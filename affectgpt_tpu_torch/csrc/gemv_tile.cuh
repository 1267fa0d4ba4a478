// Shared building blocks of the decode kernels: a block computes the product
// of up to BM activation rows, staged in shared memory, with an NC-column
// strip of a row-major bf16 weight matrix W[K, N] (the JAX `[in, out]`
// layout, so `x @ W`).
//
// What bounds these kernels on an H100: at decode batch sizes (b <= 64) a
// projection is a GEMV sweep. Every weight byte is read once per call and
// used for only b multiply-adds, so the kernels are bound by device-memory
// bandwidth on the weights, far below the tensor-core rate. The design keeps
// many 16-byte weight loads in flight: each lane owns 8 consecutive columns
// (one uint4 per weight row), NC/8 lanes share a k-row, the 512 threads of a
// block cover 512/(NC/8) k-rows at a time, and the k loop is unrolled four
// deep so that four loads per thread are outstanding. Activations are read
// from shared memory; partial sums are reduced across lanes with shuffles
// and across warps in shared memory, with no atomics, so results do not
// depend on the schedule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agk {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 8;  // activation rows per block

__device__ __forceinline__ float bf2f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 f2bf(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ void unpack8(const uint4& v, float out[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(p[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage rows [0, rows) of x (row-major, row stride h) into xs[BM][h]; rows
// past `rows` are zero. With ln != nullptr each row is rms-normalized in f32
// and multiplied by ln, then rounded to bf16 -- the rounding point of the
// TPU kernels (`xn.astype(x.dtype)`). One warp per row.
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* __restrict__ ln,
                                           int rows, int h, float eps,
                                           __nv_bfloat16* xs) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < BM; m += kWarps) {
    __nv_bfloat16* dst = xs + (size_t)m * h;
    if (m >= rows) {
      for (int i = lane; i < h; i += 32) dst[i] = f2bf(0.f);
      continue;
    }
    const __nv_bfloat16* src = x + (size_t)m * h;
    if (ln == nullptr) {
      for (int i = lane; i < h; i += 32) dst[i] = src[i];
      continue;
    }
    float ss = 0.f;
    for (int i = lane; i < h; i += 32) {
      float f = bf2f(src[i]);
      ss = fmaf(f, f, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / (float)h + eps);
    for (int i = lane; i < h; i += 32) dst[i] = f2bf(bf2f(src[i]) * r * bf2f(ln[i]));
  }
  __syncthreads();
}

// acc[m][j] += sum over k in [k0, k1) owned by this thread of
//   xs[m][k - x_k0] * W[k][c + j],
// where the strip's first NC/2 columns start at colA and its last NC/2 at
// colB (colB = colA + NC/2 for a contiguous strip), and c is the thread's
// first column: tile column lane*8 of that layout.
// xs: shared memory, row stride ldx. W row stride ldw (elements, multiple of 8).
template <int NC>
__device__ __forceinline__ void gemv_accumulate(const __nv_bfloat16* xs, int ldx, int x_k0,
                                                const __nv_bfloat16* __restrict__ W,
                                                size_t ldw, int colA, int colB, int k0, int k1,
                                                float acc[BM][8]) {
  constexpr int L = NC / 8;          // lanes sharing one weight row
  constexpr int G = kThreads / L;    // weight rows in flight per block step
  constexpr int U = 4;               // unroll: loads outstanding per thread
  const int lane = threadIdx.x % L;
  const int g = threadIdx.x / L;
  const __nv_bfloat16* wp =
      W + (lane < L / 2 ? colA + lane * 8 : colB + (lane - L / 2) * 8);
  int k = k0 + g;
  for (; k + (U - 1) * G < k1; k += U * G) {
    uint4 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      wv[u] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)(k + u * G) * ldw));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float w[8];
      unpack8(wv[u], w);
      const int kx = k + u * G - x_k0;
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = bf2f(xs[m * ldx + kx]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
      }
    }
  }
  for (; k < k1; k += G) {
    float w[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(wp + (size_t)k * ldw)), w);
    const int kx = k - x_k0;
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float xv = bf2f(xs[m * ldx + kx]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
    }
  }
}

// Sum the per-thread partials of gemv_accumulate<NC> into out[BM][NC] (f32,
// shared memory). red is shared scratch of kWarps*BM*NC floats. Ends with a
// barrier, so out is readable and red reusable afterwards.
template <int NC>
__device__ __forceinline__ void gemv_reduce(float acc[BM][8], float* red, float* out) {
  constexpr int L = NC / 8;
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
    }
  }
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  if (wl < L) {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(warp * BM + m) * NC + wl * 8 + j] = acc[m][j];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * NC; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * BM * NC + i];
    out[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void zero_acc(float acc[BM][8]) {
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  }
}

// Raise the kernel's dynamic shared-memory limit when a launch needs more
// than the 48 KB default. Returns the CUDA error code.
template <typename Kernel>
inline cudaError_t ensure_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

}  // namespace agk
