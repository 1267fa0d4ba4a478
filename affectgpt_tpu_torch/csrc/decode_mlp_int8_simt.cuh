// The previous design of the fused int8 decode MLP on CUDA cores, kept as
// the yardstick that chip_smoke.py times the tensor-core design of
// decode_mlp_int8.cu against (its C entry's variant 2); no path of the port
// runs it.
//   (A) grid over 64-column strips of I: each block rms-normalizes its rows
//       and rounds them to bf16, streams its gate and up strips, converting
//       each int8 byte to a float in registers (a byte permute and a
//       subtraction), accumulates in f32 on CUDA cores, scales, applies
//       silu(g)*u and rounds it to bf16;
//   (B) grid over 32-column strips of h: the down projection over the whole
//       I in f32, times the column's down scale, plus the residual x.
// A block covers a tile of 8 batch rows, so at b > 8 the tiles read their
// weight strips once each, and every weight value costs b f32 multiply-adds
// plus its conversion: CUDA-core bound from b = 16.
#pragma once

#include <stdint.h>

#include "gemv_tile.cuh"

namespace agk {
namespace simt {

constexpr int kGateColsS8 = 64;
constexpr int kDownColsS8 = 32;
constexpr int kDownChunkS8 = 4096;  // I values of the scratch rows staged at a time

// Eight int8 values to f32 without the quarter-rate integer conversion:
// byte s ^ 0x80 = s + 128 becomes the low mantissa byte of 2^23 (one byte
// permute), and subtracting 2^23 + 128 leaves s, exactly.
__device__ __forceinline__ void unpack8_s8(const uint2& v, float out[8]) {
  const uint32_t words[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    out[i] = __uint_as_float(__byte_perm(words[i / 4], 0x4B000000u, 0x7440 + i % 4)) -
             8388736.f;
}

// acc[m][j] += sum over k in [k0, k1) owned by this thread of
//   xs[m][k - x_k0] * W[k][col0 + lane * 8 + j]
// for an int8 W[K, N] (row stride ldw, a multiple of 8) and an NC-column
// strip starting at col0; the layout of gemv_accumulate (gemv_tile.cuh), so
// gemv_reduce<NC> sums the partials.
template <int NC>
__device__ __forceinline__ void gemv_accumulate_s8(const __nv_bfloat16* xs, int ldx, int x_k0,
                                                   const int8_t* __restrict__ W, size_t ldw,
                                                   int col0, int k0, int k1, float acc[BM][8]) {
  constexpr int L = NC / 8;        // lanes sharing one weight row
  constexpr int G = kThreads / L;  // weight rows in flight per block step
  constexpr int U = 8;             // unroll: loads outstanding per thread
  const int lane = threadIdx.x % L;
  const int g = threadIdx.x / L;
  const int8_t* wp = W + col0 + lane * 8;
  int k = k0 + g;
  for (; k + (U - 1) * G < k1; k += U * G) {
    uint2 wv[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      wv[u] = __ldg(reinterpret_cast<const uint2*>(wp + (size_t)(k + u * G) * ldw));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float w[8];
      unpack8_s8(wv[u], w);
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
    unpack8_s8(__ldg(reinterpret_cast<const uint2*>(wp + (size_t)k * ldw)), w);
    const int kx = k - x_k0;
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const float xv = bf2f(xs[m * ldx + kx]);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_mlp_int8_gateup_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ ln,
                              const int8_t* __restrict__ wg, const float* __restrict__ sg,
                              const int8_t* __restrict__ wu, const float* __restrict__ su,
                              __nv_bfloat16* __restrict__ act, int b, int h, int inter,
                              float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);        // [BM][h]
  float* red = reinterpret_cast<float*>(smem + (size_t)BM * h * 2);  // [kWarps][BM][64]
  float* gate = red + kWarps * BM * kGateColsS8;                     // [BM][64]
  float* up = gate + BM * kGateColsS8;                               // [BM][64]

  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, b - row0);
  stage_rows(x + (size_t)row0 * h, ln, rows, h, eps, xs);
  const int col0 = blockIdx.x * kGateColsS8;

  float acc[BM][8];
  zero_acc(acc);
  gemv_accumulate_s8<kGateColsS8>(xs, h, 0, wg, (size_t)inter, col0, 0, h, acc);
  gemv_reduce<kGateColsS8>(acc, red, gate);
  zero_acc(acc);
  gemv_accumulate_s8<kGateColsS8>(xs, h, 0, wu, (size_t)inter, col0, 0, h, acc);
  gemv_reduce<kGateColsS8>(acc, red, up);

  for (int i = threadIdx.x; i < BM * kGateColsS8; i += kThreads) {
    const int m = i / kGateColsS8, c = i % kGateColsS8;
    if (m >= rows) continue;
    const float g = gate[i] * sg[col0 + c];
    const float a = g / (1.f + expf(-g)) * (up[i] * su[col0 + c]);
    act[(size_t)(row0 + m) * inter + col0 + c] = f2bf(a);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_mlp_int8_down_kernel(const __nv_bfloat16* __restrict__ act,
                            const __nv_bfloat16* __restrict__ x,
                            const int8_t* __restrict__ wd, const float* __restrict__ sd,
                            __nv_bfloat16* __restrict__ y, int b, int h, int inter) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);                   // [BM][chunk]
  float* red = reinterpret_cast<float*>(smem + (size_t)BM * kDownChunkS8 * 2);  // [kWarps][BM][32]
  float* out = red + kWarps * BM * kDownColsS8;                                 // [BM][32]

  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, b - row0);
  const int col0 = blockIdx.x * kDownColsS8;

  float acc[BM][8];
  zero_acc(acc);
  for (int kc = 0; kc < inter; kc += kDownChunkS8) {
    const int kn = min(kDownChunkS8, inter - kc);
    const int vecs = kn / 8;  // inter % 64 == 0, checked by the wrapper
    for (int i = threadIdx.x; i < BM * vecs; i += kThreads) {
      const int m = i / vecs, kv = i % vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < rows)
        val = *reinterpret_cast<const uint4*>(act + (size_t)(row0 + m) * inter + kc + kv * 8);
      *reinterpret_cast<uint4*>(as + m * kDownChunkS8 + kv * 8) = val;
    }
    __syncthreads();
    gemv_accumulate_s8<kDownColsS8>(as, kDownChunkS8, kc, wd, (size_t)h, col0, kc, kc + kn, acc);
    __syncthreads();
  }
  gemv_reduce<kDownColsS8>(acc, red, out);

  for (int i = threadIdx.x; i < BM * kDownColsS8; i += kThreads) {
    const int m = i / kDownColsS8, c = i % kDownColsS8;
    if (m >= rows) continue;
    const size_t o = (size_t)(row0 + m) * h + col0 + c;
    y[o] = f2bf(bf2f(x[o]) + out[i] * sd[col0 + c]);
  }
}


inline cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* ln, const int8_t* wg,
                          const float* sg, const int8_t* wu, const float* su, const int8_t* wd,
                          const float* sd, __nv_bfloat16* act, __nv_bfloat16* y, int b, int h,
                          int inter, float eps, cudaStream_t st) {
  static size_t granted_a = 48 * 1024, granted_b = 48 * 1024;
  const size_t smem_a = (size_t)BM * h * 2 + (size_t)(kWarps + 2) * BM * kGateColsS8 * 4;
  cudaError_t err = ensure_smem(decode_mlp_int8_gateup_kernel, smem_a, &granted_a);
  if (err != cudaSuccess) return err;
  decode_mlp_int8_gateup_kernel<<<dim3(inter / kGateColsS8, (b + BM - 1) / BM), kThreads, smem_a,
                                  st>>>(x, ln, wg, sg, wu, su, act, b, h, inter, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_b =
      (size_t)BM * kDownChunkS8 * 2 + (size_t)(kWarps + 1) * BM * kDownColsS8 * 4;
  err = ensure_smem(decode_mlp_int8_down_kernel, smem_b, &granted_b);
  if (err != cudaSuccess) return err;
  decode_mlp_int8_down_kernel<<<dim3(h / kDownColsS8, (b + BM - 1) / BM), kThreads, smem_b, st>>>(
      act, x, wd, sd, y, b, h, inter);
  return cudaGetLastError();
}

}  // namespace simt
}  // namespace agk
