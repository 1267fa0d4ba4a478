// Shared pieces of the ViT / HuBERT encoder kernels on Hopper (sm_90a):
// LayerNorm of bf16 rows, and a bf16 GEMM on mma.sync m16n8k16 with f32
// accumulation whose epilogue adds a bias, then optionally applies an
// activation or adds a residual, and rounds to bf16 once.
//
// The GEMM: y[M, N] = epi(a[M, K] @ w[K, N]) with a and w row-major (w in the
// JAX `[in, out]` layout, applied as a @ w). A block computes a 128 x 128
// tile with 8 warps (2 x 4, each 64 x 32); the K loop walks 32-column slices
// staged by cp.async in a ring of three, so two slices are in flight while
// one is multiplied. A fragments come from the a tile by ldmatrix, B
// fragments from the [k][n] w tile by transposed ldmatrix; shared rows are
// padded by 8 bf16 so fragment loads hit distinct banks. Rows of a at or
// past M and columns of w at or past N are zero-filled (cp.async with a
// source size of 0) and never stored. Needs K % 32 == 0 and N % 8 == 0.
// Up to three GEMMs that share a (the q, k and v projections) run in one
// launch, one per blockIdx.z.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_tile.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace vit {

enum : int { kActNone = 0, kActQuickGelu = 1, kActGelu = 2 };

// quick_gelu (CLIP) and the erf gelu (HuBERT), in f32. The TPU kernels build
// erf from the Abramowitz-Stegun rational (1.5e-7 absolute error) because
// Mosaic lowers no erf; erff is the exact function.
template <int ACT>
__device__ __forceinline__ float activate(float t) {
  if constexpr (ACT == kActQuickGelu) return t * (1.f / (1.f + expf(-1.702f * t)));
  if constexpr (ACT == kActGelu) return 0.5f * t * (1.f + erff(t * 0.7071067811865476f));
  return t;
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kLnMaxVec = 8;  // 16-byte vectors per lane: w <= 32 * 8 * 8 = 2048

// One warp normalizes one row of w values (w % 8 == 0, w <= 2048): mean,
// then the mean of squared deviations, in f32; dst = bf16((x - mean) *
// rsqrt(var + eps) * scale + bias). dst may be global or shared memory.
__device__ __forceinline__ void layernorm_row(const __nv_bfloat16* __restrict__ xr,
                                              const __nv_bfloat16* __restrict__ scale,
                                              const __nv_bfloat16* __restrict__ bias,
                                              __nv_bfloat16* dst, int w, float eps) {
  const int lane = threadIdx.x % 32, nv = w / 8;
  float v[kLnMaxVec][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      unpack8(*reinterpret_cast<const uint4*>(xr + c * 8), v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[i][e];
    }
  }
  const float mean = warp_allsum(sum) / (float)w;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[i][e] - mean;
        sq += d * d;
      }
    }
  }
  const float inv = rsqrtf(warp_allsum(sq) / (float)w + eps);
#pragma unroll
  for (int i = 0; i < kLnMaxVec; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      float s[8], b[8];
      unpack8(*reinterpret_cast<const uint4*>(scale + c * 8), s);
      unpack8(*reinterpret_cast<const uint4*>(bias + c * 8), b);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = pack_bf16x2((v[i][2 * e] - mean) * inv * s[2 * e] + b[2 * e],
                           (v[i][2 * e + 1] - mean) * inv * s[2 * e + 1] + b[2 * e + 1]);
      *reinterpret_cast<uint4*>(dst + c * 8) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

constexpr int kLnThreads = 256;

// h[rows, w] = LayerNorm(x[rows, w]), one warp per row.
static __global__ void __launch_bounds__(kLnThreads)
layernorm_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ h,
                      int rows, int w, float eps) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  if (row >= rows) return;
  layernorm_row(x + (size_t)row * w, scale, bias, h + (size_t)row * w, w, eps);
}

static inline cudaError_t launch_layernorm(const __nv_bfloat16* x, const __nv_bfloat16* scale,
                                           const __nv_bfloat16* bias, __nv_bfloat16* h, int rows,
                                           int w, float eps, cudaStream_t stream) {
  constexpr int rows_per_block = kLnThreads / 32;
  layernorm_rows_kernel<<<(rows + rows_per_block - 1) / rows_per_block, kLnThreads, 0, stream>>>(
      x, scale, bias, h, rows, w, eps);
  return cudaGetLastError();
}

// 16 bytes global -> shared, asynchronously; with pred false the 16 bytes
// are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kGemmThreads = 256;
constexpr int kGemmBM = 128, kGemmBN = 128, kGemmBK = 32, kGemmStages = 3;
constexpr int kGemmLDA = kGemmBK + 8, kGemmLDB = kGemmBN + 8;
constexpr size_t kGemmSmem =
    (size_t)kGemmStages * (kGemmBM * kGemmLDA + kGemmBK * kGemmLDB) * sizeof(__nv_bfloat16);

struct GemmOperand {
  const __nv_bfloat16* w;     // [K, N]
  const __nv_bfloat16* bias;  // [N]
  __nv_bfloat16* y;           // [M, N]
};
struct GemmGroup {
  GemmOperand op[3];
};

// Grid (N / 128, M / 128, operands). y = bf16(act(a @ w + bias)) or, with
// RESIDUAL, y = bf16(a @ w + bias + res) (res [M, N]), all in f32 first.
template <int ACT, bool RESIDUAL>
static __global__ void __launch_bounds__(kGemmThreads)
gemm_bias_kernel(const __nv_bfloat16* __restrict__ a, GemmGroup group,
                 const __nv_bfloat16* __restrict__ res, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [stages][BM][LDA]
  __nv_bfloat16* Bs = As + kGemmStages * kGemmBM * kGemmLDA;    // [stages][BK][LDB]
  // picked without a dynamic index, which would copy the group to local memory
  const GemmOperand op =
      blockIdx.z == 0 ? group.op[0] : blockIdx.z == 1 ? group.op[1] : group.op[2];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * kGemmBM, n0 = blockIdx.x * kGemmBN;
  const int wm0 = (warp / 4) * 64, wn0 = (warp % 4) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* as = As + stage * kGemmBM * kGemmLDA;
    __nv_bfloat16* bs = Bs + stage * kGemmBK * kGemmLDB;
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // a: 128 rows x 4 vectors
      const int i = tid + it * kGemmThreads;
      const int r = i / 4, c = (i % 4) * 8;
      const bool in = m0 + r < M;
      cp_async16(as + r * kGemmLDA + c, a + (size_t)(in ? m0 + r : 0) * K + k0 + c, in);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // w: 32 rows x 16 vectors
      const int i = tid + it * kGemmThreads;
      const int r = i / 16, c = (i % 16) * 8;
      const bool in = n0 + c < N;
      cp_async16(bs + r * kGemmLDB + c, op.w + (size_t)(k0 + r) * N + (in ? n0 + c : 0), in);
    }
  };

  const int tiles = K / kGemmBK;
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < tiles) load_stage(s, s * kGemmBK);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kGemmStages - 2>();  // slice t has landed
    __syncthreads();                   // and every warp is done with slice t - 1
    const int next = t + kGemmStages - 1;
    if (next < tiles) load_stage(next % kGemmStages, next * kGemmBK);
    cp_async_commit();
    const __nv_bfloat16* as = As + (t % kGemmStages) * kGemmBM * kGemmLDA;
    const __nv_bfloat16* bs = Bs + (t % kGemmStages) * kGemmBK * kGemmLDB;
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm0 + mt * 16 + lane % 16) * kGemmLDA + kk * 16 + (lane / 16) * 8);
      const __nv_bfloat16* br =
          bs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kGemmLDB + wn0 + (lane / 16) * 8;
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, br + j * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][j], af[mt], b[0], b[1]);
          mma_bf16(acc[mt][j + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn0 + nt * 8 + tig * 2;
    if (col >= N) continue;
    const float b0 = bf2f(op.bias[col]), b1 = bf2f(op.bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + wm0 + mt * 16 + gid + i * 8;
        if (row >= M) continue;
        float v0 = acc[mt][nt][2 * i] + b0, v1 = acc[mt][nt][2 * i + 1] + b1;
        if constexpr (RESIDUAL) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + (size_t)row * N + col));
          v0 += r.x;
          v1 += r.y;
        } else {
          v0 = activate<ACT>(v0);
          v1 = activate<ACT>(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(op.y + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int ACT, bool RESIDUAL>
static cudaError_t launch_gemm(const __nv_bfloat16* a, const GemmGroup& group, int operands,
                               const __nv_bfloat16* res, int M, int N, int K,
                               cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(gemm_bias_kernel<ACT, RESIDUAL>, kGemmSmem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kGemmBN - 1) / kGemmBN, (M + kGemmBM - 1) / kGemmBM, operands);
  gemm_bias_kernel<ACT, RESIDUAL><<<grid, kGemmThreads, kGemmSmem, stream>>>(a, group, res, M, N, K);
  return cudaGetLastError();
}

}  // namespace vit
}  // namespace agk
