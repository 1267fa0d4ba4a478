// Shared tile code of the quantized matmul kernels on Hopper (sm_90a):
//   y[M, N] = x[M, K] (bf16, row-major) against an integer weight stored in
//   the JAX `[in, out]` layout (row-major, N contiguous), as
//   affectgpt_tpu/ops/quant.py stores it: int8 [K, N], or int4 packed
//   [K/2, N] (low nibble = row k, high nibble = row k + K/2).
//
// One block computes a BM x BN tile of y with four warps. The K loop walks
// "units": 64 weight rows (int8) or 128 packed rows (int4: one 128-row scale
// group of each K-half). Each unit's x columns are staged in shared memory as
// they are; its weight bytes are loaded 16 at a time, converted to bf16 in
// registers (exact for int8 and int4 values) and stored in shared memory, so
// the dequantized weights never exist in device memory. The products run as
// mma.sync m16n8k16 bf16 with f32 accumulators; the B fragments come from the
// [k][n] weight tile by transposed ldmatrix. Rows of shared tiles are padded
// by 8 bf16, so fragment loads hit 32 distinct banks.
//
// One tile shape, for M above the decode M (16 < M <= 1024; the wrappers run
// M <= 16 on quant_swapab.cu): 2 x 2 warps of 64 x 32 (128 x 64). Where the
// tiles leave too few blocks for the SMs, the K loop is split over
// blockIdx.z: each split writes its f32 partial tile, and a second launch
// sums the splits in a fixed order and rounds to bf16, so results do not
// depend on the schedule and no atomics are needed.
//
// Modes (what the unit's weights become before the product, and where the
// scales enter):
//   kW8        int8 value; y = (sum) * scales[n] at the end        (int8_matmul)
//   kW4        int4 value; each group's f32 sum * scales[g, n],
//              added to the accumulator                            (int4_matmul)
//   kW4Dequant bf16(int4 value * scales[g, n]) computed in f32      (int4_matmul_smallm)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_tile.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace qmm {

constexpr int kQThreads = 128;  // four warps

template <int MT_, int WARPS_M_, int WARPS_N_>
struct TileCfg {
  static constexpr int MT = MT_;  // 16-row mma tiles per warp
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int BM = WARPS_M * 16 * MT;
  static constexpr int BN = WARPS_N * 32;  // each warp: four 8-column mma tiles
};
using LargeTile = TileCfg<4, 2, 2>;  // 128 x 64

enum : int { kW8 = 0, kW4 = 1, kW4Dequant = 2 };

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Signed values of byte i of a word: the int8 value, and the two int4
// nibbles (low = bits 0-3, high = bits 4-7), each sign-extended from its own
// bits, so nothing depends on how a signed shift behaves.
__device__ __forceinline__ int s8_of(uint32_t word, int i) {
  return (int)(((word >> (8 * i)) & 0xFFu) ^ 0x80u) - 0x80;
}
__device__ __forceinline__ int s4_lo_of(uint32_t word, int i) {
  return (int)(((word >> (8 * i)) & 0xFu) ^ 0x8u) - 0x8;
}
__device__ __forceinline__ int s4_hi_of(uint32_t word, int i) {
  return (int)(((word >> (8 * i + 4)) & 0xFu) ^ 0x8u) - 0x8;
}

// c[MT][4][4] += A[warp rows, 16*KSTEPS] @ B[16*KSTEPS, warp columns]: A
// row-major in shared memory (row stride LDA), B row-major [k][n] (row
// stride LDB). Fragment layouts are those of mma.m16n8k16 (PTX ISA): with
// gid = lane / 4 and tig = lane % 4, a thread holds rows gid and gid + 8,
// columns 2 * tig and 2 * tig + 1 of each 8-column tile.
template <class Cfg, int LDA, int LDB, int KSTEPS>
__device__ __forceinline__ void warp_mma(const __nv_bfloat16* As, const __nv_bfloat16* Bs,
                                         int wm0, int wn0, float c[Cfg::MT][4][4]) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[Cfg::MT][4];
#pragma unroll
    for (int mt = 0; mt < Cfg::MT; ++mt) {
      const __nv_bfloat16* ar = As + (wm0 + mt * 16 + gid) * LDA + kk * 16 + tig * 2;
      a[mt][0] = ld_u32(ar);
      a[mt][1] = ld_u32(ar + 8 * LDA);
      a[mt][2] = ld_u32(ar + 8);
      a[mt][3] = ld_u32(ar + 8 * LDA + 8);
    }
    const __nv_bfloat16* br =
        Bs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDB + wn0 + (lane / 16) * 8;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, br + j * 8);
#pragma unroll
      for (int mt = 0; mt < Cfg::MT; ++mt) {
        mma_bf16(c[mt][j], a[mt], b[0], b[1]);
        mma_bf16(c[mt][j + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// Write a warp's accumulators: rounded to bf16 into y (times scales[n] when
// `scales` is given) when the K loop was not split, else as f32 into this
// split's slice of `partial` [splits, M, N]. N % 16 == 0, so a thread's
// column pair is inside N when its first column is.
template <class Cfg>
__device__ __forceinline__ void store_tile(float acc[Cfg::MT][4][4],
                                           const float* __restrict__ scales,
                                           __nv_bfloat16* __restrict__ y,
                                           float* __restrict__ partial, int M, int N, int m_w,
                                           int n_w) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < Cfg::MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n_w + nt * 8 + tig * 2;
      if (col >= N) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m_w + mt * 16 + gid + i * 8;
        if (row >= M) continue;
        float v0 = acc[mt][nt][2 * i], v1 = acc[mt][nt][2 * i + 1];
        if (gridDim.z == 1) {
          if (scales != nullptr) {
            v0 *= scales[col];
            v1 *= scales[col + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * M + row) * N + col) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// y = bf16(sum over splits of partial (times scales[n] when given)), the
// splits summed in order.
static __global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scales,
                     __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * total + i];
    if (scales != nullptr) s *= scales[i % N];
    y[i] = __float2bfloat16(s);
  }
}

static inline cudaError_t launch_splitk_reduce(const float* partial, const float* scales,
                                        __nv_bfloat16* y, int M, int N, int splits,
                                        cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const int blocks = (int)(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, scales, y, M, N, splits);
  return cudaGetLastError();
}

// Grid (N / BN, M / BM, splits), kQThreads threads; split z runs units
// [z * units_per_split, (z + 1) * units_per_split). The next unit's weight
// bytes (and, for int8, its x columns) are loaded into registers
// while the current unit's products run.
template <int MODE, class Cfg>
__global__ void __launch_bounds__(kQThreads)
bf16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scales, __nv_bfloat16* __restrict__ y,
                float* __restrict__ partial, int M, int N, int K, int units_per_split) {
  constexpr int HALVES = MODE == kW8 ? 1 : 2;  // int4: the two K-halves of a packed row
  constexpr int BK = MODE == kW8 ? 64 : 128;   // stored weight rows per unit
  constexpr int BM = Cfg::BM, BN = Cfg::BN, MT = Cfg::MT;
  constexpr int LDA = BK + 8, LDB = BN + 8;
  constexpr int A_ITERS = BM * (BK / 8) / kQThreads;   // 16-byte x loads per thread and half
  constexpr int B_ITERS = BK * (BN / 16) / kQThreads;  // 16-byte weight loads per thread
  constexpr bool PREFETCH_A = HALVES * A_ITERS <= 8;
  static_assert(A_ITERS * kQThreads == BM * (BK / 8) && B_ITERS * kQThreads == BK * (BN / 16),
                "tile loads must divide evenly over the threads");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [HALVES][BM][LDA]
  __nv_bfloat16* Bs = As + HALVES * BM * LDA;                  // [HALVES][BK][LDB]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tig = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / Cfg::WARPS_N) * 16 * MT;  // the warp's tile inside the block
  const int wn0 = (warp % Cfg::WARPS_N) * 32;
  const int units = (MODE == kW8 ? K : K / 2) / BK;
  const int u0 = blockIdx.z * units_per_split;
  const int u1 = min(units, u0 + units_per_split);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[MT][4][4];
  float part[MT][4][4];  // kW4: one group's sum before its scale
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  uint4 b_raw[B_ITERS];
  uint4 a_raw[PREFETCH_A ? HALVES * A_ITERS : 1];
  // x columns of half h of unit u: the unit's rows (int8, or the low half
  // of int4) or K/2 + those rows (the high half)
  auto x_col0 = [&](int u, int h) { return (h == 0 ? 0 : K / 2) + u * BK; };
  auto load_a = [&](int u, int h, int i) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    return m0 + r < M
               ? *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + x_col0(u, h) + c)
               : zero;
  };
  auto fetch = [&](int u) {
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int i = tid + it * kQThreads;
      const int r = i / (BN / 16), col = n0 + (i % (BN / 16)) * 16;
      b_raw[it] = col < N ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(u * BK + r) * N + col))
                          : zero;
    }
    if constexpr (PREFETCH_A) {
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int it = 0; it < A_ITERS; ++it) a_raw[h * A_ITERS + it] = load_a(u, h, tid + it * kQThreads);
    }
  };
  // a thread's weight columns are the same in each of its loads of a unit
  static_assert(kQThreads % (BN / 16) == 0, "a thread keeps its 16 columns");
  const int my_col = n0 + (tid % (BN / 16)) * 16;
  // unit u's tiles into shared memory: x as it is, the weights as bf16
  auto stage = [&](int u) {
    const int g_lo = u * BK / 128, g_hi = (K / 2 + u * BK) / 128;  // int4 scale rows
    float s_lo[16], s_hi[16];  // kW4Dequant: the scales of the thread's columns
    if constexpr (MODE == kW4Dequant) {
#pragma unroll
      for (int j = 0; j < 16; j += 4) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
        if (my_col < N) {
          a = __ldg(reinterpret_cast<const float4*>(scales + (size_t)g_lo * N + my_col + j));
          b = __ldg(reinterpret_cast<const float4*>(scales + (size_t)g_hi * N + my_col + j));
        }
        s_lo[j] = a.x; s_lo[j + 1] = a.y; s_lo[j + 2] = a.z; s_lo[j + 3] = a.w;
        s_hi[j] = b.x; s_hi[j + 1] = b.y; s_hi[j + 2] = b.z; s_hi[j + 3] = b.w;
      }
    }
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
#pragma unroll 4
      for (int it = 0; it < A_ITERS; ++it) {
        const int i = tid + it * kQThreads;
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 v;
        if constexpr (PREFETCH_A) v = a_raw[h * A_ITERS + it];
        else v = load_a(u, h, i);
        *reinterpret_cast<uint4*>(As + h * BM * LDA + r * LDA + c) = v;
      }
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int i = tid + it * kQThreads;
      const int r = i / (BN / 16), c = my_col - n0;
      const uint32_t words[4] = {b_raw[it].x, b_raw[it].y, b_raw[it].z, b_raw[it].w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[4], t[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (MODE == kW8) {
            v[e] = (float)s8_of(words[q], e);
            t[e] = 0.f;
          } else {
            v[e] = (float)s4_lo_of(words[q], e);
            t[e] = (float)s4_hi_of(words[q], e);
            if constexpr (MODE == kW4Dequant) {
              v[e] *= s_lo[4 * q + e];  // rounded to bf16 below, as the TPU kernel does
              t[e] *= s_hi[4 * q + e];
            }
          }
        }
        lo[2 * q] = pack_bf16x2(v[0], v[1]);
        lo[2 * q + 1] = pack_bf16x2(v[2], v[3]);
        hi[2 * q] = pack_bf16x2(t[0], t[1]);
        hi[2 * q + 1] = pack_bf16x2(t[2], t[3]);
      }
      __nv_bfloat16* b0 = Bs + r * LDB + c;
      *reinterpret_cast<uint4*>(b0) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(b0 + 8) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      if constexpr (HALVES == 2) {
        __nv_bfloat16* b1 = b0 + BK * LDB;
        *reinterpret_cast<uint4*>(b1) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(b1 + 8) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      }
    }
  };

  if (u0 < u1) fetch(u0);
  for (int u = u0; u < u1; ++u) {
    __syncthreads();  // every warp is done with the previous unit's tiles
    stage(u);
    __syncthreads();
    if (u + 1 < u1) fetch(u + 1);  // in flight during the products
    if constexpr (MODE == kW4) {
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            part[mt][nt][0] = part[mt][nt][1] = part[mt][nt][2] = part[mt][nt][3] = 0.f;
        warp_mma<Cfg, LDA, LDB, BK / 16>(As + h * BM * LDA, Bs + h * BK * LDB, wm0, wn0, part);
        // the group's f32 sum times its scales, then into the accumulator
        const float* srow = scales + (size_t)((x_col0(u, h)) / 128) * N;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn0 + nt * 8 + tig * 2;
          const float s0 = col < N ? srow[col] : 0.f;
          const float s1 = col < N ? srow[col + 1] : 0.f;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            acc[mt][nt][0] += part[mt][nt][0] * s0;
            acc[mt][nt][1] += part[mt][nt][1] * s1;
            acc[mt][nt][2] += part[mt][nt][2] * s0;
            acc[mt][nt][3] += part[mt][nt][3] * s1;
          }
        }
      }
    } else {
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        warp_mma<Cfg, LDA, LDB, BK / 16>(As + h * BM * LDA, Bs + h * BK * LDB, wm0, wn0, acc);
    }
  }
  store_tile<Cfg>(acc, MODE == kW8 ? scales : nullptr, y, partial, M, N, m0 + wm0, n0 + wn0);
}

template <int MODE, class Cfg>
inline cudaError_t launch_bf16_mma_cfg(const __nv_bfloat16* x, const int8_t* w,
                                       const float* scales, __nv_bfloat16* y, float* partial,
                                       int M, int N, int K, int units_per_split, int splits,
                                       cudaStream_t stream) {
  constexpr int HALVES = MODE == kW8 ? 1 : 2;
  constexpr int BK = MODE == kW8 ? 64 : 128;
  const size_t smem =
      (size_t)HALVES * (Cfg::BM * (BK + 8) + BK * (Cfg::BN + 8)) * sizeof(__nv_bfloat16);
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(bf16_mma_kernel<MODE, Cfg>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Cfg::BN - 1) / Cfg::BN, (M + Cfg::BM - 1) / Cfg::BM, splits);
  bf16_mma_kernel<MODE, Cfg><<<grid, kQThreads, smem, stream>>>(x, w, scales, y, partial, M, N,
                                                                K, units_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_reduce(partial, MODE == kW8 ? scales : nullptr, y, M, N, splits, stream);
}

// The C entries of int8_matmul.cu, int4_matmul.cu and int4_matmul_smallm.cu.
// Device pointers to contiguous tensors: x [M, K] bf16; w int8 [K, N] (kW8)
// or [K/2, N] (int4); scales f32 [1, N] or [K/128, N]; y [M, N] bf16;
// partial f32 [splits, M, N] when splits > 1. The wrappers in
// affectgpt_tpu_torch/ops/quant.py check shapes, dtypes and alignment (N %
// 16 == 0; K % 64 == 0, or K % 256 == 0 for int4) and choose the split.
template <int MODE>
inline int launch_bf16_mma(const void* x, const void* w, const void* scales, void* y,
                           void* partial, int m, int n, int k, int units_per_split, int splits,
                           void* stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_bf16_mma_cfg<MODE, LargeTile>(xp, wp, sp, yp, pp, m, n, k, units_per_split,
                                                   splits, st);
}

}  // namespace qmm
}  // namespace agk
