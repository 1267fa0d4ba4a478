// W8A8 matmul for Hopper (sm_90a): int8 weights AND int8 activations.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/quant.py::int8_matmul_w8a8.
//
// The function, as the TPU kernel computes it: x is quantized per (row,
// block of `qblock` = min(512, K) columns): sx = max(absmax, 1e-8) / 127 and
// xq = clip(round_half_even(x / sx), -127, 127), with a true division. Each
// block's int8 x int8 product is summed exactly in int32 (|127 * 127 * 512| <
// 2^24), converted to f32, multiplied by the row's sx and added to the f32
// accumulator; the sum times scales[n] is rounded to bf16.
//
// Bound: the s8 products at prefill M (4512 rows at b = 8: 58.9 T operations
// per 7B prefill, 1979 TOPS peak); the weight bytes at decode M. Design, two
// launches (three when the K loop is split):
//   (A) quantize x once: one block per (row, qblock), writing xq [M, K] int8
//       and sx [M, K / qblock] f32; the TPU kernel requantizes the x tile in
//       every N block instead;
//   (B) mma.sync m16n8k32 s8 x s8 -> s32 on tiles of 64 K columns
//       (quant_mma.cuh's tile shapes). The B operand must be K-contiguous, but
//       w_q is stored [K, N] (N contiguous) and ldmatrix's transpose works
//       only on 16-bit elements, so each thread loads four consecutive weight
//       rows of 16 columns and transposes the 4 x 16 bytes in registers
//       (__byte_perm) into 32-bit words of four K values, stored [n][k] in
//       shared memory. Rows are padded to 80 bytes, so fragment loads hit 32
//       distinct banks. At the end of each qblock the s32 fragment is scaled
//       by sx into the f32 accumulator. K splits are whole qblocks.
// Never compile this source with --use_fast_math: the division and rintf
// must round as IEEE does.

#include "quant_mma.cuh"

namespace agk {
namespace qmm {

constexpr int kQuantThreads = 128;

__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int K, int qblock) {
  __shared__ float red[kQuantThreads / 32];
  const int row = blockIdx.y, blk = blockIdx.x;
  const size_t base = (size_t)row * K + (size_t)blk * qblock;
  float amax = 0.f;
  for (int i = threadIdx.x; i < qblock; i += kQuantThreads)
    amax = fmaxf(amax, fabsf(__bfloat162float(x[base + i])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(amax, 1e-8f) / 127.f;
  for (int i = threadIdx.x; i < qblock; i += kQuantThreads) {
    const float q = fminf(fmaxf(rintf(__bfloat162float(x[base + i]) / s), -127.f), 127.f);
    xq[base + i] = (int8_t)(int)q;
  }
  if (threadIdx.x == 0) sx[(size_t)row * (K / qblock) + blk] = s;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (N / BN, M / BM, splits); split z runs the 64-column units [z *
// units_per_split, (z + 1) * units_per_split), a whole number of qblocks.
// Fragment layouts of mma.m16n8k32 with 8-bit operands (PTX ISA): each
// 32-bit register holds four consecutive K values; A rows gid and gid + 8,
// K 4 * tig .. + 3 and + 16; B column gid, the same K values; the s32
// accumulators as for m16n8k16.
template <class Cfg>
__global__ void __launch_bounds__(kQThreads)
w8a8_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int8_t* __restrict__ w, const float* __restrict__ scales,
                __nv_bfloat16* __restrict__ y, float* __restrict__ partial, int M, int N, int K,
                int qblock, int units_per_split) {
  constexpr int BK = 64;  // K columns (bytes) per unit
  constexpr int BM = Cfg::BM, BN = Cfg::BN, MT = Cfg::MT;
  constexpr int LDA = BK + 16, LDT = BK + 16;  // row strides in bytes
  constexpr int A_CHUNKS = BM * (BK / 16);     // 16-byte x loads per unit
  constexpr int B_QUADS = (BK / 4) * (BN / 16);  // (4 rows x 16 columns) weight pieces per unit
  constexpr int A_ITERS = (A_CHUNKS + kQThreads - 1) / kQThreads;
  constexpr int B_ITERS = (B_QUADS + kQThreads - 1) / kQThreads;
  __shared__ __align__(16) int8_t As[BM * LDA];  // [m][k]
  __shared__ __align__(16) int8_t Bt[BN * LDT];  // [n][k]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm0 = (warp / Cfg::WARPS_N) * 16 * MT;
  const int wn0 = (warp % Cfg::WARPS_N) * 32;
  const int units = K / BK, per_q = qblock / BK, nq = K / qblock;
  const int u0 = blockIdx.z * units_per_split;
  const int u1 = min(units, u0 + units_per_split);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float acc[MT][4][4];
  int pi[MT][4][4];  // the current qblock's exact integer sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0.f;
        pi[mt][nt][e] = 0;
      }

  uint4 a_raw[A_ITERS];
  uint4 b_raw[B_ITERS][4];
  auto fetch = [&](int u) {
    const int k0 = u * BK;
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int i = tid + it * kQThreads;
      const int r = (i / (BN / 16)) * 4, col = n0 + (i % (BN / 16)) * 16;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        b_raw[it][t] = i < B_QUADS && col < N
                           ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r + t) * N + col))
                           : zero;
    }
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int i = tid + it * kQThreads;
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      a_raw[it] = i < A_CHUNKS && m0 + r < M
                      ? *reinterpret_cast<const uint4*>(xq + (size_t)(m0 + r) * K + k0 + c)
                      : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int i = tid + it * kQThreads;
      if (i < A_CHUNKS)
        *reinterpret_cast<uint4*>(As + (i / (BK / 16)) * LDA + (i % (BK / 16)) * 16) = a_raw[it];
    }
#pragma unroll
    for (int it = 0; it < B_ITERS; ++it) {
      const int i = tid + it * kQThreads;
      if (i >= B_QUADS) continue;
      const int r = (i / (BN / 16)) * 4, c = (i % (BN / 16)) * 16;
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: columns c + 4q .. c + 4q + 3
        const uint32_t w0 = word_of(b_raw[it][0], q), w1 = word_of(b_raw[it][1], q);
        const uint32_t w2 = word_of(b_raw[it][2], q), w3 = word_of(b_raw[it][3], q);
        // byte e of the four rows' words, rows in order, for each column e
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
        const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
        const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
        int8_t* dst = Bt + (c + 4 * q) * LDT + r;
        *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + LDT) = __byte_perm(lo01, lo23, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + 2 * LDT) = __byte_perm(hi01, hi23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 3 * LDT) = __byte_perm(hi01, hi23, 0x7632);
      }
    }
  };

  if (u0 < u1) fetch(u0);
  for (int u = u0; u < u1; ++u) {
    __syncthreads();  // every warp is done with the previous unit's tiles
    stage();
    __syncthreads();
    if (u + 1 < u1) fetch(u + 1);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* ar = As + (wm0 + mt * 16 + gid) * LDA + kk * 32 + tig * 4;
        a[mt][0] = ld_u32(ar);
        a[mt][1] = ld_u32(ar + 8 * LDA);
        a[mt][2] = ld_u32(ar + 16);
        a[mt][3] = ld_u32(ar + 8 * LDA + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* br = Bt + (wn0 + nt * 8 + gid) * LDT + kk * 32 + tig * 4;
        const uint32_t b0 = ld_u32(br), b1 = ld_u32(br + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(pi[mt][nt], a[mt], b0, b1);
      }
    }
    if ((u + 1) % per_q == 0) {  // the end of a qblock: scale its sums by sx
      const int blk = u / per_q;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = m0 + wm0 + mt * 16 + gid, r1 = r0 + 8;
        const float s0 = r0 < M ? sx[(size_t)r0 * nq + blk] : 0.f;
        const float s1 = r1 < M ? sx[(size_t)r1 * nq + blk] : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[mt][nt][0] += (float)pi[mt][nt][0] * s0;
          acc[mt][nt][1] += (float)pi[mt][nt][1] * s0;
          acc[mt][nt][2] += (float)pi[mt][nt][2] * s1;
          acc[mt][nt][3] += (float)pi[mt][nt][3] * s1;
          pi[mt][nt][0] = pi[mt][nt][1] = pi[mt][nt][2] = pi[mt][nt][3] = 0;
        }
      }
    }
  }
  store_tile<Cfg>(acc, scales, y, partial, M, N, m0 + wm0, n0 + wn0);
}

template <class Cfg>
static cudaError_t launch_w8a8(const int8_t* xq, const float* sx, const int8_t* w,
                               const float* scales, __nv_bfloat16* y, float* partial, int M,
                               int N, int K, int qblock, int units_per_split, int splits,
                               cudaStream_t stream) {
  const dim3 grid((N + Cfg::BN - 1) / Cfg::BN, (M + Cfg::BM - 1) / Cfg::BM, splits);
  w8a8_mma_kernel<Cfg><<<grid, kQThreads, 0, stream>>>(xq, sx, w, scales, y, partial, M, N, K,
                                                       qblock, units_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_reduce(partial, scales, y, M, N, splits, stream);
}

}  // namespace qmm
}  // namespace agk

// C entry. Device pointers to contiguous tensors: x [M, K] bf16; w int8
// [K, N]; scales f32 [1, N]; scratch xq int8 [M, K] and sx f32 [M, K /
// qblock]; y [M, N] bf16; partial f32 [splits, M, N] when splits > 1. The
// wrapper in affectgpt_tpu_torch/ops/quant.py checks shapes, dtypes and
// alignment (N % 16 == 0, K % qblock == 0, qblock % 64 == 0) and makes
// units_per_split a multiple of qblock / 64. Returns the first CUDA error of
// the launches, or 0.
extern "C" int agk_int8_matmul_w8a8(const void* x, const void* w, const void* scales, void* xq,
                                    void* sx, void* y, void* partial, int m, int n, int k,
                                    int qblock, int units_per_split, int splits, void* stream) {
  using namespace agk::qmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xqp = static_cast<int8_t*>(xq);
  auto* sxp = static_cast<float*>(sx);
  quantize_rows_kernel<<<dim3(k / qblock, m), kQuantThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), xqp, sxp, k, qblock);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partial);
  if (m <= SmallTile::BM)
    return (int)launch_w8a8<SmallTile>(xqp, sxp, wp, sp, yp, pp, m, n, k, qblock,
                                       units_per_split, splits, st);
  return (int)launch_w8a8<LargeTile>(xqp, sxp, wp, sp, yp, pp, m, n, k, qblock, units_per_split,
                                     splits, st);
}
