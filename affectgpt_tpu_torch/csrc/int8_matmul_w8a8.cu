// W8A8 matmul for Hopper (sm_90a) above decode M (M > 16): int8 weights AND
// int8 activations, on wgmma with s8 operands fed by TMA (`wgmma.mma_async`
// and `cp.async.bulk.tensor` from hopper.cuh). Three designs by M:
//   - M <= 16: the w8a8 mode of quant_swapab.cu, one launch that quantizes x
//     itself and reduces its K split in a cluster;
//   - 16 < M <= the wrapper's cut (ops/quant.py PALLAS_DEQUANT_MAX_M, 1024): x
//     quantized by (A) below, then the kW8A8 mode of quant_wgmma.cuh
//     (swap-AB, the batch rows the wgmma N, 16 to 128 of them a block; K
//     split over a cluster in whole qblocks, met in distributed shared
//     memory), launched as the programmatic dependent of (A): two launches
//     a product (agk_int8_matmul_w8a8_wgmma);
//   - above the cut (the prefill's M = 4512): the 192-row tile below, the
//     design this file was written for (agk_int8_matmul_w8a8).
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
// Bound: the s8 products at prefill M (4512 rows: 2.10 T operations per
// decoder layer, 1979 TOPS peak). Design, two launches (three when the K
// loop is split):
//   (A) quantize x once: one warp per (row, qblock), writing xq [M, K] int8
//       and sx f32, stored [K / qblock, M padded to the row tile] so that a
//       block's scales of one qblock are contiguous. The bytes of each
//       16-column group of xq are stored permuted (position p holds column
//       sigma16(p)); see (B).
//   (B) wgmma.m64nNk32.s32.s8.s8 needs both shared-memory operands K-major
//       for 8-bit types, but w_q is stored [K, N] (N contiguous, the JAX
//       format). So the kernel computes the transposed tile, y^T = w_q^T .
//       xq^T: the weight is the A operand, taken from registers; xq (K
//       contiguous) is the B operand, read from shared memory. A block of
//       three warpgroups owns 128 output columns (n) x BM = 192 rows (m,
//       the wgmma's N, whose 96 s32 and 96 f32 accumulators a consumer
//       thread holds); warpgroup 0 issues the TMA
//       loads of a 4-stage ring (weight tile 128 k x 128 n and xq tile BM x
//       128 k per stage, both 128-byte swizzled, and the BM scales sx of the
//       qblock the stage ends in, a bulk copy), warpgroups 1 and 2 each
//       multiply 64 of the n. A warp's A fragment of one 32-wide k step is
//       one ldmatrix.x4.trans of the N-contiguous weight tile read as 16-bit
//       pairs of n, then four byte permutes (hopper.cuh s8_a_from_trans).
//       That gives a thread the k values {2t, 2t+1, 2t+8, 2t+9} (t = lane %
//       4) where the fragment wants 4t .. 4t+3, and the pair of n (2g, 2g+1)
//       where it wants rows g and g + 8: the k order is matched by the
//       permuted xq of (A) (sigma16), the row order by the epilogue, which
//       stores the pair of n side by side. At the end of each
//       qblock the s32 accumulators are scaled by sx into f32 accumulators
//       (a wgmma with scale-d 0 starts the next block). K splits are whole
//       qblocks, their partial sums reduced in a fixed order by a third
//       launch (splitk_reduce.cuh): no atomics, the same bits on every call.
// L2 reads at M = 4512 per decoder layer: each weight byte once per 192 rows
// (24 row tiles x 233 MB = 5.6 GB) and each xq byte once per 128 columns
// (8.2 GB); 128-row tiles took 3.06 ms a layer against 2.78 on an H100
// (scripts/torch_wgmma_variants.py). Sharing each weight tile between two
// 128-row tiles (a cluster of two blocks, TMA multicast) made the layer
// slower (3.29 against 3.03 ms), so the blocks work alone.
// Never compile this source with --use_fast_math: the division and rintf
// must round as IEEE does.

#include "gemv_tile.cuh"
#include "hopper.cuh"
#include "quant_wgmma.cuh"
#include "splitk_reduce.cuh"

namespace agk {
namespace w8a8 {

using namespace hopper;

constexpr int kThreads = 384;  // TMA warpgroup + two consumer warpgroups
constexpr int kBN = 128;       // output columns per block, 64 per consumer
constexpr int kBK = 128;       // K bytes per stage (one 128-byte swizzle row)
constexpr int kStages = 4;
constexpr int kQuantWarps = 4;
constexpr int kBM = 192;       // rows per block: the wgmma's N

// One warp per (row, qblock): lane l holds the block's 16-column group l
// (two 16-byte loads), the block's absmax comes from shuffles, and the lane
// writes its group's 16 quantized bytes in the permuted order, one 16-byte
// store. qblock <= 512, a multiple of 64. A product launched as this grid's
// programmatic dependent may start at once: it waits for this grid's end
// before it reads xq or sx.
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int K, int qblock, int m_pad) {
  launch_dependents();
  const int nq = K / qblock, item = blockIdx.x * kQuantWarps + threadIdx.x / 32;
  if (item >= M * nq) return;
  const int row = item / nq, blk = item % nq, lane = threadIdx.x % 32;
  const size_t base = (size_t)row * K + (size_t)blk * qblock + 16 * lane;
  const bool live = 16 * lane < qblock;
  float v[16];
  float amax = 0.f;
  if (live) {
    unpack8(*reinterpret_cast<const uint4*>(x + base), v);
    unpack8(*reinterpret_cast<const uint4*>(x + base + 8), v + 8);
#pragma unroll
    for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(v[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax, 1e-8f) / 127.f;
  if (live) {
    uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const int qv = (int)fminf(fmaxf(rintf(v[sigma16(p)] / s), -127.f), 127.f);
      q[p / 4] |= (uint32_t)(qv & 0xFF) << (8 * (p % 4));
    }
    *reinterpret_cast<uint4*>(xq + base) = make_uint4(q[0], q[1], q[2], q[3]);
  }
  if (lane == 0) sx[(size_t)blk * m_pad + row] = s;
}

template <int BM>
constexpr size_t smem_bytes() {
  return (size_t)kStages * (kBK * kBN + BM * kBK + BM * 4) + 2 * kStages * sizeof(uint64_t) +
         1024;
}
static_assert(smem_bytes<kBM>() <= 232448, "the ring exceeds a block's shared memory");

// Grid (ceil(M / BM), ceil(N / 128), splits); split z runs K columns [z *
// k_per_split, min(K, (z + 1) * k_per_split)), whole qblocks. Row tiles vary
// fastest, so the blocks in flight at once share a few weight column tiles
// and all of xq, and both stay in the L2 (with columns fastest, every wave
// streamed the whole weight from device memory again).
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap x_map, const float* __restrict__ sx,
                  const float* __restrict__ scales, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ partial, int M, int N, int K, int qblock,
                  int k_per_split, int m_pad) {
  constexpr int W_BYTES = kBK * kBN, X_BYTES = BM * kBK, S_BYTES = BM * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ws = smem;                      // [stage][k 128][n 128 bytes]
  unsigned char* xs = smem + kStages * W_BYTES;  // [stage][m BM][k 128 bytes]
  float* sxs = reinterpret_cast<float*>(xs + kStages * X_BYTES);  // [stage][m BM]
  uint64_t* full = reinterpret_cast<uint64_t*>(sxs + kStages * BM);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int k0 = blockIdx.z * k_per_split, k1 = min(K, k0 + k_per_split);
  const int stages = (k1 - k0 + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues the loads
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos pos;
      for (int it = 0; it < stages; ++it) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        mbar_expect_tx(&full[pos.stage], W_BYTES + X_BYTES + S_BYTES);
        const int k = k0 + it * kBK;
        const int blk = (min(k + kBK, k1) - 1) / qblock;  // at most one ends in a stage
        tma_load_2d(ws + pos.stage * W_BYTES, &w_map, &full[pos.stage], n0, k);
        tma_load_2d(xs + pos.stage * X_BYTES, &x_map, &full[pos.stage], k, m0);
        bulk_load(sxs + pos.stage * BM, sx + (size_t)blk * m_pad + m0, S_BYTES,
                  &full[pos.stage]);
        pos.advance(kStages);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int chunk = 4 * c + warp;  // this warp's 16 n: a 16-byte chunk of the weight rows
    int acc_i[BM / 2];  // the current qblock's exact sums
    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    int fresh = 1;  // the next wgmma starts a qblock
    RingPos pos;
    for (int it = 0; it < stages; ++it) {
      mbar_wait(&full[pos.stage], pos.phase);
      const uint32_t wbase = smem_u32(ws + pos.stage * W_BYTES);
      const uint32_t xbase = smem_u32(xs + pos.stage * X_BYTES);
      const int kst = k0 + it * kBK;
      uint32_t a[kBK / 32][4];
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s) {
        // lane gives row lane % 8 of matrix lane / 8: k rows 8q .. 8q + 7 of the step
        const int row = s * 32 + lane;
        uint32_t r[4];
        ldsm_x4_trans(r, wbase + row * 128 + ((chunk ^ (row & 7)) << 4));
        s8_a_from_trans(r, a[s]);
      }
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s) {
        const int kk = kst + s * 32;
        if (kk >= k1) break;  // the split's last stage may end early
        wgmma_fence();
        wgmma_s8_rs(acc_i, a[s], desc_sw128(xbase + s * 32, 16, 1024), fresh ? 0 : 1);
        wgmma_commit();
        fresh = 0;
        if ((kk + 32) % qblock == 0) {  // the end of a qblock: scale its sums by sx
          wgmma_wait<0>();
          fence_regs(acc_i);
          const float* s_blk = sxs + pos.stage * BM;  // rows past M: zero sums
#pragma unroll
          for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s_m = s_blk[8 * j + 2 * t + e];
              acc[4 * j + e] += (float)acc_i[4 * j + e] * s_m;
              acc[4 * j + 2 + e] += (float)acc_i[4 * j + 2 + e] * s_m;
            }
          }
          fresh = 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc_i);
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s) fence_regs(a[s]);  // live until the products are done
      if (lane == 0) mbar_arrive(&empty[pos.stage]);
      pos.advance(kStages);
    }
    // d[4j + 2h + e]: n = n0 + 64c + 16 warp + 2g + h, m = m0 + 8j + 2t + e
    const int n = n0 + 64 * c + 16 * warp + 2 * g;
    if (n < N) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * j + 2 * t + e;
          if (m >= M) continue;
          const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
          if (gridDim.z == 1)
            *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
                __floats2bfloat162_rn(v0 * scales[n], v1 * scales[n + 1]);
          else
            *reinterpret_cast<float2*>(partial + ((size_t)blockIdx.z * M + m) * N + n) =
                make_float2(v0, v1);
        }
      }
    }
  }
}

template <int BM>
static cudaError_t launch_tile(const int8_t* xq, const float* sx, const int8_t* w,
                               const float* scales, __nv_bfloat16* y, float* partial, int M,
                               int N, int K, int qblock, int k_per_split, int splits, int m_pad,
                               cudaStream_t stream) {
  CUtensorMap w_map, x_map;
  if (tensor_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, kBN, kBK) ||
      tensor_map_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, K, M, K, kBK, BM))
    return cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;
  constexpr size_t smem = smem_bytes<BM>();
  cudaError_t err = ensure_smem(w8a8_wgmma_kernel<BM>, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN, splits);
  w8a8_wgmma_kernel<BM><<<grid, kThreads, smem, stream>>>(w_map, x_map, sx, scales, y, partial, M,
                                                          N, K, qblock, k_per_split, m_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_reduce(partial, scales, y, M, N, splits, stream);
}

}  // namespace w8a8
}  // namespace agk

// C entry. Device pointers to contiguous tensors: x [M, K] bf16; w int8
// [K, N]; scales f32 [1, N]; scratch xq int8 [M, K] and sx f32 [K / qblock,
// m_pad] (m_pad: M rounded up to 192, zeros past M); y [M, N] bf16; partial
// f32 [splits, M, N] when splits > 1. The
// wrapper in affectgpt_tpu_torch/ops/quant.py (`w8a8_plan`) checks shapes,
// dtypes and alignment (M > 16, N % 16 == 0, K % qblock == 0, qblock % 64 ==
// 0) and makes k_per_split a multiple of qblock. Returns the first CUDA
// error of the launches, or 0.
extern "C" int agk_int8_matmul_w8a8(const void* x, const void* w, const void* scales, void* xq,
                                    void* sx, void* y, void* partial, int m, int n, int k,
                                    int qblock, int k_per_split, int splits, int m_pad,
                                    void* stream) {
  using namespace agk::w8a8;
  if (m <= 16 || m_pad % kBM) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xqp = static_cast<int8_t*>(xq);
  auto* sxp = static_cast<float*>(sx);
  const int items = m * (k / qblock);
  quantize_rows_kernel<<<(items + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), xqp, sxp, m, k, qblock, m_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* sp = static_cast<const float*>(scales);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partial);
  return (int)launch_tile<kBM>(xqp, sxp, wp, sp, yp, pp, m, n, k, qblock, k_per_split, splits,
                              m_pad, st);
}

// C entry of 16 < M <= the cut: quantize x into the scratch xq int8 [M, K]
// and sx f32 [K / qblock, M rounded up to 4], then the product on
// quant_wgmma.cuh's kW8A8 mode with the plan (nb, cb, ck, stages) of
// ops/quant.py::wgmma_plan(..., MODE_W8A8). Returns the first CUDA error of
// the two launches, or 0.
extern "C" int agk_int8_matmul_w8a8_wgmma(const void* x, const void* w, const void* scales,
                                          void* xq, void* sx, void* y, int m, int n, int k,
                                          int nb, int cb, int ck, int stages, void* stream) {
  using namespace agk::w8a8;
  const int qblock = k < 512 ? k : 512;
  if (m <= 16 || k < 64 || k % 64 || k % qblock) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int items = m * (k / qblock);
  quantize_rows_kernel<<<(items + kQuantWarps - 1) / kQuantWarps, kQuantWarps * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), m,
      k, qblock, (m + 3) / 4 * 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return agk::qwg::launch<agk::qwg::kW8A8>(xq, w, scales, y, m, n, k, nb, cb, ck, stages, stream,
                                           sx);
}

extern "C" int agk_int8_matmul_w8a8_wgmma_active_clusters(int nb, int cluster, int stages) {
  return agk::qwg::active_clusters<agk::qwg::kW8A8>(nb, cluster, stages);
}

extern "C" int agk_int8_matmul_w8a8_wgmma_blocks_per_sm(int nb) {
  return agk::qwg::blocks_an_sm<agk::qwg::kW8A8>(nb);
}
