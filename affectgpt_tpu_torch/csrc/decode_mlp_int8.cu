// Fused int8 decode MLP for the q=1 decode step on Hopper (sm_90a), with its
// products on tensor cores:
//   y = x + (down_q(silu((gate_q(rms(x)) * s_g)) * (up_q(rms(x)) * s_u)) * s_d)
// with per-channel int8 weights (the JAX `w_q` [in, out] leaves) and f32
// column scales.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/decode_mlp_pallas.py::
// decode_mlp_pallas. Rounding points are the TPU kernel's (decode_mlp_reference
// in ops/decode_mlp.py): xn = bf16(rms(x) * ln); gate and up as f32 sums of
// exact bf16 products times their column scales; bf16(silu(g) * u); down as
// an f32 sum times its column scales, + x, rounded once.
//
// Bound: the weights, 3 * h * I int8 bytes (203.7 MB a layer at Qwen2.5-7B
// width, 0.061 ms at 3.35 TB/s). The previous design (decode_mlp_int8_simt.cuh)
// multiplied on CUDA cores: every weight value cost b f32 multiply-adds, and
// each 8-row batch tile read the weights again, so it was arithmetic-bound
// from b = 16. Route (a) of the two open ones: mma.sync m16n8k16 in bf16 with
// the int8 weights converted in registers (as quant_swapab.cu and
// quant_wgmma.cuh do for the weight-only matmuls), here with the weight as
// the 16-row A operand and the batch rows as the 8-wide N
// (swap-AB: y^T = W^T x^T), so a 16-row batch tile (two n8 tiles) reads each
// weight byte once, and b up to 16 needs no second pass. The other route, a
// swap-AB wgmma (int8_matmul_w8a8.cu), needs its A operand in registers all
// the same, and its 64-row A tile would make each block stream 64 weight
// columns at a time: coarser strips than the grid needs here. Weights come
// in by TMA (one producer warp, an mbarrier ring, as hopper.cuh provides);
// each consumer warp turns a 16-bit transposed ldmatrix of the N-contiguous
// weight tile and byte permutes into the A fragments (k pairs of one n; n =
// 2g and 2g + 1 on fragment rows g and g + 8), converting each byte to bf16
// through f32 (a permute and a subtraction: int8 values are exact in both),
// while the batch rows' B fragments come from shared memory by ldmatrix.
// Two launches with a [b, I] bf16 scratch between them, no atomics, and
// every sum taken in a fixed order, so a call repeats bit for bit:
//   (A) gate and up: grid (ctas, row tiles of 16), about one block per SM.
//       A block rms-normalizes its 16 rows once into shared memory (bf16),
//       then walks 32-column strips of I (strip s, s + ctas, ...): per strip
//       the ring brings 256 k x 32 n of gate and of up a stage (32-byte
//       swizzled TMA boxes), eight consumer warps each multiply 32 k of the
//       stage, and at the strip's end the eight partial sums are added in
//       warp order, scaled, and silu(g)*u is rounded into the scratch. The
//       ring runs on across strips, so the producer never waits for an
//       epilogue.
//   (B) down: a cluster of 8 blocks per (128-column strip of h, row tile);
//       block r of the cluster takes the r-th eighth of I's 64-k steps (the
//       strips of h alone would be too few blocks for 132 SMs). A stage is
//       64 k x 128 n of the weight and 16 rows x 64 k of the scratch, both
//       by 128-byte swizzled TMA boxes; warp w of eight owns 16 columns. The
//       eight blocks' f32 partials meet through distributed shared memory:
//       block r adds columns [16 r, 16 r + 16) of all eight in rank order,
//       times the down scale, plus x.
// Launch plan: ops/decode_mlp.py::decode_mlp_plan (grid, strips, K ranges,
// shared memory), held on the CPU by tests/test_torch_launch_plans.py.

#include <stdint.h>

#include "decode_mlp_int8_simt.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace dmlp {

using namespace hopper;

constexpr int kRows = 16;         // batch rows a block covers (two n8 mma tiles)
constexpr int kConsumers = 8;     // consumer warps; one more warp issues the TMA loads
constexpr int kThreads = 32 * (kConsumers + 1);
// (A) gate and up
constexpr int kStrip = 32;        // columns of I per strip
constexpr int kStageK = 256;      // k per stage, 32 per consumer warp
constexpr int kTileA = kStageK * kStrip;  // one weight's box: 8 KB
constexpr int kStagesA = 4;
// (B) down
constexpr int kStripB = 128;      // columns of h per cluster, 16 per consumer warp
constexpr int kStageKB = 64;
constexpr int kTileB = kStageKB * kStripB;  // 8 KB
constexpr int kActTile = kRows * kStageKB * 2;  // 2 KB
constexpr int kStagesB = 6;
constexpr int kSplit = 8;         // blocks of a cluster, each an eighth of I

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// bytes of dynamic shared memory of (A): ring, xn rows (padded pitch), the
// eight warps' partials, barriers, alignment slack
__host__ __device__ constexpr size_t smem_gateup(int h) {
  return (size_t)kStagesA * 2 * kTileA + (size_t)kRows * (round_up(h, kStageK) + 8) * 2 +
         (size_t)kConsumers * 2 * kRows * kStrip * 4 + 2 * kStagesA * 8 + 1024;
}
constexpr size_t kSmemDown =
    (size_t)kStagesB * (kTileB + kActTile) + (size_t)kRows * kStripB * 4 + 2 * kStagesB * 8 + 1024;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// bytes lo and hi of `word` (int8 values biased by 128: word ^ 0x80808080)
// as a bf16 pair, lo in the low half. 2^23 + u as an f32 is exact; minus
// 2^23 + 128 leaves the int8 value, which bf16 holds exactly.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t biased, int lo, int hi) {
  const float a = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + lo)) - 8388736.f;
  const float b = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + hi)) - 8388736.f;
  return pack_bf16x2(a, b);
}

// The A fragments of two k16 steps for 16 weight columns from one
// ldmatrix.x4.trans of an N-contiguous int8 tile: matrix q holds rows 8q ..
// 8q + 7 (k), and a thread's word of it the bytes (k 2t, n 2g), (k 2t, n
// 2g + 1), (k 2t + 1, n 2g), (k 2t + 1, n 2g + 1). Fragment row g is n = 2g,
// row g + 8 is n = 2g + 1.
__device__ __forceinline__ void a_frags(const uint32_t (&r)[4], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t w0 = r[2 * s] ^ 0x80808080u, w1 = r[2 * s + 1] ^ 0x80808080u;
    a[s][0] = s8x2_to_bf16x2(w0, 0, 2);
    a[s][1] = s8x2_to_bf16x2(w0, 1, 3);
    a[s][2] = s8x2_to_bf16x2(w1, 0, 2);
    a[s][3] = s8x2_to_bf16x2(w1, 1, 3);
  }
}

// (A). Grid (ctas, row tiles); block (p, rt) covers batch rows [16 rt, 16 rt
// + 16) and strips p, p + ctas, ... of I.
template <bool PRODUCTS>
__global__ void __launch_bounds__(kThreads, 1)
gateup_kernel(const __grid_constant__ CUtensorMap wg_map, const __grid_constant__ CUtensorMap wu_map,
              const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln,
              const float* __restrict__ sg, const float* __restrict__ su,
              __nv_bfloat16* __restrict__ act, int b, int h, int inter, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int hp = round_up(h, kStageK), pitch = hp + 8;  // 16 bytes of pad: no bank conflicts
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ring + kStagesA * 2 * kTileA);
  float* part = reinterpret_cast<float*>(xs + kRows * pitch);  // [warp][gate, up][16][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kConsumers * 2 * kRows * kStrip);
  uint64_t* empty = full + kStagesA;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.y * kRows, strips = inter / kStrip, ksteps = hp / kStageK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesA; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer: one thread walks the stage sequence
    if (lane == 0) {
      RingPos pos;
      for (int s = blockIdx.x; s < strips; s += gridDim.x)
        for (int kt = 0; kt < ksteps; ++kt) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
          mbar_expect_tx(&full[pos.stage], 2 * kTileA);
          unsigned char* st = ring + pos.stage * 2 * kTileA;
          tma_load_2d(st, &wg_map, &full[pos.stage], s * kStrip, kt * kStageK);
          tma_load_2d(st + kTileA, &wu_map, &full[pos.stage], s * kStrip, kt * kStageK);
          pos.advance(kStagesA);
        }
    }
    return;
  }

  // xn = bf16(rms(x) * ln) for the tile's rows, zeros past b and past h
  for (int m = warp; m < kRows; m += kConsumers) {
    __nv_bfloat16* dst = xs + m * pitch;
    const bool live = row0 + m < b;
    const __nv_bfloat16* src = x + (size_t)(row0 + m) * h;
    float ss = 0.f;
    if (live)
      for (int i = lane * 8; i < h; i += 256) {
        float v[8];
        unpack8(*reinterpret_cast<const uint4*>(src + i), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float r = rsqrtf(ss / (float)h + eps);
    for (int i = lane * 8; i < hp; i += 256) {
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (live && i < h) {
        float v[8], s[8];
        unpack8(*reinterpret_cast<const uint4*>(src + i), v);
        unpack8(*reinterpret_cast<const uint4*>(ln + i), s);
        o = make_uint4(pack_bf16x2(v[0] * r * s[0], v[1] * r * s[1]),
                       pack_bf16x2(v[2] * r * s[2], v[3] * r * s[3]),
                       pack_bf16x2(v[4] * r * s[4], v[5] * r * s[5]),
                       pack_bf16x2(v[6] * r * s[6], v[7] * r * s[7]));
      }
      *reinterpret_cast<uint4*>(dst + i) = o;
    }
  }
  named_barrier(1, 32 * kConsumers);

  const int g = lane / 4, t = lane % 4;
  const int krow = 32 * warp + lane;  // this lane's ldmatrix row of a stage's tiles
  const uint32_t a_off = krow * kStrip;
  // B fragments: rows (lane % 8) + 8 (lane / 16), k + 8 ((lane / 8) % 2)
  const __nv_bfloat16* xrow = xs + ((lane % 8) + 8 * (lane / 16)) * pitch + 8 * ((lane / 8) % 2);
  RingPos pos;
  for (int s = blockIdx.x; s < strips; s += gridDim.x) {
    float acc[2][2][2][4];  // [gate, up][16-column group][8-row tile][fragment]
#pragma unroll
    for (int i = 0; i < 2 * 2 * 2 * 4; ++i) (&acc[0][0][0][0])[i] = 0.f;
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&full[pos.stage], pos.phase);
      const uint32_t st = smem_u32(ring + pos.stage * 2 * kTileA);
      uint32_t a[2][2][2][4];  // [weight][group][k16 step][register]
#pragma unroll
      for (int wt = 0; wt < 2; ++wt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          uint32_t r[4];
          ldsm_x4_trans(r, st + wt * kTileA + a_off + ((c ^ ((krow >> 2) & 1)) << 4));
          a_frags(r, a[wt][c]);
        }
      if (lane == 0) mbar_arrive(&empty[pos.stage]);  // the tiles are in registers
      pos.advance(kStagesA);
      uint32_t bx[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) ldmatrix_x4(bx[ks], xrow + kt * kStageK + 32 * warp + 16 * ks);
      if constexpr (PRODUCTS) {
#pragma unroll
        for (int wt = 0; wt < 2; ++wt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                mma_bf16(acc[wt][c][j], a[wt][c][ks], bx[ks][2 * j], bx[ks][2 * j + 1]);
      } else {  // diagnostic: the loads and conversions alone, folded into the output
#pragma unroll
        for (int wt = 0; wt < 2; ++wt)
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) sink_into(acc[wt][c][0][0], xor_fold(a[wt][c][ks]));
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) sink_into(acc[0][0][1][0], xor_fold(bx[ks]));
      }
    }
    // the strip's partials: d[j][e] at n = 16 c + 2 g + e / 2, row 8 j + 2 t + e % 2
    named_barrier(1, 32 * kConsumers);  // the previous strip's epilogue has read `part`
#pragma unroll
    for (int wt = 0; wt < 2; ++wt) {
      float* p = part + (warp * 2 + wt) * kRows * kStrip;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[(8 * j + 2 * t + e % 2) * kStrip + 16 * c + 2 * g + e / 2] = acc[wt][c][j][e];
    }
    named_barrier(1, 32 * kConsumers);
    for (int i = threadIdx.x; i < kRows * kStrip; i += 32 * kConsumers) {
      const int m = i / kStrip, col = s * kStrip + i % kStrip;
      if (row0 + m >= b) continue;
      float gs = 0.f, us = 0.f;
#pragma unroll
      for (int w = 0; w < kConsumers; ++w) {  // warp order: a fixed sum
        gs += part[(w * 2) * kRows * kStrip + i];
        us += part[(w * 2 + 1) * kRows * kStrip + i];
      }
      const float gv = gs * sg[col];
      act[(size_t)(row0 + m) * inter + col] = f2bf(gv / (1.f + expf(-gv)) * (us * su[col]));
    }
  }
}

// (B). Grid: 8 blocks (a cluster) per (strip of h, row tile), clusters with
// the same strip adjacent so that the row tiles' weight reads meet in L2.
template <bool PRODUCTS>
__global__ void __launch_bounds__(kThreads, 1)
down_kernel(const __grid_constant__ CUtensorMap wd_map, const __grid_constant__ CUtensorMap act_map,
            const __nv_bfloat16* __restrict__ residual, const float* __restrict__ sd,
            __nv_bfloat16* __restrict__ y, int b, int h, int inter, int row_tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  constexpr int kStageBytes = kTileB + kActTile;
  float* part = reinterpret_cast<float*>(ring + kStagesB * kStageBytes);  // [16][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kRows * kStripB);
  uint64_t* empty = full + kStagesB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = (int)cluster_rank(), cl = blockIdx.x / kSplit;
  const int row0 = (cl % row_tiles) * kRows, n0 = (cl / row_tiles) * kStripB;
  const int steps = inter / kStageKB;
  const int k0 = rank * steps / kSplit, k1 = (rank + 1) * steps / kSplit;  // in 64-k steps
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer
    if (lane == 0) {
      RingPos pos;
      for (int kt = k0; kt < k1; ++kt) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        mbar_expect_tx(&full[pos.stage], kStageBytes);
        unsigned char* st = ring + pos.stage * kStageBytes;
        tma_load_2d(st, &wd_map, &full[pos.stage], n0, kt * kStageKB);
        tma_load_2d(st + kTileB, &act_map, &full[pos.stage], kt * kStageKB, row0);
        pos.advance(kStagesB);
      }
    }
    cluster_sync();  // (1) the partials are written
    cluster_sync();  // (2) every block has read them
    return;
  }

  const int g = lane / 4, t = lane % 4;
  float acc[2][4] = {};  // [8-row tile][fragment]
  const int brow = (lane % 8) + 8 * (lane / 16);  // B fragments: scratch row, chunk parity
  const int bpar = (lane / 8) % 2;
  RingPos pos;
  for (int kt = k0; kt < k1; ++kt) {
    mbar_wait(&full[pos.stage], pos.phase);
    const uint32_t st = smem_u32(ring + pos.stage * kStageBytes);
    uint32_t a[4][4];  // four k16 steps
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = 32 * hf + lane;
      uint32_t r[4], two[2][4];
      ldsm_x4_trans(r, st + row * 128 + ((warp ^ (row & 7)) << 4));
      a_frags(r, two);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[2 * hf][i] = two[0][i];
        a[2 * hf + 1][i] = two[1][i];
      }
    }
    uint32_t bx[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldsm_x4(bx[ks], st + kTileB + brow * 128 + (((2 * ks + bpar) ^ (brow & 7)) << 4));
    if (lane == 0) mbar_arrive(&empty[pos.stage]);
    pos.advance(kStagesB);
    if constexpr (PRODUCTS) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[j], a[ks], bx[ks][2 * j], bx[ks][2 * j + 1]);
    } else {  // diagnostic: the loads and conversions alone, folded into the output
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) sink_into(acc[ks % 2][0], xor_fold(a[ks]) ^ xor_fold(bx[ks]));
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(8 * j + 2 * t + e % 2) * kStripB + 16 * warp + 2 * g + e / 2] = acc[j][e];
  cluster_sync();  // (1)
  {
    const int m = threadIdx.x / 16, c = 16 * rank + threadIdx.x % 16;
    const uint32_t local = smem_u32(part + m * kStripB + c);
    float sum = 0.f;
#pragma unroll
    for (int src = 0; src < kSplit; ++src) sum += ld_cluster_f32(map_to_rank(local, src));
    if (row0 + m < b) {
      const size_t o = (size_t)(row0 + m) * h + n0 + c;
      // a null residual is the tensor-parallel partial: the product alone
      y[o] = residual != nullptr ? f2bf(bf2f(residual[o]) + sum * sd[n0 + c])
                                 : f2bf(sum * sd[n0 + c]);
    }
  }
  cluster_sync();  // (2) no block leaves while another may read its partials
}

template <bool PRODUCTS>
cudaError_t launch(const CUtensorMap& wg_map, const CUtensorMap& wu_map, const CUtensorMap& wd_map,
                   const CUtensorMap& act_map, const __nv_bfloat16* x, const __nv_bfloat16* ln,
                   const float* sg, const float* su, const float* sd, __nv_bfloat16* act,
                   __nv_bfloat16* y, int b, int h, int inter, int ctas, int row_tiles, float eps,
                   bool residual, cudaStream_t st) {
  static size_t granted_a = 48 * 1024, granted_b = 48 * 1024;
  const size_t smem_a = smem_gateup(h);
  cudaError_t err = ensure_smem(gateup_kernel<PRODUCTS>, smem_a, &granted_a);
  if (err != cudaSuccess) return err;
  gateup_kernel<PRODUCTS><<<dim3(ctas, row_tiles), kThreads, smem_a, st>>>(
      wg_map, wu_map, x, ln, sg, su, act, b, h, inter, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = ensure_smem(down_kernel<PRODUCTS>, kSmemDown, &granted_b);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit * (h / kStripB) * row_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemDown;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, down_kernel<PRODUCTS>, wd_map, act_map,
                           residual ? x : nullptr, sd, y, b, h, inter, row_tiles);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dmlp
}  // namespace agk

// C entry. Device pointers to contiguous tensors: x, y [b, h] and ln [h]
// bf16; wg, wu [h, I] and wd [I, h] int8; sg, su [1, I] and sd [1, h] f32;
// act is [b, I] bf16 scratch. ctas and row_tiles are the grid of launch (A)
// from the wrapper's plan (ops/decode_mlp.py::decode_mlp_plan), which checks
// shapes, dtypes, alignment and limits (h % 128 == 0, I % 64 == 0, launch
// (A)'s shared memory). variant: 0 the kernels; 1 the same without the
// tensor-core products (a diagnostic: the loads and conversions alone; its
// result is wrong); 2 the previous CUDA-core design (decode_mlp_int8_simt.cuh,
// a yardstick, with the residual only). residual 0 drops the + x of (B): y is
// the MLP alone, a tensor-parallel rank's partial sum, which the caller
// reduces over the ranks before it adds x once. Returns the first CUDA error
// of the launches, or 0.
extern "C" int agk_decode_mlp_int8(const void* x, const void* ln, const void* wg, const void* sg,
                                   const void* wu, const void* su, const void* wd, const void* sd,
                                   void* act, void* y, int b, int h, int inter, int ctas,
                                   int row_tiles, int variant, float eps, int residual,
                                   void* stream) {
  using namespace agk;
  using bf = __nv_bfloat16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf*>(x);
  const auto* lnp = static_cast<const bf*>(ln);
  const auto* sgp = static_cast<const float*>(sg);
  const auto* sup = static_cast<const float*>(su);
  const auto* sdp = static_cast<const float*>(sd);
  auto* actp = static_cast<bf*>(act);
  auto* yp = static_cast<bf*>(y);
  if (variant == 2 && !residual) return (int)cudaErrorInvalidValue;
  if (variant == 2)
    return (int)simt::launch(xp, lnp, static_cast<const int8_t*>(wg), sgp,
                             static_cast<const int8_t*>(wu), sup, static_cast<const int8_t*>(wd),
                             sdp, actp, yp, b, h, inter, eps, st);
  if (h % dmlp::kStripB || inter % dmlp::kStageKB || ctas < 1 || row_tiles * dmlp::kRows < b ||
      (variant != 0 && variant != 1))
    return (int)cudaErrorInvalidValue;
  using hopper::tensor_map_2d;
  CUtensorMap wg_map, wu_map, wd_map, act_map;
  constexpr auto kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  constexpr auto kSw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  if (tensor_map_2d(&wg_map, kU8, wg, inter, h, inter, dmlp::kStrip, dmlp::kStageK, kSw32) ||
      tensor_map_2d(&wu_map, kU8, wu, inter, h, inter, dmlp::kStrip, dmlp::kStageK, kSw32) ||
      tensor_map_2d(&wd_map, kU8, wd, h, inter, h, dmlp::kStripB, dmlp::kStageKB) ||
      tensor_map_2d(&act_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, act, inter, b, 2ull * inter,
                    dmlp::kStageKB, dmlp::kRows))
    return (int)cudaErrorInvalidValue;
  return (int)(variant == 0
                   ? dmlp::launch<true>(wg_map, wu_map, wd_map, act_map, xp, lnp, sgp, sup, sdp,
                                        actp, yp, b, h, inter, ctas, row_tiles, eps, residual != 0,
                                        st)
                   : dmlp::launch<false>(wg_map, wu_map, wd_map, act_map, xp, lnp, sgp, sup, sdp,
                                         actp, yp, b, h, inter, ctas, row_tiles, eps,
                                         residual != 0, st));
}
