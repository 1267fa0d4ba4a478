// A bf16 GEMM on Hopper's wgmma fed by TMA (sm_90a), with the encoder
// kernels' epilogues: y[M, N] = bf16(act(a @ w + bias)) or bf16(a @ w + bias
// + res), all in f32 first, one rounding. a is [M, K] row-major (K-major);
// w is [K, N] row-major, the JAX `[in, out]` layout (a 16-bit MN-major wgmma
// operand, so no transposed copy of the weights is made).
//
// Bound: operations (the encoder MLP's two products: 276 GFLOP a CLIP layer
// at 64 images, 0.279 ms at 989 TFLOP/s). The mma.sync design this replaces
// (vit_gemm.cuh: 128 x 128 tiles, a cp.async ring of three 32-k slices) ran
// its products at about 230 TFLOP/s. Design, the usual Hopper GEMM built
// from hopper.cuh: 128 x 256 output tiles, three warpgroups a block.
// Warpgroup 0 gives up its registers (setmaxnreg) and one of its threads
// keeps a ring of four 48 KB stages full by TMA: a's 128 rows x 64 k (one
// 128-byte swizzled box) and w's 64 k x 256 n (four 64-column boxes).
// Warpgroups 1 and 2 each multiply 64 of the rows with wgmma.m64n256k16
// (128 f32 accumulators a thread), four per stage, and release a stage one
// wgmma group late. Rows of a past M, k past K and columns of w past N
// arrive from TMA as zeros. The epilogue passes each warpgroup's bf16 64 x
// 256 result, in two halves, through its 16 KB of staging shared memory:
// stmatrix writes the accumulators' layout (four 8 x 8 pieces an
// instruction, 128-byte rows with the 16-byte chunks swizzled, so no bank
// conflicts), then each thread copies whole 16-byte chunks to rows < M and
// columns < N (a warp writes two full rows of 256 bytes). The residual
// comes by TMA loads into the staging memory, the first half issued when
// the tile starts, and is read with ldmatrix; the tile's bias is read from
// shared memory too, so the 128 accumulators fit the 168 registers the
// launch bound leaves without spills.
// The blocks are persistent, one per SM, in clusters of CM = 2 (where there
// are two row tiles): a cluster walks units u, u + clusters, ..., each a
// column tile and two neighbouring row tiles, one a block (column tiles
// fastest, so the blocks in flight share a few row tiles of a and all of w,
// 8 MB at the towers' width, in the L2). Each block loads half of a
// stage's w boxes and multicasts them into both blocks' rings, and a stage
// is refilled once the consumers of both blocks have released it: a block
// reads 32 KB a stage from L2 instead of 48. The producer runs on into the
// next unit while the consumers store this one.
// Why this shape (measured on an H100 80GB HBM3 at 700 W, CLIP's shape;
// PERF.md section 6, scripts/torch_wgmma_variants.py --only mlp): without
// its epilogue, fc1 runs its k loop at about 0.15 ms, near the products'
// 0.14 ms, so what decides the time is the epilogue, which the consumers
// run between k loops, not overlapped with the products. Stores and
// residual loads straight from the accumulators' layout (8 rows of 16 bytes
// a warp instruction) cost more than the k loop; staging a whole tile took
// the ring's fourth stage (the k loops 0.025-0.04 ms slower), and TMA
// stores out of half a tile made each half wait for the last one's reads,
// hence half a tile, stmatrix and copies by the threads. The activations'
// special-function operations are most of what the epilogue still costs.
// Splitting HuBERT's short last rounds (fc1 6.06 rounds of units, fc2 1.52)
// by k steps over all clusters (stream-K) made it slower: a split unit
// still pays a whole epilogue. Warpgroups taking turns on 64-row tiles of
// their own, one's epilogue under the other's k loop, made it slower too
// (0.50 ms at CLIP's shape, as long without the products): each stage then
// brings 24 KB for half the products, and the loads bound the k loops.
// Launch plan: ops/vit_mlp.py::gemm_plan (grid, tiles, k steps, shared
// memory, L2 bytes), held on the CPU by tests/test_torch_launch_plans.py.
#pragma once

#include "hopper.cuh"
#include "vit_gemm.cuh"

namespace agk {
namespace vit {
namespace wg {

using namespace hopper;

constexpr int kThreads = 384;  // TMA warpgroup + two consumer warpgroups
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kATile = kBM * kBK * 2;            // 16 KB
constexpr int kBBox = kBK * 64 * 2;              // 8 KB: 64 k x 64 n
constexpr int kStageBytes = kATile + (kBN / 64) * kBBox;  // 48 KB
constexpr int kOutBox = 64 * 64 * 2;  // 8 KB: 64 rows x 64 columns of the result
constexpr int kOutBytes = 2 * kOutBox;  // 16 KB: half a warpgroup's 64 x 256, staged at a time
constexpr size_t kSmem = (size_t)kStages * kStageBytes + 2 * kOutBytes + 2 * kBN * 2 +
                         (2 * kStages + 2) * 8 + 1024;
static_assert(kSmem <= 232448, "the ring and staging exceed a block's shared memory");

// The epilogue's activation of a pair of values, with the special-function
// unit's exponential and one reciprocal for both values of the pair: the
// activations' special-function operations bound fc1's epilogue (16 a clock
// an SM), and the epilogue is not overlapped with the products. With expf
// and an IEEE division quick_gelu took fc1 0.05 ms longer at CLIP's shape;
// with erff the erf gelu took 0.039 ms of HuBERT's fc1.
//   quick_gelu: t / (1 + e^(-1.702 t)), the pair's 1 / ((1 + a0)(1 + a1));
//     arguments clamped to +-40, where the sigmoid is 0 or 1 to f32.
//   gelu: 0.5 t (1 + erf(t / sqrt 2)) with the TPU kernel's erf
//     (vit_mlp_pallas.py _erf, Abramowitz-Stegun 7.1.26, absolute error at
//     most 1.5e-7), the pair's 1 / ((1 + p z0)(1 + p z1)).
template <int ACT>
__device__ __forceinline__ void activate_pair(float& v0, float& v1) {
  if constexpr (ACT == kActQuickGelu) {
    const float p0 = 1.f + __expf(fminf(fmaxf(-1.702f * v0, -40.f), 40.f));
    const float p1 = 1.f + __expf(fminf(fmaxf(-1.702f * v1, -40.f), 40.f));
    const float r = __fdividef(1.f, p0 * p1);
    v0 *= p1 * r;
    v1 *= p0 * r;
  } else {
    static_assert(ACT == kActGelu, "quick_gelu or gelu");
    constexpr float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
    constexpr float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
    const float z0 = fabsf(v0) * 0.7071067811865476f, z1 = fabsf(v1) * 0.7071067811865476f;
    const float d0 = 1.f + p * z0, d1 = 1.f + p * z1;
    const float r = __fdividef(1.f, d0 * d1);
    const float t0 = d1 * r, t1 = d0 * r;
    const float q0 = t0 * (a1 + t0 * (a2 + t0 * (a3 + t0 * (a4 + t0 * a5))));
    const float q1 = t1 * (a1 + t1 * (a2 + t1 * (a3 + t1 * (a4 + t1 * a5))));
    const float e0 = copysignf(1.f - q0 * __expf(-z0 * z0), v0);
    const float e1 = copysignf(1.f - q1 * __expf(-z1 * z1), v1);
    v0 = 0.5f * v0 * (1.f + e0);
    v1 = 0.5f * v1 * (1.f + e1);
  }
}

// LayerNorm of rows of w = 256 VEC values (w = 1024 at the towers' width):
// vit_gemm.cuh's layernorm_row arithmetic, one warp a row, with registers
// for VEC 8-value vectors a lane only (that kernel holds room for 8 whatever
// w is, which at w = 1024 left it about half the bandwidth's pace: 0.036 ms
// for CLIP's 34 MB of rows, in and out). h[rows, w] = bf16((x - mean) *
// rsqrt(var + eps) * scale + bias).
template <int VEC>
__global__ void __launch_bounds__(256)
layernorm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ scale,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ h, int rows,
                 float eps) {
  constexpr int w = 256 * VEC;
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* xr = x + (size_t)row * w;
  float v[VEC][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    unpack8(*reinterpret_cast<const uint4*>(xr + (lane + 32 * i) * 8), v[i]);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[i][e];
  }
  const float mean = warp_allsum(sum) / (float)w;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[i][e] - mean;
      sq += d * d;
    }
  const float inv = rsqrtf(warp_allsum(sq) / (float)w + eps);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = (lane + 32 * i) * 8;
    float sc[8], b[8];
    unpack8(*reinterpret_cast<const uint4*>(scale + c), sc);
    unpack8(*reinterpret_cast<const uint4*>(bias + c), b);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = pack_bf16x2((v[i][2 * e] - mean) * inv * sc[2 * e] + b[2 * e],
                         (v[i][2 * e + 1] - mean) * inv * sc[2 * e + 1] + b[2 * e + 1]);
    *reinterpret_cast<uint4*>(h + (size_t)row * w + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// h = LN(x) by layernorm_kernel where w is a multiple of 256 up to 2048,
// else by vit_gemm.cuh's launch_layernorm.
static inline cudaError_t launch_layernorm_rows(const __nv_bfloat16* x, const __nv_bfloat16* scale,
                                                const __nv_bfloat16* bias, __nv_bfloat16* h,
                                                int rows, int w, float eps, cudaStream_t stream) {
  const int blocks = (rows + 7) / 8;
  switch (w) {
    case 256: layernorm_kernel<1><<<blocks, 256, 0, stream>>>(x, scale, bias, h, rows, eps); break;
    case 512: layernorm_kernel<2><<<blocks, 256, 0, stream>>>(x, scale, bias, h, rows, eps); break;
    case 1024: layernorm_kernel<4><<<blocks, 256, 0, stream>>>(x, scale, bias, h, rows, eps); break;
    case 2048: layernorm_kernel<8><<<blocks, 256, 0, stream>>>(x, scale, bias, h, rows, eps); break;
    default: return launch_layernorm(x, scale, bias, h, rows, w, eps, stream);
  }
  return cudaGetLastError();
}

// Grid (blocks), clusters of CM blocks: cluster c computes units c, c +
// gridDim.x / CM, ... of the n_tiles x (m_tiles / CM) units, unit u at
// column tile u % n_tiles and row tiles CM (u / n_tiles) + rank. res_map is
// the residual's map (64 x 64 boxes), y the result [M, N]. PRODUCTS = false
// drops the wgmma instructions: a diagnostic of what the loads, barriers
// and epilogue cost alone.
template <int ACT, bool RESIDUAL, bool PRODUCTS, int CM>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
            const __grid_constant__ CUtensorMap res_map,
            const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, int M, int N,
            int K, int n_tiles, int units) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = ring + kStages * kStageBytes;  // [warpgroup][2 boxes][64 rows][128 B]
  // per consumer warpgroup, the tile's bias (kBN bf16), loaded when the tile starts
  __nv_bfloat16* bias_s = reinterpret_cast<__nv_bfloat16*>(staging + 2 * kOutBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + 2 * kBN);
  uint64_t* empty = full + kStages;
  uint64_t* res_bar = empty + kStages;  // per consumer warpgroup
  const int ksteps = (K + kBK - 1) / kBK;
  const int rank = CM > 1 ? (int)cluster_rank() : 0, clusters = gridDim.x / CM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * CM);  // lane 0 of each consumer warp of the cluster
    }
    mbar_init(&res_bar[0], 1);
    mbar_init(&res_bar[1], 1);
    mbar_fence_init();
  }
  if constexpr (CM > 1)
    cluster_sync();  // the other block's barriers exist before any multicast
  else
    __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues the loads
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      RingPos pos;
      for (int u = blockIdx.x / CM; u < units; u += clusters) {
        const int n0 = (u % n_tiles) * kBN, m0 = ((u / n_tiles) * CM + rank) * kBM;
        for (int kt = 0; kt < ksteps; ++kt) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
          mbar_expect_tx(&full[pos.stage], kStageBytes);
          unsigned char* st = ring + pos.stage * kStageBytes;
          tma_load_2d(st, &a_map, &full[pos.stage], kt * kBK, m0);
          constexpr int kBoxes = kBN / 64 / CM;  // this block's share of w's boxes
#pragma unroll
          for (int i = 0; i < kBoxes; ++i) {
            const int q = rank * kBoxes + i;
            if constexpr (CM > 1)
              tma_load_2d_multicast(st + kATile + q * kBBox, &w_map, &full[pos.stage],
                                    n0 + 64 * q, kt * kBK, (1u << CM) - 1);
            else
              tma_load_2d(st + kATile + q * kBBox, &w_map, &full[pos.stage], n0 + 64 * q,
                          kt * kBK);
          }
          pos.advance(kStages);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int g = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* out = staging + g * kOutBytes;
  auto release = [&](int stage) {  // in every block of the cluster
    if (lane != 0) return;
    if constexpr (CM > 1) {
#pragma unroll
      for (int r = 0; r < CM; ++r) mbar_arrive_remote(map_to_rank(smem_u32(&empty[stage]), r));
    } else {
      mbar_arrive(&empty[stage]);
    }
  };
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  RingPos pos;
  uint32_t res_phase = 0;
  for (int u = blockIdx.x / CM; u < units; u += clusters) {
    const int n0 = (u % n_tiles) * kBN, m0 = ((u / n_tiles) * CM + rank) * kBM;
    const int mw = m0 + 64 * g;  // this warpgroup's rows
    auto load_residual = [&](int half) {  // once every thread is done with the staging memory
      fence_proxy_async();
      mbar_expect_tx(&res_bar[g], kOutBytes);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        tma_load_2d(out + q * kOutBox, &res_map, &res_bar[g], n0 + 128 * half + 64 * q, mw);
    };
    if (RESIDUAL && leader) load_residual(0);
    {  // the tile's bias into shared memory, read by the epilogue after its first barrier
      const int tid = threadIdx.x % 128, col = n0 + 2 * tid;
      reinterpret_cast<__nv_bfloat162*>(bias_s + g * kBN)[tid] =
          *reinterpret_cast<const __nv_bfloat162*>(bias + min(col, N - 2));
    }
    int prev = -1;
    for (int kt = 0; kt < ksteps; ++kt) {
      mbar_wait(&full[pos.stage], pos.phase);
      const uint32_t st = smem_u32(ring + pos.stage * kStageBytes);
      const uint32_t a = st + 64 * 128 * g;  // this warpgroup's 64 rows
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        if constexpr (PRODUCTS)  // a tile's first product discards the last tile's sums
          wgmma_bf16_ss_tb(acc, desc_sw128(a + 32 * ks, 16, 1024),
                           desc_sw128(st + kATile + 2048 * ks, kBBox, 1024), (kt | ks) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (prev >= 0) release(prev);
      prev = pos.stage;
      pos.advance(kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0) release(prev);

    // In two halves of 128 columns. acc[4j + 2h + e] is row 16 warp + lane /
    // 4 + 8 h of the warpgroup's 64, column 8 j + 2 (lane % 4) + e; in the
    // staging memory column 8 j is 16-byte chunk j % 8 of box (j / 8) % 2,
    // swizzled. One ldmatrix / stmatrix moves the pieces (h, j), (h + 1, j),
    // (h, j + 1), (h + 1, j + 1): lane l addresses row l % 8 of piece l / 8.
    const int pr = 16 * warp + 8 * ((lane / 8) % 2) + lane % 8;  // this lane's piece row
    const uint32_t prow = smem_u32(out) + pr * 128;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if constexpr (RESIDUAL) {
        if (half == 1 && leader) load_residual(1);
        mbar_wait(&res_bar[g], res_phase);
        res_phase ^= 1u;
      }
      if (half == 0) named_barrier(1 + g, 128);  // the tile's bias is in shared memory
#pragma unroll
      for (int j = 16 * half; j < 16 * half + 16; j += 2) {
        const int jj = j + lane / 16;  // this lane's piece column
        const uint32_t at = prow + ((jj / 8) % 2) * kOutBox + (((jj % 8) ^ (pr % 8)) << 4);
        float v[8];  // pieces (0, j), (1, j), (0, j + 1), (1, j + 1), two values each
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jq = j + q / 2, h = q % 2;
          const float2 bv = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
              bias_s + g * kBN)[4 * jq + lane % 4]);
          v[2 * q] = acc[4 * jq + 2 * h] + bv.x;
          v[2 * q + 1] = acc[4 * jq + 2 * h + 1] + bv.y;
        }
        if constexpr (RESIDUAL) {
          uint32_t r[4];
          ldsm_x4(r, at);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r[q]));
            v[2 * q] += rf.x;
            v[2 * q + 1] += rf.y;
          }
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) activate_pair<ACT>(v[2 * q], v[2 * q + 1]);
        }
        const uint32_t o[4] = {pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                               pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7])};
        stsm_x4(at, o);
      }
      named_barrier(1 + g, 128);
      // copy out: 64 rows x 16 chunks, 8 a thread, 16 threads a row
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = threadIdx.x % 128 + 128 * k, row = i / 16, c = i % 16;
        const uint32_t src = smem_u32(out) + (c / 8) * kOutBox + row * 128 +
                             (((c % 8) ^ (row % 8)) << 4);
        uint4 val;
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                     : "r"(src));
        const int grow = mw + row, gcol = n0 + 128 * half + 8 * c;
        if (grow < M && gcol < N)
          *reinterpret_cast<uint4*>(y + (size_t)grow * N + gcol) = val;
      }
      named_barrier(1 + g, 128);  // the staging memory is free again
    }
  }
  if constexpr (CM > 1) cluster_sync();  // no block leaves while the other may arrive on it
}

// y = epi(a[M, K] @ w[K, N]) on `blocks` persistent blocks in clusters of
// `cluster` (1 or 2) over n_tiles x m_tiles tiles (the plan's: they cover
// M and N, m_tiles a multiple of the cluster, tiles past M store nothing).
// a, w, y, bias and res contiguous, 16-byte aligned, K and N multiples of 8
// (TMA's 16-byte row strides).
template <int ACT, bool RESIDUAL, bool PRODUCTS>
static cudaError_t launch_gemm(const __nv_bfloat16* a, const __nv_bfloat16* w,
                               const __nv_bfloat16* bias, const __nv_bfloat16* res,
                               __nv_bfloat16* y, int M, int N, int K, int n_tiles, int m_tiles,
                               int blocks, int cluster, cudaStream_t stream) {
  if (K % 8 || N % 8 || n_tiles * kBN < N || (n_tiles - 1) * kBN >= N || m_tiles * kBM < M ||
      (m_tiles - cluster) * kBM >= M || (cluster != 1 && cluster != 2) || m_tiles % cluster ||
      blocks < cluster || blocks % cluster)
    return cudaErrorInvalidValue;
  CUtensorMap a_map, w_map, res_map;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (tensor_map_2d(&a_map, kBf16, a, K, M, 2ull * K, kBK, kBM) ||
      tensor_map_2d(&w_map, kBf16, w, N, K, 2ull * N, 64, kBK) ||
      (RESIDUAL && tensor_map_2d(&res_map, kBf16, res, N, M, 2ull * N, 64, 64)))
    return cudaErrorInvalidValue;
  if (!RESIDUAL) res_map = a_map;  // unused
  static size_t granted1 = 48 * 1024, granted2 = 48 * 1024;
  auto kernel = cluster == 2 ? gemm_kernel<ACT, RESIDUAL, PRODUCTS, 2>
                             : gemm_kernel<ACT, RESIDUAL, PRODUCTS, 1>;
  cudaError_t err = ensure_smem(kernel, kSmem, cluster == 2 ? &granted2 : &granted1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a_map, w_map, res_map, bias, y, M, N, K, n_tiles,
                           n_tiles * (m_tiles / cluster));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace vit
}  // namespace agk
