// The quantized matmuls at decode M (1 <= M <= 16; above it quant_wgmma.cuh
// and int8_matmul_w8a8.cu) on Hopper (sm_90a), one design for int4 and int8
// weights: y [M, N] = x [M, K] (bf16) against an integer weight in the JAX
// [K, N] layout (N contiguous, no repacked copy). Four modes:
//   int4_matmul (replaces the Pallas kernel affectgpt_tpu/ops/quant.py::
//     int4_matmul): w_p int8 [K/2, N] packed (low nibble = row k, high
//     nibble = row k + K/2), f32 scales [K/128, N]; each 128-row scale
//     group's f32 sum of bf16(x) times the raw int4 values (exact in bf16),
//     times scales[g, n], added to the f32 accumulator; rounded once.
//   int4_matmul_smallm (replaces quant.py::int4_matmul_smallm): each weight
//     is bf16(f32(value) * scales[g, n]) before the product; bf16(x) times
//     those in f32; rounded once.
//   int8_matmul (replaces quant.py::int8_matmul): w_q int8 [K, N], f32
//     per-channel scales [1, N]; bf16(x) times the int8 values (exact in
//     bf16) summed in f32, times scales[n] once in the epilogue, rounded
//     once.
//   int8_matmul_w8a8 (replaces quant.py::int8_matmul_w8a8 at M <= 16): the
//     same weights; x quantized per (row, qblock = min(512, K) columns), sx
//     = max(absmax, 1e-8) / 127 and xq = clip(rint(x / sx), +-127) by IEEE
//     division (never build this source with --use_fast_math); each
//     qblock's int8 x int8 sum exact in int32 (mma m16n8k32 s8), times the
//     row's sx in f32; the qblocks' terms summed in f32, times scales[n],
//     rounded once. See "The w8a8 mode" below.
//
// Bound: the weight bytes (116.5 MB a Qwen2.5-7B layer packed int4, 233 MB
// int8: 0.035 / 0.070 ms at 3.35 TB/s), each read once for at most 16
// multiply-adds a value. The previous design (a 16-row mma.sync tile, since
// removed) took the x rows as the 16-row A operand of mma.sync (half or more
// of the rows zeros at M <= 8), turned each weight byte into bf16 in shared
// memory, kept one unit of loads in flight between two __syncthreads and
// reduced its K split in a second launch: latency-bound at a fifth (int4) or under half
// (int8) of the bytes bound. This one (after decode_mlp_int8.cu) streams the
// wide products' weights at 2.2-2.4 TB/s on the H100 (the int4 loads alone
// take 0.067 ms a layer, the memory system's rate for 128-byte rows of an
// N-strided weight); int4_matmul runs within a quarter of that, and
// int4_matmul_smallm's per-weight scaling adds about 0.03 ms a layer
// (scripts/torch_wgmma_variants.py --only int4):
//   - swap-AB: y^T = W^T x^T on mma.sync m16n8k16 bf16. 16 weight columns are
//     the A operand's rows and the batch rows the n8 operand (one n8 tile for
//     M <= 8, two for M <= 16), so each weight byte is read once whatever M.
//   - weights by TMA: a block owns a strip of N (128 columns: one 128-byte
//     box row; 256-column int8 blocks, two box rows, streamed no faster) and
//     walks its K range in stages of 16 KB of weights (int4: 128 packed rows,
//     one scale group of each K-half, with its two scale rows; int8: 128
//     rows), plus
//     the stage's x columns (64-column boxes of 8 or 16 rows), all on one
//     mbarrier of a ring of five stages (int4 at M > 8: four) that one
//     producer thread keeps full; two blocks an SM keep up to 160 KB of
//     weights in flight.
//   - fragments in registers: each of eight consumer warps owns 16 columns;
//     a 16-bit transposed ldmatrix of the
//     N-contiguous tile gives each thread the bytes (k 2t, n 2g), (k 2t, n
//     2g + 1), (k 2t + 1, n 2g), (k 2t + 1, n 2g + 1): fragment row g is n =
//     2g, row g + 8 is n = 2g + 1. int4: the low nibbles build the A
//     fragment of the low K-half, the high nibbles that of the high half; a
//     nibble becomes bf16 without I2F: (nibble ^ 8) | 0x4300 is the bf16 128
//     + value + 8, and one bf16x2 subtraction of 136 leaves the signed value,
//     exactly. The scales enter per fragment row: int4_matmul scales each
//     group's f32 fragment sums, int4_matmul_smallm multiplies each value by
//     its scale in f32 and rounds the pair to bf16 (building the f32 in
//     place from the nibble's bit position, with fewer integer operations,
//     ran slower). int8: bytes 0, 2 and 1, 3 of a word are the pairs of one
//     fragment row, each an exact bf16 pair in two logic operations and one
//     bf16x2 FMA (mma_bf16.cuh s8_halves_to_bf16x2); the per-channel scale
//     enters in the epilogue only.
//   - K split over a cluster of up to 8 blocks: one cluster a column block,
//     block r taking the r-th share of K's units (wide products, such as
//     gate/up_proj and the lm_head, fill the card with whole-K blocks, a
//     cluster of one, and store from registers). The f32 partials meet
//     through distributed shared memory: each block sums its share of the
//     output tile over the cluster's blocks in rank order, between two
//     rounds of the cluster barrier that only the consumer warps take (the
//     producer warp leaves once it has issued its stages; a persistent grid,
//     whose producer had to take the rounds too, was no faster). One launch
//     a product, no atomics: two calls give the same bits.
// Launch plans (cluster size, grid, shared memory): ops/quant.py::int4_plan
// and int8_plan, held on the CPU by tests/test_torch_launch_plans.py.

#include <stdint.h>

#include "gemv_tile.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace sab {

using namespace hopper;

constexpr int kConsumers = 8;                 // warps of 16 weight columns each
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kBN = 16 * kConsumers;          // columns of N a block owns: one 128-byte box row
constexpr int kBKP = 128;                     // packed rows a stage: one scale group of each half
constexpr int kMaxCluster = 8;
constexpr int kWTile = kBKP * kBN;            // 16 KB of packed weights a stage
constexpr int kScaleTile = 2 * kBN * 4;       // the stage's two scale rows
constexpr int kXBoxK = 64;                    // x columns a TMA box (128 bytes)

// Diagnostics, all true in the package; scripts/torch_wgmma_variants.py and
// scripts/torch_int8_probe.py switch them off in a copy to split the kernel's time (the results of
// such a build are wrong). Whatever a switched-off part would have consumed
// still reaches the output (the fragments through an XOR sink into the
// accumulator): ptxas deletes work whose results reach no store, and an
// empty asm statement (fence_regs) emits no instruction to stop it.
constexpr bool kConvert = true;   // weights to bf16 fragments, and the dequant scaling
constexpr bool kProducts = true;  // the tensor-core products
constexpr bool kConsume = true;   // the consumers read their stages at all

// A stage: the weight box, the x boxes, the scale rows. The ring is as deep
// as two blocks an SM leave room for (a ring of eight, one block an SM, moved
// nothing on the H100: the memory system's rate for these 128-byte rows, not
// the bytes in flight, bounds the stream).
template <int NT>  // n8 tiles of batch rows: 1 (M <= 8) or 2 (M <= 16)
struct Layout {
  static constexpr int kStages = NT == 1 ? 5 : 4;
  static constexpr int kXBox = 8 * NT * 128;  // one x box: 8 NT rows x 64 bf16
  static constexpr int kXTile = 4 * kXBox;    // two boxes of each K-half
  static constexpr int kStage = kWTile + kXTile + kScaleTile;
  static constexpr int kRed = kStages * kStage;               // offset of the partial tile
  static constexpr int kBars = kRed + 8 * NT * (kBN + 4) * 4;  // offset of the barriers
  // ring, partial tile, barriers, alignment slack
  static constexpr size_t kSmem = (size_t)kBars + 2 * kStages * 8 + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The A fragment of K-half H for the k16 step whose two 8-row matrices a
// thread holds in words w0 (k 0-7) and w1 (k 8-15): a0 = n 2g at k 2t, 2t + 1
// (bytes 0 and 2 of w0), a1 = n 2g + 1 (bytes 1 and 3), a2 and a3 the same
// from w1 (k + 8). The low K-half reads the low nibbles, the high one the
// high. For int4_matmul_smallm, s holds the scales of columns 2g and 2g + 1.
template <bool DEQUANT, int H>
__device__ __forceinline__ void a_fragment(uint32_t w0, uint32_t w1, float2 s, uint32_t (&a)[4]) {
  constexpr int kShift = 4 * H;
  if constexpr (!kConvert) {
    a[0] = w0 >> kShift;
    a[1] = w0 >> (8 + kShift);
    a[2] = w1 >> kShift;
    a[3] = w1 >> (8 + kShift);
  } else {
    a[0] = nibbles_to_bf16x2(w0 >> kShift);
    a[1] = nibbles_to_bf16x2(w0 >> (8 + kShift));
    a[2] = nibbles_to_bf16x2(w1 >> kShift);
    a[3] = nibbles_to_bf16x2(w1 >> (8 + kShift));
    if constexpr (DEQUANT) {
      a[0] = scale_bf16x2(a[0], s.x);
      a[1] = scale_bf16x2(a[1], s.y);
      a[2] = scale_bf16x2(a[2], s.x);
      a[3] = scale_bf16x2(a[3], s.y);
    }
  }
}

// The epilogue of every mode. d[nt][e] is batch row 8 nt + 2 t + e % 2,
// column n_a + e / 2, the f32 sum over this block's K share; times
// scales[n] where given (int8's per-channel scales), rounded once. A cluster
// of one stores from registers; otherwise the cluster's partial tiles meet:
// block r sums its r-th share of the tile's M x BN / 4 column quads over the
// blocks in rank order, every remote load issued before the first sum,
// between two rounds of the cluster barrier (the consumers' alone: the
// producer warp has left). The stores wait until after the second round, so
// no release waits for them. BN: the block's columns, 16 a consumer warp.
template <int NT, int BN = kBN>
__device__ __forceinline__ void finish(const float (&d)[NT][4], float* red,
                                       const float* __restrict__ scales,
                                       __nv_bfloat16* __restrict__ y, int M, int N, int n0,
                                       int n_a, int csize, int rank) {
  constexpr int kPitch = BN + 4;  // f32 a row of the partial tile
  constexpr int kStride = 2 * BN;  // the consumer threads: 32 a 16 columns
  const int t = threadIdx.x % 4;
  if (csize == 1) {  // the whole K: round and store
    const int n = n0 + n_a;
    if (n >= N) return;
    float2 s = make_float2(1.f, 1.f);
    if (scales != nullptr) s = __ldg(reinterpret_cast<const float2*>(scales + n));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int m = 8 * nt + 2 * t;
      if (m < M)
        *reinterpret_cast<uint32_t*>(y + (size_t)m * N + n) =
            pack_bf16x2(d[nt][0] * s.x, d[nt][2] * s.y);
      if (m + 1 < M)
        *reinterpret_cast<uint32_t*>(y + (size_t)(m + 1) * N + n) =
            pack_bf16x2(d[nt][1] * s.x, d[nt][3] * s.y);
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* row = red + (8 * nt + 2 * t) * kPitch + n_a;
    *reinterpret_cast<float2*>(row) = make_float2(d[nt][0], d[nt][2]);
    *reinterpret_cast<float2*>(row + kPitch) = make_float2(d[nt][1], d[nt][3]);
  }
  cluster_arrive_release();  // (1) every block's partial tile is written
  cluster_wait();
  constexpr int kQuads = BN / 4;
  const int lo = rank * M * kQuads / csize, hi = (rank + 1) * M * kQuads / csize;
  float4 sum[NT];  // a share is at most 8 NT x BN / 4 quads / 2 over 2 BN threads
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int q = lo + threadIdx.x + kStride * j;
    float4 part_of[kMaxCluster];
    const uint32_t addr = smem_u32(red + (q / kQuads) * kPitch + 4 * (q % kQuads));
#pragma unroll
    for (int src = 0; src < kMaxCluster; ++src)
      if (q < hi && src < csize) part_of[src] = ld_cluster_f32x4(map_to_rank(addr, src));
    sum[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int src = 0; src < kMaxCluster; ++src)
      if (q < hi && src < csize) {
        sum[j].x += part_of[src].x;
        sum[j].y += part_of[src].y;
        sum[j].z += part_of[src].z;
        sum[j].w += part_of[src].w;
      }
  }
  cluster_arrive_relaxed();  // (2) every block has read the tiles: no block leaves before
  cluster_wait();
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int q = lo + threadIdx.x + kStride * j;
    const int n = n0 + 4 * (q % kQuads);
    if (q < hi && n < N) {
      float4 s = make_float4(1.f, 1.f, 1.f, 1.f);
      if (scales != nullptr) s = __ldg(reinterpret_cast<const float4*>(scales + n));
      *reinterpret_cast<uint2*>(y + (size_t)(q / kQuads) * N + n) =
          make_uint2(pack_bf16x2(sum[j].x * s.x, sum[j].y * s.y),
                     pack_bf16x2(sum[j].z * s.z, sum[j].w * s.w));
    }
  }
}

// Grid: a cluster of C blocks (1-D) for each 128-column block of N; block r
// of cluster c takes column block c and the units [r U / C, (r + 1) U / C)
// of K's U = K / 256 units (packed rows [128 u, 128 u + 128): scale group u
// of the low half, U + u of the high half).
template <bool DEQUANT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
int4_swapab_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap s_map, __nv_bfloat16* __restrict__ y,
                   int M, int N, int K) {
  using L = Layout<NT>;
  constexpr int stages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(ring + L::kRed);  // [8 NT][kBN + 4]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kBars);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int csize = (int)cluster_size(), rank = (int)cluster_rank();
  const int n0 = (int)(blockIdx.x / csize) * kBN, units = K / (2 * kBKP);
  const int u0 = rank * units / csize, u1 = (rank + 1) * units / csize;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer: one thread issues the stages, then the warp leaves
    if (lane == 0) {
      RingPos pos;
      for (int u = u0; u < u1; ++u) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        mbar_expect_tx(&full[pos.stage], L::kStage);
        unsigned char* st = ring + pos.stage * L::kStage;
        tma_load_2d(st, &w_map, &full[pos.stage], n0, u * kBKP);
#pragma unroll
        for (int box = 0; box < 4; ++box)  // (half, 64-column box)
          tma_load_2d(st + kWTile + box * L::kXBox, &x_map, &full[pos.stage],
                      (box / 2) * (K / 2) + u * kBKP + (box % 2) * kXBoxK, 0);
        unsigned char* sc = st + kWTile + L::kXTile;
        tma_load_2d(sc, &s_map, &full[pos.stage], n0, u);
        tma_load_2d(sc + kBN * 4, &s_map, &full[pos.stage], n0, units + u);
        pos.advance(stages);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int n_a = 16 * warp + 2 * g;  // fragment rows g, g + 8: columns n_a, n_a + 1
  // this lane's ldmatrix row of the weight tile (k = 32 j + lane): the warp's
  // 16-byte chunk, swizzled
  const uint32_t a_off = lane * 128 + ((warp ^ (lane & 7)) << 4);
  // B fragments from an x box [8 NT rows][64 k]: NT = 2, matrices (rows 0-7,
  // k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 0-7), (rows 8-15, k 8-15) of a
  // k16 step; NT = 1, rows 0-7 at k 0-7, 8-15, 16-23, 24-31 (two steps)
  const int xrow = NT == 2 ? (lane % 8) + 8 * (lane / 16) : lane % 8;
  const int xchunk = NT == 2 ? (lane / 8) % 2 : lane / 8;
  RingPos pos;
  uint32_t sink = 0;  // kProducts off: the fragments, so that they are computed
  float acc[2][NT][4];  // by K-half: two independent chains of products
#pragma unroll
  for (int i = 0; i < 2 * NT * 4; ++i) (&acc[0][0][0])[i] = 0.f;
  for (int u = u0; u < u1; ++u) {
    mbar_wait(&full[pos.stage], pos.phase);
    if constexpr (!kConsume) {
      if (lane == 0) mbar_arrive(&empty[pos.stage]);
      pos.advance(stages);
      continue;
    }
    unsigned char* stp = ring + pos.stage * L::kStage;
    const uint32_t st = smem_u32(stp);
    const float* sc = reinterpret_cast<const float*>(stp + kWTile + L::kXTile);
    const float2 s_h[2] = {*reinterpret_cast<const float2*>(sc + n_a),
                           *reinterpret_cast<const float2*>(sc + kBN + n_a)};
    float part[2][NT][4];  // int4_matmul: each half's group sums before their scales
#pragma unroll
    for (int i = 0; i < 2 * NT * 4; ++i) (&part[0][0][0])[i] = 0.f;
    // The weight words and B fragments of each 32-row chunk j, loaded one
    // chunk ahead of its products (ldmatrix and mma are issued in program
    // order, so each product would otherwise wait on its own load).
    uint32_t r[2][4], b[2][2][NT][4];  // [slot][4]; [slot][half][k16 step (NT = 2)][4]
    auto load = [&](int j, int slot) {
      ldsm_x4_trans(r[slot], st + j * 32 * 128 + a_off);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t xt = st + kWTile + (2 * h + j / 2) * L::kXBox + xrow * 128;
#pragma unroll
        for (int s = 0; s < NT; ++s)  // NT = 1: one load covers both k16 steps
          ldsm_x4(b[slot][h][s], xt + (((4 * (j % 2) + 2 * s + xchunk) ^ (lane & 7)) << 4));
      }
    };
    load(0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int slot = j % 2;
      if (j + 1 < 4) load(j + 1, (j + 1) % 2);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t a[4];
          if (h == 0) a_fragment<DEQUANT, 0>(r[slot][2 * s], r[slot][2 * s + 1], s_h[0], a);
          else a_fragment<DEQUANT, 1>(r[slot][2 * s], r[slot][2 * s + 1], s_h[1], a);
          const uint32_t* bx = NT == 2 ? b[slot][h][s % NT] : b[slot][h][0] + 2 * s;
          if constexpr (kProducts) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(DEQUANT ? acc[h][nt] : part[h][nt], a, bx[2 * nt], bx[2 * nt + 1]);
          } else {
            sink ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ bx[0] ^ bx[1];
          }
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[pos.stage]);  // the stage is in registers
    pos.advance(stages);
    if constexpr (!DEQUANT) {  // each group's f32 sum times its scales
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[h][nt][0] += part[h][nt][0] * s_h[h].x;
          acc[h][nt][1] += part[h][nt][1] * s_h[h].x;
          acc[h][nt][2] += part[h][nt][2] * s_h[h].y;
          acc[h][nt][3] += part[h][nt][3] * s_h[h].y;
        }
    }
  }
  float d[NT][4];  // the two chains' sum
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = acc[0][nt][e] + acc[1][nt][e];
  if constexpr (!kProducts) sink_into(d[0][0], sink);
  finish<NT>(d, red, nullptr, y, M, N, n0, n_a, csize, rank);
}

// The int8 mode's stage: 16 KB of weights (kRows8 K rows of the block's 128
// columns, one box), then the stage's x columns in two 64-column boxes.
constexpr int kRows8 = kWTile / kBN;  // K rows an int8 stage
template <int NT>
struct Layout8 {
  static constexpr int kXBox = 8 * NT * 128;
  static constexpr int kXTile = (kRows8 / kXBoxK) * kXBox;
  static constexpr int kStages = 5;
  static constexpr int kStage = kWTile + kXTile;
  static constexpr int kRed = kStages * kStage;
  static constexpr int kBars = kRed + 8 * NT * (kBN + 4) * 4;
  static constexpr size_t kSmem = (size_t)kBars + 2 * kStages * 8 + 1024;
};

// The A fragments of the two k16 steps of a 32-row chunk from one
// ldmatrix.x4.trans of the int8 tile (r[q]: k rows 8q .. 8q + 7): pairs of
// bytes 0, 2 (n = 2g) and 1, 3 (n = 2g + 1) of each word.
__device__ __forceinline__ void s8_a_fragments(const uint32_t (&r)[4], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t w0 = r[2 * s], w1 = r[2 * s + 1];
    if constexpr (kConvert) {
      a[s][0] = s8_halves_to_bf16x2(w0);
      a[s][1] = s8_halves_to_bf16x2(w0 >> 8);
      a[s][2] = s8_halves_to_bf16x2(w1);
      a[s][3] = s8_halves_to_bf16x2(w1 >> 8);
    } else {
      a[s][0] = w0;
      a[s][1] = w0 >> 8;
      a[s][2] = w1;
      a[s][3] = w1 >> 8;
    }
  }
}

// Grid: a cluster of C blocks for each 128-column block of N; block r of
// cluster c takes column block c and the units [r U / C, (r + 1) U / C) of
// K's U = ceil(K / kRows8) stage units (rows past K arrive as zeros).
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
int8_swapab_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap x_map, const float* __restrict__ scales,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  using L = Layout8<NT>;
  constexpr int stages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* red = reinterpret_cast<float*>(ring + L::kRed);  // [8 NT][kBN + 4]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kBars);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int csize = (int)cluster_size(), rank = (int)cluster_rank();
  const int n0 = (int)(blockIdx.x / csize) * kBN, units = (K + kRows8 - 1) / kRows8;
  const int u0 = rank * units / csize, u1 = (rank + 1) * units / csize;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer: one thread issues the stages, then the warp leaves
    if (lane == 0) {
      RingPos pos;
      for (int u = u0; u < u1; ++u) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        mbar_expect_tx(&full[pos.stage], L::kStage);
        unsigned char* st = ring + pos.stage * L::kStage;
        tma_load_2d(st, &w_map, &full[pos.stage], n0, u * kRows8);
#pragma unroll
        for (int box = 0; box < kRows8 / kXBoxK; ++box)
          tma_load_2d(st + kWTile + box * L::kXBox, &x_map, &full[pos.stage],
                      u * kRows8 + box * kXBoxK, 0);
        pos.advance(stages);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int n_a = 16 * warp + 2 * g;  // fragment rows g, g + 8: columns n_a, n_a + 1
  // this lane's ldmatrix row of the weight tile, as in the int4 kernel
  const uint32_t a_off = lane * 128 + ((warp ^ (lane & 7)) << 4);
  // B fragments from an x box [8 NT rows][64 k], as in the int4 kernel
  const int xrow = NT == 2 ? (lane % 8) + 8 * (lane / 16) : lane % 8;
  const int xchunk = NT == 2 ? (lane / 8) % 2 : lane / 8;
  RingPos pos;
  uint32_t sink = 0;  // kProducts off: the fragments, so that they are computed
  float acc[2][NT][4];  // by k16 step parity: two independent chains of products
#pragma unroll
  for (int i = 0; i < 2 * NT * 4; ++i) (&acc[0][0][0])[i] = 0.f;
  for (int u = u0; u < u1; ++u) {
    mbar_wait(&full[pos.stage], pos.phase);
    if constexpr (!kConsume) {
      if (lane == 0) mbar_arrive(&empty[pos.stage]);
      pos.advance(stages);
      continue;
    }
    const uint32_t st = smem_u32(ring + pos.stage * L::kStage);
#pragma unroll
    for (int j = 0; j < kRows8 / 32; ++j) {  // 32-row chunks: two k16 steps
      uint32_t r[4], a[2][4];
      ldsm_x4_trans(r, st + j * 32 * 128 + a_off);
      s8_a_fragments(r, a);
      uint32_t b[NT][4];
      const uint32_t xt = st + kWTile + (j / 2) * L::kXBox + xrow * 128;
#pragma unroll
      for (int s = 0; s < NT; ++s)  // NT = 1: one load covers both k16 steps
        ldsm_x4(b[s], xt + (((4 * (j % 2) + 2 * s + xchunk) ^ (lane & 7)) << 4));
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t* bx = NT == 2 ? b[s % NT] : b[0] + 2 * s;
        if constexpr (kProducts) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[s][nt], a[s], bx[2 * nt], bx[2 * nt + 1]);
        } else {
          sink ^= a[s][0] ^ a[s][1] ^ a[s][2] ^ a[s][3] ^ bx[0] ^ bx[1];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[pos.stage]);  // the stage is consumed
    pos.advance(stages);
  }
  float d[NT][4];  // the two chains' sum
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[nt][e] = acc[0][nt][e] + acc[1][nt][e];
  if constexpr (!kProducts) sink_into(d[0][0], sink);
  finish<NT>(d, red, scales, y, M, N, n0, n_a, csize, rank);
}

// ---------------------------------------------------------------------------
// The w8a8 mode: int8_matmul_w8a8 at decode M, one launch a product.
//
// Bound: the weight bytes, as the int8 mode (233 MB a split Qwen2.5-7B layer:
// 0.070 ms at 3.35 TB/s); x is at most 16 x 18944 bf16 and sits in the L2.
// The previous design (int8_matmul_w8a8.cu's wgmma block with a 16-row tile)
// took three launches a product (quantize x, the product, the reduce of its
// K split through device memory), ran one block an SM (gate/up_proj's 148
// column tiles in two waves, k/v_proj's 28 blocks on 132 SMs) and kept at
// most 64 KB of weights in flight an SM. This mode is the int8 mode's stream
// with the activations quantized inside the block. Times below: NVIDIA H100
// 80GB HBM3 at 700 W, a split 7B layer (scripts/torch_int8_probe.py).
//   - The weights as the int8 mode streams them: TMA, a ring of 64 KB, two
//     blocks an SM (five stages of 16 KB were slower at M = 8 and 16), in
//     blocks of 128 columns, or 64 (a 64-byte swizzled box, four consumer
//     warps) for products too narrow to fill the card over the largest
//     cluster (k/v_proj: 4 column blocks x 7 qblocks).
//   - K split over a cluster of up to 8 blocks in whole qblocks, the f32
//     partials met in rank order (`finish`): one launch, no atomics.
//   - x by TMA too, a qblock (8 NT rows, rows past M zeros) at a time into
//     one staging buffer, issued by the producer after each qblock's weight
//     stages once the previous qblock has been quantized. Read from the L2 by
//     the warps that quantize, the rows waited behind the weight stream (M =
//     16: 0.20 ms, 0.13 without those loads).
//   - The consumer warps quantize the next qblock from the staging buffer, a
//     row a warp after each of the current qblock's stages but its last, into
//     the other of two xq buffers (one named barrier a qblock): a row's 512
//     columns in one warp (lane l: columns 16 l .. 16 l + 15), its absmax by
//     shuffles, sx by IEEE division, xq as IEEE division and rint give it
//     (`quantize_value`), stored straight in the order the B fragments want.
//     Every column block quantizes x again (M x K values a block). A
//     warpgroup of quantizer warps beside the consumers was slower (0.17 ms
//     at M = 16): at 416 threads a block ptxas caps a thread at 72 registers,
//     and the M = 16 kernel spilled.
//   - The products on mma.sync m16n8k32 s8 with s32 accumulators, exact: the
//     A fragment from one transposed ldmatrix and four byte permutes
//     (hopper.cuh s8_a_from_trans), the B fragment (xq of one batch row at k
//     positions sigma16) one 8-byte shared load. Each qblock's sums, in two
//     chains by step parity, are added as integers, converted and scaled by
//     the row's sx at its end.
// Plan (block width, cluster, grid, ring, shared memory):
// ops/quant.py::w8a8_swapab_plan, held on the CPU with emulations of a
// block's qblock and of the quantizer's rounding by
// tests/test_torch_launch_plans.py.

constexpr bool kQuantize = true;  // diagnostics: the consumer warps quantize x
constexpr int kQSteps = 16;       // k32 steps of a 512-column qblock
constexpr int kXsCols = 256;      // x columns a TMA box of the staged qblock

template <int NT, int BN>  // n8 tiles of batch rows; the block's columns (128 or 64)
struct LayoutW8A8 {
  static constexpr int kConsumers = BN / 16;
  static constexpr int kThreads = 32 * (kConsumers + 1);
  static constexpr int kStages = 4 * 128 / BN;            // 64 KB of weights a block
  static constexpr int kStage = kRows8 * BN;              // kRows8 K rows of the block's columns
  static constexpr int kXsBox = 8 * NT * kXsCols * 2;     // a staged x box: 8 NT rows x 256 bf16
  static constexpr int kXsOff = kStages * kStage;         // [2 boxes]: one qblock of x
  static constexpr int kXq = kQSteps * NT * 256;          // a qblock of xq in fragment order
  static constexpr int kXqOff = kXsOff + 2 * kXsBox;      // [2][kXq]
  static constexpr int kSxOff = kXqOff + 2 * kXq;         // [2][8 NT] f32
  static constexpr int kRed = kSxOff + 2 * 8 * NT * 4;    // the partial tile
  static constexpr int kBars = kRed + 8 * NT * (BN + 4) * 4;  // the ring's, then the staged x's
  static constexpr size_t kSmem = (size_t)kBars + 2 * (kStages + 1) * 8 + 1024;
};

// c (16 x 8, s32) += a (16 x 32, s8, row-major) . b (32 x 8, s8, column-major)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 32-bit word of xq a B fragment holds, and where it sits. For k32 step
// s of a qblock and n8 tile nt, the 64 words of (s, nt) hold, in slot
// (4 g + t) ^ s, thread (g, t)'s pair: b0 (h = 0), batch row 8 nt + g at k
// positions 4t .. 4t + 3, and b1 (h = 1) the same 16 k later; position p
// holds column 32 s + 16 h + sigma16(p % 16). The XOR spreads the
// quantizing warp's stores (lane 2 s + h of a row) over every bank; a warp's
// 8-byte loads of one (s, nt) stay 256 contiguous bytes.
template <int NT>
__device__ __forceinline__ int xq_word(int s, int nt, int g, int t, int h) {
  return ((s * NT + nt) * 32 + ((4 * g + t) ^ s)) * 2 + h;
}

// The integer rint(v / s) of xq, exactly as IEEE division and round half to
// even give it, from r = 1 / s (IEEE) without a division: p = v r lies
// within |v / s| 1.5 2^-23 <= 2.3e-5 of fl(v / s) (|v / s| <= 127), so
// both round to the same integer unless p is within 3e-5 of a half (`near`;
// then the caller divides). p + 1.5 2^23 rounds p to an integer (half to
// even) in its low mantissa bits (the _rn intrinsics keep the compiler from
// fusing the product into that sum). No branch: a lane's 16 values keep
// their chains side by side.
__device__ __forceinline__ int quantize_value(float v, float r, bool& near) {
  constexpr float kMagic = 12582912.f;  // 1.5 2^23
  const float p = __fmul_rn(v, r);
  const float t = __fadd_rn(p, kMagic);
  near = fabsf(__fsub_rn(p, __fsub_rn(t, kMagic))) > 0.49997f;
  return __float_as_int(t) - __float_as_int(kMagic);
}

// Quantizes batch row `row` of the staged qblock into xq and sx, one warp:
// lane l takes columns 16 l .. 16 l + 15 (in box 16 l / cols of `cols` =
// min(qblock, 256) columns a row; TMA wrote rows past M as zeros, whose sx
// is 0; a lane past qblock < 512 stores nothing). The absmax of a lane's 16
// bf16 is an integer max of their bits without the sign (non-negative
// floats order as their bits).
template <int NT>
__device__ __forceinline__ void quantize_row(const unsigned char* xs, int cols, uint32_t* xq,
                                             float* sx, int M, int qblock, int row, int lane) {
  const bool live = 16 * lane < qblock;
  uint4 raw[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
  if (live) {
    const int c = 16 * lane;
    const uint4* p = reinterpret_cast<const uint4*>(xs + (c / cols) * (8 * NT * cols * 2) +
                                                    (row * cols + c % cols) * 2);
    raw[0] = p[0];
    raw[1] = p[1];
  }
  const uint32_t* w = reinterpret_cast<const uint32_t*>(raw);
  uint32_t m = 0u;
#pragma unroll
  for (int e = 0; e < 8; ++e) m = __vmaxu2(m, w[e] & 0x7FFF7FFFu);
  float amax = __uint_as_float(max(m & 0xFFFFu, m >> 16) << 16);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax, 1e-8f) / 127.f;
  const float r = 1.f / s;
  if (live) {
    float v[16];
    unpack8(raw[0], v);
    unpack8(raw[1], v + 8);
    int q[16];
    uint32_t near = 0u;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      bool n;
      q[e] = quantize_value(v[e], r, n);
      near |= (uint32_t)n << e;
    }
    if (near != 0u) {  // a quotient within 3e-5 of a half: the IEEE division decides
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if ((near >> e) & 1u) q[e] = __float2int_rn(v[e] / s);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // clipped to +-127 (|v / s| <= 127 already)
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (uint32_t)(max(-127, min(127, q[sigma16(4 * t + j)])) & 0xFF) << (8 * j);
      xq[xq_word<NT>(lane / 2, row / 8, row % 8, t, lane % 2)] = word;
    }
  }
  if (lane == 0) sx[row] = row < M ? s : 0.f;
}

// Grid: a cluster of C blocks for each BN-column block of N; block r of
// cluster c takes column block c and the qblocks [r U / C, (r + 1) U / C) of
// K's U = K / qblock, each in ceil(qblock / kRows8) stages (rows past K
// arrive as zeros).
template <int NT, int BN>
__global__ void __launch_bounds__(LayoutW8A8<NT, BN>::kThreads, 2)
w8a8_swapab_kernel(const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap x_map, const float* __restrict__ scales,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K, int qblock) {
  using L = LayoutW8A8<NT, BN>;
  constexpr int stages = L::kStages, consumers = L::kConsumers;
  constexpr int rows = 8 * NT / consumers;  // batch rows a consumer warp quantizes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* xs = ring + L::kXsOff;  // the staged qblock of x
  uint32_t* xq = reinterpret_cast<uint32_t*>(ring + L::kXqOff);
  float* sx = reinterpret_cast<float*>(ring + L::kSxOff);
  float* red = reinterpret_cast<float*>(ring + L::kRed);  // [8 NT][BN + 4]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kBars);
  uint64_t* empty = full + stages;
  uint64_t* xsfull = empty + stages;  // the staged qblock of x has landed
  uint64_t* xsempty = xsfull + 1;     // the consumers have quantized it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int csize = (int)cluster_size(), rank = (int)cluster_rank();
  const int n0 = (int)(blockIdx.x / csize) * BN, units = K / qblock;
  const int b0 = rank * units / csize, b1 = (rank + 1) * units / csize;
  const int per_unit = (qblock + kRows8 - 1) / kRows8;  // stages a qblock
  const int x_cols = qblock < kXsCols ? qblock : kXsCols;  // a staged box's columns
  const int x_boxes = (qblock + x_cols - 1) / x_cols;      // and boxes a qblock
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    mbar_init(xsfull, 1);
    mbar_init(xsempty, 32 * consumers);  // every consumer thread after its reads
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == consumers) {  // producer: one thread issues the loads, then the warp leaves
    if (lane == 0) {
      RingPos pos, xpos;
      auto load_x = [&](int b) {  // once the consumers have quantized the previous qblock
        mbar_wait(xsempty, xpos.phase ^ 1u);
        mbar_expect_tx(xsfull, x_boxes * 8 * NT * x_cols * 2);
        for (int h = 0; h < x_boxes; ++h)
          tma_load_2d(xs + h * 8 * NT * x_cols * 2, &x_map, xsfull, b * qblock + h * x_cols, 0);
        xpos.advance(1);
      };
      load_x(b0);
      for (int b = b0; b < b1; ++b) {
        for (int s = 0; s < per_unit; ++s) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
          mbar_expect_tx(&full[pos.stage], L::kStage);
          tma_load_2d(ring + pos.stage * L::kStage, &w_map, &full[pos.stage], n0,
                      b * qblock + s * kRows8);
          pos.advance(stages);
        }
        if (b + 1 < b1) load_x(b + 1);  // quantized during b's stages
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int n_a = 16 * warp + 2 * g;  // fragment rows g, g + 8: columns n_a, n_a + 1
  // this lane's ldmatrix row of the weight tile (k = 32 j + lane): the warp's
  // 16-byte chunk, swizzled (128-byte rows: chunk ^ (k % 8); 64-byte rows:
  // chunk ^ (k / 2 % 4))
  const uint32_t a_off = BN == 128 ? lane * 128 + ((warp ^ (lane & 7)) << 4)
                                   : lane * 64 + ((warp ^ ((lane >> 1) & 3)) << 4);
  RingPos pos, xspos;
  // row warp + consumers i of the staged qblock b into xq buffer (b - b0) % 2
  auto quantize = [&](int b, int i) {
    const int buf = (b - b0) & 1;
    if constexpr (kQuantize && kConsume)
      quantize_row<NT>(xs, x_cols, xq + buf * (L::kXq / 4), sx + buf * 8 * NT, M, qblock,
                       warp + consumers * i, lane);
  };
  mbar_wait(xsfull, xspos.phase);  // the first qblock, under its first weight loads
  for (int i = 0; i < rows; ++i) quantize(b0, i);
  mbar_arrive(xsempty);
  xspos.advance(1);
  uint32_t sink = 0;  // kProducts off: the fragments, so that they are computed
  float acc[NT][4];   // the f32 sum of the qblocks' scaled terms
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) (&acc[0][0])[i] = 0.f;
  for (int b = b0; b < b1; ++b) {
    // qblock b's xq and sx are written; every warp has left qblock b - 1, so
    // its buffer is free for b + 1
    named_barrier(1, 32 * consumers);
    const int buf = (b - b0) & 1;
    const uint32_t* xqb = xq + buf * (L::kXq / 4);
    const float* sxb = sx + buf * 8 * NT;
    int acc_i[2][NT][4];  // the qblock's exact sums, by step parity: two chains
#pragma unroll
    for (int i = 0; i < 2 * NT * 4; ++i) (&acc_i[0][0][0])[i] = 0;
    for (int s = 0; s < per_unit; ++s) {
      mbar_wait(&full[pos.stage], pos.phase);
      if constexpr (kConsume) {
        const uint32_t st = smem_u32(ring + pos.stage * L::kStage);
#pragma unroll
        for (int j = 0; j < kRows8 / 32; ++j) {  // k32 steps
          uint32_t r[4], a[4];
          ldsm_x4_trans(r, st + j * 32 * BN + a_off);
          s8_a_from_trans(r, a);
          const int step = (kRows8 / 32) * s + j;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 bx = *reinterpret_cast<const uint2*>(xqb + xq_word<NT>(step, nt, g, t, 0));
            if constexpr (kProducts) mma_s8(acc_i[j % 2][nt], a, bx.x, bx.y);
            else sink ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ bx.x ^ bx.y;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[pos.stage]);  // the stage is consumed
      pos.advance(stages);
      // the next qblock's rows, a row after each stage but the last (its x
      // was staged when this qblock's last weight stage was issued; after
      // the last stage the rows held the next qblock's barrier)
      const int i = s - (per_unit - 1 - rows > 0 ? per_unit - 1 - rows : 0);
      if (b + 1 < b1 && i >= 0 && i < rows) {
        if (i == 0) mbar_wait(xsfull, xspos.phase);
        quantize(b + 1, i);
        if (i == rows - 1) {
          mbar_arrive(xsempty);
          xspos.advance(1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {  // d[nt][e]: batch row 8 nt + 2 t + e % 2
      const float s0 = sxb[8 * nt + 2 * t], s1 = sxb[8 * nt + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] += (float)(acc_i[0][nt][e] + acc_i[1][nt][e]) * (e % 2 ? s1 : s0);
    }
  }
  if constexpr (!kProducts) sink_into(acc[0][0], sink);
  finish<NT, BN>(acc, red, scales, y, M, N, n0, n_a, csize, rank);
}

enum Mode : int { kInt4 = 0, kInt4Dequant = 1, kInt8 = 2, kW8A8 = 3 };

template <int MODE, int NT, int BN = kBN>
struct Kernel {
  static constexpr int kBlockThreads = MODE == kW8A8 ? LayoutW8A8<NT, BN>::kThreads : kThreads;
  static constexpr size_t kSmem = MODE == kW8A8   ? LayoutW8A8<NT, BN>::kSmem
                                  : MODE == kInt8 ? Layout8<NT>::kSmem
                                                  : Layout<NT>::kSmem;
  static constexpr auto fn() {
    if constexpr (MODE == kW8A8) return w8a8_swapab_kernel<NT, BN>;
    else if constexpr (MODE == kInt8) return int8_swapab_kernel<NT>;
    else return int4_swapab_kernel<MODE == kInt4Dequant, NT>;
  }
};

static void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int blocks,
                           int cluster, int threads, size_t smem) {
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <int MODE, int NT, int BN = kBN, class... Args>
cudaError_t launch(int n, int cluster, cudaStream_t st, Args... args) {
  using K = Kernel<MODE, NT, BN>;
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(K::fn(), K::kSmem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, cluster * ((n + BN - 1) / BN), cluster, K::kBlockThreads, K::kSmem);
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, K::fn(), args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE, int NT, int BN = kBN>
int active_clusters(int cluster) {
  using K = Kernel<MODE, NT, BN>;
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(K::fn(), K::kSmem, &granted);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, cluster * 64, cluster, K::kBlockThreads, K::kSmem);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, K::fn(), &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

}  // namespace sab
}  // namespace agk

// C entry. Device pointers to contiguous tensors: x [m, k] bf16; w int8
// [k / 2, n] (packed int4, modes 0 and 1) or [k, n] (int8, mode 2); scales
// f32 [k / 128, n] or [1, n]; y [m, n] bf16. mode: 0 the function of
// int4_matmul, 1 that of int4_matmul_smallm, 2 that of int8_matmul. The
// cluster size comes from the wrapper's plan (ops/quant.py::int4_plan,
// int8_plan), which checks shapes, dtypes and alignment. Returns the first
// CUDA error, or 0.
extern "C" int agk_quant_swapab(const void* x, const void* w, const void* scales, void* y, int m,
                                int n, int k, int cluster, int mode, void* stream) {
  using namespace agk;
  using namespace agk::sab;
  const bool int8 = mode == kInt8;
  const int unit = int8 ? kRows8 : 256;
  if (mode < kInt4 || mode > kInt8 || m < 1 || m > 16 || n < 16 || n % 16 || k < 1 ||
      k % (int8 ? 64 : 256) || cluster < 1 || cluster > kMaxCluster ||
      cluster > (k + unit - 1) / unit)
    return (int)cudaErrorInvalidValue;
  const int nt = m <= 8 ? 1 : 2;
  using hopper::tensor_map_2d;
  CUtensorMap w_map, x_map, s_map;
  if (tensor_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, n, int8 ? k : k / 2, n, 128,
                    int8 ? kRows8 : kBKP) ||
      tensor_map_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2ull * k, kXBoxK, 8 * nt))
    return (int)cudaErrorInvalidValue;
  auto* yp = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8) {
    const auto* sp = static_cast<const float*>(scales);
    return (int)(nt == 1 ? launch<kInt8, 1>(n, cluster, st, w_map, x_map, sp, yp, m, n, k)
                         : launch<kInt8, 2>(n, cluster, st, w_map, x_map, sp, yp, m, n, k));
  }
  if (tensor_map_2d(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, n, k / 128, 4ull * n, kBN, 1,
                    CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  if (mode == kInt4Dequant)
    return (int)(nt == 1
                     ? launch<kInt4Dequant, 1>(n, cluster, st, w_map, x_map, s_map, yp, m, n, k)
                     : launch<kInt4Dequant, 2>(n, cluster, st, w_map, x_map, s_map, yp, m, n, k));
  return (int)(nt == 1 ? launch<kInt4, 1>(n, cluster, st, w_map, x_map, s_map, yp, m, n, k)
                       : launch<kInt4, 2>(n, cluster, st, w_map, x_map, s_map, yp, m, n, k));
}

// How many clusters of `cluster` blocks the card holds at once, for the
// kernel that M rows (1-16) and `mode` select; a negative CUDA error on
// failure. The wrappers' plans read it.
extern "C" int agk_quant_swapab_active_clusters(int cluster, int m, int mode) {
  using namespace agk::sab;
  if (cluster < 1 || cluster > kMaxCluster || m < 1 || m > 16 || mode < kInt4 || mode > kInt8)
    return -(int)cudaErrorInvalidValue;
  const bool one = m <= 8;
  if (mode == kInt8)
    return one ? active_clusters<kInt8, 1>(cluster) : active_clusters<kInt8, 2>(cluster);
  if (mode == kInt4Dequant)
    return one ? active_clusters<kInt4Dequant, 1>(cluster)
               : active_clusters<kInt4Dequant, 2>(cluster);
  return one ? active_clusters<kInt4, 1>(cluster) : active_clusters<kInt4, 2>(cluster);
}

// The w8a8 mode (int8_matmul_w8a8 at M <= 16). Device pointers to contiguous
// tensors: x [m, k] bf16, w int8 [k, n], scales f32 [1, n], y [m, n] bf16;
// qblock = min(512, k). block_n (128 or 64) and the cluster size (at most k
// / qblock) come from the wrapper's plan (ops/quant.py::w8a8_swapab_plan),
// which checks shapes, dtypes and alignment. Returns the first CUDA error,
// or 0.
extern "C" int agk_w8a8_swapab(const void* x, const void* w, const void* scales, void* y, int m,
                               int n, int k, int block_n, int cluster, void* stream) {
  using namespace agk;
  using namespace agk::sab;
  const int qblock = k < 512 ? k : 512;
  if (m < 1 || m > 16 || n < 16 || n % 16 || k < 64 || k % 64 || k % qblock ||
      (block_n != 128 && block_n != 64) || cluster < 1 || cluster > kMaxCluster ||
      cluster > k / qblock)
    return (int)cudaErrorInvalidValue;
  const bool one = m <= 8;
  CUtensorMap w_map, x_map;
  if (hopper::tensor_map_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, n, k, n, block_n, kRows8,
                            block_n == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                           : CU_TENSOR_MAP_SWIZZLE_64B) ||
      hopper::tensor_map_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2ull * k,
                            k < kXsCols ? k : kXsCols, one ? 8 : 16, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const auto* sp = static_cast<const float*>(scales);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_n == 128)
    return (int)(one ? launch<kW8A8, 1, 128>(n, cluster, st, w_map, x_map, sp, yp, m, n, k, qblock)
                     : launch<kW8A8, 2, 128>(n, cluster, st, w_map, x_map, sp, yp, m, n, k, qblock));
  return (int)(one ? launch<kW8A8, 1, 64>(n, cluster, st, w_map, x_map, sp, yp, m, n, k, qblock)
                   : launch<kW8A8, 2, 64>(n, cluster, st, w_map, x_map, sp, yp, m, n, k, qblock));
}

// How many clusters of `cluster` blocks of the w8a8 mode the card holds at
// once, for M rows (1-16) and block_n columns a block; a negative CUDA error
// on failure. The wrapper's plan reads it.
extern "C" int agk_w8a8_swapab_active_clusters(int cluster, int m, int block_n) {
  using namespace agk::sab;
  if (cluster < 1 || cluster > kMaxCluster || m < 1 || m > 16 ||
      (block_n != 128 && block_n != 64))
    return -(int)cudaErrorInvalidValue;
  const bool one = m <= 8;
  if (block_n == 128)
    return one ? active_clusters<kW8A8, 1, 128>(cluster) : active_clusters<kW8A8, 2, 128>(cluster);
  return one ? active_clusters<kW8A8, 1, 64>(cluster) : active_clusters<kW8A8, 2, 64>(cluster);
}
