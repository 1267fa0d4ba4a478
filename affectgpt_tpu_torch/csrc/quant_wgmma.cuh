// The weight-only quantized matmuls above decode M (16 < M <= 1024) on
// Hopper (sm_90a), one design for int8 and int4 weights: y [M, N] = x [M, K]
// (bf16) against an integer weight in the JAX [K, N] layout (N contiguous, no
// repacked copy). Three modes, with the TPU kernels' rounding points:
//   kW8 (int8_matmul, replaces the Pallas kernel affectgpt_tpu/ops/quant.py::
//     int8_matmul): w_q int8 [K, N], f32 per-channel scales [1, N]; bf16(x)
//     times the int8 values (exact in bf16) summed in f32, times scales[n]
//     once in the epilogue.
//   kW4 (int4_matmul, replaces quant.py::int4_matmul): w_p int8 [K/2, N]
//     packed (low nibble = row k, high nibble = row k + K/2), f32 scales
//     [K/128, N]; each 128-row group's f32 sum of bf16(x) times the raw int4
//     values, times scales[g, n], added to the f32 accumulator.
//   kW4Dequant (int4_matmul_smallm's function above M = 16, reached by a
//     direct call only): each weight is bf16(f32(value) * scales[g, n])
//     before the product.
//   kW8A8 (int8_matmul_w8a8, replaces quant.py::int8_matmul_w8a8): x
//     quantized per (row, qblock of min(512, K) columns) by the launch
//     before (int8_matmul_w8a8.cu quantize_rows_kernel: xq int8 with each
//     16-column group sigma16-permuted, sx f32 [K / qblock, M]); each
//     qblock's int8 x int8 products summed exactly in s32, times the row's
//     sx into the f32 accumulator; the sum times scales[n] in the epilogue.
// Each output is rounded to bf16 once. At M <= 16 the wrappers launch
// quant_swapab.cu instead.
//
// Bound: the products at M in the hundreds (a Qwen2.5-7B layer at M = 256:
// 119 GFLOP, 0.121 ms at 989 TFLOP/s), the weight bytes at M = 40 (116.5 MB
// packed int4, 233 MB int8). The previous design (a 128 x 64 tile on
// mma.sync, four warps) loaded each unit's weight bytes into registers,
// converted them to bf16 and stored them in shared memory between two
// __syncthreads, one unit ahead: no TMA, no ring, no wgmma, at 8-11% of the
// bound. This one:
//   - swap-AB on wgmma: D^T = W^T x^T. A block owns 128 weight columns, one
//     128-byte TMA box row, 64 for each of two consumer warpgroups (the
//     wgmma M = 64); the block's NB batch rows of x (NB one of 32, 40, 48,
//     64, 96, 128: M rounded up; rows past M zero-filled by TMA) are the
//     K-major B operand, read from the 128-byte swizzled box TMA writes. A
//     product of M <= 128 rows reads each weight byte once; above, the
//     batch is split into cb = ceil(M / 128) blocks of NB rows, which read
//     the weights again (from the L2: the blocks of a column tile are
//     neighbours in the grid).
//   - A from registers (wgmma RS): in each warp's 16 rows the RS A fragment
//     of m64nNk16 has the layout of mma.sync m16n8k16's A fragment, which
//     quant_swapab.cu builds from int8 bytes and int4 nibbles: one 16-bit
//     transposed ldmatrix of the N-contiguous weight tile gives each thread
//     the bytes of columns 2g and 2g + 1 at k 2t, 2t + 1 (fragment row g is
//     column 2g, row g + 8 column 2g + 1), converted in registers to exact
//     bf16 pairs (int8: mma_bf16.cuh s8_halves_to_bf16x2; int4:
//     nibbles_to_bf16x2, and scale_bf16x2 in kW4Dequant).
//   - weights as raw bytes through a TMA ring: a stage is 64 stored weight
//     rows (8 KB), the x columns they meet (int8: one 64-column box; int4:
//     one of each K-half, k = 64 s and K/2 + 64 s) and, in an int4 pair's
//     first stage, the pair's two scale rows. The consumers take stages in
//     pairs (128 rows: one scale group of each K-half) and hand them back
//     once the pair's products are done; one producer thread keeps the ring
//     full. The A fragments live in two register buffers, so that one group
//     of products runs while the next group's fragments are converted.
//   - kW4's groups: each half's group sum is a second f32 tile (started by
//     scale-d 0), scaled into the accumulator once its group has completed
//     (acc + part is NB registers a thread, so NB <= 128); the two consumer
//     warpgroups interleave, so one's wait and scaling overlap the other's
//     products.
//   - K split over a cluster of ck blocks where the tiles are fewer than the
//     SMs (k/v_proj: 4 column tiles): each block takes a contiguous share of
//     K's pairs, and the f32 partial tiles meet in distributed shared
//     memory, summed in rank order (no atomics: two calls give the same
//     bits). Splitting K costs a block its share of the reduction: wide
//     products (gate/up_proj, the lm_head) run whole-K, also where their
//     last wave is partly empty (a second launch splitting only that
//     wave's K was tried and moved nothing at M = 256).
// On the H100 the loads bind it from M = 256 on: the ring alone (the
// consumers handing each pair back unread) takes 54-85% of the kernel's time
// per 7B layer at M = 256 and 1000, x's bytes (read again for each
// 128-column tile) the larger part of them (scripts/torch_int8_probe.py
// wgmma). Sharing the x boxes across the column tiles of a cluster by TMA
// multicast was tried and made every product slower: the blocks of a
// cluster wait on each other's consumers to refill a stage.
// kW8A8 keeps the design and changes the operands: the weight's s8 A
// fragment of a k32 step is one transposed ldmatrix and four byte permutes
// (hopper.cuh s8_a_from_trans: no conversion), xq is the K-major s8 B
// operand (wgmma m64nNBk32 s32.s8.s8; N one of 16, 24, 32, 48, 64, 96, 128,
// the widths s8 wgmma takes), one 128-byte box of NB rows a pair. Its ring
// stage is a whole pair (two weight boxes and the xq box): a stage of 64
// rows would leave the room of the bf16 modes' second x box empty, and
// whole pairs hold 6 of them at NB = 128 against 4. A qblock's NB row
// scales sx ride in a slot of their own beside the stage of the qblock's
// last pair. A qblock (4 pairs) sums into an s32 tile started by scale-d
// 0; at its last pair the warpgroup waits for its products and adds s32 *
// sx into the f32 accumulator. The two consumer warpgroups run in lockstep:
// taking the tensor cores in turn, a pair each, so that one's wait and
// scaling would overlap the other's products (kPingPong), made a split 7B
// layer 2-3.5% slower at M = 40, 256 and 1000 (the turns' barriers cost more
// than the drains they hide). K splits over the cluster in whole qblocks.
// The launch is the programmatic dependent of the quantize launch: its
// producer issues the first lap's weight boxes, then waits for xq and sx
// (griddepcontrol.wait) before their boxes. At NB <= 48 two blocks fit an
// SM (consumers at 104 registers, the producer at 24, a ring within half
// the SM's shared memory), so gate/up_proj's 148 blocks at the speculative
// verify's M = 40 run in one wave. Sharing each weight box between two
// batch blocks of a cluster by TMA multicast was tried and made a split 7B
// layer slower at M = 256 and 1000, so every block loads its own.
// Launch plans (NB, batch blocks, K split, stages, shared memory, grid):
// ops/quant.py::wgmma_plan, held on the CPU by tests/test_torch_quant_wgmma.py.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "gemv_tile.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace qwg {

using namespace hopper;

enum Mode : int { kW8 = 0, kW4 = 1, kW4Dequant = 2, kW8A8 = 3 };

constexpr int kConsumers = 2;                     // warpgroups of 64 weight columns
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup
constexpr int kBN = 64 * kConsumers;              // columns a block: one 128-byte box row
constexpr int kRows = 64;                         // stored weight rows a stage
constexpr int kWBox = kRows * kBN;                // 8 KB of weight bytes a stage
constexpr int kScaleTile = 2 * kBN * 4;           // int4: a pair's two scale rows
constexpr int kPitch = kBN + 4;                   // f32 a row of the partial tile
constexpr int kMaxCluster = 8;
constexpr int kMaxStages = 16;

// Diagnostics, all true in the package; scripts/torch_int8_probe.py wgmma
// switches them off in a copy to split the kernel's time (the results of such
// a build are wrong). Whatever a switched-off part would have consumed still
// reaches the output (XORed into the accumulator), or ptxas deletes it.
constexpr bool kConvert = true;   // weight bytes to bf16 fragments
constexpr bool kProducts = true;  // the tensor-core products
constexpr bool kConsume = true;   // the consumers read their stages at all
constexpr bool kScale = true;     // kW8A8: each qblock's s32 sums scaled by sx on its own
constexpr bool kPingPong = false;  // kW8A8: the warpgroups take the tensor cores in turn

// A stage: the weight box, the x boxes (NB rows x 128 bytes each), and int4's
// two scale rows (loaded in a pair's first stage only). kW8A8: a whole pair,
// its two weight boxes and the xq box of its 128 k.
__host__ __device__ constexpr int stage_bytes(int mode, int nb) {
  return mode == kW8    ? kWBox + nb * 128
         : mode == kW8A8 ? 2 * kWBox + nb * 128
                         : kWBox + 2 * nb * 128 + kScaleTile;
}
// kW8A8: a stage's slot for the NB row scales of a qblock (TMA's 128-byte
// alignment), after the ring
__host__ __device__ constexpr int sx_slot(int mode, int nb) {
  return mode == kW8A8 ? (nb * 4 + 127) / 128 * 128 : 0;
}
// blocks an SM: two for the narrow w8a8 widths, one otherwise
__host__ __device__ constexpr int blocks_per_sm(int mode, int nb) {
  return mode == kW8A8 && nb <= 48 ? 2 : 1;
}
// the shared memory a block may take: all of it, or half an SM's 228 KB less
// the 1 KB each resident block reserves
constexpr size_t smem_limit(int mode, int nb) {
  return blocks_per_sm(mode, nb) == 2 ? 233472 / 2 - 1024 : 232448;
}

// The dynamic shared memory of a launch: the ring (or the partial tile of a K
// split, where that is larger), kW8A8's sx slots, the barriers, alignment
// slack.
inline size_t smem_bytes(int mode, int nb, int stages) {
  const size_t ring = (size_t)stages * stage_bytes(mode, nb), tile = (size_t)nb * kPitch * 4;
  return (ring > tile ? ring : tile) + (size_t)stages * (sx_slot(mode, nb) + 16) + 1024;
}

struct alignas(64) Params {
  CUtensorMap w;        // weight bytes, boxes of 128 columns x 64 rows
  CUtensorMap x;        // x, boxes of 64 k x NB rows
  CUtensorMap s;        // int4: scales, boxes of 128 columns x 1 row; kW8A8: sx, NB rows x 1
  const float* scales;  // int8: the per-channel scales
  __nv_bfloat16* y;
  int M, N, K, cb, ck, stages;
  int qbu;  // kW8A8: pairs a qblock
};

// An A fragment of the k16 step whose 8-row matrices a thread holds in words
// w0 (k 0-7) and w1 (k 8-15): a0 = column 2g at k 2t, 2t + 1 (bytes 0 and 2
// of w0), a1 = column 2g + 1 (bytes 1 and 3), a2, a3 the same from w1. int8
// the bytes; int4 the low nibbles (the low K-half, H = 0) or the high ones;
// kW4Dequant times s (the scales of columns 2g and 2g + 1).
template <int MODE, int H>
__device__ __forceinline__ void a_fragment(uint32_t w0, uint32_t w1, float2 s, uint32_t (&a)[4]) {
  constexpr int kShift = MODE == kW8 ? 0 : 4 * H;
  if constexpr (!kConvert) {
    a[0] = w0 >> kShift;
    a[1] = w0 >> (8 + kShift);
    a[2] = w1 >> kShift;
    a[3] = w1 >> (8 + kShift);
  } else if constexpr (MODE == kW8) {
    a[0] = s8_halves_to_bf16x2(w0);
    a[1] = s8_halves_to_bf16x2(w0 >> 8);
    a[2] = s8_halves_to_bf16x2(w1);
    a[3] = s8_halves_to_bf16x2(w1 >> 8);
  } else {
    a[0] = nibbles_to_bf16x2(w0 >> kShift);
    a[1] = nibbles_to_bf16x2(w0 >> (8 + kShift));
    a[2] = nibbles_to_bf16x2(w1 >> kShift);
    a[3] = nibbles_to_bf16x2(w1 >> (8 + kShift));
    if constexpr (MODE == kW4Dequant) {
      a[0] = scale_bf16x2(a[0], s.x);
      a[1] = scale_bf16x2(a[1], s.y);
      a[2] = scale_bf16x2(a[2], s.x);
      a[3] = scale_bf16x2(a[3], s.y);
    }
  }
}

// The 8 A fragments of half H of a pair (the stages' k16 steps in order:
// stage i / 4, step i % 4) from the pair's raw words r[stage][32-row
// chunk][matrix].
template <int MODE, int H>
__device__ __forceinline__ void pair_fragments(const uint32_t (&r)[2][2][4], float2 s,
                                               uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int st = i / 4, q = i % 4;
    a_fragment<MODE, H>(r[st][q / 2][2 * (q % 2)], r[st][q / 2][2 * (q % 2) + 1], s, a[i]);
  }
}

// d (+)= the 8 k16 steps of one x box sequence: fragment i against the x box
// of stage i / 4 (shared address xb[i / 4]) at k16 step i % 4. scale_d 0 on
// the first product when `fresh`.
template <int NB>
__device__ __forceinline__ void pair_products(float (&d)[NB / 2], const uint32_t (&a)[8][4],
                                              const uint32_t (&xb)[2], bool fresh,
                                              uint32_t& sink) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (kProducts)
      wgmma_bf16_rs(d, a[i][0], a[i][1], a[i][2], a[i][3],
                    desc_sw128(xb[i / 4] + 32 * (i % 4), 16, 1024), (fresh && i == 0) ? 0 : 1);
    else
      sink ^= a[i][0] ^ a[i][1] ^ a[i][2] ^ a[i][3];
  }
}

// Grid: one cluster of ck blocks for each tile (column tile, batch block),
// batch blocks fastest; rank kr takes K's pairs [kr U / ck, (kr + 1) U / ck)
// of U (int8: ceil(K / 128), rows past K arriving as zeros; int4: K / 256,
// pair u holding packed rows 128 u .. 128 u + 127: group u of the low half,
// U + u of the high half; kW8A8: the pairs of qblocks [kr Q / ck, (kr + 1) Q
// / ck) of Q = U / qbu).
template <int MODE, int NB>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(MODE, NB))
quant_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr bool kInt4 = MODE == kW4 || MODE == kW4Dequant;
  constexpr bool kTwo = blocks_per_sm(MODE, NB) == 2;
  constexpr int kStage = stage_bytes(MODE, NB);
  constexpr int kXBox = NB * 128;
  constexpr int kSxSlot = sx_slot(MODE, NB);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = p.stages, ck = p.ck;
  const int ring_bytes = max(stages * kStage, NB * kPitch * 4);  // the tile lies over the ring
  unsigned char* sx_slots = ring + ring_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(sx_slots + stages * kSxSlot);
  uint64_t* empty = full + stages;
  const int kr = ck > 1 ? (int)cluster_rank() : 0;
  const int tile = blockIdx.x / ck, br = tile % p.cb;
  const int n0 = (tile / p.cb) * kBN, row0 = br * NB;
  const int units = kInt4 ? p.K / 256 : (p.K + 127) / 128;
  int u0 = kr * units / ck, u1 = (kr + 1) * units / ck;
  if constexpr (MODE == kW8A8) {
    const int q = units / p.qbu;
    u0 = kr * q / ck * p.qbu;
    u1 = (kr + 1) * q / ck * p.qbu;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {  // producer warpgroup: one thread issues the stages
    setmaxnreg_dec<kTwo ? 24 : 40>();
    if (MODE == kW8A8 && threadIdx.x == 128 * kConsumers) {
      // stage i of the share: pair u0 + i, its weight rows and xq's 128 k,
      // and at a qblock's last pair the qblock's sx. The first lap's weights
      // do not depend on the quantize launch this grid follows: they go out
      // before its wait.
      const int total = u1 - u0, first = min(stages, total);
      auto load_w = [&](int i, int stage) {
        const int u = u0 + i;
        mbar_expect_tx(&full[stage], kStage + ((u + 1) % p.qbu ? 0 : NB * 4));
        tma_load_2d(ring + stage * kStage, &p.w, &full[stage], n0, 128 * u);
        tma_load_2d(ring + stage * kStage + kWBox, &p.w, &full[stage], n0, 128 * u + kRows);
      };
      auto load_x = [&](int i, int stage) {
        const int u = u0 + i;
        tma_load_2d(ring + stage * kStage + 2 * kWBox, &p.x, &full[stage], 128 * u, row0);
        if ((u + 1) % p.qbu == 0)
          tma_load_2d(sx_slots + stage * kSxSlot, &p.s, &full[stage], row0, u / p.qbu);
      };
      for (int i = 0; i < first; ++i) load_w(i, i);
      grid_dependency_wait();
      for (int i = 0; i < first; ++i) load_x(i, i);
      RingPos pos;
      for (int i = 0; i < first; ++i) pos.advance(stages);
      for (int i = first; i < total; ++i) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        load_w(i, pos.stage);
        load_x(i, pos.stage);
        pos.advance(stages);
      }
    } else if (MODE != kW8A8 && threadIdx.x == 128 * kConsumers) {
      RingPos pos;
      for (int u = u0; u < u1; ++u) {
#pragma unroll 1
        for (int s = 0; s < 2; ++s) {
          mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
          uint64_t* bar = &full[pos.stage];
          unsigned char* st = ring + pos.stage * kStage;
          const int row = 128 * u + kRows * s;  // stored rows (int4: packed)
          mbar_expect_tx(bar, kInt4 && s == 1 ? kStage - kScaleTile : kStage);
          tma_load_2d(st, &p.w, bar, n0, row);
          tma_load_2d(st + kWBox, &p.x, bar, row, row0);  // int4: the low half's k
          if constexpr (kInt4) {
            tma_load_2d(st + kWBox + kXBox, &p.x, bar, p.K / 2 + row, row0);
            if (s == 0) {
              unsigned char* sc = st + kWBox + 2 * kXBox;
              tma_load_2d(sc, &p.s, bar, n0, u);
              tma_load_2d(sc + kBN * 4, &p.s, bar, n0, units + u);
            }
          }
          pos.advance(stages);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kTwo ? 104 : 232>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // this warp's 16 columns are 16-byte chunk `warp` of each weight row; its
  // warpgroup rows 16 (warp % 4) + g and + 8 are columns n_a and n_a + 1
  const int n_a = 16 * warp + 2 * g;
  const uint32_t a_off = lane * 128 + ((warp ^ (lane & 7)) << 4);
  // a pair's two stages are consumed: lane 0 of each warp arrives on their
  // empty barriers
  auto release = [&](RingPos q) {
    if (lane != 0) return;
    mbar_arrive(&empty[q.stage]);
    q.advance(stages);
    mbar_arrive(&empty[q.stage]);
  };
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  uint32_t sink = 0;  // kProducts off: the fragments, so that they are computed
  RingPos pos;
  if constexpr (!kConsume && MODE == kW8A8) {  // a pair is one stage
    for (int u = u0; u < u1; ++u) {
      mbar_wait(&full[pos.stage], pos.phase);
      if (lane == 0) mbar_arrive(&empty[pos.stage]);
      pos.advance(stages);
    }
  } else if constexpr (!kConsume) {
    for (int u = u0; u < u1; ++u) {
      RingPos next = pos;
      next.advance(stages);
      mbar_wait(&full[pos.stage], pos.phase);
      mbar_wait(&full[next.stage], next.phase);
      release(pos);
      pos = next;
      pos.advance(stages);
    }
  } else {
    // The pair's weight words ([stage][32-row chunk][matrix]) and its stages'
    // shared addresses, once both stages have landed.
    uint32_t r[2][2][4], st[2];
    auto take = [&](RingPos q) {
      RingPos next = q;
      next.advance(stages);
      mbar_wait(&full[q.stage], q.phase);
      mbar_wait(&full[next.stage], next.phase);
      st[0] = smem_u32(ring + q.stage * kStage);
      st[1] = smem_u32(ring + next.stage * kStage);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < 2; ++j) ldsm_x4_trans(r[s][j], st[s] + j * 32 * 128 + a_off);
    };
    // A fragments in two register buffers, so that one group of products is
    // in flight while the next group's fragments are converted. int8: a
    // group is one stage's 4 k16 steps (buffer = the stage of the pair);
    // the wait after issuing a group retires the one before, whose buffer is
    // then free and whose pair's stages, at a pair's first group, go back.
    // int4: a group is one K-half's 8 k16 steps (buffer = the half); kW4
    // waits for a group before scaling its sum into the accumulator (ptxas
    // serializes every product when other code reads an accumulator tile
    // while any product is in flight), and the other warpgroup's products
    // fill the wait.
    using Lo = std::integral_constant<int, 0>;
    using Hi = std::integral_constant<int, 1>;
    if constexpr (MODE == kW8) {
      uint32_t a[2][4][4];
      auto group = [&](auto buf) {  // stage b of the pair
        constexpr int b = decltype(buf)::value;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a_fragment<MODE, 0>(r[b][i / 2][2 * (i % 2)], r[b][i / 2][2 * (i % 2) + 1],
                              make_float2(1.f, 1.f), a[b][i]);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kProducts)
            wgmma_bf16_rs(acc, a[b][i][0], a[b][i][1], a[b][i][2], a[b][i][3],
                          desc_sw128(st[b] + kWBox + 32 * i, 16, 1024), 1);
          else
            sink ^= a[b][i][0] ^ a[b][i][1] ^ a[b][i][2] ^ a[b][i][3];
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group before is done
#pragma unroll
        for (int i = 0; i < 4; ++i) fence_regs(a[1 - b][i]);
      };
      RingPos prev;
      for (int u = u0; u < u1; ++u) {
        take(pos);
        group(Lo{});
        if (u > u0) release(prev);  // its second stage's products are done
        group(Hi{});
        prev = pos;
        pos.advance(stages);
        pos.advance(stages);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_regs(a[1][i]);
      release(prev);
    } else if constexpr (MODE == kW8A8) {
      // A pair (one stage) is 4 k32 steps (step i: weight rows 32 i of the
      // pair's two boxes), each A fragment one transposed ldmatrix and four
      // byte permutes, B the pair's xq box at 32 i bytes. A qblock's first
      // pair starts the s32 tile (scale-d 0); its last waits for its
      // products and scales them into acc by sx, then hands its stage back.
      // Between, the wait after a pair retires the pair before, whose stage
      // and fragment buffer are then free. Pairs alternate between two
      // fragment buffers. kPingPong (off: slower, see the top of the file):
      // the warpgroups issue their products in turn, a pair each
      // (warpgroup 0's pair u, warpgroup 1's pair u, warpgroup 0's pair u +
      // 1, ...: named barriers 2 and 3, on which each warpgroup waits for
      // its turn and hands the other its own); warpgroup 0 takes its first
      // turn unasked and warpgroup 1 hands back no turn after its last pair,
      // so every arrival is met.
      const int wg = threadIdx.x / 128;
      auto turn = [&](int u) {
        if (kPingPong && (wg == 1 || u > u0)) named_barrier(2 + wg, 128 * kConsumers);
      };
      auto hand_over = [&](int u) {
        if (kPingPong && (wg == 0 || u + 1 < u1)) named_barrier_arrive(3 - wg, 128 * kConsumers);
      };
      int acc_i[NB / 2];
      uint32_t a[2][4][4];
      RingPos prev;
      bool held = false;  // prev's stage awaits the end of its products
      auto release1 = [&](RingPos q) {
        if (lane == 0) mbar_arrive(&empty[q.stage]);
      };
      auto pair = [&](auto buf, int u) {
        constexpr int b = decltype(buf)::value;
        mbar_wait(&full[pos.stage], pos.phase);
        const uint32_t s0 = smem_u32(ring + pos.stage * kStage);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t r[4];
          ldsm_x4_trans(r, s0 + i * 32 * 128 + a_off);
          s8_a_from_trans(r, a[b][i]);
        }
        const bool fresh = kScale ? u % p.qbu == 0 : u == u0;
        const bool last = kScale ? (u + 1) % p.qbu == 0 : u + 1 == u1;
        turn(u);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kProducts)
            wgmma_s8_rs(acc_i, a[b][i], desc_sw128(s0 + 2 * kWBox + 32 * i, 16, 1024),
                        fresh && i == 0 ? 0 : 1);
          else
            sink ^= a[b][i][0] ^ a[b][i][1] ^ a[b][i][2] ^ a[b][i][3];
        }
        wgmma_commit();
        hand_over(u);
        if (last) {
          wgmma_wait<0>();
          fence_regs(acc_i);
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_regs(a[b][i]);
          if (held) release1(prev);
          held = false;
          const float* sxs = reinterpret_cast<const float*>(sx_slots + pos.stage * kSxSlot);
#pragma unroll
          for (int j = 0; j < NB / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float s_m = kScale ? sxs[8 * j + 2 * t + e] : 1.f;
              acc[4 * j + e] += (float)acc_i[4 * j + e] * s_m;
              acc[4 * j + 2 + e] += (float)acc_i[4 * j + 2 + e] * s_m;
            }
          release1(pos);
        } else {
          wgmma_wait<1>();
#pragma unroll
          for (int i = 0; i < 4; ++i) fence_regs(a[1 - b][i]);
          if (held) release1(prev);
          prev = pos;
          held = true;
        }
        pos.advance(stages);
      };
      for (int u = u0; u < u1; u += 2) {
        pair(Lo{}, u);
        if (u + 1 < u1) pair(Hi{}, u + 1);
      }
    } else {
      // int4: the pair's low half, its high half converted while it runs;
      // kW4 scales the low half's group sum in once it has completed, then
      // runs the high half into the same tile. The pair's stages go back
      // before the next pair is taken, so that the ring (five stages of
      // 41 KB at NB = 128) keeps three stages loading.
      uint32_t a[2][8][4];
      float part[MODE == kW4 ? NB / 2 : 1];  // kW4: the current group's f32 sum
      auto scale_in = [&](float2 s) {  // the completed group sum times its scales
        if constexpr (MODE == kW4) {
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < NB / 2; ++i) acc[i] += part[i] * (i % 4 < 2 ? s.x : s.y);
        }
      };
      auto issue = [&](auto buf, const uint32_t(&xb)[2]) {
        constexpr int b = decltype(buf)::value;
        wgmma_fence();
        if constexpr (MODE == kW4) pair_products<NB>(part, a[b], xb, true, sink);
        else pair_products<NB>(acc, a[b], xb, false, sink);
        wgmma_commit();
      };
      for (int u = u0; u < u1; ++u) {
        take(pos);
        const float* sc =
            reinterpret_cast<const float*>(ring + pos.stage * kStage + kWBox + 2 * kXBox);
        const float2 s_lo = *reinterpret_cast<const float2*>(sc + n_a);
        const float2 s_hi = *reinterpret_cast<const float2*>(sc + kBN + n_a);
        const uint32_t xlo[2] = {st[0] + kWBox, st[1] + kWBox};
        const uint32_t xhi[2] = {st[0] + kWBox + kXBox, st[1] + kWBox + kXBox};
        pair_fragments<MODE, 0>(r, s_lo, a[0]);
        issue(Lo{}, xlo);
        pair_fragments<MODE, 1>(r, s_hi, a[1]);  // while the low half runs
        if constexpr (MODE == kW4) {
          wgmma_wait<0>();
          scale_in(s_lo);
        }
        issue(Hi{}, xhi);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          fence_regs(a[0][i]);
          fence_regs(a[1][i]);
        }
        scale_in(s_hi);
        release(pos);
        pos.advance(stages);
        pos.advance(stages);
      }
    }
  }
  fence_regs(acc);
  if constexpr (!kProducts || !kConsume) sink_into(acc[0], sink);

  // acc[4j + 2h + e] is column n_a + h, batch row 8j + 2t + e of the tile
  if (ck == 1) {  // the whole K: round and store
    const int n = n0 + n_a;
    if (n < p.N) {
      float2 s = make_float2(1.f, 1.f);
      if constexpr (MODE == kW8 || MODE == kW8A8)
        s = __ldg(reinterpret_cast<const float2*>(p.scales + n));
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = row0 + 8 * j + 2 * t + e;
          if (m < p.M)
            *reinterpret_cast<uint32_t*>(p.y + (size_t)m * p.N + n) =
                pack_bf16x2(acc[4 * j + e] * s.x, acc[4 * j + 2 + e] * s.y);
        }
    }
    return;
  }
  // K split: the f32 tile over the ring once both warpgroups are done with
  // it; block kr finishes its share of the tile's column quads, summing the
  // ck partial tiles in rank order, between two rounds of the cluster
  // barrier (the consumers' alone: the producers have left)
  named_barrier(1, 128 * kConsumers);
  float* part_tile = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(part_tile + (8 * j + 2 * t + e) * kPitch + n_a) =
          make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
  cluster_arrive_release();  // (1) every block's partial tile is written
  cluster_wait();
  constexpr int kQuads = kBN / 4;
  const int quads = min(NB, p.M - row0) * kQuads;
  const int lo = kr * quads / ck, hi = (kr + 1) * quads / ck;
  for (int i = lo + (int)threadIdx.x; i < hi; i += 128 * kConsumers) {
    const int m = i / kQuads, q = i % kQuads;
    const uint32_t at = smem_u32(part_tile + m * kPitch + 4 * q);
    float4 part_of[kMaxCluster];
#pragma unroll
    for (int src = 0; src < kMaxCluster; ++src)
      if (src < ck) part_of[src] = ld_cluster_f32x4(map_to_rank(at, src));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int src = 0; src < kMaxCluster; ++src)
      if (src < ck) {
        sum.x += part_of[src].x;
        sum.y += part_of[src].y;
        sum.z += part_of[src].z;
        sum.w += part_of[src].w;
      }
    const int n = n0 + 4 * q;
    if (n < p.N) {
      float4 s = make_float4(1.f, 1.f, 1.f, 1.f);
      if constexpr (MODE == kW8 || MODE == kW8A8)
        s = __ldg(reinterpret_cast<const float4*>(p.scales + n));
      *reinterpret_cast<uint2*>(p.y + (size_t)(row0 + m) * p.N + n) =
          make_uint2(pack_bf16x2(sum.x * s.x, sum.y * s.y), pack_bf16x2(sum.z * s.z, sum.w * s.w));
    }
  }
  cluster_arrive_relaxed();  // (2) every block has read the tiles: no block leaves before
  cluster_wait();
}

// The launch of a grid of `blocks` in clusters of `cluster`; `dependent`:
// as the programmatic dependent of the launch before it on the stream.
static inline void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2],
                                  int blocks, int cluster, size_t smem, bool dependent = false) {
  cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1] = programmatic_launch();
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 2 : 1;
}

template <int MODE, int NB>
cudaError_t launch_nb(const Params& p, int blocks, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes(MODE, NB, p.stages);
  cudaError_t err = ensure_smem(quant_wgmma_kernel<MODE, NB>, smem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cluster_config(cfg, attr, blocks, p.ck, smem, MODE == kW8A8);
  cfg.stream = st;
  err = cudaLaunchKernelEx(&cfg, quant_wgmma_kernel<MODE, NB>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE, int NB>
int active_clusters_nb(int cluster, int stages) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes(MODE, NB, stages);
  cudaError_t err = ensure_smem(quant_wgmma_kernel<MODE, NB>, smem, &granted);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cluster_config(cfg, attr, cluster * 64, cluster, smem);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, quant_wgmma_kernel<MODE, NB>, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// The batch-block widths the kernel is built for (wgmma N): bf16 products,
// and the s8 ones of kW8A8 (s8 wgmma takes N = 8, 16, 24 and multiples of 16).
#define AGK_QWG_WIDTHS(X) X(32) X(40) X(48) X(64) X(96) X(128)
#define AGK_QWG_S8_WIDTHS(X) X(16) X(24) X(32) X(48) X(64) X(96) X(128)

// Checks the plan (NB one of the widths, cb blocks of NB rows covering M
// with none empty, a legal cluster, a K split no finer than K's pairs
// (kW8A8: its qblocks), a ring of at least two stages within a block's
// shared memory), makes the tensor maps and launches. Device pointers to
// contiguous tensors: x [m, k] bf16 (kW8A8: xq int8 [m, k], and sx f32 [k /
// qblock, m rounded up to 4]); w int8 [k, n] (kW8, kW8A8) or [k / 2, n]
// (packed int4); scales f32 [1, n] or [k / 128, n]; y [m, n] bf16. The plan
// comes from ops/quant.py::wgmma_plan, which also checks dtypes and
// alignment. Returns the first CUDA error, or 0.
template <int MODE>
int launch(const void* x, const void* w, const void* scales, void* y, int m, int n, int k,
           int nb, int cb, int ck, int stages, void* stream, const void* sx = nullptr) {
  constexpr bool kInt4 = MODE == kW4 || MODE == kW4Dequant;
  const int units = kInt4 ? k / 256 : (k + 127) / 128;
  const int qblock = k < 512 ? k : 512, qbu = (qblock + 127) / 128;
  const int splittable = MODE == kW8A8 ? k / qblock : units;
  if (m < 1 || n < 16 || n % 16 || k < 1 || k % (kInt4 ? 256 : 64) || nb < 8 || nb > 128 ||
      cb < 1 || (long)cb * nb < m || (long)(cb - 1) * nb >= m || ck < 1 || ck > kMaxCluster ||
      ck > splittable || stages < 2 || stages > kMaxStages ||
      smem_bytes(MODE, nb, stages) > smem_limit(MODE, nb) ||
      (MODE == kW8A8 && (k % qblock || sx == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.scales = static_cast<const float*>(scales);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.M = m, p.N = n, p.K = k, p.cb = cb, p.ck = ck, p.stages = stages, p.qbu = qbu;
  int bad = tensor_map_2d(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, n, kInt4 ? k / 2 : k, n, kBN,
                          kRows);
  if (MODE == kW8A8) {
    const uint64_t m_pad = (m + 3) / 4 * 4;
    bad = bad || tensor_map_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, k, m, k, 128, nb) ||
          tensor_map_2d(&p.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sx, m, k / qblock, 4 * m_pad, nb,
                        1, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    bad = bad || tensor_map_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, k, m, 2ull * k, 64, nb) ||
          (kInt4 && tensor_map_2d(&p.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, n, k / 128,
                                  4ull * n, kBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE));
  }
  if (bad) return (int)cudaErrorInvalidValue;
  const int blocks = ((n + kBN - 1) / kBN) * cb * ck;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AGK_QWG_CASE(W) \
  case W:               \
    return (int)launch_nb<MODE, W>(p, blocks, st);
  if constexpr (MODE == kW8A8) {
    switch (nb) { AGK_QWG_S8_WIDTHS(AGK_QWG_CASE) }
  } else {
    switch (nb) { AGK_QWG_WIDTHS(AGK_QWG_CASE) }
  }
#undef AGK_QWG_CASE
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `cluster` blocks the card holds at once for the
// kernel of width nb with a ring of `stages`; a negative CUDA error on
// failure. The wrappers' plans read it.
template <int MODE>
int active_clusters(int nb, int cluster, int stages) {
  if (cluster < 1 || cluster > kMaxCluster || stages < 2 || stages > kMaxStages)
    return -(int)cudaErrorInvalidValue;
#define AGK_QWG_CASE(W) \
  case W:               \
    return active_clusters_nb<MODE, W>(cluster, stages);
  if constexpr (MODE == kW8A8) {
    switch (nb) { AGK_QWG_S8_WIDTHS(AGK_QWG_CASE) }
  } else {
    switch (nb) { AGK_QWG_WIDTHS(AGK_QWG_CASE) }
  }
#undef AGK_QWG_CASE
  return -(int)cudaErrorInvalidValue;
}

// The blocks an SM the kernel of width nb is built for (its launch bounds),
// or -1 for a width it has no build of. The wrappers' plans size the ring by
// it.
template <int MODE>
int blocks_an_sm(int nb) {
#define AGK_QWG_CASE(W) \
  case W:               \
    return blocks_per_sm(MODE, W);
  if constexpr (MODE == kW8A8) {
    switch (nb) { AGK_QWG_S8_WIDTHS(AGK_QWG_CASE) }
  } else {
    switch (nb) { AGK_QWG_WIDTHS(AGK_QWG_CASE) }
  }
#undef AGK_QWG_CASE
  return -1;
}

}  // namespace qwg
}  // namespace agk
