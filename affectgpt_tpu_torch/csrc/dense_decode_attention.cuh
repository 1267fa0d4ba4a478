// Decode attention over the dense KV cache on Hopper (sm_90a), one launch:
// one query token per row, GQA, online softmax in f32. Two wrappers of the
// port launch it, each with its own rule for the cache columns a row attends
// to (the template parameter Keys):
//   - kWindow, the attention stage of the decode attention sublayer
//     (csrc/decode_attn_o.cu, replacing the attention part of
//     affectgpt_tpu/ops/decode_attn_o_pallas.py::decode_attn_o): row r's
//     valid columns are its window [lo, hi], from the first to the last valid
//     column of mask row r, or all of [0, T - 1] where the row has none: the
//     reduction the TPU wrapper makes (decode_attn_o_pallas.py:135-137), made
//     here by every block from the mask row itself;
//   - kMaskWindow and kMaskAll, decode attention (csrc/decode_attention.cu,
//     replacing affectgpt_tpu/ops/decode_attention_pallas.py::
//     decode_attention_pallas), which takes any mask: a column is valid
//     exactly when its mask byte is non-zero, and a row with no valid column
//     gives zeros (decode_attention_pallas.py:25-46). kMaskWindow shares out
//     the tiles of the row's window (reduced from the mask row before the
//     first load, as kWindow; no tile at all where no column is valid);
//     kMaskAll all ceil(T / 16) tiles of the row, so that the first loads
//     wait for nothing, and a tile with no valid column is loaded and
//     skipped. The plan (ops/decode_attention.py::decode_attention_plan)
//     picks one of the two by the batch.
// The design is the paged decode attention's (csrc/paged_attention.cu), with
// a 4-D tensor map over the cache in place of the block table; the two share
// their consumer steps and merge (csrc/split_attention.cuh).
//
// Layouts: q [b, kv, g, d] and out [b, kv, g, d] bf16 (out flattened is the
// head-major [b, kv g d] that o_proj reads); the caches [b, kv, T, d] bf16;
// mask [b, T] bool.
//
// Arithmetic: f32 scores q.k / sqrt(d) (in the base-2 domain: exp2 of
// scores times log2(e) / sqrt(d)), invalid keys at p = 0, the running max,
// sum and accumulator in f32, out = acc / max(sum, 1e-20) rounded once to
// bf16 (decode_attn_o_pallas.py:100, decode_attention_pallas.py:46). A row
// with no valid key keeps (max -1e30, sum 0, acc 0) in every warp and block,
// so the merges weigh each state by exp2(0) = 1 and write 0 / 1e-20 = 0. The
// PV product takes p as two bf16 parts, p_hi = bf16(p) and p_lo = bf16(p -
// p_hi), two products on the same V fragments: 16 significant bits of p,
// against the 8 of one bf16 rounding, so the product keeps the TPU kernel's
// f32 p to well below the output's rounding.
//
// Bound: cache bytes. Each valid column's K and V rows (2 kv d values, 2 KiB
// a column per layer at Qwen2.5-7B width: 10.5 MB at b = 8, T = 640) are
// read once and used for 2 g multiply-adds a value, far below the
// tensor-core rate. At decode batches a block's share is a few tiles, so it
// costs memory latencies more than its bytes' time. The design:
//   - splits from the plan (ops/decode_attention.py::attention_plan): the
//     tiles of each (row, kv head) pair (its window's, from lo rounded down to
//     16, or all of the row's) are cut into C shares of whole 16-token tiles
//     (C <= 8, from b * kv and the SM count);
//   - one producer thread brings each tile's K and V rows of its kv head by
//     TMA (boxes of 16 rows x 64 values, 128-byte swizzle; rows past T
//     arrive as zeros) into a ring of stages on mbarriers;
//   - under kMask*, the consumer warps copy the mask bytes of their block's
//     share into shared memory while the first stages load, and a tile's 16
//     valid bits are one ballot of its bytes;
//   - both products on mma.sync m16n8k16 (bf16 in, f32 out), the <= 8 query
//     heads of the kv head as the n8 operand: S^T = K Q^T with the tile's 16
//     tokens as the A rows, Out^T = V^T P^T with d as the A rows (transposed
//     ldmatrix of the V tile) and P^T moved from the S^T fragment into the B
//     fragment by movmatrix; four consumer warps take the share's tiles in
//     turn, each with its own running (max, sum, accumulator), and skip a
//     tile with no valid token; the V fragments of invalid tokens are
//     zeroed, whatever the cache holds there;
//   - the merge in the same launch: the warps' states meet in shared memory
//     (fixed order), then the C blocks of a pair, one cluster, meet through
//     distributed shared memory, each summing its share of the output over
//     the blocks in rank order between two rounds of the cluster barrier. No
//     atomics: two calls give the same bits.
// The grid calls launch_dependents once its barriers are set, so the launch
// after it (decode_attn_o.cu's o_proj) may start loading its weights.
#pragma once

#include <stdint.h>

#include "split_attention.cuh"

namespace agk {
namespace dense {

using namespace hopper;
using namespace split;

constexpr int kConsumers = 4;  // warps; one more warp issues the loads
constexpr int kThreads = 32 * (kConsumers + 1);

// Which cache columns a row attends to (the header's note; the values are
// the C entry's and ops/decode_attention.py's WINDOW, MASK_WINDOW, MASK_ALL).
enum class Keys : int { kWindow = 0, kMaskWindow = 1, kMaskAll = 2 };

// A stage: the K tile, then the V tile, each [D / 64 boxes][16 rows][128
// bytes] (one box: 64 head-dim values of 16 tokens). Also computed by
// ops/decode_attention.py::attention_plan.
template <int D>
struct Tiles {
  static constexpr int kBoxes = D / 64;
  static constexpr int kBoxBytes = kTile * 128;
  static constexpr int kKvBytes = kBoxes * kBoxBytes;
  static constexpr int kStageBytes = 2 * kKvBytes;
  static constexpr int kMergeBytes = merge_bytes<kConsumers, D>();
};

// Row r's first and last valid column from its mask row (T bytes, non-zero
// = valid); lo = T and hi = -1 when none is valid. The warp reads the row in
// aligned 16-byte chunks (the row starts anywhere).
__device__ __forceinline__ void key_window(const unsigned char* row, int T, int& lo, int& hi) {
  const int lane = threadIdx.x % 32;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const uint4* chunks = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  const int off = (int)(addr & 15);  // row[i] is byte off + i of the chunks
  int first = T, last = -1;
  for (int c = lane; c * 16 < off + T; c += 32) {
    const uint4 v = __ldg(chunks + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = 16 * c + j - off;
      if (((w[j / 4] >> (8 * (j % 4))) & 0xFFu) && i >= 0 && i < T) {
        first = min(first, i);
        last = max(last, i);
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, first);
  hi = __reduce_max_sync(0xffffffffu, last);
}

// The mask bytes of a block's tiles [t0, t1) (kMask*): the consumer warps
// copy them into shared memory at buf in aligned 16-byte chunks as they lie
// in the row (a row of T = 577 starts at any byte), the bytes of columns
// past T zeroed; column 16 t0 + j is the returned pointer's byte j. buf holds
// 16 (t1 - t0 + 1) bytes (keys_bytes).
__device__ __forceinline__ const unsigned char* share_keys(const unsigned char* row, int T,
                                                           int t0, int t1, unsigned char* buf) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row) + kTile * t0;
  const uint4* chunks = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  const int off = (int)(addr & 15);
  const int end = off + min(kTile * t1, T) - kTile * t0;  // past the share's last column < T
  for (int c = threadIdx.x; 16 * c < off + kTile * (t1 - t0); c += 32 * kConsumers) {
    const int keep = end - 16 * c;  // the chunk's bytes before `end`
    uint4 v = keep > 0 ? __ldg(chunks + c) : make_uint4(0u, 0u, 0u, 0u);
    uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = keep - 4 * j;
      if (n < 4) w[j] &= n <= 0 ? 0u : (1u << (8 * n)) - 1u;
    }
    reinterpret_cast<uint4*>(buf)[c] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  named_barrier(2, 32 * kConsumers);
  return buf + off;
}

// The valid tokens of a tile under kWindow: bit i for token i, inside [lo, hi].
__device__ __forceinline__ uint32_t window_bits(int tile, int lo, int hi) {
  const int a = max(lo - kTile * tile, 0), e = min(hi - kTile * tile, kTile - 1);
  return e < a ? 0u : (0xFFFFu >> (kTile - 1 - e)) & (0xFFFFu << a);
}

// Shared memory for a share's mask bytes (share_keys), at most
// ceil(ceil(T / 16) / splits) tiles and one chunk more: none under kWindow.
// Also computed by ops/decode_attention.py::attention_plan.
template <Keys K>
__host__ __device__ constexpr int keys_bytes(int T, int splits) {
  return K == Keys::kWindow ? 0 : 16 * (((T + kTile - 1) / kTile + splits - 1) / splits + 1);
}

// Grid: one cluster of `splits` blocks per (row, kv head) pair, pair-major.
// k_map and v_map: the caches as 4-D tensors (d, T, kv, b), boxes of 64 x
// 16 x 1 x 1.
template <int D, Keys K>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
             const __nv_bfloat16* __restrict__ q, const unsigned char* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int kv, int G, int T, int splits, int stages) {
  using L = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int ring_bytes = max(stages * L::kStageBytes, L::kMergeBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_bytes);
  uint64_t* empty = full + stages;
  unsigned char* key_buf = reinterpret_cast<unsigned char*>(empty + stages);  // kMask*
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = blockIdx.x % splits, pair = blockIdx.x / splits;
  const int row = pair / kv, head = pair % kv;
  const int g = lane / 4, t = lane % 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  // Issued before the window's reduction, so that their latencies overlap:
  // the consumers' Q fragments (B operand of S^T = K Q^T: query head g, zero
  // past G; head-dim pairs (2t, 2t + 1) and (2t + 8, 2t + 9) of each k16
  // step).
  uint32_t qf[D / 16][2];
  if (warp < kConsumers) {
    const __nv_bfloat16* qr = q + ((size_t)pair * G + g) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * t)) : 0u;
      qf[kk][1] = g < G ? __ldg(reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * t + 8)) : 0u;
    }
  }
  const unsigned char* mrow = mask + (size_t)row * T;
  int lo = 0, hi = T - 1;  // kMaskAll: every tile of the row
  if constexpr (K != Keys::kMaskAll) key_window(mrow, T, lo, hi);
  if constexpr (K == Keys::kWindow) {
    if (hi < 0) {  // no valid column: the TPU wrapper's [0, T - 1]
      lo = 0;
      hi = T - 1;
    }
  }
  // this block's tiles [t0, t1) of the tiles lo / 16 .. hi / 16, none when hi < lo (copied
  // by tests/test_torch_launch_plans.py, which checks its copy against these lines)
  const int first = lo / kTile, tiles = hi < lo ? 0 : hi / kTile - first + 1;
  const int t0 = first + rank * tiles / splits, t1 = first + (rank + 1) * tiles / splits;
  __syncthreads();
  launch_dependents();

  if (warp == kConsumers) {  // producer: one thread issues the stages
    if (lane == 0) {
      RingPos pos;
      for (int tile = t0; tile < t1; ++tile) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        mbar_expect_tx(&full[pos.stage], L::kStageBytes);
        unsigned char* st = ring + pos.stage * L::kStageBytes;
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx) {
          tma_load_4d(st + bx * L::kBoxBytes, &k_map, &full[pos.stage], 64 * bx, tile * kTile,
                      head, row);
          tma_load_4d(st + L::kKvBytes + bx * L::kBoxBytes, &v_map, &full[pos.stage], 64 * bx,
                      tile * kTile, head, row);
        }
        pos.advance(stages);
      }
    }
    return;
  }

  const unsigned char* keys = nullptr;
  if constexpr (K != Keys::kWindow) keys = share_keys(mrow, T, t0, t1, key_buf);
  const float scale = 1.4426950408889634f * rsqrtf((float)D);  // log2(e) / sqrt(d): exp2 below
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // query heads 2t, 2t + 1
  float acc[D / 16][4];                              // Out^T: d rows, query-head columns
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  uint32_t sink = 0;  // unused: the products are on

  // warp w takes the share's tiles w, w + 4, ...: with a ring of a multiple
  // of four stages each slot always serves the same warp
  for (int s = warp, tile = t0 + warp; tile < t1; s += kConsumers, tile += kConsumers) {
    const int slot = s % stages;
    uint32_t bits;  // the tile's valid tokens, bit i for token i: the same in every lane
    if constexpr (K == Keys::kWindow)
      bits = window_bits(tile, lo, hi);
    else
      bits = __ballot_sync(0xffffffffu, keys[(tile - t0) * kTile + lane % kTile] != 0) & 0xFFFFu;
    mbar_wait(&full[slot], (uint32_t)((s / stages) & 1));
    if (bits) {  // a tile with no valid token adds nothing
      const uint32_t kt = smem_u32(ring + slot * L::kStageBytes), vt = kt + L::kKvBytes;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      scores_bf16<D>(sc, kt, L::kBoxBytes, qf, sink);
      const bool va = (bits >> g) & 1u, vb = (bits >> (g + 8)) & 1u;
      float x[4], p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = (sc[0][e] + sc[1][e]) * scale;
        x[e] = (e < 2 ? va : vb) ? v : -INFINITY;
      }
      softmax_step<D>(x, m, l, acc, p);
      // P^T as B fragments (k = tokens, n = query heads): the S^T fragment's
      // two 8x8 matrices (tokens 0-7, 8-15), transposed, p in two bf16 parts
      const uint32_t h01 = pack_bf16x2(p[0], p[1]), h23 = pack_bf16x2(p[2], p[3]);
      const float2 f01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h01));
      const float2 f23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&h23));
      const uint32_t b0 = movmatrix_trans(h01), b1 = movmatrix_trans(h23);
      const uint32_t c0 = movmatrix_trans(pack_bf16x2(p[0] - f01.x, p[1] - f01.y));
      const uint32_t c1 = movmatrix_trans(pack_bf16x2(p[2] - f23.x, p[3] - f23.y));
      uint32_t m01, m23;
      token_masks(bits, m01, m23);
      pv_bf16<D, true>(acc, vt, L::kBoxBytes, bits != 0xFFFFu, m01, m23, b0, b1, c0, c1, sink);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the stage is in registers, or not needed
  }

  float* scratch = reinterpret_cast<float*>(ring);
  __nv_bfloat16* orow = out + (size_t)pair * G * D;
  merge_warps<D, kConsumers>(scratch, acc, m, l, G, splits, orow);
  if (splits > 1) merge_cluster<D, kConsumers>(scratch, G, splits, rank, orow);
}

// The dynamic shared memory of a launch: the ring (or the merge's scratch
// over it), the barriers, the share's mask bytes, alignment slack.
template <int D>
inline size_t smem_bytes(int stages, int keys) {
  using L = Tiles<D>;
  return (size_t)max(stages * L::kStageBytes, L::kMergeBytes) + 2 * stages * 8 + keys + 1024;
}

template <int D, Keys K>
cudaError_t launch(const CUtensorMap& k_map, const CUtensorMap& v_map, const __nv_bfloat16* q,
                   const unsigned char* mask, __nv_bfloat16* out, int b, int kv, int G, int T,
                   int splits, int stages, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes<D>(stages, keys_bytes<K>(T, splits));
  cudaError_t err = ensure_smem(dense_kernel<D, K>, smem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kv * splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dense_kernel<D, K>, k_map, v_map, q, mask, out, kv, G, T,
                           splits, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace dense

// out [b, kv, g, d] = the attention of q [b, kv, g, d] over the keys of each
// row that K admits (dense::Keys) in the caches [b, kv, T, d] (bf16,
// contiguous, 16-byte aligned), mask [b, T] bool; splits (1-8 blocks a (row,
// kv head) pair, one cluster) and stages (a multiple of 4) from the plan
// (ops/decode_attention.py::attention_plan). d is 64 or 128, 1 <= g <= 8.
// One launch; returns its CUDA error.
template <dense::Keys K>
static inline cudaError_t launch_dense_decode_attention(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const unsigned char* mask, __nv_bfloat16* out, int b, int kv, int g, int T, int d, int splits,
    int stages, cudaStream_t st) {
  using namespace dense;
  if (b < 1 || kv < 1 || g < 1 || g > kHeads || T < 1 || splits < 1 || splits > kMaxSplits ||
      stages < kConsumers || stages % kConsumers || (d != 64 && d != 128))
    return cudaErrorInvalidValue;
  const int keys = keys_bytes<K>(T, splits);
  const size_t smem = d == 128 ? smem_bytes<128>(stages, keys) : smem_bytes<64>(stages, keys);
  if (smem > 232448) return cudaErrorInvalidValue;
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)T, (uint64_t)kv, (uint64_t)b};
  const uint64_t strides[3] = {2ull * d, 2ull * d * T, 2ull * d * T * kv};
  const uint32_t box[4] = {64, kTile, 1, 1};
  CUtensorMap k_map, v_map;
  if (hopper::tensor_map_4d(&k_map, k, dims, strides, box) ||
      hopper::tensor_map_4d(&v_map, v, dims, strides, box))
    return cudaErrorInvalidValue;
  if (d == 128)
    return launch<128, K>(k_map, v_map, q, mask, out, b, kv, g, T, splits, stages, st);
  return launch<64, K>(k_map, v_map, q, mask, out, b, kv, g, T, splits, stages, st);
}

}  // namespace agk
