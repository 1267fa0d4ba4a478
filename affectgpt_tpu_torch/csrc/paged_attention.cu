// Decode attention over a paged KV cache on Hopper (sm_90a): one query token
// per row, GQA, keys and values gathered from a block pool through per-row
// block tables, online softmax in f32. Two variants of one kernel: bf16
// pools, and int8 pools with f32 per-row scales.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/paged_attention_pallas.py::
// paged_attention_pallas (`_kernel` and `_kernel_int8`).
//
// Layouts: q and out [b, H, d] bf16 (head h = kv head * g + group); pools
// [blocks, block, kv, d] with pages of any size; scales [blocks, block, kv]
// f32, read as stored; tables [b, width] int32 (padded with block 0, the null
// page); seq_lens [b] int32. Token p of row r lies in page tables[r, p /
// block] at offset p % block; one kv head's part of a page is `block` rows of
// d values, strided by kv * d.
//
// Arithmetic follows the TPU kernel: f32 scores q.k / sqrt(d), an int8
// page's key scale folded into the score and its value scale into the PV
// weight only (the softmax sum runs over the unscaled p,
// paged_attention_pallas.py:164-181), tokens at or past seq_len at p = 0, a
// row with no valid token 0 through max(sum, 1e-20), one rounding to bf16.
// The PV product takes p (times the value scale) rounded to bf16, as the
// flash prefill does.
//
// Bound: page bytes. Each valid token's K and V rows (2 * kv * d values, 2
// KiB a token per layer in bf16 at Qwen2.5-7B width, half that plus 32 bytes
// of scales in int8) are read once and used for 2 * g multiply-adds per
// value, far below the tensor-core rate. The previous design launched one
// 128-thread block per 64-token chunk of every (row, kv head), chunks past
// seq_len included, multiplied on CUDA cores with a warp reduction per token
// and query head, wrote f32 partials to HBM and merged them in a second
// launch: 17% of its bound in bf16. This one:
//   - splits from the plan (ops/paged_attention.py::paged_plan): the tokens
//     of each (row, kv head) pair are cut into C shares of whole 16-token
//     tiles (C <= 8, from b * kv and the SM count), computed here from
//     seq_len, so the work follows the tokens, not the table's width;
//   - pages by TMA: one producer warp reads the block table (64 entries a
//     load, lane-parallel, the first beside seq_len) and brings each tile's
//     K and V rows of its kv head (strided by kv * d; 128-byte swizzle; lane
//     j issues the tile's j-th page) and, for int8, the tile's scale rows by
//     cp.async.bulk, into a ring of stages on mbarriers, the whole share in
//     flight at once at the serve phase's lengths. A box holds min(block, 16)
//     rows of one page. Pages of 8 or a multiple of 16 tokens fill the tile
//     exactly; other sizes ("odd" pages) straddle its edges, so each tile
//     has 16 rows of padding on either side, a page's box lands at its own
//     row offset (the box's rows stay inside the page, and no two pages'
//     boxes overlap), and the int8 scales are read by the consumers from
//     global memory (a bulk copy needs 16-byte aligned rows);
//   - both products on mma.sync m16n8k16 (bf16 in, f32 out), the <= 8 query
//     heads of the kv head as the n8 operand: S^T = K Q^T with the tile's 16
//     tokens as the A rows (ldmatrix of the K tile; Q's fragments built once
//     from global memory), Out^T = V^T P^T with d as the A rows (transposed
//     ldmatrix of the V tile) and P^T moved from the S^T fragment into the
//     B fragment by movmatrix. Int8 pages become exact bf16 in registers
//     (mma_bf16.cuh s8_halves_to_bf16x2); for the keys the head dimension is
//     read in the order ldmatrix gives it, and Q's fragments follow it. Four
//     consumer warps take the share's tiles in turn, each with its own
//     running (max, sum, accumulator);
//   - the merge in the same launch: the warps' states meet in shared memory
//     (fixed order), then the C blocks of a pair, one cluster, meet through
//     distributed shared memory, each summing its share of the output over
//     the blocks in rank order between two rounds of the cluster barrier.
//     No f32 partials in HBM, no second launch, no atomics: two calls give
//     the same bits.
// The bf16 tiles' consumer steps and the merge are shared with the dense
// decode attention (csrc/split_attention.cuh).

#include <stdint.h>

#include "split_attention.cuh"

namespace agk {
namespace paged {

using namespace hopper;
using namespace split;

constexpr int kConsumers = 4;  // warps; one more warp issues the loads
constexpr int kThreads = 32 * (kConsumers + 1);

// Diagnostics, all true in the package (scripts/torch_paged_probe.py builds
// copies with them off; the results are then wrong). What a switched-off part
// would have consumed still reaches the output.
constexpr bool kConsume = true;   // the consumers read their stages at all
constexpr bool kProducts = true;  // the tensor-core products
constexpr bool kClusterMerge = true;  // the splits' states read through distributed shared memory

// Pages that neither divide into the 16-token tiles nor are cut by them
// into whole tiles: a tile meets them at any offset.
__host__ __device__ __forceinline__ bool odd_pages(int blk) {
  return !(blk == 8 || blk % kTile == 0);
}

// A stage: the K tile, the V tile ([boxes][pad + 16 + pad rows][128 bytes],
// 128-byte swizzle: 64 bf16 or 128 int8 head-dim values a box; pad = 16 rows
// for odd pages, else 0), then for int8 (pages not odd) the 16 tokens' key
// and value scales of every kv head. Its size is also computed by
// ops/paged_attention.py::paged_plan.
template <typename T, int D>
struct Tiles {
  static constexpr bool kInt8 = sizeof(T) == 1;
  static constexpr int kBoxes = kInt8 ? 1 : D / 64;
  __host__ __device__ static int pad_rows(int blk) { return odd_pages(blk) ? kTile : 0; }
  // one box column of a tile, with its padding
  __host__ __device__ static int box_bytes(int blk) { return (kTile + 2 * pad_rows(blk)) * 128; }
  __host__ __device__ static int kv_bytes(int blk) { return kBoxes * box_bytes(blk); }
  __host__ __device__ static int stage_bytes(int kv, int blk) {
    const int scales = kInt8 && !odd_pages(blk) ? 2 * kTile * kv * 4 : 0;
    return (2 * kv_bytes(blk) + scales + 1023) / 1024 * 1024;
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// the tile tokens [lo, hi) of split `rank` of `splits` over n valid tokens:
// whole 16-token tiles, split r taking tiles [r T / C, (r + 1) T / C)
__device__ __forceinline__ void share(int n, int rank, int splits, int& t0, int& t1) {
  const int tiles = (max(n, 0) + kTile - 1) / kTile;
  t0 = rank * tiles / splits;
  t1 = (rank + 1) * tiles / splits;
}

// Grid: one cluster of `splits` blocks per (row, kv head) pair, pair-major.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
             const __nv_bfloat16* __restrict__ q, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ tables,
             const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out, int kv, int G,
             int width, int blk, int splits, int stages) {
  using L = Tiles<T, D>;
  constexpr bool kInt8 = L::kInt8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int stage_bytes = L::stage_bytes(kv, blk);
  const bool odd = odd_pages(blk);
  const int box_bytes = L::box_bytes(blk), kv_bytes = L::kv_bytes(blk);
  const int ring_bytes = max(stages * stage_bytes, merge_bytes<kConsumers, D>());
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_bytes);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = blockIdx.x % splits, pair = blockIdx.x / splits;
  const int row = pair / kv, head = pair % kv;
  const int g = lane / 4, t = lane % 4;
  // Loaded before the first wait, so that their latencies overlap: the
  // producer's first 64 table entries (lane i: pages i and 32 + i), the
  // consumers' Q fragments (B operand of S^T = K Q^T: query head g, zero
  // past G; the head-dim pairs each k16 step takes: bf16 (2t, 2t + 1) and
  // (2t + 8, 2t + 9); int8 the order the keys' ldmatrix gives, (4t, 4t + 1)
  // and (4t + 2, 4t + 3)), and seq_len.
  const int* table = tables + (size_t)row * width;
  int e0 = 0, e1 = 0;
  uint32_t qf[D / 16][2];
  if (warp == kConsumers) {
    e0 = lane < width ? __ldg(table + lane) : 0;
    e1 = lane + 32 < width ? __ldg(table + 32 + lane) : 0;
  } else {
    const __nv_bfloat16* qr = q + ((size_t)pair * G + g) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (g >= G) {
        qf[kk][0] = qf[kk][1] = 0u;
      } else if constexpr (kInt8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(qr + 16 * kk + 4 * t));
        qf[kk][0] = v.x;
        qf[kk][1] = v.y;
      } else {
        qf[kk][0] = __ldg(reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * t));
        qf[kk][1] = __ldg(reinterpret_cast<const uint32_t*>(qr + 16 * kk + 2 * t + 8));
      }
    }
  }
  const int n = min(__ldg(seq_lens + row), width * blk);  // the valid tokens: a prefix
  int t0, t1;
  share(n, rank, splits, t0, t1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {  // producer: the warp walks the tiles, lane j issues page j
    const int box_rows = min(blk, kTile);
    const bool bulk_scales = kInt8 && !odd;
    const int pad = L::pad_rows(blk);
    int p0 = 0;  // lane i holds table[row][p0 + i] in e0, [p0 + 32 + i] in e1
    RingPos pos;
    for (int tile = t0; tile < t1; ++tile) {
      const int tok0 = tile * kTile;
      // the pages holding a valid token of the tile: at most 17
      const int first = tok0 / blk, last = (min(tok0 + kTile, n) - 1) / blk;
      if (last >= p0 + 64) {
        p0 = first;
        e0 = p0 + lane < width ? __ldg(table + p0 + lane) : 0;
        e1 = p0 + 32 + lane < width ? __ldg(table + p0 + 32 + lane) : 0;
      }
      const int p = first + lane, rel = p - p0;
      const int lo = __shfl_sync(0xffffffffu, e0, rel & 31);
      const int hi = __shfl_sync(0xffffffffu, e1, rel & 31);
      mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
      unsigned char* st = ring + pos.stage * stage_bytes;
      const uint32_t bytes = (uint32_t)(last - first + 1) *
                             (2 * L::kBoxes * box_rows * 128 +
                              (bulk_scales ? 2 * box_rows * kv * 4 : 0));
      if (lane == 0) mbar_expect_tx(&full[pos.stage], bytes);
      __syncwarp();
      if (p <= last) {
        const int page = rel < 32 ? lo : hi;
        // the page's box: its rows [o, o + box_rows), as close to the tile as
        // the page allows, at tile row dst (pad rows into the padded region)
        const int o = min(max(tok0 - p * blk, 0), blk - box_rows);
        const int dst = pad + p * blk + o - tok0;
        const int src = page * blk + o;  // its pool row
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b) {
          const int c0 = head * D + (kInt8 ? 0 : 64 * b);
          tma_load_2d(st + b * box_bytes + dst * 128, &k_map, &full[pos.stage], c0, src);
          tma_load_2d(st + kv_bytes + b * box_bytes + dst * 128, &v_map, &full[pos.stage], c0,
                      src);
        }
        if (bulk_scales) {  // pages of 8 or a multiple of 16: dst = tile row, o whole tiles
          unsigned char* sc = st + 2 * kv_bytes;
          const uint32_t rb = (uint32_t)box_rows * kv * 4;
          bulk_load(sc + dst * kv * 4, k_scale + (size_t)src * kv, rb, &full[pos.stage]);
          bulk_load(sc + (kTile + dst) * kv * 4, v_scale + (size_t)src * kv, rb,
                    &full[pos.stage]);
        }
      }
      pos.advance(stages);
    }
    return;
  }

  const float scale = 1.4426950408889634f * rsqrtf((float)D);  // log2(e) / sqrt(d): exp2 below
  // ldmatrix rows of this lane in both int8 tiles (matrices: tokens 0-7 and
  // 8-15 of one 16-byte chunk, then of the next)
  const int r_8 = (lane % 8) + 8 * ((lane / 8) % 2);
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};  // query heads 2t, 2t + 1
  float acc[D / 16][4];                              // Out^T: d rows, query-head columns
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  uint32_t sink = 0;  // kProducts off: the fragments, so that they are computed

  // warp w takes the share's tiles w, w + 4, ...: with a ring of a multiple
  // of four stages each slot always serves the same warp, so no warp waits
  // on a slot's phase more than one ahead of the one it holds
  for (int s = warp, tile = t0 + warp; tile < t1; s += kConsumers, tile += kConsumers) {
    const int slot = s % stages;
    mbar_wait(&full[slot], (uint32_t)((s / stages) & 1));
    if constexpr (!kConsume) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      continue;
    }
    // the tiles' first rows (past the padding)
    const uint32_t kt = smem_u32(ring + slot * stage_bytes) + (odd ? kTile * 128 : 0);
    const uint32_t vt = kt + kv_bytes;
    // S^T = K Q^T: two chains of products (even and odd k16 steps)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if constexpr (kInt8) {
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        uint32_t r[4];
        ldsm_x4(r, kt + r_8 * 128 + (((2 * j + lane / 16) ^ (r_8 & 7)) << 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // k16 step 2j + h: r[2h] tokens 0-7, r[2h + 1] 8-15
          const uint32_t w0 = __byte_perm(r[2 * h], 0u, 0x3120);
          const uint32_t w1 = __byte_perm(r[2 * h + 1], 0u, 0x3120);
          const uint32_t a[4] = {s8_halves_to_bf16x2(w0), s8_halves_to_bf16x2(w1),
                                 s8_halves_to_bf16x2(w0 >> 8), s8_halves_to_bf16x2(w1 >> 8)};
          if constexpr (kProducts) mma_bf16(sc[h], a, qf[2 * j + h][0], qf[2 * j + h][1]);
          else sink ^= a[0] ^ a[1] ^ a[2] ^ a[3];
        }
      }
    } else {
      scores_bf16<D, kProducts>(sc, kt, box_bytes, qf, sink);
    }
    // sc[.][e]: token g + 8 (e / 2) of the tile, query head 2t + e % 2
    const int tok = tile * kTile + g;
    const bool va = tok < n, vb = tok + 8 < n;
    float ka = 1.f, kb = 1.f, wa = 1.f, wb = 1.f;  // int8: the tokens' key and value scales
    if constexpr (kInt8) {
      if (!odd) {
        const float* sk = reinterpret_cast<const float*>(ring + slot * stage_bytes + 2 * kv_bytes);
        ka = sk[g * kv + head];
        kb = sk[(g + 8) * kv + head];
        wa = sk[(kTile + g) * kv + head];
        wb = sk[(kTile + g + 8) * kv + head];
      } else {  // odd pages: the valid tokens' scales from their pool rows
        if (va) {
          const size_t r = (size_t)__ldg(table + tok / blk) * blk + tok % blk;
          ka = __ldg(k_scale + r * kv + head);
          wa = __ldg(v_scale + r * kv + head);
        }
        if (vb) {
          const size_t r = (size_t)__ldg(table + (tok + 8) / blk) * blk + (tok + 8) % blk;
          kb = __ldg(k_scale + r * kv + head);
          wb = __ldg(v_scale + r * kv + head);
        }
      }
    }
    float x[4], p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = (sc[0][e] + sc[1][e]) * (e < 2 ? ka : kb) * scale;
      x[e] = (e < 2 ? va : vb) ? v : -INFINITY;
    }
    softmax_step<D>(x, m, l, acc, p);
    // P^T as the B fragment (k = tokens, n = query heads): the S^T fragment's
    // two 8x8 matrices (tokens 0-7, 8-15), transposed. Int8: p times the
    // value scale (0 at a masked token, whatever its stored scale).
    const uint32_t b0 = movmatrix_trans(pack_bf16x2(va ? p[0] * wa : 0.f, va ? p[1] * wa : 0.f));
    const uint32_t b1 = movmatrix_trans(pack_bf16x2(vb ? p[2] * wb : 0.f, vb ? p[3] * wb : 0.f));
    // Out^T += V^T P^T
    if constexpr (kInt8) {
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {  // two m16 tiles: head-dim bytes 32j .. 32j + 31
        uint32_t r[4];
        ldsm_x4_trans(r, vt + r_8 * 128 + (((2 * j + lane / 16) ^ (r_8 & 7)) << 4));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // r[2h]: bytes (token 2t, d 2g), (2t, 2g + 1), (2t + 1, 2g), (2t + 1, 2g + 1);
          // r[2h + 1] the same at tokens + 8. Fragment row g is d 2g, row g + 8 d 2g + 1.
          const uint32_t a[4] = {s8_halves_to_bf16x2(r[2 * h]), s8_halves_to_bf16x2(r[2 * h] >> 8),
                                 s8_halves_to_bf16x2(r[2 * h + 1]),
                                 s8_halves_to_bf16x2(r[2 * h + 1] >> 8)};
          if constexpr (kProducts) mma_bf16(acc[2 * j + h], a, b0, b1);
          else sink ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1;
        }
      }
    } else {
      uint32_t m01, m23;
      const bool partial = column_masks(tile, 0, n - 1, m01, m23);
      pv_bf16<D, false, kProducts>(acc, vt, box_bytes, partial, m01, m23, b0, b1, 0u, 0u, sink);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the stage is in registers
  }
  if constexpr (!kProducts) sink_into(acc[0][0], sink);
  float* scratch = reinterpret_cast<float*>(ring);
  __nv_bfloat16* orow = out + (size_t)pair * G * D;
  merge_warps<D, kConsumers, kInt8>(scratch, acc, m, l, G, splits, orow);
  if (splits > 1) merge_cluster<D, kConsumers, kClusterMerge>(scratch, G, splits, rank, orow);
}

template <typename T, int D>
cudaError_t launch(const CUtensorMap& k_map, const CUtensorMap& v_map, const void* q,
                   const void* k_scale, const void* v_scale, const void* tables,
                   const void* seq_lens, void* out, int b, int kv, int G, int width, int blk,
                   int splits, int stages, cudaStream_t st) {
  using L = Tiles<T, D>;
  const size_t smem = (size_t)max(stages * L::stage_bytes(kv, blk), merge_bytes<kConsumers, D>()) +
                      2 * stages * 8 + 1024;
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(paged_kernel<T, D>, smem, &granted);
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
  err = cudaLaunchKernelEx(&cfg, paged_kernel<T, D>, k_map, v_map,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                           static_cast<const int*>(tables), static_cast<const int*>(seq_lens),
                           static_cast<__nv_bfloat16*>(out), kv, G, width, blk, splits, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
        const void* v_scale, const void* tables, const void* seq_lens, void* out, int b, int kv,
        int G, int width, int blk, int d, int blocks, int splits, int stages, void* stream) {
  constexpr bool kInt8 = sizeof(T) == 1;
  if (b < 1 || kv < 1 || G < 1 || G > kHeads || width < 1 || blocks < 1 || splits < 1 ||
      splits > kMaxSplits || stages < 1 || stages % kConsumers || (d != 64 && d != 128) ||
      blk < 1)
    return (int)cudaErrorInvalidValue;
  // the pools as 2-D tensors: a row per (page, offset), kv * d values; a box
  // is min(block, 16) rows of 64 bf16 or 128 int8 values of one kv head
  const uint64_t rows = (uint64_t)blocks * blk, inner = (uint64_t)kv * d;
  const auto dtype = kInt8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint32_t box = kInt8 ? 128 : 64, box_rows = blk < kTile ? blk : kTile;
  CUtensorMap k_map, v_map;
  if (hopper::tensor_map_2d(&k_map, dtype, pool_k, inner, rows, inner * sizeof(T), box, box_rows) ||
      hopper::tensor_map_2d(&v_map, dtype, pool_v, inner, rows, inner * sizeof(T), box, box_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return (int)launch<T, 128>(k_map, v_map, q, k_scale, v_scale, tables, seq_lens, out, b, kv, G,
                               width, blk, splits, stages, st);
  return (int)launch<T, 64>(k_map, v_map, q, k_scale, v_scale, tables, seq_lens, out, b, kv, G,
                            width, blk, splits, stages, st);
}

}  // namespace paged
}  // namespace agk

// C entries. Device pointers to contiguous tensors: q, out [b, kv*g, d] bf16;
// pool_k, pool_v [blocks, blk, kv, d] bf16 (or int8, with k_scale, v_scale
// [blocks, blk, kv] f32); tables [b, width] and seq_lens [b] int32. splits
// and stages come from the wrapper's plan (ops/paged_attention.py::
// paged_plan), which checks shapes, dtypes and limits. One launch; returns
// its CUDA error, or 0.
extern "C" int agk_paged_attention_bf16(const void* q, const void* pool_k, const void* pool_v,
                                        const void* tables, const void* seq_lens, void* out, int b,
                                        int kv, int g, int width, int blk, int d, int blocks,
                                        int splits, int stages, void* stream) {
  return agk::paged::run<__nv_bfloat16>(q, pool_k, pool_v, nullptr, nullptr, tables, seq_lens,
                                        out, b, kv, g, width, blk, d, blocks, splits, stages,
                                        stream);
}

extern "C" int agk_paged_attention_int8(const void* q, const void* pool_k, const void* pool_v,
                                        const void* k_scale, const void* v_scale,
                                        const void* tables, const void* seq_lens, void* out, int b,
                                        int kv, int g, int width, int blk, int d, int blocks,
                                        int splits, int stages, void* stream) {
  return agk::paged::run<int8_t>(q, pool_k, pool_v, k_scale, v_scale, tables, seq_lens, out, b,
                                 kv, g, width, blk, d, blocks, splits, stages, stream);
}
