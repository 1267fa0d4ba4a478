// Non-causal short-sequence attention of the ViT / HuBERT encoders on Hopper
// (sm_90a), on wgmma fed by TMA; shared by vit_attention.cu (the attention
// alone) and vit_sublayer.cu (step (iii) of the whole attention sublayer).
//
// out = softmax(q k^T / sqrt(d), keys >= valid_len masked) v per (image,
// head), head_dim 64, at most 512 valid keys: row 11's attention step. Every
// shape of fused_vit_attention goes to vit_attention_flash.cu (one pass, p
// rounded before it is normalised), which took less time at CLIP's,
// ImageBind's and HuBERT's shapes (PERF.md section 6;
// scripts/torch_wgmma_variants.py's vit_resident routes them here). The TPU kernel
// (affectgpt_tpu/ops/vit_attention_pallas.py::_kernel) holds a whole score
// row on chip, normalises p, rounds p to bf16 and only then multiplies by
// v. Both designs here keep that rounding point:
// - one pass (valid_len <= 320 keys, kOnePassTiles = 5 key tiles of 64:
//   CLIP's 257 tokens, HuBERT's 99): a warpgroup keeps its 64 rows' scores
//   of every key tile in registers (up to 160 f32 a thread), so each score
//   is computed once and each exp2 taken once; then the row max and sum,
//   p = exp2(s - max) / sum rounded to bf16 as the A operand of P V;
// - two passes (up to 512 keys): the first finds each row's max and sum
//   online over the key tiles, the second recomputes the scores tile by
//   tile, normalises, rounds and multiplies by V (1.5x the products and 2x
//   the exp2 of one pass).
// launch_vit_attention picks the design.
//
// Block: two consumer warpgroups (256 threads, so ptxas may give each up
// to 255 registers: CLIP's five key tiles need 214; a 288-thread block with
// a producer warp gets 168 and spilled them), persistent. A unit is one
// (image, head): its K and V tiles come once by TMA into shared memory (a
// barrier a tile), where they stay until both warpgroups are done with the
// unit; its 64-row query tiles go to the two warpgroups in turn, and each
// warpgroup loads its Q tile into registers (ldmatrix) for S = Q K^T by RS
// wgmma. The warpgroups' leaders issue every load and never wait on one: a
// warpgroup loads its own query tiles two ahead into its two Q slots, and
// the second warpgroup done with a unit loads a later unit into the freed
// K/V buffer, so that a block keeps kv_slots(T) units in flight (two at
// CLIP's five key tiles and HuBERT's two). HuBERT's one-pass kernel needs
// 114 registers, so two blocks share an SM there. T = ceil(valid_len / 64):
// key tiles wholly at or past valid_len are never loaded, and keys at or
// past valid_len in the last tile get p = 0 exactly. Query rows at or past
// valid_len (but below n) are computed and attend to the valid keys, as on
// the TPU. q, k, v and out are addressed through element strides of their
// batch, head and token axes (head_dim contiguous): 4-D tensor maps read
// the [b, h, n, d] layout and the [b, n, h, d] layout of a fused projection
// alike, with no copy, and rows past n arrive as zeros.
//
// Bound: bytes. For CLIP ViT-L (64 images, n = 257, 16 heads) the q k^T and
// p v products are 17.3 GFLOP (0.0175 ms at 989 TFLOP/s) against 134.7 MB of
// q, k, v and out (0.0402 ms at 3.35 TB/s). The mma.sync design this
// replaces (two passes, the whole head staged by the threads before the
// first product) took 0.2362 ms. Measured (an H100 80GB HBM3 at 700 W,
// PERF.md section 6; scripts/torch_wgmma_variants.py --only
// attention): 0.112-0.119 ms at CLIP's shape (SDPA 0.183), 0.028-0.029 at
// HuBERT's; the loads alone take 0.040, the one-pass softmax about 0.035
// more and the products 0.018: they overlap only in part. One warpgroup a
// block with a ring of key tiles took 0.196 ms; the two warpgroups taking
// turns on the tensor cores changed nothing (0.1135 against 0.1134 ms).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "gemv_tile.cuh"

namespace agk {
namespace vit {

constexpr int kAttnD = 64;
constexpr int kAttnMaxN = 512;
constexpr int kOnePassTiles = 5;  // one pass up to 320 keys: 160 score registers a thread

using attn::AttnStrides;

namespace wgattn {

using namespace attn;
constexpr int kThreads = 256;  // two consumer warpgroups; their leaders issue the loads
constexpr int kTile = kTileBytes<kAttnD>;  // one 64-row tile of q, k or v
constexpr int kMaxTiles = kAttnMaxN / kKeys;

constexpr int kMaxSlots = 4;
constexpr int kHeadBytes = (4 + kMaxSlots * 2 * kMaxTiles) * 8 + kMaxSlots * 4;

// Blocks an SM: two while the one-pass kernel needs at most 128 registers
// (up to two key tiles: HuBERT's 99 tokens), so that four warpgroups hide
// each other's latencies; else one.
__host__ __device__ constexpr int blocks_per_sm(int one_pass) {
  return one_pass >= 1 && one_pass <= 2 ? 2 : 1;
}

// K/V buffers a block keeps, so that units arrive ahead of their products:
// as many as fit beside the Q slots in the block's share of the SM's 228 KB
// (1 KB of it reserved a block), at most four (two at CLIP's five key tiles
// and at HuBERT's two)
__host__ __device__ inline int kv_slots(int tiles) {
  const int one_pass = tiles <= kOnePassTiles ? tiles : 0;
  const int share = 233472 / blocks_per_sm(one_pass) - 1024;
  const int room = (share - 1024 - kHeadBytes - 4 * kTile) / (2 * tiles * kTile);
  return room < 1 ? 1 : (room > kMaxSlots ? kMaxSlots : room);
}

// The shared memory of a block holding `tiles` key tiles in kv_slots(tiles)
// K/V buffers: the barriers and a counter a buffer, then (1024-byte aligned)
// each warpgroup's two Q slots and the K/V buffers (K tiles 0 .. tiles - 1,
// then V tiles).
struct VitSmem {
  uint64_t *qfull, *kvfull;  // [2 wg][2 slots], [kMaxSlots buffers][2 kMaxTiles]
  int* done;                 // [kMaxSlots]: warpgroup releases of the buffer's units
  unsigned char* q;          // [2 wg][2 slots][tile]
  unsigned char* kv;         // [buffers][2 tiles][tile]
  int tiles;
  static size_t bytes(int tiles) {
    return 1024 + kHeadBytes + (size_t)(4 + kv_slots(tiles) * 2 * tiles) * kTile;
  }
  __device__ __forceinline__ VitSmem(unsigned char* raw, int tiles_) : tiles(tiles_) {
    qfull = reinterpret_cast<uint64_t*>(raw);
    kvfull = qfull + 4;
    done = reinterpret_cast<int*>(kvfull + kMaxSlots * 2 * kMaxTiles);
    unsigned char* after = raw + kHeadBytes;
    q = after + ((1024 - (smem_u32(after) & 1023)) & 1023);
    kv = q + 4 * kTile;
  }
  __device__ __forceinline__ unsigned char* q_tile(int wg, int slot) const {
    return q + (2 * wg + slot) * kTile;
  }
  __device__ __forceinline__ uint64_t* kv_bar(int slot, int j) const {
    return kvfull + slot * 2 * kMaxTiles + j;
  }
  __device__ __forceinline__ unsigned char* kv_tile(int slot, int j) const {
    return kv + (size_t)(slot * 2 * tiles + j) * kTile;
  }
};

// keys at or past valid_len in the tile from k0 get a score of -inf
template <int N>
__device__ __forceinline__ void mask_tail(float (&s)[N], const Frag& f, int k0, int valid_len) {
  if (k0 + kKeys <= valid_len) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + f.col(j, e) >= valid_len) s[4 * j + 2 * h + e] = -INFINITY;
}

// Grid (blocks), kThreads threads, VitSmem::bytes(tiles) of dynamic shared
// memory. Block c walks units c, c + blocks, ... (one (image, head) each)
// and deals their query tiles to its two warpgroups: tile s of the block's
// stream (unit s / q_tiles, tile s % q_tiles) goes to warpgroup s % 2.
// Loads are issued by the warpgroups' leaders, never waited on by the
// issuing thread: each warpgroup loads its own query tiles two ahead into
// its two Q slots, and the second warpgroup done with a unit loads the unit
// `slots` later into the freed K/V buffer. The K and V of a unit stay in
// shared memory until both warpgroups are done with it. ONE_PASS: the key
// tiles (1 .. kOnePassTiles) held in registers; 0: two passes over `tiles`
// key tiles.
template <int ONE_PASS>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(ONE_PASS))
vit_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out,
                     AttnStrides os, int heads, int n, int valid_len, int heads_inner, int tiles,
                     int units, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  VitSmem sm(smem_raw, tiles);
  const int slots = kv_slots(tiles);
  const int q_tiles = (n + kRows - 1) / kRows;
  const int my_units = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_units * q_tiles;  // tiles of the block's stream
  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;
  auto load_kv = [&](int i) {  // unit i of the block into buffer i % slots
    if (i >= my_units) return;
    const int u = blockIdx.x + i * gridDim.x, slot = i % slots;
    for (int j = 0; j < 2 * tiles; ++j) {
      mbar_expect_tx(sm.kv_bar(slot, j), kTile);
      load_rows(sm.kv_tile(slot, j), j < tiles ? &k_map : &v_map, sm.kv_bar(slot, j),
                heads_inner, 0, (j % tiles) * kKeys, u % heads, u / heads);
    }
  };
  auto load_q = [&](int t) {  // this warpgroup's t-th tile into its slot t % 2
    const int st = 2 * t + wg;
    if (st >= total) return;
    const int u = blockIdx.x + (st / q_tiles) * gridDim.x;
    uint64_t* bar = &sm.qfull[2 * wg + t % 2];
    mbar_expect_tx(bar, kTile);
    load_rows(sm.q_tile(wg, t % 2), &q_map, bar, heads_inner, 0, (st % q_tiles) * kRows,
              u % heads, u / heads);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&sm.qfull[i], 1);
    for (int i = 0; i < slots; ++i) {
      for (int j = 0; j < 2 * tiles; ++j) mbar_init(sm.kv_bar(i, j), 1);
      sm.done[i] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  launch_dependents();
  grid_dependency_wait();  // launched as a dependent: q, k and v are written
  if (threadIdx.x == 0)
    for (int i = 0; i < slots; ++i) load_kv(i);
  if (leader) {
    load_q(0);
    load_q(1);
  }

  const Frag f;
  const int mine = (total + 1 - wg) / 2;  // this warpgroup's tiles
  int released = 0;                       // units this warpgroup is done with
  // the warpgroup is done with units up to `upto` - 1: the second warpgroup
  // done with a unit loads its buffer's next unit
  auto release_units = [&](int upto) {
    if (released >= upto) return;
    named_barrier(1 + wg, 128);  // every warp's products are complete
    if (leader) {
      for (; released < upto; ++released) {
        const int slot = released % slots;
        if (atomicAdd(&sm.done[slot], 1) % 2 == 1) load_kv(released + slots);
      }
    }
    released = upto;
  };
  for (int t = 0; t < mine; ++t) {
    const int st = 2 * t + wg, i = st / q_tiles, qt = st % q_tiles;
    const int u = blockIdx.x + i * gridDim.x, hi = u % heads, bi = u / heads;
    release_units(i);
    const int slot = i % slots;
    const uint32_t kv_phase = (i / slots) & 1;
    mbar_wait(&sm.qfull[2 * wg + t % 2], (t / 2) & 1);
    uint32_t qf[kAttnD / 4];
    load_q_frags<kAttnD>(qf, smem_u32(sm.q_tile(wg, t % 2)));
    named_barrier(1 + wg, 128);  // the slot is read: its next tile may come
    if (leader) load_q(t + 2);
    for (int j = 0; j < tiles; ++j) mbar_wait(sm.kv_bar(slot, j), kv_phase);  // K
    float o[32];
    if constexpr (ONE_PASS > 0) {
      float s[ONE_PASS][32];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < ONE_PASS; ++j)  // S = Q K^T, every key tile
        qk_tile_rs<kAttnD>(s[j], qf, smem_u32(sm.kv_tile(slot, j)));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(qf);
#pragma unroll
      for (int j = 0; j < ONE_PASS; ++j) fence_regs(s[j]);
      mask_tail(s[ONE_PASS - 1], f, (ONE_PASS - 1) * kKeys, valid_len);
      uint32_t p[ONE_PASS][16];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // one chain a key tile, so the tiles' reductions overlap
        float part[ONE_PASS];
#pragma unroll
        for (int j = 0; j < ONE_PASS; ++j) {
          part[j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
#pragma unroll
          for (int c = 1; c < 8; ++c)
            part[j] = fmaxf(part[j], fmaxf(s[j][4 * c + 2 * h], s[j][4 * c + 2 * h + 1]));
        }
        float mx = part[0];
#pragma unroll
        for (int j = 1; j < ONE_PASS; ++j) mx = fmaxf(mx, part[j]);
        mx = quad_max(mx) * scale_log2;
#pragma unroll
        for (int j = 0; j < ONE_PASS; ++j) {
          part[j] = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[j][4 * c + 2 * h + e];
              x = fast_exp2(fmaf(x, scale_log2, -mx));
              part[j] += x;
            }
        }
        float sum = part[0];
#pragma unroll
        for (int j = 1; j < ONE_PASS; ++j) sum += part[j];
        const float inv = 1.f / quad_sum(sum);
#pragma unroll
        for (int j = 0; j < ONE_PASS; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e) s[j][4 * c + 2 * h + e] *= inv;
      }
#pragma unroll
      for (int j = 0; j < ONE_PASS; ++j) pack_p(p[j], s[j]);
      for (int j = 0; j < ONE_PASS; ++j) mbar_wait(sm.kv_bar(slot, tiles + j), kv_phase);  // V
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < ONE_PASS; ++j)  // O = P V, every key tile
        pv_tile<kAttnD>(o, p[j], smem_u32(sm.kv_tile(slot, tiles + j)), j > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < ONE_PASS; ++j) fence_regs(p[j]);
    } else {
      // pass 1: each row's max and sum (online, log2 domain)
      float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
      float s[32];
      for (int kt = 0; kt < tiles; ++kt) {
        wgmma_fence();
        qk_tile_rs<kAttnD>(s, qf, smem_u32(sm.kv_tile(slot, kt)));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mask_tail(s, f, kt * kKeys, valid_len);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = m[h];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            mx = fmaxf(mx, fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]) * scale_log2);
          mx = quad_max(mx);
          float rs = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              rs += fast_exp2(fmaf(s[4 * c + 2 * h + e], scale_log2, -mx));
          l[h] = l[h] * fast_exp2(m[h] - mx) + rs;
          m[h] = mx;
        }
      }
      for (int j = 0; j < tiles; ++j) mbar_wait(sm.kv_bar(slot, tiles + j), kv_phase);  // V
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) inv[h] = 1.f / quad_sum(l[h]);
      // pass 2: p = exp2(s - max) / sum rounded to bf16, then O += P V
      for (int kt = 0; kt < tiles; ++kt) {
        wgmma_fence();
        qk_tile_rs<kAttnD>(s, qf, smem_u32(sm.kv_tile(slot, kt)));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mask_tail(s, f, kt * kKeys, valid_len);
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[4 * c + 2 * h + e];
              x = fast_exp2(fmaf(x, scale_log2, -m[h])) * inv[h];
            }
        uint32_t p[16];
        pack_p(p, s);
        wgmma_fence();
        pv_tile<kAttnD>(o, p, smem_u32(sm.kv_tile(slot, tiles + kt)), kt > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
      }
      fence_regs(qf);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qt * kRows + f.row(h);
      if (row >= n) continue;
      __nv_bfloat16* op = out + (size_t)bi * os.b + (size_t)hi * os.h + (size_t)row * os.n;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + f.col(j, 0)) =
            __floats2bfloat162_rn(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
  release_units(my_units);
}

template <int ONE_PASS>
static cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map,
                          const CUtensorMap& v_map, __nv_bfloat16* out, AttnStrides os, int b,
                          int heads, int n, int valid_len, int heads_inner, int tiles,
                          bool dependent, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = VitSmem::bytes(tiles);
  cudaError_t err = ensure_smem(vit_attention_kernel<ONE_PASS>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int units = b * heads;
  const float scale_log2 = kLog2e / sqrtf((float)kAttnD);
  const int most = blocks_per_sm(ONE_PASS) * sm_count();
  const int blocks = units < most ? units : most;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {programmatic_launch()};
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, vit_attention_kernel<ONE_PASS>, q_map, k_map, v_map, out, os,
                           heads, n, valid_len, heads_inner, tiles, units, scale_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wgattn

// q, k, v share the element strides `in`; out has its own. Needs 1 <=
// valid_len <= n and valid_len <= kAttnMaxN, all strides multiples of 8 and 16-byte
// aligned pointers (the tensor maps' rules). dependent: q, k and v are
// written by the launch just before on the stream, which calls
// launch_dependents; the grid is launched as its programmatic dependent.
static inline cudaError_t launch_vit_attention(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                               const __nv_bfloat16* v, __nv_bfloat16* out,
                                               int b, int heads, int n, int valid_len,
                                               AttnStrides in, AttnStrides os,
                                               cudaStream_t stream, bool dependent = false) {
  using namespace wgattn;
  if (n < 1 || valid_len < 1 || valid_len > n || valid_len > kAttnMaxN)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  int inner = 0;
  if (head_rows_map(&q_map, q, kAttnD, b, heads, n, in.b, in.h, in.n, &inner) ||
      head_rows_map(&k_map, k, kAttnD, b, heads, n, in.b, in.h, in.n, &inner) ||
      head_rows_map(&v_map, v, kAttnD, b, heads, n, in.b, in.h, in.n, &inner))
    return cudaErrorInvalidValue;
  const int tiles = (valid_len + kKeys - 1) / kKeys;
  switch (tiles) {
    case 1:
      return launch<1>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, inner, 1,
                       dependent, stream);
    case 2:
      return launch<2>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, inner, 2,
                       dependent, stream);
    case 3:
      return launch<3>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, inner, 3,
                       dependent, stream);
    case 4:
      return launch<4>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, inner, 4,
                       dependent, stream);
    case 5:
      return launch<5>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, inner, 5,
                       dependent, stream);
    default:
      return launch<0>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, inner, tiles,
                       dependent, stream);
  }
}

}  // namespace vit
}  // namespace agk
