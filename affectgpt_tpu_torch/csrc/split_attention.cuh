// What the two decode attention kernels that split a (row, kv head) pair's
// tokens over a cluster of blocks share: the paged one
// (csrc/paged_attention.cu) and the dense one
// (csrc/dense_decode_attention.cuh). Each block's consumer warps take 16-token
// tiles of K and V from a ring in shared memory and run both products on
// mma.sync m16n8k16 (bf16 in, f32 out), the <= 8 query heads of the kv head as
// the n8 operand; then the warps' states, and the cluster's blocks' states,
// meet in the same launch.
//
// Fragments (lane = 4g + t): S^T = K Q^T is sc[.][e], token g + 8 (e / 2) of
// the tile and query head 2t + e % 2; Out^T = V^T P^T is acc[D / 16][4],
// acc[i][e] query head 2t + e % 2 at head-dim 16i + g + 8 (e / 2) (bf16 V
// tiles), or 16i + 2g + e / 2 (int8 V tiles: the order their ldmatrix gives).
// K and V tiles: D / 64 boxes (box_bytes apart) of 16 rows of 128 bytes,
// 128-byte swizzle. Scores are in the base-2 domain (exp2).
#pragma once

#include <stdint.h>

#include "gemv_tile.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace split {

using namespace hopper;

constexpr int kTile = 16;      // tokens a stage: S^T's m16 rows, PV's k16
constexpr int kHeads = 8;      // query heads of a kv head: the n8 operand
constexpr int kMaxSplits = 8;  // blocks of a pair's cluster

// The merge's scratch, over the drained ring: each of the CONSUMERS warps'
// accumulator [kHeads][D] and max and sum [2][kHeads]; then the block's.
// Also computed by the plans (ops/paged_attention.py, ops/decode_attention.py).
template <int CONSUMERS, int D>
__host__ __device__ constexpr int merge_bytes() {
  return (CONSUMERS + 1) * (kHeads * D + 2 * kHeads) * 4;
}

// S^T += K Q^T over a bf16 K tile at shared address kt, qf the B fragments
// of Q (query head g; head-dim pairs (2t, 2t + 1), (2t + 8, 2t + 9) of each
// k16 step): two chains of products, even and odd k16 steps. PRODUCTS =
// false folds the fragments into `sink` instead (a probe's diagnostic).
template <int D, bool PRODUCTS = true>
__device__ __forceinline__ void scores_bf16(float (&sc)[2][4], uint32_t kt, int box_bytes,
                                            const uint32_t (&qf)[D / 16][2], uint32_t& sink) {
  const int lane = threadIdx.x % 32, r = lane % 16;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, kt + (kk / 4) * box_bytes + r * 128 + (((2 * (kk % 4) + lane / 16) ^ (r & 7)) << 4));
    if constexpr (PRODUCTS) mma_bf16(sc[kk % 2], a, qf[kk][0], qf[kk][1]);
    else sink ^= a[0] ^ a[1] ^ a[2] ^ a[3];
  }
}

// The online softmax over one tile: x the scores (-inf at a masked token).
// Updates the running max m and sum l of query heads 2t, 2t + 1 (l over this
// lane's tokens; merge_warps sums it over the lanes), rescales acc, and gives
// the tile's weights p (0 at a masked token).
template <int D>
__device__ __forceinline__ void softmax_step(const float (&x)[4], float (&m)[2], float (&l)[2],
                                             float (&acc)[D / 16][4], float (&p)[4]) {
  // the tile's maxima of query heads 2t, 2t + 1 over its 16 tokens
  float mx[2] = {fmaxf(x[0], x[2]), fmaxf(x[1], x[3])};
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
    mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
  }
  float alpha[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float mn = fmaxf(m[c], mx[c]);
    alpha[c] = exp2f(m[c] - mn);
    m[c] = mn;
    p[c] = exp2f(x[c] - mn);
    p[c + 2] = exp2f(x[c + 2] - mn);
    l[c] = l[c] * alpha[c] + p[c] + p[c + 2];
  }
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    acc[i][0] *= alpha[0];
    acc[i][1] *= alpha[1];
    acc[i][2] *= alpha[0];
    acc[i][3] *= alpha[1];
  }
}

// A token outside the valid columns [lo, hi] may hold anything in the cache
// (a pad, another row's stale page, a column not yet written): its V
// fragment halves are zeroed, not only its p. m01 keeps this lane's tokens
// 2t, 2t + 1 of the tile, m23 tokens 2t + 8, 2t + 9; returns whether the tile
// has a token outside at all.
__device__ __forceinline__ bool column_masks(int tile, int lo, int hi, uint32_t& m01,
                                             uint32_t& m23) {
  const int c = tile * kTile + 2 * (threadIdx.x % 4);
  auto in = [&](int col) { return col >= lo && col <= hi; };
  m01 = (in(c) ? 0xFFFFu : 0u) | (in(c + 1) ? 0xFFFF0000u : 0u);
  m23 = (in(c + 8) ? 0xFFFFu : 0u) | (in(c + 9) ? 0xFFFF0000u : 0u);
  return tile * kTile < lo || tile * kTile + kTile - 1 > hi;
}

// column_masks for any set of valid tokens of a tile: bits, bit i for token i.
__device__ __forceinline__ void token_masks(uint32_t bits, uint32_t& m01, uint32_t& m23) {
  const int c = 2 * (threadIdx.x % 4);
  m01 = ((bits >> c) & 1u ? 0xFFFFu : 0u) | ((bits >> (c + 1)) & 1u ? 0xFFFF0000u : 0u);
  m23 = ((bits >> (c + 8)) & 1u ? 0xFFFFu : 0u) | ((bits >> (c + 9)) & 1u ? 0xFFFF0000u : 0u);
}

// Out^T += V^T P^T over a bf16 V tile at shared address vt, read transposed
// by ldmatrix (d as the A rows); (b0, b1) the B fragment of P^T, the S^T
// fragment's two 8x8 matrices moved by movmatrix. SPLIT_P: a second product
// on (c0, c1), the low bf16 part of p. `partial`: the fragments masked by
// (m01, m23) from column_masks.
template <int D, bool SPLIT_P, bool PRODUCTS = true>
__device__ __forceinline__ void pv_bf16(float (&acc)[D / 16][4], uint32_t vt, int box_bytes,
                                        bool partial, uint32_t m01, uint32_t m23, uint32_t b0,
                                        uint32_t b1, uint32_t c0, uint32_t c1, uint32_t& sink) {
  const int lane = threadIdx.x % 32, r = (lane % 8) + 8 * (lane / 16);
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    uint32_t a[4];
    ldsm_x4_trans(a, vt + (i / 4) * box_bytes + r * 128 +
                         (((2 * (i % 4) + (lane / 8) % 2) ^ (r & 7)) << 4));
    if (partial) {
      a[0] &= m01;
      a[1] &= m01;
      a[2] &= m23;
      a[3] &= m23;
    }
    if constexpr (PRODUCTS) {
      mma_bf16(acc[i], a, b0, b1);
      if constexpr (SPLIT_P) mma_bf16(acc[i], a, c0, c1);
    } else {
      sink ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1;
    }
  }
}

// After the consumer warps' last tile (called by all CONSUMERS of them): l
// summed over the lanes, then the warps' states meet over the drained ring at
// `scratch` (merge_bytes), summed in warp order. With one split the block
// writes the pair's output orow [G][D] = acc / max(sum, 1e-20) rounded to
// bf16; else it leaves its state there for merge_cluster. INT8_ORDER: acc
// in the int8 V tiles' head-dim order.
template <int D, int CONSUMERS, bool INT8_ORDER = false>
__device__ __forceinline__ void merge_warps(float* scratch, const float (&acc)[D / 16][4],
                                            const float (&m)[2], float (&l)[2], int G,
                                            int splits, __nv_bfloat16* orow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) l[c] += __shfl_xor_sync(0xffffffffu, l[c], off);
  float* part = scratch;                         // [warp][kHeads][D]
  float* wml = part + CONSUMERS * kHeads * D;    // [warp][max, sum][kHeads]
  float* bo = wml + CONSUMERS * 2 * kHeads;      // the block's [kHeads][D]
  float* bml = bo + kHeads * D;                  // and its [max, sum][kHeads]
  named_barrier(1, 32 * CONSUMERS);  // every consumer is past its last stage
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 16 * i + (INT8_ORDER ? 2 * g + e / 2 : g + 8 * (e / 2));
      part[(warp * kHeads + 2 * t + e % 2) * D + d] = acc[i][e];
    }
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      wml[(warp * 2) * kHeads + 2 * t + c] = m[c];
      wml[(warp * 2 + 1) * kHeads + 2 * t + c] = l[c];
    }
  }
  named_barrier(1, 32 * CONSUMERS);
  for (int idx = threadIdx.x; idx < G * D; idx += 32 * CONSUMERS) {
    const int h = idx / D, d = idx % D;
    float mm = -1e30f;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) mm = fmaxf(mm, wml[w * 2 * kHeads + h]);
    float o = 0.f, ls = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMERS; ++w) {  // warp order: a fixed sum
      const float f = exp2f(wml[w * 2 * kHeads + h] - mm);
      o += part[(w * kHeads + h) * D + d] * f;
      ls += wml[(w * 2 + 1) * kHeads + h] * f;
    }
    if (splits == 1) {
      orow[idx] = __float2bfloat16(o / fmaxf(ls, 1e-20f));
    } else {
      bo[idx] = o;
      if (d == 0) {
        bml[h] = mm;
        bml[kHeads + h] = ls;
      }
    }
  }
}

// The cluster's block states (merge_warps at splits > 1) meet: block `rank`
// writes its share of the output's G * D / 4 quads, each summed over the
// blocks in rank order, every remote load issued before the first sum; the
// second round of the cluster barrier keeps every block resident until all
// have read its state. No atomics: two calls give the same bits. CLUSTER =
// false reads the block's own state `splits` times (a probe's diagnostic).
template <int D, int CONSUMERS, bool CLUSTER = true>
__device__ __forceinline__ void merge_cluster(float* scratch, int G, int splits, int rank,
                                              __nv_bfloat16* orow) {
  const float* bo = scratch + CONSUMERS * (kHeads * D + 2 * kHeads);
  const float* bml = bo + kHeads * D;
  if constexpr (CLUSTER) {
    cluster_arrive_release();  // (1)
    cluster_wait();
  } else {
    named_barrier(1, 32 * CONSUMERS);
  }
  const int quads = G * D / 4;
  const int qd = rank * quads / splits + threadIdx.x;
  const bool mine = qd < (rank + 1) * quads / splits;  // at most quads / 2 a block: one pass
  float4 o4[kMaxSplits];
  float ms[kMaxSplits], ls[kMaxSplits];
  const int h = 4 * qd / D;
  if (mine) {
    const uint32_t ao = smem_u32(bo + 4 * qd), am = smem_u32(bml + h);
    const uint32_t al = smem_u32(bml + kHeads + h);
#pragma unroll
    for (int src = 0; src < kMaxSplits; ++src)
      if (src < splits) {
        const uint32_t from = CLUSTER ? src : rank;
        o4[src] = ld_cluster_f32x4(map_to_rank(ao, from));
        ms[src] = ld_cluster_f32(map_to_rank(am, from));
        ls[src] = ld_cluster_f32(map_to_rank(al, from));
      }
  }
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float inv = 0.f;
  if (mine) {
    float mm = -1e30f;
#pragma unroll
    for (int src = 0; src < kMaxSplits; ++src)
      if (src < splits) mm = fmaxf(mm, ms[src]);
    float total = 0.f;
#pragma unroll
    for (int src = 0; src < kMaxSplits; ++src)
      if (src < splits) {
        const float f = exp2f(ms[src] - mm);
        o.x += o4[src].x * f;
        o.y += o4[src].y * f;
        o.z += o4[src].z * f;
        o.w += o4[src].w * f;
        total += ls[src] * f;
      }
    inv = 1.f / fmaxf(total, 1e-20f);
  }
  if constexpr (CLUSTER) cluster_arrive_relaxed();  // (2) the reads have returned
  if (mine)
    *reinterpret_cast<uint2*>(orow + 4 * qd) =
        make_uint2(pack_bf16x2(o.x * inv, o.y * inv), pack_bf16x2(o.z * inv, o.w * inv));
  if constexpr (CLUSTER) cluster_wait();
}

}  // namespace split
}  // namespace agk
