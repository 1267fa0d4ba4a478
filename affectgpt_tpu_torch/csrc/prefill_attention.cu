// Causal prefill attention with segment ids and GQA on Hopper (sm_90a),
// on wgmma fed by TMA.
//
// Replaces models/qwen2.py::_flash_prefill_attention of the JAX package,
// which calls JAX's stock TPU flash-attention Pallas op
// (jax.experimental.pallas.ops.tpu.flash_attention) after repeating K/V
// `groups` times so that q and kv head counts match.
//
// Bound: operations. Per layer at b = 8, t = 564, Qwen2.5-7B width (28 q
// heads, 4 kv heads, d = 128) the visible pairs' QK^T and PV are ~18 GFLOP,
// 0.0185 ms at 989 TFLOP/s, against ~74 MB of q/k/v/out (0.0221 ms at 3.35
// TB/s). The mma.sync design this replaces ran at about 76 TFLOP/s: one
// stage of K/V staged by the threads, no overlap of loads and products,
// the mask tested on every element of every tile, each q head of a group
// streaming the same K/V.
//
// Design (attention_wgmma.cuh's products; 288 threads: two consumer
// warpgroups and one producer warp; persistent blocks, one an SM):
// - A unit is (row b, kv head, 64-row query tile, pair of q heads of the
//   kv head's group): the two warpgroups take the pair's two heads, so each
//   K/V tile brought into shared memory serves both (with 7 heads a group
//   the fourth pair has one; its second warpgroup idles). The four pairs of
//   one (row, kv head) run on neighbouring SMs at once and read its K/V (289
//   KB at t = 564) from the L2, four times: with the consumers idle, the
//   loads alone run at about the L2's rate (0.055 ms at b = 8). The four
//   pairs as a cluster of four CTAs sharing each stage by multicast made the
//   kernel 20% slower (a stage then waits for the slowest of four CTAs).
// - Units go heaviest first: query tiles from the last (which sees the
//   most key tiles under the causal mask) to the first; block i takes
//   units i, i + blocks, ... (ops/prefill_attention.py::prefill_plan).
// - Tile classes, from each 64-row tile's least and greatest segment id
//   (a first launch writes them, [b, tiles] int2, and the ids again in rows
//   of whole tiles): a (query tile, key tile) pair is skip when no key of it
//   can be visible (all keys past the tile's last row, or disjoint id
//   ranges), full when every key is visible to every row (all keys below
//   the first row and one id throughout), else masked. The producer warp
//   classifies 32 key tiles at once (one read a lane, the next unit's read
//   while this unit's loads run) and its lane 0 loads the K/V of full and
//   masked tiles only, by TMA into a ring of four stages, each tagged with
//   its tile and class; a masked tile's 64 segment ids come with it by a
//   bulk copy. Only masked tiles pay for the per-element test (key <= row,
//   key < t, equal ids). A last stage without data tags the unit's end.
// - Per stage a warpgroup runs S = Q K^T (SS wgmma), the online softmax in
//   f32 (log2 domain, ex2.approx), P rounded to bf16 unnormalised as the A
//   operand of O += P V (RS wgmma on the V tile as it lies), as the TPU
//   flash op and the previous kernel do; O is divided by the row sum and
//   rounded to bf16 once. Every row < t sees at least itself, so no
//   denominator is 0.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6;
// scripts/torch_wgmma_variants.py --only attention): 0.088-0.091 ms at b =
// 8, t = 564 (SDPA 0.168), 190-200 TFLOP/s. Without its products the
// kernel takes about 0.07 ms, so the ring's loads, the softmax and the
// barriers, not the tensor cores, set its time. Slower, and taken out:
// the two warpgroups taking turns on the tensor cores (FlashAttention-3's
// ping-pong, 18%), the pipeline inside a warpgroup (the next stage's S = Q
// K^T issued before this stage's P V, the next softmax under it; 11%: a
// warpgroup then holds two of the four stages).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "attention_wgmma.cuh"
#include "gemv_tile.cuh"

namespace agk {
namespace prefill {

using namespace attn;

constexpr int kStages = 4;  // K/V stages
constexpr int kThreads = 288;  // two consumer warpgroups and the producer warp

// The shared memory of a block: the Q ring (two slots, each both
// warpgroups' 64-row tiles of one unit) and the K/V ring (a stage holds a
// key tile's K, then its V), 1024-byte aligned, then the barriers, each
// segment ids of a masked stage's 64 keys and each stage's tag (key tile |
// class << 16, or -1 for a unit's end).
template <int D>
struct Smem {
  static constexpr int kTile = kTileBytes<D>;
  static constexpr int kQSlot = 2 * kTile;
  static constexpr size_t kBytes = 1024 + 2 * kQSlot + (size_t)kStages * 2 * kTile +
                                   (2 * kStages + 4) * 8 + kStages * kKeys * 4 + kStages * 4;
  unsigned char* q;
  unsigned char* ring;
  uint64_t *full, *empty, *qfull, *qempty;
  int* segk;  // [kStages][kKeys], 16-byte aligned for the bulk copy
  int* info;
  __device__ __forceinline__ explicit Smem(unsigned char* raw) {
    q = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
    ring = q + 2 * kQSlot;
    full = reinterpret_cast<uint64_t*>(ring + (size_t)kStages * 2 * kTile);
    empty = full + kStages;
    qfull = empty + kStages;
    qempty = qfull + 2;
    segk = reinterpret_cast<int*>(qempty + 2);
    info = segk + kStages * kKeys;
  }
  __device__ __forceinline__ uint32_t q_tile(int slot, int wg) const {
    return smem_u32(q + slot * kQSlot + wg * kTile);
  }
  __device__ __forceinline__ uint32_t stage(int st) const {
    return smem_u32(ring + (size_t)st * 2 * kTile);
  }
  // thread 0, then __syncthreads
  __device__ __forceinline__ void init() {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // lane 0 of each consumer warp
    }
    for (int st = 0; st < 2; ++st) {
      mbar_init(&qfull[st], 1);
      mbar_init(&qempty[st], 8);
    }
    mbar_fence_init();
  }
};
constexpr int kSkip = 0, kFull = 1, kMasked = 2;

// a consumer warp's release of a ring stage or Q slot
__device__ __forceinline__ void release(uint64_t* bar) {
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// least and greatest segment id of each 64-row tile, and the ids copied
// into rows of tiles * 64 (segp, zeros past t), so that a tile's 64 ids are
// one aligned 256-byte block: one warp a tile
__global__ void segment_tile_range(const int* __restrict__ seg, int* __restrict__ segp,
                                   int2* __restrict__ range, int b, int t, int tiles) {
  const int tile = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  if (tile >= b * tiles) return;
  const int lane = threadIdx.x % 32, bi = tile / tiles, r0 = (tile % tiles) * kKeys;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane + 32 * i;
    const int s = r < t ? seg[(size_t)bi * t + r] : 0;
    segp[(size_t)bi * tiles * kKeys + r] = s;
    if (r < t) {
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) range[tile] = make_int2(lo, hi);
}

// the class of (query tile qt, key tile kt <= qt), as prefill_plan computes it
__device__ __forceinline__ int tile_class(int qt, int kt, int2 qr, int2 kr, int t) {
  if (kr.y < qr.x || kr.x > qr.y) return kSkip;
  const bool one_id = qr.x == qr.y && kr.x == kr.y && qr.x == kr.x;
  return kt < qt && (kt + 1) * kKeys <= t && one_id ? kFull : kMasked;
}

struct Unit {
  int qt, bi, kvh, pair;
};

// unit u of the walk: heaviest query tiles first, then rows, kv heads and
// pairs of q heads
__device__ __forceinline__ Unit unit_at(int u, int b, int kv, int pairs, int q_tiles) {
  const int per_tile = b * kv * pairs;
  const int r = u % per_tile;
  return Unit{q_tiles - 1 - u / per_tile, r / (pairs * kv), (r / pairs) % kv, r % pairs};
}

// Grid (blocks), kThreads threads, Smem<D>::kBytes of dynamic shared memory.
// q map over [b, t, heads, D] as (head, row), k/v maps over [b, kv, t, D];
// range the per-tile segment-id ranges; out [b, t, heads * D].
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
prefill_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map, const int* __restrict__ segp,
               const int2* __restrict__ range, __nv_bfloat16* __restrict__ out, int b, int t,
               int heads, int kv, int pairs, int q_tiles, int units, int q_inner, int kv_inner,
               float scale_log2) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  S sm(smem_raw);
  if (threadIdx.x == 0) sm.init();
  __syncthreads();
  const int groups = heads / kv;
  constexpr int kTile = kTileBytes<D>;

  if (threadIdx.x >= 256) {  // the producer warp: classifies 32 key tiles at once, lane 0 loads
    const int lane = threadIdx.x % 32;
    RingPos pos, qpos;  // lane 0's
    int2 qr_next, kr_next;  // the next unit's query tile range, lane's key tile range
    auto fetch = [&](int u) {
      const Unit nx = unit_at(u, b, kv, pairs, q_tiles);
      const int last = (min(t, (nx.qt + 1) * kRows) - 1) / kKeys;
      qr_next = range[nx.bi * q_tiles + nx.qt];
      kr_next = range[nx.bi * q_tiles + min(lane, last)];
    };
    if ((int)blockIdx.x < units) fetch(blockIdx.x);
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit un = unit_at(u, b, kv, pairs, q_tiles);
      if (lane == 0) {
        const int h0 = 2 * un.pair, live = min(2, groups - h0);
        mbar_wait(&sm.qempty[qpos.stage], qpos.phase ^ 1u);
        mbar_expect_tx(&sm.qfull[qpos.stage], live * kTile);
        for (int w = 0; w < live; ++w)
#pragma unroll
          for (int c = 0; c < D / 64; ++c)
            load_rows(sm.q + qpos.stage * S::kQSlot + w * kTile + c * kBox, &q_map,
                      &sm.qfull[qpos.stage], q_inner, 64 * c, un.qt * kRows,
                      un.kvh * groups + h0 + w, un.bi);
      }
      qpos.advance(2);
      const int2 qr = qr_next, kr0 = kr_next;
      if (u + (int)gridDim.x < units) fetch(u + gridDim.x);  // read under this unit's loads
      const int last = (min(t, (un.qt + 1) * kRows) - 1) / kKeys;
      for (int base = 0; base <= last; base += 32) {
        const int mine = base + lane;
        const int2 kr = base == 0 ? kr0 : range[un.bi * q_tiles + min(mine, last)];
        const int cls = mine <= last ? tile_class(un.qt, mine, qr, kr, t) : kSkip;
        uint32_t live = __ballot_sync(0xffffffffu, cls != kSkip);
        const uint32_t masked = __ballot_sync(0xffffffffu, cls == kMasked);
        while (lane == 0 && live) {
          const int i = __ffs(live) - 1, kt = base + i;
          const bool mask = masked >> i & 1u;
          live &= live - 1;
          mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
          sm.info[pos.stage] = kt | (mask ? kMasked : kFull) << 16;
          mbar_expect_tx(&sm.full[pos.stage], 2 * kTile + (mask ? kKeys * 4 : 0));
          unsigned char* st = sm.ring + (size_t)pos.stage * 2 * kTile;
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            load_rows(st + c * kBox, &k_map, &sm.full[pos.stage], kv_inner, 64 * c, kt * kKeys,
                      un.kvh, un.bi);
            load_rows(st + kTile + c * kBox, &v_map, &sm.full[pos.stage], kv_inner, 64 * c,
                      kt * kKeys, un.kvh, un.bi);
          }
          if (mask)  // the keys' segment ids, for the consumers' test
            bulk_load(sm.segk + pos.stage * kKeys, segp + ((size_t)un.bi * q_tiles + kt) * kKeys,
                      kKeys * 4, &sm.full[pos.stage]);
          pos.advance(kStages);
        }
        __syncwarp();
      }
      if (lane == 0) {  // the unit's end: a stage without data
        mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
        sm.info[pos.stage] = -1;
        mbar_arrive(&sm.full[pos.stage]);
        pos.advance(kStages);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const Frag f;
  const size_t out_row = (size_t)heads * D;
  RingPos pos, qpos;
  int qseg_next[2];  // the next unit's segment ids of this thread's two rows
  auto fetch_qseg = [&](int u) {
    const Unit nx = unit_at(u, b, kv, pairs, q_tiles);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      qseg_next[h] = segp[((size_t)nx.bi * q_tiles + nx.qt) * kRows + f.row(h)];
  };
  if ((int)blockIdx.x < units) fetch_qseg(blockIdx.x);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_at(u, b, kv, pairs, q_tiles);
    const bool live = 2 * un.pair + wg < groups;
    const int hq = un.kvh * groups + 2 * un.pair + wg;
    const int q0 = un.qt * kRows;
    int rows[2], qseg[2];
    float m[2], l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h] = q0 + f.row(h);
      qseg[h] = qseg_next[h];
      m[h] = -1e30f;
      l[h] = 0.f;
    }
    if (u + (int)gridDim.x < units) fetch_qseg(u + gridDim.x);  // read under this unit's work
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // the online softmax of one stage's S: its mask where the stage is
    // masked, the new row maxima, p = exp2(s - max) in s, the row sums, and
    // alpha, the factor the earlier sums and O take
    auto softmax = [&](float (&s)[32], int info, int stage, float (&alpha)[2]) {
      const int k0 = (info & 0xffff) * kKeys;
      if (info >> 16 == kMasked) {  // key <= row, key < t, one segment id
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + f.col(j, e);
            const int ks = sm.segk[stage * kKeys + f.col(j, e)];
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (key > rows[h] || key >= t || ks != qseg[h]) s[4 * j + 2 * h + e] = -INFINITY;
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]) * scale_log2);
        mx = quad_max(mx);
        alpha[h] = fast_exp2(m[h] - mx);
        m[h] = mx;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = fast_exp2(fmaf(s[4 * j + 2 * h + e], scale_log2, -mx));
            s[4 * j + 2 * h + e] = p;
            rs += p;
          }
        l[h] = l[h] * alpha[h] + rs;
      }
    };
    mbar_wait(&sm.qfull[qpos.stage], qpos.phase);
    const uint32_t qa = sm.q_tile(qpos.stage, wg);
    while (true) {
      mbar_wait(&sm.full[pos.stage], pos.phase);
      const int info = sm.info[pos.stage];
      if (info < 0) {  // the unit's end
        release(&sm.empty[pos.stage]);
        pos.advance(kStages);
        break;
      }
      if (live) {
        const uint32_t ka = sm.stage(pos.stage);
        float s[32], alpha[2];
        wgmma_fence();
        qk_tile<D>(s, qa, ka);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        softmax(s, info, pos.stage, alpha);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            o[4 * j + 2 * h] *= alpha[h];
            o[4 * j + 2 * h + 1] *= alpha[h];
          }
        uint32_t p[16];
        pack_p(p, s);
        wgmma_fence();
        pv_tile<D>(o, p, ka + kTile, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
      }
      release(&sm.empty[pos.stage]);
      pos.advance(kStages);
    }
    release(&sm.qempty[qpos.stage]);  // every product of the unit read its Q
    qpos.advance(2);
    if (!live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lh = quad_sum(l[h]);
      if (rows[h] >= t) continue;
      const float inv = 1.f / lh;
      __nv_bfloat16* op = out + ((size_t)un.bi * t + rows[h]) * out_row + (size_t)hq * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + f.col(j, 0)) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
}

template <int D>
static cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                          const int* seg, int* segp, int2* range, __nv_bfloat16* out, int b,
                          int t, int heads, int kv, cudaStream_t stream) {
  using S = Smem<D>;
  const int q_tiles = (t + kRows - 1) / kRows, pairs = (heads / kv + 1) / 2;
  const int units = b * kv * q_tiles * pairs;
  CUtensorMap q_map, k_map, v_map;
  const long long hd = (long long)heads * D;
  int q_inner, kv_inner;
  // q [b, t, heads, D] as (b, head, row); k, v [b, kv, t, D]
  if (head_rows_map(&q_map, q, D, b, heads, t, (long long)t * hd, D, hd, &q_inner) ||
      head_rows_map(&k_map, k, D, b, kv, t, (long long)kv * t * D, (long long)t * D, D,
                    &kv_inner) ||
      head_rows_map(&v_map, v, D, b, kv, t, (long long)kv * t * D, (long long)t * D, D,
                    &kv_inner))
    return cudaErrorInvalidValue;
  segment_tile_range<<<(b * q_tiles * 32 + 127) / 128, 128, 0, stream>>>(seg, segp, range, b, t,
                                                                           q_tiles);
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(prefill_kernel<D>, S::kBytes, &granted);
  if (err != cudaSuccess) return err;
  const float scale_log2 = kLog2e / sqrtf((float)D);
  const int blocks = units < sm_count() ? units : sm_count();
  prefill_kernel<D><<<blocks, kThreads, S::kBytes, stream>>>(
      q_map, k_map, v_map, segp, range, out, b, t, heads, kv, pairs, q_tiles, units, q_inner,
      kv_inner, scale_log2);
  return cudaGetLastError();
}

}  // namespace prefill
}  // namespace agk

// C entry. Device pointers to contiguous tensors: q [b, t, heads, d],
// k, v [b, kv, t, d] and out [b, t, heads * d] bf16; seg [b, t] int32;
// scratch: segp, b * 64 ceil(t / 64) int32 (16-byte aligned), and range,
// b * ceil(t / 64) int2. The wrapper in
// affectgpt_tpu_torch/ops/prefill_attention.py checks shapes, dtypes and
// limits (d is 64 or 128, heads % kv == 0). Returns the first CUDA error of
// the two launches.
extern "C" int agk_prefill_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* seg, void* segp, void* range, void* out,
                                          int b, int t, int heads, int kv, int d,
                                          void* stream) {
  using namespace agk::prefill;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* sp = static_cast<const int*>(seg);
  auto* pp = static_cast<int*>(segp);
  auto* rp = static_cast<int2*>(range);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || t < 1 || kv < 1 || heads % kv || reinterpret_cast<uintptr_t>(segp) % 16)
    return (int)cudaErrorInvalidValue;
  if (d == 128) return (int)launch<128>(qp, kp, vp, sp, pp, rp, op, b, t, heads, kv, st);
  if (d == 64) return (int)launch<64>(qp, kp, vp, sp, pp, rp, op, b, t, heads, kv, st);
  return (int)cudaErrorInvalidValue;
}
