// The encoders' non-causal attention beyond what vit_attention.cuh holds in
// shared memory: any head_dim d with d % 8 == 0 and 32 <= d <= 128, any
// number of tokens. DINOv2-large at 518 px has 1370 tokens (head_dim 64),
// SigLIP so400m 729 tokens at head_dim 72; a unit's K and V no longer fit
// in shared memory there (350 KB at 1370 x 64), so this design streams them.
//
// The function is vit_attention.cuh's, with its rounding points: f32
// scores, p = exp(s - max) / sum normalised and only then rounded to bf16,
// P V summed in f32 and rounded once. A flash-style kernel would round the
// unnormalised p and compute another function in bf16, so this one makes
// two passes over the keys: the first finds each row's max and sum
// (online, in the log2 domain, as vit_attention.cuh's two-pass kernel
// does), the second recomputes the scores tile by tile, normalises them,
// rounds them and multiplies by V.
//
// Work item: 128 query rows (two 64-row tiles, one a warpgroup) of one
// (image, head). A block (two consumer warpgroups, 256 threads, one block
// an SM, persistent) walks items c, c + blocks, ...; both warpgroups read
// the same stream of key tiles, three a key tile an item (pass 1: K; pass
// 2: K then V), through a ring of kStages TMA stages. A warpgroup releases
// a stage once its products on it are complete; the second warpgroup to
// release it issues the load of the stream position kStages later into it,
// so no thread ever waits to issue a load and no producer warp takes
// registers from the consumers. Q tiles come two items ahead into each
// warpgroup's two slots, as in vit_attention.cuh.
//
// Head dimensions other than 64: the tensor maps' innermost extent is d
// itself, read in 64-value boxes, so the columns of a box past d (72..127 at
// d = 72, the next head's values in memory) arrive as zeros. The products
// run on D = d rounded up to 16 (the bf16 wgmma K step): S = Q K^T takes D
// / 16 steps, whose columns past d add zeros, and P V runs at N = D, a
// legal wgmma N, read as an MN-major B operand over the ceil(D / 64) boxes.
// The softmax scale is 1 / sqrt(d), and the store writes d columns.
//
// Bound at DINOv2's shape (32 images, 16 heads, n = 1370, d = 64): the two
// products are 246 GFLOP (0.249 ms at 989 TFLOP/s) against 359 MB of q, k,
// v and out (0.107 ms at 3.35 TB/s): operations. This design computes Q K^T
// twice (1.5x the products) and takes exp2 twice a score.
#pragma once

#include "vit_attention.cuh"

namespace agk {
namespace vit {
namespace stream {

using namespace attn;
constexpr int kThreads = 256;
constexpr int kStages = 8;
constexpr int kHeadBytes = 256;  // the barriers and counters, before the tiles

template <int D>
constexpr int kBoxes = (D + 63) / 64;
template <int D>
constexpr int kTile = kTileBytes<D>;

// dynamic shared memory of a block: 1024 bytes of alignment slack, the
// header, then the four Q slots and the ring's stages
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + kHeadBytes + (size_t)(4 + kStages) * kTile<D>;
}

// Grid (blocks), kThreads threads, smem_bytes<D>() of dynamic shared memory.
// Items: (image, head) units times `pairs` pairs of 64-row query tiles,
// unit-major. D: the head dimension rounded up to 16; d: the head dimension.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
vit_attention_stream_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            __nv_bfloat16* __restrict__ out, AttnStrides os, int heads, int n,
                            int valid_len, int d, int heads_inner, int tiles, int pairs,
                            int items, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem_raw);  // [2 wg][2 slots]
  uint64_t* full = qfull + 4;                               // [kStages]
  int* done = reinterpret_cast<int*>(full + kStages);        // [kStages]: releases
  unsigned char* after = smem_raw + kHeadBytes;
  unsigned char* q_slots = after + ((1024 - (smem_u32(after) & 1023)) & 1023);
  unsigned char* ring = q_slots + 4 * kTile<D>;

  const int my_items = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int per_item = 3 * tiles;  // stream positions of an item
  const int total = my_items * per_item;
  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;

  // (head, image, pair of query tiles) of the block's i-th item
  auto coords = [&](int i, int& hi, int& bi, int& pair) {
    const int item = blockIdx.x + i * gridDim.x, u = item / pairs;
    pair = item % pairs;
    hi = u % heads;
    bi = u / heads;
  };
  // stream position g into stage g % kStages: K tile p (pass 1), then K and
  // V of tile j in turn (pass 2)
  auto load = [&](int g) {
    if (g >= total) return;
    const int p = g % per_item, r = p - tiles;
    int hi, bi, pair;
    coords(g / per_item, hi, bi, pair);
    const CUtensorMap* map = r >= 0 && r % 2 == 1 ? &v_map : &k_map;
    const int j = r < 0 ? p : r / 2;
    uint64_t* bar = &full[g % kStages];
    unsigned char* dst = ring + (g % kStages) * kTile<D>;
    mbar_expect_tx(bar, kTile<D>);
#pragma unroll
    for (int x = 0; x < kBoxes<D>; ++x)
      load_rows(dst + x * kBox, map, bar, heads_inner, 64 * x, j * kKeys, hi, bi);
  };
  // this warpgroup's query tile of item i into its slot i % 2
  auto load_q = [&](int i) {
    if (i >= my_items) return;
    int hi, bi, pair;
    coords(i, hi, bi, pair);
    uint64_t* bar = &qfull[2 * wg + i % 2];
    unsigned char* dst = q_slots + (2 * wg + i % 2) * kTile<D>;
    mbar_expect_tx(bar, kTile<D>);
#pragma unroll
    for (int x = 0; x < kBoxes<D>; ++x)
      load_rows(dst + x * kBox, &q_map, bar, heads_inner, 64 * x, (2 * pair + wg) * kRows, hi,
                bi);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&qfull[i], 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      done[s] = 0;
    }
    mbar_fence_init();
  }
  __syncthreads();
  launch_dependents();
  grid_dependency_wait();  // launched as a dependent: q, k and v are written
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) load(s);
  if (leader) {
    load_q(0);
    load_q(1);
  }

  // the warpgroup's products on position g are complete: the second
  // warpgroup to say so loads position g + kStages into the stage
  auto release = [&](int g) {
    named_barrier(1 + wg, 128);
    if (leader && atomicAdd(&done[g % kStages], 1) % 2 == 1) load(g + kStages);
  };
  auto stage = [&](int g) {
    mbar_wait(&full[g % kStages], (g / kStages) & 1);
    return smem_u32(ring + (g % kStages) * kTile<D>);
  };

  const Frag f;
  int g = 0;  // the block's stream position
  for (int i = 0; i < my_items; ++i) {
    int hi, bi, pair;
    coords(i, hi, bi, pair);
    const int qt = 2 * pair + wg;
    mbar_wait(&qfull[2 * wg + i % 2], (i / 2) & 1);
    uint32_t qf[D / 4];
    load_q_frags<D>(qf, smem_u32(q_slots + (2 * wg + i % 2) * kTile<D>));
    named_barrier(1 + wg, 128);  // the slot is read: its next tile may come
    if (leader) load_q(i + 2);

    // pass 1: each row's max and sum (online, log2 domain)
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    float s[32];
    for (int kt = 0; kt < tiles; ++kt, ++g) {
      const uint32_t k = stage(g);
      wgmma_fence();
      qk_tile_rs<D>(s, qf, k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(g);
      wgattn::mask_tail(s, f, kt * kKeys, valid_len);
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
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = 1.f / quad_sum(l[h]);

    // pass 2: p = exp2(s - max) / sum rounded to bf16, then O += P V
    float o[D / 2];
    for (int kt = 0; kt < tiles; ++kt) {
      const uint32_t k = stage(g);
      wgmma_fence();
      qk_tile_rs<D>(s, qf, k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(g++);
      wgattn::mask_tail(s, f, kt * kKeys, valid_len);
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
      const uint32_t v = stage(g);
      wgmma_fence();
      pv_tile<D>(o, p, v, kt > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(g++);
    }
    fence_regs(qf);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qt * kRows + f.row(h);
      if (row >= n) continue;
      __nv_bfloat16* op = out + (size_t)bi * os.b + (size_t)hi * os.h + (size_t)row * os.n;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < d)  // d % 8 == 0: a pair is wholly inside or outside
          *reinterpret_cast<__nv_bfloat162*>(op + f.col(j, 0)) =
              __floats2bfloat162_rn(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
    }
  }
}

template <int D>
static cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map,
                          const CUtensorMap& v_map, __nv_bfloat16* out, AttnStrides os, int b,
                          int heads, int n, int valid_len, int d, int heads_inner,
                          bool dependent, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = ensure_smem(vit_attention_stream_kernel<D>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int tiles = (valid_len + kKeys - 1) / kKeys;
  const int pairs = ((n + kRows - 1) / kRows + 1) / 2;
  const long long items = (long long)b * heads * pairs;
  if (items > 0x7fffffff / (3 * tiles)) return cudaErrorInvalidValue;  // stream positions
  const float scale_log2 = kLog2e / sqrtf((float)d);
  const int blocks = items < sm_count() ? (int)items : sm_count();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1] = {programmatic_launch()};
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, vit_attention_stream_kernel<D>, q_map, k_map, v_map, out, os,
                           heads, n, valid_len, d, heads_inner, tiles, pairs, (int)items,
                           scale_log2);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace stream

// The streaming kernel at head_dim d (d % 8 == 0, 32 <= d <= 128; 1 <=
// valid_len <= n). q, k, v share the element strides `in`; out has its own
// (all multiples of 8, pointers 16-byte aligned).
static inline cudaError_t launch_vit_attention_stream(const __nv_bfloat16* q,
                                                      const __nv_bfloat16* k,
                                                      const __nv_bfloat16* v, __nv_bfloat16* out,
                                                      int b, int heads, int n, int valid_len,
                                                      int d, AttnStrides in, AttnStrides os,
                                                      cudaStream_t stream,
                                                      bool dependent = false) {
  if (d % 8 || d < 32 || d > 128 || n < 1 || valid_len < 1 || valid_len > n)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  int inner = 0;
  if (attn::head_rows_map(&q_map, q, d, b, heads, n, in.b, in.h, in.n, &inner) ||
      attn::head_rows_map(&k_map, k, d, b, heads, n, in.b, in.h, in.n, &inner) ||
      attn::head_rows_map(&v_map, v, d, b, heads, n, in.b, in.h, in.n, &inner))
    return cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
    case 2:
      return stream::launch<32>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                dependent, stream);
    case 3:
      return stream::launch<48>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                dependent, stream);
    case 4:
      return stream::launch<64>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                dependent, stream);
    case 5:
      return stream::launch<80>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                dependent, stream);
    case 6:
      return stream::launch<96>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                dependent, stream);
    case 7:
      return stream::launch<112>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                 dependent, stream);
    default:
      return stream::launch<128>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                 dependent, stream);
  }
}

}  // namespace vit
}  // namespace agk
