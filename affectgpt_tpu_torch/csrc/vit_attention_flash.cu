// The encoders' non-causal attention on Hopper (sm_90a) at every shape:
// any head_dim d with d % 8 == 0 and 32 <= d <= 128, any number of tokens n
// and any 1 <= valid_len <= n. DINOv2-large at 518 px has 1370 tokens
// (head_dim 64), SigLIP so400m 729 at head_dim 72, VideoMAE 1568 tubes; a
// unit's K and V do not fit in shared memory there (350 KB at 1370 x 64),
// so they stream. At the shapes where they would fit (CLIP's 257 tokens,
// ImageBind's 229, HuBERT's 99) this design took less time than the
// resident ones of vit_attention.cuh too.
//
// Replaces affectgpt_tpu/ops/vit_attention_pallas.py::fused_vit_attention
// (its pallas_call, :79); vit_attention.cu's C entry routes here. One pass over the keys: S = Q K^T, an online softmax in the log2
// domain with each row's running max and sum in f32, P = exp2(s - max)
// rounded to bf16 before it is normalised (the register A operand of O += P
// V), and the f32 O divided by the row sum once at the end and rounded
// once. This is a deliberate departure from the TPU kernel, which
// normalises p first and then rounds it: both round p in [0, 1] to bf16,
// so the error has the same size, and SDPA rounds where this kernel does.
// ops/vit_attention.py::fused_vit_attention_reference keeps the TPU
// kernel's rounding points and is the oracle on the card.
//
// Bound at DINOv2's shape (32 images, 16 heads, n = 1370, d = 64): the two
// products are 246 GFLOP (0.249 ms at 989 TFLOP/s) against 359 MB of q, k, v
// and out (0.107 ms at 3.35 TB/s): operations. The special-function unit is
// a second roof: it takes about 3.9e12 exp2 a second (16 a clock on each of
// 132 SMs), so the 0.96e9 scores need about 0.25 ms of exp2, as long as the
// products. The design keeps the tensor cores and the exp unit busy at once:
// - Warp specialisation: a block is two or three consumer warpgroups of 64
//   query rows each (Cfg) and one producer warpgroup, whose single thread
//   issues every TMA load (Q of a work tile, then K and V of each key tile
//   into two rings of kStages stages) and which gives its registers to the
//   consumers (setmaxnreg). Persistent blocks, one an SM, walk the work
//   tiles (image, head, block of kBlockRows query rows) c, c + blocks, ...;
//   the query blocks of one (image, head) are neighbours, so its K and V
//   come from the L2 after the first.
// - Within a warpgroup the products of key tile j + 1 (S = Q K^T, Q in
//   registers) and of tile j (O += P V) are issued together, and the
//   softmax of tile j + 1 runs while P V of tile j is in flight.
// - Between warpgroups (ping-pong): a named barrier a warpgroup hands the
//   turn to issue products from one warpgroup to the next, so one
//   warpgroup's softmax runs under the others' products.
// - Key tiles of 128 keys (S as m64n128: 64 f32 a thread, P 32, O D/2, Q
//   D/4) with two warpgroups; of 64 with three (160 registers a thread).
//   Only the last key tile, the one that holds valid_len, is masked; key
//   tiles wholly past valid_len are never loaded. Query rows at or past n
//   are computed and not stored.
// Measured (PERF.md section 6, an H100 80GB HBM3 at 700 W, one call of
// scripts/torch_wgmma_variants.py --only attention): 0.5837 and 0.6128 ms at
// DINOv2's shape against SDPA's 0.6335 and 0.6350; without its products and
// exp2 the kernel still takes 0.3639 ms there: K and V reach shared memory
// from the L2 at about 5.6 TB/s, which bounds it next.
// Head dims other than 64: the products run at D = d rounded up to 16 (the
// bf16 wgmma K step). The tensor maps' innermost extent is d itself, read in
// 64-value boxes, so the columns of a box past d arrive as zeros: S = Q K^T
// takes D / 16 steps whose columns past d add zeros, and P V runs at N = D,
// read as an MN-major B operand over the ceil(D / 64) boxes. The softmax
// scale is 1 / sqrt(d), and the store writes d columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
#include "gemv_tile.cuh"

namespace agk {
namespace vit {

using attn::AttnStrides;

namespace flash {

using namespace attn;

// The launch shape of a head-dim class (scripts/torch_wgmma_variants.py
// records the sweep): consumer warpgroups of 64 query rows each, and keys of
// a key tile. At D = 80 and 96 (SigLIP's 72) three warpgroups on 64-key
// tiles, whose 192 query rows a block read each K and V tile for, took 28%
// less time than two on 128-key tiles (0.2332 against 0.3248 ms at
// SigLIP's shape); at every other D two on 128 (DINOv2's 64: 0.5982 against
// 0.6783 on 64-key tiles and 0.6390 with three warpgroups on 64).
constexpr int kConsumers = 2;
constexpr int kBN = 128;
constexpr int kWideConsumers = 3;
constexpr int kWideBN = 64;
template <int D>
struct Cfg {
  static constexpr bool kWide = D == 80 || D == 96;
  static constexpr int kConsumers = kWide ? kWideConsumers : flash::kConsumers;
  static constexpr int kBN = kWide ? kWideBN : flash::kBN;
  static constexpr int kThreads = 128 * (kConsumers + 1);  // and the producer warpgroup
  static constexpr int kBlockRows = 64 * kConsumers;       // query rows of a work tile
  // registers a thread after setmaxnreg: 128 (24 + 2 x 240) or 128 (32 + 3 x
  // 160) of the SM's 65536
  static constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
  static constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
};
constexpr bool kPingPong = true;  // warpgroups take turns to issue their products
constexpr int kHeadBytes = 256;     // the barriers, before the tiles
constexpr int kSmemLimit = 232448;  // shared memory a block may use
// the diagnostic builds of scripts/torch_wgmma_variants.py turn these off
constexpr bool kProducts = true;  // the tensor-core products
constexpr bool kExp = true;       // exp2 in the softmax

template <int D>
constexpr int kBoxes = (D + 63) / 64;  // 64-value boxes of a row
template <int D>
constexpr int kQTile = kBoxes<D> * kBox;  // a warpgroup's 64 query rows
template <int D>
constexpr int kKVTile = kBoxes<D> * Cfg<D>::kBN * 128;  // a key tile of K or V: [box][kBN rows]
// stages of each of the K and V rings: as many as fit, at most 4 (3 at D =
// 112 and 128, else 4)
template <int D>
constexpr int kRoom = (kSmemLimit - 1024 - kHeadBytes - Cfg<D>::kConsumers * kQTile<D>) /
                      (2 * kKVTile<D>);
template <int D>
constexpr int kStages = kRoom<D> > 4 ? 4 : kRoom<D>;
// dynamic shared memory of a block: 1024 bytes of alignment slack, the
// barriers, then the Q tiles and the two rings (ops/vit_attention.py
// computes the same)
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + kHeadBytes + (size_t)Cfg<D>::kConsumers * kQTile<D> +
         2ull * kStages<D> * kKVTile<D>;
}

// S = Q K^T for the warpgroup's 64 rows and a BN-key tile: Q from
// registers (load_q_frags), K the K-major B operand, [box][BN rows] from
// shared address k. The caller fences before and commits after.
template <int D, int BN>
__device__ __forceinline__ void qk(float (&s)[BN / 2], const uint32_t (&qf)[D / 4], uint32_t k) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    if constexpr (kProducts)
      wgmma_bf16_rs(s, qf[4 * ks], qf[4 * ks + 1], qf[4 * ks + 2], qf[4 * ks + 3],
                    desc_sw128(k + (ks / 4) * (BN * 128) + 32 * (ks % 4), 16, 1024), ks > 0);
    else
      sink_into(s[ks], qf[4 * ks] ^ qf[4 * ks + 1] ^ qf[4 * ks + 2] ^ qf[4 * ks + 3]);
  }
}

// O += P V for a BN-key tile: p the packed bf16 A operand (p[4k .. 4k + 3]
// keys 16k .. 16k + 15), V the MN-major B operand, [box][BN rows] from
// shared address v (64-wide boxes BN * 128 bytes apart). The caller fences
// before, commits after, and keeps p unchanged until the products complete.
template <int D, int BN>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&p)[BN / 4], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if constexpr (kProducts)
      wgmma_bf16_rs_tb(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                       desc_sw128_mn(v + 2048 * kk, BN * 128), 1);
    else
      sink_into(o[kk % (D / 2)], p[4 * kk] ^ p[4 * kk + 1] ^ p[4 * kk + 2] ^ p[4 * kk + 3]);
  }
}

// keys at or past valid_len in the key tile from k0 get a score of -inf
template <int BN>
__device__ __forceinline__ void mask_keys(float (&s)[BN / 2], const Frag& f, int k0,
                                          int valid_len) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + f.col(j, e) >= valid_len) s[4 * j + 2 * h + e] = -INFINITY;
}

// The online softmax of one key tile's scores: each of the thread's two
// rows' new max m (log2 domain, the scores times scale_log2), p = exp2(s *
// scale_log2 - m) in place of s, the thread's part of the row sum l, and
// alpha = exp2(m_old - m), the factor the earlier sum and O take.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx[2] = {s[2 * h], s[2 * h + 1]};
#pragma unroll
    for (int j = 1; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) mx[e] = fmaxf(mx[e], s[4 * j + 2 * h + e]);
    const float mn = fmaxf(m[h], quad_max(fmaxf(mx[0], mx[1])) * scale_log2);
    alpha[h] = fast_exp2(m[h] - mn);
    m[h] = mn;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        const float y = fmaf(x, scale_log2, -mn);
        x = kExp ? fast_exp2(y) : y;
        rs[e] += x;
      }
    l[h] = l[h] * alpha[h] + (rs[0] + rs[1]);
  }
}

// Grid (blocks), Cfg<D>::kThreads threads, smem_bytes<D>() of dynamic shared
// memory. Work tile w: (image, head) unit w / q_blocks, query rows
// kBlockRows (w % q_blocks) .. + kBlockRows - 1; block c takes w = c, c +
// blocks, .... tiles: key tiles of kBN holding the valid_len valid keys. D:
// the head dimension rounded up to 16; d: the head dimension.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
vit_attention_flash_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ out, AttnStrides os, int heads, int n,
                           int valid_len, int d, int heads_inner, int tiles, int q_blocks,
                           int work, float scale_log2) {
  constexpr int S = kStages<D>, kConsumers = Cfg<D>::kConsumers, kBN = Cfg<D>::kBN;
  constexpr int kBlockRows = Cfg<D>::kBlockRows;
  extern __shared__ unsigned char smem_raw[];
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qfull + 2;  // [S]
  uint64_t* kempty = kfull + S;
  uint64_t* vfull = kempty + S;
  uint64_t* vempty = vfull + S;
  unsigned char* after = smem_raw + kHeadBytes;
  unsigned char* q_smem = after + ((1024 - (smem_u32(after) & 1023)) & 1023);
  unsigned char* k_ring = q_smem + kConsumers * kQTile<D>;
  unsigned char* v_ring = k_ring + S * kKVTile<D>;
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * kConsumers);  // lane 0 of each consumer warp
    for (int s = 0; s < S; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4 * kConsumers);
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {  // the producer warpgroup: one thread loads
    setmaxnreg_dec<Cfg<D>::kProducerRegs>();
    if (threadIdx.x != 128 * kConsumers) return;
    RingPos kpos, vpos;
    uint32_t qphase = 0;
    // key tile j of (hi, bi) into the ring's next stage, once it is free
    auto load_tile = [&](unsigned char* ring, uint64_t* full, uint64_t* empty, RingPos& pos,
                         const CUtensorMap* map, int j, int hi, int bi) {
      mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
      mbar_expect_tx(&full[pos.stage], kKVTile<D>);
      unsigned char* dst = ring + pos.stage * kKVTile<D>;
#pragma unroll
      for (int c = 0; c < kBoxes<D>; ++c)
#pragma unroll
        for (int r = 0; r < kBN / 64; ++r)
          load_rows(dst + c * (kBN * 128) + r * kBox, map, &full[pos.stage], heads_inner, 64 * c,
                    j * kBN + 64 * r, hi, bi);
      pos.advance(S);
    };
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const int u = w / q_blocks, qb = w % q_blocks, hi = u % heads, bi = u / heads;
      mbar_wait(qempty, qphase ^ 1u);  // every warp has its Q fragments of the last tile
      qphase ^= 1u;
      mbar_expect_tx(qfull, kConsumers * kQTile<D>);
#pragma unroll
      for (int g = 0; g < kConsumers; ++g)
#pragma unroll
        for (int c = 0; c < kBoxes<D>; ++c)
          load_rows(q_smem + g * kQTile<D> + c * kBox, &q_map, qfull, heads_inner, 64 * c,
                    qb * kBlockRows + 64 * g, hi, bi);
      for (int j = 0; j < tiles; ++j) {
        load_tile(k_ring, kfull, kempty, kpos, &k_map, j, hi, bi);
        load_tile(v_ring, vfull, vempty, vpos, &v_map, j, hi, bi);
      }
    }
    return;
  }

  setmaxnreg_inc<Cfg<D>::kConsumerRegs>();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int next = (wg + 1) % kConsumers;
  const Frag f;
  const bool masked = tiles * kBN > valid_len;  // the last key tile holds masked keys
  auto release = [&](uint64_t* bar) {
    if (lane == 0) mbar_arrive(bar);
  };
  // ping-pong: named barrier 1 + w completes when warpgroup w syncs on it and
  // the warpgroup before it has arrived, i.e. has issued its products
  auto my_turn = [&]() {
    if constexpr (kPingPong) named_barrier(1 + wg, 256);
  };
  auto pass_turn = [&]() {
    if constexpr (kPingPong) named_barrier_arrive(1 + next, 256);
  };
  if (kPingPong && wg == kConsumers - 1) named_barrier_arrive(1, 256);  // warpgroup 0 first
  RingPos kpos, vpos;
  uint32_t qphase = 0;
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const int u = w / q_blocks, qb = w % q_blocks, hi = u % heads, bi = u / heads;
    mbar_wait(qfull, qphase);
    qphase ^= 1u;
    uint32_t qf[D / 4];
    load_q_frags<D>(qf, smem_u32(q_smem + wg * kQTile<D>));
    __syncwarp();
    release(qempty);

    float o[D / 2], s[kBN / 2], m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t p[kBN / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // the O of the rows so far takes the factor of the last softmax
    auto rescale = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * j + 2 * h] *= alpha[h];
          o[4 * j + 2 * h + 1] *= alpha[h];
        }
    };
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < kBN / 4; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
    };

    // key tile 0: S alone
    mbar_wait(&kfull[kpos.stage], kpos.phase);
    my_turn();
    wgmma_fence();
    qk<D, kBN>(s, qf, smem_u32(k_ring + kpos.stage * kKVTile<D>));
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(s);
    release(&kempty[kpos.stage]);
    kpos.advance(S);
    if (tiles == 1 && masked) mask_keys<kBN>(s, f, 0, valid_len);
    online_softmax<kBN>(s, m, l, alpha, scale_log2);
    pack();
    // key tile j: S_j and P_{j-1} V_{j-1} issued together; the softmax of S_j
    // runs while P V is in flight
    for (int j = 1; j < tiles; ++j) {
      mbar_wait(&kfull[kpos.stage], kpos.phase);
      mbar_wait(&vfull[vpos.stage], vpos.phase);
      rescale();
      my_turn();
      wgmma_fence();
      qk<D, kBN>(s, qf, smem_u32(k_ring + kpos.stage * kKVTile<D>));
      wgmma_commit();
      pv<D, kBN>(o, p, smem_u32(v_ring + vpos.stage * kKVTile<D>));
      wgmma_commit();
      pass_turn();
      wgmma_wait<1>();
      fence_regs(s);
      release(&kempty[kpos.stage]);
      kpos.advance(S);
      if (j == tiles - 1 && masked) mask_keys<kBN>(s, f, j * kBN, valid_len);
      online_softmax<kBN>(s, m, l, alpha, scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      release(&vempty[vpos.stage]);
      vpos.advance(S);
      pack();
    }
    // the last P V
    mbar_wait(&vfull[vpos.stage], vpos.phase);
    rescale();
    my_turn();
    wgmma_fence();
    pv<D, kBN>(o, p, smem_u32(v_ring + vpos.stage * kKVTile<D>));
    wgmma_commit();
    pass_turn();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    fence_regs(qf);
    release(&vempty[vpos.stage]);
    vpos.advance(S);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / quad_sum(l[h]);
      const int row = qb * kBlockRows + 64 * wg + f.row(h);
      if (row >= n) continue;
      __nv_bfloat16* op = out + (size_t)bi * os.b + (size_t)hi * os.h + (size_t)row * os.n;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (8 * j < d)  // d % 8 == 0: a pair is wholly inside or outside
          *reinterpret_cast<__nv_bfloat162*>(op + f.col(j, 0)) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  }
  if (kPingPong && wg == 0) named_barrier(1, 256);  // the last warpgroup's last hand-over
}

template <int D>
static cudaError_t launch(const CUtensorMap& q_map, const CUtensorMap& k_map,
                          const CUtensorMap& v_map, __nv_bfloat16* out, AttnStrides os, int b,
                          int heads, int n, int valid_len, int d, int heads_inner,
                          cudaStream_t stream) {
  constexpr int kBN = Cfg<D>::kBN, kBlockRows = Cfg<D>::kBlockRows;
  static size_t granted = 48 * 1024;
  constexpr size_t smem = smem_bytes<D>();
  static_assert(smem <= (size_t)kSmemLimit, "shared memory of a block");
  cudaError_t err = ensure_smem(vit_attention_flash_kernel<D>, smem, &granted);
  if (err != cudaSuccess) return err;
  const int tiles = (valid_len + kBN - 1) / kBN;
  const int q_blocks = (n + kBlockRows - 1) / kBlockRows;
  const long long work = (long long)b * heads * q_blocks;
  if (work > 0x7fffffff) return cudaErrorInvalidValue;
  const int blocks = work < sm_count() ? (int)work : sm_count();
  const float scale_log2 = kLog2e / sqrtf((float)d);
  vit_attention_flash_kernel<D><<<blocks, Cfg<D>::kThreads, smem, stream>>>(
      q_map, k_map, v_map, out, os, heads, n, valid_len, d, heads_inner, tiles, q_blocks,
      (int)work, scale_log2);
  return cudaGetLastError();
}

}  // namespace flash

// The one-pass streaming kernel at head_dim d (d % 8 == 0, 32 <= d <= 128;
// 1 <= valid_len <= n). q, k, v share the element strides `in`; out has its
// own (all multiples of 8, pointers 16-byte aligned). Declared in
// vit_attention.cu.
cudaError_t launch_vit_attention_flash(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, __nv_bfloat16* out, int b,
                                       int heads, int n, int valid_len, int d, AttnStrides in,
                                       AttnStrides os, cudaStream_t stream) {
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
      return flash::launch<32>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                               stream);
    case 3:
      return flash::launch<48>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                               stream);
    case 4:
      return flash::launch<64>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                               stream);
    case 5:
      return flash::launch<80>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                               stream);
    case 6:
      return flash::launch<96>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                               stream);
    case 7:
      return flash::launch<112>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                stream);
    default:
      return flash::launch<128>(q_map, k_map, v_map, out, os, b, heads, n, valid_len, d, inner,
                                stream);
  }
}

}  // namespace vit
}  // namespace agk
