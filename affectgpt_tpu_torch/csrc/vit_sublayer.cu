// Whole pre-LN attention sublayer of CLIP ViT-L/14 and HuBERT-large on Hopper
// (sm_90a): y = x + o_proj(attention(LN(x))).
//
// Replaces affectgpt_tpu/ops/vit_sublayer_pallas.py::attn_sublayer (its
// pallas_call, :105; `_kernel` :34). Rounding points are the TPU kernel's:
// LN in f32 rounded to bf16; q, k, v = bf16(h W + b) with f32 sums; the
// attention of vit_attention.cuh (p normalized, then rounded to bf16; PV in
// f32, rounded once; heads concatenated); y = bf16(o W_o + b_o + x) with one
// rounding.
//
// Bound: operations. CLIP, one layer, 64 images of 257 tokens: 155.3 GFLOP
// (four 1024 x 1024 products of 16448 rows plus the attention) against 75 MB,
// 0.157 ms at 989 TFLOP/s; HuBERT (64 clips of 99 frames) 55.7 GFLOP.
// Design: the TPU kept all four 1024^2 weights (8 MB) resident in VMEM and
// ran one image per grid step. 8 MB does not fit a Hopper block's 227 KB of
// shared memory, but it does sit in the 50 MB L2, so the sublayer runs over
// all b * n rows at once as four launches on one stream, every product on
// the persistent wgmma + TMA GEMM of vit_gemm_wgmma.cuh (the encoder MLP's;
// its plan ops/vit_gemm.py::gemm_plan):
//   (i)   LayerNorm of x into bf16 rows h (a row pass: h is rounded to bf16
//         before the products either way, so the numbers are the same);
//   (ii)  q, k and v in one persistent launch of three products over the
//         rows h: a unit is (product, column tile, the cluster's row tiles),
//         column tiles fastest, so the blocks in flight share a few row
//         tiles of h in the L2; each product has its own weight map (no
//         concatenated copy), the epilogue adds the bias and writes [rows,
//         w], which is the [b, n, heads, d] layout the attention reads;
//   (iii) the attention of vit_attention.cuh (wgmma fed by TMA, one pass
//         up to 320 keys) on q, k, v through their strides, writing the
//         heads side by side;
//   (iv)  the o product with the bias + residual epilogue (fc2's).
// (ii)-(iv) are launched as programmatic dependents of the launch before
// them: each one's barrier setup, tensor-map fetch and first weight stages
// overlap the end of the launch before, which counts most at HuBERT's
// shape, where every launch is short. n (257, 99) is no multiple of any
// tile: TMA zero-fills the GEMMs' ragged row tail and their epilogues do
// not store it, the attention's tensor maps zero-fill rows past n and it
// masks its key tail.

#include <string.h>

#include "vit_attention.cuh"
#include "vit_gemm_wgmma.cuh"

namespace {

// The products' launch plan (ops/vit_sublayer.py attn_sublayer_plan): row
// tiles, each product's column tiles, the q/k/v and o grids, the cluster.
struct Plan {
  int m_tiles, n_tiles, qkv_blocks, o_blocks, cluster;
};

}  // namespace

// C entry. Device pointers to contiguous bf16 tensors: x, y [b, n, w]; the
// LN scale and bias [w]; wq, wk, wv, wo [w, w] and their biases [w]; the
// scratch h, q, k, v, attn [b, n, w] the wrapper allocates; plan holds the
// five ints of Plan. The wrapper in affectgpt_tpu_torch/ops/vit_sublayer.py
// checks shapes and limits (w / heads == 64, w % 32 == 0, w <= 2048, n <=
// 512). Returns the first CUDA error of the four launches.
extern "C" int agk_vit_attn_sublayer_bf16(const void* x, const void* ln_scale,
                                          const void* ln_bias, const void* wq, const void* bq,
                                          const void* wk, const void* bk, const void* wv,
                                          const void* bv, const void* wo, const void* bo,
                                          void* h, void* q, void* k, void* v, void* attn, void* y,
                                          const void* plan, int b, int n, int w, int heads,
                                          int valid_len, float eps, void* stream) {
  using namespace agk::vit;
  using bf = __nv_bfloat16;
  if (w != heads * kAttnD || w % 32 || w > 32 * 8 * kLnMaxVec || n < 1 || n > kAttnMaxN ||
      valid_len < 1 || valid_len > n)
    return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(p));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n;
  const bf* xp = static_cast<const bf*>(x);
  bf* hp = static_cast<bf*>(h);
  cudaError_t err = wg::launch_layernorm_rows(xp, static_cast<const bf*>(ln_scale),
                                              static_cast<const bf*>(ln_bias), hp, rows, w, eps,
                                              st);
  if (err != cudaSuccess) return (int)err;
  const wg::Operand qkv[3] = {
      {static_cast<const bf*>(wq), static_cast<const bf*>(bq), static_cast<bf*>(q)},
      {static_cast<const bf*>(wk), static_cast<const bf*>(bk), static_cast<bf*>(k)},
      {static_cast<const bf*>(wv), static_cast<const bf*>(bv), static_cast<bf*>(v)}};
  err = wg::launch_products<kActNone, false, true>(hp, qkv, 3, nullptr, rows, w, w, p.n_tiles,
                                                   p.m_tiles, p.qkv_blocks, p.cluster, true, st);
  if (err != cudaSuccess) return (int)err;
  const AttnStrides bnhd{(long long)n * w, kAttnD, w};  // [b, n, h, d]
  err = launch_vit_attention(static_cast<const bf*>(q), static_cast<const bf*>(k),
                             static_cast<const bf*>(v), static_cast<bf*>(attn), b, heads, n,
                             valid_len, bnhd, bnhd, st, true);
  if (err != cudaSuccess) return (int)err;
  const wg::Operand o{static_cast<const bf*>(wo), static_cast<const bf*>(bo), static_cast<bf*>(y)};
  return (int)wg::launch_products<kActNone, true, true>(static_cast<const bf*>(attn), &o, 1, xp,
                                                        rows, w, w, p.n_tiles, p.m_tiles,
                                                        p.o_blocks, p.cluster, true, st);
}
