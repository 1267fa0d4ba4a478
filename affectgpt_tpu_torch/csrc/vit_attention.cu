// Fused non-causal ViT attention on Hopper (sm_90a), on wgmma fed by TMA.
//
// Replaces affectgpt_tpu/ops/vit_attention_pallas.py::fused_vit_attention
// (its pallas_call, :79), which the JAX package reaches through
// mha_fused (CLIP_ATTN="flash") and through nn.mha for unmasked
// self-attention of at least 192 tokens. The kernel, its bound and its two
// designs (one pass up to 320 keys, two passes beyond) are in
// vit_attention.cuh; it reads q, k and v through 4-D tensor maps over their
// strides, so the [b, h, n, d] layout of fused_vit_attention and the
// [b, n, h, d] layout of fused_self_attention both go in without a copy
// (JAX's two transposes and its pad of n to 8 are TPU layout costs).

#include "vit_attention.cuh"

// C entry. Device pointers: q, k, v (one set of element strides sb, sh, sn
// over batch, head and token; head_dim 64 contiguous) and out (strides ob,
// oh, on), all bf16. The wrapper in affectgpt_tpu_torch/ops/vit_attention.py
// checks dtypes, shapes, alignment and the limits (d == 64, 1 <= valid_len
// <= n <= 512). Returns cudaGetLastError() after the launch.
extern "C" int agk_vit_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                      int b, int heads, int n, int valid_len, int d,
                                      long long sb, long long sh, long long sn, long long ob,
                                      long long oh, long long on, void* stream) {
  using namespace agk::vit;
  if (d != kAttnD || n < 1 || n > kAttnMaxN || valid_len < 1 || valid_len > n)
    return (int)cudaErrorInvalidValue;
  return (int)launch_vit_attention(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), b, heads, n,
      valid_len, AttnStrides{sb, sh, sn}, AttnStrides{ob, oh, on},
      static_cast<cudaStream_t>(stream));
}
