// Fused non-causal ViT attention on Hopper (sm_90a), on wgmma fed by TMA.
//
// Replaces affectgpt_tpu/ops/vit_attention_pallas.py::fused_vit_attention
// (its pallas_call, :79), which the JAX package reaches through
// mha_fused (CLIP_ATTN="flash") and through nn.mha for unmasked
// self-attention of at least 192 tokens. Like the TPU kernel it takes any
// head_dim d with d % 8 == 0 and 32 <= d <= 128 (JAX's route gate) and any
// number of tokens. Three designs: at head_dim 64 with at most 512 valid
// keys, a unit's K and V stay in shared memory (vit_attention.cuh: one pass
// up to 320 keys, two beyond); every other shape streams K and V through a
// TMA ring in two passes (vit_attention_stream.cuh: DINOv2's 1370 tokens,
// SigLIP's head_dim 72). q, k and v are read through 4-D tensor maps over
// their strides, so the [b, h, n, d] layout of fused_vit_attention and the
// [b, n, h, d] layout of fused_self_attention both go in without a copy
// (JAX's two transposes and its pad of n to 8 are TPU layout costs).
// ops/vit_attention.py::vit_attention_plan names the design of a shape.

#include "vit_attention.cuh"
#include "vit_attention_stream.cuh"

// C entry. Device pointers: q, k, v (one set of element strides sb, sh, sn
// over batch, head and token; head_dim d contiguous) and out (strides ob,
// oh, on), all bf16. The wrapper in affectgpt_tpu_torch/ops/vit_attention.py
// checks dtypes, shapes, alignment and the limits (d % 8 == 0, 32 <= d <=
// 128, 1 <= valid_len <= n). Returns cudaGetLastError() after the launch.
extern "C" int agk_vit_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                      int b, int heads, int n, int valid_len, int d,
                                      long long sb, long long sh, long long sn, long long ob,
                                      long long oh, long long on, void* stream) {
  using namespace agk::vit;
  using bf = __nv_bfloat16;
  if (d % 8 || d < 32 || d > 128 || n < 1 || valid_len < 1 || valid_len > n)
    return (int)cudaErrorInvalidValue;
  const AttnStrides in{sb, sh, sn}, os{ob, oh, on};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == kAttnD && valid_len <= kAttnMaxN)  // K and V of a unit stay in shared memory
    return (int)launch_vit_attention(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                     static_cast<const bf*>(v), static_cast<bf*>(out), b, heads,
                                     n, valid_len, in, os, s);
  return (int)launch_vit_attention_stream(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                          static_cast<const bf*>(v), static_cast<bf*>(out), b,
                                          heads, n, valid_len, d, in, os, s);
}
