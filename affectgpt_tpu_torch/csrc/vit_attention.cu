// Fused non-causal ViT attention on Hopper (sm_90a), on wgmma fed by TMA.
//
// Replaces affectgpt_tpu/ops/vit_attention_pallas.py::fused_vit_attention
// (its pallas_call, :79), which the JAX package reaches through
// mha_fused (CLIP_ATTN="flash") and through nn.mha for unmasked
// self-attention of at least 192 tokens. Like the TPU kernel it takes any
// head_dim d with d % 8 == 0 and 32 <= d <= 128 (JAX's route gate) and any
// number of tokens, and every shape takes one design: K and V streamed
// through TMA rings in one pass with an online softmax, p rounded before it
// is normalised (vit_attention_flash.cu). It took less time than the
// resident designs of vit_attention.cuh (K and V of a unit kept in shared
// memory, p normalised before its bf16 rounding as on the TPU) at every
// shape they hold that was timed (CLIP's 257 tokens, ImageBind's 229,
// HuBERT's 99), which now serve only as row 11's attention step
// (vit_sublayer.cu). q, k and v are read through 4-D tensor maps over their
// strides, so the [b, h, n, d] layout of fused_vit_attention and the [b, n,
// h, d] layout of fused_self_attention both go in without a copy (JAX's two
// transposes and its pad of n to 8 are TPU layout costs).

#include "attention_wgmma.cuh"

namespace agk {
namespace vit {
using attn::AttnStrides;
// vit_attention_flash.cu
cudaError_t launch_vit_attention_flash(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, __nv_bfloat16* out, int b,
                                       int heads, int n, int valid_len, int d, AttnStrides in,
                                       AttnStrides os, cudaStream_t stream);
}  // namespace vit
}  // namespace agk

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
  return (int)launch_vit_attention_flash(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                         static_cast<const bf*>(v), static_cast<bf*>(out), b,
                                         heads, n, valid_len, d, in, os, s);
}
