// Decode attention over the dense KV cache on Hopper (sm_90a): one query
// token per row, GQA, masked softmax in f32, then PV, for any key mask.
//
// Replaces the Pallas kernel
// affectgpt_tpu/ops/decode_attention_pallas.py::decode_attention_pallas.
//
// One launch of the attention kernel of csrc/dense_decode_attention.cuh (the
// one decode_attn_o.cu launches for its window of keys), in one of its two
// modes that take any mask (dense::Keys): kMaskWindow shares out the tiles of
// each row's window of valid columns, kMaskAll all tiles of the row; the plan
// (ops/decode_attention.py::decode_attention_plan) picks the mode, the splits
// of a (row, kv head) pair and the ring. Bound: the valid columns' K/V bytes
// (10.5 MB at b = 8, T = 640, Qwen2.5-7B width); the header says what the
// design does about them.

#include "dense_decode_attention.cuh"

// C entry. Device pointers to contiguous tensors: q, out [b, kv, g, d] and
// k, v [b, kv, T, d] bf16; mask [b, T] bool. splits, stages and keys (1
// kMaskWindow, 2 kMaskAll) from the plan; the wrapper in affectgpt_tpu_torch/
// ops/decode_attention.py checks shapes, dtypes and limits. Returns the
// launch's CUDA error, or 0.
extern "C" int agk_decode_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* mask, void* out, int b, int kv, int g, int T,
                                         int d, int splits, int stages, int keys, void* stream) {
  using namespace agk;
  using bf = __nv_bfloat16;
  const bf* qp = static_cast<const bf*>(q);
  const bf* kp = static_cast<const bf*>(k);
  const bf* vp = static_cast<const bf*>(v);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  bf* op = static_cast<bf*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keys == (int)dense::Keys::kMaskWindow)
    return (int)launch_dense_decode_attention<dense::Keys::kMaskWindow>(
        qp, kp, vp, mp, op, b, kv, g, T, d, splits, stages, st);
  if (keys == (int)dense::Keys::kMaskAll)
    return (int)launch_dense_decode_attention<dense::Keys::kMaskAll>(
        qp, kp, vp, mp, op, b, kv, g, T, d, splits, stages, st);
  return (int)cudaErrorInvalidValue;
}
