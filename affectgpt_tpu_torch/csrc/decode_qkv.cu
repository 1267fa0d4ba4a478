// Fused decode-QKV for the q=1 decode step on Hopper (sm_90a).
//
// Replaces the Pallas kernel affectgpt_tpu/ops/decode_qkv_pallas.py::decode_qkv:
// optional rmsnorm of the raw residual (rounded to bf16), the q/k/v
// projections with f32 accumulation plus bias, and half-split RoPE on q and k
// at per-row positions in f32, then one rounding.
//
// Bound: the weight bytes, h * (H + 2 kv) * d bf16 values (33 MB a layer at
// Qwen2.5-7B width, 12.6 MB at 3B), each used for b multiply-adds. The TPU
// kernel kept q/k/v resident in VMEM and streamed batch tiles through them.
// Here: the rmsnorm once a row (decode_swapab.cuh rms_rows_kernel, skipped
// without ln), then one launch of the swap-AB wgmma kernel of
// decode_swapab.cuh over three segments of 128-column tiles: q's, k's (both
// with the RoPE epilogue; a tile holds 64 columns of a head's first half and
// the 64 they rotate with, so the rotation is done in f32 before the one
// rounding) and v's (bias only). Every weight byte is read once a call at
// every b; the K split over a cluster fills the SMs (36 tiles at 7B). After
// the rmsnorm the projections launch as its programmatic dependent: their
// first weight loads start before the normalized rows exist.

#include "decode_swapab.cuh"

// C entry. Device pointers to contiguous tensors: bf16 except pos (int32
// [b]); ln may be null, then xn is unused, else xn is [b, h] scratch. The
// plan (nb, cb, ck, stages) comes from the wrapper
// (affectgpt_tpu_torch/ops/decode_qkv.py, decode_qkv_plan), which checks
// shapes, alignment and head_dim % 128 == 0. Returns the first CUDA error of
// the launches, or 0.
extern "C" int agk_decode_qkv_bf16(const void* x, const void* ln, const void* pos,
                                   const void* wq, const void* bq, const void* wk,
                                   const void* bk, const void* wv, const void* bv, void* q,
                                   void* k, void* v, void* xn, int b, int h, int nq, int nkv,
                                   int head_dim, int nb, int cb, int ck, int stages,
                                   float eps, float theta, void* stream) {
  using namespace agk::dsab;
  if (head_dim % 128 || nq % head_dim || nkv % head_dim || h % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf* a = static_cast<const bf*>(x);
  if (ln != nullptr) {
    cudaError_t err = launch_rms_rows(a, static_cast<const bf*>(ln), static_cast<bf*>(xn), b, h,
                                      eps, st);
    if (err != cudaSuccess) return (int)err;
    a = static_cast<const bf*>(xn);
  }
  Params p = {};
  if (weight_map(&p.w[0], wq, h, nq) || weight_map(&p.w[1], wk, h, nkv) ||
      weight_map(&p.w[2], wv, h, nkv))
    return (int)cudaErrorInvalidValue;
  p.seg[0] = {nq / 128, kRope, 0, 0, head_dim, nq, static_cast<const bf*>(bq), nullptr,
              static_cast<bf*>(q)};
  p.seg[1] = {nkv / 128, kRope, 1, 1, head_dim, nkv, static_cast<const bf*>(bk), nullptr,
              static_cast<bf*>(k)};
  p.seg[2] = {nkv / 128, kBias, 2, 2, head_dim, nkv, static_cast<const bf*>(bv), nullptr,
              static_cast<bf*>(v)};
  p.nseg = 3;
  p.pos = static_cast<const int*>(pos);
  p.theta = theta;
  p.b = b;
  p.K = h;
  p.cb = cb;
  p.ck = ck;
  p.stages = stages;
  return (int)launch(p, a, nb, ln != nullptr, st);
}
