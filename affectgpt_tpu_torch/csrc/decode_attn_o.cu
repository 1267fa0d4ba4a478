// The decode attention sublayer's back half on Hopper (sm_90a): attention
// over the dense KV cache for one query token per row, then o_proj and the
// residual add, y = x + bf16(attn(q, K, V)) @ W_o.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/decode_attn_o_pallas.py::
// decode_attn_o, which ran an online softmax over T blocks on a sequential
// grid and then o_proj with W_o resident in VMEM.
//
// Bound: bytes. The window's K/V rows (10.5 MB at b = 8, T = 640, Qwen2.5-7B
// width) and W_o [kv g d, h] (25.7 MB there) are each read once and used for
// few multiply-adds per value. W_o does not fit a block's 227 KB of shared
// memory, so it cannot stay resident as on the TPU, and Hopper blocks run in
// no order, so nothing can carry the softmax state across a sequential
// grid. The call is therefore two launches, deterministic and without
// atomics:
//   (A) the attention in one launch (dense_decode_attention.cuh: each (row,
//       kv head) window cut into shares of 16-token tiles over a cluster,
//       K and V by TMA, both products on mma.sync, the shares merged through
//       distributed shared memory), writing the normalized attention rounded
//       to bf16 (the TPU kernel's rounding point,
//       decode_attn_o_pallas.py:100) into a [b, kv g d] scratch, head-major;
//   (B) o_proj + residual on the swap-AB wgmma kernel of decode_swapab.cuh
//       (its kResidual segment, decode_mlp_bf16's down projection): W_o's
//       128-column tiles as the MN-major A operand streamed by a TMA ring, K
//       = kv g d split over a cluster as far as one wave of clusters fits, x
//       added in f32 and one rounding (decode_attn_o_pallas.py:101-102).
//       It is launched as the programmatic dependent of (A), whose plan
//       keeps (A)'s grid within one block an SM: (B)'s blocks then fit
//       beside (A)'s and load their first stages of W_o while the attention
//       runs (with two blocks of (A) an SM they could not start before it
//       ended: 0.0232 ms a call against 0.0215 on an H100 at 7B b = 8,
//       T = 640).

#include "decode_swapab.cuh"
#include "dense_decode_attention.cuh"

// C entry. Device pointers to contiguous tensors: x, y [b, h], q [b, kv, g, d],
// k, v [b, kv, T, d], wo [kv*g*d, h] and attn [b, kv*g*d] bf16; mask [b, T]
// bool. The plan (ops/decode_attn_o.py::decode_attn_o_plan): splits and
// stages of (A); nb, cb, ck and stages of (B). The wrapper checks shapes,
// dtypes and limits (h % 128 == 0, kv g d % 64 == 0, d 64 or 128, g <= 8, b
// <= 512). residual 0 drops the + x of (B): y is o_proj(attention) alone, a
// tensor-parallel rank's partial sum, which the caller reduces over the
// ranks before it adds x once. Returns the first CUDA error of the two
// launches, or 0.
extern "C" int agk_decode_attn_o_bf16(const void* x, const void* q, const void* k,
                                      const void* v, const void* mask, const void* wo,
                                      void* attn, void* y, int b, int kv, int g, int T, int d,
                                      int h, int splits, int stages, int nb, int cb, int ck,
                                      int stages_o, int residual, void* stream) {
  using namespace agk;
  using bf = __nv_bfloat16;
  const int nq = kv * g * d;
  if (h % 128 || nq % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_dense_decode_attention<dense::Keys::kWindow>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const unsigned char*>(mask), static_cast<bf*>(attn), b, kv, g, T, d, splits,
      stages, st);
  if (err != cudaSuccess) return (int)err;
  dsab::Params p = {};
  if (dsab::weight_map(&p.w[0], wo, nq, h)) return (int)cudaErrorInvalidValue;
  p.seg[0] = {h / 128, dsab::kResidual, 0, 0, 0, h, nullptr,
              residual ? static_cast<const bf*>(x) : nullptr, static_cast<bf*>(y)};
  p.nseg = 1;
  p.b = b;
  p.K = nq;
  p.cb = cb;
  p.ck = ck;
  p.stages = stages_o;
  return (int)dsab::launch(p, static_cast<const bf*>(attn), nb, true, st);
}
