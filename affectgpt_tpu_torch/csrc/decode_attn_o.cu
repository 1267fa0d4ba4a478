// The decode attention sublayer's back half on Hopper (sm_90a): attention
// over the dense KV cache for one query token per row, then o_proj and the
// residual add, y = x + attn(q, K, V) @ W_o.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/decode_attn_o_pallas.py::
// decode_attn_o, which ran an online softmax over T blocks on a sequential
// grid and then o_proj with W_o resident in VMEM.
//
// Bound: bytes. The valid K/V rows (10.5 MB at b = 8, T = 640, Qwen2.5-7B
// width) and W_o [H*d, h] (25.7 MB there) are each read once and used for
// few multiply-adds per value. W_o does not fit a block's 227 KB of shared
// memory, so it cannot stay resident as on the TPU, and Hopper blocks run in
// no order, so nothing can carry the softmax state across a sequential
// grid. The call is therefore split into stages, as the decode MLP splits
// its sweep (csrc/decode_mlp_bf16.cu):
//   (A) split-T flash decoding (csrc/flash_decode.cuh, two launches) over
//       each row's valid window [lo, hi]: first to last valid column of the
//       key mask, which every block reduces itself from the mask row, as
//       the TPU wrapper does (decode_attn_o_pallas.py:135-137); the merge
//       writes the normalized attention rounded to bf16 (the TPU kernel's
//       rounding point, :100) into a [b, H*d] scratch, head-major;
//   (B) o_proj + residual over 32-column strips of h, streaming W_o with
//       the strip loader of gemv_tile.cuh, f32 accumulation, x added in f32
//       and one rounding (decode_attn_o_pallas.py:101-102).
// The chunk merge and the strip reduction run in a fixed order: the result
// is deterministic and needs no atomics.

#include "flash_decode.cuh"
#include "gemv_tile.cuh"

// C entry. Device pointers to contiguous tensors: x, y [b, h], q [b, kv, g, d],
// k, v [b, kv, T, d], wo [kv*g*d, h] and attn [b, kv*g*d] bf16; mask [b, T]
// bool; part_ml, part_acc f32 scratch (see flash_decode.cuh). The wrapper in
// affectgpt_tpu_torch/ops/decode_attn_o.py checks shapes, dtypes and limits.
// Returns the first CUDA error of the launches, or 0.
extern "C" int agk_decode_attn_o_bf16(const void* x, const void* q, const void* k,
                                      const void* v, const void* mask, const void* wo,
                                      void* part_ml, void* part_acc, void* attn, void* y,
                                      int b, int kv, int g, int T, int d, int h, void* stream) {
  using namespace agk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_flash_decode(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const unsigned char*>(mask), true,
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<__nv_bfloat16*>(attn), b, kv, g, T, d, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_down_residual(
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wo), static_cast<__nv_bfloat16*>(y), b, h, kv * g * d,
      st);
}
