// Split-T flash decoding over the dense KV cache, for one query token per
// row: the attention part shared by the decode-attention kernel
// (csrc/decode_attention.cu, where it is defined) and the decode attention
// sublayer (csrc/decode_attn_o.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace agk {

constexpr int kDecodeChunk = 64;  // cache columns per block of the split launch
constexpr int kMaxGroups = 8;     // query heads per kv head held in registers

// out[b, kv, g, d] (bf16) = softmax(q k^T / sqrt(d) + additive mask) v. The
// valid columns of row r come from mask[r, T] (bytes, non-zero = valid):
// either the mask itself, or, with window set, the window from its first to
// its last valid column (all T columns when it has none), the reduction
// decode_attn_o_pallas.py:135-137 makes. Two launches: per (row, kv head,
// chunk of kDecodeChunk columns) a block writes its running max, sum and
// f32 accumulator into part_ml [b*kv, chunks, g, 2] and part_acc
// [b*kv, chunks, g, d]; then per (query head, row, kv head) a block merges
// the chunks in a fixed order. d is 64 or 128, 1 <= g <= kMaxGroups. Returns the
// first CUDA error.
cudaError_t launch_flash_decode(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const unsigned char* mask, bool window,
                                float* part_ml, float* part_acc, __nv_bfloat16* out, int b,
                                int kv, int g, int T, int d, cudaStream_t stream);

}  // namespace agk
