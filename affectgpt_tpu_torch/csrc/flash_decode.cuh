// Split-T flash decoding for one query token per row: the launches and row
// helpers of the decode-attention kernel (csrc/decode_attention.cu, where
// they are defined).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agk {

constexpr int kDecodeChunk = 64;  // cache columns per block of the split launch
constexpr int kMaxGroups = 8;     // query heads per kv head held in registers

// out[b, kv, g, d] (bf16) = softmax(q k^T / sqrt(d) + additive mask) v. The
// valid columns of row r are those of mask[r, T] (bytes, non-zero = valid).
// Two launches: per (row, kv head, chunk of kDecodeChunk columns) a block
// writes its running max, sum and f32 accumulator into part_ml [b*kv,
// chunks, g, 2] and part_acc [b*kv, chunks, g, d]; then per (query head,
// row, kv head) a block merges the chunks in a fixed order. d is 64 or 128,
// 1 <= g <= kMaxGroups. Returns the first CUDA error.
cudaError_t launch_flash_decode(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const unsigned char* mask,
                                float* part_ml, float* part_acc, __nv_bfloat16* out, int b,
                                int kv, int g, int T, int d, cudaStream_t stream);

// Warp reductions and row loads of the split kernels.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sums v[gi] over the warp for all kMaxGroups query heads at once, in 9
// shuffles instead of 8 x 5: each step halves the values a lane keeps and
// adds its partner's other half. Afterwards lane l holds the sum for query
// head (l / 4) % 8, the same in the four lanes of each quad.
__device__ __forceinline__ float warp_sum_groups(const float (&v)[kMaxGroups]) {
  static_assert(kMaxGroups == 8, "the butterfly below reduces 8 values");
  const int lane = threadIdx.x % 32;
  float a[4], b[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (hi16 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, hi16 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (hi8 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, hi8 ? a[i] : a[i + 2], 8);
  float c = (hi4 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, hi4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  return c + __shfl_xor_sync(0xffffffffu, c, 1);
}

// E consecutive bf16 of a row (E = 4: one 8-byte load, E = 2: one 4-byte
// load), or zeros when !in.
template <int E>
__device__ __forceinline__ void load_row_part(const __nv_bfloat16* src, bool in,
                                              uint32_t (&w)[E / 2]) {
  if constexpr (E == 4) {
    const uint2 t = in ? __ldg(reinterpret_cast<const uint2*>(src)) : make_uint2(0u, 0u);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    w[0] = in ? __ldg(reinterpret_cast<const uint32_t*>(src)) : 0u;
  }
}

template <int E>
__device__ __forceinline__ void unpack_bf16(const uint32_t (&w)[E / 2], float (&f)[E]) {
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

}  // namespace agk
