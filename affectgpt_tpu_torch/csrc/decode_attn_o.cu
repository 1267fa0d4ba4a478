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
// grid. The call is therefore split into stages:
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

namespace agk {

constexpr int kDownCols = 32;
constexpr int kDownChunk = 4096;  // values of the attention rows staged at a time

__global__ void __launch_bounds__(kThreads, 1)
o_proj_residual_kernel(const __nv_bfloat16* __restrict__ act, const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ wd, __nv_bfloat16* __restrict__ y,
                       int b, int h, int inter) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);                 // [BM][chunk]
  float* red = reinterpret_cast<float*>(smem + (size_t)BM * kDownChunk * 2);  // [kWarps][BM][32]
  float* out = red + kWarps * BM * kDownCols;                                 // [BM][32]

  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, b - row0);
  const int col0 = blockIdx.x * kDownCols;

  float acc[BM][8];
  zero_acc(acc);
  for (int kc = 0; kc < inter; kc += kDownChunk) {
    const int kn = min(kDownChunk, inter - kc);
    const int vecs = kn / 8;  // inter % 8 == 0, checked by the wrapper
    for (int i = threadIdx.x; i < BM * vecs; i += kThreads) {
      const int m = i / vecs, kv = i % vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < rows)
        val = *reinterpret_cast<const uint4*>(act + (size_t)(row0 + m) * inter + kc + kv * 8);
      *reinterpret_cast<uint4*>(as + m * kDownChunk + kv * 8) = val;
    }
    __syncthreads();
    gemv_accumulate<kDownCols>(as, kDownChunk, kc, wd, (size_t)h, col0, col0 + kDownCols / 2, kc,
                              kc + kn, acc);
    __syncthreads();
  }
  gemv_reduce<kDownCols>(acc, red, out);

  for (int i = threadIdx.x; i < BM * kDownCols; i += kThreads) {
    const int m = i / kDownCols, c = i % kDownCols;
    if (m >= rows) continue;
    const size_t o = (size_t)(row0 + m) * h + col0 + c;
    y[o] = f2bf(out[i] + bf2f(x[o]));
  }
}

// y[b, h] = x + act[b, inter] @ w[inter, h], f32 accumulation and one
// rounding to bf16: the o_proj + residual launch. Needs h % 32 == 0 and
// inter % 8 == 0. Returns the launch's CUDA error code.
static cudaError_t launch_o_proj_residual(const __nv_bfloat16* act, const __nv_bfloat16* x,
                                        const __nv_bfloat16* w, __nv_bfloat16* y, int b,
                                        int h, int inter, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = (size_t)BM * kDownChunk * 2 + (size_t)(kWarps + 1) * BM * kDownCols * 4;
  cudaError_t err = ensure_smem(o_proj_residual_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  o_proj_residual_kernel<<<dim3(h / kDownCols, (b + BM - 1) / BM), kThreads, smem, stream>>>(
      act, x, w, y, b, h, inter);
  return cudaGetLastError();
}

}  // namespace agk

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
  return (int)launch_o_proj_residual(
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wo), static_cast<__nv_bfloat16*>(y), b, h, kv * g * d,
      st);
}
