// Fused bf16 decode MLP for the q=1 decode step on Hopper (sm_90a):
//   y = x + down(silu(gate(rms(x))) * up(rms(x)))
//
// Replaces the Pallas kernel
// affectgpt_tpu/ops/decode_mlp_bf16_pallas.py::decode_mlp_bf16.
//
// Bound: weight bytes. The three matrices hold 3*h*I bf16 values (407 MB per
// layer at Qwen2.5-7B width) and each is used for only b multiply-adds, so a
// call is a bandwidth-bound sweep. The TPU kernel carried an f32 down-projection
// accumulator across a sequential grid over I blocks; Hopper blocks run in no
// order, so the sweep is split into two launches instead, which keeps the
// result deterministic and needs no atomics:
//   (A) grid over 64-column strips of I: each block rms-normalizes its rows
//       (cheap, repeated per block), computes gate and up with f32
//       accumulation, applies silu(g)*u, rounds it to bf16 (the TPU kernel's
//       rounding point, decode_mlp_bf16_pallas.py:64) and stores it in a
//       [b, I] scratch buffer (0.3 MB at b=8);
//   (B) grid over 32-column strips of h: each block streams the down
//       projection over the whole I, staging the scratch rows through shared
//       memory in chunks, accumulates in f32, adds the residual x and writes
//       the bf16 output.
// Both launches read their weight strips once per batch tile of 8 rows with
// 16-byte loads (gemv_tile.cuh).

#include "gemv_tile.cuh"

namespace agk {

constexpr int kGateCols = 64;
constexpr int kDownCols = 32;
constexpr int kDownChunk = 4096;  // I values of the scratch rows staged at a time

__global__ void __launch_bounds__(kThreads, 1)
decode_mlp_gateup_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln,
                         const __nv_bfloat16* __restrict__ wg, const __nv_bfloat16* __restrict__ wu,
                         __nv_bfloat16* __restrict__ act, int b, int h, int inter, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);        // [BM][h]
  float* red = reinterpret_cast<float*>(smem + (size_t)BM * h * 2);  // [kWarps][BM][64]
  float* gate = red + kWarps * BM * kGateCols;                       // [BM][64]
  float* up = gate + BM * kGateCols;                                 // [BM][64]

  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, b - row0);
  stage_rows(x + (size_t)row0 * h, ln, rows, h, eps, xs);
  const int col0 = blockIdx.x * kGateCols;

  float acc[BM][8];
  zero_acc(acc);
  gemv_accumulate<kGateCols>(xs, h, 0, wg, (size_t)inter, col0, col0 + kGateCols / 2, 0, h,
                             acc);
  gemv_reduce<kGateCols>(acc, red, gate);
  zero_acc(acc);
  gemv_accumulate<kGateCols>(xs, h, 0, wu, (size_t)inter, col0, col0 + kGateCols / 2, 0, h,
                             acc);
  gemv_reduce<kGateCols>(acc, red, up);

  for (int i = threadIdx.x; i < BM * kGateCols; i += kThreads) {
    const int m = i / kGateCols, c = i % kGateCols;
    if (m >= rows) continue;
    const float g = gate[i];
    const float a = g / (1.f + expf(-g)) * up[i];
    act[(size_t)(row0 + m) * inter + col0 + c] = f2bf(a);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
decode_mlp_down_kernel(const __nv_bfloat16* __restrict__ act, const __nv_bfloat16* __restrict__ x,
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

cudaError_t launch_down_residual(const __nv_bfloat16* act, const __nv_bfloat16* x,
                                 const __nv_bfloat16* w, __nv_bfloat16* y, int b, int h,
                                 int inter, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = (size_t)BM * kDownChunk * 2 + (size_t)(kWarps + 1) * BM * kDownCols * 4;
  cudaError_t err = ensure_smem(decode_mlp_down_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  decode_mlp_down_kernel<<<dim3(h / kDownCols, (b + BM - 1) / BM), kThreads, smem, stream>>>(
      act, x, w, y, b, h, inter);
  return cudaGetLastError();
}

}  // namespace agk

// C entry. Device pointers to contiguous bf16 tensors: x, y [b, h]; ln [h];
// wg, wu [h, I]; wd [I, h]; act is [b, I] scratch. The wrapper in
// affectgpt_tpu_torch/ops/decode_mlp_bf16.py checks shapes, alignment and
// divisibility. Returns the first CUDA error of the two launches, or 0.
extern "C" int agk_decode_mlp_bf16(const void* x, const void* ln, const void* wg, const void* wu,
                                   const void* wd, void* act, void* y, int b, int h, int inter,
                                   float eps, void* stream) {
  using namespace agk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static size_t granted = 48 * 1024;
  const size_t smem = (size_t)BM * h * 2 + (size_t)(kWarps + 2) * BM * kGateCols * 4;
  cudaError_t err = ensure_smem(decode_mlp_gateup_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  decode_mlp_gateup_kernel<<<dim3(inter / kGateCols, (b + BM - 1) / BM), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ln),
      static_cast<const __nv_bfloat16*>(wg), static_cast<const __nv_bfloat16*>(wu),
      static_cast<__nv_bfloat16*>(act), b, h, inter, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_down_residual(
      static_cast<const __nv_bfloat16*>(act), static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wd), static_cast<__nv_bfloat16*>(y), b, h, inter, st);
}
