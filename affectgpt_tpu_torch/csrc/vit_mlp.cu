// Pre-LN MLP sublayer of CLIP ViT-L/14 (quick_gelu) and HuBERT-large (erf
// gelu) on Hopper (sm_90a), as two products: y = x + fc2(act(fc1(LN(x)))).
//
// Replaces affectgpt_tpu/ops/vit_mlp_pallas.py::mlp_sublayer (its two
// pallas_calls, :116 `_fc1_kernel` and :132 `_fc2_kernel`). Rounding points
// are the TPU kernels': LN in f32 rounded to bf16; t = act(h W_in + b_in) in
// f32, stored as bf16 [rows, I]; y = bf16(t W_out + b_out + x), one
// rounding. The activation is quick_gelu or erf gelu with erff; the TPU
// kernel builds erf from the Abramowitz-Stegun rational (absolute error
// 1.5e-7) because Mosaic lowers no erf.
//
// Bound: operations. CLIP, one layer, 64 images of 257 tokens: 4 * 16448 *
// 1024 * 4096 = 276 GFLOP, 0.279 ms at 989 TFLOP/s; HuBERT (64 x 99 rows)
// 106 GFLOP. Design: as on the TPU, two products with the intermediate in
// device memory, here over all rows at once (the TPU streamed one image per
// grid step past one VMEM-resident weight): a LayerNorm pass into bf16 rows
// h, fc1 with the bias + activation epilogue into the bf16 scratch t, then
// fc2 with the bias + residual epilogue (vit_gemm.cuh's 128 x 128 mma.sync
// tiles, which mask the ragged row tail of n = 257 or 99).

#include "vit_gemm.cuh"

// C entry. Device pointers to contiguous bf16 tensors: x, y [rows, w]; LN
// scale and bias [w]; w_in [w, I], b_in [I], w_out [I, w], b_out [w]; the
// scratch h [rows, w] and t [rows, I] the wrapper allocates. act is
// kActQuickGelu or kActGelu. The wrapper in affectgpt_tpu_torch/ops/vit_mlp.py
// checks shapes and limits (w % 32 == 0, w <= 2048, I % 32 == 0). Returns the
// first CUDA error of the three launches.
extern "C" int agk_vit_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w_in, const void* b_in, const void* w_out,
                                const void* b_out, void* h, void* t, void* y, int rows, int w,
                                int inter, int act, float eps, void* stream) {
  using namespace agk::vit;
  using bf = __nv_bfloat16;
  if (w % 32 || w > 32 * 8 * kLnMaxVec || inter % 32 || (act != kActQuickGelu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf* xp = static_cast<const bf*>(x);
  bf* hp = static_cast<bf*>(h);
  bf* tp = static_cast<bf*>(t);
  cudaError_t err = launch_layernorm(xp, static_cast<const bf*>(ln_scale),
                                     static_cast<const bf*>(ln_bias), hp, rows, w, eps, st);
  if (err != cudaSuccess) return (int)err;
  GemmGroup fc1{};
  fc1.op[0] = {static_cast<const bf*>(w_in), static_cast<const bf*>(b_in), tp};
  err = act == kActGelu ? launch_gemm<kActGelu, false>(hp, fc1, 1, nullptr, rows, inter, w, st)
                        : launch_gemm<kActQuickGelu, false>(hp, fc1, 1, nullptr, rows, inter, w, st);
  if (err != cudaSuccess) return (int)err;
  GemmGroup fc2{};
  fc2.op[0] = {static_cast<const bf*>(w_out), static_cast<const bf*>(b_out), static_cast<bf*>(y)};
  return (int)launch_gemm<kActNone, true>(tp, fc2, 1, xp, rows, w, inter, st);
}
