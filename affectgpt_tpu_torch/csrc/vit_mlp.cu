// Pre-LN MLP sublayer of CLIP ViT-L/14 (quick_gelu) and HuBERT-large (erf
// gelu) on Hopper (sm_90a), as two products: y = x + fc2(act(fc1(LN(x)))).
//
// Replaces affectgpt_tpu/ops/vit_mlp_pallas.py::mlp_sublayer (its two
// pallas_calls, :116 `_fc1_kernel` and :132 `_fc2_kernel`). Rounding points
// are the TPU kernels': LN in f32 rounded to bf16; t = act(h W_in + b_in) in
// f32, stored as bf16 [rows, I]; y = bf16(t W_out + b_out + x), one
// rounding. The activation is quick_gelu or the erf gelu, whose erf is the
// TPU kernel's Abramowitz-Stegun rational (absolute error 1.5e-7; Mosaic
// lowers no erf), with the special-function unit's exponential and
// reciprocal (vit_gemm_wgmma.cuh activate_pair); the plain version uses the
// exact functions, which the bf16 rounding of t hides but for a rare ulp.
//
// Bound: operations. CLIP, one layer, 64 images of 257 tokens: 4 * 16448 *
// 1024 * 4096 = 276 GFLOP, 0.279 ms at 989 TFLOP/s; HuBERT (64 x 99 rows)
// 106 GFLOP. Design: as on the TPU, two products with the intermediate in
// device memory, here over all rows at once (the TPU streamed one image per
// grid step past one VMEM-resident weight): a LayerNorm pass into bf16 rows
// h (vit_gemm_wgmma.cuh), fc1 with the bias + activation epilogue into the bf16
// scratch t, then fc2 with the bias + residual epilogue, both on the
// persistent wgmma + TMA GEMM of vit_gemm_wgmma.cuh (128 x 256 tiles; TMA
// zero-fills the ragged row tail of n = 257 or 99, the epilogue does not
// store it).

#include <string.h>

#include "vit_gemm_wgmma.cuh"

namespace {

using namespace agk::vit;
using bf = __nv_bfloat16;

// The GEMMs' launch plan (ops/vit_mlp.py mlp_plan): row tiles, fc1's and
// fc2's column tiles, the persistent grid and its clusters.
struct Plan {
  int m_tiles, fc1_tiles, fc2_tiles, blocks, cluster;
};

template <bool PRODUCTS>
cudaError_t products(const bf* h, const bf* w_in, const bf* b_in, const bf* w_out,
                     const bf* b_out, const bf* x, bf* t, bf* y, int rows, int w, int inter,
                     int act, const Plan& p, cudaStream_t st) {
  cudaError_t err =
      act == kActGelu
          ? wg::launch_gemm<kActGelu, false, PRODUCTS>(h, w_in, b_in, nullptr, t, rows, inter, w,
                                                       p.fc1_tiles, p.m_tiles, p.blocks,
                                                       p.cluster, st)
          : wg::launch_gemm<kActQuickGelu, false, PRODUCTS>(h, w_in, b_in, nullptr, t, rows,
                                                            inter, w, p.fc1_tiles, p.m_tiles,
                                                            p.blocks, p.cluster, st);
  if (err != cudaSuccess) return err;
  return wg::launch_gemm<kActNone, true, PRODUCTS>(t, w_out, b_out, x, y, rows, w, inter,
                                                   p.fc2_tiles, p.m_tiles, p.blocks, p.cluster,
                                                   st);
}

// the previous design: vit_gemm.cuh's mma.sync GEMM (a yardstick)
cudaError_t products_mma(const bf* h, const bf* w_in, const bf* b_in, const bf* w_out,
                         const bf* b_out, const bf* x, bf* t, bf* y, int rows, int w, int inter,
                         int act, cudaStream_t st) {
  GemmGroup fc1{};
  fc1.op[0] = {w_in, b_in, t};
  cudaError_t err =
      act == kActGelu ? launch_gemm<kActGelu, false>(h, fc1, 1, nullptr, rows, inter, w, st)
                      : launch_gemm<kActQuickGelu, false>(h, fc1, 1, nullptr, rows, inter, w, st);
  if (err != cudaSuccess) return err;
  GemmGroup fc2{};
  fc2.op[0] = {w_out, b_out, y};
  return launch_gemm<kActNone, true>(t, fc2, 1, x, rows, w, inter, st);
}

}  // namespace

// C entry. Device pointers to contiguous bf16 tensors: x, y [rows, w]; LN
// scale and bias [w]; w_in [w, I], b_in [I], w_out [I, w], b_out [w]; the
// scratch h [rows, w] and t [rows, I] the wrapper allocates. act is
// kActQuickGelu or kActGelu. plan holds the five ints of Plan from the
// wrapper's plan (affectgpt_tpu_torch/ops/vit_mlp.py
// `mlp_plan`), which checks shapes and limits (w % 32 == 0, w <= 2048,
// I % 32 == 0). variant: 0 the kernels; 1 the GEMMs without their products
// (a diagnostic, its result wrong); 2 the previous mma.sync GEMMs (a
// yardstick). Returns the first CUDA error of the three launches.
extern "C" int agk_vit_mlp_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                const void* w_in, const void* b_in, const void* w_out,
                                const void* b_out, void* h, void* t, void* y, const void* plan,
                                int rows, int w, int inter, int act, int variant, float eps,
                                void* stream) {
  if (w % 32 || w > 32 * 8 * kLnMaxVec || inter % 32 || (act != kActQuickGelu && act != kActGelu) ||
      variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(p));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf* xp = static_cast<const bf*>(x);
  bf* hp = static_cast<bf*>(h);
  cudaError_t err =
      variant == 2 ? launch_layernorm(xp, static_cast<const bf*>(ln_scale),
                                      static_cast<const bf*>(ln_bias), hp, rows, w, eps, st)
                   : wg::launch_layernorm_rows(xp, static_cast<const bf*>(ln_scale),
                                               static_cast<const bf*>(ln_bias), hp, rows, w, eps,
                                               st);
  if (err != cudaSuccess) return (int)err;
  const auto* wi = static_cast<const bf*>(w_in);
  const auto* bi = static_cast<const bf*>(b_in);
  const auto* wo = static_cast<const bf*>(w_out);
  const auto* bo = static_cast<const bf*>(b_out);
  bf* tp = static_cast<bf*>(t);
  bf* yp = static_cast<bf*>(y);
  if (variant == 2) return (int)products_mma(hp, wi, bi, wo, bo, xp, tp, yp, rows, w, inter, act, st);
  return (int)(variant == 0
                   ? products<true>(hp, wi, bi, wo, bo, xp, tp, yp, rows, w, inter, act, p, st)
                   : products<false>(hp, wi, bi, wo, bo, xp, tp, yp, rows, w, inter, act, p, st));
}
