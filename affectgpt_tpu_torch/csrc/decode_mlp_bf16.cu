// Fused bf16 decode MLP for the q=1 decode step on Hopper (sm_90a):
//   y = x + down(bf16(silu(gate(xn)) * up(xn))), xn = bf16(rms(x) * ln)
//
// Replaces the Pallas kernel
// affectgpt_tpu/ops/decode_mlp_bf16_pallas.py::decode_mlp_bf16.
//
// Bound: the weight bytes at decode batches (3 h I bf16 values: 407 MB a
// layer at Qwen2.5-7B width, 135 MB at 3B), each used for b multiply-adds;
// at bench.py's b = 384 (3B) the products (52 GFLOP, 0.052 ms at 989
// TFLOP/s) pass the bytes (0.040 ms). The TPU kernel carried the down
// projection's f32 accumulator across a sequential grid over I blocks with
// the batch innermost, so the weights were DMA'd once a call. Hopper blocks
// run in no order, so the call is three launches, deterministic and without
// atomics: the rmsnorm once a row (decode_swapab.cuh rms_rows_kernel), then
// the swap-AB wgmma kernel of decode_swapab.cuh twice:
//   (A) gate and up: a tile is gate's columns c .. c + 63 (box 0) and up's
//       same columns (box 1); the epilogue rounds silu(g) * u to bf16 (the
//       TPU kernel's rounding point, decode_mlp_bf16_pallas.py:64) into a
//       [b, I] scratch;
//   (B) down + residual: 128-column tiles of h over K = I, the f32 sum split
//       over a cluster where the tiles are fewer than the SMs, x added in
//       f32, one rounding.
// Each weight byte is read once a call at every b <= 512. (A) and (B) launch
// as programmatic dependents of the launch before them: their first weight
// loads overlap its end.

#include "decode_swapab.cuh"

// C entry. Device pointers to contiguous bf16 tensors: x, y [b, h]; ln [h];
// wg, wu [h, I]; wd [I, h]; xn [b, h] and act [b, I] scratch. Each
// product's plan (nb, cb, ck, stages) comes from the wrapper
// (affectgpt_tpu_torch/ops/decode_mlp_bf16.py, decode_mlp_bf16_plan), which
// checks shapes, alignment, I % 64 == 0 and h % 128 == 0. residual 0 drops
// the + x of (B): y is the MLP alone, a tensor-parallel rank's partial sum,
// which the caller reduces over the ranks before it adds x once. Returns the
// first CUDA error of the three launches, or 0.
extern "C" int agk_decode_mlp_bf16(const void* x, const void* ln, const void* wg, const void* wu,
                                   const void* wd, void* xn, void* act, void* y, int b, int h,
                                   int inter, int nb_a, int cb_a, int ck_a, int stages_a,
                                   int nb_b, int cb_b, int ck_b, int stages_b, float eps,
                                   int residual, void* stream) {
  using namespace agk::dsab;
  if (inter % 64 || h % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_rms_rows(static_cast<const bf*>(x), static_cast<const bf*>(ln),
                                    static_cast<bf*>(xn), b, h, eps, st);
  if (err != cudaSuccess) return (int)err;
  Params pa = {};
  if (weight_map(&pa.w[0], wg, h, inter) || weight_map(&pa.w[1], wu, h, inter))
    return (int)cudaErrorInvalidValue;
  pa.seg[0] = {inter / 64, kSiluMul, 0, 1, 0, inter, nullptr, nullptr, static_cast<bf*>(act)};
  pa.nseg = 1;
  pa.b = b;
  pa.K = h;
  pa.cb = cb_a;
  pa.ck = ck_a;
  pa.stages = stages_a;
  err = launch(pa, static_cast<const bf*>(xn), nb_a, true, st);
  if (err != cudaSuccess) return (int)err;
  Params pb = {};
  if (weight_map(&pb.w[0], wd, inter, h)) return (int)cudaErrorInvalidValue;
  pb.seg[0] = {h / 128, kResidual, 0, 0, 0, h, nullptr,
               residual ? static_cast<const bf*>(x) : nullptr, static_cast<bf*>(y)};
  pb.nseg = 1;
  pb.b = b;
  pb.K = inter;
  pb.cb = cb_b;
  pb.ck = ck_b;
  pb.stages = stages_b;
  return (int)launch(pb, static_cast<const bf*>(act), nb_b, true, st);
}

// How many clusters of `cluster` blocks of the swap-AB kernel at batch width
// nb with `stages` ring stages the card holds at once (both decode kernels'
// plans read it: ops/decode_gemm.py); a negative CUDA error on failure.
extern "C" int agk_decode_swapab_active_clusters(int nb, int cluster, int stages) {
  using namespace agk::dsab;
  if (cluster < 1 || cluster > kMaxCluster || stages < 2 || smem_bytes(nb, stages) > 232448)
    return -(int)cudaErrorInvalidValue;
  switch (nb) {
    case 8: return active_clusters_nb<8>(cluster, stages);
    case 16: return active_clusters_nb<16>(cluster, stages);
    case 32: return active_clusters_nb<32>(cluster, stages);
    case 64: return active_clusters_nb<64>(cluster, stages);
    case 128: return active_clusters_nb<128>(cluster, stages);
    case 192: return active_clusters_nb<192>(cluster, stages);
    case 256: return active_clusters_nb<256>(cluster, stages);
    default: return -(int)cudaErrorInvalidValue;
  }
}
