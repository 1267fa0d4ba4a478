// Int8-weight matmul for Hopper (sm_90a) above decode M (16 < M <= 1024):
// y = bf16(x) @ bf16(w_q), f32 accumulation, times the per-channel scales[n]
// at the end, rounded to bf16. At M <= 16 the wrapper launches
// quant_swapab.cu's int8 mode instead.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/quant.py::int8_matmul.
//
// Bound: the products at M in the hundreds, the weight bytes at the
// speculative verify's M = 40. The kernel is quant_wgmma.cuh's swap-AB
// wgmma design in mode kW8: the int8 bytes as register A fragments of wgmma
// (exact bf16 pairs), the batch rows of x as its B operand, both by TMA
// through one ring; the per-channel scale enters in the epilogue only.

#include "quant_wgmma.cuh"

// C entries: see launch, active_clusters and blocks_an_sm in quant_wgmma.cuh. The plan
// (nb, cb, ck, stages) comes from ops/quant.py::wgmma_plan.
extern "C" int agk_int8_matmul(const void* x, const void* w, const void* scales, void* y, int m,
                               int n, int k, int nb, int cb, int ck, int stages, void* stream) {
  return agk::qwg::launch<agk::qwg::kW8>(x, w, scales, y, m, n, k, nb, cb, ck, stages,
                                         stream);
}

extern "C" int agk_int8_matmul_active_clusters(int nb, int cluster, int stages) {
  return agk::qwg::active_clusters<agk::qwg::kW8>(nb, cluster, stages);
}

extern "C" int agk_int8_matmul_blocks_per_sm(int nb) {
  return agk::qwg::blocks_an_sm<agk::qwg::kW8>(nb);
}
