// int4_matmul_smallm's function above decode M on quant_wgmma.cuh (mode
// kW4Dequant): each weight is dequantized as bf16(value * scales[g, n])
// computed in f32 in the register A fragment, then bf16(x) times those
// weights is accumulated in f32 and rounded to bf16, the function of
// int4_matmul_xla.
//
// The wrapper (ops/quant.py::int4_matmul_smallm) launches this entry only
// above M = 16, which the main path never routes to it (its decode M, up to
// 15, runs quant_swapab.cu): a direct call at a larger M.

#include "quant_wgmma.cuh"

// C entries: see launch, active_clusters and blocks_an_sm in quant_wgmma.cuh. The plan
// (nb, cb, ck, stages) comes from ops/quant.py::wgmma_plan.
extern "C" int agk_int4_matmul_smallm(const void* x, const void* w, const void* scales, void* y,
                                      int m, int n, int k, int nb, int cb, int ck, int stages,
                                      void* stream) {
  return agk::qwg::launch<agk::qwg::kW4Dequant>(x, w, scales, y, m, n, k, nb, cb, ck, stages,
                                                stream);
}

extern "C" int agk_int4_matmul_smallm_active_clusters(int nb, int cluster, int stages) {
  return agk::qwg::active_clusters<agk::qwg::kW4Dequant>(nb, cluster, stages);
}

extern "C" int agk_int4_matmul_smallm_blocks_per_sm(int nb) {
  return agk::qwg::blocks_an_sm<agk::qwg::kW4Dequant>(nb);
}
