// Int4-weight matmul for Hopper (sm_90a) above decode M (16 < M <= 1024):
// each 128-row group's product of bf16(x) with the raw int4 values (exact in
// bf16) is summed in f32, multiplied by that group's scales[g, n] and added to
// the f32 accumulator; the result is rounded to bf16. The dequantized weight
// never exists, as in the TPU kernel. At M <= 16 the wrapper launches
// quant_swapab.cu instead.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/quant.py::int4_matmul.
//
// Bound: the products at M in the hundreds (bench.py's 7B batch of 256), the
// weight bytes at the speculative verify's M = 40. The kernel is
// quant_wgmma.cuh's swap-AB wgmma design in mode kW4: the packed bytes come
// by TMA, each nibble becomes a register A fragment of wgmma, and each K-half's
// group sum is a second f32 tile scaled into the accumulator when its group
// completes.

#include "quant_wgmma.cuh"

// C entries: see launch, active_clusters and blocks_an_sm in quant_wgmma.cuh. The plan
// (nb, cb, ck, stages) comes from ops/quant.py::wgmma_plan.
extern "C" int agk_int4_matmul(const void* x, const void* w, const void* scales, void* y, int m,
                               int n, int k, int nb, int cb, int ck, int stages, void* stream) {
  return agk::qwg::launch<agk::qwg::kW4>(x, w, scales, y, m, n, k, nb, cb, ck, stages,
                                         stream);
}

extern "C" int agk_int4_matmul_active_clusters(int nb, int cluster, int stages) {
  return agk::qwg::active_clusters<agk::qwg::kW4>(nb, cluster, stages);
}

extern "C" int agk_int4_matmul_blocks_per_sm(int nb) {
  return agk::qwg::blocks_an_sm<agk::qwg::kW4>(nb);
}
