// int4_matmul_smallm's function on quant_mma.cuh (mode kW4Dequant): each
// weight is dequantized as bf16(value * scales[g, n]) computed in f32, then
// bf16(x) times those weights is accumulated in f32 and rounded to bf16, the
// function of int4_matmul_xla.
//
// The wrapper (ops/quant.py::int4_matmul_smallm) launches this entry only
// above M = 16, which the main path never routes to it (its decode M, up to
// 15, runs quant_swapab.cu): the 128 x 64 tile, the K loop split over blocks
// and reduced by a second launch where the tiles are too few.

#include "quant_mma.cuh"

// C entry: see launch_bf16_mma in quant_mma.cuh. Returns the first CUDA
// error of the launches, or 0.
extern "C" int agk_int4_matmul_smallm(const void* x, const void* w, const void* scales, void* y,
                                      void* partial, int m, int n, int k, int units_per_split,
                                      int splits, void* stream) {
  return agk::qmm::launch_bf16_mma<agk::qmm::kW4Dequant>(x, w, scales, y, partial, m, n, k,
                                                         units_per_split, splits, stream);
}
