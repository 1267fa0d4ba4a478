// Int8-weight matmul for Hopper (sm_90a) above decode M (16 < M <= 1024):
// y = bf16(x) @ bf16(w_q), f32 accumulation, times the per-channel scales[n]
// at the end, rounded to bf16. At M <= 16 the wrapper launches
// quant_swapab.cu's int8 mode instead.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/quant.py::int8_matmul.
//
// Bound: the products at M in the hundreds. The TPU kernel streams int8
// tiles into VMEM and upcasts them there; this one converts each 16-byte
// load of weights to bf16 in registers on its way to shared memory and runs
// mma.sync bf16 products with f32 accumulation (quant_mma.cuh, mode kW8, the
// 128 x 64 tile).

#include "quant_mma.cuh"

// C entry: see launch_bf16_mma in quant_mma.cuh. Returns the first CUDA
// error of the launches, or 0.
extern "C" int agk_int8_matmul(const void* x, const void* w, const void* scales, void* y,
                               void* partial, int m, int n, int k, int units_per_split,
                               int splits, void* stream) {
  return agk::qmm::launch_bf16_mma<agk::qmm::kW8>(x, w, scales, y, partial, m, n, k,
                                                  units_per_split, splits, stream);
}
