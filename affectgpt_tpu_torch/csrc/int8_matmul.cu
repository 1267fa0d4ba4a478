// Int8-weight matmul for Hopper (sm_90a): y = bf16(x) @ bf16(w_q), f32
// accumulation, times the per-channel scales[n] at the end, rounded to bf16.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/quant.py::int8_matmul.
//
// Bound: at decode M (8, or 16 at b = 16) the int8 weight bytes, each read
// once for M multiply-adds; at M in the hundreds the products. The TPU kernel
// streams int8 tiles into VMEM and upcasts them there; this one converts each
// 16-byte load of weights to bf16 in registers on its way to shared memory and
// runs mma.sync bf16 products with f32 accumulation (quant_mma.cuh, mode kW8).
// One source covers M = 8 (a 16 x 128 tile, the K loop split over enough
// blocks to fill the card) and M up to 1024 (a 128 x 64 tile); both compute
// the same function.

#include "quant_mma.cuh"

// C entry: see launch_bf16_mma in quant_mma.cuh. Returns the first CUDA
// error of the launches, or 0.
extern "C" int agk_int8_matmul(const void* x, const void* w, const void* scales, void* y,
                               void* partial, int m, int n, int k, int units_per_split,
                               int splits, void* stream) {
  return agk::qmm::launch_bf16_mma<agk::qmm::kW8>(x, w, scales, y, partial, m, n, k,
                                                  units_per_split, splits, stream);
}
