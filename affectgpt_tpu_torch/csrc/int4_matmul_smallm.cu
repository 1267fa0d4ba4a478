// Decode-shaped int4-weight matmul for Hopper (sm_90a), M < 16: each weight
// is dequantized as bf16(value * scales[g, n]) computed in f32, then bf16(x)
// times those weights is accumulated in f32 and rounded to bf16, the
// function of int4_matmul_xla.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/quant.py::int4_matmul_smallm.
//
// Bound: the packed weight bytes (3.5 GB per 7B decode step), each read once
// for M <= 15 multiply-adds. The TPU kernel dequantizes a tile into VMEM and
// runs one fat dot; here each 16-byte load of packed bytes becomes 32 bf16
// weights (both nibbles, each with its group's scale) in registers on its way
// to shared memory, and one 16-row mma.sync tile (rows past M are zero)
// multiplies them (quant_mma.cuh, mode kW4Dequant). The x rows of the down
// projection (18944 columns) would not fit shared memory, so x is staged per
// unit of 128 packed rows. k/v_proj (N = 512) has only 4 column tiles, and
// the K loop is split over blocks to fill 132 SMs; a second launch sums the
// splits in a fixed order.

#include "quant_mma.cuh"

// C entry: see launch_bf16_mma in quant_mma.cuh. Returns the first CUDA
// error of the launches, or 0.
extern "C" int agk_int4_matmul_smallm(const void* x, const void* w, const void* scales, void* y,
                                      void* partial, int m, int n, int k, int units_per_split,
                                      int splits, void* stream) {
  return agk::qmm::launch_bf16_mma<agk::qmm::kW4Dequant>(x, w, scales, y, partial, m, n, k,
                                                         units_per_split, splits, stream);
}
