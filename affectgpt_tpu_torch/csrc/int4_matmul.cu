// Int4-weight matmul for Hopper (sm_90a) above decode M (16 < M <= 1024):
// each 128-row group's product of bf16(x) with the raw int4 values (exact in
// bf16) is summed in f32, multiplied by that group's scales[g, n] and added to
// the f32 accumulator; the result is rounded to bf16. The dequantized weight
// never exists, as in the TPU kernel. At M <= 16 the wrapper launches
// quant_swapab.cu instead.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/quant.py::int4_matmul.
//
// Bound: the products at M in the hundreds. A unit of the K loop is 128 packed
// rows: the low nibbles are one scale group of the first K-half, the high
// nibbles one of the second, and each is contracted against its own x columns
// with mma.sync m16n8k16 bf16 into a per-group fragment, then scaled into the
// accumulator (quant_mma.cuh, mode kW4, the 128 x 64 tile). Both nibbles are
// unpacked from unsigned bits and sign-extended from bit 3, so no signed shift
// is involved.

#include "quant_mma.cuh"

// C entry: see launch_bf16_mma in quant_mma.cuh. Returns the first CUDA
// error of the launches, or 0.
extern "C" int agk_int4_matmul(const void* x, const void* w, const void* scales, void* y,
                               void* partial, int m, int n, int k, int units_per_split,
                               int splits, void* stream) {
  return agk::qmm::launch_bf16_mma<agk::qmm::kW4>(x, w, scales, y, partial, m, n, k,
                                                  units_per_split, splits, stream);
}
