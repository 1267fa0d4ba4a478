// The second launch of a K split whose partial sums went to device memory
// (int8_matmul_w8a8.cu): y = bf16(the splits' f32 partial tiles summed in
// order, times scales[n] when given). A fixed order and no atomics, so two
// calls give the same bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agk {

// partial [splits, M, N] f32 -> y [M, N] bf16, one thread an element
static __global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scales,
                     __nv_bfloat16* __restrict__ y, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * total + i];
    if (scales != nullptr) s *= scales[i % N];
    y[i] = __float2bfloat16(s);
  }
}

static inline cudaError_t launch_splitk_reduce(const float* partial, const float* scales,
                                               __nv_bfloat16* y, int M, int N, int splits,
                                               cudaStream_t stream) {
  const size_t total = (size_t)M * N;
  const int blocks = (int)(total / 256 + 1 < 4096 ? total / 256 + 1 : 4096);
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, scales, y, M, N, splits);
  return cudaGetLastError();
}

}  // namespace agk
