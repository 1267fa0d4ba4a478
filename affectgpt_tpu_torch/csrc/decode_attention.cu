// Decode attention over the dense KV cache on Hopper (sm_90a): one query
// token per row, GQA, masked softmax in f32, then PV.
//
// Replaces the Pallas kernel
// affectgpt_tpu/ops/decode_attention_pallas.py::decode_attention_pallas.
//
// Bound: cache bytes. Each valid K/V row (2 * d bf16 per kv head) is read
// once and used for 2 * g multiply-adds per value, far below the
// tensor-core rate, so a call is a bandwidth-bound sweep of the valid part of
// the cache: 10.5 MB at b = 8, T = 640, Qwen2.5-7B width. The TPU kernel
// ran one grid cell per (row, kv head) over the whole [T, d] tile; that is
// only b * kv = 32 blocks at b = 8 on 132 SMs. Here T is split into chunks
// of 64 columns, one block each (flash decoding), and a second launch
// merges the chunks' (max, sum, accumulator) per (query head, row, kv head)
// in a fixed order, so results do not depend on the schedule and need no
// atomics. The g query heads of a kv head share every K/V row a block
// loads. At these sizes a chunk costs about one memory latency, not its
// bytes' time, so a block starts all its loads (K and V rows, q, the mask
// row) before the first wait; it reads the masked columns inside its range
// too, and ignores them. A chunk with no valid column adds nothing.
// Arithmetic follows the TPU kernel
// (decode_attention_pallas.py:25-46): f32 scores q.k / sqrt(d), masked
// columns at -1e30 and p = 0 there, denominator max(sum p, 1e-20), f32
// accumulation, one rounding to bf16.

#include <stdint.h>

#include "flash_decode.cuh"

namespace agk {

// One block per (chunk, row * kv + kv head); D threads, D / 32 warps. Warp w
// owns the chunk's columns w, w + D/32, ...; lane l holds values
// [l*E, l*E + E) of each of their K and V rows and of the q rows. Every
// global load of the block is started before the first wait, so the chunk
// costs about one memory latency: K and V rows of all in-range columns
// (a masked column inside the chunk is read and then ignored), the q rows
// and the mask row.
template <int D>
__global__ void __launch_bounds__(D)
flash_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ part_ml, float* __restrict__ part_acc, int kv,
                          int g, int T) {
  constexpr int kW = D / 32;              // warps
  constexpr int E = D / 32;               // values of a row per lane
  constexpr int KPW = kDecodeChunk / kW;  // columns per warp
  __shared__ float qs[kMaxGroups][D];
  __shared__ float p[kMaxGroups][kDecodeChunk];
  __shared__ float red[kW][kMaxGroups][D];
  __shared__ unsigned char ok[kDecodeChunk];

  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int bh = blockIdx.y;  // row * kv + kv head: the [b, kv] index of q and the cache
  const int row = bh / kv;
  const int j0 = chunk * kDecodeChunk;
  const int n = min(kDecodeChunk, T - j0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ml = part_ml + ((size_t)bh * chunks + chunk) * g * 2;

  uint32_t kw[KPW][E / 2], vw[KPW][E / 2];
  const size_t base = ((size_t)bh * T + j0) * D + lane * E;
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int jj = warp + kW * u;
    load_row_part<E>(k + base + (size_t)jj * D, jj < n, kw[u]);
    load_row_part<E>(v + base + (size_t)jj * D, jj < n, vw[u]);
  }
  const __nv_bfloat16* qp = q + (size_t)bh * g * D;
  for (int i = tid; i < g * D; i += D) qs[i / D][i % D] = __bfloat162float(qp[i]);

  const unsigned char* mrow = mask + (size_t)row * T;
  bool valid = false;
  if (tid < kDecodeChunk) {
    if (tid < n) valid = mrow[j0 + tid] != 0;
    ok[tid] = valid;
  }
  if (!__syncthreads_or(valid)) {  // no valid column: the chunk adds nothing
    if (tid < g) {
      ml[2 * tid] = -1e30f;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  float qr[kMaxGroups][E];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[gi][e] = gi < g ? qs[gi][lane * E + e] : 0.f;
  }

  // scores q.k / sqrt(d), masked columns at -1e30
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  const int gi_lane = (lane / 4) % kMaxGroups;  // the query head this lane's sum is for
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int jj = warp + kW * u;
    float kf[E], s[kMaxGroups];
    unpack_bf16<E>(kw[u], kf);
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      s[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s[gi] = fmaf(qr[gi][e], kf[e], s[gi]);
    }
    const float sum = warp_sum_groups(s);
    if (lane % 4 == 0 && gi_lane < g) p[gi_lane][jj] = ok[jj] ? sum * inv_sqrt_d : -1e30f;
  }
  __syncthreads();

  // softmax statistics of the chunk, one warp per query head; p = 0 exactly
  // on masked columns
  for (int gi = warp; gi < g; gi += kW) {
    const float a = p[gi][lane], c = p[gi][lane + 32];
    const float mx = warp_max(fmaxf(a, c));
    const float pa = ok[lane] ? expf(a - mx) : 0.f;
    const float pc = ok[lane + 32] ? expf(c - mx) : 0.f;
    p[gi][lane] = pa;
    p[gi][lane + 32] = pc;
    const float l = warp_sum(pa + pc);
    if (lane == 0) {
      ml[2 * gi] = mx;
      ml[2 * gi + 1] = l;
    }
  }
  __syncthreads();

  // unnormalized PV: each warp over its columns, then a sum over the warps
  float acc[kMaxGroups][E];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int jj = warp + kW * u;
    if (!ok[jj]) continue;  // warp-uniform; also keeps whatever a masked row holds out
    float vf[E];
    unpack_bf16<E>(vw[u], vf);
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      const float pj = p[gi][jj];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[gi][e] = fmaf(pj, vf[e], acc[gi][e]);
    }
  }
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
#pragma unroll
    for (int e = 0; e < E; ++e) red[warp][gi][lane * E + e] = acc[gi][e];
  }
  __syncthreads();
  float* ap = part_acc + ((size_t)bh * chunks + chunk) * g * D + tid;
  for (int gi = 0; gi < g; ++gi) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kW; ++w) a += red[w][gi][tid];
    ap[(size_t)gi * D] = a;
  }
}

// One block per (query head, row * kv + kv head); D threads, one per output
// column. Each thread starts its loads of the chunks' accumulators (up to
// kMergeBatch at a time) while warp 0 turns the chunks' (max, sum) pairs into
// normalized weights, 0 for a chunk with no valid column: such a chunk wrote
// no accumulator, so its loaded value is dropped, never multiplied. Dynamic
// shared memory: chunks floats.
constexpr int kMergeBatch = 16;

template <int D>
__global__ void __launch_bounds__(D)
flash_decode_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                          __nv_bfloat16* __restrict__ out, int g, int chunks) {
  extern __shared__ float weight[];  // [chunks]
  const int gi = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const float* ml = part_ml + (size_t)bh * chunks * g * 2 + gi * 2;  // chunk s at s * g * 2
  const float* acc = part_acc + ((size_t)bh * chunks * g + gi) * D + tid;  // at s * g * D
  float x[kMergeBatch];
#pragma unroll
  for (int s = 0; s < kMergeBatch; ++s)
    x[s] = s < chunks ? acc[(size_t)s * g * D] : 0.f;
  if (tid < 32) {
    float mx = -1e30f;
    for (int s = tid; s < chunks; s += 32) mx = fmaxf(mx, ml[(size_t)s * g * 2]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = tid; s < chunks; s += 32) {
      const float ls = ml[(size_t)s * g * 2 + 1];
      const float w = ls > 0.f ? expf(ml[(size_t)s * g * 2] - mx) : 0.f;
      weight[s] = w;
      l = fmaf(ls, w, l);
    }
    const float inv = 1.f / fmaxf(warp_sum(l), 1e-20f);
    for (int s = tid; s < chunks; s += 32) weight[s] *= inv;
  }
  __syncthreads();
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < kMergeBatch; ++s)
    if (s < chunks && weight[s] != 0.f) a = fmaf(weight[s], x[s], a);
  for (int s0 = kMergeBatch; s0 < chunks; s0 += kMergeBatch) {
#pragma unroll
    for (int s = 0; s < kMergeBatch; ++s)
      x[s] = s0 + s < chunks ? acc[(size_t)(s0 + s) * g * D] : 0.f;
#pragma unroll
    for (int s = 0; s < kMergeBatch; ++s)
      if (s0 + s < chunks && weight[s0 + s] != 0.f) a = fmaf(weight[s0 + s], x[s], a);
  }
  out[((size_t)bh * g + gi) * D + tid] = __float2bfloat16(a);
}

// The merge launch: per (query head, row) of `rows` = b * kv rows, weights
// the `chunks` partials of part_ml [rows, chunks, g, 2] and part_acc [rows,
// chunks, g, d] by their maxima, skips a chunk whose sum is 0 without reading
// its accumulator's value, divides by max(sum, 1e-20) and writes out [rows,
// g, d] in bf16. d is 64 or 128.
static cudaError_t launch_flash_decode_merge(const float* part_ml, const float* part_acc,
                                             __nv_bfloat16* out, int rows, int g, int chunks,
                                             int d, cudaStream_t stream) {
  const size_t smem = (size_t)chunks * sizeof(float);
  if (d == 128)
    flash_decode_merge_kernel<128><<<dim3(g, rows), 128, smem, stream>>>(part_ml, part_acc, out,
                                                                        g, chunks);
  else if (d == 64)
    flash_decode_merge_kernel<64><<<dim3(g, rows), 64, smem, stream>>>(part_ml, part_acc, out, g,
                                                                      chunks);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int D>
static cudaError_t launch_flash_decode_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                         const __nv_bfloat16* v, const unsigned char* mask,
                                         float* part_ml, float* part_acc, __nv_bfloat16* out,
                                         int b, int kv, int g, int T, cudaStream_t stream) {
  const int chunks = (T + kDecodeChunk - 1) / kDecodeChunk;
  flash_decode_split_kernel<D><<<dim3(chunks, b * kv), D, 0, stream>>>(
      q, k, v, mask, part_ml, part_acc, kv, g, T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_flash_decode_merge(part_ml, part_acc, out, b * kv, g, chunks, D, stream);
}

cudaError_t launch_flash_decode(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                const __nv_bfloat16* v, const unsigned char* mask,
                                float* part_ml, float* part_acc, __nv_bfloat16* out, int b,
                                int kv, int g, int T, int d, cudaStream_t stream) {
  if (d == 128)
    return launch_flash_decode_d<128>(q, k, v, mask, part_ml, part_acc, out, b, kv, g, T,
                                      stream);
  if (d == 64)
    return launch_flash_decode_d<64>(q, k, v, mask, part_ml, part_acc, out, b, kv, g, T,
                                     stream);
  return cudaErrorInvalidValue;
}

}  // namespace agk

// C entry. Device pointers to contiguous tensors: q, out [b, kv, g, d] and
// k, v [b, kv, T, d] bf16; mask [b, T] bool; part_ml, part_acc f32 scratch
// (see flash_decode.cuh). The wrapper in affectgpt_tpu_torch/ops/
// decode_attention.py checks shapes, dtypes and limits. Returns the first
// CUDA error of the two launches, or 0.
extern "C" int agk_decode_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* mask, void* part_ml, void* part_acc,
                                         void* out, int b, int kv, int g, int T, int d,
                                         void* stream) {
  return (int)agk::launch_flash_decode(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const unsigned char*>(mask),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc),
      static_cast<__nv_bfloat16*>(out), b, kv, g, T, d, static_cast<cudaStream_t>(stream));
}
