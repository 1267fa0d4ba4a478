// Decode attention over a paged KV cache on Hopper (sm_90a): one query token
// per row, GQA, keys and values gathered from a block pool through per-row
// block tables, online softmax in f32. Two variants of one kernel: bf16
// pools, and int8 pools with f32 per-row scales.
//
// Replaces the Pallas kernel affectgpt_tpu/ops/paged_attention_pallas.py::
// paged_attention_pallas (`_kernel` and `_kernel_int8`).
//
// Layouts: q and out [b, H, d] bf16 (head h = kv head * g + group); pools
// [blocks, block, kv, d]; scales [blocks, block, kv] f32, read as stored;
// tables [b, width] int32 (padded with block 0, the null page); seq_lens [b]
// int32. Token p of row r lies in page tables[r, p / block] at offset
// p % block; one kv head's part of a page is `block` rows of d values,
// strided by kv * d.
//
// Bound: page bytes. Each valid token's K and V rows (2 * kv * d values, 2
// KiB a token per layer in bf16 at Qwen2.5-7B width, half that plus 32 bytes
// of scales in int8) are read once and used for 2 * g multiply-adds per
// value, far below the tensor-core rate. The TPU kernel walked a row's pages
// in order on a sequential grid of (row, page), carrying the softmax state in
// scratch, one (row) cell per core step; that gives b * kv = 64 independent
// (row, kv head) pairs at 16 slots for 132 SMs. Here each row's tokens are
// split into chunks of 64 (4 pages of 16), one block per (chunk, row, kv
// head), which loads its own block-table entries (no scalar prefetch); a
// chunk at or past the row's seq_len writes an empty partial and returns, so
// the work follows the tokens, not the table's width. A second launch
// merges the chunks' (max, sum, accumulator) in a fixed order
// (csrc/flash_decode.cuh, shared with the dense-cache decode kernels):
// deterministic, no atomics. A block starts every K/V load of its chunk (and
// the int8 scales) before the first wait, so a chunk costs about one memory
// latency. Arithmetic follows the TPU kernel: f32 scores q.k / sqrt(d), an
// int8 page's key scale folded into the score and its value scale into the
// PV weight only (the softmax sum runs over the unscaled p,
// paged_attention_pallas.py:175-177), tokens past seq_len at p = 0, a row
// with no valid token 0 through max(sum, 1e-20), one rounding to bf16.

#include "flash_decode.cuh"

namespace agk {

// E consecutive values of a pool row, loaded as one word (or zeros) and
// unpacked to f32: bf16 pools (2 * E bytes) and int8 pools (E bytes).
template <typename T, int E>
struct RowPart;

template <int E>
struct RowPart<__nv_bfloat16, E> {
  uint32_t w[E / 2];
  __device__ __forceinline__ void load(const __nv_bfloat16* src, bool in) {
    load_row_part<E>(src, in, w);
  }
  __device__ __forceinline__ void unpack(float (&f)[E]) const { unpack_bf16<E>(w, f); }
};

template <int E>
struct RowPart<int8_t, E> {
  uint32_t w;
  __device__ __forceinline__ void load(const int8_t* src, bool in) {
    if constexpr (E == 4)
      w = in ? __ldg(reinterpret_cast<const unsigned int*>(src)) : 0u;
    else
      w = in ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(src)) : 0u;
  }
  __device__ __forceinline__ void unpack(float (&f)[E]) const {
#pragma unroll
    for (int i = 0; i < E; ++i) f[i] = (float)(int8_t)(w >> (8 * i));
  }
};

// One block per (chunk, row * kv + kv head); D threads, D / 32 warps. Warp
// w owns the chunk's tokens w, w + D/32, ...; lane l holds values
// [l*E, l*E + E) of each of their K and V rows and of the q rows.
template <int D, typename T>
__global__ void __launch_bounds__(D)
paged_split_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const int* __restrict__ tables,
                   const int* __restrict__ seq_lens, float* __restrict__ part_ml,
                   float* __restrict__ part_acc, int kv, int g, int width, int blk) {
  constexpr bool kInt8 = sizeof(T) == 1;
  constexpr int kW = D / 32;              // warps
  constexpr int E = D / 32;               // values of a row per lane
  constexpr int KPW = kDecodeChunk / kW;  // tokens per warp
  __shared__ float qs[kMaxGroups][D];
  __shared__ float p[kMaxGroups][kDecodeChunk];
  __shared__ float red[kW][kMaxGroups][D];

  const int chunk = blockIdx.x, chunks = gridDim.x;
  const int bh = blockIdx.y;  // row * kv + kv head
  const int row = bh / kv, head = bh % kv;
  const int j0 = chunk * kDecodeChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ml = part_ml + ((size_t)bh * chunks + chunk) * g * 2;

  // the valid tokens are a prefix: below seq_len, inside the table's pages
  const int n = min(kDecodeChunk, min(seq_lens[row], width * blk) - j0);
  if (n <= 0) {  // no valid token: the chunk adds nothing
    if (tid < g) {
      ml[2 * tid] = -1e30f;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }

  const int* table = tables + (size_t)row * width;
  RowPart<T, E> kr[KPW], vr[KPW];
  float ks[KPW], vs[KPW];
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int jj = warp + kW * u;
    const bool in = jj < n;
    size_t slot = 0;  // (page, offset, kv head) row of the pool
    if (in) {
      const int pos = j0 + jj;
      slot = ((size_t)table[pos / blk] * blk + pos % blk) * kv + head;
    }
    kr[u].load(pool_k + slot * D + lane * E, in);
    vr[u].load(pool_v + slot * D + lane * E, in);
    if constexpr (kInt8) {
      ks[u] = in ? __ldg(k_scale + slot) : 0.f;
      vs[u] = in ? __ldg(v_scale + slot) : 0.f;
    } else {
      ks[u] = vs[u] = 1.f;
    }
  }
  const __nv_bfloat16* qp = q + (size_t)bh * g * D;
  for (int i = tid; i < g * D; i += D) qs[i / D][i % D] = __bfloat162float(qp[i]);
  __syncthreads();

  float qr[kMaxGroups][E];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
#pragma unroll
    for (int e = 0; e < E; ++e) qr[gi][e] = gi < g ? qs[gi][lane * E + e] : 0.f;
  }

  // scores q.k (x the key scale) / sqrt(d), tokens past n at -1e30
  const float inv_sqrt_d = 1.0f / sqrtf((float)D);
  const int gi_lane = (lane / 4) % kMaxGroups;  // the query head this lane's sum is for
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int jj = warp + kW * u;
    float kf[E], s[kMaxGroups];
    kr[u].unpack(kf);
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      s[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s[gi] = fmaf(qr[gi][e], kf[e], s[gi]);
    }
    const float sum = warp_sum_groups(s);
    if (lane % 4 == 0 && gi_lane < g) p[gi_lane][jj] = jj < n ? sum * ks[u] * inv_sqrt_d : -1e30f;
  }
  __syncthreads();

  // softmax statistics of the chunk over the unscaled p, one warp per query
  // head; p = 0 exactly past n
  for (int gi = warp; gi < g; gi += kW) {
    const float a = p[gi][lane], c = p[gi][lane + 32];
    const float mx = warp_max(fmaxf(a, c));
    const float pa = lane < n ? expf(a - mx) : 0.f;
    const float pc = lane + 32 < n ? expf(c - mx) : 0.f;
    p[gi][lane] = pa;
    p[gi][lane + 32] = pc;
    const float l = warp_sum(pa + pc);
    if (lane == 0) {
      ml[2 * gi] = mx;
      ml[2 * gi + 1] = l;
    }
  }
  __syncthreads();

  // unnormalized PV, p x the value scale: each warp over its tokens, then a
  // sum over the warps
  float acc[kMaxGroups][E];
#pragma unroll
  for (int gi = 0; gi < kMaxGroups; ++gi) {
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < KPW; ++u) {
    const int jj = warp + kW * u;
    if (jj >= n) continue;  // warp-uniform
    float vf[E];
    vr[u].unpack(vf);
#pragma unroll
    for (int gi = 0; gi < kMaxGroups; ++gi) {
      const float pj = p[gi][jj] * vs[u];
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

template <typename T>
static cudaError_t launch_paged(const void* q, const void* pool_k, const void* pool_v,
                                const void* k_scale, const void* v_scale, const void* tables,
                                const void* seq_lens, void* part_ml, void* part_acc, void* out,
                                int b, int kv, int g, int width, int blk, int d,
                                cudaStream_t stream) {
  const int chunks = (width * blk + kDecodeChunk - 1) / kDecodeChunk;
  const dim3 grid(chunks, b * kv);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* pk = static_cast<const T*>(pool_k);
  const auto* pv = static_cast<const T*>(pool_v);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* tb = static_cast<const int*>(tables);
  const auto* sl = static_cast<const int*>(seq_lens);
  auto* ml = static_cast<float*>(part_ml);
  auto* acc = static_cast<float*>(part_acc);
  if (d == 128)
    paged_split_kernel<128, T><<<grid, 128, 0, stream>>>(qb, pk, pv, ks, vs, tb, sl, ml, acc, kv,
                                                          g, width, blk);
  else if (d == 64)
    paged_split_kernel<64, T><<<grid, 64, 0, stream>>>(qb, pk, pv, ks, vs, tb, sl, ml, acc, kv,
                                                        g, width, blk);
  else
    return cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_flash_decode_merge(ml, acc, static_cast<__nv_bfloat16*>(out), b * kv, g, chunks,
                                   d, stream);
}

}  // namespace agk

// C entries. Device pointers to contiguous tensors: q, out [b, kv*g, d] bf16;
// pool_k, pool_v [blocks, blk, kv, d] bf16 (or int8, with k_scale, v_scale
// [blocks, blk, kv] f32); tables [b, width] and seq_lens [b] int32; part_ml
// [b*kv, chunks, g, 2] and part_acc [b*kv, chunks, g, d] f32 scratch, chunks
// = ceil(width * blk / 64). The wrappers in affectgpt_tpu_torch/ops/
// paged_attention.py check shapes, dtypes and limits. Each returns the first
// CUDA error of its two launches, or 0.
extern "C" int agk_paged_attention_bf16(const void* q, const void* pool_k, const void* pool_v,
                                        const void* tables, const void* seq_lens, void* part_ml,
                                        void* part_acc, void* out, int b, int kv, int g,
                                        int width, int blk, int d, void* stream) {
  return (int)agk::launch_paged<__nv_bfloat16>(q, pool_k, pool_v, nullptr, nullptr, tables,
                                               seq_lens, part_ml, part_acc, out, b, kv, g, width,
                                               blk, d, static_cast<cudaStream_t>(stream));
}

extern "C" int agk_paged_attention_int8(const void* q, const void* pool_k, const void* pool_v,
                                        const void* k_scale, const void* v_scale,
                                        const void* tables, const void* seq_lens, void* part_ml,
                                        void* part_acc, void* out, int b, int kv, int g,
                                        int width, int blk, int d, void* stream) {
  return (int)agk::launch_paged<int8_t>(q, pool_k, pool_v, k_scale, v_scale, tables, seq_lens,
                                        part_ml, part_acc, out, b, kv, g, width, blk, d,
                                        static_cast<cudaStream_t>(stream));
}
