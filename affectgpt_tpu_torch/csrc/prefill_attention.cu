// Causal prefill attention with segment ids and GQA on Hopper (sm_90a).
//
// Replaces models/qwen2.py::_flash_prefill_attention of the JAX package,
// which calls JAX's stock TPU flash-attention Pallas op
// (jax.experimental.pallas.ops.tpu.flash_attention) after repeating K/V
// `groups` times so that q and kv head counts match.
//
// Bound: operations. Per layer at b = 8, t = 564, Qwen2.5-7B width the
// causal half of QK^T and PV is ~18 GFLOP against ~74 MB of q/k/v/out, so the
// tensor cores bound it, as long as the [t, t] scores stay on chip. The
// plain chain it replaces scores every query against all max_len cache
// columns in f32 (a [b, kv, g, t, max_len] f32 tensor, ~323 MB per layer).
// Design (FlashAttention-2 on mma.sync): one block of 4 warps per (query
// tile of 64 rows, q head, row); each warp owns 16 query rows. The block
// walks the key tiles of 64 up to the causal diagonal; each tile's K and V
// are staged in shared memory (rows padded by 8 bf16 so that fragment loads
// hit 32 distinct banks). S = Q K^T and O += P V run as bf16
// m16n8k16 products with f32 accumulation; the softmax is online, in f32,
// with P rounded to bf16 for the PV product; O is rounded to bf16 once at the
// end. The kv head is h / groups, so K/V are never repeated in memory. A key
// j is visible to query i iff j <= i and seg[j] == seg[i]; masked scores
// give p = 0 exactly, and a tile's ragged tail (t is not a multiple of 64)
// is zero-filled and masked. Every row sees at least itself, so no
// denominator is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace agk {

constexpr int kTile = 64;  // query rows per block and keys per tile
constexpr int kPrefillThreads = 128;

// Grid (query tiles, heads, b), 128 threads. Fragment layouts are those of
// mma.m16n8k16 (PTX ISA): with gid = lane / 4 and tig = lane % 4, a thread
// holds accumulator rows gid and gid + 8, columns 2 * tig and 2 * tig + 1 of
// each 8-column tile.
template <int D>
__global__ void __launch_bounds__(kPrefillThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                         __nv_bfloat16* __restrict__ out, int t, int heads, int kv,
                         float scale_log2) {
  constexpr int LD = D + 8;         // shared row stride, bf16
  constexpr int VEC = D / 8;        // 16-byte vectors per row
  constexpr int NT = kTile / 8;     // 8-key tiles of S
  constexpr int DT = D / 8;         // 8-column tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * LD];
  __shared__ int segk[kTile];

  const int q0 = blockIdx.x * kTile, hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (heads / kv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t q_row = (size_t)heads * D;  // stride of q and out over t
  const __nv_bfloat16* kh = k + ((size_t)bi * kv + hk) * t * D;
  const __nv_bfloat16* vh = v + ((size_t)bi * kv + hk) * t * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // stage the query tile in ks, then keep the warp's A fragments in registers
  for (int i = tid; i < kTile * VEC; i += kPrefillThreads) {
    const int r = i / VEC, c = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(ks + r * LD + c) =
        q0 + r < t ? *reinterpret_cast<const uint4*>(q + ((size_t)bi * t + q0 + r) * q_row +
                                                     (size_t)hq * D + c)
                   : zero;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
  const int ra = warp * 16 + gid;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(ks + ra * LD + c);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(ks + (ra + 8) * LD + c);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(ks + ra * LD + c + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(ks + (ra + 8) * LD + c + 8);
  }
  __syncthreads();

  const int qrow[2] = {q0 + ra, q0 + ra + 8};
  int qseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qseg[i] = qrow[i] < t ? seg[(size_t)bi * t + qrow[i]] : 0;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  const int k_end = min(t, q0 + kTile);  // keys up to the tile's last query row
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    for (int i = tid; i < kTile * VEC; i += kPrefillThreads) {
      const int r = i / VEC, c = (i % VEC) * 8;
      const bool in = k0 + r < t;
      const size_t off = (size_t)(k0 + r) * D + c;
      *reinterpret_cast<uint4*>(ks + r * LD + c) =
          in ? *reinterpret_cast<const uint4*>(kh + off) : zero;
      *reinterpret_cast<uint4*>(vs + r * LD + c) =
          in ? *reinterpret_cast<const uint4*>(vh + off) : zero;
    }
    if (tid < kTile) segk[tid] = k0 + tid < t ? seg[(size_t)bi * t + k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nt * 8 + gid) * LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }

    // mask, then the online softmax update of rows gid (i = 0) and gid + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t vis = 0u;
      float mx = m[i];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + tig * 2 + e;
          const int key = k0 + col;
          if (key <= qrow[i] && key < t && segk[col] == qseg[i]) {
            vis |= 1u << (nt * 2 + e);
            s[nt][2 * i + e] *= scale_log2;
            mx = fmaxf(mx, s[nt][2 * i + e]);
          }
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = (vis >> (nt * 2 + e)) & 1u ? exp2f(s[nt][2 * i + e] - mx) : 0.f;
          s[nt][2 * i + e] = p;
          rs += p;
        }
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

    // O += P V: P from the S accumulators, V fragments by transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow =
          vs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vrow + j * 8);
        mma_bf16(o[j], pa, b[0], b[1]);
        mma_bf16(o[j + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (qrow[i] >= t) continue;
    const float inv = 1.f / li;
    __nv_bfloat16* op = out + ((size_t)bi * t + qrow[i]) * q_row + (size_t)hq * D + tig * 2;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

template <int D>
static cudaError_t launch_prefill(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const int* seg, __nv_bfloat16* out,
                                  int b, int t, int heads, int kv, cudaStream_t stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);  // log2(e) / sqrt(d)
  prefill_attention_kernel<D><<<dim3((t + kTile - 1) / kTile, heads, b), kPrefillThreads, 0,
                                stream>>>(q, k, v, seg, out, t, heads, kv, scale_log2);
  return cudaGetLastError();
}

}  // namespace agk

// C entry. Device pointers to contiguous tensors: q [b, t, heads, d],
// k, v [b, kv, t, d] and out [b, t, heads * d] bf16; seg [b, t] int32. The
// wrapper in affectgpt_tpu_torch/ops/prefill_attention.py checks shapes,
// dtypes and limits (d is 64 or 128, heads % kv == 0). Returns
// cudaGetLastError() after the launch.
extern "C" int agk_prefill_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* seg, void* out, int b, int t, int heads,
                                          int kv, int d, void* stream) {
  using namespace agk;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* sp = static_cast<const int*>(seg);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return (int)launch_prefill<128>(qp, kp, vp, sp, op, b, t, heads, kv, st);
  if (d == 64) return (int)launch_prefill<64>(qp, kp, vp, sp, op, b, t, heads, kv, st);
  return (int)cudaErrorInvalidValue;
}
