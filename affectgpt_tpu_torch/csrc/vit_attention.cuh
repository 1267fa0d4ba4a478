// Non-causal short-sequence attention of the ViT / HuBERT encoders on Hopper
// (sm_90a), shared by vit_attention.cu (the attention alone) and
// vit_sublayer.cu (the whole attention sublayer).
//
// out = softmax(q k^T / sqrt(d), keys >= valid_len masked) v per (image,
// head), head_dim 64, n <= 512. The TPU kernel
// (affectgpt_tpu/ops/vit_attention_pallas.py::_kernel) holds a whole score
// row on chip, normalizes p, rounds p to bf16 and only then multiplies by v:
// a streaming (flash) softmax would round the unnormalized p instead and
// compute another function in bf16. So each query row's max and sum are
// found first (pass 1, online over 64-key tiles), and pass 2 recomputes the
// scores, forms p = exp(s - max) / sum, rounds it to bf16 and accumulates
// p v in f32; the output is rounded once. The scores are recomputed rather
// than stored: at head_dim 64 the two q k^T products cost less than a
// [rows, n] f32 score tile in shared memory would.
//
// One block of 8 warps per (head, image) stages that head's K and V rows in
// shared memory (n rounded up to 64, zero-filled past n, rows padded by 8
// bf16 so fragment loads hit distinct banks) and each warp walks 16-row
// query slabs. Keys at or past valid_len give p = 0 exactly; query rows at or
// past valid_len (but below n) are computed and attend to the valid keys, as
// on the TPU. q, k, v and out are addressed through element strides of
// their batch, head and token axes (head_dim contiguous), so the [b, n, h, d]
// layout of a fused projection is read without a transpose.
//
// Bound: bytes. For CLIP ViT-L (64 images, n = 257, 16 heads) the q k^T and
// p v products are 17.3 GFLOP against 134.7 MB of q, k, v and out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemv_tile.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace vit {

constexpr int kAttnThreads = 256;
constexpr int kAttnD = 64;
constexpr int kAttnKeys = 64;  // keys per tile
constexpr int kAttnMaxN = 512;
constexpr int kAttnLD = kAttnD + 8;

struct AttnStrides {
  long long b, h, n;  // element strides; head_dim is contiguous
};

static inline size_t attn_smem_bytes(int n) {
  const int n_pad = (n + kAttnKeys - 1) / kAttnKeys * kAttnKeys;
  return 2 * (size_t)n_pad * kAttnLD * sizeof(__nv_bfloat16);
}

// S = Q K^T for a warp's 16 query rows and the 64 keys from k0 (raw dot
// products, f32).
__device__ __forceinline__ void attn_scores(float s[8][4], const uint32_t qa[4][4],
                                            const __nv_bfloat16* ks, int k0) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kr = ks + (k0 + nt * 8 + gid) * kAttnLD + tig * 2;
#pragma unroll
    for (int kk = 0; kk < kAttnD / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
      mma_bf16(s[nt], qa[kk], b0, b1);
    }
  }
}

// Grid (heads, b), kAttnThreads threads, attn_smem_bytes(n) of dynamic
// shared memory.
static __global__ void __launch_bounds__(kAttnThreads)
vit_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     AttnStrides in, AttnStrides os, int n, int valid_len, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_pad = (n + kAttnKeys - 1) / kAttnKeys * kAttnKeys;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [n_pad][LD]
  __nv_bfloat16* vs = ks + (size_t)n_pad * kAttnLD;             // [n_pad][LD]
  const int hi = blockIdx.x, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const size_t base = (size_t)bi * in.b + (size_t)hi * in.h;
  const __nv_bfloat16* qh = q + base;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int i = tid; i < n_pad * (kAttnD / 8); i += kAttnThreads) {
    const int r = i / (kAttnD / 8), c = (i % (kAttnD / 8)) * 8;
    const bool live = r < n;
    const size_t off = base + (size_t)r * in.n + c;
    *reinterpret_cast<uint4*>(ks + r * kAttnLD + c) =
        live ? *reinterpret_cast<const uint4*>(k + off) : zero;
    *reinterpret_cast<uint4*>(vs + r * kAttnLD + c) =
        live ? *reinterpret_cast<const uint4*>(v + off) : zero;
  }
  __syncthreads();

  const int k_end = (valid_len + kAttnKeys - 1) / kAttnKeys * kAttnKeys;
  for (int q0 = warp * 16; q0 < n; q0 += (kAttnThreads / 32) * 16) {
    const int rows[2] = {q0 + gid, q0 + gid + 8};
    uint32_t qa[kAttnD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kAttnD / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          qa[kk][2 * half + i] =
              rows[i] < n ? *reinterpret_cast<const uint32_t*>(
                                qh + (size_t)rows[i] * in.n + c + half * 8)
                          : 0u;
      }
    }

    // pass 1: each row's max and sum over the valid keys (online)
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < k_end; k0 += kAttnKeys) {
      float s[8][4];
      attn_scores(s, qa, ks, k0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + nt * 8 + tig * 2 + e < valid_len) mx = fmaxf(mx, s[nt][2 * i + e] * scale_log2);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + nt * 8 + tig * 2 + e < valid_len) rs += exp2f(s[nt][2 * i + e] * scale_log2 - mx);
        l[i] = l[i] * exp2f(m[i] - mx) + rs;
        m[i] = mx;
      }
    }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float li = l[i];
      li += __shfl_xor_sync(0xffffffffu, li, 1);
      li += __shfl_xor_sync(0xffffffffu, li, 2);
      inv[i] = 1.f / li;
    }

    // pass 2: p = exp(s - max) / sum, rounded to bf16, then O += P V
    float o[kAttnD / 8][4];
#pragma unroll
    for (int j = 0; j < kAttnD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int k0 = 0; k0 < k_end; k0 += kAttnKeys) {
      float s[8][4];
      attn_scores(s, qa, ks, k0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            s[nt][2 * i + e] = k0 + nt * 8 + tig * 2 + e < valid_len
                                   ? exp2f(s[nt][2 * i + e] * scale_log2 - m[i]) * inv[i]
                                   : 0.f;
#pragma unroll
      for (int kk = 0; kk < kAttnKeys / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const __nv_bfloat16* vrow =
            vs + (k0 + kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kAttnLD + (lane / 16) * 8;
#pragma unroll
        for (int j = 0; j < kAttnD / 8; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + j * 8);
          mma_bf16(o[j], pa, b[0], b[1]);
          mma_bf16(o[j + 1], pa, b[2], b[3]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] >= n) continue;
      __nv_bfloat16* op =
          out + (size_t)bi * os.b + (size_t)hi * os.h + (size_t)rows[i] * os.n + tig * 2;
#pragma unroll
      for (int j = 0; j < kAttnD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
            __floats2bfloat162_rn(o[j][2 * i], o[j][2 * i + 1]);
    }
  }
}

static inline cudaError_t launch_vit_attention(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                               const __nv_bfloat16* v, __nv_bfloat16* out,
                                               int b, int heads, int n, int valid_len,
                                               AttnStrides in, AttnStrides os,
                                               cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(vit_attention_kernel, attn_smem_bytes(kAttnMaxN), &granted);
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)kAttnD);  // log2(e) / sqrt(d)
  vit_attention_kernel<<<dim3(heads, b), kAttnThreads, attn_smem_bytes(n), stream>>>(
      q, k, v, out, in, os, n, valid_len, scale_log2);
  return cudaGetLastError();
}

}  // namespace vit
}  // namespace agk
