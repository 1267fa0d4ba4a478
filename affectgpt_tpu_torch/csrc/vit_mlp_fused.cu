// Single-launch pre-LN MLP sublayer of the ViT / HuBERT encoders on Hopper
// (sm_90a): y = x + fc2(act(fc1(LN(x)))) with no intermediate in device
// memory.
//
// Replaces affectgpt_tpu/ops/vit_mlp_fused_pallas.py::mlp_sublayer_fused
// (its pallas_calls, :161 `_kernel_f32acc` and :167 `_kernel_bf16acc`). The
// intermediate dim I is cut into k_chunks chunks of kc columns; per chunk
// the partial P_k = act(h W_in[:, chunk] + b_in[chunk]) (rounded to bf16)
// @ W_out[chunk, :] is an f32 sum. The two accumulations of the TPU kernel
// are two functions, and both are kept:
//   bf16: out = bf16(x + b_out + P_0), then out = bf16(out + P_k) for each
//         later chunk (the TPU kernel's bf16 output block);
//   f32:  out = x + b_out + P_0 + P_1 + ... in f32, rounded once.
//
// Bound: operations, as the two-call pair (vit_mlp.cu): 276 GFLOP a CLIP
// layer at 64 images. Design: one block of 8 warps per tile of BM rows (32
// with the bf16 accumulator, 16 with the f32 one, whose out tile is twice as
// large). The block LayerNorms its rows into shared memory once, then for
// each chunk computes the [BM, kc] chunk of t into shared memory (bf16) and
// folds t W_out[chunk, :] into the out tile, which also lives in shared
// memory; only x is read and y written. Every product runs on mma.sync with
// the shared-memory rows as A and the weights streamed as B in 32-row
// slices of up to 256 columns (cp.async, double-buffered; each warp owns 32
// of the 256 columns). Every row tile streams all 2 * w * I weights (16 MB
// for CLIP), mostly from L2: that is this design's cost against the pair,
// which reads them once per 128-row tile.

#include <type_traits>

#include "vit_gemm.cuh"

namespace agk {
namespace vit {

constexpr int kFusedThreads = 256;
constexpr int kSlab = 256;  // columns of B per staged slice: 8 warps x 32
constexpr int kSlabK = 32;  // rows of B per staged slice
constexpr int kSlabLD = kSlab + 8;

// acc[MT][4][4] = As[16 * MT rows, K] (shared, row stride lda) @ B[K, nw]
// (global, row stride ldb): the warp owns columns [32 * warp, 32 * warp + 32)
// of the slab, nw <= kSlab of which are live (nw % 8 == 0; B is zero-filled
// past them). K % kSlabK == 0. bst holds two staged slices.
template <int MT>
__device__ __forceinline__ void slab_gemm(const __nv_bfloat16* As, int lda, int K,
                                          const __nv_bfloat16* __restrict__ B, int ldb, int nw,
                                          __nv_bfloat16* bst, float acc[MT][4][4]) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  auto load = [&](int stage, int k0) {
    __nv_bfloat16* bs = bst + stage * kSlabK * kSlabLD;
#pragma unroll
    for (int it = 0; it < kSlabK * (kSlab / 8) / kFusedThreads; ++it) {
      const int i = tid + it * kFusedThreads;
      const int r = i / (kSlab / 8), c = (i % (kSlab / 8)) * 8;
      const bool in = c < nw;
      cp_async16(bs + r * kSlabLD + c, B + (size_t)(k0 + r) * ldb + (in ? c : 0), in);
    }
  };
  const bool live = warp * 32 < nw;  // warp-uniform: nw % 32 may be 8, 16 or 24
  const int tiles = K / kSlabK;
  __syncthreads();  // As is written and the previous user of bst is done
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load((t + 1) & 1, (t + 1) * kSlabK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* bs = bst + (t & 1) * kSlabK * kSlabLD;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kSlabK / 16; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], As + (mt * 16 + lane % 16) * lda + t * kSlabK + kk * 16 +
                                  (lane / 16) * 8);
        const __nv_bfloat16* br =
            bs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kSlabLD + warp * 32 +
            (lane / 16) * 8;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, br + j * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][j], af[mt], b[0], b[1]);
            mma_bf16(acc[mt][j + 1], af[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this slice before it is refilled
  }
}

template <bool F32ACC>
struct OutTile {
  using T = typename std::conditional<F32ACC, float, __nv_bfloat16>::type;
};

// Grid (ceil(M / BM)), kFusedThreads threads, fused_smem_bytes of dynamic
// shared memory: hs [BM][w + 8] bf16, ts [BM][kc + 8] bf16, the out tile
// [BM][w + 8] (bf16 or f32), two B slices.
template <int BM, bool F32ACC, int ACT>
static __global__ void __launch_bounds__(kFusedThreads)
vit_mlp_fused_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ lns,
                     const __nv_bfloat16* __restrict__ lnb, const __nv_bfloat16* __restrict__ w_in,
                     const __nv_bfloat16* __restrict__ b_in, const __nv_bfloat16* __restrict__ w_out,
                     const __nv_bfloat16* __restrict__ b_out, __nv_bfloat16* __restrict__ y, int M,
                     int w, int inter, int kc, float eps) {
  using OT = typename OutTile<F32ACC>::T;
  constexpr int MT = BM / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldh = w + 8, ldt = kc + 8;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ts = hs + BM * ldh;
  OT* os = reinterpret_cast<OT*>(ts + BM * ldt);
  __nv_bfloat16* bst = reinterpret_cast<__nv_bfloat16*>(os + BM * ldh);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int m0 = blockIdx.x * BM;

  // LayerNorm of the tile's rows into hs; rows past M are zero
  for (int r = warp; r < BM; r += kFusedThreads / 32) {
    if (m0 + r < M) {
      layernorm_row(x + (size_t)(m0 + r) * w, lns, lnb, hs + r * ldh, w, eps);
    } else {
      for (int c = lane * 8; c < w; c += 32 * 8)
        *reinterpret_cast<uint4*>(hs + r * ldh + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  float acc[MT][4][4];
  const int chunks = inter / kc;
  for (int ch = 0; ch < chunks; ++ch) {
    // t = act(h W_in[:, chunk] + b_in[chunk]), rounded to bf16, into ts
    for (int s0 = 0; s0 < kc; s0 += kSlab) {
      const int nw = min(kSlab, kc - s0);
      const int c0 = ch * kc + s0;
      slab_gemm<MT>(hs, ldh, w, w_in + c0, inter, nw, bst, acc);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = warp * 32 + nt * 8 + tig * 2;
        if (col >= nw) continue;
        const float b0 = bf2f(b_in[c0 + col]), b1 = bf2f(b_in[c0 + col + 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<uint32_t*>(ts + (mt * 16 + gid + 8 * i) * ldt + s0 + col) =
                pack_bf16x2(activate<ACT>(acc[mt][nt][2 * i] + b0),
                            activate<ACT>(acc[mt][nt][2 * i + 1] + b1));
      }
    }
    // out (+)= t W_out[chunk, :]
    for (int s0 = 0; s0 < w; s0 += kSlab) {
      const int nw = min(kSlab, w - s0);
      slab_gemm<MT>(ts, ldt, kc, w_out + (size_t)ch * kc * w + s0, w, nw, bst, acc);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = s0 + warp * 32 + nt * 8 + tig * 2;
        if (col >= s0 + nw) continue;
        const float b0 = bf2f(b_out[col]), b1 = bf2f(b_out[col + 1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = mt * 16 + gid + 8 * i;
            float base0, base1;
            if (ch == 0) {
              float2 xv = make_float2(0.f, 0.f);
              if (m0 + r < M)
                xv = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)(m0 + r) * w + col));
              base0 = xv.x + b0;
              base1 = xv.y + b1;
            } else if constexpr (F32ACC) {
              const float2 o = *reinterpret_cast<const float2*>(os + r * ldh + col);
              base0 = o.x;
              base1 = o.y;
            } else {
              const float2 o =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(os + r * ldh + col));
              base0 = o.x;
              base1 = o.y;
            }
            const float v0 = base0 + acc[mt][nt][2 * i], v1 = base1 + acc[mt][nt][2 * i + 1];
            if constexpr (F32ACC)
              *reinterpret_cast<float2*>(os + r * ldh + col) = make_float2(v0, v1);
            else
              *reinterpret_cast<__nv_bfloat162*>(os + r * ldh + col) =
                  __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
  __syncthreads();

  // the out tile to y, rounded once (bf16 tiles already are)
  for (int i = tid; i < BM * (w / 2); i += kFusedThreads) {
    const int r = i / (w / 2), c = (i % (w / 2)) * 2;
    if (m0 + r >= M) continue;
    __nv_bfloat162 val;
    if constexpr (F32ACC) {
      const float2 o = *reinterpret_cast<const float2*>(os + r * ldh + c);
      val = __floats2bfloat162_rn(o.x, o.y);
    } else {
      val = *reinterpret_cast<const __nv_bfloat162*>(os + r * ldh + c);
    }
    *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(m0 + r) * w + c) = val;
  }
}

static size_t fused_smem_bytes(int bm, bool f32acc, int w, int kc) {
  return (size_t)bm * (w + 8) * 2 + (size_t)bm * (kc + 8) * 2 +
         (size_t)bm * (w + 8) * (f32acc ? 4 : 2) + 2 * (size_t)kSlabK * kSlabLD * 2;
}

template <int BM, bool F32ACC, int ACT>
static cudaError_t launch_fused(const __nv_bfloat16* x, const __nv_bfloat16* lns,
                                const __nv_bfloat16* lnb, const __nv_bfloat16* w_in,
                                const __nv_bfloat16* b_in, const __nv_bfloat16* w_out,
                                const __nv_bfloat16* b_out, __nv_bfloat16* y, int M, int w,
                                int inter, int kc, float eps, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  const size_t smem = fused_smem_bytes(BM, F32ACC, w, kc);
  cudaError_t err = ensure_smem(vit_mlp_fused_kernel<BM, F32ACC, ACT>, smem, &granted);
  if (err != cudaSuccess) return err;
  vit_mlp_fused_kernel<BM, F32ACC, ACT><<<(M + BM - 1) / BM, kFusedThreads, smem, stream>>>(
      x, lns, lnb, w_in, b_in, w_out, b_out, y, M, w, inter, kc, eps);
  return cudaGetLastError();
}

}  // namespace vit
}  // namespace agk

// C entry. Device pointers to contiguous bf16 tensors: x, y [rows, w]; LN
// scale and bias [w]; w_in [w, I], b_in [I], w_out [I, w], b_out [w].
// k_chunks divides I (the wrapper rounds it as the TPU wrapper does); act is
// 1 (quick_gelu) or 2 (gelu); f32acc selects the accumulation. The wrapper in
// affectgpt_tpu_torch/ops/vit_mlp_fused.py checks shapes and limits (w and
// kc multiples of 32, at most 1024). Returns cudaGetLastError() after the
// launch.
extern "C" int agk_vit_mlp_fused_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                      const void* w_in, const void* b_in, const void* w_out,
                                      const void* b_out, void* y, int rows, int w, int inter,
                                      int k_chunks, int act, int f32acc, float eps,
                                      void* stream) {
  using namespace agk::vit;
  using bf = __nv_bfloat16;
  if (k_chunks < 1 || inter % k_chunks) return (int)cudaErrorInvalidValue;
  const int kc = inter / k_chunks;
  if (w % 32 || kc % 32 || w > 1024 || kc > 1024 || (act != kActQuickGelu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  const auto* xp = static_cast<const bf*>(x);
  const auto* ls = static_cast<const bf*>(ln_scale);
  const auto* lb = static_cast<const bf*>(ln_bias);
  const auto* wi = static_cast<const bf*>(w_in);
  const auto* bi = static_cast<const bf*>(b_in);
  const auto* wo = static_cast<const bf*>(w_out);
  const auto* bo = static_cast<const bf*>(b_out);
  auto* yp = static_cast<bf*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32acc)
    return (int)(act == kActGelu
                     ? launch_fused<16, true, kActGelu>(xp, ls, lb, wi, bi, wo, bo, yp, rows, w,
                                                        inter, kc, eps, st)
                     : launch_fused<16, true, kActQuickGelu>(xp, ls, lb, wi, bi, wo, bo, yp, rows,
                                                             w, inter, kc, eps, st));
  return (int)(act == kActGelu
                   ? launch_fused<32, false, kActGelu>(xp, ls, lb, wi, bi, wo, bo, yp, rows, w,
                                                       inter, kc, eps, st)
                   : launch_fused<32, false, kActQuickGelu>(xp, ls, lb, wi, bi, wo, bo, yp, rows,
                                                            w, inter, kc, eps, st));
}
