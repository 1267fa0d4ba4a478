// Fused decode-QKV for the q=1 decode step on Hopper (sm_90a).
//
// Replaces the Pallas kernel affectgpt_tpu/ops/decode_qkv_pallas.py::decode_qkv:
// optional rmsnorm of the raw residual (rounded to bf16), the q/k/v
// projections with f32 accumulation plus bias, and half-split RoPE on q and k
// at per-row positions, in one launch.
//
// Bound: weight bytes. At b <= 64 the three projections are a GEMV sweep over
// h*(H+2kv)*d bf16 weights (33 MB per layer at Qwen2.5-7B width), each byte
// used for b multiply-adds. The TPU kernel kept the weights resident in VMEM
// and streamed batch tiles through them; here there is no such store, so the
// grid is (weight strips, batch tiles of 8 rows): each block streams one
// strip once with 16-byte loads (gemv_tile.cuh) and every strip is read by
// b/8 blocks. A strip is 64 columns of one head: 32 columns of its first half
// and the 32 columns they rotate with in its second half, so both halves of
// every RoPE pair are in the block and the rotation happens in the epilogue,
// in f32, before the one rounding to bf16. Pairing the halves this way gives
// 72 blocks per batch tile at 7B width, not the 36 whole-head strips would.
// cos/sin are computed in the epilogue as the TPU kernel's wrapper computes
// them (decode_qkv_pallas.py:103-106): f32 freqs = 1 / theta^(2j/d),
// angle = pos * freq, precise sincosf (no fast math).

#include "gemv_tile.cuh"

namespace agk {

constexpr int kQkvCols = 64;  // 32 + 32 paired columns of one head

__global__ void __launch_bounds__(kThreads, 1)
decode_qkv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ ln,
                  const int* __restrict__ pos,
                  const __nv_bfloat16* __restrict__ wq, const __nv_bfloat16* __restrict__ bq,
                  const __nv_bfloat16* __restrict__ wk, const __nv_bfloat16* __restrict__ bk,
                  const __nv_bfloat16* __restrict__ wv, const __nv_bfloat16* __restrict__ bv,
                  __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ k,
                  __nv_bfloat16* __restrict__ v, int b, int h, int nq, int nkv, int head_dim,
                  float eps, float theta) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);               // [BM][h]
  float* red = reinterpret_cast<float*>(smem + (size_t)BM * h * 2);         // [kWarps][BM][64]
  float* out = red + kWarps * BM * kQkvCols;                                // [BM][64]

  const int row0 = blockIdx.y * BM;
  const int rows = min(BM, b - row0);
  stage_rows(x + (size_t)row0 * h, ln, rows, h, eps, xs);

  const int q_strips = nq / kQkvCols, kv_strips = nkv / kQkvCols;
  int strip = blockIdx.x;
  const __nv_bfloat16 *W, *bias;
  __nv_bfloat16* dst;
  int ldw;
  bool rope = true;
  if (strip < q_strips) {
    W = wq; bias = bq; dst = q; ldw = nq;
  } else if (strip < q_strips + kv_strips) {
    strip -= q_strips;
    W = wk; bias = bk; dst = k; ldw = nkv;
  } else {
    strip -= q_strips + kv_strips;
    W = wv; bias = bv; dst = v; ldw = nkv; rope = false;
  }
  constexpr int kPairs = kQkvCols / 2;
  const int half = head_dim / 2;
  const int per_head = half / kPairs;
  const int j0 = (strip % per_head) * kPairs;            // first rotary index of the strip
  const int colA = (strip / per_head) * head_dim + j0;   // first-half columns
  const int colB = colA + half;                          // the columns they rotate with

  float acc[BM][8];
  zero_acc(acc);
  gemv_accumulate<kQkvCols>(xs, h, 0, W, (size_t)ldw, colA, colB, 0, h, acc);
  gemv_reduce<kQkvCols>(acc, red, out);

  // epilogue: one RoPE pair (colA + p, colB + p) of one row per iteration
  for (int i = threadIdx.x; i < BM * kPairs; i += kThreads) {
    const int m = i / kPairs, p = i % kPairs;
    if (m >= rows) continue;
    const float a = out[m * kQkvCols + p] + bf2f(bias[colA + p]);
    const float c = out[m * kQkvCols + kPairs + p] + bf2f(bias[colB + p]);
    float ya = a, yc = c;
    if (rope) {
      const float freq = 1.0f / powf(theta, (float)(2 * (j0 + p)) / (float)head_dim);
      float sn, cs;
      sincosf((float)pos[row0 + m] * freq, &sn, &cs);
      ya = a * cs - c * sn;
      yc = c * cs + a * sn;
    }
    __nv_bfloat16* o = dst + (size_t)(row0 + m) * ldw;
    o[colA + p] = f2bf(ya);
    o[colB + p] = f2bf(yc);
  }
}

}  // namespace agk

// C entry. Pointers are device pointers to contiguous tensors: bf16 except
// pos (int32 [b]); ln may be null. The wrapper in
// affectgpt_tpu_torch/ops/decode_qkv.py checks shapes, alignment and the
// divisibility the grid needs. Returns cudaGetLastError() after the launch.
extern "C" int agk_decode_qkv_bf16(const void* x, const void* ln, const void* pos,
                                   const void* wq, const void* bq, const void* wk,
                                   const void* bk, const void* wv, const void* bv, void* q,
                                   void* k, void* v, int b, int h, int nq, int nkv,
                                   int head_dim, float eps, float theta, void* stream) {
  using namespace agk;
  static size_t granted = 48 * 1024;
  const size_t smem = (size_t)BM * h * 2 + (size_t)(kWarps + 1) * BM * kQkvCols * 4;
  cudaError_t err = ensure_smem(decode_qkv_kernel, smem, &granted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nq / kQkvCols + 2 * (nkv / kQkvCols), (b + BM - 1) / BM);
  decode_qkv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(ln),
      static_cast<const int*>(pos),
      static_cast<const __nv_bfloat16*>(wq), static_cast<const __nv_bfloat16*>(bq),
      static_cast<const __nv_bfloat16*>(wk), static_cast<const __nv_bfloat16*>(bk),
      static_cast<const __nv_bfloat16*>(wv), static_cast<const __nv_bfloat16*>(bv),
      static_cast<__nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(v), b, h, nq, nkv, head_dim, eps, theta);
  return (int)cudaGetLastError();
}
