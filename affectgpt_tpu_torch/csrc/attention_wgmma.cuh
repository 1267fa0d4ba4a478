// The pieces the port's two wgmma attention kernels share on Hopper
// (sm_90a): prefill_attention.cu (causal, segment ids, GQA, online softmax)
// and vit_attention.cuh (the encoders' non-causal attention with p
// normalised before its bf16 rounding). Both run two consumer warpgroups a
// block, each on 64 query rows against 64-key tiles that TMA brought into
// 128-byte swizzled shared memory (4-D tensor maps over the [b][heads][rows]
// strides, boxes of 64 rows x 64 head-dim values of one (b, head); rows past
// a tensor's end arrive as zeros).
//
// The products, 64 query rows x 64 keys a warpgroup:
//   S = Q K^T by wgmma m64n64k16 with the K tile as the K-major B operand:
//     SS (Q in shared memory, qk_tile) or RS (Q loaded once into registers
//     by ldmatrix, qk_tile_rs: only K is read from shared memory);
//   O += P V by RS wgmma m64nDk16: the f32 accumulators of S, packed in
//     pairs to bf16, are the register A operand as they lie (hopper.cuh
//     gives both layouts), and the V tile [keys, D] is read as an MN-major
//     B operand (desc_sw128_mn), so nothing is transposed or staged again.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace attn {

using namespace hopper;

constexpr int kRows = 64;       // query rows of a warpgroup
constexpr int kKeys = 64;       // keys of a tile
constexpr int kBox = 64 * 128;  // bytes of one 64-row x 64-value bf16 box
constexpr float kLog2e = 1.4426950408889634f;

// element strides of a [b, heads, rows, d] operand's batch, head and row
// axes (head_dim contiguous)
struct AttnStrides {
  long long b, h, n;
};

// bytes of one 64-row tile of head_dim D (ceil(D / 64) boxes side by side;
// the columns of the last box past D arrive as zeros)
template <int D>
constexpr int kTileBytes = ((D + 63) / 64) * kBox;

// Where this thread's accumulators lie: warp w of its warpgroup, lane
// (g, tq); element 4j + 2h + e of an m64 accumulator is row 16w + g + 8h,
// column 8j + 2tq + e (hopper.cuh).
struct Frag {
  int warp, g, tq;
  __device__ __forceinline__ Frag()
      : warp((threadIdx.x / 32) % 4), g(threadIdx.x % 32 / 4), tq(threadIdx.x % 4) {}
  __device__ __forceinline__ int row(int h) const { return 16 * warp + g + 8 * h; }
  __device__ __forceinline__ int col(int j, int e) const { return 8 * j + 2 * tq + e; }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, subnormal results flushed to 0; exp2(-inf) = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for the warpgroup's 64 rows and one 64-key tile (raw dot
// products). q and k are shared addresses of 64-row tiles in D / 64 boxes;
// the caller fences before and commits after.
template <int D>
__device__ __forceinline__ void qk_tile(float (&s)[32], uint32_t q, uint32_t k) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 4) * kBox + 32 * (ks % 4);
    wgmma_bf16_ss(s, desc_sw128(q + off, 16, 1024), desc_sw128(k + off, 16, 1024), ks > 0);
  }
}

// The register A operand of Q (the warpgroup's 64 rows, D / 64 boxes of a
// 128-byte swizzled tile at shared address q): q_frag[4 ks .. 4 ks + 3] is
// k step ks (head-dim values 16 ks .. 16 ks + 15). One ldmatrix x4 a step:
// lane l addresses row 16 warp + 8 ((l / 8) % 2) + l % 8, 16-byte chunk
// 2 ks + l / 16 of its 128-byte row, stored at chunk ^ (row % 8).
template <int D>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[D / 4], uint32_t q) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row = 16 * warp + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int chunk = (2 * ks + lane / 16) % 8;
    uint32_t r[4];
    ldsm_x4(r, q + (ks / 4) * kBox + row * 128 + ((chunk ^ (row % 8)) << 4));
#pragma unroll
    for (int i = 0; i < 4; ++i) qf[4 * ks + i] = r[i];
  }
}

// S = Q K^T for one 64-key tile with Q from registers (load_q_frags): only
// the K tile is read from shared memory. The caller fences before and
// commits after, and keeps qf unchanged until the products complete.
template <int D>
__device__ __forceinline__ void qk_tile_rs(float (&s)[32], const uint32_t (&qf)[D / 4],
                                           uint32_t k) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_bf16_rs(s, qf[4 * ks], qf[4 * ks + 1], qf[4 * ks + 2], qf[4 * ks + 3],
                  desc_sw128(k + (ks / 4) * kBox + 32 * (ks % 4), 16, 1024), ks > 0);
}

// O (+)= P V for one 64-key tile: p the packed bf16 A operand (p[4k .. 4k +
// 3] holds keys 16k .. 16k + 15), v the shared address of the [64 keys, D]
// tile; accumulate = 0 discards the old O. The caller fences before,
// commits after, and keeps p unchanged until the products complete.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const uint32_t (&p)[16], uint32_t v,
                                        int accumulate) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_bf16_rs_tb(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                     desc_sw128_mn(v + 2048 * kk, kBox), kk > 0 || accumulate);
}

// the A operand of P V from the f32 values of an S tile
__device__ __forceinline__ void pack_p(uint32_t (&p)[16], const float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = pack_bf16x2(s[2 * i], s[2 * i + 1]);
}

// Host: the tensor map of a bf16 tensor of 64-value rows (head_dim d,
// contiguous) addressed as [b][heads][rows] through element strides sb,
// sh, sn, read in boxes of 64 rows x 64 values of one (b, head). The two
// middle dimensions go in the order of their strides; `heads_inner` says
// which came first, so the kernel orders its coordinates the same way.
static inline int head_rows_map(CUtensorMap* map, const void* ptr, int d, int b, int heads,
                                int rows, long long sb, long long sh, long long sn,
                                int* heads_inner) {
  *heads_inner = sh < sn;
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)(*heads_inner ? heads : rows),
                            (uint64_t)(*heads_inner ? rows : heads), (uint64_t)b};
  const uint64_t strides[3] = {2ull * (*heads_inner ? sh : sn), 2ull * (*heads_inner ? sn : sh),
                               2ull * sb};
  const uint32_t box[4] = {64, *heads_inner ? 1u : 64u, *heads_inner ? 64u : 1u, 1};
  return tensor_map_4d(map, ptr, dims, strides, box);
}

// the box of rows r0 .. r0 + 63, head-dim values c0 .. c0 + 63 of (bi, hi)
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int heads_inner, int c0, int r0, int hi, int bi) {
  if (heads_inner)
    tma_load_4d(dst, map, bar, c0, hi, r0, bi);
  else
    tma_load_4d(dst, map, bar, c0, r0, hi, bi);
}

static inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace attn
}  // namespace agk
