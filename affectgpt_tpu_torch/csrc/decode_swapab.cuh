// The bf16 decode projections on Hopper (sm_90a): one kernel for the two
// decode kernels that read bf16 weights, y = epi(a [b, K] @ W [K, N]), with
// W in the JAX [in, out] layout (N contiguous, no repacked copy), a the
// rmsnormed rows (rounded to bf16 by a first pass, rms_rows_kernel, once a
// row a call) or the down projection's bf16 activation. The epilogues are
// the TPU kernels' (their rounding points): bias + half-split RoPE in f32
// (decode_qkv's q and k), bias (its v), silu(gate) * up rounded to bf16
// (decode_mlp_bf16's first product), + the residual in f32 (its down
// projection); one rounding of each output.
//
// Bound: the weight bytes at decode batches (b <= 64: 33 MB a Qwen2.5-7B
// q/k/v, 407 MB its MLP), used for b multiply-adds each; at bench.py's b =
// 384 the MLP's products (52 GFLOP at Qwen2.5-3B width, 0.052 ms at 989
// TFLOP/s) pass its bytes (0.040 ms). The TPU kernels put the batch
// innermost so the weights are DMA'd once a call. The previous design here
// (CUDA-core FMAs over 8-row batch tiles, a grid of strips x b / 8 tiles)
// read every weight strip b / 8 times and ran no tensor cores. This one:
//   - swap-AB on wgmma: D^T = W^T a^T. A block owns 128 weight columns, two
//     TMA boxes of 64, one a consumer warpgroup; each box is the MN-major A
//     operand of wgmma.m64nNBk16 (read straight from the swizzled tile: bf16
//     needs no conversion), the block's NB batch rows (8 to 256, rows past
//     b zero-filled by TMA) the K-major B operand. So a weight byte is read
//     once a call at every b, and the tensor cores run at every b >= 1.
//   - b > 256: the batch is split over a pair of blocks in a cluster (NB
//     rows each); each block loads one of the stage's two weight boxes and
//     multicasts it into both, so the weights still leave memory once.
//   - the ring: one producer thread keeps `stages` stages full by TMA (the
//     two weight boxes, 64 k rows each, and the stage's 64 columns of a);
//     the consumers release a stage one wgmma group late.
//   - K split over a cluster of ck blocks where the column tiles are fewer
//     than the SMs (q/k/v: 36 tiles at 7B, 20 at 3B; down: 28, 16): each
//     block takes a contiguous share of K's 64-row units, and the f32
//     partial tiles meet in distributed shared memory, summed in rank order
//     (no atomics: two calls give the same bits). The plan takes the
//     largest split whose clusters the card holds all at once, as it
//     reports (agk_decode_swapab_active_clusters): at 3B b = 384 splits
//     into clusters of 8 (the down projection) and 6 (q/k/v), which did not
//     all fit, ran 19% and 43% slower than into clusters of 6 and 4.
//   - the epilogue from shared memory: the f32 tile [NB rows][128 columns]
//     is staged over the ring, so a column and its partner in the other box
//     (RoPE's c and c + d / 2, gate c and up c) are in one thread's hands.
// Launch plans (NB, batch blocks cb, K split ck, stages, shared memory,
// grid): ops/decode_gemm.py::gemm_plan, held on the CPU by
// tests/test_torch_decode_kernels.py.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "gemv_tile.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace agk {
namespace dsab {

using namespace hopper;
using bf = __nv_bfloat16;

constexpr int kThreads = 384;  // a TMA warpgroup + two consumer warpgroups
constexpr int kBK = 64;        // k rows a stage
constexpr int kBox = 64 * kBK * 2;  // one weight box: 64 k rows x 64 columns, 8 KB
constexpr int kWStage = 2 * kBox;   // the stage's two boxes
constexpr int kPitch = 128 + 4;     // f32 a row of the staged output tile
constexpr int kMaxCluster = 8;
constexpr int kMaxSegments = 3;
// Diagnostics, true in the package: scripts/torch_decode_probe.py switches it
// off in a copy to time the ring alone (the result of such a build is wrong).
constexpr bool kProducts = true;

enum Epi : int { kRope = 0, kBias = 1, kSiluMul = 2, kResidual = 3 };

// A run of a launch's column tiles with one epilogue. Tile t of a segment
// reads columns c0 .. c0 + 63 of weight map0 (box 0) and c1 .. c1 + 63 of
// map1 (box 1): kRope / kBias c0 = head * d + 64 i (i < d / 128), c1 = c0 +
// d / 2, a RoPE pair in one tile; kSiluMul c0 = c1 = 64 t (gate and up);
// kResidual c0 = 128 t, c1 = c0 + 64.
struct Segment {
  int tiles, kind, map0, map1, head_dim, ld;  // ld: columns of out (and of residual)
  const bf* bias;                             // kRope, kBias
  const bf* residual;                         // kResidual (null: no residual add)
  bf* out;
};

struct alignas(64) Params {
  CUtensorMap w[3];  // weight maps, boxes of 64 columns x 64 k rows
  CUtensorMap x;     // the rows a, boxes of 64 k x NB rows
  Segment seg[kMaxSegments];
  const int* pos;  // kRope: the rows' positions
  float theta;
  int nseg, b, K, cb, ck, stages;
};

__device__ __forceinline__ void locate(const Params& p, int tile, const Segment*& s, int& c0,
                                       int& c1) {
  int i = 0;
  while (i + 1 < p.nseg && tile >= p.seg[i].tiles) tile -= p.seg[i++].tiles;
  s = &p.seg[i];
  if (s->kind == kSiluMul) {
    c0 = c1 = 64 * tile;
  } else if (s->kind == kResidual) {
    c0 = 128 * tile;
    c1 = c0 + 64;
  } else {
    const int per = s->head_dim / 128;
    c0 = (tile / per) * s->head_dim + 64 * (tile % per);
    c1 = c0 + s->head_dim / 2;
  }
}

__device__ __forceinline__ void store4(bf* dst, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// Columns c0 + 4q .. + 3 (box 0, sums va) and c1 + 4q .. + 3 (box 1, vc) of
// row `row`: the segment's epilogue, one rounding, the stores.
__device__ __forceinline__ void epilogue(const Params& p, const Segment& s, int c0, int c1,
                                         int row, int q, float (&va)[4], float (&vc)[4]) {
  const int ca = c0 + 4 * q, cc = c1 + 4 * q;
  bf* out = s.out + (size_t)row * s.ld;
  if (s.kind == kSiluMul) {
#pragma unroll
    for (int e = 0; e < 4; ++e) va[e] = va[e] / (1.f + expf(-va[e])) * vc[e];
    store4(out + ca, va);
    return;
  }
  if (s.kind == kResidual) {
    // a null residual is the tensor-parallel partial: the product alone
    if (s.residual != nullptr) {
      const bf* r = s.residual + (size_t)row * s.ld;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        va[e] += bf2f(r[ca + e]);
        vc[e] += bf2f(r[cc + e]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      va[e] += bf2f(s.bias[ca + e]);
      vc[e] += bf2f(s.bias[cc + e]);
    }
    if (s.kind == kRope) {
      // cos/sin as the TPU kernel's wrapper computes them
      // (decode_qkv_pallas.py:103-106): f32 freq = 1 / theta^(2j / d),
      // angle = pos * freq, precise sincosf
      const float pos = (float)p.pos[row];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = ca % s.head_dim + e;  // the rotary index: ca is in the head's first half
        const float freq = 1.0f / powf(p.theta, (float)(2 * j) / (float)s.head_dim);
        float sn, cs;
        sincosf(pos * freq, &sn, &cs);
        const float a = va[e], c = vc[e];
        va[e] = a * cs - c * sn;
        vc[e] = c * cs + a * sn;
      }
    }
  }
  store4(out + ca, va);
  store4(out + cc, vc);
}

// Grid: a cluster of cb * ck blocks for each column tile (the segments'
// tiles in order); rank r = kr * cb + br takes batch rows [br NB, br NB +
// NB) and K units [kr U / ck, (kr + 1) U / ck) of U = ceil(K / 64).
template <int NB>
__global__ void __launch_bounds__(kThreads, NB <= 64 ? 2 : 1)
decode_swapab_kernel(const __grid_constant__ Params p) {
  constexpr int kStage = kWStage + NB * 128;  // two weight boxes, NB rows x 64 k of a
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int stages = p.stages;
  const int ring_bytes = max(stages * kStage, NB * kPitch * 4);  // the tile lies over the ring
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + ring_bytes);
  uint64_t* empty = full + stages;
  const int cb = p.cb, ck = p.ck, csize = cb * ck;
  const int rank = csize > 1 ? (int)cluster_rank() : 0;
  const int kr = rank / cb, br = rank % cb;
  const Segment* seg;
  int c0, c1;
  locate(p, blockIdx.x / csize, seg, c0, c1);
  const int units = (p.K + kBK - 1) / kBK;
  const int u0 = kr * units / ck, u1 = (kr + 1) * units / ck;
  const int row0 = br * NB;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * cb);  // lane 0 of each consumer warp of the batch pair
    }
    mbar_fence_init();
  }
  if (csize > 1)
    cluster_sync();  // the pair's barriers exist before any multicast or remote arrival
  else
    __syncthreads();
  launch_dependents();  // the next launch of the call may start its weight loads

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues the stages, then it leaves
    if constexpr (NB >= 128) setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const CUtensorMap* m0 = &p.w[seg->map0];
      const CUtensorMap* m1 = &p.w[seg->map1];
      const uint16_t pair = (uint16_t)(((1u << cb) - 1) << (kr * cb));
      auto weights = [&](int stage, int u) {
        mbar_expect_tx(&full[stage], kStage);
        unsigned char* st = ring + stage * kStage;
        if (cb == 1) {
          tma_load_2d(st, m0, &full[stage], c0, u * kBK);
          tma_load_2d(st + kBox, m1, &full[stage], c1, u * kBK);
        } else {  // box br into both blocks of the pair
          tma_load_2d_multicast(st + br * kBox, br ? m1 : m0, &full[stage], br ? c1 : c0,
                                u * kBK, pair);
        }
      };
      auto rows = [&](int stage, int u) {
        tma_load_2d(ring + stage * kStage + kWStage, &p.x, &full[stage], u * kBK, row0);
      };
      // The first stages' weights before the rows a, which the previous
      // launch of the call writes (launched as its programmatic dependent,
      // this grid may start before that launch ends).
      const int pre = min(stages, u1 - u0);
      for (int i = 0; i < pre; ++i) weights(i, u0 + i);
      grid_dependency_wait();
      for (int i = 0; i < pre; ++i) rows(i, u0 + i);
      RingPos pos;
      for (int i = 0; i < pre; ++i) pos.advance(stages);
      for (int u = u0 + pre; u < u1; ++u) {
        mbar_wait(&empty[pos.stage], pos.phase ^ 1u);
        weights(pos.stage, u);
        rows(pos.stage, u);
        pos.advance(stages);
      }
    }
    return;
  }

  if constexpr (NB >= 128) setmaxnreg_inc<232>();
  grid_dependency_wait();  // the epilogue reads what earlier launches wrote
  const int g = threadIdx.x / 128 - 1;  // this warpgroup's box
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, tid = threadIdx.x - 128;
  auto release = [&](int stage) {  // in both blocks of the batch pair
    if (lane != 0) return;
    if (cb == 1) {
      mbar_arrive(&empty[stage]);
    } else {
      for (int r = 0; r < cb; ++r)
        mbar_arrive_remote(map_to_rank(smem_u32(&empty[stage]), kr * cb + r));
    }
  };
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  RingPos pos;
  int prev = -1;
  for (int u = u0; u < u1; ++u) {
    mbar_wait(&full[pos.stage], pos.phase);
    const uint32_t st = smem_u32(ring + pos.stage * kStage);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      if constexpr (kProducts)
        wgmma_bf16_ss_ta(acc, desc_sw128_mn(st + g * kBox + 2048 * ks, kBox),
                         desc_sw128(st + kWStage + 32 * ks, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0) release(prev);
    prev = pos.stage;
    pos.advance(stages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0) release(prev);

  // The f32 tile over the ring, once both warpgroups are done reading it:
  // acc[4j + 2h + e] is weight column 16 warp + lane / 4 + 8h of box g,
  // batch row 8j + 2 (lane % 4) + e.
  named_barrier(1, 256);
  float* tile = reinterpret_cast<float*>(ring);
  const int col = 64 * g + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tile[(8 * j + 2 * (lane % 4) + e) * kPitch + col + 8 * h] = acc[4 * j + 2 * h + e];
  const int rows = min(NB, p.b - row0), quads = rows * 16;
  if (ck == 1) {
    named_barrier(1, 256);
    for (int i = tid; i < quads; i += 256) {
      const int m = i / 16, q = i % 16;
      const float4 a = *reinterpret_cast<const float4*>(tile + m * kPitch + 4 * q);
      const float4 c = *reinterpret_cast<const float4*>(tile + m * kPitch + 64 + 4 * q);
      float va[4] = {a.x, a.y, a.z, a.w}, vc[4] = {c.x, c.y, c.z, c.w};
      epilogue(p, *seg, c0, c1, row0 + m, q, va, vc);
    }
    if (csize > 1) {  // no block leaves while its pair may still arrive on its barriers
      cluster_arrive_relaxed();
      cluster_wait();
    }
    return;
  }
  // K split: block kr finishes its share of the tile's quads, summing the
  // ck partial tiles of its batch rows in rank order, between two rounds of
  // the cluster barrier (the consumers' alone: the producers have left)
  cluster_arrive_release();
  cluster_wait();
  const int lo = kr * quads / ck, hi = (kr + 1) * quads / ck;
  for (int i = lo + tid; i < hi; i += 256) {
    const int m = i / 16, q = i % 16;
    const uint32_t at = smem_u32(tile + m * kPitch + 4 * q);
    float va[4] = {0.f, 0.f, 0.f, 0.f}, vc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ck; ++r) {
      const float4 a = ld_cluster_f32x4(map_to_rank(at, r * cb + br));
      const float4 c = ld_cluster_f32x4(map_to_rank(at + 64 * 4, r * cb + br));
      va[0] += a.x, va[1] += a.y, va[2] += a.z, va[3] += a.w;
      vc[0] += c.x, vc[1] += c.y, vc[2] += c.z, vc[3] += c.w;
    }
    epilogue(p, *seg, c0, c1, row0 + m, q, va, vc);
  }
  cluster_arrive_relaxed();  // every block has read the tiles: no block leaves before
  cluster_wait();
}

// xn[b, h] = bf16(x * rsqrt(mean(x^2) + eps) * ln) in f32, one warp a row:
// the rmsnorm of every row once a call (h % 8 == 0). Static: both decode
// sources include this header.
static __global__ void __launch_bounds__(256)
rms_rows_kernel(const bf* __restrict__ x, const bf* __restrict__ ln, bf* __restrict__ xn, int b,
                int h, float eps) {
  launch_dependents();  // the projections may start loading their weights
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= b) return;
  const bf* xr = x + (size_t)row * h;
  float ss = 0.f;
  for (int c = 8 * lane; c < h; c += 256) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
#pragma unroll
    for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)h + eps);
  for (int c = 8 * lane; c < h; c += 256) {
    float v[8], s[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), v);
    unpack8(*reinterpret_cast<const uint4*>(ln + c), s);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = pack_bf16x2(v[2 * e] * r * s[2 * e], v[2 * e + 1] * r * s[2 * e + 1]);
    *reinterpret_cast<uint4*>(xn + (size_t)row * h + c) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

inline cudaError_t launch_rms_rows(const bf* x, const bf* ln, bf* xn, int b, int h, float eps,
                                   cudaStream_t st) {
  rms_rows_kernel<<<(b + 7) / 8, 256, 0, st>>>(x, ln, xn, b, h, eps);
  return cudaGetLastError();
}

// The dynamic shared memory of a launch: the ring (or the output tile, where
// it is larger), the barriers, alignment slack.
inline size_t smem_bytes(int nb, int stages) {
  const size_t ring = (size_t)stages * (kWStage + nb * 128);
  const size_t tile = (size_t)nb * kPitch * 4;
  return (ring > tile ? ring : tile) + 16 * stages + 1024;
}

template <int NB>
cudaError_t launch_nb(const Params& p, int tiles, bool dependent, cudaStream_t st) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes(NB, p.stages);
  cudaError_t err = ensure_smem(decode_swapab_kernel<NB>, smem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cb * p.ck);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cb * p.ck;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1] = programmatic_launch();
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, decode_swapab_kernel<NB>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Checks the plan (NB one of the kernel's widths, the batch within cb * NB,
// a legal cluster, a K split no finer than K's units, the shared memory
// within a block's 227 KB), makes the map of the rows a [b, K] and launches
// over the segments' tiles. The weight maps p.w are made by the caller.
// dependent: a is the output of the launch just before on the stream, one
// of this file's kernels; the grid is launched as its programmatic
// dependent, so its first weight loads overlap that launch's end.
inline cudaError_t launch(Params& p, const bf* a, int nb, bool dependent, cudaStream_t st) {
  const int units = (p.K + kBK - 1) / kBK;
  if (p.b < 1 || p.K < 1 || p.K % 8 || p.cb < 1 || p.cb > 2 || p.ck < 1 ||
      p.cb * p.ck > kMaxCluster || p.ck > units || p.b > p.cb * nb || (p.cb == 2 && p.b <= nb) ||
      p.stages < 2 || smem_bytes(nb, p.stages) > 232448 || p.nseg < 1 || p.nseg > kMaxSegments)
    return cudaErrorInvalidValue;
  int tiles = 0;
  for (int i = 0; i < p.nseg; ++i) tiles += p.seg[i].tiles;
  if (hopper::tensor_map_2d(&p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, p.K, p.b, 2ull * p.K, kBK,
                            nb))
    return cudaErrorInvalidValue;
  switch (nb) {
    case 8: return launch_nb<8>(p, tiles, dependent, st);
    case 16: return launch_nb<16>(p, tiles, dependent, st);
    case 32: return launch_nb<32>(p, tiles, dependent, st);
    case 64: return launch_nb<64>(p, tiles, dependent, st);
    case 128: return launch_nb<128>(p, tiles, dependent, st);
    case 192: return launch_nb<192>(p, tiles, dependent, st);
    case 256: return launch_nb<256>(p, tiles, dependent, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NB>
int active_clusters_nb(int cluster, int stages) {
  static size_t granted = 48 * 1024;
  const size_t smem = smem_bytes(NB, stages);
  cudaError_t err = ensure_smem(decode_swapab_kernel<NB>, smem, &granted);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, decode_swapab_kernel<NB>, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// The map of a row-major bf16 weight [k, n] in boxes of 64 columns x 64 k rows.
inline int weight_map(CUtensorMap* map, const void* w, int k, int n) {
  return hopper::tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, n, k, 2ull * n, 64, kBK);
}

}  // namespace dsab
}  // namespace agk
