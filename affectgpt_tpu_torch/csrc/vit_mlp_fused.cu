// The pre-LN MLP sublayer of the ViT / HuBERT encoders in one product kernel
// on Hopper (sm_90a), wgmma fed by TMA (`wgmma.mma_async` and
// `cp.async.bulk.tensor` from hopper.cuh): y = x + fc2(act(fc1(LN(x))))
// with no [rows, I] intermediate in device memory.
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
// Bound: operations, 276 GFLOP a CLIP layer at 64 images (16,448 rows, w =
// 1024, I = 4096). What must be on chip for a row tile is the problem: at w
// = 1024 LN(x) of 128 rows is 256 KB and one chunk's f32 partial [128, w]
// 512 KB, against 227 KB of shared memory and 256 KB of registers an SM. A
// first design kept the running out of a 128-row tile in an f32 scratch in
// device memory: 66 MB live, more than the L2, and its read-modify-write
// per chunk cost half the kernel's time. Design, two launches:
//   (A) LN prologue (vit_gemm.cuh's layernorm_rows_kernel): h = LN(x)
//       [rows, w] bf16, written once (34 MB at CLIP) and read back by TMA.
//   (B) a thread-block cluster of C = w / 128 blocks per 128-row tile; block
//       j owns output columns [128 j, 128 j + 128), and its two consumer
//       warpgroups (64 rows each) keep that slab's running out in registers
//       (64 f32 a thread) for the whole kernel: no partial sum leaves the
//       chip. Warpgroup 0 of each block issues TMA loads into a ring of four
//       24 KB stages. Per chunk, in pieces of 64 C columns of t:
//         fc1: block j computes t[:, 64 j .. 64 j + 64) of the piece,
//              wgmma.m64n64k16 over K = w (h and W_in tiles of 64 k per
//              stage), t = bf16(act(acc + b_in)) into block j of its t tile
//              ([128, 64 C] bf16 in shared memory, a 128-byte swizzled wgmma
//              operand), and bulk-copies that block into the other blocks'
//              t tiles (distributed shared memory; completion on their
//              `t_ready` barrier);
//         fc2: every block multiplies the whole piece of t with W_out[piece,
//              its slab] (wgmma.m64n128k16, W_out tiles of 64 k per stage)
//              into its running out; then it arrives on every block's
//              `t_free` barrier, which a block waits for before it
//              overwrites its t block with the next piece.
//       bf16 rounds the running out at each chunk end, f32 does not; x +
//       b_out starts it, y = bf16(out) ends it.
//   Budget: 96 KB ring + 128 KB t tile + 1 KB alignment = 230,488 bytes of
//   shared memory. L2 reads at CLIP's shape, 129 row tiles of 8 blocks: the
//   weights once per 128 rows (129 x 16.8 MB = 2.2 GB, against 8.6 GB of
//   the mma.sync design this replaces), h once per block and piece (2.2
//   GB); t moves between the blocks' shared memories, not through L2.
// Limits: w % 128 == 0 (so C <= 8 at w <= 1024), kc % 64 == 0, kc <= 1024.

#include "hopper.cuh"
#include "vit_gemm.cuh"

namespace agk {
namespace vit {
namespace fused {

using namespace hopper;

constexpr int kThreads = 384;  // TMA warpgroup + two consumer warpgroups
constexpr int kBM = 128;       // rows per cluster, 64 per consumer warpgroup
constexpr int kSlab = 128;     // output columns per CTA: a cluster has w / 128 CTAs
constexpr int kMaxCluster = 8;
constexpr int kStages = 4;
constexpr int kHTile = kBM * 64 * 2;          // h box: 128 rows x 64 k (16 KB)
constexpr int kBox = 64 * 64 * 2;             // weight box: 64 k x 64 n (8 KB)
constexpr int kStageBytes = kHTile + kBox;    // fc1: h + W_in box; fc2: two W_out boxes
constexpr int kTBlock = kBM * 64 * 2;         // 64 columns of t for 128 rows (16 KB)
constexpr int kTBytes = kMaxCluster * kTBlock;  // a piece of t: 64 columns per CTA
constexpr size_t kSmem = (size_t)kStages * kStageBytes + kTBytes + (2 * kStages + 3) * 8 + 1024;
static_assert(kSmem <= 232448, "the ring and the t tile exceed a block's shared memory");

struct Shape {
  int rows, w, kc, chunks, cluster;
};

// acc (+)= A . B over `kts` stages of the ring (64 k a stage). A is K-major
// at a_addr(kt, stage address) (this warpgroup's 64 rows); B is MN-major,
// N / 64 boxes 8 KB apart at b_off in the stage. With `fresh` the first
// product discards acc. Each stage is released one wgmma group late.
template <int N, class AAddr>
__device__ __forceinline__ void ring_gemm(float (&acc)[N / 2], int kts, AAddr a_addr,
                                          uint32_t b_off, bool fresh, unsigned char* ring,
                                          uint64_t* full, uint64_t* empty, RingPos& pos) {
  const int lane = threadIdx.x % 32;
  int prev = -1;
  for (int kt = 0; kt < kts; ++kt) {
    mbar_wait(&full[pos.stage], pos.phase);
    const uint32_t st = smem_u32(ring + pos.stage * kStageBytes);
    const uint32_t a = a_addr(kt, st);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_bf16_ss_tb(acc, desc_sw128(a + 32 * ks, 16, 1024),
                       desc_sw128(st + b_off + 2048 * ks, kBox, 1024),
                       (fresh && (kt | ks) == 0) ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: release it
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = pos.stage;
    pos.advance(kStages);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
}

// A cluster of C = w / 128 CTAs per 128-row tile (grid: tiles x C). CTA j of
// the cluster owns output columns [128 j, 128 j + 128) and keeps their
// running out in registers for the whole kernel. Per chunk, in pieces of
// 64 C columns of t: CTA j computes t's columns [64 j, 64 j + 64) of the
// piece (fc1, K = w) into block j of its t tile and copies the block into
// the other CTAs' t tiles (bulk copies between shared memories); then every
// CTA multiplies the whole piece of t with its slab of W_out (fc2).
// Barriers: `t_ready` completes when the other CTAs' blocks of the piece
// have landed; `t_free[p % 2]` when every CTA of the cluster has finished
// fc2 of piece p, after which its blocks may be overwritten.
template <bool F32ACC, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
mlp_fused_kernel(const __grid_constant__ CUtensorMap h_map,
                 const __grid_constant__ CUtensorMap win_map,
                 const __grid_constant__ CUtensorMap wout_map, const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ b_in, const __nv_bfloat16* __restrict__ b_out,
                 __nv_bfloat16* __restrict__ y, Shape sh) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* tbuf = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(tbuf + kTBytes);
  uint64_t* empty = full + kStages;
  uint64_t* t_ready = empty + kStages;
  uint64_t* t_free = t_ready + 1;  // two: pieces alternate
  const int C = sh.cluster, w = sh.w, kc = sh.kc, pw = 64 * C;
  const int rank = (int)cluster_rank();
  const int m0 = (blockIdx.x / C) * kBM, col0 = kSlab * rank;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_init(t_ready, 1);
    mbar_init(&t_free[0], 8 * C);  // each consumer warp of each CTA
    mbar_init(&t_free[1], 8 * C);
    mbar_fence_init();
  }
  cluster_sync();  // every CTA's barriers exist before any remote use

  if (threadIdx.x < 128) {  // producer: one thread walks the stage sequence
    if (threadIdx.x != 0) return;
    RingPos pos;
    auto next = [&](uint32_t bytes) {  // the next free stage, expecting `bytes`
      const int slot = pos.stage;
      mbar_wait(&empty[slot], pos.phase ^ 1u);
      mbar_expect_tx(&full[slot], bytes);
      pos.advance(kStages);
      return slot;
    };
    for (int c = 0; c < sh.chunks; ++c) {
      for (int pc0 = 0; pc0 < kc; pc0 += pw) {
        const int pwp = min(pw, kc - pc0), base = c * kc + pc0;
        if (64 * rank < pwp)
          for (int kt = 0; kt < w / 64; ++kt) {
            const int slot = next(kStageBytes);
            unsigned char* st = ring + slot * kStageBytes;
            tma_load_2d(st, &h_map, &full[slot], 64 * kt, m0);
            tma_load_2d(st + kHTile, &win_map, &full[slot], base + 64 * rank, 64 * kt);
          }
        for (int kt = 0; kt < pwp / 64; ++kt) {
          const int slot = next(2 * kBox);
          unsigned char* st = ring + slot * kStageBytes;
          tma_load_2d(st, &wout_map, &full[slot], col0, base + 64 * kt);
          tma_load_2d(st + kBox, &wout_map, &full[slot], col0 + 64, base + 64 * kt);
        }
      }
    }
    cluster_sync();  // no CTA leaves while another may still copy into it
    return;
  }

  const int g = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int r0 = 64 * g + 16 * warp + gid;  // tile rows r0 and r0 + 8 of this thread
  const uint32_t tb = smem_u32(tbuf);
  const bool leader = threadIdx.x == 128;
  float out[64];  // out[4j + 2h + e]: row r0 + 8h, column col0 + 8j + 2 tig + e
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + 8 * j + 2 * tig;
    const float2 bo = make_float2(bf2f(b_out[col]), bf2f(b_out[col + 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      float2 xv = make_float2(0.f, 0.f);
      if (row < sh.rows)
        xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)row * w + col));
      out[4 * j + 2 * h] = xv.x + bo.x;
      out[4 * j + 2 * h + 1] = xv.y + bo.y;
    }
  }
  float t1[32];
  RingPos pos;
  int piece = 0;
  for (int c = 0; c < sh.chunks; ++c) {
    for (int pc0 = 0; pc0 < kc; pc0 += pw, ++piece) {
      const int pwp = min(pw, kc - pc0), base = c * kc + pc0, blocks = pwp / 64;
      const bool active = rank < blocks;
      if (leader)  // the other CTAs' blocks of this piece, by bulk copy
        mbar_expect_tx(t_ready, kTBlock * (blocks - (active ? 1 : 0)));
      if (active) {  // fc1: t[:, 64 rank .. + 64) of the piece
        ring_gemm<64>(t1, w / 64, [&](int, uint32_t st) { return st + 8192u * g; }, kHTile,
                      true, ring, full, empty, pos);
        if (piece > 0)  // every CTA is done with the previous piece
          mbar_wait_cluster(&t_free[(piece - 1) & 1], ((piece - 1) >> 1) & 1);
        const uint32_t blk = tb + rank * kTBlock;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tig;
          const float b0 = bf2f(b_in[base + 64 * rank + col]);
          const float b1 = bf2f(b_in[base + 64 * rank + col + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            const uint32_t at = blk + r * 128 + ((((col / 8) ^ (r % 8)) << 4) | ((col % 8) * 2));
            const uint32_t v = pack_bf16x2(activate<ACT>(t1[4 * j + 2 * h] + b0),
                                           activate<ACT>(t1[4 * j + 2 * h + 1] + b1));
            asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(v) : "memory");
          }
        }
        fence_proxy_async();        // the block is read by wgmma and bulk copies
        named_barrier(1, 256);      // both consumer warpgroups wrote their rows
        if (leader)
          for (int dst = 0; dst < C; ++dst)
            if (dst != rank)
              bulk_copy_to_rank(map_to_rank(blk, dst), tbuf + rank * kTBlock, kTBlock,
                                map_to_rank(smem_u32(t_ready), dst));
      }
      mbar_wait_cluster(t_ready, piece & 1);  // the whole piece of t is here
      // fc2: out[:, slab] += t[:, piece] . W_out[piece, slab]
      ring_gemm<128>(out, blocks, [&](int kt, uint32_t) { return tb + kt * kTBlock + 8192u * g; },
                     0, false, ring, full, empty, pos);
      if (lane == 0)  // this warp is done reading the piece, in every CTA's count
        for (int dst = 0; dst < C; ++dst)
          mbar_arrive_cluster(map_to_rank(smem_u32(&t_free[piece & 1]), dst));
      if (!F32ACC && pc0 + pwp == kc) {  // the bf16 accumulator rounds at each chunk end
#pragma unroll
        for (int i = 0; i < 64; ++i) out[i] = __bfloat162float(__float2bfloat16(out[i]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col0 + 8 * j + 2 * tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r0 + 8 * h;
      if (row < sh.rows)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * w + col) =
            __floats2bfloat162_rn(out[4 * j + 2 * h], out[4 * j + 2 * h + 1]);
    }
  }
  cluster_sync();
}

template <bool F32ACC, int ACT>
static cudaError_t launch(const CUtensorMap& h_map, const CUtensorMap& win_map,
                          const CUtensorMap& wout_map, const __nv_bfloat16* x,
                          const __nv_bfloat16* b_in, const __nv_bfloat16* b_out,
                          __nv_bfloat16* y, const Shape& sh, cudaStream_t stream) {
  static size_t granted = 48 * 1024;
  cudaError_t err = ensure_smem(mlp_fused_kernel<F32ACC, ACT>, kSmem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((sh.rows + kBM - 1) / kBM * sh.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mlp_fused_kernel<F32ACC, ACT>, h_map, win_map, wout_map, x, b_in,
                           b_out, y, sh);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace fused
}  // namespace vit
}  // namespace agk

// C entry. Device pointers to contiguous bf16 tensors: x, y [rows, w]; LN
// scale and bias [w]; w_in [w, I], b_in [I], w_out [I, w], b_out [w];
// scratch h [rows, w]. k_chunks divides I (the wrapper rounds it as the TPU
// wrapper does); act is 1 (quick_gelu) or 2 (gelu); f32acc selects the
// accumulation. The wrapper in affectgpt_tpu_torch/ops/vit_mlp_fused.py
// (`fused_plan`) checks shapes and limits (w % 128 == 0, kc % 64 == 0, each
// at most 1024). Returns the first CUDA error of the two launches, or 0.
extern "C" int agk_vit_mlp_fused_bf16(const void* x, const void* ln_scale, const void* ln_bias,
                                      const void* w_in, const void* b_in, const void* w_out,
                                      const void* b_out, void* y, void* h, int rows, int w,
                                      int inter, int k_chunks, int act, int f32acc, float eps,
                                      void* stream) {
  using namespace agk::vit;
  using bf = __nv_bfloat16;
  if (k_chunks < 1 || inter % k_chunks) return (int)cudaErrorInvalidValue;
  const int kc = inter / k_chunks;
  if (w % 128 || kc % 64 || w > 1024 || kc > 1024 || (act != kActQuickGelu && act != kActGelu))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf*>(x);
  cudaError_t err = launch_layernorm(xp, static_cast<const bf*>(ln_scale),
                                     static_cast<const bf*>(ln_bias), static_cast<bf*>(h), rows,
                                     w, eps, st);
  if (err != cudaSuccess) return (int)err;
  using agk::hopper::tensor_map_2d;
  CUtensorMap h_map, win_map, wout_map;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (tensor_map_2d(&h_map, kBf16, h, w, rows, 2ull * w, 64, fused::kBM) ||
      tensor_map_2d(&win_map, kBf16, w_in, inter, w, 2ull * inter, 64, 64) ||
      tensor_map_2d(&wout_map, kBf16, w_out, w, inter, 2ull * w, 64, 64))
    return (int)cudaErrorInvalidValue;
  const fused::Shape sh{rows, w, kc, k_chunks, w / fused::kSlab};
  const auto* bi = static_cast<const bf*>(b_in);
  const auto* bo = static_cast<const bf*>(b_out);
  auto* yp = static_cast<bf*>(y);
  if (f32acc)
    return (int)(act == kActGelu
                     ? fused::launch<true, kActGelu>(h_map, win_map, wout_map, xp, bi, bo, yp,
                                                     sh, st)
                     : fused::launch<true, kActQuickGelu>(h_map, win_map, wout_map, xp, bi, bo,
                                                          yp, sh, st));
  return (int)(act == kActGelu
                   ? fused::launch<false, kActGelu>(h_map, win_map, wout_map, xp, bi, bo, yp, sh,
                                                    st)
                   : fused::launch<false, kActQuickGelu>(h_map, win_map, wout_map, xp, bi, bo, yp,
                                                         sh, st));
}
