"""Int8 and int4 weight formats and the quantized matmul kernels.

Port of affectgpt_tpu/ops/quant.py. The formats are the JAX package's, byte
for byte, so a quantized JAX tree carries over unchanged
(`models.convert.from_jax`):

- int8 per output channel: w_q int8 [K, N], scales f32 [1, N] (absmax/127);
- int4 grouped: w_q4 int8 [K/2, N] with two values per byte (low nibble =
  row k of the first K-half, high nibble = row k + K/2), scales f32
  [K/128, N], one per (128-row group, output channel), absmax/7.

Four kernels, each a wrapper with its plain PyTorch version beside it and a
`launches` count. On a CPU tensor a wrapper runs the plain version; on a
CUDA tensor it launches the hand-written kernel (csrc/) or raises:

- `int8_matmul`: bf16(x) @ bf16(w_q), f32 accumulation, × scales, then
  x.dtype (replaces quant.py:90);
- `int8_matmul_w8a8`: x quantized per (row, 512-column K block) to int8,
  int8 × int8 → int32 per block, × the row's block scale, summed in f32, ×
  scales (replaces quant.py:163): at M <= 16 one launch of the swap-AB
  kernel's w8a8 mode (csrc/quant_swapab.cu, plan `w8a8_swapab_plan`), which
  quantizes x itself and meets its K split in a cluster; up to
  PALLAS_DEQUANT_MAX_M a quantize launch and the w8a8 mode of
  csrc/quant_wgmma.cuh (plan `wgmma_plan(..., MODE_W8A8)`); above it (the
  prefill) the 192-row wgmma tile of csrc/int8_matmul_w8a8.cu (plan
  `w8a8_plan`);
- `int4_matmul`: each 128-row group's bf16 product with the raw nibbles,
  summed in f32, times that group's scales (replaces quant.py:319);
- `int4_matmul_smallm`: bf16(nibble · scale) dequantized in f32, then one
  bf16 product with f32 accumulation, equal to `int4_matmul_xla`
  (replaces quant.py:407).

`int8_matmul` and both int4 wrappers launch csrc/quant_swapab.cu at M <= 16
(the decode M of the main path: 8 and 16): the weights as the A operand of
mma.sync, their bytes through a TMA ring, K split over a cluster, one
launch a product, on the plans of `int8_plan` and `int4_plan`. Above M = 16
(the speculative verify's 40, bench.py's 7B batch of 256, prefill up to
PALLAS_DEQUANT_MAX_M) they launch csrc/quant_wgmma.cuh (through
csrc/int8_matmul.cu, int4_matmul.cu, int4_matmul_smallm.cu): swap-AB on
wgmma, the weight bytes converted into register A fragments, the batch rows
of x the B operand, both by TMA through one ring, on the plan of
`wgmma_plan`.

`models.qwen2._lora_dense` routes by M = rows of x, as the JAX TPU route
does without its Mosaic gates (block divisibility, the 8-row pad,
`interpret`): int4 M < PALLAS_INT4_MIN_M → `int4_matmul_smallm`, M up to
PALLAS_DEQUANT_MAX_M → `int4_matmul`; int8 M up to PALLAS_DEQUANT_MAX_M →
`int8_matmul`; above the cut (the prefill) → `int4_matmul_xla` /
`int8_matmul_xla`, dequantize + one large product, the JAX package's own
XLA path for compute-bound prefill.

Departure from the TPU route: with MATMUL_MODE == "w8a8" the port runs
`int8_matmul_w8a8` for every M. JAX on a TPU sends a w8a8 matmul whose M is
not a multiple of its 256-row block to the w8 XLA path (qwen2.py
`_int8_shapes_ok`), a Mosaic block gate; the port's kernel masks ragged
tiles, so w8a8 always runs the kernel, as the JAX comment on the route
intends ("w8a8 always runs the Pallas kernel").

The encoder towers' int8 serving mode: `quantize_encoder_tree` gives a
tower `w_q` leaves, and `nn.dense` / `nn.dense_nobias` send them to
`dense_w8a8_xla`, JAX's XLA product (per-row activation quantization, int8 x
int8 → int32 in `torch._int_mm`, f32 rescale). As in JAX it runs outside any
hand-written kernel: no TPU kernel computes it.
"""

from __future__ import annotations

import functools

import torch

from affectgpt_tpu_torch.ops import _build

INT4_GROUP = 128  # K-rows per scale group (GPTQ/AWQ default)
W8A8_BLOCK_K = 512  # activation-quantization block along K (JAX default block_k)

# serving precision of int8 weights, read at each call: "w8" (bf16
# activations) or "w8a8" (activations quantized to int8 in the kernel)
MATMUL_MODE = "w8"
# M above which a quantized matmul takes the dequantize + matmul route
# (prefill, compute-bound) instead of the weight-streaming kernels
PALLAS_DEQUANT_MAX_M = 1024
# int4 M below which the small-M kernel runs (every b = 8 decode step)
PALLAS_INT4_MIN_M = 16


# ---------------------------------------------------------------------------
# Formats


def quantize_per_channel(w: torch.Tensor, absmax=None):
    """[K, N] float → (int8 [K, N], scales f32 [1, N]). absmax: the columns'
    f32 absmax [1, N] when it is not w's own (a tensor-parallel rank's rows
    of a row-parallel leaf take the whole K's)."""
    w = w.float()
    if absmax is None:
        absmax = w.abs().amax(dim=0, keepdim=True)
    scale = absmax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int4_grouped(w: torch.Tensor):
    """[K, N] float → (packed int8 [K/2, N], scales f32 [K/128, N]).
    Symmetric per-(128-row group, output-channel) quantization to [-7, 7];
    byte[k, n] = (q[k + K/2, n] << 4) | (q[k, n] & 0xF)."""
    k, n = w.shape
    if k % (2 * INT4_GROUP):
        raise ValueError(f"quantize_int4_grouped: K={k} is not a multiple of 2·{INT4_GROUP}")
    wg = w.float().reshape(k // INT4_GROUP, INT4_GROUP, n)
    absmax = wg.abs().amax(dim=1, keepdim=True)  # [G, 1, N]
    scale = absmax.clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32).reshape(k, n)
    lo, hi = q[: k // 2], q[k // 2:]
    return ((hi << 4) | (lo & 0xF)).to(torch.int8), scale[:, 0, :]


def _unpack_int4(packed: torch.Tensor):
    """Packed int8 bytes → (low-nibble, high-nibble) values, int8, signed:
    the low nibble sign-extended by a shift up and an arithmetic shift
    down, the high one by the arithmetic shift alone."""
    return (packed << 4) >> 4, packed >> 4


def _int4_values(w_p: torch.Tensor) -> torch.Tensor:
    """Packed [K/2, N] → the int4 values [K, N], int8 (rows [0, K/2) from
    the low nibbles)."""
    return torch.cat(_unpack_int4(w_p), dim=0)


def _int4_dequant(w_p: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Packed [K/2, N] and scales [K/128, N] → value · scale, f32 [K, N]."""
    k, n = 2 * w_p.shape[0], w_p.shape[1]
    q = _int4_values(w_p).reshape(k // INT4_GROUP, INT4_GROUP, n)
    return (q * scales.float()[:, None, :]).reshape(k, n)


def quantize_dense_tree(params, bits: int = 8):
    """Quantize every 2-D 'w' leaf of a dense-params tree: {'w', 'b'?} →
    {'w_q', 'scales', 'b'?} (bits=8) or {'w_q4', 'scales', 'b'?} (bits=4).
    bits=4 leaves whose K is not a multiple of 2·INT4_GROUP take int8."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")

    def visit(node):
        if isinstance(node, dict):
            if "w" in node and getattr(node["w"], "ndim", 0) == 2:
                if bits == 4 and node["w"].shape[0] % (2 * INT4_GROUP) == 0:
                    w_p, scales = quantize_int4_grouped(node["w"])
                    out = {"w_q4": w_p, "scales": scales}
                else:
                    w_q, scales = quantize_per_channel(node["w"])
                    out = {"w_q": w_q, "scales": scales}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            return {k: visit(v) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v) for v in node]
        return node

    return visit(params)


# Encoder towers reuse the decoder's leaf format ({"w_q", "scales", "b"?});
# conv, layernorm and embedding leaves (not 2-D, or no "w") stay as they are.
quantize_encoder_tree = quantize_dense_tree

# 1/127 rounded to f32: XLA compiles JAX's `absmax / 127.0` into a product
# with this constant, and every JAX caller of dense_w8a8_xla (and of the
# int8 KV cache's qwen2._quantize_kv) runs compiled
INV_127 = torch.tensor(1 / 127, dtype=torch.float32).item()


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 → int32, exactly. torch._int_mm on the
    card takes M > 16 and K, N multiples of 8: the operands are padded with
    zeros to that, which leaves the sums unchanged."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(0, 17 - m), -k % 8, -n % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def dense_w8a8_xla(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor,
                   b=None) -> torch.Tensor:
    """The encoder towers' W8A8 dense (JAX quant.py:502-521): x quantized per
    row (absmax / 127, round half to even, clip to ±127), int8 x int8 →
    int32, then × the row's scale × scales [1, N] in f32, + b, → x.dtype."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * INV_127
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    y = _int8_mm(xq.reshape(-1, xq.shape[-1]), w_q).reshape(*x.shape[:-1], w_q.shape[1])
    y = y.float() * sx * scales.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the oracle of each kernel on the card)


def int8_matmul_reference(x, w_q, scales):
    """bf16(x) @ bf16(w_q) accumulated in f32, × scales, → x.dtype."""
    y = x.to(torch.bfloat16).float() @ w_q.float()
    return (y * scales.float()).to(x.dtype)


def int8_matmul_w8a8_reference(x, w_q, scales):
    """Per (row, K block): sx = max(absmax, 1e-8)/127, xq = clip(round(x/sx))
    (half to even); each block's integer product, exact in f32, times sx,
    summed over blocks in f32; × scales; → x.dtype."""
    m, k = x.shape
    kb = min(W8A8_BLOCK_K, k)
    xf = x.float().reshape(m, k // kb, kb)
    sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / sx), -127, 127)
    wf = w_q.float().reshape(k // kb, kb, -1)
    acc = torch.zeros((m, wf.shape[-1]), dtype=torch.float32, device=x.device)
    for blk in range(k // kb):
        acc = acc + (xq[:, blk] @ wf[blk]) * sx[:, blk]
    return (acc * scales.float()).to(x.dtype)


def int4_matmul_reference(x, w_p, scales):
    """Each 128-row group: bf16(x) against the raw int4 values, f32 sum,
    times the group's scales [N]; the groups summed in f32; → x.dtype."""
    m, k = x.shape
    xb = x.to(torch.bfloat16).float()
    q = _int4_values(w_p).float()
    sc = scales.float()
    acc = torch.zeros((m, q.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(k // INT4_GROUP):
        rows = slice(g * INT4_GROUP, (g + 1) * INT4_GROUP)
        acc = acc + (xb[:, rows] @ q[rows]) * sc[g]
    return acc.to(x.dtype)


def int4_matmul_smallm_reference(x, w_p, scales):
    """bf16(int4 value · scale) computed in f32, then bf16(x) @ that, f32
    accumulation, → x.dtype (the semantics of `int4_matmul_xla`)."""
    w = _int4_dequant(w_p, scales).to(torch.bfloat16).float()
    return (x.to(torch.bfloat16).float() @ w).to(x.dtype)


# ---------------------------------------------------------------------------
# The dequantize + matmul route of large M (JAX's XLA path for prefill)


def int8_matmul_xla(x, w_q, scales):
    """bf16(x) @ bf16(w_q) with its f32 sum, × scales in f32, rounded once
    to x.dtype. On the card one bf16 product on a transient bf16 copy of
    the weight writes the f32 sum (`out_dtype`); on the CPU the f32 product
    of the same values."""
    xb = x.to(torch.bfloat16)
    if x.is_cuda:
        y = torch.mm(xb, w_q.to(torch.bfloat16), out_dtype=torch.float32)
    else:
        y = xb.float() @ w_q.float()
    return (y * scales.float()).to(x.dtype)


def int4_matmul_xla(x, w_p, scales):
    """bf16(x) @ bf16(int4 value · scale), in x's dtype, through a transient
    dequantized weight."""
    w = _int4_dequant(w_p, scales).to(torch.bfloat16).to(x.dtype)
    return torch.matmul(x.to(torch.bfloat16).to(x.dtype), w).to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers

def _check_operands(name, x, w, scales, w_rows: int, scale_rows: int, k_multiple: int):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 2 or w.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"{name}: x, weight and scales must be 2-D")
    m, k = x.shape
    n = w.shape[1]
    for t in (w, scales):
        if t.device != x.device:
            raise ValueError(f"{name}: all operands must be on one device")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bfloat16 activations, got {x.dtype}")
    if w.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes int8 weights and float32 scales, "
                        f"got {w.dtype} and {scales.dtype}")
    for t in (x, w, scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors")
    if tuple(w.shape) != (w_rows, n) or tuple(scales.shape) != (scale_rows, n):
        raise ValueError(f"{name}: weight {tuple(w.shape)} or scales {tuple(scales.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if m == 0 or n % 16 or k % k_multiple:
        raise ValueError(f"{name} kernel needs M > 0, N % 16 == 0 and K % {k_multiple} == 0 "
                         f"(M={m}, N={n}, K={k})")
    return m, n, k


# csrc/quant_swapab.cu: a block owns SWAPAB_BN columns of N (eight consumer
# warps of 16) and streams its share of K in stages of 16 KB of weights (int4:
# 128 packed rows, one scale group of each K-half; int8: 128 rows) through a
# ring of five stages (int4 at M > 8: four); two blocks fit an SM
SWAPAB_BN, INT4_BKP = 128, 128
INT8_ROWS, INT8_STAGES = 128, 5
SWAPAB_MAX_M, SWAPAB_MAX_CLUSTER = 16, 8
W8A8_SWAPAB_RING = 64 * 1024  # the w8a8 mode's ring: 4 stages of 128 columns, 8 of 64
# the share of the card's SMs a product's blocks should cover before K is
# split over a cluster: the smallest cluster reaching it was the fastest size
# for every 7B int4 product on the H100 (one block an SM, none waiting on a
# slower cluster peer), and within 5% of the fastest for every int8 one
SWAPAB_SM_FILL = 0.8
# the C entry's modes (agk_quant_swapab; the w8a8 mode, which takes the
# block width, has its own entry, agk_w8a8_swapab)
MODE_INT4, MODE_INT4_DEQUANT, MODE_INT8 = 0, 1, 2
# csrc/quant_wgmma.cuh's w8a8 mode, a `wgmma_plan` mode only (its C entry is
# agk_int8_matmul_w8a8_wgmma, which takes no mode number)
MODE_W8A8 = 4


def _cluster_plan(col_blocks: int, units: int, sm_count: int, active_clusters) -> int:
    """The cluster size of a swap-AB launch: the smallest whose blocks cover
    SWAPAB_SM_FILL of the SMs (at most 8, at most the K units), among the
    sizes of which the card holds at least one cluster at once."""
    sizes = [c for c in range(1, min(SWAPAB_MAX_CLUSTER, units) + 1) if active_clusters(c) >= 1]
    if not sizes:
        raise ValueError("swap-AB kernel: no cluster size fits the card")
    return next((c for c in sizes if col_blocks * c >= SWAPAB_SM_FILL * sm_count), sizes[-1])


def int4_plan(m: int, n: int, k: int, sm_count: int, active_clusters=None) -> dict:
    """The launch plan of the swap-AB int4 kernel for x [m, k] against a
    packed weight [k/2, n]: n8 tiles of batch rows `nt`; one cluster of
    `cluster` blocks for each 128-column block, block r of it taking K's
    units [r U / C, (r + 1) U / C) of U = k / 256 (`unit_ranges`); the grid;
    the ring's stages and the dynamic shared memory. The cluster is the
    smallest whose blocks cover SWAPAB_SM_FILL of the SMs (at most 8, at most
    U), among the sizes of which the card holds at least one cluster at once
    (`active_clusters(c)`; the wrapper asks the card, by default two blocks
    an SM). Raises on what the kernel does not take."""
    if not 1 <= m <= SWAPAB_MAX_M or n < 16 or n % 16 or k < 2 * INT4_GROUP \
            or k % (2 * INT4_GROUP):
        raise ValueError(f"int4 swap-AB kernel needs 1 <= M <= {SWAPAB_MAX_M}, N % 16 == 0 and "
                         f"K % {2 * INT4_GROUP} == 0 (M={m}, N={n}, K={k})")
    if active_clusters is None:
        def active_clusters(c):
            return 2 * sm_count // c
    nt = 1 if m <= 8 else 2
    col_blocks, units = -(-n // SWAPAB_BN), k // (2 * INT4_BKP)
    c = _cluster_plan(col_blocks, units, sm_count, active_clusters)
    stages = 5 if nt == 1 else 4
    # packed weights, four 64-column x boxes of 8 nt rows, two scale rows
    stage = INT4_BKP * SWAPAB_BN + 4 * 8 * nt * 128 + 2 * SWAPAB_BN * 4
    return {
        "nt": nt, "cluster": c, "grid": (c * col_blocks,),
        "col_blocks": col_blocks, "units": units,
        "unit_ranges": [(r * units // c, (r + 1) * units // c) for r in range(c)],
        "stages": stages, "stage_bytes": stage,
        # ring, partial tile, barriers, alignment slack
        "smem_bytes": stages * stage + 8 * nt * (SWAPAB_BN + 4) * 4 + 2 * stages * 8 + 1024,
        # the packed bytes the blocks stream: each once
        "weight_bytes": col_blocks * SWAPAB_BN * k // 2,
    }


def int8_plan(m: int, n: int, k: int, sm_count: int, active_clusters=None) -> dict:
    """The launch plan of the swap-AB kernel's int8 mode for x [m, k] @ w_q
    [k, n]: as `int4_plan`, with K in units of INT8_ROWS rows (U = ceil(k /
    INT8_ROWS); rows past K arrive as zeros), a ring of five stages. Raises
    on what the kernel does not take."""
    if not 1 <= m <= SWAPAB_MAX_M or n < 16 or n % 16 or k < 64 or k % 64:
        raise ValueError(f"int8 swap-AB kernel needs 1 <= M <= {SWAPAB_MAX_M}, N % 16 == 0 and "
                         f"K % 64 == 0 (M={m}, N={n}, K={k})")
    if active_clusters is None:
        def active_clusters(c):
            return 2 * sm_count // c
    nt = 1 if m <= 8 else 2
    col_blocks, units = -(-n // SWAPAB_BN), -(-k // INT8_ROWS)
    c = _cluster_plan(col_blocks, units, sm_count, active_clusters)
    # int8 weights, the 64-column x boxes of 8 nt rows
    stage = INT8_ROWS * SWAPAB_BN + (INT8_ROWS // 64) * 8 * nt * 128
    return {
        "nt": nt, "cluster": c, "grid": (c * col_blocks,),
        "col_blocks": col_blocks, "units": units, "rows": INT8_ROWS, "block_n": SWAPAB_BN,
        "unit_ranges": [(r * units // c, (r + 1) * units // c) for r in range(c)],
        "stages": INT8_STAGES, "stage_bytes": stage,
        "smem_bytes": INT8_STAGES * stage + 8 * nt * (SWAPAB_BN + 4) * 4 + 2 * INT8_STAGES * 8
        + 1024,
        "weight_bytes": col_blocks * SWAPAB_BN * units * INT8_ROWS,
    }


def w8a8_swapab_plan(m: int, n: int, k: int, sm_count: int, active_clusters=None) -> dict:
    """The launch plan of the swap-AB kernel's w8a8 mode for x [m, k] @ w_q
    [k, n], 1 <= m <= 16: n8 tiles of batch rows `nt`; blocks of `block_n`
    columns, 128 unless 128-column blocks split over the largest cluster
    would cover fewer than SWAPAB_SM_FILL of the SMs (then 64: k/v_proj at
    7B); one cluster of `cluster` blocks for each column block, block r of it
    taking the qblocks [r U / C, (r + 1) U / C) of U = k / qblock
    (`unit_ranges`), each in `stages_per_unit` stages of INT8_ROWS rows (rows
    past K arrive as zeros); the grid; a ring of 64 KB of weights; the
    dynamic shared memory (the ring, one staged qblock of x, two qblocks of
    xq in fragment order and their row scales, the partial tile). The
    cluster is the largest (at most 8, at most U) whose clusters the card
    holds all at once (`active_clusters(c, block_n)` >= the column blocks;
    the wrapper asks the card, by default two blocks an SM), else the
    smallest the card holds; not `_cluster_plan`'s smallest size covering
    SWAPAB_SM_FILL of the SMs, which left down_proj and q_proj slower: the
    largest one-wave size was the fastest one-wave size for every 7B
    product at M = 8 and 16 (`scripts/torch_int8_probe.py sweep`, NVIDIA
    H100 80GB HBM3 at 700 W). Raises on what the kernel does not take."""
    qblock = min(W8A8_BLOCK_K, k)
    if not 1 <= m <= SWAPAB_MAX_M or n < 16 or n % 16 or k < 64 or k % 64 or k % qblock:
        raise ValueError(f"w8a8 swap-AB kernel needs 1 <= M <= {SWAPAB_MAX_M}, N % 16 == 0, "
                         f"K % 64 == 0 and K % {qblock} == 0 (M={m}, N={n}, K={k})")
    if active_clusters is None:
        def active_clusters(c, block_n):
            return 2 * sm_count // c
    nt = 1 if m <= 8 else 2
    units = k // qblock
    bn = SWAPAB_BN
    if -(-n // bn) * min(SWAPAB_MAX_CLUSTER, units) < SWAPAB_SM_FILL * sm_count:
        bn = SWAPAB_BN // 2
    col_blocks = -(-n // bn)
    sizes = [c for c in range(1, min(SWAPAB_MAX_CLUSTER, units) + 1) if active_clusters(c, bn) >= 1]
    if not sizes:
        raise ValueError("w8a8 swap-AB kernel: no cluster size fits the card")
    c = max((c for c in sizes if active_clusters(c, bn) >= col_blocks), default=sizes[0])
    stages = W8A8_SWAPAB_RING // (INT8_ROWS * bn)
    stage = INT8_ROWS * bn
    per_unit = -(-qblock // INT8_ROWS)
    return {
        "nt": nt, "block_n": bn, "qblock": qblock, "cluster": c, "grid": (c * col_blocks,),
        "col_blocks": col_blocks, "units": units, "rows": INT8_ROWS,
        "unit_ranges": [(r * units // c, (r + 1) * units // c) for r in range(c)],
        "stages_per_unit": per_unit, "stages": stages, "stage_bytes": stage,
        # ring, the staged x (two boxes of 8 nt rows x 256 bf16), two qblocks
        # of xq (16 k32 steps x nt x 256 bytes) and their scales, partial
        # tile, barriers, alignment slack
        "smem_bytes": stages * stage + 2 * 8 * nt * 512 + 2 * 16 * nt * 256 + 2 * 8 * nt * 4
        + 8 * nt * (bn + 4) * 4 + 2 * (stages + 1) * 8 + 1024,
        "weight_bytes": col_blocks * bn * units * per_unit * INT8_ROWS,
    }


@functools.lru_cache(maxsize=None)
def _swapab_active_clusters(index: int, cluster: int, m: int, mode: int) -> int:
    with torch.cuda.device(index):
        count = _build.load_library().agk_quant_swapab_active_clusters(cluster, m, mode)
    if count < 0:
        _build.check(-count, "swap-AB occupancy")
    return count


@functools.lru_cache(maxsize=None)
def _swapab_plan_on(index: int, m: int, n: int, k: int, mode: int) -> dict:
    plan = int8_plan if mode == MODE_INT8 else int4_plan
    return plan(m, n, k, _build.sm_count(index), lambda c: _swapab_active_clusters(index, c, m, mode))


def _swapab(name, x, w, scales, mode: int):
    m, k = x.shape
    n = w.shape[1]
    plan = _swapab_plan_on(x.device.index or 0, m, n, k, mode)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    status = _build.load_library().agk_quant_swapab(
        x.data_ptr(), w.data_ptr(), scales.data_ptr(), y.data_ptr(), m, n, k, plan["cluster"],
        mode, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, name)
    return y


# csrc/quant_wgmma.cuh, above SWAPAB_MAX_M: a block owns WGMMA_BN columns of
# N (two consumer warpgroups of 64, the wgmma M) and NB batch rows (the wgmma
# N, one of WGMMA_NB); a stage is WGMMA_ROWS stored weight rows and the x
# columns they meet (int8: one 64-column box; int4: one of each K-half, and
# two scale rows in a pair's first stage); the consumers take stages in
# pairs, one 128-row scale group of each K-half
WGMMA_BN, WGMMA_ROWS = 128, 64
WGMMA_NB = (32, 40, 48, 64, 96, 128)
# the w8a8 mode's widths: those of an s8 wgmma (N = 8, 16, 24 or a multiple
# of 16)
W8A8_WGMMA_NB = (16, 24, 32, 48, 64, 96, 128)
WGMMA_MAX_STAGES = 8
SMEM_PER_SM = 233_472  # an H100 SM's shared memory; each resident block reserves 1 KB
SMEM_LIMIT = SMEM_PER_SM - 1024  # bytes of shared memory an H100 block can use


def wgmma_stage_bytes(mode: int, nb: int) -> int:
    """One stage of the ring: the weight box, the x boxes of nb rows x 128
    bytes, int4's two scale rows; w8a8: a whole pair, two weight boxes and
    xq's box."""
    if mode == MODE_W8A8:
        return 2 * WGMMA_ROWS * WGMMA_BN + nb * 128
    if mode == MODE_INT8:
        return WGMMA_ROWS * WGMMA_BN + nb * 128
    return WGMMA_ROWS * WGMMA_BN + 2 * nb * 128 + 2 * WGMMA_BN * 4


def cpu_blocks_per_sm(mode: int, nb: int) -> int:
    """csrc/quant_wgmma.cuh's blocks_per_sm, for plans made without a card:
    two blocks an SM at the w8a8 widths up to 48, one otherwise. On a card
    the plan asks the built kernel (`_wgmma_blocks_per_sm`); the `cuda`
    tests hold the two equal at every width."""
    return 2 if mode == MODE_W8A8 and nb <= 48 else 1


def wgmma_plan(m: int, n: int, k: int, sm_count: int, mode: int, active_clusters=None,
               blocks_per_sm=None) -> dict:
    """The launch plan of csrc/quant_wgmma.cuh for x [m, k] against an int8
    weight [k, n] (MODE_INT8, MODE_W8A8) or a packed int4 one [k/2, n]
    (MODE_INT4, MODE_INT4_DEQUANT), SWAPAB_MAX_M < m <= PALLAS_DEQUANT_MAX_M:

    - `cb` batch blocks of `nb` rows (cb = ceil(m / 128), nb the narrowest
      width of WGMMA_NB (W8A8_WGMMA_NB) that holds ceil(m / cb) rows; rows
      past m are zeros);
    - U = `units` pairs of stages along K (int8: ceil(k / 128), rows past K
      zeros; int4: k / 256, pair u one scale group of each K-half), split
      over a cluster of `cluster` blocks, rank r taking `unit_ranges[r]`;
    - the grid: one cluster for each (column block, batch block), batch
      blocks fastest, so block b is column block b // (cb c), batch block
      (b // c) % cb, rank b % c;
    - `blocks_per_sm`, the blocks an SM the kernel of width nb is built for
      (`blocks_per_sm(nb)`: the wrapper asks the built kernel; by default
      `cpu_blocks_per_sm`), and the ring: as many stages as fit a block's
      share of the SM's shared memory, at most WGMMA_MAX_STAGES;
    - the weight bytes the launch reads: each byte once a batch block
      (`weight_reads` = cb), from the L2 after the first.

    The cluster is the swap-AB kernel's rule (`_cluster_plan`): the smallest
    whose blocks cover SWAPAB_SM_FILL of the SMs, at most 8 and at most U,
    among the sizes of which the card holds at least one cluster at once
    (`active_clusters(c, nb, stages)`; the wrapper asks the card, by default
    `blocks_per_sm` blocks an SM).

    MODE_W8A8 splits K in whole qblocks (`qblock` = min(512, k) columns,
    `qblock_units` pairs each; at most one rank a qblock), over the largest
    cluster (at most 8) whose clusters the card holds all at once, else the
    smallest it holds (`w8a8_swapab_plan`'s rule); where the largest split
    of the column blocks still covers less than SWAPAB_SM_FILL of the SMs
    (k/v_proj: 4 column blocks, 7 qblocks) it splits the batch into more,
    narrower blocks (down to 16 rows, none empty), which read the weights
    again from the L2. Its ring stage is a whole pair (the
    two weight boxes and xq's) with a 128-byte-aligned slot for a qblock's
    row scales. Raises on what the kernel does not take."""
    int8, w8a8 = mode == MODE_INT8, mode == MODE_W8A8
    if mode not in (MODE_INT8, MODE_INT4, MODE_INT4_DEQUANT, MODE_W8A8):
        raise ValueError(f"wgmma kernel: unknown mode {mode}")
    k_unit = 64 if int8 or w8a8 else 2 * INT4_GROUP
    qblock = min(W8A8_BLOCK_K, k)
    if not SWAPAB_MAX_M < m <= PALLAS_DEQUANT_MAX_M or n < 16 or n % 16 or k < k_unit \
            or k % k_unit or (w8a8 and k % qblock):
        raise ValueError(f"wgmma quantized kernel needs {SWAPAB_MAX_M} < M <= "
                         f"{PALLAS_DEQUANT_MAX_M}, "
                         f"N % 16 == 0 and K % {k_unit} == 0"
                         + (f" and K % {qblock} == 0" if w8a8 else "")
                         + f" (M={m}, N={n}, K={k})")
    widths = W8A8_WGMMA_NB if w8a8 else WGMMA_NB
    col_blocks = -(-n // WGMMA_BN)
    units = -(-k // 128) if int8 or w8a8 else k // (2 * INT4_GROUP)
    qbu = -(-qblock // 128) if w8a8 else 1
    splittable = units // qbu  # w8a8: qblocks

    def narrowest(cb):
        return next((w for w in widths if cb * w >= m), None)

    cb = -(-m // widths[-1])
    nb = narrowest(cb)
    while w8a8 and col_blocks * cb * min(SWAPAB_MAX_CLUSTER, splittable) \
            < SWAPAB_SM_FILL * sm_count:
        wider = narrowest(cb + 1)
        if wider is None or cb * wider >= m:  # a batch block would be empty
            break
        cb, nb = cb + 1, wider
    stage = wgmma_stage_bytes(mode, nb)
    slot = -(-nb * 4 // 128) * 128 if w8a8 else 0
    per_sm = (blocks_per_sm or functools.partial(cpu_blocks_per_sm, mode))(nb)
    limit = SMEM_PER_SM // per_sm - 1024
    stages = min(WGMMA_MAX_STAGES, (limit - 1024) // (stage + slot + 16))
    if active_clusters is None:
        def active_clusters(c, nb, stages):
            return per_sm * sm_count // c
    if w8a8:  # the largest K split whose clusters the card holds all at once
        sizes = [size for size in range(1, min(SWAPAB_MAX_CLUSTER, splittable) + 1)
                 if active_clusters(size, nb, stages) >= 1]
        if not sizes:
            raise ValueError("wgmma quantized kernel: no cluster size fits the card")
        c = max((size for size in sizes if active_clusters(size, nb, stages) >= col_blocks * cb),
                default=sizes[0])
    else:
        c = _cluster_plan(col_blocks * cb, splittable, sm_count,
                          lambda size: active_clusters(size, nb, stages))
    plan = {
        "nb": nb, "cb": cb, "cluster": c, "col_blocks": col_blocks, "units": units,
        "unit_ranges": [(r * splittable // c * qbu, (r + 1) * splittable // c * qbu)
                        for r in range(c)],
        "grid": (col_blocks * cb * c,), "stages": stages, "stage_bytes": stage,
        "smem_bytes": max(stages * stage, nb * (WGMMA_BN + 4) * 4) + stages * (slot + 16) + 1024,
        "weight_reads": cb, "weight_bytes": cb * col_blocks * WGMMA_BN * units * 128,
        "blocks_per_sm": per_sm,
    }
    if w8a8:
        plan.update(qblock=qblock, qblock_units=qbu, sx_slot=slot)
    return plan


@functools.lru_cache(maxsize=None)
def _wgmma_active_clusters(index: int, mode: int, nb: int, stages: int, cluster: int) -> int:
    with torch.cuda.device(index):
        count = getattr(_build.load_library(), _WGMMA_ENTRY[mode] + "_active_clusters")(
            nb, cluster, stages)
    if count < 0:
        _build.check(-count, "wgmma quantized kernel occupancy")
    return count


@functools.lru_cache(maxsize=None)
def _wgmma_blocks_per_sm(mode: int, nb: int) -> int:
    """The blocks an SM the built kernel of width nb takes (its launch
    bounds)."""
    count = getattr(_build.load_library(), _WGMMA_ENTRY[mode] + "_blocks_per_sm")(nb)
    if count < 1:
        raise ValueError(f"wgmma quantized kernel: no build of width {nb} in mode {mode}")
    return count


@functools.lru_cache(maxsize=None)
def _wgmma_plan_on(index: int, m: int, n: int, k: int, mode: int) -> dict:
    return wgmma_plan(m, n, k, _build.sm_count(index), mode,
                      lambda c, nb, stages: _wgmma_active_clusters(index, mode, nb, stages, c),
                      lambda nb: _wgmma_blocks_per_sm(mode, nb))


# the C entry of each mode (csrc/int8_matmul.cu, int4_matmul.cu, int4_matmul_smallm.cu)
_WGMMA_ENTRY = {MODE_INT8: "agk_int8_matmul", MODE_INT4: "agk_int4_matmul",
                MODE_INT4_DEQUANT: "agk_int4_matmul_smallm",
                MODE_W8A8: "agk_int8_matmul_w8a8_wgmma"}


def _wgmma(name, x, w, scales, mode: int):
    m, k = x.shape
    n = w.shape[1]
    plan = _wgmma_plan_on(x.device.index or 0, m, n, k, mode)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    status = getattr(_build.load_library(), _WGMMA_ENTRY[mode])(
        x.data_ptr(), w.data_ptr(), scales.data_ptr(), y.data_ptr(), m, n, k, plan["nb"],
        plan["cb"], plan["cluster"], plan["stages"], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, name)
    return y


def _int8_check(name, x, w_q, scales):
    return _check_operands(name, x, w_q, scales, x.shape[-1], 1, 64)


def int8_matmul(x, w_q, scales):
    """x [M, K] @ dequant(w_q int8 [K, N], scales [1, N]) → [M, N] x.dtype."""
    _build.refuse_grad("int8_matmul", x, w_q, scales)
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scales)
    m, n, k = _int8_check("int8_matmul", x, w_q, scales)
    if m <= SWAPAB_MAX_M:
        y = _swapab("int8_matmul", x, w_q, scales, MODE_INT8)
    else:
        y = _wgmma("int8_matmul", x, w_q, scales, MODE_INT8)
    int8_matmul.launches += 1
    return y


def _int4_check(name, x, w_p, scales):
    k = x.shape[-1]
    return _check_operands(name, x, w_p, scales, k // 2, k // INT4_GROUP, 2 * INT4_GROUP)


def int4_matmul(x, w_p, scales):
    """x [M, K] @ dequant(w_p int4-packed [K/2, N], scales [K/128, N]) →
    [M, N] x.dtype, the group scales applied to f32 partial sums."""
    _build.refuse_grad("int4_matmul", x, w_p, scales)
    if x.device.type == "cpu":
        return int4_matmul_reference(x, w_p, scales)
    m, n, k = _int4_check("int4_matmul", x, w_p, scales)
    if m <= SWAPAB_MAX_M:
        y = _swapab("int4_matmul", x, w_p, scales, MODE_INT4)
    else:
        y = _wgmma("int4_matmul", x, w_p, scales, MODE_INT4)
    int4_matmul.launches += 1
    return y


def int4_matmul_smallm(x, w_p, scales):
    """Decode-shaped int4 matmul: the same contract as `int4_matmul`, the
    weights dequantized with their scales before the product."""
    _build.refuse_grad("int4_matmul_smallm", x, w_p, scales)
    if x.device.type == "cpu":
        return int4_matmul_smallm_reference(x, w_p, scales)
    m, n, k = _int4_check("int4_matmul_smallm", x, w_p, scales)
    if m <= SWAPAB_MAX_M:
        y = _swapab("int4_matmul_smallm", x, w_p, scales, MODE_INT4_DEQUANT)
    else:
        y = _wgmma("int4_matmul_smallm", x, w_p, scales, MODE_INT4_DEQUANT)
    int4_matmul_smallm.launches += 1
    return y


@functools.lru_cache(maxsize=None)
def _w8a8_active_clusters(index: int, cluster: int, m: int, block_n: int) -> int:
    with torch.cuda.device(index):
        count = _build.load_library().agk_w8a8_swapab_active_clusters(cluster, m, block_n)
    if count < 0:
        _build.check(-count, "w8a8 swap-AB occupancy")
    return count


@functools.lru_cache(maxsize=None)
def _w8a8_swapab_plan_on(index: int, m: int, n: int, k: int) -> dict:
    return w8a8_swapab_plan(m, n, k, _build.sm_count(index),
                            lambda c, bn: _w8a8_active_clusters(index, c, m, bn))


# csrc/int8_matmul_w8a8.cu, above PALLAS_DEQUANT_MAX_M: a block owns 128 output
# columns and 192 rows (the wgmma N), and streams K in 128-byte stages
# through a ring of four
W8A8_BN, W8A8_BK, W8A8_STAGES, W8A8_BM = 128, 128, 4, 192


def w8a8_plan(m: int, n: int, k: int, sm_count: int) -> dict:
    """The launch plan of the prefill's w8a8 tile for x [m, k] @ w_q [k, n],
    m > PALLAS_DEQUANT_MAX_M: the row tile `bm` (the wgmma N), the K split
    (whole activation blocks `qblock`, enough splits to give each SM about
    one block, reduced in a fixed order), the grid (row tiles fastest) and
    the dynamic shared memory in bytes (a stage: weight tile, xq tile, the
    rows' scales). Smaller M take `wgmma_plan(..., MODE_W8A8)` and decode M
    `w8a8_swapab_plan`."""
    if m <= PALLAS_DEQUANT_MAX_M:
        raise ValueError(f"the w8a8 prefill tile takes M > {PALLAS_DEQUANT_MAX_M} (M={m}); smaller "
                         "M run the w8a8 modes of the wgmma and swap-AB kernels")
    qblock = min(W8A8_BLOCK_K, k)
    bm = W8A8_BM
    m_tiles, n_tiles = -(-m // bm), -(-n // W8A8_BN)
    groups = k // qblock
    per = -(-groups // min(groups, max(1, -(-sm_count // (m_tiles * n_tiles)))))
    splits = -(-groups // per)
    stage = W8A8_BK * W8A8_BN + bm * W8A8_BK + bm * 4
    return {"bm": bm, "qblock": qblock, "k_per_split": per * qblock, "splits": splits,
            "grid": (m_tiles, n_tiles, splits),
            "smem_bytes": W8A8_STAGES * stage + 2 * W8A8_STAGES * 8 + 1024,
            # the product's reads: each weight byte once per row tile, each xq
            # byte once per column tile
            "l2_bytes": m_tiles * k * n + n_tiles * m * k}


def _w8a8_swapab(x, w_q, scales):
    m, k = x.shape
    n = w_q.shape[1]
    plan = _w8a8_swapab_plan_on(x.device.index or 0, m, n, k)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    status = _build.load_library().agk_w8a8_swapab(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), y.data_ptr(), m, n, k, plan["block_n"],
        plan["cluster"], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "int8_matmul_w8a8")
    return y


def int8_matmul_w8a8(x, w_q, scales):
    """x [M, K] quantized per (row, 512-column block) in the kernel, then
    int8 × int8 products → [M, N] x.dtype. At M <= 16 one launch of the
    swap-AB kernel's w8a8 mode (`w8a8_swapab_plan`); up to PALLAS_DEQUANT_MAX_M
    two launches, quantize x and the product on quant_wgmma.cuh's w8a8 mode
    (`wgmma_plan(..., MODE_W8A8)`); above it two launches on the prefill's
    192-row tile, plus the fixed-order reduce of the K splits when there are
    several (`w8a8_plan`)."""
    _build.refuse_grad("int8_matmul_w8a8", x, w_q, scales)
    if x.device.type == "cpu":
        return int8_matmul_w8a8_reference(x, w_q, scales)
    m, n, k = _check_operands("int8_matmul_w8a8", x, w_q, scales, x.shape[-1], 1, 64)
    qblock = min(W8A8_BLOCK_K, k)
    if k % qblock:
        raise ValueError(f"int8_matmul_w8a8 kernel needs K % {qblock} == 0 (K={k})")
    if m <= SWAPAB_MAX_M:
        y = _w8a8_swapab(x, w_q, scales)
    elif m <= PALLAS_DEQUANT_MAX_M:
        y = _w8a8_wgmma(x, w_q, scales)
    else:
        y = _w8a8_prefill(x, w_q, scales)
    int8_matmul_w8a8.launches += 1
    return y


def _w8a8_wgmma(x, w_q, scales):
    m, k = x.shape
    n = w_q.shape[1]
    plan = _wgmma_plan_on(x.device.index or 0, m, n, k, MODE_W8A8)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    # the row scales, one row per qblock, rows of M rounded up to 4 (TMA's
    # 16-byte row pitch); the product's map reads M of them
    sx = torch.empty((k // plan["qblock"], -(-m // 4) * 4), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    status = _build.load_library().agk_int8_matmul_w8a8_wgmma(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        y.data_ptr(), m, n, k, plan["nb"], plan["cb"], plan["cluster"], plan["stages"],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "int8_matmul_w8a8")
    return y


def _w8a8_prefill(x, w_q, scales):
    m, k = x.shape
    n = w_q.shape[1]
    qblock = min(W8A8_BLOCK_K, k)
    plan = w8a8_plan(m, n, k, _build.sm_count(x.device.index or 0))
    splits = plan["splits"]
    m_pad = plan["grid"][0] * plan["bm"]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    # the row scales, one row per activation block, zero past M
    sx = torch.zeros((k // qblock, m_pad), dtype=torch.float32, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    partial = torch.empty((splits, m, n) if splits > 1 else (0,), dtype=torch.float32,
                          device=x.device)
    status = _build.load_library().agk_int8_matmul_w8a8(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        y.data_ptr(), partial.data_ptr(), m, n, k, qblock, plan["k_per_split"], splits,
        m_pad, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "int8_matmul_w8a8")
    return y


# wrapper calls that launched their kernels since the last reset
int8_matmul.launches = 0
int8_matmul_w8a8.launches = 0
int4_matmul.launches = 0
int4_matmul_smallm.launches = 0

