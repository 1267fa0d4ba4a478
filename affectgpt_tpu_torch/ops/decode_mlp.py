"""Fused int8 decode MLP: x + down(silu(gate(rms x)) · up(rms x)) for the
q=1 decode step, on per-channel int8 weights (or, residual=False, the MLP
alone: a tensor-parallel rank's partial sum).

Port of affectgpt_tpu/ops/decode_mlp_pallas.py::decode_mlp_pallas. On a CUDA
tensor `decode_mlp` launches the hand-written kernels in
csrc/decode_mlp_int8.cu (two launches in one call, products on tensor cores:
gate/up into a [b, I] scratch, then down + scales + residual, as
`decode_mlp_plan` lays them out) or raises; on a CPU tensor it runs
`decode_mlp_reference`, the plain PyTorch version, which is also the oracle
the kernels are checked against on the card.

Weights are the JAX int8 serving leaves, `[in, out]` row-major: gate/up
`w_q` [h, I] with f32 `scales` [1, I], down `w_q` [I, h] with `scales`
[1, h] (`ops.quant.quantize_per_channel`).
"""

from __future__ import annotations

import torch

from affectgpt_tpu_torch.ops import _build


def decode_mlp_reference(x, ln_scale, w_gate, s_gate, w_up, s_up, w_down, s_down, *,
                         eps: float = 1e-6, residual: bool = True):
    """Plain version with the TPU kernel's rounding points, which are bf16
    whatever x's dtype (decode_mlp_pallas.py:66, :74): xn rounded to bf16,
    gate/up as f32 sums of bf16 products times their column scales,
    silu(g)·u rounded to bf16, down as an f32 sum times its column scales,
    + x (unless residual=False), then x.dtype."""
    bf = torch.bfloat16
    xf = x.float()
    xn = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * ln_scale.float()
    xn = xn.to(bf).float()
    g = (xn @ w_gate.float()) * s_gate.float()
    u = (xn @ w_up.float()) * s_up.float()
    a = (torch.nn.functional.silu(g) * u).to(bf).float()
    y = (a @ w_down.float()) * s_down.float()
    return (xf + y if residual else y).to(x.dtype)


def _check_operands(x, ln_scale, w_gate, s_gate, w_up, s_up, w_down, s_down):
    b, h = x.shape
    inter = w_gate.shape[-1]
    dtypes = ((x, torch.bfloat16), (ln_scale, torch.bfloat16), (w_gate, torch.int8),
              (w_up, torch.int8), (w_down, torch.int8), (s_gate, torch.float32),
              (s_up, torch.float32), (s_down, torch.float32))
    for t, dtype in dtypes:
        if t.device != x.device:
            raise ValueError("decode_mlp: all operands must be on one device")
        if t.dtype != dtype:
            raise TypeError(f"decode_mlp kernel takes {dtype} here, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_mlp kernel takes contiguous, 16-byte aligned tensors")
    shapes = ((ln_scale, (h,)), (w_gate, (h, inter)), (w_up, (h, inter)), (w_down, (inter, h)),
              (s_gate, (1, inter)), (s_up, (1, inter)), (s_down, (1, h)))
    if any(tuple(t.shape) != shape for t, shape in shapes):
        raise ValueError("decode_mlp: operand shapes do not match x [b, h]")


# The kernels' tiles (csrc/decode_mlp_int8.cu): 16 batch rows a block; (A)
# strips of 32 columns of I, stages of 256 k, a ring of 4; (B) strips of 128
# columns of h, stages of 64 k, a ring of 6, clusters of 8 blocks over I.
ROW_TILE = 16
GATEUP_STRIP, GATEUP_STAGE_K, GATEUP_STAGES = 32, 256, 4
DOWN_STRIP, DOWN_STAGE_K, DOWN_STAGES, DOWN_SPLIT = 128, 64, 6, 8
SMEM_LIMIT = 232_448  # bytes of shared memory an H100 block can use
CONSUMER_WARPS = 8


def decode_mlp_plan(b: int, h: int, inter: int, sm_count: int) -> dict:
    """The launch plan of the two kernels for x [b, h] and an intermediate
    width I: the row tiles; (A)'s grid (blocks per row tile x row tiles),
    each block's strips of I and the k stages (h padded to a whole stage);
    (B)'s grid (one cluster of DOWN_SPLIT blocks per strip of h and row
    tile, in the order the kernel numbers them) and each block's K range
    of I; both launches' shared memory and the bytes they read from L2.
    Raises on what the kernels do not take."""
    if inter % DOWN_STAGE_K or h % DOWN_STRIP:
        raise ValueError(f"decode_mlp kernel needs intermediate % {DOWN_STAGE_K} == 0 and hidden "
                         f"% {DOWN_STRIP} == 0 (intermediate={inter}, hidden={h})")
    row_tiles = -(-b // ROW_TILE)
    hp = -(-h // GATEUP_STAGE_K) * GATEUP_STAGE_K
    smem_a = (GATEUP_STAGES * 2 * GATEUP_STAGE_K * GATEUP_STRIP + ROW_TILE * (hp + 8) * 2
              + CONSUMER_WARPS * 2 * ROW_TILE * GATEUP_STRIP * 4 + 2 * GATEUP_STAGES * 8 + 1024)
    if smem_a > SMEM_LIMIT:
        raise ValueError(f"decode_mlp kernel: hidden {h} exceeds shared memory")
    ctas = max(1, sm_count // row_tiles)
    strips_a = inter // GATEUP_STRIP
    steps = inter // DOWN_STAGE_K
    k_ranges = [(r * steps // DOWN_SPLIT * DOWN_STAGE_K, (r + 1) * steps // DOWN_SPLIT
                 * DOWN_STAGE_K) for r in range(DOWN_SPLIT)]
    clusters = [(rt, s) for s in range(h // DOWN_STRIP) for rt in range(row_tiles)]
    smem_b = (DOWN_STAGES * (DOWN_STAGE_K * DOWN_STRIP + ROW_TILE * DOWN_STAGE_K * 2)
              + ROW_TILE * DOWN_STRIP * 4 + 2 * DOWN_STAGES * 8 + 1024)
    return {
        "row_tiles": row_tiles,
        "gateup": {"grid": (ctas, row_tiles), "strip": GATEUP_STRIP,
                   "strips": [list(range(p, strips_a, ctas)) for p in range(ctas)],
                   "stage_k": GATEUP_STAGE_K, "k_steps": hp // GATEUP_STAGE_K,
                   "stages": GATEUP_STAGES, "smem_bytes": smem_a},
        "down": {"grid": (DOWN_SPLIT * len(clusters),), "cluster": DOWN_SPLIT,
                 "clusters": clusters, "strip": DOWN_STRIP, "k_ranges": k_ranges,
                 "stage_k": DOWN_STAGE_K, "stages": DOWN_STAGES, "smem_bytes": smem_b},
        # each row tile reads all three weights (from L2 where the tiles meet);
        # each block of (A) its rows of x, each cluster of (B) its rows of the
        # scratch
        "l2_bytes": row_tiles * 3 * h * inter + ctas * row_tiles * ROW_TILE * h * 2
        + len(clusters) * ROW_TILE * inter * 2,
    }


def _launch(args, variant: int, eps: float, residual: bool = True):
    """Both launches of csrc/decode_mlp_int8.cu as `decode_mlp_plan` lays
    them out. variant 0 is the kernels; 1 drops their tensor-core products
    (a diagnostic of the loads alone, its result wrong) and 2 runs the
    previous CUDA-core design (residual only), both for chip_smoke.py's
    timings only. residual=False drops the + x."""
    x, w_gate = args[0], args[2]
    b, h = x.shape
    inter = w_gate.shape[1]
    plan = decode_mlp_plan(b, h, inter,
                           torch.cuda.get_device_properties(x.device).multi_processor_count)
    act = torch.empty((b, inter), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    ctas, row_tiles = plan["gateup"]["grid"]
    status = _build.load_library().agk_decode_mlp_int8(
        *(t.data_ptr() for t in args), act.data_ptr(), y.data_ptr(), b, h, inter, ctas,
        row_tiles, variant, float(eps), int(residual),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "decode_mlp")
    return y


def decode_mlp(x, ln_scale, w_gate, s_gate, w_up, s_up, w_down, s_down, *, eps: float = 1e-6,
               residual: bool = True):
    """x [b, h] (the post-attention residual stream), ln_scale [h], int8
    w_gate/w_up [h, I] with scales [1, I], int8 w_down [I, h] with scales
    [1, h] → the new residual stream [b, h]. residual=False returns the MLP
    alone, a tensor-parallel rank's partial sum over its columns of I, which
    the caller reduces over the ranks and adds to x once."""
    _build.refuse_grad("decode_mlp", x, ln_scale, w_gate, s_gate, w_up, s_up, w_down, s_down)
    args = (x, ln_scale, w_gate, s_gate, w_up, s_up, w_down, s_down)
    if x.device.type == "cpu":
        return decode_mlp_reference(*args, eps=eps, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"decode_mlp: no kernel for device {x.device}")
    _check_operands(*args)
    y = _launch(args, 0, eps, residual)
    decode_mlp.launches += 1
    return y


decode_mlp.launches = 0  # wrapper calls that launched the kernels since the last reset
