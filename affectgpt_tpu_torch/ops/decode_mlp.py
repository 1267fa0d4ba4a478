"""Fused int8 decode MLP: x + down(silu(gate(rms x)) · up(rms x)) for the
q=1 decode step, on per-channel int8 weights.

Port of affectgpt_tpu/ops/decode_mlp_pallas.py::decode_mlp_pallas. On a CUDA
tensor `decode_mlp` launches the hand-written kernels in
csrc/decode_mlp_int8.cu (two launches in one call: gate/up into a [b, I]
scratch, then down + scales + residual) or raises; on a CPU tensor it runs
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
                         eps: float = 1e-6):
    """Plain version with the TPU kernel's rounding points, which are bf16
    whatever x's dtype (decode_mlp_pallas.py:66, :74): xn rounded to bf16,
    gate/up as f32 sums of bf16 products times their column scales,
    silu(g)·u rounded to bf16, down as an f32 sum times its column scales,
    + x, then x.dtype."""
    bf = torch.bfloat16
    xf = x.float()
    xn = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * ln_scale.float()
    xn = xn.to(bf).float()
    g = (xn @ w_gate.float()) * s_gate.float()
    u = (xn @ w_up.float()) * s_up.float()
    a = (torch.nn.functional.silu(g) * u).to(bf).float()
    return (xf + (a @ w_down.float()) * s_down.float()).to(x.dtype)


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
    if inter % 64 or h % 32:
        raise ValueError(
            f"decode_mlp kernel needs intermediate % 64 == 0 and hidden % 32 == 0 "
            f"(intermediate={inter}, hidden={h})"
        )
    if 16 * h + 18 * 8 * 64 * 4 > 227 * 1024:
        raise ValueError(f"decode_mlp kernel: hidden {h} exceeds shared memory")


def decode_mlp(x, ln_scale, w_gate, s_gate, w_up, s_up, w_down, s_down, *, eps: float = 1e-6):
    """x [b, h] (the post-attention residual stream), ln_scale [h], int8
    w_gate/w_up [h, I] with scales [1, I], int8 w_down [I, h] with scales
    [1, h] → the new residual stream [b, h]."""
    args = (x, ln_scale, w_gate, s_gate, w_up, s_up, w_down, s_down)
    if x.device.type == "cpu":
        return decode_mlp_reference(*args, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"decode_mlp: no kernel for device {x.device}")
    _check_operands(*args)
    b, h = x.shape
    inter = w_gate.shape[1]
    act = torch.empty((b, inter), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lib = _build.load_library()
    status = lib.agk_decode_mlp_int8(
        *(t.data_ptr() for t in args), act.data_ptr(), y.data_ptr(), b, h, inter, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "decode_mlp")
    decode_mlp.launches += 1
    return y


decode_mlp.launches = 0  # wrapper calls that launched the kernels since the last reset
