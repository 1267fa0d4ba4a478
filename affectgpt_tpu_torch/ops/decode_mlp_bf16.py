"""Fused bf16 decode MLP: x + down(silu(gate(rms x)) · up(rms x)) for the
q=1 decode step.

Port of affectgpt_tpu/ops/decode_mlp_bf16_pallas.py::decode_mlp_bf16. On a
CUDA tensor `decode_mlp_bf16` launches the hand-written kernels in
csrc/decode_mlp_bf16.cu (two launches in one call: gate/up into a [b, I]
scratch, then down + residual) or raises; on a CPU tensor it runs
`decode_mlp_bf16_reference`, the plain PyTorch version, which is also the
oracle the kernels are checked against on the card.

Weights are in the JAX `[in, out]` layout, row-major: gate/up [h, I] are
read in 64-column strips, down [I, h] in 32-column strips.
"""

from __future__ import annotations

import torch

from affectgpt_tpu_torch.ops import _build


def decode_mlp_bf16_reference(x, ln_scale, w_gate, w_up, w_down, *, eps: float = 1e-6):
    """Plain version with the TPU kernel's rounding points: xn rounded to the
    weight dtype, gate/up with f32 accumulation, silu·up rounded to the
    weight dtype, down with f32 accumulation, + x, then x.dtype."""
    xf = x.float()
    xn = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * ln_scale.float()
    xn = xn.to(w_gate.dtype).float()
    g = xn @ w_gate.float()
    u = xn @ w_up.float()
    a = (torch.nn.functional.silu(g) * u).to(w_gate.dtype).float()
    return (xf + a @ w_down.float()).to(x.dtype)


def _check_operands(x, ln_scale, w_gate, w_up, w_down):
    b, h = x.shape
    inter = w_gate.shape[-1]
    for t in (x, ln_scale, w_gate, w_up, w_down):
        if t.device != x.device:
            raise ValueError("decode_mlp_bf16: all operands must be on one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_mlp_bf16 kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_mlp_bf16 kernel takes contiguous, 16-byte aligned tensors")
    if (tuple(ln_scale.shape) != (h,) or tuple(w_gate.shape) != (h, inter)
            or tuple(w_up.shape) != (h, inter) or tuple(w_down.shape) != (inter, h)):
        raise ValueError("decode_mlp_bf16: operand shapes do not match x [b, h]")
    if inter % 64 or h % 32:
        raise ValueError(
            f"decode_mlp_bf16 kernel needs intermediate % 64 == 0 and hidden % 32 == 0 "
            f"(intermediate={inter}, hidden={h})"
        )
    if 16 * h + 18 * 8 * 64 * 4 > 227 * 1024:
        raise ValueError(f"decode_mlp_bf16 kernel: hidden {h} exceeds shared memory")


def decode_mlp_bf16(x, ln_scale, w_gate, w_up, w_down, *, eps: float = 1e-6):
    """x [b, h] (the post-attention residual stream), ln_scale [h],
    w_gate/w_up [h, I], w_down [I, h] → the new residual stream [b, h]."""
    if x.device.type == "cpu":
        return decode_mlp_bf16_reference(x, ln_scale, w_gate, w_up, w_down, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"decode_mlp_bf16: no kernel for device {x.device}")
    _check_operands(x, ln_scale, w_gate, w_up, w_down)
    b, h = x.shape
    inter = w_gate.shape[1]
    act = torch.empty((b, inter), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lib = _build.load_library()
    status = lib.agk_decode_mlp_bf16(
        x.data_ptr(), ln_scale.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), act.data_ptr(), y.data_ptr(), b, h, inter, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "decode_mlp_bf16")
    decode_mlp_bf16.launches += 1
    return y


decode_mlp_bf16.launches = 0  # wrapper calls that launched the kernels since the last reset
