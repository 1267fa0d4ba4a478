"""Fused bf16 decode MLP: x + down(silu(gate(rms x)) · up(rms x)) for the
q=1 decode step (or, residual=False, the MLP alone: a tensor-parallel
rank's partial sum).

Port of affectgpt_tpu/ops/decode_mlp_bf16_pallas.py::decode_mlp_bf16. On a
CUDA tensor `decode_mlp_bf16` launches the hand-written kernels in
csrc/decode_mlp_bf16.cu (three launches in one call: the rmsnorm once a row
into a [b, h] scratch, then the swap-AB wgmma kernel of
csrc/decode_swapab.cuh for gate/up/silu·mul into a [b, I] scratch and for
down + residual) or raises; on a CPU tensor it runs
`decode_mlp_bf16_reference`, the plain PyTorch version, which is also the
oracle the kernels are checked against on the card.

Weights are in the JAX `[in, out]` layout, row-major: a gate/up tile reads
gate's columns c .. c + 63 and up's same columns, a down tile 128 columns
of h, so the kernel takes I % 64 == 0 and h % 128 == 0.
`decode_mlp_bf16_plan` is its launch plan, cached by shape.
"""

from __future__ import annotations

import functools

import torch

from affectgpt_tpu_torch.ops import _build, decode_gemm


def decode_mlp_bf16_reference(x, ln_scale, w_gate, w_up, w_down, *, eps: float = 1e-6,
                              residual: bool = True):
    """Plain version with the TPU kernel's rounding points: xn rounded to the
    weight dtype, gate/up with f32 accumulation, silu·up rounded to the
    weight dtype, down with f32 accumulation, + x (unless residual=False),
    then x.dtype."""
    xf = x.float()
    xn = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * ln_scale.float()
    xn = xn.to(w_gate.dtype).float()
    g = xn @ w_gate.float()
    u = xn @ w_up.float()
    a = (torch.nn.functional.silu(g) * u).to(w_gate.dtype).float()
    y = a @ w_down.float()
    return (xf + y if residual else y).to(x.dtype)


def mlp_segments(h: int, inter: int) -> dict:
    """The two products' tiles (csrc/decode_mlp_bf16.cu): gate/up, a tile of
    gate's 64 columns (map 0) and up's same 64 (map 1); down, 128-column
    tiles of h."""
    return {"gateup": [dict(tiles=inter // 64, kind=decode_gemm.SILU_MUL, map0=0, map1=1,
                            head_dim=0)],
            "down": [dict(tiles=h // 128, kind=decode_gemm.RESIDUAL, map0=0, map1=0,
                          head_dim=0)]}


def decode_mlp_bf16_plan(b: int, h: int, inter: int, sms: int, active_clusters=None) -> dict:
    """The launch plan at b rows on a card of `sms` SMs: gate/up (K = h over
    I / 64 tiles) and down (K = I over h / 128 tiles), each the swap-AB
    kernel's gemm plan (active_clusters: as decode_gemm.gemm_plan takes it),
    and the launches a call makes (the rmsnorm pass and the two products)."""
    return {"gateup": decode_gemm.gemm_plan(b, h, inter // 64, sms, active_clusters),
            "down": decode_gemm.gemm_plan(b, inter, h // 128, sms, active_clusters),
            "segments": mlp_segments(h, inter), "launches": 3}


@functools.lru_cache(maxsize=None)
def _plan_on(b, h, inter, device_index) -> dict:
    return decode_mlp_bf16_plan(b, h, inter, _build.sm_count(device_index),
                                decode_gemm.active_clusters_on_card)


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
    if inter % 64 or h % 128:
        raise ValueError(
            f"decode_mlp_bf16 kernel needs intermediate % 64 == 0 and hidden % 128 == 0 "
            f"(intermediate={inter}, hidden={h})"
        )
    if not 1 <= b <= 2 * decode_gemm.NB_WIDTHS[-1]:
        raise ValueError(
            f"decode_mlp_bf16 kernel takes 1 to {2 * decode_gemm.NB_WIDTHS[-1]} rows, got {b}")


def decode_mlp_bf16(x, ln_scale, w_gate, w_up, w_down, *, eps: float = 1e-6,
                    residual: bool = True):
    """x [b, h] (the post-attention residual stream), ln_scale [h],
    w_gate/w_up [h, I], w_down [I, h] → the new residual stream [b, h].
    residual=False returns the MLP alone, without + x: a tensor-parallel
    rank's partial sum over its columns of I, which the caller reduces over
    the ranks and adds to x once."""
    _build.refuse_grad("decode_mlp_bf16", x, ln_scale, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return decode_mlp_bf16_reference(x, ln_scale, w_gate, w_up, w_down, eps=eps,
                                         residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"decode_mlp_bf16: no kernel for device {x.device}")
    _check_operands(x, ln_scale, w_gate, w_up, w_down)
    b, h = x.shape
    inter = w_gate.shape[1]
    plan = _plan_on(b, h, inter, x.device.index or 0)
    a, d = plan["gateup"], plan["down"]
    xn = torch.empty_like(x)
    act = torch.empty((b, inter), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lib = _build.load_library()
    status = lib.agk_decode_mlp_bf16(
        x.data_ptr(), ln_scale.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
        w_down.data_ptr(), xn.data_ptr(), act.data_ptr(), y.data_ptr(), b, h, inter,
        a["nb"], a["cb"], a["ck"], a["stages"], d["nb"], d["cb"], d["ck"], d["stages"],
        float(eps), int(residual), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "decode_mlp_bf16")
    decode_mlp_bf16.launches += 1
    return y


decode_mlp_bf16.launches = 0  # wrapper calls that launched the kernels since the last reset
