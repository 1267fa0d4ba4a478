"""Fused decode-QKV: optional rmsnorm → q/k/v projections + bias → RoPE,
for the q=1 decode step.

Port of affectgpt_tpu/ops/decode_qkv_pallas.py::decode_qkv. On a CUDA
tensor `decode_qkv` launches the hand-written kernels in
csrc/decode_qkv.cu (the rmsnorm once a row when ln_scale is given, then the
swap-AB wgmma kernel of csrc/decode_swapab.cuh over q/k/v's 128-column
tiles) or raises; on a CPU tensor it runs `decode_qkv_reference`, the plain
PyTorch version, which is also the oracle the kernel is checked against on
the card.

Weights are in the JAX `[in, out]` layout (`x @ w`), row-major; a tile reads
64 columns of a head's first half and the 64 they rotate with from its
second half, so the kernel takes head_dim % 128 == 0 (Qwen2.5's 128).
`decode_qkv_plan` is its launch plan, cached by shape.
"""

from __future__ import annotations

import functools

import torch

from affectgpt_tpu_torch.ops import _build, decode_gemm


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """f32 cos/sin [b, head_dim/2] at per-row positions, computed as the TPU
    kernel's wrapper does (decode_qkv_pallas.py:103-106); the CUDA kernel
    computes the same in its epilogue."""
    freqs = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
                  / head_dim)
    )
    angles = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rms_rounded(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps) * scale.float()
    return y.to(x.dtype)


def _rope_rows(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, head_dim: int):
    """Half-split RoPE on f32 rows [b, n*head_dim] with cos/sin [b, head_dim/2]."""
    b = y.shape[0]
    y = y.reshape(b, -1, head_dim)
    a, c = y.chunk(2, dim=-1)
    cs, sn = cos[:, None, :], sin[:, None, :]
    return torch.cat([a * cs - c * sn, c * cs + a * sn], dim=-1).reshape(b, -1)


def decode_qkv_reference(
    x, positions, wq, bq, wk, bk, wv, bv, *, num_heads: int, num_kv_heads: int,
    head_dim: int, theta: float, ln_scale=None, eps: float = 1e-6,
):
    """Plain version: rmsnorm (rounded to x.dtype) → three projections with
    f32 accumulation + bias → RoPE in f32 → x.dtype.
    Returns (q [b, H*d], k [b, kv*d], v [b, kv*d])."""
    if ln_scale is not None:
        x = _rms_rounded(x, ln_scale, eps)
    xf = x.float()
    cos, sin = rope_tables(positions, head_dim, theta)

    def proj(w, bias):
        return xf @ w.float() + bias.float()

    q = _rope_rows(proj(wq, bq), cos, sin, head_dim)
    k = _rope_rows(proj(wk, bk), cos, sin, head_dim)
    return q.to(x.dtype), k.to(x.dtype), proj(wv, bv).to(x.dtype)


def qkv_segments(nq: int, nkv: int, head_dim: int) -> list:
    """The kernel's three runs of 128-column tiles: q and k with RoPE, v
    with its bias only (csrc/decode_qkv.cu)."""
    return [dict(tiles=n // 128, kind=kind, map0=i, map1=i, head_dim=head_dim)
            for i, (n, kind) in enumerate(((nq, decode_gemm.ROPE), (nkv, decode_gemm.ROPE),
                                           (nkv, decode_gemm.BIAS)))]


def decode_qkv_plan(b: int, h: int, nq: int, nkv: int, head_dim: int, sms: int,
                    active_clusters=None) -> dict:
    """The launch plan at b rows of hidden h (K) on a card of `sms` SMs: the
    swap-AB kernel's gemm plan over q/k/v's tiles (active_clusters: as
    decode_gemm.gemm_plan takes it), and the launches a call makes (the
    rmsnorm pass, then the projections)."""
    plan = decode_gemm.gemm_plan(b, h, (nq + 2 * nkv) // 128, sms, active_clusters)
    return {**plan, "segments": qkv_segments(nq, nkv, head_dim), "launches_with_ln": 2,
            "launches_without_ln": 1}


@functools.lru_cache(maxsize=None)
def _plan_on(b, h, nq, nkv, head_dim, device_index) -> dict:
    return decode_qkv_plan(b, h, nq, nkv, head_dim, _build.sm_count(device_index),
                           decode_gemm.active_clusters_on_card)


def _check_operands(x, positions, ln_scale, weights, biases, num_heads, num_kv_heads, head_dim):
    b, h = x.shape
    nq, nkv = num_heads * head_dim, num_kv_heads * head_dim
    tensors = [x, *weights, *biases] + ([ln_scale] if ln_scale is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError("decode_qkv: all operands must be on one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_qkv kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("decode_qkv kernel takes contiguous, 16-byte aligned tensors")
    shapes = [(h, nq), (h, nkv), (h, nkv)]
    if [tuple(w.shape) for w in weights] != shapes:
        raise ValueError(f"decode_qkv: weight shapes {[tuple(w.shape) for w in weights]} != {shapes}")
    if [tuple(v.shape) for v in biases] != [(nq,), (nkv,), (nkv,)]:
        raise ValueError("decode_qkv: bias shapes do not match the projections")
    if ln_scale is not None and tuple(ln_scale.shape) != (h,):
        raise ValueError("decode_qkv: ln_scale must be [hidden]")
    if tuple(positions.shape) != (b,) or positions.device != x.device:
        raise ValueError("decode_qkv: positions must be [b] on the device of x")
    if head_dim % 128 or h % 8:
        raise ValueError(
            f"decode_qkv kernel needs head_dim % 128 == 0 and hidden % 8 == 0 "
            f"(head_dim={head_dim}, hidden={h})"
        )
    if not 1 <= b <= 2 * decode_gemm.NB_WIDTHS[-1]:
        raise ValueError(f"decode_qkv kernel takes 1 to {2 * decode_gemm.NB_WIDTHS[-1]} rows, got {b}")


def decode_qkv(
    x, positions, wq, bq, wk, bk, wv, bv, *, num_heads: int, num_kv_heads: int,
    head_dim: int, theta: float, ln_scale=None, eps: float = 1e-6,
):
    """x [b, h] (the raw residual stream when ln_scale [h] is given, else
    already normalized), positions [b] int; wq [h, H*d], wk/wv [h, kv*d],
    biases [H*d]/[kv*d]. Returns (q [b, H*d], k [b, kv*d], v [b, kv*d]) in
    x.dtype, q and k roped at positions."""
    _build.refuse_grad("decode_qkv", x, positions, wq, bq, wk, bk, wv, bv, ln_scale)
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              theta=theta, ln_scale=ln_scale, eps=eps)
    if x.device.type == "cpu":
        return decode_qkv_reference(x, positions, wq, bq, wk, bk, wv, bv, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"decode_qkv: no kernel for device {x.device}")
    _check_operands(x, positions, ln_scale, (wq, wk, wv), (bq, bk, bv),
                    num_heads, num_kv_heads, head_dim)
    b, h = x.shape
    nq, nkv = num_heads * head_dim, num_kv_heads * head_dim
    plan = _plan_on(b, h, nq, nkv, head_dim, x.device.index or 0)
    positions = positions.to(torch.int32).contiguous()
    q = torch.empty((b, nq), dtype=x.dtype, device=x.device)
    k = torch.empty((b, nkv), dtype=x.dtype, device=x.device)
    v = torch.empty((b, nkv), dtype=x.dtype, device=x.device)
    xn = None if ln_scale is None else torch.empty_like(x)
    lib = _build.load_library()
    status = lib.agk_decode_qkv_bf16(
        x.data_ptr(), None if ln_scale is None else ln_scale.data_ptr(), positions.data_ptr(),
        wq.data_ptr(), bq.data_ptr(), wk.data_ptr(), bk.data_ptr(),
        wv.data_ptr(), bv.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if xn is None else xn.data_ptr(), b, h, nq, nkv, head_dim,
        plan["nb"], plan["cb"], plan["ck"], plan["stages"], float(eps), float(theta),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "decode_qkv")
    decode_qkv.launches += 1
    return q, k, v


decode_qkv.launches = 0  # wrapper calls that launched the kernels since the last reset
