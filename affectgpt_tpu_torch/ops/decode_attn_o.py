"""The decode attention sublayer's back half: attention over the dense KV
cache for one query token per row → o_proj → + residual (residual=False:
without it, a tensor-parallel rank's partial sum).

Port of affectgpt_tpu/ops/decode_attn_o_pallas.py::decode_attn_o. On a CUDA
tensor `decode_attn_o` launches the hand-written kernels of
csrc/decode_attn_o.cu (or raises): the attention in one launch
(csrc/dense_decode_attention.cuh: each (row, kv head) window split over a
cluster of blocks by ops/decode_attention.py's `attention_plan`, products on
tensor cores, the splits merged through distributed shared memory), then
o_proj + residual on the swap-AB wgmma kernel of csrc/decode_swapab.cuh
(`decode_gemm.gemm_plan`), launched as the attention's programmatic
dependent. On a CPU tensor it runs
`decode_attn_o_reference`, the plain PyTorch version, which is also the
oracle the kernels are checked against on the card.

The key mask must be one contiguous window of valid columns per row (the
decode step's shape: left pads invalid, columns up to the write index
valid). As the TPU wrapper does (decode_attn_o_pallas.py:135-137), the
mask is reduced to the first and last valid column of each row, and a row
with no valid column becomes the window [0, T-1]; the kernel makes that
reduction itself, from the mask row, which spares the call the half-dozen
small launches of `key_window`.

Limits of the kernels: hidden % 128 == 0 (o_proj's 128-column tiles), kv
groups head_dim % 64 == 0, head_dim 64 or 128, at most 8 query heads per kv
head, b <= 512 (the swap-AB kernel's rows); every Qwen2.5 width is inside.
"""

from __future__ import annotations

import functools

import torch

from affectgpt_tpu_torch.ops import _build, decode_gemm
from affectgpt_tpu_torch.ops.decode_attention import (
    WINDOW,
    attend_f32,
    attention_plan,
    check_cache_operands,
)


def key_window(key_mask: torch.Tensor) -> torch.Tensor:
    """[b, 2] int32 (first True, last True) of each row of a bool [b, T]
    mask; argmax takes the first maximum, as jnp.argmax does."""
    valid = key_mask.to(torch.int32)
    lo = torch.argmax(valid, dim=1)
    hi = key_mask.shape[1] - 1 - torch.argmax(valid.flip(1), dim=1)
    return torch.stack([lo, hi], dim=1).to(torch.int32)


def decode_attn_o_reference(x_res, q, k_cache, v_cache, key_mask, wo, residual: bool = True):
    """Plain version with the TPU kernel's rounding points: attention over
    the key window in f32, rounded to x's dtype (decode_attn_o_pallas.py:100),
    o_proj with f32 accumulation, + x in f32 (unless residual=False), one
    final rounding (:101-102)."""
    window = key_window(key_mask)
    cols = torch.arange(k_cache.shape[2], device=q.device)
    in_window = (cols[None, :] >= window[:, :1]) & (cols[None, :] <= window[:, 1:])
    attn = attend_f32(q, k_cache, v_cache, in_window).to(x_res.dtype)
    y = attn.reshape(x_res.shape[0], -1).float() @ wo.float()
    return (x_res.float() + y if residual else y).to(x_res.dtype)


def decode_attn_o_plan(b: int, kv: int, g: int, d: int, t_len: int, h: int, sms: int,
                       active_clusters=None) -> dict:
    """The call's plan on a card of `sms` SMs: the attention launch
    (`decode_attention.attention_plan` under its WINDOW rule) and o_proj +
    residual (K = kv g d over h / 128 tiles; `decode_gemm.gemm_plan`,
    active_clusters as it takes it) with its one segment (128 columns of h a
    tile, the residual epilogue), the launches a call makes. Raises on what
    the kernels do not take."""
    nq = kv * g * d
    if h % 128 or nq % 64:
        raise ValueError(f"decode_attn_o kernel needs hidden % 128 == 0 and kv * groups * "
                         f"head_dim % 64 == 0 (hidden={h}, kv*groups*head_dim={nq})")
    return {"attention": attention_plan(b, kv, g, d, t_len, sms, WINDOW),
            "o_proj": decode_gemm.gemm_plan(b, nq, h // 128, sms, active_clusters),
            "segments": [dict(tiles=h // 128, kind=decode_gemm.RESIDUAL, map0=0, map1=0,
                              head_dim=0)], "launches": 2}


@functools.lru_cache(maxsize=None)
def _plan_on(b, kv, g, d, t_len, h, device_index) -> dict:
    return decode_attn_o_plan(b, kv, g, d, t_len, h, _build.sm_count(device_index),
                              decode_gemm.active_clusters_on_card)


def decode_attn_o(x_res, q, k_cache, v_cache, key_mask, wo, residual: bool = True):
    """x_res [b, h] (the raw residual stream, pre-attention), q [b, kv,
    groups, d] (roped), k_cache/v_cache [b, kv, T, d] (already holding the
    new token's k/v), key_mask [b, T] bool, wo [kv*groups*d, h]. Returns
    x_res + o_proj(attention) [b, h] in x_res.dtype; residual=False returns
    o_proj(attention) alone, a tensor-parallel rank's partial sum over its
    heads, which the caller reduces over the ranks and adds to x once."""
    _build.refuse_grad("decode_attn_o", x_res, q, k_cache, v_cache, key_mask, wo)
    if q.device.type == "cpu":
        return decode_attn_o_reference(x_res, q, k_cache, v_cache, key_mask, wo,
                                       residual=residual)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn_o: no kernel for device {q.device}")
    check_cache_operands("decode_attn_o", q, k_cache, v_cache, key_mask)
    b, kv, groups, d = q.shape
    h = x_res.shape[1]
    nq = kv * groups * d
    for t in (x_res, wo):
        if (t.device != q.device or t.dtype != torch.bfloat16 or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("decode_attn_o: x_res and wo must be contiguous, 16-byte aligned "
                             "bf16 on q's device")
    if tuple(x_res.shape) != (b, h) or tuple(wo.shape) != (nq, h):
        raise ValueError(f"decode_attn_o: x_res {tuple(x_res.shape)} / wo {tuple(wo.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not 1 <= b <= 2 * decode_gemm.NB_WIDTHS[-1]:
        raise ValueError(f"decode_attn_o kernel takes 1 to {2 * decode_gemm.NB_WIDTHS[-1]} "
                         f"rows, got {b}")
    t_len = k_cache.shape[2]
    plan = _plan_on(b, kv, groups, d, t_len, h, q.device.index or 0)
    a, o = plan["attention"], plan["o_proj"]
    key_mask = key_mask.contiguous()
    attn = torch.empty((b, nq), dtype=x_res.dtype, device=q.device)
    y = torch.empty_like(x_res)
    lib = _build.load_library()
    status = lib.agk_decode_attn_o_bf16(
        x_res.data_ptr(), q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        key_mask.data_ptr(), wo.data_ptr(), attn.data_ptr(), y.data_ptr(), b, kv, groups, t_len,
        d, h, a["splits"], a["stages"], o["nb"], o["cb"], o["ck"], o["stages"], int(residual),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "decode_attn_o")
    decode_attn_o.launches += 1
    return y


decode_attn_o.launches = 0  # wrapper calls that launched the kernels since the last reset
