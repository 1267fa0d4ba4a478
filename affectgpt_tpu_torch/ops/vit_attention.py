"""Fused non-causal ViT attention with a `valid_len` key mask.

Port of affectgpt_tpu/ops/vit_attention_pallas.py (`fused_vit_attention`,
`fused_self_attention`, `mha_fused`). On CUDA tensors the kernel of
csrc/vit_attention.cu runs (or the wrapper raises); on CPU tensors
`fused_vit_attention_reference`, the plain PyTorch version, which is also
the oracle the kernel is checked against on the card.

The kernel takes what the TPU kernel takes under JAX's route gate: any
head_dim d with d % 8 == 0 and 32 <= d <= 128 (HEAD_DIMS) and any number of
tokens. `vit_attention_plan` names its design for a shape: at head_dim 64
with at most RESIDENT_KEYS valid keys a unit's K and V stay in shared
memory (one pass up to ONE_PASS_KEYS valid keys, two beyond); every other
shape streams K and V through a ring of STREAM_STAGES TMA stages in two
passes ("stream": DINOv2-large's 1370 tokens, SigLIP so400m's head_dim 72).
It reads q, k and v through strides: `fused_self_attention` hands it the [b,
t, h, d] layout of the projections as it is (JAX transposes to [b, h, t, d]
and pads t to a multiple of 8, both TPU layout costs). Keys at or past
`valid_len` are masked; every query row is computed.
"""

from __future__ import annotations

from typing import Optional

import torch

from affectgpt_tpu_torch.ops import _build

HEAD_DIM = 64  # the head_dim of the resident designs
HEAD_DIMS = range(32, 129, 8)  # every head_dim the kernel takes
RESIDENT_KEYS = 512  # the most valid keys whose K and V a unit keeps in shared memory
TILE = 64  # query rows of a warpgroup, keys of a tile
ONE_PASS_KEYS = 320  # the one-pass kernel holds up to 5 key tiles of scores in registers
STREAM_STAGES = 8  # the streaming design's ring of K / V tiles
SMEM_PER_SM = 233_472  # bytes of shared memory an H100 SM holds (1 KB of it reserved a block)
_HEAD_BYTES = (4 + 4 * 2 * (RESIDENT_KEYS // TILE)) * 8 + 4 * 4  # barriers and counters
_TILE_BYTES = TILE * HEAD_DIM * 2
_BOX_BYTES = 64 * 128  # a 64-row box of 64 bf16 values


def vit_attention_plan(n: int, valid_len: Optional[int] = None, b: int = 1, heads: int = 1,
                       sms: int = 132, head_dim: int = HEAD_DIM) -> dict:
    """The kernel's launch for n tokens (keys >= valid_len masked, default
    n) at head_dim, as csrc/vit_attention.cu computes it. Raises, naming the
    limit, beyond 1 <= valid_len <= n and head_dim in HEAD_DIMS.

    Resident designs (head_dim 64, at most RESIDENT_KEYS valid keys;
    csrc/vit_attention.cuh): one pass while the valid keys fit
    ONE_PASS_KEYS (every score of a row held in registers, exp once per
    pair), else two passes (max and sum first, then the scores again,
    normalised, rounded, times V); the key tiles (those with a key <
    valid_len); the units (image, head), whose K and V a block keeps in
    shared memory while their 64-row query tiles go to its two warpgroups in
    turn; the K/V buffers a block keeps ahead (`kv_slots`); blocks an SM
    (two for the one-pass kernel of up to two key tiles, else one).

    Streaming design (every other shape; csrc/vit_attention_stream.cuh):
    items of two 64-row query tiles of a unit, one a warpgroup; both read
    the item's key tiles through a ring of STREAM_STAGES stages, three a
    key tile (K in pass 1, K and V in pass 2); the products run at the
    head_dim rounded up to 16 (`padded_head_dim`) over ceil(padded / 64)
    boxes a tile. Both: the persistent grid and the shared memory a
    block."""
    valid = n if valid_len is None else valid_len
    if not 1 <= valid <= n:
        raise ValueError(f"fused_vit_attention kernel takes 1 <= valid_len <= n (n={n}, "
                         f"valid_len={valid})")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"fused_vit_attention kernel takes head_dim % 8 == 0 from "
                         f"{HEAD_DIMS[0]} to {HEAD_DIMS[-1]} (head_dim={head_dim})")
    tiles = -(-valid // TILE)
    q_tiles = -(-n // TILE)
    units = b * heads
    if head_dim != HEAD_DIM or valid > RESIDENT_KEYS:
        padded = -(-head_dim // 16) * 16
        tile_bytes = -(-padded // 64) * _BOX_BYTES
        items = units * -(-q_tiles // 2)
        return {"kernel": "stream", "padded_head_dim": padded, "key_tiles": tiles,
                "score_registers": 32, "q_tiles": q_tiles, "units": units, "items": items,
                "ring_stages": STREAM_STAGES, "blocks_per_sm": 1, "blocks": min(items, sms),
                "smem_bytes": 1024 + 256 + (4 + STREAM_STAGES) * tile_bytes}
    one_pass = tiles * TILE <= ONE_PASS_KEYS
    per_sm = 2 if one_pass and tiles <= 2 else 1
    share = SMEM_PER_SM // per_sm - 1024
    room = (share - 1024 - _HEAD_BYTES - 4 * _TILE_BYTES) // (2 * tiles * _TILE_BYTES)
    slots = max(1, min(4, room))
    return {"kernel": "one_pass" if one_pass else "two_pass", "padded_head_dim": HEAD_DIM,
            "key_tiles": tiles, "score_registers": 32 * tiles if one_pass else 32,
            "q_tiles": q_tiles, "units": units, "kv_slots": slots, "blocks_per_sm": per_sm,
            "blocks": min(units, per_sm * sms),
            "smem_bytes": 1024 + _HEAD_BYTES + (4 + slots * 2 * tiles) * _TILE_BYTES}


def fused_vit_attention_reference(q, k, v, valid_len: int):
    """Plain version with the TPU kernel's rounding points: q, k, v
    [b, h, n, d] → softmax(q·kᵀ · 1/√d, keys ≥ valid_len at −1e30)·v, with
    f32 scores, p normalized and then rounded to v's dtype, f32 PV rounded
    once to q's dtype."""
    n, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / float(d) ** 0.5)
    keep = torch.arange(k.shape[2], device=q.device) < valid_len
    s = torch.where(keep, s, torch.full((), -1e30, device=q.device))
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def _attention(q, k, v, valid_len: int, out):
    """Launch the kernel on [b, h, n, d] views (any strides with head_dim
    contiguous, one set for q, k and v) writing the [b, h, n, d] view `out`."""
    b, h, n, d = q.shape
    for t in (q, k, v, out):
        if t.device != q.device:
            raise ValueError("fused_vit_attention: all operands must be on one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_vit_attention kernel takes bfloat16, got {t.dtype}")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            raise ValueError("fused_vit_attention kernel takes a contiguous head_dim and "
                             "16-byte aligned rows")
    if tuple(k.shape) != (b, h, n, d) or k.shape != v.shape or k.stride() != q.stride() \
            or v.stride() != q.stride():
        raise ValueError("fused_vit_attention: q, k and v need one shape and one layout")
    vit_attention_plan(n, valid_len, head_dim=d)  # raises beyond the kernel's limits
    lib = _build.load_library()
    status = lib.agk_vit_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, int(valid_len), d,
        q.stride(0), q.stride(1), q.stride(2), out.stride(0), out.stride(1), out.stride(2),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "fused_vit_attention")
    fused_vit_attention.launches += 1
    return out


def fused_vit_attention(q, k, v, valid_len: int):
    """q, k, v [b, h, n, d] (keys ≥ valid_len masked) → [b, h, n, d] in
    q.dtype."""
    _build.refuse_grad("fused_vit_attention", q, k, v)
    if q.device.type == "cpu":
        return fused_vit_attention_reference(q, k, v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"fused_vit_attention: no kernel for device {q.device}")
    return _attention(q, k, v, valid_len, torch.empty(q.shape, dtype=q.dtype, device=q.device))


fused_vit_attention.launches = 0  # kernel launches since the last reset


def fused_self_attention(q, k, v, valid_len: int):
    """q, k, v [b, t, h, d] (keys ≥ valid_len masked) → [b, t, h, d]."""
    _build.refuse_grad("fused_self_attention", q, k, v)
    if q.device.type == "cpu":
        o = fused_vit_attention_reference(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), valid_len)
        return o.transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"fused_self_attention: no kernel for device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), valid_len,
               out.transpose(1, 2))
    return out


def mha_fused(params: dict, x, num_heads: int, valid_len: int):
    """nn.mha(params, x, x, num_heads) on self-attention inputs x [b, n, w]
    with keys ≥ valid_len masked: the projections as plain dense layers, the
    softmax chain in the kernel."""
    from affectgpt_tpu_torch.models import nn

    b, n, _ = x.shape
    inner = nn.out_dim(params["q"])
    d = inner // num_heads
    q = nn.dense(params["q"], x).reshape(b, n, num_heads, d)
    k = nn.dense(params["k"], x).reshape(b, n, num_heads, d)
    v = nn.dense(params["v"], x).reshape(b, n, num_heads, d)
    o = fused_self_attention(q, k, v, valid_len).reshape(b, n, inner).to(x.dtype)
    return nn.dense(params["o"], o)
