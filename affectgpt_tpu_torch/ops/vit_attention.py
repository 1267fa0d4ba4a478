"""Fused non-causal ViT attention with a `valid_len` key mask.

Port of affectgpt_tpu/ops/vit_attention_pallas.py (`fused_vit_attention`,
`fused_self_attention`, `mha_fused`). On CUDA tensors the kernel of
csrc/vit_attention.cu runs (or the wrapper raises); on CPU tensors
`fused_vit_attention_reference`, the plain PyTorch version, which is also
the oracle the kernel is checked against on the card.

The kernel takes what the TPU kernel takes under JAX's route gate: any
head_dim d with d % 8 == 0 and 32 <= d <= 128 (HEAD_DIMS) and any number of
tokens. Every shape takes the flash design (csrc/vit_attention_flash.cu):
K and V streamed through two TMA rings in one pass with an online softmax,
whose p is rounded to bf16 before it is normalised, a deliberate departure
from the TPU kernel's rounding point (normalise, then round), of the same
size, where SDPA rounds too. The resident designs (csrc/vit_attention.cuh:
at head_dim 64 with at most RESIDENT_KEYS valid keys a unit's K and V stay
in shared memory; p normalised and then rounded, as on the TPU) took more
time at every shape they hold that was timed (CLIP's 257 tokens,
ImageBind's 229, HuBERT's 99; PERF.md section 6), so they serve only as row
11's attention step (ops/vit_sublayer.py). `vit_attention_plan` gives the
flash design's launch for a shape. It reads q, k and v through strides:
`fused_self_attention` hands it the [b, t, h, d] layout of the projections
as it is (JAX transposes to [b, h, t, d] and pads t to a multiple of 8,
both TPU layout costs). Keys at or past `valid_len` are masked; every query
row is computed.
"""

from __future__ import annotations

from typing import Optional

import torch

from affectgpt_tpu_torch.ops import _build

HEAD_DIM = 64  # CLIP's and HuBERT's head_dim, the resident designs' (row 11's attention step)
HEAD_DIMS = range(32, 129, 8)  # every head_dim the kernel takes
RESIDENT_KEYS = 512  # the most valid keys whose K and V a unit keeps in shared memory
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use
_BOX_BYTES = 64 * 128  # a 64-row box of 64 bf16 values
# the flash design's launch shape (csrc/vit_attention_flash.cu, Cfg):
# consumer warpgroups of 64 query rows a block, keys of a key tile, and a
# consumer's and the producer's registers a thread after setmaxnreg; at a
# head_dim rounded up to 16 in WIDE_HEAD_DIMS (SigLIP's 72), and at any other
FLASH_WIDE_SHAPE = (3, 64, 160, 32)
FLASH_SHAPE = (2, 128, 240, 24)
WIDE_HEAD_DIMS = (80, 96)
FLASH_HEAD_BYTES = 256  # the barriers


def vit_attention_plan(n: int, valid_len: Optional[int] = None, b: int = 1, heads: int = 1,
                       sms: int = 132, head_dim: int = HEAD_DIM) -> dict:
    """The kernel's launch for n tokens (keys >= valid_len masked, default
    n) at head_dim (csrc/vit_attention_flash.cu). Raises, naming the limit,
    beyond 1 <= valid_len <= n and head_dim in HEAD_DIMS.

    Work tiles of `consumers` x 64 query rows of a unit (image, head;
    `q_blocks` a unit), one 64-row slice a consumer warpgroup, walked by
    persistent blocks (one an SM); their key tiles of `key_tile` keys
    (`key_tiles`, the last one masked where it holds keys >= valid_len) come
    through a K ring and a V ring of `stages` stages each; the products run
    at the head_dim rounded up to 16 (`padded_head_dim`) over ceil(padded /
    64) boxes a tile; `registers` is the warpgroup split's budget a thread,
    `accumulator_registers` what a consumer thread holds live (S, P, O and
    Q's fragments), and `smem_bytes` the shared memory a block."""
    valid = n if valid_len is None else valid_len
    if not 1 <= valid <= n:
        raise ValueError(f"fused_vit_attention kernel takes 1 <= valid_len <= n (n={n}, "
                         f"valid_len={valid})")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"fused_vit_attention kernel takes head_dim % 8 == 0 from "
                         f"{HEAD_DIMS[0]} to {HEAD_DIMS[-1]} (head_dim={head_dim})")
    padded = -(-head_dim // 16) * 16
    consumers, keys, regs, producer_regs = \
        FLASH_WIDE_SHAPE if padded in WIDE_HEAD_DIMS else FLASH_SHAPE
    boxes = -(-padded // 64)
    q_tile = boxes * _BOX_BYTES  # a warpgroup's 64 query rows
    kv_tile = boxes * keys * 128
    room = SMEM_LIMIT - 1024 - FLASH_HEAD_BYTES - consumers * q_tile
    stages = min(4, room // (2 * kv_tile))
    rows = 64 * consumers
    q_blocks = -(-n // rows)
    units = b * heads
    work = units * q_blocks
    return {"kernel": "flash", "padded_head_dim": padded, "key_tile": keys,
            "key_tiles": -(-valid // keys), "masked_tile": valid % keys != 0,
            "score_registers": keys // 2, "q_block_rows": rows, "q_blocks": q_blocks,
            "units": units, "work_tiles": work, "consumers": consumers,
            "threads": 128 * (consumers + 1),
            "registers": {"consumer": regs, "producer": producer_regs},
            "accumulator_registers": keys // 2 + keys // 4 + padded // 2 + padded // 4,
            "stages": stages, "blocks_per_sm": 1, "blocks": min(work, sms),
            "smem_bytes": 1024 + FLASH_HEAD_BYTES + consumers * q_tile + 2 * stages * kv_tile}


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
    contiguous, one set for q, k and v) writing the [b, h, n, d] view
    `out`."""
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
