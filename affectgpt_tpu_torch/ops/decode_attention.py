"""Decode attention over the dense KV cache: one query token per row, GQA,
masked softmax in f32, then PV.

Port of affectgpt_tpu/ops/decode_attention_pallas.py::decode_attention_pallas.
On a CUDA tensor `decode_attention` launches the hand-written kernels in
csrc/decode_attention.cu (or raises); on a CPU tensor it runs
`decode_attention_reference`, the plain PyTorch version, which is also the
oracle the kernels are checked against on the card.

Layouts are the JAX package's: q [b, kv, groups, d], cache [b, kv, T, d],
key mask [b, T] bool, output [b, kv, groups, d] (which, flattened, is the
head-major [b, H*d] that o_proj takes).
"""

from __future__ import annotations

import torch

from affectgpt_tpu_torch.ops import _build

CHUNK = 64  # cache columns per block of the split kernel (csrc/flash_decode.cuh)
MAX_GROUPS = 8  # query heads per kv head the kernels hold in registers


def attend_f32(q, k_cache, v_cache, key_mask):
    """The TPU kernel's arithmetic (decode_attention_pallas.py:25-46) in f32:
    scores q·k/√d, additive mask (m − 1)·1e30, p = exp(s − max)·m, so that
    masked columns give exactly 0, denominator max(Σp, 1e-20), then
    (p / denom)·v. Returns [b, kv, groups, d] float32."""
    d = q.shape[-1]
    m = key_mask.to(torch.float32)[:, None, None, :]
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k_cache.float()) / float(d) ** 0.5
    s = s + (m - 1.0) * 1e30
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * m
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    return torch.einsum("bhgk,bhkd->bhgd", p / denom, v_cache.float())


def decode_attention_reference(q, k_cache, v_cache, key_mask):
    """Plain version: `attend_f32`, rounded once to q's dtype."""
    return attend_f32(q, k_cache, v_cache, key_mask).to(q.dtype)


def check_cache_operands(name, q, k_cache, v_cache, key_mask):
    """Device, dtype, shape and contiguity checks shared by the two decode
    attention wrappers: raise on what the kernels do not take."""
    b, kv, groups, d = q.shape
    for t in (q, k_cache, v_cache):
        if t.device != q.device:
            raise ValueError(f"{name}: all operands must be on one device")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors")
    if k_cache.shape != v_cache.shape or tuple(k_cache.shape[:2]) != (b, kv) \
            or k_cache.shape[3] != d:
        raise ValueError(f"{name}: cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    t_len = k_cache.shape[2]
    if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, t_len)
            or key_mask.device != q.device):
        raise ValueError(f"{name}: key_mask must be bool [b, T] = [{b}, {t_len}] on q's device")
    if d not in (64, 128) or not 1 <= groups <= MAX_GROUPS:
        raise ValueError(
            f"{name} kernel takes head_dim 64 or 128 and 1..{MAX_GROUPS} query heads per "
            f"kv head (head_dim={d}, groups={groups})"
        )


def partials(q, t_len):
    """Per-chunk scratch of the split kernel, in one allocation: running
    (max, sum) pairs [b*kv, chunks, groups, 2] and unnormalized f32
    accumulators [b*kv, chunks, groups, d]."""
    b, kv, groups, d = q.shape
    n = b * kv * ((t_len + CHUNK - 1) // CHUNK) * groups
    scratch = torch.empty(n * (2 + d), dtype=torch.float32, device=q.device)
    return scratch[: 2 * n], scratch[2 * n:]


def decode_attention(q, k_cache, v_cache, key_mask):
    """q [b, kv, groups, d] (roped), k_cache/v_cache [b, kv, T, d], key_mask
    [b, T] bool (valid cache columns). Returns [b, kv, groups, d] in q.dtype."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    check_cache_operands("decode_attention", q, k_cache, v_cache, key_mask)
    b, kv, groups, d = q.shape
    t_len = k_cache.shape[2]
    key_mask = key_mask.contiguous()
    ml, acc = partials(q, t_len)
    out = torch.empty_like(q)
    lib = _build.load_library()
    status = lib.agk_decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), key_mask.data_ptr(),
        ml.data_ptr(), acc.data_ptr(), out.data_ptr(), b, kv, groups, t_len, d,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # wrapper calls that launched the kernels since the last reset
