"""Causal prefill attention with segment ids, GQA, over the prompt's own
k/v.

Port of affectgpt_tpu/models/qwen2.py::_flash_prefill_attention, which calls
JAX's stock TPU flash-attention op. On a CUDA tensor `prefill_attention`
launches the hand-written kernel in csrc/prefill_attention.cu (or raises);
on a CPU tensor it runs `prefill_attention_reference`, the plain PyTorch
version, which is also the oracle the kernel is checked against on the card.

Key j is visible to query i iff j <= i and segment_ids[j] == segment_ids[i].
Under the left-pack of inference/generate.py (pads segment 0, tokens segment
1) a real row sees the real keys up to itself and a pad row sees the pads
up to itself, so no row is empty. That is the TPU op's semantics; the plain
attention chain of models/qwen2.py instead spreads a pad row uniformly over
every column, so the two agree on real rows only.

Layouts are the JAX function's: q [b, t, H, d], k/v [b, kv, t, d] (the
just-projected, pre-cache-write rows), segment_ids [b, t]; output
[b, t, H*d].
"""

from __future__ import annotations

import torch

from affectgpt_tpu_torch.ops import _build


def prefill_attention_reference(q, k, v, segment_ids):
    """Plain version: f32 scores q·k/√d, the visibility above, f32 softmax
    and PV, the output rounded once to q's dtype."""
    b, t, heads, d = q.shape
    kv = k.shape[1]
    qg = q.float().reshape(b, t, kv, heads // kv, d)
    s = torch.einsum("bqhgd,bhkd->bhgqk", qg, k.float()) / float(d) ** 0.5
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    visible = causal[None] & (segment_ids[:, :, None] == segment_ids[:, None, :])  # [b, q, k]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bqhgd", p, v.float())
    return out.to(q.dtype).reshape(b, t, heads * d)


def prefill_attention(q, k, v, segment_ids):
    """q [b, t, H, d] (roped), k/v [b, kv, t, d], segment_ids [b, t] (bool
    or int). Returns [b, t, H*d] in q.dtype."""
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k, v, segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: no kernel for device {q.device}")
    b, t, heads, d = q.shape
    kv = k.shape[1]
    for x in (q, k, v):
        if x.device != q.device:
            raise ValueError("prefill_attention: all operands must be on one device")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"prefill_attention kernel takes bfloat16, got {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("prefill_attention kernel takes contiguous, 16-byte aligned tensors")
    if tuple(k.shape) != (b, kv, t, d) or k.shape != v.shape or heads % kv:
        raise ValueError(f"prefill_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if tuple(segment_ids.shape) != (b, t) or segment_ids.device != q.device:
        raise ValueError("prefill_attention: segment_ids must be [b, t] on q's device")
    if d not in (64, 128):
        raise ValueError(f"prefill_attention kernel takes head_dim 64 or 128, got {d}")
    seg = segment_ids.to(torch.int32).contiguous()
    out = torch.empty((b, t, heads * d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    status = lib.agk_prefill_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
        b, t, heads, kv, d, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "prefill_attention")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0  # kernel launches since the last reset
