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

The kernel's launch (`prefill_plan`): persistent blocks walk units of
(row, kv head, 64-row query tile, pair of q heads) heaviest first, and each
(query tile, key tile) pair is skipped, taken whole or masked element by
element by its class (`prefill_tile_classes`), computed on the card from
each 64-row tile's least and greatest segment id.
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


TILE = 64  # query rows of a warpgroup, keys of a tile
STAGES = 4  # K/V stages of the kernel's ring
SKIP, FULL, MASKED = 0, 1, 2


def prefill_tile_classes(segment_ids) -> torch.Tensor:
    """[b, tiles, tiles] int8: the class of each (query tile, key tile) of
    64 rows, as the kernel computes it from each tile's least and greatest
    segment id: SKIP where no key can be visible (key tile past the query
    tile, or disjoint id ranges), FULL where every key is visible to every
    row < t (key tile wholly below the query tile and inside t, one id
    throughout), else MASKED."""
    seg = segment_ids.to(torch.int64)
    b, t = seg.shape
    tiles = -(-t // TILE)
    pad = tiles * TILE - t
    tail = seg[:, -1:].expand(b, pad)  # rows past t repeat the last row: no new id
    lo = torch.cat([seg, tail], 1).view(b, tiles, TILE).amin(-1)
    hi = torch.cat([seg, tail], 1).view(b, tiles, TILE).amax(-1)
    qlo, qhi, klo, khi = lo[:, :, None], hi[:, :, None], lo[:, None, :], hi[:, None, :]
    idx = torch.arange(tiles, device=seg.device)
    qt, kt = idx[:, None], idx[None, :]
    live = (kt <= qt) & ~((khi < qlo) | (klo > qhi))
    one_id = (qlo == qhi) & (klo == khi) & (qlo == klo)
    full = (kt < qt) & ((kt + 1) * TILE <= t) & one_id
    classes = torch.where(full, FULL, MASKED)
    return torch.where(live, classes, SKIP).to(torch.int8)


def prefill_plan(b: int, t: int, heads: int, kv: int, d: int, sms: int = 132,
                 segment_ids=None) -> dict:
    """The kernel's launch for q [b, t, heads, d], k/v [b, kv, t, d]: its
    units (query tile, row, kv head, the pair's q heads) in launch order,
    heaviest first (the last query tile sees the most key tiles); the
    persistent grid (block i takes units i, i + blocks, ...); the shared
    memory a block; and, given segment_ids, the tile classes and the K/V
    tiles the producer loads. Raises on what the kernel does not take."""
    if d not in (64, 128) or kv < 1 or heads % kv or b < 1 or t < 1:
        raise ValueError(f"prefill_attention kernel takes head_dim 64 or 128 and heads % kv "
                         f"== 0 (heads={heads}, kv={kv}, head_dim={d}, b={b}, t={t})")
    groups = heads // kv
    q_tiles, pairs = -(-t // TILE), (groups + 1) // 2
    per_tile = b * kv * pairs
    units = []
    for u in range(per_tile * q_tiles):
        r = u % per_tile
        qt, bi, kvh, pair = q_tiles - 1 - u // per_tile, r // (pairs * kv), (r // pairs) % kv, \
            r % pairs
        units.append((qt, bi, kvh, tuple(kvh * groups + h
                                         for h in range(2 * pair, min(2 * pair + 2, groups)))))
    blocks = min(len(units), sms)
    tile = TILE * d * 2
    plan = {"q_tiles": q_tiles, "pairs": pairs, "units": units, "blocks": blocks,
            "grid": (blocks,), "stages": STAGES,
            "smem_bytes": 1024 + 2 * 2 * tile + STAGES * 2 * tile + (2 * STAGES + 4) * 8
            + STAGES * TILE * 4 + STAGES * 4}
    if segment_ids is not None:
        classes = prefill_tile_classes(segment_ids)
        plan["classes"] = classes
        plan["kv_tiles_loaded"] = int(sum(int((classes[bi, qt] != SKIP).sum())
                                          for qt, bi, _, _ in units))
    return plan


def prefill_attention(q, k, v, segment_ids):
    """q [b, t, H, d] (roped), k/v [b, kv, t, d], segment_ids [b, t] (bool
    or int). Returns [b, t, H*d] in q.dtype."""
    _build.refuse_grad("prefill_attention", q, k, v)
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
    tiles = -(-t // TILE)
    padded = torch.empty((b, tiles * TILE), dtype=torch.int32, device=q.device)  # ids by tile
    ranges = torch.empty((b, tiles, 2), dtype=torch.int32, device=q.device)
    lib = _build.load_library()
    status = lib.agk_prefill_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), padded.data_ptr(),
        ranges.data_ptr(), out.data_ptr(), b, t, heads, kv, d,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "prefill_attention")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0  # kernel launches since the last reset
