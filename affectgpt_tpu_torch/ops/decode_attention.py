"""Decode attention over the dense KV cache: one query token per row, GQA,
masked softmax in f32, then PV.

Port of affectgpt_tpu/ops/decode_attention_pallas.py::decode_attention_pallas.
On a CUDA tensor `decode_attention` launches the hand-written kernel of
csrc/decode_attention.cu once (or raises): the attention kernel of
csrc/dense_decode_attention.cuh in a mode that takes any key mask, each
(row, kv head) pair's tiles split over a cluster of blocks, products on
tensor cores, the splits merged through distributed shared memory. On a CPU
tensor it runs `decode_attention_reference`, the plain PyTorch version,
which is also the oracle the kernel is checked against on the card.

`attention_plan` plans that kernel's launch for both wrappers that launch
it: `decode_attention` (any mask: a column is valid exactly when its mask
byte is set, a row with no valid column gives zeros) and
ops/decode_attn_o.py (a window of keys).

Layouts are the JAX package's: q [b, kv, groups, d], cache [b, kv, T, d],
key mask [b, T] bool, output [b, kv, groups, d] (which, flattened, is the
head-major [b, H*d] that o_proj takes).
"""

from __future__ import annotations

import functools

import torch

from affectgpt_tpu_torch.ops import _build

# csrc/dense_decode_attention.cuh: a stage is 16 tokens of one kv head (the
# m16 rows of S^T = K Q^T, the k16 of PV); four consumer warps take a block's
# tiles in turn; at most 8 blocks (a cluster) share a (row, kv head) pair's
# tiles; at most 8 query heads a kv head (the n8 operand)
TILE, CONSUMERS, MAX_SPLITS, MAX_GROUPS = 16, 4, 8, 8
# the ring; one that holds a block's whole share (12-16 stages) was 1-10% slower
# on an H100 at b = 8-64, T = 640
MAX_STAGES = 8
# dense::Keys, which cache columns a row attends to: WINDOW (decode_attn_o)
# every column from the row's first valid one to its last, all of them where
# none is valid; MASK_WINDOW and MASK_ALL (decode_attention) exactly the
# valid ones, taking the tiles of that window or all tiles of the row
WINDOW, MASK_WINDOW, MASK_ALL = 0, 1, 2
KEYS = {WINDOW: "window", MASK_WINDOW: "mask_window", MASK_ALL: "mask_all"}
# the splits C of a pair. WINDOW: the most with b * kv * C <= SMs, the whole
# grid at one block an SM, so that the o_proj blocks that decode_attn_o
# launches as the attention's dependents fit beside it and load their first
# stages of W_o during the attention (on an H100 at b = 8, T = 640: 0.0215 ms
# a call against 0.0232 with two attention blocks an SM). MASK_*: the most
# that leave a quarter of the SMs free, or 2 where that would split no pair
# and 2 fit the SMs, the best of every split count measured on an H100 at
# T = 640: 8 at b = 1 (0.0062 ms a call), 6 at b = 4 (0.0071; 8: 0.0077),
# 3 at b = 8 (0.0086; 4: 0.0090), 2 at b = 16 (0.0118; 1: 0.0131), 1 at
# b = 32 (0.0181; 2: 0.0193)


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


def attention_plan(b: int, kv: int, g: int, d: int, t_len: int, sm_count: int,
                   keys: int) -> dict:
    """The attention launch (csrc/dense_decode_attention.cuh) for b rows of
    kv heads with g query heads each, head_dim d, a cache of t_len columns
    and the key rule `keys` (WINDOW, MASK_WINDOW, MASK_ALL): the splits C of
    each (row, kv head) pair's tiles (as the note on the module's constants
    says, at least 1, at most 8 and at most T's 16-token tiles), the grid
    (one cluster of C blocks a pair), the ring's stages (a multiple of the
    four consumer warps) and the dynamic shared memory. Raises on what the
    kernel does not take."""
    if d not in (64, 128) or not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"decode attention kernel takes head_dim 64 or 128 and 1-{MAX_GROUPS} "
                         f"query heads per kv head (head_dim={d}, g={g})")
    if min(b, kv, t_len) < 1:
        raise ValueError(f"decode attention kernel needs b, kv, T >= 1 (b={b}, kv={kv}, "
                         f"T={t_len})")
    if keys not in KEYS:
        raise ValueError(f"decode attention kernel: no key rule {keys}")
    tiles = -(-t_len // TILE)  # all of a row's; a window holds at most as many
    pairs = b * kv
    fit = sm_count // pairs if keys == WINDOW else max(
        3 * sm_count // 4 // pairs, min(2, sm_count // pairs))
    splits = min(MAX_SPLITS, tiles, max(1, fit))
    per_block = -(-tiles // splits)
    stages = min(MAX_STAGES, -(-per_block // CONSUMERS) * CONSUMERS)
    stage = 2 * (d // 64) * TILE * 128  # a K and a V tile: 128-byte rows of 64 values
    merge = (CONSUMERS + 1) * (8 * d + 16) * 4  # the warps' and the block's states
    keys_bytes = 0 if keys == WINDOW else 16 * (per_block + 1)  # a share's mask bytes
    return {"keys": keys, "splits": splits, "cluster": splits, "grid": (b * kv * splits,),
            "stages": stages, "stage_bytes": stage, "threads": 32 * (CONSUMERS + 1),
            "keys_bytes": keys_bytes,
            # ring (or the merge over it), barriers, mask bytes, alignment slack
            "smem_bytes": max(stages * stage, merge) + 2 * stages * 8 + keys_bytes + 1024}


def decode_attention_plan(b: int, kv: int, g: int, d: int, t_len: int, sm_count: int) -> dict:
    """decode_attention's launch: `attention_plan` under MASK_ALL while the b
    kv pairs fit the SMs, the grid one wave whose first loads would wait for
    the mask row's reduction (on an H100 at T = 640: 0.0087 ms a call against
    0.0092 under MASK_WINDOW at b = 8, 0.0177 against 0.0180 at b = 32);
    beyond, MASK_WINDOW, which reads no pad and no unwritten column (0.0316
    against 0.0321 at b = 64)."""
    return attention_plan(b, kv, g, d, t_len, sm_count,
                          MASK_ALL if b * kv <= sm_count else MASK_WINDOW)


@functools.lru_cache(maxsize=None)
def _plan_on(b, kv, g, d, t_len, device_index) -> dict:
    return decode_attention_plan(b, kv, g, d, t_len, _build.sm_count(device_index))


def decode_attention(q, k_cache, v_cache, key_mask):
    """q [b, kv, groups, d] (roped), k_cache/v_cache [b, kv, T, d], key_mask
    [b, T] bool (valid cache columns). Returns [b, kv, groups, d] in q.dtype."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache, key_mask)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    check_cache_operands("decode_attention", q, k_cache, v_cache, key_mask)
    b, kv, groups, d = q.shape
    t_len = k_cache.shape[2]
    plan = _plan_on(b, kv, groups, d, t_len, q.device.index or 0)
    key_mask = key_mask.contiguous()
    out = torch.empty_like(q)
    lib = _build.load_library()
    status = lib.agk_decode_attention_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), key_mask.data_ptr(),
        out.data_ptr(), b, kv, groups, t_len, d, plan["splits"], plan["stages"], plan["keys"],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0  # wrapper calls that launched the kernel since the last reset
