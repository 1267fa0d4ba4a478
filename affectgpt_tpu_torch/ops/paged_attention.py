"""Decode attention over a paged KV cache: one query token per row, GQA,
keys and values gathered from a block pool through per-row block tables.

Port of affectgpt_tpu/ops/paged_attention_pallas.py::paged_attention_pallas
(`_kernel` for bf16 pools, `_kernel_int8` for int8 pools with per-row
scales). On CUDA tensors `paged_attention` and `paged_attention_int8` launch
the two variants of the hand-written kernel in csrc/paged_attention.cu (one
launch: the tokens of each (row, kv head) split over a cluster of blocks by
`paged_plan`, products on tensor cores, the splits merged through
distributed shared memory) or raise; on CPU tensors they run
`paged_attention_reference`, the plain PyTorch version, which is also the
oracle the kernel is checked against on the card.

Layouts: q [b, heads, d]; pools [blocks, block, kv, d], pages of any
size; block_tables
[b, width] int32, padded with block 0 (the null page), of any width;
seq_lens [b] int32; int8 scales f32 [blocks, block, kv], read as stored (JAX
transposes its scale pools to [blocks, kv, block] for the TPU kernel on
every call, inference/paged.py:170-182). Returns [b, heads, d] in q's dtype.
"""

from __future__ import annotations

import functools

import torch

from affectgpt_tpu_torch.ops import _build

# csrc/paged_attention.cu: a stage is 16 tokens of one kv head (the m16 rows
# of S^T = K Q^T, the k16 of PV); four consumer warps take a block's tiles in
# turn; at most 8 blocks (a cluster) share a (row, kv head) pair's tokens
TILE, CONSUMERS, MAX_SPLITS, MAX_GROUPS = 16, 4, 8, 8
# the blocks per SM the plan fills the card with: the splits C of a pair are
# the most with b * kv * C <= SPLIT_FILL * SMs (the whole grid fits the card
# at once: a block needs at most 65 KB of shared memory, save with odd pages)
SPLIT_FILL = 2
MAX_STAGES = 8  # the ring: a block's whole share in flight at the serve phase's lengths


def paged_attention_reference(q, pool_k, pool_v, block_tables, seq_lens, k_scale=None,
                              v_scale=None):
    """Plain version of the TPU kernel's function: f32 scores q.k / sqrt(d)
    (int8: x the key's scale), tokens at or past seq_len masked, softmax
    weights p kept in f32, the sum over the unscaled p, PV weighted by p
    (int8: x the value's scale), divided by max(sum, 1e-20), so a row with
    no valid token is 0; one rounding to q's dtype."""
    b, heads, d = q.shape
    _, blk, kv, _ = pool_k.shape
    width = block_tables.shape[1]
    tables = block_tables.long()
    k = pool_k[tables].reshape(b, width * blk, kv, d).float()
    v = pool_v[tables].reshape(b, width * blk, kv, d).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(b, kv, heads // kv, d), k)
    if k_scale is not None:
        scores = scores * k_scale[tables].reshape(b, width * blk, kv).transpose(1, 2)[:, :, None]
    scores = scores / float(d) ** 0.5
    valid = (torch.arange(width * blk, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None].long())[:, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(scores - m), torch.zeros_like(scores))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if v_scale is not None:
        p = p * v_scale[tables].reshape(b, width * blk, kv).transpose(1, 2)[:, :, None]
    out = torch.einsum("bhgk,bkhd->bhgd", p, v) / denom
    return out.reshape(b, heads, d).to(q.dtype)


def odd_pages(blk: int) -> bool:
    """Pages that a 16-token tile meets at any offset (neither 8 tokens nor
    a multiple of 16): the kernel pads each tile by TILE rows on either side
    for their boxes and reads their int8 scales from global memory."""
    return not (blk == 8 or blk % TILE == 0)


def paged_plan(b: int, kv: int, g: int, d: int, blk: int, width: int, int8: bool,
               sm_count: int, splits=None) -> dict:
    """The launch plan of csrc/paged_attention.cu for b rows of kv heads with
    g query heads each, head_dim d, pages of blk tokens and tables of
    `width` pages: the splits C of each (row, kv head) pair (the most that
    keep the grid within SPLIT_FILL blocks an SM, at least 1, at most 8 and
    at most the table's 16-token tiles; `splits` overrides), the grid (one
    cluster of C blocks a pair), the ring's stages (a multiple of the four
    consumer warps) and the dynamic shared memory. Raises on what the kernel
    does not take."""
    if d not in (64, 128) or not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"paged attention kernel needs head_dim 64 or 128 and 1-{MAX_GROUPS} "
                         f"query heads per kv head (head_dim={d}, g={g})")
    if min(blk, b, kv, width) < 1:
        raise ValueError(f"paged attention kernel needs block, b, kv, width >= 1 (block={blk}, "
                         f"b={b}, kv={kv}, width={width})")
    tiles = -(-width * blk // TILE)  # the most a pair can hold
    if splits is None:
        splits = min(MAX_SPLITS, tiles, max(1, SPLIT_FILL * sm_count // (b * kv)))
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"paged attention kernel takes 1-{MAX_SPLITS} splits, got {splits}")
    per_block = -(-tiles // splits)
    stages = min(MAX_STAGES, -(-per_block // CONSUMERS) * CONSUMERS)
    odd = odd_pages(blk)
    # a K or V tile: 128-byte box columns of 16 rows (odd pages: and 16 rows of
    # padding on either side), then the int8 scales of pages that are not odd
    kv_tile = (1 if int8 else d // 64) * (TILE + (2 * TILE if odd else 0)) * 128
    stage = -(-(2 * kv_tile + (2 * TILE * kv * 4 if int8 and not odd else 0)) // 1024) * 1024
    merge = (CONSUMERS + 1) * (8 * d + 16) * 4  # the warps' and the block's states
    return {"splits": splits, "cluster": splits, "grid": (b * kv * splits,),
            "stages": stages, "stage_bytes": stage,
            # ring (or the merge over it), barriers, alignment slack
            "smem_bytes": max(stages * stage, merge) + 2 * stages * 8 + 1024,
            "threads": 32 * (CONSUMERS + 1)}


def _check_operands(name, q, pool_k, pool_v, block_tables, seq_lens, scales, pool_dtype):
    if q.dim() != 3 or pool_k.dim() != 4:
        raise ValueError(f"{name}: q must be [b, heads, d] and the pools [blocks, block, kv, d]")
    b, heads, d = q.shape
    _, blk, kv, dk = pool_k.shape
    want = [(q, torch.bfloat16), (pool_k, pool_dtype), (pool_v, pool_dtype),
            (block_tables, torch.int32), (seq_lens, torch.int32)]
    want += [(s, torch.float32) for s in scales]
    for t, dtype in want:
        if t.device != q.device:
            raise ValueError(f"{name}: all operands must be on one device")
        if t.dtype != dtype:
            raise TypeError(f"{name} kernel takes {dtype} here, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned tensors")
    if (dk != d or tuple(pool_v.shape) != tuple(pool_k.shape)
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or tuple(seq_lens.shape) != (b,)
            or any(tuple(s.shape) != tuple(pool_k.shape[:3]) for s in scales)):
        raise ValueError(f"{name}: operand shapes do not match q [b, heads, d]")
    if heads % kv:
        raise ValueError(f"{name}: {heads} query heads do not divide over {kv} kv heads")


@functools.lru_cache(maxsize=None)
def _plan_on(index: int, b: int, kv: int, g: int, d: int, blk: int, width: int,
             int8: bool) -> dict:
    return paged_plan(b, kv, g, d, blk, width, int8, _build.sm_count(index))


def _launch(name, entry, q, pool_k, pool_v, block_tables, seq_lens, scales):
    b, heads, d = q.shape
    blocks, blk, kv, _ = pool_k.shape
    width = block_tables.shape[1]
    plan = _plan_on(q.device.index or 0, b, kv, heads // kv, d, blk, width,
                    pool_k.dtype == torch.int8)
    out = torch.empty_like(q)
    status = getattr(_build.load_library(), entry)(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), *(s.data_ptr() for s in scales),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b, kv, heads // kv, width,
        blk, d, blocks, plan["splits"], plan["stages"],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, name)
    return out


def paged_attention(q, pool_k, pool_v, block_tables, seq_lens):
    """bf16 pools: q [b, heads, d] against pages [blocks, block, kv, d]
    through block_tables [b, width] and seq_lens [b] → [b, heads, d]."""
    _build.refuse_grad("paged_attention", q, pool_k, pool_v)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_k, pool_v, block_tables, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    args = (q, pool_k, pool_v, block_tables, seq_lens, ())
    _check_operands("paged_attention", *args, torch.bfloat16)
    out = _launch("paged_attention", "agk_paged_attention_bf16", *args)
    paged_attention.launches += 1
    return out


def paged_attention_int8(q, pool_k, pool_v, block_tables, seq_lens, k_scale, v_scale):
    """int8 pools with f32 per-row scales [blocks, block, kv]: as
    `paged_attention`, the scales folded outside the two contractions."""
    _build.refuse_grad("paged_attention_int8", q, pool_k, pool_v, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_k, pool_v, block_tables, seq_lens,
                                         k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_int8: no kernel for device {q.device}")
    args = (q, pool_k, pool_v, block_tables, seq_lens, (k_scale, v_scale))
    _check_operands("paged_attention_int8", *args, torch.int8)
    out = _launch("paged_attention_int8", "agk_paged_attention_int8", *args)
    paged_attention_int8.launches += 1
    return out


paged_attention.launches = 0  # wrapper calls that launched the kernel since the last reset
paged_attention_int8.launches = 0
