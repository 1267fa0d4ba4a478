"""Paged KV cache and the continuous-batching engine over it, in PyTorch.

Port of affectgpt_tpu/inference/paged.py.
K/V live in per-layer pools of fixed-size blocks [blocks, block, kv, d];
each sequence holds a table of block ids, so device memory is sized by the
tokens in flight, not by slots x max_len. Block 0 is the null page: tables
pad with it, and dummy rows write and read there.

- `paged_write` writes one token per row into its (block, offset); int8
  pools quantize on write (`qwen2._quantize_kv`, per-row f32 scales).
- `paged_attention` is the JAX default route, the gather chain (pages
  gathered, masked GQA einsum, probabilities rounded to the compute dtype
  before PV); `paged_attention_auto` sends the step to the hand-written
  kernel of `ops.paged_attention` instead when PAGED_ATTENTION is "pallas".
- `_decode_core`, `paged_decode_step`, `paged_decode_burst`: the decode step
  and a burst of steps with argmax or top-p on the device and one host copy
  of the [b, k] tokens per burst.
- `PagedBatchServer`: reserve or optimistic admission (with recompute
  preemption), decode bursts bucketed to powers of two, gather-width
  bucketing, chunked prefill, `stats` and a `RequestClock`.
- `layout=` (JAX's `mesh=`, paged.py:417-441): tensor-parallel serving over
  a (dp = 1, tp) layout, as `server.BatchServer` takes it. The pools hold
  the rank's kv heads; every sampled token is tp rank 0's, broadcast over
  the group, so every rank admits, bursts, preempts and finishes alike
  (the stats' wall times are recorded and steer nothing); every rank must
  be given the same requests in the same order.

Departures from the JAX package:
- Pools (and the prefill's dense cache) are written IN PLACE where JAX
  donates them; the functions return the pools they were given. Dummy rows
  all write (block 0, offset 0): the duplicate indices of that in-place
  write are harmless, because the null page is never read unmasked.
- One scale layout: int8 pools keep f32 scales [blocks, block, kv]. JAX's
  flat [blocks, block·kv] and legacy [blocks, block, kv, 1] pools hold the
  same elements in the same order; their choice was a TPU lane-padding
  trade (paged.py:58-77). The kernel reads the layout as stored.
- The environment switches are module constants with JAX's defaults:
  PAGED_ATTENTION (JAX's PAGED_ATTN) and gather-width bucketing, always on
  (JAX's PAGED_GATHER_BUCKET).
- The decode core rounds the attention output to the compute dtype before
  o_proj, as the kernel route does; the JAX gather route hands o_proj f32.
- `dtype=None` takes the pool dtype from the embedding table, never from
  the first leaf of the tree (an int8 value or an f32 scale on a quantized
  tree).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.inference.server import (
    RequestClock,
    admission_embeds,
    bucket,
    serving_shard,
    signature,
)
from affectgpt_tpu_torch.models import nn, qwen2
from affectgpt_tpu_torch.ops import paged_attention as paged_ops
from affectgpt_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)

# "xla" (JAX's default, PAGED_ATTN): the gather chain of `paged_attention`;
# "pallas": the hand-written CUDA kernel of `ops.paged_attention`. Whether
# the kernel becomes the default is for a measurement on the card.
PAGED_ATTENTION = "xla"


@dataclass(frozen=True)
class PagedConfig:
    block_size: int = 16
    num_blocks: int = 256  # pool blocks per layer
    max_blocks_per_seq: int = 16

    @property
    def max_seq_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq


def init_paged_cache(llm_cfg: qwen2.QwenConfig, pcfg: PagedConfig, dtype=torch.bfloat16,
                     device="cuda") -> list:
    """Per-layer block pools [num_blocks, block_size, kv_heads, head_dim], on
    the card unless `device` says otherwise. dtype=torch.int8 selects the
    quantized pool, with f32 per-row scales "k_scale"/"v_scale"
    [num_blocks, block_size, kv_heads]."""
    shape = (pcfg.num_blocks, pcfg.block_size, llm_cfg.num_kv_heads, llm_cfg.head_dim)
    return [qwen2.kv_buffers(shape, dtype, device) for _ in range(llm_cfg.num_layers)]


class BlockAllocator:
    """Free-list allocator with admission-time reservations: a sequence's
    future decode blocks are counted against `reserved` when it is admitted,
    so a later admission can never starve an in-flight decode."""

    def __init__(self, pcfg: PagedConfig):
        self.pcfg = pcfg
        # block 0 is the null page (block tables pad with 0)
        self.free: List[int] = list(range(pcfg.num_blocks - 1, 0, -1))
        self.reserved = 0

    def available(self) -> int:
        """Blocks an admission may claim (free minus outstanding reservations)."""
        return len(self.free) - self.reserved

    def reserve(self, n_blocks: int) -> None:
        if n_blocks > self.available():
            raise RuntimeError("paged KV pool exhausted")
        self.reserved += n_blocks

    def release(self, n_blocks: int) -> None:
        assert n_blocks <= self.reserved
        self.reserved -= n_blocks

    def allocate(self, n_tokens: int) -> List[int]:
        n_blocks = -(-n_tokens // self.pcfg.block_size)
        if n_blocks > self.available():
            raise RuntimeError("paged KV pool exhausted")
        return [self.free.pop() for _ in range(n_blocks)]

    def extend(self, table: List[int], new_len: int) -> List[int]:
        """Grow table to cover new_len tokens (blocks are never returned
        mid-sequence, so the coverage is len(table) blocks)."""
        need = -(-new_len // self.pcfg.block_size) - len(table)
        for _ in range(need):
            if not self.free:
                raise RuntimeError("paged KV pool exhausted")
            table.append(self.free.pop())
        return table

    def free_table(self, table: List[int]) -> None:
        self.free.extend(b for b in table if b != 0)


def paged_write(pool: dict, k_new, v_new, block_ids, offsets) -> dict:
    """Write one token per row into a layer pool IN PLACE and return it.
    k_new/v_new [b, kv, d]; block_ids/offsets [b]. int8 pools quantize on
    write and store the per-row scales beside the values."""
    if pool["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = qwen2._quantize_kv(k_new), qwen2._quantize_kv(v_new)
        writes = {"k": kq, "v": vq, "k_scale": ks[..., 0], "v_scale": vs[..., 0]}
    else:
        writes = {"k": k_new, "v": v_new}
    for name, new in writes.items():
        pool[name][block_ids, offsets] = new.to(pool[name].dtype)
    return pool


def paged_attention(q, pool_k, pool_v, block_tables, seq_lens, num_kv_heads: int,
                    k_scale=None, v_scale=None) -> torch.Tensor:
    """GQA attention over paged K/V, the gather chain (JAX paged.py:192-232).
    q [b, heads, d]; pools [blocks, block, kv, d]; block_tables [b, width];
    seq_lens [b]. int8 pools: read in q's dtype with the scales applied
    outside the contractions, as in qwen2._attention. Returns f32
    [b, heads, d]."""
    b, heads, d = q.shape
    groups = heads // num_kv_heads
    tables = block_tables.long()
    k, v = pool_k[tables], pool_v[tables]  # [b, nblk, blk, kv, d]
    nblk, blk = k.shape[1], k.shape[2]
    k = k.reshape(b, nblk * blk, num_kv_heads, d)
    v = v.reshape(b, nblk * blk, num_kv_heads, d)
    if k_scale is not None:
        k, v = k.to(q.dtype), v.to(q.dtype)
        ks = k_scale[tables].reshape(b, nblk * blk, num_kv_heads)
        vs = v_scale[tables].reshape(b, nblk * blk, num_kv_heads)
    qg = q.reshape(b, num_kv_heads, groups, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float())
    if k_scale is not None:
        logits = logits * ks.transpose(1, 2)[:, :, None, :]
    logits = logits / float(d) ** 0.5
    valid = (torch.arange(nblk * blk, device=q.device)[None, :]
             < seq_lens.to(q.device).long()[:, None])
    logits = logits.masked_fill(~valid[:, None, None, :], torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * vs.transpose(1, 2)[:, :, None, :]
    probs = probs.to(v.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.float(), v.float())
    return out.reshape(b, heads, d)


def paged_attention_auto(q, pool_k, pool_v, block_tables, seq_lens, num_kv_heads: int,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """The kernel of `ops.paged_attention` (bf16 or int8 variant) when
    PAGED_ATTENTION is "pallas", else the gather chain."""
    if PAGED_ATTENTION != "pallas":
        return paged_attention(q, pool_k, pool_v, block_tables, seq_lens, num_kv_heads,
                               k_scale, v_scale)
    if k_scale is not None:
        return paged_ops.paged_attention_int8(q, pool_k, pool_v, block_tables, seq_lens,
                                              k_scale, v_scale)
    return paged_ops.paged_attention(q, pool_k, pool_v, block_tables, seq_lens)


def _decode_core(frozen_llm: dict, llm_cfg: qwen2.QwenConfig, pools: list, tokens, positions,
                 block_tables, pcfg: PagedConfig,
                 lora: Optional[dict] = None) -> Tuple[torch.Tensor, list]:
    """One decode step over the paged cache for all rows: tokens [b], the
    positions [b] int32 they are decoded at, block_tables [b, width] int32.
    Pools are written IN PLACE. Returns (logits [b, vocab] f32, pools)."""
    scaling = llm_cfg.lora_alpha / llm_cfg.lora_r
    compute_dtype = pools[0]["k"].dtype
    if compute_dtype == torch.int8:  # quantized pool: activations stay at weight dtype
        compute_dtype = frozen_llm["embed_tokens"]["table"].dtype
    x = qwen2.embed_tokens(frozen_llm, tokens.long())[:, None, :].to(compute_dtype)
    b = x.shape[0]
    pos = positions.long()
    block_ids = block_tables.long().gather(1, (pos // pcfg.block_size)[:, None])[:, 0]
    offsets = pos % pcfg.block_size
    seq_lens = positions + 1
    heads, d = llm_cfg.num_heads, llm_cfg.head_dim
    for i, layer in enumerate(frozen_llm["layers"]):
        lget = qwen2._lora_getter(None if lora is None else lora["layers"][i], llm_cfg, layer)
        lora_layer = lora["layers"][i] if lora is not None else None
        q, k, v, _ = qwen2._project_qkv(layer, lora_layer, llm_cfg, x, positions[:, None],
                                        decode=True)
        pool = paged_write(pools[i], k[:, 0], v[:, 0], block_ids, offsets)
        attn = paged_attention_auto(
            q[:, 0], pool["k"], pool["v"], block_tables, seq_lens, llm_cfg.num_kv_heads,
            k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
        ).to(x.dtype).reshape(b, 1, heads * d)
        x = x + qwen2._tp_sum(qwen2._lora_dense(layer["o_proj"], lget("o_proj"), attn, scaling,
                                                has_bias=False), llm_cfg)
        y = qwen2._decode_mlp_fused(layer, lora_layer, llm_cfg, x)
        if y is not None:
            x = y
        else:
            h = nn.rmsnorm(layer["post_attn_ln"], x, llm_cfg.rms_eps)
            x = x + qwen2._mlp(layer, lora_layer, llm_cfg, h)
    x = nn.rmsnorm(frozen_llm["final_ln"], x, llm_cfg.rms_eps)
    return qwen2._logits(frozen_llm, llm_cfg, x)[:, 0], pools


def paged_decode_step(frozen_llm: dict, llm_cfg: qwen2.QwenConfig, pools: list, tokens,
                      positions, block_tables, pcfg: PagedConfig,
                      lora: Optional[dict] = None) -> Tuple[torch.Tensor, list]:
    """One decode step over the paged cache for all rows (`_decode_core`).
    Returns (logits [b, vocab], pools, written in place)."""
    return _decode_core(frozen_llm, llm_cfg, pools, tokens, positions, block_tables, pcfg,
                        lora=lora)


def paged_decode_burst(frozen_llm: dict, llm_cfg: qwen2.QwenConfig, pools: list, tokens,
                       positions, block_tables, pcfg: PagedConfig,
                       generator: Optional[torch.Generator], n_steps: int,
                       lora: Optional[dict] = None, do_sample: bool = False, top_p: float = 0.9,
                       temperature: float = 1.0) -> Tuple[torch.Tensor, list]:
    """n_steps decode steps, each sampled token fed straight into the next on
    the device (JAX's lax.scan; vLLM's multi-step scheduling): the host
    fetches one [b, n_steps] array per burst. Callers pre-extend every live
    table to cover positions + n_steps tokens. Returns (tokens [b, n_steps]
    on the device, pools)."""
    out = []
    for _ in range(n_steps):
        logits, pools = _decode_core(frozen_llm, llm_cfg, pools, tokens, positions,
                                     block_tables, pcfg, lora=lora)
        if do_sample:
            tokens = gen.top_p_sample(generator, logits, top_p, temperature)
        else:
            tokens = torch.argmax(logits, dim=-1)
        tokens = mesh.tp_broadcast(tokens, llm_cfg.layout).to(torch.int32)
        out.append(tokens)
        positions = positions + 1
    return torch.stack(out, dim=1), pools


def _scatter_pages(pools: list, cache: list, tables: np.ndarray, pad, pcfg: PagedConfig) -> None:
    """Write each row's dense prefill cache [b, kv, t_pad, ...] into its
    pages IN PLACE: rows unshifted by `pad` [b] (token 0 back to column 0),
    padded to whole blocks and split into pages [b·n_blocks, block, kv, ...]
    at tables[:, :n_blocks] (host int32). Padding lands in the masked tail
    of a row's last block or in the null page."""
    b, _, t_pad = cache[0]["k"].shape[:3]
    dev = cache[0]["k"].device
    n_blocks = -(-t_pad // pcfg.block_size)
    scatter_t = n_blocks * pcfg.block_size
    ids = torch.as_tensor(np.ascontiguousarray(tables[:, :n_blocks]).reshape(-1),
                          dtype=torch.long, device=dev)
    pad = torch.as_tensor(pad, dtype=torch.long, device=dev)
    idx = (torch.arange(t_pad, device=dev)[None, :] + pad[:, None]) % t_pad  # [b, t_pad]
    for pool, layer_cache in zip(pools, cache):
        for name, dst in pool.items():
            src = layer_cache[name].transpose(1, 2)  # [b, t_pad, kv(, d)]: time-major
            src = torch.gather(src, 1, idx.view(b, t_pad, *([1] * (src.dim() - 2)))
                               .expand(src.shape))
            src = torch.nn.functional.pad(
                src, (0, 0) * (src.dim() - 2) + (0, scatter_t - t_pad))
            dst[ids] = src.reshape(b * n_blocks, pcfg.block_size, *src.shape[2:]).to(dst.dtype)


def _prefill_cache(frozen_llm, llm_cfg, embeds, lengths, dtype, lora):
    """Left-packed prefill of rows [b, t_pad, d] (true lengths [b]) into a
    fresh dense cache of t_pad columns. Returns (logits [b, 1, vocab],
    cache, pad [b])."""
    b, t_pad, _ = embeds.shape
    dev = embeds.device
    lengths = torch.as_tensor(lengths, dtype=torch.long, device=dev)
    pad = t_pad - lengths
    embeds = gen._left_pack(embeds, lengths)
    cols = torch.arange(t_pad, device=dev)
    key_valid = cols[None, :] >= pad[:, None]
    cache = qwen2.init_cache(llm_cfg, b, t_pad, dtype=dtype, device=dev)
    mask = torch.tril(torch.ones((t_pad, t_pad), dtype=torch.bool, device=dev))[None] \
        & key_valid[:, None, :]
    positions = (cols[None, :] - pad[:, None]).clamp(min=0)
    logits, cache = qwen2.forward(frozen_llm, llm_cfg, embeds, mask, lora=lora,
                                  positions=positions, cache=cache, cache_index=0,
                                  last_token_only=True)
    return logits, cache, pad


def prefill_batch_into_pages(frozen_llm: dict, llm_cfg: qwen2.QwenConfig, pools: list,
                             embeds, lengths, block_tables: np.ndarray, pcfg: PagedConfig,
                             lora: Optional[dict] = None) -> Tuple[torch.Tensor, list]:
    """Prefill an admission batch in one forward and scatter every row's K/V
    into its pages (written IN PLACE). embeds [b, t_pad, d] end-padded rows,
    lengths [b] true prompt lengths, block_tables [b, max_blocks] int32 on
    the host. An int8 pool prefills into an int8 dense cache, whose scales
    scatter beside the values. Returns (last-token logits [b, vocab],
    pools)."""
    logits, cache, pad = _prefill_cache(frozen_llm, llm_cfg, embeds, lengths,
                                        pools[0]["k"].dtype, lora)
    _scatter_pages(pools, cache, np.asarray(block_tables), pad, pcfg)
    return logits[:, -1], pools


def prefill_into_pages(frozen_llm: dict, llm_cfg: qwen2.QwenConfig, pools: list, embeds,
                       block_table: np.ndarray, pcfg: PagedConfig, lora: Optional[dict] = None,
                       length: Optional[int] = None) -> Tuple[torch.Tensor, list]:
    """Prefill one sequence [1, t_pad, d] (its tail bucket padding when
    `length` < t_pad) and scatter its K/V into its pages, IN PLACE. Returns
    (last-token logits [vocab], pools)."""
    t_pad = embeds.shape[1]
    length = t_pad if length is None else int(length)
    logits, pools = prefill_batch_into_pages(frozen_llm, llm_cfg, pools, embeds, [length],
                                             np.asarray(block_table)[None], pcfg, lora=lora)
    return logits[0], pools


class PagedBatchServer:
    """Continuous batching over the paged cache: device memory is bounded by
    the tokens in flight (the block pool), not slots x max_len. The request
    and result contract of `server.BatchServer`; greedy by default, top-p
    with do_sample=True."""

    def __init__(self, frozen, trainable, cfg, tokenizer, pcfg: Optional[PagedConfig] = None,
                 max_slots: int = 8, dtype=None, seed: int = 0, do_sample: bool = False,
                 top_p: float = 0.9, temperature: float = 1.0, prefill_bucket: int = 64,
                 decode_burst: int = 8, admission: str = "reserve", prefill_batch: int = 256,
                 prefill_chunk_tokens: Optional[int] = None,
                 layout: Optional[mesh.Layout] = None):
        frozen, trainable, cfg = serving_shard(frozen, trainable, cfg, layout)
        self.frozen, self.trainable, self.cfg = frozen, trainable, cfg
        self.tokenizer = tokenizer
        self.pcfg = pcfg or PagedConfig()
        self.max_slots = max_slots
        table = frozen["llm"]["embed_tokens"]["table"]
        self.device = table.device
        # the pool matches the weights: an f32 pool against bf16 weights would
        # double the pool and run the decode in f32, past the bf16 kernels
        self.pools = init_paged_cache(cfg.llm, self.pcfg, dtype=dtype or table.dtype,
                                      device=self.device)
        self.alloc = BlockAllocator(self.pcfg)
        self.slots: List[Optional[dict]] = [None] * max_slots
        self.pending: List = []
        self.results = {}
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.do_sample, self.top_p, self.temperature = do_sample, top_p, temperature
        # prompts padded to a bucket multiple (JAX shares compiled prefills so)
        self.prefill_bucket = min(prefill_bucket, self.pcfg.max_seq_len)
        # cap on requests per admission (one admission is one prefill forward)
        self.prefill_batch = max(1, prefill_batch)
        # chunked prefill: an admission holds at most this many prompt tokens
        # (one request always admits), so decodes in flight stall at most one
        # chunk between bursts; None = off
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # tokens decoded per burst, rounded down to a power of two at run time
        self.decode_burst = max(1, decode_burst)
        # "reserve": admission claims a request's whole lifetime of blocks, so
        # decode never starves. "optimistic": prompt blocks only; when a burst
        # would drain the pool, the youngest slot is recompute-preempted.
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"admission must be 'reserve' or 'optimistic', got {admission!r}")
        # a lone survivor must always be able to grow to a full table
        if admission == "optimistic" and self.pcfg.num_blocks - 1 < self.pcfg.max_blocks_per_seq:
            raise ValueError("optimistic admission needs a pool of at least one full table")
        self.admission = admission
        # t_* are wall seconds of device-fenced phases: t_prefill from an
        # admission's staging to its first tokens on the host, t_decode from
        # a burst's dispatch to its tokens on the host
        self.stats = {
            "admissions": 0, "admitted_requests": 0,
            "decode_steps": 0, "decode_slot_tokens": 0, "decode_bursts": 0,
            "preemptions": 0, "t_prefill": 0.0, "t_decode": 0.0,
        }
        self.clock = RequestClock()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits [b, vocab] → tokens [b]: top-p when sampling, else argmax."""
        if not self.do_sample:
            token = torch.argmax(logits, dim=-1)
        else:
            token = gen.top_p_sample(self.generator, logits, self.top_p, self.temperature)
        return mesh.tp_broadcast(token, self.cfg.llm.layout)

    def _lifetime_blocks(self, request) -> int:
        """Blocks an admission claims: the prompt's, plus under "reserve"
        every token the request may decode, capped by the table size."""
        lifetime = len(request.input_ids) + (
            0 if self.admission == "optimistic" else request.max_new_tokens)
        return min(-(-lifetime // self.pcfg.block_size), self.pcfg.max_blocks_per_seq)

    def submit(self, request) -> None:
        # two kinds of request can never be served: a prompt >= max_seq_len
        # (no position left to decode), and a lifetime larger than the whole
        # pool (it would wait at the head of the queue forever)
        if len(request.input_ids) >= self.pcfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(request.input_ids)} must be < max_seq_len "
                f"{self.pcfg.max_seq_len} (one position is needed for decode)")
        need = self._lifetime_blocks(request)
        if need > self.pcfg.num_blocks - 1:  # block 0 is the null page
            raise ValueError(
                f"request needs {need} blocks (prompt {len(request.input_ids)} + "
                f"max_new_tokens {request.max_new_tokens}) but the pool has only "
                f"{self.pcfg.num_blocks - 1} allocatable blocks — it could never be admitted")
        self.pending.append(request)
        self.clock.submitted(request.request_id)

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.pending:
            return
        # the longest prefix of pending that fits the free slots, the
        # prefill cap, the chunk budget and the pool, with one signature
        sig = signature(self.pending[0])
        batch, blocks_needed, tokens_planned = [], 0, 0
        for req in self.pending:
            if len(batch) >= min(len(free), self.prefill_batch) or signature(req) != sig:
                break
            if (self.prefill_chunk_tokens is not None and batch
                    and tokens_planned + len(req.input_ids) > self.prefill_chunk_tokens):
                break
            need = self._lifetime_blocks(req)
            if blocks_needed + need > self.alloc.available():
                break
            blocks_needed += need
            tokens_planned += len(req.input_ids)
            batch.append(req)
        if not batch:
            return
        del self.pending[:len(batch)]
        self.stats["admissions"] += 1
        self.stats["admitted_requests"] += len(batch)
        t0 = time.perf_counter()

        n_bucket = bucket(len(batch))
        t_max = max(len(r.input_ids) for r in batch)
        t_bucket = min(-(-t_max // self.prefill_bucket) * self.prefill_bucket,
                       self.pcfg.max_seq_len)
        tables, reserves = [], []
        padded_tables = np.zeros((n_bucket, self.pcfg.max_blocks_per_seq), np.int32)
        for i, req in enumerate(batch):
            table = self.alloc.allocate(len(req.input_ids))
            reserve = 0 if self.admission == "optimistic" \
                else self._lifetime_blocks(req) - len(table)
            self.alloc.reserve(reserve)
            reserves.append(reserve)
            padded_tables[i, :len(table)] = table
            tables.append(table)
        embeds, lengths = admission_embeds(self.frozen, self.trainable, self.cfg, batch,
                                           n_bucket, t_bucket, self.device)
        last_logits, self.pools = prefill_batch_into_pages(
            self.frozen["llm"], self.cfg.llm, self.pools, embeds, lengths, padded_tables,
            self.pcfg, lora=self.trainable.get("lora"))
        first = self._sample(last_logits).cpu().numpy().astype(np.int32)
        self.stats["t_prefill"] += time.perf_counter() - t0
        for req in batch:
            self.clock.first_token(req.request_id)
        for i, req in enumerate(batch):
            slot = {
                "request_id": req.request_id, "table": tables[i],
                "padded": padded_tables[i].copy(), "pos": int(lengths[i]),
                "tokens": [int(first[i])], "remaining": req.max_new_tokens - 1,
                "reserved": reserves[i],
                "request": req,  # kept for recompute preemption
            }
            if slot["tokens"][0] == self.tokenizer.eos_token_id or slot["remaining"] <= 0:
                self._finish(free[i], slot)
            else:
                self.slots[free[i]] = slot

    def _finish(self, index: int, slot: dict) -> None:
        tokens = slot["tokens"]
        if tokens and tokens[-1] == self.tokenizer.eos_token_id:
            tokens = tokens[:-1]
        self.results[slot["request_id"]] = tokens
        self.clock.finished(slot["request_id"], len(tokens))
        self.alloc.release(slot.get("reserved", 0))
        self.alloc.free_table(slot["table"])
        self.slots[index] = None

    def _preempt_for_burst(self, live, k):
        """Optimistic admission's escape hatch: while growing every live
        table by k tokens would drain the pool, recompute-preempt the slot
        with the most remaining budget (the least sunk work); its request
        requeues at the head and re-prefills from its prompt (generated
        tokens are discarded, vLLM's recompute preemption)."""

        def burst_blocks(s):
            target = min(s["pos"] + k, self.pcfg.max_seq_len)
            return max(0, -(-target // self.pcfg.block_size) - len(s["table"]))

        while sum(burst_blocks(s) for _, s in live) > self.alloc.available() and len(live) > 1:
            j = max(range(len(live)), key=lambda idx: live[idx][1]["remaining"])
            i, s = live.pop(j)
            self.alloc.release(s.get("reserved", 0))
            self.alloc.free_table(s["table"])
            # insert(0) per victim, youngest first, leaves the oldest at the head
            self.pending.insert(0, s["request"])
            self.clock.preempted(s["request_id"])
            self.slots[i] = None
            self.stats["preemptions"] += 1
        return live

    def step(self) -> bool:
        self._admit()
        live = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return bool(self.pending)
        # burst length: bounded by the tightest slot's budget and table
        # capacity, rounded down to a power of two; slots that stop mid-burst
        # waste their tail steps (the multi-step trade)
        k = min(self.decode_burst, min(s["remaining"] for _, s in live),
                max(1, self.pcfg.max_seq_len - 1 - max(s["pos"] for _, s in live)))
        k = max(1, k)
        while k & (k - 1):
            k &= k - 1
        if self.admission == "optimistic":
            live = self._preempt_for_burst(live, k)
        for _, s in live:
            before = len(s["table"])
            # growth comes out of this slot's admission-time reservation
            target = min(s["pos"] + k, self.pcfg.max_seq_len)
            need = -(-target // self.pcfg.block_size) - before
            if need > 0:
                self.alloc.release(min(need, s["reserved"]))
            self.alloc.extend(s["table"], target)
            s["reserved"] = max(0, s["reserved"] - (len(s["table"]) - before))
            s["padded"][:len(s["table"])] = s["table"]
        # the live set padded to max_slots: dummy rows decode token 0 at
        # position 0 into the null page
        n_pad = self.max_slots - len(live)
        dev = self.device
        tokens = torch.as_tensor([s["tokens"][-1] for _, s in live] + [0] * n_pad,
                                 dtype=torch.int32, device=dev)
        positions = torch.as_tensor([s["pos"] for _, s in live] + [0] * n_pad,
                                    dtype=torch.int32, device=dev)
        # gather-width bucketing: tables cut to the next power of two of
        # blocks covering the furthest live position + k
        need = -(-(max(s["pos"] for _, s in live) + k) // self.pcfg.block_size)
        width = min(bucket(need), self.pcfg.max_blocks_per_seq)
        self.stats["gather_width_tokens"] = self.stats.get("gather_width_tokens", 0) \
            + width * self.pcfg.block_size * k
        tables = torch.as_tensor(np.stack([s["padded"][:width] for _, s in live]
                                          + [np.zeros(width, np.int32)] * n_pad), device=dev)
        t0 = time.perf_counter()
        toks, self.pools = paged_decode_burst(
            self.frozen["llm"], self.cfg.llm, self.pools, tokens, positions, tables, self.pcfg,
            self.generator, k, lora=self.trainable.get("lora"), do_sample=self.do_sample,
            top_p=self.top_p, temperature=self.temperature)
        toks = toks.cpu().numpy()  # [b, k]: one device→host copy per burst
        self.stats["t_decode"] += time.perf_counter() - t0
        self.stats["decode_steps"] += k
        self.stats["decode_bursts"] += 1
        self.stats["decode_slot_tokens"] += len(live) * k
        for row, (i, s) in enumerate(live):
            for j in range(k):
                token = int(toks[row, j])
                s["tokens"].append(token)
                s["pos"] += 1
                s["remaining"] -= 1
                if (token == self.tokenizer.eos_token_id or s["remaining"] <= 0
                        or s["pos"] >= self.pcfg.max_seq_len - 1):
                    self._finish(i, s)
                    break
        return True

    def run_until_drained(self, max_steps: int = 10_000):
        for _ in range(max_steps):
            if not self.step():
                break
        live = sum(s is not None for s in self.slots)
        if self.pending or live:
            logger.warning("run_until_drained exhausted max_steps=%d with %d pending and %d "
                           "live slots — results are incomplete", max_steps,
                           len(self.pending), live)
        return self.results
