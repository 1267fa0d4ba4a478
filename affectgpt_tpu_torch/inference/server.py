"""Continuous-batching serving engine over a dense KV cache, in PyTorch.

Port of affectgpt_tpu/inference/server.py (`Request`, `RequestClock`,
`SlotState`, `BatchServer`). A fixed-capacity cache [layers][slots, kv,
max_len, d] stays resident on the card; admission prefills a batch of new
prompts (grouped by modality signature, bucketed to a power of two) and
splices each row's cache into its free slot; every step then decodes one
token for all active slots at per-row cache columns (`qwen2.forward` with a
[slots] `cache_index`). The cache is written IN PLACE where JAX donates it.
Greedy by default; top-p sampling draws from a `torch.Generator` seeded
from `seed` (JAX's keys give other numbers).

`layout=` (JAX's `mesh=`, server.py:188-205): tensor-parallel serving over a
(dp = 1, tp) layout of `parallel.mesh`. Every rank of the tp group runs the
same engine on its shard (`mesh.shard_model`; the cache holds the rank's kv
heads) and must be given the same requests in the same order; each sampled
token is tp rank 0's, broadcast over the group, so every rank's admission,
slot and stop decisions are the same. The wall-clock stats and the
`RequestClock` are recorded on every rank and steer nothing.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.models import affectgpt, qwen2
from affectgpt_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)


@dataclass
class Request:
    request_id: int
    input_ids: np.ndarray  # [t] int32, patch ids zeroed
    features: Dict[str, np.ndarray]  # {m: [tm, dm]}
    offsets: Dict[str, int]
    max_new_tokens: int = 64


class RequestClock:
    """Per-request clock shared by both serving engines: wall time from
    submit to first token (TTFT, stamped when the admission's sampled token
    reaches the host) to finish. `summary()` gives the request-level latency
    distribution, which the engine's phase timers (t_prefill/t_decode) cannot
    see because queueing accrues while other requests hold the slots."""

    def __init__(self):
        self._t: Dict[int, Dict[str, float]] = {}
        self._done: List[Dict[str, float]] = []

    def submitted(self, request_id: int) -> None:
        self._t[request_id] = {"submit": time.perf_counter()}

    def first_token(self, request_id: int) -> None:
        rec = self._t.get(request_id)
        if rec is not None and "first" not in rec:
            rec["first"] = time.perf_counter()

    def preempted(self, request_id: int) -> None:
        """Recompute preemption discards a slot's generated tokens: clear the
        first-token stamp so TTFT counts the surviving generation."""
        rec = self._t.get(request_id)
        if rec is not None:
            rec.pop("first", None)

    def finished(self, request_id: int, n_tokens: int) -> None:
        rec = self._t.pop(request_id, None)
        if rec is None:
            return
        now = time.perf_counter()
        self._done.append({
            "ttft": rec.get("first", now) - rec["submit"],
            "e2e": now - rec["submit"],
            "tokens": float(n_tokens),
            "submit_abs": rec["submit"], "finish_abs": now,
        })

    def summary(self) -> Dict[str, float]:
        if not self._done:
            return {"requests": 0}
        ttft = np.array([d["ttft"] for d in self._done])
        e2e = np.array([d["e2e"] for d in self._done])
        toks = np.array([d["tokens"] for d in self._done])

        def pct(a, q):
            return float(np.percentile(a, q))

        return {
            "requests": len(self._done),
            "ttft_p50_ms": round(pct(ttft, 50) * 1e3, 1),
            "ttft_p95_ms": round(pct(ttft, 95) * 1e3, 1),
            "ttft_max_ms": round(float(ttft.max()) * 1e3, 1),
            "e2e_p50_ms": round(pct(e2e, 50) * 1e3, 1),
            "e2e_p95_ms": round(pct(e2e, 95) * 1e3, 1),
            "e2e_max_ms": round(float(e2e.max()) * 1e3, 1),
            "mean_tokens": round(float(toks.mean()), 1),
            # generated tokens over the submit→finish window of the whole
            # trace (throughput as a client measures it)
            "gen_tokens_per_s": round(float(toks.sum() / max(
                max(d["finish_abs"] for d in self._done)
                - min(d["submit_abs"] for d in self._done), 1e-9)), 1),
        }


@dataclass
class SlotState:
    request_id: int = -1
    position: int = 0  # next cache column to write
    remaining: int = 0
    done: bool = True
    tokens: List[int] = field(default_factory=list)


def signature(request: Request) -> tuple:
    """Modality names AND shapes: one admission prefills as one batched
    forward, so its requests must stack."""
    return tuple(sorted((m, tuple(v.shape)) for m, v in request.features.items()))


def bucket(n: int) -> int:
    """The next power of two >= n."""
    out = 1
    while out < n:
        out *= 2
    return out


def admission_embeds(frozen, trainable, cfg, batch: List[Request], n_bucket: int, t_pad: int,
                     device) -> tuple:
    """Right-padded ids, features and offsets of an admission, with
    n_bucket - len(batch) dummy rows of one pad token and no modality, spliced
    into embeddings [n_bucket, t_pad, d] on `device`. Returns (embeds,
    lengths [n_bucket] numpy int32)."""
    n_dummy = n_bucket - len(batch)
    ids = np.zeros((n_bucket, t_pad), np.int32)
    lengths = np.ones(n_bucket, np.int32)  # dummy rows: 1 token
    for i, req in enumerate(batch):
        ids[i, :len(req.input_ids)] = req.input_ids
        lengths[i] = len(req.input_ids)
    feats, offs = {}, {}
    for m, _ in signature(batch[0]):
        feats[m] = torch.as_tensor(np.stack(
            [np.asarray(r.features[m]) for r in batch]
            + [np.zeros_like(np.asarray(batch[0].features[m]))] * n_dummy), device=device)
        offs[m] = torch.as_tensor([r.offsets.get(m, -1) for r in batch] + [-1] * n_dummy,
                                  dtype=torch.long, device=device)
    embeds = affectgpt.build_inputs_embeds(
        frozen, trainable, cfg, torch.as_tensor(ids, dtype=torch.long, device=device), feats, offs)
    return embeds, lengths


def serving_shard(frozen, trainable, cfg, layout: Optional[mesh.Layout]):
    """(frozen, trainable, cfg) of this rank for a serving engine under a
    tp layout (`mesh.shard_model`); unchanged without one. The engines run
    one dp row: a layout with dp > 1 raises."""
    if layout is None:
        return frozen, trainable, cfg
    if layout.dp > 1:
        raise ValueError(f"the serving engines take a (dp = 1, tp) layout, got dp={layout.dp}: "
                         f"run one engine a dp row")
    return mesh.shard_model(frozen, trainable, cfg, layout)


def _prefill(frozen, trainable, cfg, embeds, lengths, max_len):
    """Left-packed prefill of an admission into a fresh dense cache of
    max_len columns; each row's cache is then shifted so that its token 0
    sits at column 0. Returns (last-token logits [b, vocab], cache)."""
    b, t_pad, _ = embeds.shape
    dev = embeds.device
    lengths = torch.as_tensor(lengths, dtype=torch.long, device=dev)
    embeds = gen._left_pack(embeds, lengths)
    pad_len = t_pad - lengths
    cols = torch.arange(t_pad, device=dev)
    key_valid = cols[None, :] >= pad_len[:, None]
    positions = (cols[None, :] - pad_len[:, None]).clamp(min=0)
    cache = qwen2.init_cache(cfg.llm, b, max_len, dtype=embeds.dtype, device=dev)
    causal = torch.arange(max_len, device=dev)[None, None, :] <= cols[None, :, None]
    mask = causal & torch.nn.functional.pad(key_valid, (0, max_len - t_pad))[:, None, :]
    logits, cache = qwen2.forward(frozen["llm"], cfg.llm, embeds, mask,
                                  lora=trainable.get("lora"), positions=positions, cache=cache,
                                  cache_index=0, last_token_only=True)
    # left-packed rows end at the last column: roll each row's cache left by
    # its pad (time is axis 2 of [b, kv, T, d])
    idx = (torch.arange(max_len, device=dev)[None, :] + pad_len[:, None]) % max_len  # [b, T]
    for layer in cache:
        for name, buf in layer.items():
            layer[name] = torch.gather(
                buf, 2, idx.view(b, 1, max_len, *([1] * (buf.dim() - 3))).expand(buf.shape))
    return logits[:, -1, :], cache


class BatchServer:
    """Synchronous continuous-batching server over the dense cache."""

    def __init__(self, frozen, trainable, cfg: affectgpt.AffectGPTConfig, tokenizer,
                 max_slots: int = 8, max_len: int = 512, do_sample: bool = False,
                 top_p: float = 0.9, temperature: float = 1.0, seed: int = 0,
                 prefill_bucket: int = 64, layout: Optional[mesh.Layout] = None):
        frozen, trainable, cfg = serving_shard(frozen, trainable, cfg, layout)
        self.frozen, self.trainable, self.cfg = frozen, trainable, cfg
        self.tokenizer = tokenizer
        self.max_slots, self.max_len = max_slots, max_len
        # prompts are padded up to a bucket multiple, as JAX pads them to
        # share compiled prefills
        self.prefill_bucket = prefill_bucket
        self.do_sample, self.top_p, self.temperature = do_sample, top_p, temperature
        table = frozen["llm"]["embed_tokens"]["table"]
        self.device = table.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the cache takes the embedding table's dtype (a quantized tree's
        # other leaves may be int8 or f32 scales)
        self.cache = qwen2.init_cache(cfg.llm, max_slots, max_len, dtype=table.dtype,
                                      device=self.device)
        self.slots = [SlotState() for _ in range(max_slots)]
        self.next_tokens = np.zeros(max_slots, np.int32)
        self.pending: List[Request] = []
        self.results: Dict[int, List[int]] = {}
        self._stops = {tokenizer.eos_token_id}
        self.clock = RequestClock()
        self.stats = {"admissions": 0, "admitted_requests": 0, "decode_steps": 0,
                      "t_prefill": 0.0, "t_decode": 0.0}

    # -- API -----------------------------------------------------------------
    def submit(self, request: Request) -> None:
        # an over-long prompt would be lost after dequeue (> max_len) or leave
        # no cache column for the first decode write (== max_len)
        if len(request.input_ids) >= self.max_len:
            raise ValueError(
                f"prompt length {len(request.input_ids)} must be < max_len "
                f"{self.max_len} (one cache column is needed for decode)"
            )
        self.pending.append(request)
        self.clock.submitted(request.request_id)

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        for _ in range(max_steps):
            if not self.step():
                break
        if self.pending or any(not s.done for s in self.slots):
            logger.warning(
                "run_until_drained exhausted max_steps=%d with %d pending and %d live slots "
                "— results are incomplete", max_steps, len(self.pending),
                sum(not s.done for s in self.slots))
        return self.results

    # -- scheduling ------------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.do_sample:
            token = gen.top_p_sample(self.generator, logits, self.top_p, self.temperature)
        else:
            token = torch.argmax(logits, dim=-1)
        return mesh.tp_broadcast(token, self.cfg.llm.layout)

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s.done]
        if not free or not self.pending:
            return
        # the longest prefix of pending that fits the free slots and shares
        # one modality signature
        sig = signature(self.pending[0])
        batch = []
        for req in self.pending:
            if len(batch) >= len(free) or signature(req) != sig:
                break
            batch.append(req)
        del self.pending[:len(batch)]
        slots = free[:len(batch)]
        self.stats["admissions"] += 1
        self.stats["admitted_requests"] += len(batch)
        t0 = time.perf_counter()

        n_bucket = bucket(len(batch))
        t_max = max(len(r.input_ids) for r in batch)
        t_pad = min(-(-t_max // self.prefill_bucket) * self.prefill_bucket, self.max_len)
        embeds, lengths = admission_embeds(self.frozen, self.trainable, self.cfg, batch,
                                           n_bucket, t_pad, self.device)
        last_logits, new_cache = _prefill(self.frozen, self.trainable, self.cfg, embeds,
                                          lengths, self.max_len)
        # splice the real rows into their slots (JAX scatters the dummy rows
        # out of bounds, where they are dropped)
        slot_ids = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        for layer, new_layer in zip(self.cache, new_cache):
            for name in layer:
                layer[name][slot_ids] = new_layer[name][:len(batch)].to(layer[name].dtype)
        first = self._sample(last_logits).cpu().numpy().astype(np.int32)
        self.stats["t_prefill"] += time.perf_counter() - t0
        for req in batch:
            self.clock.first_token(req.request_id)
        for i, (slot, req) in enumerate(zip(slots, batch)):
            state = self.slots[slot]
            state.request_id = req.request_id
            state.position = int(lengths[i])
            state.remaining = req.max_new_tokens - 1
            state.done = False
            state.tokens = [int(first[i])]
            self.next_tokens[slot] = first[i]
            if int(first[i]) in self._stops or state.remaining <= 0:
                self._finish(slot)

    def _finish(self, slot: int) -> None:
        state = self.slots[slot]
        tokens = state.tokens
        if tokens and tokens[-1] in self._stops:
            tokens = tokens[:-1]
        self.results[state.request_id] = tokens
        self.clock.finished(state.request_id, len(tokens))
        state.done = True

    def _decode_step(self, positions: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """One token for every slot: tokens at per-slot cache columns, the
        key mask up to each slot's column, inactive slots masked out."""
        dev = self.device
        pos = torch.as_tensor(positions, dtype=torch.int32, device=dev)
        act = torch.as_tensor(active, device=dev)
        tokens = torch.as_tensor(self.next_tokens, dtype=torch.long, device=dev)
        embeds = qwen2.embed_tokens(self.frozen["llm"], tokens)[:, None, :].to(
            self.cache[0]["k"].dtype)
        key_mask = (torch.arange(self.max_len, device=dev)[None, None, :]
                    <= pos.long()[:, None, None]) & act[:, None, None]
        logits, _ = qwen2.forward(self.frozen["llm"], self.cfg.llm, embeds, key_mask,
                                  lora=self.trainable.get("lora"), positions=pos[:, None],
                                  cache=self.cache, cache_index=pos)
        return self._sample(logits[:, 0, :])

    def step(self) -> bool:
        """Admit + advance one decode step. Returns False when idle."""
        self._admit()
        active = np.array([not s.done for s in self.slots])
        if not active.any():
            return bool(self.pending)
        t0 = time.perf_counter()
        positions = np.array([s.position for s in self.slots], np.int32)
        sampled = self._decode_step(positions, active).cpu().numpy()
        self.stats["t_decode"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        for i, state in enumerate(self.slots):
            if state.done:
                continue
            token = int(sampled[i])
            state.tokens.append(token)
            state.position += 1
            state.remaining -= 1
            self.next_tokens[i] = token
            if token in self._stops or state.remaining <= 0 or state.position >= self.max_len - 1:
                self._finish(i)
        return True
