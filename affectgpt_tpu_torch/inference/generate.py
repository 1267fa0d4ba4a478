"""Batched prefill + KV-cache decode, in PyTorch.

Port of affectgpt_tpu/inference/generate.py. `generate`: prompts of
different lengths are left-packed so that every row ends at the same column
and each decode step writes one shared cache column. The decode loop runs
exactly `max_new_tokens` steps, as the JAX `lax.scan` does, and makes no
host synchronisation inside the loop: stop handling, the `done` mask and the
repetition penalty's `seen` mask stay on the device.

`generate_speculative`: prompt-lookup speculative greedy decoding, the same
tokens as `generate(do_sample=False)` with fewer weight sweeps. JAX's
`lax.while_loop` becomes a host loop whose test (`any(~done)`) reads one
flag from the device per verify iteration.

Under a layout (`llm_cfg.layout`, a rank's shard config from
`parallel.mesh.shard_config`): the batch is split over the dp groups, each
dp group decodes its share (`mesh.dp_share`) and the ranks gather the
tokens of the whole batch (`mesh.dp_gather`), as JAX's dp-sharded batch
comes back whole. Within a tp group every rank takes the same token at
every step: each rank samples from its gathered logits with a generator
seeded alike, and tp rank 0's token (or, in the speculative verify, its
predictions) is broadcast over the group, so that a last-bit difference
between the ranks' logits can never split their streams.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from affectgpt_tpu_torch.models import qwen2
from affectgpt_tpu_torch.parallel import mesh


@dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 300
    temperature: float = 1.0
    top_p: float = 0.9
    do_sample: bool = True
    eos_token_id: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    # HF RepetitionPenaltyLogitsProcessor semantics; 1.0 = off. The
    # reference's AU agent generates with 1.1.
    repetition_penalty: float = 1.0


def _reciprocal_f32(value: float) -> float:
    """1 / value rounded to f32: XLA compiles JAX's division by a constant
    into a product with this reciprocal, and every JAX caller runs compiled."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return (one / torch.tensor(value, dtype=torch.float32)).item()


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor math on [b, vocab] logits, in f32:
    for every token present in the sequence (`seen`, a bool mask), score < 0
    → score · penalty, else score / penalty (as JAX computes it compiled: a
    product with f32(1 / penalty))."""
    logits = logits.float()
    penalized = torch.where(logits < 0, logits * penalty, logits * _reciprocal_f32(penalty))
    return torch.where(seen, penalized, logits)


def _seen_from_prompt(prompt_ids: torch.Tensor, prompt_lengths: torch.Tensor, b: int,
                      t_pad: int, vocab: int) -> torch.Tensor:
    """[b, vocab] bool presence mask of the prompt's tokens, padding left out:
    padded positions scatter into a sacrificial column `vocab`, then dropped."""
    dev = prompt_ids.device
    valid = torch.arange(t_pad, device=dev)[None, :] < prompt_lengths.to(dev)[:, None]
    clamped = torch.where(valid, prompt_ids.long(), torch.full_like(prompt_ids.long(), vocab))
    seen = torch.zeros((b, vocab + 1), dtype=torch.bool, device=dev)
    seen.scatter_(1, clamped, True)
    return seen[:, :vocab]


def top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Boolean keep-mask over [b, vocab] logits with the HF TopPLogitsWarper
    semantics: ascending stable sort, drop tokens whose ascending cumulative
    probability is <= 1 - top_p, always keep the top token, remove by
    sorted position (ties at the boundary keep only what the mass allows)."""
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, stable=True)
    cumulative = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove_sorted = cumulative <= (1.0 - top_p)
    remove_sorted[..., -1] = False
    remove = torch.zeros_like(remove_sorted).scatter(-1, sorted_idx, remove_sorted)
    return ~remove


def top_p_sample(generator: Optional[torch.Generator], logits: torch.Tensor, top_p: float,
                 temperature: float) -> torch.Tensor:
    """Nucleus sampling over [b, vocab] logits: temperature first, then the
    top-p mask. Returns [b] token ids."""
    logits = logits.float() / max(temperature, 1e-6)
    masked = logits.masked_fill(~top_p_mask(logits, top_p), float("-inf"))
    probs = torch.softmax(masked, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _left_pack(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Roll each row right by (t - len) so content ends at the last column."""
    t = x.shape[1]
    shift = (t - lengths).to(torch.long)
    idx = (torch.arange(t, device=x.device)[None, :] - shift[:, None]) % t  # [b, t]
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def _prefill(frozen_llm: dict, llm_cfg: qwen2.QwenConfig, prompt_embeds: torch.Tensor,
             lengths: torch.Tensor, max_len: int, lora: Optional[dict], cache_dtype):
    """Left-pack the right-padded prompts and run the prefill into a new
    cache of max_len columns. Returns (the key-valid mask over all max_len
    columns [b, max_len], the cache, the last position's logits [b, vocab])."""
    b, t_pad, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    embeds = _left_pack(prompt_embeds, lengths)
    pad_len = t_pad - lengths
    cols = torch.arange(t_pad, device=dev)
    key_valid = cols[None, :] >= pad_len[:, None]  # [b, t_pad]
    positions = (cols[None, :] - pad_len[:, None]).clamp(min=0)

    cache = qwen2.init_cache(llm_cfg, b, max_len, dtype=cache_dtype or embeds.dtype, device=dev)
    slots = torch.arange(max_len, device=dev)
    causal = slots[None, None, :] <= cols[None, :, None]  # [1, t_pad, max_len]
    key_valid_gen = torch.nn.functional.pad(key_valid, (0, max_len - t_pad), value=True)
    prefill_mask = causal & key_valid_gen[:, None, :]
    logits, cache = qwen2.forward(
        frozen_llm, llm_cfg, embeds, prefill_mask, lora=lora, positions=positions,
        cache=cache, cache_index=0, last_token_only=True,
    )
    return key_valid_gen, cache, logits[:, -1, :]


def _stop_ids(gen_cfg: GenerateConfig, dev) -> torch.Tensor:
    return torch.tensor((gen_cfg.eos_token_id,) + tuple(gen_cfg.stop_token_ids),
                        dtype=torch.long, device=dev)


def _dp_split(llm_cfg: qwen2.QwenConfig, run, prompt_embeds, *batched):
    """run(prompt_embeds, *batched) on this dp rank's share of the batch
    (None entries pass as they are), its batch-shaped outputs gathered back
    whole; anything else it returns is this rank's."""
    layout = llm_cfg.layout
    if layout is None or layout.dp <= 1:
        return run(prompt_embeds, *batched)
    b = prompt_embeds.shape[0]
    out = run(*(None if t is None else mesh.dp_share(t, layout)
                for t in (prompt_embeds, *batched)))
    return tuple(mesh.dp_gather(o, b, layout) if torch.is_tensor(o) else o for o in out)


def generate(
    frozen_llm: dict,
    llm_cfg: qwen2.QwenConfig,
    gen_cfg: GenerateConfig,
    prompt_embeds: torch.Tensor,
    prompt_lengths: torch.Tensor,
    generator: Optional[torch.Generator],
    max_len: int,
    lora: Optional[dict] = None,
    decode_llm: Optional[dict] = None,
    cache_dtype: Optional[torch.dtype] = None,
    prompt_ids: Optional[torch.Tensor] = None,
):
    """Generate continuations for a batch of spliced prompt embeddings.

    prompt_embeds [b, t_pad, d] right-padded; prompt_lengths [b] on the same
    device. max_len >= t_pad + max_new_tokens (KV-cache capacity).
    generator: drawn from when gen_cfg.do_sample.
    decode_llm: a second copy of the decoder weights used only by the decode
    loop, token embeddings included (e.g. `qwen2.quantize_params` of
    frozen_llm: bf16 prefill, quantized decode).
    cache_dtype: the KV cache's dtype, the prompt embeddings' by default;
    torch.int8 selects the quantized cache (`qwen2.init_cache`).
    prompt_ids [b, t_pad] right-padded, read only when
    gen_cfg.repetition_penalty != 1.0: HF penalizes the prompt's tokens and
    the generated ones; without prompt_ids only generated tokens are.
    Returns (tokens [b, max_new_tokens], num_valid [b]); tokens after a
    row's stop are eos.
    """
    return _dp_split(
        llm_cfg,
        lambda e, lens, ids: _generate(frozen_llm, llm_cfg, gen_cfg, e, lens, generator,
                                       max_len, lora, decode_llm, cache_dtype, ids),
        prompt_embeds, prompt_lengths, prompt_ids)


def _generate(frozen_llm, llm_cfg, gen_cfg, prompt_embeds, prompt_lengths, generator, max_len,
              lora, decode_llm, cache_dtype, prompt_ids):
    b, t_pad, _ = prompt_embeds.shape
    max_new = gen_cfg.max_new_tokens
    if max_len < t_pad + max_new:
        raise ValueError(f"max_len {max_len} < prompt {t_pad} + max_new_tokens {max_new}")
    dev = prompt_embeds.device
    lengths = prompt_lengths.to(device=dev, dtype=torch.long)
    key_valid_gen, cache, cur_logits = _prefill(
        frozen_llm, llm_cfg, prompt_embeds, lengths, max_len, lora, cache_dtype)
    stop_ids = _stop_ids(gen_cfg, dev)
    slots = torch.arange(max_len, device=dev)
    step_llm = decode_llm if decode_llm is not None else frozen_llm
    penalty = gen_cfg.repetition_penalty
    if penalty != 1.0:
        vocab = cur_logits.shape[-1]
        seen = (_seen_from_prompt(prompt_ids.to(dev), lengths, b, t_pad, vocab)
                if prompt_ids is not None
                else torch.zeros((b, vocab), dtype=torch.bool, device=dev))
    rows = torch.arange(b, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    cur_pos = lengths.to(torch.int32)  # the decode-QKV kernel reads int32 positions
    tokens = []
    for step in range(max_new):
        if penalty != 1.0:
            cur_logits = apply_repetition_penalty(cur_logits, seen, penalty)
        if gen_cfg.do_sample:
            token = top_p_sample(generator, cur_logits, gen_cfg.top_p, gen_cfg.temperature)
        else:
            token = torch.argmax(cur_logits, dim=-1)
        token = mesh.tp_broadcast(token, llm_cfg.layout)
        token = torch.where(done, torch.full_like(token, gen_cfg.eos_token_id), token)
        if penalty != 1.0:  # the emitted token joins the penalized set
            seen[rows, token] = True
        done = done | (token[:, None] == stop_ids[None, :]).any(dim=-1)
        tokens.append(token)

        tok_embeds = qwen2.embed_tokens(step_llm, token)[:, None, :].to(prompt_embeds.dtype)
        write_idx = t_pad + step
        key_mask = (slots[None, None, :] <= write_idx) & key_valid_gen[:, None, :]
        logits_d, cache = qwen2.forward(
            step_llm, llm_cfg, tok_embeds, key_mask, lora=lora,
            positions=cur_pos[:, None], cache=cache, cache_index=write_idx,
        )
        cur_logits = logits_d[:, 0, :]
        cur_pos = cur_pos + 1

    if max_new == 0:
        return (torch.zeros((b, 0), dtype=torch.long, device=dev),
                torch.zeros((b,), dtype=torch.long, device=dev))
    tokens = torch.stack(tokens, dim=1)  # [b, max_new]
    is_stop = (tokens[:, :, None] == stop_ids[None, None, :]).any(dim=-1)
    num_valid = torch.where(is_stop.any(dim=1), torch.argmax(is_stop.to(torch.int32), dim=1),
                            torch.full((b,), max_new, device=dev))
    return tokens, num_valid


def generate_speculative(
    frozen_llm: dict,
    llm_cfg: qwen2.QwenConfig,
    gen_cfg: GenerateConfig,
    prompt_embeds: torch.Tensor,
    prompt_lengths: torch.Tensor,
    prompt_ids: torch.Tensor,
    max_len: int,
    lora: Optional[dict] = None,
    draft_len: int = 4,
    cache_dtype: Optional[torch.dtype] = None,
    return_stats: bool = False,
):
    """Prompt-lookup speculative GREEDY decoding: the tokens of
    `generate(do_sample=False)`, with one weight sweep per verify iteration
    instead of one per token. Each iteration drafts `draft_len` tokens from
    the continuation of an earlier match of the stream's head in the id
    history and verifies them in one forward of t = draft_len + 1 rows,
    written at each row's own cache columns; a row keeps the drafts its
    greedy predictions confirm, plus one bonus token. Exact in exact
    arithmetic (in f32 on the CPU, identical to `generate`); in bf16 a t > 1
    verify and a t = 1 step may round a near-tie differently.

    prompt_ids [b, t_pad] right-padded token ids of the prompt (patch
    positions may be 0). max_len >= t_pad + max_new_tokens + draft_len (the
    verify writes overshoot by up to draft_len). Returns (tokens [b,
    max_new_tokens], num_valid [b]) like `generate`, and with return_stats
    also the number of verify iterations run (this dp rank's under a
    layout).
    """
    out = _dp_split(
        llm_cfg,
        lambda e, lens, ids: _generate_speculative(frozen_llm, llm_cfg, gen_cfg, e, lens, ids,
                                                   max_len, lora, draft_len, cache_dtype),
        prompt_embeds, prompt_lengths, prompt_ids)
    return out if return_stats else out[:2]


def _generate_speculative(frozen_llm, llm_cfg, gen_cfg, prompt_embeds, prompt_lengths,
                          prompt_ids, max_len, lora, draft_len, cache_dtype):
    if gen_cfg.do_sample:
        raise ValueError("speculative decoding is greedy-only")
    if gen_cfg.repetition_penalty != 1.0:
        raise ValueError("repetition_penalty is not supported on the speculative path")
    b, t_pad, _ = prompt_embeds.shape
    max_new, d = gen_cfg.max_new_tokens, draft_len
    if max_len < t_pad + max_new + d:
        raise ValueError(f"max_len {max_len} < prompt {t_pad} + max_new_tokens {max_new} "
                         f"+ draft_len {d}")
    dev = prompt_embeds.device
    lengths = prompt_lengths.to(device=dev, dtype=torch.long)
    key_valid_gen, cache, logits = _prefill(
        frozen_llm, llm_cfg, prompt_embeds, lengths, max_len, lora, cache_dtype)
    t0 = mesh.tp_broadcast(torch.argmax(logits, dim=-1), llm_cfg.layout)  # the first new token
    stop_ids = _stop_ids(gen_cfg, dev)

    def is_stop(tok):
        return (tok[..., None] == stop_ids).any(dim=-1)

    # the id history: the left-packed prompt, then the generated region
    ids_buf = torch.nn.functional.pad(_left_pack(prompt_ids.to(dev).long(), lengths),
                                      (0, max_len - t_pad))
    slots = torch.arange(max_len, device=dev)[None, :]
    steps = torch.arange(d + 1, device=dev)[None, :]
    rows = torch.arange(b, device=dev)[:, None].expand(b, d + 1)
    # position j - 1 must itself be a valid stream token: the roll wraps the
    # last column to position 0, and left-pad zeros could match `prev`
    prev_valid = torch.roll(key_valid_gen, 1, dims=1)

    def propose(last_tok, cur_abs):
        """Draft = the continuation of the best earlier match of the stream's
        head, by tier: a 2-gram match whose d-token continuation is written,
        then such a 1-gram match, then the nearest 1-gram match; the last
        token repeated where none exists. cur_abs [b]: the column last_tok
        sits at."""
        hit1 = (ids_buf == last_tok[:, None]) & (slots < cur_abs[:, None]) & key_valid_gen
        prev = ids_buf.gather(1, (cur_abs - 1).clamp(min=0)[:, None])  # [b, 1]
        hit2 = hit1 & (torch.roll(ids_buf, 1, dims=1) == prev) & prev_valid & (slots >= 1)
        full = slots < cur_abs[:, None] - d
        none = torch.full_like(ids_buf, -1)

        def last(hit):
            return torch.where(hit, slots.expand_as(ids_buf), none).amax(dim=1)

        j2, j1, j_any = last(hit2 & full), last(hit1 & full), last(hit1)
        j = torch.where(j2 >= 0, j2, torch.where(j1 >= 0, j1, j_any))  # -1: none
        found = j >= 0
        # JAX's dynamic_slice clamps the start so that the d-slice fits
        start = torch.where(found, j + 1, 0).clamp(max=max_len - d)
        drafts = ids_buf.gather(1, start[:, None] + steps[:, :d])
        return torch.where(found[:, None], drafts, last_tok[:, None])

    n_emitted = torch.zeros((b,), dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = 0
    while iters < max_new and bool((~done).any()):
        active = ~done
        cur_abs = t_pad + n_emitted  # the column of t0
        drafts = propose(t0, cur_abs)  # [b, d]
        cand = torch.cat([t0[:, None], drafts], dim=1)  # [b, d + 1]
        tok_embeds = qwen2.embed_tokens(frozen_llm, cand).to(prompt_embeds.dtype)
        q_abs = cur_abs[:, None] + steps  # [b, d + 1]
        key_mask = (slots[:, None, :] <= q_abs[:, :, None]) & key_valid_gen[:, None, :]
        logits_v, cache = qwen2.forward(
            frozen_llm, llm_cfg, tok_embeds, key_mask, lora=lora,
            positions=(lengths + n_emitted)[:, None] + steps, cache=cache, cache_index=cur_abs,
        )
        preds = mesh.tp_broadcast(torch.argmax(logits_v, dim=-1), llm_cfg.layout)  # [b, d + 1]

        # greedy acceptance: a draft survives iff it equals the prediction
        # before it and every earlier draft survived
        acc = torch.cumprod((preds[:, :d] == drafts).long(), dim=1)  # [b, d]
        n_acc = acc.sum(dim=1)
        bonus = preds.gather(1, n_acc[:, None])[:, 0]
        emitted = torch.cat([torch.ones_like(acc[:, :1]), acc], dim=1).bool()
        # truncate at the first stop among the emitted tokens
        stops = is_stop(cand) & emitted
        any_stop = stops.any(dim=1)
        count = torch.where(any_stop, torch.argmax(stops.int(), dim=1) + 1, 1 + n_acc)

        # emit: row i's first `count` tokens at columns t_pad + n_emitted[i] + k,
        # never past t_pad + max_new (the other columns keep their ids); a
        # done row's columns reach max_len, so clamp them for the indexing
        cols = (cur_abs[:, None] + steps).clamp(max=max_len - 1)
        write = active[:, None] & (steps < count[:, None]) & (cols < t_pad + max_new)
        ids_buf[rows, cols] = torch.where(write, cand, ids_buf[rows, cols])
        n_emitted = n_emitted + torch.where(
            active, torch.minimum(count, max_new - n_emitted), torch.zeros_like(count))
        # a stop in `bonus` does not end the row yet: the next iteration
        # emits it, as generate() emits the stop token
        done = done | (active & any_stop) | (n_emitted >= max_new)
        t0 = torch.where(active, bonus, t0)
        iters += 1

    tokens, num_valid = ids_buf[:, t_pad:t_pad + max_new], n_emitted
    if max_new:  # the stop token at num_valid stays, everything after it becomes eos
        gen_stop = is_stop(tokens)
        num_valid = torch.where(gen_stop.any(dim=1), torch.argmax(gen_stop.int(), dim=1),
                                n_emitted)
        tail = torch.arange(max_new, device=dev)[None, :] > num_valid[:, None]
        tokens = torch.where(tail, torch.full_like(tokens, gen_cfg.eos_token_id), tokens)
    return tokens, num_valid, iters


def trim_output_text(text: str) -> str:
    """Host-side stop-string cleanup matching the reference
    (conversation_video.py:381-388): strip at eos, cut at the LAST '###',
    then take the text after the last 'Assistant:' and strip."""
    text = text.split("</s>")[0]
    text = text.rsplit("###", 1)[0]
    return text.split("Assistant:")[-1].strip()
