"""Batched prefill + KV-cache decode, in PyTorch.

Port of affectgpt_tpu/inference/generate.py (`generate` and its helpers).
Prompts of different lengths are left-packed so that every row ends at the
same column and each decode step writes one shared cache column. The decode
loop runs exactly `max_new_tokens` steps, as the JAX `lax.scan` does, and
makes no host synchronisation inside the loop: stop handling and the
`done` mask stay on the device.

Not ported yet: the repetition penalty and `generate_speculative`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from affectgpt_tpu_torch.models import qwen2


@dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 300
    temperature: float = 1.0
    top_p: float = 0.9
    do_sample: bool = True
    eos_token_id: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    repetition_penalty: float = 1.0  # only 1.0 is supported by the port so far


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
    Returns (tokens [b, max_new_tokens], num_valid [b]); tokens after a
    row's stop are eos.
    """
    if gen_cfg.repetition_penalty != 1.0:
        raise NotImplementedError("repetition_penalty is not ported to PyTorch yet")
    b, t_pad, _ = prompt_embeds.shape
    max_new = gen_cfg.max_new_tokens
    if max_len < t_pad + max_new:
        raise ValueError(f"max_len {max_len} < prompt {t_pad} + max_new_tokens {max_new}")
    dev = prompt_embeds.device
    lengths = prompt_lengths.to(device=dev, dtype=torch.long)

    embeds = _left_pack(prompt_embeds, lengths)
    pad_len = t_pad - lengths
    cols = torch.arange(t_pad, device=dev)
    key_valid = cols[None, :] >= pad_len[:, None]  # [b, t_pad]
    positions = (cols[None, :] - pad_len[:, None]).clamp(min=0)

    cache = qwen2.init_cache(llm_cfg, b, max_len, dtype=cache_dtype or embeds.dtype, device=dev)
    slots = torch.arange(max_len, device=dev)
    causal = slots[None, None, :] <= cols[None, :, None]  # [1, t_pad, max_len]
    key_valid_full = torch.nn.functional.pad(key_valid, (0, max_len - t_pad))
    prefill_mask = causal & key_valid_full[:, None, :]
    logits, cache = qwen2.forward(
        frozen_llm, llm_cfg, embeds, prefill_mask, lora=lora, positions=positions,
        cache=cache, cache_index=0, last_token_only=True,
    )
    cur_logits = logits[:, -1, :]

    stop_ids = torch.tensor((gen_cfg.eos_token_id,) + tuple(gen_cfg.stop_token_ids),
                            dtype=torch.long, device=dev)
    key_valid_gen = torch.cat(
        [key_valid, torch.ones((b, max_len - t_pad), dtype=torch.bool, device=dev)], dim=1
    )
    step_llm = decode_llm if decode_llm is not None else frozen_llm
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    cur_pos = lengths.to(torch.int32)  # the decode-QKV kernel reads int32 positions
    tokens = []
    for step in range(max_new):
        if gen_cfg.do_sample:
            token = top_p_sample(generator, cur_logits, gen_cfg.top_p, gen_cfg.temperature)
        else:
            token = torch.argmax(cur_logits, dim=-1)
        token = torch.where(done, torch.full_like(token, gen_cfg.eos_token_id), token)
        done = done | (token[:, None] == stop_ids[None, :]).any(dim=-1)
        tokens.append(token)

        tok_embeds = qwen2.embed_tokens(step_llm, token)[:, None, :].to(embeds.dtype)
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


def trim_output_text(text: str) -> str:
    """Host-side stop-string cleanup matching the reference
    (conversation_video.py:381-388): strip at eos, cut at the LAST '###',
    then take the text after the last 'Assistant:' and strip."""
    text = text.split("</s>")[0]
    text = text.rsplit("###", 1)[0]
    return text.split("Assistant:")[-1].strip()
