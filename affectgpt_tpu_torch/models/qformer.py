"""Q-Former: learned query tokens cross-attending over encoder states, in
PyTorch.

Port of affectgpt_tpu/models/qformer.py: the temporal and fusion Q-Formers of the `qformer` mergers (the reference's vendored BERT,
my_affectgpt/models/Qformer.py, with the text FFN and cls head stripped).
Per layer, post-LN:

    x = LN(x + SelfAttn(x))
    x = LN(x + CrossAttn(x, enc))   # every cross_attention_freq-th layer
    x = LN(x + FFN(x))

after a LayerNorm of the query embeddings. In train mode (a dropout key)
the BERT dropouts run as in JAX: the query embeddings, each attention's
probabilities and each sublayer's output before its residual.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from affectgpt_tpu_torch.models import nn


@dataclass(frozen=True)
class QFormerConfig:
    hidden_size: int = 768
    num_heads: int = 12
    num_layers: int = 2
    intermediate_size: int = 3072
    encoder_width: int = 768
    num_query_tokens: int = 32
    layer_norm_eps: float = 1e-12
    # cross-attention every Nth layer (1 for the temporal Q-Formers, 2 for
    # the BLIP2 image Q-Former)
    cross_attention_freq: int = 1
    # BERT dropouts (bert-base-uncased's 0.1 / 0.1), applied only in train
    # mode, when apply() receives a dropout key
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1

    @classmethod
    def blip2(cls, num_query_tokens: int = 32, encoder_width: int = 1408):
        return cls(num_layers=12, cross_attention_freq=2,
                   num_query_tokens=num_query_tokens, encoder_width=encoder_width)

    @classmethod
    def tiny(cls, encoder_width: int = 16, num_query_tokens: int = 4):
        return cls(hidden_size=16, num_heads=2, num_layers=2, intermediate_size=32,
                   encoder_width=encoder_width, num_query_tokens=num_query_tokens)


def init_params(generator: torch.Generator, cfg: QFormerConfig, dtype=torch.float32) -> dict:
    """Random Q-Former weights on the generator's device (JAX's tree and
    scales; the values differ from JAX's for the same seed)."""
    dev = generator.device
    h = cfg.hidden_size
    layers = []
    for i in range(cfg.num_layers):
        layer = {
            "self_attn": nn.mha_init(generator, h, h, cfg.num_heads, dtype=dtype),
            "self_ln": nn.layernorm_init(h, dtype=dtype, device=dev),
            "ffn_in": nn.dense_init(generator, h, cfg.intermediate_size, dtype=dtype),
            "ffn_out": nn.dense_init(generator, cfg.intermediate_size, h, dtype=dtype),
            "ffn_ln": nn.layernorm_init(h, dtype=dtype, device=dev),
        }
        if i % cfg.cross_attention_freq == 0:
            layer["cross_attn"] = nn.mha_init(generator, h, cfg.encoder_width, cfg.num_heads,
                                              dtype=dtype)
            layer["cross_ln"] = nn.layernorm_init(h, dtype=dtype, device=dev)
        layers.append(layer)
    return {
        "query_tokens": nn.normal(generator, (1, cfg.num_query_tokens, h), 0.02, dtype),
        "embed_ln": nn.layernorm_init(h, dtype=dtype, device=dev),
        "layers": layers,
    }


def apply(params: dict, cfg: QFormerConfig, encoder_hidden_states: torch.Tensor,
          encoder_mask: Optional[torch.Tensor] = None, dropout_rng=None) -> torch.Tensor:
    """encoder_hidden_states [b, t, encoder_width] → [b, num_query, hidden].
    encoder_mask [b, t] bool (True = valid) folds padded timesteps out of the
    cross-attention; a row with no valid step attends uniformly over all of
    them, as JAX's finfo.min fill gives. dropout_rng: a dropout key (train
    mode; `nn.fold_in`) or None (eval mode). Site keys follow JAX: the
    embeddings fold 10000 then 5; layer i folds i, then 0 self-probs, 1
    self-hidden, 2 cross-probs, 3 cross-hidden, 4 ffn-hidden."""
    b = encoder_hidden_states.shape[0]
    x = params["query_tokens"].to(encoder_hidden_states.dtype).expand(
        b, cfg.num_query_tokens, cfg.hidden_size)
    x = nn.layernorm(params["embed_ln"], x, cfg.layer_norm_eps)
    h_p, a_p = cfg.hidden_dropout_prob, cfg.attention_probs_dropout_prob
    drop_on = dropout_rng is not None and (h_p > 0.0 or a_p > 0.0)

    def hdrop(key, y):
        return nn.dropout(key, h_p, y) if drop_on and h_p > 0.0 else y

    def pdrop(key):
        return (key, a_p) if drop_on and a_p > 0.0 else None

    if drop_on:
        x = hdrop(nn.fold_in(nn.fold_in(dropout_rng, 10_000), 5), x)
    cross_mask = None if encoder_mask is None else encoder_mask.bool()[:, None, None, :]
    for i, layer in enumerate(params["layers"]):
        lk = nn.fold_in(dropout_rng, i) if drop_on else None
        site = (lambda s: nn.fold_in(lk, s)) if drop_on else (lambda s: None)
        attn = nn.mha(layer["self_attn"], x, x, cfg.num_heads, probs_drop=pdrop(site(0)))
        x = nn.layernorm(layer["self_ln"], x + hdrop(site(1), attn), cfg.layer_norm_eps)
        if "cross_attn" in layer:
            cross = nn.mha(layer["cross_attn"], x, encoder_hidden_states, cfg.num_heads,
                           cross_mask, probs_drop=pdrop(site(2)))
            x = nn.layernorm(layer["cross_ln"], x + hdrop(site(3), cross), cfg.layer_norm_eps)
        h = nn.dense(layer["ffn_out"], nn.gelu(nn.dense(layer["ffn_in"], x)))
        x = nn.layernorm(layer["ffn_ln"], x + hdrop(site(4), h), cfg.layer_norm_eps)
    return x
