"""WavLM-large and data2vec-audio-base acoustic towers, in PyTorch.

Port of affectgpt_tpu/models/wav_encoders.py: registry alternates to the
HuBERT tower (reference: my_affectgpt/models/encoder.py:354-394
WAVLM_LARGE, :313-352 DATA2VEC_BASE) with its pooling, the mean of the last
4 hidden layers and then the time mean of each 2 s clip.

- WavLM-large: HuBERT's conv frontend (layer-norm mode) and stable-LN stack,
  whose self-attention adds a gated relative position bias: T5-style
  log-bucketed relative positions embedded per head (computed once, reused
  by every layer), gated per (clip, head, query) by a sigmoid of a small
  projection of the query's hidden state. The attention is its own plain
  chain (f32 scores plus the bias, p rounded to v's dtype, f32 PV), as in
  JAX.
- data2vec-audio-base: the layer-norm conv frontend, 5 stacked positional
  convolutions each with a non-affine LayerNorm and gelu, a post-LN stack
  whose attention is `nn.mha` (99 frames a 2 s clip: the plain chain).

Both reuse the HuBERT port's conv frontend and positional convolution
(`hubert._conv_frontend`, `hubert._pos_conv`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from affectgpt_tpu_torch.models import hubert, nn
from affectgpt_tpu_torch.models.hubert import HubertConfig, _conv_frontend, _pos_conv


@dataclass(frozen=True)
class WavLMConfig:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    layer_norm_eps: float = 1e-5
    mean_last_k_layers: int = 4

    @classmethod
    def large(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
                   hidden_size=16, num_layers=3, num_heads=2, intermediate_size=32,
                   pos_conv_kernel=8, pos_conv_groups=2, num_buckets=8,
                   max_distance=16, mean_last_k_layers=2)

    def as_hubert(self) -> HubertConfig:
        return HubertConfig(
            conv_dim=self.conv_dim, conv_kernel=self.conv_kernel,
            conv_stride=self.conv_stride, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            pos_conv_kernel=self.pos_conv_kernel, pos_conv_groups=self.pos_conv_groups,
            layer_norm_eps=self.layer_norm_eps,
            mean_last_k_layers=self.mean_last_k_layers,
        )


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """[q, k] T5-style signed log buckets of the key's position relative to
    the query's (HF WavLMAttention._relative_positions_bucket)."""
    rel = np.arange(k_len)[None, :] - np.arange(q_len)[:, None]
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact) / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return buckets + np.where(rel < max_exact, rel, large)


def init_wavlm_params(generator: torch.Generator, cfg: WavLMConfig,
                      dtype=torch.bfloat16) -> dict:
    """Random WavLM weights on the generator's device: HuBERT's tree plus the
    relative-position embedding and each layer's gate (JAX's tree and
    scales; the values differ from JAX's for the same seed)."""
    base = hubert.init_params(generator, cfg.as_hubert(), dtype=dtype)
    base["rel_attn_embed"] = nn.embedding_init(generator, cfg.num_buckets, cfg.num_heads,
                                               dtype=dtype)
    for layer in base["layers"]:
        layer["gru_rel_pos_linear"] = nn.dense_init(
            generator, cfg.hidden_size // cfg.num_heads, 8, dtype=dtype)
        layer["gru_rel_pos_const"] = torch.ones((1, cfg.num_heads, 1, 1), dtype=dtype,
                                                device=generator.device)
    return base


def _wavlm_attention(layer: dict, cfg: WavLMConfig, x: torch.Tensor,
                     position_bias: torch.Tensor) -> torch.Tensor:
    """Self-attention with the gated relative position bias: x [b, t, d],
    position_bias [h, t, t]."""
    b, t, d = x.shape
    h, hd = cfg.num_heads, d // cfg.num_heads
    # the gate from the query's hidden state (HF WavLMAttention.forward 1-4)
    gated = x.reshape(b, t, h, hd).transpose(1, 2)  # [b, h, t, hd]
    proj = nn.dense(layer["gru_rel_pos_linear"], gated)  # [b, h, t, 8]
    proj = proj.reshape(b, h, t, 2, 4).sum(-1)  # [b, h, t, 2]
    gate_a, gate_b = torch.sigmoid(proj).split(1, dim=-1)  # each [b, h, t, 1]
    const = layer["gru_rel_pos_const"].float()  # [1, h, 1, 1]
    gate = gate_a * (gate_b * const - 1.0) + 2.0
    gated_bias = gate * position_bias[None].float()  # [b, h, t, t]

    attn = layer["attn"]
    q = nn.dense(attn["q"], x).reshape(b, t, h, hd)
    k = nn.dense(attn["k"], x).reshape(b, t, h, hd)
    v = nn.dense(attn["v"], x).reshape(b, t, h, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd) + gated_bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return nn.dense(attn["o"], out.to(x.dtype).reshape(b, t, d))


def wavlm_encode(params: dict, cfg: WavLMConfig, waveform: torch.Tensor,
                 normalize_input: bool = True) -> torch.Tensor:
    """[b, samples] → [b, hidden]: the stable-LN stack with gated relative
    attention, the mean of the last k layers, then the time mean."""
    hcfg = cfg.as_hubert()
    if normalize_input:
        waveform = hubert.normalize(waveform)
    eps = cfg.layer_norm_eps
    x = _conv_frontend(params, hcfg, waveform)
    x = nn.layernorm(params["feat_proj_ln"], x, eps)
    x = nn.dense(params["feat_proj"], x)
    x = x + _pos_conv(params, hcfg, x)

    t = x.shape[1]
    buckets = torch.from_numpy(relative_position_buckets(t, t, cfg.num_buckets,
                                                         cfg.max_distance)).to(x.device)
    position_bias = nn.embedding(params["rel_attn_embed"], buckets).permute(2, 0, 1)  # [h, t, t]

    k, n = cfg.mean_last_k_layers, cfg.num_layers
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        h = nn.layernorm(layer["attn_ln"], x, eps)
        x = x + _wavlm_attention(layer, cfg, h, position_bias)
        h = nn.layernorm(layer["ffn_ln"], x, eps)
        x = x + nn.dense(layer["ffn_out"], nn.gelu(nn.dense(layer["ffn_in"], h)))
        out = x if i < n - 1 else nn.layernorm(params["final_ln"], x, eps)
        if i >= n - k:
            acc = acc + out.float()
    return (acc / k).mean(dim=1).to(x.dtype)


def wavlm_encode_clips(params: dict, cfg: WavLMConfig, clips: torch.Tensor) -> torch.Tensor:
    """[b, n_clips, 1, samples] → [b, n_clips, hidden], one batched pass."""
    b, t, _, s = clips.shape
    return wavlm_encode(params, cfg, clips[:, :, 0, :].reshape(b * t, s)).reshape(b, t, -1)


# ---------------------------------------------------------------------------
# data2vec-audio


@dataclass(frozen=True)
class Data2VecAudioConfig:
    conv_dim: Tuple[int, ...] = (512,) * 7
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_pos_conv_layers: int = 5
    pos_conv_kernel: int = 19
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    mean_last_k_layers: int = 4

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
                   hidden_size=16, num_layers=3, num_heads=2, intermediate_size=32,
                   num_pos_conv_layers=2, pos_conv_kernel=5, pos_conv_groups=2,
                   mean_last_k_layers=2)

    def as_hubert(self) -> HubertConfig:
        return HubertConfig(
            conv_dim=self.conv_dim, conv_kernel=self.conv_kernel,
            conv_stride=self.conv_stride, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            intermediate_size=self.intermediate_size,
            layer_norm_eps=self.layer_norm_eps,
            mean_last_k_layers=self.mean_last_k_layers,
        )


def init_data2vec_params(generator: torch.Generator, cfg: Data2VecAudioConfig,
                         dtype=torch.bfloat16) -> dict:
    """Random data2vec-audio weights on the generator's device: HuBERT's tree
    with the stacked positional convolutions in place of the one, and the
    encoder's LayerNorm (JAX's tree and scales; the values differ from
    JAX's for the same seed)."""
    base = hubert.init_params(generator, cfg.as_hubert(), dtype=dtype)
    del base["pos_conv"]
    h, dev = cfg.hidden_size, generator.device
    base["pos_convs"] = [{
        "w": nn.normal(generator, (h, h // cfg.pos_conv_groups, cfg.pos_conv_kernel), 0.02,
                       dtype),
        "b": torch.zeros((h,), dtype=dtype, device=dev),
    } for _ in range(cfg.num_pos_conv_layers)]
    base["encoder_ln"] = nn.layernorm_init(h, dtype=dtype, device=dev)
    return base


def _d2v_pos_conv(params: dict, cfg: Data2VecAudioConfig, x: torch.Tensor) -> torch.Tensor:
    """The stacked grouped convolutions, each followed by a non-affine
    LayerNorm over channels (f32) and gelu (HF
    Data2VecAudioPositionalConvLayer)."""
    h = x.transpose(1, 2)  # [b, c, t]
    for conv in params["pos_convs"]:
        h = F.conv1d(h, conv["w"].to(h.dtype), padding=cfg.pos_conv_kernel // 2,
                     groups=cfg.pos_conv_groups) + conv["b"][None, :, None].to(h.dtype)
        if cfg.pos_conv_kernel % 2 == 0:
            h = h[:, :, :-1]
        ht = h.transpose(1, 2).float()
        mean = ht.mean(-1, keepdim=True)
        var = ht.var(-1, keepdim=True, unbiased=False)
        ht = (ht - mean) * torch.rsqrt(var + cfg.layer_norm_eps)
        h = nn.gelu(ht).to(h.dtype).transpose(1, 2)
    return h.transpose(1, 2)


def data2vec_encode(params: dict, cfg: Data2VecAudioConfig, waveform: torch.Tensor,
                    normalize_input: bool = True) -> torch.Tensor:
    """[b, samples] → [b, hidden]: the post-LN wav2vec2-style stack (a
    LayerNorm after the positional convolutions' sum, residual-then-LN
    blocks), the mean of the last k layers, then the time mean."""
    hcfg = cfg.as_hubert()
    if normalize_input:
        waveform = hubert.normalize(waveform)
    eps = cfg.layer_norm_eps
    x = _conv_frontend(params, hcfg, waveform)
    x = nn.layernorm(params["feat_proj_ln"], x, eps)
    x = nn.dense(params["feat_proj"], x)
    x = x + _d2v_pos_conv(params, cfg, x)
    x = nn.layernorm(params["encoder_ln"], x, eps)

    k = cfg.mean_last_k_layers
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i, layer in enumerate(params["layers"]):
        x = nn.layernorm(layer["attn_ln"], x + nn.mha(layer["attn"], x, x, cfg.num_heads), eps)
        ffn = nn.dense(layer["ffn_out"], nn.gelu(nn.dense(layer["ffn_in"], x)))
        x = nn.layernorm(layer["ffn_ln"], x + ffn, eps)
        if i >= cfg.num_layers - k:
            acc = acc + x.float()
    return (acc / k).mean(dim=1).to(x.dtype)


def data2vec_encode_clips(params: dict, cfg: Data2VecAudioConfig,
                          clips: torch.Tensor) -> torch.Tensor:
    """[b, n_clips, 1, samples] → [b, n_clips, hidden], one batched pass."""
    b, t, _, s = clips.shape
    return data2vec_encode(params, cfg, clips[:, :, 0, :].reshape(b * t, s)).reshape(b, t, -1)
