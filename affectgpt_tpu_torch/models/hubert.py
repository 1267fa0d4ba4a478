"""HuBERT-large acoustic encoder, in PyTorch.

Port of affectgpt_tpu/models/hubert.py: raw 16 kHz clips → conv feature
extractor → transformer → mean of the last 4 hidden layers → time mean, one
1024-d vector per 2 s clip ([b, 8, 1024]). Geometry of hubert-large
(feat_extract_norm="layer", do_stable_layer_norm=True): 7 conv1d stages
(512 channels, kernels 10/3/3/3/3/2/2, strides 5/2/2/2/2/2/2) each with a
channel LayerNorm and gelu; feature projection LN + dense → 1024; grouped
conv positional embedding (k = 128, 16 groups); 24 pre-LN layers (16
heads, FFN 4096); final LayerNorm. The convolutions are F.conv1d, as JAX
computes them outside any Pallas kernel; the last-4 mean accumulates online
in f32.

Routes of a layer, JAX's switches with JAX's defaults ("auto" is the plain
chain for both): ATTN_IMPL "sublayer" runs the attention-sublayer kernel
(ops/vit_sublayer.py); MLP_IMPL "pallas" the two-call MLP kernel pair
(ops/vit_mlp.py) and "fused" the one-call kernel (ops/vit_mlp_fused.py),
both with the erf gelu. A kernel route needs bf16 `"w"` leaves (JAX's
layout rule): a tower with the int8 `w_q` leaves of
`ops.quant.quantize_encoder_tree` runs the plain stack, its dense layers in
`ops.quant.dense_w8a8_xla`. JAX's TPU gates (backend, head_dim % 64) are
dropped, and the token axis is not padded to a multiple of 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from affectgpt_tpu_torch.models import nn
from affectgpt_tpu_torch.ops import vit_mlp, vit_mlp_fused, vit_sublayer

ATTN_IMPL = "auto"  # "auto" (plain) | "sublayer" | "xla"
MLP_IMPL = "auto"  # "auto" (plain) | "pallas" | "fused" | "xla"
# clips per pass of the conv frontend when the batch is larger (JAX's
# HUBERT_CONV_CHUNK default): bounds the first conv's [b, 512, samples / 5]
# activation; the result is the unchunked one
CONV_CHUNK = 256


@dataclass(frozen=True)
class HubertConfig:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    layer_norm_eps: float = 1e-5
    mean_last_k_layers: int = 4  # reference layer_ids = [-4, -3, -2, -1]

    @classmethod
    def large(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(
            conv_dim=(8, 8), conv_kernel=(10, 3), conv_stride=(5, 2),
            hidden_size=16, num_layers=3, num_heads=2, intermediate_size=32,
            pos_conv_kernel=8, pos_conv_groups=2, mean_last_k_layers=2,
        )


def init_params(generator: torch.Generator, cfg: HubertConfig, dtype=torch.bfloat16) -> dict:
    """Random HuBERT weights on the generator's device (JAX's tree and
    scales: conv kernels [out, in, k] like torch's Conv1d)."""
    dev = generator.device
    convs, in_ch = [], 1
    for out_ch, k in zip(cfg.conv_dim, cfg.conv_kernel):
        convs.append({
            "w": nn.normal(generator, (out_ch, in_ch, k), (in_ch * k) ** -0.5, dtype),
            "b": torch.zeros((out_ch,), dtype=dtype, device=dev),
            "ln": nn.layernorm_init(out_ch, dtype=dtype, device=dev),
        })
        in_ch = out_ch
    h = cfg.hidden_size
    layers = [{
        "attn_ln": nn.layernorm_init(h, dtype=dtype, device=dev),
        "attn": nn.mha_init(generator, h, h, cfg.num_heads, dtype=dtype),
        "ffn_ln": nn.layernorm_init(h, dtype=dtype, device=dev),
        "ffn_in": nn.dense_init(generator, h, cfg.intermediate_size, dtype=dtype),
        "ffn_out": nn.dense_init(generator, cfg.intermediate_size, h, dtype=dtype),
    } for _ in range(cfg.num_layers)]
    return {
        "convs": convs,
        "feat_proj_ln": nn.layernorm_init(cfg.conv_dim[-1], dtype=dtype, device=dev),
        "feat_proj": nn.dense_init(generator, cfg.conv_dim[-1], h, dtype=dtype),
        "pos_conv": {
            "w": nn.normal(generator, (h, h // cfg.pos_conv_groups, cfg.pos_conv_kernel), 0.02,
                           dtype),
            "b": torch.zeros((h,), dtype=dtype, device=dev),
        },
        "layers": layers,
        "final_ln": nn.layernorm_init(h, dtype=dtype, device=dev),
    }


def _conv_frontend(params: dict, cfg: HubertConfig, waveform: torch.Tensor) -> torch.Tensor:
    """[b, samples] → [b, frames, conv_dim[-1]], over groups of CONV_CHUNK
    clips (the largest divisor of b not above it) when b is larger."""
    b = waveform.shape[0]
    if CONV_CHUNK and b > CONV_CHUNK:
        chunk = CONV_CHUNK
        while b % chunk:
            chunk -= 1
        if chunk > 1:
            return torch.cat([_conv_stack(params, cfg, waveform[i:i + chunk])
                              for i in range(0, b, chunk)])
    return _conv_stack(params, cfg, waveform)


def _conv_stack(params: dict, cfg: HubertConfig, waveform: torch.Tensor) -> torch.Tensor:
    x = waveform[:, None, :].to(params["convs"][0]["w"].dtype)  # [b, 1, s]
    for i, conv in enumerate(params["convs"]):
        x = F.conv1d(x, conv["w"], stride=cfg.conv_stride[i]) + conv["b"][None, :, None]
        # channel LayerNorm (feat_extract_norm="layer") over [b, t, c] rows, made
        # contiguous: on the CPU an elementwise op over a transposed view rounds
        # some elements differently, and the chunked result would differ
        h = nn.layernorm(conv["ln"], x.transpose(1, 2).contiguous(), cfg.layer_norm_eps)
        x = nn.gelu(h).transpose(1, 2)
    return x.transpose(1, 2)  # [b, t, c]


def _pos_conv(params: dict, cfg: HubertConfig, x: torch.Tensor) -> torch.Tensor:
    """Grouped conv positional embedding, padding k / 2 on both sides and
    the trailing sample trimmed for an even k (wav2vec2's layout)."""
    h = x.transpose(1, 2)  # [b, c, t]
    h = F.conv1d(h, params["pos_conv"]["w"].to(h.dtype), padding=cfg.pos_conv_kernel // 2,
                 groups=cfg.pos_conv_groups)
    h = h + params["pos_conv"]["b"][None, :, None].to(h.dtype)
    if cfg.pos_conv_kernel % 2 == 0:
        h = h[:, :, :-1]
    return nn.gelu(h).transpose(1, 2)


def normalize(waveform: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit variance per clip (Wav2Vec2FeatureExtractor
    do_normalize)."""
    mean = waveform.mean(-1, keepdim=True)
    var = waveform.var(-1, keepdim=True, unbiased=False)
    return (waveform - mean) / torch.sqrt(var + 1e-7)


def encode(params: dict, cfg: HubertConfig, waveform: torch.Tensor,
           normalize_input: bool = True) -> torch.Tensor:
    """[b, samples] raw audio → [b, hidden]: the mean of the last k layers'
    hidden states, then the time mean (the reference's pooling,
    encoder.py:424-429)."""
    if normalize_input:
        waveform = normalize(waveform)
    x = _conv_frontend(params, cfg, waveform)
    x = nn.layernorm(params["feat_proj_ln"], x, cfg.layer_norm_eps)
    x = nn.dense(params["feat_proj"], x)
    x = x + _pos_conv(params, cfg, x)

    k = cfg.mean_last_k_layers
    t_valid = x.shape[1]
    use_sublayer = ATTN_IMPL == "sublayer" and "w" in params["layers"][0]["attn"]["q"]
    use_mlp_kernel = MLP_IMPL in ("pallas", "fused") and "w" in params["layers"][0]["ffn_in"]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    eps = cfg.layer_norm_eps
    for i, layer in enumerate(params["layers"]):
        if use_sublayer:
            x = vit_sublayer.apply({"ln1": layer["attn_ln"], "attn": layer["attn"]}, x,
                                   cfg.num_heads, t_valid, eps)
        else:
            h = nn.layernorm(layer["attn_ln"], x, eps)
            x = x + nn.mha(layer["attn"], h, h, cfg.num_heads)
        if use_mlp_kernel:
            mlp = vit_mlp_fused if MLP_IMPL == "fused" else vit_mlp
            x = mlp.apply_hubert(layer, x, eps)
        else:
            h = nn.layernorm(layer["ffn_ln"], x, eps)
            x = x + nn.dense(layer["ffn_out"], nn.gelu(nn.dense(layer["ffn_in"], h)))
        # hidden_states[i + 1] in HF terms; the final LN applies to the last
        out = x if i < cfg.num_layers - 1 else nn.layernorm(params["final_ln"], x, eps)
        if i >= cfg.num_layers - k:
            acc = acc + out.float()
    return (acc / k).mean(dim=1).to(x.dtype)


def encode_clips(params: dict, cfg: HubertConfig, clips: torch.Tensor) -> torch.Tensor:
    """[b, n_clips, 1, samples] → [b, n_clips, hidden], one batched pass."""
    b, t, _, s = clips.shape
    return encode(params, cfg, clips[:, :, 0, :].reshape(b * t, s)).reshape(b, t, -1)
