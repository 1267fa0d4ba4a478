"""ImageBind's audio tower (a ViT over log-mel spectrograms), in PyTorch.

Port of affectgpt_tpu/models/imagebind_audio.py (reference:
my_affectgpt/models/encoder.py:285-310 IMAGEBIND;
ImageBind/models/imagebind_model.py:477-511 get_audio_feature, :137-207 the
audio stem, :514-541 imagebind_huge → 1024).

Geometry (imagebind_huge's audio branch): normalized log-mel clips [B, S, 1,
128, 204] (ops/audio.transform_audio) → overlapping Conv2d patches (k = 16,
s = 10 → 12 x 19 = 228 tokens) + LayerNorm → a CLS token and learned
position embeddings → 12 pre-LN blocks (width 768, 12 heads, MLP 3072) →
the head's LayerNorm on the CLS token → 768 → 1024 without bias → L2
normalized x logit scale 20. The blocks' attention is `nn.mha`, whose 229
tokens go to the fused kernel (ops/vit_attention.py) unless nn.FUSED_MHA is
"0".
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from affectgpt_tpu_torch.models import nn


@dataclass(frozen=True)
class ImageBindAudioConfig:
    num_mel_bins: int = 128
    target_len: int = 204
    kernel_size: int = 16
    stride: int = 10
    width: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    out_embed_dim: int = 1024
    logit_scale: float = 20.0
    layer_norm_eps: float = 1e-6

    @property
    def patch_grid(self):
        h = (self.num_mel_bins - self.kernel_size) // self.stride + 1
        w = (self.target_len - self.kernel_size) // self.stride + 1
        return h, w

    @classmethod
    def huge(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(num_mel_bins=32, target_len=48, kernel_size=16, stride=10,
                   width=16, num_layers=2, num_heads=2, mlp_dim=32, out_embed_dim=12)


def init_params(generator: torch.Generator, cfg: ImageBindAudioConfig,
                dtype=torch.bfloat16) -> dict:
    """Random audio-tower weights on the generator's device (JAX's tree and
    scales; the values differ from JAX's for the same seed)."""
    dev = generator.device
    h, w = cfg.patch_grid
    blocks = [{
        "ln1": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
        "attn": nn.mha_init(generator, cfg.width, cfg.width, cfg.num_heads, dtype=dtype),
        "ln2": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
        "mlp_in": nn.dense_init(generator, cfg.width, cfg.mlp_dim, dtype=dtype),
        "mlp_out": nn.dense_init(generator, cfg.mlp_dim, cfg.width, dtype=dtype),
    } for _ in range(cfg.num_layers)]
    k = cfg.kernel_size
    return {
        "stem_conv": {"w": nn.normal(generator, (cfg.width, 1, k, k), 0.02, dtype)},  # OIHW
        "stem_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
        "cls_token": torch.zeros((cfg.width,), dtype=dtype, device=dev),
        "pos_embed": nn.embedding_init(generator, h * w + 1, cfg.width, dtype=dtype),
        "blocks": blocks,
        "head_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
        "head_proj": nn.dense_nobias_init(generator, cfg.width, cfg.out_embed_dim, dtype=dtype),
    }


def encode_mels(params: dict, cfg: ImageBindAudioConfig, mels: torch.Tensor) -> torch.Tensor:
    """[b, 1, mel_bins, target_len] normalized log-mels → [b, out_embed_dim]
    in the weights' dtype."""
    dtype = params["cls_token"].dtype
    x = F.conv2d(mels.to(dtype), params["stem_conv"]["w"].to(dtype), stride=cfg.stride)
    b, d = x.shape[:2]
    x = x.reshape(b, d, -1).transpose(1, 2)  # [b, tokens, width]
    eps = cfg.layer_norm_eps
    x = nn.layernorm(params["stem_ln"], x, eps)
    x = torch.cat([params["cls_token"].to(x.dtype).expand(b, 1, d), x], dim=1)
    x = x + params["pos_embed"]["table"][None, : x.shape[1]].to(x.dtype)
    for blk in params["blocks"]:
        h = nn.layernorm(blk["ln1"], x, eps)
        x = x + nn.mha(blk["attn"], h, h, cfg.num_heads)
        h = nn.layernorm(blk["ln2"], x, eps)
        x = x + nn.dense(blk["mlp_out"], nn.gelu(nn.dense(blk["mlp_in"], h)))
    pooled = nn.layernorm(params["head_ln"], x[:, 0], eps)
    proj = nn.dense_nobias(params["head_proj"], pooled).float()
    proj = proj / proj.norm(dim=-1, keepdim=True).clamp(min=1e-8)
    return (proj * cfg.logit_scale).to(pooled.dtype)


def encode_clips(params: dict, cfg: ImageBindAudioConfig, mel_clips: torch.Tensor) -> torch.Tensor:
    """[b, clips, 1, mel, frames] (the reference's audio tensor layout) →
    [b, clips, out_embed_dim]."""
    b, s = mel_clips.shape[:2]
    return encode_mels(params, cfg, mel_clips.reshape(b * s, *mel_clips.shape[2:])).reshape(
        b, s, -1)


def convert_imagebind_audio(state: dict, dtype=torch.float32, device="cuda") -> dict:
    """An imagebind_huge checkpoint's state dict (torch tensors or numpy
    arrays with the reference's names) → this layout (the audio branch),
    each tensor cast to `dtype` on `device`."""
    from affectgpt_tpu_torch.models.convert import _count, _Put

    put = _Put(state, device, dtype)
    pre, trunk = "modality_preprocessors.audio", "modality_trunks.audio"
    blocks = []
    for i in range(_count(state, trunk + ".blocks.{}.norm_1.weight")):
        p = f"{trunk}.blocks.{i}"
        in_w = put(f"{p}.attn.in_proj_weight")  # [3d, d]: q, k, v
        in_b = put(f"{p}.attn.in_proj_bias")
        d = in_w.shape[1]
        blocks.append({
            "ln1": put.ln(f"{p}.norm_1"),
            "attn": {
                **{name: {"w": in_w[j * d:(j + 1) * d].t().contiguous(),
                          "b": in_b[j * d:(j + 1) * d].contiguous()}
                   for j, name in enumerate(("q", "k", "v"))},
                "o": put.dense(f"{p}.attn.out_proj"),
            },
            "ln2": put.ln(f"{p}.norm_2"),
            "mlp_in": put.dense(f"{p}.mlp.fc1"),
            "mlp_out": put.dense(f"{p}.mlp.fc2"),
        })
    return {
        "stem_conv": {"w": put(f"{pre}.audio_stem.proj.0.weight")},
        "stem_ln": put.ln(f"{pre}.audio_stem.norm_layer"),
        "cls_token": put(f"{pre}.cls_token").reshape(-1),
        "pos_embed": {"table": put(f"{pre}.pos_embedding_helper.pos_embed")[0]},
        "blocks": blocks,
        "head_ln": put.ln("modality_heads.audio.0"),
        "head_proj": {"w": put("modality_heads.audio.2.weight", transpose=True)},
    }
