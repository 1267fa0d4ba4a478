"""DINOv2 and SigLIP visual towers, in PyTorch.

Port of affectgpt_tpu/models/vit_variants.py: registry alternates to the
CLIP tower (reference: my_affectgpt/models/encoder.py:212-249 DINO2_LARGE,
the mean of the last hidden state over the CLS and patch tokens → [b, t,
1024]; :249-281 SigLIP_SO, the same pooling → [b, t, 1152]).

- DINOv2: pre-LN ViT with a LayerScale on each residual branch, a CLS
  token, position embeddings resized to the image's patch grid when they
  differ (`_interpolate_pos`), an erf-gelu MLP.
- SigLIP: pre-LN ViT without a CLS token, a tanh-gelu MLP, learned position
  embeddings; the reference pools the hidden states itself, so the
  attention-pool head is not needed.

Their attention is `nn.mha`, which sends these towers' unmasked
self-attention (DINOv2-large at 518 px: 1370 tokens at head_dim 64; SigLIP
so400m: 729 tokens at head_dim 72) to the fused kernel (ops/vit_attention.py)
unless nn.FUSED_MHA is "0". The MLPs are plain products, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from affectgpt_tpu_torch.models import nn
from affectgpt_tpu_torch.models.clip_vit import patchify
from affectgpt_tpu_torch.ops import image


@dataclass(frozen=True)
class Dinov2Config:
    image_size: int = 224  # the position grid's image size (518 for the released weights)
    patch_size: int = 14
    width: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    layer_norm_eps: float = 1e-6

    @classmethod
    def large(cls, image_size: int = 518):
        return cls(image_size=image_size)

    @classmethod
    def tiny(cls):
        return cls(image_size=28, patch_size=14, width=16, num_layers=2,
                   num_heads=2, mlp_dim=32)


def _init_blocks(generator, cfg, layer_scale: bool, dtype) -> list:
    dev = generator.device
    blocks = []
    for _ in range(cfg.num_layers):
        block = {
            "ln1": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
            "attn": nn.mha_init(generator, cfg.width, cfg.width, cfg.num_heads, dtype=dtype),
            "ln2": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
            "mlp_in": nn.dense_init(generator, cfg.width, cfg.mlp_dim, dtype=dtype),
            "mlp_out": nn.dense_init(generator, cfg.mlp_dim, cfg.width, dtype=dtype),
        }
        if layer_scale:  # LayerScale lambdas
            block["ls1"] = torch.ones((cfg.width,), dtype=dtype, device=dev)
            block["ls2"] = torch.ones((cfg.width,), dtype=dtype, device=dev)
        blocks.append(block)
    return blocks


def init_dinov2_params(generator: torch.Generator, cfg: Dinov2Config,
                       dtype=torch.bfloat16) -> dict:
    """Random DINOv2 weights on the generator's device (JAX's tree and
    scales; the values differ from JAX's for the same seed)."""
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    return {
        "patch_embed": nn.dense_init(generator, cfg.patch_size ** 2 * 3, cfg.width, dtype=dtype),
        "cls_token": nn.normal(generator, (cfg.width,), 0.02, dtype),
        "pos_embed": nn.embedding_init(generator, n_patches + 1, cfg.width, dtype=dtype),
        "blocks": _init_blocks(generator, cfg, True, dtype),
        "final_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=generator.device),
    }


def _interpolate_pos(pos: torch.Tensor, n_patches_target: int) -> torch.Tensor:
    """The patch rows of the position table resized from their square grid to
    the target's (jax.image.resize bicubic in f32: ops.image.resize), the CLS
    row kept."""
    cls_pos, patch_pos = pos[:1], pos[1:]
    src = int(patch_pos.shape[0] ** 0.5)
    dst = int(n_patches_target ** 0.5)
    grid = image.resize(patch_pos.reshape(src, src, -1).float(), (dst, dst))
    return torch.cat([cls_pos, grid.reshape(dst * dst, -1).to(pos.dtype)])


def dinov2_encode(params: dict, cfg: Dinov2Config, images: torch.Tensor) -> torch.Tensor:
    """[b, H, W, 3] (ImageNet-normalized) → [b, width]: the mean of the final
    hidden states over all tokens (the reference's pooling,
    encoder.py:240-242)."""
    b = images.shape[0]
    x = nn.dense(params["patch_embed"],
                 patchify(images.to(params["cls_token"].dtype), cfg.patch_size))
    cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    pos = params["pos_embed"]["table"]
    if pos.shape[0] != x.shape[1]:
        pos = _interpolate_pos(pos, x.shape[1] - 1)
    x = x + pos[None].to(x.dtype)
    eps = cfg.layer_norm_eps
    for blk in params["blocks"]:
        h = nn.layernorm(blk["ln1"], x, eps)
        x = x + nn.mha(blk["attn"], h, h, cfg.num_heads) * blk["ls1"].to(x.dtype)
        h = nn.dense(blk["mlp_out"], nn.gelu(nn.dense(blk["mlp_in"],
                                                      nn.layernorm(blk["ln2"], x, eps))))
        x = x + h * blk["ls2"].to(x.dtype)
    return nn.layernorm(params["final_ln"], x, eps).mean(dim=1)


@dataclass(frozen=True)
class SiglipConfig:
    image_size: int = 384
    patch_size: int = 14
    width: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    mlp_dim: int = 4304
    layer_norm_eps: float = 1e-6

    @classmethod
    def so400m(cls):
        """siglip-so400m-patch14-384, the reference's SigLIP_SO
        (encoder.py:249: hidden 1152)."""
        return cls()

    @classmethod
    def tiny(cls):
        return cls(image_size=32, patch_size=16, width=16, num_layers=2,
                   num_heads=2, mlp_dim=32)


def init_siglip_params(generator: torch.Generator, cfg: SiglipConfig,
                       dtype=torch.bfloat16) -> dict:
    """Random SigLIP weights on the generator's device (JAX's tree and
    scales; the values differ from JAX's for the same seed)."""
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    return {
        "patch_embed": nn.dense_init(generator, cfg.patch_size ** 2 * 3, cfg.width, dtype=dtype),
        "pos_embed": nn.embedding_init(generator, n_patches, cfg.width, dtype=dtype),
        "blocks": _init_blocks(generator, cfg, False, dtype),
        "post_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=generator.device),
    }


def siglip_encode(params: dict, cfg: SiglipConfig, images: torch.Tensor) -> torch.Tensor:
    """[b, H, W, 3] → [b, width]: the mean over the final hidden states
    (reference pooling at encoder.py:275-277)."""
    x = nn.dense(params["patch_embed"],
                 patchify(images.to(params["pos_embed"]["table"].dtype), cfg.patch_size))
    x = x + params["pos_embed"]["table"][None, : x.shape[1]].to(x.dtype)
    eps = cfg.layer_norm_eps
    for blk in params["blocks"]:
        h = nn.layernorm(blk["ln1"], x, eps)
        x = x + nn.mha(blk["attn"], h, h, cfg.num_heads)
        h = nn.layernorm(blk["ln2"], x, eps)
        x = x + nn.dense(blk["mlp_out"],
                         F.gelu(nn.dense(blk["mlp_in"], h), approximate="tanh"))
    return nn.layernorm(params["post_ln"], x, eps).mean(dim=1)
