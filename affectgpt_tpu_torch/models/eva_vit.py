"""EVA ViT-g/14 visual tower and its BLIP2 Q-Former head, in PyTorch.

Port of affectgpt_tpu/models/eva_vit.py (reference:
my_affectgpt/models/eva_vit.py:245-407 VisionTransformer / create_eva_vit_g;
encoder.py:43-122 EVA_CLIP_G, the BLIP2 Q-Former's [b, t, 32, 768];
:123-176 EVA_CLIP_G_NO_QFORMER, the mean over all 257 tokens → [b, t,
1408]).

Geometry (create_eva_vit_g, eva_vit.py:389-402): patch 14, width 1408, 39
blocks, 16 heads, MLP 6144, absolute position embeddings, no final
LayerNorm (BLIP2's ln_vision follows). EVA's attention packs q, k and v in
one weight with q and v biases and a k bias fixed at zero; it stays a plain
chain (f32 scores, p rounded to v's dtype, f32 PV), as in JAX, which never
routes it to the fused kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from affectgpt_tpu_torch.models import nn, qformer
from affectgpt_tpu_torch.models.clip_vit import patchify


@dataclass(frozen=True)
class EvaVitConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1408
    num_layers: int = 39
    num_heads: int = 16
    mlp_dim: int = 6144
    layer_norm_eps: float = 1e-6

    @classmethod
    def vit_g_14(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(image_size=28, patch_size=14, width=16, num_layers=2,
                   num_heads=2, mlp_dim=32)


def init_params(generator: torch.Generator, cfg: EvaVitConfig, dtype=torch.bfloat16) -> dict:
    """Random EVA weights on the generator's device (JAX's tree and scales;
    the values differ from JAX's for the same seed)."""
    dev = generator.device
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    w = cfg.width
    blocks = [{
        "ln1": nn.layernorm_init(w, dtype=dtype, device=dev),
        "qkv_w": nn.normal(generator, (w, 3 * w), 0.02, dtype),
        "q_bias": torch.zeros((w,), dtype=dtype, device=dev),
        "v_bias": torch.zeros((w,), dtype=dtype, device=dev),
        "proj": nn.dense_init(generator, w, w, dtype=dtype),
        "ln2": nn.layernorm_init(w, dtype=dtype, device=dev),
        "mlp_in": nn.dense_init(generator, w, cfg.mlp_dim, dtype=dtype),
        "mlp_out": nn.dense_init(generator, cfg.mlp_dim, w, dtype=dtype),
    } for _ in range(cfg.num_layers)]
    return {
        "patch_embed": nn.dense_init(generator, cfg.patch_size ** 2 * 3, w, dtype=dtype),
        "cls_token": torch.zeros((w,), dtype=dtype, device=dev),
        "pos_embed": nn.embedding_init(generator, n_patches + 1, w, dtype=dtype),
        "blocks": blocks,
    }


def _eva_attention(block: dict, cfg: EvaVitConfig, x: torch.Tensor) -> torch.Tensor:
    b, t, d = x.shape
    h = cfg.num_heads
    hd = d // h
    bias = torch.cat([block["q_bias"], torch.zeros_like(block["q_bias"]), block["v_bias"]])
    qkv = (nn.matmul_f32(x, block["qkv_w"]) + bias.float()).to(x.dtype)
    q, k, v = (part.reshape(b, t, h, hd) for part in qkv.split(d, dim=-1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(hd)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return nn.dense(block["proj"], out.to(x.dtype).reshape(b, t, d))


def encode_tokens(params: dict, cfg: EvaVitConfig, images: torch.Tensor) -> torch.Tensor:
    """[b, H, W, 3] → [b, 1 + n_patches, width]: the raw token states (no
    final LN, as use_mean_pooling=False)."""
    b = images.shape[0]
    x = nn.dense(params["patch_embed"],
                 patchify(images.to(params["cls_token"].dtype), cfg.patch_size))
    cls = params["cls_token"].to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"]["table"][None, : x.shape[1]].to(x.dtype)
    eps = cfg.layer_norm_eps
    for blk in params["blocks"]:
        x = x + _eva_attention(blk, cfg, nn.layernorm(blk["ln1"], x, eps))
        x = x + nn.dense(blk["mlp_out"], nn.gelu(nn.dense(blk["mlp_in"],
                                                          nn.layernorm(blk["ln2"], x, eps))))
    return x


def encode_mean(params: dict, cfg: EvaVitConfig, images: torch.Tensor) -> torch.Tensor:
    """EVA_CLIP_G_NO_QFORMER's pooling: the mean over all 257 tokens → [b,
    1408] (reference encoder.py:123-176)."""
    return encode_tokens(params, cfg, images).mean(dim=1)


def init_blip2_head(generator: torch.Generator, cfg: EvaVitConfig, num_query_tokens: int = 32,
                    dtype=torch.bfloat16) -> dict:
    """BLIP2's ln_vision and 12-layer Q-Former over the patch tokens → 32 x
    768 (reference encoder.py:43-122 EVA_CLIP_G)."""
    qcfg = qformer.QFormerConfig.blip2(num_query_tokens, cfg.width)
    return {
        "ln_vision": nn.layernorm_init(cfg.width, dtype=dtype, device=generator.device),
        "qformer": qformer.init_params(generator, qcfg, dtype=dtype),
    }


def encode_blip2(params: dict, head: dict, cfg: EvaVitConfig, images: torch.Tensor,
                 num_query_tokens: int = 32) -> torch.Tensor:
    """[b, H, W, 3] → [b, num_query_tokens, 768]."""
    tokens = nn.layernorm(head["ln_vision"], encode_tokens(params, cfg, images))
    qcfg = qformer.QFormerConfig.blip2(num_query_tokens, cfg.width)
    return qformer.apply(head["qformer"], qcfg, tokens)


def convert_eva_state(state: dict, dtype=torch.float32, device="cuda") -> dict:
    """An EVA checkpoint's state dict (torch tensors or numpy arrays with
    eva_vit.py's names) → this layout, each tensor cast to `dtype` on
    `device` (the patch convolution [O, C, kH, kW] becomes the dense
    [C·kH·kW, O])."""
    from affectgpt_tpu_torch.models.convert import _count, _patch_dense, _Put

    put = _Put(state, device, dtype)
    blocks = []
    for i in range(_count(state, "blocks.{}.norm1.weight")):
        p = f"blocks.{i}"
        blocks.append({
            "ln1": put.ln(f"{p}.norm1"),
            "qkv_w": put(f"{p}.attn.qkv.weight", transpose=True),
            "q_bias": put(f"{p}.attn.q_bias"),
            "v_bias": put(f"{p}.attn.v_bias"),
            "proj": put.dense(f"{p}.attn.proj"),
            "ln2": put.ln(f"{p}.norm2"),
            "mlp_in": put.dense(f"{p}.mlp.fc1"),
            "mlp_out": put.dense(f"{p}.mlp.fc2"),
        })
    return {
        "patch_embed": _patch_dense(put, "patch_embed.proj"),
        "cls_token": put("cls_token").reshape(-1),
        "pos_embed": {"table": put("pos_embed")[0]},
        "blocks": blocks,
    }
