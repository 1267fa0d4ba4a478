"""CLIP vision tower (ViT-L/14) and text tower (ViT-B/32), in PyTorch.

Port of affectgpt_tpu/models/clip_vit.py. The vision tower
(`ClipVisionConfig`, `init_vision_params`, `patchify`, `quick_gelu`,
`encode_image`) gives the raw-frame features of the realtime path, matching
HF CLIPModel.get_image_features (embeddings → pre-LN stack → post-LN on CLS
→ visual projection → [b, 768]). The patch embedding is an unfold + dense
[P²·3 → width], as in JAX. The text tower (`ClipTextConfig`,
`init_text_params`, `encode_text`) encodes AU descriptions: causal blocks,
pooled at the EOT token (the highest id), projected to [b, 512].

Routes of a block, JAX's switches with JAX's defaults; on the port "the
TPU" of JAX's rule reads "always", and each kernel wrapper takes its plain
version for CPU tensors:

- ATTN_IMPL "auto" / "sublayer": the attention-sublayer kernel
  (ops/vit_sublayer.py); "flash": the projections as dense layers and the
  fused attention kernel (ops/vit_attention.mha_fused); "xla": the plain
  chain (nn.mha, which sends unmasked self-attention of ≥ 192 tokens to the
  fused kernel unless nn.FUSED_MHA is "0").
- MLP_IMPL, read only on the sublayer route: "auto", the two-call MLP
  kernel pair (ops/vit_mlp.py); "fused", the one-call kernel
  (ops/vit_mlp_fused.py); "xla", the plain chain.

A block without a bf16 `"w"` leaf in its q projection (the int8 `w_q`
leaves of `ops.quant.quantize_encoder_tree`) leaves the sublayer route for
"flash" (JAX's layout rule), and so does a masked block: the text tower's
causal blocks then take the plain chain, as on the TPU. The kernels take any
token count, so the token axis is not padded (JAX pads 257 to 264, a TPU
sublane layout).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from affectgpt_tpu_torch.models import nn
from affectgpt_tpu_torch.ops import vit_attention, vit_mlp, vit_mlp_fused, vit_sublayer

ATTN_IMPL = "auto"  # "auto" | "sublayer" | "flash" | "xla"
MLP_IMPL = "auto"  # "auto" | "fused" | "xla"


@dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def vit_l_14(cls):
        """openai/clip-vit-large-patch14 vision geometry."""
        return cls()

    @classmethod
    def tiny(cls):
        return cls(image_size=28, patch_size=14, width=16, num_layers=2,
                   num_heads=2, mlp_dim=32, projection_dim=12)


@dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    projection_dim: int = 512
    layer_norm_eps: float = 1e-5

    @classmethod
    def vit_b_32_text(cls):
        """openai/clip-vit-base-patch32 text geometry (the AU encoder)."""
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=64, context_length=16, width=16, num_layers=2,
                   num_heads=2, mlp_dim=32, projection_dim=8)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _init_block(generator, width: int, num_heads: int, mlp_dim: int, dtype) -> dict:
    dev = generator.device
    return {
        "ln1": nn.layernorm_init(width, dtype=dtype, device=dev),
        "attn": nn.mha_init(generator, width, width, num_heads, dtype=dtype),
        "ln2": nn.layernorm_init(width, dtype=dtype, device=dev),
        "mlp_in": nn.dense_init(generator, width, mlp_dim, dtype=dtype),
        "mlp_out": nn.dense_init(generator, mlp_dim, width, dtype=dtype),
    }


def init_vision_params(generator: torch.Generator, cfg: ClipVisionConfig,
                       dtype=torch.bfloat16) -> dict:
    """Random vision-tower weights on the generator's device (JAX's tree and
    scales; the values differ from JAX's for the same seed)."""
    dev = generator.device
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    return {
        "patch_embed": nn.dense_nobias_init(generator, patch_dim, cfg.width, dtype=dtype),
        "class_embed": nn.normal(generator, (cfg.width,), 0.02, dtype),
        "pos_embed": nn.embedding_init(generator, cfg.num_patches + 1, cfg.width, dtype=dtype),
        "pre_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
        "blocks": [_init_block(generator, cfg.width, cfg.num_heads, cfg.mlp_dim, dtype)
                   for _ in range(cfg.num_layers)],
        "post_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
        "proj": nn.dense_nobias_init(generator, cfg.width, cfg.projection_dim, dtype=dtype),
    }


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[b, H, W, 3] → [b, n_patches, P·P·3], channel-major within a patch
    (the HF conv weight (O, C, kH, kW) flattened to (C·kH·kW, O)). Pixels
    past the last whole patch are dropped, as HF's patch convolution (stride
    = kernel, no padding) drops them: SigLIP so400m's 384 px at patch 14
    gives 27 x 27 patches (JAX's reshape raises there)."""
    b, H, W, c = images.shape
    gh, gw = H // patch_size, W // patch_size
    x = images[:, :gh * patch_size, :gw * patch_size].reshape(b, gh, patch_size, gw, patch_size,
                                                               c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [b, gh, gw, c, ph, pw]
    return x.reshape(b, gh * gw, c * patch_size * patch_size)


def _apply_block(block: dict, x: torch.Tensor, num_heads: int, eps: float, mask=None,
                 valid_len=None) -> torch.Tensor:
    impl = "sublayer" if ATTN_IMPL == "auto" else ATTN_IMPL
    fusable = valid_len is not None and mask is None
    if impl == "sublayer" and not (fusable and "w" in block["attn"]["q"]):
        impl = "flash"  # masked or non-bf16 blocks: the next route, as in JAX
    if impl == "sublayer":
        x = vit_sublayer.apply(block, x, num_heads, valid_len, eps)
    elif fusable and impl == "flash":
        h = nn.layernorm(block["ln1"], x, eps)
        x = x + vit_attention.mha_fused(block["attn"], h, num_heads, valid_len)
    else:
        h = nn.layernorm(block["ln1"], x, eps)
        x = x + nn.mha(block["attn"], h, h, num_heads, mask)
    if impl == "sublayer" and MLP_IMPL in ("auto", "fused") and "w" in block["mlp_in"]:
        if MLP_IMPL == "fused":
            return vit_mlp_fused.apply(block, x, eps)
        return vit_mlp.apply(block, x, eps)
    h = nn.layernorm(block["ln2"], x, eps)
    return x + nn.dense(block["mlp_out"], quick_gelu(nn.dense(block["mlp_in"], h)))


def encode_image(params: dict, cfg: ClipVisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [b, H, W, 3] (CLIP-normalized floats) → [b, projection_dim] in
    the weights' dtype."""
    b = images.shape[0]
    pe = params["patch_embed"]
    # an int8 patch embedding has no float weight to take the dtype from:
    # the tower then computes in its other leaves' dtype (JAX takes the
    # images' f32 there, which the port's bf16 fused attention would refuse)
    patch_dtype = pe["w"].dtype if "w" in pe else params["class_embed"].dtype
    x = nn.dense_nobias(pe, patchify(images.to(patch_dtype), cfg.patch_size))  # [b, N, w]
    cls = params["class_embed"].to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"]["table"][None, : x.shape[1]].to(x.dtype)
    x = nn.layernorm(params["pre_ln"], x, cfg.layer_norm_eps)
    valid_len = x.shape[1]
    for block in params["blocks"]:
        x = _apply_block(block, x, cfg.num_heads, cfg.layer_norm_eps, valid_len=valid_len)
    pooled = nn.layernorm(params["post_ln"], x[:, 0], cfg.layer_norm_eps)
    return nn.dense_nobias(params["proj"], pooled)


def init_text_params(generator: torch.Generator, cfg: ClipTextConfig,
                     dtype=torch.bfloat16) -> dict:
    """Random text-tower weights on the generator's device (JAX's tree and
    scales; the values differ from JAX's for the same seed)."""
    dev = generator.device
    return {
        "token_embed": nn.embedding_init(generator, cfg.vocab_size, cfg.width, dtype=dtype),
        "pos_embed": nn.embedding_init(generator, cfg.context_length, cfg.width, dtype=dtype),
        "blocks": [_init_block(generator, cfg.width, cfg.num_heads, cfg.mlp_dim, dtype)
                   for _ in range(cfg.num_layers)],
        "final_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=dev),
        "proj": nn.dense_nobias_init(generator, cfg.width, cfg.projection_dim, dtype=dtype),
    }


def encode_text(params: dict, cfg: ClipTextConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """token_ids [b, T] (0 after the EOT token, which has the highest id:
    the CLIP convention) → [b, projection_dim]."""
    t = token_ids.shape[1]
    x = nn.embedding(params["token_embed"], token_ids)
    x = x + params["pos_embed"]["table"][None, :t].to(x.dtype)
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))[None, None]
    for block in params["blocks"]:
        x = _apply_block(block, x, cfg.num_heads, cfg.layer_norm_eps, causal)
    x = nn.layernorm(params["final_ln"], x, cfg.layer_norm_eps)
    eot = torch.argmax(token_ids, dim=-1)  # the highest id is the EOT token
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    return nn.dense_nobias(params["proj"], pooled)
