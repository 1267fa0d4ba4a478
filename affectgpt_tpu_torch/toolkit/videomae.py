"""VideoMAE pretraining: tube-masked video autoencoding, in PyTorch.

Port of affectgpt_tpu/toolkit/videomae.py (reference: toolkit/models/
VideoMAE pretrain entry): videos are split into space-time tubes, a high
ratio is masked, a ViT encoder sees only visible tubes, and a light decoder
reconstructs the masked pixels; the loss is masked-pixel MSE against each
tube normalized by its mean and population std.

The mask is a per-sample random permutation (argsort of uniforms) with a
fixed visible count. `pretrain_loss` draws the order from a key of the
port's (a tuple of ints, as `nn.fold_in` makes them; the draws are the
port's, not JAX's) and calls `loss_from_order`, which takes any order.
The blocks are `nn.mha`'s: unmasked self-attention of 192 tokens or more
goes to row 13 (the fused attention kernel) unless it trains, so
`encode_video` over all 1568 tubes of the default config launches it once
a layer; run it in bf16 (`init_params(dtype=torch.bfloat16)`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from affectgpt_tpu_torch.models import nn


@dataclass(frozen=True)
class VideoMAEConfig:
    num_frames: int = 16
    image_size: int = 224
    patch_size: int = 16
    tubelet_size: int = 2
    width: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_dim: int = 1536
    decoder_width: int = 192
    decoder_layers: int = 4
    decoder_heads: int = 3
    mask_ratio: float = 0.9
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        spatial = (self.image_size // self.patch_size) ** 2
        return spatial * (self.num_frames // self.tubelet_size)

    @property
    def patch_dim(self) -> int:
        return self.tubelet_size * self.patch_size * self.patch_size * 3

    @property
    def num_visible(self) -> int:
        return max(1, int(self.num_patches * (1.0 - self.mask_ratio)))

    @classmethod
    def tiny(cls):
        return cls(num_frames=4, image_size=32, patch_size=16, tubelet_size=2,
                   width=32, num_layers=2, num_heads=2, mlp_dim=64,
                   decoder_width=16, decoder_layers=1, decoder_heads=2,
                   mask_ratio=0.5)


def _block_init(g, width, heads, mlp, dtype=torch.float32):
    return {
        "ln1": nn.layernorm_init(width, dtype=dtype, device=g.device),
        "attn": nn.mha_init(g, width, width, heads, dtype=dtype),
        "ln2": nn.layernorm_init(width, dtype=dtype, device=g.device),
        "mlp_in": nn.dense_init(g, width, mlp, dtype=dtype),
        "mlp_out": nn.dense_init(g, mlp, width, dtype=dtype),
    }


def _block_apply(block, x, heads, eps):
    h = nn.layernorm(block["ln1"], x, eps)
    x = x + nn.mha(block["attn"], h, h, heads)
    h = nn.layernorm(block["ln2"], x, eps)
    return x + nn.dense(block["mlp_out"], nn.gelu(nn.dense(block["mlp_in"], h)))


def init_params(generator: torch.Generator, cfg: VideoMAEConfig, dtype=torch.float32) -> dict:
    """Random weights on the generator's device (JAX's tree; the values
    differ from JAX's for the same seed)."""
    g = generator
    return {
        "patch_embed": nn.dense_init(g, cfg.patch_dim, cfg.width, dtype=dtype),
        "pos_embed": {"table": nn.normal(g, (cfg.num_patches, cfg.width), 0.02, dtype)},
        "encoder": [
            _block_init(g, cfg.width, cfg.num_heads, cfg.mlp_dim, dtype)
            for _ in range(cfg.num_layers)
        ],
        "encoder_ln": nn.layernorm_init(cfg.width, dtype=dtype, device=g.device),
        "enc_to_dec": nn.dense_init(g, cfg.width, cfg.decoder_width, dtype=dtype),
        "mask_token": torch.zeros((cfg.decoder_width,), dtype=dtype, device=g.device),
        "dec_pos_embed": {"table": nn.normal(g, (cfg.num_patches, cfg.decoder_width), 0.02,
                                             dtype)},
        "decoder": [
            _block_init(g, cfg.decoder_width, cfg.decoder_heads, cfg.decoder_width * 4, dtype)
            for _ in range(cfg.decoder_layers)
        ],
        "decoder_ln": nn.layernorm_init(cfg.decoder_width, dtype=dtype, device=g.device),
        "pixel_head": nn.dense_init(g, cfg.decoder_width, cfg.patch_dim, dtype=dtype),
    }


def tube_patchify(video: torch.Tensor, cfg: VideoMAEConfig) -> torch.Tensor:
    """[B, T, H, W, 3] → [B, num_patches, patch_dim] space-time tubes."""
    b, t, h, w, c = video.shape
    ts, ps = cfg.tubelet_size, cfg.patch_size
    x = video.reshape(b, t // ts, ts, h // ps, ps, w // ps, ps, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, (t // ts) * (h // ps) * (w // ps), ts * ps * ps * c)


def tube_order(rng: tuple, b: int, n: int, device) -> torch.Tensor:
    """[b, n] per-sample random permutations of the tubes (argsort of
    uniforms drawn from the key `rng`): the first num_visible are seen."""
    g = torch.Generator(device=device).manual_seed(nn.key_seed(rng))
    noise = torch.rand((b, n), generator=g, device=device)
    return torch.argsort(noise, dim=1, stable=True)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, D] at rows idx [B, K] → [B, K, D]."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def loss_from_order(params: dict, cfg: VideoMAEConfig, video: torch.Tensor,
                    order: torch.Tensor) -> torch.Tensor:
    """Masked tube reconstruction loss of `video` [B, T, H, W, 3] in [0, 1]
    under the tube order `order` [B, N]."""
    patches = tube_patchify(video.float(), cfg)  # [B, N, D]
    b, n, _ = patches.shape
    v = cfg.num_visible
    visible_idx = order[:, :v]
    masked_idx = order[:, v:]

    pos = params["pos_embed"]["table"]  # [N, W]
    tokens = nn.dense(params["patch_embed"], patches) + pos[None]
    x = _gather_rows(tokens, visible_idx)  # [B, V, W]
    for block in params["encoder"]:
        x = _block_apply(block, x, cfg.num_heads, cfg.layer_norm_eps)
    x = nn.layernorm(params["encoder_ln"], x, cfg.layer_norm_eps)
    x = nn.dense(params["enc_to_dec"], x)  # [B, V, Wd]

    # decoder sees visible tokens + mask tokens, each with decoder pos embeds
    dec_pos = params["dec_pos_embed"]["table"].expand(b, n, -1)  # [B, N, Wd]
    vis_pos = _gather_rows(dec_pos, visible_idx)
    msk_pos = _gather_rows(dec_pos, masked_idx)
    mask_tok = params["mask_token"].expand(msk_pos.shape)
    y = torch.cat([x + vis_pos, mask_tok + msk_pos], dim=1)  # [B, N, Wd]
    for block in params["decoder"]:
        y = _block_apply(block, y, cfg.decoder_heads, cfg.layer_norm_eps)
    y = nn.layernorm(params["decoder_ln"], y, cfg.layer_norm_eps)
    recon = nn.dense(params["pixel_head"], y[:, v:])  # only masked positions [B, N-V, D]

    target = _gather_rows(patches, masked_idx)
    # per-tube normalization (VideoMAE's normalized-pixel target), population std
    mean = target.mean(dim=-1, keepdim=True)
    std = torch.std(target, dim=-1, keepdim=True, correction=0) + 1e-6
    target = (target - mean) / std
    return torch.mean((recon - target) ** 2)


def pretrain_loss(params: dict, cfg: VideoMAEConfig, video: torch.Tensor,
                  rng: tuple) -> torch.Tensor:
    """Masked tube reconstruction loss, the tube order drawn from the key
    `rng` (`tube_order`)."""
    order = tube_order(rng, video.shape[0], cfg.num_patches, video.device)
    return loss_from_order(params, cfg, video, order)


def encode_video(params: dict, cfg: VideoMAEConfig, video: torch.Tensor) -> torch.Tensor:
    """Inference-time representation: encoder over ALL tubes, mean-pooled
    → [B, width] (the pretrained-feature output used downstream), in the
    weights' dtype (the tubes are cast to it)."""
    dtype = params["patch_embed"]["w"].dtype
    patches = tube_patchify(video.to(dtype), cfg)
    x = nn.dense(params["patch_embed"], patches) + params["pos_embed"]["table"][None]
    for block in params["encoder"]:
        x = _block_apply(block, x, cfg.num_heads, cfg.layer_norm_eps)
    x = nn.layernorm(params["encoder_ln"], x, cfg.layer_norm_eps)
    return x.mean(dim=1)
