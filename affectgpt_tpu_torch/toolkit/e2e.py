"""End-to-end raw-media fusion model (toolkit e2e baseline), in PyTorch.

Port of affectgpt_tpu/toolkit/e2e.py (reference:
toolkit/models/e2e_model.py: fine-tune pretrained audio/visual encoders
directly on raw media with a fusion head, instead of frozen-feature
fusion). The towers are the port's CLIP ViT (`clip_vit.encode_image`) and
HuBERT (`hubert.encode_clips`) with *trainable* params, topped by the
MERBench attention-fusion head.

Routes: under `torch.no_grad` a bf16 tree runs CLIP's blocks on rows 11-12
(the attention and MLP sublayer kernels) like every frozen tower; under
autograd the towers' blocks take the plain chain (`nn.needs_grad`), since
no kernel has a backward. An f32 tree under `no_grad` reaches the bf16
kernels on the card and raises there: run a frozen tower in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import torch

from affectgpt_tpu_torch.models import clip_vit, hubert, nn
from affectgpt_tpu_torch.toolkit.models import FusionArgs, _drop, _heads, _heads_init, _site


@dataclass(frozen=True)
class E2EConfig:
    vision: clip_vit.ClipVisionConfig = field(default_factory=clip_vit.ClipVisionConfig.tiny)
    audio: hubert.HubertConfig = field(default_factory=hubert.HubertConfig.tiny)
    text_dim: int = 768
    hidden_dim: int = 64
    output_dim1: int = 6
    output_dim2: int = 1
    # the reference e2e model's fusion-encoder dropout; train-mode only,
    # active iff apply() receives train_rng
    dropout: float = 0.0

    def fusion_args(self) -> FusionArgs:
        return FusionArgs(
            text_dim=self.text_dim,
            audio_dim=self.audio.hidden_size,
            video_dim=self.vision.projection_dim,
            hidden_dim=self.hidden_dim,
            output_dim1=self.output_dim1,
            output_dim2=self.output_dim2,
        )


def init_params(generator: torch.Generator, cfg: E2EConfig, dtype=torch.float32) -> dict:
    """Random weights on the generator's device (JAX's tree; the values
    differ from JAX's for the same seed)."""
    args = cfg.fusion_args()
    d = cfg.hidden_dim
    return {
        "visual": clip_vit.init_vision_params(generator, cfg.vision, dtype=dtype),
        "acoustic": hubert.init_params(generator, cfg.audio, dtype=dtype),
        "proj_a": nn.dense_init(generator, args.audio_dim, d, dtype=dtype),
        "proj_t": nn.dense_init(generator, args.text_dim, d, dtype=dtype),
        "proj_v": nn.dense_init(generator, args.video_dim, d, dtype=dtype),
        "heads": _heads_init(generator, d * 3, args, dtype=dtype),
    }


def apply(params: dict, cfg: E2EConfig, batch, train_rng=None) -> Tuple:
    """batch: frames [b, T, H, W, 3] floats (CLIP-normalized), audio clips
    [b, clips, 1, samples], texts [b, text_dim] (utterance embedding).
    Returns the toolkit 4-tuple.

    train_rng: dropout on the three fusion projections; None = eval mode."""
    frames = batch["frames"]
    b, t = frames.shape[:2]
    flat = frames.reshape(b * t, *frames.shape[2:])
    vfeat = clip_vit.encode_image(params["visual"], cfg.vision, flat)
    vfeat = vfeat.reshape(b, t, -1).mean(dim=1)
    afeat = hubert.encode_clips(params["acoustic"], cfg.audio, batch["audios"]).mean(dim=1)
    key = train_rng if cfg.dropout > 0.0 else None
    a = _drop(_site(key, 0), cfg.dropout, torch.relu(nn.dense(params["proj_a"], afeat)))
    t_ = _drop(_site(key, 1), cfg.dropout, torch.relu(nn.dense(params["proj_t"], batch["texts"])))
    v = _drop(_site(key, 2), cfg.dropout, torch.relu(nn.dense(params["proj_v"], vfeat)))
    feats = torch.cat([a, t_, v], dim=-1)
    emos, vals = _heads(params["heads"], feats)
    return feats, emos, vals, torch.zeros((), dtype=feats.dtype, device=feats.device)
