"""Temporal mergers and audio-video pre-fusion, in PyTorch.

Port of affectgpt_tpu/models/mergers.py for the `attention` and `mean`
mergers and the `attention` pre-fusion (the shipped best configuration).
The `qformer` variants (and models/qformer.py) are not ported yet; asking
for one raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from affectgpt_tpu_torch.models import nn


@dataclass(frozen=True)
class MergerConfig:
    fusion_type: str  # "qformer" | "attention" | "mean"
    feat_dim: int
    llm_dim: int
    num_query_tokens: int
    max_time: int


def _no_qformer(kind: str):
    return NotImplementedError(f"{kind} fusion_type 'qformer' is not ported to PyTorch yet")


def init_merger(generator: torch.Generator, cfg: MergerConfig, dtype=torch.float32) -> dict:
    params: dict = {}
    if cfg.fusion_type == "attention":
        params["attn_mlp"] = nn.dense_init(generator, cfg.feat_dim, 1, dtype=dtype)
    elif cfg.fusion_type == "qformer":
        raise _no_qformer("merger")
    elif cfg.fusion_type != "mean":
        raise ValueError(f"Unknown fusion_type: {cfg.fusion_type}")
    params["proj"] = nn.dense_init(generator, cfg.feat_dim, cfg.llm_dim, dtype=dtype)
    return params


def apply_merger(params: dict, cfg: MergerConfig, features: torch.Tensor) -> torch.Tensor:
    """[b, t, feat_dim] (or [b, t, q, feat_dim]) → [b, num_query_tokens, llm_dim]."""
    if cfg.fusion_type == "qformer":
        raise _no_qformer("merger")
    if features.ndim == 4:
        features = features.mean(dim=2)
    b, t, _ = features.shape
    if cfg.fusion_type == "attention":
        if t == 1:
            # single-timestep features bypass the attention weighting
            # (reference preextracted path, affectgpt.py:587-589)
            fused = features[:, 0, :]
        else:
            # unnormalized linear attention pooling: features^T @ mlp(features)
            weights = nn.dense(params["attn_mlp"], features)  # [b, t, 1]
            fused = torch.einsum("btd,bto->bd", features.float(), weights.float())
            fused = fused.to(features.dtype)
    elif cfg.fusion_type == "mean":
        fused = features.mean(dim=1)
    else:
        raise ValueError(cfg.fusion_type)
    out = nn.dense(params["proj"], fused)  # [b, llm_dim]
    return out[:, None, :].expand(b, cfg.num_query_tokens, out.shape[-1])


@dataclass(frozen=True)
class MultiFusionConfig:
    fusion_type: str  # "qformer" | "attention"
    video_dim: int
    audio_dim: int
    llm_dim: int
    num_query_tokens: int
    max_time: int = 264

    @property
    def max_dim(self) -> int:
        return max(self.video_dim, self.audio_dim)


def init_multi_fusion(generator: torch.Generator, cfg: MultiFusionConfig,
                      dtype=torch.float32) -> dict:
    if cfg.fusion_type == "qformer":
        raise _no_qformer("multi")
    if cfg.fusion_type != "attention":
        raise ValueError(f"Unknown multi fusion_type: {cfg.fusion_type}")
    return {
        "video_embs": nn.dense_init(generator, cfg.video_dim, cfg.max_dim, dtype=dtype),
        "audio_embs": nn.dense_init(generator, cfg.audio_dim, cfg.max_dim, dtype=dtype),
        "attn_mlp": nn.dense_init(generator, cfg.max_dim * 2, cfg.max_dim, dtype=dtype),
        "fc_att": nn.dense_init(generator, cfg.max_dim, 2, dtype=dtype),
        "proj": nn.dense_init(generator, cfg.max_dim, cfg.llm_dim, dtype=dtype),
    }


def apply_multi_fusion(params: dict, cfg: MultiFusionConfig, video_hidden: torch.Tensor,
                       audio_hidden: torch.Tensor) -> torch.Tensor:
    """video_hidden [b, tv, video_dim], audio_hidden [b, ta, audio_dim]
    → [b, num_query_tokens, llm_dim]: mean-pool each stream, a 2-way
    attention gate, weighted sum, projection (affectgpt.py:464-489)."""
    if cfg.fusion_type != "attention":
        raise _no_qformer("multi")
    b = video_hidden.shape[0]
    v = nn.dense(params["video_embs"], video_hidden.mean(dim=1))  # [b, maxdim]
    a = nn.dense(params["audio_embs"], audio_hidden.mean(dim=1))
    gate = nn.dense(params["fc_att"], nn.dense(params["attn_mlp"], torch.cat([v, a], dim=-1)))
    stacked = torch.stack([v, a], dim=1)  # [b, 2, maxdim]
    fused = torch.einsum("bmd,bm->bd", stacked.float(), gate.float()).to(v.dtype)
    out = nn.dense(params["proj"], fused)
    return out[:, None, :].expand(b, cfg.num_query_tokens, out.shape[-1])
