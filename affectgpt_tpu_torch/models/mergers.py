"""Temporal mergers and audio-video pre-fusion, in PyTorch.

Port of affectgpt_tpu/models/mergers.py: compress [b, t, d] modality
features into a fixed number of LLM-space tokens.

Merger variants per modality:
- "qformer":   + learned temporal position embedding, 2-layer Q-Former
               → [b, num_query, 768] → linear proj → [b, num_query, llm_dim]
- "attention": linear attention pooling over time → [b, d] → proj →
               broadcast to [b, num_query, llm_dim]
- "mean":      temporal mean → proj → broadcast.

Pre-fusion ("multi") variants:
- "qformer":   project audio/video to the larger width, concatenate along
               time, + position embedding, Q-Former → num_query tokens
- "attention": mean-pool each modality, 2-way attention gate, proj,
               broadcast (the shipped best configuration).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from affectgpt_tpu_torch.models import nn, qformer


@dataclass(frozen=True)
class MergerConfig:
    fusion_type: str  # "qformer" | "attention" | "mean"
    feat_dim: int
    llm_dim: int
    num_query_tokens: int
    max_time: int  # position-embedding slots of the qformer merger

    def qformer_config(self) -> qformer.QFormerConfig:
        return qformer.QFormerConfig(encoder_width=self.feat_dim,
                                     num_query_tokens=self.num_query_tokens)


def init_merger(generator: torch.Generator, cfg: MergerConfig, dtype=torch.float32) -> dict:
    params: dict = {}
    if cfg.fusion_type == "qformer":
        params["pos_embed"] = nn.embedding_init(generator, cfg.max_time, cfg.feat_dim,
                                                dtype=dtype)
        params["qformer"] = qformer.init_params(generator, cfg.qformer_config(), dtype=dtype)
        proj_in = cfg.qformer_config().hidden_size
    elif cfg.fusion_type == "attention":
        params["attn_mlp"] = nn.dense_init(generator, cfg.feat_dim, 1, dtype=dtype)
        proj_in = cfg.feat_dim
    elif cfg.fusion_type == "mean":
        proj_in = cfg.feat_dim
    else:
        raise ValueError(f"Unknown fusion_type: {cfg.fusion_type}")
    params["proj"] = nn.dense_init(generator, proj_in, cfg.llm_dim, dtype=dtype)
    return params


def _qformer_tokens(params: dict, qcfg: qformer.QFormerConfig, h: torch.Tensor,
                    dropout_rng=None) -> torch.Tensor:
    """h [b, t, d] or [b, t, q, d]: each time step's position row added to
    its rows, flattened to [b, t·q, d] → Q-Former → proj. dropout_rng: the
    Q-Former's train-mode dropout key."""
    t = h.shape[1]
    pos = nn.embedding(params["pos_embed"], torch.arange(t, device=h.device))
    pos = pos.reshape((1, t) + (1,) * (h.ndim - 3) + (pos.shape[-1],))
    h = (h + pos.to(h.dtype)).reshape(h.shape[0], -1, h.shape[-1])
    return nn.dense(params["proj"], qformer.apply(params["qformer"], qcfg, h,
                                                  dropout_rng=dropout_rng))


def apply_merger(params: dict, cfg: MergerConfig, features: torch.Tensor,
                 dropout_rng=None) -> torch.Tensor:
    """[b, t, feat_dim] (or [b, t, q, feat_dim]) → [b, num_query_tokens, llm_dim].
    A 4-D input to the qformer merger gets the position of its frame added
    to each of its q rows and is flattened to [b, t·q, d]; the other mergers
    average its q rows first. dropout_rng: train-mode dropout key of the
    qformer merger's BERT dropouts; the attention and mean mergers have no
    dropout and ignore it."""
    if cfg.fusion_type == "qformer":
        return _qformer_tokens(params, cfg.qformer_config(), features, dropout_rng)
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
    max_time: int = 264  # qformer position slots

    @property
    def max_dim(self) -> int:
        return max(self.video_dim, self.audio_dim)

    def qformer_config(self) -> qformer.QFormerConfig:
        return qformer.QFormerConfig(encoder_width=self.max_dim,
                                     num_query_tokens=self.num_query_tokens)


def init_multi_fusion(generator: torch.Generator, cfg: MultiFusionConfig,
                      dtype=torch.float32) -> dict:
    params = {
        "video_embs": nn.dense_init(generator, cfg.video_dim, cfg.max_dim, dtype=dtype),
        "audio_embs": nn.dense_init(generator, cfg.audio_dim, cfg.max_dim, dtype=dtype),
    }
    if cfg.fusion_type == "qformer":
        params["pos_embed"] = nn.embedding_init(generator, cfg.max_time, cfg.max_dim,
                                                dtype=dtype)
        params["qformer"] = qformer.init_params(generator, cfg.qformer_config(), dtype=dtype)
        proj_in = cfg.qformer_config().hidden_size
    elif cfg.fusion_type == "attention":
        params["attn_mlp"] = nn.dense_init(generator, cfg.max_dim * 2, cfg.max_dim, dtype=dtype)
        params["fc_att"] = nn.dense_init(generator, cfg.max_dim, 2, dtype=dtype)
        proj_in = cfg.max_dim
    else:
        raise ValueError(f"Unknown multi fusion_type: {cfg.fusion_type}")
    params["proj"] = nn.dense_init(generator, proj_in, cfg.llm_dim, dtype=dtype)
    return params


def apply_multi_fusion(params: dict, cfg: MultiFusionConfig, video_hidden: torch.Tensor,
                       audio_hidden: torch.Tensor, dropout_rng=None) -> torch.Tensor:
    """video_hidden [b, tv, video_dim], audio_hidden [b, ta, audio_dim]
    → [b, num_query_tokens, llm_dim]. dropout_rng: see apply_merger."""
    b = video_hidden.shape[0]
    if cfg.fusion_type == "qformer":
        v = nn.dense(params["video_embs"], video_hidden)  # [b, tv, maxdim]
        a = nn.dense(params["audio_embs"], audio_hidden)  # [b, ta, maxdim]
        return _qformer_tokens(params, cfg.qformer_config(), torch.cat([v, a], dim=1),
                               dropout_rng)
    if cfg.fusion_type != "attention":
        raise ValueError(cfg.fusion_type)
    # attention gate: mean-pool each stream, score the 2 modalities, weighted
    # sum (affectgpt.py:464-489)
    v = nn.dense(params["video_embs"], video_hidden.mean(dim=1))  # [b, maxdim]
    a = nn.dense(params["audio_embs"], audio_hidden.mean(dim=1))
    gate = nn.dense(params["fc_att"], nn.dense(params["attn_mlp"], torch.cat([v, a], dim=-1)))
    stacked = torch.stack([v, a], dim=1)  # [b, 2, maxdim]
    fused = torch.einsum("bmd,bm->bd", stacked.float(), gate.float()).to(v.dtype)
    out = nn.dense(params["proj"], fused)
    return out[:, None, :].expand(b, cfg.num_query_tokens, out.shape[-1])
