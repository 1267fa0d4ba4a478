"""The CLIP ViT-B/32 text tower for AU text features, in PyTorch.

Port of affectgpt_tpu/utils/clip_text.py: resolve the tower
(`PATH_TO_VISUAL["CLIP_VIT_BASE32"]`: the HF checkpoint there, converted by
models/convert.py; random weights from a seed when the directory is
absent), tokenize by bytes (the CLIP BPE is not used, as in JAX), and
encode texts to row-normalized [N, 512] features, as the reference's AU
extraction normalizes them.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from affectgpt_tpu_torch import paths
from affectgpt_tpu_torch.models import clip_vit, convert

logger = logging.getLogger(__name__)


def load_text_tower(device="cuda", dtype=torch.bfloat16, seed: int = 2):
    """(params, ClipTextConfig) of the ViT-B/32 text tower: the checkpoint of
    the directory, checked against the config, or random weights drawn from
    `seed` on `device` when the directory is absent."""
    cfg = clip_vit.ClipTextConfig.vit_b_32_text()
    text_dir = paths.PATH_TO_VISUAL.get("CLIP_VIT_BASE32", "")
    if text_dir and os.path.isdir(text_dir):
        params = convert.convert_clip_text(text_dir, dtype=dtype, device=device)
        return convert.check_text_tower(params, cfg), cfg
    logger.warning("CLIP text dir %s not found — random init (smoke mode)", text_dir)
    generator = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return clip_vit.init_text_params(generator, cfg, dtype=dtype), cfg


_CACHED_TOWER = {}


def cached_text_tower(device="cuda"):
    """One load_text_tower() per device and process: the realtime AU path
    encodes one short text per sample and must not rebuild the tower."""
    key = str(torch.device(device))
    if key not in _CACHED_TOWER:
        _CACHED_TOWER[key] = load_text_tower(device)
    return _CACHED_TOWER[key]


def byte_fallback_tokenize(texts, cfg: clip_vit.ClipTextConfig) -> np.ndarray:
    """[N, context_length] int32 ids: the UTF-8 bytes clipped into the vocab,
    then an EOT sentinel (the highest id); the stand-in for CLIP's BPE."""
    ids = np.zeros((len(texts), cfg.context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        enc = [min(b, cfg.vocab_size - 2) for b in str(text).encode()]
        enc = enc[: cfg.context_length - 1]
        ids[i, : len(enc)] = enc
        ids[i, len(enc)] = cfg.vocab_size - 1  # EOT
    return ids


def encode_texts(params: dict, cfg: clip_vit.ClipTextConfig, texts) -> np.ndarray:
    """texts → [N, projection_dim] float32 features, each row divided by its
    L2 norm (floored at 1e-12)."""
    dev = params["token_embed"]["table"].device
    ids = torch.as_tensor(byte_fallback_tokenize(texts, cfg), dtype=torch.long, device=dev)
    feats = clip_vit.encode_text(params, cfg, ids).float().cpu().numpy()
    norms = np.linalg.norm(feats, axis=-1, keepdims=True)
    return feats / np.maximum(norms, 1e-12)
