"""Trainer for the traditional fusion baselines on precomputed features.

Port of affectgpt_tpu/toolkit/train.py (reference: toolkit/ main train
scripts + dataloader/: utterance-level feature npys per modality + label
npz, cross-entropy + MSE multi-task loss, combined metric checkpoint
selection). The feature table goes to the device once; each epoch visits
`np.random.RandomState(seed).permutation` order, the batches JAX visits.
The optimizer is optax's `adam(lr)` (after `clip_by_global_norm` when
`grad_clip > 0`): `training.optim.AdamW` at a constant rate with no weight
decay.

Feature layout: {feature_root}/{audio_feat}/{name}.npy etc. (the
MERBench feature-directory convention).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from affectgpt_tpu_torch.toolkit.metrics import combined_metric, emotion_metrics, valence_metrics
from affectgpt_tpu_torch.toolkit.models import FUSION_MODELS, FusionArgs
from affectgpt_tpu_torch.training import optim
from affectgpt_tpu_torch.utils.logging import logger


@dataclass
class FeatureTable:
    names: List[str]
    audios: np.ndarray
    texts: np.ndarray
    videos: np.ndarray
    emos: Optional[np.ndarray] = None  # int labels
    vals: Optional[np.ndarray] = None  # float valence


def _load_feature_map(feature_root: str, source: str) -> Dict[str, np.ndarray]:
    """A feature source is either a directory of {name}.npy files or a
    single name-keyed .npz pack (both MERBench distribution formats)."""
    path = os.path.join(feature_root, source)
    if os.path.isdir(path):
        return {
            os.path.splitext(f)[0]: np.load(os.path.join(path, f))
            for f in os.listdir(path) if f.endswith(".npy")
        }
    if path.endswith(".npz") and os.path.exists(path):
        pack = np.load(path, allow_pickle=True)
        if "feature" in pack and "name" in pack:  # paired-array pack
            return dict(zip(pack["name"].tolist(), pack["feature"]))
        return {key: pack[key] for key in pack.files}
    raise FileNotFoundError(path)


def load_feature_table(
    feature_root: str, audio_dir: str, text_dir: str, video_dir: str,
    name2emo: Optional[Dict[str, int]] = None, name2val: Optional[Dict[str, float]] = None,
) -> FeatureTable:
    maps = [
        _load_feature_map(feature_root, src) for src in (audio_dir, text_dir, video_dir)
    ]
    names = sorted(set(maps[0]) & set(maps[1]) & set(maps[2]))

    def stack(feature_map):
        feats = [np.asarray(feature_map[n]) for n in names]
        feats = [f.mean(0) if f.ndim > 1 else f for f in feats]  # utterance-level
        return np.stack(feats).astype(np.float32)

    return FeatureTable(
        names=names,
        audios=stack(maps[0]), texts=stack(maps[1]), videos=stack(maps[2]),
        emos=np.array([name2emo[n] for n in names]) if name2emo else None,
        vals=np.array([name2val[n] for n in names], np.float32) if name2val else None,
    )


def make_optimizer(args: FusionArgs, lr: float) -> optim.AdamW:
    """optax's adam(lr), after clip_by_global_norm(grad_clip) when
    grad_clip > 0 (the MERBench convention: -1 disables)."""
    return optim.AdamW(schedule=lambda _step: lr, weight_decay=0.0,
                       max_grad_norm=args.grad_clip if args.grad_clip > 0 else None)


def _table_on(table: FeatureTable, device) -> Dict[str, torch.Tensor]:
    return {key: torch.as_tensor(getattr(table, key), device=device)
            for key in ("audios", "texts", "videos")}


def train_fusion_model(
    model_name: str,
    args: FusionArgs,
    train: FeatureTable,
    test: Optional[FeatureTable] = None,
    epochs: int = 30,
    batch_size: int = 32,
    lr: float = 1e-3,
    seed: int = 0,
    device="cuda",
):
    """Returns (params, history), the tree drawn from `seed` on `device`.
    Loss = CE(emotions) + MSE(valence) + aux."""
    model = FUSION_MODELS[model_name]
    params = model.init(torch.Generator(device=torch.device(device)).manual_seed(seed), args)
    leaves = optim.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tx = make_optimizer(args, lr)
    state = tx.init(params)

    has_emo = train.emos is not None
    has_val = train.vals is not None
    # train-mode dropout (the reference trainers run model.train() with
    # args.dropout active); evaluation stays eval-mode (no key)
    drop_on = args.dropout > 0.0
    table = _table_on(train, device)
    emos_all = torch.as_tensor(train.emos, dtype=torch.long, device=device) if has_emo else None
    vals_all = torch.as_tensor(train.vals, device=device) if has_val else None

    n = len(train.names)
    rng = np.random.RandomState(seed)
    history = []
    global_step = 0
    for epoch in range(epochs):
        order = rng.permutation(n)
        losses = []
        for start in range(0, n, batch_size):
            idx = torch.as_tensor(order[start : start + batch_size], device=device)
            batch = {key: value[idx] for key, value in table.items()}
            train_rng = (seed ^ 0x5EED, global_step) if drop_on else None
            _, emo_logits, val_pred, inter = model.apply(params, args, batch,
                                                         train_rng=train_rng)
            loss = inter
            if has_emo:
                loss = loss + F.cross_entropy(emo_logits, emos_all[idx])
            if has_val:
                loss = loss + torch.mean((val_pred[:, 0] - vals_all[idx]) ** 2)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if gr is None else gr for p, gr in zip(leaves, grads)]
            state = tx.apply(optim.tree_unflatten(params, grads), state, params)
            global_step += 1
            losses.append(loss.detach())
        record = {"epoch": epoch, "train_loss": float(np.mean([x.item() for x in losses]))}
        if test is not None:
            record.update(evaluate_fusion_model(model_name, args, params, test))
        history.append(record)
        logger.info("%s %s", model_name, record)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return params, history


def train_cross_corpus(
    model_name: str,
    args: FusionArgs,
    source: FeatureTable,
    target: FeatureTable,
    **train_kwargs,
):
    """Cross-corpus protocol: train on the source corpus, evaluate on the
    target corpus. Returns (params, history, target_metrics)."""
    params, history = train_fusion_model(
        model_name, args, source, test=None, **train_kwargs
    )
    target_metrics = evaluate_fusion_model(model_name, args, params, target)
    logger.info("cross-corpus %s → target: %s", model_name, target_metrics)
    return params, history, target_metrics


def evaluate_fusion_model(model_name: str, args: FusionArgs, params, table: FeatureTable):
    """Eval-mode metrics of the whole table in one batch, on the params'
    device."""
    model = FUSION_MODELS[model_name]
    device = optim.tree_leaves(params)[0].device
    with torch.no_grad():
        _, emo_logits, val_pred, _ = model.apply(params, args, _table_on(table, device))
    out: Dict[str, float] = {}
    if table.emos is not None:
        out.update(emotion_metrics(table.emos, emo_logits.float().cpu().numpy()))
    if table.vals is not None:
        out.update(valence_metrics(table.vals, val_pred.float().cpu().numpy()))
    if "emo_waf1" in out:
        out["combined"] = combined_metric(out["emo_waf1"], out.get("val_mse", 0.0))
    return out
