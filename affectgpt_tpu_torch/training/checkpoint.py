"""Checkpoints of the PyTorch port: trainable-only state with the 3-tier
overlay.

Port of affectgpt_tpu/training/checkpoint.py (reference:
runners/runner_base.py:600-688, trainable parameters only with the
optimizer state and epoch, `checkpoint_%06d_loss_%s` names, resume; and
affectgpt.py:1099-1120, the non-strict `ckpt < ckpt_2 < ckpt_3` overlay at
model build). A checkpoint is a directory holding `payload.pt`, written
with `torch.save` and read with `torch.load(weights_only=True)` (tensors,
numbers, strings, dicts and lists only), and `config.json`. JAX's Orbax
directories are not read: that needs `jax`.

Payload keys: `trainable`, `opt_state`, `epoch` (epochs completed: the
next epoch to train), `step`, `loss`, `best_val`, `config`.
"""

from __future__ import annotations

import glob
import json
import logging
import math
import os
import re
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

PAYLOAD = "payload.pt"


def checkpoint_name(epoch: int, loss: Optional[float] = None) -> str:
    loss_str = f"{loss:.4f}" if loss is not None else "nan"
    return f"checkpoint_{epoch:06d}_loss_{loss_str}"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def save_checkpoint(output_dir: str, epoch: int, trainable: Any, opt_state: Any = None,
                    step: int = 0, loss: Optional[float] = None,
                    config: Optional[dict] = None, best_val: Optional[float] = None) -> str:
    """Save the trainable parameters (and the optimizer state for resume)
    into `output_dir/checkpoint_name(epoch, loss)`, overwriting a checkpoint
    of that name. Frozen weights are never written (the reference's
    requires_grad filter). Returns the directory."""
    path = os.path.abspath(os.path.join(output_dir, checkpoint_name(epoch, loss)))
    os.makedirs(path, exist_ok=True)
    payload = {"trainable": _to_cpu(trainable), "epoch": int(epoch), "step": int(step)}
    if opt_state is not None:
        payload["opt_state"] = _to_cpu(opt_state)
    if loss is not None:
        payload["loss"] = float(loss)
    if best_val is not None and math.isfinite(best_val):
        payload["best_val"] = float(best_val)
    if config is not None:
        payload["config"] = json.loads(json.dumps(config, default=str))
        with open(os.path.join(path, "config.json"), "w") as handle:
            json.dump(config, handle, default=str)
    tmp = os.path.join(path, PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, PAYLOAD))
    return path


def load_checkpoint(path: str, map_location="cpu") -> dict:
    """The payload of the checkpoint directory `path`, its tensors on
    `map_location`."""
    return torch.load(os.path.join(os.path.abspath(path), PAYLOAD),
                      map_location=map_location, weights_only=True)


def _overlay(base: Any, update: Any, _path: str = "", _unknown: Optional[list] = None) -> Any:
    """Non-strict merge: leaves present in `update` replace `base`, missing
    subtrees keep base values (strict=False load_state_dict). Keys absent
    from `base` are still inserted (the reference's non-strict semantics)
    but collected into `_unknown` so callers can warn: a silently inserted
    dead subtree means the live weights at that slot stayed at random
    init."""
    if isinstance(base, dict) and isinstance(update, dict):
        out = dict(base)
        for key, value in update.items():
            if key in base:
                out[key] = _overlay(base[key], value, f"{_path}/{key}", _unknown)
            else:
                if _unknown is not None:
                    _unknown.append(f"{_path}/{key}")
                out[key] = value
        return out
    if isinstance(base, list) and isinstance(update, list) and len(base) == len(update):
        return [_overlay(b, u, f"{_path}[{i}]", _unknown)
                for i, (b, u) in enumerate(zip(base, update))]
    return update if update is not None else base


def _migrate_legacy_mergers(update: Any) -> Any:
    """Old checkpoints keyed trainable["mergers"] by modality
    (frame/face/audio/image/au); the live tree keys them by group
    (video/audio/image/au), frame and face sharing one video merger as in
    the reference (affectgpt.MERGER_GROUP). Map frame (else face) to video
    and drop both, so an old checkpoint restores into the shared merger
    instead of leaving it at random init behind dead keys."""
    if not (isinstance(update, dict) and isinstance(update.get("mergers"), dict)):
        return update
    mergers = update["mergers"]
    if "frame" not in mergers and "face" not in mergers:
        return update
    migrated = {k: v for k, v in mergers.items() if k not in ("frame", "face")}
    source = None
    if "video" not in migrated:
        # frame and face fed the same merger with summed gradients, so either
        # copy is the trained one; a face-only run migrates face
        source = "frame" if "frame" in mergers else "face"
        migrated["video"] = mergers[source]
    logger.warning(
        "checkpoint: legacy modality-keyed mergers migrated (%s->video%s); "
        "re-save to silence this",
        source or "none",
        ", face weights dropped" if ("face" in mergers and source != "face") else "",
    )
    return {**update, "mergers": migrated}


def _device_of(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            found = _device_of(v)
            if found is not None:
                return found
        return None
    return tree.device if torch.is_tensor(tree) else None


def apply_checkpoint_overlays(trainable: Any, *ckpt_paths: Optional[str]) -> Any:
    """The reference's 3-tier composition: apply ckpt, ckpt_2, ckpt_3 in
    order, later tiers winning (affectgpt.py:1099-1120); each checkpoint's
    tensors land on the live tree's device."""
    device = _device_of(trainable) or "cpu"
    for path in ckpt_paths:
        if not path:
            continue
        payload = load_checkpoint(path, map_location=device)
        unknown: list = []
        trainable = _overlay(trainable, _migrate_legacy_mergers(payload["trainable"]),
                             _unknown=unknown)
        if unknown:
            logger.warning(
                "checkpoint %s: %d key(s) absent from the live trainable tree were inserted "
                "verbatim (first: %s) — the live weights at those slots are unchanged",
                path, len(unknown), unknown[0])
    return trainable


def list_checkpoints(output_dir: str):
    """Sorted (epoch, path) pairs under a run directory."""
    found = []
    for path in glob.glob(os.path.join(output_dir, "checkpoint_*")):
        match = re.search(r"checkpoint_(\d+)_loss", os.path.basename(path))
        if match:
            found.append((int(match.group(1)), path))
    return sorted(found)


def discover_checkpoint_root(result_root: str) -> Optional[str]:
    """The run directory with the most checkpoints (the reference's
    auto-discovery, inference_hybird.py:32-54); one with none never wins."""
    best, best_count = None, 0
    for candidate in glob.glob(os.path.join(result_root, "*")):
        if not os.path.isdir(candidate):
            continue
        count = len(list_checkpoints(candidate))
        if count > best_count:
            best, best_count = candidate, count
    return best
