"""Encode MER-Factory `fine_grained_descriptions` with the CLIP text tower.

Port of scripts/encode_fine_grained.py (reference:
AffectGPT/encode_fine_grained_descriptions.py): walks
`{output}/{video_id}/{video_id}_au_analysis.json`, CLIP-text-encodes each
fine-grained description with the port's ViT-B/32 text tower
(`utils/clip_text`), and writes one `.npz` per video (keys + [N, 512]
float32 features, rows in the keys' temporal order).

Usage:
  python -m affectgpt_tpu_torch.scripts.encode_fine_grained \
      --mer-factory-output /path/out [--save-root ./fine_grained_features] \
      [--limit N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np

from affectgpt_tpu_torch.utils import clip_text
from affectgpt_tpu_torch.utils.logging import logger, setup_logger


def _temporal_key(key: str):
    """Order timestamp-like keys numerically ('2.0s' before '10.5s');
    non-numeric keys sort after, lexicographically."""
    match = re.match(r"^\s*(-?\d+(?:\.\d+)?)", str(key))
    return (0, float(match.group(1)), str(key)) if match else (1, 0.0, str(key))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mer-factory-output", required=True)
    parser.add_argument("--save-root", default="./fine_grained_features")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="the tower's device (cuda or cpu)")
    args = parser.parse_args(argv)
    setup_logger()

    json_paths = sorted(
        glob.glob(os.path.join(args.mer_factory_output, "*", "*_au_analysis.json"))
    )
    if args.limit:
        json_paths = json_paths[: args.limit]
    logger.info("found %d AU analysis files", len(json_paths))
    os.makedirs(args.save_root, exist_ok=True)

    tower = None
    done = skipped = 0
    for path in json_paths:
        video_id = os.path.basename(os.path.dirname(path))
        out = os.path.join(args.save_root, f"{video_id}_fine_grained_clip.npz")
        if os.path.exists(out):
            done += 1
            continue
        try:
            with open(path) as handle:
                data = json.load(handle)
        except Exception as error:
            logger.warning("%s: unreadable (%s)", video_id, error)
            skipped += 1
            continue
        descs = data.get("fine_grained_descriptions") or {}
        if not descs:
            logger.warning("%s: no fine_grained_descriptions", video_id)
            skipped += 1
            continue
        if tower is None:
            tower = clip_text.load_text_tower(device=args.device)
        keys = sorted(descs, key=_temporal_key)
        feats = clip_text.encode_texts(*tower, [str(descs[k]) for k in keys])
        np.savez(out, keys=np.asarray(keys), features=feats)
        done += 1
    logger.info("encoded %d videos (%d skipped) → %s", done, skipped, args.save_root)


if __name__ == "__main__":
    main()
