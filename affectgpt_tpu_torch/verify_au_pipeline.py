"""Verify the AU (Action Unit) data chain end-to-end.

    python -m affectgpt_tpu_torch.verify_au_pipeline --mer-factory-output /path/to/outputs \
        [--feature-root ./preextracted_features --dataset MER2023] \
        [--nonverbal-json MER_UniBench_grained.json]

Port of the repo's root verify_au_pipeline.py (reference:
AffectGPT/verify_au_pipeline.py:1-219): walks MER-Factory outputs,
validates `{name}_au_analysis.json` structure (au_info, peak_frames,
summary descriptions), checks the CLIP-text AU feature caches (the
layout of the port's data/media.py `feature_cache_path`, which
`extract_multimodal_features_precompute --modality au` writes through
utils/clip_text.py), and confirms the nonverbal-text lookup used at
training time. Host only: no model and no device. `main` returns the
counts and the warnings it logged.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

import numpy as np

from affectgpt_tpu_torch.data import media
from affectgpt_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def check_au_json(json_path: str) -> dict:
    report = {"path": json_path, "ok": True, "issues": []}
    try:
        with open(json_path) as handle:
            data = json.load(handle)
    except Exception as error:
        report["ok"] = False
        report["issues"].append(f"unreadable: {error}")
        return report
    au_info = data.get("au_info")
    if not au_info:
        report["issues"].append("missing au_info")
        report["ok"] = False
        return report
    peaks = au_info.get("peak_frames") or []
    if not peaks:
        report["issues"].append("no peak_frames (emotion_peak sampling will fall back)")
    else:
        peak = peaks[0]
        for key in ("peak_index", "frames_before_peak", "frames_after_peak"):
            if key not in peak:
                report["issues"].append(f"peak_frames[0] missing {key}")
                report["ok"] = False
    if not (data.get("summary_description") or any(
        f.get("summary_description") for f in au_info.get("frames", [])
    )):
        report["issues"].append("no summary_description (AU text features unavailable)")
    return report


def check_feature_cache(feature_root: str, dataset: str, name: str) -> str:
    path = media.feature_cache_path(feature_root, dataset, "au", "CLIP_VIT_BASE32", name)
    if not os.path.exists(path):
        return f"missing AU feature cache: {path}"
    feats = np.load(path)
    if feats.ndim != 2 or feats.shape[1] != 512:
        return f"bad AU feature shape {feats.shape} (expected [N, 512]): {path}"
    if not np.isfinite(feats).all():
        return f"non-finite AU features: {path}"
    return ""


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--mer-factory-output", required=True)
    parser.add_argument("--feature-root", default=None)
    parser.add_argument("--dataset", default="MER2023")
    parser.add_argument("--nonverbal-json", default=None)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    setup_logger()

    json_paths = sorted(
        glob.glob(os.path.join(args.mer_factory_output, "*", "*_au_analysis.json"))
    )
    if args.limit:
        json_paths = json_paths[: args.limit]
    logger.info("found %d AU analysis files", len(json_paths))

    ok = bad = 0
    warnings = []
    for path in json_paths:
        report = check_au_json(path)
        if report["ok"]:
            ok += 1
        else:
            bad += 1
        for issue in report["issues"]:
            warnings.append(f"{os.path.basename(path)}: {issue}")
            logger.warning("%s: %s", os.path.basename(path), issue)
        if args.feature_root:
            name = os.path.basename(os.path.dirname(path))
            issue = check_feature_cache(args.feature_root, args.dataset, name)
            if issue:
                warnings.append(issue)
                logger.warning(issue)

    if args.nonverbal_json:
        try:
            with open(args.nonverbal_json) as handle:
                nonverbal = json.load(handle)
            total = sum(len(v) for v in nonverbal.values() if isinstance(v, dict))
            logger.info(
                "nonverbal json: %d datasets, %d captions", len(nonverbal), total
            )
        except Exception as error:
            warnings.append(f"nonverbal json unreadable: {error}")
            logger.warning("nonverbal json unreadable: %s", error)

    logger.info("AU pipeline check: %d ok, %d with blocking issues", ok, bad)
    return {"files": len(json_paths), "ok": ok, "bad": bad, "warnings": warnings}


if __name__ == "__main__":
    main()
