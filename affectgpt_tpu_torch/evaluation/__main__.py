"""Evaluation entry point: per-epoch zero-shot scores over result dirs.

    python -m affectgpt_tpu_torch.evaluation --input-dir <root>
        [--no-llm] [--cfg-path <yaml|json>] [--device cuda|cpu]

Port of the repo's root evaluation.py (reference:
AffectGPT/evaluation.py:199-281 main_zeroshot_scores): discover result
root → dataset class → ground truth → judge label extraction (with npz
caches) → per-epoch score → best-epoch report. The entry lives in the
package's `__main__` because the package and a module of the same name
would clash.

The judge is the LLM judge (evaluation/judge.py, on the port's decode
path) when the judge LLM's weight directory exists, else the deterministic
LexiconJudge with a warning, JAX's rule. The LLM goes to `--device`, the
card by default; without a card that raises (no fallback to the CPU).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os

import numpy as np

from affectgpt_tpu_torch import paths, registry
from affectgpt_tpu_torch.bootstrap import build_model
from affectgpt_tpu_torch.data.base_dataset import DatasetConfig, ModelDataConfig
from affectgpt_tpu_torch.data.datasets import get_dataset_class  # noqa: F401 (registers them)
from affectgpt_tpu_torch.evaluation import ew_metric
from affectgpt_tpu_torch.evaluation.judge import LexiconJudge, LLMJudge
from affectgpt_tpu_torch.evaluation.wheel import WheelMetrics
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.tokenization import ByteTokenizer
from affectgpt_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)

DISCRETE = {"MER2023", "MER2024", "MELD", "IEMOCAPFour"}
DIMENSION = {"CMUMOSI", "CMUMOSEI", "SIMS", "SIMSv2"}
DATASET_KEYS = {
    "mer2023": "MER2023", "mer2024": "MER2024", "meld": "MELD",
    "iemocapfour": "IEMOCAPFour", "cmumosi": "CMUMOSI",
    "cmumosei": "CMUMOSEI", "sims": "SIMS", "simsv2": "SIMSv2",
    "ovmerdplus": "OVMERDPlus",
}


def build_judge(use_llm: bool, judge_llm: str = "Qwen25", device="cuda"):
    """LLM judge when real weights exist, lexicon judge otherwise.

    `use_llm=True` with no pretrained weights mounted would hand label
    extraction to a RANDOM-weight LLM — garbage scores, silently. Guard:
    the LLM judge is only built when the weight dir actually exists;
    otherwise fall back to the deterministic LexiconJudge loudly. The LLM
    is loaded onto `device` (`resolve_device`: the card unless "cpu")."""
    if use_llm:
        llm_dir = paths.PATH_TO_LLM.get(judge_llm, "")
        if not (llm_dir and os.path.isdir(llm_dir)):
            logger.warning(
                "LLM judge requested but no pretrained %s weights at %r — a "
                "random-weight LLM would emit meaningless extractions; using "
                "the deterministic LexiconJudge instead (pass --no-llm to "
                "silence this warning)", judge_llm, llm_dir,
            )
        else:
            model_cfg, frozen, _, tokenizer = build_model(
                {"llama_model_name": judge_llm}, device=resolve_device(str(device)))
            return LLMJudge(frozen["llm"], model_cfg.llm, tokenizer)
    return LexiconJudge()


def main_zeroshot_scores(input_dir: str, use_llm: bool = True, judge=None, device="cuda"):
    """judge=None builds the default (LLM or lexicon) judge on `device`;
    entry-point variants pass their own (score-only cache stub, etc.)."""
    judge = judge if judge is not None else build_judge(use_llm, device=device)
    wheel = WheelMetrics()
    data_model_cfg = ModelDataConfig()

    results = {}
    for ds_dir in sorted(glob.glob(os.path.join(input_dir, "result-*"))):
        ds_key = os.path.basename(ds_dir)[len("result-"):]
        ds_name = DATASET_KEYS.get(ds_key, ds_key)
        # text only: the dataset reads its labels and touches no device
        dataset = registry.get("dataset", ds_name)(
            ByteTokenizer(), DatasetConfig(face_or_frame="textonly"), data_model_cfg,
            device="cpu")
        name2gt = dataset.get_test_name2gt()

        epoch_scores = []
        for epoch_npz in sorted(glob.glob(os.path.join(ds_dir, "*.npz"))):
            if epoch_npz.endswith("-openset.npz") or epoch_npz.endswith("-sentiment.npz"):
                continue
            if ds_name in DISCRETE:
                score, _ = ew_metric.score_discrete(epoch_npz, name2gt, judge, wheel)
            elif ds_name in DIMENSION:
                score, _ = ew_metric.score_dimension(epoch_npz, name2gt, judge)
            else:
                score, _, _ = ew_metric.score_ov(epoch_npz, name2gt, judge, wheel)
            epoch_scores.append((os.path.basename(epoch_npz), score))
            logger.info("%s %s score=%.4f", ds_name, os.path.basename(epoch_npz), score)
        if epoch_scores:
            best = max(epoch_scores, key=lambda kv: kv[1])
            results[ds_name] = best
            logger.info("%s BEST %s score=%.4f", ds_name, *best)

    if results:
        mean = float(np.mean([score for _, score in results.values()]))
        logger.info("MEAN over %d datasets: %.4f", len(results), mean)
    return results


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="AffectGPT evaluation (PyTorch)")
    parser.add_argument("--input-dir", required=True, help="result root holding result-* dirs")
    parser.add_argument("--no-llm", action="store_true",
                        help="use the deterministic lexicon judge instead of the LLM")
    parser.add_argument("--cfg-path", default=None,
                        help="experiment YAML or JSON; applies its `paths:` overrides so "
                        "ground-truth label files resolve (quality_run.sh)")
    parser.add_argument("--device", default="cuda",
                        help="where the LLM judge runs: cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logger()
    device = resolve_device(args.device)
    if args.cfg_path:
        from affectgpt_tpu_torch.config import Config

        Config.from_file(args.cfg_path)
    return main_zeroshot_scores(args.input_dir, use_llm=not args.no_llm, device=device)


if __name__ == "__main__":
    main()
