"""Evaluate Emotion-LLaMA (or any third-party MLLM) result dumps.

    python -m affectgpt_tpu_torch.evaluation_emotion_llama --input-dir <root>
        [--no-llm] [--device cuda|cpu]

Port of the repo's root evaluation_emotion_llama.py (reference:
AffectGPT/evaluation_Emotion-Llama.py): identical MER-UniBench scoring
over a results root produced by another model — the shared contract is
the `{epoch}.npz` name2reason / filenames+fileitems format, which the port
reads and writes identically. Output-format quirks of the baseline
(answer prefixes etc.) are normalized before judging. The LLM judge runs
on `--device`, the card by default (evaluation/__main__.py).
"""

from __future__ import annotations

import argparse
import re

from affectgpt_tpu_torch.evaluation import ew_metric
from affectgpt_tpu_torch.evaluation.__main__ import main_zeroshot_scores
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.utils.logging import setup_logger


def normalize_baseline_answer(text: str) -> str:
    """Strip common third-party output decorations before label extraction
    (the role of the reference's Emotion-LLaMA-specific parsing)."""
    text = str(text)
    text = re.sub(r"^\s*(answer|response|output)\s*[:：]\s*", "", text, flags=re.I)
    text = text.split("###")[0]
    return text.strip()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate third-party MLLM results (PyTorch)")
    parser.add_argument("--input-dir", required=True)
    parser.add_argument("--no-llm", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="where the LLM judge runs: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    setup_logger()
    device = resolve_device(args.device)
    ew_metric.set_reason_normalizer(normalize_baseline_answer)
    return main_zeroshot_scores(args.input_dir, use_llm=not args.no_llm, device=device)


if __name__ == "__main__":
    main()
