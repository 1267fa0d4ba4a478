"""Compare two inference result dumps (ours vs the reference's).

    python -m affectgpt_tpu_torch.compare_outputs --ours out/result-mer2023/5.npz \
        --reference ref/result-mer2023/5.npz [--no-llm] [--device cuda|cpu]

Port of the repo's root compare_outputs.py: takes two `{epoch}.npz`
result files (name2reason or filenames/fileitems format — both sides use
the same contract) and reports per-sample text agreement plus label-level
agreement after judge extraction, so greedy-decode parity against the
reference can be quantified (SURVEY §7 'bit-comparable labels' is defined
at fixed-seed/greedy + metric-level equivalence). The judge is
evaluation/__main__.py's `build_judge` on `--device`, the card by default.
Returns the report as a dict.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from affectgpt_tpu_torch.data.datasets import string_to_list
from affectgpt_tpu_torch.evaluation.__main__ import build_judge
from affectgpt_tpu_torch.evaluation.ew_metric import load_name2reason
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ours", required=True)
    parser.add_argument("--reference", required=True)
    parser.add_argument("--no-llm", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="where the LLM judge runs: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    setup_logger()
    device = resolve_device(args.device)

    ours = load_name2reason(args.ours)
    ref = load_name2reason(args.reference)
    common = sorted(set(ours) & set(ref))
    logger.info("%d common clips (%d ours, %d reference)", len(common), len(ours), len(ref))
    if not common:
        return {"common": 0}

    exact = sum(str(ours[n]).strip() == str(ref[n]).strip() for n in common)
    logger.info("exact text match: %d/%d (%.1f%%)", exact, len(common), 100 * exact / len(common))

    # label-level agreement through the judge
    judge = build_judge(use_llm=not args.no_llm, device=device)
    ours_labels = judge.reason_to_openset([str(ours[n]) for n in common])
    ref_labels = judge.reason_to_openset([str(ref[n]) for n in common])

    agree, jaccard = 0, []
    for a, b in zip(ours_labels, ref_labels):
        sa, sb = set(string_to_list(a)), set(string_to_list(b))
        agree += sa == sb
        union = sa | sb
        jaccard.append(len(sa & sb) / len(union) if union else 1.0)
    logger.info(
        "label-set agreement: %d/%d exact, mean Jaccard %.3f",
        agree, len(common), float(np.mean(jaccard)),
    )
    return {"common": len(common), "exact_text": exact, "label_sets_equal": agree,
            "mean_jaccard": float(np.mean(jaccard)), "ours_labels": ours_labels,
            "reference_labels": ref_labels}


if __name__ == "__main__":
    main()
