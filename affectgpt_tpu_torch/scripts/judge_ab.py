"""Judge A/B harness: LLMJudge vs LexiconJudge agreement on a captured
description set.

Port of scripts/judge_ab.py. The lexicon judge keeps evaluation runnable
without judge weights, but its bias must be quantified before it silently
shapes reported scores (reference extractor: toolkit/utils/qwen.py +
ew_metric.py:31-121 runs a vLLM-Qwen judge; the port's LLMJudge is the
equivalent, decoding on rows 1-2). This harness runs BOTH judges over the
same name→reason descriptions and reports:

- openset agreement: per-sample Jaccard overlap of the extracted label
  sets (after wheel backward-mapping, so synonyms don't count as
  disagreement), exact-set match rate, and per-judge label counts;
- sentiment agreement: exact match rate of positive/negative/neutral.

Usage:
    python -m affectgpt_tpu_torch.scripts.judge_ab --npz output/results/<exp>/result-<ds>/<e>.npz
    python -m affectgpt_tpu_torch.scripts.judge_ab --json captured_reasons.json [--device cpu]
Prints one JSON report line and exits 0.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from affectgpt_tpu_torch.data.datasets import string_to_list
from affectgpt_tpu_torch.evaluation.wheel import WheelMetrics


def load_reasons(npz: str | None, json_path: str | None) -> dict:
    if npz:
        return np.load(npz, allow_pickle=True)["name2reason"].tolist()
    with open(json_path) as f:
        return json.load(f)


def label_set(raw: str, wheel: WheelMetrics | None) -> frozenset:
    labels = [str(w).lower().strip() for w in string_to_list(raw)]
    if wheel is not None:
        # map through the wheel so synonyms agree ("joyful" vs "happy")
        mapped = wheel.map_labels(labels, "case3_wheel1_level1")
        if mapped:
            return frozenset(mapped)
    return frozenset(labels)


def compare_judges(name2reason: dict, judge_a, judge_b, wheel=None) -> dict:
    """Run both judges over the descriptions; returns the agreement report.
    judge_a/judge_b expose reason_to_openset + openset_to_sentiment."""
    names = sorted(name2reason)
    reasons = [name2reason[n] for n in names]
    open_a = judge_a.reason_to_openset(reasons)
    open_b = judge_b.reason_to_openset(reasons)
    sent_a = judge_a.openset_to_sentiment(open_a)
    sent_b = judge_b.openset_to_sentiment(open_b)

    jaccards, exact = [], 0
    count_a = count_b = 0
    for a, b in zip(open_a, open_b):
        sa, sb = label_set(a, wheel), label_set(b, wheel)
        count_a += len(sa)
        count_b += len(sb)
        if sa == sb:
            exact += 1
        union = sa | sb
        jaccards.append(len(sa & sb) / len(union) if union else 1.0)
    sent_match = sum(
        str(x).strip().lower() == str(y).strip().lower()
        for x, y in zip(sent_a, sent_b)
    )
    n = max(len(names), 1)
    return {
        "samples": len(names),
        "openset_jaccard_mean": round(float(np.mean(jaccards)) if jaccards else 1.0, 4),
        "openset_exact_match_rate": round(exact / n, 4),
        "labels_per_sample_a": round(count_a / n, 3),
        "labels_per_sample_b": round(count_b / n, 3),
        "sentiment_match_rate": round(sent_match / n, 4),
    }


def main(argv=None) -> dict:
    from affectgpt_tpu_torch.bootstrap import build_model
    from affectgpt_tpu_torch.evaluation.judge import LexiconJudge, LLMJudge

    parser = argparse.ArgumentParser(description="LLMJudge vs LexiconJudge A/B")
    parser.add_argument("--npz", default=None, help="inference result npz (name2reason)")
    parser.add_argument("--json", default=None, help="captured {name: reason} json")
    parser.add_argument("--no-wheel", action="store_true",
                        help="compare raw label strings (skip synonym mapping)")
    parser.add_argument("--max_new_tokens", type=int, default=512,
                        help="LLM-judge decode budget per prompt")
    parser.add_argument("--device", default="cuda", help="the LLM judge's device (cuda or cpu)")
    args = parser.parse_args(argv)
    if not (args.npz or args.json):
        parser.error("one of --npz / --json required")

    name2reason = load_reasons(args.npz, args.json)
    model_cfg, frozen, _, tokenizer = build_model({"llama_model_name": "Qwen25"},
                                                  device=args.device)
    llm_judge = LLMJudge(frozen["llm"], model_cfg.llm, tokenizer,
                         max_new_tokens=args.max_new_tokens)
    lexicon = LexiconJudge()
    wheel = None if args.no_wheel else WheelMetrics()

    report = compare_judges(name2reason, llm_judge, lexicon, wheel)
    print(json.dumps({"metric": "llm-vs-lexicon judge agreement", **report}))
    return report


if __name__ == "__main__":
    main()
