"""Score-only evaluation: reuse cached judge outputs, never invoke an LLM.

    python -m affectgpt_tpu_torch.evaluation_scoreonly --input-dir <root>

Port of the repo's root evaluation_scoreonly.py (reference:
AffectGPT/evaluation-scoreonly.py): identical scoring flow, but the
judge is replaced by a cache-only stub that raises if any `*-openset.npz`
/ `*-sentiment.npz` artifact is missing — run
`python -m affectgpt_tpu_torch.evaluation` once first (or reuse artifacts
produced by the JAX package or the reference; the npz format matches).
No model is built and no device is touched.
"""

from __future__ import annotations

import argparse

from affectgpt_tpu_torch.evaluation.__main__ import main_zeroshot_scores
from affectgpt_tpu_torch.utils.logging import setup_logger


class CacheOnlyJudge:
    def _missing(self, *_args, **_kwargs):
        raise RuntimeError(
            "score-only mode: judge cache missing — run python -m "
            "affectgpt_tpu_torch.evaluation (LLM or --no-llm) once to materialize "
            "*-openset.npz / *-sentiment.npz"
        )

    reason_to_openset = _missing
    openset_to_sentiment = _missing
    openset_to_onehot = _missing


def main(argv=None):
    parser = argparse.ArgumentParser(description="AffectGPT score-only evaluation (PyTorch)")
    parser.add_argument("--input-dir", required=True)
    args = parser.parse_args(argv)
    setup_logger()
    return main_zeroshot_scores(args.input_dir, use_llm=False, judge=CacheOnlyJudge())


if __name__ == "__main__":
    main()
