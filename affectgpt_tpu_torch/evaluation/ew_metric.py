"""Dataset-level scoring: description npz → judge extraction → wheel/
sentiment/hitrate metrics.

Capability-parity with the reference scorers (reference:
my_affectgpt/evaluation/ew_metric.py:31-210 and evaluation.py:126-196):
- discrete datasets → hitrate/mscore over the 5 wheels,
- valence datasets → openset → sentiment → binary F1/accuracy on
  non-zero ground truth,
- OV datasets → EW F-score (mean over 5 wheels at level1).
Judge npz caches (`*-openset.npz`, `*-sentiment.npz`) use the same
filenames/fileitems format so cached reference artifacts interoperate.

The port's own copy of affectgpt_tpu/evaluation/ew_metric.py; the binary
F1 and accuracy of `score_dimension` are computed in numpy with sklearn's
definitions (`accuracy_score`; `f1_score(average="weighted")`: per-label
F1 = 2·tp / (2·tp + fp + fn), 0 where that denominator is 0, averaged
over the labels of either side weighted by their support in the ground
truth), since the card has no sklearn.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from affectgpt_tpu_torch.evaluation.wheel import WheelMetrics


# Optional hook applied to every loaded reason string before judging —
# third-party result dumps (e.g. Emotion-LLaMA) carry answer decorations
# that must be stripped (reference evaluation_Emotion-Llama.py's parsing).
# Set via set_reason_normalizer(); None = identity.
_REASON_NORMALIZER = None


def set_reason_normalizer(fn) -> None:
    global _REASON_NORMALIZER
    _REASON_NORMALIZER = fn


def load_name2reason(npz_path: str) -> Dict[str, str]:
    data = np.load(npz_path, allow_pickle=True)
    if "name2reason" in data:
        out = dict(data["name2reason"].tolist())
    else:
        out = dict(zip(data["filenames"].tolist(), data["fileitems"].tolist()))
    if _REASON_NORMALIZER is not None:
        out = {k: _REASON_NORMALIZER(v) for k, v in out.items()}
    return out


def save_filenames_npz(path: str, name2item: Dict[str, str]) -> None:
    np.savez_compressed(
        path, filenames=list(name2item), fileitems=[name2item[n] for n in name2item]
    )


def extract_openset(epoch_npz: str, judge) -> Dict[str, str]:
    """description npz → cached openset npz via the judge (reference
    ew_metric.py:31-83)."""
    openset_npz = epoch_npz[:-4] + "-openset.npz"
    if not os.path.exists(openset_npz):
        name2reason = load_name2reason(epoch_npz)
        names = list(name2reason)
        responses = judge.reason_to_openset([name2reason[n] for n in names])
        save_filenames_npz(openset_npz, dict(zip(names, responses)))
    data = np.load(openset_npz, allow_pickle=True)
    return dict(zip(data["filenames"].tolist(), data["fileitems"].tolist()))


def extract_sentiment(epoch_npz: str, judge) -> Dict[str, str]:
    name2openset = extract_openset(epoch_npz, judge)
    sentiment_npz = epoch_npz[:-4] + "-openset-sentiment.npz"
    if not os.path.exists(sentiment_npz):
        names = list(name2openset)
        responses = judge.openset_to_sentiment([name2openset[n] for n in names])
        save_filenames_npz(sentiment_npz, dict(zip(names, responses)))
    data = np.load(sentiment_npz, allow_pickle=True)
    return dict(zip(data["filenames"].tolist(), data["fileitems"].tolist()))


def accuracy_score(y_true, y_pred) -> float:
    """The share of equal labels (sklearn's `accuracy_score`)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.average(y_true == y_pred))


def weighted_f1_score(y_true, y_pred) -> float:
    """sklearn's `f1_score(y_true, y_pred, average="weighted")`: each label
    of either side gets F1 = 2·tp / (2·tp + fp + fn) (0 where the
    denominator is 0, sklearn's zero_division default), and the labels'
    scores are averaged with their ground-truth counts as weights (a label
    only predicted weighs nothing)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels], np.float64)
    fp = np.array([np.sum((y_true != c) & (y_pred == c)) for c in labels], np.float64)
    fn = np.array([np.sum((y_true == c) & (y_pred != c)) for c in labels], np.float64)
    support = tp + fn
    denom = 2 * tp + fp + fn
    f1 = np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    if support.sum() == 0:
        return 0.0
    return float(np.average(f1, weights=support))


def score_discrete(
    epoch_npz: str, name2gt: Dict[str, str], judge, wheel: Optional[WheelMetrics] = None,
) -> Tuple[float, float]:
    """(hitrate-ish mscore) for one-hot datasets (evaluation.py:126-134)."""
    wheel = wheel or WheelMetrics()
    name2pred = extract_openset(epoch_npz, judge)
    mscore = wheel.hitrate_metric(name2gt, name2pred)
    return mscore, mscore


def score_ov(
    epoch_npz: str, name2gt: Dict[str, str], judge, wheel: Optional[WheelMetrics] = None,
) -> Tuple[float, float, float]:
    """EW (F, precision, recall) for open-vocabulary datasets
    (evaluation.py:137-152)."""
    wheel = wheel or WheelMetrics()
    name2pred = extract_openset(epoch_npz, judge)
    return wheel.wheel_metric(name2gt, name2pred)


def score_dimension(
    epoch_npz: str, name2gt: Dict[str, float], judge,
) -> Tuple[float, float]:
    """Binary F1/accuracy on non-zero valence gt (evaluation.py:156-196)."""
    name2sent = extract_sentiment(epoch_npz, judge)
    sent_to_val = {"positive": 1, "negative": -1, "neutral": 0}
    labels, preds = [], []
    for name, gt in name2gt.items():
        labels.append(gt)
        preds.append(sent_to_val.get(str(name2sent.get(name, "neutral")).strip().lower(), 0))
    labels = np.array(labels)
    preds = np.array(preds)
    nonzero = labels != 0
    if not np.any(nonzero):
        return 0.0, 0.0
    acc = accuracy_score(labels[nonzero] > 0, preds[nonzero] > 0)
    f1 = weighted_f1_score(labels[nonzero] > 0, preds[nonzero] > 0)
    return float(f1), float(acc)
