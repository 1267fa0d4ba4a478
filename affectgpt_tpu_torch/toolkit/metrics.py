"""MERBench-style metrics for the traditional fusion baselines.

Port of affectgpt_tpu/toolkit/metrics.py (reference:
toolkit/utils/metric.py:1-100): weighted-average F1 / accuracy for
discrete emotions, MSE + Pearson correlation for valence, and the
combined MER metric used to pick checkpoints. Accuracy and weighted F1 are
the port's numpy versions of sklearn's (`evaluation/ew_metric.py`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from affectgpt_tpu_torch.evaluation.ew_metric import accuracy_score, weighted_f1_score


def emotion_metrics(labels: np.ndarray, logits: np.ndarray) -> Dict[str, float]:
    preds = np.asarray(logits).argmax(-1)
    labels = np.asarray(labels)
    return {
        "emo_accuracy": float(accuracy_score(labels, preds)),
        "emo_waf1": float(weighted_f1_score(labels, preds)),
    }


def valence_metrics(labels: np.ndarray, preds: np.ndarray) -> Dict[str, float]:
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds).reshape(-1)
    mse = float(np.mean((labels - preds) ** 2))
    if labels.std() > 0 and preds.std() > 0:
        pcc = float(np.corrcoef(labels, preds)[0, 1])
    else:
        pcc = 0.0
    return {"val_mse": mse, "val_pcc": pcc}


def combined_metric(emo_waf1: float, val_mse: float) -> float:
    """The reference's checkpoint-selection combination (higher is better):
    f1 - mse/4 (toolkit overall_metric convention)."""
    return emo_waf1 - val_mse / 4.0
