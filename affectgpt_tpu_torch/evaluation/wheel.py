"""Emotion-wheel open-vocabulary metrics.

Capability-parity with the reference wheel stack (reference:
my_affectgpt/evaluation/wheel.py:17-585): five 3-level emotion wheels →
253 canonical labels; GPT-generated synonym table (8 runs) → ~1255
labels; format augmentation (format.csv) → ~7386 surface forms; backward
mapping of arbitrary predicted words onto wheel clusters; set-overlap
precision/recall/F averaged over the 5 wheels (level1 is the headline
EW F-score); hitrate/mscore for one-hot datasets.

Redesign notes: mappings are built lazily inside a `WheelMetrics` object
(the reference builds them eagerly at module import, wheel.py:470-471),
xlsx assets are parsed with the stdlib reader (no openpyxl here), and
every mapping is cached.

The port's own copy of affectgpt_tpu/evaluation/wheel.py: format.csv is
read with `data/datasets.read_csv` (the csv module, typed as
`pandas.read_csv` types it: an empty `format` cell is NaN, which
`string_to_list` turns into no forms), and the default root is the port's
`paths.EMOTION_WHEEL_ROOT`, the vendored assets/emotion_wheel.
"""

from __future__ import annotations

import glob
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from affectgpt_tpu_torch import paths
from affectgpt_tpu_torch.data.datasets import read_csv, string_to_list
from affectgpt_tpu_torch.utils import xlsx

WHEELS = ("wheel1", "wheel2", "wheel3", "wheel4", "wheel5")
SYNONYM_RUNS = tuple(f"run{i}" for i in range(1, 9))


def _norm(label: str) -> str:
    return str(label).lower().strip()


def read_wheel_to_map(xlsx_path: str) -> Dict[str, Dict[str, List[str]]]:
    """3-level wheel sheet → {level1: {level2: [level3...]}} with
    forward-fill of merged cells (reference wheel.py:17-44)."""
    store: Dict[str, Dict[str, List[str]]] = {}
    level1 = level2 = level3 = ""
    for row in xlsx.read_dicts(xlsx_path):
        if row.get("level1"):
            level1 = row["level1"]
        if row.get("level2"):
            level2 = row["level2"]
        if row.get("level3"):
            level3 = row["level3"]
        l1, l2, l3 = _norm(level1), _norm(level2), _norm(level3)
        store.setdefault(l1, {}).setdefault(l2, []).append(l3)
    return store


def _merge_map(map1: dict, map2: dict) -> dict:
    merged = {}
    for key in set(map1) | set(map2):
        merged[key] = sorted(set(map1.get(key, [])) | set(map2.get(key, [])))
    return merged


class WheelMetrics:
    """Holds the label-space mappings and computes the EW metrics."""

    def __init__(self, wheel_root: Optional[str] = None):
        self.root = wheel_root or paths.EMOTION_WHEEL_ROOT

    # ----- label space construction ------------------------------------------------
    @lru_cache(maxsize=None)
    def wheel_map(self, wheel: str) -> Dict[str, Dict[str, List[str]]]:
        return read_wheel_to_map(os.path.join(self.root, f"{wheel}.xlsx"))

    def candidate_labels(self) -> List[str]:
        """All wheel words at all levels (253 in the shipped assets)."""
        labels: List[str] = []
        for path in glob.glob(os.path.join(self.root, "wheel*.xlsx")):
            store = read_wheel_to_map(path)
            for level1, level2s in store.items():
                for level2, level3s in level2s.items():
                    labels.extend([level1, level2, *level3s])
        return sorted(set(labels))

    @lru_cache(maxsize=None)
    def synonym_mapping(self) -> Dict[str, List[str]]:
        """surface word → wheel labels, merged over the 8 GPT synonym runs
        (reference wheel.py:87-135)."""
        synonym_path = os.path.join(self.root, "synonym.xlsx")
        rows = xlsx.read_dicts(synonym_path)
        wheel_labels = set(self.candidate_labels())
        merged: Dict[str, List[str]] = {}
        for run in SYNONYM_RUNS:
            run_map: Dict[str, List[str]] = {}
            for row in rows:
                raw = row.get(f"word_{run}")
                if raw is None:
                    continue
                raw = _norm(raw)
                if raw not in wheel_labels:
                    raise ValueError(f"synonym table word not on any wheel: {raw}")
                run_map.setdefault(raw, []).append(raw)
                for synonym in string_to_list(row.get(f"synonym_{run}") or ""):
                    run_map.setdefault(_norm(synonym), []).append(raw)
            merged = _merge_map(merged, run_map)
        return merged

    @lru_cache(maxsize=None)
    def format_mapping(self) -> Dict[str, List[str]]:
        """surface form → synonym-table words, from format.csv
        (reference wheel.py:205-237)."""
        csv_path = os.path.join(self.root, "format.csv")
        mapping: Dict[str, List[str]] = {}
        for row in read_csv(csv_path):
            raw = _norm(row["name"])
            for form in string_to_list(row.get("format", "")):
                mapping.setdefault(_norm(form), []).append(raw)
            mapping.setdefault(raw, []).append(raw)
        return mapping

    @lru_cache(maxsize=None)
    def wheel_cluster(self, wheel: str, level: str) -> Dict[str, str]:
        """wheel word → cluster centre at the given level
        (reference wheel.py:338-365)."""
        store = self.wheel_map(wheel)
        cluster: Dict[str, str] = {}
        if level == "level1":
            for level1, level2s in store.items():
                cluster[level1] = level1
                for level2, level3s in level2s.items():
                    cluster[level2] = level1
                    for level3 in level3s:
                        cluster[level3] = level1
        elif level == "level2":
            for level1, level2s in store.items():
                cluster[level1] = sorted(level2s)[0]
                for level2, level3s in level2s.items():
                    cluster[level2] = level2
                    for level3 in level3s:
                        cluster[level3] = level2
        else:
            raise ValueError(level)
        return cluster

    # ----- backward mapping -----------------------------------------------------------
    def backward(self, label: str, metric: str) -> str:
        """Map one predicted word back to the wheel label space
        (reference func_backward_case1/2/3, wheel.py:312-381)."""
        fmt = self.format_mapping()
        if label not in fmt:
            return ""
        stage1 = sorted(fmt[label])[0]
        if metric.startswith("case1"):
            return stage1
        syn = self.synonym_mapping()
        if metric.startswith("case2"):
            return sorted(syn[stage1])[0]
        # case3_{wheel}_{level}
        _, wheel, level = metric.split("_")
        cluster = self.wheel_cluster(wheel, level)
        level1_whole = [raw for form in fmt[label] for raw in syn[form]]
        for candidate in sorted(level1_whole):
            if candidate in cluster:
                return cluster[candidate]
        return ""

    def map_labels(self, labels: Iterable[str], metric: str) -> List[str]:
        out = []
        for label in labels:
            mapped = self.backward(_norm(label), metric)
            if mapped:
                out.append(mapped)
        return out

    # ----- metrics ---------------------------------------------------------------------
    def overlap_rate(
        self, name2gt: Dict[str, str], name2pred: Dict[str, str], metric: str,
        process_names: Optional[Sequence[str]] = None,
    ) -> Tuple[float, float]:
        """Per-sample set-overlap precision/recall after backward mapping
        (reference calculate_openset_overlap_rate, wheel.py:400-470)."""
        names = process_names if process_names is not None else list(name2gt)
        precision, recall = [], []
        for name in names:
            gt = set(self.map_labels(string_to_list(name2gt[name]), metric))
            pred = set(self.map_labels(string_to_list(name2pred[name]), metric))
            if not gt:
                continue
            if not pred:
                precision.append(0.0)
                recall.append(0.0)
            else:
                precision.append(len(gt & pred) / len(pred))
                recall.append(len(gt & pred) / len(gt))
        if not precision:
            return 0.0, 0.0
        return float(np.mean(precision)), float(np.mean(recall))

    def wheel_metric(
        self, name2gt: Dict[str, str], name2pred: Dict[str, str],
        process_names: Optional[Sequence[str]] = None, level: str = "level1",
    ) -> Tuple[float, float, float]:
        """The headline EW score: mean (F, precision, recall) over the five
        wheels at the given level (reference wheel_metric_calculation,
        wheel.py:473-523)."""
        scores = []
        for wheel in WHEELS:
            p, r = self.overlap_rate(name2gt, name2pred, f"case3_{wheel}_{level}", process_names)
            f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
            scores.append([f, p, r])
        return tuple(np.mean(scores, axis=0).tolist())  # type: ignore[return-value]

    def onehot_hitrate(
        self, name2gt: Dict[str, str], name2pred: Dict[str, str], metric: str,
    ) -> Tuple[float, float]:
        """Hitrate / mscore for discrete-label datasets (reference
        calculate_openset_onehot_hitrate, wheel.py:525-585)."""
        candidate_labels = sorted(set(name2gt.values()))
        hitrates, mscores = [], []
        for name in name2gt:
            gt = set(self.map_labels(string_to_list(name2gt[name]), metric))
            if not gt:
                continue
            pred = set(self.map_labels(string_to_list(name2pred[name]), metric))
            candidates = set(self.map_labels(candidate_labels, metric))
            hitrates.append(len(pred & gt))
            denom = len(pred & candidates)
            mscores.append(len(pred & gt) / denom if denom else 0.0)
        if not hitrates:
            return 0.0, 0.0
        return float(np.mean(hitrates)), float(np.mean(mscores))

    def hit_or_not_single(self, gt_ov, pred_ov, metric: str) -> bool:
        """EMERCoarse filter predicate under ONE metric: do gt and pred
        share at least one wheel cluster after backward mapping? Empty
        sides count as neutral; a raw 'neutral' item survives mapping
        (reference func_hit_or_not, wheel.py:588-632)."""

        def prep(ov) -> set:
            items = string_to_list(ov)
            if not items:
                return {"neutral"}
            mapped = set(self.map_labels(items, metric))
            if "neutral" in items:
                mapped.add("neutral")
            return mapped

        return len(prep(gt_ov) & prep(pred_ov)) >= 1

    def hit_or_not(self, gt_ov, pred_ov, level: str = "level1") -> bool:
        """Any-wheel hit at the given level — the predicate the reference
        uses to build the EMERCoarseFilter corpus (ew_metric.py:199-210)."""
        return any(
            self.hit_or_not_single(gt_ov, pred_ov, f"case3_{wheel}_{level}")
            for wheel in WHEELS
        )

    def hitrate_metric(
        self, name2gt: Dict[str, str], name2pred: Dict[str, str], level: str = "level1",
    ) -> float:
        """Mean mscore over the five wheels — the 'Basic' MER-UniBench
        metric used for one-hot datasets (reference ew_metric.py:177-197)."""
        scores = []
        for wheel in WHEELS:
            _, mscore = self.onehot_hitrate(name2gt, name2pred, f"case3_{wheel}_{level}")
            scores.append(mscore)
        return float(np.mean(scores))
