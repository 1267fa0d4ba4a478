"""Dataset normalizers: raw corpus → the processed on-disk contract.

Capability-parity with the reference's per-corpus preprocessors
(reference: toolkit/preprocess/{mer2023,iemocap,cmumosei,meld,sims,...}.py,
e.g. preprocess/mer2023.py:8-60): each raw corpus is normalized into
  {root}/video/{name}.mp4 (or sub* dirs), {root}/audio/{name}.wav,
  {root}/label*.npz with {split}_corpus dicts, and a transcription csv —
the layout every dataset class consumes (paths.py tables).

The port's own copy of affectgpt_tpu/data/normalize.py: the
corpus-agnostic building blocks (the reference repeats them per corpus)
and recipes for the label npz, the transcription csv (written with `csv`,
in the layout of a pandas `to_csv(index=False)`) and split generation.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np


def write_label_npz(
    save_path: str,
    splits: Dict[str, Dict[str, dict]],
) -> None:
    """splits: {'train_corpus': {name: {'emo': ... , 'val': ...}}, ...} →
    the npz format all OneHot/Valence dataset classes read."""
    np.savez(
        save_path,
        **{split: np.array(corpus, dtype=object) for split, corpus in splits.items()},
    )


def write_transcriptions(
    save_path: str,
    name2english: Dict[str, str],
    name2chinese: Optional[Dict[str, str]] = None,
) -> None:
    """Emit the transcription csv contract (columns: name, english[, chinese]).
    A missing value (None or NaN, what the csv reader gives an empty cell)
    is written as an empty cell, as pandas' to_csv writes it."""
    columns = ["name", "english"] + (["chinese"] if name2chinese is not None else [])

    def cell(value):
        missing = value is None or (isinstance(value, float) and math.isnan(value))
        return "" if missing else value

    with open(save_path, "w", newline="") as handle:
        writer = csv.writer(handle, lineterminator="\n")
        writer.writerow(columns)
        for name, english in name2english.items():
            row = [cell(name), cell(english)]
            if name2chinese is not None:
                row.append(cell(name2chinese.get(name, "")))
            writer.writerow(row)


def split_by_ratio(
    names: Sequence[str], train_ratio: float = 0.8, seed: int = 0
) -> Dict[str, List[str]]:
    rng = np.random.RandomState(seed)
    order = list(names)
    rng.shuffle(order)
    cut = int(len(order) * train_ratio)
    return {"train": order[:cut], "test": order[cut:]}


def normalize_corpus(
    root: str,
    samples: Iterable[dict],
    label_fn: Callable[[dict], dict],
    name_fn: Callable[[dict], str] = lambda s: s["name"],
    subtitle_fn: Optional[Callable[[dict], str]] = None,
    split_fn: Optional[Callable[[dict], str]] = None,
    label_filename: str = "label.npz",
) -> Dict[str, int]:
    """Generic normalizer: builds label npz + transcription csv under
    `root` from an iterable of raw sample records. Media files are expected
    to be placed/symlinked by the caller (codec work is corpus-specific).

    label_fn(sample) → {'emo': ...} and/or {'val': ...};
    split_fn(sample) → 'train' | 'test' (defaults to 'train').
    """
    os.makedirs(root, exist_ok=True)
    corpora: Dict[str, Dict[str, dict]] = {}
    name2english: Dict[str, str] = {}
    for sample in samples:
        name = name_fn(sample)
        split = (split_fn(sample) if split_fn else "train") + "_corpus"
        corpora.setdefault(split, {})[name] = label_fn(sample)
        if subtitle_fn is not None:
            name2english[name] = subtitle_fn(sample)
    write_label_npz(os.path.join(root, label_filename), corpora)
    if name2english:
        write_transcriptions(
            os.path.join(root, "transcription-engchi-polish.csv"), name2english
        )
    return {split: len(corpus) for split, corpus in corpora.items()}
