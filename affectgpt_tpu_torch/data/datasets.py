"""The 12 emotion corpora as three parameterized dataset families.

The port's own copy of affectgpt_tpu/data/datasets.py, with the
capabilities of the reference's one-class-per-file dataset zoo
(reference: my_affectgpt/datasets/datasets/{mercaptionplus_dataset,
ovmerd_dataset,ovmerdplus_dataset,mer2025ov_dataset,mer2023,mer2024,
meld,iemocap,cmumosi,cmumosei,sims,simsv2}.py) with the same annotation
artifacts, path layouts, candidate labels and inference helpers
(read_test_names / get_test_name2gt / get_emo2idx_idx2emo), but factored
into three label families instead of 13 near-identical classes:

- OVDataset:      open-vocabulary labels + descriptions (MERCaptionPlus,
                  OVMERD, OVMERDPlus, MER2025OV[test-only])
- OneHotDataset:  discrete labels from .npz corpora (MER2023, MER2024,
                  MELD, IEMOCAPFour with Ses05 held out)
- ValenceDataset: continuous valence + derived sentiment (CMUMOSI,
                  CMUMOSEI, SIMS, SIMSv2)

The CSV annotations are read with the standard library's `csv` into the
values the JAX package's `pandas.read_csv` gives (`read_csv`): an empty
cell or a pandas NA marker ("NA", "None", "nan", ...) is NaN, a quoted
comma stays inside its cell, and a column whose every other cell is an
integer, a float or a boolean comes back as numbers (integers turn into
floats beside a NaN, as in a float64 column).
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Optional

import numpy as np

from affectgpt_tpu_torch import paths, registry
from affectgpt_tpu_torch.data.base_dataset import BaseDataset

# pandas.read_csv's default NA markers
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")
_INT_CELL = re.compile(r"^[-+]?[0-9]+$")


def is_na(value) -> bool:
    """pandas.isna for one scalar: None and NaN."""
    return value is None or (isinstance(value, float) and math.isnan(value))


def _float_cell(text: str):
    if "_" in text:
        return None
    try:
        return float(text)
    except ValueError:
        return None


def _column(cells: List[str]) -> list:
    """One column's cells typed as pandas infers the column's dtype."""
    na = [c in NA_VALUES for c in cells]
    present = [c for c, missing in zip(cells, na) if not missing]
    nan = float("nan")
    if not present:
        return [nan] * len(cells)
    if all(_INT_CELL.match(c) for c in present):
        conv = (lambda c: float(int(c))) if any(na) else int
    elif all(_float_cell(c) is not None for c in present):
        conv = float
    elif all(c in _TRUE or c in _FALSE for c in present):
        conv = lambda c: c in _TRUE  # noqa: E731
    else:
        conv = str
    return [nan if missing else conv(c) for c, missing in zip(cells, na)]


def read_csv(path: str) -> List[dict]:
    """The rows of a CSV with a header line as dicts of typed values,
    `pandas.read_csv(path).to_dict("records")`'s result (see the module
    docstring)."""
    with open(path, newline="") as handle:
        table = list(csv.reader(handle))
    if not table:
        return []
    header, body = table[0], [row for row in table[1:] if row]
    columns = {name: _column([row[i] if i < len(row) else "" for row in body])
               for i, name in enumerate(header)}
    return [{name: columns[name][r] for name in header} for r in range(len(body))]


def string_to_list(value) -> List[str]:
    """Parse "['happy', 'sad']"-style label strings (reference:
    toolkit/utils/functions.py:609)."""
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, list):
        return value
    if value == "" or (not isinstance(value, str) and is_na(value)):
        return []
    text = str(value)
    if text.startswith("["):
        text = text[1:]
    if text.endswith("]"):
        text = text[:-1]
    return [item.strip() for item in re.split("['\",]", text) if item.strip() not in ("", ",")]


def _read_subtitles(dataset: str, column: str = "english") -> Dict[str, str]:
    name2subtitle: Dict[str, str] = {}
    for row in read_csv(paths.PATH_TO_TRANSCRIPTIONS[dataset]):
        subtitle = row[column]
        name2subtitle[row["name"]] = "" if is_na(subtitle) else subtitle
    return name2subtitle


def _read_name_column_csv(path: str, key: str, value: str) -> Dict[str, str]:
    return {row[key]: row[value] for row in read_csv(path)}


def _check_test_count(dataset: str, names: List[str], expected: Optional[int]) -> None:
    """The reference hard-asserts official split sizes (e.g. 411 MER2023
    clips, mer2023.py:124); we warn instead so subsets/synthetic corpora
    remain usable."""
    if expected is not None and len(names) != expected:
        import logging

        logging.getLogger(__name__).warning(
            "%s: official test split has %d clips, found %d", dataset, expected, len(names)
        )


def map_valence_to_sentiment(valence: float) -> str:
    if valence > 0:
        return "positive"
    if valence < 0:
        return "negative"
    return "neutral"


class MediaPathsMixin:
    """Standard media layout: video/<name>.mp4, audio/<name>.wav,
    openface_face/<name>[.npy | /<name>.npy]."""

    face_in_subdir = False
    video_ext = ".mp4"

    def _get_video_path(self, sample):
        return os.path.join(paths.PATH_TO_RAW_VIDEO[self.dataset], sample["name"] + self.video_ext)

    def _get_audio_path(self, sample):
        return os.path.join(paths.PATH_TO_RAW_AUDIO[self.dataset], sample["name"] + ".wav")

    def _get_face_path(self, sample):
        root = paths.PATH_TO_RAW_FACE[self.dataset]
        if self.face_in_subdir:
            return os.path.join(root, sample["name"], sample["name"] + ".npy")
        return os.path.join(root, sample["name"] + ".npy")


# ---------------------------------------------------------------------------
# Open-vocabulary family


class OVDataset(MediaPathsMixin, BaseDataset):
    """description + ovlabel training corpora (reference
    mercaptionplus_dataset.py:25-115, ovmerd_dataset.py)."""

    dataset: str = ""
    openset_csv: str = ""
    description_csv: str = ""
    subtitle_column: str = "english"
    face_in_subdir = True

    def __init__(self, tokenizer, dataset_cfg, model_cfg, seed: int = 0, device="cuda"):
        name2subtitle = _read_subtitles(self.dataset, self.subtitle_column)
        self.name2subtitle = name2subtitle

        root = paths.DATA_DIR[self.dataset]
        name2openset: Dict[str, str] = {}
        if self.openset_csv:
            raw = _read_name_column_csv(os.path.join(root, self.openset_csv), "name", "openset")
            for name, openset in raw.items():
                labels = string_to_list(openset) or ["neutral"]
                name2openset[name] = ", ".join(labels)
        self.name2openset = name2openset

        name2reason: Dict[str, str] = {}
        if self.description_csv:
            name2reason = _read_name_column_csv(
                os.path.join(root, self.description_csv), "name", "reason"
            )
        self.name2reason = name2reason

        self.annotation = [
            {
                "name": name,
                "subtitle": name2subtitle.get(name, ""),
                "description": name2reason.get(name, ""),
                "ovlabel": ov,
            }
            for name, ov in name2openset.items()
        ]
        self.label_type_candidates = (
            ["description", "ovlabel"] if self.description_csv else ["ovlabel"]
        )
        super().__init__(tokenizer, dataset_cfg, model_cfg, seed, device)

    def read_test_names(self) -> List[str]:
        raise NotImplementedError(f"{self.dataset} has no test split helper")

    def get_test_name2gt(self) -> Dict[str, str]:
        return self.name2openset


@registry.register_dataset("MERCaptionPlus")
class MERCaptionPlusDataset(OVDataset):
    dataset = "MERCaptionPlus"
    openset_csv = "track2_train_mercaptionplus.csv"
    description_csv = "track3_train_mercaptionplus.csv"


@registry.register_dataset("OVMERD")
class OVMERDDataset(OVDataset):
    dataset = "OVMERD"
    openset_csv = "track2_train_ovmerd.csv"
    description_csv = "track3_train_ovmerd.csv"


@registry.register_dataset("OVMERDPlus")
class OVMERDPlusDataset(OVDataset):
    dataset = "OVMERDPlus"
    openset_csv = "ovlabel.csv"
    description_csv = ""
    subtitle_column = "sentence"
    face_in_subdir = False  # flat layout (reference ovmerdplus_dataset.py:91-94)

    def read_test_names(self) -> List[str]:
        return [row["name"] for row in read_csv(paths.PATH_TO_TRANSCRIPTIONS[self.dataset])]


@registry.register_dataset("MER2025OV")
class MER2025OVDataset(OVDataset):
    """Test-only: 20k candidate clips, no train labels (reference
    mer2025ov_dataset.py:113-169)."""

    dataset = "MER2025OV"
    openset_csv = ""
    description_csv = ""

    def read_test_names(self) -> List[str]:
        label_csv = os.path.join(paths.DATA_DIR[self.dataset], "track_all_candidates.csv")
        return [row["name"] for row in read_csv(label_csv)]


# ---------------------------------------------------------------------------
# One-hot family


class OneHotDataset(MediaPathsMixin, BaseDataset):
    """Discrete-label corpora stored as .npz {split}_corpus dicts
    (reference mer2023.py:29-143, mer2024.py, meld.py)."""

    dataset: str = ""
    train_key: str = "train_corpus"
    test_key: str = "test_corpus"
    expected_test_count: Optional[int] = None

    def __init__(self, tokenizer, dataset_cfg, model_cfg, seed: int = 0, device="cuda"):
        label_path = paths.PATH_TO_LABEL[self.dataset]
        corpus = np.load(label_path, allow_pickle=True)[self.train_key].tolist()
        train_names = list(corpus)
        train_emos = [corpus[name]["emo"] for name in corpus]
        self.name2subtitle = _read_subtitles(self.dataset)

        self.annotation = [
            {"name": name, "subtitle": self.name2subtitle.get(name, ""), "onehot": emo}
            for name, emo in zip(train_names, train_emos)
        ]
        self.candidate_labels = ",".join(sorted(set(train_emos)))
        self.label_type_candidates = ["onehot_w_candidates", "onehot_wo_candidates"]
        super().__init__(tokenizer, dataset_cfg, model_cfg, seed, device)

    def _test_corpus(self) -> dict:
        return np.load(paths.PATH_TO_LABEL[self.dataset], allow_pickle=True)[self.test_key].tolist()

    def read_test_names(self) -> List[str]:
        names = list(self._test_corpus())
        _check_test_count(self.dataset, names, self.expected_test_count)
        return names

    def get_test_name2gt(self) -> Dict[str, str]:
        corpus = self._test_corpus()
        return {name: corpus[name]["emo"] for name in corpus}

    def get_emo2idx_idx2emo(self):
        labels = string_to_list(self.candidate_labels)
        emo2idx = {emo: i for i, emo in enumerate(labels)}
        return emo2idx, {i: emo for emo, i in emo2idx.items()}


@registry.register_dataset("MER2023")
class MER2023Dataset(OneHotDataset):
    dataset = "MER2023"
    test_key = "test1_corpus"
    expected_test_count = 411


@registry.register_dataset("MER2024")
class MER2024Dataset(OneHotDataset):
    dataset = "MER2024"
    test_key = "test1_corpus"
    expected_test_count = 1169


@registry.register_dataset("MELD")
class MELDDataset(OneHotDataset):
    dataset = "MELD"
    expected_test_count = 2610


IEMOCAP_EMOS = ("happy", "sad", "neutral", "anger")


@registry.register_dataset("IEMOCAPFour")
class IEMOCAPFourDataset(MediaPathsMixin, BaseDataset):
    """Four-way IEMOCAP with Ses05 held out (reference
    iemocap.py:30-163): whole_corpus with integer emo ids, Ses01-Ses04
    train / Ses05 test."""

    dataset = "IEMOCAPFour"
    video_ext = ".mp4"

    def __init__(self, tokenizer, dataset_cfg, model_cfg, seed: int = 0, device="cuda"):
        corpus = np.load(paths.PATH_TO_LABEL[self.dataset], allow_pickle=True)[
            "whole_corpus"
        ].tolist()
        idx2emo = dict(enumerate(IEMOCAP_EMOS))
        names = list(corpus)
        emos = [idx2emo[corpus[name]["emo"]] for name in corpus]

        # the recording number is the 5th character of the clip name (reference :102-120)
        is_test = [int(name[4]) - 1 == 4 for name in names]
        self.test_names = [n for n, t in zip(names, is_test) if t]
        self.test_emos = [e for e, t in zip(emos, is_test) if t]
        train_names = [n for n, t in zip(names, is_test) if not t]
        train_emos = [e for e, t in zip(emos, is_test) if not t]

        self.name2subtitle = _read_subtitles(self.dataset)
        self.annotation = [
            {"name": name, "subtitle": self.name2subtitle.get(name, ""), "onehot": emo}
            for name, emo in zip(train_names, train_emos)
        ]
        self.candidate_labels = ",".join(IEMOCAP_EMOS)
        self.label_type_candidates = ["onehot_w_candidates", "onehot_wo_candidates"]
        super().__init__(tokenizer, dataset_cfg, model_cfg, seed, device)

    def read_test_names(self) -> List[str]:
        return list(self.test_names)

    def get_test_name2gt(self) -> Dict[str, str]:
        return dict(zip(self.test_names, self.test_emos))

    def get_emo2idx_idx2emo(self):
        emo2idx = {emo: i for i, emo in enumerate(IEMOCAP_EMOS)}
        return emo2idx, dict(enumerate(IEMOCAP_EMOS))


# ---------------------------------------------------------------------------
# Valence family


class ValenceDataset(MediaPathsMixin, BaseDataset):
    """Continuous-valence corpora (reference cmumosi.py:29-133, sims.py,
    simsv2.py, cmumosei.py): train/test corpora with 'val', sentiment
    derived by sign, valence range from the train labels."""

    dataset: str = ""
    expected_test_count: Optional[int] = None

    def __init__(self, tokenizer, dataset_cfg, model_cfg, seed: int = 0, device="cuda"):
        corpus = np.load(paths.PATH_TO_LABEL[self.dataset], allow_pickle=True)[
            "train_corpus"
        ].tolist()
        train_names = list(corpus)
        train_vals = [float(corpus[name]["val"]) for name in corpus]
        self.name2subtitle = _read_subtitles(self.dataset)
        self.annotation = [
            {
                "name": name,
                "subtitle": self.name2subtitle.get(name, ""),
                "valence": val,
                "sentiment": map_valence_to_sentiment(val),
            }
            for name, val in zip(train_names, train_vals)
        ]
        self.label_type_candidates = ["valence", "sentiment"]
        self.minval = min(train_vals)
        self.maxval = max(train_vals)
        super().__init__(tokenizer, dataset_cfg, model_cfg, seed, device)

    def read_test_names(self) -> List[str]:
        corpus = np.load(paths.PATH_TO_LABEL[self.dataset], allow_pickle=True)[
            "test_corpus"
        ].tolist()
        names = list(corpus)
        _check_test_count(self.dataset, names, self.expected_test_count)
        return names

    def get_test_name2gt(self) -> Dict[str, float]:
        corpus = np.load(paths.PATH_TO_LABEL[self.dataset], allow_pickle=True)[
            "test_corpus"
        ].tolist()
        return {name: float(corpus[name]["val"]) for name in corpus}


@registry.register_dataset("CMUMOSI")
class CMUMOSIDataset(ValenceDataset):
    dataset = "CMUMOSI"
    expected_test_count = 686


@registry.register_dataset("CMUMOSEI")
class CMUMOSEIDataset(ValenceDataset):
    dataset = "CMUMOSEI"
    expected_test_count = 4659


@registry.register_dataset("SIMS")
class SIMSDataset(ValenceDataset):
    dataset = "SIMS"


@registry.register_dataset("SIMSv2")
class SIMSv2Dataset(ValenceDataset):
    dataset = "SIMSv2"
    expected_test_count = 1034


def get_dataset_class(name: str):
    return registry.get("dataset", name)
