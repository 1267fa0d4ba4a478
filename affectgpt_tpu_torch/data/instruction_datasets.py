"""Instruction / caption / preference dataset families.

Completes the reference's training-corpus coverage beyond the 12 emotion
corpora (reference get_qa_pairs table, base_dataset.py:706-795):

- EMER family (EMERCoarse / EMERFine / EMERCoarseFilter): description +
  ovlabel (+ sentiment/valence for the filtered set) from csv.
- MERR family (MERRCoarse / MERRFine) and MAFW: description-only.
- Preference family (Preference / Preference2-4 / Preference3-reward).
- Direct-QA instruction corpora (VideoChat / LLaVA / EmoVIT): JSON
  records with explicit question/answer.
- Caption corpora (MiniGPT4 image captions; WavCaps / TextrolSpeech /
  PromptSpeech audio captions).

All reuse BaseDataset's assembly/collation; annotation sources are
simple csv/json files with the same column contracts as the reference.
The port's own copy of affectgpt_tpu/data/instruction_datasets.py: the CSVs
are read by `datasets.read_csv` (pandas' records, without pandas).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from affectgpt_tpu_torch import paths, registry
from affectgpt_tpu_torch.data.base_dataset import BaseDataset
from affectgpt_tpu_torch.data.datasets import (
    MediaPathsMixin,
    _read_subtitles,
    map_valence_to_sentiment,
    read_csv,
    string_to_list,
)


class CsvAnnotatedDataset(MediaPathsMixin, BaseDataset):
    """Generic: one csv with per-sample columns; subclasses define how a
    row becomes an annotation dict + the label_type candidates."""

    dataset: str = ""
    annotation_csv: str = ""
    label_type_candidates: List[str] = []
    with_subtitles: bool = True

    def __init__(self, tokenizer, dataset_cfg, model_cfg, seed: int = 0, device="cuda"):
        name2subtitle: Dict[str, str] = {}
        if self.with_subtitles:
            try:
                name2subtitle = _read_subtitles(self.dataset)
            except Exception:
                name2subtitle = {}
        self.name2subtitle = name2subtitle
        csv_path = os.path.join(paths.DATA_DIR.get(self.dataset, ""), self.annotation_csv)
        records = read_csv(csv_path) if os.path.exists(csv_path) else []
        self.annotation = [
            dict(self.row_to_sample(row), subtitle=name2subtitle.get(row.get("name"), ""))
            for row in records
        ]
        super().__init__(tokenizer, dataset_cfg, model_cfg, seed, device)

    def row_to_sample(self, row: dict) -> dict:
        raise NotImplementedError


class EMERDatasetBase(CsvAnnotatedDataset):
    """description + ovlabel corpora (reference EMERCoarse/EMERFine)."""

    label_type_candidates = ["description", "ovlabel"]

    def row_to_sample(self, row):
        labels = string_to_list(row.get("openset", "")) or ["neutral"]
        return {
            "name": row["name"],
            "description": row.get("reason", row.get("description", "")),
            "ovlabel": ", ".join(labels),
        }


@registry.register_dataset("EMERCoarse")
class EMERCoarseDataset(EMERDatasetBase):
    dataset = "EMERCoarse"
    annotation_csv = "emer_coarse.csv"


@registry.register_dataset("EMERFine")
class EMERFineDataset(EMERDatasetBase):
    dataset = "EMERFine"
    annotation_csv = "emer_fine.csv"


@registry.register_dataset("EMERCoarseFilter")
class EMERCoarseFilterDataset(EMERDatasetBase):
    """Filtered EMER with sentiment/valence targets too."""

    dataset = "EMERCoarseFilter"
    annotation_csv = "emer_coarse_filter.csv"
    label_type_candidates = ["description", "ovlabel", "sentiment", "valence"]

    def row_to_sample(self, row):
        sample = super().row_to_sample(row)
        valence = float(row.get("valence", 0.0))
        sample["valence"] = valence
        sample["sentiment"] = row.get("sentiment", map_valence_to_sentiment(valence))
        return sample


class DescriptionOnlyDataset(CsvAnnotatedDataset):
    label_type_candidates = ["description"]

    def row_to_sample(self, row):
        return {"name": row["name"], "description": row.get("reason", row.get("description", ""))}


@registry.register_dataset("MERRCoarse")
class MERRCoarseDataset(DescriptionOnlyDataset):
    dataset = "MERRCoarse"
    annotation_csv = "merr_coarse.csv"


@registry.register_dataset("MERRFine")
class MERRFineDataset(DescriptionOnlyDataset):
    dataset = "MERRFine"
    annotation_csv = "merr_fine.csv"


@registry.register_dataset("MAFW")
class MAFWDataset(DescriptionOnlyDataset):
    dataset = "MAFW"
    annotation_csv = "mafw.csv"


@registry.register_dataset("Preference")
class PreferenceDataset(CsvAnnotatedDataset):
    """Preference-pair corpus: description/ovlabel/sentiment/valence plus
    a1-vs-a2 preference selection (reference Preference family)."""

    dataset = "Preference"
    annotation_csv = "preference.csv"
    label_type_candidates = ["description", "ovlabel", "sentiment", "valence", "preference"]

    def row_to_sample(self, row):
        labels = string_to_list(row.get("openset", "")) or ["neutral"]
        valence = float(row.get("valence", 0.0))
        return {
            "name": row["name"],
            "description": row.get("reason", ""),
            "ovlabel": ", ".join(labels),
            "valence": valence,
            "sentiment": row.get("sentiment", map_valence_to_sentiment(valence)),
            "preference": {"a1": row.get("a1", ""), "a2": row.get("a2", ""),
                           "p": row.get("p", "same")},
        }


@registry.register_dataset("Preference2")
class Preference2Dataset(PreferenceDataset):
    """Preference corpus without the preference objective (reference
    Preference2/Preference4 variants)."""

    dataset = "Preference2"
    annotation_csv = "preference2.csv"
    label_type_candidates = ["description", "ovlabel", "sentiment", "valence"]


@registry.register_dataset("Preference4")
class Preference4Dataset(Preference2Dataset):
    dataset = "Preference4"
    annotation_csv = "preference4.csv"


@registry.register_dataset("Preference3")
class Preference3Dataset(CsvAnnotatedDataset):
    """Reward corpus: accept/reject a provided description."""

    dataset = "Preference3"
    annotation_csv = "preference3.csv"
    label_type_candidates = ["reward"]

    def row_to_sample(self, row):
        return {
            "name": row["name"],
            "description": row.get("reason", ""),
            "reward": row.get("reward", "accept"),
        }


class JsonInstructionDataset(MediaPathsMixin, BaseDataset):
    """Direct-QA instruction corpora (VideoChat / LLaVA / EmoVIT):
    JSON list of {name, question, answer} records."""

    dataset: str = ""
    json_name: str = "instructions.json"
    label_type_candidates = ["qa"]

    def __init__(self, tokenizer, dataset_cfg, model_cfg, seed: int = 0, device="cuda"):
        json_path = os.path.join(paths.DATA_DIR.get(self.dataset, ""), self.json_name)
        records = []
        if os.path.exists(json_path):
            with open(json_path) as handle:
                records = json.load(handle)
        self.annotation = [
            {
                "name": rec.get("name", str(i)),
                "question": rec["question"],
                "answer": rec["answer"],
                "subtitle": rec.get("subtitle", ""),
            }
            for i, rec in enumerate(records)
        ]
        self.name2subtitle = {a["name"]: a["subtitle"] for a in self.annotation}
        super().__init__(tokenizer, dataset_cfg, model_cfg, seed, device)


@registry.register_dataset("VideoChat")
class VideoChatDataset(JsonInstructionDataset):
    dataset = "VideoChat"


@registry.register_dataset("LLaVA")
class LLaVADataset(JsonInstructionDataset):
    dataset = "LLaVA"


@registry.register_dataset("EmoVIT")
class EmoVITDataset(JsonInstructionDataset):
    dataset = "EmoVIT"


class CaptionDataset(MediaPathsMixin, BaseDataset):
    """Caption corpora: csv with name + caption."""

    dataset: str = ""
    annotation_csv: str = "captions.csv"
    label_type_candidates = ["caption"]

    def __init__(self, tokenizer, dataset_cfg, model_cfg, seed: int = 0, device="cuda"):
        csv_path = os.path.join(paths.DATA_DIR.get(self.dataset, ""), self.annotation_csv)
        records = read_csv(csv_path) if os.path.exists(csv_path) else []
        self.annotation = [
            {"name": row["name"], "caption": row["caption"], "subtitle": ""}
            for row in records
        ]
        self.name2subtitle = {}
        super().__init__(tokenizer, dataset_cfg, model_cfg, seed, device)

    def _get_image_path(self, sample) -> Optional[str]:
        root = paths.DATA_DIR.get(self.dataset, "")
        return os.path.join(root, "image", f"{sample['name']}.jpg")


@registry.register_dataset("MiniGPT4")
class MiniGPT4Dataset(CaptionDataset):
    dataset = "MiniGPT4"


@registry.register_dataset("WavCaps")
class WavCapsDataset(CaptionDataset):
    dataset = "WavCaps"


@registry.register_dataset("TextrolSpeech")
class TextrolSpeechDataset(CaptionDataset):
    dataset = "TextrolSpeech"


@registry.register_dataset("PromptSpeech")
class PromptSpeechDataset(CaptionDataset):
    dataset = "PromptSpeech"
