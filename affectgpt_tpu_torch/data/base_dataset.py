"""Sample assembly and batching: annotations → tokenized prompts +
modality payloads → static-shape batches.

The port's own copy of affectgpt_tpu/data/base_dataset.py, with the
reference's BaseDataset capabilities (reference:
my_affectgpt/datasets/datasets/base_dataset.py:22-1103): needed-data
resolution, per-modality realtime/preextracted loading, QA-pair
selection, prompt templating + patch replication, 10-retry error
resampling, max-length enforcement, bos/eos wrapping and label masking.

As in the JAX package:
- The collator pads to a static max_length (the reference pads to the
  longest in the batch), so every step sees one shape.
- Patch-token runs are located here on the host (the offsets dict) and
  patch ids are zeroed before upload, so the device splice is a
  fixed-width write (models/splice.py) instead of the reference's
  per-sample loop (affectgpt.py:967-1009); the count and consecutiveness
  invariants are enforced here (splice.find_patch_run).
- Realtime media loading produces uint8 frames and float32 audio clips
  (cut on the host, ops/audio.host_audio_clips); the
  pixel and mel math runs on the device.
- The realtime AU texts are encoded by the CLIP text tower on the
  dataset's `device` (the card unless the caller says otherwise), from
  the loader's thread when a prefetcher drives it.
"""

from __future__ import annotations

import logging
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from affectgpt_tpu_torch import constants, prompts
from affectgpt_tpu_torch.data import media, qa
from affectgpt_tpu_torch.models import splice
from affectgpt_tpu_torch.ops import audio as audio_ops

logger = logging.getLogger(__name__)

# modalities whose ragged-collate drop has already been logged (once per
# process — see collate below)
_RAGGED_WARNED: set = set()


@dataclass
class DatasetConfig:
    """Per-dataset section of the experiment YAML (same knob names as the
    reference's dataset_cfg)."""

    label_type: str = "hybird"
    face_or_frame: str = "multiface_audio_face_frame_text"
    frame_sampling: str = "uniform"
    frame_n_frms: int = 8
    face_n_frms: int = 8
    max_length: int = 1024
    ratio: float = 1.0
    # preextracted-feature switches (per modality, reference base_dataset.py:77-85)
    use_preextracted_frame: bool = False
    use_preextracted_face: bool = False
    use_preextracted_audio: bool = False
    preextracted_root: Optional[str] = None
    visual_encoder_name: str = "CLIP_VIT_LARGE"
    acoustic_encoder_name: str = "HUBERT_LARGE"
    # nonverbal (AU) caption text injection (reference base_dataset.py:197-259)
    use_nonverbal_text: bool = False
    nonverbal_json: Optional[str] = None
    # MER-Factory output root: per-sample AU-analysis JSONs that drive
    # emotion_peak frame sampling (reference train_configs
    # ..._face_frame_au_peak.yaml `mer_factory_output`; layout
    # {root}/{name}/{name}_au_analysis.json, video_processor.py:59-164)
    mer_factory_output: Optional[str] = None
    # realtime AU text → CLIP ViT-B/32 feature encoding (no precomputed au
    # cache needed; reference eval_configs/
    # inference_frame_preextracted_au_realtime.yaml `use_au_clip_realtime`
    # reads summary_description from the MER-Factory JSON and CLIP-encodes
    # it per sample)
    use_au_clip_realtime: bool = False

    @classmethod
    def from_cfg(cls, node) -> "DatasetConfig":
        known = {f.name for f in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in dict(node or {}).items() if k in known})


@dataclass
class ModelDataConfig:
    """The model-side knobs the data layer needs (query token counts +
    the au merger's fusion type, which decides whether realtime AU CLIP
    features may be mean-pooled host-side)."""

    num_video_query_token: int = 8
    num_audio_query_token: int = 8
    num_multi_query_token: int = 1
    num_image_query_token: int = 8
    au_fusion_type: str = "mean"


class BaseDataset:
    """Subclasses set: self.dataset, self.annotation (list of sample dicts
    with at least 'name'), self.label_type_candidates, path helpers
    (_get_video_path/_get_audio_path/_get_face_path/_get_image_path), and
    optionally candidate_labels / minval / maxval. `device` is where the
    realtime AU text features are encoded."""

    candidate_labels: str = ""
    minval: float = -1
    maxval: float = 1

    def __init__(
        self,
        tokenizer,
        dataset_cfg: DatasetConfig,
        model_cfg: ModelDataConfig,
        seed: int = 0,
        device="cuda",
    ):
        self.tokenizer = tokenizer
        self.device = device
        self.cfg = dataset_cfg
        self.model_cfg = model_cfg
        self.rng = random.Random(seed)
        self.needed_data = prompts.get_needed_data(dataset_cfg.face_or_frame)
        self._nonverbal_cache: Optional[dict] = None
        self._au_feat_cache: Dict[str, np.ndarray] = {}
        if not hasattr(self, "annotation"):
            self.annotation = []

    # -- subclass extension points ------------------------------------------------
    def _get_video_path(self, sample) -> Optional[str]:
        return None

    def _get_audio_path(self, sample) -> Optional[str]:
        return None

    def _get_face_path(self, sample) -> Optional[str]:
        return None

    def _get_image_path(self, sample) -> Optional[str]:
        return None

    # -- nonverbal text -------------------------------------------------------------
    _NONVERBAL_DATASET_NAMES = {
        "IEMOCAPFour": "IEMOCAP", "CMUMOSI": "CMU-MOSI", "CMUMOSEI": "CMU-MOSEI",
        "SIMS": "CH-SIMS", "SIMSv2": "CH-SIMS v2",
    }

    def get_nonverbal_text(self, sample_name: str) -> Optional[str]:
        """Per-sample AU/audio-clue caption from the grained JSON
        (reference: base_dataset.py:220-259)."""
        if not self.cfg.use_nonverbal_text or not self.cfg.nonverbal_json:
            return None
        if self._nonverbal_cache is None:
            import json
            try:
                with open(self.cfg.nonverbal_json) as handle:
                    self._nonverbal_cache = json.load(handle)
            except OSError:
                self._nonverbal_cache = {}
        ds_name = self._NONVERBAL_DATASET_NAMES.get(self.dataset, self.dataset)
        entry = self._nonverbal_cache.get(ds_name, {}).get(sample_name)
        if isinstance(entry, dict):
            return entry.get("caption") or entry.get("summary_description")
        return entry

    def get_au_info(self, sample_name: Optional[str]) -> Optional[dict]:
        """Per-sample MER-Factory AU analysis for emotion_peak sampling
        (same JSON convention as the feature-precompute CLI,
        extract_multimodal_features_precompute.py:94-99)."""
        if (
            self.cfg.frame_sampling != "emotion_peak"
            or not self.cfg.mer_factory_output
            or not sample_name
        ):
            return None
        data = media.load_au_analysis(self.cfg.mer_factory_output, sample_name)
        return data.get("au_info") if data is not None else None

    # -- modality loading ------------------------------------------------------------
    def _feature_path(self, modality: str, sample_name: str) -> str:
        encoder = (
            self.cfg.visual_encoder_name if modality in ("frame", "face")
            else self.cfg.acoustic_encoder_name
        )
        return media.feature_cache_path(
            self.cfg.preextracted_root, self.dataset, modality, encoder, sample_name,
            sampling_name=self.cfg.frame_sampling, n_frms=self.cfg.frame_n_frms,
        )

    def load_modalities(self, sample: dict) -> Dict[str, np.ndarray]:
        """Returns {'features': {m: [t, d]}, 'raw': {m: raw media}} — a
        preextracted feature when enabled+cached, raw media otherwise
        (the reference's per-modality fallback chain,
        base_dataset.py:338-581)."""
        name = sample.get("name")
        out: Dict[str, dict] = {"features": {}, "raw": {}}

        def preextract_enabled(m: str) -> bool:
            return {
                "frame": self.cfg.use_preextracted_frame,
                "face": self.cfg.use_preextracted_face,
                "audio": self.cfg.use_preextracted_audio,
            }.get(m, False) and self.cfg.preextracted_root and name

        for m in self.needed_data:
            if m == "multi":
                continue  # pre-fusion runs in-model from face/frame+audio hiddens
            if preextract_enabled(m):
                feat = media.load_feature(self._feature_path(m, name))
                if feat is not None:
                    if feat.ndim == 1:
                        feat = feat[None, :]
                    out["features"][m] = feat.astype(np.float32)
                    continue
            # realtime fallback
            if m == "frame":
                out["raw"]["frame"] = media.read_video_frames(
                    self._get_video_path(sample), self.cfg.frame_n_frms,
                    self.cfg.frame_sampling, self.rng,
                    au_info=self.get_au_info(name),
                )
            elif m == "face":
                out["raw"]["face"] = media.read_face_crops(
                    self._get_face_path(sample), self.cfg.face_n_frms, "uniform", self.rng
                )
            elif m == "audio":
                wav, rate = media.read_wav(self._get_audio_path(sample))
                out["raw"]["audio"] = audio_ops.host_audio_clips(wav, rate)  # [8, 1, 32000]
            elif m == "image":
                from PIL import Image

                img = np.asarray(Image.open(self._get_image_path(sample)).convert("RGB"))
                out["raw"]["image"] = img[None]  # [1, H, W, 3]

        # realtime AU: MER-Factory summary_description → CLIP text features
        # (reference eval_configs/inference_frame_preextracted_au_realtime.yaml
        # `use_au_clip_realtime` names this JSON → CLIP ViT-B/32 path; note
        # AU features are a VESTIGIAL channel in the reference — its forward
        # splice list has no AU patch token (affectgpt.py:969-1009) and its
        # shipped inference script passes AU as Nonverbal TEXT only
        # (inference_hybird.py:304) — so these features feed the au-merger
        # pipeline and precompute caches, never the LLM input).
        #
        # Host-side mean-pooling to a static [1, 512] row is exact only for
        # the default `mean` au fusion; attention/qformer mergers weight
        # timesteps, so those keep the full [N, 512] sequence (same layout
        # the precomputed au cache stores).
        if (
            self.cfg.use_au_clip_realtime
            and self.cfg.mer_factory_output
            and name
            and "au" in self.cfg.face_or_frame.split("_")
        ):
            cached = self._au_feat_cache.get(name)
            if cached is not None:
                out["features"]["au"] = cached
            else:
                texts = media.load_au_summary_texts(self.cfg.mer_factory_output, name)
                if texts:
                    from affectgpt_tpu_torch.utils import clip_text

                    feats = clip_text.encode_texts(
                        *clip_text.cached_text_tower(self.device), texts)
                    if self.model_cfg.au_fusion_type == "mean":
                        feats = feats.mean(axis=0, keepdims=True)
                    # the summary texts are immutable per clip name — memoize
                    # so multi-epoch training doesn't re-pay the CLIP text
                    # forward per sample per epoch ([N,512] f32 ≈ 2 KB/clip)
                    out["features"]["au"] = self._au_feat_cache[name] = feats
        return out

    # -- text assembly ---------------------------------------------------------------
    def build_text(self, sample: dict, nonverbal_text: Optional[str]) -> dict:
        label_type = qa.pick_label_type(
            self.label_type_candidates, self.cfg.label_type, self.rng
        )
        pair = qa.get_qa_pairs(
            self.dataset, label_type, sample,
            candidate_labels=self.candidate_labels,
            minval=self.minval, maxval=self.maxval, rng=self.rng,
        )
        subtitle = sample.get("subtitle")
        prompt = prompts.get_prompt_for_multimodal(
            self.cfg.face_or_frame, subtitle, pair["question"], nonverbal_text
        )
        prompt = prompts.replace_token_for_multimodal(
            prompt,
            self.model_cfg.num_video_query_token,
            self.model_cfg.num_audio_query_token,
            self.model_cfg.num_multi_query_token,
            self.model_cfg.num_image_query_token,
        )
        prompt_ids = self.tokenizer.encode(prompt, max_length=self.cfg.max_length)
        target_ids = self.tokenizer.encode(pair["answer"] + "###", max_length=self.cfg.max_length)
        if len(prompt_ids) + len(target_ids) > self.cfg.max_length - 2:  # room for bos/eos
            raise RuntimeError("too long text_input")
        input_ids = prompt_ids + target_ids
        labels = [constants.IGNORE_INDEX] * len(prompt_ids) + list(target_ids)
        return {"input_ids": input_ids, "labels": labels}

    def smoke_check(self, n: int = 3) -> dict:
        """Build + collate `n` random samples to fail fast on a broken
        corpus (the reference runs this eagerly at dataset construction,
        base_dataset.py:156-165; here it is explicit so tests and offline
        tools construct datasets without touching media). The Runner calls
        it once per dataset before training starts."""
        if len(self) == 0:
            raise RuntimeError(f"{self.dataset}: empty dataset")
        indices = [self.rng.randint(0, len(self) - 1) for _ in range(min(n, len(self)))]
        return self.collate([self[i] for i in indices])

    # -- sample assembly --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.annotation)

    def __getitem__(self, index: int) -> dict:
        num_retries = 10  # skip broken media / overlong prompts (reference :933-987)
        for _ in range(num_retries):
            try:
                sample = self.annotation[index]
                payload = self.load_modalities(sample)
                nonverbal = self.get_nonverbal_text(sample.get("name", ""))
                text = self.build_text(sample, nonverbal)
                return {
                    **text,
                    **payload,
                    "name": sample.get("name"),
                    "dataset": self.dataset.lower(),
                    "face_or_frame": self.cfg.face_or_frame,
                }
            except Exception as error:  # noqa: BLE001 — mirror reference resilience
                logger.warning(
                    "Failed to load %s sample %s (%s); resampling.",
                    self.dataset, self.annotation[index].get("name"), error,
                )
                index = self.rng.randint(0, len(self) - 1)
        raise RuntimeError(f"Failed to fetch sample after {num_retries} retries")

    # -- batching ----------------------------------------------------------------------
    def collate(self, instances: List[dict]) -> dict:
        """Static-shape batch: bos/eos wrap, pad to max_length, labels −100
        outside target, patch offsets + zeroed patch ids, stacked payloads."""
        tok = self.tokenizer
        b = len(instances)
        T = self.cfg.max_length
        input_ids = np.full((b, T), tok.pad_token_id, dtype=np.int32)
        labels = np.full((b, T), constants.IGNORE_INDEX, dtype=np.int32)
        attention = np.zeros((b, T), dtype=np.float32)
        for i, inst in enumerate(instances):
            ids = [tok.bos_token_id] + list(inst["input_ids"]) + [tok.eos_token_id]
            lab = [constants.IGNORE_INDEX] + list(inst["labels"]) + [tok.eos_token_id]
            n = len(ids)
            input_ids[i, :n] = ids
            labels[i, :n] = lab
            attention[i, :n] = 1.0

        # locate patch runs, then zero the patch ids (device embeds id 0)
        query_counts = {
            "frame": self.model_cfg.num_video_query_token,
            "face": self.model_cfg.num_video_query_token,
            "audio": self.model_cfg.num_audio_query_token,
            "multi": self.model_cfg.num_multi_query_token,
            "image": self.model_cfg.num_image_query_token,
        }
        token_names = {
            "frame": constants.DEFAULT_FRAME_PATCH_TOKEN,
            "face": constants.DEFAULT_FACE_PATCH_TOKEN,
            "audio": constants.DEFAULT_AUDIO_PATCH_TOKEN,
            "multi": constants.DEFAULT_MULTI_PATCH_TOKEN,
            "image": constants.DEFAULT_IMAGE_PATCH_TOKEN,
        }
        offsets: Dict[str, np.ndarray] = {}
        for m, tok_name in token_names.items():
            tok_id = tok.patch_token_ids[tok_name]
            offs = np.array(
                [splice.find_patch_run(input_ids[i], tok_id, query_counts[m]) for i in range(b)],
                dtype=np.int32,
            )
            if np.any(offs >= 0):
                offsets[m] = offs
                input_ids[input_ids == tok_id] = 0

        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": attention,
            "offsets": offsets,
            "dataset": instances[0]["dataset"],
            "face_or_frame": instances[0]["face_or_frame"],
            "names": [inst.get("name") for inst in instances],
        }

        # stack per-modality payloads when every instance agrees on shape
        features: Dict[str, np.ndarray] = {}
        raws: Dict[str, np.ndarray] = {}
        for m in ("frame", "face", "audio", "image", "au"):
            feats = [inst["features"].get(m) for inst in instances]
            if all(f is not None for f in feats):
                if len({f.shape for f in feats}) == 1:
                    features[m] = np.stack(feats)
                elif m not in _RAGGED_WARNED:
                    # every sample carried the payload but lengths are
                    # ragged (e.g. variable-count AU texts under a
                    # non-mean au fusion) — dropping it silently would
                    # look like "modality absent" downstream. Warn ONCE
                    # per modality: under a non-mean au fusion nearly
                    # every batch is ragged and a per-batch warning
                    # floods the log (~300k lines on a 60-epoch recipe).
                    _RAGGED_WARNED.add(m)
                    logger.warning(
                        "collate: dropping ragged %r features (shapes %s; "
                        "warning once per modality)",
                        m, sorted({f.shape for f in feats}),
                    )
            rs = [inst["raw"].get(m) for inst in instances]
            if all(r is not None for r in rs) and len({r.shape for r in rs}) == 1:
                raws[m] = np.stack(rs)
        batch["features"] = features
        batch["raw"] = raws
        return batch
