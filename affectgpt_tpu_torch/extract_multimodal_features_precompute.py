"""Offline feature precompute: frame / face / audio / AU / multi .npy caches,
in PyTorch.

    python -m affectgpt_tpu_torch.extract_multimodal_features_precompute
        --dataset <name> [--modality all|frame|face|audio|au|multi]
        [--sample_list F | --csv_path F] [--device cuda|cpu] ...

Port of the repo's root extract_multimodal_features_precompute.py
(reference: AffectGPT/extract_multimodal_features_precompute.py:43-1146):
the same flags and cache layout
`{save_root}/{dataset}/{modality}_{encoder}_{sampling}_{n}frms/{name}.npy`
(data/media.py `feature_cache_path`, the layout the datasets read),
skip-if-exists, AU = CLIP ViT-B/32 text features of MER-Factory's
`summary_description`, and 'multi' as the concatenated means of the cached
face and audio features. The towers `--visual_encoder` and
`--acoustic_encoder` name resolve through the encoder registry
(models/encoders.py) and `bootstrap.build_tower`: loaded from
`PATH_TO_VISUAL` / `PATH_TO_AUDIO` and held to the registry's geometry, or
drawn at random from a seed when their directory is absent. They run in
bf16, the dtype of the card's encoder kernels. Media are decoded on the
host (data/media.py); the transforms and towers run on `--device`, which
defaults to `cuda` (the card; there is no fallback to the CPU).

A clip whose media cannot be read is skipped with a warning, as the
reference skips it, and its audio cache is zero-filled (reference
:945-960). Only the read is guarded: an error of the towers or their
kernels ends the run. `--csv_path` is read with the csv module.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import os

import numpy as np
import torch

from affectgpt_tpu_torch import paths
from affectgpt_tpu_torch.bootstrap import build_tower
from affectgpt_tpu_torch.data import media
from affectgpt_tpu_torch.inference.chat import encode_media_features
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.models import encoders
from affectgpt_tpu_torch.ops import audio as audio_ops
from affectgpt_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


class FeatureExtractor:
    def __init__(self, visual_encoder: str, acoustic_encoder: str, frame_sampling: str,
                 frame_n_frms: int, clips_per_video: int, save_root: str, dataset: str,
                 device="cuda", dtype=torch.bfloat16):
        self.visual_encoder_name = visual_encoder
        self.acoustic_encoder_name = acoustic_encoder
        self.frame_sampling = frame_sampling
        self.frame_n_frms = frame_n_frms
        self.clips_per_video = clips_per_video
        self.save_root = save_root
        self.dataset = dataset
        self.device, self.dtype = torch.device(device), dtype

        self.vision_spec = encoders.get_visual_encoder(visual_encoder)
        self.audio_spec = encoders.get_acoustic_encoder(acoustic_encoder)
        self.vision_cfg = self.vision_spec.make_config()
        self.audio_cfg = self.audio_spec.make_config()
        self.vision_params = build_tower(
            "visual_encoder", self.vision_spec, self.vision_cfg,
            torch.Generator(device=self.device).manual_seed(0), dtype, self.device)
        self.audio_params = build_tower(
            "acoustic_encoder", self.audio_spec, self.audio_cfg,
            torch.Generator(device=self.device).manual_seed(1), dtype, self.device)
        self.clip_text = None  # lazy (AU mode only)

    # -- cache paths -------------------------------------------------------------
    def cache_path(self, modality: str, name: str) -> str:
        encoder = (self.visual_encoder_name if modality in ("frame", "face")
                   else self.acoustic_encoder_name)
        if modality == "au":
            encoder = "CLIP_VIT_BASE32"
        if modality == "multi":
            encoder = f"{self.visual_encoder_name}+{self.acoustic_encoder_name}"
        return media.feature_cache_path(
            self.save_root, self.dataset, modality, encoder, name,
            sampling_name=self.frame_sampling, n_frms=self.frame_n_frms,
            clips_per_video=self.clips_per_video)

    def _save(self, out: str, feats: np.ndarray) -> bool:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.save(out, feats)
        return True

    @staticmethod
    def _read(name: str, modality: str, read, *args, **kwargs):
        """read(*args, **kwargs) on the host, or None with a warning where the
        clip's media cannot be read."""
        try:
            return read(*args, **kwargs)
        except Exception as error:  # a missing or bad file: skip the clip (reference)
            logger.warning("%s %s: cannot read its media (%s)", name, modality, error)
            return None

    def _encode_frames(self, modality: str, frames: np.ndarray) -> np.ndarray:
        feats = encode_media_features(
            {"visual_encoder": self.vision_params}, None,
            {modality: torch.as_tensor(frames[None], device=self.device)},
            vision_cfg=self.vision_cfg)[modality]
        return feats[0].float().cpu().numpy()

    # -- per-modality extraction --------------------------------------------------
    def extract_frame(self, name: str, video_root: str, mer_factory_output=None) -> bool:
        out = self.cache_path("frame", name)
        if os.path.exists(out):
            return True
        video_path = os.path.join(video_root, f"{name}.mp4")
        if not os.path.exists(video_path):
            video_path = os.path.join(video_root, f"{name}.avi")

        def read():
            au_info = None
            if self.frame_sampling == "emotion_peak" and mer_factory_output:
                json_path = os.path.join(mer_factory_output, name, f"{name}_au_analysis.json")
                if os.path.exists(json_path):
                    with open(json_path) as handle:
                        au_info = json.load(handle).get("au_info")
            return media.read_video_frames(video_path, self.frame_n_frms, self.frame_sampling,
                                           au_info=au_info)

        frames = self._read(name, "frame", read)
        if frames is None:
            return False
        return self._save(out, self._encode_frames("frame", frames))

    def extract_face(self, name: str, face_root: str) -> bool:
        out = self.cache_path("face", name)
        if os.path.exists(out):
            return True
        face_npy = os.path.join(face_root, name, f"{name}.npy")
        if not os.path.exists(face_npy):
            face_npy = os.path.join(face_root, f"{name}.npy")
        faces = self._read(name, "face", media.read_face_crops, face_npy, self.frame_n_frms)
        if faces is None:
            return False
        return self._save(out, self._encode_frames("face", faces))

    def extract_audio(self, name: str, audio_root: str) -> bool:
        out = self.cache_path("audio", name)
        if os.path.exists(out):
            return True
        clips = self._read(name, "audio", lambda path: audio_ops.host_audio_clips(
            *media.read_wav(path)), os.path.join(audio_root, f"{name}.wav"))
        if clips is None:  # zero-fill (reference :945-960)
            return self._save(out, np.zeros((self.clips_per_video, self.audio_cfg.hidden_size),
                                            np.float32))
        feats = self.audio_spec.encode(self.audio_params, self.audio_cfg,
                                       torch.as_tensor(clips[None], device=self.device))
        return self._save(out, feats[0].float().cpu().numpy())

    def extract_au(self, name: str, mer_factory_output: str) -> bool:
        """AU descriptions → CLIP ViT-B/32 text features [N, 512]
        (reference :702-777)."""
        from affectgpt_tpu_torch.utils import clip_text

        out = self.cache_path("au", name)
        if os.path.exists(out):
            return True
        descriptions = media.load_au_summary_texts(mer_factory_output, name)
        if not descriptions:
            return False
        if self.clip_text is None:
            self.clip_text = clip_text.load_text_tower(device=self.device, dtype=self.dtype)
        return self._save(out, clip_text.encode_texts(*self.clip_text, descriptions))

    def extract_multi(self, name: str) -> bool:
        """Pre-fusion cache from the face and audio caches (reference
        :617-697), kept for cache compatibility: training fuses online."""
        out = self.cache_path("multi", name)
        if os.path.exists(out):
            return True
        face, audio = self.cache_path("face", name), self.cache_path("audio", name)
        if not (os.path.exists(face) and os.path.exists(audio)):
            return False
        fused = np.concatenate([np.load(face).mean(0), np.load(audio).mean(0)])
        return self._save(out, fused.astype(np.float32))


def read_sample_names(args) -> list:
    if args.sample_list:
        with open(args.sample_list) as handle:
            return [line.strip() for line in handle if line.strip()]
    if args.csv_path:
        with open(args.csv_path, newline="") as handle:
            return [row[args.csv_column] for row in csv.DictReader(handle)]
    raise SystemExit("provide --sample_list or --csv_path")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="AffectGPT feature precompute (PyTorch)")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--modality", type=str, default="all",
                        choices=["all", "frame", "face", "audio", "au", "multi"])
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--skip-multi-preextract", action="store_true")
    parser.add_argument("--video_root", type=str)
    parser.add_argument("--face_root", type=str)
    parser.add_argument("--audio_root", type=str)
    parser.add_argument("--sample_list", type=str)
    parser.add_argument("--csv_path", type=str)
    parser.add_argument("--csv_column", type=str, default="names")
    parser.add_argument("--save_root", type=str, default="./preextracted_features")
    parser.add_argument("--mer-factory-output", type=str, dest="mer_factory_output")
    parser.add_argument("--visual_encoder", type=str, default="CLIP_VIT_LARGE")
    parser.add_argument("--acoustic_encoder", type=str, default="HUBERT_LARGE")
    parser.add_argument("--frame_n_frms", type=int, default=8)
    parser.add_argument("--frame_sampling", type=str, default="uniform",
                        choices=["uniform", "headtail", "emotion_peak"])
    parser.add_argument("--clips_per_video", type=int, default=8)
    parser.add_argument("--n_frms", type=int, default=8, help="Deprecated: use --frame_n_frms")
    parser.add_argument("--limit", type=int, default=None,
                        help="process only the first N sample names")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logger()
    device = resolve_device(args.device)
    # default media roots from the path tables, so `--dataset X` alone works
    # on a mounted corpus
    args.video_root = args.video_root or paths.PATH_TO_RAW_VIDEO.get(args.dataset)
    args.face_root = args.face_root or paths.PATH_TO_RAW_FACE.get(args.dataset)
    args.audio_root = args.audio_root or paths.PATH_TO_RAW_AUDIO.get(args.dataset)

    extractor = FeatureExtractor(
        args.visual_encoder, args.acoustic_encoder, args.frame_sampling, args.frame_n_frms,
        args.clips_per_video, args.save_root, args.dataset, device=device)
    names = read_sample_names(args)
    if args.limit:
        names = names[: args.limit]
    modalities = (["frame", "face", "audio", "au", "multi"] if args.modality == "all"
                  else [args.modality])
    if args.skip_multi_preextract and "multi" in modalities:
        modalities.remove("multi")
    for done, name in enumerate(names, 1):
        for modality in modalities:
            if modality == "frame" and args.video_root:
                extractor.extract_frame(name, args.video_root, args.mer_factory_output)
            elif modality == "face" and args.face_root:
                extractor.extract_face(name, args.face_root)
            elif modality == "audio" and args.audio_root:
                extractor.extract_audio(name, args.audio_root)
            elif modality == "au" and args.mer_factory_output:
                extractor.extract_au(name, args.mer_factory_output)
            elif modality == "multi":
                extractor.extract_multi(name)
        if not args.quiet and done % 100 == 0:
            logger.info("%d/%d samples processed", done, len(names))
    logger.info("feature extraction complete: %d samples", len(names))


if __name__ == "__main__":
    main()
