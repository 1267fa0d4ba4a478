"""Batch feature precompute for the 9 MER-UniBench evaluation datasets.

    python -m affectgpt_tpu_torch.mer_unibench.extract_frame_emotion_peak_batch \
        --datasets mer2023 meld --modality frame --save_root ./preextracted_features \
        [--device cuda|cpu]

Port of the repo's root mer_unibench/extract_frame_emotion_peak_batch.py
(reference: MER-UniBench/extract_frame_emotion_peak_batch.py:38-394):
per-dataset configs (video roots, label sources), emotion-peak or uniform
frame sampling, resumable per-sample .npy caches. A thin wrapper over the
port's `extract_multimodal_features_precompute.FeatureExtractor` (CLIP
ViT-L/14 and HuBERT-large, loaded from their directories or drawn from a
seed), on `--device`, the card by default (no fallback to the CPU).

The extractor skips, with a warning, a clip whose media cannot be read;
unlike the JAX wrapper, which logs and skips any error of a clip, an
error of the towers or their kernels ends the run.
"""

from __future__ import annotations

import argparse
import logging

from affectgpt_tpu_torch import paths, registry
from affectgpt_tpu_torch.data.base_dataset import DatasetConfig, ModelDataConfig
from affectgpt_tpu_torch.data.datasets import get_dataset_class  # noqa: F401 (registers them)
from affectgpt_tpu_torch.extract_multimodal_features_precompute import FeatureExtractor
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.tokenization import ByteTokenizer
from affectgpt_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)

DATASET_CONFIGS = {
    "mer2023": "MER2023", "mer2024": "MER2024", "meld": "MELD",
    "iemocapfour": "IEMOCAPFour", "cmumosi": "CMUMOSI", "cmumosei": "CMUMOSEI",
    "sims": "SIMS", "simsv2": "SIMSv2", "ovmerdplus": "OVMERDPlus",
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--datasets", nargs="+", default=list(DATASET_CONFIGS))
    parser.add_argument("--modality", default="all",
                        choices=["all", "frame", "face", "audio"])
    parser.add_argument("--save_root", default="./preextracted_features")
    parser.add_argument("--frame_sampling", default="uniform",
                        choices=["uniform", "headtail", "emotion_peak"])
    parser.add_argument("--frame_n_frms", type=int, default=8)
    parser.add_argument("--mer-factory-output", dest="mer_factory_output", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    setup_logger()
    device = resolve_device(args.device)

    for key in args.datasets:
        ds_name = DATASET_CONFIGS[key.lower()]
        # text only: the dataset lists the test names and touches no device
        dataset = registry.get("dataset", ds_name)(
            ByteTokenizer(), DatasetConfig(face_or_frame="textonly"), ModelDataConfig(),
            device="cpu")
        names = dataset.read_test_names()
        extractor = FeatureExtractor(
            "CLIP_VIT_LARGE", "HUBERT_LARGE", args.frame_sampling,
            args.frame_n_frms, 8, args.save_root, ds_name, device=device,
        )
        modalities = ["frame", "face", "audio"] if args.modality == "all" else [args.modality]
        for i, name in enumerate(names):
            for modality in modalities:
                if modality == "frame":
                    extractor.extract_frame(
                        name, paths.PATH_TO_RAW_VIDEO[ds_name], args.mer_factory_output
                    )
                elif modality == "face":
                    extractor.extract_face(name, paths.PATH_TO_RAW_FACE[ds_name])
                elif modality == "audio":
                    extractor.extract_audio(name, paths.PATH_TO_RAW_AUDIO[ds_name])
            if (i + 1) % 100 == 0:
                logger.info("%s: %d/%d", ds_name, i + 1, len(names))
        logger.info("%s done (%d clips)", ds_name, len(names))


if __name__ == "__main__":
    main()
