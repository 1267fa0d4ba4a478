"""OV-MER zero-shot harness: drive ANY third-party MLLM over the
evaluation datasets and emit results in the shared npz contract.

Port of the repo's root ovmer/zero_shot_harness.py (the reference OV-MER
suite's per-model drivers, e.g. OV-MER/Video-LLaVA/main-video.py:22-80:
iterate read_test_names(), prompt with/without subtitle, save
name2reason). One harness takes a `model_fn` callable — the baseline
wrapper supplies its own loading/inference — and the port supplies the
dataset iteration, prompts and result format, so wheel evaluation
(`python -m affectgpt_tpu_torch.evaluation`) applies unchanged.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    run_zero_shot("MER2023", my_model_fn, save_npz="out/result-mer2023/0.npz")
where my_model_fn(video_path, audio_path, subtitle, prompt) -> str. The
model adapters (the repo's ovmer/adapters/) are not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import numpy as np

from affectgpt_tpu_torch import registry
from affectgpt_tpu_torch.data.base_dataset import DatasetConfig, ModelDataConfig
from affectgpt_tpu_torch.data.datasets import get_dataset_class  # noqa: F401 (registers them)
from affectgpt_tpu_torch.tokenization import ByteTokenizer

logger = logging.getLogger(__name__)

ZERO_SHOT_PROMPT = (
    "Please recognize all possible emotional states of the character."
)


def run_zero_shot(
    dataset_name: str,
    model_fn: Callable[[Optional[str], Optional[str], Optional[str], str], str],
    save_npz: str,
    with_subtitle: bool = True,
    prompt: str = ZERO_SHOT_PROMPT,
    limit: Optional[int] = None,
) -> dict:
    # text only: the dataset lists names and media paths and touches no device
    dataset = registry.get("dataset", dataset_name)(
        ByteTokenizer(), DatasetConfig(face_or_frame="textonly"), ModelDataConfig(),
        device="cpu")
    names = dataset.read_test_names()
    if limit:
        names = names[:limit]
    name2sub = getattr(dataset, "name2subtitle", {})

    name2reason = {}
    for i, name in enumerate(names):
        sample = {"name": name}
        video = dataset._get_video_path(sample)
        audio = dataset._get_audio_path(sample)
        subtitle = name2sub.get(name, "") if with_subtitle else None
        try:
            name2reason[name] = model_fn(video, audio, subtitle, prompt)
        except Exception as error:  # keep sweeping, like the reference drivers
            logger.warning("%s/%s failed: %s", dataset_name, name, error)
            name2reason[name] = ""
        if (i + 1) % 50 == 0:
            logger.info("%s: %d/%d", dataset_name, i + 1, len(names))

    os.makedirs(os.path.dirname(save_npz), exist_ok=True)
    np.savez_compressed(save_npz, name2reason=name2reason)
    logger.info("saved %s (%d clips)", save_npz, len(name2reason))
    return name2reason
