"""Where the model checkpoints and the corpora live.

The port's own copy of affectgpt_tpu/paths.py (the reference's path map,
AffectGPT/config.py:13-115): the model tables `PATH_TO_LLM`,
`PATH_TO_VISUAL` and `PATH_TO_AUDIO`, the per-corpus data tables, the
emotion-wheel and feature-cache roots, and `update_from_dict`, which a
config's `paths:` section feeds. The same environment overrides:
AFFECTGPT_ROOT, AFFECTGPT_MODEL_ROOT, AFFECTGPT_DATA_ROOT,
AFFECTGPT_EMOTION_WHEEL_ROOT and AFFECTGPT_FEATURE_ROOT.
"""

from __future__ import annotations

import os

AFFECTGPT_ROOT = os.environ.get("AFFECTGPT_ROOT", "./")
MODEL_ROOT = os.environ.get("AFFECTGPT_MODEL_ROOT", os.path.join(AFFECTGPT_ROOT, "tools"))
DATA_ROOT = os.environ.get("AFFECTGPT_DATA_ROOT", os.path.join(AFFECTGPT_ROOT, "dataset"))
# emotion-wheel metric data (wheel{1..5}.xlsx, synonym.xlsx, format.csv),
# vendored under assets/emotion_wheel
_VENDORED_WHEEL = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "emotion_wheel")
EMOTION_WHEEL_ROOT = os.environ.get(
    "AFFECTGPT_EMOTION_WHEEL_ROOT",
    _VENDORED_WHEEL if os.path.isdir(_VENDORED_WHEEL)
    else os.path.join(AFFECTGPT_ROOT, "emotion_wheel"),
)
RESULT_ROOT = os.path.join(AFFECTGPT_ROOT, "output", "results")

PATH_TO_LLM = {
    "Qwen25": os.path.join(MODEL_ROOT, "LLM", "Qwen2.5-7B-Instruct"),
    "Llama2": os.path.join(MODEL_ROOT, "LLM", "Llama-2-7b-chat-hf"),
    "Baichuan2": os.path.join(MODEL_ROOT, "LLM", "Baichuan2-7B-Chat"),
}

PATH_TO_VISUAL = {
    "CLIP_VIT_LARGE": os.path.join(MODEL_ROOT, "visual", "clip-vit-large-patch14"),
    "CLIP_VIT_BASE32": os.path.join(MODEL_ROOT, "visual", "clip-vit-base-patch32"),
}

PATH_TO_AUDIO = {
    "HUBERT_LARGE": os.path.join(MODEL_ROOT, "audio", "chinese-hubert-large"),
}

_DATASET_NAMES = (
    "MER2025OV", "MERCaptionPlus", "OVMERD", "MER2023", "MER2024",
    "IEMOCAPFour", "CMUMOSI", "CMUMOSEI", "SIMS", "SIMSv2", "MELD",
    "OVMERDPlus",
)

DATA_DIR = {name: os.path.join(DATA_ROOT, name.lower()) for name in _DATASET_NAMES}

# per-corpus layout, the reference's (AffectGPT/config.py:46-115)
_AUDIO_SUBDIR = {
    "IEMOCAPFour": "subaudio", "CMUMOSI": "subaudio", "CMUMOSEI": "subaudio",
    "MELD": "subaudio",
}
_VIDEO_SUBDIR = {
    "IEMOCAPFour": "subvideo-tgt", "CMUMOSI": "subvideo", "CMUMOSEI": "subvideo_new",
    "MELD": "subvideo", "SIMSv2": "video_new",
}
_TRANSCRIPTION_FILE = {
    "MER2025OV": "subtitle_chieng.csv", "MERCaptionPlus": "subtitle_chieng.csv",
    "OVMERD": "subtitle_chieng.csv", "MER2024": "transcription_merge.csv",
    "OVMERDPlus": "subtitle_eng.csv",
}
_LABEL_FILE = {
    "MER2025OV": "track2_test.csv", "MER2023": "label-6way.npz",
    "MER2024": "label-6way.npz", "IEMOCAPFour": "label_4way.npz",
    "OVMERDPlus": "ovlabel.csv",
}

PATH_TO_RAW_AUDIO = {
    n: os.path.join(DATA_DIR[n], _AUDIO_SUBDIR.get(n, "audio")) for n in _DATASET_NAMES
}
PATH_TO_RAW_VIDEO = {
    n: os.path.join(DATA_DIR[n], _VIDEO_SUBDIR.get(n, "video")) for n in _DATASET_NAMES
}
PATH_TO_RAW_FACE = {
    n: os.path.join(DATA_DIR[n], "openface_face") for n in _DATASET_NAMES
}
PATH_TO_TRANSCRIPTIONS = {
    n: os.path.join(DATA_DIR[n], _TRANSCRIPTION_FILE.get(n, "transcription-engchi-polish.csv"))
    for n in _DATASET_NAMES
}
PATH_TO_LABEL = {
    n: os.path.join(DATA_DIR[n], _LABEL_FILE.get(n, "label.npz")) for n in _DATASET_NAMES
}

# root of the preextracted .npy feature caches, laid out as
# {root}/{dataset}/{modality}_{encoder}_{sampling}_{n}frms/{name}.npy
# (reference: extract_multimodal_features_precompute.py:820-846)
FEATURE_ROOT = os.environ.get("AFFECTGPT_FEATURE_ROOT", os.path.join(DATA_ROOT, "features"))

TABLES = {
    "PATH_TO_LLM": PATH_TO_LLM,
    "PATH_TO_VISUAL": PATH_TO_VISUAL,
    "PATH_TO_AUDIO": PATH_TO_AUDIO,
    "DATA_DIR": DATA_DIR,
    "PATH_TO_RAW_AUDIO": PATH_TO_RAW_AUDIO,
    "PATH_TO_RAW_VIDEO": PATH_TO_RAW_VIDEO,
    "PATH_TO_RAW_FACE": PATH_TO_RAW_FACE,
    "PATH_TO_TRANSCRIPTIONS": PATH_TO_TRANSCRIPTIONS,
    "PATH_TO_LABEL": PATH_TO_LABEL,
}


def update_from_dict(overrides: dict) -> None:
    """Apply a `paths:` config section: {table_name: {key: path}}."""
    for table_name, entries in (overrides or {}).items():
        if table_name not in TABLES:
            raise KeyError(f"Unknown path table: {table_name}")
        TABLES[table_name].update(entries)
