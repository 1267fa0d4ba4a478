"""Where the LLM and encoder checkpoints live.

The port's own copy of `PATH_TO_LLM`, `PATH_TO_VISUAL` and `PATH_TO_AUDIO`
from affectgpt_tpu/paths.py (the reference's path map, AffectGPT/config.py),
with the same environment overrides: AFFECTGPT_ROOT, or
AFFECTGPT_MODEL_ROOT for the model tree.
"""

from __future__ import annotations

import os

AFFECTGPT_ROOT = os.environ.get("AFFECTGPT_ROOT", "./")
MODEL_ROOT = os.environ.get("AFFECTGPT_MODEL_ROOT", os.path.join(AFFECTGPT_ROOT, "tools"))

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
