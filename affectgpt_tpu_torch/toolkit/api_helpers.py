"""LLM/VLM API helpers and annotation harness (transport-injectable).

Port of affectgpt_tpu/toolkit/api_helpers.py (reference:
toolkit/utils/chatgpt.py:19-502 ChatGPT/GPT-4V helpers; toolkit/gptv/ per-
dataset GPT-4V annotation scripts), without pandas. The HTTP transport is
injected: callers pass `complete_fn(messages) -> str` (an OpenAI-compatible
chat call, `LocalJudgeTransport` over the port's `evaluation/judge.LLMJudge`,
or a test stub). The prompt templates, image packing, retry loop and csv
bookkeeping live here; CSVs are read with `data/datasets.read_csv` and
written as pandas writes them (`toolkit/io.write_rows_csv`).
"""

from __future__ import annotations

import base64
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

from affectgpt_tpu_torch.data.datasets import read_csv
from affectgpt_tpu_torch.toolkit.io import write_rows_csv
from affectgpt_tpu_torch.utils.logging import logger

Message = Dict[str, object]
CompleteFn = Callable[[List[Message]], str]


def image_content(image_path: str) -> dict:
    """Pack an image file as a base64 image_url content part (the
    chatgpt.py GPT-4V payload shape)."""
    with open(image_path, "rb") as handle:
        b64 = base64.b64encode(handle.read()).decode()
    return {"type": "image_url", "image_url": {"url": f"data:image/jpeg;base64,{b64}"}}


def complete_with_retry(
    complete_fn: CompleteFn,
    messages: List[Message],
    max_retries: int = 5,
    backoff_s: float = 2.0,
) -> Optional[str]:
    """Retry loop matching the reference's defensive API calling."""
    for attempt in range(max_retries):
        try:
            return complete_fn(messages)
        except Exception as error:  # noqa: BLE001
            logger.warning("completion attempt %d failed: %s", attempt + 1, error)
            time.sleep(backoff_s * (attempt + 1))
    return None


# ---------------------------------------------------------------------------
# Annotation prompts (GPT-4V emotion annotation, toolkit/gptv pattern)

EMOTION_ANNOTATION_PROMPT = (
    "Please play the role of an expert in the field of emotions. We provide "
    "{n_frames} temporally uniformly sampled frames from a video clip. "
    "Please recognize all possible emotional states of the main character. "
    "Please separate different emotional categories with commas and output "
    "only the clearly identifiable emotional categories in a list format, "
    "such as [happy, excited]. If none are identified, output an empty list."
)

TRANSLATION_PROMPT = (
    "Please translate the following content into {target_language}, keeping "
    "names and numbers unchanged, and output only the translation. Input: {text}"
)


def annotate_clip_emotions(
    complete_fn: CompleteFn,
    frame_paths: Sequence[str],
    prompt: Optional[str] = None,
) -> Optional[str]:
    """One GPT-4V-style annotation call: N frames + instruction → label list
    string (the per-sample core of every toolkit/gptv script)."""
    content: List[dict] = [
        {"type": "text", "text": (prompt or EMOTION_ANNOTATION_PROMPT).format(n_frames=len(frame_paths))}
    ]
    content += [image_content(p) for p in frame_paths]
    return complete_with_retry(complete_fn, [{"role": "user", "content": content}])


def annotate_dataset(
    complete_fn: CompleteFn,
    name2frames: Dict[str, Sequence[str]],
    save_csv: str,
    prompt: Optional[str] = None,
) -> Dict[str, str]:
    """Batch annotation with resumable csv bookkeeping (the gptv scripts'
    loop: skip-processed, append rows)."""
    done: Dict[str, str] = {}
    if os.path.exists(save_csv):
        done = {row["name"]: row["openset"] for row in read_csv(save_csv)}

    rows = [{"name": n, "openset": o} for n, o in done.items()]
    for name, frames in name2frames.items():
        if name in done:
            continue
        response = annotate_clip_emotions(complete_fn, frames, prompt)
        if response is None:
            continue
        rows.append({"name": name, "openset": response})
        write_rows_csv(save_csv, rows)
    return {row["name"]: row["openset"] for row in rows}


def translate_text(
    complete_fn: CompleteFn, text: str, target_language: str = "English"
) -> Optional[str]:
    """chi↔eng translation helper (reference qwen.py translation calls)."""
    prompt = TRANSLATION_PROMPT.format(target_language=target_language, text=text)
    return complete_with_retry(complete_fn, [{"role": "user", "content": prompt}])


class LocalJudgeTransport:
    """Adapter: the port's own LLM decode as the completion transport (no
    external API; wraps evaluation.judge.LLMJudge). The text parts of the
    messages become one prompt; images are not seen."""

    def __init__(self, judge):
        self.judge = judge

    def __call__(self, messages: List[Message]) -> str:
        parts = []
        for message in messages:
            content = message.get("content")
            if isinstance(content, str):
                parts.append(content)
            else:
                parts.extend(
                    c.get("text", "") for c in content if isinstance(c, dict) and c.get("type") == "text"
                )
        return self.judge.complete_batch(["\n".join(parts)])[0]
