"""Otter-style VIDEO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/otter.py. Matches the reference's Otter
harness contract (reference: OV-MER/Otter/main-video.py:36-100): 16
frames sampled at a fixed stride of total//16 from frame 0
(extract_frames, main-video.py:36-51), the flamingo-style
"<image>User: {prompt} GPT:<answer>" format (main-video.py:61-62), beam
search with num_beams=3 / no_repeat_ngram_size=3 / max_new_tokens=512
and the ["User:", "GPT1:", "GFT:", "GPT:"] bad-words list
(main-video.py:80-88), the <answer>/<|endofchunk|> response parse
(main-video.py:89-100), and the emotion prompt variants
(main-video.py:162-164 verbatim).

Model side: Otter is an OpenFlamingo derivative distributed outside HF;
the wrapper drives any HF `LlavaForConditionalGeneration`-compatible
checkpoint (one image-token block per sampled frame) with Otter's
sampling, prompting and decoding rules. Frames decode through the port's
media path.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.otter import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/llava-style-checkpoint")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.otter --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

# the reference's two prompt variants (main-video.py:162-164)
PROMPT_WITH_SUBTITLE = (
    "Subtitle content of this video: {subtitle}; As an expert in the field of "
    "emotions, please focus on the facial expressions, body movements, "
    "environment, subtitle content, etc., in the video to discern clues "
    "related to the emotions of the individual. Please provide a detailed "
    "description and ultimately predict the emotional state of the individual "
    "in the video."
)
PROMPT_NO_SUBTITLE = (
    "As an expert in the field of emotions, please focus on the facial "
    "expressions, body movements, environment, subtitle content, etc., in the "
    "video to discern clues related to the emotions of the individual. Please "
    "provide a detailed description and ultimately predict the emotional "
    "state of the individual in the video."
)
# bad-words list (main-video.py:80)
BAD_WORDS = ["User:", "GPT1:", "GFT:", "GPT:"]


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def sample_frame_indices(vlen: int, num_frames: int = 16) -> np.ndarray:
    """Otter's fixed-stride rule (extract_frames, main-video.py:36-51):
    frame i*(total//num_frames) for i in range(num_frames)."""
    step = max(1, vlen // num_frames)
    return np.arange(num_frames) * step


def parse_answer(decoded: str) -> str:
    """Otter's response parse (main-video.py:89-100)."""
    return (
        decoded.split("<answer>")[-1]
        .lstrip().rstrip()
        .split("<|endofchunk|>")[0]
        .lstrip().rstrip()
        .lstrip('"').rstrip('"')
    )


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 512,
    num_frames: int = 16,
    model=None,
    tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str."""
    device = resolve_device(str(device))
    if model is None:
        model, tokenizer = base.load_image_llava(model_dir, device)
    image_token = tokenizer.convert_ids_to_tokens(model.config.image_token_index)
    out_size, tokens_per_image = base.image_tokens_per_frame(model)
    # bad-words token ids; empty encodings (words absent from a small
    # vocab) are dropped — HF rejects empty bad-word sequences
    bad_words_ids = [
        ids for ids in tokenizer(BAD_WORDS, add_special_tokens=False).input_ids
        if ids
    ] or None

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # Otter is video+text only
        frames = base.load_frames(
            video_path, lambda n: sample_frame_indices(n, num_frames)
        )
        pixel_values = base.preprocess_frames(frames, out_size, device)
        # flamingo-style format (main-video.py:61-62), one token block
        # per frame for the image-per-frame model family
        blocks = image_token * (tokens_per_image * pixel_values.shape[0])
        text = f"{blocks}User: {_emotion_prompt(subtitle)} GPT:<answer>"
        ids = torch.tensor([tokenizer.encode(text)], device=device)
        with torch.no_grad():
            out = model.generate(
                input_ids=ids,
                pixel_values=pixel_values,
                attention_mask=torch.ones_like(ids),
                max_new_tokens=max_new_tokens,
                num_beams=3,
                no_repeat_ngram_size=3,
                bad_words_ids=bad_words_ids,
            )
        decoded = tokenizer.decode(out[0].tolist())
        return parse_answer(decoded).replace("\n", " ").replace("\t", " ").strip()

    return model_fn


def main(argv=None) -> None:
    base.run_cli("Otter-style OV-MER video runner", build_model_fn,
                 "output/ovmer-otter",
                 {"max_new_tokens": 512, "num_frames": 16}, argv)


if __name__ == "__main__":
    main()
