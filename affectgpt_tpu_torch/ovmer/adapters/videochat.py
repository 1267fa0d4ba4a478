"""VideoChat-style VIDEO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/videochat.py. Matches the reference's
VideoChat harness contract (reference: OV-MER/VideoChat/main-video.py:
95-137 and conversation.py:87-93): num_segments=8 segment-MIDPOINT frame
sampling (seg_size = (T-1)/8, index = seg_size/2 + round(seg_size*i)),
the "detailed description and ultimately predict" prompt variants
(main-video.py:118-120 verbatim, including the `;` subtitle separator and
trailing space), greedy single-beam generation at temperature 1.0
(main-video.py:111-112), responses normalized into the shared name2reason
npz.

Model side: VideoChat is a BLIP2-style video-chat model distributed
outside HF; the wrapper drives any HF
`LlavaForConditionalGeneration`-compatible checkpoint (one image-token
block per sampled segment) with VideoChat's sampling and prompting rules.
Frames decode through the port's media path (native decoder ladder, no
decord).

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.videochat import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/llava-style-checkpoint")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.videochat --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

# the reference's two prompt variants (main-video.py:118-120)
PROMPT_WITH_SUBTITLE = (
    "Subtitle content of the video: {subtitle}; As an expert in the field of "
    "emotions, please focus on the facial expressions, body movements, "
    "environment, subtitle content, etc., in the video to discern clues "
    "related to the emotions of the individual. Please provide a detailed "
    "description and ultimately predict the emotional state of the individual "
    "in the video. "
)
PROMPT_NO_SUBTITLE = (
    "As an expert in the field of emotions, please focus on the facial "
    "expressions, body movements, environment, subtitle content, etc., in the "
    "video to discern clues related to the emotions of the individual. Please "
    "provide a detailed description and ultimately predict the emotional "
    "state of the individual in the video. "
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def sample_frame_indices(vlen: int, num_segments: int = 8) -> np.ndarray:
    """VideoChat's segment-midpoint rule (conversation.py:87-93)."""
    seg_size = float(vlen - 1) / num_segments
    start = int(seg_size / 2)
    return np.array(
        [start + int(np.round(seg_size * idx)) for idx in range(num_segments)]
    )


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 256,
    num_segments: int = 8,
    model=None,
    tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str.

    model/tokenizer may be passed pre-built (tests drive a tiny random
    Llava); otherwise they load from model_dir."""
    device = resolve_device(str(device))
    if model is None:
        model, tokenizer = base.load_image_llava(model_dir, device)
    image_token = tokenizer.convert_ids_to_tokens(model.config.image_token_index)
    out_size, tokens_per_image = base.image_tokens_per_frame(model)

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # VideoChat is video+text only
        frames = base.load_frames(
            video_path, lambda n: sample_frame_indices(n, num_segments)
        )
        pixel_values = base.preprocess_frames(frames, out_size, device)
        text = (
            f"USER: {image_token * (tokens_per_image * pixel_values.shape[0])}\n"
            f"{_emotion_prompt(subtitle)}ASSISTANT:"
        )
        # greedy, num_beams=1, temperature 1.0 (main-video.py:111-112)
        return base.generate_reply(
            model, tokenizer, text, device,
            {"max_new_tokens": max_new_tokens, "do_sample": False,
             "num_beams": 1},
            pixel_values=pixel_values,
        )

    return model_fn


def main(argv=None) -> None:
    base.run_cli("VideoChat-style OV-MER video runner", build_model_fn,
                 "output/ovmer-videochat",
                 {"max_new_tokens": 256, "num_segments": 8}, argv)


if __name__ == "__main__":
    main()
