"""Chat-UniVi-style VIDEO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/chat_univi.py. Matches the reference's
Chat-UniVi harness contract (reference: OV-MER/Chat-UniVi/main-video.py:
28-190): fps-based uniform frame sampling with a max_frames linspace cap
(main-video.py:44-60), the "recognize all possible emotional states"
prompt variants (main-video.py:141-145 verbatim), one <image> placeholder
per sampled frame, answer text after the assistant turn, responses into
the shared name2reason npz.

Model side: Chat-UniVi is a LLaVA-architecture model distributed outside
HF; the wrapper drives any HF `LlavaForConditionalGeneration`-compatible
checkpoint with Chat-UniVi's frame-sampling and prompting rules. Frames
decode through the port's media path (native decoder ladder, no decord)
and are preprocessed on the device through ops.image.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.chat_univi import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/llava-style-checkpoint")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.chat_univi --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

# the reference's two prompt variants (main-video.py:141-145)
PROMPT_WITH_SUBTITLE = (
    "Subtitle content of this video: {subtitle}; As an expert in the field of "
    "emotions, please focus on the facial expressions, body movements, "
    "environment, subtitle content, etc., in the video and recognize all "
    "possible emotional states of the individual."
)
PROMPT_NO_SUBTITLE = (
    "As an expert in the field of emotions, please focus on the facial "
    "expressions, body movements, environment, subtitle content, etc., in the "
    "video and recognize all possible emotional states of the individual."
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def sample_frame_indices(
    vlen: int, fps: float, video_framerate: int = 1, max_frames: int = 100
) -> np.ndarray:
    """Chat-UniVi's sampling rule (main-video.py:44-56): stride ≈
    fps/video_framerate over the whole clip, then a linspace cap at
    max_frames."""
    t_stride = max(1, int(round(float(fps) / video_framerate)))
    all_pos = np.arange(0, vlen, t_stride)
    if len(all_pos) > max_frames:
        all_pos = all_pos[np.linspace(0, len(all_pos) - 1, num=max_frames, dtype=int)]
    return all_pos


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 256,
    max_frames: int = 100,
    video_framerate: int = 1,
    assumed_fps: float = 25.0,
    model=None,
    tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str.

    model/tokenizer may be passed pre-built (tests drive a tiny random
    Llava); otherwise they load from model_dir. `assumed_fps` feeds the
    sampling rule when the container carries no fps metadata."""
    device = resolve_device(str(device))
    if model is None:
        from transformers import LlavaForConditionalGeneration

        model = LlavaForConditionalGeneration.from_pretrained(
            model_dir, torch_dtype=torch.float32
        ).to(device).eval()
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)

    image_token = tokenizer.convert_ids_to_tokens(model.config.image_token_index)
    vision = model.config.vision_config
    out_size = vision.image_size
    tokens_per_image = (vision.image_size // vision.patch_size) ** 2
    if getattr(model.config, "vision_feature_select_strategy", "default") != "default":
        tokens_per_image += 1

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # Chat-UniVi is video+text only
        # dense read, then the Chat-UniVi stride/cap rule over frame indices
        frames = base.read_video(video_path, max_frames)
        idx = sample_frame_indices(len(frames), assumed_fps, video_framerate,
                                   max_frames)
        frames = frames[idx]
        pixel_values = base.preprocess_frames(frames, out_size, device)
        n_frames = pixel_values.shape[0]
        text = (
            f"USER: {image_token * (tokens_per_image * n_frames)}\n"
            f"{_emotion_prompt(subtitle)} ASSISTANT:"
        )
        ids = torch.tensor([tokenizer.encode(text)], device=device)
        with torch.no_grad():
            out = model.generate(
                input_ids=ids,
                pixel_values=pixel_values,
                attention_mask=torch.ones_like(ids),
                max_new_tokens=max_new_tokens,
                do_sample=False,
            )
        reply = tokenizer.decode(out[0, ids.shape[1]:].tolist(), skip_special_tokens=True)
        return reply.replace("\n", " ").replace("\t", " ").strip()

    return model_fn


def main(argv=None) -> None:
    base.run_cli("Chat-UniVi-style OV-MER video runner", build_model_fn,
                 "output/ovmer-chat-univi", {"max_new_tokens": 256, "max_frames": 100}, argv)


if __name__ == "__main__":
    main()
