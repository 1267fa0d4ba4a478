"""Video-ChatGPT-style VIDEO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/video_chatgpt.py. Matches the
reference's Video-ChatGPT harness contract (reference:
OV-MER/Video-ChatGPT/main-video.py:96-150): iterate the dataset's test
names, 100-frame uniform sampling over the whole clip (video_chatgpt's
load_video num_frm=100), the detailed-description emotion prompt variants
(main-video.py:132-135 verbatim), responses normalized and saved as
name2reason in the shared `results-{flag}.npz` format that the evaluation
scores.

Model side: Video-ChatGPT is a CLIP-frames → spatio-temporal-pooled
features → Vicuna model distributed outside HF. The wrapper drives
transformers-native `LlavaNextVideoForConditionalGeneration` — the same
architecture family (CLIP tower, spatially pooled per-frame tokens, LLM
decoder), shipped in transformers, so no remote code executes; its
`pixel_values_videos` are [1, T, 3, S, S]. Frames decode through the
port's media path and are preprocessed on the device through ops.image.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.video_chatgpt import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/llava-next-video-checkpoint")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.video_chatgpt --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import torch

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

# the reference's two prompt variants (main-video.py:132-135)
PROMPT_BASE = (
    "As an expert in the field of emotions, please focus on the facial "
    "expressions, body movements, environment, acoustic information, subtitle "
    "content, etc., in the video to discern clues related to the emotions of "
    "the individual. Please provide a detailed description and ultimately "
    "predict the emotional state of the individual in the video. "
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_BASE + f"Subtitle content of the video: {subtitle} "
    return PROMPT_BASE


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 256,
    num_frames: int = 100,
    model=None,
    tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str.

    model/tokenizer may be passed pre-built (tests drive a tiny random
    LlavaNextVideo); otherwise they load from model_dir. num_frames
    follows Video-ChatGPT's 100-frame uniform sampling."""
    device = resolve_device(str(device))
    if model is None:
        from transformers import LlavaNextVideoForConditionalGeneration

        model = LlavaNextVideoForConditionalGeneration.from_pretrained(
            model_dir, torch_dtype=torch.float32
        ).to(device).eval()
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)

    video_token = tokenizer.convert_ids_to_tokens(model.config.video_token_index)
    vision = model.config.vision_config
    out_size = vision.image_size
    pool = getattr(model.config, "spatial_pool_stride", 2)
    tokens_per_frame = (vision.image_size // vision.patch_size // pool) ** 2

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # Video-ChatGPT is video+text only
        frames = base.read_video(video_path, num_frames)
        pixel_values_videos = base.preprocess_frames(frames, out_size, device)[None]  # [1,T,3,H,W]
        n_frames = pixel_values_videos.shape[1]
        text = (
            f"USER: {video_token * (tokens_per_frame * n_frames)}\n"
            f"{_emotion_prompt(subtitle)}ASSISTANT:"
        )
        ids = torch.tensor([tokenizer.encode(text)], device=device)
        with torch.no_grad():
            out = model.generate(
                input_ids=ids,
                pixel_values_videos=pixel_values_videos,
                attention_mask=torch.ones_like(ids),
                max_new_tokens=max_new_tokens,
                do_sample=False,
            )
        reply = tokenizer.decode(out[0, ids.shape[1]:].tolist(), skip_special_tokens=True)
        # same response normalization as the reference (main-video.py:140)
        return reply.replace("\n", " ").replace("\t", " ").strip()

    return model_fn


def main(argv=None) -> None:
    base.run_cli("Video-ChatGPT-style OV-MER video runner", build_model_fn,
                 "output/ovmer-video-chatgpt", {"max_new_tokens": 256, "num_frames": 100}, argv)


if __name__ == "__main__":
    main()
