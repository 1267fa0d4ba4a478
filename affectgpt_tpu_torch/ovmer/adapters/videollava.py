"""Video-LLaVA adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/videollava.py. Worked example of the
`model_fn` contract: wraps an HF VideoLlavaForConditionalGeneration
checkpoint and drives it over the evaluation datasets through
`run_zero_shot`, emitting the shared npz result format that
`python -m affectgpt_tpu_torch.evaluation` scores.

Capability-parity with the reference's per-model script
(reference: OV-MER/Video-LLaVA/main-video.py:22-110): the same
subtitle/no-subtitle emotion-expert prompts, 8 uniformly sampled frames,
answer text taken after the ASSISTANT turn. Frames decode through the
port's media ladder (native decoder / .frames.npy fallback, no decord)
and are CLIP-normalized on the device (ops.image), and the <video>
placeholder is expanded host-side from the checkpoint's vision geometry,
so neither torchvision nor the HF video processor is needed.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.videollava import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/Video-LLaVA-7B-hf")  # on the card; device="cpu" to ask
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.videollava --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

# the reference's two zero-shot prompt variants (main-video.py:76-79)
PROMPT_WITH_SUBTITLE = (
    "Subtitle content of this video: {subtitle}; As an expert in the field of "
    "emotions, please focus on the facial expressions, body movements, "
    "environment, subtitle content, etc., in the video to discern clues related "
    "to the emotions of the individual. Please provide a detailed description "
    "and ultimately predict the emotional state of the individual in the video."
)
PROMPT_NO_SUBTITLE = (
    "As an expert in the field of emotions, please focus on the facial "
    "expressions, body movements, environment, subtitle content, etc., in the "
    "video to discern clues related to the emotions of the individual. Please "
    "provide a detailed description and ultimately predict the emotional state "
    "of the individual in the video."
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def num_video_tokens(config) -> int:
    """Placeholder count per video, from the checkpoint's vision geometry
    (the HF VideoLlavaProcessor expansion rule)."""
    vision = config.vision_config
    patches = (vision.image_size // vision.patch_size) ** 2
    per_frame = patches + 1  # CLS kept for video features
    if getattr(config, "vision_feature_select_strategy", "default") != "default":
        per_frame = patches + 2
    num_frames = getattr(vision, "num_frames", 8)
    return per_frame * num_frames


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 512,
    n_frames: int = 8,
    model=None,
    tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str.

    model/tokenizer may be passed pre-built (tests drive a tiny random
    VideoLlava); otherwise they load from model_dir."""
    device = resolve_device(str(device))
    if model is None:
        from transformers import VideoLlavaForConditionalGeneration

        model = VideoLlavaForConditionalGeneration.from_pretrained(
            model_dir, torch_dtype=torch.float32
        ).to(device).eval()
    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_dir)

    video_token = tokenizer.convert_ids_to_tokens(model.config.video_token_index)
    n_tok = num_video_tokens(model.config)
    out_size = model.config.vision_config.image_size

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # Video-LLaVA is video+text only
        frames = base.read_video(video_path, n_frames)  # [T,H,W,3] u8
        pixel_values_videos = base.preprocess_frames(frames, out_size, device)[None]
        text = f"USER: {video_token * n_tok}\n{_emotion_prompt(subtitle)} ASSISTANT:"
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
        return reply.replace("\n", " ").replace("\t", " ").strip()

    return model_fn


def main(argv=None) -> None:
    import argparse

    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot

    parser = argparse.ArgumentParser(description="Video-LLaVA OV-MER zero-shot runner")
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--dataset", required=True, help="comma-separated dataset names")
    parser.add_argument("--subtitle_flag", default="subtitle",
                        choices=["subtitle", "nosubtitle"])
    parser.add_argument("--save_root", default="output/ovmer-videollava")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max_new_tokens", type=int, default=512)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)

    fn = build_model_fn(args.model_dir, device=args.device,
                        max_new_tokens=args.max_new_tokens)
    for dataset in args.dataset.split(","):
        run_zero_shot(
            dataset, fn,
            save_npz=os.path.join(args.save_root, f"result-{dataset.lower()}", "0.npz"),
            with_subtitle=args.subtitle_flag == "subtitle",
            limit=args.limit,
        )


if __name__ == "__main__":
    main()
