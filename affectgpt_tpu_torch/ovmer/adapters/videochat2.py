"""VideoChat2-style VIDEO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/videochat2.py. Matches the reference's
VideoChat2 harness contract (reference: OV-MER/VideoChat2/main-video.py:
98-157): num_segments=8 segment-midpoint sampling (same get_index rule
as VideoChat, conversation.py), the VideoChat2 prompt variants
(main-video.py:139-141 verbatim — note the subtitle clause joins with a
SPACE, not the `;` VideoChat uses), responses into the shared name2reason
npz.

Model side: VideoChat2 is a UMT-encoder + Vicuna model distributed
outside HF; its encoder consumes the sampled segments jointly as a video,
so the wrapper drives an HF `LlavaNextVideoForConditionalGeneration`-
compatible checkpoint (video tokens, frames pooled jointly) with
VideoChat2's sampling and prompting rules. Frames decode through the
port's media path.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.videochat2 import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/llava-next-video-checkpoint")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.videochat2 --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base
from affectgpt_tpu_torch.ovmer.adapters.videochat import sample_frame_indices

# the reference's two prompt variants (main-video.py:139-141)
PROMPT_WITH_SUBTITLE = (
    "Subtitle content of the video: {subtitle} As an expert in the field of "
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


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 256,
    num_segments: int = 8,
    model=None,
    tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str."""
    device = resolve_device(str(device))
    if model is None:
        model, tokenizer = base.load_video_llava(model_dir, device)
    video_token = tokenizer.convert_ids_to_tokens(model.config.video_token_index)
    out_size, tokens_per_frame = base.video_tokens_per_frame(model)

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # VideoChat2 is video+text only
        frames = base.load_frames(
            video_path, lambda n: sample_frame_indices(n, num_segments)
        )
        pixel_values_videos = base.preprocess_frames(frames, out_size, device)[None]
        n_frames = pixel_values_videos.shape[1]
        text = (
            f"USER: {video_token * (tokens_per_frame * n_frames)}\n"
            f"{_emotion_prompt(subtitle)}ASSISTANT:"
        )
        return base.generate_reply(
            model, tokenizer, text, device,
            {"max_new_tokens": max_new_tokens, "do_sample": False,
             "num_beams": 1},
            pixel_values_videos=pixel_values_videos,
        )

    return model_fn


def main(argv=None) -> None:
    base.run_cli("VideoChat2-style OV-MER video runner", build_model_fn,
                 "output/ovmer-videochat2",
                 {"max_new_tokens": 256, "num_segments": 8}, argv)


if __name__ == "__main__":
    main()
