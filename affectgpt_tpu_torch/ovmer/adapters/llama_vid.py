"""LLaMA-VID-style VIDEO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/llama_vid.py. Matches the reference's
LLaMA-VID harness contract (reference: OV-MER/LLaMA-VID/main-video.py:
35-38,95-198): 1-fps frame sampling (stride = round(avg_fps/fps) over the
whole stream, load_video), the llava_v1 conversation ("A chat between a
curious human and an artificial intelligence assistant. ... USER:
<image>\\n{inp} ASSISTANT:", main-video.py:103-163), sampled decoding at
temperature 0.5 / top_p 0.7 / max_new_tokens 512 (the reference's video
defaults, main-video.py:48-50,173-177), the </s> strip and newline
normalization (main-video.py:184-187), and the emotion prompt variants
(main-video.py:139-141 verbatim).

Model side: LLaMA-VID is a LLaVA-architecture model with a context-token
compressor distributed outside HF; the wrapper drives any HF
`LlavaForConditionalGeneration`-compatible checkpoint (one image-token
block per sampled frame) with LLaMA-VID's sampling, prompting and
decoding rules. Frames decode through the port's media path.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.llama_vid import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/llava-style-checkpoint")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.llama_vid --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

# the reference's two prompt variants (main-video.py:139-141)
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
# llava_v1 system preamble (main-video.py:160-163)
SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions."
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def sample_frame_indices(vlen: int, avg_fps: float = 25.0, fps: int = 1) -> np.ndarray:
    """LLaMA-VID's 1-fps rule (load_video, main-video.py:35-38):
    stride = round(avg_fps/fps) over the whole stream."""
    stride = max(1, int(round(avg_fps / fps)))
    return np.arange(0, vlen, stride)


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 512,
    assumed_fps: float = 25.0,
    model=None,
    tokenizer=None,
    do_sample: bool = True,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str.

    do_sample=False forces greedy decoding (tests); the reference samples
    at temperature 0.5 / top_p 0.7."""
    device = resolve_device(str(device))
    if model is None:
        model, tokenizer = base.load_image_llava(model_dir, device)
    image_token = tokenizer.convert_ids_to_tokens(model.config.image_token_index)
    out_size, tokens_per_image = base.image_tokens_per_frame(model)

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # LLaMA-VID is video+text only
        frames = base.load_frames(
            video_path, lambda n: sample_frame_indices(n, assumed_fps)
        )
        pixel_values = base.preprocess_frames(frames, out_size, device)
        blocks = image_token * (tokens_per_image * pixel_values.shape[0])
        text = (
            f"{SYSTEM} USER: {blocks}\n{_emotion_prompt(subtitle)} ASSISTANT:"
        )
        gen = {"max_new_tokens": max_new_tokens, "do_sample": do_sample}
        if do_sample:
            gen.update(temperature=0.5, top_p=0.7)  # main-video.py:48-50
        reply = base.generate_reply(model, tokenizer, text, device, gen,
                                    pixel_values=pixel_values)
        if reply.endswith("</s>"):  # main-video.py:187
            reply = reply[: -len("</s>")]
        return reply

    return model_fn


def main(argv=None) -> None:
    base.run_cli("LLaMA-VID-style OV-MER video runner", build_model_fn,
                 "output/ovmer-llama-vid", {"max_new_tokens": 512}, argv)


if __name__ == "__main__":
    main()
