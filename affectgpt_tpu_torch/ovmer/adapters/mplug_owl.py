"""mPLUG-Owl-style VIDEO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/mplug_owl.py. Matches the reference's
mPLUG-Owl harness contract (reference: OV-MER/mPLUG-Owl/main-video.py): 4
frames per video (processor call `num_frames=4`, main-video.py:91,
uniformly sampled like MplugOwlProcessor), the flamingo-style
conversation prompt with a `<|video|>` placeholder (main-video.py:82-86,
indentation preserved verbatim), sampling with do_sample=True / top_k=5 /
max_length=512 (main-video.py:87-90), skip-special-tokens decode with
newline/tab → space cleanup (main-video.py:99-100), the empty response
for an overlong prompt (main-video.py:96-102 — overlong subtitles), and
the emotion prompt variants (main-video.py:77-80 verbatim).

The empty response is given where the prompt reaches max_length, the
case in which generate refuses it; unlike the root adapter's catch-all
around generate, any other error of the model or the device raises.

Model side: mPLUG-Owl ships its own modeling code outside HF
(mplug_owl_video package); the wrapper drives any HF
`LlavaForConditionalGeneration`-compatible checkpoint, expanding the
`<|video|>` placeholder into one image-token block per sampled frame.
Frames decode through the port's media path.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.mplug_owl import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/llava-style-checkpoint")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.mplug_owl --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

# the reference's two prompt variants (main-video.py:77-80)
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
    "video to discern clues related to the emotions of the individual. "
    "Please provide a detailed description and ultimately predict the "
    "emotional state of the individual in the video."
)

# conversation template (main-video.py:82-86; the reference's triple-quoted
# literal keeps 12-space indentation on the continuation lines)
CONVERSATION_TEMPLATE = (
    "The following is a conversation between a curious human and AI "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the user's questions.\n"
    "            Human: <|video|>\n"
    "            Human: {user_message}\n"
    "            AI: "
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def sample_frame_indices(vlen: int, num_frames: int = 4) -> np.ndarray:
    """Uniform sampling (MplugOwlProcessor's video sampling for
    `num_frames=4`, main-video.py:91)."""
    return np.linspace(0, max(vlen - 1, 0), num_frames).astype(np.int64)


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_length: int = 512,
    num_frames: int = 4,
    model=None,
    tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str."""
    device = resolve_device(str(device))
    if model is None:
        model, tokenizer = base.load_image_llava(model_dir, device)
    image_token = tokenizer.convert_ids_to_tokens(model.config.image_token_index)
    out_size, tokens_per_image = base.image_tokens_per_frame(model)

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del audio_path, prompt  # mPLUG-Owl is video+text only
        frames = base.load_frames(
            video_path, lambda n: sample_frame_indices(n, num_frames)
        )
        pixel_values = base.preprocess_frames(frames, out_size, device)
        blocks = image_token * (tokens_per_image * pixel_values.shape[0])
        text = CONVERSATION_TEMPLATE.format(
            user_message=_emotion_prompt(subtitle)
        ).replace("<|video|>", blocks)
        ids = torch.tensor([tokenizer.encode(text)], device=device)
        # max_length passed VERBATIM (reference main-video.py uses a fixed
        # max_length=512): a prompt that reaches it is refused by generate,
        # and the reference scores such clips "" (overlong subtitles)
        if ids.shape[1] >= max_length:
            return ""
        with torch.no_grad():
            out = model.generate(
                input_ids=ids,
                pixel_values=pixel_values,
                attention_mask=torch.ones_like(ids),
                do_sample=True,
                top_k=5,
                max_length=max_length,
            )
        decoded = tokenizer.decode(
            out[0, ids.shape[1]:].tolist(), skip_special_tokens=True
        )
        return decoded.replace("\n", " ").replace("\t", " ").strip()

    return model_fn


def main(argv=None) -> None:
    base.run_cli("mPLUG-Owl-style OV-MER video runner", build_model_fn,
                 "output/ovmer-mplug-owl",
                 {"max_length": 512, "num_frames": 4}, argv)


if __name__ == "__main__":
    main()
