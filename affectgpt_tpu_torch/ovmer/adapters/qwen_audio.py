"""Qwen-Audio-style AUDIO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/qwen_audio.py. Matches the reference's
audio-only harness contract (reference: OV-MER/Qwen-Audio/main-audio.py:
14-87): iterate the dataset's test names, feed the clip's AUDIO plus the
reference's acoustic emotion-expert prompt (with/without subtitle,
main-audio.py:64-72 verbatim), collect name2reason into the shared npz
result format that the evaluation scores.

Model side: the reference loads the Qwen-Audio-Chat trust_remote_code
checkpoint; here the wrapper drives the HF-native successor
`Qwen2AudioForConditionalGeneration` (same Whisper-encoder + Qwen-decoder
architecture, shipped in transformers), so no remote code executes. Audio
is read through the port's own wav path (`data.media.read_wav` — native
wavio.cpp, no torchaudio/librosa), its channels averaged to mono. The
root adapter averages over the sample axis of read_wav's [channels,
samples] and hands the processor one value a channel; the port averages
the channels.

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.qwen_audio import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/Qwen2-Audio-7B-Instruct")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.qwen_audio --model_dir ... \
        --dataset MER2023 --subtitle_flag subtitle --save_root out/ [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from affectgpt_tpu_torch.data import media
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base
from affectgpt_tpu_torch.ovmer.zero_shot_harness import ClipUnreadable

# the reference's two audio prompt variants (main-audio.py:64-72)
PROMPT_WITH_SUBTITLE = (
    "Subtitle content of the audio: {subtitle}; As an expert in the field of "
    "emotions, please focus on the acoustic information and subtitle content "
    "in the audio to discern clues related to the emotions of the individual. "
    "Please provide a detailed description and ultimately predict the "
    "emotional state of the individual in the audio."
)
PROMPT_NO_SUBTITLE = (
    "As an expert in the field of emotions, please focus on the acoustic "
    "information and subtitle content in the audio to discern clues related "
    "to the emotions of the individual. Please provide a detailed description "
    "and ultimately predict the emotional state of the individual in the audio."
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def _resample_linear(wav: np.ndarray, rate: int, target: int) -> np.ndarray:
    if rate == target or wav.size == 0:
        return wav
    n_out = max(1, int(round(wav.shape[0] * target / rate)))
    x_old = np.linspace(0.0, 1.0, num=wav.shape[0], endpoint=False)
    x_new = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
    return np.interp(x_new, x_old, wav).astype(np.float32)


def load_clip_audio(audio_path: Optional[str], target_rate: int = 16000) -> np.ndarray:
    """Mono float32 waveform at the feature extractor's rate, via the port's
    native wav reader; ClipUnreadable (chained from the reader's error)
    where the wav cannot be read, a None path included."""
    if audio_path is None:
        raise ClipUnreadable("the clip has no audio path")
    try:
        wav, rate = media.read_wav(audio_path)
    except Exception as error:
        raise ClipUnreadable(f"{audio_path}: {error}") from error
    wav = np.asarray(wav, np.float32)
    if wav.ndim == 2:  # [channels, samples] → mono
        wav = wav.mean(axis=0)
    return _resample_linear(wav, rate, target_rate)


def build_model_fn(
    model_dir: Optional[str],
    device="cuda",
    max_new_tokens: int = 256,
    model=None,
    processor=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str.

    model/processor may be passed pre-built (tests drive a tiny random
    Qwen2Audio); otherwise they load from model_dir."""
    device = resolve_device(str(device))
    if model is None:
        from transformers import Qwen2AudioForConditionalGeneration

        model = Qwen2AudioForConditionalGeneration.from_pretrained(
            model_dir, torch_dtype=torch.float32
        ).to(device).eval()
    if processor is None:
        from transformers import AutoProcessor

        processor = AutoProcessor.from_pretrained(model_dir)

    sampling_rate = processor.feature_extractor.sampling_rate
    audio_token = processor.tokenizer.convert_ids_to_tokens(
        model.config.audio_token_index
    )

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del video_path, prompt  # audio-side harness: acoustic stream only
        wav = load_clip_audio(audio_path, sampling_rate)
        text = f"Audio 1: {audio_token}\n{_emotion_prompt(subtitle)}"
        inputs = processor(
            text=text, audio=[wav], sampling_rate=sampling_rate,
            return_tensors="pt",
        ).to(device)
        inputs.pop("token_type_ids", None)  # tokenizer extra generate() rejects
        with torch.no_grad():
            out = model.generate(
                **inputs, max_new_tokens=max_new_tokens, do_sample=False,
            )
        n_in = inputs["input_ids"].shape[1]
        reply = processor.tokenizer.decode(
            out[0, n_in:].tolist(), skip_special_tokens=True
        )
        # same response normalization as the reference (main-audio.py:75)
        return reply.replace("\n", " ").replace("\t", " ").strip()

    return model_fn


def main(argv=None) -> None:
    base.run_cli("Qwen-Audio-style OV-MER audio runner", build_model_fn,
                 "output/ovmer-qwen-audio", {"max_new_tokens": 256}, argv)


if __name__ == "__main__":
    main()
