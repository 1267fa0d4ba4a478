"""SALMONN-style AUDIO-side adapter for the OV-MER zero-shot harness.

Port of the repo's ovmer/adapters/salmonn.py. Matches the reference's
SALMONN harness contract (reference: OV-MER/SALMONN/main-audio.py:
60-105): iterate the dataset's test names, feed the clip's AUDIO plus the
reference's prompt variants (main-audio.py:84-90 verbatim), normalize the
response, collect name2reason into the shared `results-{flag}.npz` format
that the evaluation scores. A clip whose wav cannot be read scores ""
through the harness (`load_clip_audio` raises ClipUnreadable), as in the
reference's try/except (main-audio.py:82-97); an error of Whisper or of
the LLM raises, where the root adapter's catch-all scored it "".

Model side: SALMONN is a Whisper-encoder + BEATs + Q-Former bridge into a
Vicuna LLM, distributed as out-of-tree code. Rather than executing
third-party remote code, this wrapper recomposes the same speech→LLM
pathway from HF-native parts: a `WhisperForConditionalGeneration` turns
the clip into text, and any HF causal LM reasons over the transcript with
SALMONN's prompt. Audio is read through the port's own wav path (native
wavio.cpp, no torchaudio/librosa).

Usage (python API):
    from affectgpt_tpu_torch.ovmer.adapters.salmonn import build_model_fn
    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot
    fn = build_model_fn("/path/to/whisper", "/path/to/llm")
    run_zero_shot("MER2023", fn, save_npz="out/result-mer2023/0.npz")

CLI (mirrors the reference script):
    python -m affectgpt_tpu_torch.ovmer.adapters.salmonn --whisper_dir ... \
        --llm_dir ... --dataset MER2023 --subtitle_flag subtitle --save_root out/ \
        [--device cpu]
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ovmer.adapters.qwen_audio import load_clip_audio

# the reference's two prompt variants (main-audio.py:84-90)
PROMPT_WITH_SUBTITLE = (
    "Subtitle content of the video: {subtitle} Please predict the emotional "
    "state of the individual in the audio. "
)
PROMPT_NO_SUBTITLE = (
    "Please predict the emotional state of the individual in the audio. "
)


def _emotion_prompt(subtitle: Optional[str]) -> str:
    if subtitle:
        return PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)
    return PROMPT_NO_SUBTITLE


def build_model_fn(
    whisper_dir: Optional[str],
    llm_dir: Optional[str] = None,
    device="cuda",
    max_new_tokens: int = 256,
    whisper=None,
    whisper_processor=None,
    llm=None,
    llm_tokenizer=None,
):
    """Returns model_fn(video_path, audio_path, subtitle, prompt) -> str.

    Components may be passed pre-built (tests drive tiny random models);
    otherwise they load from whisper_dir / llm_dir."""
    device = resolve_device(str(device))
    if whisper is None:
        from transformers import WhisperForConditionalGeneration

        whisper = WhisperForConditionalGeneration.from_pretrained(
            whisper_dir, torch_dtype=torch.float32
        ).to(device).eval()
    if whisper_processor is None:
        from transformers import AutoProcessor

        whisper_processor = AutoProcessor.from_pretrained(whisper_dir)
    if llm is None:
        from transformers import AutoModelForCausalLM

        llm = AutoModelForCausalLM.from_pretrained(
            llm_dir, torch_dtype=torch.float32
        ).to(device).eval()
    if llm_tokenizer is None:
        from transformers import AutoTokenizer

        llm_tokenizer = AutoTokenizer.from_pretrained(llm_dir)

    sampling_rate = whisper_processor.feature_extractor.sampling_rate

    def model_fn(video_path, audio_path, subtitle, prompt) -> str:
        del video_path, prompt  # audio-side harness: acoustic stream only
        wav = load_clip_audio(audio_path, sampling_rate)
        feats = whisper_processor(
            wav, sampling_rate=sampling_rate, return_tensors="pt"
        ).input_features.to(device)
        with torch.no_grad():
            asr = whisper.generate(feats, max_new_tokens=128, do_sample=False)
        transcript = whisper_processor.batch_decode(
            asr, skip_special_tokens=True
        )[0].strip()
        text = (
            f"USER: Speech content of the audio: {transcript}. "
            f"{_emotion_prompt(subtitle)}ASSISTANT:"
        )
        ids = torch.tensor([llm_tokenizer.encode(text)], device=device)
        with torch.no_grad():
            out = llm.generate(
                input_ids=ids, attention_mask=torch.ones_like(ids),
                max_new_tokens=max_new_tokens, do_sample=False,
            )
        reply = llm_tokenizer.decode(
            out[0, ids.shape[1]:].tolist(), skip_special_tokens=True
        )
        # same response normalization as the reference (main-audio.py:93)
        return reply.replace("\n", " ").replace("\t", " ").strip()

    return model_fn


def main(argv=None) -> None:
    import argparse

    from affectgpt_tpu_torch.ovmer.zero_shot_harness import run_zero_shot

    parser = argparse.ArgumentParser(description="SALMONN-style OV-MER audio runner")
    parser.add_argument("--whisper_dir", required=True)
    parser.add_argument("--llm_dir", required=True)
    parser.add_argument("--dataset", required=True, help="comma-separated dataset names")
    parser.add_argument("--subtitle_flag", default="subtitle",
                        choices=["subtitle", "nosubtitle"])
    parser.add_argument("--save_root", default="output/ovmer-salmonn")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max_new_tokens", type=int, default=256)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)

    fn = build_model_fn(args.whisper_dir, args.llm_dir, device=args.device,
                        max_new_tokens=args.max_new_tokens)
    for dataset in args.dataset.split(","):
        run_zero_shot(
            dataset, fn,
            save_npz=os.path.join(
                args.save_root, f"result-{dataset.lower()}",
                f"results-{args.subtitle_flag}.npz",
            ),
            with_subtitle=args.subtitle_flag == "subtitle",
            limit=args.limit,
        )


if __name__ == "__main__":
    main()
