"""Single-clip inference, in PyTorch.

    python -m affectgpt_tpu_torch.inference_sample [--cfg-path <yaml|json>]
        [--video_path V] [--audio_path A] [--subtitle S] [--device cuda|cpu] ...

Port of the repo's root inference_sample.py (reference:
AffectGPT/inference_sample.py:110-223): one (video, audio, subtitle) triple
in, the emotion description printed. The media are decoded on the host
(data/media.py: 8 uniform frames; the audio resampled to 16 kHz, made mono,
padded to 2 s and cut into 8 clips), the towers encode them on the device
(`encode_media_features`) and `Chat.answer_batch` answers. The run goes to
the card unless `--device cpu` is given; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse

import torch

from affectgpt_tpu_torch.bootstrap import build_model
from affectgpt_tpu_torch.config import Config
from affectgpt_tpu_torch.data import media
from affectgpt_tpu_torch.inference.chat import Chat, encode_media_features
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.ops import audio as audio_ops
from affectgpt_tpu_torch.utils.logging import setup_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="AffectGPT single-clip inference (PyTorch)")
    parser.add_argument("--cfg-path", default=None, help="path to configuration file.")
    parser.add_argument("--options", nargs="+")
    parser.add_argument("--zeroshot", action="store_true", default=False)
    parser.add_argument("--outside_user_message", default=None)
    parser.add_argument("--outside_face_or_frame", default=None)
    parser.add_argument("--video_path", default=None)
    parser.add_argument("--audio_path", default=None)
    parser.add_argument("--subtitle", default=None)
    parser.add_argument("--max_new_tokens", type=int, default=300)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    setup_logger()
    device = resolve_device(args.device)
    cfg = Config.from_file(args.cfg_path, args.options) if args.cfg_path \
        else Config.from_dict({}, options=args.options)
    face_or_frame = args.outside_face_or_frame or cfg.inference.get("face_or_frame", "frame")
    user_message = args.outside_user_message or (
        "Please infer the person's emotional state and provide your reasoning process.")

    model_cfg, frozen, trainable, tokenizer = build_model(
        cfg.model.to_dict(), with_encoders=True, device=device)
    chat = Chat(frozen, trainable, model_cfg, tokenizer)
    raw = {}
    if args.video_path:
        frames = media.read_video_frames(args.video_path, n_frms=8)
        raw["frame"] = torch.as_tensor(frames[None], device=device)  # [1, T, H, W, 3]
    if args.audio_path:
        wav, rate = media.read_wav(args.audio_path)
        raw["audio"] = torch.as_tensor(audio_ops.host_audio_clips(wav, rate)[None],
                                       device=device)  # [1, 8, 1, 32000]
    features = encode_media_features(frozen, model_cfg, raw) if raw else {}
    outputs = chat.answer_batch(
        face_or_frame, [args.subtitle], user_message, features,
        generator=torch.Generator(device=device).manual_seed(0),
        max_new_tokens=args.max_new_tokens)
    print(outputs[0])
    return outputs[0]


if __name__ == "__main__":
    main()
