"""Shared machinery for the OV-MER video-side adapters.

Port of the repo's ovmer/adapters/_llava_base.py. Each reference harness
(OV-MER/<Model>/main-video.py) is ~150 lines of copy-pasted script around
three model-specific choices: the frame sampling rule, the prompt
template, and the generate() arguments. The adapters in this package keep
those three choices verbatim (cited to their reference lines) and share
everything else here: decoding frames through the port's media ladder (no
decord), preprocessing on the device through ops.image, driving an HF
image-per-frame (`LlavaForConditionalGeneration`) or video-token
(`LlavaNextVideoForConditionalGeneration`) model, and the common CLI that
feeds ovmer.zero_shot_harness.

The host read of a clip is the one place an adapter turns an error into
`ClipUnreadable` (the harness scores that clip ""); everything after it,
on the device or in the wrapped model, raises as it is.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from affectgpt_tpu_torch.data import media
from affectgpt_tpu_torch.ops import image as image_ops
from affectgpt_tpu_torch.ovmer.zero_shot_harness import ClipUnreadable, run_zero_shot


def read_video(video_path: Optional[str], n_frms: int, sampling_name: str = "uniform"):
    """media.read_video_frames on the host → [T, H, W, 3] uint8, or
    ClipUnreadable (chained from the reader's error) where the clip cannot
    be read, a None path included."""
    if video_path is None:
        raise ClipUnreadable("the clip has no video path")
    try:
        return media.read_video_frames(video_path, n_frms=n_frms, sampling_name=sampling_name)
    except Exception as error:
        raise ClipUnreadable(f"{video_path}: {error}") from error


def load_frames(video_path: str, frame_indices_fn, max_read: int = 512):
    """Dense-read up to max_read frames, then apply the adapter's index
    rule over the read frames (the reference rules index the raw stream;
    the media ladder's dense read stands in for decord's VideoReader)."""
    frames = read_video(video_path, max_read)
    idx = np.asarray(frame_indices_fn(len(frames)), np.int64)
    idx = np.clip(idx, 0, len(frames) - 1)
    return frames[idx]


def preprocess_frames(frames, out_size: int, device="cuda") -> torch.Tensor:
    """[T,H,W,3] uint8 → [T,3,S,S] float32 on `device`: the uint8 frames go
    to the device and are resized and CLIP-normalized there (ops.image, the
    reference CLIPImageProcessor's eval transform)."""
    pixels = image_ops.preprocess_frames_eval(torch.as_tensor(frames, device=device),
                                              out_size=out_size)
    return pixels.permute(1, 0, 2, 3).contiguous()  # [3,T,S,S] → [T,3,S,S]


def load_image_llava(model_dir: str, device):
    from transformers import AutoTokenizer, LlavaForConditionalGeneration

    model = LlavaForConditionalGeneration.from_pretrained(
        model_dir, torch_dtype=torch.float32
    ).to(device).eval()
    tokenizer = AutoTokenizer.from_pretrained(model_dir)
    return model, tokenizer


def load_video_llava(model_dir: str, device):
    from transformers import AutoTokenizer, LlavaNextVideoForConditionalGeneration

    model = LlavaNextVideoForConditionalGeneration.from_pretrained(
        model_dir, torch_dtype=torch.float32
    ).to(device).eval()
    tokenizer = AutoTokenizer.from_pretrained(model_dir)
    return model, tokenizer


def image_tokens_per_frame(model) -> tuple:
    """(out_size, tokens per frame) for an image-per-frame Llava."""
    vision = model.config.vision_config
    n = (vision.image_size // vision.patch_size) ** 2
    if getattr(model.config, "vision_feature_select_strategy", "default") != "default":
        n += 1
    return vision.image_size, n


def video_tokens_per_frame(model) -> tuple:
    """(out_size, tokens per frame) for a video-token LlavaNextVideo."""
    vision = model.config.vision_config
    pool = getattr(model.config, "spatial_pool_stride", 2)
    n = (vision.image_size // vision.patch_size // pool) ** 2
    return vision.image_size, n


def generate_reply(model, tokenizer, text: str, device, generate_kwargs: dict,
                   pixel_values=None, pixel_values_videos=None) -> str:
    """Tokenize → generate → decode the continuation, with the reference
    scripts' shared newline/tab normalization."""
    ids = torch.tensor([tokenizer.encode(text)], device=device)
    kwargs = dict(generate_kwargs)
    if pixel_values is not None:
        kwargs["pixel_values"] = pixel_values
    if pixel_values_videos is not None:
        kwargs["pixel_values_videos"] = pixel_values_videos
    with torch.no_grad():
        out = model.generate(
            input_ids=ids, attention_mask=torch.ones_like(ids), **kwargs
        )
    reply = tokenizer.decode(out[0, ids.shape[1]:].tolist(),
                             skip_special_tokens=True)
    return reply.replace("\n", " ").replace("\t", " ").strip()


def run_cli(description: str, build_model_fn, default_save_root: str,
            extra_int_args: Optional[dict] = None, argv=None) -> None:
    """The CLI shared by every adapter (mirrors the reference scripts'
    --dataset/--subtitle_flag contract and npz layout); `--device` is the
    card unless "cpu" is asked for."""
    import argparse

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--dataset", required=True,
                        help="comma-separated dataset names")
    parser.add_argument("--subtitle_flag", default="subtitle",
                        choices=["subtitle", "nosubtitle"])
    parser.add_argument("--save_root", default=default_save_root)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--limit", type=int, default=None)
    for name, default in (extra_int_args or {}).items():
        parser.add_argument(f"--{name}", type=int, default=default)
    args = parser.parse_args(argv)

    kwargs = {name: getattr(args, name) for name in (extra_int_args or {})}
    fn = build_model_fn(args.model_dir, device=args.device, **kwargs)
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
