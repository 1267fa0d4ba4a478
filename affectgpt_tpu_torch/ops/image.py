"""Device-side image preprocessing of the realtime path: resize, normalize.

Port of the eval half of affectgpt_tpu/ops/image.py (`resize`,
`normalize_frames`, `preprocess_frames_eval`): plain torch ops on the
frames' device, uint8 in, float32 out. The train-time crops and the YUV
ingest are not ported yet.

`resize` is `jax.image.resize(method="bicubic")`, which is not
`torch.nn.functional.interpolate(mode="bicubic")`: JAX uses the Keys cubic
kernel with a = -0.5, widened by the scale factor when it downsamples
(antialiasing), with each output's weights renormalized over the input taps
in range. The per-axis weight matrix is built as
jax/_src/image/scale.py::compute_weight_mat builds it, and applied with two
f32 products (height, then width).
"""

from __future__ import annotations

from typing import Tuple

import torch

from affectgpt_tpu_torch import constants

# per-encoder normalization schemes (EncoderSpec.normalize): each visual
# tower's own processor stats
NORM_STATS = {
    "clip": (constants.CLIP_IMAGE_MEAN, constants.CLIP_IMAGE_STD),
    "imagenet": (constants.IMAGENET_IMAGE_MEAN, constants.IMAGENET_IMAGE_STD),
    "siglip": (constants.SIGLIP_IMAGE_MEAN, constants.SIGLIP_IMAGE_STD),
}


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a = -0.5, of |distance| x."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weight_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in_size, out_size] f32 weights of an antialiased Keys-cubic resize
    along one axis (scale out/in, no translation), as JAX computes them."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=f32, device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    weights = _keys_cubic(x / kernel_scale)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(torch.finfo(f32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    in_range = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(in_range[None, :], weights, torch.zeros_like(weights))


def resize(frames: torch.Tensor, out_hw: Tuple[int, int], method: str = "bicubic") -> torch.Tensor:
    """[..., H, W, C] images → [..., h, w, C] float32. An axis whose size does
    not change is not filtered (so the identity size returns the frames as
    float32), as in JAX."""
    if method not in ("bicubic", "cubic"):
        raise ValueError(f"resize: only the bicubic method is ported, got {method!r}")
    x = frames.float()
    *lead, h, w, c = x.shape
    oh, ow = out_hw
    x = x.reshape(-1, h, w * c)
    if oh != h:
        x = torch.matmul(cubic_weight_matrix(h, oh, x.device).t(), x)  # [N, oh, w·C]
    x = x.reshape(-1, w, c)
    if ow != w:
        x = torch.matmul(cubic_weight_matrix(w, ow, x.device).t(), x)  # [N·oh, ow, C]
    return x.reshape(*lead, oh, ow, c)


def normalize_frames(frames: torch.Tensor, scheme: str = "clip") -> torch.Tensor:
    """uint8/float [..., H, W, C] in [0, 255] → float32 normalized with the
    named encoder scheme (NORM_STATS)."""
    mean, std = (torch.tensor(s, dtype=torch.float32, device=frames.device)
                 for s in NORM_STATS[scheme])
    return (frames.float() / 255.0 - mean) / std


def preprocess_frames_eval(frames_u8: torch.Tensor, out_size: int = 224,
                           normalize: str = "clip") -> torch.Tensor:
    """[T, H, W, C] uint8 → [C, T, S, S] float32, the eval transform (resize
    + normalize; reference AlproVideoEvalProcessor) with the encoder's own
    processor stats."""
    out = normalize_frames(resize(frames_u8, (out_size, out_size)), normalize)
    return out.permute(3, 0, 1, 2)
