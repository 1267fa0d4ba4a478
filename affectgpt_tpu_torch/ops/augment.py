"""Device-side video RandAugment, in PyTorch.

Port of affectgpt_tpu/ops/augment.py (reference:
my_affectgpt/processors/randaugment.py, VideoRandomAugment): N ops drawn
per clip from a pool of photometric and geometric transforms, each applied
with one signed magnitude to every frame of the clip. Frames are float32
RGB in [0, 255], [T, H, W, C]; the output has the same shape.

The draws come from an explicit generator and are read on the host, which
picks the op: a CPU generator keeps the device from waiting for them.
"""

from __future__ import annotations

import numpy as np
import torch


def _blend(a, b, factor):
    return torch.clamp(a + (b - a) * factor, 0.0, 255.0)


def _identity(frames, magnitude):
    return frames


def _brightness(frames, magnitude):
    return _blend(torch.zeros_like(frames), frames, 1.0 + magnitude)


def _contrast(frames, magnitude):
    return _blend(frames.mean(dim=(-3, -2, -1), keepdim=True), frames, 1.0 + magnitude)


def _color(frames, magnitude):
    return _blend(frames.mean(dim=-1, keepdim=True), frames, 1.0 + magnitude)


def _sharpness(frames, magnitude):
    kernel = torch.tensor([[1, 1, 1], [1, 5, 1], [1, 1, 1]], dtype=torch.float32,
                          device=frames.device) / 13.0
    t, h, w, c = frames.shape
    x = frames.permute(0, 3, 1, 2).reshape(t * c, 1, h, w)
    smooth = torch.nn.functional.conv2d(x, kernel[None, None], padding=1)
    smooth = smooth.reshape(t, c, h, w).permute(0, 2, 3, 1)
    return _blend(smooth, frames, 1.0 + magnitude)


def _posterize(frames, magnitude):
    bits = np.clip(np.float32(8.0) - np.float32(abs(magnitude)) * np.float32(4.0), 1.0, 8.0)
    scale = float(2.0 ** (8.0 - np.floor(bits)))
    return torch.floor(frames / scale) * scale


def _solarize(frames, magnitude):
    threshold = float(np.float32(256.0) - np.float32(abs(magnitude)) * np.float32(128.0))
    return torch.where(frames < threshold, frames, 255.0 - frames)


def _translate(frames, magnitude, axis: int):
    """Roll by int(magnitude · size) along `axis`, computed in f32 and
    truncated toward zero as JAX's astype(int32) truncates."""
    shift = int(np.float32(magnitude) * np.float32(frames.shape[axis]))
    return torch.roll(frames, shift, dims=axis)


OPS = (
    _identity,
    _brightness,
    _contrast,
    _color,
    _sharpness,
    _posterize,
    _solarize,
    lambda frames, magnitude: _translate(frames, np.float32(magnitude) * np.float32(0.2), 1),
    lambda frames, magnitude: _translate(frames, np.float32(magnitude) * np.float32(0.2), 2),
)


def rand_augment(generator: torch.Generator, frames: torch.Tensor, num_ops: int = 2,
                 magnitude: float = 0.5) -> torch.Tensor:
    """Apply `num_ops` ops drawn from OPS with signed magnitudes drawn
    uniformly in [-magnitude, magnitude) (one of each per op, for the whole
    clip). frames [T, H, W, C] in [0, 255] → float32, clipped to [0, 255]."""
    out = frames.float()
    for _ in range(num_ops):
        op = int(torch.randint(len(OPS), (), generator=generator, device=generator.device))
        u = float(torch.rand((), generator=generator, device=generator.device))
        out = OPS[op](out, float(np.float32(-magnitude + 2.0 * magnitude * u)))
    return torch.clamp(out, 0.0, 255.0)
