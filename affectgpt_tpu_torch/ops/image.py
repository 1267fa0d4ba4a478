"""Device-side image preprocessing: resize, normalize, the train-time crop
and the YUV ingest.

Port of affectgpt_tpu/ops/image.py (reference:
my_affectgpt/processors/video_processor.py:378-488): plain torch ops on the
frames' device, uint8 in, float32 out. `random_resized_crop` draws its
crop from an explicit generator and realizes it, as JAX does, as one
scale-and-translate resample (`jax.image.scale_and_translate`) whose scale
and translation stay device scalars.

`resize` is `jax.image.resize(method="bicubic")`, which is not
`torch.nn.functional.interpolate(mode="bicubic")`: JAX uses the Keys cubic
kernel with a = -0.5, widened by the scale factor when it downsamples
(antialiasing), with each output's weights renormalized over the input taps
in range. The per-axis weight matrix is built as
jax/_src/image/scale.py::compute_weight_mat builds it, and applied with two
f32 products (height, then width).
"""

from __future__ import annotations

import math
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
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32, device=device)
    return scale_translate_weights(in_size, out_size, inv_scale,
                                   torch.zeros((), dtype=torch.float32, device=device))


def scale_translate_weights(in_size: int, out_size: int, inv_scale: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """[in_size, out_size] f32 weights of an antialiased Keys-cubic resample
    along one axis: output pixel o samples the input at (o + 0.5 -
    translation) · inv_scale - 0.5 (jax/_src/image/scale.py
    compute_weight_mat); inv_scale and translation are f32 device scalars."""
    f32, device = torch.float32, inv_scale.device
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale
                - translation * inv_scale - 0.5)
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


def resized_crop(frames: torch.Tensor, area, log_ratio, uy, ux,
                 out_size: int = 224) -> torch.Tensor:
    """The crop of `random_resized_crop` from its four draws (f32 device
    scalars or floats): area fraction, log aspect ratio and the box's
    relative origin uy, ux in [0, 1). frames [T, H, W, C] → [T, S, S, C]
    float32, one crop for the whole clip. The box [y0, y0 + ch) x [x0, x0 +
    cw) is resampled by the Keys cubic kernel, antialiased, as JAX's
    scale_and_translate does with scale S / ch and translation -y0 · S / ch
    (and the same along x)."""
    t, h, w, c = frames.shape
    f32 = dict(dtype=torch.float32, device=frames.device)
    area, log_ratio, uy, ux = (torch.as_tensor(v, **f32) for v in (area, log_ratio, uy, ux))
    ratio = torch.exp(log_ratio)
    ch = torch.clamp(torch.sqrt(area / ratio) * h, 1.0, float(h))
    cw = torch.clamp(torch.sqrt(area * ratio) * w, 1.0, float(w))
    y0, x0 = uy * (h - ch), ux * (w - cw)
    sy, sx = out_size / ch, out_size / cw
    wy = scale_translate_weights(h, out_size, 1.0 / sy, -y0 * sy)  # [H, S]
    wx = scale_translate_weights(w, out_size, 1.0 / sx, -x0 * sx)  # [W, S]
    x = torch.matmul(wy.t(), frames.float().reshape(t, h, w * c))  # [T, S, W·C]
    x = torch.matmul(wx.t(), x.reshape(t * out_size, w, c))  # [T·S, S, C]
    return x.reshape(t, out_size, out_size, c)


def random_resized_crop(generator: torch.Generator, frames: torch.Tensor, out_size: int = 224,
                        scale: Tuple[float, float] = (0.5, 1.0)) -> torch.Tensor:
    """Train-time augmentation with the reference's RandomResizedCrop
    semantics (area 0.5-1.0, aspect 3/4-4/3, bicubic; reference
    video_processor.py:402-431), one crop for the clip [T, H, W, C]. The
    four draws come from `generator` on its device and stay there."""
    u = torch.rand(4, generator=generator, device=generator.device).to(frames.device)
    lo, hi = math.log(3.0 / 4.0), math.log(4.0 / 3.0)
    return resized_crop(frames, scale[0] + (scale[1] - scale[0]) * u[0], lo + (hi - lo) * u[1],
                        u[2], u[3], out_size)


def preprocess_frames_train(generator: torch.Generator, frames_u8: torch.Tensor,
                            out_size: int = 224) -> torch.Tensor:
    """[T, H, W, C] uint8 → [C, T, S, S] float32, the train transform
    (RandomResizedCrop + normalize; reference AlproVideoTrainProcessor)."""
    out = normalize_frames(random_resized_crop(generator, frames_u8, out_size), "clip")
    return out.permute(3, 0, 1, 2)


def yuv420_to_rgb(planar: torch.Tensor) -> torch.Tensor:
    """Planar I420 (cv2 COLOR_RGB2YUV_I420 layout) [..., H·3/2, W] uint8 →
    [..., H, W, 3] uint8 RGB on the planes' device: a full Y plane, then the
    2x2-subsampled U and V planes (each H/2 x W/2, stored as H/4 rows of
    width W), the ingest pipeline's wire format at 1.5 bytes a pixel.
    Chroma is upsampled nearest-neighbour; the BT.601 studio-swing matrix
    of cv2's I420 routines converts (Y - 16 scaled by 255/219), rounded half
    to even."""
    *lead, h15, w = planar.shape
    h = (h15 * 2) // 3
    if h % 2 or w % 2 or h15 != h * 3 // 2:
        raise ValueError(f"yuv420_to_rgb: not an I420 frame of even size: {tuple(planar.shape)}")
    planar = planar.reshape(-1, h15, w)
    y = planar[:, :h, :].float()
    chroma = planar[:, h:, :].reshape(-1, 2, h // 2, w // 2).float()

    def up2(p):  # [n, h/2, w/2] → [n, h, w] nearest
        return p.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    u, v = up2(chroma[:, 0]) - 128.0, up2(chroma[:, 1]) - 128.0
    y = 1.164384 * (y - 16.0)
    rgb = torch.stack([y + 1.596027 * v, y - 0.391762 * u - 0.812968 * v, y + 2.017232 * u],
                      dim=-1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8).reshape(*lead, h, w, 3)


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
