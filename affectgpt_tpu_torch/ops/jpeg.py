"""Device-side back half of the baseline-JPEG decode, in PyTorch.

Port of affectgpt_tpu/ops/jpeg.py. The host decoder (native/videodec.cpp)
keeps only the entropy decode; the per-pixel work runs here on the
coefficients' device:

- the iDCT of every block of every frame is one [N, 64] x [64, 64] f32
  product (the operator is C⊗C of the T.81 A.3.3 basis);
- chroma is upsampled by the host path's center-aligned separable bilinear
  filter (libjpeg's "fancy" filter for 2x factors), two clamped gathers per
  axis;
- color conversion and rounding follow native/videodec.cpp (lround as
  floor(x + 0.5) on the ranges involved), so device frames equal host
  frames within 1 LSB (float summation order).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _idct_operator() -> np.ndarray:
    """[64, 64] operator M with P_flat = K_flat @ M: K the natural-order
    frequency coefficients (v·8 + u), P the row-major pixels (y·8 + x)."""
    cs = np.zeros((8, 8), np.float32)  # cs[x, u]
    for x in range(8):
        for u in range(8):
            cu = 0.353553390593 if u == 0 else 0.5
            cs[x, u] = cu * np.cos((2 * x + 1) * u * np.pi / 16.0)
    return np.einsum("yv,xu->vuyx", cs, cs).reshape(64, 64).astype(np.float32)


_IDCT_M = _idct_operator()


def _round_half_up(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5)


def _upsample_axis(plane: torch.Tensor, out_len: int, sub_len: int, factor_num: int,
                   factor_den: int, axis: int) -> torch.Tensor:
    """Center-aligned bilinear upsample along `axis` from sub_len valid
    samples to out_len (native/videodec.cpp sample()); a slice when the
    factors match."""
    if factor_num == factor_den:
        return plane.narrow(axis, 0, out_len)
    f = (np.arange(out_len) + 0.5) * factor_num / factor_den - 0.5
    i0 = np.floor(f).astype(np.int64)
    a = (f - i0).astype(np.float32)
    dev = plane.device
    lo = plane.index_select(axis, torch.from_numpy(np.clip(i0, 0, sub_len - 1)).to(dev))
    hi = plane.index_select(axis, torch.from_numpy(np.clip(i0 + 1, 0, sub_len - 1)).to(dev))
    shape = [1] * plane.ndim
    shape[axis] = out_len
    aa = torch.from_numpy(a).to(dev).reshape(shape)
    return lo * (1.0 - aa) + hi * aa


def decode_mjpeg_frames(coefs: torch.Tensor, quants: torch.Tensor, width: int, height: int,
                        sampling: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """coefs [n, blocks, 64] int16 natural-order coefficients, quants
    [ncomp, 64] tables, sampling ((h, v) per component) → [n, height, width,
    3] uint8 RGB on the coefficients' device. The block layout is
    videodec_read_coeffs': components one after another, each row-major over
    its padded (mcuy·v, mcux·h) block grid."""
    n = coefs.shape[0]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    idct = torch.from_numpy(_IDCT_M).to(coefs.device)
    planes = []
    base = 0
    for c, (h, v) in enumerate(sampling):
        bx, by = mcux * h, mcuy * v
        k = coefs[:, base:base + by * bx, :].float() * quants[c].float()[None, None, :]
        base += by * bx
        p = k.reshape(n * by * bx, 64) @ idct
        # as the host path: plane pixels rounded and clamped to uint8 range
        # before upsampling and color (videodec.cpp:298-299)
        p = torch.clamp(_round_half_up(p) + 128.0, 0.0, 255.0)
        plane = p.reshape(n, by, bx, 8, 8).permute(0, 1, 3, 2, 4).reshape(n, by * 8, bx * 8)
        if (h, v) != (hmax, vmax):
            sub_w = -(-width * h // hmax)
            sub_h = -(-height * v // vmax)
            plane = _upsample_axis(plane, height, sub_h, v, vmax, axis=1)
            plane = _upsample_axis(plane, width, sub_w, h, hmax, axis=2)
        else:
            plane = plane[:, :height, :width]
        planes.append(plane)
    if len(sampling) == 1:
        g = torch.clamp(planes[0], 0.0, 255.0).to(torch.uint8)
        return torch.stack([g, g, g], dim=-1)
    y, cb, cr = planes[0], planes[1] - 128.0, planes[2] - 128.0
    rgb = torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb],
                      dim=-1)
    return torch.clamp(_round_half_up(rgb), 0.0, 255.0).to(torch.uint8)
