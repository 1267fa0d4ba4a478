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

The encoder's front half (`encode_mjpeg_coefficients`), which the JAX
package leaves to PIL, mirrors it on the frames' device: libjpeg's
fixed-point RGB → YCbCr, 4:2:0 by its 2x2 mean with alternating rounding
bias, the frame padded to whole 16-pixel MCUs by replicating its last row
and column (libjpeg's edge expansion), the forward DCT as one [N, 64] x
[64, 64] product with the transpose of the iDCT operator, and
quantization by the IJG tables scaled to a quality as libjpeg's
`jpeg_set_quality` scales them (`quality_tables`), rounding half away
from zero. data/jpeg_encode.py Huffman-codes the result on the host.
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


# the IJG example tables (T.81 K.1), natural order
_STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
_STD_CHROMINANCE = np.full(64, 99, np.int64)
_STD_CHROMINANCE[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_FDCT_M = np.ascontiguousarray(_IDCT_M.T)  # the basis is orthonormal


def quality_tables(quality: int) -> np.ndarray:
    """[2, 64] luminance and chrominance tables (natural order) at an IJG
    quality, as libjpeg's jpeg_set_quality(force_baseline=TRUE) makes them:
    scale 5000 / q below 50, else 200 - 2q; each entry (base · scale + 50)
    // 100, clamped to 1-255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    tables = (np.stack([_STD_LUMINANCE, _STD_CHROMINANCE]) * scale + 50) // 100
    return np.clip(tables, 1, 255).astype(np.int64)


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """[n, H, W] (multiples of 8) → [n, H/8 · W/8, 64], row-major blocks."""
    n, h, w = plane.shape
    return plane.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(n, -1, 64)


def encode_mjpeg_coefficients(frames: torch.Tensor, quality: int) -> torch.Tensor:
    """frames [n, H, W, 3] uint8 RGB → [n, blocks, 64] int16 quantized
    coefficients of a baseline 4:2:0 JPEG (natural order), on the frames'
    device, in decode_mjpeg_frames' layout: Y over its (2·mcuy, 2·mcux) block
    grid, then Cb and Cr over (mcuy, mcux), each row-major."""
    n, h, w, _ = frames.shape
    dev = frames.device
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    rows = torch.arange(hp, device=dev).clamp_max(h - 1)
    cols = torch.arange(wp, device=dev).clamp_max(w - 1)
    rgb = frames.index_select(1, rows).index_select(2, cols).to(torch.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    # libjpeg's rgb_ycc_convert: 16-bit fixed point, FIX(x) = round(x · 2^16)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16
    # h2v2_downsample: the 2x2 sum plus a bias of 1, 2, 1, 2, ... across columns
    bias = 1 + (torch.arange(wp // 2, device=dev, dtype=torch.int32) & 1)

    def down(plane):
        s = plane.reshape(n, hp // 2, 2, wp // 2, 2).sum(dim=(2, 4), dtype=torch.int32)
        return (s + bias) >> 2

    tables = torch.as_tensor(quality_tables(quality), dtype=torch.float32, device=dev)
    fdct = torch.from_numpy(_FDCT_M).to(dev)
    out = []
    for plane, table in ((y, tables[0]), (down(cb), tables[1]), (down(cr), tables[1])):
        k = (_blocks(plane).to(torch.float32) - 128.0) @ fdct
        out.append(torch.sign(k) * torch.floor(k.abs() / table + 0.5))
    return torch.cat(out, dim=1).to(torch.int16)
