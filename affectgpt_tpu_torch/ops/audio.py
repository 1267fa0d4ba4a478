"""Device-side audio front end: sinc resampling and the kaldi-compatible
fbank, in PyTorch.

Port of affectgpt_tpu/ops/audio.py (reference:
my_affectgpt/models/ImageBind/data.py:28-239, torchaudio's kaldi fbank and
sinc resampler): plain torch ops on the waveform's device. Framing is a
strided view, the FFT is `torch.fft.rfft`, the mel projection one product.

Numerical contract (kaldi/torchaudio): 25 ms hann frames at 10 ms shift,
snip-edges, per-frame DC removal, preemphasis 0.97 with the first sample
clamped, FFT padded to the next power of two, 128 mel bins on the HTK mel
scale from 20 Hz, log with a float32-epsilon floor, output padded or cut to
204 frames and normalized with mean -4.268 / std 9.138.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from affectgpt_tpu_torch import constants

_EPSILON = 1.1920928955078125e-07  # float32 machine epsilon, kaldi's log floor


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


@lru_cache(maxsize=8)
def mel_filterbank(num_bins: int = constants.AUDIO_NUM_MEL_BINS, fft_size: int = 512,
                   sample_rate: int = constants.AUDIO_SAMPLE_RATE, low_freq: float = 20.0,
                   high_freq: float = 0.0) -> np.ndarray:
    """Kaldi-style triangular mel filterbank over FFT bins: [num_bins,
    fft_size // 2 + 1] float32 whose nyquist column is zero (kaldi weighs
    fft_size // 2 bins and pads). The cached array is read-only."""
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low, mel_high = mel_scale(low_freq), mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bin_freqs = mel_scale(fft_bin_width * np.arange(num_fft_bins))
    left = mel_low + np.arange(num_bins)[:, None] * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (bin_freqs[None, :] - left) / (center - left)
    down = (right - bin_freqs[None, :]) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    out = np.pad(weights, ((0, 0), (0, 1)))
    out.setflags(write=False)
    return out


def _hann_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))).astype(np.float32)


def fbank(waveform: torch.Tensor, sample_rate: int = constants.AUDIO_SAMPLE_RATE,
          num_mel_bins: int = constants.AUDIO_NUM_MEL_BINS,
          target_length: int = constants.AUDIO_TARGET_FRAMES) -> torch.Tensor:
    """[..., num_samples] waveform → [..., num_mel_bins, target_length] f32
    log-mel (reference `waveform2melspec`, ImageBind/data.py:28-67, the
    whole clip's mean subtracted first), each leading row on its own."""
    x = waveform.float()
    x = x - x.mean(dim=-1, keepdim=True)
    frame_length = int(sample_rate * 0.025)
    frame_shift = int(sample_rate * 0.010)
    num_frames = 1 + (x.shape[-1] - frame_length) // frame_shift
    fft_size = 2 ** math.ceil(math.log2(frame_length))
    frames = x.unfold(-1, frame_length, frame_shift)  # [..., T, frame_length]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * prev
    frames = frames * torch.from_numpy(_hann_window(frame_length)).to(x.device)
    spectrum = torch.fft.rfft(frames, n=fft_size, dim=-1).abs() ** 2  # [..., T, F + 1]
    fb = torch.from_numpy(mel_filterbank(num_mel_bins, fft_size, sample_rate).copy()).to(x.device)
    mel = torch.log(torch.clamp_min(spectrum @ fb.t(), _EPSILON)).transpose(-1, -2)
    if num_frames >= target_length:
        return mel[..., :target_length]
    return torch.nn.functional.pad(mel, (0, target_length - num_frames))


def transform_audio(clips: torch.Tensor) -> torch.Tensor:
    """[n_clips, 1, clip_samples] raw clips → [n_clips, 1, 128, 204]
    normalized log-mels (reference `transform_audio`, data.py:218-239)."""
    mels = fbank(clips[:, 0, :])
    return ((mels - constants.AUDIO_MEL_MEAN) / constants.AUDIO_MEL_STD)[:, None]


@lru_cache(maxsize=32)
def _sinc_resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                          rolloff: float = 0.99) -> Tuple[np.ndarray, int, int, int]:
    """Windowed-sinc polyphase kernel with torchaudio's sinc_interp_hann
    semantics (the resampler of the reference, data.py:136-139). Returns
    (kernels [new_g, 1, kernel_width] read-only, width, orig_g, new_g)."""
    gcd = math.gcd(orig_freq, new_freq)
    orig_g, new_g = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig_g, new_g) * rolloff
    width = math.ceil(lowpass_filter_width * orig_g / base_freq)
    idx = np.arange(-width, width + orig_g, dtype=np.float64)[None, :] / orig_g
    t = np.arange(0, -new_g, -1, dtype=np.float64)[:, None] / new_g + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    t = t * np.pi
    scale = base_freq / orig_g
    kernels = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernels = (kernels * window * scale).astype(np.float32)[:, None, :]
    kernels.setflags(write=False)
    return kernels, width, orig_g, new_g


def resample(waveform: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """Resample a [..., time] waveform by polyphase sinc convolution (one
    strided conv1d over the filter bank) → f32 [..., ceil(time · new /
    orig)]."""
    if orig_freq == new_freq:
        return waveform
    kernels, width, orig_g, new_g = _sinc_resample_kernel(orig_freq, new_freq)
    length = waveform.shape[-1]
    target_length = int(math.ceil(new_g * length / orig_g))
    lead = waveform.shape[:-1]
    x = waveform.reshape(-1, 1, length).float()
    x = torch.nn.functional.pad(x, (width, width + orig_g))
    k = torch.from_numpy(kernels.copy()).to(x.device)
    y = torch.nn.functional.conv1d(x, k, stride=orig_g)  # [batch, new_g, frames]
    y = y.transpose(1, 2).reshape(x.shape[0], -1)[:, :target_length]
    return y.reshape(*lead, target_length)


def resample_numpy(waveform: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Host (numpy) polyphase resample with the kernel of `resample`, for
    data-loader workers: host- and device-resampled audio agree up to float
    order."""
    if orig_freq == new_freq:
        return waveform.astype(np.float32)
    kernels, width, orig_g, new_g = _sinc_resample_kernel(orig_freq, new_freq)
    kernels = kernels[:, 0, :]  # [new_g, kw]
    lead = waveform.shape[:-1]
    length = waveform.shape[-1]
    target_length = int(math.ceil(new_g * length / orig_g))
    x = np.pad(waveform.reshape(-1, length).astype(np.float32), ((0, 0), (width, width + orig_g)))
    kw = kernels.shape[1]
    num_windows = (x.shape[1] - kw) // orig_g + 1
    windows = np.lib.stride_tricks.sliding_window_view(x, kw, axis=1)[:, ::orig_g]
    y = np.einsum("bwk,pk->bwp", windows[:, :num_windows], kernels)  # [b, w, new_g]
    y = y.reshape(x.shape[0], -1)[:, :target_length]
    return y.reshape(*lead, target_length)


def extract_clips(waveform: torch.Tensor, sample_rate: int = constants.AUDIO_SAMPLE_RATE,
                  clip_duration: float = constants.AUDIO_CLIP_SECONDS,
                  clips_per_video: int = constants.AUDIO_CLIPS_PER_VIDEO) -> torch.Tensor:
    """[time] mono waveform (at least clip_duration · sr samples) → [clips,
    1, clip_samples], clips placed uniformly as ConstantClipsPerVideoSampler
    places them (reference data.py:70-77)."""
    clip_samples = int(clip_duration * sample_rate)
    length = waveform.shape[0]
    max_start = max(length / sample_rate - clip_duration, 0.0)
    starts = np.linspace(0.0, max_start, clips_per_video)
    start_samples = np.minimum((starts * sample_rate).astype(np.int64),
                               max(length - clip_samples, 0))
    idx = torch.from_numpy(start_samples[:, None] + np.arange(clip_samples)[None, :])
    return waveform[idx.to(waveform.device)][:, None, :]


def host_audio_clips(waveform: np.ndarray, orig_freq: int) -> np.ndarray:
    """The reference `load_audio` pipeline for one file on the host, as the
    data loaders and the command lines run it: resample_numpy to 16 kHz →
    mono → zero-pad to 2 s → 8 uniform 2 s clips. Returns [8, 1, 32000]
    f32."""
    wav = resample_numpy(waveform, orig_freq, constants.AUDIO_SAMPLE_RATE)
    wav = wav.mean(axis=0) if wav.ndim == 2 else wav
    min_len = int(constants.AUDIO_CLIP_SECONDS * constants.AUDIO_SAMPLE_RATE)
    if wav.shape[0] < min_len:
        wav = np.pad(wav, (0, min_len - wav.shape[0]))
    return extract_clips(torch.from_numpy(np.ascontiguousarray(wav))).numpy()


def load_audio_clips(waveform: np.ndarray, orig_freq: int, device="cuda") -> torch.Tensor:
    """The reference `load_audio` pipeline for one file (data.py:170-215) on
    `device`: resample → mono → zero-pad to 2 s → 8 uniform 2 s clips.
    Returns [8, 1, 32000] f32."""
    wav = torch.as_tensor(np.asarray(waveform, dtype=np.float32), device=device)
    if wav.ndim == 1:
        wav = wav[None, :]
    wav = resample(wav, orig_freq, constants.AUDIO_SAMPLE_RATE)
    if wav.shape[0] == 2:
        wav = wav.mean(dim=0, keepdim=True)
    wav = wav[0]
    min_len = int(constants.AUDIO_CLIP_SECONDS * constants.AUDIO_SAMPLE_RATE)
    if wav.shape[0] < min_len:
        wav = torch.nn.functional.pad(wav, (0, min_len - wav.shape[0]))
    return extract_clips(wav)
