"""Frame-index sampling strategies (host-side pure functions).

The port's own copy of affectgpt_tpu/ops/sampling.py (reference:
my_affectgpt/processors/video_processor.py:194-258 for uniform/headtail,
:59-164 for emotion_peak). These compute integer indices only; the pixel
work runs on the device (ops/image.py). Every function returns exactly
`n_frms` indices (the last one repeated when the clip is shorter), so a
batch of clips stacks into one tensor.
"""

from __future__ import annotations

import random
from typing import List, Optional

import numpy as np


def _pad_repeat(indices: List[int], n_frms: int) -> List[int]:
    indices = list(indices)
    while len(indices) < n_frms:
        indices.append(indices[-1])
    return indices


def uniform_indices(vlen: int, n_frms: int) -> List[int]:
    """Evenly strided indices: arange(0, vlen, vlen/n) floored
    (reference: video_processor.py:216)."""
    n_use = min(n_frms, vlen)
    indices = np.arange(0, vlen, vlen / n_use).astype(int).tolist()
    return _pad_repeat(indices, n_frms)


def headtail_indices(vlen: int, n_frms: int, rng: Optional[random.Random] = None) -> List[int]:
    """Random half from the first half of the clip, half from the second
    (reference: video_processor.py:217-220)."""
    rng = rng or random
    n_use = min(n_frms, vlen)
    head = sorted(rng.sample(range(vlen // 2), n_use // 2))
    tail = sorted(rng.sample(range(vlen // 2, vlen), n_use // 2))
    return _pad_repeat(head + tail, n_frms)


def emotion_peak_indices(au_info: Optional[dict], vlen: int, n_frms: int = 8) -> List[int]:
    """AU-peak-centred 8-frame schedule (reference: video_processor.py:59-164).

    Picks the first peak frame plus up to 2 neighbours on each side
    (clamped by frames_before/after), then fills the remainder by evenly
    striding the not-yet-selected frames; falls back to linspace when no
    peak info exists.
    """
    if not au_info or not au_info.get("peak_frames"):
        return sorted(np.linspace(0, vlen - 1, n_frms).astype(int).tolist())

    peak_info = au_info["peak_frames"][0]
    peak = peak_info["peak_index"]
    before = peak_info["frames_before_peak"]
    after = peak_info["frames_after_peak"]
    total = au_info["total_frames"]

    selected = {peak}

    def add(idx: int) -> None:
        if 0 <= idx < total:
            selected.add(idx)

    if before >= 2 and after >= 2:
        add(peak - 1), add(peak - 2), add(peak + 1), add(peak + 2)
    elif (before == 1 and after >= 2) or (before >= 2 and after == 1):
        if before == 1:
            add(peak - 1), add(peak + 1), add(peak + 2)
        else:
            add(peak + 1), add(peak - 1), add(peak - 2)
    elif before == 1 and after == 1:
        add(peak - 1), add(peak + 1)
    elif before == 0 or after == 0:
        if before == 0:
            add(peak + 1), add(peak + 2)
        else:
            add(peak - 1), add(peak - 2)

    remaining = n_frms - len(selected)
    if remaining > 0:
        available = [i for i in range(total) if i not in selected]
        if available:
            if len(available) <= remaining:
                selected.update(available)
            else:
                step = len(available) / remaining
                for i in range(remaining):
                    idx = int(i * step)
                    if idx < len(available):
                        selected.add(available[idx])

    while len(selected) < n_frms and len(selected) < total:
        available = [i for i in range(total) if i not in selected]
        if not available:
            break
        selected.add(available[0])

    result = sorted(selected)
    if len(result) < n_frms:
        base = result.copy()
        while len(result) < n_frms:
            for idx in base:
                if len(result) >= n_frms:
                    break
                result.append(idx)
        result.sort()
    return result[:n_frms]


def clip_timepoints(duration: float, clip_duration: float = 2.0, clips_per_video: int = 8):
    """Uniformly spaced (start, end) windows for audio clip extraction,
    matching pytorchvideo's ConstantClipsPerVideoSampler as used at
    reference ImageBind/data.py:70-77,145-151."""
    max_start = max(duration - clip_duration, 0.0)
    starts = np.linspace(0.0, max_start, clips_per_video)
    return [(float(s), float(s + clip_duration)) for s in starts]
