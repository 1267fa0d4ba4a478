"""Ingest-tier video transcode: any-container → MJPEG-AVI (or .frames.npy).

The port's own copy of affectgpt_tpu/data/ingest.py. The realtime
training/inference path decodes corpora videos host-side (reference:
my_affectgpt/processors/video_processor.py:207-250 via decord). This
module is the recipe for the fully self-contained tier: transcode each
corpus once at ingest into MJPEG-AVI, after which training and serving
hosts need only the in-tree native decoder (native/videodec.cpp, which
data/media.py builds and reads) — no codec licenses, no external
libraries.

Components:
- `write_mjpeg_avi`: dependency-light AVI muxer (RIFF + baseline-JPEG
  frames) matching exactly what native/videodec.cpp parses. The JAX
  package encodes the frames with PIL, which the card lacks; the port
  encodes them itself (data/jpeg_encode.py: the DCT and quantization on
  `device`, the card unless the caller says otherwise; Huffman coding on
  the host), as PIL would at the same quality.
- `iter_video_frames`: full-clip frame iterator over JAX's backend ladder
  (cv2, then decord), then the port's own readers, which neither needs:
  an MJPEG AVI through the native decoder, then a `.frames.npy` dump. A
  source that no rung reads raises, naming each rung and why it failed.
- `transcode_video` / `transcode_tree` / `segment_transcode`: one file, a
  corpus sweep, a time window — the last is the `transcode=` callable of
  data/corpus_recipes.py.
"""

from __future__ import annotations

import itertools
import os
import struct
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from affectgpt_tpu_torch.data import jpeg_encode, media


# ---------------------------------------------------------------------------
# MJPEG-AVI muxer


def write_mjpeg_avi(
    path: str,
    frames: Iterable[np.ndarray],  # [H, W, 3] uint8 RGB each
    fps: float = 25.0,
    quality: int = 90,
    device="cuda",
) -> int:
    """Mux RGB frames into an MJPEG AVI. Returns the frame count.

    Layout: RIFF('AVI ') { LIST hdrl { avih, LIST strl { strh vids/MJPG,
    strf BITMAPINFOHEADER } }, LIST movi { 00dc... }, idx1 } — the subset
    native/videodec.cpp:67-124 demuxes (plus idx1 for other players).
    The frames are JPEG-encoded on `device` (data/jpeg_encode.py).
    """
    encoded = []
    width = height = 0
    frames = iter(frames)
    first = next(frames, None)
    if first is not None:
        height, width = tuple(first.shape[:2])
        encoded = list(jpeg_encode.encode_frames(itertools.chain([first], frames),
                                                 quality, device=device))
    n = len(encoded)
    if n == 0:
        raise ValueError("no frames to mux")

    def chunk(fourcc: bytes, body: bytes) -> bytes:
        pad = b"\x00" if len(body) % 2 else b""
        return fourcc + struct.pack("<I", len(body)) + body + pad

    def lst(kind: bytes, body: bytes) -> bytes:
        return chunk(b"LIST", kind + body)

    max_size = max(len(e) for e in encoded)
    avih = struct.pack(
        "<14I",
        int(1_000_000 / max(fps, 1e-6)),  # dwMicroSecPerFrame
        int(max_size * fps),              # dwMaxBytesPerSec
        0,                                # dwPaddingGranularity
        0x10,                             # dwFlags: AVIF_HASINDEX
        n, 0, 1, max_size,                # totalframes, initial, streams, bufsize
        width, height, 0, 0, 0, 0,
    )
    strh = (
        b"vids" + b"MJPG"
        + struct.pack("<10I", 0, 0, 0, 1, int(round(fps)), 0, n, max_size, 0xFFFFFFFF, 0)
        + struct.pack("<4H", 0, 0, width, height)
    )
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, width, height, 1, 24, b"MJPG",
        width * height * 3, 0, 0, 0, 0,
    )
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_body = b"movi"
    index_entries = []
    for data in encoded:
        index_entries.append((len(movi_body) - 4, len(data)))
        movi_body += chunk(b"00dc", data)
    movi = chunk(b"LIST", movi_body)

    idx1 = b"".join(
        b"00dc" + struct.pack("<3I", 0x10, off + 4, size)
        for off, size in index_entries
    )
    riff_body = b"AVI " + hdrl + movi + chunk(b"idx1", idx1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_body)) + riff_body)
    return n


# ---------------------------------------------------------------------------
# Full-clip frame iteration over the backend ladder


def _native_avi_frames(video_path: str) -> Optional[np.ndarray]:
    """Every frame of an MJPEG AVI through native/videodec.cpp, or None when
    the file is not an MJPEG AVI or the decoder is unavailable."""
    table = media.demux_mjpeg_avi(video_path)  # counts frames as the decoder does
    if not table:
        return None
    return media._read_video_native(video_path, len(table), "uniform", None, None)


def iter_video_frames(video_path: str) -> Iterator[np.ndarray]:
    """Yield every frame of a clip as [H, W, 3] uint8 RGB, using the first
    backend that reads it: cv2 → decord → an MJPEG AVI through the native
    decoder → a `{video_path}.frames.npy` dump; RuntimeError naming the rungs
    when none does."""
    tried = []
    try:
        import cv2

        cap = cv2.VideoCapture(video_path)
        if cap.isOpened():
            got_any = False
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                got_any = True
                yield frame[:, :, ::-1]  # BGR → RGB
            cap.release()
            if got_any:
                return
        tried.append("cv2: no frame read")
    except ImportError:
        tried.append("cv2: not installed")
    try:
        import decord

        vr = decord.VideoReader(uri=video_path)
        for i in range(len(vr)):
            batch = vr[i]
            yield np.asarray(batch.asnumpy() if hasattr(batch, "asnumpy") else batch)
        return
    except ImportError:
        tried.append("decord: not installed")
    frames = _native_avi_frames(video_path) if os.path.exists(video_path) else None
    if frames is not None:
        yield from frames
        return
    tried.append("native MJPEG-AVI: not read" if os.path.exists(video_path)
                 else "native MJPEG-AVI: no file")
    npy = video_path + ".frames.npy"
    if os.path.exists(npy):
        for frame in np.load(npy):
            yield frame
        return
    tried.append(".frames.npy: no file")
    raise RuntimeError(f"no decode backend for {video_path} ({'; '.join(tried)})")


# ---------------------------------------------------------------------------
# Transcode recipes


def transcode_video(
    src: str,
    dst: str,
    quality: int = 90,
    fps: Optional[float] = None,
    max_frames: Optional[int] = None,
    device="cuda",
) -> int:
    """One clip → MJPEG-AVI (dst endswith .avi, encoded on `device`) or raw
    dump (.frames.npy). Returns frames written."""
    if fps is None:
        fps = 25.0
        try:
            import cv2

            cap = cv2.VideoCapture(src)
            if cap.isOpened():
                fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
            cap.release()
        except ImportError:
            pass
    frames = iter_video_frames(src)
    if max_frames:
        frames = itertools.islice(frames, max_frames)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    if dst.endswith(".frames.npy"):
        stacked = np.stack(list(frames))
        np.save(dst, stacked)
        return len(stacked)
    return write_mjpeg_avi(dst, frames, fps=fps, quality=quality, device=device)


def transcode_tree(
    src_root: str,
    dst_root: str,
    quality: int = 90,
    exts: Tuple[str, ...] = (".mp4", ".mkv", ".mov", ".webm", ".avi", ".flv"),
    skip_existing: bool = True,
    device="cuda",
) -> int:
    """Corpus sweep: every video under src_root → MJPEG-AVI under dst_root
    (same relative layout, .avi suffix). Returns clips transcoded."""
    count = 0
    for dirpath, _, filenames in os.walk(src_root):
        for filename in sorted(filenames):
            if not filename.lower().endswith(exts):
                continue
            src = os.path.join(dirpath, filename)
            rel = os.path.relpath(src, src_root)
            dst = os.path.join(dst_root, os.path.splitext(rel)[0] + ".avi")
            if skip_existing and os.path.exists(dst):
                continue
            transcode_video(src, dst, quality=quality, device=device)
            count += 1
    return count


def segment_transcode(src: str, dst: str, start_s: float, end_s: float,
                      fps: float = 25.0, quality: int = 90, device="cuda") -> int:
    """Cut [start_s, end_s) and transcode — the `transcode=` callable shape
    corpus_recipes.normalize_iemocap expects (reference uses ffmpeg -ss/-to,
    iemocap.py; codec stays injected here)."""
    first = int(start_s * fps)
    last = int(end_s * fps)

    def window():
        for i, frame in enumerate(iter_video_frames(src)):
            if i >= last:
                break
            if i >= first:
                yield frame

    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    return write_mjpeg_avi(dst, window(), fps=fps, quality=quality, device=device)
