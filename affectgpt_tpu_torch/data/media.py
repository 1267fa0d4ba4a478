"""Host-side media loading.

The port's own copy of affectgpt_tpu/data/media.py. The reference leans on
decord/torchaudio/OpenCV C++ for demux + decode (reference:
my_affectgpt/processors/video_processor.py:194-296,
ImageBind/data.py:117-239). Here the host does only container/codec work
and index selection; every pixel/sample transform happens on the device
(ops/image.py, ops/audio.py). Backends, in preference order:

- WAV audio: native C++ reader (native/wavio, ctypes) when built, else a
  pure-python RIFF parser (PCM16/24/32, float32) — no torchaudio.
- Video frames, in preference order: MJPEG-AVI demux + cv2.imdecode
  (host demux of the frame table, SIMD JPEG decode of ONLY the sampled
  indices — the realtime ingest tier's hot rung), then the native C++
  AVI/MJPEG decoder (native/videodec.cpp — same sampled-only property,
  zero dependencies), then decord, then OpenCV, then an `ffmpeg`
  binary, then `.npy` frame dumps (and, for faces, the OpenFace `.npy`
  crops the reference also uses). Codecs stay gated, never assumed.
  `read_video_frames_device` additionally offers the device-decode
  split: host entropy decode only, with dequant/iDCT/upsample/color on
  the card (ops/jpeg.py), so frames are born on the device where
  ops/image.py continues. The native readers are ctypes bindings to the
  repo's `native/` libraries, built with `make -C native` at first use.
- Preextracted features: `.npy` caches with the reference's directory
  contract `{root}/{dataset}/{modality}_{encoder}_{sampling}_{n}frms/{name}.npy`
  (reference: extract_multimodal_features_precompute.py:820-846).

Two departures from the JAX copy: an AVI without a `vids` stream header
gives no frame table (the JAX demuxer then admits every stream's chunks;
the native decoder reads none, as here), and `load_au_analysis` returns a
copy of its cached parse, so a caller that edits it cannot change what the
next caller reads.
"""

from __future__ import annotations

import copy
import functools as _functools
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from affectgpt_tpu_torch.ops import sampling

# ---------------------------------------------------------------------------
# WAV reading


def _read_wav_python(path: str) -> Tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE parser: returns ([channels, samples] float32, rate)."""
    with open(path, "rb") as handle:
        data = handle.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"Not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"Missing fmt/data chunk: {path}")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        samples = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    elif audio_format in (1, 0xFFFE):  # PCM (or extensible, assume PCM)
        if bits == 16:
            samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            samples = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            samples = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            as_int = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            as_int = np.where(as_int >= 1 << 23, as_int - (1 << 24), as_int)
            samples = as_int.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits}: {path}")
    else:
        raise ValueError(f"Unsupported WAV format {audio_format}: {path}")
    n = (len(samples) // channels) * channels
    return samples[:n].reshape(-1, channels).T.copy(), rate


_NATIVE_WAV = None


def _native_wav_reader():
    """ctypes binding to the C++ wav reader (native/wavio.cpp), if built."""
    global _NATIVE_WAV
    if _NATIVE_WAV is not None:
        return _NATIVE_WAV or None
    import ctypes

    native_dir = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
    lib_path = os.path.join(native_dir, "libwavio.so")
    if not os.path.exists(lib_path):
        # try a one-shot build (g++ is part of the toolchain contract)
        import subprocess

        try:
            subprocess.run(["make", "-C", native_dir], check=True, capture_output=True)
        except Exception:
            _NATIVE_WAV = False
            return None
    if not os.path.exists(lib_path):
        _NATIVE_WAV = False
        return None
    lib = ctypes.CDLL(lib_path)
    lib.wavio_read.restype = ctypes.c_int
    lib.wavio_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),  # channels
        ctypes.POINTER(ctypes.c_longlong),  # frames
        ctypes.POINTER(ctypes.c_int),  # rate
    ]
    lib.wavio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    _NATIVE_WAV = lib
    return lib


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns ([channels, samples] float32, sample_rate)."""
    lib = _native_wav_reader()
    if lib is not None:
        import ctypes

        buf = ctypes.POINTER(ctypes.c_float)()
        channels = ctypes.c_int()
        frames = ctypes.c_longlong()
        rate = ctypes.c_int()
        status = lib.wavio_read(
            path.encode(), ctypes.byref(buf), ctypes.byref(channels),
            ctypes.byref(frames), ctypes.byref(rate),
        )
        if status == 0:
            n = channels.value * frames.value
            arr = np.ctypeslib.as_array(buf, shape=(n,)).reshape(frames.value, channels.value)
            out = arr.T.astype(np.float32).copy()
            lib.wavio_free(buf)
            return out, rate.value
        # fall through to python parser on unsupported format
    return _read_wav_python(path)


# ---------------------------------------------------------------------------
# Video frames

_NATIVE_VIDEO = None


def _native_video_reader():
    """ctypes binding to the C++ AVI/MJPEG decoder (native/videodec.cpp),
    building it on first use if g++ is available."""
    global _NATIVE_VIDEO
    if _NATIVE_VIDEO is not None:
        return _NATIVE_VIDEO or None
    import ctypes

    native_dir = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))
    lib_path = os.path.join(native_dir, "libvideodec.so")
    if not os.path.exists(lib_path):
        import subprocess

        try:
            subprocess.run(["make", "-C", native_dir], check=True, capture_output=True)
        except Exception:
            _NATIVE_VIDEO = False
            return None
    if not os.path.exists(lib_path):
        _NATIVE_VIDEO = False
        return None
    lib = ctypes.CDLL(lib_path)
    lib.videodec_probe.restype = ctypes.c_int
    lib.videodec_probe.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.videodec_read.restype = ctypes.c_int
    lib.videodec_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
    ]
    try:  # device-decode split (absent in a stale pre-built .so)
        lib.videodec_probe_coeffs.restype = ctypes.c_int
        lib.videodec_probe_coeffs.argtypes = (
            [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4
            + [ctypes.c_int * 6, ctypes.POINTER(ctypes.c_int)]
        )
        lib.videodec_read_coeffs.restype = ctypes.c_int
        lib.videodec_read_coeffs.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint16),
        ]
    except AttributeError:
        pass
    _NATIVE_VIDEO = lib
    return lib


def _read_video_native(video_path, n_frms, sampling_name, rng, au_info):
    """Two-call protocol: probe frame count → compute sampling indices →
    decode only those frames (RGB24). Returns None when the container or
    codec is outside the native decoder's scope (caller falls through)."""
    import ctypes

    lib = _native_video_reader()
    if lib is None:
        return None
    vlen, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.videodec_probe(video_path.encode(), ctypes.byref(vlen),
                          ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    indices = np.asarray(_indices(vlen.value, n_frms, sampling_name, rng, au_info),
                         dtype=np.int32)
    out = np.empty((len(indices), h.value, w.value, 3), dtype=np.uint8)
    status = lib.videodec_read(
        video_path.encode(), indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(indices), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out if status == 0 else None


def _try_cv2():
    try:
        import cv2  # noqa: F401

        return cv2
    except Exception:
        return None


def demux_mjpeg_avi(video_path: str) -> Optional[List[Tuple[int, int]]]:
    """Host demux only: RIFF walk of an MJPEG-AVI → [(offset, size)] of the
    JPEG payload of every '00dc' frame chunk (offsets into the file), or
    None when the container isn't an AVI / carries no MJPEG frames.

    Walks the 'movi' LIST directly (robust to both idx1 offset conventions
    and to index-free files); the result is the random-access frame table
    the sampled-decode fast path needs.

    Stream discipline (matches native/videodec.cpp): the video stream id
    is identified from the hdrl LIST's strh headers (first fccType 'vids'
    strl, in declaration order), and only THAT stream's '##dc'/'##db'
    chunks enter the table — a second video stream (thumbnail/preview)
    or a JPEG-bodied non-primary stream would otherwise interleave wrong
    frames silently. A container that declares no 'vids' stream gives
    None, as the native decoder reads no frame from it. 'LIST rec ' interleave groups are descended into,
    not skipped.

    Frame-table parity with the native demuxer: EVERY size>0 chunk of the
    video stream enters the table (videodec.cpp pushes the same set), so
    sampled indices map to the same temporal positions on both backends
    even when the stream carries non-JPEG placeholder chunks; codec
    detection instead checks the FIRST entry for a JPEG SOI. All walk
    bounds are clamped to the real file length so truncated or
    size-lying containers return None (ladder falls through) instead of
    raising."""
    import mmap

    try:
        with open(video_path, "rb") as handle:
            if os.fstat(handle.fileno()).st_size < 24:
                return None
            data = mmap.mmap(handle.fileno(), 0, access=mmap.ACCESS_READ)
    except OSError:
        return None
    with data:
        if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            return None
        # top-level chunk walk → hdrl (stream headers) + the LIST/movi body
        pos, end = 12, min(len(data), 8 + struct.unpack("<I", data[4:8])[0])
        movi: Optional[Tuple[int, int]] = None
        hdrl: Optional[Tuple[int, int]] = None
        while pos + 8 <= end:
            fourcc = data[pos : pos + 4]
            size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
            if fourcc == b"LIST" and data[pos + 8 : pos + 12] == b"hdrl":
                hdrl = (pos + 12, min(pos + 8 + size, len(data)))
            if fourcc == b"LIST" and data[pos + 8 : pos + 12] == b"movi":
                movi = (pos + 12, min(pos + 8 + size, len(data)))
                break
            pos += 8 + size + (size & 1)
        if movi is None:
            return None
        # video stream number = index of the first 'vids' strl in hdrl
        video_stream = None
        if hdrl is not None:
            stream_idx = 0
            pos, end = hdrl
            while pos + 8 <= end:
                fourcc = data[pos : pos + 4]
                size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
                if fourcc == b"LIST" and data[pos + 8 : pos + 12] == b"strl":
                    # strl body starts with the strh chunk; fccType at +8
                    if data[pos + 12 : pos + 16] == b"strh":
                        if data[pos + 20 : pos + 24] == b"vids" and video_stream is None:
                            video_stream = stream_idx
                    stream_idx += 1
                pos += 8 + size + (size & 1)
        if video_stream is None:
            return None  # no video stream declared: nothing to sample from
        want = b"%02d" % video_stream

        entries: List[Tuple[int, int]] = []

        def scan(pos: int, end: int) -> None:
            end = min(end, len(data))
            while pos + 8 <= end:
                fourcc = data[pos : pos + 4]
                size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
                body = pos + 8
                if fourcc == b"LIST" and data[body : body + 4] == b"rec ":
                    scan(body + 4, body + size)  # interleave group: descend
                elif (
                    fourcc[2:4] in (b"dc", b"db")
                    and fourcc[:2] == want
                    and size > 0
                    and body + size <= len(data)
                ):
                    entries.append((body, size))
                pos = body + size + (size & 1)

        scan(*movi)
        if not entries:
            return None
        first_off, _ = entries[0]
        if data[first_off : first_off + 2] != b"\xff\xd8":
            return None  # video stream isn't MJPEG → next ladder rung
        return entries


def _read_video_avi_cv2(video_path, n_frms, sampling_name, rng, au_info):
    """MJPEG-AVI fast path: host demux (frame table above) + cv2.imdecode
    (SIMD libjpeg) of ONLY the sampled frame indices. ~9× faster per frame
    than the in-tree scalar Huffman+iDCT decoder on this image (measured
    1.0 vs 9.5 ms per 256² frame) while keeping its decode-only-the-samples
    property — this is the realtime ingest tier's hot rung. Returns None
    when cv2 is absent or the container isn't MJPEG-AVI (caller falls
    through to the native pixel decoder)."""
    cv2 = _try_cv2()
    if cv2 is None:
        return None
    entries = demux_mjpeg_avi(video_path)
    if entries is None:
        return None
    indices = _indices(len(entries), n_frms, sampling_name, rng, au_info)
    frames = []
    with open(video_path, "rb") as handle:
        for i in indices:
            off, size = entries[i]
            handle.seek(off)
            buf = np.frombuffer(handle.read(size), np.uint8)
            img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            if img is None:
                return None  # corrupt frame → let the ladder's next rung try
            frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return np.stack(frames)


def _read_video_cv2(video_path, n_frms, sampling_name, rng, au_info):
    cv2 = _try_cv2()
    if cv2 is None:
        return None
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        return None
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if vlen <= 0:
        cap.release()
        return None
    full = list(_indices(vlen, n_frms, sampling_name, rng, au_info))
    wanted = set(full)
    by_index = {}
    pos = 0
    while pos <= max(wanted):
        ok, frame = cap.read()
        if not ok:
            break
        if pos in wanted:
            by_index[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        pos += 1
    cap.release()
    if not by_index:
        return None
    last = by_index[max(by_index)]
    return np.stack([by_index.get(i, last) for i in full])


def read_video_frames_device(
    video_path: str,
    n_frms: int = 8,
    sampling_name: str = "uniform",
    rng=None,
    au_info: Optional[dict] = None,
    device="cuda",
):
    """Device-side decode split: the host C++ decoder entropy-decodes only
    (videodec_read_coeffs) and the per-pixel back half — dequant, 8x8 iDCT
    as one batched matmul, chroma upsampling, YCbCr→RGB — runs on `device`
    (ops/jpeg.decode_mjpeg_frames). Returns a uint8 tensor [T, H, W, 3] on
    `device` matching read_video_frames to ≤1 LSB, or None when the
    container/codec is outside the MJPEG-AVI scope (callers fall back to
    the host pixel ladder)."""
    import ctypes

    import torch

    from affectgpt_tpu_torch.ops import jpeg as jpeg_ops

    lib = _native_video_reader()
    if lib is None or not hasattr(lib, "videodec_read_coeffs"):
        return None
    nf = ctypes.c_int()
    w, h = ctypes.c_int(), ctypes.c_int()
    ncomp, blocks = ctypes.c_int(), ctypes.c_int()
    samp = (ctypes.c_int * 6)()
    if lib.videodec_probe_coeffs(
        video_path.encode(), ctypes.byref(nf), ctypes.byref(w), ctypes.byref(h),
        ctypes.byref(ncomp), samp, ctypes.byref(blocks),
    ) != 0:
        return None
    indices = np.asarray(
        _indices(nf.value, n_frms, sampling_name, rng, au_info), dtype=np.int32
    )
    coefs = np.empty((len(indices), blocks.value, 64), np.int16)
    quants = np.empty((ncomp.value, 64), np.uint16)
    if lib.videodec_read_coeffs(
        video_path.encode(), indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        len(indices), coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        quants.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    ) != 0:
        return None
    sampling_static = tuple(
        (samp[2 * c], samp[2 * c + 1]) for c in range(ncomp.value)
    )
    return jpeg_ops.decode_mjpeg_frames(
        torch.as_tensor(coefs, device=device),
        torch.as_tensor(quants.astype(np.int32), device=device),
        width=w.value, height=h.value, sampling=sampling_static,
    )


def _try_decord():
    try:
        import decord  # noqa: F401

        return decord
    except Exception:
        return None


def _ffmpeg_available() -> bool:
    import shutil

    return shutil.which("ffmpeg") is not None


def read_video_frames(
    video_path: str,
    n_frms: int = 8,
    sampling_name: str = "uniform",
    rng=None,
    au_info: Optional[dict] = None,
) -> np.ndarray:
    """Decode `n_frms` sampled frames → [T, H, W, 3] uint8.

    Backend order: MJPEG-AVI demux + cv2.imdecode (sampled-only, SIMD) →
    native C++ AVI/MJPEG → decord → OpenCV → ffmpeg binary →
    `{video_path}.frames.npy` dump.
    """
    frames = _read_video_avi_cv2(video_path, n_frms, sampling_name, rng, au_info)
    if frames is not None:
        return frames
    frames = _read_video_native(video_path, n_frms, sampling_name, rng, au_info)
    if frames is not None:
        return frames
    decord = _try_decord()
    if decord is not None:
        vr = decord.VideoReader(uri=video_path)
        vlen = len(vr)
        indices = _indices(vlen, n_frms, sampling_name, rng, au_info)
        batch = vr.get_batch(indices)
        return np.asarray(batch.asnumpy() if hasattr(batch, "asnumpy") else batch)
    frames = _read_video_cv2(video_path, n_frms, sampling_name, rng, au_info)
    if frames is not None:
        return frames
    if _ffmpeg_available():
        return _read_video_ffmpeg(video_path, n_frms, sampling_name, rng, au_info)
    npy_path = video_path + ".frames.npy"
    if os.path.exists(npy_path):
        frames = np.load(npy_path)  # [T, H, W, 3]
        indices = _indices(len(frames), n_frms, sampling_name, rng, au_info)
        return frames[indices]
    raise RuntimeError(
        f"No video decode backend (native/decord/cv2/ffmpeg) and no frame dump "
        f"next to {video_path}; use preextracted features or provide .frames.npy"
    )


def _indices(vlen, n_frms, sampling_name, rng, au_info) -> List[int]:
    if sampling_name == "uniform":
        return sampling.uniform_indices(vlen, n_frms)
    if sampling_name == "headtail":
        return sampling.headtail_indices(vlen, n_frms, rng)
    if sampling_name == "emotion_peak":
        return sampling.emotion_peak_indices(au_info, vlen, n_frms)
    raise NotImplementedError(sampling_name)


def _read_video_ffmpeg(video_path, n_frms, sampling_name, rng, au_info) -> np.ndarray:
    import json
    import subprocess

    probe = subprocess.run(
        ["ffprobe", "-v", "quiet", "-print_format", "json", "-show_streams", video_path],
        capture_output=True, check=True,
    )
    streams = json.loads(probe.stdout)["streams"]
    vstream = next(s for s in streams if s["codec_type"] == "video")
    w, h = int(vstream["width"]), int(vstream["height"])
    raw = subprocess.run(
        ["ffmpeg", "-v", "quiet", "-i", video_path, "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
        capture_output=True, check=True,
    ).stdout
    frames = np.frombuffer(raw, dtype=np.uint8)
    vlen = len(frames) // (w * h * 3)
    frames = frames[: vlen * w * h * 3].reshape(vlen, h, w, 3)
    return frames[_indices(vlen, n_frms, sampling_name, rng, au_info)]


def read_face_crops(face_npy: str, n_frms: int = 8, sampling_name: str = "uniform", rng=None) -> np.ndarray:
    """OpenFace face-crop `.npy` sequence → [T, H0, W0, 3] uint8 sampled
    frames (resize to 224² happens on device; the reference resizes with
    cv2 host-side, video_processor.py:262-296)."""
    faces = np.load(face_npy)
    indices = _indices(len(faces), n_frms, sampling_name, rng, None)
    return np.asarray(faces)[indices]


# ---------------------------------------------------------------------------
# Preextracted feature cache contract


def feature_cache_path(
    root: str, dataset: str, modality: str, encoder: str, sample_name: str,
    sampling_name: str = "uniform", n_frms: int = 8, clips_per_video: int = 8,
) -> str:
    """Reference cache layout (base_dataset.py:398,485,524)."""
    if modality == "frame":
        sub = f"frame_{encoder}_{sampling_name}_{n_frms}frms"
    elif modality == "face":
        sub = f"face_{encoder}_{n_frms}frms"
    elif modality == "audio":
        sub = f"audio_{encoder}_{clips_per_video}clips"
    elif modality == "multi":
        sub = f"multi_{encoder}"
    elif modality == "au":
        sub = f"au_{encoder}"
    else:
        raise ValueError(modality)
    return os.path.join(root, dataset, sub, f"{sample_name}.npy")


def load_feature(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    return np.load(path)


@_functools.lru_cache(maxsize=1024)
def _load_au_analysis_cached(json_path: str):
    import json

    try:
        with open(json_path) as handle:
            return json.load(handle)
    except (OSError, ValueError):
        return None


def load_au_analysis(mer_factory_output: str, sample_name: str):
    """Parsed {name}_au_analysis.json for a sample, or None. ONE cached
    parse serves both per-call consumers in the hot ingest loop —
    emotion_peak sampling (get_au_info) and the realtime AU text path
    (load_au_summary_texts) each need the same file every
    load_modalities call. Each call returns its own copy of the parse."""
    return copy.deepcopy(_load_au_analysis_cached(
        os.path.join(mer_factory_output, sample_name, f"{sample_name}_au_analysis.json")))


def load_au_summary_texts(mer_factory_output: str, sample_name: str) -> list:
    """Per-sample AU summary descriptions from the MER-Factory output tree
    ({root}/{name}/{name}_au_analysis.json). Accepts every layout the
    pipeline produces (reference
    extract_multimodal_features_precompute.py:725-777: prefer
    `summary_description` — a {frame_idx: text} dict sorted by int key, or
    a single string — falling back to `fine_grained_descriptions`, plus the
    per-frame `au_info.frames[].summary_description` list). Returns [] when
    the JSON is absent or carries no descriptions."""
    data = load_au_analysis(mer_factory_output, sample_name)
    if data is None:
        return []

    for key in ("summary_description", "fine_grained_descriptions"):
        node = data.get(key)
        if isinstance(node, dict) and node:
            try:
                indices = sorted(node, key=int)
            except (TypeError, ValueError):
                indices = sorted(node)
            return [str(node[i]) for i in indices if node[i]]
        if isinstance(node, str) and node:
            return [node]
    texts = [
        f.get("summary_description")
        for f in data.get("au_info", {}).get("frames", [])
    ]
    return [t for t in texts if t]
