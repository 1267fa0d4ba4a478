"""The port's ingest tier against the JAX package's and PIL, on the CPU: the
JPEG encoder's quantization tables equal PIL's; PIL decodes the port's JPEG
bytes, whose PSNR to the source is within 0.3 dB of PIL's own encode at the
same quality (frames whose sides are not multiples of 16 included);
native/videodec.cpp, the cv2 fast path and the device decode read the
port's MJPEG-AVI within JPEG_ATOL of the source, as they read JAX's; the
frame ladder and the transcode recipes give JAX's frames and counts."""

import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from affectgpt_tpu.data import ingest as jingest
from affectgpt_tpu_torch.data import ingest as tingest
from affectgpt_tpu_torch.data import jpeg_encode, media
from affectgpt_tpu_torch.ops import jpeg
from affectgpt_tpu_torch.ops.sampling import uniform_indices

cv2 = pytest.importorskip("cv2")

# the largest pixel error of a decoded MJPEG-AVI frame against its smooth
# source at quality 90-95 (the JAX package's transcode round trip, atol 24)
JPEG_ATOL = 24
PSNR_DB = 0.3  # |PSNR(port) - PSNR(PIL)| at the same quality


def smooth_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """n RGB frames of smooth gradients and waves with mild noise: content a
    JPEG keeps within JPEG_ATOL."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        chans = [128 + 80 * np.sin(xx / (9 + c) + i / 3) * np.cos(yy / (7 + c)) + 30 * c
                 for c in range(3)]
        out.append(np.clip(np.stack(chans, -1) + rng.randn(h, w, 3) * 3, 0, 255))
    return np.stack(out).astype(np.uint8)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10 * np.log10(255.0 ** 2 / np.mean((a.astype(np.float64) - b) ** 2)))


def pil_jpeg(frame: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "JPEG", quality=quality, progressive=False)
    return buf.getvalue()


@pytest.mark.parametrize("quality", [50, 75, 95, 10, 100])
def test_quantization_tables_equal_pil(quality):
    frame = smooth_frames(1, 16, 16)[0]
    pil = Image.open(io.BytesIO(pil_jpeg(frame, quality))).quantization
    tables = jpeg.quality_tables(quality)
    assert [list(tables[0]), list(tables[1])] == [list(pil[0]), list(pil[1])]
    (ours,) = jpeg_encode.encode_frames([frame], quality, device="cpu")
    assert Image.open(io.BytesIO(ours)).quantization == pil


@pytest.mark.parametrize("shape", [(48, 64), (37, 53), (17, 9), (360, 638)])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_pil_decodes_port_jpeg_as_well_as_its_own(shape, quality):
    frame = smooth_frames(1, *shape, seed=shape[0])[0]
    (ours,) = jpeg_encode.encode_frames([frame], quality, device="cpu")
    image = Image.open(io.BytesIO(ours))
    assert (image.format, image.mode, image.size) == ("JPEG", "RGB", shape[::-1])
    assert not image.info.get("progressive")
    got = np.asarray(image.convert("RGB"))
    want = np.asarray(Image.open(io.BytesIO(pil_jpeg(frame, quality))).convert("RGB"))
    assert abs(psnr(got, frame) - psnr(want, frame)) <= PSNR_DB
    assert np.abs(got.astype(int) - frame).max() <= 2 * JPEG_ATOL


def test_edge_blocks_are_padded_by_replication():
    """A frame whose sides are not multiples of 16: the right and bottom
    blocks hold replicated edge pixels, so the last row and column decode
    as well as the interior (zero padding would ring there)."""
    frame = smooth_frames(1, 37, 53, seed=4)[0]
    (ours,) = jpeg_encode.encode_frames([frame], 90, device="cpu")
    got = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB")).astype(int)
    edge = np.concatenate([np.abs(got[-1] - frame[-1]).ravel(),
                           np.abs(got[:, -1] - frame[:, -1]).ravel()])
    assert edge.mean() <= 2 * np.abs(got - frame).mean() + 1


def test_device_pass_round_trips_through_the_device_decoder():
    """encode_mjpeg_coefficients' layout is decode_mjpeg_frames': the
    coefficients decode on the same device without the entropy coder."""
    frames = smooth_frames(3, 37, 53)
    coefs = jpeg.encode_mjpeg_coefficients(torch.from_numpy(frames), 95)
    assert coefs.dtype == torch.int16 and coefs.shape == (3, 4 * 12 + 2 * 12, 64)
    tables = torch.as_tensor(jpeg.quality_tables(95)[[0, 1, 1]])
    got = jpeg.decode_mjpeg_frames(coefs, tables, 53, 37, ((2, 2), (1, 1), (1, 1))).numpy()
    assert np.abs(got.astype(int) - frames).max() <= JPEG_ATOL


def write_pair(tmp_path, frames, quality=95, fps=10):
    """The same frames muxed by JAX's write_mjpeg_avi (PIL) and the port's."""
    paths = {side: str(tmp_path / f"{side}.avi") for side in ("jax", "port")}
    assert jingest.write_mjpeg_avi(paths["jax"], frames, fps=fps, quality=quality) == len(frames)
    assert tingest.write_mjpeg_avi(paths["port"], frames, fps=fps, quality=quality,
                                   device="cpu") == len(frames)
    return paths


def _header_fields(path: str) -> tuple:
    """avih's fields but the byte-rate and buffer size (they follow the
    largest JPEG), strh's and strf's."""
    data = open(path, "rb").read()
    avih = np.frombuffer(data[data.index(b"avih") + 8:][:56], "<u4").copy()
    avih[[1, 7]] = 0
    strh = data[data.index(b"strh") + 8:][:56]
    strh = strh[:36] + strh[40:]  # dwSuggestedBufferSize
    strf = data[data.index(b"strf") + 8:][:40]
    return tuple(avih), strh, strf


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_avi_readers_read_the_port_avi_as_jax(tmp_path, shape):
    frames = smooth_frames(7, *shape)
    paths = write_pair(tmp_path, frames)
    assert _header_fields(paths["port"]) == _header_fields(paths["jax"])
    table = media.demux_mjpeg_avi(paths["port"])
    assert table is not None and len(table) == 7
    data = open(paths["port"], "rb").read()
    for (off, size), frame in zip(table, frames):
        assert data[off:off + 2] == b"\xff\xd8" and data[off + size - 2:off + size] == b"\xff\xd9"
        pil = np.asarray(Image.open(io.BytesIO(data[off:off + size])).convert("RGB"))
        assert np.abs(pil.astype(int) - frame).max() <= JPEG_ATOL
    idx = uniform_indices(7, 4)
    parted = {}  # how far two conformant decoders part on each side's file
    for side in ("jax", "port"):
        native = media._read_video_native(paths[side], 4, "uniform", None, None)
        fast = media._read_video_avi_cv2(paths[side], 4, "uniform", None, None)
        device = media.read_video_frames_device(paths[side], 4, device="cpu").numpy()
        assert native is not None and native.shape == (4, *shape, 3)
        for got in (native, fast, device):
            assert np.abs(got.astype(int) - frames[idx]).max() <= JPEG_ATOL, side
        assert np.abs(device.astype(int) - native).max() <= 1
        parted[side] = np.abs(fast.astype(int) - native).max()
    assert parted["port"] <= parted["jax"] + 1


def test_frame_ladder_matches_jax(tmp_path, monkeypatch):
    frames = smooth_frames(6, 48, 64)
    src = str(tmp_path / "clip.mp4")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 5.0, (64, 48))
    if not writer.isOpened():
        pytest.skip("no mp4 encoder available")
    for frame in frames:
        writer.write(frame[:, :, ::-1])
    writer.release()
    got = np.stack(list(tingest.iter_video_frames(src)))
    assert np.array_equal(got, np.stack(list(jingest.iter_video_frames(src))))
    npy = str(tmp_path / "dump.avi")
    np.save(npy + ".frames.npy", frames)
    assert np.array_equal(np.stack(list(tingest.iter_video_frames(npy))), frames)
    avi = write_pair(tmp_path, frames)["port"]
    monkeypatch.setitem(sys.modules, "cv2", None)  # the card: neither cv2 nor decord
    monkeypatch.setitem(sys.modules, "decord", None)
    native = np.stack(list(tingest.iter_video_frames(avi)))
    assert native.shape == frames.shape and np.abs(native.astype(int) - frames).max() <= JPEG_ATOL
    assert np.array_equal(np.stack(list(tingest.iter_video_frames(npy))), frames)
    with pytest.raises(RuntimeError) as info:
        list(tingest.iter_video_frames(src))
    assert str(info.value) == (
        f"no decode backend for {src} (cv2: not installed; decord: not installed; "
        "native MJPEG-AVI: not read; .frames.npy: no file)")


def _mp4(path, frames):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 5.0,
                             frames.shape[2:0:-1])
    if not writer.isOpened():
        pytest.skip("no mp4 encoder available")
    for frame in frames:
        writer.write(frame[:, :, ::-1])
    writer.release()


def test_transcode_recipes_match_jax(tmp_path):
    frames = smooth_frames(10, 48, 64)
    (tmp_path / "corpus" / "sub").mkdir(parents=True)
    _mp4(tmp_path / "corpus" / "a.mp4", frames)
    _mp4(tmp_path / "corpus" / "sub" / "b.mp4", frames[:4])
    src = str(tmp_path / "corpus" / "a.mp4")
    for kw in ({}, {"max_frames": 3}):
        counts = {}
        for side, mod, extra in (("jax", jingest, {}), ("port", tingest, {"device": "cpu"})):
            counts[side] = mod.transcode_video(src, str(tmp_path / f"{side}{len(kw)}.avi"),
                                               quality=95, **kw, **extra)
        assert counts["port"] == counts["jax"] == (3 if kw else 10)
        jax_frames = media._read_video_native(str(tmp_path / f"jax{len(kw)}.avi"),
                                              counts["jax"], "uniform", None, None)
        port_frames = media._read_video_native(str(tmp_path / f"port{len(kw)}.avi"),
                                               counts["port"], "uniform", None, None)
        assert np.abs(port_frames.astype(int) - jax_frames).max() <= JPEG_ATOL
    for side, mod, extra in (("jax", jingest, {}), ("port", tingest, {"device": "cpu"})):
        mod.transcode_video(src, str(tmp_path / f"{side}.frames.npy"), **extra)
    assert np.array_equal(np.load(tmp_path / "port.frames.npy"),
                          np.load(tmp_path / "jax.frames.npy"))
    assert tingest.segment_transcode(src, str(tmp_path / "seg.avi"), 0.4, 1.2, fps=5.0,
                                     device="cpu") == \
        jingest.segment_transcode(src, str(tmp_path / "jseg.avi"), 0.4, 1.2, fps=5.0) == 4
    for mod, dst, extra in ((jingest, "jax_tree", {}), (tingest, "port_tree", {"device": "cpu"})):
        assert mod.transcode_tree(str(tmp_path / "corpus"), str(tmp_path / dst), **extra) == 2
        assert mod.transcode_tree(str(tmp_path / "corpus"), str(tmp_path / dst), **extra) == 0
    assert sorted(os.listdir(tmp_path / "port_tree")) == sorted(os.listdir(tmp_path / "jax_tree"))
    assert (tmp_path / "port_tree" / "sub" / "b.avi").exists()


def test_encoder_runs_on_the_frames_device_unless_told():
    """The device pass goes to `device` (the card by default); a CPU tensor
    asked onto the card raises where there is none, never falls back."""
    frame = torch.from_numpy(smooth_frames(1, 16, 16)[0])
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises((RuntimeError, AssertionError)):
        list(jpeg_encode.encode_frames([frame], 90))
    assert len(list(jpeg_encode.encode_frames([frame, frame], 90, device="cpu"))) == 2
    with pytest.raises(ValueError, match="frames of"):
        list(jpeg_encode.encode_frames([frame, frame[:8]], 90, device="cpu", chunk=1))
