"""The port's media ops against the JAX package's on the same numpy inputs.

Tolerances: `fbank` within 2e-3 absolute on log-mels of magnitude ~10
(float32 FFTs of two libraries, summed in another order); `resample`
within 1e-5 (the same polyphase kernel, one conv each); `extract_clips`,
`yuv420_to_rgb` and the integer-valued augment ops (posterize, solarize,
translate, identity) exact; the blending ops within 1e-4 on [0, 255];
`resized_crop` within 2e-3 on [0, 255] (two f32 products against one f32
einsum); `decode_mjpeg_frames` within 1 LSB of JAX's on coefficients of a
JPEG the test writes. The random draws themselves cannot match (rbg
against torch's generators), so the crop is compared at JAX's own draws
and the augment ops at fixed magnitudes.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.ops import audio as jaudio
from affectgpt_tpu.ops import augment as jaug
from affectgpt_tpu.ops import image as jimage
from affectgpt_tpu.ops import jpeg as jjpeg
from affectgpt_tpu_torch.ops import audio, augment, image, jpeg


def test_mel_filterbank_and_fbank_match_jax():
    np.testing.assert_array_equal(audio.mel_filterbank(), jaudio.mel_filterbank())
    rng = np.random.RandomState(0)
    wave = (rng.randn(2, 32000) * 0.1).astype(np.float32)
    got = audio.fbank(torch.from_numpy(wave))
    want = np.stack([np.asarray(jaudio.fbank(jnp.asarray(w))) for w in wave])
    assert got.shape == (2, 128, 204)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)
    clips = torch.from_numpy(wave[:, None, :])
    np.testing.assert_allclose(audio.transform_audio(clips).numpy(),
                               np.asarray(jaudio.transform_audio(jnp.asarray(wave[:, None]))),
                               atol=2e-3 / 9.138, rtol=0)
    short = audio.fbank(torch.from_numpy(wave[0, :8000]))  # 49 frames, padded to 204
    np.testing.assert_allclose(short.numpy(), np.asarray(jaudio.fbank(jnp.asarray(wave[0, :8000]))),
                               atol=2e-3, rtol=0)


@pytest.mark.parametrize("orig,new", [(44100, 16000), (8000, 16000), (16000, 16000)])
def test_resample_matches_jax(orig, new):
    rng = np.random.RandomState(1)
    wave = rng.randn(2, 3001).astype(np.float32)
    got = audio.resample(torch.from_numpy(wave), orig, new)
    want = np.asarray(jaudio.resample(jnp.asarray(wave), orig, new))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(audio.resample_numpy(wave, orig, new),
                               jaudio.resample_numpy(wave, orig, new), atol=1e-6, rtol=0)


def test_extract_and_load_audio_clips_match_jax():
    rng = np.random.RandomState(2)
    wave = rng.randn(50000).astype(np.float32)
    got = audio.extract_clips(torch.from_numpy(wave))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jaudio.extract_clips(jnp.asarray(wave))))
    stereo = rng.randn(2, 20000).astype(np.float32)  # 0.45 s at 44.1 kHz: padded to 2 s
    got = audio.load_audio_clips(stereo, 44100, device="cpu")
    want = np.asarray(jaudio.load_audio_clips(stereo, 44100))
    assert got.shape == (8, 1, 32000)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_yuv420_to_rgb_matches_jax():
    rng = np.random.RandomState(3)
    planar = rng.randint(0, 256, (2, 3, 36, 16), dtype=np.uint8)  # H 24, W 16
    got = image.yuv420_to_rgb(torch.from_numpy(planar))
    want = np.asarray(jimage.yuv420_to_rgb(jnp.asarray(planar)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 3, 24, 16, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        image.yuv420_to_rgb(torch.zeros(3, 5, dtype=torch.uint8))


def test_resized_crop_matches_jax_at_its_draws():
    rng = np.random.RandomState(4)
    frames = rng.randint(0, 256, (2, 40, 56, 3)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jimage.random_resized_crop(key, jnp.asarray(frames), out_size=24))
        # JAX's own four draws, as random_resized_crop makes them
        k_scale, k_ratio, ky, kx = jax.random.split(key, 4)
        area = jax.random.uniform(k_scale, (), minval=0.5, maxval=1.0)
        log_ratio = jax.random.uniform(k_ratio, (), minval=jnp.log(3.0 / 4.0),
                                       maxval=jnp.log(4.0 / 3.0))
        draws = [float(v) for v in (area, log_ratio, jax.random.uniform(ky, ()),
                                    jax.random.uniform(kx, ()))]
        got = image.resized_crop(torch.from_numpy(frames), *draws, out_size=24)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)
    g = torch.Generator().manual_seed(0)
    out = image.preprocess_frames_train(g, torch.from_numpy(frames.astype(np.uint8)), 24)
    assert tuple(out.shape) == (3, 2, 24, 24) and torch.isfinite(out).all()
    again = image.preprocess_frames_train(torch.Generator().manual_seed(0),
                                          torch.from_numpy(frames.astype(np.uint8)), 24)
    assert torch.equal(out, again)  # the crop is a function of the generator


EXACT_OPS = {0, 5, 6, 7, 8}  # identity, posterize, solarize, the two translations


@pytest.mark.parametrize("op", range(len(jaug._OPS)))
@pytest.mark.parametrize("magnitude", [-0.37, 0.21, 0.5])
def test_augment_ops_match_jax(op, magnitude):
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 256, (2, 12, 10, 3)).astype(np.float32)
    mag = float(np.float32(magnitude))
    want = np.asarray(jaug._OPS[op](jnp.asarray(frames), jnp.float32(mag)))
    got = augment.OPS[op](torch.from_numpy(frames), mag).numpy()
    if op in EXACT_OPS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_rand_augment_draws_from_its_generator():
    frames = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (2, 12, 10, 3)))
    a = augment.rand_augment(torch.Generator().manual_seed(3), frames)
    b = augment.rand_augment(torch.Generator().manual_seed(3), frames)
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 255.0


@pytest.mark.parametrize("subsampling,gray", [(0, False), (2, False), (1, False), (0, True)])
def test_decode_mjpeg_frames_matches_jax(tmp_path, monkeypatch, subsampling, gray):
    """A JPEG the test writes (PIL), put in an MJPEG AVI, entropy-decoded by
    the host decoder; both packages finish the decode from its
    coefficients."""
    from PIL import Image

    from affectgpt_tpu.data import media
    from test_videodec_native import _build_avi, _rgb_test_frames

    frames = _rgb_test_frames(n=2, h=33, w=47, seed=subsampling)
    payloads = []
    for f in frames:
        buf = io.BytesIO()
        img = Image.fromarray(f).convert("L") if gray else Image.fromarray(f)
        img.save(buf, format="JPEG", quality=92, subsampling=subsampling)
        payloads.append(buf.getvalue())
    path = str(tmp_path / "clip.avi")
    _build_avi(path, payloads, 47, 33, b"MJPG")
    seen = {}
    decode = jjpeg.decode_mjpeg_frames

    def record(coefs, quants, **kwargs):
        seen.update(coefs=np.array(coefs), quants=np.array(quants), **kwargs)
        return decode(coefs, quants, **kwargs)

    monkeypatch.setattr(jjpeg, "decode_mjpeg_frames", record)
    want = media.read_video_frames_device(path, n_frms=2)
    assert want is not None
    got = jpeg.decode_mjpeg_frames(torch.from_numpy(seen["coefs"]),
                                   torch.from_numpy(seen["quants"]), width=seen["width"],
                                   height=seen["height"], sampling=seen["sampling"])
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 33, 47, 3)
    diff = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99
    # and it decoded the picture: PIL's own decode within a few levels
    ref = np.asarray(Image.open(io.BytesIO(payloads[0])).convert("RGB")).astype(int)
    assert np.abs(got[0].numpy().astype(int) - ref).mean() < 3.0
