"""The port's two OV-MER audio adapters (qwen_audio, salmonn) against the
repo's root adapters on the CPU, on the tiny random Qwen2-Audio, Whisper
and causal LM the root adapters' own tests build once a module.

The root `load_clip_audio` averages read_wav's [channels, samples] over
the sample axis and hands the processor one value a channel; the port
averages the channels. So the root adapters run here with their
`load_clip_audio` replaced by the reading they intend (the root package's
own read_wav, the channels averaged, its own `_resample_linear`), and the
port's loader is held to that reading exactly. Given the same waveform,
both hand generate the same ids and features within 1e-6 and reply the
same. A missing wav scores "" through either harness; an error of Whisper
or of the LLM ends the port's run."""

import struct

import numpy as np
import pytest
import torch

from affectgpt_tpu.data import media as jmedia
from affectgpt_tpu_torch.ovmer import zero_shot_harness as tharness
from affectgpt_tpu_torch.ovmer.adapters import qwen_audio, salmonn
from ovmer import zero_shot_harness as jharness
from ovmer.adapters import qwen_audio as j_qwen_audio
from ovmer.adapters import salmonn as j_salmonn
from tests.synth_corpus import NAMES
from tests.test_ovmer_adapters_more import tiny_qwen2audio  # noqa: F401
from tests.test_ovmer_adapters_round3 import _tiny_tokenizer, tiny_llm  # noqa: F401
from tests.test_torch_ovmer_adapters import (assert_same_generate, corpus,  # noqa: F401
                                             record_generate)

FEATURE_TOL = dict(rtol=1e-6, atol=1e-6)
SUBTITLES = ("I am fine.", None)


@pytest.fixture(scope="module")
def tiny_whisper():
    """The root adapters' tiny Whisper (tests/test_ovmer_adapters_round3.py)
    with 192 target positions: both SALMONN adapters ask Whisper for 128
    new tokens, which that fixture's 64 positions refuse, so the root test
    scored every clip "" through the adapter's catch-all."""
    from transformers import (WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration)

    cfg = WhisperConfig(
        vocab_size=64, num_mel_bins=16, d_model=32,
        encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_layers=2, decoder_attention_heads=4, decoder_ffn_dim=64,
        max_source_positions=200, max_target_positions=192,
        bos_token_id=1, eos_token_id=2, pad_token_id=3,
        decoder_start_token_id=1, begin_suppress_tokens=None,
        suppress_tokens=None, forced_decoder_ids=None,
    )
    torch.manual_seed(0)
    model = WhisperForConditionalGeneration(cfg).eval()
    model.generation_config.begin_suppress_tokens = None
    model.generation_config.suppress_tokens = None
    model.generation_config.forced_decoder_ids = None
    feat = WhisperFeatureExtractor(feature_size=16, sampling_rate=16000,
                                   hop_length=160, chunk_length=4, n_fft=400)
    return model, MiniProcessor(feat, _tiny_tokenizer("<|startoftranscript|>"))


class MiniProcessor:
    """The root test's duck-typed Whisper processor: the adapters touch only
    feature_extractor.sampling_rate, __call__ and batch_decode."""

    def __init__(self, feature_extractor, tokenizer):
        self.feature_extractor = feature_extractor
        self.tokenizer = tokenizer

    def __call__(self, *args, **kwargs):
        return self.feature_extractor(*args, **kwargs)

    def batch_decode(self, ids, **kwargs):
        return self.tokenizer.batch_decode(ids, **kwargs)


def write_wav(path, samples: np.ndarray, rate: int) -> str:
    """16-bit PCM of [n] or [n, channels] samples in [-1, 1]."""
    samples = samples.reshape(len(samples), -1)
    channels = samples.shape[1]
    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, rate, rate * 2 * channels,
                                      2 * channels, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)
    return str(path)


def intended_reading(audio_path, target_rate=16000):
    """The root package's pieces with the channel axis read_wav returns."""
    wav, rate = jmedia.read_wav(audio_path)
    return j_qwen_audio._resample_linear(np.asarray(wav, np.float32).mean(axis=0), rate,
                                         target_rate)


@pytest.fixture()
def root_reads_channels(monkeypatch):
    monkeypatch.setattr(j_qwen_audio, "load_clip_audio", intended_reading)
    monkeypatch.setattr(j_salmonn, "load_clip_audio", intended_reading)


def stereo_48k(tmp_path, seconds=0.5, seed=0) -> str:
    rng = np.random.RandomState(seed)
    return write_wav(tmp_path / "clip.wav", rng.randn(int(48000 * seconds), 2) * 0.2, 48000)


# -- the loader and the resampler ------------------------------------------------

@pytest.mark.parametrize("rate", [8000, 16000, 22050, 44100, 48000])
@pytest.mark.parametrize("channels", [1, 2])
def test_load_clip_audio_reads_the_channels(tmp_path, rate, channels):
    rng = np.random.RandomState(rate + channels)
    path = write_wav(tmp_path / "a.wav", rng.randn(rate // 3, channels) * 0.3, rate)
    got = qwen_audio.load_clip_audio(path)
    assert got.dtype == np.float32 and got.shape == (max(1, round(rate // 3 * 16000 / rate)),)
    np.testing.assert_array_equal(got, intended_reading(path))
    # the root loader resamples one value a channel
    short = channels if rate == 16000 else max(1, round(channels * 16000 / rate))
    assert j_qwen_audio.load_clip_audio(path).shape == (short,)


def test_resample_linear_equals_jax():
    rng = np.random.RandomState(3)
    for rate in (8000, 11025, 16000, 22050, 32000, 44100, 48000):
        for target in (8000, 16000, 48000):
            for n in (0, 1, 2, 7, 1000, rate // 5):
                wav = rng.randn(n).astype(np.float32)
                got = qwen_audio._resample_linear(wav, rate, target)
                want = j_qwen_audio._resample_linear(wav, rate, target)
                assert got.dtype == want.dtype and np.array_equal(got, want), (rate, target, n)


def test_missing_or_absent_wav_raises_clip_unreadable(tmp_path):
    with pytest.raises(tharness.ClipUnreadable, match="no audio path"):
        qwen_audio.load_clip_audio(None)
    with pytest.raises(tharness.ClipUnreadable) as info:
        qwen_audio.load_clip_audio(str(tmp_path / "absent.wav"))
    assert isinstance(info.value.__cause__, OSError)


@pytest.mark.parametrize("module,root", [(qwen_audio, j_qwen_audio), (salmonn, j_salmonn)],
                         ids=["qwen_audio", "salmonn"])
def test_prompts_equal_jax(module, root):
    for subtitle in (None, "", "I am fine.", "a; b", "{braces}"):
        assert module._emotion_prompt(subtitle) == root._emotion_prompt(subtitle)
    constants = [k for k in vars(root) if k.isupper()]
    assert constants and all(getattr(module, k) == getattr(root, k) for k in constants)


# -- the adapters against the root's -------------------------------------------------

def test_qwen_audio_equals_jax(tiny_qwen2audio, tmp_path, monkeypatch, root_reads_channels):
    model, proc = tiny_qwen2audio
    clip = stereo_48k(tmp_path)
    calls = record_generate(model, monkeypatch)
    want_fn = j_qwen_audio.build_model_fn(None, model=model, processor=proc, max_new_tokens=4)
    got_fn = qwen_audio.build_model_fn(None, device="cpu", model=model, processor=proc,
                                       max_new_tokens=4)
    for subtitle in SUBTITLES:
        want = want_fn(None, clip, subtitle, "unused")
        got = got_fn(None, clip, subtitle, "unused")
        assert isinstance(got, str) and got == want
    assert len(calls) == 4 and "input_features" in calls[1]
    for want_call, got_call in zip(calls[0::2], calls[1::2]):
        assert_same_generate(got_call, want_call, FEATURE_TOL)


def test_salmonn_equals_jax(tiny_whisper, tiny_llm, tmp_path, monkeypatch,
                            root_reads_channels):
    whisper, proc = tiny_whisper
    llm, tok = tiny_llm
    clip = stereo_48k(tmp_path)
    asr_calls, llm_calls = [], record_generate(llm, monkeypatch)
    inner = whisper.generate

    def whisper_generate(feats, **kwargs):
        asr_calls.append(dict(kwargs, input_features=feats))
        return inner(feats, **kwargs)

    monkeypatch.setattr(whisper, "generate", whisper_generate)
    parts = dict(whisper=whisper, whisper_processor=proc, llm=llm, llm_tokenizer=tok,
                 max_new_tokens=4)
    want_fn = j_salmonn.build_model_fn(None, None, **parts)
    got_fn = salmonn.build_model_fn(None, None, device="cpu", **parts)
    for subtitle in SUBTITLES:
        want = want_fn(None, clip, subtitle, "unused")
        got = got_fn(None, clip, subtitle, "unused")
        assert isinstance(got, str) and got == want
    assert len(asr_calls) == len(llm_calls) == 4
    for want_call, got_call in zip(asr_calls[0::2], asr_calls[1::2]):
        assert_same_generate(got_call, want_call, FEATURE_TOL)
    for want_call, got_call in zip(llm_calls[0::2], llm_calls[1::2]):
        assert_same_generate(got_call, want_call, FEATURE_TOL)


def test_run_zero_shot_equals_jax(tiny_qwen2audio, corpus, root_reads_channels):
    """qwen_audio through both harnesses over the corpus's mono 16 kHz wavs:
    the same npz keys and name2reason."""
    model, proc = tiny_qwen2audio
    want = jharness.run_zero_shot(
        "MER2023", j_qwen_audio.build_model_fn(None, model=model, processor=proc,
                                               max_new_tokens=4),
        str(corpus / "jax" / "result-mer2023" / "results-subtitle.npz"))
    got = tharness.run_zero_shot(
        "MER2023", qwen_audio.build_model_fn(None, device="cpu", model=model, processor=proc,
                                             max_new_tokens=4),
        str(corpus / "port" / "result-mer2023" / "results-subtitle.npz"))
    assert got == want and sorted(got) == NAMES
    for side in ("jax", "port"):
        with np.load(corpus / side / "result-mer2023" / "results-subtitle.npz",
                     allow_pickle=True) as data:
            assert data.files == ["name2reason"] and data["name2reason"].item() == want


def test_salmonn_missing_wav_scores_empty_through_the_harness(tiny_whisper, tiny_llm, corpus):
    whisper, proc = tiny_whisper
    llm, tok = tiny_llm
    (corpus / "mer2023" / "audio" / f"{NAMES[1]}.wav").unlink()
    parts = dict(whisper=whisper, whisper_processor=proc, llm=llm, llm_tokenizer=tok,
                 max_new_tokens=4)
    want = jharness.run_zero_shot("MER2023", j_salmonn.build_model_fn(None, None, **parts),
                                  str(corpus / "jax" / "0.npz"))
    got = tharness.run_zero_shot("MER2023",
                                 salmonn.build_model_fn(None, None, device="cpu", **parts),
                                 str(corpus / "port" / "0.npz"))
    assert got == want and got[NAMES[1]] == "" and sorted(got) == NAMES


def test_salmonn_model_error_ends_the_run(tiny_whisper, tiny_llm, corpus, monkeypatch):
    """SALMONN keeps no catch-all: Whisper's error ends the port's run,
    where the root adapter scores the clip ""."""
    whisper, proc = tiny_whisper
    llm, tok = tiny_llm

    def whisper_generate(feats, **kwargs):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(whisper, "generate", whisper_generate)
    parts = dict(whisper=whisper, whisper_processor=proc, llm=llm, llm_tokenizer=tok,
                 max_new_tokens=4)
    clip = str(corpus / "mer2023" / "audio" / f"{NAMES[0]}.wav")
    assert j_salmonn.build_model_fn(None, None, **parts)(None, clip, None, "unused") == ""
    save = corpus / "port" / "0.npz"
    with pytest.raises(RuntimeError, match="device-side assert"):
        tharness.run_zero_shot("MER2023", salmonn.build_model_fn(None, None, device="cpu",
                                                                 **parts), str(save))
    assert not save.exists()
