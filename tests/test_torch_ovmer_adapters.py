"""The port's OV-MER video adapters (affectgpt_tpu_torch/ovmer/adapters/)
against the repo's root adapters (ovmer/adapters/) on the CPU.

Both packages drive the same tiny random HF model, built once a module by
the root adapters' own tests, over the same synthetic clip (a
`.frames.npy` dump beside an empty `.mp4`). A wrapper of the model's
`generate` records what each adapter hands it: ids and masks exactly
equal, pixels within the tolerance `tests/test_torch_encoders.py` holds
`preprocess_frames_eval` to, the other arguments identical, and the
replies equal. The pure rules (frame sampling, token counts, Otter's
parse, the prompts) equal JAX's over drawn inputs; `run_zero_shot` saves
what the root harness saves; and the harness scores "" only a clip whose
media cannot be read, while any other error of a model_fn ends the run."""

import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from affectgpt_tpu import paths as jpaths
from affectgpt_tpu_torch import paths as tpaths
from affectgpt_tpu_torch.ovmer import zero_shot_harness as tharness
from affectgpt_tpu_torch.ovmer.adapters import _llava_base as tbase
from affectgpt_tpu_torch.ovmer.adapters import (chat_univi, llama_vid, mplug_owl, otter,
                                                video_chatgpt, videochat, videochat2,
                                                videollava)
from ovmer import zero_shot_harness as jharness
from ovmer.adapters import _llava_base as jbase
from ovmer.adapters import chat_univi as j_chat_univi
from ovmer.adapters import llama_vid as j_llama_vid
from ovmer.adapters import mplug_owl as j_mplug_owl
from ovmer.adapters import otter as j_otter
from ovmer.adapters import video_chatgpt as j_video_chatgpt
from ovmer.adapters import videochat as j_videochat
from ovmer.adapters import videochat2 as j_videochat2
from ovmer.adapters import videollava as j_videollava
from tests.synth_corpus import NAMES, build_corpus
from tests.test_ovmer_adapter import tiny_videollava  # noqa: F401
from tests.test_ovmer_adapters_more import tiny_llava  # noqa: F401
from tests.test_ovmer_adapters_round3 import tiny_llava_next_video  # noqa: F401

PIXEL_TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_torch_encoders.py's TOL
PIXEL_KEYS = ("pixel_values", "pixel_values_videos")
SUBTITLES = ("I am fine.", None)

# adapter: (port module, root module, the tiny model's fixture, build kwargs)
ADAPTERS = {
    "videollava": (videollava, j_videollava, "tiny_videollava", {"max_new_tokens": 4}),
    "chat_univi": (chat_univi, j_chat_univi, "tiny_llava",
                   {"max_new_tokens": 4, "max_frames": 4, "assumed_fps": 1.0}),
    "llama_vid": (llama_vid, j_llama_vid, "tiny_llava", {"max_new_tokens": 4}),
    "mplug_owl": (mplug_owl, j_mplug_owl, "tiny_llava", {}),
    "otter": (otter, j_otter, "tiny_llava", {"max_new_tokens": 4, "num_frames": 4}),
    "videochat": (videochat, j_videochat, "tiny_llava",
                  {"max_new_tokens": 4, "num_segments": 4}),
    "videochat2": (videochat2, j_videochat2, "tiny_llava_next_video",
                   {"max_new_tokens": 4, "num_segments": 4}),
    "video_chatgpt": (video_chatgpt, j_video_chatgpt, "tiny_llava_next_video",
                      {"max_new_tokens": 4, "num_frames": 4}),
}


def write_clip(path, n_frames=30, seed=0, hw=(48, 40)):
    """An empty `.mp4` and its `.frames.npy` dump (both packages' last rung)."""
    path.touch()
    frames = np.random.RandomState(seed).randint(0, 256, (n_frames, *hw, 3)).astype(np.uint8)
    np.save(str(path) + ".frames.npy", frames)
    return str(path)


def record_generate(model, monkeypatch) -> list:
    """The model's generate wrapped to append each call's keyword arguments."""
    calls = []
    inner = model.generate

    def generate(*args, **kwargs):
        assert not args
        calls.append(kwargs)
        return inner(**kwargs)

    monkeypatch.setattr(model, "generate", generate)
    return calls


def assert_same_generate(got: dict, want: dict, tol: dict = PIXEL_TOL) -> None:
    """Ids and masks equal, pixels or audio features within `tol`, the other
    arguments identical."""
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key in PIXEL_KEYS or key == "input_features":
            assert got[key].shape == value.shape and got[key].dtype == value.dtype, key
            np.testing.assert_allclose(got[key].cpu().numpy(), value.cpu().numpy(), **tol,
                                       err_msg=key)
        elif isinstance(value, torch.Tensor):
            assert torch.equal(got[key], value), key
        else:
            assert got[key] == value, key


def mplug_max_length(tok) -> int:
    """Four new tokens past mPLUG-Owl's longer prompt (4 frames of the tiny
    Llava's 4 image tokens), so its sampled continuation stays short."""
    longest = max(len(tok.encode(mplug_owl.CONVERSATION_TEMPLATE.format(
        user_message=mplug_owl._emotion_prompt(s)).replace("<|video|>", "<image>" * 16)))
        for s in SUBTITLES)
    return longest + 4


@pytest.fixture()
def corpus(tmp_path, monkeypatch):
    overrides, _ = build_corpus(tmp_path)
    for paths in (jpaths, tpaths):
        for table, entries in overrides.items():
            for key, value in entries.items():
                monkeypatch.setitem(getattr(paths, table), key, value)
    return tmp_path


@pytest.mark.parametrize("name", list(ADAPTERS))
def test_adapter_equals_jax(name, request, tmp_path, monkeypatch):
    """Each video adapter hands generate what its root twin hands it, and
    replies the same, with and without a subtitle."""
    port, root, fixture, kwargs = ADAPTERS[name]
    model, tok = request.getfixturevalue(fixture)
    if name == "mplug_owl":
        kwargs = {"max_length": mplug_max_length(tok)}
    clip = write_clip(tmp_path / "clip.mp4")
    calls = record_generate(model, monkeypatch)
    want_fn = root.build_model_fn(None, model=model, tokenizer=tok, **kwargs)
    got_fn = port.build_model_fn(None, device="cpu", model=model, tokenizer=tok, **kwargs)
    for subtitle in SUBTITLES:
        torch.manual_seed(0)  # llama_vid and mplug_owl sample
        want = want_fn(clip, None, subtitle, "unused")
        torch.manual_seed(0)
        got = got_fn(clip, None, subtitle, "unused")
        assert isinstance(got, str) and got == want
    assert len(calls) == 2 * len(SUBTITLES)
    for want_call, got_call in zip(calls[0::2], calls[1::2]):
        assert_same_generate(got_call, want_call)
    pixels = [k for k in PIXEL_KEYS if k in calls[1]]
    assert len(pixels) == 1 and calls[1][pixels[0]].dtype == torch.float32


def test_mplug_owl_overlong_prompt_scores_empty_without_generate(tiny_llava, tmp_path,
                                                                  monkeypatch):
    """A prompt that reaches max_length scores "" in both packages; the port
    gives it before generate, which would refuse the prompt."""
    model, tok = tiny_llava
    clip = write_clip(tmp_path / "clip.mp4")
    want = j_mplug_owl.build_model_fn(None, model=model, tokenizer=tok, max_length=8)
    calls = record_generate(model, monkeypatch)
    got = mplug_owl.build_model_fn(None, device="cpu", model=model, tokenizer=tok,
                                   max_length=8)
    assert got(clip, None, "I am fine.", "unused") == "" and not calls
    assert want(clip, None, "I am fine.", "unused") == ""


# -- the pure rules over drawn inputs -------------------------------------------

VLENS = sorted(set(range(1, 65)) | set(np.random.RandomState(0).randint(65, 2001, 150).tolist())
               | {2000})


@pytest.mark.parametrize("rule", ["chat_univi", "llama_vid", "mplug_owl", "otter",
                                  "videochat"])
def test_sampling_rule_equals_jax(rule):
    cases = {
        "chat_univi": [(fps, rate, cap) for fps in (1.0, 23.976, 25.0, 29.97, 60.0)
                       for rate in (1, 2) for cap in (8, 100)],
        "llama_vid": [(fps, target) for fps in (1.0, 23.976, 25.0, 30.0, 60.0)
                      for target in (1, 2)],
        "mplug_owl": [(n,) for n in (1, 4, 8)],
        "otter": [(n,) for n in (1, 4, 16)],
        "videochat": [(n,) for n in (1, 4, 8)],
    }[rule]
    port, root = ADAPTERS[rule][:2]
    for vlen in VLENS:
        for args in cases:
            got = port.sample_frame_indices(vlen, *args)
            want = root.sample_frame_indices(vlen, *args)
            assert got.dtype == want.dtype and np.array_equal(got, want), (vlen, args)
    assert videochat2.sample_frame_indices is videochat.sample_frame_indices


def _config(image_size, patch_size, strategy, pool=None, num_frames=None):
    vision = SimpleNamespace(image_size=image_size, patch_size=patch_size)
    if num_frames is not None:
        vision.num_frames = num_frames
    config = SimpleNamespace(vision_config=vision)
    if strategy is not None:
        config.vision_feature_select_strategy = strategy
    if pool is not None:
        config.spatial_pool_stride = pool
    return config


TOKEN_CONFIGS = [(size, patch, strategy, pool, frames)
                 for size, patch in ((28, 14), (56, 14), (224, 14), (224, 16), (336, 14))
                 for strategy in (None, "default", "full") for pool in (None, 2, 3)
                 for frames in (None, 8, 16)]


def test_token_counts_equal_jax():
    for args in TOKEN_CONFIGS:
        config = _config(*args)
        model = SimpleNamespace(config=config)
        assert videollava.num_video_tokens(config) == j_videollava.num_video_tokens(config)
        assert tbase.image_tokens_per_frame(model) == jbase.image_tokens_per_frame(model)
        assert tbase.video_tokens_per_frame(model) == jbase.video_tokens_per_frame(model)
    # llava-1.5-7b (336 px, patch 14): 576 a frame; LLaVA-NeXT-Video pools 2: 144
    model = SimpleNamespace(config=_config(336, 14, "default", 2))
    assert tbase.image_tokens_per_frame(model) == (336, 576)
    assert tbase.video_tokens_per_frame(model) == (336, 144)
    # Video-LLaVA-7B (224 px, patch 14, 8 frames): 257 a frame with its CLS
    assert videollava.num_video_tokens(_config(224, 14, "default", num_frames=8)) == 2056


def test_otter_parse_answer_equals_jax():
    rng = np.random.RandomState(1)
    pieces = ["<answer>", "<|endofchunk|>", '"', " ", "\n", "happy", "sad face", "GPT:",
              "User:", "<image>"]
    for _ in range(400):
        text = "".join(pieces[i] for i in rng.randint(0, len(pieces), rng.randint(0, 9)))
        assert otter.parse_answer(text) == j_otter.parse_answer(text), repr(text)


@pytest.mark.parametrize("name", list(ADAPTERS))
def test_prompts_equal_jax(name):
    port, root = ADAPTERS[name][:2]
    for subtitle in (None, "", "I am fine.", "a; b", "{braces}"):
        assert port._emotion_prompt(subtitle) == root._emotion_prompt(subtitle)
    constants = [k for k in vars(root) if k.isupper()]
    assert constants and all(getattr(port, k) == getattr(root, k) for k in constants)


# -- the harness end to end, and its repair ---------------------------------------

def write_corpus_clips(corpus, names=NAMES):
    video_root = corpus / "mer2023" / "video"
    for i, name in enumerate(names):
        write_clip(video_root / f"{name}.mp4", n_frames=10 + i, seed=i)
    return video_root


def test_run_zero_shot_equals_jax(tiny_llava, corpus):
    """videochat through both harnesses: the same npz keys and name2reason."""
    model, tok = tiny_llava
    write_corpus_clips(corpus)
    kwargs = {"max_new_tokens": 4, "num_segments": 4}
    want = jharness.run_zero_shot(
        "MER2023", j_videochat.build_model_fn(None, model=model, tokenizer=tok, **kwargs),
        str(corpus / "jax" / "result-mer2023" / "results-subtitle.npz"))
    got = tharness.run_zero_shot(
        "MER2023", videochat.build_model_fn(None, device="cpu", model=model, tokenizer=tok,
                                            **kwargs),
        str(corpus / "port" / "result-mer2023" / "results-subtitle.npz"))
    assert got == want and sorted(got) == NAMES
    for side in ("jax", "port"):
        with np.load(corpus / side / "result-mer2023" / "results-subtitle.npz",
                     allow_pickle=True) as data:
            assert data.files == ["name2reason"] and data["name2reason"].item() == want


def test_model_error_ends_the_run(tiny_llava, corpus, monkeypatch):
    """An error of the model (here generate raising as a failed launch
    does) ends run_zero_shot with that error and writes no npz."""
    model, tok = tiny_llava
    write_corpus_clips(corpus)

    def generate(**kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(model, "generate", generate)
    fn = videochat.build_model_fn(None, device="cpu", model=model, tokenizer=tok,
                                  max_new_tokens=4, num_segments=4)
    save = corpus / "port" / "result-mer2023" / "0.npz"
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tharness.run_zero_shot("MER2023", fn, str(save))
    assert not save.exists()


@pytest.mark.parametrize("error", [RuntimeError("a kernel refused the shape"),
                                   ValueError("head_dim % 8"), TypeError("f32 tree")],
                         ids=lambda e: type(e).__name__)
def test_run_zero_shot_lets_a_model_fns_error_through(corpus, error):
    def model_fn(video, audio, subtitle, prompt):
        raise error

    save = corpus / "port" / "result-mer2023" / "0.npz"
    with pytest.raises(type(error)) as info:
        tharness.run_zero_shot("MER2023", model_fn, str(save))
    assert info.value is error and not save.exists()


def test_unreadable_and_missing_clips_score_empty(tiny_llava, corpus, caplog):
    """A clip with no file and one no decoder reads score "" with a
    warning, as in the root harness; the readable clip is answered."""
    model, tok = tiny_llava
    video_root = write_corpus_clips(corpus, NAMES[:1])
    (video_root / f"{NAMES[1]}.mp4").write_bytes(b"\x00" * 64)  # no decoder, no dump
    kwargs = {"max_new_tokens": 4, "num_segments": 4}
    want = jharness.run_zero_shot(
        "MER2023", j_videochat.build_model_fn(None, model=model, tokenizer=tok, **kwargs),
        str(corpus / "jax" / "0.npz"))
    with caplog.at_level(logging.WARNING, logger=tharness.logger.name):
        got = tharness.run_zero_shot(
            "MER2023", videochat.build_model_fn(None, device="cpu", model=model,
                                                tokenizer=tok, **kwargs),
            str(corpus / "port" / "0.npz"))
    assert got == want and got[NAMES[1]] == got[NAMES[2]] == ""
    warned = [r.getMessage() for r in caplog.records if r.name == tharness.logger.name]
    assert len(warned) == 2 and all("cannot read its media" in m for m in warned)


def test_the_host_read_raises_clip_unreadable(tmp_path):
    with pytest.raises(tharness.ClipUnreadable, match="no video path"):
        tbase.load_frames(None, lambda n: [0])
    with pytest.raises(tharness.ClipUnreadable) as info:
        tbase.read_video(str(tmp_path / "absent.mp4"), 8)
    assert isinstance(info.value.__cause__, Exception)
    clip = write_clip(tmp_path / "clip.mp4", n_frames=5)
    assert tbase.load_frames(clip, lambda n: [0, n - 1, 99]).shape == (3, 48, 40, 3)
