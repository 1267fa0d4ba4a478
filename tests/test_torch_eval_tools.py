"""The port's remaining evaluation tools against the repo's root scripts, on
the CPU: the MER-UniBench precompute (mer_unibench/
extract_frame_emotion_peak_batch.py) writes JAX's caches within 1e-4 from
the same tiny tower directories (tests/torch_hf_models.py, both packages'
presets at the tiny geometry, the port in f32); the OV-MER zero-shot
harness saves JAX's name2reason for the same model_fn, which the port's
evaluation then scores; verify_au_pipeline reports what JAX's reports."""

import functools
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from affectgpt_tpu import paths as jpaths
from affectgpt_tpu_torch import paths as tpaths
from affectgpt_tpu_torch import verify_au_pipeline as tverify
from affectgpt_tpu_torch.evaluation import __main__ as teval
from affectgpt_tpu_torch.mer_unibench import extract_frame_emotion_peak_batch as tmub
from affectgpt_tpu_torch.ovmer import zero_shot_harness as tharness
from tests.synth_corpus import NAMES, build_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_module(name: str):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return __import__(name, fromlist=[name.split(".")[-1]])


@pytest.fixture()
def corpus(tmp_path, monkeypatch):
    overrides, _ = build_corpus(tmp_path)
    for paths in (jpaths, tpaths):
        for table, entries in overrides.items():
            for key, value in entries.items():
                monkeypatch.setitem(getattr(paths, table), key, value)
    return tmp_path


def test_mer_unibench_precompute_equals_jax(corpus, monkeypatch):
    pytest.importorskip("transformers")
    from tests import torch_hf_models as hf

    hf.set_tiny_presets(monkeypatch)
    hf.write_model_dirs(corpus / "models", monkeypatch)
    for i, name in enumerate(NAMES[:2]):  # the third clip has no video: skipped
        frames = np.random.RandomState(i).randint(0, 256, (10, 36, 44, 3)).astype(np.uint8)
        np.save(corpus / "mer2023" / "video" / f"{name}.avi.frames.npy", frames)
    argv = ["--datasets", "mer2023", "--frame_n_frms", "4"]
    monkeypatch.setattr(sys, "argv", ["mub", *argv, "--save_root", str(corpus / "jax_feats")])
    jax_module("mer_unibench.extract_frame_emotion_peak_batch").main()
    monkeypatch.setattr(tmub, "FeatureExtractor",
                        functools.partial(tmub.FeatureExtractor, dtype=torch.float32))
    tmub.main([*argv, "--save_root", str(corpus / "port_feats"), "--device", "cpu"])
    want = sorted(p.relative_to(corpus / "jax_feats") for p in (corpus / "jax_feats").rglob("*.npy"))
    got = sorted(p.relative_to(corpus / "port_feats")
                 for p in (corpus / "port_feats").rglob("*.npy"))
    assert got == want and len(got) == 2 + 3 + 3  # frame of 2 clips, face and audio of 3
    for rel in want:
        a, b = np.load(corpus / "jax_feats" / rel), np.load(corpus / "port_feats" / rel)
        assert a.shape == b.shape and b.dtype == np.float32, rel
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4, err_msg=str(rel))


def test_mer_unibench_without_a_card_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tmub.main(["--datasets", "mer2023", "--save_root", str(corpus / "feats")])


def model_fn(video, audio, subtitle, prompt):
    if video.endswith(f"{NAMES[1]}.mp4"):
        raise RuntimeError("this clip fails")
    return (f"{os.path.basename(video)} {os.path.basename(audio)} [{subtitle}]: the person "
            f"looks happy and cheerful. {prompt[:10]}")


@pytest.mark.parametrize("with_subtitle,limit", [(True, None), (False, 2)])
def test_zero_shot_harness_equals_jax(corpus, with_subtitle, limit):
    harness = jax_module("ovmer.zero_shot_harness")
    want = harness.run_zero_shot("MER2023", model_fn, str(corpus / "jax" / "result-mer2023" /
                                                          "0.npz"), with_subtitle, limit=limit)
    got = tharness.run_zero_shot("MER2023", model_fn, str(corpus / "port" / "result-mer2023" /
                                                          "0.npz"), with_subtitle, limit=limit)
    assert got == want and got[NAMES[1]] == "" and len(got) == (limit or 3)
    assert tharness.ZERO_SHOT_PROMPT == harness.ZERO_SHOT_PROMPT
    with np.load(corpus / "port" / "result-mer2023" / "0.npz", allow_pickle=True) as data:
        assert data.files == ["name2reason"] and data["name2reason"].item() == want
    if limit is None:  # a partial sweep lacks clips the ground truth names
        scores = teval.main(["--input-dir", str(corpus / "port"), "--no-llm", "--device", "cpu"])
        assert set(scores) == {"MER2023"} and np.isfinite(scores["MER2023"][1])


def write_mer_factory(root):
    clips = {
        "good": {"au_info": {"peak_frames": [{"peak_index": 3, "frames_before_peak": 1,
                                              "frames_after_peak": 2}], "frames": []},
                 "summary_description": "brows lowered"},
        "nopeak": {"au_info": {"frames": [{"summary_description": "a smile"}]}},
        "badpeak": {"au_info": {"peak_frames": [{"peak_index": 1}]}},
        "noinfo": {"summary_description": "x"},
    }
    for name, data in clips.items():
        (root / name).mkdir(parents=True)
        (root / name / f"{name}_au_analysis.json").write_text(json.dumps(data))
    (root / "broken").mkdir()
    (root / "broken" / "broken_au_analysis.json").write_text("{not json")


def write_au_caches(root):
    sub = root / "MER2023" / "au_CLIP_VIT_BASE32"
    sub.mkdir(parents=True)
    np.save(sub / "good.npy", np.zeros((2, 512), np.float32))
    np.save(sub / "nopeak.npy", np.zeros((2, 64), np.float32))
    np.save(sub / "badpeak.npy", np.full((1, 512), np.nan, np.float32))


@pytest.mark.parametrize("extra", [[], ["--limit", "3"], ["--feature-root", "FEATS"],
                                   ["--nonverbal-json", "GOOD"], ["--nonverbal-json", "BAD"]])
def test_verify_au_pipeline_reports_as_jax(tmp_path, monkeypatch, caplog, extra):
    write_mer_factory(tmp_path / "mf")
    write_au_caches(tmp_path / "feats")
    (tmp_path / "good.json").write_text(json.dumps({"MER2023": {"a": "x", "b": "y"}, "x": 1}))
    (tmp_path / "bad.json").write_text("[")
    extra = [{"FEATS": str(tmp_path / "feats"), "GOOD": str(tmp_path / "good.json"),
              "BAD": str(tmp_path / "bad.json")}.get(a, a) for a in extra]
    argv = ["--mer-factory-output", str(tmp_path / "mf"), *extra]
    jax_verify = jax_module("verify_au_pipeline")
    with caplog.at_level(logging.INFO):
        monkeypatch.setattr(sys, "argv", ["verify", *argv])
        jax_verify.main()
        want = [(r.levelno, r.getMessage()) for r in caplog.records]
        caplog.clear()
        report = tverify.main(argv)
        got = [(r.levelno, r.getMessage()) for r in caplog.records]
    assert got == want and len(got) >= 3
    assert report["warnings"] == [m for lvl, m in got if lvl == logging.WARNING]
    assert (report["ok"], report["bad"]) == ((1, 2) if "--limit" in extra else (2, 3))
    for path in sorted((tmp_path / "mf").glob("*/*.json")):
        assert tverify.check_au_json(str(path)) == jax_verify.check_au_json(str(path))
