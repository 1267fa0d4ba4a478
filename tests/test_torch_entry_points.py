"""The port's serving and feature command lines against the JAX package's, on
the CPU: `python -m affectgpt_tpu_torch.inference_hybird`,
`.inference_sample` and `.extract_multimodal_features_precompute` beside the
repo's root inference_hybird.py, inference_sample.py and
extract_multimodal_features_precompute.py, both reading the same tiny HF
directories (a Qwen2 with its Qwen2-style tokenizer, CLIP, CLIP text,
HuBERT; tests/torch_hf_models.py) with both packages' presets set to their
geometry, over tests/synth_corpus.py's corpus. Both bootstraps run in f32
(their `build_model` wrapped with the dtype) and both Chats greedy, so the
answers must be the same strings, the `.npz` files the same keys, and the
feature caches the same files, within 1e-4."""

import functools
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("transformers")
yaml = pytest.importorskip("yaml")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from affectgpt_tpu import paths as jpaths  # noqa: E402
from affectgpt_tpu.bootstrap import build_model as jax_build_model  # noqa: E402
from affectgpt_tpu.config import Config as JaxConfig  # noqa: E402
from affectgpt_tpu.inference.chat import Chat as JaxChat  # noqa: E402
from affectgpt_tpu.training import checkpoint as jcheckpoint  # noqa: E402
from affectgpt_tpu_torch import bootstrap as tboot  # noqa: E402
from affectgpt_tpu_torch import extract_multimodal_features_precompute as tpre  # noqa: E402
from affectgpt_tpu_torch import inference_hybird as thybird  # noqa: E402
from affectgpt_tpu_torch import inference_sample as tsample  # noqa: E402
from affectgpt_tpu_torch import paths as tpaths  # noqa: E402
from affectgpt_tpu_torch.inference.chat import Chat as TorchChat  # noqa: E402
from affectgpt_tpu_torch.models import convert  # noqa: E402
from affectgpt_tpu_torch.training import checkpoint as tcheckpoint  # noqa: E402
from tests import torch_hf_models as hf  # noqa: E402
from tests.synth_corpus import NAMES, build_corpus, write_wav  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"llama_model": "Qwen25", "preextracted_visual_dim": 12,
         "preextracted_acoustic_dim": 16, "num_video_query_token": 2,
         "num_audio_query_token": 2, "num_multi_query_token": 1, "lora_r": 2}


def jax_entry(name: str):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return __import__(name)


def greedy(chat_cls):
    """chat_cls whose answer_batch decodes greedily."""
    class Greedy(chat_cls):
        def answer_batch(self, *args, **kwargs):
            return super().answer_batch(*args, **{**kwargs, "do_sample": False})
    return Greedy


@pytest.fixture()
def env(tmp_path, monkeypatch):
    """The tiny model directories and presets, the synthetic corpus in both
    packages' path tables, f32 bootstraps in every entry module."""
    hf.set_tiny_presets(monkeypatch)
    hf.write_model_dirs(tmp_path / "models", monkeypatch)
    overrides, feat_root = build_corpus(tmp_path)
    for paths in (jpaths, tpaths):
        for table, entries in overrides.items():
            for key, value in entries.items():
                monkeypatch.setitem(getattr(paths, table), key, value)
    for name in ("inference_hybird", "inference_sample"):
        monkeypatch.setattr(jax_entry(name), "build_model",
                            functools.partial(jax_build_model, dtype=jnp.float32))
    for module in (thybird, tsample):
        monkeypatch.setattr(module, "build_model",
                            functools.partial(tboot.build_model, dtype=torch.float32))
    return tmp_path, feat_root


def write_checkpoints(tmp_path, node: dict) -> tuple:
    """One trainable tree (JAX's bootstrap draw with a nonzero LoRA B and
    O(1) mergers) saved as epoch 0 by each package's save_checkpoint;
    returns the two run directories."""
    _, _, trainable, _ = jax_build_model(JaxConfig.from_dict({"model": node}), dtype=jnp.float32)
    rng = np.random.RandomState(5)
    trainable = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" and p[0].key == "lora" else x * 25.0, trainable)
    runs = (str(tmp_path / "jax_run"), str(tmp_path / "port_run"))
    jcheckpoint.save_checkpoint(runs[0], 0, trainable, loss=1.0)
    tcheckpoint.save_checkpoint(runs[1], 0, convert.tree_to_torch(
        jax.tree.map(np.asarray, trainable), "cpu"), loss=1.0)
    return runs


def configs(tmp_path, feat_root) -> tuple:
    raw = {
        "model": {**MODEL, "skip_encoders": True},
        "datasets": {"mer2023": {"face_or_frame": "multiface_audio_face_frame_text",
                                 "use_preextracted_frame": True, "use_preextracted_face": True,
                                 "use_preextracted_audio": True, "preextracted_root": feat_root,
                                 "max_length": 640}},
        "run": {"output_dir": str(tmp_path / "output")},
        "inference": {"face_or_frame": "multiface_audio_face_frame_text"},
    }
    (tmp_path / "exp_inf.yaml").write_text(yaml.safe_dump(raw))
    (tmp_path / "exp_inf.json").write_text(json.dumps(raw))
    return str(tmp_path / "exp_inf.yaml"), str(tmp_path / "exp_inf.json")


def run_hybird_pair(tmp_path, monkeypatch, cfgs, runs, flags):
    """(JAX's, the port's) name2reason of one inference_hybird run each."""
    out = {}
    for side, cfg_path, run in (("jax", cfgs[0], runs[0]), ("port", cfgs[1], runs[1])):
        cwd = tmp_path / f"cwd_{side}_{'_'.join(flags) or 'dense'}"
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        argv = ["--cfg-path", cfg_path, "--dataset", "MER2023", "--batch_size", "2",
                "--max_new_tokens", "6", "--greedy", "--ckpt_root", run, *flags]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["inference_hybird.py", *argv])
            jax_entry("inference_hybird").main()
        else:
            thybird.main([*argv, "--device", "cpu"])
        path = cwd / "output" / "results" / "exp_inf" / "result-mer2023" / "0.npz"
        with np.load(path, allow_pickle=True) as npz:
            out[side] = (sorted(npz.files), npz["name2reason"].tolist())
    return out["jax"], out["port"]


@pytest.mark.parametrize("flags", [[], ["--paged", "--paged_block_size", "8"], ["--int8"]])
def test_inference_hybird_as_jax(env, monkeypatch, flags):
    tmp_path, feat_root = env
    cfgs = configs(tmp_path, feat_root)
    runs = write_checkpoints(tmp_path, {**MODEL, "skip_encoders": True})
    want, got = run_hybird_pair(tmp_path, monkeypatch, cfgs, runs, flags)
    assert got[0] == want[0] == ["name2reason"]
    assert set(got[1]) == set(NAMES)
    assert got[1] == want[1]
    assert any(got[1].values())  # some clip got a non-empty answer


def test_inference_hybird_resumes_and_selects_epochs(env, monkeypatch):
    tmp_path, feat_root = env
    _, cfg_path = configs(tmp_path, feat_root)
    monkeypatch.chdir(tmp_path)
    argv = ["--cfg-path", cfg_path, "--dataset", "MER2023", "--batch_size", "3",
            "--max_new_tokens", "2", "--greedy", "--device", "cpu"]
    thybird.main(argv)  # no checkpoint: one zero-shot pass as epoch 0
    out = tmp_path / "output" / "results" / "exp_inf" / "result-mer2023" / "0.npz"
    mtime = out.stat().st_mtime
    thybird.main(argv)
    assert out.stat().st_mtime == mtime  # skipped: the result exists
    ckpts = [(0, "a"), (1, "b"), (2, "c"), (3, "d")]
    assert thybird.select_epochs(ckpts, "last") == [(3, "d")]
    assert thybird.select_epochs(ckpts, "1-2") == [(1, "b"), (2, "c")]
    assert thybird.select_epochs(ckpts, "2") == [(2, "c")]
    assert thybird.get_user_message(True, None, True).startswith("Please recognize")


def test_inference_hybird_flags_that_raise(env):
    tmp_path, feat_root = env
    _, cfg_path = configs(tmp_path, feat_root)
    if not torch.cuda.is_available():  # --tp on the card: the cards are counted before any rank
        with pytest.raises(RuntimeError, match="CUDA card"):
            thybird.main(["--cfg-path", cfg_path, "--tp", "2"])
    with pytest.raises(ValueError, match="exclusive"):
        thybird.main(["--cfg-path", cfg_path, "--int8", "--int4", "--device", "cpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
@pytest.mark.parametrize("module,argv", [
    (thybird, []), (tsample, []), (tpre, ["--dataset", "MER2023", "--sample_list", "x"])])
def test_entry_points_default_to_the_card(module, argv):
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        module.main(argv)


def test_inference_sample_as_jax(env, monkeypatch, capsys):
    tmp_path, _ = env
    video = tmp_path / "clip.mp4"
    frames = np.random.RandomState(4).randint(0, 256, (12, 40, 48, 3)).astype(np.uint8)
    np.save(str(video) + ".frames.npy", frames)
    wav = tmp_path / "clip.wav"
    t = np.arange(int(22050 * 2.5)) / 22050
    write_wav(wav, (0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32), rate=22050)
    (tmp_path / "sample.yaml").write_text(yaml.safe_dump({"model": MODEL}))
    argv = ["--cfg-path", str(tmp_path / "sample.yaml"), "--video_path", str(video),
            "--audio_path", str(wav), "--subtitle", "I can't believe it!",
            "--outside_face_or_frame", "multiframe_audio_frame_text", "--max_new_tokens", "8"]
    jentry = jax_entry("inference_sample")
    monkeypatch.setattr(jentry, "Chat", greedy(JaxChat))
    monkeypatch.setattr(tsample, "Chat", greedy(TorchChat))
    monkeypatch.setattr(sys, "argv", ["inference_sample.py", *argv])
    jentry.main()
    want = capsys.readouterr().out.strip().splitlines()[-1]
    got = tsample.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == got.strip()
    assert got.strip() == want and got.strip()


def write_frame_dumps(tmp_path) -> None:
    """Frame dumps beside the corpus's (absent) MER2023 videos."""
    for i, name in enumerate(NAMES):
        frames = np.random.RandomState(i).randint(0, 256, (10, 36, 44, 3)).astype(np.uint8)
        np.save(tmp_path / "mer2023" / "video" / f"{name}.avi.frames.npy", frames)


def test_precompute_as_jax(env, monkeypatch):
    tmp_path, _ = env
    write_frame_dumps(tmp_path)
    for name in NAMES:
        au_dir = tmp_path / "mer_factory" / name
        au_dir.mkdir(parents=True)
        (au_dir / f"{name}_au_analysis.json").write_text(json.dumps(
            {"summary_description": {"3": "brows lowered, lips pressed", "1": f"{name} smiles"}}))
    (tmp_path / "names.csv").write_text("names,other\n" + "".join(f"{n},x\n" for n in NAMES))
    argv = ["--dataset", "MER2023", "--csv_path", str(tmp_path / "names.csv"),
            "--mer-factory-output", str(tmp_path / "mer_factory")]
    monkeypatch.setattr(sys, "argv", ["precompute.py", *argv, "--save_root",
                                      str(tmp_path / "jax_feats")])
    jax_entry("extract_multimodal_features_precompute").main()
    monkeypatch.setattr(tpre, "FeatureExtractor",
                        functools.partial(tpre.FeatureExtractor, dtype=torch.float32))
    tpre.main([*argv, "--save_root", str(tmp_path / "port_feats"), "--device", "cpu"])
    want = sorted(p.relative_to(tmp_path / "jax_feats")
                  for p in (tmp_path / "jax_feats").rglob("*.npy"))
    got = sorted(p.relative_to(tmp_path / "port_feats")
                 for p in (tmp_path / "port_feats").rglob("*.npy"))
    assert got == want
    assert len(got) == 5 * len(NAMES)  # frame, face, audio, au and multi of each clip
    assert {p.parts[1].split("_")[0] for p in got} == {"frame", "face", "audio", "au", "multi"}
    for rel in want:
        a, b = np.load(tmp_path / "jax_feats" / rel), np.load(tmp_path / "port_feats" / rel)
        assert a.shape == b.shape and b.dtype == np.float32, rel
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4, err_msg=str(rel))


def run_precompute(tmp_path, names: list, modality: str = "all") -> dict:
    """The port's precompute over `names` of the corpus on the CPU: {cache
    path relative to the save root: array}."""
    (tmp_path / "names.txt").write_text("\n".join(names) + "\n")
    save_root = tmp_path / "port_feats"
    tpre.main(["--dataset", "MER2023", "--sample_list", str(tmp_path / "names.txt"),
               "--modality", modality, "--save_root", str(save_root), "--device", "cpu"])
    return {str(p.relative_to(save_root)): np.load(p) for p in save_root.rglob("*.npy")}


def test_precompute_skips_unreadable_media(env):
    """A clip without media is skipped (no frame, face or multi cache) and its
    audio cache is zero-filled; the readable clip's caches are all written."""
    tmp_path, _ = env
    write_frame_dumps(tmp_path)
    feats = run_precompute(tmp_path, [NAMES[0], "no_such_clip"])
    kinds = {(rel.split("/")[1].split("_")[0], rel.split("/")[-1][:-4]) for rel in feats}
    assert kinds == {(m, NAMES[0]) for m in ("frame", "face", "audio", "multi")} | {
        ("audio", "no_such_clip")}
    zeros = next(a for rel, a in feats.items() if rel.endswith("/no_such_clip.npy"))
    width = tpre.encoders.get_acoustic_encoder("HUBERT_LARGE").make_config().hidden_size
    assert zeros.shape == (8, width) and not zeros.any()
    real = next(a for rel, a in feats.items() if rel.startswith("MER2023/audio_")
                and rel.endswith(f"/{NAMES[0]}.npy"))
    assert real.shape == zeros.shape and real.any()


@pytest.mark.parametrize("modality", ["frame", "audio"])
def test_precompute_fails_on_a_tower_error(env, monkeypatch, modality):
    """An error of a tower (here one raised in place of its encode, as a card
    fault would) ends the command and writes no cache."""
    import dataclasses

    from affectgpt_tpu_torch.models import encoders

    def fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    tmp_path, _ = env
    write_frame_dumps(tmp_path)
    if modality == "frame":
        monkeypatch.setattr(tpre, "encode_media_features", fault)
    else:
        monkeypatch.setitem(encoders.ACOUSTIC, "HUBERT_LARGE", dataclasses.replace(
            encoders.ACOUSTIC["HUBERT_LARGE"], encode=fault))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_precompute(tmp_path, NAMES, modality)
    assert not list((tmp_path / "port_feats").rglob("*.npy"))


def test_precompute_holds_towers_to_their_geometry(env, monkeypatch):
    """A tower directory of another geometry than the registry's fails the
    same check as bootstrap's (ValueError)."""
    import dataclasses

    from affectgpt_tpu_torch.models import encoders

    spec = encoders.VISUAL["CLIP_VIT_LARGE"]
    deeper = dataclasses.replace(spec.make_config(), num_layers=spec.make_config().num_layers + 1)
    monkeypatch.setitem(encoders.VISUAL, "CLIP_VIT_LARGE",
                        dataclasses.replace(spec, make_config=lambda: deeper))
    with pytest.raises(ValueError, match="vision tower has"):
        tpre.FeatureExtractor("CLIP_VIT_LARGE", "HUBERT_LARGE", "uniform", 8, 8,
                              str(env[0] / "feats"), "MER2023", device="cpu")
