"""The port's training runner against the JAX package's, and its entry
point, on the CPU.

- JAX's `Runner` and the port's on the same synthetic corpus
  (`tests/synth_corpus.build_corpus`), the port's weights carried over by
  `convert.from_jax`, in f32 with `lora_dropout: 0` (JAX draws its masks
  from rbg, the port from torch): the same sample stream, per-iteration
  losses within LOSS_RTOL, the final trainable within PARAM_TOL, the same
  checkpoint epochs, best checkpoint and log lines. Each epoch's
  prefetcher of the port draws exactly the epoch's batches and trains on
  all of them; JAX's draws ahead and drops what it holds at the epoch's
  end, so its runner takes an on-demand iterator here (`on_demand`), which
  drops nothing and leaves JAX's loop as it is. The port's stream over two
  epochs is the loader's own whatever the worker's timing.
- `python -m affectgpt_tpu_torch.train --device cpu`, mirroring
  tests/test_train_entry.py: checkpoints, validation with a best
  checkpoint, resume at the next epoch with its step and optimizer state,
  the accumulation schedule at iteration resolution, legacy checkpoint
  migrations, a rerun over the same directory; and the card as the default
  device.
- The tiny mode of the port's bootstrap keeps the node's `lora_dropout`
  (JAX's sets 0.05 whatever the node says).
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu import bootstrap as jbootstrap
from affectgpt_tpu import config as jconfig
from affectgpt_tpu import paths as jpaths
from affectgpt_tpu.parallel import mesh as jmesh
from affectgpt_tpu.training import runner as jrunner
from affectgpt_tpu_torch import bootstrap as tbootstrap
from affectgpt_tpu_torch import config as tconfig
from affectgpt_tpu_torch import paths as tpaths
from affectgpt_tpu_torch import train as tentry
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.training import checkpoint, optim
from affectgpt_tpu_torch.training import runner as trunner
from tests.synth_corpus import build_corpus

REPO = Path(__file__).resolve().parent.parent
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: ops this small gain nothing from more, and in a
    parallel test run more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runner_corpus")
    overrides, feat_root = build_corpus(tmp)
    saved = [(m, k, dict(getattr(m, k))) for m in (jpaths, tpaths) for k in overrides]
    for module in (jpaths, tpaths):
        module.update_from_dict(overrides)
    yield feat_root, overrides
    for module, name, value in saved:
        getattr(module, name).clear()
        getattr(module, name).update(value)


def raw_cfg(out_dir, feat_root, **run):
    """tests/test_train_entry.py's tiny experiment, LoRA dropout off."""
    return {
        "model": {"llama_model": "tiny", "skip_encoders": True, "preextracted_visual_dim": 12,
                  "preextracted_acoustic_dim": 16, "multi_fusion_type": "attention",
                  "video_fusion_type": "attention", "audio_fusion_type": "attention",
                  "num_video_query_token": 2, "num_audio_query_token": 2,
                  "num_multi_query_token": 1, "num_image_query_token": 2, "lora_r": 2,
                  "lora_dropout": 0.0, "max_length": 640},
        "datasets": {"mercaptionplus": {
            "face_or_frame": "multiface_audio_face_text", "label_type": "hybird",
            "use_preextracted_face": True, "use_preextracted_audio": True,
            "preextracted_root": feat_root, "max_length": 640, "ratio": 1.0}},
        "run": {"max_epoch": 2, "iters_per_epoch": 3, "batch_size_train": 2, "init_lr": 1e-3,
                "min_lr": 1e-4, "warmup_steps": 2, "seed": 0, "log_freq": 1, "tp": 1,
                "max_grad_norm": 1.0, "evaluate": True, "val_iters": 1,
                "output_dir": str(out_dir), **run},
        "inference": {},
    }


def no_lora_dropout(model_cfg):
    """Both bootstraps shrink the LLM to its tiny geometry without a model
    directory, and JAX's tiny config keeps the default LoRA dropout 0.05
    whatever the node says: set it to 0 again (the port's keeps the node's
    0 already)."""
    return dataclasses.replace(model_cfg, llm=dataclasses.replace(model_cfg.llm,
                                                                  lora_dropout=0.0))


def jax_runner(raw, job):
    cfg = jconfig.Config.from_dict(raw, name="tiny_exp")
    model_cfg, frozen, trainable, tok = jbootstrap.build_model(cfg, dtype=jnp.float32)
    model_cfg = no_lora_dropout(model_cfg)
    datasets, ratios = jrunner.build_datasets(cfg, tok, model_cfg)
    mesh = jmesh.create_mesh(devices=jax.devices()[:1])
    runner = jrunner.Runner(cfg, tok, frozen, trainable, model_cfg, datasets, ratios,
                            mesh=mesh, job_id=job)
    return runner, frozen, trainable


def port_runner(raw, job, frozen, trainable):
    cfg = tconfig.Config.from_dict(raw, name="tiny_exp")
    model_cfg, _, _, tok = tbootstrap.build_model(cfg.model.to_dict(), device="cpu",
                                                  dtype=torch.float32)
    model_cfg = no_lora_dropout(model_cfg)
    numpy = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    tfrozen, ttrain = convert.from_jax(numpy(frozen), numpy(trainable), model_cfg, device="cpu")
    datasets, ratios = trunner.build_datasets(cfg, tok, model_cfg, device="cpu")
    return trunner.Runner(cfg, tok, tfrozen, ttrain, model_cfg, datasets, ratios, job_id=job,
                          device="cpu")


def counted(cls, drawn: list):
    """A subclass of the DevicePrefetcher `cls` that appends to `drawn` the
    batches its worker drew, at close."""
    class Counted(cls):
        def __init__(self, loader, *args, **kwargs):
            self.drawn = 0

            def counting():
                while True:
                    batch = next(loader)
                    self.drawn += 1
                    yield batch

            super().__init__(counting(), *args, **kwargs)

        def close(self):
            super().close()
            drawn.append(self.drawn)

    return Counted


def on_demand(drawn: list):
    """A stand-in for JAX's DevicePrefetcher that draws a batch when one is
    asked for: nothing is drawn ahead, so nothing is dropped at an epoch's
    end. Appends to `drawn` the batches each one drew, at close."""
    class OnDemand:
        def __init__(self, loader, put_fn=None, **_):
            self.loader, self.put_fn, self.count = loader, put_fn or (lambda b: b), 0

        def __next__(self):
            self.count += 1
            return self.put_fn(next(self.loader))

        def close(self):
            drawn.append(self.count)

    return OnDemand


def checkpoints(run_dir: Path):
    return sorted(int(p.name.split("_")[1]) for p in run_dir.iterdir()
                  if p.name.startswith("checkpoint_"))


def test_sample_stream_equals_jax(corpus, tmp_path):
    feat_root, _ = corpus
    raw = raw_cfg(tmp_path, feat_root)
    jr, frozen, trainable = jax_runner(raw, "j")
    tr = port_runner(raw, "t", frozen, trainable)
    for _ in range(6):
        want, got = next(jr.loader), next(tr.loader)
        assert got["names"] == want["names"]
        for key in ("input_ids", "labels", "attention_mask"):
            np.testing.assert_array_equal(got[key], want[key])
        for m in want["features"]:
            np.testing.assert_array_equal(got["features"][m], want["features"][m])


def test_runner_trains_as_jax(corpus, tmp_path, monkeypatch):
    feat_root, _ = corpus
    raw = raw_cfg(tmp_path, feat_root)
    jax_drawn, port_drawn = [], []
    monkeypatch.setattr(jrunner, "DevicePrefetcher", on_demand(jax_drawn))
    monkeypatch.setattr(trunner, "DevicePrefetcher", counted(trunner.DevicePrefetcher, port_drawn))
    jr, frozen, trainable = jax_runner(raw, "jax")
    tr = port_runner(raw, "port", frozen, trainable)
    jr.train()
    tr.train()
    assert port_drawn == jax_drawn == [3, 3]  # one an epoch, each drawing what it trained on
    want, got = jr.visualizer.history["loss"], tr.visualizer.history["loss"]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert int(tr.state.step) == int(jr.state.step) == 6
    want_leaves = optim.tree_leaves(jax.tree.map(np.asarray, jr.state.trainable))
    got_leaves = optim.tree_leaves(tr.state.trainable)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), w, **PARAM_TOL)
    out = tmp_path / "tiny_exp"
    assert checkpoints(out / "port") == checkpoints(out / "jax") == [0, 1, 2]
    assert checkpoints(out / "port" / "best") == checkpoints(out / "jax" / "best")
    lines = [json.loads(x) for x in (out / "port" / "log.txt").read_text().splitlines()]
    want_lines = [json.loads(x) for x in (out / "jax" / "log.txt").read_text().splitlines()]
    assert lines[0] == want_lines[0] and "config" in lines[0]
    assert [x["epoch"] for x in lines[1:]] == [x["epoch"] for x in want_lines[1:]] == [0, 1]
    for got_line, want_line in zip(lines[1:], want_lines[1:]):
        np.testing.assert_allclose(got_line["val_loss"], want_line["val_loss"], rtol=LOSS_RTOL)
    assert tr.json_log is not None and len(tr.iteration_ms) == len(tr.wait_ms) == 6


def write_yaml(tmp_path, feat_root, overrides, **run):
    import yaml

    raw = raw_cfg(tmp_path / "output", feat_root, **run)
    raw["run"].update(max_epoch=1, iters_per_epoch=2, evaluate=False, warmup_steps=0)
    raw["paths"] = overrides
    path = tmp_path / "tiny_exp.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_entry_point_trains_resumes_and_validates(corpus, tmp_path):
    feat_root, overrides = corpus
    cfg_path = write_yaml(tmp_path, feat_root, overrides)
    out = tmp_path / "output" / "tiny_exp"
    tentry.main(["--cfg-path", cfg_path, "--device", "cpu", "--options",
                 "run.accum_grad_iters=2", "run.job_id=first"])
    assert checkpoints(out / "first") == [0, 1]
    assert (out / "first" / "log.txt").exists()
    ck1 = next(p for p in (out / "first").iterdir() if p.name.startswith("checkpoint_000001"))
    payload = checkpoint.load_checkpoint(str(ck1))
    assert payload["epoch"] == 1 and payload["step"] == 2
    assert payload["opt_state"]["count"] == 1 and payload["opt_state"]["mini_step"] == 0

    # resume: the next epoch to train is the saved one, with its step and
    # optimizer state; no zero-shot checkpoint
    options = ["run.max_epoch=2", "run.accum_grad_iters=2", f"run.resume_ckpt_path={ck1}"]
    cfg = tconfig.Config.from_file(cfg_path, options=options)
    model_cfg, frozen, trainable, tok = tbootstrap.build_model(cfg.model.to_dict(), device="cpu")
    datasets, ratios = trunner.build_datasets(cfg, tok, model_cfg, device="cpu")
    resumed = trunner.Runner(cfg, tok, frozen, trainable, model_cfg, datasets, ratios,
                             job_id="second", device="cpu")
    assert resumed.start_epoch == 1 and resumed.state.step == 2
    assert resumed.state.opt_state["count"] == 1
    for got, want in zip(optim.tree_leaves(resumed.state.trainable),
                         optim.tree_leaves(payload["trainable"])):
        assert torch.equal(got, want)
    resumed.train()
    assert checkpoints(out / "second") == [2]
    assert resumed.state.opt_state["count"] == 2

    tentry.main(["--cfg-path", cfg_path, "--device", "cpu", "--options", "run.evaluate=true",
                 "run.val_iters=1", "run.job_id=val"])
    assert list((out / "val").glob("best/checkpoint_*"))
    tentry.main(["--cfg-path", cfg_path, "--device", "cpu", "--options", "run.job_id=val"])
    assert checkpoints(out / "val") == [0, 1]  # a rerun overwrites its names


def test_accum_schedule_at_iteration_resolution():
    """With accum_grad_iters=k the update after u·k micro-steps takes the
    schedule at u·k: lr 1 for micro-steps 0-1, then 0, so the second update
    leaves the parameters as the first left them."""
    tx = optim.make_optimizer(lambda s: 1.0 if s < 2 else 0.0, weight_decay=0.0, accum_steps=2)
    params = {"w": torch.ones(3)}
    state = tx.init(params)
    snapshots = [params["w"].clone()]
    for _ in range(4):
        state = tx.apply({"w": torch.ones(3)}, state, params)
        snapshots.append(params["w"].clone())
    assert not torch.allclose(snapshots[2], snapshots[0])
    torch.testing.assert_close(snapshots[4], snapshots[2], rtol=0, atol=1e-7)


@pytest.mark.parametrize("legacy", ["frame_and_face", "face_only"])
def test_legacy_modality_keyed_checkpoint_migrates(tmp_path, legacy):
    cfg = ta.AffectGPTConfig.tiny()
    trainable = ta.init_trainable(torch.Generator().manual_seed(0), cfg)
    old = dict(trainable, mergers=dict(trainable["mergers"]))
    video = old["mergers"].pop("video")
    if legacy == "frame_and_face":
        old["mergers"]["frame"] = video
        old["mergers"]["face"] = optim.tree_map(lambda x: x * 7.0, video)
    else:
        old["mergers"]["face"] = video
    path = checkpoint.save_checkpoint(str(tmp_path), 0, old, loss=0.5)
    fresh = ta.init_trainable(torch.Generator().manual_seed(9), cfg)
    merged = checkpoint.apply_checkpoint_overlays(fresh, path)
    assert set(merged["mergers"]) == set(fresh["mergers"])
    for got, want in zip(optim.tree_leaves(merged["mergers"]["video"]),
                         optim.tree_leaves(trainable["mergers"]["video"])):
        assert torch.equal(got, want)


def test_tensor_parallel_is_not_ported(corpus, tmp_path):
    """Tensor-parallel training (run.tp > 1) is ported (tests/
    test_torch_tp_train.py) and needs tp ranks: on one process run.tp = 2
    raises, as the layout does, and a layout whose tp is not run.tp is
    refused."""
    from affectgpt_tpu_torch.parallel import mesh

    feat_root, _ = corpus
    raw = raw_cfg(tmp_path / "output", feat_root, max_epoch=1, iters_per_epoch=1)
    raw["run"]["tp"] = 2
    cfg = tconfig.Config.from_dict(raw, name="tiny_exp")
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        trunner.Runner(cfg, None, {}, {}, None, {}, {}, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        mesh.create_layout(device="cpu", tp=2)
    with pytest.raises(ValueError, match="run.tp=2 but the layout has tp=1"):
        trunner.Runner(cfg, None, {}, {}, None, {}, {}, layout=mesh.create_layout("cpu"),
                       device="cpu")


def test_entry_point_defaults_to_the_card(corpus, tmp_path):
    """Without --device the run asks for the card, which this CPU-only
    machine lacks: it raises instead of falling back."""
    feat_root, overrides = corpus
    cfg_path = write_yaml(tmp_path, feat_root, overrides)
    assert tentry.parse_args(["--cfg-path", cfg_path]).device == "cuda"
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from affectgpt_tpu_torch import train\n"
            f"train.main(['--cfg-path', {cfg_path!r}])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "--device cpu" in proc.stderr


class Jittery:
    """A loader that sleeps a random while before each batch it hands out,
    so the prefetcher's worker runs ahead of or behind the step at random."""

    def __init__(self, loader, seed: int):
        self.loader, self.rng = loader, np.random.RandomState(seed)

    def __next__(self):
        time.sleep(float(self.rng.choice([0.0, 0.0, 0.002, 0.02])))
        return next(self.loader)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefetcher_keeps_every_batch_across_epochs(corpus, tmp_path, seed):
    """Over two epochs the steps see the loader's own stream, in order,
    whatever the worker's timing: no batch drawn ahead is dropped at an
    epoch's end. With validation on, whose loader shares the dataset's
    random state, two timings give the same stream too."""
    feat_root, _ = corpus
    streams = {}
    for evaluate, jitter in ((False, None), (False, seed), (True, seed), (True, seed + 10)):
        raw = raw_cfg(tmp_path, feat_root, evaluate=evaluate, iters_per_epoch=4)
        cfg = tconfig.Config.from_dict(raw, name="tiny_exp")
        model_cfg, frozen, trainable, tok = tbootstrap.build_model(cfg.model.to_dict(),
                                                                   device="cpu")
        datasets, ratios = trunner.build_datasets(cfg, tok, model_cfg, device="cpu")
        r = trunner.Runner(cfg, tok, frozen, trainable, model_cfg, datasets, ratios,
                           job_id=f"jitter{seed}", device="cpu")
        if jitter is None:  # the loader's own stream
            streams[evaluate, jitter] = [next(r.loader)["input_ids"] for _ in range(8)]
            continue
        r.loader = Jittery(r.loader, jitter)
        seen = []
        r._device_batch = lambda batch: batch["input_ids"]
        r.step_fn = lambda state, frozen, ids, seen=seen: (seen.append(ids) or state,
                                                           {"loss": torch.zeros(())})
        r.validate = lambda r=r: float(len(next(r._val_loader)["names"]))
        r.train()
        streams[evaluate, jitter] = seen

    def same(a, b):
        return len(a) == len(b) == 8 and all(np.array_equal(x, y) for x, y in zip(a, b))

    assert same(streams[False, seed], streams[False, None])
    assert same(streams[True, seed], streams[True, seed + 10])


def test_tiny_mode_keeps_the_nodes_lora_dropout(corpus, tmp_path):
    """Without a model directory the port's bootstrap shrinks the LLM to its
    tiny geometry and keeps the node's LoRA dropout (a departure: JAX's
    tiny config keeps 0.05 whatever the node says)."""
    feat_root, _ = corpus
    node = raw_cfg(tmp_path, feat_root)["model"]
    for rate in (0.0, 0.2):
        tcfg = tbootstrap.build_model({**node, "lora_dropout": rate}, device="cpu")[0]
        assert tcfg.llm.hidden_size == 32 and tcfg.llm.lora_dropout == rate
        jcfg = jbootstrap.build_model(jconfig.Config.from_dict(
            {**raw_cfg(tmp_path, feat_root), "model": {**node, "lora_dropout": rate}},
            name="tiny_exp"), dtype=jnp.float32)[0]
        assert jcfg.llm.lora_dropout == 0.05
