"""The port's AU-agent SFT against the repo's root au_agent_finetune/, on the
CPU: `build_batch` equal to JAX's; `prepare_au_instruction_dataset` writes
the same JSON from a MER-Factory tree; three steps of `train_au_agent
--llama-model tiny` with dropout 0 give JAX's losses within 1e-4 from the
same weights (JAX's tiny draw in f32, handed to the port through
`tree_to_torch`) and the same initial LoRA (JAX's `init_lora`, likewise);
the checkpoints reload to the trained leaves; with dropout on, the loss
is finite and the masks differ from step to step."""

import functools
import json
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu import bootstrap as jboot
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch.au_agent_finetune import prepare_au_instruction_dataset as tprep
from affectgpt_tpu_torch.au_agent_finetune import train_au_agent as ttrain
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer
from affectgpt_tpu_torch.training import checkpoint as tcheckpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = [
    {"user": "AU06 cheek raiser, AU12 lip corner puller",
     "assistant": "The person shows a genuine smile."},
    {"user": "AU04 brow lowerer", "assistant": "The person appears to frown."},
    {"user": "AU01 inner brow raiser, AU15 lip corner depressor",
     "assistant": "The person looks sad."},
    {"user": "AU05 upper lid raiser, AU26 jaw drop", "assistant": "The person appears surprised."},
    {"user": "AU09 nose wrinkler", "assistant": "The nose wrinkles."},
    {"user": "AU45 blink", "assistant": "The eyes close briefly."},
]


def jax_module(name: str):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return __import__(f"au_agent_finetune.{name}", fromlist=[name])


@pytest.mark.parametrize("max_length", [16, 96, 512])
def test_build_batch_equals_jax(max_length):
    want = jax_module("train_au_agent").build_batch(ByteTokenizer(), RECORDS, max_length)
    got = ttrain.build_batch(TorchByteTokenizer(), RECORDS, max_length)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert (got[1] != -100).any() == (max_length > 200)


def write_mer_factory(root):
    """MER-Factory outputs: per-frame AU values with summaries, a clip-level
    summary, a clip under the threshold, one without au_info."""
    clips = {
        "c1": {"au_info": {"frames": [
            {"au_values": {"AU06_r": 1.5, "AU12_r": 2.0}, "summary_description": "smile"},
            {"aus": {"AU04_r": 0.9}, "summary_description": "frown"},
            {"au_values": {"AU01_r": 0.2}, "summary_description": "weak"}]}},
        "c2": {"au_info": {"au_values": {"AU26_r": 3.0}}, "summary_description": "jaw drop"},
        "c3": {"summary_description": "no AUs"},
        "c4": {"au_info": {"frames": [{"au_values": {"AU15_r": 0.7}}]},
               "summary_description": "fallback summary"},
    }
    for name, data in clips.items():
        (root / name).mkdir(parents=True)
        (root / name / f"{name}_au_analysis.json").write_text(json.dumps(data))


@pytest.mark.parametrize("threshold", ["0.5", "0.1"])
def test_prepare_dataset_writes_jax_json(tmp_path, monkeypatch, threshold):
    write_mer_factory(tmp_path / "mf")
    argv = ["--mer-factory-output", str(tmp_path / "mf"), "--threshold", threshold]
    monkeypatch.setattr(sys, "argv", ["prep", *argv, "--save-path", str(tmp_path / "jax.json")])
    jax_module("prepare_au_instruction_dataset").main()
    tprep.main([*argv, "--save-path", str(tmp_path / "port.json")])
    want = (tmp_path / "jax.json").read_bytes()
    assert (tmp_path / "port.json").read_bytes() == want
    assert len(json.loads(want)) == (5 if threshold == "0.1" else 4)


@functools.lru_cache(maxsize=None)
def _tiny(lora_r: int, seed: int):
    """JAX's tiny bootstrap in f32 and its init_lora: (build_model's result,
    the LoRA)."""
    from affectgpt_tpu.config import Config

    built = jboot.build_model(Config.from_dict(
        {"model": {"llama_model": "tiny", "lora_r": lora_r}}), dtype=jnp.float32)
    lora = jq.init_lora(jax.random.PRNGKey(seed), jq.QwenConfig(
        **{**built[0].llm.__dict__, "lora_r": lora_r}))
    return built, lora


def _to_torch(tree):
    """A fresh copy of a JAX tree as CPU tensors (the port trains in place)."""
    return convert.tree_to_torch(jax.tree.map(np.asarray, tree), "cpu")


def train_pair(tmp_path, monkeypatch, dropout: str, epochs: int = 1):
    """(JAX's losses, the port's result) of one run each on RECORDS, batch 2,
    from the same weights and LoRA."""
    data = tmp_path / "au_sft.json"
    data.write_text(json.dumps(RECORDS))
    argv = ["--data", str(data), "--llama-model", "tiny", "--lora-r", "4", "--lora-alpha", "8",
            "--lora-dropout", dropout, "--epochs", str(epochs), "--batch-size", "2",
            "--max-length", "320", "--seed", "0", "--lr", "3e-3"]
    built, jlora = _tiny(4, 0)
    port_cfg = ttrain.build_model({"llama_model": "tiny", "lora_r": 4}, device="cpu")[0]
    monkeypatch.setattr(jboot, "build_model", lambda *a, **k: built)
    monkeypatch.setattr(jq, "init_lora", lambda *a, **k: jlora)
    losses = []
    ce = jq.cross_entropy_loss

    def recording_ce(logits, labels, *args, **kwargs):
        loss = ce(logits, labels, *args, **kwargs)
        jax.debug.callback(lambda v: losses.append(float(v)), loss)
        return loss

    monkeypatch.setattr(jq, "cross_entropy_loss", recording_ce)
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--output-dir", str(tmp_path / "jax")])
    jax_module("train_au_agent").main()
    jax.effects_barrier()

    monkeypatch.setattr(ttrain, "build_model", lambda *a, **k: (
        port_cfg, _to_torch(built[1]), None, TorchByteTokenizer()))
    monkeypatch.setattr(tq, "init_lora", lambda *a, **k: _to_torch(jlora))
    got = ttrain.main([*argv, "--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    return losses, got


def test_three_steps_equal_jax_losses(tmp_path, monkeypatch):
    want, got = train_pair(tmp_path, monkeypatch, "0")
    assert len(got["losses"]) == len(want) == 3
    np.testing.assert_allclose(got["losses"], want, atol=1e-4, rtol=0)
    assert got["losses"][-1] < got["losses"][0]
    (path,) = got["checkpoints"]
    assert os.path.basename(path) == "checkpoint_000001_loss_nan"
    saved = tcheckpoint.load_checkpoint(path)["trainable"]["lora"]
    for layer, trained in zip(saved["layers"], got["lora"]["layers"]):
        for name, leaf in layer.items():
            assert torch.equal(leaf["a"], trained[name]["a"])
            assert torch.equal(leaf["b"], trained[name]["b"]) and leaf["b"].abs().sum() > 0


def test_dropout_trains_with_step_keys(tmp_path, monkeypatch):
    """Dropout 0.05 (the recipe's): finite losses over two epochs, each
    step's masks keyed by (seed, step), so the first step differs from the
    dropout-free run's by the masks alone."""
    keys = []
    forward = tq.forward

    def recording_forward(*args, **kwargs):
        keys.append(kwargs.get("dropout_rng"))
        return forward(*args, **kwargs)

    monkeypatch.setattr(tq, "forward", recording_forward)
    _, got = train_pair(tmp_path, monkeypatch, "0.05", epochs=2)
    assert keys == [(0, s) for s in range(6)]
    assert np.isfinite(got["losses"]).all() and len(got["checkpoints"]) == 2


def test_trainer_logs_as_jax(tmp_path, monkeypatch, caplog):
    with caplog.at_level(logging.INFO):
        train_pair(tmp_path, monkeypatch, "0")
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith(
        ("loaded", "epoch", "AU agent LoRA saved"))]
    assert [line.split(" under ")[0] for line in lines[len(lines) // 2:]] == \
        [line.split(" under ")[0] for line in lines[: len(lines) // 2]]
    assert len(lines) == 6
