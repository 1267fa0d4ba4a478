"""The port's checkpoints: save/load round trip, the non-strict overlay and
the legacy merger migration against JAX's on the same numpy trees, and
`bootstrap.build_model` applying `ckpt` / `ckpt_2` / `ckpt_3`."""

import copy
import logging
import os

import numpy as np
import pytest
import torch

from affectgpt_tpu.training import checkpoint as jck
from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.training import checkpoint as tck
from affectgpt_tpu_torch.training import optim


def np_tree(seed: int):
    rng = np.random.RandomState(seed)
    return {
        "lora": {"layers": [{"q_proj": {"a": rng.randn(4, 2), "b": rng.randn(2, 4)}}
                            for _ in range(2)]},
        "mergers": {"video": {"proj": {"w": rng.randn(3, 4), "b": rng.randn(4)}},
                    "audio": {"proj": {"w": rng.randn(3, 4), "b": rng.randn(4)}}},
    }


def assert_trees_equal(a, b):
    la, lb = optim.tree_leaves(a), optim.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_save_load_round_trip(tmp_path):
    trainable = optim.tree_map(torch.from_numpy, np_tree(0))
    opt_state = {"count": 3, "mini_step": 1, "mu": [torch.ones(2)], "nu": [torch.zeros(2)],
                 "acc": None}
    path = tck.save_checkpoint(str(tmp_path), epoch=2, trainable=trainable, opt_state=opt_state,
                               step=40, loss=1.23456, config={"run": {"lr": 1e-4}},
                               best_val=0.5)
    assert os.path.basename(path) == "checkpoint_000002_loss_1.2346"
    payload = tck.load_checkpoint(path)
    assert payload["epoch"] == 2 and payload["step"] == 40  # epochs completed
    assert payload["best_val"] == 0.5 and payload["loss"] == pytest.approx(1.23456)
    assert payload["config"] == {"run": {"lr": 1e-4}}
    assert payload["opt_state"]["count"] == 3 and payload["opt_state"]["acc"] is None
    assert_trees_equal(payload["trainable"], trainable)
    # an infinite best_val (no validation yet) is not written; a re-save overwrites
    path2 = tck.save_checkpoint(str(tmp_path), epoch=2, trainable=trainable, loss=1.23456,
                                best_val=float("inf"))
    assert path2 == path and "best_val" not in tck.load_checkpoint(path)
    assert tck.list_checkpoints(str(tmp_path)) == [(2, path)]


def test_list_and_discover(tmp_path):
    trainable = optim.tree_map(torch.from_numpy, np_tree(0))
    for run, epochs in (("a", (0,)), ("b", (0, 1, 2)), ("c", ())):
        os.makedirs(tmp_path / run, exist_ok=True)
        for e in epochs:
            tck.save_checkpoint(str(tmp_path / run), epoch=e, trainable=trainable)
    assert [e for e, _ in tck.list_checkpoints(str(tmp_path / "b"))] == [0, 1, 2]
    assert tck.discover_checkpoint_root(str(tmp_path)) == str(tmp_path / "b")
    assert jck.discover_checkpoint_root(str(tmp_path / "c")) is None
    assert tck.discover_checkpoint_root(str(tmp_path / "c")) is None


@pytest.mark.parametrize("update", [
    lambda t: {"mergers": {"video": {"proj": {"w": t["mergers"]["video"]["proj"]["w"] * 2}}}},
    lambda t: {"lora": {"layers": [{"q_proj": {"a": np.zeros((4, 2))}}, {}]}},
    lambda t: {"mergers": {"image": {"proj": {"w": np.ones((3, 4))}}}, "extra": {"x": np.ones(1)}},
    lambda t: {"lora": {"layers": [{}]}},  # a list of another length replaces the base's
], ids=["leaf", "list", "unknown_keys", "short_list"])
def test_overlay_matches_jax(update):
    base = np_tree(1)
    upd = update(np_tree(2))
    unknown_j, unknown_t = [], []
    want = jck._overlay(copy.deepcopy(base), copy.deepcopy(upd), _unknown=unknown_j)
    got = tck._overlay(copy.deepcopy(base), copy.deepcopy(upd), _unknown=unknown_t)
    assert unknown_t == unknown_j
    assert_trees_equal(got, want)


@pytest.mark.parametrize("mergers", [
    {"frame": 1, "face": 2, "audio": 3},
    {"face": 2, "audio": 3},  # face-only legacy run: face migrates to video
    {"frame": 1, "video": 9},
    {"video": 9, "audio": 3},  # already group-keyed: untouched
])
def test_migrate_legacy_mergers_matches_jax(mergers):
    update = {"mergers": dict(mergers), "lora": 0}
    assert tck._migrate_legacy_mergers(dict(update)) == jck._migrate_legacy_mergers(dict(update))
    assert tck._migrate_legacy_mergers({"lora": 0}) == {"lora": 0}


def test_bootstrap_applies_overlays_in_order(tmp_path, caplog):
    node = {"keep_full_llm": False}
    cfg, _, trainable, _ = bootstrap.build_model(node, device="cpu")
    w = trainable["mergers"]["video"]["proj"]["w"]
    first = {"mergers": {"video": {"proj": {"w": torch.full_like(w, 1.0)}},
                         "audio": {"proj": {"w": torch.full_like(
                             trainable["mergers"]["audio"]["proj"]["w"], 3.0)}}}}
    second = {"mergers": {"frame": {"proj": {"w": torch.full_like(w, 2.0)}}},  # legacy keys
              "stale": {"x": torch.ones(1)}}
    os.makedirs(tmp_path / "one")
    os.makedirs(tmp_path / "two")
    p1 = tck.save_checkpoint(str(tmp_path / "one"), 0, first)
    p2 = tck.save_checkpoint(str(tmp_path / "two"), 0, second)
    with caplog.at_level(logging.WARNING):
        _, _, got, _ = bootstrap.build_model({**node, "ckpt": p1, "ckpt_2": p2}, device="cpu")
    assert torch.equal(got["mergers"]["video"]["proj"]["w"], torch.full_like(w, 2.0))
    assert float(got["mergers"]["audio"]["proj"]["w"].mean()) == 3.0
    assert torch.equal(got["mergers"]["video"]["proj"]["b"], trainable["mergers"]["video"]["proj"]["b"])
    assert "stale" in got and "legacy modality-keyed mergers" in caplog.text
    assert "absent from the live trainable tree" in caplog.text
