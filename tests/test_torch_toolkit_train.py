"""The port's fusion trainer (`toolkit/train.py`) and metrics
(`toolkit/metrics.py`) against the JAX package's, in f32 on the CPU:
`train_fusion_model` for 2 epochs with and without `grad_clip`, the
cross-corpus and cross-dimension protocols: the loss history and
`evaluate_fusion_model`'s metrics within 1e-4 of JAX's from the same
initial parameters (JAX's init is given the port's draws); the Adam chain
against optax over 3 steps; the metrics against JAX's sklearn-based ones
to 1e-12; `load_feature_table` over npy directories and both npz packs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from affectgpt_tpu.toolkit import metrics as jmetrics
from affectgpt_tpu.toolkit import train as jtrain
from affectgpt_tpu_torch.toolkit import metrics, train
from affectgpt_tpu_torch.toolkit.models import FUSION_MODELS, FusionArgs
from affectgpt_tpu_torch.training import optim

TOL = dict(rtol=1e-4, atol=1e-4)


def make_tables(n=48, seed=0):
    """The JAX trainer test's synthetic table: the label signal in the audio
    stream."""
    rng = np.random.RandomState(seed)
    args = FusionArgs.tiny()
    emos = rng.randint(0, args.output_dim1, n)
    audios = rng.randn(n, args.audio_dim).astype(np.float32)
    audios[:, 0] = emos * 1.0
    vals = (emos - args.output_dim1 / 2).astype(np.float32) / args.output_dim1
    return train.FeatureTable(
        names=[f"s{i}" for i in range(n)], audios=audios,
        texts=rng.randn(n, args.text_dim).astype(np.float32),
        videos=rng.randn(n, args.video_dim).astype(np.float32), emos=emos, vals=vals)


def jax_table(t: train.FeatureTable) -> jtrain.FeatureTable:
    return jtrain.FeatureTable(**dataclasses.asdict(t))


def start_params(name: str, args: FusionArgs, seed: int = 3):
    """A port draw of the model's tree, as numpy (JAX's form) and tensors."""
    params = FUSION_MODELS[name].init(torch.Generator().manual_seed(seed), args)
    return optim.tree_map(lambda x: x.numpy().copy(), params), params


def seed_inits(monkeypatch, name: str, tree, params):
    """Both trainers start from the same draw: JAX's from `tree`, the
    port's from `params`, in place of their own."""
    for table, start in ((jtrain.FUSION_MODELS, lambda: optim.tree_map(jnp.asarray, tree)),
                         (train.FUSION_MODELS, lambda: params)):
        original = table[name]
        seeded = type("Seeded", (), {"apply": staticmethod(original.apply),
                                     "init": staticmethod(lambda _g, _a, _s=start: _s())})
        monkeypatch.setitem(table, name, seeded)


def assert_records_close(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], err_msg=key, **TOL)


@pytest.mark.parametrize("name,clip", [("attention", -1.0), ("attention", 0.05),
                                       ("mmim", 0.5)])
def test_train_fusion_model_matches_jax(monkeypatch, name, clip):
    args = dataclasses.replace(FusionArgs.tiny(), grad_clip=clip)
    table = make_tables()
    seed_inits(monkeypatch, name, *start_params(name, args))
    jparams, jhistory = jtrain.train_fusion_model(
        name, args, jax_table(table), test=jax_table(table), epochs=2, batch_size=16, lr=5e-3)
    got, history = train.train_fusion_model(name, args, table, test=table, epochs=2,
                                            batch_size=16, lr=5e-3, device="cpu")
    assert_records_close(history, jhistory)
    assert_records_close([train.evaluate_fusion_model(name, args, got, table)],
                         [jtrain.evaluate_fusion_model(name, args, jparams, jax_table(table))])
    assert all(not leaf.requires_grad for leaf in optim.tree_leaves(got))


@pytest.mark.parametrize("protocol", ["cross_corpus", "cross_dimension"])
def test_cross_protocols_match_jax(monkeypatch, protocol):
    """Train on a source table, evaluate on a target one; cross-dimension is
    the valence-only form (emos=None)."""
    name = "lf_dnn" if protocol == "cross_corpus" else "attention"
    args = FusionArgs.tiny()
    source, target = make_tables(n=32, seed=1), make_tables(n=24, seed=8)
    if protocol == "cross_dimension":
        source.emos = target.emos = None
    seed_inits(monkeypatch, name, *start_params(name, args))
    _, jhistory, jmetrics_ = jtrain.train_cross_corpus(
        name, args, jax_table(source), jax_table(target), epochs=2, batch_size=16, lr=5e-3)
    _, history, got = train.train_cross_corpus(name, args, source, target, epochs=2,
                                               batch_size=16, lr=5e-3, device="cpu")
    assert_records_close(history, jhistory)
    assert_records_close([got], [jmetrics_])
    assert ("emo_accuracy" in got) == (protocol == "cross_corpus") and "val_mse" in got


def test_train_draws_its_params_and_learns():
    """The trainer draws the tree from `seed` on `device`, the same tree for
    the same seed; the synthetic signal is learned."""
    args, table = FusionArgs.tiny(), make_tables(n=64)
    params, history = train.train_fusion_model("attention", args, table, epochs=12,
                                               batch_size=16, lr=5e-3, device="cpu")
    assert history[-1]["train_loss"] < history[0]["train_loss"]
    assert train.evaluate_fusion_model("attention", args, params, table)["emo_accuracy"] > 0.5
    _, again = train.train_fusion_model("attention", args, table, epochs=1, batch_size=16,
                                        lr=5e-3, device="cpu")
    assert again[0]["train_loss"] == history[0]["train_loss"]  # the same draw
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            train.train_fusion_model("attention", args, table, epochs=1)


@pytest.mark.parametrize("clip", [-1.0, 0.3])
def test_adam_chain_matches_optax(clip):
    """make_optimizer = optax adam(lr) (after clip_by_global_norm when
    grad_clip > 0), step by step over 3 steps, within a few f32 ulps of the
    parameters (optax takes the bias corrections' powers in f32, the port in
    f64)."""
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(5, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
            "layers": [{"k": rng.randn(2, 2).astype(np.float32)}]}
    grads = [optim.tree_map(lambda x: rng.randn(*x.shape).astype(np.float32), tree)
             for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-2)) if clip > 0 \
        else optax.adam(1e-2)
    jp = optim.tree_map(jnp.asarray, tree)
    state = tx.init(jp)
    params = optim.tree_map(lambda x: torch.from_numpy(x.copy()), tree)
    port = train.make_optimizer(dataclasses.replace(FusionArgs.tiny(), grad_clip=clip), 1e-2)
    pstate = port.init(params)
    for g in grads:
        updates, state = tx.update(optim.tree_map(jnp.asarray, g), state)
        jp = optax.apply_updates(jp, updates)
        pstate = port.apply(optim.tree_map(torch.from_numpy, g), pstate, params)
        for got, want in zip(optim.tree_leaves(params), optim.tree_leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_sklearn(seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 6, 50)
    logits = rng.randn(50, 6)
    logits[:, 5] -= 10.0 * seed  # a class never predicted
    want = jmetrics.emotion_metrics(labels, logits)
    got = metrics.emotion_metrics(labels, logits)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=1e-12)
    vals, preds = rng.randn(50), rng.randn(50, 1)
    for v, p in ((vals, preds), (np.ones(50), preds), (vals, np.zeros((50, 1)))):
        assert metrics.valence_metrics(v, p) == jmetrics.valence_metrics(v, p)
    assert metrics.combined_metric(0.7, 0.4) == jmetrics.combined_metric(0.7, 0.4) == 0.6


def test_load_feature_table_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    names = ["c1", "c2", "c3"]
    (tmp_path / "audio_feat").mkdir()
    for n in names:  # frame-level → mean-pooled
        np.save(tmp_path / "audio_feat" / f"{n}.npy", rng.randn(5, 10).astype(np.float32))
    np.savez(tmp_path / "text.npz", **{n: rng.randn(12).astype(np.float32) for n in names})
    np.savez(tmp_path / "video.npz", name=np.array(names),
             feature=rng.randn(3, 8).astype(np.float32))
    kw = dict(name2emo={n: i % 2 for i, n in enumerate(names)},
              name2val={n: 0.5 * i for i, n in enumerate(names)})
    got = train.load_feature_table(str(tmp_path), "audio_feat", "text.npz", "video.npz", **kw)
    want = jtrain.load_feature_table(str(tmp_path), "audio_feat", "text.npz", "video.npz", **kw)
    assert got.names == want.names == names and got.audios.shape == (3, 10)
    for key in ("audios", "texts", "videos", "emos", "vals"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    with pytest.raises(FileNotFoundError):
        train.load_feature_table(str(tmp_path), "absent", "text.npz", "video.npz")
