"""The 13 MERBench fusion baselines of the port (`toolkit/models.py`) against
the JAX package's, in f32 on the CPU at `FusionArgs.tiny()`: from parameters
in JAX's tree (drawn with numpy) carried across by `convert.tree_to_torch`, the 4-tuple and the
gradient of every leaf within 1e-5, utterance-level and frame-level inputs
as JAX's tests split them (plus the LSTM-encoder attention model, the
5-stream Attention_TOPN and a frame-level MULT). Dropout is off for parity;
the port's masks are held to their keep rate, scaling and determinism per
key."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu import registry as jregistry
from affectgpt_tpu.toolkit import models as jmodels
from affectgpt_tpu_torch import registry
from affectgpt_tpu_torch.models import convert, nn
from affectgpt_tpu_torch.toolkit import models
from affectgpt_tpu_torch.training import optim

ARGS = models.FusionArgs.tiny()
TOL = dict(rtol=1e-5, atol=1e-5)
FRAME_MODELS = ("ef_lstm", "mfn", "graph_mfn", "mctn")
# (name, model, args replacements, frame-level input)
CASES = ([(n, n, {}, n in FRAME_MODELS) for n in sorted(models.FUSION_MODELS)]
         + [("attention_frm_align", "attention", {"feat_type": "frm_align"}, True),
            ("attention_topn_5", "attention_topn", {"feat_dims": (10, 12, 8, 6, 14)}, False),
            ("mult_frames", "mult", {}, True)])


def make_batch(args, b=4, frame=False, t=5, seed=0):
    rng = np.random.RandomState(seed)
    if args.feat_dims:
        return {f"feat{i}": rng.randn(b, d).astype(np.float32)
                for i, d in enumerate(args.feat_dims)}
    shape = (lambda d: (b, t, d)) if frame else (lambda d: (b, d))
    return {"audios": rng.randn(*shape(args.audio_dim)).astype(np.float32),
            "texts": rng.randn(*shape(args.text_dim)).astype(np.float32),
            "videos": rng.randn(*shape(args.video_dim)).astype(np.float32)}


def jax_tree(name, jargs):
    """The shapes and dtypes of JAX's model.init tree (traced, not drawn)."""
    return jax.eval_shape(lambda key: jmodels.FUSION_MODELS[name].init(key, jargs),
                          jax.random.PRNGKey(0))


def jax_init(name, jargs, seed=0):
    """Parameters in JAX's tree drawn with numpy (JAX's own eager draws take
    seconds a model): N(0, 0.1²) leaves, layer-norm scales around 1."""
    rng = np.random.RandomState(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(jax_tree(name, jargs))
    leaves = []
    for path, leaf in paths:
        x = rng.randn(*leaf.shape).astype(np.float32) * 0.1
        leaves.append(x + 1.0 if path[-1] == jax.tree_util.DictKey("scale") else x)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _weights(out_shapes, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in out_shapes]


def test_fusion_args_match_jax():
    assert [f.name for f in dataclasses.fields(models.FusionArgs)] == \
        [f.name for f in dataclasses.fields(jmodels.FusionArgs)]
    for preset, want in ((models.FusionArgs(), jmodels.FusionArgs()),
                         (models.FusionArgs.tiny(), jmodels.FusionArgs.tiny())):
        assert dataclasses.asdict(preset) == dataclasses.asdict(want)
    assert list(models.FUSION_MODELS) == list(jmodels.FUSION_MODELS)


def test_registered_under_the_jax_names():
    names = [n for n in jregistry.names("model") if n.startswith("toolkit_")]
    assert len(names) == 13 and registry.names("model") == names
    for key, cls in models.FUSION_MODELS.items():
        assert registry.get("model", f"toolkit_{key}") is cls


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_model_matches_jax(case):
    """Forward 4-tuple and every leaf's gradient of a weighted sum of all
    four outputs, from the same parameters."""
    _, name, extra, frame = case
    args = dataclasses.replace(ARGS, **extra)
    jargs = dataclasses.replace(jmodels.FusionArgs.tiny(), **extra)
    jparams = jax_init(name, jargs)
    batch = make_batch(args, frame=frame)

    jbatch = jax.tree.map(jnp.asarray, batch)
    apply = lambda p: jmodels.FUSION_MODELS[name].apply(p, jargs, jbatch)  # noqa: E731
    w = _weights([o.shape for o in jax.eval_shape(apply, jparams)[:3]])

    def jloss(p):
        out = apply(p)
        return sum(jnp.sum(o * wi) for o, wi in zip(out[:3], w)) + out[3], out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)

    params = convert.tree_to_torch(jparams, "cpu")
    leaves = optim.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = models.FUSION_MODELS[name].apply(params, args, tbatch)
    assert len(out) == 4 and out[1].shape == (4, args.output_dim1)
    assert out[2].shape == (4, args.output_dim2) and out[3].shape == ()
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    loss = sum((o * torch.from_numpy(wi)).sum() for o, wi in zip(out[:3], w)) + out[3]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(leaves)
    for path, got, want in zip(optim.tree_paths(params), grads, jleaves):
        got = np.zeros(want.shape, np.float32) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), err_msg=path, **TOL)


def test_init_has_the_jax_tree():
    """model.init draws JAX's tree (keys, shapes, f32) from a generator."""
    for name, cls in models.FUSION_MODELS.items():
        want = jax.tree_util.tree_flatten_with_path(jax_tree(name, jmodels.FusionArgs.tiny()))[0]
        got = jax.tree_util.tree_flatten_with_path(
            cls.init(torch.Generator().manual_seed(0), ARGS))[0]
        assert [(p, x.shape, str(x.dtype)) for p, x in want] == \
            [(p, tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in got], name
    with pytest.raises(AssertionError):
        models.AttentionTopN.init(torch.Generator().manual_seed(0),
                                  dataclasses.replace(ARGS, feat_dims=(4,) * 19))


@pytest.mark.parametrize("case", CASES[:13], ids=lambda c: c[0])
def test_train_rng_dropout(case):
    """With dropout > 0 a train_rng changes the outputs, the same key gives
    the same outputs and another key others; with dropout 0 (or no key) the
    outputs are the eval-mode ones."""
    _, name, _, frame = case
    model = models.FUSION_MODELS[name]
    params = model.init(torch.Generator().manual_seed(0), ARGS)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(ARGS, frame=frame).items()}
    drop = dataclasses.replace(ARGS, dropout=0.3)
    eval_out = model.apply(params, ARGS, batch)[1]
    assert torch.equal(model.apply(params, drop, batch)[1], eval_out)
    assert torch.equal(model.apply(params, ARGS, batch, train_rng=(7, 0))[1], eval_out)
    a = model.apply(params, drop, batch, train_rng=(7, 0))[1]
    assert not torch.equal(a, eval_out)
    assert torch.equal(model.apply(params, drop, batch, train_rng=(7, 0))[1], a)
    assert not torch.equal(model.apply(params, drop, batch, train_rng=(7, 1))[1], a)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_site_keep_rate_and_scale(rate):
    """A site's mask keeps 1 - rate of the values, scales the survivors by
    1 / (1 - rate), and is a function of its key; sites differ."""
    x = torch.ones(200, 500)
    y = models._drop(models._site((3, 1), 0), rate, x)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    assert torch.all(y[kept] == x[kept] / nn.keep_scale(rate, x.dtype))
    assert torch.equal(models._drop(models._site((3, 1), 0), rate, x), y)
    assert not torch.equal(models._drop(models._site((3, 1), 1), rate, x), y)
    assert models._drop(None, rate, x) is x and models._drop((1,), 0.0, x) is x
    assert models._dr(None, ARGS, 1) is None
    assert models._dr((2,), dataclasses.replace(ARGS, dropout=rate), 1) == ((2, 1), rate)
