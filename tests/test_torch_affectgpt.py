"""The port's mergers, pre-fusion, splice and build_inputs_embeds against
the JAX package, on the same seeded weights and features, in f32
(tolerance 1e-5: the same f32 math, summed in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import mergers as jm
from affectgpt_tpu.models import splice as js
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import mergers as tm
from affectgpt_tpu_torch.models import splice as ts

TOL = dict(atol=1e-5, rtol=1e-5)
B = 3


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _model():
    jcfg = ja.AffectGPTConfig.tiny()
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    # scale the merger weights up so that their outputs are O(1)
    trainable = jax.tree.map(lambda x: x * 25.0, trainable)
    tcfg = ta.AffectGPTConfig.tiny()
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg)
    return jcfg, frozen, trainable, tcfg, tfrozen, ttrain


def _features(cfg, t=8, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "frame": rng.randn(B, t, cfg.visual_dim).astype(np.float32),
        "face": rng.randn(B, t, cfg.visual_dim).astype(np.float32),
        "audio": rng.randn(B, t, cfg.acoustic_dim).astype(np.float32),
    }


@pytest.mark.parametrize("fusion,t", [("attention", 8), ("attention", 1), ("mean", 8)])
def test_apply_merger(fusion, t):
    rng = np.random.RandomState(5)
    jcfg_m = jm.MergerConfig(fusion, 12, 32, 4, 32)
    tcfg_m = tm.MergerConfig(fusion, 12, 32, 4, 32)
    params = jax.tree.map(lambda x: x * 25.0, jm.init_merger(jax.random.PRNGKey(3), jcfg_m))
    feats = rng.randn(B, t, 12).astype(np.float32)
    want = jm.apply_merger(params, jcfg_m, jnp.asarray(feats))
    got = tm.apply_merger(convert.tree_to_torch(jax.tree.map(np.asarray, params)), tcfg_m,
                          torch.from_numpy(feats))
    assert tuple(got.shape) == (B, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_multi_fusion():
    jcfg, _, trainable, tcfg, _, ttrain = _model()
    f = _features(jcfg)
    want = jm.apply_multi_fusion(trainable["multi"], jcfg.multi_config(),
                                 jnp.asarray(f["face"]), jnp.asarray(f["audio"]))
    got = tm.apply_multi_fusion(ttrain["multi"], tcfg.multi_config(),
                                torch.from_numpy(f["face"]), torch.from_numpy(f["audio"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_splice_embeddings_with_absent_row():
    rng = np.random.RandomState(6)
    embeds = rng.randn(B, 10, 4).astype(np.float32)
    block = rng.randn(B, 3, 4).astype(np.float32)
    offsets = np.array([2, -1, 7], np.int32)
    want = js.splice_embeddings(jnp.asarray(embeds), jnp.asarray(block), jnp.asarray(offsets))
    got = ts.splice_embeddings(torch.from_numpy(embeds), torch.from_numpy(block),
                               torch.from_numpy(offsets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), embeds[1])  # -1 leaves the row alone
    ids = np.array([5, 9, 9, 9, 1])
    assert ts.find_patch_run(ids, 9, 3) == js.find_patch_run(ids, 9, 3) == 1
    with pytest.raises(ValueError):
        ts.find_patch_run(ids, 9, 2)


def test_build_inputs_embeds():
    jcfg, frozen, trainable, tcfg, tfrozen, ttrain = _model()
    f = _features(jcfg, seed=1)
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 256, size=(B, 16)).astype(np.int32)
    offsets = {
        "frame": np.array([2, -1, 4], np.int32),
        "face": np.array([5, 3, -1], np.int32),
        "audio": np.array([8, 6, 8], np.int32),
        "multi": np.array([0, 0, 1], np.int32),
    }
    want = ja.build_inputs_embeds(frozen, trainable, jcfg, jnp.asarray(ids),
                                  {m: jnp.asarray(v) for m, v in f.items()},
                                  {m: jnp.asarray(v) for m, v in offsets.items()})
    got = ta.build_inputs_embeds(tfrozen, ttrain, tcfg, torch.from_numpy(ids).long(),
                                 {m: torch.from_numpy(v) for m, v in f.items()},
                                 {m: torch.from_numpy(v).long() for m, v in offsets.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_nn_primitives_match_jax(dtype):
    """dense, dense_nobias, rmsnorm, layernorm (f32 statistics) and embedding,
    on weights carried over by convert.tree_to_torch (bf16 leaves included)."""
    from affectgpt_tpu.models import nn as jnn
    from affectgpt_tpu_torch.models import nn as tnn

    rng = np.random.RandomState(8)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {
        "dense": jnn.dense_init(jax.random.PRNGKey(0), 24, 16, dtype=jdt),
        "ln": {"scale": jnp.asarray(1 + 0.1 * rng.randn(24), jdt),
               "bias": jnp.asarray(0.1 * rng.randn(24), jdt)},
        "emb": jnn.embedding_init(jax.random.PRNGKey(1), 10, 24, dtype=jdt),
    }
    params["dense"]["b"] = jnp.asarray(rng.randn(16), jdt)
    tparams = convert.tree_to_torch(jax.tree.map(np.asarray, params))
    x = rng.randn(3, 5, 24).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), convert.tree_to_torch(np.asarray(jnp.asarray(x, jdt)))
    ids = np.array([[1, 9, 0]])
    pairs = [
        (jnn.dense(params["dense"], jx), tnn.dense(tparams["dense"], tx)),
        (jnn.dense_nobias(params["dense"], jx), tnn.dense_nobias(tparams["dense"], tx)),
        (jnn.rmsnorm(params["ln"], jx), tnn.rmsnorm(tparams["ln"], tx)),
        (jnn.layernorm(params["ln"], jx), tnn.layernorm(tparams["ln"], tx)),
        (jnn.embedding(params["emb"], jnp.asarray(ids)),
         tnn.embedding(tparams["emb"], torch.from_numpy(ids))),
    ]
    # f32: the same math in another summation order; bf16: one rounding step
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == np.float32 else dict(atol=1.6e-2, rtol=1.6e-2)
    for want, got in pairs:
        assert str(got.dtype).endswith(str(want.dtype))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
