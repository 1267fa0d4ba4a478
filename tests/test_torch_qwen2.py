"""The port's Qwen2 decoder against the JAX one: prefill logits, the KV
cache after prefill, one decode step's logits, and merge_lora, on the same
seeded weights (carried over by convert.tree_to_torch), in f32.

Geometries: QwenConfig.tiny, and a small one the decode kernels accept
(hidden 256, intermediate 512, heads 4, kv 2, head_dim 64, b = 8), at
which the JAX decode step runs both Pallas kernels in interpret mode.
Tolerance 1e-4: the same f32 math, summed in another order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq

GEOMETRIES = {
    "tiny": dict(vocab_size=300, hidden_size=32, intermediate_size=64, num_layers=2,
                 num_heads=4, num_kv_heads=2, head_dim=8, rope_theta=10_000.0,
                 lora_r=2, lora_alpha=4.0),
    "kernel_small": dict(vocab_size=300, hidden_size=256, intermediate_size=512,
                         num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64),
}
B, T, MAX_LEN = 8, 12, 20
TOL = dict(atol=1e-4, rtol=1e-4)
jax_forward = jax.jit(jq.forward, static_argnums=(1,), static_argnames=("last_token_only",))


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _setup(name):
    jcfg = jq.QwenConfig(**GEOMETRIES[name])
    tcfg = tq.QwenConfig(**GEOMETRIES[name])
    params = jq.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    lora = jq.init_lora(jax.random.PRNGKey(1), jcfg)
    # nonzero B so that LoRA changes the outputs
    rng = np.random.RandomState(2)
    lora = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, lora)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return jcfg, tcfg, params, lora, convert.tree_to_torch(np_tree(params), "cpu"), \
        convert.tree_to_torch(np_tree(lora), "cpu")


def _inputs(d, seed=3):
    rng = np.random.RandomState(seed)
    embeds = rng.randn(B, T, d).astype(np.float32) * 0.5
    valid = np.ones((B, T), bool)
    for i in range(B):
        valid[i, : i % 4] = False  # left padding, as generate() packs it
    positions = np.maximum(np.arange(T)[None, :] - (~valid).sum(1)[:, None], 0).astype(np.int32)
    return embeds, valid, positions


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_prefill_logits_with_lora(geometry):
    jcfg, tcfg, params, lora, tparams, tlora = _setup(geometry)
    embeds, valid, _ = _inputs(jcfg.hidden_size)
    want, _ = jax_forward(params, jcfg, jnp.asarray(embeds), jnp.asarray(valid), lora=lora)
    got, cache = tq.forward(tparams, tcfg, torch.from_numpy(embeds), torch.from_numpy(valid),
                            lora=tlora)
    assert cache is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_merge_lora_matches(geometry):
    jcfg, tcfg, params, lora, tparams, tlora = _setup(geometry)
    want = jq.merge_lora(params, lora, jcfg)
    got = tq.merge_lora(tparams, tlora, tcfg)
    for jl, tl in zip(want["layers"], got["layers"]):
        for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
            np.testing.assert_allclose(tl[name]["w"].numpy(), np.asarray(jl[name]["w"]),
                                       atol=1e-6, rtol=1e-6)
    assert got["layers"][0]["input_ln"] is tparams["layers"][0]["input_ln"]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_cached_prefill_and_decode_step(geometry, monkeypatch):
    """Prefill into the cache (cache contents and last-token logits), then one
    decode step with merged LoRA; at kernel_small the JAX step runs both
    Pallas kernels (interpret mode) and the port their plain versions."""
    monkeypatch.setenv("AFFECTGPT_DECODE_KERNEL_INTERPRET", "1")
    jax.clear_caches()  # the switch is read at trace time
    jcfg, tcfg, params, lora, tparams, tlora = _setup(geometry)
    params = jq.merge_lora(params, lora, jcfg)
    tparams = tq.merge_lora(tparams, tlora, tcfg)
    embeds, valid, positions = _inputs(jcfg.hidden_size)
    key_valid = np.pad(valid, ((0, 0), (0, MAX_LEN - T)))
    causal = np.arange(MAX_LEN)[None, None, :] <= np.arange(T)[None, :, None]
    mask = causal & key_valid[:, None, :]

    jcache = jq.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32)
    want, jcache = jax_forward(params, jcfg, jnp.asarray(embeds), jnp.asarray(mask),
                              positions=jnp.asarray(positions), cache=jcache,
                              cache_index=jnp.int32(0), last_token_only=True)
    tcache = tq.init_cache(tcfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    got, tcache = tq.forward(tparams, tcfg, torch.from_numpy(embeds), torch.from_numpy(mask),
                             positions=torch.from_numpy(positions), cache=tcache,
                             cache_index=0, last_token_only=True)
    assert got.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for jc, tc in zip(jcache, tcache):
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)

    rng = np.random.RandomState(4)
    step = rng.randn(B, 1, jcfg.hidden_size).astype(np.float32) * 0.5
    step_mask = ((np.arange(MAX_LEN)[None, :] <= T) & np.pad(valid, ((0, 0), (0, MAX_LEN - T)),
                                                           constant_values=True))[:, None, :]
    step_pos = valid.sum(1).astype(np.int32)[:, None]
    want, jcache = jax_forward(params, jcfg, jnp.asarray(step), jnp.asarray(step_mask),
                              positions=jnp.asarray(step_pos), cache=jcache,
                              cache_index=jnp.int32(T))
    got, tcache = tq.forward(tparams, tcfg, torch.from_numpy(step), torch.from_numpy(step_mask),
                             positions=torch.from_numpy(step_pos), cache=tcache, cache_index=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for jc, tc in zip(jcache, tcache):
        np.testing.assert_allclose(tc["k"][:, :, T].numpy(), np.asarray(jc["k"][:, :, T]), **TOL)
