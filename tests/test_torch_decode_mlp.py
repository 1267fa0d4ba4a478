"""The int8 decode MLP of the port against the JAX package, in f32 on the CPU.

- `ops.decode_mlp` (its plain version, which the wrapper takes for CPU
  tensors) against JAX's `decode_mlp_pallas` in interpret mode on a layer of
  hidden 256 / intermediate 1024, with per-channel int8 weights made by each
  side's own `quantize_per_channel` from the same numpy weights.
- The `qwen2.DECODE_MLP` switch: which kernel each switch value and layout
  reaches over one `generate`, and greedy `generate` on an int8 split tree
  with DECODE_MLP="pallas", where JAX runs its kernel in interpret mode
  (8 rows and intermediate % 512 == 0, so that its gates let it in)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affectgpt_tpu.ops.decode_mlp_pallas as jax_mlp_mod
from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.ops import quant as jquant
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import quant
from affectgpt_tpu_torch.ops.decode_mlp import decode_mlp

H, INTER = 256, 1024
# Both sides round xn and silu(g)·u to bf16 and differ only in the order of
# their f32 sums; where a sum lies within an ulp of a bf16 rounding boundary
# one a value rounds the other way, which moves an output by one bf16 ulp of
# that value times one down weight, across the row (seed 2: one flip, 8.5e-5
# at most; the other seeds agree within 5e-7, the f32 summation order).
FLIP_TOL = dict(atol=5e-4, rtol=0)


def _layer(seed, b):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, H).astype(np.float32)
    ln = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    ws = [rng.randn(k, n).astype(np.float32) * k ** -0.5
          for k, n in ((H, INTER), (H, INTER), (INTER, H))]
    return x, ln, ws


@pytest.mark.parametrize("seed,b", [(0, 8), (1, 16), (2, 8), (3, 24)])
def test_decode_mlp_plain_matches_pallas(seed, b):
    x, ln, ws = _layer(seed, b)
    jleaves = [jquant.quantize_per_channel(jnp.asarray(w)) for w in ws]
    tleaves = [quant.quantize_per_channel(torch.from_numpy(w)) for w in ws]
    for (jw, js), (tw, ts) in zip(jleaves, tleaves):  # the formats are the same bytes
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = jax_mlp_mod.decode_mlp_pallas(
        jnp.asarray(x), jnp.asarray(ln), *[a for leaf in jleaves for a in leaf],
        interpret=True, block_i=512)
    before = decode_mlp.launches
    got = decode_mlp(torch.from_numpy(x), torch.from_numpy(ln),
                     *[a for leaf in tleaves for a in leaf])
    assert decode_mlp.launches == before and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLIP_TOL)


LLM = dict(vocab_size=300, hidden_size=128, intermediate_size=512, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=32)
B, T_PAD, MAX_LEN, NEW = 8, 12, 20, 6
LENGTHS = np.array([12, 9, 7, 12, 5, 10, 11, 8], np.int32)


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _trees():
    jcfg, tcfg = jq.QwenConfig(**LLM), tq.QwenConfig(**LLM)
    params = jq.init_params(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    tparams = convert.tree_to_torch(jax.tree.map(np.asarray, params), "cpu")
    return jcfg, tcfg, params, tparams, jq.quantize_params(params, bits=8), \
        tq.quantize_params(tparams, bits=8)


def _embeds():
    return np.random.RandomState(5).randn(B, T_PAD, LLM["hidden_size"]).astype(np.float32)


def _spy(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        def wrapped(*args, _inner=getattr(tq, name), _name=name, **kwargs):
            calls[_name] += 1
            return _inner(*args, **kwargs)

        monkeypatch.setattr(tq, name, wrapped)
    return calls


@pytest.mark.parametrize("switch,tree,expect", [
    ("auto", "bf16", {"decode_mlp_bf16": 2 * NEW, "decode_mlp": 0}),
    ("auto", "int8", {"decode_mlp_bf16": 0, "decode_mlp": 0}),
    ("pallas", "bf16", {"decode_mlp_bf16": 2 * NEW, "decode_mlp": 0}),
    ("pallas", "int8", {"decode_mlp_bf16": 0, "decode_mlp": 2 * NEW}),
    ("xla", "bf16", {"decode_mlp_bf16": 0, "decode_mlp": 0}),
    ("xla", "int8", {"decode_mlp_bf16": 0, "decode_mlp": 0}),
])
def test_decode_mlp_switch_routes(switch, tree, expect, monkeypatch):
    """One MLP kernel call per layer and decode step where the switch and
    the layout allow it (JAX qwen2.py:619-678), none on the prefill."""
    monkeypatch.setattr(tq, "DECODE_MLP", switch)
    calls = _spy(monkeypatch, tuple(expect))
    _, tcfg, _, tparams, _, tq8 = _trees()
    tgen.generate(tq8 if tree == "int8" else tparams, tcfg,
                  tgen.GenerateConfig(max_new_tokens=NEW, do_sample=False),
                  torch.from_numpy(_embeds()), torch.from_numpy(LENGTHS), None, max_len=MAX_LEN)
    assert calls == expect


def test_int8_tree_generate_with_the_kernel_matches_jax(monkeypatch):
    """DECODE_MLP="pallas" on the int8 split tree: JAX runs decode_mlp_pallas
    in interpret mode at every decode step, the port its plain version;
    greedy tokens and num_valid identical."""
    monkeypatch.setenv("AFFECTGPT_DECODE_KERNEL_INTERPRET", "1")
    monkeypatch.setattr(jq, "DECODE_MLP", "pallas")
    monkeypatch.setattr(tq, "DECODE_MLP", "pallas")
    jax.clear_caches()  # the switches are read at trace time
    reached = []
    inner = jax_mlp_mod.decode_mlp_pallas
    monkeypatch.setattr(jax_mlp_mod, "decode_mlp_pallas",
                        lambda *a, **k: reached.append(1) or inner(*a, **k))
    jcfg, tcfg, _, _, jq8, tq8 = _trees()
    gk = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=LLM["vocab_size"] - 1)
    try:
        jtok, jnv = jgen.generate(jq8, jcfg, jgen.GenerateConfig(**gk), jnp.asarray(_embeds()),
                                  jnp.asarray(LENGTHS), jax.random.PRNGKey(0), max_len=MAX_LEN)
        jtok, jnv = np.asarray(jtok), np.asarray(jnv)
    finally:
        jax.clear_caches()
    assert reached, "the JAX int8 decode-MLP kernel must engage"
    calls = _spy(monkeypatch, ("decode_mlp",))
    ttok, tnv = tgen.generate(tq8, tcfg, tgen.GenerateConfig(**gk), torch.from_numpy(_embeds()),
                              torch.from_numpy(LENGTHS), None, max_len=MAX_LEN)
    assert calls["decode_mlp"] == 2 * NEW
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_array_equal(tnv.numpy(), jnv)
