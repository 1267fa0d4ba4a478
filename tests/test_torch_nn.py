"""Two faults of the port's decoder building blocks, held on the CPU.

- `nn.matmul_f32` keeps the f32 sum of a 16-bit product, as JAX's
  `preferred_element_type=f32` does: `nn.dense` and `nn.dense_nobias` on
  bf16 inputs equal bf16(f32(x) @ f32(w) + f32(b)), rounded once, and the
  logits (`qwen2._logits`, dense and tied lm_head) equal the f32 product
  itself. A product rounded to bf16 before the bias or the upcast parts
  from these on some elements.
- `qwen2.DECODE_QKV` (JAX qwen2.py:497): "xla" takes the per-projection
  route, so `ops.decode_qkv` is never called, and greedy tokens and the
  decode-step logits match the JAX package run with the same switch, in
  f32 (tolerance 1e-4, as the port's other f32 parity tests: the same math
  summed in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import convert, nn
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv

BF = torch.bfloat16


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(BF)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_rounds_the_f32_sum_once(seed):
    rng = np.random.RandomState(seed)
    x, w, b = _bf16(rng, 3, 7, 256), _bf16(rng, 256, 384, scale=0.06), _bf16(rng, 384)
    want = (x.float() @ w.float() + b.float()).to(BF)
    got = nn.dense({"w": w, "b": b}, x)
    assert got.dtype == BF and got.shape == (3, 7, 384)
    assert torch.equal(got, want)
    assert torch.equal(nn.dense_nobias({"w": w}, x), (x.float() @ w.float()).to(BF))


@pytest.mark.parametrize("tied", [False, True])
def test_logits_are_the_f32_product(tied):
    rng = np.random.RandomState(3)
    cfg = tq.QwenConfig(vocab_size=500, hidden_size=128, tie_embeddings=tied)
    table = _bf16(rng, 500, 128, scale=0.1)
    params = ({"embed_tokens": {"table": table}} if tied
              else {"lm_head": {"w": table.T.contiguous()}})
    x = _bf16(rng, 2, 5, 128)
    got = tq._logits(params, cfg, x)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 500)
    assert torch.equal(got, x.float() @ table.float().T)


def test_mixed_dtypes_promote():
    rng = np.random.RandomState(4)
    x, w = _bf16(rng, 4, 64), torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    assert torch.equal(nn.matmul_f32(x, w), x.float() @ w)


LLM = dict(vocab_size=300, hidden_size=128, intermediate_size=512, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=32)
B, T_PAD, MAX_LEN, NEW = 8, 12, 20, 6
LENGTHS = np.array([12, 9, 7, 12, 5, 10, 11, 8], np.int32)
TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _trees():
    jcfg, tcfg = jq.QwenConfig(**LLM), tq.QwenConfig(**LLM)
    params = jq.init_params(jax.random.PRNGKey(6), jcfg, dtype=jnp.float32)
    return jcfg, tcfg, params, convert.tree_to_torch(jax.tree.map(np.asarray, params), "cpu")


def _embeds():
    return np.random.RandomState(7).randn(B, T_PAD, LLM["hidden_size"]).astype(np.float32)


def _spy_decode_qkv(monkeypatch):
    calls = []
    inner = tq.decode_qkv
    monkeypatch.setattr(tq, "decode_qkv", lambda *a, **k: calls.append(1) or inner(*a, **k))
    return calls


@pytest.mark.parametrize("switch,per_step", [("auto", 1), ("pallas", 1), ("xla", 0)])
def test_decode_qkv_switch_routes(switch, per_step, monkeypatch):
    """One decode_qkv call per layer and decode step under "auto" and
    "pallas", none under "xla"; none on the prefill either way."""
    monkeypatch.setattr(tq, "DECODE_QKV", switch)
    calls = _spy_decode_qkv(monkeypatch)
    _, tcfg, _, tparams = _trees()
    tgen.generate(tparams, tcfg, tgen.GenerateConfig(max_new_tokens=NEW, do_sample=False),
                  torch.from_numpy(_embeds()), torch.from_numpy(LENGTHS), None, max_len=MAX_LEN)
    assert len(calls) == per_step * LLM["num_layers"] * NEW


def test_decode_qkv_xla_matches_jax(monkeypatch):
    """DECODE_QKV="xla" on both sides: greedy tokens and num_valid identical
    over `generate`, and the logits of one decode step after a cached
    prefill within 1e-4, with decode_qkv neither called nor launched."""
    monkeypatch.setattr(jq, "DECODE_QKV", "xla")
    monkeypatch.setattr(tq, "DECODE_QKV", "xla")
    jax.clear_caches()  # JAX reads the switch at trace time
    calls = _spy_decode_qkv(monkeypatch)
    launches = decode_qkv.launches
    jcfg, tcfg, params, tparams = _trees()
    gk = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=LLM["vocab_size"] - 1)
    try:
        jtok, jnv = jgen.generate(params, jcfg, jgen.GenerateConfig(**gk),
                                  jnp.asarray(_embeds()), jnp.asarray(LENGTHS),
                                  jax.random.PRNGKey(0), max_len=MAX_LEN)
        jtok, jnv = np.asarray(jtok), np.asarray(jnv)
        rng = np.random.RandomState(8)
        step = rng.randn(B, 1, LLM["hidden_size"]).astype(np.float32) * 0.5
        prompt = rng.randn(B, T_PAD, LLM["hidden_size"]).astype(np.float32) * 0.5
        causal = np.arange(MAX_LEN)[None, None, :] <= np.arange(T_PAD)[None, :, None]
        positions = np.broadcast_to(np.arange(T_PAD, dtype=np.int32), (B, T_PAD))
        step_mask = (np.arange(MAX_LEN) <= T_PAD)[None, None, :].repeat(B, 0)
        step_pos = np.full((B, 1), T_PAD, np.int32)
        jcache = jq.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32)
        _, jcache = jq.forward(params, jcfg, jnp.asarray(prompt),
                               jnp.asarray(np.broadcast_to(causal, (B, T_PAD, MAX_LEN))),
                               positions=jnp.asarray(positions), cache=jcache,
                               cache_index=jnp.int32(0), last_token_only=True)
        want, _ = jq.forward(params, jcfg, jnp.asarray(step), jnp.asarray(step_mask),
                             positions=jnp.asarray(step_pos), cache=jcache,
                             cache_index=jnp.int32(T_PAD))
    finally:
        jax.clear_caches()
    ttok, tnv = tgen.generate(tparams, tcfg, tgen.GenerateConfig(**gk),
                              torch.from_numpy(_embeds()), torch.from_numpy(LENGTHS), None,
                              max_len=MAX_LEN)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_array_equal(tnv.numpy(), jnv)
    tcache = tq.init_cache(tcfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    _, tcache = tq.forward(tparams, tcfg, torch.from_numpy(prompt),
                           torch.from_numpy(np.broadcast_to(causal, (B, T_PAD, MAX_LEN)).copy()),
                           positions=torch.from_numpy(positions.copy()), cache=tcache,
                           cache_index=0, last_token_only=True)
    got, _ = tq.forward(tparams, tcfg, torch.from_numpy(step), torch.from_numpy(step_mask),
                        positions=torch.from_numpy(step_pos), cache=tcache, cache_index=T_PAD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not calls and decode_qkv.launches == launches
