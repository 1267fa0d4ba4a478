"""The dense-cache attention kernels of the port against the JAX package, on
the CPU, in f32, on the same seeded numpy inputs.

- Each kernel module's plain version (reached through its wrapper, which
  takes it for CPU tensors) against its JAX function: the decode-attention
  and decode attention+o_proj Pallas kernels in interpret mode, and the
  flash prefill against the JAX XLA attention chain on valid rows (the
  stock TPU flash op has no interpret mode, and the two differ on pad rows
  by design: see ops/prefill_attention.py).
- qwen2.forward and generate with each attention switch on, against the
  JAX package: its DECODE_ATTN_O="pallas" kernel in interpret mode, its
  plain chain for the other two. Greedy tokens and num_valid must be
  identical; logits agree within 1e-4 (the same f32 math, summed in
  another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affectgpt_tpu.ops.decode_attn_o_pallas as jax_attn_o_mod
from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.ops.decode_attention_pallas import decode_attention_pallas
from affectgpt_tpu.ops.decode_attn_o_pallas import decode_attn_o as jax_decode_attn_o
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops.decode_attention import decode_attention
from affectgpt_tpu_torch.ops.decode_attn_o import decode_attn_o
from affectgpt_tpu_torch.ops.prefill_attention import prefill_attention

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def fresh_jax_traces():
    """The JAX switches and the interpret flag are read at trace time: drop
    compiled functions before and after, so no other test sees them."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def _windows(rng, b, t, lo_max, hi_min):
    """Ragged per-row windows [lo, hi] of valid columns, as a decode step has."""
    lo = rng.randint(0, lo_max, size=(b,))
    hi = rng.randint(hi_min, t, size=(b,))
    cols = np.arange(t)[None, :]
    return (cols >= lo[:, None]) & (cols <= hi[:, None])


@pytest.mark.parametrize("b,kv,g,d,t", [(4, 2, 3, 64, 40), (8, 4, 7, 128, 72)])
def test_decode_attention_plain_matches_pallas(b, kv, g, d, t):
    rng = np.random.RandomState(0)
    q = rng.randn(b, kv, g, d).astype(np.float32)
    k = rng.randn(b, kv, t, d).astype(np.float32)
    v = rng.randn(b, kv, t, d).astype(np.float32)
    mask = _windows(rng, b, t, 8, t // 2)
    mask[0, ::3] = False  # a mask that is not a window: this kernel takes any
    mask[1] = False  # a row with no valid column gives zeros
    want = decode_attention_pallas(*map(jnp.asarray, (q, k, v, mask)), interpret=True)
    decode_attention.launches = 0
    got = decode_attention(*map(torch.from_numpy, (q, k, v, mask)))
    assert got.dtype == torch.float32 and decode_attention.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not got[1].any()


def test_decode_attention_plain_matches_pallas_on_a_ragged_last_tile():
    """T = 577's raggedness at a small width: t = 37 ends in a partial
    16-column tile, and row 2's only valid column is the last; row 0 has
    holes, row 1 no valid column (zeros)."""
    b, kv, g, d, t = 3, 2, 3, 64, 37
    rng = np.random.RandomState(3)
    q = rng.randn(b, kv, g, d).astype(np.float32)
    k = rng.randn(b, kv, t, d).astype(np.float32)
    v = rng.randn(b, kv, t, d).astype(np.float32)
    mask = _windows(rng, b, t, 8, t // 2)
    mask[0, ::4] = False
    mask[1] = False
    mask[2] = np.arange(t) == t - 1
    want = decode_attention_pallas(*map(jnp.asarray, (q, k, v, mask)), interpret=True)
    got = decode_attention(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert not got[1].any()
    np.testing.assert_allclose(got[2].numpy(), v[2, :, None, t - 1].repeat(g, 1), atol=1e-6)


@pytest.mark.parametrize("b,kv,g,d,t,h,edges", [
    pytest.param(16, 2, 4, 128, 64, 256, False, id="16-2-4-128-64-256"),
    pytest.param(8, 2, 2, 64, 48, 128, False, id="8-2-2-64-48-128"),
    # a row with no valid column (the window [0, T - 1]), windows that end
    # before T - 1, one that starts past a 16-column tile's first column
    pytest.param(8, 4, 7, 128, 64, 256, True, id="edges-8-4-7-128-64-256"),
    pytest.param(8, 2, 3, 64, 48, 128, True, id="edges-8-2-3-64-48-128"),
])
def test_decode_attn_o_plain_matches_pallas(b, kv, g, d, t, h, edges):
    rng = np.random.RandomState(1)
    x = rng.randn(b, h).astype(np.float32)
    q = rng.randn(b, kv, g, d).astype(np.float32)
    k = rng.randn(b, kv, t, d).astype(np.float32)
    v = rng.randn(b, kv, t, d).astype(np.float32)
    wo = (rng.randn(kv * g * d, h) * 0.05).astype(np.float32)
    mask = _windows(rng, b, t, 8, 16)  # as tests/test_decode_attn_o_pallas.py:35-39
    if edges:
        cols = np.arange(t)
        mask[0] = False
        mask[1] = (cols >= 5) & (cols <= t // 2)
        mask[2] = (cols >= 17) & (cols <= t - 3)
        mask[3] = cols == t - 7
    want = jax_decode_attn_o(*map(jnp.asarray, (x, q, k, v, mask, wo)), block_m=8,
                             block_t=16, interpret=True)
    decode_attn_o.launches = 0
    got = decode_attn_o(*map(torch.from_numpy, (x, q, k, v, mask, wo)))
    assert got.dtype == torch.float32 and decode_attn_o.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _selection_layer(heads, kv, d):
    """A layer whose q/k/v projections pick [q | k | v] out of x and whose
    o_proj writes the attention into the first heads*d columns: with
    positions 0 (RoPE is then the identity) the JAX layer computes exactly
    its attention chain on the q/k/v it is handed."""
    nq, nkv = heads * d, kv * d
    hidden = nq + 2 * nkv
    eye = np.eye(hidden, dtype=np.float32)

    def dense(cols):
        return {"w": jnp.asarray(eye[:, cols]), "b": jnp.zeros(cols.stop - cols.start)}

    return hidden, {
        "q_proj": dense(slice(0, nq)), "k_proj": dense(slice(nq, nq + nkv)),
        "v_proj": dense(slice(nq + nkv, hidden)),
        "o_proj": {"w": jnp.asarray(eye[:nq])},
    }


@pytest.mark.parametrize("heads,kv,d,t,max_len", [(4, 2, 16, 20, 28), (6, 2, 64, 37, 40)])
def test_prefill_plain_matches_xla_chain_on_valid_rows(heads, kv, d, t, max_len):
    b = 5
    hidden, layer = _selection_layer(heads, kv, d)
    cfg = jq.QwenConfig(vocab_size=8, hidden_size=hidden, intermediate_size=8, num_layers=1,
                        num_heads=heads, num_kv_heads=kv, head_dim=d)
    rng = np.random.RandomState(2)
    x = rng.randn(b, t, hidden).astype(np.float32)
    pad = np.array([0, 3, 7, 1, t - 1])  # left pads per row, generate's left-pack
    key_valid = np.arange(t)[None, :] >= pad[:, None]
    mask = (np.arange(max_len)[None, None, :] <= np.arange(t)[None, :, None]) \
        & np.pad(key_valid, ((0, 0), (0, max_len - t)))[:, None, :]
    assert jq.PREFILL_ATTENTION == "xla"
    want, _, _ = jq._attention(layer, None, cfg, jnp.asarray(x), jnp.zeros((b, t), jnp.int32),
                               jnp.asarray(mask)[:, None], jq.init_cache(cfg, b, max_len,
                                                                         jnp.float32)[0],
                               jnp.int32(0))
    nq, nkv = heads * d, kv * d
    q = torch.from_numpy(x[..., :nq]).reshape(b, t, heads, d)
    k = torch.from_numpy(x[..., nq:nq + nkv]).reshape(b, t, kv, d).transpose(1, 2).contiguous()
    v = torch.from_numpy(x[..., nq + nkv:]).reshape(b, t, kv, d).transpose(1, 2).contiguous()
    prefill_attention.launches = 0
    got = prefill_attention(q, k, v, torch.from_numpy(key_valid))
    assert got.shape == (b, t, nq) and prefill_attention.launches == 0
    want = np.asarray(want)[..., :nq]
    np.testing.assert_allclose(got.numpy()[key_valid], want[key_valid], atol=1e-5, rtol=1e-5)
    # pad rows attend over the pads up to themselves, not uniformly
    assert not np.allclose(got.numpy()[~key_valid], want[~key_valid], atol=1e-3)


# a geometry at which the JAX decode kernels engage in interpret mode:
# head_dim 128 (decode_attn_o needs head_dim % 128 == 0), b % 8 == 0
LLM = dict(vocab_size=300, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=128)
B, T_PAD, MAX_LEN, NEW = 8, 24, 32, 6
LENGTHS = np.array([24, 20, 17, 24, 12, 15, 22, 19], np.int32)
SWITCHES = {  # port switch → (value, the port's kernel wrapper and its calls per generate)
    "DECODE_ATTN_O": ("pallas", "decode_attn_o", LLM["num_layers"] * NEW),
    "DECODE_ATTENTION": ("pallas", "decode_attention", LLM["num_layers"] * NEW),
    "PREFILL_ATTENTION": ("flash", "prefill_attention", LLM["num_layers"]),
}


def _merged_llm():
    jcfg, tcfg = jq.QwenConfig(**LLM), tq.QwenConfig(**LLM)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    lora = jq.init_lora(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    lora = jax.tree_util.tree_map_with_path(  # nonzero B so that merging matters
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" else x, lora)
    jllm = jq.merge_lora(params, lora, jcfg)
    tllm = tq.merge_lora(convert.tree_to_torch(jax.tree.map(np.asarray, params), "cpu"),
                         convert.tree_to_torch(jax.tree.map(np.asarray, lora), "cpu"), tcfg)
    return jcfg, tcfg, jllm, tllm


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_forward_and_generate_match_jax(switch, monkeypatch, fresh_jax_traces):
    value, wrapper, calls = SWITCHES[switch]
    monkeypatch.setattr(tq, switch, value)
    jax_calls = []
    if switch == "DECODE_ATTN_O":  # the JAX kernel, in interpret mode
        monkeypatch.setattr(jq, switch, value)
        monkeypatch.setenv("AFFECTGPT_DECODE_KERNEL_INTERPRET", "1")
        jax_inner = jax_attn_o_mod.decode_attn_o
        monkeypatch.setattr(jax_attn_o_mod, "decode_attn_o",
                            lambda *a, **kw: (jax_calls.append(1), jax_inner(*a, **kw))[1])
    port_calls = []
    inner = getattr(tq, wrapper)
    monkeypatch.setattr(tq, wrapper, lambda *a, **kw: (port_calls.append(1), inner(*a, **kw))[1])

    jcfg, tcfg, jllm, tllm = _merged_llm()
    rng = np.random.RandomState(3)
    embeds = (rng.randn(B, T_PAD, jcfg.hidden_size) * 0.5).astype(np.float32)

    # forward: prefill of the left-packed prompts, then one decode step
    pad = T_PAD - LENGTHS
    key_valid = np.arange(T_PAD)[None, :] >= pad[:, None]
    positions = np.maximum(np.arange(T_PAD)[None, :] - pad[:, None], 0).astype(np.int32)
    mask = (np.arange(MAX_LEN)[None, None, :] <= np.arange(T_PAD)[None, :, None]) \
        & np.pad(key_valid, ((0, 0), (0, MAX_LEN - T_PAD)))[:, None, :]
    packed = np.array(jgen._left_pack(jnp.asarray(embeds), jnp.asarray(LENGTHS)))
    jax_forward = jax.jit(jq.forward, static_argnums=(1,), static_argnames=("last_token_only",))
    want, jcache = jax_forward(jllm, jcfg, jnp.asarray(packed), jnp.asarray(mask),
                               positions=jnp.asarray(positions),
                               cache=jq.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32),
                               cache_index=jnp.int32(0), last_token_only=True)
    tcache = tq.init_cache(tcfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    got, tcache = tq.forward(tllm, tcfg, torch.from_numpy(packed), torch.from_numpy(mask),
                             positions=torch.from_numpy(positions), cache=tcache,
                             cache_index=0, last_token_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    step = (rng.randn(B, 1, jcfg.hidden_size) * 0.5).astype(np.float32)
    step_mask = ((np.arange(MAX_LEN)[None, :] <= T_PAD)
                 & np.pad(key_valid, ((0, 0), (0, MAX_LEN - T_PAD)), constant_values=True)
                 )[:, None, :]
    step_pos = LENGTHS[:, None]
    want, _ = jax_forward(jllm, jcfg, jnp.asarray(step), jnp.asarray(step_mask),
                          positions=jnp.asarray(step_pos), cache=jcache,
                          cache_index=jnp.int32(T_PAD))
    got, _ = tq.forward(tllm, tcfg, torch.from_numpy(step), torch.from_numpy(step_mask),
                        positions=torch.from_numpy(step_pos), cache=tcache, cache_index=T_PAD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # generate: greedy, with an eos and a stop id that some rows emit
    port_calls.clear()
    gk = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=211, stop_token_ids=(281,))
    jtok, jnv = jgen.generate(jllm, jcfg, jgen.GenerateConfig(**gk), jnp.asarray(embeds),
                              jnp.asarray(LENGTHS), jax.random.PRNGKey(0), max_len=MAX_LEN)
    ttok, tnv = tgen.generate(tllm, tcfg, tgen.GenerateConfig(**gk), torch.from_numpy(embeds),
                              torch.from_numpy(LENGTHS), None, max_len=MAX_LEN)
    assert len(port_calls) == calls
    assert bool(jax_calls) == (switch == "DECODE_ATTN_O")  # traced with the JAX kernel
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
