"""Quantized and fused serving in the port against the JAX package, in f32 on
the CPU, at the geometry of tests/test_quant.py:131-135 (every projection
has int4 leaves there).

- `generate`, greedy, b = 2 with prompts of at most 6 tokens, so that every
  quantized product has M < 16: on the CPU the JAX forward takes its XLA
  functions, whose functions the port's routed kernels (`int4_matmul_smallm`
  and `int8_matmul` plain versions) compute. Tokens and num_valid identical,
  prefill logits within 1e-4.
- The routes where JAX on the CPU computes another function (`int4_matmul`
  at 16 <= M <= 1024, and w8a8): `qwen2.forward`, eager on both sides, with
  the JAX package's XLA functions patched in this test to route by M and
  MATMUL_MODE to the Pallas kernels in interpret mode, as on a TPU. Each
  routed product of the port is held against the Pallas kernel on the
  port's own inputs within 1e-6, the logits within one flipped rounding.
- Routing: the number of calls of each kernel over one `generate`, the
  formula chip_smoke.py asserts at 7B; the bf16 decode kernels are not
  reached on quantized or fused trees.
- `from_jax` carries split, fused, int8 and int4 JAX trees across unchanged;
  `bootstrap.build_model` honours `model.int8`."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.ops import quant as jquant
from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import quant

LLM = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10_000.0,
           lora_r=2, lora_alpha=4.0)
B, T_PAD, NEW, MAX_LEN = 2, 6, 6, 16
LENGTHS = np.array([6, 4], np.int32)
TOL = dict(atol=1e-4, rtol=1e-4)
KERNELS = ("int8_matmul", "int8_matmul_w8a8", "int4_matmul", "int4_matmul_smallm")


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _base():
    jcfg, tcfg = jq.QwenConfig(**LLM), tq.QwenConfig(**LLM)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, tcfg, params, convert.tree_to_torch(jax.tree.map(np.asarray, params), "cpu")


# serving trees, built on each side by its own transforms from the same
# weights: (JAX transform, port transform)
VARIANTS = {
    "int4": (lambda p, c: jq.quantize_params(p, bits=4),
             lambda p, c: tq.quantize_params(p, bits=4)),
    "int8": (lambda p, c: jq.quantize_params(p, bits=8),
             lambda p, c: tq.quantize_params(p, bits=8)),
    "fused_int8": (lambda p, c: jq.quantize_params(jq.fuse_qkv_gateup(p, c), bits=8),
                   lambda p, c: tq.quantize_params(tq.fuse_qkv_gateup(p, c), bits=8)),
    "fused_qkv_int4": (
        lambda p, c: jq.quantize_params(jq.fuse_qkv_gateup(p, c, fuse_gateup=False), bits=4),
        lambda p, c: tq.quantize_params(tq.fuse_qkv_gateup(p, c, fuse_gateup=False), bits=4)),
}


@functools.lru_cache(maxsize=None)
def _variant(name):
    jcfg, tcfg, params, tparams = _base()
    jfn, tfn = VARIANTS[name]
    return jfn(params, jcfg), tfn(tparams, tcfg)


def _embeds(seed=3, t=T_PAD):
    return np.random.RandomState(seed).randn(B, t, LLM["hidden_size"]).astype(np.float32) * 0.5


def _generate_both(jprefill, tprefill, jdecode=None, tdecode=None):
    jcfg, tcfg, _, _ = _base()
    gk = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=LLM["vocab_size"] - 1)
    embeds = _embeds()
    jtok, jnv = jgen.generate(jprefill, jcfg, jgen.GenerateConfig(**gk), jnp.asarray(embeds),
                              jnp.asarray(LENGTHS), jax.random.PRNGKey(0), max_len=MAX_LEN,
                              decode_llm=jdecode)
    ttok, tnv = tgen.generate(tprefill, tcfg, tgen.GenerateConfig(**gk), torch.from_numpy(embeds),
                              torch.from_numpy(LENGTHS), None, max_len=MAX_LEN,
                              decode_llm=tdecode)
    return (np.asarray(jtok), np.asarray(jnv)), (ttok.numpy(), tnv.numpy())


def _prefill_logits(jllm, tllm):
    """Last-token logits of the left-packed cached prefill, both sides."""
    jcfg, tcfg, _, _ = _base()
    pad = T_PAD - LENGTHS
    key_valid = np.arange(T_PAD)[None, :] >= pad[:, None]
    positions = np.maximum(np.arange(T_PAD)[None, :] - pad[:, None], 0).astype(np.int32)
    mask = (np.arange(MAX_LEN)[None, None, :] <= np.arange(T_PAD)[None, :, None]) \
        & np.pad(key_valid, ((0, 0), (0, MAX_LEN - T_PAD)))[:, None, :]
    embeds = _embeds()
    want, _ = jq.forward(jllm, jcfg, jgen._left_pack(jnp.asarray(embeds), jnp.asarray(LENGTHS)),
                         jnp.asarray(mask), positions=jnp.asarray(positions),
                         cache=jq.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32),
                         cache_index=jnp.int32(0), last_token_only=True)
    got, _ = tq.forward(tllm, tcfg, tgen._left_pack(torch.from_numpy(embeds),
                                                    torch.from_numpy(LENGTHS)),
                        torch.from_numpy(mask), positions=torch.from_numpy(positions),
                        cache=tq.init_cache(tcfg, B, MAX_LEN, dtype=torch.float32, device="cpu"),
                        cache_index=0, last_token_only=True)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_quantized_trees_match_jax_leaf_for_leaf(variant):
    want, got = _variant(variant)
    flat_want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        if w.dtype == np.int8:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-7, rtol=1e-7, err_msg=str(path))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_generate_matches_jax(variant):
    jllm, tllm = _variant(variant)
    (jtok, jnv), (ttok, tnv) = _generate_both(jllm, tllm)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tnv, jnv)
    want, got = _prefill_logits(jllm, tllm)
    np.testing.assert_allclose(got, want, **TOL)


def test_decode_llm_generate_matches_jax():
    """f32 prefill, int4 decode copy: JAX's generate(decode_llm=) and the
    port's, token for token."""
    _, _, params, tparams = _base()
    jq4, tq4 = _variant("int4")
    (jtok, jnv), (ttok, tnv) = _generate_both(params, tparams, jq4, tq4)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tnv, jnv)
    # the decode copy really decides the tokens: f32 decode picks others
    (ftok, _), _ = _generate_both(params, tparams)
    assert not np.array_equal(ftok, jtok)


def _pallas_routed(monkeypatch):
    """Make the JAX forward route its quantized products as on a TPU: the
    XLA functions the CPU backend calls are replaced, in this test only, by
    the Pallas kernels in interpret mode, chosen by M and MATMUL_MODE."""
    int4_xla, int8_xla = jquant.int4_matmul_xla, jquant.int8_matmul_xla

    def int4_route(x, w, s, group=jquant.INT4_GROUP):
        m = x.shape[0]
        if m > jquant.PALLAS_DEQUANT_MAX_M:
            return int4_xla(x, w, s, group)
        kernel = jquant.int4_matmul_smallm if m < jquant.PALLAS_INT4_MIN_M else jquant.int4_matmul
        return kernel(x, w, s, interpret=True)

    def int8_route(x, w, s):
        if jquant.MATMUL_MODE == "w8a8":
            return jquant.int8_matmul_w8a8(x, w, s, interpret=True)
        if x.shape[0] > jquant.PALLAS_DEQUANT_MAX_M:
            return int8_xla(x, w, s)
        return jquant.int8_matmul(x, w, s, interpret=True)

    monkeypatch.setattr(jquant, "int4_matmul_xla", int4_route)
    monkeypatch.setattr(jquant, "int8_matmul_xla", int8_route)


# the kernels the port routes M = 24 rows to, with the JAX Pallas kernel of each
ROUTED = {"int4_matmul": jquant.int4_matmul, "int8_matmul_w8a8": jquant.int8_matmul_w8a8}
# products per forward: 7 per split layer, 5 (qkv-only fused) or 4 (fully
# fused) per fused one, plus the lm_head
ROUTED_PRODUCTS = {"int4": 15, "fused_qkv_int4": 11, "int8": 15, "fused_int8": 9}
# one flipped bf16 rounding of an activation moves a logit here by 5.3e-4 to
# 1.25e-3 (int4 at seeds 0, 3 and 5); the limit leaves room for a few
FLIP_TOL = dict(atol=5e-3, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 3, 5])
@pytest.mark.parametrize("variant,mode", [("int4", "w8"), ("fused_qkv_int4", "w8"),
                                          ("int8", "w8a8"), ("fused_int8", "w8a8")])
def test_routed_forward_matches_pallas_route(variant, mode, seed, monkeypatch):
    """M = b·t = 24 rows: int4 takes `int4_matmul`, w8a8 `int8_matmul_w8a8`,
    whose functions JAX computes on the CPU only through the Pallas kernels.

    - Every product the port's forward routes is held against the JAX
      Pallas kernel (interpret mode) on the very inputs the port gave it,
      within 1e-6: only the order of f32 sums differs.
    - The logits against JAX's forward routed as on a TPU: the same argmax
      at every position, and within FLIP_TOL. Both sides round activations
      to bf16 (or int8) before each product, so a 1-ulp f32 difference
      upstream can flip one rounding; the products above show that nothing
      else differs."""
    _pallas_routed(monkeypatch)
    monkeypatch.setattr(jquant, "MATMUL_MODE", mode)
    monkeypatch.setattr(quant, "MATMUL_MODE", mode)
    captured = []
    for name in ROUTED:
        def capture(x, w, s, _inner=getattr(quant, name), _name=name):
            captured.append((_name, x.numpy().copy(), w.numpy(), s.numpy()))
            return _inner(x, w, s)

        monkeypatch.setattr(quant, name, capture)
    jcfg, tcfg, _, _ = _base()
    jllm, tllm = _variant(variant)
    embeds = _embeds(seed=seed, t=12)
    valid = np.ones((B, 12), bool)
    valid[1, :3] = False
    want, _ = jq.forward(jllm, jcfg, jnp.asarray(embeds), jnp.asarray(valid))
    got, _ = tq.forward(tllm, tcfg, torch.from_numpy(embeds), torch.from_numpy(valid))
    routed = "int8_matmul_w8a8" if mode == "w8a8" else "int4_matmul"
    assert [name for name, *_ in captured] == [routed] * ROUTED_PRODUCTS[variant]
    for name, x, w, s in captured:
        port = getattr(quant, f"{name}_reference")(*map(torch.from_numpy, (x, w, s)))
        pallas = ROUTED[name](jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), interpret=True)
        np.testing.assert_allclose(port.numpy(), np.asarray(pallas), atol=1e-6, rtol=1e-6)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, **FLIP_TOL)


def _spy(monkeypatch, module, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        inner = getattr(module, name)

        def wrapped(*args, _inner=inner, _name=name, **kwargs):
            calls[_name] += 1
            return _inner(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("variant,mode,expect", [
    # 7 products per split layer and 4 per fused one, plus the lm_head; the
    # prefill's layers (M = 12 above the cut set below) take the dequantize
    # route, its lm_head (last token, M = 2) the kernel, except under w8a8
    ("int4", "w8", {"int4_matmul_smallm": NEW * (2 * 7 + 1) + 1}),
    ("fused_int8", "w8", {"int8_matmul": NEW * (2 * 4 + 1) + 1}),
    ("int8", "w8a8", {"int8_matmul_w8a8": (NEW + 1) * (2 * 7 + 1)}),
])
def test_kernel_routes_over_one_generate(variant, mode, expect, monkeypatch):
    monkeypatch.setattr(quant, "MATMUL_MODE", mode)
    monkeypatch.setattr(quant, "PALLAS_DEQUANT_MAX_M", 8)  # the prefill's M = 12 is above it
    calls = _spy(monkeypatch, quant, KERNELS)
    bf16 = _spy(monkeypatch, tq, ("decode_qkv", "decode_mlp_bf16"))
    _, tllm = _variant(variant)
    tcfg = _base()[1]
    tgen.generate(tllm, tcfg, tgen.GenerateConfig(max_new_tokens=NEW, do_sample=False),
                  torch.from_numpy(_embeds()), torch.from_numpy(LENGTHS), None, max_len=MAX_LEN)
    assert calls == {**dict.fromkeys(KERNELS, 0), **expect}
    assert bf16 == {"decode_qkv": 0, "decode_mlp_bf16": 0}


@pytest.mark.parametrize("m,route", [
    (1, "int4_matmul_smallm"), (15, "int4_matmul_smallm"), (16, "int4_matmul"),
    (1024, "int4_matmul"), (1025, "int4_matmul_xla"),
])
def test_int4_route_by_m(m, route, monkeypatch):
    calls = _spy(monkeypatch, quant, ("int4_matmul_smallm", "int4_matmul", "int4_matmul_xla"))
    w, s = quant.quantize_int4_grouped(torch.randn(256, 16))
    tq._quantized_matmul(torch.zeros(m, 256), {"w_q4": w, "scales": s})
    assert [name for name, n in calls.items() if n] == [route]


@pytest.mark.parametrize("m,mode,route", [
    (8, "w8", "int8_matmul"), (1024, "w8", "int8_matmul"), (1025, "w8", "int8_matmul_xla"),
    (8, "w8a8", "int8_matmul_w8a8"), (4512, "w8a8", "int8_matmul_w8a8"),
])
def test_int8_route_by_m_and_mode(m, mode, route, monkeypatch):
    monkeypatch.setattr(quant, "MATMUL_MODE", mode)
    calls = _spy(monkeypatch, quant, ("int8_matmul", "int8_matmul_w8a8", "int8_matmul_xla"))
    w, s = quant.quantize_per_channel(torch.randn(64, 16))
    tq._quantized_matmul(torch.zeros(m, 64), {"w_q": w, "scales": s})
    assert [name for name, n in calls.items() if n] == [route]


@pytest.mark.parametrize("layout,expect", [
    # the JAX rule: decode_qkv needs split bf16 q/k/v, decode_mlp_bf16 a bf16
    # gate_proj leaf, decode_attn_o a bf16 o_proj behind decode_qkv
    ("split", {"decode_qkv": 2 * NEW, "decode_mlp_bf16": 2 * NEW, "decode_attn_o": 2 * NEW,
               "decode_attention": 0}),
    ("fused", {"decode_qkv": 0, "decode_mlp_bf16": 0, "decode_attn_o": 0,
               "decode_attention": 2 * NEW}),
    ("fused_qkv", {"decode_qkv": 0, "decode_mlp_bf16": 2 * NEW, "decode_attn_o": 0,
                   "decode_attention": 2 * NEW}),
    ("int4", {"decode_qkv": 0, "decode_mlp_bf16": 0, "decode_attn_o": 0,
              "decode_attention": 2 * NEW}),
])
def test_decode_kernels_follow_the_layout(layout, expect, monkeypatch):
    """With DECODE_ATTN_O and DECODE_ATTENTION on: attention composes with
    any layout, the weight-reading kernels only with the bf16 split one."""
    monkeypatch.setattr(tq, "DECODE_ATTN_O", "pallas")
    monkeypatch.setattr(tq, "DECODE_ATTENTION", "pallas")
    calls = _spy(monkeypatch, tq, tuple(expect))
    _, tcfg, _, tparams = _base()
    tllm = {"split": lambda: tparams,
            "fused": lambda: tq.fuse_qkv_gateup(tparams, tcfg),
            "fused_qkv": lambda: tq.fuse_qkv_gateup(tparams, tcfg, fuse_gateup=False),
            "int4": lambda: _variant("int4")[1]}[layout]()
    tgen.generate(tllm, tcfg, tgen.GenerateConfig(max_new_tokens=NEW, do_sample=False),
                  torch.from_numpy(_embeds()), torch.from_numpy(LENGTHS), None, max_len=MAX_LEN)
    assert calls == expect


def test_fused_layout_generate_equals_split():
    """fuse_qkv_gateup is a layout change only (tests/test_quant.py:183-217
    on the JAX side)."""
    _, tcfg, _, tparams = _base()
    gcfg = tgen.GenerateConfig(max_new_tokens=NEW, do_sample=False)
    args = (torch.from_numpy(_embeds()), torch.from_numpy(LENGTHS), None)
    ref, _ = tgen.generate(tparams, tcfg, gcfg, *args, max_len=MAX_LEN)
    for fuse_gateup in (True, False):
        got, _ = tgen.generate(tq.fuse_qkv_gateup(tparams, tcfg, fuse_gateup=fuse_gateup), tcfg,
                               gcfg, *args, max_len=MAX_LEN)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("layout", ["split", "fused", "int8", "int4", "fused_qkv_int4"])
def test_from_jax_carries_every_layout(layout):
    """The JAX package's frozen tree with its LLM in each serving layout
    comes across with keys, dtypes and values unchanged."""
    jcfg = dataclasses.replace(ja.AffectGPTConfig.tiny(), llm=jq.QwenConfig(**LLM))
    tcfg = dataclasses.replace(ta.AffectGPTConfig.tiny(), llm=tq.QwenConfig(**LLM))
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    llm = frozen["llm"]
    llm = {"split": lambda: llm,
           "fused": lambda: jq.fuse_qkv_gateup(llm, jcfg.llm),
           "int8": lambda: jq.quantize_params(llm, bits=8),
           "int4": lambda: jq.quantize_params(llm, bits=4),
           "fused_qkv_int4": lambda: jq.quantize_params(
               jq.fuse_qkv_gateup(llm, jcfg.llm, fuse_gateup=False), bits=4)}[layout]()
    frozen_np = jax.tree.map(np.asarray, {**frozen, "llm": llm})
    trainable_np = jax.tree.map(np.asarray, ja.init_trainable(jax.random.PRNGKey(1), jcfg))
    tfrozen, _ = convert.from_jax(frozen_np, trainable_np, tcfg, device="cpu")
    flat_want = jax.tree_util.tree_flatten_with_path(frozen_np["llm"])[0]
    flat_got = jax.tree_util.tree_flatten_with_path(tfrozen["llm"])[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32), err_msg=str(path))
    bad = dataclasses.replace(tcfg, llm=dataclasses.replace(tcfg.llm, num_heads=2))
    with pytest.raises(ValueError):
        convert.from_jax(frozen_np, trainable_np, bad, device="cpu")


def test_build_model_int8_quantizes_the_llm():
    cfg, frozen, _, _ = bootstrap.build_model({"int8": True}, device="cpu")
    layer = frozen["llm"]["layers"][0]
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
        assert layer[name]["w_q"].dtype == torch.int8 and "w" not in layer[name]
        assert layer[name]["scales"].shape == (1, layer[name]["w_q"].shape[1])
    assert "w_q" in frozen["llm"]["lm_head"]
    plain = bootstrap.build_model({}, device="cpu")[1]["llm"]["layers"][0]
    assert "w" in plain["q_proj"]
