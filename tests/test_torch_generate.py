"""The whole preextracted slice — build_inputs_embeds → generate — in the
port against the JAX package, at a geometry both decode kernels accept
(hidden 256, intermediate 512, heads 4, kv 2, head_dim 64, b = 8), with the
JAX side running both Pallas kernels in interpret mode and the port their
plain versions. Greedy tokens and num_valid must be identical; the logits
that pick the first token agree within 1e-4 (f32 on both sides)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import affectgpt_tpu.ops.decode_mlp_bf16_pallas as jax_mlp_mod
import affectgpt_tpu.ops.decode_qkv_pallas as jax_qkv_mod
from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq

LLM = dict(vocab_size=300, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=64)
B, T_PAD, MAX_LEN, NEW = 8, 24, 32, 6
LENGTHS = np.array([24, 20, 17, 24, 12, 15, 22, 19], np.int32)


def _inputs(cfg):
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 256, size=(B, T_PAD)).astype(np.int32)
    ids[np.arange(T_PAD)[None, :] >= LENGTHS[:, None]] = 0
    offsets = {
        "multi": np.full(B, 1, np.int32),
        "audio": np.full(B, 3, np.int32),
        "face": np.full(B, 6, np.int32),
        "frame": np.where(np.arange(B) % 2 == 0, 9, -1).astype(np.int32),
    }
    feats = {
        "frame": rng.randn(B, 4, cfg.visual_dim).astype(np.float32),
        "face": rng.randn(B, 4, cfg.visual_dim).astype(np.float32),
        "audio": rng.randn(B, 4, cfg.acoustic_dim).astype(np.float32),
    }
    return ids, offsets, feats


def test_greedy_slice_matches_jax_with_kernels(monkeypatch):
    monkeypatch.setenv("AFFECTGPT_DECODE_KERNEL_INTERPRET", "1")
    jax.clear_caches()  # the switch is read at trace time
    reached = {"qkv": 0, "mlp": 0}

    def counting(mod, name, key):
        inner = getattr(mod, name)

        def wrapped(*args, **kwargs):
            reached[key] += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(mod, name, wrapped)

    counting(jax_qkv_mod, "decode_qkv", "qkv")
    counting(jax_mlp_mod, "decode_mlp_bf16", "mlp")
    port_calls = {"qkv": 0, "mlp": 0}
    for name, key in (("decode_qkv", "qkv"), ("decode_mlp_bf16", "mlp")):
        inner = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _f=inner, _k=key, **kw: (
            port_calls.__setitem__(_k, port_calls[_k] + 1), _f(*a, **kw))[1])

    jcfg = dataclasses.replace(ja.AffectGPTConfig.tiny(), llm=jq.QwenConfig(**LLM))
    tcfg = dataclasses.replace(ta.AffectGPTConfig.tiny(), llm=tq.QwenConfig(**LLM))
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    trainable = jax.tree.map(lambda x: x * 25.0, trainable)  # O(1) merger outputs
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg,
                                       device="cpu")
    jllm = jq.merge_lora(frozen["llm"], trainable["lora"], jcfg.llm)
    tllm = tq.merge_lora(tfrozen["llm"], ttrain["lora"], tcfg.llm)

    ids, offsets, feats = _inputs(jcfg)
    jembeds = ja.build_inputs_embeds(frozen, trainable, jcfg, jnp.asarray(ids),
                                     {m: jnp.asarray(v) for m, v in feats.items()},
                                     {m: jnp.asarray(v) for m, v in offsets.items()})
    tembeds = ta.build_inputs_embeds(tfrozen, ttrain, tcfg, torch.from_numpy(ids).long(),
                                     {m: torch.from_numpy(v) for m, v in feats.items()},
                                     {m: torch.from_numpy(v).long() for m, v in offsets.items()})
    np.testing.assert_allclose(tembeds.numpy(), np.asarray(jembeds), atol=1e-5, rtol=1e-5)

    # eos and stop ids that some rows emit, so that stopping is exercised
    gk = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=211, stop_token_ids=(281,))
    jtok, jnv = jgen.generate(jllm, jcfg.llm, jgen.GenerateConfig(**gk), jembeds,
                              jnp.asarray(LENGTHS), jax.random.PRNGKey(0), max_len=MAX_LEN)
    ttok, tnv = tgen.generate(tllm, tcfg.llm, tgen.GenerateConfig(**gk), tembeds,
                              torch.from_numpy(LENGTHS), None, max_len=MAX_LEN)
    assert reached["qkv"] > 0 and reached["mlp"] > 0, reached  # JAX took its kernels
    assert port_calls == {"qkv": LLM["num_layers"] * NEW, "mlp": LLM["num_layers"] * NEW}
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
    assert bool((tnv < NEW).any())  # some rows stopped early

    # the logits that choose the first token: prefill of the left-packed prompts
    pad = T_PAD - LENGTHS
    key_valid = np.arange(T_PAD)[None, :] >= pad[:, None]
    positions = np.maximum(np.arange(T_PAD)[None, :] - pad[:, None], 0).astype(np.int32)
    mask = (np.arange(MAX_LEN)[None, None, :] <= np.arange(T_PAD)[None, :, None]) \
        & np.pad(key_valid, ((0, 0), (0, MAX_LEN - T_PAD)))[:, None, :]
    jax_forward = jax.jit(jq.forward, static_argnums=(1,), static_argnames=("last_token_only",))
    want, _ = jax_forward(jllm, jcfg.llm, jgen._left_pack(jembeds, jnp.asarray(LENGTHS)),
                         jnp.asarray(mask), positions=jnp.asarray(positions),
                         cache=jq.init_cache(jcfg.llm, B, MAX_LEN, dtype=jnp.float32),
                         cache_index=jnp.int32(0), last_token_only=True)
    got, _ = tq.forward(tllm, tcfg.llm, tgen._left_pack(tembeds, torch.from_numpy(LENGTHS)),
                        torch.from_numpy(mask), positions=torch.from_numpy(positions),
                        cache=tq.init_cache(tcfg.llm, B, MAX_LEN, dtype=torch.float32,
                                            device="cpu"),
                        cache_index=0, last_token_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("top_p", [0.3, 0.5, 0.9])
def test_top_p_mask_matches_jax_with_ties(top_p):
    logits = np.array([
        [2.0, 2.0, 2.0, 1.0, 0.0, -1.0, 2.0, 0.5],   # a four-way tie at the top
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],    # all tied
        [3.0, -2.0, 1.5, 1.5, 0.25, 1.5, -0.5, 0.0],  # a tie in the middle
    ], np.float32)
    want = np.asarray(jgen.top_p_mask(jnp.asarray(logits), top_p))
    got = tgen.top_p_mask(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_left_pack_and_trim_match_jax():
    x = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    lengths = np.array([3, 5], np.int32)
    np.testing.assert_array_equal(
        tgen._left_pack(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
        np.asarray(jgen._left_pack(jnp.asarray(x), jnp.asarray(lengths))))
    for text in ("a</s>b", " Assistant: happy ### sad ###x", "x###y###z"):
        assert tgen.trim_output_text(text) == jgen.trim_output_text(text)
