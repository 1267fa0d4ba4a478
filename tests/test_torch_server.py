"""The dense continuous-batching server and the int8 KV cache of the port
against the JAX package, in f32 on the CPU, on the same seeded weights.

- `BatchServer`: greedy results identical to JAX's `BatchServer` with slot
  reuse across waves, power-of-two admission buckets with dummy rows,
  mixed modality signatures (a shorter face sequence, a text-only
  request), and a second wave on a drained server.
- `generate(cache_dtype=torch.int8)` and `Chat(kv_cache_dtype="int8")`
  against JAX's: the same tokens; after the prefill the logits within
  1e-4, the int8 rows byte-identical and their scales within 1e-6.
- The submit-time refusals, `Chat`'s validation, and the per-row write of
  t > 1 rows (speculative verify), which the port refuses."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.inference.chat import Chat as JChat
from affectgpt_tpu.inference.server import BatchServer as JServer
from affectgpt_tpu.inference.server import Request as JRequest
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.inference.chat import Chat as TChat
from affectgpt_tpu_torch.inference.server import BatchServer as TServer
from affectgpt_tpu_torch.inference.server import Request as TRequest
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TByteTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _models():
    jcfg, tcfg = ja.AffectGPTConfig.tiny(), ta.AffectGPTConfig.tiny()
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    trainable = jax.tree_util.tree_map_with_path(  # a LoRA that changes the outputs
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" and p[0].key == "lora" else x, trainable)
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg, device="cpu")
    return jcfg, frozen, trainable, tcfg, tfrozen, ttrain


def _request(cls, rid, length, max_new=5, face_frames=8, text_only=False):
    rng = np.random.RandomState(rid)
    ids = rng.randint(1, 250, length).astype(np.int32)
    if text_only:
        return cls(request_id=rid, input_ids=ids, features={}, offsets={},
                   max_new_tokens=max_new)
    ids[2:4] = 0  # num_video_query_token = 2 patch positions
    face = rng.randn(8, 12).astype(np.float32)[:face_frames]
    return cls(request_id=rid, input_ids=ids, features={"face": face}, offsets={"face": 2},
               max_new_tokens=max_new)


# waves of submissions: each wave is submitted, then the server drains
WAVES = {
    "two_slots": (2, [[(0, 7), (1, 5), (2, 9), (3, 6), (4, 8)], [(10, 7, 4)]]),
    "buckets_and_signatures": (4, [[(5, 7), (6, 6), (7, 7, 6, 5), (8, 6, 4, 8, True),
                                    (9, 5, 6), (11, 9, 3)]]),
}


@functools.lru_cache(maxsize=None)
def _jax_waves(name):
    slots, waves = WAVES[name]
    jcfg, jfrozen, jtrain = _models()[:3]
    server = JServer(jfrozen, jtrain, jcfg, ByteTokenizer(), max_slots=slots, max_len=64)
    out = []
    for wave in waves:
        for spec in wave:
            server.submit(_request(JRequest, *spec))
        out.append(dict(server.run_until_drained()))
    return out


@pytest.mark.parametrize("name", list(WAVES))
def test_batch_server_matches_jax(name):
    slots, waves = WAVES[name]
    tcfg, tfrozen, ttrain = _models()[3:]
    server = TServer(tfrozen, ttrain, tcfg, TByteTokenizer(), max_slots=slots, max_len=64)
    got = []
    for wave in waves:
        for spec in wave:
            server.submit(_request(TRequest, *spec))
        got.append(dict(server.run_until_drained()))
    assert got == _jax_waves(name)
    assert server.stats["admissions"] >= 2 and all(s.done for s in server.slots)
    summary = server.clock.summary()
    assert summary["requests"] == sum(len(w) for w in waves)
    assert summary["ttft_p95_ms"] >= summary["ttft_p50_ms"] >= 0


def test_submit_refusals_match_jax():
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models()
    jserver = JServer(jfrozen, jtrain, jcfg, ByteTokenizer(), max_slots=2, max_len=64)
    tserver = TServer(tfrozen, ttrain, tcfg, TByteTokenizer(), max_slots=2, max_len=64)
    for length in (64, 80):  # == max_len, > max_len
        for server, cls in ((jserver, JRequest), (tserver, TRequest)):
            with pytest.raises(ValueError):
                server.submit(_request(cls, 0, length))
    for server, cls in ((jserver, JRequest), (tserver, TRequest)):
        server.submit(_request(cls, 1, 63, max_new=1))  # the longest servable prompt
    assert tserver.run_until_drained() == jserver.run_until_drained()


LLM = dict(vocab_size=300, hidden_size=64, intermediate_size=128, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=16)
B, T_PAD, MAX_LEN, NEW = 3, 10, 20, 8
LENGTHS = np.array([10, 6, 8], np.int32)


@functools.lru_cache(maxsize=None)
def _llm():
    jcfg, tcfg = jq.QwenConfig(**LLM), tq.QwenConfig(**LLM)
    params = jq.init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    return jcfg, tcfg, params, convert.tree_to_torch(jax.tree.map(np.asarray, params), "cpu")


def test_int8_cache_generate_matches_jax():
    jcfg, tcfg, params, tparams = _llm()
    embeds = np.random.RandomState(4).randn(B, T_PAD, LLM["hidden_size"]).astype(np.float32)
    gk = dict(max_new_tokens=NEW, do_sample=False, eos_token_id=LLM["vocab_size"] - 1)
    jtok, jnv = jgen.generate(params, jcfg, jgen.GenerateConfig(**gk), jnp.asarray(embeds),
                              jnp.asarray(LENGTHS), jax.random.PRNGKey(0), max_len=MAX_LEN,
                              cache_dtype=jnp.int8)
    ttok, tnv = tgen.generate(tparams, tcfg, tgen.GenerateConfig(**gk), torch.from_numpy(embeds),
                              torch.from_numpy(LENGTHS), None, max_len=MAX_LEN,
                              cache_dtype=torch.int8)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))


def test_int8_cache_prefill_matches_jax():
    """The left-packed prefill into an int8 cache: the quantized rows
    byte-identical to JAX's compiled forward, their scales within 1e-6 (the
    projections' f32 sums run in another order, which moves about a
    quarter of the scales by one ulp), the last-token logits within 1e-4."""
    jcfg, tcfg, params, tparams = _llm()
    embeds = np.random.RandomState(5).randn(B, T_PAD, LLM["hidden_size"]).astype(np.float32)
    pad = T_PAD - LENGTHS
    positions = np.maximum(np.arange(T_PAD)[None, :] - pad[:, None], 0).astype(np.int32)
    mask = (np.arange(MAX_LEN)[None, None, :] <= np.arange(T_PAD)[None, :, None]) \
        & np.pad(np.arange(T_PAD)[None, :] >= pad[:, None], ((0, 0), (0, MAX_LEN - T_PAD)))[
            :, None, :]
    packed = np.array(jgen._left_pack(jnp.asarray(embeds), jnp.asarray(LENGTHS)))
    want, jcache = jax.jit(lambda p, e, m, pos: jq.forward(
        p, jcfg, e, m, positions=pos, cache=jq.init_cache(jcfg, B, MAX_LEN, dtype=jnp.int8),
        cache_index=jnp.int32(0), last_token_only=True))(params, packed, mask, positions)
    cache = tq.init_cache(tcfg, B, MAX_LEN, dtype=torch.int8, device="cpu")
    got, tcache = tq.forward(tparams, tcfg, torch.from_numpy(packed), torch.from_numpy(mask),
                             positions=torch.from_numpy(positions), cache=cache, cache_index=0,
                             last_token_only=True)
    assert tcache is cache and cache[0]["k"].dtype == torch.int8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for tl, jl in zip(tcache, jcache):
        assert sorted(tl) == ["k", "k_scale", "v", "v_scale"] == sorted(jl)
        for name in ("k", "v"):
            np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]), err_msg=name)
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tl[name].numpy(), np.asarray(jl[name]), rtol=1e-6,
                                       atol=0, err_msg=name)


def test_chat_int8_kv_cache_matches_jax():
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models()
    mode, subs, question = "multiface_audio_face_frame_text", ["so happy", "leave me"], "Why?"
    rng = np.random.RandomState(6)
    feats = {m: rng.randn(2, 8, d).astype(np.float32) for m, d in
             (("frame", 12), ("face", 12), ("audio", 16))}
    kw = dict(max_new_tokens=8, do_sample=False)
    want = JChat(jfrozen, jtrain, jcfg, ByteTokenizer(), max_len=512,
                 kv_cache_dtype="int8").answer_batch(
        mode, subs, question, {m: jnp.asarray(v) for m, v in feats.items()}, **kw)
    got = TChat(tfrozen, ttrain, tcfg, TByteTokenizer(), max_len=512,
                kv_cache_dtype="int8").answer_batch(
        mode, subs, question, {m: torch.from_numpy(v) for m, v in feats.items()}, **kw)
    assert got == want
    for chat_cls, frozen, train, cfg, tok in ((JChat, jfrozen, jtrain, jcfg, ByteTokenizer()),
                                              (TChat, tfrozen, ttrain, tcfg, TByteTokenizer())):
        with pytest.raises(ValueError):
            chat_cls(frozen, train, cfg, tok, kv_cache_dtype="fp8")


def test_per_row_write_of_several_rows_is_not_ported():
    """Per-row writes of t > 1 rows (the speculative verify) are ported now:
    each row's three rows land at its own columns, as a shared-column write
    of that row alone puts them, and no other column is touched."""
    _, tcfg, _, tparams = _llm()
    x = torch.randn(2, 3, LLM["hidden_size"], generator=torch.Generator().manual_seed(0))
    cache = tq.init_cache(tcfg, 2, 8, dtype=torch.float32, device="cpu")
    tq.forward(tparams, tcfg, x, torch.ones(2, 3, 8, dtype=torch.bool),
               positions=torch.zeros(2, 3).long(), cache=cache,
               cache_index=torch.tensor([1, 2]))
    for row, start in ((0, 1), (1, 2)):
        alone = tq.init_cache(tcfg, 1, 8, dtype=torch.float32, device="cpu")
        tq.forward(tparams, tcfg, x[row:row + 1], torch.ones(1, 3, 8, dtype=torch.bool),
                   positions=torch.zeros(1, 3).long(), cache=alone, cache_index=start)
        for layer, want in zip(cache, alone):
            for name in ("k", "v"):
                torch.testing.assert_close(layer[name][row], want[name][0], rtol=1e-6,
                                           atol=1e-6)
