"""Prompt-lookup speculative decoding in the port against the JAX package,
in f32 on the CPU, mirroring tests/test_speculative.py: draft_len 1, 3 and 4
over a ragged batch, stop tokens, a rigged two-token head, a periodic
stream that accepts full drafts, the int8 KV cache and the int4, int8 and
fused serving trees. Tokens, num_valid and the verify iterations
(`return_stats`) must be identical to JAX's, and the tokens to the port's
own greedy `generate`.

Also the per-row cache write of t > 1 rows (the verify) against JAX's
one-hot rewrite for bf16 and int8 caches, with a row whose writes run past
the cache's end, and the flash-prefill gate: a verify forward under
PREFILL_ATTENTION="flash" equals the same forward under "xla"."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import quant

EOS = 257


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _tiny():
    cfg = jq.QwenConfig.tiny()
    params = jq.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, tq.QwenConfig.tiny(), params, _to_torch(params)


def _to_torch(params):
    return convert.tree_to_torch(jax.tree.map(np.asarray, params), "cpu")


def _run_all(jparams, tparams, jcfg, tcfg, ids, lengths, max_new, draft_len, stop_ids=(),
             max_len=64, cache_dtype=None):
    """(JAX speculative, port speculative, port greedy), each (tokens,
    num_valid[, iters]) as numpy."""
    gk = dict(max_new_tokens=max_new, do_sample=False, eos_token_id=EOS,
              stop_token_ids=stop_ids)
    ids = np.array(ids, np.int32)
    lengths = np.array(lengths, np.int32)
    jembeds = jq.embed_tokens(jparams, jnp.asarray(ids))
    want = jgen.generate_speculative(
        jparams, jcfg, jgen.GenerateConfig(**gk), jembeds, jnp.asarray(lengths),
        jnp.asarray(ids), max_len=max_len, draft_len=draft_len, return_stats=True,
        cache_dtype=jnp.int8 if cache_dtype is torch.int8 else None)
    return ([np.asarray(x) for x in want],
            *_run_port(tparams, tcfg, ids, lengths, gk, draft_len, max_len, cache_dtype))


def _run_port(tparams, tcfg, ids, lengths, gk, draft_len, max_len, cache_dtype=None):
    """(port speculative, port greedy) of _run_all."""
    tids = torch.from_numpy(ids).long()
    tembeds = tq.embed_tokens(tparams, tids)
    got = tgen.generate_speculative(
        tparams, tcfg, tgen.GenerateConfig(**gk), tembeds, torch.from_numpy(lengths), tids,
        max_len=max_len, draft_len=draft_len, return_stats=True, cache_dtype=cache_dtype)
    greedy = tgen.generate(tparams, tcfg, tgen.GenerateConfig(**gk), tembeds,
                           torch.from_numpy(lengths), None, max_len=max_len,
                           cache_dtype=cache_dtype)
    return [got[0].numpy(), got[1].numpy(), got[2]], [x.numpy() for x in greedy]


def _assert_exact(want, got, greedy):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == int(want[2])  # verify iterations
    np.testing.assert_array_equal(got[0], greedy[0])
    np.testing.assert_array_equal(got[1], greedy[1])


def _ids(seed, shape, vocab):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 1, vocab))


@pytest.mark.parametrize("draft_len", [1, 3, 4])
def test_ragged_batch_matches_jax_and_greedy(draft_len):
    jcfg, tcfg, params, tparams = _tiny()
    _assert_exact(*_run_all(params, tparams, jcfg, tcfg, _ids(1, (3, 9), jcfg.vocab_size),
                            [9, 5, 7], max_new=8, draft_len=draft_len))


def test_stop_token_truncation():
    jcfg, tcfg, params, tparams = _tiny()
    ids = _ids(3, (2, 6), jcfg.vocab_size)
    lengths = np.array([6, 4], np.int32)
    gcfg = tgen.GenerateConfig(max_new_tokens=6, do_sample=False, eos_token_id=EOS)
    ref, _ = tgen.generate(tparams, tcfg, gcfg, tq.embed_tokens(tparams, torch.from_numpy(ids)),
                           torch.from_numpy(lengths), None, max_len=32)
    stop = int(ref[0, 2])  # a token the model emits, so truncation triggers mid-stream
    want, got, greedy = _run_all(params, tparams, jcfg, tcfg, ids, lengths, max_new=6,
                                 draft_len=3, stop_ids=(stop,), max_len=32)
    _assert_exact(want, got, greedy)
    assert (got[1] < 6).any()


def _two_token_head(params, seed):
    """A rigged lm_head whose two antipodal columns 42 and 43 win the argmax
    for any hidden state: the model emits from a two-token alphabet."""
    w = np.zeros(params["lm_head"]["w"].shape, np.float32)
    v = np.random.RandomState(seed).randn(w.shape[0])
    w[:, 42], w[:, 43] = v, -v
    return {**params, "lm_head": {"w": jnp.asarray(w)}}


def test_high_acceptance_cyclic_model():
    jcfg, tcfg, params, _ = _tiny()
    params = _two_token_head(params, 0)
    want, got, greedy = _run_all(params, _to_torch(params), jcfg, tcfg,
                                 _ids(4, (2, 7), jcfg.vocab_size), [7, 6], max_new=12,
                                 draft_len=4)
    assert set(greedy[0].ravel()) <= {42, 43}  # the rig worked
    _assert_exact(want, got, greedy)


def _periodic(params):
    """Zeroed projections and a two-column head: each token's successor is
    fixed by the token alone, and with seed 7 the map is the 2-cycle
    42 -> 43 -> 42."""
    names = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
    params = _two_token_head(params, 7)
    params["layers"] = [{**lyr, **{n: jax.tree.map(jnp.zeros_like, lyr[n]) for n in names}}
                        for lyr in params["layers"]]
    return params


def test_periodic_stream_accepts_full_drafts():
    """On the 2-cycle map the lookup drafts from a match whose continuation
    is written, so 24 tokens take at most 9 verify iterations."""
    jcfg, tcfg, params, _ = _tiny()
    params = _periodic(params)
    want, got, greedy = _run_all(params, _to_torch(params), jcfg, tcfg,
                                 _ids(6, (2, 7), jcfg.vocab_size), [7, 6], max_new=24,
                                 draft_len=4)
    assert set(got[0].ravel()) == {42, 43}
    assert got[2] <= 9, got[2]
    _assert_exact(want, got, greedy)


def test_minimum_max_len_with_a_row_done_early():
    """max_len = t_pad + max_new + draft_len, the least the call takes. Row
    0's prompt already holds the periodic stream, so it accepts full drafts
    from the first iteration and is done after 5; row 1's random prompt is
    not, and decodes on. The done row's verify columns then reach max_len:
    its writes are dropped, its emit columns stay in the buffer."""
    jcfg, tcfg, params, _ = _tiny()
    params = _periodic(params)
    tparams = _to_torch(params)
    t_pad, max_new, d = 8, 24, 4
    ids = _ids(9, (2, t_pad), jcfg.vocab_size)
    stream, _ = tgen.generate(
        tparams, tcfg, tgen.GenerateConfig(max_new_tokens=max_new, do_sample=False,
                                           eos_token_id=EOS),
        tq.embed_tokens(tparams, torch.from_numpy(ids[1:]).long()), torch.tensor([t_pad]),
        None, max_len=t_pad + max_new)
    ids[0] = stream[0, -t_pad:].numpy()  # the orbit's periodic part
    want, got, greedy = _run_all(params, tparams, jcfg, tcfg, ids, [t_pad, t_pad],
                                 max_new=max_new, draft_len=d, max_len=t_pad + max_new + d)
    assert got[2] > 5, got[2]  # row 1 outlasted row 0
    _assert_exact(want, got, greedy)


@pytest.mark.parametrize("draft_len", [1, 3, 4])
def test_int8_kv_cache(draft_len):
    jcfg, tcfg, params, tparams = _tiny()
    _assert_exact(*_run_all(params, tparams, jcfg, tcfg, _ids(7, (3, 9), jcfg.vocab_size),
                            [9, 6, 8], max_new=8, draft_len=draft_len, cache_dtype=torch.int8))


# the geometry of tests/test_torch_quant_serving.py, where every projection
# has int4 leaves; b = 2 keeps the verify's M = b·(d + 1) below 16, where the
# port's routed kernels compute JAX's XLA functions on the CPU. int8_w8a8:
# the int8 tree under quant.MATMUL_MODE = "w8a8", where the port runs
# int8_matmul_w8a8 for every M (chip_smoke.py's spec_q8a8) and JAX on a CPU
# its w8 XLA route (the departure noted in the port's ops/quant.py): its
# speculative tokens are held to the port's own greedy ones alone
QLLM = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10_000.0,
            lora_r=2, lora_alpha=4.0)
TREES = {
    "int4": lambda p, c, q: q.quantize_params(p, bits=4),
    "int8": lambda p, c, q: q.quantize_params(p, bits=8),
    "fused_int8": lambda p, c, q: q.quantize_params(q.fuse_qkv_gateup(p, c), bits=8),
    "int8_w8a8": lambda p, c, q: q.quantize_params(p, bits=8),
}


@functools.lru_cache(maxsize=None)
def _quant_base():
    jcfg, tcfg = jq.QwenConfig(**QLLM), tq.QwenConfig(**QLLM)
    params = jq.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, tcfg, params, _to_torch(params)


@pytest.mark.parametrize("tree", list(TREES))
@pytest.mark.parametrize("draft_len", [3, 4])
def test_quantized_trees(tree, draft_len, monkeypatch):
    jcfg, tcfg, params, tparams = _quant_base()
    ttree = TREES[tree](tparams, tcfg, tq)
    ids = _ids(8, (2, 6), 256)
    if tree == "int8_w8a8":
        monkeypatch.setattr(quant, "MATMUL_MODE", "w8a8")
        rows, inner = [], quant.int8_matmul_w8a8
        monkeypatch.setattr(quant, "int8_matmul_w8a8",
                            lambda x, w, s: rows.append(x.shape[0]) or inner(x, w, s))
        gk = dict(max_new_tokens=6, do_sample=False, eos_token_id=EOS, stop_token_ids=())
        got, greedy = _run_port(ttree, tcfg, np.array(ids, np.int32), np.array([6, 4], np.int32),
                                gk, draft_len, 24)
        np.testing.assert_array_equal(got[0], greedy[0])
        np.testing.assert_array_equal(got[1], greedy[1])
        assert 2 * (draft_len + 1) in rows and 2 in rows  # the verify's rows, greedy's step
        return
    jtree = TREES[tree](params, jcfg, jq)
    _assert_exact(*_run_all(jtree, ttree, jcfg, tcfg, ids, [6, 4], max_new=6,
                            draft_len=draft_len, max_len=24))


def _verify_inputs(cfg, b, max_len, t, start, seed=11):
    """A t-row verify block at per-row columns `start` of a max_len cache:
    embeddings, the causal key mask over the cache and the positions."""
    rng = np.random.RandomState(seed)
    block = rng.randn(b, t, cfg.hidden_size).astype(np.float32)
    q_abs = np.asarray(start)[:, None] + np.arange(t)[None, :]
    mask = np.arange(max_len)[None, None, :] <= q_abs[:, :, None]
    return block, mask, q_abs.astype(np.int32)


def _random_cache(cfg, b, max_len, dtype, seed=12):
    """Per-layer cache buffers filled from a numpy seed: (numpy tree, port
    tree). int8 values in [-127, 127] with positive f32 scales."""
    rng = np.random.RandomState(seed)
    shape = (b, cfg.num_kv_heads, max_len, cfg.head_dim)
    layers = []
    for _ in range(cfg.num_layers):
        if dtype == "int8":
            layers.append({n: rng.randint(-127, 128, shape).astype(np.int8) for n in "kv"})
            layers[-1].update({f"{n}_scale": (rng.rand(*shape[:-1]) * 0.02 + 0.01)
                               .astype(np.float32) for n in "kv"})
        else:
            layers.append({n: rng.randn(*shape).astype(np.float32) for n in "kv"})
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
    tcache = [{n: torch.from_numpy(a).to(tdt if a.dtype != np.float32 or n in "kv" else
                                           torch.float32) for n, a in lyr.items()}
              for lyr in layers]
    return layers, tcache


def _jax_cache(layers, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
    return [{n: jnp.asarray(a).astype(jdt if n in "kv" else jnp.float32)
             for n, a in lyr.items()} for lyr in layers]


def _jax_onehot_write(cache, k, v, cache_index):
    """JAX's per-row write of t > 1 rows (affectgpt_tpu/models/qwen2.py:
    818-845, inline there): k/v [b, kv, t, d] quantized by JAX's
    _quantize_kv for an int8 cache, then the one-hot rewrite, which drops
    the rows at or beyond the cache's end."""
    writes = [("k", k), ("v", v)]
    writes3 = []
    if cache["k"].dtype == jnp.int8:
        quant = jax.jit(jq._quantize_kv)  # every JAX caller runs it compiled
        (kq, ks), (vq, vs) = quant(k), quant(v)
        writes = [("k", kq), ("v", vq)]
        writes3 = [("k_scale", ks[..., 0]), ("v_scale", vs[..., 0])]
    t = k.shape[2]
    cols = cache_index[:, None] + jnp.arange(t)[None, :]
    onehot = jnp.arange(cache["k"].shape[2])[None, None, :] == cols[:, :, None]
    hit4 = jnp.any(onehot, axis=1)[:, None, :, None]
    hit3 = jnp.any(onehot, axis=1)[:, None, :]
    oh = onehot.astype(jnp.float32)
    out = dict(cache)
    for name, new in writes:
        upd = jnp.einsum("btT,bhtd->bhTd", oh, new.astype(jnp.float32))
        out[name] = jnp.where(hit4, upd.astype(cache[name].dtype), cache[name])
    for name, new in writes3:
        upd = jnp.einsum("btT,bht->bhT", oh, new.astype(jnp.float32))
        out[name] = jnp.where(hit3, upd.astype(cache[name].dtype), cache[name])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("start", [[3, 7, 10], [-2, 11, 14]], ids=["tail", "outside"])
def test_per_row_block_write_matches_jax_onehot(dtype, start):
    """t = 4 rows at per-row columns of a 12-column cache. "tail": row 2
    writes columns 10 and 11 and drops its last two rows (the t == 1 write
    clamps, this one must not). "outside": rows starting before the cache,
    at its last column and past its end. Bit for bit JAX's rewrite."""
    cfg = tq.QwenConfig.tiny()
    b, max_len, t = 3, 12, 4
    start = np.array(start, np.int32)
    layers, tcache = _random_cache(cfg, b, max_len, dtype)
    rng = np.random.RandomState(13)
    k = rng.randn(b, cfg.num_kv_heads, t, cfg.head_dim).astype(np.float32)
    v = rng.randn(b, cfg.num_kv_heads, t, cfg.head_dim).astype(np.float32)
    want = _jax_onehot_write(_jax_cache(layers, dtype)[0], jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(start))
    got = tcache[0]
    tq._write_cache(got, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(start))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name]).astype(np.float32), err_msg=name)
    # the dropped rows did not land anywhere: row 2's columns before 10 kept
    old = np.asarray(_jax_cache(layers, dtype)[0]["k"][2, :, :10]).astype(np.float32)
    np.testing.assert_array_equal(got["k"][2, :, :10].float().numpy(), old)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_verify_forward_matches_jax(dtype):
    """The whole verify forward (t = 4 at per-row columns, one row running
    past the cache's end) on the same cache: logits within 1e-4."""
    jcfg, tcfg, params, tparams = _tiny()
    b, max_len, t = 3, 12, 4
    start = np.array([3, 7, 10], np.int32)
    block, mask, positions = _verify_inputs(tcfg, b, max_len, t, start)
    layers, tcache = _random_cache(tcfg, b, max_len, dtype)
    want, _ = jq.forward(params, jcfg, jnp.asarray(block), jnp.asarray(mask),
                         positions=jnp.asarray(positions), cache=_jax_cache(layers, dtype),
                         cache_index=jnp.asarray(start))
    got, _ = tq.forward(tparams, tcfg, torch.from_numpy(block), torch.from_numpy(mask),
                        positions=torch.from_numpy(positions), cache=tcache,
                        cache_index=torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_flash_gate_excludes_verify(monkeypatch):
    """PREFILL_ATTENTION="flash" routes only the shared-column prefill to the
    flash kernel; a verify forward (per-row columns) reads the earlier cache
    columns on the plain chain, so its logits equal those under "xla"."""
    _, tcfg, _, tparams = _tiny()
    b, max_len, t = 2, 16, 3
    start = np.array([6, 9], np.int32)
    block, mask, positions = _verify_inputs(tcfg, b, max_len, t, start)

    def verify(switch):
        _, cache = _random_cache(tcfg, b, max_len, "float32")
        calls = []
        with monkeypatch.context() as m:
            m.setattr(tq, "PREFILL_ATTENTION", switch)
            m.setattr(tq, "prefill_attention",
                      lambda *a, _f=tq.prefill_attention: calls.append(1) or _f(*a))
            out, _ = tq.forward(tparams, tcfg, torch.from_numpy(block), torch.from_numpy(mask),
                                positions=torch.from_numpy(positions), cache=cache,
                                cache_index=torch.from_numpy(start))
        return out, calls

    flash, flash_calls = verify("flash")
    plain, _ = verify("xla")
    assert not flash_calls
    torch.testing.assert_close(flash, plain, rtol=0, atol=0)


def test_speculative_generate_under_flash_prefill(monkeypatch):
    """The whole speculative call under "flash": the prefill takes the flash
    kernel's plain version, the verifies the plain chain; the tokens stay
    the port's greedy tokens."""
    jcfg, tcfg, params, tparams = _tiny()
    monkeypatch.setattr(tq, "PREFILL_ATTENTION", "flash")
    _, got, greedy = _run_all(params, tparams, jcfg, tcfg, _ids(1, (3, 9), jcfg.vocab_size),
                              [9, 5, 7], max_new=8, draft_len=3)
    np.testing.assert_array_equal(got[0], greedy[0])


def test_no_new_tokens_runs_the_prefill_alone():
    _, tcfg, _, tparams = _tiny()
    ids = torch.from_numpy(_ids(2, (2, 5), 256)).long()
    gcfg = tgen.GenerateConfig(max_new_tokens=0, do_sample=False, eos_token_id=EOS)
    tokens, num_valid, iters = tgen.generate_speculative(
        tparams, tcfg, gcfg, tq.embed_tokens(tparams, ids), torch.tensor([5, 3]), ids,
        max_len=9, draft_len=4, return_stats=True)
    assert tokens.shape == (2, 0) and num_valid.tolist() == [0, 0] and iters == 0


def test_speculative_checks_its_arguments():
    _, tcfg, _, tparams = _tiny()
    embeds = torch.zeros((1, 4, tcfg.hidden_size))
    ids, lengths = torch.ones((1, 4), dtype=torch.long), torch.tensor([4])
    for gcfg, max_len in ((tgen.GenerateConfig(max_new_tokens=2, do_sample=True), 16),
                          (tgen.GenerateConfig(max_new_tokens=2, do_sample=False,
                                               repetition_penalty=1.1), 16),
                          (tgen.GenerateConfig(max_new_tokens=8, do_sample=False), 15)):
        with pytest.raises(ValueError):
            tgen.generate_speculative(tparams, tcfg, gcfg, embeds, lengths, ids,
                                      max_len=max_len, draft_len=4)


@pytest.mark.parametrize("draft_len", [3, 4])
def test_chat_speculative_matches_jax_chat(draft_len):
    """Chat(speculative_draft_len=d): greedy requests take the speculative
    path (max_len + d columns), with JAX's strings and the port's plain
    greedy strings; a penalized request takes `generate`."""
    from affectgpt_tpu.inference.chat import Chat as JaxChat
    from affectgpt_tpu.tokenization import ByteTokenizer
    from affectgpt_tpu_torch.inference.chat import Chat
    from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer

    from test_torch_chat import MODE, QUESTION, SUBTITLES, _models

    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models()
    rng = np.random.RandomState(draft_len)
    feats = {m: rng.randn(3, 8, d).astype(np.float32) for m, d in
             (("frame", jcfg.visual_dim), ("face", jcfg.visual_dim), ("audio", jcfg.acoustic_dim))}
    kw = dict(max_new_tokens=10, do_sample=False)
    want = JaxChat(jfrozen, jtrain, jcfg, ByteTokenizer(), max_len=512,
                   speculative_draft_len=draft_len).answer_batch(
        MODE, SUBTITLES[:3], QUESTION, {m: jnp.asarray(v) for m, v in feats.items()}, **kw)
    tfeats = {m: torch.from_numpy(v) for m, v in feats.items()}
    chat = Chat(tfrozen, ttrain, tcfg, TorchByteTokenizer(), max_len=512,
                speculative_draft_len=draft_len)
    calls = []
    inner = tgen.generate_speculative
    try:
        tgen.generate_speculative = lambda *a, **k: calls.append(k["max_len"]) or inner(*a, **k)
        got = chat.answer_batch(MODE, SUBTITLES[:3], QUESTION, tfeats, **kw)
        chat.answer_batch(MODE, SUBTITLES[:3], QUESTION, tfeats, repetition_penalty=1.1, **kw)
    finally:
        tgen.generate_speculative = inner
    plain = Chat(tfrozen, ttrain, tcfg, TorchByteTokenizer(), max_len=512).answer_batch(
        MODE, SUBTITLES[:3], QUESTION, tfeats, **kw)
    assert calls == [512 + draft_len]
    assert got == want == plain and len(got) == 3
