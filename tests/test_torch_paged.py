"""The paged KV cache and the paged continuous-batching engine of the port
against the JAX package, in f32 on the CPU, on the same seeded weights and
requests.

- `_quantize_kv` and an int8 `paged_write` are byte-identical to JAX's (the
  JAX scale pools, flat or legacy, reshaped to the port's one layout).
- `BlockAllocator` hands out the same block ids over an
  allocate/extend/free/reserve sequence.
- The kernel's plain version (`ops.paged_attention`, reached through its
  wrappers) against JAX's `paged_attention_pallas` in interpret mode, and
  the gather route against JAX's `paged.paged_attention`, within 1e-5, for
  bf16-layout and int8 pools, ragged seq_lens, a one-token row and a row of
  one full page.
- `PagedBatchServer`: greedy results and `stats` identical to JAX's, for
  fp and int8 pools, reserve and optimistic admission (with preemption),
  chunked prefill, gather-width bucketing, and an int8 weight tree with
  `DECODE_MLP="pallas"` (JAX running its kernel in interpret mode); the
  port under both PAGED_ATTENTION routes. Each JAX server runs once per
  module (cached). The port's paged engine and its dense BatchServer return
  the same tokens on the same requests.
- The submit-time refusals, and the pool dtype of a quantized tree."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference import paged as jpaged
from affectgpt_tpu.inference.server import Request as JRequest
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.ops.paged_attention_pallas import paged_attention_pallas
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch.inference import paged as tpaged
from affectgpt_tpu_torch.inference.server import BatchServer as TBatchServer
from affectgpt_tpu_torch.inference.server import Request as TRequest
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import paged_attention as paged_ops
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TByteTokenizer

TOL = dict(atol=1e-5, rtol=1e-5)


def test_quantize_kv_is_bit_identical():
    """Against JAX's function as its engines run it, compiled: XLA turns
    `amax / 127.0` into a product with f32(1/127), which differs from the
    division in the last bit of about 5% of the scales."""
    rng = np.random.RandomState(0)
    x = rng.randn(400, 3, 5, 64).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0  # an all-zero row: scale 0, values 0
    x[1, 1, 1] = np.round(rng.randn(64) * 20) / 2  # ties at the rounding points
    x[1, 1, 1, 0] = 127.0
    jv, js = jax.jit(jq._quantize_kv)(jnp.asarray(x))
    tv, ts = tq._quantize_kv(torch.from_numpy(x))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _port_scales(pool, name, shape):
    """A JAX scale pool (flat [blocks, block·kv] or legacy [blocks, block,
    kv, 1]) in the port's layout [blocks, block, kv]: the same elements in
    the same order."""
    return np.asarray(pool[name]).reshape(shape)


@pytest.mark.parametrize("block", [4, 64])  # legacy (block·kv < 128) and flat scale layouts
def test_int8_paged_write_is_byte_identical(block):
    cfg = jq.QwenConfig.tiny()
    jcfg = jpaged.PagedConfig(block_size=block, num_blocks=8, max_blocks_per_seq=4)
    tcfg = tpaged.PagedConfig(block_size=block, num_blocks=8, max_blocks_per_seq=4)
    jpool = jpaged.init_paged_cache(cfg, jcfg, dtype=jnp.int8)[0]
    tpool = tpaged.init_paged_cache(tq.QwenConfig.tiny(), tcfg, dtype=torch.int8,
                                    device="cpu")[0]
    rng = np.random.RandomState(1)
    kv, d = cfg.num_kv_heads, cfg.head_dim
    blocks, offs = np.array([1, 2, 5], np.int32), np.array([0, 3, block - 1], np.int32)
    for step in range(2):  # a second write over the first
        k, v = (rng.randn(3, kv, d).astype(np.float32) * (step + 1) for _ in range(2))
        jpool = jpaged.paged_write(jpool, jnp.asarray(k), jnp.asarray(v), jnp.asarray(blocks),
                                   jnp.asarray(offs))
        out = tpaged.paged_write(tpool, torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(blocks).long(), torch.from_numpy(offs).long())
        assert out is tpool  # written in place
    shape = tuple(tpool["k"].shape[:3])
    for name in ("k", "v"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tpool[name].numpy(), _port_scales(jpool, name, shape))


def test_block_allocator_hands_out_the_same_blocks():
    jcfg = jpaged.PagedConfig(block_size=4, num_blocks=16, max_blocks_per_seq=8)
    tcfg = tpaged.PagedConfig(block_size=4, num_blocks=16, max_blocks_per_seq=8)
    ja_, ta_ = jpaged.BlockAllocator(jcfg), tpaged.BlockAllocator(tcfg)
    trace = []
    for alloc in (ja_, ta_):
        a = alloc.allocate(9)
        b = alloc.allocate(4)
        alloc.extend(a, 14)
        alloc.reserve(3)
        avail = alloc.available()
        alloc.free_table(b)
        c = alloc.allocate(7)
        alloc.release(2)
        alloc.extend(c, 16)
        with pytest.raises(RuntimeError):
            alloc.allocate(4 * 12)
        trace.append((a, b, c, avail, alloc.available(), list(alloc.free), alloc.reserved))
    assert trace[0] == trace[1]


def _paged_inputs(seed, b, kv, g, d, blk, width, int8, num_blocks=40):
    rng = np.random.RandomState(seed)
    shape = (num_blocks, blk, kv, d)
    if int8:
        pool_k = rng.randint(-127, 128, shape).astype(np.int8)
        pool_v = rng.randint(-127, 128, shape).astype(np.int8)
        scales = [(rng.rand(*shape[:3]) * 0.02).astype(np.float32) for _ in range(2)]
    else:
        pool_k, pool_v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
        scales = [None, None]
    lens = rng.randint(1, width * blk + 1, size=b).astype(np.int32)
    lens[0], lens[1] = 1, blk  # one token; exactly one full page
    perm = rng.permutation(num_blocks - 1) + 1
    tables = np.zeros((b, width), np.int32)
    used = 0
    for r in range(b):
        n = -(-lens[r] // blk)
        tables[r, :n] = perm[used:used + n]
        used += n
    q = rng.randn(b, kv * g, d).astype(np.float32)
    return q, pool_k, pool_v, tables, lens, scales


CASES = [(4, 2, 3, 16, 4, 5), (5, 2, 2, 8, 4, 8), (3, 1, 4, 32, 8, 3)]  # b, kv, g, d, blk, width


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,kv,g,d,blk,width", CASES)
def test_paged_attention_plain_matches_pallas(int8, b, kv, g, d, blk, width):
    q, pk, pv, tables, lens, (ks, vs) = _paged_inputs(0, b, kv, g, d, blk, width, int8)
    jscales = {} if not int8 else {  # the TPU kernel reads [blocks, kv, block] side pages
        "k_scale": jnp.asarray(ks.transpose(0, 2, 1)), "v_scale": jnp.asarray(vs.transpose(0, 2, 1))}
    want = paged_attention_pallas(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                  jnp.asarray(tables), jnp.asarray(lens), kv, interpret=True,
                                  **jscales)
    args = [torch.from_numpy(a) for a in (q, pk, pv, tables, lens)]
    kernel = paged_ops.paged_attention_int8 if int8 else paged_ops.paged_attention
    before = kernel.launches
    got = kernel(*args, *(torch.from_numpy(s) for s in (ks, vs) if s is not None))
    assert kernel.launches == before  # the CPU takes the plain version, no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("int8,blk", [(False, 4), (True, 4), (True, 64)])
def test_gather_route_matches_jax(int8, blk):
    b, kv, g, d, width = 4, 2, 3, 16, 3
    q, pk, pv, tables, lens, (ks, vs) = _paged_inputs(1, b, kv, g, d, blk, width, int8)
    jscales = (None, None)
    if int8:  # JAX's pools: legacy [blocks, block, kv, 1] or flat [blocks, block·kv]
        layout = (lambda s: s[..., None]) if blk * kv < 128 else \
            (lambda s: s.reshape(s.shape[0], -1))
        jscales = (jnp.asarray(layout(ks)), jnp.asarray(layout(vs)))
    want = jpaged.paged_attention(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                  jnp.asarray(tables), jnp.asarray(lens), kv, *jscales)
    got = tpaged.paged_attention(*(torch.from_numpy(a) for a in (q, pk, pv, tables, lens)), kv,
                                 *(None if s is None else torch.from_numpy(s) for s in (ks, vs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- the engine ------------------------------------------------------------

INT8_LLM = dict(vocab_size=300, hidden_size=128, intermediate_size=512, num_layers=2,
                num_heads=4, num_kv_heads=2, head_dim=32)


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _models(weights: str):
    """(jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain): "lora" keeps LoRA as
    a parallel branch (as JAX's own server tests do); "int8" merges it and
    quantizes the LLM to the int8 split layout, at a geometry where JAX's
    int8 decode-MLP kernel engages (intermediate % 512 == 0)."""
    jcfg, tcfg = ja.AffectGPTConfig.tiny(), ta.AffectGPTConfig.tiny()
    if weights == "int8":
        jcfg = dataclasses.replace(jcfg, llm=jq.QwenConfig(**INT8_LLM))
        tcfg = dataclasses.replace(tcfg, llm=tq.QwenConfig(**INT8_LLM))
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    trainable = jax.tree_util.tree_map_with_path(  # a LoRA that changes the outputs
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" and p[0].key == "lora" else x, trainable)
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg, device="cpu")
    if weights == "int8":
        frozen = {**frozen, "llm": jq.quantize_params(
            jq.merge_lora(frozen["llm"], trainable["lora"], jcfg.llm), bits=8)}
        trainable = {**trainable, "lora": None}
        tfrozen = {**tfrozen, "llm": tq.quantize_params(
            tq.merge_lora(tfrozen["llm"], ttrain["lora"], tcfg.llm), bits=8)}
        ttrain = {**ttrain, "lora": None}
    return jcfg, frozen, trainable, tcfg, tfrozen, ttrain


def _requests(cls, specs, num_query):
    """(request_id, prompt length, max_new_tokens[, face frames]) → requests
    of the JAX or the port's class from the same numpy draws."""
    out = []
    for rid, length, max_new, *frames in specs:
        rng = np.random.RandomState(rid)
        ids = rng.randint(1, 250, length).astype(np.int32)
        ids[2:2 + num_query] = 0
        face = rng.randn(8, 12).astype(np.float32)[:frames[0] if frames else 8]
        out.append(cls(request_id=rid, input_ids=ids, features={"face": face},
                       offsets={"face": 2}, max_new_tokens=max_new))
    return out


STATS = ("admissions", "admitted_requests", "decode_steps", "decode_slot_tokens",
         "decode_bursts", "preemptions", "gather_width_tokens")
# name: (weights, PagedConfig fields, server kwargs, pool dtype, requests)
SERVERS = {
    "fp_reserve": ("lora", (4, 64, 8), dict(max_slots=2), None,
                   [(0, 6, 4), (1, 9, 4), (2, 5, 4), (3, 7, 4, 5)]),
    "int8_pool": ("lora", (8, 64, 16), dict(max_slots=3), "int8",
                  [(0, 9, 4), (1, 14, 4), (2, 11, 6), (3, 7, 5)]),
    "optimistic": ("lora", (4, 9, 8), dict(max_slots=2, admission="optimistic"), None,
                   [(0, 6, 16), (1, 7, 16)]),
    "reserve_tight": ("lora", (4, 9, 8), dict(max_slots=2), None, [(0, 6, 16), (1, 7, 16)]),
    "chunked": ("lora", (8, 96, 8), dict(max_slots=6, prefill_chunk_tokens=20), None,
                [(0, 9, 4), (1, 14, 4), (2, 11, 4), (3, 7, 4), (4, 13, 4)]),
    "wide_tables": ("lora", (4, 128, 16), dict(max_slots=4, decode_burst=4), None,
                    [(i, 9, 8) for i in range(4)]),
    "int8_tree_kernel": ("int8", (8, 64, 8), dict(max_slots=8), None,
                         [(i, 9 + i % 4, 5) for i in range(6)]),
}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    weights, (blk, nblocks, maxb), kw, pool, specs = SERVERS[name]
    jcfg, jfrozen, jtrain = _models(weights)[:3]
    pcfg = jpaged.PagedConfig(block_size=blk, num_blocks=nblocks, max_blocks_per_seq=maxb)
    server = jpaged.PagedBatchServer(jfrozen, jtrain, jcfg, ByteTokenizer(), pcfg=pcfg,
                                     dtype=jnp.int8 if pool else None, **kw)
    for r in _requests(JRequest, specs, jcfg.num_video_query_token):
        server.submit(r)
    return server.run_until_drained(), {k: server.stats.get(k) for k in STATS}


def _port_run(name):
    weights, (blk, nblocks, maxb), kw, pool, specs = SERVERS[name]
    tcfg, tfrozen, ttrain = _models(weights)[3:]
    pcfg = tpaged.PagedConfig(block_size=blk, num_blocks=nblocks, max_blocks_per_seq=maxb)
    server = tpaged.PagedBatchServer(tfrozen, ttrain, tcfg, TByteTokenizer(), pcfg=pcfg,
                                     dtype=torch.int8 if pool else None, **kw)
    for r in _requests(TRequest, specs, tcfg.num_video_query_token):
        server.submit(r)
    out = server.run_until_drained()
    assert server.alloc.reserved == 0 and len(server.alloc.free) == nblocks - 1
    return out, {k: server.stats.get(k) for k in STATS}, server


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("name", [n for n in SERVERS if n != "int8_tree_kernel"])
def test_paged_server_matches_jax(name, route, monkeypatch):
    monkeypatch.setattr(tpaged, "PAGED_ATTENTION", route)
    want, want_stats = _jax_run(name)
    got, stats, server = _port_run(name)
    assert got == want and len(got) == len(SERVERS[name][4])
    assert stats == want_stats
    if name == "optimistic":
        assert stats["preemptions"] >= 1
    if name == "chunked":
        assert stats["admissions"] >= 3
    if name == "wide_tables":  # the tables were cut below max_blocks_per_seq
        assert stats["gather_width_tokens"] < stats["decode_steps"] * server.pcfg.max_seq_len
    summary = server.clock.summary()
    assert summary["requests"] == len(want) and summary["e2e_p50_ms"] >= summary["ttft_p50_ms"]


@pytest.fixture
def jax_int8_mlp_kernel(monkeypatch):
    """JAX's int8 decode-MLP kernel in interpret mode (read at trace time)."""
    monkeypatch.setenv("AFFECTGPT_DECODE_KERNEL_INTERPRET", "1")
    monkeypatch.setattr(jq, "DECODE_MLP", "pallas")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_int8_tree_with_the_mlp_kernel_matches_jax(route, jax_int8_mlp_kernel, monkeypatch):
    monkeypatch.setattr(tq, "DECODE_MLP", "pallas")
    monkeypatch.setattr(tpaged, "PAGED_ATTENTION", route)
    calls = {"decode_mlp": 0}
    inner = tq.decode_mlp

    def counted(*args, **kwargs):
        calls["decode_mlp"] += 1
        return inner(*args, **kwargs)

    monkeypatch.setattr(tq, "decode_mlp", counted)
    want, want_stats = _jax_run("int8_tree_kernel")
    got, stats, _ = _port_run("int8_tree_kernel")
    assert got == want and stats == want_stats
    assert calls["decode_mlp"] == INT8_LLM["num_layers"] * stats["decode_steps"]


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_paged_and_dense_engines_return_the_same_tokens(route, monkeypatch):
    """The paged engine (either attention route) and the dense BatchServer
    are one function of the requests: in f32 their greedy tokens agree, so
    where they part in bf16 on the card, the cause is rounding."""
    monkeypatch.setattr(tpaged, "PAGED_ATTENTION", route)
    got = _port_run("wide_tables")[0]
    tcfg, tfrozen, ttrain = _models("lora")[3:]
    dense = TBatchServer(tfrozen, ttrain, tcfg, TByteTokenizer(), max_slots=4, max_len=64)
    for r in _requests(TRequest, SERVERS["wide_tables"][4], tcfg.num_video_query_token):
        dense.submit(r)
    assert dense.run_until_drained() == got


def test_submit_refusals_match_jax():
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models("lora")
    cases = [((4, 64, 8), [(50, 32, 4)]),  # prompt == max_seq_len
             ((4, 4, 8), [(51, 6, 10_000)]),  # lifetime larger than the pool
             ((4, 64, 8), [(52, 31, 4)])]  # the longest servable prompt
    for (blk, n, maxb), spec in cases:
        verdicts = []
        for mod, cls, cfg, frozen, train, tok in (
                (jpaged, JRequest, jcfg, jfrozen, jtrain, ByteTokenizer()),
                (tpaged, TRequest, tcfg, tfrozen, ttrain, TByteTokenizer())):
            pcfg = mod.PagedConfig(block_size=blk, num_blocks=n, max_blocks_per_seq=maxb)
            server = mod.PagedBatchServer(frozen, train, cfg, tok, pcfg=pcfg, max_slots=2)
            try:
                server.submit(_requests(cls, spec, cfg.num_video_query_token)[0])
                verdicts.append("accepted")
            except ValueError:
                verdicts.append("refused")
        assert verdicts[0] == verdicts[1], (spec, verdicts)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_pool_dtype_comes_from_the_embedding_table(table_dtype):
    """On a quantized tree the first leaves may be int8 values or f32
    scales; the pool takes the embedding table's dtype, whatever the key
    order of the tree."""
    tcfg, tfrozen = _models("int8")[3:5]
    llm = tfrozen["llm"]
    llm = {"layers": llm["layers"], "lm_head": llm["lm_head"], "final_ln": llm["final_ln"],
           "embed_tokens": {"table": llm["embed_tokens"]["table"].to(table_dtype)}}
    server = tpaged.PagedBatchServer({**tfrozen, "llm": llm}, {"lora": None}, tcfg,
                                     TByteTokenizer(), pcfg=tpaged.PagedConfig(num_blocks=8))
    assert server.pools[0]["k"].dtype == table_dtype
    assert tpaged.PagedBatchServer({**tfrozen, "llm": llm}, {"lora": None}, tcfg,
                                   TByteTokenizer(), pcfg=tpaged.PagedConfig(num_blocks=8),
                                   dtype=torch.int8).pools[0]["k_scale"].dtype == torch.float32
