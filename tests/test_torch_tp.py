"""Tensor-parallel serving of the port against the JAX package, in f32 on the
CPU (JAX's tests/test_sharded_inference.py on gloo ranks).

- Shard rules without processes: every leaf of tiny bf16, int8, int4 and
  LoRA trees; the ranks' slices put back together give the leaf (int4
  after unpacking), and each slice is the numpy slice of the JAX tree that
  JAX's `param_spec` names, except where the port departs on purpose (a
  row-parallel int8 leaf's [1, N] scales stay whole, a row-parallel int4
  leaf is repacked on its own K, k/v keep whole kv heads where tp does not
  divide them).
- Ranks: tests/torch_tp_worker.py on two and four gloo processes (each with
  its own timeout of WORKER_TIMEOUT s), all started together: `generate` at
  tp = 2 and 4 with LoRA as a branch and merged gives JAX single-device
  `generate`'s tokens exactly and the prompt's logits within 1e-5; the int8
  and int4 trees at tp = 2 (a narrow geometry whose shards keep K % 256);
  BatchServer and PagedBatchServer at tp = 2 give JAX's engines' tokens on
  `_make_requests`'s list; Chat's speculative answers equal its greedy
  ones; dp 2 x tp 2 gives JAX's replicated tokens, and the towers
  batch-parallel over dp give one rank's features. Every rank of a case
  holds the same outputs.
- `inference_hybird --tp 2 --device cpu` writes the answers of `--tp 1`.
- The residual-free plain versions of rows 2, 4 and 10 summed over their
  shards, plus x, give the fused ones; the int4 limit at tp = 4 raises.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.inference.paged import PagedBatchServer as JPaged
from affectgpt_tpu.inference.paged import PagedConfig as JPagedConfig
from affectgpt_tpu.inference.server import BatchServer as JServer
from affectgpt_tpu.inference.server import Request as JRequest
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.parallel import mesh as jmesh
from affectgpt_tpu.tokenization import ByteTokenizer as JByteTokenizer
from affectgpt_tpu_torch import paths as tpaths
from affectgpt_tpu_torch.inference.chat import Chat
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import clip_vit, convert, hubert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import quant
from affectgpt_tpu_torch.ops.decode_attn_o import decode_attn_o_reference
from affectgpt_tpu_torch.ops.decode_mlp import decode_mlp_reference
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16_reference
from affectgpt_tpu_torch.parallel import mesh
from affectgpt_tpu_torch.tokenization import ByteTokenizer
from affectgpt_tpu_torch.training import checkpoint

REPO = Path(__file__).resolve().parent.parent
WORKER_TIMEOUT = 300
LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
# a geometry whose row-parallel leaves keep the int4 kernels' K % 256 at tp = 2
QLLM = dict(vocab_size=512, hidden_size=256, intermediate_size=1024, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=128, rope_theta=10_000.0,
            lora_r=2, lora_alpha=4.0)
NEW, MAX_LEN, EOS = 6, 16, 257
CASES = {"tp2": 2, "tp4": 4, "dp2tp2": 4}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def jax_models():
    """The tiny model of JAX's tests with a LoRA B that changes the outputs."""
    cfg = ja.AffectGPTConfig.tiny()
    frozen = ja.init_frozen(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), cfg)
    rng = np.random.RandomState(2)
    trainable = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" and p[0].key == "lora" else x, trainable)
    return cfg, frozen, trainable


@functools.lru_cache(maxsize=None)
def jax_quant_trees():
    """(f32 params, {bits: JAX's quantize_params of them}) at QLLM."""
    params = jq.init_params(jax.random.PRNGKey(0), jq.QwenConfig(**QLLM), dtype=jnp.float32)
    return params, {bits: jq.quantize_params(params, bits=bits) for bits in (8, 4)}


def prompts():
    rng = np.random.RandomState(3)
    return (rng.randint(1, 250, (2, 7)).astype(np.int32), np.array([7, 5], np.int32),
            rng.randint(1, 250, (4, 9)).astype(np.int32), np.array([9, 5, 7, 8], np.int32),
            rng.randint(1, 500, (2, 6)).astype(np.int32), np.array([6, 4], np.int32))


def make_requests(cfg, lengths=(6, 9, 5)):
    """JAX's `_make_requests` (tests/test_sharded_inference.py:38-51), as kwargs."""
    reqs = []
    for rid, length in enumerate(lengths):
        rng = np.random.RandomState(rid)
        ids = rng.randint(1, 250, length).astype(np.int32)
        ids[2:2 + cfg.num_video_query_token] = 0
        reqs.append(dict(request_id=rid, input_ids=ids,
                         features={"face": rng.randn(8, cfg.visual_dim).astype(np.float32)},
                         offsets={"face": 2}, max_new_tokens=4))
    return reqs


@functools.lru_cache(maxsize=None)
def jax_references():
    """JAX single-device outputs the ranks are held to."""
    cfg, frozen, trainable = jax_models()
    ids, lengths, ids4, lengths4, qids, qlengths = prompts()
    gcfg = jgen.GenerateConfig(max_new_tokens=NEW, do_sample=False, eos_token_id=EOS)
    merged = jq.merge_lora(frozen["llm"], trainable["lora"], cfg.llm)
    out = {}
    for name, llm, lora in (("unmerged", frozen["llm"], trainable["lora"]),
                            ("merged", merged, None)):
        for key, i, n in (("gen", ids, lengths), ("gen4", ids4, lengths4)):
            toks, valid = jgen.generate(llm, cfg.llm, gcfg, jq.embed_tokens(llm, jnp.asarray(i)),
                                        jnp.asarray(n), jax.random.PRNGKey(3), max_len=MAX_LEN,
                                        lora=lora)
            out[name, key] = (np.asarray(toks), np.asarray(valid))
        valid = np.arange(ids.shape[1])[None, :] < lengths[:, None]
        logits, _ = jq.forward(llm, cfg.llm, jq.embed_tokens(llm, jnp.asarray(ids)),
                               jnp.asarray(valid), lora=lora)
        out[name, "logits"] = np.asarray(logits)
    qcfg = jq.QwenConfig(**QLLM)
    qgcfg = jgen.GenerateConfig(max_new_tokens=NEW, do_sample=False, eos_token_id=1)
    for bits, tree in jax_quant_trees()[1].items():
        toks, valid = jgen.generate(tree, qcfg, qgcfg, jq.embed_tokens(tree, jnp.asarray(qids)),
                                    jnp.asarray(qlengths), jax.random.PRNGKey(3), max_len=16)
        out[f"q{bits}"] = (np.asarray(toks), np.asarray(valid))
    tok = JByteTokenizer()
    pcfg = JPagedConfig(block_size=4, num_blocks=64, max_blocks_per_seq=8)
    for name, engine in (("server", JServer(frozen, trainable, cfg, tok, max_slots=2,
                                            max_len=64)),
                         ("paged", JPaged(frozen, trainable, cfg, tok, pcfg=pcfg, max_slots=2))):
        for r in make_requests(cfg):
            engine.submit(JRequest(**r))
        out[name] = engine.run_until_drained()
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_inputs():
    """What every worker reads: the port's trees of the JAX weights, the
    prompts, the requests, and the realtime case's towers and media."""
    cfg, frozen, trainable = jax_models()
    tcfg = ta.AffectGPTConfig.tiny()
    tfrozen, ttrain = convert.from_jax(np_tree(frozen), np_tree(trainable), tcfg, device="cpu")
    ids, lengths, ids4, lengths4, qids, qlengths = prompts()
    params, qtrees = jax_quant_trees()
    g = torch.Generator().manual_seed(4)
    vision_cfg, audio_cfg = clip_vit.ClipVisionConfig.tiny(), hubert.HubertConfig.tiny()
    rt_frozen = {**tfrozen,
                 "visual_encoder": clip_vit.init_vision_params(g, vision_cfg, torch.float32),
                 "acoustic_encoder": hubert.init_params(g, audio_cfg, torch.float32)}
    rng = np.random.RandomState(7)
    b, t = 8, 24
    rt_ids = rng.randint(1, 250, (b, t))
    offsets = {"multi": 2, "audio": 5, "face": 9, "frame": 13}
    for m, off in offsets.items():
        rt_ids[:, off:off + tcfg.num_query_tokens(m)] = 0
    as_t = torch.as_tensor
    return {
        "cfg": tcfg, "frozen": tfrozen, "trainable": ttrain,
        "merged_frozen": {**tfrozen, "llm": tq.merge_lora(tfrozen["llm"], ttrain["lora"],
                                                         tcfg.llm)},
        "ids": as_t(ids, dtype=torch.long), "lengths": as_t(lengths, dtype=torch.long),
        "ids4": as_t(ids4, dtype=torch.long), "lengths4": as_t(lengths4, dtype=torch.long),
        "valid": as_t(np.arange(ids.shape[1])[None, :] < lengths[:, None]),
        "new": NEW, "eos": EOS, "max_len": MAX_LEN,
        "qcfg": tq.QwenConfig(**QLLM), "qbase": convert.tree_to_torch(np_tree(params), "cpu"),
        "q8": convert.tree_to_torch(np_tree(qtrees[8]), "cpu"),
        "q4": convert.tree_to_torch(np_tree(qtrees[4]), "cpu"),
        "qids": as_t(qids, dtype=torch.long), "qlengths": as_t(qlengths, dtype=torch.long),
        "requests": make_requests(tcfg),
        "subtitles": ["hello there", "so sad"],
        "chat_features": {"frame": torch.randn(2, 8, tcfg.visual_dim, generator=g)},
        "rt_cfg": tcfg, "rt_frozen": rt_frozen, "vision_cfg": vision_cfg,
        "audio_cfg": audio_cfg,
        "raw": {"frame": as_t(rng.randint(0, 255, (b, 2, 28, 28, 3)), dtype=torch.uint8),
                "face": as_t(rng.randint(0, 255, (b, 2, 28, 28, 3)), dtype=torch.uint8),
                "audio": as_t(rng.randn(b, 2, 1, 800).astype(np.float32))},
        "rt_ids": as_t(rt_ids, dtype=torch.long),
        "rt_offsets": {m: torch.full((b,), off, dtype=torch.long) for m, off in offsets.items()},
        "rt_lengths": torch.full((b,), t, dtype=torch.long),
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: [each rank's outputs]}: every case's ranks run at once."""
    out = tmp_path_factory.mktemp("tp")
    torch.save(worker_inputs(), out / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = []
    for case, world in CASES.items():
        address = f"tcp://localhost:{free_port()}"
        procs += [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_tp_worker.py"),
                                    address, str(world), str(rank), case, str(out)],
                                   cwd=REPO, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for rank in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for proc in procs:
            proc.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return {case: [torch.load(out / f"{case}_rank{r}.pt", weights_only=False)
                   for r in range(world)] for case, world in CASES.items()}


# ---------------------------------------------------------------------------
# Shard rules


def jax_trees():
    cfg, frozen, trainable = jax_models()
    bf16 = ja.init_frozen(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)["llm"]
    _, qtrees = jax_quant_trees()
    return {"bf16": ({"llm": bf16}, cfg.llm), "int8": ({"llm": qtrees[8]}, jq.QwenConfig(**QLLM)),
            "int4": ({"llm": qtrees[4]}, jq.QwenConfig(**QLLM)),
            "lora": ({"lora": trainable["lora"]}, cfg.llm)}


def path_str(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def get_leaf(tree, name: str):
    for key in name.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def spec_slice(arr: np.ndarray, spec, tp: int, r: int) -> np.ndarray:
    """The numpy slice of rank r of a tp axis under a JAX PartitionSpec."""
    for axis, name in enumerate(spec):
        if name == "tp":
            n = arr.shape[axis] // tp
            arr = np.take(arr, range(r * n, (r + 1) * n), axis=axis)
    return arr


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def unpacked(t: torch.Tensor) -> np.ndarray:
    return quant._int4_values(t).numpy()


@pytest.mark.parametrize("tree,tp", [("bf16", 2), ("bf16", 4), ("int8", 2), ("int8", 4),
                                     ("int4", 2), ("lora", 2), ("lora", 4)])
def test_shard_rules_slice_as_jax_param_spec(tree, tp):
    jtree, jcfg = jax_trees()[tree]
    cfg = tq.QwenConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    whole = convert.tree_to_torch(np_tree(jtree), "cpu")
    shards = [mesh.shard_params(whole, mesh.Layout(tp, r, torch.device("cpu"), tp=tp), cfg)
              for r in range(tp)]
    departures = 0
    for path, jleaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        name = full = path_str(path)
        leaf = get_leaf(whole, name)
        slices = [get_leaf(s, name) for s in shards]
        kind = mesh.leaf_kind(full)
        key = name.rsplit("/", 1)[-1]
        siblings = get_leaf(whole, name.rsplit("/", 1)[0])
        spec = jmesh.param_spec(path, jleaf)
        if kind is None:
            assert all(s is leaf for s in slices), full
            assert all(name != "tp" for name in spec), full
            continue
        if kind == "row" and key == "w_q4":  # repacked on the rank's K
            np.testing.assert_array_equal(np.concatenate([unpacked(s) for s in slices]),
                                          unpacked(leaf))
            departures += 1
            continue
        if kind == "row" and key == "scales" and "w_q" in siblings:  # int8 [1, N]: whole
            assert all(s is leaf for s in slices), full
            departures += 1
            continue
        if kind == "col" and mesh._KV.search(full) and cfg.num_kv_heads % tp:
            # whole kv heads: the one each rank's query heads read
            d = leaf.shape[-1] // cfg.num_kv_heads
            for r, s in enumerate(slices):
                head = r * (cfg.num_heads // tp) // (cfg.num_heads // cfg.num_kv_heads)
                np.testing.assert_array_equal(as_np(s), as_np(leaf)[..., head * d:(head + 1) * d])
            departures += 1
            continue
        axis = 0 if kind == "row" else leaf.ndim - 1
        np.testing.assert_array_equal(np.concatenate([as_np(s) for s in slices], axis=axis),
                                      as_np(leaf), err_msg=full)
        for r, s in enumerate(slices):
            np.testing.assert_array_equal(as_np(s), spec_slice(np.asarray(jleaf, np.float32)
                                                               if jleaf.dtype == jnp.bfloat16
                                                               else np.asarray(jleaf),
                                                               spec, tp, r), err_msg=full)
    assert departures == 0 or tree in ("int8", "int4") or tp == 4


def test_int4_shards_at_tp4_raise_naming_the_limit():
    _, qtrees = jax_quant_trees()
    whole = convert.tree_to_torch(np_tree(qtrees[4]), "cpu")
    layout = mesh.Layout(4, 0, torch.device("cpu"), tp=4)
    with pytest.raises(ValueError, match="K % 256"):
        mesh.shard_params(whole, layout, tq.QwenConfig(**QLLM), "llm/")
    params = convert.tree_to_torch(np_tree(jax_quant_trees()[0]), "cpu")
    shard = mesh.shard_params(params, layout, tq.QwenConfig(**QLLM), "llm/")
    with pytest.raises(ValueError, match="K % 256"):
        tq.quantize_params(shard, bits=4, cfg=mesh.shard_config(tq.QwenConfig(**QLLM), layout))


def test_fused_layout_and_uneven_heads_refuse_to_shard():
    cfg = tq.QwenConfig.tiny()
    params = tq.init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    layout = mesh.Layout(2, 0, torch.device("cpu"), tp=2)
    with pytest.raises(ValueError, match="one rank only"):
        mesh.shard_params(tq.fuse_qkv_gateup(params, cfg), layout, cfg, "llm/")
    with pytest.raises(ValueError, match="does not divide"):
        mesh.shard_config(cfg, mesh.Layout(3, 0, torch.device("cpu"), tp=3))


# ---------------------------------------------------------------------------
# Residual-free plain versions (rows 2, 4, 10)


def _split(t: torch.Tensor, tp: int, dim: int) -> list:
    return list(t.chunk(tp, dim=dim))


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("row", ["decode_mlp_bf16", "decode_attn_o", "decode_mlp"])
def test_residual_free_partials_sum_to_the_fused_plain_version(row, tp):
    g = torch.Generator().manual_seed(5)
    b, h, inter = 3, 64, 256

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    x = rnd(b, h)
    if row == "decode_attn_o":
        kv, groups, d, t_len = 4, 2, 16, 9
        q, k, v = rnd(b, kv, groups, d), rnd(b, kv, t_len, d), rnd(b, kv, t_len, d)
        mask = torch.arange(t_len)[None, :] >= torch.tensor([0, 2, 5])[:, None]
        wo = rnd(kv * groups * d, h, scale=0.1)
        fused = decode_attn_o_reference(x, q, k, v, mask, wo)
        parts = [decode_attn_o_reference(x, qs, ks, vs, mask, ws, residual=False)
                 for qs, ks, vs, ws in zip(_split(q, tp, 1), _split(k, tp, 1), _split(v, tp, 1),
                                           _split(wo, tp, 0))]
    else:
        ln = 1.0 + rnd(h, scale=0.1)
        if row == "decode_mlp_bf16":
            wg, wu, wd = rnd(h, inter, scale=0.1), rnd(h, inter, scale=0.1), rnd(inter, h,
                                                                                  scale=0.1)
            fused = decode_mlp_bf16_reference(x, ln, wg, wu, wd)
            parts = [decode_mlp_bf16_reference(x, ln, a, u, dn, residual=False)
                     for a, u, dn in zip(_split(wg, tp, 1), _split(wu, tp, 1), _split(wd, tp, 0))]
        else:
            (wg, sg), (wu, su), (wd, sd) = (quant.quantize_per_channel(rnd(*s, scale=0.1))
                                            for s in ((h, inter), (h, inter), (inter, h)))
            fused = decode_mlp_reference(x, ln, wg, sg, wu, su, wd, sd)
            parts = [decode_mlp_reference(x, ln, a, sa, u, su_, dn, sd, residual=False)
                     for a, sa, u, su_, dn in zip(_split(wg, tp, 1), _split(sg, tp, 1),
                                                  _split(wu, tp, 1), _split(su, tp, 1),
                                                  _split(wd, tp, 0))]
    got = x + torch.stack(parts).sum(dim=0)  # the all-reduce, then the residual once
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Ranks


def _same_on_every_rank(outs, key):
    first = outs[0][key]
    for other in outs[1:]:
        if isinstance(first, dict):
            assert other[key] == first
        else:
            for a, b in zip(first, other[key]):
                assert torch.equal(a, b)


@pytest.mark.parametrize("lora", ["unmerged", "merged"])
@pytest.mark.parametrize("case", ["tp2", "tp4"])
def test_tp_generate_matches_jax_single_device(ranks, case, lora):
    ref = jax_references()
    for out in ranks[case]:
        for key in ("gen", "gen4"):
            toks, valid = out[lora][key]
            np.testing.assert_array_equal(toks.numpy(), ref[lora, key][0])
            np.testing.assert_array_equal(valid.numpy(), ref[lora, key][1])
        np.testing.assert_allclose(out[lora]["logits"].numpy(), ref[lora, "logits"],
                                   **LOGITS_TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_tp2_quantized_trees_match_jax(ranks, bits):
    ref = jax_references()[f"q{bits}"]
    for out in ranks["tp2"]:
        toks, valid = out[f"q{bits}"]
        np.testing.assert_array_equal(toks.numpy(), ref[0])
        np.testing.assert_array_equal(valid.numpy(), ref[1])
        assert out[f"requant{bits}"]  # quantizing the shard = the shard of the quantized tree


@pytest.mark.parametrize("engine", ["server", "paged"])
def test_tp2_engines_match_jax_single_device(ranks, engine):
    want = jax_references()[engine]
    assert set(want) == {0, 1, 2}
    for out in ranks["tp2"]:
        assert out[engine] == want


def test_tp2_chat_speculative_gives_greedy_answers(ranks):
    _, frozen, trainable = jax_models()
    tcfg = ta.AffectGPTConfig.tiny()
    tfrozen, ttrain = convert.from_jax(np_tree(frozen), np_tree(trainable), tcfg, device="cpu")
    inputs = worker_inputs()
    one_rank = Chat(inputs["merged_frozen"], {**ttrain, "lora": None}, tcfg, ByteTokenizer(),
                    max_len=512).answer_batch("frame", inputs["subtitles"], "why?",
                                             inputs["chat_features"], max_new_tokens=8,
                                             do_sample=False)
    for out in ranks["tp2"]:
        assert out["chat_spec"] == out["chat_greedy"] == one_rank


def test_dp2_tp2_generate_matches_jax_replicated(ranks):
    ref = jax_references()
    for out in ranks["dp2tp2"]:
        for key in ("gen", "gen4"):
            toks, valid = out["unmerged"][key]
            np.testing.assert_array_equal(toks.numpy(), ref["unmerged", key][0])
            np.testing.assert_array_equal(valid.numpy(), ref["unmerged", key][1])


def test_dp2_realtime_encode_matches_one_rank(ranks):
    outs = ranks["dp2tp2"]
    for out in outs:
        assert set(out["feats"]) == {"frame", "face", "audio"}
        for m, f in out["feats"].items():
            np.testing.assert_allclose(f.numpy(), out["alone"][m].numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(out["rt_tokens"], out["rt_alone_tokens"])


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_holds_the_same_outputs(ranks, case):
    outs = ranks[case]
    for key in ("gen", "gen4"):
        for lora in ("unmerged",) + (("merged",) if case != "dp2tp2" else ()):
            for a, b in zip(outs[0][lora][key], outs[-1][lora][key]):
                assert torch.equal(a, b)
    if case == "tp2":
        for key in ("server", "paged", "chat_spec"):
            assert all(o[key] == outs[0][key] for o in outs)


# ---------------------------------------------------------------------------
# inference_hybird --tp


MODEL = {"llama_model": "Qwen25", "preextracted_visual_dim": 12,
         "preextracted_acoustic_dim": 16, "num_video_query_token": 2,
         "num_audio_query_token": 2, "num_multi_query_token": 1, "lora_r": 2,
         "skip_encoders": True}


def hybird_setup(tmp_path):
    """A JSON config over tests/synth_corpus.py's corpus (tiny random LLM,
    its `paths:` section naming the corpus) and a checkpoint whose LoRA
    changes the answers."""
    from affectgpt_tpu_torch import bootstrap
    from tests.synth_corpus import build_corpus

    overrides, feat_root = build_corpus(tmp_path)
    raw = {
        "model": MODEL,
        "datasets": {"mer2023": {"face_or_frame": "multiface_audio_face_frame_text",
                                 "use_preextracted_frame": True, "use_preextracted_face": True,
                                 "use_preextracted_audio": True, "preextracted_root": feat_root,
                                 "max_length": 640}},
        "run": {"output_dir": str(tmp_path / "output")},
        "inference": {"face_or_frame": "multiface_audio_face_frame_text"},
        "paths": overrides,
    }
    (tmp_path / "exp_inf.json").write_text(json.dumps(raw))
    saved = {k: dict(v) for k, v in tpaths.TABLES.items()}
    try:
        _, _, trainable, _ = bootstrap.build_model(MODEL, device="cpu", dtype=torch.float32)
    finally:
        for k, v in saved.items():
            tpaths.TABLES[k].clear()
            tpaths.TABLES[k].update(v)
    g = torch.Generator().manual_seed(6)
    for layer in trainable["lora"]["layers"]:
        for leaf in layer.values():
            leaf["b"] = torch.randn(leaf["b"].shape, generator=g) * 0.05
    run = tmp_path / "run"
    checkpoint.save_checkpoint(str(run), 0, trainable, loss=1.0)
    return str(tmp_path / "exp_inf.json"), str(run)


def read_answers(cwd: Path) -> dict:
    with np.load(cwd / "output" / "results" / "exp_inf" / "result-mer2023" / "0.npz",
                 allow_pickle=True) as npz:
        return npz["name2reason"].tolist()


@pytest.mark.parametrize("flags", [[], ["--paged", "--paged_block_size", "8", "--int8",
                                        "--no_merge_lora"]])
def test_inference_hybird_tp2_writes_the_answers_of_tp1(tmp_path, monkeypatch, flags):
    from affectgpt_tpu_torch import bootstrap
    from affectgpt_tpu_torch import inference_hybird as thybird

    cfg_path, run = hybird_setup(tmp_path)
    argv = ["--cfg-path", cfg_path, "--dataset", "MER2023", "--batch_size", "2",
            "--max_new_tokens", "6", "--greedy", "--ckpt_root", run, "--device", "cpu", *flags]
    tp2 = tmp_path / "tp2"
    tp2.mkdir()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_tp_worker.py"),
                             "hybird", *argv, "--tp", "2"], cwd=tp2, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    tp1 = tmp_path / "tp1"
    tp1.mkdir()
    monkeypatch.chdir(tp1)
    monkeypatch.setattr(thybird, "build_model",
                        functools.partial(bootstrap.build_model, dtype=torch.float32))
    saved = {k: dict(v) for k, v in tpaths.TABLES.items()}
    try:
        thybird.main(argv)
    finally:
        for k, v in saved.items():
            tpaths.TABLES[k].clear()
            tpaths.TABLES[k].update(v)
        try:
            log = proc.communicate(timeout=WORKER_TIMEOUT)[0]
        finally:
            proc.kill()
    assert proc.returncode == 0, log[-4000:]
    want = read_answers(tp1)
    assert len(want) == 3 and any(want.values())
    assert read_answers(tp2) == want
