"""The port's quantization formats and quantized-matmul plain versions
against the JAX package, on the same seeded numpy inputs, in f32.

Formats must be byte-identical (int8 values) with scales within 1e-7. Each
plain version is held against the JAX Pallas kernel in interpret mode with
the kernel's default blocks, atol = rtol = 1e-4: both sides compute the same
function and differ only in the order of f32 sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.ops import quant as jquant
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.ops import quant

TOL = dict(atol=1e-4, rtol=1e-4)
# the geometry of tests/test_quant.py:131-135: the smallest at which every
# projection has int4 leaves (K % 256 == 0)
LLM = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
           num_heads=4, num_kv_heads=2, head_dim=64, rope_theta=10_000.0,
           lora_r=2, lora_alpha=4.0)


def _weights(k, n, seed=0, scale=0.05):
    return (np.random.default_rng(seed).normal(size=(k, n)) * scale).astype(np.float32)


@pytest.mark.parametrize("k,n", [(64, 128), (1024, 384)])
def test_quantize_per_channel_matches_jax(k, n):
    w = _weights(k, n)
    jw, js = jquant.quantize_per_channel(jnp.asarray(w))
    tw, ts = quant.quantize_per_channel(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts.dtype == torch.float32 and tuple(ts.shape) == (1, n)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


@pytest.mark.parametrize("k,n", [(256, 128), (1024, 384)])
def test_quantize_int4_grouped_matches_jax(k, n):
    w = _weights(k, n, seed=1)
    jw, js = jquant.quantize_int4_grouped(jnp.asarray(w))
    tw, ts = quant.quantize_int4_grouped(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and tuple(tw.shape) == (k // 2, n)
    assert tuple(ts.shape) == (k // quant.INT4_GROUP, n)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    lo, hi = quant._unpack_int4(tw)
    jlo, jhi = jquant._unpack_int4(np.asarray(jw, dtype=np.int32))
    np.testing.assert_array_equal(lo.numpy(), jlo)
    np.testing.assert_array_equal(hi.numpy(), jhi)
    assert int(lo.min()) >= -7 and int(hi.max()) <= 7


def test_unpack_int4_matches_jax_on_every_byte():
    """The port's one nibble decoder (int8 shifts, the dequantize route and
    the plain versions use it) against JAX's (int32 mask and xor)."""
    packed = np.arange(-128, 128, dtype=np.int32)
    lo, hi = quant._unpack_int4(torch.from_numpy(packed.astype(np.int8)))
    jlo, jhi = jquant._unpack_int4(jnp.asarray(packed))
    assert lo.dtype == hi.dtype == torch.int8
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    values = quant._int4_values(torch.from_numpy(packed.astype(np.int8))[:, None])
    np.testing.assert_array_equal(values[:, 0].numpy(), np.concatenate([jlo, jhi]))


def test_quantize_int4_grouped_rejects_ungroupable_k():
    with pytest.raises(ValueError):
        quant.quantize_int4_grouped(torch.zeros(384, 8))  # K/2 = 192 is not a multiple of 128


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_dense_tree_matches_jax(bits):
    """Mirrors tests/test_quant.py:121-128: a K = 8 leaf falls back to int8
    at bits=4, biases and non-dense leaves are kept."""
    rng = np.random.default_rng(2)
    tree = {
        "big": {"w": rng.normal(size=(256, 16)).astype(np.float32),
                "b": rng.normal(size=16).astype(np.float32)},
        "small": {"w": rng.normal(size=(8, 16)).astype(np.float32)},
        "input_ln": {"scale": np.ones(8, np.float32)},
        "layers": [{"o_proj": {"w": rng.normal(size=(512, 32)).astype(np.float32)}}],
    }
    want = jax.tree.map(np.asarray, jquant.quantize_dense_tree(
        jax.tree.map(jnp.asarray, tree), bits=bits))
    got = quant.quantize_dense_tree(jax.tree.map(torch.from_numpy, tree), bits=bits)
    big_key = "w_q4" if bits == 4 else "w_q"
    assert set(got["big"]) == {big_key, "scales", "b"} and set(got["small"]) == {"w_q", "scales"}
    assert set(got["layers"][0]["o_proj"]) == {big_key, "scales"}
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _structure(tree):
    return [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("fused", [False, True, "qkv"], ids=["split", "fused", "fused_qkv"])
@pytest.mark.parametrize("bits", [4, 8])
def test_init_quantized_params_structure_matches_jax(bits, fused):
    jcfg, tcfg = jq.QwenConfig(**LLM), tq.QwenConfig(**LLM)
    want = jq.init_quantized_params(jax.random.PRNGKey(0), jcfg, bits=bits, fused=fused)
    got = tq.init_quantized_params(torch.Generator().manual_seed(0), tcfg, bits=bits,
                                   fused=fused)
    assert _structure(got) == _structure(jax.tree.map(np.asarray, want))
    for layer in got["layers"] + [{"lm_head": got["lm_head"]}]:
        for leaf in (v for v in layer.values() if "scales" in v):
            k = 2 * leaf["w_q4"].shape[0] if "w_q4" in leaf else leaf["w_q"].shape[0]
            sigma = 1.0 / k ** 0.5
            if "w_q4" in leaf:
                lo, hi = quant._unpack_int4(leaf["w_q4"])
                values = torch.cat([lo, hi])
                assert -7 <= int(values.min()) and int(values.max()) <= 7
                expect = 3.0 * sigma / 7.0
            else:
                assert -127 <= int(leaf["w_q"].min()) and int(leaf["w_q"].max()) <= 127
                expect = 3.0 * sigma / 127.0
            assert torch.all(leaf["scales"] == torch.tensor(expect, dtype=torch.float32))


def _x(m, k, seed=3):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


# (kernel, M, K, N): the M each kernel is routed (the weight-only kernels
# also at the speculative verify's M = 40 and bench.py's 7B batch of 256,
# which the card runs on csrc/quant_wgmma.cuh), K = 1024 gives the int4
# kernels two groups per nibble half and w8a8 two activation blocks of its
# default block_k (512)
PALLAS_CASES = [
    ("int8_matmul", 8, 1024, 256), ("int8_matmul", 16, 1024, 256),
    ("int8_matmul", 40, 1024, 256), ("int8_matmul", 256, 1024, 256),
    ("int4_matmul", 16, 1024, 256), ("int4_matmul", 32, 1024, 256),
    ("int4_matmul", 40, 1024, 256), ("int4_matmul", 256, 1024, 256),
    ("int4_matmul_smallm", 1, 1024, 256), ("int4_matmul_smallm", 3, 1024, 256),
    ("int4_matmul_smallm", 8, 1024, 256),
    ("int8_matmul_w8a8", 1, 1024, 256), ("int8_matmul_w8a8", 8, 1024, 256),
    ("int8_matmul_w8a8", 16, 1024, 256),
]


@pytest.mark.parametrize("name,m,k,n", PALLAS_CASES)
def test_plain_version_matches_pallas_kernel(name, m, k, n):
    w = _weights(k, n, seed=4)
    bits = 4 if name.startswith("int4") else 8
    q, s = (jquant.quantize_int4_grouped if bits == 4 else jquant.quantize_per_channel)(
        jnp.asarray(w))
    x = _x(m, k)
    want = np.asarray(getattr(jquant, name)(jnp.asarray(x), q, s, interpret=True))
    quant_launches = getattr(quant, name).launches
    got = getattr(quant, name)(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                               torch.from_numpy(np.array(s)))
    assert got.dtype == torch.float32 and getattr(quant, name).launches == quant_launches
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _w8a8_swapab_emulation(x, w_q, scales, plan):
    """csrc/quant_swapab.cu's w8a8 mode in its arithmetic, f32 out: x
    quantized per (row, qblock) (sx = max(absmax, 1e-8) / 127 by IEEE
    division, xq = clip(round half to even(x / sx))); each qblock's int8 x
    int8 sum exact (int64 here, int32 on the card: at most 512 x 127^2),
    converted to f32 and times the row's sx; each cluster rank adds the
    terms of its qblocks (`unit_ranges`) in order, from 0; the ranks'
    partials are summed in rank order, from 0, then times scales (the card
    may fuse a product and its sum into one FMA: a rounding apart)."""
    m, k = x.shape
    qblock = plan["qblock"]
    xf = x.float().reshape(m, k // qblock, qblock)
    sx = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / sx[..., None]), -127, 127).to(torch.int64)
    w = w_q.to(torch.int64).reshape(k // qblock, qblock, -1)
    total = torch.zeros((m, w.shape[-1]), dtype=torch.float32)
    for u0, u1 in plan["unit_ranges"]:
        part = torch.zeros_like(total)
        for b in range(u0, u1):
            part = part + (xq[:, b] @ w[b]).float() * sx[:, b:b + 1]
        total = total + part
    return total * scales.float()


def _w8a8_shares(m, k, n, sms):
    """The K shares of a w8a8 launch's cluster ranks: the decode kernel's
    plan at M <= 16, above it the wgmma mode's (its pair ranges in qblock
    units: each batch block's rows are its own, as the quantization and the
    sums are per row)."""
    if m <= quant.SWAPAB_MAX_M:
        return quant.w8a8_swapab_plan(m, n, k, sms)
    plan = quant.wgmma_plan(m, n, k, sms, quant.MODE_W8A8)
    qbu = plan["qblock_units"]
    assert plan["cb"] * plan["nb"] >= m
    return {"qblock": plan["qblock"], "cluster": plan["cluster"],
            "unit_ranges": [(u0 // qbu, u1 // qbu) for u0, u1 in plan["unit_ranges"]]}


@pytest.mark.parametrize("m", [1, 8, 13, 16, 40, 64])
@pytest.mark.parametrize("k,n,sms", [(1024, 256, 132), (3584, 384, 8)])
def test_w8a8_swapab_emulation_matches_pallas_kernel(m, k, n, sms):
    """The w8a8 kernels' arithmetic on their plans' K shares against JAX's
    Pallas kernel in interpret mode and the plain version: two qblocks over
    a cluster of two, and seven qblocks split unevenly over a cluster (the
    plans for an 8-SM card: the decode kernel's (1, 1, 2, 1, 2) over five,
    which holds no three clusters of seven; the wgmma mode's (1, 1, 2, 1, 2)
    at M = 40 and (3, 4) at M = 64)."""
    plan = _w8a8_shares(m, k, n, sms)
    shares = [u1 - u0 for u0, u1 in plan["unit_ranges"]]
    assert plan["cluster"] > 1 and (k == 1024 or len(set(shares)) > 1)
    q, s = jquant.quantize_per_channel(jnp.asarray(_weights(k, n, seed=11)))
    x = _x(m, k, seed=12)
    want = np.asarray(jquant.int8_matmul_w8a8(jnp.asarray(x), q, s, interpret=True))
    got = _w8a8_swapab_emulation(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                                 torch.from_numpy(np.array(s)), plan)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), quant.int8_matmul_w8a8(
        torch.from_numpy(x), torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))).numpy(),
        **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_route_matches_jax_xla_function(bits):
    """int8_matmul_xla / int4_matmul_xla, the route of M above
    PALLAS_DEQUANT_MAX_M, against the JAX functions of the same name."""
    w = _weights(512, 384, seed=5)
    fn = "int4_matmul_xla" if bits == 4 else "int8_matmul_xla"
    q, s = (jquant.quantize_int4_grouped if bits == 4 else jquant.quantize_per_channel)(
        jnp.asarray(w))
    x = _x(40, 512, seed=6)
    want = np.asarray(getattr(jquant, fn)(jnp.asarray(x), q, s))
    got = getattr(quant, fn)(torch.from_numpy(x), torch.from_numpy(np.array(q)),
                             torch.from_numpy(np.array(s)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int4_smallm_plain_equals_dequantize_route():
    """The small-M kernel's function is the dequantize route's (the JAX
    package checks the same at tests/test_quant.py:250-264)."""
    w = torch.from_numpy(_weights(512, 256, seed=7))
    q, s = quant.quantize_int4_grouped(w)
    x = torch.from_numpy(_x(5, 512, seed=8))
    np.testing.assert_allclose(quant.int4_matmul_smallm(x, q, s).numpy(),
                               quant.int4_matmul_xla(x, q, s).numpy(), atol=1e-6, rtol=1e-6)


def test_serving_switches_are_plain_constants():
    """MATMUL_MODE and the two routing cuts are module constants with the
    JAX defaults; the port reads no environment variable for them."""
    assert quant.MATMUL_MODE == jquant.MATMUL_MODE == "w8"
    assert quant.PALLAS_DEQUANT_MAX_M == 1024 and quant.PALLAS_INT4_MIN_M == 16
    assert quant.INT4_GROUP == jquant.INT4_GROUP
    with open(quant.__file__) as f:
        assert "environ" not in f.read()
