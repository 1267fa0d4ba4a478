"""The two bf16 decode kernels' plain versions against JAX's Pallas kernels
(interpret mode, f32, the same seeded numpy inputs) at b = 8, 40 and 136,
and their launch plans (ops/decode_gemm.py, the swap-AB wgmma kernel of
csrc/decode_swapab.cuh) at every b of 1-512 at Qwen2.5-3B and 7B widths:
each output column is written by one tile, each weight byte is loaded by
one block once a call, the clusters, ring and shared memory are legal, and
a RoPE pair and a gate/up pair land in one tile. Tolerances follow
tests/test_torch_kernels.py (2e-4 for decode_qkv, 1e-4 for the MLP)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.ops.decode_mlp_bf16_pallas import decode_mlp_bf16 as jax_decode_mlp
from affectgpt_tpu.ops.decode_qkv_pallas import decode_qkv as jax_decode_qkv
from affectgpt_tpu_torch.models import encoders
from affectgpt_tpu_torch.ops import decode_gemm
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16, decode_mlp_bf16_plan
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv, decode_qkv_plan

H, I, HEADS, KV, HD = 256, 1024, 4, 2, 64
# (hidden, intermediate, heads, kv heads): Qwen2.5-3B (bench.py's default) and 7B
WIDTHS = {"3b": (2048, 11008, 16, 2), "7b": (3584, 18944, 28, 4)}
SMS = 132  # H100 SXM


@pytest.mark.parametrize("b", [8, 40, 136])
@pytest.mark.parametrize("with_ln", [False, True], ids=["prenormed", "ln_folded"])
def test_decode_qkv_plain_matches_pallas_at_batch(b, with_ln):
    rng = np.random.RandomState(b)
    nq, nkv = HEADS * HD, KV * HD
    arrs = {
        "wq": rng.randn(H, nq) * 0.05, "wk": rng.randn(H, nkv) * 0.05,
        "wv": rng.randn(H, nkv) * 0.05, "bq": rng.randn(nq) * 0.1,
        "bk": rng.randn(nkv) * 0.1, "bv": rng.randn(nkv) * 0.1,
        "x": rng.randn(b, H), "ln": rng.randn(H) * 0.2 + 1.0,
    }
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    positions = rng.randint(0, 4097, size=(b,)).astype(np.int32)
    order = ("wq", "bq", "wk", "bk", "wv", "bv")
    kw = dict(num_heads=HEADS, num_kv_heads=KV, head_dim=HD, theta=1_000_000.0, eps=1e-6)
    want = jax_decode_qkv(
        jnp.asarray(arrs["x"]), jnp.asarray(positions), *(jnp.asarray(arrs[k]) for k in order),
        ln_scale=jnp.asarray(arrs["ln"]) if with_ln else None, interpret=True, **kw,
    )
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    got = decode_qkv(t["x"], torch.from_numpy(positions), *(t[k] for k in order),
                     ln_scale=t["ln"] if with_ln else None, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("b", [8, 40, 136])
def test_decode_mlp_bf16_plain_matches_pallas_at_batch(b):
    rng = np.random.RandomState(b + 1)
    wg = (rng.randn(H, I) * 0.05).astype(np.float32)
    wu = (rng.randn(H, I) * 0.05).astype(np.float32)
    wd = (rng.randn(I, H) * 0.05).astype(np.float32)
    ln = (1.0 + 0.1 * rng.randn(H)).astype(np.float32)
    x = rng.randn(b, H).astype(np.float32)
    want = jax_decode_mlp(*(jnp.asarray(a) for a in (x, ln, wg, wu, wd)),
                          eps=1e-6, block_i=512, interpret=True)
    got = decode_mlp_bf16(*(torch.from_numpy(a) for a in (x, ln, wg, wu, wd)), eps=1e-6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _check_legal(plan: dict, b: int) -> None:
    """The launch the C entry accepts (csrc/decode_swapab.cuh launch) and
    the card can run: a batch width of the kernel, rows split over at most
    a pair, a cluster of at most 8 that divides the grid, a K split no finer
    than K's units, shared memory within a block's 227 KB (two blocks' within
    the SM's 228 KB where two share an SM)."""
    nb, cb, ck = plan["nb"], plan["cb"], plan["ck"]
    assert nb in decode_gemm.NB_WIDTHS
    assert cb in (1, 2) and cb * nb >= b and (cb == 1 or b > nb)
    assert plan["cluster"] == cb * ck <= decode_gemm.MAX_CLUSTER
    assert plan["grid"] == plan["tiles"] * cb * ck and plan["grid"] % plan["cluster"] == 0
    assert 1 <= ck <= plan["units"] == -(-plan["k"] // decode_gemm.BK)
    assert plan["stages"] >= 2
    assert plan["smem_bytes"] == decode_gemm.smem_bytes(nb, plan["stages"]) <= 232448
    assert plan["blocks_per_sm"] * (plan["smem_bytes"] + 1024) <= 233472
    assert plan["wgmma"] == f"m64n{nb}k16"  # tensor cores at every b


def _check_reads_once(plan: dict, segments, shapes: dict) -> None:
    """Every weight byte of every map [k, n] in `shapes` is in exactly one
    block's loads (each block's 64-column boxes over its K share; a pair's
    boxes each loaded by one block and multicast), and every block's rows
    together cover [0, b) once per (tile, K share)."""
    loads = {m: {} for m in shapes}
    rows = {}
    for tile, kr, br, boxes, (r0, r1) in decode_gemm.block_loads(plan, segments):
        for m, c, k0, k1 in boxes:
            loads[m].setdefault(c, []).append((k0, k1))
        rows.setdefault((tile, kr), []).append((r0, r1))
    for m, (k, n) in shapes.items():
        assert sorted(loads[m]) == list(range(0, n, 64)), f"map {m}: column boxes"
        for c, spans in loads[m].items():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] >= k, f"map {m} column {c}: K not covered"
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:])), f"map {m}: K overlaps"
            assert spans[-1][1] - k < decode_gemm.BK  # only the last unit runs past K
    for spans in rows.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] >= plan["b"]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def _columns_once(boxes, seg_index: int, width: int, n: int) -> None:
    cols = np.zeros(n, np.int64)
    for seg, (m0, c0), (m1, c1) in boxes:
        if seg == seg_index:
            cols[c0:c0 + width] += 1
            if width == 64 and c1 != c0:
                cols[c1:c1 + 64] += 1
    assert (cols == 1).all()


@pytest.mark.parametrize("geometry", list(WIDTHS))
def test_decode_qkv_plan_at_every_batch(geometry):
    h, _, heads, kv = WIDTHS[geometry]
    d = 128
    nq, nkv = heads * d, kv * d
    plan1 = decode_qkv_plan(8, h, nq, nkv, d, SMS)
    boxes = decode_gemm.tile_boxes(plan1["segments"])
    assert len(boxes) == plan1["tiles"] == (nq + 2 * nkv) // 128
    for seg, n in ((0, nq), (1, nkv), (2, nkv)):  # q, k, v: each output column once
        _columns_once(boxes, seg, 64, n)
    for seg, (m0, c0), (m1, c1) in boxes:  # a RoPE pair lands in one tile
        assert m0 == m1 == seg
        assert c1 == c0 + d // 2 and c0 // d == c1 // d and c0 % d < d // 2
    shapes = {0: (h, nq), 1: (h, nkv), 2: (h, nkv)}
    for b in range(1, 513):
        plan = decode_qkv_plan(b, h, nq, nkv, d, SMS)
        _check_legal(plan, b)
        assert plan["regime"] == ("swapab" if b <= 256 else "swapab_pair")
        assert plan["launches_with_ln"] == 2 and plan["launches_without_ln"] == 1
        _check_reads_once(plan, plan["segments"], shapes)


@pytest.mark.parametrize("geometry", list(WIDTHS))
def test_decode_mlp_bf16_plan_at_every_batch(geometry):
    h, inter, _, _ = WIDTHS[geometry]
    segs = decode_mlp_bf16_plan(8, h, inter, SMS)["segments"]
    gateup = decode_gemm.tile_boxes(segs["gateup"])
    for _, (m0, c0), (m1, c1) in gateup:  # gate column c and up column c in one tile
        assert (m0, m1) == (0, 1) and c0 == c1
    _columns_once(gateup, 0, 64, inter)  # each activation column once (c0 == c1)
    _columns_once(decode_gemm.tile_boxes(segs["down"]), 0, 64, h)
    for b in range(1, 513):
        plan = decode_mlp_bf16_plan(b, h, inter, SMS)
        assert plan["launches"] == 3
        for name, shapes in (("gateup", {0: (h, inter), 1: (h, inter)}),
                             ("down", {0: (inter, h)})):
            _check_legal(plan[name], b)
            _check_reads_once(plan[name], segs[name], shapes)


def test_decode_plans_split_k_only_as_far_as_the_clusters_fit_at_once():
    # a card that holds 16 clusters of up to 4 blocks and 12 of more at nb = 192
    def active(nb, cluster, stages):
        return 16 if cluster <= 4 else 12

    h, inter, heads, kv = WIDTHS["3b"]
    down = decode_mlp_bf16_plan(384, h, inter, SMS, active)["down"]  # 16 tiles
    assert (down["cb"], down["ck"]) == (2, 2)  # clusters of 6 would not all fit
    qkv = decode_qkv_plan(384, h, heads * 128, kv * 128, 128, SMS, lambda *a: 20)
    assert qkv["ck"] == 3  # the largest split in clusters of at most 7 blocks
    gateup = decode_mlp_bf16_plan(384, h, inter, SMS, active)["gateup"]  # wide: no K split
    assert (gateup["cb"], gateup["ck"]) == (2, 1)
    # an H100 80GB HBM3's counts at nb = 8, two blocks an SM: 36 q/k/v tiles
    # at 7B split 6 ways, not 7 (32 clusters of 7 fit); 28 down tiles 7 ways
    h100 = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}
    h, inter, heads, kv = WIDTHS["7b"]
    assert decode_qkv_plan(8, h, heads * 128, kv * 128, 128, SMS,
                           lambda nb, c, st: h100[c])["ck"] == 6
    assert decode_mlp_bf16_plan(8, h, inter, SMS, lambda nb, c, st: h100[c])["down"]["ck"] == 7


def test_decode_plans_refuse_what_the_kernel_does_not_take():
    for bad in (0, 513):
        with pytest.raises(ValueError):
            decode_gemm.gemm_plan(bad, 2048, 16, SMS)
    with pytest.raises(ValueError):
        decode_gemm.gemm_plan(8, 0, 16, SMS)


@pytest.mark.parametrize("name", ("DINO2_LARGE", "SigLIP_SO", "EVA_CLIP_G_NO_QFORMER",
                                  "EVA_CLIP_G", "WAVLM_LARGE", "IMAGEBIND", "DATA2VEC_BASE"))
def test_not_ported_encoders_name_their_roadmap_item(name):
    """The towers ROADMAP queue 1 item 12 ported resolve in their own table
    and are unknown (KeyError) in the other."""
    visual = name in encoders.VISUAL
    own, other = ((encoders.get_visual_encoder, encoders.get_acoustic_encoder) if visual
                  else (encoders.get_acoustic_encoder, encoders.get_visual_encoder))
    assert own(name).name == name
    with pytest.raises(KeyError):
        other(name)
