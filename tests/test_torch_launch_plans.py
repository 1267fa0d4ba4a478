"""The launch plans of the two wgmma kernels, and the fragment arithmetic of
the w8a8 kernel, checked on the CPU (the kernels themselves run only on the
card: tests/test_torch_cuda_kernels.py).

- `quant.w8a8_plan`: every output tile of y [M, N] is covered exactly once,
  the K splits fall on whole 512-column activation blocks and cover K
  exactly once, and the ring fits the card's 232,448 bytes of shared memory
  a block, at the 7B (K, N) layouts and the M the path and the tests use.
- The w8a8 kernel's A fragments: the weight tile is N-contiguous, so a warp
  builds its s8 fragments from one transposed ldmatrix (16-bit pairs of n)
  and four byte permutes, and the quantizer stores each 16-column group of
  xq permuted to match. An emulation of those instructions, as the PTX ISA
  defines them, must give every fragment position p the weight of the
  column the permuted xq holds there, so the products are the plain ones.
- `vit_mlp_fused.fused_plan`: the pieces of t cover each chunk exactly once,
  the shared memory fits, weights are read once per 128 rows at CLIP's
  shape, and the wrapper raises on widths the kernel does not take.
- `decode_mlp.decode_mlp_plan` (the int8 decode MLP on tensor cores): launch
  (A) covers every 16-row tile and every 32-column strip of I once and h in
  whole stages, launch (B) every (row tile, 128-column strip of h) once and
  I's 64-k steps once across its cluster of 8, both fit the shared memory,
  b <= 16 reads each weight byte once, and the plan raises on widths the
  kernels do not take.
- `vit_mlp.mlp_plan` (the encoder MLP's two GEMMs on wgmma + TMA): the
  persistent blocks cover every 128 x 256 tile of fc1 and fc2 once, the two
  blocks of a cluster take neighbouring row tiles of one column tile, K in
  whole stages, and the ring and the staging memory fit.
- `prefill_attention.prefill_tile_classes` / `prefill_plan` (the causal
  prefill attention on wgmma + TMA): against a brute-force visibility mask
  over left-packed, non-monotone and random segment ids, no skipped tile
  holds a visible pair and every pair of a full tile is visible, so every
  visible pair lies in exactly one full or masked tile; the units cover
  every (row, q head, query tile) once, heaviest (latest query tile) first;
  the shared memory fits; the plan raises on what the kernel does not take.
- `vit_attention.vit_attention_plan` (the encoders' attention on wgmma +
  TMA): a kernel for every 1 <= valid_len <= n <= 512, one pass up to 320
  valid keys, the shared memory of the blocks an SM holds fits, and it
  raises beyond.
"""

import numpy as np
import pytest

import torch

from affectgpt_tpu_torch.ops import decode_mlp, prefill_attention, quant, vit_attention, vit_mlp
from affectgpt_tpu_torch.ops import vit_mlp_fused

SMEM_LIMIT = 232_448  # bytes of shared memory an H100 block can use
SMS = 132
LAYER_7B = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064)]


@pytest.mark.parametrize("m", [1, 8, 13, 16, 17, 64, 65, 200, 4512])
@pytest.mark.parametrize("k,n", LAYER_7B + [(64, 256), (1024, 512), (512, 272)])
def test_w8a8_plan_covers_every_tile_and_k_once(m, k, n):
    plan = quant.w8a8_plan(m, n, k, SMS)
    bm, per, splits = plan["bm"], plan["k_per_split"], plan["splits"]
    assert bm == (16 if m <= 16 else 192)
    gy, gx, gz = plan["grid"]  # row tiles vary fastest
    # the tiles are the product of a row and a column partition
    rows, cols = np.zeros(m, np.int32), np.zeros(n, np.int32)
    for by in range(gy):
        rows[by * bm:(by + 1) * bm] += 1
    for bx in range(gx):
        cols[bx * quant.W8A8_BN:(bx + 1) * quant.W8A8_BN] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert (gy - 1) * bm < m and (gx - 1) * quant.W8A8_BN < n
    qblock = plan["qblock"]
    assert qblock == min(512, k) and per % qblock == 0 and gz == splits
    ks = np.zeros(k, np.int32)
    for z in range(splits):
        ks[z * per:min(k, (z + 1) * per)] += 1
    assert (ks == 1).all() and (splits - 1) * per < k
    assert plan["smem_bytes"] <= SMEM_LIMIT


def test_w8a8_plan_splits_k_at_decode_and_not_at_prefill():
    assert quant.w8a8_plan(8, 512, 3584, SMS)["splits"] == 7  # k_proj: 4 column tiles
    assert quant.w8a8_plan(8, 3584, 18944, SMS)["splits"] > 1
    for k, n in LAYER_7B:  # at prefill only a product of fewer tiles than SMs splits
        plan = quant.w8a8_plan(4512, n, k, SMS)
        assert (plan["splits"] == 1) == (plan["grid"][0] * plan["grid"][1] >= SMS)


def _sigma16(p):  # csrc/int8_matmul_w8a8.cu sigma16
    return ((p >> 2) << 1) + (p & 1) + ((p & 2) << 2)


def _byte_perm(x, y, sel):
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 0xF] << (8 * i) for i in range(4))


def test_w8a8_fragments_match_the_permuted_activations():
    rng = np.random.RandomState(0)
    w = rng.randint(0, 256, size=(32, 16))  # one k32 step of a warp's 16 n, as bytes
    assert sorted(_sigma16(p) for p in range(16)) == list(range(16))

    def elem(q, i, c):  # 16-bit element c of row i of matrix q: k = 8q + i, n = 2c, 2c + 1
        return w[8 * q + i, 2 * c] | (w[8 * q + i, 2 * c + 1] << 8)

    for lane in range(32):
        g, t = lane // 4, lane % 4
        # ldmatrix .trans: element (2t, g) in the low half, (2t + 1, g) in the high
        r = [elem(q, 2 * t, g) | (elem(q, 2 * t + 1, g) << 16) for q in range(4)]
        a = [_byte_perm(r[0], r[1], 0x6420), _byte_perm(r[0], r[1], 0x7531),
             _byte_perm(r[2], r[3], 0x6420), _byte_perm(r[2], r[3], 0x7531)]
        # the m16n8k32 / wgmma s8 A layout: a0 row g, k 4t..4t+3; a1 row g + 8;
        # a2, a3 the same at k + 16; byte j is k 4t + j
        for reg, (row, k0) in enumerate([(g, 4 * t), (g + 8, 4 * t), (g, 16 + 4 * t),
                                         (g + 8, 16 + 4 * t)]):
            n = 2 * (row % 8) + row // 8  # fragment rows g, g + 8 hold n = 2g, 2g + 1
            for j in range(4):
                p = k0 + j
                k = 16 * (p // 16) + _sigma16(p % 16)  # the column xq holds at position p
                assert (a[reg] >> (8 * j)) & 0xFF == w[k, n]


@pytest.mark.parametrize("rows,w,inter,k_chunks", [
    (64 * 257, 1024, 4096, 8), (64 * 99, 1024, 4096, 8), (3 * 40, 1024, 4096, 8),
    (771, 384, 1536, 8), (771, 384, 1536, 6), (771, 256, 1024, 8), (771, 256, 1024, 6)])
def test_fused_plan_covers_each_chunk_once(rows, w, inter, k_chunks):
    plan = vit_mlp_fused.fused_plan(rows, w, inter, k_chunks)
    kc = plan["kc"]
    assert plan["cluster"] * 128 == w and plan["cluster"] <= 8  # one block per 128 columns
    assert plan["chunks"] * kc == inter and plan["tiles"] * 128 >= rows > (plan["tiles"] - 1) * 128
    cols = np.zeros(kc, np.int32)
    for p0, pw in plan["pieces"]:
        assert pw % 64 == 0 and 0 < pw <= 64 * plan["cluster"] <= 512
        cols[p0:p0 + pw] += 1
    assert (cols == 1).all()
    assert plan["smem_bytes"] <= SMEM_LIMIT


def test_fused_plan_reads_weights_once_per_128_rows_at_clip():
    plan = vit_mlp_fused.fused_plan(64 * 257, 1024, 4096, 8)
    assert plan["weight_l2_bytes"] == 129 * 2 * 2 * 1024 * 4096 <= 2.2e9


@pytest.mark.parametrize("w,inter,k_chunks", [(320, 1280, 8), (256, 768, 8), (256, 2048, 1)])
def test_fused_plan_raises_on_what_the_kernel_does_not_take(w, inter, k_chunks):
    with pytest.raises(ValueError):  # width % 128, chunk % 64, chunk > 1024
        vit_mlp_fused.fused_plan(99, w, inter, k_chunks)


DECODE_WIDTHS = [(3584, 18944), (2048, 11008), (256, 512), (384, 8320)]  # 7B, 3B, test widths


@pytest.mark.parametrize("b", [1, 3, 8, 16, 40, 64])
@pytest.mark.parametrize("h,inter", DECODE_WIDTHS)
def test_decode_mlp_plan_covers_every_tile_and_k_once(b, h, inter):
    plan = decode_mlp.decode_mlp_plan(b, h, inter, SMS)
    rt = plan["row_tiles"]
    assert (rt - 1) * 16 < b <= rt * 16
    a = plan["gateup"]
    ctas, rows = a["grid"]
    assert rows == rt and ctas * rt <= SMS and len(a["strips"]) == ctas
    strips = np.zeros(inter // a["strip"], np.int32)  # each block's strips, every row tile
    for mine in a["strips"]:
        strips[mine] += 1
    assert (strips == 1).all()
    assert (a["k_steps"] - 1) * a["stage_k"] < h <= a["k_steps"] * a["stage_k"]
    d = plan["down"]
    tiles = np.zeros((rt, h // d["strip"]), np.int32)
    for r, s in d["clusters"]:
        tiles[r, s] += 1
    assert (tiles == 1).all() and d["grid"] == (d["cluster"] * len(d["clusters"]),)
    ks = np.zeros(inter, np.int32)
    for k0, k1 in d["k_ranges"]:
        assert k0 % d["stage_k"] == 0 and k1 % d["stage_k"] == 0
        ks[k0:k1] += 1
    assert (ks == 1).all() and len(d["k_ranges"]) == d["cluster"] == 8
    assert a["smem_bytes"] <= SMEM_LIMIT and d["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("b", [1, 8, 16, 17, 64])
def test_decode_mlp_plan_reads_each_weight_byte_once_up_to_16_rows(b):
    h, inter = 3584, 18944
    plan = decode_mlp.decode_mlp_plan(b, h, inter, SMS)
    weights = 3 * h * inter
    reads = plan["l2_bytes"] - plan["gateup"]["grid"][0] * plan["row_tiles"] * 16 * h * 2 \
        - len(plan["down"]["clusters"]) * 16 * inter * 2
    assert reads == weights * (1 if b <= 16 else -(-b // 16))


@pytest.mark.parametrize("h,inter", [(320, 1024), (256, 480), (8192, 1024)])
def test_decode_mlp_plan_raises_on_what_the_kernels_do_not_take(h, inter):
    with pytest.raises(ValueError):  # hidden % 128, intermediate % 64, shared memory
        decode_mlp.decode_mlp_plan(16, h, inter, SMS)


MLP_SHAPES = [(64 * 257, 1024, 4096), (64 * 99, 1024, 4096), (300, 1024, 4096),
              (3 * 99, 256, 1024), (3 * 257, 384, 1536), (120, 256, 1024), (1, 256, 1024)]


@pytest.mark.parametrize("rows,w,inter", MLP_SHAPES)
def test_mlp_plan_covers_every_tile_once(rows, w, inter):
    plan = vit_mlp.mlp_plan(rows, w, inter, SMS)
    for name, (n, k) in (("fc1", (inter, w)), ("fc2", (w, inter))):
        p = plan[name]
        bm, bn = p["tile"]
        cl = p["cluster"]
        assert p["grid"] == (plan["blocks"],) and plan["blocks"] <= SMS
        assert plan["blocks"] % cl == 0 and p["m_tiles"] % cl == 0
        assert (p["n_tiles"] - 1) * bn < n <= p["n_tiles"] * bn
        assert (p["m_tiles"] - cl) * bm < rows <= p["m_tiles"] * bm
        seen = np.zeros((p["n_tiles"], p["m_tiles"]), np.int32)
        for b, mine in enumerate(p["tiles"]):
            for nt, mt in mine:
                seen[nt, mt] += 1
            if cl == 2:  # the cluster's blocks: one column tile, neighbouring row tiles
                other = p["tiles"][b ^ 1]
                assert [t[0] for t in mine] == [t[0] for t in other]
                assert all(t[1] // 2 == o[1] // 2 and t[1] % 2 == b % 2
                           for t, o in zip(mine, other))
        assert (seen == 1).all()
        assert (p["k_steps"] - 1) * p["stage_k"] < k <= p["k_steps"] * p["stage_k"]
        assert p["smem_bytes"] <= SMEM_LIMIT


def test_mlp_plan_clusters_share_weight_tiles_at_the_towers_shapes():
    for rows in (64 * 257, 64 * 99):
        p = vit_mlp.mlp_plan(rows, 1024, 4096, SMS)["fc1"]
        assert p["cluster"] == 2 and p["grid"] == (SMS,)
        # w_in is read once per pair of row tiles, h once per column tile
        assert p["l2_bytes"] == 2 * (16 * rows * 1024 + p["m_tiles"] // 2 * 1024 * 4096)


@pytest.mark.parametrize("w,inter", [(100, 4096), (2080, 4096), (1024, 1000)])
def test_mlp_plan_raises_on_what_the_kernels_do_not_take(w, inter):
    with pytest.raises(ValueError):  # width % 32 or > 2048, intermediate % 32
        vit_mlp.mlp_plan(99, w, inter, SMS)



def _segment_ids(kind: str, b: int, t: int, seed: int) -> torch.Tensor:
    """[b, t] segment ids: `leftpack` (pads 0, then tokens 1), `runs` (runs
    of ids 0-3 in a shuffled order, so an id comes back after others),
    `random3` (each token's id drawn from 0-2), `one` (a single id)."""
    rng = np.random.RandomState(seed)
    if kind == "leftpack":
        pad = rng.randint(0, max(1, min(20, t)), size=b)
        seg = (np.arange(t)[None, :] >= pad[:, None]).astype(np.int32)
    elif kind == "random3":
        seg = rng.randint(0, 3, size=(b, t)).astype(np.int32)
    elif kind == "runs":
        seg = np.zeros((b, t), np.int32)
        for r in range(b):
            ends = np.sort(rng.randint(1, max(2, t), size=5))
            ids = rng.permutation(4)[[0, 1, 2, 0, 3, 1]]
            seg[r] = ids[(np.arange(t)[:, None] >= ends[None, :]).sum(-1)]
    else:
        seg = np.full((b, t), 7, np.int32)
    return torch.from_numpy(seg)


@pytest.mark.parametrize("kind", ["leftpack", "runs", "random3", "one"])
@pytest.mark.parametrize("t", [1, 37, 64, 130, 564])
def test_prefill_tile_classes_hold_every_visible_pair(kind, t):
    b, tile = 3, prefill_attention.TILE
    seg = _segment_ids(kind, b, t, seed=t)
    classes = prefill_attention.prefill_tile_classes(seg)
    tiles = -(-t // tile)
    assert classes.shape == (b, tiles, tiles)
    visible = torch.ones((t, t), dtype=torch.bool).tril()[None] & (seg[:, :, None] == seg[:, None, :])
    pad = tiles * tile - t
    vis = torch.nn.functional.pad(visible, (0, pad, 0, pad)).view(b, tiles, tile, tiles, tile)
    real = torch.nn.functional.pad(torch.ones((b, t, t), dtype=torch.bool), (0, pad, 0, pad))
    real = real.view(b, tiles, tile, tiles, tile)
    any_visible = vis.any(dim=4).any(dim=2)
    all_visible = (vis | ~real).all(dim=4).all(dim=2)
    skip, full = classes == prefill_attention.SKIP, classes == prefill_attention.FULL
    assert not (skip & any_visible).any()  # no skipped tile holds a visible pair
    assert not (full & ~all_visible).any()  # a full tile needs no per-element test
    # so the full and masked tiles hold every visible pair, each in exactly one tile
    kept = vis & (~skip)[:, :, None, :, None]
    assert int(kept.sum()) == int(visible.sum())
    if kind == "leftpack" and t == 564:  # the main path's prompts: most tiles skip or run full
        assert int((classes == prefill_attention.MASKED).sum()) <= 2 * b * tiles


PREFILL_SHAPES = [(8, 564, 28, 4, 128), (64, 564, 28, 4, 128), (3, 37, 28, 4, 128),
                  (2, 130, 6, 1, 64), (1, 1, 1, 1, 64)]


@pytest.mark.parametrize("b,t,heads,kv,d", PREFILL_SHAPES)
def test_prefill_plan_covers_every_query_tile_once_heaviest_first(b, t, heads, kv, d):
    seg = _segment_ids("leftpack", b, t, seed=1)
    plan = prefill_attention.prefill_plan(b, t, heads, kv, d, SMS, segment_ids=seg)
    q_tiles, groups = plan["q_tiles"], heads // kv
    assert (q_tiles - 1) * prefill_attention.TILE < t <= q_tiles * prefill_attention.TILE
    seen = np.zeros((b, heads, q_tiles), np.int32)
    for qt, bi, kvh, hs in plan["units"]:
        assert 1 <= len(hs) <= 2 and all(kvh * groups <= h < (kvh + 1) * groups for h in hs)
        for h in hs:
            seen[bi, h, qt] += 1
    assert (seen == 1).all()
    order = [qt for qt, _, _, _ in plan["units"]]  # the causal key tiles a unit sees: qt + 1
    assert order == sorted(order, reverse=True)
    assert plan["blocks"] == min(len(plan["units"]), SMS) and plan["grid"] == (plan["blocks"],)
    assert plan["smem_bytes"] <= SMEM_LIMIT
    # the producer loads a unit's non-skipped tiles: at most the causal ones
    assert plan["kv_tiles_loaded"] <= sum(qt + 1 for qt in order)


@pytest.mark.parametrize("b,t,heads,kv,d", [(2, 40, 4, 2, 96), (2, 40, 6, 4, 64),
                                            (2, 0, 4, 2, 64)])
def test_prefill_plan_raises_on_what_the_kernel_does_not_take(b, t, heads, kv, d):
    with pytest.raises(ValueError):  # head_dim 96, heads % kv, no tokens
        prefill_attention.prefill_plan(b, t, heads, kv, d, SMS)


def test_vit_attention_plan_picks_a_kernel_for_every_n():
    for n in range(1, vit_attention.MAX_N + 1):
        for valid in sorted({1, n // 2 + 1, n}):
            plan = vit_attention.vit_attention_plan(n, valid, b=64, heads=16, sms=SMS)
            keys = plan["key_tiles"] * vit_attention.TILE
            assert keys - vit_attention.TILE < valid <= keys
            assert plan["kernel"] == ("one_pass" if keys <= vit_attention.ONE_PASS_KEYS
                                      else "two_pass")
            assert plan["score_registers"] <= 160
            assert plan["smem_bytes"] <= SMEM_LIMIT
            per_sm = plan["blocks_per_sm"]
            assert per_sm * (plan["smem_bytes"] + 1024) <= vit_attention.SMEM_PER_SM
            assert plan["blocks"] == min(1024, per_sm * SMS) and 1 <= plan["kv_slots"] <= 4
    assert vit_attention.vit_attention_plan(257)["kernel"] == "one_pass"  # CLIP
    assert vit_attention.vit_attention_plan(99)["blocks_per_sm"] == 2  # HuBERT
    assert vit_attention.vit_attention_plan(512, 320)["kernel"] == "one_pass"


@pytest.mark.parametrize("n,valid", [(0, 0), (513, 513), (100, 0), (100, 101)])
def test_vit_attention_plan_raises_beyond_max_n(n, valid):
    with pytest.raises(ValueError):
        vit_attention.vit_attention_plan(n, valid)


# ---------------------------------------------------------------------------
# The swap-AB int4 kernel (csrc/int4_matmul_swapab.cu)

SMEM_PER_SM = 233_472  # an H100 SM's shared memory; each resident block also reserves 1 KB
INT4_SHAPES = LAYER_7B + [(1024, 256), (512, 272), (256, 128), (2048, 16)]


@pytest.mark.parametrize("m", [1, 8, 13, 16])
@pytest.mark.parametrize("k,n", INT4_SHAPES)
def test_int4_plan_covers_every_strip_and_unit_once(m, k, n):
    plan = quant.int4_plan(m, n, k, SMS)
    c, units = plan["cluster"], plan["units"]
    assert plan["nt"] == (1 if m <= 8 else 2) and units == k // 256
    assert 1 <= c <= 8 and c <= units and plan["col_blocks"] == -(-n // 128)
    assert plan["grid"] == (c * plan["col_blocks"],)
    # block b: column block b // c, rank b % c and that rank's units
    cover = np.zeros((n // 16, units), np.int32)
    for b in range(plan["grid"][0]):
        cb, rank = divmod(b, c)
        u0, u1 = plan["unit_ranges"][rank]
        strips = range(8 * cb, min(8 * cb + 8, n // 16))  # the block's 16-column strips inside N
        for s in strips:
            cover[s, u0:u1] += 1
    assert (cover == 1).all()  # each weight byte is read by one block, once
    assert plan["weight_bytes"] >= n * k // 2
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert plan["stages"] >= 4 and 2 * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM  # two an SM


@pytest.mark.parametrize("m,n,k", [(0, 512, 3584), (17, 512, 3584), (8, 120, 3584),
                                   (8, 512, 384), (8, 512, 128), (8, 0, 3584)])
def test_int4_plan_raises_on_what_the_kernel_does_not_take(m, n, k):
    with pytest.raises(ValueError):  # M outside 1-16, N % 16, K % 256
        quant.int4_plan(m, n, k, SMS)


def test_int4_plan_splits_k_for_narrow_products_only():
    # k/v_proj (4 column blocks) and down_proj (K = 18944) split K over a
    # cluster; the lm_head's 1188 column blocks fill the card whole-K
    assert quant.int4_plan(8, 512, 3584, SMS)["cluster"] >= 4
    assert quant.int4_plan(16, 3584, 18944, SMS)["cluster"] >= 4
    assert quant.int4_plan(8, 152064, 3584, SMS)["cluster"] == 1


def test_int4_plan_reads_the_card_s_cluster_count():
    """A card that holds no cluster of more than two blocks gets one of at
    most two; one that holds none raises."""
    plan = quant.int4_plan(8, 512, 3584, SMS, lambda c: 264 // c if c <= 2 else 0)
    assert plan["cluster"] <= 2
    with pytest.raises(ValueError):
        quant.int4_plan(8, 512, 3584, SMS, lambda c: 0)


def _swizzle128(tile: np.ndarray) -> np.ndarray:
    """A [rows, 128]-byte tile as TMA writes it with the 128-byte swizzle:
    16-byte chunk c of row r at chunk c ^ (r % 8); flat bytes."""
    out = np.empty_like(tile)
    for r in range(tile.shape[0]):
        for c in range(8):
            p = c ^ (r % 8)
            out[r, 16 * p:16 * p + 16] = tile[r, 16 * c:16 * c + 16]
    return out.reshape(-1)


def _ldmatrix_x4(smem: np.ndarray, addrs, trans: bool) -> np.ndarray:
    """ldmatrix.sync.aligned.m8n8.x4(.trans).b16 as the PTX ISA defines it:
    lane l gives the byte address of row l % 8 of matrix l / 8; register q
    of lane (g = l / 4, t = l % 4) holds matrix q's 16-bit elements (g, 2t)
    and (g, 2t + 1), or with .trans (2t, g) and (2t + 1, g), low half first."""
    mats = [np.stack([smem[a:a + 16].view(np.uint16) for a in addrs[8 * q:8 * q + 8]])
            for q in range(4)]
    regs = np.zeros((32, 4), np.uint64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q, mat in enumerate(mats):
            lo, hi = (mat[2 * t, g], mat[2 * t + 1, g]) if trans else (mat[g, 2 * t], mat[g, 2 * t + 1])
            regs[lane, q] = int(lo) | (int(hi) << 16)
    return regs


def _bf16_value(bits: int) -> float:
    return float(np.array([bits << 16], np.uint32).view(np.float32)[0])


def _nibble_pair(v: int):
    """The kernel's nibbles_to_bf16x2: (v & 0x000F000F) ^ 0x43084308 read as
    two bf16, each minus 136 (exact)."""
    biased = (v & 0x000F000F) ^ 0x43084308
    return _bf16_value(biased & 0xFFFF) - 136.0, _bf16_value(biased >> 16) - 136.0


def _bf16_round(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).float())


@pytest.mark.parametrize("nt", [1, 2])
@pytest.mark.parametrize("dequant", [False, True])
def test_int4_fragments_rebuild_the_weight_tile(nt, dequant):
    """One stage of one block (128 packed rows x 128 columns, K = 256), every
    consumer warp, emulated instruction by instruction: the swizzled weight
    and x tiles TMA writes, the transposed ldmatrix and the nibble (and
    dequant) arithmetic of each A fragment, the ldmatrix of each B
    fragment, the m16n8k16 products into the accumulator layout. Every A
    fragment must hold the weight (or its dequantized value) at the (n, k)
    the mma layout gives it, every B fragment x at its (k, m), and the
    products the plain version's sums."""
    rng = np.random.RandomState(3)
    k, m = 256, 8 * nt
    w = rng.randint(0, 256, size=(128, 128)).astype(np.uint8)  # packed bytes [kp][n]
    values = [((w.astype(np.int32) & 0xF) ^ 8) - 8, (((w.astype(np.int32) >> 4) & 0xF) ^ 8) - 8]
    scales = (rng.rand(2, 128).astype(np.float32) + 0.5) * 0.01  # group rows: low half, high half
    x = torch.tensor(rng.randn(m, k), dtype=torch.float32).to(torch.bfloat16)
    weight = [np.vectorize(lambda v, s: _bf16_round(np.float32(v) * s))(values[h], scales[h])
              if dequant else values[h].astype(np.float64) for h in range(2)]
    w_smem = _swizzle128(w)
    x_bits = x.view(torch.int16).numpy().view(np.uint16)
    # the stage's x boxes: (half h, 64-column box b) of 8 nt rows x 128 bytes
    x_smem = [_swizzle128(x_bits[:, h * 128 + 64 * b:h * 128 + 64 * b + 64].copy().view(np.uint8))
              for h in range(2) for b in range(2)]
    lanes = np.arange(32)
    xrow = (lanes % 8) + 8 * (lanes // 16) if nt == 2 else lanes % 8
    xchunk = (lanes // 8) % 2 if nt == 2 else lanes // 8
    y = np.zeros((m, 128))
    for warp in range(8):
        a_off = lanes * 128 + ((warp ^ (lanes & 7)) << 4)
        d = np.zeros((2, 16, m))  # [half][fragment row][batch row]
        for j in range(4):
            r = _ldmatrix_x4(w_smem, j * 32 * 128 + a_off, trans=True)
            for h in range(2):
                box = x_smem[2 * h + j // 2]
                loads = [_ldmatrix_x4(box, xrow * 128 + (((4 * (j % 2) + 2 * s + xchunk)
                                                          ^ (lanes & 7)) << 4), trans=False)
                         for s in range(nt)]
                for s in range(2):
                    a_mat, b_mat = np.zeros((16, 16)), np.zeros((16, m))
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        w0, w1 = int(r[lane, 2 * s]), int(r[lane, 2 * s + 1])
                        sh = 4 * h
                        pairs = [_nibble_pair(w0 >> sh), _nibble_pair(w0 >> (8 + sh)),
                                 _nibble_pair(w1 >> sh), _nibble_pair(w1 >> (8 + sh))]
                        if dequant:  # bf16(f32(value) * scale of the fragment row's column)
                            sc = scales[h][16 * warp + 2 * g:16 * warp + 2 * g + 2]
                            pairs = [tuple(_bf16_round(np.float32(v) * sc[i % 2]) for v in p)
                                     for i, p in enumerate(pairs)]
                        for i, (row, col) in enumerate([(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                                        (g + 8, 2 * t + 8)]):
                            a_mat[row, col], a_mat[row, col + 1] = pairs[i]
                        for tile in range(nt):
                            regs = (loads[s][lane, 2 * tile:2 * tile + 2] if nt == 2
                                    else loads[0][lane, 2 * s:2 * s + 2])
                            for i, kk in enumerate((2 * t, 2 * t + 8)):
                                b_mat[kk, 8 * tile + g] = _bf16_value(int(regs[i]) & 0xFFFF)
                                b_mat[kk + 1, 8 * tile + g] = _bf16_value(int(regs[i]) >> 16)
                    # fragment row g is column 2g of the warp's 16, row g + 8 column 2g + 1
                    cols = 16 * warp + np.array([2 * (i % 8) + i // 8 for i in range(16)])
                    kp = 32 * j + 16 * s + np.arange(16)
                    np.testing.assert_array_equal(a_mat, weight[h][kp][:, cols].T)
                    np.testing.assert_array_equal(
                        b_mat, x[:, h * 128 + kp].float().numpy().T)
                    d[h] += a_mat @ b_mat
        cols = 16 * warp + np.array([2 * (i % 8) + i // 8 for i in range(16)])
        for h in range(2):
            y[:, cols] += (d[h] * (1.0 if dequant else scales[h][cols, None])).T
    xf = x.double().numpy()
    want = sum(xf[:, h * 128:(h + 1) * 128] @ (weight[h] * (1.0 if dequant else scales[h]))
               for h in range(2))
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)
