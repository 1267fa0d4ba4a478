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
"""

import numpy as np
import pytest

from affectgpt_tpu_torch.ops import decode_mlp, quant, vit_mlp, vit_mlp_fused

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

