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
"""

import numpy as np
import pytest

from affectgpt_tpu_torch.ops import quant, vit_mlp_fused

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
