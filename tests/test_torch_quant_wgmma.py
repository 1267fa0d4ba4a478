"""The weight-only quantized matmuls above decode M (csrc/quant_wgmma.cuh:
int8_matmul, int4_matmul and int4_matmul_smallm at 16 < M <= 1024), checked
on the CPU; the kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py's quant phase).

- `quant.wgmma_plan`: at every M of the regime and the 7B, 3B and tiny
  widths, every (16-column strip, batch block, K pair) is covered once, the
  batch blocks cover M with none empty, each weight byte is read once a
  batch block (once up to M = 128), the ring holds at least two pairs and
  fits the shared memory; narrow products split K over a cluster, wide ones
  do not; the plan reads the card's cluster count and raises on what the
  kernel does not take.
- One pair of stages of one block, every consumer warp, emulated
  instruction by instruction in each mode: the swizzled weight and x tiles
  TMA writes, the transposed ldmatrix and the conversions of each register A
  fragment (int8 bytes, int4 nibbles, the dequantized values), the K-major
  B operand as the wgmma descriptor addresses it, the m64nNBk16 products
  into the accumulator layout and the epilogue's columns. Every A fragment
  must hold the weight at the (n, k) the wgmma layout gives it, and the
  result the plain sums exactly.
- One launch emulated block by block on the plan: each batch block's rows
  (zeros past M), each K pair's group sums with the scales where the TPU
  kernels apply them, the K split's partial tiles summed in rank order:
  each mode's plain version to 1e-6.
"""

import numpy as np
import pytest
import torch

from affectgpt_tpu_torch.ops import quant
from tests.test_torch_launch_plans import (SMEM_LIMIT, SMEM_PER_SM, _bf16_round, _bf16_value,
                                           _byte_perm, _ldmatrix_x4, _nibble_pair, _s8,
                                           _s8_halves, _sigma16, _swizzle128)

SMS = 132
MODES = {"int8_matmul": quant.MODE_INT8, "int4_matmul": quant.MODE_INT4,
         "int4_matmul_smallm": quant.MODE_INT4_DEQUANT}
PLAIN = {quant.MODE_INT8: quant.int8_matmul_reference,
         quant.MODE_INT4: quant.int4_matmul_reference,
         quant.MODE_INT4_DEQUANT: quant.int4_matmul_smallm_reference}
# (K, N) of a Qwen2.5-7B and a Qwen2.5-3B layer (split layout) with the
# lm_head, and the tests' tiny widths (a last column block partly inside N)
LAYER_7B = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064)]
LAYER_3B = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048), (2048, 151936)]
TINY = [(256, 128), (512, 272), (1024, 512), (1024, 256)]
MS = [17, 24, 40, 100, 256, 257, 512, 1000, 1024]


def _blocks(plan: dict):
    """Every block of the grid: (column block, batch block, K pairs [u0,
    u1), rank). A cluster of c blocks a (column block, batch block), batch
    blocks fastest."""
    cb, c = plan["cb"], plan["cluster"]
    for b in range(plan["grid"][0]):
        yield b // (cb * c), (b // c) % cb, plan["unit_ranges"][b % c], b % c


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", LAYER_7B + LAYER_3B + TINY)
@pytest.mark.parametrize("name", sorted(MODES))
def test_wgmma_plan_covers_every_strip_batch_block_and_pair_once(name, k, n, m):
    mode = MODES[name]
    plan = quant.wgmma_plan(m, n, k, SMS, mode)
    nb, cb, units = plan["nb"], plan["cb"], plan["units"]
    assert nb in quant.WGMMA_NB and cb == -(-m // 128)
    assert (cb - 1) * nb < m <= cb * nb  # no batch block empty
    assert units == (-(-k // 128) if mode == quant.MODE_INT8 else k // 256)
    cols, c = plan["col_blocks"], plan["cluster"]
    assert cols == -(-n // 128) and 1 <= c <= min(8, units)
    assert plan["grid"] == (cols * cb * c,)
    ranges = plan["unit_ranges"]
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    cover = np.zeros((n // 16, cb, units), np.int32)
    for col, br, (u0, u1), _ in _blocks(plan):
        cover[8 * col:min(8 * col + 8, n // 16), br, u0:u1] += 1
    assert (cover == 1).all()  # each weight byte once a batch block
    assert plan["weight_reads"] == cb
    assert plan["weight_bytes"] == cb * plan["col_blocks"] * 128 * units * 128
    assert plan["weight_bytes"] >= cb * n * (k if mode == quant.MODE_INT8 else k // 2)
    stage = quant.wgmma_stage_bytes(mode, nb)
    assert plan["stage_bytes"] == stage and 4 <= plan["stages"] <= quant.WGMMA_MAX_STAGES
    assert plan["smem_bytes"] == max(plan["stages"] * stage, nb * 132 * 4) \
        + 16 * plan["stages"] + 1024
    assert plan["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("m", [17, 40, 64, 65, 128, 129, 256, 1000])
@pytest.mark.parametrize("name", sorted(MODES))
def test_wgmma_plan_reads_the_weights_once_a_batch_block(name, m):
    """Once up to 128 rows, then once a block of up to 128 rows."""
    plan = quant.wgmma_plan(m, 18944, 3584, SMS, MODES[name])
    assert plan["weight_reads"] == -(-m // 128)
    # the narrowest width that holds a batch block's share of the rows
    assert plan["nb"] == min(w for w in quant.WGMMA_NB if w * plan["cb"] >= m)


@pytest.mark.parametrize("m,n,k,mode", [
    (16, 512, 3584, quant.MODE_INT8), (1025, 512, 3584, quant.MODE_INT8),
    (40, 120, 3584, quant.MODE_INT8), (40, 512, 96, quant.MODE_INT8),
    (40, 0, 3584, quant.MODE_INT8), (40, 512, 384, quant.MODE_INT4),
    (16, 512, 3584, quant.MODE_INT4_DEQUANT), (40, 512, 128, quant.MODE_INT4),
    (40, 512, 3584, 3)])
def test_wgmma_plan_raises_on_what_the_kernel_does_not_take(m, n, k, mode):
    with pytest.raises(ValueError):  # M outside (16, 1024], N % 16, K % 64 or 256, the mode
        quant.wgmma_plan(m, n, k, SMS, mode)


@pytest.mark.parametrize("m", [40, 256])
@pytest.mark.parametrize("name", sorted(MODES))
def test_wgmma_plan_splits_k_for_narrow_products_only(name, m):
    """k/v_proj (4 column blocks) split K over a cluster; gate/up_proj's 148
    column blocks and the lm_head's 1188 fill the card whole-K."""
    assert quant.wgmma_plan(m, 512, 3584, SMS, MODES[name])["cluster"] >= 4
    assert quant.wgmma_plan(m, 18944, 3584, SMS, MODES[name])["cluster"] == 1
    assert quant.wgmma_plan(m, 152064, 3584, SMS, MODES[name])["cluster"] == 1


def test_wgmma_plan_reads_the_card_s_cluster_count():
    """A card that holds no cluster of more than two blocks gets one of at
    most two; one that holds none raises. The count is asked for the width
    and ring the plan launches."""
    asked = set()

    def two(c, nb, stages):
        asked.add((nb, stages))
        return 132 // c if c <= 2 else 0

    plan = quant.wgmma_plan(40, 512, 3584, SMS, quant.MODE_INT4, two)
    assert plan["cluster"] == 2 and asked == {(plan["nb"], plan["stages"])}
    with pytest.raises(ValueError):
        quant.wgmma_plan(40, 512, 3584, SMS, quant.MODE_INT4, lambda c, nb, stages: 0)


def _wgmma_b(box: np.ndarray, nb: int, q: int) -> np.ndarray:
    """The K-major B operand [16 k x nb rows] of k16 step q, as
    desc_sw128(box + 32 q, 16, 1024) addresses the 128-byte swizzled box:
    row n's 8-row group 1024 bytes apart (SBO), its row 128 bytes, the step
    32 bytes in, the 16-byte chunk XORed with n % 8; bf16 values."""
    out = np.zeros((16, nb))
    for n in range(nb):
        for kk in range(16):
            logical = 32 * q + 2 * kk
            at = (n // 8) * 1024 + (n % 8) * 128 + (((logical // 16) ^ (n % 8)) << 4) \
                + logical % 16
            out[kk, n] = _bf16_value(int(box[at:at + 2].view(np.uint16)[0]))
    return out


def _fragment_pairs(mode: int, half: int, w0: int, w1: int, sc) -> list:
    """The four register pairs a0-a3 a_fragment builds from words w0, w1:
    int8 bytes, int4 nibbles of `half`, or those times the scales sc of the
    fragment rows' two columns, rounded to bf16."""
    if mode == quant.MODE_INT8:
        return [_s8_halves(w0), _s8_halves(w0 >> 8), _s8_halves(w1), _s8_halves(w1 >> 8)]
    sh = 4 * half
    pairs = [_nibble_pair(w0 >> sh), _nibble_pair(w0 >> (8 + sh)), _nibble_pair(w1 >> sh),
             _nibble_pair(w1 >> (8 + sh))]
    if mode == quant.MODE_INT4_DEQUANT:
        pairs = [tuple(_bf16_round(np.float32(v) * sc[i % 2]) for v in p)
                 for i, p in enumerate(pairs)]
    return pairs


@pytest.mark.parametrize("nb", [40, 128])
@pytest.mark.parametrize("name", sorted(MODES))
def test_wgmma_fragments_rebuild_the_weight_tile(name, nb):
    """One pair of stages (128 stored rows x 128 columns) of one block with
    nb batch rows (37 of x, zeros past them as TMA fills), both consumer
    warpgroups, each k16 step: the A fragments from the transposed ldmatrix
    of the swizzled stage tiles hold the weight (int8 value, int4 value or
    bf16(value * scale)) at the columns the wgmma rows stand for, B the x
    rows at their k, and the products, the group scaling (int4_matmul) and
    the epilogue's column map give the plain sums exactly."""
    mode = MODES[name]
    rng = np.random.RandomState(7)
    rows = 37
    w = rng.randint(0, 256, size=(128, 128)).astype(np.uint8)  # the pair's stored bytes [row][n]
    halves = 1 if mode == quant.MODE_INT8 else 2
    if mode == quant.MODE_INT8:
        values = [((w.astype(np.int32) ^ 0x80) - 0x80).astype(np.float64)]
    else:
        values = [((((w.astype(np.int32) >> (4 * h)) & 0xF) ^ 8) - 8).astype(np.float64)
                  for h in range(2)]
    scales = (rng.rand(halves, 128).astype(np.float32) + 0.5) * 0.01  # a scale row a half
    weight = [np.vectorize(lambda v, s: _bf16_round(np.float32(v) * s))(values[h], scales[h])
              if mode == quant.MODE_INT4_DEQUANT else values[h] for h in range(halves)]
    x = torch.zeros((nb, 128 * halves), dtype=torch.bfloat16)
    x[:rows] = torch.tensor(rng.randn(rows, 128 * halves), dtype=torch.float32)
    x_bits = x.view(torch.int16).numpy().view(np.uint16)
    # stage s: its 64 weight rows, and the x box of each half (k = 64 s + 128 h)
    w_smem = [_swizzle128(w[64 * s:64 * s + 64]) for s in range(2)]
    x_smem = [[_swizzle128(x_bits[:, 128 * h + 64 * s:128 * h + 64 * s + 64].copy()
                           .view(np.uint8)) for h in range(halves)] for s in range(2)]
    lanes = np.arange(32)
    out = np.zeros((nb, 128))
    for wg in range(2):
        d = np.zeros((halves, 64, nb))  # [half][warpgroup row][batch row]
        col_of_row = np.zeros(64, np.int64)
        for h in range(halves):
            for i in range(8):  # the pair's k16 steps: stage i // 4, step i % 4
                st, q = i // 4, i % 4
                a_mat = np.zeros((64, 16))
                for wq in range(4):
                    warp = 4 * wg + wq
                    a_off = lanes * 128 + ((warp ^ (lanes & 7)) << 4)
                    r = _ldmatrix_x4(w_smem[st], (q // 2) * 32 * 128 + a_off, trans=True)
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        sc = scales[h][16 * warp + 2 * g:16 * warp + 2 * g + 2]
                        pairs = _fragment_pairs(mode, h, int(r[lane, 2 * (q % 2)]),
                                                int(r[lane, 2 * (q % 2) + 1]), sc)
                        for j, (row, kk) in enumerate([(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                                       (g + 8, 2 * t + 8)]):
                            a_mat[16 * wq + row, kk], a_mat[16 * wq + row, kk + 1] = pairs[j]
                    # warpgroup row 16 wq + g is column 16 warp + 2 g, row + 8 the next
                    col_of_row[16 * wq:16 * wq + 16] = 16 * warp + np.array(
                        [2 * (i8 % 8) + i8 // 8 for i8 in range(16)])
                k_rows = 64 * st + 16 * q + np.arange(16)
                np.testing.assert_array_equal(a_mat, weight[h][k_rows][:, col_of_row].T)
                b_mat = _wgmma_b(x_smem[st][h], nb, q)
                np.testing.assert_array_equal(b_mat, x[:, 128 * h + k_rows].float().numpy().T)
                d[h] += a_mat @ b_mat
        for h in range(halves):  # the group sum times its scales where int4_matmul applies them
            scale = scales[h][col_of_row, None] if mode == quant.MODE_INT4 else 1.0
            out[:, col_of_row] += (d[h] * scale).T
    if mode == quant.MODE_INT8:
        out *= scales[0]  # the per-channel scales in the epilogue
    xf = x.double().numpy()
    scaled = [weight[h] if mode == quant.MODE_INT4_DEQUANT else weight[h] * scales[h]
              for h in range(halves)]
    want = sum(xf[:, 128 * h:128 * (h + 1)] @ scaled[h] for h in range(halves))
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def _emulate_launch(plan: dict, mode: int, x, w, scales) -> np.ndarray:
    """The kernel's arithmetic block by block on the plan, in float64: a
    block's rows of x (zeros past M) against its 128 columns (zeros past N),
    each K pair as the kernel takes it (int8: 128 rows, zeros past K; int4:
    one scale group of each K-half, its f32 group sum times the group's
    scales (int4_matmul), or the dequantized values (int4_matmul_smallm)),
    the partial tiles of a K split summed in rank order, int8's scales in
    the epilogue."""
    m, k = x.shape
    n = w.shape[1]
    nb, cb = plan["nb"], plan["cb"]
    xb = np.zeros((cb * nb, k + 128))
    xb[:m, :k] = x.to(torch.bfloat16).double().numpy()
    cols = plan["col_blocks"] * 128
    sc = np.zeros((scales.shape[0], cols))
    sc[:, :n] = scales.double().numpy()
    if mode == quant.MODE_INT8:
        wv = np.zeros((plan["units"] * 128, cols))
        wv[:k, :n] = w.double().numpy()
    else:
        lo, hi = quant._unpack_int4(w)
        wv = np.zeros((k, cols))
        wv[:, :n] = torch.cat([lo, hi]).double().numpy()
        if mode == quant.MODE_INT4_DEQUANT:
            deq = quant._int4_dequant(w, scales).to(torch.bfloat16).double().numpy()
            wv[:, :n] = deq
    partial = {}
    for col, br, (u0, u1), rank in _blocks(plan):
        rows, cs = slice(br * nb, br * nb + nb), slice(128 * col, 128 * col + 128)
        acc = np.zeros((nb, 128))
        for u in range(u0, u1):
            if mode == quant.MODE_INT8:
                kr = slice(128 * u, 128 * u + 128)
                acc += xb[rows, kr] @ wv[kr, cs]
                continue
            for g in (u, plan["units"] + u):  # the low half's group, then the high half's
                kr = slice(128 * g, 128 * g + 128)
                part = xb[rows, kr] @ wv[kr, cs]
                acc += part * sc[g, cs] if mode == quant.MODE_INT4 else part
        partial.setdefault((col, br), [None] * plan["cluster"])[rank] = acc
    y = np.zeros((cb * nb, cols))
    for (col, br), tiles in partial.items():
        tile = np.zeros((nb, 128))
        for t in tiles:  # the cluster's partial tiles in rank order
            tile += t
        y[br * nb:br * nb + nb, 128 * col:128 * col + 128] = tile
    if mode == quant.MODE_INT8:
        y *= sc[0]
    return y[:m, :n]


@pytest.mark.parametrize("m,k,n", [(40, 1024, 272), (100, 1024, 256), (257, 512, 128),
                                   (1000, 256, 144)])
@pytest.mark.parametrize("name", sorted(MODES))
def test_wgmma_launch_emulation_equals_the_plain_version(name, m, k, n):
    mode = MODES[name]
    rng = np.random.default_rng(11)
    w = torch.from_numpy((rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32))
    q, s = quant.quantize_per_channel(w) if mode == quant.MODE_INT8 else \
        quant.quantize_int4_grouped(w)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    plan = quant.wgmma_plan(m, n, k, SMS, mode)
    got = _emulate_launch(plan, mode, x, q, s)
    want = PLAIN[mode](x.to(torch.bfloat16).float(), q, s).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_wgmma_launch_emulation_splits_k_over_a_cluster():
    """The tiny shapes above reach the K split and the batch blocks the
    emulation must sum in rank order."""
    assert quant.wgmma_plan(40, 272, 1024, SMS, quant.MODE_INT4)["cluster"] > 1
    assert quant.wgmma_plan(40, 272, 1024, SMS, quant.MODE_INT8)["cluster"] > 1
    assert quant.wgmma_plan(1000, 144, 256, SMS, quant.MODE_INT8)["cb"] == 8


# ---------------------------------------------------------------------------
# The w8a8 mode (int8_matmul_w8a8 at 16 < M <= PALLAS_DEQUANT_MAX_M)

# the 7B split layer and the lm_head; two qblocks with a last column block
# partly inside N; one qblock of 192 columns in two pairs, the second partly
# past K
W8A8_SHAPES = LAYER_7B + [(1024, 272), (192, 128)]
W8A8_MS = [17, 40, 64, 100, 256, 257, 1000, 1024]


def _check_w8a8_wgmma_plan(plan: dict, m: int, k: int, n: int) -> None:
    """Every (16-column strip, batch block, K pair) once, batch blocks of an
    s8 wgmma width covering M with none empty, each rank's K share whole
    qblocks, the ring within a block's shared memory (half an SM's where two
    blocks fit one)."""
    nb, cb, c, units = plan["nb"], plan["cb"], plan["cluster"], plan["units"]
    qblock, qbu = plan["qblock"], plan["qblock_units"]
    assert qblock == min(512, k) and qbu == -(-qblock // 128) and units == -(-k // 128)
    assert units == qbu * (k // qblock)
    assert nb in quant.W8A8_WGMMA_NB and (cb - 1) * nb < m <= cb * nb and cb >= -(-m // 128)
    assert plan["col_blocks"] == -(-n // 128) and 1 <= c <= min(8, k // qblock)
    assert plan["grid"] == (plan["col_blocks"] * cb * c,)
    ranges = plan["unit_ranges"]
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(lo < hi and lo % qbu == 0 and hi % qbu == 0 for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    cover = np.zeros((n // 16, cb, units), np.int32)
    for col, br, (u0, u1), _ in _blocks(plan):
        cover[8 * col:min(8 * col + 8, n // 16), br, u0:u1] += 1
    assert (cover == 1).all()
    assert plan["blocks_per_sm"] == quant.cpu_blocks_per_sm(quant.MODE_W8A8, nb)
    two = plan["blocks_per_sm"] == 2
    stage, slot = quant.wgmma_stage_bytes(quant.MODE_W8A8, nb), plan["sx_slot"]
    assert plan["stage_bytes"] == stage and slot % 128 == 0 and nb * 4 <= slot < nb * 4 + 128
    assert 4 <= plan["stages"] <= quant.WGMMA_MAX_STAGES
    assert plan["smem_bytes"] == max(plan["stages"] * stage, nb * 132 * 4) \
        + plan["stages"] * (slot + 16) + 1024
    if two:
        assert 2 * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM
    assert plan["smem_bytes"] <= SMEM_LIMIT


@pytest.mark.parametrize("m", W8A8_MS)
@pytest.mark.parametrize("k,n", W8A8_SHAPES)
def test_w8a8_wgmma_plan_covers_every_strip_batch_block_and_qblock_once(k, n, m):
    _check_w8a8_wgmma_plan(quant.wgmma_plan(m, n, k, SMS, quant.MODE_W8A8), m, k, n)


@pytest.mark.parametrize("m", [40, 256])
def test_w8a8_wgmma_plan_fits_gate_up_and_kv(m):
    """k/v_proj (4 column blocks, 7 qblocks: at most 28 blocks by the K
    split alone) take narrower batch blocks, more than 28 blocks in all. At
    M = 40 (NB = 48, two blocks an SM) gate/up_proj's 148 blocks run in one
    wave. At M = 256 they are 296 blocks of 128 batch rows, one an SM: three
    waves, the last of 32 (a K split in whole qblocks cannot even out 7
    qblocks over the tail)."""
    gate = quant.wgmma_plan(m, 18944, 3584, SMS, quant.MODE_W8A8)
    kv = quant.wgmma_plan(m, 512, 3584, SMS, quant.MODE_W8A8)
    assert kv["grid"][0] > 28 and kv["cluster"] == 7 and kv["cb"] > -(-m // 128)
    assert gate["cluster"] == 1
    if m == 40:
        assert gate["nb"] == 48 and gate["blocks_per_sm"] == 2 and gate["grid"][0] <= 2 * SMS
    else:
        assert gate["nb"] == 128 and gate["blocks_per_sm"] == 1 and gate["grid"] == (296,)


@pytest.mark.parametrize("m,n,k", [(16, 512, 3584), (1025, 512, 3584), (40, 120, 3584),
                                   (40, 512, 576), (40, 512, 96), (40, 0, 3584)])
def test_w8a8_wgmma_plan_raises_on_what_the_kernel_does_not_take(m, n, k):
    with pytest.raises(ValueError):  # M outside (16, cut], N % 16, K % qblock, K % 64
        quant.wgmma_plan(m, n, k, SMS, quant.MODE_W8A8)


@pytest.mark.parametrize("m", [17, 40, 1024])
def test_w8a8_prefill_tile_takes_only_m_above_the_cut(m):
    with pytest.raises(ValueError):
        quant.w8a8_plan(m, 512, 3584, SMS)
    assert quant.w8a8_plan(quant.PALLAS_DEQUANT_MAX_M + 1, 512, 3584, SMS)["bm"] == 192


def test_w8a8_wgmma_plan_reads_the_card_s_cluster_count():
    asked = set()

    def two(c, nb, stages):
        asked.add((nb, stages))
        return 264 // c if c <= 2 else 0

    plan = quant.wgmma_plan(40, 512, 3584, SMS, quant.MODE_W8A8, two)
    assert plan["cluster"] == 2 and asked == {(plan["nb"], plan["stages"])}
    with pytest.raises(ValueError):
        quant.wgmma_plan(40, 512, 3584, SMS, quant.MODE_W8A8, lambda c, nb, stages: 0)
    plan = quant.wgmma_plan(1000, 512, 3584, SMS, quant.MODE_W8A8,
                            lambda c, nb, stages: 132 // c if c <= 4 else 0)
    assert plan["cluster"] == 4 and plan["grid"] == (4 * 8 * 4,)


def test_wgmma_plan_sizes_the_ring_by_the_kernel_s_blocks_an_sm():
    """The ring takes a block's share of the SM's shared memory at the
    blocks an SM the built kernel reports (the wrapper asks the C entry;
    by default cpu_blocks_per_sm)."""
    asked = []

    def per_sm(count):
        def blocks(nb):
            asked.append(nb)
            return count
        return blocks

    two = quant.wgmma_plan(40, 18944, 3584, SMS, quant.MODE_W8A8, blocks_per_sm=per_sm(2))
    one = quant.wgmma_plan(40, 18944, 3584, SMS, quant.MODE_W8A8, blocks_per_sm=per_sm(1))
    assert asked == [48, 48] and two == quant.wgmma_plan(40, 18944, 3584, SMS, quant.MODE_W8A8)
    assert two["blocks_per_sm"] == 2 and one["blocks_per_sm"] == 1
    assert 2 * (two["smem_bytes"] + 1024) <= SMEM_PER_SM < 2 * (one["smem_bytes"] + 1024)
    assert one["stages"] > two["stages"] and one["smem_bytes"] <= SMEM_LIMIT
    assert quant.wgmma_plan(256, 512, 3584, SMS, quant.MODE_INT8, blocks_per_sm=per_sm(1)) \
        == quant.wgmma_plan(256, 512, 3584, SMS, quant.MODE_INT8)


def _wgmma_b_s8(box: np.ndarray, nb: int, i: int) -> np.ndarray:
    """The K-major s8 B operand [32 k x nb rows] of k32 step i, as
    desc_sw128(box + 32 i, 16, 1024) addresses the 128-byte swizzled box:
    row n's 8-row group 1024 bytes apart, its row 128 bytes, the step 32
    bytes in, the 16-byte chunk XORed with n % 8."""
    out = np.zeros((32, nb), np.int64)
    for n in range(nb):
        for kk in range(32):
            logical = 32 * i + kk
            at = (n // 8) * 1024 + (n % 8) * 128 + (((logical // 16) ^ (n % 8)) << 4) \
                + logical % 16
            out[kk, n] = _s8(int(box[at]))
    return out


@pytest.mark.parametrize("nb", [48, 128])
def test_w8a8_wgmma_qblock_emulation_gives_the_plain_terms(nb):
    """One 512-column qblock (four pairs, each a ring stage of two 64-row
    weight boxes and an xq box) of one block with nb batch rows (nb - 5 of
    x, zeros past them as TMA fills), both consumer warpgroups, each k32
    step, emulated instruction by instruction: the quantizer's xq (each
    16-column group stored sigma16-permuted) in the pair's swizzled box, the
    weight boxes as TMA writes them side by side, each A
    fragment from one transposed ldmatrix and four byte permutes, the B
    operand as the descriptor addresses it, the m64nNBk32 s8 products in the
    accumulator layout, the epilogue's (batch row, column) of each
    accumulator and the sx slot's row of each. The sums must be the exact
    integer products, and their terms float(sum) * sx the plain version's
    bit for bit."""
    rng = np.random.RandomState(nb)
    rows, qblock = nb - 5, 512
    x = torch.tensor(rng.randn(rows, qblock) * 2, dtype=torch.float32).to(torch.bfloat16)
    w = rng.randint(-127, 128, size=(qblock, 128)).astype(np.int8)
    xf = x.float()
    sx = xf.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    xq = np.zeros((nb, qblock), np.int64)
    xq[:rows] = torch.clamp(torch.round(xf / sx[:, None]), -127, 127).to(torch.int64).numpy()
    perm = np.array([16 * (c // 16) + _sigma16(c % 16) for c in range(qblock)])
    stored = xq[:, perm].astype(np.int8).view(np.uint8)  # position p holds column perm[p]
    slot = np.zeros(nb, np.float32)
    slot[:rows] = sx.numpy()  # the qblock's row scales, zeros past M
    w_bytes = w.view(np.uint8)
    lanes = np.arange(32)
    y = np.zeros((nb, 128), np.int64)
    b_of = {}
    for wg in range(2):
        d = np.zeros((64, nb), np.int64)  # [warpgroup row][batch row]
        col_of_row = np.zeros(64, np.int64)
        for u in range(qblock // 128):
            w_smem = np.concatenate([_swizzle128(np.ascontiguousarray(
                w_bytes[128 * u + 64 * s:128 * u + 64 * s + 64])) for s in range(2)])
            box = _swizzle128(np.ascontiguousarray(stored[:, 128 * u:128 * u + 128]))
            for i in range(4):  # the pair's k32 steps: its weight rows 32 i .. 32 i + 31
                a_mat = np.zeros((64, 32), np.int64)
                for wq in range(4):
                    warp = 4 * wg + wq
                    a_off = lanes * 128 + ((warp ^ (lanes & 7)) << 4)
                    r = _ldmatrix_x4(w_smem, i * 32 * 128 + a_off, trans=True)
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        rr = [int(v) for v in r[lane]]
                        a = [_byte_perm(rr[0], rr[1], 0x6420), _byte_perm(rr[0], rr[1], 0x7531),
                             _byte_perm(rr[2], rr[3], 0x6420), _byte_perm(rr[2], rr[3], 0x7531)]
                        for reg, (row, k0) in enumerate([(g, 4 * t), (g + 8, 4 * t),
                                                         (g, 16 + 4 * t), (g + 8, 16 + 4 * t)]):
                            for jj in range(4):
                                a_mat[16 * wq + row, k0 + jj] = _s8((a[reg] >> (8 * jj)) & 0xFF)
                    # warpgroup row 16 wq + g is column 16 warp + 2 g, row + 8 the next
                    col_of_row[16 * wq:16 * wq + 16] = 16 * warp + np.array(
                        [2 * (i8 % 8) + i8 // 8 for i8 in range(16)])
                k_pos = 128 * u + 32 * i + np.arange(32)  # stored positions of the step
                np.testing.assert_array_equal(a_mat, w[perm[k_pos]][:, col_of_row].T)
                if (u, i) not in b_of:
                    b_of[u, i] = _wgmma_b_s8(box, nb, i)
                    np.testing.assert_array_equal(b_of[u, i], xq[:, perm[k_pos]].T)
                d += a_mat @ b_of[u, i]
        assert np.abs(d).max() < 2 ** 31  # exact in the s32 tile
        for wq in range(4):  # acc[4j + 2h + e]: column n_a + h, batch row 8j + 2t + e
            warp = 4 * wg + wq
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for j in range(nb // 8):
                    for h in range(2):
                        for e in range(2):
                            y[8 * j + 2 * t + e, 16 * warp + 2 * g + h] = \
                                d[16 * wq + g + 8 * h, 8 * j + 2 * t + e]
        assert sorted(col_of_row) == list(range(64 * wg, 64 * wg + 64))
    np.testing.assert_array_equal(y, xq @ w.astype(np.int64))
    terms = torch.from_numpy(y.astype(np.float32)) * torch.from_numpy(slot)[:, None]
    plain = (torch.from_numpy(xq[:rows].astype(np.float32)) @ torch.from_numpy(
        w.astype(np.float32))) * sx[:, None]  # the plain version's term of one block
    assert torch.equal(terms[:rows], plain) and not terms[rows:].any()
