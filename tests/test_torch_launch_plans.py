"""The launch plans of the two wgmma kernels, and the fragment arithmetic of
the w8a8 kernel, checked on the CPU (the kernels themselves run only on the
card: tests/test_torch_cuda_kernels.py).

- `quant.w8a8_plan` (the wgmma w8a8 kernel, M > 16): every output tile of
  y [M, N] is covered exactly once, the K splits fall on whole 512-column
  activation blocks and cover K exactly once, and the ring fits the card's
  232,448 bytes of shared memory a block, at the 7B (K, N) layouts and the
  M the path and the tests use; it refuses decode M.
- `quant.w8a8_swapab_plan` (the w8a8 mode of csrc/quant_swapab.cu, M <=
  16): every (16-column strip, qblock) once, K shares of whole qblocks,
  clusters of at most 8, two blocks an SM, gate/up_proj at 7B in one wave
  and k/v_proj on more than 28 blocks; an emulation of a block's qblock
  (the quantizer's stores of xq in fragment order, TMA's 128- and 64-byte
  swizzles, the transposed ldmatrix and byte permutes, the m16n8k32 s8
  products and their scaling) gives the plain version's exact sums and its
  f32 terms bit for bit, with conflict-free shared-memory accesses.
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
  TMA): a kernel for every 1 <= valid_len <= n and every head_dim % 8 from
  32 to 128, K and V streamed in one pass ("flash"), whose work tiles
  cover every query row once, its key tiles every valid key once with only
  the last one masked, its shared memory fits a block and its live
  accumulators the consumer warpgroups' register budget; it raises beyond;
  and every tower of the registry whose attention reaches the kernel
  (`nn.mha`'s route: unmasked self-attention of >= 192 tokens) is inside
  the plan at its registry geometry.
- `quant.int4_plan` and `quant.int8_plan` (the swap-AB weight-only kernel,
  csrc/quant_swapab.cu): every (16-column strip, K unit) once, clusters of
  at most 8 that split K for the narrow products only, two blocks an SM;
  a bit-level emulation of one stage of each mode (TMA's swizzle, ldmatrix,
  the nibble and int8 conversions, the mma fragment layouts) rebuilds the
  weight tile and the plain sums exactly.
- `paged_attention.paged_plan` (the paged decode attention,
  csrc/paged_attention.cu): every valid token of a (row, kv head) pair in
  one split (the kernel's shares, `_paged_shares`), at most 8 splits, the
  same shares at table widths 38 and 64; for pages of any size, the
  producer's boxes fill each tile's 16 rows once, inside their pages and
  the stage's padding;
  an emulation of one tile through one warp (S^T = K Q^T with int8 keys in
  ldmatrix's order, P^T by movmatrix, Out^T = V^T P^T) gives the exact
  products.
- `vit_sublayer.attn_sublayer_plan` (the encoder attention sublayer's
  products on the wgmma GEMM): q/k/v's one launch covers every (product,
  column tile, row tile) once, column tiles fastest, and so does o's, at
  CLIP's and HuBERT's rows, at a ragged 3 x 77 and at narrow widths; it
  raises on widths the kernels do not take.
- `decode_attention.attention_plan` (with the kernel's shares,
  `_window_shares`) under decode_attn_o's WINDOW rule, and
  `decode_attn_o_plan` (the decode attention sublayer): every column of a
  row's window is in exactly one split's whole 16-column tiles (left pads, a
  window start that is no multiple of 16, T = 577, a window that ends early,
  a row with no valid column taking all of [0, T - 1]); the grid fits the
  card at once; the attention plan is the one decode_attn_o had before it
  moved; o_proj's swap-AB plan loads each W_o byte once a call at every b of
  1-512; the plan raises on what the kernels do not take.
- `decode_attention.decode_attention_plan` (any key mask, the MASK_ALL and
  MASK_WINDOW rules of the same kernel): the mode by batch, splits, ring,
  grid and shared memory at b 1-384 and T 77, 577, 640; every column of
  [0, T) in one share under MASK_ALL, every valid column in one share of the
  window's tiles under MASK_WINDOW and no tile for a row with no valid
  column; an emulation of `share_keys` (the mask bytes of a share copied in
  aligned 16-byte chunks from a row at any byte offset) and of the tiles'
  valid bits gives each tile exactly its valid columns below T, reads no
  chunk outside the mask and fits the plan's bytes.
"""

import numpy as np
import pytest

import torch

from affectgpt_tpu_torch.ops import _build, decode_attention, decode_attn_o, decode_gemm
from affectgpt_tpu_torch.ops import decode_mlp, paged_attention
from affectgpt_tpu_torch.ops import prefill_attention, quant
from affectgpt_tpu_torch.ops import vit_attention, vit_mlp, vit_mlp_fused, vit_sublayer

SMEM_LIMIT = 232_448  # bytes of shared memory an H100 block can use
SMS = 132
LAYER_7B = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064)]


SMEM_PER_SM = 233_472  # an H100 SM's shared memory; each resident block also reserves 1 KB


def _check_w8a8_swapab_plan(plan, m, k, n):
    """The swap-AB w8a8 plan: every (16-column strip, qblock) once, each
    rank's K share whole qblocks in stages that cover them, two blocks an SM."""
    c, units, bn, qblock = plan["cluster"], plan["units"], plan["block_n"], plan["qblock"]
    assert plan["nt"] == (1 if m <= 8 else 2) and bn in (64, 128)
    assert qblock == min(512, k) and units * qblock == k
    assert 1 <= c <= 8 and c <= units and plan["col_blocks"] == -(-n // bn)
    assert plan["grid"] == (c * plan["col_blocks"],)
    cover = np.zeros((n // 16, units), np.int32)
    for b in range(plan["grid"][0]):  # block b: column block b // c, rank b % c
        cb, rank = divmod(b, c)
        u0, u1 = plan["unit_ranges"][rank]
        assert u0 < u1  # every rank has whole qblocks to stream
        for s in range(bn // 16 * cb, min(bn // 16 * (cb + 1), n // 16)):
            cover[s, u0:u1] += 1
    assert (cover == 1).all()  # each weight byte is read by one block, once
    per_unit, rows = plan["stages_per_unit"], plan["rows"]
    assert (per_unit - 1) * rows < qblock <= per_unit * rows <= 16 * 32  # the xq buffer's steps
    assert plan["weight_bytes"] >= n * k and plan["stages"] * plan["stage_bytes"] == 64 * 1024
    assert plan["smem_bytes"] <= SMEM_LIMIT and 2 * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("m", [1, 8, 13, 16, 17, 64, 65, 200, 4512])
@pytest.mark.parametrize("k,n", LAYER_7B + [(64, 256), (1024, 512), (512, 272)])
def test_w8a8_plan_covers_every_tile_and_k_once(m, k, n):
    """Decode M (<= 16) on the swap-AB kernel's w8a8 mode, up to the cut the
    w8a8 mode of the wgmma weight-only kernel (every (16-column strip, batch
    row, K pair) once, K shares of whole qblocks; its full checks are
    tests/test_torch_quant_wgmma.py's), above it the prefill's 192-row
    tiles."""
    if m <= 16:
        _check_w8a8_swapab_plan(quant.w8a8_swapab_plan(m, n, k, SMS), m, k, n)
        return
    if m <= quant.PALLAS_DEQUANT_MAX_M:
        plan = quant.wgmma_plan(m, n, k, SMS, quant.MODE_W8A8)
        nb, cb, qbu = plan["nb"], plan["cb"], plan["qblock_units"]
        assert (cb - 1) * nb < m <= cb * nb and plan["qblock"] == min(512, k)
        cover = np.zeros((n // 16, cb * nb, plan["units"]), np.int32)
        c = plan["cluster"]
        for b in range(plan["grid"][0]):  # column block b // (cb c), batch block (b // c) % cb
            col, br, (u0, u1) = b // (cb * c), (b // c) % cb, plan["unit_ranges"][b % c]
            assert u0 % qbu == 0 and u1 % qbu == 0
            cover[8 * col:min(8 * col + 8, n // 16), br * nb:br * nb + nb, u0:u1] += 1
        assert (cover == 1).all() and plan["units"] * 128 >= k
        return
    plan = quant.w8a8_plan(m, n, k, SMS)
    bm, per, splits = plan["bm"], plan["k_per_split"], plan["splits"]
    assert bm == 192
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
    # decode: k_proj's 64-column blocks over a cluster of its 7 qblocks,
    # down_proj's 37 qblocks over a cluster too
    assert quant.w8a8_swapab_plan(8, 512, 3584, SMS)["cluster"] == 7
    assert quant.w8a8_swapab_plan(8, 3584, 18944, SMS)["cluster"] > 1
    for k, n in LAYER_7B:  # at prefill only a product of fewer tiles than SMs splits
        plan = quant.w8a8_plan(4512, n, k, SMS)
        assert (plan["splits"] == 1) == (plan["grid"][0] * plan["grid"][1] >= SMS)


def _sigma16(p):  # csrc/hopper.cuh sigma16
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


# ---------------------------------------------------------------------------
# The w8a8 mode of the swap-AB kernel (csrc/quant_swapab.cu), M <= 16


@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("k,n", [(3584, 4608), (3584, 37888), (3584, 112), (2560, 256),
                                 (192, 272)])
def test_w8a8_swapab_plan_covers_every_strip_and_qblock_once(m, k, n):
    """The fused 7B layout's qkv and gate/up_proj, a narrow N, five qblocks,
    one qblock of 192 columns in two stages (the split layout's shapes are
    test_w8a8_plan_covers_every_tile_and_k_once's)."""
    _check_w8a8_swapab_plan(quant.w8a8_swapab_plan(m, n, k, SMS), m, k, n)


@pytest.mark.parametrize("m", [1, 8, 16])
def test_w8a8_swapab_plan_fills_the_card_in_one_wave(m):
    """Two blocks an SM: gate/up_proj's 148 whole-K blocks run in one wave;
    k/v_proj take 64-column blocks (8 x 7 qblocks: 56 blocks, not 4 x 7);
    every product of a 7B layer but the lm_head fits the card at once."""
    gate = quant.w8a8_swapab_plan(m, 18944, 3584, SMS)
    assert gate["cluster"] == 1 and gate["grid"] == (148,) and 148 <= 2 * SMS
    kv = quant.w8a8_swapab_plan(m, 512, 3584, SMS)
    assert kv["block_n"] == 64 and kv["grid"][0] > 28
    for k, n in LAYER_7B[:-1] + [(3584, 4608), (3584, 37888)]:
        plan = quant.w8a8_swapab_plan(m, n, k, SMS)
        assert plan["grid"][0] <= 2 * SMS or n == 37888  # the fused gate/up: 296 blocks
        assert plan["block_n"] == (64 if n == 512 else 128)


@pytest.mark.parametrize("m,n,k", [(0, 512, 3584), (17, 512, 3584), (8, 120, 3584),
                                   (8, 512, 576), (8, 512, 96), (8, 0, 3584)])
def test_w8a8_swapab_plan_raises_on_what_the_kernel_does_not_take(m, n, k):
    with pytest.raises(ValueError):  # M outside 1-16, N % 16, K % qblock, K % 64
        quant.w8a8_swapab_plan(m, n, k, SMS)


def test_w8a8_swapab_plan_reads_the_card_s_cluster_count():
    plan = quant.w8a8_swapab_plan(8, 512, 3584, SMS, lambda c, bn: 264 // c if c <= 2 else 0)
    assert plan["cluster"] <= 2
    with pytest.raises(ValueError):
        quant.w8a8_swapab_plan(8, 512, 3584, SMS, lambda c, bn: 0)


def test_w8a8_wgmma_plan_refuses_decode_m():
    with pytest.raises(ValueError):
        quant.w8a8_plan(16, 512, 3584, SMS)


def _swizzle64(tile: np.ndarray) -> np.ndarray:
    """A [rows, 64]-byte tile as TMA writes it with the 64-byte swizzle:
    16-byte chunk c of row r at chunk c ^ (r / 2 % 4); flat bytes."""
    out = np.empty_like(tile)
    for r in range(tile.shape[0]):
        for c in range(4):
            p = c ^ ((r // 2) % 4)
            out[r, 16 * p:16 * p + 16] = tile[r, 16 * c:16 * c + 16]
    return out.reshape(-1)


def _xq_word(s, nt, g, t, h, tiles):  # csrc/quant_swapab.cu xq_word
    return ((s * tiles + nt) * 32 + ((4 * g + t) ^ s)) * 2 + h


def _s8(byte: int) -> int:
    return byte - 256 if byte >= 128 else byte


def _quantize_value(v, s):
    """csrc/quant_swapab.cu quantize_value in float32: p = v * (1 / s), p +
    1.5 2^23 rounded (half to even), the IEEE quotient within 3e-5 of a half,
    clipped to +-127."""
    f = np.float32
    r = f(1) / s
    p = v * r
    magic = f(12582912.0)
    t = p + magic
    q = (t.view(np.int32) - magic.view(np.int32)).astype(np.int64)
    near = np.abs(p - (t - magic)) > f(0.49997)
    q[near] = np.rint(v[near] / s).astype(np.int64)
    return np.clip(q, -127, 127)


def test_w8a8_swapab_quantizer_rounds_as_ieee_division():
    """The kernel's quantizer (a product with the reciprocal, the division
    only near a half) gives clip(rint(v / s)) of the IEEE quotient: on random
    rows at their own scale, and on values placed at, and a few ulps either
    side of, every half-integer quotient of 0.5-126.5 for many scales."""
    rng = np.random.RandomState(7)
    f = np.float32
    for _ in range(200):
        v = (rng.randn(512) * rng.choice([1e-6, 1e-2, 1.0, 30.0, 3e4])).astype(f)
        amax = np.abs(v).max()
        s = np.maximum(amax, f(1e-8)) / f(127)
        np.testing.assert_array_equal(_quantize_value(v, s), np.clip(np.rint(v / s), -127, 127))
    halves = np.arange(-126.5, 127, 1.0)
    for s in (np.abs(rng.randn(300)) * f(0.05) + f(1e-4)).astype(f):
        v = (halves * s).astype(f)
        v = np.concatenate([np.nextafter(v, np.inf), np.nextafter(v, -np.inf), v,
                            np.nextafter(np.nextafter(v, np.inf), np.inf)]).astype(f)
        want = np.clip(np.rint(v / s), -127, 127)
        np.testing.assert_array_equal(_quantize_value(v, s), want)


@pytest.mark.parametrize("nt", [1, 2])
@pytest.mark.parametrize("bn", [128, 64])
def test_w8a8_swapab_qblock_emulation_gives_the_plain_terms(nt, bn):
    """One 512-column qblock of one block of the w8a8 mode, every consumer
    warp, emulated instruction by instruction: the quantizer's sx and xq (f32
    IEEE division, round half to even) stored word by word at xq_word (each
    store of a row's lanes on its own bank); the four stages of weights as
    TMA writes them (128- or 64-byte swizzle); each k32 step's transposed
    ldmatrix and byte permutes (the A fragment), the B fragment from one
    8-byte load (a warp's loads 256 contiguous bytes), the m16n8k32 s8
    product in its C layout and the epilogue's (column, batch row) of each
    accumulator. The sums must be the exact integer products and the
    qblock's f32 terms, float(sum) * sx, the plain version's bit for bit."""
    rng = np.random.RandomState(6 + nt)
    m, qblock = 8 * nt - 3, 512  # the last three batch rows are padding
    x = torch.tensor(rng.randn(m, qblock) * 2, dtype=torch.float32).to(torch.bfloat16)
    w = rng.randint(-127, 128, size=(qblock, bn)).astype(np.int8)
    xf = x.float()
    sx = xf.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    xq = np.zeros((8 * nt, qblock), np.int64)
    xq[:m] = torch.clamp(torch.round(xf / sx[:, None]), -127, 127).to(torch.int64).numpy()
    words = np.zeros(16 * nt * 64, np.int64)
    written = np.zeros(words.shape, bool)
    for row in range(8 * nt):
        for t in range(4):
            stores = []
            for lane in range(qblock // 16):
                a = _xq_word(lane // 2, row // 8, row % 8, t, lane % 2, nt)
                words[a] = sum((int(xq[row, 16 * lane + _sigma16(4 * t + j)]) & 0xFF) << (8 * j)
                               for j in range(4))
                written[a] = True
                stores.append(a)
            assert len({a % 32 for a in stores}) == 32  # conflict-free
    assert written.all()
    swizzle = _swizzle128 if bn == 128 else _swizzle64
    lanes = np.arange(32)
    y = np.zeros((8 * nt, bn), np.int64)
    for warp in range(bn // 16):
        if bn == 128:
            a_off = lanes * 128 + ((warp ^ (lanes & 7)) << 4)
        else:
            a_off = lanes * 64 + ((warp ^ ((lanes >> 1) & 3)) << 4)
        d = np.zeros((nt, 32, 4), np.int64)
        for s in range(qblock // 128):
            tile = swizzle(np.ascontiguousarray(w[128 * s:128 * s + 128]).view(np.uint8))
            for j in range(4):
                r = _ldmatrix_x4(tile, j * 32 * bn + a_off, trans=True)
                step = 4 * s + j
                for tn in range(nt):
                    reads = [_xq_word(step, tn, lane // 4, lane % 4, 0, nt) for lane in range(32)]
                    assert sorted(reads) == list(range(min(reads), min(reads) + 64, 2))
                    a_mat, b_mat = np.zeros((16, 32), np.int64), np.zeros((32, 8), np.int64)
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        rr = [int(v) for v in r[lane]]
                        a = [_byte_perm(rr[0], rr[1], 0x6420), _byte_perm(rr[0], rr[1], 0x7531),
                             _byte_perm(rr[2], rr[3], 0x6420), _byte_perm(rr[2], rr[3], 0x7531)]
                        for reg, (row, k0) in enumerate([(g, 4 * t), (g + 8, 4 * t),
                                                         (g, 16 + 4 * t), (g + 8, 16 + 4 * t)]):
                            for jj in range(4):
                                a_mat[row, k0 + jj] = _s8((a[reg] >> (8 * jj)) & 0xFF)
                        b0, b1 = int(words[reads[lane]]), int(words[reads[lane] + 1])
                        for jj in range(4):
                            b_mat[4 * t + jj, g] = _s8((b0 >> (8 * jj)) & 0xFF)
                            b_mat[16 + 4 * t + jj, g] = _s8((b1 >> (8 * jj)) & 0xFF)
                    prod = a_mat @ b_mat
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        d[tn, lane] += [prod[g, 2 * t], prod[g, 2 * t + 1], prod[g + 8, 2 * t],
                                        prod[g + 8, 2 * t + 1]]
        for tn in range(nt):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for e in range(4):  # batch row 8 nt + 2 t + e % 2, column n_a + e / 2
                    y[8 * tn + 2 * t + e % 2, 16 * warp + 2 * g + e // 2] = d[tn, lane, e]
    np.testing.assert_array_equal(y, xq @ w.astype(np.int64))
    terms = torch.from_numpy(y[:m].astype(np.float32)) * sx[:, None]
    plain = (torch.from_numpy(xq[:m].astype(np.float32)) @ torch.from_numpy(w.astype(np.float32))
             ) * sx[:, None]  # the plain version's term of one block
    assert torch.equal(terms, plain)


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


def _check_flash_plan(plan, n, valid, d, units):
    """The streaming design's plan: key tiles hold every valid key once and
    only the last may be masked; the work tiles of q_block_rows rows cover
    every query row of every unit once; the ring fits a block's shared
    memory; the consumer warpgroups' live accumulators fit their budget."""
    tile, rows = plan["key_tile"], plan["q_block_rows"]
    padded = plan["padded_head_dim"]
    assert padded % 16 == 0 and 0 <= padded - d < 16
    # three warpgroups on 64-key tiles at 80 and 96, two on 128-key tiles else
    wide = padded in vit_attention.WIDE_HEAD_DIMS
    assert plan["kernel"] == "flash" and (plan["consumers"], tile) == ((3, 64) if wide
                                                                       else (2, 128))
    assert (plan["key_tiles"] - 1) * tile < valid <= plan["key_tiles"] * tile
    assert plan["masked_tile"] == (plan["key_tiles"] * tile > valid)
    assert rows == 64 * plan["consumers"] and plan["threads"] == 128 * (plan["consumers"] + 1)
    assert (plan["q_blocks"] - 1) * rows < n <= plan["q_blocks"] * rows
    assert plan["work_tiles"] == units * plan["q_blocks"]
    assert plan["blocks"] == min(plan["work_tiles"], SMS) and plan["blocks_per_sm"] == 1
    boxes = -(-padded // 64)
    assert 2 <= plan["stages"] <= 4
    assert plan["smem_bytes"] == 1024 + 256 + plan["consumers"] * boxes * 8192 \
        + 2 * plan["stages"] * boxes * tile * 128
    assert plan["smem_bytes"] <= SMEM_LIMIT
    regs = plan["registers"]
    assert 128 * (regs["producer"] + plan["consumers"] * regs["consumer"]) <= 65536
    assert regs["consumer"] % 8 == 0 and regs["producer"] % 8 == 0
    # S (a f32 a thread for every two keys), P (packed bf16), O and Q's
    # fragments, with 32 registers left for addresses, the row max and sum,
    # the loop
    assert plan["accumulator_registers"] == tile // 2 + tile // 4 + padded // 2 + padded // 4
    assert plan["accumulator_registers"] + 32 <= regs["consumer"]


def test_vit_attention_plan_picks_a_kernel_for_every_n():
    """At the towers' 64 images x 16 heads, every n up to 1025 and the long
    counts, at DINOv2's and SigLIP's head_dims: one flash plan each."""
    for n in list(range(1, 2 * vit_attention.RESIDENT_KEYS + 2)) + [1370, 4097]:
        for valid in sorted({1, n // 2 + 1, n}):
            for d in (64, 72) if n % 7 == 0 else (64,):
                plan = vit_attention.vit_attention_plan(n, valid, b=64, heads=16, sms=SMS,
                                                        head_dim=d)
                _check_flash_plan(plan, n, valid, d, 64 * 16)


@pytest.mark.parametrize("d", list(vit_attention.HEAD_DIMS))
def test_vit_attention_flash_plan_at_every_n_and_valid_len(d):
    """Every n up to 1025 and the zoo's long counts (DINOv2's 1370,
    VideoMAE's 1568, 4097), valid_len at 1, n / 2 + 1 and n, at each head_dim
    JAX's gate takes: the flash design's plan holds."""
    for n in list(range(1, 1026)) + [1370, 1568, 4097]:
        for valid in sorted({1, n // 2 + 1, n}):
            plan = vit_attention.vit_attention_plan(n, valid, b=3, heads=5, sms=SMS, head_dim=d)
            _check_flash_plan(plan, n, valid, d, 15)


@pytest.mark.parametrize("b,heads,n,valid,d", [
    (32, 16, 1370, 1370, 64), (32, 16, 729, 729, 72), (8, 6, 1568, 1568, 64),
    (3, 5, 129, 129, 88), (2, 3, 700, 650, 120), (1, 1, 1, 1, 32), (5, 7, 300, 1, 128)])
def test_vit_attention_flash_work_tiles_cover_every_query_row_once(b, heads, n, valid, d):
    """The kernel's walk: block c takes work tiles c, c + blocks, ...; tile w
    is unit w // q_blocks (head u % heads, image u // heads) and its query
    rows q_block_rows (w % q_blocks) onward, the rows at or past n computed
    and not stored."""
    plan = vit_attention.vit_attention_plan(n, valid, b=b, heads=heads, sms=SMS, head_dim=d)
    assert plan["kernel"] == "flash"
    rows, q_blocks, blocks = plan["q_block_rows"], plan["q_blocks"], plan["blocks"]
    stored = np.zeros((b, heads, n), np.int32)
    for c in range(blocks):
        for w in range(c, plan["work_tiles"], blocks):
            u, qb = divmod(w, q_blocks)
            bi, hi = divmod(u, heads)
            stored[bi, hi, qb * rows:min(n, (qb + 1) * rows)] += 1
    assert (stored == 1).all()
    per_block = [len(range(c, plan["work_tiles"], blocks)) for c in range(blocks)]
    assert max(per_block) - min(per_block) <= 1  # balanced to one tile


@pytest.mark.parametrize("d", list(vit_attention.HEAD_DIMS))
def test_vit_attention_plan_pads_each_head_dim_to_the_wgmma_k_step(d):
    plan = vit_attention.vit_attention_plan(729, head_dim=d, b=32, heads=16, sms=SMS)
    assert plan["kernel"] == "flash" and plan["padded_head_dim"] == -(-d // 16) * 16
    assert plan["padded_head_dim"] % 16 == 0 and plan["padded_head_dim"] - d < 16
    boxes = -(-plan["padded_head_dim"] // 64)  # 64-value TMA boxes a tile
    # the Q tiles of 64 rows, then K and V rings of key tiles: four stages
    # each at one box and at 80 and 96 (64-key tiles), three at 112 and 128
    assert plan["stages"] == (4 if boxes == 1 or plan["key_tile"] == 64 else 3)
    assert plan["smem_bytes"] == 1024 + 256 + plan["consumers"] * boxes * 8192 \
        + 2 * plan["stages"] * boxes * plan["key_tile"] * 128
    assert plan["smem_bytes"] <= SMEM_LIMIT


def test_vit_attention_routing_rule():
    """Every shape takes the flash design, which took less time than the
    resident designs at CLIP's 257 tokens, ImageBind's 229 and HuBERT's 99
    as well as at the long shapes."""
    route = lambda n, valid=None, d=64: vit_attention.vit_attention_plan(  # noqa: E731
        n, valid, head_dim=d)["kernel"]
    assert route(257) == route(229) == route(99) == route(512) == route(1370) == "flash"
    assert route(729, d=72) == route(64, d=128) == route(1568) == route(1370, 300) == "flash"


@pytest.mark.parametrize("n,valid,d", [(0, 0, 64), (100, 0, 64), (100, 101, 64),
                                       (513, 513, 24), (1370, 1370, 136), (729, 729, 76)])
def test_vit_attention_plan_raises_beyond_max_n(n, valid, d):
    """Outside 1 <= valid_len <= n, or a head_dim not a multiple of 8 from
    32 to 128 (JAX's route gate), the plan raises naming the limit."""
    with pytest.raises(ValueError, match="valid_len|head_dim"):
        vit_attention.vit_attention_plan(n, valid, head_dim=d)


def _mha_shape(name):
    """(tokens, head_dim) of the self-attention `nn.mha` runs in the zoo
    tower `name` at its registry geometry, or None where the tower's
    attention does not go through nn.mha with a token count of >= 192
    (CLIP and HuBERT run their own sublayer routes by default, EVA and
    WavLM their own attention chains, data2vec 99 frames a 2 s clip)."""
    from affectgpt_tpu_torch.models import encoders, imagebind_audio, vit_variants

    spec = encoders.VISUAL.get(name) or encoders.ACOUSTIC[name]
    cfg = spec.make_config()
    if isinstance(cfg, vit_variants.Dinov2Config):
        return (cfg.image_size // cfg.patch_size) ** 2 + 1, cfg.width // cfg.num_heads
    if isinstance(cfg, vit_variants.SiglipConfig):
        return (cfg.image_size // cfg.patch_size) ** 2, cfg.width // cfg.num_heads
    if isinstance(cfg, imagebind_audio.ImageBindAudioConfig):
        h, w = cfg.patch_grid
        return h * w + 1, cfg.width // cfg.num_heads
    return None


@pytest.mark.parametrize("name", ["DINO2_LARGE", "SigLIP_SO", "IMAGEBIND", "CLIP_VIT_LARGE",
                                  "EVA_CLIP_G", "EVA_CLIP_G_NO_QFORMER", "HUBERT_LARGE",
                                  "WAVLM_LARGE", "DATA2VEC_BASE"])
def test_every_zoo_tower_fits_the_fused_attention_plan(name):
    """nn._fused_self_attn_ok sends every unmasked self-attention of >= 192
    tokens to the kernel at any head_dim: each tower that reaches it must be
    inside the plan at its registry geometry (DINOv2-large 1370 tokens at
    64, SigLIP so400m 729 at 72, ImageBind 229 at 64), so a tower the kernel
    cannot take fails here, not first on the card. CLIP's flash route (257
    at 64) is held too."""
    from affectgpt_tpu_torch.models import clip_vit, nn

    shape = _mha_shape(name)
    if name == "CLIP_VIT_LARGE":
        cfg = clip_vit.ClipVisionConfig.vit_l_14()
        shape = (cfg.num_patches + 1, cfg.width // cfg.num_heads)
    want = {"DINO2_LARGE": (1370, 64), "SigLIP_SO": (729, 72), "IMAGEBIND": (229, 64),
            "CLIP_VIT_LARGE": (257, 64)}.get(name)
    assert shape == want
    if shape is not None:
        n, d = shape
        assert nn._fused_self_attn_ok(n, n, None)
        plan = vit_attention.vit_attention_plan(n, n, b=32, heads=16, sms=SMS, head_dim=d)
        assert plan["smem_bytes"] <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# The swap-AB kernel's int4 modes (csrc/quant_swapab.cu)

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


# ---------------------------------------------------------------------------
# The int8 mode of the swap-AB kernel (csrc/quant_swapab.cu)

INT8_SHAPES = LAYER_7B + [(3584, 4608), (3584, 37888), (64, 256), (1024, 512), (512, 272),
                          (4160, 16)]


@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("k,n", INT8_SHAPES)
def test_int8_plan_covers_every_strip_and_unit_once(m, k, n):
    plan = quant.int8_plan(m, n, k, SMS)
    c, units, rows, bn = plan["cluster"], plan["units"], plan["rows"], plan["block_n"]
    assert plan["nt"] == (1 if m <= 8 else 2)
    assert units == -(-k // rows) and (units - 1) * rows < k <= units * rows
    assert 1 <= c <= 8 and c <= units and plan["col_blocks"] == -(-n // bn)
    assert plan["grid"] == (c * plan["col_blocks"],)
    # block b: column block b // c, rank b % c and that rank's units
    cover = np.zeros((n // 16, units), np.int32)
    for b in range(plan["grid"][0]):
        cb, rank = divmod(b, c)
        u0, u1 = plan["unit_ranges"][rank]
        for s in range(bn // 16 * cb, min(bn // 16 * (cb + 1), n // 16)):
            cover[s, u0:u1] += 1
    assert (cover == 1).all()  # each weight byte is read by one block, once
    assert plan["weight_bytes"] >= n * k
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert 2 * (plan["smem_bytes"] + 1024) <= SMEM_PER_SM  # two blocks an SM


@pytest.mark.parametrize("m,n,k", [(0, 512, 3584), (17, 512, 3584), (8, 120, 3584),
                                   (8, 512, 96), (8, 512, 0), (8, 0, 3584)])
def test_int8_plan_raises_on_what_the_kernel_does_not_take(m, n, k):
    with pytest.raises(ValueError):  # M outside 1-16, N % 16, K % 64
        quant.int8_plan(m, n, k, SMS)


@pytest.mark.parametrize("m", [1, 8, 16])
def test_int8_plan_splits_k_for_narrow_products_only(m):
    """q/k/v/o_proj, qkv_proj and down_proj split K over a cluster; gate and
    up_proj (split and fused) and the lm_head fill the card whole-K."""
    for k, n in [(3584, 3584), (3584, 512), (3584, 4608), (18944, 3584)]:
        assert quant.int8_plan(m, n, k, SMS)["cluster"] >= 3
    for k, n in [(3584, 18944), (3584, 37888), (3584, 152064)]:
        assert quant.int8_plan(m, n, k, SMS)["cluster"] == 1


def test_int8_plan_reads_the_card_s_cluster_count():
    plan = quant.int8_plan(8, 512, 3584, SMS, lambda c: 264 // c if c <= 2 else 0)
    assert plan["cluster"] <= 2
    with pytest.raises(ValueError):
        quant.int8_plan(8, 512, 3584, SMS, lambda c: 0)


def _s8_halves(h: int):
    """mma_bf16.cuh s8_halves_to_bf16x2: for each 16-bit half, the bf16 0x4300
    | (b & 0x7F) times 1 plus the bf16 0xC300 | (b & 0x80), rounded once to
    bf16 (fma.rn.bf16x2); b the half's low byte."""
    out = []
    for half in (h & 0xFFFF, h >> 16):
        lo, neg = _bf16_value((half & 0x7F) | 0x4300), _bf16_value((half & 0x80) | 0xC300)
        out.append(_bf16_round(lo * 1.0 + neg))
    return out


def test_int8_conversion_is_exact_for_every_byte():
    rng = np.random.RandomState(5)
    for b in range(256):
        v = b - 256 if b >= 128 else b
        high = [int(x) for x in rng.randint(0, 256, size=2)]  # the ignored high bytes
        assert _s8_halves(b | (high[0] << 8) | ((255 - b) << 16) | (high[1] << 24)) == \
            [v, (255 - b) - 256 if 255 - b >= 128 else 255 - b]


@pytest.mark.parametrize("nt", [1, 2])
def test_int8_fragments_rebuild_the_weight_tile(nt):
    """One int8 stage of one block (128 rows x 128 columns), every consumer
    warp, emulated instruction by instruction: the swizzled weight and x
    tiles TMA writes, the transposed ldmatrix and the byte-pair conversions
    of each A fragment, the ldmatrix of each B fragment, the m16n8k16
    products. Every A fragment must hold the weight at the (n, k) the mma
    layout gives it, every B fragment x at its (k, m), and the products the
    plain sums."""
    rng = np.random.RandomState(4)
    rows, m = 128, 8 * nt
    w = rng.randint(0, 256, size=(rows, 128)).astype(np.uint8)  # bytes [k][n]
    values = (w.astype(np.int32) ^ 0x80) - 0x80
    x = torch.tensor(rng.randn(m, rows), dtype=torch.float32).to(torch.bfloat16)
    w_smem = _swizzle128(w)
    x_bits = x.view(torch.int16).numpy().view(np.uint16)
    x_smem = [_swizzle128(x_bits[:, 64 * b:64 * b + 64].copy().view(np.uint8)) for b in range(2)]
    lanes = np.arange(32)
    xrow = (lanes % 8) + 8 * (lanes // 16) if nt == 2 else lanes % 8
    xchunk = (lanes // 8) % 2 if nt == 2 else lanes // 8
    y = np.zeros((m, 128))
    for warp in range(8):
        d = np.zeros((16, m))  # [fragment row][batch row]
        for j in range(rows // 32):
            r = _ldmatrix_x4(w_smem, (32 * j + lanes) * 128 + ((warp ^ (lanes & 7)) << 4),
                             trans=True)
            box = x_smem[j // 2]
            loads = [_ldmatrix_x4(box, xrow * 128 + (((4 * (j % 2) + 2 * s + xchunk)
                                                      ^ (lanes & 7)) << 4), trans=False)
                     for s in range(nt)]
            for s in range(2):
                a_mat, b_mat = np.zeros((16, 16)), np.zeros((16, m))
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    w0, w1 = int(r[lane, 2 * s]), int(r[lane, 2 * s + 1])
                    pairs = [_s8_halves(w0), _s8_halves(w0 >> 8), _s8_halves(w1),
                             _s8_halves(w1 >> 8)]
                    for i, (row, col) in enumerate([(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                                    (g + 8, 2 * t + 8)]):
                        a_mat[row, col], a_mat[row, col + 1] = pairs[i]
                    for tile in range(nt):
                        regs = (loads[s][lane, 2 * tile:2 * tile + 2] if nt == 2
                                else loads[0][lane, 2 * s:2 * s + 2])
                        for i, kk in enumerate((2 * t, 2 * t + 8)):
                            b_mat[kk, 8 * tile + g] = _bf16_value(int(regs[i]) & 0xFFFF)
                            b_mat[kk + 1, 8 * tile + g] = _bf16_value(int(regs[i]) >> 16)
                cols = 16 * warp + np.array([2 * (i % 8) + i // 8 for i in range(16)])
                kp = 32 * j + 16 * s + np.arange(16)
                np.testing.assert_array_equal(a_mat, values[kp][:, cols].T)
                np.testing.assert_array_equal(b_mat, x[:, kp].float().numpy().T)
                d += a_mat @ b_mat
        cols = 16 * warp + np.array([2 * (i % 8) + i // 8 for i in range(16)])
        y[:, cols] += d.T
    np.testing.assert_allclose(y, x.double().numpy() @ values, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The paged decode attention kernel (csrc/paged_attention.cu)

PAGED_LENGTHS = [0, 1, 16, 17, 595]


def _paged_shares(n_tokens: int, width: int, blk: int, splits: int) -> list:
    """The token ranges [lo, hi) of the `splits` blocks of one (row, kv head)
    pair with seq_len n_tokens, as the kernel's share() computes them: the
    valid tokens are a prefix, n = min(n_tokens, width * blk), cut into
    16-token tiles, block r taking tiles [r T / C, (r + 1) T / C)."""
    n = max(0, min(n_tokens, width * blk))
    tiles = -(-n // 16)
    return [(min(n, 16 * (r * tiles // splits)), min(n, 16 * ((r + 1) * tiles // splits)))
            for r in range(splits)]


@pytest.mark.parametrize("width", [38, 64])
@pytest.mark.parametrize("blk", [16, 8, 32, 12, 4, 24, 1])
@pytest.mark.parametrize("b,kv,g,d", [(16, 4, 7, 128), (3, 2, 3, 64), (1, 1, 8, 128),
                                      (64, 4, 7, 128)])
def test_paged_plan_gives_every_valid_token_to_one_split(width, blk, b, kv, g, d):
    for int8 in (False, True):
        plan = paged_attention.paged_plan(b, kv, g, d, blk, width, int8, SMS)
        c = plan["splits"]
        assert 1 <= c <= 8 and plan["cluster"] == c and plan["grid"] == (b * kv * c,)
        assert b * kv * c <= 2 * SMS or c == 1  # the whole grid fits the card at once
        assert plan["stages"] % 4 == 0 and plan["smem_bytes"] <= SMEM_LIMIT
        for n in PAGED_LENGTHS:
            valid = min(n, width * blk)
            cover = np.zeros(valid, np.int32)
            shares = _paged_shares(n, width, blk, c)
            assert len(shares) == c
            for lo, hi in shares:
                assert lo % 16 == 0 and lo <= hi  # whole 16-token tiles
                cover[lo:hi] += 1
            assert (cover == 1).all()


def test_paged_plan_follows_the_tokens_not_the_table_width():
    """At the serve phase's shape (16 rows of 4 kv heads) widths 38 and 64
    give the same splits and the same shares of a row's tokens: the wider
    table adds no work."""
    p38, p64 = (paged_attention.paged_plan(16, 4, 7, 128, 16, w, False, SMS) for w in (38, 64))
    assert p38["splits"] == p64["splits"] == 4 and p38["grid"] == p64["grid"]
    for n in PAGED_LENGTHS:
        assert _paged_shares(n, 38, 16, 4) == _paged_shares(n, 64, 16, 4)


@pytest.mark.parametrize("kwargs", [dict(d=96), dict(d=256), dict(g=9), dict(g=0),
                                    dict(blk=0), dict(width=0), dict(splits=9)])
def test_paged_plan_raises_on_what_the_kernel_does_not_take(kwargs):
    args = dict(b=16, kv=4, g=7, d=128, blk=16, width=38, int8=False, sm_count=SMS)
    with pytest.raises(ValueError):
        paged_attention.paged_plan(**{**args, **kwargs})


@pytest.mark.parametrize("blk", [1, 2, 3, 4, 5, 7, 8, 12, 16, 20, 24, 32, 40, 48, 100])
def test_paged_page_boxes_fill_each_tile_once(blk):
    """The producer's boxes, as csrc/paged_attention.cu places them: for each
    page p holding a valid token of a tile at tok0, a box of min(blk, 16)
    rows from the page's row o = clamp(tok0 - p blk, 0, blk - rows), at
    stage row pad + p blk + o - tok0. Every box stays inside its page and the
    stage's padded rows, no two boxes of a tile overlap, and the tile's valid
    rows [0, 16) are each written once with the right token. Pages of 8 or a
    multiple of 16 need no padding; the plan's stage fits the card."""
    rows, pad = min(blk, 16), 16 if paged_attention.odd_pages(blk) else 0
    assert paged_attention.odd_pages(blk) == (blk != 8 and blk % 16 != 0)
    for n in (1, 15, 16, 17, 3 * blk + 5, 595):
        for tok0 in range(0, n, 16):
            written = {}  # stage row -> token
            first, last = tok0 // blk, (min(tok0 + 16, n) - 1) // blk
            assert last - first + 1 <= 17  # lanes of the producer warp
            for p in range(first, last + 1):
                o = min(max(tok0 - p * blk, 0), blk - rows)
                dst = pad + p * blk + o - tok0
                assert 0 <= o and o + rows <= blk  # inside the page
                assert 0 <= dst and dst + rows <= 16 + 2 * pad  # inside the stage's rows
                for r in range(rows):
                    assert dst + r not in written  # no overlap
                    written[dst + r] = p * blk + o + r
            for r in range(min(16, n - tok0)):
                assert written[pad + r] == tok0 + r
    for int8 in (False, True):
        plan = paged_attention.paged_plan(16, 4, 7, 128, blk, 38, int8, SMS)
        assert plan["smem_bytes"] <= SMEM_LIMIT


def _movmatrix_trans(regs: np.ndarray) -> np.ndarray:
    """movmatrix.sync.aligned.m8n8.trans.b16: lane l holds row l / 4,
    columns 2 (l % 4), 2 (l % 4) + 1 of a matrix; afterwards the same of its
    transpose."""
    mat = np.zeros((8, 8), np.uint64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        mat[g, 2 * t], mat[g, 2 * t + 1] = int(regs[lane]) & 0xFFFF, int(regs[lane]) >> 16
    out = np.zeros(32, np.uint64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out[lane] = int(mat[2 * t, g]) | (int(mat[2 * t + 1, g]) << 16)
    return out


def _bf16_bits(v: float) -> int:
    return int(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16).view(torch.int16)) & 0xFFFF


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d", [128, 64])
def test_paged_fragments_compute_one_tile(int8, d):
    """One 16-token tile of one kv head through one consumer warp, emulated
    instruction by instruction: the K and V tiles as TMA writes them
    (128-byte boxes, swizzled), Q's B fragments, S^T = K Q^T from the
    ldmatrix of K (int8: the byte permute and pair conversions, the head
    dimension in ldmatrix's order, Q's fragments following it), P^T moved
    into the B fragment by movmatrix, and Out^T = V^T P^T from the
    transposed ldmatrix of V (int8: the byte-pair conversions), the
    accumulator rows mapped back to d. S^T must be the exact K Q^T and
    Out^T the exact V^T P (P as the bf16 values the kernel multiplies)."""
    rng = np.random.RandomState(d + int8)
    heads = 7
    if int8:
        k_rows = rng.randint(0, 256, size=(16, d)).astype(np.uint8)
        v_rows = rng.randint(0, 256, size=(16, d)).astype(np.uint8)
        kf, vf = [((r.astype(np.int32) ^ 0x80) - 0x80).astype(np.float64) for r in (k_rows, v_rows)]
        # one 128-byte box column: d bytes a row (d = 64 fills half of it)
        pad = lambda r: np.concatenate([r, np.zeros((16, 128 - d), np.uint8)], 1)
        k_boxes, v_boxes = [_swizzle128(pad(k_rows))], [_swizzle128(pad(v_rows))]
    else:
        kt = torch.tensor(rng.randn(16, d), dtype=torch.float32).to(torch.bfloat16)
        vt = torch.tensor(rng.randn(16, d), dtype=torch.float32).to(torch.bfloat16)
        kf, vf = kt.double().numpy(), vt.double().numpy()
        kb, vb = (t.view(torch.int16).numpy().view(np.uint16) for t in (kt, vt))
        k_boxes = [_swizzle128(kb[:, 64 * i:64 * i + 64].copy().view(np.uint8))
                   for i in range(d // 64)]
        v_boxes = [_swizzle128(vb[:, 64 * i:64 * i + 64].copy().view(np.uint8))
                   for i in range(d // 64)]
    q = torch.tensor(rng.randn(8, d), dtype=torch.float32).to(torch.bfloat16)
    q[heads:] = 0  # query heads past g
    qbits = q.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    qf64 = q.double().numpy()
    lanes = np.arange(32)
    r_k, r_v = lanes % 16, (lanes % 8) + 8 * (lanes // 16)
    r_8 = (lanes % 8) + 8 * ((lanes // 8) % 2)

    def qfrag(lane, kk):  # the kernel's qf[kk][0..1] of a lane
        g, t = lane // 4, lane % 4
        c = [16 * kk + 4 * t + i for i in range(4)] if int8 else \
            [16 * kk + 2 * t, 16 * kk + 2 * t + 1, 16 * kk + 2 * t + 8, 16 * kk + 2 * t + 9]
        return [qbits[g, c[0]] | (qbits[g, c[1]] << 16), qbits[g, c[2]] | (qbits[g, c[3]] << 16)]

    # S^T = K Q^T
    s = np.zeros((16, 8))
    for kk in range(d // 16):
        if int8:
            j, h = divmod(kk, 2)
            r = _ldmatrix_x4(k_boxes[0], r_8 * 128 + (((2 * j + lanes // 16) ^ (r_8 & 7)) << 4),
                             trans=False)
        else:
            r = _ldmatrix_x4(k_boxes[kk // 4], r_k * 128 + (((2 * (kk % 4) + lanes // 16)
                                                             ^ (r_k & 7)) << 4), trans=False)
        a_mat, b_mat, cols = np.zeros((16, 16)), np.zeros((16, 8)), []
        for lane in range(32):
            g, t = lane // 4, lane % 4
            if int8:
                w0, w1 = (_byte_perm(int(r[lane, 2 * h + i]), 0, 0x3120) for i in range(2))
                regs = [_s8_halves(w0), _s8_halves(w1), _s8_halves(w0 >> 8), _s8_halves(w1 >> 8)]
            else:
                regs = [[_bf16_value(int(r[lane, i]) & 0xFFFF), _bf16_value(int(r[lane, i]) >> 16)]
                        for i in range(4)]
            for i, (row, col) in enumerate([(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                            (g + 8, 2 * t + 8)]):
                a_mat[row, col], a_mat[row, col + 1] = regs[i]
            for i, kq in enumerate((2 * t, 2 * t + 8)):
                word = qfrag(lane, kk)[i]
                b_mat[kq, g], b_mat[kq + 1, g] = _bf16_value(word & 0xFFFF), _bf16_value(word >> 16)
        s += a_mat @ b_mat
    np.testing.assert_allclose(s, kf @ qf64.T, rtol=1e-12, atol=1e-9)
    # P^T into the B fragment: the S^T fragment's two 8x8 matrices, transposed
    p = rng.rand(16, 8)
    pb = np.vectorize(lambda v: _bf16_value(_bf16_bits(v)))(p)
    m0, m1 = np.zeros(32, np.uint64), np.zeros(32, np.uint64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        m0[lane] = _bf16_bits(p[g, 2 * t]) | (_bf16_bits(p[g, 2 * t + 1]) << 16)
        m1[lane] = _bf16_bits(p[g + 8, 2 * t]) | (_bf16_bits(p[g + 8, 2 * t + 1]) << 16)
    b0, b1 = _movmatrix_trans(m0), _movmatrix_trans(m1)
    b_mat = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, kk in enumerate((2 * t, 2 * t + 8)):
            word = int((b0, b1)[i][lane])
            b_mat[kk, g], b_mat[kk + 1, g] = _bf16_value(word & 0xFFFF), _bf16_value(word >> 16)
    np.testing.assert_array_equal(b_mat, pb)
    # Out^T = V^T P^T
    out = np.zeros((d, 8))
    for i in range(d // 16):
        if int8:
            j, h = divmod(i, 2)
            r = _ldmatrix_x4(v_boxes[0], r_8 * 128 + (((2 * j + lanes // 16) ^ (r_8 & 7)) << 4),
                             trans=True)
        else:
            r = _ldmatrix_x4(v_boxes[i // 4], r_v * 128 + (((2 * (i % 4) + (lanes // 8) % 2)
                                                             ^ (r_v & 7)) << 4), trans=True)
        a_mat = np.zeros((16, 16))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            if int8:
                w0, w1 = int(r[lane, 2 * h]), int(r[lane, 2 * h + 1])
                regs = [_s8_halves(w0), _s8_halves(w0 >> 8), _s8_halves(w1), _s8_halves(w1 >> 8)]
            else:
                regs = [[_bf16_value(int(r[lane, q]) & 0xFFFF), _bf16_value(int(r[lane, q]) >> 16)]
                        for q in range(4)]
            for q, (row, col) in enumerate([(g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                            (g + 8, 2 * t + 8)]):
                a_mat[row, col], a_mat[row, col + 1] = regs[q]
        acc = a_mat @ b_mat  # [fragment row][query head]
        for row in range(16):  # the kernel's map of fragment rows to d
            dd = 16 * i + (2 * (row % 8) + row // 8 if int8 else row)
            out[dd] = acc[row]
    np.testing.assert_allclose(out, vf.T @ pb, rtol=1e-12, atol=1e-9)


# ---------------------------------------------------------------------------
# The encoder attention sublayer's products (csrc/vit_sublayer.cu on
# csrc/vit_gemm_wgmma.cuh): q/k/v as one launch of three products, o alone

SUBLAYER_SHAPES = [(64 * 257, 1024), (64 * 99, 1024), (3 * 77, 1024), (3 * 77, 384),
                   (2 * 40, 256)]


@pytest.mark.parametrize("rows,w", SUBLAYER_SHAPES)
def test_attn_sublayer_plan_covers_every_product_tile_once(rows, w):
    plan = vit_sublayer.attn_sublayer_plan(rows, w, SMS)
    assert plan["launches"] == 4
    for name, products in (("qkv", 3), ("o", 1)):
        p = plan[name]
        bm, bn = p["tile"]
        cl, nt, mt = p["cluster"], p["n_tiles"], p["m_tiles"]
        assert p["products"] == products and p["grid"][0] <= SMS and p["grid"][0] % cl == 0
        assert (nt - 1) * bn < w <= nt * bn and (mt - cl) * bm < rows <= mt * bm
        assert p["units"] == products * nt * mt // cl and p["rounds"] == p["units"] / (
            p["grid"][0] // cl)
        seen = np.zeros((products, nt, mt), np.int32)  # (product, column tile, row tile)
        for b, mine in enumerate(p["tiles"]):
            for c, r in mine:
                seen[c // nt, c % nt, r] += 1
            if cl == 2:  # the cluster's blocks: one column tile, neighbouring row tiles
                other = p["tiles"][b ^ 1]
                assert [t[0] for t in mine] == [t[0] for t in other]
                assert all(t[1] // 2 == o[1] // 2 and t[1] % 2 == b % 2
                           for t, o in zip(mine, other))
            # column tiles fastest: a block's consecutive units walk the columns of
            # the three products before the next rows
            assert all(t1[1] >= t0[1] for t0, t1 in zip(mine, mine[1:]))
        assert (seen == 1).all()
        assert (p["k_steps"] - 1) * p["stage_k"] < w <= p["k_steps"] * p["stage_k"]
        assert p["smem_bytes"] <= SMEM_LIMIT


def test_attn_sublayer_plan_at_the_towers_shapes():
    """CLIP and HuBERT: clusters of two on every SM, q/k/v's units three times
    o's; HuBERT's o launch takes 1.52 rounds of units (100 on 66 clusters), as
    a 128-column tile would (200 on 66 = 3.03 rounds of half the work)."""
    for rows, o_units in ((64 * 257, 4 * 65), (64 * 99, 4 * 25)):
        plan = vit_sublayer.attn_sublayer_plan(rows, 1024, SMS)
        for p in (plan["qkv"], plan["o"]):
            assert p["cluster"] == 2 and p["grid"] == (SMS,)
        assert plan["o"]["units"] == o_units and plan["qkv"]["units"] == 3 * o_units
    assert vit_sublayer.attn_sublayer_plan(64 * 99, 1024, SMS)["o"]["rounds"] == 100 / 66


@pytest.mark.parametrize("rows,w", [(99, 100), (99, 2080), (0, 1024)])
def test_attn_sublayer_plan_raises_on_what_the_kernels_do_not_take(rows, w):
    with pytest.raises(ValueError):  # width % 32 or > 2048, no rows
        vit_sublayer.attn_sublayer_plan(rows, w, SMS)


# ---------------------------------------------------------------------------
# The decode attention sublayer (csrc/decode_attn_o.cu): the attention launch
# over each row's window, o_proj + residual on the swap-AB kernel

def _window_row(t: int, case: str) -> torch.Tensor:
    """A [1, t] bool mask row of one decode-step shape."""
    cols = torch.arange(t)
    if case == "left_pads":  # pads before a window to the end
        return (cols >= 32)[None]
    if case == "lo_unaligned":  # a window from column 21 to 400
        return ((cols >= 21) & (cols <= 400))[None]
    if case == "ends_early":  # a window that ends before T - 1
        return ((cols >= 3) & (cols <= t - 40))[None]
    if case == "one_column":
        return (cols == t // 2)[None]
    if case == "no_valid_column":  # all of [0, T - 1]
        return torch.zeros((1, t), dtype=torch.bool)
    return torch.ones((1, t), dtype=torch.bool)


# The kernel's split of a window, which this file's `_window_shares` copies:
# the test below fails when these lines of the kernel change. The kernel's
# own split is run by the card tests (tests/test_torch_cuda_kernels.py,
# `test_decode_attn_o_kernel_matches_plain_at_qwen_width`).
_KERNEL_SHARES = (
    "const int first = lo / kTile, tiles = hi < lo ? 0 : hi / kTile - first + 1;",
    "const int t0 = first + rank * tiles / splits, t1 = first + (rank + 1) * tiles / splits;",
)


def _window_shares(lo: int, hi: int, splits: int) -> list:
    """The tiles [t0, t1) (16 columns each) that the `splits` blocks of a
    pair take of the window [lo, hi], as the kernel computes them
    (csrc/dense_decode_attention.cuh, `_KERNEL_SHARES`): the window's tiles
    lo // 16 .. hi // 16, block r taking [r W / C, (r + 1) W / C) of its W
    tiles; none when hi < lo (lo, hi >= -1: C's / and Python's // agree)."""
    first = lo // 16
    tiles = 0 if hi < lo else hi // 16 - first + 1
    return [(first + r * tiles // splits, first + (r + 1) * tiles // splits)
            for r in range(splits)]


@pytest.mark.parametrize("t", [577, 640])
@pytest.mark.parametrize("case", ["left_pads", "lo_unaligned", "ends_early", "one_column",
                                  "no_valid_column", "all_valid"])
def test_decode_attn_o_window_shares_give_every_column_to_one_share(t, case):
    kernel = (_build.CSRC_DIR / "dense_decode_attention.cuh").read_text()
    assert all(line in kernel for line in _KERNEL_SHARES)  # the copy is the kernel's split
    lo, hi = (int(v) for v in decode_attn_o.key_window(_window_row(t, case))[0])
    if case == "no_valid_column":
        assert (lo, hi) == (0, t - 1)
    plans = [decode_attention.attention_plan(b, 4, 7, 128, t, SMS, decode_attention.WINDOW)
             ["splits"] for b in (1, 8, 64)]
    assert plans == [8, 4, 1]  # small batches split over a cluster, b = 64 not at all
    for splits in range(1, 9):
        shares = _window_shares(lo, hi, splits)
        assert len(shares) == splits
        cover = np.zeros(-(-t // 16) * 16, np.int32)
        for t0, t1 in shares:
            assert 0 <= t0 <= t1 <= -(-t // 16)  # whole 16-column tiles of the cache
            cover[16 * t0:16 * t1] += 1
        assert (cover[lo:hi + 1] == 1).all()  # every window column in one share
        assert cover.sum() - (hi - lo + 1) < 32  # beyond it, the first and last tiles' rest


@pytest.mark.parametrize("b", [1, 8, 64, 512])
def test_decode_attn_o_attention_plan_fills_the_card_at_once(b):
    for t in (577, 640):
        p = decode_attention.attention_plan(b, 4, 7, 128, t, SMS, decode_attention.WINDOW)
        c = p["splits"]
        assert 1 <= c <= 8 and p["cluster"] == c and p["grid"] == (b * 4 * c,)
        assert b * 4 * c <= SMS or c == 1  # the whole grid at one block an SM
        assert p["stages"] % 4 == 0 and p["smem_bytes"] <= SMEM_LIMIT
        assert 2 * p["smem_bytes"] <= 233_472  # two blocks an SM


def test_decode_attn_o_plan_loads_each_wo_byte_once_a_call():
    h, kv, g, d = 3584, 4, 7, 128  # Qwen2.5-7B
    nq = kv * g * d
    for b in range(1, 513):
        plan = decode_attn_o.decode_attn_o_plan(b, kv, g, d, 640, h, SMS)
        o = plan["o_proj"]
        assert plan["launches"] == 2 and o["tiles"] == h // 128 and o["k"] == nq
        assert o["wgmma"] == f"m64n{o['nb']}k16" and o["cb"] * o["nb"] >= b
        spans = {}
        rows = {}
        for tile, kr, br, boxes, (r0, r1) in decode_gemm.block_loads(o, plan["segments"]):
            for m, c, k0, k1 in boxes:
                assert m == 0
                spans.setdefault(c, []).append((k0, k1))
            rows.setdefault((tile, kr), []).append((r0, r1))
        assert sorted(spans) == list(range(0, h, 64))  # every 64-column box of W_o
        for s in spans.values():  # its K rows once, in the K shares of one cluster
            s.sort()
            assert s[0][0] == 0 and s[-1][1] == nq
            assert all(x[1] == y[0] for x, y in zip(s, s[1:]))
        for r in rows.values():  # every batch row once a (tile, K share)
            r.sort()
            assert r[0][0] == 0 and r[-1][1] >= b and all(x[1] == y[0] for x, y in zip(r, r[1:]))


@pytest.mark.parametrize("kwargs", [dict(h=3520), dict(d=96), dict(g=9), dict(b=0),
                                    dict(t_len=0)])
def test_decode_attn_o_plan_raises_on_what_the_kernels_do_not_take(kwargs):
    args = dict(b=8, kv=4, g=7, d=128, t_len=640, h=3584, sms=SMS)
    with pytest.raises(ValueError):
        decode_attn_o.decode_attn_o_plan(**{**args, **kwargs})


def _parent_window_plan(b, kv, g, d, t_len, sm_count):
    """decode_attn_o's attention plan as it stood before it moved to
    ops/decode_attention.py (its WINDOW rule must give the same launch)."""
    tiles = -(-t_len // 16)
    splits = min(8, tiles, max(1, 1 * sm_count // (b * kv)))
    per_block = -(-tiles // splits)
    stages = min(8, -(-per_block // 4) * 4)
    stage = 2 * (d // 64) * 16 * 128
    merge = 5 * (8 * d + 16) * 4
    return {"splits": splits, "cluster": splits, "grid": (b * kv * splits,), "stages": stages,
            "stage_bytes": stage, "threads": 160,
            "smem_bytes": max(stages * stage, merge) + 2 * stages * 8 + 1024}


@pytest.mark.parametrize("kv,g,d", [(4, 7, 128), (2, 8, 128), (2, 3, 64)])
def test_decode_attn_o_attention_plan_is_unchanged_by_the_move(kv, g, d):
    for b in (1, 3, 8, 16, 64, 384, 512):
        for t in (1, 77, 192, 577, 640, 4096):
            got = decode_attn_o.decode_attn_o_plan(b, kv, g, d, t, 3584, SMS)["attention"]
            assert got.pop("keys") == decode_attention.WINDOW and got.pop("keys_bytes") == 0
            assert got == _parent_window_plan(b, kv, g, d, t, SMS)


def test_decode_attention_key_rules_are_the_kernel_s():
    kernel = (_build.CSRC_DIR / "dense_decode_attention.cuh").read_text()
    assert "enum class Keys : int { kWindow = 0, kMaskWindow = 1, kMaskAll = 2 };" in kernel
    assert (decode_attention.WINDOW, decode_attention.MASK_WINDOW,
            decode_attention.MASK_ALL) == (0, 1, 2)
    # the share's mask bytes, as attention_plan counts them
    assert ("return K == Keys::kWindow ? 0 : 16 * (((T + kTile - 1) / kTile + splits - 1) / "
            "splits + 1);") in kernel


@pytest.mark.parametrize("b", [1, 4, 8, 16, 32, 64, 384])
@pytest.mark.parametrize("t", [77, 577, 640])
@pytest.mark.parametrize("kv,g", [(4, 7), (2, 8)])
def test_decode_attention_plan_at_decode_shapes(b, t, kv, g):
    p = decode_attention.decode_attention_plan(b, kv, g, 128, t, SMS)
    tiles = -(-t // 16)
    want = decode_attention.MASK_ALL if b * kv <= SMS else decode_attention.MASK_WINDOW
    assert p["keys"] == want  # all tiles while the pairs fit the SMs
    c = p["splits"]
    assert 1 <= c <= min(8, tiles) and p["cluster"] == c and p["grid"] == (b * kv * c,)
    assert b * kv * c <= SMS or c == 1  # the whole grid at one block an SM
    if c > 2:  # a quarter of the SMs free, and no more splits would leave it
        assert 4 * b * kv * c <= 3 * SMS and (c == min(8, tiles) or 4 * b * kv * (c + 1) > 3 * SMS)
    best = {1: 8, 4: 6, 8: 3, 16: 2, 32: 1, 64: 1, 384: 1}  # on an H100 at T = 640, kv = 4
    per_block = -(-tiles // c)
    assert p["stages"] % 4 == 0 and p["stages"] == min(8, -(-per_block // 4) * 4)
    assert p["keys_bytes"] == 16 * (per_block + 1)
    assert p["smem_bytes"] == (max(p["stages"] * 8192, 5 * (8 * 128 + 16) * 4)
                               + 16 * p["stages"] + p["keys_bytes"] + 1024)
    assert 2 * p["smem_bytes"] <= 233_472  # two blocks an SM
    if (kv, t) == (4, 640):
        assert c == best[b]


def _mask_row(t: int, case: str, rng: np.random.RandomState) -> np.ndarray:
    cols = np.arange(t)
    if case == "window":
        return (cols >= rng.randint(0, 20)) & (cols <= rng.randint(t - 95, t - 1))
    if case == "holes":  # a window with holes, and a run of masked columns
        row = (cols >= 3) & (cols <= t - 5)
        row[::5] = False
        row[40:70] = False
        return row
    if case == "last_column":  # the only valid column in a partial last tile at T = 577
        return cols == t - 1
    if case == "server":  # BatchServer: [0, pos]
        return cols <= rng.randint(0, t)
    if case == "random":
        return rng.rand(t) < 0.3
    return np.zeros(t, bool)  # "none"


def _kernel_shares(row: np.ndarray, keys: int, splits: int) -> list:
    """The tiles a (row, kv head) pair's blocks take under MASK_ALL (lo = 0,
    hi = T - 1) or MASK_WINDOW (the first and last valid column, (T, -1)
    when none), as dense_kernel sets lo and hi before `_KERNEL_SHARES`."""
    t = len(row)
    valid = np.flatnonzero(row)
    if keys == decode_attention.MASK_ALL:
        lo, hi = 0, t - 1
    else:
        lo, hi = (int(valid[0]), int(valid[-1])) if len(valid) else (t, -1)
    return _window_shares(lo, hi, splits)


@pytest.mark.parametrize("keys", [1, 2])
@pytest.mark.parametrize("t", [77, 577, 640])
@pytest.mark.parametrize("case", ["window", "holes", "last_column", "server", "random", "none"])
def test_decode_attention_shares_give_every_column_to_one_share(keys, t, case):
    kernel = (_build.CSRC_DIR / "dense_decode_attention.cuh").read_text()
    assert all(line in kernel for line in _KERNEL_SHARES)  # the copy is the kernel's split
    row = _mask_row(t, case, np.random.RandomState(t))
    n_tiles = -(-t // 16)
    for splits in range(1, 9):
        shares = _kernel_shares(row, keys, splits)
        cover = np.zeros(16 * n_tiles, np.int32)
        for t0, t1 in shares:
            assert 0 <= t0 <= t1 <= n_tiles and t1 - t0 <= -(-n_tiles // splits)
            cover[16 * t0:16 * t1] += 1
        assert cover.max() <= 1
        if keys == decode_attention.MASK_ALL:
            assert (cover == 1).all()  # every tile of the row, padding past T included
        else:
            assert (cover[:t][row] == 1).all()  # every valid column
            if not row.any():
                assert cover.sum() == 0  # no valid column: no tile, no load
            else:  # only the window's tiles
                v = np.flatnonzero(row)
                assert cover.sum() == 16 * (v[-1] // 16 - v[0] // 16 + 1)


# The lines of dense_decode_attention.cuh that `_share_keys` and
# `_window_bits` copy: the tests below fail when these lines change.
_KERNEL_KEYS = (
    "const int end = off + min(kTile * t1, T) - kTile * t0;",
    "for (int c = threadIdx.x; 16 * c < off + kTile * (t1 - t0); c += 32 * kConsumers) {",
    "const int keep = end - 16 * c;",
    "uint4 v = keep > 0 ? __ldg(chunks + c) : make_uint4(0u, 0u, 0u, 0u);",
    "const int n = keep - 4 * j;",
    "if (n < 4) w[j] &= n <= 0 ? 0u : (1u << (8 * n)) - 1u;",
    "return buf + off;",
    "bits = __ballot_sync(0xffffffffu, keys[(tile - t0) * kTile + lane % kTile] != 0) & 0xFFFFu;",
)
_KERNEL_WINDOW_BITS = (
    "const int a = max(lo - kTile * tile, 0), e = min(hi - kTile * tile, kTile - 1);",
    "return e < a ? 0u : (0xFFFFu >> (kTile - 1 - e)) & (0xFFFFu << a);",
)


def _share_keys(mem: np.ndarray, row_start: int, t: int, t0: int, t1: int, buf_bytes: int):
    """dense_decode_attention.cuh `share_keys` on the mask's bytes `mem`
    (the [b, T] mask flattened, its allocation 16-byte aligned): the
    chunks' copy into a buffer of buf_bytes, then the pointer's offset.
    Returns (buffer, off, chunks read)."""
    addr = row_start + 16 * t0
    off = addr % 16
    base = addr - off
    end = off + min(16 * t1, t) - 16 * t0
    buf = np.full(buf_bytes, 0xAB, np.uint8)  # what shared memory held before
    read = []
    c = 0
    while 16 * c < off + 16 * (t1 - t0):
        keep = end - 16 * c
        chunk = np.zeros(16, np.uint8)
        if keep > 0:
            read.append(base // 16 + c)
            src = mem[base + 16 * c:base + 16 * c + 16]
            chunk[:len(src)] = src
        for j in range(4):  # the words' byte masks
            n = keep - 4 * j
            if n < 4:
                chunk[4 * j + max(n, 0):4 * j + 4] = 0
        assert 16 * c + 16 <= buf_bytes  # inside the plan's keys_bytes
        buf[16 * c:16 * c + 16] = chunk
        c += 1
    return buf, off, read


def _window_bits(tile: int, lo: int, hi: int) -> int:
    """dense_decode_attention.cuh `window_bits`."""
    a, e = max(lo - 16 * tile, 0), min(hi - 16 * tile, 15)
    return 0 if e < a else (0xFFFF >> (15 - e)) & (0xFFFF << a) & 0xFFFF


@pytest.mark.parametrize("t", [77, 577, 640])
@pytest.mark.parametrize("keys", [1, 2])
def test_decode_attention_share_keys_give_each_tile_its_valid_columns(t, keys):
    kernel = (_build.CSRC_DIR / "dense_decode_attention.cuh").read_text()
    assert all(line in kernel for line in _KERNEL_KEYS)  # the copy is the kernel's
    rng = np.random.RandomState(t + keys)
    cases = ["window", "holes", "last_column", "server", "random", "none"]
    b = 2 * len(cases)  # every case at two byte offsets of its row
    mask = np.stack([_mask_row(t, cases[r % len(cases)], rng) for r in range(b)])
    mem = mask.astype(np.uint8).reshape(-1)
    n_chunks = -(-len(mem) // 16)  # the aligned chunks the allocation holds
    for splits in range(1, 9):
        buf_bytes = 16 * (-(-(-(-t // 16)) // splits) + 1)  # the kernel's keys_bytes
        for r in range(b):
            for t0, t1 in _kernel_shares(mask[r], keys, splits):
                buf, off, read = _share_keys(mem, r * t, t, t0, t1, buf_bytes)
                assert all(0 <= c < n_chunks for c in read)  # no chunk outside the mask
                for tile in range(t0, t1):
                    keys_ = buf[off + 16 * (tile - t0):off + 16 * (tile - t0) + 16]
                    bits = sum(1 << i for i in range(16) if keys_[i])  # the warp's ballot
                    cols = 16 * tile + np.arange(16)
                    want = [c < t and mask[r, c] for c in cols]
                    assert bits == sum(1 << i for i in range(16) if want[i])


def test_decode_attention_window_bits_are_the_window_s_columns():
    kernel = (_build.CSRC_DIR / "dense_decode_attention.cuh").read_text()
    assert all(line in kernel for line in _KERNEL_WINDOW_BITS)  # the copy is the kernel's
    for lo in range(0, 40):
        for hi in range(lo, 60):
            for tile in range(4):
                want = sum(1 << i for i in range(16) if lo <= 16 * tile + i <= hi)
                assert _window_bits(tile, lo, hi) == want
