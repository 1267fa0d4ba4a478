"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On a machine with a
card (and no jax), run them with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
Tolerance rtol 1.6e-2, atol 1e-2: both sides round to bf16 at the same
points, so they differ by f32 summation order plus one final rounding (the
prefill kernel also rounds p to bf16 for its PV product, as the TPU flash op
does; the quantized matmuls round their f32 sums to bf16 once; the int8
decode MLP rounds xn and silu·up to bf16 on both sides; the encoder kernels
round h, q/k/v, p, the heads, t and the output to bf16 on both sides, and
the fused MLP its bf16 out tile after every chunk; the flash design of
fused_vit_attention rounds p before it normalises it, the plain version
after, an error of the same size, as SDPA's)."""

import pytest
import torch

from affectgpt_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference
from affectgpt_tpu_torch.ops import decode_attention as decode_attention_module
from affectgpt_tpu_torch.ops.decode_attn_o import decode_attn_o, decode_attn_o_reference
from affectgpt_tpu_torch.ops.decode_mlp import decode_mlp, decode_mlp_reference
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16, decode_mlp_bf16_reference
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv, decode_qkv_reference
from affectgpt_tpu_torch.models import nn
from affectgpt_tpu_torch.ops import quant
from affectgpt_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
)
from affectgpt_tpu_torch.ops.prefill_attention import (
    prefill_attention,
    prefill_attention_reference,
)
from affectgpt_tpu_torch.ops import vit_attention, vit_mlp, vit_mlp_fused, vit_sublayer

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1.6e-2, atol=1e-2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(gen, *shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(torch.bfloat16)


@pytest.mark.parametrize("b", [1, 3, 8, 13])
@pytest.mark.parametrize("heads,kv,hd,h", [(4, 2, 128, 256), (6, 2, 128, 384)])
@pytest.mark.parametrize("with_ln", [False, True])
def test_decode_qkv_kernel_matches_plain(gen, b, heads, kv, hd, h, with_ln):
    nq, nkv = heads * hd, kv * hd
    args = (_rnd(gen, b, h), torch.randint(0, 5000, (b,), generator=gen, device="cuda"),
            _rnd(gen, h, nq, scale=0.05), _rnd(gen, nq, scale=0.1),
            _rnd(gen, h, nkv, scale=0.05), _rnd(gen, nkv, scale=0.1),
            _rnd(gen, h, nkv, scale=0.05), _rnd(gen, nkv, scale=0.1))
    kw = dict(num_heads=heads, num_kv_heads=kv, head_dim=hd, theta=1e6,
              ln_scale=_rnd(gen, h, scale=0.1, shift=1.0) if with_ln else None)
    before = decode_qkv.launches
    got = decode_qkv(*args, **kw)
    torch.cuda.synchronize()
    assert decode_qkv.launches == before + 1
    for g, r in zip(got, decode_qkv_reference(*args, **kw)):
        torch.testing.assert_close(g.float(), r.float(), **TOL)


@pytest.mark.parametrize("b", [1, 5, 8, 20])
@pytest.mark.parametrize("h,inter", [(256, 512), (384, 4160 * 2)])
def test_decode_mlp_kernel_matches_plain(gen, b, h, inter):
    args = (_rnd(gen, b, h), _rnd(gen, h, scale=0.1, shift=1.0), _rnd(gen, h, inter, scale=0.05),
            _rnd(gen, h, inter, scale=0.05), _rnd(gen, inter, h, scale=0.05))
    before = decode_mlp_bf16.launches
    got = decode_mlp_bf16(*args)
    torch.cuda.synchronize()
    assert decode_mlp_bf16.launches == before + 1
    torch.testing.assert_close(got.float(), decode_mlp_bf16_reference(*args).float(), **TOL)


def test_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x = torch.randn(8, 256, device="cuda")  # float32: the kernels take bf16 only
    with pytest.raises(TypeError):
        decode_mlp_bf16(x, x[0], x.new_zeros(256, 512), x.new_zeros(256, 512),
                        x.new_zeros(512, 256))
    xb = _rnd(gen, 8, 200)  # hidden not a multiple of 32
    with pytest.raises(ValueError):
        decode_mlp_bf16(xb, xb[0].clone(), _rnd(gen, 200, 512), _rnd(gen, 200, 512),
                        _rnd(gen, 512, 200))


# (hidden, intermediate, heads, kv heads): small, and Qwen2.5-3B (bench.py's default)
DECODE_WIDTHS = {"small": (256, 1024, 4, 2), "3b": (2048, 11008, 16, 2)}
DECODE_BATCHES = [1, 8, 13, 16, 24, 64, 100, 384, 392]


@pytest.mark.parametrize("b", DECODE_BATCHES)
@pytest.mark.parametrize("widths", list(DECODE_WIDTHS))
@pytest.mark.parametrize("with_ln", [False, True])
def test_decode_qkv_kernel_matches_plain_at_every_batch_width(gen, b, widths, with_ln):
    h, _, heads, kv = DECODE_WIDTHS[widths]
    nq, nkv = heads * 128, kv * 128
    args = (_rnd(gen, b, h), torch.randint(0, 32768, (b,), generator=gen, device="cuda"),
            _rnd(gen, h, nq, scale=0.02), _rnd(gen, nq, scale=0.1),
            _rnd(gen, h, nkv, scale=0.02), _rnd(gen, nkv, scale=0.1),
            _rnd(gen, h, nkv, scale=0.02), _rnd(gen, nkv, scale=0.1))
    kw = dict(num_heads=heads, num_kv_heads=kv, head_dim=128, theta=1e6,
              ln_scale=_rnd(gen, h, scale=0.1, shift=1.0) if with_ln else None)
    before = decode_qkv.launches
    got = decode_qkv(*args, **kw)
    again = decode_qkv(*args, **kw)
    torch.cuda.synchronize()
    assert decode_qkv.launches == before + 2  # one count a call
    assert all(torch.equal(g, a) for g, a in zip(got, again))  # the same bits
    for g, r in zip(got, decode_qkv_reference(*args, **kw)):
        torch.testing.assert_close(g.float(), r.float(), **TOL)


@pytest.mark.parametrize("b", DECODE_BATCHES)
@pytest.mark.parametrize("widths", list(DECODE_WIDTHS))
def test_decode_mlp_kernel_matches_plain_at_every_batch_width(gen, b, widths):
    h, inter, _, _ = DECODE_WIDTHS[widths]
    args = (_rnd(gen, b, h), _rnd(gen, h, scale=0.1, shift=1.0), _rnd(gen, h, inter, scale=0.02),
            _rnd(gen, h, inter, scale=0.02), _rnd(gen, inter, h, scale=0.02))
    before = decode_mlp_bf16.launches
    got = decode_mlp_bf16(*args)
    again = decode_mlp_bf16(*args)
    torch.cuda.synchronize()
    assert decode_mlp_bf16.launches == before + 2  # one count a call
    assert torch.equal(got, again)  # the same bits
    torch.testing.assert_close(got.float(), decode_mlp_bf16_reference(*args).float(), **TOL)


def test_decode_wrappers_raise_on_what_the_swapab_kernel_does_not_take(gen):
    x = _rnd(gen, 8, 256)
    pos = torch.zeros(8, dtype=torch.int32, device="cuda")
    w, bias = _rnd(gen, 256, 256), _rnd(gen, 256)
    with pytest.raises(ValueError, match="head_dim % 128"):  # a RoPE pair needs d / 2 >= 64
        decode_qkv(x, pos, w, bias, w[:, :128].contiguous(), bias[:128].contiguous(),
                   w[:, :128].contiguous(), bias[:128].contiguous(), num_heads=4,
                   num_kv_heads=2, head_dim=64, theta=1e6)
    big = _rnd(gen, 513, 256)  # past a pair of 256-row blocks
    with pytest.raises(ValueError, match="rows"):
        decode_mlp_bf16(big, big[0].clone(), _rnd(gen, 256, 512), _rnd(gen, 256, 512),
                        _rnd(gen, 512, 256))
    with pytest.raises(ValueError, match="intermediate % 64"):
        decode_mlp_bf16(x, x[0].clone(), _rnd(gen, 256, 544), _rnd(gen, 256, 544),
                        _rnd(gen, 544, 256))


def _window_mask(gen, b, t):
    """Per-row windows of valid columns that start past 0 (left pads) and
    end before T (columns not yet written)."""
    lo = torch.randint(1, max(2, t // 4), (b,), generator=gen, device="cuda")
    hi = torch.randint(t // 2, t - 1, (b,), generator=gen, device="cuda")
    cols = torch.arange(t, device="cuda")
    return (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("kv,g,d", [(2, 3, 64), (4, 7, 128)])
@pytest.mark.parametrize("t", [77, 200])  # not multiples of the 16-column tile
def test_decode_attention_kernel_matches_plain(gen, b, kv, g, d, t):
    q, k, v = _rnd(gen, b, kv, g, d), _rnd(gen, b, kv, t, d), _rnd(gen, b, kv, t, d)
    mask = _window_mask(gen, b, t)
    mask[0, ::5] = False  # any mask, not only a window
    if b > 1:
        mask[1] = False  # no valid column: zeros
    before = decode_attention.launches
    got = decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), decode_attention_reference(q, k, v, mask).float(),
                               **TOL)


def _any_mask(gen, b, t, case):
    """Decode masks of decode_attention's kinds: `windows` (0-19 left pads,
    valid through a write index in [T - 95, T - 2], as chip_smoke.py's),
    `holes` (windows with every fifth column of row 0 and a 40-column run of
    row 1 masked), `server` (BatchServer's: [0, pos] per slot, slots 1 and 3
    inactive), `last_tile` (row 0's only valid column the last, in T = 577's
    partial last tile), `none` (no valid column anywhere). With b > 1 the
    last row has no valid column in every case."""
    cols = torch.arange(t, device="cuda")
    if case == "server":
        pos = torch.randint(0, t, (b,), generator=gen, device="cuda")
        mask = cols[None, :] <= pos[:, None]
        mask[[r for r in (1, 3) if r < b]] = False
    else:
        lo = torch.randint(0, 20, (b,), generator=gen, device="cuda")
        hi = torch.randint(t - 95, t - 1, (b,), generator=gen, device="cuda")
        mask = (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])
    if case == "holes":
        mask[0, ::5] = False
        if b > 1:
            mask[1, 100:140] = False
    if case == "last_tile":
        mask[0] = cols == t - 1
    if case == "none":
        mask[:] = False
    if b > 1:
        mask[-1] = False
    return mask


@pytest.mark.parametrize("keys", ["mask_all", "mask_window"])
@pytest.mark.parametrize("case", ["windows", "holes", "server", "last_tile", "none"])
@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("t", [577, 640])
def test_decode_attention_kernel_matches_plain_at_qwen_width(gen, monkeypatch, b, t, case, keys):
    """Both of decode_attention's key modes (the plan picks one by b: here
    each is forced through the wrapper's plan) against the plain version at
    Qwen2.5-7B width; rows with no valid column exactly zero, two calls the
    same bits."""
    da = decode_attention_module
    rule = da.MASK_ALL if keys == "mask_all" else da.MASK_WINDOW
    monkeypatch.setattr(da, "_plan_on", lambda b_, kv_, g_, d_, t_, dev: da.attention_plan(
        b_, kv_, g_, d_, t_, da._build.sm_count(dev), rule))
    kv, g, d = 4, 7, 128
    q, k, v = _rnd(gen, b, kv, g, d), _rnd(gen, b, kv, t, d), _rnd(gen, b, kv, t, d)
    mask = _any_mask(gen, b, t, case)
    before = decode_attention.launches
    got = decode_attention(q, k, v, mask)
    again = decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(got, again)  # one order of sums, no atomics: the same bits
    empty = ~mask.any(dim=1)
    assert not got[empty].any()  # no valid column: exactly zero
    torch.testing.assert_close(got.float(), decode_attention_reference(q, k, v, mask).float(),
                               **TOL)


def test_decode_attention_kernel_launches_at_bench_geometry(gen):
    """bench.py's 3B geometry, b = 384 rows of 2 kv heads of 8 query heads
    over T = 192 (768 pairs), BatchServer-shaped masks."""
    b, kv, g, d, t = 384, 2, 8, 128, 192
    q, k, v = _rnd(gen, b, kv, g, d), _rnd(gen, b, kv, t, d), _rnd(gen, b, kv, t, d)
    mask = _any_mask(gen, b, t, "server")
    got = decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert not got[~mask.any(dim=1)].any()
    torch.testing.assert_close(got.float(), decode_attention_reference(q, k, v, mask).float(),
                               **TOL)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("kv,g,d,h", [(2, 3, 64, 256), (4, 7, 128, 512)])
@pytest.mark.parametrize("t", [77, 200])
def test_decode_attn_o_kernel_matches_plain(gen, b, kv, g, d, h, t):
    args = (_rnd(gen, b, h), _rnd(gen, b, kv, g, d), _rnd(gen, b, kv, t, d),
            _rnd(gen, b, kv, t, d), _window_mask(gen, b, t), _rnd(gen, kv * g * d, h, scale=0.05))
    before = decode_attn_o.launches
    got = decode_attn_o(*args)
    torch.cuda.synchronize()
    assert decode_attn_o.launches == before + 1
    torch.testing.assert_close(got.float(), decode_attn_o_reference(*args).float(), **TOL)


def _decode_window_edges(gen, b, t):
    """`_window_mask`'s windows with the edges of the kernel's window split:
    row 0 has no valid column (all of [0, T - 1]), row 1 runs from a column
    that is no multiple of 16 to T - 1, row 2 is one column."""
    mask = _window_mask(gen, b, t)
    cols = torch.arange(t, device="cuda")
    mask[0] = False
    if b > 1:
        mask[1] = cols >= 21
    if b > 2:
        mask[2] = cols == t // 3
    return mask


@pytest.mark.parametrize("b", [1, 3, 8, 64])
@pytest.mark.parametrize("t", [577, 640])
def test_decode_attn_o_kernel_matches_plain_at_qwen_width(gen, b, t):
    kv, g, d, h = 4, 7, 128, 3584  # Qwen2.5-7B
    args = (_rnd(gen, b, h), _rnd(gen, b, kv, g, d), _rnd(gen, b, kv, t, d),
            _rnd(gen, b, kv, t, d), _decode_window_edges(gen, b, t),
            _rnd(gen, kv * g * d, h, scale=0.02))
    before = decode_attn_o.launches
    got = decode_attn_o(*args)
    again = decode_attn_o(*args)
    torch.cuda.synchronize()
    assert decode_attn_o.launches == before + 2
    assert torch.equal(got, again)  # one order of sums, no atomics: the same bits
    torch.testing.assert_close(got.float(), decode_attn_o_reference(*args).float(), **TOL)


def test_decode_attn_o_raises_on_what_the_kernels_do_not_take(gen):
    kv, g, d, t = 2, 3, 64, 40
    mask = torch.ones(2, t, dtype=torch.bool, device="cuda")
    q, k = _rnd(gen, 2, kv, g, d), _rnd(gen, 2, kv, t, d)
    with pytest.raises(ValueError):  # hidden 192: no whole 128-column o_proj tiles
        decode_attn_o(_rnd(gen, 2, 192), q, k, k, mask, _rnd(gen, kv * g * d, 192))
    b = 513  # past the swap-AB kernel's rows
    with pytest.raises(ValueError):
        decode_attn_o(_rnd(gen, b, 256), _rnd(gen, b, kv, g, d), _rnd(gen, b, kv, t, d),
                      _rnd(gen, b, kv, t, d), torch.ones(b, t, dtype=torch.bool, device="cuda"),
                      _rnd(gen, kv * g * d, 256))


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("heads,kv,d", [(4, 2, 64), (14, 2, 128)])
@pytest.mark.parametrize("t", [37, 130])
@pytest.mark.parametrize("pads", [False, True])
def test_prefill_attention_kernel_matches_plain(gen, b, heads, kv, d, t, pads):
    q, k, v = _rnd(gen, b, t, heads, d), _rnd(gen, b, kv, t, d), _rnd(gen, b, kv, t, d)
    pad = torch.randint(0, t // 2, (b,), generator=gen, device="cuda") if pads \
        else torch.zeros(b, dtype=torch.long, device="cuda")
    seg = torch.arange(t, device="cuda")[None, :] >= pad[:, None]  # pads 0, tokens 1
    before = prefill_attention.launches
    got = prefill_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    torch.testing.assert_close(got.float(), prefill_attention_reference(q, k, v, seg).float(),
                               **TOL)


def _segments(gen, kind, b, t):
    """[b, t] int segment ids: `leftpack` (pads 0, tokens 1, prompts of at
    least t - 19 tokens, as the main path packs them), `runs` (runs of ids 0-3
    in a shuffled order, so an id comes back after others: keys of its
    earlier run stay visible), `random3` (each token's id drawn from 0-2)."""
    if kind == "leftpack":
        pad = torch.randint(0, min(20, t), (b,), generator=gen, device="cuda")
        return (torch.arange(t, device="cuda")[None, :] >= pad[:, None]).to(torch.int32)
    if kind == "random3":
        return torch.randint(0, 3, (b, t), generator=gen, device="cuda", dtype=torch.int32)
    ends = torch.sort(torch.randint(1, t, (b, 5), generator=gen, device="cuda"), dim=1).values
    run = (torch.arange(t, device="cuda")[None, :, None] >= ends[:, None, :]).sum(-1)
    ids = torch.stack([torch.randperm(4, generator=gen, device="cuda")[[0, 1, 2, 0, 3, 1]]
                       for _ in range(b)])
    return torch.gather(ids, 1, run).to(torch.int32)


# (b, t, heads, kv, d, segments): Qwen2.5-7B's 28 / 4 heads (7 a group, the
# last pair of a group one head) at t < 64 and t = 564 with three or more
# segments, ids that come back after other ids, and b = 64 at the main
# path's left pack; a single head; head_dim 64.
PREFILL_SEGMENT_CASES = [
    (3, 37, 28, 4, 128, "runs"), (3, 37, 28, 4, 128, "random3"),
    (2, 564, 28, 4, 128, "runs"), (2, 564, 28, 4, 128, "random3"),
    (64, 564, 28, 4, 128, "leftpack"), (4, 200, 6, 1, 64, "runs"), (2, 130, 1, 1, 64, "runs"),
    (2, 1, 4, 2, 128, "leftpack"),
]


@pytest.mark.parametrize("b,t,heads,kv,d,kind", PREFILL_SEGMENT_CASES)
def test_prefill_attention_kernel_matches_plain_on_segments(gen, b, t, heads, kv, d, kind):
    q, k, v = _rnd(gen, b, t, heads, d), _rnd(gen, b, kv, t, d), _rnd(gen, b, kv, t, d)
    seg = _segments(gen, kind, b, t)
    before = prefill_attention.launches
    got = prefill_attention(q, k, v, seg)
    torch.cuda.synchronize()
    assert prefill_attention.launches == before + 1
    torch.testing.assert_close(got.float(), prefill_attention_reference(q, k, v, seg).float(),
                               **TOL)
    assert torch.equal(got, prefill_attention(q, k, v, seg))  # one order of sums: same bits


def test_attention_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    q, k = _rnd(gen, 2, 2, 3, 96), _rnd(gen, 2, 2, 40, 96)  # head_dim 96
    mask = torch.ones(2, 40, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError):
        decode_attention(q, k, k, mask)
    with pytest.raises(TypeError):
        decode_attention(q[..., :64].float().contiguous(), k[..., :64].float().contiguous(),
                         k[..., :64].float().contiguous(), mask)
    with pytest.raises(ValueError):  # nine query heads per kv head
        q9 = _rnd(gen, 2, 2, 9, 64)
        decode_attn_o(_rnd(gen, 2, 256), q9, _rnd(gen, 2, 2, 40, 64), _rnd(gen, 2, 2, 40, 64),
                      mask, _rnd(gen, 2 * 9 * 64, 256))
    with pytest.raises(ValueError):  # k not contiguous
        kt = _rnd(gen, 2, 40, 2, 64).transpose(1, 2)
        prefill_attention(_rnd(gen, 2, 40, 4, 64), kt, kt, mask)


QUANT_KERNELS = {  # wrapper: (its plain version, weight bits)
    "int8_matmul": (quant.int8_matmul_reference, 8),
    "int8_matmul_w8a8": (quant.int8_matmul_w8a8_reference, 8),
    "int4_matmul": (quant.int4_matmul_reference, 4),
    "int4_matmul_smallm": (quant.int4_matmul_smallm_reference, 4),
}
# (K, N): one K unit with the whole product in one split (64 and 256), two
# w8a8 activation blocks and K split over blocks (1024), a last column tile
# that is only partly inside N (272)
QUANT_CASES = [(name, k, n) for name, (_, bits) in QUANT_KERNELS.items()
               for k, n in [(64, 256), (256, 128), (1024, 512), (512, 272)]
               if bits == 8 or k % 256 == 0]


def _quantized(gen, k, n, bits):
    w = torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5
    return quant.quantize_int4_grouped(w) if bits == 4 else quant.quantize_per_channel(w)


@pytest.mark.parametrize("m", [1, 8, 13, 16, 40, 200])
@pytest.mark.parametrize("name,k,n", QUANT_CASES)
def test_quant_kernels_match_plain(gen, name, k, n, m):
    plain, bits = QUANT_KERNELS[name]
    kernel = getattr(quant, name)
    w, scales = _quantized(gen, k, n, bits)
    x = _rnd(gen, m, k)
    before = kernel.launches
    got = kernel(x, w, scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.shape == (m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), plain(x, w, scales).float(), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_route_matches_plain_at_prefill_m(gen, bits):
    """The route above PALLAS_DEQUANT_MAX_M (cuBLAS on a transient bf16
    weight) computes the small-M functions: int8 with one rounding after
    the scales, int4 that of `int4_matmul_smallm`."""
    w, scales = _quantized(gen, 512, 272, bits)
    x = _rnd(gen, quant.PALLAS_DEQUANT_MAX_M + 76, 512)
    route = quant.int4_matmul_xla if bits == 4 else quant.int8_matmul_xla
    plain = quant.int4_matmul_smallm_reference if bits == 4 else quant.int8_matmul_reference
    got = route(x, w, scales)
    assert got.dtype == torch.bfloat16 and got.shape == (x.shape[0], 272)
    torch.testing.assert_close(got.float(), plain(x, w, scales).float(), **TOL)


INT4_KERNELS = {"int4_matmul": quant.int4_matmul_reference,
                "int4_matmul_smallm": quant.int4_matmul_smallm_reference}


@pytest.mark.parametrize("m", [1, 3, 8, 13, 15, 16])
@pytest.mark.parametrize("k,n", [(3584, 512), (18944, 3584)])
@pytest.mark.parametrize("name", sorted(INT4_KERNELS))
def test_int4_swapab_kernel_matches_plain_at_decode_m(gen, name, k, n, m):
    """The swap-AB kernel (both functions) at every decode M, on k/v_proj's
    and down_proj's shapes of Qwen2.5-7B: one launch, the plain version's
    result within tolerance, and the same bits from a second call."""
    kernel, plain = getattr(quant, name), INT4_KERNELS[name]
    w, scales = _quantized(gen, k, n, 4)
    x = _rnd(gen, m, k)
    before = kernel.launches
    got = kernel(x, w, scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.shape == (m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), plain(x, w, scales).float(), **TOL)
    assert torch.equal(got, kernel(x, w, scales))


@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("k,n", [(3584, 512), (18944, 3584), (3584, 4608)])
def test_int8_swapab_kernel_matches_plain_at_decode_m(gen, k, n, m):
    """The int8 mode of the swap-AB kernel at every decode M, on k/v_proj's,
    down_proj's and the fused qkv_proj's shapes of Qwen2.5-7B: one launch,
    the plain version's result within tolerance, and the same bits from a
    second call."""
    w, scales = _quantized(gen, k, n, 8)
    x = _rnd(gen, m, k)
    before = quant.int8_matmul.launches
    got = quant.int8_matmul(x, w, scales)
    torch.cuda.synchronize()
    assert quant.int8_matmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), quant.int8_matmul_reference(x, w, scales).float(),
                               **TOL)
    assert torch.equal(got, quant.int8_matmul(x, w, scales))


def test_int8_swapab_kernel_raises_on_what_it_does_not_take(gen):
    w, scales = _quantized(gen, 512, 256, 8)
    x = _rnd(gen, 8, 512)
    with pytest.raises(ValueError):  # K not a multiple of 64
        quant.int8_matmul(_rnd(gen, 8, 480), w[:480].contiguous(), scales)
    with pytest.raises(ValueError):  # N not a multiple of 16
        quant.int8_matmul(x, w[:, :120].contiguous(), scales[:, :120].contiguous())
    with pytest.raises(ValueError):  # a weight that is not contiguous
        quant.int8_matmul(x, w.t().contiguous().t(), scales)
    with pytest.raises(TypeError):  # bf16 scales
        quant.int8_matmul(x, w, scales.to(torch.bfloat16))


@pytest.mark.parametrize("name", sorted(INT4_KERNELS))
def test_int4_swapab_kernel_raises_on_what_it_does_not_take(gen, name):
    kernel = getattr(quant, name)
    w, scales = _quantized(gen, 512, 256, 4)
    x = _rnd(gen, 8, 512)
    with pytest.raises(ValueError):  # K not a multiple of 256
        kernel(_rnd(gen, 8, 384), w[:192].contiguous(), scales[:3].contiguous())
    with pytest.raises(ValueError):  # N not a multiple of 16
        kernel(x, w[:, :120].contiguous(), scales[:, :120].contiguous())
    with pytest.raises(ValueError):  # scales of another K
        kernel(x, w, scales[:2].contiguous())
    with pytest.raises(ValueError):  # a weight that is not contiguous
        kernel(x, w.t().contiguous().t(), scales)
    with pytest.raises(TypeError):  # float32 activations
        kernel(x.float(), w, scales)
    with pytest.raises(TypeError):  # bf16 scales
        kernel(x, w, scales.to(torch.bfloat16))


def test_quant_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    w8, s8 = _quantized(gen, 256, 128, 8)
    w4, s4 = _quantized(gen, 256, 128, 4)
    x = _rnd(gen, 8, 256)
    with pytest.raises(TypeError):  # float32 activations
        quant.int8_matmul(x.float(), w8, s8)
    with pytest.raises(TypeError):  # a bf16 weight where int8 is stored
        quant.int4_matmul(x, w4.to(torch.bfloat16), s4)
    with pytest.raises(ValueError):  # N not a multiple of 16
        quant.int8_matmul_w8a8(x, w8[:, :120].contiguous(), s8[:, :120].contiguous())
    with pytest.raises(ValueError):  # x does not match the packed weight
        quant.int4_matmul_smallm(_rnd(gen, 8, 512), w4, s4)


def _int8_mlp(gen, b, h, inter):
    """x, ln and the three int8 leaves (values and scales) of one layer."""
    leaves = []
    for k, n in ((h, inter), (h, inter), (inter, h)):
        leaves += quant.quantize_per_channel(
            torch.randn(k, n, generator=gen, device="cuda") * k ** -0.5)
    return (_rnd(gen, b, h), _rnd(gen, h, scale=0.1, shift=1.0), *leaves)


@pytest.mark.parametrize("b", [1, 5, 8, 16, 20])
@pytest.mark.parametrize("h,inter", [(256, 512), (384, 4160 * 2)])
def test_decode_mlp_int8_kernel_matches_plain(gen, b, h, inter):
    args = _int8_mlp(gen, b, h, inter)
    before = decode_mlp.launches
    got = decode_mlp(*args)
    torch.cuda.synchronize()
    assert decode_mlp.launches == before + 1
    torch.testing.assert_close(got.float(), decode_mlp_reference(*args).float(), **TOL)


@pytest.mark.parametrize("b", [1, 3, 8, 16, 40, 64])
@pytest.mark.parametrize("h,inter", [(3584, 18944), (2048, 11008)])  # Qwen2.5 7B, 3B
def test_decode_mlp_int8_kernel_matches_plain_at_qwen_widths(gen, b, h, inter):
    """The tensor-core design at the serving widths, every batch size its
    row tiles meet; split sums are added in a fixed order, so a second call
    gives the same bits."""
    args = _int8_mlp(gen, b, h, inter)
    before = decode_mlp.launches
    got = decode_mlp(*args)
    again = decode_mlp(*args)
    torch.cuda.synchronize()
    assert decode_mlp.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), decode_mlp_reference(*args).float(), **TOL)


def test_decode_mlp_int8_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    x, ln, wg, sg, wu, su, wd, sd = _int8_mlp(gen, 8, 256, 512)
    with pytest.raises(TypeError):  # bf16 weights where int8 is stored
        decode_mlp(x, ln, wg.to(torch.bfloat16), sg, wu, su, wd, sd)
    with pytest.raises(TypeError):  # float32 activations
        decode_mlp(x.float(), ln, wg, sg, wu, su, wd, sd)
    with pytest.raises(ValueError):  # intermediate not a multiple of 64
        decode_mlp(x, ln, wg[:, :480].contiguous(), sg[:, :480].contiguous(),
                   wu[:, :480].contiguous(), su[:, :480].contiguous(), wd[:480], sd)
    with pytest.raises(ValueError):  # a transposed, non-contiguous weight
        decode_mlp(x, ln, wg, sg, wu, su, wd.t().contiguous().t(), sd)
    # hidden % 128 (the tensor-core design's 128-column strips of h; the
    # design before it took hidden % 32)
    x, ln, wg, sg, wu, su, wd, sd = _int8_mlp(gen, 8, 320, 512)
    with pytest.raises(ValueError):
        decode_mlp(x, ln, wg, sg, wu, su, wd, sd)


def _paged_case(gen, b, kv, g, d, blk, width, int8, num_blocks=64):
    """Pools of random pages, tables of distinct shuffled blocks (0, the
    null page, pads them), ragged seq_lens with a 1-token row, a row of
    exactly one page and a row filling the whole table."""
    shape = (num_blocks, blk, kv, d)
    if int8:
        pool_k = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        pool_v = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        scales = tuple(torch.rand(shape[:3], generator=gen, device="cuda") * 0.02
                       for _ in range(2))
    else:
        pool_k, pool_v = _rnd(gen, *shape), _rnd(gen, *shape)
        scales = ()
    lens = torch.randint(1, width * blk + 1, (b,), generator=gen, device="cuda")
    lens[0] = 1
    if b > 1:
        lens[1] = blk
    if b > 2:
        lens[2] = width * blk
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((b, width), dtype=torch.int32, device="cuda")
    used = 0
    for r in range(b):
        n = -(-int(lens[r]) // blk)
        tables[r, :n] = perm[used:used + n].to(torch.int32)
        used += n
    return (_rnd(gen, b, kv * g, d), pool_k, pool_v, tables, lens.to(torch.int32)), scales


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b", [1, 3, 7])
@pytest.mark.parametrize("kv,g,d", [(2, 3, 64), (4, 7, 128)])
@pytest.mark.parametrize("blk,width", [(16, 5), (8, 8), (12, 6), (4, 12), (24, 4), (1, 40),
                                       (20, 5)])
def test_paged_attention_kernel_matches_plain(gen, int8, b, kv, g, d, blk, width):
    args, scales = _paged_case(gen, b, kv, g, d, blk, width, int8,
                               num_blocks=b * width + 2)
    kernel = paged_attention_int8 if int8 else paged_attention
    before = kernel.launches
    got = kernel(*args, *scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.shape == args[0].shape
    torch.testing.assert_close(got.float(), paged_attention_reference(*args, *scales).float(),
                               **TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kv,g,d", [(2, 3, 64), (4, 7, 128)])
@pytest.mark.parametrize("blk,width", [(16, 38), (8, 9), (12, 10), (24, 6), (1, 64)])
def test_paged_attention_kernel_repeats_on_empty_and_mid_page_rows(gen, int8, kv, g, d, blk,
                                                                     width):
    """Rows of 0 and 1 tokens, rows that end inside a page, one that fills
    the table: within tolerance of the plain version, the empty row exactly
    0, one launch a call and the same bits from a second call."""
    args, scales = _paged_case(gen, 6, kv, g, d, blk, width, int8, num_blocks=6 * width + 2)
    q, pool_k, pool_v, tables, _ = args
    lens = torch.tensor([0, 1, blk + 3, width * blk, 2 * blk - 1, width * blk - 5],
                        dtype=torch.int32, device="cuda")
    kernel = paged_attention_int8 if int8 else paged_attention
    before = kernel.launches
    got = kernel(q, pool_k, pool_v, tables, lens, *scales)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got.float(), paged_attention_reference(
        q, pool_k, pool_v, tables, lens, *scales).float(), **TOL)
    assert torch.equal(got, kernel(q, pool_k, pool_v, tables, lens, *scales))


def test_paged_attention_rows_without_tokens_are_zero(gen):
    args, _ = _paged_case(gen, 3, 2, 3, 64, 16, 4, False)
    q, pool_k, pool_v, tables, lens = args
    lens = torch.tensor([0, 5, 0], dtype=torch.int32, device="cuda")
    got = paged_attention(q, pool_k, pool_v, tables, lens)
    assert torch.equal(got[0], torch.zeros_like(got[0])) and torch.equal(got[2], got[0])
    torch.testing.assert_close(got.float(), paged_attention_reference(
        q, pool_k, pool_v, tables, lens).float(), **TOL)


def test_paged_attention_wrappers_raise_on_what_the_kernel_does_not_take(gen):
    (q, pool_k, pool_v, tables, lens), _ = _paged_case(gen, 2, 2, 3, 64, 16, 4, False)
    with pytest.raises(TypeError):  # int64 block tables
        paged_attention(q, pool_k, pool_v, tables.long(), lens)
    with pytest.raises(TypeError):  # a bf16 pool given to the int8 variant
        s = torch.ones(pool_k.shape[:3], device="cuda")
        paged_attention_int8(q, pool_k, pool_v, tables, lens, s, s)
    with pytest.raises(ValueError):  # head_dim 96
        pk = _rnd(gen, 12, 16, 2, 96)
        paged_attention(_rnd(gen, 2, 6, 96), pk, pk, tables, lens)
    with pytest.raises(ValueError):  # non-contiguous q
        paged_attention(_rnd(gen, 2, 64, 6).transpose(1, 2), pool_k, pool_v, tables, lens)
    with pytest.raises(ValueError):  # 5 query heads over 2 kv heads
        paged_attention(_rnd(gen, 2, 5, 64), pool_k, pool_v, tables, lens)
    with pytest.raises(ValueError):  # 9 query heads per kv head
        paged_attention(_rnd(gen, 2, 18, 64), pool_k, pool_v, tables, lens)


# the encoder kernels: CLIP's 257 tokens, HuBERT's 99 and a single key tile,
# each with keys masked past valid_len; RESIDENT_KEYS = 512, whole and
# masked; 320 and 321 valid keys, the last of the resident designs' one pass
# and the first of their two (row 11's attention step); a single valid key
VIT_TOKENS = [(257, 250), (99, 90), (40, 33), (512, 512), (512, 449), (330, 320), (321, 321),
              (64, 1), (257, 1)]
# the flash design, which takes every shape (one pass, K and V streamed),
# beyond the shapes above: DINOv2's 1370 tokens, past 512 valid keys,
# SigLIP's head_dim 72 and the other head dims of JAX's gate (88 and 120
# rounded up to 96 and 128), VideoMAE's 1568 tubes, an odd count of 64-row
# query slices (the last work tile's second wholly past n), a last key tile
# with a single valid key (129, 1281), a valid_len that ends mid-tile with n
# past it (700, 650), 300 valid keys of 700
VIT_FLASH = [(1370, 1370, 64), (1370, 1000, 64), (513, 513, 64), (729, 729, 72),
             (100, 77, 72), (200, 200, 32), (129, 129, 40), (330, 321, 96), (65, 65, 128),
             (700, 300, 64), (64, 1, 72), (1568, 1568, 64), (129, 129, 64), (1281, 1281, 72),
             (700, 650, 64), (300, 260, 88), (257, 250, 120), (1030, 1030, 120)]


@pytest.mark.parametrize("n,valid,d", [(n, v, 64) for n, v in VIT_TOKENS] + VIT_FLASH)
@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_vit_attention_kernel_matches_plain(gen, n, valid, d, layout):
    b, h = 3, 4
    q, k, v = (_rnd(gen, b, h, n, d) for _ in range(3))
    want = vit_attention.fused_vit_attention_reference(q, k, v, valid)
    before = vit_attention.fused_vit_attention.launches
    if layout == "bhnd":
        got = vit_attention.fused_vit_attention(q, k, v, valid)
    else:  # the [b, n, h, d] layout of the projections, read through strides
        tr = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
        got = vit_attention.fused_self_attention(tr(q), tr(k), tr(v), valid).transpose(1, 2)
    torch.cuda.synchronize()
    assert vit_attention.fused_vit_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def _vit_block(gen, w, inter):
    vec = lambda n: _rnd(gen, n, scale=0.1)  # noqa: E731
    return dict(lns=_rnd(gen, w, scale=0.1, shift=1.0), lnb=vec(w),
                wq=_rnd(gen, w, w, scale=w ** -0.5), bq=vec(w), wk=_rnd(gen, w, w, scale=w ** -0.5),
                bk=vec(w), wv=_rnd(gen, w, w, scale=w ** -0.5), bv=vec(w),
                wo=_rnd(gen, w, w, scale=w ** -0.5), bo=vec(w),
                wi=_rnd(gen, w, inter, scale=w ** -0.5), bi=vec(inter),
                wf=_rnd(gen, inter, w, scale=inter ** -0.5), bf=vec(w))


@pytest.mark.parametrize("w", [256, 384])
@pytest.mark.parametrize("n,valid", VIT_TOKENS)
def test_attn_sublayer_kernel_matches_plain(gen, w, n, valid):
    p = _vit_block(gen, w, 4 * w)
    args = (_rnd(gen, 3, n, w), *(p[k] for k in ("lns", "lnb", "wq", "bq", "wk", "bk", "wv",
                                                  "bv", "wo", "bo")))
    before = vit_sublayer.attn_sublayer.launches
    got = vit_sublayer.attn_sublayer(*args, w // 64, valid)
    torch.cuda.synchronize()
    assert vit_sublayer.attn_sublayer.launches == before + 1
    torch.testing.assert_close(got.float(), vit_sublayer.attn_sublayer_reference(
        *args, w // 64, valid).float(), **TOL)


@pytest.mark.parametrize("b,n,valid", [(5, 99, 90), (2, 257, 257), (3, 77, 77), (1, 257, 200)])
def test_attn_sublayer_kernel_at_the_towers_width(gen, b, n, valid):
    """w = 1024, 16 heads (CLIP ViT-L/14, HuBERT-large) at row counts that
    are no multiple of the GEMM's 128-row tile, keys past valid_len masked;
    two calls give the same bits."""
    w = 1024
    p = _vit_block(gen, w, 64)
    args = (_rnd(gen, b, n, w), *(p[k] for k in ("lns", "lnb", "wq", "bq", "wk", "bk", "wv",
                                                  "bv", "wo", "bo")))
    before = vit_sublayer.attn_sublayer.launches
    got = vit_sublayer.attn_sublayer(*args, 16, valid)
    again = vit_sublayer.attn_sublayer(*args, 16, valid)
    torch.cuda.synchronize()
    assert vit_sublayer.attn_sublayer.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), vit_sublayer.attn_sublayer_reference(
        *args, 16, valid).float(), **TOL)


@pytest.mark.parametrize("w", [256, 384])
@pytest.mark.parametrize("n", [257, 99, 40])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_sublayer_kernel_matches_plain(gen, w, n, act):
    p = _vit_block(gen, w, 4 * w)
    args = (_rnd(gen, 3, n, w), *(p[k] for k in ("lns", "lnb", "wi", "bi", "wf", "bf")))
    before = vit_mlp.mlp_sublayer.launches
    got = vit_mlp.mlp_sublayer(*args, act=act)
    torch.cuda.synchronize()
    assert vit_mlp.mlp_sublayer.launches == before + 1
    torch.testing.assert_close(got.float(), vit_mlp.mlp_sublayer_reference(
        *args, act=act).float(), **TOL)
    if n == 99:  # two groups of two images: rows are independent, no bit changes
        x4 = _rnd(gen, 4, n, w)
        chunked = vit_mlp.mlp_sublayer(x4, *args[1:], act=act, image_chunk=2)
        assert vit_mlp.mlp_sublayer.launches == before + 2
        assert torch.equal(chunked, vit_mlp.mlp_sublayer(x4, *args[1:], act=act))


@pytest.mark.parametrize("w", [256, 384])
@pytest.mark.parametrize("n", [257, 99, 40])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("acc", ["bf16", "f32"])
@pytest.mark.parametrize("k_chunks", [8, 6])  # 6 rounds down to 3 (w = 384) or 1 (w = 256)
def test_mlp_sublayer_fused_kernel_matches_plain(gen, w, n, act, acc, k_chunks):
    p = _vit_block(gen, w, 4 * w)
    args = (_rnd(gen, 3, n, w), *(p[k] for k in ("lns", "lnb", "wi", "bi", "wf", "bf")))
    kw = dict(act=act, acc=acc, k_chunks=k_chunks)
    before = vit_mlp_fused.mlp_sublayer_fused.launches
    got = vit_mlp_fused.mlp_sublayer_fused(*args, **kw)
    torch.cuda.synchronize()
    assert vit_mlp_fused.mlp_sublayer_fused.launches == before + 1
    torch.testing.assert_close(got.float(), vit_mlp_fused.mlp_sublayer_fused_reference(
        *args, **kw).float(), **TOL)


def test_vit_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    p = _vit_block(gen, 256, 1024)
    x = _rnd(gen, 2, 99, 256)
    sub = [p[k] for k in ("lns", "lnb", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")]
    mlp = [p[k] for k in ("lns", "lnb", "wi", "bi", "wf", "bf")]
    with pytest.raises(TypeError):  # float32 activations
        vit_sublayer.attn_sublayer(x.float(), *sub, 4, 99)
    with pytest.raises(ValueError):  # head_dim 32
        vit_sublayer.attn_sublayer(x, *sub, 8, 99)
    with pytest.raises(ValueError):  # valid_len past n
        vit_sublayer.attn_sublayer(x, *sub, 4, 100)
    q = _rnd(gen, 1, 2, 520, 20)
    with pytest.raises(ValueError):  # head_dim 20: below JAX's gate of 32
        vit_attention.fused_vit_attention(q, q, q, 520)
    q = _rnd(gen, 1, 2, 520, 64)
    with pytest.raises(ValueError):  # q, k and v in different layouts
        vit_attention.fused_vit_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, 9)
    wide = _vit_block(gen, 256, 2048)
    with pytest.raises(ValueError):  # a chunk of I wider than 1024
        vit_mlp_fused.mlp_sublayer_fused(x, *(wide[k] for k in ("lns", "lnb", "wi", "bi", "wf",
                                                                 "bf")), k_chunks=1)
    with pytest.raises(ValueError):  # non-contiguous x
        vit_mlp.mlp_sublayer(_rnd(gen, 99, 2, 256).transpose(0, 1), *mlp)


# The w8a8 kernels (the swap-AB kernel's w8a8 mode at M <= 16, the w8a8
# mode of csrc/quant_wgmma.cuh up to quant.PALLAS_DEQUANT_MAX_M, the 192-row
# tile of csrc/int8_matmul_w8a8.cu above it) and the fused MLP
# (csrc/vit_mlp_fused.cu) at the main path's shapes: the 7B split layout's
# (K, N), split and unsplit K, at decode M (one row; 8; a ragged 13), at the
# wgmma mode's M (ragged 17, 65 and 200, the speculative verify's 40, 64,
# bench.py's 256, a prefill's 1000, the cut's 1024) and the prefill's 4512;
# the lm_head up to the cut.
W8A8_7B = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]


@pytest.mark.parametrize("m", [1, 8, 13, 17, 40, 64, 65, 200, 256, 1000, 1024, 4512])
@pytest.mark.parametrize("k,n", W8A8_7B + [(3584, 152064)])
def test_w8a8_kernel_matches_plain_at_7b_shapes(gen, m, k, n):
    if n == 152064 and m > quant.PALLAS_DEQUANT_MAX_M:
        pytest.skip("the prefill's lm_head takes the last token alone (M = 8)")
    w, scales = _quantized(gen, k, n, 8)
    x = _rnd(gen, m, k)
    before = quant.int8_matmul_w8a8.launches
    got = quant.int8_matmul_w8a8(x, w, scales)
    again = quant.int8_matmul_w8a8(x, w, scales)
    torch.cuda.synchronize()
    assert quant.int8_matmul_w8a8.launches == before + 2
    assert torch.equal(got, again)  # split K is reduced in a fixed order
    torch.testing.assert_close(got.float(), quant.int8_matmul_w8a8_reference(
        x, w, scales).float(), **TOL)


@pytest.mark.parametrize("m", list(range(1, 17)))
@pytest.mark.parametrize("k,n", W8A8_7B + [(3584, 4608), (3584, 37888), (3584, 152064),
                                 (1024, 112), (1024, 272)])
def test_w8a8_swapab_kernel_matches_plain_at_every_decode_m(gen, m, k, n):
    """The swap-AB kernel's w8a8 mode at every decode M on every 7B (K, N)
    (split and fused layouts, the lm_head) and two ragged N (the last
    64-column block partly inside N): one launch, the plain version's result
    within tolerance, the same bits from a second call."""
    w, scales = _quantized(gen, k, n, 8)
    x = _rnd(gen, m, k)
    before = quant.int8_matmul_w8a8.launches
    got = quant.int8_matmul_w8a8(x, w, scales)
    torch.cuda.synchronize()
    assert quant.int8_matmul_w8a8.launches == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), quant.int8_matmul_w8a8_reference(
        x, w, scales).float(), **TOL)
    assert torch.equal(got, quant.int8_matmul_w8a8(x, w, scales))


@pytest.mark.parametrize("k,n", [(3584, 512), (18944, 3584)])
def test_w8a8_swapab_kernel_is_one_device_launch(gen, k, n):
    """At M = 8 a w8a8 product is one device kernel: no quantize pass, no
    reduce of its K split (the cluster meets it)."""
    w, scales = _quantized(gen, k, n, 8)
    x = _rnd(gen, 8, k)
    quant.int8_matmul_w8a8(x, w, scales)  # build, plan and tensor map before the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        quant.int8_matmul_w8a8(x, w, scales)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "w8a8_swapab_kernel" in kernels[0], kernels


@pytest.mark.parametrize("m", [17, 40, 256])
def test_w8a8_wgmma_mode_is_a_quantize_and_a_product(gen, m):
    """Above decode M a w8a8 product is two device kernels, the quantize
    pass and quant_wgmma.cuh's w8a8 mode: no reduce of its K split (k_proj
    splits its 7 qblocks over a cluster)."""
    w, scales = _quantized(gen, 3584, 512, 8)
    x = _rnd(gen, m, 3584)
    assert quant.wgmma_plan(m, 512, 3584, 132, quant.MODE_W8A8)["cluster"] > 1
    quant.int8_matmul_w8a8(x, w, scales)  # build, plan and tensor maps before the trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        quant.int8_matmul_w8a8(x, w, scales)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 2 and "quantize_rows_kernel" in kernels[0], kernels
    assert "quant_wgmma_kernel<3" in kernels[1], kernels


@pytest.mark.parametrize("mode", [quant.MODE_INT8, quant.MODE_INT4, quant.MODE_INT4_DEQUANT,
                                  quant.MODE_W8A8])
def test_wgmma_blocks_an_sm_of_the_build_equal_the_cpu_model(gen, mode):
    """The plans made without a card (the CPU tests) size the ring by
    quant.cpu_blocks_per_sm; on the card they ask the built kernel. The two
    agree at every width of every mode."""
    widths = quant.W8A8_WGMMA_NB if mode == quant.MODE_W8A8 else quant.WGMMA_NB
    assert [quant._wgmma_blocks_per_sm(mode, nb) for nb in widths] == \
        [quant.cpu_blocks_per_sm(mode, nb) for nb in widths]


def test_w8a8_wrapper_raises_on_a_k_of_partial_blocks(gen):
    w, scales = _quantized(gen, 576, 128, 8)  # 576 = one 512-column block and a part
    with pytest.raises(ValueError):
        quant.int8_matmul_w8a8(_rnd(gen, 8, 576), w, scales)


def _bf16_acc_peak_ulp(x, p, act, k_chunks=vit_mlp_fused.K_CHUNKS):
    """One bf16 ulp of the largest |running sum| the bf16 accumulator rounds
    over its chunks, per output (as chip_smoke.py's bf16_acc_peak): where
    the kernel and the plain version round one running sum differently,
    that ulp outlives the later chunks."""
    h = vit_sublayer.layernorm_rounded(x, p["lns"], p["lnb"], 1e-5)
    inter = p["wi"].shape[1]
    kc = inter // vit_mlp_fused.chunks_for(inter, k_chunks)
    out = peak = None
    for c0 in range(0, inter, kc):
        t = vit_mlp.activation(vit_sublayer.dot_f32(h, p["wi"][:, c0:c0 + kc])
                               + p["bi"][c0:c0 + kc].float(), act)
        part = vit_sublayer.dot_f32(t.to(x.dtype), p["wf"][c0:c0 + kc])
        out = (x.float() + p["bf"].float() + part if out is None
               else out.float() + part).to(x.dtype)
        peak = out.float().abs() if peak is None else torch.maximum(peak, out.float().abs())
    return torch.exp2(torch.floor(torch.log2(peak.clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("n", [257, 99, 40])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("acc", ["bf16", "f32"])
def test_mlp_sublayer_fused_kernel_matches_plain_at_tower_width(gen, n, act, acc):
    p = _vit_block(gen, 1024, 4096)
    x = _rnd(gen, 3, n, 1024)
    args = (x, *(p[k] for k in ("lns", "lnb", "wi", "bi", "wf", "bf")))
    before = vit_mlp_fused.mlp_sublayer_fused.launches
    got = vit_mlp_fused.mlp_sublayer_fused(*args, act=act, acc=acc)
    again = vit_mlp_fused.mlp_sublayer_fused(*args, act=act, acc=acc)
    torch.cuda.synchronize()
    assert vit_mlp_fused.mlp_sublayer_fused.launches == before + 2
    assert torch.equal(got, again)
    want = vit_mlp_fused.mlp_sublayer_fused_reference(*args, act=act, acc=acc).float()
    extra = _bf16_acc_peak_ulp(x, p, act) if acc == "bf16" else 0.0
    over = (got.float() - want).abs() > TOL["atol"] + extra + TOL["rtol"] * want.abs()
    assert not bool(over.any()), f"{int(over.sum())} outputs outside the tolerance"


@pytest.mark.parametrize("w,inter,k_chunks", [(320, 1280, 8), (256, 768, 8)])
def test_mlp_sublayer_fused_wrapper_raises_on_the_new_limits(gen, w, inter, k_chunks):
    """The wgmma design takes widths that are multiples of 128 and chunks of
    I that are multiples of 64 (the design before it took multiples of 32)."""
    p = _vit_block(gen, w, inter)
    with pytest.raises(ValueError):
        vit_mlp_fused.mlp_sublayer_fused(_rnd(gen, 2, 9, w), *(p[k] for k in (
            "lns", "lnb", "wi", "bi", "wf", "bf")), k_chunks=k_chunks)


def test_matmul_f32_keeps_the_f32_sum_on_the_card(gen):
    """nn.matmul_f32 on bf16 operands returns the f32 sum (torch.mm with
    out_dtype), also for the transposed table the tied logits pass; dense
    rounds that sum plus the bias once. Tolerances: f32 summation order for
    the sum, one bf16 rounding flip for dense."""
    x, w, b = _rnd(gen, 3, 7, 512), _rnd(gen, 512, 384, scale=0.05), _rnd(gen, 384)
    want = x.float() @ w.float()
    got = nn.matmul_f32(x, w)
    assert got.dtype == torch.float32 and got.shape == (3, 7, 384)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    table = _rnd(gen, 384, 512, scale=0.05)
    torch.testing.assert_close(nn.matmul_f32(x, table.T), x.float() @ table.float().T,
                               rtol=1e-5, atol=1e-5)
    dense = nn.dense({"w": w, "b": b}, x)
    torch.testing.assert_close(dense.float(), (want + b.float()).to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=0.0)


@pytest.mark.parametrize("n", [257, 99])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_sublayer_kernel_matches_plain_at_tower_width(gen, n, act):
    """The wgmma + TMA GEMMs at the towers' width (w = 1024, I = 4096) and
    their token counts: the ragged row tail, clusters of two row tiles (the
    last one past the rows), the same bits on a second call."""
    p = _vit_block(gen, 1024, 4096)
    args = (_rnd(gen, 4, n, 1024), *(p[k] for k in ("lns", "lnb", "wi", "bi", "wf", "bf")))
    before = vit_mlp.mlp_sublayer.launches
    got = vit_mlp.mlp_sublayer(*args, act=act)
    again = vit_mlp.mlp_sublayer(*args, act=act)
    torch.cuda.synchronize()
    assert vit_mlp.mlp_sublayer.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), vit_mlp.mlp_sublayer_reference(
        *args, act=act).float(), **TOL)


@pytest.mark.parametrize("m", [1, 16, 17, 64])
@pytest.mark.parametrize("k,n", [(588, 1024), (1024, 4096), (4096, 1024), (1024, 768)])
def test_dense_w8a8_xla_on_the_card_equals_the_cpu(gen, m, k, n):
    """The encoder towers' w8a8 dense (a library product, padded on the card
    to torch._int_mm's M > 16 and K, N multiples of 8) gives the CPU's bits:
    the int8 product is exact, the f32 steps are the same operations."""
    x = _rnd(gen, m, k)
    w_q = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    scales = torch.rand((1, n), generator=gen, device="cuda") * 1e-3
    b = _rnd(gen, n)
    got = quant.dense_w8a8_xla(x, w_q, scales, b)
    want = quant.dense_w8a8_xla(x.cpu(), w_q.cpu(), scales.cpu(), b.cpu())
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_per_row_block_cache_write_on_the_card_equals_the_cpu(gen, dtype):
    """The speculative verify's cache write (t = 5 rows at per-row columns,
    a row starting before the cache, one running past its end) on CUDA
    tensors gives the CPU's cache."""
    from affectgpt_tpu_torch.models import qwen2

    k, v = _rnd(gen, 4, 2, 5, 128), _rnd(gen, 4, 2, 5, 128)
    start = torch.tensor([-3, 7, 30, 38], device="cuda")
    caches = [qwen2.kv_buffers((4, 2, 40, 128), dtype, device) for device in ("cuda", "cpu")]
    qwen2._write_cache(caches[0], k, v, start)
    qwen2._write_cache(caches[1], k.cpu(), v.cpu(), start.cpu())
    for name in caches[1]:
        assert torch.equal(caches[0][name].cpu(), caches[1][name]), name


# the Qwen2.5-7B shard shapes of tensor-parallel serving: (tp, heads a rank,
# kv heads a rank, the rank's columns of I)
TP_SHARDS = [(2, 14, 2, 9472), (4, 7, 1, 4736)]


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("tp,heads,kv,inter", TP_SHARDS)
@pytest.mark.parametrize("b", [1, 8, 16])
def test_decode_mlp_bf16_residual_modes_at_tp_shards(gen, b, tp, heads, kv, inter, residual):
    """Row 2 on a rank's shard, with its residual add and without it (the
    partial sum a tensor-parallel rank reduces before adding x once)."""
    h = 3584
    args = (_rnd(gen, b, h), _rnd(gen, h, scale=0.1, shift=1.0), _rnd(gen, h, inter, scale=0.02),
            _rnd(gen, h, inter, scale=0.02), _rnd(gen, inter, h, scale=0.02))
    before = decode_mlp_bf16.launches
    got = decode_mlp_bf16(*args, residual=residual)
    again = decode_mlp_bf16(*args, residual=residual)
    torch.cuda.synchronize()
    assert decode_mlp_bf16.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got.float(), decode_mlp_bf16_reference(*args, residual=residual).float(), **TOL)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("tp,heads,kv,inter", TP_SHARDS)
@pytest.mark.parametrize("b", [1, 8, 16])
def test_decode_attn_o_residual_modes_at_tp_shards(gen, b, tp, heads, kv, inter, residual):
    """Row 4 on a rank's heads (o_proj's rows of those heads)."""
    g, d, h, t = heads // kv, 128, 3584, 640
    args = (_rnd(gen, b, h), _rnd(gen, b, kv, g, d), _rnd(gen, b, kv, t, d),
            _rnd(gen, b, kv, t, d), _decode_window_edges(gen, b, t),
            _rnd(gen, kv * g * d, h, scale=0.02))
    before = decode_attn_o.launches
    got = decode_attn_o(*args, residual=residual)
    again = decode_attn_o(*args, residual=residual)
    torch.cuda.synchronize()
    assert decode_attn_o.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got.float(), decode_attn_o_reference(*args, residual=residual).float(), **TOL)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("tp,heads,kv,inter", TP_SHARDS)
@pytest.mark.parametrize("b", [1, 8, 16])
def test_decode_mlp_int8_residual_modes_at_tp_shards(gen, b, tp, heads, kv, inter, residual):
    """Row 10 on a rank's columns of I."""
    args = _int8_mlp(gen, b, 3584, inter)
    before = decode_mlp.launches
    got = decode_mlp(*args, residual=residual)
    torch.cuda.synchronize()
    assert decode_mlp.launches == before + 1
    torch.testing.assert_close(
        got.float(), decode_mlp_reference(*args, residual=residual).float(), **TOL)
