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
the fused MLP its bf16 out tile after every chunk)."""

import pytest
import torch

from affectgpt_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference
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
@pytest.mark.parametrize("heads,kv,hd,h", [(4, 2, 64, 256), (6, 2, 128, 384)])
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


def _window_mask(gen, b, t):
    """Per-row windows of valid columns that start past 0 (left pads) and
    end before T (columns not yet written)."""
    lo = torch.randint(1, max(2, t // 4), (b,), generator=gen, device="cuda")
    hi = torch.randint(t // 2, t - 1, (b,), generator=gen, device="cuda")
    cols = torch.arange(t, device="cuda")
    return (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("kv,g,d", [(2, 3, 64), (4, 7, 128)])
@pytest.mark.parametrize("t", [77, 200])  # not multiples of the 64-column chunk
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
@pytest.mark.parametrize("blk,width", [(16, 5), (8, 8)])
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


# the encoder kernels: CLIP's 257 tokens, HuBERT's 99 and a single key tile,
# each with keys masked past valid_len
VIT_TOKENS = [(257, 250), (99, 90), (40, 33)]


@pytest.mark.parametrize("n,valid", VIT_TOKENS)
@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
def test_vit_attention_kernel_matches_plain(gen, n, valid, layout):
    b, h, d = 3, 4, 64
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
    q = _rnd(gen, 1, 2, 520, 64)
    with pytest.raises(ValueError):  # more tokens than the kernel holds
        vit_attention.fused_vit_attention(q, q, q, 520)
    with pytest.raises(ValueError):  # q, k and v in different layouts
        vit_attention.fused_vit_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q, 9)
    wide = _vit_block(gen, 256, 2048)
    with pytest.raises(ValueError):  # a chunk of I wider than 1024
        vit_mlp_fused.mlp_sublayer_fused(x, *(wide[k] for k in ("lns", "lnb", "wi", "bi", "wf",
                                                                 "bf")), k_chunks=1)
    with pytest.raises(ValueError):  # non-contiguous x
        vit_mlp.mlp_sublayer(_rnd(gen, 99, 2, 256).transpose(0, 1), *mlp)


# The two wgmma designs (csrc/int8_matmul_w8a8.cu, csrc/vit_mlp_fused.cu) at
# the main path's shapes: the 7B split layout's (K, N), split and unsplit K,
# at every M the wgmma N-width choice meets (16 and 128 rows; one row; a
# ragged last tile; the prefill's 4512), the lm_head at decode M.
W8A8_7B = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]


@pytest.mark.parametrize("m", [1, 8, 13, 64, 65, 200, 4512])
@pytest.mark.parametrize("k,n", W8A8_7B + [(3584, 152064)])
def test_w8a8_kernel_matches_plain_at_7b_shapes(gen, m, k, n):
    if n == 152064 and m > 13:
        pytest.skip("the lm_head runs the kernel at decode M only")
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
