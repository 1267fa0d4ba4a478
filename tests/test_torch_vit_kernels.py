"""The plain versions of the port's four encoder kernels against the JAX
package's Pallas kernels, which run here in interpret mode as
tests/test_vit_*.py run them: the same numpy inputs go to both.

In float32 every rounding point is exact, so the two differ only by f32
summation order and the erf (the TPU kernels' Abramowitz-Stegun rational is
within 1.5e-7 of torch.erf): rtol and atol 1e-5. One bfloat16 case per
kernel holds the rounding points themselves: both sides round at the same
places, and an f32 sum taken in another order flips at most one bf16
rounding of an intermediate or of the output, so the tolerance is one bf16
ulp (2^-7 relative, and 2^-7 of the largest output for atol); at these
sizes the attention sublayer differs in one output in 200, by less than one
ulp, and the other kernels not at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.ops import vit_attention_pallas as jattn
from affectgpt_tpu.ops import vit_mlp_fused_pallas as jfused
from affectgpt_tpu.ops import vit_mlp_pallas as jmlp
from affectgpt_tpu.ops import vit_sublayer_pallas as jsub
from affectgpt_tpu_torch.ops import vit_attention, vit_mlp, vit_mlp_fused, vit_sublayer

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _arrays(seed, dtype, **shapes):
    """name → (numpy float32 array, matching jax array, matching torch tensor)
    in `dtype` ("float32" or "bfloat16"); LN scales near 1, the rest scaled
    as the towers' weights."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, (shape, scale, shift) in shapes.items():
        a = (rng.randn(*shape) * scale + shift).astype(np.float32)
        t = torch.from_numpy(a).to(getattr(torch, dtype))
        a = t.float().numpy()  # the values both sides see
        out[name] = (a, jnp.asarray(a).astype(getattr(jnp, dtype)), t)
    return out


def _check(got: torch.Tensor, want, dtype: str):
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-7 * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype,b,h,n,d,valid", [
    ("float32", 2, 3, 24, 16, 24),
    ("float32", 2, 3, 24, 16, 19),  # padded keys masked
    ("float32", 1, 2, 264, 64, 257),  # CLIP's padded token count
    ("bfloat16", 2, 4, 40, 64, 37),
    # the zoo's shapes: SigLIP's head_dim 72, and more tokens than K and V of a
    # unit hold in shared memory (DINOv2-large's 1370), where the kernel streams
    ("float32", 2, 2, 48, 72, 45),
    ("float32", 1, 2, 528, 64, 521),
    ("float32", 1, 1, 736, 72, 729),
    ("bfloat16", 1, 2, 520, 72, 515),
])
def test_fused_vit_attention_plain_matches_pallas(dtype, b, h, n, d, valid):
    a = _arrays(n + valid, dtype, q=((b, h, n, d), 1.0, 0.0), k=((b, h, n, d), 1.0, 0.0),
                v=((b, h, n, d), 1.0, 0.0))
    want = jattn.fused_vit_attention(a["q"][1], a["k"][1], a["v"][1], valid_len=valid,
                                     interpret=True)
    got = vit_attention.fused_vit_attention(a["q"][2], a["k"][2], a["v"][2], valid)
    assert got.dtype == a["q"][2].dtype and got.shape == (b, h, n, d)
    _check(got, want, dtype)
    # the [b, t, h, d] entry computes the same function on the transposed layout
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    _check(tr(vit_attention.fused_self_attention(tr(a["q"][2]), tr(a["k"][2]), tr(a["v"][2]),
                                                 valid)), want, dtype)


LOG2E = 1.4426950408889634


def _flash_emulation(q, k, v, valid_len, key_tile=None):
    """The arithmetic of the streaming design (csrc/vit_attention_flash.cu)
    in plain torch, q, k, v [b, h, n, d]: key tiles of `key_tile` (by
    default the kernel's at this head_dim, from its plan) in order,
    keys >= valid_len masked; each row's running max m (log2 domain) and sum
    l in f32; p = exp2(s log2(e) / sqrt(d) - m) rounded to v's dtype before
    it is normalised, O = O exp2(m_old - m) + p V in f32; O divided by l once
    at the end and rounded once to q's dtype. The TPU kernel and
    `fused_vit_attention_reference` normalise p before rounding it."""
    b, h, n, d = q.shape
    if key_tile is None:
        key_tile = vit_attention.vit_attention_plan(n, valid_len, head_dim=d)["key_tile"]
    c = LOG2E / d ** 0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((b, h, n, 1), -1e30)
    l = torch.zeros((b, h, n, 1))
    o = torch.zeros((b, h, n, d))
    for k0 in range(0, valid_len, key_tile):
        k1 = min(k0 + key_tile, valid_len)  # the masked keys' p is exactly 0
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)
        mn = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s * c - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(v.dtype).float() @ vf[:, :, k0:k1]
        m = mn
    return (o / l).to(q.dtype)


@pytest.mark.parametrize("b,h,n,d,valid", [
    (1, 2, 264, 64, 257),  # DINOv2's head_dim: three key tiles, one valid key in the last
    (1, 2, 200, 72, 185),  # SigLIP's head_dim: key tiles of 64, the last masked mid-way
    (1, 1, 136, 128, 120),  # the widest head_dim; one key tile
])
def test_flash_emulation_against_plain_in_bf16(b, h, n, d, valid):
    """The streaming design rounds p before it normalises it: in bf16 it is
    another function than the plain version's (normalise, then round), of
    the same error size, held to the kernels' tolerance on the card."""
    a = _arrays(n + d, "bfloat16", q=((b, h, n, d), 1.0, 0.0), k=((b, h, n, d), 1.0, 0.0),
                v=((b, h, n, d), 1.0, 0.0))
    q, k, v = a["q"][2], a["k"][2], a["v"][2]
    got = _flash_emulation(q, k, v, valid)
    want = vit_attention.fused_vit_attention_reference(q, k, v, valid)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, n, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1e-2)
    # the same function in f32: rounding p is the only difference
    f32 = [x.float() for x in (q, k, v)]
    torch.testing.assert_close(_flash_emulation(*f32, valid),
                               vit_attention.fused_vit_attention_reference(*f32, valid),
                               **F32_TOL)


@pytest.mark.parametrize("b,h,n,d,valid,key_tile", [
    (2, 2, 48, 72, 45, None),  # the kernel's key tiles at SigLIP's head_dim: 64
    (1, 2, 136, 64, 129, None),  # two key tiles of 128, one valid key in the last
    (1, 1, 72, 128, 70, 16),  # five key tiles of 16: the online rescale many times over
])
def test_flash_emulation_matches_pallas_in_f32(b, h, n, d, valid, key_tile):
    """In f32 p's rounding is exact, so the one-pass online softmax and JAX's
    kernel (whole rows, normalised p) agree up to summation order."""
    a = _arrays(n + valid, "float32", q=((b, h, n, d), 1.0, 0.0), k=((b, h, n, d), 1.0, 0.0),
                v=((b, h, n, d), 1.0, 0.0))
    want = jattn.fused_vit_attention(a["q"][1], a["k"][1], a["v"][1], valid_len=valid,
                                     interpret=True)
    got = _flash_emulation(a["q"][2], a["k"][2], a["v"][2], valid, key_tile)
    _check(got, want, "float32")


def _sublayer_arrays(seed, dtype, b, n, w):
    vec, mat = ((w,), 0.1, 0.0), ((w, w), w ** -0.5, 0.0)
    return _arrays(seed, dtype, x=((b, n, w), 1.0, 0.0), lns=((w,), 0.1, 1.0), lnb=vec,
                   wq=mat, bq=vec, wk=mat, bk=vec, wv=mat, bv=vec, wo=mat, bo=vec)


@pytest.mark.parametrize("dtype,b,n,w,heads,valid", [
    ("float32", 2, 24, 32, 2, 24),
    ("float32", 2, 24, 32, 2, 21),
    ("float32", 3, 16, 64, 4, 9),
    ("bfloat16", 2, 16, 128, 2, 13),
])
def test_attn_sublayer_plain_matches_pallas(dtype, b, n, w, heads, valid):
    a = _sublayer_arrays(w + valid, dtype, b, n, w)
    names = ("x", "lns", "lnb", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
    want = jsub.attn_sublayer(*(a[k][1] for k in names), num_heads=heads, valid_len=valid,
                              eps=1e-5, interpret=True)
    got = vit_sublayer.attn_sublayer(*(a[k][2] for k in names), heads, valid, 1e-5)
    assert got.dtype == a["x"][2].dtype and got.shape == (b, n, w)
    _check(got, want, dtype)


def _mlp_arrays(seed, dtype, b, n, w, inter):
    return _arrays(seed, dtype, x=((b, n, w), 1.0, 0.0), lns=((w,), 0.1, 1.0),
                   lnb=((w,), 0.1, 0.0), wi=((w, inter), w ** -0.5, 0.0),
                   bi=((inter,), 0.1, 0.0), wo=((inter, w), inter ** -0.5, 0.0),
                   bo=((w,), 0.1, 0.0))


MLP_NAMES = ("x", "lns", "lnb", "wi", "bi", "wo", "bo")


@pytest.mark.parametrize("dtype,act,b,image_chunk", [
    ("float32", "quick_gelu", 3, 0),
    ("float32", "gelu", 3, 0),
    ("float32", "gelu", 4, 2),  # two chunks of two images
    ("float32", "quick_gelu", 5, 3),  # no divisor above 1: unchunked
    ("bfloat16", "gelu", 3, 0),
    ("bfloat16", "quick_gelu", 3, 0),
])
def test_mlp_sublayer_plain_matches_pallas(dtype, act, b, image_chunk):
    n, w, inter = 8, 32, 128
    a = _mlp_arrays(b + len(act), dtype, b, n, w, inter)
    want = jmlp.mlp_sublayer(*(a[k][1] for k in MLP_NAMES), eps=1e-5, act=act, interpret=True,
                             image_chunk=image_chunk)
    got = vit_mlp.mlp_sublayer(*(a[k][2] for k in MLP_NAMES), eps=1e-5, act=act,
                               image_chunk=image_chunk)
    assert got.dtype == a["x"][2].dtype and got.shape == (b, n, w)
    _check(got, want, dtype)
    if image_chunk:  # rows are independent: chunking changes no bit
        assert torch.equal(got, vit_mlp.mlp_sublayer(*(a[k][2] for k in MLP_NAMES), eps=1e-5,
                                                     act=act))


@pytest.mark.parametrize("dtype,act,inter,k_chunks,acc", [
    ("float32", "quick_gelu", 128, 8, "bf16"),
    ("float32", "gelu", 128, 8, "f32"),
    ("float32", "gelu", 80, 32, "bf16"),  # 32 halves to 16, a divisor of 80
    ("float32", "quick_gelu", 96, 5, "f32"),  # 5 halves to 2
    ("bfloat16", "quick_gelu", 128, 4, "bf16"),
    ("bfloat16", "gelu", 128, 4, "f32"),
])
def test_mlp_sublayer_fused_plain_matches_pallas(dtype, act, inter, k_chunks, acc):
    b, n, w = 2, 9, 32
    a = _mlp_arrays(inter + k_chunks, dtype, b, n, w, inter)
    want = jfused.mlp_sublayer_fused(*(a[k][1] for k in MLP_NAMES), eps=1e-5, act=act,
                                     interpret=True, k_chunks=k_chunks, acc=acc)
    got = vit_mlp_fused.mlp_sublayer_fused(*(a[k][2] for k in MLP_NAMES), eps=1e-5, act=act,
                                           k_chunks=k_chunks, acc=acc)
    assert got.dtype == a["x"][2].dtype and got.shape == (b, n, w)
    _check(got, want, dtype)


def test_fused_mlp_accumulations_are_two_functions_in_bf16():
    """In bf16 the per-chunk rounding of the bf16 accumulator shows: the two
    `acc` settings give different outputs, and the f32 one stays at least as
    close to the two-call pair's single f32 sum."""
    a = _mlp_arrays(3, "bfloat16", 2, 9, 32, 256)
    args = [a[k][2] for k in MLP_NAMES]
    bf = vit_mlp_fused.mlp_sublayer_fused(*args, k_chunks=8, acc="bf16")
    f32 = vit_mlp_fused.mlp_sublayer_fused(*args, k_chunks=8, acc="f32")
    assert not torch.equal(bf, f32)
    pair = vit_mlp.mlp_sublayer(*args)  # one f32 sum over I, rounded once
    assert (f32.float() - pair.float()).abs().max() <= (bf.float() - pair.float()).abs().max()


def test_kernel_wrappers_on_cpu_count_no_launch():
    vit_attention.fused_vit_attention.launches = vit_sublayer.attn_sublayer.launches = 0
    vit_mlp.mlp_sublayer.launches = vit_mlp_fused.mlp_sublayer_fused.launches = 0
    a = _sublayer_arrays(0, "bfloat16", 2, 5, 64)
    x = a["x"][2]
    vit_sublayer.attn_sublayer(*(a[k][2] for k in ("x", "lns", "lnb", "wq", "bq", "wk", "bk",
                                                    "wv", "bv", "wo", "bo")), 1, 5)
    q = x.reshape(2, 5, 1, 64)
    vit_attention.fused_self_attention(q, q, q, 4)
    m = _mlp_arrays(1, "bfloat16", 2, 5, 32, 64)
    vit_mlp.mlp_sublayer(*(m[k][2] for k in MLP_NAMES))
    vit_mlp_fused.mlp_sublayer_fused(*(m[k][2] for k in MLP_NAMES))
    assert vit_attention.fused_vit_attention.launches == vit_sublayer.attn_sublayer.launches == 0
    assert vit_mlp.mlp_sublayer.launches == vit_mlp_fused.mlp_sublayer_fused.launches == 0


def test_wrappers_reject_unknown_activation_and_accumulator():
    m = _mlp_arrays(2, "float32", 1, 3, 32, 64)
    args = [m[k][2] for k in MLP_NAMES]
    with pytest.raises(ValueError):
        vit_mlp.mlp_sublayer(*args, act="relu")
    with pytest.raises(ValueError):
        vit_mlp_fused.mlp_sublayer_fused(*args, acc="f16")
