"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device. On a machine with a
card (and no jax), run them with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
Tolerance rtol 1.6e-2, atol 1e-2: both sides round to bf16 at the same
points, so they differ by f32 summation order plus one final rounding."""

import pytest
import torch

from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16, decode_mlp_bf16_reference
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv, decode_qkv_reference

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
