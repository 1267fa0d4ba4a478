"""Plain versions of the port's decode kernels against the JAX Pallas
kernels run in interpret mode, on the same seeded numpy inputs, in f32.

Geometry and tolerances follow tests/test_decode_qkv_pallas.py (atol = rtol
= 2e-4) and tests/test_decode_mlp_bf16_pallas.py (1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.ops.decode_mlp_bf16_pallas import decode_mlp_bf16 as jax_decode_mlp
from affectgpt_tpu.ops.decode_qkv_pallas import decode_qkv as jax_decode_qkv
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv

H, HEADS, KV, HD, B = 256, 4, 2, 64, 8


@pytest.mark.parametrize("with_ln", [False, True], ids=["prenormed", "ln_folded"])
@pytest.mark.parametrize("pos_range", [(0, 500), (500, 4097)], ids=["pos_lt_500", "pos_gt_500"])
def test_decode_qkv_plain_matches_pallas(with_ln, pos_range):
    rng = np.random.RandomState(1)
    nq, nkv = HEADS * HD, KV * HD
    arrs = {
        "wq": rng.randn(H, nq) * 0.05, "wk": rng.randn(H, nkv) * 0.05,
        "wv": rng.randn(H, nkv) * 0.05, "bq": rng.randn(nq) * 0.1,
        "bk": rng.randn(nkv) * 0.1, "bv": rng.randn(nkv) * 0.1,
        "x": rng.randn(B, H), "ln": rng.randn(H) * 0.2 + 1.0,
    }
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    positions = rng.randint(*pos_range, size=(B,)).astype(np.int32)
    order = ("wq", "bq", "wk", "bk", "wv", "bv")
    kw = dict(num_heads=HEADS, num_kv_heads=KV, head_dim=HD, theta=1_000_000.0, eps=1e-6)

    want = jax_decode_qkv(
        jnp.asarray(arrs["x"]), jnp.asarray(positions), *(jnp.asarray(arrs[k]) for k in order),
        ln_scale=jnp.asarray(arrs["ln"]) if with_ln else None, interpret=True, **kw,
    )
    t = {k: torch.from_numpy(v) for k, v in arrs.items()}
    got = decode_qkv(
        t["x"], torch.from_numpy(positions), *(t[k] for k in order),
        ln_scale=t["ln"] if with_ln else None, **kw,
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4)


def test_decode_mlp_bf16_plain_matches_pallas():
    rng = np.random.RandomState(0)
    h, inter = 256, 1024
    wg = (rng.randn(h, inter) * 0.05).astype(np.float32)
    wu = (rng.randn(h, inter) * 0.05).astype(np.float32)
    wd = (rng.randn(inter, h) * 0.05).astype(np.float32)
    ln = (1.0 + 0.1 * rng.randn(h)).astype(np.float32)
    x = rng.randn(B, h).astype(np.float32)

    want = jax_decode_mlp(*(jnp.asarray(a) for a in (x, ln, wg, wu, wd)),
                          eps=1e-6, block_i=512, interpret=True)
    got = decode_mlp_bf16(*(torch.from_numpy(a) for a in (x, ln, wg, wu, wd)), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
