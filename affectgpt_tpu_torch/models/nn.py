"""Neural-net building blocks on explicit parameter dictionaries.

Port of affectgpt_tpu/models/nn.py. Parameters are nested dicts of tensors
with the JAX package's keys and layouts (dense `w` is `[in, out]`, applied
as `x @ w`), so a converted JAX tree drops in unchanged.

Compute convention, as in the JAX package: matmuls accumulate in float32
and the result returns to the activation dtype; norms take float32
statistics. Init functions draw from an explicit `torch.Generator` and
allocate on its device.
"""

from __future__ import annotations

import torch


def normal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    out = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (out * scale).to(dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w returned in float32 (JAX `preferred_element_type=f32`). Mixed
    dtypes compute in the promoted dtype. In bfloat16 the product is
    accumulated in float32 by the BLAS and rounded once before the upcast."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return torch.matmul(x, w).float()


def dense_init(generator, in_dim: int, out_dim: int, scale: float = 0.02, dtype=torch.float32):
    return {
        "w": normal(generator, (in_dim, out_dim), scale, dtype),
        "b": torch.zeros((out_dim,), dtype=dtype, device=generator.device),
    }


def dense(params, x: torch.Tensor) -> torch.Tensor:
    y = matmul_f32(x, params["w"]) + params["b"].float()
    return y.to(x.dtype)


def dense_nobias_init(generator, in_dim: int, out_dim: int, scale: float = 0.02,
                      dtype=torch.float32):
    return {"w": normal(generator, (in_dim, out_dim), scale, dtype)}


def dense_nobias(params, x: torch.Tensor) -> torch.Tensor:
    return matmul_f32(x, params["w"]).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rmsnorm_init(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


def embedding_init(generator, num: int, dim: int, scale: float = 0.02, dtype=torch.float32):
    return {"table": normal(generator, (num, dim), scale, dtype)}


def embedding(params, ids: torch.Tensor) -> torch.Tensor:
    return params["table"][ids]
