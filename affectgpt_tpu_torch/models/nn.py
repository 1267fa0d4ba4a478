"""Neural-net building blocks on explicit parameter dictionaries.

Port of affectgpt_tpu/models/nn.py; `mha`'s train-mode `probs_drop` and
`dropout` are not ported yet. A dense leaf holds a float `w`, or int8 `w_q`
with its `scales` (the encoder towers' serving mode,
`ops.quant.quantize_encoder_tree`), which `dense` and `dense_nobias` send to
`ops.quant.dense_w8a8_xla`. Parameters
are nested dicts of tensors with the JAX package's keys and layouts (dense
`w` is `[in, out]`, applied as `x @ w`), so a converted JAX tree drops in
unchanged.

Compute convention, as in the JAX package: matmuls accumulate in float32
and the result returns to the activation dtype; norms take float32
statistics. Init functions draw from an explicit `torch.Generator` and
allocate on its device.
"""

from __future__ import annotations

import math

import torch

from affectgpt_tpu_torch.ops import quant


def normal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    out = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (out * scale).to(dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with its float32 sum, unrounded (JAX
    `preferred_element_type=f32`). Mixed dtypes compute in the promoted
    dtype. On the card a 16-bit product writes its f32 sum directly
    (`torch.mm(..., out_dtype=float32)` over a 2-D view; w may be a
    transposed view, as the tied logits pass it); on the CPU, where that
    overload is missing, the f32 product of the upcast operands, which is
    the same sum."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    x2d = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        y = torch.mm(x2d, w, out_dtype=torch.float32)
    else:
        y = torch.mm(x2d.float(), w.float())
    return y.reshape(*x.shape[:-1], w.shape[-1])


def dense_init(generator, in_dim: int, out_dim: int, scale: float = 0.02, dtype=torch.float32):
    return {
        "w": normal(generator, (in_dim, out_dim), scale, dtype),
        "b": torch.zeros((out_dim,), dtype=dtype, device=generator.device),
    }


def out_dim(params) -> int:
    """Output width of a dense leaf, float or int8."""
    return params.get("w", params.get("w_q")).shape[1]


def dense(params, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in params:  # int8 tower serving mode
        return quant.dense_w8a8_xla(x, params["w_q"], params["scales"], params.get("b"))
    y = matmul_f32(x, params["w"]) + params["b"].float()
    return y.to(x.dtype)


def dense_nobias_init(generator, in_dim: int, out_dim: int, scale: float = 0.02,
                      dtype=torch.float32):
    return {"w": normal(generator, (in_dim, out_dim), scale, dtype)}


def dense_nobias(params, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in params:  # int8 tower serving mode
        return quant.dense_w8a8_xla(x, params["w_q"], params["scales"])
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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The erf gelu (torch nn.GELU's default, BERT "gelu")."""
    return torch.nn.functional.gelu(x)


def mha_init(generator, q_dim: int, kv_dim: int, num_heads: int, head_dim=None,
             dtype=torch.float32):
    """Multi-head attention projections: q from q_dim, k/v from kv_dim,
    output back to q_dim."""
    inner = num_heads * (head_dim or q_dim // num_heads)
    return {
        "q": dense_init(generator, q_dim, inner, dtype=dtype),
        "k": dense_init(generator, kv_dim, inner, dtype=dtype),
        "v": dense_init(generator, kv_dim, inner, dtype=dtype),
        "o": dense_init(generator, inner, q_dim, dtype=dtype),
    }


# Route of unmasked self-attention in `mha`: "auto" sends it to the fused
# kernel (ops/vit_attention.py) from 192 tokens on, "0" keeps every call on
# the plain chain. JAX's AFFECTGPT_FUSED_MHA, with its TPU gates (backend,
# head_dim % 8, head_dim >= 32) dropped.
FUSED_MHA = "auto"


def _fused_self_attn_ok(tq: int, tk: int, mask) -> bool:
    """JAX's route rule: full (unmasked) self-attention of at least 192
    tokens. Shorter sequences stay on the plain chain (on the TPU the kernel
    lost 8% at HuBERT's 99 tokens)."""
    return FUSED_MHA != "0" and mask is None and tq == tk and tq >= 192


def mha(params, q_input: torch.Tensor, kv_input: torch.Tensor, num_heads: int,
        mask=None, probs_drop=None) -> torch.Tensor:
    """Attention with the full softmax in f32: q_input [b, tq, dq], kv_input
    [b, tk, dkv], mask broadcastable to [b, h, tq, tk] (bool, True = attend).
    Logits are f32 sums divided by √d, masked with finfo(f32).min; the
    probabilities are rounded to v's dtype before the f32 PV product.
    Unmasked self-attention of at least 192 tokens goes to the fused kernel
    (`_fused_self_attn_ok`). probs_drop (train-mode attention dropout) waits
    for the training slice and raises."""
    if probs_drop is not None:
        raise NotImplementedError("mha: probs_drop (train-mode dropout) is not ported yet")
    b, tq, _ = q_input.shape
    tk = kv_input.shape[1]
    inner = out_dim(params["q"])
    head_dim = inner // num_heads
    q = dense(params["q"], q_input).reshape(b, tq, num_heads, head_dim)
    k = dense(params["k"], kv_input).reshape(b, tk, num_heads, head_dim)
    v = dense(params["v"], kv_input).reshape(b, tk, num_heads, head_dim)
    if _fused_self_attn_ok(tq, tk, mask):
        from affectgpt_tpu_torch.ops import vit_attention

        out = vit_attention.fused_self_attention(q, k, v, valid_len=tk)
        return dense(params["o"], out.to(q_input.dtype).reshape(b, tq, inner))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(head_dim)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return dense(params["o"], out.to(q_input.dtype).reshape(b, tq, inner))
