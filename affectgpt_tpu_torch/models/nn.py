"""Neural-net building blocks on explicit parameter dictionaries.

Port of affectgpt_tpu/models/nn.py. A dense leaf holds a float `w`, or int8
`w_q` with its `scales` (the encoder towers' serving mode,
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


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] of one dtype with its float32 sum: on the card a
    16-bit product writes the f32 sum directly (`torch.mm(...,
    out_dtype=float32)`; either operand may be a transposed view); on the
    CPU, where that overload is missing, the f32 product of the upcast
    operands, which is the same sum."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _MatmulF32(torch.autograd.Function):
    """`mm_f32` with the gradients of JAX's transpose of
    `dot(preferred_element_type=f32)`: the f32 cotangent is taken in the
    operands' dtype, each product sums in f32 and is rounded to its
    operand's dtype. `torch.mm(..., out_dtype=)` has no derivative of its
    own, so a frozen 16-bit projection on the card backpropagates through
    this function."""

    @staticmethod
    def forward(ctx, x2d, w):
        # x is read only for dw, w only for dx
        ctx.save_for_backward(x2d if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        return mm_f32(x2d, w)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = mm_f32(g.to(w.dtype), w.t()).to(w.dtype)
        if ctx.needs_input_grad[1]:
            dw = mm_f32(x2d.t(), g.to(x2d.dtype)).to(x2d.dtype)
        return dx, dw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] with its float32 sum, unrounded (JAX
    `preferred_element_type=f32`). Mixed dtypes compute in the promoted
    dtype. A 16-bit product runs on a 2-D view through `mm_f32` (w may be a
    transposed view, as the tied logits pass it), differentiable through
    `_MatmulF32` when an operand requires grad."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    x2d = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        y = _MatmulF32.apply(x2d, w)
    else:
        y = mm_f32(x2d, w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit ints that spreads every
    input bit over the output."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: tuple, data: int) -> tuple:
    """The dropout key of a sub-site: `key` extended by `data` (JAX
    `jax.random.fold_in`)."""
    return (*key, int(data))


def key_seed(key: tuple) -> int:
    """The 63-bit generator seed of a dropout key, a hash of its ints."""
    h = 0
    for v in key:
        h = _mix64(h ^ (int(v) & _MASK64))
    return h >> 1


def dropout_keep(key: tuple, rate: float, shape, device, cols=None) -> torch.Tensor:
    """The bool keep-mask of a dropout site, P(keep) = 1 - rate, drawn from a
    generator seeded from `key` on `device`: the same key gives the same
    mask. cols: (whole, start), the mask of columns [start, start +
    shape[-1]) of the mask drawn at a last axis of `whole` (a
    tensor-parallel rank's slice of a row-parallel input)."""
    g = torch.Generator(device=device).manual_seed(key_seed(key))
    if cols is None:
        return torch.rand(shape, generator=g, device=device) < 1.0 - rate
    whole, start = cols
    mask = torch.rand((*shape[:-1], whole), generator=g, device=device) < 1.0 - rate
    return mask[..., start:start + shape[-1]]


def keep_scale(rate: float, dtype) -> float:
    """1 - rate rounded to `dtype`, as a host float: the divisor of the kept
    values (JAX divides by `jnp.asarray(1 - rate, x.dtype)`). Kept on the
    host: a tensor made from it on the card would be a copy the host waits
    for at every dropout site."""
    return torch.tensor(1.0 - rate, dtype=dtype).item()


def dropout(key: tuple, rate: float, x: torch.Tensor, cols=None) -> torch.Tensor:
    """Inverted dropout (train-mode torch nn.Dropout): zero with prob
    `rate`, survivors divided by (1 - rate) in x's dtype, as JAX's
    `nn.dropout`. Callers gate on key presence: eval mode never calls it.
    cols: as in `dropout_keep`."""
    keep = dropout_keep(key, rate, x.shape, x.device, cols)
    return torch.where(keep, x / keep_scale(rate, x.dtype), 0.0)


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


def needs_grad(*trees) -> bool:
    """True when grad mode is on and a tensor among `trees` (tensors, or
    dicts and lists of them) requires grad: a trainable tower's block, which
    takes the plain chain, since no hand-written kernel has a backward."""
    if not torch.is_grad_enabled():
        return False
    stack = list(trees)
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif torch.is_tensor(node) and node.requires_grad:
            return True
    return False


def _fused_self_attn_ok(tq: int, tk: int, mask, *operands) -> bool:
    """JAX's route rule: full (unmasked) self-attention of at least 192
    tokens. Shorter sequences stay on the plain chain (on the TPU the kernel
    lost 8% at HuBERT's 99 tokens), and so do operands that require grad
    under grad mode (`needs_grad`: a trainable tower)."""
    return (FUSED_MHA != "0" and mask is None and tq == tk and tq >= 192
            and not needs_grad(*operands))


def mha(params, q_input: torch.Tensor, kv_input: torch.Tensor, num_heads: int,
        mask=None, probs_drop=None) -> torch.Tensor:
    """Attention with the full softmax in f32: q_input [b, tq, dq], kv_input
    [b, tk, dkv], mask broadcastable to [b, h, tq, tk] (bool, True = attend).
    Logits are f32 sums divided by √d, masked with finfo(f32).min; the
    probabilities are rounded to v's dtype before the f32 PV product.
    Unmasked self-attention of at least 192 tokens goes to the fused kernel
    (`_fused_self_attn_ok`) unless q, k or v requires grad. probs_drop:
    optional (key, rate), train-mode dropout on the probabilities (BERT
    attention_probs_dropout_prob); it keeps the call on the plain chain, as
    in JAX."""
    b, tq, _ = q_input.shape
    tk = kv_input.shape[1]
    inner = out_dim(params["q"])
    head_dim = inner // num_heads
    q = dense(params["q"], q_input).reshape(b, tq, num_heads, head_dim)
    k = dense(params["k"], kv_input).reshape(b, tk, num_heads, head_dim)
    v = dense(params["v"], kv_input).reshape(b, tk, num_heads, head_dim)
    if probs_drop is None and _fused_self_attn_ok(tq, tk, mask, q, k, v):
        from affectgpt_tpu_torch.ops import vit_attention

        out = vit_attention.fused_self_attention(q, k, v, valid_len=tk)
        return dense(params["o"], out.to(q_input.dtype).reshape(b, tq, inner))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(head_dim)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    if probs_drop is not None:
        probs = dropout(probs_drop[0], probs_drop[1], probs)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return dense(params["o"], out.to(q_input.dtype).reshape(b, tq, inner))
