"""The whole pre-LN attention sublayer of CLIP ViT-L/14 and HuBERT-large:
x + o_proj(attention(LN(x))), keys ≥ valid_len masked.

Port of affectgpt_tpu/ops/vit_sublayer_pallas.py (`attn_sublayer`, `apply`).
On CUDA tensors the kernels of csrc/vit_sublayer.cu run (four launches in
one call, each after the first a programmatic dependent of the one before:
LayerNorm, the q/k/v products as one persistent launch of three products on
the wgmma + TMA GEMM of csrc/vit_gemm_wgmma.cuh, the attention, the o
product with the residual on the same GEMM; `attn_sublayer_plan`) or the
wrapper raises; on CPU tensors `attn_sublayer_reference`, the plain PyTorch
version, which is also the oracle the kernels are checked against on the
card.

Limits of the kernels: head_dim 64, width a multiple of 32 up to 2048, at
most 512 tokens. Any n is taken (JAX pads n to a multiple of 8 for the TPU);
query rows at or past valid_len are computed and attend to the valid keys.
"""

from __future__ import annotations

import functools

import torch

from affectgpt_tpu_torch.ops import _build
from affectgpt_tpu_torch.ops.vit_attention import HEAD_DIM, RESIDENT_KEYS, fused_vit_attention_reference
from affectgpt_tpu_torch.ops.vit_gemm import gemm_plan


def layernorm_rounded(x, scale, bias, eps: float):
    """The TPU kernels' LayerNorm: f32 mean, then the mean of squared
    deviations, (x - mean)·rsqrt(var + eps)·scale + bias, rounded to x's
    dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    h = (x32 - mean) * torch.rsqrt(var + eps)
    return (h * scale.float() + bias.float()).to(x.dtype)


def dot_f32(a, w):
    """a @ w as an f32 sum of the operands' exact products (JAX
    `preferred_element_type=f32`)."""
    return a.float() @ w.float()


def attn_sublayer_reference(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                            num_heads: int, valid_len: int, eps: float = 1e-5):
    """Plain version with the TPU kernel's rounding points: h = LN(x) rounded;
    q, k, v = (h·W + b) rounded; per head the attention of
    `fused_vit_attention_reference`; the heads side by side, rounded; then
    y = o·W_o + b_o + x in f32, rounded once."""
    b, n, w = x.shape
    d = w // num_heads
    h = layernorm_rounded(x, ln_scale, ln_bias, eps)

    def proj(wt, bt):  # [b, n, w] → [b, heads, n, d]
        y = (dot_f32(h, wt) + bt.float()).to(x.dtype)
        return y.reshape(b, n, num_heads, d).transpose(1, 2)

    o = fused_vit_attention_reference(proj(wq, bq), proj(wk, bk), proj(wv, bv), valid_len)
    o = o.transpose(1, 2).reshape(b, n, w)
    return (dot_f32(o, wo) + bo.float() + x.float()).to(x.dtype)


def attn_sublayer_plan(rows: int, w: int, sm_count: int) -> dict:
    """The products' launch plans over `rows` rows of width w: q/k/v as one
    launch of three products [rows, w] @ [w, w] over the rows h, o as one
    product over the attention's rows, each on the persistent wgmma GEMM
    (ops/vit_gemm.py: tiles, units, rounds, grid); the launches a call makes
    (LayerNorm, q/k/v, attention, o). Raises on what the GEMMs and the
    LayerNorm pass do not take: width % 32 (TMA's 16-byte row strides) and
    at most 2048 (the pass holds a row in 8-value pieces)."""
    if w % 32 or w > 2048 or rows < 1:
        raise ValueError(f"attn_sublayer kernel takes width % 32 == 0 up to 2048 and rows "
                         f">= 1 (width={w}, rows={rows})")
    return {"qkv": gemm_plan(rows, w, w, sm_count, products=3),
            "o": gemm_plan(rows, w, w, sm_count), "launches": 4}


@functools.lru_cache(maxsize=None)
def _plan_on(rows: int, w: int, device_index: int) -> torch.Tensor:
    """The C entry's Plan ints of `attn_sublayer_plan` on card device_index."""
    plan = attn_sublayer_plan(rows, w, _build.sm_count(device_index))
    qkv, o = plan["qkv"], plan["o"]
    return torch.tensor([qkv["m_tiles"], qkv["n_tiles"], qkv["grid"][0], o["grid"][0],
                         qkv["cluster"]], dtype=torch.int32)


def attn_sublayer(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                  num_heads: int, valid_len: int, eps: float = 1e-5):
    """x [b, n, w] (keys ≥ valid_len masked) → x + o_proj(attention(LN(x)))
    in x.dtype. Weights [w, w] in the `[in, out]` layout, biases and LN
    parameters [w]."""
    _build.refuse_grad("attn_sublayer", x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    args = (x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo)
    if x.device.type == "cpu":
        return attn_sublayer_reference(*args, num_heads, valid_len, eps)
    if x.device.type != "cuda":
        raise ValueError(f"attn_sublayer: no kernel for device {x.device}")
    b, n, w = x.shape
    vec, mat = (w,), (w, w)
    _build.check_bf16_operands("attn_sublayer", x.device, zip(
        args, ((b, n, w), vec, vec, mat, vec, mat, vec, mat, vec, mat, vec)))
    if w != num_heads * HEAD_DIM or w % 32 or w > 2048 \
            or not 1 <= valid_len <= n <= RESIDENT_KEYS:
        raise ValueError(f"attn_sublayer kernel takes head_dim {HEAD_DIM}, width % 32 == 0 up "
                         f"to 2048 and 1 <= valid_len <= n <= {RESIDENT_KEYS} (width={w}, "
                         f"heads={num_heads}, n={n}, valid_len={valid_len})")
    plan = _plan_on(b * n, w, x.device.index or 0)
    scratch = torch.empty((5, b, n, w), dtype=x.dtype, device=x.device)  # h, q, k, v, attn
    y = torch.empty_like(x)
    lib = _build.load_library()
    status = lib.agk_vit_attn_sublayer_bf16(
        *(t.data_ptr() for t in args), *(s.data_ptr() for s in scratch), y.data_ptr(),
        plan.data_ptr(), b, n, w, num_heads, int(valid_len), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "attn_sublayer")
    attn_sublayer.launches += 1
    return y


attn_sublayer.launches = 0  # wrapper calls that launched the kernels since the last reset


def apply(block: dict, x, num_heads: int, valid_len: int, eps: float):
    """`x + nn.mha(block['attn'], LN(x), ...)` of a pre-LN block
    (models/clip_vit.py _apply_block's attention half), on the kernels'
    rounding points."""
    a = block["attn"]
    return attn_sublayer(
        x, block["ln1"]["scale"], block["ln1"]["bias"],
        a["q"]["w"], a["q"]["b"], a["k"]["w"], a["k"]["b"],
        a["v"]["w"], a["v"]["b"], a["o"]["w"], a["o"]["b"],
        num_heads=num_heads, valid_len=valid_len, eps=eps,
    )
