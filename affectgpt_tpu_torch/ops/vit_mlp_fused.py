"""The pre-LN MLP sublayer in one call, with no [rows, I] intermediate in
device memory: x + fc2(act(fc1(LN(x)))), I cut into k_chunks chunks.

Port of affectgpt_tpu/ops/vit_mlp_fused_pallas.py (`mlp_sublayer_fused`,
`apply`, `apply_hubert`). On CUDA tensors the kernel of
csrc/vit_mlp_fused.cu runs (or the wrapper raises); on CPU tensors
`mlp_sublayer_fused_reference`, the plain PyTorch version, which is also the
oracle the kernel is checked against on the card.

`acc` selects one of the TPU kernel's two functions: "bf16" rounds the out
tile to bf16 after every chunk, "f32" keeps it in f32 and rounds once. The
TPU's row block (`block_rows`, a VMEM tile) has no counterpart: rows are
independent. Kernel limits: width and I / k_chunks multiples of 32, each at
most 1024.
"""

from __future__ import annotations

import torch

from affectgpt_tpu_torch.ops import _build
from affectgpt_tpu_torch.ops.vit_mlp import ACTS, activation
from affectgpt_tpu_torch.ops.vit_sublayer import dot_f32, layernorm_rounded

# `apply` and `apply_hubert` use JAX's defaults (VIT_MLP_FUSED_K, _ACC)
K_CHUNKS = 8
ACC = "bf16"


def chunks_for(inter: int, k_chunks: int) -> int:
    """k_chunks halved until it divides I, as the JAX wrapper rounds it."""
    while inter % k_chunks:
        k_chunks //= 2
    return k_chunks


def mlp_sublayer_fused_reference(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out,
                                 eps: float = 1e-5, act: str = "quick_gelu",
                                 k_chunks: int = K_CHUNKS, acc: str = ACC):
    """Plain version with the TPU kernels' rounding points: h = LN(x)
    rounded; per chunk t = act(h·W_in[:, c] + b_in[c]) rounded, P = t·W_out[c]
    in f32; bf16: out = round(x + b_out + P₀), then out = round(out + Pₖ);
    f32: x + b_out + ΣPₖ, rounded once."""
    inter = w_in.shape[1]
    kc = inter // chunks_for(inter, k_chunks)
    h = layernorm_rounded(x, ln_scale, ln_bias, eps)
    out = None
    for c0 in range(0, inter, kc):
        t = activation(dot_f32(h, w_in[:, c0:c0 + kc]) + b_in[c0:c0 + kc].float(), act)
        part = dot_f32(t.to(x.dtype), w_out[c0:c0 + kc])
        out = x.float() + b_out.float() + part if out is None else out.float() + part
        if acc == "bf16":
            out = out.to(x.dtype)
    return out.to(x.dtype)


def mlp_sublayer_fused(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, eps: float = 1e-5,
                       act: str = "quick_gelu", k_chunks: int = K_CHUNKS, acc: str = ACC):
    """x [b, n, w] → x + fc2(act(fc1(LN(x)))) in x.dtype, one kernel launch.
    w_in [w, I], w_out [I, w] in the `[in, out]` layout."""
    if act not in ACTS or acc not in ("bf16", "f32"):
        raise ValueError(f"mlp_sublayer_fused: act {act!r}, acc {acc!r}")
    args = (x, ln_scale, ln_bias, w_in, b_in, w_out, b_out)
    if x.device.type == "cpu":
        return mlp_sublayer_fused_reference(*args, eps=eps, act=act, k_chunks=k_chunks, acc=acc)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_sublayer_fused: no kernel for device {x.device}")
    b, n, w = x.shape
    inter = w_in.shape[1]
    _build.check_bf16_operands("mlp_sublayer_fused", x.device, zip(
        args, ((b, n, w), (w,), (w,), (w, inter), (inter,), (inter, w), (w,))))
    chunks = chunks_for(inter, k_chunks)
    kc = inter // chunks
    if w % 32 or kc % 32 or w > 1024 or kc > 1024:
        raise ValueError(f"mlp_sublayer_fused kernel takes width and I / k_chunks multiples of "
                         f"32 up to 1024 (width={w}, chunk={kc})")
    y = torch.empty_like(x)
    lib = _build.load_library()
    status = lib.agk_vit_mlp_fused_bf16(
        *(a.data_ptr() for a in args), y.data_ptr(), b * n, w, inter, chunks, ACTS[act],
        int(acc == "f32"), float(eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "mlp_sublayer_fused")
    mlp_sublayer_fused.launches += 1
    return y


mlp_sublayer_fused.launches = 0  # kernel launches since the last reset


def apply(block: dict, x, eps: float):
    """The MLP half of models/clip_vit.py _apply_block (quick_gelu)."""
    return mlp_sublayer_fused(
        x, block["ln2"]["scale"], block["ln2"]["bias"],
        block["mlp_in"]["w"], block["mlp_in"]["b"],
        block["mlp_out"]["w"], block["mlp_out"]["b"], eps=eps,
    )


def apply_hubert(layer: dict, x, eps: float):
    """The FFN half of a models/hubert.py layer (erf gelu)."""
    return mlp_sublayer_fused(
        x, layer["ffn_ln"]["scale"], layer["ffn_ln"]["bias"],
        layer["ffn_in"]["w"], layer["ffn_in"]["b"],
        layer["ffn_out"]["w"], layer["ffn_out"]["b"], eps=eps, act="gelu",
    )
