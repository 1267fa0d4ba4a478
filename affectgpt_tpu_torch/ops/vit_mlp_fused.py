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
independent. Kernel limits: width a multiple of 128 and I / k_chunks of 64,
each at most 1024 (`fused_plan`).
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


# csrc/vit_mlp_fused.cu: a cluster of width / 128 blocks owns 128 rows, each
# block 128 output columns; t is kept in pieces of 64 columns per block; a
# ring of four 24 KB stages plus an [128, 512] bf16 t tile and 1 KB of
# alignment fill a block's shared memory
FUSED_BM, FUSED_SLAB, FUSED_STAGES, FUSED_STAGE_BYTES = 128, 128, 4, 24576


def fused_plan(rows: int, w: int, inter: int, k_chunks: int) -> dict:
    """The launch plan of the kernel: its row tiles, the cluster size (blocks
    per row tile), the chunk width kc, each chunk's pieces of t ((first
    column, width) within the chunk), the dynamic shared memory in bytes and
    the bytes the blocks read from L2. Raises on what the kernel does not
    take."""
    chunks = chunks_for(inter, k_chunks)
    kc = inter // chunks
    if w % 128 or kc % 64 or w > 1024 or kc > 1024:
        raise ValueError(f"mlp_sublayer_fused kernel takes a width that is a multiple of 128 "
                         f"and I / k_chunks a multiple of 64, each up to 1024 (width={w}, "
                         f"chunk={kc})")
    tiles, cluster = -(-rows // FUSED_BM), w // FUSED_SLAB
    piece = 64 * cluster
    pieces = [(p0, min(piece, kc - p0)) for p0 in range(0, kc, piece)]
    smem = FUSED_STAGES * FUSED_STAGE_BYTES + FUSED_BM * 512 * 2 + (2 * FUSED_STAGES + 3) * 8 \
        + 1024
    # each block of a piece reads all of h for its 64 columns of t
    h_reads = chunks * sum(pw // 64 for _, pw in pieces) * FUSED_BM * w * 2
    return {"tiles": tiles, "cluster": cluster, "chunks": chunks, "kc": kc, "pieces": pieces,
            "smem_bytes": smem, "weight_l2_bytes": tiles * 2 * 2 * w * inter,
            "l2_bytes": tiles * (2 * 2 * w * inter + h_reads)}


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
    _build.refuse_grad("mlp_sublayer_fused", x, ln_scale, ln_bias, w_in, b_in, w_out, b_out)
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
    plan = fused_plan(b * n, w, inter, k_chunks)
    y = torch.empty_like(x)
    h = torch.empty_like(x)  # LN(x), written by the kernel's prologue
    lib = _build.load_library()
    status = lib.agk_vit_mlp_fused_bf16(
        *(a.data_ptr() for a in args), y.data_ptr(), h.data_ptr(), b * n, w, inter,
        plan["chunks"], ACTS[act],
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
