"""The pre-LN MLP sublayer of CLIP ViT-L/14 (quick_gelu) and HuBERT-large
(erf gelu) as two products: x + fc2(act(fc1(LN(x)))).

Port of affectgpt_tpu/ops/vit_mlp_pallas.py (`mlp_sublayer`, `apply`,
`apply_hubert`). On CUDA tensors the kernels of csrc/vit_mlp.cu run (three
launches in one call: LayerNorm, fc1 + bias + act into a bf16 [rows, I]
scratch, fc2 + bias + residual, the two products on the wgmma + TMA GEMM of
csrc/vit_gemm_wgmma.cuh as `mlp_plan` lays them out) or the wrapper raises;
on CPU tensors
`mlp_sublayer_reference`, the plain PyTorch version, which is also the oracle
the kernels are checked against on the card.

The plain version's erf gelu is the exact one (torch.erf). The kernel, like
the TPU kernel, builds erf from the Abramowitz-Stegun rational, whose
absolute error is at most 1.5e-7 (Mosaic lowers no erf), with the fast
exponential and reciprocal, as it computes quick_gelu's sigmoid: below the
bf16 rounding of t but for a rare ulp.
"""

from __future__ import annotations

import torch

from affectgpt_tpu_torch.ops import _build
from affectgpt_tpu_torch.ops.vit_sublayer import dot_f32, layernorm_rounded

ACTS = {"quick_gelu": 1, "gelu": 2}  # the kernels' activation codes

# Images per fc1 → fc2 pair in `apply` and `apply_hubert` (JAX's
# CLIP_MLP_CHUNK default), used only when the [b, n, I] intermediate alone
# would pass CHUNK_ABOVE_BYTES (JAX's CLIP_MLP_CHUNK_ABOVE_GB default, 4 GiB).
IMAGE_CHUNK = 512
CHUNK_ABOVE_BYTES = 4 * 2**30


def activation(t, act: str):
    """quick_gelu (CLIP) or the erf gelu (HuBERT) of an f32 tensor."""
    if act == "quick_gelu":
        return t * torch.sigmoid(1.702 * t)
    if act == "gelu":
        return 0.5 * t * (1.0 + torch.erf(t * 0.7071067811865476))
    raise ValueError(f"unknown activation {act!r}")


def mlp_sublayer_reference(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out,
                           eps: float = 1e-5, act: str = "quick_gelu"):
    """Plain version with the TPU kernels' rounding points: h = LN(x)
    rounded; t = act(h·W_in + b_in) in f32, rounded; y = t·W_out + b_out + x
    in f32, rounded once."""
    h = layernorm_rounded(x, ln_scale, ln_bias, eps)
    t = activation(dot_f32(h, w_in) + b_in.float(), act).to(x.dtype)
    return (dot_f32(t, w_out) + b_out.float() + x.float()).to(x.dtype)


# The GEMM's tile (csrc/vit_gemm_wgmma.cuh): 128 rows x 256 columns, 64 k a
# stage, a ring of four stages beside the staging memory of half a tile's
# result; persistent blocks, one per SM, in clusters of two that share w's
# tiles.
GEMM_BM, GEMM_BN, GEMM_BK, GEMM_STAGES, GEMM_CLUSTER = 128, 256, 64, 4, 2


def gemm_plan(m: int, n: int, k: int, sm_count: int) -> dict:
    """The launch plan of one product y [m, n] = a [m, k] @ w [k, n] on the
    wgmma GEMM: the tile; the cluster (GEMM_CLUSTER row tiles sharing each
    of w's tiles, where there is more than one row tile); the column tiles
    and the row tiles, rounded up to whole clusters (tiles past m compute
    zeros and store nothing); the persistent grid (whole clusters, at most
    one block per SM) with each block's tiles (`_place`); the k steps (k
    padded to a whole stage with TMA's zeros); the shared memory; and the
    bytes its blocks read from L2 (a once per column tile, w once per
    cluster)."""
    n_tiles, m_tiles = -(-n // GEMM_BN), -(-m // GEMM_BM)
    cluster = GEMM_CLUSTER if m_tiles > 1 else 1
    m_tiles = -(-m_tiles // cluster) * cluster
    units = n_tiles * m_tiles // cluster
    stage = (GEMM_BM + GEMM_BN) * GEMM_BK * 2
    plan = {"tile": (GEMM_BM, GEMM_BN), "cluster": cluster, "stage_k": GEMM_BK,
            "stages": GEMM_STAGES, "n_tiles": n_tiles, "m_tiles": m_tiles,
            "k_steps": -(-k // GEMM_BK),
            # the ring, half a tile's result and the bias per warpgroup, barriers
            "smem_bytes": GEMM_STAGES * stage + GEMM_BM * GEMM_BN + 2 * GEMM_BN * 2
            + (2 * GEMM_STAGES + 2) * 8 + 1024,
            "l2_bytes": 2 * (n_tiles * m * k + m_tiles // cluster * k * n)}
    return _place(plan, min(sm_count // cluster, units) * cluster)


def _place(plan: dict, blocks: int) -> dict:
    """`plan` on a grid of `blocks` blocks: the grid and each block's tiles
    (column tile, row tile) in its order. A unit is a column tile and a
    cluster's row tiles; cluster c takes units c, c + clusters, ..., unit u
    the column tile u % n_tiles and its blocks the row tiles cluster *
    (u // n_tiles) + rank."""
    n_tiles, cluster = plan["n_tiles"], plan["cluster"]
    units, clusters = n_tiles * plan["m_tiles"] // cluster, blocks // cluster
    plan["grid"] = (blocks,)
    plan["tiles"] = [[(u % n_tiles, cluster * (u // n_tiles) + b % cluster)
                      for u in range(b // cluster, units, clusters)] for b in range(blocks)]
    return plan


def mlp_plan(rows: int, w: int, inter: int, sm_count: int) -> dict:
    """The two products' plans (fc1: [rows, w] @ [w, I], fc2: [rows, I] @
    [I, w]) on one persistent grid; raises on what the kernels do not take:
    the LayerNorm pass holds a row of up to 2048 values in 8-value pieces,
    and TMA needs 16-byte row strides, which width % 32 and I % 32 give."""
    if w % 32 or w > 2048 or inter % 32:
        raise ValueError(f"mlp_sublayer kernel takes width % 32 == 0 up to 2048 and "
                         f"intermediate % 32 == 0 (width={w}, intermediate={inter})")
    fc1, fc2 = gemm_plan(rows, inter, w, sm_count), gemm_plan(rows, w, inter, sm_count)
    blocks = max(fc1["grid"][0], fc2["grid"][0])  # a block with no tile returns
    return {"fc1": _place(fc1, blocks), "fc2": _place(fc2, blocks), "blocks": blocks}


def _launch(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, eps: float, act: str,
            variant: int = 0):
    """The three launches of csrc/vit_mlp.cu. variant 0 is the kernels; 1
    drops the GEMMs' products (a diagnostic of their loads, its result
    wrong) and 2 runs the previous mma.sync GEMMs, both for chip_smoke.py's
    timings only."""
    b, n, w = x.shape
    inter = w_in.shape[1]
    args = (x, ln_scale, ln_bias, w_in, b_in, w_out, b_out)
    _build.check_bf16_operands("mlp_sublayer", x.device, zip(
        args, ((b, n, w), (w,), (w,), (w, inter), (inter,), (inter, w), (w,))))
    plan = mlp_plan(b * n, w, inter,
                    torch.cuda.get_device_properties(x.device).multi_processor_count)
    fc1, fc2, blocks = plan["fc1"], plan["fc2"], plan["blocks"]
    h = torch.empty_like(x)
    t = torch.empty((b, n, inter), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    ints = torch.tensor([fc1["m_tiles"], fc1["n_tiles"], fc2["n_tiles"], blocks, fc1["cluster"]],
                        dtype=torch.int32)  # the C entry's Plan
    lib = _build.load_library()
    status = lib.agk_vit_mlp_bf16(
        *(a.data_ptr() for a in args), h.data_ptr(), t.data_ptr(), y.data_ptr(), ints.data_ptr(),
        b * n, w, inter, ACTS[act], variant, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(status, "mlp_sublayer")
    return y


def mlp_sublayer(x, ln_scale, ln_bias, w_in, b_in, w_out, b_out, eps: float = 1e-5,
                 act: str = "quick_gelu", image_chunk: int = 0):
    """x [b, n, w] → x + fc2(act(fc1(LN(x)))) in x.dtype. w_in [w, I],
    w_out [I, w] in the `[in, out]` layout. image_chunk > 0 runs the pair
    over groups of images (the largest divisor of b not above image_chunk),
    bounding the [chunk, n, I] intermediate; rows are independent, so the
    result is the unchunked one."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    args = (ln_scale, ln_bias, w_in, b_in, w_out, b_out)
    if x.device.type == "cpu":
        run = lambda xc: mlp_sublayer_reference(xc, *args, eps=eps, act=act)  # noqa: E731
    elif x.device.type == "cuda":
        run = lambda xc: _launch(xc, *args, eps=eps, act=act)  # noqa: E731
    else:
        raise ValueError(f"mlp_sublayer: no kernel for device {x.device}")
    b = x.shape[0]
    chunk = b
    if image_chunk and b > image_chunk:
        chunk = image_chunk
        while b % chunk:
            chunk -= 1
        chunk = chunk if chunk > 1 else b
    y = torch.cat([run(x[i:i + chunk]) for i in range(0, b, chunk)]) if chunk < b else run(x)
    if x.device.type == "cuda":
        mlp_sublayer.launches += 1
    return y


mlp_sublayer.launches = 0  # wrapper calls that launched the kernels since the last reset


def image_chunk_for(x, inter: int) -> int:
    """Images per fc1 → fc2 pair: IMAGE_CHUNK when the [b, n, I]
    intermediate would pass CHUNK_ABOVE_BYTES, else 0 (unchunked)."""
    b, n, _ = x.shape
    return IMAGE_CHUNK if b * n * inter * x.element_size() > CHUNK_ABOVE_BYTES else 0


def apply(block: dict, x, eps: float):
    """The MLP half of models/clip_vit.py _apply_block (quick_gelu)."""
    return mlp_sublayer(
        x, block["ln2"]["scale"], block["ln2"]["bias"],
        block["mlp_in"]["w"], block["mlp_in"]["b"],
        block["mlp_out"]["w"], block["mlp_out"]["b"],
        eps=eps, image_chunk=image_chunk_for(x, block["mlp_in"]["w"].shape[1]),
    )


def apply_hubert(layer: dict, x, eps: float):
    """The FFN half of a models/hubert.py layer (ffn_ln, ffn_in, erf gelu,
    ffn_out, residual)."""
    return mlp_sublayer(
        x, layer["ffn_ln"]["scale"], layer["ffn_ln"]["bias"],
        layer["ffn_in"]["w"], layer["ffn_in"]["b"],
        layer["ffn_out"]["w"], layer["ffn_out"]["b"],
        eps=eps, act="gelu", image_chunk=image_chunk_for(x, layer["ffn_in"]["w"].shape[1]),
    )
