"""Qwen2/2.5-family causal decoder with LoRA, in PyTorch.

Port of affectgpt_tpu/models/qwen2.py, serving and training: dense weights
in the split q/k/v layout or the fused serving layouts (`fuse_qkv_gateup`:
`qkv_proj`, and `gateup_proj` unless gate/up stay split), bf16 or quantized
(`quantize_params`, `init_quantized_params`: int8 `w_q` or int4 `w_q4`
leaves with their `scales`), LoRA either as a parallel branch or merged into
the weights (`merge_lora`), a dense KV cache, and the kernels of
`affectgpt_tpu_torch.ops`.

Parameters are the JAX package's tree as nested dicts of tensors, with the
same keys and the JAX `[in, out]` dense layout, so `models.convert.from_jax`
needs no transposes and both decode kernels read the weights as stored.

The KV cache keeps the JAX layout `[b, kv_heads, max_len, head_dim]` and is
written IN PLACE by `forward`; the list it returns is the one passed in. An
int8 cache (`init_cache(dtype=torch.int8)`) adds f32 per-row scales
`k_scale`/`v_scale` [b, kv_heads, max_len] and quantizes on write
(`_quantize_kv`, bit for bit JAX's). `cache_index` is the shared column of a
left-packed batch (an int) or, for a decode step, one column per row (a [b]
tensor, the continuous-batching server).

Decode dispatch follows the JAX rule (qwen2.py:562-678, :761-766): on a
decode step (a cache, t == 1, merged LoRA), the pre-attention rmsnorm, q/k/v
projections, bias and RoPE go through `ops.decode_qkv` when q/k/v are split
bf16 leaves ("w") and DECODE_QKV leaves it on, and the post-attention rmsnorm and MLP go through the
kernel DECODE_MLP chooses (below); otherwise the plain rmsnorm runs and each
projection goes through `_lora_dense`. `_decode_qkv_fused` and
`_decode_mlp_fused` hold that rule for this module and the paged engine
alike. A quantized leaf there takes the matmul kernels of `ops.quant`,
routed by M (rows of x) as that module says. The attention itself follows
the JAX switches `DECODE_ATTN_O`, `DECODE_ATTENTION` and `PREFILL_ATTENTION`
(below); by default it is the plain chain, and an int8 cache always takes
it. The kernel wrappers launch their CUDA kernels for CUDA tensors (or
raise) and run their plain versions for CPU tensors. Everything else is
plain torch, mirroring the JAX default chain.

`cache_index` may also be a [b] tensor on a t > 1 forward: the
speculative verify of `inference.generate.generate_speculative`, each row's
t rows at its own columns.

Tensor parallelism: a config whose `layout` is set (`parallel.mesh.
shard_config`) describes one rank's shard of the decoder (its query heads,
the kv heads they read, its columns of I) over the tp group of that layout,
and the params are that rank's slices (`parallel.mesh.shard_params`). Each
rank runs the same dispatch on its shard, so the decode kernels run at the
shard's shapes; o_proj and down_proj give partial sums, which one
all-reduce each over the tp group sums before the residual is added, once
(the three kernels that fuse `+ residual` run without it there: the
`residual=False` mode of `decode_attn_o`, `decode_mlp_bf16` and
`decode_mlp`). A row-parallel LoRA branch is linear, so a rank adds (x_r @
a[rows_r]) @ b to its partial. `_logits` gathers the vocabulary-parallel
lm_head's (or the tied table's rows') logits to the whole vocabulary. The
KV cache holds the rank's kv heads.

Training under tp: where autograd records, the collectives are the
differentiable ones of `parallel.mesh`. The normed input of q/k/v and of
gate/up passes `copy_to_tp` (f: its gradient, a partial sum on each rank,
is summed over the ranks), the row-parallel sums are `reduce_from_tp` (g),
the logits are gathered by `gather_from_tp`, and
`fused_cross_entropy_loss` streams the rank's vocabulary columns and
combines the ranks' online logsumexps. The LoRA tree stays whole: the
gradient a rank gives a leaf is its slice or a partial sum, which the
training step sums over the tp group. LoRA dropout draws a row-parallel
branch's mask at the whole input's shape and takes the rank's columns, so
tp ranks drop what tp = 1 drops at the same key.

Training (JAX qwen2.py:978-1208): `forward(remat=, dropout_rng=,
return_hidden=)` with per-layer activation checkpointing and LoRA dropout,
and the causal-LM losses `cross_entropy_loss` and
`fused_cross_entropy_loss`. The training forward takes no cache, so it
reaches none of the decode or prefill kernels.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.utils import checkpoint as torch_checkpoint

from affectgpt_tpu_torch.models import nn
from affectgpt_tpu_torch.ops import quant
from affectgpt_tpu_torch.ops.decode_attention import decode_attention
from affectgpt_tpu_torch.ops.decode_attn_o import decode_attn_o
from affectgpt_tpu_torch.ops.decode_mlp import decode_mlp
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv
from affectgpt_tpu_torch.ops.prefill_attention import prefill_attention
from affectgpt_tpu_torch.parallel import mesh

# The attention switches of the JAX decoder (qwen2.py:481, :511, :524), read
# at each call. "xla", the default, is the plain attention chain. The kernel
# values keep their JAX names so that each switch maps straight to its
# counterpart; on the port "pallas" and "flash" mean the hand-written CUDA
# kernel. The JAX package's TPU-only gates (the 12 MB resident-W_o gate of
# "auto", the backend checks, the t % 32, t >= 64 and head_dim limits of the
# flash op) are not carried: each kernel's wrapper checks its own limits and
# raises.
# DECODE_ATTN_O="pallas": on the decode step whose q/k/v came from
# decode_qkv and o_proj is a bf16 leaf, attention → o_proj → + residual in
# `ops.decode_attn_o`.
DECODE_ATTN_O = "xla"
# DECODE_ATTENTION="pallas": otherwise on a decode step, attention in
# `ops.decode_attention`; o_proj stays a plain product.
DECODE_ATTENTION = "xla"
# PREFILL_ATTENTION="flash": on the cache-populating forward (t > 1),
# attention over the prompt's own k/v in `ops.prefill_attention`.
PREFILL_ATTENTION = "xla"
# The decode-MLP switch of the JAX decoder (qwen2.py:490), read at each call:
# "auto" fuses rmsnorm -> gate/up -> silu*up -> down -> residual on the bf16
# split layout (`ops.decode_mlp_bf16`); "pallas" also sends the int8 split
# layout to `ops.decode_mlp`; "xla" turns both off. JAX's TPU gates (b % 8,
# fits_vmem, intermediate % 512, the backend) are not carried.
DECODE_MLP = "auto"
# The decode-QKV switch of the JAX decoder (qwen2.py:497), read at each call:
# "auto" and "pallas" send a split bf16 q/k/v layer with merged LoRA to
# `ops.decode_qkv` (rmsnorm -> q/k/v + bias -> RoPE in one kernel); any other
# value ("xla") takes the per-projection route. JAX's TPU-only gates (the
# 12 MB resident-weight limit of "auto", b % 8, the backend) are not carried.
DECODE_QKV = "auto"
# JAX's opt-in AFFECTGPT_DROPOUT_VJP (qwen2.py:390): True sends each
# dropped LoRA branch through `_LoraDropBranch`, which regenerates its mask in
# the backward instead of keeping the dropped copy of x alive.
DROPOUT_VJP = False


@dataclass(frozen=True)
class QwenConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    qkv_bias: bool = True
    lora_r: int = 16
    lora_alpha: float = 32.0
    lora_dropout: float = 0.05  # train-only; the serving path never applies it
    # not a field: a ShardConfig (a tensor-parallel rank's shard) sets it
    layout = None

    @classmethod
    def qwen25_7b(cls, vocab_size: int = 152064, lora_r: int = 16):
        """Qwen2.5-7B-Instruct geometry (the reference's production LLM)."""
        return cls(vocab_size=vocab_size, lora_r=lora_r)

    @classmethod
    def llama2_7b(cls, vocab_size: int = 32000, lora_r: int = 16):
        return cls(
            vocab_size=vocab_size, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
            rope_theta=10_000.0, rms_eps=1e-5, qkv_bias=False, lora_r=lora_r,
        )

    @classmethod
    def baichuan2_7b(cls, vocab_size: int = 125696, lora_r: int = 16):
        return cls(
            vocab_size=vocab_size, hidden_size=4096, intermediate_size=11008,
            num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
            rope_theta=10_000.0, rms_eps=1e-6, qkv_bias=False, lora_r=lora_r,
        )

    @classmethod
    def tiny(cls, vocab_size: int = 300, lora_r: int = 2):
        return cls(
            vocab_size=vocab_size, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
            rope_theta=10_000.0, lora_r=lora_r, lora_alpha=4.0,
        )


@dataclass(frozen=True)
class ShardConfig(QwenConfig):
    """One tensor-parallel rank's decoder geometry (`parallel.mesh.
    shard_config`): its query heads, the kv heads they read and its columns
    of I, with the layout whose tp group the decoder reduces over."""

    layout: Optional[object] = field(default=None, compare=False, repr=False)


_LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
_QKV = ("q_proj", "k_proj", "v_proj")


def _dims(cfg: QwenConfig) -> dict:
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    h, inter = cfg.hidden_size, cfg.intermediate_size
    return {
        "q_proj": (h, nq), "k_proj": (h, nkv), "v_proj": (h, nkv), "o_proj": (nq, h),
        "gate_proj": (h, inter), "up_proj": (h, inter), "down_proj": (inter, h),
    }


def init_params(generator: torch.Generator, cfg: QwenConfig, dtype=torch.bfloat16) -> dict:
    """Random frozen base parameters on the generator's device (stand-in for
    a converted checkpoint; same shapes and init scale as the JAX package)."""
    dims = _dims(cfg)
    dev = generator.device
    layers = []
    for _ in range(cfg.num_layers):
        layer = {}
        for name in _LORA_TARGETS:
            init = nn.dense_init if cfg.qkv_bias and name in ("q_proj", "k_proj", "v_proj") \
                else nn.dense_nobias_init
            layer[name] = init(generator, *dims[name], dtype=dtype)
        layer["input_ln"] = nn.rmsnorm_init(cfg.hidden_size, dtype=dtype, device=dev)
        layer["post_attn_ln"] = nn.rmsnorm_init(cfg.hidden_size, dtype=dtype, device=dev)
        layers.append(layer)
    params = {
        "embed_tokens": nn.embedding_init(generator, cfg.vocab_size, cfg.hidden_size, dtype=dtype),
        "layers": layers,
        "final_ln": nn.rmsnorm_init(cfg.hidden_size, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = nn.dense_nobias_init(
            generator, cfg.hidden_size, cfg.vocab_size, dtype=dtype)
    return params


def init_lora(generator: torch.Generator, cfg: QwenConfig, dtype=torch.float32) -> dict:
    """LoRA adapters for every layer's 7 target matmuls: A ~ N(0, 1/in),
    B = 0 (the PEFT start, an identity adapter)."""
    dims = _dims(cfg)
    layers = []
    for _ in range(cfg.num_layers):
        layer = {}
        for name in _LORA_TARGETS:
            in_dim, out_dim = dims[name]
            layer[name] = {
                "a": nn.normal(generator, (in_dim, cfg.lora_r), in_dim ** -0.5, dtype),
                "b": torch.zeros((cfg.lora_r, out_dim), dtype=dtype, device=generator.device),
            }
        layers.append(layer)
    return {"layers": layers}


def merge_lora(params: dict, lora: dict, cfg: QwenConfig) -> dict:
    """Fold LoRA into the base weights for serving: W' = W + (α/r)·A·B,
    computed in f32 and stored in W's dtype. On a tensor-parallel shard each
    W takes the rank's slice of a whole LoRA (`_rank_lora`). Returns a new
    tree; unchanged leaves are shared with `params`."""
    scaling = cfg.lora_alpha / cfg.lora_r
    layers = []
    for layer, lora_layer in zip(params["layers"], lora["layers"]):
        merged = dict(layer)
        for name in _LORA_TARGETS:
            if name not in lora_layer:
                continue
            if "w" not in layer[name]:
                raise ValueError("merge_lora needs unquantized weights: merge, then quantize")
            w = layer[name]["w"]
            leaf = _rank_lora(lora_layer[name], name, cfg, *w.shape)
            ab = leaf["a"].float() @ leaf["b"].float()
            merged[name] = {**layer[name], "w": (w.float() + scaling * ab).to(w.dtype)}
        layers.append(merged)
    return {**params, "layers": layers}


def fuse_qkv_gateup(params: dict, cfg: QwenConfig, fuse_gateup: bool = True) -> dict:
    """Serving layout: q/k/v concatenated into one [h, nq + 2·nkv] `qkv_proj`
    and, with fuse_gateup, gate/up into one [h, 2·I] `gateup_proj`. The same
    math with fewer matmuls per decode step. Apply after merge_lora and
    before quantize_params (per-channel scales commute with the concat).
    Returns a new tree; unchanged leaves are shared with `params`."""
    layers = []
    for layer in params["layers"]:
        if "w" not in layer["q_proj"]:
            raise ValueError("fuse_qkv_gateup expects unquantized weights")
        drop = _QKV + (("gate_proj", "up_proj") if fuse_gateup else ())
        fused = {k: v for k, v in layer.items() if k not in drop}
        qkv = {"w": torch.cat([layer[n]["w"] for n in _QKV], dim=1)}
        if "b" in layer["q_proj"]:
            qkv["b"] = torch.cat([layer[n]["b"] for n in _QKV])
        fused["qkv_proj"] = qkv
        if fuse_gateup:
            fused["gateup_proj"] = {
                "w": torch.cat([layer["gate_proj"]["w"], layer["up_proj"]["w"]], dim=1)}
        layers.append(fused)
    return {**params, "layers": layers}


def quantize_params(params: dict, bits: int = 8, cfg: Optional[QwenConfig] = None) -> dict:
    """Quantize the decoder's projection weights and the lm_head for serving
    (bits=8 per-channel int8, bits=4 group-128 int4); embeddings and norms
    stay as they are. cfg: a tensor-parallel rank's config
    (`parallel.mesh.shard_config`) when `params` is its shard; the shard then
    quantizes to the rank's slice of the whole tree's quantization."""
    out = dict(params)
    if _tp(cfg) is not None:
        out["layers"] = [_quantize_shard_layer(layer, bits, cfg) for layer in params["layers"]]
    else:
        out["layers"] = [quant.quantize_dense_tree(layer, bits=bits)
                         for layer in params["layers"]]
    if "lm_head" in params:
        out["lm_head"] = quant.quantize_dense_tree(params["lm_head"], bits=bits)
    return out


def _quantize_shard_layer(layer: dict, bits: int, cfg: QwenConfig) -> dict:
    """One layer of a tensor-parallel shard quantized as `mesh.shard_params`
    slices the whole layer's quantization: column-parallel leaves alone
    (their scales are their columns'); a row-parallel int8 leaf with the
    columns' absmax over the whole K (the ranks' maxima reduced); a
    row-parallel int4 leaf on its own rows (its groups are its own), which
    must keep the kernels' K % 256 where the whole K does."""
    layout = cfg.layout
    out = {}
    for name, leaf in layer.items():
        if name not in ("o_proj", "down_proj") or "w" not in leaf:
            out[name] = quant.quantize_dense_tree(leaf, bits=bits) if isinstance(leaf, dict) \
                and "w" in leaf else leaf
            continue
        w = leaf["w"]
        k = w.shape[0]
        whole_int4 = bits == 4 and (k * layout.tp) % (2 * quant.INT4_GROUP) == 0
        if whole_int4:
            if k % (2 * quant.INT4_GROUP):
                raise ValueError(f"{name}: a rank's int4 row-parallel K = {k} does not keep the "
                                 f"int4 kernels' K % {2 * quant.INT4_GROUP} == 0 at "
                                 f"tp={layout.tp}; use fewer tp ranks or int8")
            w_p, scales = quant.quantize_int4_grouped(w)
            out[name] = {"w_q4": w_p, "scales": scales}
        else:
            absmax = mesh.tp_all_reduce_max(w.float().abs().amax(dim=0, keepdim=True), layout)
            w_q, scales = quant.quantize_per_channel(w, absmax=absmax)
            out[name] = {"w_q": w_q, "scales": scales}
    return out


def init_quantized_params(generator: torch.Generator, cfg: QwenConfig, bits: int = 4,
                          dtype=torch.bfloat16, fused=False) -> dict:
    """Random decoder weights made directly in quantized form, on the
    generator's device, with the JAX package's value distribution: int4
    nibbles uniform in [-7, 7] packed as quantize_int4_grouped packs them,
    scales 3σ/7 (σ = K^-1/2); int8 values in [-127, 127], scales 3σ/127;
    int8 for leaves whose K is not a multiple of 256 at bits=4. fused=True
    gives the qkv + gateup layout, fused="qkv" keeps gate/up split."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    dev = generator.device

    def randint(low, high, shape):
        return torch.randint(low, high, shape, generator=generator, device=dev,
                             dtype=torch.int32)

    def qdense(k, n, bias):
        sigma = 1.0 / float(k) ** 0.5
        if bits == 4 and k % (2 * quant.INT4_GROUP) == 0:
            lo, hi = randint(-7, 8, (k // 2, n)), randint(-7, 8, (k // 2, n))
            out = {"w_q4": ((hi << 4) | (lo & 0xF)).to(torch.int8),
                   "scales": torch.full((k // quant.INT4_GROUP, n), 3.0 * sigma / 7.0,
                                        dtype=torch.float32, device=dev)}
        else:
            out = {"w_q": randint(-127, 128, (k, n)).to(torch.int8),
                   "scales": torch.full((1, n), 3.0 * sigma / 127.0, dtype=torch.float32,
                                        device=dev)}
        if bias:
            out["b"] = torch.zeros((n,), dtype=dtype, device=dev)
        return out

    h, inter = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        if fused:
            layer = {"qkv_proj": qdense(h, nq + 2 * nkv, cfg.qkv_bias),
                     "o_proj": qdense(nq, h, False), "down_proj": qdense(inter, h, False)}
            if fused == "qkv":
                layer["gate_proj"] = qdense(h, inter, False)
                layer["up_proj"] = qdense(h, inter, False)
            else:
                layer["gateup_proj"] = qdense(h, 2 * inter, False)
        else:
            layer = {"q_proj": qdense(h, nq, cfg.qkv_bias), "k_proj": qdense(h, nkv, cfg.qkv_bias),
                     "v_proj": qdense(h, nkv, cfg.qkv_bias), "o_proj": qdense(nq, h, False),
                     "gate_proj": qdense(h, inter, False), "up_proj": qdense(h, inter, False),
                     "down_proj": qdense(inter, h, False)}
        layer["input_ln"] = nn.rmsnorm_init(h, dtype=dtype, device=dev)
        layer["post_attn_ln"] = nn.rmsnorm_init(h, dtype=dtype, device=dev)
        layers.append(layer)
    params = {
        "embed_tokens": nn.embedding_init(generator, cfg.vocab_size, h, dtype=dtype),
        "layers": layers,
        "final_ln": nn.rmsnorm_init(h, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = qdense(h, cfg.vocab_size, False)
    return params


def _tp(cfg: Optional[QwenConfig]):
    """The layout of a tensor-parallel shard's config, else None."""
    layout = None if cfg is None else cfg.layout
    return layout if layout is not None and layout.tp > 1 else None


def _tp_sum(y: torch.Tensor, cfg: QwenConfig) -> torch.Tensor:
    """A row-parallel product's partial sums y summed over the tp ranks (g
    where autograd records y, else the in-place all-reduce)."""
    return mesh.reduce_from_tp(y, _tp(cfg))


def _base_shape(leaf: dict) -> tuple:
    """(K, N) of a dense leaf in any of its stored forms."""
    if "w_q4" in leaf:
        return 2 * leaf["w_q4"].shape[0], leaf["w_q4"].shape[1]
    return tuple((leaf["w"] if "w" in leaf else leaf["w_q"]).shape)


def _rank_lora(leaf: dict, name: str, cfg: QwenConfig, k: int, n: int) -> dict:
    """The LoRA leaf {a [K, r], b [r, N]} of projection `name` as a
    tensor-parallel rank applies it to its base of [k, n]: a whole `a` at the
    rank's rows (row-parallel: a partial sum of a linear branch), a whole
    `b` at the rank's output columns (column-parallel, the kv heads' for
    k/v); the slices `mesh.shard_params` makes pass as they are."""
    layout = _tp(cfg)
    if layout is None:
        return leaf
    a, b = leaf["a"], leaf["b"]
    r = layout.tp_rank
    if a.shape[0] != k:
        a = a[r * k:(r + 1) * k]
    if b.shape[1] != n:
        whole = dataclasses.replace(cfg, num_heads=cfg.num_heads * layout.tp,
                                    num_kv_heads=b.shape[1] // cfg.head_dim, layout=None)
        start, stop = mesh.axis_range("col", name, b.shape[1], whole, layout.tp, r)
        b = b[:, start:stop]
    return {**leaf, "a": a, "b": b}


def _lora_getter(lora_layer, cfg: QwenConfig, layer: dict):
    """name → the projection's LoRA leaf as this rank applies it
    (`_rank_lora`), or None without LoRA."""
    if lora_layer is None:
        return lambda n: None
    if _tp(cfg) is None:
        return lambda n: lora_layer[n]
    return lambda n: _rank_lora(lora_layer[n], n, cfg, *_base_shape(layer[n]))


def _quantized_matmul(x2d: torch.Tensor, base: dict) -> torch.Tensor:
    """x2d [M, K] against a quantized leaf, routed by M as the JAX TPU route
    does (qwen2.py:401-447) without its Mosaic gates: see `ops.quant`."""
    m = x2d.shape[0]
    if "w_q4" in base:
        w, s = base["w_q4"], base["scales"]
        if m > quant.PALLAS_DEQUANT_MAX_M:
            return quant.int4_matmul_xla(x2d, w, s)
        kernel = quant.int4_matmul_smallm if m < quant.PALLAS_INT4_MIN_M else quant.int4_matmul
        return kernel(x2d, w, s)
    w, s = base["w_q"], base["scales"]
    if quant.MATMUL_MODE == "w8a8":
        return quant.int8_matmul_w8a8(x2d, w, s)
    if m > quant.PALLAS_DEQUANT_MAX_M:
        return quant.int8_matmul_xla(x2d, w, s)
    return quant.int8_matmul(x2d, w, s)


class _LoraDropBranch(torch.autograd.Function):
    """B(A(dropout(x))) whose backward regenerates the dropout mask from its
    key (JAX `_lora_drop_branch`, qwen2.py:339-393): what it keeps for the
    backward is x, a and b, all alive anyway. The forward is the plain
    branch's arithmetic; the gradients agree with autograd's up to the
    products' summation order."""

    @staticmethod
    def forward(ctx, x, a, b, key, rate, cols=None):
        ctx.key, ctx.rate, ctx.cols = key, rate, cols
        ctx.save_for_backward(x, a, b)
        xl = nn.dropout(key, rate, x, cols)
        z = nn.matmul_f32(xl, a.to(x.dtype))
        return nn.matmul_f32(z.to(x.dtype), b.to(x.dtype))

    @staticmethod
    def backward(ctx, g):
        x, a, b = ctx.saved_tensors
        keep = nn.dropout_keep(ctx.key, ctx.rate, x.shape, x.device, ctx.cols)
        inv = nn.keep_scale(ctx.rate, x.dtype)
        x2d = torch.where(keep, x / inv, 0.0).reshape(-1, x.shape[-1])
        ax, bx = a.to(x.dtype), b.to(x.dtype)
        g2d = g.reshape(-1, g.shape[-1]).to(x.dtype)
        z1 = nn.mm_f32(x2d, ax).to(x.dtype)
        db = nn.mm_f32(z1.t(), g2d).to(b.dtype)
        g1 = nn.mm_f32(g2d, bx.t()).to(x.dtype)
        da = nn.mm_f32(x2d.t(), g1).to(a.dtype)
        dxl = nn.mm_f32(g1, ax.t()).to(x.dtype).reshape(x.shape)
        return torch.where(keep, dxl / inv, 0.0), da, db, None, None, None


def _lora_dense(base, lora, x, scaling: float, has_bias: bool = True,
                drop=None) -> torch.Tensor:
    """x @ base (+ the LoRA branch · scaling) (+ bias). drop: optional (key,
    rate, cols) of `_lora_drop`, inverted dropout on the LoRA branch's
    input only, peft's train-mode `B(A(dropout(x)))`; the frozen product is
    never dropped."""
    if "w" in base:
        y = nn.matmul_f32(x, base["w"])
    else:
        x2d = x.reshape(-1, x.shape[-1]).contiguous()
        y = _quantized_matmul(x2d, base).reshape(*x.shape[:-1], -1)
        if lora is None and not (has_bias and "b" in base):
            return y  # already x.dtype: the f32 round trip below is the identity
        y = y.float()
    if lora is not None:
        if drop is not None and DROPOUT_VJP:
            z = _LoraDropBranch.apply(x, lora["a"], lora["b"], *drop)
        else:
            xl = x if drop is None else nn.dropout(drop[0], drop[1], x, drop[2])
            z = nn.matmul_f32(xl, lora["a"].to(x.dtype))
            z = nn.matmul_f32(z.to(x.dtype), lora["b"].to(x.dtype))
        y = y + scaling * z
    if has_bias and "b" in base:
        y = y + base["b"].float()
    return y.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, HF half-split convention. x [b, t, h, d],
    positions [b, t]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].to(torch.float32) * freqs  # [b, t, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _decode_qkv_fused(layer, lora_layer, cfg: QwenConfig, x2d: torch.Tensor,
                      pos1d: torch.Tensor):
    """The decode-QKV dispatch shared by the dense decode step and the paged
    engine (JAX qwen2.py:562-616): split bf16 q/k/v leaves ("w") and merged
    LoRA take `ops.decode_qkv`. x2d [b, hidden] is the RAW residual stream:
    the pre-attention rmsnorm (input_ln) runs in the kernel. Returns (q [b, heads, d], k [b, kv, d], v [b, kv, d]) with RoPE applied,
    or None when DECODE_QKV turns the kernel off or the layout does not
    qualify."""
    if (DECODE_QKV not in ("auto", "pallas") or lora_layer is not None
            or "qkv_proj" in layer or "w" not in layer["q_proj"]):
        return None
    b = x2d.shape[0]

    def bias(name):
        if "b" in layer[name]:
            return layer[name]["b"]
        return torch.zeros(layer[name]["w"].shape[1], dtype=x2d.dtype, device=x2d.device)

    q2, k2, v2 = decode_qkv(
        x2d, pos1d,
        layer["q_proj"]["w"], bias("q_proj"), layer["k_proj"]["w"], bias("k_proj"),
        layer["v_proj"]["w"], bias("v_proj"),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, theta=cfg.rope_theta,
        ln_scale=layer["input_ln"]["scale"], eps=cfg.rms_eps,
    )
    return (q2.reshape(b, cfg.num_heads, cfg.head_dim),
            k2.reshape(b, cfg.num_kv_heads, cfg.head_dim),
            v2.reshape(b, cfg.num_kv_heads, cfg.head_dim))


def _decode_mlp_fused(layer, lora_layer, cfg: QwenConfig, x: torch.Tensor):
    """The decode-MLP dispatch shared by the dense decode step and the paged
    engine (JAX qwen2.py:619-678), under DECODE_MLP: "auto" sends a split
    bf16 gate/up/down layer ("w" in gate_proj) with merged LoRA to
    `ops.decode_mlp_bf16`, "pallas" also a split int8 one ("w_q") to
    `ops.decode_mlp`, "xla" neither. x [b, 1, hidden] is the residual stream
    after attention; the post-attention rmsnorm runs in the kernel. Returns
    the new residual stream [b, 1, hidden], or None. On a tensor-parallel
    shard the kernel runs without its residual add: its partial sum is
    reduced over the tp ranks, then x is added once."""
    if DECODE_MLP == "xla" or lora_layer is not None:
        return None
    gate = layer.get("gate_proj", {})
    ln = layer["post_attn_ln"]["scale"]
    residual = _tp(cfg) is None
    if "w" in gate:
        y = decode_mlp_bf16(x[:, 0, :], ln, gate["w"], layer["up_proj"]["w"],
                            layer["down_proj"]["w"], eps=cfg.rms_eps, residual=residual)
    elif DECODE_MLP == "pallas" and "w_q" in gate:
        up, down = layer["up_proj"], layer["down_proj"]
        y = decode_mlp(x[:, 0, :], ln, gate["w_q"], gate["scales"], up["w_q"], up["scales"],
                       down["w_q"], down["scales"], eps=cfg.rms_eps, residual=residual)
    else:
        return None
    if not residual:
        y = x[:, 0, :] + _tp_sum(y, cfg)
    return y[:, None, :]


# stable per-projection dropout-key offsets (peft: one independent
# nn.Dropout per wrapped module), JAX qwen2.py:727-730
_LORA_DROP_IDS = {
    "q_proj": 0, "k_proj": 1, "v_proj": 2, "o_proj": 3,
    "gate_proj": 4, "up_proj": 5, "down_proj": 6,
}


def _lora_drop(drop_rng, cfg: QwenConfig, name: str):
    """(key, rate, cols) of projection `name`'s LoRA dropout in a layer whose
    key is drop_rng, or None in eval mode. cols (`nn.dropout_keep`) is set
    on a tensor-parallel shard's o_proj and down_proj: their input is the
    rank's columns of the whole one, and so is their mask."""
    if drop_rng is None or cfg.lora_dropout <= 0.0:
        return None
    cols, layout = None, _tp(cfg)
    if layout is not None and name in ("o_proj", "down_proj"):
        k = cfg.num_heads * cfg.head_dim if name == "o_proj" else cfg.intermediate_size
        cols = (k * layout.tp, k * layout.tp_rank)
    return nn.fold_in(drop_rng, _LORA_DROP_IDS[name]), cfg.lora_dropout, cols


def _direct(fn, *args):
    return fn(*args)


def _recomputed(fn, *args):
    """fn(*args) whose intermediates the backward recomputes from args:
    remat="dots"'s segments between the products."""
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                       preserve_rng_state=False)


def _project_qkv(layer, lora_layer, cfg: QwenConfig, x, positions, decode: bool,
                 drop_rng=None, seg=_direct):
    """q [b, t, heads, d], k and v [b, t, kv, d], RoPE applied, from the RAW
    residual stream x [b, t, hidden]; this function owns the pre-attention
    rmsnorm. decode: a decode step (a cache, t == 1), where the decode-QKV
    kernel is tried. drop_rng: the layer's LoRA-dropout key. seg runs the
    rmsnorm and RoPE (`_direct`, or `_recomputed` under remat="dots").
    Returns (q, k, v, fused), fused telling that the kernel ran (x was left
    un-normed for it)."""
    b, t, _ = x.shape
    heads, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    fused = _decode_qkv_fused(layer, lora_layer, cfg, x[:, 0, :], positions[:, 0]) \
        if decode else None
    if fused is not None:
        q, k, v = fused
        return q[:, None], k[:, None], v[:, None], True
    scaling = cfg.lora_alpha / cfg.lora_r
    lget = _lora_getter(lora_layer, cfg, layer)
    x = mesh.copy_to_tp(seg(nn.rmsnorm, layer["input_ln"], x, cfg.rms_eps), _tp(cfg))
    if "qkv_proj" in layer:  # fused serving layout: one matmul, split columns
        if lora_layer is not None:
            raise ValueError("the fused layout serves merged-LoRA weights")
        y = _lora_dense(layer["qkv_proj"], None, x, 0.0)
        q, k, v = y[..., :heads * d], y[..., heads * d:(heads + kv) * d], y[..., (heads + kv) * d:]
    else:
        q, k, v = (_lora_dense(layer[n], lget(n), x, scaling,
                               drop=_lora_drop(drop_rng, cfg, n)) for n in _QKV)
    q = seg(_rope, q.reshape(b, t, heads, d), positions, cfg.rope_theta)
    k = seg(_rope, k.reshape(b, t, kv, d), positions, cfg.rope_theta)
    return q, k, v.reshape(b, t, kv, d), False


def _quantize_kv(x: torch.Tensor):
    """Symmetric per-row int8 quantization over the trailing (head_dim) axis,
    bit for bit JAX's compiled qwen2.py:716-722: scale = amax x f32(1/127),
    values round(x / max(scale, 1e-20)), half to even. Returns (int8
    values, f32 scale [..., 1])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) * quant.INV_127
    return torch.round(xf / scale.clamp_min(1e-20)).to(torch.int8), scale


def _per_row(cache_index) -> bool:
    """cache_index is one column per row (a [b] tensor), not a shared one."""
    return torch.is_tensor(cache_index) and cache_index.ndim == 1


def _write_cache(cache: dict, k: torch.Tensor, v: torch.Tensor, cache_index) -> None:
    """Write k/v [b, kv, t, d] into a layer's cache IN PLACE (JAX returns a
    new cache): at the shared column `cache_index` (an int), or at a per-row
    column (a [b] tensor). For t == 1 (the continuous-batching server) that
    column is clamped into the cache, as JAX's dynamic_update_slice clamps;
    for t > 1 (speculative verify) row i's t rows go to columns
    cache_index[i] + [0, t), and those outside the cache are dropped, as
    JAX's one-hot rewrite (qwen2.py:818-845) drops them. An int8 cache
    stores the quantized rows and their scales [b, kv, T]. No step here
    waits for the device."""
    writes = {"k": k, "v": v}
    if cache["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        writes = {"k": kq, "v": vq, "k_scale": ks[..., 0], "v_scale": vs[..., 0]}
    b, _, t = k.shape[:3]
    if _per_row(cache_index):
        size = cache["k"].shape[2]
        start = cache_index.to(device=k.device, dtype=torch.long)
        if t == 1:
            rows = torch.arange(b, device=k.device)
            cols = start.clamp(0, size - 1)
            for name, new in writes.items():
                cache[name][rows, :, cols] = new[:, :, 0].to(cache[name].dtype)
            return
        # a write outside the cache goes to the nearest column instead,
        # carrying what that column ends up holding (the step that writes it,
        # else its old value), so every write to a column carries one value:
        # the drop needs no boolean mask, whose count the host would wait for
        # and a CUDA graph of the verify could not capture
        rows = torch.arange(b, device=k.device)[:, None].expand(b, t)
        cols = (start[:, None] + torch.arange(t, device=k.device)).clamp(0, size - 1)
        step = cols - start[:, None]  # the step that writes each target column
        written = (step >= 0) & (step < t)
        step = step.clamp(0, t - 1)
        for name, new in writes.items():
            buf = cache[name]
            val = new.transpose(1, 2)[rows, step].to(buf.dtype)  # [b, t, kv, ...]
            keep = written.view(b, t, *([1] * (val.ndim - 2)))
            buf[rows, :, cols] = torch.where(keep, val, buf[rows, :, cols])
    else:
        for name, new in writes.items():
            cache[name][:, :, cache_index:cache_index + t] = new


def _attention_core(q, k, v, mask, cfg: QwenConfig, dtype, k_scale=None, v_scale=None):
    """The plain attention chain: q [b, t, heads, d], k and v [b, kv, T, d],
    mask [b, 1, t, T] → [b, t, heads · d] in `dtype`.

    GQA without repeating K/V: fold the query-head groups into a 5-D
    product; scores and softmax in f32, probabilities rounded to v's dtype
    before PV, as the JAX chain does (qwen2.py:929-958). An int8 cache is
    read in q's dtype with its per-row scales k_scale / v_scale [b, kv, T]
    folded outside the contractions: scores x k_scale, probabilities x
    v_scale."""
    b, t = q.shape[:2]
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, t, cfg.num_kv_heads, groups, cfg.head_dim)
    if k_scale is not None:
        k, v = k.to(qg.dtype), v.to(qg.dtype)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), k.float())
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, None, :]
    logits = logits / float(cfg.head_dim) ** 0.5
    mask5 = mask[:, :, None, :, :]
    logits = logits.masked_fill(~mask5, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, None, :]
    probs = probs.to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs.float(), v.float())
    return out.to(dtype).reshape(b, t, cfg.num_heads * cfg.head_dim)


def _attention(layer, lora_layer, cfg: QwenConfig, x, positions, mask, cache, cache_index,
               drop_rng=None, seg=_direct):
    """x is the RAW residual stream; this function owns the pre-attention
    rmsnorm (folded into the decode-QKV kernel on the decode step).
    drop_rng: the layer's LoRA-dropout key (q/k/v, and o_proj on the plain
    chain, as JAX drops them). seg runs the segments between the products
    (`_project_qkv`'s, and the plain attention chain). Returns (out,
    residual_done): residual_done means that out already holds x +
    attention (decode_attn_o adds the residual itself), so the caller must
    not add x again. On a tensor-parallel shard out is the sum of the ranks'
    o_proj partials, and residual_done is False."""
    b, t, _ = x.shape
    scaling = cfg.lora_alpha / cfg.lora_r
    lget = _lora_getter(lora_layer, cfg, layer)
    q, k, v, fused = _project_qkv(layer, lora_layer, cfg, x, positions,
                                  decode=cache is not None and t == 1, drop_rng=drop_rng,
                                  seg=seg)
    k = k.transpose(1, 2)  # [b, kv, t, d]
    v = v.transpose(1, 2)
    groups = cfg.num_heads // cfg.num_kv_heads
    kv_quant = cache is not None and cache["k"].dtype == torch.int8
    if cache is not None:
        _write_cache(cache, k, v, cache_index)
        # an int8 cache takes none of the three attention kernels (JAX
        # qwen2.py:863, :889, :916): the plain chain reads the quantized cache
        # and a per-row index is a speculative verify, whose queries also
        # read the earlier cache columns (JAX qwen2.py:864, "prefill, not
        # verify")
        if PREFILL_ATTENTION == "flash" and t > 1 and not kv_quant \
                and not _per_row(cache_index):
            # the cache holds nothing beyond the prompt yet: attend over the
            # local k/v; pads are segment 0, tokens 1, read off the last
            # query row's mask (JAX qwen2.py:869-878, :698)
            out = prefill_attention(q, k.contiguous(), v.contiguous(), mask[:, 0, t - 1, :t])
            return _tp_sum(_lora_dense(layer["o_proj"], lget("o_proj"), out, scaling,
                                       has_bias=False), cfg), False
        k, v = cache["k"], cache["v"]
        # x is still the raw residual stream when decode_qkv ran
        attn_o = (DECODE_ATTN_O == "pallas" and fused and not kv_quant
                  and "w" in layer["o_proj"])
        if attn_o or DECODE_ATTENTION == "pallas" and t == 1 and not kv_quant:
            qd = q[:, 0].reshape(b, cfg.num_kv_heads, groups, cfg.head_dim)
            key_mask = mask[:, 0, 0, :]
            if attn_o and _tp(cfg) is not None:
                part = decode_attn_o(x[:, 0, :], qd, k, v, key_mask, layer["o_proj"]["w"],
                                     residual=False)
                return _tp_sum(part, cfg)[:, None, :], False
            if attn_o:
                x_new = decode_attn_o(x[:, 0, :], qd, k, v, key_mask, layer["o_proj"]["w"])
                return x_new[:, None, :], True
            out = decode_attention(qd, k, v, key_mask).reshape(
                b, 1, cfg.num_heads * cfg.head_dim)
            return _tp_sum(_lora_dense(layer["o_proj"], lget("o_proj"), out, scaling,
                                       has_bias=False), cfg), False

    scales = (cache["k_scale"], cache["v_scale"]) if kv_quant else (None, None)
    out = seg(_attention_core, q, k, v, mask, cfg, x.dtype, *scales)
    return _tp_sum(_lora_dense(layer["o_proj"], lget("o_proj"), out, scaling, has_bias=False,
                               drop=_lora_drop(drop_rng, cfg, "o_proj")), cfg), False


def _silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(gate) * up


def _mlp(layer, lora_layer, cfg: QwenConfig, x: torch.Tensor, drop_rng=None,
         seg=_direct) -> torch.Tensor:
    """The MLP of the post-attention-normed x; on a tensor-parallel shard
    the sum of the ranks' down_proj partials."""
    scaling = cfg.lora_alpha / cfg.lora_r
    lget = _lora_getter(lora_layer, cfg, layer)
    x = mesh.copy_to_tp(x, _tp(cfg))
    if "gateup_proj" in layer:
        if lora_layer is not None:
            raise ValueError("the fused layout serves merged-LoRA weights")
        gate, up = _lora_dense(layer["gateup_proj"], None, x, 0.0, has_bias=False).chunk(2, dim=-1)
    else:
        gate = _lora_dense(layer["gate_proj"], lget("gate_proj"), x, scaling, has_bias=False,
                           drop=_lora_drop(drop_rng, cfg, "gate_proj"))
        up = _lora_dense(layer["up_proj"], lget("up_proj"), x, scaling, has_bias=False,
                         drop=_lora_drop(drop_rng, cfg, "up_proj"))
    return _tp_sum(_lora_dense(layer["down_proj"], lget("down_proj"), seg(_silu_mul, gate, up),
                               scaling, has_bias=False,
                               drop=_lora_drop(drop_rng, cfg, "down_proj")), cfg)


def forward(
    params: dict,
    cfg: QwenConfig,
    inputs_embeds: torch.Tensor,
    attention_mask: torch.Tensor,
    lora: Optional[dict] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[list] = None,
    cache_index: Optional[int] = None,
    last_token_only: bool = False,
    remat=False,
    return_hidden: bool = False,
    dropout_rng=None,
):
    """Run the decoder stack.

    inputs_embeds [b, t, d]; attention_mask [b, t] validity without a cache
    (causal mask built here), or [b, t, max_len] bool key mask with one.
    cache_index: the int column the t new k/v rows are written at, or a [b]
    tensor of per-row columns (`_write_cache`).
    last_token_only: project only the final position through the lm_head.
    remat: True recomputes each layer in the backward
    (`torch.utils.checkpoint`, non-reentrant); "dots" keeps what the
    projections (LoRA's factors included) take and give, and recomputes
    each segment between them (the rmsnorms, RoPE, the attention's batched
    products and softmax, silu·mul) under its own checkpoint, as JAX's
    `dots_with_no_batch_dims_saveable` (qwen2.py:1040-1052); False keeps
    every activation. No route dispatches through a Python mode.
    return_hidden: return the final-normed hidden states [b, t, d] instead
    of the logits (the fused loss's input).
    dropout_rng: a dropout key turns on LoRA dropout (cfg.lora_dropout) with
    a LoRA tree; layer i's key folds in i. The masks are drawn inside the
    recomputed region from the key's ints, so a recompute draws them again.
    Returns (logits [b, t or 1, vocab] f32 or hidden, cache or None).
    """
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    if positions is None:
        positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    if cache is None:
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
        mask = causal[None, None] & attention_mask[:, None, None, :].bool()
    else:
        mask = attention_mask[:, None, :, :]  # [b, 1, t, max_len]

    dots = remat == "dots"
    seg = _recomputed if dots else _direct

    def layer_fn(x, layer, lora_layer, layer_cache, layer_drop):
        out, residual_done = _attention(layer, lora_layer, cfg, x, positions, mask,
                                        layer_cache, cache_index, drop_rng=layer_drop, seg=seg)
        x = out if residual_done else x + out
        y = _decode_mlp_fused(layer, lora_layer, cfg, x) \
            if layer_cache is not None and t == 1 else None
        if y is not None:
            return y
        h = seg(nn.rmsnorm, layer["post_attn_ln"], x, cfg.rms_eps)
        return x + _mlp(layer, lora_layer, cfg, h, drop_rng=layer_drop, seg=seg)

    run = layer_fn
    if remat and not dots:
        run = functools.partial(torch_checkpoint.checkpoint, layer_fn, use_reentrant=False)
    drop_on = dropout_rng is not None and lora is not None and cfg.lora_dropout > 0.0
    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        lora_layer = lora["layers"][i] if lora is not None else None
        layer_cache = cache[i] if cache is not None else None
        x = run(x, layer, lora_layer, layer_cache,
                nn.fold_in(dropout_rng, i) if drop_on else None)

    x = nn.rmsnorm(params["final_ln"], x, cfg.rms_eps)
    if last_token_only:
        x = x[:, -1:, :]
    if return_hidden:
        return x, cache
    return _logits(params, cfg, x), cache


def _logits(params: dict, cfg: QwenConfig, x: torch.Tensor) -> torch.Tensor:
    """f32 logits of final-normed hidden states x [b, t, hidden]: the tied
    embedding table, a quantized lm_head (rounded to x's dtype, then f32) or
    a dense one. On a tensor-parallel shard each rank computes its
    vocabulary columns (the lm_head's, or its rows of the replicated tied
    table) and the ranks' columns are gathered to the whole vocabulary
    (under autograd x passes f and the gather returns the rank's slice of
    the gradient)."""
    layout = _tp(cfg)
    x = mesh.copy_to_tp(x, layout)
    if cfg.tie_embeddings:
        table = params["embed_tokens"]["table"]
        if layout is not None:
            per = table.shape[0] // layout.tp
            table = table[layout.tp_rank * per:(layout.tp_rank + 1) * per]
        logits = nn.matmul_f32(x, table.T)
    elif "w" not in params["lm_head"]:
        logits = _lora_dense(params["lm_head"], None, x, 0.0, has_bias=False).float()
    else:
        logits = nn.matmul_f32(x, params["lm_head"]["w"])
    return mesh.gather_from_tp(logits, layout)


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return nn.embedding(params["embed_tokens"], ids)


def init_cache(cfg: QwenConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> list:
    """Dense KV cache, one {"k", "v"} pair of [b, kv_heads, max_len, head_dim]
    buffers per layer (the JAX layout), on the card unless `device` says
    otherwise. dtype=torch.int8 selects the quantized cache, which adds f32
    per-row scales "k_scale"/"v_scale" [b, kv_heads, max_len]."""
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return [kv_buffers(shape, dtype, device) for _ in range(cfg.num_layers)]


def kv_buffers(shape: tuple, dtype, device) -> dict:
    """One layer's zeroed K/V buffers of `shape` (head_dim last). int8 adds
    the f32 per-row scales "k_scale"/"v_scale" of shape[:-1]; the dense cache
    and the paged pools share this layout."""
    buf = {"k": torch.zeros(shape, dtype=dtype, device=device),
           "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        buf["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
        buf["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=device)
    return buf


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100, return_sum: bool = False):
    """Shifted causal-LM loss with ignore-index masking, the mean over valid
    positions (HF labels= semantics; JAX qwen2.py:1123). return_sum: return
    (the sum over valid positions, their count) instead, for a mean over a
    batch spread over several ranks."""
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:]
    valid = shift_labels != ignore_index
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logprobs = torch.log_softmax(shift_logits, dim=-1)
    token_ll = logprobs.gather(-1, safe[..., None].long())[..., 0]
    loss_sum = -torch.where(valid, token_ll, torch.zeros_like(token_ll)).sum()
    if return_sum:
        return loss_sum, valid.sum()
    return loss_sum / valid.sum().clamp_min(1)


def _chunk_stats(xs, w_chunk, safe, off: int, m, s, tgt):
    """One vocab chunk of the online logsumexp: the chunk's f32 logits
    [N, width], the running max m, the rescaled sum s and the target logit
    tgt of the rows whose label falls in the chunk."""
    logits = nn.matmul_f32(xs, w_chunk)
    width = logits.shape[-1]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    in_chunk = (safe >= off) & (safe < off + width)
    picked = logits.gather(1, (safe - off).clamp(0, width - 1)[:, None])[:, 0]
    return m_new, s, tgt + torch.where(in_chunk, picked, torch.zeros_like(picked))


def fused_cross_entropy_loss(hidden: torch.Tensor, params: dict, cfg: QwenConfig,
                             labels: torch.Tensor, ignore_index: int = -100,
                             chunk: int = 16384, return_sum: bool = False):
    """The shifted causal-LM loss of `cross_entropy_loss(lm_head(hidden))`,
    streaming the lm_head over vocab chunks with an online logsumexp, so
    the [b, t, vocab] f32 logits never exist (JAX qwen2.py:1138-1208).
    hidden [b, t, d] = forward(..., return_hidden=True). Each chunk runs
    under `torch.utils.checkpoint`: the backward recomputes its [N, chunk]
    logits, so one chunk is live at a time. The chunk product is
    `nn.matmul_f32`, as JAX computes it outside any kernel. return_sum: as
    in `cross_entropy_loss`.

    On a tensor-parallel shard (vocabulary-parallel): each rank streams its
    own columns (the sharded lm_head's, or its rows of the replicated tied
    table, as `_logits` takes them) from hidden passed through f; the
    ranks' running maxima are reduced by max (no gradient: the result does
    not depend on it), each rank's sum is rescaled to that maximum and the
    sums and the target logits (nonzero on the rank holding the label) are
    summed over the ranks by g. Every rank returns the same loss; its
    backward gives the whole gradient of hidden, and of the rank's own
    columns."""
    b, t, d = hidden.shape
    xs = hidden[:, :-1, :].reshape(-1, d)
    lab = labels[:, 1:].reshape(-1)
    n = xs.shape[0]
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
    layout = _tp(cfg)
    if cfg.tie_embeddings:
        table = params["embed_tokens"]["table"]  # [V, d]
        if layout is not None:
            per = table.shape[0] // layout.tp
            table = table[layout.tp_rank * per:(layout.tp_rank + 1) * per]
        vocab = table.shape[0]
        get_chunk = lambda off, width: table[off:off + width].t()  # noqa: E731
    else:
        w = params["lm_head"]["w"]  # [d, V], or the rank's [d, V / tp]
        vocab = w.shape[1]
        get_chunk = lambda off, width: w[:, off:off + width]  # noqa: E731
    if layout is not None:
        xs = mesh.copy_to_tp(xs, layout)
        safe = safe - layout.tp_rank * vocab  # labels outside [0, vocab) are another rank's
    f32 = dict(dtype=torch.float32, device=hidden.device)
    m = torch.full((n,), float("-inf"), **f32)
    s = torch.zeros((n,), **f32)
    tgt = torch.zeros((n,), **f32)
    for off in range(0, vocab, chunk):
        w_chunk = get_chunk(off, min(chunk, vocab - off))
        m, s, tgt = torch_checkpoint.checkpoint(_chunk_stats, xs, w_chunk, safe, off, m, s, tgt,
                                                use_reentrant=False)
    if layout is not None:
        m_all = mesh.tp_all_reduce_max(m.detach().clone(), layout)
        s = mesh.reduce_from_tp(s * torch.exp(m - m_all), layout)
        tgt = mesh.reduce_from_tp(tgt, layout)
        m = m_all
    token_nll = torch.log(s) + m - tgt
    loss_sum = torch.where(valid, token_nll, torch.zeros_like(token_nll)).sum()
    if return_sum:
        return loss_sum, valid.sum()
    return loss_sum / valid.sum().clamp_min(1)
