"""Qwen2/2.5-family causal decoder with LoRA, in PyTorch.

Port of affectgpt_tpu/models/qwen2.py for the serving path: dense bf16
weights in the split q/k/v layout, LoRA either as a parallel branch or
merged into the weights (`merge_lora`), a dense KV cache, and the decode
kernels of `affectgpt_tpu_torch.ops`.

Parameters are the JAX package's tree as nested dicts of tensors, with the
same keys and the JAX `[in, out]` dense layout, so `models.convert.from_jax`
needs no transposes and both decode kernels read the weights as stored.

The KV cache keeps the JAX layout `[b, kv_heads, max_len, head_dim]` and is
written IN PLACE by `forward`; the list it returns is the one passed in.

Decode dispatch follows the JAX rule (qwen2.py:761-766, :1028-1032): with a
cache, t == 1, merged LoRA and the split layout, the pre-attention rmsnorm,
q/k/v projections, bias and RoPE go through `ops.decode_qkv`, and the
post-attention rmsnorm and MLP through `ops.decode_mlp_bf16`. Those wrappers
launch their CUDA kernels for CUDA tensors (or raise) and run their plain
versions for CPU tensors. Everything else is plain torch, mirroring the JAX
default chain.

Not ported yet: quantized and fused (`qkv_proj`) layouts, the int8 KV cache,
per-row cache indices, flash prefill attention, the CE losses, remat and
LoRA dropout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from affectgpt_tpu_torch.models import nn
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv


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


_LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


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
    computed in f32 and stored in W's dtype. Returns a new tree; unchanged
    leaves are shared with `params`."""
    scaling = cfg.lora_alpha / cfg.lora_r
    layers = []
    for layer, lora_layer in zip(params["layers"], lora["layers"]):
        merged = dict(layer)
        for name in _LORA_TARGETS:
            if name not in lora_layer:
                continue
            ab = lora_layer[name]["a"].float() @ lora_layer[name]["b"].float()
            w = layer[name]["w"]
            merged[name] = {**layer[name], "w": (w.float() + scaling * ab).to(w.dtype)}
        layers.append(merged)
    return {**params, "layers": layers}


def _lora_dense(base, lora, x, scaling: float, has_bias: bool = True) -> torch.Tensor:
    y = nn.matmul_f32(x, base["w"])
    if lora is not None:
        z = nn.matmul_f32(x, lora["a"].to(x.dtype))
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


def _kernel_eligible(lora_layer, cache, t: int) -> bool:
    """The JAX rule: a decode step (cache, t == 1) with LoRA merged. The
    port has only the split bf16 layout, so no layout check is needed."""
    return cache is not None and t == 1 and lora_layer is None


def _attention(layer, lora_layer, cfg: QwenConfig, x, positions, mask, cache, cache_index):
    """x is the RAW residual stream; this function owns the pre-attention
    rmsnorm (folded into the decode-QKV kernel on the decode step)."""
    b, t, _ = x.shape
    scaling = cfg.lora_alpha / cfg.lora_r
    lget = (lambda n: lora_layer[n]) if lora_layer is not None else (lambda n: None)
    if _kernel_eligible(lora_layer, cache, t):
        def bias(name):
            if "b" in layer[name]:
                return layer[name]["b"]
            return torch.zeros(layer[name]["w"].shape[1], dtype=x.dtype, device=x.device)

        q2, k2, v2 = decode_qkv(
            x[:, 0, :], positions[:, 0],
            layer["q_proj"]["w"], bias("q_proj"), layer["k_proj"]["w"], bias("k_proj"),
            layer["v_proj"]["w"], bias("v_proj"),
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, theta=cfg.rope_theta,
            ln_scale=layer["input_ln"]["scale"], eps=cfg.rms_eps,
        )
        q = q2.reshape(b, t, cfg.num_heads, cfg.head_dim)
        k = k2.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = v2.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    else:
        x = nn.rmsnorm(layer["input_ln"], x, cfg.rms_eps)
        q = _lora_dense(layer["q_proj"], lget("q_proj"), x, scaling).reshape(
            b, t, cfg.num_heads, cfg.head_dim)
        k = _lora_dense(layer["k_proj"], lget("k_proj"), x, scaling).reshape(
            b, t, cfg.num_kv_heads, cfg.head_dim)
        v = _lora_dense(layer["v_proj"], lget("v_proj"), x, scaling).reshape(
            b, t, cfg.num_kv_heads, cfg.head_dim)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)

    k = k.transpose(1, 2)  # [b, kv, t, d]
    v = v.transpose(1, 2)
    if cache is not None:
        cache["k"][:, :, cache_index:cache_index + t] = k
        cache["v"][:, :, cache_index:cache_index + t] = v
        k, v = cache["k"], cache["v"]

    # GQA without repeating K/V: fold the query-head groups into a 5-D
    # product; scores and softmax in f32, probabilities rounded to the cache
    # dtype before PV, as the JAX chain does (qwen2.py:929-958)
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(b, t, cfg.num_kv_heads, groups, cfg.head_dim)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qg.float(), k.float())
    logits = logits / float(cfg.head_dim) ** 0.5
    mask5 = mask[:, :, None, :, :]
    logits = logits.masked_fill(~mask5, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs.float(), v.float())
    out = out.to(x.dtype).reshape(b, t, cfg.num_heads * cfg.head_dim)
    return _lora_dense(layer["o_proj"], lget("o_proj"), out, scaling, has_bias=False)


def _mlp(layer, lora_layer, cfg: QwenConfig, x: torch.Tensor) -> torch.Tensor:
    scaling = cfg.lora_alpha / cfg.lora_r
    lget = (lambda n: lora_layer[n]) if lora_layer is not None else (lambda n: None)
    gate = _lora_dense(layer["gate_proj"], lget("gate_proj"), x, scaling, has_bias=False)
    up = _lora_dense(layer["up_proj"], lget("up_proj"), x, scaling, has_bias=False)
    return _lora_dense(layer["down_proj"], lget("down_proj"),
                       torch.nn.functional.silu(gate) * up, scaling, has_bias=False)


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
):
    """Run the decoder stack.

    inputs_embeds [b, t, d]; attention_mask [b, t] validity without a cache
    (causal mask built here), or [b, t, max_len] bool key mask with one.
    cache_index: the int column the t new k/v rows are written at.
    last_token_only: project only the final position through the lm_head.
    Returns (logits [b, t or 1, vocab] f32, cache or None).
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

    x = inputs_embeds
    for i, layer in enumerate(params["layers"]):
        lora_layer = lora["layers"][i] if lora is not None else None
        layer_cache = cache[i] if cache is not None else None
        x = x + _attention(layer, lora_layer, cfg, x, positions, mask, layer_cache, cache_index)
        if _kernel_eligible(lora_layer, layer_cache, t):
            x = decode_mlp_bf16(
                x[:, 0, :], layer["post_attn_ln"]["scale"], layer["gate_proj"]["w"],
                layer["up_proj"]["w"], layer["down_proj"]["w"], eps=cfg.rms_eps,
            )[:, None, :]
        else:
            h = nn.rmsnorm(layer["post_attn_ln"], x, cfg.rms_eps)
            x = x + _mlp(layer, lora_layer, cfg, h)

    x = nn.rmsnorm(params["final_ln"], x, cfg.rms_eps)
    if last_token_only:
        x = x[:, -1:, :]
    if cfg.tie_embeddings:
        logits = nn.matmul_f32(x, params["embed_tokens"]["table"].T)
    else:
        logits = nn.matmul_f32(x, params["lm_head"]["w"])
    return logits, cache


def embed_tokens(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return nn.embedding(params["embed_tokens"], ids)


def init_cache(cfg: QwenConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> list:
    """Dense KV cache, one {"k", "v"} pair of [b, kv_heads, max_len, head_dim]
    buffers per layer (the JAX layout)."""
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return [
        {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device)}
        for _ in range(cfg.num_layers)
    ]
