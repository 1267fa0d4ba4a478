"""Load JAX parameter trees into the PyTorch port.

`from_jax` takes the JAX package's `frozen` and `trainable` trees after
`np.asarray` on every leaf (nested dicts and lists of numpy arrays) and
returns the same trees as tensors. It covers the LLM, LoRA, the mergers and
the multi-fusion block, and never imports jax.

Layouts: the port keeps the JAX layouts unchanged. Dense weights stay
`[in, out]` (applied as `x @ w`); embeddings `[vocab, hidden]`. Both decode
kernels read that layout directly: ops/decode_qkv.py reads `wq [h, H*d]`
and `wk`/`wv [h, kv*d]` in 128-column strips, ops/decode_mlp_bf16.py reads
`w_gate`/`w_up [h, I]` in 64-column strips and `w_down [I, h]` in
32-column strips. No transpose happens here.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy→torch bridge
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32))).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def tree_to_torch(tree, device="cpu"):
    """Nested dicts/lists of arrays → the same structure of tensors, dtypes
    kept; None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return _tensor(tree, device)


def from_jax(frozen_np: dict, trainable_np: dict, cfg, device="cpu"):
    """(frozen, trainable) numpy trees of the JAX package → tensor trees for
    `affectgpt_tpu_torch`. cfg is the port's AffectGPTConfig; the LLM's
    geometry is checked against it."""
    frozen = tree_to_torch(frozen_np, device)
    trainable = tree_to_torch(trainable_np, device)
    llm, lc = frozen["llm"], cfg.llm
    if tuple(llm["embed_tokens"]["table"].shape) != (lc.vocab_size, lc.hidden_size):
        raise ValueError("from_jax: embedding table does not match cfg.llm")
    if len(llm["layers"]) != lc.num_layers:
        raise ValueError("from_jax: layer count does not match cfg.llm")
    expect_q = (lc.hidden_size, lc.num_heads * lc.head_dim)
    if tuple(llm["layers"][0]["q_proj"]["w"].shape) != expect_q:
        raise ValueError("from_jax: q_proj is not [hidden, heads*head_dim]")
    return frozen, trainable
