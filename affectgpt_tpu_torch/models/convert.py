"""Load JAX parameter trees into the PyTorch port.

`from_jax` takes the JAX package's `frozen` and `trainable` trees after
`np.asarray` on every leaf (nested dicts and lists of numpy arrays) and
returns the same trees as tensors, on the card unless `device` says
otherwise. It covers the LLM, LoRA, the mergers (their Q-Formers too), the
multi-fusion block and the media encoders (`visual_encoder`: the CLIP vision
tower, `acoustic_encoder`: HuBERT), bf16 or with the int8 `w_q` leaves of
`ops.quant.quantize_encoder_tree`; `text_tower_from_jax` carries the CLIP
text tower. Neither imports jax.

Layouts: the port keeps the JAX layouts and dtypes unchanged, the split
(`q_proj` ...) and fused (`qkv_proj`, `gateup_proj`) serving layouts alike.
Dense weights stay `[in, out]` (applied as `x @ w`): bf16/f32 `w`, int8
`w_q` with f32 `scales` [1, out], or int4 `w_q4` packed [in/2, out] with f32
`scales` [in/128, out]; embeddings `[vocab, hidden]`. The decode
kernels read that layout directly: ops/decode_qkv.py reads `wq [h, H*d]`
and `wk`/`wv [h, kv*d]` in 64-column boxes, ops/decode_mlp_bf16.py reads
`w_gate`/`w_up [h, I]` in 64-column boxes and `w_down [I, h]` in
128-column tiles, ops/decode_attn_o.py reads `o_proj [H*d, h]` in
128-column tiles, and ops/quant.py's kernels read the quantized leaves as
stored. The encoder towers keep the JAX layouts too, which already are
torch's: dense `[in, out]` applied as `x @ w`, the CLIP patch embedding
`[P²·3, width]` over channel-major patches, Conv1d kernels `OIH`
`[out, in, k]`. No transpose or repacking happens here.
"""

from __future__ import annotations

import numpy as np
import torch

from affectgpt_tpu_torch.models import affectgpt, encoders


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: no numpy→torch bridge
        t = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32))).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def tree_to_torch(tree, device="cuda"):
    """Nested dicts/lists of arrays → the same structure of tensors, dtypes
    kept; None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_torch(v, device) for v in tree]
    return _tensor(tree, device)


def _dense_shape(leaf: dict) -> tuple:
    """(in, out) of a dense leaf in any of its stored forms."""
    if "w" in leaf:
        return tuple(leaf["w"].shape)
    if "w_q" in leaf:
        return tuple(leaf["w_q"].shape)
    if "w_q4" in leaf:
        return (2 * leaf["w_q4"].shape[0], leaf["w_q4"].shape[1])
    raise ValueError(f"from_jax: not a dense leaf (keys {sorted(leaf)})")


def from_jax(frozen_np: dict, trainable_np: dict, cfg, device="cuda"):
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
    layer0 = llm["layers"][0]
    nq, nkv = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    name, width = ("qkv_proj", nq + 2 * nkv) if "qkv_proj" in layer0 else ("q_proj", nq)
    if _dense_shape(layer0[name]) != (lc.hidden_size, width):
        raise ValueError(f"from_jax: {name} is not [hidden, {width}]")
    if "visual_encoder" in frozen:
        _check_vision(frozen["visual_encoder"], cfg.vision_cfg_override
                      or encoders.get_visual_encoder(cfg.visual_encoder_name).make_config())
    if "acoustic_encoder" in frozen:
        _check_hubert(frozen["acoustic_encoder"], cfg.audio_cfg_override
                      or encoders.get_acoustic_encoder(cfg.acoustic_encoder_name).make_config())
    for group, modality in affectgpt.GROUP_MODALITY.items():
        if group in trainable.get("mergers", {}):
            mcfg = cfg.merger_config(modality)
            _check_merger(trainable["mergers"][group], mcfg.fusion_type, mcfg.feat_dim,
                          mcfg.max_time, mcfg.qformer_config(), f"{group} merger")
    if "multi" in trainable:
        mcfg = cfg.multi_config()
        _check_merger(trainable["multi"], mcfg.fusion_type, mcfg.max_dim, mcfg.max_time,
                      mcfg.qformer_config(), "multi fusion")
    return frozen, trainable


def text_tower_from_jax(tree_np: dict, cfg, device="cuda") -> dict:
    """The JAX package's CLIP text tower (numpy tree) → tensors, checked
    against its ClipTextConfig."""
    tree = tree_to_torch(tree_np, device)
    if tuple(tree["token_embed"]["table"].shape) != (cfg.vocab_size, cfg.width):
        raise ValueError("from_jax: text token_embed does not match the config")
    if tuple(tree["pos_embed"]["table"].shape) != (cfg.context_length, cfg.width):
        raise ValueError("from_jax: text pos_embed does not match the config")
    if len(tree["blocks"]) != cfg.num_layers:
        raise ValueError(f"from_jax: the text tower has {len(tree['blocks'])} blocks, "
                         f"the config {cfg.num_layers}")
    if _dense_shape(tree["blocks"][0]["mlp_in"]) != (cfg.width, cfg.mlp_dim):
        raise ValueError(f"from_jax: text mlp_in is not [{cfg.width}, {cfg.mlp_dim}]")
    if _dense_shape(tree["proj"]) != (cfg.width, cfg.projection_dim):
        raise ValueError(f"from_jax: text proj is not [{cfg.width}, {cfg.projection_dim}]")
    return tree


def _check_merger(tree: dict, fusion_type: str, feat_dim: int, max_time: int, qcfg,
                  what: str) -> None:
    """A qformer merger or pre-fusion block against its config: the position
    table [max_time, feat_dim], the query tokens, the layer count and each
    cross-attention's key projection [feat_dim, hidden]."""
    if fusion_type != "qformer":
        if "qformer" in tree:
            raise ValueError(f"from_jax: the {what} holds a Q-Former, the config asks for "
                             f"{fusion_type!r}")
        return
    if "qformer" not in tree:
        raise ValueError(f"from_jax: the {what} has no Q-Former, the config asks for one")
    if tuple(tree["pos_embed"]["table"].shape) != (max_time, feat_dim):
        raise ValueError(f"from_jax: {what} pos_embed is not [{max_time}, {feat_dim}]")
    q = tree["qformer"]
    if tuple(q["query_tokens"].shape) != (1, qcfg.num_query_tokens, qcfg.hidden_size):
        raise ValueError(f"from_jax: {what} query_tokens is not "
                         f"[1, {qcfg.num_query_tokens}, {qcfg.hidden_size}]")
    if len(q["layers"]) != qcfg.num_layers:
        raise ValueError(f"from_jax: the {what} Q-Former has {len(q['layers'])} layers, the "
                         f"config {qcfg.num_layers}")
    for i, layer in enumerate(q["layers"]):
        if "cross_attn" in layer and \
                _dense_shape(layer["cross_attn"]["k"]) != (feat_dim, qcfg.hidden_size):
            raise ValueError(f"from_jax: {what} layer {i} cross-attention keys are not "
                             f"[{feat_dim}, {qcfg.hidden_size}]")
    if _dense_shape(tree["proj"])[0] != qcfg.hidden_size:
        raise ValueError(f"from_jax: {what} proj does not take the Q-Former's width")


def _check_vision(tree: dict, vc) -> None:
    """The CLIP vision tower's geometry against its ClipVisionConfig."""
    patch = (vc.patch_size * vc.patch_size * 3, vc.width)
    if _dense_shape(tree["patch_embed"]) != patch:
        raise ValueError(f"from_jax: visual patch_embed is not {list(patch)}")
    if len(tree["blocks"]) != vc.num_layers:
        raise ValueError(f"from_jax: the vision tower has {len(tree['blocks'])} blocks, "
                         f"the config {vc.num_layers}")
    if tuple(tree["pos_embed"]["table"].shape) != (vc.num_patches + 1, vc.width):
        raise ValueError("from_jax: visual pos_embed does not match the config")


def _check_hubert(tree: dict, ac) -> None:
    """HuBERT's geometry against its HubertConfig: the conv kernels [out, in,
    k], the layer count, the positional conv [hidden, hidden / groups, k]."""
    in_ch = 1
    if len(tree["convs"]) != len(ac.conv_dim):
        raise ValueError("from_jax: the acoustic conv stack does not match the config")
    for i, (conv, out_ch, k) in enumerate(zip(tree["convs"], ac.conv_dim, ac.conv_kernel)):
        if tuple(conv["w"].shape) != (out_ch, in_ch, k):
            raise ValueError(f"from_jax: acoustic conv {i} is not [{out_ch}, {in_ch}, {k}]")
        in_ch = out_ch
    if len(tree["layers"]) != ac.num_layers:
        raise ValueError(f"from_jax: HuBERT has {len(tree['layers'])} layers, the config "
                         f"{ac.num_layers}")
    pos = (ac.hidden_size, ac.hidden_size // ac.pos_conv_groups, ac.pos_conv_kernel)
    if tuple(tree["pos_conv"]["w"].shape) != pos:
        raise ValueError(f"from_jax: pos_conv is not {list(pos)}")
