"""Load JAX parameter trees into the PyTorch port.

`from_jax` takes the JAX package's `frozen` and `trainable` trees after
`np.asarray` on every leaf (nested dicts and lists of numpy arrays) and
returns the same trees as tensors, on the card unless `device` says
otherwise. It covers the LLM, LoRA, the mergers (their Q-Formers too), the
multi-fusion block and the media encoders (`visual_encoder`: any visual
tower of the registry, `acoustic_encoder`: any acoustic one; `check_tower`
holds each to its config), bf16 or with the int8 `w_q` leaves of
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

The HF checkpoint converters (`convert_qwen2`, `convert_llama`,
`convert_baichuan2`, `convert_clip_vision`, `convert_clip_text`,
`convert_hubert`, `convert_dinov2`, `convert_siglip_vision`,
`convert_wavlm`, `convert_data2vec_audio`, `llm_config_from_hf`;
`eva_vit.convert_eva_state` and `imagebind_audio.convert_imagebind_audio`
take raw state dicts; `convert_reference_affectgpt` for a
reference `AffectGPT.state_dict()`) are the port of affectgpt_tpu/models/
convert.py. They read a model directory with the port's own readers: the
safetensors format (an 8-byte little-endian header length, a JSON header,
then the data; BF16, F16 and F32), one file or the shards that
`model.safetensors.index.json` names, else `*.bin` through
`torch.load(weights_only=True, mmap=True)`. One tensor at a time goes from
its own memory map to the device, is cast there to the tree's dtype
(f32 → bf16 rounds to nearest even, as JAX's cast does) and transposed
there from HF's `[out, in]` into a contiguous `[in, out]`; no f32 or
whole-state copy is held on the host. The two products JAX computes in f32
numpy (Baichuan2's NormHead row norms and HuBERT's weight norm `g·v/‖v‖`)
are computed in f32 numpy here too, row block by row block for the head,
so the trees equal JAX's bit for bit.

Tensor-parallel loading: `convert_qwen2` (and `convert_llama`,
`convert_baichuan2`) take a `layout` of `parallel.mesh`; each rank then
reads only its slices of the sharded projections and of the lm_head
(`mesh.leaf_kind`: the rows of HF's `[out, in]` for column-parallel q/k/v,
gate/up and the vocabulary, the columns for row-parallel o/down), a tensor
at a time, cut on the host before the copy to the device, so no rank holds
the whole LLM on its card. The tree equals `mesh.shard_params` of the whole
conversion.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from affectgpt_tpu_torch.models import affectgpt, clip_vit, encoders, hubert
from affectgpt_tpu_torch.parallel import mesh


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
    check_trees(frozen, trainable, cfg)
    return frozen, trainable


def check_trees(frozen: dict, trainable: dict, cfg) -> None:
    """Raise ValueError where a (frozen, trainable) pair of tensor trees does
    not have the geometry of cfg (the port's AffectGPTConfig): the LLM's
    embedding, layer count and q (or fused qkv) projection, the towers
    present, the mergers and the multi-fusion block."""
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
        check_tower("visual_encoder", frozen["visual_encoder"], cfg.vision_cfg_override
                    or encoders.get_visual_encoder(cfg.visual_encoder_name).make_config())
    if "acoustic_encoder" in frozen:
        check_tower("acoustic_encoder", frozen["acoustic_encoder"], cfg.audio_cfg_override
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


def text_tower_from_jax(tree_np: dict, cfg, device="cuda") -> dict:
    """The JAX package's CLIP text tower (numpy tree) → tensors, checked
    against its ClipTextConfig."""
    return check_text_tower(tree_to_torch(tree_np, device), cfg)


def check_text_tower(tree: dict, cfg) -> dict:
    """`tree` if a CLIP text tower's geometry matches its ClipTextConfig,
    else ValueError."""
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


def check_tower(key: str, tree: dict, tower_cfg) -> dict:
    """`tree` if the `key` tower ("visual_encoder" or "acoustic_encoder") has
    the geometry of tower_cfg, the config of any tower the registry names
    (models/encoders.py), else ValueError. An EVA_CLIP_G tree ({"vit",
    "head"}) is held by its ViT and its Q-Former head."""
    from affectgpt_tpu_torch.models import eva_vit, imagebind_audio, vit_variants, wav_encoders

    if key == "visual_encoder" and isinstance(tower_cfg, eva_vit.EvaVitConfig) \
            and "head" in tree:
        _check_vit(tree["vit"], tower_cfg, "the EVA tower", cls=1)
        _check_blip2_head(tree["head"], tower_cfg)
        return tree
    checks = {
        clip_vit.ClipVisionConfig: _check_vision,
        hubert.HubertConfig: _check_hubert,
        vit_variants.Dinov2Config: lambda t, c: _check_vit(t, c, "DINOv2", cls=1,
                                                           any_grid=True),
        vit_variants.SiglipConfig: lambda t, c: _check_vit(t, c, "SigLIP", cls=0),
        eva_vit.EvaVitConfig: lambda t, c: _check_vit(t, c, "the EVA tower", cls=1),
        wav_encoders.WavLMConfig: _check_wavlm,
        wav_encoders.Data2VecAudioConfig: _check_data2vec,
        imagebind_audio.ImageBindAudioConfig: _check_imagebind,
    }
    if type(tower_cfg) not in checks:
        raise ValueError(f"from_jax: no geometry check for a {type(tower_cfg).__name__}")
    checks[type(tower_cfg)](tree, tower_cfg)
    return tree


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


def _check_vit(tree: dict, vc, what: str, cls: int, any_grid: bool = False) -> None:
    """A DINOv2, SigLIP or EVA tower against its config: the patch embedding
    [P²·3, width], the block count, each block's MLP [width, mlp_dim] and the
    position table [grid + cls, width] (DINOv2 resizes a table of another
    square grid to the image's: any_grid)."""
    patch = (vc.patch_size * vc.patch_size * 3, vc.width)
    if _dense_shape(tree["patch_embed"]) != patch:
        raise ValueError(f"from_jax: {what}'s patch_embed is not {list(patch)}")
    if len(tree["blocks"]) != vc.num_layers:
        raise ValueError(f"from_jax: {what} has {len(tree['blocks'])} blocks, the config "
                         f"{vc.num_layers}")
    if _dense_shape(tree["blocks"][0]["mlp_in"]) != (vc.width, vc.mlp_dim):
        raise ValueError(f"from_jax: {what}'s mlp_in is not [{vc.width}, {vc.mlp_dim}]")
    rows, width = tree["pos_embed"]["table"].shape
    grid = (vc.image_size // vc.patch_size) ** 2
    side = round((rows - cls) ** 0.5)
    if width != vc.width or (rows != grid + cls and not (any_grid and side * side == rows - cls)):
        raise ValueError(f"from_jax: {what}'s pos_embed is not [{grid + cls}, {vc.width}]")


def _check_blip2_head(head: dict, vc) -> None:
    """EVA_CLIP_G's head: ln_vision over the ViT's width and BLIP2's
    12-layer Q-Former, whose cross-attention keys take that width."""
    from affectgpt_tpu_torch.models import qformer

    q = head["qformer"]
    qcfg = qformer.QFormerConfig.blip2(q["query_tokens"].shape[1], vc.width)
    if tuple(head["ln_vision"]["scale"].shape) != (vc.width,) \
            or len(q["layers"]) != qcfg.num_layers:
        raise ValueError(f"from_jax: the BLIP2 head is not ln_vision [{vc.width}] and "
                         f"{qcfg.num_layers} Q-Former layers")
    for i, layer in enumerate(q["layers"]):
        if "cross_attn" in layer and \
                _dense_shape(layer["cross_attn"]["k"]) != (vc.width, qcfg.hidden_size):
            raise ValueError(f"from_jax: BLIP2 head layer {i} cross-attention keys are not "
                             f"[{vc.width}, {qcfg.hidden_size}]")


def _check_hubert(tree: dict, ac) -> None:
    """HuBERT's geometry against its HubertConfig: the conv kernels [out, in,
    k], the layer count, the positional conv [hidden, hidden / groups, k]."""
    _check_wav_stack(tree, ac)
    pos = (ac.hidden_size, ac.hidden_size // ac.pos_conv_groups, ac.pos_conv_kernel)
    if tuple(tree["pos_conv"]["w"].shape) != pos:
        raise ValueError(f"from_jax: pos_conv is not {list(pos)}")


def _check_wav_stack(tree: dict, ac) -> None:
    """The conv frontend [out, in, k] and the layer count of a HuBERT-style
    tower."""
    in_ch = 1
    if len(tree["convs"]) != len(ac.conv_dim):
        raise ValueError("from_jax: the acoustic conv stack does not match the config")
    for i, (conv, out_ch, k) in enumerate(zip(tree["convs"], ac.conv_dim, ac.conv_kernel)):
        if tuple(conv["w"].shape) != (out_ch, in_ch, k):
            raise ValueError(f"from_jax: acoustic conv {i} is not [{out_ch}, {in_ch}, {k}]")
        in_ch = out_ch
    if len(tree["layers"]) != ac.num_layers:
        raise ValueError(f"from_jax: the acoustic tower has {len(tree['layers'])} layers, the "
                         f"config {ac.num_layers}")


def _check_wavlm(tree: dict, ac) -> None:
    """WavLM: HuBERT's geometry, the relative-position table [buckets, heads]
    and each layer's gate [head_dim, 8]."""
    _check_hubert(tree, ac.as_hubert())
    if tuple(tree["rel_attn_embed"]["table"].shape) != (ac.num_buckets, ac.num_heads):
        raise ValueError(f"from_jax: rel_attn_embed is not [{ac.num_buckets}, {ac.num_heads}]")
    gate = (ac.hidden_size // ac.num_heads, 8)
    if any(_dense_shape(layer["gru_rel_pos_linear"]) != gate for layer in tree["layers"]):
        raise ValueError(f"from_jax: a WavLM gate is not {list(gate)}")


def _check_data2vec(tree: dict, ac) -> None:
    """data2vec-audio: the conv frontend, the layer count and the positional
    convolutions [hidden, hidden / groups, k]."""
    _check_wav_stack(tree, ac)
    pos = (ac.hidden_size, ac.hidden_size // ac.pos_conv_groups, ac.pos_conv_kernel)
    if len(tree["pos_convs"]) != ac.num_pos_conv_layers or \
            any(tuple(conv["w"].shape) != pos for conv in tree["pos_convs"]):
        raise ValueError(f"from_jax: the positional convs are not {ac.num_pos_conv_layers} x "
                         f"{list(pos)}")


def _check_imagebind(tree: dict, ac) -> None:
    """ImageBind's audio tower: the stem [width, 1, k, k], the block count,
    the position table [grid + 1, width] and the head [width, out]."""
    k = ac.kernel_size
    if tuple(tree["stem_conv"]["w"].shape) != (ac.width, 1, k, k):
        raise ValueError(f"from_jax: the audio stem is not [{ac.width}, 1, {k}, {k}]")
    if len(tree["blocks"]) != ac.num_layers:
        raise ValueError(f"from_jax: the audio tower has {len(tree['blocks'])} blocks, the "
                         f"config {ac.num_layers}")
    h, w = ac.patch_grid
    if tuple(tree["pos_embed"]["table"].shape) != (h * w + 1, ac.width):
        raise ValueError(f"from_jax: the audio pos_embed is not [{h * w + 1}, {ac.width}]")
    if _dense_shape(tree["head_proj"]) != (ac.width, ac.out_embed_dim):
        raise ValueError(f"from_jax: head_proj is not [{ac.width}, {ac.out_embed_dim}]")


# ---------------------------------------------------------------------------
# HF checkpoint reading

# safetensors dtype → (numpy dtype of the stored bytes, torch dtype to view
# them as); numpy has no bfloat16, so its bits are read as int16
_SAFETENSORS_DTYPES = {
    "BF16": (np.int16, torch.bfloat16),
    "F16": (np.float16, torch.float16),
    "F32": (np.float32, torch.float32),
}


class SafetensorsFile:
    """One `.safetensors` file: the header is read when it opens, each
    tensor is mapped from the file on its own when asked for."""

    def __init__(self, path: str):
        with open(path, "rb") as handle:
            (n,) = struct.unpack("<Q", handle.read(8))
            header = json.loads(handle.read(n))
        header.pop("__metadata__", None)
        self.path, self.base, self.header = path, 8 + n, header

    def keys(self):
        return self.header.keys()

    def tensor(self, key: str) -> torch.Tensor:
        """The tensor `key` in its stored dtype, on the CPU, over a private
        memory map of its bytes (copy it before the map goes)."""
        entry = self.header[key]
        if entry["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{self.path}: {key} has dtype {entry['dtype']}; the reader takes "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        np_dtype, torch_dtype = _SAFETENSORS_DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        start, end = entry["data_offsets"]
        if end == start:
            return torch.empty(shape, dtype=torch_dtype)
        mapped = np.memmap(self.path, dtype=np_dtype, mode="c", offset=self.base + start,
                           shape=shape)
        return torch.from_numpy(np.asarray(mapped)).view(torch_dtype)


class CheckpointState:
    """Name → tensor over the checkpoint files of an HF model directory,
    read lazily: safetensors (the shards of `model.safetensors.index.json`'s
    `weight_map` when the index exists, else every `*.safetensors`), else
    every `*.bin`, loaded with `torch.load(weights_only=True, mmap=True)`.
    `state[key]` is a CPU tensor in the stored dtype."""

    def __init__(self, model_dir: str):
        self._where: Dict[str, object] = {}
        index = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as handle:
                weight_map = json.load(handle)["weight_map"]
            files = {name: SafetensorsFile(os.path.join(model_dir, name))
                     for name in sorted(set(weight_map.values()))}
            self._where = {key: files[name] for key, name in weight_map.items()}
        else:
            for path in sorted(glob.glob(os.path.join(model_dir, "*.safetensors"))):
                file = SafetensorsFile(path)
                self._where.update(dict.fromkeys(file.keys(), file))
        if not self._where:
            paths = sorted(glob.glob(os.path.join(model_dir, "*.bin")))
            if not paths:
                raise FileNotFoundError(f"{model_dir} holds no *.safetensors or *.bin checkpoint")
            for path in paths:
                state = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
                self._where.update({key: value for key, value in state.items()})

    def __contains__(self, key: str) -> bool:
        return key in self._where

    def __getitem__(self, key: str) -> torch.Tensor:
        where = self._where[key]
        return where.tensor(key) if isinstance(where, SafetensorsFile) else where

    def keys(self):
        return self._where.keys()


def _load_torch_state(model_dir: str) -> CheckpointState:
    """The tensors of a HF model directory (safetensors preferred), lazily."""
    return CheckpointState(model_dir)


class _Put:
    """Stored CPU tensors → the tree's tensors: each is copied to `device`,
    cast there to `dtype` and, for a dense weight, transposed there into a
    contiguous [in, out]. With a tensor-parallel `layout` (and the LLM's
    whole `cfg`), a sharded HF tensor is first cut on the host to the
    rank's slice (`shard`)."""

    def __init__(self, state, device, dtype, layout=None, cfg=None):
        self.state, self.device, self.dtype = state, torch.device(device), dtype
        self.layout = layout if layout is not None and layout.tp > 1 else None
        self.cfg = cfg

    def __call__(self, value, transpose: bool = False, shard: str = "") -> torch.Tensor:
        if isinstance(value, str):
            value = self.state[value]
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if shard:
            value = self.shard(value, shard)
        out = value.to(device=self.device, copy=True).to(self.dtype)
        return out.t().contiguous() if transpose else out

    def shard(self, value: torch.Tensor, name: str) -> torch.Tensor:
        """The rank's slice of an HF tensor named `name` ([out, in] weight
        or [out] bias), still on the host: its rows for a column-parallel
        or vocabulary leaf, its columns for a row-parallel one."""
        kind = None if self.layout is None else mesh.leaf_kind(name)
        if kind is None:
            return value
        axis = 0 if kind in ("col", "vocab") else 1
        if axis >= value.ndim:
            return value
        start, stop = mesh.axis_range(kind, name, value.shape[axis], self.cfg, self.layout.tp,
                                      self.layout.tp_rank)
        return value.narrow(axis, start, stop - start)

    def dense(self, prefix: str, bias: bool = True) -> dict:
        out = {"w": self(f"{prefix}.weight", transpose=True, shard=prefix)}
        if bias and f"{prefix}.bias" in self.state:
            out["b"] = self(f"{prefix}.bias", shard=prefix)
        return out

    def ln(self, prefix: str) -> dict:
        return {"scale": self(f"{prefix}.weight"), "bias": self(f"{prefix}.bias")}


def _count(state, pattern: str) -> int:
    n = 0
    while pattern.format(n) in state:
        n += 1
    return n


def _llm_layer(put: _Put, p: str, qkv: dict) -> dict:
    return {
        **qkv,
        "o_proj": put.dense(f"{p}.self_attn.o_proj", bias=False),
        "gate_proj": put.dense(f"{p}.mlp.gate_proj", bias=False),
        "up_proj": put.dense(f"{p}.mlp.up_proj", bias=False),
        "down_proj": put.dense(f"{p}.mlp.down_proj", bias=False),
        "input_ln": {"scale": put(f"{p}.input_layernorm.weight")},
        "post_attn_ln": {"scale": put(f"{p}.post_attention_layernorm.weight")},
    }


def _llm_put(model_dir: str, state, device, dtype, layout, cfg) -> _Put:
    """The converters' `_Put`, sharding under a tp layout by the LLM's whole
    geometry (cfg, else the directory's config.json)."""
    if layout is not None and layout.tp > 1 and cfg is None:
        cfg = llm_config_from_hf(model_dir)
    return _Put(state, device, dtype, layout, cfg)


def convert_qwen2(model_dir: str, dtype=torch.float32, device="cuda", layout=None,
                  cfg=None) -> dict:
    """HF Qwen2ForCausalLM state → the qwen2 parameter tree; under a tp
    `layout`, this rank's shard of it (cfg: the LLM's whole QwenConfig,
    read from config.json when None)."""
    state = _load_torch_state(model_dir)
    put = _llm_put(model_dir, state, device, dtype, layout, cfg)
    layers = [
        _llm_layer(put, f"model.layers.{i}", {
            name: put.dense(f"model.layers.{i}.self_attn.{name}")
            for name in ("q_proj", "k_proj", "v_proj")})
        for i in range(_count(state, "model.layers.{}.self_attn.q_proj.weight"))
    ]
    params = {
        "embed_tokens": {"table": put("model.embed_tokens.weight")},
        "layers": layers,
        "final_ln": {"scale": put("model.norm.weight")},
    }
    if "lm_head.weight" in state:
        params["lm_head"] = {"w": put("lm_head.weight", transpose=True, shard="lm_head")}
    return params


# HF LlamaForCausalLM uses Qwen2's state-dict names (q/k/v carry no bias
# tensors, which `_Put.dense` treats as optional)
convert_llama = convert_qwen2

# rows of Baichuan2's head whose norms one numpy call computes
_NORM_ROWS = 4096


def _row_norms(head: torch.Tensor) -> np.ndarray:
    """[vocab, 1] f32 L2 norms of the head's rows, as np.linalg.norm(axis=-1)
    computes them in f32 (a row's sum does not depend on the rows beside
    it, so blocks of rows give the same bits)."""
    out = []
    for start in range(0, head.shape[0], _NORM_ROWS):
        x = head[start:start + _NORM_ROWS].float().numpy()
        out.append(np.sqrt(np.add.reduce(x * x, axis=-1, keepdims=True)))
    return np.concatenate(out)


def convert_baichuan2(model_dir: str, dtype=torch.float32, device="cuda", layout=None,
                      cfg=None) -> dict:
    """HF Baichuan2-7B state (BaichuanForCausalLM) → the qwen2 parameter tree.
    Two deltas from Llama: W_pack [3·hidden, hidden] holds q, k and v, split
    here; NormHead L2-normalizes the head's rows on every forward, folded in
    here (in f32, before the cast) so the served head is a plain matmul.
    layout, cfg: as `convert_qwen2` takes them."""
    state = _load_torch_state(model_dir)
    put = _llm_put(model_dir, state, device, dtype, layout, cfg)
    layers = []
    for i in range(_count(state, "model.layers.{}.self_attn.W_pack.weight")):
        p = f"model.layers.{i}"
        w_pack = state[f"{p}.self_attn.W_pack.weight"]
        h = w_pack.shape[1]
        if w_pack.shape[0] != 3 * h:
            raise ValueError(f"{p}.self_attn.W_pack is {list(w_pack.shape)}, not [3·{h}, {h}]")
        qkv = {name: {"w": put(w_pack[j * h:(j + 1) * h], transpose=True, shard=name)}
               for j, name in enumerate(("q_proj", "k_proj", "v_proj"))}
        layers.append(_llm_layer(put, p, qkv))
    head = put.shard(state["lm_head.weight"], "lm_head")  # [vocab, h]: the rank's rows
    norms = torch.from_numpy(np.maximum(_row_norms(head), np.float32(1e-7)))
    folded = head.to(device=put.device, copy=True).float() / norms.to(put.device)
    return {
        "embed_tokens": {"table": put("model.embed_tokens.weight")},
        "layers": layers,
        "final_ln": {"scale": put("model.norm.weight")},
        "lm_head": {"w": folded.to(dtype).t().contiguous()},
    }


def llm_config_from_hf(model_dir: str, lora_r: int = 16):
    """A qwen2.QwenConfig from a HF checkpoint's config.json: Qwen2/2.5,
    Llama-2 and Baichuan2 geometries (vocab, widths, GQA heads, rope theta,
    rms eps, tied embeddings, qkv bias)."""
    from affectgpt_tpu_torch.models import qwen2

    with open(os.path.join(model_dir, "config.json")) as handle:
        hf = json.load(handle)
    arch = (hf.get("architectures") or [""])[0]
    is_llama = "Llama" in arch or "Baichuan" in arch  # both families: no qkv bias
    heads = int(hf["num_attention_heads"])
    return qwen2.QwenConfig(
        vocab_size=int(hf["vocab_size"]),
        hidden_size=int(hf["hidden_size"]),
        intermediate_size=int(hf["intermediate_size"]),
        num_layers=int(hf["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads", heads)),
        head_dim=int(hf.get("head_dim", hf["hidden_size"] // heads)),
        rope_theta=float(hf.get("rope_theta", 10_000.0)),
        rms_eps=float(hf.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        qkv_bias=bool(hf.get("attention_bias", not is_llama)),
        lora_r=lora_r,
    )


def _clip_block(put: _Put, p: str) -> dict:
    return {
        "ln1": put.ln(f"{p}.layer_norm1"),
        "attn": {key: put.dense(f"{p}.self_attn.{name}")
                 for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                   ("o", "out_proj"))},
        "ln2": put.ln(f"{p}.layer_norm2"),
        "mlp_in": put.dense(f"{p}.mlp.fc1"),
        "mlp_out": put.dense(f"{p}.mlp.fc2"),
    }


def convert_clip_vision(model_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """HF CLIPModel vision tower + visual_projection → the clip_vit layout;
    the patch convolution [O, C, kH, kW] becomes the dense [C·kH·kW, O]."""
    state = _load_torch_state(model_dir)
    put = _Put(state, device, dtype)
    pre = "vision_model"
    conv = state[f"{pre}.embeddings.patch_embedding.weight"]
    n_layers = _count(state, pre + ".encoder.layers.{}.layer_norm1.weight")
    return {
        "patch_embed": {"w": put(conv.reshape(conv.shape[0], -1), transpose=True)},
        "class_embed": put(state[f"{pre}.embeddings.class_embedding"].reshape(-1)),
        "pos_embed": {"table": put(f"{pre}.embeddings.position_embedding.weight")},
        "pre_ln": put.ln(f"{pre}.pre_layrnorm"),
        "blocks": [_clip_block(put, f"{pre}.encoder.layers.{i}") for i in range(n_layers)],
        "post_ln": put.ln(f"{pre}.post_layernorm"),
        "proj": {"w": put("visual_projection.weight", transpose=True)},
    }


def convert_clip_text(model_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """HF CLIPModel text tower + text_projection → the clip_vit text layout."""
    state = _load_torch_state(model_dir)
    put = _Put(state, device, dtype)
    pre = "text_model"
    n_layers = _count(state, pre + ".encoder.layers.{}.layer_norm1.weight")
    return {
        "token_embed": {"table": put(f"{pre}.embeddings.token_embedding.weight")},
        "pos_embed": {"table": put(f"{pre}.embeddings.position_embedding.weight")},
        "blocks": [_clip_block(put, f"{pre}.encoder.layers.{i}") for i in range(n_layers)],
        "final_ln": put.ln(f"{pre}.final_layer_norm"),
        "proj": {"w": put("text_projection.weight", transpose=True)},
    }


def _pos_conv_weight(state) -> torch.Tensor:
    """HuBERT's positional conv weight, the weight norm materialized as
    w = g·v / max(‖v‖, 1e-12) in f32 numpy (‖v‖ over the out and in axes).
    The key names vary with the torch version that saved it: weight_g /
    weight_v, parametrizations.weight.original0 / original1, or a plain
    weight once the norm was removed."""
    base = "encoder.pos_conv_embed.conv"
    if f"{base}.weight_g" in state:
        g, v = state[f"{base}.weight_g"], state[f"{base}.weight_v"]
    elif f"{base}.parametrizations.weight.original0" in state:
        g = state[f"{base}.parametrizations.weight.original0"]
        v = state[f"{base}.parametrizations.weight.original1"]
    else:
        return state[f"{base}.weight"]
    g, v = g.float().numpy(), v.float().numpy()
    norm = np.linalg.norm(v, axis=(0, 1), keepdims=True)
    return torch.from_numpy(g * v / np.maximum(norm, np.float32(1e-12)))


def convert_hubert(model_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """HF HubertModel (large, stable layer norm) → the hubert layout."""
    state = _load_torch_state(model_dir)
    put = _Put(state, device, dtype)
    convs = []
    for i in range(_count(state, "feature_extractor.conv_layers.{}.conv.weight")):
        p = f"feature_extractor.conv_layers.{i}"
        w = put(f"{p}.conv.weight")  # [out, in, k]: the port's layout
        convs.append({
            "w": w,
            "b": put(f"{p}.conv.bias") if f"{p}.conv.bias" in state
            else torch.zeros(w.shape[0], dtype=dtype, device=put.device),
            "ln": put.ln(f"{p}.layer_norm"),
        })

    def layer(p: str) -> dict:
        return {
            "attn_ln": put.ln(f"{p}.layer_norm"),
            "attn": {key: put.dense(f"{p}.attention.{name}")
                     for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                       ("o", "out_proj"))},
            "ffn_ln": put.ln(f"{p}.final_layer_norm"),
            "ffn_in": put.dense(f"{p}.feed_forward.intermediate_dense"),
            "ffn_out": put.dense(f"{p}.feed_forward.output_dense"),
        }

    n_layers = _count(state, "encoder.layers.{}.layer_norm.weight")
    return {
        "convs": convs,
        "feat_proj_ln": put.ln("feature_projection.layer_norm"),
        "feat_proj": put.dense("feature_projection.projection"),
        "pos_conv": {"w": put(_pos_conv_weight(state)),
                     "b": put("encoder.pos_conv_embed.conv.bias")},
        "layers": [layer(f"encoder.layers.{i}") for i in range(n_layers)],
        "final_ln": put.ln("encoder.layer_norm"),
    }


def _patch_dense(put: _Put, prefix: str) -> dict:
    """A patch convolution [O, C, kH, kW] with its bias → the dense
    [C·kH·kW, O] the towers apply to channel-major patches."""
    conv = put(f"{prefix}.weight")
    return {"w": conv.reshape(conv.shape[0], -1).t().contiguous(), "b": put(f"{prefix}.bias")}


def convert_dinov2(model_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """HF Dinov2Model → the vit_variants DINOv2 layout."""
    state = _load_torch_state(model_dir)
    put = _Put(state, device, dtype)

    def block(p: str) -> dict:
        return {
            "ln1": put.ln(f"{p}.norm1"),
            "attn": {key: put.dense(f"{p}.attention.{name}")
                     for key, name in (("q", "attention.query"), ("k", "attention.key"),
                                       ("v", "attention.value"), ("o", "output.dense"))},
            "ls1": put(f"{p}.layer_scale1.lambda1"),
            "ln2": put.ln(f"{p}.norm2"),
            "mlp_in": put.dense(f"{p}.mlp.fc1"),
            "mlp_out": put.dense(f"{p}.mlp.fc2"),
            "ls2": put(f"{p}.layer_scale2.lambda1"),
        }

    n_layers = _count(state, "encoder.layer.{}.norm1.weight")
    return {
        "patch_embed": _patch_dense(put, "embeddings.patch_embeddings.projection"),
        "cls_token": put("embeddings.cls_token").reshape(-1),
        "pos_embed": {"table": put("embeddings.position_embeddings")[0]},
        "blocks": [block(f"encoder.layer.{i}") for i in range(n_layers)],
        "final_ln": put.ln("layernorm"),
    }


def convert_siglip_vision(model_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """HF SiglipVisionModel (or a SiglipModel's vision tower) → the
    vit_variants SigLIP layout (the attention-pool head is not read)."""
    state = _load_torch_state(model_dir)
    put = _Put(state, device, dtype)
    pre = "vision_model." if any(k.startswith("vision_model.") for k in state.keys()) else ""
    n_layers = _count(state, pre + "encoder.layers.{}.layer_norm1.weight")
    return {
        "patch_embed": _patch_dense(put, f"{pre}embeddings.patch_embedding"),
        "pos_embed": {"table": put(f"{pre}embeddings.position_embedding.weight")},
        "blocks": [_clip_block(put, f"{pre}encoder.layers.{i}") for i in range(n_layers)],
        "post_ln": put.ln(f"{pre}post_layernorm"),
    }


def convert_wavlm(model_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """HF WavLMModel (large, stable layer norm) → the wav_encoders WavLM
    layout: HuBERT's tree plus the relative-position embedding (layer 0's)
    and each layer's gate."""
    params = convert_hubert(model_dir, dtype=dtype, device=device)
    state = _load_torch_state(model_dir)
    put = _Put(state, device, dtype)
    params["rel_attn_embed"] = {
        "table": put("encoder.layers.0.attention.rel_attn_embed.weight")}
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.layers.{i}.attention"
        layer["gru_rel_pos_linear"] = put.dense(f"{p}.gru_rel_pos_linear")
        layer["gru_rel_pos_const"] = put(f"{p}.gru_rel_pos_const")
    return params


def convert_data2vec_audio(model_dir: str, dtype=torch.float32, device="cuda") -> dict:
    """HF Data2VecAudioModel → the wav_encoders data2vec layout."""
    state = _load_torch_state(model_dir)
    put = _Put(state, device, dtype)
    convs = []
    for i in range(_count(state, "feature_extractor.conv_layers.{}.conv.weight")):
        p = f"feature_extractor.conv_layers.{i}"
        w = put(f"{p}.conv.weight")  # [out, in, k]: the port's layout
        convs.append({
            "w": w,
            "b": put(f"{p}.conv.bias") if f"{p}.conv.bias" in state
            else torch.zeros(w.shape[0], dtype=dtype, device=put.device),
            "ln": put.ln(f"{p}.layer_norm"),
        })
    pos_convs = [{"w": put(f"encoder.pos_conv_embed.layers.{i}.conv.weight"),
                  "b": put(f"encoder.pos_conv_embed.layers.{i}.conv.bias")}
                 for i in range(_count(state, "encoder.pos_conv_embed.layers.{}.conv.weight"))]

    def layer(p: str) -> dict:
        return {
            "attn": {key: put.dense(f"{p}.attention.{name}")
                     for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                                       ("o", "out_proj"))},
            "attn_ln": put.ln(f"{p}.layer_norm"),
            "ffn_in": put.dense(f"{p}.feed_forward.intermediate_dense"),
            "ffn_out": put.dense(f"{p}.feed_forward.output_dense"),
            "ffn_ln": put.ln(f"{p}.final_layer_norm"),
        }

    n_layers = _count(state, "encoder.layers.{}.layer_norm.weight")
    return {
        "convs": convs,
        "feat_proj_ln": put.ln("feature_projection.layer_norm"),
        "feat_proj": put.dense("feature_projection.projection"),
        "pos_convs": pos_convs,
        "encoder_ln": put.ln("encoder.layer_norm"),
        "layers": [layer(f"encoder.layers.{i}") for i in range(n_layers)],
    }


# ---------------------------------------------------------------------------
# An assembled reference model


def convert_reference_affectgpt(state: dict, dtype=torch.float32, device="cuda") -> dict:
    """A reference `AffectGPT.state_dict()` (torch tensors or numpy arrays)
    → {"frozen": {"llm": ...}, "trainable": {...}} tensor trees.

    - `llama_model.base_model.model.model.*` → the frozen LLM (peft's
      `base_layer` weights), `...model.lm_head` → its head;
    - `...<proj>.lora_A/lora_B.default.weight` → LoRA (a = Aᵀ, b = Bᵀ);
    - `video_attention_mlp` + `affectgpt_proj` → the video merger, shared by
      the frame and face streams; `audio_*` → the audio merger;
      `image_llama_proj` / `au_*` → the image and AU mergers;
    - `multi_*` → the multi pre-fusion: `attention_mlp` + `fc_att` (the
      attention variant) or `multi_Qformer` (the Q-Former variant);
    - a `<group>_Qformer` (BLIP-2 BertLMHeadModel, query path only) with its
      query tokens and position table → a Q-Former merger.
    """
    put = _Put(state, device, dtype)
    llm_prefix = "llama_model.base_model.model.model"
    head_prefix = "llama_model.base_model.model"

    def base_dense(prefix):
        if f"{prefix}.base_layer.weight" in state:  # a LoRA-wrapped Linear
            key, bkey = f"{prefix}.base_layer.weight", f"{prefix}.base_layer.bias"
        else:
            key, bkey = f"{prefix}.weight", f"{prefix}.bias"
        out = {"w": put(key, transpose=True)}
        if bkey in state:
            out["b"] = put(bkey)
        return out

    def lora_leaf(prefix):
        return {"a": put(f"{prefix}.lora_A.default.weight", transpose=True),  # [r, in]ᵀ
                "b": put(f"{prefix}.lora_B.default.weight", transpose=True)}  # [out, r]ᵀ

    modules = (("q_proj", "self_attn"), ("k_proj", "self_attn"), ("v_proj", "self_attn"),
               ("o_proj", "self_attn"), ("gate_proj", "mlp"), ("up_proj", "mlp"),
               ("down_proj", "mlp"))
    layers, lora_layers = [], []
    for i in range(_count(state, llm_prefix + ".layers.{}.self_attn.q_proj.base_layer.weight")):
        p = f"{llm_prefix}.layers.{i}"
        layers.append({
            **{name: base_dense(f"{p}.{mod}.{name}") for name, mod in modules},
            "input_ln": {"scale": put(f"{p}.input_layernorm.weight")},
            "post_attn_ln": {"scale": put(f"{p}.post_attention_layernorm.weight")},
        })
        lora_layers.append({name: lora_leaf(f"{p}.{mod}.{name}") for name, mod in modules})
    llm = {
        "embed_tokens": {"table": put(f"{llm_prefix}.embed_tokens.weight")},
        "layers": layers,
        "final_ln": {"scale": put(f"{llm_prefix}.norm.weight")},
    }
    if f"{head_prefix}.lm_head.weight" in state:
        llm["lm_head"] = {"w": put(f"{head_prefix}.lm_head.weight", transpose=True)}

    def ref_qformer(prefix, query_key):
        """The BLIP-2 Q-Former's query path (Qformer.py BertLMHeadModel; the
        query FFN is `intermediate_query` / `output_query`) → the qformer
        tree."""
        qlayers = []
        for j in range(_count(state, prefix + ".bert.encoder.layer.{}.attention.self.query.weight")):
            p = f"{prefix}.bert.encoder.layer.{j}"
            qlayer = {
                "self_attn": {"q": put.dense(f"{p}.attention.self.query"),
                              "k": put.dense(f"{p}.attention.self.key"),
                              "v": put.dense(f"{p}.attention.self.value"),
                              "o": put.dense(f"{p}.attention.output.dense")},
                "self_ln": put.ln(f"{p}.attention.output.LayerNorm"),
                "ffn_in": put.dense(f"{p}.intermediate_query.dense"),
                "ffn_out": put.dense(f"{p}.output_query.dense"),
                "ffn_ln": put.ln(f"{p}.output_query.LayerNorm"),
            }
            if f"{p}.crossattention.self.query.weight" in state:
                qlayer["cross_attn"] = {"q": put.dense(f"{p}.crossattention.self.query"),
                                        "k": put.dense(f"{p}.crossattention.self.key"),
                                        "v": put.dense(f"{p}.crossattention.self.value"),
                                        "o": put.dense(f"{p}.crossattention.output.dense")}
                qlayer["cross_ln"] = put.ln(f"{p}.crossattention.output.LayerNorm")
            qlayers.append(qlayer)
        return {"query_tokens": put(query_key),
                "embed_ln": put.ln(f"{prefix}.bert.embeddings.LayerNorm"),
                "layers": qlayers}

    def merger_for(qformer_prefix, query_key, pos_key, attn_mlp_name, proj_name):
        if f"{qformer_prefix}.bert.embeddings.LayerNorm.weight" in state:
            return {"pos_embed": {"table": put(pos_key)},
                    "qformer": ref_qformer(qformer_prefix, query_key),
                    "proj": put.dense(proj_name)}
        out = {"proj": put.dense(proj_name)}
        if f"{attn_mlp_name}.weight" in state:
            out["attn_mlp"] = put.dense(attn_mlp_name)
        return out

    mergers = {
        "video": merger_for("video_Qformer", "video_query_tokens",
                            "video_frame_position_embedding.weight", "video_attention_mlp",
                            "affectgpt_proj"),
        "audio": merger_for("audio_Qformer", "audio_query_tokens",
                            "audio_position_embedding.weight", "audio_attention_mlp",
                            "audio_llama_proj"),
        "image": {"proj": put.dense("image_llama_proj")},
        "au": merger_for("au_Qformer", "au_query_tokens", "au_position_embedding.weight",
                         "au_attention_mlp", "au_llama_proj"),
    }
    trainable = {"mergers": mergers, "lora": {"layers": lora_layers}}
    if "multi_llama_proj.weight" in state:
        multi = {"video_embs": put.dense("multi_video_embs"),
                 "audio_embs": put.dense("multi_audio_embs"),
                 "proj": put.dense("multi_llama_proj")}
        if "multi_Qformer.bert.embeddings.LayerNorm.weight" in state:
            multi["pos_embed"] = {"table": put("multi_position_embedding.weight")}
            multi["qformer"] = ref_qformer("multi_Qformer", "multi_query_tokens")
        elif "attention_mlp.weight" in state:
            multi["attn_mlp"] = put.dense("attention_mlp")
            multi["fc_att"] = put.dense("fc_att")
        trainable["multi"] = multi
    return {"frozen": {"llm": llm}, "trainable": trainable}
