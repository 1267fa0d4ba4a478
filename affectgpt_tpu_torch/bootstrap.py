"""Model bootstrap for the PyTorch port.

Port of affectgpt_tpu/bootstrap.py: resolve the tokenizer, build the model
config from the YAML `model:` section given as a plain dict (a
`config.Config`'s `cfg.model.to_dict()`, as the entry points pass it), and
make the weights on the chosen device. Where the LLM's directory
(`paths.PATH_TO_LLM`) exists, the tokenizer is its own
(`tokenization.load_tokenizer`) and the LLM is converted from its HF
checkpoint (models/convert.py: `convert_baichuan2` for Baichuan2, else
`convert_qwen2`); with `with_encoders`, each tower whose directory
(`PATH_TO_VISUAL`, `PATH_TO_AUDIO`) exists goes through its spec's
`convert`. The geometry stays the preset's (`AffectGPTConfig.
from_model_cfg`), and the loaded trees are held to it
(`convert.check_trees`, which raises on a mismatch). What no directory
holds is drawn at random from a seed: without the LLM's directory the
tokenizer is the ByteTokenizer and the LLM shrinks to the tiny geometry
unless `keep_full_llm` is set. `model.int8` then quantizes the LLM's
projections to per-channel int8, and the trainable tree takes the
checkpoint overlays `ckpt`, `ckpt_2`, `ckpt_3`
(`training.checkpoint.apply_checkpoint_overlays`, the port's torch-format
checkpoints). Under a tensor-parallel `layout` the LLM is this rank's
shard (a model directory is read a slice at a time by the converters) and
the config's LLM is the rank's (`mesh.shard_config`).
"""

from __future__ import annotations

import logging
import os
from dataclasses import replace
from typing import Tuple

import torch

from affectgpt_tpu_torch import paths
from affectgpt_tpu_torch.models import affectgpt, clip_vit, convert, encoders, hubert, qwen2
from affectgpt_tpu_torch.parallel import mesh
from affectgpt_tpu_torch.tokenization import ByteTokenizer, load_tokenizer
from affectgpt_tpu_torch.training import checkpoint

logger = logging.getLogger(__name__)


def _llm_name(node: dict) -> str:
    return node.get("llama_model", node.get("llama_model_name", node.get("llm_name", "Qwen25")))


def _model_dir(table: dict, name: str) -> str:
    """The table's directory for `name`, or "" when it does not exist."""
    path = table.get(name, "")
    return path if path and os.path.isdir(path) else ""


def build_tokenizer(model_node: dict):
    """The LLM's own tokenizer when its directory exists, else the
    ByteTokenizer (the random-weight mode)."""
    llm_name = _llm_name(model_node or {})
    if _model_dir(paths.PATH_TO_LLM, llm_name):
        return load_tokenizer(llm_name)
    logger.warning("LLM dir %s not found — using ByteTokenizer (random-weight mode)",
                   paths.PATH_TO_LLM.get(llm_name, ""))
    return ByteTokenizer()


def build_tower(key: str, spec: encoders.EncoderSpec, tower_cfg, generator: torch.Generator,
                dtype=torch.bfloat16, device="cuda") -> dict:
    """The `key` tower ("visual_encoder" or "acoustic_encoder") that `spec`
    names: converted through `spec.convert` from its directory in
    PATH_TO_VISUAL / PATH_TO_AUDIO when that exists, and held to
    tower_cfg's geometry (ValueError on a mismatch); else drawn from
    `generator` at tower_cfg."""
    table = paths.PATH_TO_VISUAL if key == "visual_encoder" else paths.PATH_TO_AUDIO
    tower_dir = _model_dir(table, spec.name)
    if tower_dir and spec.convert is not None:
        logger.info("Converting %s weights from %s", spec.name, tower_dir)
        return convert.check_tower(key, spec.convert(tower_dir, dtype=dtype, device=device),
                                   tower_cfg)
    logger.warning("%s dir %s not found — random init", spec.name, table.get(spec.name, ""))
    return spec.init_params(generator, tower_cfg, dtype)


def build_model(
    model_node: dict,
    with_encoders: bool = False,
    device="cuda",
    dtype=torch.bfloat16,
    seed: int = 0,
    layout=None,
) -> Tuple[affectgpt.AffectGPTConfig, dict, dict, object]:
    """Returns (model_cfg, frozen, trainable, tokenizer), on the card unless
    `device` says otherwise (there is no fallback to the CPU). The LLM is
    loaded from its directory when it exists, else drawn from `seed`; the
    trainable tree is drawn from `seed + 1`.

    with_encoders (unless the node sets `skip_encoders`) adds the
    `visual_encoder` and `acoustic_encoder` towers the node names, each
    loaded from its directory or drawn from `seed + 2`: at their registry
    geometry unless the LLM is tiny, else shrunk to the tiny CLIP and HuBERT
    with projection_dim = visual_dim and hidden_size = acoustic_dim,
    recorded in the config's overrides. The node's `ckpt`, `ckpt_2` and
    `ckpt_3` overlay the trainable tree in that order.

    layout: a tp layout of `parallel.mesh`; the LLM comes back as this
    rank's shard and model_cfg.llm as its shard config (the trainable tree,
    LoRA included, stays whole, as checkpoints hold it: the decoder reads a
    whole LoRA at its rank's slices). A model directory is read a slice at
    a time; random weights are drawn whole from the seed (the same on every
    rank) and then sliced."""
    node = dict(model_node or {})
    tokenizer = build_tokenizer(node)
    model_cfg = affectgpt.AffectGPTConfig.from_model_cfg(node)
    tiny = isinstance(tokenizer, ByteTokenizer) and not node.get("keep_full_llm", False)
    if tiny:  # the node's LoRA dropout stays (JAX bootstrap.py:52-59 drops it)
        model_cfg = replace(model_cfg, llm=replace(qwen2.QwenConfig.tiny(
            vocab_size=max(tokenizer.vocab_size, 300), lora_r=model_cfg.llm.lora_r),
            lora_dropout=model_cfg.llm.lora_dropout))

    device = torch.device(device)
    llm_name = _llm_name(node)
    llm_dir = _model_dir(paths.PATH_TO_LLM, llm_name)
    if llm_dir:
        logger.info("Converting LLM weights from %s", llm_dir)
        llm_convert = convert.convert_baichuan2 if llm_name == "Baichuan2" else \
            convert.convert_qwen2
        frozen = {"llm": llm_convert(llm_dir, dtype=dtype, device=device, layout=layout,
                                     cfg=model_cfg.llm)}
    else:
        frozen = affectgpt.init_frozen(
            torch.Generator(device=device).manual_seed(seed), model_cfg, dtype=dtype)
        if layout is not None:
            frozen["llm"] = mesh.shard_params(frozen["llm"], layout, model_cfg.llm, "llm/")
    if with_encoders and not node.get("skip_encoders", False):
        vis_spec = encoders.get_visual_encoder(model_cfg.visual_encoder_name)
        aud_spec = encoders.get_acoustic_encoder(model_cfg.acoustic_encoder_name)
        if tiny:  # random-weight smoke mode: tiny towers with the mergers' input widths
            vis_cfg = replace(clip_vit.ClipVisionConfig.tiny(), projection_dim=model_cfg.visual_dim)
            aud_cfg = replace(hubert.HubertConfig.tiny(), hidden_size=model_cfg.acoustic_dim)
            model_cfg = replace(model_cfg, vision_cfg_override=vis_cfg, audio_cfg_override=aud_cfg)
        else:
            vis_cfg, aud_cfg = vis_spec.make_config(), aud_spec.make_config()
        generator = torch.Generator(device=device).manual_seed(seed + 2)
        frozen["visual_encoder"] = build_tower("visual_encoder", vis_spec, vis_cfg, generator,
                                               dtype, device)
        frozen["acoustic_encoder"] = build_tower("acoustic_encoder", aud_spec, aud_cfg,
                                                 generator, dtype, device)
    trainable = affectgpt.init_trainable(
        torch.Generator(device=device).manual_seed(seed + 1), model_cfg)
    if layout is not None:
        model_cfg = replace(model_cfg, llm=mesh.shard_config(model_cfg.llm, layout))
    convert.check_trees(frozen, trainable, model_cfg)
    if node.get("int8", False):  # serving mode: per-channel int8 decoder weights
        frozen["llm"] = qwen2.quantize_params(frozen["llm"], cfg=model_cfg.llm)
    trainable = checkpoint.apply_checkpoint_overlays(
        trainable, node.get("ckpt"), node.get("ckpt_2"), node.get("ckpt_3"))
    return model_cfg, frozen, trainable, tokenizer


def serving_llm(frozen: dict, trainable: dict, cfg: affectgpt.AffectGPTConfig):
    """Fold the LoRA adapters into the LLM weights for serving, as
    inference_hybird.py does: returns (frozen, trainable) with merged weights
    and trainable["lora"] = None, so decode runs the fused kernels."""
    if trainable.get("lora") is None:
        return frozen, trainable
    llm = qwen2.merge_lora(frozen["llm"], trainable["lora"], cfg.llm)
    return {**frozen, "llm": llm}, {**trainable, "lora": None}
