"""Model bootstrap for the PyTorch port.

Port of affectgpt_tpu/bootstrap.py: resolve the tokenizer, build the model
config from the YAML `model:` section given as a plain dict (a
`config.Config`'s `cfg.model.to_dict()`, as the runner's entry point passes
it), and make
random weights from a seed on the chosen device: the LLM and, with
`with_encoders` (the realtime path), the CLIP ViT-L/14 and HuBERT-large
towers; `model.int8` quantizes the LLM's projections to per-channel int8.
The trainable tree takes the checkpoint overlays `ckpt`, `ckpt_2`, `ckpt_3`
(`training.checkpoint.apply_checkpoint_overlays`, the port's torch-format
checkpoints).

Not ported yet: HF checkpoint conversion (of the LLM and of the encoders);
a node that names a model directory that exists raises
NotImplementedError.
"""

from __future__ import annotations

import logging
import os
from dataclasses import replace
from typing import Tuple

import torch

from affectgpt_tpu_torch import paths
from affectgpt_tpu_torch.models import affectgpt, clip_vit, encoders, hubert, qwen2
from affectgpt_tpu_torch.tokenization import ByteTokenizer
from affectgpt_tpu_torch.training import checkpoint

logger = logging.getLogger(__name__)


def _llm_name(node: dict) -> str:
    return node.get("llama_model", node.get("llama_model_name", node.get("llm_name", "Qwen25")))


def build_model(
    model_node: dict,
    with_encoders: bool = False,
    device="cuda",
    dtype=torch.bfloat16,
    seed: int = 0,
) -> Tuple[affectgpt.AffectGPTConfig, dict, dict, object]:
    """Returns (model_cfg, frozen, trainable, tokenizer). Without the LLM's
    directory the tokenizer is the ByteTokenizer and the LLM shrinks to the
    tiny geometry unless `keep_full_llm` is set; the weights are random,
    drawn from `seed` (frozen) and `seed + 1` (trainable), on the card
    unless `device` says otherwise (there is no fallback to the CPU).

    with_encoders (unless the node sets `skip_encoders`) adds the
    `visual_encoder` and `acoustic_encoder` towers the node names, drawn
    from `seed + 2`: at their registry geometry with `keep_full_llm`, else
    shrunk to the tiny CLIP and HuBERT with projection_dim = visual_dim and
    hidden_size = acoustic_dim, recorded in the config's overrides. The
    node's `ckpt`, `ckpt_2` and `ckpt_3` overlay the trainable tree in that
    order."""
    node = dict(model_node or {})
    llm_dir = paths.PATH_TO_LLM.get(_llm_name(node), "")
    if llm_dir and os.path.isdir(llm_dir):
        raise NotImplementedError(
            f"loading the HF checkpoint in {llm_dir} is not ported to PyTorch yet"
        )
    logger.warning("LLM dir %s not found — using ByteTokenizer (random-weight mode)", llm_dir)
    tokenizer = ByteTokenizer()
    model_cfg = affectgpt.AffectGPTConfig.from_model_cfg(node)
    if not node.get("keep_full_llm", False):
        model_cfg = replace(model_cfg, llm=qwen2.QwenConfig.tiny(
            vocab_size=max(tokenizer.vocab_size, 300), lora_r=model_cfg.llm.lora_r))

    device = torch.device(device)
    frozen = affectgpt.init_frozen(
        torch.Generator(device=device).manual_seed(seed), model_cfg, dtype=dtype)
    if with_encoders and not node.get("skip_encoders", False):
        vis_spec = encoders.get_visual_encoder(model_cfg.visual_encoder_name)
        aud_spec = encoders.get_acoustic_encoder(model_cfg.acoustic_encoder_name)
        for table, spec in ((paths.PATH_TO_VISUAL, vis_spec), (paths.PATH_TO_AUDIO, aud_spec)):
            model_dir = table.get(spec.name, "")
            if model_dir and os.path.isdir(model_dir):
                raise NotImplementedError(
                    f"loading the HF checkpoint in {model_dir} is not ported to PyTorch yet")
        if node.get("keep_full_llm", False):
            vis_cfg, aud_cfg = vis_spec.make_config(), aud_spec.make_config()
        else:  # random-weight smoke mode: tiny towers with the mergers' input widths
            vis_cfg = replace(clip_vit.ClipVisionConfig.tiny(), projection_dim=model_cfg.visual_dim)
            aud_cfg = replace(hubert.HubertConfig.tiny(), hidden_size=model_cfg.acoustic_dim)
            model_cfg = replace(model_cfg, vision_cfg_override=vis_cfg, audio_cfg_override=aud_cfg)
        generator = torch.Generator(device=device).manual_seed(seed + 2)
        frozen["visual_encoder"] = vis_spec.init_params(generator, vis_cfg, dtype)
        frozen["acoustic_encoder"] = aud_spec.init_params(generator, aud_cfg, dtype)
    if node.get("int8", False):  # serving mode: per-channel int8 decoder weights
        frozen["llm"] = qwen2.quantize_params(frozen["llm"])
    trainable = affectgpt.init_trainable(
        torch.Generator(device=device).manual_seed(seed + 1), model_cfg)
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
