"""Model bootstrap for the PyTorch port.

Port of affectgpt_tpu/bootstrap.py for the preextracted serving path:
resolve the tokenizer, build the model config from the YAML `model:`
section given as a plain dict (affectgpt_tpu.config needs PyYAML, which the
port does not), and make random weights from a seed on the chosen device.

Not ported yet: the media encoders, HF checkpoint conversion and the
checkpoint overlays (`ckpt`, `ckpt_2`, `ckpt_3`); a node that asks for
them raises NotImplementedError.
"""

from __future__ import annotations

import logging
import os
from dataclasses import replace
from typing import Tuple

import torch

from affectgpt_tpu import paths
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch.models import affectgpt, qwen2

logger = logging.getLogger(__name__)


def _llm_name(node: dict) -> str:
    return node.get("llama_model", node.get("llama_model_name", node.get("llm_name", "Qwen25")))


def build_model(
    model_node: dict,
    device="cpu",
    dtype=torch.bfloat16,
    seed: int = 0,
) -> Tuple[affectgpt.AffectGPTConfig, dict, dict, object]:
    """Returns (model_cfg, frozen, trainable, tokenizer). Without the LLM's
    directory the tokenizer is the ByteTokenizer and the LLM shrinks to the
    tiny geometry unless `keep_full_llm` is set; the weights are random,
    drawn from `seed` (frozen) and `seed + 1` (trainable)."""
    node = dict(model_node or {})
    for key in ("ckpt", "ckpt_2", "ckpt_3"):
        if node.get(key):
            raise NotImplementedError(f"checkpoint overlay {key!r} is not ported to PyTorch yet")
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
    trainable = affectgpt.init_trainable(
        torch.Generator(device=device).manual_seed(seed + 1), model_cfg)
    return model_cfg, frozen, trainable, tokenizer


def serving_llm(frozen: dict, trainable: dict, cfg: affectgpt.AffectGPTConfig):
    """Fold the LoRA adapters into the LLM weights for serving, as
    inference_hybird.py does: returns (frozen, trainable) with merged weights
    and trainable["lora"] = None, so decode runs the fused kernels."""
    if trainable.get("lora") is None:
        return frozen, trainable
    llm = qwen2.merge_lora(frozen["llm"], trainable["lora"], cfg.llm)
    return {**frozen, "llm": llm}, {**trainable, "lora": None}
