"""AffectGPT over preextracted features, in PyTorch.

Port of affectgpt_tpu/models/affectgpt.py for the serving path: modality
features [b, t, d] → temporal mergers (+ audio-video pre-fusion) → splice
into the prompt embeddings. Parameters are split as in the JAX package into
`frozen` (the LLM) and `trainable` (LoRA, mergers, pre-fusion) trees.

Not ported yet: the media encoders (`with_encoders`) and `forward_loss`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import torch

from affectgpt_tpu_torch.models import mergers, qwen2, splice


@dataclass(frozen=True)
class AffectGPTConfig:
    llm: qwen2.QwenConfig = field(default_factory=qwen2.QwenConfig.qwen25_7b)
    video_fusion_type: str = "attention"
    audio_fusion_type: str = "attention"
    multi_fusion_type: str = "attention"
    au_fusion_type: str = "mean"
    image_fusion_type: str = "mean"
    num_video_query_token: int = 8
    num_audio_query_token: int = 8
    num_multi_query_token: int = 1
    num_image_query_token: int = 8
    num_au_query_token: int = 8
    visual_dim: int = 768
    acoustic_dim: int = 1024
    au_dim: int = 512
    video_max_time: int = 32
    audio_max_time: int = 8
    au_max_time: int = 32
    multi_max_time: int = 264
    use_multi: bool = True
    visual_encoder_name: str = "CLIP_VIT_LARGE"
    acoustic_encoder_name: str = "HUBERT_LARGE"
    # encoder geometry overrides of the JAX config; the encoders are not
    # ported yet, so these stay None here
    vision_cfg_override: Optional[object] = None
    audio_cfg_override: Optional[object] = None

    @classmethod
    def from_model_cfg(cls, node: dict) -> "AffectGPTConfig":
        """Build from the YAML `model:` section as a plain dict (same knob
        names as the reference train configs)."""
        node = dict(node or {})
        llm_name = node.get(
            "llama_model", node.get("llama_model_name", node.get("llm_name", "Qwen25"))
        )
        presets = {
            "Qwen25": qwen2.QwenConfig.qwen25_7b,
            "Qwen25_3B": lambda **kw: qwen2.QwenConfig(
                vocab_size=151936, hidden_size=2048, intermediate_size=11008,
                num_layers=36, num_heads=16, num_kv_heads=2, head_dim=128,
                tie_embeddings=True, **kw,
            ),
            "Llama2": qwen2.QwenConfig.llama2_7b,
            "Baichuan2": qwen2.QwenConfig.baichuan2_7b,
            "tiny": qwen2.QwenConfig.tiny,
        }
        llm_kwargs = {}
        if "lora_r" in node:
            llm_kwargs["lora_r"] = int(node["lora_r"])
        llm = presets.get(llm_name, qwen2.QwenConfig.qwen25_7b)(**llm_kwargs)
        if "lora_dropout" in node:
            llm = replace(llm, lora_dropout=float(node["lora_dropout"]))
        return cls(
            llm=llm,
            video_fusion_type=node.get("video_fusion_type", "attention"),
            audio_fusion_type=node.get("audio_fusion_type", "attention"),
            multi_fusion_type=node.get("multi_fusion_type", "attention"),
            au_fusion_type=node.get("au_fusion_type", "mean"),
            image_fusion_type=node.get("image_fusion_type", "mean"),
            num_video_query_token=int(node.get("num_video_query_token", 8)),
            num_audio_query_token=int(node.get("num_audio_query_token", 8)),
            num_multi_query_token=int(node.get("num_multi_query_token", 1)),
            num_image_query_token=int(node.get("num_image_query_token", 8)),
            num_au_query_token=int(node.get("num_au_query_token", 8)),
            visual_dim=int(node.get("preextracted_visual_dim", 768)),
            acoustic_dim=int(node.get("preextracted_acoustic_dim", 1024)),
            au_dim=int(node.get("preextracted_au_dim", 512)),
            visual_encoder_name=node.get(
                "visual_encoder", node.get("visual_encoder_name", "CLIP_VIT_LARGE")
            ),
            acoustic_encoder_name=node.get(
                "acoustic_encoder", node.get("acoustic_encoder_name", "HUBERT_LARGE")
            ),
        )

    @classmethod
    def tiny(cls):
        return cls(
            llm=qwen2.QwenConfig.tiny(),
            num_video_query_token=2, num_audio_query_token=2,
            num_multi_query_token=1, num_image_query_token=2, num_au_query_token=2,
            visual_dim=12, acoustic_dim=16, au_dim=8,
        )

    def merger_config(self, modality: str) -> mergers.MergerConfig:
        llm_dim = self.llm.hidden_size
        if modality in ("frame", "face"):
            return mergers.MergerConfig(self.video_fusion_type, self.visual_dim,
                                        llm_dim, self.num_video_query_token, self.video_max_time)
        if modality == "audio":
            return mergers.MergerConfig(self.audio_fusion_type, self.acoustic_dim,
                                        llm_dim, self.num_audio_query_token, self.audio_max_time)
        if modality == "au":
            return mergers.MergerConfig(self.au_fusion_type, self.au_dim,
                                        llm_dim, self.num_au_query_token, self.au_max_time)
        if modality == "image":
            return mergers.MergerConfig(self.image_fusion_type, self.visual_dim,
                                        llm_dim, self.num_image_query_token, self.video_max_time)
        raise ValueError(modality)

    def multi_config(self) -> mergers.MultiFusionConfig:
        return mergers.MultiFusionConfig(
            self.multi_fusion_type, self.visual_dim, self.acoustic_dim,
            self.llm.hidden_size, self.num_multi_query_token, self.multi_max_time,
        )

    def num_query_tokens(self, modality: str) -> int:
        return {
            "frame": self.num_video_query_token,
            "face": self.num_video_query_token,
            "audio": self.num_audio_query_token,
            "multi": self.num_multi_query_token,
            "image": self.num_image_query_token,
            "au": self.num_au_query_token,
        }[modality]


MODALITIES = ("frame", "face", "audio", "image", "au")

# frame and face share one video merger, as in the reference
# (affectgpt.py:929-932)
MERGER_GROUP = {
    "frame": "video", "face": "video",
    "audio": "audio", "image": "image", "au": "au",
}
_GROUPS = ("video", "audio", "image", "au")
_GROUP_CFG_MODALITY = {"video": "frame", "audio": "audio", "image": "image", "au": "au"}


def init_trainable(generator: torch.Generator, cfg: AffectGPTConfig,
                   dtype=torch.float32) -> dict:
    """LoRA + mergers + projections, on the generator's device."""
    params: dict = {
        "mergers": {
            g: mergers.init_merger(generator, cfg.merger_config(_GROUP_CFG_MODALITY[g]),
                                   dtype=dtype)
            for g in _GROUPS
        },
        "lora": qwen2.init_lora(generator, cfg.llm, dtype=dtype),
    }
    if cfg.use_multi:
        params["multi"] = mergers.init_multi_fusion(generator, cfg.multi_config(), dtype=dtype)
    return params


def init_frozen(generator: torch.Generator, cfg: AffectGPTConfig,
                dtype=torch.bfloat16) -> dict:
    """Frozen base params: the LLM (preextracted mode, no media encoders)."""
    return {"llm": qwen2.init_params(generator, cfg.llm, dtype=dtype)}


def encode_modalities(trainable: dict, cfg: AffectGPTConfig,
                      features: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-modality [b, t, d] features → LLM-space blocks [b, q_m, llm_dim],
    plus the pre-fusion 'multi' block (face preferred over frame)."""
    blocks: Dict[str, torch.Tensor] = {}
    for m in MODALITIES:
        if m in features:
            blocks[m] = mergers.apply_merger(
                trainable["mergers"][MERGER_GROUP[m]], cfg.merger_config(m), features[m]
            )
    if cfg.use_multi and "multi" in trainable and "audio" in features:
        video_hidden = features.get("face", features.get("frame"))
        if video_hidden is not None:
            blocks["multi"] = mergers.apply_multi_fusion(
                trainable["multi"], cfg.multi_config(), video_hidden, features["audio"]
            )
    return blocks


def build_inputs_embeds(frozen: dict, trainable: dict, cfg: AffectGPTConfig,
                        input_ids: torch.Tensor, features: Dict[str, torch.Tensor],
                        offsets: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token ids (patch ids zeroed host-side) + modality features → spliced
    embedding sequence [b, t, d]; offsets[m] [b] start positions (-1 = absent)."""
    embeds = qwen2.embed_tokens(frozen["llm"], input_ids)
    for m, block in encode_modalities(trainable, cfg, features).items():
        if m in offsets:
            embeds = splice.splice_embeddings(embeds, block, offsets[m])
    return embeds
