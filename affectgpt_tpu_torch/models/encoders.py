"""Frozen media encoders by registry name.

Port of affectgpt_tpu/models/encoders.py over a plain dict: each
`EncoderSpec` bundles a tower's output width, its config, its init, its HF
checkpoint conversion (models/convert.py) and its batch encode, so the
`visual_encoder: CLIP_VIT_LARGE` style YAML keys resolve as in JAX. encode():
visual [b, t, H, W, 3] normalized floats → [b, t, d]; acoustic
[b, clips, 1, samples] → [b, clips, d] (IMAGEBIND: mel clips [b, clips,
1, 128, 204] from ops/audio.transform_audio); EVA_CLIP_G gives its BLIP2
Q-Former's [b, t, 32, 768], which the mergers take as 4-D features. Every
tower of the JAX zoo is here: CLIP_VIT_LARGE, DINO2_LARGE, SigLIP_SO,
EVA_CLIP_G_NO_QFORMER and EVA_CLIP_G (visual), HUBERT_LARGE, WAVLM_LARGE,
IMAGEBIND and DATA2VEC_BASE (acoustic).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from affectgpt_tpu_torch.models import (clip_vit, eva_vit, hubert, imagebind_audio,
                                        vit_variants, wav_encoders)


@dataclass(frozen=True)
class EncoderSpec:
    name: str
    hidden_size: int
    make_config: Callable
    init_params: Callable  # (generator, cfg, dtype) -> params
    convert: Optional[Callable]  # (model_dir, dtype=, device=) -> params
    encode: Callable  # (params, cfg, batch) -> features
    # pixel-normalization scheme of the tower's own image processor
    # (ops/image.NORM_STATS); acoustic specs ignore it
    normalize: str = "clip"


def _converter(name: str) -> Callable:
    """models.convert's `name`, imported when called (convert imports this
    module)."""
    def fn(model_dir, **kwargs):
        from affectgpt_tpu_torch.models import convert

        return getattr(convert, name)(model_dir, **kwargs)

    return fn


def _encode_frames(encode_one):
    def fn(params, cfg, frames):  # [b, t, H, W, 3]
        b, t = frames.shape[:2]
        out = encode_one(params, cfg, frames.reshape(b * t, *frames.shape[2:]))
        return out.reshape(b, t, -1)

    return fn


def _encode_frames_blip2(params, cfg, frames):
    """EVA_CLIP_G: [b, t, H, W, 3] → [b, t, 32, 768] (reference
    encoder.py:43-122). params = {"vit": ..., "head": ...}."""
    b, t = frames.shape[:2]
    out = eva_vit.encode_blip2(params["vit"], params["head"], cfg,
                               frames.reshape(b * t, *frames.shape[2:]))
    return out.reshape(b, t, out.shape[-2], out.shape[-1])


def _init_eva_blip2(generator, cfg, dtype=torch.bfloat16):
    return {"vit": eva_vit.init_params(generator, cfg, dtype),
            "head": eva_vit.init_blip2_head(generator, cfg, dtype=dtype)}


VISUAL = {
    "CLIP_VIT_LARGE": EncoderSpec(
        name="CLIP_VIT_LARGE",
        hidden_size=768,  # projection dim (reference encoder.py:193)
        make_config=clip_vit.ClipVisionConfig.vit_l_14,
        init_params=clip_vit.init_vision_params,
        convert=_converter("convert_clip_vision"),
        encode=_encode_frames(clip_vit.encode_image),
    ),
    "DINO2_LARGE": EncoderSpec(
        name="DINO2_LARGE",
        hidden_size=1024,  # reference encoder.py:229
        make_config=vit_variants.Dinov2Config.large,
        init_params=vit_variants.init_dinov2_params,
        convert=_converter("convert_dinov2"),
        encode=_encode_frames(vit_variants.dinov2_encode),
        normalize="imagenet",
    ),
    "SigLIP_SO": EncoderSpec(
        name="SigLIP_SO",
        hidden_size=1152,  # reference encoder.py:262
        make_config=vit_variants.SiglipConfig.so400m,
        init_params=vit_variants.init_siglip_params,
        convert=_converter("convert_siglip_vision"),
        encode=_encode_frames(vit_variants.siglip_encode),
        normalize="siglip",
    ),
    "EVA_CLIP_G_NO_QFORMER": EncoderSpec(
        name="EVA_CLIP_G_NO_QFORMER",
        hidden_size=1408,  # reference encoder.py:123-176
        make_config=eva_vit.EvaVitConfig.vit_g_14,
        init_params=eva_vit.init_params,
        convert=None,  # EVA ships raw state dicts: eva_vit.convert_eva_state
        encode=_encode_frames(eva_vit.encode_mean),
    ),
    "EVA_CLIP_G": EncoderSpec(
        name="EVA_CLIP_G",
        hidden_size=768,  # the BLIP2 Q-Former's width
        make_config=eva_vit.EvaVitConfig.vit_g_14,
        init_params=_init_eva_blip2,
        convert=None,
        encode=_encode_frames_blip2,
    ),
}
ACOUSTIC = {
    "HUBERT_LARGE": EncoderSpec(
        name="HUBERT_LARGE",
        hidden_size=1024,
        make_config=hubert.HubertConfig.large,
        init_params=hubert.init_params,
        convert=_converter("convert_hubert"),
        encode=hubert.encode_clips,
    ),
    "WAVLM_LARGE": EncoderSpec(
        name="WAVLM_LARGE",
        hidden_size=1024,
        make_config=wav_encoders.WavLMConfig.large,
        init_params=wav_encoders.init_wavlm_params,
        convert=_converter("convert_wavlm"),
        encode=wav_encoders.wavlm_encode_clips,
    ),
    "IMAGEBIND": EncoderSpec(
        name="IMAGEBIND",
        hidden_size=1024,  # the projected embedding (reference imagebind_model.py:541)
        make_config=imagebind_audio.ImageBindAudioConfig.huge,
        init_params=imagebind_audio.init_params,
        convert=None,  # raw .pth state dicts: imagebind_audio.convert_imagebind_audio
        encode=imagebind_audio.encode_clips,  # mel clips, not raw audio
    ),
    "DATA2VEC_BASE": EncoderSpec(
        name="DATA2VEC_BASE",
        hidden_size=768,
        make_config=wav_encoders.Data2VecAudioConfig.base,
        init_params=wav_encoders.init_data2vec_params,
        convert=_converter("convert_data2vec_audio"),
        encode=wav_encoders.data2vec_encode_clips,
    ),
}


def _get(table: dict, kind: str, name: str) -> EncoderSpec:
    if name in table:
        return table[name]
    raise KeyError(f"unknown {kind} {name!r}")


def get_visual_encoder(name: str) -> EncoderSpec:
    return _get(VISUAL, "visual encoder", name)


def get_acoustic_encoder(name: str) -> EncoderSpec:
    return _get(ACOUSTIC, "acoustic encoder", name)
