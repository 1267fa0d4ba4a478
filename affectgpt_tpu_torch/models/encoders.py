"""Frozen media encoders by registry name.

Port of affectgpt_tpu/models/encoders.py over a plain dict: each
`EncoderSpec` bundles a tower's output width, its config, its init, its HF
checkpoint conversion (models/convert.py) and its batch encode, so the
`visual_encoder: CLIP_VIT_LARGE` style YAML keys resolve as in JAX. encode():
visual [b, t, H, W, 3] normalized floats → [b, t, d]; acoustic
[b, clips, 1, samples] → [b, clips, d]. The port has CLIP_VIT_LARGE and
HUBERT_LARGE; the other towers of the JAX zoo raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from affectgpt_tpu_torch.models import clip_vit, hubert


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


VISUAL = {
    "CLIP_VIT_LARGE": EncoderSpec(
        name="CLIP_VIT_LARGE",
        hidden_size=768,  # projection dim (reference encoder.py:193)
        make_config=clip_vit.ClipVisionConfig.vit_l_14,
        init_params=clip_vit.init_vision_params,
        convert=_converter("convert_clip_vision"),
        encode=_encode_frames(clip_vit.encode_image),
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
}
# the rest of the JAX zoo, not ported yet
_NOT_PORTED = ("DINO2_LARGE", "SigLIP_SO", "EVA_CLIP_G_NO_QFORMER", "EVA_CLIP_G",
               "WAVLM_LARGE", "IMAGEBIND", "DATA2VEC_BASE")


def _get(table: dict, kind: str, name: str) -> EncoderSpec:
    if name in table:
        return table[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to PyTorch yet (ROADMAP queue 1 item 12)")
    raise KeyError(f"unknown {kind} {name!r}")


def get_visual_encoder(name: str) -> EncoderSpec:
    return _get(VISUAL, "visual encoder", name)


def get_acoustic_encoder(name: str) -> EncoderSpec:
    return _get(ACOUSTIC, "acoustic encoder", name)
