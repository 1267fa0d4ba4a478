"""Chat: batched clip → text, in PyTorch.

Port of affectgpt_tpu/inference/chat.py (`encode_media_features`,
`Chat.build_prompt_batch` and `Chat.answer_batch`): on the realtime path
`encode_media_features` turns raw frames, face crops and audio clips into
features on the device (preprocessing, then the towers the config names:
CLIP ViT-L/14 and HuBERT-large by default, any tower of models/encoders.py); on the
preextracted path the features come from a cache. Prompt assembly and
tokenization use the port's own copies of the host modules (`constants`,
`prompts`, `tokenization`), then mergers → splice → prefill → decode run in
the port. Greedy requests without a repetition penalty take prompt-lookup
speculative decoding when `speculative_draft_len` > 0.

`layout=` (JAX's `Chat.mesh`, chat.py:84, :110-116): the LLM sharded over the
layout's tp groups (`parallel.mesh.shard_model`), each batch split over its
dp groups by `generate`, and every rank given back the whole batch's
answers; `encode_media_features(layout=)` runs the towers batch-parallel
over the dp groups. Every rank calls with the same inputs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from affectgpt_tpu_torch import constants, prompts
from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.models import affectgpt, clip_vit, encoders, hubert, splice
from affectgpt_tpu_torch.ops import image as image_ops
from affectgpt_tpu_torch.parallel import mesh
from affectgpt_tpu_torch.tokenization import encode_batch


def prepare_frames(frames: torch.Tensor, image_size: int, normalize: str) -> torch.Tensor:
    """[b, T, H, W, 3] uint8 → [b, T, S, S, 3] float32: the eval transform
    (resize + the tower's processor stats) over the flattened [b·T] batch."""
    b, t = frames.shape[:2]
    prepped = image_ops.preprocess_frames_eval(  # [C, b·T, S, S]
        frames.reshape(b * t, *frames.shape[2:]), out_size=image_size, normalize=normalize)
    return prepped.permute(1, 2, 3, 0).reshape(b, t, *prepped.shape[2:], -1)


def encode_media_features(
    frozen: dict,
    cfg: Optional[affectgpt.AffectGPTConfig],
    raw: Dict[str, torch.Tensor],
    vision_cfg: Optional[clip_vit.ClipVisionConfig] = None,
    audio_cfg: Optional[hubert.HubertConfig] = None,
    layout: Optional[mesh.Layout] = None,
) -> Dict[str, torch.Tensor]:
    """Raw media on the device → per-modality [b, t, d] features through the
    frozen encoders the config names (the realtime path; reference
    encoder.py forward wrappers). raw: frame / face / image [b, T, H, W, 3]
    uint8, audio [b, clips, 1, samples] (IMAGEBIND: mel clips [b, clips, 1,
    128, 204] from ops/audio.transform_audio, as in JAX). Frames are resized and normalized
    with the visual tower's own processor stats, as one [b·T] batch. Under a
    layout with dp > 1 each dp rank encodes its share of the clips (the
    towers are replicated) and the ranks gather the whole batch's
    features."""
    if layout is not None and layout.dp > 1:
        b = next(iter(raw.values())).shape[0]
        share = {m: mesh.dp_share(v, layout) for m, v in raw.items()}
        feats = encode_media_features(frozen, cfg, share, vision_cfg, audio_cfg)
        return {m: mesh.dp_gather(f, b, layout) for m, f in feats.items()}
    vis_spec = encoders.get_visual_encoder(
        cfg.visual_encoder_name if cfg is not None else "CLIP_VIT_LARGE")
    aud_spec = encoders.get_acoustic_encoder(
        cfg.acoustic_encoder_name if cfg is not None else "HUBERT_LARGE")
    vcfg = vision_cfg or getattr(cfg, "vision_cfg_override", None) or vis_spec.make_config()
    acfg = audio_cfg or getattr(cfg, "audio_cfg_override", None) or aud_spec.make_config()

    feats: Dict[str, torch.Tensor] = {}
    for m in ("frame", "face", "image"):
        if m in raw:
            prepped = prepare_frames(raw[m], vcfg.image_size, vis_spec.normalize)
            feats[m] = vis_spec.encode(frozen["visual_encoder"], vcfg, prepped)
    if "audio" in raw:
        feats["audio"] = aud_spec.encode(frozen["acoustic_encoder"], acfg, raw["audio"])
    return feats


@dataclass
class Chat:
    frozen: dict
    trainable: dict
    cfg: affectgpt.AffectGPTConfig
    tokenizer: "object"
    max_len: int = 2048
    # "int8" → the quantized KV cache (qwen2.init_cache), None → the
    # embeddings' dtype
    kv_cache_dtype: Optional[str] = None
    # > 0: greedy requests without a repetition penalty take prompt-lookup
    # speculative decoding (gen.generate_speculative: the same tokens, fewer
    # weight sweeps); sampled or penalized requests take gen.generate
    speculative_draft_len: int = 0
    # seeds the instance's sampling generator, used when answer_batch is
    # called without one; repeated sampled calls advance it
    seed: int = 0
    # a (dp, tp) layout of parallel.mesh: the LLM sharded over its tp groups,
    # each batch split over its dp groups (None: one rank)
    layout: Optional[mesh.Layout] = None

    def __post_init__(self):
        self.frozen, self.trainable, self.cfg = mesh.shard_model(
            self.frozen, self.trainable, self.cfg, self.layout)
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_cache_dtype must be None or 'int8', got {self.kv_cache_dtype!r}")
        self.device = self.frozen["llm"]["embed_tokens"]["table"].device
        self._generator = torch.Generator(device=self.device).manual_seed(self.seed)
        # single-token turn terminators ('###' when it is one token)
        self._stop_ids = tuple(
            enc[0] for s in ("###",)
            for enc in [self.tokenizer.encode(s)] if len(enc) == 1
        )

    def build_prompt_batch(
        self,
        face_or_frame: str,
        subtitles: List[Optional[str]],
        user_message: str,
        nonverbal_texts: Optional[List[Optional[str]]] = None,
    ):
        """Tokenize prompts (bos + prompt) and compute patch offsets; returns
        right-padded ids [b, t], lengths [b], offsets {m: [b]} as numpy."""
        texts = []
        for i, subtitle in enumerate(subtitles):
            nv = nonverbal_texts[i] if nonverbal_texts else None
            p = prompts.get_prompt_for_multimodal(face_or_frame, subtitle, user_message, nv)
            p = prompts.replace_token_for_multimodal(
                p, self.cfg.num_video_query_token, self.cfg.num_audio_query_token,
                self.cfg.num_multi_query_token, self.cfg.num_image_query_token,
            )
            texts.append(p)
        ids, lengths = encode_batch(self.tokenizer, texts)
        token_names = {
            "frame": constants.DEFAULT_FRAME_PATCH_TOKEN,
            "face": constants.DEFAULT_FACE_PATCH_TOKEN,
            "audio": constants.DEFAULT_AUDIO_PATCH_TOKEN,
            "multi": constants.DEFAULT_MULTI_PATCH_TOKEN,
            "image": constants.DEFAULT_IMAGE_PATCH_TOKEN,
        }
        offsets = {}
        for m, name in token_names.items():
            tok_id = self.tokenizer.patch_token_ids[name]
            offs = np.array(
                [splice.find_patch_run(row, tok_id, self.cfg.num_query_tokens(m)) for row in ids],
                dtype=np.int32,
            )
            if np.any(offs >= 0):
                offsets[m] = offs
                ids[ids == tok_id] = 0
        return ids, lengths, offsets

    def answer_batch(
        self,
        face_or_frame: str,
        subtitles: List[Optional[str]],
        user_message: str,
        features: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        max_new_tokens: int = 300,
        do_sample: bool = True,
        top_p: float = 0.9,
        temperature: float = 1.0,
        repetition_penalty: float = 1.0,
        nonverbal_texts: Optional[List[Optional[str]]] = None,
    ) -> List[str]:
        """Batched clip → text with the reference answer_sample semantics
        (top-p sampling or greedy, temperature and repetition_penalty with
        1.0 defaults, '###'/eos stop). With repetition_penalty != 1.0 only
        generated tokens are penalized: the spliced prompts carry patch
        placeholders, so their ids mean nothing to HF's penalty. features[m]
        are [b, t, d] tensors on the model's device. LoRA is applied as a
        parallel branch when trainable["lora"] is present, and is already in
        the weights when it is None (see bootstrap.serving_llm)."""
        ids, lengths, offsets = self.build_prompt_batch(
            face_or_frame, subtitles, user_message, nonverbal_texts
        )
        gcfg = gen.GenerateConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample, top_p=top_p,
            temperature=temperature, repetition_penalty=repetition_penalty,
            eos_token_id=self.tokenizer.eos_token_id, stop_token_ids=self._stop_ids,
        )
        dev = self.device
        input_ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
        embeds = affectgpt.build_inputs_embeds(
            self.frozen, self.trainable, self.cfg, input_ids, features,
            {m: torch.as_tensor(v, dtype=torch.long, device=dev) for m, v in offsets.items()},
        )
        common = dict(lora=self.trainable.get("lora"),
                      cache_dtype=torch.int8 if self.kv_cache_dtype == "int8" else None)
        lengths = torch.as_tensor(lengths, device=dev)
        if self.speculative_draft_len > 0 and not do_sample and repetition_penalty == 1.0:
            tokens, num_valid = gen.generate_speculative(
                self.frozen["llm"], self.cfg.llm, gcfg, embeds, lengths, input_ids,
                max_len=self.max_len + self.speculative_draft_len,  # verify-write headroom
                draft_len=self.speculative_draft_len, **common)
        else:
            tokens, num_valid = gen.generate(
                self.frozen["llm"], self.cfg.llm, gcfg, embeds, lengths,
                generator or self._generator, max_len=self.max_len, **common)
        tokens, num_valid = tokens.cpu().numpy(), num_valid.cpu().numpy()
        return [
            gen.trim_output_text(
                self.tokenizer.decode(row[: int(nv)], skip_special_tokens=True))
            for row, nv in zip(tokens, num_valid)
        ]
