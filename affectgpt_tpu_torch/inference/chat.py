"""Chat over preextracted features: batched clip → text, in PyTorch.

Port of affectgpt_tpu/inference/chat.py (`Chat.build_prompt_batch` and
`Chat.answer_batch`): prompt assembly and tokenization reuse the
framework-free host modules of `affectgpt_tpu`, then mergers → splice →
prefill → decode run in the port.

Not ported yet: `encode_media_features` (the realtime encoders), speculative
decoding, the int8 KV cache and the repetition penalty.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from affectgpt_tpu import constants, prompts
from affectgpt_tpu.tokenization import encode_batch
from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.models import affectgpt, splice


@dataclass
class Chat:
    frozen: dict
    trainable: dict
    cfg: affectgpt.AffectGPTConfig
    tokenizer: "object"
    max_len: int = 2048
    # seeds the instance's sampling generator, used when answer_batch is
    # called without one; repeated sampled calls advance it
    seed: int = 0

    def __post_init__(self):
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
        nonverbal_texts: Optional[List[Optional[str]]] = None,
    ) -> List[str]:
        """Batched clip → text with the reference answer_sample semantics
        (top-p sampling or greedy, '###'/eos stop). features[m] are
        [b, t, d] tensors on the model's device. LoRA is applied as a
        parallel branch when trainable["lora"] is present, and is already in
        the weights when it is None (see bootstrap.serving_llm)."""
        ids, lengths, offsets = self.build_prompt_batch(
            face_or_frame, subtitles, user_message, nonverbal_texts
        )
        gcfg = gen.GenerateConfig(
            max_new_tokens=max_new_tokens, do_sample=do_sample, top_p=top_p,
            temperature=temperature, eos_token_id=self.tokenizer.eos_token_id,
            stop_token_ids=self._stop_ids,
        )
        dev = self.device
        embeds = affectgpt.build_inputs_embeds(
            self.frozen, self.trainable, self.cfg,
            torch.as_tensor(ids, dtype=torch.long, device=dev),
            features,
            {m: torch.as_tensor(v, dtype=torch.long, device=dev) for m, v in offsets.items()},
        )
        tokens, num_valid = gen.generate(
            self.frozen["llm"], self.cfg.llm, gcfg, embeds,
            torch.as_tensor(lengths, device=dev), generator or self._generator,
            max_len=self.max_len, lora=self.trainable.get("lora"),
        )
        tokens, num_valid = tokens.cpu().numpy(), num_valid.cpu().numpy()
        return [
            gen.trim_output_text(
                self.tokenizer.decode(row[: int(nv)], skip_special_tokens=True))
            for row, nv in zip(tokens, num_valid)
        ]
