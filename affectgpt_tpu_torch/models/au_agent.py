"""AU agent: objective facial-muscle descriptions from OpenFace Action
Units through a Qwen decoder, in PyTorch.

Port of affectgpt_tpu/models/au_agent.py (the reference AUAgent,
my_affectgpt/models/au_agent.py): parse OpenFace `AU??_r` intensity
columns, keep the AUs above 0.5, name them after FACS, build a Qwen chat
prompt and generate a description without emotions, batched, through
`inference.generate.generate` with the reference's sampling (temperature
0.7, top-p 0.9, repetition penalty 1.1 over the prompt and the generated
tokens). A row without a significant AU comes back as NEUTRAL_DESCRIPTION
without generating. The host helpers are the port's own copy of JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.models import qwen2
from affectgpt_tpu_torch.tokenization import encode_batch

AU_NAME_MAP = {
    "AU01": "Inner brow raiser",
    "AU02": "Outer brow raiser",
    "AU04": "Brow lowerer",
    "AU05": "Upper lid raiser",
    "AU06": "Cheek raiser",
    "AU07": "Lid tightener",
    "AU09": "Nose wrinkler",
    "AU10": "Upper lip raiser",
    "AU12": "Lip corner puller (smile)",
    "AU14": "Dimpler",
    "AU15": "Lip corner depressor",
    "AU17": "Chin raiser",
    "AU20": "Lip stretcher",
    "AU23": "Lip tightener",
    "AU25": "Lips part",
    "AU26": "Jaw drop",
    "AU45": "Blink",
}

INSTRUCTION = (
    "Generate a detailed and objective facial muscle movement description "
    "based on the Action Unit detections. Focus only on the physical "
    "movements without inferring emotions."
)

NEUTRAL_DESCRIPTION = "neutral expression with minimal facial movement"


def parse_openface_row(csv_row: Dict) -> Dict[str, float]:
    """OpenFace CSV row → {AU01: intensity, ...} from the `*_r` columns."""
    au_values = {}
    for key, value in csv_row.items():
        key = str(key).strip()
        if key.endswith("_r"):
            try:
                au_values[key[:-2]] = float(value)
            except (TypeError, ValueError):
                continue
    return au_values


def build_au_input(au_values: Dict[str, float], au_description: Optional[str] = None,
                   threshold: float = 0.5) -> Optional[str]:
    """The user turn's text from the AUs above `threshold`; None for a
    neutral face."""
    significant = {k.replace("_r", ""): v for k, v in au_values.items() if v > threshold}
    if not significant:
        return None
    au_values_text = ", ".join(f"{au}: {v:.2f}" for au, v in significant.items())
    if au_description:
        au_descriptions_text = au_description
    else:
        au_descriptions_text = ", ".join(
            f"{AU_NAME_MAP.get(au, au)} (intensity: {v:.2f})" for au, v in significant.items())
    return f"AU values: {au_values_text}\nAU descriptions: {au_descriptions_text}"


def build_chat_prompt(user_text: str) -> str:
    """Qwen2.5 chat template: system, user, then the generation prompt."""
    return (
        f"<|im_start|>system\n{INSTRUCTION}<|im_end|>\n"
        f"<|im_start|>user\n{user_text}<|im_end|>\n"
        f"<|im_start|>assistant\n"
    )


@dataclass
class AUAgent:
    """Batched AU → description generation on the port's decode path."""

    frozen_llm: dict
    llm_cfg: qwen2.QwenConfig
    tokenizer: "object"
    lora: Optional[dict] = None
    max_new_tokens: int = 256
    temperature: float = 0.7
    top_p: float = 0.9
    repetition_penalty: float = 1.1

    def generate_descriptions(self, batch_au_values: List[Dict[str, float]],
                              au_descriptions: Optional[List[Optional[str]]] = None,
                              generator: Optional[torch.Generator] = None) -> List[str]:
        """One description per row of AU values; `generator` seeds the
        sampling (a generator seeded 0 on the weights' device if None)."""
        prompts, positions = [], []
        outputs: List[Optional[str]] = [None] * len(batch_au_values)
        for i, au_values in enumerate(batch_au_values):
            user_text = build_au_input(au_values, au_descriptions[i] if au_descriptions else None)
            if user_text is None:
                outputs[i] = NEUTRAL_DESCRIPTION
            else:
                prompts.append(build_chat_prompt(user_text))
                positions.append(i)
        if prompts:
            dev = self.frozen_llm["embed_tokens"]["table"].device
            ids, lengths = encode_batch(self.tokenizer, prompts)
            gcfg = gen.GenerateConfig(
                max_new_tokens=self.max_new_tokens, do_sample=True,
                temperature=self.temperature, top_p=self.top_p,
                eos_token_id=self.tokenizer.eos_token_id,
                repetition_penalty=self.repetition_penalty,
            )
            ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
            tokens, num_valid = gen.generate(
                self.frozen_llm, self.llm_cfg, gcfg, qwen2.embed_tokens(self.frozen_llm, ids),
                torch.as_tensor(lengths, device=dev),
                generator or torch.Generator(device=dev).manual_seed(0),
                max_len=ids.shape[1] + self.max_new_tokens, lora=self.lora, prompt_ids=ids,
            )
            for pos, row, nv in zip(positions, tokens.cpu().numpy(), num_valid.cpu().numpy()):
                text = gen.trim_output_text(
                    self.tokenizer.decode(row[: int(nv)], skip_special_tokens=True))
                if "Description:" in text:
                    text = text.split("Description:")[-1].strip()
                outputs[pos] = text
        return [o if o is not None else NEUTRAL_DESCRIPTION for o in outputs]

    def generate_description(self, au_values: Dict[str, float], au_description=None) -> str:
        return self.generate_descriptions([au_values], [au_description])[0]
