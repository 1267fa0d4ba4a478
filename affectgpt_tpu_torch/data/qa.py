"""Question/answer pair construction per dataset + label type.

The port's own copy of affectgpt_tpu/data/qa.py: string parity with the
reference's func_get_qa_* family and the dataset → candidate-label-types
table (reference: my_affectgpt/datasets/datasets/base_dataset.py:588-795),
so tokenized training targets are the same.
"""

from __future__ import annotations

import random
from typing import Dict, Optional


def qa_description(sample: dict) -> Dict[str, str]:
    return {
        "question": "Please infer the person's emotional state and provide your reasoning process.",
        "answer": sample["description"],
    }


def qa_ovlabel(sample: dict) -> Dict[str, str]:
    return {
        "question": "Please recognize all possible emotional states of the character.",
        "answer": f"The character's emotional state is {sample['ovlabel']}.",
    }


def qa_onehot_w_candidates(sample: dict, candidate_labels: str) -> Dict[str, str]:
    return {
        "question": (
            "Please select the label that can best describe the person's emotional "
            f"state from the provided candidate labels: {candidate_labels}."
        ),
        "answer": f"The most likely label is {sample['onehot']}.",
    }


def qa_onehot_wo_candidates(sample: dict) -> Dict[str, str]:
    return {
        "question": "Please recognize the character's most likely emotional state.",
        "answer": f"The character's emotional state is {sample['onehot']}.",
    }


def qa_valence(sample: dict, minval: float, maxval: float) -> Dict[str, str]:
    # NB: the reference uses the 'ﬂ' ligature in this prompt; preserved for
    # token-level parity (base_dataset.py:632-637).
    question = (
        "Please identify the overall positive or negative emotional polarity of the main characters. "
        f"The output should be a ﬂoating-point number ranging from {minval} to {maxval}. "
        f"Here, {minval} indicates extremely negative emotions, 0 indicates neutral emotions, "
        f"and {maxval} indicates extremely positive emotions. "
        "Please provide your judgment as a ﬂoating-point number."
    )
    return {"question": question, "answer": "The valence score is %.2f." % sample["valence"]}


def qa_sentiment(sample: dict) -> Dict[str, str]:
    return {
        "question": (
            "Please select the most likely sentiment label that can best describe the "
            "person's emotional state: positive, negative, neutral."
        ),
        "answer": f"The character's sentiment state is {sample['sentiment']}.",
    }


def qa_direct(sample: dict) -> Dict[str, str]:
    return {"question": sample["question"], "answer": sample["answer"]}


def qa_preference(sample: dict) -> Dict[str, str]:
    a1, a2, p = sample["preference"]["a1"], sample["preference"]["a2"], sample["preference"]["p"]
    assert p in ("a1", "a2", "same")
    question = (
        f"We provide two descriptions. a1: {a1} \t\t\t a2: {a2} "
        "Please select the one that best matches the video content."
    )
    answer = (
        f"The best one is {p}." if p in ("a1", "a2")
        else "These two sentences describe the content of the video with the same accuracy."
    )
    return {"question": question, "answer": answer}


def qa_description_reward(sample: dict) -> Dict[str, str]:
    reason, reward = sample["description"], sample["reward"]
    assert reward in ("accept", "reject")
    return {
        "question": (
            f"We have provided a description: {reason} \t\t\t Please evaluate and decide "
            "whether to accept or reject this description based on its alignment with the video content."
        ),
        "answer": f"{reward} this sentence.",
    }


def qa_caption(sample: dict, modality: str, rng: Optional[random.Random] = None) -> Dict[str, str]:
    rng = rng or random
    prompts = {
        "image": ["Describe this image in detail.", "What is shown in this image?"],
        "audio": ["Describe this audio in detail.", "What can you hear in this audio?"],
    }[modality]
    return {"question": rng.choice(prompts), "answer": sample["caption"]}


# dataset → label_type → QA function (reference get_qa_pairs, base_dataset.py:706-795)
def get_qa_pairs(
    dataset: str,
    label_type: str,
    sample: dict,
    candidate_labels: str = "",
    minval: float = -1,
    maxval: float = 1,
    rng: Optional[random.Random] = None,
) -> Dict[str, str]:
    def candidates() -> dict:
        if dataset in ("EMERCoarse", "EMERFine", "MERCaptionPlus", "OVMERD", "OVMERDPlus"):
            return {"description": lambda: qa_description(sample), "ovlabel": lambda: qa_ovlabel(sample)}
        if dataset == "EMERCoarseFilter" or dataset in ("Preference2", "Preference4"):
            return {
                "description": lambda: qa_description(sample),
                "ovlabel": lambda: qa_ovlabel(sample),
                "sentiment": lambda: qa_sentiment(sample),
                "valence": lambda: qa_valence(sample, minval, maxval),
            }
        if dataset == "Preference":
            return {
                "description": lambda: qa_description(sample),
                "ovlabel": lambda: qa_ovlabel(sample),
                "sentiment": lambda: qa_sentiment(sample),
                "valence": lambda: qa_valence(sample, minval, maxval),
                "preference": lambda: qa_preference(sample),
            }
        if dataset == "Preference3":
            return {"reward": lambda: qa_description_reward(sample)}
        if dataset in ("MERRCoarse", "MERRFine", "MAFW"):
            return {"description": lambda: qa_description(sample)}
        if dataset in ("MER2023", "MER2024", "MELD", "IEMOCAPFour"):
            return {
                "onehot_w_candidates": lambda: qa_onehot_w_candidates(sample, candidate_labels),
                "onehot_wo_candidates": lambda: qa_onehot_wo_candidates(sample),
            }
        if dataset in ("CMUMOSI", "CMUMOSEI", "SIMS", "SIMSv2"):
            return {
                "valence": lambda: qa_valence(sample, minval, maxval),
                "sentiment": lambda: qa_sentiment(sample),
            }
        if dataset in ("VideoChat", "LLaVA", "EmoVIT"):
            return {"qa": lambda: qa_direct(sample)}
        if dataset == "MiniGPT4":
            return {"caption": lambda: qa_caption(sample, "image", rng)}
        if dataset in ("WavCaps", "TextrolSpeech", "PromptSpeech"):
            return {"caption": lambda: qa_caption(sample, "audio", rng)}
        raise KeyError(f"Unknown dataset: {dataset}")

    table = candidates()
    if label_type not in table:
        raise KeyError(f"label_type {label_type} not available for {dataset}: {sorted(table)}")
    return table[label_type]()


def pick_label_type(candidates, label_type: str, rng: Optional[random.Random] = None) -> str:
    """'hybird' label_type samples uniformly among the dataset's candidates
    each step (the reference's label-type mixing)."""
    if label_type == "hybird":
        return (rng or random).choice(list(candidates))
    return label_type
