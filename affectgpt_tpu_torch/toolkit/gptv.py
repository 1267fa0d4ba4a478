"""GPT-4V image-emotion annotation engine (generic, transport-injectable).

Port of affectgpt_tpu/toolkit/gptv.py without pandas (reference: the 19
per-dataset GPT-4V harnesses toolkit/gptv/{rafdb,sfew,dfew,mer2023,...}.py,
each repeating one loop: shuffled order npz, fixed-size image batches,
per-batch npz resume, recursive batch bisection on API failure
(rafdb.py:109-174), 'name/result' response parsing (rafdb.py:177-194),
batch validation (rafdb.py:197-209), top-1 accuracy + merged label csv
(rafdb.py:212-249)). The loop exists once, parameterized by the
dataset's emotion vocabulary; the transport is injected (an
OpenAI-compatible callable or `api_helpers.LocalJudgeTransport`).
"""

from __future__ import annotations

import glob
import math
import os
import re
import shutil
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from affectgpt_tpu_torch.toolkit.api_helpers import CompleteFn, image_content
from affectgpt_tpu_torch.toolkit.io import write_rows_csv
from affectgpt_tpu_torch.utils.logging import logger

# Emotion vocabularies of every reference gptv dataset (toolkit/gptv/*.py
# `emos` lists — dataset facts, one table instead of 19 scripts).
GPTV_EMOS: Dict[str, List[str]] = {
    "abstract": ["Amusement", "Anger", "Awe", "Content", "Disgust", "Excitement", "Fear", "Sad"],
    "affectnet": ["Surprise", "Contempt", "Happiness", "Anger", "Neutral", "Sadness", "Fear", "Disgust"],
    "artphoto": ["disgust", "awe", "sad", "fear", "anger", "excitement", "contentment", "amusement"],
    "casme": ["tense", "disgust", "repression", "surprise"],
    "casme2": ["happiness", "surprise", "disgust", "repression", "others"],
    "ckplus": ["anger", "contempt", "disgust", "fear", "happy", "sadness", "surprise"],
    "cmumosi": ["negative", "weakly negative", "neutral", "weakly positive", "positive"],
    "dfew": ["Sad", "Neutral", "Angry", "Fear", "Surprise", "Happy", "Disgust"],
    "enterface": ["happiness", "anger", "disgust", "fear", "surprise", "sadness"],
    "fer2013": ["neutral", "happiness", "surprise", "sadness", "anger", "disgust", "fear", "contempt"],
    "ferv39k": ["Angry", "Disgust", "Fear", "Happy", "Neutral", "Sad", "Surprise"],
    "mer2023": ["worried", "happy", "neutral", "angry", "surprised", "sad"],
    "mvsa-multiple": ["negative", "neutral", "positive"],
    "mvsa-single": ["negative", "neutral", "positive"],
    "rafdb": ["Surprise", "Fear", "Disgust", "Happiness", "Sadness", "Anger", "Neutral"],
    "ravdess": ["surprised", "neutral", "disgust", "sad", "happy", "calm", "fearful", "angry"],
    "samm": ["Anger", "Contempt", "Happiness", "Surprise", "Other"],
    "sfew": ["Angry", "Disgust", "Fear", "Happy", "Neutral", "Sad", "Surprise"],
    "sims": ["negative", "weakly negative", "neutral", "weakly positive", "positive"],
    "twitter1": ["positive", "negative"],
    "twitter2": ["positive", "negative"],
}


def build_batch_prompt(image_paths: Sequence[str], candidates: Sequence[str]) -> List[dict]:
    """The reference's batch classification prompt (chatgpt.py
    get_image_emotion_batch 'case0'): expert role, top-5 similarity
    ranking per image, {'name':, 'result':} output contract."""
    text = (
        f"Please play the role of a facial expression classification expert. "
        f"We provide {len(image_paths)} images. Please ignore the speaker's "
        f"identity and focus on the facial expression. For each image, please "
        f"sort the provided categories from high to low according to the top 5 "
        f"similarity with the input image. Here are the optional categories: "
        f"{list(candidates)}. Please ignore the speaker's identity and focus on "
        f"the facial expression. The output format should be "
        f"{{'name':, 'result':}} for each image."
    )
    content: List[dict] = [{"type": "text", "text": text}]
    content += [image_content(p) for p in image_paths]
    return [{"role": "user", "content": content}]


def annotate_images(
    complete_fn: CompleteFn,
    image_paths: Sequence[str],
    save_root: str,
    order_path: str,
    emos: Sequence[str],
    bsize: int = 20,
    bisect_depth: int = 2,
    sleeptime: float = 0.0,
    seed: int = 0,
) -> None:
    """Annotate a dataset's images in resumable batches.

    - The shuffled order is persisted to `order_path` so re-runs resume the
      same batches (reference rafdb.py:119-128).
    - One npz per batch under save_root; existing files are skipped.
    - A failed batch is split in half recursively up to `bisect_depth`
      (the generic form of the reference's flag2/3/4 segment retries).
    """
    os.makedirs(save_root, exist_ok=True)
    if os.path.exists(order_path):
        ordered = list(np.load(order_path, allow_pickle=True)["image_paths"])
    else:
        rng = np.random.RandomState(seed)
        ordered = list(image_paths)
        rng.shuffle(ordered)
        np.savez_compressed(order_path, image_paths=np.array(ordered, dtype=object))

    n_batches = math.ceil(len(ordered) / bsize)
    for i in range(n_batches):
        batch = [str(p) for p in ordered[i * bsize : (i + 1) * bsize]]
        base = os.path.join(save_root, f"batch_{i + 1}.npz")
        _annotate_or_bisect(complete_fn, batch, base, emos, bisect_depth, sleeptime)


def _annotate_or_bisect(
    complete_fn: CompleteFn,
    batch: List[str],
    save_path: str,
    emos: Sequence[str],
    depth: int,
    sleeptime: float,
) -> None:
    if os.path.exists(save_path) or not batch:
        return
    if sleeptime:
        time.sleep(sleeptime)
    try:
        response = complete_fn(build_batch_prompt(batch, emos))
    except Exception as error:  # noqa: BLE001 — bisect on any API failure
        response = None
        logger.warning("batch %s failed: %s", os.path.basename(save_path), error)
    if response is not None:
        np.savez_compressed(save_path, gpt4v=response,
                            names=np.array(batch, dtype=object))
        return
    if depth <= 0 or len(batch) == 1:
        logger.warning("giving up on %s (%d images)", save_path, len(batch))
        return
    half = math.ceil(len(batch) / 2)
    for j, segment in enumerate((batch[:half], batch[half:])):
        seg_path = save_path[:-4] + f"_segment_{j + 1}.npz"
        _annotate_or_bisect(complete_fn, segment, seg_path, emos, depth - 1, sleeptime)


def parse_batch_response(text: str) -> List[str]:
    """'name'/'result' delimited response → one '[...]' payload per image
    (reference rafdb.py:177-194)."""
    text = text.replace("name", "==========").replace("result", "==========")
    results = []
    for line in text.split("=========="):
        if "[" in line and "]" in line:
            results.append(line.split("[", 1)[1].split("]", 1)[0])
    return results


def collect_batches(save_root: str, delete_bad: bool = True) -> Tuple[List[str], List[str]]:
    """Validate every batch npz: per-image result count must match the
    image count, else the batch is removed for re-annotation (reference
    check_gpt4_performance, rafdb.py:197-209)."""
    names, preds = [], []
    for path in sorted(glob.glob(os.path.join(save_root, "*.npz"))):
        pack = np.load(path, allow_pickle=True)
        batch_names = [os.path.basename(str(n)) for n in pack["names"].tolist()]
        batch_preds = parse_batch_response(str(pack["gpt4v"]))
        if len(batch_names) == len(batch_preds):
            names.extend(batch_names)
            preds.extend(batch_preds)
        else:
            logger.warning("bad batch %s (%d names, %d results)",
                           path, len(batch_names), len(batch_preds))
            if delete_bad:
                os.remove(path)
    return names, preds


def _split_ranking(pred: str) -> List[str]:
    return [p for p in re.split("['\"]", pred) if p.strip() not in ("", ",")]


def score_top1(
    save_root: str,
    name2gt: Dict[str, str],
    store_csv: Optional[str] = None,
) -> float:
    """Top-1 accuracy of the collected annotations against ground truth,
    optionally writing the merged gt/gpt4v csv (reference
    get_results_and_update_label, rafdb.py:212-249)."""
    names, preds = collect_batches(save_root, delete_bad=False)
    correct, rows = 0, []
    for name, pred in zip(names, preds):
        if name not in name2gt:
            continue
        ranking = _split_ranking(pred)
        top1 = ranking[0] if ranking else ""
        correct += int(top1 == name2gt[name])
        rows.append({"name": name, "gt": name2gt[name], "gpt4v": ",".join(ranking)})
    if store_csv and rows:
        write_rows_csv(store_csv, rows)
    accuracy = correct / max(len(rows), 1)
    logger.info("gpt4v top-1 accuracy: %.2f%% over %d samples", accuracy * 100, len(rows))
    return accuracy


def select_samples(
    names: Sequence[str],
    labels: Sequence[str],
    image_src: Callable[[str], str],
    save_root: str,
) -> str:
    """The common output contract of every reference selector
    (select_samples_for_* in each gptv script): copy test images under
    `{save_root}/image/` and write `label.csv` with name/gt/gpt4v columns."""
    save_image = os.path.join(save_root, "image")
    os.makedirs(save_image, exist_ok=True)
    for name in names:
        src = image_src(name)
        dst = os.path.join(save_image, os.path.basename(src))
        if os.path.exists(src) and not os.path.exists(dst):
            shutil.copy(src, dst)
    csv_path = os.path.join(save_root, "label.csv")
    write_rows_csv(csv_path, [{"name": n, "gt": gt, "gpt4v": ""} for n, gt in zip(names, labels)],
                   columns=("name", "gt", "gpt4v"))
    return csv_path
