"""First-quality-run recipe: weights -> preextract -> greedy inference ->
judge -> score, each step one of the port's command lines run as a
subprocess (reference flow: extract_multimodal_features_precompute.py ->
inference_hybird.py -> evaluation.py).

Port of scripts/quality_run.sh with scripts/_synth_quality_setup.py.

Real run (weights and corpus mounted):
    export AFFECTGPT_MODEL_ROOT=/path/to/tools   # LLM/, visual/, audio/ HF dirs
    export AFFECTGPT_DATA_ROOT=/path/to/dataset  # per-corpus layout (paths.py)
    python -m affectgpt_tpu_torch.scripts.quality_run <cfg.yaml|json> <dataset> [ckpt_root]
  - the precompute of frame, face and audio features for the evaluation
    clips (skip-if-exists resume; QUALITY_LIMIT caps the clips), then greedy
    `inference_hybird` (QUALITY_BATCH, default 16; QUALITY_NEW_TOKENS,
    default 64), then `evaluation` over output/results/<name>;
  - a step that exits non-zero stops the recipe with its code. A clip whose
    media cannot be read is skipped by the precompute itself (the bash
    recipe ran the precompute under `|| true`).

CI staging (no pretrained assets; random weights, synthetic corpus):
    python -m affectgpt_tpu_torch.scripts.quality_run --synthetic <workdir>
  writes the corpus and `quality_run.json` (JSON: the card has no PyYAML)
  under <workdir>, runs there and scores with the lexicon judge. On the
  CPU the LLM is the tiny one of the bash recipe's config; on the card it
  has bench.py's 3B geometry (the `Qwen25_3B` preset, random weights),
  since the decode kernels take Qwen2.5's widths (head_dim 128), not the
  tiny LLM's.

`--device` (default cuda, the card) is passed to every step.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from affectgpt_tpu_torch.scripts.synth_corpus import build_corpus

REPO = Path(__file__).resolve().parents[2]


def write_synthetic_config(workdir: str, device: str = "cuda") -> str:
    """The synthetic corpus and its config (scripts/_synth_quality_setup.py,
    as JSON; off the CPU the LLM at the 3B geometry); returns the config's
    path."""
    work = Path(workdir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    overrides, feat_root = build_corpus(work)
    cfg = {
        "model": {
            "llama_model": "tiny",
            "skip_encoders": True,
            "preextracted_visual_dim": 12,
            "preextracted_acoustic_dim": 16,
            "num_video_query_token": 2,
            "num_audio_query_token": 2,
            "num_multi_query_token": 1,
            "lora_r": 2,
            "max_length": 640,
        },
        "datasets": {
            "mer2023": {
                "face_or_frame": "frame_text",
                "label_type": "onehot_wo_candidates",
                "use_preextracted_frame": True,
                "preextracted_root": feat_root,
                "max_length": 640,
            },
        },
        "run": {"output_dir": str(work / "output"), "seed": 0},
        "inference": {"face_or_frame": "frame_text"},
        "paths": overrides,
    }
    if torch.device(device).type != "cpu":
        cfg["model"].update(llama_model="Qwen25_3B", keep_full_llm=True)
    cfg_path = work / "quality_run.json"
    cfg_path.write_text(json.dumps(cfg, indent=1))
    return str(cfg_path)


def config_name(cfg_path: str) -> str:
    """The result directory's name: the config's `name`, else its basename."""
    with open(cfg_path) as handle:
        if cfg_path.endswith(".json"):
            raw = json.load(handle)
        else:
            import yaml

            raw = yaml.safe_load(handle)
    return (raw or {}).get("name") or os.path.splitext(os.path.basename(cfg_path))[0]


def run_step(module: str, args: list, cwd: str) -> None:
    """`python -m affectgpt_tpu_torch.<module> args` in `cwd`, its seconds
    printed; a non-zero exit stops the recipe with that code."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    argv = [sys.executable, "-m", f"affectgpt_tpu_torch.{module}", *args]
    print("+ python", " ".join(argv[1:]), flush=True)
    t0 = time.perf_counter()
    code = subprocess.run(argv, cwd=cwd, env=env).returncode
    if code:
        print(f"quality_run: {module} exited {code}", file=sys.stderr, flush=True)
        raise SystemExit(code)
    print(f"quality_run: {module} took {time.perf_counter() - t0:.3f} s", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="first-quality-run recipe (PyTorch port)")
    parser.add_argument("cfg", nargs="?", help="experiment YAML or JSON")
    parser.add_argument("dataset", nargs="?")
    parser.add_argument("ckpt_root", nargs="?")
    parser.add_argument("--synthetic", metavar="WORKDIR",
                        help="stage the recipe on a synthetic corpus with random tiny weights")
    parser.add_argument("--device", default="cuda", help="every step's device: cuda or cpu")
    args = parser.parse_args(argv)
    device = ["--device", args.device]

    if args.synthetic:
        cfg = write_synthetic_config(args.synthetic, args.device)
        dataset, ckpt_args, eval_args = "MER2023", [], ["--no-llm"]  # no judge weights in CI
        cwd = str(Path(args.synthetic).resolve())
    else:
        if not (args.cfg and args.dataset):
            parser.error("usage: quality_run <cfg> <dataset> [ckpt_root] | --synthetic <workdir>")
        cfg, dataset, cwd = os.path.abspath(args.cfg), args.dataset, str(REPO)
        ckpt_args = ["--ckpt_root", os.path.abspath(args.ckpt_root)] if args.ckpt_root else []
        eval_args = []
        limit = os.environ.get("QUALITY_LIMIT")
        # 1) preextract features for the evaluation clips (skip-if-exists resume)
        for modality in ("frame", "face", "audio"):
            run_step("extract_multimodal_features_precompute",
                     ["--dataset", dataset, "--modality", modality, *device,
                      *(["--limit", limit] if limit else [])], cwd)

    name = config_name(cfg)
    # 2) greedy batched inference over the evaluation set
    run_step("inference_hybird",
             ["--cfg-path", cfg, "--dataset", dataset, "--greedy",
              "--batch_size", os.environ.get("QUALITY_BATCH", "16"),
              "--max_new_tokens", os.environ.get("QUALITY_NEW_TOKENS", "64"),
              *ckpt_args, *device], cwd)
    # 3) judge + score (the LLM judge when its weights exist, the lexicon otherwise)
    run_step("evaluation", ["--input-dir", f"output/results/{name}", "--cfg-path", cfg,
                            *eval_args, *device], cwd)
    print(f"quality_run complete: output/results/{name}", flush=True)


if __name__ == "__main__":
    main()
