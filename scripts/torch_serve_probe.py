"""Serve-phase wall times of chip_smoke.py's paged configurations, for this tree and other checkouts, on one CUDA card.

    python3 scripts/torch_serve_probe.py [--reps N] [DIR ...]

Each package runs in a process of its own, with its own checkout's
chip_smoke.py: the model of that script's main path at Qwen2.5-7B width and
full depth (random weights from its seed, LoRA merged, the bf16 serving
tree; no encoders), its 48 serve requests, and its `serve_counted` (the
launch counts and results checked, a warm-up) and then `serve_timed`, N
times each (default 3), for paged_bf16 and paged_kv8: PagedBatchServer as
inference_hybird.py builds it, the kernel route of PAGED_ATTENTION. A DIR
is the root of another checkout (the parent commit unpacked into a
directory that .gitignore lists). The packages run in the order A B B A, so
a drift of the host weighs on both. Prints the card's name and power limit
first, then each run's `serve` lines (wall s, requests/s, TTFT and e2e
percentiles, the engine's stats with t_decode and decode_steps) under a
line naming its package, then for each package and configuration the
quartiles (25%, median, 75%) over all its timed runs of the wall s and of
the decode ms a step (t_decode / decode_steps).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

from torch_int4_probe import card
from torch_wgmma_variants import REPO

CONFIGS = ("paged_bf16", "paged_kv8")

BENCH = r'''
import importlib.util, sys
import numpy as np
import torch
root, reps = sys.argv[1], int(sys.argv[2])
spec = importlib.util.spec_from_file_location("chip_smoke", f"{root}/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
sys.modules["chip_smoke"] = cs
spec.loader.exec_module(cs)
from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference.chat import Chat
card = cs.phase_device()
cs.phase_build(card)
cfg, frozen, trainable, tok = bootstrap.build_model(
    {"llama_model": "Qwen25", "keep_full_llm": True}, with_encoders=False, seed=0)
frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
rng = np.random.RandomState(0)
feats = {m: torch.as_tensor(rng.randn(cs.BATCH, 8, d).astype(np.float32), device="cuda")
         .to(torch.bfloat16)
         for m, d in (("frame", cfg.visual_dim), ("face", cfg.visual_dim),
                      ("audio", cfg.acoustic_dim))}
model = (cfg, frozen, trainable, tok, feats,
         {"bf16": cs.serving_tree(frozen["llm"], cfg.llm, "bf16")})
requests = cs.serve_requests(Chat(frozen, trainable, cfg, tok), feats)
configs = sys.argv[3:]
for config in configs:
    cs.serve_counted(config, model, requests)
for _ in range(reps):
    for config in configs:
        cs.serve_timed(config, model, requests, card)
'''


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("dirs", nargs="*")
    args = parser.parse_args()
    card()
    roots = [("this tree", REPO)] + [(d, Path(d).resolve()) for d in args.dirs]
    runs = {}  # (package, config) -> [(wall s, decode ms a step)]
    for label, root in roots + roots[::-1]:
        print("package", label, flush=True)
        env = {**os.environ, "PYTHONPATH": str(root)}
        proc = subprocess.run([sys.executable, "-c", BENCH, str(root), str(args.reps), *CONFIGS],
                              env=env, cwd=root, capture_output=True, text=True, timeout=1500)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[serve]")]
        print("\n".join(lines) if proc.returncode == 0 else proc.stderr[-3000:], flush=True)
        for ln in lines:
            if " wall_s=" not in ln:  # the counted run's line
                continue
            head, tail = ln.split(" stats=", 1)
            fields = dict(f.split("=", 1) for f in head.split()[1:])
            stats = json.loads(tail.split(" cache_gib=")[0])
            runs.setdefault((label, fields["config"]), []).append(
                (float(fields["wall_s"]), 1000 * stats["t_decode"] / stats["decode_steps"]))
    for (label, config), values in runs.items():
        print(json.dumps({"package": label, "config": config, "runs": len(values), **{
            key: [round(q, 4) for q in statistics.quantiles([v[i] for v in values], n=4)]
            for i, key in enumerate(("wall_s", "decode_ms_per_step"))}}), flush=True)


if __name__ == "__main__":
    main()
