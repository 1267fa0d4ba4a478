"""The PyTorch port's training step alone, on one CUDA card.

    python3 scripts/torch_train_probe.py [numerics] [profile] [runs]

Builds the LLM as chip_smoke.py's phase 4 does (Qwen2.5-7B width, random
bf16 weights from a seed, LoRA merged into them, no encoders) and runs
pieces of chip_smoke.py's phase 8 on it (all three when no argument is
given):

- numerics: the measurements behind gates 3 and 4 with every gradient
  leaf's relative L2 error (bf16 against the same 2-layer model upcast to
  f32; remat True and "dots" against remat False, dropout on).
- profile: one b = 8 remat=True step (dropout on) under torch.profiler with
  CPU and CUDA activities: its wall ms, the kernels' device ms and busy
  share, the device operations it launches, the CPU operators with the most
  self time (calls, ms), and the host µs of creating and seeding one CUDA
  generator (what every dropout site does). The table goes to
  chiprun_out/train_profile.txt.
- runs: chip_smoke.py's TRAIN_RUNS (step ms, samples/s, peak memory).
- memory: one step at b = 4, t = 1024 (mercaptionplus_bestsetup.yaml's
  batch and max_length) under remat False, "dots" and True: its ms and
  peak memory, or the out-of-memory error it raised.

Every line carries the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from affectgpt_tpu_torch import bootstrap  # noqa: E402
from affectgpt_tpu_torch.training import train_step  # noqa: E402


def numerics(card: str, cfg, frozen: dict) -> None:
    loss16, loss32, errs = cs.bf16_errors(cfg, frozen)
    cs.say("probe", what="bf16_vs_f32", loss_bf16=f"{loss16:.6f}", loss_f32=f"{loss32:.6f}",
           errors=json.dumps({k: f"{v:.3e}" for k, v in sorted(errs.items(),
                                                               key=lambda kv: -kv[1])}),
           card=repr(card))
    loss0, routes = cs.remat_errors(cfg, frozen, (cs.DROPOUT_SEED, 0))
    for remat, (loss, e) in routes.items():
        cs.say("probe", what="remat", remat=remat, loss=f"{loss:.6f}", loss_remat0=f"{loss0:.6f}",
               worst=cs.worst(e, 6), card=repr(card))


def profile_step(card: str, cfg, frozen: dict) -> None:
    tx = cs.make_tx()
    state = train_step.create_train_state(cs.train_trainable(cfg, 1), tx)
    step_fn = train_step.make_train_step(cfg, tx, remat=True, dropout_seed=cs.DROPOUT_SEED)
    batch = cs.train_batch(cfg, 8)
    for _ in range(3):
        state, _ = step_fn(state, frozen, batch)
    torch.cuda.synchronize()
    for _ in range(2):  # a process's first profiler session may record no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step_fn(state, frozen, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        device = [e for e in events if getattr(e, "self_device_time_total", 0) > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        if device:
            break
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    launches = sum(e.count for e in device)
    cpu = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)
    top = {e.key[:48]: [e.count, round(e.self_cpu_time_total / 1e3, 2)] for e in cpu[:15]}
    aten_calls = sum(e.count for e in cpu if e.key.startswith("aten::"))
    cs.say("probe", what="profile", wall_ms=f"{wall_ms:.3f}", device_ms=f"{device_ms:.3f}",
           busy_share=f"{device_ms / wall_ms:.4f}", device_launches=launches,
           aten_calls=aten_calls, top_cpu_self=json.dumps(top), card=repr(card))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_profile.txt"), "w") as handle:
        handle.write(events.table(sort_by="self_cpu_time_total", row_limit=60))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1000):
        torch.Generator(device="cuda").manual_seed(i)
    cs.say("probe", what="generator", create_and_seed_us=f"{(time.perf_counter() - t0) * 1e3:.3f}",
           card=repr(card))


def memory(card: str, cfg, frozen: dict) -> None:
    batch = cs.train_batch(cfg, 4, t=1024)
    for remat in (True, "dots", False):
        tx = cs.make_tx()
        state = train_step.create_train_state(cs.train_trainable(cfg, 1), tx)
        step_fn = train_step.make_train_step(cfg, tx, remat=remat, dropout_seed=cs.DROPOUT_SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        try:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                state, m = step_fn(state, frozen, batch)
                float(m["loss"])
                times.append((time.perf_counter() - t0) * 1e3)
            result = {"step_ms": [round(x, 2) for x in times]}
        except torch.cuda.OutOfMemoryError as error:
            result = {"oom": str(error).split(".")[0]}
        cs.say("probe", what="memory", batch=4, seq=1024, remat=remat,
               peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
               **{k: json.dumps(v) for k, v in result.items()}, card=repr(card))
        del state, step_fn
        torch.cuda.empty_cache()


def main() -> None:
    what = set(sys.argv[1:]) or {"numerics", "profile", "runs"}
    card = cs.phase_device()
    cfg, frozen, trainable, _ = bootstrap.build_model(
        {"llama_model": "Qwen25", "keep_full_llm": True}, seed=0)
    frozen, _ = bootstrap.serving_llm(frozen, trainable, cfg)
    if "numerics" in what:
        numerics(card, cfg, frozen)
    if "profile" in what:
        profile_step(card, cfg, frozen)
    if "memory" in what:
        memory(card, cfg, frozen)
    if "runs" in what:
        for name in cs.TRAIN_RUNS:
            cs.train_run(card, name, cfg, frozen)


if __name__ == "__main__":
    main()
