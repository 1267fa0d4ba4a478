"""Where the time of the PyTorch port's decode goes, on one CUDA card.

    python3 scripts/torch_profile_decode.py [--steps 8] [--batch 8] [--attention a]
                                            [--bits 4|8 [--w8a8]] [--speculative D]

Builds the port's main path as chip_smoke.py does (Qwen2.5-7B width, random
bf16 weights from a seed, LoRA merged, 8 preextracted clips) under one of
chip_smoke.py's attention configurations (`default`: the plain chain; `a`:
flash prefill + decode_attn_o; `b`: flash prefill + decode_attention);
`--bits` serves the merged weights quantized (int4, or int8; `--w8a8` sets
quant.MATMUL_MODE = "w8a8"). Runs one warm generate, then profiles prefill
plus `--steps` greedy decode steps with torch.profiler. Prints the card's
name and power limit, the host wall time, the summed device time of all
kernels, the device operations a decode step launches (the profiled run's
less a prefill-only run's), and the kernels ranked by device time; writes
the full table and a Chrome trace to chiprun_out/. With `--bits`, one more
run outside the profiler times the host side of every quantized-matmul
wrapper call (its checks, allocations and launch; the kernels run
asynchronously) and prints, per wrapper, the calls, the median and mean
microseconds, and their share of the run's wall time. `--speculative D`
profiles generate_speculative with draft length D instead (`--steps` new
tokens; device operations counted per verify iteration).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from affectgpt_tpu_torch import bootstrap  # noqa: E402
from affectgpt_tpu_torch.inference import generate as gen  # noqa: E402
from affectgpt_tpu_torch.inference.chat import Chat  # noqa: E402
from affectgpt_tpu_torch.models import affectgpt, qwen2  # noqa: E402
from affectgpt_tpu_torch.ops import quant  # noqa: E402
from chip_smoke import CONFIGS, serving_tree  # noqa: E402

ATTENTION = ("default", "a", "b")  # chip_smoke.py's bf16 attention configurations
KERNEL_WRAPPERS = ("int4_matmul_smallm", "int4_matmul", "int8_matmul", "int8_matmul_w8a8")


class _TimedQuant:
    """Stands in for ops.quant inside models.qwen2 for one run: times the
    host side of each kernel-wrapper call and passes the rest through."""

    def __init__(self):
        self.host_ns = {name: [] for name in KERNEL_WRAPPERS}

    def __getattr__(self, name):
        fn = getattr(quant, name)
        if name not in KERNEL_WRAPPERS:
            return fn
        times = self.host_ns[name]

        def call(*args):
            t0 = time.perf_counter_ns()
            y = fn(*args)
            times.append(time.perf_counter_ns() - t0)
            return y

        return call


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--attention", choices=ATTENTION, default="default")
    ap.add_argument("--bits", type=int, choices=(4, 8), default=None)
    ap.add_argument("--w8a8", action="store_true")
    ap.add_argument("--speculative", type=int, default=0, metavar="D",
                    help="profile generate_speculative with draft length D")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if args.w8a8 and args.bits != 8:
        ap.error("--w8a8 needs --bits 8")
    for name, value in CONFIGS[args.attention].switches.items():
        setattr(qwen2, name, value)
    if args.w8a8:
        quant.MATMUL_MODE = "w8a8"
    label = args.attention + (f"_int{args.bits}" if args.bits else "") + \
        ("_w8a8" if args.w8a8 else "") + (f"_spec{args.speculative}" if args.speculative else "")
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_decode: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg, frozen, trainable, tok = bootstrap.build_model(
        {"llama_model": "Qwen25", "keep_full_llm": True}, device="cuda", seed=0)
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    if args.bits:
        frozen = {**frozen, "llm": serving_tree(frozen["llm"], cfg.llm, f"int{args.bits}")}
    chat = Chat(frozen, trainable, cfg, tok, max_len=640)
    b = args.batch
    rng = np.random.RandomState(0)
    feats = {m: torch.as_tensor(rng.randn(b, 8, d).astype(np.float32), device="cuda")
             .to(torch.bfloat16)
             for m, d in (("frame", cfg.visual_dim), ("face", cfg.visual_dim),
                          ("audio", cfg.acoustic_dim))}
    ids, lengths, offsets = chat.build_prompt_batch(
        "multiface_audio_face_frame_text", [f"subtitle number {i}" for i in range(b)],
        "Please recognize all possible emotional states of the character.")
    embeds = affectgpt.build_inputs_embeds(
        frozen, trainable, cfg, torch.as_tensor(ids, dtype=torch.long, device="cuda"), feats,
        {m: torch.as_tensor(v, dtype=torch.long, device="cuda") for m, v in offsets.items()})
    lengths_t = torch.as_tensor(lengths, device="cuda")
    ids_t = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    iters = []  # verify iterations of each speculative run

    def run(steps=args.steps):
        gcfg = gen.GenerateConfig(max_new_tokens=steps, do_sample=False,
                                  eos_token_id=tok.eos_token_id)
        if args.speculative:
            *out, n = gen.generate_speculative(
                frozen["llm"], cfg.llm, gcfg, embeds, lengths_t, ids_t,
                chat.max_len + args.speculative, draft_len=args.speculative, return_stats=True)
            iters.append(n)
        else:
            out = gen.generate(frozen["llm"], cfg.llm, gcfg, embeds, lengths_t, None,
                               chat.max_len)
        torch.cuda.synchronize()
        return out

    def device_events(prof):
        # device-side events only (kernels, memcpy/memset): the CPU-side aten
        # ops report their children's device time too and would count it twice
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    run()  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prefill_prof:
        run(0)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = device_events(prof)
    device_us = {e.key: e.self_device_time_total for e in kernels}
    total_device_ms = sum(device_us.values()) / 1e3
    # a decode step, or a verify iteration of the speculative loop
    loops = iters[-1] if args.speculative else args.steps
    ops_per_step = (sum(e.count for e in kernels)
                    - sum(e.count for e in device_events(prefill_prof))) / loops
    print(f"[profile] card={card!r} config={label} batch={b} "
          f"prompt_tokens={ids.shape[1]} new_tokens={args.steps} "
          f"{'verify_iterations' if args.speculative else 'decode_steps'}={loops} "
          f"wall_ms={wall_ms:.3f} "
          f"kernel_device_ms={total_device_ms:.3f} "
          f"device_busy_share={total_device_ms / wall_ms:.4f} "
          f"device_ops_per_{'verify' if args.speculative else 'decode_step'}={ops_per_step:.1f}",
          flush=True)
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:20]:
        count = next(e.count for e in kernels if e.key == key)
        print(f"[profile] {us / 1e3:10.3f} ms  {count:6d} calls  {key[:90]}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    stem = os.path.join(args.out, f"torch_profile_decode_{label}")
    with open(stem + ".txt", "w") as f:
        f.write(card + "\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    prof.export_chrome_trace(stem + ".json")
    if args.bits:
        timed = _TimedQuant()
        qwen2.quant = timed
        try:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            qwen2.quant = quant
        for name, ns in timed.host_ns.items():
            if ns:
                us = np.asarray(ns) / 1e3
                print(f"[host] card={card!r} config={label} wrapper={name} calls={len(us)} "
                      f"median_us={np.median(us):.2f} mean_us={us.mean():.2f} "
                      f"total_ms={us.sum() / 1e3:.3f} run_wall_ms={wall_ms:.3f} "
                      f"share_of_wall={us.sum() / 1e3 / wall_ms:.4f}", flush=True)


if __name__ == "__main__":
    main()
