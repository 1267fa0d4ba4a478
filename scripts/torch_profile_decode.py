"""Where the time of the PyTorch port's decode goes, on one CUDA card.

    python3 scripts/torch_profile_decode.py [--steps 8] [--batch 8]

Builds the port's main path as chip_smoke.py does (Qwen2.5-7B width, random
bf16 weights from a seed, LoRA merged, 8 preextracted clips), runs one
warm generate, then profiles prefill plus `--steps` greedy decode steps with
torch.profiler. Prints the card's name and power limit, the host wall time,
the summed device time of all kernels, and the kernels ranked by device
time; writes the full table and a Chrome trace to chiprun_out/.
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
from affectgpt_tpu_torch.models import affectgpt  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
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
    gcfg = gen.GenerateConfig(max_new_tokens=args.steps, do_sample=False,
                              eos_token_id=tok.eos_token_id)

    def run():
        out = gen.generate(frozen["llm"], cfg.llm, gcfg, embeds, lengths_t, None, chat.max_len)
        torch.cuda.synchronize()
        return out

    run()  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only (kernels, memcpy/memset): the CPU-side aten ops
    # report their children's device time too and would count it twice
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = {e.key: e.self_device_time_total for e in kernels}
    total_device_ms = sum(device_us.values()) / 1e3
    print(f"[profile] card={card!r} batch={b} prompt_tokens={ids.shape[1]} "
          f"decode_steps={args.steps} wall_ms={wall_ms:.3f} "
          f"kernel_device_ms={total_device_ms:.3f} "
          f"device_busy_share={total_device_ms / wall_ms:.4f}", flush=True)
    for key, us in sorted(device_us.items(), key=lambda kv: -kv[1])[:15]:
        count = next(e.count for e in kernels if e.key == key)
        print(f"[profile] {us / 1e3:10.3f} ms  {count:6d} calls  {key[:90]}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "torch_profile_decode.txt"), "w") as f:
        f.write(card + "\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(args.out, "torch_profile_decode.json"))


if __name__ == "__main__":
    main()
