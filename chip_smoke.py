"""GPU smoke run of the PyTorch port (`affectgpt_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (it raises without one) and nvcc. Phases, one line each:

1. Device: card name and power limit (from nvidia-smi), torch, CUDA and
   nvcc versions. TF32 is switched off for matmuls and cuDNN, so every
   float32 product on the plain path is a full float32 product.
2. Build: compiles affectgpt_tpu_torch/csrc into affectgpt_tpu_torch/_build.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, in bf16, at Qwen2.5-7B widths (b = 8 and 64, RoPE positions up
   to 4096). Times of each side: `ms`/`plain_ms` are device time per call
   (calls captured in a CUDA graph, 20 replays, weights read from device
   memory); `eager_*` are eager calls with the L2 flushed before each, which
   include the host's launch overhead.
4. Main path: bootstrap.build_model at Qwen2.5-7B width with random bf16
   weights from a seed, LoRA merged by serving_llm, then Chat.answer_batch
   on 8 preextracted clips, greedy, 32 new tokens. Every decode step of
   every layer must go through both kernels (launch counts of exactly
   layers x steps), all logits must be finite, 8 strings must come back.
   Prints peak memory, prefill ms, decode ms per step and clips/s.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`, printed only when every
phase passed. Every time printed carries the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.inference.chat import Chat
from affectgpt_tpu_torch.models import affectgpt, qwen2
from affectgpt_tpu_torch.ops import _build
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16, decode_mlp_bf16_reference
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv, decode_qkv_reference

# both sides round at the same points (xn and silu·up to bf16), so they
# differ by f32 summation order plus one final bf16 rounding
RTOL, ATOL = 1.6e-2, 1e-2
NEW_TOKENS = 32
BATCH = 8
KERNELS = {
    "decode_qkv": {
        "source": "affectgpt_tpu_torch/csrc/decode_qkv.cu",
        "replaces": "affectgpt_tpu/ops/decode_qkv_pallas.py:121",
    },
    "decode_mlp_bf16": {
        "source": "affectgpt_tpu_torch/csrc/decode_mlp_bf16.cu",
        "replaces": "affectgpt_tpu/ops/decode_mlp_bf16_pallas.py:154",
    },
}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, nvcc=repr(nvcc), tf32="off")
    return smi


def phase_build(card: str) -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    say("build", library=path.name, seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))


def eager_ms(fn, flush: torch.Tensor, iters: int = 25, warmup: int = 3) -> float:
    """Median per-call time of eager calls, L2 flushed before each: the device
    timeline between two events, so it includes any wait for the host's
    Python to launch the call."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(calls, reps: int = 20) -> float:
    """Median device time per call, without host overhead: the calls are
    captured back to back in one CUDA graph, which is replayed `reps` times
    between CUDA events. Callers cycle through enough weight copies that
    every call reads its weights from device memory, not from the 50 MB L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up before capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / len(calls)
    del graph
    return ms


def compare(name: str, got, ref, b: int):
    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
    ref = [r.float() for r in (ref if isinstance(ref, tuple) else (ref,))]
    max_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    max_rel = max(float(((g - r).abs() / r.abs().clamp_min(ATOL)).max()) for g, r in zip(got, ref))
    for g, r in zip(got, ref):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} b={b}: non-finite kernel output")
        torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL, msg=f"{name} b={b} disagrees")
    return max_abs, max_rel


def phase_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """Kernel vs plain version at the main path's widths. Returns per-kernel
    {max_abs_err, ms, plain_ms}: the largest error over all checks, and the
    graph-replayed device time per call at b = BATCH."""
    g = torch.Generator(device="cuda").manual_seed(7)
    dev, bf = "cuda", torch.bfloat16
    h, inter = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(bf)

    # four q/k/v weight sets (4 x 33 MB > L2); the MLP's 407 MB exceed it alone
    qkv_sets = [(rnd(h, nq, scale=0.02), rnd(nq, scale=0.1), rnd(h, nkv, scale=0.02),
                 rnd(nkv, scale=0.1), rnd(h, nkv, scale=0.02), rnd(nkv, scale=0.1))
                for _ in range(4)]
    ln = rnd(h, scale=0.1, shift=1.0)
    wg, wu, wd = rnd(h, inter, scale=0.02), rnd(h, inter, scale=0.02), rnd(inter, h, scale=0.02)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    qkv_kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  head_dim=cfg.head_dim, theta=cfg.rope_theta, eps=cfg.rms_eps)
    out = {name: {"max_abs_err": 0.0} for name in KERNELS}
    for b in (BATCH, 64):
        x = rnd(b, h)
        pos = torch.randint(0, 4097, (b,), generator=g, device=dev, dtype=torch.int32)

        def qkv(f, ln_scale=ln, ws=qkv_sets[0]):
            return f(x, pos, *ws, ln_scale=ln_scale, **qkv_kw)

        for ln_scale in (None, ln):
            err, rel = compare("decode_qkv", qkv(decode_qkv, ln_scale),
                               qkv(decode_qkv_reference, ln_scale), b)
            out["decode_qkv"]["max_abs_err"] = max(out["decode_qkv"]["max_abs_err"], err)
            say("kernels", kernel="decode_qkv", b=b, ln=ln_scale is not None,
                max_abs_err=f"{err:.6g}", max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)
        times = {
            "ms": graph_ms([lambda ws=ws: qkv(decode_qkv, ws=ws) for ws in qkv_sets * 6]),
            "plain_ms": graph_ms([lambda ws=ws: qkv(decode_qkv_reference, ws=ws)
                                  for ws in qkv_sets * 6]),
            "eager_ms": eager_ms(lambda: qkv(decode_qkv), flush),
            "eager_plain_ms": eager_ms(lambda: qkv(decode_qkv_reference), flush),
        }
        say("kernels", kernel="decode_qkv", b=b, **{k: f"{v:.4f}" for k, v in times.items()},
            card=repr(card))
        if b == BATCH:
            out["decode_qkv"].update(ms=times["ms"], plain_ms=times["plain_ms"])

        def mlp(f):
            return f(x, ln, wg, wu, wd, eps=cfg.rms_eps)

        err, rel = compare("decode_mlp_bf16", mlp(decode_mlp_bf16),
                           mlp(decode_mlp_bf16_reference), b)
        out["decode_mlp_bf16"]["max_abs_err"] = max(out["decode_mlp_bf16"]["max_abs_err"], err)
        say("kernels", kernel="decode_mlp_bf16", b=b, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)
        times = {
            "ms": graph_ms([lambda: mlp(decode_mlp_bf16)] * 8),
            "plain_ms": graph_ms([lambda: mlp(decode_mlp_bf16_reference)] * 8),
            "eager_ms": eager_ms(lambda: mlp(decode_mlp_bf16), flush),
            "eager_plain_ms": eager_ms(lambda: mlp(decode_mlp_bf16_reference), flush),
        }
        say("kernels", kernel="decode_mlp_bf16", b=b,
            **{k: f"{v:.4f}" for k, v in times.items()}, card=repr(card))
        if b == BATCH:
            out["decode_mlp_bf16"].update(ms=times["ms"], plain_ms=times["plain_ms"])
    del qkv_sets, wg, wu, wd, flush
    torch.cuda.empty_cache()
    return out


SUBTITLES = [
    "I can't believe you did that for me.",
    "Leave me alone, I said I'm fine.",
    "We won! We actually won the final!",
    "Why does this always happen to me?",
    "Oh, so now you remember my birthday.",
    "Please, just tell me the truth.",
    "That noise again... did you hear it?",
    "Fine. Whatever you want.",
]
QUESTION = "Please recognize all possible emotional states of the character."


def phase_main_path(card: str) -> dict:
    torch.cuda.reset_peak_memory_stats()
    cfg, frozen, trainable, tok = bootstrap.build_model(
        {"llama_model": "Qwen25", "keep_full_llm": True}, device="cuda", seed=0)
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    assert cfg.llm == qwen2.QwenConfig.qwen25_7b(), cfg.llm
    chat = Chat(frozen, trainable, cfg, tok, max_len=640)
    rng = np.random.RandomState(0)
    feats = {
        m: torch.as_tensor(rng.randn(BATCH, 8, d).astype(np.float32), device="cuda").to(torch.bfloat16)
        for m, d in (("frame", cfg.visual_dim), ("face", cfg.visual_dim), ("audio", cfg.acoustic_dim))
    }
    mode = "multiface_audio_face_frame_text"

    # the counted run: every launch of the main path, nothing else
    finite = []
    forward = qwen2.forward

    def checked_forward(*args, **kwargs):
        logits, cache = forward(*args, **kwargs)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    qwen2.forward = checked_forward
    decode_qkv.launches = 0
    decode_mlp_bf16.launches = 0
    try:
        texts = chat.answer_batch(mode, SUBTITLES, QUESTION, feats,
                                  max_new_tokens=NEW_TOKENS, do_sample=False)
        torch.cuda.synchronize()
    finally:
        qwen2.forward = forward
    launches = {"decode_qkv": decode_qkv.launches, "decode_mlp_bf16": decode_mlp_bf16.launches}
    expected = cfg.llm.num_layers * NEW_TOKENS
    say("main", launches=json.dumps(launches), expected_each=expected,
        forwards=len(finite), strings=len(texts))
    if launches != {name: expected for name in KERNELS}:
        raise AssertionError(f"kernel launches {launches} != {expected} each")
    if len(finite) != NEW_TOKENS + 1 or not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits on the main path")
    if len(texts) != BATCH or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"expected {BATCH} strings, got {texts!r}")
    say("main", sample=json.dumps(texts[0][:60]))

    # timings: whole answer_batch calls, then prefill alone (0 new tokens)
    # and prefill + decode on the same spliced embeddings
    def wall(fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    total_ms = wall(lambda: chat.answer_batch(mode, SUBTITLES, QUESTION, feats,
                                              max_new_tokens=NEW_TOKENS, do_sample=False))
    ids, lengths, offsets = chat.build_prompt_batch(mode, SUBTITLES, QUESTION)
    embeds = affectgpt.build_inputs_embeds(
        chat.frozen, chat.trainable, cfg, torch.as_tensor(ids, dtype=torch.long, device="cuda"),
        feats, {m: torch.as_tensor(v, dtype=torch.long, device="cuda") for m, v in offsets.items()})
    lengths_t = torch.as_tensor(lengths, device="cuda")

    def run(n):
        gcfg = gen.GenerateConfig(max_new_tokens=n, do_sample=False,
                                  eos_token_id=tok.eos_token_id)
        return gen.generate(chat.frozen["llm"], cfg.llm, gcfg, embeds, lengths_t, None,
                            max_len=chat.max_len)

    prefill_ms = wall(lambda: run(0))
    decode_ms = (wall(lambda: run(NEW_TOKENS)) - prefill_ms) / NEW_TOKENS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    say("main", prompt_tokens=ids.shape[1], batch=BATCH, new_tokens=NEW_TOKENS,
        peak_mem_gib=f"{peak_gib:.3f}", prefill_ms=f"{prefill_ms:.3f}",
        decode_ms_per_step=f"{decode_ms:.4f}", answer_batch_ms=f"{total_ms:.3f}",
        clips_per_s=f"{BATCH / (total_ms / 1e3):.4f}", card=repr(card))
    return launches


def main() -> None:
    card = phase_device()
    phase_build(card)
    kernels = phase_kernels(card, qwen2.QwenConfig.qwen25_7b())
    launches = phase_main_path(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name], "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"]}
        for name in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
