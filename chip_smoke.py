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
   include the host's launch overhead. The attention kernels are checked at
   T = 640 and at a T that is not a multiple of their 64-column tile, with
   ragged per-row windows of valid cache columns (decode) and prompt lengths
   545-564 left-packed into t = 564 (prefill); `library_ms` times one PyTorch
   call that computes the same function (scaled_dot_product_attention with
   GQA and a bool mask), a yardstick the port never calls. `bound_ms` is
   the least time the card could take: bytes moved at 3.35 TB/s or
   operations at 989 TFLOP/s (bf16) or 1979 TOPS (int8), whichever is
   larger, counted from this run's inputs (valid cache columns and visible
   key pairs only). The four quantized matmuls are checked at every (K, N)
   of the 7B split and fused layouts and the lm_head, at the M the main path
   routes to each plus a ragged one; their times are per decoder layer at
   the main path's M (the sum of the layer's products, each timed alone),
   with `bf16_cublas_ms`, torch.matmul on the same weights dequantized to
   bf16, as a yardstick of the unquantized product that no path runs; the
   w8a8 kernel (wgmma) must also give the same bits on a second call, and
   prints its variant (wgmma N-width, K splits) and the bytes it reads. The
   serving kernels: paged attention (bf16 and int8 pools of 2048 blocks of
   16, 16 rows of 545-596 tokens plus a 1-token row and a one-page row,
   pages drawn from a shuffled permutation, table widths 38 and 64; times
   at width 38 over three disjoint table sets on two pools, so a replay
   cycle reads more than the L2; `chain_ms` times the gather chain that
   PAGED_ATTENTION="xla" runs, inference/paged.py) and the int8 decode MLP
   (b = 8, 16, 64 on int8 weights of the 7B layer; times at b = 16, with
   the three products in cuBLAS on the dequantized bf16 weights as a
   yardstick); neither has a single PyTorch call that computes its
   function, so `library_ms` is null. The two kernels redesigned last, the
   decode MLP (tensor cores) and the encoder MLP sublayer (wgmma + TMA),
   must give the same bits on a second call and print `old_ms`, the
   previous design's time (a variant of the same C entry), and a `variant`
   dict with their tiles, rings and grids and `no_products_ms`, the time
   of the variant without the tensor-core products.
   The encoder kernels at the towers' widths (ViT-L/14 and HuBERT-large:
   w = 1024, 16 heads of 64, I = 4096), 64 images or clips: CLIP's 257
   tokens, 264 with valid_len 257 and HuBERT's 99; both activations of the
   MLP kernels, both accumulations of the fused one (the bf16 accumulator is
   allowed one more bf16 ulp of its running sum's peak: a rounding that
   parts there outlives the later chunks; the fused kernel, on wgmma, must
   give the same bits on a second call and prints its variant and L2
   bytes). Times at CLIP's shape (and HuBERT's for the sublayer, the MLP
   pair and the fused MLP), four layers' weights per replay cycle;
   `library_ms` is SDPA with the bool key mask for the attention, and the
   sublayers print their library chains' times (layer_norm, addmm, SDPA or
   the activation, addmm) as `chain_ms`, as do the bf16 decode kernels
   (rms_norm, addmm, RoPE; rms_norm, matmul, silu * up, addmm) and
   decode_attn_o (SDPA, addmm).
4. Main path: bootstrap.build_model at Qwen2.5-7B width with random bf16
   weights from a seed, LoRA merged by serving_llm, then Chat.answer_batch
   on 8 preextracted clips, greedy, 32 new tokens, under three attention
   configurations of models/qwen2.py: the default (plain attention), (a)
   PREFILL_ATTENTION="flash" with DECODE_ATTN_O="pallas", and (b)
   PREFILL_ATTENTION="flash" with DECODE_ATTENTION="pallas"; then under five
   quantized configurations of the same merged weights, built as
   inference_hybird.py builds them (fuse_qkv_gateup, then quantize_params):
   q4 (int4, b = 8), q4_b16 (the same tree, 16 clips), decode_llm (bf16
   prefill, generate(decode_llm=) with the int4 tree for the decode loop,
   as bench.py's mixed-precision mode calls it), q8_fused (qkv and gate/up
   fused, int8) and q8a8 (int8, MATMUL_MODE="w8a8"); and qkv_xla
   (qwen2.DECODE_QKV="xla", counted only, not timed). Each run must launch
   every kernel of its configuration exactly as often as the path calls it
   and the others not at all; all logits must be finite, one string per
   clip must come back. Then each configuration is timed in the order
   default, a, b, q4, q4_b16, decode_llm, q8_fused, q8a8 and back, (a) and
   (b) only on the way there (their numbers stand in PERF.md since they
   were ported; the quantized decode steps make this phase long); prints
   peak memory and the mean prefill ms, decode ms per step and clips/s of
   the visits, with each visit's numbers.
5. Serve: the continuous-batching engines on the merged model of phase 4,
   built as inference_hybird.py's make_paged_server builds the paged one
   (block 16, 2048 blocks, tables for the longest prompt + 32 tokens, 16
   slots, reserve admission, bursts of 8, greedy), over 48 requests (the 8
   clips six times, prompts from Chat.build_prompt_batch, max_new_tokens
   cycling 32, 24, 16, 8), all submitted up front: paged_bf16 (bf16 tree
   and pool, PAGED_ATTENTION="pallas"), paged_bf16_gather (the same with
   the gather chain, PAGED_ATTENTION="xla"), paged_kv8 (int8 pool),
   paged_w8 (int8 split tree, DECODE_MLP="pallas") and server_bf16 (the
   dense BatchServer, 16 slots, max_len 640). One counted run each asserts
   that each kernel of the configuration launched num_layers x the decode
   steps the engine made (int8_matmul by its own count), every other kernel
   0 times, one result per request and finite logits; it prints how many
   requests' tokens paged_bf16, paged_bf16_gather and server_bf16 share
   pairwise; then one timed run each prints requests/s, TTFT and end-to-end
   percentiles, generated tokens/s, the engine's phase times and counters,
   the cache's GiB and the peak memory.
6. Realtime: the phase-4 model, built with_encoders=True (CLIP ViT-L/14 and
   HuBERT-large beside the LLM), answers 8 clips from raw media made from a
   seed (720p frames, 112² face crops, 2 s of 16 kHz audio) through
   encode_media_features and Chat.answer_batch under five configurations of
   the towers' switches (RT); a counted run each asserts the exact encoder
   launches (24 layers per tower call) beside the LLM's, finite features and
   logits and one string per clip, and prints the features' distance from
   rt_plain's; timed visits print the stages' ms, clips/s from raw media to
   text and the peak memory.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`, printed only when every
phase passed. Every time printed carries the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import time
from typing import Callable, Optional

import numpy as np
import torch

from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.inference import paged, server
from affectgpt_tpu_torch.inference.chat import Chat, encode_media_features, prepare_frames
from affectgpt_tpu_torch.models import affectgpt, clip_vit, encoders, hubert, nn, qwen2
from affectgpt_tpu_torch.ops import _build, quant, vit_mlp
from affectgpt_tpu_torch.ops import decode_mlp as decode_mlp_module
from affectgpt_tpu_torch.ops.vit_attention import (
    fused_vit_attention,
    fused_vit_attention_reference,
)
from affectgpt_tpu_torch.ops import vit_mlp_fused
from affectgpt_tpu_torch.ops.vit_mlp import activation, mlp_sublayer, mlp_sublayer_reference
from affectgpt_tpu_torch.ops.vit_mlp_fused import (
    chunks_for,
    mlp_sublayer_fused,
    mlp_sublayer_fused_reference,
)
from affectgpt_tpu_torch.ops.vit_sublayer import (
    attn_sublayer,
    attn_sublayer_reference,
    dot_f32,
    layernorm_rounded,
)
from affectgpt_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference
from affectgpt_tpu_torch.ops.decode_attn_o import decode_attn_o, decode_attn_o_reference
from affectgpt_tpu_torch.ops.decode_mlp import decode_mlp, decode_mlp_plan, decode_mlp_reference
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import decode_mlp_bf16, decode_mlp_bf16_reference
from affectgpt_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
)
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv, decode_qkv_reference
from affectgpt_tpu_torch.ops.prefill_attention import (
    prefill_attention,
    prefill_attention_reference,
)

# both sides round at the same points (xn and silu·up to bf16, attention
# before o_proj), so they differ by f32 summation order plus one final bf16
# rounding; the prefill kernel also rounds p to bf16 for its PV product
RTOL, ATOL = 1.6e-2, 1e-2
NEW_TOKENS = 32
BATCH = 8
MAX_LEN = 640
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
S8_OPS_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores
KERNELS = {
    "decode_qkv": {
        "source": "affectgpt_tpu_torch/csrc/decode_qkv.cu",
        "replaces": "affectgpt_tpu/ops/decode_qkv_pallas.py:121",
    },
    "decode_mlp_bf16": {
        "source": "affectgpt_tpu_torch/csrc/decode_mlp_bf16.cu",
        "replaces": "affectgpt_tpu/ops/decode_mlp_bf16_pallas.py:154",
    },
    "decode_attention": {
        "source": "affectgpt_tpu_torch/csrc/decode_attention.cu",
        "replaces": "affectgpt_tpu/ops/decode_attention_pallas.py:64",
    },
    "decode_attn_o": {
        "source": "affectgpt_tpu_torch/csrc/decode_attn_o.cu",
        "replaces": "affectgpt_tpu/ops/decode_attn_o_pallas.py:140",
    },
    "prefill_attention": {
        "source": "affectgpt_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "affectgpt_tpu/models/qwen2.py:681",
    },
    "int4_matmul_smallm": {
        "source": "affectgpt_tpu_torch/csrc/int4_matmul_smallm.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:407",
    },
    "int4_matmul": {
        "source": "affectgpt_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:319",
    },
    "int8_matmul": {
        "source": "affectgpt_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:90",
    },
    "int8_matmul_w8a8": {
        "source": "affectgpt_tpu_torch/csrc/int8_matmul_w8a8.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:163",
    },
    "paged_attention": {  # _kernel, bf16 pools
        "source": "affectgpt_tpu_torch/csrc/paged_attention.cu",
        "replaces": "affectgpt_tpu/ops/paged_attention_pallas.py:245",
    },
    "paged_attention_int8": {  # _kernel_int8, int8 pools with scales
        "source": "affectgpt_tpu_torch/csrc/paged_attention.cu",
        "replaces": "affectgpt_tpu/ops/paged_attention_pallas.py:245",
    },
    "decode_mlp": {
        "source": "affectgpt_tpu_torch/csrc/decode_mlp_int8.cu",
        "replaces": "affectgpt_tpu/ops/decode_mlp_pallas.py:122",
    },
    "attn_sublayer": {
        "source": "affectgpt_tpu_torch/csrc/vit_sublayer.cu",
        "replaces": "affectgpt_tpu/ops/vit_sublayer_pallas.py:105",
    },
    "mlp_sublayer": {
        "source": "affectgpt_tpu_torch/csrc/vit_mlp.cu",
        "replaces": "affectgpt_tpu/ops/vit_mlp_pallas.py:116",
    },
    "fused_vit_attention": {
        "source": "affectgpt_tpu_torch/csrc/vit_attention.cu",
        "replaces": "affectgpt_tpu/ops/vit_attention_pallas.py:79",
    },
    "mlp_sublayer_fused": {
        "source": "affectgpt_tpu_torch/csrc/vit_mlp_fused.cu",
        "replaces": "affectgpt_tpu/ops/vit_mlp_fused_pallas.py:161",
    },
}
WRAPPERS = {"decode_qkv": decode_qkv, "decode_mlp_bf16": decode_mlp_bf16,
            "decode_attention": decode_attention, "decode_attn_o": decode_attn_o,
            "prefill_attention": prefill_attention,
            "int4_matmul_smallm": quant.int4_matmul_smallm, "int4_matmul": quant.int4_matmul,
            "int8_matmul": quant.int8_matmul, "int8_matmul_w8a8": quant.int8_matmul_w8a8,
            "paged_attention": paged_attention, "paged_attention_int8": paged_attention_int8,
            "decode_mlp": decode_mlp, "attn_sublayer": attn_sublayer,
            "mlp_sublayer": mlp_sublayer, "fused_vit_attention": fused_vit_attention,
            "mlp_sublayer_fused": mlp_sublayer_fused}


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


def bound(nbytes: float, flops: float, ops_per_s: float = BF16_FLOP_PER_S) -> dict:
    """The least time the card could take for work that moves `nbytes` and
    does `flops` operations at `ops_per_s`, and which of the two bounds it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def compare(name: str, got, ref, b: int, extra_atol=None):
    """Largest absolute and relative error of the kernel's outputs against
    the plain version's; raises unless every element is within
    ATOL (+ extra_atol, an elementwise tensor, where given) + RTOL·|ref|."""
    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
    ref = [r.float() for r in (ref if isinstance(ref, tuple) else (ref,))]
    max_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    max_rel = max(float(((g - r).abs() / r.abs().clamp_min(ATOL)).max()) for g, r in zip(got, ref))
    for g, r in zip(got, ref):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} b={b}: non-finite kernel output")
        if extra_atol is None:
            torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL, msg=f"{name} b={b} disagrees")
            continue
        over = (g - r).abs() > ATOL + extra_atol + RTOL * r.abs()
        if bool(over.any()):
            raise AssertionError(f"{name} b={b} disagrees at {int(over.sum())} elements")
    return max_abs, max_rel


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |value| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def bf16_acc_peak(x, s: dict, act: str) -> torch.Tensor:
    """Per output element, the largest |running sum| that
    mlp_sublayer_fused's bf16 accumulator rounds over its chunks, in the
    plain version's arithmetic. Where the kernel's and the plain f32 sums
    round one of these running sums differently, the one-ulp difference
    outlives the later chunks, so the bf16-accumulator check allows one ulp
    of this peak beyond the usual tolerance."""
    h = layernorm_rounded(x, s["lns"], s["lnb"], 1e-5)
    inter = s["wi"].shape[1]
    kc = inter // chunks_for(inter, vit_mlp_fused.K_CHUNKS)
    out = peak = None
    for c0 in range(0, inter, kc):
        t = activation(dot_f32(h, s["wi"][:, c0:c0 + kc]) + s["bi"][c0:c0 + kc].float(), act)
        part = dot_f32(t.to(x.dtype), s["wf"][c0:c0 + kc])
        out = (x.float() + s["bf"].float() + part if out is None
               else out.float() + part).to(x.dtype)
        peak = out.float().abs() if peak is None else torch.maximum(peak, out.float().abs())
    return peak


def rope_rows(t, cos, sin):
    """RoPE (half-split) on [b, heads, d] in f32, in library calls."""
    t1, t2 = t.float().chunk(2, dim=-1)
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1).to(t.dtype)


def library_qkv_chain(x, ln, wqkv, bqkv, cos, sin, cfg: qwen2.QwenConfig):
    """decode_qkv in library calls: rms_norm, one addmm for q/k/v with their
    biases, RoPE on q and k (a yardstick)."""
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    xn = torch.nn.functional.rms_norm(x, (x.shape[-1],), ln, cfg.rms_eps)
    q, k, v = torch.addmm(bqkv, xn, wqkv).split((nq, nkv, nkv), dim=-1)
    b = x.shape[0]
    return (rope_rows(q.view(b, cfg.num_heads, -1), cos, sin),
            rope_rows(k.view(b, cfg.num_kv_heads, -1), cos, sin), v)


def library_mlp_bf16_chain(x, ln, wgu, wd, eps: float):
    """decode_mlp_bf16 in library calls: rms_norm, one matmul for gate and
    up, silu * up, addmm of down onto the residual (a yardstick)."""
    xn = torch.nn.functional.rms_norm(x, (x.shape[-1],), ln, eps)
    g, u = (xn @ wgu).chunk(2, dim=-1)
    return torch.addmm(x, torch.nn.functional.silu(g) * u, wd)


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
    qkv_cat = [(torch.cat(ws[0::2], dim=1), torch.cat(ws[1::2])) for ws in qkv_sets]
    ln = rnd(h, scale=0.1, shift=1.0)
    wg, wu, wd = rnd(h, inter, scale=0.02), rnd(h, inter, scale=0.02), rnd(inter, h, scale=0.02)
    wgu = torch.cat([wg, wu], dim=1)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    qkv_kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                  head_dim=cfg.head_dim, theta=cfg.rope_theta, eps=cfg.rms_eps)
    out = {name: {"max_abs_err": 0.0} for name in ("decode_qkv", "decode_mlp_bf16")}
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
        freqs = 1.0 / (cfg.rope_theta ** (torch.arange(0, cfg.head_dim, 2, device=dev)
                                          / cfg.head_dim))
        angles = pos[:, None, None].float() * freqs
        cos, sin = torch.cos(angles), torch.sin(angles)
        times = {
            "ms": graph_ms([lambda ws=ws: qkv(decode_qkv, ws=ws) for ws in qkv_sets * 6]),
            "plain_ms": graph_ms([lambda ws=ws: qkv(decode_qkv_reference, ws=ws)
                                  for ws in qkv_sets * 6]),
            "chain_ms": graph_ms([lambda wb=wb: library_qkv_chain(x, ln, *wb, cos, sin, cfg)
                                  for wb in qkv_cat * 6]),
            "eager_ms": eager_ms(lambda: qkv(decode_qkv), flush),
            "eager_plain_ms": eager_ms(lambda: qkv(decode_qkv_reference), flush),
        }
        say("kernels", kernel="decode_qkv", b=b, **{k: f"{v:.4f}" for k, v in times.items()},
            card=repr(card))
        if b == BATCH:
            n_out = nq + 2 * nkv  # weights and biases, x and ln read; q, k, v written
            out["decode_qkv"].update(ms=times["ms"], plain_ms=times["plain_ms"],
                                     library_ms=None,
                                     **bound(2 * (h * n_out + n_out + h + b * h + b * n_out)
                                             + 4 * b, 2 * b * h * n_out))

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
            "chain_ms": graph_ms([lambda: library_mlp_bf16_chain(x, ln, wgu, wd, cfg.rms_eps)]
                                 * 8),
            "eager_ms": eager_ms(lambda: mlp(decode_mlp_bf16), flush),
            "eager_plain_ms": eager_ms(lambda: mlp(decode_mlp_bf16_reference), flush),
        }
        say("kernels", kernel="decode_mlp_bf16", b=b,
            **{k: f"{v:.4f}" for k, v in times.items()}, card=repr(card))
        if b == BATCH:
            out["decode_mlp_bf16"].update(ms=times["ms"], plain_ms=times["plain_ms"],
                                          library_ms=None,
                                          **bound(2 * (3 * h * inter + h + 2 * b * h),
                                                  6 * b * h * inter))
    del qkv_sets, qkv_cat, wg, wu, wd, wgu, flush
    torch.cuda.empty_cache()
    return out


def decode_window_mask(g: torch.Generator, b: int, t_len: int) -> torch.Tensor:
    """Valid cache columns of a decode step, [b, T] bool: left pads (0-19
    columns) invalid, then valid through a write index in [T - 95, T - 2]."""
    lo = torch.randint(0, 20, (b,), generator=g, device="cuda")
    hi = torch.randint(t_len - 95, t_len - 1, (b,), generator=g, device="cuda")
    cols = torch.arange(t_len, device="cuda")
    return (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])


def phase_attention_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """The attention kernels against their plain versions at the main path's
    widths, T = 640 and 577 (not a multiple of the 64-column tile) for the
    decode kernels, prompt lengths 545-564 for the prefill. Returns
    per-kernel {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}:
    the largest error over all checks, and device times per call at b = BATCH
    (T = 640 for the decode kernels)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    kv, d, h = cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    heads, groups = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    nq = heads * d
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    out = {name: {"max_abs_err": 0.0}
           for name in ("decode_attention", "decode_attn_o", "prefill_attention")}

    def check(name, got, ref, b, **shape):
        err, rel = compare(name, got, ref, b)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        say("kernels", kernel=name, b=b, **shape, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)

    def record(name, b, calls, plain_calls, library_calls, nbytes, flops, library_err=None):
        times = {"ms": graph_ms(calls), "plain_ms": graph_ms(plain_calls),
                 "library_ms": graph_ms(library_calls) if library_calls else None}
        cost = bound(nbytes, flops)
        say("kernels", kernel=name, b=b,
            **{k: "null" if v is None else f"{v:.4f}" for k, v in times.items()},
            bound_ms=f"{cost['bound_ms']:.5f}", bound_by=cost["bound_by"], card=repr(card))
        if library_calls:
            say("library", kernel=name, b=b, call="scaled_dot_product_attention(enable_gqa=True)",
                library_ms=f"{times['library_ms']:.4f}",
                max_abs_err_vs_plain=f"{library_err:.6g}", card=repr(card))
        if b == BATCH:
            out[name].update(times, **cost)

    for b in (BATCH, 64):
        for t_len in (MAX_LEN, 577):
            q = rnd(b, kv, groups, d)
            mask = decode_window_mask(g, b, t_len)
            x = rnd(b, h)
            set_bytes = 2 * b * kv * t_len * d * 2 + nq * h * 2
            copies = max(2, -(-64 * 2**20 // set_bytes))  # > 50 MB of L2 per replay cycle
            sets = [(rnd(b, kv, t_len, d), rnd(b, kv, t_len, d), rnd(nq, h, scale=0.02))
                    for _ in range(copies)]
            k, v, wo = sets[0]
            check("decode_attention", decode_attention(q, k, v, mask),
                  decode_attention_reference(q, k, v, mask), b, T=t_len)
            check("decode_attn_o", decode_attn_o(x, q, k, v, mask, wo),
                  decode_attn_o_reference(x, q, k, v, mask, wo), b, T=t_len)
            if t_len != MAX_LEN:
                continue
            valid = int(mask.sum())  # valid (row, column) pairs: the K/V rows needed
            kv_bytes = 2 * valid * kv * d * 2
            qk_pv_flops = 4 * valid * kv * groups * d
            q4, mask4 = q.reshape(b, heads, 1, d), mask[:, None, None, :]
            lib_err = float((sdpa(q4, k, v, attn_mask=mask4, enable_gqa=True).reshape(q.shape)
                             .float() - decode_attention_reference(q, k, v, mask).float())
                            .abs().max())
            reps = max(1, 24 // copies)
            record("decode_attention", b,
                   [lambda k=k, v=v: decode_attention(q, k, v, mask) for k, v, _ in sets] * reps,
                   [lambda k=k, v=v: decode_attention_reference(q, k, v, mask)
                    for k, v, _ in sets] * reps,
                   [lambda k=k, v=v: sdpa(q4, k, v, attn_mask=mask4, enable_gqa=True)
                    for k, v, _ in sets] * reps,
                   kv_bytes + 2 * 2 * q.numel() + b * t_len, qk_pv_flops, lib_err)
            record("decode_attn_o", b,
                   [lambda k=k, v=v, wo=wo: decode_attn_o(x, q, k, v, mask, wo)
                    for k, v, wo in sets] * reps,
                   [lambda k=k, v=v, wo=wo: decode_attn_o_reference(x, q, k, v, mask, wo)
                    for k, v, wo in sets] * reps,
                   None, kv_bytes + 2 * (q.numel() + nq * h + 2 * b * h) + b * t_len,
                   qk_pv_flops + 2 * b * nq * h)
            # its library chain: SDPA, then addmm of o_proj onto the residual
            chain = graph_ms([lambda k=k, v=v, wo=wo: torch.addmm(
                x, sdpa(q4, k, v, attn_mask=mask4, enable_gqa=True).reshape(b, nq), wo)
                for k, v, wo in sets] * reps)
            say("kernels", kernel="decode_attn_o", b=b, chain_ms=f"{chain:.4f}", card=repr(card))
            del sets, k, v, wo

        # prefill: prompts of 545-564 tokens left-packed into t = 564
        t_len = 564
        lengths = torch.randint(545, t_len + 1, (b,), generator=g, device="cuda")
        seg = torch.arange(t_len, device="cuda")[None, :] >= (t_len - lengths)[:, None]
        q, k, v = rnd(b, t_len, heads, d), rnd(b, kv, t_len, d), rnd(b, kv, t_len, d)
        check("prefill_attention", prefill_attention(q, k, v, seg),
              prefill_attention_reference(q, k, v, seg), b, t=t_len,
              lengths=f"{int(lengths.min())}-{int(lengths.max())}")
        causal = torch.ones((t_len, t_len), dtype=torch.bool, device="cuda").tril()
        visible = causal[None] & (seg[:, :, None] == seg[:, None, :])  # [b, query, key]
        pairs = int(visible.sum())
        qh, vis4 = q.transpose(1, 2), visible[:, None]
        lib_err = float((sdpa(qh, k, v, attn_mask=vis4, enable_gqa=True).transpose(1, 2)
                         .reshape(b, t_len, nq).float()
                         - prefill_attention_reference(q, k, v, seg).float()).abs().max())
        record("prefill_attention", b, [lambda: prefill_attention(q, k, v, seg)] * 4,
               [lambda: prefill_attention_reference(q, k, v, seg)] * 2,
               [lambda: sdpa(qh, k, v, attn_mask=vis4, enable_gqa=True)] * 2,
               2 * (q.numel() + k.numel() + v.numel() + b * t_len * nq) + b * t_len,
               4 * d * heads * pairs, lib_err)
        del q, k, v, qh, visible, vis4
        torch.cuda.empty_cache()
    return out


def layer_shapes(cfg: qwen2.QwenConfig, fused: bool) -> dict:
    """(K, N) of one decoder layer's products, split or fused layout."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    if fused:
        return {"qkv_proj": (h, nq + 2 * nkv), "o_proj": (nq, h), "gateup_proj": (h, 2 * inter),
                "down_proj": (inter, h)}
    return {"q_proj": (h, nq), "k_proj": (h, nkv), "v_proj": (h, nkv), "o_proj": (nq, h),
            "gate_proj": (h, inter), "up_proj": (h, inter), "down_proj": (inter, h)}


# kernel: (weight bits, plain version, the M checked, the main path's M, its
# layer layout is fused, its operation rate)
QUANT_PHASE = {
    "int4_matmul_smallm": (4, quant.int4_matmul_smallm_reference, (1, 8, 13), 8, False,
                           BF16_FLOP_PER_S),
    "int4_matmul": (4, quant.int4_matmul_reference, (16, 64, 1000), 16, False, BF16_FLOP_PER_S),
    "int8_matmul": (8, quant.int8_matmul_reference, (8, 64, 1000), 8, True, BF16_FLOP_PER_S),
    "int8_matmul_w8a8": (8, quant.int8_matmul_w8a8_reference, (8, 4512), 8, False,
                         S8_OPS_PER_S),
}


def w8a8_variant(m: int, n: int, k: int) -> dict:
    """What the w8a8 wrapper launches for x [m, k] @ w [k, n]: the wgmma
    N-width (row tile), the K splits and the bytes its product reads."""
    plan = quant.w8a8_plan(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"variant": f"wgmma_m64n{plan['bm']}k32_s8", "splits": plan["splits"],
            "l2_read_bytes": plan["l2_bytes"]}


def phase_quant_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """The quantized matmuls against their plain versions at every (K, N) of
    the 7B split and fused layouts and the lm_head, with random int8 bytes
    or int4 nibbles and random positive scales (so a wrong scale row shows).
    Returns per-kernel {max_abs_err, ms, plain_ms, bf16_cublas_ms, bound_ms,
    bound_by, library_ms}: device times summed over one decoder layer's
    products at the main path's M, each product timed alone (CUDA graph,
    enough weight copies per replay to exceed the 50 MB L2)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    shapes = {**layer_shapes(cfg, False), **layer_shapes(cfg, True),
              "lm_head": (cfg.hidden_size, cfg.vocab_size)}
    by_kn = {}
    for name, kn in shapes.items():
        by_kn.setdefault(kn, []).append(name)

    def weights(bits, k, n):
        sigma = k ** -0.5
        if bits == 4:
            w = torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda",
                              dtype=torch.int8)
            s = (torch.rand((k // quant.INT4_GROUP, n), generator=g, device="cuda") + 0.5) \
                * (3 * sigma / 7)
        else:
            w = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
            s = (torch.rand((1, n), generator=g, device="cuda") + 0.5) * (3 * sigma / 127)
        return w, s

    def dequant_bf16(bits, w, s):
        if bits == 4:
            return quant._int4_dequant(w, s).to(torch.bfloat16)
        return (w.float() * s).to(torch.bfloat16)

    stored = {bits: {kn: weights(bits, *kn) for kn in by_kn} for bits in (4, 8)}
    out = {}
    for name, (bits, plain, ms_checked, m_path, fused, ops_rate) in QUANT_PHASE.items():
        kernel = getattr(quant, name)
        err_max = 0.0
        for (k, n), names in by_kn.items():
            w, s = stored[bits][(k, n)]
            for m in ms_checked:
                x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
                got = kernel(x, w, s)
                err, rel = compare(name, got, plain(x, w, s), m)
                err_max = max(err_max, err)
                extra = {}
                if name == "int8_matmul_w8a8":  # the redesign: same bits twice, its variant
                    if not torch.equal(got, kernel(x, w, s)):
                        raise AssertionError(f"{name} M={m} K={k} N={n}: two calls differ")
                    extra = w8a8_variant(m, n, k)
                say("kernels", kernel=name, M=m, K=k, N=n, shapes="/".join(names),
                    max_abs_err=f"{err:.6g}", max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL,
                    **extra)
        # the main path's M first; w8a8 also at its prefill M
        per_layer = []
        for m in (m_path, max(ms_checked)) if name == "int8_matmul_w8a8" else (m_path,):
            layer = layer_shapes(cfg, fused)
            sums = dict.fromkeys(("ms", "plain_ms", "bf16_cublas_ms"), 0.0)
            nbytes = flops = 0
            for pname, (k, n) in {**layer, "lm_head": shapes["lm_head"]}.items():
                w, s = stored[bits][(k, n)]
                x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
                wbytes = w.numel() + s.numel() * 4  # packed weight and its f32 scales
                copies = max(1, -(-64 * 2**20 // wbytes))
                ws = [(w, s)] + [(w.clone(), s.clone()) for _ in range(copies - 1)]
                wb = dequant_bf16(bits, w, s)
                bcopies = max(1, -(-64 * 2**20 // (wb.numel() * 2)))
                wbs = [wb] + [wb.clone() for _ in range(bcopies - 1)]
                times = {
                    "ms": graph_ms([lambda w=w, s=s: kernel(x, w, s) for w, s in ws]
                                   * max(1, -(-8 // copies))),
                    "plain_ms": graph_ms([lambda: plain(x, w, s)] * 2, reps=5),
                    "bf16_cublas_ms": graph_ms([lambda wb=wb: torch.matmul(x, wb) for wb in wbs]
                                               * max(1, -(-8 // bcopies))),
                }
                moved, ops = 2 * m * k + wbytes + 2 * m * n, 2 * m * k * n
                cost = bound(moved, ops, ops_rate)
                say("kernels", kernel=name, M=m, product=pname, K=k, N=n,
                    **{key: f"{v:.5f}" for key, v in times.items()},
                    bound_ms=f"{cost['bound_ms']:.5f}", bound_by=cost["bound_by"],
                    GB_per_s=f"{moved / times['ms'] / 1e6:.1f}",
                    **(w8a8_variant(m, n, k) if name == "int8_matmul_w8a8" else {}),
                    card=repr(card))
                if pname != "lm_head":
                    for key in sums:
                        sums[key] += times[key]
                    nbytes, flops = nbytes + moved, flops + ops
                del ws, wbs, wb
            sums.update(bound(nbytes, flops, ops_rate))
            say("kernels", kernel=name, M=m, per="decoder layer (" + ", ".join(layer) + ")",
                **{key: f"{v:.5f}" if isinstance(v, float) else v for key, v in sums.items()},
                card=repr(card))
            per_layer.append(sums)
        out[name] = {"max_abs_err": err_max, "library_ms": None, **per_layer[0]}
        torch.cuda.empty_cache()
    del stored
    torch.cuda.empty_cache()
    return out


SERVE_SLOTS = 16
PAGE = 16  # block size of the paged engine (inference_hybird.py's default)
POOL_BLOCKS = 2048  # its pool, blocks per layer


def paged_case(g: torch.Generator, cfg: qwen2.QwenConfig, width: int, int8: bool) -> tuple:
    """The serve phase's decode attention: 16 rows of 545-596 tokens, one of
    1 token and one of exactly one page, over pools of 2048 blocks; each row's
    pages drawn from a shuffled permutation, distinct across the rows and
    the three table sets of each of two pools (a replay cycle of the six
    calls reads more than the 50 MB L2). Returns ([(q, pool_k, pool_v,
    tables, lens, scales)] for every pool and table set, valid tokens per
    call)."""
    kv, d, heads = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    shape = (POOL_BLOCKS, PAGE, kv, d)
    lens = torch.randint(545, 597, (SERVE_SLOTS,), generator=g, device="cuda")
    lens[0], lens[1] = 1, PAGE
    lens = lens.clamp(max=width * PAGE).to(torch.int32)
    q = (torch.randn((SERVE_SLOTS, heads, d), generator=g, device="cuda")).to(torch.bfloat16)
    pages = [-(-int(n) // PAGE) for n in lens]
    cases = []
    for _ in range(2):
        if int8:
            pool_k, pool_v = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                            dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(shape[:3], generator=g, device="cuda") * (4.0 / 127)
                           for _ in range(2))
        else:
            pool_k, pool_v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                              for _ in range(2))
            scales = ()
        perm = (torch.randperm(POOL_BLOCKS - 1, generator=g, device="cuda") + 1).tolist()
        for t in range(3):
            tables = torch.zeros((SERVE_SLOTS, width), dtype=torch.int32)
            used = t * sum(pages)
            for r, n in enumerate(pages):
                tables[r, :n] = torch.tensor(perm[used:used + n], dtype=torch.int32)
                used += n
            cases.append((q, pool_k, pool_v, tables.to(q.device), lens, scales))
    return cases, int(lens.sum())


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def decode_mlp_variant(b: int, h: int, inter: int) -> dict:
    """What decode_mlp launches for x [b, h]: the tensor-core tiles, the
    rings, the grids and the bytes it reads from L2."""
    plan = decode_mlp_plan(b, h, inter, sm_count())
    a, d = plan["gateup"], plan["down"]
    return {"products": "mma.sync m16n8k16 bf16, int8 to bf16 in registers, batch as N",
            "gateup_tile": f"16 rows x {a['strip']} cols x {a['stage_k']} k",
            "gateup_stages": a["stages"], "gateup_grid": list(a["grid"]),
            "down_tile": f"16 rows x {d['strip']} cols x {d['stage_k']} k",
            "down_stages": d["stages"], "down_cluster": d["cluster"],
            "down_grid": list(d["grid"]), "l2_read_bytes": plan["l2_bytes"]}


def phase_serving_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """The serving slice's kernels against their plain versions at 7B
    widths: paged attention for both pool dtypes at table widths 38 (the
    serve phase's max_blocks_per_seq) and 64 (a power-of-two bucket), and
    the int8 decode MLP at b = 8, 16 and 64 on int8 weights of the 7B
    layer. Returns per-kernel {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by} with the times at the serve phase's shapes (16 rows,
    width 38; b = 16)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    kv, d, heads = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    out = {name: {"max_abs_err": 0.0, "library_ms": None}
           for name in ("paged_attention", "paged_attention_int8", "decode_mlp")}
    max_blocks = -(-(564 + NEW_TOKENS) // PAGE)  # 38
    for int8 in (False, True):
        name = "paged_attention_int8" if int8 else "paged_attention"
        kernel = paged_attention_int8 if int8 else paged_attention
        for width in (max_blocks, 64):
            cases, valid = paged_case(g, cfg, width, int8)
            for case in cases[:2]:
                q, pk, pv, tables, lens, scales = case
                err, rel = compare(name, kernel(q, pk, pv, tables, lens, *scales),
                                   paged_attention_reference(q, pk, pv, tables, lens, *scales),
                                   SERVE_SLOTS)
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
                say("kernels", kernel=name, b=SERVE_SLOTS, width=width, tokens=valid,
                    lens=f"{int(lens.min())}-{int(lens.max())}", max_abs_err=f"{err:.6g}",
                    max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)
            elem = 1 if int8 else 2
            # the valid tokens' K and V rows (+ int8 scales), q, out, tables, lens
            nbytes = (valid * kv * d * 2 * elem + (valid * kv * 2 * 4 if int8 else 0)
                      + 2 * 2 * SERVE_SLOTS * heads * d + 4 * SERVE_SLOTS * (width + 1))
            times = {"ms": graph_ms([lambda c=c: kernel(*c[:5], *c[5]) for c in cases] * 4),
                     "plain_ms": graph_ms([lambda c=c: paged_attention_reference(*c[:5], *c[5])
                                           for c in cases]),
                     # the gather chain PAGED_ATTENTION="xla" runs (inference/paged.py)
                     "chain_ms": graph_ms([lambda c=c: paged.paged_attention(*c[:5], kv, *c[5])
                                           for c in cases])}
            cost = bound(nbytes, 4 * valid * heads * d)
            say("kernels", kernel=name, b=SERVE_SLOTS, width=width,
                **{k: f"{v:.5f}" for k, v in times.items()}, bound_ms=f"{cost['bound_ms']:.5f}",
                bound_by=cost["bound_by"], GB_per_s=f"{nbytes / times['ms'] / 1e6:.1f}",
                library="none: no single PyTorch call reads a block table; chain_ms is the "
                "gather chain", card=repr(card))
            if width == max_blocks:
                out[name].update(times, **cost)
            del cases
        torch.cuda.empty_cache()

    h, inter = cfg.hidden_size, cfg.intermediate_size
    leaves = []
    for k, n in ((h, inter), (h, inter), (inter, h)):
        leaves += quant.quantize_per_channel(torch.randn(k, n, generator=g, device="cuda")
                                             * k ** -0.5)
    ln = (torch.randn(h, generator=g, device="cuda") * 0.1 + 1.0).to(torch.bfloat16)
    dequant = [(w.float() * s).to(torch.bfloat16) for w, s in zip(leaves[::2], leaves[1::2])]
    for b in (8, SERVE_SLOTS, 64):
        x = torch.randn((b, h), generator=g, device="cuda").to(torch.bfloat16)
        args = (x, ln, *leaves)
        got = decode_mlp(*args)
        if not torch.equal(got, decode_mlp(*args)):
            raise AssertionError(f"decode_mlp b={b}: two calls differ")
        err, rel = compare("decode_mlp", got, decode_mlp_reference(*args), b)
        out["decode_mlp"]["max_abs_err"] = max(out["decode_mlp"]["max_abs_err"], err)
        say("kernels", kernel="decode_mlp", b=b, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)
        wg, wu, wd = dequant

        def cublas():  # three products and silu·up on bf16 weights, no norm: a yardstick
            return torch.matmul(torch.nn.functional.silu(x @ wg) * (x @ wu), wd)

        times = {"ms": graph_ms([lambda: decode_mlp(*args)] * 8),
                 # the previous CUDA-core design, the C entry's variant 2 (counted nowhere)
                 "old_ms": graph_ms([lambda: decode_mlp_module._launch(args, 2, 1e-6)] * 8),
                 "plain_ms": graph_ms([lambda: decode_mlp_reference(*args)] * 2, reps=5),
                 "bf16_cublas_ms": graph_ms([cublas] * 4)}
        variant = {**decode_mlp_variant(b, h, inter),  # variant 1: no tensor-core products
                   "no_products_ms": graph_ms([lambda: decode_mlp_module._launch(args, 1, 1e-6)]
                                              * 8)}
        nbytes = 3 * h * inter + 4 * (2 * inter + h) + 2 * (h + 2 * b * h)
        cost = bound(nbytes, 6 * b * h * inter)
        say("kernels", kernel="decode_mlp", b=b, **{k: f"{v:.5f}" for k, v in times.items()},
            bound_ms=f"{cost['bound_ms']:.5f}", bound_by=cost["bound_by"],
            GB_per_s=f"{nbytes / times['ms'] / 1e6:.1f}",
            library="none: no single PyTorch call does the fused int8 MLP",
            variant=json.dumps(variant), card=repr(card))
        if b == SERVE_SLOTS:
            out["decode_mlp"].update(ms=times["ms"], plain_ms=times["plain_ms"], **cost)
    del leaves, dequant
    torch.cuda.empty_cache()
    return out


ENCODER_B = 64  # images (8 clips x 8 frames) or audio clips (8 x 8) per tower call
RT_SAMPLES = 32000  # an audio clip: 2 s at 16 kHz
ATTN_KEYS = ("lns", "lnb", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
MLP_KEYS = ("lns", "lnb", "wi", "bi", "wf", "bf")


def encoder_layers(g: torch.Generator, w: int, inter: int, copies: int) -> list:
    """`copies` random bf16 encoder layers (LN near 1, the towers' scales),
    each with the concatenated q/k/v weight of the library chain."""
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(torch.bfloat16)

    layers = []
    for _ in range(copies):
        s = {"lns": rnd(w, scale=0.1, shift=1.0), "lnb": rnd(w, scale=0.1),
             **{k: rnd(w, w, scale=0.02) for k in ("wq", "wk", "wv", "wo")},
             **{k: rnd(w, scale=0.1) for k in ("bq", "bk", "bv", "bo")},
             "wi": rnd(w, inter, scale=0.02), "bi": rnd(inter, scale=0.1),
             "wf": rnd(inter, w, scale=0.02), "bf": rnd(w, scale=0.1)}
        s["wqkv"] = torch.cat([s["wq"], s["wk"], s["wv"]], dim=1)
        s["bqkv"] = torch.cat([s["bq"], s["bk"], s["bv"]])
        layers.append(s)
    return layers


def library_attn_chain(x, s, heads: int, key_mask):
    """The attention sublayer in library calls: layer_norm, one addmm for
    q/k/v, SDPA with the bool key mask, addmm + residual (a yardstick)."""
    b, n, w = x.shape
    h = torch.nn.functional.layer_norm(x, (w,), s["lns"], s["lnb"], 1e-5)
    qkv = torch.addmm(s["bqkv"], h.view(-1, w), s["wqkv"]).view(b, n, 3, heads, w // heads)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    return torch.addmm(s["bo"], o.transpose(1, 2).reshape(-1, w), s["wo"]).view_as(x) + x


def library_mlp_chain(x, s, act: str):
    """The MLP sublayer in library calls: layer_norm, addmm, the activation,
    addmm + residual (a yardstick)."""
    w = x.shape[-1]
    h = torch.nn.functional.layer_norm(x, (w,), s["lns"], s["lnb"], 1e-5).view(-1, w)
    t = torch.addmm(s["bi"], h, s["wi"])
    t = torch.nn.functional.gelu(t) if act == "gelu" else t * torch.sigmoid(1.702 * t)
    return torch.addmm(s["bf"], t, s["wf"]).view_as(x) + x


def hubert_frames(acfg: hubert.HubertConfig, samples: int) -> int:
    """Frames the conv frontend makes of `samples` audio samples."""
    for k, s in zip(acfg.conv_kernel, acfg.conv_stride):
        samples = (samples - k) // s + 1
    return samples


def encoder_configs(cfg: affectgpt.AffectGPTConfig) -> tuple:
    """(visual spec, its config, acoustic spec, its config) as
    encode_media_features resolves them."""
    vspec = encoders.get_visual_encoder(cfg.visual_encoder_name)
    aspec = encoders.get_acoustic_encoder(cfg.acoustic_encoder_name)
    return (vspec, cfg.vision_cfg_override or vspec.make_config(),
            aspec, cfg.audio_cfg_override or aspec.make_config())


def mlp_variant(rows: int, w: int, inter: int) -> dict:
    """What mlp_sublayer launches for `rows` rows: the GEMMs' wgmma tile,
    ring, cluster and persistent grid, and the bytes their blocks read from
    L2."""
    plan = vit_mlp.mlp_plan(rows, w, inter, sm_count())
    fc1, fc2 = plan["fc1"], plan["fc2"]
    return {"products": "wgmma m64n256k16 bf16, TMA ring, persistent",
            "tile": "x".join(map(str, fc1["tile"])) + f"x{fc1['stage_k']}",
            "stages": fc1["stages"], "cluster": fc1["cluster"], "blocks": plan["blocks"],
            "fc1_tiles": fc1["n_tiles"] * fc1["m_tiles"],
            "fc2_tiles": fc2["n_tiles"] * fc2["m_tiles"],
            "l2_read_bytes": fc1["l2_bytes"] + fc2["l2_bytes"]}


def fused_variant(rows: int, w: int, inter: int) -> dict:
    """What mlp_sublayer_fused launches for `rows` rows: the wgmma shape, the
    row tiles and the bytes it reads from L2 (weights, h, the running out)."""
    plan = vit_mlp_fused.fused_plan(rows, w, inter, vit_mlp_fused.K_CHUNKS)
    return {"variant": f"ln+cluster{plan['cluster']}x128rows_wgmma_m64n64k16+m64n128k16",
            "row_tiles": plan["tiles"],
            "l2_read_bytes": plan["l2_bytes"], "weight_l2_bytes": plan["weight_l2_bytes"]}


def phase_encoder_kernels(card: str, vcfg: clip_vit.ClipVisionConfig,
                          acfg: hubert.HubertConfig) -> dict:
    """The four encoder kernels against their plain versions at the towers'
    widths (ViT-L/14 and HuBERT-large share w = 1024, 16 heads of 64,
    I = 4096), b = 64: CLIP's n = 257, the same padded to 264 with valid_len
    257, and HuBERT's n = 99 (the frames of a 2 s clip); both
    activations for the MLP kernels, both accumulations for the fused one.
    Returns per-kernel {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by} with device times at CLIP's shape (CUDA graph, four layers'
    weights per replay cycle); HuBERT's times of the sublayer and the MLP
    pair are printed. library_ms is SDPA for the attention; the sublayers
    have no single library call, so their library chains' times are printed
    as chain_ms."""
    g = torch.Generator(device="cuda").manual_seed(19)
    w, heads, inter, b = vcfg.width, vcfg.num_heads, vcfg.mlp_dim, ENCODER_B
    if (w, heads, inter) != (acfg.hidden_size, acfg.num_heads, acfg.intermediate_size):
        raise ValueError("phase_encoder_kernels: the towers' layer widths differ")
    d, n_clip, n_hub = w // heads, vcfg.num_patches + 1, hubert_frames(acfg, RT_SAMPLES)
    layers = encoder_layers(g, w, inter, 4)  # 4 x 24 MB of weights per replay cycle
    s0 = layers[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {name: {"max_abs_err": 0.0, "library_ms": None} for name in
           ("attn_sublayer", "mlp_sublayer", "fused_vit_attention", "mlp_sublayer_fused")}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def check(name, got, ref, extra_atol=None, **shape):
        err, rel = compare(name, got, ref, b, extra_atol)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        say("kernels", kernel=name, b=b, **shape, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL if extra_atol is None else
            f"{ATOL}+one bf16 ulp of the running sum's peak")

    for tower, n, valid in (("clip", n_clip, n_clip), ("clip", -(-n_clip // 8) * 8, n_clip),
                            ("hubert", n_hub, n_hub)):
        x = rnd(b, n, w)
        a_args = (x, *(s0[k] for k in ATTN_KEYS))
        check("attn_sublayer", attn_sublayer(*a_args, heads, valid),
              attn_sublayer_reference(*a_args, heads, valid), tower=tower, n=n, valid_len=valid)
        q, k, v = (rnd(b, heads, n, d) for _ in range(3))
        check("fused_vit_attention", fused_vit_attention(q, k, v, valid),
              fused_vit_attention_reference(q, k, v, valid), tower=tower, n=n, valid_len=valid)
        if n != valid:
            continue  # the MLP kernels are row-wise: no key mask
        m_args = (x, *(s0[k] for k in MLP_KEYS))
        for act in ("quick_gelu", "gelu"):
            got = mlp_sublayer(*m_args, act=act)
            if not torch.equal(got, mlp_sublayer(*m_args, act=act)):
                raise AssertionError(f"mlp_sublayer {tower} {act}: two calls differ")
            check("mlp_sublayer", got, mlp_sublayer_reference(*m_args, act=act), tower=tower,
                  n=n, act=act, **mlp_variant(b * n, w, inter))
            for acc in ("bf16", "f32"):
                extra = bf16_ulp(bf16_acc_peak(x, s0, act)) if acc == "bf16" else None
                got = mlp_sublayer_fused(*m_args, act=act, acc=acc)
                if not torch.equal(got, mlp_sublayer_fused(*m_args, act=act, acc=acc)):
                    raise AssertionError(f"mlp_sublayer_fused {tower} {act} {acc}: two calls "
                                         "differ")
                check("mlp_sublayer_fused", got,
                      mlp_sublayer_fused_reference(*m_args, act=act, acc=acc), extra,
                      tower=tower, n=n, act=act, acc=acc, **fused_variant(b * n, w, inter))

    def record(name, tower, n, calls, plain_calls, nbytes, flops, library=None, chain=None,
               old=None, no_products=None, **shape):
        times = {"ms": graph_ms(calls), "plain_ms": graph_ms(plain_calls, reps=5)}
        if library:
            times["library_ms"] = graph_ms(library)
        if chain:
            times["chain_ms"] = graph_ms(chain)
        if old:  # the previous design, for a redesigned kernel
            times["old_ms"] = graph_ms(old)
        if no_products:  # its variant without the tensor-core products
            shape["variant"] = json.dumps({**json.loads(shape["variant"]),
                                           "no_products_ms": graph_ms(no_products)})
        cost = bound(nbytes, flops)
        say("kernels", kernel=name, tower=tower, b=b, n=n, **shape,
            **{k: f"{v:.5f}" for k, v in times.items()}, bound_ms=f"{cost['bound_ms']:.5f}",
            bound_by=cost["bound_by"], card=repr(card))
        if tower == "clip" and "ms" not in out[name]:  # the first CLIP timing of a kernel
            out[name].update({k: v for k, v in times.items() if k != "chain_ms"}, **cost)

    for tower, n in (("clip", n_clip), ("hubert", n_hub)):
        x = rnd(b, n, w)
        key_mask = torch.ones((1, 1, 1, n), dtype=torch.bool, device="cuda")
        rows = b * n
        record("attn_sublayer", tower, n,
               [lambda s=s: attn_sublayer(x, *(s[k] for k in ATTN_KEYS), heads, n)
                for s in layers] * 2,
               [lambda: attn_sublayer_reference(x, *(s0[k] for k in ATTN_KEYS), heads, n)],
               2 * (2 * rows * w + 4 * w * w + 6 * w), 8 * rows * w * w + 4 * rows * n * w,
               chain=[lambda s=s: library_attn_chain(x, s, heads, key_mask) for s in layers] * 2)
        mlp_bytes, mlp_flops = 2 * (2 * rows * w + 2 * w * inter + inter + 3 * w), \
            4 * rows * w * inter
        act = "quick_gelu" if tower == "clip" else "gelu"
        def mlp_launch(variant):  # vit_mlp's C entry: 1 no products, 2 the previous design
            return [lambda s=s: vit_mlp._launch(x, *(s[k] for k in MLP_KEYS), eps=1e-5, act=act,
                                                variant=variant) for s in layers] * 2

        record("mlp_sublayer", tower, n,
               [lambda s=s: mlp_sublayer(x, *(s[k] for k in MLP_KEYS), act=act)
                for s in layers] * 2,
               [lambda: mlp_sublayer_reference(x, *(s0[k] for k in MLP_KEYS), act=act)],
               mlp_bytes, mlp_flops,
               chain=[lambda s=s: library_mlp_chain(x, s, act) for s in layers] * 2,
               old=mlp_launch(2), no_products=mlp_launch(1), act=act,
               variant=json.dumps(mlp_variant(rows, w, inter)))
        # bf16 (the default) recorded at CLIP's shape; f32 and HuBERT's shape printed
        for acc in ("bf16", "f32") if tower == "clip" else ("bf16",):
            record("mlp_sublayer_fused", tower, n,
                   [lambda s=s: mlp_sublayer_fused(x, *(s[k] for k in MLP_KEYS), act=act,
                                                   acc=acc) for s in layers],
                   [lambda: mlp_sublayer_fused_reference(x, *(s0[k] for k in MLP_KEYS),
                                                         act=act, acc=acc)],
                   mlp_bytes, mlp_flops,
                   chain=[lambda s=s: library_mlp_chain(x, s, act) for s in layers], acc=acc,
                   **fused_variant(rows, w, inter))
        if tower != "clip":
            continue
        qkv = [tuple(rnd(b, heads, n, d) for _ in range(3)) for _ in range(2)]  # 2 x 101 MB
        record("fused_vit_attention", tower, n,
               [lambda t=t: fused_vit_attention(*t, n) for t in qkv] * 4,
               [lambda: fused_vit_attention_reference(*qkv[0], n)],
               4 * b * heads * n * d * 2, 4 * b * heads * n * n * d,
               library=[lambda t=t: sdpa(*t, attn_mask=key_mask) for t in qkv] * 4)
        lib_err = float((sdpa(*qkv[0], attn_mask=key_mask).float()
                         - fused_vit_attention_reference(*qkv[0], n).float()).abs().max())
        say("library", kernel="fused_vit_attention", call="scaled_dot_product_attention",
            max_abs_err_vs_plain=f"{lib_err:.6g}", card=repr(card))
        del qkv
    del layers
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


@dataclasses.dataclass(frozen=True)
class Config:
    """A configuration of the main path. `launches(layers)` gives the count
    each kernel must reach in one answer; every other kernel stays at 0."""
    launches: Callable[[int], dict]
    switches: dict = dataclasses.field(default_factory=dict)  # qwen2 attention switches
    tree: str = "bf16"  # the serving tree (serving_tree)
    batch: int = BATCH
    matmul_mode: str = "w8"  # quant.MATMUL_MODE
    decode_only: bool = False  # the tree serves only the decode loop (generate's decode_llm)


# decode kernels run once per layer and step, prefill kernels once per layer;
# a quantized product runs per layer (7 split, 4 fused) plus the lm_head on
# every decode step, and on the prefill only where its M is routed to the
# kernel: the prefill's lm_head (last token, M = batch), and every product
# under w8a8
N = NEW_TOKENS
CONFIGS = {
    "default": Config(lambda L: {"decode_qkv": N * L, "decode_mlp_bf16": N * L}),
    "a": Config(lambda L: {"decode_qkv": N * L, "decode_mlp_bf16": N * L, "decode_attn_o": N * L,
                           "prefill_attention": L},
                {"PREFILL_ATTENTION": "flash", "DECODE_ATTN_O": "pallas"}),
    "b": Config(lambda L: {"decode_qkv": N * L, "decode_mlp_bf16": N * L,
                           "decode_attention": N * L, "prefill_attention": L},
                {"PREFILL_ATTENTION": "flash", "DECODE_ATTENTION": "pallas"}),
    "q4": Config(lambda L: {"int4_matmul_smallm": N * (7 * L + 1) + 1}, tree="int4"),
    "q4_b16": Config(lambda L: {"int4_matmul": N * (7 * L + 1) + 1}, tree="int4", batch=16),
    "decode_llm": Config(lambda L: {"int4_matmul_smallm": N * (7 * L + 1)}, tree="int4",
                         decode_only=True),
    "q8_fused": Config(lambda L: {"int8_matmul": N * (4 * L + 1) + 1}, tree="int8_fused"),
    "q8a8": Config(lambda L: {"int8_matmul_w8a8": (N + 1) * (7 * L + 1)}, tree="int8",
                   matmul_mode="w8a8"),
    # qwen2.DECODE_QKV="xla": the per-projection route, decode_qkv never launched
    "qkv_xla": Config(lambda L: {"decode_mlp_bf16": N * L}, {"DECODE_QKV": "xla"}),
}


def serving_tree(llm: dict, cfg: qwen2.QwenConfig, tree: str) -> dict:
    """The merged bf16 LLM in a serving form of CONFIGS, built in the order of
    inference_hybird.py: fuse (optionally), then quantize."""
    if tree == "bf16":
        return llm
    if tree == "int8_fused":
        return qwen2.quantize_params(qwen2.fuse_qkv_gateup(llm, cfg), bits=8)
    return qwen2.quantize_params(llm, bits={"int4": 4, "int8": 8}[tree])


def tree_gib(tree) -> float:
    """GiB of every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_gib(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_gib(v) for v in tree)
    return tree.numel() * tree.element_size() / 2**30 if isinstance(tree, torch.Tensor) else 0.0


def wall(fn, reps=3):
    """Median host wall time in ms of calls that end in a synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


@contextlib.contextmanager
def switched(settings):
    """Set module switches, (module, name, value) triples, for the duration
    of the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in settings]
    for mod, name, value in settings:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def config_switches(config: str):
    """The qwen2 attention switches and quant.MATMUL_MODE of a configuration
    of CONFIGS, for the duration of a block."""
    c = CONFIGS[config]
    return switched([*((qwen2, name, value) for name, value in c.switches.items()),
                     (quant, "MATMUL_MODE", c.matmul_mode)])


# configurations timed once, on the way there only, and those only counted
TIMED_ONCE = ("a", "b")
COUNTED_ONLY = ("qkv_xla",)
MODE = "multiface_audio_face_frame_text"


class Served:
    """One configuration's requests: `answer` is the user's call (Chat.
    answer_batch, or for a decode-only tree generate(decode_llm=) on the
    spliced prompts, as bench.py calls it), `generate(n)` the prefill + n
    decode steps on the same spliced embeddings."""

    def __init__(self, chat: Chat, feats: dict, subtitles: list, decode_llm=None):
        self.chat, self.feats, self.subtitles, self.decode_llm = chat, feats, subtitles, decode_llm
        ids, lengths, offsets = chat.build_prompt_batch(MODE, subtitles, QUESTION)
        self.prompt_tokens = ids.shape[1]
        self.embeds = affectgpt.build_inputs_embeds(
            chat.frozen, chat.trainable, chat.cfg,
            torch.as_tensor(ids, dtype=torch.long, device="cuda"), feats,
            {m: torch.as_tensor(v, dtype=torch.long, device="cuda") for m, v in offsets.items()})
        self.lengths = torch.as_tensor(lengths, device="cuda")

    def generate(self, n: int):
        gcfg = gen.GenerateConfig(max_new_tokens=n, do_sample=False,
                                  eos_token_id=self.chat.tokenizer.eos_token_id)
        return gen.generate(self.chat.frozen["llm"], self.chat.cfg.llm, gcfg, self.embeds,
                            self.lengths, None, max_len=self.chat.max_len,
                            decode_llm=self.decode_llm)

    def answer(self) -> list:
        if self.decode_llm is None:
            return self.chat.answer_batch(MODE, self.subtitles, QUESTION, self.feats,
                                          max_new_tokens=NEW_TOKENS, do_sample=False)
        tokens, num_valid = self.generate(NEW_TOKENS)
        tokens, num_valid = tokens.cpu().numpy(), num_valid.cpu().numpy()
        return [gen.trim_output_text(self.chat.tokenizer.decode(row[:int(nv)],
                                                                skip_special_tokens=True))
                for row, nv in zip(tokens, num_valid)]


def counted_run(config: str, served: Served, baseline: dict) -> dict:
    """One answer under a configuration, with every kernel count set to 0
    just before it and read just after; asserts the exact launch counts,
    finite logits and one string per clip. `baseline` receives the default
    configuration's first-token logits and strings, which the others' first
    8 rows are compared with (printed, not asserted: in bf16 the kernels
    round differently from the plain chain, and the quantized trees hold
    other weights)."""
    c = CONFIGS[config]
    expected = {**dict.fromkeys(KERNELS, 0), **c.launches(served.chat.cfg.llm.num_layers)}
    finite, logits = [], []
    forward = qwen2.forward

    def checked_forward(*args, **kwargs):
        out, cache = forward(*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        if not logits:
            logits.append(out[:BATCH, -1].float())
        return out, cache

    with config_switches(config):
        qwen2.forward = checked_forward
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        try:
            texts = served.answer()
            torch.cuda.synchronize()
        finally:
            qwen2.forward = forward
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    say("main", config=config, tree=c.tree, batch=c.batch, matmul_mode=c.matmul_mode,
        switches=json.dumps(c.switches), launches=json.dumps(launches), forwards=len(finite),
        strings=len(texts))
    if launches != expected:
        raise AssertionError(f"config {config}: kernel launches {launches} != {expected}")
    if len(finite) != NEW_TOKENS + 1 or not bool(torch.stack(finite).all()):
        raise AssertionError(f"config {config}: non-finite logits on the main path")
    if len(texts) != c.batch or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"config {config}: expected {c.batch} strings, got {texts!r}")
    say("main", config=config, sample=json.dumps(texts[0][:60]))
    if config == "default":
        baseline.update(logits=logits[0], texts=texts)
    else:
        say("main", config=config, first_logits_max_abs_diff_vs_default=(
            f"{float((logits[0] - baseline['logits']).abs().max()):.6g}"),
            first_token_agrees=int((logits[0].argmax(-1) == baseline["logits"].argmax(-1)).sum()),
            strings_equal_to_default=sum(a == b for a, b in zip(texts, baseline["texts"])))
    return launches


def timed_run(config: str, served: Served) -> dict:
    """Wall times of one configuration: whole answers, then prefill alone
    (0 new tokens) and prefill + decode on the same spliced embeddings; peak
    device memory over them, and the part of it above what was allocated
    before (caches and activations)."""
    batch = CONFIGS[config].batch
    with config_switches(config):
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        total_ms = wall(served.answer)
        prefill_ms = wall(lambda: served.generate(0))
        decode_ms = (wall(lambda: served.generate(NEW_TOKENS)) - prefill_ms) / NEW_TOKENS
    peak = torch.cuda.max_memory_allocated()
    return {"answer_batch_ms": total_ms, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "clips_per_s": batch / (total_ms / 1e3),
            "peak_mem_gib": peak / 2**30, "working_set_gib": (peak - resident) / 2**30}


def phase_main_path(card: str) -> tuple:
    """Every configuration of CONFIGS on one model, all serving trees
    resident at once: a counted run each, then timings in the order of
    CONFIGS and back (TIMED_ONCE only there), so that a drift of the host
    over the phase weighs on the configurations alike. Returns each
    kernel's launch count from the first configuration that runs it, and
    the model for the serve phase (cfg, frozen, trainable, tokenizer,
    features, the bf16 and int8 serving trees)."""
    cfg, frozen, trainable, tok = bootstrap.build_model(
        {"llama_model": "Qwen25", "keep_full_llm": True}, with_encoders=True, seed=0)
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    assert cfg.llm == qwen2.QwenConfig.qwen25_7b(), cfg.llm
    say("main", encoders=f"{cfg.visual_encoder_name}+{cfg.acoustic_encoder_name}",
        encoder_gib=f"{tree_gib([frozen['visual_encoder'], frozen['acoustic_encoder']]):.3f}")
    rng = np.random.RandomState(0)
    feats = {
        m: torch.as_tensor(rng.randn(BATCH, 8, d).astype(np.float32), device="cuda")
        .to(torch.bfloat16)
        for m, d in (("frame", cfg.visual_dim), ("face", cfg.visual_dim),
                     ("audio", cfg.acoustic_dim))
    }
    trees = {}
    for tree in dict.fromkeys(c.tree for c in CONFIGS.values()):
        t0 = time.perf_counter()
        trees[tree] = serving_tree(frozen["llm"], cfg.llm, tree)
        torch.cuda.synchronize()
        say("main", tree=tree, weight_gib=f"{tree_gib(trees[tree]):.3f}",
            build_seconds=f"{time.perf_counter() - t0:.3f}",
            allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    served = {}
    for config, c in CONFIGS.items():
        llm = frozen["llm"] if c.decode_only else trees[c.tree]
        chat = Chat({**frozen, "llm": llm}, trainable, cfg, tok, max_len=MAX_LEN)
        reps = c.batch // BATCH  # 16 clips: the 8 twice
        served[config] = Served(chat, {m: v.repeat(reps, 1, 1) for m, v in feats.items()},
                                SUBTITLES * reps, trees[c.tree] if c.decode_only else None)
    launches, baseline = {}, {}
    for config in CONFIGS:
        for name, count in counted_run(config, served[config], baseline).items():
            if count and name not in launches:
                launches[name] = count
    timed = [c for c in CONFIGS if c not in COUNTED_ONLY]
    visits = {config: [] for config in timed}
    for config in (*timed, *(c for c in reversed(timed) if c not in TIMED_ONCE)):
        visits[config].append(timed_run(config, served[config]))
    for config, runs in visits.items():
        c = CONFIGS[config]
        mean = {key: statistics.mean(r[key] for r in runs) for key in runs[0]}
        weights = tree_gib(trees[c.tree]) + (tree_gib(frozen["llm"]) if c.decode_only else 0)
        say("main", config=config, tree=c.tree, prompt_tokens=served[config].prompt_tokens,
            batch=c.batch, new_tokens=NEW_TOKENS, weight_gib=f"{weights:.3f}",
            peak_mem_gib=f"{max(r['peak_mem_gib'] for r in runs):.3f}",
            working_set_gib=f"{max(r['working_set_gib'] for r in runs):.3f}",
            **{key: f"{mean[key]:.4f}" for key in
               ("prefill_ms", "decode_ms_per_step", "answer_batch_ms", "clips_per_s")},
            visits=json.dumps([{key: round(r[key], 4) for key in
                                ("prefill_ms", "decode_ms_per_step", "clips_per_s")}
                               for r in runs]), card=repr(card))
    serving = {"bf16": trees["bf16"], "int8": trees["int8"]}  # what the serve phase runs
    del trees, served
    torch.cuda.empty_cache()
    return launches, (cfg, frozen, trainable, tok, feats, serving)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """A configuration of the serve phase: `kernels` launch num_layers times
    per decode step (int8_matmul in paged_w8 by its own count), every other
    kernel 0 times."""
    kernels: tuple
    engine: str = "paged"  # PagedBatchServer, or the dense BatchServer
    tree: str = "bf16"  # the serving tree: bf16, or int8 split (quantize_params)
    pool: Optional[torch.dtype] = None  # the paged pool's dtype, the table's by default
    decode_mlp: str = "auto"  # qwen2.DECODE_MLP
    attention: str = "pallas"  # paged.PAGED_ATTENTION of a paged engine


SERVE = {
    "paged_bf16": ServeConfig(("paged_attention", "decode_qkv", "decode_mlp_bf16")),
    # the gather chain: tells the kernel's rounding from the engines' own
    # differences when the paged and dense engines' tokens part
    "paged_bf16_gather": ServeConfig(("decode_qkv", "decode_mlp_bf16"), attention="xla"),
    "paged_kv8": ServeConfig(("paged_attention_int8", "decode_qkv", "decode_mlp_bf16"),
                             pool=torch.int8),
    "paged_w8": ServeConfig(("paged_attention", "decode_mlp"), tree="int8",
                            decode_mlp="pallas"),
    "server_bf16": ServeConfig(("decode_qkv", "decode_mlp_bf16"), engine="dense"),
}
SERVE_NEW_TOKENS = (32, 24, 16, 8)  # max_new_tokens, cycling over the requests


def serve_requests(chat: Chat, feats: dict) -> list:
    """48 requests: the 8 clips six times, prompts from Chat.build_prompt_batch
    (545-564 tokens), submitted as inference_hybird.py's submit_chunk_paged
    does."""
    ids, lengths, offsets = chat.build_prompt_batch(MODE, SUBTITLES, QUESTION)
    feats_np = {m: v.float().cpu().numpy() for m, v in feats.items()}
    return [server.Request(
        request_id=r, input_ids=np.asarray(ids[r % BATCH, :lengths[r % BATCH]], np.int32),
        features={m: v[r % BATCH] for m, v in feats_np.items()},
        offsets={m: int(o[r % BATCH]) for m, o in offsets.items()},
        max_new_tokens=SERVE_NEW_TOKENS[r % len(SERVE_NEW_TOKENS)],
    ) for r in range(6 * BATCH)]


def serve_engine(config: str, model: tuple, max_prompt: int):
    """The engine of a configuration, built as inference_hybird.py's
    make_paged_server builds it: block 16, 2048 blocks, tables for the
    longest prompt + 32 tokens, 16 slots, reserve admission, bursts of 8,
    greedy (the dense server: 16 slots, max_len 640)."""
    cfg, frozen, trainable, tok, _, trees = model
    c = SERVE[config]
    frozen = {**frozen, "llm": trees[c.tree]}
    if c.engine == "dense":
        return server.BatchServer(frozen, trainable, cfg, tok, max_slots=SERVE_SLOTS,
                                  max_len=MAX_LEN)
    pcfg = paged.PagedConfig(block_size=PAGE, num_blocks=POOL_BLOCKS,
                             max_blocks_per_seq=-(-(max_prompt + NEW_TOKENS) // PAGE))
    return paged.PagedBatchServer(frozen, trainable, cfg, tok, pcfg=pcfg, max_slots=SERVE_SLOTS,
                                  dtype=c.pool, do_sample=False, seed=0, admission="reserve",
                                  decode_burst=8)


def serve_switches(config: str):
    """paged.PAGED_ATTENTION and qwen2.DECODE_MLP of the configuration, for
    the duration of a block."""
    c = SERVE[config]
    return switched([(paged, "PAGED_ATTENTION", c.attention),
                     (qwen2, "DECODE_MLP", c.decode_mlp)])


def serve_counted(config: str, model: tuple, requests: list) -> tuple:
    """One run of a configuration over all requests, every kernel count set
    to 0 just before and read just after. Asserts each kernel of the
    configuration launched num_layers x the decode steps the engine made
    (int8_matmul: the decode steps' 4 products a layer + the lm_head, plus
    each admission's prefill products routed to the kernel by M), every
    other kernel 0 times, a result for every request and finite logits.
    Returns (launches, results)."""
    c = SERVE[config]
    layers = model[0].llm.num_layers
    finite, admissions = [], []
    forward, core, prefill = qwen2.forward, paged._decode_core, paged.prefill_batch_into_pages

    def checked_forward(*args, **kwargs):  # the prefills (both engines), the dense decode
        out, cache = forward(*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        return out, cache

    def checked_core(*args, **kwargs):  # the paged decode steps
        logits, pools = core(*args, **kwargs)
        finite.append(torch.isfinite(logits).all())
        return logits, pools

    def recorded_prefill(llm, llm_cfg, pools, embeds, *args, **kwargs):
        admissions.append(tuple(embeds.shape[:2]))
        return prefill(llm, llm_cfg, pools, embeds, *args, **kwargs)

    with serve_switches(config):
        engine = serve_engine(config, model, max(len(r.input_ids) for r in requests))
        qwen2.forward, paged._decode_core = checked_forward, checked_core
        paged.prefill_batch_into_pages = recorded_prefill
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        try:
            for r in requests:
                engine.submit(r)
            results = engine.run_until_drained()
            torch.cuda.synchronize()
        finally:
            qwen2.forward, paged._decode_core = forward, core
            paged.prefill_batch_into_pages = prefill
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    steps = engine.stats["decode_steps"]
    expected = {**dict.fromkeys(KERNELS, 0), **dict.fromkeys(c.kernels, layers * steps)}
    if c.tree == "int8":
        expected["int8_matmul"] = steps * (4 * layers + 1) + sum(
            7 * layers + 1 if b * t <= quant.PALLAS_DEQUANT_MAX_M else 1 for b, t in admissions)
    say("serve", config=config, decode_steps=steps, admissions=json.dumps(admissions),
        launches=json.dumps(launches), results=len(results), forwards=len(finite))
    if launches != expected:
        raise AssertionError(f"serve {config}: kernel launches {launches} != {expected}")
    if set(results) != {r.request_id for r in requests}:
        raise AssertionError(f"serve {config}: results for {sorted(results)} only")
    if not finite or not bool(torch.stack(finite).all()):
        raise AssertionError(f"serve {config}: non-finite logits")
    return launches, results


def serve_timed(config: str, model: tuple, requests: list, card: str) -> None:
    """One timed run of a configuration on a fresh engine: all requests
    submitted up front, wall time to the last result (ending in a
    synchronize); requests/s, the clock's TTFT/e2e percentiles and
    generated tokens/s, the engine's phase times and counters, the cache's
    GiB and the peak device memory."""
    with serve_switches(config):
        engine = serve_engine(config, model, max(len(r.input_ids) for r in requests))
        cache = engine.cache if SERVE[config].engine == "dense" else engine.pools
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for r in requests:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = engine.clock.summary()
    stats = {k: round(v, 4) if isinstance(v, float) else v for k, v in engine.stats.items()}
    say("serve", config=config, requests=len(requests), wall_s=f"{wall:.4f}",
        requests_per_s=f"{len(requests) / wall:.4f}",
        **{k: summary[k] for k in ("ttft_p50_ms", "ttft_p95_ms", "e2e_p50_ms", "e2e_p95_ms",
                                   "gen_tokens_per_s", "mean_tokens")},
        stats=json.dumps(stats), cache_gib=f"{tree_gib(cache):.3f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}", card=repr(card))
    del engine, cache
    torch.cuda.empty_cache()


def phase_serve(card: str, model: tuple) -> dict:
    """The serving engines at Qwen2.5-7B width on the merged model of the
    main path: a counted run of each configuration of SERVE, then one timed
    run each. Returns each kernel's launch count from the first
    configuration that runs it."""
    cfg, frozen, trainable, tok, feats, _ = model
    requests = serve_requests(Chat(frozen, trainable, cfg, tok), feats)
    say("serve", requests=len(requests),
        prompt_tokens=f"{min(len(r.input_ids) for r in requests)}-"
                      f"{max(len(r.input_ids) for r in requests)}",
        max_new_tokens=json.dumps(SERVE_NEW_TOKENS), slots=SERVE_SLOTS)
    launches, results = {}, {}
    for config in SERVE:
        counts, results[config] = serve_counted(config, model, requests)
        for name, count in counts.items():
            if count and name not in launches:
                launches[name] = count
        torch.cuda.empty_cache()
    def equal(a, b):  # requests whose tokens two configurations share
        return sum(results[a][r] == results[b][r] for r in results[a])

    say("serve", paged_bf16_requests_equal_to_server_bf16=equal("paged_bf16", "server_bf16"),
        paged_bf16_gather_equal_to_server_bf16=equal("paged_bf16_gather", "server_bf16"),
        paged_bf16_equal_to_paged_bf16_gather=equal("paged_bf16", "paged_bf16_gather"),
        of=len(requests))
    for config in SERVE:
        serve_timed(config, model, requests, card)
    return launches


@dataclasses.dataclass(frozen=True)
class RtConfig:
    """A configuration of the realtime phase: module switches, and the count
    each kernel must reach in one answer, `launches(clip_layers,
    hubert_layers)`, beside the LLM's decode kernels; every other kernel
    stays at 0. Frames and faces each pass CLIP once per answer."""
    switches: tuple  # ((module, name, value), ...)
    launches: Callable[[int, int], dict]


RT = {
    "rt_plain": RtConfig(((clip_vit, "ATTN_IMPL", "xla"), (clip_vit, "MLP_IMPL", "xla"),
                          (nn, "FUSED_MHA", "0")), lambda c, h: {}),
    "rt_default": RtConfig((), lambda c, h: {"attn_sublayer": 2 * c, "mlp_sublayer": 2 * c}),
    "rt_a": RtConfig(((clip_vit, "MLP_IMPL", "fused"), (hubert, "ATTN_IMPL", "sublayer"),
                      (hubert, "MLP_IMPL", "pallas")),
                     lambda c, h: {"attn_sublayer": 2 * c + h, "mlp_sublayer": h,
                                   "mlp_sublayer_fused": 2 * c}),
    "rt_b": RtConfig(((clip_vit, "ATTN_IMPL", "flash"), (hubert, "MLP_IMPL", "fused")),
                     lambda c, h: {"fused_vit_attention": 2 * c, "mlp_sublayer_fused": h}),
    "rt_mha": RtConfig(((clip_vit, "ATTN_IMPL", "xla"),),  # nn.mha's route at 257 tokens
                       lambda c, h: {"fused_vit_attention": 2 * c}),
}
RT_VISITS = ("rt_plain", "rt_default", "rt_a", "rt_b", "rt_mha", "rt_default", "rt_plain")


def realtime_media(seed: int = 1) -> dict:
    """The realtime phase's raw media for 8 clips, made from a numpy seed and
    put on the card: frames [8, 8, 720, 1280, 3] uint8 (a decoded HD clip,
    downsampled on the device), OpenFace face crops [8, 8, 112, 112, 3]
    uint8 (upsampled), audio [8, 8, 1, 32000] bf16 (2 s at 16 kHz, as
    scripts/bench_realtime.py shapes it)."""
    rng = np.random.RandomState(seed)
    return {
        "frame": torch.as_tensor(rng.randint(0, 256, (BATCH, 8, 720, 1280, 3), dtype=np.uint8),
                                 device="cuda"),
        "face": torch.as_tensor(rng.randint(0, 256, (BATCH, 8, 112, 112, 3), dtype=np.uint8),
                                device="cuda"),
        "audio": torch.as_tensor((rng.randn(BATCH, 8, 1, RT_SAMPLES) * 0.1).astype(np.float32),
                                 device="cuda").to(torch.bfloat16),
    }


def rt_counted(config: str, chat: Chat, raw: dict, baseline: dict) -> dict:
    """One answer from raw media under a configuration, every kernel count
    set to 0 just before and read just after: asserts the exact launches,
    features of the expected shapes, finite features and logits, and one
    string per clip; prints each modality's largest difference and least
    cosine similarity against rt_plain's features (not asserted: the kernel
    routes round at other points than the plain chain)."""
    cfg = chat.cfg
    _, vcfg, _, acfg = encoder_configs(cfg)
    n = NEW_TOKENS * cfg.llm.num_layers
    expected = {**dict.fromkeys(KERNELS, 0), "decode_qkv": n, "decode_mlp_bf16": n,
                **RT[config].launches(vcfg.num_layers, acfg.num_layers)}
    finite = []
    forward = qwen2.forward

    def checked_forward(*args, **kwargs):
        out, cache = forward(*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        return out, cache

    with switched(RT[config].switches):
        qwen2.forward = checked_forward
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        try:
            feats = encode_media_features(chat.frozen, cfg, raw)
            texts = chat.answer_batch(MODE, SUBTITLES, QUESTION, feats,
                                      max_new_tokens=NEW_TOKENS, do_sample=False)
            torch.cuda.synchronize()
        finally:
            qwen2.forward = forward
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    say("realtime", config=config, switches=json.dumps(
        {f"{mod.__name__.split('.')[-1]}.{name}": v for mod, name, v in RT[config].switches}),
        launches=json.dumps({k: v for k, v in launches.items() if v}), strings=len(texts))
    if launches != expected:
        raise AssertionError(f"realtime {config}: kernel launches {launches} != {expected}")
    dims = {"frame": cfg.visual_dim, "face": cfg.visual_dim, "audio": cfg.acoustic_dim}
    for m, d in dims.items():
        if tuple(feats[m].shape) != (BATCH, 8, d) or not bool(torch.isfinite(feats[m]).all()):
            raise AssertionError(f"realtime {config}: {m} features {tuple(feats[m].shape)}, "
                                 f"expected finite [8, 8, {d}]")
    if len(finite) != NEW_TOKENS + 1 or not bool(torch.stack(finite).all()):
        raise AssertionError(f"realtime {config}: non-finite logits")
    if len(texts) != BATCH or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"realtime {config}: expected {BATCH} strings, got {texts!r}")
    if config == "rt_plain":
        baseline.update(feats=feats, texts=texts)
    else:
        diffs = {}
        for m in dims:
            a, b = feats[m].float().flatten(0, 1), baseline["feats"][m].float().flatten(0, 1)
            cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
            diffs[m] = {"max_abs_diff": round(float((a - b).abs().max()), 6),
                        "min_cos": round(float(cos.min()), 6)}
        say("realtime", config=config, features_vs_rt_plain=json.dumps(diffs),
            strings_equal_to_rt_plain=sum(x == y for x, y in zip(texts, baseline["texts"])))
    return launches


def rt_timed(config: str, chat: Chat, raw: dict) -> dict:
    """One timed visit: each stage alone as the entry point runs it
    (preprocessing of frames and faces, CLIP on frames, CLIP on faces, HuBERT,
    answer_batch on those features), each ending in a synchronize; then the
    whole path, encode_media_features + answer_batch, whose wall time gives
    clips/s from raw media to text; peak device memory over the visit."""
    cfg = chat.cfg
    vspec, vcfg, aspec, acfg = encoder_configs(cfg)
    enc = chat.frozen

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with switched(RT[config].switches):
        torch.cuda.reset_peak_memory_stats()
        prepped, pre_ms = timed(lambda: {m: prepare_frames(raw[m], vcfg.image_size,
                                                           vspec.normalize)
                                         for m in ("frame", "face")})
        feats, ms = {}, {"preprocess_ms": pre_ms}
        for m in ("frame", "face"):
            feats[m], ms[f"clip_{m}_ms"] = timed(
                lambda m=m: vspec.encode(enc["visual_encoder"], vcfg, prepped[m]))
        feats["audio"], ms["hubert_ms"] = timed(
            lambda: aspec.encode(enc["acoustic_encoder"], acfg, raw["audio"]))
        _, ms["answer_batch_ms"] = timed(lambda: chat.answer_batch(
            MODE, SUBTITLES, QUESTION, feats, max_new_tokens=NEW_TOKENS, do_sample=False))
        _, ms["raw_to_text_ms"] = timed(lambda: chat.answer_batch(
            MODE, SUBTITLES, QUESTION, encode_media_features(enc, cfg, raw),
            max_new_tokens=NEW_TOKENS, do_sample=False))
    ms["clips_per_s"] = BATCH / (ms["raw_to_text_ms"] / 1e3)
    ms["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return ms


def phase_realtime(card: str, model: tuple) -> dict:
    """The realtime path at full width on the phase-4 model (CLIP ViT-L/14 +
    HuBERT-large + Qwen2.5-7B, random bf16 weights from a seed, LoRA
    merged): raw media of 8 clips (realtime_media) → encode_media_features →
    greedy Chat.answer_batch in multiface_audio_face_frame_text mode, 32 new
    tokens, under the configurations of RT: a counted run each, then timed
    visits in the order of RT_VISITS. Returns each encoder kernel's launch
    count from the first configuration that runs it."""
    cfg, frozen, trainable, tok, _, _ = model
    t0 = time.perf_counter()
    raw = realtime_media()
    torch.cuda.synchronize()
    say("realtime", media=json.dumps({m: list(v.shape) for m, v in raw.items()}),
        setup_s=f"{time.perf_counter() - t0:.3f}")
    chat = Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN)
    launches, baseline = {}, {}
    for config in RT:
        for name, count in rt_counted(config, chat, raw, baseline).items():
            if count and name not in launches:
                launches[name] = count
    visits = {config: [] for config in RT}
    for config in RT_VISITS:
        visit = rt_timed(config, chat, raw)
        visits[config].append(visit)
        say("realtime", config=config, visit=len(visits[config]),
            **{k: f"{v:.4f}" for k, v in visit.items()}, card=repr(card))
    for config, runs in visits.items():
        say("realtime", config=config, visits=len(runs), **{
            k: f"{statistics.mean(r[k] for r in runs):.4f}" for k in runs[0]}, card=repr(card))
    del raw, chat
    torch.cuda.empty_cache()
    return launches


def main() -> None:
    card = phase_device()
    phase_build(card)
    cfg = qwen2.QwenConfig.qwen25_7b()
    kernels = phase_kernels(card, cfg)
    kernels.update(phase_attention_kernels(card, cfg))
    kernels.update(phase_quant_kernels(card, cfg))
    kernels.update(phase_serving_kernels(card, cfg))
    kernels.update(phase_encoder_kernels(card, clip_vit.ClipVisionConfig.vit_l_14(),
                                         hubert.HubertConfig.large()))
    launches, model = phase_main_path(card)
    for name, count in phase_serve(card, model).items():  # the serving slice's kernels
        launches.setdefault(name, count)
    for name, count in phase_realtime(card, model).items():  # the encoder kernels
        launches.setdefault(name, count)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name], "launches": launches[name],
         **{key: kernels[name][key] for key in keys}}
        for name in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
