"""Time variants of the port's wgmma and tensor-core kernels on one CUDA card.

    python3 scripts/torch_wgmma_variants.py [--only fused|w8a8|mlp|decode|attention|int4] [--out DIR]
                                            [--parent DIR] [NAME ...]

For each variant the package is copied to a temporary directory, a few
source constants are replaced there (the ring depth, the w8a8 row tile;
or, in the variants named `diag_*`, the tensor-core products are dropped,
which breaks the result and shows what the loads and barriers cost alone),
the kernels are built from the copy, and one process checks
the kernel against its plain version at a small shape and times it at the
main path's shapes: `mlp_sublayer_fused` (csrc/vit_mlp_fused.cu) at CLIP's
64 x 257 and HuBERT's 64 x 99 rows (w = 1024, I = 4096, bf16 accumulator),
`int8_matmul_w8a8` summed over one Qwen2.5-7B decoder layer's products at
M = 4512 (csrc/int8_matmul_w8a8.cu, whose row tile and products the `w8a8`
variants edit) and M = 8 (csrc/quant_swapab.cu's w8a8 mode,
unedited), `mlp_sublayer`
(csrc/vit_mlp.cu on csrc/vit_gemm_wgmma.cuh) at the same two shapes as the
fused MLP, with the device ms of each of its three launches from
torch.profiler, and the int8 `decode_mlp` (csrc/decode_mlp_int8.cu) at the
7B layer's widths for b = 8, 16 and 64, with its two launches' ms, and
the two wgmma attention kernels (`--only attention`): `prefill_attention`
(csrc/prefill_attention.cu) at b = 8 and 64, t = 564, 28 q and 4 kv heads
of 128, prompts of 545-564 tokens left-packed, `fused_vit_attention` at
row 13's long shapes in nn.mha's [b, n, h, d] layout (DINOv2's 32 x 1370
tokens x 16 heads of 64, SigLIP's 32 x 729 x 16 of 72, VideoMAE's 8 x 1568
x 6 of 64: csrc/vit_attention_flash.cu) and at ImageBind's 16 x 229 x 12
of 64 with its largest error against the plain version and whether two
calls give the same bits, and at CLIP's 64 x 16 heads x 257 tokens and
HuBERT's 99, each beside SDPA (the unedited variant); `vit_resident` routes
the shapes the resident designs hold (head_dim 64, at most 512 valid keys:
ImageBind's, CLIP's, HuBERT's; csrc/vit_attention.cuh, row 11's attention
step) to them, for the routing rule, and the `vit_*` and `diag_vit_*`
variants edit them on that route; `attn_sublayer`
(`sublayer_as_is`: csrc/vit_sublayer.cu, whose attention step is that
attention) at CLIP's and HuBERT's shapes with the device ms of each of its
launches, its largest error against the plain version, whether two calls
give the same bits, its launch plan and, on the first visit, its library
chain (layer_norm, one addmm for q/k/v, SDPA, addmm + residual) by launch
too; with `--parent DIR` (another checkout, such as the parent commit
unpacked by `git archive`) `sublayer_as_is` runs from this tree and from
DIR in the order A B B A, and so does `attention_as_is` (the parent's
long shapes on its own design); `diag_attention_no_products` drops the
kernels' wgmma products, `diag_attention_no_exp` their exp2 and
`diag_flash_no_products_no_exp` both in the flash design, which splits the
time into loads, products and softmax; `flash_*` sweep the flash design's
key tile, warpgroups and ping-pong; the two int4 decode
wrappers (`--only int4`, csrc/quant_swapab.cu) per Qwen2.5-7B layer
and at the lm_head, `int4_matmul_smallm` at M = 8 and `int4_matmul` at M =
16, with `diag_int4_*` variants without the consumers' work, the nibble conversion
or the products (each keeps what it skips reaching the output: ptxas
deletes work whose results are never stored). For
those two kernels the unedited variant also times the C entry's variants:
without the tensor-core products (`no_products_ms`) and the previous
design (`old_ms`). Times are device ms per
call: calls captured in a CUDA graph over enough weight copies to exceed
the 50 MB L2, 20 replays, the median. Prints the card's name and power
limit first and one JSON line per variant.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
FUSED = "affectgpt_tpu_torch/csrc/vit_mlp_fused.cu"
W8A8 = "affectgpt_tpu_torch/csrc/int8_matmul_w8a8.cu"
GEMM = "affectgpt_tpu_torch/csrc/vit_gemm_wgmma.cuh"
ATTN = "affectgpt_tpu_torch/csrc/attention_wgmma.cuh"
PREFILL = "affectgpt_tpu_torch/csrc/prefill_attention.cu"
VIT_ATTN = "affectgpt_tpu_torch/csrc/vit_attention.cuh"
FLASH = "affectgpt_tpu_torch/csrc/vit_attention_flash.cu"
ENTRY = "affectgpt_tpu_torch/csrc/vit_attention.cu"
INT4 = "affectgpt_tpu_torch/csrc/quant_swapab.cu"

# fused_vit_attention's C entry sends head_dim 64 with at most 512 valid keys
# to the resident designs (as the entry did before the flash design)
_RESIDENT = [
    (ENTRY, '#include "attention_wgmma.cuh"', '#include "vit_attention.cuh"'),
    (ENTRY, "  return (int)launch_vit_attention_flash(",
     "  if (d == kAttnD && valid_len <= kAttnMaxN)\n"
     "    return (int)launch_vit_attention(static_cast<const bf*>(q), static_cast<const bf*>(k),\n"
     "                                     static_cast<const bf*>(v), static_cast<bf*>(out), b,\n"
     "                                     heads, n, valid_len, in, os, s);\n"
     "  return (int)launch_vit_attention_flash(")]
_VIT_SOFTMAX = "for (int h = 0; h < 2; ++h) {  // one chain a key tile"
_VIT_NO_SOFTMAX = "for (int h = 0; h < 0; ++h) {  // one chain a key tile"
_VIT_STORE = "if (row >= n) continue;"
_VIT_NO_STORE = "if (row >= 0) continue;"
# The "no products" diagnostics fold the register operands a left-out
# product would have read into its accumulator (hopper.cuh xor_fold,
# sink_into): ptxas deletes work whose results reach no store, so without
# the fold the fragments' loads and conversions would go too. The SS
# products (operands in shared memory, read by the tensor cores) leave no
# register work behind.
_W8A8_MMA = "        wgmma_s8_rs(acc_i, a[s], desc_sw128(xbase + s * 32, 16, 1024), fresh ? 0 : 1);"
_NO_ATTN_PRODUCTS = [
    (ATTN, "    wgmma_bf16_ss(s, desc_sw128(", "    if (false) wgmma_bf16_ss(s, desc_sw128("),
    (ATTN, "    wgmma_bf16_rs(s, qf[4 * ks], qf[4 * ks + 1], qf[4 * ks + 2], qf[4 * ks + 3],\n"
     "                  desc_sw128(k + (ks / 4) * kBox + 32 * (ks % 4), 16, 1024), ks > 0);",
     "    sink_into(s[ks], qf[4 * ks] ^ qf[4 * ks + 1] ^ qf[4 * ks + 2] ^ qf[4 * ks + 3]);"),
    (ATTN, "    wgmma_bf16_rs_tb(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],\n"
     "                     desc_sw128_mn(v + 2048 * kk, kBox), kk > 0 || accumulate);",
     "    sink_into(o[kk], p[4 * kk] ^ p[4 * kk + 1] ^ p[4 * kk + 2] ^ p[4 * kk + 3]);")]

# name: (kernel, [(file, old text, new text)])
VARIANTS = {
    "fused_as_is": ("fused", []),
    "fused_stages3": ("fused", [(FUSED, "constexpr int kStages = 4;",
                                 "constexpr int kStages = 3;")]),
    "diag_fused_no_products": ("fused", [(FUSED, "      wgmma_bf16_ss_tb(acc,",
                                          "      if (false) wgmma_bf16_ss_tb(acc,")]),
    "w8a8_as_is": ("w8a8", []),
    "w8a8_rows128": ("w8a8", [
        ("affectgpt_tpu_torch/ops/quant.py", "W8A8_STAGES, W8A8_BM = 128, 128, 4, 192",
         "W8A8_STAGES, W8A8_BM = 128, 128, 4, 128"),
        (W8A8, "constexpr int kBM = 192;", "constexpr int kBM = 128;")]),
    # the A fragments (built from the weights in registers) folded into the
    # accumulator in place of the products
    "diag_w8a8_no_products": ("w8a8", [(W8A8, _W8A8_MMA,
                                        "        acc_i[0] ^= (int)xor_fold(a[s]);")]),
    "mlp_as_is": ("mlp", []),
    "mlp_cluster1": ("mlp", [("affectgpt_tpu_torch/ops/vit_gemm.py",
                              "GEMM_CLUSTER = 128, 256, 64, 4, 2",
                              "GEMM_CLUSTER = 128, 256, 64, 4, 1")]),
    # expf, an IEEE division and erff (vit_gemm.cuh's activate) in fc1's epilogue
    "mlp_exact_act": ("mlp", [(GEMM, "activate_pair<ACT>(v[2 * q], v[2 * q + 1]);",
                               "{ v[2 * q] = activate<ACT>(v[2 * q]); "
                               "v[2 * q + 1] = activate<ACT>(v[2 * q + 1]); }")]),
    # fc1 without its epilogue (fc2 keeps its own): the k loop and the ring alone
    "diag_mlp_fc1_no_epilogue": ("mlp", [(GEMM, "    for (int half = 0; half < 2; ++half) {",
                                          "    for (int half = 0; half < (RESIDUAL ? 2 : 0); "
                                          "++half) {")]),
    "decode_as_is": ("decode", []),
    "attention_as_is": ("attention", []),
    "sublayer_as_is": ("sublayer", []),
    # the resident designs where they take the shape
    "vit_resident": ("attention", _RESIDENT),
    # CLIP's five key tiles through the resident two-pass design
    "vit_two_pass": ("attention", _RESIDENT + [(VIT_ATTN, "return launch<5>(",
                                                "return launch<0>(")]),
    # no kernel's tensor-core products (the prefill kernel's come from
    # attention_wgmma.cuh; the flash design's fold their operands into a sink)
    "diag_attention_no_products": ("attention", _NO_ATTN_PRODUCTS + [
        (FLASH, "constexpr bool kProducts = true;", "constexpr bool kProducts = false;")]),
    # no exp2 in either kernel's softmax (the values go on as they are)
    "diag_attention_no_exp": ("attention", [
        (PREFILL, "fast_exp2(", "("),
        (FLASH, "constexpr bool kExp = true;", "constexpr bool kExp = false;")]),
    # the flash design (the long shapes) with neither: its loads, barriers and
    # the softmax's other arithmetic
    "diag_flash_no_products_no_exp": ("attention", [
        (FLASH, "constexpr bool kProducts = true;", "constexpr bool kProducts = false;"),
        (FLASH, "constexpr bool kExp = true;", "constexpr bool kExp = false;")]),
    # the flash design's sweep at head_dims other than 80 and 96 (DINOv2's,
    # VideoMAE's 64): key tiles of 64, three consumer warpgroups (192 query
    # rows a work tile, 160 registers a thread) with key tiles of 64; at 80
    # and 96 (SigLIP's 72): two warpgroups with key tiles of 128 or 64
    "flash_keys64": ("attention", [(FLASH, "constexpr int kBN = 128;",
                                    "constexpr int kBN = 64;")]),
    "flash_consumers3_keys64": ("attention", [
        (FLASH, "constexpr int kBN = 128;", "constexpr int kBN = 64;"),
        (FLASH, "constexpr int kConsumers = 2;", "constexpr int kConsumers = 3;")]),
    "flash_wide_consumers2_keys128": ("attention", [
        (FLASH, "constexpr int kWideBN = 64;", "constexpr int kWideBN = 128;"),
        (FLASH, "constexpr int kWideConsumers = 3;", "constexpr int kWideConsumers = 2;")]),
    "flash_wide_consumers2": ("attention", [
        (FLASH, "constexpr int kWideConsumers = 3;", "constexpr int kWideConsumers = 2;")]),
    "flash_no_pingpong": ("attention", [(FLASH, "constexpr bool kPingPong = true;",
                                         "constexpr bool kPingPong = false;")]),
    # the prefill's K/V ring two stages deep instead of four
    "prefill_stages2": ("attention", [(PREFILL, "constexpr int kStages = 4;",
                                       "constexpr int kStages = 2;")]),
    # the prefill's consumers only wait for and release the stages: the producer and loads alone
    "diag_prefill_no_consumer_work": ("attention", [
        (PREFILL, "if (live) {\n        const uint32_t ka", "if (false) {\n        const uint32_t ka")]),
    # the prefill's masked tiles taken as full: no per-element test
    "diag_prefill_no_mask": ("attention", [(PREFILL, "? kFull : kMasked;", "? kFull : kFull;")]),
    # the resident one-pass ViT kernel without its softmax (P is the raw
    # scores), without its stores, and with neither nor its products: the
    # loads and barriers alone
    "diag_vit_no_softmax": ("attention",
                            _RESIDENT + [(VIT_ATTN, _VIT_SOFTMAX, _VIT_NO_SOFTMAX)]),
    "diag_vit_no_stores": ("attention", _RESIDENT + [(VIT_ATTN, _VIT_STORE, _VIT_NO_STORE)]),
    "int4_as_is": ("int4", []),
    # the consumers take each stage and hand it back untouched: the ring alone
    "diag_int4_loads_only": ("int4", [(INT4, "kConsume = true;", "kConsume = false;")]),
    # the raw packed words as A fragments: no nibble conversion, no dequant scaling
    "diag_int4_no_convert": ("int4", [(INT4, "kConvert = true;", "kConvert = false;")]),
    # the fragments built and XORed into a sink instead of multiplied
    "diag_int4_no_products": ("int4", [(INT4, "kProducts = true;", "kProducts = false;")]),
    "diag_vit_loads_only": ("attention", _RESIDENT + [
        (VIT_ATTN, _VIT_SOFTMAX, _VIT_NO_SOFTMAX), (VIT_ATTN, _VIT_STORE, _VIT_NO_STORE),
        *_NO_ATTN_PRODUCTS]),
}

BENCH = r"""
import json, statistics, sys
import torch
from torch.profiler import ProfilerActivity, profile
from affectgpt_tpu_torch.ops import decode_mlp, quant, vit_attention, vit_mlp, vit_mlp_fused
from affectgpt_tpu_torch.ops import vit_sublayer
from affectgpt_tpu_torch.ops.prefill_attention import prefill_attention, prefill_attention_reference

kind, name, chain = sys.argv[1], sys.argv[2], sys.argv[3:] == ["chain"]
g = torch.Generator(device="cuda").manual_seed(0)

def rnd(*shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(torch.bfloat16)

def graph_ms(calls, reps=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(); graph.replay(); e.record(); events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / len(calls)

def kernel_ms(fn, reps=10):  # device ms of each kernel a call launches, by name
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if e.count and t:
            out[e.key.split("(")[0][-48:]] = t / e.count / 1000
    return out

out = {"variant": name}
if kind == "mlp":
    w, inter = 1024, 4096
    layers = [(rnd(w, scale=0.1, shift=1.0), rnd(w, scale=0.1), rnd(w, inter, scale=0.02),
               rnd(inter, scale=0.1), rnd(inter, w, scale=0.02), rnd(w, scale=0.1))
              for _ in range(4)]
    x = rnd(3, 99, w)
    got = vit_mlp.mlp_sublayer(x, *layers[0], act="gelu")
    ref = vit_mlp.mlp_sublayer_reference(x, *layers[0], act="gelu")
    out["max_abs_err"] = float((got.float() - ref.float()).abs().max())
    for tower, n, act in (("clip", 257, "quick_gelu"), ("hubert", 99, "gelu")):
        x = rnd(64, n, w)
        runs = {"ms": 0, "no_products_ms": 1, "old_ms": 2} if name == "mlp_as_is" else {"ms": 0}
        for key, v in runs.items():
            out[f"{tower}_{key}"] = graph_ms([
                lambda p=p, v=v: vit_mlp._launch(x, *p, eps=1e-5, act=act, variant=v)
                for p in layers])
        out[f"{tower}_launch_ms"] = kernel_ms(
            lambda: vit_mlp._launch(x, *layers[0], eps=1e-5, act=act))
elif kind == "decode":
    h, inter = 3584, 18944
    leaves = []
    for k, n in ((h, inter), (h, inter), (inter, h)):
        leaves += quant.quantize_per_channel(torch.randn(k, n, generator=g, device="cuda")
                                             * k ** -0.5)
    ln = rnd(h, scale=0.1, shift=1.0)
    for b in (8, 16, 64):
        args = (rnd(b, h), ln, *leaves)
        for key, v in {"ms": 0, "no_products_ms": 1, "old_ms": 2}.items():
            out[f"b{b}_{key}"] = graph_ms([lambda v=v: decode_mlp._launch(args, v, 1e-6)] * 8)
        out[f"b{b}_launch_ms"] = kernel_ms(lambda: decode_mlp._launch(args, 0, 1e-6))
elif kind == "attention":
    sdpa = torch.nn.functional.scaled_dot_product_attention
    as_is = name in ("attention_as_is", "attention_as_is_tree")  # the library calls beside it
    for b in (8, 64):  # Qwen2.5-7B: 28 q heads, 4 kv heads, d = 128; prompts of 545-564
        t, heads, kv, d = 564, 28, 4, 128
        lengths = torch.randint(545, t + 1, (b,), generator=g, device="cuda")
        seg = torch.arange(t, device="cuda")[None, :] >= (t - lengths)[:, None]
        q, k, v = rnd(b, t, heads, d), rnd(b, kv, t, d), rnd(b, kv, t, d)
        if b == 8:
            out["prefill_max_abs_err"] = float((prefill_attention(q, k, v, seg).float()
                                                - prefill_attention_reference(q, k, v, seg)
                                                .float()).abs().max())
        out[f"prefill_b{b}_ms"] = graph_ms([lambda: prefill_attention(q, k, v, seg)] * 4)
        if as_is:
            vis = torch.ones((t, t), dtype=torch.bool, device="cuda").tril()[None] \
                & (seg[:, :, None] == seg[:, None, :])
            qh, vis4 = q.transpose(1, 2), vis[:, None]
            out[f"prefill_b{b}_sdpa_ms"] = graph_ms(
                [lambda: sdpa(qh, k, v, attn_mask=vis4, enable_gqa=True)] * 2)
            out[f"prefill_b{b}_kernel_ms"] = kernel_ms(lambda: prefill_attention(q, k, v, seg))
        del q, k, v
    # row 13's long shapes ([b, heads, n, d]; the [b, n, h, d] layout nn.mha
    # hands the kernel), where the flash design runs (the stream before it)
    for shape, (b, h, n, d) in (("dinov2", (32, 16, 1370, 64)), ("siglip", (32, 16, 729, 72)),
                                ("videomae", (8, 6, 1568, 64)), ("imagebind", (16, 12, 229, 64))):
        qkv = [tuple(rnd(b, n, h, d) for _ in range(3)) for _ in range(2)]
        got = vit_attention.fused_self_attention(*qkv[0], n)
        heads_first = [x.transpose(1, 2) for x in qkv[0]]
        want = vit_attention.fused_vit_attention_reference(*heads_first, n).transpose(1, 2)
        out[f"long_{shape}_max_abs_err"] = float((got.float() - want.float()).abs().max())
        out[f"long_{shape}_same_bits"] = torch.equal(
            got, vit_attention.fused_self_attention(*qkv[0], n))
        out[f"long_{shape}_ms"] = graph_ms(
            [lambda t=t: vit_attention.fused_self_attention(*t, n) for t in qkv] * 4)
        if as_is:
            out[f"long_{shape}_sdpa_ms"] = graph_ms(
                [lambda t=t: sdpa(*(x.transpose(1, 2) for x in t)) for t in qkv] * 4)
            out[f"long_{shape}_sdpa_max_abs_err"] = float(
                (sdpa(*heads_first).transpose(1, 2).float() - want.float()).abs().max())
        del qkv, got, want, heads_first
    b, h, d, w = 64, 16, 64, 1024
    for tower, n in (("clip", 257), ("hubert", 99)):  # 64 images or clips, 16 heads of 64
        qkv = [tuple(rnd(b, h, n, d) for _ in range(3)) for _ in range(2)]
        if tower == "clip":
            out["vit_max_abs_err"] = float((vit_attention.fused_vit_attention(*qkv[0], n).float()
                                            - vit_attention.fused_vit_attention_reference(
                                                *qkv[0], n).float()).abs().max())
        out[f"vit_{tower}_ms"] = graph_ms(
            [lambda t=t: vit_attention.fused_vit_attention(*t, n) for t in qkv] * 4)
        if as_is:
            mask = torch.ones((1, 1, 1, n), dtype=torch.bool, device="cuda")
            out[f"vit_{tower}_sdpa_ms"] = graph_ms([lambda t=t: sdpa(*t, attn_mask=mask)
                                                    for t in qkv] * 4)
        del qkv
elif kind == "sublayer":
    b, h, w = 64, 16, 1024
    for tower, n in (("clip", 257), ("hubert", 99)):  # 64 images or clips, 16 heads of 64
        x = rnd(b, n, w)
        layers = [(rnd(w, scale=0.1, shift=1.0), rnd(w, scale=0.1),
                   *[m for _ in range(4) for m in (rnd(w, w, scale=0.02), rnd(w, scale=0.1))])
                  for _ in range(4)]
        got = vit_sublayer.attn_sublayer(x, *layers[0], h, n)
        out[f"{tower}_same_bits"] = torch.equal(got, vit_sublayer.attn_sublayer(x, *layers[0], h, n))
        out[f"{tower}_max_abs_err"] = float((got.float() - vit_sublayer.attn_sublayer_reference(
            x, *layers[0], h, n).float()).abs().max())
        out[f"{tower}_ms"] = graph_ms(
            [lambda p=p: vit_sublayer.attn_sublayer(x, *p, h, n) for p in layers] * 2)
        out[f"{tower}_launch_ms"] = kernel_ms(lambda: vit_sublayer.attn_sublayer(x, *layers[0], h, n))
        if chain:  # layer_norm, one addmm for q/k/v, SDPA, addmm + residual
            mask = torch.ones((1, 1, 1, n), dtype=torch.bool, device="cuda")
            cat = [(torch.cat(p[2:8:2], dim=1), torch.cat(p[3:8:2])) for p in layers]

            def library_chain(p, wqkv, bqkv):
                hh = torch.nn.functional.layer_norm(x, (w,), p[0], p[1], 1e-5)
                qkv = torch.addmm(bqkv, hh.view(-1, w), wqkv).view(b, n, 3, h, w // h)
                q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
                o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                return torch.addmm(p[9], o.transpose(1, 2).reshape(-1, w), p[8]).view_as(x) + x

            out[f"{tower}_chain_ms"] = graph_ms(
                [lambda p=p, c=c: library_chain(p, *c) for p, c in zip(layers, cat)] * 2)
            out[f"{tower}_chain_launch_ms"] = kernel_ms(lambda: library_chain(layers[0], *cat[0]))
        try:
            from affectgpt_tpu_torch.ops.vit_sublayer import attn_sublayer_plan
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            pl = attn_sublayer_plan(b * n, w, sms)
            out[f"{tower}_plan"] = {k: {f: pl[k][f] for f in ("n_tiles", "m_tiles", "cluster",
                                                            "units", "rounds")}
                                    for k in ("qkv", "o")}
        except ImportError:  # the parent's package has no plan
            pass
        del layers
elif kind == "int4":
    # Qwen2.5-7B's split layer and lm_head; (M, wrapper) as the main path routes them
    layer = {"q": (3584, 3584), "k": (3584, 512), "v": (3584, 512), "o": (3584, 3584),
             "gate": (3584, 18944), "up": (3584, 18944), "down": (18944, 3584),
             "lm_head": (3584, 152064)}
    stored = {}
    for k, n in set(layer.values()):
        stored[(k, n)] = (torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda",
                                        dtype=torch.int8),
                          (torch.rand((k // 128, n), generator=g, device="cuda") + 0.5) * 1e-2)
    w, s = stored[(3584, 512)]
    x = rnd(13, 3584)
    for fn in ("int4_matmul", "int4_matmul_smallm"):
        ref = getattr(quant, fn + "_reference")(x, w, s).float()
        out[f"{fn}_max_abs_err"] = float((getattr(quant, fn)(x, w, s).float() - ref).abs().max())
    for fn, m in (("int4_matmul_smallm", 8), ("int4_matmul", 16)):
        kernel = getattr(quant, fn)
        for key, call in {"ms": kernel}.items():
            per = {}
            for p, (k, n) in layer.items():
                w, s = stored[(k, n)]
                copies = max(1, -(-64 * 2**20 // (w.numel() + 4 * s.numel())))
                ws = [(w, s)] + [(w.clone(), s.clone()) for _ in range(copies - 1)]
                xm = rnd(m, k)
                per[p] = graph_ms([lambda w=w, s=s: call(xm, w, s) for w, s in ws]
                                  * max(1, -(-8 // copies)))
                del ws
            out[f"{fn}_M{m}_{key}"] = {**per, "layer": sum(v for p, v in per.items()
                                                           if p != "lm_head")}
elif kind == "fused":
    w, inter = 1024, 4096
    layers = [(rnd(w, scale=0.1, shift=1.0), rnd(w, scale=0.1), rnd(w, inter, scale=0.02),
               rnd(inter, scale=0.1), rnd(inter, w, scale=0.02), rnd(w, scale=0.1))
              for _ in range(4)]
    x = rnd(3, 40, w)
    got = vit_mlp_fused.mlp_sublayer_fused(x, *layers[0], acc="f32")
    ref = vit_mlp_fused.mlp_sublayer_fused_reference(x, *layers[0], acc="f32")
    out["max_abs_err_f32acc"] = float((got.float() - ref.float()).abs().max())
    for tower, n, act in (("clip", 257, "quick_gelu"), ("hubert", 99, "gelu")):
        x = rnd(64, n, w)
        out[tower + "_ms"] = graph_ms([lambda p=p: vit_mlp_fused.mlp_sublayer_fused(x, *p, act=act)
                                       for p in layers])
else:
    layer = [(3584, 3584), (3584, 512), (3584, 512), (3584, 3584), (3584, 18944),
             (3584, 18944), (18944, 3584)]
    stored = {}
    for k, n in set(layer):
        stored[(k, n)] = (torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                                        dtype=torch.int8),
                          torch.rand((1, n), generator=g, device="cuda") * 1e-3 + 1e-4)
    w, s = stored[(3584, 512)]
    x = rnd(200, 3584)
    got = quant.int8_matmul_w8a8(x, w, s)
    ref = quant.int8_matmul_w8a8_reference(x, w, s)
    out["max_rel_err"] = float(((got.float() - ref.float()).abs()
                                / ref.float().abs().clamp_min(1e-2)).max())
    for m in (4512, 8):
        total = 0.0
        for k, n in layer:
            w, s = stored[(k, n)]
            copies = max(1, -(-64 * 2**20 // w.numel()))
            ws = [(w, s)] + [(w.clone(), s.clone()) for _ in range(copies - 1)]
            xm = rnd(m, k)
            total += graph_ms([lambda w=w, s=s: quant.int8_matmul_w8a8(xm, w, s) for w, s in ws]
                              * max(1, -(-8 // copies)))
            del ws
        out[f"layer_ms_M{m}"] = total
print(json.dumps(out), flush=True)
"""


def copy_package(name: str, edits: list, tmp_root: Path, source: Path = REPO) -> Path:
    """source's package copied under tmp_root with each (file, old, new) edit made."""
    root = Path(tempfile.mkdtemp(dir=tmp_root))
    shutil.copytree(source / "affectgpt_tpu_torch", root / "affectgpt_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        path = root / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {rel}")
        path.write_text(text.replace(old, new))
    return root


def run_variant(name: str, kind: str, edits: list, tmp_root: Path, bench: str = BENCH,
                source: Path = REPO, chain: bool = False) -> None:
    """Build and run `bench` (argv: kind, name[, chain]) in a copy of source's
    package with `edits`; print its last line."""
    root = copy_package(name, edits, tmp_root, source)
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", bench, kind, name, *(["chain"] if chain else [])],
                          env=env, cwd=root, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(json.dumps({"variant": name, "error": proc.stderr[-2000:]}), flush=True)
    else:
        print(proc.stdout.strip().splitlines()[-1], flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("fused", "w8a8", "mlp", "decode", "attention", "int4"))
    ap.add_argument("--out", default=None, help="scratch directory (default: a temporary one)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout: sublayer_as_is from it too, A B B A")
    ap.add_argument("names", nargs="*", help="only these variants (default: all, or --only's)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tmp_root = Path(args.out or tempfile.mkdtemp())
    tmp_root.mkdir(parents=True, exist_ok=True)
    kinds = {None: None, "attention": ("attention", "sublayer")}.get(args.only, (args.only,))
    for name, (kind, edits) in VARIANTS.items():
        if (kinds is None or kind in kinds) and (not args.names or name in args.names):
            if name in ("sublayer_as_is", "attention_as_is") and args.parent:
                for i, src in enumerate((REPO, args.parent.resolve(), args.parent.resolve(), REPO)):
                    run_variant(f"{name}_{'parent' if i in (1, 2) else 'tree'}", kind, edits,
                                tmp_root, source=src, chain=i == 0 and kind == "sublayer")
            else:
                run_variant(name, kind, edits, tmp_root, chain=name == "sublayer_as_is")


if __name__ == "__main__":
    main()
