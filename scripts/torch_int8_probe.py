"""Probes of the quantized matmuls on one CUDA card: the int8 and w8a8
modes of the swap-AB kernel (csrc/quant_swapab.cu) that `int8_matmul` and
`int8_matmul_w8a8` launch at M <= 16, and the wgmma kernel
(csrc/quant_wgmma.cuh) that `int8_matmul`, `int4_matmul` and (its w8a8
mode, up to quant.PALLAS_DEQUANT_MAX_M) `int8_matmul_w8a8` launch above it.

    python3 scripts/torch_int8_probe.py check    # correctness, per-layer times, cluster sweep
    python3 scripts/torch_int8_probe.py time [--w8a8] [DIR ...]  # this tree's package beside each DIR's
    python3 scripts/torch_int8_probe.py builds [NAME ...]  # edited copies of the swap-AB kernel
    python3 scripts/torch_int8_probe.py wgmma [NAME ...]   # edited copies of the wgmma kernel
    python3 scripts/torch_int8_probe.py sweep    # the wgmma kernel at every K split, the w8a8
                                                 # mode at every cluster and block width

`check`: `int8_matmul` against its plain version at every M of 1-16 and at
M = 17, 40, 64, 100, 256, 257, 1000 and 1024 (quant_wgmma.cuh) on the tiny
test shapes and every Qwen2.5-7B (K, N) of the split and fused layouts and
the lm_head; two calls must give the same bits. Then device ms of each
product and of the fused layer (q8_fused: qkv, o, gateup, down) and the
split layer at M = 8 and 16, and the lm_head; then q/k/gate/down_proj at
every cluster size, launched through the C entry. `time`: the quantized
matmuls per product and per layer, as the main path runs them at decode M:
`int8_matmul_w8a8` on q8a8's split layer and the lm_head at M = 8, 16, 40
(the speculative verify) and 256 (bench.py's 7B batch), and on the split
layer at M = 1000 and the prefill's 4512 (with `--w8a8` nothing else); `int8_matmul` on q8_fused's layer at M = 8 and on paged_w8's
q/k/v/o at M = 16, `int4_matmul_smallm` at M = 8 and `int4_matmul` at M =
16 on the split layer, each with the lm_head; and above decode M:
`int8_matmul`, `int4_matmul` and `int4_matmul_smallm` on the split layer
and the lm_head at M = 40 (the speculative verify), 256 (bench.py's 7B
batch) and 1000 (prefill rows); each package (this tree's, then each DIR's, the root of another
checkout such as the parent commit unpacked into a directory that
.gitignore lists) in a process of its own, in the order A B B A, so a
drift of the card weighs on both. `builds`: the package copied to a
temporary directory with a few source lines of the swap-AB kernel edited
(VARIANTS: the loads alone, no conversion, no products), built, and
gate/down/q_proj, gate_proj cut to 132 column blocks, and the fused layer
timed at M = 8 and 16 (`int8_matmul`); the `w8a8_*` variants edit the w8a8
mode (the loads alone, no quantization of x, no products) and time
`int8_matmul_w8a8` per product of the split layer and at the lm_head at M =
8 and 16, with the largest error against the plain version (and
`w8a8_no_x_loads`: x not staged); the `w8a8_wgmma_*` variants edit the
w8a8 mode of quant_wgmma.cuh (the loads alone, no products, no qblock
scaling: each qblock's s32 sums not waited for and scaled on their own, one
s32 tile over the share; the consumer warpgroups taking turns) and time `int8_matmul_w8a8` per split layer at M =
40, 256 and 1000. `wgmma`: the same with quant_wgmma.cuh's switches
(WGMMA_VARIANTS), the split layer of `int8_matmul` and `int4_matmul` timed
at M = 40, 256 and 1000, to split the kernel's time into loads,
conversion and products (a NAME given twice is built and timed twice).
`sweep`: the wgmma kernel through its C entries at every K split the card
holds (int4 also at 64-row batch blocks), beside the plan's choice, on
q/k/gate/down_proj at M = 40, 256 and 1000; then the swap-AB kernel's w8a8
mode through its C entry at every cluster size and both block widths (128
and 64 columns), beside `w8a8_swapab_plan`'s choice, on q/k/gate/down_proj
at M = 8 and 16. Times: calls captured in a
CUDA graph over enough weight copies to exceed the 50 MB L2, 20 replays,
the median. Prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from torch_int4_probe import GRAPH_MS, LAYER, card
from torch_wgmma_variants import REPO, run_variant

SAB = "affectgpt_tpu_torch/csrc/quant_swapab.cu"
QWG = "affectgpt_tpu_torch/csrc/quant_wgmma.cuh"
QUANT = "affectgpt_tpu_torch/ops/quant.py"
SPLIT = {"q": (3584, 3584), "k": (3584, 512), "v": (3584, 512), "o": (3584, 3584),
         "gate": (3584, 18944), "up": (3584, 18944), "down": (18944, 3584)}
FUSED = {"qkv": (3584, 4608), "o": (3584, 3584), "gateup": (3584, 37888),
         "down": (18944, 3584)}
LM_HEAD = (3584, 152064)
# name: [(file, old text, new text)]
VARIANTS = {
    "as_is": [],
    # the consumers take each stage and hand it back untouched: the ring alone
    "loads_only": [(SAB, "kConsume = true;", "kConsume = false;")],
    # the raw weight words as A fragments: no int8 to bf16 conversion
    "no_convert": [(SAB, "kConvert = true;", "kConvert = false;")],
    # the fragments built and XORed into the output instead of multiplied
    "no_products": [(SAB, "kProducts = true;", "kProducts = false;")],
    # the w8a8 mode (int8_matmul_w8a8 at M <= 16): as built; the ring alone
    # (no quantization, no products); x not quantized (xq and sx left as
    # they were); the fragments XORed into the output instead of multiplied
    "w8a8_as_is": [],
    "w8a8_loads_only": [(SAB, "kConsume = true;", "kConsume = false;")],
    "w8a8_no_quantize": [(SAB, "kQuantize = true;", "kQuantize = false;")],
    "w8a8_no_products": [(SAB, "kProducts = true;", "kProducts = false;")],
    # x not staged: the producer hands the staging buffer over without its
    # TMA loads (the consumers quantize what it held)
    "w8a8_no_x_loads": [(SAB, "mbar_expect_tx(xsfull, x_boxes * 8 * NT * x_cols * 2);",
                         "mbar_arrive(xsfull);"),
                        (SAB, "for (int h = 0; h < x_boxes; ++h)", "for (int h = 0; h < 0; ++h)")],
    # the w8a8 mode of quant_wgmma.cuh (int8_matmul_w8a8 above M = 16): as
    # built; the ring alone; the fragments XORed into the output instead of
    # multiplied; no qblock scaling (one s32 tile over the share); the two
    # consumer warpgroups taking the tensor cores in turn, a pair each
    "w8a8_wgmma_as_is": [],
    "w8a8_wgmma_loads_only": [(QWG, "kConsume = true;", "kConsume = false;")],
    "w8a8_wgmma_no_products": [(QWG, "kProducts = true;", "kProducts = false;")],
    "w8a8_wgmma_no_scaling": [(QWG, "kScale = true;", "kScale = false;")],
    "w8a8_wgmma_ping_pong": [(QWG, "kPingPong = false;", "kPingPong = true;")],
}

# quant_wgmma.cuh's diagnostic switches
WGMMA_VARIANTS = {
    "as_is": [],
    # the consumers take each pair and hand it back untouched: the ring alone
    "loads_only": [(QWG, "kConsume = true;", "kConsume = false;")],
    # the raw weight words as A fragments: no conversion to bf16
    "no_convert": [(QWG, "kConvert = true;", "kConvert = false;")],
    # the fragments built and XORed into the output instead of multiplied
    "no_products": [(QWG, "kProducts = true;", "kProducts = false;")],
}
WGMMA_M = (17, 40, 64, 100, 256, 257, 1000, 1024)

INT8_MS = GRAPH_MS + r'''
def weights8(g, k, n):
    w = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
    s = (torch.rand((1, n), generator=g, device="cuda") + 0.5) * (3 * k ** -0.5 / 127)
    return w, s

def entry8_ms(lib, x, ws, rep, m, n, k, cluster):
    y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    def call(w, s):
        status = lib.agk_quant_swapab(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), m, n,
                                      k, cluster, 2, torch.cuda.current_stream().cuda_stream)
        assert status == 0, status
    return graph_ms([lambda w=w, s=s: call(w, s) for w, s in ws] * rep)
'''


def check() -> None:
    sys.path.insert(0, str(REPO))
    import torch
    from affectgpt_tpu_torch.ops import _build, quant
    ns = {}
    exec(INT8_MS, ns)
    graph_ms, weights8, copies_of, entry8_ms = (ns[k] for k in ("graph_ms", "weights8",
                                                                "copies_of", "entry8_ms"))
    lib = _build.load_library()
    for m in (8, 16):
        print("active clusters", f"M={m}",
              [quant._swapab_active_clusters(0, c, m, quant.MODE_INT8) for c in range(1, 9)],
              flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    shapes = [(64, 256), (1024, 512), (512, 272), *sorted({*SPLIT.values(), *FUSED.values()}),
              LM_HEAD]
    for k, n in shapes:
        w, s = weights8(g, k, n)
        for m in (*range(1, 17), *WGMMA_M):
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            got = quant.int8_matmul(x, w, s)
            ref = quant.int8_matmul_reference(x, w, s).float()
            ok = bool(((got.float() - ref).abs() <= 1e-2 + 1.6e-2 * ref.abs()).all())
            same = torch.equal(got, quant.int8_matmul(x, w, s))
            bad += not (ok and same)
            if m in (1, 16, 40, 256, 1000) or not (ok and same):
                print("int8_matmul", f"K={k} N={n} M={m}", "max_abs_err",
                      round(float((got.float() - ref).abs().max()), 5), "ok", ok, "same", same,
                      flush=True)
        del w, s
    print("failed checks", bad, flush=True)
    for m in (8, 16):
        for layout, layer in (("fused", FUSED), ("split", SPLIT)):
            total = {"ms": 0.0}
            products = {**layer, "lm_head": LM_HEAD} if layout == "fused" else layer
            for p, (k, n) in products.items():
                w, s = weights8(g, k, n)
                x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
                ws, rep = copies_of(w, s)
                t = {"ms": graph_ms([lambda w=w, s=s: quant.int8_matmul(x, w, s)
                                     for w, s in ws] * rep)}
                plan = quant._swapab_plan_on(0, m, n, k, quant.MODE_INT8)
                nbytes = w.numel() + 4 * s.numel() + 2 * m * (k + n)
                print("int8_matmul", f"M={m}", layout, p,
                      {key: round(v, 5) for key, v in t.items()},
                      "bound_ms", round(nbytes / 3.35e9, 5), "GB/s",
                      round(nbytes / t["ms"] / 1e6, 1), "cluster", plan["cluster"], "grid",
                      plan["grid"][0], flush=True)
                if p != "lm_head":
                    for key in total:
                        total[key] += t[key]
                if m == 8 and layout == "split" and p in ("q", "k", "gate", "down"):
                    sweep = {c: round(entry8_ms(lib, x, ws, rep, m, n, k, c), 5)
                             for c in range(1, min(8, -(-k // quant.INT8_ROWS)) + 1)}
                    print("  cluster sweep", sweep, flush=True)
                del ws, w, s
            print("int8_matmul", f"M={m}", layout, "layer",
                  {key: round(v, 5) for key, v in total.items()}, flush=True)


BUILD_BENCH = INT8_MS + r'''
import json, sys
from affectgpt_tpu_torch.ops import quant
g = torch.Generator(device="cuda").manual_seed(0)
out = {"variant": sys.argv[2]}
w, s = weights8(g, 3584, 512)
x = torch.randn((5, 3584), generator=g, device="cuda").to(torch.bfloat16)
out["max_abs_err"] = round(float((quant.int8_matmul(x, w, s).float()
                                  - quant.int8_matmul_reference(x, w, s).float()).abs().max()), 5)
for m in (8, 16):
    layer = 0.0
    # gate132: gate_proj cut to 132 column blocks (one block an SM, none
    # doubled), beside the real one's 148
    for p, (k, n) in {"gate": (3584, 18944), "down": (18944, 3584), "q": (3584, 3584),
                      "qkv": (3584, 4608), "gateup": (3584, 37888), "o": (3584, 3584),
                      "gate132": (3584, 132 * 128)}.items():
        ws, rep = copies_of(*weights8(g, k, n))
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        us = graph_ms([lambda w=w, s=s: quant.int8_matmul(x, w, s) for w, s in ws] * rep) * 1000
        if p in ("gate", "down", "q", "gate132"):
            out[f"{p}_M{m}_us"] = round(us, 2)
        if p in ("qkv", "o", "gateup", "down"):
            layer += us
        del ws
    out[f"fused_layer_M{m}_us"] = round(layer, 2)
print(json.dumps(out), flush=True)
'''


W8A8_BUILD_BENCH = INT8_MS + f"""
import json, sys
from affectgpt_tpu_torch.ops import quant
SPLIT, LM_HEAD = {SPLIT!r}, {LM_HEAD!r}
""" + r'''
g = torch.Generator(device="cuda").manual_seed(0)
out = {"variant": sys.argv[2]}
w, s = weights8(g, 3584, 512)
x = torch.randn((5, 3584), generator=g, device="cuda").to(torch.bfloat16)
out["max_abs_err"] = round(float((quant.int8_matmul_w8a8(x, w, s).float()
                                  - quant.int8_matmul_w8a8_reference(x, w, s).float()).abs().max()), 5)
for m in (8, 16):
    per = {}
    for p, (k, n) in {**SPLIT, "lm_head": LM_HEAD}.items():
        ws, rep = copies_of(*weights8(g, k, n))
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        per[p] = round(graph_ms([lambda w=w, s=s: quant.int8_matmul_w8a8(x, w, s)
                                 for w, s in ws] * rep), 5)
        del ws
    out[f"M{m}"] = {"layer_ms": round(sum(v for p, v in per.items() if p != "lm_head"), 5), **per}
print(json.dumps(out), flush=True)
'''


W8A8_WGMMA_BENCH = INT8_MS + f"""
import json, sys
from affectgpt_tpu_torch.ops import quant
SPLIT = {SPLIT!r}
""" + r'''
g = torch.Generator(device="cuda").manual_seed(0)
out = {"variant": sys.argv[2]}
w, s = weights8(g, 3584, 512)
x = torch.randn((40, 3584), generator=g, device="cuda").to(torch.bfloat16)
out["max_abs_err"] = round(float((quant.int8_matmul_w8a8(x, w, s).float()
                                  - quant.int8_matmul_w8a8_reference(x, w, s).float()).abs().max()), 5)
for m in (40, 256, 1000):
    per = {}
    for p, (k, n) in SPLIT.items():
        ws, rep = copies_of(*weights8(g, k, n))
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        per[p] = round(graph_ms([lambda w=w, s=s: quant.int8_matmul_w8a8(x, w, s)
                                 for w, s in ws] * rep), 5)
        del ws
    out[f"M{m}"] = {"layer_ms": round(sum(per.values()), 5), **per}
print(json.dumps(out), flush=True)
'''


def builds(names: list) -> None:
    tmp = Path(tempfile.mkdtemp())
    for name in names or VARIANTS:
        bench = (W8A8_WGMMA_BENCH if name.startswith("w8a8_wgmma_") else
                 W8A8_BUILD_BENCH if name.startswith("w8a8_") else BUILD_BENCH)
        run_variant(name, "int8_builds", VARIANTS[name], tmp, bench=bench)


TIME_BENCH = INT8_MS + f"""
import json, sys
from affectgpt_tpu_torch.ops import quant
SPLIT, FUSED, LM_HEAD, LAYER = {SPLIT!r}, {FUSED!r}, {LM_HEAD!r}, {LAYER!r}
""" + r'''
g = torch.Generator(device="cuda").manual_seed(0)
out = {"package": sys.argv[1]}
w8a8 = tuple((f"int8_matmul_w8a8_M{m}", quant.int8_matmul_w8a8, 8, m,
              {**SPLIT, "lm_head": LM_HEAD} if m <= 256 else SPLIT)
             for m in (8, 16, 40, 256, 1000, 4512))
runs = w8a8 if sys.argv[2] == "w8a8" else w8a8 + (
        ("int8_matmul_M8_fused", quant.int8_matmul, 8, 8, {**FUSED, "lm_head": LM_HEAD}),
        ("int8_matmul_M16_qkvo", quant.int8_matmul, 8, 16,
         {**{p: SPLIT[p] for p in "qkvo"}, "lm_head": LM_HEAD}),
        ("int4_matmul_smallm_M8", quant.int4_matmul_smallm, 4, 8, LAYER),
        ("int4_matmul_M16", quant.int4_matmul, 4, 16, LAYER),
        *((f"{fn.__name__}_M{m}", fn, bits, m, LAYER)
          for fn, bits in ((quant.int8_matmul, 8), (quant.int4_matmul, 4),
                           (quant.int4_matmul_smallm, 4))
          for m in (40, 256, 1000)))
for label, fn, bits, m, shapes in runs:
    per = {}
    for p, (k, n) in shapes.items():
        w, s = weights8(g, k, n) if bits == 8 else weights(g, k, n)
        ws, rep = copies_of(w, s)
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        per[p] = round(graph_ms([lambda w=w, s=s: fn(x, w, s) for w, s in ws] * rep), 5)
        del ws, w, s
    out[label] = {"layer_ms": round(sum(v for p, v in per.items() if p != "lm_head"), 5), **per}
print(json.dumps(out), flush=True)
'''


WGMMA_BENCH = INT8_MS + f"""
import json, sys
from affectgpt_tpu_torch.ops import quant
SPLIT = {SPLIT!r}
""" + r'''
g = torch.Generator(device="cuda").manual_seed(0)
out = {"variant": sys.argv[2]}
for fn, bits in ((quant.int8_matmul, 8), (quant.int4_matmul, 4)):
    for m in (40, 256, 1000):
        layer = 0.0
        for p, (k, n) in SPLIT.items():
            ws, rep = copies_of(*(weights8(g, k, n) if bits == 8 else weights(g, k, n)))
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            layer += graph_ms([lambda w=w, s=s: fn(x, w, s) for w, s in ws] * rep)
            del ws
        out[f"{fn.__name__}_M{m}_layer_ms"] = round(layer, 5)
print(json.dumps(out), flush=True)
'''


def wgmma_sweep() -> None:
    """quant_wgmma.cuh through its C entries at every K split the card
    holds (and int4 also at 64-row batch blocks), beside the plan's choice:
    int8_matmul and int4_matmul on the 7B q/k/gate/down_proj at M = 40, 256
    and 1000."""
    sys.path.insert(0, str(REPO))
    import torch
    from affectgpt_tpu_torch.ops import _build, quant
    ns = {}
    exec(INT8_MS, ns)
    graph_ms, weights8, weights, copies_of = (ns[k] for k in ("graph_ms", "weights8", "weights",
                                                              "copies_of"))
    lib = _build.load_library()
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, mode, bits in (("int8_matmul", quant.MODE_INT8, 8),
                             ("int4_matmul", quant.MODE_INT4, 4)):
        entry = getattr(lib, quant._WGMMA_ENTRY[mode])
        for p in ("q", "k", "gate", "down"):
            k, n = SPLIT[p]
            ws, rep = copies_of(*(weights8(g, k, n) if bits == 8 else weights(g, k, n)))
            for m in (40, 256, 1000):
                x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
                y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                plan = quant._wgmma_plan_on(0, m, n, k, mode)
                times = {}
                for nb in sorted({plan["nb"], *((64,) if bits == 4 and m > 64 else ())}):
                    cb = -(-m // nb)
                    stages = min(quant.WGMMA_MAX_STAGES, (quant.SMEM_LIMIT - 1024)
                                 // (quant.wgmma_stage_bytes(mode, nb) + 16))
                    for ck in range(1, min(8, plan["units"]) + 1):
                        if quant._wgmma_active_clusters(0, mode, nb, stages, ck) < 1:
                            continue

                        def call(w, s, nb=nb, cb=cb, ck=ck, stages=stages):
                            status = entry(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(),
                                           m, n, k, nb, cb, ck, stages,
                                           torch.cuda.current_stream().cuda_stream)
                            assert status == 0, status
                        times[f"nb{nb}_ck{ck}"] = round(graph_ms(
                            [lambda w=w, s=s: call(w, s) for w, s in ws] * rep), 5)
                print(name, p, f"M={m}", "plan", f"nb{plan['nb']}_ck{plan['cluster']}", times,
                      flush=True)
            del ws


def w8a8_sweep() -> None:
    """The w8a8 mode (agk_w8a8_swapab) at every cluster size and block
    width beside the plan's choice: q/k/gate/down_proj at M = 8 and 16."""
    sys.path.insert(0, str(REPO))
    import torch
    from affectgpt_tpu_torch.ops import _build, quant
    ns = {}
    exec(INT8_MS, ns)
    graph_ms, weights8, copies_of = (ns[k] for k in ("graph_ms", "weights8", "copies_of"))
    lib = _build.load_library()
    g = torch.Generator(device="cuda").manual_seed(0)
    for p in ("q", "k", "gate", "down"):
        k, n = SPLIT[p]
        ws, rep = copies_of(*weights8(g, k, n))
        for m in (8, 16):
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            plan = quant._w8a8_swapab_plan_on(0, m, n, k)
            times = {}
            for bn in (128, 64):
                for c in range(1, min(8, plan["units"]) + 1):
                    if quant._w8a8_active_clusters(0, c, m, bn) < 1:
                        continue

                    def call(w, s, bn=bn, c=c):
                        status = lib.agk_w8a8_swapab(x.data_ptr(), w.data_ptr(), s.data_ptr(),
                                                     y.data_ptr(), m, n, k, bn, c,
                                                     torch.cuda.current_stream().cuda_stream)
                        assert status == 0, status
                    times[f"bn{bn}_c{c}"] = round(graph_ms(
                        [lambda w=w, s=s: call(w, s) for w, s in ws] * rep), 5)
            print("int8_matmul_w8a8", p, f"M={m}", "plan",
                  f"bn{plan['block_n']}_c{plan['cluster']}", times, flush=True)
        del ws


def wgmma_builds(names: list) -> None:
    tmp = Path(tempfile.mkdtemp())
    for name in names or WGMMA_VARIANTS:
        run_variant(name, "wgmma_builds", WGMMA_VARIANTS[name], tmp, bench=WGMMA_BENCH)


def time_packages(dirs: list) -> None:
    """TIME_BENCH for this tree's package and each DIR's, A B B A (with
    --w8a8 first: int8_matmul_w8a8 alone)."""
    only = "w8a8" if dirs[:1] == ["--w8a8"] else "all"
    roots = [("this tree", REPO)] + [(d, Path(d).resolve()) for d in dirs if d != "--w8a8"]
    for label, root in roots + roots[::-1]:
        env = {**os.environ, "PYTHONPATH": str(root)}
        proc = subprocess.run([sys.executable, "-c", TIME_BENCH, label, only], env=env, cwd=root,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(json.dumps({"package": label, "error": proc.stderr[-3000:]}), flush=True)
        else:
            print(proc.stdout.strip().splitlines()[-1], flush=True)


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    if mode not in ("check", "time", "builds", "wgmma", "sweep"):
        raise SystemExit(f"unknown mode {mode!r}: check, time, builds, wgmma or sweep")
    card()
    if mode == "builds":
        builds(sys.argv[2:])
    elif mode == "wgmma":
        wgmma_builds(sys.argv[2:])
    elif mode == "sweep":
        wgmma_sweep()
        w8a8_sweep()
    elif mode == "time":
        time_packages(sys.argv[2:])
    else:
        check()


if __name__ == "__main__":
    main()
