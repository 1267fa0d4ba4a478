"""Probes of the swap-AB int4 decode kernel (csrc/quant_swapab.cu, its int4 modes) on one card.

    python3 scripts/torch_int4_probe.py check    # correctness, per-layer times, cluster sweep
    python3 scripts/torch_int4_probe.py builds [NAME ...]  # edited copies, every cluster size
    python3 scripts/torch_int4_probe.py stamps   # %globaltimer stamps of each block, one launch
    python3 scripts/torch_int4_probe.py sass     # SASS op counts, as built and without stores

`check`: both int4 wrappers against their plain versions at M = 1, 3, 8, 13,
15 and 16 on the tiny test shapes and every Qwen2.5-7B (K, N) with the
lm_head (two calls must give the same bits); the occupancy the plan reads;
device ms of each 7B product and the layer (CUDA graph over enough weight
copies to exceed the 50 MB L2) for `int4_matmul_smallm` at M = 8 and
`int4_matmul` at M = 16; then q/k/gate/down_proj and the lm_head at every
cluster size, launched through the C entry. (`scripts/torch_int8_probe.py
time DIR` times both beside another checkout's package.) `builds`: the package copied to a temporary
directory with a few source lines edited (VARIANTS), built, and gate/down/
q_proj timed at clusters of 1, 2, 4 and 8 at both M. `stamps`: a copy that
records `%globaltimer` at each block's start, first stage and K loop end,
launched once per product (weights in L2), then
summarised by cluster and by the number of blocks on the SM. `sass`: op
counts of each kernel as built and with the cluster-of-one stores replaced
by nothing (ptxas then deletes the work that fed them). Prints the card's
name and power limit first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

from torch_wgmma_variants import REPO, copy_package, run_variant

INT4 = "affectgpt_tpu_torch/csrc/quant_swapab.cu"
HOP = "affectgpt_tpu_torch/csrc/hopper.cuh"
LAYER = {"q": (3584, 3584), "k": (3584, 512), "v": (3584, 512), "o": (3584, 3584),
         "gate": (3584, 18944), "up": (3584, 18944), "down": (18944, 3584),
         "lm_head": (3584, 152064)}
_PROMO = ("CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);\n"
          "  if (res != CUDA_SUCCESS) return (int)res;\n  Entry& e = cache[next];\n  e = Entry")
_NO_X = [(INT4, "mbar_expect_tx(&full[pos.stage], L::kStage);",
          "mbar_expect_tx(&full[pos.stage], L::kStage - L::kXTile);"),
         (INT4, "for (int box = 0; box < 4; ++box)  // (half", "for (int box = 0; box < 0; ++box)  // (half")]
_ROUND_STORE = "  if (csize == 1) {  // the whole K: round and store"
# name: [(file, old text, new text)]
VARIANTS = {
    "as_is": [],
    "loads_only": [(INT4, "kConsume = true;", "kConsume = false;")],
    "no_convert": [(INT4, "kConvert = true;", "kConvert = false;")],
    "no_products": [(INT4, "kProducts = true;", "kProducts = false;")],
    # without the x boxes (their bytes off the barrier)
    "no_x": _NO_X,
    # 128-byte or no L2 promotion of every tensor map (256-byte as built)
    "promo128": [(HOP, _PROMO, _PROMO.replace("L2_256B", "L2_128B"))],
    "promo_none": [(HOP, _PROMO, _PROMO.replace("PROMOTION_L2_256B", "PROMOTION_NONE"))],
    # int4_matmul_smallm without its per-weight scaling
    "no_scale": [(INT4, "    if constexpr (DEQUANT) {\n      a[0] = scale_bf16x2",
                  "    if constexpr (false) {\n      a[0] = scale_bf16x2")],
}

GRAPH_MS = r'''
import statistics, torch
def graph_ms(calls, reps=20):
    side = torch.cuda.Stream(); side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls: fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls: fn()
    graph.replay(); ev = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); graph.replay(); b.record(); ev.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev) / len(calls)

def weights(g, k, n):
    w = torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda", dtype=torch.int8)
    s = (torch.rand((k // 128, n), generator=g, device="cuda") + 0.5) * (3 * k ** -0.5 / 7)
    return w, s

def copies_of(w, s):  # enough copies that a replay cycle reads past the L2
    copies = max(1, -(-64 * 2**20 // (w.numel() + 4 * s.numel())))
    return [(w, s)] + [(w.clone(), s.clone()) for _ in range(copies - 1)], max(1, -(-8 // copies))

def entry_ms(lib, x, ws, rep, m, n, k, cluster, dequant):
    y = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    def call(w, s):
        status = lib.agk_quant_swapab(x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), m, n,
                                      k, cluster, int(dequant),
                                      torch.cuda.current_stream().cuda_stream)
        assert status == 0, status
    return graph_ms([lambda w=w, s=s: call(w, s) for w, s in ws] * rep)
'''


def card() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)


def check() -> None:
    sys.path.insert(0, str(REPO))
    import torch
    from affectgpt_tpu_torch.ops import _build, quant
    ns = {}
    exec(GRAPH_MS, ns)
    graph_ms, weights, copies_of, entry_ms = (ns[k] for k in ("graph_ms", "weights", "copies_of",
                                                               "entry_ms"))
    lib = _build.load_library()
    for dq in (False, True):
        for m in (8, 16):
            print("active clusters", "dequant" if dq else "int4", f"M={m}",
                  [quant._swapab_active_clusters(0, c, m, int(dq)) for c in range(1, 9)],
                  flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    bad = 0
    for k, n in [(256, 128), (512, 272), (1024, 256), *sorted(set(LAYER.values()))]:
        w, s = weights(g, k, n)
        for m in (1, 3, 8, 13, 15, 16):
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            for name in ("int4_matmul", "int4_matmul_smallm"):
                got = getattr(quant, name)(x, w, s)
                ref = getattr(quant, name + "_reference")(x, w, s).float()
                ok = bool(((got.float() - ref).abs() <= 1e-2 + 1.6e-2 * ref.abs()).all())
                same = torch.equal(got, getattr(quant, name)(x, w, s))
                bad += not (ok and same)
                if m in (1, 16) or not (ok and same):
                    print(name, f"K={k} N={n} M={m}", "max_abs_err",
                          round(float((got.float() - ref).abs().max()), 5), "ok", ok, "same", same,
                          flush=True)
    print("failed checks", bad, flush=True)
    for name, m in (("int4_matmul_smallm", 8), ("int4_matmul", 16)):
        dq = name.endswith("smallm")
        total = {"ms": 0.0}
        for p, (k, n) in LAYER.items():
            w, s = weights(g, k, n)
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            ws, rep = copies_of(w, s)
            t = {"ms": graph_ms([lambda w=w, s=s: getattr(quant, name)(x, w, s)
                                 for w, s in ws] * rep)}
            plan = quant._swapab_plan_on(0, m, n, k, int(dq))
            nbytes = w.numel() + 4 * s.numel() + 2 * m * (k + n)
            print(name, f"M={m}", p, {key: round(v, 5) for key, v in t.items()},
                  "bound_ms", round(nbytes / 3.35e9, 5), "GB/s", round(nbytes / t["ms"] / 1e6, 1),
                  "cluster", plan["cluster"], "grid", plan["grid"][0], flush=True)
            if p != "lm_head":
                for key in total:
                    total[key] += t[key]
            if p in ("q", "k", "gate", "down", "lm_head"):
                sweep = {c: round(entry_ms(lib, x, ws, rep, m, n, k, c, dq), 5)
                         for c in range(1, min(8, k // 256) + 1)}
                print("  cluster sweep", sweep, flush=True)
            del ws
        print(name, f"M={m}", "layer", {key: round(v, 5) for key, v in total.items()}, flush=True)


BUILD_BENCH = GRAPH_MS + r'''
import json, sys
from affectgpt_tpu_torch.ops import _build
lib = _build.load_library()
g = torch.Generator(device="cuda").manual_seed(0)
out = {"variant": sys.argv[2]}
for p, (k, n) in {"gate": (3584, 18944), "down": (18944, 3584), "q": (3584, 3584)}.items():
    ws, rep = copies_of(*weights(g, k, n))
    for m, dq in ((8, True), (16, False)):
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        for c in (1, 2, 4, 8):
            out[f"{p}_M{m}_C{c}_us"] = round(entry_ms(lib, x, ws, rep, m, n, k, c, dq) * 1000, 2)
    del ws
print(json.dumps(out), flush=True)
'''


def builds(names: list) -> None:
    tmp = Path(tempfile.mkdtemp())
    for name in names or VARIANTS:
        run_variant(name, "int4_builds", VARIANTS[name], tmp, bench=BUILD_BENCH)


_STAMP_EDITS = [
    (INT4, "namespace agk {\nnamespace sab {",
     "__device__ unsigned long long g_stamps[8192][8];\n"
     "__device__ __forceinline__ unsigned long long now_ns() { unsigned long long v; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v)); return v; }\n"
     "__device__ __forceinline__ unsigned smid() { unsigned v; "
     "asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(v)); return v; }\n"
     "namespace agk {\nnamespace sab {"),
    (INT4, "  __syncthreads();\n\n  if (warp == kConsumers) {",
     "  __syncthreads();\n  const bool rec = threadIdx.x == 0 && blockIdx.x < 8192;\n"
     "  if (rec) { g_stamps[blockIdx.x][0] = now_ns(); g_stamps[blockIdx.x][7] = smid(); }\n"
     "  bool first = true;\n\n  if (warp == kConsumers) {"),
    (INT4, "    mbar_wait(&full[pos.stage], pos.phase);\n    if constexpr (!kConsume)",
     "    mbar_wait(&full[pos.stage], pos.phase);\n"
     "    if (rec && first) { g_stamps[blockIdx.x][1] = now_ns(); first = false; }\n"
     "    if constexpr (!kConsume)"),
    (INT4, "  float d[NT][4];  // the two chains' sum",
     "  if (rec) g_stamps[blockIdx.x][2] = now_ns();\n"
     "  float d[NT][4];  // the two chains' sum"),
]


def stamps() -> None:
    root = copy_package("stamps", _STAMP_EDITS, Path(tempfile.mkdtemp()))
    cu = root / INT4
    cu.write_text(cu.read_text() + '\nextern "C" int agk_int4_stamps(void* dst) '
                  '{ return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)); }\n')
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from affectgpt_tpu_torch.ops import _build, quant
    lib = _build.load_library()
    lib.agk_int4_stamps.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(0)
    for p, (k, n) in LAYER.items():
        if p in ("v", "o", "up"):
            continue
        w = torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda", dtype=torch.int8)
        s = torch.rand((k // 128, n), generator=g, device="cuda") * 1e-2
        x = torch.randn((8, k), generator=g, device="cuda").to(torch.bfloat16)
        for _ in range(3):
            quant.int4_matmul_smallm(x, w, s)
        torch.cuda.synchronize()
        plan = quant._swapab_plan_on(0, 8, n, k, quant.MODE_INT4_DEQUANT)
        raw = np.zeros((8192, 8), np.uint64)
        lib.agk_int4_stamps(raw.ctypes.data)
        st = raw[:plan["grid"][0]].astype(np.int64)
        rel = (st[:, :6] - st[:, 0].min()) / 1000.0  # µs from the first block's start
        c = plan["cluster"]
        per_sm = np.bincount(st[:, 7])[st[:, 7]]
        print(f"{p}: cluster {c}, {len(rel)} blocks on {len(set(st[:, 7].tolist()))} SMs; "
              f"first stage µs {np.round(np.percentile(rel[:, 1], [0, 50, 100]), 3).tolist()}")
        for held in sorted(set(per_sm.tolist())):
            print(f"  blocks on SMs holding {held}: K loop end µs (min/median/max) "
                  f"{np.round(np.percentile(rel[per_sm == held, 2], [0, 50, 100]), 3).tolist()}")
        if c > 1:
            cl = rel.reshape(-1, c, 6)
            print("  spread of a cluster's K loop ends µs (median/max)",
                  np.round(np.percentile(cl[:, :, 2].max(1) - cl[:, :, 2].min(1), [50, 100]), 3)
                  .tolist(), flush=True)

def sass() -> None:
    from collections import Counter
    import re
    sys.path.insert(0, str(REPO))
    from affectgpt_tpu_torch.ops import _build
    tmp = Path(tempfile.mkdtemp())
    nvcc = _build.find_nvcc()
    no_store = [(INT4, _ROUND_STORE, _ROUND_STORE + "\n    return;")]
    for name, edits in (("as_is", []), ("no_store", no_store)):
        root = copy_package(name, edits, tmp)
        cubin = tmp / f"{name}.cubin"
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin", "-o", str(cubin), str(root / INT4)],
                       check=True, capture_output=True)
        text = subprocess.run(["cuobjdump", "-sass", str(cubin)], capture_output=True, text=True,
                              check=True).stdout
        counts, kernel = {}, None
        for line in text.splitlines():
            found = re.search(r"Function : (\S+)", line)
            if found:
                kernel = found.group(1)
                counts[kernel] = Counter()
                continue
            op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
            if op and kernel:
                counts[kernel][op.group(1).split(".")[0]] += 1
        for kernel, ops in counts.items():
            top = ", ".join(f"{op} {n}" for op, n in ops.most_common(12))
            print(name, kernel[-48:], "total", sum(ops.values()), "HMMA", ops["HMMA"], "LDSM",
                  ops["LDSM"], "|", top, flush=True)


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    if mode not in ("check", "builds", "stamps", "sass"):
        raise SystemExit(f"unknown mode {mode!r}: check, builds, stamps or sass")
    card()
    if mode == "builds":
        builds(sys.argv[2:])
    else:
        {"check": check, "stamps": stamps, "sass": sass}[mode]()


if __name__ == "__main__":
    main()
