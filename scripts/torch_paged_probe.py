"""Probes of the paged decode attention kernel (csrc/paged_attention.cu) on one CUDA card.

    python3 scripts/torch_paged_probe.py check               # correctness, plans
    python3 scripts/torch_paged_probe.py time [DIR ...]      # this tree's package beside each DIR's
    python3 scripts/torch_paged_probe.py builds [NAME ...]   # edited copies of the kernel
    python3 scripts/torch_paged_probe.py stamps              # %globaltimer stamps of each block

`check`: both wrappers against `paged_attention_reference` on the test
shapes (kv, g, d) = (2, 3, 64) and (4, 7, 128), pages of 16 and 8 tokens
and odd pages (12, 24, 4, 1, 20),
rows of 0 and 1 tokens, of exactly one page, ending mid-page and filling
the table, and at the serve phase's shape (below) at widths 38 and 64; two
calls must give the same bits; one launch a call. `time`: device ms at the
serve phase's shape, chip_smoke.py's `paged_case`: 16 rows of Qwen2.5-7B
heads (28 query, 4 kv, d = 128), one of 1 token, one of 16, the rest 545-596,
pools of 2048 pages of 16 tokens, bf16 and int8, tables of width 38 and 64;
six calls over two pools and three table sets (more than the 50 MB L2) in a
CUDA graph, 20 replays, the median; with this tree's package also every
split count of 1-8. A DIR is the root of another checkout (the parent
commit unpacked into a directory that .gitignore lists): its package is
timed the same way in its own process, for a comparison inside one call,
the packages in the order A B B A (the split sweep only in the first run).
`builds`: copies of this tree's package with the consumers' work or the
products or the cluster's merge switched off, or eight consumer warps
(VARIANTS). `stamps`: a copy that records `%globaltimer` in each block at
its start, after the first barrier, when warp 0's first tile has arrived,
at the end of warp 0's tiles, after the warps' merge, after the cluster's
first barrier and before its last, and when the producer has issued its
last tile; one launch of each pool type at the serve shape (width 38)
after the six calls of a replay cycle, summarised as µs from the first
block's start., timed the same way. Prints the card's name
and power limit first, then one JSON line per package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

from torch_int4_probe import card
from torch_wgmma_variants import REPO, copy_package

PAGED = "affectgpt_tpu_torch/csrc/paged_attention.cu"
VARIANTS = {
    "as_is": [],
    # the consumers take each stage and hand it back untouched: the ring alone
    "loads_only": [(PAGED, "kConsume = true;", "kConsume = false;")],
    # eight consumer warps a block instead of four
    "consumers8": [(PAGED, "constexpr int kConsumers = 4;", "constexpr int kConsumers = 8;"),
                   ("affectgpt_tpu_torch/ops/paged_attention.py",
                    "TILE, CONSUMERS, MAX_SPLITS, MAX_GROUPS = 16, 4, 8, 8",
                    "TILE, CONSUMERS, MAX_SPLITS, MAX_GROUPS = 16, 8, 8, 8")],
    # a ring of up to twelve stages: a block's whole share (9-10 tiles at the
    # serve shape) in flight at once
    "stages12": [("affectgpt_tpu_torch/ops/paged_attention.py", "MAX_STAGES = 8",
                  "MAX_STAGES = 12")],
    # no cluster barrier and no remote reads: each block merges only its own state
    "no_cluster_merge": [(PAGED, "kClusterMerge = true;", "kClusterMerge = false;")],
    # the fragments built and XORed into the output instead of multiplied
    "no_products": [(PAGED, "kProducts = true;", "kProducts = false;")],
}

BENCH = r'''
import json, statistics, sys
import torch
from affectgpt_tpu_torch.ops import paged_attention as pa

label, sweep = sys.argv[1], sys.argv[2] == "1"
SLOTS, PAGE, BLOCKS, KV, D, HEADS = 16, 16, 2048, 4, 128, 28

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

def paged_case(g, width, int8):  # chip_smoke.py's paged_case
    shape = (BLOCKS, PAGE, KV, D)
    lens = torch.randint(545, 597, (SLOTS,), generator=g, device="cuda")
    lens[0], lens[1] = 1, PAGE
    lens = lens.clamp(max=width * PAGE).to(torch.int32)
    q = torch.randn((SLOTS, HEADS, D), generator=g, device="cuda").to(torch.bfloat16)
    pages = [-(-int(n) // PAGE) for n in lens]
    cases = []
    for _ in range(2):
        if int8:
            pk, pv = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                    dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(shape[:3], generator=g, device="cuda") * (4.0 / 127)
                           for _ in range(2))
        else:
            pk, pv = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            scales = ()
        perm = (torch.randperm(BLOCKS - 1, generator=g, device="cuda") + 1).tolist()
        for t in range(3):
            tables = torch.zeros((SLOTS, width), dtype=torch.int32)
            used = t * sum(pages)
            for r, n in enumerate(pages):
                tables[r, :n] = torch.tensor(perm[used:used + n], dtype=torch.int32)
                used += n
            cases.append((q, pk, pv, tables.to(q.device), lens, scales))
    return cases, int(lens.sum())

g = torch.Generator(device="cuda").manual_seed(17)
out = {"package": label}
for int8 in (False, True):
    tag = "int8" if int8 else "bf16"
    kernel = pa.paged_attention_int8 if int8 else pa.paged_attention
    entry = "agk_paged_attention_int8" if int8 else "agk_paged_attention_bf16"
    for width in (38, 64):
        cases, valid = paged_case(g, width, int8)
        c = cases[0]
        err = (kernel(*c[:5], *c[5]).float()
               - pa.paged_attention_reference(*c[:5], *c[5]).float()).abs().max()
        nbytes = (valid * KV * D * 2 * (1 if int8 else 2) + (valid * KV * 8 if int8 else 0)
                  + 4 * SLOTS * HEADS * D + 4 * SLOTS * (width + 1))
        ms = graph_ms([lambda c=c: kernel(*c[:5], *c[5]) for c in cases] * 4)
        out[f"{tag}_w{width}"] = {"ms": round(ms, 5), "max_abs_err": round(float(err), 5),
                                  "bound_ms": round(nbytes / 3.35e9, 5),
                                  "GB_per_s": round(nbytes / ms / 1e6, 1)}
        if sweep and hasattr(pa, "paged_plan"):
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out[f"{tag}_w{width}"]["plan"] = {k: v for k, v in pa.paged_plan(
                SLOTS, KV, HEADS // KV, D, PAGE, width, int8, sms).items() if k != "grid"}
            lib = pa._build.load_library()
            y = torch.empty_like(cases[0][0])

            def entry_call(c, splits):  # the C entry at a given split count
                plan = pa.paged_plan(SLOTS, KV, HEADS // KV, D, PAGE, width, int8, sms, splits)
                status = getattr(lib, entry)(
                    c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(),
                    *(s.data_ptr() for s in c[5]), c[3].data_ptr(), c[4].data_ptr(),
                    y.data_ptr(), SLOTS, KV, HEADS // KV, width, PAGE, D, BLOCKS, splits,
                    plan["stages"], torch.cuda.current_stream().cuda_stream)
                assert status == 0, status

            out[f"{tag}_w{width}"]["splits_ms"] = {
                s: round(graph_ms([lambda c=c: entry_call(c, s) for c in cases] * 4), 5)
                for s in range(1, 9)}
        del cases
print(json.dumps(out), flush=True)
'''


_STAMP = "if (rec) g_st[blockIdx.x][{}] = now_ns();"
_STAMP_EDITS = [
    (PAGED, "namespace agk {\nnamespace paged {",
     "__device__ unsigned long long g_st[4096][10];\n"
     "__device__ __forceinline__ unsigned long long now_ns() { unsigned long long v; "
     "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v)); return v; }\n"
     "namespace agk {\nnamespace paged {"),
    (PAGED, "  const int row = pair / kv, head = pair % kv;\n",
     "  const int row = pair / kv, head = pair % kv;\n"
     "  const bool rec = threadIdx.x == 0 && blockIdx.x < 4096;\n  " + _STAMP.format(0) + "\n"),
    (PAGED, "  __syncthreads();\n\n  if (warp == kConsumers) {  // producer",
     "  __syncthreads();\n  " + _STAMP.format(1) + "\n\n  if (warp == kConsumers) {  // producer"),
    (PAGED, "      pos.advance(stages);\n    }\n    return;\n  }",
     "      pos.advance(stages);\n    }\n    if (lane == 0 && blockIdx.x < 4096) "
     "g_st[blockIdx.x][8] = now_ns();\n    return;\n  }"),
    (PAGED, "    mbar_wait(&full[slot], (uint32_t)((s / stages) & 1));\n",
     "    mbar_wait(&full[slot], (uint32_t)((s / stages) & 1));\n    if (s == 0) "
     + _STAMP.format(2) + "\n"),
    (PAGED, "  if constexpr (!kProducts) sink_into(acc[0][0], sink);",
     "  " + _STAMP.format(3) + "\n  if constexpr (!kProducts) sink_into(acc[0][0], sink);"),
    (PAGED, "splits, orow);\n  if (splits > 1)",
     "splits, orow);\n  " + _STAMP.format(4) + "\n  if (splits > 1)"),
    (PAGED, "rank, orow);\n}", "rank, orow);\n  " + _STAMP.format(5) + "\n}"),
]
_STAMP_NAMES = ["after the first barrier", "warp 0's first tile arrived", "warp 0's tiles done",
                "the warps' merge done", "the cluster's merge done"]


def stamps() -> None:
    root = copy_package("stamps", _STAMP_EDITS, Path(tempfile.mkdtemp()))
    cu = root / PAGED
    cu.write_text(cu.read_text() + '\nextern "C" int agk_paged_stamps(void* dst) '
                  '{ return (int)cudaMemcpyFromSymbol(dst, g_st, sizeof(g_st)); }\n')
    sys.path.insert(0, str(root))
    import ctypes
    import numpy as np
    import torch
    from affectgpt_tpu_torch.ops import _build
    from affectgpt_tpu_torch.ops import paged_attention as pa
    lib = _build.load_library()
    lib.agk_paged_stamps.argtypes = [ctypes.c_void_p]
    ns = {}
    exec(BENCH.split("g = torch.Generator")[0].replace("label, sweep = sys.argv[1], "
                                                       "sys.argv[2] == \"1\"", ""), ns)
    g = torch.Generator(device="cuda").manual_seed(17)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for int8 in (False, True):
        kernel = pa.paged_attention_int8 if int8 else pa.paged_attention
        cases, _ = ns["paged_case"](g, 38, int8)
        for c in cases[1:] + cases[:1]:  # the cycle, case 0 last
            kernel(*c[:5], *c[5])
        torch.cuda.synchronize()
        plan = pa.paged_plan(16, 4, 7, 128, 16, 38, int8, sms)
        raw = np.zeros((4096, 10), np.uint64)
        lib.agk_paged_stamps(raw.ctypes.data)
        st = raw[:plan["grid"][0]].astype(np.int64)
        t0 = st[:, 0].min()
        rel = (st - t0) / 1000.0
        live = st[:, 2] > 0  # blocks whose warp 0 had a tile
        print("int8" if int8 else "bf16", f"splits {plan['splits']}, {len(st)} blocks; µs from "
              "the first block's start (min / median / max):", flush=True)
        print("  block start", np.round(np.percentile(rel[:, 0], [0, 50, 100]), 3).tolist())
        for i, name in enumerate(_STAMP_NAMES, start=1):
            sel = live if i in (2, 3) else np.ones(len(st), bool)
            print(f"  {name}", np.round(np.percentile(rel[sel, i], [0, 50, 100]), 3).tolist())
        print("  producer issued its last tile",
              np.round(np.percentile(rel[:, 8], [0, 50, 100]), 3).tolist(), flush=True)
        del cases


def run_bench(label: str, root: Path, sweep: bool) -> None:
    """BENCH in its own process on the package under `root`."""
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", BENCH, label, "1" if sweep else "0"], env=env,
                          cwd=root, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(json.dumps({"package": label, "error": proc.stderr[-3000:]}), flush=True)
    else:
        print(proc.stdout.strip().splitlines()[-1], flush=True)


def check() -> None:
    sys.path.insert(0, str(REPO))
    import torch
    from affectgpt_tpu_torch.ops import paged_attention as pa
    g = torch.Generator(device="cuda").manual_seed(0)
    gc = torch.Generator().manual_seed(0)  # the lengths and tables, made on the host
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    bad = 0
    for int8 in (False, True):
        kernel = pa.paged_attention_int8 if int8 else pa.paged_attention
        for kv, grp, d, blk, width, b, blocks in [
                (2, 3, 64, 16, 5, 7, 64), (4, 7, 128, 16, 5, 7, 64), (2, 3, 64, 8, 8, 7, 64),
                (4, 7, 128, 8, 8, 3, 64), (4, 7, 128, 16, 38, 16, 2048),
                (4, 7, 128, 16, 64, 16, 2048), (1, 8, 128, 16, 40, 5, 256),
                (2, 3, 64, 12, 10, 7, 128), (4, 7, 128, 24, 6, 7, 128), (4, 7, 128, 4, 30, 7, 256),
                (2, 3, 64, 1, 64, 5, 512), (4, 7, 128, 20, 8, 7, 128)]:
            shape = (blocks, blk, kv, d)
            if int8:
                pk, pv = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                        dtype=torch.int8) for _ in range(2))
                scales = tuple(torch.rand(shape[:3], generator=g, device="cuda") * 0.03
                               for _ in range(2))
            else:
                pk, pv, scales = rnd(*shape), rnd(*shape), ()
            lens = torch.randint(1, width * blk + 1, (b,), generator=gc)
            for r, n in enumerate((0, 1, blk, width * blk, blk + 3, 17)[:b]):
                lens[r] = n
            perm = torch.randperm(blocks - 1, generator=gc) + 1
            tables = torch.zeros((b, width), dtype=torch.int32)
            used = 0
            for r in range(b):
                n = -(-int(lens[r]) // blk)
                tables[r, :n] = perm[used:used + n].to(torch.int32)
                used += n
            args = (rnd(b, kv * grp, d), pk, pv, tables.cuda(), lens.to(torch.int32).cuda())
            before = kernel.launches
            got = kernel(*args, *scales)
            torch.cuda.synchronize()
            ref = pa.paged_attention_reference(*args, *scales).float()
            ok = bool(((got.float() - ref).abs() <= 1e-2 + 1.6e-2 * ref.abs()).all())
            same = torch.equal(got, kernel(*args, *scales))
            zero = bool((got[0] == 0).all())  # the row of no token
            one = kernel.launches == before + 2
            bad += not (ok and same and zero and one)
            plan = pa.paged_plan(b, kv, grp, d, blk, width, int8, sms)
            print("int8" if int8 else "bf16", f"kv={kv} g={grp} d={d} block={blk} width={width} "
                  f"b={b}", "max_abs_err", round(float((got.float() - ref).abs().max()), 5), "ok",
                  ok, "same", same, "empty_row_zero", zero, "one_launch", one, "splits",
                  plan["splits"], "stages", plan["stages"], "smem", plan["smem_bytes"], flush=True)
    print("failed checks", bad, flush=True)


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    if mode not in ("check", "time", "builds", "stamps"):
        raise SystemExit(f"unknown mode {mode!r}: check, time, builds or stamps")
    card()
    if mode == "check":
        check()
    elif mode == "stamps":
        stamps()
    elif mode == "time":
        roots = [("this tree", REPO)] + [(d, Path(d).resolve()) for d in sys.argv[2:]]
        for i, (label, root) in enumerate(roots + roots[::-1]):
            run_bench(label, root, i == 0)
    else:
        tmp = Path(tempfile.mkdtemp())
        for name in sys.argv[2:] or VARIANTS:
            run_bench(name, copy_package(name, VARIANTS[name], tmp), False)


if __name__ == "__main__":
    main()
