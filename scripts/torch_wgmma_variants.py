"""Time variants of the port's two wgmma kernels on one CUDA card.

    python3 scripts/torch_wgmma_variants.py [--only fused|w8a8] [--out DIR]

For each variant the package is copied to a temporary directory, a few
source constants are replaced there (the ring depth, the w8a8 row tile;
or, in the variants named `diag_*`, the tensor-core products are dropped,
which breaks the result and shows what the loads and barriers cost alone),
the kernels are built from the copy, and one process checks
the kernel against its plain version at a small shape and times it at the
main path's shapes: `mlp_sublayer_fused` (csrc/vit_mlp_fused.cu) at CLIP's
64 x 257 and HuBERT's 64 x 99 rows (w = 1024, I = 4096, bf16 accumulator),
`int8_matmul_w8a8` (csrc/int8_matmul_w8a8.cu) summed over one Qwen2.5-7B
decoder layer's products at M = 4512 and M = 8. Times are device ms per
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

# name: (kernel, [(file, old text, new text)])
VARIANTS = {
    "fused_as_is": ("fused", []),
    "fused_stages3": ("fused", [(FUSED, "constexpr int kStages = 4;",
                                 "constexpr int kStages = 3;")]),
    "diag_fused_no_products": ("fused", [(FUSED, "      wgmma_bf16_ss_tb(acc,",
                                          "      if (false) wgmma_bf16_ss_tb(acc,")]),
    "w8a8_as_is": ("w8a8", []),
    "w8a8_rows128": ("w8a8", [
        ("affectgpt_tpu_torch/ops/quant.py", "bm = 16 if m <= 16 else 192",
         "bm = 16 if m <= 16 else 128"),
        (W8A8, "if (bm != 16 && bm != 192)", "if (bm != 16 && bm != 128)"),
        (W8A8, ": launch<192>(", ": launch<128>(")]),
    "diag_w8a8_no_products": ("w8a8", [(W8A8, "        wgmma_s8_rs(acc_i,",
                                        "        if (false) wgmma_s8_rs(acc_i,")]),
}

BENCH = r"""
import json, statistics, sys
import torch
from affectgpt_tpu_torch.ops import quant, vit_mlp_fused

kind, name = sys.argv[1], sys.argv[2]
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

out = {"variant": name}
if kind == "fused":
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


def run_variant(name: str, kind: str, edits: list, tmp_root: Path) -> None:
    root = Path(tempfile.mkdtemp(dir=tmp_root))
    shutil.copytree(REPO / "affectgpt_tpu_torch", root / "affectgpt_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        path = root / rel
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"{name}: {old!r} not in {rel}")
        path.write_text(text.replace(old, new))
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run([sys.executable, "-c", BENCH, kind, name], env=env, cwd=root,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(json.dumps({"variant": name, "error": proc.stderr[-2000:]}), flush=True)
    else:
        print(proc.stdout.strip().splitlines()[-1], flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("fused", "w8a8"))
    ap.add_argument("--out", default=None, help="scratch directory (default: a temporary one)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    tmp_root = Path(args.out or tempfile.mkdtemp())
    tmp_root.mkdir(parents=True, exist_ok=True)
    for name, (kind, edits) in VARIANTS.items():
        if args.only in (None, kind):
            run_variant(name, kind, edits, tmp_root)


if __name__ == "__main__":
    main()
