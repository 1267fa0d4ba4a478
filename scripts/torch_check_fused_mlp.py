"""How far the port's one-call encoder MLP kernel is from its plain version,
on one CUDA card.

    python3 scripts/torch_check_fused_mlp.py

Runs `ops/vit_mlp_fused.mlp_sublayer_fused` (csrc/vit_mlp_fused.cu) and its
plain version on random bf16 inputs (x ~ N(0, 1), weights at the towers'
0.02 scale, a seed) at CLIP ViT-L/14's shape (64 images of 257 tokens,
w = 1024, I = 4096, 8 chunks) and at smaller rows, widths and chunk counts,
with both accumulations, and the two-call pair (`ops/vit_mlp.mlp_sublayer`)
beside it. For each it prints the largest and mean absolute difference and
how many outputs lie outside chip_smoke.py's phase-3 tolerance (rtol 1.6e-2,
atol 1e-2), with the first few of them. With the bf16 accumulator, a
per-chunk rounding that parts on the two sides keeps its one-ulp difference
of the running sum, which later chunks may bring far below it: this shows
how often that happens. Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from affectgpt_tpu_torch.ops import vit_mlp, vit_mlp_fused  # noqa: E402

RTOL, ATOL = 1.6e-2, 1e-2
# (w, I, k_chunks, images, tokens)
CASES = [(1024, 4096, 8, 64, 257), (1024, 4096, 8, 1, 32), (384, 1536, 3, 3, 99),
         (1024, 4096, 4, 2, 40), (1024, 4096, 16, 2, 40), (256, 1024, 2, 2, 40),
         (512, 2048, 4, 2, 40)]


def report(tag: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    out = diff > ATOL + RTOL * ref.abs()
    first = torch.nonzero(out)[:3].tolist()
    print(tag, f"max_abs={float(diff.max()):.6g}", f"mean_abs={float(diff.mean()):.6g}",
          f"outside={int(out.sum())}/{diff.numel()}",
          "first=" + str([(i, float(got[tuple(i)]), float(ref[tuple(i)])) for i in first]),
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_check_fused_mlp: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain products in full f32
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(torch.bfloat16)

    for w, inter, k_chunks, b, n in CASES:
        x = rnd(b, n, w)
        params = (rnd(w, scale=0.1, shift=1.0), rnd(w, scale=0.1), rnd(w, inter, scale=0.02),
                  rnd(inter, scale=0.1), rnd(inter, w, scale=0.02), rnd(w, scale=0.1))
        kc = inter // vit_mlp_fused.chunks_for(inter, k_chunks)
        for acc in ("bf16", "f32"):
            got = vit_mlp_fused.mlp_sublayer_fused(x, *params, k_chunks=k_chunks, acc=acc)
            ref = vit_mlp_fused.mlp_sublayer_fused_reference(x, *params, k_chunks=k_chunks,
                                                             acc=acc)
            report(f"fused w={w} I={inter} kc={kc} b={b} n={n} acc={acc}", got, ref)
        report(f"pair  w={w} I={inter} b={b} n={n}", vit_mlp.mlp_sublayer(x, *params),
               vit_mlp.mlp_sublayer_reference(x, *params))


if __name__ == "__main__":
    main()
