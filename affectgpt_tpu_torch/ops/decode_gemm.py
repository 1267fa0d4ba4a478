"""Launch plans of the swap-AB wgmma kernel behind the bf16 decode
projections (csrc/decode_swapab.cuh): `decode_qkv` and `decode_mlp_bf16`.

A block owns one column tile (two 64-column TMA boxes of the weights, one a
consumer warpgroup, each the MN-major A operand of wgmma.m64nNBk16) and
NB batch rows (the K-major B operand). Up to b = 256 one block holds every
row (cb = 1); above it the rows are split over a pair of blocks in a
cluster (cb = 2) that multicast the weight boxes into each other, so a
weight byte is loaded by one block once a call at every b <= 512. Where the
column tiles are too few to cover the SMs, K is split over a cluster of ck
blocks whose f32 partial tiles meet in distributed shared memory, as far as
the card holds all of the split's clusters at once. The CUDA
kernel computes its tiles' columns and its K share as `tile_boxes` and
`block_loads` do here; the CPU tests hold these against the coverage rules
(tests/test_torch_decode_kernels.py).
"""

from __future__ import annotations

import functools

from affectgpt_tpu_torch.ops import _build

NB_WIDTHS = (8, 16, 32, 64, 128, 192, 256)  # the kernel's batch widths (wgmma N)
BK = 64  # k rows a stage
W_STAGE = 2 * 64 * BK * 2  # a stage's two weight boxes, bytes
PITCH = 128 + 4  # f32 a row of the staged output tile
SMEM_LIMIT = 232448  # a block's most dynamic shared memory (227 KB)
SMEM_TWO = 233472 // 2 - 1024  # each of two blocks an SM (228 KB, 1 KB reserved a block)
MAX_CLUSTER = 8  # the kernel's largest cluster
# the plans' largest: on the H100 clusters of 8 at two blocks an SM ran 5% slower
# than clusters of 7 though the card reports that all of them fit at once
PLAN_CLUSTER = 7
MAX_STAGES = 6
COVER = 0.8  # a product whose tiles cover this share of the SMs takes no K split

ROPE, BIAS, SILU_MUL, RESIDUAL = 0, 1, 2, 3  # the epilogues (csrc/decode_swapab.cuh Epi)


def smem_bytes(nb: int, stages: int) -> int:
    """Dynamic shared memory of a launch: the ring or, where larger, the f32
    output tile staged over it; the barriers; alignment slack."""
    ring = stages * (W_STAGE + 128 * nb)
    return max(ring, nb * PITCH * 4) + 16 * stages + 1024


def gemm_plan(b: int, k: int, tiles: int, sms: int, active_clusters=None) -> dict:
    """The launch of b rows against `tiles` column tiles of a [k, N] weight
    on a card of `sms` SMs: batch width nb and blocks cb per tile; K split
    ck; ring stages
    (as many as fit the blocks an SM: two at nb <= 64, else one); shared
    memory; grid. ck: 1 where the tiles cover COVER of the SMs, else the
    largest split (clusters of at most PLAN_CLUSTER blocks) whose clusters
    the card holds all at once: active_clusters(nb, cluster, stages) is how
    many clusters of that size it holds (None: as many as needed)."""
    if not 1 <= b <= 2 * NB_WIDTHS[-1]:
        raise ValueError(f"decode kernels take 1 <= b <= {2 * NB_WIDTHS[-1]} rows, got {b}")
    if k < 1 or tiles < 1:
        raise ValueError(f"empty product: k={k}, tiles={tiles}")
    cb = 1 if b <= NB_WIDTHS[-1] else 2
    nb = min(n for n in NB_WIDTHS if cb * n >= b)
    per_sm = 2 if nb <= 64 else 1
    limit = SMEM_TWO if per_sm == 2 else SMEM_LIMIT
    stages = max(s for s in range(2, MAX_STAGES + 1) if smem_bytes(nb, s) <= limit)
    units = -(-k // BK)
    ck = 1
    if tiles * cb < COVER * sms:
        ck = max((c for c in range(1, min(PLAN_CLUSTER // cb, units) + 1)
                  if active_clusters is None or tiles <= active_clusters(nb, cb * c, stages)),
                 default=1)
    return {"regime": "swapab" if cb == 1 else "swapab_pair", "wgmma": f"m64n{nb}k16",
            "nb": nb, "cb": cb, "ck": ck, "cluster": cb * ck, "stages": stages,
            "smem_bytes": smem_bytes(nb, stages), "tiles": tiles, "grid": tiles * cb * ck,
            "blocks_per_sm": per_sm, "units": units, "b": b, "k": k}


@functools.lru_cache(maxsize=None)
def active_clusters_on_card(nb: int, cluster: int, stages: int) -> int:
    """How many clusters of the swap-AB kernel (batch width nb, `cluster`
    blocks, `stages` ring stages) the current card holds at once, as the
    CUDA occupancy calculator reports it: the plans' `active_clusters`."""
    count = _build.load_library().agk_decode_swapab_active_clusters(nb, cluster, stages)
    if count < 0:
        raise RuntimeError(f"decode kernels: occupancy query failed (CUDA error {-count})")
    return count


def tile_boxes(segments) -> list:
    """Per column tile, in launch order: (segment index, (map0, c0), (map1,
    c1)), the two 64-column boxes it reads, as the kernel's `locate`
    computes them. segments: dicts with tiles, kind, map0, map1, head_dim."""
    out = []
    for i, s in enumerate(segments):
        for t in range(s["tiles"]):
            if s["kind"] == SILU_MUL:
                c0 = c1 = 64 * t
            elif s["kind"] == RESIDUAL:
                c0, c1 = 128 * t, 128 * t + 64
            else:
                per = s["head_dim"] // 128
                c0 = (t // per) * s["head_dim"] + 64 * (t % per)
                c1 = c0 + s["head_dim"] // 2
            out.append((i, (s["map0"], c0), (s["map1"], c1)))
    return out


def block_loads(plan: dict, segments) -> list:
    """Per block of the grid, in the kernel's rank order: (tile, kr, br,
    weight loads, rows), the loads as (map, first column, first k row, end
    k row) of the 64-column boxes that block issues (both with cb = 1, box
    br with cb = 2, multicast to its batch pair), rows the batch rows [br
    nb, br nb + nb) it computes."""
    boxes = tile_boxes(segments)
    cb, ck, nb, units = plan["cb"], plan["ck"], plan["nb"], plan["units"]
    out = []
    for tile, (_, box0, box1) in enumerate(boxes):
        for rank in range(cb * ck):
            kr, br = divmod(rank, cb)
            k0, k1 = kr * units // ck * BK, (kr + 1) * units // ck * BK
            mine = (box0, box1) if cb == 1 else ((box0, box1)[br],)
            out.append((tile, kr, br, [(m, c, k0, k1) for m, c in mine],
                        (br * nb, br * nb + nb)))
    return out
