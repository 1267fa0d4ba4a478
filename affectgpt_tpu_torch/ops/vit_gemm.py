"""Launch plans of the encoders' persistent bf16 GEMM on wgmma + TMA
(csrc/vit_gemm_wgmma.cuh), behind the MLP sublayer's two products
(ops/vit_mlp.py) and the attention sublayer's q/k/v and o products
(ops/vit_sublayer.py).

A block owns one 128 x 256 output tile at a time: 128 rows of a, 256
columns of one product's weight. Blocks are persistent, one per SM, in
clusters of two (where there are two row tiles or more) whose blocks take
neighbouring row tiles of one column tile and multicast each stage's weight
boxes into each other. A unit is a column tile and a cluster's row tiles;
one launch may run up to three products over the same rows a (q, k and v):
their column tiles lie side by side, column tiles fastest, so the blocks in
flight share a few row tiles of a in the L2. The CUDA kernel walks its
units as `place` lists them; the CPU tests hold the lists against the
coverage rules (tests/test_torch_launch_plans.py).
"""

from __future__ import annotations

# The tile: 128 rows x 256 columns, 64 k a stage, a ring of four stages beside
# the staging memory of half a tile's result; clusters of two row tiles.
GEMM_BM, GEMM_BN, GEMM_BK, GEMM_STAGES, GEMM_CLUSTER = 128, 256, 64, 4, 2
MAX_PRODUCTS = 3  # csrc/vit_gemm_wgmma.cuh kMaxProducts


def gemm_plan(m: int, n: int, k: int, sm_count: int, products: int = 1) -> dict:
    """The launch plan of `products` products y_p [m, n] = a [m, k] @ w_p [k,
    n] over the same rows a on the wgmma GEMM: the tile; the cluster
    (GEMM_CLUSTER row tiles sharing each of w's tiles, where there is more
    than one row tile); each product's column tiles and the row tiles,
    rounded up to whole clusters (tiles past m compute zeros and store
    nothing); the units and the rounds of units the clusters take; the
    persistent grid (whole clusters, at most one block per SM) with each
    block's tiles (`place`); the k steps (k padded to a whole stage with
    TMA's zeros); the shared memory; and the bytes its blocks read from L2
    (a once per column tile, w once per cluster)."""
    if not 1 <= products <= MAX_PRODUCTS or min(m, n, k) < 1:
        raise ValueError(f"wgmma GEMM takes 1-{MAX_PRODUCTS} products of m, n, k >= 1 "
                         f"(products={products}, m={m}, n={n}, k={k})")
    n_tiles, m_tiles = -(-n // GEMM_BN), -(-m // GEMM_BM)
    cluster = GEMM_CLUSTER if m_tiles > 1 else 1
    m_tiles = -(-m_tiles // cluster) * cluster
    units = products * n_tiles * m_tiles // cluster
    stage = (GEMM_BM + GEMM_BN) * GEMM_BK * 2
    plan = {"tile": (GEMM_BM, GEMM_BN), "cluster": cluster, "stage_k": GEMM_BK,
            "stages": GEMM_STAGES, "products": products, "n_tiles": n_tiles,
            "m_tiles": m_tiles, "units": units, "k_steps": -(-k // GEMM_BK),
            # the ring, half a tile's result and the bias per warpgroup, barriers
            "smem_bytes": GEMM_STAGES * stage + GEMM_BM * GEMM_BN + 2 * GEMM_BN * 2
            + (2 * GEMM_STAGES + 2) * 8 + 1024,
            "l2_bytes": 2 * products * (n_tiles * m * k + m_tiles // cluster * k * n)}
    return place(plan, min(sm_count // cluster, units) * cluster)


def place(plan: dict, blocks: int) -> dict:
    """`plan` on a grid of `blocks` blocks: the grid, the rounds of units
    (units over clusters, the last one maybe part-filled) and each block's
    tiles (column tile, row tile) in its order. Column tile c is column tile
    c % n_tiles of product c // n_tiles. A unit is a column tile and a
    cluster's row tiles; cluster i takes units i, i + clusters, ..., unit u
    the column tile u % (products * n_tiles) and its blocks the row tiles
    cluster * (u // (products * n_tiles)) + rank."""
    cols, cluster = plan["products"] * plan["n_tiles"], plan["cluster"]
    units, clusters = plan["units"], blocks // cluster
    plan["grid"] = (blocks,)
    plan["rounds"] = units / clusters
    plan["tiles"] = [[(u % cols, cluster * (u // cols) + b % cluster)
                      for u in range(b // cluster, units, clusters)] for b in range(blocks)]
    return plan
