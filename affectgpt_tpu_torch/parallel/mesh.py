"""The ("dp", "tp") layout of the PyTorch port, its sharding rules and
collectives.

Port of affectgpt_tpu/parallel/mesh.py (reference:
my_affectgpt/common/dist_utils.py:54-79, runner_base.py:103-109). The JAX
package lays a 2-D ("dp", "tp") mesh over its devices and lets the compiler
insert the collectives; here each process is one rank on one card (or the
CPU), `torch.distributed` names its rank and the world, and the code calls
the collectives itself. Ranks are laid out tp-fastest, as JAX's
`np.asarray(devices).reshape(dp, tp)`: rank = dp_rank * tp + tp_rank.

- Data parallelism (training): every dp rank loads its own share of
  the global batch (`run.batch_size_train` samples a rank, as JAX's
  `batch_size_train · dp`) and the training step sums its gradients over
  the dp group (`training.train_step`).
- Tensor-parallel training: the decoder runs on the rank's shard under
  autograd through three differentiable collectives over the tp group
  (Megatron's f and g, and a gather): `copy_to_tp` (identity forward,
  all-reduce of the gradient backward) before every column-parallel
  product, `reduce_from_tp` (all-reduce forward, identity backward) after
  every row-parallel one, `gather_from_tp` (all-gather forward, the rank's
  slice of the gradient backward) on the vocabulary-parallel logits. Their
  backward rules hold where what follows them is replicated over the tp
  group, as the residual stream and the loss are. The training step sums
  the LoRA gradients over the tp group (`all_reduce_sum(axis="tp")`).
- Tensor-parallel serving: `shard_params` gives each rank its slice of the
  LLM by JAX's `param_spec` rules, `shard_config` the rank's decoder
  geometry (its query heads, the kv heads they read, its intermediate
  columns) with the layout attached (`qwen2.ShardConfig`), and `models.qwen2` reduces the
  row-parallel partial sums over the tp group (`tp_all_reduce`) and gathers
  the vocabulary-parallel logits (`tp_all_gather`). The decode kernels run
  on each rank's shard.

Sharding rules (JAX `param_spec`, mesh.py:56-77):
- q/k/v and gate/up are column-parallel (their biases too): a rank holds
  its heads' columns, or its columns of I. Where tp does not divide the kv
  heads, a rank holds the kv head its query heads read (JAX replicates the
  cache there and lets the compiler reassemble its column slice).
- o and down are row-parallel: a rank holds the rows of its heads or of its
  columns of I, and its product is a partial sum.
- lm_head is split by vocabulary columns.
- LoRA `a` is replicated and LoRA `b` follows its base's output columns
  (`b` of o and down is replicated); a row-parallel layer's `a` is read at
  the rank's rows when the branch runs. The decoder also takes a whole LoRA
  tree (as checkpoints hold it) and reads it at the rank's slices
  (`qwen2._rank_lora`).
- Embeddings, norms, mergers and encoders are replicated.
- Quantized leaves: int8 `scales` [1, N] follow N on column-parallel
  leaves and stay whole on row-parallel ones. A row-parallel int4 leaf is
  unpacked, sliced along K and repacked for the rank (the format pairs row
  k with row k + K/2 in a byte, so a slice of the packed rows is not a K
  slice); its scales are sliced by their 128-row groups. The int4 kernels
  take K % 256 == 0, so a rank's K must keep it: Qwen2.5-7B's o_proj (K =
  1792) and down_proj (9472) do at tp = 2, not at tp = 4 (896, 4736), where
  `shard_params` raises.
- The fused q/k/v and gate/up serving layout serves one rank only.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Layout:
    """One process's place in the (dp, tp) world. tp_group / dp_group are
    the process groups of the rank's tp row and dp column (None where the
    axis has one rank; the dp group of a tp = 1 layout is the world)."""

    world_size: int
    rank: int
    device: torch.device
    tp: int = 1
    dp: int = 1
    tp_group: object = field(default=None, compare=False, repr=False)
    dp_group: object = field(default=None, compare=False, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_src(self) -> int:
        """The global rank of tp rank 0 in this rank's tp group."""
        return self.rank - self.tp_rank



def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def create_layout(device="cuda", tp: int = 1, dp: Optional[int] = None) -> Layout:
    """The layout of this process: rank and world size from an initialized
    torch.distributed group (one rank, rank 0, without one), tp ranks a row
    and dp = world / tp rows, on `device`; a CUDA device without an index
    takes the card of the rank (rank % the cards). Every rank must call it
    with the same arguments: it creates the tp and dp process groups, which
    all ranks make in the same order."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if distributed() else (1, 0)
    tp = int(tp)
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} does not divide the {world} ranks")
    dp = world // tp if dp is None else int(dp)
    if dp * tp != world:
        raise ValueError(f"dp ({dp}) x tp ({tp}) != the {world} ranks")
    tp_group = dp_group = None
    if tp > 1:
        for row in range(dp):
            group = dist.new_group(list(range(row * tp, (row + 1) * tp)))
            if rank // tp == row:
                tp_group = group
        if dp > 1:
            for col in range(tp):
                group = dist.new_group(list(range(col, world, tp)))
                if rank % tp == col:
                    dp_group = group
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return Layout(world_size=world, rank=rank, device=device, tp=tp, dp=dp,
                  tp_group=tp_group, dp_group=dp_group)


# ---------------------------------------------------------------------------
# Data-parallel collectives (training)


def all_reduce_sum(tensors: List[torch.Tensor], layout: Optional[Layout],
                   axis: str = "dp") -> None:
    """Sum `tensors` over the layout's dp group (or, with axis="tp", its tp
    group) in place, as one flat buffer per dtype (one collective each);
    nothing to do where the axis has one rank (or no layout)."""
    if layout is None or getattr(layout, axis) <= 1 or not tensors:
        return
    pg = layout.dp_group if axis == "dp" else layout.tp_group
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=pg)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast(tensors: List[torch.Tensor], layout: Layout, src: int = 0) -> None:
    """Give every rank rank `src`'s values of `tensors`, in place."""
    if layout.world_size <= 1:
        return
    for t in tensors:
        dist.broadcast(t, src)


def barrier(layout: Layout) -> None:
    if layout.world_size > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# Tensor-parallel collectives (serving, and under autograd training)


def _tp_on(layout: Optional[Layout]) -> bool:
    return layout is not None and layout.tp > 1


def tp_all_reduce(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The sum of the tp ranks' partials `t`, in t's dtype (in place)."""
    if _tp_on(layout):
        dist.all_reduce(t, group=layout.tp_group)
    return t


def tp_all_reduce_max(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The elementwise maximum of the tp ranks' `t` (in place)."""
    if _tp_on(layout):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=layout.tp_group)
    return t


def tp_all_gather(t: torch.Tensor, layout: Optional[Layout], dim: int = -1) -> torch.Tensor:
    """The tp ranks' slices `t` concatenated along `dim`, in rank order."""
    if not _tp_on(layout):
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(layout.tp)]
    dist.all_gather(parts, t, group=layout.tp_group)
    return torch.cat(parts, dim=dim)


def tp_broadcast(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """tp rank 0's values of `t` on every rank of its tp group (in place):
    the ranks take the same token whatever their logits' last bits."""
    if _tp_on(layout):
        t = t.contiguous()
        dist.broadcast(t, src=layout.tp_src, group=layout.tp_group)
    return t


class _CopyToTP(torch.autograd.Function):
    """Megatron's f: identity forward; backward, the sum over the tp ranks
    of their gradients (each rank's product reads its own columns, so its
    gradient of the input is a partial sum)."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tp_all_reduce(g.contiguous().clone(), ctx.layout), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's g: the sum over the tp ranks forward; identity backward
    (what follows is replicated, so every rank's gradient of the sum is
    already the gradient of its own partial)."""

    @staticmethod
    def forward(ctx, x, layout):
        return tp_all_reduce(x.contiguous().clone(), layout)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """The tp ranks' slices concatenated along the last axis forward; the
    rank's slice of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout, ctx.n = layout, x.shape[-1]
        return tp_all_gather(x, layout)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.layout.tp_rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def _recorded(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def copy_to_tp(x: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """f before a column-parallel product: x itself, whose gradient the
    backward sums over the tp ranks. The identity with tp = 1, no layout,
    or where autograd does not record x."""
    if not _tp_on(layout) or not _recorded(x):
        return x
    return _CopyToTP.apply(x, layout)


def reduce_from_tp(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """g after a row-parallel product: the sum of the tp ranks' partials t,
    with the identity backward; where autograd does not record t, the
    in-place `tp_all_reduce` of the serving path."""
    if not _tp_on(layout):
        return t
    if not _recorded(t):
        return tp_all_reduce(t.contiguous(), layout)
    return _ReduceFromTP.apply(t, layout)


def gather_from_tp(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """The tp ranks' slices t concatenated along the last axis, whose
    backward returns the rank's slice of the gradient (`tp_all_gather`
    where autograd does not record t)."""
    if not _tp_on(layout) or not _recorded(t):
        return tp_all_gather(t, layout)
    return _GatherFromTP.apply(t, layout)


def dp_share(t: torch.Tensor, layout: Optional[Layout]) -> torch.Tensor:
    """This dp rank's share of a batch t (dim 0): ceil(n / dp) rows a rank,
    the batch padded with copies of its last row to dp such shares."""
    if layout is None or layout.dp <= 1:
        return t
    n = t.shape[0]
    per = -(-n // layout.dp)
    if per * layout.dp > n:
        t = torch.cat([t, t[-1:].expand(per * layout.dp - n, *t.shape[1:])])
    return t[layout.dp_rank * per:(layout.dp_rank + 1) * per]


def dp_gather(t: torch.Tensor, n: int, layout: Optional[Layout]) -> torch.Tensor:
    """The dp ranks' shares t (`dp_share`'s, along dim 0) concatenated into
    the whole batch of n rows, on every rank."""
    if layout is None or layout.dp <= 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(layout.dp)]
    dist.all_gather(parts, t, group=layout.dp_group)
    return torch.cat(parts)[:n]


# ---------------------------------------------------------------------------
# Sharding rules

_COL_PARALLEL = re.compile(r"(q_proj|k_proj|v_proj|gate_proj|up_proj)")
_ROW_PARALLEL = re.compile(r"(o_proj|down_proj)")
_KV = re.compile(r"(k_proj|v_proj)")
_FUSED = re.compile(r"(qkv_proj|gateup_proj)")
INT4_K_MULTIPLE = 256  # ops/quant.py: the int4 kernels' K % 256 (two 128-row groups a byte pair)


def leaf_kind(name: str) -> Optional[str]:
    """How a leaf at tree path `name` ("llm/layers/0/q_proj/w") is split
    over tp: "col" (its output columns), "row" (its input rows), "vocab"
    (lm_head's columns), or None (replicated). JAX's `param_spec` by name."""
    if _FUSED.search(name):
        raise ValueError(f"{name}: the fused q/k/v and gate/up layout serves one rank only; "
                         f"shard the split layout")
    if "lora" in name:
        if name.endswith("/b") and _COL_PARALLEL.search(name):
            return "col"
        return None
    if "lm_head" in name:
        return "vocab"
    if _COL_PARALLEL.search(name):
        return "col"
    if _ROW_PARALLEL.search(name):
        return "row"
    return None


def kv_heads(cfg, tp: int, tp_rank: int) -> tuple:
    """(first, count) of the kv heads that tp rank `tp_rank`'s query heads
    read: kv / tp of them where tp divides the kv heads, else the one kv
    head of the rank's query heads (which must then share one)."""
    heads, kv = cfg.num_heads, cfg.num_kv_heads
    if heads % tp:
        raise ValueError(f"tp={tp} does not divide the {heads} query heads")
    if kv % tp == 0:
        return tp_rank * (kv // tp), kv // tp
    local, groups = heads // tp, heads // kv
    if groups % local:
        raise ValueError(f"tp={tp}: a rank's {local} query heads span two of the {kv} kv heads")
    return tp_rank * local // groups, 1


def shard_config(cfg, layout: Optional[Layout]):
    """The rank's decoder geometry: its query heads, the kv heads they read,
    its columns of I, and the layout attached (a `qwen2.ShardConfig`),
    from which the decoder takes its collectives. The vocabulary and hidden
    widths stay whole (the logits are gathered)."""
    from affectgpt_tpu_torch.models.qwen2 import ShardConfig

    if layout is None:
        return cfg
    if cfg.layout is not None:
        raise ValueError("shard_config: the config is already a rank's shard")
    tp = layout.tp
    if tp > 1:
        _, kv = kv_heads(cfg, tp, 0)
        if cfg.intermediate_size % tp or cfg.vocab_size % tp:
            raise ValueError(f"tp={tp} must divide intermediate_size {cfg.intermediate_size} "
                             f"and vocab_size {cfg.vocab_size}")
        cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp, num_kv_heads=kv,
                                  intermediate_size=cfg.intermediate_size // tp)
    return ShardConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
                       layout=layout)


def axis_range(kind: str, name: str, n: int, cfg, tp: int, tp_rank: int) -> tuple:
    """(start, stop) of the rank's slice of a split axis of length n: the
    kv-head columns of k/v (`kv_heads`), else the rank's n / tp."""
    if kind == "col" and _KV.search(name):
        first, count = kv_heads(cfg, tp, tp_rank)
        d = n // cfg.num_kv_heads
        return first * d, (first + count) * d
    if n % tp:
        raise ValueError(f"{name}: tp={tp} does not divide its {n} {kind} entries")
    return tp_rank * (n // tp), (tp_rank + 1) * (n // tp)


def _repack_int4_rows(w_q4: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows [start, stop) of a packed int4 leaf's K, repacked as
    `quant.quantize_int4_grouped` packs a [stop - start, N] leaf."""
    from affectgpt_tpu_torch.ops import quant

    k = stop - start
    if k % INT4_K_MULTIPLE:
        raise ValueError(f"int4 row-parallel shard of K = {k}: the int4 kernels need K % "
                         f"{INT4_K_MULTIPLE} == 0 on every rank (ops/quant.py); use fewer "
                         f"tp ranks or int8")
    vals = quant._int4_values(w_q4)[start:stop].to(torch.int32)
    lo, hi = vals[:k // 2], vals[k // 2:]
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def shard_leaf(name: str, leaf: torch.Tensor, siblings: dict, cfg, layout: Layout):
    """The rank's slice of one leaf at tree path `name` (siblings: the dict
    holding it, which tells a quantized leaf's format)."""
    kind = leaf_kind(name)
    tp, r = layout.tp, layout.tp_rank
    if kind is None or tp == 1:
        return leaf
    key = name.rsplit("/", 1)[-1]
    if kind in ("col", "vocab"):
        axis = leaf.ndim - 1
        start, stop = axis_range(kind, name, leaf.shape[axis], cfg, tp, r)
        return leaf.narrow(axis, start, stop - start).contiguous()
    # row-parallel: w [K, N], w_q [K, N], w_q4 [K/2, N] with scales [K/128, N]
    if key == "w_q4":
        start, stop = axis_range(kind, name, 2 * leaf.shape[0], cfg, tp, r)
        return _repack_int4_rows(leaf, start, stop)
    if key == "scales":
        if "w_q4" not in siblings:
            return leaf  # int8 [1, N]: the columns' scales, whole on every rank
        start, stop = axis_range(kind, name, 2 * siblings["w_q4"].shape[0], cfg, tp, r)
        from affectgpt_tpu_torch.ops.quant import INT4_GROUP

        return leaf[start // INT4_GROUP:stop // INT4_GROUP].contiguous()
    if leaf.ndim != 2:
        return leaf
    start, stop = axis_range(kind, name, leaf.shape[0], cfg, tp, r)
    return leaf[start:stop].contiguous()


def shard_params(tree, layout: Layout, cfg, prefix: str = ""):
    """This rank's slice of every leaf of `tree` (nested dicts and lists of
    tensors, paths as in JAX: "llm/layers/0/q_proj/w"), by `leaf_kind`.
    cfg, the LLM's (whole) QwenConfig, places the kv-head columns of k/v
    (`kv_heads`). Returns a new tree; replicated leaves are shared with
    `tree`."""
    if isinstance(tree, dict):
        return {k: (shard_leaf(f"{prefix}{k}", v, tree, cfg, layout)
                    if torch.is_tensor(v) else
                    shard_params(v, layout, cfg, f"{prefix}{k}/"))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_params(v, layout, cfg, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return tree


def shard_llm(frozen: dict, cfg, layout: Optional[Layout]):
    """(frozen, cfg) of the rank under `layout`: the LLM sharded
    (`shard_params`), cfg.llm the rank's geometry (`shard_config`); the
    rest of frozen (the towers) stays whole. Trees whose cfg.llm already
    carries a layout (`bootstrap.build_model(layout=)`) pass unchanged."""
    if layout is None or cfg.llm.layout is not None:
        return frozen, cfg
    frozen = {**frozen, "llm": shard_params(frozen["llm"], layout, cfg.llm, "llm/")}
    return frozen, dataclasses.replace(cfg, llm=shard_config(cfg.llm, layout))


def shard_model(frozen: dict, trainable: dict, cfg, layout: Optional[Layout]):
    """(frozen, trainable, cfg) of the rank under `layout`: `shard_llm`, and
    LoRA sharded too (serving; training keeps the trainable tree whole).
    Trees whose cfg.llm already carries a layout pass unchanged."""
    if layout is None or cfg.llm.layout is not None:
        return frozen, trainable, cfg
    if trainable.get("lora") is not None:
        trainable = {**trainable, "lora": shard_params(trainable["lora"], layout, cfg.llm,
                                                       "lora/")}
    frozen, cfg = shard_llm(frozen, cfg, layout)
    return frozen, trainable, cfg
