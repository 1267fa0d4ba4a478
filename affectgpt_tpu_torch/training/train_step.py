"""The training step of the PyTorch port: loss, gradients, optimizer.

Port of affectgpt_tpu/training/train_step.py (reference:
my_affectgpt/tasks/base_task.py:101-198). One call runs the forward
(`affectgpt.forward_loss`), the backward over the `trainable` tree (LoRA,
mergers, projections) and one micro-step of the optimizer. The frozen tree
(the LLM base, the encoders) is read only. bf16 compute needs no loss
scaling; trainable leaves, their gradients and the optimizer state are
float32.

With a data-parallel layout of several ranks (`make_train_step(layout=)`),
the step takes JAX's loss over the global batch (one `jit` over the "dp" mesh,
JAX qwen2.py:1134-1135): each rank's summed token loss over the valid
tokens of every rank (their count is summed first), the gradients summed
over the ranks, so every rank clips and applies the same update. A mean
of per-rank means would weigh a rank's tokens by its own count.

With tp > 1 (JAX: the step jitted over the "tp" axis, train_step.py:100-130)
the frozen LLM is the rank's shard (`cfg.llm` a shard config) and the ranks
of a tp row take the same batch. The trainable tree stays whole on every
rank, as checkpoints hold it (JAX shards LoRA `b` and its optimizer state):
the decoder reads the LoRA leaves at the rank's slices under autograd, so a
rank's LoRA gradient is its slice (q/k/v/gate/up `b`, o/down `a`) or a
partial sum (their other factor), and one sum over the tp group gives the
whole gradient. Every other trainable leaf (mergers, projections) sees the
whole gradient of the replicated embeddings on each rank (f sums it) and is
not summed over tp. The loss, the token count and every gradient are then
summed over the dp group only. Every rank holds the same gradients, clips
by the same norm and applies the same update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from affectgpt_tpu_torch.models import affectgpt, nn
from affectgpt_tpu_torch.parallel import mesh as mesh_lib
from affectgpt_tpu_torch.training import optim


@dataclass
class TrainState:
    step: int  # micro-steps taken, a host counter
    trainable: dict
    opt_state: dict


def create_train_state(trainable: dict, tx: optim.AdamW) -> TrainState:
    """A state at step 0 that owns float32 copies of the trainable leaves
    (the caller's tree is not touched) and the optimizer's initial state."""
    own = optim.tree_map(lambda t: t.detach().to(torch.float32, copy=True), trainable)
    return TrainState(step=0, trainable=own, opt_state=tx.init(own))


def make_train_step(cfg: affectgpt.AffectGPTConfig, tx: optim.AdamW, remat=False,
                    dropout_seed: Optional[int] = None,
                    layout: Optional[mesh_lib.Layout] = None,
                    check_replicas: bool = False) -> Callable:
    """Returns train_step(state, frozen, batch) -> (state, metrics).

    dropout_seed: turns on train-mode dropout (the reference trains under
    model.train(): LoRA dropout 0.05, the qformer mergers' BERT dropouts).
    The step's dropout key is (dropout_seed, state.step): deterministic and
    the same after a resume; with several dp ranks each folds its dp rank
    into it, so the dp ranks draw different masks and the tp ranks of a row
    the same ones (a tp = 2 step draws tp = 1's masks). None is the
    eval-mode forward (what parity checks compare).

    layout: with several ranks, batch is this rank's share of the global
    batch (the same on the tp ranks of a row) and the loss, the gradients
    and the metrics are the global batch's (see the module docstring);
    every rank must call the step.

    check_replicas: after the update, compare every tp rank's trainable
    tree with tp rank 0's (one broadcast a step) and raise if one differs
    by a bit: the tests' check that the replicas stay identical.

    The state's trainable leaves and optimizer state are updated in place
    (JAX donates the state) and the returned state holds them. The metrics,
    "loss" and "grad_norm" (the global norm of every trainable gradient,
    frozen-mask leaves included), stay device tensors: the caller syncs
    only when it reads them."""
    dp = layout.dp if layout is not None else 1
    tp = layout.tp if layout is not None else 1

    def train_step(state: TrainState, frozen: dict, batch: dict) -> Tuple[TrainState, Dict]:
        key = None
        if dropout_seed is not None:
            key = (dropout_seed, state.step)
            if dp > 1:
                key = nn.fold_in(key, layout.dp_rank)
        loss, grads = loss_and_grads(cfg, frozen, state.trainable, batch, remat=remat,
                                     key=key, layout=layout)
        grad_tree = optim.tree_unflatten(state.trainable, grads)
        opt_state = tx.apply(grad_tree, state.opt_state, state.trainable)
        if check_replicas and tp > 1:
            check_tp_replicas(state.trainable, layout)
        metrics = {"loss": loss, "grad_norm": optim.global_norm(grads)}
        return TrainState(step=state.step + 1, trainable=state.trainable,
                          opt_state=opt_state), metrics

    return train_step


def loss_and_grads(cfg: affectgpt.AffectGPTConfig, frozen: dict, trainable: dict,
                   batch: dict, remat=False, key=None,
                   layout: Optional[mesh_lib.Layout] = None) -> Tuple[torch.Tensor, list]:
    """The step's loss over the global batch and the gradient of every leaf
    of `trainable` (in `optim.tree_leaves` order, zeros where the loss does
    not reach), reduced as the module docstring says: the LoRA leaves over
    the tp group, then everything over the dp group. key: the dropout key
    (None: eval mode). Every rank must call it."""
    leaves = optim.tree_leaves(trainable)
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        loss_sum, count = affectgpt.forward_loss(frozen, trainable, cfg, batch, remat=remat,
                                                 dropout_rng=key, return_sum=True)
        mesh_lib.all_reduce_sum([count], layout)
        loss = loss_sum / count.clamp_min(1)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    # a leaf the loss does not reach (an unused merger) has a zero gradient
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    loss = loss.detach()
    if layout is not None and layout.tp > 1:
        mesh_lib.all_reduce_sum([g for g, path in zip(grads, optim.tree_paths(trainable))
                                 if path.startswith("/lora/")], layout, axis="tp")
    mesh_lib.all_reduce_sum(grads + [loss], layout)
    return loss, grads


def check_tp_replicas(trainable: dict, layout: mesh_lib.Layout) -> None:
    """Raise unless every leaf of `trainable` holds tp rank 0's bits on
    every rank of the tp row."""
    mine = torch.cat([t.reshape(-1) for t in optim.tree_leaves(trainable)])
    theirs = mesh_lib.tp_broadcast(mine.clone(), layout)
    if not torch.equal(mine, theirs):
        diff = int((mine != theirs).sum())
        raise RuntimeError(f"tp rank {layout.tp_rank}'s trainable tree differs from tp rank "
                           f"0's in {diff} of {mine.numel()} elements")


def shard_state(layout: mesh_lib.Layout, state: TrainState) -> TrainState:
    """The state on the layout's device, every rank holding rank 0's
    trainable leaves and optimizer state (JAX's `shard_state` places a
    replicated copy on each device)."""
    def place(t):
        return t.to(layout.device) if torch.is_tensor(t) else t

    trainable = optim.tree_map(place, state.trainable)
    opt_state = {k: optim.tree_map(place, v) for k, v in state.opt_state.items()}
    mesh_lib.broadcast(optim.tree_leaves(trainable)
                       + [t for k in ("mu", "nu", "acc") for t in optim.tree_leaves(
                           opt_state.get(k))], layout)
    return TrainState(step=state.step, trainable=trainable, opt_state=opt_state)
