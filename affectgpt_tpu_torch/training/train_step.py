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
                    layout: Optional[mesh_lib.Layout] = None) -> Callable:
    """Returns train_step(state, frozen, batch) -> (state, metrics).

    dropout_seed: turns on train-mode dropout (the reference trains under
    model.train(): LoRA dropout 0.05, the qformer mergers' BERT dropouts).
    The step's dropout key is (dropout_seed, state.step): deterministic and
    the same after a resume; with several ranks each rank folds its rank
    into it, so the ranks draw different masks. None is the eval-mode
    forward (what parity checks compare).

    layout: with several ranks, batch is this rank's share of the global
    batch and the loss, the gradients and the metrics are the global
    batch's (see the module docstring); every rank must call the step.

    The state's trainable leaves and optimizer state are updated in place
    (JAX donates the state) and the returned state holds them. The metrics,
    "loss" and "grad_norm" (the global norm of every trainable gradient,
    frozen-mask leaves included), stay device tensors: the caller syncs
    only when it reads them."""
    world = layout.world_size if layout is not None else 1

    def train_step(state: TrainState, frozen: dict, batch: dict) -> Tuple[TrainState, Dict]:
        key = None
        if dropout_seed is not None:
            key = (dropout_seed, state.step)
            if world > 1:
                key = nn.fold_in(key, layout.rank)
        leaves = optim.tree_leaves(state.trainable)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss_sum, count = affectgpt.forward_loss(frozen, state.trainable, cfg, batch,
                                                 remat=remat, dropout_rng=key, return_sum=True)
        mesh_lib.all_reduce_sum([count], layout)
        loss = loss_sum / count.clamp_min(1)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for leaf in leaves:
            leaf.requires_grad_(False)
        # a leaf the loss does not reach (an unused merger) has a zero gradient
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        loss = loss.detach()
        mesh_lib.all_reduce_sum(grads + [loss], layout)
        grad_tree = optim.tree_unflatten(state.trainable, grads)
        opt_state = tx.apply(grad_tree, state.opt_state, state.trainable)
        metrics = {"loss": loss, "grad_norm": optim.global_norm(grads)}
        return TrainState(step=state.step + 1, trainable=state.trainable,
                          opt_state=opt_state), metrics

    return train_step


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
