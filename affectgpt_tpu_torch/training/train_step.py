"""The training step of the PyTorch port: loss, gradients, optimizer.

Port of affectgpt_tpu/training/train_step.py (reference:
my_affectgpt/tasks/base_task.py:101-198). One call runs the forward
(`affectgpt.forward_loss`), the backward over the `trainable` tree (LoRA,
mergers, projections) and one micro-step of the optimizer. The frozen tree
(the LLM base, the encoders) is read only. bf16 compute needs no loss
scaling; trainable leaves, their gradients and the optimizer state are
float32.

The device and data parallel placement of JAX's `compile_train_step` and
`shard_state` belongs with the runner's torch.distributed port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from affectgpt_tpu_torch.models import affectgpt
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
                    dropout_seed: Optional[int] = None) -> Callable:
    """Returns train_step(state, frozen, batch) -> (state, metrics).

    dropout_seed: turns on train-mode dropout (the reference trains under
    model.train(): LoRA dropout 0.05, the qformer mergers' BERT dropouts).
    The step's dropout key is (dropout_seed, state.step): deterministic and
    the same after a resume. None is the eval-mode forward (what parity
    checks compare).

    The state's trainable leaves and optimizer state are updated in place
    (JAX donates the state) and the returned state holds them. The metrics,
    "loss" and "grad_norm" (the global norm of every trainable gradient,
    frozen-mask leaves included), stay device tensors: the caller syncs
    only when it reads them."""

    def train_step(state: TrainState, frozen: dict, batch: dict) -> Tuple[TrainState, Dict]:
        key = (dropout_seed, state.step) if dropout_seed is not None else None
        leaves = optim.tree_leaves(state.trainable)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = affectgpt.forward_loss(frozen, state.trainable, cfg, batch, remat=remat,
                                      dropout_rng=key)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for leaf in leaves:
            leaf.requires_grad_(False)
        # a leaf the loss does not reach (an unused merger) has a zero gradient
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grad_tree = optim.tree_unflatten(state.trainable, grads)
        opt_state = tx.apply(grad_tree, state.opt_state, state.trainable)
        metrics = {"loss": loss.detach(), "grad_norm": optim.global_norm(grads)}
        return TrainState(step=state.step + 1, trainable=state.trainable,
                          opt_state=opt_state), metrics

    return train_step
