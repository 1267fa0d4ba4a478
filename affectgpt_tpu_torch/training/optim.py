"""Optimizer and LR schedules of the PyTorch port.

Port of affectgpt_tpu/training/optim.py (reference:
my_affectgpt/common/optims.py:13-121, runners/runner_base.py:116-149,
tasks/base_task.py:167-173):
- `linear_warmup_cosine_lr` / `linear_warmup_step_lr` at iteration
  resolution, evaluated in float32 as JAX evaluates them;
- AdamW with no weight decay on vectors and scalars (ndim < 2);
- clipping by the global norm, gradient accumulation over `accum_steps`
  micro-steps, and a freeze mask whose leaves get no update at all.

`AdamW` is optax's `MultiSteps(chain(clip_by_global_norm, adamw))` under
`multi_transform({"train": ..., "freeze": set_to_zero()})`, written as one
functional update over dict trees of tensors: Adam's moments and count,
eps outside the square root, bias correction, decoupled weight decay scaled
by the learning rate; the accumulated gradient is the running mean of the
micro-gradients, and the inner update (clip, Adam, the schedule at
`count * accum_steps`) runs once every `accum_steps` calls. The global norm
of the clip covers the leaves that train, as the "train" partition of
`multi_transform` sees only them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from affectgpt_tpu_torch import registry

B1, EPS = 0.9, 1e-8  # optax.adamw's b1 and eps, as the JAX package calls it


@registry.register_lr_scheduler("linear_warmup_cosine_lr")
def linear_warmup_cosine_lr(init_lr: float, min_lr: float, warmup_steps: int, total_steps: int,
                            warmup_start_lr: float = -1.0, **_) -> Callable[[int], float]:
    warmup_start = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step) -> float:
        step = np.float32(step)
        if step < warmup_steps:
            warm = warmup_start + (init_lr - warmup_start) * np.minimum(step, np.float32(warmup_steps)) \
                / np.float32(max(warmup_steps, 1))
            return float(np.float32(warm))
        progress = np.clip(step / np.float32(max(total_steps, 1)), np.float32(0.0), np.float32(1.0))
        cosine = min_lr + 0.5 * (init_lr - min_lr) * (1.0 + np.cos(np.float32(np.pi) * progress))
        return float(np.float32(cosine))

    return schedule


@registry.register_lr_scheduler("linear_warmup_step_lr")
def linear_warmup_step_lr(init_lr: float, min_lr: float, warmup_steps: int,
                          decay_rate: float = 1.0, steps_per_epoch: int = 1,
                          warmup_start_lr: float = -1.0, **_) -> Callable[[int], float]:
    warmup_start = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step) -> float:
        step = np.float32(step)
        if step < warmup_steps:
            warm = warmup_start + (init_lr - warmup_start) * np.minimum(step, np.float32(warmup_steps)) \
                / np.float32(max(warmup_steps, 1))
            return float(np.float32(warm))
        epoch = np.floor(step / np.float32(max(steps_per_epoch, 1)))
        return float(np.maximum(np.float32(init_lr * (decay_rate ** epoch)), np.float32(min_lr)))

    return schedule


def tree_leaves(tree) -> List:
    """The leaves of a tree of dicts and lists, dicts in sorted key order
    (None leaves skipped)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[str]:
    """The path of every leaf of `tree` ("/key", "[index]"), in
    `tree_leaves` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, f"{prefix}[{i}]")]
    return [prefix]


def tree_unflatten(tree, leaves: list):
    """`leaves` (in `tree_leaves` order) put into `tree`'s structure."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(tree)


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the same leaves of `rest`), keeping
    its dicts and lists; None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _no_decay_mask(params):
    """True (decay) for matrices; False for vectors and scalars, the
    reference's ndim < 2 / bias / norm exclusion."""
    return tree_map(lambda p: p.ndim >= 2, params)


def freeze_mask_from_flags(trainable, model_cfg_node: dict):
    """Tree of bools over `trainable`: False = frozen (no update). The
    reference's frozen_* switches as an optimizer mask (reference:
    affectgpt.py:126-356, runner_base.py:116-149)."""
    flags = model_cfg_node or {}

    def subtree_mask(tree, value):
        return tree_map(lambda _: value, tree)

    mask = {}
    for key, sub in trainable.items():
        if key == "lora":
            mask[key] = subtree_mask(sub, not flags.get("frozen_llm", False))
        elif key == "multi":
            frozen = flags.get("frozen_multi_Qformer", False) and flags.get(
                "frozen_multi_llama_proj", False)
            mask[key] = subtree_mask(sub, not frozen)
        elif key == "mergers":
            mask[key] = {}
            for m, msub in sub.items():
                if m in ("video", "image"):
                    frozen = flags.get("frozen_video_Qformer", False) and flags.get(
                        "frozen_video_proj", False)
                elif m == "audio":
                    frozen = flags.get("frozen_audio_Qformer", False) and flags.get(
                        "frozen_audio_proj", False)
                else:  # au
                    frozen = flags.get("frozen_au_proj", False)
                mask[key][m] = subtree_mask(msub, not frozen)
        else:
            mask[key] = subtree_mask(sub, True)
    return mask


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Clip → AdamW (b1 0.9, eps 1e-8) with accumulation and a freeze mask;
    `make_optimizer` builds it. `init(params)` gives the state, and
    `apply(grads, state, params)` updates `params` in place and returns the
    next state."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.05
    beta2: float = 0.999
    max_grad_norm: Optional[float] = None
    accum_steps: int = 1
    freeze: Optional[dict] = None  # tree of bools, False = frozen

    def _train_leaves(self, tree) -> list:
        """The leaves of `tree` that train, in `tree_leaves` order."""
        leaves = tree_leaves(tree)
        if self.freeze is None:
            return leaves
        keep = tree_leaves(self.freeze)
        return [leaf for leaf, k in zip(leaves, keep) if k]

    def init(self, params) -> dict:
        train = self._train_leaves(params)
        zeros = lambda: [torch.zeros_like(p) for p in train]  # noqa: E731
        return {"count": 0, "mini_step": 0, "mu": zeros(), "nu": zeros(),
                "acc": zeros() if self.accum_steps > 1 else None}

    def apply(self, grads, state: dict, params) -> dict:
        """One micro-step: `grads` (a tree like `params`) joins the
        accumulator; every `accum_steps`-th call updates the training leaves
        of `params` in place. Nothing here waits for the device."""
        params_l = self._train_leaves(params)
        grads_l = self._train_leaves(grads)
        decays = self._train_leaves(_no_decay_mask(params))
        with torch.no_grad():
            k = self.accum_steps
            mini = state["mini_step"]
            if k > 1:
                acc = state["acc"]
                # Welford's running mean, as MultiSteps(use_grad_mean=True)
                torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads_l, acc),
                                                            mini + 1))
                if mini < k - 1:
                    return {**state, "mini_step": mini + 1}
                grads_l = acc
            count = state["count"]
            lr = self.schedule(count * k if k > 1 else count)
            if self.max_grad_norm:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads_l)))
                # optax divides by the norm, then multiplies by max_norm
                grads_l = [torch.where(norm < self.max_grad_norm, g,
                                       (g / norm) * self.max_grad_norm) for g in grads_l]
            b1, b2 = B1, self.beta2
            mu = torch._foreach_add(torch._foreach_mul(grads_l, 1 - b1),
                                    torch._foreach_mul(state["mu"], b1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads_l, grads_l),
                                                       1 - b2),
                                    torch._foreach_mul(state["nu"], b2))
            count += 1
            mu_hat = torch._foreach_div(mu, 1 - b1 ** count)
            nu_hat = torch._foreach_div(nu, 1 - b2 ** count)
            upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat),
                                                                EPS))
            if self.weight_decay:
                decay = [(u, p) for u, p, d in zip(upd, params_l, decays) if d]
                if decay:
                    torch._foreach_add_([u for u, _ in decay], [p for _, p in decay],
                                        alpha=self.weight_decay)
            torch._foreach_add_(params_l, torch._foreach_mul(upd, -lr))
            if k > 1:
                for a in state["acc"]:
                    a.zero_()
        return {"count": count, "mini_step": 0, "mu": mu, "nu": nu, "acc": state["acc"]}


def apply_freeze_mask(tx: AdamW, mask) -> AdamW:
    """Frozen leaves receive no update at all, not even the decoupled weight
    decay, which would drift them by lr·wd·param a step: the reference
    leaves requires_grad=False parameters out of the optimizer
    (runner_base.py:126)."""
    return dataclasses.replace(tx, freeze=mask)


def make_optimizer(schedule: Callable[[int], float], weight_decay: float = 0.05,
                   beta2: float = 0.999, max_grad_norm: Optional[float] = None,
                   accum_steps: int = 1) -> AdamW:
    """Clip by global norm (when max_grad_norm is set) → AdamW, applied once
    every `accum_steps` micro-steps to their mean gradient. The schedule is
    indexed by micro-iteration (the reference steps its scheduler every
    iteration), so the update after u·k micro-steps takes schedule(u·k):
    warmup lasts as many micro-steps with or without accumulation."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    return AdamW(schedule=schedule, weight_decay=weight_decay, beta2=beta2,
                 max_grad_norm=max_grad_norm, accum_steps=accum_steps)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (optax.global_norm), as a
    device scalar."""
    leaves = [t for t in tree_leaves(tree) if t is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves)))
