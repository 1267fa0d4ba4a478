"""The port's LR schedules and optimizer step against the JAX package
(optax).

The two schedules against JAX's at steps 0-40 (rtol 1e-6: both evaluate in
float32). Six micro-steps of the port's `train_step` against JAX's
`make_train_step` from the same state at tiny geometry in f32, dropout off:
the trainable tree within atol 1e-6 after every micro-step, the loss within
rtol 1e-5 and `grad_norm` within rtol 1e-5. Cases: accumulation over 1 and
2 micro-steps, clipping by the global norm (a norm small enough to clip),
weight decay 0.05 and a freeze mask that freezes the audio merger (its
leaves must not move, not even by weight decay).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.training import optim as jopt
from affectgpt_tpu.training import train_step as jts
from affectgpt_tpu_torch import registry
from affectgpt_tpu_torch.training import optim as topt
from affectgpt_tpu_torch.training import train_step as tts
from test_torch_train import batch_np, model, to_torch

STEPS = 6
SCHEDULE = dict(init_lr=1e-3, min_lr=1e-5, warmup_steps=3, warmup_start_lr=1e-4)
FREEZE_AUDIO = {"frozen_audio_Qformer": True, "frozen_audio_proj": True}


@pytest.mark.parametrize("name,kwargs", [
    ("linear_warmup_cosine_lr", dict(init_lr=3e-4, min_lr=1e-6, warmup_steps=7,
                                     total_steps=30, warmup_start_lr=1e-6)),
    ("linear_warmup_cosine_lr", dict(init_lr=1e-4, min_lr=0.0, warmup_steps=0, total_steps=25)),
    ("linear_warmup_step_lr", dict(init_lr=1e-3, min_lr=2e-4, warmup_steps=5, decay_rate=0.7,
                                   steps_per_epoch=6, warmup_start_lr=1e-5)),
])
def test_schedule_matches_jax(name, kwargs):
    want = jopt.linear_warmup_cosine_lr if name == "linear_warmup_cosine_lr" \
        else jopt.linear_warmup_step_lr
    got = registry.get("lr_scheduler", name)(**kwargs)
    ws = want(**kwargs)
    for step in range(41):
        np.testing.assert_allclose(got(step), float(ws(step)), rtol=1e-6, atol=1e-12)
    assert {"linear_warmup_cosine_lr", "linear_warmup_step_lr"} <= set(
        registry.names("lr_scheduler"))


CASES = {
    "plain": dict(accum_steps=1, max_grad_norm=None, freeze=None),
    "clip_freeze": dict(accum_steps=1, max_grad_norm=0.05, freeze=FREEZE_AUDIO),
    "accum2_clip_freeze": dict(accum_steps=2, max_grad_norm=0.05, freeze=FREEZE_AUDIO),
}


def optimizer(lib, case: dict, trainable):
    """`lib`'s (jopt or topt) optimizer of a case over `trainable`."""
    total = STEPS * case["accum_steps"] + 4
    tx = lib.make_optimizer(lib.linear_warmup_cosine_lr(total_steps=total, **SCHEDULE),
                            weight_decay=0.05, max_grad_norm=case["max_grad_norm"],
                            accum_steps=case["accum_steps"])
    if case["freeze"] is None:
        return tx
    return lib.apply_freeze_mask(tx, lib.freeze_mask_from_flags(trainable, case["freeze"]))


@functools.lru_cache(maxsize=None)
def jax_run(case_name: str):
    """JAX's trainable tree, loss and grad_norm after each micro-step."""
    jc, _, frozen, trainable, _, _ = model(False, "attention")
    jtx = optimizer(jopt, CASES[case_name], trainable)
    step = jax.jit(jts.make_train_step(jc, jtx))
    state = jts.create_train_state(trainable, jtx)
    out = []
    for i in range(STEPS):
        batch = jax.tree.map(jnp.asarray, batch_np(jc, seed=i % 3))
        state, metrics = step(state, frozen, batch)
        out.append((jax.tree.map(np.asarray, state.trainable), float(metrics["loss"]),
                    float(metrics["grad_norm"])))
    return out


@pytest.mark.parametrize("case_name", list(CASES))
def test_train_step_matches_optax(case_name):
    jc, tc, _, trainable, tfrozen, ttrain = model(False, "attention")
    case = CASES[case_name]
    ttx = optimizer(topt, case, ttrain)
    step = tts.make_train_step(tc, ttx)
    state = tts.create_train_state(ttrain, ttx)
    assert state.trainable["lora"]["layers"][0]["q_proj"]["a"] is not \
        ttrain["lora"]["layers"][0]["q_proj"]["a"]  # the state owns its leaves
    start_audio = [t.clone() for t in topt.tree_leaves(ttrain["mergers"]["audio"])]
    for i, (want_tree, want_loss, want_norm) in enumerate(jax_run(case_name)):
        state, metrics = step(state, tfrozen, to_torch(batch_np(tc, seed=i % 3)))
        assert state.step == i + 1
        np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)
        for got, want in zip(topt.tree_leaves(state.trainable), topt.tree_leaves(want_tree)):
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    moved = [not torch.equal(a, b) for a, b in
             zip(start_audio, topt.tree_leaves(state.trainable["mergers"]["audio"]))]
    assert not any(moved) if case["freeze"] else all(moved)
    if case["accum_steps"] > 1:
        assert state.opt_state["count"] == STEPS // case["accum_steps"]


def test_freeze_mask_from_flags_matches_jax():
    _, _, _, trainable, _, ttrain = model(False, "attention")
    flags = {"frozen_llm": True, "frozen_video_Qformer": True, "frozen_video_proj": True,
             "frozen_au_proj": True}
    want = jopt.freeze_mask_from_flags(trainable, flags)
    got = topt.freeze_mask_from_flags(ttrain, flags)
    assert topt.tree_leaves(got) == [bool(x) for x in jax.tree.leaves(want)]
    assert got["mergers"]["video"]["proj"]["w"] is False
    assert got["mergers"]["audio"]["proj"]["w"] is True


def test_no_decay_mask_keeps_vectors_out():
    _, _, _, _, _, ttrain = model(False, "attention")
    mask = topt._no_decay_mask(ttrain)
    assert mask["mergers"]["video"]["proj"]["w"] and not mask["mergers"]["video"]["proj"]["b"]
