"""The training forward's numerics on the CPU: remat="dots" against
remat=False, and the port's bf16 gradients against JAX's.

- remat="dots" recomputes the segments between the products under
  checkpoints of their own and runs no selective-checkpoint dispatch mode:
  its loss and every trainable gradient equal remat=False's bit for bit,
  with dropout off and on, tied and untied, on both merger types. Any
  other truthy remat is full remat, one checkpoint a layer.
- bf16 against f32: the same inputs go through JAX's
  `jax.grad(affectgpt.forward_loss)` and the port's `forward_loss` with the
  frozen weights and features in bf16 and in f32 (trainable leaves f32, as
  the smoke's gate 3 runs them), 2 layers at narrow widths (hidden 128,
  features 96 / 128, b = 2, t = 48 with labels on the last 16 positions).
  Each leaf's relative L2 error of bf16 against f32 is a rounding noise
  that one seed can make large for a small cancelling sum (the attention
  merger's 1-element bias), so the errors are taken as the root mean square
  over SEEDS draws of the weights, features and ids. The port's must be at
  most MARGIN times JAX's, leaf by leaf and over the whole gradient.

Run as a script, it prints each leaf's root mean square error in both
packages:  JAX_PLATFORMS=cpu python tests/test_torch_train_numerics.py
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as torch_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from affectgpt_tpu.models import affectgpt as ja  # noqa: E402
from affectgpt_tpu_torch.models import affectgpt as ta  # noqa: E402
from affectgpt_tpu_torch.models import convert  # noqa: E402
from affectgpt_tpu_torch.training import optim  # noqa: E402
from tests.test_torch_train import numpy_tree, torch_loss_and_grads  # noqa: E402

SEEDS = 64
MARGIN = 1.25  # the port's RMS error at most 25% above JAX's
B, T, LABELS = 2, 48, 16
OFFSETS = {"multi": 2, "audio": 5, "face": 10, "frame": 14}
LLM = dict(hidden_size=128, intermediate_size=256, num_heads=8, num_kv_heads=2, head_dim=16)
FEATS = dict(visual_dim=96, acoustic_dim=128)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: ops this small gain nothing from more, and in a
    parallel test run more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dropout_rng", [None, (42, 5)], ids=["eval", "dropout"])
@pytest.mark.parametrize("fusion", ["attention", "qformer"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_dots_gives_remat_false_bits(tied, fusion, dropout_rng, monkeypatch):
    def no_dispatch_mode(*_, **__):
        raise AssertionError("remat='dots' entered a selective-checkpoint dispatch mode")

    monkeypatch.setattr(torch_checkpoint, "create_selective_checkpoint_contexts",
                        no_dispatch_mode)
    loss0, grads0 = torch_loss_and_grads(tied, fusion, remat=False, dropout_rng=dropout_rng)
    loss, grads = torch_loss_and_grads(tied, fusion, remat="dots", dropout_rng=dropout_rng)
    assert torch.equal(loss, loss0)
    assert all(torch.equal(g, g0) for g, g0 in zip(grads, grads0))


@pytest.mark.parametrize("remat", [True, 1], ids=["True", "truthy"])
def test_truthy_remat_checkpoints_every_layer(remat, monkeypatch):
    """Any truthy remat other than "dots" is full remat, as in JAX's forward
    (qwen2.py:1040): one checkpoint a layer beyond remat=False's."""
    calls = []
    wrapped = torch_checkpoint.checkpoint
    monkeypatch.setattr(torch_checkpoint, "checkpoint",
                        lambda fn, *a, **k: calls.append(fn) or wrapped(fn, *a, **k))
    loss0, grads0 = torch_loss_and_grads(False, "attention", remat=False)
    plain = len(calls)
    loss, grads = torch_loss_and_grads(False, "attention", remat=remat)
    assert len(calls) - 2 * plain == ta.AffectGPTConfig.tiny().llm.num_layers
    assert torch.equal(loss, loss0)
    assert all(torch.equal(g, g0) for g, g0 in zip(grads, grads0))


def configs():
    jc, tc = ja.AffectGPTConfig.tiny(), ta.AffectGPTConfig.tiny()
    jc = dataclasses.replace(jc, **FEATS, llm=dataclasses.replace(jc.llm, **LLM))
    tc = dataclasses.replace(tc, **FEATS, llm=dataclasses.replace(tc.llm, **LLM))
    return jc, tc


@functools.lru_cache(maxsize=None)
def shapes():
    """The shapes of JAX's frozen and trainable trees at configs()'s
    geometry (nothing is computed): draw() fills them with its own values."""
    jc = configs()[0]
    return jax.eval_shape(lambda: (ja.init_frozen(jax.random.PRNGKey(0), jc, dtype=jnp.float32),
                                   ja.init_trainable(jax.random.PRNGKey(1), jc)))


def draw(jc, seed: int):
    """Weights (numpy, f32), a trainable tree and a batch from `seed`."""
    rng = np.random.RandomState(seed)
    frozen_init, trainable_init = shapes()
    frozen = numpy_tree(frozen_init, rng, 0.05)
    trainable = numpy_tree(trainable_init, rng, 0.05)
    ids = rng.randint(1, jc.llm.vocab_size, (B, T)).astype(np.int32)
    labels = np.full_like(ids, -100)
    labels[:, -LABELS:] = ids[:, -LABELS:]
    for m, off in OFFSETS.items():
        ids[:, off:off + jc.num_query_tokens(m)] = 0
    dims = {"frame": jc.visual_dim, "face": jc.visual_dim, "audio": jc.acoustic_dim}
    batch = {"input_ids": ids, "attention_mask": np.ones((B, T), np.float32), "labels": labels,
             "features": {m: rng.randn(B, 8, d).astype(np.float32) for m, d in dims.items()},
             "offsets": {m: np.full((B,), off, np.int32) for m, off in OFFSETS.items()}}
    return frozen, trainable, batch


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(np.asarray(got, np.float32) - want)
                 / max(np.linalg.norm(want), 1e-30))


def whole_err(got: list, want: list) -> float:
    return rel_err(np.concatenate([np.ravel(g) for g in got]),
                   np.concatenate([np.ravel(w) for w in want]))


@functools.lru_cache(maxsize=None)
def errors():
    """(leaf paths, JAX's errors [SEEDS, leaves + 1], the port's): each
    seed's bf16-against-f32 relative L2 error per leaf, the whole gradient
    last."""
    jc, tc = configs()
    jgrad = jax.jit(jax.grad(lambda tr, fz, bt: ja.forward_loss(fz, tr, jc, bt)))

    def jax_grads(frozen, trainable, batch, dtype):
        fz = jax.tree.map(lambda x: jnp.asarray(x, dtype), frozen)
        bt = jax.tree.map(jnp.asarray, batch)
        bt["features"] = {m: v.astype(dtype) for m, v in bt["features"].items()}
        return optim.tree_leaves(jax.tree.map(np.asarray, jgrad(trainable, fz, bt)))

    def port_grads(frozen, trainable, batch, dtype):
        fz = optim.tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, frozen)
        bt = convert.tree_to_torch(batch, "cpu")
        bt["features"] = {m: v.to(dtype) for m, v in bt["features"].items()}
        leaves = [t.clone().requires_grad_(True) for t in optim.tree_leaves(trainable)]
        loss = ta.forward_loss(fz, optim.tree_unflatten(trainable, leaves), tc, bt)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [np.zeros(tuple(p.shape), np.float32) if g is None else g.float().numpy()
                for p, g in zip(leaves, grads)]

    jax_errs, port_errs, names = [], [], None
    for seed in range(SEEDS):
        frozen, trainable, batch = draw(jc, seed)
        tfrozen, ttrain = convert.from_jax(frozen, trainable, tc, device="cpu")
        names = optim.tree_paths(ttrain)
        runs = ((jax_grads, (frozen, trainable), (jnp.bfloat16, jnp.float32), jax_errs),
                (port_grads, (tfrozen, ttrain), (torch.bfloat16, torch.float32), port_errs))
        for grads, trees, (bf16, f32), out in runs:
            g16, g32 = grads(*trees, batch, bf16), grads(*trees, batch, f32)
            out.append([rel_err(a, b) for a, b in zip(g16, g32)] + [whole_err(g16, g32)])
    return names + ["(all)"], np.asarray(jax_errs), np.asarray(port_errs)


def rms(errs: np.ndarray) -> np.ndarray:
    return np.sqrt((errs ** 2).mean(axis=0))


def test_bf16_gradients_err_no_more_than_jax():
    names, jax_errs, port_errs = errors()
    j, p = rms(jax_errs), rms(port_errs)
    assert np.all(np.isfinite(p)) and p[-1] > 0  # bf16 differs from f32 at all
    worse = {n: (float(a), float(b)) for n, a, b in zip(names, j, p) if b > MARGIN * a}
    assert not worse, worse


if __name__ == "__main__":
    names, jax_errs, port_errs = errors()
    jc, tc = configs()
    trainable = convert.from_jax(*draw(jc, 0)[:2], tc, device="cpu")[1]
    sizes = {n: t.numel() for n, t in zip(optim.tree_paths(trainable),
                                          optim.tree_leaves(trainable))}
    rows = zip(names, rms(jax_errs), rms(port_errs), jax_errs.max(0), port_errs.max(0))
    for n, a, b, jm, pm in sorted(rows, key=lambda r: -r[2]):
        print(f"{n:40s} {sizes.get(n, 0):7d}  rms jax {a:.4f} port {b:.4f}  "
              f"max jax {jm:.4f} port {pm:.4f}")
