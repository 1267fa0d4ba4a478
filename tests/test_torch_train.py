"""The port's training forward against the JAX package, and its train-mode
dropout on its own.

`affectgpt.forward_loss` and its trainable gradients against JAX's
`jax.value_and_grad(forward_loss)` on the same batch with dropout off, in
f32 at tiny geometry (2 layers), weights from a numpy seed through
`convert.from_jax`: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (the
same f32 math, summed in another order). Cases: remat False / True /
"dots", tied and untied lm_head (the fused loss, and the plain one), the
attention and the qformer mergers, a batch with -100 labels and a padded
attention mask.

JAX draws its masks from rbg and the port from torch's generators, so
train-mode dropout is held to its keep rate (within 4 sigma) and 1/(1-p)
scaling, determinism per key, remat invariance, the DROPOUT_VJP branch
against plain autograd, and to changing the output only in train mode.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert, nn
from affectgpt_tpu_torch.models import qformer as tqf
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.training import optim

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, T = 3, 24
OFFSETS = {"multi": 1, "audio": 3, "face": 6, "frame": 9}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: ops this small gain nothing from more, and in a
    parallel test run more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_tree(tree, rng, scale: float):
    """A tree of the same structure with values from `rng`: norm scales
    1 + noise, every other leaf noise · scale."""
    def leaf(path, x):
        noise = rng.standard_normal(np.shape(x)).astype(np.float32)
        if str(getattr(path[-1], "key", "")) == "scale":
            return 1.0 + 0.1 * noise
        return noise * scale
    return jax.tree_util.tree_map_with_path(leaf, tree)


def configs(tied: bool, fusion: str):
    kw = dict(video_fusion_type=fusion, audio_fusion_type=fusion, multi_fusion_type=fusion)
    jc = dataclasses.replace(ja.AffectGPTConfig.tiny(), **kw)
    tc = dataclasses.replace(ta.AffectGPTConfig.tiny(), **kw)
    jc = dataclasses.replace(jc, llm=dataclasses.replace(jc.llm, tie_embeddings=tied))
    tc = dataclasses.replace(tc, llm=dataclasses.replace(tc.llm, tie_embeddings=tied))
    return jc, tc


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def model(tied: bool, fusion: str):
    jc, tc = configs(tied, fusion)
    rng = np.random.RandomState(0)
    # the shapes alone (nothing is computed): numpy_tree replaces every value
    frozen, trainable = jax.eval_shape(
        lambda: (ja.init_frozen(jax.random.PRNGKey(0), jc, dtype=jnp.float32),
                 ja.init_trainable(jax.random.PRNGKey(1), jc)))
    frozen = numpy_tree(frozen, rng, 0.1)
    trainable = numpy_tree(trainable, rng, 0.1)
    tfrozen, ttrain = convert.from_jax(frozen, trainable, tc, device="cpu")
    return jc, tc, frozen, trainable, tfrozen, ttrain


def batch_np(cfg, seed: int = 0):
    """input_ids with patch runs zeroed, labels -100 over the prompt and the
    patch runs, the second row padded at its last 4 positions."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.llm.vocab_size, (B, T)).astype(np.int32)
    labels = ids.copy()
    for m, off in OFFSETS.items():
        q = cfg.num_query_tokens(m)
        ids[:, off:off + q] = 0
        labels[:, off:off + q] = -100
    labels[:, :T // 2] = -100
    mask = np.ones((B, T), np.float32)
    mask[1, -4:] = 0
    labels[1, -4:] = -100
    return {
        "input_ids": ids, "attention_mask": mask, "labels": labels,
        "features": {"frame": rng.randn(B, 8, cfg.visual_dim).astype(np.float32),
                     "face": rng.randn(B, 8, cfg.visual_dim).astype(np.float32),
                     "audio": rng.randn(B, 8, cfg.acoustic_dim).astype(np.float32)},
        "offsets": {m: np.full((B,), off, np.int32) for m, off in OFFSETS.items()},
    }


def to_torch(tree):
    return convert.tree_to_torch(tree, "cpu")


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(tied: bool, fusion: str):
    jc, _, frozen, trainable, _, _ = model(tied, fusion)
    batch = jax.tree.map(jnp.asarray, batch_np(jc))
    fn = jax.jit(jax.value_and_grad(lambda tr: ja.forward_loss(frozen, tr, jc, batch)))
    loss, grads = fn(trainable)
    return float(loss), jax.tree.map(np.asarray, grads)


def torch_loss_and_grads(tied: bool, fusion: str, remat=False, dropout_rng=None):
    _, tc, _, _, tfrozen, ttrain = model(tied, fusion)
    train = optim.tree_map(lambda t: t.clone().requires_grad_(True), ttrain)
    loss = ta.forward_loss(tfrozen, train, tc, to_torch(batch_np(tc)), remat=remat,
                           dropout_rng=dropout_rng)
    leaves = optim.tree_leaves(train)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


@pytest.mark.parametrize("fusion", ["attention", "qformer"])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("remat", [False, True, "dots"], ids=["remat0", "remat1", "dots"])
def test_forward_loss_and_grads_match_jax(remat, tied, fusion):
    want_loss, want_grads = jax_loss_and_grads(tied, fusion)
    loss, grads = torch_loss_and_grads(tied, fusion, remat=remat)
    np.testing.assert_allclose(float(loss), want_loss, **LOSS_TOL)
    want = optim.tree_leaves(want_grads)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, **GRAD_TOL)
    # the LoRA factors and the mergers reached by the batch get gradients
    assert sum(bool(g.abs().sum() > 0) for g in grads) > len(grads) // 2


def test_plain_loss_on_a_quantized_lm_head_matches_jax():
    """A quantized lm_head takes the plain loss over its logits in both
    packages (forward_loss's other branch)."""
    jc, tc, frozen, trainable, tfrozen, ttrain = model(False, "attention")
    jfrozen = {**frozen, "llm": jq.quantize_params(frozen["llm"])}
    tfrozen_q = {**tfrozen, "llm": to_torch(jax.tree.map(np.asarray, jfrozen["llm"]))}
    batch = batch_np(jc)
    want = jax.jit(lambda tr: ja.forward_loss(jfrozen, tr, jc, jax.tree.map(jnp.asarray, batch)))(
        trainable)
    got = ta.forward_loss(tfrozen_q, ttrain, tc, to_torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fused_loss_matches_plain_and_jax_over_ragged_chunks(tied):
    """chunk 64 over a vocab of 300: four full chunks and a ragged last one
    of 44; loss and the hidden states' gradient against the plain loss of
    the full logits, and the loss against JAX's fused loss at that chunk."""
    jc, tc, frozen, _, tfrozen, _ = model(tied, "attention")
    rng = np.random.RandomState(3)
    hidden = rng.randn(B, T, tc.llm.hidden_size).astype(np.float32)
    labels = batch_np(tc)["labels"]
    h1 = torch.from_numpy(hidden).requires_grad_(True)
    fused = tq.fused_cross_entropy_loss(h1, tfrozen["llm"], tc.llm, torch.from_numpy(labels),
                                        chunk=64)
    (g1,) = torch.autograd.grad(fused, h1)
    h2 = torch.from_numpy(hidden).requires_grad_(True)
    plain = tq.cross_entropy_loss(tq._logits(tfrozen["llm"], tc.llm, h2),
                                  torch.from_numpy(labels))
    (g2,) = torch.autograd.grad(plain, h2)
    np.testing.assert_allclose(float(fused.detach()), float(plain.detach()), rtol=1e-6)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=1e-5, atol=1e-7)
    want = jq.fused_cross_entropy_loss(jnp.asarray(hidden), frozen["llm"], jc.llm,
                                       jnp.asarray(labels), chunk=64)
    np.testing.assert_allclose(float(fused.detach()), float(want), rtol=1e-6)


def test_dropout_keep_rate_scaling_and_determinism():
    x = torch.ones(200_000)
    rate = 0.1
    y = nn.dropout((7, 3), rate, x)
    kept = y != 0
    n = x.numel()
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - rate)) < 4 * sigma
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0) / torch.tensor(1 - rate))
    assert torch.equal(nn.dropout((7, 3), rate, x), y)  # same key, same mask
    assert not torch.equal(nn.dropout((7, 4), rate, x), y)  # another key, another mask
    assert nn.fold_in((7,), 3) == (7, 3)


def dropout_grads(remat):
    return torch_loss_and_grads(False, "qformer", remat=remat, dropout_rng=(42, 5))


def test_remat_is_invariant_with_dropout_on():
    """The masks are drawn from the key's ints inside the recomputed layer,
    so remat True and "dots" give the loss and gradients of remat False."""
    loss0, grads0 = dropout_grads(False)
    for remat in (True, "dots"):
        loss, grads = dropout_grads(remat)
        assert torch.equal(loss, loss0)
        for g, g0 in zip(grads, grads0):
            torch.testing.assert_close(g, g0, rtol=1e-6, atol=1e-9)


def test_dropout_changes_the_loss_and_only_in_train_mode():
    eval_loss, _ = torch_loss_and_grads(False, "qformer")
    train_loss, _ = dropout_grads(False)
    assert float(train_loss) != float(eval_loss)
    want_loss, _ = jax_loss_and_grads(False, "qformer")
    np.testing.assert_allclose(float(eval_loss), want_loss, **LOSS_TOL)


def test_dropout_vjp_branch_matches_autograd(monkeypatch):
    """DROPOUT_VJP's backward regenerates the mask: the same loss bit for
    bit, and the gradients of plain autograd up to summation order."""
    loss0, grads0 = torch_loss_and_grads(False, "attention", dropout_rng=(9,))
    monkeypatch.setattr(tq, "DROPOUT_VJP", True)
    loss1, grads1 = torch_loss_and_grads(False, "attention", dropout_rng=(9,))
    loss2, _ = torch_loss_and_grads(False, "attention", dropout_rng=(9,), remat=True)
    assert torch.equal(loss0, loss1) and torch.equal(loss1, loss2)
    for g0, g1 in zip(grads0, grads1):
        torch.testing.assert_close(g1, g0, rtol=1e-5, atol=1e-7)


def test_lora_drop_branch_bf16_against_autograd():
    """The custom backward in bf16 (the card's dtype) against autograd of
    the same forward in f32 on the upcast operands: within bf16 rounding."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 6, 32).astype(np.float32))
    a = torch.from_numpy(rng.randn(32, 4).astype(np.float32) * 0.2)
    b = torch.from_numpy(rng.randn(4, 16).astype(np.float32) * 0.2)
    g = torch.from_numpy(rng.randn(4, 6, 16).astype(np.float32))
    key, rate = (1, 2), 0.25

    def run(fn, dtype):
        xs = x.to(dtype).requires_grad_(True)
        ap, bp = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = fn(xs, ap, bp)
        return y, torch.autograd.grad(y, (xs, ap, bp), g.to(y.dtype))

    def plain(xs, ap, bp):
        z = nn.matmul_f32(nn.dropout(key, rate, xs), ap.to(xs.dtype))
        return nn.matmul_f32(z.to(xs.dtype), bp.to(xs.dtype))

    def branch(xs, ap, bp):
        return tq._LoraDropBranch.apply(xs, ap, bp, key, rate)

    y_ref, grads_ref = run(plain, torch.float32)
    y, grads = run(branch, torch.bfloat16)
    torch.testing.assert_close(y, y_ref, rtol=2e-2, atol=2e-2)
    for got, want in zip(grads, grads_ref):
        torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)


def test_matmul_f32_backward_in_bf16():
    """`_MatmulF32` (the card's bf16 route; here its CPU twin): dx is the
    f32 sum of g @ w^T rounded to bf16, dw that of x^T @ g."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(5, 7, 24).astype(np.float32)).bfloat16().requires_grad_(True)
    w = torch.from_numpy(rng.randn(24, 12).astype(np.float32)).bfloat16().requires_grad_(True)
    g = torch.from_numpy(rng.randn(5, 7, 12).astype(np.float32))
    y = nn.matmul_f32(x, w)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad(y, (x, w), g)
    gb = g.bfloat16().float().reshape(-1, 12)
    want_dx = (gb @ w.detach().float().t()).bfloat16().reshape(x.shape)
    want_dw = (x.detach().float().reshape(-1, 24).t() @ gb).bfloat16()
    assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)


def test_mha_probs_drop_changes_output_only_in_train_mode():
    rng = np.random.RandomState(4)
    g = torch.Generator().manual_seed(0)
    params = nn.mha_init(g, 16, 16, 2)
    x = torch.from_numpy(rng.randn(2, 200, 16).astype(np.float32))
    eval_out = nn.mha(params, x, x, 2)
    train_out = nn.mha(params, x, x, 2, probs_drop=((3,), 0.5))
    assert not torch.allclose(eval_out, train_out)
    assert torch.equal(nn.mha(params, x, x, 2, probs_drop=((3,), 0.5)), train_out)


def test_qformer_dropouts_change_output_only_in_train_mode():
    cfg = tqf.QFormerConfig.tiny()
    params = tqf.init_params(torch.Generator().manual_seed(0), cfg)
    enc = torch.randn(2, 5, cfg.encoder_width, generator=torch.Generator().manual_seed(1))
    eval_out = tqf.apply(params, cfg, enc)
    assert torch.equal(tqf.apply(params, cfg, enc), eval_out)
    train_out = tqf.apply(params, cfg, enc, dropout_rng=(1,))
    assert not torch.allclose(train_out, eval_out)
    assert torch.equal(tqf.apply(params, cfg, enc, dropout_rng=(1,)), train_out)
    off = dataclasses.replace(cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    assert torch.equal(tqf.apply(params, off, enc, dropout_rng=(1,)), eval_out)
