"""The toolkit's trainable towers in the port against the JAX package, in f32
on the CPU: `e2e.apply` (CLIP ViT + HuBERT + the fusion head) and its
gradients within 1e-4; VideoMAE's `tube_patchify` exactly, its loss and
gradients under JAX's own tube order, and `encode_video`, within 1e-4; a
few Adam steps of each lower the loss. The route rule for trainable towers:
under autograd with leaves or inputs that require grad, CLIP's blocks,
HuBERT's layers and `nn.mha` take the plain chain (their kernel wrappers are
not called), under `no_grad` they call the wrappers as before; a direct
wrapper call under grad still raises, and f32 operands reaching a kernel
launch raise TypeError."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.toolkit import e2e as je2e
from affectgpt_tpu.toolkit import videomae as jvmae
from affectgpt_tpu_torch.models import clip_vit, convert, hubert, nn
from affectgpt_tpu_torch.ops import _build, vit_attention, vit_mlp, vit_sublayer
from affectgpt_tpu_torch.toolkit import e2e, videomae
from affectgpt_tpu_torch.training import optim

TOL = dict(rtol=1e-4, atol=1e-4)


def numpy_tree(shapes, seed: int):
    """Leaves of JAX's tree drawn with numpy: N(0, 0.1²), scales around 1."""
    rng = np.random.RandomState(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, leaf in paths:
        x = rng.randn(*leaf.shape).astype(np.float32) * 0.1
        leaves.append(x + 1.0 if path[-1] == jax.tree_util.DictKey("scale") else x)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def leaf_grads(params, loss_fn):
    leaves = optim.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(params)
    return loss, torch.autograd.grad(loss, leaves, allow_unused=True)


def adam_step(tx, state, params, grads):
    """One optimizer step; leaves the loss does not reach get zeros."""
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(optim.tree_leaves(params), grads)]
    return tx.apply(optim.tree_unflatten(params, grads), state, params)


def assert_grads_close(params, grads, jgrads):
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for path, got, want in zip(optim.tree_paths(params), grads, jleaves):
        got = np.zeros(want.shape, np.float32) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), err_msg=path, **TOL)


def counted(monkeypatch, module, name: str, calls: list):
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append(name)
        return original(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


# -- e2e ---------------------------------------------------------------------------

E2E_KW = dict(text_dim=12, hidden_dim=16, output_dim1=4)


def e2e_case():
    jcfg = je2e.E2EConfig(**E2E_KW)
    cfg = e2e.E2EConfig(**E2E_KW)
    tree = numpy_tree(jax.eval_shape(lambda k: je2e.init_params(k, jcfg), jax.random.PRNGKey(0)),
                      seed=1)
    rng = np.random.RandomState(0)
    batch = {"frames": rng.randn(2, 2, 28, 28, 3).astype(np.float32),
             "audios": rng.randn(2, 2, 1, 800).astype(np.float32),
             "texts": rng.randn(2, 12).astype(np.float32)}
    return jcfg, cfg, tree, batch


def test_e2e_config_matches_jax():
    assert [f.name for f in dataclasses.fields(e2e.E2EConfig)] == \
        [f.name for f in dataclasses.fields(je2e.E2EConfig)]
    assert dataclasses.asdict(e2e.E2EConfig()) == dataclasses.asdict(je2e.E2EConfig())
    assert dataclasses.asdict(e2e.E2EConfig().fusion_args()) == \
        dataclasses.asdict(je2e.E2EConfig().fusion_args())
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: je2e.init_params(k, je2e.E2EConfig()), jax.random.PRNGKey(0)))[0]
    got = jax.tree_util.tree_flatten_with_path(
        e2e.init_params(torch.Generator().manual_seed(0), e2e.E2EConfig()))[0]
    assert [(p, x.shape, str(x.dtype)) for p, x in want] == \
        [(p, tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in got]


def test_e2e_apply_and_grads_match_jax(monkeypatch):
    """Eval forward under no_grad (CLIP's blocks through the kernel
    wrappers' plain versions) and the autograd forward (the plain chain,
    no wrapper called) both within 1e-4 of JAX, with every gradient."""
    jcfg, cfg, tree, batch = e2e_case()
    jbatch = jax.tree.map(jnp.asarray, batch)
    w = np.random.RandomState(3).randn(2, 4).astype(np.float32)

    def jloss(p):
        out = je2e.apply(p, jcfg, jbatch)
        return jnp.sum(out[1] * w) + jnp.sum(out[2]), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(tree)
    calls = []
    for module, name in ((vit_sublayer, "apply"), (vit_mlp, "apply"),
                         (vit_attention, "fused_self_attention")):
        counted(monkeypatch, module, name, calls)
    params = convert.tree_to_torch(tree, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = e2e.apply(params, cfg, tbatch)
    assert calls.count("apply") == 2 * cfg.vision.num_layers
    for got, want in zip(out, jout):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    calls.clear()

    def loss_fn(p):
        _, emos, vals, _ = e2e.apply(p, cfg, tbatch)
        return (emos * torch.from_numpy(w)).sum() + vals.sum()

    _, grads = leaf_grads(params, loss_fn)
    assert calls == []
    assert_grads_close(params, grads, jgrads)


def test_e2e_trains_its_towers():
    """Five Adam steps through both towers lower the loss and move CLIP's
    patch embedding (JAX's e2e test, on the port)."""
    cfg = e2e.E2EConfig(**E2E_KW)
    params = e2e.init_params(torch.Generator().manual_seed(0), cfg)
    _, _, _, batch = e2e_case()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    labels = torch.tensor([0, 3])
    tx = optim.AdamW(schedule=lambda _s: 1e-3, weight_decay=0.0)
    state = tx.init(params)
    before = params["visual"]["patch_embed"]["w"].clone()
    losses = []
    for _ in range(5):
        loss, grads = leaf_grads(params, lambda p: torch.nn.functional.cross_entropy(
            e2e.apply(p, cfg, tbatch)[1], labels))
        state = adam_step(tx, state, params, grads)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert not torch.equal(before, params["visual"]["patch_embed"]["w"])


def test_e2e_dropout_keys():
    cfg = dataclasses.replace(e2e.E2EConfig(**E2E_KW), dropout=0.5)
    params = e2e.init_params(torch.Generator().manual_seed(0), cfg)
    _, _, _, batch = e2e_case()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        eval_feats = e2e.apply(params, cfg, tbatch)[0]
        a = e2e.apply(params, cfg, tbatch, train_rng=(1,))[0]
        assert torch.equal(e2e.apply(params, cfg, tbatch, train_rng=(1,))[0], a)
        assert not torch.equal(a, eval_feats)
        assert not torch.equal(e2e.apply(params, cfg, tbatch, train_rng=(2,))[0], a)


# -- VideoMAE -----------------------------------------------------------------------

VCFG = videomae.VideoMAEConfig.tiny()


def vmae_case(b=2):
    jcfg = jvmae.VideoMAEConfig.tiny()
    tree = numpy_tree(jax.eval_shape(lambda k: jvmae.init_params(k, jcfg),
                                     jax.random.PRNGKey(0)), seed=2)
    video = np.random.RandomState(1).rand(b, 4, 32, 32, 3).astype(np.float32)
    return jcfg, tree, video


def test_videomae_config_matches_jax():
    for preset in ("__call__", "tiny"):
        make = (lambda c: c()) if preset == "__call__" else (lambda c: c.tiny())
        p, j = make(videomae.VideoMAEConfig), make(jvmae.VideoMAEConfig)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert (p.num_patches, p.patch_dim, p.num_visible) == \
            (j.num_patches, j.patch_dim, j.num_visible)
    assert videomae.VideoMAEConfig().num_patches == 1568


def test_tube_patchify_matches_jax():
    jcfg, _, video = vmae_case()
    want = np.asarray(jvmae.tube_patchify(jnp.asarray(video), jcfg))
    got = videomae.tube_patchify(torch.from_numpy(video), VCFG).numpy()
    assert got.shape == (2, VCFG.num_patches, VCFG.patch_dim)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fold", [0, 1])
def test_pretrain_loss_and_grads_under_jax_order(fold):
    """The loss and every gradient under the tube order JAX draws inside
    `pretrain_loss` (argsort of uniform(rng, (b, n)))."""
    jcfg, tree, video = vmae_case()
    rng = jax.random.fold_in(jax.random.PRNGKey(2), fold)
    order = np.array(jnp.argsort(jax.random.uniform(rng, (2, jcfg.num_patches)), axis=1))
    jloss, jgrads = jax.value_and_grad(
        lambda p: jvmae.pretrain_loss(p, jcfg, jnp.asarray(video), rng))(tree)
    params = convert.tree_to_torch(tree, "cpu")
    loss, grads = leaf_grads(params, lambda p: videomae.loss_from_order(
        p, VCFG, torch.from_numpy(video), torch.from_numpy(order)))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    assert_grads_close(params, grads, jgrads)


def test_encode_video_matches_jax():
    jcfg, tree, video = vmae_case(b=3)
    want = np.asarray(jvmae.encode_video(jax.tree.map(jnp.asarray, tree), jcfg,
                                         jnp.asarray(video)))
    with torch.no_grad():
        got = videomae.encode_video(convert.tree_to_torch(tree, "cpu"), VCFG,
                                    torch.from_numpy(video))
    assert got.shape == (3, VCFG.width)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pretrain_loss_decreases_and_order_is_per_key():
    params = videomae.init_params(torch.Generator().manual_seed(0), VCFG)
    video = torch.from_numpy(vmae_case()[2])
    order = videomae.tube_order((2, 0), 2, VCFG.num_patches, "cpu")
    assert torch.equal(order, videomae.tube_order((2, 0), 2, VCFG.num_patches, "cpu"))
    assert not torch.equal(order, videomae.tube_order((2, 1), 2, VCFG.num_patches, "cpu"))
    assert torch.equal(order.sort(dim=1).values, torch.arange(VCFG.num_patches).expand(2, -1))
    tx = optim.AdamW(schedule=lambda _s: 1e-3, weight_decay=0.0)
    state = tx.init(params)
    losses = []
    for i in range(15):
        loss, grads = leaf_grads(params, lambda p: videomae.pretrain_loss(p, VCFG, video,
                                                                          (2, i % 3)))
        state = adam_step(tx, state, params, grads)
        losses.append(loss.item())
    assert losses[-1] < losses[0]


# -- the route rule for trainable towers ------------------------------------------------


def _mha_params(dim=16):
    g = torch.Generator().manual_seed(4)
    return nn.mha_init(g, dim, dim, 2)


@pytest.mark.parametrize("trainable", ["params", "input", "none"])
def test_mha_routes_trainable_attention_to_the_plain_chain(monkeypatch, trainable):
    """192 tokens: the fused route under no_grad; under grad with params or
    input requiring grad, the plain chain (the same values, a gradient)."""
    calls = []
    counted(monkeypatch, vit_attention, "fused_self_attention", calls)
    params = _mha_params()
    x = torch.randn(1, 192, 16, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        fused = nn.mha(params, x, x, 2)
    assert calls == ["fused_self_attention"]
    if trainable == "params":
        for leaf in optim.tree_leaves(params):
            leaf.requires_grad_(True)
    elif trainable == "input":
        x.requires_grad_(True)
    out = nn.mha(params, x, x, 2)
    assert calls == ["fused_self_attention"] * (2 if trainable == "none" else 1)
    np.testing.assert_allclose(out.detach().numpy(), fused.numpy(), **TOL)
    assert nn.needs_grad(params, x) == (trainable != "none")
    if trainable != "none":
        out.sum().backward()


@pytest.mark.parametrize("grad", [False, True])
def test_towers_route_trainable_blocks_to_the_plain_chain(monkeypatch, grad):
    """CLIP's blocks under the default switches and HuBERT's layers under the
    kernel switches call the kernel wrappers under no_grad and none of them
    when their leaves require grad."""
    monkeypatch.setattr(hubert, "ATTN_IMPL", "sublayer")
    monkeypatch.setattr(hubert, "MLP_IMPL", "pallas")
    calls = []
    for module, name in ((vit_sublayer, "apply"), (vit_mlp, "apply"),
                         (vit_mlp, "apply_hubert")):
        counted(monkeypatch, module, name, calls)
    g = torch.Generator().manual_seed(6)
    vcfg, acfg = clip_vit.ClipVisionConfig.tiny(), hubert.HubertConfig.tiny()
    vis = clip_vit.init_vision_params(g, vcfg, dtype=torch.float32)
    aud = hubert.init_params(g, acfg, dtype=torch.float32)
    images = torch.randn(2, 28, 28, 3, generator=g)
    clips = torch.randn(1, 2, 1, 800, generator=g)
    for leaf in optim.tree_leaves(vis) + optim.tree_leaves(aud):
        leaf.requires_grad_(grad)
    with torch.set_grad_enabled(True):
        v = clip_vit.encode_image(vis, vcfg, images)
        a = hubert.encode_clips(aud, acfg, clips)
    want = [] if grad else ["apply"] * 2 * vcfg.num_layers + \
        ["apply", "apply_hubert"] * acfg.num_layers
    assert sorted(calls) == sorted(want)
    assert v.requires_grad == a.requires_grad == grad


def test_kernels_stay_loud():
    """A direct wrapper call under grad with an operand off the CPU raises
    (no backward); f32 operands at a kernel launch raise TypeError (no
    dtype fallback)."""
    q = torch.empty(1, 2, 256, 64, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        vit_attention.fused_vit_attention(q, q, q, valid_len=256)
    f32 = torch.empty(1, 2, 256, 64, device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        vit_attention._attention(f32, f32, f32, 256, f32)
    with pytest.raises(TypeError, match="bfloat16"):
        _build.check_bf16_operands("attn_sublayer", f32.device, [(f32, f32.shape)])
