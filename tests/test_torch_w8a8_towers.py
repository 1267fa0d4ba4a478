"""The encoder towers' int8 serving mode in the port against the JAX
package, in f32 on the CPU: `dense_w8a8_xla` against JAX's compiled function
(JAX's callers run it compiled, where XLA multiplies by f32(1/127) for the
division by 127 and contracts the bias add into an FMA), the leaves of
`quantize_encoder_tree`, the `w_q` branch of nn.dense / dense_nobias, and the
tiny CLIP vision tower and HuBERT on `w_q` trees under every switch value
(features within 1e-4 of JAX's compiled towers). A `w_q` CLIP block leaves
the sublayer route for "flash" (the fused attention, the plain MLP) and
HuBERT stays on the plain stack: no other encoder kernel is reached."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.models import clip_vit as jclip
from affectgpt_tpu.models import hubert as jhub
from affectgpt_tpu.models import nn as jnn
from affectgpt_tpu.ops import quant as jquant
from affectgpt_tpu_torch.models import clip_vit, convert, hubert, nn
from affectgpt_tpu_torch.ops import quant, vit_attention, vit_mlp, vit_mlp_fused, vit_sublayer

TOL = dict(rtol=1e-4, atol=1e-4)


def _case(seed, shape, k, n):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, k) * 3).astype(np.float32)
    x[0, ..., 0] = 0.0  # a row whose absmax hits the 1e-8 floor below
    if len(shape) > 1:
        x[0, 0] = 0.0
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    return x, w, rng.randn(n).astype(np.float32)


@pytest.mark.parametrize("shape,k,n", [((5,), 48, 24), ((3, 7), 588, 64), ((130,), 1024, 40)])
def test_dense_w8a8_xla_matches_jax_compiled(shape, k, n):
    x, w, b = _case(sum(shape) + k, shape, k, n)
    w_q, scales = jquant.quantize_per_channel(jnp.asarray(w))
    jfn = jax.jit(jquant.dense_w8a8_xla)
    args = (torch.from_numpy(x), torch.from_numpy(np.array(w_q)),
            torch.from_numpy(np.array(scales)))
    # without the bias: bit for bit (the int8 rounding and the int32 sums)
    np.testing.assert_array_equal(quant.dense_w8a8_xla(*args).numpy(),
                                  np.asarray(jfn(jnp.asarray(x), w_q, scales)))
    # with it: one f32 rounding apart where XLA fused the last multiply-add
    got = quant.dense_w8a8_xla(*args, torch.from_numpy(b)).numpy()
    want = np.asarray(jfn(jnp.asarray(x), w_q, scales, jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=2 ** -23 * np.abs(want).max())
    assert quant.dense_w8a8_xla(*[a.to(torch.bfloat16) if a.dtype == torch.float32 else a
                                  for a in args[:1]], *args[1:]).dtype == torch.bfloat16


def test_nn_dense_takes_w_q_leaves():
    x, w, b = _case(3, (4,), 32, 16)
    leaf = quant.quantize_encoder_tree({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    assert set(leaf) == {"w_q", "scales", "b"} and nn.out_dim(leaf) == 16
    xt = torch.from_numpy(x)
    torch.testing.assert_close(nn.dense(leaf, xt), quant.dense_w8a8_xla(
        xt, leaf["w_q"], leaf["scales"], leaf["b"]), rtol=0, atol=0)
    nobias = {k: v for k, v in leaf.items() if k != "b"}
    torch.testing.assert_close(nn.dense_nobias(nobias, xt), quant.dense_w8a8_xla(
        xt, leaf["w_q"], leaf["scales"]), rtol=0, atol=0)
    np.testing.assert_array_equal(nn.dense_nobias(nobias, xt).numpy(), np.asarray(
        jax.jit(jnn.dense_nobias)(jax.tree.map(lambda t: jnp.asarray(t.numpy()), nobias),
                                  jnp.asarray(x))))


@functools.lru_cache(maxsize=None)
def _towers():
    vcfg, acfg = jclip.ClipVisionConfig.tiny(), jhub.HubertConfig.tiny()
    vis = jclip.init_vision_params(jax.random.PRNGKey(5), vcfg, dtype=jnp.float32)
    aud = jhub.init_params(jax.random.PRNGKey(6), acfg, dtype=jnp.float32)
    rng = np.random.RandomState(7)
    # O(1) biases and LN parameters, so every leaf shapes the output
    vis, aud = (jax.tree.map(lambda x: np.asarray(x) + rng.randn(*x.shape).astype(np.float32)
                             * 0.05, t) for t in (vis, aud))
    jvis, jaud = (jquant.quantize_encoder_tree(jax.tree.map(jnp.asarray, t)) for t in (vis, aud))
    tvis, taud = (quant.quantize_encoder_tree(convert.tree_to_torch(t, "cpu"))
                  for t in (vis, aud))
    return vcfg, acfg, (jvis, tvis), (jaud, taud)


@pytest.mark.parametrize("tower", ["vision", "audio"])
def test_quantize_encoder_tree_leaves_match_jax(tower):
    _, _, vis, aud = _towers()
    jtree, ttree = vis if tower == "vision" else aud
    want = jax.tree_util.tree_flatten_with_path(jtree)[0]
    got = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p[-1].key == "w_q" for p, _ in got)
    for (path, g), (_, w) in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype), path
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))


def _forbid(monkeypatch, *targets):
    for mod, name in targets:
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} reached"))


def _count(monkeypatch, mod, name):
    calls = []
    inner = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: calls.append(1) or inner(*a, **k))
    return calls


@pytest.mark.parametrize("attn", ["auto", "sublayer", "flash", "xla"])
@pytest.mark.parametrize("mlp", ["auto", "fused", "xla"])
def test_w8a8_clip_matches_jax_under_every_switch(monkeypatch, attn, mlp):
    monkeypatch.setattr(clip_vit, "ATTN_IMPL", attn)
    monkeypatch.setattr(clip_vit, "MLP_IMPL", mlp)
    _forbid(monkeypatch, (vit_sublayer, "apply"), (vit_mlp, "apply"), (vit_mlp_fused, "apply"))
    fused = _count(monkeypatch, vit_attention, "fused_self_attention")
    vcfg, _, (jvis, tvis), _ = _towers()
    images = np.random.RandomState(1).randn(3, 28, 28, 3).astype(np.float32)
    want = np.asarray(jax.jit(jclip.encode_image, static_argnums=1)(jvis, vcfg,
                                                                     jnp.asarray(images)))
    got = clip_vit.encode_image(tvis, clip_vit.ClipVisionConfig(**dataclasses.asdict(vcfg)),
                                torch.from_numpy(images))
    assert got.shape == (3, vcfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the demoted route: every block's attention in the fused kernel unless "xla"
    assert len(fused) == (0 if attn == "xla" else vcfg.num_layers)


@pytest.mark.parametrize("attn", ["auto", "sublayer", "xla"])
@pytest.mark.parametrize("mlp", ["auto", "pallas", "fused", "xla"])
def test_w8a8_hubert_matches_jax_under_every_switch(monkeypatch, attn, mlp):
    monkeypatch.setattr(hubert, "ATTN_IMPL", attn)
    monkeypatch.setattr(hubert, "MLP_IMPL", mlp)
    _forbid(monkeypatch, (vit_sublayer, "apply"), (vit_mlp, "apply_hubert"),
            (vit_mlp_fused, "apply_hubert"))
    _, acfg, _, (jaud, taud) = _towers()
    clips = np.random.RandomState(2).randn(2, 3, 1, 640).astype(np.float32)
    want = np.asarray(jax.jit(jhub.encode_clips, static_argnums=1)(jaud, acfg,
                                                                    jnp.asarray(clips)))
    got = hubert.encode_clips(taud, hubert.HubertConfig(**dataclasses.asdict(acfg)),
                              torch.from_numpy(clips))
    assert got.shape == (2, 3, acfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_from_jax_carries_w_q_towers():
    """convert.from_jax takes int8 towers and checks their geometry."""
    from affectgpt_tpu.models import affectgpt as ja
    from affectgpt_tpu_torch.models import affectgpt as ta

    vcfg, acfg, (jvis, _), (jaud, _) = _towers()
    base = ja.AffectGPTConfig.tiny()
    jcfg = dataclasses.replace(base, vision_cfg_override=vcfg, audio_cfg_override=acfg)
    tcfg = dataclasses.replace(
        ta.AffectGPTConfig.tiny(),
        vision_cfg_override=clip_vit.ClipVisionConfig(**dataclasses.asdict(vcfg)),
        audio_cfg_override=hubert.HubertConfig(**dataclasses.asdict(acfg)))
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    frozen = jax.tree.map(np.asarray, {**frozen, "visual_encoder": jvis,
                                       "acoustic_encoder": jaud})
    trainable = jax.tree.map(np.asarray, ja.init_trainable(jax.random.PRNGKey(1), jcfg))
    tfrozen, _ = convert.from_jax(frozen, trainable, tcfg, device="cpu")
    leaf = tfrozen["visual_encoder"]["patch_embed"]
    assert leaf["w_q"].dtype == torch.int8 and tuple(leaf["w_q"].shape) == (588, vcfg.width)
    frozen["visual_encoder"]["patch_embed"]["w_q"] = np.zeros((589, vcfg.width), np.int8)
    with pytest.raises(ValueError):
        convert.from_jax(frozen, trainable, tcfg, device="cpu")
