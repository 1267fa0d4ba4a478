"""The port's realtime slice against the JAX package on the CPU, in float32:
device preprocessing (`resize`, `preprocess_frames_eval`), `nn.mha`, the
CLIP vision tower and HuBERT at tiny geometry under every switch value,
`encode_media_features` and greedy `Chat.answer_batch` on raw frames, faces
and audio, and the encoder checks of `convert.from_jax`.

JAX runs its XLA routes here (its kernel routes need a TPU); every port
route computes the same function, and in float32 every bf16 rounding point
of a kernel route is exact. Tolerances: rtol/atol 1e-5 where only f32
summation order differs; resize 2e-4 absolute on 0-255 pixels (two f32
products of 720-wide rows); features 1e-4 (a stack of layers).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference.chat import Chat as JaxChat
from affectgpt_tpu.inference.chat import encode_media_features as jax_encode_media
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import clip_vit as jclip
from affectgpt_tpu.models import hubert as jhub
from affectgpt_tpu.models import nn as jnn
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.ops import image as jimage
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference.chat import Chat, encode_media_features
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import clip_vit, convert, encoders, hubert, nn
from affectgpt_tpu_torch.ops import image, vit_attention
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer

TOL = dict(rtol=1e-5, atol=1e-5)
MODE = "multiface_audio_face_frame_text"


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("shape,out", [
    ((3, 48, 72, 3), (24, 24)),  # downsampled, not square
    ((2, 12, 12, 3), (28, 28)),  # upsampled (face crops)
    ((2, 30, 20, 3), (30, 11)),  # one axis only
    ((2, 16, 16, 3), (16, 16)),  # identity: no filter
])
def test_resize_matches_jax(shape, out):
    frames = np.random.RandomState(sum(shape)).randint(0, 256, size=shape).astype(np.uint8)
    got = image.resize(torch.from_numpy(frames), out)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape[:-3] + out + (3,)
    np.testing.assert_allclose(got.numpy(), _np(jimage.resize(jnp.asarray(frames), out)),
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("scheme", ["clip", "imagenet", "siglip"])
@pytest.mark.parametrize("hw", [(40, 64), (12, 12)])
def test_preprocess_frames_eval_matches_jax(scheme, hw):
    frames = np.random.RandomState(len(scheme)).randint(0, 256, size=(3, *hw, 3)).astype(np.uint8)
    got = image.preprocess_frames_eval(torch.from_numpy(frames), 28, scheme)
    want = _np(jimage.preprocess_frames_eval(jnp.asarray(frames), 28, scheme))
    assert tuple(got.shape) == want.shape == (3, 3, 28, 28)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _mha_params(seed, dq, dkv, heads):
    rng = np.random.RandomState(seed)
    inner = dq

    def dense(i, o):
        return {"w": (rng.randn(i, o) * i ** -0.5).astype(np.float32),
                "b": (rng.randn(o) * 0.1).astype(np.float32)}

    return {"q": dense(dq, inner), "k": dense(dkv, inner), "v": dense(dkv, inner),
            "o": dense(inner, dq)}


@pytest.mark.parametrize("tq,tk,masked,fused", [
    (7, 11, False, "auto"),
    (7, 11, True, "auto"),
    (200, 200, False, "auto"),  # unmasked self-attention ≥ 192: the fused kernel's route
    (200, 200, False, "0"),
    (200, 200, True, "auto"),  # masked: the plain chain
])
def test_mha_matches_jax(monkeypatch, tq, tk, masked, fused):
    monkeypatch.setattr(nn, "FUSED_MHA", fused)
    rng = np.random.RandomState(tq + tk)
    params = _mha_params(3, 32, 32, 4)
    q_in = rng.randn(2, tq, 32).astype(np.float32)
    kv_in = q_in if tq == tk else rng.randn(2, tk, 32).astype(np.float32)
    mask = (rng.rand(2, 1, tq, tk) > 0.3) | (np.arange(tk) == 0) if masked else None
    want = _np(jnn.mha(jax.tree.map(jnp.asarray, params), jnp.asarray(q_in), jnp.asarray(kv_in),
                       4, None if mask is None else jnp.asarray(mask)))
    got = nn.mha(convert.tree_to_torch(params, "cpu"), torch.from_numpy(q_in),
                 torch.from_numpy(kv_in), 4, None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert nn._fused_self_attn_ok(tq, tk, None if not masked else mask) == (
        fused == "auto" and not masked and tq == tk and tq >= 192)


def test_mha_raises_on_probs_drop(monkeypatch):
    """probs_drop (train mode) takes a dropout key, a tuple of ints: a bare
    int raises. A call with probs_drop stays on the plain chain where the
    same call without it takes the fused route."""
    params = convert.tree_to_torch(_mha_params(0, 16, 16, 2), "cpu")
    x = torch.zeros(1, 3, 16)
    with pytest.raises(TypeError):
        nn.mha(params, x, x, 2, probs_drop=(0, 0.1))

    def fused(*args, **kwargs):
        raise RuntimeError("fused route")

    monkeypatch.setattr(vit_attention, "fused_self_attention", fused)
    x = torch.randn(1, 192, 16, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="fused route"):
        nn.mha(params, x, x, 2)
    assert nn.mha(params, x, x, 2, probs_drop=((0,), 0.1)).shape == x.shape


@functools.lru_cache(maxsize=None)
def _towers():
    vcfg, acfg = jclip.ClipVisionConfig.tiny(), jhub.HubertConfig.tiny()
    vis = jclip.init_vision_params(jax.random.PRNGKey(5), vcfg, dtype=jnp.float32)
    aud = jhub.init_params(jax.random.PRNGKey(6), acfg, dtype=jnp.float32)
    rng = np.random.RandomState(7)
    # O(1) biases and LN parameters, so every leaf shapes the output
    vis, aud = (jax.tree.map(lambda x: np.asarray(x) + rng.randn(*x.shape).astype(np.float32)
                             * 0.05, t) for t in (vis, aud))
    return vcfg, acfg, vis, aud


@pytest.mark.parametrize("attn", ["auto", "sublayer", "flash", "xla"])
@pytest.mark.parametrize("mlp", ["auto", "fused", "xla"])
def test_encode_image_matches_jax_under_every_switch(monkeypatch, attn, mlp):
    monkeypatch.setattr(clip_vit, "ATTN_IMPL", attn)
    monkeypatch.setattr(clip_vit, "MLP_IMPL", mlp)
    vcfg, _, vis, _ = _towers()
    images = np.random.RandomState(1).randn(3, 28, 28, 3).astype(np.float32)
    want = _np(jclip.encode_image(jax.tree.map(jnp.asarray, vis), vcfg, jnp.asarray(images)))
    cfg = clip_vit.ClipVisionConfig(**dataclasses.asdict(vcfg))
    got = clip_vit.encode_image(convert.tree_to_torch(vis, "cpu"), cfg, torch.from_numpy(images))
    assert got.shape == (3, vcfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("attn", ["auto", "sublayer", "xla"])
@pytest.mark.parametrize("mlp", ["auto", "pallas", "fused", "xla"])
def test_hubert_encode_clips_matches_jax_under_every_switch(monkeypatch, attn, mlp):
    monkeypatch.setattr(hubert, "ATTN_IMPL", attn)
    monkeypatch.setattr(hubert, "MLP_IMPL", mlp)
    _, acfg, _, aud = _towers()
    clips = np.random.RandomState(2).randn(2, 3, 1, 640).astype(np.float32)
    want = _np(jhub.encode_clips(jax.tree.map(jnp.asarray, aud), acfg, jnp.asarray(clips)))
    cfg = hubert.HubertConfig(**dataclasses.asdict(acfg))
    got = hubert.encode_clips(convert.tree_to_torch(aud, "cpu"), cfg, torch.from_numpy(clips))
    assert got.shape == (2, 3, acfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_hubert_chunked_conv_frontend_equals_unchunked(monkeypatch):
    _, acfg, _, aud = _towers()
    params = convert.tree_to_torch(aud, "cpu")
    cfg = hubert.HubertConfig(**dataclasses.asdict(acfg))
    wave = torch.from_numpy(np.random.RandomState(4).randn(6, 640).astype(np.float32))
    whole = hubert._conv_frontend(params, cfg, wave)
    monkeypatch.setattr(hubert, "CONV_CHUNK", 4)  # 6 clips: the largest divisor ≤ 4 is 3
    assert torch.equal(hubert._conv_frontend(params, cfg, wave), whole)


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _models():
    base = ja.AffectGPTConfig.tiny()
    vcfg = dataclasses.replace(jclip.ClipVisionConfig.tiny(), projection_dim=base.visual_dim)
    acfg = dataclasses.replace(jhub.HubertConfig.tiny(), hidden_size=base.acoustic_dim)
    jcfg = dataclasses.replace(base, vision_cfg_override=vcfg, audio_cfg_override=acfg)
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32, with_encoders=True,
                            vision_cfg=vcfg, audio_cfg=acfg)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    trainable = jax.tree.map(lambda x: x * 25.0, trainable)  # O(1) mergers
    tcfg = dataclasses.replace(
        ta.AffectGPTConfig.tiny(),
        vision_cfg_override=clip_vit.ClipVisionConfig(**dataclasses.asdict(vcfg)),
        audio_cfg_override=hubert.HubertConfig(**dataclasses.asdict(acfg)))
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg, device="cpu")
    jfrozen = {**frozen, "llm": jq.merge_lora(frozen["llm"], trainable["lora"], jcfg.llm)}
    tfrozen, ttrain = bootstrap.serving_llm(tfrozen, ttrain, tcfg)
    return jcfg, jfrozen, {**trainable, "lora": None}, tcfg, tfrozen, ttrain


def _raw(b):
    rng = np.random.RandomState(b)
    return {
        "frame": rng.randint(0, 256, size=(b, 4, 40, 56, 3)).astype(np.uint8),  # downsampled
        "face": rng.randint(0, 256, size=(b, 4, 12, 12, 3)).astype(np.uint8),  # upsampled
        "audio": rng.randn(b, 3, 1, 640).astype(np.float32),
    }


@pytest.mark.parametrize("b", [2, 3])
def test_realtime_answer_matches_jax(b):
    """Raw media → encode_media_features → greedy answer_batch: the features
    within 1e-4 of JAX's, the strings identical."""
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models()
    raw = _raw(b)
    jfeats = jax_encode_media(jfrozen, jcfg, {m: jnp.asarray(v) for m, v in raw.items()})
    feats = encode_media_features(tfrozen, tcfg, {m: torch.from_numpy(v) for m, v in raw.items()})
    assert feats.keys() == jfeats.keys() == {"frame", "face", "audio"}
    for m in feats:
        np.testing.assert_allclose(feats[m].numpy(), _np(jfeats[m]), rtol=1e-4, atol=1e-4)
    subtitles = ["so happy", "leave me", "what?!"][:b]
    kw = dict(max_new_tokens=8, do_sample=False)
    want = JaxChat(jfrozen, jtrain, jcfg, ByteTokenizer(), max_len=512).answer_batch(
        MODE, subtitles, "Emotions?", jfeats, **kw)
    got = Chat(tfrozen, ttrain, tcfg, TorchByteTokenizer(), max_len=512).answer_batch(
        MODE, subtitles, "Emotions?", feats, **kw)
    assert got == want and len(got) == b


def _to_jax(tree):
    """A port tree (tensors) → the same tree of jax arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def test_build_model_with_encoders_tiny_answers_as_jax():
    """The port's own bootstrap in tiny mode, carried to the JAX package as
    it is: the raw-media answer's greedy strings are JAX's."""
    node = {"keep_full_llm": False, "preextracted_visual_dim": 12,
            "preextracted_acoustic_dim": 16}
    cfg, frozen, trainable, tok = bootstrap.build_model(node, with_encoders=True, device="cpu",
                                                        dtype=torch.float32, seed=3)
    assert cfg.vision_cfg_override == dataclasses.replace(clip_vit.ClipVisionConfig.tiny(),
                                                          projection_dim=12)
    assert cfg.audio_cfg_override == dataclasses.replace(hubert.HubertConfig.tiny(),
                                                         hidden_size=16)
    assert frozen["visual_encoder"]["proj"]["w"].shape == (16, 12)
    assert frozen["acoustic_encoder"]["pos_conv"]["w"].shape == (16, 8, 8)
    assert len(frozen["visual_encoder"]["blocks"]) == 2
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    raw = _raw(2)
    feats = encode_media_features(frozen, cfg, {m: torch.from_numpy(v) for m, v in raw.items()})
    assert {m: tuple(v.shape) for m, v in feats.items()} == {
        "frame": (2, 4, 12), "face": (2, 4, 12), "audio": (2, 3, 16)}
    kw = dict(max_new_tokens=8, do_sample=False)
    got = Chat(frozen, trainable, cfg, tok, max_len=512).answer_batch(
        MODE, ["a", "b"], "Q?", feats, **kw)

    jcfg = dataclasses.replace(
        ja.AffectGPTConfig.from_model_cfg(node),
        llm=jq.QwenConfig(**dataclasses.asdict(cfg.llm)),
        vision_cfg_override=jclip.ClipVisionConfig(**dataclasses.asdict(cfg.vision_cfg_override)),
        audio_cfg_override=jhub.HubertConfig(**dataclasses.asdict(cfg.audio_cfg_override)))
    jfrozen, jtrain = _to_jax(frozen), _to_jax(trainable)
    jfeats = jax_encode_media(jfrozen, jcfg, {m: jnp.asarray(v) for m, v in raw.items()})
    for m in feats:
        np.testing.assert_allclose(feats[m].numpy(), _np(jfeats[m]), rtol=1e-4, atol=1e-4)
    want = JaxChat(jfrozen, jtrain, jcfg, ByteTokenizer(), max_len=512).answer_batch(
        MODE, ["a", "b"], "Q?", jfeats, **kw)
    assert got == want and len(got) == 2


def test_build_model_encoder_modes():
    node = {"keep_full_llm": False, "preextracted_visual_dim": 12,
            "preextracted_acoustic_dim": 16}
    frozen = bootstrap.build_model(node, with_encoders=True, device="cpu", dtype=torch.float32,
                                   seed=3)[1]
    # skip_encoders keeps the preextracted mode; the same seed gives the same towers
    assert "visual_encoder" not in bootstrap.build_model(
        {**node, "skip_encoders": True}, with_encoders=True, device="cpu")[1]
    again = bootstrap.build_model(node, with_encoders=True, device="cpu", dtype=torch.float32,
                                  seed=3)[1]
    assert torch.equal(again["acoustic_encoder"]["convs"][0]["w"],
                       frozen["acoustic_encoder"]["convs"][0]["w"])


def test_encoder_registry():
    assert encoders.get_visual_encoder("CLIP_VIT_LARGE").make_config() == \
        clip_vit.ClipVisionConfig.vit_l_14()
    assert encoders.get_acoustic_encoder("HUBERT_LARGE").hidden_size == 1024
    assert encoders.get_visual_encoder("DINO2_LARGE").normalize == "imagenet"
    assert encoders.get_acoustic_encoder("WAVLM_LARGE").hidden_size == 1024
    with pytest.raises(KeyError):
        encoders.get_visual_encoder("NO_SUCH_TOWER")


@pytest.mark.parametrize("tower,path,bad", [
    ("visual_encoder", ("patch_embed", "w"), np.zeros((14 * 14 * 3 + 1, 16), np.float32)),
    ("visual_encoder", ("blocks",), []),
    ("acoustic_encoder", ("pos_conv", "w"), np.zeros((16, 16, 8), np.float32)),
    ("acoustic_encoder", ("layers",), []),
])
def test_from_jax_raises_on_a_tower_of_the_wrong_geometry(tower, path, bad):
    jcfg, jfrozen, jtrain, tcfg, _, _ = _models()
    frozen = jax.tree.map(np.asarray, jfrozen)
    node = frozen[tower]
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = bad
    with pytest.raises(ValueError, match="from_jax"):
        convert.from_jax(frozen, jax.tree.map(np.asarray, jtrain), tcfg, device="cpu")


def test_from_jax_raises_on_a_conv_kernel_of_the_wrong_shape():
    _, jfrozen, jtrain, tcfg, _, _ = _models()
    frozen = jax.tree.map(np.asarray, jfrozen)
    conv = frozen["acoustic_encoder"]["convs"][1]
    conv["w"] = np.zeros((8, 8, 4), np.float32)  # the config says k = 3
    with pytest.raises(ValueError, match="acoustic conv 1"):
        convert.from_jax(frozen, jax.tree.map(np.asarray, jtrain), tcfg, device="cpu")
