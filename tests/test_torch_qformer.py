"""The Q-Former and the `qformer` mergers in the port against the JAX
package, in f32 on the CPU, on weights carried across by convert.from_jax:
`qformer.apply` with and without an encoder mask and with a fully masked
row (JAX's finite fill, no NaN), the merger on 3-D and 4-D inputs, the
qformer pre-fusion, and a whole configuration with every fusion type
"qformer" through `Chat.answer_batch` (identical greedy strings). Outputs
within 1e-4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference.chat import Chat as JaxChat
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import mergers as jm
from affectgpt_tpu.models import qformer as jqf
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference.chat import Chat
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import mergers as tm
from affectgpt_tpu_torch.models import qformer as tqf
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer

TOL = dict(atol=1e-4, rtol=1e-4)


def _torch(tree):
    return convert.tree_to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _scaled(tree, scale=10.0):
    """Larger weights than the 0.02 init, so that attention is not uniform
    (3x at the mergers' 768-wide Q-Former, 10x at the tiny one)."""
    return jax.tree.map(lambda x: x * scale, tree)


def test_config_matches_jax():
    for preset in ("blip2", "tiny"):
        assert dataclasses.asdict(getattr(tqf.QFormerConfig, preset)()) == \
            dataclasses.asdict(getattr(jqf.QFormerConfig, preset)())
    assert [f.name for f in dataclasses.fields(tqf.QFormerConfig)] == \
        [f.name for f in dataclasses.fields(jqf.QFormerConfig)]


@pytest.mark.parametrize("mask", ["none", "ragged", "fully_masked_row"])
@pytest.mark.parametrize("cross_attention_freq", [1, 2])
def test_apply_matches_jax(mask, cross_attention_freq):
    cfg = dataclasses.replace(jqf.QFormerConfig.tiny(encoder_width=12),
                              cross_attention_freq=cross_attention_freq)
    tcfg = tqf.QFormerConfig(**dataclasses.asdict(cfg))
    params = _scaled(jqf.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(1)
    enc = rng.randn(3, 7, 12).astype(np.float32)
    enc_mask = None
    if mask != "none":
        enc_mask = np.arange(7)[None, :] < np.array([[7], [4], [2]])
        if mask == "fully_masked_row":
            enc_mask[1] = False
    want = jqf.apply(params, cfg, jnp.asarray(enc),
                     None if enc_mask is None else jnp.asarray(enc_mask))
    got = tqf.apply(_torch(params), tcfg, torch.from_numpy(enc),
                    None if enc_mask is None else torch.from_numpy(enc_mask))
    assert got.shape == (3, cfg.num_query_tokens, cfg.hidden_size)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_raises_in_train_mode():
    """Train mode is ported: its dropout key is a tuple of ints (a bare int
    raises), and a key gives the train-mode output."""
    cfg = tqf.QFormerConfig.tiny()
    params = tqf.init_params(torch.Generator().manual_seed(0), cfg)
    enc = torch.zeros(1, 3, cfg.encoder_width)
    with pytest.raises(TypeError):
        tqf.apply(params, cfg, enc, dropout_rng=0)
    out = tqf.apply(params, cfg, enc, dropout_rng=(0,))
    assert out.shape == (1, cfg.num_query_tokens, cfg.hidden_size) and torch.isfinite(out).all()


def test_init_params_has_jax_tree():
    cfg = dataclasses.replace(jqf.QFormerConfig.tiny(), cross_attention_freq=2, num_layers=3)
    want = jax.tree_util.tree_flatten_with_path(jqf.init_params(jax.random.PRNGKey(0), cfg))[0]
    got = tqf.init_params(torch.Generator().manual_seed(0),
                          tqf.QFormerConfig(**dataclasses.asdict(cfg)))
    got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(x.shape) for _, x in got] == [x.shape for _, x in want]


MERGER = dict(fusion_type="qformer", feat_dim=12, llm_dim=24, num_query_tokens=3, max_time=8)


@pytest.mark.parametrize("shape", [(2, 5, 12), (2, 1, 12), (2, 4, 3, 12)],
                         ids=["3d", "3d_t1", "4d"])
def test_merger_matches_jax(shape):
    jcfg, tcfg = jm.MergerConfig(**MERGER), tm.MergerConfig(**MERGER)
    params = _scaled(jm.init_merger(jax.random.PRNGKey(2), jcfg), 3.0)
    feats = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = jm.apply_merger(params, jcfg, jnp.asarray(feats))
    got = tm.apply_merger(_torch(params), tcfg, torch.from_numpy(feats))
    assert got.shape == (2, 3, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcfg.qformer_config() == tqf.QFormerConfig(encoder_width=12, num_query_tokens=3)


def test_multi_fusion_matches_jax():
    kw = dict(fusion_type="qformer", video_dim=12, audio_dim=16, llm_dim=24,
              num_query_tokens=2, max_time=20)
    jcfg, tcfg = jm.MultiFusionConfig(**kw), tm.MultiFusionConfig(**kw)
    params = _scaled(jm.init_multi_fusion(jax.random.PRNGKey(4), jcfg), 3.0)
    rng = np.random.RandomState(5)
    video, audio = rng.randn(3, 6, 12).astype(np.float32), rng.randn(3, 5, 16).astype(np.float32)
    want = jm.apply_multi_fusion(params, jcfg, jnp.asarray(video), jnp.asarray(audio))
    got = tm.apply_multi_fusion(_torch(params), tcfg, torch.from_numpy(video),
                                torch.from_numpy(audio))
    assert got.shape == (3, 2, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_port_init_builds_every_qformer_tree():
    """init_merger / init_multi_fusion on the port's generator give JAX's
    tree (keys and shapes) for the qformer types."""
    g = torch.Generator().manual_seed(0)
    for jtree, ttree in (
            (jm.init_merger(jax.random.PRNGKey(0), jm.MergerConfig(**MERGER)),
             tm.init_merger(g, tm.MergerConfig(**MERGER))),
            (jm.init_multi_fusion(jax.random.PRNGKey(0), jm.MultiFusionConfig(
                "qformer", 12, 16, 24, 2)),
             tm.init_multi_fusion(g, tm.MultiFusionConfig("qformer", 12, 16, 24, 2)))):
        want = jax.tree_util.tree_flatten_with_path(jtree)[0]
        got = jax.tree_util.tree_flatten_with_path(ttree)[0]
        assert [(p, x.shape) for p, x in want] == [(p, tuple(x.shape)) for p, x in got]


QFORMER_NODE = dict(video_fusion_type="qformer", audio_fusion_type="qformer",
                    multi_fusion_type="qformer")


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(ja.AffectGPTConfig.tiny(), **QFORMER_NODE)
    tcfg = dataclasses.replace(ta.AffectGPTConfig.tiny(), **QFORMER_NODE)
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    trainable = {**trainable, "mergers": _scaled(trainable["mergers"], 3.0),
                 "multi": _scaled(trainable["multi"], 3.0)}
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg, device="cpu")
    jfrozen = {**frozen, "llm": jq.merge_lora(frozen["llm"], trainable["lora"], jcfg.llm)}
    tfrozen, ttrain = bootstrap.serving_llm(tfrozen, ttrain, tcfg)
    return jcfg, jfrozen, {**trainable, "lora": None}, tcfg, tfrozen, ttrain


def test_qformer_answer_batch_matches_jax_chat():
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models()
    mode = "multiface_audio_face_frame_text"
    rng = np.random.RandomState(6)
    feats = {m: rng.randn(2, 8, d).astype(np.float32) for m, d in
             (("frame", jcfg.visual_dim), ("face", jcfg.visual_dim), ("audio", jcfg.acoustic_dim))}
    kw = dict(max_new_tokens=8, do_sample=False)
    want = JaxChat(jfrozen, jtrain, jcfg, ByteTokenizer(), max_len=512).answer_batch(
        mode, ["so happy", "leave me"], "Emotions?",
        {m: jnp.asarray(v) for m, v in feats.items()}, **kw)
    got = Chat(tfrozen, ttrain, tcfg, TorchByteTokenizer(), max_len=512).answer_batch(
        mode, ["so happy", "leave me"], "Emotions?",
        {m: torch.from_numpy(v) for m, v in feats.items()}, **kw)
    assert got == want and len(got) == 2


def test_qformer_blocks_match_jax():
    """build_inputs_embeds' merger blocks under the qformer configuration."""
    jcfg, _, jtrain, tcfg, _, ttrain = _models()
    rng = np.random.RandomState(7)
    feats = {m: rng.randn(2, 6, d).astype(np.float32) for m, d in
             (("face", jcfg.visual_dim), ("audio", jcfg.acoustic_dim))}
    want = ja.encode_modalities(jtrain, jcfg, {m: jnp.asarray(v) for m, v in feats.items()})
    got = ta.encode_modalities(ttrain, tcfg, {m: torch.from_numpy(v) for m, v in feats.items()})
    assert set(got) == set(want) == {"face", "audio", "multi"}
    for m in want:
        np.testing.assert_allclose(got[m].numpy(), np.asarray(want[m]), **TOL)


def test_build_model_builds_qformer_configurations():
    cfg, _, trainable, _ = bootstrap.build_model({"keep_full_llm": False, **QFORMER_NODE},
                                                 device="cpu")
    assert cfg.video_fusion_type == cfg.multi_fusion_type == "qformer"
    assert "qformer" in trainable["mergers"]["video"] and "qformer" in trainable["multi"]


@pytest.mark.parametrize("bad", ["pos_embed", "query_tokens", "layers", "kind"])
def test_from_jax_checks_qformer_trees(bad):
    jcfg, _, _, tcfg, _, _ = _models()
    frozen = jax.tree.map(np.asarray, ja.init_frozen(jax.random.PRNGKey(0), jcfg,
                                                     dtype=jnp.float32))
    trainable = jax.tree.map(np.asarray, ja.init_trainable(jax.random.PRNGKey(1), jcfg))
    video = trainable["mergers"]["video"]
    if bad == "pos_embed":
        video["pos_embed"]["table"] = np.zeros((3, jcfg.visual_dim), np.float32)
    elif bad == "query_tokens":
        video["qformer"]["query_tokens"] = np.zeros((1, 5, 768), np.float32)
    elif bad == "layers":
        video["qformer"]["layers"] = video["qformer"]["layers"][:1]
    else:
        trainable["mergers"]["video"] = jax.tree.map(np.asarray, jm.init_merger(
            jax.random.PRNGKey(0), dataclasses.replace(jcfg.merger_config("frame"),
                                                       fusion_type="attention")))
    with pytest.raises(ValueError):
        convert.from_jax(frozen, trainable, tcfg, device="cpu")
