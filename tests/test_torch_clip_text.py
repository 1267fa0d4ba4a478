"""The CLIP text tower in the port against the JAX package, in f32 on the
CPU: `encode_text` (causal blocks on the plain chain, EOT pooling, the
projection) within 1e-4, `byte_fallback_tokenize` identical, `encode_texts`
(row-normalized features) within 1e-4, and the tower's loading: random
weights from a seed without a checkpoint directory, NotImplementedError
with one."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.models import clip_vit as jclip
from affectgpt_tpu.utils import clip_text as jtext
from affectgpt_tpu_torch import paths
from affectgpt_tpu_torch.models import clip_vit, convert, nn
from affectgpt_tpu_torch.ops import vit_attention, vit_mlp, vit_mlp_fused, vit_sublayer
from affectgpt_tpu_torch.utils import clip_text

TOL = dict(rtol=1e-4, atol=1e-4)
TEXTS = ["Inner brow raiser (intensity: 1.25)", "", "Lip corner puller, jaw drop",
         "é" * 40]  # multi-byte and longer than the 16-token context


def test_config_matches_jax():
    for preset in ("vit_b_32_text", "tiny"):
        assert dataclasses.asdict(getattr(clip_vit.ClipTextConfig, preset)()) == \
            dataclasses.asdict(getattr(jclip.ClipTextConfig, preset)())


@functools.lru_cache(maxsize=None)
def _tower():
    cfg = jclip.ClipTextConfig.tiny()
    params = jclip.init_text_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda x: np.asarray(x) + rng.randn(*x.shape).astype(np.float32)
                          * 0.05, params)
    tcfg = clip_vit.ClipTextConfig(**dataclasses.asdict(cfg))
    return cfg, tcfg, params, convert.text_tower_from_jax(params, tcfg, device="cpu")


def test_byte_fallback_tokenize_matches_jax():
    cfg, tcfg, _, _ = _tower()
    for c, t in ((cfg, tcfg), (jclip.ClipTextConfig(), clip_vit.ClipTextConfig())):
        np.testing.assert_array_equal(clip_text.byte_fallback_tokenize(TEXTS, t),
                                      jtext.byte_fallback_tokenize(TEXTS, c))


@pytest.mark.parametrize("attn", ["auto", "sublayer", "flash", "xla"])
def test_encode_text_matches_jax(monkeypatch, attn):
    """Every switch value: the causal mask sends each block to the plain
    chain, and no kernel is reached."""
    monkeypatch.setattr(clip_vit, "ATTN_IMPL", attn)
    for mod, name in ((vit_sublayer, "apply"), (vit_mlp, "apply"), (vit_mlp_fused, "apply"),
                      (vit_attention, "fused_self_attention")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(f"{_n} reached"))
    cfg, tcfg, params, tparams = _tower()
    ids = clip_text.byte_fallback_tokenize(TEXTS, tcfg)
    want = jclip.encode_text(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(ids))
    got = clip_vit.encode_text(tparams, tcfg, torch.from_numpy(ids).long())
    assert got.shape == (len(TEXTS), cfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_texts_matches_jax():
    cfg, tcfg, params, tparams = _tower()
    want = jtext.encode_texts(jax.tree.map(jnp.asarray, params), cfg, TEXTS)
    got = clip_text.encode_texts(tparams, tcfg, TEXTS)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)


def test_init_text_params_has_jax_tree():
    cfg = jclip.ClipTextConfig.tiny()
    want = jax.tree_util.tree_flatten_with_path(
        jclip.init_text_params(jax.random.PRNGKey(0), cfg))[0]
    got = jax.tree_util.tree_flatten_with_path(clip_vit.init_text_params(
        torch.Generator().manual_seed(0), clip_vit.ClipTextConfig.tiny()))[0]
    assert [(p, x.shape, str(x.dtype)) for p, x in want] == \
        [(p, tuple(x.shape), str(x.dtype).replace("torch.", "")) for p, x in got]


def test_load_text_tower(monkeypatch, tmp_path):
    monkeypatch.setitem(paths.PATH_TO_VISUAL, "CLIP_VIT_BASE32", str(tmp_path / "absent"))
    params, cfg = clip_text.load_text_tower(device="cpu")
    again, _ = clip_text.load_text_tower(device="cpu")
    assert cfg == clip_vit.ClipTextConfig.vit_b_32_text()
    assert tuple(params["token_embed"]["table"].shape) == (cfg.vocab_size, cfg.width)
    assert params["proj"]["w"].dtype == torch.bfloat16 and len(params["blocks"]) == 12
    assert torch.equal(params["proj"]["w"], again["proj"]["w"])  # drawn from the seed
    monkeypatch.setattr(clip_text, "_CACHED_TOWER", {})
    assert clip_text.cached_text_tower("cpu") is clip_text.cached_text_tower("cpu")
    # a directory that exists is loaded: a checkpoint of another geometry
    # than ViT-B/32's fails the geometry check, an empty one names what it lacks
    monkeypatch.setitem(paths.PATH_TO_VISUAL, "CLIP_VIT_BASE32", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors"):
        clip_text.load_text_tower(device="cpu")
    torch.save(text_state(params), tmp_path / "pytorch_model.bin")
    loaded, _ = clip_text.load_text_tower(device="cpu")
    assert torch.equal(loaded["proj"]["w"], params["proj"]["w"])
    monkeypatch.setattr(clip_vit.ClipTextConfig, "vit_b_32_text",
                        classmethod(lambda cls: clip_vit.ClipTextConfig.tiny()))
    with pytest.raises(ValueError, match="text token_embed"):
        clip_text.load_text_tower(device="cpu")


def text_state(params: dict) -> dict:
    """The port's text tower → a HF CLIPModel state dict of it (text_model.*
    and text_projection, HF's [out, in] layout)."""
    sd = {"embeddings.token_embedding.weight": params["token_embed"]["table"],
          "embeddings.position_embedding.weight": params["pos_embed"]["table"],
          "final_layer_norm.weight": params["final_ln"]["scale"],
          "final_layer_norm.bias": params["final_ln"]["bias"]}
    for i, blk in enumerate(params["blocks"]):
        p = f"encoder.layers.{i}"
        for ln in ("1", "2"):
            sd[f"{p}.layer_norm{ln}.weight"] = blk[f"ln{ln}"]["scale"]
            sd[f"{p}.layer_norm{ln}.bias"] = blk[f"ln{ln}"]["bias"]
        for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            sd[f"{p}.self_attn.{name}.weight"] = blk["attn"][key]["w"].t().contiguous()
            sd[f"{p}.self_attn.{name}.bias"] = blk["attn"][key]["b"]
        for key, name in (("mlp_in", "fc1"), ("mlp_out", "fc2")):
            sd[f"{p}.mlp.{name}.weight"] = blk[key]["w"].t().contiguous()
            sd[f"{p}.mlp.{name}.bias"] = blk[key]["b"]
    out = {f"text_model.{k}": v.clone() for k, v in sd.items()}
    out["text_projection.weight"] = params["proj"]["w"].t().contiguous()
    return out


def test_text_tower_from_jax_checks_the_geometry():
    _, tcfg, params, _ = _tower()
    bad = jax.tree.map(np.asarray, params)
    bad["proj"]["w"] = np.zeros((tcfg.width, tcfg.projection_dim + 1), np.float32)
    with pytest.raises(ValueError):
        convert.text_tower_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError):
        convert.text_tower_from_jax(params, dataclasses.replace(tcfg, num_layers=3),
                                    device="cpu")


def test_encode_text_on_a_w_q_tree():
    """The text tower under quantize_encoder_tree: the same plain route with
    nn.dense's int8 branch, close to the float tower."""
    _, tcfg, _, tparams = _tower()
    ids = torch.from_numpy(clip_text.byte_fallback_tokenize(TEXTS, tcfg)).long()
    from affectgpt_tpu_torch.ops import quant

    got = clip_vit.encode_text(quant.quantize_encoder_tree(tparams), tcfg, ids)
    ref = clip_vit.encode_text(tparams, tcfg, ids)
    assert "w_q" in quant.quantize_encoder_tree(tparams)["proj"]
    assert float(torch.nn.functional.cosine_similarity(got, ref).min()) > 0.99
    assert nn.out_dim(quant.quantize_encoder_tree(tparams)["proj"]) == tcfg.projection_dim
