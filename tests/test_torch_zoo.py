"""The port's encoder zoo (affectgpt_tpu_torch/models/{vit_variants,eva_vit,
wav_encoders,imagebind_audio}.py, models/encoders.py) against the JAX
package on the CPU, in float32:

- each of the seven towers at its `tiny` geometry through its registry
  spec's `encode`, with the same numpy-perturbed weights carried by
  `convert.from_jax`'s tree conversion, within 1e-5 (a stack of layers whose
  f32 sums differ in order only; DINOv2's resized position table within 1e-4:
  two f32 products of the Keys-cubic weights);
- the HF converters (`convert_dinov2`, `convert_siglip_vision`,
  `convert_wavlm`, `convert_data2vec_audio`) and the raw-state converters
  (`eva_vit.convert_eva_state`, `imagebind_audio.convert_imagebind_audio`)
  bit for bit against JAX's, in f32 and bf16, and their trees through the
  towers of both packages;
- `encode_media_features` + greedy `Chat.answer_batch` with a Llama2-config
  (SigLIP + WavLM) and a Baichuan2-config (DINOv2 + ImageBind on mel clips)
  tiny LLM, each under its own tokenizer built here (a Llama-2-form
  `tokenizer.json`; a BPE `tokenizer.model` with JAX's wrapper over HF's BPE
  as the oracle): identical strings, features within 1e-4.

JAX runs its XLA routes here; the port's `nn.mha` takes the plain chain
below 192 tokens, as every tiny tower has.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from affectgpt_tpu import paths as jpaths  # noqa: E402
from affectgpt_tpu import tokenization as jtok  # noqa: E402
from affectgpt_tpu.inference.chat import Chat as JaxChat  # noqa: E402
from affectgpt_tpu.inference.chat import encode_media_features as jax_encode_media  # noqa: E402
from affectgpt_tpu.models import affectgpt as ja  # noqa: E402
from affectgpt_tpu.models import convert as jconv  # noqa: E402
from affectgpt_tpu.models import encoders as jenc  # noqa: E402
from affectgpt_tpu.models import eva_vit as jeva  # noqa: E402
from affectgpt_tpu.models import imagebind_audio as jib  # noqa: E402
from affectgpt_tpu.models import qwen2 as jq  # noqa: E402
from affectgpt_tpu.models import vit_variants as jvv  # noqa: E402
from affectgpt_tpu.models import wav_encoders as jwav  # noqa: E402
from affectgpt_tpu.ops import audio as jaudio  # noqa: E402
from affectgpt_tpu_torch import bootstrap  # noqa: E402
from affectgpt_tpu_torch import paths as tpaths  # noqa: E402
from affectgpt_tpu_torch import tokenization as ttok  # noqa: E402
from affectgpt_tpu_torch.inference.chat import Chat, encode_media_features  # noqa: E402
from affectgpt_tpu_torch.models import affectgpt as ta  # noqa: E402
from affectgpt_tpu_torch.models import (convert, encoders, eva_vit, imagebind_audio,  # noqa: E402
                                        qwen2, vit_variants, wav_encoders)
from affectgpt_tpu_torch.ops import audio  # noqa: E402
from tests import torch_hf_models as hf  # noqa: E402
from tests.test_torch_tokenizer_spm import hf_bpe_oracle  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MODE = "multiface_audio_face_frame_text"

# name → (JAX config class, port config class, the input's kind)
ZOO = {
    "DINO2_LARGE": (jvv.Dinov2Config, vit_variants.Dinov2Config, "frames"),
    "SigLIP_SO": (jvv.SiglipConfig, vit_variants.SiglipConfig, "frames"),
    "EVA_CLIP_G_NO_QFORMER": (jeva.EvaVitConfig, eva_vit.EvaVitConfig, "frames"),
    "EVA_CLIP_G": (jeva.EvaVitConfig, eva_vit.EvaVitConfig, "frames"),
    "WAVLM_LARGE": (jwav.WavLMConfig, wav_encoders.WavLMConfig, "wave"),
    "DATA2VEC_BASE": (jwav.Data2VecAudioConfig, wav_encoders.Data2VecAudioConfig, "wave"),
    "IMAGEBIND": (jib.ImageBindAudioConfig, imagebind_audio.ImageBindAudioConfig, "mels"),
}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _specs(name):
    visual = ZOO[name][2] == "frames"
    return ((jenc.get_visual_encoder, encoders.get_visual_encoder) if visual
            else (jenc.get_acoustic_encoder, encoders.get_acoustic_encoder))


def _configs(name):
    jcls, tcls, _ = ZOO[name]
    jcfg = jcls.tiny()
    return jcfg, tcls(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _tower(name, seed=5):
    """JAX's tiny tower `name` in f32 with O(1) noise on every leaf, as numpy."""
    jget, _ = _specs(name)
    jcfg, _ = _configs(name)
    tree = jget(name).init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + rng.randn(*x.shape).astype(np.float32) * 0.05,
                        tree)


def _inputs(name, b=2, t=2, size=None):
    jcfg, _ = _configs(name)
    rng = np.random.RandomState(b + t)
    kind = ZOO[name][2]
    if kind == "frames":
        s = size or jcfg.image_size
        return rng.randn(b, t, s, s, 3).astype(np.float32)
    if kind == "wave":
        return rng.randn(b, t, 1, 640).astype(np.float32)
    return rng.randn(b, t, 1, jcfg.num_mel_bins, jcfg.target_len).astype(np.float32)


@pytest.mark.parametrize("name", list(ZOO))
def test_tower_matches_jax(name):
    jget, tget = _specs(name)
    jcfg, tcfg = _configs(name)
    tree = _tower(name)
    x = _inputs(name)
    want = _np(jget(name).encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x)))
    params = convert.check_tower("visual_encoder" if ZOO[name][2] == "frames"
                                 else "acoustic_encoder", convert.tree_to_torch(tree, "cpu"), tcfg)
    got = tget(name).encode(params, tcfg, torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.shape[-1] == (768 if name == "EVA_CLIP_G" else want.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dinov2_resizes_its_position_table_as_jax():
    """42 px images (9 patches) on the 28 px table (4 patches): the table's
    grid resized by the antialiased Keys-cubic resample, as
    jax.image.resize does."""
    jcfg, tcfg = _configs("DINO2_LARGE")
    tree = _tower("DINO2_LARGE")
    x = _inputs("DINO2_LARGE", size=42)[:, 0]
    want = _np(jvv.dinov2_encode(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x)))
    got = vit_variants.dinov2_encode(convert.tree_to_torch(tree, "cpu"), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_wavlm_buckets_equal_jax():
    for q, k, nb, md in ((99, 99, 320, 800), (7, 11, 8, 16), (1, 1, 320, 800)):
        np.testing.assert_array_equal(wav_encoders.relative_position_buckets(q, k, nb, md),
                                      jwav.relative_position_buckets(q, k, nb, md))


@pytest.mark.parametrize("name", list(ZOO))
def test_check_tower_refuses_another_geometry(name):
    _, tcfg = _configs(name)
    key = "visual_encoder" if ZOO[name][2] == "frames" else "acoustic_encoder"
    tree = convert.tree_to_torch(_tower(name), "cpu")
    wider = dataclasses.replace(tcfg, num_layers=tcfg.num_layers + 1)
    with pytest.raises(ValueError, match="from_jax"):
        convert.check_tower(key, tree, wider)


# ---------------------------------------------------------------------------
# converters

HF_TOWERS = {  # port converter, JAX converter, HF model, the tower it feeds
    "dinov2": (convert.convert_dinov2, jconv.convert_dinov2, hf.dinov2_model, "DINO2_LARGE"),
    "siglip": (convert.convert_siglip_vision, jconv.convert_siglip_vision, hf.siglip_model,
               "SigLIP_SO"),
    "wavlm": (convert.convert_wavlm, jconv.convert_wavlm, hf.wavlm_model, "WAVLM_LARGE"),
    "data2vec": (convert.convert_data2vec_audio, jconv.convert_data2vec_audio,
                 hf.data2vec_audio_model, "DATA2VEC_BASE"),
}


def _to_jax_bf16(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype=jnp.bfloat16)), tree)


def _run_both(name, want_tree, got_tree):
    """The JAX tree through JAX's tower and the port's through the port's."""
    jget, tget = _specs(name)
    jcfg, tcfg = _configs(name)
    x = _inputs(name)
    want = _np(jget(name).encode(jax.tree.map(jnp.asarray, want_tree), jcfg, jnp.asarray(x)))
    got = tget(name).encode(got_tree, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("tower", list(HF_TOWERS))
@pytest.mark.parametrize("save", ["safetensors", "bin"])
def test_hf_converter_equals_jax(tmp_path, tower, save):
    port_fn, jax_fn, make, name = HF_TOWERS[tower]
    make().save_pretrained(str(tmp_path), safe_serialization=save == "safetensors")
    want = jax_fn(str(tmp_path))
    got = port_fn(str(tmp_path), dtype=torch.float32, device="cpu")
    hf.assert_same_tree(want, got)
    key = "visual_encoder" if ZOO[name][2] == "frames" else "acoustic_encoder"
    convert.check_tower(key, got, _configs(name)[1])
    _run_both(name, want, got)
    hf.assert_same_tree(_to_jax_bf16(want), port_fn(str(tmp_path), dtype=torch.bfloat16,
                                                    device="cpu"))


@pytest.mark.parametrize("which", ["eva", "imagebind"])
@pytest.mark.parametrize("form", ["torch", "numpy"])
def test_raw_state_converters_equal_jax(which, form):
    state = hf.eva_state() if which == "eva" else hf.imagebind_audio_state()
    if form == "numpy":
        state = {k: v.numpy() for k, v in state.items()}
    port_fn, jax_fn, name = ((eva_vit.convert_eva_state, jeva.convert_eva_state,
                              "EVA_CLIP_G_NO_QFORMER") if which == "eva" else
                             (imagebind_audio.convert_imagebind_audio,
                              jib.convert_imagebind_audio, "IMAGEBIND"))
    want = jax_fn(state)
    got = port_fn(state, device="cpu")
    hf.assert_same_tree(want, got)
    _run_both(name, want, got)
    hf.assert_same_tree(jax_fn(state, dtype=jnp.bfloat16), port_fn(state, dtype=torch.bfloat16,
                                                                   device="cpu"))


def test_imagebind_on_transform_audio_mels_matches_jax():
    """The tower on mel clips from each package's transform_audio of the
    same 2 s clips (the realtime path's audio for IMAGEBIND), at huge's mel
    geometry with a 2-layer, width-16 trunk."""
    jcfg = dataclasses.replace(jib.ImageBindAudioConfig.huge(), width=16, num_layers=2,
                               num_heads=2, mlp_dim=32, out_embed_dim=12)
    tcfg = imagebind_audio.ImageBindAudioConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, jib.init_params(jax.random.PRNGKey(3), jcfg, jnp.float32))
    clips = np.random.RandomState(4).randn(3, 1, 32000).astype(np.float32) * 0.1
    jmels = jaudio.transform_audio(jnp.asarray(clips))
    tmels = audio.transform_audio(torch.from_numpy(clips))
    assert tuple(tmels.shape) == (3, 1, 128, 204)
    want = _np(jib.encode_clips(jax.tree.map(jnp.asarray, tree), jcfg, jmels[None]))
    got = imagebind_audio.encode_clips(convert.tree_to_torch(tree, "cpu"), tcfg, tmels[None])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Llama-2 and Baichuan2 models end to end

LLMS = {  # name → (visual tower, acoustic tower)
    "Llama2": ("SigLIP_SO", "WAVLM_LARGE"),
    "Baichuan2": ("DINO2_LARGE", "IMAGEBIND"),
}


def _tiny_llm(cls):
    """A tiny LLM of the two families' form: MHA, no qkv bias."""
    return dataclasses.replace(cls.tiny(vocab_size=768), num_kv_heads=4, qkv_bias=False,
                               rms_eps=1e-5)


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("llm_tokenizers")
    hf.write_llama2_tokenizer(root / "Llama2")
    hf.write_sentencepiece_model(root / "Baichuan2", "bpe", add_dummy_prefix=False)
    return root


def _tokenizers(root, llm):
    """(JAX's tokenizer or its oracle, the port's) of the LLM family."""
    saved = tpaths.PATH_TO_LLM.get(llm), jpaths.PATH_TO_LLM.get(llm)
    tpaths.PATH_TO_LLM[llm] = jpaths.PATH_TO_LLM[llm] = str(root / llm)
    try:
        port = ttok.load_tokenizer(llm)
        oracle = jtok.load_tokenizer(llm) if llm == "Llama2" else hf_bpe_oracle(root / llm)
    finally:
        tpaths.PATH_TO_LLM[llm], jpaths.PATH_TO_LLM[llm] = saved
    return oracle, port


def _models(llm):
    vis, aud = LLMS[llm]
    (jv, tv), (ja_, ta_) = _configs(vis), _configs(aud)
    dims = dict(visual_dim=jv.width, acoustic_dim=getattr(ja_, "out_embed_dim",
                                                          getattr(ja_, "hidden_size", None)))
    jcfg = dataclasses.replace(ja.AffectGPTConfig.tiny(), llm=_tiny_llm(jq.QwenConfig),
                               visual_encoder_name=vis, acoustic_encoder_name=aud,
                               vision_cfg_override=jv, audio_cfg_override=ja_, **dims)
    tcfg = dataclasses.replace(ta.AffectGPTConfig.tiny(), llm=_tiny_llm(qwen2.QwenConfig),
                               visual_encoder_name=vis, acoustic_encoder_name=aud,
                               vision_cfg_override=tv, audio_cfg_override=ta_, **dims)
    frozen = jax.tree.map(np.asarray, ja.init_frozen(jax.random.PRNGKey(0), jcfg,
                                                     dtype=jnp.float32))
    frozen["visual_encoder"], frozen["acoustic_encoder"] = _tower(vis), _tower(aud)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    trainable = jax.tree.map(lambda x: np.asarray(x) * 25.0, trainable)  # O(1) mergers
    tfrozen, ttrain = convert.from_jax(frozen, trainable, tcfg, device="cpu")
    jfrozen = jax.tree.map(jnp.asarray, frozen)
    jfrozen["llm"] = jq.merge_lora(jfrozen["llm"], jax.tree.map(jnp.asarray, trainable["lora"]),
                                   jcfg.llm)
    tfrozen, ttrain = bootstrap.serving_llm(tfrozen, ttrain, tcfg)
    return jcfg, jfrozen, {**jax.tree.map(jnp.asarray, trainable), "lora": None}, tcfg, \
        tfrozen, ttrain


def _raw(llm, b):
    rng = np.random.RandomState(b)
    raw = {"frame": rng.randint(0, 256, size=(b, 4, 40, 56, 3)).astype(np.uint8),
           "face": rng.randint(0, 256, size=(b, 4, 12, 12, 3)).astype(np.uint8)}
    raw["audio"] = _inputs(LLMS[llm][1], b=b, t=3)
    return raw


@pytest.mark.parametrize("llm", list(LLMS))
def test_llm_family_answers_as_jax(tokenizer_dirs, llm):
    oracle, port = _tokenizers(tokenizer_dirs, llm)
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models(llm)
    raw = _raw(llm, 2)
    jfeats = jax_encode_media(jfrozen, jcfg, {m: jnp.asarray(v) for m, v in raw.items()})
    feats = encode_media_features(tfrozen, tcfg, {m: torch.from_numpy(v) for m, v in raw.items()})
    assert feats.keys() == jfeats.keys() == {"frame", "face", "audio"}
    for m in feats:
        np.testing.assert_allclose(feats[m].numpy(), _np(jfeats[m]), rtol=1e-4, atol=1e-4)
    subtitles = ["so happy", "leave me alone, 你好"]
    kw = dict(max_new_tokens=8, do_sample=False)
    want = JaxChat(jfrozen, jtrain, jcfg, oracle, max_len=512).answer_batch(
        MODE, subtitles, "Emotions?", jfeats, **kw)
    got = Chat(tfrozen, ttrain, tcfg, port, max_len=512).answer_batch(
        MODE, subtitles, "Emotions?", feats, **kw)
    assert got == want and len(got) == 2


def test_imagebind_in_bf16_takes_f32_mels():
    """A difference from JAX, kept: JAX's encode_mels casts the mels to the
    weights' dtype but the stem kernel to the mels' dtype, so bf16 weights on
    the f32 mels of transform_audio raise in lax.conv. The port runs the
    stem in the weights' dtype, which is JAX's function on bf16 mels
    (within bf16 rounding: rtol 2^-7 of the largest output)."""
    jcfg, tcfg = _configs("IMAGEBIND")
    tree = jib.init_params(jax.random.PRNGKey(2), jcfg, jnp.bfloat16)
    mels = _inputs("IMAGEBIND")
    with pytest.raises(TypeError, match="same dtypes"):
        jib.encode_clips(tree, jcfg, jnp.asarray(mels))
    want = _np(jib.encode_clips(tree, jcfg, jnp.asarray(mels, jnp.bfloat16)))
    got = imagebind_audio.encode_clips(convert.tree_to_torch(jax.tree.map(np.asarray, tree), "cpu"),
                                       tcfg, torch.from_numpy(mels))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).max()))


def test_siglip_at_an_image_size_patches_do_not_divide():
    """A fault of JAX's repaired in the port: SigLIP so400m's registry
    geometry is 384 px at patch 14, which JAX's patchify cannot reshape
    (384 = 27 x 14 + 6). HF's patch convolution drops the last 6 pixels and
    makes 27 x 27 = 729 patches; so does the port's patchify. Held here on
    a tiny HF SiglipVisionModel at 36 px, patch 16 (2 x 2 patches, 4 pixels
    dropped), within 1e-5 of HF's mean-pooled last hidden state."""
    from transformers import SiglipVisionConfig, SiglipVisionModel

    torch.manual_seed(0)
    model = hf._perturbed(SiglipVisionModel(SiglipVisionConfig(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
        image_size=36, patch_size=16, attn_implementation="eager")))
    images = np.random.RandomState(0).randn(2, 36, 36, 3).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(images).permute(0, 3, 1, 2)).last_hidden_state.mean(1)
    cfg = vit_variants.SiglipConfig(image_size=36, patch_size=16, width=16, num_layers=2,
                                    num_heads=2, mlp_dim=32)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = jax.tree.map(np.asarray, _siglip_tree_from_state(state))
    got = vit_variants.siglip_encode(convert.tree_to_torch(tree, "cpu"), cfg,
                                     torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    with pytest.raises(TypeError):  # JAX's reshape of 36 px into 16 px patches
        jvv.siglip_encode(jax.tree.map(jnp.asarray, tree),
                          jvv.SiglipConfig(**dataclasses.asdict(cfg)), jnp.asarray(images))
    assert vit_variants.siglip_encode(
        convert.tree_to_torch(tree, "cpu"), cfg,
        torch.from_numpy(np.ascontiguousarray(images[:, :32, :32]))).shape == got.shape


def _siglip_tree_from_state(state):
    """JAX's convert_siglip_vision on a state dict in memory (its directory
    reader needs a file): the same tree."""
    import tempfile

    import safetensors.numpy

    with tempfile.TemporaryDirectory() as d:
        safetensors.numpy.save_file(state, f"{d}/model.safetensors")
        return jconv.convert_siglip_vision(d)
