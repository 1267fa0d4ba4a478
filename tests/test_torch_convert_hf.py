"""The port's HF checkpoint converters (affectgpt_tpu_torch/models/convert.py)
against the JAX package's on tiny HF models built from configs: every
converted tree must equal JAX's bit for bit in f32 (and in bf16, after the
JAX bootstrap's cast), from one safetensors file, sharded safetensors with
an index, `.bin` files and bf16 checkpoints. JAX's reader cannot open a
bf16 safetensors file (numpy has no bfloat16), so the port's bf16
safetensors tree is held to JAX's tree of the same weights saved as `.bin`.
Also `llm_config_from_hf`, `convert_reference_affectgpt` on a synthetic
reference state (attention and Q-Former fusions), greedy tokens of the
loaded tiny Qwen2, and the bootstrap's model-directory branch with both
packages' Qwen25 preset (and tower specs) set to the tiny HF geometry."""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("transformers")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from affectgpt_tpu import bootstrap as jboot  # noqa: E402
from affectgpt_tpu.inference import generate as jgen  # noqa: E402
from affectgpt_tpu.models import convert as jconv  # noqa: E402
from affectgpt_tpu.models import qwen2 as jq  # noqa: E402
from affectgpt_tpu_torch import bootstrap as tboot  # noqa: E402
from affectgpt_tpu_torch import paths as tpaths  # noqa: E402
from affectgpt_tpu_torch.inference import generate as tgen  # noqa: E402
from affectgpt_tpu_torch.models import clip_vit, convert, hubert  # noqa: E402
from affectgpt_tpu_torch.models import qwen2 as tq  # noqa: E402
from affectgpt_tpu_torch.tokenization import TokenizerWrapper  # noqa: E402
from tests import torch_hf_models as hf  # noqa: E402

SAVES = {  # how a checkpoint directory is written
    "safetensors": dict(safe_serialization=True),
    "sharded": dict(safe_serialization=True, max_shard_size="20KB"),
    "bin": dict(safe_serialization=False),
}


def port(fn, model_dir, dtype=torch.float32):
    return fn(str(model_dir), dtype=dtype, device="cpu")


def to_jax_bf16(tree):
    return jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype=jnp.bfloat16)), tree)


@pytest.fixture(scope="module")
def qwen_dirs(tmp_path_factory):
    """The tiny Qwen2 saved every way of SAVES, and in bf16 as safetensors
    and as `.bin`."""
    root = tmp_path_factory.mktemp("qwen")
    model = hf.qwen2_model(seed=0)
    for name, kw in SAVES.items():
        model.save_pretrained(str(root / name), **kw)
    bf16 = hf.qwen2_model(seed=0).to(torch.bfloat16)
    bf16.save_pretrained(str(root / "bf16_safetensors"), safe_serialization=True)
    bf16.save_pretrained(str(root / "bf16_bin"), safe_serialization=False)
    return root


@pytest.mark.parametrize("save", sorted(SAVES))
def test_qwen2_equals_jax(qwen_dirs, save):
    model_dir = qwen_dirs / save
    if save == "sharded":
        index = json.loads((model_dir / "model.safetensors.index.json").read_text())
        assert len(set(index["weight_map"].values())) > 1
    want = jconv.convert_qwen2(str(model_dir))
    hf.assert_same_tree(want, port(convert.convert_qwen2, model_dir))
    hf.assert_same_tree(to_jax_bf16(want), port(convert.convert_qwen2, model_dir, torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qwen2_bf16_checkpoint_equals_jax(qwen_dirs, dtype):
    want = jconv.convert_qwen2(str(qwen_dirs / "bf16_bin"))
    if dtype == torch.bfloat16:
        want = to_jax_bf16(want)
    for save in ("bf16_safetensors", "bf16_bin"):
        hf.assert_same_tree(want, port(convert.convert_qwen2, qwen_dirs / save, dtype))


def test_safetensors_reader_reads_every_dtype(tmp_path):
    from safetensors.torch import save_file

    tensors = {"bf16": torch.randn(3, 5).to(torch.bfloat16), "f16": torch.randn(7).half(),
               "f32": torch.randn(2, 3, 4), "scalar": torch.tensor(2.5), "empty": torch.ones(0, 4)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    state = convert.CheckpointState(str(tmp_path))
    assert sorted(state.keys()) == sorted(tensors)
    for key, value in tensors.items():
        assert state[key].dtype == value.dtype and torch.equal(state[key], value), key


def test_llm_config_from_hf(qwen_dirs, tmp_path):
    from transformers import LlamaConfig, LlamaForCausalLM

    def fields(c):
        return {f.name: getattr(c, f.name) for f in dataclasses.fields(jq.QwenConfig)}

    torch.manual_seed(1)
    llama = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, head_dim=8, rms_norm_eps=1e-5))
    llama.save_pretrained(str(tmp_path / "llama"))
    for model_dir in (qwen_dirs / "safetensors", tmp_path / "llama"):
        want = jconv.llm_config_from_hf(str(model_dir), lora_r=4)
        assert fields(want) == fields(convert.llm_config_from_hf(str(model_dir), lora_r=4))
    got = convert.llm_config_from_hf(str(tmp_path / "llama"))
    assert not got.qkv_bias and got.num_kv_heads == 4 and got.rms_eps == 1e-5
    hf.assert_same_tree(jconv.convert_llama(str(tmp_path / "llama")),
                        port(convert.convert_llama, tmp_path / "llama"))


@pytest.mark.parametrize("save", ["bin", "safetensors"])
def test_baichuan2_equals_jax(tmp_path, save):
    """Baichuan2's format on the synthetic state of tests/test_convert_parity.py:
    a Llama whose q/k/v are fused into W_pack, the head's raw weight kept
    for the NormHead fold."""
    from safetensors.torch import save_file
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(3)
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4, head_dim=8, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False))
    with torch.no_grad():  # rows of unequal norms
        model.lm_head.weight.mul_(torch.rand(128, 1) * 3)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    state = {}
    for i in range(2):
        p = f"model.layers.{i}"
        state[f"{p}.self_attn.W_pack.weight"] = torch.cat(
            [sd.pop(f"{p}.self_attn.{n}_proj.weight") for n in ("q", "k", "v")], dim=0)
    state.update(sd)
    model_dir = tmp_path / "baichuan"
    model_dir.mkdir()
    if save == "bin":
        torch.save(state, model_dir / "pytorch_model.bin")
    else:
        save_file(state, str(model_dir / "model.safetensors"))
    (model_dir / "config.json").write_text(json.dumps({
        "architectures": ["BaichuanForCausalLM"], "vocab_size": 128, "hidden_size": 32,
        "intermediate_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "rms_norm_eps": 1e-6}))
    want = jconv.convert_baichuan2(str(model_dir))
    hf.assert_same_tree(want, port(convert.convert_baichuan2, model_dir))
    hf.assert_same_tree(to_jax_bf16(want),
                        port(convert.convert_baichuan2, model_dir, torch.bfloat16))
    assert not convert.llm_config_from_hf(str(model_dir)).qkv_bias


def test_baichuan2_head_norms_in_row_blocks(monkeypatch):
    """The fold's row norms do not depend on how the rows are blocked."""
    head = torch.randn(37, 24)
    want = np.linalg.norm(head.numpy(), axis=-1, keepdims=True)
    monkeypatch.setattr(convert, "_NORM_ROWS", 5)
    np.testing.assert_array_equal(convert._row_norms(head), want)


@pytest.mark.parametrize("save", sorted(SAVES))
def test_clip_towers_equal_jax(tmp_path, save):
    vision = hf.clip_model(projection_dim=12)
    vision.save_pretrained(str(tmp_path / "v"), **SAVES[save])
    text = hf.clip_model(projection_dim=8, seed=1)
    text.save_pretrained(str(tmp_path / "t"), **SAVES[save])
    want = jconv.convert_clip_vision(str(tmp_path / "v"))
    got = port(convert.convert_clip_vision, tmp_path / "v")
    hf.assert_same_tree(want, got)
    convert.check_trees({"llm": _tiny_llm(), "visual_encoder": got}, {},
                        _cfg_with(vision=clip_vit.ClipVisionConfig.tiny()))
    hf.assert_same_tree(jconv.convert_clip_text(str(tmp_path / "t")),
                        port(convert.convert_clip_text, tmp_path / "t"))
    convert.check_text_tower(port(convert.convert_clip_text, tmp_path / "t"),
                             clip_vit.ClipTextConfig.tiny())


@pytest.mark.parametrize("form", ["parametrizations", "weight_g", "plain"])
@pytest.mark.parametrize("bf16", [False, True])
def test_hubert_equals_jax(tmp_path, form, bf16):
    model = hf.hubert_model()
    if bf16:
        model = model.to(torch.bfloat16)
    torch.save(hf.hubert_state(model, form), tmp_path / "pytorch_model.bin")
    want = jconv.convert_hubert(str(tmp_path))
    got = port(convert.convert_hubert, tmp_path)
    hf.assert_same_tree(want, got)
    convert.check_trees({"llm": _tiny_llm(), "acoustic_encoder": got}, {},
                        _cfg_with(audio=hubert.HubertConfig.tiny()))
    hf.assert_same_tree(to_jax_bf16(want), port(convert.convert_hubert, tmp_path, torch.bfloat16))


def test_hubert_safetensors_equals_jax(tmp_path):
    hf.hubert_model().save_pretrained(str(tmp_path), safe_serialization=True)
    hf.assert_same_tree(jconv.convert_hubert(str(tmp_path)),
                        port(convert.convert_hubert, tmp_path))


def _tiny_llm():
    return tq.init_params(torch.Generator().manual_seed(0), tq.QwenConfig.tiny(),
                          dtype=torch.float32)


def _cfg_with(vision=None, audio=None):
    from affectgpt_tpu_torch.models import affectgpt

    return dataclasses.replace(affectgpt.AffectGPTConfig.tiny(), vision_cfg_override=vision,
                               audio_cfg_override=audio)


# ---------------------------------------------------------------------------
# convert_reference_affectgpt


def reference_state(fusion: str, seed: int = 0) -> dict:
    """A synthetic reference AffectGPT.state_dict(): a peft-wrapped 2-layer
    LLM, the mergers and the multi pre-fusion of `fusion` ("attention" or
    "qformer"), torch tensors and numpy arrays mixed (values random, shapes
    only as wide as the keys need)."""
    rng = np.random.RandomState(seed)
    h, r, q = 8, 2, 6
    state = {}

    def put(key, *shape):
        arr = rng.randn(*shape).astype(np.float32)
        state[key] = torch.from_numpy(arr) if len(state) % 2 else arr

    base = "llama_model.base_model.model"
    put(f"{base}.model.embed_tokens.weight", 20, h)
    put(f"{base}.model.norm.weight", h)
    put(f"{base}.lm_head.weight", 20, h)
    for i in range(2):
        p = f"{base}.model.layers.{i}"
        for name, mod in (("q_proj", "self_attn"), ("k_proj", "self_attn"),
                          ("v_proj", "self_attn"), ("o_proj", "self_attn"),
                          ("gate_proj", "mlp"), ("up_proj", "mlp"), ("down_proj", "mlp")):
            put(f"{p}.{mod}.{name}.base_layer.weight", h + 2, h)
            if name in ("q_proj", "k_proj", "v_proj"):
                put(f"{p}.{mod}.{name}.base_layer.bias", h + 2)
            put(f"{p}.{mod}.{name}.lora_A.default.weight", r, h)
            put(f"{p}.{mod}.{name}.lora_B.default.weight", h + 2, r)
        put(f"{p}.input_layernorm.weight", h)
        put(f"{p}.post_attention_layernorm.weight", h)

    def dense(name, out, inp):
        put(f"{name}.weight", out, inp)
        put(f"{name}.bias", out)

    def qformer(prefix, query_key, cross_layers):
        put(query_key, 1, 4, q)
        put(f"{prefix}.bert.embeddings.LayerNorm.weight", q)
        put(f"{prefix}.bert.embeddings.LayerNorm.bias", q)
        for j, cross in enumerate(cross_layers):
            p = f"{prefix}.bert.encoder.layer.{j}"
            for name in ("query", "key", "value"):
                dense(f"{p}.attention.self.{name}", q, q)
            dense(f"{p}.attention.output.dense", q, q)
            for ln in ("attention.output.LayerNorm", "output_query.LayerNorm"):
                put(f"{p}.{ln}.weight", q)
                put(f"{p}.{ln}.bias", q)
            dense(f"{p}.intermediate_query.dense", 2 * q, q)
            dense(f"{p}.output_query.dense", q, 2 * q)
            if cross:
                for name in ("query", "key", "value"):
                    dense(f"{p}.crossattention.self.{name}", q, 5)
                dense(f"{p}.crossattention.output.dense", q, q)
                put(f"{p}.crossattention.output.LayerNorm.weight", q)
                put(f"{p}.crossattention.output.LayerNorm.bias", q)

    if fusion == "qformer":
        for group, pos in (("video", "video_frame_position_embedding"),
                           ("audio", "audio_position_embedding"), ("au", "au_position_embedding")):
            qformer(f"{group}_Qformer", f"{group}_query_tokens", (True, False))
            put(f"{pos}.weight", 8, 5)
        qformer("multi_Qformer", "multi_query_tokens", (True,))
        put("multi_position_embedding.weight", 16, 5)
    else:
        for name in ("video_attention_mlp", "audio_attention_mlp", "au_attention_mlp"):
            dense(name, 1, 5)
        dense("attention_mlp", 3, 10)
        dense("fc_att", 2, 3)
    for name in ("affectgpt_proj", "audio_llama_proj", "au_llama_proj", "image_llama_proj",
                 "multi_llama_proj"):
        dense(name, h, q if fusion == "qformer" else 5)
    dense("multi_video_embs", 5, 5)
    dense("multi_audio_embs", 5, 5)
    return state


@pytest.mark.parametrize("fusion", ["attention", "qformer"])
def test_reference_affectgpt_equals_jax(fusion):
    state = reference_state(fusion)
    want = jconv.convert_reference_affectgpt(state)
    got = convert.convert_reference_affectgpt(state, device="cpu")
    hf.assert_same_tree(want, got)
    assert ("qformer" in got["trainable"]["multi"]) == (fusion == "qformer")
    assert ("qformer" in got["trainable"]["mergers"]["video"]) == (fusion == "qformer")
    hf.assert_same_tree(to_jax_bf16(want),
                        convert.convert_reference_affectgpt(state, torch.bfloat16, "cpu"))


# ---------------------------------------------------------------------------
# The loaded model


def test_loaded_qwen2_gives_jax_greedy_tokens(qwen_dirs):
    model_dir = str(qwen_dirs / "sharded")
    jcfg = hf.qwen_config(jq.QwenConfig)
    tcfg = hf.qwen_config(tq.QwenConfig)
    assert convert.llm_config_from_hf(model_dir).hidden_size == tcfg.hidden_size
    jparams = jax.tree.map(jnp.asarray, jconv.convert_qwen2(model_dir))
    tparams = convert.convert_qwen2(model_dir, device="cpu")
    ids = np.random.RandomState(0).randint(0, hf.LLM_VOCAB, (2, 9))
    want, _ = jgen.generate(
        jparams, jcfg, jgen.GenerateConfig(max_new_tokens=12, do_sample=False, eos_token_id=-1),
        jq.embed_tokens(jparams, jnp.asarray(ids)), jnp.full((2,), 9), jax.random.PRNGKey(0),
        max_len=32)
    got, _ = tgen.generate(
        tparams, tcfg, tgen.GenerateConfig(max_new_tokens=12, do_sample=False, eos_token_id=-1),
        tq.embed_tokens(tparams, torch.as_tensor(ids)), torch.full((2,), 9), None, max_len=32)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.fixture()
def tiny_presets(monkeypatch):
    hf.set_tiny_presets(monkeypatch)


@pytest.fixture()
def model_dirs(tmp_path, monkeypatch):
    return hf.write_model_dirs(tmp_path, monkeypatch)


NODE = {"llama_model": "Qwen25", "lora_r": 4, "preextracted_visual_dim": 12,
        "preextracted_acoustic_dim": 16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bootstrap_loads_the_directories_as_jax(tiny_presets, model_dirs, dtype):
    from affectgpt_tpu.config import Config

    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg, jfrozen, _, jtok = jboot.build_model(Config.from_dict({"model": NODE}),
                                               with_encoders=True, dtype=jdtype)
    cfg, frozen, trainable, tok = tboot.build_model(NODE, with_encoders=True, device="cpu",
                                                    dtype=dtype)
    assert isinstance(tok, TokenizerWrapper)
    assert (tok.vocab_size, tok.eos_token_id, tok.patch_token_ids) == \
        (jtok.vocab_size, jtok.eos_token_id, jtok.patch_token_ids)
    assert cfg.llm == hf.qwen_config(tq.QwenConfig, lora_r=4)
    hf.assert_same_tree(jax.tree.map(np.asarray, jfrozen), frozen)
    assert [len(trainable["lora"]["layers"])] == [cfg.llm.num_layers]


def test_bootstrap_raises_on_a_geometry_mismatch(tiny_presets, model_dirs, monkeypatch):
    monkeypatch.setattr(tq.QwenConfig, "qwen25_7b", classmethod(
        lambda cls, vocab_size=hf.LLM_VOCAB, lora_r=16: dataclasses.replace(
            hf.qwen_config(cls, vocab_size, lora_r), num_layers=3)))
    with pytest.raises(ValueError, match="layer count"):
        tboot.build_model(NODE, device="cpu")


def test_bootstrap_int8_and_baichuan_route(tiny_presets, model_dirs, monkeypatch):
    _, frozen, _, _ = tboot.build_model({**NODE, "int8": True}, device="cpu")
    assert "w_q" in frozen["llm"]["layers"][0]["q_proj"]
    monkeypatch.setitem(tpaths.PATH_TO_LLM, "Baichuan2", str(model_dirs / "llm"))
    # its tokenizer is the directory's sentencepiece model, which a Qwen2
    # directory lacks
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        tboot.build_model({"llama_model": "Baichuan2"}, device="cpu")
