"""Chat.answer_batch in the port against the JAX Chat on the same converted
weights (LoRA merged on both sides), greedy, ByteTokenizer, f32: the
strings must be identical. Also bootstrap.build_model and serving_llm."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference.chat import Chat as JaxChat
from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference.chat import Chat
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer

MODE = "multiface_audio_face_frame_text"
SUBTITLES = ["so happy", "leave me", "what?!", "fine."]
QUESTION = "Emotions?"


@functools.lru_cache(maxsize=None)  # trees are only read, never mutated
def _models():
    jcfg = ja.AffectGPTConfig.tiny()
    frozen = ja.init_frozen(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    trainable = jax.tree_util.tree_map_with_path(  # nonzero LoRA B, O(1) mergers
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" and p[0].key == "lora" else x * 25.0, trainable)
    tcfg = ta.AffectGPTConfig.tiny()
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg,
                                       device="cpu")
    jfrozen = {**frozen, "llm": jq.merge_lora(frozen["llm"], trainable["lora"], jcfg.llm)}
    jtrain = {**trainable, "lora": None}
    tfrozen, ttrain = bootstrap.serving_llm(tfrozen, ttrain, tcfg)
    return jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain


@pytest.mark.parametrize("b", [2, 4])
def test_answer_batch_matches_jax_chat(b):
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models()
    assert ttrain["lora"] is None
    rng = np.random.RandomState(b)
    feats = {m: rng.randn(b, 8, d).astype(np.float32) for m, d in
             (("frame", jcfg.visual_dim), ("face", jcfg.visual_dim), ("audio", jcfg.acoustic_dim))}
    kw = dict(max_new_tokens=8, do_sample=False)
    want = JaxChat(jfrozen, jtrain, jcfg, ByteTokenizer(), max_len=512).answer_batch(
        MODE, SUBTITLES[:b], QUESTION, {m: jnp.asarray(v) for m, v in feats.items()}, **kw)
    chat = Chat(tfrozen, ttrain, tcfg, TorchByteTokenizer(), max_len=512)
    got = chat.answer_batch(MODE, SUBTITLES[:b], QUESTION,
                            {m: torch.from_numpy(v) for m, v in feats.items()}, **kw)
    assert got == want and len(got) == b

    jids, jlen, joffs = JaxChat(jfrozen, jtrain, jcfg, ByteTokenizer()).build_prompt_batch(
        MODE, SUBTITLES[:b], QUESTION)
    ids, lengths, offsets = chat.build_prompt_batch(MODE, SUBTITLES[:b], QUESTION)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(lengths, jlen)
    assert offsets.keys() == joffs.keys()
    for m in offsets:
        np.testing.assert_array_equal(offsets[m], joffs[m])


def test_build_model_tiny_and_serving_llm():
    cfg, frozen, trainable, tok = bootstrap.build_model(
        {"keep_full_llm": False, "lora_r": 4}, device="cpu", dtype=torch.float32, seed=3)
    assert isinstance(tok, TorchByteTokenizer)
    assert cfg.llm == tq.QwenConfig.tiny(vocab_size=300, lora_r=4)
    assert frozen["llm"]["embed_tokens"]["table"].shape == (300, cfg.llm.hidden_size)
    assert len(trainable["lora"]["layers"]) == cfg.llm.num_layers
    assert set(trainable["mergers"]) == {"video", "audio", "image", "au"}
    again = bootstrap.build_model({"keep_full_llm": False, "lora_r": 4}, device="cpu",
                                  dtype=torch.float32, seed=3)[1]
    assert torch.equal(again["llm"]["lm_head"]["w"], frozen["llm"]["lm_head"]["w"])

    served, strain = bootstrap.serving_llm(frozen, trainable, cfg)
    assert strain["lora"] is None
    # B starts at zero, so merging leaves the weights as they were
    assert torch.equal(served["llm"]["layers"][0]["q_proj"]["w"],
                       frozen["llm"]["layers"][0]["q_proj"]["w"])
    feats = {"face": torch.randn(2, 8, cfg.visual_dim), "audio": torch.randn(2, 8, cfg.acoustic_dim)}
    out = Chat(served, strain, cfg, tok, max_len=512).answer_batch(
        "multiface_audio_face_text", ["a", "b"], "Q?", feats, max_new_tokens=4, do_sample=True)
    assert len(out) == 2 and all(isinstance(s, str) for s in out)

    # the checkpoint overlays are ported: a missing checkpoint is a missing file
    with pytest.raises(FileNotFoundError):
        bootstrap.build_model({"keep_full_llm": False, "ckpt": "some.ckpt"}, device="cpu")
