"""The repetition penalty in the port against the JAX package, in f32 on the
CPU: `apply_repetition_penalty` bit for bit against JAX's compiled function,
`_seen_from_prompt`, greedy `generate` with penalty 1.1 with and without
prompt_ids (identical tokens), and `Chat.answer_batch(repetition_penalty=
1.1, do_sample=False)` (identical strings)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.inference import generate as jgen
from affectgpt_tpu.inference.chat import Chat as JaxChat
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.inference.chat import Chat
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer

from test_torch_chat import MODE, QUESTION, SUBTITLES, _models


@pytest.mark.parametrize("penalty", [1.1, 1.3, 0.9])
def test_apply_repetition_penalty_matches_jax_bits(penalty):
    rng = np.random.RandomState(0)
    logits = (rng.randn(8, 1000) * 8).astype(np.float32)
    seen = rng.rand(8, 1000) < 0.3
    want = jax.jit(functools.partial(jgen.apply_repetition_penalty, penalty=penalty))(
        jnp.asarray(logits), jnp.asarray(seen))
    got = tgen.apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen),
                                        penalty)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seen_from_prompt_matches_jax():
    rng = np.random.RandomState(1)
    b, t_pad, vocab = 4, 9, 40
    ids = rng.randint(0, vocab, (b, t_pad)).astype(np.int32)
    lengths = np.array([9, 3, 6, 1], np.int32)
    want = jgen._seen_from_prompt(jnp.asarray(ids), jnp.asarray(lengths), b, t_pad, vocab)
    got = tgen._seen_from_prompt(torch.from_numpy(ids), torch.from_numpy(lengths), b, t_pad,
                                 vocab)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[3].nonzero().flatten().tolist() == [ids[3, 0]]  # pads left out


@functools.lru_cache(maxsize=None)
def _llm():
    cfg = jq.QwenConfig.tiny()
    params = jq.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, tq.QwenConfig.tiny(), params, convert.tree_to_torch(
        jax.tree.map(np.asarray, params), "cpu")


@pytest.mark.parametrize("with_prompt_ids", [False, True])
def test_penalized_greedy_generate_matches_jax(with_prompt_ids):
    jcfg, tcfg, params, tparams = _llm()
    ids = np.array(jax.random.randint(jax.random.PRNGKey(2), (3, 8), 1, 256), np.int32)
    lengths = np.array([8, 5, 7], np.int32)
    ids[np.arange(8)[None, :] >= lengths[:, None]] = 0
    gk = dict(max_new_tokens=12, do_sample=False, eos_token_id=257, repetition_penalty=1.1)
    want = jgen.generate(params, jcfg, jgen.GenerateConfig(**gk),
                         jq.embed_tokens(params, jnp.asarray(ids)), jnp.asarray(lengths),
                         jax.random.PRNGKey(0), max_len=24,
                         prompt_ids=jnp.asarray(ids) if with_prompt_ids else None)
    tids = torch.from_numpy(ids).long()
    got = tgen.generate(tparams, tcfg, tgen.GenerateConfig(**gk), tq.embed_tokens(tparams, tids),
                        torch.from_numpy(lengths), None, max_len=24,
                        prompt_ids=tids if with_prompt_ids else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    plain = tgen.generate(tparams, tcfg, tgen.GenerateConfig(**{**gk, "repetition_penalty": 1.0}),
                          tq.embed_tokens(tparams, tids), torch.from_numpy(lengths), None,
                          max_len=24)
    assert not torch.equal(plain[0], got[0])  # the penalty changed the stream


@pytest.mark.parametrize("b", [2, 4])
def test_penalized_answer_batch_matches_jax_chat(b):
    jcfg, jfrozen, jtrain, tcfg, tfrozen, ttrain = _models()
    rng = np.random.RandomState(b)
    feats = {m: rng.randn(b, 8, d).astype(np.float32) for m, d in
             (("frame", jcfg.visual_dim), ("face", jcfg.visual_dim), ("audio", jcfg.acoustic_dim))}
    kw = dict(max_new_tokens=10, do_sample=False, repetition_penalty=1.1)
    want = JaxChat(jfrozen, jtrain, jcfg, ByteTokenizer(), max_len=512).answer_batch(
        MODE, SUBTITLES[:b], QUESTION, {m: jnp.asarray(v) for m, v in feats.items()}, **kw)
    got = Chat(tfrozen, ttrain, tcfg, TorchByteTokenizer(), max_len=512).answer_batch(
        MODE, SUBTITLES[:b], QUESTION, {m: torch.from_numpy(v) for m, v in feats.items()}, **kw)
    assert got == want and len(got) == b
