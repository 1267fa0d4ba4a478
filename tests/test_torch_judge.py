"""The port's judge against the JAX package's: every prompt string for
string, `postprocess_response` and the LexiconJudge's outputs equal, and
`LLMJudge.complete_batch` on a tiny f32 Qwen (JAX's weights through
`tree_to_torch`) giving identical texts with both judges built with
top_p=1e-6, where the nucleus keeps only the top token, so the draws of
JAX's PRNG and torch's generator cannot part them (JAX code unchanged:
top_p is a constructor argument)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from affectgpt_tpu.evaluation import judge as jjudge
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch.evaluation import judge as tjudge
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer

TEXTS = ["He smiles warmly.", "", "[happy, sad]", "Ünïcode 你好；Output: x", "a\nb  ", "Input: y"]
PROMPTS_1 = ["prompt_reason_to_openset", "prompt_openset_to_sentiment",
             "prompt_reason_to_valence"]
PROMPTS_CANDIDATES = ["prompt_openset_to_onehot", "prompt_reason_to_rank",
                      "prompt_reason_to_onehot"]


@pytest.mark.parametrize("name", PROMPTS_1 + PROMPTS_CANDIDATES)
def test_prompts_equal_jax(name):
    for text in TEXTS:
        assert getattr(tjudge, name)(text) == getattr(jjudge, name)(text)
        if name in PROMPTS_CANDIDATES:
            assert getattr(tjudge, name)(text, "joy, fear") == \
                getattr(jjudge, name)(text, "joy, fear")


def test_reason_merge_prompt_equals_jax():
    for reason in TEXTS:
        for subtitle in TEXTS[:1] + TEXTS[2:]:
            assert tjudge.prompt_reason_merge(reason, subtitle) == \
                jjudge.prompt_reason_merge(reason, subtitle)
    for mod in (tjudge, jjudge):
        with pytest.raises(ValueError, match="subtitle cannot be empty"):
            mod.prompt_reason_merge("clue", "")


PREFIXED = ["Output: [happy]", "  output: x\n", "输出：[悲伤]", "翻译: y", "Input:\n z\n",
            "让我们来翻译一下：a", "inputoutput: b", "[sad, angry]", ""]


@settings(max_examples=80, deadline=None)
@given(prefix=st.sampled_from(PREFIXED), body=st.text(max_size=20))
def test_postprocess_response_equals_jax(prefix, body):
    for text in (prefix, prefix + body, body + prefix):
        assert tjudge.postprocess_response(text) == jjudge.postprocess_response(text)


@pytest.mark.parametrize("vocabulary", [None, ["happy", "sad", "very happy", "happy (very)"]])
def test_lexicon_judge_equals_jax(vocabulary):
    reasons = ["He is very happy today, happy (very)!", "Nothing emotional here.",
               "sad and Happy; clearly angry tone", "joyful, worried, surprise", ""]
    port, jax_judge = tjudge.LexiconJudge(vocabulary), jjudge.LexiconJudge(vocabulary)
    assert port.vocabulary == jax_judge.vocabulary
    opensets = port.reason_to_openset(reasons)
    assert opensets == jax_judge.reason_to_openset(reasons)
    assert port.openset_to_sentiment(opensets) == jax_judge.openset_to_sentiment(opensets)
    assert port.reason_merge(reasons, TEXTS[:5]) == jax_judge.reason_merge(reasons, TEXTS[:5])
    for cands in ("happy, angry, worried, sad, surprise, neutral", "joyful, sad"):
        assert port.reason_to_rank(reasons, cands) == jax_judge.reason_to_rank(reasons, cands)
        assert port.reason_to_onehot(reasons, cands) == \
            jax_judge.reason_to_onehot(reasons, cands)


@functools.lru_cache(maxsize=None)
def _llm():
    cfg = jq.QwenConfig.tiny()
    params = jq.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    # a larger head spreads the logits: no near-tie decides a token
    params = {**params, "lm_head": {"w": params["lm_head"]["w"] * 40.0}}
    return cfg, tq.QwenConfig.tiny(), params, convert.tree_to_torch(
        jax.tree.map(np.asarray, params), "cpu")


def judges(max_new: int = 20):
    jcfg, tcfg, params, tparams = _llm()
    kw = dict(max_new_tokens=max_new, top_p=1e-6)
    return (jjudge.LLMJudge(params, jcfg, ByteTokenizer(), **kw),
            tjudge.LLMJudge(tparams, tcfg, TorchByteTokenizer(), **kw))


REASONS = [f"Clip {i}: the speaker {w}." for i, w in enumerate(
    ["smiles", "frowns and sighs", "shouts", "is quiet", "laughs loudly", "cries",
     "shrugs", "stares", "grins", "trembles"])]


def test_complete_batch_equals_jax_at_tiny_top_p():
    jax_judge, port = judges()
    assert (port.temperature, port.top_p, port.max_new_tokens) == (0.7, 1e-6, 20)
    prompts = [tjudge.prompt_reason_to_openset(r) for r in REASONS]
    want = jax_judge.complete_batch(prompts)  # two chunks: 8 prompts, then 2
    got = port.complete_batch(prompts)
    assert got == want and len(got) == len(REASONS) and any(got)


def test_judge_methods_equal_jax_at_tiny_top_p():
    jax_judge, port = judges(12)
    opensets = ["[happy]", "[]", "[sad, angry]"]
    assert port.openset_to_sentiment(opensets) == jax_judge.openset_to_sentiment(opensets)
    assert port.reason_to_onehot(REASONS[:3]) == jax_judge.reason_to_onehot(REASONS[:3])


def test_complete_batch_seeds_each_chunk_from_its_start(monkeypatch):
    """Sampled at the default T 0.7, top-p 0.8: each chunk's generator is
    seeded with the chunk's start (JAX's PRNGKey(start)), on the device of
    the weights, so a run repeats itself."""
    _, tcfg, _, tparams = _llm()
    port = tjudge.LLMJudge(tparams, tcfg, TorchByteTokenizer(), max_new_tokens=8)
    seeds = []
    generate = tgen.generate

    def record(*args, **kwargs):
        gen_cfg, generator = args[2], args[5]
        assert gen_cfg.do_sample and (gen_cfg.temperature, gen_cfg.top_p) == (0.7, 0.8)
        seeds.append((generator.initial_seed(), generator.device.type))
        return generate(*args, **kwargs)

    monkeypatch.setattr(tgen, "generate", record)
    prompts = [tjudge.prompt_reason_to_openset(r) for r in REASONS[:5]]
    first = port.complete_batch(prompts, batch_size=2)
    assert seeds == [(0, "cpu"), (2, "cpu"), (4, "cpu")]
    assert port.complete_batch(prompts, batch_size=2) == first
    assert torch.is_tensor(tparams["embed_tokens"]["table"])
