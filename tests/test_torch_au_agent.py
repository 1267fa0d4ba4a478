"""The AU agent in the port against the JAX package, in f32 on the CPU: the
host helpers string for string; `generate_descriptions` with the
reference's temperature and repetition penalty at a top_p so small that
the nucleus keeps only the top token (sampling is then the argmax of the
penalized, tempered logits, whatever the random draws), identical strings;
the neutral row comes back without generating."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from affectgpt_tpu.models import au_agent as jau
from affectgpt_tpu.models import qwen2 as jq
from affectgpt_tpu.tokenization import ByteTokenizer
from affectgpt_tpu_torch.inference import generate as tgen
from affectgpt_tpu_torch.models import au_agent as tau
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.tokenization import ByteTokenizer as TorchByteTokenizer

ROWS = [
    {" AU01_r": "1.25", "AU04_r": 0.2, "AU12_r": 2.5, "AU45_c": 1.0, "frame": 3},
    {"AU06_r": 0.7, "AU99_r": 3.0, "AU26_r": "n/a"},
    {"AU01_r": 0.1, "AU02_r": 0.5},  # nothing above 0.5: neutral
]


def test_constants_match_jax():
    assert tau.AU_NAME_MAP == jau.AU_NAME_MAP
    assert tau.INSTRUCTION == jau.INSTRUCTION
    assert tau.NEUTRAL_DESCRIPTION == jau.NEUTRAL_DESCRIPTION


@pytest.mark.parametrize("row", range(len(ROWS)))
@pytest.mark.parametrize("desc", [None, "brows up"])
@pytest.mark.parametrize("threshold", [0.5, 0.05])
def test_host_helpers_match_jax(row, desc, threshold):
    au = tau.parse_openface_row(ROWS[row])
    assert au == jau.parse_openface_row(ROWS[row])
    text = tau.build_au_input(au, desc, threshold)
    assert text == jau.build_au_input(au, desc, threshold)
    if text is not None:
        assert tau.build_chat_prompt(text) == jau.build_chat_prompt(text)


@functools.lru_cache(maxsize=None)
def _llm():
    cfg = jq.QwenConfig.tiny()
    params = jq.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    # a larger head spreads the logits, so the penalty moves the argmax
    params = {**params, "lm_head": {"w": params["lm_head"]["w"] * 40.0}}
    return cfg, tq.QwenConfig.tiny(), params, convert.tree_to_torch(
        jax.tree.map(np.asarray, params), "cpu")


@pytest.mark.parametrize("max_new", [12, 24])
def test_generate_descriptions_match_jax_at_tiny_top_p(max_new):
    jcfg, tcfg, params, tparams = _llm()
    kw = dict(max_new_tokens=max_new, top_p=1e-6)  # the reference's T 0.7 and penalty 1.1
    batch = [tau.parse_openface_row(r) for r in ROWS]
    want = jau.AUAgent(params, jcfg, ByteTokenizer(), **kw).generate_descriptions(
        batch, rng=jax.random.PRNGKey(5))
    agent = tau.AUAgent(tparams, tcfg, TorchByteTokenizer(), **kw)
    assert (agent.temperature, agent.repetition_penalty) == (0.7, 1.1)
    got = agent.generate_descriptions(batch, generator=torch.Generator().manual_seed(9))
    assert got == want and len(got) == 3
    assert got[2] == tau.NEUTRAL_DESCRIPTION
    assert agent.generate_description(batch[0]) == want[0]


def test_neutral_rows_do_not_generate(monkeypatch):
    _, tcfg, _, tparams = _llm()
    monkeypatch.setattr(tgen, "generate", lambda *a, **k: pytest.fail("generated"))
    agent = tau.AUAgent(tparams, tcfg, TorchByteTokenizer())
    assert agent.generate_descriptions([{"AU01_r": 0.3}, {}]) == [tau.NEUTRAL_DESCRIPTION] * 2
