"""The port's Qwen2 tokenizer (affectgpt_tpu_torch/tokenization.py) against
JAX's `load_tokenizer("Qwen25")`, which runs HF's `tokenizers` on the same
files: a Qwen2-style `tokenizer.json` trained here by `tokenizers` (NFC,
Qwen2's split pattern, byte-level BPE) with Qwen's 22 special tokens, read
by both packages with `PATH_TO_LLM` pointed at it. Ids, decodes (with and
without `skip_special_tokens`), the bos / eos / pad / patch ids and
`vocab_size` must be equal over hypothesis text.

The text is drawn from ALPHABET: blocks whose characters' categories are the
same in Python's `unicodedata` (Unicode 15.0) and in the tables of the
`tokenizers` crate's regex engine (ASCII with its controls, Latin-1 and
Latin Extended-A with ſ, Greek, Cyrillic, Arabic-Indic digits, combining
accents, general punctuation with U+2028/U+2029, super- and subscripts,
number forms (Ⅻ, ½), CJK punctuation and ideographs U+4E00-U+9FA5,
hiragana, and the emoticons U+1F600-U+1F64F).
"""

import json

import pytest

tokenizers = pytest.importorskip("tokenizers")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from affectgpt_tpu import constants  # noqa: E402
from affectgpt_tpu import paths as jpaths  # noqa: E402
from affectgpt_tpu import tokenization as jtok  # noqa: E402
from affectgpt_tpu_torch import paths as tpaths  # noqa: E402
from affectgpt_tpu_torch import tokenization as ttok  # noqa: E402
from tests.torch_hf_models import SPECIALS, write_qwen2_tokenizer  # noqa: E402

_RANGES = [(0x00, 0x7F), (0xA0, 0x17F), (0x300, 0x36F), (0x391, 0x3C9), (0x410, 0x44F),
           (0x660, 0x669), (0x2000, 0x2064), (0x2070, 0x209C), (0x2150, 0x2188),
           (0x3000, 0x303F), (0x3041, 0x3096), (0x4E00, 0x9FA5), (0x1F600, 0x1F64F)]
ALPHABET = [chr(c) for lo, hi in _RANGES for c in range(lo, hi + 1)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX's tokenizer, the port's) on one tokenizer directory."""
    model_dir = tmp_path_factory.mktemp("qwen_tok")
    write_qwen2_tokenizer(model_dir)
    saved = (jpaths.PATH_TO_LLM.get("Qwen25"), tpaths.PATH_TO_LLM.get("Qwen25"))
    jpaths.PATH_TO_LLM["Qwen25"] = tpaths.PATH_TO_LLM["Qwen25"] = str(model_dir)
    try:
        yield jtok.load_tokenizer("Qwen25"), ttok.load_tokenizer("Qwen25")
    finally:
        jpaths.PATH_TO_LLM["Qwen25"], tpaths.PATH_TO_LLM["Qwen25"] = saved


text = st.text(alphabet=st.sampled_from(ALPHABET), max_size=60)
# runs of the characters the pre-tokenizer treats specially
tricky = st.sampled_from(["\r\n", "\r\n\r\n", "\n", "  ", "   ", "\t", "\x1c", "\x1d", "\x1e",
                          "\x1f", "ſ", "'S", "'LL", "'Re", "'ſ", "'t", "'VE", "'d", "'M", " '",
                          "²", "Ⅻ", "½", "٣", "　", "\xa0", "\x85", " ", "é",
                          "😀", "你好", " 123", " !!\n"])
tokens = st.sampled_from(SPECIALS + list(constants.ALL_PATCH_TOKENS))
mixed = st.lists(st.one_of(text, tricky, tokens), max_size=8).map("".join)


def test_ids_and_specials(pair):
    jax_tok, port = pair
    assert port.patch_token_ids == jax_tok.patch_token_ids
    assert (port.bos_token_id, port.eos_token_id, port.pad_token_id) == \
        (jax_tok.bos_token_id, jax_tok.eos_token_id, jax_tok.pad_token_id)
    assert port.vocab_size == jax_tok.vocab_size
    assert port.eos_token_id == port.encode("<|im_end|>")[0] != port.bos_token_id


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(mixed)
def test_encode_decode_as_hf(pair, s):
    jax_tok, port = pair
    ids = port.encode(s)
    assert ids == jax_tok.encode(s)
    assert port.encode(s, max_length=5) == jax_tok.encode(s, max_length=5)
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == \
            jax_tok.decode(ids, skip_special_tokens=skip)


@settings(max_examples=300, deadline=None)
@given(st.one_of(text, st.lists(st.one_of(text, tricky), max_size=8).map("".join)))
def test_pre_tokenizer_as_hf(s):
    from tokenizers import Regex, pre_tokenizers

    split = pre_tokenizers.Split(Regex(ttok.QWEN2_PATTERN), behavior="isolated")
    assert ttok.pre_tokenize(s) == [piece for piece, _ in split.pre_tokenize_str(s)]


@pytest.mark.parametrize("case", [
    "Hello world's  best\n\n  123 !!\tA'S ſ", "a\x1c\x1db", "x'ſ y'S", "²Ⅻ½٣ 12",
    "trailing   ", "\r\n\r\n  x", "  ", "été", "<|im_start|>user\n<FrameHere>hi<|im_end|>",
])
def test_fixed_cases(pair, case):
    jax_tok, port = pair
    ids = port.encode(case)
    assert ids == jax_tok.encode(case)
    assert port.decode(ids) == jax_tok.decode(ids)


def test_decode_of_ids_outside_the_vocab(pair):
    """Ids no token has (a model's vocab is wider than the tokenizer's) are
    dropped by both, and a cut UTF-8 sequence decodes alike."""
    jax_tok, port = pair
    ids = port.encode("你好 😀") + [port.vocab_size + 50, 151000]
    assert port.decode(ids) == jax_tok.decode(ids)
    assert port.decode(ids[:-3]) == jax_tok.decode(ids[:-3])


def test_added_token_ids_follow_hf_on_a_gap(tmp_path):
    """Specials whose stated ids leave a gap after the vocab are renumbered
    on load, by HF and by the port alike."""
    model_dir = tmp_path / "gap"
    write_qwen2_tokenizer(model_dir, vocab_size=600)
    spec = json.loads((model_dir / "tokenizer.json").read_text(encoding="utf-8"))
    for t in spec["added_tokens"]:
        t["id"] += 1000
    (model_dir / "tokenizer.json").write_text(json.dumps(spec), encoding="utf-8")
    saved = (jpaths.PATH_TO_LLM.get("Qwen25"), tpaths.PATH_TO_LLM.get("Qwen25"))
    jpaths.PATH_TO_LLM["Qwen25"] = tpaths.PATH_TO_LLM["Qwen25"] = str(model_dir)
    try:
        jax_tok, port = jtok.load_tokenizer("Qwen25"), ttok.load_tokenizer("Qwen25")
    finally:
        jpaths.PATH_TO_LLM["Qwen25"], tpaths.PATH_TO_LLM["Qwen25"] = saved
    assert (port.bos_token_id, port.eos_token_id, port.patch_token_ids, port.vocab_size) == \
        (jax_tok.bos_token_id, jax_tok.eos_token_id, jax_tok.patch_token_ids,
         jax_tok.vocab_size)
    s = "<|im_start|>hi<ImageHere><|im_end|>"
    assert port.encode(s) == jax_tok.encode(s)


@pytest.mark.parametrize("name", ["Llama2", "Baichuan2"])
def test_other_tokenizers_raise(name, tmp_path):
    """The Llama2 and Baichuan2 routes take only their own forms: a
    tokenizer.json of Qwen2's form is not Llama-2's, and a sentencepiece
    model of the WORD type is neither unigram nor BPE (both tokenizers are
    held against their oracles in tests/test_torch_tokenizer_spm.py)."""
    if name == "Llama2":
        write_qwen2_tokenizer(tmp_path, vocab_size=600)
        match = "Llama-2's form"
    else:
        from tests.torch_hf_models import sentencepiece_proto

        proto = sentencepiece_proto("bpe", vocab_size=400)
        proto.trainer_spec.model_type = 3  # WORD
        (tmp_path / "tokenizer.model").write_bytes(proto.SerializeToString())
        match = "model type WORD"
    saved = tpaths.PATH_TO_LLM.get(name)
    tpaths.PATH_TO_LLM[name] = str(tmp_path)
    try:
        with pytest.raises(NotImplementedError, match=match):
            ttok.load_tokenizer(name)
    finally:
        tpaths.PATH_TO_LLM[name] = saved


def test_other_tokenizer_json_raises():
    spec = {"model": {"type": "BPE", "byte_fallback": True, "vocab": {}, "merges": []}}
    with pytest.raises(NotImplementedError, match="Qwen2's form"):
        ttok.Qwen2BPE(spec)
