"""The port's Llama-2 and Baichuan2 tokenizers (affectgpt_tpu_torch/
tokenization.py: LlamaBPE, SentencePieceModel) against their oracles over
hypothesis text, on tokenizers built here (tests/torch_hf_models.py):

- Llama2: a Llama-2-form `tokenizer.json`, against JAX's
  `load_tokenizer("Llama2")` (HF's LlamaTokenizerFast on the same file);
- Baichuan2 with a unigram `tokenizer.model`: against JAX's
  `load_tokenizer("Baichuan2")`, which without the sentencepiece wheel
  converts the ModelProto through transformers' LlamaConverter
  (`load_sentencepiece_fast`);
- Baichuan2 with a BPE `tokenizer.model` (Baichuan2's own type): JAX's
  loader needs the sentencepiece wheel there, which this image lacks, so
  the oracle is HF's BPE built from the same pieces, its merges ordered by
  the merged piece's score as transformers' SentencePieceExtractor orders
  them (`generate_merges`), behind the wrapper JAX's `load_tokenizer`
  builds; hand-worked cases hold the merge order itself.

Ids, decodes (with and without `skip_special_tokens`), the bos / eos / pad
/ patch ids and `vocab_size` must be equal. The text is drawn from the
alphabet of tests/test_torch_tokenizer.py (characters outside the
vocabularies take the byte-fallback pieces) with the special, user-defined
and patch tokens mixed in.
"""

import json

import pytest

tokenizers = pytest.importorskip("tokenizers")
pytest.importorskip("google.protobuf")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from affectgpt_tpu import constants  # noqa: E402
from affectgpt_tpu import paths as jpaths  # noqa: E402
from affectgpt_tpu import tokenization as jtok  # noqa: E402
from affectgpt_tpu_torch import paths as tpaths  # noqa: E402
from affectgpt_tpu_torch import tokenization as ttok  # noqa: E402
from tests import torch_hf_models as hf  # noqa: E402
from tests.test_torch_tokenizer import ALPHABET  # noqa: E402


def _load(package, model_dir, name):
    """`package`'s load_tokenizer(name) with its PATH_TO_LLM[name] at model_dir."""
    table = (jpaths if package is jtok else tpaths).PATH_TO_LLM
    saved = table.get(name)
    table[name] = str(model_dir)
    try:
        return package.load_tokenizer(name)
    finally:
        table[name] = saved


def hf_bpe_oracle(model_dir):
    """JAX's TokenizerWrapper over HF's BPE of the `tokenizer.model` in
    model_dir: the converter's BPE (its vocabulary, merges by score, unk,
    fuse_unk, byte fallback), added tokens and decoder, with the normalizer
    and decoder following add_dummy_prefix, then load_tokenizer's fixes."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers
    from transformers import PreTrainedTokenizerFast
    from transformers.convert_slow_tokenizer import generate_merges

    try:
        from transformers.utils import sentencepiece_model_pb2_new as sp
    except ImportError:
        from transformers.utils import sentencepiece_model_pb2 as sp
    proto = sp.ModelProto()
    proto.ParseFromString((model_dir / "tokenizer.model").read_bytes())
    vocab_scores = [(p.piece, p.score) for p in proto.pieces]
    vocab = {p: i for i, (p, _) in enumerate(vocab_scores)}
    tok = Tokenizer(models.BPE(vocab, generate_merges(vocab, vocab_scores),
                               unk_token=proto.trainer_spec.unk_piece, fuse_unk=True,
                               byte_fallback=True, dropout=None))
    prefix = proto.normalizer_spec.add_dummy_prefix
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁")] * prefix
                                          + [normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse()] + [decoders.Strip(" ", 1, 0)] * prefix)
    tok.add_tokens([AddedToken(p.piece, normalized=False, special=p.type == 3)
                    for p in proto.pieces if p.type in (3, 4)])
    spec = proto.trainer_spec
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token=proto.pieces[spec.unk_id].piece,
                                   bos_token=proto.pieces[spec.bos_id].piece,
                                   eos_token=proto.pieces[spec.eos_id].piece)
    fast.pad_token = fast.eos_token
    for t in constants.ALL_PATCH_TOKENS:
        fast.add_tokens([t], special_tokens=True)
    return jtok.TokenizerWrapper(fast)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name → (oracle, the port's tokenizer)."""
    root = tmp_path_factory.mktemp("spm")
    hf.write_llama2_tokenizer(root / "llama")
    hf.write_sentencepiece_model(root / "unigram", "unigram")
    hf.write_sentencepiece_model(root / "bpe", "bpe", add_dummy_prefix=False)
    return {
        "llama2": (_load(jtok, root / "llama", "Llama2"), _load(ttok, root / "llama", "Llama2")),
        "unigram": (_load(jtok, root / "unigram", "Baichuan2"),
                    _load(ttok, root / "unigram", "Baichuan2")),
        "bpe": (hf_bpe_oracle(root / "bpe"), _load(ttok, root / "bpe", "Baichuan2")),
    }


KINDS = ["llama2", "unigram", "bpe"]
text = st.text(alphabet=st.sampled_from(ALPHABET), max_size=60)
tricky = st.sampled_from(["  ", "   ", " ", "\n", "\t", "▁", "▁▁", " the", "the cat",
                          "你好", "😀", "é", "ſ", "<0x41>", "<unk>", " <s>", "</s> ",
                          hf.USER_DEFINED, "emotion", "I'M", "2024"])
tokens = st.sampled_from(hf.SP_SPECIALS + list(constants.ALL_PATCH_TOKENS))
mixed = st.lists(st.one_of(text, tricky, tokens), max_size=8).map("".join)


@pytest.mark.parametrize("kind", KINDS)
def test_ids_and_specials(pairs, kind):
    oracle, port = pairs[kind]
    assert port.patch_token_ids == oracle.patch_token_ids
    assert (port.bos_token_id, port.eos_token_id, port.pad_token_id) == \
        (oracle.bos_token_id, oracle.eos_token_id, oracle.pad_token_id) == (1, 2, 2)
    assert port.vocab_size == oracle.vocab_size


@pytest.mark.parametrize("kind", KINDS)
@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(s=mixed)
def test_encode_decode_as_oracle(pairs, kind, s):
    oracle, port = pairs[kind]
    ids = port.encode(s)
    assert ids == oracle.encode(s)
    assert port.encode(s, max_length=5) == oracle.encode(s, max_length=5)
    for skip in (False, True):
        assert port.decode(ids, skip_special_tokens=skip) == \
            oracle.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("kind", KINDS)
def test_fixed_cases(pairs, kind):
    oracle, port = pairs[kind]
    for case in [hf.CORPUS[6], "<s>" + hf.CORPUS[0] + "</s>", " leading and trailing ",
                 "你好<FrameHere><FrameHere> x", "\U0001F600\U0001F600 ὠ", "", " ",
                 "<unk><unk>", "a" + hf.USER_DEFINED + "b"]:
        ids = port.encode(case)
        assert ids == oracle.encode(case), case
        assert port.decode(ids) == oracle.decode(ids), case
    # ids no token has (a model's vocab is wider than the tokenizer's) are
    # dropped, and byte pieces that are not UTF-8 decode to U+FFFD each
    bad = [port.bpe.vocab["<0xE4>"], port.bpe.vocab["<0xBD>"], port.bpe.vocab["<0x41>"],
           port.vocab_size + 7, 120_000]
    assert port.decode(bad) == oracle.decode(bad)


def _spm(pieces, kind=ttok.SP_BPE, add_dummy_prefix=False, **spec):
    """A SentencePieceModel over `pieces` [(piece, score, type)] after the
    unk / bos / eos pieces."""
    head = [("<unk>", 0.0, ttok.SP_UNKNOWN), ("<s>", 0.0, ttok.SP_CONTROL),
            ("</s>", 0.0, ttok.SP_CONTROL)]
    proto = {"pieces": head + pieces, "model_type": kind, "unk_id": 0, "bos_id": 1,
             "eos_id": 2, "treat_whitespace_as_suffix": False, "normalizer_name": "identity",
             "precompiled_charsmap": b"", "add_dummy_prefix": add_dummy_prefix,
             "remove_extra_whitespaces": False, "escape_whitespaces": True,
             "normalization_rule_tsv": b"", **spec}
    return ttok.SentencePieceModel(proto)


def _pieces(tok, text):
    return [tok.id_to_token[i] for i in tok.encode(text)]


def test_bpe_merges_the_highest_score_first():
    """Hand-worked: "abc" with pieces ab (-2) and bc (-1): bc first, so a +
    bc; with ab (-1) and bc (-2): ab + c. "aaa" with aa: the leftmost pair
    first, so aa + a. Ties of one piece at two places: leftmost first."""
    chars = [(c, -10.0, ttok.SP_NORMAL) for c in "abc"]
    tok = _spm(chars + [("ab", -2.0, ttok.SP_NORMAL), ("bc", -1.0, ttok.SP_NORMAL)])
    assert _pieces(tok, "abc") == ["a", "bc"]
    tok = _spm(chars + [("ab", -1.0, ttok.SP_NORMAL), ("bc", -2.0, ttok.SP_NORMAL)])
    assert _pieces(tok, "abc") == ["ab", "c"]
    tok = _spm(chars + [("aa", -1.0, ttok.SP_NORMAL), ("aaaa", -0.5, ttok.SP_NORMAL)])
    assert _pieces(tok, "aaa") == ["aa", "a"]
    assert _pieces(tok, "aaaaa") == ["aaaa", "a"]
    # a merge only into a normal or user-defined piece: "<s" is no piece and
    # the control piece "<s>" is split out before the model runs
    tok = _spm([(c, -10.0, ttok.SP_NORMAL) for c in "<s>"])
    assert _pieces(tok, "<s><s") == ["<s>", "<", "s"]


def test_unknown_characters_fall_back_to_bytes_or_one_unk():
    chars = [(c, -1.0, ttok.SP_NORMAL) for c in "ab"]
    tok = _spm(chars)
    assert tok.encode("aé€b") == [tok.vocab["a"], 0, tok.vocab["b"]]  # one unk for the run
    with_bytes = _spm(chars + [(f"<0x{b:02X}>", 0.0, ttok.SP_BYTE) for b in range(256)])
    assert _pieces(with_bytes, "aéb") == ["a", "<0xC3>", "<0xA9>", "b"]
    assert with_bytes.decode(with_bytes.encode("aéb")) == "aéb"


def test_unigram_viterbi_hand_worked():
    """"abc": a + bc scores -1 - 1 = -2 against ab + c -1.5 - 1 = -2.5 and
    a + b + c -3; the dummy prefix makes "▁" a piece of its own."""
    pieces = [("a", -1.0, ttok.SP_NORMAL), ("b", -1.0, ttok.SP_NORMAL),
              ("c", -1.0, ttok.SP_NORMAL), ("ab", -1.5, ttok.SP_NORMAL),
              ("bc", -1.0, ttok.SP_NORMAL), ("▁", -0.5, ttok.SP_NORMAL)]
    tok = _spm(pieces, kind=ttok.SP_UNIGRAM, add_dummy_prefix=True)
    assert _pieces(tok, "abc") == ["▁", "a", "bc"]
    assert tok.decode(tok.encode("abc ab")) == "abc ab"


@pytest.mark.parametrize("spec,match", [
    ({"model_type": 3}, "model type WORD"),
    ({"model_type": 4}, "model type CHAR"),
    ({"remove_extra_whitespaces": True}, "remove_extra_whitespaces"),
    ({"normalizer_name": "nmt_nfkc", "precompiled_charsmap": b"\x01"}, "precompiled_charsmap"),
    ({"treat_whitespace_as_suffix": True}, "treat_whitespace_as_suffix"),
])
def test_models_not_ported_raise(spec, match):
    with pytest.raises(NotImplementedError, match=match):
        _spm([("a", -1.0, ttok.SP_NORMAL)], **spec)


def test_reader_reads_the_proto_defaults_and_negative_ids():
    """An empty ModelProto gives sentencepiece's defaults; pad_id -1 and
    other negative int32s (ten-byte varints) read as negatives."""
    pytest.importorskip("transformers")
    from transformers.utils import sentencepiece_model_pb2_new as sp

    proto = ttok.read_sentencepiece_model(sp.ModelProto().SerializeToString())
    assert (proto["model_type"], proto["unk_id"], proto["bos_id"], proto["eos_id"]) == \
        (ttok.SP_UNIGRAM, 0, 1, 2)
    assert proto["add_dummy_prefix"] and proto["remove_extra_whitespaces"]
    m = sp.ModelProto()
    m.trainer_spec.bos_id, m.trainer_spec.eos_id = -1, 7
    proto = ttok.read_sentencepiece_model(m.SerializeToString())
    assert (proto["bos_id"], proto["eos_id"]) == (-1, 7)


def test_other_tokenizer_json_forms_raise(tmp_path):
    hf.write_llama2_tokenizer(tmp_path)
    spec = json.loads((tmp_path / "tokenizer.json").read_text(encoding="utf-8"))
    with pytest.raises(NotImplementedError, match="Qwen2's form"):
        ttok.Qwen2BPE(spec)
    spec["decoder"] = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always"}
    with pytest.raises(NotImplementedError, match="Llama-2's form"):
        ttok.LlamaBPE(spec)
