r"""Tokenizers: the Qwen2 BPE of `tokenizer.json`, the dependency-free
ByteTokenizer and batch prompt encoding.

Port of affectgpt_tpu/tokenization.py. `load_tokenizer("Qwen25")` (or
"Qwen2") reads the LLM directory's `tokenizer.json` and
`tokenizer_config.json` without `transformers`, `tokenizers` or `regex`
and gives the ids and decodes of JAX's HF-backed `load_tokenizer`:

1. the added and special tokens are split out of the raw text first,
   leftmost-longest, as HF's added vocabulary does;
2. the rest is NFC-normalized;
3. Qwen2's pre-tokenizer regex is run by a hand-written scanner
   (`pre_tokenize`) over `unicodedata.category`: `\p{L}` is the L*
   categories, `\p{N}` the N* ones (Nd, Nl, No), `\s` Unicode White_Space
   (tab to carriage return, U+0085 and the Zs, Zl, Zp categories; not
   U+001C-U+001F, which `str.isspace` accepts), and `(?i:'s|...)` folds
   U+017F (ſ) to s;
4. each piece's UTF-8 bytes are mapped to the byte-level alphabet;
5. rank-ordered BPE merges run on each piece (the lowest rank first, the
   leftmost of equal ranks), cached per piece;
6. decoding joins the tokens through the byte-level decoder, dropping the
   special ones with `skip_special_tokens` and ids no token has.

Then JAX's fixes: bos = `<|im_start|>`, pad = eos (eos from
`tokenizer_config.json`), the six patch tokens added as special tokens
after the highest added id, and `vocab_size` counting every distinct
token.

`load_tokenizer("Llama2")` reads a `tokenizer.json` of Llama-2's form
(`LlamaBPE`: a Prepend("▁") + Replace(" ", "▁") normalizer, no
pre-tokenizer, a BPE model with byte fallback and fused unknowns, the
Replace / ByteFallback / Fuse / Strip decoder), and
`load_tokenizer("Baichuan2")` a sentencepiece `tokenizer.model`
(`SentencePieceModel`, read by a protobuf wire-format reader of its own:
the card has no `protobuf` or `sentencepiece`): unigram models encode by
Viterbi as HF's Unigram does, BPE models by sentencepiece's merges of the
highest-scoring piece first. Both give the ids and decodes of JAX's
HF-backed loaders (`load_sentencepiece_fast` for a unigram `.model`; JAX
cannot load a BPE `.model` without the sentencepiece wheel), with bos /
eos / unk as the files name them, pad = eos and the patch tokens added.

The ByteTokenizer has the same interface (ids for the specials, encode,
decode) and stands in where no tokenizer files exist, as in the
random-weight mode.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional

import numpy as np

from affectgpt_tpu_torch import constants, paths

# Qwen2's pre-tokenizer pattern (tokenizer.json, pre_tokenizer Split), which
# `pre_tokenize` implements
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' White_Space, 'O' anything else."""
    cat = unicodedata.category(ch)
    if cat[0] in "LN":
        return cat[0]
    if ch in "\t\n\x0b\x0c\r\x85" or cat in ("Zs", "Zl", "Zp"):
        return "S"
    return "O"


def _fold(ch: str) -> str:
    """The case fold of the contraction alternatives' letters."""
    return "s" if ch == "\u017f" else ch.lower() if ch.isascii() else ch


def pre_tokenize(text: str) -> List[str]:
    """Qwen2's pre-tokenizer (QWEN2_PATTERN, isolated splits): the text cut
    into the pattern's leftmost matches, which cover every character."""
    kinds = [_kind(ch) for ch in text]
    n, i, out = len(text), 0, []
    while i < n:
        j = _match(text, kinds, i, n)
        out.append(text[i:j])
        i = j
    return out


def _match(text: str, kinds: List[str], i: int, n: int) -> int:
    """The end of the pattern's match at i (the alternatives in order)."""
    ch, kind = text[i], kinds[i]
    if ch == "'":  # (?i:'s|'t|'re|'ve|'m|'ll|'d)
        for tail in _CONTRACTIONS:
            end = i + 1 + len(tail)
            if end <= n and "".join(_fold(c) for c in text[i + 1:end]) == tail:
                return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    start = None
    if kind == "L":
        start = i
    elif ch not in "\r\n" and kind != "N" and i + 1 < n and kinds[i + 1] == "L":
        start = i + 1
    if start is not None:
        while start < n and kinds[start] == "L":
            start += 1
        return start
    if kind == "N":  # \p{N}
        return i + 1
    k = i + 1 if ch == " " else i  # " ?[^\s\p{L}\p{N}]+[\r\n]*"
    if k < n and kinds[k] == "O":
        while k < n and kinds[k] == "O":
            k += 1
        while k < n and text[k] in "\r\n":
            k += 1
        return k
    end = i  # the rest start at White_Space
    while end < n and kinds[end] == "S":
        end += 1
    newlines = [k for k in range(i, end) if text[k] in "\r\n"]
    if newlines:  # \s*[\r\n]+
        return newlines[-1] + 1
    if end == n or end - i == 1:  # \s+(?!\S) at the end of the text; else \s+
        return end
    return end - 1  # \s+(?!\S): the run less its last character


def _byte_alphabet() -> Dict[int, str]:
    """GPT-2's byte-level alphabet: byte → a printable character."""
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) \
        + list(range(ord("\xae"), ord("\xff") + 1))
    chars, extra = {}, 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    return chars


BYTE_TO_CHAR = _byte_alphabet()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}


class _AddedVocabulary:
    """A model vocabulary (token → id) with HF's added tokens over it: they
    are split out of the raw text first, leftmost-longest (all are
    `normalized: false`), and new ones take ids as HF's add_tokens gives
    them. Subclasses encode the text between them (`_encode_plain`) and
    join tokens back into text (`_join`)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.model_vocab_size = len(vocab)
        self.added: Dict[str, int] = {}
        self.special: set = set()

    def _reindex(self) -> None:
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        alternation = "|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True))
        self._added_re = re.compile(alternation) if self.added else None

    def add_token(self, content: str, special: bool = True, reindex: bool = True) -> int:
        """Register `content` as an added token, as HF's add_tokens does: its
        id if it has one, else one past the highest added id (or the model's
        vocab size when no added id reaches it)."""
        if content in self.added:
            new_id = self.added[content]
        elif content in self.vocab:
            new_id = self.vocab[content]
        elif self.added and max(self.added.values()) >= self.model_vocab_size:
            new_id = max(self.added.values()) + 1
        else:
            new_id = self.model_vocab_size
        self.added[content] = new_id
        if special:
            self.special.add(content)
        if reindex:
            self._reindex()
        return new_id

    def get_vocab(self) -> Dict[str, int]:
        return {**self.vocab, **self.added}

    def token_to_id(self, token: str) -> Optional[int]:
        return self.added.get(token, self.vocab.get(token))

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                if m.start() > pos:
                    ids.extend(self._encode_plain(text[pos:m.start()]))
                ids.append(self.added[m.group()])
                pos = m.end()
        if pos < len(text):
            ids.extend(self._encode_plain(text[pos:]))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """The tokens of `ids` (ids no token has dropped, the special ones too
        with skip_special_tokens) joined by the decoder."""
        tokens = []
        for token_id in ids:
            token = self.id_to_token.get(int(token_id))
            if token is not None and not (skip_special_tokens and token in self.special):
                tokens.append(token)
        return self._join(tokens)

    def _encode_plain(self, text: str) -> List[int]:
        raise NotImplementedError

    def _join(self, tokens: List[str]) -> str:
        raise NotImplementedError


def _merge(parts: List[str], priority) -> List[str]:
    """Merge adjacent symbols, best pair first: priority(left, right) is a
    sortable key (lower first) of a pair that merges into left + right, or
    None; ties go to the leftmost pair (its left symbol's first position).
    This is both HF's BPE order (merge rank, then position) and
    sentencepiece's BPE order (the merged piece's score, then position)."""
    n = len(parts)
    if n < 2:
        return list(parts)
    sym: List[Optional[str]] = list(parts)
    prev = list(range(-1, n - 1))
    nxt = list(range(1, n)) + [-1]
    heap = []
    for i in range(n - 1):
        key = priority(sym[i], sym[i + 1])
        if key is not None:
            heap.append((key, i, sym[i], sym[i + 1]))
    heapq.heapify(heap)
    while heap:
        _, i, a, b = heapq.heappop(heap)
        j = nxt[i]
        if sym[i] != a or j < 0 or sym[j] != b:  # a merge since changed the pair
            continue
        sym[i], sym[j] = a + b, None
        nxt[i] = nxt[j]
        if nxt[i] >= 0:
            prev[nxt[i]] = i
        for left in (prev[i], i):
            right = nxt[left] if left >= 0 else -1
            if right >= 0:
                key = priority(sym[left], sym[right])
                if key is not None:
                    heapq.heappush(heap, (key, left, sym[left], sym[right]))
    return [p for p in sym if p is not None]


def _byte_tokens(text: str, vocab: Dict[str, int]) -> Optional[List[str]]:
    """The byte-fallback tokens <0xHH> of text's UTF-8 bytes, or None when
    the vocabulary lacks one."""
    tokens = [f"<0x{b:02X}>" for b in text.encode("utf-8")]
    return tokens if all(t in vocab for t in tokens) else None


def _metaspace_join(tokens: List[str], strip_prefix: bool) -> str:
    """Llama's decoder: "▁" → " " in each token, runs of <0xHH> tokens
    decoded as UTF-8 (one U+FFFD a byte when they are not valid UTF-8), all
    joined, and one leading space stripped when the encoder prepends "▁"."""
    out: List[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.append("\ufffd" * len(run))
            run.clear()

    for token in tokens:
        token = token.replace("\u2581", " ")
        if len(token) == 6 and token.startswith("<0x") and token.endswith(">"):
            try:
                run.append(int(token[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(token)
    flush()
    text = "".join(out)
    return text[1:] if strip_prefix and text.startswith(" ") else text


class Qwen2BPE(_AddedVocabulary):
    """A byte-level BPE tokenizer read from a `tokenizer.json` of Qwen2's
    form (NFC normalizer, QWEN2_PATTERN split + byte-level pre-tokenizer, BPE
    model, byte-level decoder); anything else raises NotImplementedError."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") != "BPE" or model.get("byte_fallback") \
                or model.get("continuing_subword_prefix") or model.get("end_of_word_suffix") \
                or model.get("dropout"):
            raise NotImplementedError(f"tokenizer.json model {model.get('type')!r} with these "
                                      f"options is not of Qwen2's form")
        _check_qwen2_pipeline(spec)
        super().__init__(dict(model["vocab"]))
        self.ranks = _merge_ranks(model)
        self.ignore_merges = bool(model.get("ignore_merges", False))
        _add_file_tokens(self, spec)
        self._cache: Dict[str, List[int]] = {}

    def _bpe(self, piece: str) -> List[int]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        word = "".join(BYTE_TO_CHAR[b] for b in piece.encode("utf-8"))
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            parts = _merge(list(word), lambda a, b: self.ranks.get((a, b)))
            ids = [self.vocab[p] for p in parts if p in self.vocab]
        self._cache[piece] = ids
        return ids

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in pre_tokenize(unicodedata.normalize("NFC", text)):
            ids.extend(self._bpe(piece))
        return ids

    def _join(self, tokens: List[str]) -> str:
        data = bytearray()
        for token in tokens:
            if all(c in CHAR_TO_BYTE for c in token):
                data.extend(CHAR_TO_BYTE[c] for c in token)
            else:
                data.extend(token.encode("utf-8"))
        return data.decode("utf-8", errors="replace")


def _merge_ranks(model: dict) -> Dict[tuple, int]:
    """(left, right) → rank of a tokenizer.json BPE's merges ("a b" strings
    or pairs), the first of a repeated pair winning."""
    merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
              for m in model.get("merges", [])]
    return {pair: rank for rank, pair in reversed(list(enumerate(merges)))}


def _add_file_tokens(tok: _AddedVocabulary, spec: dict) -> None:
    """The tokenizer.json's added tokens, re-added in order as HF does when it
    loads them (so their ids follow add_token's rule, not the ids the file
    states)."""
    for t in spec.get("added_tokens", []):
        if t.get("lstrip") or t.get("rstrip") or t.get("single_word") or t.get("normalized"):
            raise NotImplementedError(f"added token {t['content']!r}: lstrip, rstrip, "
                                      f"single_word and normalized are not ported")
        tok.add_token(t["content"], special=bool(t.get("special")), reindex=False)
    tok._reindex()


def _check_qwen2_pipeline(spec: dict) -> None:
    """Raise NotImplementedError unless the normalizer, pre-tokenizer and
    decoder are Qwen2's."""
    normalizer = spec.get("normalizer") or {}
    pre = spec.get("pre_tokenizer") or {}
    steps = pre.get("pretokenizers", []) if pre.get("type") == "Sequence" else [pre]
    split = steps[0] if steps else {}
    ok = (normalizer.get("type") == "NFC"
          and len(steps) == 2 and split.get("type") == "Split"
          and (split.get("pattern") or {}).get("Regex") == QWEN2_PATTERN
          and str(split.get("behavior", "")).lower() == "isolated" and not split.get("invert")
          and steps[1].get("type") == "ByteLevel" and not steps[1].get("add_prefix_space")
          and not steps[1].get("use_regex", True)
          and (spec.get("decoder") or {}).get("type") == "ByteLevel")
    if not ok:
        raise NotImplementedError("tokenizer.json is not of Qwen2's form (NFC, its Split "
                                  "pattern, byte-level BPE)")


# Llama-2's tokenizer.json pipeline, which LlamaBPE implements
_LLAMA_NORMALIZER = {"type": "Sequence", "normalizers": [
    {"type": "Prepend", "prepend": "▁"},
    {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
_LLAMA_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}


class LlamaBPE(_AddedVocabulary):
    """A sentencepiece-style BPE read from a `tokenizer.json` of Llama-2's
    form: the text between added tokens gets "▁" prepended and its spaces
    replaced by "▁", then, as HF's BPE with byte_fallback and fuse_unk: each
    character is its token, or the <0xHH> tokens of its UTF-8 bytes, or
    unknown (a run of unknowns one token), and the merges apply in rank
    order. Anything else raises NotImplementedError."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        pipeline = (spec.get("normalizer"), spec.get("pre_tokenizer"), spec.get("decoder"))
        if pipeline != (_LLAMA_NORMALIZER, None, _LLAMA_DECODER):
            raise NotImplementedError("tokenizer.json is not of Llama-2's form (Prepend and "
                                      "Replace normalizer, no pre-tokenizer, Replace / "
                                      "ByteFallback / Fuse / Strip decoder)")
        if model.get("type") != "BPE" or not model.get("byte_fallback") \
                or not model.get("fuse_unk") or model.get("continuing_subword_prefix") \
                or model.get("end_of_word_suffix") or model.get("dropout"):
            raise NotImplementedError(f"tokenizer.json model {model.get('type')!r} with these "
                                      f"options is not Llama-2's BPE (byte_fallback, fuse_unk)")
        super().__init__(dict(model["vocab"]))
        self.ranks = _merge_ranks(model)
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.unk = model.get("unk_token")
        _add_file_tokens(self, spec)

    def _encode_plain(self, text: str) -> List[int]:
        word = "▁" + text.replace(" ", "▁")
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        parts: List[str] = []
        unknown = False  # the last symbol is a (fused) unknown
        for ch in word:
            known = [ch] if ch in self.vocab else _byte_tokens(ch, self.vocab)
            if known is not None:
                parts.extend(known)
            elif self.unk is not None and not unknown:
                parts.append(self.unk)
            unknown = known is None and self.unk is not None
        parts = _merge(parts, lambda a, b: self.ranks.get((a, b)))
        return [self.vocab[p] for p in parts]

    def _join(self, tokens: List[str]) -> str:
        return _metaspace_join(tokens, strip_prefix=True)


# sentencepiece's piece types (sentencepiece_model.proto)
SP_NORMAL, SP_UNKNOWN, SP_CONTROL, SP_USER_DEFINED, SP_UNUSED, SP_BYTE = 1, 2, 3, 4, 5, 6
SP_UNIGRAM, SP_BPE = 1, 2
_UNK_PENALTY = 10.0  # HF's Unigram: an unknown character scores the lowest score less this


def _proto_fields(data: bytes) -> List[tuple]:
    """(field number, value) of a protobuf message's wire format: varints as
    ints, fixed32 as their little-endian bytes, length-delimited fields as
    bytes (a string, a packed array or a sub-message)."""
    out, pos, n = [], 0, len(data)

    def varint():
        nonlocal pos
        value = shift = 0
        while True:
            byte = data[pos]
            pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    while pos < n:
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            out.append((field, varint()))
        elif wire == 1:
            out.append((field, data[pos:pos + 8]))
            pos += 8
        elif wire == 2:
            size = varint()
            out.append((field, data[pos:pos + size]))
            pos += size
        elif wire == 5:
            out.append((field, data[pos:pos + 4]))
            pos += 4
        else:
            raise ValueError(f"tokenizer.model: protobuf wire type {wire} of field {field}")
    return out


def _int32(value: int) -> int:
    """A varint-encoded int32 (negatives take ten bytes) as a Python int."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= 1 << 63 else value


def read_sentencepiece_model(data: bytes) -> dict:
    """The parts of a sentencepiece ModelProto that encoding needs: pieces
    [(piece, score, type)], the trainer spec's model type, unk / bos / eos
    ids and flags, and the normalizer spec's fields, with the proto's
    defaults where a field is absent."""
    pieces, trainer, normalizer = [], {}, {}
    for field, value in _proto_fields(data):
        if field == 1:  # SentencePiece
            piece, score, kind = "", 0.0, SP_NORMAL
            for f, v in _proto_fields(value):
                if f == 1:
                    piece = v.decode("utf-8")
                elif f == 2:
                    score = struct.unpack("<f", v)[0]
                elif f == 3:
                    kind = v
            pieces.append((piece, score, kind))
        elif field == 2:  # TrainerSpec
            trainer.update(_proto_fields(value))
        elif field == 3:  # NormalizerSpec
            normalizer.update(_proto_fields(value))
    return {
        "pieces": pieces,
        "model_type": trainer.get(3, SP_UNIGRAM),
        "unk_id": _int32(trainer.get(40, 0)),
        "bos_id": _int32(trainer.get(41, 1)),
        "eos_id": _int32(trainer.get(42, 2)),
        "treat_whitespace_as_suffix": bool(trainer.get(24, 0)),
        "normalizer_name": normalizer.get(1, b"").decode("utf-8"),
        "precompiled_charsmap": normalizer.get(2, b""),
        "add_dummy_prefix": bool(normalizer.get(3, 1)),
        "remove_extra_whitespaces": bool(normalizer.get(4, 1)),
        "escape_whitespaces": bool(normalizer.get(5, 1)),
        "normalization_rule_tsv": normalizer.get(6, b""),
    }


class SentencePieceModel(_AddedVocabulary):
    """A sentencepiece `tokenizer.model` (unigram or BPE) as JAX's HF route
    serves it (transformers' LlamaConverter over the ModelProto): control
    pieces are special added tokens, user-defined pieces plain added
    tokens; the text between added tokens gets "▁" prepended
    (add_dummy_prefix) and its spaces replaced by "▁"; a piece the model
    cannot give falls back to the <0xHH> pieces of its UTF-8 bytes, else to
    unk (a run of unknowns one token); decoding is LlamaBPE's, with the
    leading space stripped when the dummy prefix is on.

    Unigram: the best segmentation by Viterbi over every piece's score (an
    unknown character scores the lowest score less 10), ties to the first
    found, as HF's Unigram. BPE: the characters merge, the adjacent pair
    whose concatenation is the highest-scoring normal or user-defined piece
    first, the leftmost of equal scores (sentencepiece's bpe_model.cc).

    A normalizer other than identity (a precompiled charsmap, a rule table,
    remove_extra_whitespaces, no whitespace escaping), whitespace as a
    suffix, unused pieces or a model type other than unigram and BPE raise
    NotImplementedError naming it."""

    def __init__(self, proto: dict):
        rules = {
            "normalizer_name": proto["normalizer_name"] not in ("", "identity"),
            "precompiled_charsmap": bool(proto["precompiled_charsmap"]),
            "normalization_rule_tsv": bool(proto["normalization_rule_tsv"]),
            "remove_extra_whitespaces": proto["remove_extra_whitespaces"],
            "escape_whitespaces=false": not proto["escape_whitespaces"],
            "treat_whitespace_as_suffix": proto["treat_whitespace_as_suffix"],
            "unused pieces": any(kind == SP_UNUSED for _, _, kind in proto["pieces"]),
        }
        unknown_rules = [name for name, used in rules.items() if used]
        if unknown_rules:
            raise NotImplementedError(f"tokenizer.model: {', '.join(unknown_rules)} "
                                      f"(normalizer {proto['normalizer_name']!r}) not ported")
        if proto["model_type"] not in (SP_UNIGRAM, SP_BPE):
            kind = {3: "WORD", 4: "CHAR"}.get(proto["model_type"], str(proto["model_type"]))
            raise NotImplementedError(f"tokenizer.model: model type {kind} not ported "
                                      f"(unigram and BPE are)")
        pieces = proto["pieces"]
        super().__init__({piece: i for i, (piece, _, _) in enumerate(pieces)})
        self.bpe = proto["model_type"] == SP_BPE
        self.add_prefix = proto["add_dummy_prefix"]
        self.unk_id = proto["unk_id"]
        self.scores = {piece: score for piece, score, _ in pieces}
        self.max_len = max((len(p) for p, _, _ in pieces), default=1)
        self.unk_score = min((score for _, score, _ in pieces), default=0.0) - _UNK_PENALTY
        self.merge_scores = {piece: score for piece, score, kind in pieces
                             if kind in (SP_NORMAL, SP_USER_DEFINED)}
        for piece, _, kind in pieces:
            if kind in (SP_CONTROL, SP_USER_DEFINED):
                self.add_token(piece, special=kind == SP_CONTROL, reindex=False)
        self._reindex()

    def _symbols(self, pieces: List[str]) -> List[int]:
        """Ids of the pieces: a piece the vocabulary lacks as its byte
        pieces, else unk, a run of unknowns one unk."""
        ids: List[int] = []
        unknown = False
        for piece in pieces:
            known = [piece] if piece in self.vocab else _byte_tokens(piece, self.vocab)
            if known is not None:
                ids.extend(self.vocab[p] for p in known)
            elif not unknown:
                ids.append(self.unk_id)
            unknown = known is None
        return ids

    def _viterbi(self, text: str) -> List[str]:
        n = len(text)
        best = [None] * (n + 1)  # (score, start) of the best path ending here
        best[0] = (0.0, -1)
        for start in range(n):
            base = best[start][0]
            single = False
            for length in range(1, min(self.max_len, n - start) + 1):
                piece = text[start:start + length]
                score = self.scores.get(piece)
                if score is None:
                    continue
                single = single or length == 1
                end = start + length
                if best[end] is None or score + base > best[end][0]:
                    best[end] = (score + base, start)
            if not single and (best[start + 1] is None
                               or self.unk_score + base > best[start + 1][0]):
                best[start + 1] = (self.unk_score + base, start)
        out: List[str] = []
        end, unknown = n, []
        while end > 0:
            start = best[end][1]
            piece = text[start:end]
            if piece not in self.scores:  # an unknown character: fused with its unknown run
                unknown.append(piece)
            else:
                if unknown:
                    out.append("".join(reversed(unknown)))
                    unknown = []
                out.append(piece)
            end = start
        if unknown:
            out.append("".join(reversed(unknown)))
        return out[::-1]

    def _encode_plain(self, text: str) -> List[int]:
        text = ("▁" if self.add_prefix else "") + text.replace(" ", "▁")
        if self.bpe:
            pieces = _merge(list(text), lambda a, b: None if a + b not in self.merge_scores
                            else -self.merge_scores[a + b])
        else:
            pieces = self._viterbi(text)
        return self._symbols(pieces)

    def _join(self, tokens: List[str]) -> str:
        return _metaspace_join(tokens, strip_prefix=self.add_prefix)


class TokenizerWrapper:
    """The HF tokenizer wrapper's interface over a tokenizer of this module
    (Qwen2BPE, LlamaBPE, SentencePieceModel): ids for the specials and
    patch tokens, encode (no special tokens added, optional truncation) and
    decode."""

    def __init__(self, tok: _AddedVocabulary, bos_token: str, eos_token: str):
        self.bpe = tok
        self.patch_token_ids: Dict[str, int] = {
            t: tok.add_token(t) for t in constants.ALL_PATCH_TOKENS}
        self.bos_token_id = tok.token_to_id(bos_token)
        self.eos_token_id = tok.token_to_id(eos_token)
        self.pad_token_id = self.eos_token_id
        self.vocab_size = len(tok.get_vocab())

    def encode(self, text: str, max_length: int | None = None) -> List[int]:
        ids = self.bpe.encode(text)
        return ids[:max_length] if max_length is not None else ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return self.bpe.decode(ids, skip_special_tokens=skip_special_tokens)


def _token_content(token) -> Optional[str]:
    return token.get("content") if isinstance(token, dict) else token


def _read_config(model_dir: str) -> dict:
    config = {}
    config_path = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.exists(config_path):
        with open(config_path, encoding="utf-8") as handle:
            config = json.load(handle)
    if config.get("clean_up_tokenization_spaces"):
        raise NotImplementedError("clean_up_tokenization_spaces is not ported (the Qwen2 and "
                                  "Llama-2 tokenizer_config.json set it false)")
    return config


def load_tokenizer(model_name: str) -> TokenizerWrapper:
    """The LLM's tokenizer with the patch tokens registered (reference:
    models/tokenizer.py:31-45), from `paths.PATH_TO_LLM[model_name]`:
    Qwen2 / Qwen25 and Llama2 from the directory's `tokenizer.json`,
    Baichuan2 from its sentencepiece `tokenizer.model`."""
    if model_name not in ("Qwen2", "Qwen25", "Llama2", "Baichuan2"):
        raise NotImplementedError(f"no tokenizer for {model_name!r} (the JAX package serves "
                                  f"Qwen2, Qwen25, Llama2 and Baichuan2)")
    model_dir = paths.PATH_TO_LLM[model_name]
    config = _read_config(model_dir)
    if model_name == "Baichuan2":
        with open(os.path.join(model_dir, "tokenizer.model"), "rb") as handle:
            proto = read_sentencepiece_model(handle.read())
        tok = SentencePieceModel(proto)
        names = [tok.id_to_token.get(proto[key]) for key in ("bos_id", "eos_id", "unk_id")]
        for name in names:  # HF registers its bos, eos and unk as specials
            if name is not None:
                tok.add_token(name)
        return TokenizerWrapper(tok, bos_token=names[0], eos_token=names[1])
    with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as handle:
        spec = json.load(handle)
    if model_name == "Llama2":
        tok = LlamaBPE(spec)
        bos = _token_content(config.get("bos_token")) or "<s>"
        eos = _token_content(config.get("eos_token")) or "</s>"
        for name in (bos, eos, _token_content(config.get("unk_token")) or "<unk>"):
            tok.add_token(name)  # HF registers its bos, eos and unk as specials
        return TokenizerWrapper(tok, bos_token=bos, eos_token=eos)
    eos = _token_content(config.get("eos_token")) or "<|endoftext|>"
    return TokenizerWrapper(Qwen2BPE(spec), bos_token="<|im_start|>", eos_token=eos)


class ByteTokenizer:
    """Deterministic byte-level tokenizer.

    Bytes 0-255 map to ids 0-255; bos, eos (= pad) and the patch tokens get
    the ids above.
    """

    def __init__(self):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 257  # pad == eos, matching the reference convention
        self.patch_token_ids = {
            tok: 258 + i for i, tok in enumerate(constants.ALL_PATCH_TOKENS)
        }
        self.vocab_size = 258 + len(constants.ALL_PATCH_TOKENS)

    def encode(self, text: str, max_length: int | None = None) -> List[int]:
        ids: List[int] = []
        rest = text
        while rest:
            for tok, tok_id in self.patch_token_ids.items():
                if rest.startswith(tok):
                    ids.append(tok_id)
                    rest = rest[len(tok):]
                    break
            else:
                ids.extend(rest[0].encode("utf-8", errors="replace"))
                rest = rest[1:]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        inverse = {v: k for k, v in self.patch_token_ids.items()}
        out: List[str] = []
        byte_buf: List[int] = []

        def flush():
            if byte_buf:
                out.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for token_id in ids:
            token_id = int(token_id)
            if token_id < 256:
                byte_buf.append(token_id)
            elif token_id == self.bos_token_id or token_id == self.eos_token_id:
                flush()
                if not skip_special_tokens:
                    out.append("<s>" if token_id == self.bos_token_id else "</s>")
            elif token_id in inverse:
                flush()
                if not skip_special_tokens:
                    out.append(inverse[token_id])
            else:
                flush()
        flush()
        return "".join(out)


def encode_batch(tokenizer, texts):
    """bos + encode each text, right-padded to the batch max (the
    reference's answer_sample prepends bos, conversation_video.py:303+).
    Returns (ids [b, t_pad] int32, lengths [b] int32)."""
    encoded = [[tokenizer.bos_token_id] + tokenizer.encode(t) for t in texts]
    lengths = np.array([len(e) for e in encoded], dtype=np.int32)
    ids = np.zeros((len(encoded), int(lengths.max())), dtype=np.int32)
    for i, e in enumerate(encoded):
        ids[i, : len(e)] = e
    return ids, lengths
