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
token. Llama-2's `tokenizer.json` (sentencepiece-style BPE with byte
fallback) and Baichuan2's `tokenizer.model` raise NotImplementedError.

The ByteTokenizer has the same interface (ids for the specials, encode,
decode) and stands in where no tokenizer files exist, as in the
random-weight mode.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import Dict, List, Optional

import numpy as np

from affectgpt_tpu_torch import constants, paths

# Qwen2's pre-tokenizer pattern (tokenizer.json, pre_tokenizer Split), which
# `pre_tokenize` implements
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_NOT_PORTED = "(ROADMAP queue 1 item 13b: the sentencepiece-style tokenizers)"


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


class Qwen2BPE:
    """A byte-level BPE tokenizer read from a `tokenizer.json` of Qwen2's
    form (NFC normalizer, QWEN2_PATTERN split + byte-level pre-tokenizer, BPE
    model, byte-level decoder); anything else raises NotImplementedError."""

    def __init__(self, spec: dict):
        model = spec.get("model") or {}
        if model.get("type") != "BPE" or model.get("byte_fallback") \
                or model.get("continuing_subword_prefix") or model.get("end_of_word_suffix") \
                or model.get("dropout"):
            raise NotImplementedError(f"tokenizer.json model {model.get('type')!r} with these "
                                      f"options is not ported {_NOT_PORTED}")
        _check_qwen2_pipeline(spec)
        self.vocab: Dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges", [])]
        self.ranks = {pair: rank for rank, pair in reversed(list(enumerate(merges)))}
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.model_vocab_size = len(self.vocab)
        self.added: Dict[str, int] = {}
        self.special: set = set()
        # HF re-adds the file's added tokens in order when it loads them, so
        # their ids follow add_token's rule, not the ids the file states
        for tok in spec.get("added_tokens", []):
            if tok.get("lstrip") or tok.get("rstrip") or tok.get("single_word") \
                    or tok.get("normalized"):
                raise NotImplementedError(f"added token {tok['content']!r}: lstrip, rstrip, "
                                          f"single_word and normalized are not ported")
            self.add_token(tok["content"], special=bool(tok.get("special")), reindex=False)
        self._reindex()
        self._cache: Dict[str, List[int]] = {}

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

    def _bpe(self, piece: str) -> List[int]:
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        word = "".join(BYTE_TO_CHAR[b] for b in piece.encode("utf-8"))
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            parts = list(word)
            while len(parts) > 1:
                best, at = None, -1
                for k in range(len(parts) - 1):
                    rank = self.ranks.get((parts[k], parts[k + 1]))
                    if rank is not None and (best is None or rank < best):
                        best, at = rank, k
                if best is None:
                    break
                parts[at:at + 2] = [parts[at] + parts[at + 1]]
            ids = [self.vocab[p] for p in parts if p in self.vocab]
        self._cache[piece] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        segments, pos = [], 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                segments.append((text[pos:m.start()], None))
                segments.append((None, self.added[m.group()]))
                pos = m.end()
        segments.append((text[pos:], None))
        for plain, added in segments:
            if added is not None:
                ids.append(added)
            elif plain:
                for piece in pre_tokenize(unicodedata.normalize("NFC", plain)):
                    ids.extend(self._bpe(piece))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        data = bytearray()
        for token_id in ids:
            token = self.id_to_token.get(int(token_id))
            if token is None or (skip_special_tokens and token in self.special):
                continue
            if all(c in CHAR_TO_BYTE for c in token):
                data.extend(CHAR_TO_BYTE[c] for c in token)
            else:
                data.extend(token.encode("utf-8"))
        return data.decode("utf-8", errors="replace")


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
                                  f"pattern, byte-level BPE) {_NOT_PORTED}")


class TokenizerWrapper:
    """The HF tokenizer wrapper's interface over Qwen2BPE: ids for the
    specials and patch tokens, encode (no special tokens added, optional
    truncation) and decode."""

    def __init__(self, bpe: Qwen2BPE, bos_token: str, eos_token: str):
        self.bpe = bpe
        self.patch_token_ids: Dict[str, int] = {
            tok: bpe.add_token(tok) for tok in constants.ALL_PATCH_TOKENS}
        self.bos_token_id = bpe.token_to_id(bos_token)
        self.eos_token_id = bpe.token_to_id(eos_token)
        self.pad_token_id = self.eos_token_id
        self.vocab_size = len(bpe.get_vocab())

    def encode(self, text: str, max_length: int | None = None) -> List[int]:
        ids = self.bpe.encode(text)
        return ids[:max_length] if max_length is not None else ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return self.bpe.decode(ids, skip_special_tokens=skip_special_tokens)


def _token_content(token) -> Optional[str]:
    return token.get("content") if isinstance(token, dict) else token


def load_tokenizer(model_name: str) -> TokenizerWrapper:
    """The LLM's tokenizer with the patch tokens registered (reference:
    models/tokenizer.py:31-45), from `paths.PATH_TO_LLM[model_name]`:
    Qwen2 / Qwen25 only."""
    if model_name not in ("Qwen2", "Qwen25"):
        raise NotImplementedError(f"the {model_name} tokenizer is not ported {_NOT_PORTED}")
    model_dir = paths.PATH_TO_LLM[model_name]
    with open(os.path.join(model_dir, "tokenizer.json"), encoding="utf-8") as handle:
        spec = json.load(handle)
    config = {}
    config_path = os.path.join(model_dir, "tokenizer_config.json")
    if os.path.exists(config_path):
        with open(config_path, encoding="utf-8") as handle:
            config = json.load(handle)
    if config.get("clean_up_tokenization_spaces"):
        raise NotImplementedError("clean_up_tokenization_spaces is not ported (Qwen2's "
                                  "tokenizer_config.json sets it false)")
    bpe = Qwen2BPE(spec)
    eos = _token_content(config.get("eos_token")) or "<|endoftext|>"
    return TokenizerWrapper(bpe, bos_token="<|im_start|>", eos_token=eos)


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
