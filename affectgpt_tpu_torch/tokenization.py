"""The dependency-free ByteTokenizer and batch prompt encoding.

The port's own copy of `ByteTokenizer` and `encode_batch` from
affectgpt_tpu/tokenization.py. The ByteTokenizer has the interface of the
HF tokenizer wrapper (ids for the specials, encode, decode) and stands in
for it where no tokenizer files exist, as in the random-weight mode.
"""

from __future__ import annotations

from typing import List

import numpy as np

from affectgpt_tpu_torch import constants


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
