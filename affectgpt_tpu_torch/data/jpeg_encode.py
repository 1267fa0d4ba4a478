"""Baseline JPEG encoder: the device DCT pass and host Huffman coding.

The JAX package encodes MJPEG-AVI frames with PIL (its data/ingest.py
`_jpeg_bytes`), which the card lacks. The port encodes what PIL writes
for `Image.save(buf, "JPEG", quality=q)` of an RGB frame: a JFIF baseline
JPEG, 4:2:0, the IJG tables scaled to q, the standard Huffman tables
(T.81 K.3, no optimization), components Y, Cb, Cr in one interleaved scan.
`ops/jpeg.encode_mjpeg_coefficients` makes the quantized coefficients on
the frames' device; this module Huffman-codes them on the host with numpy
(every symbol of a frame at once: the run lengths, categories and codes
as arrays, then the bits packed and 0xFF bytes stuffed) and writes the
markers native/videodec.cpp and PIL read.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator

import numpy as np
import torch

from affectgpt_tpu_torch.ops import jpeg as jpeg_ops


def _zigzag() -> np.ndarray:
    """The natural index of the k-th coefficient in zigzag order."""
    order = []
    for s in range(15):
        cells = [(i, s - i) for i in range(8) if 0 <= s - i < 8]
        order += cells if s % 2 else cells[::-1]
    return np.array([i * 8 + j for i, j in order], np.int64)


ZIGZAG = _zigzag()

# T.81 K.3: (bits, values) of the DC and AC tables, luminance then chrominance
_HUFFMAN = {
    (0, 0): ("00010501010101010100000000000000", "000102030405060708090a0b"),
    (1, 0): ("0002010303020403050504040000017d",
             "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272"
             "82090a161718191a25262728292a3435363738393a434445464748494a53545556575859"
             "5a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3"
             "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
             "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    (0, 1): ("00030101010101010101010000000000", "000102030405060708090a0b"),
    (1, 1): ("00020102040403040705040400010277",
             "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1"
             "0a162434e125f11718191a262728292a35363738393a434445464748494a535455565758"
             "595a636465666768696a737475767778797a82838485868788898a92939495969798999a"
             "a2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
             "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"),
}


def _code_table(bits: bytes, values: bytes) -> tuple:
    """(code, length) arrays indexed by symbol (T.81 C.2-C.3)."""
    code_of, len_of = np.zeros(256, np.int64), np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code_of[values[k]], len_of[values[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, len_of


_TABLES = {key: (bytes.fromhex(b), bytes.fromhex(v)) for key, (b, v) in _HUFFMAN.items()}
_CODES = {key: _code_table(*tv) for key, tv in _TABLES.items()}


def _category(v: np.ndarray) -> np.ndarray:
    """The bit count of |v| (T.81 F.1.2.1): 0 for 0."""
    a = np.abs(v)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)


def _amplitude(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The `size` low bits that follow a category: v, or v - 1 in ones'
    complement for a negative v."""
    return np.where(v >= 0, v, v + (np.int64(1) << size) - 1)


def _mcu_order(mcuy: int, mcux: int) -> tuple:
    """Block indices (into the Y, Cb, Cr layout of encode_mjpeg_coefficients)
    in the scan's order: each MCU's four Y blocks, then its Cb and Cr; and
    each scanned block's table (0 luminance, 1 chrominance)."""
    my, mx = np.meshgrid(np.arange(mcuy), np.arange(mcux), indexing="ij")
    my, mx = my.reshape(-1), mx.reshape(-1)
    ny = 4 * mcuy * mcux
    y = [(2 * my + dy) * (2 * mcux) + 2 * mx + dx for dy in (0, 1) for dx in (0, 1)]
    cb = ny + my * mcux + mx
    cr = cb + mcuy * mcux
    order = np.stack(y + [cb, cr], axis=1).reshape(-1)
    table = np.tile(np.array([0, 0, 0, 0, 1, 1]), mcuy * mcux)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mcuy * mcux)
    return order, table, comp


def _entropy_code(zz: np.ndarray, table: np.ndarray, comp: np.ndarray) -> bytes:
    """zz [blocks, 64] int zigzag coefficients in scan order → the scan's
    bytes, stuffed and padded with one-bits."""
    nb = zz.shape[0]
    dc = zz[:, 0]
    diff = np.empty_like(dc)
    for c in range(3):  # each component predicts its DC from its previous block
        idx = np.nonzero(comp == c)[0]
        diff[idx] = dc[idx] - np.concatenate([[0], dc[idx][:-1]])
    dc_size = _category(diff)
    keys, vals, lens = [], [], []

    def emit(key, value, length):
        keys.append(key)
        vals.append(value)
        lens.append(length)

    big = 1024
    blocks = np.arange(nb, dtype=np.int64)
    dc_code = np.where(table == 0, _CODES[0, 0][0][dc_size], _CODES[0, 1][0][dc_size])
    dc_len = np.where(table == 0, _CODES[0, 0][1][dc_size], _CODES[0, 1][1][dc_size])
    emit(blocks * big, dc_code, dc_len)
    emit(blocks * big + 1, _amplitude(diff, dc_size), dc_size)

    blk, pos = np.nonzero(zz[:, 1:])  # block-major, positions ascending
    v = zz[blk, pos + 1]
    prev = np.concatenate([[-1], pos[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = -1
    run = pos - prev - 1
    size = _category(v)
    tab = table[blk]

    def ac_code(symbol):
        return (np.where(tab == 0, _CODES[1, 0][0][symbol], _CODES[1, 1][0][symbol]),
                np.where(tab == 0, _CODES[1, 0][1][symbol], _CODES[1, 1][1][symbol]))

    base = blk * big + 2 + pos * 8
    zrl_code, zrl_len = ac_code(np.full_like(run, 0xF0))
    for j in range(3):  # a run of 16 zeros is one ZRL symbol; at most 3 before a value
        has = (run >> 4) > j
        emit(base[has] + j, zrl_code[has], zrl_len[has])
    code, length = ac_code(((run & 15) << 4) | size)
    emit(base + 4, code, length)
    emit(base + 5, _amplitude(v, size), size)

    last = np.full(nb, -1, np.int64)
    last[blk] = pos  # the last nonzero AC position of each block
    eob = last < 62
    eob_code, eob_len = np.where(table == 0, _CODES[1, 0][0][0], _CODES[1, 1][0][0]), \
        np.where(table == 0, _CODES[1, 0][1][0], _CODES[1, 1][1][0])
    emit(blocks[eob] * big + 2 + 63 * 8, eob_code[eob], eob_len[eob])

    key = np.concatenate(keys)
    order = np.argsort(key, kind="stable")
    value = np.concatenate(vals)[order]
    length = np.concatenate(lens)[order]
    keep = length > 0
    value, length = value[keep], length[keep]
    total = int(length.sum())
    event = np.repeat(np.arange(len(length)), length)
    offset = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    bits = ((value[event] >> (length[event] - 1 - offset)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _headers(width: int, height: int, tables: np.ndarray) -> bytes:
    """SOI, JFIF APP0, the two DQTs (zigzag), SOF0 (Y 2x2, Cb and Cr 1x1),
    the four DHTs and SOS, in PIL's order."""
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in range(2):
        out += _segment(0xDB, bytes([t]) + bytes(tables[t][ZIGZAG].astype(np.uint8)))
    out += _segment(0xC0, bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for t in range(2):
        for kind in range(2):
            bits, values = _TABLES[kind, t]
            out += _segment(0xC4, bytes([kind << 4 | t]) + bits + values)
    return out + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def encode_frames(frames: Iterable, quality: int = 90, device="cuda",
                  chunk: int = 16) -> Iterator[bytes]:
    """Yields each RGB frame ([H, W, 3] uint8, numpy or torch, all of one
    size) as the bytes of a baseline JPEG at `quality`, reading `frames`
    `chunk` at a time: the DCT pass runs on `device` (the card unless the
    caller says otherwise), the Huffman coding on the host."""
    frames = iter(frames)
    header = order = None
    while True:
        batch = list(itertools.islice(frames, chunk))
        if not batch:
            return
        batch = torch.stack([f if torch.is_tensor(f) else torch.from_numpy(np.ascontiguousarray(f))
                             for f in batch]).to(device)
        if header is None:
            height, width = batch.shape[1:3]
            order, table, comp = _mcu_order(-(-height // 16), -(-width // 16))
            header = _headers(width, height, jpeg_ops.quality_tables(quality))
        elif batch.shape[1:3] != (height, width):
            raise ValueError(f"frames of {tuple(batch.shape[1:3])} after {(height, width)}")
        coefs = jpeg_ops.encode_mjpeg_coefficients(batch, quality).cpu().numpy()
        for frame in coefs:
            zz = frame[order][:, ZIGZAG].astype(np.int64)
            yield header + _entropy_code(zz, table, comp) + b"\xff\xd9"
