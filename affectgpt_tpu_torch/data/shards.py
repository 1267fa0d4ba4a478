"""Streaming tar-shard dataset (webdataset-style) for caption-scale corpora.

The port's own copy of affectgpt_tpu/data/shards.py. The reference pipes
web-scale image/caption streams through `webdataset` DataPipelines
(reference: my_affectgpt/datasets/data_utils.py:20-60 ChainDataset); here,
with no extra dependency, plain tar shards are streamed with `tarfile`
through a shuffle buffer and split over workers by shard index: sequential
reads per shard, no seek per sample.

Shard layout (webdataset convention): entries `{key}.{ext}` grouped by
key; consecutive entries with one key form one sample. Decoders by
extension: .npy → np.ndarray, .json → dict, .txt → str, .jpg/.jpeg/.png
→ [H, W, 3] uint8 (PIL when importable, else raw bytes).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


def write_shards(
    samples: Iterable[Dict[str, object]],
    out_dir: str,
    shard_size: int = 1000,
    prefix: str = "shard",
) -> List[str]:
    """Write samples into `{out_dir}/{prefix}-{i:06d}.tar`. Each sample is
    a dict whose keys carry extensions ('feat.npy', 'meta.json', 'cap.txt',
    plus a reserved '__key__' string). Returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    writer: Optional[tarfile.TarFile] = None
    count = 0

    def open_next() -> tarfile.TarFile:
        path = os.path.join(out_dir, f"{prefix}-{len(paths):06d}.tar")
        paths.append(path)
        return tarfile.open(path, "w")

    for i, sample in enumerate(samples):
        if writer is None or count >= shard_size:
            if writer is not None:
                writer.close()
            writer = open_next()
            count = 0
        key = str(sample.get("__key__", f"{i:09d}"))
        for field, value in sample.items():
            if field == "__key__":
                continue
            payload = _encode(field, value)
            info = tarfile.TarInfo(name=f"{key}.{field}")
            info.size = len(payload)
            writer.addfile(info, io.BytesIO(payload))
        count += 1
    if writer is not None:
        writer.close()
    return paths


def _encode(field: str, value) -> bytes:
    ext = field.rsplit(".", 1)[-1]
    if ext == "npy":
        buf = io.BytesIO()
        np.save(buf, np.asarray(value))
        return buf.getvalue()
    if ext == "json":
        return json.dumps(value).encode()
    if ext in ("txt", "text"):
        return str(value).encode()
    if isinstance(value, bytes):
        return value
    raise ValueError(f"cannot encode field {field!r} of type {type(value)}")


def _decode(name: str, payload: bytes):
    ext = name.rsplit(".", 1)[-1].lower()
    if ext == "npy":
        return np.load(io.BytesIO(payload))
    if ext == "json":
        return json.loads(payload.decode())
    if ext in ("txt", "text"):
        return payload.decode()
    if ext in ("jpg", "jpeg", "png"):
        try:
            from PIL import Image

            return np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"))
        except ImportError:
            return payload
    return payload


def iter_shard(path: str) -> Iterator[Dict[str, object]]:
    """Stream one tar shard, grouping consecutive entries by key."""
    current_key: Optional[str] = None
    sample: Dict[str, object] = {}
    with tarfile.open(path, "r") as tar:
        for member in tar:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            key, _, field = base.partition(".")
            if key != current_key:
                if current_key is not None:
                    yield sample
                current_key, sample = key, {"__key__": key}
            handle = tar.extractfile(member)
            if handle is not None:
                sample[field] = _decode(base, handle.read())
    if current_key is not None:
        yield sample


class ShardDataset:
    """Iterable over a set of tar shards with worker sharding and a
    shuffle buffer (the streaming analogue of a map-style dataset's
    permutation; same role as webdataset's .shuffle())."""

    def __init__(
        self,
        shard_paths: Sequence[str],
        shuffle_buffer: int = 0,
        seed: int = 0,
        worker_index: int = 0,
        num_workers: int = 1,
        transform: Optional[Callable[[Dict[str, object]], Dict[str, object]]] = None,
    ):
        if num_workers < 1 or not (0 <= worker_index < num_workers):
            raise ValueError("bad worker split")
        self.paths = list(shard_paths)[worker_index::num_workers]
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.transform = transform
        self._epoch = 0

    def __iter__(self) -> Iterator[Dict[str, object]]:
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = rng.permutation(len(self.paths)) if self.shuffle_buffer else range(len(self.paths))

        def stream():
            for shard_idx in order:
                yield from iter_shard(self.paths[shard_idx])

        source = stream()
        if self.shuffle_buffer > 1:
            source = _buffered_shuffle(source, self.shuffle_buffer, rng)
        for sample in source:
            yield self.transform(sample) if self.transform else sample


def _buffered_shuffle(source: Iterator, buffer_size: int, rng) -> Iterator:
    buf: List = []
    for item in source:
        buf.append(item)
        if len(buf) >= buffer_size:
            i = rng.randint(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf
