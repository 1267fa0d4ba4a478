"""Input pipeline: ratio-mixed multi-dataset iteration with background
prefetch to the device.

The port's own copy of affectgpt_tpu/data/loaders.py (reference:
my_affectgpt/datasets/datasets/dataloader_utils.py:15-153 — MultiIterLoader
ratio-weighted choice, IterLoader infinite epochs, PrefetchLoader's
side-stream copy). `IterLoader` and `MultiIterLoader` keep JAX's
`random.Random` streams, so a seed draws the same samples in the same
order in both packages. `DevicePrefetcher` runs the loader and the upload
in a worker thread while the current step runs: on the card it collates on
the host, copies from freshly pinned memory with non_blocking=True on a
side CUDA stream, and hands each batch to the consumer's stream behind an
event.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch


class IterLoader:
    """Infinite shuffled iterator over a dataset with a collate fn."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, shuffle: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rng = random.Random(seed)
        self.shuffle = shuffle
        self._order: List[int] = []
        self._pos = 0
        self.epoch = 0

    def _reshuffle(self):
        self._order = list(range(len(self.dataset)))
        if self.shuffle:
            self.rng.shuffle(self._order)
        self._pos = 0
        self.epoch += 1

    def __next__(self):
        instances = []
        for _ in range(self.batch_size):
            if self._pos >= len(self._order):
                self._reshuffle()
            instances.append(self.dataset[self._order[self._pos]])
            self._pos += 1
        return self.dataset.collate(instances)

    def __iter__(self):
        return self


class MultiIterLoader:
    """Per-step ratio-weighted random choice across dataset loaders
    (reference dataloader_utils.py:15-64)."""

    def __init__(self, loaders: Sequence, ratios: Optional[Sequence[float]] = None, seed: int = 0):
        self.loaders = list(loaders)
        if ratios is None:
            ratios = [1.0] * len(self.loaders)
        total = float(sum(ratios))
        self.probs = [r / total for r in ratios]
        self.rng = random.Random(seed)

    def __next__(self):
        idx = self.rng.choices(range(len(self.loaders)), weights=self.probs)[0]
        return next(self.loaders[idx])

    def __iter__(self):
        return self


class ConcatDataset:
    """Concatenate datasets sharing a collator (reference
    data_utils.concat_datasets / datasets.ConcatDataset role)."""

    def __init__(self, datasets: Sequence):
        assert datasets
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for ds in self.datasets:
            self._offsets.append(total)
            total += len(ds)
        self._total = total

    def __len__(self) -> int:
        return self._total

    def __getitem__(self, index: int):
        for ds, off in zip(reversed(self.datasets), reversed(self._offsets)):
            if index >= off:
                return ds[index - off]
        raise IndexError(index)

    def collate(self, instances):
        return self.datasets[0].collate(instances)


def reorg_datasets_by_split(datasets_by_name: dict) -> dict:
    """{name: {split: dataset}} → {split: [datasets]} (reference
    data_utils.reorg_datasets_by_split)."""
    by_split: dict = {}
    for _, splits in datasets_by_name.items():
        if not isinstance(splits, dict):
            splits = {"train": splits}
        for split, dataset in splits.items():
            by_split.setdefault(split, []).append(dataset)
    return by_split


def to_device(batch, device):
    """A host batch's numpy arrays as tensors on `device` (nested dicts and
    lists kept, other leaves as they are). For a CUDA device each array is
    copied from its own freshly pinned buffer with non_blocking=True on the
    current stream; the pinned allocator keeps a buffer until the copies
    that read it have ended, so none is reused early."""
    device = torch.device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if not isinstance(x, np.ndarray):
            return x
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    return put(batch)


def tensors_of(tree) -> List[torch.Tensor]:
    """Every tensor in a tree of dicts and lists."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return [tree] if torch.is_tensor(tree) else []


class DevicePrefetcher:
    """A worker thread that draws, collates and uploads the next batches
    (up to `depth` ahead) while the device runs the current step: the
    reference PrefetchLoader's role (dataloader_utils.py:78-153).

    put_fn(host_batch) makes the device batch (default: `to_device` to
    `device`). On a CUDA device it runs on a side stream of the worker's
    own; the batch is queued with an event recorded after it, and
    `__next__` makes the consumer's current stream wait on that event and
    records every tensor of the batch on that stream, so the side stream's
    memory is not reused under the consumer. Device work in put_fn (the
    realtime encoders) runs on the side stream too. An exception in the
    worker is raised by the `__next__` that would have returned its batch.
    `close()` stops the worker and joins it, even while it waits on a full
    queue. limit: the worker draws at most this many batches and stops
    (None: no end), so a consumer that takes all of them leaves no batch
    drawn and unused at `close()`."""

    def __init__(self, loader, put_fn: Optional[Callable] = None, depth: int = 2,
                 device="cuda", limit: Optional[int] = None):
        self.loader = loader
        self.limit = limit
        self.device = torch.device(device)
        self.put_fn = put_fn or (lambda batch: to_device(batch, self.device))
        self.queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _offer(self, item) -> bool:
        """Queue `item`, waiting for room until close(); False if closed."""
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        drawn = 0
        try:
            while not self._stop.is_set() and (self.limit is None or drawn < self.limit):
                batch = next(self.loader)
                drawn += 1
                event = None
                if self.stream is not None:
                    with torch.cuda.stream(self.stream):
                        item = self.put_fn(batch)
                        event = torch.cuda.Event()
                        event.record(self.stream)
                else:
                    item = self.put_fn(batch)
                if not self._offer((item, event)):
                    return
        except Exception as error:  # surface loader errors to the consumer
            self._offer(error)

    def __next__(self):
        item = self.queue.get()
        if isinstance(item, Exception):
            raise item
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in tensors_of(batch):
                if t.is_cuda:
                    t.record_stream(consumer)
        return batch

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        self.thread.join()
