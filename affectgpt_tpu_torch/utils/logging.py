"""Training observability: smoothed metrics, step logging, curve dumps,
and profiler hooks.

The port's own copy of affectgpt_tpu/utils/logging.py (reference:
my_affectgpt/common/logger.py:19-100 MetricLogger/SmoothedValue with
cross-process sync; training_visualizer.py:14-56 matplotlib curves;
runner_base.py:691-704 JSON-lines log.txt), plus what the reference lacks
(SURVEY §5 'tracing: none'): a torch.profiler trace around a window of
steps. Meters sum across ranks with torch.distributed; matplotlib stays
optional.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger("affectgpt_tpu_torch")


def setup_logger(level=logging.INFO) -> None:
    logging.basicConfig(
        level=level,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
        force=False,
    )


class SmoothedValue:
    """Windowed + global average of a scalar series."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, global_avg=self.global_avg)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for key, value in kwargs.items():
            self.meters[key].update(float(value))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())

    def synchronize_between_processes(self, device=None) -> None:
        """Cross-rank metric reduction: all-reduce each meter's count and
        total (the reference's NCCL all_reduce, common/logger.py:37-48), so
        global_avg agrees on every rank. A no-op without an initialized
        torch.distributed group of more than one rank. device: where the
        reduced tensor lives (the card under NCCL; the CPU under gloo)."""
        import torch
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
            return
        if device is None:
            device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        keys = sorted(self.meters)
        local = torch.tensor([[self.meters[k].count, self.meters[k].total] for k in keys],
                             dtype=torch.float64, device=device).reshape(-1, 2)
        dist.all_reduce(local)
        summed = local.cpu().numpy()
        for i, k in enumerate(keys):
            self.meters[k].count = int(summed[i, 0])
            self.meters[k].total = float(summed[i, 1])

    def log_every(self, iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{median:.4f}")
        for i, obj in enumerate(iterable):
            tic = time.time()
            yield obj
            iter_time.update(time.time() - tic)
            if i % print_freq == 0:
                try:
                    total = len(iterable)
                except TypeError:
                    total = -1
                eta = iter_time.global_avg * (total - i) if total > 0 else float("nan")
                logger.info(
                    "%s [%d/%d] eta: %.0fs %s iter_time: %s",
                    header, i, total, eta, str(self), str(iter_time),
                )
        logger.info("%s total time: %.1fs", header, time.time() - start)

    def to_dict(self) -> Dict[str, float]:
        return {k: v.global_avg for k, v in self.meters.items()}


class JsonLinesLogger:
    """Append config + per-epoch stats to <output>/log.txt as JSON lines
    (the reference's log contract, runner_base.py:691-704)."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "log.txt")

    def write(self, record: dict) -> None:
        with open(self.path, "a") as handle:
            handle.write(json.dumps(record, default=str) + "\n")


class TrainingVisualizer:
    """Collect lr/loss curves and dump a PNG per epoch (reference
    training_visualizer.py:14-56). Matplotlib is optional."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        self.history: Dict[str, list] = defaultdict(list)

    def record(self, **kwargs) -> None:
        for key, value in kwargs.items():
            self.history[key].append(float(value))

    def plot_and_save(self, epoch: int) -> Optional[str]:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return None
        os.makedirs(self.output_dir, exist_ok=True)
        keys = list(self.history)
        if not keys:
            return None
        fig, axes = plt.subplots(1, len(keys), figsize=(5 * len(keys), 4))
        if len(keys) == 1:
            axes = [axes]
        for ax, key in zip(axes, keys):
            ax.plot(self.history[key])
            ax.set_title(key)
            ax.set_xlabel("step")
        path = os.path.join(self.output_dir, f"training_curves_epoch{epoch}.png")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path


@contextmanager
def profile_trace(log_dir: Optional[str], rank: int = 0):
    """A torch.profiler window (host and, where there is a card, device
    activity) whose Chrome trace is written to
    `log_dir/trace_rank{rank}.json` when the window closes; first-class
    tracing the reference lacks."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_rank{rank}.json"))
