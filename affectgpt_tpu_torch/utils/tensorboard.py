"""Optional TensorBoard logging.

The port's own copy of affectgpt_tpu/utils/tensorboard.py, the reference
wrapper's counterpart (reference:
my_affectgpt/common/tensorboard_logger.py:9-56 — present but unwired).
Here it is wired: pass `run.tensorboard: true` and the Runner mirrors
scalar metrics into <output>/tb. Degrades to a no-op when no TB backend
(tensorboardX / torch.utils.tensorboard / tf.summary) is importable.
"""

from __future__ import annotations

from typing import Optional


class TensorBoardLogger:
    def __init__(self, log_dir: str):
        self.writer = None
        for factory in (self._try_tbx, self._try_torch, self._try_tf):
            self.writer = factory(log_dir)
            if self.writer is not None:
                break

    @staticmethod
    def _try_tbx(log_dir):
        try:
            from tensorboardX import SummaryWriter

            return SummaryWriter(log_dir)
        except ImportError:
            return None

    @staticmethod
    def _try_torch(log_dir):
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(log_dir)
        except ImportError:
            return None

    @staticmethod
    def _try_tf(log_dir):
        try:
            import tensorflow as tf

            writer = tf.summary.create_file_writer(log_dir)

            class _TF:
                def add_scalar(self, tag, value, step):
                    with writer.as_default():
                        tf.summary.scalar(tag, value, step=step)

                def close(self):
                    writer.close()

            return _TF()
        except ImportError:
            return None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
