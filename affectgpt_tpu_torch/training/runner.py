"""Training orchestration: datasets → mixed loaders → the data-parallel
step → per-epoch checkpoints, logs and curves.

Port of affectgpt_tpu/training/runner.py (reference:
runners/runner_base.py:42-704 RunnerBase + tasks/base_task.py:101-198
train_epoch): warmup-cosine LR at iteration resolution, gradient
accumulation, ratio-mixed multi-dataset sampling, the epoch-0 zero-shot
checkpoint, per-epoch trainable-only checkpoints with the loss in the name,
the JSON-lines log.txt, training curves, validation with a best
checkpoint, resume and a profiler window. One process runs on each card
(or on the CPU); with a torch.distributed group of several ranks laid out
(dp, tp) by `run.tp` (JAX runner.py:88), each dp rank loads its share of
the global batch from its own sample stream (the seed offset by 7919 · dp
rank), which the tp ranks of its row draw alike; the frozen LLM is the
rank's shard and the step sums the gradients as `training.train_step`
says. Rank 0 alone writes checkpoints and logs, after a barrier; a
checkpoint holds the whole trainable tree whatever tp is, so one written
under tp resumes under any other.

Each epoch's `DevicePrefetcher` draws exactly the epoch's batches
(`limit=iters_per_epoch`), and every one is trained on, in the loader's
order: a departure from JAX, whose epoch prefetcher draws ahead and drops
what it holds at the epoch's end, a count that depends on thread timing.
So the sample stream is the loader's own whatever the timing, the tp
ranks of a row see the same batches in every epoch, and validation, whose
loader shares the datasets (and their random state) with training, always
draws between the same two training batches.

The loop reads the device only at log boundaries (`float(loss)`); the
schedule is a host function. `Runner.iteration_ms` and `Runner.wait_ms`
keep each iteration's wall time and the part of it spent waiting on the
prefetcher, over every `train_epoch` of the runner in order.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from affectgpt_tpu_torch import registry
from affectgpt_tpu_torch.config import Config
import affectgpt_tpu_torch.data.datasets  # noqa: F401 — registers the dataset classes
import affectgpt_tpu_torch.data.instruction_datasets  # noqa: F401 — instruction/caption corpora
from affectgpt_tpu_torch.data.base_dataset import DatasetConfig, ModelDataConfig
from affectgpt_tpu_torch.data.loaders import (
    DevicePrefetcher,
    IterLoader,
    MultiIterLoader,
    to_device,
)
from affectgpt_tpu_torch.models import affectgpt
from affectgpt_tpu_torch.parallel import mesh as mesh_lib
from affectgpt_tpu_torch.training import checkpoint, optim, train_step
from affectgpt_tpu_torch.utils.logging import (
    JsonLinesLogger,
    MetricLogger,
    TrainingVisualizer,
    logger,
)

# each rank's loaders draw from seed + 7919 · rank (JAX runner.py:136)
RANK_SEED_STRIDE = 7919


@registry.register_task("video_text_pretrain")
def build_datasets(cfg: Config, tokenizer, model_cfg: affectgpt.AffectGPTConfig,
                   device="cuda"):
    """Instantiate every dataset named in the YAML `datasets:` section
    (the reference's registry path, tasks/base_task.py:33-62).
    device: where a dataset encodes its realtime AU texts."""
    data_model_cfg = ModelDataConfig(
        num_video_query_token=model_cfg.num_video_query_token,
        num_audio_query_token=model_cfg.num_audio_query_token,
        num_multi_query_token=model_cfg.num_multi_query_token,
        num_image_query_token=model_cfg.num_image_query_token,
        au_fusion_type=model_cfg.au_fusion_type,
    )
    datasets, ratios = [], []
    for name, node in cfg.datasets.items():
        ds_cfg = DatasetConfig.from_cfg(node)
        if ds_cfg.face_or_frame.startswith("multi"):
            assert model_cfg.use_multi, "multi fusion requested but model has use_multi=False"
        cls = registry.get("dataset", _canonical_dataset_name(name))
        datasets.append(cls(tokenizer, ds_cfg, data_model_cfg, device=device))
        ratios.append(float((node or {}).get("ratio", 1.0)))
    return datasets, ratios


def _canonical_dataset_name(name: str) -> str:
    """YAML keys are conventionally lowercase (the reference's dataset
    names); resolve them case-insensitively against the registry."""
    registered = registry.names("dataset")
    if name in registered:
        return name
    lowered = {n.lower(): n for n in registered}
    return lowered.get(name.lower(), name)


@registry.register_runner("runner_base")
class Runner:
    def __init__(
        self,
        cfg: Config,
        tokenizer,
        frozen,
        trainable,
        model_cfg: affectgpt.AffectGPTConfig,
        datasets,
        ratios,
        layout: Optional[mesh_lib.Layout] = None,
        job_id: Optional[str] = None,
        device="cuda",
    ):
        """frozen and trainable: `bootstrap.build_model`'s trees, the LLM
        whole or already the rank's shard (`build_model(layout=)`), the
        trainable tree whole. layout: this process's (dp, tp) place
        (default: from torch.distributed with `run.tp` tp ranks a row, on
        `device`; its tp must equal `run.tp`)."""
        self.cfg = cfg
        run = cfg.run
        tp = int(run.get("tp", 1))
        self.layout = layout or mesh_lib.create_layout(device=device, tp=tp)
        if self.layout.tp != tp:
            raise ValueError(f"run.tp={tp} but the layout has tp={self.layout.tp}")
        if self.layout.tp > 1:
            frozen, model_cfg = mesh_lib.shard_llm(frozen, model_cfg, self.layout)
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.device = self.layout.device
        self.is_main = self.layout.is_main
        seed = int(run.get("seed", 42))

        self.max_epoch = int(run.get("max_epoch", 1))
        self.iters_per_epoch = int(run.get("iters_per_epoch", 100))
        # batch_size_train is each dp rank's share; the global batch is
        # batch_size_train · dp (JAX runner.py:99)
        self.batch_size = int(run.get("batch_size_train", 1))
        self.log_freq = int(run.get("log_freq", 50))

        total_steps = self.max_epoch * self.iters_per_epoch
        sched_name = run.get("lr_sched", "linear_warmup_cosine_lr")
        self.schedule = registry.get("lr_scheduler", sched_name)(
            init_lr=float(run.get("init_lr", 1e-5)),
            min_lr=float(run.get("min_lr", 1e-6)),
            warmup_steps=int(run.get("warmup_steps", 0)),
            total_steps=total_steps,
            warmup_start_lr=float(run.get("warmup_lr", -1)),
            decay_rate=float(run.get("lr_decay_rate", 1.0)),
            steps_per_epoch=self.iters_per_epoch,
        )
        self.tx = optim.make_optimizer(
            self.schedule,
            weight_decay=float(run.get("weight_decay", 0.05)),
            beta2=float(run.get("beta2", 0.999)),
            max_grad_norm=run.get("max_grad_norm"),
            accum_steps=int(run.get("accum_grad_iters", 1)),
        )
        model_node = cfg.model.to_dict() if hasattr(cfg.model, "to_dict") else dict(cfg.model)
        if any(str(k).startswith("frozen_") and v for k, v in model_node.items()):
            mask = optim.freeze_mask_from_flags(trainable, model_node)
            self.tx = optim.apply_freeze_mask(self.tx, mask)

        state = train_step.create_train_state(trainable, self.tx)
        self.state = train_step.shard_state(self.layout, state)
        self.frozen = frozen
        remat_cfg = run.get("remat", False)  # False | True | "dots"
        self.remat = remat_cfg if remat_cfg == "dots" else bool(remat_cfg)
        # train-mode dropout: the reference trains under model.train()
        # (runner_base.py:461), so the seed is passed unconditionally and each
        # site's own rate gates it (LoRA dropout, the qformer mergers' BERT
        # dropouts); validation below runs in eval mode, as runner_base.py:496
        self.step_fn = train_step.make_train_step(
            model_cfg, self.tx, remat=self.remat, dropout_seed=seed, layout=self.layout,
            check_replicas=bool(run.get("check_tp_replicas", False)))

        if bool(run.get("smoke_check", True)):
            # fail fast on a broken corpus before any training work (the
            # reference collates 3 samples at dataset init, base_dataset.py:156-165)
            for ds in datasets:
                ds.smoke_check()
                logger.info("smoke check ok: %s (%d samples)", ds.dataset, len(ds))

        # per-dp-rank seed offset: dp ranks draw disjoint sample streams (the
        # role of the reference's DistributedSampler), the tp ranks of a row
        # the same one
        rank_off = RANK_SEED_STRIDE * self.layout.dp_rank
        loaders = [IterLoader(ds, self.batch_size, seed=seed + i + rank_off)
                   for i, ds in enumerate(datasets)]
        self.loader = MultiIterLoader(loaders, ratios, seed=seed)

        # optional validation (reference runner_base.py:385-446 evaluate +
        # best checkpoint): an eval-mode loss over an independent sample
        # stream of the first training corpus; it tracks fit and divergence,
        # not generalization (the reference's valid splits are separate files)
        self.evaluate = bool(run.get("evaluate", False))
        self.val_iters = int(run.get("val_iters", 20))
        self._val_loader = None
        if self.evaluate and datasets:
            self._val_loader = IterLoader(datasets[0], self.batch_size,
                                          seed=seed + 999 + rank_off)
        self.best_val = float("inf")

        self.output_dir = cfg.output_dir if job_id is None else f"{cfg.output_dir}/{job_id}"
        self.json_log = JsonLinesLogger(self.output_dir) if self.is_main else None
        self.visualizer = TrainingVisualizer(self.output_dir)
        self.tb = None
        if run.get("tensorboard", False) and self.is_main:
            from affectgpt_tpu_torch.utils.tensorboard import TensorBoardLogger

            self.tb = TensorBoardLogger(os.path.join(self.output_dir, "tb"))
        self.start_epoch = 0
        self.iteration_ms: list = []
        self.wait_ms: list = []

        resume = run.get("resume_ckpt_path")
        if resume:
            payload = checkpoint.load_checkpoint(resume, map_location=self.device)
            trainable = optim.tree_map(lambda t: t.to(torch.float32), payload["trainable"])
            opt_state = payload.get("opt_state") or self.tx.init(trainable)
            self.state = train_step.shard_state(self.layout, train_step.TrainState(
                step=int(payload["step"]), trainable=trainable, opt_state=opt_state))
            # checkpoints store epoch = EPOCHS COMPLETED: the next epoch to
            # train is payload["epoch"] (a +1 here would skip an epoch)
            self.start_epoch = int(payload["epoch"])
            self.best_val = float(payload.get("best_val", float("inf")))
            logger.info("Resumed from %s at epoch %d", resume, self.start_epoch)

    def _device_batch(self, batch: dict) -> dict:
        """Host batch → this rank's device batch: ids, masks, labels,
        features and offsets as tensors on the layout's device; in realtime
        mode (raw media and the frozen encoders present) the encoders turn
        the raw media into features on the device, as the reference's
        non-preextracted branch does."""
        out = to_device({k: batch[k] for k in ("input_ids", "attention_mask", "labels",
                                               "features", "offsets")}, self.device)
        raw = batch.get("raw") or {}
        if raw and ("visual_encoder" in self.frozen or "acoustic_encoder" in self.frozen):
            from affectgpt_tpu_torch.inference.chat import encode_media_features

            with torch.no_grad():
                out["features"].update(encode_media_features(
                    self.frozen, self.model_cfg, to_device(raw, self.device)))
        return out

    def _barrier(self) -> None:
        mesh_lib.barrier(self.layout)

    def _save(self, output_dir: str, epoch: int, **kwargs) -> None:
        """Rank 0 writes the checkpoint once every rank has reached it."""
        self._barrier()
        if self.is_main:
            checkpoint.save_checkpoint(output_dir, epoch, self.state.trainable, **kwargs)
        self._barrier()

    def validate(self) -> float:
        """The eval-mode loss over `val_iters` batches of the validation
        stream: each batch's loss over the target tokens of every rank."""
        losses = []
        with torch.no_grad():
            for _ in range(self.val_iters):
                batch = self._device_batch(next(self._val_loader))
                loss_sum, count = affectgpt.forward_loss(
                    self.frozen, self.state.trainable, self.model_cfg, batch, return_sum=True)
                totals = [loss_sum.detach().double(), count.double()]
                mesh_lib.all_reduce_sum(totals, self.layout)
                losses.append(float(totals[0] / totals[1].clamp_min(1)))
        return float(np.mean(losses))

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        metrics_log = MetricLogger()
        prefetcher = DevicePrefetcher(self.loader, put_fn=self._device_batch, device=self.device,
                                      limit=self.iters_per_epoch)
        waited = len(self.wait_ms)
        tic = time.time()
        try:
            for it in range(self.iters_per_epoch):
                t0 = time.perf_counter()
                batch = next(prefetcher)
                t1 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, self.frozen, batch)
                step = epoch * self.iters_per_epoch + it
                if it % self.log_freq == 0 or it == self.iters_per_epoch - 1:
                    lr = self.schedule(step)
                    loss = float(metrics["loss"])  # the host waits for the step here
                    metrics_log.update(loss=loss, lr=lr)
                    self.visualizer.record(loss=loss, lr=lr)
                    if self.tb is not None:
                        self.tb.add_scalar("train/loss", loss, step)
                        self.tb.add_scalar("train/lr", lr, step)
                    logger.info("epoch %d iter %d/%d loss %.4f lr %.2e",
                                epoch, it, self.iters_per_epoch, loss, lr)
                self.iteration_ms.append((time.perf_counter() - t0) * 1e3)
                self.wait_ms.append((t1 - t0) * 1e3)
        finally:
            prefetcher.close()
        stats = metrics_log.to_dict()
        stats["epoch_time_s"] = time.time() - tic
        stats["data_wait_s"] = sum(self.wait_ms[waited:]) / 1e3
        return stats

    def train(self) -> None:
        if self.is_main:
            self.json_log.write({"config": self.cfg.to_dict()})
        # epoch-0 zero-shot checkpoint before training (runner_base.py:396)
        if self.start_epoch == 0:
            self._save(self.output_dir, 0, step=0, config=self.cfg.to_dict())
        # set run.profile_dir to trace the first epoch (torch.profiler)
        profile_dir = self.cfg.run.get("profile_dir")
        for epoch in range(self.start_epoch, self.max_epoch):
            if profile_dir and epoch == self.start_epoch:
                from affectgpt_tpu_torch.utils.logging import profile_trace

                with profile_trace(profile_dir, rank=self.layout.rank):
                    stats = self.train_epoch(epoch)
            else:
                stats = self.train_epoch(epoch)
            if self._val_loader is not None:
                stats["val_loss"] = self.validate()
                if stats["val_loss"] < self.best_val:
                    self.best_val = stats["val_loss"]
                    self._save(self.output_dir + "/best", epoch + 1, loss=stats["val_loss"],
                               config=self.cfg.to_dict())
                    logger.info("new best val_loss %.4f at epoch %d", self.best_val, epoch)
            if self.is_main:
                self.json_log.write({"epoch": epoch, **stats})
                self.visualizer.plot_and_save(epoch)
            self._save(self.output_dir, epoch + 1, opt_state=self.state.opt_state,
                       step=int(self.state.step), loss=stats.get("loss"),
                       config=self.cfg.to_dict(),
                       # carried so a resumed run does not declare a worse
                       # post-crash val_loss a new best
                       best_val=self.best_val)
        logger.info("Training complete: %d epochs in %s", self.max_epoch, self.output_dir)
