"""The model, optimizer and global batch shared by the port's 2-process
gloo test and its worker (tests/test_torch_ddp.py, tests/torch_ddp_worker.py):
f32, tiny geometry, LoRA B drawn from a seed so every factor gets a
gradient, LoRA dropout off; a global batch of 4 rows whose first two hold
12 target tokens each and last two 3 each, so the ranks' token counts
differ."""

import dataclasses

import numpy as np
import torch

from affectgpt_tpu_torch.models import affectgpt
from affectgpt_tpu_torch.training import optim, train_step

B, T, STEPS = 4, 24, 2
LABELS = (12, 12, 3, 3)
OFFSETS = {"multi": 1, "audio": 3, "face": 6, "frame": 9}


def build():
    """(cfg, frozen, state, tx): the same on every rank."""
    cfg = affectgpt.AffectGPTConfig.tiny()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, lora_dropout=0.0))
    frozen = affectgpt.init_frozen(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    g = torch.Generator().manual_seed(1)
    trainable = affectgpt.init_trainable(g, cfg)
    for layer in trainable["lora"]["layers"]:
        for leaf in layer.values():
            leaf["b"].normal_(0.0, 0.05, generator=g)
    schedule = optim.linear_warmup_cosine_lr(1e-3, 1e-5, warmup_steps=1, total_steps=10)
    tx = optim.make_optimizer(schedule, max_grad_norm=1.0)
    return cfg, frozen, train_step.create_train_state(trainable, tx), tx


def global_batch(cfg):
    rng = np.random.RandomState(0)
    ids = rng.randint(1, cfg.llm.vocab_size, (B, T)).astype(np.int64)
    labels = np.full_like(ids, -100)
    for i, n in enumerate(LABELS):
        labels[i, T - n:] = ids[i, T - n:]
    for m, off in OFFSETS.items():
        ids[:, off:off + cfg.num_query_tokens(m)] = 0
    dims = {"frame": cfg.visual_dim, "face": cfg.visual_dim, "audio": cfg.acoustic_dim}
    return {
        "input_ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels),
        "attention_mask": torch.ones((B, T)),
        "features": {m: torch.from_numpy(rng.randn(B, 8, d).astype(np.float32))
                     for m, d in dims.items()},
        "offsets": {m: torch.full((B,), off) for m, off in OFFSETS.items()},
    }


def rank_share(batch, rank: int, world: int):
    """Rows [rank · B / world, (rank + 1) · B / world) of every leaf."""
    n = B // world
    return optim.tree_map(lambda t: t[rank * n:(rank + 1) * n], batch)
