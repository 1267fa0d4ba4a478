"""Worker of the 2-process gloo test of the port (tests/test_torch_ddp.py).

Each process joins a gloo group at a localhost address, takes its half of
a fixed global batch whose halves hold different numbers of target tokens,
runs two data-parallel training steps (`train_step.make_train_step(layout=)`),
then a `Runner` for one epoch of two iterations on the synthetic corpus,
counting the checkpoints it writes; it saves what it saw for the parent
test. Imports neither jax nor the JAX package.

Run (by the test):
  python tests/torch_ddp_worker.py <address> <world> <rank> <out_dir> <paths.json>
"""

import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tests.torch_ddp_case import STEPS, build, global_batch, rank_share  # noqa: E402


def main():
    address, world, rank, out_dir, paths_json = sys.argv[1:6]
    world, rank, out = int(world), int(rank), Path(out_dir)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=address, world_size=world, rank=rank)

    from affectgpt_tpu_torch import paths
    from affectgpt_tpu_torch.config import Config
    from affectgpt_tpu_torch.parallel import mesh
    from affectgpt_tpu_torch.training import checkpoint, runner, train_step
    from affectgpt_tpu_torch.utils.logging import MetricLogger

    layout = mesh.create_layout(device="cpu")
    assert (layout.world_size, layout.rank) == (world, rank)
    cfg, frozen, state, tx = build()
    state = train_step.shard_state(layout, state)
    step = train_step.make_train_step(cfg, tx, layout=layout)
    batch = rank_share(global_batch(cfg), rank, world)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, frozen, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    torch.save({"losses": losses, "grad_norms": norms, "trainable": state.trainable},
               out / f"step_rank{rank}.pt")

    meters = MetricLogger()
    meters.update(loss=float(rank + 1))
    meters.synchronize_between_processes()

    paths.update_from_dict(json.loads(Path(paths_json).read_text()))
    saves = []
    save = checkpoint.save_checkpoint
    checkpoint.save_checkpoint = lambda *a, **k: saves.append(a[1]) or save(*a, **k)
    raw = json.loads((out / "runner_cfg.json").read_text())
    run_cfg = Config.from_dict(raw, name="tiny_exp")
    from affectgpt_tpu_torch import bootstrap

    model_cfg, frozen, trainable, tok = bootstrap.build_model(run_cfg.model.to_dict(),
                                                              device="cpu", dtype=torch.float32)
    datasets, ratios = runner.build_datasets(run_cfg, tok, model_cfg, device="cpu")
    r = runner.Runner(run_cfg, tok, frozen, trainable, model_cfg, datasets, ratios, job_id="ddp",
                      device="cpu")
    r.train()
    (out / f"rank{rank}.json").write_text(json.dumps({
        "saves": saves, "json_log": r.json_log is not None,
        "meter_count": meters.meters["loss"].count, "meter_total": meters.meters["loss"].total,
        "step": int(r.state.step)}))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
