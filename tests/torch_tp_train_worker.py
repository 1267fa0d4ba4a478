"""Worker of the tensor-parallel training tests of the port
(tests/test_torch_tp_train.py).

    python tests/torch_tp_train_worker.py <address> <world> <rank> <case> <dir>

Each process joins a gloo group at a localhost address as one rank of a
(dp, tp) layout, reads what the parent test saved (the port's trees of the
JAX weights, the global batch, the dropout key), shards the LLM
(`mesh.shard_llm`; the trainable tree stays whole) and saves what it got:
the first step's loss and gradients, then three steps of
`train_step.make_train_step(check_replicas=True)` (their losses, grad
norms and the updated trainable tree). Cases "tp2" and "tp4" (one dp rank)
also take the gradients with LoRA dropout on under every remat route and
with `qwen2.DROPOUT_VJP`; "dp2tp2" gives each dp rank its half of the
batch. In f32 on the CPU.

    python tests/torch_tp_train_worker.py train <out_dir> <argv ...>

runs `python -m affectgpt_tpu_torch.train <argv ...>` with an f32
bootstrap, recording the names of the batches each iteration trained on
(`<out_dir>/names_rank<RANK>.json`). Imports neither jax nor the JAX
package.
"""

import functools
import json
import os
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from affectgpt_tpu_torch import bootstrap  # noqa: E402
from affectgpt_tpu_torch import train as entry  # noqa: E402

STEPS = 3
TP = {"tp2": 2, "tp4": 4, "dp2tp2": 2}


def recording_prefetcher(cls, trained: list):
    """A DevicePrefetcher subclass that appends to `trained` the names of
    each batch it hands out: the k-th batch a prefetcher hands out is the
    k-th it drew, so its names are read where the worker draws them."""
    class Recording(cls):
        def __init__(self, loader, *args, **kwargs):
            self.names = []

            def drawn():
                while True:
                    batch = next(loader)
                    self.names.append(list(batch["names"]))
                    yield batch

            super().__init__(drawn(), *args, **kwargs)
            self.taken = 0

        def __next__(self):
            batch = super().__next__()
            trained.append(self.names[self.taken])
            self.taken += 1
            return batch

    return Recording


def run_entry(out_dir: str, argv: list) -> None:
    from affectgpt_tpu_torch.training import runner

    trained: list = []
    runner.DevicePrefetcher = recording_prefetcher(runner.DevicePrefetcher, trained)
    entry.build_model = functools.partial(bootstrap.build_model, dtype=torch.float32)
    entry.main(argv)
    rank = os.environ.get("RANK", "0")
    Path(out_dir, f"names_rank{rank}.json").write_text(json.dumps(trained))


def grads_case(inputs, layout, cfg, frozen, batch) -> dict:
    """Gradients with LoRA dropout on at the saved key under remat False,
    True and "dots", and with DROPOUT_VJP."""
    from affectgpt_tpu_torch.models import qwen2
    from affectgpt_tpu_torch.training import train_step

    out = {}
    for name, remat, vjp in (("drop", False, False), ("drop_remat", True, False),
                             ("drop_dots", "dots", False), ("drop_vjp", False, True)):
        qwen2.DROPOUT_VJP = vjp
        try:
            out[name] = train_step.loss_and_grads(cfg, frozen, inputs["trainable"], batch,
                                                  remat=remat, key=inputs["key"],
                                                  layout=layout)
        finally:
            qwen2.DROPOUT_VJP = False
    return out


def main():
    if sys.argv[1] == "train":
        run_entry(sys.argv[2], sys.argv[3:])
        return
    address, world, rank, case, out_dir = sys.argv[1:6]
    world, rank, out = int(world), int(rank), Path(out_dir)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=address, world_size=world, rank=rank)
    from affectgpt_tpu_torch.parallel import mesh
    from affectgpt_tpu_torch.training import optim, train_step

    inputs = torch.load(out / "inputs.pt", weights_only=False)
    layout = mesh.create_layout(device="cpu", tp=TP[case])
    frozen, cfg = mesh.shard_llm(inputs["frozen"], inputs["cfg"], layout)
    batch = optim.tree_map(lambda t: mesh.dp_share(t, layout), inputs["batch"])
    result = {"rank": rank, "tp_rank": layout.tp_rank, "dp_rank": layout.dp_rank,
              "first": train_step.loss_and_grads(cfg, frozen, inputs["trainable"], batch,
                                                 layout=layout)}
    if layout.dp == 1:
        result.update(grads_case(inputs, layout, cfg, frozen, batch))
    tx = optim.make_optimizer(optim.linear_warmup_cosine_lr(*inputs["schedule"]),
                              max_grad_norm=1.0)
    state = train_step.create_train_state(inputs["trainable"], tx)
    step = train_step.make_train_step(cfg, tx, layout=layout, check_replicas=True)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, frozen, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    result.update(losses=losses, grad_norms=norms, trainable=state.trainable)
    torch.save(result, out / f"{case}_rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
