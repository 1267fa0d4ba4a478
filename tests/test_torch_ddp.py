"""The port's data-parallel training on two gloo processes against one
process on the same global batch.

Two workers (tests/torch_ddp_worker.py) each take half of a global batch
whose halves hold 24 and 6 target tokens, and run two steps of
`train_step.make_train_step(layout=)`: the loss and the updated trainable equal
the single-process step's on the whole batch within TOL, and the two ranks
hold the same bits. Then each runs a `Runner` epoch on the synthetic
corpus: rank 0 alone writes checkpoints and log.txt, and the meters sum
over the ranks. Each worker has its own timeout of WORKER_TIMEOUT s.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from affectgpt_tpu_torch.training import optim, train_step
from tests.synth_corpus import build_corpus
from tests.test_torch_runner import raw_cfg
from tests.torch_ddp_case import STEPS, build, global_batch

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-6, atol=1e-6)
WORKER_TIMEOUT = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def single_process():
    cfg, frozen, state, tx = build()
    step = train_step.make_train_step(cfg, tx)
    batch = global_batch(cfg)
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, frozen, batch)
        losses.append(float(metrics["loss"]))
    return losses, state.trainable


def test_two_gloo_ranks_match_one_process(tmp_path):
    overrides, feat_root = build_corpus(tmp_path / "corpus")
    paths_json = tmp_path / "paths.json"
    paths_json.write_text(json.dumps(overrides))
    raw = raw_cfg(tmp_path / "output", feat_root, max_epoch=1, iters_per_epoch=2,
                  evaluate=False, warmup_steps=0)
    (tmp_path / "runner_cfg.json").write_text(json.dumps(raw))
    address = f"tcp://localhost:{free_port()}"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_ddp_worker.py"),
                               address, "2", str(rank), str(tmp_path), str(paths_json)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=WORKER_TIMEOUT)[0])
    finally:
        for proc in procs:
            proc.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outputs)

    want_losses, want_trainable = single_process()
    ranks = [torch.load(tmp_path / f"step_rank{r}.pt", weights_only=True) for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want_losses, **TOL)
        for g, w in zip(optim.tree_leaves(got["trainable"]), optim.tree_leaves(want_trainable)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(ranks[0]["trainable"]),
                                                 optim.tree_leaves(ranks[1]["trainable"])))

    info = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert info[0]["saves"] == [0, 1] and info[1]["saves"] == []
    assert info[0]["json_log"] and not info[1]["json_log"]
    assert [(i["meter_count"], i["meter_total"]) for i in info] == [(2, 3.0), (2, 3.0)]
    assert [i["step"] for i in info] == [2, 2]
    run_dir = tmp_path / "output" / "tiny_exp" / "ddp"
    assert sorted(p.name.split("_")[1] for p in run_dir.glob("checkpoint_*")) == ["000000",
                                                                                  "000001"]
    assert len((run_dir / "log.txt").read_text().splitlines()) == 2
