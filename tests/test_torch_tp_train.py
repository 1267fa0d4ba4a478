"""Tensor-parallel training of the port against the JAX package and against
the port at tp = 1, in f32 on the CPU.

- Ranks: tests/torch_tp_train_worker.py on gloo processes, all started
  together, each with its own timeout of WORKER_TIMEOUT s. The model is
  JAX's tests/test_train_multichip.py tiny AffectGPT (2 layers, hidden 32,
  4 q / 2 kv heads, vocab 300) with LoRA B drawn from a seed, converted by
  `convert.from_jax`, and its b = 8, t = 32 batch. At tp = 2, tp = 4 (the 2
  kv heads held by pairs of ranks) and dp 2 x tp 2, dropout off: the first
  step's loss and gradients and three steps' losses and updated trainable
  leaves equal JAX's `compile_train_step` on a (1, 2) and (2, 2) virtual
  CPU mesh and JAX's single-device step within TOL (relative L2 a leaf).
  The ranks' trees stay bit-identical (`check_replicas`). With LoRA dropout
  on, tp = 2 and 4 give tp = 1's loss and gradients at the same key, under
  remat False, True and "dots" and with `qwen2.DROPOUT_VJP`.
- The entry point: `python -m affectgpt_tpu_torch.train --device cpu
  --multihost` with `run.tp=2` (two gloo ranks, torchrun's environment)
  beside a tp = 1 run on the synthetic corpus, 2 epochs, LoRA dropout on:
  every checkpoint within TOL of tp = 1's, each rank trained on the
  loader's own stream of batches in both epochs, and a checkpoint of
  either run resumes under the other to the same next checkpoint.
- Without processes (the tp ranks as threads of this process, the
  collectives of `parallel.mesh` exchanged through memory): the
  vocabulary-parallel `fused_cross_entropy_loss` gives the whole-vocab loss
  and gradient of hidden at tp = 2 and 4, with labels on the shards' edges
  and -100s, as does the plain loss over `_logits`' gathered logits (the
  quantized lm_head's route); f, g and the gather give their stated
  gradients, and `torch.autograd.gradcheck` in doubles holds the products
  they surround.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from affectgpt_tpu.models import affectgpt as ja
from affectgpt_tpu.parallel import mesh as jmesh
from affectgpt_tpu.training import optim as joptim
from affectgpt_tpu.training import train_step as jstep
from affectgpt_tpu_torch import bootstrap as tbootstrap
from affectgpt_tpu_torch import config as tconfig
from affectgpt_tpu_torch.models import affectgpt as ta
from affectgpt_tpu_torch.models import convert
from affectgpt_tpu_torch.models import qwen2 as tq
from affectgpt_tpu_torch.parallel import mesh
from affectgpt_tpu_torch.training import checkpoint, optim, train_step
from affectgpt_tpu_torch.training import runner as trunner
from tests.synth_corpus import build_corpus
from tests.test_torch_runner import raw_cfg
from tests.test_train_multichip import make_batch

REPO = Path(__file__).resolve().parent.parent
WORKER = str(REPO / "tests" / "torch_tp_train_worker.py")
WORKER_TIMEOUT = 180
TOL = 1e-5  # relative L2 of each leaf (and of each loss) against its reference
STEPS = 3
SCHEDULE = (1e-3, 1e-5, 2, 10)  # linear_warmup_cosine_lr(init, min, warmup, total)
KEY = (42, 0)  # the dropout key of the first step
CASES = {"tp2": 2, "tp4": 4, "dp2tp2": 4}
RUN = dict(max_epoch=2, iters_per_epoch=3, evaluate=True, val_iters=1, warmup_steps=1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / ref) if ref else float(np.abs(got).max(initial=0))


def assert_leaves_close(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    errs = [rel(g, w) for g, w in zip(got, want)]
    worst = int(np.argmax(errs))
    assert errs[worst] <= TOL, f"{what}: leaf {worst} off by {errs[worst]:.3g}"


# ---------------------------------------------------------------------------
# The model and the JAX references


@functools.lru_cache(maxsize=None)
def jax_model():
    """JAX's tiny AffectGPT with a LoRA B that gives every factor a gradient."""
    cfg = ja.AffectGPTConfig.tiny()
    frozen = ja.init_frozen(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    trainable = ja.init_trainable(jax.random.PRNGKey(1), cfg)
    rng = np.random.RandomState(2)
    trainable = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.05)
        if p[-1].key == "b" and p[0].key == "lora" else x, trainable)
    return cfg, frozen, trainable, make_batch(cfg)


def np_leaves(tree) -> list:
    return optim.tree_leaves(jax.tree.map(np.asarray, tree))


@functools.lru_cache(maxsize=None)
def jax_references():
    """{"single", "mesh12", "mesh22"}: (losses, final trainable leaves), and
    "grads": the first step's gradient leaves."""
    cfg, frozen, trainable, batch = jax_model()
    schedule = joptim.linear_warmup_cosine_lr(*SCHEDULE)
    tx = joptim.make_optimizer(schedule, max_grad_norm=1.0)
    grads = jax.grad(lambda tr: ja.forward_loss(frozen, tr, cfg, batch))(trainable)
    out = {"grads": np_leaves(grads)}
    runs = {"single": None, "mesh12": (1, 2), "mesh22": (2, 2)}
    for name, shape in runs.items():
        # each run its own copy: the mesh steps donate their state
        state = jstep.create_train_state(jax.tree.map(lambda x: jnp.array(x, copy=True),
                                                      trainable), tx)
        if shape is None:
            step, fro, bat = jax.jit(jstep.make_train_step(cfg, tx)), frozen, batch
        else:
            m = jmesh.create_mesh(jax.devices()[:shape[0] * shape[1]], tp=shape[1])
            state = jstep.shard_state(m, state)
            fro = jmesh.shard_params(m, frozen)
            bat = jax.device_put(batch, jax.tree.map(lambda _: jmesh.batch_sharding(m), batch))
            step = jstep.compile_train_step(m, cfg, tx, state, fro)
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, fro, bat)
            losses.append(float(metrics["loss"]))
        out[name] = (losses, np_leaves(state.trainable))
    return out


def worker_inputs() -> dict:
    cfg, frozen, trainable, batch = jax_model()
    tcfg = ta.AffectGPTConfig.tiny()
    tfrozen, ttrain = convert.from_jax(jax.tree.map(np.asarray, frozen),
                                       jax.tree.map(np.asarray, trainable), tcfg, device="cpu")
    tbatch = jax.tree.map(lambda x: torch.as_tensor(np.array(x)), batch)
    for key in ("input_ids", "labels"):
        tbatch[key] = tbatch[key].long()
    tbatch["offsets"] = {m: v.long() for m, v in tbatch["offsets"].items()}
    return {"cfg": tcfg, "frozen": tfrozen, "trainable": ttrain, "batch": tbatch, "key": KEY,
            "schedule": SCHEDULE}


# ---------------------------------------------------------------------------
# Processes


def launch(cmd: list, env: dict) -> tuple:
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, time.monotonic() + WORKER_TIMEOUT


def wait_all(procs: list) -> None:
    """Wait for every process within its own deadline; kill them all on the
    way out, and fail with the logs of any that did not end with 0."""
    logs = []
    try:
        for proc, deadline in procs:
            logs.append(proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for proc, _ in procs:
            proc.kill()
    assert all(p.returncode == 0 for p, _ in procs), "\n".join(log[-3000:] for log in logs)


def base_env() -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def parity_procs(out: Path) -> list:
    procs = []
    for case, world in CASES.items():
        address = f"tcp://localhost:{free_port()}"
        procs += [launch([sys.executable, WORKER, address, str(world), str(rank), case,
                          str(out)], base_env())
                  for rank in range(world)]
    return procs


def entry_procs(job: str, world: int, cfg_path: str, out: Path, options: list) -> list:
    """`python -m affectgpt_tpu_torch.train` on `world` ranks (one without
    --multihost), through the worker's f32 bootstrap."""
    names = out / job
    names.mkdir()
    argv = ["--cfg-path", cfg_path, "--device", "cpu", "--options", f"run.job_id={job}",
            f"run.tp={world}", *options]
    if world == 1:
        return [launch([sys.executable, WORKER, "train", str(names), *argv], base_env())]
    port = str(free_port())
    return [launch([sys.executable, WORKER, "train", str(names), *argv, "--multihost"],
                   {**base_env(), "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
                    "MASTER_ADDR": "localhost", "MASTER_PORT": port})
            for r in range(world)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus, the tiny experiment's YAML (LoRA dropout on)
    and the loader's own first batches (a tp = 1 Runner's)."""
    import yaml

    tmp = tmp_path_factory.mktemp("tp_train_corpus")
    overrides, feat_root = build_corpus(tmp)
    raw = raw_cfg(tmp / "output", feat_root, **RUN)
    raw["model"]["lora_dropout"] = 0.1
    raw["paths"] = overrides
    cfg_path = tmp / "tiny_exp.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    return tmp, str(cfg_path)


def loader_stream(cfg_path: str, n: int) -> list:
    """The names of the first n batches of the loader a tp = 1 Runner of
    the experiment builds."""
    from affectgpt_tpu_torch import paths as tpaths

    saved = {k: dict(v) for k, v in tpaths.TABLES.items()}
    try:
        cfg = tconfig.Config.from_file(cfg_path)
        model_cfg, frozen, trainable, tok = tbootstrap.build_model(cfg.model.to_dict(),
                                                                   device="cpu")
        datasets, ratios = trunner.build_datasets(cfg, tok, model_cfg, device="cpu")
        r = trunner.Runner(cfg, tok, frozen, trainable, model_cfg, datasets, ratios,
                           job_id="stream", device="cpu")
        return [list(next(r.loader)["names"]) for _ in range(n)]
    finally:
        for k, v in saved.items():
            tpaths.TABLES[k].clear()
            tpaths.TABLES[k].update(v)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, corpus):
    """Every process of the file: the parity cases and the two entry-point
    runs start together; the cross resumes follow. Returns the ranks'
    results, the runs' output directory and the names files' directory."""
    tmp, cfg_path = corpus
    out = tmp_path_factory.mktemp("tp_train")
    torch.save(worker_inputs(), out / "inputs.pt")
    procs = parity_procs(out)
    procs += entry_procs("tp2", 2, cfg_path, out, ["run.check_tp_replicas=true"])
    procs += entry_procs("tp1", 1, cfg_path, out, [])
    jax_references()  # JAX compiles while the ranks run
    wait_all(procs)
    runs = tmp / "output" / "tiny_exp"
    ck = {job: dict(checkpoint.list_checkpoints(str(runs / job))) for job in ("tp1", "tp2")}
    procs = entry_procs("tp1_from_tp2", 1, cfg_path, out,
                        [f"run.resume_ckpt_path={ck['tp2'][1]}"])
    procs += entry_procs("tp2_from_tp1", 2, cfg_path, out,
                         [f"run.resume_ckpt_path={ck['tp1'][1]}", "run.check_tp_replicas=true"])
    wait_all(procs)
    results = {case: [torch.load(out / f"{case}_rank{r}.pt", weights_only=False)
                      for r in range(world)] for case, world in CASES.items()}
    return results, runs, out


# ---------------------------------------------------------------------------
# The step against JAX


@pytest.mark.parametrize("case", list(CASES))
def test_first_step_gradients_match_jax(ranks, case):
    want = jax_references()["grads"]
    for r in ranks[0][case]:
        loss, grads = r["first"]
        assert rel(float(loss), jax_references()["single"][0][0]) <= TOL
        assert_leaves_close([g.numpy() for g in grads], want, f"{case} rank {r['rank']}")


@pytest.mark.parametrize("case,reference", [("tp2", "mesh12"), ("tp2", "single"),
                                            ("tp4", "single"), ("dp2tp2", "mesh22"),
                                            ("dp2tp2", "single")])
def test_three_steps_match_jax(ranks, case, reference):
    losses, leaves = jax_references()[reference]
    for r in ranks[0][case]:
        assert max(rel(a, b) for a, b in zip(r["losses"], losses)) <= TOL, (r["losses"], losses)
        assert_leaves_close([t.numpy() for t in optim.tree_leaves(r["trainable"])], leaves,
                            f"{case} rank {r['rank']} against JAX {reference}")


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_identical_trees(ranks, case):
    first = ranks[0][case][0]
    for r in ranks[0][case][1:]:
        assert r["losses"] == first["losses"] and r["grad_norms"] == first["grad_norms"]
        assert all(torch.equal(a, b) for a, b in zip(optim.tree_leaves(r["trainable"]),
                                                     optim.tree_leaves(first["trainable"])))


# ---------------------------------------------------------------------------
# Dropout and remat against the port at tp = 1


@functools.lru_cache(maxsize=None)
def port_tp1_dropout():
    inputs = worker_inputs()
    return train_step.loss_and_grads(inputs["cfg"], inputs["frozen"], inputs["trainable"],
                                     inputs["batch"], key=KEY)


@pytest.mark.parametrize("route", ["drop", "drop_remat", "drop_dots", "drop_vjp"])
@pytest.mark.parametrize("case", ["tp2", "tp4"])
def test_dropout_and_remat_under_tp_give_tp1(ranks, case, route):
    want_loss, want = port_tp1_dropout()
    _, off = ranks[0][case][0]["first"]
    # the masks moved the gradients far beyond TOL
    assert max(rel(a.numpy(), b.numpy()) for a, b in zip(want, off)) > 1e-2
    for r in ranks[0][case]:
        loss, grads = r[route]
        assert rel(float(loss), float(want_loss)) <= TOL
        assert_leaves_close([g.numpy() for g in grads], [g.numpy() for g in want],
                            f"{case} {route} rank {r['rank']}")


# ---------------------------------------------------------------------------
# The entry point


def leaves_of(path: str) -> list:
    return [t.numpy() for t in optim.tree_leaves(checkpoint.load_checkpoint(path)["trainable"])]


def test_entry_point_tp2_checkpoints_match_tp1(ranks):
    _, runs, _ = ranks
    tp1 = dict(checkpoint.list_checkpoints(str(runs / "tp1")))
    tp2 = dict(checkpoint.list_checkpoints(str(runs / "tp2")))
    assert sorted(tp1) == sorted(tp2) == [0, 1, 2]
    for epoch in tp1:
        assert_leaves_close(leaves_of(tp2[epoch]), leaves_of(tp1[epoch]), f"epoch {epoch}")
    for path in (tp1[2], tp2[2]):
        payload = checkpoint.load_checkpoint(path)
        assert payload["step"] == 6 and payload["opt_state"]["count"] == 6
    logs = [[json.loads(x) for x in (runs / job / "log.txt").read_text().splitlines()[1:]]
            for job in ("tp1", "tp2")]
    for a, b in zip(*logs):
        assert rel(a["loss"], b["loss"]) <= TOL and rel(a["val_loss"], b["val_loss"]) <= TOL


def test_entry_point_ranks_train_on_the_loaders_stream(ranks, corpus):
    _, _, out = ranks
    want = loader_stream(corpus[1], 2 * RUN["iters_per_epoch"])
    got = {f"{job} rank {r}": json.loads((out / job / f"names_rank{r}.json").read_text())
           for job, world in (("tp1", 1), ("tp2", 2)) for r in range(world)}
    for name, names in got.items():
        assert names == want, name


def test_checkpoints_resume_across_tp(ranks):
    _, runs, _ = ranks
    a = dict(checkpoint.list_checkpoints(str(runs / "tp1_from_tp2")))
    b = dict(checkpoint.list_checkpoints(str(runs / "tp2_from_tp1")))
    assert sorted(a) == sorted(b) == [2]  # resumed at epoch 1: no zero-shot checkpoint
    assert_leaves_close(leaves_of(a[2]), leaves_of(b[2]), "the resumed runs' epoch 2")
    for path in (a[2], b[2]):
        assert checkpoint.load_checkpoint(path)["step"] == 6


# ---------------------------------------------------------------------------
# Without processes: tp ranks as threads


class ThreadGroup:
    """A tp group of threads: each collective hands every rank's tensor to
    every rank through memory, between two barriers."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n
        self.local = threading.local()

    def exchange(self, t: torch.Tensor) -> list:
        self.slots[self.local.rank] = t.detach().clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts


class ThreadDist:
    """The `torch.distributed` calls of `parallel.mesh` over a ThreadGroup."""

    ReduceOp = dist.ReduceOp

    @staticmethod
    def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
        stacked = torch.stack(group.exchange(t))
        t.copy_(stacked.amax(0) if op == dist.ReduceOp.MAX else stacked.sum(0))

    @staticmethod
    def all_gather(parts, t, group=None):
        for dst, src in zip(parts, group.exchange(t)):
            dst.copy_(src)

    @staticmethod
    def broadcast(t, src=0, group=None):
        t.copy_(group.exchange(t)[src])


def on_threads(monkeypatch, tp: int, fn) -> list:
    """fn(layout) on tp threads, one tp rank each; their results in rank order."""
    monkeypatch.setattr(mesh, "dist", ThreadDist)
    group = ThreadGroup(tp)
    results, errors = [None] * tp, []

    def run(r):
        group.local.rank = r
        layout = mesh.Layout(world_size=tp, rank=r, device=torch.device("cpu"), tp=tp, dp=1,
                             tp_group=group)
        try:
            results[r] = fn(layout)
        except Exception as error:  # noqa: BLE001 — raised in the calling thread below
            errors.append(error)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    return results


def loss_case(tie: bool, tp: int):
    """A tiny LLM config, its lm_head (or tied table), hidden states and
    labels on every shard edge at tp = 2 and 4, with -100s."""
    cfg = dataclasses.replace(tq.QwenConfig.tiny(vocab_size=300), tie_embeddings=tie)
    rng = np.random.RandomState(5)
    params = {"embed_tokens": {"table": torch.as_tensor(rng.randn(300, 32).astype(np.float32))},
              "lm_head": {"w": torch.as_tensor(rng.randn(32, 300).astype(np.float32) * 0.2)}}
    hidden = torch.as_tensor(rng.randn(2, 9, 32).astype(np.float32))
    edges = [0, 74, 75, 149, 150, 224, 225, 299, -100, 76, 151, -100, 5, 298, 148, 226, 100, 200]
    labels = torch.as_tensor(edges, dtype=torch.long).reshape(2, 9)
    return cfg, params, hidden, labels


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_loss_equals_whole_vocab(monkeypatch, tp, tie):
    cfg, params, hidden, labels = loss_case(tie, tp)
    want_h = hidden.clone().requires_grad_(True)
    want = tq.fused_cross_entropy_loss(want_h, params, cfg, labels, chunk=32)
    want.backward()
    logits = torch.matmul(hidden, params["embed_tokens"]["table"].T if tie
                          else params["lm_head"]["w"])
    torch.testing.assert_close(tq.cross_entropy_loss(logits, labels), want.detach())

    def rank(layout):
        shard = mesh.shard_params({"lm_head": params["lm_head"]}, layout, cfg)
        scfg = mesh.shard_config(cfg, layout)
        h = hidden.clone().requires_grad_(True)
        loss_sum, count = tq.fused_cross_entropy_loss(
            h, {**params, **shard}, scfg, labels, chunk=32, return_sum=True)
        (loss_sum / count).backward()
        return float((loss_sum / count).detach()), h.grad

    for loss, grad in on_threads(monkeypatch, tp, rank):
        assert rel(loss, float(want.detach())) <= 1e-6
        assert rel(grad.numpy(), want_h.grad.numpy()) <= 1e-6


@pytest.mark.parametrize("tp", [2, 4])
def test_gathered_logits_loss_equals_whole_vocab(monkeypatch, tp):
    """The plain loss over `_logits`' gathered vocabulary-parallel logits
    (the quantized lm_head's route) and its gradient of hidden, on every
    rank, equal the whole lm_head's."""
    cfg, params, hidden, labels = loss_case(False, tp)
    want_h = hidden.clone().requires_grad_(True)
    want = tq.cross_entropy_loss(tq._logits(params, cfg, want_h), labels)
    want.backward()

    def rank(layout):
        shard = mesh.shard_params({"lm_head": params["lm_head"]}, layout, cfg)
        h = hidden.clone().requires_grad_(True)
        loss = tq.cross_entropy_loss(tq._logits(shard, mesh.shard_config(cfg, layout), h), labels)
        loss.backward()
        return float(loss.detach()), h.grad

    for loss, grad in on_threads(monkeypatch, tp, rank):
        assert rel(loss, float(want.detach())) <= 1e-6
        assert rel(grad.numpy(), want_h.grad.numpy()) <= 1e-6


def test_f_g_and_gather_give_their_stated_gradients(monkeypatch):
    tp = 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, dtype=torch.float64, generator=g)
    grads_out = [torch.randn(3, 8, dtype=torch.float64, generator=g) for _ in range(tp)]
    partials = [torch.randn(3, 8, dtype=torch.float64, generator=g) for _ in range(tp)]

    def rank(layout):
        r = layout.tp_rank
        xf = x.clone().requires_grad_(True)
        mesh.copy_to_tp(xf, layout).backward(grads_out[r])
        p = partials[r].clone().requires_grad_(True)
        summed = mesh.reduce_from_tp(p, layout)
        summed.backward(grads_out[0])
        q = partials[r].clone().requires_grad_(True)
        gathered = mesh.gather_from_tp(q, layout)
        gathered.backward(torch.cat(grads_out, dim=-1))
        return xf.grad, summed.detach(), p.grad, gathered.detach(), q.grad

    for r, (fx, summed, gp, gathered, gq) in enumerate(on_threads(monkeypatch, tp, rank)):
        torch.testing.assert_close(fx, sum(grads_out))  # f: the ranks' gradients summed
        torch.testing.assert_close(summed, sum(partials))  # g: the partials summed ...
        torch.testing.assert_close(gp, grads_out[0])  # ... and the gradient passed through
        torch.testing.assert_close(gathered, torch.cat(partials, dim=-1))
        torch.testing.assert_close(gq, grads_out[r])  # the gather: the rank's slice


@pytest.mark.parametrize("tp", [2, 4])
def test_gradcheck_column_row_and_gathered_products(monkeypatch, tp):
    """The whole program as a function of the replicated x: tanh(f(x) @
    W1[:, cols]) @ W2[rows] summed by g, and f(x) @ U[:, cols] gathered.
    Every rank perturbs x alike, so gradcheck's finite differences are the
    whole program's; the analytic side runs f's, g's and the gather's
    backward."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 6, dtype=torch.float64, generator=g)
    w1 = torch.randn(6, 4 * tp, dtype=torch.float64, generator=g)
    w2 = torch.randn(4 * tp, 5, dtype=torch.float64, generator=g)
    u = torch.randn(6, 2 * tp, dtype=torch.float64, generator=g)

    def rank(layout):
        r = layout.tp_rank
        cols, half = slice(4 * r, 4 * r + 4), slice(2 * r, 2 * r + 2)

        def mlp(xv):
            return mesh.reduce_from_tp(torch.tanh(mesh.copy_to_tp(xv, layout) @ w1[:, cols])
                                       @ w2[cols], layout)

        def logits(xv):
            return mesh.gather_from_tp(mesh.copy_to_tp(xv, layout) @ u[:, half], layout)

        xr = x.clone().requires_grad_(True)
        checks = [torch.autograd.gradcheck(fn, (xr,)) for fn in (mlp, logits)]
        return checks, mlp(x).detach(), logits(x).detach()

    for checks, y, z in on_threads(monkeypatch, tp, rank):
        assert all(checks)
        torch.testing.assert_close(y, torch.tanh(x @ w1) @ w2)
        torch.testing.assert_close(z, x @ u)


def test_replica_check_catches_a_diverged_rank(monkeypatch):
    tree = {"lora": {"a": torch.ones(4, 2)}, "mergers": {"w": torch.zeros(3)}}

    def rank(layout):
        mine = optim.tree_map(torch.clone, tree)
        train_step.check_tp_replicas(mine, layout)  # identical: passes
        if layout.tp_rank == 1:
            mine["mergers"]["w"][2] = 1e-7
        try:
            train_step.check_tp_replicas(mine, layout)
        except RuntimeError as error:
            return str(error)
        return None

    results = on_threads(monkeypatch, 2, rank)
    assert results[0] is None and "1 of 11 elements" in results[1]
