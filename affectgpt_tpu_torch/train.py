"""Training entry point of the PyTorch port.

    python -m affectgpt_tpu_torch.train --cfg-path <yaml> [--options a.b=c ...]
        [--multihost] [--device cuda|cpu]

Port of the repo's root train.py (reference: AffectGPT/train.py:31-86):
read the config, build the model (`bootstrap.build_model` on the `model:`
section), the datasets and the `Runner`, then train. One process drives
one card; for several, launch one process per card with torchrun and pass
`--multihost`, which joins the group that torchrun's environment describes
(NCCL on the card, gloo on the CPU):

    torchrun --nproc_per_node 4 -m affectgpt_tpu_torch.train --cfg-path <yaml> --multihost

`run.tp` lays the ranks out (dp, tp), tp ranks a row (JAX's mesh): with
`--options run.tp=2` the four ranks above train dp = 2 x tp = 2, each
loading its slice of the LLM (`bootstrap.build_model(layout=)`). On the CPU
(`--device cpu`) the ranks join a gloo group. The run goes to the card
unless `--device cpu` is given; there is no fallback to the CPU.
"""

from __future__ import annotations

import argparse
import datetime
import random

import numpy as np
import torch

from affectgpt_tpu_torch.bootstrap import build_model
from affectgpt_tpu_torch.config import Config
from affectgpt_tpu_torch.parallel import mesh
from affectgpt_tpu_torch.training.runner import Runner, build_datasets
from affectgpt_tpu_torch.utils.logging import setup_logger


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="AffectGPT training (PyTorch)")
    parser.add_argument("--cfg-path", required=True, help="path to configuration file.")
    parser.add_argument(
        "--options", nargs="+",
        help="overwrite params in the config, e.g. --options run.max_epoch=2 model.ckpt=aaa",
    )
    parser.add_argument("--multihost", action="store_true",
                        help="join the torch.distributed group of torchrun's environment")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default: one card per process) or cpu")
    return parser.parse_args(argv)


def setup_seeds(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def main(argv=None) -> None:
    args = parse_args(argv)
    setup_logger()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device cpu to run on the CPU")
    if args.multihost:
        import torch.distributed as dist

        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        if device.type == "cuda":
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)

    cfg = Config.from_file(args.cfg_path, options=args.options)
    setup_seeds(int(cfg.run.get("seed", 42)))
    # run.job_id overrides the timestamp (deterministic run directories for
    # scripted resume workflows; the default is the reference's now() job id)
    job_id = str(cfg.run.get("job_id") or datetime.datetime.now().strftime("%Y%m%d%H%M"))

    # the layout comes before the model: under tp each rank loads its slice
    layout = mesh.create_layout(device=device, tp=int(cfg.run.get("tp", 1)))
    model_cfg, frozen, trainable, tokenizer = build_model(
        cfg.model.to_dict(), with_encoders=not cfg.model.get("skip_encoders", False),
        device=device, layout=layout if layout.tp > 1 else None)
    datasets, ratios = build_datasets(cfg, tokenizer, model_cfg, device=device)
    runner = Runner(cfg, tokenizer, frozen, trainable, model_cfg, datasets, ratios,
                    layout=layout, job_id=job_id, device=device)
    try:
        runner.train()
    finally:
        if args.multihost:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
