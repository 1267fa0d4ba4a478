"""LoRA SFT of the AU Agent on AU→description instruction data.

    python -m affectgpt_tpu_torch.au_agent_finetune.train_au_agent \
        --data au_instruction_dataset.json [--lora-r 64 --epochs 3 --batch-size 8 \
        --lr 1e-4] [--device cuda|cpu]

Port of the repo's root au_agent_finetune/train_au_agent.py (reference:
au_agent_finetune/train_au_agent.sh:79-110 + au_agent_lora_config.yaml:
Qwen2.5-7B, LoRA rank 64 / α 128, dropout 0.05, chat-template SFT),
trained inside the port: the LLM from `bootstrap.build_model` (its HF
directory, or drawn from a seed without one) frozen, an f32 LoRA from
`qwen2.init_lora`, `qwen2.forward(lora=, dropout_rng=)` and
`qwen2.cross_entropy_loss` under autograd, `training/optim.py`'s AdamW
(linear warmup + cosine, no weight decay, clip 1.0), one torch-format
checkpoint an epoch (`training/checkpoint.py`). Where JAX jits one step,
the port runs a plain step; the LoRA dropout masks are the port's own
(keyed by (seed, step)), not JAX's PRNG bits. The run goes to `--device`,
the card by default (no fallback to the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import random

import numpy as np
import torch

from affectgpt_tpu_torch import constants
from affectgpt_tpu_torch.bootstrap import build_model
from affectgpt_tpu_torch.inference_hybird import resolve_device
from affectgpt_tpu_torch.models import qwen2
from affectgpt_tpu_torch.models.au_agent import build_chat_prompt
from affectgpt_tpu_torch.training import checkpoint, optim
from affectgpt_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)


def build_batch(tokenizer, records, max_length: int):
    ids = np.full((len(records), max_length), tokenizer.pad_token_id, np.int32)
    labels = np.full((len(records), max_length), constants.IGNORE_INDEX, np.int32)
    mask = np.zeros((len(records), max_length), np.float32)
    for i, rec in enumerate(records):
        prompt = build_chat_prompt(rec["user"])
        p_ids = [tokenizer.bos_token_id] + tokenizer.encode(prompt)
        t_ids = tokenizer.encode(rec["assistant"]) + [tokenizer.eos_token_id]
        seq = (p_ids + t_ids)[:max_length]
        ids[i, : len(seq)] = seq
        mask[i, : len(seq)] = 1.0
        t_start = min(len(p_ids), max_length)
        labels[i, t_start : len(seq)] = seq[t_start:]
    return ids, labels, mask


def make_step(frozen_llm: dict, llm_cfg: qwen2.QwenConfig, tx: optim.AdamW):
    """step(lora, opt_state, ids, labels, mask, dropout_rng) -> (opt_state,
    loss): one AdamW update of the LoRA leaves in place; the loss stays a
    device scalar."""

    def step(lora, opt_state, ids, labels, mask, dropout_rng):
        leaves = optim.tree_leaves(lora)
        for leaf in leaves:
            leaf.requires_grad_(True)
        embeds = qwen2.embed_tokens(frozen_llm, ids)
        logits, _ = qwen2.forward(frozen_llm, llm_cfg, embeds, mask, lora=lora,
                                  dropout_rng=dropout_rng)
        loss = qwen2.cross_entropy_loss(logits, labels)
        grads = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        opt_state = tx.apply(optim.tree_unflatten(lora, list(grads)), opt_state, lora)
        return opt_state, loss.detach()

    return step


def main(argv=None) -> dict:
    """Returns {"losses": one float a step, "checkpoints": the directories
    written, "lora": the trained LoRA tree}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", required=True)
    parser.add_argument("--lora-r", type=int, default=64)
    parser.add_argument("--lora-alpha", type=float, default=128.0)
    # reference recipe trains with lora_dropout 0.05
    # (au_agent_finetune/train_au_agent.sh:91, au_agent_lora_config.yaml:12)
    parser.add_argument("--lora-dropout", type=float, default=0.05)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--max-length", type=int, default=512)
    parser.add_argument("--output-dir", default="output/au_agent")
    parser.add_argument("--seed", type=int, default=42)
    # registry model key — "tiny" exercises the full recipe at test geometry
    parser.add_argument("--llama-model", default="Qwen25")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    setup_logger()
    device = resolve_device(args.device)

    with open(args.data) as handle:
        records = json.load(handle)
    logger.info("loaded %d SFT records", len(records))

    model_cfg, frozen, _, tokenizer = build_model(
        {"llama_model": args.llama_model, "lora_r": args.lora_r}, device=device)
    llm_cfg = dataclasses.replace(model_cfg.llm, lora_r=args.lora_r,
                                  lora_alpha=args.lora_alpha, lora_dropout=args.lora_dropout)
    lora = qwen2.init_lora(torch.Generator(device=device).manual_seed(args.seed), llm_cfg)

    steps_per_epoch = max(len(records) // args.batch_size, 1)
    schedule = optim.linear_warmup_cosine_lr(
        args.lr, args.lr / 10, warmup_steps=steps_per_epoch // 10,
        total_steps=args.epochs * steps_per_epoch,
    )
    tx = optim.make_optimizer(schedule, weight_decay=0.0, max_grad_norm=1.0)
    opt_state = tx.init(lora)
    step = make_step(frozen["llm"], llm_cfg, tx)

    rng = random.Random(args.seed)
    global_step = 0
    losses, ckpts = [], []
    for epoch in range(args.epochs):
        rng.shuffle(records)
        for it in range(steps_per_epoch):
            chunk = records[it * args.batch_size : (it + 1) * args.batch_size]
            ids, labels, mask = build_batch(tokenizer, chunk, args.max_length)
            to_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
            # dropout keys are (seed, step), as JAX folds the step into its key
            key = (args.seed, global_step) if args.lora_dropout > 0 else None
            opt_state, loss = step(lora, opt_state, to_dev(ids).long(), to_dev(labels).long(),
                                   to_dev(mask), key)
            losses.append(loss)
            global_step += 1
            if it % 20 == 0:
                logger.info("epoch %d it %d loss %.4f", epoch, it, float(loss))
        ckpts.append(checkpoint.save_checkpoint(args.output_dir, epoch + 1, {"lora": lora}))
    logger.info("AU agent LoRA saved under %s", args.output_dir)
    return {"losses": [float(v) for v in losses], "checkpoints": ckpts, "lora": lora}


if __name__ == "__main__":
    main()
