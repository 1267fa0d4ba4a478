"""Batch inference over the MER-UniBench evaluation datasets, in PyTorch.

    python -m affectgpt_tpu_torch.inference_hybird --cfg-path <yaml|json>
        [--dataset merbench|<name>] [--options a.b=c ...] [--device cuda|cpu] ...

Port of the repo's root inference_hybird.py (reference:
AffectGPT/inference_hybird.py:132-343): checkpoint-root auto-discovery (the
run directory with the most checkpoints wins; the port's torch checkpoints),
epoch selection, a per-dataset loop with per-modality preextract switches,
`{save_root}/{epoch}.npz` results holding name2reason, and skip-if-exists
resume. Clips are answered in batches of `--batch_size` through one
prefill and decode (`Chat.answer_batch`), or streamed through the paged
continuous-batching engine with `--paged`; the next chunk's features load in
a worker thread while the current one decodes. Each epoch's LoRA is folded
into the serving weights unless `--no_merge_lora`, then `--fuse_qkv` and
`--int8` / `--int4` apply, in JAX's order.

The run goes to the card unless `--device cpu` is given; there is no
fallback to the CPU.

`--tp N` serves the LLM tensor-parallel over N ranks (JAX's 1 x N mesh,
inference_hybird.py:158-165), one process a rank: the ranks of `torchrun
--nproc_per_node N` when the environment names them, else N processes the
entry point spawns itself. On `--device cuda` the ranks talk over NCCL with
one rank a card (it asserts N cards, as JAX asserts N devices); on `--device
cpu` over gloo. Every rank builds its shard (`bootstrap.build_model(
layout=)`: a model directory is read a slice at a time), reads the same
datasets and answers the same clips in the same order; rank 0 alone writes
the results. `--fuse_qkv` is ignored under tp (the split layout shards), as
in JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import logging
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from affectgpt_tpu_torch import registry
from affectgpt_tpu_torch.bootstrap import build_model
from affectgpt_tpu_torch.config import Config
from affectgpt_tpu_torch.data.base_dataset import DatasetConfig, ModelDataConfig
from affectgpt_tpu_torch.data.datasets import get_dataset_class  # noqa: F401 (registers them)
from affectgpt_tpu_torch.inference.chat import Chat, encode_media_features
from affectgpt_tpu_torch.models import qwen2
from affectgpt_tpu_torch.parallel import mesh
from affectgpt_tpu_torch.training import checkpoint
from affectgpt_tpu_torch.utils.logging import setup_logger

logger = logging.getLogger(__name__)

MERBENCH_DATASETS = (
    "MER2023", "MER2024", "MELD", "IEMOCAPFour",
    "CMUMOSI", "CMUMOSEI", "SIMS", "SIMSv2", "OVMERDPlus",
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="AffectGPT batch inference (PyTorch)")
    parser.add_argument("--cfg-path", default=None)
    parser.add_argument("--options", nargs="+")
    parser.add_argument("--dataset", default="merbench")
    parser.add_argument("--zeroshot", action="store_true", default=False)
    parser.add_argument("--no_reasoning", action="store_true", default=False)
    parser.add_argument("--outside_user_message", default=None)
    parser.add_argument("--outside_face_or_frame", default=None)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--max_new_tokens", type=int, default=300)
    parser.add_argument("--ckpt_root", default=None,
                        help="run dir holding checkpoint_*; defaults to auto-discovery "
                             "under output/<cfg-name> (most checkpoints wins)")
    parser.add_argument("--epochs", default="last",
                        help="'last', 'all', a single epoch number, or 'a-b' range")
    parser.add_argument("--int8", action="store_true",
                        help="int8 serving mode (per-channel int8 decoder weights)")
    parser.add_argument("--int4", action="store_true",
                        help="int4 serving mode (group-128 int4 decoder weights)")
    parser.add_argument("--fuse_qkv", action="store_true",
                        help="concatenate qkv and gate/up into single serving matmuls "
                             "(dense engine only); off by default")
    parser.add_argument("--no_merge_lora", action="store_true",
                        help="keep LoRA adapters as a parallel branch instead of folding "
                             "them into the serving weights (merge is the default, and "
                             "quantization then sees the adapted weights)")
    parser.add_argument("--paged", action="store_true",
                        help="serve through the paged-KV continuous-batching engine "
                             "(device memory bounded by the tokens in flight)")
    parser.add_argument("--paged_block_size", type=int, default=16)
    parser.add_argument("--paged_num_blocks", type=int, default=2048)
    parser.add_argument("--fuse_mode", choices=["full", "qkv"], default="full",
                        help="with --fuse_qkv: concat qkv+gateup (full) or qkv only")
    parser.add_argument("--paged_slots", type=int, default=16,
                        help="concurrent sequences in the continuous-batching engine")
    parser.add_argument("--paged_prefill_chunk", type=int, default=0,
                        help="chunked prefill: cap each admission at N prompt tokens "
                             "(0 = off)")
    parser.add_argument("--paged_admission", choices=["reserve", "optimistic"],
                        default="reserve",
                        help="reserve: admission claims a request's full-lifetime block "
                             "budget; optimistic: prompt blocks only, with recompute "
                             "preemption of the youngest slot when the pool runs dry")
    parser.add_argument("--greedy", action="store_true", default=False,
                        help="greedy decoding (default: the reference's top-p 0.9 sampling)")
    parser.add_argument("--speculative", type=int, default=0, metavar="D",
                        help="EXPERIMENTAL: prompt-lookup speculative decoding with D draft "
                             "tokens per verify step (greedy-exact: the same tokens). "
                             "Requires --greedy; dense engine only")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: shard the LLM over N ranks, one a card "
                             "(torchrun's, or N processes spawned here)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def select_epochs(ckpts, spec: str):
    """[(epoch, path)] filtered by 'last' | 'all' | 'N' | 'A-B'
    (reference epoch selection, inference_hybird.py:60-83)."""
    if not ckpts:
        return []
    if spec == "last":
        return [ckpts[-1]]
    if spec == "all":
        return ckpts
    if "-" in spec:
        lo, hi = (int(s) for s in spec.split("-"))
        return [(e, p) for e, p in ckpts if lo <= e <= hi]
    want = int(spec)
    return [(e, p) for e, p in ckpts if e == want]


def get_user_message(zeroshot: bool, outside: str | None, use_reasoning: bool) -> str:
    """Priority: outside > zeroshot(ovlabel) > reasoning(description)
    (reference inference_hybird.py:116-129)."""
    if outside is not None:
        return outside
    if zeroshot:
        return "Please recognize all possible emotional states of the character."
    return "Please infer the person's emotional state and provide your reasoning process."


def resolve_device(name: str) -> torch.device:
    """The entry points' --device: the card unless "cpu" is asked for, and
    an error (never the CPU) where there is no card."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda needs a CUDA card; pass --device cpu to run on "
                               "the CPU")
        if device.index is None:
            device = torch.device("cuda", 0)
    return device


def serving_weights(args, frozen: dict, trainable: dict, model_cfg, quant_bits):
    """(frozen, trainable) for one epoch: the LoRA folded in (unless
    --no_merge_lora), then --fuse_qkv (dense engine, one rank) and
    --int8/--int4; under --tp each on the rank's shard."""
    if args.no_merge_lora:
        return frozen, trainable
    llm = frozen["llm"]
    if trainable.get("lora") is not None:
        llm = qwen2.merge_lora(llm, trainable["lora"], model_cfg.llm)
        trainable = {**trainable, "lora": None}
    if args.fuse_qkv and (args.paged or args.tp > 1):
        logger.warning("--fuse_qkv ignored (tp > 1 and the paged engine keep the split "
                       "weight layout)")
    if args.fuse_qkv and not args.paged and args.tp == 1:
        llm = qwen2.fuse_qkv_gateup(llm, model_cfg.llm, fuse_gateup=args.fuse_mode == "full")
    if quant_bits:
        llm = qwen2.quantize_params(llm, bits=quant_bits, cfg=model_cfg.llm)
    return {**frozen, "llm": llm}, trainable


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, argv, world: int, address: str, backend: str) -> None:
    """One spawned rank of `--tp`: join the group, run `main`, leave."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank)
    try:
        main(argv)
    finally:
        dist.destroy_process_group()


def tp_layout(args, device: torch.device):
    """The --tp layout of this process, or None for --tp 1. Joins torchrun's
    group from the environment when it names one and no group exists yet;
    returns "spawned" after running the N ranks as child processes (the
    caller then has nothing left to do)."""
    if args.tp == 1:
        return None
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and torch.cuda.device_count() < args.tp:
        raise AssertionError(f"--tp {args.tp} needs {args.tp} cards, found "
                             f"{torch.cuda.device_count()}")
    if not mesh.distributed():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            dist.init_process_group(backend, init_method="env://")
        else:
            import torch.multiprocessing as mp

            mp.start_processes(_rank_main, args=(args.argv, args.tp,
                                                 f"tcp://localhost:{_free_port()}", backend),
                               nprocs=args.tp, join=True, start_method="spawn")
            return "spawned"
    if dist.get_world_size() != args.tp:
        raise ValueError(f"--tp {args.tp} runs one tp group of {args.tp} ranks; the process "
                         f"group has {dist.get_world_size()}")
    return mesh.create_layout(device if device.type == "cpu" else "cuda", tp=args.tp)


def main(argv=None) -> None:
    args = parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)  # what a spawned rank parses
    setup_logger()
    if args.int8 and args.int4:
        raise ValueError("--int8 and --int4 are exclusive")
    if args.speculative and not args.greedy:
        raise ValueError("--speculative is greedy-exact; add --greedy")
    if args.speculative and args.paged:
        raise ValueError("--speculative runs on the dense engine")
    device = resolve_device(args.device)
    layout = tp_layout(args, device)
    if layout == "spawned":
        return
    if layout is not None:
        device = layout.device
    cfg = Config.from_file(args.cfg_path, args.options) if args.cfg_path \
        else Config.from_dict({}, options=args.options)

    model_cfg, frozen, trainable, tokenizer = build_model(
        cfg.model.to_dict(), with_encoders=True, device=device, layout=layout)
    quant_bits = 4 if args.int4 else (8 if args.int8 else None)
    if quant_bits and args.no_merge_lora:
        frozen = {**frozen, "llm": qwen2.quantize_params(frozen["llm"], bits=quant_bits,
                                                         cfg=model_cfg.llm)}
    if args.fuse_qkv and args.no_merge_lora:
        logger.warning("--fuse_qkv ignored with --no_merge_lora (fusion only applies to the "
                       "merged serving weights)")
    inference_cfg = cfg.inference
    datasets = MERBENCH_DATASETS if args.dataset == "merbench" else [args.dataset]
    face_or_frame = args.outside_face_or_frame or inference_cfg.get(
        "face_or_frame", cfg.model.get("face_or_frame", "frame"))
    user_message = get_user_message(args.zeroshot, args.outside_user_message,
                                    not args.no_reasoning)
    result_root = os.path.join("output", "results", cfg.name)

    # checkpoint-epoch loop: the run dir with the most checkpoints
    # (reference inference_hybird.py:32-54), then the selected epochs
    ckpt_root = args.ckpt_root or checkpoint.discover_checkpoint_root(cfg.output_dir)
    epochs = select_epochs(
        checkpoint.list_checkpoints(ckpt_root) if ckpt_root else [], args.epochs
    ) or [(0, None)]  # zero-shot (no checkpoints): one pass with the initial weights
    data_model_cfg = ModelDataConfig(
        num_video_query_token=model_cfg.num_video_query_token,
        num_audio_query_token=model_cfg.num_audio_query_token,
        num_multi_query_token=model_cfg.num_multi_query_token,
        num_image_query_token=model_cfg.num_image_query_token,
        au_fusion_type=model_cfg.au_fusion_type,
    )
    for epoch, ckpt_path in epochs:
        epoch_trainable = (checkpoint.apply_checkpoint_overlays(trainable, ckpt_path)
                           if ckpt_path else trainable)
        serve_frozen, epoch_trainable = serving_weights(args, frozen, epoch_trainable,
                                                        model_cfg, quant_bits)
        if args.speculative:
            logger.warning("--speculative is EXPERIMENTAL: a verify step costs several "
                           "decode steps, so it gains only at high draft acceptance")
        chat = Chat(serve_frozen, epoch_trainable, model_cfg, tokenizer,
                    kv_cache_dtype=inference_cfg.get("kv_cache_dtype"),
                    speculative_draft_len=args.speculative
                    or int(inference_cfg.get("speculative_draft_len", 0) or 0))
        run_datasets(args, cfg, chat, frozen, model_cfg, tokenizer, datasets, face_or_frame,
                     user_message, result_root, str(epoch), data_model_cfg, layout)
        del chat, serve_frozen


def make_paged_server(args, chat: Chat, max_prompt_tokens: int):
    """ONE long-lived continuous-batching engine for a whole dataset pass:
    requests stream in as chunks load and admission happens whenever slots
    free up, so prefill and decode overlap across chunks."""
    from affectgpt_tpu_torch.inference.paged import PagedBatchServer, PagedConfig

    max_tokens = max_prompt_tokens + args.max_new_tokens
    pcfg = PagedConfig(
        block_size=args.paged_block_size,
        num_blocks=args.paged_num_blocks,
        max_blocks_per_seq=-(-max_tokens // args.paged_block_size),
    )
    pool_dtype = (torch.int8 if chat.kv_cache_dtype == "int8"
                  else chat.frozen["llm"]["embed_tokens"]["table"].dtype)
    return PagedBatchServer(
        chat.frozen, chat.trainable, chat.cfg, chat.tokenizer,
        pcfg=pcfg, max_slots=args.paged_slots, dtype=pool_dtype,
        do_sample=not args.greedy, top_p=0.9, seed=0,
        admission=args.paged_admission,
        prefill_chunk_tokens=args.paged_prefill_chunk or None,
    )


def submit_chunk_paged(server, chat: Chat, face_or_frame, subtitles, user_message,
                       stacked, first_rid: int, max_new_tokens: int):
    """Tokenize one loaded chunk and stream its requests into the engine."""
    from affectgpt_tpu_torch.inference.server import Request

    ids, lengths, offsets = chat.build_prompt_batch(face_or_frame, subtitles, user_message)
    for i in range(len(subtitles)):
        server.submit(Request(
            request_id=first_rid + i,
            input_ids=np.asarray(ids[i][: lengths[i]], np.int32),
            features={m: v[i].float().cpu().numpy() for m, v in stacked.items()},
            offsets={m: int(o[i]) for m, o in offsets.items()},
            max_new_tokens=max_new_tokens,
        ))


def stack_features(feats_per_name: list, frozen: dict, model_cfg, device) -> dict:
    """One chunk's features [b, t, d] on the device: preextracted where every
    clip has them, else the raw media encoded by the towers. "au" is not
    stacked: the reference's splice has no AU patch token (affectgpt.py:
    969-1009) and its inference script passes AU as nonverbal text only (reference
    inference_hybird.py:304)."""
    stacked = {}
    for m in ("frame", "face", "audio"):
        pre = [p["features"].get(m) for p in feats_per_name]
        if all(f is not None for f in pre):
            stacked[m] = torch.as_tensor(np.stack(pre), device=device)
            continue
        raws = [p["raw"].get(m) for p in feats_per_name]
        if all(r is not None for r in raws):
            stacked.update(encode_media_features(
                frozen, model_cfg, {m: torch.as_tensor(np.stack(raws), device=device)}))
    return stacked


def _rank0_says(flag: bool, layout, device) -> bool:
    """Rank 0's `flag` on every rank (one rank decides; the others follow)."""
    if layout is None:
        return flag
    t = torch.tensor([int(flag)], device=device)
    mesh.tp_broadcast(t, layout)
    return bool(t.item())


def run_datasets(args, cfg, chat: Chat, frozen, model_cfg, tokenizer, datasets,
                 face_or_frame, user_message, result_root, epoch_tag, data_model_cfg,
                 layout=None):
    device = chat.device
    is_main = layout is None or layout.is_main
    for ds_name in datasets:
        node = dict(cfg.datasets.get(ds_name.lower(), {}) or {})
        node.setdefault("face_or_frame", face_or_frame)
        if node.get("use_au_clip_realtime"):
            # AU features never reach the LLM input (see stack_features), so
            # per-sample CLIP text encodes would buy nothing here
            logger.info("%s: use_au_clip_realtime disabled for batch inference "
                        "(AU reaches the prompt via nonverbal text)", ds_name)
            node["use_au_clip_realtime"] = False
        ds_cfg = DatasetConfig.from_cfg(node)
        dataset = registry.get("dataset", ds_name)(tokenizer, ds_cfg, data_model_cfg,
                                                   device=device)
        save_root = os.path.join(result_root, f"result-{ds_name.lower()}")
        if is_main:
            os.makedirs(save_root, exist_ok=True)
        save_path = os.path.join(save_root, f"{epoch_tag}.npz")
        # epoch-level resume (reference :276-281), as rank 0 finds it
        if _rank0_says(os.path.exists(save_path), layout, device):
            logger.info("skip %s (exists)", save_path)
            continue

        test_names = dataset.read_test_names()
        name2sub = getattr(dataset, "name2subtitle", {})
        name2reason = {}
        bs = args.batch_size

        def load_chunk(chunk):
            """Host-side modality IO for one chunk (in the worker thread)."""
            return ([dataset.load_modalities({"name": name}) for name in chunk],
                    [name2sub.get(name, "") for name in chunk])

        chunks = [test_names[s: s + bs] for s in range(0, len(test_names), bs)]
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        pending = pool.submit(load_chunk, chunks[0]) if chunks else None
        paged_server, rid2name = None, {}
        try:
            for ci, chunk in enumerate(chunks):
                start = ci * bs
                feats_per_name, subtitles = pending.result()
                pending = pool.submit(load_chunk, chunks[ci + 1]) if ci + 1 < len(chunks) \
                    else None
                stacked = stack_features(feats_per_name, frozen, model_cfg, device)
                if args.paged:
                    if paged_server is None:
                        paged_server = make_paged_server(args, chat, max_prompt_tokens=chat.max_len)
                    for i, name in enumerate(chunk):
                        rid2name[start + i] = name
                    submit_chunk_paged(paged_server, chat, face_or_frame, subtitles,
                                       user_message, stacked, first_rid=start,
                                       max_new_tokens=args.max_new_tokens)
                    while len(paged_server.pending) > paged_server.max_slots:
                        paged_server.step()
                    logger.info("%s: %d/%d submitted (%d done)", ds_name, start + len(chunk),
                                len(test_names), len(paged_server.results))
                else:
                    responses = chat.answer_batch(
                        face_or_frame, subtitles, user_message, stacked,
                        generator=torch.Generator(device=device).manual_seed(start),
                        max_new_tokens=args.max_new_tokens, do_sample=not args.greedy)
                    name2reason.update(zip(chunk, responses))
                    logger.info("%s: %d/%d clips", ds_name, start + len(chunk), len(test_names))
            if paged_server is not None:
                from affectgpt_tpu_torch.inference.generate import trim_output_text

                for rid, tokens in paged_server.run_until_drained().items():
                    name2reason[rid2name[rid]] = trim_output_text(
                        tokenizer.decode(tokens, skip_special_tokens=True))
                logger.info("paged engine stats: %s", paged_server.stats)
                logger.info("paged request SLAs: %s", paged_server.clock.summary())
        finally:
            pool.shutdown(wait=True)
        if is_main:
            np.savez_compressed(save_path, name2reason=name2reason)
            logger.info("saved %s (%d clips)", save_path, len(name2reason))


if __name__ == "__main__":
    main()
