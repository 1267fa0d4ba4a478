"""Worker of the tensor-parallel tests of the port (tests/test_torch_tp.py).

Each process joins a gloo group at a localhost address as one rank of a
(dp, tp) layout, reads the inputs the parent test saved (the port's trees of
the JAX weights, prompts, requests), runs its case on its shard in f32 on
the CPU and saves what it got for the parent to compare with the JAX
package. Imports neither jax nor the JAX package.

    python tests/torch_tp_worker.py <address> <world> <rank> <case> <dir>

Cases: "tp2" (world 2: generate with LoRA as a branch and merged, the
prompt's logits, the int8 and int4 trees, BatchServer, PagedBatchServer,
Chat with and without speculative decoding), "tp4" (world 4: generate and
logits at tp = 4, the tiny config's 2 kv heads held by pairs of ranks),
"dp2tp2" (world 4: generate with the batch split over two dp groups, and
the realtime towers batch-parallel beside one rank's encode).

    python tests/torch_tp_worker.py hybird <argv ...>

runs `python -m affectgpt_tpu_torch.inference_hybird <argv ...>` with f32
bootstraps: the patch below is made when this script is imported, and the
ranks that the entry point spawns import it first, so they run f32 too.
"""

import functools
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from affectgpt_tpu_torch import bootstrap, inference_hybird  # noqa: E402

inference_hybird.build_model = functools.partial(bootstrap.build_model, dtype=torch.float32)


def generate_case(inputs, layout, lora):
    """Greedy generate of the saved prompts on this rank's shard, and the
    prompts' logits (no cache) of the same shard."""
    from affectgpt_tpu_torch.inference import generate as gen
    from affectgpt_tpu_torch.models import qwen2
    from affectgpt_tpu_torch.parallel import mesh

    cfg = inputs["cfg"]
    trainable = {**inputs["trainable"], "lora": lora}
    frozen, trainable, cfg = mesh.shard_model(inputs["frozen"], trainable, cfg, layout)
    out = {}
    for name, ids, lengths in (("gen", inputs["ids"], inputs["lengths"]),
                               ("gen4", inputs["ids4"], inputs["lengths4"])):
        embeds = qwen2.embed_tokens(frozen["llm"], ids)
        gcfg = gen.GenerateConfig(max_new_tokens=inputs["new"], do_sample=False,
                                  eos_token_id=inputs["eos"])
        out[name] = gen.generate(frozen["llm"], cfg.llm, gcfg, embeds, lengths, None,
                                 max_len=inputs["max_len"], lora=trainable["lora"])
    embeds = qwen2.embed_tokens(frozen["llm"], inputs["ids"])
    out["logits"], _ = qwen2.forward(frozen["llm"], cfg.llm, embeds, inputs["valid"],
                                     lora=trainable["lora"])
    return out


def quant_case(inputs, layout):
    """Generate on the int8 and int4 trees' shards (`shard_params` of the
    whole quantized tree), and whether quantizing the shard of the f32 tree
    gives the same leaves."""
    from affectgpt_tpu_torch.inference import generate as gen
    from affectgpt_tpu_torch.models import qwen2
    from affectgpt_tpu_torch.parallel import mesh
    from affectgpt_tpu_torch.training import optim

    qcfg = mesh.shard_config(inputs["qcfg"], layout)
    out = {}
    for bits in (8, 4):
        whole = inputs[f"q{bits}"]
        shard = mesh.shard_params(whole, layout, inputs["qcfg"], "llm/")
        requant = qwen2.quantize_params(mesh.shard_params(inputs["qbase"], layout,
                                                          inputs["qcfg"], "llm/"),
                                        bits=bits, cfg=qcfg)
        out[f"requant{bits}"] = all(torch.equal(a, b) for a, b in zip(
            optim.tree_leaves(requant), optim.tree_leaves(shard)))
        embeds = qwen2.embed_tokens(shard, inputs["qids"])
        gcfg = gen.GenerateConfig(max_new_tokens=inputs["new"], do_sample=False, eos_token_id=1)
        out[f"q{bits}"] = gen.generate(shard, qcfg, gcfg, embeds, inputs["qlengths"], None,
                                       max_len=16)
    return out


def engines_case(inputs, layout):
    """BatchServer and PagedBatchServer under the layout on the saved
    requests, and Chat's greedy and speculative answers."""
    from affectgpt_tpu_torch.inference.chat import Chat
    from affectgpt_tpu_torch.inference.paged import PagedBatchServer, PagedConfig
    from affectgpt_tpu_torch.inference.server import BatchServer, Request
    from affectgpt_tpu_torch.tokenization import ByteTokenizer

    tok = ByteTokenizer()
    args = (inputs["frozen"], inputs["trainable"], inputs["cfg"], tok)
    out = {}
    for name, engine in (
            ("server", BatchServer(*args, max_slots=2, max_len=64, layout=layout)),
            ("paged", PagedBatchServer(*args, pcfg=PagedConfig(block_size=4, num_blocks=64,
                                                                max_blocks_per_seq=8),
                                       max_slots=2, layout=layout))):
        for r in inputs["requests"]:
            engine.submit(Request(**r))
        out[name] = engine.run_until_drained()
    merged = {**inputs["trainable"], "lora": None}
    frozen = inputs["merged_frozen"]
    for name, draft in (("chat_greedy", 0), ("chat_spec", 3)):
        chat = Chat(frozen, merged, inputs["cfg"], tok, max_len=512, layout=layout,
                    speculative_draft_len=draft)
        out[name] = chat.answer_batch("frame", inputs["subtitles"], "why?",
                                      inputs["chat_features"], max_new_tokens=8,
                                      do_sample=False)
    return out


def realtime_case(inputs, layout):
    """encode_media_features batch-parallel over the dp groups against this
    rank alone, then greedy generate of the spliced prompts under the
    layout."""
    from affectgpt_tpu_torch.inference import generate as gen
    from affectgpt_tpu_torch.inference.chat import encode_media_features
    from affectgpt_tpu_torch.models import affectgpt
    from affectgpt_tpu_torch.parallel import mesh

    cfg, frozen, trainable = inputs["rt_cfg"], inputs["rt_frozen"], inputs["trainable"]
    kw = dict(vision_cfg=inputs["vision_cfg"], audio_cfg=inputs["audio_cfg"])
    feats = encode_media_features(frozen, cfg, inputs["raw"], layout=layout, **kw)
    alone = encode_media_features(frozen, cfg, inputs["raw"], **kw)
    embeds = affectgpt.build_inputs_embeds(frozen, trainable, cfg, inputs["rt_ids"], feats,
                                           inputs["rt_offsets"])
    sfrozen, strain, scfg = mesh.shard_model(frozen, trainable, cfg, layout)
    gcfg = gen.GenerateConfig(max_new_tokens=5, do_sample=False, eos_token_id=257)
    toks, _ = gen.generate(sfrozen["llm"], scfg.llm, gcfg, embeds, inputs["rt_lengths"], None,
                           max_len=48, lora=strain["lora"])
    one, _ = gen.generate(frozen["llm"], cfg.llm, gcfg, embeds, inputs["rt_lengths"], None,
                          max_len=48, lora=trainable["lora"])
    return {"feats": feats, "alone": alone, "rt_tokens": toks, "rt_alone_tokens": one}


def main():
    if sys.argv[1] == "hybird":
        inference_hybird.main(sys.argv[2:])
        return
    address, world, rank, case, out_dir = sys.argv[1:6]
    world, rank, out = int(world), int(rank), Path(out_dir)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=address, world_size=world, rank=rank)
    from affectgpt_tpu_torch.parallel import mesh

    inputs = torch.load(out / "inputs.pt", weights_only=False)
    tp = {"tp2": 2, "tp4": 4, "dp2tp2": 2}[case]
    layout = mesh.create_layout(device="cpu", tp=tp)
    lora = inputs["trainable"]["lora"]
    result = {"unmerged": generate_case(inputs, layout, lora)}
    if case == "dp2tp2":
        result.update(realtime_case(inputs, layout))
    else:
        merged = {**inputs, "frozen": inputs["merged_frozen"]}
        result["merged"] = generate_case(merged, layout, None)
    if case == "tp2":
        result.update(quant_case(inputs, layout))
        result.update(engines_case(inputs, layout))
    torch.save(result, out / f"{case}_rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
