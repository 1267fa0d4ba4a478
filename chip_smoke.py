"""GPU smoke run of the PyTorch port (`affectgpt_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card (it raises without one) and nvcc. Phases, one line each:

1. Device: card name and power limit (from nvidia-smi), torch, CUDA and
   nvcc versions. TF32 is switched off for matmuls and cuDNN, so every
   float32 product on the plain path is a full float32 product.
2. Build: compiles affectgpt_tpu_torch/csrc into affectgpt_tpu_torch/_build.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, in bf16, at Qwen2.5-7B widths (b = 8 and 64, RoPE positions up
   to 4096); the two bf16 decode kernels (decode_qkv, decode_mlp_bf16, on
   the swap-AB wgmma kernel) at 7B b = 8, 16 and 64 and at bench.py's 3B
   geometry at b = 384, each with its launch plan, the same bits from a
   second call, `chain_ms` (their library chains) and `bound_ms`. Times of
   each side: `ms`/`plain_ms` are device time per call
   (calls captured in a CUDA graph, 20 replays, weights read from device
   memory); `eager_*` are eager calls with the L2 flushed before each, which
   include the host's launch overhead. The attention kernels are checked at
   T = 640 and at a T that is not a multiple of their 16-column tile, with
   ragged per-row windows of valid cache columns (decode; decode_attention
   also on the dense BatchServer's masks, [0, pos] per slot with two slots
   inactive, whose rows must come back exactly zero) and prompt lengths
   545-564 left-packed into t = 564 (prefill, timed at b = 8 and 64 with its
   TFLOP/s and its launch plan; also checked on segment ids in runs whose ids
   come back after others, at t = 564 and 37); `library_ms` times one PyTorch
   call that computes the same function (scaled_dot_product_attention with
   GQA and a bool mask), a yardstick the port never calls. `bound_ms` is
   the least time the card could take: bytes moved at 3.35 TB/s or
   operations at 989 TFLOP/s (bf16) or 1979 TOPS (int8), whichever is
   larger, counted from this run's inputs (valid cache columns and visible
   key pairs only). The four quantized matmuls are checked at every (K, N)
   of the 7B split and fused layouts and the lm_head, at the M the main path
   routes to each plus a ragged one; their times are per decoder layer at
   the main path's M (the sum of the layer's products, each timed alone),
   with `bf16_cublas_ms`, torch.matmul on the same weights dequantized to
   bf16, as a yardstick of the unquantized product that no path runs; the
   w8a8 kernel (wgmma) must also give the same bits on a second call, and
   prints its variant (wgmma N-width, K splits) and the bytes it reads; so
   must the two int4 wrappers and `int8_matmul`, which print the swap-AB
   kernel's plan at M <= 16 (n8 tiles, cluster size, grid, ring, shared
   memory) beside each product; `int8_matmul` is checked at every M of 1-16
   and at 64 and 1000 (the 128 x 64 tile), and also timed at M = 16 on the split layout's attention
   products and the lm_head (paged_w8's decode M); `int4_matmul` is also
   timed at M = 256, bench.py's 7B batch, beside cuBLAS bf16 (a measurement
   only); `int4_matmul` and `int8_matmul` are also checked and timed at
   M = 40, the speculative verify's rows (8 clips x (4 drafts + 1)), over the
   7B split layer and the lm_head, beside cuBLAS bf16. The serving kernels:
   paged attention (bf16 and int8 pools of 2048 blocks of 16, 16 rows of
   545-596 tokens plus a 1-token row and a one-page row, pages drawn from a
   shuffled permutation, table widths 38
   and 64, each call's plan printed (splits, cluster, ring), the same bits
   from a second call; times at both widths over three disjoint table sets
   on two pools, so a replay cycle reads more than the L2; `chain_ms` times
   the gather chain that PAGED_ATTENTION="xla" runs, inference/paged.py) and
   the int8 decode MLP
   (b = 8, 16, 64 on int8 weights of the 7B layer; times at b = 16, with
   the three products in cuBLAS on the dequantized bf16 weights as a
   yardstick); neither has a single PyTorch call that computes its
   function, so `library_ms` is null. The two kernels redesigned last, the
   decode MLP (tensor cores) and the encoder MLP sublayer (wgmma + TMA),
   must give the same bits on a second call and print `old_ms`, the
   previous design's time (a variant of the same C entry), and a `variant`
   dict with their tiles, rings and grids and `no_products_ms`, the time
   of the variant without the tensor-core products.
   The encoder kernels at the towers' widths (ViT-L/14 and HuBERT-large:
   w = 1024, 16 heads of 64, I = 4096), 64 images or clips: CLIP's 257
   tokens, 264 with valid_len 257 and HuBERT's 99 (the two attention
   kernels also at 512 tokens, 330 with 321 valid and 257 with one valid,
   fused_vit_attention in both layouts); both activations of the
   MLP kernels, both accumulations of the fused one (the bf16 accumulator is
   allowed one more bf16 ulp of its running sum's peak: a rounding that
   parts there outlives the later chunks; the fused kernel, on wgmma, must
   give the same bits on a second call and prints its variant and L2
   bytes). Times at CLIP's shape (and HuBERT's for the sublayer, the MLP
   pair, the fused MLP and the attention, with TFLOP/s and the attention's
   launch plan), four layers' weights per replay cycle;
   `library_ms` is SDPA with the bool key mask for the attention, and the
   sublayers print their library chains' times (layer_norm, addmm, SDPA or
   the activation, addmm) as `chain_ms`, as do the bf16 decode kernels
   (rms_norm, addmm, RoPE; rms_norm, matmul, silu * up, addmm) and
   decode_attn_o (SDPA, addmm). The attention sublayer (its four products
   on the wgmma GEMM, q/k/v in one launch), decode_attn_o (the attention
   in one launch, o_proj on the swap-AB wgmma kernel) and decode_attention
   (the same attention kernel under a key rule that takes any mask) must
   give the same bits on a second call at every checked shape, print their
   plans (`variant`; decode_attention's with its key rule, all tiles of a
   row or its window's) and, beside their times (at b = 8 and 64),
   `stages`: the device ms of each launch of one call, from torch.profiler.
4. Main path: bootstrap.build_model at Qwen2.5-7B width with random bf16
   weights from a seed, LoRA merged by serving_llm, then Chat.answer_batch
   on 8 preextracted clips, greedy, 32 new tokens, under three attention
   configurations of models/qwen2.py: the default (plain attention), (a)
   PREFILL_ATTENTION="flash" with DECODE_ATTN_O="pallas", and (b)
   PREFILL_ATTENTION="flash" with DECODE_ATTENTION="pallas"; then under five
   quantized configurations of the same merged weights, built as
   inference_hybird.py builds them (fuse_qkv_gateup, then quantize_params):
   q4 (int4, b = 8), q4_b16 (the same tree, 16 clips), decode_llm (bf16
   prefill, generate(decode_llm=) with the int4 tree for the decode loop,
   as bench.py's mixed-precision mode calls it), q8_fused (qkv and gate/up
   fused, int8) and q8a8 (int8, MATMUL_MODE="w8a8"); and qkv_xla
   (qwen2.DECODE_QKV="xla", counted only, not timed). Each run must launch
   every kernel of its configuration exactly as often as the path calls it
   and the others not at all; all logits must be finite, one string per
   clip must come back. Then each configuration is timed once, in the
   order default, a, b, q4, q4_b16, decode_llm, q8_fused, q8a8 (the
   quantized decode steps make this phase long); prints peak memory and
   the prefill ms, decode ms per step and clips/s of the visit.
5. Serve: the continuous-batching engines on the merged model of phase 4,
   built as inference_hybird.py's make_paged_server builds the paged one
   (block 16, 2048 blocks, tables for the longest prompt + 32 tokens, 16
   slots, reserve admission, bursts of 8, greedy), over 48 requests (the 8
   clips six times, prompts from Chat.build_prompt_batch, max_new_tokens
   cycling 32, 24, 16, 8), all submitted up front: paged_bf16 (bf16 tree
   and pool, PAGED_ATTENTION="pallas"), paged_bf16_gather (the same with
   the gather chain, PAGED_ATTENTION="xla"), paged_kv8 (int8 pool),
   paged_w8 (int8 split tree, DECODE_MLP="pallas"), server_bf16 (the
   dense BatchServer, 16 slots, max_len 640) and server_bf16_da (the same
   under DECODE_ATTENTION="pallas", decoding through decode_attention).
   One counted run each asserts that each kernel of the configuration
   launched num_layers x the decode steps the engine made (int8_matmul by
   its own count), every other kernel 0 times, one result per request and
   finite logits; it prints how many requests' tokens paged_bf16,
   paged_bf16_gather and server_bf16 share pairwise, and server_bf16_da with
   server_bf16 (not gated); then one timed run each prints requests/s, TTFT
   and end-to-end percentiles, generated tokens/s, the engine's phase times
   and counters, the cache's GiB and the peak memory.
6. Realtime: the phase-4 model, built with_encoders=True (CLIP ViT-L/14 and
   HuBERT-large beside the LLM), answers 8 clips from raw media made from a
   seed (720p frames, 112² face crops, 2 s of 16 kHz audio) through
   encode_media_features and Chat.answer_batch under five configurations of
   the towers' switches (RT); a counted run each asserts the exact encoder
   launches (24 layers per tower call) beside the LLM's, finite features and
   logits and one string per clip, and prints the features' distance from
   rt_plain's; timed visits print the stages' ms, clips/s from raw media to
   text and the peak memory.
7. Serving variants, on the phase-4 model; each sub-run a counted run
   (exact launches, every other kernel 0 times) and one timed run.
   spec_bf16, spec_q4, spec_kv8: Chat(speculative_draft_len=4), greedy, 8
   clips, 32 tokens, on the bf16 tree, the q4 tree and the bf16 tree with
   the int8 KV cache; the decode kernels take t = 1 only, so the bf16 setups
   launch none, and spec_q4 launches int4_matmul 197 x its verify
   iterations (7 products x 28 layers + the lm_head at M = 40) and
   int4_matmul_smallm once (the prefill's last-token lm_head); prints the
   verify iterations, tokens per iteration, decode ms beside plain greedy's,
   and how many rows equal the same tree's greedy answer (not gated). The
   f32 exactness gate: the speculative call at 2 layers of the 7B width in
   f32 must emit greedy's tokens row for row. On the random weights a row
   may part where greedy's top-two logit gap is below 1e-4 of the logits'
   scale (printed); on a rig whose greedy stream is a 2-cycle (projections
   zeroed, a two-column lm_head) the drafts are accepted, and tokens,
   num_valid and more than one token per iteration are gated.
   au_agent: AUAgent on the merged 7B LLM (T 0.7, top-p 0.9, repetition
   penalty 1.1, 256 tokens) over 8 OpenFace rows from a seed, one neutral;
   rows 1-2 launched 28 x 256 times, the neutral row's fixed string, one
   step's penalty on the card bit-identical to the CPU's; prints tokens/s.
   qformer: video, audio and multi mergers all "qformer" (768 wide, 12
   heads, 2 layers) from a seed before the phase-4 LLM, greedy on the 8
   clips; rows 1-2 launched 28 x 32 times; prints merger and prefill ms.
   clip_text: encode_texts of the ViT-B/32 text geometry over 64 AU strings,
   f32 within 1e-4 of the CPU's tower, no kernel; prints its bf16 ms.
   rt_w8a8: phase 6's path with both towers from quantize_encoder_tree;
   fused_vit_attention launched 24 x per CLIP call, the other encoder
   kernels 0 times; prints the features' distance from rt_plain's and the
   stages' ms.
8. Train: `training.train_step.make_train_step` on the phase-4 LLM at
   Qwen2.5-7B width (its bf16 weights frozen; f32 LoRA r = 16 with B drawn
   from a seed, and the attention mergers; AdamW, weight decay 0.05, clip
   1.0), preextracted features [b, 8, 768|1024], prompts of t = 256
   (scripts/bench_train.py) whose last 64 positions are labels, dropout on
   (seed 42). Runs of 2 warm-up and 5 timed steps: b = 8 remat=True, b = 4
   remat=False, b = 4 remat="dots", b = 4 accum_steps=2; each prints step
   ms, samples/s, target tokens/s and peak memory, and launches no kernel;
   the b = 8 run also prints one step's forward, backward and optimizer ms,
   its device busy share and its kernels by device time (torch.profiler).
   Gates: (1) every loss and grad_norm is finite; (2) on one fixed batch,
   dropout off, lr 1e-4, the loss after 10 steps is below the first
   step's; (3) on the first 2 layers of the LLM at 7B width, the bf16 loss
   and trainable gradients are within the bf16 bounds of the same model
   upcast to f32 on the card (BF16_LOSS_RTOL on the loss; relative L2
   errors: BF16_TOTAL_RTOL on the whole gradient, BF16_GRAD_RTOL on each
   leaf of at least GATED_LEAF_SIZE elements); (4) on that 2-layer model
   with dropout on, remat=True and "dots" give remat=False's loss and
   gradients within the same bounds; (5) a
   realtime step at b = 2, the frozen CLIP ViT-L/14 and HuBERT-large under
   torch.no_grad on raw media, launches attn_sublayer and mlp_sublayer 48
   times each (as rt_default) and nothing else, and gives the mergers
   finite, non-zero gradients. The runs include b = 4 remat=True beside
   remat=False and "dots" at the same batch.
9. Runner: the training entry point's path (`config.Config.from_dict` →
   `training.runner.build_datasets` → `Runner.train`) on the phase-4 model
   (its LLM frozen, f32 trainable leaves from a seed), over a synthetic
   MERCaptionPlus corpus of 16 clips written to a temporary directory
   (subtitles and the track2 / track3 label CSVs, preextracted frame, face
   and audio features, raw OpenFace crops and wav files). Run A,
   runner_bestsetup: the model, datasets and run nodes of
   train_configs/mercaptionplus_bestsetup.yaml (BESTSETUP, a literal: the
   card has no YAML parser) with RUN_A_OVERRIDES, 2 epochs of 6
   iterations, validation; it prints each iteration's ms, their median
   after each epoch's first, the share spent waiting on the prefetcher,
   the bare step's median on one resident batch, the losses, each
   checkpoint's bytes and save seconds and the peak memory; gates: finite
   losses, checkpoints of epochs 0, 1 and 2 and a best one, log.txt's
   config line and two epoch lines, the median iteration at most
   ITERATION_RATIO_MAX x the bare step's, and a Runner resumed from epoch
   1's checkpoint at epoch 1, step 6 and its optimizer count; no kernel
   launches. Run B, runner_realtime: the face and audio read raw and
   encoded by the towers inside the prefetcher, b = 2, 3 iterations; rows
   11 and 12 launch once a CLIP layer for every batch the prefetcher
   encoded, nothing else.
10. Load: the phase-4 model written as HF directories in a temporary
   directory (its free space checked first): a Qwen2.5-7B-Instruct-shaped
   LLM directory (config.json with the published geometry, the LLM in HF's
   names and [out, in] layout as LOAD_SHARDS bf16 safetensors shards with
   an index, written by the script's own safetensors writer; a
   tokenizer.json of Qwen2's form whose byte-level BPE the script learns
   from its prompts' text, the vocabulary filled to Qwen2.5's 151643 so the
   22 special tokens take their ids 151643-151664, and a
   tokenizer_config.json with eos <|im_end|>), CLIP ViT-L/14's
   model.safetensors and HuBERT-large's pytorch_model.bin with the
   positional conv in the parametrizations.weight.original0/1 form; the
   path tables then name them. Gate 1: bootstrap.build_model loads every
   tensor bit for bit (HuBERT's positional conv equals g·v/‖v‖ of the
   written g and v in f32 numpy); prints the load's seconds and GB/s (warm
   page cache), the host's RSS before and at its peak. Gate 2:
   Chat.answer_batch on the 8 clips, greedy, 32 tokens, gives the same
   tokens from the loaded LLM as from the in-memory one under the loaded
   tokenizer, rows 1-2 launched layers x 32 times in each; prints the prompt
   tokens under the BPE beside the ByteTokenizer's. Gate 3:
   inference_hybird.main over a MER2023-style corpus of 16 preextracted
   clips with a checkpoint that save_checkpoint wrote (a LoRA that the
   merge changes), --greedy, once on the bf16 serving weights and once with
   --int4: one .npz of 16 answers each, the kernels launched as their
   routes say (hybird_launches) and no other. Gate 4:
   extract_multimodal_features_precompute.main over 8 raw clips (720p
   frames, OpenFace crops, 2 s wav) with the towers loaded from their
   directories writes the frame, face, audio and multi caches, within
   FEATURE_RTOL of the in-memory towers' features, rows 11 and 12 launched
   24 times per CLIP call and nothing else.
11. Zoo: the encoder zoo and the Llama-2 / Baichuan2 families. (a) Row 13
   (fused_vit_attention) against its plain version at the zoo's shapes
   (ZOO_ATTENTION: DINOv2-large's 1370 tokens at head_dim 64 and SigLIP
   so400m's 729 at 72, both on 2 clips x 8 frames x (frame + face) = 32
   images of 16 heads; ImageBind's 229 at 64 on 16 mel clips of 12 heads;
   CLIP's 257 beside them), in the [b, n, h, d] layout nn.mha gives it and
   in [b, h, n, d]: the plan's mode, the largest error, the kernel's,
   plain version's and one SDPA call's device ms, and the bound. (b) Each
   of the seven zoo towers at registry geometry in bf16, random weights
   from a seed, on 2 of the realtime clips (mel clips for IMAGEBIND): the
   FUSED_MHA="auto" route against "0", within ZOO_REL_TOL of the plain
   route's features, ms a call, and row 13's launches a call (24 DINOv2, 27
   SigLIP, 12 ImageBind, none elsewhere). (c) Rows 1-4 and 15 against their
   plain versions at Llama-2's MHA geometry (32 heads of 128, I = 11008, no
   qkv bias), b = 8; then the Llama2 model (Llama-2-7B, SigLIP_SO +
   WAVLM_LARGE) and the Baichuan2 model (vocab 125696, DINO2_LARGE +
   IMAGEBIND on mel clips), each built by bootstrap.build_model(with_encoders
   =True, keep_full_llm=True) with LoRA merged, served with its tokenizer
   (a Llama-2-form tokenizer.json and a BPE sentencepiece tokenizer.model
   that the script learns from its prompts and writes, read by
   load_tokenizer), encode_media_features → greedy Chat.answer_batch on the
   8 clips, 32 new tokens; gates: the launches (rows 1-2 layers x 32, row 13
   as the towers' layers say, nothing else), features of the expected
   shapes and finite, 8 strings, the tokenizer's round trip of the prompts'
   text. One model is freed before the next is built. The kernel line's
   fused_vit_attention entry carries phase 11's shapes and launches.
12. Eval: the evaluation slice on phase 10's Qwen2.5-7B-shaped directory
   (kept on disk through phase 11) and its CLIP and HuBERT directories. (7)
   The OV-MER zero-shot harness over an OV-MERD+ label tree of 8 clips, its
   model_fn the port's Chat on the loaded LLM (LoRA merged), text only,
   greedy, 32 tokens: one string a clip in the npz, rows 1-2 launched
   layers x 8 x 32 times. (1) `python -m affectgpt_tpu_torch.evaluation
   --input-dir` over that root plus a result-mer2023 root of 16 answers and
   a result-cmumosi root of 8, their label trees written beside: the LLM
   judge (the lexicon judge refused) samples 5 batches of 8 prompts,
   JUDGE_TOKENS (128; the judge's default is 512) tokens each, on the card;
   rows 1-2 launched layers x 5 x JUDGE_TOKENS times, the
   four judge caches written, every score finite; prints the judge's
   tokens/s and the scores. (2) evaluation_scoreonly over the same root
   gives the same scores with no model built. (3) compare_outputs --ours
   (the 16 answers) --reference (8 of them, 4 with the same text): 8 common,
   4 exact, two judge batches. (4) prepare_au_instruction_dataset over a
   MER-Factory tree of 16 AU rows (and verify_au_pipeline over it: 4 files
   ok), then train_au_agent on the 7B directory at r 64, --max-length 512,
   3 epochs of the 16 records at the largest batch of 8, 4, 2 that fits
   (printed), lr 5e-4: finite losses, the last epoch's mean below the
   first's, no kernel launched, the last checkpoint reloading to the trained
   leaves; prints each step's ms and the peak GiB. (5) The MER-UniBench
   precompute over a MER2023 tree of 8 raw clips (720p frame dumps,
   OpenFace crops, 2 s wav) with the towers loaded from their directories:
   rows 11-12 launched 24 x 2 calls a clip, every cache within 1e-3 of a
   direct FeatureExtractor run's (equal bits printed). (6) 8 clips of 16
   smooth 360 x 638 frames transcoded to MJPEG-AVI (the DCT on the card),
   read back by data/media.py's native decoder and device decode within
   JPEG_ATOL; normalize_mer2023 over a raw tree, loaded by the dataset class.
   The kernel line carries the launches of rows 1-2 and 11-12 in phase 12
   as `eval_launches`.
13. Tensor parallelism. (a) Rows 1, 2, 4 and 10 at Qwen2.5-7B's tp = 2 (14
   query heads, 2 kv heads, I = 9472 a rank) and tp = 4 (7, 1, 4736) shard
   shapes, b = 8 and 16, rows 2, 4 and 10 with and without their residual
   add (a rank's partial sum), and rows 6, 8 and 9 over one layer's tp = 2
   shard at their main-path M, each against its plain version at the bf16
   tolerance, with ms, plain_ms and bound_ms (run right after phase 3's
   encoder kernels). (b) Phase 10's directory (kept on disk through phase 13)
   at tp = 2: the parent loads it whole and records the prefill and
   teacher-forced decode logits (TP_FORCED, and 2 layers in f32), the greedy
   answers and the paged engine's results; then two spawned ranks each load
   their shard a slice at a time, merge the LoRA on it, quantize it (int4,
   int8) and run the same logits, phase 4's default, (a), (b), q4 and q4_b16
   and phase 5's paged_bf16 (24 requests) and paged_w8 (16) with exact launch
   counts on each rank. The logits must be within TP_REL_L2_F32 (f32) and
   TP_REL_L2 (bf16) of tp = 1's, and a negative control (the default
   configuration's logits with the all-reduce after o_proj skipped) must
   read above TP_REL_L2; the greedy strings' and paged tokens' match
   share is printed, not gated. With one card the ranks share it over gloo
   (CUDA tensors; NCCL takes one rank a card) and a time there is no
   tensor-parallel speedup; with two cards or more `inference_hybird --tp 2`
   also runs on NCCL. A rank that fails or outlives TP_TIMEOUT fails the
   phase. The kernel line carries phase 13 (a)'s shapes as `tp_shapes` and
   rank 0's launches in (b) as `tp_launches`.
14. Tensor-parallel training on phase 10's directory at tp = 2 (kept on
   disk through phase 14). The parent loads it whole with the towers and
   records the references; two spawned ranks sharing the card over gloo
   each load their shard (`bootstrap.build_model(layout=)`), train phase
   8's trainable tree (f32 LoRA r = 16 with B drawn, the attention mergers;
   whole on every rank) at phase 8's geometry, b = 4, remat, dropout on,
   and hold five gates: (1) 6 steps on one batch, every loss and grad norm
   finite, the loss after them below the first, the ranks' trees
   identical; (2) f32 at 2 layers, dropout off and on: loss, whole gradient
   and each leaf of GATED_LEAF_SIZE elements within TP_TRAIN_REL_L2_F32 of
   tp = 1's; (3) bf16 over 28 layers within twice phase 8's BF16_* bounds;
   (4) negative controls (the LoRA gradients not summed over tp, f's
   backward all-reduce skipped) above TP_TRAIN_REL_L2_F32; (5) the realtime
   step at b = 2 launching rows 11 and 12 48 times each on each rank. Step
   ms, peak memory and weights a rank beside tp = 1's are printed; with two
   cards or more `python -m affectgpt_tpu_torch.train --multihost` at tp =
   2 runs on NCCL against tp = 1. The kernel line carries rank 0's launches
   in gate 5 as `tp_train_launches`.
15. Toolkit: the MERBench toolkit (`affectgpt_tpu_torch/toolkit/`) at full
   width, random weights from a seed. (a) The 13 fusion baselines at
   MERBench's best MER2023 features (audio 1024, text 5120, video 768;
   hidden 128; TFN's post1 [129³, 128] f32): one epoch of 3373 clips at
   batch 32 through `train.train_fusion_model` (ef_lstm, mfn, graph_mfn and
   mctn on frame-level sequences of 32 steps), then `evaluate_fusion_model`
   on 411 clips; no kernel, finite losses and metrics; seconds, steps/s and
   peak GiB a model. (b) `e2e` at CLIP ViT-L/14 + HuBERT-large, 4 clips of
   8 224² frames and 2 audio clips of 2 s: a bf16 forward under no_grad
   launching rows 11 and 12 24 times each (within TOOLKIT_REL_TOL of the
   plain chain's), then 5 f32 Adam steps with autograd through both towers
   launching no kernel, the loss falling and CLIP's patch embedding moving.
   (c) VideoMAE at its default config, 8 videos of 16 224² frames (1568
   tubes): 5 f32 pretraining steps (no kernel, the loss falling), then
   `encode_video` in bf16 launching row 13 12 times (within TOOLKIT_REL_TOL
   of the plain chain's), and row 13 at [8, 6, 1568, 64] against its plain
   version with its times, bound and SDPA (as phase 11). (d) One batch of 8
   JPEG images (encoded on the card) through `gptv.annotate_images` (the
   mer2023 vocabulary) with `api_helpers.LocalJudgeTransport` over the LLM
   judge loaded from phase 10's directory (kept on disk through phase 15),
   JUDGE_TOKENS tokens: rows 1-2 launched 28 x the decode steps, one batch
   file. The kernel line's fused_vit_attention entry carries the VideoMAE
   shape, and rows 1-2 and 11-13 carry their phase-15 launches as
   `toolkit_launches`.
16. OV-MER adapters (`affectgpt_tpu_torch/ovmer/adapters/`) through
   `zero_shot_harness.run_zero_shot` over a two-clip MER2023 label root:
   clip a an MJPEG-AVI of 150 frames of 112 x 192 written by the port's
   JPEG encoder and a 2 s stereo wav at 48 kHz, clip b a video no decoder
   reads and no wav. The card has no HF weights, so the wrapped HF
   models do not run: doubles with an HF-shaped `config` at each family's
   published vision geometry (llava-1.5-7b-hf 336 px / patch 14, 576
   tokens a frame; LLaVA-NeXT-Video-7B-hf pooled by 2, 144; Video-LLaVA-7B-hf
   224 px, 257) and a recording `generate` stand in, over a byte-level
   tokenizer double. Each of the eight video adapters (Chat-UniVi also at
   1 fps, its 100-frame read kept whole, and mPLUG-Owl at max_length 4096,
   the prompt at its default 512 being overlong) must hand generate pixels
   on the card of the [T, 3, S, S] (or [1, T, 3, S, S]) its rule gives,
   within OVMER_PIXEL_ATOL of the port's CPU preprocessing of the same
   frames, tokens a frame x T image tokens, and save the double's reply for
   clip a and "" for clip b; Qwen-Audio and SALMONN read the wav as its
   channels' mean at 16 kHz (within OVMER_WAV_ATOL), build the prompts from
   the subtitle (and the transcript) and put their tensors on the card. A
   double whose generate raises RuntimeError must end run_zero_shot with
   it, no npz written. Every wrapper launches 0 times. Then `python -m
   affectgpt_tpu_torch.scripts.quality_run --synthetic <tmp> --device
   cuda` (the LLM at the 3B geometry) must exit 0 with its answers and the
   judge's cache written. Prints T, S, image tokens and the ms of the host
   read and the device preprocessing a clip, whether `transformers` is
   importable, the recipe's seconds and the phase's.

The line before the last is a JSON object with one entry per kernel; the
last line is `{"ok": true, "device": {...}}`, printed only when every
phase passed. Every time printed carries the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from affectgpt_tpu_torch import bootstrap
from affectgpt_tpu_torch.inference import generate as gen
from affectgpt_tpu_torch.inference import paged, server
from affectgpt_tpu_torch.inference.chat import Chat, encode_media_features, prepare_frames
from affectgpt_tpu_torch.models import affectgpt, au_agent, clip_vit, encoders, hubert, nn, qwen2
from affectgpt_tpu_torch.ops import _build, decode_attn_o as decode_attn_o_module
from affectgpt_tpu_torch.ops import decode_gemm, quant, vit_mlp
from affectgpt_tpu_torch.ops import decode_attention as decode_attention_module
from affectgpt_tpu_torch.ops import decode_mlp as decode_mlp_module
from affectgpt_tpu_torch.ops.vit_attention import (
    fused_self_attention,
    fused_vit_attention,
    fused_vit_attention_reference,
    vit_attention_plan,
)
from affectgpt_tpu_torch.ops import vit_mlp_fused
from affectgpt_tpu_torch.ops.vit_mlp import activation, mlp_sublayer, mlp_sublayer_reference
from affectgpt_tpu_torch.ops.vit_mlp_fused import (
    chunks_for,
    mlp_sublayer_fused,
    mlp_sublayer_fused_reference,
)
from affectgpt_tpu_torch.ops.vit_sublayer import (
    attn_sublayer,
    attn_sublayer_plan,
    attn_sublayer_reference,
    dot_f32,
    layernorm_rounded,
)
from affectgpt_tpu_torch.ops.decode_attention import decode_attention, decode_attention_reference
from affectgpt_tpu_torch.ops.decode_attn_o import decode_attn_o, decode_attn_o_reference
from affectgpt_tpu_torch.ops.decode_mlp import decode_mlp, decode_mlp_plan, decode_mlp_reference
from affectgpt_tpu_torch.ops.decode_mlp_bf16 import (
    decode_mlp_bf16,
    decode_mlp_bf16_plan,
    decode_mlp_bf16_reference,
)
from affectgpt_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_int8,
    paged_attention_reference,
    paged_plan,
)
from affectgpt_tpu_torch.ops.decode_qkv import decode_qkv, decode_qkv_plan, decode_qkv_reference
from affectgpt_tpu_torch.ops.prefill_attention import (
    FULL,
    MASKED,
    SKIP,
    prefill_attention,
    prefill_attention_reference,
    prefill_plan,
)
from affectgpt_tpu_torch.training import optim, train_step
from affectgpt_tpu_torch.utils import clip_text

# both sides round at the same points (xn and silu·up to bf16, attention
# before o_proj), so they differ by f32 summation order plus one final bf16
# rounding; the prefill kernel also rounds p to bf16 for its PV product
RTOL, ATOL = 1.6e-2, 1e-2
NEW_TOKENS = 32
BATCH = 8
DRAFT_LEN = 4  # phase 7's speculative draft length
SPEC_M = BATCH * (DRAFT_LEN + 1)  # the rows of a speculative verify's products
MAX_LEN = 640
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
BF16_FLOP_PER_S = 989e12  # H100 SXM, dense bf16 tensor cores
S8_OPS_PER_S = 1979e12  # H100 SXM, dense int8 tensor cores
KERNELS = {
    "decode_qkv": {
        "source": "affectgpt_tpu_torch/csrc/decode_qkv.cu",
        "replaces": "affectgpt_tpu/ops/decode_qkv_pallas.py:121",
    },
    "decode_mlp_bf16": {
        "source": "affectgpt_tpu_torch/csrc/decode_mlp_bf16.cu",
        "replaces": "affectgpt_tpu/ops/decode_mlp_bf16_pallas.py:154",
    },
    "decode_attention": {
        "source": "affectgpt_tpu_torch/csrc/decode_attention.cu",
        "replaces": "affectgpt_tpu/ops/decode_attention_pallas.py:64",
    },
    "decode_attn_o": {
        "source": "affectgpt_tpu_torch/csrc/decode_attn_o.cu",
        "replaces": "affectgpt_tpu/ops/decode_attn_o_pallas.py:140",
    },
    "prefill_attention": {
        "source": "affectgpt_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "affectgpt_tpu/models/qwen2.py:681",
    },
    "int4_matmul_smallm": {
        "source": "affectgpt_tpu_torch/csrc/quant_swapab.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:407",
    },
    "int4_matmul": {
        "source": "affectgpt_tpu_torch/csrc/quant_swapab.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:319",
    },
    "int8_matmul": {
        "source": "affectgpt_tpu_torch/csrc/quant_swapab.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:90",
    },
    "int8_matmul_w8a8": {
        "source": "affectgpt_tpu_torch/csrc/int8_matmul_w8a8.cu",
        "replaces": "affectgpt_tpu/ops/quant.py:163",
    },
    "paged_attention": {  # _kernel, bf16 pools
        "source": "affectgpt_tpu_torch/csrc/paged_attention.cu",
        "replaces": "affectgpt_tpu/ops/paged_attention_pallas.py:245",
    },
    "paged_attention_int8": {  # _kernel_int8, int8 pools with scales
        "source": "affectgpt_tpu_torch/csrc/paged_attention.cu",
        "replaces": "affectgpt_tpu/ops/paged_attention_pallas.py:245",
    },
    "decode_mlp": {
        "source": "affectgpt_tpu_torch/csrc/decode_mlp_int8.cu",
        "replaces": "affectgpt_tpu/ops/decode_mlp_pallas.py:122",
    },
    "attn_sublayer": {
        "source": "affectgpt_tpu_torch/csrc/vit_sublayer.cu",
        "replaces": "affectgpt_tpu/ops/vit_sublayer_pallas.py:105",
    },
    "mlp_sublayer": {
        "source": "affectgpt_tpu_torch/csrc/vit_mlp.cu",
        "replaces": "affectgpt_tpu/ops/vit_mlp_pallas.py:116",
    },
    "fused_vit_attention": {
        "source": "affectgpt_tpu_torch/csrc/vit_attention.cu",
        "replaces": "affectgpt_tpu/ops/vit_attention_pallas.py:79",
    },
    "mlp_sublayer_fused": {
        "source": "affectgpt_tpu_torch/csrc/vit_mlp_fused.cu",
        "replaces": "affectgpt_tpu/ops/vit_mlp_fused_pallas.py:161",
    },
}
WRAPPERS = {"decode_qkv": decode_qkv, "decode_mlp_bf16": decode_mlp_bf16,
            "decode_attention": decode_attention, "decode_attn_o": decode_attn_o,
            "prefill_attention": prefill_attention,
            "int4_matmul_smallm": quant.int4_matmul_smallm, "int4_matmul": quant.int4_matmul,
            "int8_matmul": quant.int8_matmul, "int8_matmul_w8a8": quant.int8_matmul_w8a8,
            "paged_attention": paged_attention, "paged_attention_int8": paged_attention_int8,
            "decode_mlp": decode_mlp, "attn_sublayer": attn_sublayer,
            "mlp_sublayer": mlp_sublayer, "fused_vit_attention": fused_vit_attention,
            "mlp_sublayer_fused": mlp_sublayer_fused}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, nvcc=repr(nvcc), tf32="off")
    return smi


def phase_build(card: str) -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    say("build", library=path.name, seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))


def eager_ms(fn, flush: torch.Tensor, iters: int = 25, warmup: int = 3) -> float:
    """Median per-call time of eager calls, L2 flushed before each: the device
    timeline between two events, so it includes any wait for the host's
    Python to launch the call."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(calls, reps: int = 20) -> float:
    """Median device time per call, without host overhead: the calls are
    captured back to back in one CUDA graph, which is replayed `reps` times
    between CUDA events. Callers cycle through enough weight copies that
    every call reads its weights from device memory, not from the 50 MB L2."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up before capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    events = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = statistics.median(s.elapsed_time(e) for s, e in events) / len(calls)
    del graph
    return ms


def stage_ms(fn, reps: int = 10) -> dict:
    """Device ms a launch of each kernel that `fn` launches, by kernel name
    (torch.profiler over `reps` eager calls; the mean over the launches it
    recorded): a kernel's stages."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(2):  # a process's first profiler session may record no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0)
            if e.count and t:
                out[e.key.split("(")[0][-48:]] = round(t / e.count / 1000, 5)
        if out:
            break
    return out


def bound(nbytes: float, flops: float, ops_per_s: float = BF16_FLOP_PER_S) -> dict:
    """The least time the card could take for work that moves `nbytes` and
    does `flops` operations at `ops_per_s`, and which of the two bounds it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def compare(name: str, got, ref, b: int, extra_atol=None):
    """Largest absolute and relative error of the kernel's outputs against
    the plain version's; raises unless every element is within
    ATOL (+ extra_atol, an elementwise tensor, where given) + RTOL·|ref|."""
    got = [g.float() for g in (got if isinstance(got, tuple) else (got,))]
    ref = [r.float() for r in (ref if isinstance(ref, tuple) else (ref,))]
    max_abs = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    max_rel = max(float(((g - r).abs() / r.abs().clamp_min(ATOL)).max()) for g, r in zip(got, ref))
    for g, r in zip(got, ref):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} b={b}: non-finite kernel output")
        if extra_atol is None:
            torch.testing.assert_close(g, r, rtol=RTOL, atol=ATOL, msg=f"{name} b={b} disagrees")
            continue
        over = (g - r).abs() > ATOL + extra_atol + RTOL * r.abs()
        if bool(over.any()):
            raise AssertionError(f"{name} b={b} disagrees at {int(over.sum())} elements")
    return max_abs, max_rel


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |value| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


def bf16_acc_peak(x, s: dict, act: str) -> torch.Tensor:
    """Per output element, the largest |running sum| that
    mlp_sublayer_fused's bf16 accumulator rounds over its chunks, in the
    plain version's arithmetic. Where the kernel's and the plain f32 sums
    round one of these running sums differently, the one-ulp difference
    outlives the later chunks, so the bf16-accumulator check allows one ulp
    of this peak beyond the usual tolerance."""
    h = layernorm_rounded(x, s["lns"], s["lnb"], 1e-5)
    inter = s["wi"].shape[1]
    kc = inter // chunks_for(inter, vit_mlp_fused.K_CHUNKS)
    out = peak = None
    for c0 in range(0, inter, kc):
        t = activation(dot_f32(h, s["wi"][:, c0:c0 + kc]) + s["bi"][c0:c0 + kc].float(), act)
        part = dot_f32(t.to(x.dtype), s["wf"][c0:c0 + kc])
        out = (x.float() + s["bf"].float() + part if out is None
               else out.float() + part).to(x.dtype)
        peak = out.float().abs() if peak is None else torch.maximum(peak, out.float().abs())
    return peak


def rope_rows(t, cos, sin):
    """RoPE (half-split) on [b, heads, d] in f32, in library calls."""
    t1, t2 = t.float().chunk(2, dim=-1)
    return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin], dim=-1).to(t.dtype)


def library_qkv_chain(x, ln, wqkv, bqkv, cos, sin, cfg: qwen2.QwenConfig):
    """decode_qkv in library calls: rms_norm, one addmm for q/k/v with their
    biases, RoPE on q and k (a yardstick)."""
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    xn = torch.nn.functional.rms_norm(x, (x.shape[-1],), ln, cfg.rms_eps)
    q, k, v = torch.addmm(bqkv, xn, wqkv).split((nq, nkv, nkv), dim=-1)
    b = x.shape[0]
    return (rope_rows(q.view(b, cfg.num_heads, -1), cos, sin),
            rope_rows(k.view(b, cfg.num_kv_heads, -1), cos, sin), v)


def library_mlp_bf16_chain(x, ln, wgu, wd, eps: float):
    """decode_mlp_bf16 in library calls: rms_norm, one matmul for gate and
    up, silu * up, addmm of down onto the residual (a yardstick)."""
    xn = torch.nn.functional.rms_norm(x, (x.shape[-1],), ln, eps)
    g, u = (xn @ wgu).chunk(2, dim=-1)
    return torch.addmm(x, torch.nn.functional.silu(g) * u, wd)


def qwen_3b_config() -> qwen2.QwenConfig:
    """bench.py's default geometry (qwen_3b_config, bench.py:52-58): the
    LLM the bf16 decode kernels meet at b = 384."""
    return qwen2.QwenConfig(vocab_size=151936, hidden_size=2048, intermediate_size=11008,
                            num_layers=36, num_heads=16, num_kv_heads=2, head_dim=128)


def decode_variant(b: int, cfg: qwen2.QwenConfig, kind: str) -> dict:
    """The plan of the swap-AB wgmma kernel (csrc/decode_swapab.cuh) that
    decode_qkv (kind "qkv") or decode_mlp_bf16 ("gateup", "down") launches."""
    h, d = cfg.hidden_size, cfg.head_dim
    if kind == "qkv":
        plan = decode_qkv_plan(b, h, cfg.num_heads * d, cfg.num_kv_heads * d, d, sm_count(),
                               decode_gemm.active_clusters_on_card)
    else:
        plan = decode_mlp_bf16_plan(b, h, cfg.intermediate_size, sm_count(),
                                    decode_gemm.active_clusters_on_card)[kind]
    return {k: plan[k]
            for k in ("regime", "wgmma", "cb", "ck", "stages", "grid", "smem_bytes")}


def phase_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """The bf16 decode kernels against their plain versions at the main
    path's widths: Qwen2.5-7B at b = 8, 16 and 64, and bench.py's 3B at b =
    384; each call must give the same bits twice. Returns per-kernel
    {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}: the largest
    error over all checks, the times and bound at 7B, b = BATCH."""
    g = torch.Generator(device="cuda").manual_seed(7)
    dev, bf = "cuda", torch.bfloat16
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device=dev) * scale + shift).to(bf)

    out = {name: {"max_abs_err": 0.0} for name in ("decode_qkv", "decode_mlp_bf16")}
    for c, batches in ((cfg, (BATCH, 16, 64)), (qwen_3b_config(), (384,))):
        h, inter = c.hidden_size, c.intermediate_size
        nq, nkv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        geom = "7b" if c == cfg else "3b"
        # q/k/v weight sets whose replay cycle passes the 50 MB L2 (4 x 33 MB at
        # 7B, 8 x 12.6 MB at 3B); the MLP's 407 MB (135 MB at 3B) exceed it alone
        qkv_sets = [(rnd(h, nq, scale=0.02), rnd(nq, scale=0.1), rnd(h, nkv, scale=0.02),
                     rnd(nkv, scale=0.1), rnd(h, nkv, scale=0.02), rnd(nkv, scale=0.1))
                    for _ in range(4 if geom == "7b" else 8)]
        qkv_cat = [(torch.cat(ws[0::2], dim=1), torch.cat(ws[1::2])) for ws in qkv_sets]
        ln = rnd(h, scale=0.1, shift=1.0)
        wg, wu, wd = rnd(h, inter, scale=0.02), rnd(h, inter, scale=0.02), rnd(inter, h, scale=0.02)
        wgu = torch.cat([wg, wu], dim=1)
        qkv_kw = dict(num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
                      head_dim=c.head_dim, theta=c.rope_theta, eps=c.rms_eps)
        for b in batches:
            x = rnd(b, h)
            pos = torch.randint(0, 4097, (b,), generator=g, device=dev, dtype=torch.int32)

            def qkv(f, ln_scale=ln, ws=qkv_sets[0]):
                return f(x, pos, *ws, ln_scale=ln_scale, **qkv_kw)

            for ln_scale in (None, ln):
                got = qkv(decode_qkv, ln_scale)
                if not all(torch.equal(a, r) for a, r in zip(got, qkv(decode_qkv, ln_scale))):
                    raise AssertionError(f"decode_qkv {geom} b={b}: two calls differ")
                err, rel = compare("decode_qkv", got, qkv(decode_qkv_reference, ln_scale), b)
                out["decode_qkv"]["max_abs_err"] = max(out["decode_qkv"]["max_abs_err"], err)
                say("kernels", kernel="decode_qkv", geometry=geom, b=b,
                    ln=ln_scale is not None, max_abs_err=f"{err:.6g}", max_rel_err=f"{rel:.6g}",
                    rtol=RTOL, atol=ATOL)
            freqs = 1.0 / (c.rope_theta ** (torch.arange(0, c.head_dim, 2, device=dev)
                                            / c.head_dim))
            angles = pos[:, None, None].float() * freqs
            cos, sin = torch.cos(angles), torch.sin(angles)
            times = {
                "ms": graph_ms([lambda ws=ws: qkv(decode_qkv, ws=ws) for ws in qkv_sets] * 3),
                "plain_ms": graph_ms([lambda ws=ws: qkv(decode_qkv_reference, ws=ws)
                                      for ws in qkv_sets]),
                "chain_ms": graph_ms([lambda wb=wb: library_qkv_chain(x, ln, *wb, cos, sin, c)
                                      for wb in qkv_cat] * 3),
                "eager_ms": eager_ms(lambda: qkv(decode_qkv), flush),
            }
            n_out = nq + 2 * nkv  # weights and biases, x and ln read; q, k, v written
            cost = bound(2 * (h * n_out + n_out + h + b * h + b * n_out) + 4 * b,
                         2 * b * h * n_out)
            say("kernels", kernel="decode_qkv", geometry=geom, b=b,
                **{k: f"{v:.4f}" for k, v in times.items()}, bound_ms=f"{cost['bound_ms']:.4f}",
                bound_by=cost["bound_by"], variant=json.dumps(decode_variant(b, c, "qkv")),
                card=repr(card))
            if geom == "7b" and b == BATCH:
                out["decode_qkv"].update(ms=times["ms"], plain_ms=times["plain_ms"],
                                         library_ms=None, **cost)

            def mlp(f):
                return f(x, ln, wg, wu, wd, eps=c.rms_eps)

            got = mlp(decode_mlp_bf16)
            if not torch.equal(got, mlp(decode_mlp_bf16)):
                raise AssertionError(f"decode_mlp_bf16 {geom} b={b}: two calls differ")
            err, rel = compare("decode_mlp_bf16", got, mlp(decode_mlp_bf16_reference), b)
            out["decode_mlp_bf16"]["max_abs_err"] = max(out["decode_mlp_bf16"]["max_abs_err"],
                                                        err)
            say("kernels", kernel="decode_mlp_bf16", geometry=geom, b=b,
                max_abs_err=f"{err:.6g}", max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)
            times = {
                "ms": graph_ms([lambda: mlp(decode_mlp_bf16)] * 8),
                "plain_ms": graph_ms([lambda: mlp(decode_mlp_bf16_reference)] * 2, reps=5),
                "chain_ms": graph_ms([lambda: library_mlp_bf16_chain(x, ln, wgu, wd, c.rms_eps)]
                                     * 8),
                "eager_ms": eager_ms(lambda: mlp(decode_mlp_bf16), flush),
            }
            cost = bound(2 * (3 * h * inter + h + 2 * b * h), 6 * b * h * inter)
            say("kernels", kernel="decode_mlp_bf16", geometry=geom, b=b,
                **{k: f"{v:.4f}" for k, v in times.items()}, bound_ms=f"{cost['bound_ms']:.4f}",
                bound_by=cost["bound_by"],
                variant=json.dumps({"gateup": decode_variant(b, c, "gateup"),
                                    "down": decode_variant(b, c, "down")}), card=repr(card))
            if geom == "7b" and b == BATCH:
                out["decode_mlp_bf16"].update(ms=times["ms"], plain_ms=times["plain_ms"],
                                              library_ms=None, **cost)
        del qkv_sets, qkv_cat, wg, wu, wd, wgu
        torch.cuda.empty_cache()
    return out


def decode_window_mask(g: torch.Generator, b: int, t_len: int) -> torch.Tensor:
    """Valid cache columns of a decode step, [b, T] bool: left pads (0-19
    columns) invalid, then valid through a write index in [T - 95, T - 2]."""
    lo = torch.randint(0, 20, (b,), generator=g, device="cuda")
    hi = torch.randint(t_len - 95, t_len - 1, (b,), generator=g, device="cuda")
    cols = torch.arange(t_len, device="cuda")
    return (cols[None, :] >= lo[:, None]) & (cols[None, :] <= hi[:, None])


def segment_runs(g: torch.Generator, b: int, t: int) -> torch.Tensor:
    """[b, t] int32 segment ids in six runs of ids 0-3 (a shuffled order in
    which two ids come back after others), run ends drawn at random."""
    ends = torch.sort(torch.randint(1, t, (b, 5), generator=g, device="cuda"), dim=1).values
    run = (torch.arange(t, device="cuda")[None, :, None] >= ends[:, None, :]).sum(-1)
    ids = torch.stack([torch.randperm(4, generator=g, device="cuda")[[0, 1, 2, 0, 3, 1]]
                       for _ in range(b)])
    return torch.gather(ids, 1, run).to(torch.int32)


def prefill_variant(b: int, t: int, heads: int, kv: int, d: int, seg: torch.Tensor) -> dict:
    """What prefill_attention launches: its units and persistent grid, and
    the (query tile, key tile) classes of these segment ids."""
    plan = prefill_plan(b, t, heads, kv, d, sm_count(), segment_ids=seg)
    causal = torch.ones(plan["q_tiles"], plan["q_tiles"], dtype=torch.bool).tril()
    return {"products": "wgmma SS (QK^T) + RS (PV), TMA ring of 4, persistent",
            "units": len(plan["units"]), "blocks": plan["blocks"],
            **{f"{name}_tiles": int(((plan["classes"] == c) & causal).sum())
               for name, c in (("skip", SKIP), ("full", FULL), ("masked", MASKED))},
            "kv_tiles_loaded": plan["kv_tiles_loaded"]}


def server_mask(g: torch.Generator, b: int, t_len: int) -> torch.Tensor:
    """The dense BatchServer's decode mask, [b, T] bool: columns [0, pos] of
    each slot valid, slots 1 and 3 inactive (no valid column)."""
    pos = torch.randint(0, t_len, (b,), generator=g, device="cuda")
    mask = torch.arange(t_len, device="cuda")[None, :] <= pos[:, None]
    mask[[1, 3]] = False
    return mask


def attention_variant(b: int, kv: int, g: int, d: int, t_len: int) -> dict:
    """What decode_attention launches: its key rule (all tiles of a row, or
    its window's), splits a (row, kv head) pair, ring and grid."""
    plan = decode_attention_module.decode_attention_plan(b, kv, g, d, t_len, sm_count())
    return {"attention": f"mma.sync, TMA ring of {plan['stages']}, cluster of "
                         f"{plan['splits']} a (row, kv head), grid {plan['grid'][0]}",
            "keys": decode_attention_module.KEYS[plan["keys"]]}


def attn_o_variant(b: int, kv: int, g: int, d: int, t_len: int, h: int) -> dict:
    """What decode_attn_o launches: the attention's splits a (row, kv head)
    pair, ring and grid, and o_proj's swap-AB plan on the card."""
    plan = decode_attn_o_module.decode_attn_o_plan(b, kv, g, d, t_len, h, sm_count(),
                                                   decode_gemm.active_clusters_on_card)
    a, o = plan["attention"], plan["o_proj"]
    return {"attention": f"mma.sync, TMA ring of {a['stages']}, cluster of {a['splits']} a "
                         f"(row, kv head), grid {a['grid'][0]}",
            "o_proj": {k: o[k] for k in ("wgmma", "cb", "ck", "stages", "grid")}}


def phase_attention_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """The attention kernels against their plain versions at the main path's
    widths, T = 640 and 577 (not a multiple of the 16-column tile) for the
    decode kernels, prompt lengths 545-564 for the prefill. Returns
    per-kernel {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by}:
    the largest error over all checks, and device times per call at b = BATCH
    (T = 640 for the decode kernels)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    kv, d, h = cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
    heads, groups = cfg.num_heads, cfg.num_heads // cfg.num_kv_heads
    nq = heads * d
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    out = {name: {"max_abs_err": 0.0}
           for name in ("decode_attention", "decode_attn_o", "prefill_attention")}

    def check(name, got, ref, b, **shape):
        err, rel = compare(name, got, ref, b)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        say("kernels", kernel=name, b=b, **shape, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)

    def record(name, b, calls, plain_calls, library_calls, nbytes, flops, library_err=None,
               **extra):
        times = {"ms": graph_ms(calls), "plain_ms": graph_ms(plain_calls),
                 "library_ms": graph_ms(library_calls) if library_calls else None}
        cost = bound(nbytes, flops)
        say("kernels", kernel=name, b=b,
            **{k: "null" if v is None else f"{v:.4f}" for k, v in times.items()},
            bound_ms=f"{cost['bound_ms']:.5f}", bound_by=cost["bound_by"],
            tflops=f"{flops / times['ms'] / 1e9:.1f}", **extra, card=repr(card))
        if library_calls:
            say("library", kernel=name, b=b, call="scaled_dot_product_attention(enable_gqa=True)",
                library_ms=f"{times['library_ms']:.4f}",
                max_abs_err_vs_plain=f"{library_err:.6g}", card=repr(card))
        if b == BATCH:
            out[name].update(times, **cost)

    for b in (BATCH, 64):
        for t_len in (MAX_LEN, 577):
            q = rnd(b, kv, groups, d)
            mask = decode_window_mask(g, b, t_len)
            x = rnd(b, h)
            set_bytes = 2 * b * kv * t_len * d * 2 + nq * h * 2
            copies = max(2, -(-64 * 2**20 // set_bytes))  # > 50 MB of L2 per replay cycle
            sets = [(rnd(b, kv, t_len, d), rnd(b, kv, t_len, d), rnd(nq, h, scale=0.02))
                    for _ in range(copies)]
            k, v, wo = sets[0]
            got = decode_attention(q, k, v, mask)
            if not torch.equal(got, decode_attention(q, k, v, mask)):
                raise AssertionError(f"decode_attention b={b} T={t_len}: two calls differ")
            check("decode_attention", got, decode_attention_reference(q, k, v, mask), b,
                  T=t_len, variant=json.dumps(attention_variant(b, kv, groups, d, t_len)))
            smask = server_mask(g, b, t_len)  # BatchServer's: inactive slots give zeros
            got = decode_attention(q, k, v, smask)
            if got[~smask.any(dim=1)].any():
                raise AssertionError(f"decode_attention b={b} T={t_len}: inactive rows not 0")
            check("decode_attention", got, decode_attention_reference(q, k, v, smask), b,
                  T=t_len, masks="server", inactive_rows_zero=True)
            got = decode_attn_o(x, q, k, v, mask, wo)
            if not torch.equal(got, decode_attn_o(x, q, k, v, mask, wo)):
                raise AssertionError(f"decode_attn_o b={b} T={t_len}: two calls differ")
            check("decode_attn_o", got, decode_attn_o_reference(x, q, k, v, mask, wo), b,
                  T=t_len, variant=json.dumps(attn_o_variant(b, kv, groups, d, t_len, h)))
            if t_len != MAX_LEN:
                continue
            valid = int(mask.sum())  # valid (row, column) pairs: the K/V rows needed
            kv_bytes = 2 * valid * kv * d * 2
            qk_pv_flops = 4 * valid * kv * groups * d
            q4, mask4 = q.reshape(b, heads, 1, d), mask[:, None, None, :]
            lib_err = float((sdpa(q4, k, v, attn_mask=mask4, enable_gqa=True).reshape(q.shape)
                             .float() - decode_attention_reference(q, k, v, mask).float())
                            .abs().max())
            reps = max(1, 24 // copies)
            record("decode_attention", b,
                   [lambda k=k, v=v: decode_attention(q, k, v, mask) for k, v, _ in sets] * reps,
                   [lambda k=k, v=v: decode_attention_reference(q, k, v, mask)
                    for k, v, _ in sets] * reps,
                   [lambda k=k, v=v: sdpa(q4, k, v, attn_mask=mask4, enable_gqa=True)
                    for k, v, _ in sets] * reps,
                   kv_bytes + 2 * 2 * q.numel() + b * t_len, qk_pv_flops, lib_err,
                   variant=json.dumps(attention_variant(b, kv, groups, d, t_len)),
                   stages=json.dumps(stage_ms(lambda: decode_attention(q, k, v, mask))))
            record("decode_attn_o", b,
                   [lambda k=k, v=v, wo=wo: decode_attn_o(x, q, k, v, mask, wo)
                    for k, v, wo in sets] * reps,
                   [lambda k=k, v=v, wo=wo: decode_attn_o_reference(x, q, k, v, mask, wo)
                    for k, v, wo in sets] * reps,
                   None, kv_bytes + 2 * (q.numel() + nq * h + 2 * b * h) + b * t_len,
                   qk_pv_flops + 2 * b * nq * h,
                   stages=json.dumps(stage_ms(lambda: decode_attn_o(x, q, k, v, mask, wo))))
            # its library chain: SDPA, then addmm of o_proj onto the residual
            chain = graph_ms([lambda k=k, v=v, wo=wo: torch.addmm(
                x, sdpa(q4, k, v, attn_mask=mask4, enable_gqa=True).reshape(b, nq), wo)
                for k, v, wo in sets] * reps)
            say("kernels", kernel="decode_attn_o", b=b, chain_ms=f"{chain:.4f}", card=repr(card))
            del sets, k, v, wo

        # prefill: prompts of 545-564 tokens left-packed into t = 564; then
        # segment ids in runs whose ids come back after others (t = 564, and
        # t = 37 below one 64-row tile)
        t_len = 564
        for t_runs in (t_len, 37):
            q, k, v = rnd(b, t_runs, heads, d), rnd(b, kv, t_runs, d), rnd(b, kv, t_runs, d)
            runs = segment_runs(g, b, t_runs)
            check("prefill_attention", prefill_attention(q, k, v, runs),
                  prefill_attention_reference(q, k, v, runs), b, t=t_runs,
                  segments="runs of ids 0-3, ids coming back")
        lengths = torch.randint(545, t_len + 1, (b,), generator=g, device="cuda")
        seg = torch.arange(t_len, device="cuda")[None, :] >= (t_len - lengths)[:, None]
        q, k, v = rnd(b, t_len, heads, d), rnd(b, kv, t_len, d), rnd(b, kv, t_len, d)
        got = prefill_attention(q, k, v, seg)
        if not torch.equal(got, prefill_attention(q, k, v, seg)):
            raise AssertionError(f"prefill_attention b={b}: two calls differ")
        check("prefill_attention", got, prefill_attention_reference(q, k, v, seg), b, t=t_len,
              lengths=f"{int(lengths.min())}-{int(lengths.max())}")
        causal = torch.ones((t_len, t_len), dtype=torch.bool, device="cuda").tril()
        visible = causal[None] & (seg[:, :, None] == seg[:, None, :])  # [b, query, key]
        pairs = int(visible.sum())
        qh, vis4 = q.transpose(1, 2), visible[:, None]
        lib_err = float((sdpa(qh, k, v, attn_mask=vis4, enable_gqa=True).transpose(1, 2)
                         .reshape(b, t_len, nq).float()
                         - prefill_attention_reference(q, k, v, seg).float()).abs().max())
        record("prefill_attention", b, [lambda: prefill_attention(q, k, v, seg)] * 4,
               [lambda: prefill_attention_reference(q, k, v, seg)] * 2,
               [lambda: sdpa(qh, k, v, attn_mask=vis4, enable_gqa=True)] * 2,
               2 * (q.numel() + k.numel() + v.numel() + b * t_len * nq) + b * t_len,
               4 * d * heads * pairs, lib_err,
               variant=json.dumps(prefill_variant(b, t_len, heads, kv, d, seg.cpu())))
        del q, k, v, qh, visible, vis4
        torch.cuda.empty_cache()
    return out


def layer_shapes(cfg: qwen2.QwenConfig, fused: bool) -> dict:
    """(K, N) of one decoder layer's products, split or fused layout."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    nq, nkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    if fused:
        return {"qkv_proj": (h, nq + 2 * nkv), "o_proj": (nq, h), "gateup_proj": (h, 2 * inter),
                "down_proj": (inter, h)}
    return {"q_proj": (h, nq), "k_proj": (h, nkv), "v_proj": (h, nkv), "o_proj": (nq, h),
            "gate_proj": (h, inter), "up_proj": (h, inter), "down_proj": (inter, h)}


# kernel: (weight bits, plain version, the M checked, the main path's M, its
# layer layout is fused, its operation rate)
QUANT_PHASE = {
    "int4_matmul_smallm": (4, quant.int4_matmul_smallm_reference, (1, 8, 13), 8, False,
                           BF16_FLOP_PER_S),
    "int4_matmul": (4, quant.int4_matmul_reference, (16, 40, 64, 1000), 16, False,
                    BF16_FLOP_PER_S),
    "int8_matmul": (8, quant.int8_matmul_reference, tuple(range(1, 17)) + (40, 64, 1000), 8, True,
                    BF16_FLOP_PER_S),
    "int8_matmul_w8a8": (8, quant.int8_matmul_w8a8_reference, (8, 4512), 8, False,
                         S8_OPS_PER_S),
}


SWAPAB_MODES = {"int4_matmul": quant.MODE_INT4, "int4_matmul_smallm": quant.MODE_INT4_DEQUANT,
                "int8_matmul": quant.MODE_INT8}


def swapab_variant(name: str, m: int, n: int, k: int) -> dict:
    """What an int4 or int8 weight-only wrapper launches for x [m, k]: at M
    <= 16 the swap-AB kernel with its plan (n8 tiles, cluster size, grid,
    ring, shared memory), above it quant_mma.cuh's 128 x 64 tile."""
    if m > quant.SWAPAB_MAX_M:
        return {"variant": "quant_mma_128x64"}
    plan = quant._swapab_plan_on(0, m, n, k, SWAPAB_MODES[name])
    return {"variant": f"swapab_mma_m16n8k16_nt{plan['nt']}", "cluster": plan["cluster"],
            "grid": plan["grid"][0], "stages": plan["stages"], "smem": plan["smem_bytes"]}


def w8a8_variant(m: int, n: int, k: int) -> dict:
    """What the w8a8 wrapper launches for x [m, k] @ w [k, n]: the wgmma
    N-width (row tile), the K splits and the bytes its product reads."""
    plan = quant.w8a8_plan(m, n, k, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"variant": f"wgmma_m64n{plan['bm']}k32_s8", "splits": plan["splits"],
            "l2_read_bytes": plan["l2_bytes"]}


def phase_quant_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """The quantized matmuls against their plain versions at every (K, N) of
    the 7B split and fused layouts and the lm_head, with random int8 bytes
    or int4 nibbles and random positive scales (so a wrong scale row shows).
    Returns per-kernel {max_abs_err, ms, plain_ms, bf16_cublas_ms, bound_ms,
    bound_by, library_ms}: device times summed over one decoder layer's
    products at the main path's M, each product timed alone (CUDA graph,
    enough weight copies per replay to exceed the 50 MB L2)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    shapes = {**layer_shapes(cfg, False), **layer_shapes(cfg, True),
              "lm_head": (cfg.hidden_size, cfg.vocab_size)}
    by_kn = {}
    for name, kn in shapes.items():
        by_kn.setdefault(kn, []).append(name)

    def weights(bits, k, n):
        sigma = k ** -0.5
        if bits == 4:
            w = torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda",
                              dtype=torch.int8)
            s = (torch.rand((k // quant.INT4_GROUP, n), generator=g, device="cuda") + 0.5) \
                * (3 * sigma / 7)
        else:
            w = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
            s = (torch.rand((1, n), generator=g, device="cuda") + 0.5) * (3 * sigma / 127)
        return w, s

    def dequant_bf16(bits, w, s):
        if bits == 4:
            return quant._int4_dequant(w, s).to(torch.bfloat16)
        return (w.float() * s).to(torch.bfloat16)

    stored = {bits: {kn: weights(bits, *kn) for kn in by_kn} for bits in (4, 8)}
    out = {}
    for name, (bits, plain, ms_checked, m_path, fused, ops_rate) in QUANT_PHASE.items():
        kernel = getattr(quant, name)
        err_max = 0.0
        for (k, n), names in by_kn.items():
            w, s = stored[bits][(k, n)]
            for m in ms_checked:
                x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
                got = kernel(x, w, s)
                err, rel = compare(name, got, plain(x, w, s), m)
                err_max = max(err_max, err)
                extra = {}
                # the redesigns: the same bits twice, and what ran
                if not torch.equal(got, kernel(x, w, s)):
                    raise AssertionError(f"{name} M={m} K={k} N={n}: two calls differ")
                extra = (w8a8_variant(m, n, k) if name == "int8_matmul_w8a8"
                         else swapab_variant(name, m, n, k))
                say("kernels", kernel=name, M=m, K=k, N=n, shapes="/".join(names),
                    max_abs_err=f"{err:.6g}", max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL,
                    **extra)
        # the main path's M first; w8a8 also at its prefill M, int4_matmul at
        # bench.py's 7B batch (M = 256, a measurement only), int8_matmul at
        # paged_w8's M = 16 on the split layout's attention products; both
        # weight-only kernels at the speculative verify's M = SPEC_M over the
        # split layer (phase 7's spec_q4 runs int4_matmul there)
        extra_m = {"int8_matmul_w8a8": (max(ms_checked),), "int4_matmul": (256, SPEC_M),
                   "int8_matmul": (16, SPEC_M)}.get(name, ())
        per_layer = []
        for m in (m_path, *extra_m):
            layer = layer_shapes(cfg, fused)
            if name == "int8_matmul" and m == 16:
                layer = {p: kn for p, kn in layer_shapes(cfg, False).items()
                         if p in ("q_proj", "k_proj", "v_proj", "o_proj")}
            elif m == SPEC_M:
                layer = layer_shapes(cfg, False)
            sums = dict.fromkeys(("ms", "plain_ms", "bf16_cublas_ms"), 0.0)
            nbytes = flops = 0
            for pname, (k, n) in {**layer, "lm_head": shapes["lm_head"]}.items():
                w, s = stored[bits][(k, n)]
                x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
                wbytes = w.numel() + s.numel() * 4  # packed weight and its f32 scales
                copies = max(1, -(-64 * 2**20 // wbytes))
                ws = [(w, s)] + [(w.clone(), s.clone()) for _ in range(copies - 1)]
                wb = dequant_bf16(bits, w, s)
                bcopies = max(1, -(-64 * 2**20 // (wb.numel() * 2)))
                wbs = [wb] + [wb.clone() for _ in range(bcopies - 1)]
                times = {
                    "ms": graph_ms([lambda w=w, s=s: kernel(x, w, s) for w, s in ws]
                                   * max(1, -(-8 // copies))),
                    "plain_ms": graph_ms([lambda: plain(x, w, s)] * 2, reps=5),
                    "bf16_cublas_ms": graph_ms([lambda wb=wb: torch.matmul(x, wb) for wb in wbs]
                                               * max(1, -(-8 // bcopies))),
                }
                moved, ops = 2 * m * k + wbytes + 2 * m * n, 2 * m * k * n
                cost = bound(moved, ops, ops_rate)
                say("kernels", kernel=name, M=m, product=pname, K=k, N=n,
                    **{key: f"{v:.5f}" for key, v in times.items()},
                    bound_ms=f"{cost['bound_ms']:.5f}", bound_by=cost["bound_by"],
                    GB_per_s=f"{moved / times['ms'] / 1e6:.1f}",
                    **(w8a8_variant(m, n, k) if name == "int8_matmul_w8a8" else
                       swapab_variant(name, m, n, k)),
                    card=repr(card))
                if pname != "lm_head":
                    for key in sums:
                        sums[key] += times[key]
                    nbytes, flops = nbytes + moved, flops + ops
                del ws, wbs, wb
            sums.update(bound(nbytes, flops, ops_rate))
            say("kernels", kernel=name, M=m, per="decoder layer (" + ", ".join(layer) + ")",
                **{key: f"{v:.5f}" if isinstance(v, float) else v for key, v in sums.items()},
                card=repr(card))
            per_layer.append(sums)
        out[name] = {"max_abs_err": err_max, "library_ms": None, **per_layer[0]}
        torch.cuda.empty_cache()
    del stored
    torch.cuda.empty_cache()
    return out


SERVE_SLOTS = 16
PAGE = 16  # block size of the paged engine (inference_hybird.py's default)
POOL_BLOCKS = 2048  # its pool, blocks per layer


def paged_case(g: torch.Generator, cfg: qwen2.QwenConfig, width: int, int8: bool) -> tuple:
    """The serve phase's decode attention: 16 rows of 545-596 tokens, one of
    1 token and one of exactly one page, over pools of 2048 blocks; each row's
    pages drawn from a shuffled permutation, distinct across the rows and
    the three table sets of each of two pools (a replay cycle of the six
    calls reads more than the 50 MB L2). Returns ([(q, pool_k, pool_v,
    tables, lens, scales)] for every pool and table set, valid tokens per
    call)."""
    kv, d, heads = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    shape = (POOL_BLOCKS, PAGE, kv, d)
    lens = torch.randint(545, 597, (SERVE_SLOTS,), generator=g, device="cuda")
    lens[0], lens[1] = 1, PAGE
    lens = lens.clamp(max=width * PAGE).to(torch.int32)
    q = (torch.randn((SERVE_SLOTS, heads, d), generator=g, device="cuda")).to(torch.bfloat16)
    pages = [-(-int(n) // PAGE) for n in lens]
    cases = []
    for _ in range(2):
        if int8:
            pool_k, pool_v = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                            dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(shape[:3], generator=g, device="cuda") * (4.0 / 127)
                           for _ in range(2))
        else:
            pool_k, pool_v = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                              for _ in range(2))
            scales = ()
        perm = (torch.randperm(POOL_BLOCKS - 1, generator=g, device="cuda") + 1).tolist()
        for t in range(3):
            tables = torch.zeros((SERVE_SLOTS, width), dtype=torch.int32)
            used = t * sum(pages)
            for r, n in enumerate(pages):
                tables[r, :n] = torch.tensor(perm[used:used + n], dtype=torch.int32)
                used += n
            cases.append((q, pool_k, pool_v, tables.to(q.device), lens, scales))
    return cases, int(lens.sum())


def card_clocks() -> str:
    """The card's SM clock, temperature and power draw now, as nvidia-smi
    reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=True).stdout.strip()


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def decode_mlp_variant(b: int, h: int, inter: int) -> dict:
    """What decode_mlp launches for x [b, h]: the tensor-core tiles, the
    rings, the grids and the bytes it reads from L2."""
    plan = decode_mlp_plan(b, h, inter, sm_count())
    a, d = plan["gateup"], plan["down"]
    return {"products": "mma.sync m16n8k16 bf16, int8 to bf16 in registers, batch as N",
            "gateup_tile": f"16 rows x {a['strip']} cols x {a['stage_k']} k",
            "gateup_stages": a["stages"], "gateup_grid": list(a["grid"]),
            "down_tile": f"16 rows x {d['strip']} cols x {d['stage_k']} k",
            "down_stages": d["stages"], "down_cluster": d["cluster"],
            "down_grid": list(d["grid"]), "l2_read_bytes": plan["l2_bytes"]}


def phase_serving_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """The serving slice's kernels against their plain versions at 7B
    widths: paged attention for both pool dtypes at table widths 38 (the
    serve phase's max_blocks_per_seq) and 64 (a power-of-two bucket), with
    each width's launch plan and the same bits from a second call, and
    the int8 decode MLP at b = 8, 16 and 64 on int8 weights of the 7B
    layer. Returns per-kernel {max_abs_err, ms, plain_ms, library_ms,
    bound_ms, bound_by} with the times at the serve phase's shapes (16 rows,
    width 38; b = 16)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    kv, d, heads = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    out = {name: {"max_abs_err": 0.0, "library_ms": None}
           for name in ("paged_attention", "paged_attention_int8", "decode_mlp")}
    max_blocks = -(-(564 + NEW_TOKENS) // PAGE)  # 38
    for int8 in (False, True):
        name = "paged_attention_int8" if int8 else "paged_attention"
        kernel = paged_attention_int8 if int8 else paged_attention
        for width in (max_blocks, 64):
            cases, valid = paged_case(g, cfg, width, int8)
            plan = paged_plan(SERVE_SLOTS, kv, heads // kv, d, PAGE, width, int8, sm_count())
            for case in cases[:2]:
                q, pk, pv, tables, lens, scales = case
                got = kernel(q, pk, pv, tables, lens, *scales)
                if not torch.equal(got, kernel(q, pk, pv, tables, lens, *scales)):
                    raise AssertionError(f"{name} width={width}: two calls differ")
                err, rel = compare(name, got,
                                   paged_attention_reference(q, pk, pv, tables, lens, *scales),
                                   SERVE_SLOTS)
                out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
                say("kernels", kernel=name, b=SERVE_SLOTS, width=width, tokens=valid,
                    lens=f"{int(lens.min())}-{int(lens.max())}", max_abs_err=f"{err:.6g}",
                    max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL,
                    variant=json.dumps({"products": "mma.sync m16n8k16 bf16, S^T = K Q^T, "
                                        "Out^T = V^T P^T, one launch", "splits": plan["splits"],
                                        "cluster": plan["cluster"], "grid": plan["grid"][0],
                                        "stages": plan["stages"],
                                        "smem": plan["smem_bytes"]}))
            elem = 1 if int8 else 2
            # the valid tokens' K and V rows (+ int8 scales), q, out, tables, lens
            nbytes = (valid * kv * d * 2 * elem + (valid * kv * 2 * 4 if int8 else 0)
                      + 2 * 2 * SERVE_SLOTS * heads * d + 4 * SERVE_SLOTS * (width + 1))
            times = {"ms": graph_ms([lambda c=c: kernel(*c[:5], *c[5]) for c in cases] * 4),
                     "plain_ms": graph_ms([lambda c=c: paged_attention_reference(*c[:5], *c[5])
                                           for c in cases]),
                     # the gather chain PAGED_ATTENTION="xla" runs (inference/paged.py)
                     "chain_ms": graph_ms([lambda c=c: paged.paged_attention(*c[:5], kv, *c[5])
                                           for c in cases])}
            if not int8 and width == max_blocks:  # the same graph's calls again, right after
                times["ms_repeat"] = graph_ms([lambda c=c: kernel(*c[:5], *c[5])
                                               for c in cases] * 4)
            cost = bound(nbytes, 4 * valid * heads * d)
            say("kernels", kernel=name, b=SERVE_SLOTS, width=width,
                **{k: f"{v:.5f}" for k, v in times.items()}, bound_ms=f"{cost['bound_ms']:.5f}",
                bound_by=cost["bound_by"], GB_per_s=f"{nbytes / times['ms'] / 1e6:.1f}",
                library="none: no single PyTorch call reads a block table; chain_ms is the "
                "gather chain", clocks=repr(card_clocks()), card=repr(card))
            if width == max_blocks:
                out[name].update({k: v for k, v in times.items() if k != "ms_repeat"}, **cost)
            del cases
        torch.cuda.empty_cache()
    # the first paged timing again, on the same data (the generator's seed),
    # after the others: the bf16 kernel at width 38 is the phase's first
    # timing, taken right after the quantized kernels' phase
    cases, _ = paged_case(torch.Generator(device="cuda").manual_seed(17), cfg, max_blocks, False)
    again = graph_ms([lambda c=c: paged_attention(*c[:5], *c[5]) for c in cases] * 4)
    say("kernels", kernel="paged_attention", b=SERVE_SLOTS, width=max_blocks,
        ms_again=f"{again:.5f}", clocks=repr(card_clocks()), card=repr(card))
    del cases
    torch.cuda.empty_cache()

    h, inter = cfg.hidden_size, cfg.intermediate_size
    leaves = []
    for k, n in ((h, inter), (h, inter), (inter, h)):
        leaves += quant.quantize_per_channel(torch.randn(k, n, generator=g, device="cuda")
                                             * k ** -0.5)
    ln = (torch.randn(h, generator=g, device="cuda") * 0.1 + 1.0).to(torch.bfloat16)
    dequant = [(w.float() * s).to(torch.bfloat16) for w, s in zip(leaves[::2], leaves[1::2])]
    for b in (8, SERVE_SLOTS, 64):
        x = torch.randn((b, h), generator=g, device="cuda").to(torch.bfloat16)
        args = (x, ln, *leaves)
        got = decode_mlp(*args)
        if not torch.equal(got, decode_mlp(*args)):
            raise AssertionError(f"decode_mlp b={b}: two calls differ")
        err, rel = compare("decode_mlp", got, decode_mlp_reference(*args), b)
        out["decode_mlp"]["max_abs_err"] = max(out["decode_mlp"]["max_abs_err"], err)
        say("kernels", kernel="decode_mlp", b=b, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL)
        wg, wu, wd = dequant

        def cublas():  # three products and silu·up on bf16 weights, no norm: a yardstick
            return torch.matmul(torch.nn.functional.silu(x @ wg) * (x @ wu), wd)

        times = {"ms": graph_ms([lambda: decode_mlp(*args)] * 8),
                 # the previous CUDA-core design, the C entry's variant 2 (counted nowhere)
                 "old_ms": graph_ms([lambda: decode_mlp_module._launch(args, 2, 1e-6)] * 8),
                 "plain_ms": graph_ms([lambda: decode_mlp_reference(*args)] * 2, reps=5),
                 "bf16_cublas_ms": graph_ms([cublas] * 4)}
        variant = {**decode_mlp_variant(b, h, inter),  # variant 1: no tensor-core products
                   "no_products_ms": graph_ms([lambda: decode_mlp_module._launch(args, 1, 1e-6)]
                                              * 8)}
        nbytes = 3 * h * inter + 4 * (2 * inter + h) + 2 * (h + 2 * b * h)
        cost = bound(nbytes, 6 * b * h * inter)
        say("kernels", kernel="decode_mlp", b=b, **{k: f"{v:.5f}" for k, v in times.items()},
            bound_ms=f"{cost['bound_ms']:.5f}", bound_by=cost["bound_by"],
            GB_per_s=f"{nbytes / times['ms'] / 1e6:.1f}",
            library="none: no single PyTorch call does the fused int8 MLP",
            variant=json.dumps(variant), card=repr(card))
        if b == SERVE_SLOTS:
            out["decode_mlp"].update(ms=times["ms"], plain_ms=times["plain_ms"], **cost)
    del leaves, dequant
    torch.cuda.empty_cache()
    return out


ENCODER_B = 64  # images (8 clips x 8 frames) or audio clips (8 x 8) per tower call
RT_SAMPLES = 32000  # an audio clip: 2 s at 16 kHz
ATTN_KEYS = ("lns", "lnb", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
MLP_KEYS = ("lns", "lnb", "wi", "bi", "wf", "bf")


def encoder_layers(g: torch.Generator, w: int, inter: int, copies: int) -> list:
    """`copies` random bf16 encoder layers (LN near 1, the towers' scales),
    each with the concatenated q/k/v weight of the library chain."""
    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(torch.bfloat16)

    layers = []
    for _ in range(copies):
        s = {"lns": rnd(w, scale=0.1, shift=1.0), "lnb": rnd(w, scale=0.1),
             **{k: rnd(w, w, scale=0.02) for k in ("wq", "wk", "wv", "wo")},
             **{k: rnd(w, scale=0.1) for k in ("bq", "bk", "bv", "bo")},
             "wi": rnd(w, inter, scale=0.02), "bi": rnd(inter, scale=0.1),
             "wf": rnd(inter, w, scale=0.02), "bf": rnd(w, scale=0.1)}
        s["wqkv"] = torch.cat([s["wq"], s["wk"], s["wv"]], dim=1)
        s["bqkv"] = torch.cat([s["bq"], s["bk"], s["bv"]])
        layers.append(s)
    return layers


def library_attn_chain(x, s, heads: int, key_mask):
    """The attention sublayer in library calls: layer_norm, one addmm for
    q/k/v, SDPA with the bool key mask, addmm + residual (a yardstick)."""
    b, n, w = x.shape
    h = torch.nn.functional.layer_norm(x, (w,), s["lns"], s["lnb"], 1e-5)
    qkv = torch.addmm(s["bqkv"], h.view(-1, w), s["wqkv"]).view(b, n, 3, heads, w // heads)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    return torch.addmm(s["bo"], o.transpose(1, 2).reshape(-1, w), s["wo"]).view_as(x) + x


def library_mlp_chain(x, s, act: str):
    """The MLP sublayer in library calls: layer_norm, addmm, the activation,
    addmm + residual (a yardstick)."""
    w = x.shape[-1]
    h = torch.nn.functional.layer_norm(x, (w,), s["lns"], s["lnb"], 1e-5).view(-1, w)
    t = torch.addmm(s["bi"], h, s["wi"])
    t = torch.nn.functional.gelu(t) if act == "gelu" else t * torch.sigmoid(1.702 * t)
    return torch.addmm(s["bf"], t, s["wf"]).view_as(x) + x


def hubert_frames(acfg: hubert.HubertConfig, samples: int) -> int:
    """Frames the conv frontend makes of `samples` audio samples."""
    for k, s in zip(acfg.conv_kernel, acfg.conv_stride):
        samples = (samples - k) // s + 1
    return samples


def encoder_configs(cfg: affectgpt.AffectGPTConfig) -> tuple:
    """(visual spec, its config, acoustic spec, its config) as
    encode_media_features resolves them."""
    vspec = encoders.get_visual_encoder(cfg.visual_encoder_name)
    aspec = encoders.get_acoustic_encoder(cfg.acoustic_encoder_name)
    return (vspec, cfg.vision_cfg_override or vspec.make_config(),
            aspec, cfg.audio_cfg_override or aspec.make_config())


def mlp_variant(rows: int, w: int, inter: int) -> dict:
    """What mlp_sublayer launches for `rows` rows: the GEMMs' wgmma tile,
    ring, cluster and persistent grid, and the bytes their blocks read from
    L2."""
    plan = vit_mlp.mlp_plan(rows, w, inter, sm_count())
    fc1, fc2 = plan["fc1"], plan["fc2"]
    return {"products": "wgmma m64n256k16 bf16, TMA ring, persistent",
            "tile": "x".join(map(str, fc1["tile"])) + f"x{fc1['stage_k']}",
            "stages": fc1["stages"], "cluster": fc1["cluster"], "blocks": plan["blocks"],
            "fc1_tiles": fc1["n_tiles"] * fc1["m_tiles"],
            "fc2_tiles": fc2["n_tiles"] * fc2["m_tiles"],
            "l2_read_bytes": fc1["l2_bytes"] + fc2["l2_bytes"]}


def sublayer_variant(rows: int, w: int) -> dict:
    """What attn_sublayer launches for `rows` rows: q/k/v as one launch of
    three products and o, each on the wgmma GEMM (tile, cluster, units, the
    rounds of units its clusters take, grid)."""
    plan = attn_sublayer_plan(rows, w, sm_count())
    return {name: {"tile": "x".join(map(str, p["tile"])), "cluster": p["cluster"],
                   "units": p["units"], "rounds": round(p["rounds"], 3), "grid": p["grid"][0]}
            for name, p in (("qkv", plan["qkv"]), ("o", plan["o"]))}


def fused_variant(rows: int, w: int, inter: int) -> dict:
    """What mlp_sublayer_fused launches for `rows` rows: the wgmma shape, the
    row tiles and the bytes it reads from L2 (weights, h, the running out)."""
    plan = vit_mlp_fused.fused_plan(rows, w, inter, vit_mlp_fused.K_CHUNKS)
    return {"variant": f"ln+cluster{plan['cluster']}x128rows_wgmma_m64n64k16+m64n128k16",
            "row_tiles": plan["tiles"],
            "l2_read_bytes": plan["l2_bytes"], "weight_l2_bytes": plan["weight_l2_bytes"]}


def phase_encoder_kernels(card: str, vcfg: clip_vit.ClipVisionConfig,
                          acfg: hubert.HubertConfig) -> dict:
    """The four encoder kernels against their plain versions at the towers'
    widths (ViT-L/14 and HuBERT-large share w = 1024, 16 heads of 64,
    I = 4096), b = 64: CLIP's n = 257, the same padded to 264 with valid_len
    257, and HuBERT's n = 99 (the frames of a 2 s clip); both
    activations for the MLP kernels, both accumulations for the fused one.
    Returns per-kernel {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by} with device times at CLIP's shape (CUDA graph, four layers'
    weights per replay cycle); HuBERT's times of the sublayer and the MLP
    pair are printed. library_ms is SDPA for the attention; the sublayers
    have no single library call, so their library chains' times are printed
    as chain_ms."""
    g = torch.Generator(device="cuda").manual_seed(19)
    w, heads, inter, b = vcfg.width, vcfg.num_heads, vcfg.mlp_dim, ENCODER_B
    if (w, heads, inter) != (acfg.hidden_size, acfg.num_heads, acfg.intermediate_size):
        raise ValueError("phase_encoder_kernels: the towers' layer widths differ")
    d, n_clip, n_hub = w // heads, vcfg.num_patches + 1, hubert_frames(acfg, RT_SAMPLES)
    layers = encoder_layers(g, w, inter, 4)  # 4 x 24 MB of weights per replay cycle
    s0 = layers[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {name: {"max_abs_err": 0.0, "library_ms": None} for name in
           ("attn_sublayer", "mlp_sublayer", "fused_vit_attention", "mlp_sublayer_fused")}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)

    def check(name, got, ref, extra_atol=None, **shape):
        err, rel = compare(name, got, ref, b, extra_atol)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        say("kernels", kernel=name, b=b, **shape, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL if extra_atol is None else
            f"{ATOL}+one bf16 ulp of the running sum's peak")

    for tower, n, valid in (("clip", n_clip, n_clip), ("clip", -(-n_clip // 8) * 8, n_clip),
                            ("hubert", n_hub, n_hub)):
        x = rnd(b, n, w)
        a_args = (x, *(s0[k] for k in ATTN_KEYS))
        got = attn_sublayer(*a_args, heads, valid)
        if not torch.equal(got, attn_sublayer(*a_args, heads, valid)):
            raise AssertionError(f"attn_sublayer {tower} n={n}: two calls differ")
        check("attn_sublayer", got, attn_sublayer_reference(*a_args, heads, valid), tower=tower,
              n=n, valid_len=valid, variant=json.dumps(sublayer_variant(b * n, w)))
        q, k, v = (rnd(b, heads, n, d) for _ in range(3))
        check("fused_vit_attention", fused_vit_attention(q, k, v, valid),
              fused_vit_attention_reference(q, k, v, valid), tower=tower, n=n, valid_len=valid)
        if n != valid:
            continue  # the MLP kernels are row-wise: no key mask
        m_args = (x, *(s0[k] for k in MLP_KEYS))
        for act in ("quick_gelu", "gelu"):
            got = mlp_sublayer(*m_args, act=act)
            if not torch.equal(got, mlp_sublayer(*m_args, act=act)):
                raise AssertionError(f"mlp_sublayer {tower} {act}: two calls differ")
            check("mlp_sublayer", got, mlp_sublayer_reference(*m_args, act=act), tower=tower,
                  n=n, act=act, **mlp_variant(b * n, w, inter))
            for acc in ("bf16", "f32"):
                extra = bf16_ulp(bf16_acc_peak(x, s0, act)) if acc == "bf16" else None
                got = mlp_sublayer_fused(*m_args, act=act, acc=acc)
                if not torch.equal(got, mlp_sublayer_fused(*m_args, act=act, acc=acc)):
                    raise AssertionError(f"mlp_sublayer_fused {tower} {act} {acc}: two calls "
                                         "differ")
                check("mlp_sublayer_fused", got,
                      mlp_sublayer_fused_reference(*m_args, act=act, acc=acc), extra,
                      tower=tower, n=n, act=act, acc=acc, **fused_variant(b * n, w, inter))

    # the attention kernels alone at MAX_N = 512 (two passes), 330 tokens with
    # 321 valid (the first two-pass key count), a single valid key, both
    # layouts of fused_vit_attention
    for n, valid in ((512, 512), (330, 321), (n_clip, 1)):
        x = rnd(b, n, w)
        a_args = (x, *(s0[k] for k in ATTN_KEYS))
        check("attn_sublayer", attn_sublayer(*a_args, heads, valid),
              attn_sublayer_reference(*a_args, heads, valid), n=n, valid_len=valid)
        q, k, v = (rnd(b, heads, n, d) for _ in range(3))
        want = fused_vit_attention_reference(q, k, v, valid)
        check("fused_vit_attention", fused_vit_attention(q, k, v, valid), want, n=n,
              valid_len=valid, layout="bhnd", design=vit_attention_plan(n, valid)["kernel"])
        tr = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        check("fused_vit_attention", fused_self_attention(*tr, valid).transpose(1, 2), want,
              n=n, valid_len=valid, layout="bnhd")
        del q, k, v, tr, want

    def record(name, tower, n, calls, plain_calls, nbytes, flops, library=None, chain=None,
               old=None, no_products=None, **shape):
        times = {"ms": graph_ms(calls), "plain_ms": graph_ms(plain_calls, reps=5)}
        if library:
            times["library_ms"] = graph_ms(library)
        if chain:
            times["chain_ms"] = graph_ms(chain)
        if old:  # the previous design, for a redesigned kernel
            times["old_ms"] = graph_ms(old)
        if no_products:  # its variant without the tensor-core products
            shape["variant"] = json.dumps({**json.loads(shape["variant"]),
                                           "no_products_ms": graph_ms(no_products)})
        cost = bound(nbytes, flops)
        say("kernels", kernel=name, tower=tower, b=b, n=n, **shape,
            **{k: f"{v:.5f}" for k, v in times.items()}, bound_ms=f"{cost['bound_ms']:.5f}",
            bound_by=cost["bound_by"], tflops=f"{flops / times['ms'] / 1e9:.1f}",
            card=repr(card))
        if tower == "clip" and "ms" not in out[name]:  # the first CLIP timing of a kernel
            out[name].update({k: v for k, v in times.items() if k != "chain_ms"}, **cost)

    for tower, n in (("clip", n_clip), ("hubert", n_hub)):
        x = rnd(b, n, w)
        key_mask = torch.ones((1, 1, 1, n), dtype=torch.bool, device="cuda")
        rows = b * n
        record("attn_sublayer", tower, n,
               [lambda s=s: attn_sublayer(x, *(s[k] for k in ATTN_KEYS), heads, n)
                for s in layers] * 2,
               [lambda: attn_sublayer_reference(x, *(s0[k] for k in ATTN_KEYS), heads, n)],
               2 * (2 * rows * w + 4 * w * w + 6 * w), 8 * rows * w * w + 4 * rows * n * w,
               chain=[lambda s=s: library_attn_chain(x, s, heads, key_mask) for s in layers] * 2,
               stages=json.dumps(stage_ms(
                   lambda: attn_sublayer(x, *(s0[k] for k in ATTN_KEYS), heads, n))))
        mlp_bytes, mlp_flops = 2 * (2 * rows * w + 2 * w * inter + inter + 3 * w), \
            4 * rows * w * inter
        act = "quick_gelu" if tower == "clip" else "gelu"
        def mlp_launch(variant):  # vit_mlp's C entry: 1 no products, 2 the previous design
            return [lambda s=s: vit_mlp._launch(x, *(s[k] for k in MLP_KEYS), eps=1e-5, act=act,
                                                variant=variant) for s in layers] * 2

        record("mlp_sublayer", tower, n,
               [lambda s=s: mlp_sublayer(x, *(s[k] for k in MLP_KEYS), act=act)
                for s in layers] * 2,
               [lambda: mlp_sublayer_reference(x, *(s0[k] for k in MLP_KEYS), act=act)],
               mlp_bytes, mlp_flops,
               chain=[lambda s=s: library_mlp_chain(x, s, act) for s in layers] * 2,
               old=mlp_launch(2), no_products=mlp_launch(1), act=act,
               variant=json.dumps(mlp_variant(rows, w, inter)))
        # bf16 (the default) recorded at CLIP's shape; f32 and HuBERT's shape printed
        for acc in ("bf16", "f32") if tower == "clip" else ("bf16",):
            record("mlp_sublayer_fused", tower, n,
                   [lambda s=s: mlp_sublayer_fused(x, *(s[k] for k in MLP_KEYS), act=act,
                                                   acc=acc) for s in layers],
                   [lambda: mlp_sublayer_fused_reference(x, *(s0[k] for k in MLP_KEYS),
                                                         act=act, acc=acc)],
                   mlp_bytes, mlp_flops,
                   chain=[lambda s=s: library_mlp_chain(x, s, act) for s in layers], acc=acc,
                   **fused_variant(rows, w, inter))
        qkv = [tuple(rnd(b, heads, n, d) for _ in range(3)) for _ in range(2)]  # 2 x 101 MB
        record("fused_vit_attention", tower, n,
               [lambda t=t: fused_vit_attention(*t, n) for t in qkv] * 4,
               [lambda: fused_vit_attention_reference(*qkv[0], n)],
               4 * b * heads * n * d * 2, 4 * b * heads * n * n * d,
               library=[lambda t=t: sdpa(*t, attn_mask=key_mask) for t in qkv] * 4,
               variant=json.dumps(vit_attention_plan(n, b=b, heads=heads, sms=sm_count())))
        lib_err = float((sdpa(*qkv[0], attn_mask=key_mask).float()
                         - fused_vit_attention_reference(*qkv[0], n).float()).abs().max())
        say("library", kernel="fused_vit_attention", call="scaled_dot_product_attention",
            max_abs_err_vs_plain=f"{lib_err:.6g}", card=repr(card))
        del qkv
    del layers
    torch.cuda.empty_cache()
    return out


SUBTITLES = [
    "I can't believe you did that for me.",
    "Leave me alone, I said I'm fine.",
    "We won! We actually won the final!",
    "Why does this always happen to me?",
    "Oh, so now you remember my birthday.",
    "Please, just tell me the truth.",
    "That noise again... did you hear it?",
    "Fine. Whatever you want.",
]
QUESTION = "Please recognize all possible emotional states of the character."


@dataclasses.dataclass(frozen=True)
class Config:
    """A configuration of the main path. `launches(layers)` gives the count
    each kernel must reach in one answer; every other kernel stays at 0."""
    launches: Callable[[int], dict]
    switches: dict = dataclasses.field(default_factory=dict)  # qwen2 attention switches
    tree: str = "bf16"  # the serving tree (serving_tree)
    batch: int = BATCH
    matmul_mode: str = "w8"  # quant.MATMUL_MODE
    decode_only: bool = False  # the tree serves only the decode loop (generate's decode_llm)


# decode kernels run once per layer and step, prefill kernels once per layer;
# a quantized product runs per layer (7 split, 4 fused) plus the lm_head on
# every decode step, and on the prefill only where its M is routed to the
# kernel: the prefill's lm_head (last token, M = batch), and every product
# under w8a8
N = NEW_TOKENS
CONFIGS = {
    "default": Config(lambda L: {"decode_qkv": N * L, "decode_mlp_bf16": N * L}),
    "a": Config(lambda L: {"decode_qkv": N * L, "decode_mlp_bf16": N * L, "decode_attn_o": N * L,
                           "prefill_attention": L},
                {"PREFILL_ATTENTION": "flash", "DECODE_ATTN_O": "pallas"}),
    "b": Config(lambda L: {"decode_qkv": N * L, "decode_mlp_bf16": N * L,
                           "decode_attention": N * L, "prefill_attention": L},
                {"PREFILL_ATTENTION": "flash", "DECODE_ATTENTION": "pallas"}),
    "q4": Config(lambda L: {"int4_matmul_smallm": N * (7 * L + 1) + 1}, tree="int4"),
    "q4_b16": Config(lambda L: {"int4_matmul": N * (7 * L + 1) + 1}, tree="int4", batch=16),
    "decode_llm": Config(lambda L: {"int4_matmul_smallm": N * (7 * L + 1)}, tree="int4",
                         decode_only=True),
    "q8_fused": Config(lambda L: {"int8_matmul": N * (4 * L + 1) + 1}, tree="int8_fused"),
    "q8a8": Config(lambda L: {"int8_matmul_w8a8": (N + 1) * (7 * L + 1)}, tree="int8",
                   matmul_mode="w8a8"),
    # qwen2.DECODE_QKV="xla": the per-projection route, decode_qkv never launched
    "qkv_xla": Config(lambda L: {"decode_mlp_bf16": N * L}, {"DECODE_QKV": "xla"}),
}


def serving_tree(llm: dict, cfg: qwen2.QwenConfig, tree: str) -> dict:
    """The merged bf16 LLM in a serving form of CONFIGS, built in the order of
    inference_hybird.py: fuse (optionally), then quantize."""
    if tree == "bf16":
        return llm
    if tree == "int8_fused":
        return qwen2.quantize_params(qwen2.fuse_qkv_gateup(llm, cfg), bits=8)
    return qwen2.quantize_params(llm, bits={"int4": 4, "int8": 8}[tree])


def tree_gib(tree) -> float:
    """GiB of every tensor of a parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_gib(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_gib(v) for v in tree)
    return tree.numel() * tree.element_size() / 2**30 if isinstance(tree, torch.Tensor) else 0.0


def wall(fn, reps=3):
    """Median host wall time in ms of calls that end in a synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


@contextlib.contextmanager
def switched(settings):
    """Set module switches, (module, name, value) triples, for the duration
    of the block."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in settings]
    for mod, name, value in settings:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def config_switches(config: str):
    """The qwen2 attention switches and quant.MATMUL_MODE of a configuration
    of CONFIGS, for the duration of a block."""
    c = CONFIGS[config]
    return switched([*((qwen2, name, value) for name, value in c.switches.items()),
                     (quant, "MATMUL_MODE", c.matmul_mode)])


# configurations only counted, not timed
COUNTED_ONLY = ("qkv_xla",)
MODE = "multiface_audio_face_frame_text"


class Served:
    """One configuration's requests: `answer` is the user's call (Chat.
    answer_batch, or for a decode-only tree generate(decode_llm=) on the
    spliced prompts, as bench.py calls it), `generate(n)` the prefill + n
    decode steps on the same spliced embeddings."""

    def __init__(self, chat: Chat, feats: dict, subtitles: list, decode_llm=None):
        self.chat, self.feats, self.subtitles, self.decode_llm = chat, feats, subtitles, decode_llm
        ids, lengths, offsets = chat.build_prompt_batch(MODE, subtitles, QUESTION)
        self.prompt_tokens = ids.shape[1]
        self.embeds = affectgpt.build_inputs_embeds(
            chat.frozen, chat.trainable, chat.cfg,
            torch.as_tensor(ids, dtype=torch.long, device="cuda"), feats,
            {m: torch.as_tensor(v, dtype=torch.long, device="cuda") for m, v in offsets.items()})
        self.lengths = torch.as_tensor(lengths, device="cuda")

    def generate(self, n: int):
        gcfg = gen.GenerateConfig(max_new_tokens=n, do_sample=False,
                                  eos_token_id=self.chat.tokenizer.eos_token_id)
        return gen.generate(self.chat.frozen["llm"], self.chat.cfg.llm, gcfg, self.embeds,
                            self.lengths, None, max_len=self.chat.max_len,
                            decode_llm=self.decode_llm)

    def answer(self) -> list:
        if self.decode_llm is None:
            return self.chat.answer_batch(MODE, self.subtitles, QUESTION, self.feats,
                                          max_new_tokens=NEW_TOKENS, do_sample=False)
        tokens, num_valid = self.generate(NEW_TOKENS)
        tokens, num_valid = tokens.cpu().numpy(), num_valid.cpu().numpy()
        return [gen.trim_output_text(self.chat.tokenizer.decode(row[:int(nv)],
                                                                skip_special_tokens=True))
                for row, nv in zip(tokens, num_valid)]


def counted_run(config: str, served: Served, baseline: dict) -> dict:
    """One answer under a configuration, with every kernel count set to 0
    just before it and read just after; asserts the exact launch counts,
    finite logits and one string per clip. `baseline` receives the default
    configuration's first-token logits and strings, which the others' first
    8 rows are compared with (printed, not asserted: in bf16 the kernels
    round differently from the plain chain, and the quantized trees hold
    other weights)."""
    c = CONFIGS[config]
    expected = {**dict.fromkeys(KERNELS, 0), **c.launches(served.chat.cfg.llm.num_layers)}
    finite, logits = [], []
    forward = qwen2.forward

    def checked_forward(*args, **kwargs):
        out, cache = forward(*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        if not logits:
            logits.append(out[:BATCH, -1].float())
        return out, cache

    with config_switches(config):
        qwen2.forward = checked_forward
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        try:
            texts = served.answer()
            torch.cuda.synchronize()
        finally:
            qwen2.forward = forward
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    say("main", config=config, tree=c.tree, batch=c.batch, matmul_mode=c.matmul_mode,
        switches=json.dumps(c.switches), launches=json.dumps(launches), forwards=len(finite),
        strings=len(texts))
    if launches != expected:
        raise AssertionError(f"config {config}: kernel launches {launches} != {expected}")
    if len(finite) != NEW_TOKENS + 1 or not bool(torch.stack(finite).all()):
        raise AssertionError(f"config {config}: non-finite logits on the main path")
    if len(texts) != c.batch or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"config {config}: expected {c.batch} strings, got {texts!r}")
    say("main", config=config, sample=json.dumps(texts[0][:60]))
    if config == "default":
        baseline.update(logits=logits[0], texts=texts)
    else:
        say("main", config=config, first_logits_max_abs_diff_vs_default=(
            f"{float((logits[0] - baseline['logits']).abs().max()):.6g}"),
            first_token_agrees=int((logits[0].argmax(-1) == baseline["logits"].argmax(-1)).sum()),
            strings_equal_to_default=sum(a == b for a, b in zip(texts, baseline["texts"])))
    return launches


def timed_run(config: str, served: Served) -> dict:
    """Wall times of one configuration: whole answers, then prefill alone
    (0 new tokens) and prefill + decode on the same spliced embeddings; peak
    device memory over them, and the part of it above what was allocated
    before (caches and activations)."""
    batch = CONFIGS[config].batch
    with config_switches(config):
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        total_ms = wall(served.answer, reps=2)
        prefill_ms = wall(lambda: served.generate(0), reps=2)
        decode_ms = (wall(lambda: served.generate(NEW_TOKENS), reps=2) - prefill_ms) / NEW_TOKENS
    peak = torch.cuda.max_memory_allocated()
    return {"answer_batch_ms": total_ms, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "clips_per_s": batch / (total_ms / 1e3),
            "peak_mem_gib": peak / 2**30, "working_set_gib": (peak - resident) / 2**30}


def phase_main_path(card: str) -> tuple:
    """Every configuration of CONFIGS on one model, all serving trees
    resident at once: a counted run each, then one timed visit each in the
    order of CONFIGS. Returns each
    kernel's launch count from the first configuration that runs it, and
    the model for the serve phase (cfg, frozen, trainable, tokenizer,
    features, the bf16 and int8 serving trees)."""
    cfg, frozen, trainable, tok = bootstrap.build_model(
        {"llama_model": "Qwen25", "keep_full_llm": True}, with_encoders=True, seed=0)
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    assert cfg.llm == qwen2.QwenConfig.qwen25_7b(), cfg.llm
    say("main", encoders=f"{cfg.visual_encoder_name}+{cfg.acoustic_encoder_name}",
        encoder_gib=f"{tree_gib([frozen['visual_encoder'], frozen['acoustic_encoder']]):.3f}")
    rng = np.random.RandomState(0)
    feats = {
        m: torch.as_tensor(rng.randn(BATCH, 8, d).astype(np.float32), device="cuda")
        .to(torch.bfloat16)
        for m, d in (("frame", cfg.visual_dim), ("face", cfg.visual_dim),
                     ("audio", cfg.acoustic_dim))
    }
    trees = {}
    for tree in dict.fromkeys(c.tree for c in CONFIGS.values()):
        t0 = time.perf_counter()
        trees[tree] = serving_tree(frozen["llm"], cfg.llm, tree)
        torch.cuda.synchronize()
        say("main", tree=tree, weight_gib=f"{tree_gib(trees[tree]):.3f}",
            build_seconds=f"{time.perf_counter() - t0:.3f}",
            allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    served = {}
    for config, c in CONFIGS.items():
        llm = frozen["llm"] if c.decode_only else trees[c.tree]
        chat = Chat({**frozen, "llm": llm}, trainable, cfg, tok, max_len=MAX_LEN)
        reps = c.batch // BATCH  # 16 clips: the 8 twice
        served[config] = Served(chat, {m: v.repeat(reps, 1, 1) for m, v in feats.items()},
                                SUBTITLES * reps, trees[c.tree] if c.decode_only else None)
    launches, baseline = {}, {}
    for config in CONFIGS:
        for name, count in counted_run(config, served[config], baseline).items():
            if count and name not in launches:
                launches[name] = count
    timed = [c for c in CONFIGS if c not in COUNTED_ONLY]
    visits = {config: [] for config in timed}
    for config in timed:
        visits[config].append(timed_run(config, served[config]))
    for config, runs in visits.items():
        c = CONFIGS[config]
        mean = {key: statistics.mean(r[key] for r in runs) for key in runs[0]}
        weights = tree_gib(trees[c.tree]) + (tree_gib(frozen["llm"]) if c.decode_only else 0)
        say("main", config=config, tree=c.tree, prompt_tokens=served[config].prompt_tokens,
            batch=c.batch, new_tokens=NEW_TOKENS, weight_gib=f"{weights:.3f}",
            peak_mem_gib=f"{max(r['peak_mem_gib'] for r in runs):.3f}",
            working_set_gib=f"{max(r['working_set_gib'] for r in runs):.3f}",
            **{key: f"{mean[key]:.4f}" for key in
               ("prefill_ms", "decode_ms_per_step", "answer_batch_ms", "clips_per_s")},
            visits=json.dumps([{key: round(r[key], 4) for key in
                                ("prefill_ms", "decode_ms_per_step", "clips_per_s")}
                               for r in runs]), card=repr(card))
    # what the serve phase runs, and phase 7's q4 tree
    serving = {"bf16": trees["bf16"], "int8": trees["int8"], "int4": trees["int4"]}
    del trees, served
    torch.cuda.empty_cache()
    return launches, (cfg, frozen, trainable, tok, feats, serving)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """A configuration of the serve phase: `kernels` launch num_layers times
    per decode step (int8_matmul in paged_w8 by its own count), every other
    kernel 0 times."""
    kernels: tuple
    engine: str = "paged"  # PagedBatchServer, or the dense BatchServer
    tree: str = "bf16"  # the serving tree: bf16, or int8 split (quantize_params)
    pool: Optional[torch.dtype] = None  # the paged pool's dtype, the table's by default
    decode_mlp: str = "auto"  # qwen2.DECODE_MLP
    attention: str = "pallas"  # paged.PAGED_ATTENTION of a paged engine
    decode_attention: str = "xla"  # qwen2.DECODE_ATTENTION (the dense engine's decode)


SERVE = {
    "paged_bf16": ServeConfig(("paged_attention", "decode_qkv", "decode_mlp_bf16")),
    # the gather chain: tells the kernel's rounding from the engines' own
    # differences when the paged and dense engines' tokens part
    "paged_bf16_gather": ServeConfig(("decode_qkv", "decode_mlp_bf16"), attention="xla"),
    "paged_kv8": ServeConfig(("paged_attention_int8", "decode_qkv", "decode_mlp_bf16"),
                             pool=torch.int8),
    "paged_w8": ServeConfig(("paged_attention", "decode_mlp"), tree="int8",
                            decode_mlp="pallas"),
    "server_bf16": ServeConfig(("decode_qkv", "decode_mlp_bf16"), engine="dense"),
    # the dense engine decoding through decode_attention (any mask: inactive
    # slots' rows have no valid column)
    "server_bf16_da": ServeConfig(("decode_qkv", "decode_mlp_bf16", "decode_attention"),
                                  engine="dense", decode_attention="pallas"),
}
SERVE_NEW_TOKENS = (32, 24, 16, 8)  # max_new_tokens, cycling over the requests


def serve_requests(chat: Chat, feats: dict) -> list:
    """48 requests: the 8 clips six times, prompts from Chat.build_prompt_batch
    (545-564 tokens), submitted as inference_hybird.py's submit_chunk_paged
    does."""
    ids, lengths, offsets = chat.build_prompt_batch(MODE, SUBTITLES, QUESTION)
    feats_np = {m: v.float().cpu().numpy() for m, v in feats.items()}
    return [server.Request(
        request_id=r, input_ids=np.asarray(ids[r % BATCH, :lengths[r % BATCH]], np.int32),
        features={m: v[r % BATCH] for m, v in feats_np.items()},
        offsets={m: int(o[r % BATCH]) for m, o in offsets.items()},
        max_new_tokens=SERVE_NEW_TOKENS[r % len(SERVE_NEW_TOKENS)],
    ) for r in range(6 * BATCH)]


def serve_engine(config: str, model: tuple, max_prompt: int):
    """The engine of a configuration, built as inference_hybird.py's
    make_paged_server builds it: block 16, 2048 blocks, tables for the
    longest prompt + 32 tokens, 16 slots, reserve admission, bursts of 8,
    greedy (the dense server: 16 slots, max_len 640)."""
    cfg, frozen, trainable, tok, _, trees = model
    c = SERVE[config]
    frozen = {**frozen, "llm": trees[c.tree]}
    if c.engine == "dense":
        return server.BatchServer(frozen, trainable, cfg, tok, max_slots=SERVE_SLOTS,
                                  max_len=MAX_LEN)
    pcfg = paged.PagedConfig(block_size=PAGE, num_blocks=POOL_BLOCKS,
                             max_blocks_per_seq=-(-(max_prompt + NEW_TOKENS) // PAGE))
    return paged.PagedBatchServer(frozen, trainable, cfg, tok, pcfg=pcfg, max_slots=SERVE_SLOTS,
                                  dtype=c.pool, do_sample=False, seed=0, admission="reserve",
                                  decode_burst=8)


def serve_switches(config: str):
    """paged.PAGED_ATTENTION, qwen2.DECODE_MLP and qwen2.DECODE_ATTENTION of
    the configuration, for the duration of a block."""
    c = SERVE[config]
    return switched([(paged, "PAGED_ATTENTION", c.attention),
                     (qwen2, "DECODE_MLP", c.decode_mlp),
                     (qwen2, "DECODE_ATTENTION", c.decode_attention)])


def serve_counted(config: str, model: tuple, requests: list) -> tuple:
    """One run of a configuration over all requests, every kernel count set
    to 0 just before and read just after. Asserts each kernel of the
    configuration launched num_layers x the decode steps the engine made
    (int8_matmul: the decode steps' 4 products a layer + the lm_head, plus
    each admission's prefill products routed to the kernel by M), every
    other kernel 0 times, a result for every request and finite logits.
    Returns (launches, results)."""
    c = SERVE[config]
    layers = model[0].llm.num_layers
    finite, admissions = [], []
    forward, core, prefill = qwen2.forward, paged._decode_core, paged.prefill_batch_into_pages

    def checked_forward(*args, **kwargs):  # the prefills (both engines), the dense decode
        out, cache = forward(*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        return out, cache

    def checked_core(*args, **kwargs):  # the paged decode steps
        logits, pools = core(*args, **kwargs)
        finite.append(torch.isfinite(logits).all())
        return logits, pools

    def recorded_prefill(llm, llm_cfg, pools, embeds, *args, **kwargs):
        admissions.append(tuple(embeds.shape[:2]))
        return prefill(llm, llm_cfg, pools, embeds, *args, **kwargs)

    with serve_switches(config):
        engine = serve_engine(config, model, max(len(r.input_ids) for r in requests))
        qwen2.forward, paged._decode_core = checked_forward, checked_core
        paged.prefill_batch_into_pages = recorded_prefill
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        try:
            for r in requests:
                engine.submit(r)
            results = engine.run_until_drained()
            torch.cuda.synchronize()
        finally:
            qwen2.forward, paged._decode_core = forward, core
            paged.prefill_batch_into_pages = prefill
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    steps = engine.stats["decode_steps"]
    expected = {**dict.fromkeys(KERNELS, 0), **dict.fromkeys(c.kernels, layers * steps)}
    if c.tree == "int8":
        expected["int8_matmul"] = steps * (4 * layers + 1) + sum(
            7 * layers + 1 if b * t <= quant.PALLAS_DEQUANT_MAX_M else 1 for b, t in admissions)
    say("serve", config=config, decode_steps=steps, admissions=json.dumps(admissions),
        launches=json.dumps(launches), results=len(results), forwards=len(finite))
    if launches != expected:
        raise AssertionError(f"serve {config}: kernel launches {launches} != {expected}")
    if set(results) != {r.request_id for r in requests}:
        raise AssertionError(f"serve {config}: results for {sorted(results)} only")
    if not finite or not bool(torch.stack(finite).all()):
        raise AssertionError(f"serve {config}: non-finite logits")
    return launches, results


def serve_timed(config: str, model: tuple, requests: list, card: str) -> None:
    """One timed run of a configuration on a fresh engine: all requests
    submitted up front, wall time to the last result (ending in a
    synchronize); requests/s, the clock's TTFT/e2e percentiles and
    generated tokens/s, the engine's phase times and counters, the cache's
    GiB and the peak device memory."""
    with serve_switches(config):
        engine = serve_engine(config, model, max(len(r.input_ids) for r in requests))
        cache = engine.cache if SERVE[config].engine == "dense" else engine.pools
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for r in requests:
            engine.submit(r)
        engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = engine.clock.summary()
    stats = {k: round(v, 4) if isinstance(v, float) else v for k, v in engine.stats.items()}
    say("serve", config=config, requests=len(requests), wall_s=f"{wall:.4f}",
        requests_per_s=f"{len(requests) / wall:.4f}",
        **{k: summary[k] for k in ("ttft_p50_ms", "ttft_p95_ms", "e2e_p50_ms", "e2e_p95_ms",
                                   "gen_tokens_per_s", "mean_tokens")},
        stats=json.dumps(stats), cache_gib=f"{tree_gib(cache):.3f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}", card=repr(card))
    del engine, cache
    torch.cuda.empty_cache()


def phase_serve(card: str, model: tuple) -> dict:
    """The serving engines at Qwen2.5-7B width on the merged model of the
    main path: a counted run of each configuration of SERVE, then one timed
    run each. Returns each kernel's launch count from the first
    configuration that runs it."""
    cfg, frozen, trainable, tok, feats, _ = model
    requests = serve_requests(Chat(frozen, trainable, cfg, tok), feats)
    say("serve", requests=len(requests),
        prompt_tokens=f"{min(len(r.input_ids) for r in requests)}-"
                      f"{max(len(r.input_ids) for r in requests)}",
        max_new_tokens=json.dumps(SERVE_NEW_TOKENS), slots=SERVE_SLOTS)
    launches, results = {}, {}
    for config in SERVE:
        counts, results[config] = serve_counted(config, model, requests)
        for name, count in counts.items():
            if count and name not in launches:
                launches[name] = count
        torch.cuda.empty_cache()
    def equal(a, b):  # requests whose tokens two configurations share
        return sum(results[a][r] == results[b][r] for r in results[a])

    say("serve", paged_bf16_requests_equal_to_server_bf16=equal("paged_bf16", "server_bf16"),
        paged_bf16_gather_equal_to_server_bf16=equal("paged_bf16_gather", "server_bf16"),
        paged_bf16_equal_to_paged_bf16_gather=equal("paged_bf16", "paged_bf16_gather"),
        server_bf16_da_requests_equal_to_server_bf16=equal("server_bf16_da", "server_bf16"),
        of=len(requests))
    for config in SERVE:
        serve_timed(config, model, requests, card)
    return launches


@dataclasses.dataclass(frozen=True)
class RtConfig:
    """A configuration of the realtime phase: module switches, and the count
    each kernel must reach in one answer, `launches(clip_layers,
    hubert_layers)`, beside the LLM's decode kernels; every other kernel
    stays at 0. Frames and faces each pass CLIP once per answer."""
    switches: tuple  # ((module, name, value), ...)
    launches: Callable[[int, int], dict]


RT = {
    "rt_plain": RtConfig(((clip_vit, "ATTN_IMPL", "xla"), (clip_vit, "MLP_IMPL", "xla"),
                          (nn, "FUSED_MHA", "0")), lambda c, h: {}),
    "rt_default": RtConfig((), lambda c, h: {"attn_sublayer": 2 * c, "mlp_sublayer": 2 * c}),
    "rt_a": RtConfig(((clip_vit, "MLP_IMPL", "fused"), (hubert, "ATTN_IMPL", "sublayer"),
                      (hubert, "MLP_IMPL", "pallas")),
                     lambda c, h: {"attn_sublayer": 2 * c + h, "mlp_sublayer": h,
                                   "mlp_sublayer_fused": 2 * c}),
    "rt_b": RtConfig(((clip_vit, "ATTN_IMPL", "flash"), (hubert, "MLP_IMPL", "fused")),
                     lambda c, h: {"fused_vit_attention": 2 * c, "mlp_sublayer_fused": h}),
    "rt_mha": RtConfig(((clip_vit, "ATTN_IMPL", "xla"),),  # nn.mha's route at 257 tokens
                       lambda c, h: {"fused_vit_attention": 2 * c}),
}
RT_VISITS = ("rt_plain", "rt_default", "rt_a", "rt_b", "rt_mha")


def realtime_media(seed: int = 1) -> dict:
    """The realtime phase's raw media for 8 clips, made from a numpy seed and
    put on the card: frames [8, 8, 720, 1280, 3] uint8 (a decoded HD clip,
    downsampled on the device), OpenFace face crops [8, 8, 112, 112, 3]
    uint8 (upsampled), audio [8, 8, 1, 32000] bf16 (2 s at 16 kHz, as
    scripts/bench_realtime.py shapes it)."""
    rng = np.random.RandomState(seed)
    return {
        "frame": torch.as_tensor(rng.randint(0, 256, (BATCH, 8, 720, 1280, 3), dtype=np.uint8),
                                 device="cuda"),
        "face": torch.as_tensor(rng.randint(0, 256, (BATCH, 8, 112, 112, 3), dtype=np.uint8),
                                device="cuda"),
        "audio": torch.as_tensor((rng.randn(BATCH, 8, 1, RT_SAMPLES) * 0.1).astype(np.float32),
                                 device="cuda").to(torch.bfloat16),
    }


def rt_counted(config: str, chat: Chat, raw: dict, baseline: dict,
               rt: Optional[RtConfig] = None) -> dict:
    """One answer from raw media under a configuration, every kernel count
    set to 0 just before and read just after: asserts the exact launches,
    features of the expected shapes, finite features and logits, and one
    string per clip; prints each modality's largest difference and least
    cosine similarity against rt_plain's features (not asserted: the kernel
    routes round at other points than the plain chain). `rt` overrides the
    configuration's RT entry (phase 7's rt_w8a8)."""
    rt = rt or RT[config]
    cfg = chat.cfg
    _, vcfg, _, acfg = encoder_configs(cfg)
    n = NEW_TOKENS * cfg.llm.num_layers
    expected = {**dict.fromkeys(KERNELS, 0), "decode_qkv": n, "decode_mlp_bf16": n,
                **rt.launches(vcfg.num_layers, acfg.num_layers)}
    finite = []
    forward = qwen2.forward

    def checked_forward(*args, **kwargs):
        out, cache = forward(*args, **kwargs)
        finite.append(torch.isfinite(out).all())
        return out, cache

    with switched(rt.switches):
        qwen2.forward = checked_forward
        for wrapper in WRAPPERS.values():
            wrapper.launches = 0
        try:
            feats = encode_media_features(chat.frozen, cfg, raw)
            texts = chat.answer_batch(MODE, SUBTITLES, QUESTION, feats,
                                      max_new_tokens=NEW_TOKENS, do_sample=False)
            torch.cuda.synchronize()
        finally:
            qwen2.forward = forward
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    say("realtime", config=config, switches=json.dumps(
        {f"{mod.__name__.split('.')[-1]}.{name}": v for mod, name, v in rt.switches}),
        launches=json.dumps({k: v for k, v in launches.items() if v}), strings=len(texts))
    if launches != expected:
        raise AssertionError(f"realtime {config}: kernel launches {launches} != {expected}")
    dims = {"frame": cfg.visual_dim, "face": cfg.visual_dim, "audio": cfg.acoustic_dim}
    for m, d in dims.items():
        if tuple(feats[m].shape) != (BATCH, 8, d) or not bool(torch.isfinite(feats[m]).all()):
            raise AssertionError(f"realtime {config}: {m} features {tuple(feats[m].shape)}, "
                                 f"expected finite [8, 8, {d}]")
    if len(finite) != NEW_TOKENS + 1 or not bool(torch.stack(finite).all()):
        raise AssertionError(f"realtime {config}: non-finite logits")
    if len(texts) != BATCH or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"realtime {config}: expected {BATCH} strings, got {texts!r}")
    if config == "rt_plain":
        baseline.update(feats=feats, texts=texts)
    else:
        diffs = {}
        for m in dims:
            a, b = feats[m].float().flatten(0, 1), baseline["feats"][m].float().flatten(0, 1)
            cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
            diffs[m] = {"max_abs_diff": round(float((a - b).abs().max()), 6),
                        "min_cos": round(float(cos.min()), 6)}
        say("realtime", config=config, features_vs_rt_plain=json.dumps(diffs),
            strings_equal_to_rt_plain=sum(x == y for x, y in zip(texts, baseline["texts"])))
    return launches


def rt_timed(config: str, chat: Chat, raw: dict, rt: Optional[RtConfig] = None) -> dict:
    """One timed visit: each stage alone as the entry point runs it
    (preprocessing of frames and faces, CLIP on frames, CLIP on faces, HuBERT,
    answer_batch on those features), each ending in a synchronize; then the
    whole path, encode_media_features + answer_batch, whose wall time gives
    clips/s from raw media to text; peak device memory over the visit."""
    cfg = chat.cfg
    vspec, vcfg, aspec, acfg = encoder_configs(cfg)
    enc = chat.frozen

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with switched((rt or RT[config]).switches):
        torch.cuda.reset_peak_memory_stats()
        prepped, pre_ms = timed(lambda: {m: prepare_frames(raw[m], vcfg.image_size,
                                                           vspec.normalize)
                                         for m in ("frame", "face")})
        feats, ms = {}, {"preprocess_ms": pre_ms}
        for m in ("frame", "face"):
            feats[m], ms[f"clip_{m}_ms"] = timed(
                lambda m=m: vspec.encode(enc["visual_encoder"], vcfg, prepped[m]))
        feats["audio"], ms["hubert_ms"] = timed(
            lambda: aspec.encode(enc["acoustic_encoder"], acfg, raw["audio"]))
        _, ms["answer_batch_ms"] = timed(lambda: chat.answer_batch(
            MODE, SUBTITLES, QUESTION, feats, max_new_tokens=NEW_TOKENS, do_sample=False))
        _, ms["raw_to_text_ms"] = timed(lambda: chat.answer_batch(
            MODE, SUBTITLES, QUESTION, encode_media_features(enc, cfg, raw),
            max_new_tokens=NEW_TOKENS, do_sample=False))
    ms["clips_per_s"] = BATCH / (ms["raw_to_text_ms"] / 1e3)
    ms["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return ms


def phase_realtime(card: str, model: tuple) -> dict:
    """The realtime path at full width on the phase-4 model (CLIP ViT-L/14 +
    HuBERT-large + Qwen2.5-7B, random bf16 weights from a seed, LoRA
    merged): raw media of 8 clips (realtime_media) → encode_media_features →
    greedy Chat.answer_batch in multiface_audio_face_frame_text mode, 32 new
    tokens, under the configurations of RT: a counted run each, then timed
    visits in the order of RT_VISITS. Returns each encoder kernel's launch
    count from the first configuration that runs it."""
    cfg, frozen, trainable, tok, _, _ = model
    t0 = time.perf_counter()
    raw = realtime_media()
    torch.cuda.synchronize()
    say("realtime", media=json.dumps({m: list(v.shape) for m, v in raw.items()}),
        setup_s=f"{time.perf_counter() - t0:.3f}")
    chat = Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN)
    launches, baseline = {}, {}
    for config in RT:
        for name, count in rt_counted(config, chat, raw, baseline).items():
            if count and name not in launches:
                launches[name] = count
    visits = {config: [] for config in RT}
    for config in RT_VISITS:
        visit = rt_timed(config, chat, raw)
        visits[config].append(visit)
        say("realtime", config=config, visit=len(visits[config]),
            **{k: f"{v:.4f}" for k, v in visit.items()}, card=repr(card))
    for config, runs in visits.items():
        say("realtime", config=config, visits=len(runs), **{
            k: f"{statistics.mean(r[k] for r in runs):.4f}" for k in runs[0]}, card=repr(card))
    del raw, chat
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 7: serving variants on the phase-4 model

# setup: (the serving tree of phase 4, the KV cache dtype)
SPEC = {"spec_bf16": ("bf16", None), "spec_q4": ("int4", None), "spec_kv8": ("bf16", "int8")}
AU_ROWS = 8
NEUTRAL_ROW = 3  # every AU at or below 0.5: answered without generating
AU_NEW_TOKENS = 256  # the reference AU agent's max_new_tokens
CLIP_TEXTS = 64
# the CLIP calls of rt_w8a8 (frames and faces): int8 blocks leave the sublayer
# route for "flash", the fused attention with the plain MLP
RT_W8A8 = RtConfig((), lambda c, h: {"fused_vit_attention": 2 * c})


def spec_launches(setup: str, layers: int, iters: int) -> dict:
    """Launches of one speculative answer. The decode kernels (rows 1-4) take
    t = 1 only, and neither the prefill nor a verify (t = DRAFT_LEN + 1) is:
    the bf16 setups launch nothing. spec_q4: each verify runs the split
    layout's seven products in every layer and the lm_head at M = SPEC_M
    (int4_matmul); the prefill's products (M = 8 t_pad > 1024) take the
    dequantize route and its last-token lm_head (M = 8) int4_matmul_smallm."""
    if setup == "spec_q4":
        return {"int4_matmul": (7 * layers + 1) * iters, "int4_matmul_smallm": 1}
    return {}


def counted_call(fn):
    """fn() with every kernel count set to 0 just before and read just after;
    returns (its result, the counts)."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: wrapper.launches for name, wrapper in WRAPPERS.items()}


def check_launches(what: str, launches: dict, expected: dict) -> None:
    expected = {**dict.fromkeys(KERNELS, 0), **expected}
    if launches != expected:
        raise AssertionError(f"{what}: kernel launches {launches} != {expected}")


@contextlib.contextmanager
def patched(module, name: str, make):
    """module.name replaced by make(original) for the duration of the block."""
    inner = getattr(module, name)
    setattr(module, name, make(inner))
    try:
        yield
    finally:
        setattr(module, name, inner)


def recording_forward(record: list):
    """A wrapper of qwen2.forward that appends each call's last-position
    logits [b, vocab] to `record`."""
    def make(forward):
        def wrapped(*args, **kwargs):
            out, cache = forward(*args, **kwargs)
            record.append(out[:, -1].float())
            return out, cache
        return wrapped
    return make


def spec_stats(record: list):
    """A wrapper of gen.generate_speculative that appends (verify
    iterations, mean num_valid) of each call to `record`."""
    def make(inner):
        def wrapped(*args, **kwargs):
            tokens, num_valid, iters = inner(*args, **kwargs, return_stats=True)
            record.append((iters, float(num_valid.float().mean())))
            return tokens, num_valid
        return wrapped
    return make


def check_finite(what: str, logits: list, count: Optional[int] = None) -> None:
    if not logits or (count is not None and len(logits) != count) \
            or not bool(torch.stack([torch.isfinite(x).all() for x in logits]).all()):
        raise AssertionError(f"{what}: {len(logits)} forwards, or non-finite logits")


def check_strings(what: str, texts, n: int) -> None:
    if len(texts) != n or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"{what}: expected {n} strings, got {texts!r}")


def prefill_ms(chat: Chat, feats: dict, cache_dtype=None) -> float:
    """Wall ms of the answer's prefill alone: generate with 0 new tokens on
    the spliced prompt embeddings."""
    served = Served(chat, feats, SUBTITLES)
    gcfg = gen.GenerateConfig(max_new_tokens=0, do_sample=False)
    return wall(lambda: gen.generate(chat.frozen["llm"], chat.cfg.llm, gcfg, served.embeds,
                                     served.lengths, None, max_len=chat.max_len,
                                     cache_dtype=cache_dtype), reps=1)


def spec_setup(card: str, setup: str, model: tuple) -> None:
    """One speculative setup of SPEC: a counted answer (exact launches from
    its verify iterations, finite logits, one string per clip), the same
    tree's plain greedy answer (rows equal: printed, not gated, since bf16
    ties may part a t = 1 step from a t = DRAFT_LEN + 1 verify), then one
    timed answer of each."""
    cfg, frozen, trainable, tok, feats, trees = model
    tree, kv = SPEC[setup]
    llm = {**frozen, "llm": trees[tree]}
    spec = Chat(llm, trainable, cfg, tok, max_len=MAX_LEN, kv_cache_dtype=kv,
                speculative_draft_len=DRAFT_LEN)
    plain = Chat(llm, trainable, cfg, tok, max_len=MAX_LEN, kv_cache_dtype=kv)

    def answer(chat):
        return chat.answer_batch(MODE, SUBTITLES, QUESTION, feats, max_new_tokens=NEW_TOKENS,
                                 do_sample=False)

    stats, logits = [], []
    with patched(gen, "generate_speculative", spec_stats(stats)), \
            patched(qwen2, "forward", recording_forward(logits)):
        texts, launches = counted_call(lambda: answer(spec))
    iters, mean_valid = stats[0]
    say("serving", setup=setup, tree=tree, kv_cache=kv or "bf16", draft_len=DRAFT_LEN,
        verify_iterations=iters, launches=json.dumps({k: v for k, v in launches.items() if v}))
    check_launches(setup, launches, spec_launches(setup, cfg.llm.num_layers, iters))
    check_finite(setup, logits, iters + 1)
    check_strings(setup, texts, BATCH)
    greedy = answer(plain)
    cache_dtype = torch.int8 if kv == "int8" else None
    pre = prefill_ms(spec, feats, cache_dtype)
    spec_ms, plain_ms = wall(lambda: answer(spec), reps=1), wall(lambda: answer(plain), reps=1)
    out = {"verify_iterations": iters, "tokens_per_iteration": mean_valid / iters,
           "rows_equal_to_greedy": sum(a == b for a, b in zip(texts, greedy)),
           "prefill_ms": pre, "spec_decode_ms": spec_ms - pre, "greedy_decode_ms": plain_ms - pre,
           "spec_answer_ms": spec_ms, "greedy_answer_ms": plain_ms}
    say("serving", setup=setup, **{k: f"{v:.4f}" if isinstance(v, float) else v
                                   for k, v in out.items()}, card=repr(card))


def tree_to(tree, dtype=None, device=None):
    """A parameter tree moved to `device` (if given), every floating tensor
    cast to `dtype` (if given)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, dtype, device) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    return tree.to(device=device, dtype=dtype if tree.is_floating_point() else None)


PERIODIC = (42, 43)  # the rigged lm_head's two columns


def periodic_rig(llm: dict, cfg: qwen2.QwenConfig) -> dict:
    """llm with every projection zeroed, so that each position's final
    hidden state is its own token's final-normed embedding h(x), and an
    lm_head that is zero except columns 42 and 43 = +-(u43 - u42), u the unit
    h(x): 42 is followed by 43 and 43 by 42, whatever came before. The
    stream is the 2-cycle, which the lookup drafts from its own history."""
    layers = [{**lyr, **{n: {k: torch.zeros_like(v) for k, v in lyr[n].items()}
                         for n in qwen2._LORA_TARGETS}} for lyr in llm["layers"]]
    dev = llm["embed_tokens"]["table"].device
    h = qwen2.embed_tokens(llm, torch.as_tensor(PERIODIC, device=dev))
    u = nn.rmsnorm(llm["final_ln"], h, cfg.rms_eps).float()
    u = u / u.norm(dim=-1, keepdim=True)
    w = torch.zeros((cfg.hidden_size, cfg.vocab_size), device=dev)
    w[:, PERIODIC[0]], w[:, PERIODIC[1]] = u[1] - u[0], u[0] - u[1]
    return {**llm, "layers": layers, "lm_head": {"w": w}}


def spec_exactness(card: str, model: tuple) -> None:
    """The speculative call at 2 layers of the 7B width in f32 (TF32 is off,
    the decode kernels take bf16, so every product is a plain f32 one) must
    emit, row for row, the tokens of generate(do_sample=False). On the
    random weights each verify keeps t0 and the bonus token alone, and a row
    may part only where greedy's top-two logit gap at that step is below
    1e-4 of the logits' largest magnitude, a tie that f32 summation order
    may flip. On periodic_rig the drafts are accepted (tokens per iteration
    > 1): there the tokens and num_valid must equal greedy's in every row."""
    cfg, frozen, trainable, tok, feats, _ = model
    llm = frozen["llm"]
    llm32 = tree_to({**llm, "layers": llm["layers"][:2]}, torch.float32)
    cfg2 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=2))
    chat = Chat({**frozen, "llm": llm32}, trainable, cfg2, tok, max_len=MAX_LEN)
    ids, lengths, offsets = chat.build_prompt_batch(MODE, SUBTITLES, QUESTION)
    ids = torch.as_tensor(ids, dtype=torch.long, device="cuda")
    embeds = affectgpt.build_inputs_embeds(
        chat.frozen, trainable, cfg2, ids, tree_to(feats, torch.float32),
        {m: torch.as_tensor(v, dtype=torch.long, device="cuda") for m, v in offsets.items()})
    lengths = torch.as_tensor(lengths, device="cuda")
    gcfg = gen.GenerateConfig(max_new_tokens=NEW_TOKENS, do_sample=False,
                              eos_token_id=tok.eos_token_id, stop_token_ids=chat._stop_ids)
    for rig, params in (("random", llm32), ("periodic", periodic_rig(llm32, cfg2.llm))):
        logits = []
        with switched([(qwen2, "DECODE_QKV", "xla"), (qwen2, "DECODE_MLP", "xla")]):
            spec, spec_nv, iters = gen.generate_speculative(
                params, cfg2.llm, gcfg, embeds, lengths, ids, max_len=MAX_LEN + DRAFT_LEN,
                draft_len=DRAFT_LEN, return_stats=True)
            with patched(qwen2, "forward", recording_forward(logits)):
                greedy, greedy_nv = gen.generate(params, cfg2.llm, gcfg, embeds, lengths, None,
                                                 max_len=MAX_LEN)
        parted = {}
        for row in range(BATCH):
            diff = (spec[row] != greedy[row]).nonzero()
            if len(diff):
                step = int(diff[0])
                top2 = logits[step][row].topk(2).values
                gap, scale = float(top2[0] - top2[1]), float(logits[step][row].abs().max())
                parted[row] = {"step": step, "gap": gap, "gap_over_scale": gap / scale}
        per_iter = float(spec_nv.float().mean()) / max(iters, 1)
        nv_equal = bool(torch.equal(spec_nv, greedy_nv))
        say("serving", setup=f"spec_exactness_f32_{rig}", layers=2, verify_iterations=iters,
            tokens_per_iteration=f"{per_iter:.4f}", rows_equal=BATCH - len(parted),
            parted=json.dumps(parted), num_valid_equal=nv_equal, card=repr(card))
        if rig == "random":
            for row, p in parted.items():
                if p["gap_over_scale"] >= 1e-4:
                    raise AssertionError(
                        f"spec_exactness_f32: row {row} parts from greedy at step {p['step']} "
                        f"with a top-two gap of {p['gap_over_scale']:.3g} of the logits' scale")
        elif parted or not nv_equal or per_iter <= 1.0 \
                or set(spec.unique().tolist()) != set(PERIODIC):
            raise AssertionError(
                f"spec_exactness_f32_periodic: rows parted {sorted(parted)}, num_valid "
                f"{spec_nv.tolist()} vs greedy {greedy_nv.tolist()}, {per_iter:.3f} tokens per "
                f"iteration, tokens {sorted(set(spec.unique().tolist()))}")
        del params, logits
    del llm32, chat, embeds
    torch.cuda.empty_cache()


def au_rows(seed: int = 7) -> list:
    """AU_ROWS OpenFace rows from a numpy seed: the 17 `AU??_r` intensities
    in [0, 3), and row NEUTRAL_ROW with every AU at or below 0.5."""
    rng = np.random.RandomState(seed)
    names = sorted(au_agent.AU_NAME_MAP)
    rows = []
    for i in range(AU_ROWS):
        values = rng.rand(len(names)) * (0.5 if i == NEUTRAL_ROW else 3.0)
        rows.append({f"{au}_r": f"{v:.2f}" for au, v in zip(names, values)})
    return rows


def au_agent_run(card: str, model: tuple) -> None:
    """AUAgent on the merged 7B LLM with the reference's sampling (T 0.7,
    top-p 0.9, repetition penalty 1.1, 256 new tokens): a counted run (rows
    1-2 launched num_layers x the decode steps, one string per row, the
    neutral row's fixed description), one step's penalty on the card against
    the same f32 formula on the CPU (the same bits), then a timed run."""
    cfg, frozen, _, tok, _, _ = model
    rows = [au_agent.parse_openface_row(r) for r in au_rows()]
    agent = au_agent.AUAgent(frozen["llm"], cfg.llm, tok, max_new_tokens=AU_NEW_TOKENS)
    penalties = []

    def keep_first(inner):
        def wrapped(logits, seen, penalty):
            out = inner(logits, seen, penalty)
            if not penalties:
                penalties.append((logits, seen.clone(), penalty, out))
            return out
        return wrapped

    logits = []
    with patched(gen, "apply_repetition_penalty", keep_first), \
            patched(qwen2, "forward", recording_forward(logits)):
        texts, launches = counted_call(lambda: agent.generate_descriptions(
            rows, generator=torch.Generator(device="cuda").manual_seed(0)))
    n = cfg.llm.num_layers * AU_NEW_TOKENS
    say("serving", setup="au_agent", rows=AU_ROWS, decode_steps=AU_NEW_TOKENS,
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        sample=json.dumps(texts[0][:60]))
    check_launches("au_agent", launches, {"decode_qkv": n, "decode_mlp_bf16": n})
    check_finite("au_agent", logits, AU_NEW_TOKENS + 1)
    check_strings("au_agent", texts, AU_ROWS)
    if texts[NEUTRAL_ROW] != au_agent.NEUTRAL_DESCRIPTION:
        raise AssertionError(f"au_agent: neutral row gave {texts[NEUTRAL_ROW]!r}")
    x, seen, penalty, got = penalties[0]
    want = gen.apply_repetition_penalty(x.cpu(), seen.cpu(), penalty)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("au_agent: the penalty on the card differs from the CPU's bits")
    ms = wall(lambda: agent.generate_descriptions(
        rows, generator=torch.Generator(device="cuda").manual_seed(1)), reps=1)
    generated = (AU_ROWS - 1) * AU_NEW_TOKENS
    say("serving", setup="au_agent", penalty_bits_equal_cpu=True, seen_tokens=int(seen.sum()),
        wall_ms=f"{ms:.4f}", tokens_per_s=f"{generated / ms * 1e3:.4f}", card=repr(card))


def qformer_run(card: str, model: tuple) -> None:
    """The phase-4 frozen LLM behind new random Q-Former mergers from a seed
    (video, audio and the multi pre-fusion all "qformer": 768 wide, 12
    heads, 2 layers): a counted greedy answer on the 8 preextracted clips
    (rows 1-2 launched num_layers x the steps, finite logits, one string per
    clip), then the mergers, the prefill and the answer timed."""
    cfg, frozen, _, tok, feats, _ = model
    qcfg = dataclasses.replace(cfg, video_fusion_type="qformer", audio_fusion_type="qformer",
                               multi_fusion_type="qformer")
    trainable = affectgpt.init_trainable(torch.Generator(device="cuda").manual_seed(3), qcfg)
    trainable["lora"] = None  # the LLM's LoRA is merged
    chat = Chat(frozen, trainable, qcfg, tok, max_len=MAX_LEN)

    def answer():
        return chat.answer_batch(MODE, SUBTITLES, QUESTION, feats, max_new_tokens=NEW_TOKENS,
                                 do_sample=False)

    logits = []
    with patched(qwen2, "forward", recording_forward(logits)):
        texts, launches = counted_call(answer)
    n = cfg.llm.num_layers * NEW_TOKENS
    say("serving", setup="qformer", launches=json.dumps({k: v for k, v in launches.items() if v}),
        sample=json.dumps(texts[0][:60]))
    check_launches("qformer", launches, {"decode_qkv": n, "decode_mlp_bf16": n})
    check_finite("qformer", logits, NEW_TOKENS + 1)
    check_strings("qformer", texts, BATCH)
    blocks = affectgpt.encode_modalities(trainable, qcfg, feats)
    say("serving", setup="qformer", blocks=json.dumps({m: list(b.shape) for m, b in
                                                       blocks.items()}),
        merger_ms=f"{wall(lambda: affectgpt.encode_modalities(trainable, qcfg, feats)):.4f}",
        prefill_ms=f"{prefill_ms(chat, feats):.4f}", answer_ms=f"{wall(answer, reps=1):.4f}",
        card=repr(card))


def clip_text_run(card: str) -> None:
    """encode_texts of the ViT-B/32 text geometry over CLIP_TEXTS AU
    description strings: f32 weights from a seed on the card within 1e-4 of
    the same tower on the CPU (TF32 off), no kernel launched (the causal
    blocks take the plain chain); then the bf16 tower timed."""
    tcfg = clip_vit.ClipTextConfig.vit_b_32_text()
    params = clip_vit.init_text_params(torch.Generator(device="cuda").manual_seed(4), tcfg,
                                       dtype=torch.float32)
    rng = np.random.RandomState(8)
    names = sorted(au_agent.AU_NAME_MAP)
    texts = [au_agent.build_au_input({au: float(v) for au, v in zip(names, rng.rand(17) * 3)})
             for _ in range(CLIP_TEXTS)]
    got, launches = counted_call(lambda: clip_text.encode_texts(params, tcfg, texts))
    check_launches("clip_text", launches, {})
    want = clip_text.encode_texts(tree_to(params, device="cpu"), tcfg, texts)
    err = float(np.abs(got - want).max())
    params16 = tree_to(params, torch.bfloat16)
    feats16 = clip_text.encode_texts(params16, tcfg, texts)
    say("serving", setup="clip_text", texts=CLIP_TEXTS, shape=list(got.shape),
        max_abs_err_vs_cpu_f32=f"{err:.6g}", tol=1e-4,
        bf16_min_cos_vs_f32=f"{float((feats16 * got).sum(-1).min()):.6f}",
        bf16_ms=f"{wall(lambda: clip_text.encode_texts(params16, tcfg, texts)):.4f}",
        card=repr(card))
    if not np.isfinite(got).all() or err > 1e-4:
        raise AssertionError(f"clip_text: {err:.3g} from the CPU's f32 tower (tolerance 1e-4)")


def rt_w8a8_run(card: str, model: tuple) -> None:
    """The realtime path (phase 6) with both towers from
    quant.quantize_encoder_tree: rt_plain's counted run on the bf16 towers
    as the baseline, then rt_w8a8's counted run (fused_vit_attention 24 x
    per CLIP call, the other encoder kernels 0 times; the features'
    distance from rt_plain's printed) and one timed visit."""
    cfg, frozen, trainable, tok, _, _ = model
    t0 = time.perf_counter()
    qfrozen = {**frozen, **{tower: quant.quantize_encoder_tree(frozen[tower])
                            for tower in ("visual_encoder", "acoustic_encoder")}}
    raw = realtime_media()
    torch.cuda.synchronize()
    towers = [qfrozen["visual_encoder"], qfrozen["acoustic_encoder"]]
    say("serving", setup="rt_w8a8", encoder_gib=f"{tree_gib(towers):.3f}",
        setup_s=f"{time.perf_counter() - t0:.3f}")
    baseline = {}
    rt_counted("rt_plain", Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN), raw, baseline)
    chat = Chat(qfrozen, trainable, cfg, tok, max_len=MAX_LEN)
    rt_counted("rt_w8a8", chat, raw, baseline, RT_W8A8)
    visit = rt_timed("rt_w8a8", chat, raw, RT_W8A8)
    say("serving", setup="rt_w8a8", **{k: f"{v:.4f}" for k, v in visit.items()}, card=repr(card))
    # where a w8a8 dense spends its time: CLIP's fc1 on a tower call's rows
    leaf = qfrozen["visual_encoder"]["blocks"][0]["mlp_in"]
    x = torch.randn((ENCODER_B * 257, leaf["w_q"].shape[0]), device="cuda").to(torch.bfloat16)
    say("serving", setup="rt_w8a8", dense=f"{list(x.shape)} @ {list(leaf['w_q'].shape)}",
        stages_ms=json.dumps(stage_ms(lambda: nn.dense(leaf, x))), card=repr(card))
    del raw, qfrozen, chat
    torch.cuda.empty_cache()


def phase_serving_variants(card: str, model: tuple) -> None:
    """Phase 7 on the phase-4 model: spec_bf16, spec_q4, spec_kv8 and the f32
    exactness gate, au_agent, qformer, clip_text, rt_w8a8, each gating its
    own launch counts."""
    t0 = time.perf_counter()
    for setup in SPEC:
        spec_setup(card, setup, model)
    spec_exactness(card, model)
    au_agent_run(card, model)
    qformer_run(card, model)
    clip_text_run(card)
    rt_w8a8_run(card, model)
    say("serving", phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))


# ---------------------------------------------------------------------------
# Phase 8: the training step at Qwen2.5-7B width

TRAIN_T = 256  # scripts/bench_train.py:32
TRAIN_LABELS = 64  # the target positions at the end of each prompt
TRAIN_OFFSETS = {"multi": 2, "audio": 5, "face": 20, "frame": 30}  # scripts/bench_train.py:83
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
DROPOUT_SEED = 42
# runs: (batch, remat, accum_steps)
TRAIN_RUNS = {"b8_remat": (8, True, 1), "b4_noremat": (4, False, 1),
              "b4_dots": (4, "dots", 1), "b4_remat": (4, True, 1), "b4_accum2": (4, True, 2)}
# gates 3-4: bf16 against f32 on the card, and remat routes against each
# other, at 2 layers of 7B width: the loss within 2%, the whole trainable
# gradient (every leaf in one vector) within 5% relative L2 and each leaf of
# at least GATED_LEAF_SIZE elements within 10% (bf16 keeps 8 significant
# bits, and the upstream gradients of the two runs part by 1-3%). A smaller
# leaf is one cancelling sum, such as the attention merger's 1-element bias
# (the sum over every feature row of its weight's gradient), whose relative
# error is that of one number: those leaves are printed and weigh in the
# whole-gradient bound only.
BF16_LOSS_RTOL, BF16_TOTAL_RTOL, BF16_GRAD_RTOL = 2e-2, 5e-2, 0.1
GATED_LEAF_SIZE = 1024


def train_batch(cfg: affectgpt.AffectGPTConfig, b: int, seed: int = 0,
                dtype=torch.bfloat16, t: int = TRAIN_T) -> dict:
    """scripts/bench_train.py's batch at t = TRAIN_T (or `t`) from a numpy
    seed, on the card: random ids with the patch runs zeroed at fixed
    offsets, labels on the last TRAIN_LABELS positions, preextracted
    features [b, 8, 768|1024] in `dtype`."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, min(1000, cfg.llm.vocab_size), (b, t)).astype(np.int64)
    labels = np.full_like(ids, -100)
    labels[:, -TRAIN_LABELS:] = ids[:, -TRAIN_LABELS:]
    for m, off in TRAIN_OFFSETS.items():
        ids[:, off:off + cfg.num_query_tokens(m)] = 0
    dims = {"frame": cfg.visual_dim, "face": cfg.visual_dim, "audio": cfg.acoustic_dim}
    return {
        "input_ids": torch.as_tensor(ids, device="cuda"),
        "attention_mask": torch.ones((b, t), dtype=torch.float32, device="cuda"),
        "labels": torch.as_tensor(labels, device="cuda"),
        "features": {m: torch.as_tensor(rng.randn(b, 8, d).astype(np.float32), device="cuda")
                     .to(dtype) for m, d in dims.items()},
        "offsets": {m: torch.full((b,), off, dtype=torch.int64, device="cuda")
                    for m, off in TRAIN_OFFSETS.items()},
    }


def train_trainable(cfg: affectgpt.AffectGPTConfig, seed: int) -> dict:
    """The f32 trainable tree on the card from a seed, LoRA's B drawn too
    (the PEFT start B = 0 gives A no gradient, which gates 3-4 compare)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    tree = affectgpt.init_trainable(g, cfg)
    for layer in tree["lora"]["layers"]:
        for leaf in layer.values():
            leaf["b"].normal_(0.0, 0.02, generator=g)
    return tree


def loss_and_grads(cfg, frozen, trainable, batch, remat=False, key=None):
    """forward_loss and the gradient of every trainable leaf (zeros where the
    loss does not reach) on copies of the leaves."""
    leaves = [t.detach().clone().requires_grad_(True) for t in optim.tree_leaves(trainable)]
    tree = optim.tree_unflatten(trainable, leaves)
    loss = affectgpt.forward_loss(frozen, tree, cfg, batch, remat=remat, dropout_rng=key)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def grad_errors(got: list, want: list, names: list) -> dict:
    """Relative L2 error of each gradient leaf against `want`'s, by leaf
    path, over the leaves whose `want` is non-zero, and under "(all)" that
    of every leaf in one vector."""
    out = {}
    for a, b, name in zip(got, want, names):
        ref = float(torch.linalg.vector_norm(b.float()))
        if ref > 0:
            out[name] = float(torch.linalg.vector_norm(a.float() - b.float())) / ref
    diff = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(a.float() - b.float()) for a, b in zip(got, want)]))
    out["(all)"] = float(diff) / float(optim.global_norm(want))
    return out


def grad_errors_hold(errs: dict, sizes: dict) -> bool:
    """Gates 3-4's gradient bounds: "(all)" within BF16_TOTAL_RTOL, every
    leaf of at least GATED_LEAF_SIZE elements within BF16_GRAD_RTOL."""
    return errs["(all)"] <= BF16_TOTAL_RTOL and all(
        v <= BF16_GRAD_RTOL for k, v in errs.items()
        if k != "(all)" and sizes[k] >= GATED_LEAF_SIZE)


def make_tx(accum_steps: int = 1, lr: Optional[float] = None) -> optim.AdamW:
    schedule = (lambda step: lr) if lr is not None else optim.linear_warmup_cosine_lr(
        init_lr=1e-4, min_lr=1e-6, warmup_steps=2, total_steps=200)
    return optim.make_optimizer(schedule, weight_decay=0.05, max_grad_norm=1.0,
                                accum_steps=accum_steps)


def train_step_flops(lc: qwen2.QwenConfig, b: int, t: int, remat) -> float:
    """Operations of one training step estimated from shapes: the frozen
    projections twice (forward, dx) and once more under remat=True; the
    attention products (full t x t, as the plain chain computes them) three
    times and once more under any remat; the fused loss's lm_head three
    times (forward, its chunk's recompute, dx). LoRA's rank-16 products are
    left out."""
    h, inter = lc.hidden_size, lc.intermediate_size
    nq, nkv = lc.num_heads * lc.head_dim, lc.num_kv_heads * lc.head_dim
    n = b * t
    mm = 2 * n * lc.num_layers * (h * nq + 2 * h * nkv + nq * h + 3 * h * inter)
    attn = 4 * n * t * nq * lc.num_layers
    head = 2 * b * (t - 1) * h * lc.vocab_size
    return mm * (3 if remat is True else 2) + attn * (4 if remat else 3) + 3 * head


def step_breakdown(cfg, frozen, state, batch, remat, tx) -> dict:
    """One step in its three parts, each ending in a synchronize: forward
    (the loss), backward (the gradients), optimizer. Then one whole step
    under torch.profiler: its kernels' device time, the busy share of its
    wall time, and the six kernels with the most device time."""
    step_fn = train_step.make_train_step(cfg, tx, remat=remat, dropout_seed=DROPOUT_SEED)
    leaves = optim.tree_leaves(state.trainable)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = affectgpt.forward_loss(frozen, state.trainable, cfg, batch, remat=remat,
                                  dropout_rng=(DROPOUT_SEED, state.step))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    state.opt_state = tx.apply(optim.tree_unflatten(state.trainable, grads), state.opt_state,
                               state.trainable)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out = {"forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
           "optimizer_ms": (t3 - t2) * 1e3}
    kernels = {}
    for _ in range(2):  # a process's first profiler session may record no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            state, _ = step_fn(state, frozen, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - w0) * 1e3
        kernels = {e.key: getattr(e, "device_time_total", 0) / 1e3 for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0)}
        if kernels:
            break
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    out.update(profiled_wall_ms=wall_ms, device_ms=device_ms,
               busy_share=device_ms / wall_ms if wall_ms else float("nan"),
               top_kernels={k.split("(")[0][-60:]: round(v, 3) for k, v in top})
    return out


def train_run(card: str, name: str, cfg, frozen: dict) -> None:
    """One run of TRAIN_RUNS: TRAIN_WARMUP + TRAIN_TIMED steps on one batch,
    dropout on; the timed steps' mean ms, samples/s, target tokens/s, the
    peak memory; gate 1 and no kernel launched."""
    b, remat, accum = TRAIN_RUNS[name]
    tx = make_tx(accum)
    state = train_step.create_train_state(train_trainable(cfg, 1), tx)
    step_fn = train_step.make_train_step(cfg, tx, remat=remat, dropout_seed=DROPOUT_SEED)
    batch = train_batch(cfg, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []

    def steps(n):
        nonlocal state
        for _ in range(n):
            state, m = step_fn(state, frozen, batch)
            metrics.append(m)

    _, launches = counted_call(lambda: steps(TRAIN_WARMUP))
    check_launches(f"train {name}", launches, {})
    t0 = time.perf_counter()
    steps(TRAIN_TIMED)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_TIMED
    losses = torch.stack([m["loss"] for m in metrics]).float().cpu()
    norms = torch.stack([m["grad_norm"] for m in metrics]).float().cpu()
    if not bool(torch.isfinite(losses).all() and torch.isfinite(norms).all()):
        raise AssertionError(f"train {name}: non-finite loss {losses} or grad_norm {norms}")
    flops = train_step_flops(cfg.llm, b, TRAIN_T, remat)
    say("train", run=name, batch=b, remat=remat, accum_steps=accum, seq=TRAIN_T,
        step_ms=f"{step_s * 1e3:.4f}", samples_per_s=f"{b / step_s:.4f}",
        target_tokens_per_s=f"{b * TRAIN_LABELS / step_s:.4f}",
        est_tflops_per_s=f"{flops / step_s / 1e12:.2f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
        updates=state.opt_state["count"], losses=json.dumps([round(float(x), 4) for x in losses]),
        grad_norm_last=f"{float(norms[-1]):.4f}", card=repr(card))
    if name == "b8_remat":
        parts = step_breakdown(cfg, frozen, state, batch, remat, tx)
        say("train", run=name, breakdown=json.dumps(
            {k: round(v, 4) if isinstance(v, float) else v for k, v in parts.items()}),
            card=repr(card))
    del state, batch, metrics
    torch.cuda.empty_cache()


def train_loss_falls(card: str, cfg, frozen: dict) -> None:
    """Gate 2: 10 steps on one fixed batch (b = 4, remat=True), dropout off,
    constant lr 1e-4; the loss after them must be below the first step's."""
    tx = make_tx(lr=1e-4)
    state = train_step.create_train_state(train_trainable(cfg, 2), tx)
    step_fn = train_step.make_train_step(cfg, tx, remat=True)
    batch = train_batch(cfg, 4, seed=1)
    losses = []
    for _ in range(10):
        state, m = step_fn(state, frozen, batch)
        losses.append(m["loss"])
    with torch.no_grad():
        after = affectgpt.forward_loss(frozen, state.trainable, cfg, batch)
    losses = [float(x) for x in losses] + [float(after)]
    say("train", gate="loss_falls", losses=json.dumps([round(x, 5) for x in losses]),
        card=repr(card))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall over 10 steps: {losses}")


def numerics_model(cfg, frozen: dict):
    """The first 2 layers of the LLM at its width, their config, a trainable
    tree and a b = 2 batch: the model of gates 3 and 4."""
    cfg2 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=2))
    llm2 = {**frozen["llm"], "layers": frozen["llm"]["layers"][:2]}
    return cfg2, {"llm": llm2}, train_trainable(cfg2, 3), train_batch(cfg2, 2, seed=2)


def bf16_errors(cfg, frozen: dict) -> tuple:
    """Gate 3's measurement: (bf16 loss, f32 loss, {leaf: relative L2 error
    of its bf16 gradient against the f32 one}) on `numerics_model`, the f32
    side the same weights and features upcast."""
    cfg2, small, trainable, batch = numerics_model(cfg, frozen)
    names = optim.tree_paths(trainable)
    loss16, g16 = loss_and_grads(cfg2, small, trainable, batch)
    batch32 = {**batch, "features": tree_to(batch["features"], torch.float32)}
    loss32, g32 = loss_and_grads(cfg2, tree_to(small, torch.float32), trainable, batch32)
    return float(loss16), float(loss32), grad_errors(g16, g32, names)


def leaf_sizes(cfg, frozen: dict) -> dict:
    """Elements of each trainable leaf of `numerics_model`, by path."""
    trainable = numerics_model(cfg, frozen)[2]
    return {k: t.numel() for k, t in zip(optim.tree_paths(trainable), optim.tree_leaves(trainable))}


def remat_errors(cfg, frozen: dict, key: tuple) -> tuple:
    """Gate 4's measurement on `numerics_model` with dropout key `key`: the
    remat=False loss and, for remat True and "dots", (loss, {leaf:
    relative L2 error against remat=False's gradient})."""
    cfg2, small, trainable, batch = numerics_model(cfg, frozen)
    names = optim.tree_paths(trainable)
    loss0, g0 = loss_and_grads(cfg2, small, trainable, batch, remat=False, key=key)
    out = {}
    for remat in (True, "dots"):
        loss, g = loss_and_grads(cfg2, small, trainable, batch, remat=remat, key=key)
        out[str(remat)] = (float(loss), grad_errors(g, g0, names))
    return float(loss0), out


def worst(errs: dict, n: int = 4) -> str:
    return json.dumps({k: f"{v:.3e}" for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:n]})


def train_numerics(card: str, cfg, frozen: dict) -> None:
    """Gates 3 and 4 on the first 2 layers of the LLM at its width, b = 2."""
    sizes = leaf_sizes(cfg, frozen)
    loss16, loss32, errs = bf16_errors(cfg, frozen)
    loss_err = abs(loss16 - loss32) / abs(loss32)
    gated = {k: v for k, v in errs.items() if k != "(all)" and sizes[k] >= GATED_LEAF_SIZE}
    say("train", gate="bf16_vs_f32", loss_bf16=f"{loss16:.6f}", loss_f32=f"{loss32:.6f}",
        loss_rel_err=f"{loss_err:.3e}", leaves=len(errs) - 1, gated_leaves=len(gated),
        grad_rel_err_all=f"{errs['(all)']:.4e}",
        grad_rel_err_median=f"{statistics.median(gated.values()):.4e}",
        worst_gated=worst(gated, 3), worst_small=worst(
            {k: v for k, v in errs.items() if k != "(all)" and k not in gated}, 3),
        card=repr(card))
    if not (np.isfinite(loss16) and loss_err <= BF16_LOSS_RTOL and gated
            and grad_errors_hold(errs, sizes)):
        raise AssertionError(f"train: bf16 against f32: loss error {loss_err}, gradient "
                             f"errors {worst(errs)}")
    key = (DROPOUT_SEED, 0)
    loss0, routes = remat_errors(cfg, frozen, key)
    say("train", gate="remat_invariance", dropout_key=json.dumps(key),
        loss_dropout=f"{loss0:.6f}", loss_no_dropout=f"{loss16:.6f}",
        **{f"remat_{r}": f"loss={loss:.6f} worst={worst(e, 2)}" for r, (loss, e) in routes.items()},
        card=repr(card))
    for remat, (loss, e) in routes.items():
        if abs(loss - loss0) > BF16_LOSS_RTOL * abs(loss0) or not grad_errors_hold(e, sizes):
            raise AssertionError(f"train: remat={remat} against remat=False with dropout: "
                                 f"loss {loss} / {loss0}, errors {worst(e)}")
    if loss0 == loss16:
        raise AssertionError("train: dropout on left the 2-layer loss unchanged")


def train_realtime(card: str, cfg, frozen: dict) -> None:
    """Gate 5: a realtime training step at b = 2. The frozen towers encode
    raw media under torch.no_grad (rt_default's kernels: attn_sublayer and
    mlp_sublayer once per CLIP layer, frames and faces), the step trains on
    their features; then the mergers' gradients on the same features."""
    _, vcfg, _, _ = encoder_configs(cfg)
    raw = {m: v[:2] for m, v in realtime_media().items()}
    batch = train_batch(cfg, 2, seed=3)
    tx = make_tx()
    state = train_step.create_train_state(train_trainable(cfg, 4), tx)
    step_fn = train_step.make_train_step(cfg, tx, remat=True, dropout_seed=DROPOUT_SEED)

    def run():
        with torch.no_grad():
            feats = encode_media_features(frozen, cfg, raw)
        return feats, step_fn(state, frozen, {**batch, "features": feats})

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (feats, (_, metrics)), launches = counted_call(run)
    step_ms = (time.perf_counter() - t0) * 1e3
    expected = {"attn_sublayer": 2 * vcfg.num_layers, "mlp_sublayer": 2 * vcfg.num_layers}
    say("train", gate="realtime", batch=2, launches=json.dumps({k: v for k, v in launches.items()
                                                                if v}),
        loss=f"{float(metrics['loss']):.5f}", grad_norm=f"{float(metrics['grad_norm']):.4f}",
        step_ms=f"{step_ms:.3f}", card=repr(card))
    check_launches("train realtime", launches, expected)
    _, grads = loss_and_grads(cfg, frozen, state.trainable, {**batch, "features": feats},
                              remat=True, key=(DROPOUT_SEED, 1))
    merger = optim.tree_unflatten(state.trainable, grads)
    used = [g for grp in ("video", "audio") for g in optim.tree_leaves(merger["mergers"][grp])]
    used += optim.tree_leaves(merger["multi"])
    if not (bool(torch.isfinite(metrics["loss"])) and all(bool(torch.isfinite(g).all()) for g in used)
            and all(bool(g.abs().sum() > 0) for g in used)):
        raise AssertionError("train realtime: non-finite loss or merger gradients, or a zero one")


def phase_train(card: str, model: tuple) -> None:
    """Phase 8 on the phase-4 model: the runs of TRAIN_RUNS and gates 2-5.
    The quantized serving trees of phases 4-7 are released first."""
    cfg, frozen, _, _, _, trees = model
    for tree in ("int8", "int4"):
        trees.pop(tree, None)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    llm_only = {"llm": frozen["llm"]}
    say("train", hidden=cfg.llm.hidden_size, layers=cfg.llm.num_layers,
        frozen_gib=f"{tree_gib(llm_only):.3f}",
        trainable_gib=f"{tree_gib(train_trainable(cfg, 0)):.3f}", lora_r=cfg.llm.lora_r,
        lora_dropout=cfg.llm.lora_dropout, allocated_gib=f"{torch.cuda.memory_allocated() / 2**30:.3f}")
    for name in TRAIN_RUNS:
        train_run(card, name, cfg, llm_only)
    train_loss_falls(card, cfg, llm_only)
    train_numerics(card, cfg, llm_only)
    train_realtime(card, cfg, frozen)
    say("train", phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))


# ---------------------------------------------------------------------------
# Phase 9: the training entry point (config → datasets → Runner) at 7B width

# the model, datasets and run nodes of train_configs/mercaptionplus_bestsetup.yaml
# (the card has no YAML parser; tests/test_torch_config.py holds this literal
# equal to Config.from_file of the file)
BESTSETUP = {
    "model": {
        "arch": "affectgpt", "llama_model": "Qwen25", "visual_encoder": "CLIP_VIT_LARGE",
        "acoustic_encoder": "HUBERT_LARGE", "skip_encoders": True,
        "preextracted_visual_dim": 768, "preextracted_acoustic_dim": 1024,
        "multi_fusion_type": "attention", "video_fusion_type": "attention",
        "audio_fusion_type": "attention", "image_fusion_type": "mean",
        "num_audio_query_token": 1, "num_video_query_token": 1, "num_multi_query_token": 1,
        "num_image_query_token": 1, "lora_r": 16, "lora_dropout": 0.05, "max_length": 1024,
        "frozen_llm": False, "frozen_video_proj": False, "frozen_video_Qformer": False,
        "frozen_audio_Qformer": False, "frozen_audio_proj": False,
        "frozen_multi_Qformer": False, "frozen_multi_llama_proj": False,
        "ckpt": "", "ckpt_2": "", "ckpt_3": "",
    },
    "datasets": {
        "mercaptionplus": {
            "data_type": "video", "face_or_frame": "multiface_audio_face_frame_text",
            "label_type": "hybird", "frame_n_frms": 8, "frame_sampling": "uniform",
            "use_preextracted_frame": True, "use_preextracted_face": True,
            "use_preextracted_audio": True, "preextracted_root": "./preextracted_features",
            "visual_encoder_name": "CLIP_VIT_LARGE", "acoustic_encoder_name": "HUBERT_LARGE",
            "ratio": 1.0,
        },
    },
    "run": {
        "task": "video_text_pretrain", "lr_sched": "linear_warmup_cosine_lr", "init_lr": 1.0e-5,
        "min_lr": 1.0e-5, "warmup_lr": 1.0e-6, "weight_decay": 0.05, "max_epoch": 100,
        "iters_per_epoch": 5000, "warmup_steps": 5000, "batch_size_train": 4,
        "accum_grad_iters": 1, "tp": 1, "remat": False, "seed": 42, "log_freq": 50,
        "resume_ckpt_path": None,
    },
}
# run A's overrides of the file's run node (output_dir and the corpus paths
# are set to the phase's temporary directory besides)
RUN_A_OVERRIDES = {"max_epoch": 2, "iters_per_epoch": 6, "warmup_steps": 4, "log_freq": 1,
                   "evaluate": True, "val_iters": 2}
# run B: the realtime dataset mode through the towers of phase 4's model
RUN_B_DATASET = {"face_or_frame": "multiface_audio_face_text", "use_preextracted_face": False,
                 "use_preextracted_audio": False}
RUN_B_OVERRIDES = {"batch_size_train": 2, "max_epoch": 1, "iters_per_epoch": 3,
                   "warmup_steps": 0, "log_freq": 1}
RUNNER_CLIPS = 16
FACE_CROPS = 16  # OpenFace crops a clip, of which the dataset samples 8
ITERATION_RATIO_MAX = 1.25  # run A's median iteration against the bare step's
BARE_STEPS = 5
OPENSETS = ["['happy', 'excited']", "['sad']", "['angry', 'frustrated']", "[]",
            "['surprised']", "['worried', 'nervous']", "['calm']", "['disappointed']"]


def write_runner_corpus(root: str, seed: int = 9) -> tuple:
    """A synthetic MERCaptionPlus corpus of RUNNER_CLIPS clips under `root`:
    subtitles.csv and the track2 / track3 label CSVs (written with csv),
    preextracted frame and face [8, 768] and audio [8, 1024] features, raw
    OpenFace crops [FACE_CROPS, 112, 112, 3] and 2 s of 16 kHz audio a clip.
    Returns (the `paths:` section that points the tables at it, the
    feature root)."""
    import csv
    import os
    import wave

    rng = np.random.RandomState(seed)
    data = os.path.join(root, "mercaptionplus")
    feat_root = os.path.join(root, "features")
    names = [f"clip_{i:04d}" for i in range(RUNNER_CLIPS)]
    subdirs = {"frame": ("frame_CLIP_VIT_LARGE_uniform_8frms", 768),
               "face": ("face_CLIP_VIT_LARGE_8frms", 768),
               "audio": ("audio_HUBERT_LARGE_8clips", 1024)}
    for sub, _ in subdirs.values():
        os.makedirs(os.path.join(feat_root, "MERCaptionPlus", sub), exist_ok=True)
    os.makedirs(os.path.join(data, "audio"), exist_ok=True)
    for i, name in enumerate(names):
        for sub, dim in subdirs.values():
            np.save(os.path.join(feat_root, "MERCaptionPlus", sub, f"{name}.npy"),
                    rng.randn(8, dim).astype(np.float32))
        face_dir = os.path.join(data, "openface_face", name)
        os.makedirs(face_dir, exist_ok=True)
        np.save(os.path.join(face_dir, f"{name}.npy"),
                rng.randint(0, 256, (FACE_CROPS, 112, 112, 3), dtype=np.uint8))
        pcm = (np.clip(rng.randn(RT_SAMPLES) * 0.1, -1, 1) * 32767).astype("<i2")
        with wave.open(os.path.join(data, "audio", f"{name}.wav"), "wb") as handle:
            handle.setnchannels(1)
            handle.setsampwidth(2)
            handle.setframerate(16000)
            handle.writeframes(pcm.tobytes())
    tables = {
        "subtitles.csv": (["name", "english"],
                          [[n, SUBTITLES[i % len(SUBTITLES)]] for i, n in enumerate(names)]),
        "track2_train_mercaptionplus.csv": (["name", "openset"],
                                            [[n, OPENSETS[i % len(OPENSETS)]]
                                             for i, n in enumerate(names)]),
        "track3_train_mercaptionplus.csv": (["name", "reason"], [
            [n, f"In clip {i}, the speaker's voice drops and the face tightens, so the mood "
                f"reads as {OPENSETS[i % len(OPENSETS)].strip('[]') or 'neutral'}."]
            for i, n in enumerate(names)]),
    }
    for file, (header, rows) in tables.items():
        with open(os.path.join(data, file), "w", newline="") as handle:
            writer = csv.writer(handle)
            writer.writerow(header)
            writer.writerows(rows)
    section = {"DATA_DIR": {"MERCaptionPlus": data},
               "PATH_TO_RAW_AUDIO": {"MERCaptionPlus": os.path.join(data, "audio")},
               "PATH_TO_RAW_FACE": {"MERCaptionPlus": os.path.join(data, "openface_face")},
               "PATH_TO_TRANSCRIPTIONS": {"MERCaptionPlus": os.path.join(data, "subtitles.csv")}}
    return section, feat_root


def runner_config(section: dict, feat_root: str, out_dir: str, run: dict,
                  dataset: Optional[dict] = None):
    """BESTSETUP with `run` and `dataset` over its run and dataset nodes,
    the corpus's paths and `out_dir`, as a runner Config."""
    from affectgpt_tpu_torch.config import Config

    raw = json.loads(json.dumps(BESTSETUP))
    raw["datasets"]["mercaptionplus"].update(preextracted_root=feat_root, **(dataset or {}))
    raw["run"].update(output_dir=out_dir, **run)
    raw["paths"] = section
    return Config.from_dict(raw, name="mercaptionplus_bestsetup")


def make_runner(cfg, frozen: dict, tok, job: str, seed: int = 5):
    """A Runner on `cfg`'s model node with phase 4's frozen trees and f32
    trainable leaves drawn from `seed` on the card."""
    from affectgpt_tpu_torch.training import runner

    model_cfg = affectgpt.AffectGPTConfig.from_model_cfg(cfg.model.to_dict())
    trainable = affectgpt.init_trainable(torch.Generator(device="cuda").manual_seed(seed),
                                         model_cfg)
    datasets, ratios = runner.build_datasets(cfg, tok, model_cfg, device="cuda")
    return runner.Runner(cfg, tok, frozen, trainable, model_cfg, datasets, ratios, job_id=job,
                         device="cuda")


def timed_saves(record: list):
    """A wrapper of checkpoint.save_checkpoint that appends (directory,
    seconds) of each save to `record`."""
    def make(inner):
        def save(*args, **kwargs):
            t0 = time.perf_counter()
            path = inner(*args, **kwargs)
            record.append((path, time.perf_counter() - t0))
            return path
        return save
    return make


def dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def bare_step_ms(r, batch: dict) -> list:
    """BARE_STEPS of the runner's step on one resident device batch, each
    read back as the runner's loop reads it at a log boundary."""
    out = []
    for _ in range(BARE_STEPS):
        t0 = time.perf_counter()
        r.state, metrics = r.step_fn(r.state, r.frozen, batch)
        float(metrics["loss"])
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def runner_bestsetup(card: str, model: tuple, tmp: str, section: dict, feat_root: str) -> None:
    """Run A: mercaptionplus_bestsetup.yaml's training through the Runner
    (2 epochs of 6 iterations, validation, checkpoints), its iterations
    against the bare step's, then a resumed Runner."""
    import os

    from affectgpt_tpu_torch.training import checkpoint

    _, frozen, _, tok, _, _ = model
    cfg = runner_config(section, feat_root, os.path.join(tmp, "out"), RUN_A_OVERRIDES)
    saves: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(checkpoint, "save_checkpoint", timed_saves(saves)):
        r = make_runner(cfg, {"llm": frozen["llm"]}, tok, "run_a")
        assert r.model_cfg.llm == qwen2.QwenConfig.qwen25_7b(), r.model_cfg.llm
        (_, launches) = counted_call(r.train)
    run_s = time.perf_counter() - t0
    check_launches("runner_bestsetup", launches, {})
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = r._device_batch(next(r.loader))
    bare = bare_step_ms(r, batch)
    per_epoch = r.iters_per_epoch
    iters = [ms for i, ms in enumerate(r.iteration_ms) if i % per_epoch]  # each epoch's first out
    iter_med, bare_med = statistics.median(iters), statistics.median(bare[1:])
    losses = r.visualizer.history["loss"]
    out = os.path.join(tmp, "out", "mercaptionplus_bestsetup", "run_a")
    lines = [json.loads(x) for x in open(os.path.join(out, "log.txt")).read().splitlines()]
    say("runner", run="runner_bestsetup", batch=r.batch_size, seq=cfg.model["max_length"],
        remat=r.remat, lora_dropout=r.model_cfg.llm.lora_dropout, iterations=len(r.iteration_ms),
        iteration_ms=json.dumps([round(x, 2) for x in r.iteration_ms]),
        iteration_median_ms=f"{iter_med:.3f}", bare_step_ms=json.dumps([round(x, 2) for x in bare]),
        bare_step_median_ms=f"{bare_med:.3f}", ratio=f"{iter_med / bare_med:.4f}",
        prefetch_wait_share=f"{sum(r.wait_ms) / sum(r.iteration_ms):.4f}",
        losses=json.dumps([round(x, 5) for x in losses]),
        val_losses=json.dumps([round(x.get("val_loss", float("nan")), 5) for x in lines[1:]]),
        checkpoints=json.dumps([[os.path.relpath(p, out), dir_bytes(p), round(s, 3)]
                                for p, s in saves]),
        run_s=f"{run_s:.3f}", peak_mem_gib=f"{peak:.3f}", card=repr(card))
    epochs = sorted(e for e, _ in checkpoint.list_checkpoints(out))
    best = checkpoint.list_checkpoints(os.path.join(out, "best"))
    if not (all(np.isfinite(losses)) and all(np.isfinite(x["val_loss"]) for x in lines[1:])):
        raise AssertionError(f"runner_bestsetup: non-finite losses {losses}, {lines[1:]}")
    if epochs != [0, 1, 2] or not best:
        raise AssertionError(f"runner_bestsetup: checkpoints {epochs}, best {best}")
    if not ("config" in lines[0] and [x.get("epoch") for x in lines[1:]] == [0, 1]):
        raise AssertionError(f"runner_bestsetup: log.txt holds {[sorted(x) for x in lines]}")
    if iter_med > ITERATION_RATIO_MAX * bare_med:
        raise AssertionError(f"runner_bestsetup: the median iteration {iter_med:.1f} ms exceeds "
                             f"{ITERATION_RATIO_MAX} x the bare step's {bare_med:.1f} ms")
    epoch1 = dict(checkpoint.list_checkpoints(out))[1]
    payload = checkpoint.load_checkpoint(epoch1)
    del r, batch
    torch.cuda.empty_cache()
    resume = runner_config(section, feat_root, os.path.join(tmp, "out"),
                           {**RUN_A_OVERRIDES, "resume_ckpt_path": epoch1})
    resumed = make_runner(resume, {"llm": frozen["llm"]}, tok, "run_a_resumed")
    say("runner", run="runner_bestsetup_resume", checkpoint=os.path.relpath(epoch1, out),
        start_epoch=resumed.start_epoch, step=resumed.state.step,
        optimizer_count=resumed.state.opt_state["count"], card=repr(card))
    if not (resumed.start_epoch == 1 and resumed.state.step == 6 == payload["step"]
            and resumed.state.opt_state["count"] == payload["opt_state"]["count"]):
        raise AssertionError(f"runner_bestsetup: resumed at epoch {resumed.start_epoch}, step "
                             f"{resumed.state.step}, count {resumed.state.opt_state['count']}")
    del resumed
    torch.cuda.empty_cache()


def runner_realtime(card: str, model: tuple, tmp: str, section: dict, feat_root: str) -> None:
    """Run B: the face and audio of each clip read raw (OpenFace crops, wav)
    and encoded by phase 4's CLIP ViT-L/14 and HuBERT-large inside the
    prefetcher; 1 epoch of 3 iterations at b = 2. The CLIP tower launches
    rows 11 and 12 once a layer for every batch the prefetcher encodes
    (HuBERT runs its plain stack): their counts over the run must be
    num_layers x the batches encoded, and nothing else may launch."""
    import os

    cfg, frozen, _, tok, _, _ = model
    _, vcfg, _, _ = encoder_configs(cfg)
    run_cfg = runner_config(section, feat_root, os.path.join(tmp, "out"), RUN_B_OVERRIDES,
                            RUN_B_DATASET)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r = make_runner(run_cfg, frozen, tok, "run_b", seed=6)
    encoded = []
    device_batch = r._device_batch

    def counting(batch):
        encoded.append(len(batch["names"]))
        return device_batch(batch)

    r._device_batch = counting
    t0 = time.perf_counter()
    _, launches = counted_call(r.train)
    run_s = time.perf_counter() - t0
    n = len(encoded)
    expected = {"attn_sublayer": n * vcfg.num_layers, "mlp_sublayer": n * vcfg.num_layers}
    losses = r.visualizer.history["loss"]
    say("runner", run="runner_realtime", batch=r.batch_size, iterations=len(r.iteration_ms),
        batches_encoded=n, launches=json.dumps({k: v for k, v in launches.items() if v}),
        launches_per_batch=json.dumps({k: v / n for k, v in launches.items() if v}),
        iteration_ms=json.dumps([round(x, 2) for x in r.iteration_ms]),
        prefetch_wait_share=f"{sum(r.wait_ms) / sum(r.iteration_ms):.4f}",
        losses=json.dumps([round(x, 5) for x in losses]), run_s=f"{run_s:.3f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}", card=repr(card))
    check_launches("runner_realtime", launches, expected)
    if not (n >= r.iters_per_epoch == len(losses) and all(np.isfinite(losses))):
        raise AssertionError(f"runner_realtime: {n} batches encoded, losses {losses}")
    del r
    torch.cuda.empty_cache()


def phase_runner(card: str, model: tuple) -> None:
    """Phase 9 on the phase-4 model: run A and run B in a temporary
    directory that the phase removes."""
    import shutil
    import tempfile

    from affectgpt_tpu_torch import paths

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="runner_")
    saved = {k: dict(v) for k, v in paths.TABLES.items()}
    try:
        section, feat_root = write_runner_corpus(tmp)
        say("runner", clips=RUNNER_CLIPS, corpus_seconds=f"{time.perf_counter() - t0:.3f}")
        runner_bestsetup(card, model, tmp, section, feat_root)
        runner_realtime(card, model, tmp, section, feat_root)
    finally:
        for k, v in saved.items():
            paths.TABLES[k].clear()
            paths.TABLES[k].update(v)
        shutil.rmtree(tmp, ignore_errors=True)
    say("runner", phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))


# ---------------------------------------------------------------------------
# Phase 10: load — HF directories of the phase-4 model read back by the
# port's loaders, tokenizer and command lines

LOAD_SHARDS = 4  # Qwen2.5-7B-Instruct ships 4 shards
LOAD_DISK_MARGIN = 4 * 2**30  # bytes left free beside the written directories
QWEN_VOCAB = 151643  # Qwen2.5's BPE vocabulary; its special tokens follow it
QWEN_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|object_ref_start|>",
                 "<|object_ref_end|>", "<|box_start|>", "<|box_end|>", "<|quad_start|>",
                 "<|quad_end|>", "<|vision_start|>", "<|vision_end|>", "<|vision_pad|>",
                 "<|image_pad|>", "<|video_pad|>", "<tool_call>", "</tool_call>",
                 "<|fim_prefix|>", "<|fim_middle|>", "<|fim_suffix|>", "<|fim_pad|>",
                 "<|repo_name|>", "<|file_sep|>"]
HYBIRD_CLIPS = 16
PRECOMPUTE_CLIPS = 8
HYBIRD_MESSAGE = "Please infer the person's emotional state and provide your reasoning process."
# features of the towers loaded from disk against the in-memory towers: CLIP's
# trees load bit for bit; HuBERT's positional conv is rematerialized from its
# weight norm (g·v/‖v‖ in f32, then bf16), one bf16 rounding of each weight
FEATURE_RTOL = 2e-2  # of the reference features' largest magnitude
_ST_DTYPE = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def hf_llm_entries(llm: dict) -> list:
    """(HF key, tensor, transpose) of the port's LLM tree in Qwen2ForCausalLM's
    names; transpose=True marks a dense [in, out] weight stored [out, in]."""
    out = [("model.embed_tokens.weight", llm["embed_tokens"]["table"], False)]
    for i, layer in enumerate(llm["layers"]):
        p = f"model.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out.append((f"{p}.self_attn.{name}.weight", layer[name]["w"], True))
            if "b" in layer[name]:
                out.append((f"{p}.self_attn.{name}.bias", layer[name]["b"], False))
        for name in ("gate_proj", "up_proj", "down_proj"):
            out.append((f"{p}.mlp.{name}.weight", layer[name]["w"], True))
        out.append((f"{p}.input_layernorm.weight", layer["input_ln"]["scale"], False))
        out.append((f"{p}.post_attention_layernorm.weight", layer["post_attn_ln"]["scale"],
                    False))
    out.append(("model.norm.weight", llm["final_ln"]["scale"], False))
    out.append(("lm_head.weight", llm["lm_head"]["w"], True))
    return out


def entry_bytes(entries: list) -> int:
    return sum(t.numel() * t.element_size() for _, t, _ in entries)


def write_safetensors(path: str, entries: list) -> None:
    """A safetensors file (8-byte little-endian header length, JSON header,
    data) written one tensor at a time from the card: each is transposed
    there when asked, copied to the host and written."""
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for key, t, transpose in entries:
        nbytes = t.numel() * t.element_size()
        shape = list(t.shape[::-1]) if transpose else list(t.shape)
        header[key] = {"dtype": _ST_DTYPE[t.dtype], "shape": shape,
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as handle:
        handle.write(len(blob).to_bytes(8, "little"))
        handle.write(blob)
        for _, t, transpose in entries:
            host = (t.t() if transpose else t).contiguous().cpu()
            handle.write(host.reshape(-1).view(torch.uint8).numpy().data)


def write_llm_dir(root: str, llm: dict, cfg: qwen2.QwenConfig) -> int:
    """Qwen2.5-7B-Instruct's layout: config.json with the published
    geometry, LOAD_SHARDS bf16 safetensors shards of about equal bytes and
    model.safetensors.index.json. Returns the bytes written."""
    import os

    entries = hf_llm_entries(llm)
    total = entry_bytes(entries)
    shards, cur, acc = [[]], 0, 0
    for e in entries:
        if acc >= (len(shards)) * total / LOAD_SHARDS and len(shards) < LOAD_SHARDS:
            shards.append([])
        shards[-1].append(e)
        acc += e[1].numel() * e[1].element_size()
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(root, name), shard)
        weight_map.update({key: name for key, _, _ in shard})
    with open(os.path.join(root, "model.safetensors.index.json"), "w") as handle:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, handle)
    with open(os.path.join(root, "config.json"), "w") as handle:
        json.dump({"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
                   "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                   "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads, "vocab_size": cfg.vocab_size,
                   "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_eps,
                   "tie_word_embeddings": False, "torch_dtype": "bfloat16",
                   "hidden_act": "silu", "max_position_embeddings": 32768}, handle)
    return total


def learn_merges(words) -> list:
    """BPE merges learned from `words` (a Counter of symbol strings) by the
    rule of HF's trainer: the most frequent adjacent pair, ties to the
    smaller pair, merged everywhere, until every word is one piece."""
    import collections

    splits = {w: list(w) for w in words}
    merges = []
    while True:
        pairs = collections.Counter()
        for w, n in words.items():
            s = splits[w]
            for pair in zip(s, s[1:]):
                pairs[pair] += n
        if not pairs:
            return merges
        best = max(pairs.values())
        a, b = min(p for p, n in pairs.items() if n == best)
        merges.append((a, b))
        for w, s in splits.items():
            k, out = 0, []
            while k < len(s):
                if k + 1 < len(s) and s[k] == a and s[k + 1] == b:
                    out.append(a + b)
                    k += 2
                else:
                    out.append(s[k])
                    k += 1
            splits[w] = out


def train_bpe(texts: list) -> tuple:
    """A byte-level BPE learned from `texts` (learn_merges over Qwen2's
    pre-tokenized pieces): (vocab, merges), the 256 byte tokens first."""
    import collections
    import unicodedata

    from affectgpt_tpu_torch import tokenization

    words = collections.Counter()
    for text in texts:
        for piece in tokenization.pre_tokenize(unicodedata.normalize("NFC", text)):
            words["".join(tokenization.BYTE_TO_CHAR[b] for b in piece.encode())] += 1
    merges = learn_merges(words)
    vocab = {tokenization.BYTE_TO_CHAR[b]: b for b in range(256)}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return vocab, merges


def filler_pieces():
    """Vocabulary entries past the learned ones: the two- and three-character
    strings of letters and digits, short as Qwen2.5's own entries are, so a
    random model's sampled tokens decode to text that encodes again at a
    few tokens each (phase 12's judge feeds its answers back as prompts)."""
    import itertools
    import string

    chars = string.ascii_letters + string.digits
    for n in (2, 3):
        for piece in itertools.product(chars, repeat=n):
            yield "".join(piece)


def write_tokenizer(root: str, texts: list) -> dict:
    """tokenizer.json of Qwen2's form (NFC, its split pattern, byte-level
    BPE and decoder) with merges learned from `texts`, the vocabulary
    filled to Qwen2.5's 151643 entries (filler_pieces) so the 22 special
    tokens take their ids 151643-151664, and tokenizer_config.json with eos
    <|im_end|>."""
    import itertools
    import os

    from affectgpt_tpu_torch import tokenization

    vocab, merges = train_bpe(texts)
    learned = len(vocab)
    for piece in itertools.takewhile(lambda _: len(vocab) < QWEN_VOCAB, filler_pieces()):
        vocab.setdefault(piece, len(vocab))
    if len(vocab) != QWEN_VOCAB:
        raise AssertionError(f"load: the tokenizer's vocabulary has {len(vocab)} entries")
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": QWEN_VOCAB + i, "content": tok, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False,
                          "special": True} for i, tok in enumerate(QWEN_SPECIALS)],
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": tokenization.QWEN2_PATTERN},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                    "use_regex": False},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "", "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": False, "vocab": vocab,
                  "merges": [f"{a} {b}" for a, b in merges]},
    }
    with open(os.path.join(root, "tokenizer.json"), "w", encoding="utf-8") as handle:
        json.dump(spec, handle, ensure_ascii=False)
    with open(os.path.join(root, "tokenizer_config.json"), "w") as handle:
        json.dump({"eos_token": "<|im_end|>", "pad_token": "<|endoftext|>", "bos_token": None,
                   "clean_up_tokenization_spaces": False, "model_max_length": 131072,
                   "tokenizer_class": "Qwen2Tokenizer"}, handle)
    return {"merges": len(merges), "learned_vocab": learned}


def hf_clip_entries(tree: dict) -> list:
    """(HF key, tensor, transpose) of a CLIP vision tree in CLIPModel's
    names (vision_model.* and visual_projection)."""
    pre = "vision_model"
    w = tree["patch_embed"]["w"]  # [3·P·P, width], channel-major patches
    p = int(round((w.shape[0] // 3) ** 0.5))
    out = [(f"{pre}.embeddings.patch_embedding.weight",
            w.t().contiguous().reshape(w.shape[1], 3, p, p), False),
           (f"{pre}.embeddings.class_embedding", tree["class_embed"], False),
           (f"{pre}.embeddings.position_embedding.weight", tree["pos_embed"]["table"], False)]

    def ln(key, leaf):
        return [(f"{key}.weight", leaf["scale"], False), (f"{key}.bias", leaf["bias"], False)]

    def dense(key, leaf):
        return [(f"{key}.weight", leaf["w"], True)] + \
            ([(f"{key}.bias", leaf["b"], False)] if "b" in leaf else [])

    out += ln(f"{pre}.pre_layrnorm", tree["pre_ln"])
    for i, blk in enumerate(tree["blocks"]):
        k = f"{pre}.encoder.layers.{i}"
        out += ln(f"{k}.layer_norm1", blk["ln1"]) + ln(f"{k}.layer_norm2", blk["ln2"])
        for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            out += dense(f"{k}.self_attn.{name}", blk["attn"][key])
        out += dense(f"{k}.mlp.fc1", blk["mlp_in"]) + dense(f"{k}.mlp.fc2", blk["mlp_out"])
    out += ln(f"{pre}.post_layernorm", tree["post_ln"])
    out += dense("visual_projection", tree["proj"])
    return out


def hubert_weight_norm(w: torch.Tensor) -> tuple:
    """(g, v) of a weight norm over the out and in axes that gives back `w`:
    v = w, g = ‖w‖ (norm in f32, stored in w's dtype)."""
    g = torch.linalg.vector_norm(w.float(), dim=(0, 1), keepdim=True)
    return g.to(w.dtype), w


def hf_hubert_state(tree: dict) -> dict:
    """HuBERT's tree → a HubertModel state dict on the host (HF's [out, in]
    layout), the positional conv in the `parametrizations.weight.original0
    / original1` form that torch >= 2.1 saves."""
    sd = {}

    def put(key, t, transpose=False):
        sd[key] = (t.t() if transpose else t).contiguous().cpu()

    def ln(key, leaf):
        put(f"{key}.weight", leaf["scale"])
        put(f"{key}.bias", leaf["bias"])

    def dense(key, leaf):
        put(f"{key}.weight", leaf["w"], True)
        if "b" in leaf:
            put(f"{key}.bias", leaf["b"])

    for i, conv in enumerate(tree["convs"]):
        k = f"feature_extractor.conv_layers.{i}"
        put(f"{k}.conv.weight", conv["w"])
        put(f"{k}.conv.bias", conv["b"])
        ln(f"{k}.layer_norm", conv["ln"])
    ln("feature_projection.layer_norm", tree["feat_proj_ln"])
    dense("feature_projection.projection", tree["feat_proj"])
    g, v = hubert_weight_norm(tree["pos_conv"]["w"])
    put("encoder.pos_conv_embed.conv.parametrizations.weight.original0", g)
    put("encoder.pos_conv_embed.conv.parametrizations.weight.original1", v)
    put("encoder.pos_conv_embed.conv.bias", tree["pos_conv"]["b"])
    for i, layer in enumerate(tree["layers"]):
        k = f"encoder.layers.{i}"
        ln(f"{k}.layer_norm", layer["attn_ln"])
        ln(f"{k}.final_layer_norm", layer["ffn_ln"])
        for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            dense(f"{k}.attention.{name}", layer["attn"][key])
        dense(f"{k}.feed_forward.intermediate_dense", layer["ffn_in"])
        dense(f"{k}.feed_forward.output_dense", layer["ffn_out"])
    ln("encoder.layer_norm", tree["final_ln"])
    return sd


@contextlib.contextmanager
def rss_peak(record: dict):
    """Samples the process's resident set (/proc/self/statm, read only) every
    5 ms in a thread: record["before_gib"] is the first reading,
    record["peak_gib"] the largest."""
    import os
    import threading

    page = os.sysconf("SC_PAGE_SIZE")
    stop, peak = threading.Event(), [0]

    def rss() -> int:
        with open("/proc/self/statm") as handle:
            return int(handle.read().split()[1]) * page

    record["before_gib"] = rss() / 2**30

    def sample():
        while not stop.is_set():
            peak[0] = max(peak[0], rss())
            stop.wait(0.005)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield record
    finally:
        stop.set()
        thread.join()
        record["peak_gib"] = peak[0] / 2**30


def leaf_pairs(got, want, prefix: str = ""):
    """(path, got leaf, want leaf) over two trees of the same structure."""
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"load: {prefix} has keys {sorted(got)}, want {sorted(want)}")
        for k in want:
            yield from leaf_pairs(got[k], want[k], f"{prefix}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"load: {prefix} has {len(got)} items, want {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            yield from leaf_pairs(g, w, f"{prefix}/{i}")
    else:
        yield prefix, got, want


def check_bits(what: str, got, want, skip=()) -> int:
    """Asserts every leaf of `got` equals `want`'s bit for bit (dtype, shape
    and values; `skip` paths are compared by the caller); returns the
    leaves compared."""
    bad, n = [], 0
    for path, g, w in leaf_pairs(got, want):
        if path in skip:
            continue
        n += 1
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            bad.append(path)
    if bad:
        raise AssertionError(f"load: {what}: {len(bad)} of {n} tensors differ from those "
                             f"written, e.g. {bad[:5]}")
    return n


def dir_gb(path: str) -> float:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files) / 1e9


def load_texts() -> list:
    """The text the smoke's BPE learns from: the prompts the smoke's paths
    send (the clips' subtitles in every face_or_frame mode under both
    questions, the AU agent's prompts for au_rows(), the runner corpus's
    reasons), with the patch tokens taken out."""
    import re

    from affectgpt_tpu_torch import constants, prompts

    texts = []
    for mode in prompts.NEEDED_DATA:
        for question in (QUESTION, HYBIRD_MESSAGE):
            for sub in SUBTITLES:
                texts.append(prompts.get_prompt_for_multimodal(mode, sub, question,
                                                               "brows lowered, lips pressed"))
    texts += [au_agent.build_chat_prompt(au_agent.build_au_input(au_agent.parse_openface_row(r)))
              for r in au_rows()]
    texts += [f"In clip {i}, the speaker's voice drops and the face tightens, so the mood reads "
              f"as {o.strip('[]') or 'neutral'}." for i, o in enumerate(OPENSETS)]
    pattern = "|".join(re.escape(t) for t in constants.ALL_PATCH_TOKENS)
    return [re.sub(pattern, " ", t) for t in texts]


def write_mer2023_corpus(root: str, n: int, seed: int = 11) -> tuple:
    """A MER2023-style corpus of n clips: label-6way.npz (test1_corpus),
    transcription-engchi-polish.csv and preextracted frame / face [8, 768]
    and audio [8, 1024] features. Returns (the `paths:` section, the
    feature root)."""
    import csv
    import os

    rng = np.random.RandomState(seed)
    data, feat_root = os.path.join(root, "mer2023"), os.path.join(root, "features")
    names = [f"sample_{i:05d}" for i in range(n)]
    os.makedirs(data, exist_ok=True)
    for sub, dim in (("frame_CLIP_VIT_LARGE_uniform_8frms", 768),
                     ("face_CLIP_VIT_LARGE_8frms", 768), ("audio_HUBERT_LARGE_8clips", 1024)):
        os.makedirs(os.path.join(feat_root, "MER2023", sub))
        for name in names:
            np.save(os.path.join(feat_root, "MER2023", sub, f"{name}.npy"),
                    rng.randn(8, dim).astype(np.float32))
    emos = ["happy", "sad", "angry", "neutral", "worried", "surprise"]
    corpus = {name: {"emo": emos[i % len(emos)]} for i, name in enumerate(names)}
    label = os.path.join(data, "label-6way.npz")
    np.savez(label, train_corpus=np.array(corpus, dtype=object),
             test1_corpus=np.array(corpus, dtype=object))
    subtitles = os.path.join(data, "transcription-engchi-polish.csv")
    with open(subtitles, "w", newline="") as handle:
        writer = csv.writer(handle)
        writer.writerow(["name", "english"])
        writer.writerows([name, SUBTITLES[i % len(SUBTITLES)]] for i, name in enumerate(names))
    section = {"DATA_DIR": {"MER2023": data}, "PATH_TO_LABEL": {"MER2023": label},
               "PATH_TO_TRANSCRIPTIONS": {"MER2023": subtitles}}
    return section, feat_root


def write_raw_clips(root: str, n: int, seed: int = 12) -> dict:
    """n raw clips for the precompute: 8 decoded 720p frames (a
    `{name}.avi.frames.npy` dump beside the absent video, which
    data/media.py reads when no decoder takes the file), 16 OpenFace crops
    of 112² ({root}/openface_face/{name}/{name}.npy) and 2 s of 16 kHz mono
    audio (a wav file). Returns {name: the wav's path}."""
    import os
    import wave

    rng = np.random.RandomState(seed)
    clips = {}
    for sub in ("video", "audio", "openface_face"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        name = f"raw_{i:04d}"
        frames = rng.randint(0, 256, (8, 720, 1280, 3), dtype=np.uint8)
        np.save(os.path.join(root, "video", f"{name}.avi.frames.npy"), frames)
        faces = rng.randint(0, 256, (FACE_CROPS, 112, 112, 3), dtype=np.uint8)
        os.makedirs(os.path.join(root, "openface_face", name))
        np.save(os.path.join(root, "openface_face", name, f"{name}.npy"), faces)
        wav = os.path.join(root, "audio", f"{name}.wav")
        pcm = (np.clip(rng.randn(RT_SAMPLES) * 0.1, -1, 1) * 32767).astype("<i2")
        with wave.open(wav, "wb") as handle:
            handle.setnchannels(1)
            handle.setsampwidth(2)
            handle.setframerate(16000)
            handle.writeframes(pcm.tobytes())
        clips[name] = wav
    return clips


def hybird_launches(tree: str, layers: int, steps: int, b: int, t_prefill: int) -> dict:
    """The kernel launches of one inference_hybird batch: the decode kernels
    once a layer and step (bf16), or each int4 product once a call at the
    M that routes it (qwen2._lora_dense): the decode's 7 a layer plus the
    lm_head at M = b, the prefill's last-token lm_head at M = b, and the
    prefill's 7 a layer at M = b·t unless that M takes the dequantize
    route."""
    if tree == "bf16":
        return {"decode_qkv": steps * layers, "decode_mlp_bf16": steps * layers}
    out = {}

    def add(m, count):
        if m <= quant.PALLAS_DEQUANT_MAX_M:
            name = "int4_matmul_smallm" if m < quant.PALLAS_INT4_MIN_M else "int4_matmul"
            out[name] = out.get(name, 0) + count
    add(b, steps * (7 * layers + 1) + 1)
    add(b * t_prefill, 7 * layers)
    return out


def load_gate_bootstrap(card: str, model: tuple, dirs: dict) -> tuple:
    """Gate 1: bootstrap.build_model on the written directories; every LLM
    and CLIP tensor equals the one written, HuBERT's too but its positional
    conv, which equals the f32 numpy materialization of the written g, v.
    Prints the load's seconds, GB/s and host peak RSS."""
    cfg, frozen, _, _, _, _ = model
    torch.cuda.synchronize()
    record = {}
    t0 = time.perf_counter()
    with rss_peak(record):
        lcfg, loaded, _, tok = bootstrap.build_model(
            {"llama_model": "Qwen25", "keep_full_llm": True}, with_encoders=True, device="cuda")
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gb = sum(dir_gb(d) for d in dirs.values())
    n_llm = check_bits("llm", loaded["llm"], frozen["llm"])
    n_clip = check_bits("CLIP", loaded["visual_encoder"], frozen["visual_encoder"])
    pos = "/pos_conv/w"
    n_hub = check_bits("HuBERT", loaded["acoustic_encoder"], frozen["acoustic_encoder"], {pos})
    g, v = hubert_weight_norm(frozen["acoustic_encoder"]["pos_conv"]["w"])
    g, v = g.float().cpu().numpy(), v.float().cpu().numpy()
    norm = np.linalg.norm(v, axis=(0, 1), keepdims=True)
    want_pos = torch.from_numpy(g * v / np.maximum(norm, np.float32(1e-12))).to(torch.bfloat16)
    got_pos = loaded["acoustic_encoder"]["pos_conv"]["w"]
    pos_err = float((got_pos.float() - frozen["acoustic_encoder"]["pos_conv"]["w"].float())
                    .abs().max())
    say("load", gate="bootstrap", layers=len(loaded["llm"]["layers"]), tensors_equal=n_llm + n_clip + n_hub,
        llm_tensors=n_llm, clip_tensors=n_clip, hubert_tensors=n_hub,
        pos_conv_vs_written_w_max_abs=f"{pos_err:.6g}", load_seconds=f"{seconds:.3f}",
        gb=f"{gb:.3f}", gb_per_s=f"{gb / seconds:.3f}", page_cache="warm (written by this phase)",
        host_rss_before_gib=f"{record['before_gib']:.3f}",
        host_peak_rss_gib=f"{record['peak_gib']:.3f}",
        device_gib=f"{tree_gib(loaded):.3f}", card=repr(card))
    if not torch.equal(got_pos.cpu(), want_pos):
        raise AssertionError("load: HuBERT's pos_conv is not g·v/‖v‖ of the written g, v")
    if lcfg.llm != cfg.llm:
        raise AssertionError(f"load: the loaded config {lcfg.llm} is not the preset's")
    return loaded, tok


def load_gate_serving(card: str, model: tuple, loaded: dict, tok) -> None:
    """Gate 2: Chat.answer_batch on the 8 clips, greedy, from the loaded LLM
    and from the in-memory one, both under the loaded tokenizer: the same
    tokens; rows 1-2 launch num_layers x the decode steps in each. Prints the
    prompt tokens under the BPE and the ByteTokenizer."""
    from affectgpt_tpu_torch.tokenization import ByteTokenizer

    cfg, frozen, trainable, byte_tok, feats, _ = model
    tokens, runs = {}, {}
    for side, llm in (("loaded", loaded["llm"]), ("in_memory", frozen["llm"])):
        chat = Chat({**frozen, "llm": llm}, trainable, cfg, tok, max_len=MAX_LEN)
        record = []

        def recorder(inner):
            def wrapped(*args, **kwargs):
                out = inner(*args, **kwargs)
                record.append(out[0].cpu())
                return out
            return wrapped

        with patched(gen, "generate", recorder):
            t0 = time.perf_counter()
            texts, launches = counted_call(lambda: chat.answer_batch(
                MODE, SUBTITLES, QUESTION, feats, max_new_tokens=NEW_TOKENS, do_sample=False))
            runs[side] = time.perf_counter() - t0
        check_launches(f"load {side}", launches, hybird_launches(
            "bf16", cfg.llm.num_layers, NEW_TOKENS, BATCH, 0))
        check_strings(f"load {side}", texts, BATCH)
        tokens[side] = record[0]
    bpe_ids, bpe_len, _ = Chat(frozen, trainable, cfg, tok).build_prompt_batch(
        MODE, SUBTITLES, QUESTION)
    byte_ids, byte_len, _ = Chat(frozen, trainable, cfg, ByteTokenizer()).build_prompt_batch(
        MODE, SUBTITLES, QUESTION)
    same = int((tokens["loaded"] == tokens["in_memory"]).all(dim=1).sum())
    say("load", gate="serving", rows_with_the_same_tokens=f"{same}/{BATCH}",
        new_tokens=NEW_TOKENS, launches_each=json.dumps(launches),
        prompt_tokens_bpe=bpe_ids.shape[1], prompt_tokens_byte=byte_ids.shape[1],
        mean_prompt_tokens_bpe=f"{float(bpe_len.mean()):.2f}",
        mean_prompt_tokens_byte=f"{float(byte_len.mean()):.2f}",
        vocab_size=tok.vocab_size, eos=tok.eos_token_id, bos=tok.bos_token_id,
        answer_s=json.dumps({k: round(v, 3) for k, v in runs.items()}), card=repr(card))
    if same != BATCH:
        raise AssertionError(f"load: the loaded model's greedy tokens differ on "
                             f"{BATCH - same} of {BATCH} rows")


def load_gate_hybird(card: str, model: tuple, tmp: str) -> None:
    """Gate 3: inference_hybird.main over HYBIRD_CLIPS preextracted
    MER2023-style clips with a checkpoint that save_checkpoint wrote, once
    with the default serving weights and once with --int4 (both --greedy):
    one .npz of HYBIRD_CLIPS answers each, the kernels launched as their
    switches say and no other."""
    import os

    from affectgpt_tpu_torch import inference_hybird
    from affectgpt_tpu_torch.training import checkpoint

    cfg = model[0]
    section, feat_root = write_mer2023_corpus(tmp, HYBIRD_CLIPS)
    trainable = affectgpt.init_trainable(torch.Generator(device="cuda").manual_seed(13), cfg)
    g = torch.Generator(device="cuda").manual_seed(14)
    for layer in trainable["lora"]["layers"]:  # a LoRA that the merge changes
        for leaf in layer.values():
            leaf["b"] = nn.normal(g, tuple(leaf["b"].shape), 1e-3, leaf["b"].dtype)
    run = os.path.join(tmp, "out", "exp_load", "run")
    checkpoint.save_checkpoint(run, 0, trainable, loss=1.0)
    del trainable
    raw = {"model": {"llama_model": "Qwen25", "keep_full_llm": True, "skip_encoders": True},
           "datasets": {"mer2023": {"face_or_frame": MODE, "use_preextracted_frame": True,
                                    "use_preextracted_face": True,
                                    "use_preextracted_audio": True,
                                    "preextracted_root": feat_root}},
           "run": {"output_dir": os.path.join(tmp, "out")},
           "inference": {"face_or_frame": MODE}, "paths": section}
    cfg_path = os.path.join(tmp, "exp_load.json")
    with open(cfg_path, "w") as handle:
        json.dump(raw, handle)
    cwd = os.getcwd()
    for tree, flags in (("bf16", []), ("int4", ["--int4"])):
        os.chdir(tmp)
        shapes = []

        def recorder(inner):
            def wrapped(*args, **kwargs):
                shapes.append(tuple(args[2].shape))
                return inner(*args, **kwargs)
            return wrapped

        try:
            with patched(qwen2, "forward", recorder):
                t0 = time.perf_counter()
                _, launches = counted_call(lambda: inference_hybird.main(
                    ["--cfg-path", cfg_path, "--dataset", "MER2023", "--batch_size",
                     str(HYBIRD_CLIPS), "--max_new_tokens", str(NEW_TOKENS), "--greedy",
                     "--ckpt_root", run, "--device", "cuda", *flags]))
                seconds = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        out = os.path.join(tmp, "output", "results", "exp_load", "result-mer2023", "0.npz")
        with np.load(out, allow_pickle=True) as npz:
            keys, answers = sorted(npz.files), npz["name2reason"].tolist()
        os.remove(out)
        expected = hybird_launches(tree, cfg.llm.num_layers, NEW_TOKENS, HYBIRD_CLIPS,
                                   shapes[0][1])
        say("load", gate="inference_hybird", tree=tree, flags=json.dumps(flags),
            clips=len(answers), npz_keys=json.dumps(keys), prefill=list(shapes[0]),
            forwards=len(shapes), launches=json.dumps({k: v for k, v in launches.items() if v}),
            sample=json.dumps(next(iter(answers.values()), "")[:60]),
            run_s=f"{seconds:.3f}", card=repr(card))
        check_launches(f"inference_hybird {tree}", launches, expected)
        if keys != ["name2reason"] or len(answers) != HYBIRD_CLIPS \
                or not all(isinstance(a, str) for a in answers.values()):
            raise AssertionError(f"inference_hybird {tree}: {keys}, {len(answers)} answers")
        if len(shapes) != NEW_TOKENS + 1:
            raise AssertionError(f"inference_hybird {tree}: {len(shapes)} forwards")
        torch.cuda.empty_cache()


def load_gate_precompute(card: str, model: tuple, tmp: str) -> None:
    """Gate 4: the precompute entry over PRECOMPUTE_CLIPS raw clips with the
    towers loaded from their directories writes the frame, face, audio and
    multi caches; each equals encode_media_features (frame, face) or
    hubert.encode_clips (audio) on the in-memory towers, one clip a call as
    the entry calls them, within FEATURE_RTOL; rows 11 and 12 launch
    num_layers times per CLIP call (two calls a clip) and nothing else
    launches."""
    import os

    from affectgpt_tpu_torch import extract_multimodal_features_precompute as pre
    from affectgpt_tpu_torch.data import media
    from affectgpt_tpu_torch.ops import audio as audio_ops

    cfg, frozen, _, _, _, _ = model
    _, vcfg, _, _ = encoder_configs(cfg)
    root = os.path.join(tmp, "raw")
    clips = write_raw_clips(root, PRECOMPUTE_CLIPS)
    names = os.path.join(tmp, "names.txt")
    with open(names, "w") as handle:
        handle.write("\n".join(clips) + "\n")
    save_root = os.path.join(tmp, "feats")
    t0 = time.perf_counter()
    _, launches = counted_call(lambda: pre.main([
        "--dataset", "MER2023", "--sample_list", names, "--modality", "all",
        "--video_root", os.path.join(root, "video"), "--face_root",
        os.path.join(root, "openface_face"), "--audio_root", os.path.join(root, "audio"),
        "--save_root", save_root, "--device", "cuda"]))
    seconds = time.perf_counter() - t0
    calls = 2 * PRECOMPUTE_CLIPS
    expected = {"attn_sublayer": calls * vcfg.num_layers, "mlp_sublayer": calls * vcfg.num_layers}
    encoder = {"frame": "CLIP_VIT_LARGE", "face": "CLIP_VIT_LARGE", "audio": "HUBERT_LARGE",
               "multi": "CLIP_VIT_LARGE+HUBERT_LARGE"}
    acfg = hubert.HubertConfig.large()
    errs = dict.fromkeys(encoder, 0.0)
    for name, wav in clips.items():
        got = {m: np.load(media.feature_cache_path(save_root, "MER2023", m, enc, name))
               for m, enc in encoder.items()}
        want = {}
        for m, raw in (("frame", media.read_video_frames(
                os.path.join(root, "video", f"{name}.avi"), 8)), ("face", media.read_face_crops(
                os.path.join(root, "openface_face", name, f"{name}.npy"), 8))):
            want[m] = encode_media_features(
                frozen, None, {m: torch.as_tensor(raw[None], device="cuda")},
                vision_cfg=vcfg)[m][0].float().cpu().numpy()
        audio = torch.as_tensor(audio_ops.host_audio_clips(*media.read_wav(wav))[None],
                                device="cuda")
        want["audio"] = hubert.encode_clips(frozen["acoustic_encoder"], acfg, audio)[0] \
            .float().cpu().numpy()
        want["multi"] = np.concatenate([want["face"].mean(0), want["audio"].mean(0)])
        for m in errs:
            if got[m].shape != want[m].shape or not np.isfinite(got[m]).all():
                raise AssertionError(f"precompute {name} {m}: {got[m].shape} vs "
                                     f"{want[m].shape}, or non-finite")
            errs[m] = max(errs[m], float(np.abs(got[m] - want[m]).max()
                                         / max(np.abs(want[m]).max(), 1e-6)))
    say("load", gate="precompute", clips=PRECOMPUTE_CLIPS, clip_calls=calls,
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        rel_err=json.dumps({k: float(f"{v:.6g}") for k, v in errs.items()}),
        rtol=FEATURE_RTOL, run_s=f"{seconds:.3f}", card=repr(card))
    check_launches("precompute", launches, expected)
    if max(errs.values()) > FEATURE_RTOL:
        raise AssertionError(f"precompute: features off the in-memory towers' by {errs}")


def phase_load(card: str, model: tuple, tmp: str) -> dict:
    """Phase 10: write the phase-4 model as HF directories (the LLM at its
    own depth in 4 bf16 shards with a tokenizer, CLIP ViT-L/14's
    model.safetensors, HuBERT-large's pytorch_model.bin) into `tmp`, point
    the path tables at them, and run the four gates. The directories stay
    for phase 12 (the caller removes `tmp`); returns {"llm", "clip",
    "hubert": their paths}."""
    import os
    import shutil

    from affectgpt_tpu_torch import paths

    t0 = time.perf_counter()
    cfg, frozen, _, _, _, _ = model
    saved = {k: dict(v) for k, v in paths.TABLES.items()}
    try:
        free = shutil.disk_usage(tmp).free
        llm_bytes = entry_bytes(hf_llm_entries(frozen["llm"]))
        towers = tree_gib([frozen["visual_encoder"], frozen["acoustic_encoder"]]) * 2**30
        say("load", tmp_free_gb=f"{free / 1e9:.3f}",
            needed_gb=f"{(llm_bytes + towers + LOAD_DISK_MARGIN) / 1e9:.3f}",
            layers=len(frozen["llm"]["layers"]), card=repr(card))
        if llm_bytes + towers + LOAD_DISK_MARGIN > free:
            raise AssertionError(f"load: {free / 1e9:.1f} GB free in {tmp}, the directories "
                                 f"need {(llm_bytes + towers) / 1e9:.1f} GB")
        dirs = {k: os.path.join(tmp, k) for k in ("llm", "clip", "hubert")}
        for d in dirs.values():
            os.makedirs(d)
        t1 = time.perf_counter()
        write_llm_dir(dirs["llm"], frozen["llm"], cfg.llm)
        bpe = write_tokenizer(dirs["llm"], load_texts())
        write_safetensors(os.path.join(dirs["clip"], "model.safetensors"),
                          hf_clip_entries(frozen["visual_encoder"]))
        torch.save(hf_hubert_state(frozen["acoustic_encoder"]),
                   os.path.join(dirs["hubert"], "pytorch_model.bin"))
        write_s = time.perf_counter() - t1
        say("load", written_gb=json.dumps({k: round(dir_gb(d), 3) for k, d in dirs.items()}),
            shards=LOAD_SHARDS, bpe_merges=bpe["merges"], bpe_learned_vocab=bpe["learned_vocab"],
            write_s=f"{write_s:.3f}", card=repr(card))
        paths.PATH_TO_LLM["Qwen25"] = dirs["llm"]
        paths.PATH_TO_VISUAL["CLIP_VIT_LARGE"] = dirs["clip"]
        paths.PATH_TO_AUDIO["HUBERT_LARGE"] = dirs["hubert"]
        loaded, tok = load_gate_bootstrap(card, model, dirs)
        load_gate_serving(card, model, loaded, tok)
        del loaded
        torch.cuda.empty_cache()
        load_gate_hybird(card, model, tmp)
        load_gate_precompute(card, model, tmp)
    finally:
        for k, v in saved.items():
            paths.TABLES[k].clear()
            paths.TABLES[k].update(v)
    say("load", phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))
    return dirs


# ---------------------------------------------------------------------------
# Phase 11: the encoder zoo, and the Llama-2 and Baichuan2 families

ZOO_CLIPS = 2  # clips of a zoo tower call: 2 clips x 8 frames (or 8 audio clips)
# row 13 at the zoo's shapes: (images or audio clips, heads, tokens, head_dim)
ZOO_ATTENTION = {
    "dinov2": (ZOO_CLIPS * 8 * 2, 16, 1370, 64),  # frame + face, 518 px, patch 14
    "siglip": (ZOO_CLIPS * 8 * 2, 16, 729, 72),  # 384 px, patch 14, 1152 / 16
    "imagebind": (ZOO_CLIPS * 8, 12, 229, 64),  # 12 x 19 mel patches + cls
    "clip": (ZOO_CLIPS * 8 * 2, 16, 257, 64),  # held beside them: CLIP's old shape
}
# a tower's FUSED_MHA="auto" route against "0" in bf16: the kernel and the
# plain chain round at the same points but sum in another order, and the
# difference passes through every later layer in bf16
ZOO_REL_TOL = 0.02  # ||auto - plain|| / ||plain|| of the features
ZOO_TOWERS = ("DINO2_LARGE", "SigLIP_SO", "EVA_CLIP_G_NO_QFORMER", "EVA_CLIP_G",
              "WAVLM_LARGE", "IMAGEBIND", "DATA2VEC_BASE")
# the two LLM families end to end: (visual tower, acoustic tower)
FAMILIES = {"Llama2": ("SigLIP_SO", "WAVLM_LARGE"), "Baichuan2": ("DINO2_LARGE", "IMAGEBIND")}
SP_SPECIALS = ["<unk>", "<s>", "</s>"]


def zoo_attention(card: str, shapes: Optional[dict] = None, tag: str = "zoo") -> dict:
    """Row 13 against its plain version at `shapes` (ZOO_ATTENTION unless
    given; {name: (b, heads, n, head_dim)}), in the [b, n, h, d] layout
    nn.mha hands it and in [b, h, n, d]: the plan's mode, the largest error,
    the kernel's device ms (CUDA graph, two copies of q, k, v a replay
    cycle), the plain version's, one SDPA call's on the same inputs, and the
    bound (q, k, v and out moved once; the two products' operations).
    Returns {shape: record}."""
    g = torch.Generator(device="cuda").manual_seed(23)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for shape, (b, heads, n, d) in (shapes or ZOO_ATTENTION).items():
        sets = [tuple(torch.randn((b, n, heads, d), generator=g, device="cuda")
                      .to(torch.bfloat16) for _ in range(3)) for _ in range(2)]
        q, k, v = sets[0]
        heads_first = [t.transpose(1, 2) for t in sets[0]]
        want = fused_vit_attention_reference(*heads_first, n)
        got = fused_self_attention(q, k, v, n)
        if not torch.equal(got, fused_self_attention(q, k, v, n)):
            raise AssertionError(f"zoo fused_vit_attention {shape}: two calls differ")
        err, rel = compare("fused_vit_attention", got.transpose(1, 2), want, b)
        contiguous = [t.contiguous() for t in heads_first]
        err2, _ = compare("fused_vit_attention", fused_vit_attention(*contiguous, n), want, b)
        plan = vit_attention_plan(n, n, b=b, heads=heads, sms=sm_count(), head_dim=d)
        lib_err = float((sdpa(*heads_first).float() - want.float()).abs().max())
        del want, contiguous
        times = {"ms": graph_ms([lambda t=t: fused_self_attention(*t, n) for t in sets] * 4),
                 "plain_ms": graph_ms([lambda: fused_vit_attention_reference(*heads_first, n)],
                                      reps=5),
                 "library_ms": graph_ms([lambda t=t: sdpa(*(x.transpose(1, 2) for x in t))
                                         for t in sets] * 4)}
        cost = bound(4 * b * heads * n * d * 2, 4 * b * heads * n * n * d)
        out[shape] = {"b": b, "heads": heads, "n": n, "head_dim": d, "mode": plan["kernel"],
                      "max_abs_err": max(err, err2), **times, **cost}
        say(tag, kernel="fused_vit_attention", shape=shape, b=b, heads=heads, n=n,
            head_dim=d, mode=plan["kernel"], max_abs_err=f"{max(err, err2):.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL,
            **{k: f"{t:.5f}" for k, t in times.items()}, bound_ms=f"{cost['bound_ms']:.5f}",
            bound_by=cost["bound_by"], sdpa_max_abs_err_vs_plain=f"{lib_err:.6g}",
            plan=json.dumps(plan), card=repr(card))
        del sets, q, k, v, heads_first, got
        torch.cuda.empty_cache()
    return out


def zoo_input(name: str, cfg, spec, raw: dict) -> torch.Tensor:
    """A tower call's input from the realtime media of ZOO_CLIPS clips: the
    frames resized and normalized as the tower's processor does, the 2 s
    audio clips, or their log-mels (IMAGEBIND)."""
    if name in encoders.VISUAL:
        return prepare_frames(raw["frame"][:ZOO_CLIPS], cfg.image_size, spec.normalize)
    clips = raw["audio"][:ZOO_CLIPS]
    if name == "IMAGEBIND":
        return mel_clips(clips)
    return clips


def mel_clips(clips: torch.Tensor) -> torch.Tensor:
    """[b, t, 1, samples] audio → [b, t, 1, 128, 204] normalized log-mels
    (ops/audio.transform_audio), IMAGEBIND's input."""
    from affectgpt_tpu_torch.ops import audio

    b, t = clips.shape[:2]
    mels = audio.transform_audio(clips.float().reshape(b * t, 1, clips.shape[-1]))
    return mels.reshape(b, t, *mels.shape[1:])


def zoo_towers(card: str, raw: dict, tower_cfgs: Optional[dict] = None) -> dict:
    """Each zoo tower at registry geometry (or tower_cfgs[name]) in bf16,
    random weights from a seed, on ZOO_CLIPS clips: the FUSED_MHA="auto"
    route (row 13 wherever nn.mha attends over >= 192 tokens) against "0"
    (the plain chain), ms a call and row 13's launches a call. Returns
    {name: launches a call}."""
    out = {}
    for i, name in enumerate(ZOO_TOWERS):
        spec = encoders.VISUAL.get(name) or encoders.ACOUSTIC[name]
        cfg = (tower_cfgs or {}).get(name) or spec.make_config()
        t0 = time.perf_counter()
        params = spec.init_params(torch.Generator(device="cuda").manual_seed(31 + i), cfg,
                                  torch.bfloat16)
        x = zoo_input(name, cfg, spec, raw)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        feats = {}
        for route in ("0", "auto"):
            with switched([(nn, "FUSED_MHA", route)]):
                fused_vit_attention.launches = 0
                feats[route] = spec.encode(params, cfg, x)
                torch.cuda.synchronize()
                launches = fused_vit_attention.launches
                if route == "auto":
                    ms = wall(lambda: spec.encode(params, cfg, x))
            if route == "0" and launches:
                raise AssertionError(f"zoo {name}: FUSED_MHA=0 launched row 13")
        got, want = feats["auto"].float(), feats["0"].float()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"zoo {name}: features {tuple(got.shape)} not finite")
        rel = float((got - want).norm() / want.norm())
        expected = zoo_launches(name, cfg)
        say("zoo", tower=name, input=list(x.shape), features=list(got.shape),
            fused_launches_a_call=launches, expected=expected, rel_err_vs_plain=f"{rel:.6g}",
            max_abs_diff=f"{float((got - want).abs().max()):.6g}",
            max_abs_plain=f"{float(want.abs().max()):.6g}", rel_tol=ZOO_REL_TOL,
            ms_a_call=f"{ms:.4f}", init_s=f"{init_s:.3f}",
            params_gib=f"{tree_gib(params):.3f}", card=repr(card))
        if launches != expected:
            raise AssertionError(f"zoo {name}: row 13 launched {launches} times, expected "
                                 f"{expected}")
        if rel > ZOO_REL_TOL:
            raise AssertionError(f"zoo {name}: the fused route is {rel:.4g} from the plain "
                                 f"chain, above {ZOO_REL_TOL}")
        out[name] = launches
        del params, x, feats, got, want
        torch.cuda.empty_cache()
    return out


def zoo_launches(name: str, cfg) -> int:
    """Row 13's launches in one call of the tower: one a layer where nn.mha
    attends over >= 192 tokens (DINOv2, SigLIP, ImageBind's trunk; data2vec
    only on clips longer than 2 s: 99 frames there), none where the tower
    has its own attention (EVA, WavLM)."""
    from affectgpt_tpu_torch.models import imagebind_audio, vit_variants, wav_encoders

    if isinstance(cfg, wav_encoders.Data2VecAudioConfig):
        n = hubert_frames(cfg.as_hubert(), RT_SAMPLES)
    elif isinstance(cfg, vit_variants.Dinov2Config):
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
    elif isinstance(cfg, vit_variants.SiglipConfig):
        n = (cfg.image_size // cfg.patch_size) ** 2
    elif isinstance(cfg, imagebind_audio.ImageBindAudioConfig):
        h, w = cfg.patch_grid
        n = h * w + 1
    else:
        return 0
    return cfg.num_layers if nn._fused_self_attn_ok(n, n, None) else 0


def metaspace_bpe(texts: list) -> tuple:
    """Merges learned from `texts` as sentencepiece's BPE sees them ("▁"
    before the text, spaces made "▁", words split before each "▁"), by
    learn_merges. Returns (the characters, the merges)."""
    import collections
    import re

    words = collections.Counter()
    for text in texts:
        for w in re.split("(?=▁)", "▁" + text.replace(" ", "▁")):
            if w:
                words[w] += 1
    return sorted({c for w in words for c in w}), learn_merges(words)


def write_llama2_tokenizer(root: str, chars: list, merges: list) -> int:
    """tokenizer.json of Llama-2's form (Prepend + Replace normalizer, no
    pre-tokenizer, BPE with byte_fallback and fuse_unk, the Replace /
    ByteFallback / Fuse / Strip decoder), Llama-2's vocabulary layout (the
    three specials, the 256 byte pieces, then the pieces), and
    tokenizer_config.json. Returns the vocabulary's size."""
    import os

    from affectgpt_tpu_torch import tokenization

    pieces = SP_SPECIALS + [f"<0x{b:02X}>" for b in range(256)] + chars \
        + [a + b for a, b in merges]
    vocab = {p: i for i, p in enumerate(dict.fromkeys(pieces))}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": t, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, t in enumerate(SP_SPECIALS)],
        "normalizer": tokenization._LLAMA_NORMALIZER, "pre_tokenizer": None,
        "post_processor": None, "decoder": tokenization._LLAMA_DECODER,
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
    }
    with open(os.path.join(root, "tokenizer.json"), "w", encoding="utf-8") as handle:
        json.dump(spec, handle, ensure_ascii=False)
    with open(os.path.join(root, "tokenizer_config.json"), "w") as handle:
        json.dump({"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
                   "clean_up_tokenization_spaces": False, "legacy": False,
                   "tokenizer_class": "LlamaTokenizer"}, handle)
    return len(vocab)


def pb_varint(value: int) -> bytes:
    value &= (1 << 64) - 1
    out = bytearray()
    while True:
        low, value = value & 0x7F, value >> 7
        out.append(low | (0x80 if value else 0))
        if not value:
            return bytes(out)


def pb_field(number: int, wire: int, payload: bytes) -> bytes:
    """One protobuf field: its key, then `payload` (a varint, four bytes, or
    a length-delimited body with its length)."""
    if wire == 2:
        payload = pb_varint(len(payload)) + payload
    return pb_varint(number << 3 | wire) + payload


def write_baichuan2_tokenizer(root: str, chars: list, merges: list) -> int:
    """tokenizer.model: a sentencepiece ModelProto of BPE type, as Baichuan2
    ships one (byte fallback, identity normalizer, no dummy prefix), in the
    protobuf wire format: the specials, the 256 byte pieces, the merged
    pieces scored by minus their merge rank, then the characters below
    them. Returns the number of pieces."""
    import os
    import struct

    merged = list(dict.fromkeys(a + b for a, b in merges))
    singles = [c for c in chars if c not in merged]
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)] \
        + [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)] \
        + [(p, -float(i), 1) for i, p in enumerate(merged)] \
        + [(c, -float(len(merged) + i), 1) for i, c in enumerate(singles)]
    body = b"".join(pb_field(1, 2, pb_field(1, 2, p.encode("utf-8"))
                             + pb_field(2, 5, struct.pack("<f", s)) + pb_field(3, 0, pb_varint(t)))
                    for p, s, t in pieces)
    trainer = b"".join(pb_field(f, 0, pb_varint(v))
                       for f, v in ((3, 2), (35, 1), (40, 0), (41, 1), (42, 2)))
    normalizer = pb_field(1, 2, b"identity") + pb_field(3, 0, pb_varint(0)) \
        + pb_field(4, 0, pb_varint(0))
    with open(os.path.join(root, "tokenizer.model"), "wb") as handle:
        handle.write(body + pb_field(2, 2, trainer) + pb_field(3, 2, normalizer))
    return len(pieces)


def family_kernels(card: str, cfg: qwen2.QwenConfig) -> dict:
    """Rows 1-4 and 15 against their plain versions at a Llama-2-style
    geometry (MHA, no qkv bias: zero biases), b = BATCH: decode_qkv and
    decode_mlp_bf16, decode_attention and decode_attn_o at T = MAX_LEN with
    ragged windows, prefill_attention over prompts of 545-564 tokens
    left-packed into 564; each with its device ms and bound. Returns
    {kernel: largest error}."""
    g = torch.Generator(device="cuda").manual_seed(29)
    b, h, inter, heads, kv, d = (BATCH, cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                                 cfg.num_kv_heads, cfg.head_dim)
    nq, nkv, groups = heads * d, kv * d, heads // kv

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(torch.bfloat16)

    errs = {}

    def held(name, got, want, calls, plain_calls, nbytes, flops, **shape):
        err, rel = compare(name, got, want, b)
        errs[name] = err
        cost = bound(nbytes, flops)
        say("zoo", kernel=name, geometry="llama2_mha", b=b, **shape, max_abs_err=f"{err:.6g}",
            max_rel_err=f"{rel:.6g}", rtol=RTOL, atol=ATOL, ms=f"{graph_ms(calls):.5f}",
            plain_ms=f"{graph_ms(plain_calls, reps=5):.5f}", bound_ms=f"{cost['bound_ms']:.5f}",
            bound_by=cost["bound_by"], card=repr(card))

    x, ln = rnd(b, h), rnd(h, scale=0.1, shift=1.0)
    pos = torch.randint(0, 4097, (b,), generator=g, device="cuda", dtype=torch.int32)
    zeros = [torch.zeros(n, dtype=torch.bfloat16, device="cuda") for n in (nq, nkv, nkv)]
    wq, wk, wv = rnd(h, nq, scale=0.02), rnd(h, nkv, scale=0.02), rnd(h, nkv, scale=0.02)
    qkv_kw = dict(ln_scale=ln, num_heads=heads, num_kv_heads=kv, head_dim=d,
                  theta=cfg.rope_theta, eps=cfg.rms_eps)
    qkv_args = (x, pos, wq, zeros[0], wk, zeros[1], wv, zeros[2])
    n_out = nq + 2 * nkv
    held("decode_qkv", decode_qkv(*qkv_args, **qkv_kw),
         decode_qkv_reference(*qkv_args, **qkv_kw), [lambda: decode_qkv(*qkv_args, **qkv_kw)] * 4,
         [lambda: decode_qkv_reference(*qkv_args, **qkv_kw)],
         2 * (h * n_out + n_out + h + b * h + b * n_out) + 4 * b, 2 * b * h * n_out,
         variant=json.dumps(decode_variant(b, cfg, "qkv")))
    wg, wu, wd = rnd(h, inter, scale=0.02), rnd(h, inter, scale=0.02), rnd(inter, h, scale=0.02)
    mlp_args = (x, ln, wg, wu, wd)
    held("decode_mlp_bf16", decode_mlp_bf16(*mlp_args, eps=cfg.rms_eps),
         decode_mlp_bf16_reference(*mlp_args, eps=cfg.rms_eps),
         [lambda: decode_mlp_bf16(*mlp_args, eps=cfg.rms_eps)] * 4,
         [lambda: decode_mlp_bf16_reference(*mlp_args, eps=cfg.rms_eps)],
         2 * (3 * h * inter + h + 2 * b * h), 6 * b * h * inter)
    del wg, wu, wd, mlp_args
    q, mask = rnd(b, kv, groups, d), decode_window_mask(g, b, MAX_LEN)
    k, v, wo = rnd(b, kv, MAX_LEN, d), rnd(b, kv, MAX_LEN, d), rnd(nq, h, scale=0.02)
    valid = int(mask.sum())
    held("decode_attention", decode_attention(q, k, v, mask),
         decode_attention_reference(q, k, v, mask), [lambda: decode_attention(q, k, v, mask)] * 4,
         [lambda: decode_attention_reference(q, k, v, mask)],
         2 * valid * kv * d * 2 + 4 * q.numel() + b * MAX_LEN, 4 * valid * kv * groups * d,
         T=MAX_LEN)
    held("decode_attn_o", decode_attn_o(x, q, k, v, mask, wo),
         decode_attn_o_reference(x, q, k, v, mask, wo),
         [lambda: decode_attn_o(x, q, k, v, mask, wo)] * 4,
         [lambda: decode_attn_o_reference(x, q, k, v, mask, wo)],
         2 * valid * kv * d * 2 + 2 * (q.numel() + nq * h + 2 * b * h) + b * MAX_LEN,
         4 * valid * kv * groups * d + 2 * b * nq * h, T=MAX_LEN)
    del q, k, v, wo
    t_len = 564
    lengths = torch.randint(545, t_len + 1, (b,), generator=g, device="cuda")
    seg = torch.arange(t_len, device="cuda")[None, :] >= (t_len - lengths)[:, None]
    q, k, v = rnd(b, t_len, heads, d), rnd(b, kv, t_len, d), rnd(b, kv, t_len, d)
    causal = torch.ones((t_len, t_len), dtype=torch.bool, device="cuda").tril()
    pairs = int((causal[None] & (seg[:, :, None] == seg[:, None, :])).sum())
    held("prefill_attention", prefill_attention(q, k, v, seg),
         prefill_attention_reference(q, k, v, seg), [lambda: prefill_attention(q, k, v, seg)] * 2,
         [lambda: prefill_attention_reference(q, k, v, seg)],
         2 * (q.numel() + k.numel() + v.numel() + b * t_len * nq) + b * t_len,
         4 * d * heads * pairs, t=t_len, lengths=f"{int(lengths.min())}-{int(lengths.max())}",
         variant=json.dumps(prefill_variant(b, t_len, heads, kv, d, seg.cpu())))
    del q, k, v
    torch.cuda.empty_cache()
    return errs


def family_run(card: str, llm: str, root: str, texts: list, raw: dict) -> dict:
    """One LLM family end to end: bootstrap.build_model (random weights at
    the family's 7B geometry and its two towers at registry geometry, LoRA
    merged), its tokenizer read by load_tokenizer from the directory the
    script wrote, then encode_media_features → greedy Chat.answer_batch on
    the 8 clips, 32 new tokens, every kernel count set to 0 just before and
    read just after. Gates: the launches (rows 1-2 layers x 32, row 13 as
    the towers' layers say, nothing else), features of the expected shapes
    and finite, 8 strings, and the tokenizer giving back each prompt's text
    (its patch tokens taken out). Returns the launches."""
    import re

    from affectgpt_tpu_torch import constants, paths
    from affectgpt_tpu_torch.tokenization import encode_batch, load_tokenizer

    vis, aud = FAMILIES[llm]
    node = {"llama_model": llm, "keep_full_llm": True, "visual_encoder": vis,
            "acoustic_encoder": aud,
            "preextracted_visual_dim": encoders.get_visual_encoder(vis).hidden_size,
            "preextracted_acoustic_dim": encoders.get_acoustic_encoder(aud).hidden_size}
    t0 = time.perf_counter()
    cfg, frozen, trainable, _ = bootstrap.build_model(node, with_encoders=True,
                                                      device="cuda", seed=3)
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    saved = paths.PATH_TO_LLM.get(llm)
    paths.PATH_TO_LLM[llm] = root
    try:
        tok = load_tokenizer(llm)
    finally:
        paths.PATH_TO_LLM[llm] = saved
    # text between added tokens takes a "▁" of its own in Llama-2's form (as
    # in HF's), so the round trip is held on the prompts without them
    plain = [re.sub("|".join(map(re.escape, constants.ALL_PATCH_TOKENS)), " ", t) for t in texts]
    for text in plain:
        if tok.decode(tok.encode(text)) != text:
            raise AssertionError(f"zoo {llm}: the tokenizer does not give back {text!r}")
    chat = Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN)
    prompts = [len(r) for r in encode_batch(tok, [text for text in texts[:BATCH]])[0]]
    media = {**raw, "audio": mel_clips(raw["audio"])} if aud == "IMAGEBIND" else raw
    _, vcfg, _, acfg = encoder_configs(cfg)
    n = NEW_TOKENS * cfg.llm.num_layers
    expected = {**dict.fromkeys(KERNELS, 0), "decode_qkv": n, "decode_mlp_bf16": n,
                "fused_vit_attention": 2 * zoo_launches(vis, vcfg) + zoo_launches(aud, acfg)}
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    t1 = time.perf_counter()
    feats = encode_media_features(frozen, cfg, media)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    texts_out = chat.answer_batch(MODE, SUBTITLES, QUESTION, feats, max_new_tokens=NEW_TOKENS,
                                  do_sample=False)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    dims = {"frame": cfg.visual_dim, "face": cfg.visual_dim, "audio": cfg.acoustic_dim}
    shapes = {m: list(f.shape) for m, f in feats.items()}
    say("zoo", llm=llm, towers=f"{vis}+{aud}", llm_layers=cfg.llm.num_layers,
        vocab=cfg.llm.vocab_size, tokenizer_vocab=tok.vocab_size,
        bos_eos_pad=[tok.bos_token_id, tok.eos_token_id, tok.pad_token_id],
        prompt_tokens=json.dumps(prompts), features=json.dumps(shapes),
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        build_s=f"{build_s:.3f}", encode_ms=f"{(t2 - t1) * 1e3:.3f}",
        answer_batch_ms=f"{(t3 - t2) * 1e3:.3f}", strings=len(texts_out),
        first=json.dumps(texts_out[0][:60]), card=repr(card))
    if launches != expected:
        raise AssertionError(f"zoo {llm}: kernel launches {launches} != {expected}")
    for m, d in dims.items():
        if shapes[m] != [BATCH, 8, d] or not bool(torch.isfinite(feats[m]).all()):
            raise AssertionError(f"zoo {llm}: {m} features {shapes[m]}, expected finite "
                                 f"[{BATCH}, 8, {d}]")
    if len(texts_out) != BATCH or not all(isinstance(t, str) for t in texts_out):
        raise AssertionError(f"zoo {llm}: expected {BATCH} strings, got {texts_out!r}")
    del chat, frozen, trainable, feats
    torch.cuda.empty_cache()
    return launches


def phase_zoo(card: str, tower_cfgs: Optional[dict] = None, llm_cfg=None) -> dict:
    """Phase 11: row 13 at the zoo's shapes (zoo_attention), each zoo tower's
    kernel route against its plain route (zoo_towers), rows 1-4 and 15 at
    Llama-2's MHA geometry (family_kernels), then the Llama2 and Baichuan2
    models end to end with their own tokenizers (family_run), one built and
    freed before the next. tower_cfgs and llm_cfg shrink the first parts
    for a rehearsal on the CPU. Returns {"attention": zoo_attention's
    records, "launches": row 13's launches of each tower call and family
    run, "max_abs_err": the largest error of rows 1-4 and 15}."""
    import os
    import shutil
    import tempfile

    from affectgpt_tpu_torch import prompts

    t0 = time.perf_counter()
    attention = zoo_attention(card)
    raw = realtime_media()
    launches = {f"tower:{k}": v for k, v in zoo_towers(card, raw, tower_cfgs).items()}
    errs = family_kernels(card, llm_cfg or qwen2.QwenConfig.llama2_7b())
    texts = [prompts.replace_token_for_multimodal(
        prompts.get_prompt_for_multimodal(MODE, sub, QUESTION), 8, 8, 1, 8)
        for sub in SUBTITLES]
    chars, merges = metaspace_bpe(load_texts() + texts)
    tmp = tempfile.mkdtemp(prefix="zoo_")
    try:
        for llm in FAMILIES:
            root = os.path.join(tmp, llm)
            os.makedirs(root)
            size = (write_llama2_tokenizer if llm == "Llama2" else write_baichuan2_tokenizer)(
                root, chars, merges)
            say("zoo", llm=llm, tokenizer=sorted(os.listdir(root)), pieces=size,
                merges=len(merges))
            family = family_run(card, llm, root, texts, raw)
            launches[f"family:{llm}"] = family["fused_vit_attention"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del raw
    torch.cuda.empty_cache()
    say("zoo", launches=json.dumps(launches), phase_seconds=f"{time.perf_counter() - t0:.3f}",
        card=repr(card))
    return {"attention": attention, "launches": launches, "max_abs_err": errs}


# ---------------------------------------------------------------------------
# Phase 12: the evaluation slice

EVAL_CLIPS = 16  # answers of the result-mer2023 root
EVAL_SMALL = 8  # clips of the OV-MERD+ and CMU-MOSI roots and of compare's reference
# the judge's max_new_tokens in phase 12: LLMJudge's default is 512, and random weights
# never emit eos, so every batch runs them all; the smoke runs half of them, which keeps
# every path and launch of the phase and leaves room in the time limit for phase 14
JUDGE_TOKENS = 128  # the judge's decode depth in phases 12 and 15 (its default: 512)
HARNESS_TOKENS = 32  # the OV-MER harness's greedy answers through Chat
AU_RECORDS = 16
AU_EPOCHS = 3
AU_LR = "5e-4"  # above the recipe's 1e-4, so six steps move the loss visibly
AU_BATCHES = (8, 4, 2)  # the recipe's 8 first, then smaller where it does not fit
UNIBENCH_CLIPS = 8
TRANSCODE_CLIPS = 8
TRANSCODE_FRAMES = 16
TRANSCODE_SHAPE = (360, 638)  # neither side a multiple of 16: the edge MCUs are padded
# the largest pixel error of a transcoded frame against its smooth source
# (tests/test_torch_ingest.py's JPEG_ATOL)
JPEG_ATOL = 24
MOSI_VALENCE = [1.4, -0.6, 2.2, -1.8, 0.4, -2.6, 0.8, -0.2]
EVAL_REASONS = [
    "The speaker smiles and sounds happy and excited about the news.",
    "Her voice trembles; she seems sad and a little worried.",
    "He raises his voice, clearly angry and frustrated with the answer.",
    "The character looks calm and relaxed, with a neutral tone.",
    "A sudden gasp: she is surprised, then cheerful.",
    "He sighs and looks disappointed, his shoulders dropping.",
    "She speaks nervously, anxious about what comes next.",
    "A warm laugh: the person is joyful and content.",
]


def smooth_frames(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """n RGB frames of smooth gradients and waves with mild noise, content a
    JPEG keeps within JPEG_ATOL (tests/test_torch_ingest.py's generator)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        chans = [128 + 80 * np.sin(xx / (9 + c) + i / 3) * np.cos(yy / (7 + c)) + 30 * c
                 for c in range(3)]
        out.append(np.clip(np.stack(chans, -1) + rng.randn(h, w, 3) * 3, 0, 255))
    return np.stack(out).astype(np.uint8)


def write_csv(path: str, header: list, rows) -> None:
    import csv

    with open(path, "w", newline="") as handle:
        csv.writer(handle).writerows([header] + [list(r) for r in rows])


def write_eval_trees(root: str) -> tuple:
    """The label trees the three scored datasets read, one of each scoring
    kind: MER2023 (EVAL_CLIPS clips, discrete labels), OV-MERD+ (EVAL_SMALL,
    open-vocabulary labels) and CMU-MOSI (EVAL_SMALL, valences), each with
    its subtitles. Returns (the `paths:` tables' entries, {dataset: its
    names})."""
    import os

    emos = ["happy", "sad", "angry", "neutral", "surprise", "sad", "worried", "happy"]
    names = {"MER2023": [f"m23_{i:03d}" for i in range(EVAL_CLIPS)],
             "OVMERDPlus": [f"ov_{i:03d}" for i in range(EVAL_SMALL)],
             "CMUMOSI": [f"mosi_{i:03d}" for i in range(EVAL_SMALL)]}
    section = {"DATA_DIR": {}, "PATH_TO_LABEL": {}, "PATH_TO_TRANSCRIPTIONS": {}}
    for ds, clips in names.items():
        d = os.path.join(root, ds.lower())
        os.makedirs(d)
        subs = [(n, SUBTITLES[i % len(SUBTITLES)]) for i, n in enumerate(clips)]
        if ds == "OVMERDPlus":
            label, subtitles = os.path.join(d, "ovlabel.csv"), os.path.join(d, "subtitle_eng.csv")
            write_csv(label, ["name", "openset"], zip(clips, OPENSETS))
            write_csv(subtitles, ["name", "sentence"], subs)
        else:
            label = os.path.join(d, "label-6way.npz" if ds == "MER2023" else "label.npz")
            corpus = ({n: {"emo": emos[i % len(emos)]} for i, n in enumerate(clips)}
                      if ds == "MER2023" else
                      {n: {"emo": 0, "val": v} for n, v in zip(clips, MOSI_VALENCE)})
            test_key = "test1_corpus" if ds == "MER2023" else "test_corpus"
            np.savez(label, train_corpus=np.array(corpus, dtype=object),
                     **{test_key: np.array(corpus, dtype=object)})
            subtitles = os.path.join(d, "transcription.csv")
            write_csv(subtitles, ["name", "english"], subs)
        section["DATA_DIR"][ds] = d
        section["PATH_TO_LABEL"][ds] = label
        section["PATH_TO_TRANSCRIPTIONS"][ds] = subtitles
    return section, names


def write_reasons(root: str, ds_key: str, names: list, offset: int = 0) -> str:
    """result-{ds_key}/0.npz of name2reason from EVAL_REASONS; returns its path."""
    import os

    os.makedirs(os.path.join(root, f"result-{ds_key}"), exist_ok=True)
    path = os.path.join(root, f"result-{ds_key}", "0.npz")
    np.savez_compressed(path, name2reason={
        n: EVAL_REASONS[(i + offset) % len(EVAL_REASONS)] for i, n in enumerate(names)})
    return path


def judge_recorder(record: list):
    """gen.generate wrapped to record each call's (rows, new tokens, device,
    seconds)."""
    def make(inner):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            record.append((args[3].shape[0], args[2].max_new_tokens, args[3].device.type,
                           time.perf_counter() - t0))
            return out
        return wrapped
    return make


def refuse(what: str):
    def make(inner):
        def wrapped(*args, **kwargs):
            raise AssertionError(f"eval: {what}")
        return wrapped
    return make


def judge_run(card: str, what: str, fn, layers: int, batches: list, tag: str = "eval") -> tuple:
    """fn() with the lexicon judge refused: its judge batches must be the
    port's generate calls of JUDGE_TOKENS steps on the card of `batches`
    rows, rows 1-2 launched layers x their steps and nothing else. Returns
    (fn's result, the launches)."""
    from affectgpt_tpu_torch.evaluation import judge

    record = []
    with patched(gen, "generate", judge_recorder(record)), \
            patched(judge.LexiconJudge, "reason_to_openset", refuse("the lexicon judge ran")), \
            patched(judge.LexiconJudge, "openset_to_sentiment", refuse("the lexicon judge ran")):
        t0 = time.perf_counter()
        out, launches = counted_call(fn)
        seconds = time.perf_counter() - t0
    steps = sum(tokens for _, tokens, _, _ in record)
    gen_s = sum(s for _, _, _, s in record)
    say(tag, run=what, judge_batches=json.dumps([b for b, _, _, _ in record]),
        decode_steps=steps, devices=sorted({d for _, _, d, _ in record}),
        judge_tokens_per_s=f"{sum(b * t for b, t, _, _ in record) / max(gen_s, 1e-9):.1f}",
        generate_s=f"{gen_s:.3f}", run_s=f"{seconds:.3f}",
        launches=json.dumps({k: v for k, v in launches.items() if v}), card=repr(card))
    if sorted(b for b, _, _, _ in record) != sorted(batches) or any(
            t != JUDGE_TOKENS or d != "cuda" for _, t, d, _ in record):
        raise AssertionError(f"eval {what}: judge batches {record}, want rows {batches} of "
                             f"{JUDGE_TOKENS} tokens on cuda")
    check_launches(f"eval {what}", launches, {"decode_qkv": layers * steps,
                                              "decode_mlp_bf16": layers * steps})
    return out, launches


def eval_caches(root: str) -> list:
    import glob
    import os

    return sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "*", "*-*.npz")))


def eval_harness(card: str, root: str) -> tuple:
    """Step 7, run first: its npz is the OV-MERD+ root that step 1 scores.
    The OV-MER zero-shot harness over OV-MERD+ with a model_fn over the
    port's Chat on the loaded 7B model (LoRA merged), text only, greedy,
    HARNESS_TOKENS tokens a clip: one string a clip, rows 1-2 launched
    layers x the decode steps. Returns (the LLM's layers, the launches)."""
    import os

    from affectgpt_tpu_torch.ovmer import zero_shot_harness

    cfg, frozen, trainable, tok = bootstrap.build_model(
        {"llama_model": "Qwen25", "keep_full_llm": True, "skip_encoders": True}, device="cuda")
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    chat = Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN)
    layers = cfg.llm.num_layers

    def model_fn(video, audio, subtitle, prompt):
        return chat.answer_batch("textonly", [subtitle], prompt, {},
                                 max_new_tokens=HARNESS_TOKENS, do_sample=False)[0]

    save = os.path.join(root, "result-ovmerdplus", "0.npz")
    t0 = time.perf_counter()
    answers, launches = counted_call(lambda: zero_shot_harness.run_zero_shot(
        "OVMERDPlus", model_fn, save))
    seconds = time.perf_counter() - t0
    del chat, frozen, trainable
    torch.cuda.empty_cache()
    with np.load(save, allow_pickle=True) as data:
        saved, keys = data["name2reason"].item(), sorted(data.files)
    say("eval", run="ov_harness", clips=len(answers), npz_keys=json.dumps(keys),
        sample=json.dumps(next(iter(answers.values()))[:60]), run_s=f"{seconds:.3f}",
        launches=json.dumps({k: v for k, v in launches.items() if v}), card=repr(card))
    check_strings("eval ov_harness", list(saved.values()), EVAL_SMALL)
    if saved != answers:
        raise AssertionError("eval ov_harness: the npz differs from the answers")
    steps = EVAL_SMALL * HARNESS_TOKENS
    check_launches("eval ov_harness", launches, {"decode_qkv": layers * steps,
                                                 "decode_mlp_bf16": layers * steps})
    return layers, launches


def eval_scores(card: str, root: str, layers: int) -> tuple:
    """Steps 1-2: `python -m affectgpt_tpu_torch.evaluation --input-dir
    root` with the LLM judge on the card (2 openset batches for MER2023, 1
    for OV-MERD+, openset and sentiment for CMU-MOSI), its caches written and
    its scores finite; then evaluation_scoreonly over the same root gives
    the same scores with no model built."""
    from affectgpt_tpu_torch import evaluation_scoreonly
    from affectgpt_tpu_torch.evaluation import __main__ as evaluation

    results, launches = judge_run(
        card, "evaluation", lambda: evaluation.main(["--input-dir", root, "--device", "cuda"]),
        layers, [8, 8, 8, 8, 8])
    torch.cuda.empty_cache()
    caches = eval_caches(root)
    want = ["result-cmumosi/0-openset-sentiment.npz", "result-cmumosi/0-openset.npz",
            "result-mer2023/0-openset.npz", "result-ovmerdplus/0-openset.npz"]
    with np.load(f"{root}/result-mer2023/0-openset.npz", allow_pickle=True) as data:
        sample = data["fileitems"].tolist()[0]
    say("eval", scores=json.dumps({k: [e, round(float(s), 6)] for k, (e, s) in results.items()}),
        caches=json.dumps(caches), openset_sample=json.dumps(str(sample)[:60]), card=repr(card))
    if sorted(results) != ["CMUMOSI", "MER2023", "OVMERDPlus"] or not all(
            np.isfinite(s) for _, s in results.values()) or caches != want:
        raise AssertionError(f"eval: scores {results}, caches {caches}")
    with patched(bootstrap, "build_model", refuse("score-only built a model")), \
            patched(evaluation, "build_model", refuse("score-only built a model")):
        cached, none = counted_call(lambda: evaluation_scoreonly.main(["--input-dir", root]))
    say("eval", run="score_only", scores=json.dumps(
        {k: [e, round(float(s), 6)] for k, (e, s) in cached.items()}), card=repr(card))
    if cached != results:
        raise AssertionError(f"eval score_only: {cached} != {results}")
    check_launches("eval score_only", none, {})
    return launches


def eval_compare(card: str, root: str, names: list, layers: int) -> dict:
    """Step 3: compare_outputs --ours (the MER2023 root's 16 answers)
    --reference (8 of its clips, 4 with the same text) with the LLM judge:
    8 common clips, two judge batches."""
    import os

    from affectgpt_tpu_torch import compare_outputs

    ref_root = os.path.join(os.path.dirname(root), "reference")
    ref = write_reasons(ref_root, "mer2023", names[:EVAL_SMALL])
    with np.load(ref, allow_pickle=True) as data:
        reasons = data["name2reason"].item()
    np.savez_compressed(ref, name2reason={n: r if i < 4 else r + " Maybe not."
                                          for i, (n, r) in enumerate(reasons.items())})
    report, launches = judge_run(card, "compare_outputs", lambda: compare_outputs.main(
        ["--ours", os.path.join(root, "result-mer2023", "0.npz"), "--reference", ref,
         "--device", "cuda"]), layers, [EVAL_SMALL, EVAL_SMALL])
    torch.cuda.empty_cache()
    say("eval", run="compare_outputs", common=report["common"], exact_text=report["exact_text"],
        label_sets_equal=report["label_sets_equal"],
        mean_jaccard=f"{report['mean_jaccard']:.4f}", card=repr(card))
    if (report["common"], report["exact_text"]) != (EVAL_SMALL, 4) \
            or not np.isfinite(report["mean_jaccard"]):
        raise AssertionError(f"eval compare_outputs: {report}")
    return launches


def write_mer_factory(root: str, seed: int = 17) -> None:
    """MER-Factory outputs of AU_RECORDS // 4 clips, four frames each: the
    17 AU intensities from a numpy seed, five of them in [0.6, 3) (above the
    0.5 threshold) and the rest below it, a summary a frame, and the emotion
    peak."""
    import os

    rng = np.random.RandomState(seed)
    aus = sorted(au_agent.AU_NAME_MAP)

    def intensities():
        values = rng.rand(len(aus)) * 0.5
        active = rng.choice(len(aus), 5, replace=False)
        values[active] = 0.6 + rng.rand(5) * 2.4
        return {f"{au}_r": round(float(v), 2) for au, v in zip(aus, values)}

    for c in range(AU_RECORDS // 4):
        name = f"au_{c:03d}"
        frames = [{"au_values": intensities(),
                   "summary_description": f"Frame {f}: {EVAL_REASONS[(c + f) % 8]}"}
                  for f in range(4)]
        data = {"au_info": {"frames": frames, "peak_frames": [
            {"peak_index": 2, "frames_before_peak": 2, "frames_after_peak": 1}]}}
        os.makedirs(os.path.join(root, name))
        with open(os.path.join(root, name, f"{name}_au_analysis.json"), "w") as handle:
            json.dump(data, handle)


def au_train(card: str, data: str, out: str, batch: int) -> dict:
    """train_au_agent on the 7B directory at r 64, --max-length 512, `batch`
    a step, timing each step (synchronized) and the peak memory."""
    from affectgpt_tpu_torch.au_agent_finetune import train_au_agent

    times = []

    def timed(inner):
        def make(*args, **kwargs):
            step = inner(*args, **kwargs)

            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = step(*a, **k)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                return result
            return run
        return make

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with patched(train_au_agent, "make_step", timed):
        result, launches = counted_call(lambda: train_au_agent.main([
            "--data", data, "--lora-r", "64", "--epochs", str(AU_EPOCHS), "--batch-size",
            str(batch), "--lr", AU_LR, "--max-length", "512", "--output-dir", out,
            "--device", "cuda"]))
    result.update(times=times, launches=launches,
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return result


def eval_au_agent(card: str, root: str) -> None:
    """Step 4, with step 6's verify_au_pipeline: prepare_au_instruction_dataset
    over AU_RECORDS synthetic OpenFace rows; train_au_agent on the 7B
    directory (r 64, alpha 128, dropout 0.05, max-length 512) at the largest
    of AU_BATCHES that fits, AU_EPOCHS epochs of the same records: finite
    losses, the last epoch's mean below the first's, no kernel launched, the
    last checkpoint reloading to the trained leaves."""
    import os

    from affectgpt_tpu_torch import verify_au_pipeline
    from affectgpt_tpu_torch.au_agent_finetune import prepare_au_instruction_dataset
    from affectgpt_tpu_torch.training import checkpoint

    mf = os.path.join(root, "mer_factory")
    write_mer_factory(mf)
    data = os.path.join(root, "au_sft.json")
    prepare_au_instruction_dataset.main(["--mer-factory-output", mf, "--save-path", data])
    with open(data) as handle:
        records = json.load(handle)
    report = verify_au_pipeline.main(["--mer-factory-output", mf])
    say("eval", run="au_data", records=len(records), verify=json.dumps(
        {k: report[k] for k in ("files", "ok", "bad")}), card=repr(card))
    if len(records) != AU_RECORDS or (report["ok"], report["bad"]) != (AU_RECORDS // 4, 0):
        raise AssertionError(f"eval au_data: {len(records)} records, verify {report}")
    result, refused = None, []
    for batch in AU_BATCHES:
        try:
            result = au_train(card, data, os.path.join(root, f"au_out_b{batch}"), batch)
            break
        except torch.cuda.OutOfMemoryError:
            refused.append(batch)
        torch.cuda.empty_cache()
    if result is None:
        raise AssertionError(f"eval au_agent: no batch of {AU_BATCHES} fits")
    losses, times = result["losses"], result["times"]
    per_epoch = len(losses) // AU_EPOCHS
    first, last = np.mean(losses[:per_epoch]), np.mean(losses[-per_epoch:])
    saved = checkpoint.load_checkpoint(result["checkpoints"][-1])["trainable"]["lora"]
    same = all(torch.equal(saved["layers"][i][k][ab], layer[k][ab].cpu())
               for i, layer in enumerate(result["lora"]["layers"]) for k in layer for ab in "ab")
    say("eval", run="au_agent", batch=batch, did_not_fit=json.dumps(refused), steps=len(losses),
        losses=json.dumps([round(v, 4) for v in losses]), first_epoch_mean=f"{first:.4f}",
        last_epoch_mean=f"{last:.4f}", step_ms=json.dumps([round(t * 1e3, 1) for t in times]),
        median_step_ms=f"{statistics.median(times) * 1e3:.1f}",
        peak_gib=f"{result['peak_gib']:.2f}", checkpoint_reloads=same, card=repr(card))
    launches = result["launches"]
    del result
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and min(losses) > 0 and last < first and same):
        raise AssertionError(f"eval au_agent: losses {losses}, reload {same}")
    check_launches("eval au_agent", launches, {})


def eval_unibench(card: str, root: str) -> dict:
    """Step 5: mer_unibench/extract_frame_emotion_peak_batch over a
    MER2023 tree of UNIBENCH_CLIPS raw clips (phase 10's write_raw_clips)
    with CLIP ViT-L/14 and HuBERT-large loaded from phase 10's directories:
    rows 11-12 launched the CLIP layers x 2 calls a clip, nothing else, and
    every cache equal to a direct FeatureExtractor run's."""
    import os

    from affectgpt_tpu_torch import extract_multimodal_features_precompute as pre
    from affectgpt_tpu_torch import paths
    from affectgpt_tpu_torch.data import media
    from affectgpt_tpu_torch.mer_unibench import extract_frame_emotion_peak_batch as unibench

    raw = os.path.join(root, "unibench")
    clips = sorted(write_raw_clips(raw, UNIBENCH_CLIPS))
    corpus = {n: {"emo": "happy"} for n in clips}
    label = os.path.join(raw, "label-6way.npz")
    np.savez(label, train_corpus=np.array(corpus, dtype=object),
             test1_corpus=np.array(corpus, dtype=object))
    subtitles = os.path.join(raw, "transcription.csv")
    write_csv(subtitles, ["name", "english"], [(n, "hello") for n in clips])
    paths.update_from_dict({
        "DATA_DIR": {"MER2023": raw}, "PATH_TO_LABEL": {"MER2023": label},
        "PATH_TO_TRANSCRIPTIONS": {"MER2023": subtitles},
        "PATH_TO_RAW_VIDEO": {"MER2023": os.path.join(raw, "video")},
        "PATH_TO_RAW_FACE": {"MER2023": os.path.join(raw, "openface_face")},
        "PATH_TO_RAW_AUDIO": {"MER2023": os.path.join(raw, "audio")}})
    save = os.path.join(root, "unibench_feats")
    t0 = time.perf_counter()
    _, launches = counted_call(lambda: unibench.main(
        ["--datasets", "mer2023", "--save_root", save, "--device", "cuda"]))
    seconds = time.perf_counter() - t0
    direct = os.path.join(root, "direct_feats")
    extractor = pre.FeatureExtractor("CLIP_VIT_LARGE", "HUBERT_LARGE", "uniform", 8, 8, direct,
                                     "MER2023", device="cuda")
    for name in clips:
        extractor.extract_frame(name, paths.PATH_TO_RAW_VIDEO["MER2023"])
        extractor.extract_face(name, paths.PATH_TO_RAW_FACE["MER2023"])
        extractor.extract_audio(name, paths.PATH_TO_RAW_AUDIO["MER2023"])
    del extractor
    torch.cuda.empty_cache()
    encoders_of = {"frame": "CLIP_VIT_LARGE", "face": "CLIP_VIT_LARGE", "audio": "HUBERT_LARGE"}
    err, equal = 0.0, 0
    for name in clips:
        for m, enc in encoders_of.items():
            got = np.load(media.feature_cache_path(save, "MER2023", m, enc, name))
            want = np.load(media.feature_cache_path(direct, "MER2023", m, enc, name))
            if got.shape != want.shape or not np.isfinite(got).all():
                raise AssertionError(f"eval unibench {name} {m}: {got.shape} vs {want.shape}")
            equal += int(np.array_equal(got, want))
            err = max(err, float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)))
    layers = encoders.get_visual_encoder("CLIP_VIT_LARGE").make_config().num_layers
    calls = 2 * UNIBENCH_CLIPS
    say("eval", run="mer_unibench", clips=UNIBENCH_CLIPS, clip_calls=calls,
        caches_equal_bits=f"{equal}/{3 * UNIBENCH_CLIPS}", rel_err_vs_direct=f"{err:.3g}",
        launches=json.dumps({k: v for k, v in launches.items() if v}), run_s=f"{seconds:.3f}",
        card=repr(card))
    check_launches("eval mer_unibench", launches, {"attn_sublayer": calls * layers,
                                                   "mlp_sublayer": calls * layers})
    if err > 1e-3:
        raise AssertionError(f"eval mer_unibench: caches off the direct run's by {err}")
    return launches


def eval_ingest(card: str, root: str) -> None:
    """Step 6: TRANSCODE_CLIPS clips of TRANSCODE_FRAMES smooth frames
    (`.frames.npy` sources: the card has neither cv2 nor decord) transcoded
    to MJPEG-AVI with the DCT on the card, read back by data/media.py (the
    native decoder, and its device decode) within JPEG_ATOL of the source;
    normalize_mer2023 over a raw tree, loaded by the dataset class."""
    import os

    from affectgpt_tpu_torch import paths, registry
    from affectgpt_tpu_torch.data import corpus_recipes, ingest, jpeg_encode, media
    from affectgpt_tpu_torch.data.base_dataset import DatasetConfig, ModelDataConfig
    from affectgpt_tpu_torch.ops import jpeg
    from affectgpt_tpu_torch.ops.sampling import uniform_indices
    from affectgpt_tpu_torch.tokenization import ByteTokenizer

    src_dir, dst_dir = os.path.join(root, "src"), os.path.join(root, "avi")
    os.makedirs(src_dir)
    sources = {}
    for c in range(TRANSCODE_CLIPS):
        sources[c] = smooth_frames(TRANSCODE_FRAMES, *TRANSCODE_SHAPE, seed=c)
        np.save(os.path.join(src_dir, f"clip_{c}.mp4.frames.npy"), sources[c])
    t0 = time.perf_counter()
    for c in sources:
        n = ingest.transcode_video(os.path.join(src_dir, f"clip_{c}.mp4"),
                                   os.path.join(dst_dir, f"clip_{c}.avi"), device="cuda")
        if n != TRANSCODE_FRAMES:
            raise AssertionError(f"eval ingest: clip {c} transcoded {n} frames")
    seconds = time.perf_counter() - t0
    batch = torch.as_tensor(sources[0], device="cuda")
    jpeg.encode_mjpeg_coefficients(batch, 90)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(5):
        jpeg.encode_mjpeg_coefficients(batch, 90)
    torch.cuda.synchronize()
    dct_ms = (time.perf_counter() - t1) / 5 * 1e3
    t1 = time.perf_counter()
    list(jpeg_encode.encode_frames(sources[0], 90, device="cuda"))
    clip_ms = (time.perf_counter() - t1) * 1e3
    err = {"native": 0, "device": 0}
    idx = uniform_indices(TRANSCODE_FRAMES, 8)
    for c, frames in sources.items():
        avi = os.path.join(dst_dir, f"clip_{c}.avi")
        native = media.read_video_frames(avi, 8)
        device = media.read_video_frames_device(avi, 8, device="cuda")
        if native.shape != (8, *TRANSCODE_SHAPE, 3) or device is None:
            raise AssertionError(f"eval ingest: clip {c} read back as {native.shape}, {device}")
        err["native"] = max(err["native"], int(np.abs(native.astype(int) - frames[idx]).max()))
        err["device"] = max(err["device"], int(np.abs(
            device.cpu().numpy().astype(int) - frames[idx]).max()))
    avi_mb = sum(os.path.getsize(os.path.join(dst_dir, f)) for f in os.listdir(dst_dir)) / 1e6
    say("eval", run="transcode", clips=TRANSCODE_CLIPS, frames=TRANSCODE_FRAMES,
        shape=list(TRANSCODE_SHAPE), quality=90, transcode_s=f"{seconds:.3f}",
        frames_per_s=f"{TRANSCODE_CLIPS * TRANSCODE_FRAMES / seconds:.1f}",
        dct_ms_a_clip=f"{dct_ms:.3f}", encode_ms_a_clip=f"{clip_ms:.1f}", avi_mb=f"{avi_mb:.3f}",
        max_abs_err=json.dumps(err), atol=JPEG_ATOL, card=repr(card))
    if max(err.values()) > JPEG_ATOL:
        raise AssertionError(f"eval ingest: read back {err} off the source")

    raw, out = os.path.join(root, "mer2023_raw"), os.path.join(root, "mer2023_norm")
    os.makedirs(raw)
    split_names = {}
    for split, n in (("train", 4), ("test1", 3), ("test2", 2), ("test3", 2)):
        names = [f"{split}_{i:05d}" for i in range(n)]
        split_names[split] = names
        rows = [[nm, ["happy", "sad", "angry", "worried"][i % 4]] + ([0.5 - i] if split != "test3"
                                                                       else [])
                for i, nm in enumerate(names)]
        write_csv(os.path.join(raw, f"{split}-label.csv"),
                  ["name", "discrete"] + (["valence"] if split != "test3" else []), rows)
        os.makedirs(os.path.join(raw, split))
        for nm in names:
            with open(os.path.join(raw, split, f"{nm}.mp4"), "wb") as handle:
                handle.write(b"\x00" * 16)
    counts = corpus_recipes.normalize_mer2023(raw, out)
    subtitles = os.path.join(out, "transcription.csv")
    write_csv(subtitles, ["name", "english"], [(n, "hi") for n in split_names["test1"]])
    paths.update_from_dict({"DATA_DIR": {"MER2023": out},
                            "PATH_TO_LABEL": {"MER2023": os.path.join(out, "label-6way.npz")},
                            "PATH_TO_TRANSCRIPTIONS": {"MER2023": subtitles}})
    dataset = registry.get("dataset", "MER2023")(
        ByteTokenizer(), DatasetConfig(face_or_frame="textonly"), ModelDataConfig(), device="cpu")
    gt = dataset.get_test_name2gt()
    copied = len(os.listdir(os.path.join(out, "video")))
    say("eval", run="normalize_mer2023", counts=json.dumps(counts), test1=json.dumps(gt),
        videos_copied=copied, card=repr(card))
    if counts != {"train": 4, "test1": 3, "test2": 2, "test3": 2} or copied != 11 or gt != {
            n: ["happy", "sad", "angry"][i] for i, n in enumerate(split_names["test1"])}:
        raise AssertionError(f"eval normalize_mer2023: {counts}, {gt}, {copied} videos")


def phase_eval(card: str, dirs: dict, tmp: str) -> dict:
    """Phase 12: the evaluation slice on phase 10's Qwen2.5-7B-shaped
    directory (and its CLIP and HuBERT), in `tmp`: the OV-MER harness over
    the port's Chat (step 7, whose npz step 1 scores), the evaluation entry
    with the LLM judge and score-only (steps 1-2), compare_outputs (3), the
    AU agent's data and LoRA training (4), the MER-UniBench precompute (5),
    the transcode and corpus recipes with the AU check (6). Returns {step:
    its launches}."""
    import os

    from affectgpt_tpu_torch import paths

    t0 = time.perf_counter()
    saved = {k: dict(v) for k, v in paths.TABLES.items()}
    root = os.path.join(tmp, "results")
    try:
        paths.PATH_TO_LLM["Qwen25"] = dirs["llm"]
        paths.PATH_TO_VISUAL["CLIP_VIT_LARGE"] = dirs["clip"]
        paths.PATH_TO_AUDIO["HUBERT_LARGE"] = dirs["hubert"]
        section, names = write_eval_trees(tmp)
        paths.update_from_dict(section)
        launches = {}
        layers, launches["ov_harness"] = eval_harness(card, root)
        write_reasons(root, "mer2023", names["MER2023"])
        write_reasons(root, "cmumosi", names["CMUMOSI"], offset=2)
        from affectgpt_tpu_torch.evaluation import judge

        defaults = judge.LLMJudge.__init__.__defaults__
        judge.LLMJudge.__init__.__defaults__ = (JUDGE_TOKENS, *defaults[1:])
        try:
            launches["evaluation"] = eval_scores(card, root, layers)
            launches["compare_outputs"] = eval_compare(card, root, names["MER2023"], layers)
        finally:
            judge.LLMJudge.__init__.__defaults__ = defaults
        eval_au_agent(card, tmp)
        launches["mer_unibench"] = eval_unibench(card, tmp)
        eval_ingest(card, tmp)
    finally:
        for k, v in saved.items():
            paths.TABLES[k].clear()
            paths.TABLES[k].update(v)
    say("eval", phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))
    return launches


# ---------------------------------------------------------------------------
# Phase 13: tensor-parallel serving

TP = 2  # the ranks of phase 13 (b)
# Qwen2.5-7B's shard a rank holds: tp -> (query heads, kv heads, columns of I)
TP_SHARDS = {2: (14, 2, 9472), 4: (7, 1, 4736)}
TP_FORCED_STEPS = 4  # teacher-forced decode steps after the prefill compared with tp = 1
# ||logits(tp = 2) - logits(tp = 1)|| / ||logits(tp = 1)|| over the prefill and the
# forced steps. In f32 (TP_F32_LAYERS layers of the 7B width, TF32 off, the plain
# chain: the decode kernels take bf16) the two differ by summation order alone. In
# bf16 each rank rounds its partial sums to bf16 before the all-reduce and the sum
# again before the residual add, over 28 layers of random weights: on an "NVIDIA H100
# 80GB HBM3, 700.00 W" this reads 0.044 at every step (argmax equal at 38 of 40 rows x
# steps), a rounding drift that does not grow with the steps; the bound catches a
# wrong head, shard or sum, which moves the logits by O(1): the negative control
# TP_WRONG (the all-reduce after o_proj skipped on both ranks, so each adds only
# its own heads' half of the attention output) must read above it
TP_REL_L2_F32 = 1e-4
TP_F32_LAYERS = 2
TP_REL_L2 = 0.1
TP_TIMEOUT = 900  # seconds the ranks of phase 13 (b) may take together
TP_CHAT = ("default", "a", "b", "q4", "q4_b16")  # phase 4's configurations run on each rank
# phase 5's configurations and the first requests of its 48 each serves (the same
# engines and kernels at fewer requests, to keep the phase near 2 min)
TP_SERVE = {"paged_bf16": 24, "paged_w8": 16}
TP_FORCED = ("default", "a")  # the configurations whose logits are compared with tp = 1
TP_WRONG = "default"  # the configuration of the negative control (o_proj's sum skipped)


def skip_o_proj_sums(tp_sum):
    """A wrapper of qwen2._tp_sum that returns each layer's first partial
    sum (o_proj's; the MLP's down_proj sum comes second) unreduced."""
    calls = [0]

    def wrapped(y, cfg):
        calls[0] += 1
        return y if calls[0] % 2 else tp_sum(y, cfg)
    return wrapped


def tp_layer(g: torch.Generator, b: int, tp: int, h: int = 3584, d: int = 128) -> dict:
    """Random bf16 operands of one Qwen2.5-7B layer's shard at tp ranks."""
    heads, kv, inter = TP_SHARDS[tp]

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(torch.bfloat16)

    return {"x": rnd(b, h), "ln": rnd(h, scale=0.1, shift=1.0),
            "pos": torch.randint(0, 4096, (b,), generator=g, device="cuda", dtype=torch.int32),
            "wq": rnd(h, heads * d, scale=0.02), "bq": rnd(heads * d, scale=0.1),
            "wk": rnd(h, kv * d, scale=0.02), "bk": rnd(kv * d, scale=0.1),
            "wv": rnd(h, kv * d, scale=0.02), "bv": rnd(kv * d, scale=0.1),
            "wg": rnd(h, inter, scale=0.02), "wu": rnd(h, inter, scale=0.02),
            "wd": rnd(inter, h, scale=0.02), "wo": rnd(heads * d, h, scale=0.02),
            "q": rnd(b, kv, heads // kv, d), "k": rnd(b, kv, MAX_LEN, d),
            "v": rnd(b, kv, MAX_LEN, d), "mask": decode_window_mask(g, b, MAX_LEN)}


def tp_row_calls(s: dict, tp: int, residual: bool) -> dict:
    """name -> (kernel call, plain call, bytes, operations) of rows 1, 2, 4
    and 10 on a shard's operands (rows 2, 4, 10 with or without the
    residual add; row 1 has none)."""
    heads, kv, inter = TP_SHARDS[tp]
    b, h = s["x"].shape
    d = s["q"].shape[-1]
    qkv = (s["x"], s["pos"], s["wq"], s["bq"], s["wk"], s["bk"], s["wv"], s["bv"])
    qkv_kw = dict(num_heads=heads, num_kv_heads=kv, head_dim=d, theta=1e6, ln_scale=s["ln"],
                  eps=1e-6)
    mlp = (s["x"], s["ln"], s["wg"], s["wu"], s["wd"])
    attn = (s["x"], s["q"], s["k"], s["v"], s["mask"], s["wo"])
    int8 = (s["x"], s["ln"], *s["int8"])
    valid = int(s["mask"].sum())
    calls = {
        "decode_mlp_bf16": (lambda: decode_mlp_bf16(*mlp, residual=residual),
                            lambda: decode_mlp_bf16_reference(*mlp, residual=residual),
                            2 * 3 * h * inter + 2 * 2 * b * h, 6 * b * h * inter),
        "decode_attn_o": (lambda: decode_attn_o(*attn, residual=residual),
                          lambda: decode_attn_o_reference(*attn, residual=residual),
                          2 * (2 * valid * kv * d + heads * d * h + 2 * b * h + b * heads * d)
                          + b * MAX_LEN, 4 * valid * heads * d + 2 * b * heads * d * h),
        "decode_mlp": (lambda: decode_mlp(*int8, eps=1e-6, residual=residual),
                       lambda: decode_mlp_reference(*int8, eps=1e-6, residual=residual),
                       3 * h * inter + 4 * (2 * inter + h) + 2 * 2 * b * h, 6 * b * h * inter),
    }
    if residual:
        calls["decode_qkv"] = (lambda: decode_qkv(*qkv, **qkv_kw),
                               lambda: decode_qkv_reference(*qkv, **qkv_kw),
                               2 * h * (heads + 2 * kv) * d + 2 * b * (h + (heads + 2 * kv) * d),
                               2 * b * h * (heads + 2 * kv) * d)
    return calls


def tp_quant_calls(g: torch.Generator, tp: int) -> dict:
    """name -> [(kernel call, plain call, bytes, operations)] over one layer's
    seven products on a tp rank's shard (the rows of o and down, the columns
    of the others), at each kernel's main-path M (QUANT_PHASE)."""
    heads, kv, inter = TP_SHARDS[tp]
    h, d = 3584, 128
    shapes = [(h, heads * d), (h, kv * d), (h, kv * d), (heads * d, h), (h, inter), (h, inter),
              (inter, h)]
    out = {}
    for name in ("int8_matmul", "int4_matmul", "int4_matmul_smallm"):
        bits, plain, _, m, _, _ = QUANT_PHASE[name]
        kernel = getattr(quant, name)
        calls = []
        for k, n in shapes:
            sigma = k ** -0.5
            if bits == 4:
                w = torch.randint(-128, 128, (k // 2, n), generator=g, device="cuda",
                                  dtype=torch.int8)
                s = (torch.rand((k // quant.INT4_GROUP, n), generator=g, device="cuda") + 0.5) \
                    * (3 * sigma / 7)
                nbytes = k * n // 2 + 4 * s.numel()
            else:
                w = torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                                  dtype=torch.int8)
                s = (torch.rand((1, n), generator=g, device="cuda") + 0.5) * (3 * sigma / 127)
                nbytes = k * n + 4 * n
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            calls.append((lambda x=x, w=w, s=s, f=kernel: f(x, w, s),
                          lambda x=x, w=w, s=s, f=plain: f(x, w, s),
                          nbytes + 2 * m * (k + n), 2 * m * k * n))
        out[name] = (m, calls)
    return out


def phase_tp_kernels(card: str) -> dict:
    """Phase 13 (a): rows 1, 2, 4 and 10 at Qwen2.5-7B's tp = 2 and tp = 4
    shard shapes (rows 2, 4, 10 with and without their residual add: a
    rank's partial sum), b = 8 and 16, and rows 6, 8 and 9 over one layer's
    tp = 2 shard at their main-path M, each against its plain version at the
    smoke's tolerance, with ms, plain_ms and bound_ms. Returns {kernel:
    {shape key: {...}}} and the largest error of each kernel."""
    g = torch.Generator(device="cuda").manual_seed(31)
    shapes, errs = {}, {}
    for tp in TP_SHARDS:
        for b in (8, SERVE_SLOTS):
            s = tp_layer(g, b, tp)
            h, inter = 3584, TP_SHARDS[tp][2]
            s["int8"] = []
            for k, n in ((h, inter), (h, inter), (inter, h)):
                s["int8"] += quant.quantize_per_channel(
                    torch.randn(k, n, generator=g, device="cuda") * k ** -0.5)
            for residual in (True, False):
                for name, (kernel, plain, nbytes, flops) in tp_row_calls(s, tp, residual).items():
                    got = kernel()
                    err, rel = compare(f"{name} tp={tp} residual={residual}", got, plain(), b)
                    errs[name] = max(errs.get(name, 0.0), err)
                    cost = bound(nbytes, flops)
                    row = {"max_abs_err": err, "ms": graph_ms([kernel] * 6),
                           "plain_ms": graph_ms([plain] * 2, reps=5), **cost}
                    key = f"tp{tp}_b{b}" + ("" if residual or name == "decode_qkv"
                                            else "_partial")
                    shapes.setdefault(name, {})[key] = {k: (round(v, 6) if isinstance(v, float)
                                                            else v) for k, v in row.items()}
                    say("tp", part="a", kernel=name, tp=tp, b=b, heads=TP_SHARDS[tp][0],
                        kv_heads=TP_SHARDS[tp][1], intermediate=inter, residual=residual,
                        max_abs_err=f"{err:.6g}", max_rel_err=f"{rel:.6g}", rtol=RTOL,
                        atol=ATOL, ms=f"{row['ms']:.5f}", plain_ms=f"{row['plain_ms']:.5f}",
                        bound_ms=f"{cost['bound_ms']:.5f}", bound_by=cost["bound_by"],
                        card=repr(card))
            del s
            torch.cuda.empty_cache()
    for name, (m, calls) in tp_quant_calls(g, 2).items():
        err = 0.0
        for kernel, plain, _, _ in calls:
            e, _ = compare(f"{name} tp=2", kernel(), plain(), m)
            err = max(err, e)
        errs[name] = max(errs.get(name, 0.0), err)
        ms = sum(graph_ms([kernel] * 8) for kernel, _, _, _ in calls)
        plain_ms = sum(graph_ms([plain] * 2, reps=5) for _, plain, _, _ in calls)
        cost = bound(sum(c[2] for c in calls), sum(c[3] for c in calls))
        shapes.setdefault(name, {})[f"tp2_layer_m{m}"] = {
            "max_abs_err": round(err, 6), "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(cost["bound_ms"], 6), "bound_by": cost["bound_by"]}
        say("tp", part="a", kernel=name, tp=2, M=m, products="one layer's 7 on the shard",
            max_abs_err=f"{err:.6g}", rtol=RTOL, atol=ATOL, ms_per_layer=f"{ms:.5f}",
            plain_ms_per_layer=f"{plain_ms:.5f}", bound_ms=f"{cost['bound_ms']:.5f}",
            bound_by=cost["bound_by"], card=repr(card))
        del calls
        torch.cuda.empty_cache()
    return {"shapes": shapes, "max_abs_err": errs}


def tp_features(cfg) -> dict:
    """The 8 clips' preextracted features of phase 4 (the same seed), bf16."""
    rng = np.random.RandomState(0)
    return {m: torch.as_tensor(rng.randn(BATCH, 8, d).astype(np.float32), device="cuda")
            .to(torch.bfloat16)
            for m, d in (("frame", cfg.visual_dim), ("face", cfg.visual_dim),
                         ("audio", cfg.acoustic_dim))}


def forced_logits(chat: Chat, feats: dict, tokens: torch.Tensor, steps: int) -> torch.Tensor:
    """The f32 logits [b, 1 + steps, vocab] of the 8 clips' prompts: the
    prefill's last position, then `steps` decode steps fed tokens[:, s]
    (teacher forcing: the same inputs whatever a rank would have sampled),
    on generate's own prefill and cache columns."""
    served = Served(chat, feats, SUBTITLES)
    llm, cfg = chat.frozen["llm"], chat.cfg.llm
    embeds, lengths = served.embeds, served.lengths.long()
    t_pad = embeds.shape[1]
    key_valid, cache, logits = gen._prefill(llm, cfg, embeds, lengths, chat.max_len, None, None)
    out = [logits.float()]
    slots = torch.arange(chat.max_len, device=embeds.device)
    pos = lengths.to(torch.int32)
    for step in range(steps):
        tok = qwen2.embed_tokens(llm, tokens[:, step])[:, None, :].to(embeds.dtype)
        key_mask = (slots[None, None, :] <= t_pad + step) & key_valid[:, None, :]
        step_logits, cache = qwen2.forward(llm, cfg, tok, key_mask, positions=pos[:, None],
                                           cache=cache, cache_index=t_pad + step)
        out.append(step_logits[:, 0].float())
        pos = pos + 1
    return torch.stack(out, dim=1)


def f32_forced(model: tuple, tokens: torch.Tensor) -> torch.Tensor:
    """forced_logits of the first TP_F32_LAYERS layers of `model`'s LLM (a
    rank's shard or the whole) in f32, on the plain chain (DECODE_QKV and
    DECODE_MLP "xla": the decode kernels take bf16)."""
    cfg, frozen, trainable, tok, feats, _ = model
    llm = tree_to({**frozen["llm"], "layers": frozen["llm"]["layers"][:TP_F32_LAYERS]},
                  torch.float32)
    small = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, num_layers=TP_F32_LAYERS))
    chat = Chat({**frozen, "llm": llm}, trainable, small, tok, max_len=MAX_LEN)
    with switched([(qwen2, "DECODE_QKV", "xla"), (qwen2, "DECODE_MLP", "xla")]):
        return forced_logits(chat, tree_to(feats, torch.float32), tokens, TP_FORCED_STEPS).cpu()


def tp_model(layout=None, quantized: bool = True) -> tuple:
    """Phase 10's Qwen2.5-7B-shaped directory (PATH_TO_LLM) loaded whole or,
    under a layout, as the rank's shard, LoRA merged; the serving trees of
    TP_CHAT and TP_SERVE (bf16, and with `quantized` int4 and int8 split,
    each quantized on the shard); the load's seconds."""
    t0 = time.perf_counter()
    cfg, frozen, trainable, tok = bootstrap.build_model(
        {"llama_model": "Qwen25", "keep_full_llm": True},
        device="cuda" if layout is None else layout.device, layout=layout)
    frozen, trainable = bootstrap.serving_llm(frozen, trainable, cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    trees = {"bf16": frozen["llm"]}
    for bits, name in ((4, "int4"), (8, "int8")) if quantized else ():
        trees[name] = qwen2.quantize_params(frozen["llm"], bits=bits, cfg=cfg.llm)
    return (cfg, frozen, trainable, tok, tp_features(cfg), trees), load_s


def tp_runs(model: tuple, chats=TP_CHAT, serves=TP_SERVE) -> dict:
    """Phase 4's counted runs of `chats` (exact launch counts, one string a
    clip) and phase 5's of `serves` (exact launch counts, a result a
    request, over TP_SERVE's first requests) on `model`; each run's
    launches and host seconds, the default configuration's strings, the
    engines' results."""
    cfg, frozen, trainable, tok, feats, trees = model
    out = {"launches": {}, "seconds": {}, "texts": {}, "results": {}}
    baseline = {}
    for config in chats:
        c = CONFIGS[config]
        chat = Chat({**frozen, "llm": trees[c.tree]}, trainable, cfg, tok, max_len=MAX_LEN)
        reps = c.batch // BATCH
        served = Served(chat, {m: v.repeat(reps, 1, 1) for m, v in feats.items()},
                        SUBTITLES * reps)
        t0 = time.perf_counter()
        out["launches"][config] = counted_run(config, served, baseline)
        out["seconds"][config] = time.perf_counter() - t0
    out["texts"]["default"] = baseline["texts"]
    chat = Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN)
    requests = serve_requests(chat, feats)
    for config in serves:
        t0 = time.perf_counter()
        out["launches"][config], out["results"][config] = serve_counted(
            config, model, requests[:TP_SERVE[config]])
        out["seconds"][config] = time.perf_counter() - t0
    return out


def tp_rank_main(rank: int, world: int, address: str, root: str, llm_dir: str) -> None:
    """One rank of phase 13 (b), a spawned process: gloo over the one card
    (NCCL refuses two ranks on a device), its shard of phase 10's directory,
    the forced logits and the counted runs, saved for the parent; rank 1's
    lines go to its log."""
    import torch.distributed as dist

    from affectgpt_tpu_torch import paths
    from affectgpt_tpu_torch.parallel import mesh

    if rank:
        log = open(os.path.join(root, f"rank{rank}.log"), "w")
        os.dup2(log.fileno(), 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=address, world_size=world, rank=rank)
    try:
        layout = mesh.create_layout("cuda", tp=world)
        paths.PATH_TO_LLM["Qwen25"] = llm_dir
        ref = torch.load(os.path.join(root, "tp1.pt"), weights_only=False)
        torch.cuda.reset_peak_memory_stats()
        model, load_s = tp_model(layout)
        cfg, frozen, trainable, tok, feats, trees = model
        tokens = ref["tokens"].to(layout.device)
        forced = {"f32": f32_forced(model, tokens)}
        for config in TP_FORCED:
            with config_switches(config):
                forced[config] = forced_logits(Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN),
                                               feats, tokens, TP_FORCED_STEPS).cpu()
        with config_switches(TP_WRONG), patched(qwen2, "_tp_sum", skip_o_proj_sums):
            forced["wrong"] = forced_logits(Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN),
                                            feats, tokens, TP_FORCED_STEPS).cpu()
        runs = tp_runs(model)
        torch.save({"rank": rank, "backend": dist.get_backend(), "load_s": load_s,
                    "weight_gib": {k: tree_gib(v) for k, v in trees.items()},
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "forced": forced if rank == 0 else None, **runs},
                   os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_spawn(root: str, llm_dir: str) -> float:
    """Run TP ranks of tp_rank_main and wait for them within TP_TIMEOUT: a
    rank that raises, dies or outlives the limit fails the phase (the
    others are stopped). Returns the seconds taken."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    t0 = time.perf_counter()
    ctx = mp.start_processes(tp_rank_main, args=(TP, address, root, llm_dir), nprocs=TP,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > TP_TIMEOUT:
                raise AssertionError(f"tp: the ranks did not finish within {TP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return time.perf_counter() - t0


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).norm() / want.norm())


def tp_hybird_nccl(card: str, tmp: str, llm_dir: str) -> None:
    """Where the machine has two cards or more: `python -m affectgpt_tpu_torch.
    inference_hybird --tp 2` (NCCL, one rank a card, the ranks spawned by
    the entry point) over a MER2023-style corpus of HYBIRD_CLIPS
    preextracted clips on phase 10's directory: one .npz of HYBIRD_CLIPS
    answers, written by rank 0."""
    root = os.path.join(tmp, "tp_hybird")
    os.makedirs(root)
    section, feat_root = write_mer2023_corpus(root, HYBIRD_CLIPS)
    raw = {"model": {"llama_model": "Qwen25", "keep_full_llm": True, "skip_encoders": True},
           "datasets": {"mer2023": {"face_or_frame": MODE, "use_preextracted_frame": True,
                                    "use_preextracted_face": True,
                                    "use_preextracted_audio": True,
                                    "preextracted_root": feat_root}},
           "run": {"output_dir": os.path.join(root, "out")},
           "inference": {"face_or_frame": MODE},
           "paths": {**section, "PATH_TO_LLM": {"Qwen25": llm_dir}}}
    cfg_path = os.path.join(root, "exp_tp.json")
    with open(cfg_path, "w") as handle:
        json.dump(raw, handle)
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    proc = subprocess.run([sys.executable, "-m", "affectgpt_tpu_torch.inference_hybird",
                           "--cfg-path", cfg_path, "--dataset", "MER2023", "--batch_size",
                           str(HYBIRD_CLIPS), "--max_new_tokens", str(NEW_TOKENS), "--greedy",
                           "--tp", str(TP)], cwd=root, env=env, capture_output=True, text=True,
                          timeout=TP_TIMEOUT)
    if proc.returncode:
        raise AssertionError(f"tp: inference_hybird --tp {TP} failed:\n{proc.stderr[-4000:]}")
    out = os.path.join(root, "output", "results", "exp_tp", "result-mer2023", "0.npz")
    with np.load(out, allow_pickle=True) as npz:
        answers = npz["name2reason"].tolist()
    if len(answers) != HYBIRD_CLIPS or not all(isinstance(a, str) for a in answers.values()):
        raise AssertionError(f"tp: inference_hybird --tp {TP} wrote {len(answers)} answers")
    say("tp", part="b_nccl", command=f"inference_hybird --tp {TP}", backend="nccl",
        cards=torch.cuda.device_count(), answers=len(answers),
        seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))


def phase_tp(card: str, dirs: dict, tmp: str) -> dict:
    """Phase 13 (b): tensor-parallel serving of phase 10's directory at
    tp = 2 on the card. The parent loads it whole (tp = 1) and records the
    prefill and teacher-forced logits (TP_FORCED), the greedy tokens and
    TP_CHAT's / TP_SERVE's counted runs; then TP ranks, spawned processes,
    each load their shard (a slice at a time from the directory) and run
    the same. On one card the ranks share it over gloo (CUDA tensors). The
    ranks' logits must be within TP_REL_L2 of tp = 1's; every run's launches
    must be exact on every rank (phase 4's and 5's counts, as at tp = 1) and
    the ranks' outputs the same; the match share with tp = 1 of the greedy
    strings and of the paged engine's tokens is printed, not gated (bf16 on
    random weights). Returns rank 0's launches of each kernel over its
    runs."""
    from affectgpt_tpu_torch import paths

    t0 = time.perf_counter()
    root = os.path.join(tmp, "tp")
    os.makedirs(root)
    saved = dict(paths.PATH_TO_LLM)
    paths.PATH_TO_LLM["Qwen25"] = dirs["llm"]
    try:
        torch.cuda.reset_peak_memory_stats()
        model, load_s = tp_model(quantized=False)
        cfg, frozen, trainable, tok, feats, trees = model
        chat = Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN)
        record = []
        with patched(gen, "generate", recording_generate(record)):
            chat.answer_batch(MODE, SUBTITLES, QUESTION, feats, max_new_tokens=NEW_TOKENS,
                              do_sample=False)
        tokens = record[0]
        forced = {"f32": f32_forced(model, tokens)}
        for config in TP_FORCED:
            with config_switches(config):
                forced[config] = forced_logits(Chat(frozen, trainable, cfg, tok, max_len=MAX_LEN),
                                               feats, tokens, TP_FORCED_STEPS).cpu()
        torch.save({"tokens": tokens.cpu()}, os.path.join(root, "tp1.pt"))
        one = tp_runs(model, chats=("default",), serves=("paged_bf16",))
        one.update(weight_gib={k: tree_gib(v) for k, v in trees.items()}, load_s=load_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del model, cfg, frozen, trainable, trees, chat
        torch.cuda.empty_cache()
        spawn_s = tp_spawn(root, dirs["llm"])
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP)]
        if torch.cuda.device_count() >= TP:
            tp_hybird_nccl(card, tmp, dirs["llm"])
        else:
            say("tp", part="b_nccl", skipped=f"{torch.cuda.device_count()} card: NCCL takes "
                f"one rank a card, so inference_hybird --tp {TP} needs {TP}", card=repr(card))
    finally:
        paths.PATH_TO_LLM.clear()
        paths.PATH_TO_LLM.update(saved)
    for config in ("f32",) + TP_FORCED:
        got, want = ranks[0]["forced"][config], forced[config]
        err = rel_l2(got, want)
        limit = TP_REL_L2_F32 if config == "f32" else TP_REL_L2
        per_step = [round(rel_l2(got[:, s], want[:, s]), 6) for s in range(got.shape[1])]
        agree = int((got.argmax(-1) == want.argmax(-1)).sum())
        say("tp", part="b", config=config, logits="prefill + forced steps",
            layers=TP_F32_LAYERS if config == "f32" else "all", steps=TP_FORCED_STEPS,
            rel_l2=f"{err:.6g}", limit=limit, rel_l2_by_step=json.dumps(per_step),
            max_abs=f"{float((got - want).abs().max()):.6g}",
            argmax_agree=f"{agree}/{got.shape[0] * got.shape[1]}", card=repr(card))
        if not err <= limit:
            raise AssertionError(f"tp: {config} logits at tp={TP} are {err:.4g} (relative L2) "
                                 f"from tp=1's, above {limit}")
    wrong = rel_l2(ranks[0]["forced"]["wrong"], forced[TP_WRONG])
    say("tp", part="b", negative_control="o_proj's all-reduce skipped", config=TP_WRONG,
        rel_l2=f"{wrong:.6g}", must_exceed=TP_REL_L2, card=repr(card))
    if not wrong > TP_REL_L2:
        raise AssertionError(f"tp: the negative control reads {wrong:.4g}, not above the bf16 "
                             f"bound {TP_REL_L2}: the bound does not tell a wrong sum")
    for r in ranks:
        if r["launches"] != ranks[0]["launches"]:
            raise AssertionError(f"tp: rank {r['rank']}'s launches differ from rank 0's")
        if r["results"] != ranks[0]["results"] or r["texts"] != ranks[0]["texts"]:
            raise AssertionError(f"tp: rank {r['rank']}'s outputs differ from rank 0's")
    same_texts = sum(a == b for a, b in zip(ranks[0]["texts"]["default"], one["texts"]["default"]))
    same_paged = {c: sum(one["results"][c][k] == v for k, v in ranks[0]["results"][c].items())
                  for c in one["results"]}
    say("tp", part="b", backend=ranks[0]["backend"], ranks=TP, cards=torch.cuda.device_count(),
        shared_card=torch.cuda.device_count() < TP,
        note="two ranks on one card over gloo: a time here is no tensor-parallel speedup",
        weight_gib_tp1=json.dumps({k: round(v, 3) for k, v in one["weight_gib"].items()}),
        weight_gib_per_rank=json.dumps([{k: round(v, 3) for k, v in r["weight_gib"].items()}
                                        for r in ranks]),
        peak_gib_per_rank=json.dumps([round(r["peak_gib"], 3) for r in ranks]),
        peak_gib_tp1=f"{one['peak_gib']:.3f}",
        load_s_tp1=f"{one['load_s']:.3f}",
        load_s_per_rank=json.dumps([round(r["load_s"], 3) for r in ranks]),
        spawn_to_end_s=f"{spawn_s:.3f}", card=repr(card))
    for config in TP_CHAT + tuple(TP_SERVE):
        say("tp", part="b", config=config,
            launches_per_rank=json.dumps([{k: v for k, v in r["launches"][config].items() if v}
                                          for r in ranks]),
            seconds_tp1=f"{one['seconds'][config]:.3f}" if config in one["seconds"] else "-",
            seconds_per_rank=json.dumps([round(r["seconds"][config], 3) for r in ranks]),
            card=repr(card))
    say("tp", part="b", greedy_strings_equal_to_tp1=f"{same_texts}/{BATCH}",
        paged_requests_with_tp1_tokens=json.dumps(
            {c: f"{n}/{len(one['results'][c])}" for c, n in same_paged.items()}),
        gated="no: bf16 greedy tokens on random weights part at near ties",
        phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))
    launches = dict.fromkeys(KERNELS, 0)
    for counts in ranks[0]["launches"].values():
        for name, n in counts.items():
            launches[name] += n
    return launches


# ---------------------------------------------------------------------------
# Phase 14: tensor-parallel training

TP_TRAIN_B = 4  # the step's batch, at phase 8's geometry (TRAIN_T, TRAIN_LABELS labelled)
TP_TRAIN_STEPS = 6  # gate 1: steps on one fixed batch
TP_TRAIN_TP1_STEPS = 3  # tp = 1's steps in the parent, the last two timed
TP_TRAIN_F32_LAYERS = 2  # gates 2 and 4: the first layers of the LLM, in f32
# gate 2: tp = 2 against tp = 1 in f32 on the plain chain (TF32 off): the two differ
# by summation order alone. Gate 4's negative controls (the LoRA gradients not
# summed over tp; f's backward all-reduce skipped) must read above it.
TP_TRAIN_REL_L2_F32 = 1e-4
# gate 3, bf16 over every layer: phase 8 holds one bf16 run within BF16_* of f32
# (at 2 layers); tp = 2 and tp = 1 are two bf16 runs, which may part by the sum of
# their errors, so twice each bound
TP_TRAIN_LOSS_RTOL = 2 * BF16_LOSS_RTOL
TP_TRAIN_TOTAL_RTOL = 2 * BF16_TOTAL_RTOL
TP_TRAIN_GRAD_RTOL = 2 * BF16_GRAD_RTOL
TP_TRAIN_TIMEOUT = 600  # seconds the ranks of phase 14 may take together
TP_TRAIN_NODE = {"llama_model": "Qwen25", "keep_full_llm": True}
TP_TRAIN_NCCL_ITERS = 3


def tp_train_model(dirs: dict, layout=None) -> tuple:
    """(cfg, frozen, whole cfg, load seconds): phase 10's directories loaded
    through `bootstrap.build_model` with the towers, the LLM whole or, under
    a layout, the rank's shard (cfg.llm its shard config); `whole` is the
    config of the whole LLM, which the trainable tree keeps."""
    from affectgpt_tpu_torch import paths

    paths.PATH_TO_LLM["Qwen25"] = dirs["llm"]
    paths.PATH_TO_VISUAL["CLIP_VIT_LARGE"] = dirs["clip"]
    paths.PATH_TO_AUDIO["HUBERT_LARGE"] = dirs["hubert"]
    t0 = time.perf_counter()
    cfg, frozen, _, _ = bootstrap.build_model(
        TP_TRAIN_NODE, with_encoders=True, device="cuda" if layout is None else layout.device,
        layout=layout)
    torch.cuda.synchronize()
    whole = dataclasses.replace(
        cfg, llm=affectgpt.AffectGPTConfig.from_model_cfg(TP_TRAIN_NODE).llm)
    return cfg, frozen, whole, time.perf_counter() - t0


def tp_train_f32(cfg, frozen: dict) -> tuple:
    """(cfg, frozen) of the first TP_TRAIN_F32_LAYERS layers of the LLM (a
    rank's shard or the whole) in f32."""
    small = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                            num_layers=TP_TRAIN_F32_LAYERS))
    llm = {**frozen["llm"], "layers": frozen["llm"]["layers"][:TP_TRAIN_F32_LAYERS]}
    return small, {"llm": tree_to(llm, torch.float32)}


def tp_train_grads(cfg, frozen: dict, whole, layout=None, controls: bool = False) -> dict:
    """Gates 2-4's readings on one side (tp = 1 without a layout): the loss
    and every trainable gradient in f32 at TP_TRAIN_F32_LAYERS layers with
    dropout off ("f32") and on ("f32_dropout"), in bf16 over every layer
    with remat and dropout on ("bf16"); with `controls`, the f32 ones of the
    two negative controls ("lora_unsummed", "f_skipped"), dropout off. The
    gradients come back on the CPU."""
    from affectgpt_tpu_torch.parallel import mesh

    trainable = train_trainable(whole, 14)
    batch = train_batch(cfg, TP_TRAIN_B, seed=14)
    key = (DROPOUT_SEED, 0)
    small, small_frozen = tp_train_f32(cfg, frozen)
    batch32 = {**batch, "features": tree_to(batch["features"], torch.float32)}

    def run(c, f, b, **kw):
        loss, grads = train_step.loss_and_grads(c, f, trainable, b, layout=layout, **kw)
        return float(loss), [g.cpu() for g in grads]

    out = {"f32": run(small, small_frozen, batch32),
           "f32_dropout": run(small, small_frozen, batch32, key=key)}
    if controls:
        def no_tp_sum(inner):
            def wrapped(tensors, lay, axis="dp"):
                if axis != "tp":
                    inner(tensors, lay, axis)
            return wrapped

        with patched(mesh, "all_reduce_sum", no_tp_sum):
            out["lora_unsummed"] = run(small, small_frozen, batch32)
        with patched(mesh, "copy_to_tp", lambda inner: lambda x, lay: x):
            out["f_skipped"] = run(small, small_frozen, batch32)
    del small_frozen
    torch.cuda.empty_cache()
    out["bf16"] = run(cfg, {"llm": frozen["llm"]}, batch, remat=True, key=key)
    return out


def tp_train_steps(cfg, frozen: dict, whole, n: int, layout=None) -> dict:
    """n steps (b = TP_TRAIN_B, remat=True, dropout on, lr 1e-4) on one
    fixed batch: each step's loss, grad norm and ms (each step synchronized),
    the loss after them, and the peak memory of the steps (the resident
    weights included); under a layout the ranks' trees must be identical
    after them (`train_step.check_tp_replicas` raises)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tx = make_tx(lr=1e-4)
    state = train_step.create_train_state(train_trainable(whole, 15), tx)
    step_fn = train_step.make_train_step(cfg, tx, remat=True, dropout_seed=DROPOUT_SEED,
                                         layout=layout)
    batch = train_batch(cfg, TP_TRAIN_B, seed=15)
    llm = {"llm": frozen["llm"]}
    losses, norms, ms = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, llm, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    with torch.no_grad():
        after = float(affectgpt.forward_loss(llm, state.trainable, cfg, batch))
    if layout is not None:
        train_step.check_tp_replicas(state.trainable, layout)
    return {"losses": losses, "grad_norms": norms, "step_ms": ms, "after": after,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def tp_train_realtime(cfg, frozen: dict, whole, layout) -> dict:
    """Gate 5 on a rank: phase 8's realtime step at b = 2 (the towers encode
    raw media under no_grad, replicated on every rank; the step trains on
    their features), counted; its launches, loss and grad norm."""
    raw = {m: v[:2] for m, v in realtime_media().items()}
    batch = train_batch(cfg, 2, seed=3)
    tx = make_tx()
    state = train_step.create_train_state(train_trainable(whole, 4), tx)
    step_fn = train_step.make_train_step(cfg, tx, remat=True, dropout_seed=DROPOUT_SEED,
                                         layout=layout)

    def run():
        with torch.no_grad():
            feats = encode_media_features(frozen, cfg, raw)
        return step_fn(state, frozen, {**batch, "features": feats})

    (_, metrics), launches = counted_call(run)
    return {"launches": launches, "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"])}


def tp_train_rank_main(rank: int, world: int, address: str, root: str, dirs: dict) -> None:
    """One rank of phase 14, a spawned process: gloo over the one card, its
    shard of phase 10's directory with the towers, gates 1-5's readings,
    saved for the parent; rank 1's lines go to its log."""
    import torch.distributed as dist

    from affectgpt_tpu_torch.parallel import mesh

    if rank:
        log = open(os.path.join(root, f"rank{rank}.log"), "w")
        os.dup2(log.fileno(), 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=address, world_size=world, rank=rank)
    try:
        layout = mesh.create_layout("cuda", tp=world)
        torch.cuda.reset_peak_memory_stats()
        cfg, frozen, whole, load_s = tp_train_model(dirs, layout)
        out = {"rank": rank, "backend": dist.get_backend(), "load_s": load_s,
               "weight_gib": tree_gib(frozen["llm"]),
               "grads": tp_train_grads(cfg, frozen, whole, layout, controls=True),
               "steps": tp_train_steps(cfg, frozen, whole, TP_TRAIN_STEPS, layout),
               "realtime": tp_train_realtime(cfg, frozen, whole, layout)}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_train_spawn(root: str, dirs: dict) -> float:
    """Run TP ranks of tp_train_rank_main within TP_TRAIN_TIMEOUT, as
    tp_spawn does; returns the seconds taken."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
    t0 = time.perf_counter()
    ctx = mp.start_processes(tp_train_rank_main, args=(TP, address, root, dirs), nprocs=TP,
                             join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > TP_TRAIN_TIMEOUT:
                raise AssertionError(f"tp_train: the ranks did not finish within "
                                     f"{TP_TRAIN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return time.perf_counter() - t0


def tp_train_nccl(card: str, tmp: str, dirs: dict) -> None:
    """Where the machine has two cards or more: `python -m
    affectgpt_tpu_torch.train --multihost --options run.tp=2`, one rank a
    card on NCCL (the environment torchrun gives each rank), for
    TP_TRAIN_NCCL_ITERS iterations on phase 9's synthetic corpus and phase
    10's directory, then the same run at tp = 1 on one card: each
    iteration's loss within TP_TRAIN_LOSS_RTOL of tp = 1's."""
    import re
    import socket

    root = os.path.join(tmp, "tp_train_nccl")
    os.makedirs(root)
    section, feat_root = write_runner_corpus(root)
    raw = json.loads(json.dumps(BESTSETUP))
    raw["model"].update(TP_TRAIN_NODE)
    raw["datasets"]["mercaptionplus"].update(preextracted_root=feat_root)
    raw["run"].update(output_dir=os.path.join(root, "out"), max_epoch=1,
                      iters_per_epoch=TP_TRAIN_NCCL_ITERS, warmup_steps=0, log_freq=1,
                      remat=True, job_id="nccl")
    raw["paths"] = {**section, "PATH_TO_LLM": {"Qwen25": dirs["llm"]}}
    cfg_path = os.path.join(root, "exp_tp_train.json")
    with open(cfg_path, "w") as handle:
        json.dump(raw, handle)
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    command = [sys.executable, "-m", "affectgpt_tpu_torch.train", "--cfg-path", cfg_path]

    def losses(text: str) -> list:
        return [float(x) for x in re.findall(r"iter \d+/\d+ loss ([0-9.naninf-]+)", text)]

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = [subprocess.Popen(command + ["--multihost", "--options", f"run.tp={TP}",
                                         f"run.job_id=nccl_tp{TP}"],
                              cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r),
                                   "WORLD_SIZE": str(TP), "MASTER_ADDR": "localhost",
                                   "MASTER_PORT": port})
             for r in range(TP)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TP_TRAIN_TIMEOUT)[0])
    finally:
        for proc in procs:
            proc.kill()
    if any(p.returncode for p in procs):
        raise AssertionError(f"tp_train: train --multihost run.tp={TP} failed:\n"
                             + "\n".join(log[-3000:] for log in logs))
    tp_s = time.perf_counter() - t0
    one = subprocess.run(command + ["--options", "run.job_id=nccl_tp1"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=TP_TRAIN_TIMEOUT)
    if one.returncode:
        raise AssertionError(f"tp_train: train at tp=1 failed:\n{one.stderr[-3000:]}")
    got, want = losses(logs[0]), losses(one.stderr + one.stdout)
    say("tp_train", part="nccl", command=f"train --multihost run.tp={TP}", backend="nccl",
        cards=torch.cuda.device_count(), losses=json.dumps(got), losses_tp1=json.dumps(want),
        seconds=f"{tp_s:.3f}", card=repr(card))
    if len(got) != TP_TRAIN_NCCL_ITERS or len(want) != len(got) or not all(
            abs(a - b) <= TP_TRAIN_LOSS_RTOL * abs(b) for a, b in zip(got, want)):
        raise AssertionError(f"tp_train: NCCL losses {got} against tp=1's {want}")


def tp_train_gate(what: str, got: tuple, want: tuple, names: list, sizes: dict,
                  loss_rtol: float, total_rtol: float, leaf_rtol: float, card: str) -> dict:
    """One comparison of (loss, gradients) with tp = 1's: printed, and
    raised unless the loss, the whole gradient and every leaf of at least
    GATED_LEAF_SIZE elements are within their bounds. Returns the errors."""
    errs = grad_errors(got[1], want[1], names)
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    gated = {k: v for k, v in errs.items() if k != "(all)" and sizes[k] >= GATED_LEAF_SIZE}
    say("tp_train", gate=what, loss=f"{got[0]:.6f}", loss_tp1=f"{want[0]:.6f}",
        loss_rel_err=f"{loss_err:.3e}", grad_rel_err_all=f"{errs['(all)']:.4e}",
        gated_leaves=len(gated), worst_gated=worst(gated, 3),
        bounds=json.dumps([loss_rtol, total_rtol, leaf_rtol]), card=repr(card))
    if not (np.isfinite(got[0]) and loss_err <= loss_rtol and errs["(all)"] <= total_rtol
            and gated and all(v <= leaf_rtol for v in gated.values())):
        raise AssertionError(f"tp_train: {what}: loss error {loss_err:.4g}, gradient errors "
                             f"{worst(errs)} above {loss_rtol}, {total_rtol}, {leaf_rtol}")
    return errs


def phase_tp_train(card: str, dirs: dict, tmp: str) -> dict:
    """Phase 14: tensor-parallel training of phase 10's directory at tp = 2
    on the card. The parent loads it whole (tp = 1) and records gates 2-3's
    references and TP_TRAIN_TP1_STEPS timed steps; then TP ranks, spawned
    processes sharing the card over gloo, each load their shard and run
    gates 1-5 (`tp_train_rank_main`). Gates: (1) every loss and grad norm
    finite and the loss after TP_TRAIN_STEPS steps on one batch below the
    first step's, the ranks' trees identical after them; (2) f32 at
    TP_TRAIN_F32_LAYERS layers, dropout off and on: the loss, the whole
    gradient and each leaf of GATED_LEAF_SIZE elements within
    TP_TRAIN_REL_L2_F32 of tp = 1's; (3) bf16 over every layer (remat,
    dropout on) within TP_TRAIN_*_RTOL; (4) the negative controls above
    TP_TRAIN_REL_L2_F32; (5) the realtime step launching rows 11 and 12 48
    times each on each rank, and nothing else. With two cards or more
    `tp_train_nccl` runs too. Returns rank 0's launches in gate 5."""
    from affectgpt_tpu_torch import paths

    t0 = time.perf_counter()
    root = os.path.join(tmp, "tp_train")
    os.makedirs(root)
    saved = {k: dict(v) for k, v in paths.TABLES.items()}
    try:
        torch.cuda.reset_peak_memory_stats()
        cfg, frozen, whole, load_s = tp_train_model(dirs)
        one = {"grads": tp_train_grads(cfg, frozen, whole),
               "steps": tp_train_steps(cfg, frozen, whole, TP_TRAIN_TP1_STEPS),
               "weight_gib": tree_gib(frozen["llm"]), "load_s": load_s}
        del cfg, frozen
        torch.cuda.empty_cache()
        spawn_s = tp_train_spawn(root, dirs)
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                 for r in range(TP)]
        if torch.cuda.device_count() >= TP:
            tp_train_nccl(card, tmp, dirs)
        else:
            say("tp_train", part="nccl", skipped=f"{torch.cuda.device_count()} card: NCCL takes "
                f"one rank a card, so train --multihost run.tp={TP} needs {TP}", card=repr(card))
    finally:
        for k, v in saved.items():
            paths.TABLES[k].clear()
            paths.TABLES[k].update(v)
    trainable = train_trainable(whole, 14)
    names = optim.tree_paths(trainable)
    sizes = {k: t.numel() for k, t in zip(names, optim.tree_leaves(trainable))}
    del trainable
    for r in ranks:
        steps = r["steps"]
        say("tp_train", gate="loss_falls", rank=r["rank"], batch=TP_TRAIN_B, remat=True,
            dropout=True, losses=json.dumps([round(x, 5) for x in steps["losses"]]),
            loss_after=f"{steps['after']:.5f}",
            grad_norms=json.dumps([round(x, 4) for x in steps["grad_norms"]]),
            trees_identical_across_ranks=True, card=repr(card))
        if not (all(np.isfinite(steps["losses"] + steps["grad_norms"] + [steps["after"]]))
                and steps["after"] < steps["losses"][0]):
            raise AssertionError(f"tp_train: rank {r['rank']}: the loss did not fall over "
                                 f"{TP_TRAIN_STEPS} steps: {steps['losses']}, {steps['after']}")
    got, want = ranks[0]["grads"], one["grads"]
    for name in ("f32", "f32_dropout"):
        tp_train_gate(name, got[name], want[name], names, sizes, TP_TRAIN_REL_L2_F32,
                      TP_TRAIN_REL_L2_F32, TP_TRAIN_REL_L2_F32, card)
    tp_train_gate("bf16", got["bf16"], want["bf16"], names, sizes, TP_TRAIN_LOSS_RTOL,
                  TP_TRAIN_TOTAL_RTOL, TP_TRAIN_GRAD_RTOL, card)
    for control in ("lora_unsummed", "f_skipped"):
        errs = grad_errors(got[control][1], want["f32"][1], names)
        say("tp_train", negative_control=control, grad_rel_err_all=f"{errs['(all)']:.4e}",
            worst=worst(errs, 3), must_exceed=TP_TRAIN_REL_L2_F32, card=repr(card))
        if not errs["(all)"] > TP_TRAIN_REL_L2_F32:
            raise AssertionError(f"tp_train: the negative control {control} reads "
                                 f"{errs['(all)']:.4g}, not above {TP_TRAIN_REL_L2_F32}")
    same = all(torch.equal(a, b) for name in ("f32", "f32_dropout", "bf16")
               for a, b in zip(got[name][1], ranks[1]["grads"][name][1]))
    vcfg = encoder_configs(whole)[1]
    expected = {"attn_sublayer": 2 * vcfg.num_layers, "mlp_sublayer": 2 * vcfg.num_layers}
    for r in ranks:
        rt = r["realtime"]
        say("tp_train", gate="realtime", rank=r["rank"], batch=2,
            launches=json.dumps({k: v for k, v in rt["launches"].items() if v}),
            loss=f"{rt['loss']:.5f}", grad_norm=f"{rt['grad_norm']:.4f}", card=repr(card))
        check_launches(f"tp_train realtime rank {r['rank']}", rt["launches"], expected)
        if not (np.isfinite(rt["loss"]) and np.isfinite(rt["grad_norm"])):
            raise AssertionError(f"tp_train realtime rank {r['rank']}: non-finite loss")
    step_ms = [statistics.mean(r["steps"]["step_ms"][1:]) for r in ranks]
    say("tp_train", backend=ranks[0]["backend"], ranks=TP, cards=torch.cuda.device_count(),
        shared_card=torch.cuda.device_count() < TP, batch=TP_TRAIN_B, seq=TRAIN_T, remat=True,
        note="two ranks on one card over gloo: a time here is no tensor-parallel speedup",
        step_ms_tp1=f"{statistics.mean(one['steps']['step_ms'][1:]):.3f}",
        step_ms_per_rank=json.dumps([round(x, 3) for x in step_ms]),
        peak_gib_tp1=f"{one['steps']['peak_gib']:.3f}",
        peak_gib_per_rank=json.dumps([round(r["steps"]["peak_gib"], 3) for r in ranks]),
        weight_gib_tp1=f"{one['weight_gib']:.3f}",
        weight_gib_per_rank=json.dumps([round(r["weight_gib"], 3) for r in ranks]),
        load_s_tp1=f"{one['load_s']:.3f}",
        load_s_per_rank=json.dumps([round(r["load_s"], 3) for r in ranks]),
        grads_identical_across_ranks=same, spawn_to_end_s=f"{spawn_s:.3f}",
        phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))
    return ranks[0]["realtime"]["launches"]


# ---------------------------------------------------------------------------
# Phase 15: the MERBench toolkit

# MERBench's best MER2023 features (audio: chinese-hubert-large, text:
# Baichuan-13B, video: CLIP ViT-L) and its hidden width
TOOLKIT_ARGS = {"audio_dim": 1024, "text_dim": 5120, "video_dim": 768, "hidden_dim": 128}
TOOLKIT_TRAIN = 3373  # MER2023's train set: one epoch of it a model
TOOLKIT_TEST = 411  # MER2023's test1 set, the table evaluate_fusion_model scores
TOOLKIT_BATCH = 32
TOOLKIT_STEPS = 32  # the frame-level models' sequence length
FRAME_LEVEL = ("ef_lstm", "mfn", "graph_mfn", "mctn")  # as JAX's tests split them
E2E_CLIPS, E2E_FRAMES, E2E_AUDIO = 4, 8, 2  # clips; 224² frames and 2 s audio clips a clip
E2E_STEPS = 5
E2E_LR = 1e-5
VMAE_B = 8
VMAE_STEPS = 5
VMAE_LR = 1.5e-4  # VideoMAE's base learning rate
GPTV_IMAGES = 8  # one batch of annotate_images
# a kernel route's output against the plain route's on the same bf16 tree
TOOLKIT_REL_TOL = ZOO_REL_TOL


def fusion_table(g: torch.Generator, frame: bool, n: int, seed: int):
    """A FeatureTable of n clips made on the card: features N(0, 1), the
    label in the audio stream's first column (a signal to learn), valence
    from the label."""
    from affectgpt_tpu_torch.toolkit.train import FeatureTable

    rng = np.random.RandomState(seed)
    emos = rng.randint(0, 6, n)
    steps = (TOOLKIT_STEPS,) if frame else ()
    feats = {k: torch.randn((n, *steps, TOOLKIT_ARGS[f"{k[:-1]}_dim"]), generator=g,
                            device="cuda") for k in ("audios", "texts", "videos")}
    label = torch.as_tensor(emos, dtype=torch.float32, device="cuda")
    feats["audios"][..., 0] = label.reshape(n, *([1] * len(steps)))
    return FeatureTable(names=[f"clip_{i:05d}" for i in range(n)], **feats, emos=emos,
                        vals=((emos - 3) / 6).astype(np.float32))


def noted_peak(peaks: list) -> str:
    """The card's peak GiB since the last reset, appended to `peaks` (the
    phase prints their largest)."""
    peaks.append(torch.cuda.max_memory_allocated() / 2**30)
    return f"{peaks[-1]:.3f}"


def toolkit_fusion(card: str, peaks: list) -> dict:
    """The 13 fusion baselines at MERBench's MER2023 widths: one epoch of
    TOOLKIT_TRAIN clips at batch 32 through train_fusion_model (Adam, lr
    1e-3), then evaluate_fusion_model on TOOLKIT_TEST clips; frame-level
    models on sequences of TOOLKIT_STEPS. No kernel; every loss and metric
    finite. Returns {model: (steps, seconds)}."""
    from affectgpt_tpu_torch.toolkit import train as fusion_train
    from affectgpt_tpu_torch.toolkit.models import FUSION_MODELS, FusionArgs

    g = torch.Generator(device="cuda").manual_seed(31)
    tables = {frame: (fusion_table(g, frame, TOOLKIT_TRAIN, 1),
                      fusion_table(g, frame, TOOLKIT_TEST, 2)) for frame in (False, True)}
    args = FusionArgs(**TOOLKIT_ARGS)
    steps = -(-TOOLKIT_TRAIN // TOOLKIT_BATCH)
    out = {}
    for name in FUSION_MODELS:
        train_t, test_t = tables[name in FRAME_LEVEL]
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (params, history), launches = counted_call(lambda: fusion_train.train_fusion_model(
            name, args, train_t, epochs=1, batch_size=TOOLKIT_BATCH, seed=0, device="cuda"))
        seconds = time.perf_counter() - t0
        metrics, more = counted_call(
            lambda: fusion_train.evaluate_fusion_model(name, args, params, test_t))
        check_launches(f"toolkit {name} train", launches, {})
        check_launches(f"toolkit {name} evaluate", more, {})
        loss = history[0]["train_loss"]
        say("toolkit", model=name, level="frame" if name in FRAME_LEVEL else "utt",
            clips=TOOLKIT_TRAIN, steps=steps, seconds=f"{seconds:.3f}",
            steps_per_s=f"{steps / seconds:.2f}", train_loss=f"{loss:.5f}",
            test=json.dumps({k: round(v, 5) for k, v in metrics.items()}),
            params_gib=f"{tree_gib(params):.3f}",
            peak_gib=noted_peak(peaks), card=repr(card))
        want = ["combined", "emo_accuracy", "emo_waf1", "val_mse", "val_pcc"]
        if not np.isfinite(loss) or sorted(metrics) != want or not all(
                np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"toolkit {name}: loss {loss}, metrics {metrics}")
        out[name] = (steps, seconds)
        del params
        torch.cuda.empty_cache()
    del tables
    return out


def adam_steps(params: dict, loss_fn, n: int, lr: float) -> tuple:
    """n steps of optax's adam(lr) (`optim.AdamW`, no weight decay) on the
    f32 tree `params` under autograd; returns (losses, step seconds)."""
    tx = optim.AdamW(schedule=lambda _s: lr, weight_decay=0.0)
    leaves = optim.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    state = tx.init(params)
    losses, seconds = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if d is None else d for p, d in zip(leaves, grads)]
        state = tx.apply(optim.tree_unflatten(params, grads), state, params)
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return losses, seconds


def routes_forward(what: str, fn, expected: dict, plain_switches) -> tuple:
    """fn() under no_grad on the default route (its launches exactly
    `expected`) and on the plain chain (`plain_switches`, no launch); the
    first output of each, finite, within TOOLKIT_REL_TOL of each other.
    Returns (the default route's output, its launches, its wall ms, the
    relative error)."""
    with torch.no_grad():
        out, launches = counted_call(fn)
        with switched(plain_switches):
            plain, none = counted_call(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    check_launches(f"toolkit {what}", launches, expected)
    check_launches(f"toolkit {what} plain", none, {})
    first = out[0] if isinstance(out, tuple) else out
    want = plain[0] if isinstance(plain, tuple) else plain
    err = rel_l2(first.float(), want.float())
    if not bool(torch.isfinite(first).all()) or err > TOOLKIT_REL_TOL:
        raise AssertionError(f"toolkit {what}: finite {bool(torch.isfinite(first).all())}, "
                             f"rel. L2 {err} from the plain chain")
    return out, launches, ms, err


def toolkit_e2e(card: str, peaks: list, cfg=None) -> dict:
    """The e2e raw-media model at CLIP ViT-L/14 + HuBERT-large (random f32
    weights from a seed), E2E_CLIPS clips of E2E_FRAMES 224² frames and
    E2E_AUDIO 2 s audio clips: a bf16 forward under no_grad through rows 11
    and 12 (one launch each a CLIP layer, against the plain chain), then
    E2E_STEPS f32 Adam steps with autograd through both towers (the plain
    chain: no launch), the loss falling and CLIP's patch embedding moving.
    Returns the forward's launches."""
    from affectgpt_tpu_torch.toolkit import e2e

    cfg = cfg or e2e.E2EConfig(vision=clip_vit.ClipVisionConfig.vit_l_14(),
                               audio=hubert.HubertConfig.large())
    g = torch.Generator(device="cuda").manual_seed(37)
    params = e2e.init_params(g, cfg, dtype=torch.float32)
    size = cfg.vision.image_size
    batch = {"frames": torch.randn((E2E_CLIPS, E2E_FRAMES, size, size, 3), generator=g,
                                   device="cuda"),
             "audios": torch.randn((E2E_CLIPS, E2E_AUDIO, 1, RT_SAMPLES), generator=g,
                                   device="cuda") * 0.1,
             "texts": torch.randn((E2E_CLIPS, cfg.text_dim), generator=g, device="cuda")}
    labels = torch.arange(E2E_CLIPS, device="cuda") % cfg.output_dim1
    frozen = tree_to(params, torch.bfloat16)
    layers = cfg.vision.num_layers
    torch.cuda.reset_peak_memory_stats()
    out, launches, ms, err = routes_forward(
        "e2e forward", lambda: e2e.apply(frozen, cfg, batch),
        {"attn_sublayer": layers, "mlp_sublayer": layers},
        [(clip_vit, "ATTN_IMPL", "xla"), (nn, "FUSED_MHA", "0")])
    if tuple(out[1].shape) != (E2E_CLIPS, cfg.output_dim1):
        raise AssertionError(f"toolkit e2e: logits of shape {tuple(out[1].shape)}")
    forward_peak = noted_peak(peaks)
    del frozen, out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = params["visual"]["patch_embed"]["w"].clone()
    (losses, seconds), none = counted_call(lambda: adam_steps(
        params, lambda p: torch.nn.functional.cross_entropy(e2e.apply(p, cfg, batch)[1],
                                                            labels), E2E_STEPS, E2E_LR))
    check_launches("toolkit e2e training", none, {})
    moved = not torch.equal(before, params["visual"]["patch_embed"]["w"])
    say("toolkit", run="e2e", clips=E2E_CLIPS, frames=E2E_FRAMES, audio_clips=E2E_AUDIO,
        forward_bf16_ms=f"{ms:.3f}", forward_rel_l2_vs_plain=f"{err:.5f}",
        forward_peak_gib=forward_peak,
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        train_losses=json.dumps([round(x, 5) for x in losses]),
        step_s=json.dumps([round(x, 3) for x in seconds]),
        steps_per_s=f"{len(seconds[1:]) / sum(seconds[1:]):.3f}", patch_embed_moved=moved,
        params_gib=f"{tree_gib(params):.3f}", train_peak_gib=noted_peak(peaks), card=repr(card))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and moved):
        raise AssertionError(f"toolkit e2e: losses {losses}, patch embedding moved {moved}")
    return launches


def toolkit_videomae(card: str, peaks: list, cfg=None) -> tuple:
    """VideoMAE at its default config, VMAE_B videos of 16 224² frames (1568
    tubes, 156 visible): VMAE_STEPS f32 pretraining steps under one mask
    (the plain chain: no launch), the loss falling; then encode_video in
    bf16 through row 13 (once a layer over all 1568 tubes, against the plain
    chain); then row 13 at that shape against its plain version, timed
    (zoo_attention). Returns (encode_video's launches, the shape's record)."""
    from affectgpt_tpu_torch.toolkit import videomae

    cfg = cfg or videomae.VideoMAEConfig()
    g = torch.Generator(device="cuda").manual_seed(41)
    params = videomae.init_params(g, cfg, dtype=torch.float32)
    video = torch.rand((VMAE_B, cfg.num_frames, cfg.image_size, cfg.image_size, 3),
                       generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    (losses, seconds), none = counted_call(lambda: adam_steps(
        params, lambda p: videomae.pretrain_loss(p, cfg, video, (41, 0)), VMAE_STEPS, VMAE_LR))
    check_launches("toolkit videomae pretraining", none, {})
    peak = noted_peak(peaks)
    frozen = tree_to(params, torch.bfloat16)
    n = cfg.num_patches
    expected = {"fused_vit_attention": cfg.num_layers} if nn._fused_self_attn_ok(n, n, None) \
        else {}
    out, launches, ms, err = routes_forward(
        "videomae encode_video", lambda: videomae.encode_video(frozen, cfg, video), expected,
        [(nn, "FUSED_MHA", "0")])
    say("toolkit", run="videomae", videos=VMAE_B, tubes=n, visible=cfg.num_visible,
        train_losses=json.dumps([round(x, 5) for x in losses]),
        step_s=json.dumps([round(x, 3) for x in seconds]),
        steps_per_s=f"{len(seconds[1:]) / sum(seconds[1:]):.3f}", train_peak_gib=peak,
        encode_video_bf16_ms=f"{ms:.3f}", encode_rel_l2_vs_plain=f"{err:.5f}",
        launches=json.dumps({k: v for k, v in launches.items() if v}), card=repr(card))
    if tuple(out.shape) != (VMAE_B, cfg.width) or not (
            all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"toolkit videomae: losses {losses}, features {tuple(out.shape)}")
    del frozen, params, video, out
    torch.cuda.empty_cache()
    shape = {"videomae": (VMAE_B, cfg.num_heads, n, cfg.width // cfg.num_heads)}
    return launches, zoo_attention(card, shape, tag="toolkit")


def toolkit_gptv(card: str, peaks: list, dirs: dict, tmp: str) -> dict:
    """One batch of GPTV_IMAGES JPEG images (encoded on the card) through
    gptv.annotate_images with the mer2023 vocabulary, its transport
    LocalJudgeTransport over the LLM judge loaded from phase 10's 7B
    directory (JUDGE_TOKENS sampled tokens): one generate call of one row,
    rows 1-2 launched layers x its steps, one batch file holding the images
    in the persisted order and the response; parsing and top-1 scoring run
    on it. Returns the launches."""
    import os

    from affectgpt_tpu_torch import paths
    from affectgpt_tpu_torch.data import jpeg_encode
    from affectgpt_tpu_torch.evaluation import __main__ as evaluation
    from affectgpt_tpu_torch.evaluation.judge import LLMJudge
    from affectgpt_tpu_torch.toolkit import api_helpers, gptv

    saved = dict(paths.PATH_TO_LLM)
    try:
        paths.PATH_TO_LLM["Qwen25"] = dirs["llm"]
        judge = evaluation.build_judge(True, device="cuda")
    finally:
        paths.PATH_TO_LLM.clear()
        paths.PATH_TO_LLM.update(saved)
    if not isinstance(judge, LLMJudge):
        raise AssertionError("toolkit gptv: no LLM judge over phase 10's directory")
    judge.max_new_tokens = JUDGE_TOKENS
    os.makedirs(tmp, exist_ok=True)
    images = []
    for i, data in enumerate(jpeg_encode.encode_frames(smooth_frames(GPTV_IMAGES, 224, 224),
                                                       90, device="cuda")):
        images.append(os.path.join(tmp, f"face_{i}.jpg"))
        with open(images[-1], "wb") as handle:
            handle.write(data)
    save_root, order = os.path.join(tmp, "gptv"), os.path.join(tmp, "order.npz")
    _, launches = judge_run(card, "gptv", lambda: gptv.annotate_images(
        api_helpers.LocalJudgeTransport(judge), images, save_root, order,
        gptv.GPTV_EMOS["mer2023"], bsize=GPTV_IMAGES), judge.llm_cfg.num_layers, [1],
        tag="toolkit")
    files = sorted(os.listdir(save_root))
    with np.load(os.path.join(save_root, "batch_1.npz"), allow_pickle=True) as pack:
        names, response = pack["names"].tolist(), str(pack["gpt4v"])
    with np.load(order, allow_pickle=True) as pack:
        ordered = pack["image_paths"].tolist()
    parsed = gptv.collect_batches(save_root, delete_bad=False)[1]
    accuracy = gptv.score_top1(save_root, {os.path.basename(p): "happy" for p in images})
    say("toolkit", run="gptv", images=GPTV_IMAGES, files=json.dumps(files),
        parsed_results=len(parsed), top1=f"{accuracy:.3f}", peak_gib=noted_peak(peaks),
        response=json.dumps(response[:80]), card=repr(card))
    if files != ["batch_1.npz"] or names != ordered or sorted(names) != sorted(images) \
            or not 0.0 <= accuracy <= 1.0:
        raise AssertionError(f"toolkit gptv: files {files}, names {names}")
    del judge
    torch.cuda.empty_cache()
    return launches


def phase_toolkit(card: str, dirs: dict, tmp: str, e2e_cfg=None, vmae_cfg=None) -> dict:
    """Phase 15: the MERBench toolkit on the card. The fusion baselines
    (toolkit_fusion), the e2e model (toolkit_e2e), VideoMAE
    (toolkit_videomae) and the GPT-4V harness over the LLM judge
    (toolkit_gptv); e2e_cfg / vmae_cfg replace the full-width configs for a
    rehearsal on the CPU. Returns {"launches": {run: its launches},
    "attention": row 13's record at VideoMAE's shape}."""
    t0 = time.perf_counter()
    peaks = []
    fusion = toolkit_fusion(card, peaks)
    launches = {"e2e_forward": toolkit_e2e(card, peaks, e2e_cfg)}
    launches["videomae_encode"], attention = toolkit_videomae(card, peaks, vmae_cfg)
    torch.cuda.reset_peak_memory_stats()
    launches["gptv"] = toolkit_gptv(card, peaks, dirs, tmp)
    steps = sum(s for s, _ in fusion.values())
    say("toolkit", fusion_models=len(fusion), fusion_steps=steps,
        fusion_seconds=f"{sum(t for _, t in fusion.values()):.3f}",
        fusion_steps_per_s=f"{steps / sum(t for _, t in fusion.values()):.2f}",
        launches=json.dumps({run: {k: v for k, v in c.items() if v}
                             for run, c in launches.items()}),
        peak_gib=f"{max(peaks):.3f}", phase_seconds=f"{time.perf_counter() - t0:.3f}",
        card=repr(card))
    return {"launches": launches, "attention": attention}


OVMER_FRAMES = 150  # the clip: more frames than Chat-UniVi's and Video-ChatGPT's 100-frame reads
OVMER_SHAPE = (112, 192)  # its frames (a dense read decodes 512 of them on the host)
OVMER_RATE = 48000  # the stereo wav's rate, resampled to the extractor's 16 kHz
OVMER_REPLY = "happy, with a calm smile"
OVMER_TRANSCRIPT = "we won the final"
OVMER_NAMES = ["ov_clip_a", "ov_clip_b"]  # a readable clip, then one no decoder reads
# the vision geometry of each family's published HF checkpoint, and the
# adapters' token ids (those of the checkpoints' tokenizers)
OVMER_FAMILIES = {
    "llava-1.5": dict(image_size=336, patch_size=14),  # llava-hf/llava-1.5-7b-hf
    "llava-next-video": dict(image_size=336, patch_size=14,  # llava-hf/LLaVA-NeXT-Video-7B-hf
                             spatial_pool_stride=2),
    "video-llava": dict(image_size=224, patch_size=14),  # LanguageBind/Video-LLaVA-7B-hf
}
OVMER_SPECIALS = {"<image>": 32000, "<video>": 32001, "<|AUDIO|>": 151646}
# run: (adapter, family, build kwargs, frames T its rule takes from the clip's read)
OVMER_VIDEO = {
    "videollava": ("videollava", "video-llava", {}, 8),
    "chat_univi": ("chat_univi", "llava-1.5", {}, 4),  # 100 read, 25 fps stride: 4
    "chat_univi_1fps": ("chat_univi", "llava-1.5", {"assumed_fps": 1.0}, 100),  # the cap: 100
    "llama_vid": ("llama_vid", "llava-1.5", {}, 21),  # 512 read, stride 25
    "mplug_owl": ("mplug_owl", "llava-1.5", {"max_length": 4096}, 4),  # 512 reaches no answer
    "otter": ("otter", "llava-1.5", {}, 16),
    "videochat": ("videochat", "llava-1.5", {}, 8),
    "videochat2": ("videochat2", "llava-next-video", {}, 8),
    "video_chatgpt": ("video_chatgpt", "llava-next-video", {}, 100),
}
OVMER_PIXEL_ATOL = 1e-5  # the card's preprocessing against the port's CPU preprocessing
OVMER_WAV_ATOL = 1e-6


class TokenizerDouble:
    """An HF-shaped tokenizer: each of OVMER_SPECIALS is one id, any other
    text one id a UTF-8 byte."""

    def __init__(self):
        import re

        self.split = re.compile("(" + "|".join(map(re.escape, OVMER_SPECIALS)) + ")").split
        self.tokens = {i: t for t, i in OVMER_SPECIALS.items()}

    def convert_ids_to_tokens(self, index: int) -> str:
        return self.tokens[index]

    def encode(self, text: str) -> list:
        ids = []
        for piece in self.split(text):
            ids.extend([OVMER_SPECIALS[piece]] if piece in OVMER_SPECIALS else piece.encode())
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        out, raw = [], bytearray()
        for i in ids:
            if i < 256:
                raw.append(i)
                continue
            out.append(raw.decode(errors="replace"))
            raw = bytearray()
            if not skip_special_tokens:
                out.append(self.tokens[i])
        return "".join(out) + raw.decode(errors="replace")

    def batch_decode(self, rows, skip_special_tokens: bool = False) -> list:
        return [self.decode(r.tolist(), skip_special_tokens) for r in rows]

    def __call__(self, texts, add_special_tokens: bool = False):
        return types.SimpleNamespace(input_ids=[self.encode(t) for t in texts])


class BatchDouble(dict):
    """A processor's output: items as attributes, `.to(device)`."""

    __getattr__ = dict.__getitem__

    def to(self, device):
        return BatchDouble({k: v.to(device) for k, v in self.items()})


class ProcessorDouble:
    """Qwen2-Audio's processor (text and audio) or Whisper's (audio as its
    first argument): records each call; the features are the waveform."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.feature_extractor = types.SimpleNamespace(sampling_rate=16000)
        self.calls = []

    def __call__(self, *wav, text=None, audio=None, sampling_rate=None, return_tensors=None):
        audio = list(wav) or audio
        self.calls.append((text, audio, sampling_rate))
        out = BatchDouble(input_features=torch.as_tensor(np.stack(audio))[:, None])
        if text is not None:
            out["input_ids"] = torch.tensor([self.tokenizer.encode(text)])
            out["attention_mask"] = torch.ones_like(out["input_ids"])
        return out

    def batch_decode(self, rows, skip_special_tokens: bool = False) -> list:
        return self.tokenizer.batch_decode(rows, skip_special_tokens)


class ModelDouble:
    """An HF-shaped model: a `config` of a family's published geometry, and a
    generate that records its arguments and answers `reply` after the
    prompt (or alone, as Whisper's does), or raises `error`."""

    def __init__(self, config=None, reply: str = OVMER_REPLY, after_prompt: bool = True,
                 error: Optional[Exception] = None):
        self.config, self.after_prompt, self.error = config, after_prompt, error
        self.reply = reply.encode()
        self.calls = []

    def generate(self, *args, **kwargs):
        if self.error is not None:
            raise self.error
        self.calls.append((args, kwargs))
        prompt = kwargs["input_ids"] if self.after_prompt else args[0]
        reply = torch.tensor([list(self.reply)], device=prompt.device)
        return torch.cat([prompt, reply], 1) if self.after_prompt else reply


def ovmer_config(family: str):
    geometry = dict(OVMER_FAMILIES[family])
    pool = geometry.pop("spatial_pool_stride", None)
    config = types.SimpleNamespace(
        vision_config=types.SimpleNamespace(**geometry),
        image_token_index=OVMER_SPECIALS["<image>"], video_token_index=OVMER_SPECIALS["<video>"],
        audio_token_index=OVMER_SPECIALS["<|AUDIO|>"], vision_feature_select_strategy="default")
    if pool is not None:
        config.spatial_pool_stride = pool
    return config


def write_stereo_wav(path: str, samples: np.ndarray, rate: int) -> np.ndarray:
    """16-bit PCM of [n, 2] samples in [-1, 1]; returns the int16 samples."""
    import struct

    pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, rate, rate * 4, 4, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
    return pcm


def write_ovmer_root(root: str) -> tuple:
    """A two-clip MER2023 label root: clip a an MJPEG-AVI of OVMER_FRAMES
    frames (the port's JPEG encoder, DCT on the card) and a 2 s stereo wav
    at OVMER_RATE; clip b a video file no decoder reads and no wav. Sets
    the path tables; returns (the clip's subtitle, the 16 kHz mono waveform
    the adapters should read, computed here from the int16 samples)."""
    import os

    from affectgpt_tpu_torch import paths
    from affectgpt_tpu_torch.data import ingest

    for sub in ("video", "audio"):
        os.makedirs(os.path.join(root, sub))
    ingest.write_mjpeg_avi(os.path.join(root, "video", f"{OVMER_NAMES[0]}.mp4"),
                           smooth_frames(OVMER_FRAMES, *OVMER_SHAPE), fps=25.0, device="cuda")
    with open(os.path.join(root, "video", f"{OVMER_NAMES[1]}.mp4"), "wb") as handle:
        handle.write(b"\x00" * 64)
    rng = np.random.RandomState(23)
    pcm = write_stereo_wav(os.path.join(root, "audio", f"{OVMER_NAMES[0]}.wav"),
                           rng.randn(2 * OVMER_RATE, 2) * 0.2, OVMER_RATE)
    mono = (pcm.astype(np.float32) / 32768.0).mean(axis=1)
    n_out = int(round(len(mono) * 16000 / OVMER_RATE))
    want = np.interp(np.linspace(0.0, 1.0, n_out, endpoint=False),
                     np.linspace(0.0, 1.0, len(mono), endpoint=False), mono)
    corpus = {n: {"emo": "happy"} for n in OVMER_NAMES}
    label = os.path.join(root, "label-6way.npz")
    np.savez(label, train_corpus=np.array(corpus, dtype=object),
             test1_corpus=np.array(corpus, dtype=object))
    subtitles = os.path.join(root, "transcription.csv")
    write_csv(subtitles, ["name", "english"], [(n, SUBTITLES[i]) for i, n in enumerate(OVMER_NAMES)])
    paths.update_from_dict({"DATA_DIR": {"MER2023": root}, "PATH_TO_LABEL": {"MER2023": label},
                            "PATH_TO_TRANSCRIPTIONS": {"MER2023": subtitles},
                            "PATH_TO_RAW_VIDEO": {"MER2023": os.path.join(root, "video")},
                            "PATH_TO_RAW_AUDIO": {"MER2023": os.path.join(root, "audio")}})
    return SUBTITLES[0], want.astype(np.float32)


def ovmer_saved(what: str, save: str) -> dict:
    with np.load(save, allow_pickle=True) as data:
        if data.files != ["name2reason"]:
            raise AssertionError(f"ovmer {what}: npz keys {data.files}")
        saved = data["name2reason"].item()
    if saved != {OVMER_NAMES[0]: OVMER_REPLY, OVMER_NAMES[1]: ""}:
        raise AssertionError(f"ovmer {what}: saved {saved!r}")
    return saved


def ovmer_video(card: str, run: str, root: str) -> None:
    """One video adapter through run_zero_shot on the two-clip root with a
    ModelDouble of its family's geometry: the pixels on the card at [T, 3,
    S, S] (or [1, T, 3, S, S]) of the adapter's rule, equal to the port's CPU
    preprocessing of the same frames, tokens a frame x T image tokens in the
    prompt, the double's reply for clip a and "" for clip b."""
    import importlib
    import os

    from affectgpt_tpu_torch.ovmer import zero_shot_harness
    from affectgpt_tpu_torch.ovmer.adapters import _llava_base as base

    adapter, family, kwargs, frames = OVMER_VIDEO[run]
    module = importlib.import_module(f"affectgpt_tpu_torch.ovmer.adapters.{adapter}")
    model, tok = ModelDouble(ovmer_config(family)), TokenizerDouble()
    reads, preps = [], []

    def timed_read(inner):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = inner(*args, **kw)
            reads.append(time.perf_counter() - t0)
            return out
        return wrapped

    def timed_preprocess(inner):
        def wrapped(frames_u8, out_size, device):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(frames_u8, out_size, device)
            torch.cuda.synchronize()
            preps.append((time.perf_counter() - t0, frames_u8, out_size))
            return out
        return wrapped

    save = os.path.join(root, "out", f"result-{run}", "0.npz")
    fn = module.build_model_fn(None, device="cuda", model=model, tokenizer=tok, **kwargs)
    with patched(base, "read_video", timed_read), \
            patched(base, "preprocess_frames", timed_preprocess):
        zero_shot_harness.run_zero_shot("MER2023", fn, save)
    ovmer_saved(run, save)
    if len(model.calls) != 1 or len(preps) != 1 or len(reads) != 1:
        raise AssertionError(f"ovmer {run}: {len(model.calls)} generate calls, {len(reads)} "
                             f"reads, {len(preps)} preprocessings; want 1 each")
    _, call = model.calls[0]
    key = "pixel_values_videos" if "pixel_values_videos" in call else "pixel_values"
    pixels, ids = call[key], call["input_ids"]
    size = OVMER_FAMILIES[family]["image_size"]
    shape = (frames, 3, size, size) if key == "pixel_values" else (1, frames, 3, size, size)
    if tuple(pixels.shape) != shape or pixels.device.type != "cuda" \
            or pixels.dtype != torch.float32 or ids.device.type != "cuda":
        raise AssertionError(f"ovmer {run}: {key} {tuple(pixels.shape)} {pixels.dtype} on "
                             f"{pixels.device}, ids on {ids.device}; want {shape} f32 on cuda")
    _, frames_u8, out_size = preps[0]
    err = float((pixels.reshape(shape[-4:]).cpu()
                 - base.preprocess_frames(frames_u8, out_size, "cpu")).abs().max())
    if adapter == "videollava":
        token, per_frame = "<video>", module.num_video_tokens(model.config) // frames
    elif key == "pixel_values_videos":
        token, per_frame = "<video>", base.video_tokens_per_frame(model)[1]
    else:
        token, per_frame = "<image>", base.image_tokens_per_frame(model)[1]
    image_tokens = int((ids == OVMER_SPECIALS[token]).sum())
    say("ovmer", adapter=run, T=frames, S=size, pixels=key, image_tokens=image_tokens,
        tokens_a_frame=per_frame, read_ms=f"{reads[0] * 1e3:.3f}",
        preprocess_ms=f"{preps[0][0] * 1e3:.3f}",
        read_and_preprocess_ms=f"{(reads[0] + preps[0][0]) * 1e3:.3f}",
        pixel_max_abs_err=f"{err:.3e}", card=repr(card))
    if image_tokens != per_frame * frames or err > OVMER_PIXEL_ATOL:
        raise AssertionError(f"ovmer {run}: {image_tokens} image tokens (want {per_frame} x "
                             f"{frames}), pixels {err:.3e} off the CPU's")


def ovmer_audio(card: str, root: str, subtitle: str, wav_want: np.ndarray) -> None:
    """qwen_audio and salmonn through run_zero_shot on the two-clip root
    with doubles: the 48 kHz stereo wav read as wav_want, the prompts
    built from the clip's subtitle (and SALMONN's from the transcript),
    the features and ids on the card; clip b (no wav) scores ""."""
    import os

    from affectgpt_tpu_torch.ovmer import zero_shot_harness
    from affectgpt_tpu_torch.ovmer.adapters import qwen_audio, salmonn

    tok = TokenizerDouble()
    processor, model = ProcessorDouble(tok), ModelDouble(ovmer_config("llava-1.5"))
    save = os.path.join(root, "out", "result-qwen_audio", "0.npz")
    t0 = time.perf_counter()
    zero_shot_harness.run_zero_shot("MER2023", qwen_audio.build_model_fn(
        None, device="cuda", model=model, processor=processor), save)
    qwen_s = time.perf_counter() - t0
    ovmer_saved("qwen_audio", save)
    (text, audio, rate), = processor.calls
    (_, call), = model.calls
    wav_err = float(np.abs(audio[0] - wav_want).max()) if audio[0].shape == wav_want.shape \
        else float("inf")
    prompt = f"Audio 1: <|AUDIO|>\n{qwen_audio.PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)}"
    devices = {k: v.device.type for k, v in call.items() if isinstance(v, torch.Tensor)}

    whisper, llm = ModelDouble(reply=OVMER_TRANSCRIPT, after_prompt=False), ModelDouble()
    whisper_processor = ProcessorDouble(tok)
    save_s = os.path.join(root, "out", "result-salmonn", "0.npz")
    t0 = time.perf_counter()
    zero_shot_harness.run_zero_shot("MER2023", salmonn.build_model_fn(
        None, None, device="cuda", whisper=whisper, whisper_processor=whisper_processor,
        llm=llm, llm_tokenizer=tok), save_s)
    salmonn_s = time.perf_counter() - t0
    ovmer_saved("salmonn", save_s)
    (feats,), _ = whisper.calls[0]
    (_, llm_call), = llm.calls
    llm_prompt = tok.decode(llm_call["input_ids"][0].tolist())
    llm_want = (f"USER: Speech content of the audio: {OVMER_TRANSCRIPT}. "
                f"{salmonn.PROMPT_WITH_SUBTITLE.format(subtitle=subtitle)}ASSISTANT:")
    salmonn_err = float(np.abs(whisper_processor.calls[0][1][0] - wav_want).max())
    say("ovmer", adapter="qwen_audio", samples=len(audio[0]), rate=rate,
        wav_max_abs_err=f"{wav_err:.3e}", generate_devices=json.dumps(devices),
        run_s=f"{qwen_s:.3f}", card=repr(card))
    say("ovmer", adapter="salmonn", samples=len(whisper_processor.calls[0][1][0]),
        wav_max_abs_err=f"{salmonn_err:.3e}", whisper_features_on=feats.device.type,
        llm_ids_on=llm_call["input_ids"].device.type, run_s=f"{salmonn_s:.3f}", card=repr(card))
    if text != prompt or rate != 16000 or wav_err > OVMER_WAV_ATOL or set(devices.values()) != \
            {"cuda"} or salmonn_err > OVMER_WAV_ATOL or feats.device.type != "cuda" \
            or llm_call["input_ids"].device.type != "cuda" or llm_prompt != llm_want:
        raise AssertionError(f"ovmer audio: prompt {text!r}, rate {rate}, wav {wav_err}, "
                             f"{devices}; salmonn wav {salmonn_err}, {feats.device}, "
                             f"{llm_prompt!r}")


def ovmer_model_error(root: str) -> None:
    """A double whose generate raises RuntimeError must end run_zero_shot
    with it, and no npz is written."""
    import os

    from affectgpt_tpu_torch.ovmer import zero_shot_harness
    from affectgpt_tpu_torch.ovmer.adapters import videochat

    error = RuntimeError("CUDA error: an illegal memory access was encountered (a double)")
    model = ModelDouble(ovmer_config("llava-1.5"), error=error)
    save = os.path.join(root, "out", "result-error", "0.npz")
    fn = videochat.build_model_fn(None, device="cuda", model=model, tokenizer=TokenizerDouble())
    try:
        zero_shot_harness.run_zero_shot("MER2023", fn, save)
    except RuntimeError as raised:
        if raised is not error or os.path.exists(save):
            raise AssertionError(f"ovmer model_error: {raised!r}, npz written "
                                 f"{os.path.exists(save)}") from raised
        return
    raise AssertionError("ovmer model_error: run_zero_shot swallowed the model's RuntimeError")


def ovmer_quality_run(card: str, root: str) -> None:
    """`python -m affectgpt_tpu_torch.scripts.quality_run --synthetic root
    --device cuda` as a subprocess: exit 0, its three answers and the
    judge's openset cache written."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (here, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "affectgpt_tpu_torch.scripts.quality_run",
                           "--synthetic", root, "--device", "cuda"], cwd=here, env=env,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    result = os.path.join(root, "output", "results", "quality_run", "result-mer2023")
    files = sorted(os.listdir(result)) if os.path.isdir(result) else []
    answers = {}
    if "0.npz" in files:
        with np.load(os.path.join(result, "0.npz"), allow_pickle=True) as data:
            answers = data["name2reason"].item()
    score = [line for line in proc.stderr.splitlines() + proc.stdout.splitlines()
             if "BEST" in line]
    steps = [line.split(": ", 1)[1] for line in proc.stdout.splitlines()
             if line.startswith("quality_run: ") and " took " in line]
    say("ovmer", run="quality_run", rc=proc.returncode, files=json.dumps(files),
        answers=len(answers), non_empty=sum(bool(v) for v in answers.values()),
        score=json.dumps(score[-1].split("] ")[-1] if score else None),
        steps=json.dumps(steps), seconds=f"{seconds:.3f}", card=repr(card))
    # the 3B LLM's random weights mostly pick ids past the ByteTokenizer's bytes, which
    # decode to nothing: an answer must be a string, not a non-empty one
    if proc.returncode or "quality_run complete" not in proc.stdout \
            or files != ["0-openset.npz", "0.npz"] or len(answers) != 3 \
            or not all(isinstance(v, str) for v in answers.values()):
        raise AssertionError(f"ovmer quality_run: rc {proc.returncode}, {files}, {answers}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")


def phase_ovmer(card: str, tmp: str) -> dict:
    """Phase 16: the OV-MER adapters on the card through run_zero_shot, the
    wrapped HF models replaced by doubles of their published geometry
    (no HF weights here), then the quality-run recipe. Returns
    the launches of the adapters' runs (all 0: they run no kernel)."""
    import importlib.metadata
    import importlib.util
    import os

    t0 = time.perf_counter()
    root = os.path.join(tmp, "ovmer")
    subtitle, wav_want = write_ovmer_root(root)

    def adapters():
        for run in OVMER_VIDEO:
            ovmer_video(card, run, root)
        ovmer_audio(card, root, subtitle, wav_want)
        ovmer_model_error(root)

    _, launches = counted_call(adapters)
    check_launches("ovmer adapters", launches, {})
    from affectgpt_tpu_torch.data import media

    present = importlib.util.find_spec("transformers") is not None
    say("ovmer", launches=json.dumps(launches),
        transformers=importlib.metadata.version("transformers") if present else "absent",
        hf_models="the wrapped HF models did not run: test doubles of their published "
        "geometry stood in", video_rungs=json.dumps({
            "cv2": media._try_cv2() is not None, "decord": media._try_decord() is not None,
            "ffmpeg": media._ffmpeg_available(),
            "native": media._native_video_reader() is not None}), card=repr(card))
    ovmer_quality_run(card, os.path.join(tmp, "quality_run"))
    say("ovmer", phase_seconds=f"{time.perf_counter() - t0:.3f}", card=repr(card))
    return launches


def recording_generate(record: list):
    """A wrapper of gen.generate that appends each call's tokens to `record`."""
    def make(generate):
        def wrapped(*args, **kwargs):
            out = generate(*args, **kwargs)
            record.append(out[0])
            return out
        return wrapped
    return make


def main() -> None:
    card = phase_device()
    phase_build(card)
    cfg = qwen2.QwenConfig.qwen25_7b()
    kernels = phase_kernels(card, cfg)
    kernels.update(phase_attention_kernels(card, cfg))
    kernels.update(phase_quant_kernels(card, cfg))
    kernels.update(phase_serving_kernels(card, cfg))
    kernels.update(phase_encoder_kernels(card, clip_vit.ClipVisionConfig.vit_l_14(),
                                         hubert.HubertConfig.large()))
    tp_kernels = phase_tp_kernels(card)
    launches, model = phase_main_path(card)
    for name, count in phase_serve(card, model).items():  # the serving slice's kernels
        launches.setdefault(name, count)
    for name, count in phase_realtime(card, model).items():  # the encoder kernels
        launches.setdefault(name, count)
    phase_serving_variants(card, model)
    phase_train(card, model)
    phase_runner(card, model)
    model = (*model[:5], {})  # phase 10 needs no serving tree: free their memory
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="smoke_")  # phase 10's directories, read again in phases 12-15
    try:
        dirs = phase_load(card, model, tmp)
        model = None  # phases 11 and 12 build their own models
        torch.cuda.empty_cache()
        zoo = phase_zoo(card)
        evaluation = phase_eval(card, dirs, os.path.join(tmp, "eval"))
        tp_launches = phase_tp(card, dirs, tmp)
        tp_train_launches = phase_tp_train(card, dirs, tmp)
        torch.cuda.empty_cache()
        toolkit = phase_toolkit(card, dirs, os.path.join(tmp, "toolkit"))
        phase_ovmer(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, err in zoo["max_abs_err"].items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    row13 = kernels["fused_vit_attention"]
    row13["max_abs_err"] = max([row13["max_abs_err"]]
                               + [r["max_abs_err"] for r in zoo["attention"].values()])
    row13["shapes"] = zoo["attention"]
    row13["zoo_launches"] = zoo["launches"]
    for run, counts in evaluation.items():  # rows 1-2 and 11-12 in phase 12
        for name, count in counts.items():
            if count:
                kernels[name].setdefault("eval_launches", {})[run] = count
    for name, shapes in tp_kernels["shapes"].items():  # phase 13 (a) and (b)
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                           tp_kernels["max_abs_err"][name])
        kernels[name]["tp_shapes"] = shapes
    for name, count in tp_launches.items():
        if count:
            kernels[name]["tp_launches"] = count
    for name, count in tp_train_launches.items():  # phase 14's realtime step, rank 0
        if count:
            kernels[name]["tp_train_launches"] = count
    row13["shapes"].update(toolkit["attention"])  # phase 15: VideoMAE's shape
    row13["max_abs_err"] = max([row13["max_abs_err"]] + [r["max_abs_err"] for r in
                                                         toolkit["attention"].values()])
    for run, counts in toolkit["launches"].items():  # rows 1-2 and 11-13 in phase 15
        for name, count in counts.items():
            if count:
                kernels[name].setdefault("toolkit_launches", {})[run] = count
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **KERNELS[name], "launches": launches[name],
         **{key: kernels[name][key] for key in keys},
         **{key: kernels[name][key] for key in ("shapes", "zoo_launches", "eval_launches",
                                                "tp_shapes", "tp_launches", "tp_train_launches",
                                                "toolkit_launches")
            if key in kernels[name]}}
        for name in KERNELS
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
