#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (neko_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Device: exits non-zero unless CUDA is available; prints the card's name
   and power limit, builds the CUDA kernels from neko_tpu_torch/csrc/ with
   nvcc (sm_90a) and prints the build time.
   Prints each attention forward instance's registers and spills (ptxas);
   a spill fails the run.
2. Kernel vs plain: the whole-head attention kernel against its plain torch
   version at the flagship prefill shape (B=8, H=24, S=1024, hd=32, bf16),
   at hd=64 / hd=128 in fp32 and at hd=16 in bf16 (native, the tensor-core
   tile) and fp32 (zero-padded to 32), with both times from CUDA events and
   SDPA's as a yardstick.
3. Serve: a flagship-width model (768d/6L/24 heads, k=1024, full token
   space, bf16, random weights from a seed) behind NekoServer on 127.0.0.1,
   answering greedy and sampled text requests and continuous and image
   (discrete) action requests.  Every prefill of that run must have gone
   through the kernel (its launch counter), and every decode step through
   the decode kernel (layers x decode steps launches).
4. Prefill check, on the greedy batch: each layer's kernel output against
   the plain version on the same served inputs, and the last-position
   logits against a prefill through the plain version on the card.  Planted
   faults in the plain version (controls) show what each check can see.
5. Training kernels vs plain, at the flagship train shape (B=16, H=24,
   S=1024, hd=32, bf16): q, k, v are head-packed strided views of one
   [B, S, 3D] tensor with left-padded bounds, a short row and an empty row.
   At dropout 0 and 0.1: out, dq, dk, dv against autograd through the plain
   version with the same materialized mask, and a planted forward fault
   (the keep byte of the neighbouring 16-column block) that the out check
   must see; the mask kernel against the plain Philox bit for bit (also
   at MASK_EDGES: S 1, 17, 128, 1000 and 2048), and its keep share;
   [B,H,S,hd] at hd 64 and 128 in fp32; the tensor-core forward
   (out and lse) and backward at bf16 hd 16 and 128 (and hd 16 in fp32)
   against the plain versions, the backward on the kernel forward's lse,
   rounding p * keep and ds as the kernels do.  Forward, backward and mask times, kernel and
   plain, from CUDA events in turns, and the forward's and backward's
   TFLOP/s.
6. The flagship train step (neko_tpu_torch.bench's model and batch, random
   weights from the seed): warm-up and timed steps (step ms, tokens/s, MFU,
   peak memory); every loss finite; the launch counters show forward =
   backward = layers x steps, loss head = loss chunks x steps.  One step with the kernels against the same
   step with the plain attention (same seeds, so the same masks; the plain
   attention gets its mask from the mask kernel): loss and every
   parameter's gradient, with planted faults in the plain forward and
   backward that the checks must see.  Then the loss must fall over 20 steps
   on one batch.  The same step check at configs/smoke_offline.sh's width
   (64d / 2 layers / 4 heads: hd 16, k = 128, 8 rows, bf16).
7. Blocked kernels vs plain (long context): the forward (o, m, l) and both
   backward routes (fused; dq + dkv) on head-packed strided views with
   left-padded, short and empty rows, bf16 at dropout 0 and 0.1 at the
   `long` and `long4k` shapes (B=8, S=2048 and B=4, S=4096; H=24, hd=32)
   and at hd 16 and 128, fp32 at hd 16, 64 and 128 and at S=3000; the plain
   versions round p * keep (and ds) to bf16 as the kernels do; a planted
   forward fault (the keep byte of the neighbouring 16-column block) must
   fail the out check at dropout 0.1; the plain versions get their mask
   from the mask kernel, which must equal the plain Philox bit for bit, and
   the plain backward gets the kernel forward's (m, l, delta), so that each
   backward kernel is held on its own inputs.  A fault planted in the plain
   backward (the key tile on each row's diagonal skipped) must fail every
   gradient check.  At S=1024 the blocked kernels agree with the whole-head
   ones at the same seed.  Times in turns (plain, kernel, kernel, plain),
   and SDPA's as a yardstick, at S=2048, 4096 and 8192 with the long
   configs' rows (8, 4, 2), and the two backward routes alone at S=16384
   (B=1): these set blocked_attention.FUSED_MAX.
8. The long train steps: `long` (768d/6L/24h, k=2048, 8 rows, dropout 0.1)
   timed, with launch counts = layers x steps; one step with the kernels
   against the same step with the plain blocked attention, with planted
   faults the checks must see; the loss falls over 20 steps on one batch;
   one timed `long4k` step and one step at k=8192 (the same width, 2 rows;
   not a root bench configuration).
9. Ring kernels vs plain (sequence parallelism, 4 shards): per (q block,
   kv block) pair -- a diagonal pair, a past pair (full square), a pair
   whose kv block holds a row's `start`, a pair wholly before it -- the
   forward partial (acc, m, l) and the dq and dk/dv partials, bf16 at
   S_local=2048 (B=2) and 4096 (B=1), H=24, hd=32, and at hd 16 (a ragged
   S_local) and 128, dropout 0 and 0.1, on a full and a left-padded row;
   fp32 at hd 16, 64 and 128 and at a ragged S_local.  The plain versions
   run on the same values (rounding p * keep and ds to bf16 as the kernels
   do) with the plain Philox window of the pair, and each backward kernel is
   held on the kernel forward's own L and delta.  A planted fault (the
   visiting block's column offset taken as 0) must fail every check, and a
   planted forward fault (the keep byte of the neighbouring 16-column block)
   the acc check at dropout 0.1.  Then the ring as a
   whole at S=8192 against the blocked kernels at the same seed: output and
   the three gradients.  Times in turns at a diagonal and a full pair, with
   SDPA on the pair's shape as a yardstick.
10. The sequence-parallel train steps under `create_mesh(data=1, seq=4)`
   (shards on the one card): timed steps at k=8192 (2 rows) and k=16384
   (1 row) with launch counts = layers x steps x 10 pairs per ring kernel and
   0 for the blocked and whole-head kernels; one k=8192 step through the
   ring against the same step through the blocked path with the same seed,
   with planted faults in the ring schedule that the check must see; the
   loss falls over 20 steps on one batch.
11. Decode attention (#14) vs plain at the flagship decode step (B=8 and
   B=1, H=24, S=1024, hd=32, bf16), a long cache (S=8192 at B=1 and 8),
   fp32 at hd 64 and 128, hd 16 in bf16 and fp32, and a ragged S=1000: rows
   with a full cache, a left-padded start, one key, no key, a wrapped ring;
   the same with holes in the cache mask inside each window; windows on and
   across the edges of the kernel's split (DECODE_SPLIT_SHAPES: shorter
   than the cluster, exactly as long, one key, no key, a start no multiple
   of 4, holes that clear a whole share); its registers and spills per
   instance (ptxas: none may spill); planted faults ("newest key excluded",
   "start ignored", "mask holes ignored", and SPLIT_FAULTS in the plain
   split version) must fail; times in turns at DECODE_TIMED with SDPA
   (boolean mask) as the yardstick and the cluster size each used.
   Then generate_batch at bench_decode.py's shape (B=8, 512-token prompts,
   64 new tokens) through the kernel and through the plain decode
   attention: per-token ms (the package harness's timing loop,
   `neko_tpu_torch.bench_decode.measure`), and the last-step logits of the
   two (teacher-forced on the kernel run's tokens) within a limit a planted
   fault fails.
12. The fused loss head (#15, the train steps' loss forward) at the
   flagship loss chunks ([4096, 768] and [3328, 768] x 52,480, valid vocab
   52,305, bf16) against its plain version in fp32, with planted faults
   (the last one what a wrong swizzle or a dropped tail k-slice gives);
   times and TFLOP/s at both chunks against the route the loss forward ran
   before it (cuBLAS fp32 logits + logsumexp + gather), which it must beat,
   and at the 256-row chunk of the loss without gathered targets at B = 1;
   its registers and spills (ptxas: none may spill) and its HGMMA and
   UTMALDG instructions (cuobjdump -sass: both must be there).
13. Fused AdamW (#16) on the flagship tree with the gradients of a real step
   and moments after two updates, bit for bit against its plain version,
   with planted faults; times against torch's fused AdamW; the optimizer
   half of the step both ways; the flagship train step with
   `fused_adamw=True` (launches = steps); three steps against the default
   AdamW route, and 20 steps of falling loss.
14. The training entry point: `python -m neko_tpu_torch.cli.train` in this
   process (TRAIN_CLI: the flagship width, 16 rows of the synthetic text /
   continuous / image mix, bf16, dropout 0.1): 30 steps with an evaluation
   and a checkpoint every 15.  The per-step losses must fall (the mean of
   the last 10 below the first 10 by LOSS_DROP_MIN; a run at learning rate
   0 must not); the launches are whole-head forward = layers x (steps +
   evaluation prefills), backward = layers x steps, decode = layers x
   decode steps, loss head = loss chunks x steps; the evaluation metrics
   finite under their keys; the Trainer's step time against phase 6's
   flagship step (the bench's batch, `train_step_check`) and its queue
   wait.  A run stopped inside step
   21 (its emergency checkpoint) and resumed to 30 must replay the packed
   arrays of steps 21-30 bit for bit and their losses within
   RESUME_LOSS_TOL, which the resume from a copy without the host-state
   sidecar must exceed; the same with `--fused_adamw` (#16 launches =
   steps) resumed at 10 of 15.  The last checkpoint loads through
   `convert.load_model_dir` and answers /v1/generate and /v1/action.  The
   run's control rows go through the native C packer (`native.calls` > 0).
   Then one continuous-env episode longer than the ring through
   `RolloutSession` on the kernels against the same session on the plain
   prefill and decode attention, teacher-forced (ROLLOUT_*).  The runs write
   under `_smoke_runs/`, removed at the end.
15. The evaluation entry point (EVAL_*): the Trainer at the flagship width
   on a mix of every task kind (16 rows: 4 synthetic text, 4 caption and 2
   VQA rows of 256x256 uint8 images made from the seed, 6 rows of the Text,
   Dict-observation and Dict-action envs), 10 steps ending in an in-loop
   evaluation of all six tasks and a checkpoint; the launches are #1/#3 =
   layers x (steps + evaluation prefills), #4 = layers x steps, #15 = loss
   chunks x steps, #14 = layers x decode steps.  Then `python -m
   neko_tpu_torch.cli.evaluate` in this process on that checkpoint (control
   and text), and the caption and VQA evaluations on the Generator its
   restore helpers build (a task-less restore: the pool sized from the
   checkpoint's image embedder); every `evaluation/...` key present and
   finite, a second CLI run giving the same logs, #1 = layers x prefills and
   #14 = layers x decode steps over it; seconds per evaluation by task, the
   caption group's prefill ms and ms per decode step.  Then the caption and
   VQA groups through generate_batch(targets=) on random weights, kernels
   against plain attention, teacher-forced: prefill logits (LOGIT_TOL),
   decode windows (DECODE_LOGIT_TOL) and the target NLL (EVAL_NLL_TOL),
   with planted prefill and decode faults that must exceed one of them.
16. The serving engine (ENGINE_*), the flagship width in bf16 (and a fp32
   copy for the exact checks), random weights from the seed: eight greedy
   requests submitted to a ContinuousEngine before it starts (admitted in
   one prefill) give generate_batch's tokens on the same 8 prompts; 16
   concurrent /v1/generate requests (8 greedy, 8 sampled; 32-512-token
   prompts, 16-128 new tokens), streamed through
   `NekoServer(continuous_slots=8, continuous_chunk=8)` and then through the
   coalescing server: requests/s, tokens/s, p50 / p99 latency and time to
   first token of each (the coalescing server's first token comes with its
   reply; the load through the serving harness's closed loop,
   `tools.bench_serving.run_load`, one client a request), the greedy
   replies against generate_batch up to the first step
   whose top-two logits lie within DECODE_LOGIT_TOL; a stream against the
   same request's reply; /metrics.  Beams: predict_caption with 4 beams on
   two 256x256 caption prompts, generate_beam kernels vs plain attention
   (fp32 tokens identical; bf16 window logits within DECODE_LOGIT_TOL on
   the steps whose beams agree), ms per beam step.  Speculation on a
   repeated phrase (lookup K = 4; a 2-layer truncated draft): fp32 tokens
   equal generate()'s, bf16 rounds, tokens per round, ms per token against
   plain decode.  The engine's spec rounds then a plain chunk against
   generate_batch in fp32 (ENGINE_FP32_LOGIT_TOL), with the cache-mask
   refresh skipped as a planted fault.  #1 = layers x prefills and #14 =
   layers x decode steps over the main-path runs (`serving_engine_launches`).
17. The train CLI's remaining one-device flags (FEATURES_*), the flagship
   width, random weights from the seed: (a) `python -m
   neko_tpu_torch.cli.train` in this process on synthetic text and the two
   committed HDF5 fixtures (`h5:<path>:<EnvId>` and a bare `.h5`), with
   `--mixed_precision fp16` (bf16), stochastic depth 0.1, remat, GEGLU, EMA
   0.999, gradient accumulation k = 2 and `--profile_dir`: 12 calls (6
   updates), finite losses, the schedule's 6 updates, a Chrome trace of 2
   steps naming the kernels of #3, #4 and #15, #3 = 2 x layers x calls
   (remat recomputes it); a stop after call 7 (inside a window) resumed to
   12 within RESUME_LOSS_TOL, with the planted "accumulator dropped at the
   resume" outside it; `python -m neko_tpu_torch.cli.evaluate --use_ema` on
   the checkpoint, whose text NLL differs from the weights'.  The Trainer's
   step ms at k = 2 and the ms to read one fixture episode.  (b) one
   flagship step (dropout 0.1, stochastic depth 0.1) with remat and
   without, from the same weights, batch and step generator: loss and
   gradients within REMAT_LOSS_TOL / REMAT_GRAD_TOL, the planted "recompute
   from the live generator" outside; #3 12 launches with remat and 6
   without, #4 6 both ways; step ms and peak memory both ways.  (c) three
   steps with `fused_adamw` and EMA against the default route with EMA
   (FUSED_STEP_LOSS_TOL), #16 3 launches, the EMA update's device ms.  (d)
   prefill and decode of a LoRA (a non-zero `lora_b`) + GEGLU model
   through #1 and #14 against plain attention: last-position prefill logits
   within LOGIT_TOL, teacher-forced decode logits within DECODE_LOGIT_TOL,
   with planted faults outside (`train_features_launches`).

18. Training over processes (PARALLEL_*): two ranks on the one card over
   gloo (NCCL refuses two ranks on one card; gloo carries the collectives
   through host memory).  First the kernels on the shapes a rank gives them,
   against their plain versions: #3 / #4 at (data=2)'s 8 rows x 24 heads and
   (model=2)'s 16 rows x 12 heads (timed at the latter), #15 on each rank's
   block of the vocabulary (26,240 columns, 26,240 and 26,065 valid) with
   targets of both blocks, #16 over a rank's shards of the flagship tree
   under (data=2, fsdp), bit for bit.  Then tools/check_torch_parallel_ranks.py
   (one spawn of 2 ranks) at the flagship width cut to RANK_WIDTH's 2 layers
   on the root bench's 16 rows, 3 steps, dropout 0: (data=2), (data=2, fsdp, fused_adamw) and (model=2)
   against the same steps in one process on the whole batch (losses,
   gathered parameters, the clip's global norm: PARALLEL_LOSS_TOL,
   PARALLEL_PARAM_TOL, PARALLEL_NORM_TOL), with the planted "mean of local
   means", "FSDP clip norm from the local shard", "row-parallel all-reduce
   dropped" and "out-of-shard targets clipped" outside them; (model=2) at
   dropout 0.1 keeps the model peers' replicated leaves bit-identical, the
   planted "model peers draw different dropout masks" does not.  Each rank's
   launches: #3 = #4 = layers x steps, #15 = its loss chunks x steps, #16 =
   steps under fused_adamw; step ms, collective ms / bytes / calls per step,
   peak and resting memory per rank.  Then `python -m
   neko_tpu_torch.cli.train --multihost --mesh_model_axis 2` in 2 spawned
   processes given torchrun's environment (2 layers): RANK_CLI_STEPS steps,
   an evaluation on rank 0 (#1, #14) and a checkpoint, which one process
   restores to the parameters the ranks gathered, bit for bit
   (`parallel_launches`).

19. The rest of training over processes: 'seq' over the ranks and the
   pipeline, two ranks on the one card over gloo again (the ring's kv
   blocks and the pipeline's hops go through pinned host buffers: gloo's
   point-to-point takes host memory only).  First the kernels at the
   shapes the ranks give them, against their plain versions: #11-#13 on
   the pairs of 2 'seq' ranks at S_local 4096 (SEQ_RING; the pairs (0, 0),
   (1, 0), (1, 1), timed on the diagonal and the full pair), #3 / #4 on a
   microbatch of 4 rows, #15 on 1F1B's 1,024-row chunk of a microbatch, #16
   over stage 0's leaves, bit for bit.  Then through the tool, 3 steps at
   lr 1e-3 each, against one process (limits PARALLEL_*_TOL["seq"] and
   ["pipe"]): (a) SEQ_RANK_RUNS, seq=2 at k = 8192 (RANK_WIDTH: the flagship
   width at 2 layers, 2 rows, S_local 4096) against the one-device seq=2 mesh, through the
   gathered and the chunked loss and at dropout 0.1, the planted "gradients
   not summed over 'seq'", "boundary target dropped" and "seq peers share a
   mask" outside the limits; ring launches a step rank 0 layers x 1 pair,
   rank 1 layers x 2.  (b) PIPE_RUNS, pipe=2 at the flagship width (6
   layers, 3 a stage) on the root bench's 16 rows:
   GPipe and 1F1B at 4 and 8 microbatches (1F1B also with fused_adamw),
   GPipe against 1F1B at dropout 0.1 (PIPE_SCHEDULE_TOL) and the
   microbatches' own masks, the planted "clip norm from the stage's own
   leaves", "embedding gradient only on stage 0", "mean of microbatch
   means" and "every microbatch shares one mask" seen; the activations a
   stage holds (1F1B's below GPipe's, not growing with the microbatches);
   a stage's resting bytes against the count from the shapes.  Then the
   train CLI over 2 ranks (2 layers) with `--mesh_seq_axis 2` and with
   `--mesh_pipe_axis 2 --pipeline_schedule 1f1b`: RANK_CLI_STEPS steps, rank
   0's evaluation, a checkpoint one process restores bit for bit
   (`seq_ranks_launches`, `pipeline_launches`).
20. Quantized and tensor-parallel serving.  (a) #14's int8 instance (int8
   cache rows, fp32 row scales) against its plain version at B=8 and B=1
   (H=24, S=1024 and 8192, hd=32, bf16 queries; `_decode_rows`' windows,
   an empty one among them, and the split-edge windows of phase 11, a
   third of each window's mask cleared or a whole share), with
   INT8_DECODE_FAULTS and SPLIT_FAULTS planted in the plain version; device
   times in turns at INT8_DECODE_TIMED beside its bound (no library call
   computes it).  (b) generate_batch at
   bench_decode.py's shape with an int8 cache against the native cache:
   the first-step logits equal (the prefill attends full precision), the
   token agreement, the last-step logits teacher-forced on the native
   tokens (INT8_LOGIT_TOL, planted INT8_LOGIT_FAULTS outside it; the int8
   kernel against its plain version within INT8_DECODE_LOGIT_TOL, planted
   INT8_DECODE_LOGIT_FAULTS outside), the cache
   bytes ((hd + 4) / 2hd of bf16), #14-int8 launched on every decode step
   and #14's bf16 instance never.  (c) fp8 weights there against bf16:
   logits, tokens, resting weight bytes (`quantized_bytes`), and against
   the model whose weights are the fp8 ones dequantized once, exactly
   (FP8_PLAIN_TOL; planted "scales over the input dim").  Decode ms a token
   of the three, in turns.  (d) two ranks on the one card over gloo at
   model = 2 (tools/check_torch_serving_ranks.py, one spawn) against one
   process: generate_batch native / int8 / fp8 (every rank's logits the
   same bits, rank 0's first-step logits within TP_LOGIT_TOL, tokens equal
   up to the first near tie, #1 and #14 at 12 heads a rank; the planted
   "scales per shard" outside the limit), the serve CLI with
   `--mesh_model_axis 2` (fp32, fp8 weights, int8 cache: replies through
   the engine and the coalescing path equal one process's server), and the
   evaluation CLI (one text task; rank 0 prints one process's metrics,
   TP_EVAL_TOL).  (`quant_tp_serving_launches`.)
21. Weights in and out.  (a) #3 / #4 at GPT-2 small's heads (B=16, H=12,
   S=1024, hd=64, bf16; `_train_bounds`' left-padded rows, a short row, an
   empty row) against their plain versions at dropout 0 and 0.1 (KERNEL_TOL,
   GRAD_TOL), timed in turns with SDPA beside them; the instances the
   evaluation of (b)'s checkpoint launches, #1 and #14 at hd 64 in bf16,
   against their plain versions (GPT2_PREFILL, GPT2_DECODE_SHAPES:
   KERNEL_TOL, DECODE_FAULTS planted in #14's).  (b) A GPT-2-small
   directory the phase writes (768 / 12 layers / 12 heads, vocab 50257,
   n_positions 1024, fp32 random weights from the seed: config.json and a
   model.safetensors from its own writer, ~0.5 GB, removed at the end):
   `python -m neko_tpu_torch.cli.train --pretrained_lm DIR` on the
   synthetic mix at k = 1024 in bf16 for GPT2_STEPS steps, checkpoints at
   half and at the end: every mapped tensor of the run's initial weights
   equals the file's bits (a mapping written here), the first loss equals
   the loss of a model built here from the file on the same batch
   (PRETRAINED_LOSS_TOL; planted PRETRAINED_FAULT outside it), the loss
   falls, #3 = #4 = 12 x steps and #15 = chunks x steps; the same with
   `--lora`: every base tensor keeps its bits, every adapter moves; the
   checkpoint restored through `cli.evaluate` for the text task (#1 and #14
   at hd 64).  (c) The reference `.pt` round trip at the train CLI's default
   width (768 / 8 layers / 24 heads, with images): a one-step run's
   checkpoint exported by `neko_tpu_torch.tools.export_checkpoint`, one
   step from it with `--init_checkpoint x.pt`: import of the export gives
   the checkpoint's bits back (the padded head rows zeroed), the first loss
   equals the source model's on the same batch (PT_LOSS_TOL; planted
   PT_FAULT outside it).  (d) hd 256 (768 / 3 heads / 6 layers, k = 1024,
   bf16): a train step at dropout 0.1, a prefill and 16 decode steps, all
   finite; the logits teacher-forced against the same model in fp32 on the
   card (WIDE_LOGIT_TOL on the prefill, planted "causal mask dropped" in
   its plain route outside it; WIDE_DECODE_LOGIT_TOL on the decode step,
   WIDE_DECODE_FAULTS planted in the cache mask of the wide decode branch
   outside it); no attention kernel launched for that model.  (e) (b)'s two
   checkpoints averaged by `tools.average_checkpoints` and served by the
   serve CLI's build for one request; `tools.inspect_checkpoint` reports
   the model's parameter count; the `main` of
   `neko_tpu_torch.examples.training` and `examples.inference` (what
   `python -m` runs) runs on the card in this process.  (`weights_io_launches`.)
22. The VQ image tokenizer, the world model and the ring at hd 256: (a)
   the VQ trained 400 steps, its codes against the CPU's fp32 codes
   (VQ_CODE_AGREE_MIN) and the plain convolutions (VQ_OUT_TOL, VQ_FAULTS);
   (b) the world model at the flagship width on its code grids and
   `imagine`'s first frame against plain attention; (c) the ring at hd 256
   over `seq` = 4 against plain attention (WIDE_RING_*).
   (`world_model_launches`.)
23. The serving bench harnesses through their main() at the flagship width
   (HARNESS_RUNS): `neko_tpu_torch.bench_decode` at its shape with the
   native and the int8 cache (launches of #14 = 63 x 6 a timed generation,
   #1 = 6), `tools.bench_spec` (tokens a round within [1, k + 1], lossless
   in bf16; in fp32 the cyclic prompt's speculative tokens equal plain
   greedy's), `tools.bench_serving` (no error, the coalescing worker and the
   engine lossless in bf16, token for token in fp32), `tools.bench_rollout`
   (the share of actions the two modes agree on with the full-context
   prompt; equal actions without eviction); each harness's JSON line on a
   line of its own.  Then the native packer built here against the numpy
   route on the three pure-control variants, bit for bit.
   (`serving_harness_launches`.)

Every train run (phases 6, 8, 10, 13, 14, 15, 17, 18, 19, 21) takes its loss forward through #15:
its launches must be loss chunks x steps (2 a flagship and `long` step, 3 a
`long4k` step), and the plain side of each kernels-vs-plain step check runs
the plain loss forward too.

Prints a JSON line of the kernels that only the checks launch
({"check_kernels": ...}), then one JSON line of the kernels the main path
runs ({"kernels": ...}; launches counted in the serving and train runs
alone, phase 14's among them (`train_cli_launches`), phase 15's training
(`mix_train_launches`) and evaluation (`eval_cli_launches`), phase 16's
(`serving_engine_launches`), phase 17's (`train_features_launches`), phase
18's over both ranks (`parallel_launches`), phase 19's (`seq_ranks_launches`,
`pipeline_launches`), phase 20's over its one-process and two-rank runs
(`quant_tp_serving_launches`; #14's int8 instance as its own entry,
`decode_cache_attention_int8`), phase 21's (`weights_io_launches`), phase
22's (`world_model_launches`), phase 23's (`serving_harness_launches`), each
with its bound
from this run's shapes), then, as the last line,
{"ok": true, "device": {...}}.  Any failed phase exits non-zero.  The
attention entries and the loss head carry `tflops`: the bound's FLOPs over
their ms.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

SEED = 0
FLAGSHIP = dict(embed_dim=768, layers=6, heads=24, context_len=1024,
                max_patches=936, dtype="bfloat16")
# kernel vs plain, on valid rows: |kernel - plain| <= atol + rtol * |plain|
#   bf16: atol 1e-2 plus rtol 2^-7 (one bf16 ulp, relative).  Both outputs
#   are rounded to bf16 (8 significant bits), and both sides round
#   exp(s - m) * keep to bf16 before the value product (as neko_tpu does),
#   from fp32 values computed in other orders: the tensor-core forward per
#   64-key tile against a running max, the plain versions per 512-key tile
#   (blocked, ring) or after normalizing (whole-head).  Outputs reach |x| ~ 4
#   on rows with few keys, where one bf16 ulp is 2^-6 = 1.56e-2 > 1e-2.
#   fp32: atol 1e-5, summation order only.
KERNEL_TOL = {"bfloat16": (1e-2, 2.0 ** -7), "float32": (1e-5, 0.0)}
# Where the two sides' roundings of one term to bf16 fall on either side of
# a rounding boundary, the output moves by one ulp of that term, which on a
# row that sees few keys can exceed KERNEL_TOL.  So in bf16 at most
# FLIP_SHARE (below) of the outputs may exceed KERNEL_TOL and none
# GRAD_TOL["bfloat16"] (`_fwd_excess`).  On an H100 the sound run read 1 of
# 7.7 million flagship train outputs over KERNEL_TOL (3.125e-2 off; the
# blocked plain version, which rounds per tile as the kernel does, none at
# any shape); the planted "keep byte of the neighbouring 16-column block"
# (FWD_FAULT) reads 2.7 to 4.2 over GRAD_TOL["bfloat16"] wherever it is
# checked.
FWD_FAULT = "keep byte of the neighbouring 16-column block"
# prefill logits at the last prompt position, kernel vs plain attention: 6
# bf16 layers deep, every activation rounded to bf16, on logits of std ~0.55
# at this init.  On an H100 the sound run read 2.673e-2 (2.54e-2 with the
# forward's p in fp32) and the faintest planted fault ("diagonal excluded")
# 8.691e-2; the limit lies between.
LOGIT_TOL = 5e-2
# planted faults in the plain attention (controls).  Each layer's check must
# see every one; the logits check those in LOGIT_FAULTS.  "key window
# ignored" cannot move the logits of right-padded prompts: the window only
# differs from the causal mask on rows past the prompt.
FAULTS = ("causal mask dropped", "diagonal excluded", "key window ignored",
          "scale 1/hd")
LOGIT_FAULTS = ("causal mask dropped", "diagonal excluded", "scale 1/hd")
# training (phases 5 and 6)
TRAIN = dict(B=16, H=24, S=1024, hd=32)
RATE = 0.1
# the mask kernel's edges, held bit for bit (B, H, S)
MASK_EDGES = ((2, 3, 1), (2, 3, 17), (3, 4, 128), (2, 3, 1000), (1, 2, 2048))
# gradients, kernel vs autograd through the plain version: sums of up to S
# products of rounded factors, rounded to bf16 once (the plain version also
# rounds p to bf16 before dv): 3e-2 absolute plus two bf16 ulps relative
# (gradients reach |x| ~ 8); fp32: summation order over S keys.
GRAD_TOL = {"bfloat16": (3e-2, 2.0 ** -6), "float32": (5e-5, 1e-4)}
# The flagship backward against autograd through the plain forward also sees
# the forward's roundings of p * keep to bf16 (in delta = rowsum(do * o)),
# which the two sides take in other orders: in bf16 at most FLIP_SHARE of
# the gradients may exceed GRAD_TOL, and none GRAD_FLIP_TOL (`_flip_excess`).
# On an H100 the sound run read 2 of 12.6 million dk values over GRAD_TOL,
# at most 3.91e-2 off (7.0e-3 over it); the planted "keep mask not applied
# in the backward" (STEP_FAULTS) puts 10-14% of every gradient over
# GRAD_TOL and reads 2.39 over GRAD_FLIP_TOL at its faintest (dk);
# GRAD_FLIP_TOL, twice GRAD_TOL, lies between.
GRAD_FLIP_TOL = (6e-2, 2.0 ** -5)
# one train step, kernels vs plain attention: largest relative L2 error of a
# parameter's gradient, and the loss difference.  On an H100 the sound run
# read 1.095e-2 and 1.907e-5 (the forward tile rounds p * keep to bf16, the
# plain attention of this check keeps it fp32; with the tile's p in fp32 the
# loss read 1.049e-5 against a limit of 1.7e-5), the faintest planted
# backward fault ("keep mask not applied in the backward") 0.189, the
# faintest forward fault ("keep mask not applied in the forward") a loss
# difference of 3.052e-5; each limit lies between (the loss one near their
# geometric mean).  At random init the attention is near uniform, so forward
# faults move the loss little.  The forward and the loss are deterministic
# (no atomics), so the sound reading repeats from run to run.
STEP_GRAD_TOL = 5e-2
STEP_LOSS_TOL = 2.4e-5
# configs/smoke_offline.sh's width (hd 16) as a bench shape: its one train
# step, kernels vs plain attention, is held to its own limits (phase 6).  On
# an H100 the sound run read 1.037e-2 and 1.907e-5 with the native hd-16
# forward tile, which rounds p * keep to bf16 (5.33e-3 and 2.86e-6 with hd
# 16 padded to 32 and p in fp32); the faintest planted gradient fault "delta
# taken as 0" 2.337e-2 (the model is small, and so is delta's share of ds),
# the faintest loss fault "scale 1/hd in the forward" 8.583e-5.  The
# gradient limit, set at the geometric mean of the readings of the padded
# forward, still lies between; the loss limit lies near the new geometric
# mean.
SMOKE_WIDTH = dict(embed_dim=64, layers=2, heads=4, batch_per_chip=8, context_len=128)
SMOKE_STEP_GRAD_TOL = 1.1e-2
SMOKE_STEP_LOSS_TOL = 4e-5
STEP_FAULTS = ("keep mask not applied in the backward", "delta taken as 0",
               "dk without sm_scale")
STEP_LOSS_FAULTS = ("keep mask not applied in the forward", "scale 1/hd in the forward",
                    "causal mask dropped in the forward")
# blocked kernels (phases 7 and 8): bf16 check shapes (B, H, S, hd), the
# `long` and `long4k` rows; fp32 shapes at other head dims and a ragged S
# (bf16 also at hd 16 and 128, the tensor-core backward's end widths; fp32
# at hd 16 too, which the wrappers pad to 32)
BLOCKED_BF16 = ((8, 24, 2048, 32), (4, 24, 4096, 32), (2, 8, 2048, 16), (2, 4, 2048, 128))
BLOCKED_FP32 = ((4, 12, 2048, 64), (2, 6, 2048, 128), (3, 8, 3000, 32), (2, 8, 2048, 16))
# timed shapes: the rows of long, long4k and LONG8K (16,384 tokens each);
# beyond them the two backward routes alone, at 16,384 tokens too
BLOCKED_TIMED = ((8, 24, 2048, 32), (4, 24, 4096, 32), (2, 24, 8192, 32))
BLOCKED_ROUTES_ONLY = ((1, 24, 16384, 32),)
# blocked and ring gradients, kernel vs the plain backward on the same bf16
# inputs and the same (m, l, delta): both round p * keep and ds to bf16
# before their products (as neko_tpu does), sum in fp32 and round the
# gradients to bf16 (the ring's partials stay fp32), so the gap is fp32
# summation order (the fused dq's atomics included) and at most one bf16
# ulp of rounding; rtol is one ulp at worst, atol covers the fp32 order on
# values that cancel to ~0.  fp32 as GRAD_TOL.
BLOCKED_GRAD_TOL = {"bfloat16": (1e-4, 2.0 ** -7), "float32": GRAD_TOL["float32"]}
# But in bf16 the two sides round p * keep and ds from fp32 values computed
# in other orders (mma sums and exp2f against torch's), and where one lands
# on the other side of a rounding boundary the two operands differ by one
# bf16 ulp: the gradients that sum it move by one ulp of that term, which on
# rows that see few keys (p near 1) exceeds BLOCKED_GRAD_TOL.  It hits the
# fused and the three-pass dq at the same values (their fp32 ds agree).  So
# in bf16 at most FLIP_SHARE of the values may exceed BLOCKED_GRAD_TOL, and
# none GRAD_TOL["bfloat16"] (`_tile_excess`).  The card tests read up to
# 1.0e-4 of the values over it (16 of 153,600, on unnormalized ring
# probabilities; 1.2e-5 on the blocked tiles), 2.0e-3 at most beyond it;
# every planted fault moves most values.
FLIP_SHARE = 1e-3
# planted in the plain blocked backward of phase 7; every gradient check
# must fail against it
BLOCKED_FAULT = "diagonal key tile skipped in the backward"
# row stats, kernel vs plain on valid rows (atol, rtol): m is a max of fp32
# dot products (summation order only); l sums up to S terms of order 1,
# added in tiles of 32 by the kernel and pairwise by torch
STAT_TOL = {"m": (1e-5, 1e-5), "l": (1e-5, 1e-4)}
# one `long` step, kernels vs plain blocked attention: largest relative L2
# error of a parameter's gradient, and the loss difference.  On an H100 the
# sound run read 9.36e-3 and 1.22e-4 (the loss is a mean over ~7,000 targets
# of bf16-noisy logits); the faintest planted fault in the gradients was
# "running-max rescale alpha dropped" at 6.58e-2 (at random init the
# running max barely moves between key tiles, so its loss moved only
# 2.19e-5, under the sound reading), the only loss fault "key tiles above
# the diagonal included" at 4.48e-3.  Each limit lies near the geometric
# mean of the sound reading and the faintest fault.
LONG_STEP_GRAD_TOL = 2.5e-2
LONG_STEP_LOSS_TOL = 7e-4
LONG_STEP_FAULTS = ("running-max rescale alpha dropped", "delta taken as 0",
                    "keep mask not applied in the backward",
                    "key tiles above the diagonal included")
LONG_STEP_LOSS_FAULTS = ("key tiles above the diagonal included",)
# the k = 8192 step of phase 8: the `long` width at 2 rows, 16,384 tokens a
# step as `long` and `long4k`; the root bench has no k = 8192 configuration
LONG8K = dict(embed_dim=768, layers=6, heads=24, batch_per_chip=2, context_len=8192)
# sequence parallelism (phases 9 and 10): 4 shards; the k = 16384 step is one
# row of 16,384 tokens (S_local = 4096), the case the JAX package wrote its
# ring kernels for; the root bench has neither configuration
SEQ = 4
LONG16K = dict(embed_dim=768, layers=6, heads=24, batch_per_chip=1, context_len=16384)
# ring check shapes (B, H, S_local, hd): bf16 at the two trained shard sizes,
# fp32 at other head dims and a ragged shard (offsets that are no multiple of
# the kernels' 32-key tile)
# (bf16 also at hd 16 on a ragged shard and at hd 128, fp32 at hd 16)
RING_BF16 = ((2, 24, 2048, 32), (1, 24, 4096, 32), (2, 8, 1000, 16), (1, 4, 2048, 128))
RING_FP32 = ((2, 12, 1024, 64), (2, 6, 1024, 128), (3, 8, 1000, 32), (2, 8, 1000, 16))
# (q shard, kv shard) of the checked pairs: diagonal, past with every key
# visible, the kv shard that holds the padded row's `start`, a kv shard wholly
# before it (those rows see no key of the pair)
RING_PAIRS = ((2, 2), (3, 2), (2, 1), (2, 0))
# the forward partial, kernel vs the plain version on the same bf16 values:
# acc is a sum of up to S_local terms exp(s - m) * keep * v that is NOT
# divided by l, so it is held relative to l (1 where l < 1).  Both sides
# round exp(s - m) * keep to bf16, the kernel per 64-key tile and the plain
# version per 512-key tile, against running maxes that differ between the
# tiles: on an H100 the sound run read at most 2.76e-3 of max(l, 1) (rate
# 0.1; 2.05e-3 at rate 0), and FWD_FAULT 0.16 of it at its faintest; the
# bf16 limit lies near their geometric mean.  (The
# bf16 tile used to keep p in fp32, and was held to 5e-6 of l against the
# plain version on the fp32 upcast.)  fp32: summation order, exp2f against
# torch.exp.
RING_ACC_TOL = {"bfloat16": 2e-2, "float32": 5e-6}
# planted in the plain versions of phase 9; every check of a pair off shard 0
# must fail against it
RING_FAULT = "visiting block's column offset taken as 0"
# one k = 8192 step, ring vs blocked kernels at the same seed (the same
# masks): largest relative L2 error of a parameter's gradient, and the loss
# difference.  On an H100 the sound run read 8.77e-3 and 5.05e-5 (both sides
# round out and the gradients to bf16, from sums taken in different orders);
# the faintest planted fault in the gradients was "farthest kv block
# skipped" at 7.69e-2, which is also the only one that moves the loss, by
# 7.63e-4 (a dropped rescale moves it 4.2e-5: at random init the running max
# barely moves between kv blocks).  Each limit lies near the geometric mean
# of the sound reading and the faintest fault.
RING_STEP_GRAD_TOL = 2.5e-2
RING_STEP_LOSS_TOL = 2e-4
RING_STEP_FAULTS = ("running-max rescale dropped in the merge", "farthest kv block skipped",
                    "delta taken as 0", "dk, dv partials added to the q shard's block")
RING_STEP_LOSS_FAULTS = ("farthest kv block skipped",)
# decode attention (phase 11): check shapes (B, H, S, hd, dtype); B=8 and
# B=1 are the flagship decode step, S=8192 the cache of a model trained at
# k = 8192, the rest other head dims and a ragged S
DECODE_SHAPES = ((8, 24, 1024, 32, "bfloat16"), (1, 24, 1024, 32, "bfloat16"),
                 (1, 24, 8192, 32, "bfloat16"), (8, 24, 8192, 32, "bfloat16"),
                 (4, 12, 1024, 64, "float32"), (4, 6, 1024, 128, "float32"),
                 (8, 24, 1000, 32, "bfloat16"), (8, 8, 1024, 16, "bfloat16"),
                 (8, 8, 1024, 16, "float32"))
# the split-edge windows (`_split_edge_rows`) at shapes whose cluster holds
# 8, 4 and 2 blocks on an H100 (B * H = 12, 48, 96), each hd and dtype class
DECODE_SPLIT_SHAPES = ((12, 1, 1024, 32, "bfloat16"), (12, 4, 1024, 128, "float32"),
                       (12, 8, 2048, 16, "bfloat16"), (12, 4, 1000, 64, "float32"))
# planted in the plain split version (`split_decode`): the check of the
# shapes split over 2 or more blocks must see each one
SPLIT_FAULTS = ("one share of the window dropped", "shares merged without the max rescale")
# timed in turns (phase 11): the flagship decode step at B=8 and B=1, a
# cache of k = 8192 at B=1 and 8, GPT-2 small's heads (phase 21)
DECODE_TIMED = ((8, 24, 1024, 32), (1, 24, 1024, 32), (1, 24, 8192, 32), (8, 24, 8192, 32),
                (8, 12, 1024, 64))
# the same check with holes in the cache mask inside each row's window
# (rows a left-padded prompt or an eviction clears): the kernel skips them
DECODE_HOLED_SHAPES = ((8, 24, 1024, 32, "bfloat16"), (8, 8, 1024, 16, "bfloat16"))
# planted in the plain decode attention; the kernel check of the B=8 shapes
# must see each one ("mask holes ignored" on the holed shapes), the logits
# check DECODE_LOGIT_FAULTS ("start ignored" cannot move the logits of
# right-padded prompts, whose windows start at 0, nor "mask holes ignored"
# their masks, which have no holes)
DECODE_FAULTS = ("newest key excluded", "start ignored", "mask holes ignored")
DECODE_LOGIT_FAULTS = ("newest key excluded",)
# bench_decode.py's shape: 8 text prompts of 512 tokens, 64 new tokens
DECODE_BENCH = dict(B=8, prompt=512, new=64)
# last-step logits after 63 teacher-forced decode steps, kernel vs plain
# decode attention at the bench_decode shape: 6 bf16 layers, every
# activation rounded to bf16, the cache rows of the generated tokens written
# from either side's own outputs.  On an H100 the sound run read 2.34e-2 and
# the planted "newest key excluded" 5.47e-2; the limit lies near their
# geometric mean.
DECODE_LOGIT_TOL = 3.5e-2
# fused loss head (phase 12): logz and the target logit, kernel vs the plain
# version in fp32 on the same bf16 operands: fp32 sums of the same exact
# products, in another order, and exp through ex2.approx (logz ~ 11, target
# logits ~ 0.5).  "last 64-deep slice of D dropped" is what a TMA box or a
# wgmma descriptor that misses the tail of D (or a swizzle that scrambles a
# slice) would give.
LOSS_TOL = (1e-4, 1e-5)
LOSS_FAULTS = ("padded columns not masked", "target column off by one",
               "last 64-deep slice of D dropped")
# fused AdamW (phase 13): kernel vs plain, |kernel - plain| <= 1e-6 * |plain|
# on params, mu and nu (both round after every operation in one order)
ADAMW_RTOL = 1e-6
ADAMW_FAULTS = ("bias correction dropped", "clip scale ignored")
# three flagship steps on one batch at lr 1e-3, FusedAdamW vs the clip pass +
# torch's AdamW (optax's formula vs torch's, rounded in other orders): the
# largest loss difference, and the relative L2 error of the whole tree's
# update (p after 3 steps - p before).  Per parameter the routes cannot be
# held: the gradient of the key bias is 0 but for rounding (the softmax does
# not see it), and Adam turns that rounding into +-lr steps.  A planted
# "bias correction dropped" in the fused route must fail both.
# On an H100 the sound run read 4.10e-5 and 1.89e-3 (the default route
# against itself: 0 and 0), the fault 0.321 and 0.475; each limit lies near
# the geometric mean.
FUSED_STEP_LOSS_TOL = 3e-3
FUSED_STEP_UPDATE_TOL = 2.5e-2
# the training entry point (phase 14): `python -m neko_tpu_torch.cli.train` at
# the flagship width on the root bench's mix (6 text, 5 continuous, 5 image
# rows of 16), random weights from the seed.  Not the defaults: warmup 5 and
# lr 5e-4, so that the loss moves within the run.
TRAIN_CLI = ["--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
             "--text_prop", "0.375", "--control_datasets", "neko-synth-continuous-v0",
             "neko-synth-image-v0", "--embed_dim", "768", "--layers", "6", "--heads", "24",
             "-k", "1024", "--batch_size", "16", "--mixed_precision", "bf16", "--dropout", "0.1",
             "--learning_rate", "5e-4", "--warmup_steps", "5", "--seed", str(SEED),
             "--eval_episodes", "2", "--eval_text_num_examples", "4", "--save_model",
             "--save_mode", "checkpoint"]
TRAIN_STEPS, TRAIN_EVAL_FREQ, TRAIN_STOP = 30, 15, 20
FUSED_STEPS, FUSED_EVAL_FREQ, FUSED_STOP = 15, 5, 10
# the mean loss of the first 10 steps less that of the last 10 must exceed
# this; the planted "learning rate 0" must not
LOSS_DROP_MIN = 1.0
# per-step losses of a resumed run against the uninterrupted one (same
# weights, optimizer state, batches and dropout masks; only the order of
# atomic sums may differ); the planted "sidecar deleted" (the stream
# restarts from the seed) must exceed it
RESUME_LOSS_TOL = 1e-3
# the rollout check (phase 14): one continuous-env episode longer than its
# 93-timestep ring at k = 1024, kernels vs plain attention, teacher-forced,
# on random weights from the seed (logit std ~0.55, as in phases 4 and 11;
# trained logits reach |x| > 4, where one bf16 ulp is 3.1e-2); the prompt's
# prefill logits at its last position (what phase 4 reads) and the first
# action token's logits (after the extend) held to LOGIT_TOL, the later ones
# (after decode steps) to DECODE_LOGIT_TOL; planted faults in the plain
# prefill and decode attention must exceed them.  The action logits alone
# read a prefill fault only through the prompt's cached keys and values.
# On an H100 80GB HBM3 at 700 W the sound run read 2.344e-2 / 1.953e-2 /
# 2.148e-2 (prefill / after the extend / after decode steps) and the
# faintest prefill fault, "diagonal excluded", 6.445e-2 on the prefill
# logits (4.297e-2 / 3.900e-2 on the action logits); on trained weights
# "scale 1/hd" read 3.125e-2 on the action logits, as the sound run did.
ROLLOUT_STEPS = 120
ROLLOUT_PREFILL_FAULTS = LOGIT_FAULTS
ROLLOUT_DECODE_FAULTS = ("scale 1/hd",)
# the evaluation entry point (phase 15): the Trainer at the flagship width on
# a mix of every task kind the evaluation CLI reads -- synthetic text, the
# Text / Dict-observation / Dict-action envs, caption and VQA rows of
# 256x256 uint8 images from the seed (in memory: no Pillow on the card) --
# then `python -m neko_tpu_torch.cli.evaluate` on its checkpoint, and the
# caption and VQA evaluations on the Generator the CLI's restore helpers build
EVAL_ENVS = ["neko-synth-text-v0", "neko-synth-dict-v0", "neko-synth-dictact-v0"]
EVAL_STEPS, EVAL_EVAL_FREQ, EVAL_IMAGE, EVAL_GROUP = 10, 5, 256, 8
EVAL_MIX = ["--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
            "--control_datasets", *EVAL_ENVS, "--text_prop", "0.25", "--caption_prop", "0.25",
            "--vqa_prop", "0.125", "--embed_dim", "768", "--layers", "6", "--heads", "24",
            "-k", "1024", "--batch_size", "16", "--mixed_precision", "bf16", "--dropout", "0.1",
            "--learning_rate", "5e-4", "--warmup_steps", "5", "--seed", str(SEED),
            "--training_steps", str(EVAL_STEPS), "--log_eval_freq", str(EVAL_EVAL_FREQ),
            "--eval_episodes", "2", "--eval_text_num_examples", "4",
            "--eval_caption_num_examples", str(EVAL_GROUP), "--eval_vqa_num_examples",
            str(EVAL_GROUP), "--save_model", "--save_mode", "last"]
# the caption / VQA prompts (one group of 8 each: 256 patches, + the question)
# through generate_batch(targets=), kernels vs plain attention, teacher-forced
# on the kernel run's tokens, on random weights from the seed (where phase
# 4's limits were set): the prefill logits at each prompt's last position to
# LOGIT_TOL, the decode windows after decode steps to DECODE_LOGIT_TOL, and
# the per-target NLL to EVAL_NLL_TOL.  Planted faults in the plain prefill
# and decode attention must exceed one of them.  On an H100 80GB HBM3 at
# 700 W the sound run read 2.344e-2 / 2.344e-2 / 1.370e-2 (prefill / decode /
# NLL) and the faintest planted fault, "decode: newest key excluded", 2.344e-2
# / 3.125e-2 / 2.153e-2: under the two logit limits, so the NLL limit lies
# between 1.370e-2 and 2.153e-2, near their geometric mean ("prefill:
# diagonal excluded" read 4.297e-2 / 4.590e-2 / 2.538e-2).
EVAL_NLL_TOL = 1.8e-2
EVAL_PREFILL_FAULTS = LOGIT_FAULTS
EVAL_DECODE_FAULTS = ("newest key excluded", "scale 1/hd")
# the serving engine (phase 16) at the flagship width, random weights from
# the seed: 16 concurrent /v1/generate requests (8 greedy, 8 sampled at
# temperature 0.8 / top-p 0.9; text prompts of 32-512 tokens; 16-128 new
# tokens) through the continuous engine (8 slots, 8-token chunks) and
# through the coalescing server; beams (4) on 2 caption prompts of 256x256
# uint8 images; prompt-lookup (K = 4) and truncated-draft (2 layers)
# speculation on a 16-token phrase repeated to 256 tokens
ENGINE = dict(slots=8, chunk=8, requests=16, prompt=(32, 512), new=(16, 128))
ENGINE_BEAMS, ENGINE_BEAM_STEPS, ENGINE_IMAGE = 4, 32, 256
ENGINE_SPEC = dict(K=4, new=64, phrase=16, repeats=16, draft_layers=2)
# fp32 logits after spec rounds and a plain chunk, the engine against
# generate_batch on the same tokens: both sides compute the same fp32 sums,
# the rounds' attention in plain torch (extend) and the decode steps' in
# #14, in other orders.  The planted "cache-mask refresh skipped" leaves
# holes where the accepted tokens lie, which the decode steps then skip.
ENGINE_FP32_LOGIT_TOL = 1e-3
# the train CLI's remaining one-device flags (phase 17): the flagship width on
# synthetic text and the committed HDF5 fixtures, one of each name form
FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures"
FEATURES_CLI = [
    "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic", "--text_prop", "0.375",
    "--control_datasets",
    f"h5:{FIXTURES}/neko-synth-continuous-v0.h5:neko-synth-continuous-v0",
    f"{FIXTURES}/neko-synth-dict-v0.h5",
    "--embed_dim", "768", "--layers", "6", "--heads", "24", "-k", "1024", "--batch_size", "16",
    "--mixed_precision", "fp16", "--dropout", "0.1", "--stochastic_depth", "0.1", "--remat",
    "--activation_fn", "geglu", "--ema_decay", "0.999", "--gradient_accumulation_steps", "2",
    "--learning_rate", "5e-4", "--warmup_steps", "2", "--seed", str(SEED),
    "--eval_episodes", "0", "--eval_text_num_examples", "0", "--save_model",
    "--save_mode", "last", "--profile_steps", "2"]
FEATURES_CALLS, FEATURES_EVAL_FREQ, FEATURES_STOP, FEATURES_K = 12, 6, 7, 2
# text examples `cli.evaluate` scores (target NLL) with and without --use_ema
FEATURES_EVAL_TEXT = 8
# the planted fault of the resume check: the window's accumulator and
# mini-step lost at the restore (the update then lands a call late); its
# losses must leave RESUME_LOSS_TOL
FEATURES_RESUME_FAULT = "accumulator dropped at the resume"
# (b) one flagship step with remat against the same step without, from the
# same weights, batch and step generator (dropout 0.1, stochastic depth
# 0.1): the loss difference and the largest relative L2 error of a
# parameter's gradient.  The forward runs the same kernels on the same
# inputs, and the recompute replays the generator: the loss is the same
# value, and the gradients are too but for the order of atomic sums in the
# backward (the same step without remat, run twice, shows that gap).  On an
# H100 80GB HBM3 at 700 W the sound run read a loss difference of 0 and a
# gradient error of 5.351e-10; the planted "recompute from the live
# generator" (other dropout and drop-path masks in the backward) 0.810.
# REMAT_GRAD_TOL lies near their geometric mean.
REMAT_LOSS_TOL = 0.0
REMAT_GRAD_TOL = 2e-5
REMAT_FAULT = "recompute from the live generator"
# (c) steps of the fused AdamW route with EMA against the default route with
# EMA, on one batch at lr 1e-3 (FUSED_STEP_LOSS_TOL, phase 13's limit)
FEATURES_FUSED_STEPS = 3
# (d) LoRA (rank 8, alpha 32, lora_b drawn N(0, LORA_B_STD)) and GEGLU at the
# flagship width: 4 text prompts of 256 tokens, 16 new tokens; LOGIT_TOL and
# DECODE_LOGIT_TOL hold the logits, and each planted fault below (in the
# plain prefill / decode attention) must exceed its limit
LORA_SERVE = dict(lora_r=8, lora_alpha=32, activation_fn="geglu", B=4, prompt=256, new=16)
LORA_B_STD = 0.02
LORA_PREFILL_FAULTS = LOGIT_FAULTS
LORA_DECODE_FAULTS = EVAL_DECODE_FAULTS
# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 989e12, 3.35e12
# phase 18: training over processes, two ranks on the one card over gloo
# (NCCL refuses two ranks on one card; gloo carries the collectives of CUDA
# tensors through host memory), through
# tools/check_torch_parallel_ranks.py: the flagship width, the root bench's
# 16 rows (the two data halves hold different numbers of loss targets), bf16
# over fp32, 3 steps at lr 1e-3 from the first step, dropout 0, against the
# same steps in one process on the whole batch.  The limits, by the axis a
# configuration splits: the losses' largest relative difference, the
# relative L2 error of the whole tree's update (gathered from the ranks),
# the clip's global gradient norms' largest relative difference (Adam's
# update does not move with a gradient scale that is steady over the
# steps, so a wrong clip norm shows first in the norm itself).  Each lies
# between its sound reading and the faults it must see (my chip runs, PR
# 13, NVIDIA H100 80GB HBM3, 700.00 W; the readings repeat to the last
# digit run to run).  Sound: (data=2) / (data=2, fsdp, fused_adamw) loss
# 4.282e-6 / 5.067e-5, update 8.327e-3 / 8.346e-3, norm 5.497e-4 /
# 4.794e-4; (model=2) 6.466e-4, 3.755e-2, 5.778e-3.  The ranks' gradients
# differ from one process's by 2.3e-3 (data=2) and 6.4e-3 (model=2)
# relative at the first step (per-leaf median), bf16 rounding in other
# orders and shapes (each rank's weight gradient is rounded to bf16 before
# the fp32 sum over 'data'; other GEMM shapes sum in other orders); Adam
# turns the near-zero ones into sign flips.  Faults: "mean of local means"
# 9.977e-4, 6.329e-2, 3.801e-3; "FSDP clip norm from the local shard"
# 8.217e-4, 1.362e-2, 2.508e-1; "row-parallel all-reduce dropped" 7.114e-2,
# 1.171, 1.975; "out-of-shard targets clipped" 0.9508, 1.117, 32.38.  (With the
# evaluation loss after the steps added to the loss error, (data=2) then
# reads 8.262e-6, the rest as before; measured on one H100.)
PARALLEL_STEPS = 3
PARALLEL_RUNS = (
    dict(data=2), dict(data=2, fault="mean of local means"),
    dict(data=2, fsdp=True, fused_adamw=True),
    dict(data=2, fsdp=True, fused_adamw=True, fault="FSDP clip norm from the local shard"),
    dict(model=2), dict(model=2, fault="row-parallel all-reduce dropped"),
    dict(model=2, fault="out-of-shard targets clipped"),
    dict(model=2, dropout=0.1),
    dict(model=2, dropout=0.1, fault="model peers draw different dropout masks"))
PARALLEL_LOSS_TOL = {"data": 2.5e-4, "model": 5e-3}
PARALLEL_PARAM_TOL = {"data": 2.5e-2, "model": 0.2}
PARALLEL_NORM_TOL = {"data": 1.5e-3, "model": 5e-2}
# dropout 0.1 under model=2: the peers' own gradients of a leaf replicated
# over 'model', before the sync averages them, differ by the order of sums
# alone (relative to the leaf's largest gradient; sound 1.84e-7 / 2.00e-7),
# the planted "model peers draw different dropout masks" by 0.485
PARALLEL_PEER_TOL = 1e-4
# the per-rank kernel shapes: #3 / #4 at (data=2) and at (model=2); #15 on
# each rank's block of the vocabulary (52,480 / 2 columns, 52,305 valid)
PARALLEL_ATTN = ((8, 24), (16, 12))
# phases 18 and 19 (a) run their rank configurations at RANK_WIDTH, the
# flagship width cut to 2 layers in the tool (the run's time limit leaves
# room for no more: over gloo a step's collectives and hops go through host
# memory, layer by layer), and the train CLI over 2 ranks (phases 18, 19;
# --mesh_model_axis 2 here) at 2 layers: RANK_CLI_STEPS steps, an evaluation
# and a checkpoint at the last step, restored in one process.  At 2 layers
# every planted fault of PARALLEL_RUNS and SEQ_RANK_RUNS still exceeds a
# limit (the faintest: "boundary target dropped", param_err 2.667e-2
# against 0.018), and every sound run lies within them (NVIDIA H100 80GB
# HBM3, 700.00 W).  The pipeline's configurations stay at 6 layers: 2 would
# not shorten them.
RANK_WIDTH = "flagship2"
RANK_CLI_STEPS = 4
RANK_CLI = [a if prev != "--layers" else "2" for prev, a in zip([None] + TRAIN_CLI, TRAIN_CLI)]
RANK_CLI += ["--training_steps", str(RANK_CLI_STEPS), "--log_eval_freq", str(RANK_CLI_STEPS)]
PARALLEL_CLI = RANK_CLI + ["--mesh_model_axis", "2"]
# phase 19: the rest of training over processes, two ranks on the one card
# over gloo again (kv blocks and pipeline hops through pinned host buffers,
# gloo's point-to-point taking host memory only), bf16 over fp32, 3 steps
# at lr 1e-3 from the first step, against the same steps in one process.
# (a) 'seq' over the ranks at k = 8192 (S_local 4096), the flagship width at
# 2 rows (LONG8K), against one process under the one-device seq=2 mesh: at
# dropout 0 through the gathered and the chunked loss, at dropout 0.1 (the
# one-device shards draw the ranks' masks at one seed); planted: "gradients
# not summed over 'seq'", "boundary target dropped" (chunked), "seq peers
# share a mask" (dropout).  (b) 'pipe' over the ranks, the root bench's 16
# rows at k = 1024: GPipe and 1F1B at 4 microbatches (1F1B also under
# fused_adamw) and at 8 (peak memory), each against one process; both at
# dropout 0.1 against each other; planted: "clip norm from the stage's own
# leaves", "embedding gradient only on stage 0", "mean of microbatch
# means", "every microbatch shares one mask".
SEQ_RANK = dict(seq=2, k=8192, rows=2)
SEQ_RANK_RUNS = (SEQ_RANK, dict(SEQ_RANK, loss="chunked"), dict(SEQ_RANK, dropout=0.1),
                 dict(SEQ_RANK, fault="gradients not summed over 'seq'"),
                 dict(SEQ_RANK, loss="chunked", fault="boundary target dropped"),
                 dict(SEQ_RANK, dropout=0.1, fault="seq peers share a mask"))
PIPE = dict(pipe=2, micro=4)
PIPE_RUNS = (PIPE, dict(PIPE, schedule="1f1b"), dict(PIPE, schedule="1f1b", fused_adamw=True),
             dict(PIPE, micro=8), dict(PIPE, micro=8, schedule="1f1b"),
             dict(PIPE, dropout=0.1), dict(PIPE, schedule="1f1b", dropout=0.1),
             dict(PIPE, schedule="1f1b", fault="clip norm from the stage's own leaves"),
             dict(PIPE, fault="embedding gradient only on stage 0"),
             dict(PIPE, schedule="1f1b", fault="mean of microbatch means"),
             dict(PIPE, schedule="1f1b", dropout=0.1, fault="every microbatch shares one mask"))
# The limits (loss, update, norm as phase 18's; the loss error includes the
# evaluation loss after the steps), each near the geometric mean of its
# sound reading and the faintest fault it sees (measured on NVIDIA
# H100 80GB HBM3, 700.00 W; the readings repeat to the last digit).  seq:
# sound at most 1.350e-4 / 8.765e-3 / 2.562e-3 (the chunked loss; the
# gathered 3.082e-5 / 8.093e-3 / 1.091e-3), "boundary target dropped"
# 6.880e-4 / 3.904e-2 / 1.812e-2, "seq peers share a mask" 5.117e-2 /
# 0.7594 / 0.5940, "gradients not summed over 'seq'" 3.091e-2 / 0.7047 /
# 0.4674.  pipe: sound at most 4.278e-4 / 2.528e-2 / 2.137e-3 (1F1B: its
# loss and head gradient come in 4-row microbatch chunks, each weight
# gradient rounded to bf16 per chunk before the fp32 sum; GPipe x 4
# 1.019e-5 / 1.034e-2 / 3.075e-4), "clip norm from the stage's own leaves"
# 1.755e-3 / 4.142e-2 / 9.157e-2, "embedding gradient only on stage 0"
# 3.687e-4 / 1.051e-2 / 9.792e-3 (and the replicas 3.0e-3 apart), "mean of
# microbatch means" 2.563e-3 / 0.3370 / 7.502e-2.
PARALLEL_LOSS_TOL.update(seq=3e-4, pipe=8.5e-4)
PARALLEL_PARAM_TOL.update(seq=1.8e-2, pipe=3.2e-2)
PARALLEL_NORM_TOL.update(seq=6.5e-3, pipe=4.5e-3)
# GPipe against 1F1B at dropout 0.1 (the same masks): the losses' largest
# relative difference (1F1B's loss is the chunked route's per microbatch,
# GPipe's the gathered route's over the batch: other bf16 roundings); sound
# 1.089e-4 (measured on one H100); "every microbatch shares one mask" is seen
# by the microbatches' own check (share 1.0 against 0.0152-0.0158 sound)
PIPE_SCHEDULE_TOL = 1e-3
# the shapes phase 19 gives the kernels: the ring's pairs over 2 'seq' ranks
# at S_local 4096 (rank 0 computes (0, 0), rank 1 (1, 0) and (1, 1)); #3 /
# #4 on a microbatch of 4 rows; #15 on 1F1B's chunk of a microbatch (4 rows
# x 256 columns)
SEQ_RING = (2, 24, 4096, 32)
PIPE_ATTN = ((4, 24),)
PIPE_LOSS_ROWS = 4 * 256
SEQ_RANK_CLI = RANK_CLI + ["--mesh_seq_axis", "2"]
PIPE_CLI = RANK_CLI + ["--mesh_pipe_axis", "2", "--pipeline_schedule", "1f1b"]
# phase 20: quantized and tensor-parallel serving.  (a) #14's int8 path
# against its plain version at the flagship decode shapes (bf16 queries,
# int8 rows with fp32 row scales; `_decode_rows`' windows, a third of each
# window's mask cleared), planted faults in the plain version that the
# check must see.  (b) an int8 cache at bench_decode.py's shape against the
# native cache; (c) fp8 weights there against bf16.  (d) two ranks on the
# one card over gloo at model = 2 (12 heads a rank) against one process:
# generate_batch native / int8 / fp8 (and the planted "scales per shard"),
# the serve CLI (coalescing and the engine) and the evaluation CLI.
INT8_DECODE_SHAPES = ((8, 24, 1024, 32), (1, 24, 1024, 32), (1, 24, 8192, 32),
                      (8, 24, 8192, 32))
INT8_DECODE_SPLIT_SHAPES = ((12, 1, 1024, 32), (12, 4, 1000, 16), (12, 8, 1024, 64))
INT8_DECODE_TIMED = ((8, 24, 1024, 32), (1, 24, 1024, 32), (1, 24, 8192, 32))
INT8_DECODE_FAULTS = ("key scales ignored", "value scales ignored", "mask holes ignored")
# (b) the teacher-forced last-step logits of the int8 cache against the
# native one (the int8 rows' rounding, on random weights), and the tokens
# the two greedy runs share; the planted INT8_LOGIT_FAULTS in the model's
# int8 decode must leave INT8_LOGIT_TOL.  Near the geometric mean of the
# sound 3.125e-2 and the faintest fault's 2.539 (NVIDIA H100 80GB HBM3,
# 700.00 W; logit std 0.556)
INT8_LOGIT_TOL = 0.25
INT8_LOGIT_FAULTS = ("key scales ignored", "value scales ignored")
# the model's int8 decode through the kernel against its plain version (the
# int8 instance keeps p * v_scale in fp32, the plain one rounds it to bf16),
# last-step logits after 63 teacher-forced steps: sound 2.344e-2 / 2.585e-2
# on two runs, the planted "newest key excluded" 5.859e-2 (NVIDIA H100 80GB
# HBM3, 700.00 W); the limit near the geometric mean of the larger two
INT8_DECODE_LOGIT_TOL = 3.9e-2
INT8_DECODE_LOGIT_FAULTS = ("newest key excluded",)
# (c) fp8 weights: the model's logits against the same model whose weights
# are the dequantized fp8 ones (bf16, materialized: the plain version of
# the point-of-use dequantize), exact; planted "scales over the input dim".
# Beside it the fp8 bytes and scales (and the int8 cache rows and scales)
# quantized on the card equal the CPU's (neko_tpu's) bit for bit
FP8_PLAIN_TOL = 0.0
TP_SERVE = dict(B=4, prompt=128, new=16)
# (d) rank 0's first-step window logits against one process's (bf16: the
# row-parallel sums in fp32 on each rank, then one all-reduce, against one
# process's one product), near the geometric mean of the sound 2.344e-2
# (fp8; native 1.953e-2) and the planted "scales per shard"'s 0.1445 (NVIDIA
# H100 80GB HBM3, 700.00 W); tokens equal up to the first near tie
# (DECODE_LOGIT_TOL)
TP_LOGIT_TOL = 0.06
TP_CLI = ["--random_init", "--seed", str(0), "--embed_dim", "768", "--layers", "6",
          "--heads", "24", "--context_len", "1024", "--max_patches", "0", "--dtype", "float32",
          "--continuous_slots", "4", "--continuous_chunk", "8", "--kv_cache_dtype", "int8",
          "--serve_weight_dtype", "fp8"]
TP_EVAL_TOL = 1e-4
# phase 21: weights in and out.  (a) #3 / #4 at GPT-2 small's heads, 12 of
# hd 64, B=16, S=1024, bf16, held as phase 5 holds them (KERNEL_TOL,
# GRAD_TOL with GRAD_FLIP_TOL) at dropout 0 and RATE
GPT2_ATTN = ((16, 12),)
GPT2_HD = 64
# and the instances the evaluation of a pretrained checkpoint launches, at
# hd 64 in bf16, held as phases 1 and 11 hold theirs: #1 (the prefill
# wrapper) at B=8 over phase 1's windows (KERNEL_TOL), #14 over
# `_decode_rows`' windows, with and without holes in the cache mask
# (KERNEL_TOL; DECODE_FAULTS planted)
GPT2_PREFILL = dict(B=8, H=12, S=1024, starts=[0] * 7 + [100],
                    ends=[1024, 700, 1, 1024, 513, 1, 1024, 1024])
GPT2_DECODE_SHAPES = ((8, 12, 1024, 64, "bfloat16"),)
# (b) the GPT-2-small directory the phase writes: GPT-2 small's widths and
# fp32 weights from the seed, the embeddings N(0, 0.02), every other matrix
# N(0, GPT2_STD) (so that each layer moves the loss), the norms'
# weights 1 + N(0, 0.1), the biases N(0, 0.02)
GPT2_SMALL = dict(n_embd=768, n_layer=12, n_head=12, vocab_size=50257, n_positions=1024)
GPT2_STD = 0.05
GPT2_STEPS = 6
MIX_CLI = ["--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
           "--text_prop", "0.375", "--control_datasets", "neko-synth-continuous-v0",
           "neko-synth-image-v0", "-k", "1024", "--batch_size", "16", "--mixed_precision",
           "bf16", "--dropout", "0.1", "--seed", str(SEED), "--eval_episodes", "0",
           "--eval_text_num_examples", "0"]
GPT2_CLI = MIX_CLI + ["--learning_rate", "1e-3", "--warmup_steps", "1", "--training_steps",
                      str(GPT2_STEPS), "--log_eval_freq", str(GPT2_STEPS // 2)]
# the first loss of the --pretrained_lm run against that of a model built
# here from the file (a mapping of this script's own) on the same batch,
# with the same kernels and dropout draws: |a - b| <= PRETRAINED_LOSS_TOL
# (predicted 0); the planted fault, the square attn.c_proj of every layer
# left in HF's [in, out] layout, must exceed it
PRETRAINED_LOSS_TOL = 1e-4
PRETRAINED_FAULT = "attn.c_proj taken untransposed"
# (c) the first loss of a run from the exported .pt against the source
# model's on the same batch (the padded head rows, which the import zeroes,
# are masked out of the loss: predicted 0); the planted fault, the image
# projection's input dim left in the reference's (c, p1, p2) order, must
# exceed it
PT_LOSS_TOL = 1e-4
PT_FAULT = "projection's input dim left in (c, p1, p2) order"
# (d) hd 256: 768d / 3 heads / 6 layers at k = 1024, random weights from the
# seed; the bf16 model's logits (every valid prefill position, and the last
# of 16 teacher-forced decode steps) against the same weights in fp32 on
# the card: |bf16 - fp32| <= WIDE_LOGIT_TOL in the prefill, where the
# planted "causal mask dropped" in the bf16 model's plain route must exceed
# it, and <= WIDE_DECODE_LOGIT_TOL in the decode step, where each of
# WIDE_DECODE_FAULTS, planted in the cache mask the wide decode branch
# attends over, must exceed it.  On an H100 (NVIDIA H100 80GB HBM3,
# 700.00 W) the sound run read 3.162e-2 in the prefill, "causal mask
# dropped" 3.141; 2.505e-2 in the decode step, "newest key excluded"
# 5.248e-2 and "cache mask ignored" 2.361.  The decode limit lies near the
# geometric mean of its sound reading and its faintest fault.
WIDE = dict(FLAGSHIP, heads=3, max_patches=0)
WIDE_PROMPTS = dict(B=4, prompt=512, new=16)
WIDE_LOGIT_TOL = 0.125
WIDE_FAULT = "causal mask dropped"
WIDE_DECODE_LOGIT_TOL = 3.6e-2
WIDE_DECODE_FAULTS = ("newest key excluded", "cache mask ignored")
# (e) the two example walkthroughs run on the card at their default width
# (64d / 2 layers / 4 heads, k = 128) for this many steps
EXAMPLE_STEPS = 4
# phase 22: the VQ image tokenizer, the world model and the ring at hd 256.
# (a) the VQ at tools/train_vq.py's defaults (K = 512, D = 64, hidden 64,
# batch 32, lr 3e-4, VQ_STEPS steps) on the frames of VQ_EPISODES episodes
# of the synthetic image env (16x16).  The card's codes of every frame
# against the CPU's fp32 codes on the same weights: the share that agree
# must reach VQ_CODE_AGREE_MIN (the module runs fp32 with TF32 off, so only
# a near tie can flip).  The card's encoder output and decoded images on an
# odd-sized input (VQ_ODD) against a plain copy of the module written here
# (fp32 on the CPU: lax's SAME padding by hand, the transposed convolution
# as a correlation over the input dilated by 2) within VQ_OUT_TOL, with
# VQ_FAULTS planted in the copy outside it (a shape that differs counts as
# an infinite error).  The reconstruction MSE of the last 20 steps must fall
# to VQ_MSE_DROP of the first step's.
VQ_STEPS = 400
VQ_EPISODES = 32
VQ_ODD = (4, 7, 13)
VQ_CODE_AGREE_MIN = 0.99
VQ_OUT_TOL = 1e-4
VQ_FAULTS = ("transpose kernel not flipped", "SAME padding made symmetric")
VQ_MSE_DROP = 0.5
# (b) the world model at the flagship width (768d / 6 layers / 24 heads,
# k = 1024, bf16, dropout 0.1, fused AdamW) trained on (a)'s codes with
# --observation_loss through the Trainer for WORLD_STEPS steps of 16 rows;
# then `Generator.imagine` of WORLD_DREAM["frames"] frames after
# WORLD_DREAM["history"] real timesteps.  Its first frame's window logits
# (16 codes, each step restricted to the 512 codes) are held against the
# same generate_batch call through the plain prefill and decode attention,
# fed the kernel run's codes, under DECODE_LOGIT_TOL.  Both read the logits
# out of the model's bf16 hidden states in fp32 (`fp32_head`): the trained
# world model's logits reach |x| >= 4, where the bf16 head's own rounding
# step (1/32 there, 1/16 from 8) would decide the reading (the first card
# run, bf16 head: 3.125e-2, one such step).
WORLD_STEPS = 4
WORLD_ROWS = 16
WORLD_DREAM = dict(history=6, frames=3)
# (c) the ring at hd 256 (WIDE: 768d / 3 heads / 6 layers) at k = 8192 over
# SEQ shards on the one card (the ring's plain pair steps; no kernel), one
# train step at dropout 0 on WIDE_RING_ROWS text rows (a full one and a
# shorter one), against the same step without a 'seq' axis (plain attention
# at hd 256): the loss within WIDE_RING_LOSS_TOL, every gradient's relative
# L2 error within WIDE_RING_GRAD_TOL, with WIDE_RING_FAULTS planted in the
# ring's schedule (ring_planted) outside them; one step at dropout 0.1 (the
# seed's Philox mask, a window a pair) finite; no attention kernel launched.
# On an H100 (NVIDIA H100 80GB HBM3, 700.00 W) the sound step read a loss
# difference of 9.537e-6 and a gradient error of 4.572e-3; "farthest kv
# block skipped" 8.297e-5 and 4.980e-2, "running-max rescale dropped in the
# merge" 1.669e-4 and 7.293e-2.  Each limit lies near the geometric mean of
# its sound reading and its faintest fault.
WIDE_RING_CONTEXT = 8192
WIDE_RING_ROWS = (8192, 5000)
WIDE_RING_LOSS_TOL = 2.8e-5
WIDE_RING_GRAD_TOL = 1.5e-2
WIDE_RING_FAULTS = ("farthest kv block skipped", "running-max rescale dropped in the merge")

# the serving bench harnesses (phase 23): each one's main() at the flagship
# width, with fewer repetitions than its defaults (3 runs, 3 reps, 1 round, 1
# episode a mode, no warm-up episode).  In bf16 the random model's logits
# tie exactly (top-two gap 0) often enough that a token flips between two
# forwards of other shapes: there the speculative and the served tokens are
# held to the tie rule (`lossless`), and token for token in fp32 runs of the
# same width (speculation at 1 rep, 8 served requests).  The last rollout
# run has no prompt and a horizon under the window's 93 timesteps, so
# nothing is evicted and the two modes must take the same actions (fp32).
HARNESS_RUNS = (
    ("bench_decode", ["--runs", "3"]),
    ("bench_decode", ["--runs", "3", "--kv_quant"]),
    ("bench_spec", ["--gen", "128", "--reps", "3"]),
    ("bench_spec", ["--gen", "128", "--reps", "1", "--dtype", "float32"]),
    ("bench_serving", ["--requests", "16", "--rounds", "1"]),
    ("bench_serving", ["--requests", "8", "--rounds", "1", "--dtype", "float32"]),
    ("bench_rollout", ["--iterations", "1", "--warmup", "0"]),
    ("bench_rollout", ["--iterations", "1", "--warmup", "0", "--promptless", "--horizon", "16",
                       "--dtype", "float32"]),
)


def _require(ok, what) -> None:
    if not ok:
        raise AssertionError(what)


def _time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(min(3, iters)):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _device_ms(fn, iters: int = 50) -> float:
    """Device time per call of `fn`: the kernels and copies it launched, from
    torch.profiler, summed and divided by `iters`.  Where the host takes
    longer to launch a call than the card to run it, CUDA events around a
    loop time the host; this does not."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    return busy / 1e3 / iters


def _pairs(start, end, S: int, H: int) -> int:
    """(query row, key) pairs the causal mask and the key windows leave
    visible, over every batch row and head: the work these inputs need."""
    import torch

    rows = torch.arange(S, device=start.device)[None, :]
    seen = torch.minimum(end.long()[:, None], rows + 1) - start.long()[:, None]
    return int(seen.clamp(min=0).sum().item()) * H


def _bound(flops: float, nbytes: float):
    """-> (least ms the card could take, "operations" or "bytes"): the larger
    of the FLOPs over the bf16 tensor-core peak and the bytes (each input
    read once, each output written once) over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _tflops(flops: float, ms: float) -> float:
    """TFLOP/s of `flops` (the bound's FLOPs: the least work) done in `ms`."""
    return flops / ms / 1e9


def _attention_bounds(pairs, B, H, S, hd, elt):
    """{kernel: (bound ms, bound_by)} from the visible pairs: per pair each
    product is 2*hd FLOPs (forward: s, pv; fused backward and the whole-head
    backward: s, dp, dq, dk, dv; dq: s, dp, dq; dkv: s, dp, dk, dv).  Bytes:
    the [B, S, H*hd] operands in `elt` bytes, fp32 [B, H, S] row stats."""
    act, row = B * S * H * hd * elt, B * H * S * 4
    return {
        "fwd": _bound(4 * hd * pairs, 4 * act + 2 * row),          # q k v o, m l
        "whole_fwd": _bound(4 * hd * pairs, 4 * act + row),        # q k v o, lse
        "whole_bwd": _bound(10 * hd * pairs, 8 * act + row),       # q k v o do dq dk dv, lse
        "fused": _bound(10 * hd * pairs, 7 * act + 3 * row),       # q k v do dq dk dv, m l delta
        "dq": _bound(6 * hd * pairs, 5 * act + 3 * row),
        "dkv": _bound(8 * hd * pairs, 6 * act + 3 * row),
    }


def _sdpa_ms(q4, k4, v4, do4, rate, iters, causal=True):
    """(forward ms, backward ms) of torch's scaled_dot_product_attention,
    causal (or over every key) with dropout, on contiguous copies: the
    library yardstick (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.detach().contiguous().requires_grad_() for t in (q4, k4, v4))
    do = do4.contiguous()

    def fwd():
        return F.scaled_dot_product_attention(q, k, v, dropout_p=rate, is_causal=causal)

    out = fwd()
    return (_time_ms(fwd, iters),
            _time_ms(lambda: torch.autograd.grad(out, (q, k, v), do, retain_graph=True), iters))


def _against_plain(out, ref, start, end):
    """-> (max abs error, excess, share over KERNEL_TOL) on the rows that see
    a key (row >= start, start < end), as `_fwd_excess`; the outputs are
    [B,H,S,hd]."""
    import torch

    rows = torch.arange(out.shape[2], device=out.device)[None, :]
    valid = ((rows >= start[:, None]) & (start < end)[:, None])[:, None, :, None]
    valid = valid.expand_as(out)
    return _fwd_excess(out[valid], ref[valid], str(ref.dtype).removeprefix("torch."))


def _fwd_ptxas(libs):
    """-> [(library, kernel, template arguments, registers, spill bytes)] of
    every attention forward instance, from nvcc's ptxas -v logs."""
    import re

    rows = []
    for name, so in libs.items():
        fn = None
        for line in so.with_suffix(".log").read_text().splitlines():
            if m := re.search(r"Function properties for (\S+)", line):
                fn, spills = m.group(1), 0
            elif fn and "attention_fwd_kernel" in fn and (
                    m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                spills = int(m.group(1)) + int(m.group(2))
            elif fn and "attention_fwd_kernel" in fn and (
                    m := re.search(r"Used (\d+) registers", line)):
                tile = "tc" if "2tc20attention_fwd_kernel" in fn else "f32"
                args = re.search(r"attention_fwd_kernelI(.*)EEv", fn).group(1)
                hd = re.search(r"Li(\d+)E", args).group(1)
                drop, ring = re.findall(r"Lb(\d)E", args)[-2:]
                rows.append((name, tile, f"hd {hd} drop {drop} ring {ring}",
                             int(m.group(1)), spills))
                fn = None
    return rows


def kernel_vs_plain(B, H, S, hd, dtype_name, starts, ends, timed):
    """-> (max abs error on valid rows, {ms, plain_ms, library_ms, bound_ms,
    bound_by, tflops} when timed)."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    dev = torch.device("cuda")
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(B, H, S, hd, device=dev, generator=g).to(dtype)
               for _ in range(3))
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    end = torch.tensor(ends, dtype=torch.int32, device=dev)
    before = whk.whole_head_attention.launches
    out = whk.whole_head_attention(q, k, v, start, end)
    ref = whk.whole_head_attention_reference(q, k, v, start, end)
    torch.cuda.synchronize()
    _require(whk.whole_head_attention.launches == before + 1, "the kernel was not launched")
    if not torch.isfinite(out).all():
        raise AssertionError(f"kernel output not finite at {B}x{H}x{S}x{hd} {dtype_name}")
    err, excess, share = _against_plain(out, ref, start, end)
    atol, rtol = KERNEL_TOL[dtype_name]
    # which is closer to the same math on the fp32 upcast of the inputs
    exact = whk.whole_head_attention_reference(q.float(), k.float(), v.float(), start, end)
    e_k = _against_plain(out, exact, start, end)[0]
    e_p = _against_plain(ref, exact, start, end)[0]
    print(f"kernel vs plain B={B} H={H} S={S} hd={hd} {dtype_name}: "
          f"max abs err {err:.3e} (tolerance {atol:g} + {rtol:g}*|plain|, excess {excess:.1e}, "
          f"share over it {share:.1e}); vs fp32-input math: kernel {e_k:.3e}, plain {e_p:.3e}")
    if not excess <= 0:
        raise AssertionError(f"kernel disagrees with the plain version: {err}")
    if not timed:
        return err, None
    # in turns: plain, kernel, kernel, plain
    run_k = lambda: whk.whole_head_attention(q, k, v, start, end)  # noqa: E731
    run_p = lambda: whk.whole_head_attention_reference(q, k, v, start, end)  # noqa: E731
    p1, k1, k2, p2 = _time_ms(run_p), _time_ms(run_k), _time_ms(run_k), _time_ms(run_p)
    ms = (k1 + k2) / 2
    # at ~0.1 ms a call the host's wrapper work may outlast the kernel: its
    # device time too (torch.profiler)
    device_ms = _device_ms(run_k)
    lib = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    flops = 4 * hd * _pairs(start, end, S, H)
    bound = _bound(flops, 4 * q.numel() * q.element_size())
    print(f"  kernel {k1:.4f} / {k2:.4f} ms (device time {device_ms:.4f} ms), plain {p1:.4f} / "
          f"{p2:.4f} ms, SDPA (causal over full rows) {lib:.4f} ms, bound {bound[0]:.4f} ms "
          f"({bound[1]}), {_tflops(flops, ms):.1f} TFLOP/s ({_tflops(flops, device_ms):.1f} on "
          f"the device time)")
    return err, {"ms": ms, "device_ms": device_ms, "plain_ms": (p1 + p2) / 2,
                 "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib,
                 "tflops": _tflops(flops, ms)}


def _post(url: str, payload: dict):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
        status = r.status
    return status, body, time.perf_counter() - t0


def serve(card: str):
    """Phase 3.  Returns (prefill kernel launches in the serving run, decode
    kernel launches in it, the generator, the greedy prompts as examples)."""
    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import decode_attention as da
    from neko_tpu_torch.serving.server import NekoServer

    cfg = ModelConfig(**FLAGSHIP)
    t0 = time.perf_counter()
    gen = Generator(build_model(cfg, init_state_dict(cfg, SEED), "cuda"), seed=SEED)
    print(f"flagship model {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h k={cfg.context_len} "
          f"vocab {cfg.vocab_size} {cfg.dtype} built in {time.perf_counter() - t0:.1f} s")
    ts = cfg.token_space
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, ts.text_tokens, 512).tolist() for _ in range(4)]
    wants = [8, 16, 32, 32]
    frames = rng.integers(0, 256, (4, 96, 96, 3)).tolist()
    obs = rng.standard_normal((8, 17)).tolist()

    decode_steps = [0]
    decode_step = gen.model.decode_step

    def counted_decode_step(*args, **kw):  # the decode steps the requests ran
        decode_steps[0] += 1
        return decode_step(*args, **kw)

    gen.model.decode_step = counted_decode_step
    whk.whole_head_attention.launches = da.decode_cache_attention.launches = 0
    with NekoServer(gen, port=0, max_batch=8, batch_window_ms=100.0,
                    request_timeout=600.0) as server:
        host, port = server.address[0], server.address[1]
        base = f"http://{host}:{port}"
        results = [None] * 4
        errors = []

        def greedy(i):
            try:
                results[i] = _post(base + "/v1/generate",
                                   {"text": prompts[i], "max_new_tokens": wants[i]})
            except Exception as e:  # noqa: BLE001 -- re-raised below
                errors.append(e)

        threads = [threading.Thread(target=greedy, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"greedy requests failed: {errors}")
        lat = {}
        for i, (status, body, dt) in enumerate(results):
            toks = body["tokens"]
            _require(status == 200 and len(toks) == wants[i], body)
            _require(all(0 <= t < ts.text_tokens for t in toks), toks)
            lat[f"generate greedy #{i} {wants[i]} tok (coalesced)"] = dt

        status, body, dt = _post(base + "/v1/generate", {
            "text": prompts[0], "max_new_tokens": 16, "deterministic": False,
            "temperature": 0.8, "top_p": 0.9})
        _require(status == 200 and len(body["tokens"]) == 16, body)
        _require(all(0 <= t < ts.text_tokens for t in body["tokens"]), body)
        lat["generate sampled 16 tok"] = dt

        status, body, dt = _post(base + "/v1/action", {
            "continuous_obs": obs, "action_kind": "continuous", "action_tokens": 6})
        act = np.asarray(body["action"])
        _require(status == 200 and act.shape == (6,), body)
        _require(np.all((act >= -1.0) & (act <= 1.0)), act)
        lat["action continuous 8x17 obs -> 6"] = dt

        status, body, dt = _post(base + "/v1/action", {
            "images": frames, "action_kind": "discrete", "action_tokens": 1,
            "num_actions": 18})
        _require(status == 200 and isinstance(body["action"], int), body)
        _require(0 <= body["action"] < 18, body)
        lat["action discrete 4x96x96x3 frames"] = dt

        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
            _require(r.status == 200 and health["status"] == "ok", health)
        calls = server.coalesced_calls
    launches = whk.whole_head_attention.launches
    decode_launches = da.decode_cache_attention.launches
    del gen.model.decode_step
    for name, dt in lat.items():
        print(f"latency {name}: {dt * 1e3:.1f} ms ({card})")
    print(f"kernel launches {launches} over {calls} prefill calls x {cfg.layers} layers")
    print(f"decode kernel launches {decode_launches} over {decode_steps[0]} decode steps x "
          f"{cfg.layers} layers")
    if launches == 0 or launches != cfg.layers * calls:
        raise AssertionError(
            f"prefills did not all run through the kernel: {launches} launches, "
            f"{calls} prefill calls x {cfg.layers} layers")
    if decode_launches == 0 or decode_launches != cfg.layers * decode_steps[0]:
        raise AssertionError(
            f"decode steps did not all run through the kernel: {decode_launches} launches, "
            f"{decode_steps[0]} decode steps x {cfg.layers} layers")
    return launches, decode_launches, gen, [{"text": p} for p in prompts]


@contextlib.contextmanager
def prefill_attention_through(fn):
    """Within the block the model's prefill attention runs `fn(q, k, v,
    key_mask)` in place of the kernel wrapper."""
    from neko_tpu_torch.ops import attention as attn_ops

    wrapper = attn_ops.prefill_attention
    attn_ops.prefill_attention = fn
    try:
        yield
    finally:
        attn_ops.prefill_attention = wrapper


def plain_prefill_attention(q, k, v, key_mask, fault=None):
    """The kernel's plain version over the packer mask, or that version with
    one of FAULTS planted in it."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    start, end = whk.mask_bounds_from_key_mask(key_mask)
    if fault is None:
        return whk.whole_head_attention_reference(q, k, v, start, end)
    idx = torch.arange(q.shape[2], device=q.device)
    row, col = idx[:, None], idx[None, :]
    st, en = start.long()[:, None, None, None], end.long()[:, None, None, None]
    window = (col >= st) & (col < en)
    allowed, scale = {
        "causal mask dropped": (window, None),
        "diagonal excluded": ((col < row) & window, None),
        "key window ignored": ((col <= row)[None, None], None),
        "scale 1/hd": ((col <= row) & window, 1.0 / q.shape[-1]),
    }[fault]
    return whk.masked_attention(q, k, v, allowed, scale)


def prefill_check(gen, examples) -> None:
    """Phase 4, on the greedy batch."""
    import torch

    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.ops import attention as attn_ops
    from neko_tpu_torch.ops import attention_kernel as whk

    model = gen.model
    arrays = gen.packer.pack_batch(examples, pad_side="right")
    lengths = arrays.pop("lengths")
    S, V = model.cfg.context_len, model.cfg.vocab_size
    layer_errs, fault_excess = [], {f: [] for f in FAULTS}
    wrapper = attn_ops.prefill_attention

    def checked(q, k, v, key_mask):
        out = wrapper(q, k, v, key_mask)
        start, end = whk.mask_bounds_from_key_mask(key_mask)
        ref = plain_prefill_attention(q, k, v, key_mask)
        if not torch.isfinite(out).all():
            raise AssertionError(f"layer {len(layer_errs)}: kernel output not finite")
        layer_errs.append(_against_plain(out, ref, start, end))
        for f in FAULTS:
            bad = plain_prefill_attention(q, k, v, key_mask, fault=f)
            fault_excess[f].append(_against_plain(bad, ref, start, end)[1])
        return out

    with torch.inference_mode():
        batch = to_device_batch(arrays, gen.device)
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(gen.device)
        last = torch.as_tensor(lengths - 1, device=gen.device)
        emb = model.embed_batch(batch)
        with prefill_attention_through(checked):
            got, _ = model.prefill(emb, mask, last=last)
        with prefill_attention_through(plain_prefill_attention):
            want, _ = model.prefill(emb, mask, last=last)
        fault_err = {}
        for f in FAULTS:
            with prefill_attention_through(
                    lambda *a, f=f: plain_prefill_attention(*a, fault=f)):
                bad, _ = model.prefill(emb, mask, last=last)
            fault_err[f] = (bad[:, :V] - want[:, :V]).abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel prefill logits not finite")

    for i, (err, excess, share) in enumerate(layer_errs):
        print(f"layer {i} attention on the served inputs, kernel vs plain: "
              f"max abs err {err:.3e} (excess over tolerance {excess:.3e}, share over "
              f"KERNEL_TOL {share:.1e})")
    err = (got[:, :V] - want[:, :V]).abs().max().item()
    # argmax agreement is printed, not held: random-init logits have top-2
    # gaps below the bf16 noise on some rows
    agree = (got[:, :V].argmax(-1) == want[:, :V].argmax(-1)).float().mean().item()
    print(f"prefill logits kernel vs plain: max abs err {err:.3e} "
          f"(tolerance {LOGIT_TOL:g}; logit std {want[:, :V].std().item():.3f}), "
          f"argmax agreement {agree:.2f}")
    for f in FAULTS:
        print(f"control '{f}': per-layer excess over tolerance "
              f"{max(fault_excess[f]):.3e}, logits max abs err {fault_err[f]:.3e}")

    if not all(excess <= 0 for _, excess, _ in layer_errs):
        raise AssertionError(f"kernel disagrees with the plain version on a layer: {layer_errs}")
    if not err <= LOGIT_TOL:
        raise AssertionError(f"prefill logits disagree: {err}")
    blind = [f for f in FAULTS if not max(fault_excess[f]) > 0]
    blind += [f for f in LOGIT_FAULTS if not fault_err[f] > LOGIT_TOL]
    if blind:
        raise AssertionError(f"the checks cannot tell these planted faults: {blind}")


# ------------------------------------------------------------- training
def _train_bounds(B, S, dev):
    """Left-padded rows as the packer writes them for training, with a short
    row (37 keys) and an empty row (no key)."""
    import torch

    starts = ([0, 100, 600, S - 37, S, 0, 200, 400, 50, 0, 700, 900, 10, 0, 333, S - 1]
              * B)[:B]
    ends = [0 if st >= S else S for st in starts]
    return (torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(ends, dtype=torch.int32, device=dev))


def _valid_rows(start, end, S):
    """bool [B, S]: the query row sees a key."""
    import torch

    rows = torch.arange(S, device=start.device)[None, :]
    return (rows >= start[:, None].long()) & (start < end)[:, None]


def _flip_excess(got, want, tight, loose):
    """-> (max abs error, excess, share of the values over `tight`): the
    larger of that share less FLIP_SHARE and the largest excess over `loose`
    (> 0 fails either), for bf16 values whose two sides round an operand to
    bf16 from fp32 values computed in other orders."""
    atol, rtol = tight
    diff, w = (got.float() - want.float()).abs(), want.float().abs()
    share = (diff > atol + rtol * w).double().mean().item()
    return diff.max().item(), max(share - FLIP_SHARE, _excess(got, want, loose)[1]), share


def _held(got, want, dtype_name, tol):
    """-> (max abs error, excess, share over tol[dtype_name]): in fp32 the
    excess over tol; in bf16 `_flip_excess` with GRAD_TOL as the loose
    limit."""
    if dtype_name == "bfloat16":
        return _flip_excess(got, want, tol[dtype_name], GRAD_TOL[dtype_name])
    err, excess = _excess(got, want, tol[dtype_name])
    return err, excess, float(excess > 0)


def _tile_excess(got, want, dtype_name):
    """A backward tile's gradient against the plain one (BLOCKED_GRAD_TOL)."""
    return _held(got, want, dtype_name, BLOCKED_GRAD_TOL)


def _fwd_excess(got, want, dtype_name):
    """A forward's output against the plain one (KERNEL_TOL)."""
    return _held(got, want, dtype_name, KERNEL_TOL)


def _neighbour_keep(seed, B, H, rate, rows, cols):
    """FWD_FAULT: the keep/scale window of (rows, cols) drawn from the keep
    bytes of the columns 16 to the right (the neighbouring Philox block)."""
    from neko_tpu_torch.ops import attention_kernel as whk

    return whk.dropout_keep_scale_reference(seed, B, H, None, rate, rows=rows,
                                            cols=(cols[0] + 16, cols[1] + 16))


def _excess(got, want, tol):
    """-> (max abs error, largest excess over atol + rtol * |want|)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), (diff - atol - rtol * want.float().abs()).max().item()


def plain_attention_backward(q, k, v, do, start, end, sm_scale, ks, fault=None):
    """dq, dk, dv of the plain attention by the math of the TPU kernel's
    `_blk_grads`, with fp32 sums on [B, H, S, hd]; p * keep and ds are
    rounded to q's dtype before their products, as neko_tpu and the kernels
    round them; rows that see no key have p = 0 (their output is 0).
    `fault` plants one of STEP_FAULTS."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    ok = whk.allowed_keys(q.shape[-2], start, end)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = (qf @ kf.transpose(-1, -2) * sm_scale).masked_fill(~ok, -1e30)
    p = torch.softmax(s, dim=-1) * ok.any(dim=-1, keepdim=True)
    del s
    drop = ks is not None and fault != "keep mask not applied in the backward"
    dv = (p * ks if drop else p).to(q.dtype).float().transpose(-1, -2) @ dof
    dp = dof @ vf.transpose(-1, -2)
    if drop:
        dp = dp * ks
    delta = 0.0 if fault == "delta taken as 0" else (dp * p).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
    del dp, p
    dq, dk = ds @ kf, ds.transpose(-1, -2) @ qf
    if fault == "dk without sm_scale":
        dk = dk / sm_scale
    return dq, dk, dv


def plain_attention_forward(q, k, v, start, end, ks, fault=None):
    """The plain forward on [B, H, S, hd] with the keep/scale `ks`, or with
    one of STEP_LOSS_FAULTS planted in it."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    if fault == "keep mask not applied in the forward":
        ks = None
    sm_scale = 1.0 / q.shape[-1] if fault == "scale 1/hd in the forward" else None
    if fault != "causal mask dropped in the forward":
        return whk.whole_head_attention_reference(q, k, v, start, end, sm_scale, ks)
    col = torch.arange(q.shape[-2], device=q.device)[None, None, None, :]
    ok = (col >= start.long()[:, None, None, None]) & (col < end.long()[:, None, None, None])
    out = whk.masked_attention(q, k, v, ok, sm_scale, keep_scale=ks)
    return out.masked_fill(~ok.any(dim=-1, keepdim=True), 0)


def plain_attention_qkv_fn(fault=None):
    """A stand-in for ops.attention.attention_qkv: the plain forward with the
    mask from the mask kernel, and `plain_attention_backward` as its
    backward, with `fault` (one of STEP_FAULTS or STEP_LOSS_FAULTS) planted.
    Both run in fp32 on the bf16 inputs and round the result once, as the
    kernels do, so the step check's sound reading is the kernels' summation
    order alone."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    class PlainQKV(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, start, end, seed, heads, rate):
            q, k, v = (t.float() for t in whk._qkv_views("qkv", (qkv,), heads))
            B, H, S, hd = q.shape
            ks = whk.dropout_keep_scale(seed, B, H, S, rate) if rate > 0 else None
            out = plain_attention_forward(q, k, v, start, end, ks, fault).to(qkv.dtype)
            ctx.save_for_backward(qkv, start, end, seed)
            ctx.static = (heads, rate)
            return out.transpose(1, 2).reshape(B, S, H * hd)

        @staticmethod
        def backward(ctx, dout):
            qkv, start, end, seed = ctx.saved_tensors
            heads, rate = ctx.static
            q, k, v = whk._qkv_views("qkv", (qkv,), heads)
            B, H, S, hd = q.shape
            ks = whk.dropout_keep_scale(seed, B, H, S, rate) if rate > 0 else None
            grads = plain_attention_backward(q, k, v, whk._heads4(dout, heads), start, end,
                                             hd ** -0.5, ks, fault)
            dqkv = torch.cat([g.transpose(1, 2).reshape(B, S, H * hd) for g in grads], -1)
            return dqkv.to(qkv.dtype), None, None, None, None, None

    def attention_qkv(qkv, key_mask, *, heads, seed=None, rate=0.0):
        start, end = whk.mask_bounds_from_key_mask(key_mask)
        return PlainQKV.apply(qkv, start, end, seed, heads, rate)

    return attention_qkv


@contextlib.contextmanager
def train_attention_through(fn):
    """Within the block the model's train attention runs `fn` in place of
    ops.attention.attention_qkv."""
    from neko_tpu_torch.ops import attention as attn_ops

    wrapper = attn_ops.attention_qkv
    attn_ops.attention_qkv = fn
    try:
        yield
    finally:
        attn_ops.attention_qkv = wrapper


def _attention_train_times(qkv, dout, seed, ks, H, card, mask=False) -> dict:
    """Times of #3 / #4 (and with `mask` #5) on the head-packed qkv [B, S,
    3 * H * hd] at rate RATE, in turns (plain, kernel, kernel, plain), on
    full rows, as in the flagship batch (its rows hold 988 to 1023 tokens),
    with SDPA's as the library yardstick.  -> {part: (ms, plain_ms,
    library_ms, bound_ms, bound_by, flops)}."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    B, S, D = qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3
    hd, dev = D // H, qkv.device
    start = torch.zeros(B, dtype=torch.int32, device=dev)
    end = torch.full((B,), S, dtype=torch.int32, device=dev)
    q4, k4, v4 = whk._qkv_views("qkv", (qkv,), H)
    out = torch.empty(B, S, D, dtype=qkv.dtype, device=dev)
    o4, do4 = whk._heads4(out, H), whk._heads4(dout, H)
    _, lse = whk.whole_head_attention_fwd(q4, k4, v4, start, end, seed, None, RATE,
                                          out=o4, need_lse=True)
    dqkv = torch.empty_like(qkv)
    dq4, dk4, dv4 = whk._qkv_views("qkv", (dqkv,), H)
    xp = qkv.clone().requires_grad_()
    ref = whk.whole_head_attention_reference(*whk._qkv_views("qkv", (xp,), H), start, end,
                                             None, ks)

    def turns(kernel, plain, iters):
        p1, k1, k2, p2 = (_time_ms(f, iters) for f in (plain, kernel, kernel, plain))
        return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)

    timed = {
        "fwd": turns(lambda: whk.whole_head_attention_fwd(
                         q4, k4, v4, start, end, seed, None, RATE, out=o4, need_lse=True),
                     lambda: whk.whole_head_attention_reference(q4, k4, v4, start, end,
                                                                None, ks), 10),
        "bwd": turns(lambda: whk.whole_head_attention_bwd(
                         q4, k4, v4, o4, do4, lse, start, end, seed, None, RATE,
                         dq=dq4, dk=dk4, dv=dv4),
                     lambda: torch.autograd.grad(ref, (xp,), do4, retain_graph=True), 10),
    }
    if mask:
        timed["mask"] = turns(lambda: whk.dropout_keep_scale(seed, B, H, S, RATE),
                              lambda: whk.dropout_keep_scale_reference(seed, B, H, S, RATE), 3)
    lib = dict(zip(("fwd", "bwd"), _sdpa_ms(q4, k4, v4, do4, RATE, 10)))
    pairs = _pairs(start, end, S, H)
    bounds = _attention_bounds(pairs, B, H, S, hd, 2)
    bounds = {"fwd": bounds["whole_fwd"], "bwd": bounds["whole_bwd"],
              "mask": _bound(0, B * H * S * S * 4)}
    flops = {"fwd": 4 * hd * pairs, "bwd": 10 * hd * pairs, "mask": 0}
    res = {}
    for part, (ms, plain_ms, each) in timed.items():
        print(f"train {part} B={B} H={H} S={S} hd={hd} bf16 rate {RATE}, full rows: kernel "
              f"{ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (in turns k {each[0]:.4f}/{each[1]:.4f}, "
              f"p {each[2]:.4f}/{each[3]:.4f}), library "
              f"{'-' if part not in lib else f'{lib[part]:.4f} ms'}, bound "
              f"{bounds[part][0]:.4f} ms ({bounds[part][1]}), {_tflops(flops[part], ms):.1f} "
              f"TFLOP/s ({card})")
        res[part] = (ms, plain_ms, lib.get(part), *bounds[part], flops[part])
    return res


def train_kernels_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 5.  -> errors and times of the three training kernels."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import ring_kernel as rk

    B, H, S, hd = TRAIN["B"], TRAIN["H"], TRAIN["S"], TRAIN["hd"]
    D = H * hd
    g = torch.Generator(device=dev).manual_seed(SEED)
    qkv = torch.randn(B, S, 3 * D, device=dev, generator=g).bfloat16()
    start, end = _train_bounds(B, S, dev)
    valid = _valid_rows(start, end, S)
    dout = torch.randn(B, S, D, device=dev, generator=g).bfloat16() * valid[..., None]
    seed = torch.tensor([SEED + 17], dtype=torch.int32, device=dev)
    res = {}

    ks = whk.dropout_keep_scale(seed, B, H, S, RATE)
    ks_plain = whk.dropout_keep_scale_reference(seed, B, H, S, RATE)
    _require(torch.equal(ks, ks_plain), "mask kernel differs from the plain Philox")
    del ks_plain
    q_thr = whk.keep_threshold(RATE)
    p_keep, n = 1.0 - q_thr / 256.0, ks.numel()
    share = (ks > 0).double().mean().item()
    print(f"mask kernel {B}x{H}x{S}x{S}: equal to the plain Philox bit for bit; keep "
          f"share {share:.6f} (expected {p_keep:.6f} +- {5 * (p_keep * (1 - p_keep) / n) ** 0.5:.2e})")
    _require(abs(share - p_keep) < 5 * (p_keep * (1 - p_keep) / n) ** 0.5, "keep share")
    # the coalesced stores' edges: rows shorter than a warp's 128 columns, S
    # no multiple of 4 (scalar stores) or of 16
    for Bm, Hm, Sm in MASK_EDGES:
        got = whk.dropout_keep_scale(seed, Bm, Hm, Sm, RATE)
        want = whk.dropout_keep_scale_reference(seed, Bm, Hm, Sm, RATE)
        _require(torch.equal(got, want), f"mask kernel differs at S={Sm}")
    print(f"mask kernel equal to the plain Philox bit for bit at (B, H, S) {MASK_EDGES}")

    fwd_err = bwd_err = 0.0
    for rate in (0.0, RATE):
        x = qkv.clone().requires_grad_()
        out = whk.whole_head_attention_qkv(x, start, end, seed, heads=H, dropout_rate=rate)
        (dx,) = torch.autograd.grad(out, (x,), dout)
        torch.cuda.synchronize()
        _require(torch.isfinite(out).all() and torch.isfinite(dx).all(), "kernel output not finite")
        xp = qkv.clone().requires_grad_()
        q4, k4, v4 = whk._qkv_views("qkv", (xp,), H)
        ref = whk.whole_head_attention_reference(q4, k4, v4, start, end, None,
                                                 ks if rate else None)
        ref = ref.transpose(1, 2).reshape(B, S, D)
        (dxp,) = torch.autograd.grad(ref, (xp,), dout)
        err, excess, share = _fwd_excess(out[valid], ref[valid], "bfloat16")
        fwd_err = max(fwd_err, err)
        fault = ""
        if rate:
            with torch.no_grad():
                bad = whk.whole_head_attention_reference(
                    q4, k4, v4, start, end, None, _neighbour_keep(seed, B, H, rate, (0, S), (0, S)))
            x_f = _fwd_excess(out[valid], bad.transpose(1, 2).reshape(B, S, D)[valid],
                              "bfloat16")[1]
            fault = f"; control '{FWD_FAULT}' excess {x_f:.3e}"
            _require(x_f > 0, f"the train forward check cannot tell '{FWD_FAULT}'")
            del bad
        print(f"train forward rate {rate}: kernel vs plain max abs err {err:.3e} "
              f"(excess over tolerance {excess:.3e}, share over KERNEL_TOL {share:.1e}){fault}")
        _require(excess <= 0, f"train forward disagrees at rate {rate}")
        bwd_fault = STEP_FAULTS[0]  # keep mask not applied in the backward
        with torch.no_grad():  # the plain backward phase 6 plants faults into
            explicit = plain_attention_backward(
                q4, k4, v4, whk._heads4(dout, H), start, end, hd ** -0.5, ks if rate else None)
            faulty = (plain_attention_backward(q4, k4, v4, whk._heads4(dout, H), start, end,
                                               hd ** -0.5, ks, bwd_fault)
                      if rate else (None,) * 3)
        for name, got, want, mine, bad in zip("qkv", dx.chunk(3, -1), dxp.chunk(3, -1),
                                              explicit, faulty):
            tols = (GRAD_TOL["bfloat16"], GRAD_FLIP_TOL)
            err, excess, share = _flip_excess(got, want, *tols)
            e2, x2, s2 = _flip_excess(mine.transpose(1, 2).reshape(B, S, D), want.float(), *tols)
            bwd_err = max(bwd_err, err)
            control = ""
            if bad is not None:
                x_f = _flip_excess(got, bad.transpose(1, 2).reshape(B, S, D), *tols)[1]
                control = f"; control '{bwd_fault}' excess {x_f:.3e}"
                _require(x_f > 0, f"the train backward check cannot tell '{bwd_fault}' in d{name}")
            print(f"train backward rate {rate} d{name}: kernel vs autograd through plain "
                  f"max abs err {err:.3e} (excess {excess:.3e}, share over GRAD_TOL "
                  f"{share:.1e}); explicit plain backward {e2:.3e} (excess {x2:.3e}, share "
                  f"{s2:.1e}){control}")
            _require(excess <= 0 and x2 <= 0, f"train backward d{name} disagrees at rate {rate}")
        del x, xp, out, ref, dx, dxp, explicit, faulty
    res["fwd_err"], res["bwd_err"] = fwd_err, bwd_err

    for Bx, Hx, hdx in ((8, 12, 64), (8, 6, 128)):
        gq = [torch.randn(Bx, Hx, S, hdx, device=dev, generator=g).requires_grad_()
              for _ in range(3)]
        st, en = _train_bounds(Bx, S, dev)
        ok = _valid_rows(st, en, S)[:, None, :, None]
        do4 = torch.randn(Bx, Hx, S, hdx, device=dev, generator=g) * ok
        o = whk.whole_head_attention(*gq, st, en, seed, dropout_rate=RATE)
        grads = torch.autograd.grad(o, gq, do4)
        ksx = whk.dropout_keep_scale(seed, Bx, Hx, S, RATE)
        r = whk.whole_head_attention_reference(*gq, st, en, None, ksx)
        rgrads = torch.autograd.grad(r, gq, do4)
        errs = [_fwd_excess(o[ok.expand_as(o)], r[ok.expand_as(r)], "float32")[:2]]
        errs += [_excess(a, b, GRAD_TOL["float32"]) for a, b in zip(grads, rgrads)]
        print(f"[B,H,S,hd] {Bx}x{Hx}x{S}x{hdx} fp32 rate {RATE}: out, dq, dk, dv max abs "
              f"err {', '.join(f'{e:.2e}' for e, _ in errs)}")
        _require(all(x <= 0 for _, x in errs), f"hd {hdx} fp32 kernel disagrees")
        del gq, o, grads, r, rgrads, ksx

    # the tensor-core forward and backward at their end widths (bf16 hd 16
    # and 128) and hd 16 in fp32 (padded to 32): the kernels on [B, H, S, hd]
    # with dropout against the plain versions, the backward on the kernel
    # forward's own lse and delta (the plain backward of the whole head is
    # the ring's pair backward at offsets 0)
    for Bx, Hx, hdx, dt in ((8, 8, 16, "bfloat16"), (4, 4, 128, "bfloat16"),
                            (8, 8, 16, "float32")):
        q4, k4, v4 = (torch.randn(Bx, Hx, S, hdx, device=dev, generator=g).to(getattr(torch, dt))
                      for _ in range(3))
        st, en = _train_bounds(Bx, S, dev)
        ok = _valid_rows(st, en, S)[:, None, :, None]
        do4 = (torch.randn(Bx, Hx, S, hdx, device=dev, generator=g) * ok).to(q4.dtype)
        o, lse = whk.whole_head_attention_fwd(q4, k4, v4, st, en, seed, None, RATE,
                                              need_lse=True)
        grads = whk.whole_head_attention_bwd(q4, k4, v4, o, do4, lse, st, en, seed, None, RATE)
        ksx = whk.dropout_keep_scale(seed, Bx, Hx, S, RATE)
        r = whk.whole_head_attention_reference(q4, k4, v4, st, en, None, ksx)
        at = (lse, ba.row_delta(do4, o), 0, 0, st, en, None, ksx)
        want = (rk.ring_partial_dq_reference(q4, k4, v4, do4, *at),
                *rk.ring_partial_dkv_reference(q4, k4, v4, do4, *at))
        # the forward's lse contract: m + log(l) of the plain row stats, 0 on
        # rows that see no key
        _, m_w, l_w = ba.blocked_fwd_reference(q4, k4, v4, st, en, None, ksx)
        lse_w = torch.where(l_w > 0, m_w + torch.log(l_w.clamp_min(1e-30)), 0.0)
        errs = [_fwd_excess(o[ok.expand_as(o)], r[ok.expand_as(r)], dt)[:2],
                _excess(lse, lse_w, STAT_TOL["m"])]
        tiles = [_tile_excess(a, b, dt) for a, b in zip(grads, want)]
        errs += [t[:2] for t in tiles]
        print(f"[B,H,S,hd] {Bx}x{Hx}x{S}x{hdx} {dt} rate {RATE}: out, lse, dq, dk, dv max abs "
              f"err {', '.join(f'{e:.2e}' for e, _ in errs)} (excess "
              f"{', '.join(f'{x:.1e}' for _, x in errs)}; share over {BLOCKED_GRAD_TOL[dt]} "
              f"{', '.join(f'{t[2]:.1e}' for t in tiles)})")
        _require(all(x <= 0 for _, x in errs) and not lse[~ok[..., 0].expand_as(lse)].any(),
                 f"hd {hdx} {dt} kernel disagrees")
        if dt == "bfloat16":
            res["fwd_err"] = max(res["fwd_err"], errs[0][0])
            res["bwd_err"] = max([res["bwd_err"]] + [e for e, _ in errs[2:]])
        del q4, k4, v4, do4, o, grads, ksx, r, want, m_w, l_w, lse_w

    res.update(_attention_train_times(qkv, dout, seed, ks, H, card, mask=True))
    return res


def _grad_gap(grads, want) -> float:
    """Largest relative L2 error of a parameter's gradient."""
    return max(((grads[n].float() - w.float()).norm() / w.float().norm().clamp(min=1e-30)).item()
               for n, w in want.items())


def _chunks_of(targets: int) -> int:
    """Chunks the gathered loss cuts `targets` loss targets into: the loss
    head #15 launches once for each."""
    import inspect

    from neko_tpu_torch.ops import losses

    size = inspect.signature(losses.gathered_masked_xent).parameters["chunk_size"].default
    return -(-targets // size)


def _loss_chunks(batch) -> int:
    """Chunks of a batch's gathered loss targets."""
    return _chunks_of(batch.loss_pos.shape[0])


@contextlib.contextmanager
def plain_loss_forward():
    """The loss forward's (logz, target logit) through the plain version (the
    [C, V] logits in fp32, logsumexp, gather) in place of kernel #15."""
    from neko_tpu_torch.ops import loss_kernel as lk

    kernel = lk.fused_logz_tl
    lk.fused_logz_tl = lk.fused_logz_tl_reference
    try:
        yield
    finally:
        lk.fused_logz_tl = kernel


def _step_loss_and_grads(ctx, sd, batch, fn=None):
    """(loss, {name: gradient}) of one step from the state dict `sd`; with
    `fn`, the plain side: the train attention replaced by `fn` and the loss
    forward by its plain version."""
    st = ctx.init_state({k: v.clone() for k, v in sd.items()})
    with contextlib.ExitStack() as stack:
        if fn is not None:
            stack.enter_context(train_attention_through(fn))
            stack.enter_context(plain_loss_forward())
        loss = ctx.loss_and_grads(st, batch).item()
    return loss, {n: p.grad for n, p in st.model.named_parameters()}


def smoke_width_step_check(card: str, dev="cuda") -> dict:
    """Phase 6 at hd 16: one train step at configs/smoke_offline.sh's width
    (SMOKE_WIDTH: 64d / 2 layers / 4 heads, k = 128, 8 rows; bf16, dropout
    0.1, the bench's mixed batch) through the kernels -- the forward padded
    to hd 32, the backward's tensor-core tiles at hd 16 -- against the same
    step through the plain attention (same seeds, so the same masks), with
    STEP_FAULTS and STEP_LOSS_FAULTS planted.  -> the readings."""
    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import attention_kernel as whk

    cfg, ctx, _, batch, B = bench.setup(SMOKE_WIDTH, dev, SEED)
    _require(cfg.head_dim == 16, f"hd {cfg.head_dim}")
    sd = init_state_dict(cfg, SEED)
    before = whk.whole_head_attention_bwd.launches
    loss_k, grads_k = _step_loss_and_grads(ctx, sd, batch)
    launches = whk.whole_head_attention_bwd.launches - before
    loss_p, grads_p = _step_loss_and_grads(ctx, sd, batch, plain_attention_qkv_fn())
    gap, dloss = _grad_gap(grads_k, grads_p), abs(loss_k - loss_p)
    print(f"hd 16 step {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h k={cfg.context_len} B={B} "
          f"bf16 dropout {cfg.dropout}, kernels vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (diff {dloss:.3e}, tolerance {SMOKE_STEP_LOSS_TOL:g}); largest "
          f"relative gradient error {gap:.3e} (tolerance {SMOKE_STEP_GRAD_TOL:g}); backward "
          f"launches {launches}")
    _require(launches == cfg.layers, f"hd 16 backward launches {launches}")
    fault_gap, fault_dloss = {}, {}
    for f in STEP_FAULTS + STEP_LOSS_FAULTS:
        loss_f, grads_f = _step_loss_and_grads(ctx, sd, batch, plain_attention_qkv_fn(f))
        fault_gap[f], fault_dloss[f] = _grad_gap(grads_f, grads_p), abs(loss_f - loss_p)
        print(f"hd 16 control '{f}': loss diff {fault_dloss[f]:.3e}, largest relative gradient "
              f"error {fault_gap[f]:.3e}")
    _require(dloss <= SMOKE_STEP_LOSS_TOL and gap <= SMOKE_STEP_GRAD_TOL,
             f"the hd 16 kernel step disagrees with the plain step: {dloss}, {gap}")
    blind = [f for f in STEP_FAULTS if not fault_gap[f] > SMOKE_STEP_GRAD_TOL]
    blind += [f for f in STEP_LOSS_FAULTS if not fault_dloss[f] > SMOKE_STEP_LOSS_TOL]
    _require(not blind, f"the hd 16 step check cannot tell these planted faults: {blind}")
    return {"dloss": dloss, "gap": gap}


def train_step_check(card: str, dev="cuda") -> dict:
    """Phase 6.  -> launch counts of the training kernels in the timed train
    steps ("fwd", "bwd", "mask", "loss"), and of the mask kernel in the step
    check ("mask_check")."""
    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    cfg, ctx, state, batch, B = bench.setup("flagship", dev, SEED)
    warm, steps = 2, 5
    _, warm_losses = bench.time_steps(ctx, state, batch, warm)
    torch.cuda.reset_peak_memory_stats()
    whk.whole_head_attention.launches = whk.whole_head_attention_bwd.launches = 0
    whk.dropout_keep_scale.launches = lk.fused_logz_tl.launches = 0
    dt, losses = bench.time_steps(ctx, state, batch, steps)
    fwd, bwd = whk.whole_head_attention.launches, whk.whole_head_attention_bwd.launches
    mask, loss_head = whk.dropout_keep_scale.launches, lk.fused_logz_tl.launches
    tokens = B * cfg.context_len
    fpt = bench.train_flops_per_token(cfg, bench.tgt_budget(B, cfg) / tokens)
    tps = tokens * steps / dt
    peak = bench.PEAK_FLOPS.get(torch.cuda.get_device_name(0))
    print(f"flagship train step {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h k={cfg.context_len} "
          f"B={B} bf16 dropout {cfg.dropout}: {dt * 1e3 / steps:.3f} ms/step, "
          f"{tps:.1f} tokens/s, MFU {tps * fpt / peak if peak else float('nan'):.4f} "
          f"({fpt / 1e6:.1f} MFLOP/token), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
    print(f"losses: warm-up {warm_losses}, timed {losses}")
    _require(all(np.isfinite(warm_losses + losses)), f"non-finite loss: {losses}")
    chunks = _loss_chunks(batch)
    print(f"train kernel launches over {steps} steps x {cfg.layers} layers: forward {fwd}, "
          f"backward {bwd}, mask {mask} (the kernels draw their keep bytes inline); loss head "
          f"{loss_head} ({chunks} loss chunks a step)")
    _require(fwd == bwd == cfg.layers * steps,
             f"the train steps did not all run through the kernels: {fwd}, {bwd}")
    _require(mask == 0, f"the train steps launched the mask kernel {mask} times")
    _require(loss_head == chunks * steps,
             f"the loss forward did not run through the loss head kernel: {loss_head}")
    del state

    sd = init_state_dict(cfg, SEED)

    def loss_and_grads(fn=None):
        return _step_loss_and_grads(ctx, sd, batch, fn)

    loss_k, grads_k = loss_and_grads()
    whk.dropout_keep_scale.launches = lk.fused_logz_tl.launches = 0
    loss_p, grads_p = loss_and_grads(plain_attention_qkv_fn())
    mask_launches = whk.dropout_keep_scale.launches
    _require(lk.fused_logz_tl.launches == 0, "the plain step launched the loss head kernel")
    gap, dloss = _grad_gap(grads_k, grads_p), abs(loss_k - loss_p)
    print(f"one step, kernels vs plain attention (same seeds and masks): loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (diff {dloss:.3e}, tolerance {STEP_LOSS_TOL:g}); largest relative "
          f"gradient error {gap:.3e} (tolerance {STEP_GRAD_TOL:g}); mask kernel launches "
          f"{mask_launches}")
    del grads_k
    fault_gap, fault_dloss = {}, {}
    for f in STEP_FAULTS + STEP_LOSS_FAULTS:
        loss_f, grads_f = loss_and_grads(plain_attention_qkv_fn(f))
        fault_gap[f], fault_dloss[f] = _grad_gap(grads_f, grads_p), abs(loss_f - loss_p)
        print(f"control '{f}': loss diff {fault_dloss[f]:.3e}, largest relative gradient "
              f"error {fault_gap[f]:.3e}")
        del grads_f
    _require(dloss <= STEP_LOSS_TOL and gap <= STEP_GRAD_TOL,
             f"the kernel step disagrees with the plain step: {dloss}, {gap}")
    _require(mask_launches == 2 * cfg.layers, f"mask kernel launches {mask_launches}")
    blind = [f for f in STEP_FAULTS if not fault_gap[f] > STEP_GRAD_TOL]
    blind += [f for f in STEP_LOSS_FAULTS if not fault_dloss[f] > STEP_LOSS_TOL]
    _require(not blind, f"the step check cannot tell these planted faults: {blind}")

    opt = OptimizerConfig(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                          disable_cosine_decay=True)
    ctx2 = TrainContext(cfg, opt, device=dev, seed=SEED)
    state2 = ctx2.init_state()
    _, curve = bench.time_steps(ctx2, state2, batch, 20)
    print("20 steps on one batch at lr 1e-3: loss " + ", ".join(f"{x:.4f}" for x in curve[::4])
          + f", ..., {curve[-1]:.4f}")
    _require(all(np.isfinite(curve)) and curve[-1] < curve[0] - 1.0,
             f"the loss did not fall: {curve}")
    return {"fwd": fwd, "bwd": bwd, "mask": mask, "mask_check": mask_launches,
            "loss": loss_head, "step_ms": dt * 1e3 / steps}


# ------------------------------------------------------- long context
def blocked_kernels_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 7.  -> {"err": max abs error per kernel, "times": {S: {kernel:
    JSON timing fields}}, "check_launches": launches per kernel here}."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba

    counters = {"fwd": ba.blocked_attention_fwd, "fused": ba.blocked_attention_bwd_fused,
                "dq": ba.blocked_attention_dq, "dkv": ba.blocked_attention_dkv,
                "mask": whk.dropout_keep_scale}
    for f in counters.values():
        f.launches = 0
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    seed = torch.tensor([SEED + 29], dtype=torch.int32, device=dev)
    errs = dict.fromkeys(("fwd", "fused", "dq", "dkv"), 0.0)

    def inputs(B, H, S, hd, dtype, full_rows=False):
        qkv = torch.randn(B, S, 3 * H * hd, device=dev, generator=g).to(dtype)
        if full_rows:
            start = torch.zeros(B, dtype=torch.int32, device=dev)
            end = torch.full((B,), S, dtype=torch.int32, device=dev)
        else:
            start, end = _train_bounds(B, S, dev)
        valid = _valid_rows(start, end, S)
        dout = torch.randn(B, S, H * hd, device=dev, generator=g).to(dtype) * valid[..., None]
        return qkv, start, end, valid, dout

    def case(B, H, S, hd, dtype_name, rate):
        qkv, start, end, valid, dout = inputs(B, H, S, hd, getattr(torch, dtype_name))
        q, k, v = whk._qkv_views("qkv", (qkv,), H)
        do = whk._heads4(dout, H)
        ks = ba.dropout_keep_scale(seed, B, H, S, rate) if rate else None
        if rate and dtype_name == "bfloat16":
            _require(torch.equal(ks, whk.dropout_keep_scale_reference(seed, B, H, S, rate)),
                     f"mask kernel differs from the plain Philox at {B}x{H}x{S}")
            print(f"mask kernel {B}x{H}x{S}x{S}: equal to the plain Philox bit for bit")
        out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, rate)
        delta = ba.row_delta(do, out)
        bwd = (q, k, v, do, m, l, delta, start, end, seed, None, rate)
        routes = {"fused": ba.blocked_attention_bwd_fused(*bwd),
                  "three-pass": (ba.blocked_attention_dq(*bwd), *ba.blocked_attention_dkv(*bwd))}
        torch.cuda.synchronize()
        _require(all(torch.isfinite(t).all() for t in (out, m, l, *routes["fused"],
                                                        *routes["three-pass"])),
                 f"blocked kernel output not finite at {B}x{H}x{S}x{hd}")
        ref, m_ref, l_ref = ba.blocked_fwd_reference(q, k, v, start, end, None, ks)
        bad_out = None
        if rate and dtype_name == "bfloat16":
            bad_out = ba.blocked_fwd_reference(
                q, k, v, start, end, None, _neighbour_keep(seed, B, H, rate, (0, S), (0, S)))[0]
        # each backward kernel on its own inputs: the kernel forward's (m, l,
        # delta) and the same q, k, v, do (bf16: the plain side rounds p * keep
        # and ds as the kernels do)
        plain_bwd = (q, k, v, do, m, l, delta, start, end, None, ks)
        want = ba.blocked_bwd_fused_reference(*plain_bwd)
        with planted(BLOCKED_FAULT, S):
            faulty = ba.blocked_bwd_fused_reference(*plain_bwd)
        del ks, plain_bwd
        ok = valid[:, None, :, None].expand_as(out)
        rows = valid[:, None, :].expand_as(m)
        held = _fwd_excess(out[ok], ref[ok], dtype_name)
        res = {"out": held[:2],
               "m": _excess(m[rows], m_ref[rows], STAT_TOL["m"]),
               "l": _excess(l[rows], l_ref[rows], STAT_TOL["l"])}
        fault, shares = {}, {"out": held[2]}
        if bad_out is not None:  # FWD_FAULT
            fault["out"] = _fwd_excess(out[ok], bad_out[ok], dtype_name)[1]
            del bad_out
        for route, got in routes.items():
            for name, a, w, f in zip(("dq", "dk", "dv"), got, want, faulty):
                err, excess, shares[f"{route} {name}"] = _tile_excess(a, w, dtype_name)
                res[f"{route} {name}"] = (err, excess)
                fault[f"{route} {name}"] = _tile_excess(a, f, dtype_name)[1]
        empty = bool(not out[~ok].any() and (m[~rows] == whk._NEG).all() and not l[~rows].any())
        print(f"blocked {B}x{H}x{S}x{hd} {dtype_name} rate {rate}, kernel vs plain (max abs err / "
              f"excess over tolerance): " + ", ".join(
                  f"{n} {e:.2e}/{x:.1e}" for n, (e, x) in res.items())
              + f"; share over KERNEL_TOL (out) / {BLOCKED_GRAD_TOL[dtype_name]}: "
              + ", ".join(f"{n} {x:.1e}" for n, x in shares.items())
              + f"; rows with no key all 0 (m -1e30, l 0): {empty}; control '{BLOCKED_FAULT}' "
              f"(out: '{FWD_FAULT}') excess: "
              + ", ".join(f"{n} {x:.1e}" for n, x in fault.items()))
        _require(empty and all(x <= 0 for _, x in res.values()),
                 f"blocked kernels disagree with the plain versions at {B}x{H}x{S}x{hd} "
                 f"{dtype_name} rate {rate}")
        _require(all(x > 0 for x in fault.values()),
                 f"the checks cannot tell '{BLOCKED_FAULT}' / '{FWD_FAULT}': {fault}")
        errs["fwd"] = max(errs["fwd"], res["out"][0])
        errs["fused"] = max([errs["fused"]] + [res[f"fused {n}"][0] for n in ("dq", "dk", "dv")])
        errs["dq"] = max(errs["dq"], res["three-pass dq"][0])
        errs["dkv"] = max([errs["dkv"]] + [res[f"three-pass {n}"][0] for n in ("dk", "dv")])

    for B, H, S, hd in BLOCKED_BF16:
        for rate in (0.0, RATE):
            case(B, H, S, hd, "bfloat16", rate)
    for B, H, S, hd in BLOCKED_FP32:
        case(B, H, S, hd, "float32", RATE)

    # one seed, one mask: at S = 1024 the blocked and whole-head kernels agree
    qkv, start, end, valid, dout = inputs(4, 24, 1024, 32, torch.bfloat16)
    res = []
    for fn in (ba.blocked_attention_qkv, whk.whole_head_attention_qkv):
        x = qkv.clone().requires_grad_()
        out = fn(x, start, end, seed, heads=24, dropout_rate=RATE)
        res.append((out, *torch.autograd.grad(out, (x,), dout)))
    (o1, g1), (o2, g2) = res
    e_o, x_o, _ = _fwd_excess(o1[valid], o2[valid], "bfloat16")
    e_g, x_g = _excess(g1, g2, GRAD_TOL["bfloat16"])
    print(f"blocked vs whole-head kernels 4x24x1024x32 bf16 rate {RATE}, same seed: out "
          f"{e_o:.2e}, dqkv {e_g:.2e}")
    _require(x_o <= 0 and x_g <= 0, "blocked and whole-head kernels differ at S=1024")
    del res, o1, o2, g1, g2

    def routes(S, fused, three):
        print(f"backward routes at S={S}: fused {fused:.4f} ms, three-pass {three:.4f} ms "
              f"(fused/three-pass {fused / three:.3f}); FUSED_MAX = {ba.FUSED_MAX} takes the "
              f"{'fused' if S <= ba.FUSED_MAX else 'three-pass'} route")

    times = {}
    for B, H, S, hd in BLOCKED_TIMED:  # full rows, bf16, rate 0.1, in turns
        qkv, start, end, _, dout = inputs(B, H, S, hd, torch.bfloat16, full_rows=True)
        q, k, v = whk._qkv_views("qkv", (qkv,), H)
        do = whk._heads4(dout, H)
        ks = ba.dropout_keep_scale(seed, B, H, S, RATE)
        out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, RATE)
        bwd = (q, k, v, do, m, l, ba.row_delta(do, out), start, end)
        it = max(2, 10 * 2048 // S)
        runs = {
            "fwd": (lambda: ba.blocked_attention_fwd(q, k, v, start, end, seed, None, RATE),
                    lambda: ba.blocked_fwd_reference(q, k, v, start, end, None, ks)),
            "fused": (lambda: ba.blocked_attention_bwd_fused(*bwd, seed, None, RATE),
                      lambda: ba.blocked_bwd_fused_reference(*bwd, None, ks)),
            "dq": (lambda: ba.blocked_attention_dq(*bwd, seed, None, RATE),
                   lambda: ba.blocked_dq_reference(*bwd, None, ks)),
            "dkv": (lambda: ba.blocked_attention_dkv(*bwd, seed, None, RATE),
                    lambda: ba.blocked_dkv_reference(*bwd, None, ks)),
        }
        pairs = _pairs(start, end, S, H)
        bounds = _attention_bounds(pairs, B, H, S, hd, 2)
        flops = {"fwd": 4 * hd * pairs, "fused": 10 * hd * pairs, "dq": 6 * hd * pairs,
                 "dkv": 8 * hd * pairs, "mask": 0}
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do, RATE, it)
        library = {"fwd": lib_fwd, "fused": lib_bwd, "dq": lib_bwd, "dkv": lib_bwd}
        if S == BLOCKED_TIMED[0][2]:  # the mask kernel (#5, #10) at the `long` shape
            runs["mask"] = (lambda: ba.dropout_keep_scale(seed, B, H, S, RATE),
                            lambda: whk.dropout_keep_scale_reference(seed, B, H, S, RATE))
            bounds["mask"], library["mask"] = _bound(0, B * H * S * S * 4), None
        times[S] = {}
        for name, (kernel, plain) in runs.items():
            p1, k1, k2, p2 = (_time_ms(f, n) for f, n in ((plain, 2), (kernel, it), (kernel, it),
                                                          (plain, 2)))
            times[S][name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                              "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                              "library_ms": library[name]}
            if flops[name]:  # the attention tiles
                times[S][name]["tflops"] = _tflops(flops[name], (k1 + k2) / 2)
            lib = "-" if library[name] is None else f"{library[name]:.4f} ms"
            print(f"blocked {name} {B}x{H}x{S}x{hd} bf16 rate {RATE}, full rows: kernel "
                  f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA {lib}, bound "
                  f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), "
                  f"{_tflops(flops[name], (k1 + k2) / 2):.1f} TFLOP/s ({card})")
        routes(S, times[S]["fused"]["ms"], times[S]["dq"]["ms"] + times[S]["dkv"]["ms"])
        del ks, qkv, dout, out, m, l, bwd, runs
        torch.cuda.empty_cache()
    for B, H, S, hd in BLOCKED_ROUTES_ONLY:  # the two routes alone, no plain versions
        qkv, start, end, _, dout = inputs(B, H, S, hd, torch.bfloat16, full_rows=True)
        q, k, v = whk._qkv_views("qkv", (qkv,), H)
        do = whk._heads4(dout, H)
        out, m, l = ba.blocked_attention_fwd(q, k, v, start, end, seed, None, RATE)
        bwd = (q, k, v, do, m, l, ba.row_delta(do, out), start, end, seed, None, RATE)
        run_f = lambda: ba.blocked_attention_bwd_fused(*bwd)  # noqa: E731
        run_t = lambda: (ba.blocked_attention_dq(*bwd), ba.blocked_attention_dkv(*bwd))  # noqa: E731
        f1, t1, t2, f2 = (_time_ms(f, 2) for f in (run_f, run_t, run_t, run_f))  # in turns
        print(f"blocked backward routes {B}x{H}x{S}x{hd} bf16 rate {RATE}, full rows: fused "
              f"{f1:.4f}/{f2:.4f} ms, three-pass {t1:.4f}/{t2:.4f} ms ({card})")
        routes(S, (f1 + f2) / 2, (t1 + t2) / 2)
        del qkv, dout, out, m, l, bwd
        torch.cuda.empty_cache()
    return {"err": errs, "times": times,
            "check_launches": {n: f.launches for n, f in counters.items()}}


@contextlib.contextmanager
def planted(fault, S):
    """Within the block the plain blocked versions carry `fault` when it is
    one of the structure faults of LONG_STEP_FAULTS / LONG_STEP_LOSS_FAULTS
    (a dropped rescale; key tiles past the diagonal visited, the causal mask
    left to the loop bounds) or BLOCKED_FAULT (each row's keys from the
    start of its diagonal 32-key tile, the kernels' key tile, masked out)."""
    import torch

    from neko_tpu_torch.ops import blocked_attention as ba

    saved = {n: getattr(ba, n) for n in ("_online_update", "_key_tiles", "_tile_mask")}
    if fault == "running-max rescale alpha dropped":
        def no_alpha(m, l, acc, s, ok, v_blk, ks):
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new).masked_fill(~ok, 0.0)
            l = l + p.sum(-1, keepdim=True)
            if ks is not None:
                p = p * ks
            return m_new, l, acc + torch.matmul(p.to(v_blk.dtype).float(), v_blk.float())

        ba._online_update = no_alpha
    elif fault == "key tiles above the diagonal included":
        tile_mask = saved["_tile_mask"]

        def window_only_above_diagonal(r0, r1, c0, c1, start, end):
            ok = tile_mask(r0, r1, c0, c1, start, end)
            if c0 < r1:
                return ok
            col = torch.arange(c0, c1, device=start.device)
            return ((col >= start.long()[:, None, None, None])
                    & (col < end.long()[:, None, None, None])).expand_as(ok)

        ba._key_tiles = lambda r1: range(0, S, ba.BLOCK)
        ba._tile_mask = window_only_above_diagonal
    elif fault == BLOCKED_FAULT:
        tile_mask = saved["_tile_mask"]

        def diagonal_tile_skipped(r0, r1, c0, c1, start, end):
            row = torch.arange(r0, r1, device=start.device)[:, None]
            col = torch.arange(c0, c1, device=start.device)[None, :]
            return tile_mask(r0, r1, c0, c1, start, end) & (col < row // 32 * 32)

        ba._tile_mask = diagonal_tile_skipped
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ba, n, f)


def plain_blocked_qkv_fn(fault=None):
    """A stand-in for ops.attention.attention_qkv: the plain blocked forward
    and backward (the fused plain version for S <= FUSED_MAX, else dq and
    dkv), in fp32 on the bf16 inputs with the mask from the mask kernel,
    rounded once; `fault` (one of LONG_STEP_FAULTS or LONG_STEP_LOSS_FAULTS)
    planted."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba

    class PlainBlockedQKV(torch.autograd.Function):
        @staticmethod
        def forward(ctx, qkv, start, end, seed, heads, rate):
            q, k, v = (t.float() for t in whk._qkv_views("qkv", (qkv,), heads))
            B, H, S, hd = q.shape
            ks = ba.dropout_keep_scale(seed, B, H, S, rate) if rate > 0 else None
            with planted(fault, S):
                out, m, l = ba.blocked_fwd_reference(q, k, v, start, end, None, ks)
            ctx.save_for_backward(qkv, start, end, seed, out, m, l)
            ctx.static = (heads, rate)
            return out.to(qkv.dtype).transpose(1, 2).reshape(B, S, H * hd)

        @staticmethod
        def backward(ctx, dout):
            qkv, start, end, seed, out, m, l = ctx.saved_tensors
            heads, rate = ctx.static
            q, k, v = (t.float() for t in whk._qkv_views("qkv", (qkv,), heads))
            B, H, S, hd = q.shape
            do = whk._heads4(dout, heads).float()
            ks = None
            if rate > 0 and fault != "keep mask not applied in the backward":
                ks = ba.dropout_keep_scale(seed, B, H, S, rate)
            delta = ba.row_delta(do, out)
            if fault == "delta taken as 0":
                delta = torch.zeros_like(delta)
            args = (q, k, v, do, m, l, delta, start, end, None, ks)
            with planted(fault, S):
                grads = (ba.blocked_bwd_fused_reference(*args) if S <= ba.FUSED_MAX
                         else (ba.blocked_dq_reference(*args), *ba.blocked_dkv_reference(*args)))
            dqkv = torch.cat([t.transpose(1, 2).reshape(B, S, H * hd) for t in grads], -1)
            return dqkv.to(qkv.dtype), None, None, None, None, None

    def attention_qkv(qkv, key_mask, *, heads, seed=None, rate=0.0):
        start, end = whk.mask_bounds_from_key_mask(key_mask)
        return PlainBlockedQKV.apply(qkv, start, end, seed, heads, rate)

    return attention_qkv


def long_train(card: str, dev="cuda") -> dict:
    """Phase 8.  -> launches per kernel in the timed long-context steps."""
    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    counters = {"fwd": ba.blocked_attention_fwd, "fused": ba.blocked_attention_bwd_fused,
                "dq": ba.blocked_attention_dq, "dkv": ba.blocked_attention_dkv,
                "whole-head fwd": whk.whole_head_attention,
                "whole-head bwd": whk.whole_head_attention_bwd, "mask": whk.dropout_keep_scale,
                "loss head": lk.fused_logz_tl}
    path = dict.fromkeys(counters, 0)
    peak = bench.PEAK_FLOPS.get(torch.cuda.get_device_name(0))

    def timed(config, warm, steps):
        name = config if isinstance(config, str) else f"k={config['context_len']}"
        cfg, ctx, state, batch, B = bench.setup(config, dev, SEED)
        _, warm_losses = bench.time_steps(ctx, state, batch, warm)
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        dt, losses = bench.time_steps(ctx, state, batch, steps)
        got = {n: f.launches for n, f in counters.items()}
        tokens = B * cfg.context_len
        fpt = bench.train_flops_per_token(cfg, bench.tgt_budget(B, cfg) / tokens)
        tps = tokens * steps / dt
        print(f"{name} train step {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h "
              f"k={cfg.context_len} B={B} bf16 dropout {cfg.dropout}: {dt * 1e3 / steps:.3f} "
              f"ms/step over {steps}, {tps:.1f} tokens/s, MFU "
              f"{tps * fpt / peak if peak else float('nan'):.4f} ({fpt / 1e6:.1f} MFLOP/token), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
        print(f"  losses: warm-up {warm_losses}, timed {losses}; launches {got}")
        _require(all(np.isfinite(warm_losses + losses)), f"{name}: non-finite loss {losses}")
        n = cfg.layers * steps
        fused = cfg.context_len <= ba.FUSED_MAX
        want = {"fwd": n, "fused": n if fused else 0, "dq": 0 if fused else n,
                "dkv": 0 if fused else n, "whole-head fwd": 0, "whole-head bwd": 0, "mask": 0,
                "loss head": _loss_chunks(batch) * steps}
        _require(got == want, f"{name}: the steps did not run the blocked kernels as "
                              f"FUSED_MAX={ba.FUSED_MAX} routes them (and the loss head once "
                              f"a loss chunk): {got}, expected {want}")
        for k in path:
            path[k] += got[k]
        del state
        torch.cuda.empty_cache()
        return cfg, ctx, batch

    cfg, ctx, batch = timed("long", 2, 3)
    timed("long4k", 1, 1)
    timed(LONG8K, 1, 1)
    sd = init_state_dict(cfg, SEED)

    def loss_and_grads(fn=None):
        return _step_loss_and_grads(ctx, sd, batch, fn)

    loss_k, grads_k = loss_and_grads()
    loss_p, grads_p = loss_and_grads(plain_blocked_qkv_fn())
    gap, dloss = _grad_gap(grads_k, grads_p), abs(loss_k - loss_p)
    del grads_k
    print(f"one long step, kernels vs plain blocked attention (same seeds and masks): loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (diff {dloss:.3e}, tolerance {LONG_STEP_LOSS_TOL:g}); "
          f"largest relative gradient error {gap:.3e} (tolerance {LONG_STEP_GRAD_TOL:g})")
    fault_gap, fault_dloss = {}, {}
    for f in dict.fromkeys(LONG_STEP_FAULTS + LONG_STEP_LOSS_FAULTS):
        loss_f, grads_f = loss_and_grads(plain_blocked_qkv_fn(f))
        fault_gap[f], fault_dloss[f] = _grad_gap(grads_f, grads_p), abs(loss_f - loss_p)
        print(f"control '{f}': loss diff {fault_dloss[f]:.3e}, largest relative gradient "
              f"error {fault_gap[f]:.3e}")
        del grads_f
    del grads_p
    _require(dloss <= LONG_STEP_LOSS_TOL and gap <= LONG_STEP_GRAD_TOL,
             f"the long kernel step disagrees with the plain step: {dloss}, {gap}")
    blind = [f for f in LONG_STEP_FAULTS if not fault_gap[f] > LONG_STEP_GRAD_TOL]
    blind += [f for f in LONG_STEP_LOSS_FAULTS if not fault_dloss[f] > LONG_STEP_LOSS_TOL]
    _require(not blind, f"the long step check cannot tell these planted faults: {blind}")

    opt = OptimizerConfig(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                          disable_cosine_decay=True)
    ctx2 = TrainContext(cfg, opt, device=dev, seed=SEED)
    state2 = ctx2.init_state()
    _, curve = bench.time_steps(ctx2, state2, batch, 20)
    print("long: 20 steps on one batch at lr 1e-3: loss "
          + ", ".join(f"{x:.4f}" for x in curve[::4]) + f", ..., {curve[-1]:.4f}")
    _require(all(np.isfinite(curve)) and curve[-1] < curve[0] - 1.0,
             f"the long loss did not fall: {curve}")
    return path


# ------------------------------------------------- sequence parallelism
def ring_kernels_vs_plain(card: str, dev="cuda", n=SEQ, bf16=RING_BF16, fp32=RING_FP32,
                          pairs=RING_PAIRS, timed=(("diagonal", (2, 2)), ("full", (3, 2))),
                          whole=True) -> dict:
    """Phase 9 (and phase 19 at the shards of 'seq' ranks): the pairs
    `pairs` of `n` shards at the `bf16` and `fp32` shapes, the whole ring
    against the blocked kernels (`whole`), the `timed` pairs of the first
    bf16 shape.  -> {"err": max abs error per kernel, "times": {kind:
    {kernel: JSON timing fields}}, "check_launches": launches per kernel
    here}."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import ring_kernel as rk

    counters = {"fwd": rk.ring_partial_fwd, "dq": rk.ring_partial_dq, "dkv": rk.ring_partial_dkv}
    for f in counters.values():
        f.launches = 0
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    seed = torch.tensor([SEED + 41], dtype=torch.int32, device=dev)
    errs = dict.fromkeys(counters, 0.0)

    def inputs(B, H, S_l, hd, dtype, full_rows=False):
        """One global problem of n shards: a full row and rows left-padded
        from inside shard 1 and shard 0 (one row: from inside shard 1)."""
        S = n * S_l
        qkv = torch.randn(B, S, 3 * H * hd, device=dev, generator=g).to(dtype)
        starts = [0] * B if full_rows else [0, S_l + 300, S_l // 3][:B] if B > 1 else [S_l + 300]
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        end = torch.full((B,), S, dtype=torch.int32, device=dev)
        valid = _valid_rows(start, end, S)
        dout = torch.randn(B, S, H * hd, device=dev, generator=g).to(dtype) * valid[..., None]
        return qkv, start, end, dout

    def ring_forward(qkv, start, end, H, rate):
        """The kernel ring forward.  -> (q, k, v views, out view, L)."""
        q, k, v = whk._qkv_views("qkv", (qkv,), H)
        out = torch.empty(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, dtype=qkv.dtype,
                          device=dev)
        L = rk._ring_fwd_local(q, k, v, whk._heads4(out, H), n,
                               (start, end, seed, q.shape[-1] ** -0.5, rate))
        return q, k, v, whk._heads4(out, H), L

    def case(B, H, S_l, hd, dtype_name, rate):
        qkv, start, end, dout = inputs(B, H, S_l, hd, getattr(torch, dtype_name))
        q, k, v, out, L = ring_forward(qkv, start, end, H, rate)
        do = whk._heads4(dout, H)
        chunk = lambda t, i: t.chunk(n, dim=2)[i]  # noqa: E731
        for i, j in pairs:
            q_off, k_off = i * S_l, j * S_l
            qi, kj, vj, doi = chunk(q, i), chunk(k, j), chunk(v, j), chunk(do, i)
            delta = ba.row_delta(doi, chunk(out, i))
            rest = (q_off, k_off, start, end, seed, None, rate)
            acc, m, l = rk.ring_partial_fwd(qi, kj, vj, *rest)
            dq = rk.ring_partial_dq(qi, kj, vj, doi, L[i], delta, *rest)
            dk, dv = rk.ring_partial_dkv(qi, kj, vj, doi, L[i], delta, *rest)
            torch.cuda.synchronize()
            _require(all(torch.isfinite(t).all() for t in (acc, m, l, dq, dk, dv)),
                     f"ring kernel output not finite at {B}x{H}x{S_l}x{hd} pair {i},{j}")
            # the plain versions on the same values (in bf16 they round
            # p * keep and ds as the kernels do), the pair's window of the
            # plain Philox, the kernel forward's own L and delta
            same = (qi, kj, vj, doi)

            def plain(k_off_plain, ks_cols=0):
                ks = (whk.dropout_keep_scale_reference(
                    seed, B, H, None, rate, rows=(q_off, q_off + S_l),
                    cols=(k_off_plain + ks_cols, k_off_plain + ks_cols + S_l))
                      if rate else None)
                at = (q_off, k_off_plain, start, end, None, ks)
                return (*rk.ring_partial_fwd_reference(*same[:3], *at),
                        rk.ring_partial_dq_reference(*same, L[i], delta, *at),
                        *rk.ring_partial_dkv_reference(*same, L[i], delta, *at))

            def held(want):
                acc_w, m_w, l_w, dq_w, dk_w, dv_w = want
                rows = l_w > 0  # rows that see a key of the pair
                scale = l_w.clamp_min(1.0)[..., None]
                res = {"acc": ((acc - acc_w).abs().max().item(),
                               ((acc - acc_w).abs() / scale).max().item()
                               - RING_ACC_TOL[dtype_name]),
                       "m": _excess(m.masked_fill(~rows, 0), m_w.masked_fill(~rows, 0),
                                    STAT_TOL["m"]),
                       "l": _excess(l, l_w, STAT_TOL["l"])}
                for name, a, w in (("dq", dq, dq_w), ("dk", dk, dk_w), ("dv", dv, dv_w)):
                    res[name] = _tile_excess(a, w, dtype_name)[:2]
                return res, rows

            res, rows = held(plain(k_off))
            empty = bool((m[~rows] == whk._NEG).all() and not l[~rows].any()
                         and not acc[~rows].any())
            line = ", ".join(f"{n} {e:.2e}/{x:.1e}" for n, (e, x) in res.items())
            line += f" (acc: {res['acc'][1] + RING_ACC_TOL[dtype_name]:.3e} of max(l, 1))"
            fault = ""
            if j:  # at shard 0 the planted offset is the true one
                bad, _ = held(plain(0))
                fault = f"; control '{RING_FAULT}' excess: " + ", ".join(
                    f"{n} {x:.1e}" for n, (_, x) in bad.items() if n not in ("m", "l"))
                # (every case has a left-padded row, so a past pair sees the
                # fault too: its key window moves with the offset)
                blind = [nm for nm, (_, x) in bad.items() if nm not in ("m", "l") and not x > 0]
                _require(not blind, f"the ring checks cannot tell '{RING_FAULT}' in {blind} "
                                    f"at pair {i},{j}")
            if rate and rows.any():
                bad, _ = held(plain(k_off, ks_cols=16))  # FWD_FAULT
                fault += f"; control '{FWD_FAULT}' acc excess {bad['acc'][1]:.1e}"
                _require(bad["acc"][1] > 0, f"the ring acc check cannot tell '{FWD_FAULT}' at "
                                            f"pair {i},{j}")
            print(f"ring pair q{i} kv{j} {B}x{H}x{S_l}x{hd} {dtype_name} rate {rate}, kernel vs "
                  f"plain (max abs err / excess over tolerance): {line}; rows with no key of "
                  f"the pair m -1e30, l 0, acc 0: {empty}{fault}")
            _require(empty and all(x <= 0 for _, x in res.values()),
                     f"ring kernels disagree with the plain versions at {B}x{H}x{S_l}x{hd} "
                     f"{dtype_name} rate {rate} pair {i},{j}")
            errs["fwd"] = max(errs["fwd"], res["acc"][0])
            errs["dq"] = max(errs["dq"], res["dq"][0])
            errs["dkv"] = max(errs["dkv"], res["dk"][0], res["dv"][0])

    for B, H, S_l, hd in bf16:
        for rate in (0.0, RATE):
            case(B, H, S_l, hd, "bfloat16", rate)
    for B, H, S_l, hd in fp32:
        case(B, H, S_l, hd, "float32", RATE)
    torch.cuda.empty_cache()

    B, H, S_l, hd = bf16[0]
    if whole:  # the ring as a whole against the blocked kernels: one seed, one mask
        qkv, start, end, dout = inputs(B, H, S_l, hd, torch.bfloat16)
        valid = _valid_rows(start, end, n * S_l)
        res = []
        for fn, kw in ((rk.ring_attention_qkv, {"n_shards": n}),
                       (ba.blocked_attention_qkv, {})):
            x = qkv.clone().requires_grad_()
            out = fn(x, start, end, seed, heads=H, dropout_rate=RATE, **kw)
            res.append((out, *torch.autograd.grad(out, (x,), dout)))
        (o1, g1), (o2, g2) = res
        e_o, x_o, _ = _fwd_excess(o1[valid], o2[valid], "bfloat16")
        grads = {name: _excess(a, b, GRAD_TOL["bfloat16"])
                 for name, a, b in zip(("dq", "dk", "dv"), g1.chunk(3, -1), g2.chunk(3, -1))}
        print(f"ring over {n} shards vs blocked kernels {B}x{H}x{n * S_l}x{hd} bf16 rate "
              f"{RATE}, same seed: out {e_o:.2e} (tolerance {KERNEL_TOL['bfloat16']}), "
              + ", ".join(f"{name} {e:.2e}" for name, (e, _) in grads.items())
              + f" (tolerance {GRAD_TOL['bfloat16']})")
        _require(x_o <= 0 and all(x <= 0 for _, x in grads.values()),
                 "the ring and the blocked kernels differ at the same seed")
        del res, o1, o2, g1, g2

    # times, in turns (plain, kernel, kernel, plain): full rows, bf16, rate
    # 0.1, on the `timed` pairs (phase 9: the diagonal pair and a full (past)
    # pair of the k = 8192 shards)
    times = {}
    qkv, start, end, dout = inputs(B, H, S_l, hd, torch.bfloat16, full_rows=True)
    q, k, v, out, L = ring_forward(qkv, start, end, H, RATE)
    do = whk._heads4(dout, H)
    act, row = B * S_l * H * hd, B * H * S_l * 4
    for kind, (i, j) in timed:
        q_off, k_off = i * S_l, j * S_l
        qi, kj, vj, doi, oi = (t.chunk(n, dim=2)[c] for t, c in
                               ((q, i), (k, j), (v, j), (do, i), (out, i)))
        delta = ba.row_delta(doi, oi)
        ks = whk.dropout_keep_scale_reference(seed, B, H, None, RATE, rows=(q_off, q_off + S_l),
                                              cols=(k_off, k_off + S_l))
        bufs, stat = rk._new_grads(qi), rk._new_state(qi)
        rest = (q_off, k_off, start, end, seed, None, RATE)
        plain_at = (q_off, k_off, start, end, None, ks)
        runs = {
            "fwd": (lambda: rk.ring_partial_fwd(qi, kj, vj, *rest, out=stat[2], m=stat[0],
                                                l=stat[1]),
                    lambda: rk.ring_partial_fwd_reference(qi, kj, vj, *plain_at)),
            "dq": (lambda: rk.ring_partial_dq(qi, kj, vj, doi, L[i], delta, *rest, dq=bufs[0]),
                   lambda: rk.ring_partial_dq_reference(qi, kj, vj, doi, L[i], delta, *plain_at)),
            "dkv": (lambda: rk.ring_partial_dkv(qi, kj, vj, doi, L[i], delta, *rest,
                                                dk=bufs[1], dv=bufs[2]),
                    lambda: rk.ring_partial_dkv_reference(qi, kj, vj, doi, L[i], delta,
                                                          *plain_at)),
        }
        # visible (row, key) pairs of this block pair, every head and row
        seen = B * H * (S_l * (S_l + 1) // 2 if i == j else S_l * S_l)
        flops = {"fwd": 4 * hd * seen, "dq": 6 * hd * seen, "dkv": 8 * hd * seen}
        bounds = {  # bf16 inputs, fp32 outputs and row stats
            "fwd": _bound(flops["fwd"], 3 * act * 2 + act * 4 + 2 * row),
            "dq": _bound(flops["dq"], 4 * act * 2 + act * 4 + 2 * row),
            "dkv": _bound(flops["dkv"], 4 * act * 2 + 2 * act * 4 + 2 * row),
        }
        lib_fwd, lib_bwd = _sdpa_ms(qi, kj, vj, doi, RATE, 10, causal=i == j)
        library = {"fwd": lib_fwd, "dq": lib_bwd, "dkv": lib_bwd}
        times[kind] = {}
        for name, (kernel, plain) in runs.items():
            p1, k1, k2, p2 = (_time_ms(f, n) for f, n in ((plain, 2), (kernel, 10), (kernel, 10),
                                                          (plain, 2)))
            times[kind][name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                                 "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                                 "library_ms": library[name]}
            times[kind][name]["tflops"] = _tflops(flops[name], (k1 + k2) / 2)
            print(f"ring {name} {kind} pair {B}x{H}x{S_l}x{hd} bf16 rate {RATE}, full rows: "
                  f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, SDPA "
                  f"{library[name]:.4f} ms ({'all three gradients' if name != 'fwd' else 'forward'}"
                  f"), bound {bounds[name][0]:.4f} ms ({bounds[name][1]}), "
                  f"{_tflops(flops[name], (k1 + k2) / 2):.1f} TFLOP/s ({card})")
        del ks
    # the torch passes between the kernels, per pair: the (m, l, acc) merge
    # and the three gradient adds
    stat2, bufs2 = rk._new_state(qi), rk._new_grads(qi)
    for t in (*stat, *stat2, *bufs, *bufs2):
        t.normal_()
    merge = _time_ms(lambda: rk.merge_partial(stat[0], stat[1], stat[2], *stat2), 10)
    adds = _time_ms(lambda: [a.add_(b) for a, b in zip(bufs, bufs2)], 10)
    print(f"ring torch passes per pair {B}x{H}x{S_l}x{hd}: merge of (m, l, acc) {merge:.4f} ms, "
          f"three gradient adds {adds:.4f} ms ({card})")
    torch.cuda.empty_cache()
    return {"err": errs, "times": times, "passes_ms": {"merge": merge, "adds": adds},
            "check_launches": {name: f.launches for name, f in counters.items()}}


@contextlib.contextmanager
def ring_planted(fault):
    """Within the block the ring schedule (ops/ring_kernel.py) carries one of
    RING_STEP_FAULTS."""
    import torch

    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import ring_kernel as rk

    saved = {(mod, n): getattr(mod, n) for mod, n in
             ((rk, "merge_partial"), (rk, "pair_visible"), (ba, "row_delta"), (rk, "_bwd_step"))}
    if fault == "running-max rescale dropped in the merge":
        def no_rescale(m, l, acc, m_p, l_p, acc_p):
            l.add_(l_p)
            acc.add_(acc_p)
            m.copy_(torch.maximum(m, m_p))

        rk.merge_partial = no_rescale
    elif fault == "farthest kv block skipped":
        visible = rk.pair_visible
        rk.pair_visible = lambda q_off, k_off, S_l: (visible(q_off, k_off, S_l)
                                                      and q_off - k_off < (SEQ - 1) * S_l)
    elif fault == "delta taken as 0":
        delta = ba.row_delta
        ba.row_delta = lambda do, o: torch.zeros_like(delta(do, o))
    elif fault == "dk, dv partials added to the q shard's block":
        step = rk._bwd_step

        def at_home(q, k, v, do, L, delta, q_off, k_off, grads, scratch, first, common):
            dq, dk, dv = grads
            if first:  # remember the shard's own sums, and add every later pair there
                at_home.own[q_off] = (dk, dv)
            step(q, k, v, do, L, delta, q_off, k_off, (dq, *at_home.own[q_off]), scratch,
                 first, common)

        at_home.own = {}
        rk._bwd_step = at_home
    elif fault is not None:
        raise ValueError(fault)
    try:
        yield
    finally:
        for (mod, n), f in saved.items():
            setattr(mod, n, f)


def seq_parallel_train(card: str, dev="cuda") -> dict:
    """Phase 10.  -> launches per kernel in the timed sequence-parallel
    steps."""
    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.ops import ring_kernel as rk
    from neko_tpu_torch.parallel.mesh import create_mesh
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    counters = {"ring fwd": rk.ring_partial_fwd, "ring dq": rk.ring_partial_dq,
                "ring dkv": rk.ring_partial_dkv, "fwd": ba.blocked_attention_fwd,
                "fused": ba.blocked_attention_bwd_fused, "dq": ba.blocked_attention_dq,
                "dkv": ba.blocked_attention_dkv, "whole-head fwd": whk.whole_head_attention,
                "whole-head bwd": whk.whole_head_attention_bwd, "mask": whk.dropout_keep_scale,
                "loss head": lk.fused_logz_tl}
    path = dict.fromkeys(counters, 0)
    peak = bench.PEAK_FLOPS.get(torch.cuda.get_device_name(0))
    pairs = SEQ * (SEQ + 1) // 2  # the kv blocks wholly in the future are skipped

    def timed(config, warm, steps):
        cfg, ctx, state, batch, B = bench.setup(config, dev, SEED, mesh_seq_axis=SEQ)
        name = f"k={cfg.context_len} over seq={SEQ}"
        _, warm_losses = bench.time_steps(ctx, state, batch, warm)
        torch.cuda.reset_peak_memory_stats()
        for f in counters.values():
            f.launches = 0
        dt, losses = bench.time_steps(ctx, state, batch, steps)
        got = {n: f.launches for n, f in counters.items()}
        tokens = B * cfg.context_len
        fpt = bench.train_flops_per_token(cfg, bench.tgt_budget(B, cfg) / tokens)
        tps = tokens * steps / dt
        print(f"{name} train step {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h B={B} "
              f"S_local={cfg.context_len // SEQ} bf16 dropout {cfg.dropout}: "
              f"{dt * 1e3 / steps:.3f} ms/step over {steps}, {tps:.1f} tokens/s, MFU "
              f"{tps * fpt / peak if peak else float('nan'):.4f} ({fpt / 1e6:.1f} MFLOP/token), "
              f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
        print(f"  losses: warm-up {warm_losses}, timed {losses}; launches {got}")
        _require(all(np.isfinite(warm_losses + losses)), f"{name}: non-finite loss {losses}")
        n = cfg.layers * steps * pairs
        want = dict.fromkeys(counters, 0) | {"ring fwd": n, "ring dq": n, "ring dkv": n,
                                             "loss head": _loss_chunks(batch) * steps}
        _require(got == want, f"{name}: the steps did not run the ring kernels layers x steps x "
                              f"{pairs} pairs times (and the loss head once a loss chunk): "
                              f"{got}, expected {want}")
        for k in path:
            path[k] += got[k]
        del state
        torch.cuda.empty_cache()
        return cfg, ctx, batch

    cfg, ctx, batch = timed(LONG8K, 1, 2)
    timed(LONG16K, 1, 2)

    # one k = 8192 step through the ring against the same step through the
    # blocked kernels: the same weights, batch and seeds, so the same masks
    sd = init_state_dict(cfg, SEED)
    blocked_ctx = TrainContext(cfg, ctx.opt_cfg, device=dev, seed=SEED)

    def loss_and_grads(context, fault=None):
        st = context.init_state({k: v.clone() for k, v in sd.items()})
        with ring_planted(fault):
            loss = context.loss_and_grads(st, batch).item()
        # (the k = 8192 batch has no image row: the patch embedder gets no gradient)
        return loss, {n: p.grad for n, p in st.model.named_parameters() if p.grad is not None}

    loss_r, grads_r = loss_and_grads(ctx)
    before = ba.blocked_attention_fwd.launches
    loss_b, grads_b = loss_and_grads(blocked_ctx)
    _require(ba.blocked_attention_fwd.launches == before + cfg.layers,
             "the step without a mesh did not run the blocked kernels")
    gap, dloss = _grad_gap(grads_r, grads_b), abs(loss_r - loss_b)
    del grads_r
    print(f"one k={cfg.context_len} step, ring over {SEQ} shards vs blocked kernels (same seeds "
          f"and masks): loss {loss_r:.6f} vs {loss_b:.6f} (diff {dloss:.3e}, tolerance "
          f"{RING_STEP_LOSS_TOL:g}); largest relative gradient error {gap:.3e} (tolerance "
          f"{RING_STEP_GRAD_TOL:g})")
    fault_gap, fault_dloss = {}, {}
    for f in dict.fromkeys(RING_STEP_FAULTS + RING_STEP_LOSS_FAULTS):
        loss_f, grads_f = loss_and_grads(ctx, f)
        fault_gap[f], fault_dloss[f] = _grad_gap(grads_f, grads_b), abs(loss_f - loss_b)
        print(f"control '{f}': loss diff {fault_dloss[f]:.3e}, largest relative gradient "
              f"error {fault_gap[f]:.3e}")
        del grads_f
    del grads_b
    _require(dloss <= RING_STEP_LOSS_TOL and gap <= RING_STEP_GRAD_TOL,
             f"the ring step disagrees with the blocked step: {dloss}, {gap}")
    blind = [f for f in RING_STEP_FAULTS if not fault_gap[f] > RING_STEP_GRAD_TOL]
    blind += [f for f in RING_STEP_LOSS_FAULTS if not fault_dloss[f] > RING_STEP_LOSS_TOL]
    _require(not blind, f"the ring step check cannot tell these planted faults: {blind}")

    opt = OptimizerConfig(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                          disable_cosine_decay=True)
    ctx2 = TrainContext(cfg, opt, device=dev, seed=SEED,
                        mesh=create_mesh(data=1, seq=SEQ))
    state2 = ctx2.init_state()
    _, curve = bench.time_steps(ctx2, state2, batch, 20)
    print(f"k={cfg.context_len} over seq={SEQ}: 20 steps on one batch at lr 1e-3: loss "
          + ", ".join(f"{x:.4f}" for x in curve[::4]) + f", ..., {curve[-1]:.4f}")
    _require(all(np.isfinite(curve)) and curve[-1] < curve[0] - 1.0,
             f"the sequence-parallel loss did not fall: {curve}")
    return path


# ------------------------------------------------------------- decoding
def plain_decode_attention(q, k, v, start, end, key_mask=None, fault=None):
    """The decode kernel's plain version, or that version with one of
    DECODE_FAULTS planted in it."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    if fault == "newest key excluded":
        end = torch.maximum(end - 1, start)
    elif fault == "start ignored":
        start = torch.zeros_like(start)
    elif fault == "mask holes ignored":
        key_mask = None
    elif fault == "scale 1/hd":
        return da.decode_cache_attention_reference(q, k, v, start, end, 1.0 / q.shape[-1],
                                                   key_mask=key_mask)
    return da.decode_cache_attention_reference(q, k, v, start, end, key_mask=key_mask)


@contextlib.contextmanager
def decode_attention_through(fn):
    """Within the block the model's decode attention runs `fn(q, k, v, start,
    end, key_mask)` in place of the kernel wrapper."""
    from neko_tpu_torch.ops import attention as attn_ops

    wrapper = attn_ops.decode_attention
    attn_ops.decode_attention = fn
    try:
        yield
    finally:
        attn_ops.decode_attention = wrapper


def _decode_rows(B, S):
    """(start, end) lists: a full cache, a left-padded start, one key, no key
    (start >= end), a wrapped ring (every row valid), a short window, a
    window in the middle, a full cache."""
    starts = [0, S // 3, 17, 500, 0, 0, 100, 0]
    ends = [S, S, 18, 400, S, 9, 700, S]
    return (starts * B)[:B], (ends * B)[:B]


def _split_edge_rows(B, S, n):
    """(start, end) lists of windows on and across the edges of a split into
    n shares: shorter than n, exactly n, one key, no key (empty and start >
    end), a start no multiple of 4 over the whole cache, 3n + 1 rows, the
    last 2n + 1 rows, the full cache, n + 1 rows across a 4-row boundary, a
    full cache (a share of it cleared when holed), a middle run."""
    starts = [37, 100, 515, 700, 5, 2, S - 2 * n - 1, 0, 900, 126, 0, S // 3 + 1]
    ends = [37 + max(n - 1, 1), 100 + n, 516, 700, S - 3, 2 + 3 * n + 1, S, S, 300,
            126 + n + 1, S, S - 1]
    return (starts * B)[:B], (ends * B)[:B]


def _split_n(q, S: int) -> int:
    """The cluster size #14 takes for q [B, H, hd] over a cache of capacity
    S (on a CPU tensor: an H100's, 132 SMs)."""
    from neko_tpu_torch.ops import decode_attention as da

    B, H, _ = q.shape
    return da.kernel_split(q, S) if q.is_cuda else da.split_count(B, H, S, 132)


def _case_windows(B, S, n, edges, holed, g, dev):
    """(start, end, mask) of a check case: `_decode_rows`' windows or the
    split-edge ones; holed: a third of each window's cache mask cleared,
    its ends kept, and on the split-edge windows one whole share cleared in
    each of two rows."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    st, en = _split_edge_rows(B, S, n) if edges else _decode_rows(B, S)
    start = torch.tensor(st, dtype=torch.int32, device=dev)
    end = torch.tensor(en, dtype=torch.int32, device=dev)
    if not holed:
        return start, end, None
    mask = torch.rand(B, S, device=dev, generator=g) >= 1 / 3
    rows = torch.arange(B, device=dev)
    mask[rows, start.long().clamp(max=S - 1)] = True
    mask[rows, (end.long() - 1).clamp(min=0)] = True
    if edges:
        lo, hi = da.split_bounds(start.clamp(min=0), end.clamp(max=S), n)
        for row in (4, 10):
            if row < B and n > 1:  # the second share, or the last but one
                r = min(1, n - 1) if row == 4 else n - 2
                mask[row, int(lo[row, r]):int(hi[row, r])] = False
    return start, end, mask


def split_decode(q, k, v, start, end, n, key_mask=None, scales=None, fault=None):
    """#14's split in plain torch (the shares of `split_bounds`, a partial
    each, merged), or that version with one of SPLIT_FAULTS planted in it.
    scales: (k_scale, v_scale) of an int8 cache."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    lo, hi = da.split_bounds(start.clamp(min=0), end.clamp(max=k.shape[2]), n)
    parts = [da.window_partials(q, k, v, lo[:, r], hi[:, r], key_mask, scales=scales)
             for r in range(n)]
    if fault == "one share of the window dropped" and n > 1:
        del parts[n // 2]
    elif fault == "shares merged without the max rescale":
        _, l, acc = (torch.stack(x).sum(dim=0) for x in zip(*parts))
        return torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1)[..., None],
                           0).to(q.dtype)
    return da.merge_partials(parts, q.dtype)


def decode_cases_vs_plain(cases, g, dev="cuda") -> float:
    """#14 against its plain version at each ((B, H, S, hd, dtype), holed[,
    edges]) case (`_decode_rows`' windows, or the split-edge windows; holed:
    a third of each window's cache mask cleared), with DECODE_FAULTS planted
    in the plain version and SPLIT_FAULTS in the plain split one: fails
    where the kernel disagrees or the cases cannot tell a fault.  -> the
    largest abs error."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    faults = DECODE_FAULTS + SPLIT_FAULTS
    worst, fault_excess = 0.0, {f: -1.0 for f in faults}
    for (B, H, S, hd, dtype_name), holed, *edges in cases:
        dtype = getattr(torch, dtype_name)
        q = torch.randn(B, H, hd, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(B, H, S, hd, device=dev, generator=g).to(dtype) for _ in range(2))
        n = _split_n(q, S)
        start, end, mask = _case_windows(B, S, n, bool(edges and edges[0]), holed, g, dev)
        out = da.decode_cache_attention(q, k, v, start, end, mask)
        ref = plain_decode_attention(q, k, v, start, end, mask)
        torch.cuda.synchronize()
        _require(torch.isfinite(out).all(), f"decode kernel output not finite at {B}x{H}x{S}x{hd}")
        seen = (start < end)[:, None, None]
        _require(torch.all(out.masked_fill(seen, 0) == 0), "decode rows without a key not 0")
        tol = KERNEL_TOL[dtype_name]
        err, excess = _excess(out.float() * seen, ref.float() * seen, tol)
        worst = max(worst, err)
        print(f"decode kernel vs plain B={B} H={H} S={S} hd={hd} {dtype_name}, cluster of {n}"
              f"{', split-edge windows' if edges and edges[0] else ''}"
              f"{', holed cache mask' if holed else ''}: max abs err "
              f"{err:.3e} (excess over tolerance {excess:.3e})")
        _require(excess <= 0, f"decode kernel disagrees at {B}x{H}x{S}x{hd} {dtype_name}")
        for f in faults:
            bad = (plain_decode_attention(q, k, v, start, end, mask, fault=f) if f in DECODE_FAULTS
                   else split_decode(q, k, v, start, end, n, mask, fault=f))
            fault_excess[f] = max(fault_excess[f], _excess(bad.float() * seen,
                                                           ref.float() * seen, tol)[1])
    for f in faults:
        print(f"control '{f}': largest excess over tolerance {fault_excess[f]:.3e}")
    blind = [f for f in faults if not fault_excess[f] > 0]
    _require(not blind, f"the decode check cannot tell these planted faults: {blind}")
    return worst


def _decode_ptxas(libs):
    """-> [(q, cache, hd, registers, spill bytes)] of every #14 instance,
    from nvcc's ptxas -v log."""
    import re

    rows, fn = [], None
    for line in libs["decode_attention"].with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Function properties for (\S*decode_attention_kernel\S*)", line):
            fn, spills = m.group(1), 0
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = int(m.group(1)) + int(m.group(2))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            args = re.search(r"decode_attention_kernelI(.*)Li(\d+)EEEv", fn)
            q = "bf16" if args.group(1).startswith("13__nv_bfloat16") else "fp32"
            cache = "int8" if args.group(1).endswith("a") else q
            rows.append((q, cache, int(args.group(2)), int(m.group(1)), spills))
            fn = None
    return rows


def decode_kernels_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 11, kernel part.  -> {"err": max abs error, "times": the JSON
    timing fields at B=8, "times_b1": at B=1, "shapes": at each of
    DECODE_TIMED, "check_launches": n}."""
    import torch
    import torch.nn.functional as F

    from neko_tpu_torch.ops import decode_attention as da

    da.decode_cache_attention.launches = 0
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = [(shape, False) for shape in DECODE_SHAPES]
    cases += [(shape, True) for shape in DECODE_HOLED_SHAPES]
    cases += [(shape, holed, True) for shape in DECODE_SPLIT_SHAPES for holed in (False, True)]
    worst = decode_cases_vs_plain(cases, g, dev)
    res = {"err": worst, "check_launches": da.decode_cache_attention.launches, "shapes": []}

    # device times on a full cache (torch.profiler: a call's host work takes
    # longer than the kernel), in turns (plain, kernel, kernel, plain), with
    # CUDA-event times beside them; SDPA with the boolean key mask as the
    # library yardstick.  Each call reads the next of enough copies of the
    # cache to fill the 50 MB L2 twice, as a decode step finds a layer's cache
    # after the other layers' have passed through it.
    for B, H, S, hd in DECODE_TIMED:
        q = torch.randn(B, H, hd, device=dev, generator=g).bfloat16()
        copies = -(-100_000_000 // (2 * B * H * S * hd * 2))
        caches = [[torch.randn(B, H, S, hd, device=dev, generator=g).bfloat16()
                   for _ in range(2)] for _ in range(copies)]
        turn = itertools.cycle(caches)
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        end = torch.full((B,), S, dtype=torch.int32, device=dev)
        mask = da.key_window(S, start, end)
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)  # the cache mask, as decoding
        run_k = lambda: da.decode_cache_attention(q, *next(turn), start, end, valid)  # noqa: E731
        run_p = lambda: da.decode_cache_attention_reference(  # noqa: E731
            q, *next(turn), start, end, key_mask=valid)
        run_l = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], *next(turn), attn_mask=mask)
        p1, k1, k2, p2 = (_device_ms(f) for f in (run_p, run_k, run_k, run_p))
        lib = _device_ms(run_l)
        ev_k, ev_p, ev_l = (_time_ms(f, 50) for f in (run_k, run_p, run_l))
        keys = B * H * S
        bound = _bound(4 * hd * keys, (2 * keys * hd + 2 * B * H * hd) * 2 + B * S)
        n = _split_n(q, S)
        del caches
        print(f"decode B={B} H={H} S={S} hd={hd} bf16, full cache ({copies} copies in turn), "
              f"cluster of {n}, device time: kernel "
              f"{k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, SDPA (boolean mask) "
              f"{lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
              f"{bound[0] / ((k1 + k2) / 2):.3f} of it); CUDA events over 50 calls: "
              f"kernel {ev_k:.4f}, plain {ev_p:.4f}, SDPA {ev_l:.4f} ms ({card})")
        times = {"shape": [B, H, S, hd], "n": n, "ms": (k1 + k2) / 2,
                 "plain_ms": (p1 + p2) / 2, "bound_ms": bound[0], "bound_by": bound[1],
                 "library_ms": lib, "event_ms": ev_k}
        res["shapes"].append(times)
        if (H, S, hd) == (24, 1024, 32) and B in (8, 1):
            res["times" if B == 8 else "times_b1"] = {
                k: v for k, v in times.items() if k != "shape"}
    return res


def _teacher_forced_logits(gen, examples, tokens):
    """Last-step logits [B, V] of the generator's decode loop fed `tokens`
    ([B, T] int64 numpy, the tokens a generate_batch chose) instead of its own
    choices: prefill, then T - 1 decode steps."""
    import torch

    from neko_tpu_torch.data.batch import to_device_batch

    model, dev, S = gen.model, gen.device, gen.cfg.context_len
    arrays = gen.packer.pack_batch(examples, pad_side="right")
    lengths = arrays.pop("lengths")
    with torch.inference_mode():
        emb = model.embed_batch(to_device_batch(arrays, dev))
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(dev)
        pos = torch.as_tensor(lengths, dtype=torch.long, device=dev)
        logits, caches = model.prefill(emb, mask, last=pos - 1)
        toks = torch.as_tensor(tokens, device=dev)
        for i in range(toks.shape[1] - 1):
            logits = model.decode_step(model.embed_tokens(toks[:, i:i + 1]), pos, caches)[:, 0]
            pos = pos + 1
    return logits


def decode_generate(card: str, dev="cuda") -> dict:
    """Phase 11, generation part: generate_batch at bench_decode.py's shape
    through kernel #14 and through the plain decode attention (per-token ms
    in turns), and the last-step logits of the two, teacher-forced on the
    kernel run's tokens, with DECODE_LOGIT_FAULTS planted.  -> {"kernel_ms",
    "plain_ms" per token, "launches" of the kernel run}."""
    import torch

    from neko_tpu_torch import bench_decode
    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.ops import decode_attention as da

    cfg = ModelConfig(**dict(FLAGSHIP, max_patches=0, dropout=0.0))
    gen = Generator(build_model(cfg, init_state_dict(cfg, SEED), dev), seed=SEED)
    rng = np.random.RandomState(SEED)
    B, P, T = DECODE_BENCH["B"], DECODE_BENCH["prompt"], DECODE_BENCH["new"]
    examples = [{"text": list(rng.randint(1, cfg.text_tokens, size=P))} for _ in range(B)]
    ts = cfg.token_space
    kw = dict(start=ts.start("text"), end=ts.end("text"), return_logits=False)

    def per_token():  # the package harness's timing loop, 3 runs
        return bench_decode.measure(gen, examples, T, runs=3)["per_token_ms"]

    da.decode_cache_attention.launches = 0
    (tokens,) = gen.generate_batch(examples, max_new_tokens=T, **kw)
    launches = da.decode_cache_attention.launches
    print(f"generate_batch B={B}, {P}-token prompts, {T} new tokens: decode kernel launches "
          f"{launches} ({T - 1} decode steps x {cfg.layers} layers)")
    _require(launches == (T - 1) * cfg.layers, f"decode launches {launches}")
    with decode_attention_through(plain_decode_attention):
        p1 = per_token()
    k1, k2 = per_token(), per_token()
    with decode_attention_through(plain_decode_attention):
        p2 = per_token()
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"decode per token at B={B} (generate_batch, host clock, median of 3 runs less the "
          f"1-token run, in turns): kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} "
          f"ms ({card})")

    V = cfg.vocab_size
    got = _teacher_forced_logits(gen, examples, tokens)[:, :V]
    with decode_attention_through(plain_decode_attention):
        want = _teacher_forced_logits(gen, examples, tokens)[:, :V]
    err = (got - want).abs().max().item()
    print(f"last-step logits after {T - 1} decode steps, kernel vs plain decode attention: "
          f"max abs err {err:.3e} (tolerance {DECODE_LOGIT_TOL:g}; logit std "
          f"{want.std().item():.3f})")
    fault_err = {}
    for f in DECODE_LOGIT_FAULTS:
        with decode_attention_through(lambda *a, f=f: plain_decode_attention(*a, fault=f)):
            bad = _teacher_forced_logits(gen, examples, tokens)[:, :V]
        fault_err[f] = (bad - want).abs().max().item()
        print(f"control '{f}': logits max abs err {fault_err[f]:.3e}")
    _require(torch.isfinite(got).all(), "decode logits not finite")
    _require(err <= DECODE_LOGIT_TOL, f"decode logits disagree: {err}")
    blind = [f for f in DECODE_LOGIT_FAULTS if not fault_err[f] > DECODE_LOGIT_TOL]
    _require(not blind, f"the decode logits check cannot tell these planted faults: {blind}")
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "launches": launches}


# ------------------------------------------------------------- loss head
def _loss_head_build(libs) -> dict:
    """Registers and spills of kernel #15 (ptxas) and its count of HGMMA
    (wgmma) and UTMALDG (TMA load) instructions in the built library's SASS
    (cuobjdump)."""
    import os
    import re
    import shutil
    import subprocess

    so = libs["fused_logz_tl"]
    log = so.with_suffix(".log").read_text()
    at = log.index("Function properties for", log.index("fused_logz_tl_kernel"))
    props = log[at:at + 600]
    regs = int(re.search(r"Used (\d+) registers", props).group(1))
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", props)[:2]]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    _require(os.path.exists(cuobjdump), "cuobjdump not found")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return {"registers": regs, "spill_bytes": sum(spills),
            "serialized": "C7515" in log,  # ptxas: wgmma serialized
            "hgmma": len(re.findall(r"\bHGMMA\.", sass)),
            "utmaldg": len(re.findall(r"\bUTMALDG\.", sass))}


def loss_kernel_vs_plain(card: str, libs, dev="cuda") -> dict:
    """Phase 12.  -> {"err", "launches" (checks), "build" (ptxas, SASS),
    and the JSON timing fields at the first (4096-row) chunk, the other
    chunks' under "chunk_<rows>"}."""
    import inspect

    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.ops import losses

    build = _loss_head_build(libs)
    print(f"loss head kernel: {build['registers']} registers a thread, "
          f"{build['spill_bytes']} bytes spilled, "
          f"{build['hgmma']} HGMMA and {build['utmaldg']} UTMALDG instructions in its SASS"
          f"{', wgmma SERIALIZED (ptxas C7515)' if build['serialized'] else ''}")
    _require(build["hgmma"] > 0 and build["utmaldg"] > 0,
             "the loss head kernel has no wgmma or no TMA load in its SASS")
    _require(build["spill_bytes"] == 0 and not build["serialized"],
             "the loss head kernel spills registers or serializes its wgmma")
    cfg = bench.model_config("flagship")
    V, valid, D = cfg.padded_vocab_size, cfg.vocab_size, cfg.embed_dim
    budget = bench.tgt_budget(TRAIN["B"], cfg)
    size = inspect.signature(losses.gathered_masked_xent).parameters["chunk_size"].default
    chunks = [min(size, budget - i) for i in range(0, budget, size)]  # the gathered loss's
    # the loss without loss_pos (chunked_masked_xent) takes B x 256-row
    # chunks: 4,096 rows at B = 16 (the first gathered chunk's shape) and 256
    # at B = 1, timed but not held to beating the route: the dispatch rests
    # on the flagship's gathered chunks
    rows = inspect.signature(losses.chunked_masked_xent).parameters["chunk_size"].default
    shapes = [(n, True) for n in chunks] + [(rows, False)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    W = (torch.randn(V, D, device=dev, generator=g) * 0.02).bfloat16()
    lk.fused_logz_tl.launches = 0
    res, worst = {"build": build}, 0.0
    for n, gathered in shapes:
        x = torch.randn(n, D, device=dev, generator=g).bfloat16()
        t = torch.randint(0, valid, (n,), device=dev, generator=g)
        logz, tl = lk.fused_logz_tl(x, t, W, valid)
        want_logz, want_tl = lk.fused_logz_tl_reference(x, t, W, valid)
        torch.cuda.synchronize()
        _require(torch.isfinite(logz).all() and torch.isfinite(tl).all(), "loss kernel not finite")
        errs = [_excess(logz, want_logz, LOSS_TOL), _excess(tl, want_tl, LOSS_TOL)]
        worst = max(worst, *(e for e, _ in errs))
        print(f"loss head [{n}, {D}] x {V} (valid {valid}) bf16: logz, target logit max abs err "
              f"{errs[0][0]:.3e}, {errs[1][0]:.3e} vs the plain version in fp32 (tolerance "
              f"{LOSS_TOL[0]:g} + {LOSS_TOL[1]:g}*|plain|)")
        _require(all(x <= 0 for _, x in errs), f"loss kernel disagrees at {n} rows")
        x_tail = x.clone()
        x_tail[:, (D - 1) // 64 * 64:] = 0  # the last 64-deep slice of D
        faults = dict(zip(LOSS_FAULTS, (lk.fused_logz_tl_reference(x, t, W, None),
                                        lk.fused_logz_tl_reference(x, t + 1, W, valid),
                                        lk.fused_logz_tl_reference(x_tail, t, W, valid))))
        for f, (bad_logz, bad_tl) in faults.items():
            x1 = max(_excess(bad_logz, want_logz, LOSS_TOL)[1], _excess(bad_tl, want_tl, LOSS_TOL)[1])
            print(f"  control '{f}': excess over tolerance {x1:.3e}")
            _require(x1 > 0, f"the loss check cannot tell '{f}'")
        del x_tail, faults

        # times in turns; the library yardstick is the route the loss forward
        # took before kernel #15 (and takes for the shapes #15 refuses): the
        # cuBLAS product with fp32 logits, the padded columns filled,
        # logsumexp and gather
        route = lambda: lk.logits_logz_tl(x, t, W, valid)  # noqa: E731
        run_k = lambda: lk.fused_logz_tl(x, t, W, valid)  # noqa: E731
        run_p = lambda: lk.fused_logz_tl_reference(x, t, W, valid)  # noqa: E731
        r1, k1, k2, r2 = (_time_ms(f, 10) for f in (route, run_k, run_k, route))
        p1, p2 = _time_ms(run_p, 5), _time_ms(run_p, 5)
        # only the valid columns enter logz and the target logit: the padded
        # rows of W are work the function does not need
        flops = 2 * n * D * valid
        bound = _bound(flops, (n * D + valid * D) * 2 + n * 4 + 2 * n * 4)
        ms = (k1 + k2) / 2
        print(f"loss head [{n}, {D}] x {V}: kernel {k1:.4f} / {k2:.4f} ms "
              f"({_tflops(flops, ms):.1f} TFLOP/s, {bound[0] / ms:.3f} of the bound), loss route "
              f"(cuBLAS fp32 logits + logsumexp + gather) {r1:.4f} / {r2:.4f} ms, plain (fp32 "
              f"product) {p1:.4f} / {p2:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) ({card})")
        _require(not gathered or max(k1, k2) < min(r1, r2),
                 f"the loss head kernel is slower than the route it replaced at {n} rows")
        timing = {"ms": ms, "plain_ms": (p1 + p2) / 2, "bound_ms": bound[0],
                  "bound_by": bound[1], "library_ms": (r1 + r2) / 2,
                  "tflops": _tflops(flops, ms)}
        if "ms" not in res:
            res.update(timing)
        else:
            res[f"chunk_{n}"] = timing
        del x, t, logz, tl, want_logz, want_tl
    res["err"], res["launches"] = worst, lk.fused_logz_tl.launches
    return res


# ----------------------------------------------------------- fused AdamW
def _adamw_args(ctx, state, max_norm, fault=None):
    """(params, grads, scale, kwargs) of `fused_adamw_apply` for the next
    update of a FusedAdamW state, with one of ADAMW_FAULTS planted."""
    import torch

    from neko_tpu_torch.ops import fused_adamw as fa

    opt, oc = state.optimizer, ctx.opt_cfg
    params = list(state.model.parameters())
    grads = [p.grad for p in params]
    bc1, bc2 = fa.bias_corrections(opt.count, oc.beta_1, oc.beta_2)
    if fault == "bias correction dropped":
        bc1 = bc2 = 1.0
    scale = fa.clip_scale_from_norm(fa.global_norm(grads), max_norm)
    if fault == "clip scale ignored":
        scale = torch.ones_like(scale)
    kw = dict(lr=ctx.schedule(opt.count), b1=oc.beta_1, b2=oc.beta_2, eps=oc.adam_eps,
              wd=oc.weight_decay, bc1=bc1, bc2=bc2)
    return params, grads, scale, kw


def fused_adamw_check(card: str, dev="cuda") -> dict:
    """Phase 13.  -> {"err" (largest relative error), "check_launches",
    "launches" of the timed fused train steps, and the JSON timing fields}."""
    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import fused_adamw as fa
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    cfg, ctx, state, batch, B = bench.setup("flagship", dev, SEED, fused_adamw=True)
    bench.time_steps(ctx, state, batch, 2)       # moments after two updates
    ctx.loss_and_grads(state, batch)              # the gradients of a real step
    params = list(state.model.parameters())
    n_params = sum(p.numel() for p in params)
    norm = fa.global_norm([p.grad for p in params]).item()
    max_norm = min(ctx.opt_cfg.grad_norm_clip, norm / 2)  # below the norm: the clip acts
    mu, nu = state.optimizer.fused_state()[1:]
    print(f"fused AdamW on the flagship tree: {len(params)} tensors, {n_params} parameters, "
          f"gradient norm {norm:.4f} (max_norm {max_norm:.4f}), count {state.optimizer.count}")

    def run(apply, fault=None):
        ps, grads, scale, kw = _adamw_args(ctx, state, max_norm, fault)
        ps = [p.detach().clone() for p in ps]
        m, v = [t.clone() for t in mu], [t.clone() for t in nu]
        apply(ps, grads, m, v, scale, **kw)
        return ps + m + v

    def rel_err(got, want):
        return max(((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
                   for a, b in zip(got, want))

    fa.fused_adamw_apply.launches = 0
    got = run(fa.fused_adamw_apply)
    want = run(fa.fused_adamw_apply_reference)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    unequal = sum(int((a != b).sum().item()) for a, b in zip(got, want))
    print(f"fused AdamW kernel vs plain: largest relative error of params, mu, nu {err:.3e} "
          f"(tolerance {ADAMW_RTOL:g}), absolute {abs_err:.3e}; {unequal} of {3 * n_params} "
          f"values not bit-equal")
    _require(all(torch.isfinite(t).all() for t in got), "fused AdamW output not finite")
    _require(err <= ADAMW_RTOL, f"fused AdamW kernel disagrees: {err}")
    for f in ADAMW_FAULTS:
        bad = run(fa.fused_adamw_apply_reference, f)
        e = rel_err(bad, want)
        print(f"control '{f}': largest relative error {e:.3e}")
        _require(e > ADAMW_RTOL, f"the AdamW check cannot tell '{f}'")
        del bad
    del got, want

    # times, in turns; the library yardstick is torch's fused AdamW (no clip)
    # on a copy of the tree with the same gradients
    ps, grads, scale, kw = _adamw_args(ctx, state, max_norm)
    ps = [p.detach().clone() for p in ps]
    m, v = [t.clone() for t in mu], [t.clone() for t in nu]
    run_k = lambda: fa.fused_adamw_apply(ps, grads, m, v, scale, **kw)  # noqa: E731
    run_p = lambda: fa.fused_adamw_apply_reference(ps, grads, m, v, scale, **kw)  # noqa: E731
    p1, k1, k2, p2 = (_time_ms(f, 10) for f in (run_p, run_k, run_k, run_p))
    lib_params = [torch.nn.Parameter(p.detach().clone()) for p in params]
    for lp, p in zip(lib_params, params):
        lp.grad = p.grad.clone()
    lib_opt = torch.optim.AdamW(lib_params, lr=kw["lr"], betas=(kw["b1"], kw["b2"]),
                                eps=kw["eps"], weight_decay=kw["wd"], fused=True)
    lib = _time_ms(lib_opt.step, 10)
    bound = _bound(20 * n_params, 28 * n_params)
    print(f"fused AdamW over {n_params} parameters: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{p1:.4f} / {p2:.4f} ms, library (torch.optim.AdamW(fused=True), no clip) "
          f"{lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) ({card})")
    res = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound[0],
           "bound_by": bound[1], "library_ms": lib, "err": abs_err, "rel_err": err,
           "check_launches": fa.fused_adamw_apply.launches}
    del ps, grads, m, v, run_k, run_p, lib_params, lib_opt

    # the optimizer half alone, both routes (CUDA events around apply_gradients)
    fused_opt_ms = bench.optimizer_ms(ctx, state, batch)
    cfg_d, ctx_d, state_d, _, _ = bench.setup("flagship", dev, SEED)
    bench.time_steps(ctx_d, state_d, batch, 2)  # AdamW makes its state at its first step
    default_opt_ms = bench.optimizer_ms(ctx_d, state_d, batch)
    del state_d
    print(f"optimizer half of the flagship step (norm + kernel / clip pass + torch AdamW): "
          f"fused {fused_opt_ms:.4f} ms, default {default_opt_ms:.4f} ms ({card})")
    res.update(optimizer_ms=fused_opt_ms, default_optimizer_ms=default_opt_ms)

    # the flagship train step with the fused optimizer
    torch.cuda.reset_peak_memory_stats()
    fa.fused_adamw_apply.launches = lk.fused_logz_tl.launches = 0
    steps = 5
    dt, losses = bench.time_steps(ctx, state, batch, steps)
    res["launches"], res["loss_launches"] = fa.fused_adamw_apply.launches, lk.fused_logz_tl.launches
    tokens = B * cfg.context_len
    fpt = bench.train_flops_per_token(cfg, bench.tgt_budget(B, cfg) / tokens)
    tps = tokens * steps / dt
    peak = bench.PEAK_FLOPS.get(torch.cuda.get_device_name(0))
    print(f"flagship train step with fused_adamw: {dt * 1e3 / steps:.3f} ms/step, {tps:.1f} "
          f"tokens/s, MFU {tps * fpt / peak if peak else float('nan'):.4f}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; fused AdamW launches "
          f"{res['launches']}, loss head launches {res['loss_launches']} over {steps} steps "
          f"({card})")
    _require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    _require(res["launches"] == steps, f"the steps did not run the fused AdamW kernel once each")
    _require(res["loss_launches"] == _loss_chunks(batch) * steps,
             f"the steps did not run the loss head once a loss chunk: {res['loss_launches']}")
    del state
    torch.cuda.empty_cache()

    # three steps on one batch at lr 1e-3: the fused route against the default
    sd = init_state_dict(cfg, SEED)
    opt = dict(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1, disable_cosine_decay=True)

    def three(fused):
        """-> (losses, the whole tree's update as one fp32 vector)."""
        c = TrainContext(cfg, OptimizerConfig(fused_adamw=fused, **opt), device=dev, seed=SEED)
        st = c.init_state({k: t.clone() for k, t in sd.items()})
        losses = [c.train_step(st, batch)[1].item() for _ in range(3)]
        return losses, torch.cat([(p.detach() - sd[n].to(dev)).flatten()
                                  for n, p in st.model.named_parameters()])

    def against(run, want):
        (lf, uf), (ld, ud) = run, want
        return max(abs(a - b) for a, b in zip(lf, ld)), ((uf - ud).norm() / ud.norm()).item()

    default, fused = three(False), three(True)
    dloss, gap = against(fused, default)
    noise = against(three(False), default)
    bias_corrections = fa.bias_corrections
    fa.bias_corrections = lambda count, b1, b2: (1.0, 1.0)  # the planted fault
    try:
        fault = against(three(True), default)
    finally:
        fa.bias_corrections = bias_corrections
    print(f"three steps at lr 1e-3, fused vs default AdamW route: losses {fused[0]} vs "
          f"{default[0]} (largest diff {dloss:.3e}, tolerance {FUSED_STEP_LOSS_TOL:g}); relative "
          f"L2 error of the tree's update {gap:.3e} (tolerance {FUSED_STEP_UPDATE_TOL:g}); the "
          f"default route against itself {noise[0]:.3e}, {noise[1]:.3e}; control 'bias "
          f"correction dropped' {fault[0]:.3e}, {fault[1]:.3e}")
    _require(dloss <= FUSED_STEP_LOSS_TOL and gap <= FUSED_STEP_UPDATE_TOL,
             f"the fused route disagrees with the default route: {dloss}, {gap}")
    _require(fault[0] > FUSED_STEP_LOSS_TOL and fault[1] > FUSED_STEP_UPDATE_TOL,
             f"the route check cannot tell 'bias correction dropped': {fault}")
    del default, fused

    c = TrainContext(cfg, OptimizerConfig(fused_adamw=True, **opt), device=dev, seed=SEED)
    st = c.init_state()
    _, curve = bench.time_steps(c, st, batch, 20)
    print("fused_adamw: 20 steps on one batch at lr 1e-3: loss "
          + ", ".join(f"{x:.4f}" for x in curve[::4]) + f", ..., {curve[-1]:.4f}")
    _require(all(np.isfinite(curve)) and curve[-1] < curve[0] - 1.0,
             f"the loss did not fall with fused_adamw: {curve}")
    return res


# ------------------------------------------------- the training entry point
def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _arrays_digest(arrays) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def trainer_recorder():
    """Within the block every Trainer records the digest of each batch it
    packs (in order; the first is init_state's draw), each step's loss (a
    device scalar, read after the run) and its queue wait and produce time."""
    from neko_tpu_torch.training.trainer import Trainer

    rec = {"stream": [], "losses": [], "wait_s": [], "produce_s": []}
    sample, step = Trainer._sample_arrays_locked, Trainer.train_step

    def sampled(self):
        arrays = sample(self)
        rec["stream"].append(_arrays_digest(arrays))
        return arrays

    def stepped(self):
        loss, logs = step(self)
        rec["losses"].append(loss)
        rec["wait_s"].append(logs["time/sample_batch"])
        rec["produce_s"].append(logs.get("time/host_pipeline", 0.0))
        return loss, logs

    Trainer._sample_arrays_locked, Trainer.train_step = sampled, stepped
    try:
        yield rec
    finally:
        Trainer._sample_arrays_locked, Trainer.train_step = sample, step


@contextlib.contextmanager
def model_call_counter():
    """Counts NekoModel.prefill / decode_step calls within the block, and
    under "<name>_layers" the layers they run (a truncated draft counts its
    own): what #1 and #14 launch."""
    from neko_tpu_torch.models.policy import NekoModel

    names = ("prefill", "decode_step")
    calls = {k: 0 for name in names for k in (name, name + "_layers")}
    orig = {name: getattr(NekoModel, name) for name in names}

    def counted(name):
        def call(self, *a, **kw):
            calls[name] += 1
            calls[name + "_layers"] += self.cfg.layers
            return orig[name](self, *a, **kw)
        return call

    for name in names:
        setattr(NekoModel, name, counted(name))
    try:
        yield calls
    finally:
        for name, fn in orig.items():
            setattr(NekoModel, name, fn)


def _launch_counters():
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import decode_attention as da
    from neko_tpu_torch.ops import fused_adamw as fa
    from neko_tpu_torch.ops import loss_kernel as lk

    return {"fwd": whk.whole_head_attention, "bwd": whk.whole_head_attention_bwd,
            "mask": whk.dropout_keep_scale, "decode": da.decode_cache_attention,
            "loss": lk.fused_logz_tl, "adamw": fa.fused_adamw_apply}


def train_cli(argv, save_dir):
    """One in-process `python -m neko_tpu_torch.cli.train` run.  -> (the
    Trainer, the record, the launch counts, the model calls)."""
    import gc

    import torch

    from neko_tpu_torch.cli import train as cli_train

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    with trainer_recorder() as rec, model_call_counter() as calls:
        trainer = cli_train.main(list(argv) + ["--save_dir", str(save_dir)])
    launches = {k: fn.launches for k, fn in counters.items()}
    rec["losses"] = [float(x) for x in rec["losses"]]
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return trainer, rec, launches, calls


def _iteration_logs(exp_dir):
    with open(f"{exp_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


@contextlib.contextmanager
def recording_decode(gen, record, forced=None):
    """Within the block `gen._decode` records each call's tokens and window
    logits ([B, T] and [B, T, W]).  With `forced` (the records of another
    run) it feeds the tokens of the matching call instead of its own choices
    (teacher forcing; the rollout's decode: no ring, no inner positions, no
    per-step limits, every token fed)."""
    import torch

    orig = gen._decode

    def decode(last_logits, caches, pos, next_pos, *, n_steps, start, end, **kw):
        if forced is None:
            toks, windows, _ = orig(last_logits, caches, pos, next_pos, n_steps=n_steps,
                                    start=start, end=end, **{**kw, "return_logits": True})
            record.append((toks, windows))
            return toks, None, None
        _require(kw.get("feed_last") and not kw.get("ring") and not kw.get("with_pos")
                 and kw.get("limits") is None, f"teacher forcing of another decode: {kw}")
        toks = forced[len(record)][0]
        windows = []
        for i in range(n_steps):
            windows.append(last_logits[:, start:end + 1])
            last_logits = gen.model.decode_step(gen.model.embed_tokens(toks[:, i:i + 1]), pos,
                                                caches)[:, 0]
            pos = pos + 1
        record.append((toks, torch.stack(windows, dim=1)))
        return toks, None, None

    gen._decode = decode
    try:
        yield record
    finally:
        del gen._decode


@contextlib.contextmanager
def recording_prefill(gen, record):
    """Within the block `gen.model.prefill` records the logits at each row's
    last prompt position (`RolloutSession.start` asks for position 0 and
    drops them)."""
    orig = gen.model.prefill

    def prefill(emb, mask, last=None):
        logits, caches = orig(emb, mask, last=(mask.sum(1) - 1).clamp(min=0))
        record.append(logits)
        return logits, caches

    gen.model.prefill = prefill
    try:
        yield record
    finally:
        del gen.model.prefill


def rollout_vs_plain(gen, steps: int):
    """One continuous-env episode of `steps` env steps (more than the ring
    holds) through `RolloutSession` on the kernels, then the same session on
    the plain prefill and decode attention fed the kernel run's observations
    and action tokens, and again with each of ROLLOUT_PREFILL_FAULTS and
    ROLLOUT_DECODE_FAULTS planted in the plain side.  -> ((max abs error of
    the prompt's prefill logits, of the first action token's logits (after
    the extend), of the later ones (after decode steps)), {fault: the same
    three}, ring timesteps, rollout step ms)."""
    import torch

    from neko_tpu_torch.envs.synthetic import load_synthetic
    from neko_tpu_torch.tasks.control import ControlTask

    env, ds = load_synthetic("neko-synth-continuous-v0")
    env.horizon = steps
    task = ControlTask("neko-synth-continuous-v0", env, ds, context_len=gen.cfg.context_len,
                       seed=SEED)
    prompt = task._sample_eval_prompt(gen)
    observations = []
    kernel, kernel_prefill = [], []
    with torch.inference_mode(), recording_decode(gen, kernel), \
            recording_prefill(gen, kernel_prefill):
        sess = task._make_session(gen)
        sess.start([prompt])
        obs, _ = env.reset(seed=SEED)
        _sync(gen.device)
        t0 = time.perf_counter()
        done = False
        while not done:
            new = task._obs_entries(np.asarray(obs)[None])
            observations.append(new)
            action = sess.step([new])[0]
            obs, _, term, trunc, _ = env.step(task._env_action(action))
            done = term or trunc
        _sync(gen.device)
        step_ms = (time.perf_counter() - t0) * 1e3 / len(observations)

    def plain(prefill_fault=None, decode_fault=None):
        record, record_prefill = [], []
        with torch.inference_mode(), recording_decode(gen, record, forced=kernel), \
                recording_prefill(gen, record_prefill), \
                prefill_attention_through(
                    lambda *a: plain_prefill_attention(*a, fault=prefill_fault)), \
                decode_attention_through(
                    lambda *a: plain_decode_attention(*a, fault=decode_fault)):
            sess = task._make_session(gen)
            sess.start([prompt])
            for new in observations:
                sess.step([new])
        pre = (kernel_prefill[0] - record_prefill[0]).abs().max().item()
        first = max((k[1][:, 0] - p[1][:, 0]).abs().max().item()
                    for k, p in zip(kernel, record))
        later = max((k[1][:, 1:] - p[1][:, 1:]).abs().max().item()
                    for k, p in zip(kernel, record))
        return pre, first, later

    sound = plain()
    faults = {f"prefill: {f}": plain(prefill_fault=f) for f in ROLLOUT_PREFILL_FAULTS}
    faults.update({f"decode: {f}": plain(decode_fault=f) for f in ROLLOUT_DECODE_FAULTS})
    return sound, faults, sess.L // sess.tpt, step_ms


def train_entry_point(card: str, bench_step_ms: float, workdir, dev="cuda") -> dict:
    """Phase 14.  -> launch counts of the kernels in the uninterrupted run
    ("fwd", "bwd", "decode", "loss") and in the fused run ("adamw"), and the
    readings."""
    import shutil

    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict, load_model_dir
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.serving.server import NekoServer
    from neko_tpu_torch.utils.checkpoint import latest_checkpoint

    from neko_tpu_torch import native

    base = TRAIN_CLI + ["--training_steps", str(TRAIN_STEPS),
                        "--log_eval_freq", str(TRAIN_EVAL_FREQ)]
    t0 = time.perf_counter()
    native.calls = 0
    tr, rec, launches, calls = train_cli(base, workdir / "a")
    native_packs = native.calls
    run_s = time.perf_counter() - t0
    cfg, layers = tr.ctx.model_cfg, tr.ctx.model_cfg.layers
    exp_a, target_budget = tr.exp_dir, tr.target_budget
    del tr
    losses = rec["losses"]
    _require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
             f"{len(losses)} losses, or not finite: {losses}")
    drop = float(np.mean(losses[:10]) - np.mean(losses[-10:]))
    print(f"train CLI {cfg.embed_dim}d/{layers}L/{cfg.heads}h k={cfg.context_len} B=16 "
          f"(6 text, 5 continuous, 5 image rows) bf16 dropout {cfg.dropout}, {TRAIN_STEPS} "
          f"steps in {run_s:.1f} s with 2 evaluations and 2 checkpoints; losses "
          + ", ".join(f"{x:.4f}" for x in losses))
    logs = _iteration_logs(exp_a)
    _require(len(logs) == TRAIN_STEPS // TRAIN_EVAL_FREQ, f"{len(logs)} iteration logs")
    trainer_ms = logs[1]["time/training"] / TRAIN_EVAL_FREQ * 1e3
    waits = np.asarray(rec["wait_s"][TRAIN_EVAL_FREQ:]) * 1e3
    produce = np.asarray(rec["produce_s"][TRAIN_EVAL_FREQ:]) * 1e3
    print(f"Trainer step (steps {TRAIN_EVAL_FREQ + 1}-{TRAIN_STEPS}, time/training / "
          f"{TRAIN_EVAL_FREQ}): {trainer_ms:.3f} ms against phase 6's flagship step (the "
          f"bench's batch) "
          f"{bench_step_ms:.3f} ms ({trainer_ms / bench_step_ms:.3f} of it); time/sample_batch "
          f"(queue wait) median {np.median(waits):.3f} ms, max {waits.max():.3f} ms; "
          f"time/host_pipeline (produce) median {np.median(produce):.3f} ms ({card})")
    print(f"native packer (neko_tpu_torch/native/packing.c): {native_packs} control examples "
          f"packed by the C kernel in the run")
    _require(native_packs > 0, "the train CLI's control rows never reached the native packer")
    metrics = {}
    for i, it in enumerate(logs):
        ev = {k: v for k, v in it.items() if k.startswith("evaluation/")}
        print(f"evaluation at step {it['_step']}: " + ", ".join(
            f"{k.split('/', 1)[1]} {v:.4f}" for k, v in sorted(ev.items()))
            + f" in {it['time/evaluation']:.3f} s")
        metrics = ev
    want_keys = {f"evaluation/{n}/{m}" for n in ("neko-synth-continuous-v0",
                                                  "neko-synth-image-v0")
                 for m in ("mean_return", "mean_episode_len")}
    want_keys |= {"evaluation/text/loss", "evaluation/text/perplexity"}
    _require(set(metrics) == want_keys and all(np.isfinite(v) for v in metrics.values()),
             f"evaluation metrics: {metrics}")
    chunks = _chunks_of(target_budget)
    print(f"kernel launches in the run: whole-head forward {launches['fwd']} ({TRAIN_STEPS} steps "
          f"+ {calls['prefill']} evaluation prefills, x {layers} layers), backward "
          f"{launches['bwd']}, decode {launches['decode']} ({calls['decode_step']} decode steps "
          f"x {layers}), loss head {launches['loss']} ({chunks} chunks a step of "
          f"{target_budget} targets), mask {launches['mask']}")
    _require(launches["fwd"] == layers * (TRAIN_STEPS + calls["prefill"])
             and calls["prefill"] > 0, f"whole-head forward launches {launches['fwd']}")
    _require(launches["bwd"] == layers * TRAIN_STEPS, f"backward launches {launches['bwd']}")
    _require(launches["decode"] == layers * calls["decode_step"] and calls["decode_step"] > 0,
             f"decode launches {launches['decode']}")
    _require(launches["loss"] == chunks * TRAIN_STEPS, f"loss head launches {launches['loss']}")
    _require(launches["mask"] == 0 and launches["adamw"] == 0, f"launches {launches}")

    # the planted fault of the loss check: the same run at learning rate 0
    _, rec0, _, _ = train_cli(TRAIN_CLI + [
        "--training_steps", "20", "--log_eval_freq", "20", "--learning_rate", "0",
        "--init_lr", "0", "--eval_episodes", "0", "--eval_text_num_examples", "0",
        "--no_save_model"], workdir / "lr0")
    drop0 = float(np.mean(rec0["losses"][:10]) - np.mean(rec0["losses"][-10:]))
    print(f"loss drop, mean of the first 10 steps less the last 10: {drop:.4f} (limit "
          f"{LOSS_DROP_MIN:g}); planted 'learning rate 0': {drop0:.4f}")
    _require(drop > LOSS_DROP_MIN, f"the loss did not fall: {drop}")
    _require(not drop0 > LOSS_DROP_MIN, f"the loss check cannot tell lr 0: {drop0}")

    # exact resume: stop at TRAIN_STOP (an interrupt inside the next step
    # leaves the emergency checkpoint), then resume to TRAIN_STEPS
    from neko_tpu_torch.training.trainer import Trainer

    step = Trainer.train_step

    def stop_after(self):
        if self.steps > TRAIN_STOP:
            raise KeyboardInterrupt(f"stopped inside step {self.steps}")
        return step(self)

    Trainer.train_step = stop_after
    try:
        train_cli(base, workdir / "b")
    except KeyboardInterrupt as e:
        print(f"run b: {e}")
    finally:
        Trainer.train_step = step
    ckpt_b = latest_checkpoint(str(next((workdir / "b").iterdir())))
    _require(ckpt_b.endswith(f"checkpoint_{TRAIN_STOP}"), f"emergency checkpoint {ckpt_b}")
    _, rec_c, _, _ = train_cli(base + ["--resume_from", ckpt_b], workdir / "c")
    got = rec_c["losses"]
    want = losses[TRAIN_STOP:]
    stream_ok = rec_c["stream"][1:1 + len(want)] == rec["stream"][1 + TRAIN_STOP:1 + TRAIN_STEPS]
    gap = max(abs(a - b) for a, b in zip(got, want)) if len(got) == len(want) else float("inf")
    sidecar = f"host_state_{TRAIN_STOP}_p0.pkl"
    bare = workdir / "b_bare"
    shutil.copytree(ckpt_b, bare / f"checkpoint_{TRAIN_STOP}")
    _, rec_f, _, _ = train_cli(base + ["--resume_from", str(bare / f"checkpoint_{TRAIN_STOP}"),
                                       "--eval_episodes", "0", "--eval_text_num_examples", "0",
                                       "--no_save_model"], workdir / "f")
    gap_f = max(abs(a - b) for a, b in zip(rec_f["losses"], want))
    stream_f = rec_f["stream"][1:1 + len(want)] == rec["stream"][1 + TRAIN_STOP:1 + TRAIN_STEPS]
    print(f"resume at step {TRAIN_STOP} (emergency checkpoint) to {TRAIN_STEPS}: packed arrays of "
          f"steps {TRAIN_STOP + 1}-{TRAIN_STEPS} {'bit for bit equal' if stream_ok else 'DIFFER'}; "
          f"largest loss difference {gap:.3e} (tolerance {RESUME_LOSS_TOL:g}); planted "
          f"'{sidecar} deleted': stream {'equal' if stream_f else 'differs'}, loss difference "
          f"{gap_f:.3e}")
    _require(stream_ok, "the resumed run did not replay the packed arrays")
    _require(gap <= RESUME_LOSS_TOL, f"resumed losses {got} against {want}")
    _require(not stream_f and gap_f > RESUME_LOSS_TOL,
             "the resume check cannot tell a missing sidecar")
    for d in ("b", "b_bare", "c", "f", "lr0"):
        shutil.rmtree(workdir / d, ignore_errors=True)

    # the same with the fused AdamW kernel #16, evaluation off
    fused = TRAIN_CLI + ["--fused_adamw", "--training_steps", str(FUSED_STEPS),
                         "--log_eval_freq", str(FUSED_EVAL_FREQ), "--eval_episodes", "0",
                         "--eval_text_num_examples", "0"]
    tr_d, rec_d, launches_d, _ = train_cli(fused, workdir / "d")
    exp_d = tr_d.exp_dir
    del tr_d
    _require(launches_d["adamw"] == FUSED_STEPS, f"fused AdamW launches {launches_d['adamw']}")
    _, rec_e, launches_e, _ = train_cli(
        fused + ["--resume_from", f"{exp_d}/checkpoint_{FUSED_STOP}"], workdir / "e")
    want_d = rec_d["losses"][FUSED_STOP:]
    gap_d = max(abs(a - b) for a, b in zip(rec_e["losses"], want_d))
    stream_d = (rec_e["stream"][1:1 + len(want_d)]
                == rec_d["stream"][1 + FUSED_STOP:1 + FUSED_STEPS])
    print(f"fused AdamW run: {FUSED_STEPS} steps, kernel #16 launches {launches_d['adamw']}; "
          f"resumed at {FUSED_STOP} (the moments through the checkpoint): packed arrays "
          f"{'bit for bit equal' if stream_d else 'DIFFER'}, largest loss difference "
          f"{gap_d:.3e}, #16 launches {launches_e['adamw']}")
    _require(stream_d and gap_d <= RESUME_LOSS_TOL and launches_e["adamw"] == len(want_d),
             "the fused resume did not replay the run")
    shutil.rmtree(workdir / "d", ignore_errors=True)
    shutil.rmtree(workdir / "e", ignore_errors=True)

    # the last checkpoint serves
    path = latest_checkpoint(exp_a)
    _require(path.endswith(f"checkpoint_{TRAIN_STEPS}"), f"last checkpoint {path}")
    cfg2, model = load_model_dir(path, dev)
    _require(cfg2 == cfg, "the checkpoint's config differs from the run's")
    gen = Generator(model, seed=SEED)
    with NekoServer(gen, port=0, request_timeout=600.0) as server:
        url = f"http://{server.address[0]}:{server.address[1]}"
        status, body, dt_g = _post(url + "/v1/generate", {"text": list(b"the robot moves"),
                                                          "max_new_tokens": 8})
        _require(status == 200 and len(body["tokens"]) == 8, body)
        obs = np.random.default_rng(SEED).standard_normal((4, 8)).tolist()
        status, body2, dt_a = _post(url + "/v1/action", {
            "continuous_obs": obs, "action_kind": "continuous", "action_tokens": 2})
        act = np.asarray(body2["action"])
        _require(status == 200 and act.shape == (2,) and np.all(np.abs(act) <= 1.0), body2)
    print(f"{path.rsplit('/', 1)[-1]} served: /v1/generate {body['tokens']} in "
          f"{dt_g * 1e3:.1f} ms, /v1/action {act.tolist()} in {dt_a * 1e3:.1f} ms ({card})")

    del gen, model
    # the rollout cache, kernels against plain attention, past the ring, on
    # random weights from the seed (where phase 4's logit limits were set)
    rcfg = ModelConfig(**dict(FLAGSHIP, max_patches=0, dropout=0.0))
    gen = Generator(build_model(rcfg, init_state_dict(rcfg, SEED), dev), seed=SEED)
    (pre, first, later), faults, ring_ts, step_ms = rollout_vs_plain(gen, ROLLOUT_STEPS)
    limits = (LOGIT_TOL, LOGIT_TOL, DECODE_LOGIT_TOL)
    print(f"rollout cache over {ROLLOUT_STEPS} env steps (the ring holds {ring_ts} timesteps, "
          f"after a {ring_ts}-timestep-or-shorter prompt), kernels vs plain attention, "
          f"teacher-forced: prompt prefill logits {pre:.3e} and action logits after the "
          f"extend {first:.3e} (tolerance {LOGIT_TOL:g}), after decode steps {later:.3e} "
          f"(tolerance {DECODE_LOGIT_TOL:g}); {step_ms:.3f} ms a rollout step ({card})")
    for f, errs in faults.items():
        print(f"control '{f}': prefill {errs[0]:.3e}, after the extend {errs[1]:.3e}, "
              f"after decode steps {errs[2]:.3e}")
    _require(all(e <= t for e, t in zip((pre, first, later), limits)),
             f"the rollout's logits disagree: {pre}, {first}, {later}")
    blind = [f for f, errs in faults.items()
             if not any(e > t for e, t in zip(errs, limits))]
    _require(not blind, f"the rollout check cannot tell these planted faults: {blind}")
    del gen
    return {"fwd": launches["fwd"], "bwd": launches["bwd"], "decode": launches["decode"],
            "loss": launches["loss"], "adamw": launches_d["adamw"] + launches_e["adamw"],
            "trainer_ms": trainer_ms, "bench_step_ms": bench_step_ms,
            "rollout_step_ms": step_ms, "native_packs": native_packs}


# ------------------------------------------------ the evaluation entry point
def image_text_data(n: int, seed: int):
    """n uint8 [256, 256, 3] images (a coloured square on noise) with a
    caption each, and VQA items over them (the image as an array)."""
    rng = np.random.default_rng(seed)
    colours = {"red": (220, 30, 30), "green": (30, 200, 40), "blue": (30, 40, 220),
               "yellow": (230, 220, 30)}
    names, sizes = list(colours), ("small", "large")
    images = rng.integers(0, 64, (n, EVAL_IMAGE, EVAL_IMAGE, 3), dtype=np.uint8)
    captions, items = [], []
    for i in range(n):
        c, s = names[rng.integers(len(names))], sizes[rng.integers(2)]
        w = 48 if s == "small" else 128
        y, x = rng.integers(0, EVAL_IMAGE - w, 2)
        images[i, y:y + w, x:x + w] = colours[c]
        where = "top" if y + w // 2 < EVAL_IMAGE // 2 else "bottom"
        captions.append(f"a {s} {c} square near the {where} of the frame")
        items.append({"image": images[i], "question": f"what colour is the {s} square?",
                      "answers": [c, f"{c} colour"]})
    return images, captions, items


def eval_mix_tasks(args, workdir):
    """The mix's tasks, as cli/build.py's build_tasks orders them: the
    control envs, synthetic text, captions (an ArrayCaptionSource, its split
    persisted under `workdir`) and VQA (items carrying their images)."""
    from neko_tpu_torch.cli.build import build_control_tasks
    from neko_tpu_torch.data.caption_data import ArrayCaptionSource
    from neko_tpu_torch.tasks.caption import CaptionTask
    from neko_tpu_torch.tasks.text import TextTask
    from neko_tpu_torch.tasks.vqa import VqaTask

    images, captions, _ = image_text_data(48, SEED)
    _, _, train_items = image_text_data(32, SEED + 1)
    _, _, test_items = image_text_data(EVAL_GROUP, SEED + 2)
    (workdir / "caption").mkdir(parents=True, exist_ok=True)
    kw = dict(image_size=EVAL_IMAGE, patch_size=args.patch_size,
              context_length=args.sequence_length, seed=args.seed)
    return build_control_tasks(args, args.sequence_length, args.seed) + [
        TextTask(args.text_datasets, args.text_datasets_paths,
                 context_length=args.sequence_length, seed=args.seed),
        CaptionTask(str(workdir / "caption"), test_data_prop=EVAL_GROUP / len(captions),
                    source_factory=lambda dirs, image_size: ArrayCaptionSource(images, captions),
                    **kw),
        VqaTask("", [], [], items=(train_items, test_items), **kw),
    ]


@contextlib.contextmanager
def recording_score_decode(gen, record, forced=None):
    """Within the block `gen._decode` records each call's tokens, window
    logits and target NLL ([B, T], [B, T, W], [B, T]).  With `forced` (the
    records of another run) it feeds the tokens of the matching call instead
    of its own choices: the caption / VQA decode (inner positions continued,
    no ring, no limits), teacher-forced."""
    import torch

    orig = gen._decode

    def decode(last_logits, caches, pos, next_pos, *, n_steps, start, end, **kw):
        if forced is None:
            toks, windows, nlls = orig(last_logits, caches, pos, next_pos, n_steps=n_steps,
                                       start=start, end=end, **{**kw, "return_logits": True})
            record.append((toks, windows, nlls))
            return toks, None, nlls
        _require(kw.get("with_pos") and not kw.get("ring") and kw.get("limits") is None
                 and kw.get("targets") is not None, f"teacher forcing of another decode: {kw}")
        toks, tgt = forced[len(record)][0], kw["targets"].long()
        windows, nlls = [], []
        for i in range(n_steps):
            w = last_logits[:, start:end + 1]
            windows.append(w)
            nlls.append(torch.logsumexp(w, dim=-1) - w.gather(1, tgt[:, i:i + 1])[:, 0])
            if i == n_steps - 1:
                break
            emb = gen.model.embed_tokens_with_pos(toks[:, i:i + 1], next_pos[:, None])
            last_logits = gen.model.decode_step(emb, pos, caches)[:, 0]
            pos, next_pos = pos + 1, next_pos + 1
        record.append((toks, torch.stack(windows, dim=1), torch.stack(nlls, dim=1)))
        return toks, None, record[-1][2]

    gen._decode = decode
    try:
        yield record
    finally:
        del gen._decode


def _score_groups(tasks):
    """The caption and VQA evaluations' decode groups: (name, prompts,
    targets) as their `evaluate` builds them, one group of EVAL_GROUP each."""
    cap, vqa = tasks
    tok = cap.text_tokenizer
    caps = [cap.test_source.get(int(i)) for i in cap.test_indices[:EVAL_GROUP]]
    groups = [("caption", [{"images": s["image"][None], "text": []} for s in caps],
               [tok.encode(s["caption"]) for s in caps])]
    items = vqa.test_items[:EVAL_GROUP]
    groups.append(("VQA", [{"images": vqa._image(it)[None], "text": tok.encode(it["question"])}
                           for it in items],
                   [tok.encode(" " + it["answers"][0]) for it in items]))
    return groups


def caption_vqa_vs_plain(gen, tasks):
    """Phase 15's logit check.  -> ({reading: error} of the sound run, {fault:
    the same readings}) over the caption and VQA groups: "prefill" (logits
    at the prompts' last position), "decode" (the windows after decode
    steps), "nll" (per target token)."""
    import torch

    from neko_tpu_torch.tasks.caption import score_targets

    def run(forced=None, prefill_fault=None, decode_fault=None, plain=True):
        recs, pres = [], []
        ctx = [recording_score_decode(gen, recs, forced), recording_prefill(gen, pres)]
        if plain:
            ctx += [prefill_attention_through(
                        lambda *a: plain_prefill_attention(*a, fault=prefill_fault)),
                    decode_attention_through(
                        lambda *a: plain_decode_attention(*a, fault=decode_fault))]
        with torch.inference_mode(), contextlib.ExitStack() as stack:
            for c in ctx:
                stack.enter_context(c)
            for _, prompts, targets in _score_groups(tasks):
                score_targets(gen, prompts, targets, deterministic=True)
        return recs, pres

    V = gen.cfg.vocab_size
    kernel, kernel_pre = run(plain=False)
    valid = []  # [B, T] masks of the target positions
    for _, _, targets in _score_groups(tasks):
        T = max(len(t) for t in targets)
        valid.append(torch.tensor([[j < len(t) for j in range(T)] for t in targets],
                                  device=gen.device))

    def readings(recs, pres):
        return {
            "prefill": max((a[:, :V] - b[:, :V]).abs().max().item()
                           for a, b in zip(kernel_pre, pres)),
            "decode": max((k[1][:, 1:] - r[1][:, 1:]).abs().max().item()
                          for k, r in zip(kernel, recs)),
            "nll": max(((k[2] - r[2]).abs() * m).max().item()
                       for k, r, m in zip(kernel, recs, valid)),
        }

    sound = readings(*run(forced=kernel))
    faults = {f"prefill: {f}": readings(*run(forced=kernel, prefill_fault=f))
              for f in EVAL_PREFILL_FAULTS}
    faults.update({f"decode: {f}": readings(*run(forced=kernel, decode_fault=f))
                   for f in EVAL_DECODE_FAULTS})
    return sound, faults


def eval_entry_point(card: str, workdir, dev="cuda") -> dict:
    """Phase 15.  -> launch counts of the mix's train run ("fwd", "bwd",
    "loss", "decode") and of the evaluation ("eval_fwd", "eval_decode"), and
    the readings."""
    import torch

    from neko_tpu_torch import bench_decode
    from neko_tpu_torch.cli import evaluate as cli_eval
    from neko_tpu_torch.cli.build import (
        build_context, load_state_for, resolve_checkpoint_and_args)
    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.training.arguments import TrainingArgs
    from neko_tpu_torch.training.trainer import Trainer, evaluate_task
    from neko_tpu_torch.utils.typed_argparser import TypedArgumentParser

    # 1. the Trainer on the mix, ending in an evaluation and a checkpoint
    (args,) = TypedArgumentParser(TrainingArgs).parse_args_into_dataclasses(
        EVAL_MIX + ["--save_dir", str(workdir), "--device", dev])
    tasks = eval_mix_tasks(args, workdir)
    ctx, tasks = build_context(args, tasks=tasks)
    tr = Trainer(ctx, tasks, "eval_mix", args)
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with trainer_recorder() as rec, model_call_counter() as calls:
        tr.train()
    run_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    losses = [float(x) for x in rec["losses"]]
    cfg, layers = ctx.model_cfg, ctx.model_cfg.layers
    rows = tr._component_counts()[0]
    logs = _iteration_logs(tr.exp_dir)
    step_ms = logs[-1]["time/training"] / EVAL_EVAL_FREQ * 1e3
    print(f"phase 15 Trainer {cfg.embed_dim}d/{layers}L/{cfg.heads}h k={cfg.context_len} B=16 "
          f"(rows a step {rows}; caption and VQA images {EVAL_IMAGE}x{EVAL_IMAGE}, "
          f"patch pool {tr.patch_budget}, target budget {tr.target_budget}) bf16 dropout "
          f"{cfg.dropout}: {EVAL_STEPS} steps and {len(logs)} evaluations in {run_s:.1f} s, "
          f"{step_ms:.3f} ms a step over steps {EVAL_STEPS - EVAL_EVAL_FREQ + 1}-{EVAL_STEPS} "
          f"(time/training) ({card}); losses " + ", ".join(f"{x:.4f}" for x in losses))
    _require(len(losses) == EVAL_STEPS and all(np.isfinite(losses)), f"losses {losses}")
    _require(len(logs) == EVAL_STEPS // EVAL_EVAL_FREQ, f"{len(logs)} iteration logs")
    logs = logs[-1]
    ev = {k: v for k, v in logs.items() if k.startswith("evaluation/")}
    print("in-loop evaluation: " + ", ".join(f"{k.split('/', 1)[1]} {v:.4f}"
                                             for k, v in sorted(ev.items()))
          + f" in {logs['time/evaluation']:.3f} s")
    want = {f"evaluation/{n}/{m}" for n in EVAL_ENVS for m in ("mean_return",
                                                               "mean_episode_len")}
    want |= {f"evaluation/{t}/{m}" for t in ("text", "caption", "VQA")
             for m in ("loss", "perplexity")}
    _require(set(ev) == want and all(np.isfinite(v) for v in ev.values()), f"in-loop {ev}")
    chunks = _chunks_of(tr.target_budget)
    print(f"kernel launches in the mix's run: whole-head forward {launches['fwd']} "
          f"({EVAL_STEPS} steps + {calls['prefill']} evaluation prefills, x {layers}), backward "
          f"{launches['bwd']}, loss head {launches['loss']} ({chunks} chunks a step), decode "
          f"{launches['decode']} ({calls['decode_step']} decode steps x {layers})")
    _require(launches["fwd"] == layers * (EVAL_STEPS + calls["prefill"]), f"fwd {launches}")
    _require(launches["bwd"] == layers * EVAL_STEPS, f"backward launches {launches['bwd']}")
    _require(launches["loss"] == chunks * EVAL_STEPS, f"loss head launches {launches['loss']}")
    _require(launches["decode"] == layers * calls["decode_step"] and calls["decode_step"] > 0,
             f"decode launches {launches['decode']}")
    exp_dir, eval_tasks = tr.exp_dir, tasks[-2:]
    del tr
    if dev == "cuda":
        torch.cuda.empty_cache()

    # 2-3. the evaluation CLI on the checkpoint (control and text), then the
    # caption and VQA evaluations on the Generator of the CLI's restore
    # helpers; seconds per task, launches over all of it
    seconds = {}
    orig = cli_eval.evaluate_task

    def timed(task, *a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        out = orig(task, *a, **kw)
        _sync(dev)
        seconds[next(iter(out)).split("/")[1] if out else task.name] = time.perf_counter() - t0
        return out

    argv = ["--model_path", exp_dir] + (["--cpu"] if dev == "cpu" else [])
    for fn in counters.values():
        fn.launches = 0
    cli_eval.evaluate_task = timed
    try:
        with model_call_counter() as ecalls:
            got = cli_eval.main(argv)
            ckpt, rargs = resolve_checkpoint_and_args(exp_dir)
            rargs.cpu, rargs.device = dev == "cpu", dev
            rctx, _ = build_context(rargs, tasks=[], ckpt_path=ckpt)
            model, packer = load_state_for(rctx, ckpt)
            gen = Generator(model, packer, seed=rargs.seed)
            for task in eval_tasks:
                got.update(timed(task, gen, rargs, True))
        eval_launches = {k: counters[k].launches for k in ("fwd", "decode")}
    finally:
        cli_eval.evaluate_task = orig
    again = cli_eval.main(argv)
    print(f"evaluation CLI on {ckpt.rsplit('/', 2)[-2]}/{ckpt.rsplit('/', 1)[-1]} + caption / "
          f"VQA on its restore (pool {rctx.model_cfg.max_patches} patches an example): "
          + ", ".join(f"{k.split('/', 1)[1]} {v:.4f}" for k, v in sorted(got.items())))
    print("seconds per evaluation: " + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f" ({card})")
    _require(set(got) == want and all(np.isfinite(v) for v in got.values()), f"eval {got}")
    cli_keys = {k for k in want if "/caption/" not in k and "/VQA/" not in k}
    _require(set(again) == cli_keys and all(again[k] == got[k] for k in again),
             f"a second deterministic CLI run differs: {again}")
    print(f"kernel launches over the evaluation: whole-head forward {eval_launches['fwd']} "
          f"({ecalls['prefill']} prefills x {layers}), decode {eval_launches['decode']} "
          f"({ecalls['decode_step']} decode steps x {layers})")
    _require(eval_launches["fwd"] == layers * ecalls["prefill"] and ecalls["prefill"] > 0,
             f"evaluation prefills {eval_launches}")
    _require(eval_launches["decode"] == layers * ecalls["decode_step"]
             and ecalls["decode_step"] > 0, f"evaluation decode steps {eval_launches}")

    # 5. the caption group's prefill and a decode step, on the restored model
    (name, prompts, targets), _ = _score_groups(eval_tasks)
    from neko_tpu_torch.data.batch import to_device_batch

    S = gen.cfg.context_len
    arrays = gen.packer.pack_batch(prompts, pad_side="right")
    lengths = arrays.pop("lengths") - 1
    with torch.inference_mode():
        emb = model.embed_batch(to_device_batch(arrays, gen.device))
        mask = torch.from_numpy(np.arange(S)[None, :] < lengths[:, None]).to(gen.device)
        last = torch.as_tensor(lengths - 1, device=gen.device)
        prefill = lambda: model.prefill(emb, mask, last=last)  # noqa: E731
        prefill_ms = _time_ms(prefill, 10) if dev == "cuda" else float("nan")
        prefill_dev = _device_ms(prefill, 10) if dev == "cuda" else float("nan")
    ts = gen.cfg.token_space
    kw = dict(start=ts.start("text"), end=ts.end("text"), drop_trailing=1,
              inner_pos_continuation=True, return_logits=False)
    T = 32
    decode_ms = bench_decode.measure(gen, prompts, T, runs=3, **kw)["per_token_ms"]
    print(f"caption group of {len(prompts)} ({int(lengths[0])}-token prompts: "
          f"{EVAL_IMAGE}x{EVAL_IMAGE} images): prefill {prefill_ms:.3f} ms (CUDA events), "
          f"{prefill_dev:.3f} ms device time; decode {decode_ms:.3f} ms a step (generate_batch, "
          f"host clock, {T} tokens less 1, median of 3) ({card})")
    del gen, model

    # 4. the caption / VQA prompts, kernels vs plain attention, random weights
    rcfg = ModelConfig(**dict(FLAGSHIP, max_patches=(EVAL_IMAGE // 16) ** 2, dropout=0.0))
    rgen = Generator(build_model(rcfg, init_state_dict(rcfg, SEED), dev), seed=SEED)
    sound, faults = caption_vqa_vs_plain(rgen, eval_tasks)
    limits = {"prefill": LOGIT_TOL, "decode": DECODE_LOGIT_TOL, "nll": EVAL_NLL_TOL}
    print("caption / VQA groups, kernels vs plain attention, teacher-forced: "
          + ", ".join(f"{k} {v:.3e} (tolerance {limits[k]:g})" for k, v in sound.items()))
    for f, errs in faults.items():
        print(f"control '{f}': " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    _require(all(sound[k] <= limits[k] for k in limits), f"caption / VQA disagree: {sound}")
    blind = [f for f, errs in faults.items() if not any(errs[k] > limits[k] for k in limits)]
    _require(not blind, f"the caption / VQA check cannot tell these planted faults: {blind}")
    del rgen
    return {"fwd": launches["fwd"], "bwd": launches["bwd"], "loss": launches["loss"],
            "decode": launches["decode"], "eval_fwd": eval_launches["fwd"],
            "eval_decode": eval_launches["decode"], "seconds": seconds,
            "prefill_ms": prefill_ms, "prefill_device_ms": prefill_dev,
            "decode_step_ms": decode_ms, "trainer_step_ms": step_ms, "readings": sound}


# ------------------------------------------------------------ serving engine
class _MainPath:
    """Kernel launches and the layers that should launch them, over the
    phase's main-path segments (driven through the entry points, kernel
    route); the reference and plain-route runs lie outside them."""

    def __init__(self):
        from neko_tpu_torch.ops import attention_kernel as whk
        from neko_tpu_torch.ops import decode_attention as da

        self.kernels = {"fwd": whk.whole_head_attention, "decode": da.decode_cache_attention}
        self.launches = {"fwd": 0, "decode": 0}
        self.layers = {"fwd": 0, "decode": 0}

    @contextlib.contextmanager
    def segment(self):
        for fn in self.kernels.values():
            fn.launches = 0
        with model_call_counter() as calls:
            yield
        for k, fn in self.kernels.items():
            self.launches[k] += fn.launches
        self.layers["fwd"] += calls["prefill_layers"]
        self.layers["decode"] += calls["decode_step_layers"]


def _engine_payloads(ts, rng):
    """The 16 requests: (payload, prompt ids) with greedy and sampled ones
    interleaved."""
    out = []
    for i in range(ENGINE["requests"]):
        L = int(rng.integers(ENGINE["prompt"][0], ENGINE["prompt"][1] + 1))
        p = {"text": rng.integers(0, ts.text_tokens, L).tolist(),
             "max_new_tokens": int(rng.integers(ENGINE["new"][0], ENGINE["new"][1] + 1))}
        if i % 2:
            p.update(deterministic=False, temperature=0.8, top_p=0.9)
        out.append(p)
    return out


def _http_load(base: str, payloads, stream: bool):
    """Every payload at once, one client each, through the serving harness's
    closed loop (`tools.bench_serving.run_load`).  -> (replies, TTFTs,
    latencies, wall seconds); without a stream the first token comes with
    the reply."""
    from neko_tpu_torch.tools.bench_serving import run_load

    res = run_load(base, payloads, clients=len(payloads), stream=stream)
    _require(res["errors"] == 0, f"requests failed: {res['error_messages']}")
    lat = res["latency_s"]
    return res["replies"], res["ttft_s"] if stream else lat, lat, res["wall_s"]


def _load_summary(name, replies, ttft, lat, wall, card):
    toks = sum(len(r["tokens"]) for r in replies)
    out = {"requests_per_s": len(replies) / wall, "tokens_per_s": toks / wall,
           "p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "p99_ms": float(np.percentile(lat, 99)) * 1e3,
           "ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
           "ttft_p99_ms": float(np.percentile(ttft, 99)) * 1e3, "wall_s": wall, "tokens": toks}
    print(f"{name}: {len(replies)} requests, {toks} tokens in {wall:.3f} s: "
          f"{out['requests_per_s']:.3f} requests/s, {out['tokens_per_s']:.1f} tokens/s, latency "
          f"p50 {out['p50_ms']:.1f} / p99 {out['p99_ms']:.1f} ms, time to first token p50 "
          f"{out['ttft_p50_ms']:.1f} / p99 {out['ttft_p99_ms']:.1f} ms ({card})")
    return out


def _reference(gen, prompts, T):
    """generate_batch's greedy tokens [N, T] (window ids) and, per step, the
    gap between the top two window logits (fp32)."""
    ts = gen.cfg.token_space
    toks, windows = gen.generate_batch([{"text": p} for p in prompts], max_new_tokens=T,
                                       start=ts.start("text"), end=ts.end("text"))
    top2 = np.partition(windows, -2, axis=-1)[..., -2:]
    return toks - ts.start("text"), top2[..., 1] - top2[..., 0]


def _near_tie_check(name, got, ref, gaps) -> int:
    """Tokens equal up to the first step whose reference top-two logits lie
    within DECODE_LOGIT_TOL (where the kernels' rounding may flip the
    argmax).  -> the steps held."""
    ties = np.flatnonzero(gaps[:len(got)] < DECODE_LOGIT_TOL)
    held = int(ties[0]) if len(ties) else len(got)
    diff = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    if diff:
        j = diff[0]
        print(f"  {name}: diverges at step {j} of {len(got)} (reference top-two gap there "
              f"{gaps[j]:.3e}; first near tie at step {held})")
    _require(list(got[:held]) == list(ref[:held]),
             f"{name}: tokens differ before the first near tie (step {held})")
    return held


def _engine_exact(gen, payloads, main):
    """Eight greedy requests submitted before the engine starts, so its first
    call admits all eight in one prefill: the shapes of generate_batch on the
    same 8 prompts, token for token."""
    from neko_tpu_torch.serving.continuous import ContinuousEngine
    from neko_tpu_torch.serving.server import _Pending

    greedy = [p for p in payloads if p.get("deterministic", True)]
    eng = ContinuousEngine(gen, slots=ENGINE["slots"], chunk=ENGINE["chunk"])
    reqs = [_Pending(dict(p), None) for p in greedy]
    with main.segment(), model_call_counter() as calls:
        for r in reqs:
            eng.submit(r)
        eng.start()
        for r in reqs:
            _require(r.event.wait(600), "engine request timed out")
        eng.close()
    _require(all(r.error is None for r in reqs), [r.error for r in reqs])
    _require(calls["prefill"] == 1, f"{calls['prefill']} prefills: the eight were not "
             "admitted in one")
    ref, _ = _reference(gen, [p["text"] for p in greedy], max(p["max_new_tokens"] for p in greedy))
    for i, (r, p) in enumerate(zip(reqs, greedy)):
        want = ref[i, :p["max_new_tokens"]].tolist()
        _require(r.result["tokens"] == want, f"engine row {i} differs from generate_batch")
    print(f"engine, 8 greedy requests admitted in one prefill: tokens equal generate_batch's "
          f"on the same 8 prompts ({sum(p['max_new_tokens'] for p in greedy)} tokens)")
    return greedy


def _beam_phase(gen, gen32, main, card):
    """Beams on two caption prompts: predict_caption (4 beams) per prompt on
    the main path; generate_beam on both, kernels vs plain attention (fp32
    tokens identical, bf16 window logits within DECODE_LOGIT_TOL on the
    steps whose beams agree); ms per beam step."""
    import torch

    rng = np.random.default_rng(SEED + 16)
    images = rng.integers(0, 256, (2, 1, ENGINE_IMAGE, ENGINE_IMAGE, 3), dtype=np.uint8)
    ts = gen.cfg.token_space
    B, T = ENGINE_BEAMS, ENGINE_BEAM_STEPS
    with main.segment():
        caps = [gen.predict_caption(img, max_length=T, num_beams=B)[1] for img in images]
    _require(all(c.shape == (T,) and ((c >= 0) & (c < ts.text_tokens)).all() for c in caps),
             "beam captions out of range")
    examples = [{"images": img, "text": []} for img in images]
    kw = dict(start=ts.start("text"), end=ts.end("text"), num_beams=B, drop_trailing=1,
              inner_pos_continuation=True, return_logits=True)

    def routes(g):
        got = g.generate_beam(examples, max_new_tokens=T, **kw)
        with prefill_attention_through(plain_prefill_attention), \
                decode_attention_through(plain_decode_attention):
            want = g.generate_beam(examples, max_new_tokens=T, **kw)
        return got, want

    (t32, s32, _), (w32, ws32, _) = routes(gen32)
    print(f"beams fp32, kernels vs plain: tokens {'identical' if np.array_equal(t32, w32) else 'DIFFER'}"
          f", scores max abs err {np.abs(s32 - ws32).max():.3e}")
    _require(np.array_equal(t32, w32), "fp32 beam tokens differ between the kernel and plain routes")
    (tk, _, lk), (tp, _, lp) = routes(gen)
    same = [i for i in range(T) if np.array_equal(tk[..., :i + 1], tp[..., :i + 1])]
    steps = len(same)
    err = float(np.abs(lk[:, :, :steps] - lp[:, :, :steps]).max()) if steps else float("nan")
    print(f"beams bf16, kernels vs plain: beams agree on {steps} of {T} steps; window logits "
          f"there max abs err {err:.3e} (tolerance {DECODE_LOGIT_TOL:g})")
    _require(steps >= 1 and err <= DECODE_LOGIT_TOL, f"bf16 beam logits disagree: {err}")

    kw.pop("return_logits")

    def run(n):
        _sync(gen.device)
        t0 = time.perf_counter()
        gen.generate_beam(examples, max_new_tokens=n, **kw)
        _sync(gen.device)
        return time.perf_counter() - t0

    with main.segment():
        run(T)
        full = float(np.median([run(T) for _ in range(3)]))
        one = float(np.median([run(1) for _ in range(3)]))
    step_ms = (full - one) / (T - 1) * 1e3
    print(f"beam step, {len(examples)} prompts x {B} beams ({len(examples) * B} rows, "
          f"{ENGINE_IMAGE}x{ENGINE_IMAGE} images): {step_ms:.3f} ms (generate_beam, host clock, "
          f"{T} steps less 1, median of 3) ({card})")
    return {"beam_step_ms": step_ms, "beam_steps_agreeing_bf16": steps, "beam_logit_err": err}


def _spec_phase(gen, gen32, main, card):
    """Prompt-lookup and truncated-draft speculation on a repetitive prompt:
    fp32 greedy tokens equal generate()'s; bf16 rounds, tokens per round,
    ms per generated token against plain decode."""
    rng = np.random.default_rng(SEED + 17)
    ts = gen.cfg.token_space
    phrase = rng.integers(0, ts.text_tokens, ENGINE_SPEC["phrase"]).tolist()
    ex = {"text": phrase * ENGINE_SPEC["repeats"]}
    K, T = ENGINE_SPEC["K"], ENGINE_SPEC["new"]
    kw = dict(max_new_tokens=T, start=ts.start("text"), end=ts.end("text"), speculate_k=K)
    out = {}
    for g, name in ((gen32, "fp32"), (gen, "bf16")):
        draft = g.truncated_draft(ENGINE_SPEC["draft_layers"])
        plain, windows = g.generate(ex, max_new_tokens=T, start=kw["start"], end=kw["end"])
        top2 = np.partition(windows, -2, axis=-1)[..., -2:]
        gaps = top2[..., 1] - top2[..., 0]
        for route, fn in (("lookup", lambda: g.generate_spec(ex, **kw)),
                          ("draft", lambda: g.generate_spec_draft(ex, draft, **kw))):
            if name == "bf16":
                with main.segment():
                    toks, rounds = fn()
            else:
                toks, rounds = fn()
            if name == "fp32":
                _require(np.array_equal(toks, plain),
                         f"fp32 {route} speculation differs from generate()")
                print(f"speculation fp32 ({route}): tokens equal generate()'s, {rounds} rounds")
                continue
            _near_tie_check(f"speculation bf16 ({route})", toks, plain, gaps)

            def timed(f):
                _sync(g.device)
                t0 = time.perf_counter()
                f()
                _sync(g.device)
                return time.perf_counter() - t0

            with main.segment():
                spec_s = float(np.median([timed(fn) for _ in range(3)]))
                gen_one = float(np.median([timed(lambda: g.generate_batch(
                    [ex], max_new_tokens=1, start=kw["start"], end=kw["end"],
                    return_logits=False)) for _ in range(3)]))
                gen_full = float(np.median([timed(lambda: g.generate_batch(
                    [ex], max_new_tokens=T, start=kw["start"], end=kw["end"],
                    return_logits=False)) for _ in range(3)]))
            spec_ms = (spec_s - gen_one) / T * 1e3
            plain_ms = (gen_full - gen_one) / (T - 1) * 1e3
            out[route] = {"rounds": rounds, "tokens_per_round": T / rounds,
                          "ms_per_token": spec_ms, "plain_ms_per_token": plain_ms}
            print(f"speculation bf16 ({route}, K={K}"
                  + (f", draft {ENGINE_SPEC['draft_layers']} layers" if route == "draft" else "")
                  + f"), {len(ex['text'])}-token repetitive prompt, {T} tokens: {rounds} rounds, "
                  f"{T / rounds:.2f} tokens a round, {spec_ms:.3f} ms a generated token against "
                  f"plain decode's {plain_ms:.3f} (host clock, less the 1-token run, median of 3) "
                  f"({card})")
    return out


def _stale_mask_check(gen32):
    """The engine after spec rounds, then a plain chunk, against
    generate_batch (fp32): tokens equal and the logits after the chunk
    within ENGINE_FP32_LOGIT_TOL; with the cache-mask refresh skipped
    (planted) the logits must leave the limit."""
    import torch

    ts = gen32.cfg.token_space
    s, e = ts.start("text"), ts.end("text")
    rng = np.random.default_rng(SEED + 18)
    ex = {"text": rng.integers(0, ts.text_tokens, 200).tolist()}
    L = gen32.packer.pack_example(ex).length
    K = ENGINE_SPEC["K"]

    def run(skip):
        st = gen32.engine_init(2, speculate_k=K)
        st = gen32.engine_admit(st, 0, ex)
        chunks, advs, st = gen32.engine_spec_chunk(st, rounds=4, start=s, end=e, K=K)
        if skip:  # the refresh undone: the masks as they stood before the rounds
            with torch.inference_mode():
                S = gen32.cfg.context_len
                stale = torch.arange(S, device=gen32.device)[None, :] < torch.tensor(
                    [[L], [0]], device=gen32.device)
                for c in st["caches"]:
                    c["mask"].copy_(stale)
        toks, st = gen32.engine_chunk(st, n_steps=8, start=s, end=e, det=[True, True],
                                      temp=[1.0, 1.0], top_p=[1.0, 1.0])
        ids = [int(t) for r in range(chunks.shape[1]) for t in chunks[0, r, :int(advs[0, r])]]
        return ids + [int(t) for t in toks[0]], st["last"][0, s:e + 1].float().cpu().numpy()

    ids, last = run(False)
    (ref, win) = gen32.generate_batch([ex], max_new_tokens=len(ids) + 1, start=s, end=e)
    _require(ids == ref[0, :len(ids)].tolist(), "engine spec + plain chunk tokens differ (fp32)")
    sound = float(np.abs(last - win[0, len(ids)]).max())
    bad_ids, bad_last = run(True)
    fault = float(np.abs(bad_last - win[0, len(ids)]).max()) if bad_ids == ids else float("inf")
    print(f"engine spec rounds + a plain chunk vs generate_batch (fp32, {len(ids)} tokens): "
          f"logits max abs err {sound:.3e} (tolerance {ENGINE_FP32_LOGIT_TOL:g})")
    print(f"control 'cache-mask refresh skipped after spec rounds': "
          + ("tokens differ" if bad_ids != ids else f"logits max abs err {fault:.3e}")
          + (": caught" if fault > ENGINE_FP32_LOGIT_TOL else ": NOT caught"))
    _require(sound <= ENGINE_FP32_LOGIT_TOL, f"engine logits disagree: {sound}")
    _require(fault > ENGINE_FP32_LOGIT_TOL, "the check cannot tell a stale cache mask")


def serving_engine(card: str, dev="cuda", width=None) -> dict:
    """Phase 16 (at `width`, the flagship's unless given).  -> the main
    path's launches of #1 and #14 ("fwd", "decode") and the readings."""
    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.serving.server import NekoServer
    from neko_tpu_torch.tools.bench_serving import post

    width = dict(width or FLAGSHIP, max_patches=(ENGINE_IMAGE // 16) ** 2, dropout=0.0)
    cfg = ModelConfig(**width)
    gen = Generator(build_model(cfg, init_state_dict(cfg, SEED), dev), seed=SEED)
    cfg32 = ModelConfig(**dict(width, dtype="float32"))
    gen32 = Generator(build_model(cfg32, init_state_dict(cfg32, SEED), dev), seed=SEED)
    cuda = torch.device(dev).type == "cuda"
    ts = cfg.token_space
    payloads = _engine_payloads(ts, np.random.default_rng(SEED + 15))
    main = _MainPath()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()

    greedy = _engine_exact(gen, payloads, main)

    # the 16 requests over HTTP: the engine (streamed), then the coalescing server
    with main.segment():
        with NekoServer(gen, port=0, continuous_slots=ENGINE["slots"],
                        continuous_chunk=ENGINE["chunk"], request_timeout=600.0) as server:
            base = f"http://{server.address[0]}:{server.address[1]}"
            replies, ttft, lat, wall = _http_load(base, payloads, stream=True)
            engine_load = _load_summary(f"continuous engine ({ENGINE['slots']} slots, chunk "
                                        f"{ENGINE['chunk']}, streamed)", replies, ttft, lat,
                                        wall, card)
            probe = dict(greedy[0])
            done, _ = post(base + "/v1/generate", probe, stream=True)
            status, body, _ = _post(base + "/v1/generate", probe)
            with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
                metrics = json.loads(r.read())
        with NekoServer(gen, port=0, max_batch=8, batch_window_ms=20.0,
                        request_timeout=600.0) as server:
            base = f"http://{server.address[0]}:{server.address[1]}"
            c_replies, c_ttft, c_lat, c_wall = _http_load(base, payloads, stream=False)
            coalesced_load = _load_summary("coalescing server (max_batch 8, window 20 ms)",
                                           c_replies, c_ttft, c_lat, c_wall, card)
            calls = server.coalesced_calls
    print(f"coalescing server: {calls} generation calls for {len(payloads)} requests")
    _require(status == 200 and done["tokens"] == body["tokens"],
             "the streamed tokens differ from the same request's reply")
    print(f"streaming: {len(done['tokens'])} streamed tokens equal the reply's")
    print("metrics: " + json.dumps(metrics))
    _require(metrics["continuous"]["finished"] == len(payloads) + 2
             and metrics["responses"] == len(payloads) + 2, f"metrics {metrics}")
    for rs in (replies, c_replies):
        for p, r in zip(payloads, rs):
            _require(len(r["tokens"]) == p["max_new_tokens"]
                     and all(0 <= t < ts.text_tokens for t in r["tokens"]), r)
    g_idx = [i for i, p in enumerate(payloads) if p.get("deterministic", True)]
    ref, gaps = _reference(gen, [payloads[i]["text"] for i in g_idx],
                           max(payloads[i]["max_new_tokens"] for i in g_idx))
    held = [_near_tie_check(f"{name} greedy request {i}", rs[i]["tokens"], ref[j], gaps[j])
            for name, rs in (("engine", replies), ("coalescing", c_replies))
            for j, i in enumerate(g_idx)]
    print(f"greedy HTTP replies vs generate_batch: tokens equal up to the first near tie "
          f"(top-two gap < {DECODE_LOGIT_TOL:g}) on every request ({sum(held)} steps held)")

    beams = _beam_phase(gen, gen32, main, card)
    spec = _spec_phase(gen, gen32, main, card)
    _stale_mask_check(gen32)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else float("nan")
    phase_s = time.perf_counter() - t_phase

    layers = main.layers
    print(f"phase 16 kernel launches: whole-head forward {main.launches['fwd']} ({layers['fwd']} "
          f"prefill layers), decode {main.launches['decode']} ({layers['decode']} decode-step "
          f"layers); peak memory {peak:.2f} GiB (both models, {card}); {phase_s:.1f} s")
    for k in ("fwd", "decode"):
        _require(main.launches[k] == layers[k] and layers[k] > 0,
                 f"{k}: {main.launches[k]} launches for {layers[k]} layers")
    del gen, gen32
    if cuda:
        torch.cuda.empty_cache()
    return {"fwd": main.launches["fwd"], "decode": main.launches["decode"],
            "engine": engine_load, "coalescing": coalesced_load, "beams": beams, "spec": spec,
            "peak_gib": peak, "seconds": phase_s}


# --------------------------------------- the train CLI's remaining flags
def _with_width(argv, dev, width):
    """FEATURES_CLI at `width` (a dict of flag -> value: a small CPU run) and
    with --cpu on the CPU."""
    argv = list(argv)
    for flag, value in (width or {}).items():
        argv[argv.index(flag) + 1] = str(value)
    return argv + (["--cpu"] if dev == "cpu" else [])


def _trace_kernels(trace_dir):
    """(train_step ranges, kernel names) of a `--profile_dir` Chrome trace."""
    with open(Path(trace_dir) / "trace_p0.json") as f:
        events = json.load(f)["traceEvents"]
    # each range is a host event ("user_annotation"; on the card also a
    # "gpu_user_annotation" copy)
    steps = sum(e.get("name") == "train_step" and e.get("cat") == "user_annotation"
                for e in events)
    return steps, {e["name"] for e in events if e.get("cat") == "kernel"}


def _features_cli(card, workdir, dev, width):
    """Phase 17 (a).  -> (launches of the uninterrupted run and of the
    evaluations, readings)."""
    import torch

    from neko_tpu_torch.cli import evaluate as cli_evaluate
    from neko_tpu_torch.data.episodes import H5EpisodeDataset
    from neko_tpu_torch.training.trainer import Trainer
    from neko_tpu_torch.utils import checkpoint as ckpt

    base = _with_width(FEATURES_CLI, dev, width) + [
        "--training_steps", str(FEATURES_CALLS), "--log_eval_freq", str(FEATURES_EVAL_FREQ)]
    trace = workdir / "trace"
    t0 = time.perf_counter()
    tr, rec, launches, _ = train_cli(base + ["--profile_dir", str(trace)], workdir / "a")
    run_s = time.perf_counter() - t0
    cfg, layers, state = tr.ctx.model_cfg, tr.ctx.model_cfg.layers, tr.state
    updates, chunks = tr.ctx.update_count(state), _chunks_of(tr.target_budget)
    exp_a = tr.exp_dir
    del tr, state
    losses = rec["losses"]
    _require(len(losses) == FEATURES_CALLS and all(np.isfinite(losses)),
             f"{len(losses)} losses, or not finite: {losses}")
    _require((cfg.dtype, cfg.remat, cfg.activation_fn, cfg.stochastic_depth)
             == ("bfloat16", True, "geglu", 0.1), f"the flags did not reach the config: {cfg}")
    logs = _iteration_logs(exp_a)
    trainer_ms = logs[-1]["time/training"] / FEATURES_EVAL_FREQ * 1e3
    print(f"train CLI {cfg.embed_dim}d/{layers}L/{cfg.heads}h k={cfg.context_len} B=16 (text "
          f"+ the two HDF5 fixtures) fp16 (bf16), stochastic depth 0.1, remat, GEGLU, EMA 0.999, "
          f"k = {FEATURES_K}: {FEATURES_CALLS} calls in {run_s:.1f} s, {updates} updates; "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"Trainer step at k = {FEATURES_K} with remat (calls {FEATURES_EVAL_FREQ + 1}-"
          f"{FEATURES_CALLS}, time/training / {FEATURES_EVAL_FREQ}): {trainer_ms:.3f} ms ({card})")
    _require(updates == FEATURES_CALLS // FEATURES_K, f"the schedule counted {updates} updates")
    steps, kernels = _trace_kernels(trace)
    named = {what: sorted(k for k in kernels if pat in k)[:2] for what, pat in (
        ("#3", "attention_fwd_kernel"), ("#4", "attention_bwd_"), ("#15", "fused_logz_tl"))}
    print(f"--profile_dir trace: {steps} train_step ranges, {len(kernels)} kernel names; "
          + "; ".join(f"{k}: {v}" for k, v in named.items()))
    _require(steps == 2, f"the trace holds {steps} steps")
    if dev != "cpu":
        _require(all(named.values()), f"the trace misses a kernel: {named}")
        print(f"kernel launches in the run: whole-head forward {launches['fwd']} (2 x {layers} "
              f"layers x {FEATURES_CALLS} calls: remat recomputes it), backward "
              f"{launches['bwd']}, loss head {launches['loss']} ({chunks} chunks a call)")
        _require(launches["fwd"] == 2 * layers * FEATURES_CALLS,
                 f"whole-head forward launches {launches['fwd']}")
        _require(launches["bwd"] == layers * FEATURES_CALLS, f"backward launches {launches}")
        _require(launches["loss"] == chunks * FEATURES_CALLS, f"loss head launches {launches}")

    # a stop after call FEATURES_STOP (inside a window), resumed to the end
    step = Trainer.train_step

    def stop_after(self):
        if self.steps > FEATURES_STOP:
            raise KeyboardInterrupt(f"stopped inside call {self.steps}")
        return step(self)

    Trainer.train_step = stop_after
    try:
        train_cli(base, workdir / "b")
    except KeyboardInterrupt as e:
        print(f"run b: {e}")
    finally:
        Trainer.train_step = step
    ckpt_b = ckpt.latest_checkpoint(str(next((workdir / "b").iterdir())))
    _require(ckpt_b.endswith(f"checkpoint_{FEATURES_STOP}"), f"emergency checkpoint {ckpt_b}")
    held = torch.load(f"{ckpt_b}/{ckpt.TRAIN_STATE}", weights_only=True)["mini_step"]
    _require(held == FEATURES_STOP % FEATURES_K, f"the checkpoint holds mini-step {held}")
    want = losses[FEATURES_STOP:]
    resume = base + ["--resume_from", ckpt_b, "--no_save_model"]
    _, rec_c, _, _ = train_cli(resume, workdir / "c")
    gap = max(abs(a - b) for a, b in zip(rec_c["losses"], want))
    load = ckpt.load_checkpoint

    def dropped(path, ctx):
        st = load(path, ctx)
        for v in st.accum.values():
            v.zero_()
        st.mini_step = 0
        return st

    ckpt.load_checkpoint = dropped
    try:
        _, rec_f, _, _ = train_cli(resume, workdir / "f")
    finally:
        ckpt.load_checkpoint = load
    gap_f = max(abs(a - b) for a, b in zip(rec_f["losses"], want))
    print(f"resume after call {FEATURES_STOP} (mini-step {held} of {FEATURES_K}) to "
          f"{FEATURES_CALLS}: largest loss difference {gap:.3e} (tolerance "
          f"{RESUME_LOSS_TOL:g}); planted '{FEATURES_RESUME_FAULT}': {gap_f:.3e}")
    _require(len(rec_c["losses"]) == len(want) and gap <= RESUME_LOSS_TOL,
             f"resumed losses {rec_c['losses']} against {want}")
    _require(gap_f > RESUME_LOSS_TOL, "the resume check cannot tell a dropped accumulator")

    # the evaluation CLI on the checkpoint, the weights and the EMA shadow
    path = ckpt.latest_checkpoint(exp_a)
    _require(path.endswith(f"checkpoint_{FEATURES_CALLS}"), f"last checkpoint {path}")
    counters = _launch_counters()
    nll, eval_launches = {}, {"fwd": 0, "decode": 0}
    for use_ema in (False, True):
        for fn in counters.values():
            fn.launches = 0
        argv = ["--model_path", path, "--eval_episodes", "0", "--eval_text_num_examples",
                str(FEATURES_EVAL_TEXT)] + (["--cpu"] if dev == "cpu" else [])
        logs_e = cli_evaluate.main(argv + (["--use_ema"] if use_ema else []))
        nll[use_ema] = logs_e["evaluation/text/loss"]
        for k in eval_launches:
            eval_launches[k] += counters[k].launches
    print(f"cli.evaluate on {path.rsplit('/', 1)[-1]}: text target NLL {nll[False]:.6f}, with "
          f"--use_ema {nll[True]:.6f}; #1 {eval_launches['fwd']}, #14 "
          f"{eval_launches['decode']} launches")
    _require(all(np.isfinite(list(nll.values()))) and nll[True] != nll[False],
             f"--use_ema evaluated the weights: {nll}")

    ds = H5EpisodeDataset(str(FIXTURES / "neko-synth-dict-v0.h5"))
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        for i in range(len(ds)):
            ds.get_episode(i)
    read_ms = (time.perf_counter() - t0) * 1e3 / (reps * len(ds))
    ds.close()
    print(f"one HDF5 fixture episode (neko-synth-dict-v0, host numpy reader): {read_ms:.4f} ms")
    return ({"fwd": launches["fwd"] + eval_launches["fwd"], "bwd": launches["bwd"],
             "loss": launches["loss"], "decode": eval_launches["decode"]},
            {"trainer_ms": trainer_ms, "resume_gap": gap, "episode_read_ms": read_ms,
             "nll": nll})


def _remat_step(card, dev, width):
    """Phase 17 (b).  -> (launches of #3 and #4 in the two steps, readings)."""
    import torch

    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.models import transformer as tfm
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.training.train_state import TrainContext

    cfg0, ctx0, _, batch, B = bench.setup(width or "flagship", dev, SEED)
    sd = init_state_dict(cfg0, SEED)
    out = {}
    for remat in (False, True):
        cfg = cfg0.replace(stochastic_depth=0.1, remat=remat)
        ctx = TrainContext(cfg, ctx0.opt_cfg, device=dev, seed=SEED)
        whk.whole_head_attention.launches = whk.whole_head_attention_bwd.launches = 0
        loss, grads = _step_loss_and_grads(ctx, sd, batch)
        counts = (whk.whole_head_attention.launches, whk.whole_head_attention_bwd.launches)
        fault = None
        if not remat:  # the run-to-run gap of the step itself
            repeat = _grad_gap(_step_loss_and_grads(ctx, sd, batch)[1], grads)
        else:
            replay = tfm.replay_generator
            tfm.replay_generator = lambda generator, state: generator
            try:
                fault = _step_loss_and_grads(ctx, sd, batch)
            finally:
                tfm.replay_generator = replay
        state = ctx.init_state({k: v.clone() for k, v in sd.items()})
        bench.time_steps(ctx, state, batch, 2)
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        dt, _ = bench.time_steps(ctx, state, batch, 5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev != "cpu" else float("nan")
        out[remat] = dict(loss=loss, grads=grads, counts=counts, fault=fault,
                          ms=dt * 1e3 / 5, peak=peak)
        del state
    off, on = out[False], out[True]
    dloss, gap = abs(on["loss"] - off["loss"]), _grad_gap(on["grads"], off["grads"])
    fault_gap = _grad_gap(on["fault"][1], off["grads"])
    print(f"one flagship step {cfg0.embed_dim}d/{cfg0.layers}L B={B} dropout 0.1, stochastic "
          f"depth 0.1, remat vs none (same weights, batch and step generator): loss "
          f"{on['loss']:.6f} vs {off['loss']:.6f} (diff {dloss:.3e}, tolerance "
          f"{REMAT_LOSS_TOL:g}); largest relative gradient error {gap:.3e} (tolerance "
          f"{REMAT_GRAD_TOL:g}; the step without remat against itself {repeat:.3e}); "
          f"planted '{REMAT_FAULT}': {fault_gap:.3e}")
    print(f"launches in one step: #3 {on['counts'][0]} with remat, {off['counts'][0]} without; "
          f"#4 {on['counts'][1]} and {off['counts'][1]}")
    print(f"train step with remat {on['ms']:.3f} ms, peak memory {on['peak']:.3f} GiB; without "
          f"{off['ms']:.3f} ms, {off['peak']:.3f} GiB ({card})")
    _require(dloss <= REMAT_LOSS_TOL and gap <= REMAT_GRAD_TOL,
             f"remat changes the step: {dloss}, {gap}")
    _require(fault_gap > REMAT_GRAD_TOL, "the remat check cannot tell the live generator")
    if dev != "cpu":
        L = cfg0.layers
        _require(on["counts"] == (2 * L, L) and off["counts"] == (L, L),
                 f"launches {on['counts']} with remat, {off['counts']} without")
    return ({"fwd": on["counts"][0] + off["counts"][0],
             "bwd": on["counts"][1] + off["counts"][1]},
            {"remat_ms": on["ms"], "plain_ms": off["ms"], "remat_peak_gib": on["peak"],
             "plain_peak_gib": off["peak"], "remat_grad_gap": gap})


def _fused_ema(card, dev, width):
    """Phase 17 (c).  -> (#16 launches, readings)."""
    from neko_tpu_torch import bench
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.ops import fused_adamw as fa
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    cfg, _, _, batch, _ = bench.setup(width or "flagship", dev, SEED)
    sd = init_state_dict(cfg, SEED)
    losses, ema_ms = {}, None
    for fused in (False, True):
        opt = OptimizerConfig(learning_rate=1e-3, init_lr=1e-3, warmup_steps=1,
                              disable_cosine_decay=True, ema_decay=0.999, fused_adamw=fused)
        ctx = TrainContext(cfg, opt, device=dev, seed=SEED)
        state = ctx.init_state({k: v.clone() for k, v in sd.items()})
        fa.fused_adamw_apply.launches = 0
        _, losses[fused] = bench.time_steps(ctx, state, batch, FEATURES_FUSED_STEPS)
        launches = fa.fused_adamw_apply.launches
        moved = max((e - sd[n].to(e.device)).abs().max().item() for n, e in state.ema.items())
        _require(moved > 0, "the EMA shadow did not move")
        if fused and dev != "cpu":
            ema_ms = _device_ms(lambda: ctx._update_ema(state), iters=20)
        del state
    gap = max(abs(a - b) for a, b in zip(losses[True], losses[False]))
    n = sum(v.numel() for v in sd.values())
    print(f"{FEATURES_FUSED_STEPS} steps with EMA 0.999, fused AdamW (#16 launches {launches}) "
          f"vs the default route: largest loss difference {gap:.3e} (tolerance "
          f"{FUSED_STEP_LOSS_TOL:g})")
    if ema_ms is not None:
        bound = 3 * 4 * n / PEAK_HBM_BYTES * 1e3
        print(f"EMA update over {n:,} fp32 parameters: {ema_ms:.4f} ms device time, bound "
              f"{bound:.4f} ms (2 reads + 1 write of the tree) ({card})")
    _require(gap <= FUSED_STEP_LOSS_TOL, f"fused + EMA losses {losses}")
    if dev != "cpu":
        _require(launches == FEATURES_FUSED_STEPS, f"#16 launches {launches}")
    return launches, {"ema_ms": ema_ms, "fused_gap": gap}


def _lora_geglu_serving(card, dev, width):
    """Phase 17 (d).  -> (launches of #1 and #14 on the kernel side, readings)."""
    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.inference.generator import Generator

    ls = LORA_SERVE
    cfg = ModelConfig(**dict(width or FLAGSHIP, max_patches=0, dropout=0.0, lora_r=ls["lora_r"],
                             lora_alpha=ls["lora_alpha"], activation_fn=ls["activation_fn"]))
    sd = init_state_dict(cfg, SEED)
    rng = np.random.default_rng(SEED)
    for k in sd:
        if "lora_b" in k:
            sd[k] = torch.from_numpy(
                rng.standard_normal(tuple(sd[k].shape)).astype(np.float32) * LORA_B_STD)
    gen = Generator(build_model(cfg, sd, dev), seed=SEED)
    B, P, T = ls["B"], min(ls["prompt"], cfg.context_len // 2), ls["new"]
    examples = [{"text": list(rng.integers(1, cfg.text_tokens, size=P))} for _ in range(B)]
    ts = cfg.token_space
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0
    (tokens,) = gen.generate_batch(examples, max_new_tokens=T, start=ts.start("text"),
                                   end=ts.end("text"), return_logits=False)
    launches = {k: counters[k].launches for k in ("fwd", "decode")}
    V = cfg.vocab_size
    arrays = gen.packer.pack_batch(examples, pad_side="right")
    lengths = arrays.pop("lengths")

    def prefill_logits():
        with torch.inference_mode():
            emb = gen.model.embed_batch(to_device_batch(arrays, dev))
            mask = torch.from_numpy(np.arange(cfg.context_len)[None, :] < lengths[:, None])
            last = torch.as_tensor(lengths - 1, device=dev)
            return gen.model.prefill(emb, mask.to(dev), last=last)[0][:, :V]

    got = prefill_logits()
    with prefill_attention_through(plain_prefill_attention):
        want = prefill_logits()
    faults = {}
    for f in LORA_PREFILL_FAULTS:
        with prefill_attention_through(lambda *a, f=f: plain_prefill_attention(*a, fault=f)):
            faults[f"prefill: {f}"] = ((prefill_logits() - want).abs().max().item(), LOGIT_TOL)
    err = (got - want).abs().max().item()
    got_d = _teacher_forced_logits(gen, examples, tokens)[:, :V]
    with decode_attention_through(plain_decode_attention):
        want_d = _teacher_forced_logits(gen, examples, tokens)[:, :V]
    for f in LORA_DECODE_FAULTS:
        with decode_attention_through(lambda *a, f=f: plain_decode_attention(*a, fault=f)):
            bad = _teacher_forced_logits(gen, examples, tokens)[:, :V]
        faults[f"decode: {f}"] = ((bad - want_d).abs().max().item(), DECODE_LOGIT_TOL)
    err_d = (got_d - want_d).abs().max().item()
    print(f"LoRA (r {cfg.lora_r}, alpha {cfg.lora_alpha}, lora_b ~ N(0, {LORA_B_STD})) + GEGLU "
          f"{cfg.embed_dim}d/{cfg.layers}L, {B} prompts of {P} tokens, {T} new: prefill logits "
          f"kernel vs plain {err:.3e} (tolerance {LOGIT_TOL:g}; logit std "
          f"{want.std().item():.3f}); last-step logits after {T - 1} decode steps {err_d:.3e} "
          f"(tolerance {DECODE_LOGIT_TOL:g}); #1 {launches['fwd']}, #14 {launches['decode']} "
          f"launches")
    for f, (e, _) in faults.items():
        print(f"control '{f}': logits max abs err {e:.3e}")
    _require(torch.isfinite(got).all() and torch.isfinite(got_d).all(), "logits not finite")
    _require(err <= LOGIT_TOL and err_d <= DECODE_LOGIT_TOL,
             f"LoRA + GEGLU logits disagree: {err}, {err_d}")
    blind = [f for f, (e, tol) in faults.items() if not e > tol]
    _require(not blind, f"the LoRA + GEGLU checks cannot tell these planted faults: {blind}")
    if dev != "cpu":
        _require(launches["fwd"] == cfg.layers and launches["decode"] == cfg.layers * (T - 1),
                 f"launches {launches}")
    return launches, {"prefill_err": err, "decode_err": err_d}


def train_features(card: str, workdir, dev="cuda", width=None) -> dict:
    """Phase 17 (at the flagship width unless `width`: {"cli": flag values,
    "model": a FLAGSHIP-form dict, "bench": a CONFIGS-form dict}, for a
    small CPU run).  -> the main path's launches ("fwd", "bwd", "loss",
    "adamw", "decode") and the readings."""
    width = width or {}
    cli_launches, cli = _features_cli(card, workdir, dev, width.get("cli"))
    remat_launches, remat = _remat_step(card, dev, width.get("bench"))
    adamw, fused = _fused_ema(card, dev, width.get("bench"))
    serve_launches, lora = _lora_geglu_serving(card, dev, width.get("model"))
    return {"fwd": cli_launches["fwd"] + remat_launches["fwd"] + serve_launches["fwd"],
            "bwd": cli_launches["bwd"] + remat_launches["bwd"], "loss": cli_launches["loss"],
            "adamw": adamw, "decode": cli_launches["decode"] + serve_launches["decode"],
            **cli, **remat, **fused, **lora}


# ------------------------------------------------- training over processes
def rank_attention_vs_plain(card: str, shapes, g, seed_value: int, errs: dict,
                            dev="cuda", hd=None, rates=(RATE,)) -> dict:
    """#3 / #4 at the (B, H) `shapes` a rank gives them (S = 1024, hd 32 or
    `hd`, bf16, at each of `rates`; inputs from `g`) against the plain
    version, their largest errors into `errs`.  -> {(B, H):
    `_attention_train_times`} (at RATE)."""
    import torch

    from neko_tpu_torch.ops import attention_kernel as whk

    S, hd = TRAIN["S"], hd or TRAIN["hd"]
    seed = torch.tensor([seed_value], dtype=torch.int32, device=dev)
    times = {}
    for B, H in shapes:
        D = H * hd
        qkv = torch.randn(B, S, 3 * D, device=dev, generator=g).bfloat16()
        start, end = _train_bounds(B, S, dev)
        valid = _valid_rows(start, end, S)
        dout = torch.randn(B, S, D, device=dev, generator=g).bfloat16() * valid[..., None]
        ks = whk.dropout_keep_scale(seed, B, H, S, RATE)
        for rate in rates:
            x = qkv.clone().requires_grad_()
            out = whk.whole_head_attention_qkv(x, start, end, seed, heads=H, dropout_rate=rate)
            (dx,) = torch.autograd.grad(out, (x,), dout)
            xp = qkv.clone().requires_grad_()
            ref = whk.whole_head_attention_reference(
                *whk._qkv_views("qkv", (xp,), H), start, end, None,
                ks if rate > 0 else None).transpose(1, 2).reshape(B, S, D)
            (dxp,) = torch.autograd.grad(ref, (xp,), dout)
            torch.cuda.synchronize()
            err, excess, _ = _fwd_excess(out[valid], ref[valid], "bfloat16")
            berr, bexcess = 0.0, -1.0
            for got, want in zip(dx.chunk(3, -1), dxp.chunk(3, -1)):
                e, x_, _ = _flip_excess(got, want, GRAD_TOL["bfloat16"], GRAD_FLIP_TOL)
                berr, bexcess = max(berr, e), max(bexcess, x_)
            print(f"per-rank attention B={B} H={H} S={S} hd={hd} bf16 rate {rate}: out max abs "
                  f"err {err:.3e} (excess {excess:.3e}), dq/dk/dv {berr:.3e} (excess "
                  f"{bexcess:.3e})")
            _require(excess <= 0 and bexcess <= 0,
                     f"#3 / #4 disagree at B={B}, H={H}, hd={hd}, rate {rate}")
            errs["fwd"] = max(errs.get("fwd", 0.0), err)
            errs["bwd"] = max(errs.get("bwd", 0.0), berr)
            del x, out, dx, xp, ref, dxp
        times[(B, H)] = _attention_train_times(qkv, dout, seed, ks, H, card)
        del qkv, dout, ks

    return times


def parallel_kernels_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 18's kernels on the shapes one rank gives them: #3 / #4 on
    each rank's rows and heads (PARALLEL_ATTN), #15 on each rank's block
    of the vocabulary with targets of both blocks (another block's scores
    0), #16 over a rank's shards of the flagship tree under (data=2, fsdp).
    -> {"attn": {(B, H): times}, "loss": ..., "adamw": ..., "err": {...}}."""
    import torch

    from neko_tpu_torch import bench, convert
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.parallel import sharding
    from neko_tpu_torch.parallel.collectives import LOCAL, Axis
    from neko_tpu_torch.parallel.mesh import AXES, Mesh

    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    res = {"err": {}}
    res["attn"] = rank_attention_vs_plain(card, PARALLEL_ATTN, g, SEED + 18, res["err"], dev)

    cfg = bench.model_config("flagship")
    V, D, valid_vocab = cfg.padded_vocab_size, cfg.embed_dim, cfg.vocab_size
    n, rows = 4096, cfg.padded_vocab_size // 2
    x = (torch.randn(n, D, device=dev, generator=g) * 0.5).bfloat16()
    W = (torch.randn(V, D, device=dev, generator=g) * 0.05).bfloat16()
    t = torch.randint(0, valid_vocab, (n,), device=dev, generator=g)
    worst, times = 0.0, {}
    for r in range(2):
        Wr = W[r * rows:(r + 1) * rows].contiguous()
        tr = t - r * rows
        vr = max(0, min(rows, valid_vocab - r * rows))
        logz, tl = lk.fused_logz_tl(x, tr, Wr, vr)
        want = lk.fused_logz_tl_reference(x, tr, Wr, vr)
        torch.cuda.synchronize()
        errs = [_excess(a, b, LOSS_TOL) for a, b in zip((logz, tl), want)]
        outside = ((tr < 0) | (tr >= rows))
        print(f"loss head on vocabulary block {r} ([{n}, {D}] x {rows}, {vr} valid, "
              f"{int(outside.sum())} targets in the other block): logz, tl max abs err "
              f"{errs[0][0]:.3e}, {errs[1][0]:.3e} (tolerance {LOSS_TOL}); other block's "
              f"targets score {float(tl[outside].abs().max()):.1e}")
        _require(all(x_ <= 0 for _, x_ in errs) and not tl[outside].any(),
                 f"#15 disagrees on vocabulary block {r}")
        worst = max(worst, errs[0][0], errs[1][0])
        run_k = lambda: lk.fused_logz_tl(x, tr, Wr, vr)  # noqa: E731
        route = lambda: lk.logits_logz_tl(x, tr, Wr, vr)  # noqa: E731
        run_p = lambda: lk.fused_logz_tl_reference(x, tr, Wr, vr)  # noqa: E731
        r1, k1, k2, r2 = (_time_ms(f, 10) for f in (route, run_k, run_k, route))
        p1, p2 = _time_ms(run_p, 5), _time_ms(run_p, 5)
        flops = 2 * n * D * vr
        bound = _bound(flops, (n * D + vr * D) * 2 + n * 4 + 2 * n * 4)
        ms = (k1 + k2) / 2
        print(f"loss head block {r}: kernel {k1:.4f} / {k2:.4f} ms ({_tflops(flops, ms):.1f} "
              f"TFLOP/s), loss route (cuBLAS) {r1:.4f} / {r2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}) ({card})")
        times[r] = {"ms": ms, "plain_ms": (p1 + p2) / 2, "bound_ms": bound[0],
                    "bound_by": bound[1], "library_ms": (r1 + r2) / 2, "valid": vr,
                    "tflops": _tflops(flops, ms)}
    res["loss"], res["err"]["loss"] = times, worst
    del x, W, t

    # #16 over rank 0's shards of the flagship tree under (data=2, fsdp)
    shapes = convert.model_shapes(cfg)
    specs = sharding.layout(shapes, 1, 2, fsdp=True)
    mesh = Mesh(AXES, (2, 1, 1), None, (Axis(2, 0), LOCAL, LOCAL))
    res["adamw"] = adamw_vs_plain(
        card, [sharding.local_shape(s, specs[k], mesh) for k, s in shapes.items()], g,
        f"a rank's shards (data=2, fsdp), of {sum(s.numel() for s in shapes.values())}", dev)
    return res


def adamw_vs_plain(card: str, shapes, g, what: str, dev="cuda") -> dict:
    """#16 over tensors of `shapes` (inputs from `g`) against its plain
    version, bit for bit, then timed in turns beside torch's fused AdamW.
    -> the JSON timing fields."""
    import torch

    from neko_tpu_torch.ops import fused_adamw as fa

    ps = [torch.randn(s, device=dev, generator=g) * 0.02 for s in shapes]
    grads = [torch.randn(s, device=dev, generator=g) * 1e-3 for s in shapes]
    mu = [torch.randn(s, device=dev, generator=g) * 1e-4 for s in shapes]
    nu = [torch.rand(s, device=dev, generator=g) * 1e-7 for s in shapes]
    scale = torch.tensor(0.5, device=dev)
    kw = dict(lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, bc1=1 - 0.9 ** 3, bc2=1 - 0.95 ** 3)

    def run(apply):
        p2, m2, v2 = ([t.clone() for t in ts] for ts in (ps, mu, nu))
        apply(p2, grads, m2, v2, scale, **kw)
        return p2 + m2 + v2

    got, want = run(fa.fused_adamw_apply), run(fa.fused_adamw_apply_reference)
    torch.cuda.synchronize()
    unequal = sum(int((a != b).sum()) for a, b in zip(got, want))
    n_local = sum(p.numel() for p in ps)
    print(f"fused AdamW over {what}: {len(ps)} tensors, {n_local} parameters; {unequal} values "
          f"not bit-equal to the plain version")
    _require(unequal == 0, f"#16 over {what} differs from its plain version")
    del got, want
    run_k = lambda: fa.fused_adamw_apply(ps, grads, mu, nu, scale, **kw)  # noqa: E731
    run_p = lambda: fa.fused_adamw_apply_reference(ps, grads, mu, nu, scale, **kw)  # noqa: E731
    p1, k1, k2, p2 = (_time_ms(f, 10) for f in (run_p, run_k, run_k, run_p))
    lib_params = [torch.nn.Parameter(p.clone()) for p in ps]
    for lp, gr in zip(lib_params, grads):
        lp.grad = gr.clone()
    lib = _time_ms(torch.optim.AdamW(lib_params, lr=kw["lr"], betas=(kw["b1"], kw["b2"]),
                                     eps=kw["eps"], weight_decay=kw["wd"], fused=True).step, 10)
    bound = _bound(20 * n_local, 28 * n_local)
    print(f"fused AdamW over {n_local} parameters: kernel {k1:.4f} / {k2:.4f} ms, plain "
          f"{p1:.4f} / {p2:.4f} ms, library (torch fused AdamW) {lib:.4f} ms, bound "
          f"{bound[0]:.4f} ms ({bound[1]}) ({card})")
    del ps, grads, mu, nu, lib_params
    torch.cuda.empty_cache()
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib, "parameters": n_local}


def _split_axis(run) -> str:
    """The axis whose limits hold a configuration: 'seq' or 'pipe' when it
    has one, else 'model' when it splits the model, else 'data'."""
    for ax in ("seq", "pipe", "model"):
        if run[ax] > 1:
            return ax
    return "data"


def _run_name(run) -> str:
    return ", ".join([f"{k}={run[k]}" for k in ("data", "seq", "pipe", "model") if run[k] > 1]
                     + ([f"{run['schedule']} x {run['micro']}"] if run["pipe"] > 1 else [])
                     + ([f"k={run['k']}, {run['rows']} rows"] if run["k"] else [])
                     + (["chunked loss"] if run["loss"] == "chunked" else [])
                     + [k for k in ("fsdp", "fused_adamw") if run[k]]
                     + ([f"dropout {run['dropout']}"] if run["dropout"] else []))


def _expected_launches(run, r, layers: int, steps: int) -> dict:
    """The launches a rank's steps must show: #3 / #4 a layer and a
    microbatch (a stage's layers; 1F1B runs the forward of a stage that is
    not the last twice), the ring kernels #11-#13 a layer and a visible pair
    (rank i of 'seq' sees i + 1 pairs), #15 a loss chunk (the last stage's
    under 'pipe'), #16 a step under fused_adamw."""
    seq_i, stage = r["seq_pipe"]
    adamw = steps if run["fused_adamw"] else 0
    if run["seq"] > 1:
        pairs = layers * steps * (seq_i + 1)
        return {"fwd": 0, "bwd": 0, "ring_fwd": pairs, "ring_dq": pairs, "ring_dkv": pairs,
                "loss": r["loss_chunks"] * steps, "adamw": adamw}
    if run["pipe"] > 1:
        lp, m = layers // run["pipe"], run["micro"]
        last = stage == run["pipe"] - 1
        once = 1 if last or run["schedule"] == "gpipe" else 2
        loss = 0 if not last else r["loss_chunks"] * steps * (
            m if run["schedule"] == "1f1b" else 1)
        return {"fwd": lp * m * steps * once, "bwd": lp * m * steps, "ring_fwd": 0,
                "loss": loss, "adamw": adamw}
    return {"fwd": layers * steps, "bwd": layers * steps, "loss": r["loss_chunks"] * steps,
            "adamw": adamw}


def _parallel_runs(card: str, runs=PARALLEL_RUNS, phase=18, width="flagship", dev="cuda",
                   steps=PARALLEL_STEPS) -> dict:
    """`runs` through the tool in one spawn of the ranks: the limits against
    the sound and planted readings, the launches of each rank.  -> {"launches"
    (the sound runs' sums over the ranks), "readings", "results"}."""
    import check_torch_parallel_ranks as tool

    t0 = time.perf_counter()
    results = tool.run_ranks(list(runs), backend="gloo", device=dev, width=width, steps=steps,
                             seed=SEED, timeout=900)
    world = len(results[0]["ranks"])
    print(f"phase {phase} ranks: {len(results)} configurations in "
          f"{time.perf_counter() - t0:.1f} s (one spawn of {world} ranks, gloo, all on the card)")
    layers = tool.WIDTHS[width]["shape"]["layers"]
    sound, faults = {}, {}
    launches = {}
    readings = []
    for res in results:
        run, ranks = res["run"], res["ranks"]
        name = _run_name(run)
        line = {"run": name, "fault": run["fault"], "losses": [r["losses"] for r in ranks],
                "loss_err": res["loss_err"], "param_err": res["param_err"],
                "norm_err": res["norm_err"], "replica_err": res["replica_err"],
                "peer_grad_err": res["peer_grad_err"],
                "micro_mask_share": res["micro_mask_share"],
                "peak_saved_inputs": [r["peak_saved_inputs"] for r in ranks],
                "launches": [r["launches"] for r in ranks],
                "collective_ms_per_step": [r["collective"]["ms"] for r in ranks],
                "collective_bytes_per_step": [r["collective"]["bytes"] for r in ranks],
                "collective_calls_per_step": [r["collective"]["calls"] for r in ranks],
                "step_ms": [r["step_ms"] for r in ranks],
                "peak_gib": [(r["peak_bytes"] or 0) / 2 ** 30 for r in ranks],
                "activation_peak_gib": [(r["activation_peak_bytes"] or 0) / 2 ** 30
                                        for r in ranks],
                "resting_bytes": [r["resting_bytes"] for r in ranks],
                "one_process_resting_bytes": (res["one_process"]["resting_bytes"]
                                              if res["one_process"] else None)}
        readings.append(line)
        print(f"phase {phase} [{name}{'; planted: ' + run['fault'] if run['fault'] else ''}]: "
              + json.dumps({k: v for k, v in line.items() if k not in ("run", "fault")})
              + f" ({card})")
        _require(all(np.isfinite(r["losses"]).all() for r in ranks), f"non-finite loss: {name}")
        if run["fault"]:
            faults[run["fault"]] = res
            continue
        sound[name] = res
        for r in ranks:
            want = _expected_launches(run, r, layers, steps)
            got = {k: r["launches"][k] for k in want}
            # (a CPU rehearsal runs the plain versions: nothing launches)
            _require(got == want or dev == "cpu",
                     f"[{name}] rank {r['rank']} launches {got}, want {want}")
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        _require(res["replica_err"] == 0.0, f"[{name}] replicas differ: {res['replica_err']}")
        if run["dropout"] and run["model"] > 1:
            _require(res["peer_grad_err"] <= PARALLEL_PEER_TOL,
                     f"[{name}] model peers' gradients differ: {res['peer_grad_err']}")
        if res["micro_mask_share"] is not None:
            _require(res["micro_mask_share"] <= tool.MICRO_SHARE_TOL,
                     f"[{name}] microbatches share masks: {res['micro_mask_share']}")
        if res["loss_err"] is None:
            continue
        ax = _split_axis(run)
        _require(res["loss_err"] <= PARALLEL_LOSS_TOL[ax]
                 and res["param_err"] <= PARALLEL_PARAM_TOL[ax]
                 and res["norm_err"] <= PARALLEL_NORM_TOL[ax],
                 f"[{name}] the ranks disagree with one process: {res['loss_err']}, "
                 f"{res['param_err']}, {res['norm_err']}")
    # each limit between its sound reading and the faults it sees
    limits = {"loss_err": PARALLEL_LOSS_TOL, "param_err": PARALLEL_PARAM_TOL,
              "norm_err": PARALLEL_NORM_TOL}
    for ax in sorted({_split_axis(r["run"]) for r in sound.values()}):
        for key, tol in limits.items():
            held = [r[key] for r in sound.values()
                    if r[key] is not None and _split_axis(r["run"]) == ax]
            caught = {f: r[key] for f, r in faults.items() if _split_axis(r["run"]) == ax
                      and r[key] is not None and r[key] > tol[ax]}
            print(f"{key} limit ({ax}) {tol[ax]:g}: sound {max(held, default=0.0):.3e}; faults "
                  "over it: " + (", ".join(f"'{f}' {v:.3e}" for f, v in caught.items())
                                 or "none"))
    for f, r in faults.items():
        run = r["run"]
        if run["dropout"] and run["model"] > 1:
            seen = r["peer_grad_err"] > PARALLEL_PEER_TOL
        elif r["micro_mask_share"] is not None:
            seen = r["micro_mask_share"] > tool.MICRO_SHARE_TOL
        else:
            seen = r["replica_err"] > 0 or any(
                r[key] is not None and r[key] > tol[_split_axis(run)]
                for key, tol in limits.items())
        _require(seen, f"phase {phase} cannot tell the planted '{f}'")
    return {"launches": launches, "readings": readings, "results": results}


def _parallel_cli(card: str, workdir, argv=None, dev="cuda", mesh=None) -> dict:
    """The train CLI over 2 ranks (torchrun's environment given to each;
    by default `--multihost --mesh_model_axis 2`): RANK_CLI_STEPS steps, an
    evaluation and a checkpoint on rank 0; the checkpoint restored in one process holds
    the parameters the ranks gathered, bit for bit.  -> the CLI's launches
    summed over the ranks."""
    import torch

    import check_torch_parallel_ranks as tool

    from neko_tpu_torch.cli.build import build_context, resolve_checkpoint_and_args
    from neko_tpu_torch.utils.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    argv = PARALLEL_CLI if argv is None else argv
    mesh = mesh or {"data": 1, "seq": 1, "model": 2}
    ranks, final = tool.cli_ranks(argv + ["--save_dir", str(workdir)], 2, cpu=dev == "cpu",
                                  params=True, timeout=600)
    layers = int(argv[argv.index("--layers") + 1])
    flags = " ".join(a for a in argv if a.startswith("--mesh") or a.startswith("--pipeline"))
    wall = time.perf_counter() - t0
    exp = ranks[0]["exp_dir"]
    logs = _iteration_logs(exp)
    evals = {k: v for k, v in logs[-1].items() if k.startswith("evaluation/")}
    print(f"train CLI over 2 ranks (--multihost {flags}, gloo on the card): "
          f"{ranks[0]['steps']} steps in {wall:.1f} s of wall time, train loss mean "
          f"{logs[-1]['training/train_loss_mean']:.4f}, step time "
          f"{logs[-1]['time/training'] / RANK_CLI_STEPS * 1e3:.1f} ms; evaluation {evals}; "
          f"launches "
          f"{[r['launches'] for r in ranks]} ({card})")
    _require(evals and all(np.isfinite(v) for v in evals.values()),
             f"the CLI's evaluation is missing or not finite: {evals}")
    _require(all(r["steps"] == RANK_CLI_STEPS and r["mesh"] == mesh for r in ranks),
             f"the CLI ranks did not train {RANK_CLI_STEPS} steps over {mesh}: {ranks}")
    for r in ranks:
        _require(dev == "cpu"
                 or r["launches"]["loss"] >= RANK_CLI_STEPS * (mesh.get("pipe", 1) == 1)
                 and (r["launches"]["bwd"] == layers * RANK_CLI_STEPS if mesh.get("model", 1) > 1
                      else True)
                 and (r["launches"]["ring_dkv"] > 0 if mesh.get("seq", 1) > 1 else True)
                 and (r["launches"]["bwd"] > 0 if mesh.get("pipe", 1) > 1 else True),
                 f"CLI rank launches {r['launches']}")
    _require(dev == "cpu" or (ranks[0]["launches"]["decode"] > 0
                              and ranks[1]["launches"]["decode"] == 0
                              and ranks[0]["launches"]["fwd"] > ranks[1]["launches"]["fwd"]
                              and (ranks[1]["launches"]["fwd"] == layers * RANK_CLI_STEPS
                                   if mesh.get("model", 1) > 1 else True)),
             "the evaluation did not run on rank 0 alone")
    ckpt, args = resolve_checkpoint_and_args(exp, {"cpu": dev == "cpu", "device": dev})
    ctx, _ = build_context(args)
    state = load_checkpoint(ckpt, ctx)
    got = dict(state.model.named_parameters())
    diff = max(float((got[k].detach().cpu() - v).abs().max()) for k, v in final.items())
    print(f"checkpoint {ckpt} restored in one process: step {state.step}, mesh "
          f"{ctx.mesh}, largest difference from the ranks' gathered parameters {diff:.1e}")
    _require(state.step == RANK_CLI_STEPS and ctx.mesh is None and diff == 0.0,
             "the one-process restore differs from the ranks' parameters")
    del state, final
    torch.cuda.empty_cache()
    return {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}


def parallel_train(card: str, workdir) -> dict:
    """Phase 18.  -> {"kernels": parallel_kernels_vs_plain's, "launches":
    the main path's launches (the sound runs and the CLI, over the ranks)}."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    kernels = parallel_kernels_vs_plain(card)
    runs = _parallel_runs(card, width=RANK_WIDTH)
    cli = _parallel_cli(card, workdir)
    launches = {k: runs["launches"].get(k, 0) + cli.get(k, 0)
                for k in ("fwd", "bwd", "loss", "adamw", "decode")}
    print(f"phase 18 launches over the ranks (sound runs + the CLI): {launches}")
    return {"kernels": kernels, "launches": launches, "readings": runs["readings"]}


def pipeline_seq_kernels_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 19's kernels at the shapes its ranks give them, each against
    its plain version: the ring's pairs over 2 'seq' ranks at S_local 4096
    (#11-#13), #3 / #4 on a microbatch, #15 on 1F1B's chunk of a microbatch
    over the whole vocabulary, #16 over a stage's leaves (bit for bit).
    -> {"ring", "attn", "loss", "adamw", "err"}."""
    import torch

    from neko_tpu_torch import bench, convert
    from neko_tpu_torch.ops import loss_kernel as lk
    from neko_tpu_torch.parallel.collectives import LOCAL, Axis
    from neko_tpu_torch.parallel.mesh import PIPE_AXES, Mesh

    ring = ring_kernels_vs_plain(card, dev, n=2, bf16=(SEQ_RING,), fp32=(),
                                 pairs=((0, 0), (1, 0), (1, 1)),
                                 timed=(("diagonal", (1, 1)), ("full", (1, 0))), whole=False)
    g = torch.Generator(device=dev).manual_seed(SEED + 19)
    res = {"ring": ring, "err": dict(ring["err"])}
    res["attn"] = rank_attention_vs_plain(card, PIPE_ATTN, g, SEED + 19, res["err"], dev)

    cfg = bench.model_config("flagship")
    V, D, valid = cfg.padded_vocab_size, cfg.embed_dim, cfg.vocab_size
    n = PIPE_LOSS_ROWS
    x = (torch.randn(n, D, device=dev, generator=g) * 0.5).bfloat16()
    W = (torch.randn(V, D, device=dev, generator=g) * 0.05).bfloat16()
    t = torch.randint(0, valid, (n,), device=dev, generator=g)
    logz, tl = lk.fused_logz_tl(x, t, W, valid)
    want = lk.fused_logz_tl_reference(x, t, W, valid)
    torch.cuda.synchronize()
    errs = [_excess(a, b, LOSS_TOL) for a, b in zip((logz, tl), want)]
    print(f"loss head on 1F1B's microbatch chunk ([{n}, {D}] x {V}, {valid} valid): logz, tl "
          f"max abs err {errs[0][0]:.3e}, {errs[1][0]:.3e} (tolerance {LOSS_TOL})")
    _require(all(x_ <= 0 for _, x_ in errs), "#15 disagrees on 1F1B's microbatch chunk")
    res["err"]["loss"] = max(errs[0][0], errs[1][0])
    run_k = lambda: lk.fused_logz_tl(x, t, W, valid)  # noqa: E731
    route = lambda: lk.logits_logz_tl(x, t, W, valid)  # noqa: E731
    run_p = lambda: lk.fused_logz_tl_reference(x, t, W, valid)  # noqa: E731
    r1, k1, k2, r2 = (_time_ms(f, 10) for f in (route, run_k, run_k, route))
    p1, p2 = _time_ms(run_p, 5), _time_ms(run_p, 5)
    flops = 2 * n * D * valid
    bound = _bound(flops, (n * D + valid * D) * 2 + n * 4 + 2 * n * 4)
    ms = (k1 + k2) / 2
    print(f"loss head 1F1B chunk: kernel {k1:.4f} / {k2:.4f} ms ({_tflops(flops, ms):.1f} "
          f"TFLOP/s), loss route (cuBLAS) {r1:.4f} / {r2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}) ({card})")
    res["loss"] = {"rows": n, "ms": ms, "plain_ms": (p1 + p2) / 2, "bound_ms": bound[0],
                   "bound_by": bound[1], "library_ms": (r1 + r2) / 2,
                   "tflops": _tflops(flops, ms)}
    del x, W, t

    # #16 over stage 0's leaves (its three layers and the root)
    mesh = Mesh(PIPE_AXES, (1, 2, 1), None, (LOCAL, Axis(2, 0), LOCAL))
    res["adamw"] = adamw_vs_plain(card, list(convert.stage_shapes(cfg, mesh).values()), g,
                                  "stage 0's leaves", dev)
    return res


def _pipe_memory_and_schedules(results, card: str) -> dict:
    """Phase 19 (b)'s readings across runs: GPipe against 1F1B at dropout
    0.1, the stages' peak memory under both schedules at 4 and 8
    microbatches, and a stage's resting bytes against the count from the
    shapes.  -> the readings."""
    from neko_tpu_torch import bench, convert
    from neko_tpu_torch.parallel import pipeline

    by = {(r["run"]["schedule"], r["run"]["micro"], r["run"]["dropout"], r["run"]["fused_adamw"],
           r["run"]["fault"]): r for r in results}
    gp, ob = by[("gpipe", 4, 0.1, False, None)], by[("1f1b", 4, 0.1, False, None)]
    diff = max(abs(a - b) / abs(b) for ra, rb in zip(gp["ranks"], ob["ranks"])
               for a, b in zip(ra["losses"], rb["losses"]))
    print(f"GPipe vs 1F1B at dropout 0.1 (the same masks): losses' largest relative "
          f"difference {diff:.3e} (limit {PIPE_SCHEDULE_TOL:g}) ({card})")
    _require(diff <= PIPE_SCHEDULE_TOL, "1F1B does not train as GPipe does")
    peaks = {f"{sch} x {m}": [(r["activation_peak_bytes"] / 2 ** 30, r["peak_bytes"] / 2 ** 30)
                              for r in by[(sch, m, 0.0, False, None)]["ranks"]]
             for sch in ("gpipe", "1f1b") for m in (4, 8)}
    print(f"GiB a stage ((activations: the forward and backward over what rests, the step's "
          f"peak) of stage 0, stage 1): {json.dumps(peaks)} ({card})")
    # 1F1B holds at most 2 (S - 1 - i) + 1 stage inputs and one microbatch's
    # graph, whatever M is; GPipe every microbatch's graph until its
    # backward.  Stage 0's peak is its embedding's backward (the whole
    # batch's patch pool, the same under both), the last stage's the
    # schedule's.  (1% for the allocator's rounding of other block sizes.)
    for stage in (0, 1):
        for m in (4, 8):
            _require(peaks[f"1f1b x {m}"][stage][0] <= 1.01 * peaks[f"gpipe x {m}"][stage][0],
                     f"1F1B's stage {stage} holds more activations than GPipe's at {m}")
        _require(peaks["1f1b x 8"][stage][0] <= 1.01 * peaks["1f1b x 4"][stage][0],
                 "1F1B's activation memory grows with the microbatches")
    _require(all(peaks[f"1f1b x {m}"][1][0] < peaks[f"gpipe x {m}"][1][0] for m in (4, 8)),
             "1F1B's last stage holds no fewer activations than GPipe's")
    cfg = convert.model_shapes(bench.model_config("flagship"))
    n_root = sum(s.numel() for k, s in cfg.items() if not pipeline.is_stage_leaf(k))
    n_body = sum(s.numel() for k, s in cfg.items() if pipeline.is_stage_leaf(k))
    # fp32 parameters and AdamW's two fp32 moments: 12 bytes a parameter
    want = 12 * (n_root + n_body // 2)
    rest = by[("gpipe", 4, 0.0, False, None)]["ranks"]
    one = by[("gpipe", 4, 0.0, False, None)]["one_process"]["resting_bytes"]
    print(f"resting bytes a stage {[r['resting_bytes'] for r in rest]} (the count from the "
          f"shapes: 12 x ({n_root} root + {n_body} / 2 body) = {want}); one process {one} "
          f"(12 x {n_root + n_body} = {12 * (n_root + n_body)}); a stage / one process "
          f"{rest[0]['resting_bytes'] / one:.4f}")
    _require(all(r["resting_bytes"] == want for r in rest) and one == 12 * (n_root + n_body),
             "a stage's resting bytes differ from the count from the shapes")
    return {"schedule_loss_diff": diff, "peak_gib": peaks,
            "resting_bytes": [r["resting_bytes"] for r in rest], "resting_count": want,
            "one_process_resting_bytes": one}


def pipeline_seq_train(card: str, workdir) -> dict:
    """Phase 19.  -> {"kernels": pipeline_seq_kernels_vs_plain's, "launches":
    {"seq", "pipe"}: the main path's launches (the sound runs and the CLI,
    over the ranks), "readings"}."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    kernels = pipeline_seq_kernels_vs_plain(card)
    seq = _parallel_runs(card, SEQ_RANK_RUNS, phase=19, width=RANK_WIDTH)
    pipe = _parallel_runs(card, PIPE_RUNS, phase=19)
    pipe["schedules"] = _pipe_memory_and_schedules(pipe["results"], card)
    keys = ("fwd", "bwd", "loss", "adamw", "decode", "ring_fwd", "ring_dq", "ring_dkv")
    launches = {}
    for name, runs, argv, mesh in (
            ("seq", seq, SEQ_RANK_CLI, {"data": 1, "seq": 2, "model": 1}),
            ("pipe", pipe, PIPE_CLI, {"data": 1, "pipe": 2, "model": 1})):
        shutil.rmtree(workdir, ignore_errors=True)
        cli = _parallel_cli(card, workdir, argv, mesh=mesh)
        launches[name] = {k: runs["launches"].get(k, 0) + cli.get(k, 0) for k in keys}
    print(f"phase 19 launches over the ranks (sound runs + the CLI): {launches}")
    return {"kernels": kernels, "launches": launches,
            "readings": seq["readings"] + pipe["readings"], "schedules": pipe["schedules"]}


# ------------------------------------------- phase 20: quantized, tensor-parallel serving
def plain_int8_decode(q, k_q, k_scale, v_q, v_scale, start, end, key_mask=None, fault=None):
    """#14-int8's plain version, or that version with one of
    INT8_DECODE_FAULTS planted in it."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    if fault == "newest key excluded":
        end = torch.maximum(end - 1, start)
    elif fault == "key scales ignored":
        k_scale = torch.ones_like(k_scale)
    elif fault == "value scales ignored":
        v_scale = torch.ones_like(v_scale)
    elif fault == "mask holes ignored":
        key_mask = None
    return da.decode_cache_attention_int8_reference(q, k_q, k_scale, v_q, v_scale, start, end,
                                                    key_mask=key_mask)


@contextlib.contextmanager
def int8_decode_through(fn):
    """Within the block the model's int8 decode attention runs `fn(q, k_q,
    k_scale, v_q, v_scale, start, end, key_mask)` in place of the kernel."""
    from neko_tpu_torch.ops import attention as attn_ops

    wrapper = attn_ops.decode_attention_int8

    def call(q, cache, start, end):
        return fn(q, cache["key"], cache["key_scale"], cache["value"], cache["value_scale"],
                  start, end, cache["mask"])

    attn_ops.decode_attention_int8 = call
    try:
        yield
    finally:
        attn_ops.decode_attention_int8 = wrapper


def _int8_cache(B, H, S, hd, g, dev):
    """(k_q, k_scale, v_q, v_scale) of random bf16 rows quantized."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    kq, ks = da.quant_rows(torch.randn(B, H, S, hd, device=dev, generator=g).bfloat16() * 2)
    vq, vs = da.quant_rows(torch.randn(B, H, S, hd, device=dev, generator=g).bfloat16())
    return kq, ks, vq, vs


def int8_decode_vs_plain(card: str, dev="cuda") -> dict:
    """Phase 20 (a).  -> {"err", "check_launches", "times" (B=8), "times_b1",
    "shapes" (INT8_DECODE_TIMED)}."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    da.decode_cache_attention_int8.launches = 0
    g = torch.Generator(device=dev).manual_seed(SEED)
    tol = KERNEL_TOL["bfloat16"]
    faults = INT8_DECODE_FAULTS + SPLIT_FAULTS
    worst, fault_excess = 0.0, {f: -1.0 for f in faults}
    cases = [(shape, False) for shape in INT8_DECODE_SHAPES]
    cases += [(shape, True) for shape in INT8_DECODE_SPLIT_SHAPES]
    for (B, H, S, hd), edges in cases:
        q = torch.randn(B, H, hd, device=dev, generator=g).bfloat16()
        cache = _int8_cache(B, H, S, hd, g, dev)
        n = _split_n(q, S)
        start, end, mask = _case_windows(B, S, n, edges, True, g, dev)
        out = da.decode_cache_attention_int8(q, *cache, start, end, mask)
        ref = plain_int8_decode(q, *cache, start, end, mask)
        torch.cuda.synchronize()
        _require(torch.isfinite(out).all(), f"int8 decode output not finite at B={B}")
        seen = (start < end)[:, None, None]
        _require(torch.all(out.masked_fill(seen, 0) == 0), "int8 decode rows without a key not 0")
        err, excess = _excess(out.float() * seen, ref.float() * seen, tol)
        worst = max(worst, err)
        print(f"int8 decode kernel vs plain B={B} H={H} S={S} hd={hd} bf16 q, cluster of {n}, "
              f"{'split-edge windows, ' if edges else ''}holed cache mask: max abs err "
              f"{err:.3e} (excess over tolerance {excess:.3e})")
        _require(excess <= 0, f"the int8 decode kernel disagrees at {B}x{H}x{S}x{hd}")
        kq, ks, vq, vs = cache
        for f in faults:
            bad = (plain_int8_decode(q, *cache, start, end, mask, fault=f)
                   if f in INT8_DECODE_FAULTS
                   else split_decode(q, kq, vq, start, end, n, mask, (ks, vs), fault=f))
            fault_excess[f] = max(fault_excess[f], _excess(bad.float() * seen,
                                                           ref.float() * seen, tol)[1])
    for f in faults:
        print(f"control '{f}': largest excess over tolerance {fault_excess[f]:.3e}")
    blind = [f for f in faults if not fault_excess[f] > 0]
    _require(not blind, f"the int8 decode check cannot tell these planted faults: {blind}")
    res = {"err": worst, "check_launches": da.decode_cache_attention_int8.launches,
           "shapes": []}

    # device times on a full cache, in turns, each call on the next of enough
    # copies of the cache to fill the 50 MB L2 twice (as phase 11)
    for B, H, S, hd in INT8_DECODE_TIMED:
        q = torch.randn(B, H, hd, device=dev, generator=g).bfloat16()
        copies = -(-100_000_000 // (2 * B * H * S * (hd + 4)))
        caches = [_int8_cache(B, H, S, hd, g, dev) for _ in range(copies)]
        turn = itertools.cycle(caches)
        start = torch.zeros(B, dtype=torch.int32, device=dev)
        end = torch.full((B,), S, dtype=torch.int32, device=dev)
        valid = torch.ones(B, S, dtype=torch.bool, device=dev)
        run_k = lambda: da.decode_cache_attention_int8(  # noqa: E731
            q, *next(turn), start, end, valid)
        run_p = lambda: da.decode_cache_attention_int8_reference(  # noqa: E731
            q, *next(turn), start, end, key_mask=valid)
        p1, k1, k2, p2 = (_launched_device_ms(f) for f in (run_p, run_k, run_k, run_p))
        ev_k = _time_ms(run_k, 50)
        keys = B * H * S
        # int8 K and V rows, their fp32 scales, q and o in bf16, the mask
        bound = _bound(4 * hd * keys, 2 * keys * hd + 2 * keys * 4 + 2 * B * H * hd * 2 + B * S)
        n = _split_n(q, S)
        del caches
        print(f"int8 decode B={B} H={H} S={S} hd={hd}, full cache ({copies} copies in turn), "
              f"cluster of {n}, device time: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
              f"{bound[0] / ((k1 + k2) / 2):.3f} of it), no library call; CUDA events over 50 "
              f"calls: kernel {ev_k:.4f} ms ({card})")
        times = {"shape": [B, H, S, hd], "n": n, "ms": (k1 + k2) / 2,
                 "plain_ms": (p1 + p2) / 2, "bound_ms": bound[0], "bound_by": bound[1],
                 "library_ms": None, "event_ms": ev_k}
        res["shapes"].append(times)
        if (H, S, hd) == (24, 1024, 32) and B in (8, 1):
            res["times" if B == 8 else "times_b1"] = {
                k: v for k, v in times.items() if k != "shape"}
    return res


def _launched_device_ms(fn) -> float:
    """`_device_ms` of a call that launches kernels: a reading of 0 (a
    profiler session that recorded none of its launches) is taken again, at
    most twice."""
    for _ in range(3):
        ms = _device_ms(fn)
        if ms > 0:
            return ms
    raise AssertionError("the profiler recorded no device time for a call that launches")


def _cache_bytes(gen, examples) -> int:
    """Bytes of the KV caches (rows and scales; not the masks) a prefill of
    `examples` leaves."""
    import torch

    from neko_tpu_torch.data.batch import to_device_batch

    arrays = gen.packer.pack_batch(examples, pad_side="right")
    lengths = arrays.pop("lengths")
    with torch.inference_mode():
        emb = gen.model.embed_batch(to_device_batch(arrays, gen.device))
        mask = torch.from_numpy(np.arange(gen.cfg.context_len)[None, :]
                                < lengths[:, None]).to(gen.device)
        _, caches = gen.model.prefill(emb, mask)
    return sum(t.numel() * t.element_size() for c in caches for k, t in c.items()
               if k != "mask")


def _plain_fp8_model(cfg, sd, dev, fault=None):
    """The plain version of fp8 serving: a bf16 model whose weights are the
    fp8 weights dequantized once (materialized); `fault` "scales over the
    input dim" takes each scale over a column instead of an output row."""
    import torch

    from neko_tpu_torch.convert import build_model
    from neko_tpu_torch.inference import quant

    dtype = cfg.activation_dtype
    out = quant.serve_cast_state_dict(sd, dtype)
    for k, t in out.items():
        if not quant.eligible(k, t):
            continue
        if fault == "scales over the input dim":
            wf = t.float()
            scale = torch.clamp(wf.abs().amax(dim=0) / quant.FP8_MAX, min=1e-30)
            q = torch.clamp(wf / scale[None, :], -quant.FP8_MAX, quant.FP8_MAX).to(quant.FP8)
            out[k] = q.to(dtype) * scale.to(dtype)[None, :]
        else:
            out[k] = quant.dequantize(*quant.quantize(t), dtype)
    return build_model(cfg, out, dev)


def quantized_serving(card: str, dev="cuda") -> dict:
    """Phase 20 (b) and (c) at bench_decode.py's shape (B=8, 512-token
    prompts, 64 new tokens, flagship width, bf16, random weights from the
    seed).  -> {"int8_launches", "fwd", "decode", "int8": readings,
    "fp8": readings}."""
    import torch

    from neko_tpu_torch import bench_decode
    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.inference import quant
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import decode_attention as da

    cfg = ModelConfig(**dict(FLAGSHIP, max_patches=0, dropout=0.0))
    sd = init_state_dict(cfg, SEED)
    native = Generator(build_model(cfg, sd, dev), seed=SEED)
    int8 = Generator(build_model(cfg.replace(kv_cache_dtype="int8"), sd, dev), seed=SEED)
    fp8 = Generator(build_model(cfg, sd, dev), seed=SEED, weight_dtype="fp8")
    rng = np.random.RandomState(SEED)
    B, P, T = DECODE_BENCH["B"], DECODE_BENCH["prompt"], DECODE_BENCH["new"]
    examples = [{"text": list(rng.randint(1, cfg.text_tokens, size=P))} for _ in range(B)]
    ts = cfg.token_space
    kw = dict(start=ts.start("text"), end=ts.end("text"))
    V = cfg.vocab_size
    res = {"fwd": 0, "decode": 0, "int8_launches": 0}

    def run(gen):  # generate_batch counted: -> (tokens, window logits, launches)
        whk.whole_head_attention.launches = 0
        da.decode_cache_attention.launches = 0
        da.decode_cache_attention_int8.launches = 0
        toks, windows = gen.generate_batch(examples, max_new_tokens=T, **kw)
        torch.cuda.synchronize()
        n = (whk.whole_head_attention.launches, da.decode_cache_attention.launches,
             da.decode_cache_attention_int8.launches)
        res["fwd"] += n[0]
        res["decode"] += n[1]
        res["int8_launches"] += n[2]
        return toks, windows, n

    tn, wn, ln = run(native)
    ti, wi, li = run(int8)
    tf, wf, lf = run(fp8)
    steps = (T - 1) * cfg.layers
    print(f"launches (#1, #14, #14-int8): native {ln}, int8 cache {li}, fp8 weights {lf} "
          f"({T - 1} decode steps x {cfg.layers} layers = {steps})")
    _require(ln == (cfg.layers, steps, 0) and li == (cfg.layers, 0, steps)
             and lf == (cfg.layers, steps, 0), "a generation left its kernels")

    # (b) the int8 cache against the native one
    first = float(np.abs(wi[:, 0] - wn[:, 0]).max())
    agree = float((ti == tn).mean())
    forced_n = _teacher_forced_logits(native, examples, tn)[:, :V]
    forced_i = _teacher_forced_logits(int8, examples, tn)[:, :V]
    err = (forced_i - forced_n).abs().max().item()
    with int8_decode_through(plain_int8_decode):
        plain_i = _teacher_forced_logits(int8, examples, tn)[:, :V]
    kerr = (forced_i - plain_i).abs().max().item()
    kfault = {}
    for f in INT8_DECODE_LOGIT_FAULTS:
        with int8_decode_through(lambda *a, f=f: plain_int8_decode(*a, fault=f)):
            kfault[f] = (_teacher_forced_logits(int8, examples, tn)[:, :V]
                         - forced_i).abs().max().item()
    fault_err = {}
    for f in INT8_LOGIT_FAULTS:
        with int8_decode_through(lambda *a, f=f: plain_int8_decode(*a, fault=f)):
            bad = _teacher_forced_logits(int8, examples, tn)[:, :V]
        fault_err[f] = (bad - forced_n).abs().max().item()
    nb, ib = _cache_bytes(native, examples), _cache_bytes(int8, examples)
    print(f"int8 cache vs native, B={B}, {P}-token prompts, {T} new tokens: first-step logits "
          f"max abs diff {first:.3e} (the prefill attends full precision), token agreement "
          f"{agree:.4f}, last-step logits teacher-forced on the native tokens {err:.3e} "
          f"(limit {INT8_LOGIT_TOL:g}; logit std {forced_n.std().item():.3f}); the model's "
          f"int8 decode kernel vs its plain version {kerr:.3e} (limit "
          f"{INT8_DECODE_LOGIT_TOL:g}; control {kfault}); "
          f"cache bytes {ib:,} / {nb:,} = {ib / nb:.4f}")
    for f, e in fault_err.items():
        print(f"control '{f}': last-step logits against the native cache {e:.3e}")
    _require(first == 0.0, "the int8 cache changed the prefill's logits")
    _require(err <= INT8_LOGIT_TOL and kerr <= INT8_DECODE_LOGIT_TOL,
             "the int8 cache's logits")
    _require(all(e > INT8_DECODE_LOGIT_TOL for e in kfault.values()),
             f"the int8 kernel's logits check cannot tell {kfault}")
    blind = [f for f, e in fault_err.items() if not e > INT8_LOGIT_TOL]
    _require(not blind, f"the int8 logits check cannot tell these planted faults: {blind}")
    hd = cfg.head_dim  # a row: hd int8 values and an fp32 scale against 2 * hd bytes
    _require(ib * 2 * hd == nb * (hd + 4), f"int8 cache bytes {ib} against native {nb}: "
             f"not {hd + 4} / {2 * hd}")

    # the quantization on the card rounds as the CPU's (neko_tpu's) does
    bf = quant.serve_cast_state_dict(sd, cfg.activation_dtype)
    differ = []
    for k, t in bf.items():
        if quant.eligible(k, t):
            (qc, sc), (qg, sg) = quant.quantize(t), quant.quantize(t.to(dev))
            if not (torch.equal(qc.view(torch.uint8), qg.cpu().view(torch.uint8))
                    and torch.equal(sc, sg.cpu())):
                differ.append(k)
    x = torch.randn(B, cfg.heads, P, cfg.head_dim).bfloat16() * 3
    (ic, isc), (ig, isg) = da.quant_rows(x), da.quant_rows(x.to(dev))
    rows_equal = torch.equal(ic, ig.cpu()) and torch.equal(isc, isg.cpu())
    print(f"quantized on the card against the CPU: fp8 bytes and scales of "
          f"{sum(quant.eligible(k, t) for k, t in bf.items())} weights "
          f"{'equal' if not differ else 'differ in ' + str(differ)}; int8 rows and scales of "
          f"[{B}, {cfg.heads}, {P}, {cfg.head_dim}] {'equal' if rows_equal else 'differ'}")
    _require(not differ and rows_equal, "the card quantizes otherwise than the CPU")
    del bf

    # (c) fp8 weights against bf16, and against their plain version
    ffirst = float(np.abs(wf[:, 0] - wn[:, 0]).max())
    fagree = float((tf == tn).mean())
    plain = Generator(_plain_fp8_model(cfg, sd, dev), seed=SEED)
    pt, pw = plain.generate_batch(examples, max_new_tokens=T, **kw)
    perr = float(np.abs(pw - wf).max())
    bad = Generator(_plain_fp8_model(cfg, sd, dev, fault="scales over the input dim"), seed=SEED)
    fault_perr = float(np.abs(bad.generate_batch(examples, max_new_tokens=2, **kw)[1][:, 0]
                              - wf[:, 0]).max())
    del plain, bad
    qb, tb = quant.quantized_bytes(fp8.model)
    bf16_bytes = sum(t.numel() * t.element_size() for t in native.model.state_dict().values())
    print(f"fp8 weights vs bf16: first-step logits max abs diff {ffirst:.3e}, token agreement "
          f"{fagree:.4f}; against the dequantized-once bf16 model (the plain version) "
          f"{perr:.3e} over every step, tokens {'equal' if (pt == tf).all() else 'differ'} "
          f"(limit {FP8_PLAIN_TOL:g}); control 'scales over the input dim' {fault_perr:.3e}; "
          f"resting weight bytes {tb:,} (fp8 weights and scales {qb:,}) against bf16 "
          f"{bf16_bytes:,} = {tb / bf16_bytes:.4f}")
    _require(perr <= FP8_PLAIN_TOL and (pt == tf).all(), "fp8 serving left its plain version")
    _require(fault_perr > FP8_PLAIN_TOL, "the fp8 check cannot tell 'scales over the input dim'")
    nk = {}
    for name, gen in (("native", native), ("int8", int8), ("fp8", fp8), ("int8", int8),
                      ("fp8", fp8), ("native", native)):
        nk.setdefault(name, []).append(bench_decode.measure(
            gen, examples, T, runs=3, **dict(kw, return_logits=False))["per_token_ms"])
    print(f"decode ms a token at B={B} (generate_batch, host clock, in turns): native "
          f"{nk['native']}, int8 cache {nk['int8']}, fp8 weights {nk['fp8']} ({card})")
    res["int8"] = {"first_logit_diff": first, "token_agreement": agree, "forced_logit_err": err,
                   "kernel_vs_plain_logit_err": kerr, "faults": fault_err,
                   "kernel_faults": kfault,
                   "cache_bytes": ib, "native_cache_bytes": nb, "cache_ratio": ib / nb,
                   "token_ms": nk["int8"], "native_token_ms": nk["native"]}
    res["fp8"] = {"first_logit_diff": ffirst, "token_agreement": fagree, "plain_err": perr,
                  "fault_plain_err": fault_perr, "weight_bytes": tb, "quantized_bytes": qb,
                  "bf16_weight_bytes": bf16_bytes, "token_ms": nk["fp8"]}
    return res


def tp_serving(card: str, workdir: Path, dev="cuda") -> dict:
    """Phase 20 (d): two ranks on the one card over gloo at model = 2
    against one process.  -> {"fwd", "decode", "int8_launches" over both
    ranks, readings}."""
    import dataclasses

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import check_torch_serving_ranks as tool

    from neko_tpu_torch.cli import evaluate as cli_evaluate
    from neko_tpu_torch.cli import serve as cli_serve
    from neko_tpu_torch.cli.build import model_config_from_args
    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import init_state_dict, save_model_dir
    from neko_tpu_torch.training.arguments import TrainingArgs
    from neko_tpu_torch.utils.checkpoint import save_args

    workdir.mkdir(parents=True, exist_ok=True)
    cfg = ModelConfig(**dict(FLAGSHIP, max_patches=0, dropout=0.0))
    sd = init_state_dict(cfg, SEED)
    state = str(workdir / "state.pt")
    torch.save(sd, state)
    rng = np.random.RandomState(SEED + 20)
    B, P, T = TP_SERVE["B"], TP_SERVE["prompt"], TP_SERVE["new"]
    prompts = [[int(t) for t in rng.randint(1, cfg.text_tokens, size=P)] for _ in range(B)]
    cases = {"native": {}, "int8": {"kv": "int8"}, "fp8": {"weights": "fp8"},
             "fault": {"weights": "fp8", "fault": "scales per shard"}}
    job = {"kind": "generate", "prompts": prompts, "new": T, "cases": list(cases.values())}
    # the evaluation CLI's checkpoint: the flagship width on the byte
    # tokenizer's text task, fp32, random weights from the seed
    eargs = TrainingArgs(cpu=False, text_datasets=["synthetic"], text_datasets_paths=["synthetic"],
                         text_prop=1.0, embed_dim=FLAGSHIP["embed_dim"],
                         layers=FLAGSHIP["layers"], heads=FLAGSHIP["heads"],
                         sequence_length=FLAGSHIP["context_len"],
                         mixed_precision="no", dropout=0.0, eval_text_num_examples=4,
                         log_jsonl=False, seed=SEED)
    exp = workdir / "exp"
    ecfg = model_config_from_args(eargs, 0)
    save_model_dir(str(exp / "checkpoint_1"), ecfg, init_state_dict(ecfg, SEED))
    save_args(str(exp), eargs)
    eval_argv = ["--model_path", str(exp)] + (["--cpu"] if dev == "cpu" else [])
    requests = [("/v1/generate", {"text": prompts[0][:64], "max_new_tokens": 16}),
                ("/v1/generate", {"text": prompts[1][:48], "max_new_tokens": 12,
                                  "deterministic": False, "temperature": 0.8}),
                ("/v1/generate", {"text": prompts[2][:40], "max_new_tokens": 12, "top_k": 3}),
                ("/v1/generate", {"text": prompts[3][:32], "max_new_tokens": 8, "num_beams": 2})]
    t0 = time.perf_counter()
    gen_res, served, evaluated = tool.run_ranks(
        [job, {"kind": "serve", "argv": TP_CLI, "requests": requests},
         {"kind": "evaluate", "argv": eval_argv}],
        world=2, state=state, cfg=dataclasses.asdict(cfg), device=dev, timeout=900)
    ranks_s = time.perf_counter() - t0

    # one process on the same card
    out = {"fwd": 0, "decode": 0, "int8_launches": 0, "ranks_s": ranks_s}
    want = {}
    for name, case in cases.items():
        if name == "fault":
            continue
        gen = tool.build(cfg, sd, torch.device(dev), None, case)
        want[name] = tool.generate_case(gen, job)
        del gen
    readings = {}
    for (name, case), got in zip(cases.items(), gen_res):
        ref = want["fp8" if name == "fault" else name]
        first = float(np.abs(got["logits"][:, 0] - ref["logits"][:, 0]).max())
        readings[name] = {"first_logit_diff": first, "rank_logit_diff": got["rank_logit_diff"],
                          "heads": got["heads"], "launches": got["rank_launches"]}
        if name == "fault":
            print(f"control 'scales per shard': first-step logits against one process's fp8 "
                  f"{first:.3e} (limit {TP_LOGIT_TOL:g})")
            _require(first > TP_LOGIT_TOL, "the TP check cannot tell 'scales per shard'")
            continue
        _require(all(t == got["tokens"] for t in got["rank_tokens"])
                 and got["rank_logit_diff"] == 0.0, f"{name}: the ranks disagree")
        _require(got["heads"] == {"prefill": [cfg.heads // 2], "decode": [cfg.heads // 2]},
                 f"{name}: heads a rank {got['heads']}")
        windows = ref["logits"]
        top2 = np.partition(windows, -2, axis=-1)[..., -2:]
        gaps = top2[..., 1] - top2[..., 0]
        held = [_near_tie_check(f"model=2 {name} row {i}", got["tokens"][i], ref["tokens"][i],
                                gaps[i]) for i in range(B)]
        for r in got["rank_launches"]:
            out["fwd"] += r["whole_head_attention"]
            out["decode"] += r["decode_cache_attention"]
            out["int8_launches"] += r["decode_cache_attention_int8"]
        print(f"model=2 {name}: first-step logits vs one process {first:.3e} (limit "
              f"{TP_LOGIT_TOL:g}), every rank's logits equal rank 0's, tokens held "
              f"{held} of {T} a row, heads a rank {got['heads']}, launches a rank "
              f"{got['rank_launches']}")
        _require(first <= TP_LOGIT_TOL, f"{name}: TP logits against one process")
        readings[name]["held"] = held

    # the serve CLI: the same requests to one process's server
    with cli_serve.build_server(cli_serve.parser().parse_args(TP_CLI + ["--port", "0"])) as s:
        base = f"http://{s.address[0]}:{s.address[1]}"
        replies = [tool._post(base, path, payload) for path, payload in requests]
    for (code, got), (wcode, w), (_, p) in zip(served["replies"], replies, requests):
        _require(code == wcode == 200, f"serve over ranks: {code} {got}")
        _require(got["tokens"] == w["tokens"], f"serve over ranks differs from one process: {p}")
    follower = served["followers"][0]
    _require(follower["follower_errors"] == 0, "a follower's replay raised")
    print(f"serve CLI over 2 ranks (flagship fp32, fp8 weights, int8 cache, engine of 4 slots): "
          f"{len(requests)} replies equal one process's (engine, engine sampled, coalesced, "
          f"beams); rank 1 replayed {follower['follower_calls']} calls; launches a rank "
          f"{[served['launches']] + [f['launches'] for f in served['followers']]}")
    for r in [served] + served["followers"]:
        out["fwd"] += r["launches"]["whole_head_attention"]
        out["decode"] += r["launches"]["decode_cache_attention"]
        out["int8_launches"] += r["launches"]["decode_cache_attention_int8"]
    # the evaluation CLI
    ewant = cli_evaluate.main(eval_argv)
    for r in evaluated:
        _require(set(r["logs"]) == set(ewant), "evaluation keys over ranks")
        for k, w in ewant.items():
            _require(abs(r["logs"][k] - w) <= TP_EVAL_TOL * max(1.0, abs(w)),
                     f"evaluation over ranks {k}: {r['logs'][k]} against {w}")
        out["fwd"] += r["launches"]["whole_head_attention"]
        out["decode"] += r["launches"]["decode_cache_attention"]
    _require(evaluated[0]["printed"].count("evaluation/") == len(ewant)
             and "evaluation/" not in evaluated[1]["printed"], "rank 0 alone prints")
    print(f"evaluation CLI over 2 ranks: {ewant} on every rank (limit {TP_EVAL_TOL:g} relative), "
          f"printed by rank 0; the ranks' spawn took {ranks_s:.1f} s ({card})")
    out["readings"] = readings
    return out


def quantized_tp_serving(card: str, workdir: Path, dev="cuda") -> dict:
    """Phase 20: (a) #14-int8 against its plain version, timed; (b), (c) the
    int8 cache and fp8 weights at bench_decode's shape; (d) over two ranks.
    -> {"kernel": (a), "serving": (b, c), "ranks": (d)}."""
    t0 = time.perf_counter()
    kernel = int8_decode_vs_plain(card, dev)
    serving = quantized_serving(card, dev)
    ranks = tp_serving(card, workdir, dev)
    print(f"phase 20 took {time.perf_counter() - t0:.1f} s")
    return {"kernel": kernel, "serving": serving, "ranks": ranks}


# ------------------------------------------------------- phase 21: weights in and out
def write_safetensors(path, tensors) -> None:
    """A safetensors file of fp32 numpy arrays: the 8-byte little-endian
    header length, the JSON header, then the raw little-endian data."""
    import struct

    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a, dtype="<f4").tobytes())


def write_gpt2_dir(path: Path) -> dict:
    """GPT2_SMALL's config.json and model.safetensors (GPT2LMHeadModel's key
    layout, `transformer.` first, with the position table the import drops)
    from the seed.  -> the tensors written, by name."""
    D, L, V = GPT2_SMALL["n_embd"], GPT2_SMALL["n_layer"], GPT2_SMALL["vocab_size"]
    rng = np.random.default_rng(SEED)

    def normal(*shape, std=GPT2_STD):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    t = {"transformer.wte.weight": normal(V, D, std=0.02),
         "transformer.wpe.weight": normal(GPT2_SMALL["n_positions"], D, std=0.02)}
    for i in range(L):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            t[p + ln + ".weight"] = 1 + normal(D, std=0.1)
            t[p + ln + ".bias"] = normal(D, std=0.02)
        for name, shape in (("attn.c_attn", (D, 3 * D)), ("attn.c_proj", (D, D)),
                            ("mlp.c_fc", (D, 4 * D)), ("mlp.c_proj", (4 * D, D))):
            t[p + name + ".weight"] = normal(*shape)        # Conv1D: [in, out]
            t[p + name + ".bias"] = normal(shape[1], std=0.02)
    t["transformer.ln_f.weight"] = 1 + normal(D, std=0.1)
    t["transformer.ln_f.bias"] = normal(D, std=0.02)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "config.json", "w") as f:
        json.dump(dict(GPT2_SMALL, model_type="gpt2", architectures=["GPT2LMHeadModel"]), f)
    write_safetensors(path / "model.safetensors", t)
    return t


def gpt2_by_hand(sd, files, fault=None):
    """`sd` with the file's GPT-2 weights laid over it by this script's own
    mapping (Conv1D [in, out] -> Linear [out, in]); `fault` PRETRAINED_FAULT
    leaves the square attn.c_proj untransposed."""
    import torch

    out = dict(sd)
    emb = out["embed_token.weight"].clone()
    wte = files["transformer.wte.weight"]
    emb[: wte.shape[0]] = torch.from_numpy(wte)
    out["embed_token.weight"] = emb
    for key, a in files.items():
        if key.startswith(("transformer.wte.", "transformer.wpe.")):
            continue
        if key.endswith(".weight") and a.ndim == 2 and not (
                fault == PRETRAINED_FAULT and key.endswith("attn.c_proj.weight")):
            a = a.T
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


@contextlib.contextmanager
def trainer_batches_and_weights():
    """Within the block: each Trainer's packed arrays (copies, in order:
    init_state's draw first) and the initial weights `cli.train` hands it
    (`initial_weights`)."""
    from neko_tpu_torch.cli import train as cli_train
    from neko_tpu_torch.training.trainer import Trainer

    got = {"arrays": [], "weights": []}
    sample, initial = Trainer._sample_arrays_locked, cli_train.initial_weights

    def sampled(self):
        arrays = sample(self)
        if len(got["arrays"]) < 2:
            got["arrays"].append({k: np.array(v, copy=True) for k, v in arrays.items()})
        return arrays

    def weights(args, ctx):
        sd = initial(args, ctx)
        got["weights"].append(None if sd is None else {k: v.clone() for k, v in sd.items()})
        return sd

    Trainer._sample_arrays_locked, cli_train.initial_weights = sampled, weights
    try:
        yield got
    finally:
        Trainer._sample_arrays_locked, cli_train.initial_weights = sample, initial


def _first_step_loss(ctx, sd, arrays) -> float:
    """The loss of step 0 from the weights `sd` on the packed `arrays` (the
    step's dropout draws: `ctx.step_generator` at step 0)."""
    import torch

    from neko_tpu_torch.data.batch import to_device_batch

    st = ctx.init_state({k: v.clone() for k, v in sd.items()})
    loss = ctx.loss_and_grads(st, to_device_batch(arrays, ctx.device)).item()
    del st
    torch.cuda.empty_cache()
    return loss


def _counted(main: dict, fn):
    """Runs `fn` with the kernels' launch counts set to 0 just before and
    adds them to `main` just after: a main-path segment.  -> fn()'s value."""
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    for k, c in counters.items():
        main[k] = main.get(k, 0) + c.launches
    return out


def pretrained_gpt2(card: str, workdir: Path, main: dict, dev="cuda") -> dict:
    """Phase 21 (b) and (e).  -> readings."""
    import torch

    from neko_tpu_torch.cli import evaluate as cli_eval
    from neko_tpu_torch.cli import serve as cli_serve
    from neko_tpu_torch.convert import model_shapes
    from neko_tpu_torch.tools import average_checkpoints, inspect_checkpoint
    from neko_tpu_torch.training.train_state import lora_frozen

    t0 = time.perf_counter()
    gdir = workdir / "gpt2-small"
    files = write_gpt2_dir(gdir)
    size = (gdir / "model.safetensors").stat().st_size
    print(f"phase 21 GPT-2-small directory: {len(files)} tensors, {size:,} bytes of "
          f"model.safetensors written in {time.perf_counter() - t0:.1f} s")
    out = {}
    cpu = [] if dev == "cuda" else ["--cpu"]
    for lora in (False, True):
        argv = GPT2_CLI + cpu + ["--pretrained_lm", str(gdir)] + (
            ["--lora", "--lora_r", "8"] if lora else ["--save_model", "--save_mode",
                                                     "checkpoint"])
        t1 = time.perf_counter()
        with trainer_batches_and_weights() as got:
            tr, rec, launches, calls = _counted(
                main, lambda: train_cli(argv, workdir / ("lora" if lora else "full")))
        run_s = time.perf_counter() - t1
        ctx, cfg = tr.ctx, tr.ctx.model_cfg
        losses = rec["losses"]
        init = got["weights"][0]
        _require((cfg.embed_dim, cfg.layers, cfg.heads, cfg.activation_fn) == (
            GPT2_SMALL["n_embd"], GPT2_SMALL["n_layer"], GPT2_SMALL["n_head"], "gelu_new"),
            f"--pretrained_lm resolved {cfg}")
        hand = gpt2_by_hand(init, files)
        mapped = [k for k in hand if k.startswith("transformer.") and not (
            "lora_a" in k or "lora_b" in k)] + ["embed_token.weight"]
        _require(all(torch.equal(init[k], hand[k]) for k in mapped),
                 "a mapped tensor differs from the file's bits")
        chunks = _chunks_of(tr.target_budget)
        name = "--lora" if lora else "full"
        print(f"phase 21 --pretrained_lm ({name}) {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h "
              f"hd {cfg.head_dim} k={cfg.context_len} B={tr.args.batch_size} bf16: {len(losses)} "
              f"steps in "
              f"{run_s:.1f} s, losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; launches {launches} ({chunks} loss chunks a step)")
        _require(len(losses) == GPT2_STEPS and all(np.isfinite(losses))
                 and losses[-1] < losses[0], f"the loss did not fall: {losses}")
        _require(dev != "cuda" or (launches["fwd"] == launches["bwd"] == cfg.layers * GPT2_STEPS
                                   and launches["loss"] == chunks * GPT2_STEPS
                                   and launches["decode"] == 0),
                 f"phase 21 launches {launches}")
        if lora:
            final = dict(tr.state.model.named_parameters())
            base = [k for k in init if lora_frozen(k)]
            adapters = [k for k in init if "lora_a" in k or "lora_b" in k]
            kept = all(torch.equal(final[k].detach().cpu(), init[k]) for k in base)
            moved = all(not torch.equal(final[k].detach().cpu(), init[k]) for k in adapters)
            print(f"phase 21 --lora: {len(base)} base tensors keep their bits: {kept}; "
                  f"{len(adapters)} adapters moved: {moved}")
            _require(kept and moved and len(adapters) == 2 * cfg.layers,
                     "--lora changed a base tensor or left an adapter")
            out["lora_losses"] = losses
        else:
            first = _first_step_loss(ctx, hand, got["arrays"][1])
            fault = _first_step_loss(ctx, gpt2_by_hand(init, files, PRETRAINED_FAULT),
                                     got["arrays"][1])
            gap, fgap = abs(first - losses[0]), abs(fault - losses[0])
            print(f"phase 21 first loss {losses[0]:.6f} against the model built from the file "
                  f"{first:.6f}: {gap:.3e} (limit {PRETRAINED_LOSS_TOL:g}); planted "
                  f"'{PRETRAINED_FAULT}' {fgap:.3e}")
            _require(gap <= PRETRAINED_LOSS_TOL, "the first loss differs from the file's model")
            _require(fgap > PRETRAINED_LOSS_TOL, f"cannot tell '{PRETRAINED_FAULT}'")
            out.update(losses=losses, first_gap=gap, fault_gap=fgap, run_s=run_s,
                       layers=cfg.layers,
                       exp=tr.exp_dir, n_params=sum(s.numel() for s in
                                                   model_shapes(cfg).values()))
        del tr
        torch.cuda.empty_cache()

    # the checkpoint restored through the evaluation CLI: the text task
    t1 = time.perf_counter()
    with model_call_counter() as calls:
        ev = {}
        logs = _counted(ev, lambda: cli_eval.main(
            ["--model_path", out["exp"], "--eval_episodes", "0",
             "--eval_text_num_examples", "8"] + cpu))
    for k, v in ev.items():
        main[k] = main.get(k, 0) + v
    print(f"phase 21 evaluation CLI on the --pretrained_lm checkpoint: {logs} in "
          f"{time.perf_counter() - t1:.1f} s; #1 {ev['fwd']} ({calls['prefill']} prefills x "
          f"{out['layers']}), #14 {ev['decode']} ({calls['decode_step']} decode steps x "
          f"{out['layers']})")
    _require(np.isfinite(logs.get("evaluation/text/loss", np.nan))
             and calls["prefill"] > 0 and calls["decode_step"] > 0
             and (dev != "cuda" or (ev["fwd"] == out["layers"] * calls["prefill"]
                                    and ev["decode"] == out["layers"] * calls["decode_step"])),
             f"evaluation {logs}, {ev}")

    # (e) the tools on the run's two checkpoints
    ckpts = [str(Path(out["exp"]) / f"checkpoint_{n}") for n in (GPT2_STEPS // 2, GPT2_STEPS)]
    soup = average_checkpoints.main(["--checkpoints", *ckpts, "--out",
                                     str(workdir / "soup")])
    def one_request():
        server = cli_serve.build_server(cli_serve.parser().parse_args(
            ["--model_path", str(workdir / "soup"), "--port", "0"] + cpu))
        with server:
            url = f"http://{server.address[0]}:{server.address[1]}"
            return _post(url + "/v1/generate", {"text": list(b"weights in"),
                                                "max_new_tokens": 8})

    status, body, dt = _counted(main, one_request)
    info = inspect_checkpoint.main(["--model_path", soup])
    print(f"phase 21 tools: averaged {ckpts} into {soup}; served one request: {status}, "
          f"{len(body.get('tokens', []))} tokens in {dt:.2f} s; inspect: step {info['step']}, "
          f"{info['parameters']:,} parameters (the model's {out['n_params']:,}), ema "
          f"{info['ema']}")
    _require(status == 200 and len(body["tokens"]) == 8, f"serve reply {status} {body}")
    _require(info["parameters"] == out["n_params"] and info["step"] == GPT2_STEPS,
             f"inspect {info}")
    out.update(eval=logs, serve_s=dt)
    return out


def reference_round_trip(card: str, workdir: Path, main: dict, dev="cuda") -> dict:
    """Phase 21 (c).  -> readings."""
    import torch

    from neko_tpu_torch.models.export_reference import export_gato_state_dict
    from neko_tpu_torch.tools import export_checkpoint
    from neko_tpu_torch.utils import checkpoint as ckpt

    one = ["--training_steps", "1", "--log_eval_freq", "1"] + (
        [] if dev == "cuda" else ["--cpu"])
    tr, _, _, _ = _counted(main, lambda: train_cli(
        MIX_CLI + one + ["--save_model", "--save_mode", "checkpoint"], workdir / "src"))
    src = ckpt.resolve_checkpoint_dir(tr.exp_dir)
    del tr
    pt = str(workdir / "reference.pt")
    export_checkpoint.main(["--model_path", src, "--out", pt])
    cfg = ckpt.saved_model_config(src)
    sd = ckpt.load_params_only(src, cfg)
    with trainer_batches_and_weights() as got:
        tr, rec, launches, _ = _counted(main, lambda: train_cli(
            MIX_CLI + one + ["--init_checkpoint", pt, "--seed", str(SEED + 1)],
            workdir / "from_pt"))
    init, arrays = got["weights"][0], got["arrays"][1]
    V = cfg.token_space.vocab_size
    same = []
    for k, v in sd.items():
        if k == "predict_token.weight":
            same.append(torch.equal(init[k][:V], v[:V]) and not init[k][V:].any())
        elif k == "embed_token.weight":
            same.append(torch.equal(init[k][:V + 1], v[:V + 1]))
        else:
            same.append(torch.equal(init[k], v))
    source = _first_step_loss(tr.ctx, sd, arrays)
    ref = export_gato_state_dict(sd, cfg)
    faulty = dict(init, **{"image_embedding.projection.weight": torch.from_numpy(
        ref["image_embedding.post_embedding_projection.weight"].copy())})
    fault = _first_step_loss(tr.ctx, faulty, arrays)
    first = rec["losses"][0]
    gap, fgap = abs(first - source), abs(first - fault)
    print(f"phase 21 reference .pt at {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h with images "
          f"({cfg.max_patches} patches): {os.path.getsize(pt):,} bytes; import of the export "
          f"gives the checkpoint's bits: {all(same)} ({len(same)} tensors); first loss "
          f"{first:.6f} against the source model's {source:.6f}: {gap:.3e} (limit "
          f"{PT_LOSS_TOL:g}); planted '{PT_FAULT}' {fgap:.3e}; launches {launches}")
    _require(all(same), "import of the export is not the checkpoint")
    _require(gap <= PT_LOSS_TOL, "the first loss from the .pt differs from the source's")
    _require(fgap > PT_LOSS_TOL, f"cannot tell '{PT_FAULT}'")
    del tr
    torch.cuda.empty_cache()
    return {"first_gap": gap, "fault_gap": fgap, "loss": first}


def wide_heads(card: str, main: dict, dev="cuda") -> dict:
    """Phase 21 (d): hd 256 through the plain route.  -> readings."""
    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.data.packing import SequencePacker
    from neko_tpu_torch.inference.generator import Generator
    from neko_tpu_torch.ops import attention as attn_ops
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    cfg = ModelConfig(**WIDE, dropout=RATE)
    _require(cfg.head_dim == 256, f"hd {cfg.head_dim}")
    rng = np.random.default_rng(SEED)
    sd = init_state_dict(cfg, SEED)
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    ctx = TrainContext(cfg, OptimizerConfig(), device=dev, seed=SEED)
    packer = SequencePacker(cfg)
    arrays = packer.pack_batch([{"text": rng.integers(0, 256, 1000)} for _ in range(8)])
    arrays.pop("lengths")
    state, loss = ctx.train_step(ctx.init_state({k: v.clone() for k, v in sd.items()}),
                                 to_device_batch(arrays, dev))
    loss = float(loss)
    grads_ok = all(torch.isfinite(p).all().item() for p in state.model.parameters())
    del state, ctx
    B, P, T = WIDE_PROMPTS["B"], WIDE_PROMPTS["prompt"], WIDE_PROMPTS["new"]
    examples = [{"text": rng.integers(0, 256, P)} for _ in range(B)]
    ts = cfg.token_space
    gen = Generator(build_model(cfg, sd, dev), packer, seed=SEED)
    toks, _ = gen.generate_batch(examples, max_new_tokens=T, start=ts.start("text"),
                                 end=ts.end("text"))
    toks = np.asarray(toks)
    gen32 = Generator(build_model(cfg.replace(dtype="float32"), sd, dev), packer, seed=SEED)
    res = {}

    def prefill_logits(g):
        arr = g.packer.pack_batch(examples, pad_side="right")
        lengths = arr.pop("lengths")
        with torch.inference_mode():
            emb = g.model.embed_batch(to_device_batch(arr, dev))
            mask = torch.from_numpy(np.arange(cfg.context_len)[None, :] < lengths[:, None])
            logits, _ = g.model.prefill(emb, mask.to(dev))
        return logits.float()[mask.to(dev)]

    want_p = prefill_logits(gen32)
    want_d = _teacher_forced_logits(gen32, examples, toks).float()
    got_p = prefill_logits(gen)
    got_d = _teacher_forced_logits(gen, examples, toks).float()
    res["prefill"] = (got_p - want_p).abs().max().item()
    res["decode"] = (got_d - want_d).abs().max().item()
    finite = all(torch.isfinite(t).all().item() for t in (got_p, got_d)) and np.isfinite(loss)
    launched = {k: c.launches for k, c in counters.items()}
    for k, n in launched.items():  # the model's main path: #15 in the train step alone
        main[k] = main.get(k, 0) + n
    wide_s = time.perf_counter() - t0

    def no_causal(q, k, v, key_mask, keep_scale=None):
        allowed = key_mask[:, None, None, :].expand(-1, 1, q.shape[2], -1)
        return whk.masked_attention(q, k, v, allowed, fill=-1e9, keep_scale=keep_scale)

    plain = attn_ops.xla_attention
    attn_ops.xla_attention = no_causal
    try:
        fault = (prefill_logits(gen) - want_p).abs().max().item()
    finally:
        attn_ops.xla_attention = plain
    wide_decode = attn_ops.decode_attention

    def decode_fault(f):  # the wide decode branch over a faulted copy of the cache mask
        def attend(q, k, v, start, end, key_mask):
            key_mask = key_mask.clone()
            if f == "newest key excluded":
                key_mask[torch.arange(len(end), device=end.device), end.long() - 1] = False
            elif f == "cache mask ignored":
                key_mask.fill_(True)
            return wide_decode(q, k, v, start, end, key_mask)
        return attend

    d_faults = {}
    for f in WIDE_DECODE_FAULTS:
        with decode_attention_through(decode_fault(f)):
            d_faults[f] = (_teacher_forced_logits(gen, examples, toks).float()
                           - want_d).abs().max().item()
    print(f"phase 21 hd 256 ({cfg.embed_dim}d/{cfg.heads}h/{cfg.layers}L k={cfg.context_len} "
          f"bf16): a train step at dropout {RATE}, loss {loss:.4f}, gradients finite "
          f"{grads_ok}; {B} prompts of {P} tokens, {T} new; bf16 against fp32 logits: prefill "
          f"{res['prefill']:.3e}, the last of {T} teacher-forced decode steps "
          f"{res['decode']:.3e} (limits {WIDE_LOGIT_TOL:g}, {WIDE_DECODE_LOGIT_TOL:g}); "
          f"planted '{WIDE_FAULT}' in the prefill {fault:.3e}, in the decode step "
          + ", ".join(f"'{f}' {x:.3e}" for f, x in d_faults.items())
          + f"; kernel launches {launched}; {wide_s:.1f} s")
    _require(finite and grads_ok, "hd 256: a value is not finite")
    _require(res["prefill"] <= WIDE_LOGIT_TOL and res["decode"] <= WIDE_DECODE_LOGIT_TOL,
             f"hd 256 logits {res}")
    _require(fault > WIDE_LOGIT_TOL, f"cannot tell '{WIDE_FAULT}'")
    blind = [f for f, x in d_faults.items() if not x > WIDE_DECODE_LOGIT_TOL]
    _require(not blind, f"the hd 256 decode check cannot tell {blind}")
    _require(launched["fwd"] == launched["bwd"] == launched["decode"] == launched["mask"] == 0,
             f"an attention kernel launched at hd 256: {launched}")
    del gen, gen32
    torch.cuda.empty_cache()
    return dict(res, fault=fault, decode_faults=d_faults, loss=loss)


def examples_run(workdir: Path, dev="cuda") -> dict:
    """Phase 21 (e): the `main` of `neko_tpu_torch.examples.training` and
    `examples.inference` (what `python -m` runs) in this process, at their
    default width, EXAMPLE_STEPS steps.  -> seconds each."""
    import importlib
    import io

    cpu = [] if dev == "cuda" else ["--cpu"]
    secs = {}
    for name, marker in (("training", "=== 4: export"), ("inference", "engine_slot_0 ->")):
        mod = importlib.import_module(f"neko_tpu_torch.examples.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--steps", str(EXAMPLE_STEPS), "--save_dir",
                      str(workdir / f"example_{name}")] + cpu)
        secs[name] = time.perf_counter() - t0
        _require(marker in buf.getvalue(), f"examples.{name}: no '{marker}' in its output: "
                 f"{buf.getvalue()[-2000:]}")
    print(f"phase 21 examples on {dev} (in process, {EXAMPLE_STEPS} steps): training "
          f"{secs['training']:.1f} s, inference {secs['inference']:.1f} s")
    return secs


def weights_in_and_out(card: str, workdir: Path, dev="cuda") -> dict:
    """Phase 21.  -> {"launches": the main path's, "kernels": (a)'s times
    and errors, "decode_check_launches": (a)'s #14 checks, "readings"}."""
    import torch

    from neko_tpu_torch.ops import decode_attention as da

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    errs = {}
    times = rank_attention_vs_plain(card, GPT2_ATTN, g, 2121, errs, dev=dev, hd=GPT2_HD,
                                    rates=(0.0, RATE))
    errs["prefill"] = kernel_vs_plain(dtype_name="bfloat16", hd=GPT2_HD, timed=False,
                                      **GPT2_PREFILL)[0]
    before = da.decode_cache_attention.launches
    errs["decode"] = decode_cases_vs_plain(
        [(shape, holed) for shape in GPT2_DECODE_SHAPES for holed in (False, True)], g, dev)
    decode_checks = da.decode_cache_attention.launches - before
    main = {}
    readings = {"gpt2": pretrained_gpt2(card, workdir, main, dev)}
    readings["pt"] = reference_round_trip(card, workdir, main, dev)
    readings["wide"] = wide_heads(card, main, dev)
    readings["examples"] = examples_run(workdir, dev)
    print(f"phase 21 main-path launches: {main}; phase 21 took "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": main, "kernels": {"attn": times, "err": errs},
            "decode_check_launches": decode_checks, "readings": readings}


# ------------------------- phase 22: VQ tokenizer, world model, wide ring
def plain_vq_conv(x, w, b, stride, fault=None):
    """flax `nn.Conv(padding="SAME")` on NCHW, fp32: lax's padding (total //
    2 before, the rest after), or with "SAME padding made symmetric" total
    // 2 on both sides."""
    import torch.nn.functional as F

    k, pads = w.shape[-1], []
    for size in (x.shape[3], x.shape[2]):  # F.pad: the last dim first
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        lo = total // 2
        pads += [lo, lo if fault == "SAME padding made symmetric" else total - lo]
    return F.conv2d(F.pad(x, pads), w, b, stride=stride)


def plain_vq_conv_transpose(x, w_t, b, fault=None):
    """flax `nn.ConvTranspose((4, 4), strides=(2, 2), padding="SAME")` from
    the module's weight (the flax kernel flipped, [in, out, kh, kw]): the
    input dilated by 2, padded (2, 2), correlated with the flax kernel."""
    import torch.nn.functional as F

    B, C, H, W = x.shape
    d = x.new_zeros(B, C, 2 * H - 1, 2 * W - 1)
    d[:, :, ::2, ::2] = x
    k = w_t if fault == "transpose kernel not flipped" else w_t.flip(2, 3)
    return F.conv2d(F.pad(d, (2, 2, 2, 2)), k.transpose(0, 1), b)


def plain_vq(sd, images=None, z=None, fault=None):
    """The plain copy of models/vq.py on the CPU: the encoder output
    [B, h, w, D] of `images` [B, H, W, C], or the decoder output of `z`."""
    import torch.nn.functional as F

    gelu = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    p = lambda name: (sd[name + ".weight"], sd[name + ".bias"])  # noqa: E731
    if images is not None:
        x = images.permute(0, 3, 1, 2)
        x = gelu(plain_vq_conv(x, *p("encoder.Conv_0"), 2, fault))
        x = gelu(plain_vq_conv(x, *p("encoder.Conv_1"), 2, fault))
        x = gelu(plain_vq_conv(x, *p("encoder.Conv_2"), 1, fault))
        return plain_vq_conv(x, *p("encoder.Conv_3"), 1, fault).permute(0, 2, 3, 1)
    x = gelu(plain_vq_conv(z.permute(0, 3, 1, 2), *p("decoder.Conv_0"), 1, fault))
    x = gelu(plain_vq_conv_transpose(x, *p("decoder.ConvTranspose_0"), fault))
    x = gelu(plain_vq_conv_transpose(x, *p("decoder.ConvTranspose_1"), fault))
    return plain_vq_conv(x, *p("decoder.Conv_1"), 1, fault).permute(0, 2, 3, 1)


def _max_err(got, want) -> float:
    """Largest |got - want|, infinite when the shapes differ."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return (got.float().cpu() - want.float().cpu()).abs().max().item()


def vq_tokenizer(card: str, dev="cuda") -> dict:
    """Phase 22 (a).  -> (the dataset, the trained VQVAE, readings)."""
    import copy

    import torch

    from neko_tpu_torch.envs.synthetic import SyntheticImageEnv
    from neko_tpu_torch.envs.vq_wrapper import _to_float_rgb
    from neko_tpu_torch.examples.world_model import train_tokenizer
    from neko_tpu_torch.models.vq import VQConfig, fp32_math

    t0 = time.perf_counter()
    cfg = VQConfig()
    ds, vq, hist = train_tokenizer(SyntheticImageEnv(), VQ_EPISODES, cfg, VQ_STEPS, 3e-4, dev)
    train_s = time.perf_counter() - t0
    mse = hist["recon_mse"]
    late = float(np.mean(mse[-20:]))
    frames = np.stack([_to_float_rgb(o) for i in range(ds.total_episodes)
                       for o in np.asarray(ds.get_episode(i).observations)])
    cpu = copy.deepcopy(vq).cpu()
    codes = vq.encode_indices(torch.from_numpy(frames).to(dev)).cpu()
    want = cpu.encode_indices(torch.from_numpy(frames))
    agree = (codes == want).float().mean().item()

    B, H, W = VQ_ODD
    x = torch.from_numpy(np.random.default_rng(SEED + 22).uniform(
        0, 1, (B, H, W, cfg.channels)).astype(np.float32))
    sd = {k: v.detach() for k, v in cpu.state_dict().items()}
    with torch.no_grad(), fp32_math():
        z = vq.encoder(x.to(dev).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    grid = tuple(z.shape[1:3])
    odd_codes = vq.encode_indices(x.to(dev))
    dec = vq.decode_indices(odd_codes, grid)
    z_q = sd["embedding"][odd_codes.cpu().reshape(-1).long()].reshape(B, *grid, cfg.code_dim)
    with torch.no_grad():
        errs = {"encoder": _max_err(z, plain_vq(sd, images=x)),
                "decoder": _max_err(dec, plain_vq(sd, z=z_q))}
        faults = {f: max(_max_err(z, plain_vq(sd, images=x, fault=f)),
                         _max_err(dec, plain_vq(sd, z=z_q, fault=f))) for f in VQ_FAULTS}
    print(f"phase 22 (a) VQ K={cfg.codebook_size} D={cfg.code_dim} hidden {cfg.hidden} on "
          f"{len(frames)} frames {frames.shape[1:]} of {VQ_EPISODES} episodes: {VQ_STEPS} steps "
          f"in {train_s:.1f} s, recon_mse {mse[0]:.5f} -> {mse[-1]:.5f} (last 20 {late:.5f}, "
          f"limit {VQ_MSE_DROP:g} of the first), perplexity {hist['perplexity'][0]:.1f} -> "
          f"{hist['perplexity'][-1]:.1f}; card codes equal to the CPU's fp32 codes on "
          f"{agree:.5f} of {codes.numel()} (limit {VQ_CODE_AGREE_MIN:g}); a {H}x{W} input "
          f"(grid {grid}) against the plain copy: encoder {errs['encoder']:.3e}, decoder "
          f"{errs['decoder']:.3e} (limit {VQ_OUT_TOL:g}); planted "
          + ", ".join(f"'{f}' {e:.3e}" for f, e in faults.items()) + f" ({card})")
    _require(all(np.isfinite(mse)) and late <= VQ_MSE_DROP * mse[0],
             f"the VQ's recon_mse did not fall: {mse[0]} -> {late}")
    _require(agree >= VQ_CODE_AGREE_MIN, f"VQ codes agree with fp32 on {agree} only")
    _require(grid == (-(-H // 4), -(-W // 4)), f"grid {grid} of a {H}x{W} image")
    _require(max(errs.values()) <= VQ_OUT_TOL, f"the VQ disagrees with its plain copy: {errs}")
    blind = [f for f, e in faults.items() if not e > VQ_OUT_TOL]
    _require(not blind, f"the VQ check cannot tell {blind}")
    return ds, vq, {"recon_mse": [mse[0], mse[-1], late], "perplexity": hist["perplexity"][-1],
                    "agree": agree, "err": errs, "faults": faults, "seconds": train_s}


@contextlib.contextmanager
def fp32_head(model):
    """Within the block `model`'s head computes the logits from its hidden
    states and weights in fp32 (one process, no fp8 weights)."""
    import torch

    def head(hidden):
        return torch.nn.functional.linear(hidden.float(), model.predict_token.weight.float())

    model._head = head
    try:
        yield
    finally:
        del model._head


@contextlib.contextmanager
def forced_picks(toks, start):
    """Within the block the Generator's token choice returns the columns of
    `toks` ([N, T] absolute ids, one column a call) in turn: teacher
    forcing of a decode loop with its positions and per-step limits."""
    from neko_tpu_torch.inference import generator as gmod

    pick, cols = gmod._pick, iter((toks - start).unbind(1))
    gmod._pick = lambda window, *a: next(cols)
    try:
        yield
    finally:
        gmod._pick = pick


def world_model(card: str, ds, vq, main: dict, dev="cuda") -> dict:
    """Phase 22 (b).  Adds the Trainer's and imagine's launches to `main`."""
    import torch

    from neko_tpu_torch.envs.synthetic import SyntheticImageEnv
    from neko_tpu_torch.examples import world_model as wm

    t0 = time.perf_counter()
    codec, wrapped, vq_ds, task = wm.world_model_task(SyntheticImageEnv(), ds, vq, dev,
                                                      FLAGSHIP["context_len"])
    K, grid = vq.cfg.codebook_size, wrapped.grid
    args = wm.world_model_args(
        cpu=dev == "cpu", device=dev, sequence_length=FLAGSHIP["context_len"],
        embed_dim=FLAGSHIP["embed_dim"], layers=FLAGSHIP["layers"], heads=FLAGSHIP["heads"], batch_size=WORLD_ROWS,
        training_steps=WORLD_STEPS, log_eval_freq=WORLD_STEPS, warmup_steps=2,
        learning_rate=1e-4, mixed_precision="bf16", dropout=RATE, fused_adamw=True)
    counters = _launch_counters()
    for c in counters.values():
        c.launches = 0
    with trainer_recorder() as rec:
        trainer = wm.train_world_model(task, args)
    train = {k: c.launches for k, c in counters.items()}
    losses = [float(x) for x in rec["losses"]]
    cfg = trainer.ctx.model_cfg
    gen = wm.dream_generator(trainer)
    del trainer
    if dev == "cuda":
        torch.cuda.empty_cache()
    H, F = WORLD_DREAM["history"], WORLD_DREAM["frames"]
    for c in counters.values():
        c.launches = 0
    with model_call_counter() as calls:
        res = wm.dream(gen, codec, vq_ds, grid, H, F)
    dream_launches = {k: c.launches for k, c in counters.items()}
    for part in (train, dream_launches):
        for k, n in part.items():
            main[k] = main.get(k, 0) + n

    # the first frame's logits, kernels against the plain prefill and decode
    hist, _, _ = wm.dream_inputs(vq_ds, H, F)
    n = grid[0] * grid[1]
    start = cfg.token_space.start("discrete")
    kw = dict(max_new_tokens=n, start=start, end=start + K - 1, deterministic=True,
              inner_pos_start=0, step_limits=[K] * n)
    with fp32_head(gen.model):
        toks, got = gen.generate_batch([hist], **kw)
        with prefill_attention_through(plain_prefill_attention), \
                decode_attention_through(plain_decode_attention), \
                forced_picks(torch.as_tensor(toks, device=dev), start):
            toks_p, want = gen.generate_batch([hist], **kw)
    err = float(np.abs(got - want).max())
    same = bool((toks == toks_p).all())
    top = float(np.abs(got).max())
    seconds = time.perf_counter() - t0
    print(f"phase 22 (b) world model {cfg.embed_dim}d/{cfg.layers}L/{cfg.heads}h "
          f"k={cfg.context_len} bf16 dropout {cfg.dropout}, fused AdamW, --observation_loss on "
          f"{K}-code grids {grid}: {WORLD_STEPS} steps of {WORLD_ROWS} rows, losses "
          + ", ".join(f"{x:.4f}" for x in losses) + f"; launches {train}; imagine {F} frames "
          f"after {H}: codes {res['dream'].shape}, next-frame code accuracy "
          f"{res['accuracy']:.3f}, decoded-pixel MSE {res['pixel_mse']:.5f}, launches "
          f"{dream_launches} ({calls['prefill']} prefills, {calls['decode_step']} decode "
          f"steps); first frame's window logits (fp32 readout, |logit| up to {top:.2f}), kernels "
          f"vs plain attention (fed the same codes): {err:.3e} (limit {DECODE_LOGIT_TOL:g}); "
          f"{seconds:.1f} s ({card})")
    L = cfg.layers
    _require(len(losses) == WORLD_STEPS and all(np.isfinite(losses)),
             f"world model losses {losses}")
    _require(train["fwd"] == train["bwd"] == L * WORLD_STEPS and train["adamw"] == WORLD_STEPS
             and train["loss"] >= WORLD_STEPS and train["decode"] == train["mask"] == 0,
             f"the world model's steps did not launch #3 / #4 layers x steps, #16 once a step "
             f"and #15 at least once a step: {train}")
    _require(dream_launches["fwd"] == calls["prefill_layers"] == L * F
             and dream_launches["decode"] == calls["decode_step_layers"] > 0,
             f"imagine did not prefill through #1 and decode through #14: {dream_launches}, "
             f"{calls}")
    _require(res["dream"].shape == (F, n) and (res["dream"] < K).all() and same
             and np.isfinite(res["pixel_mse"]), "imagine's codes")
    _require(err <= DECODE_LOGIT_TOL, f"imagine's first frame logits disagree: {err}")
    del gen
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "train_launches": train, "dream_launches": dream_launches,
            "accuracy": res["accuracy"], "pixel_mse": res["pixel_mse"], "logit_err": err,
            "seconds": seconds}


def wide_ring(card: str, dev="cuda") -> dict:
    """Phase 22 (c).  -> readings."""
    import torch

    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.convert import init_state_dict
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.data.packing import SequencePacker
    from neko_tpu_torch.ops import blocked_attention as ba
    from neko_tpu_torch.ops import ring_kernel as rk
    from neko_tpu_torch.parallel.mesh import create_mesh
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext

    t0 = time.perf_counter()
    cfg = ModelConfig(**dict(WIDE, context_len=WIDE_RING_CONTEXT, dropout=0.0))
    _require(cfg.head_dim == 256, f"hd {cfg.head_dim}")
    rng = np.random.default_rng(SEED + 23)
    arrays = SequencePacker(cfg).pack_batch([{"text": rng.integers(0, 256, n)}
                                             for n in WIDE_RING_ROWS])
    arrays.pop("lengths")
    batch = to_device_batch(arrays, dev)
    sd = init_state_dict(cfg, SEED)
    counters = dict(_launch_counters(), ring_fwd=rk.ring_partial_fwd, ring_dq=rk.ring_partial_dq,
                    ring_dkv=rk.ring_partial_dkv, blocked_fwd=ba.blocked_attention_fwd,
                    blocked_fused=ba.blocked_attention_bwd_fused)
    for c in counters.values():
        c.launches = 0
    ring_ctx = TrainContext(cfg, OptimizerConfig(), device=dev, seed=SEED,
                            mesh=create_mesh(data=1, seq=SEQ))
    plain_ctx = TrainContext(cfg, OptimizerConfig(), device=dev, seed=SEED)

    def loss_and_grads(context, fault=None):
        st = context.init_state({k: v.clone() for k, v in sd.items()})
        with ring_planted(fault):
            loss = context.loss_and_grads(st, batch).item()
        grads = {n: p.grad for n, p in st.model.named_parameters() if p.grad is not None}
        _sync(dev)
        return loss, grads

    ts = time.perf_counter()
    loss_r, grads_r = loss_and_grads(ring_ctx)
    ring_s = time.perf_counter() - ts
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if dev == "cuda" else float("nan")
    loss_p, grads_p = loss_and_grads(plain_ctx)
    gap, dloss = _grad_gap(grads_r, grads_p), abs(loss_r - loss_p)
    del grads_r
    fault_gap, fault_dloss = {}, {}
    for f in WIDE_RING_FAULTS:
        loss_f, grads_f = loss_and_grads(ring_ctx, f)
        fault_gap[f], fault_dloss[f] = _grad_gap(grads_f, grads_p), abs(loss_f - loss_p)
        del grads_f
    del grads_p
    drop_ctx = TrainContext(cfg.replace(dropout=RATE), OptimizerConfig(), device=dev, seed=SEED,
                            mesh=create_mesh(data=1, seq=SEQ))
    loss_d, grads_d = loss_and_grads(drop_ctx)
    drop_ok = np.isfinite(loss_d) and all(torch.isfinite(g).all().item()
                                          for g in grads_d.values())
    del grads_d
    launched = {k: c.launches for k, c in counters.items()}
    seconds = time.perf_counter() - t0
    print(f"phase 22 (c) hd 256 ring ({cfg.embed_dim}d/{cfg.heads}h/{cfg.layers}L "
          f"k={cfg.context_len} bf16, rows of {WIDE_RING_ROWS} tokens) over {SEQ} shards on the "
          f"card ({ring_s:.2f} s a step with its first call, peak {peak:.2f} GiB) vs plain "
          f"attention without a 'seq' axis, dropout 0: loss {loss_r:.6f} vs {loss_p:.6f} (diff "
          f"{dloss:.3e}, limit {WIDE_RING_LOSS_TOL:g}), largest relative gradient error "
          f"{gap:.3e} (limit {WIDE_RING_GRAD_TOL:g}); planted "
          + ", ".join(f"'{f}' loss {fault_dloss[f]:.3e} gradient {fault_gap[f]:.3e}"
                      for f in WIDE_RING_FAULTS)
          + f"; at dropout {RATE}: loss {loss_d:.6f}, finite {drop_ok}; launches {launched}; "
          f"{seconds:.1f} s ({card})")
    _require(dloss <= WIDE_RING_LOSS_TOL and gap <= WIDE_RING_GRAD_TOL,
             f"the hd 256 ring disagrees with plain attention: {dloss}, {gap}")
    blind = [f for f in WIDE_RING_FAULTS
             if not (fault_gap[f] > WIDE_RING_GRAD_TOL or fault_dloss[f] > WIDE_RING_LOSS_TOL)]
    _require(not blind, f"the hd 256 ring check cannot tell {blind}")
    _require(drop_ok and abs(loss_d - loss_r) > 0, f"the dropout step: {loss_d}")
    attention = {k: n for k, n in launched.items() if k not in ("loss", "adamw")}
    _require(not any(attention.values()), f"an attention kernel launched at hd 256: {attention}")
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"loss_err": dloss, "grad_err": gap, "fault_grad": fault_gap,
            "fault_loss": fault_dloss, "step_s": ring_s, "peak_gib": peak,
            "launches": launched, "seconds": seconds}


def vq_world_model(card: str, dev="cuda") -> dict:
    """Phase 22.  -> {"launches": the main path's (b), "readings"}."""
    t0 = time.perf_counter()
    main = {}
    ds, vq, vq_read = vq_tokenizer(card, dev)
    readings = {"vq": vq_read, "world": world_model(card, ds, vq, main, dev),
                "ring": wide_ring(card, dev)}
    print(f"phase 22 main-path launches: {main}; phase 22 took "
          f"{time.perf_counter() - t0:.1f} s")
    return {"launches": main, "readings": readings}


# ------------------------------------------------ the serving bench harnesses
def _harness_line(name: str, argv) -> dict:
    """`main(argv)` of a serving harness in this process: its JSON line,
    printed on a line of its own; a non-zero exit fails the phase."""
    import importlib
    import io

    mod = importlib.import_module(("neko_tpu_torch." if name == "bench_decode"
                                   else "neko_tpu_torch.tools.") + name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"{name} {' '.join(argv)}:")
    print(line)
    _require(rc == 0, f"{name} {argv} exited {rc}")
    return json.loads(line)


def native_packer_vs_numpy() -> int:
    """The native packer built on this machine against the numpy route on
    the three pure-control variants (tests/test_native_packing.py's cases),
    bit for bit.  -> the packs made."""
    from neko_tpu_torch import native
    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.data.packing import SequencePacker

    cfg = ModelConfig(**dict(FLAGSHIP, max_patches=0))
    rng = np.random.RandomState(SEED)
    top = np.tanh(rng.randn(12, 3)).astype(np.float32)
    top[0, 0], top[0, -1] = 1.0, -1.0  # the unclipped top bin, the bottom edge
    cases = [{"continuous_obs": rng.randn(12, 8).astype(np.float32), "continuous_actions": top},
             {"continuous_obs": (rng.randn(7, 5) * 100).astype(np.float32),
              "discrete_actions": rng.randint(0, 50, (7, 1)).astype(np.int32)},
             {"discrete_obs": rng.randint(0, 50, (9, 2)).astype(np.int32),
              "discrete_actions": rng.randint(0, 50, (9, 1)).astype(np.int32)}]
    fast, plain = SequencePacker(cfg), SequencePacker(cfg)
    plain._pack_control_native = lambda ex: None
    before = native.calls
    for ex in cases:
        a, b = fast.pack_example(ex), plain.pack_example(ex)
        for field in ("tokens", "target_mask", "inner_pos"):
            _require(np.array_equal(getattr(a, field), getattr(b, field)),
                     f"native packer {sorted(ex)}: {field} differs from the numpy route")
    packs = native.calls - before
    _require(packs == len(cases), f"{packs} native packs for {len(cases)} examples")
    print(f"native packer built on this machine ({native.library_path().name}): tokens, "
          f"targets and inner positions equal to the numpy route on the {len(cases)} variants")
    return packs


def serving_harnesses(card: str) -> dict:
    """Phase 23: the serving bench harnesses through their main() at the
    flagship width (HARNESS_RUNS) and the native packer.  -> the main
    path's launches of #1 ("fwd"), #14 ("decode") and #14-int8 ("int8"),
    and the harnesses' lines."""
    from neko_tpu_torch.tools import harness

    t0 = time.perf_counter()
    for fn in harness.launch_counters().values():
        fn.launches = 0
    lines = [_harness_line(name, argv) for name, argv in HARNESS_RUNS]
    launched = harness.read_launches()
    dec, dec8, spec, spec32, srv, srv32, roll, still = lines
    layers = FLAGSHIP["layers"]
    steps = (DECODE_BENCH["new"] - 1) * layers
    want = {"whole_head_attention": layers, "decode_cache_attention": steps,
            "decode_cache_attention_int8": 0}
    _require(dec["launches"] == want, f"bench_decode launches {dec['launches']}, want {want}")
    want8 = dict(want, decode_cache_attention=0, decode_cache_attention_int8=steps)
    _require(dec8["launches"] == want8, f"bench_decode --kv_quant launches {dec8['launches']}")
    k = spec["k"]
    for line in (spec, spec32):
        for name in ("cyclic", "random"):
            r = line[name]
            _require(r["lossless"] and 1 <= r["tokens_per_round"] <= k + 1,
                     f"bench_spec {line['dtype']} {name}: {r}")
    _require(spec32["cyclic"]["tie_flips"] == 0 and spec32["cyclic"]["tokens_equal"],
             "bench_spec fp32 cyclic: the speculative tokens differ from plain greedy's")
    for line in (srv, srv32):
        _require(line["errors"] == 0 and line["lossless"],
                 f"bench_serving {line['dtype']}: errors {line['errors']}, a difference "
                 "beyond a logit tie")
    _require(srv32["outputs_equal"], "bench_serving fp32: the modes' tokens differ")
    for r in (roll, still):
        _require(r["actions_finite"] and r["launches"]["repack"]["whole_head_attention"] > 0
                 and r["launches"]["rollout_cache"]["decode_cache_attention"] > 0,
                 f"bench_rollout: {r}")
    _require(still["actions_equal"], "bench_rollout without eviction: the rollout cache and "
             f"the re-pack took other actions (agree {still['actions_agree_share']})")
    packs = native_packer_vs_numpy()
    seconds = time.perf_counter() - t0
    out = {"fwd": launched["whole_head_attention"], "decode": launched["decode_cache_attention"],
           "int8": launched["decode_cache_attention_int8"], "native_packs": packs,
           "seconds": seconds, "lines": lines}
    print(f"phase 23 main-path launches: #1 {out['fwd']}, #14 {out['decode']}, #14-int8 "
          f"{out['int8']}; bench_decode {dec['per_token_ms']:.3f} ms a token (int8 cache "
          f"{dec8['per_token_ms']:.3f}), bench_spec tokens a round cyclic "
          f"{spec['cyclic']['tokens_per_round']:.2f} / random "
          f"{spec['random']['tokens_per_round']:.2f} (tie flips {spec['cyclic']['tie_flips']} / "
          f"{spec['random']['tie_flips']} in bf16, {spec32['cyclic']['tie_flips']} / "
          f"{spec32['random']['tie_flips']} in fp32), bench_serving "
          f"{srv['continuous']['requests_per_sec']:.2f} against "
          f"{srv['coalesce']['requests_per_sec']:.2f} requests/s (requests differing in bf16 "
          f"{srv['requests_differing']}, fp32 {srv32['requests_differing']}), bench_rollout "
          f"speedup "
          f"{roll['speedup']:.2f}, actions agree {roll['actions_agree_share']:.3f} (full prompt) "
          f"/ {still['actions_agree_share']:.3f} (no eviction); phase 23 took {seconds:.1f} s "
          f"({card})")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    laps, t_lap = {}, [t_start]

    def lap(name):  # seconds since the previous lap
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from neko_tpu_torch.bench import card as card_name
    from neko_tpu_torch.ops import cuda_build

    card = card_name()
    print("card (nvidia-smi name, power.limit):")
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    for name in libs:
        cuda_build.load_library(name)
    print(f"built {', '.join(so.name for so in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    for so in libs.values():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {so.stem.rsplit('-', 1)[0]}:", line.strip())
    fwd_instances = _fwd_ptxas(libs)
    for name, tile, args, regs, spills in fwd_instances:
        print(f"ptxas attention forward {name} {tile} {args}: {regs} registers, "
              f"{spills} bytes spilled")
    _require(fwd_instances and not any(r[4] for r in fwd_instances),
             "an attention forward instance spills registers (or none was found)")
    decode_instances = _decode_ptxas(libs)
    for q_type, cache, hd, regs, spills in decode_instances:
        print(f"ptxas decode attention q {q_type} cache {cache} hd {hd}: {regs} registers, "
              f"{spills} bytes spilled")
    _require(len(decode_instances) == 16 and not any(r[4] for r in decode_instances),
             "a decode attention instance spills registers (or not all 16 were found)")
    lap("1 build")
    err, prefill = kernel_vs_plain(
        8, 24, 1024, 32, "bfloat16",
        starts=[0, 0, 0, 0, 0, 0, 0, 300],
        ends=[1024, 700, 1, 1024, 700, 1, 1024, 1024], timed=True)
    print(f"flagship prefill attention: kernel {prefill['ms']:.4f} ms, plain "
          f"{prefill['plain_ms']:.4f} ms ({card})")
    kernel_vs_plain(8, 12, 1024, 64, "float32", starts=[0] * 7 + [100],
                    ends=[1024, 700, 1, 1024, 513, 1, 1024, 1024], timed=False)
    kernel_vs_plain(8, 6, 1024, 128, "float32", starts=[0] * 7 + [100],
                    ends=[1024, 700, 1, 1024, 513, 1, 1024, 1024], timed=False)
    # hd 16: the tensor-core tile in bf16; fp32 zero-padded to 32 by the wrapper
    for dtype_name in ("bfloat16", "float32"):
        kernel_vs_plain(8, 8, 1024, 16, dtype_name, starts=[0] * 7 + [100],
                        ends=[1024, 700, 1, 1024, 513, 1, 1024, 1024], timed=False)
    lap("2")

    serve_launches, decode_launches, gen, examples = serve(card)
    prefill_check(gen, examples)
    del gen
    lap("3-4")

    trained = train_kernels_vs_plain(card)
    launches = train_step_check(card)
    smoke_width_step_check(card)
    print(f"forward kernel launches: serving run {serve_launches}, train run {launches['fwd']}")
    lap("5-6")
    blocked = blocked_kernels_vs_plain(card)
    lap("7")
    long_path = long_train(card)
    lap("8")
    ring = ring_kernels_vs_plain(card)
    lap("9")
    seq_path = seq_parallel_train(card)
    lap("10")
    decode = decode_kernels_vs_plain(card)
    decode.update(generate=decode_generate(card))
    lap("11")
    loss_head = loss_kernel_vs_plain(card, libs)
    lap("12")
    adamw = fused_adamw_check(card)
    lap("13")
    workdir = Path(__file__).resolve().parent / "_smoke_runs"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        cli = train_entry_point(card, launches["step_ms"], workdir)
        lap("14")
        shutil.rmtree(workdir, ignore_errors=True)
        ev = eval_entry_point(card, workdir)
        lap("15")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    se = serving_engine(card)
    lap("16")
    try:
        tf = train_features(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lap("17")
    try:
        par = parallel_train(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lap("18")
    try:
        p19 = pipeline_seq_train(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lap("19")
    try:
        p20 = quantized_tp_serving(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lap("20")
    try:
        p21 = weights_in_and_out(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lap("21")
    ww = vq_world_model(card)["launches"]
    lap("22")
    p23 = serving_harnesses(card)
    lap("23")
    wl, wk = p21["launches"], p21["kernels"]
    q20, r20 = p20["serving"], p20["ranks"]
    q_fwd, q_decode = q20["fwd"] + r20["fwd"], q20["decode"] + r20["decode"]
    pl = par["launches"]
    pk = par["kernels"]
    sl, pp = p19["launches"]["seq"], p19["launches"]["pipe"]
    qk = p19["kernels"]

    def at_microbatch(key):  # #3 / #4 timed on a pipeline microbatch's rows
        ms, plain_ms, library_ms, bound_ms, bound_by, flops = qk["attn"][PIPE_ATTN[0]][key]
        return {"shape": list(PIPE_ATTN[0]) + [TRAIN["S"], TRAIN["hd"]], "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "tflops": _tflops(flops, ms)}

    def at_rank_shape(key):  # #3 / #4 timed at a rank's (model=2) rows and heads
        ms, plain_ms, library_ms, bound_ms, bound_by, flops = pk["attn"][PARALLEL_ATTN[-1]][key]
        return {"shape": list(PARALLEL_ATTN[-1]) + [TRAIN["S"], TRAIN["hd"]], "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "tflops": _tflops(flops, ms),
                "data2_shape": {"ms": pk["attn"][PARALLEL_ATTN[0]][key][0]}}

    def at_gpt2(key):  # #3 / #4 timed at GPT-2 small's heads (phase 21 (a))
        ms, plain_ms, library_ms, bound_ms, bound_by, flops = wk["attn"][GPT2_ATTN[0]][key]
        return {"shape": list(GPT2_ATTN[0]) + [TRAIN["S"], GPT2_HD], "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "tflops": _tflops(flops, ms)}

    src = "neko_tpu_torch/csrc/"
    tpu = "neko_tpu/ops/attention_kernel.py"
    tpu_b = "neko_tpu/ops/blocked_attention.py"
    tpu_r = "neko_tpu/ops/ring_kernel.py"

    def timing(part):  # phase 5's kernel, plain, library and bound at the flagship shape
        ms, plain_ms, library_ms, bound_ms, bound_by, flops = trained[part]
        out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        if flops:  # the attention tiles: the rate they reach on the bound's FLOPs
            out["tflops"] = _tflops(flops, ms)
        return out

    long_times = blocked["times"][BLOCKED_TIMED[0][2]]  # at the `long` shape
    entries = [
        # timed at the train shape (#3); the prefill shape's times (#1) beside
        {"name": "whole_head_attention", "route": "cuda",
         "source": src + "whole_head_attention.cu", "replaces": f"{tpu}:206,236",
         "launches": (serve_launches + launches["fwd"] + cli["fwd"] + ev["fwd"] + ev["eval_fwd"]
                      + se["fwd"] + tf["fwd"] + pl["fwd"] + sl["fwd"] + pp["fwd"] + q_fwd
                      + wl["fwd"] + ww["fwd"] + p23["fwd"]),
         "train_cli_launches": cli["fwd"], "mix_train_launches": ev["fwd"],
         "eval_cli_launches": ev["eval_fwd"], "serving_engine_launches": se["fwd"],
         "train_features_launches": tf["fwd"], "parallel_launches": pl["fwd"],
         "seq_ranks_launches": sl["fwd"], "pipeline_launches": pp["fwd"],
         "quant_tp_serving_launches": q_fwd, "weights_io_launches": wl["fwd"],
         "world_model_launches": ww["fwd"], "serving_harness_launches": p23["fwd"],
         "max_abs_err": max(err, trained["fwd_err"], pk["err"]["fwd"], qk["err"]["fwd"],
                            wk["err"]["fwd"], wk["err"]["prefill"]),
         **timing("fwd"), "prefill": prefill, "parallel_rank_shape": at_rank_shape("fwd"),
         "microbatch_shape": at_microbatch("fwd"), "gpt2_small_shape": at_gpt2("fwd")},
        {"name": "whole_head_attention_bwd", "route": "cuda",
         "source": src + "whole_head_attention_bwd.cu", "replaces": f"{tpu}:220,256",
         "launches": (launches["bwd"] + cli["bwd"] + ev["bwd"] + tf["bwd"] + pl["bwd"]
                      + sl["bwd"] + pp["bwd"] + wl["bwd"] + ww["bwd"]),
         "train_cli_launches": cli["bwd"], "mix_train_launches": ev["bwd"],
         "train_features_launches": tf["bwd"], "parallel_launches": pl["bwd"],
         "seq_ranks_launches": sl["bwd"], "pipeline_launches": pp["bwd"],
         "weights_io_launches": wl["bwd"], "world_model_launches": ww["bwd"],
         "max_abs_err": max(trained["bwd_err"], pk["err"]["bwd"], qk["err"]["bwd"],
                            wk["err"]["bwd"]),
         **timing("bwd"), "parallel_rank_shape": at_rank_shape("bwd"),
         "microbatch_shape": at_microbatch("bwd"), "gpt2_small_shape": at_gpt2("bwd")},
    ] + [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": f"{tpu_b}:{line}", "launches": long_path[key], "parallel_launches": 0,
         "seq_ranks_launches": 0, "pipeline_launches": 0,
         "check_launches": blocked["check_launches"][key],
         "max_abs_err": blocked["err"][key], **long_times[key]}
        for name, source, line, key in (
            ("blocked_attention_fwd", "blocked_attention.cu", 183, "fwd"),
            ("blocked_attention_bwd_fused", "blocked_attention_bwd.cu", 290, "fused"),
            ("blocked_attention_dq", "blocked_attention_bwd.cu", 241, "dq"),
            ("blocked_attention_dkv", "blocked_attention_bwd.cu", 390, "dkv"))
    ] + [
        # the ring kernels, timed on a full (past) pair of the k = 8192 shards
        # (B=2, H=24, S_local=2048, hd=32), with the diagonal pair's times beside
        {"name": name, "route": "cuda", "source": src + "ring_attention.cu",
         "replaces": f"{tpu_r}:{line}",
         "launches": seq_path[f"ring {key}"] + sl[f"ring_{key}"] + pp[f"ring_{key}"],
         "parallel_launches": 0, "seq_ranks_launches": sl[f"ring_{key}"],
         "pipeline_launches": pp[f"ring_{key}"],
         "check_launches": ring["check_launches"][key] + qk["ring"]["check_launches"][key],
         "max_abs_err": max(ring["err"][key], qk["ring"]["err"][key]),
         **ring["times"]["full"][key],
         "diagonal_pair": ring["times"]["diagonal"][key],
         "seq_rank_pairs": {"shape": list(SEQ_RING),
                            **{kind: qk["ring"]["times"][kind][key]
                               for kind in ("diagonal", "full")}}}
        for name, line, key in (("ring_partial_fwd", 102, "fwd"), ("ring_partial_dq", 158, "dq"),
                                ("ring_partial_dkv", 208, "dkv"))
    ] + [
        # decode timed at B=8, H=24, S=1024, hd=32 bf16 on a full cache (each
        # of DECODE_TIMED under "shapes", with the cluster size n); launches
        # are the serving run's (layers x decode steps); registers and spills
        # per instance under "ptxas" (q, cache, hd, registers, spill bytes)
        {"name": "decode_cache_attention", "route": "cuda", "source": src + "decode_attention.cu",
         "replaces": "neko_tpu/ops/decode_attention.py:80",
         "launches": (decode_launches + cli["decode"] + ev["decode"] + ev["eval_decode"]
                      + se["decode"] + tf["decode"] + pl["decode"] + sl["decode"]
                      + pp["decode"] + q_decode + wl["decode"] + ww["decode"] + p23["decode"]),
         "train_cli_launches": cli["decode"], "mix_train_launches": ev["decode"],
         "eval_cli_launches": ev["eval_decode"], "serving_engine_launches": se["decode"],
         "train_features_launches": tf["decode"], "parallel_launches": pl["decode"],
         "seq_ranks_launches": sl["decode"], "pipeline_launches": pp["decode"],
         "quant_tp_serving_launches": q_decode, "weights_io_launches": wl["decode"],
         "world_model_launches": ww["decode"], "serving_harness_launches": p23["decode"],
         "check_launches": (decode["check_launches"] + decode["generate"]["launches"]
                            + p21["decode_check_launches"]),
         "max_abs_err": max(decode["err"], wk["err"]["decode"]), **decode["times"],
         "b1": decode["times_b1"], "shapes": decode["shapes"],
         "ptxas": [list(r) for r in decode_instances if r[1] != "int8"],
         "generate_per_token_ms": {k: decode["generate"][k] for k in ("kernel_ms", "plain_ms")}},
        # #14 over an int8 cache (neko_tpu computes it in XLA,
        # models/transformer.py:71 `_quant_cache_attention`), timed at B=8,
        # H=24, S=1024, hd=32 on a full cache (each of INT8_DECODE_TIMED under
        # "shapes"); launches are phase 20's int8 runs (layers x decode steps,
        # both ranks of (d) counted)
        {"name": "decode_cache_attention_int8", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "neko_tpu/ops/decode_attention.py:80",
         "computes": "neko_tpu/models/transformer.py:71",
         "launches": q20["int8_launches"] + r20["int8_launches"] + p23["int8"],
         "quant_tp_serving_launches": q20["int8_launches"] + r20["int8_launches"],
         "serving_harness_launches": p23["int8"],
         "check_launches": p20["kernel"]["check_launches"],
         "max_abs_err": p20["kernel"]["err"], **p20["kernel"]["times"],
         "b1": p20["kernel"]["times_b1"], "shapes": p20["kernel"]["shapes"],
         "ptxas": [list(r) for r in decode_instances if r[1] == "int8"],
         "generate_per_token_ms": {"int8": q20["int8"]["token_ms"],
                                   "native": q20["int8"]["native_token_ms"]}},
        # the loss head timed at the first [4096, 768] chunk of the flagship
        # loss, the 3,328- and 256-row chunks beside; launches are the train
        # runs' (one a loss chunk a step), library_ms the loss route it replaced
        {"name": "fused_logz_tl", "route": "cuda", "source": src + "fused_logz_tl.cu",
         "replaces": "neko_tpu/ops/loss_kernel.py:54",
         "launches": (launches["loss"] + long_path["loss head"] + seq_path["loss head"]
                      + adamw["loss_launches"] + cli["loss"] + ev["loss"] + tf["loss"]
                      + pl["loss"] + sl["loss"] + pp["loss"] + wl["loss"] + ww["loss"]),
         "train_cli_launches": cli["loss"], "mix_train_launches": ev["loss"],
         "train_features_launches": tf["loss"], "parallel_launches": pl["loss"],
         "seq_ranks_launches": sl["loss"], "pipeline_launches": pp["loss"],
         "weights_io_launches": wl["loss"], "world_model_launches": ww["loss"],
         "check_launches": loss_head["launches"],
         "max_abs_err": max(loss_head["err"], pk["err"]["loss"], qk["err"]["loss"]),
         **{k: v for k, v in loss_head.items() if k not in ("err", "launches")},
         "parallel_vocab_blocks": pk["loss"], "microbatch_chunk": qk["loss"]},
        # AdamW over the flagship tree; launches are the fused train steps'
        {"name": "fused_adamw", "route": "cuda", "source": src + "fused_adamw.cu",
         "replaces": "neko_tpu/ops/fused_adamw.py:101",
         "launches": (adamw["launches"] + cli["adamw"] + tf["adamw"] + pl["adamw"]
                      + sl["adamw"] + pp["adamw"] + wl["adamw"] + ww["adamw"]),
         "weights_io_launches": wl["adamw"], "world_model_launches": ww["adamw"],
         "train_cli_launches": cli["adamw"], "train_features_launches": tf["adamw"],
         "parallel_launches": pl["adamw"], "parallel_rank_shards": pk["adamw"],
         "seq_ranks_launches": sl["adamw"], "pipeline_launches": pp["adamw"],
         "stage_leaves": qk["adamw"],
         "check_launches": adamw["check_launches"], "max_abs_err": adamw["err"],
         **{k: adamw[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "optimizer_ms", "default_optimizer_ms")}},
    ]
    # kernel #5 writes the masks the checks hand to the plain attention, at
    # every S (so it is #10's counterpart too), timed at the flagship train
    # shape and at `long`'s; the train steps' kernels draw the same keep
    # bytes inline and never launch it, as neko_tpu's train step never runs
    # its counterparts.  A blocked backward route that
    # FUSED_MAX dispatches at no trained S runs in the checks alone.
    mask = {"name": "dropout_keep_scale", "route": "cuda",
            "source": src + "dropout_keep_scale.cu", "replaces": f"{tpu}:492,{tpu_b}:682",
            "launches": launches["mask"] + long_path["mask"] + seq_path["mask"],
            "parallel_launches": 0, "seq_ranks_launches": 0, "pipeline_launches": 0,
            "check_launches": launches["mask_check"] + blocked["check_launches"]["mask"],
            "max_abs_err": 0.0, **timing("mask"), "long": long_times["mask"]}
    for shape, t in (("16x24x1024^2", mask), ("8x24x2048^2", long_times["mask"])):
        print(f"mask kernel {shape}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.3f} of it) ({card})")
    print(f"phases 1-23 took {time.perf_counter() - t_start:.1f} s; seconds by phase {laps}")
    print(json.dumps({"check_kernels": [mask] + [e for e in entries if not e["launches"]]}))
    print(json.dumps({"kernels": [e for e in entries if e["launches"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
