#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpucfn_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, each printed as one JSON line:

1. ``device``: the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them (also printed raw on a line of its own, here and again
   just before the ``{"kernels": ...}`` line).
2. ``build``: compiles every kernel source of the serving and training
   paths (``tpucfn_torch/kernels/csrc/flash_fwd.cu``,
   ``flash_fwd_sm90.cu``, ``flash_fwd_decode_sm90.cu``,
   ``flash_fwd_mma_sm90.cu``, ``flash_bwd.cu``, ``flash_bwd_dq_sm90.cu``,
   ``flash_bwd_dq_mma_sm90.cu``, ``flash_bwd_dkv_sm90.cu`` and
   ``flash_bwd_dkv_mma_sm90.cu``) with ``nvcc`` for ``sm_90a``, one
   process per source, all started together.  Printed: each ``sm90`` and
   ``mma`` kernel's registers a thread and spill bytes at head dims 80
   and 160, from ``ptxas -v``; K1, K2 and K3 ``sm90`` at 160 must spill
   nothing (a wgmma accumulator that spills is serialized).
3. ``kernel``: the flash forward kernel (K1) against its plain PyTorch
   version on the same inputs, at the serving path's shapes (llama3-1b
   decode and prefill), the training path's (2 x 2048, causal), the
   decode variant's edge cases (llama3-8b width over an 8192-key cache,
   a GQA group of 3, D=16, segment ids, empty rows, non-causal, 4
   positions x GQA 4), two speculative-decoding verify passes (5 and 9
   positions x GQA 4 over a 2048-key cache: 20 and 36 packed rows) and
   the other edge cases (D=16/GQA and ragged D=128 with offsets, in fp32
   and bf16; empty rows, segment ids, non-causal; a GQA group of 3);
   each row names the variant that ran (``sm90``: wgmma tensor cores,
   bf16 with at least 64 packed rows and a group dividing 64;
   ``decode``: mma.sync, bf16 with at most 16; ``mma``: mma.sync at any
   row count and group, fp32 as 3xTF32); error, tolerance, times of the
   kernel, the plain version and one PyTorch library call
   (``scaled_dot_product_attention`` with a boolean mask, or
   ``is_causal`` for a plain causal square case: a yardstick only, never
   called by the port), the roofline bound and the host time of one
   call (no synchronise).  At every ``mma`` shape the old fma kernel
   (``flash_fwd.cu``, on no path now) is timed beside it in turns on the
   same inputs (fma, mma, mma, fma) and held to the same tolerance, and
   at the llama3-1b decode shape beside the decode variant; at every
   ``decode`` shape the mma variant is timed beside decode in turns
   (decode, mma, mma, decode) and held to the same tolerance
   (``mma_beside``: does decode still earn a kernel of its own?).
   ``mma_plans`` times the mma planner's key chunks against one chunk in
   turns.  Then one decode launch is captured in a ``torch.cuda.CUDAGraph``, the offsets,
   the query and the cache are changed in place, and the replay is held
   against the plain version (a replay is not a wrapper call and counts
   no launch).
4. ``kernel_bwd``: the backward kernels — Delta, K2 (dQ) and K3 (dK/dV)
   — against the plain backward on the same inputs: K2 and K3 on
   ``sm90`` in bf16 with a GQA group dividing 64, otherwise on ``mma``
   (mma.sync, 3xTF32 in fp32).  At the training shape (llama3-1b, B=2,
   S=2048, bf16) and the edge cases (D=16 GQA 2, D=128 with a query
   offset and a nonzero dLSE, each in fp32 and bf16; segment ids, empty
   rows, non-causal ragged lengths, a GQA group of 3, in fp32 also with
   segment ids and empty rows; 64 queries x GQA 4 over 2048 keys,
   non-causal, with dLSE, in fp32); error beside its
   tolerance, kernel, bound, plain and library ms (the library
   yardstick is the backward of one
   ``scaled_dot_product_attention`` call for K2 and K3, and one
   ``torch.linalg.vecdot`` for Delta); at every K2 and K3 ``mma`` shape
   the old fma kernel is timed beside it in turns and held to the same
   tolerance; an empty call counts no launch.
5. ``serve_llama3_1b``: ``Server`` -> ``ServeEngine`` -> ``Llama`` at the
   full width and depth of llama3-1b (random weights from a seed) answers
   8 requests; every request completes, no KV block leaks, the kernel ran
   on every layer of every prefill (``sm90``) and decode (``decode``)
   call, none on ``mma`` or ``fma``, and teacher-forced logits agree with the plain
   attention path; a profiled decode step reports the decode kernel's
   device time.
6. ``serve_tiny_fp32``: the tiny preset in fp32; every K1 launch on
   ``mma``, and the engine's greedy tokens (kernel) equal ``generate``'s
   (plain attention).
7. ``serve_spec_llama3_1b``: speculative decoding at llama3-1b's full
   width and depth (8 slots, ``cache_len`` 2048, the serving prompts, 96
   new tokens), the reference's drill (``benches/serve_bench.py``) in
   three legs: plain, a ``SpecDecoder`` with a self draft (k = 4) and one
   with a divergent llama3-1b draft (seed 1; ``SpecKController(k=4,
   window=4, probe_every=64)``).  Gates: every request completes, no KV
   block leaks; K1 launches equal 16 x the calls of both engines, and by
   variant equal ``fwd_variant`` at every call's shape (the width-5
   verify on ``mma``, none on ``fma``); a verify's logits within 0.25 of
   the plain path; each token where a spec leg first differs from plain
   at a near-tie (top-2 gap < 0.25); the self draft at >= 1.5x plain's
   tokens per target step; the divergent draft's controller off after
   at most 12 proposing rounds, then probes only.  K1 at width 1, 5 and
   9 over a verify's serving offsets, timed in turns; a profiled verify
   pass beside a profiled decode step.  Then the drill in fp32 at the
   tiny preset (a divergent nano draft): spec output equal to plain's,
   worst-case TPOT <= 1.3x plain's (twenty passes each, in turns).
8. ``serve_router_llama3_1b``: a ``ReplicaRouter`` over two llama3-1b
   replicas sharing one set of weights (replica 0 a self-draft
   ``SpecDecoder``); 12 requests of 64 tokens, replica 1 killed once
   both replicas have emitted tokens, 4 more requests after.  Gates:
   every request complete with 64 tokens, a failover or retry, replica 1
   relaunched in probation and serving again, never two loops on one
   engine, no KV block leaked, K1 launches by variant exact under the
   two serve threads.  Printed: kill to the first retried token, the
   replicas' state changes.
9. ``serve_cli_llama3_1b``: ``python -m tpucfn_torch.cli serve --preset
   llama3-1b --replicas 2 --spec-draft self --synthetic 16 --max-new 64
   --obs-port 0 --trace-dir D`` under ``TPUCFN_FT_DIR``, in a
   subprocess, sent SIGTERM once every request is in.  Gates: exit 0
   with every request served within ``--drain-grace``; ``router_*`` and
   ``serve_spec_*`` series on the live ``/metrics``; the heartbeats
   advance; ``cli obs --run-dir`` on D's parent gives a request
   breakdown with ``spec_propose_s`` and ``spec_verify_s``; with every
   request in, ``cli obs profile --seconds 2`` gets a 200 from ``POST
   /profile`` and a trace that names K1's ``decode`` kernel.
10. ``train_llama3_1b``: ``Trainer`` -> ``Llama`` (fp32 master weights,
   bf16 compute, full remat, chunked CE with z-loss, the example's
   clip + AdamW + warmup-cosine chain) takes 4 steps on a fixed
   ``synthetic_tokens`` batch of 2 x 2048 at the full width and depth of
   llama3-1b (random weights from seed 0): finite losses, the last below
   the first, and per step exactly 32 K1 launches (forward and remat
   recompute), 16 K2, 16 K3 and 16 Delta, every K1, K2 and K3 launch on
   the ``sm90`` variant (none on ``mma`` or ``fma``); then loss and every gradient
   against the plain attention path (loss within a tolerance, cosine
   >= 0.99), step time, tokens/s, peak memory, model flops over the
   bf16 peak, and a profiled step.
11. ``train_tiny_fp32``: the tiny preset in fp32, a few steps through the
   kernels against the plain path: losses equal to fp32 sum order; every
   K1, K2 and K3 launch on ``mma`` (none on ``fma``).
12. ``example_llama3_1b``: the port's example
   (``tpucfn_torch/examples/llama3_8b_fsdp.py``) through its
   ``main(argv)``, run dirs in a temp dir (free space printed first,
   the dir deleted at the end): ``flash_autotune.tune`` at the example's
   family (S 2048, D 64, bf16, causal) beside the committed table entry;
   ``--model 1b --seq-len 2048 --batch-size 2 --steps 10 --num-examples
   2`` at full width and depth (one batch, trained on at every step: 10
   finite losses, the last below the first; every step
   32/16/16/16 K1/K2/K3/Delta launches, all on ``sm90``, so the default
   attention went to the kernels; its checkpoints, the loop's steady
   step against ``train_llama3_1b``'s bare step with step 1's checkpoint
   write in flight and, once it is durable, without, tokens/s, data
   wait, the MFU gauge, peak memory); a resume at full width and 2 layers
   (``--stop-after 3``, relaunched to 6: resumed at step 3, losses of
   steps 4-6 within 1e-3 relative of an uninterrupted run); and
   ``--packed`` at 2 layers for 3 steps (finite losses; every flash call
   with segment ids, K1, K2 and K3 on ``sm90`` in every layer; then K1,
   Delta, K2 and K3 held against their plain versions at that shape with
   the run's segment ids: error, kernel, bound, plain and library times,
   rows beside each kernel's others in the kernels line).

13. ``ft_llama3_1b``: the cluster entry point, in subprocesses:
   ``python -m tpucfn_torch.cli create-stack --accelerator h100-1`` on
   the fake control plane, then ``launch --ft --obs-port P --chaos`` runs
   the port's example (``python -m tpucfn_torch.examples.llama3_8b_fsdp
   --model 1b --layers 2 --seq-len 2048 --batch-size 2 --steps 34
   --ckpt-every 20``) under the gang coordinator, with heartbeats every
   0.5 s, a restart budget of 1, a drain step margin of 6, a chaos
   ``kill`` at fleet step 21 and a ``preempt_notice`` at fleet step 24.
   Gates: the launch exits 0; one unplanned gang restart (budget 1 used)
   and one planned drain (none), in that order; the relaunch after the
   kill resumes from the newest step finalized when it landed (> 0), the
   one after the drain from the drain's force-save, at the drain's
   target step; the 34 losses equal an
   uninterrupted run's (in this process, planes off) within 1e-3
   relative; while the rank trains, the supervisor's ``/healthz``
   answers and rank 0's ``/healthz`` carries its step, its ``/metrics``
   the step and the card's memory gauges, its ``/flightrecorder`` ``hbm``
   samples from the card, and ``POST /profile?seconds=2`` writes a trace
   that names the K1, K2 and K3 ``sm90`` kernels and Delta; the heartbeat
   files end at step 34.  Printed: detect latency, time to recover,
   drain latency, each boot's time to its first heartbeat and to its
   first step, the heartbeats' largest gaps, the step with the planes on
   against the same run's with them off, and steps inside the capture.
   Then the read side over the drill's run dir, through the port's CLI:
   ``obs goodput --json`` (the buckets sum to wall within 5%, restart
   downtime > 0 and the kill's incident carries downtime), ``obs
   postmortem`` for the kill's incident (the bundle written, naming that
   incident and rank 0 as the failed host), ``trace critpath`` (a step's
   compute attributed) and ``trace export`` (a Chrome trace that parses);
   printed: the run's wall time by goodput bucket.
14. ``planes_llama3_1b``: the launch planes at llama3-1b width (2
   layers), in subprocesses, with the kernel directory emptied (the build
   phase's libraries set aside and put back after).  (a) ``create-stack
   --accelerator h100-1``, ``launch --compile-cache --compile-cache-dir
   D`` (no ``--ft``), the example for 3 steps: every library the
   training step loads (K1, Delta, K2 and K3 ``sm90``) built once with
   ``nvcc`` and published (the rank's compiles, publishes and nvcc runs
   4, fetches 0), three finite losses.  (b) ``create-stack
   --accelerator h100-2``, the kernel directory emptied again, ``launch
   --ft --supervise --compile-cache`` on the same D with ``--input-hosts
   1 --input-cmd "python -m tpucfn_torch.cli data serve ..."`` and a
   ``--chaos-proxy`` in front of the input port, which the trainer
   dials (``TPUCFN_INPUT_ADDRS`` set on its command); the ``--chaos``
   spec paces the proxy's link at 1.5x the trainer's batch rate, then
   trickles it at fleet step 3, then kills the coordinator at fleet step
   30.  Gates: rc 0; all 4 libraries fetched, none built, no ``nvcc``;
   the supervisor restarted the coordinator once and it adopted the
   running rank (one launch, its pid in every heartbeat, no gang
   restart, no budget spent); the stream served batches until the
   trickle and degraded to local loading at the exact cursor within 10 s
   of it and before the kill; the 34 losses within 1e-3 relative of the
   uninterrupted run; every step 4/2/2/2 K1/K2/K3 ``sm90``/Delta
   launches.  Printed: time_to_first_step cold and warm, the build
   seconds against the fetch seconds, data wait served and local, the
   degrade latency and batch, the coordinator's downtime.
15. ``provision_llama3_1b``: the provisioner policy loop, in
   subprocesses: ``create-stack --accelerator h100-2``, then ``launch
   --ft --input-hosts 1 --input-cmd "python -m tpucfn_torch.cli data
   serve ..." --provision-policy goodput --provision-interval 1
   --provision-cooldown 300 --provision-shrink-threshold 0.1`` runs the
   2-layer example (34 steps, no checkpoint write before the end) fed by
   the input host.  Gates: rc 0; exactly one ``provision_decision``, a
   ``data_rich`` shrink at a ``data_wait`` share under 0.1; ``provision_shrink_total`` 1 and
   ``provision_grow_total`` 0; one launch, no gang restart, budget 0;
   the stream degrades to local loading once, after the shrink; the 34
   losses within 1e-3 relative of the uninterrupted run; every step
   4/2/2/2 K1/K2/K3 ``sm90``/Delta launches; ``obs goodput`` buckets sum
   to wall within 5%.  Printed: the step, compile, data_wait and ckpt
   shares of wall before and after the shrink.
16. ``train_unet_sd15``: the port's SD-1.5 example
   (``tpucfn_torch/examples/sd15_unet.py``) through its ``main(argv)``:
   ``UNetConfig.sd15()`` at 64x64x4 latents, a 77 x 768 context, batch
   2, fp32 params, EMA 0.9999, 6 steps on one repeated batch.  Gates:
   finite losses; every step exactly 32 K1, 32 K2, 32 K3 and 32 Delta
   launches, all on ``sm90``: 10 at head dim 40, 10 at 80 and 12 at 160
   (the five transformer blocks of each of the 64x64, 32x32 and 16x16
   stages and the middle block's one, a self- and a cross-attention
   each); peak memory under 80 GB; at the same params (the output
   convolution drawn small), batch, t and noise, the loss within 0.02 and
   every gradient at cosine >= 0.99 of the plain attention path (plain
   in every stage where the kernel path runs the kernels).  Printed: step
   time, images/s, a profiled step's device time by kernel and by class
   (convolution, flash attention, matmul, norm, optimizer).  Then the
   tiny fp32 UNet at 16x16, kernel
   path against plain path over 6 AdamW steps: losses within 1e-4,
   every K1, K2 and K3 launch on ``mma``, at head dims 16 and 32.
17. ``train_bert_base``: the port's BERT example
   (``tpucfn_torch/examples/bert_base.py``): ``BertConfig.base()``, seq
   128, batch 32, 10 steps on one repeated batch.  Gates: finite losses,
   the last below the first, and no K1, K2, K3 or Delta launch (its
   masked attention is dense, as in the JAX package).  Printed: step
   time, tokens/s, peak memory.
18. ``train_moe_llama3_1b``: the reference example's ``--model 1b
   --moe-experts 8`` through ``Trainer``: llama3-1b's widths with 8
   experts (top-2, capacity factor 1.25: 1280 rows an expert) in each of
   4 of its 16 layers (2.18 B parameters), 2 x 2048 tokens, remat,
   chunked CE with z-loss and the MoE aux loss, 4 steps on one batch.
   Gates: 4 finite losses, the last below the first; per step exactly
   8/4/4/4 K1/K2/K3/Delta launches, all on ``sm90``; loss within 0.02
   and every gradient at cosine >= 0.99 of the plain attention path;
   the tiny preset with 4 experts in fp32 within 1e-4 of its plain path
   over 6 steps, every K1, K2 and K3 launch on ``mma``.  Printed: the
   dropped fraction, the share of routing decisions that differ from
   the plain path's, step time, tokens/s, MFU by ``train_step_flops``,
   peak memory, and a profiled step's device time by the op that
   launched each kernel (expert GEMMs, dispatch, flash kernels, the LM
   head, the other GEMMs, the optimizer).
19. ``serve_mixtral_8x7b``: a Mixtral-8x7B-v0.1-shaped model (hidden
   4096, intermediate 14336, 32 heads, 8 KV heads, D = 128, vocab 32000,
   8 experts, top-2, rope theta 1e6) at 4 of its 32 layers (6.07 B
   parameters), its HF-named bf16 state dict drawn from a seed on the
   card and imported by ``tpucfn_torch.models.hf_convert`` (capacity
   factor E/k: dropless), served through ``ServeEngine.from_llama`` and
   ``Server`` (8 slots, 6 prompts of 64-512 tokens, 16 new).  Gates:
   every request completes, no KV block leaks; every prefill on K1
   ``sm90`` and every decode on K1 ``decode``, all at D = 128; every
   greedy token is the plain model's teacher-forced argmax or a near-tie
   there (top-2 gap < 0.25); K1 at the prefill shape (4 x 512, GQA 4)
   and at the run's decode offsets within tolerance of its plain
   version.  Printed: a decode step's device time beside the time the
   card needs to read every weight (the ragged dispatch multiplies every
   expert), TTFT, TPOT.
20. ``lora_llama3_1b``: rank-8 LoRA adapters on the default targets of
   llama3-1b at full width and depth (the base frozen in the state's
   ``model_state``), 4 steps at 2 x 2048 through ``Trainer``.  Gates:
   32/16/16/16 launches a step on ``sm90``; losses falling; only the
   adapters have optimizer state; every adapter gradient at cosine >=
   0.99 of the plain path; ``ServeEngine.from_llama(...,
   lora_adapters=trained)`` gives the same greedy tokens as an engine
   over ``lora_materialize(base, trained)``, and different ones from the
   base's.
21. ``train_resnet50_imagenet``: the port's ImageNet example
   (``tpucfn_torch/examples/imagenet_resnet50.py``) through its
   ``main(argv)``: ResNet-50 at 224, batch 128, 256 synthetic images, 12
   steps, no checkpoint, cuDNN's own algorithm choice (no autotuning).
   Gates: 12 finite losses, no flash launch, peak
   under 80 GB; after two SGD steps the bf16 ``channels_last`` model
   against fp32 at the same params and batch, loss within 0.02, all
   gradients together at cosine >= 0.99 and each at >= 0.93 (beside the
   worst, its floor: the fp32 model with only its activations rounded to
   bf16); ``bn_stem``'s running statistics after one step equal 0.9 x the
   fresh ones + 0.1 x the stem output's mean and biased variance within
   1e-3.  Printed: steady step (steps 3-12), images/s, MFU by
   ``resnet_train_flops``, peak, data wait, a profiled step's device time
   by class (convolution, norm, elementwise, optimizer, other).
22. ``train_resnet20_cifar``: the port's CIFAR example
   (``tpucfn_torch/examples/cifar10_resnet20.py``): batch 128, 30 steps
   with augmentation, an eval every 10 over a synthetic split.  Gates:
   finite losses, the mean of the last 5 below the first 5's, evals at
   10, 20 and 30, and an eval step equal to the model over the running
   statistics (and not over fresh ones).
23. ``train_llama3_1b_remat``: llama3-1b at full width and depth, one
   batch of 2 x 2048, four steps under each of full remat, ``dots``,
   ``dots_no_batch`` and none, from the same init.  Gates: every step
   32/16/16/16 K1/K2/K3/Delta launches on ``sm90`` (none: 16/16/16/16);
   the first loss and the loss at init within 1e-5 relative and every
   gradient at cosine >= 0.9999 of full remat's; the steps' peak and the
   forward+backward's peak ordered none >= dots >= dots_no_batch >=
   full; the backward's ``mm`` count (a ``TorchDispatchMode``) equal
   under dots, dots_no_batch and none, and larger under full.  Printed:
   step time and peaks per policy, a profiled step under full and dots.
24. ``rl_anakin``: the RL plane (``tpucfn_torch.rl``) on the card, no
   flash kernel launched in the whole phase.  In this process: the bandit
   at ``rl train``'s defaults (8 envs, unroll 16, hidden 64) for 60
   iterations, twice with one seed (rows bit-identical, every one finite)
   and once with another (rows differ); the reference's learning gate (lr
   5e-2, 40 updates, the mean edge over the uniform policy of the last 10
   above the first 10's by 0.05 and above 0.1); a bandit and a gridworld
   rollout under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   sync in acting), and the actors' params unchanged by the learner step
   after it.  Then the chaos drill of the reference (``tests/
   test_rl_e2e.py``): ``create-stack --accelerator h100-1``, ``launch
   --ft --ft-restart-budget 1 --chaos`` (host 0 killed at fleet iteration
   12) over ``python -m tpucfn_torch.cli rl train --env gridworld
   --unroll 8 --iters 30 --ckpt-every 5 --iter-sleep-s 0.05`` in
   subprocesses.  Gates: rc 0, the kill fired, exactly one unplanned gang
   restart, two pids in the rows, ``rl_run_start`` and an ``rl_resumed``
   from a save at a multiple of 5 (>= 5), rows 1-30 bit-equal to an
   uninterrupted ``rl train`` run in this process, ``obs goodput`` with
   ``act``, ``learn`` and ``refresh`` > 0 and the buckets summing to
   wall within 5%.  Printed: the median ``act``, ``learn`` and
   ``refresh`` ms of the 60-iteration run and its env steps/s.
25. ``input_native``: the native tpurecord reader
   (``tpucfn_torch/data/native.py``), built from the checkout with
   ``g++`` at first use, on 256 ImageNet-shaped records in 4 shards
   staged as the ResNet-50 example stages them.  Gates: it loads; it and
   the Python reader give identical records; ``ShardedDataset`` reports
   the native reader; a flipped byte raises its CRC error and a
   truncated shard its truncation error.  Printed: both readers'
   records/s (best of three passes, warm page cache).
26. ``ring_llama3_1b``: ring attention (``tpucfn_torch.kernels.
   ring_attention``) at llama3-1b's attention shape (32 heads, 8 KV heads,
   D = 64, one row).  One card holds no two NCCL ranks, so the ring runs
   in this process: the port's hop loop (``ring_hops``) for each of W
   virtual ranks, handed at each step the K/V block the neighbour
   exchange would bring; autograd takes the gradients back to the
   blocks.  Cases, forward and backward: S = 32768 over 8 ranks (4096 a
   block), bf16, against one full-sequence ``flash_attention_with_lse``
   call; S = 8192 over 4 in fp32 (``mma``) and in bf16 (``sm90``), and
   non-causal in bf16, each against the same ring with dense hops.
   Gates: out, dQ, dK and dV within ``BWD_REL_TOL`` of each reference's
   largest magnitude; K1, K2, K3 and Delta launched exactly W(W+1)/2
   times by a causal ring (36 at W = 8: future blocks launch nothing)
   and W^2 by a non-causal one, all on the dtype's variant.  Printed:
   each ring's time beside the full call's (CUDA events around a call,
   and the kernels' device time of a profiled call).
   Then K1, Delta, K2 and K3 at the diagonal hop's shape (causal, 4096
   queries over 4096 keys) and a past hop's (non-causal, with dLSE),
   each against its plain version, rows beside the kernel phases'.

The runs whose gates read no checkpoint written in them save none
(``_SaveOnly`` in this process, ``NO_SAVE_EXAMPLE`` as a subprocess job):
the uninterrupted 2-layer run, the example's full run past its first
save, its resume around the one save it restores, the planes drill's
cold leg, the UNet and the ResNets.  The ft drill, the planes drill's warm leg and
the provisioner drill save as they did: the warm leg's final save keeps
its rank alive through the coordinator's restart, and the provisioner's
first save call dilutes the ledger's early ``data_wait`` share, so the
shrink comes early enough for the degrade to land inside the run.

The ``kernel`` and ``kernel_bwd`` phases also hold the head dims 32, 40,
80 and 160 (``_head_dim_cases``): every attention call of the UNet at
batch 2 and 8 heads (the 64x64 stage's at D = 40, 4096 queries over 4096
and 77 keys; the 32x32 stage's at 80, 1024 over 1024 and 77; the 16x16
stage's and the middle block's at 160, 256 over 256 and 77 and 64 over
64 and 77) on ``sm90``; D = 32, 40, 80 and 160 with causality, offsets
and GQA on ``sm90``, fp32 at each on ``mma``, a GQA group of 3 at 40, 80
and 160 (bf16 ``mma``) and a bf16 call of 16 rows at each, which lands
on ``mma``.

Then a ``{"kernels": [...]}`` line (one entry per kernel variant with
the head dims it is built for, each launched on a path above, and the
old fma kernels of K1, K2 and K3, which no path reaches, with their
times from the turns) and, last, ``{"ok": true, "device": {...}}``.
``--phases device,build,kernel`` (any subset) gives a partial run that
prints no result line.  Any failed phase exits non-zero before that
line.  Without a CUDA device, or without the package beside it, the
script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
PHASES = ("device", "build", "kernel", "kernel_bwd", "serve_llama3_1b",
          "serve_tiny_fp32", "serve_spec_llama3_1b", "serve_router_llama3_1b",
          "serve_cli_llama3_1b", "train_llama3_1b", "train_tiny_fp32",
          "example_llama3_1b", "ft_llama3_1b", "planes_llama3_1b",
          "provision_llama3_1b", "train_unet_sd15", "train_bert_base",
          "train_moe_llama3_1b", "serve_mixtral_8x7b", "lora_llama3_1b",
          "train_resnet50_imagenet", "train_resnet20_cifar",
          "train_llama3_1b_remat", "rl_anakin", "input_native",
          "ring_llama3_1b")
# tpucfn_torch/kernels/csrc/<name>.cu
SOURCES = ("flash_fwd", "flash_fwd_sm90", "flash_fwd_decode_sm90",
           "flash_fwd_mma_sm90", "flash_bwd", "flash_bwd_dq_sm90",
           "flash_bwd_dq_mma_sm90", "flash_bwd_dkv_sm90",
           "flash_bwd_dkv_mma_sm90")

# NVIDIA H100 SXM published peaks (dense), at the full 700 W limit.  An
# fp32 product is bounded by the FMA units (67 TFLOP/s), except in the mma
# variants, which run it as 3xTF32: three TF32 products (495 TFLOP/s) for
# each fp32 one, so 495 / 3.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12,
              "3xtf32": 495e12 / 3}


def _peak_flops(dtype, variant):
    """The ops peak a kernel's bound is taken against."""
    if str(dtype) == "torch.float32" and variant == "mma":
        return PEAK_FLOPS["3xtf32"]
    return PEAK_FLOPS[str(dtype)]


def _bound(bytes_, flops, peak_flops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over ``peak_flops``."""
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_flops = flops / peak_flops * 1e3
    return {"bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}

# K1 against its plain version.  bf16: both round P to bf16 before the PV
# product (the plain version as the JAX dense path does, the sm90, decode
# and mma kernels as the A operand of their products, though of
# exp(S - running max) rather than of the normalized P) while the old fma
# kernel keeps P in fp32, so O
# differs by up to ~2^-9 * max|v| plus the output's own bf16 rounding;
# LSE is fp32 on both sides (sum order only).  fp32: sum order, and in the
# mma variant 3xTF32's dropped small x small terms (~2^-22 relative).
TOL = {"torch.bfloat16": {"o": 2e-2, "lse": 1e-3},
       "torch.float32": {"o": 2e-5, "lse": 2e-5}}
# Teacher-forced llama3-1b logits, kernel path vs plain path (bf16): the
# P rounding above, carried through 16 layers of bf16 activations.
LOGITS_TOL_BF16 = 0.25
# The serving phase's requests: prompt lengths, then two prompts of a
# shared 64-token prefix and their own tails, and tokens generated each.
SERVE_LENGTHS, SERVE_SHARED, SERVE_TAILS = (16, 48, 100, 200, 333, 512), 64, (40, 150)
SERVE_MAX_NEW = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # noqa: BLE001 — report the phase, then stop
            traceback.print_exc()
            emit({"phase": name, "ok": False,
                  "seconds": round(time.perf_counter() - t0, 3)})
            self.failed.append(name)
            return None
        emit({"phase": name, "ok": True,
              "seconds": round(time.perf_counter() - t0, 3), **(out or {})})
        return out


# ---- phase 1 ---------------------------------------------------------------
def phase_device(results):
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    results["card"] = smi[0] if smi else None
    return {"name": torch.cuda.get_device_name(0),
            "nvidia_smi": smi[0] if smi else None,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}


# ---- phase 2 ---------------------------------------------------------------
def phase_build():
    from tpucfn_torch.kernels import _build

    logs = _build.build(*SOURCES)  # one nvcc per source, all at once
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    libs = [_build.library_path(name) for name in SOURCES if _build.load(name)]
    bad = _unwritten_uniform_reads(_build._nvcc(), libs)
    if bad:
        raise AssertionError(f"cp.async reads unwritten uniform registers: {bad}")
    usage = _ptxas_usage(logs, WIDE_HEAD_DIMS)
    for name, row in sorted(usage.items()):
        print(f"ptxas {name}: {row.get('registers')} registers, "
              f"{row.get('spill_stores')} / {row.get('spill_loads')} bytes "
              "spilled (stores / loads)", flush=True)
    # K1, K2 and K3 sm90 at D = 160: a wgmma accumulator that spills is
    # serialized, so their designs keep every accumulator in registers.
    spilled = {n: r for n, r in usage.items() if "_sm90_kernel" in n
               and n.endswith(",160>")
               and r.get("spill_stores", 0) + r.get("spill_loads", 0)}
    if spilled:
        raise AssertionError(f"sm90 kernels at D = 160 spill: {spilled}")
    return {"built": sorted(logs),
            "libraries": [str(lib.relative_to(HERE)) for lib in libs],
            "cp_async_unwritten_uniform_reads": bad,
            "ptxas_at_head_dims": {"head_dims": list(WIDE_HEAD_DIMS),
                                   "kernels": usage}}


# Head dims whose ptxas register and spill report the build phase prints.
WIDE_HEAD_DIMS = (80, 160)


def _ptxas_usage(logs, head_dims):
    """From ``nvcc -Xptxas -v`` output ({source: log}): each kernel
    instantiation at one of ``head_dims`` as ``"<kernel><dtype,D>"``
    (dtype ``bf16``, ``fp32`` or ``-`` for the bf16-only sm90 kernels) ->
    registers a thread, spill stores and loads and stack frame in bytes.
    A library loaded without a build in this run has no log and no rows."""
    import re

    # the kernel's name follows its file's anonymous-namespace prefix
    name_re = re.compile(r"(\w+?_kernel)I(.*?)Li(\d+)E")
    out = {}
    for log in logs.values():
        current = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                k = name_re.search(m.group(1))
                current = None
                if k and int(k.group(3)) in head_dims:
                    dtype = ("bf16" if "bfloat16" in k.group(2) else "fp32"
                             if k.group(2) == "f" else "-")
                    kernel = k.group(1)[k.group(1).rindex("flash_"):]
                    current = f"{kernel}<{dtype},{k.group(3)}>"
                    out[current] = {}
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                out[current].update(stack=int(m.group(1)),
                                    spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[current]["registers"] = int(m.group(1))
                current = None
    return out


def _unwritten_uniform_reads(nvcc, libs):
    """The cp.async copies (SASS ``LDGSTS``) of each built kernel that read
    a uniform register no instruction of their function writes: {library:
    {function: count}}, empty when there are none.  ptxas (CUDA 12.9)
    emitted such copies for L2-hinted cp.async in K3 mma's fp32 D=16
    instantiations at some key blocks and optimisation levels, and they
    fault on the card with "illegal instruction" when they run, which only
    some shapes reach."""
    import re

    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    procs = {lib.name: subprocess.Popen([cuobjdump, "-sass", str(lib)],
                                        stdout=subprocess.PIPE, text=True)
             for lib in libs}
    bad = {}
    for lib, proc in procs.items():
        sass = proc.communicate(timeout=300)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"cuobjdump -sass {lib}: exit {proc.returncode}")
        for func in re.split(r"\n\s*Function : ", sass)[1:]:
            written, reads = set(), []
            for ins in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", func):
                ins = re.sub(r"^@!?U?P\w+\s+", "", ins)
                op, _, args = ins.partition(" ")
                dst = re.match(r"UR(\d+)\b", args)
                if dst:  # a .64 or .WIDE result takes the next one too
                    width = 2 if (".64" in op or ".WIDE" in op) else 1
                    written.update(range(int(dst[1]), int(dst[1]) + width))
                if op.startswith("LDGSTS"):
                    reads += [int(r) for r in re.findall(r"\+UR(\d+)", args)]
                    reads += [int(r) + i for r in re.findall(r"desc\[UR(\d+)\]", args)
                              for i in (0, 1)]
            n = sum(r not in written for r in reads)
            if n:
                bad.setdefault(lib, {})[func.split()[0]] = n
    return bad


# ---- phase 3 ---------------------------------------------------------------
class Timer:
    """Mean device time of one call in ms: CUDA events around each call,
    with the L2 cache flushed before each (a serving layer meets its K/V
    cold) by writing 64 MB, which leaves L2 full of dirty lines; ``clean``
    flushes by reading them instead.  The calls are queued behind a
    sleeping kernel, so the events time the device's work and not the
    host's Python around the launch."""

    def __init__(self, torch, clean=False):
        self.torch, self.clean = torch, clean
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=30, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(100_000_000)  # ~50 ms: the host queues meanwhile
        for a, b in marks:
            if self.clean:
                self.flush.sum()
            else:
                self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in marks) / iters


def _spread(n, top):
    """n offsets spread evenly over 0..top, both ends included."""
    return [round(i * top / (n - 1)) for i in range(n)]


def _kernel_cases(torch):
    """(label, kwargs for the inputs) at the serving and training paths'
    shapes and the edge cases."""
    bf, f32 = torch.bfloat16, torch.float32
    sk = 2048  # llama3-1b serving cache_len
    decode_off = _spread(8, sk - 1)
    cases = [("decode_llama3_1b", dict(b=8, h=32, hkv=8, d=64, sq=1, sk=sk,
                                       dtype=bf, q_offset=decode_off)),
             # the decode variant at llama3-8b's width over an 8192-key cache
             ("decode_llama3_8b", dict(b=8, h=32, hkv=8, d=128, sq=1,
                                       sk=8192, dtype=bf,
                                       q_offset=_spread(8, 8191))),
             ("decode_gqa3", dict(b=4, h=6, hkv=2, d=64, sq=1, sk=512,
                                  dtype=bf, q_offset=_spread(4, 511))),
             ("decode_d16", dict(b=4, h=4, hkv=2, d=16, sq=1, sk=128,
                                 dtype=bf, q_offset=_spread(4, 127))),
             ("decode_segment_ids", dict(b=8, h=32, hkv=8, d=64, sq=1,
                                         sk=sk, dtype=bf, q_offset=decode_off,
                                         segments=True)),
             # k_offset past three rows' query: O = 0, LSE = NEG_INF there
             ("decode_empty_rows", dict(b=4, h=32, hkv=8, d=64, sq=1, sk=256,
                                        dtype=bf, q_offset=[0, 10, 50, 200],
                                        k_offset=60)),
             ("decode_non_causal", dict(b=4, h=32, hkv=8, d=64, sq=1,
                                        sk=1000, dtype=bf,
                                        q_offset=[0, 0, 0, 0], causal=False)),
             # 4 positions x a group of 4: 16 packed rows, one mma tile
             ("decode_sq4_gqa4", dict(b=8, h=32, hkv=8, d=64, sq=4, sk=sk,
                                      dtype=bf, q_offset=_spread(8, sk - 4))),
             # speculative-decoding verify passes (width 1 + k, k = 4 and
             # 8, at GQA 4: 20 and 36 packed rows) on the mma variant
             ("verify_sq5_gqa4", dict(b=8, h=32, hkv=8, d=64, sq=5, sk=sk,
                                      dtype=bf, q_offset=_spread(8, sk - 5))),
             ("verify_sq9_gqa4", dict(b=8, h=32, hkv=8, d=64, sq=9, sk=sk,
                                      dtype=bf, q_offset=_spread(8, sk - 9)))]
    for sq in (16, 128, 512):
        cases.append((f"prefill_llama3_1b_sq{sq}",
                      dict(b=4, h=32, hkv=8, d=64, sq=sq, sk=sk, dtype=bf,
                           q_offset=[0, 0, 300, sk - sq])))
    cases.append(("train_llama3_1b", dict(b=2, h=32, hkv=8, d=64, sq=sk,
                                          sk=sk, dtype=bf, q_offset=[0, 0])))
    cases += [
        ("tiny_fp32_d16_gqa2", dict(b=2, h=4, hkv=2, d=16, sq=64, sk=64,
                                    dtype=f32, q_offset=[0, 0])),
        ("bf16_d16_gqa2", dict(b=2, h=4, hkv=2, d=16, sq=64, sk=64, dtype=bf,
                               q_offset=[0, 0])),
        ("empty_rows_k_offset", dict(b=2, h=4, hkv=4, d=64, sq=128, sk=128,
                                     dtype=bf, q_offset=[0, 0], k_offset=40)),
        ("segment_ids", dict(b=2, h=8, hkv=2, d=64, sq=256, sk=256, dtype=bf,
                             q_offset=[0, 0], segments=True)),
        ("non_causal_d128_ragged", dict(b=2, h=8, hkv=8, d=128, sq=200,
                                        sk=300, dtype=bf, q_offset=[0, 0],
                                        causal=False)),
        ("fp32_d128_two_chunk_tiles", dict(b=2, h=8, hkv=4, d=128, sq=96,
                                           sk=160, dtype=f32,
                                           q_offset=[0, 64])),
        ("bf16_d128_ragged_q_offset", dict(b=2, h=8, hkv=4, d=128, sq=96,
                                           sk=160, dtype=bf,
                                           q_offset=[0, 64])),
        # a GQA group of 3 does not divide the 64-row tile: mma in bf16
        ("bf16_gqa3", dict(b=2, h=6, hkv=2, d=64, sq=64, sk=128, dtype=bf,
                           q_offset=[0, 32])),
    ]
    for label, kw, _ in _head_dim_cases(torch):
        kw = dict(kw)
        kw["q_offset"] = [kw.get("q_offset", 0)] * kw["b"]
        cases.append((label, kw))
    return cases


def _head_dim_cases(torch):
    """The head dims 32, 40, 80 and 160 (D = 40, 80 and 160 on zero-padded
    tiles of 64, 128 and 192 columns in sm90; D = 40 on a 48-column one in
    bf16 mma, 80 and 160 on padded rows): every attention call of the
    SD-1.5 UNet at batch 2 and 8 heads (the 64x64 stage at D = 40, 4096
    positions; the 32x32 stage at 80, 1024; the 16x16 stage at 160, 256,
    and the middle block at 160, 64; each a self-attention and a
    cross-attention over the 77-token context), D = 32 in bf16 with
    causality, offsets and GQA, D = 40, 80 and 160 likewise, fp32 at each
    on mma, a GQA group of 3 at 40, 80 and 160 (bf16 mma), and, for K1
    only, a bf16 call of 16 rows at each of 40, 80 and 160, which the
    decode variant lacks (mma).  Each entry: (label, kwargs, forward
    only)."""
    bf, f32 = torch.bfloat16, torch.float32
    unet = [(f"unet_{name}_d{d}", dict(b=2, h=8, hkv=8, d=d, sq=sq, sk=sk,
                                       dtype=bf, causal=False), False)
            for name, d, sq, sk in (
                ("self", 80, 1024, 1024), ("cross", 80, 1024, 77),
                ("self", 160, 256, 256), ("cross", 160, 256, 77),
                ("mid_self", 160, 64, 64), ("mid_cross", 160, 64, 77))]
    wide = []
    for d in (80, 160):
        wide += [
            (f"bf16_d{d}_gqa2_ragged", dict(b=2, h=8, hkv=4, d=d, sq=200,
                                            sk=300, dtype=bf, q_offset=64),
             False),
            (f"bf16_d{d}_gqa3", dict(b=2, h=6, hkv=2, d=d, sq=64, sk=128,
                                     dtype=bf, q_offset=32), False),
            (f"bf16_d{d}_16_rows", dict(b=2, h=8, hkv=8, d=d, sq=16, sk=77,
                                        dtype=bf, causal=False), True)]
    wide += [
        ("fp32_d80_cross", dict(b=2, h=8, hkv=8, d=80, sq=256, sk=77,
                                dtype=f32, causal=False), False),
        ("fp32_d160_gqa2", dict(b=2, h=4, hkv=2, d=160, sq=64, sk=96,
                                dtype=f32, q_offset=32), False)]
    return unet + wide + [
        ("unet_self_d40", dict(b=2, h=8, hkv=8, d=40, sq=4096, sk=4096,
                               dtype=bf, causal=False), False),
        ("unet_cross_d40", dict(b=2, h=8, hkv=8, d=40, sq=4096, sk=77,
                                dtype=bf, causal=False), False),
        ("bf16_d32_gqa2_ragged", dict(b=2, h=8, hkv=4, d=32, sq=200, sk=300,
                                      dtype=bf, q_offset=64), False),
        ("bf16_d40_gqa2_ragged", dict(b=2, h=8, hkv=4, d=40, sq=200, sk=300,
                                      dtype=bf, q_offset=64), False),
        ("fp32_d32_gqa2", dict(b=2, h=4, hkv=2, d=32, sq=64, sk=96,
                               dtype=f32, q_offset=32), False),
        ("fp32_d40_cross", dict(b=2, h=8, hkv=8, d=40, sq=256, sk=77,
                                dtype=f32, causal=False), False),
        ("bf16_d40_gqa3", dict(b=2, h=6, hkv=2, d=40, sq=64, sk=128,
                               dtype=bf, q_offset=32), False),
        ("bf16_d40_16_rows", dict(b=2, h=8, hkv=8, d=40, sq=16, sk=77,
                                  dtype=bf, causal=False), True),
    ]


def _in_turns(timer, call, attr, values):
    """``call`` timed with ``fa.<attr>`` (a variant rule or a planner
    constant) set to each of ``values`` in turn, restored after each:
    ({value: [ms, ...]}, {value: the call's last output})."""
    from tpucfn_torch.kernels import flash_attention as fa

    kept = getattr(fa, attr)
    times, outs = {}, {}
    for value in values:
        setattr(fa, attr, (lambda *a, _v=value: _v) if callable(kept)
                else value)
        try:
            times.setdefault(value, []).append(timer(call))
            outs[value] = call()
        finally:
            setattr(fa, attr, kept)
    return times, outs


def _one_case(torch, timer, label, b, h, hkv, d, sq, sk, dtype, q_offset,
              k_offset=0, causal=True, segments=False, seg_ids=None):
    """``seg_ids``: (B, S) segment ids for queries and keys alike (a packed
    batch's), in place of the 48-position documents of ``segments``."""
    import torch.nn.functional as F

    from tpucfn_torch.kernels import flash_attention as fa
    from tpucfn_torch.ops.attention import (NEG_INF,
                                            dot_product_attention_with_lse)

    g = torch.Generator("cuda").manual_seed(len(label))
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    q_off = torch.tensor(q_offset, dtype=torch.int32, device="cuda")
    q_seg = kv_seg = mask = None
    if seg_ids is not None:
        segments = True
        q_seg = kv_seg = seg_ids.to("cuda", torch.int32).contiguous()
        mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
    elif segments:  # documents of 48 positions, by global position
        q_seg = ((q_off[:, None] + torch.arange(sq, device="cuda")) // 48).int()
        kv_seg = ((torch.arange(sk, device="cuda") + k_offset) // 48).int()[None].expand(b, sk).contiguous()
        mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :])

    def kernel():
        return fa.flash_fwd(q, k, v, causal=causal, q_offset=q_off,
                            k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg)

    def plain():
        return dot_product_attention_with_lse(
            q, k, v, causal=causal, mask=mask, q_offset=q_off,
            k_offset=k_offset)

    before = dict(fa.flash_fwd.launches_by_variant)
    o, lse = kernel()
    torch.cuda.synchronize()
    (variant,) = [k for k, n in fa.flash_fwd.launches_by_variant.items()
                  if n != before[k]]
    assert variant == fa.fwd_variant(dtype, sq, h, hkv, d), variant
    ro, rlse = plain()
    rlse = rlse.transpose(1, 2)
    tol = TOL[str(dtype)]
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    finite = bool(torch.isfinite(o).all() and torch.isfinite(lse).all())
    # Live (query, key) pairs of these inputs: the work the function needs.
    qpos = q_off.long()[:, None] + torch.arange(sq, device="cuda")[None]
    kpos = torch.arange(sk, device="cuda") + k_offset
    live = torch.ones(b, sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        live &= qpos[:, :, None] >= kpos[None, None, :]
    if mask is not None:
        live &= mask[:, 0]
    empty = ~live.any(-1)  # (B, Sq) rows attending to nothing
    empty_ok = bool((o.float()[empty] == 0).all()
                    and (lse.transpose(1, 2)[empty] == NEG_INF).all())
    ok = err_o <= tol["o"] and err_lse <= tol["lse"] and finite and empty_ok

    # Library yardstick: SDPA over (B, H, S, D), KV heads repeated and the
    # mask built beforehand (outside the timed call); a plain causal square
    # case passes is_causal instead, which lets SDPA take its flash backend.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt = kt.repeat_interleave(h // hkv, dim=1)
    vt = vt.repeat_interleave(h // hkv, dim=1)
    plain_causal = causal and not segments and k_offset == 0 \
        and not any(q_offset) and sq == sk
    lib_mask = None if plain_causal else live[:, None]

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=lib_mask, is_causal=plain_causal)

    iters = 10 if sq * sk > 1 << 20 else 30  # as the backward's cases
    ms = timer(kernel, iters=iters)
    plain_ms = timer(plain, iters=iters)
    library_ms = timer(library, iters=iters)
    host_us = _host_us(torch, kernel)
    esize = torch.finfo(dtype).bits // 8
    keys_needed = live.any(1).sum(-1)  # (B,) keys any query row of b sees
    bytes_ = (q.numel() * esize * 2                       # q in, o out
              + int(keys_needed.sum()) * hkv * d * esize * 2   # K and V
              + b * h * sq * 4 + b * 4                    # lse out, offsets
              + (b * (sq + sk) * 4 if segments else 0))
    flops = 4 * d * h * int(live.sum())  # QK^T and PV, 2 flops per MAC
    beside = {}
    if variant == "mma" and d in fa.VARIANT_HEAD_DIMS["fma"]:
        # The old fma kernel (on no path now) beside mma, in turns, on
        # these inputs, held to the same tolerance; its bound is taken
        # against the FMA units' rate.
        times, outs = _in_turns(timer, kernel, "fwd_variant",
                                ("fma", "mma", "mma", "fma"))
        fo, flse = outs["fma"]
        fe = (fo.float() - ro.float()).abs().max().item()
        fl = (flse - rlse).abs().max().item()
        beside = {"fma_beside": {
            "fma_ms": times["fma"], "mma_ms": times["mma"],
            "max_abs_err": fe, "lse_max_abs_err": fl,
            "ok": fe <= tol["o"] and fl <= tol["lse"],
            **_bound(bytes_, flops, PEAK_FLOPS[str(dtype)])}}
        ok = ok and beside["fma_beside"]["ok"]
    elif variant == "decode":
        # The mma variant, which takes any row count, beside decode in
        # turns on these inputs, held to the same tolerance.
        times, outs = _in_turns(timer, kernel, "fwd_variant",
                                ("decode", "mma", "mma", "decode"))
        mo, mlse = outs["mma"]
        me = (mo.float() - ro.float()).abs().max().item()
        ml = (mlse - rlse).abs().max().item()
        beside = {"mma_beside": {
            "decode_ms": times["decode"], "mma_ms": times["mma"],
            "max_abs_err": me, "lse_max_abs_err": ml,
            "ok": me <= tol["o"] and ml <= tol["lse"]}}
        ok = ok and beside["mma_beside"]["ok"]
    return {"case": label, "variant": variant, **beside,
            "shape": dict(b=b, h=h, hkv=hkv, d=d, sq=sq, sk=sk,
                          dtype=str(dtype), causal=causal,
                          k_offset=k_offset, segments=segments),
            "ok": ok, "max_abs_err": err_o, "lse_max_abs_err": err_lse,
            "tol": tol, "finite": finite, "empty_rows": int(empty.sum()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            **_bound(bytes_, flops, _peak_flops(dtype, variant)),
            "bytes": bytes_, "flops": flops, "host_us": host_us}


def _host_us(torch, fn, calls=50):
    """Host time of one call in microseconds: ``calls`` calls back to
    back with no synchronise between them (the enqueue, which is what a
    host-bound decode step pays), after a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def _decode_fma_beside(torch, timer):
    """K1's fma kernel (the decode path before the decode variant) and the
    decode variant on the same llama3-1b decode inputs, both through
    ``flash_fwd`` (the variant rule overridden for the call), timed in
    turns (fma, decode, decode, fma): device ms and host us of each, and
    the largest difference between their outputs."""
    from tpucfn_torch.kernels import flash_attention as fa

    b, h, hkv, d, sk = 8, 32, 8, 64, 2048
    g = torch.Generator("cuda").manual_seed(7)
    q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
    q_off = torch.tensor(_spread(b, sk - 1), dtype=torch.int32, device="cuda")

    def call():
        return fa.flash_fwd(q, k, v, q_offset=q_off)[0]

    out, rule = {}, fa.fwd_variant
    for variant in ("fma", "decode", "decode", "fma"):
        fa.fwd_variant = lambda *a, _v=variant: _v
        try:
            out.setdefault(variant, []).append(
                (timer(call), _host_us(torch, call), call().float()))
        finally:
            fa.fwd_variant = rule
    return {f"{v}_{key}": [r[i] for r in out[v]]
            for v in out for i, key in ((0, "ms"), (1, "host_us"))} | {
        "o_max_abs_diff": (out["fma"][0][2] - out["decode"][0][2])
        .abs().max().item()}


def _decode_chunking(torch, timer):
    """Where the decode variant's time goes at llama3-1b's width (B=8,
    H=32, Hkv=8, D=64 over a 2048-key cache), by offsets: every row at
    one key, spread (``decode_llama3_1b``'s), the serving phase's mix (each
    request's prompt plus half its new tokens) and the full cache.  Each
    mix with the cache cut into 8 and 4 chunks (``DECODE_CLUSTER``, the
    planner's constant, set for the call) in turns (8, 4, 4, 8), and once
    with a clean L2; beside the timer's floor (a 4-byte memset between the
    same events)."""
    from tpucfn_torch.kernels import flash_attention as fa

    b, h, hkv, d, sk = 8, 32, 8, 64, 2048
    g = torch.Generator("cuda").manual_seed(5)
    q = torch.randn(b, 1, h, d, generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(torch.bfloat16)
    serve = [n + SERVE_MAX_NEW // 2 for n in SERVE_LENGTHS] + [
        SERVE_SHARED + n + SERVE_MAX_NEW // 2 for n in SERVE_TAILS]
    mixes = {"one_key": [0] * b, "spread": _spread(b, sk - 1),
             "serve": serve, "full": [sk - 1] * b}
    tiny = torch.empty(1, dtype=torch.int32, device="cuda")
    out, chosen = {"timer_floor_ms": timer(tiny.zero_)}, fa.DECODE_CLUSTER
    clean = Timer(torch, clean=True)
    for name, offsets in mixes.items():
        q_off = torch.tensor(offsets, dtype=torch.int32, device="cuda")
        row = {"offsets": offsets, "kv_bytes": (sum(offsets) + b) * hkv * d * 4}
        for n in (chosen, 4, 4, chosen):
            fa.DECODE_CLUSTER = n
            try:
                ms = timer(lambda: fa.flash_fwd(q, k, v, q_offset=q_off))
            finally:
                fa.DECODE_CLUSTER = chosen
            row.setdefault(f"ms_{n}_chunks", []).append(ms)
        row["ms_clean_l2"] = clean(lambda: fa.flash_fwd(q, k, v, q_offset=q_off))
        out[name] = row
    return out


def _fwd_mma_plans(torch, timer):
    """K1 mma's key chunks (``_mma_fwd_plan``) timed in turns (plan, other,
    other, plan) on the same inputs, at every ``mma`` shape of
    ``_kernel_cases``, against one chunk per row block where the plan
    splits the keys, else against the finest split (a chunk per tile, at
    most 8)."""
    from tpucfn_torch.kernels import flash_attention as fa

    out = {}
    for label, kw in _kernel_cases(torch):
        b, sq, h, hkv, d, sk, dtype = (kw[k] for k in (
            "b", "sq", "h", "hkv", "d", "sk", "dtype"))
        if fa.fwd_variant(dtype, sq, h, hkv, d) != "mma":
            continue
        g = torch.Generator("cuda").manual_seed(len(label))
        q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
        k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
        q_off = torch.tensor(kw["q_offset"], dtype=torch.int32, device="cuda")
        plan = fa._mma_fwd_plan(dtype, b, sq, h, hkv, d, sk)
        tile = fa._mma_keys(dtype, d)
        n_tiles = -(-sk // tile)
        per = 1 if plan[2] == 1 else n_tiles  # the other plan's tiles a chunk
        per = max(per, -(-n_tiles // fa.MMA_CLUSTER))
        other = (plan[0], tile * per, -(-n_tiles // per))
        if other == plan:
            continue
        times, _ = _in_turns(timer, lambda: fa.flash_fwd(q, k, k, q_offset=q_off),
                             "_mma_fwd_plan", (plan, other, other, plan))
        out[label] = {"plan": plan, "plan_ms": times[plan],
                      "other": other, "other_ms": times[other]}
    return out


def _decode_graph_check(torch):
    """One decode launch captured in a CUDA graph; the offsets, the query
    and the cache then change in place and the replay must match the
    plain version on the new values: the launch reads no device data on
    the host and its grid does not depend on the live lengths."""
    from tpucfn_torch.kernels import flash_attention as fa
    from tpucfn_torch.ops.attention import dot_product_attention_with_lse

    b, h, hkv, d, sk = 8, 32, 8, 64, 2048
    g = torch.Generator("cuda").manual_seed(11)

    def fill(t):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))

    q = torch.empty(b, 1, h, d, dtype=torch.bfloat16, device="cuda")
    k = torch.empty(b, sk, hkv, d, dtype=torch.bfloat16, device="cuda")
    v = torch.empty_like(k)
    for t in (q, k, v):
        fill(t)
    q_off = torch.tensor([3, 100, 700, 5, 2047, 64, 1000, 0],
                         dtype=torch.int32, device="cuda")
    fa.flash_fwd(q, k, v, q_offset=q_off)  # outside the capture: loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = fa.flash_fwd(q, k, v, q_offset=q_off)
    errs = []
    for offsets in ([2047, 0, 64, 1500, 3, 1999, 128, 640],
                    [1, 2, 3, 4, 2044, 2045, 2046, 2047]):
        q_off.copy_(torch.tensor(offsets, dtype=torch.int32))
        for t in (q, k, v):
            fill(t)
        graph.replay()
        torch.cuda.synchronize()
        ro, rlse = dot_product_attention_with_lse(q, k, v, q_offset=q_off)
        errs.append(((o.float() - ro.float()).abs().max().item(),
                     (lse - rlse.transpose(1, 2)).abs().max().item()))
    tol = TOL["torch.bfloat16"]
    ok = all(eo <= tol["o"] and el <= tol["lse"] for eo, el in errs)
    return {"ok": ok, "replays": len(errs),
            "max_abs_err": max(e[0] for e in errs),
            "lse_max_abs_err": max(e[1] for e in errs), "tol": tol}


def phase_kernel(results):
    import torch

    from tpucfn_torch.kernels import flash_attention as fa

    timer = Timer(torch)
    rows = []
    for label, kw in _kernel_cases(torch):
        row = _one_case(torch, timer, label, **kw)
        emit({"kernel_case": row})
        rows.append(row)
    results["kernel_rows"] = rows
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    missing = {"sm90", "mma", "decode"} - {r["variant"] for r in rows}
    if missing:
        raise AssertionError(f"no comparison launched the {missing} variant")
    beside = _decode_fma_beside(torch, timer)
    chunking = _decode_chunking(torch, timer)
    plans = _fwd_mma_plans(torch, timer)
    graph = _decode_graph_check(torch)
    if not graph["ok"]:
        raise AssertionError(f"the replayed decode graph disagrees: {graph}")
    return {"cases": len(rows),
            "worst_max_abs_err": max(r["max_abs_err"] for r in rows),
            "decode_llama3_1b_fma_beside": beside,
            "decode_chunking": chunking, "mma_plans": plans,
            "decode_graph": graph}


# ---- phase 4: the backward kernels -----------------------------------------
# K2, K3 and Delta against their plain versions on the same inputs (each
# kernel gets the inputs its plain version gets: Delta (o, dO); K2 and K3
# (q, k, v, dO, lse, Delta[, dLSE])).  All compute in fp32 and differ in
# sum order; bf16 outputs are then rounded once, so a bf16 result may sit
# one ulp (2^-8 relative) off.  Tolerances, as a fraction of the largest
# |reference| value of each tensor (dK and dV each against their own):
BWD_REL_TOL = {"torch.bfloat16": 1e-2, "torch.float32": 1e-4}


def _bwd_cases(torch):
    """(label, kwargs) at the training path's shape and the edge cases."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("train_llama3_1b", dict(b=2, h=32, hkv=8, d=64, sq=2048, sk=2048,
                                 dtype=bf)),
        ("fp32_d16_gqa2", dict(b=2, h=4, hkv=2, d=16, sq=64, sk=64,
                               dtype=f32)),
        ("bf16_d16_gqa2", dict(b=2, h=4, hkv=2, d=16, sq=64, sk=64,
                               dtype=bf)),
        ("fp32_d128_q_offset", dict(b=2, h=8, hkv=4, d=128, sq=96, sk=160,
                                    dtype=f32, q_offset=64)),
        ("bf16_d128_q_offset", dict(b=2, h=8, hkv=4, d=128, sq=96, sk=160,
                                    dtype=bf, q_offset=64)),
        ("segment_ids", dict(b=2, h=8, hkv=2, d=64, sq=256, sk=256, dtype=bf,
                             segments=True)),
        ("dlse_fp32", dict(b=2, h=8, hkv=2, d=64, sq=128, sk=128, dtype=f32,
                           dlse=True)),
        ("dlse_bf16", dict(b=2, h=8, hkv=2, d=64, sq=128, sk=128, dtype=bf,
                           dlse=True)),
        ("empty_rows_k_offset", dict(b=2, h=4, hkv=4, d=64, sq=128, sk=128,
                                     dtype=bf, k_offset=40)),
        ("non_causal_ragged_d128", dict(b=2, h=8, hkv=8, d=128, sq=200,
                                        sk=300, dtype=bf, causal=False)),
        # a GQA group of 3 does not divide the 64-row tile: K2 and K3 mma
        # in bf16
        ("bf16_gqa3", dict(b=2, h=6, hkv=2, d=64, sq=64, sk=128, dtype=bf,
                           q_offset=32)),
        # few rows over many keys, non-causal, with dLSE: 256 packed rows
        # per (batch row, KV head) walk 32 key tiles
        ("fp32_long_keys_dlse", dict(b=2, h=8, hkv=2, d=64, sq=64, sk=2048,
                                     dtype=f32, causal=False, dlse=True)),
        # the mma variants' masks together: GQA 3, segment ids by global
        # position, and the 40 positions before k_offset that see no key
        # (P = 0, dQ = 0)
        ("fp32_gqa3_segments_empty_rows", dict(
            b=2, h=6, hkv=2, d=64, sq=128, sk=128, dtype=f32, k_offset=40,
            segments=True)),
    ] + [(label, kw) for label, kw, fwd_only in _head_dim_cases(torch)
         if not fwd_only]


def _bwd_errs(pairs, dtype):
    """``pairs``: tensor name -> (kernel's, reference); each tensor held to
    its own tolerance: (ok, worst max_abs_err, per-tensor rows)."""
    tensors = {}
    for name, (got, ref) in pairs.items():
        ref = ref.float()
        scale = ref.abs().max().item()
        tensors[name] = {
            "max_abs_err": (got.float() - ref).abs().max().item(),
            "tol": BWD_REL_TOL[str(dtype)] * max(scale, 1e-6),
            "ref_max_abs": scale, "finite": bool(got.isfinite().all())}
    ok = all(t["finite"] and t["max_abs_err"] <= t["tol"]
             for t in tensors.values())
    return ok, max(t["max_abs_err"] for t in tensors.values()), tensors


def _err_row(pairs, dtype, ms, plain_ms, library_ms, bytes_, flops,
             variant=None):
    """``pairs``: tensor name -> (kernel's, reference); each tensor is
    held to its own tolerance.  ``max_abs_err`` is the worst of them."""
    ok, worst, tensors = _bwd_errs(pairs, dtype)
    return {"ok": ok, "max_abs_err": worst, "tensors": tensors, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            **_bound(bytes_, flops, _peak_flops(dtype, variant)),
            "bytes": bytes_, "flops": flops}


def _bwd_case(torch, timer, label, b, h, hkv, d, sq, sk, dtype, q_offset=0,
              k_offset=0, causal=True, segments=False, dlse=False,
              seg_ids=None):
    """``seg_ids`` as in :func:`_one_case`."""
    import torch.nn.functional as F

    from tpucfn_torch.kernels import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(len(label))
    q = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device="cuda").to(dtype)
    do = torch.randn(b, sq, h, d, generator=g, device="cuda").to(dtype)
    dl = (torch.randn(b, h, sq, generator=g, device="cuda") if dlse
          else None)
    q_seg = kv_seg = None
    if seg_ids is not None:
        segments = True
        q_seg = kv_seg = seg_ids.to("cuda", torch.int32).contiguous()
    elif segments:
        q_seg = (torch.arange(sq, device="cuda") // 48).int()[None].expand(b, sq).contiguous()
        # keys segmented by global position, k_offset + index, as queries
        kv_seg = ((torch.arange(sk, device="cuda") + k_offset) // 48).int()[None].expand(b, sk).contiguous()
    o, lse = fa.flash_fwd(q, k, v, causal=causal, q_offset=q_offset,
                          k_offset=k_offset, q_seg=q_seg, kv_seg=kv_seg)
    kw = dict(dlse=dl, causal=causal, q_offset=q_offset, k_offset=k_offset,
              q_seg=q_seg, kv_seg=kv_seg)
    delta = fa.flash_bwd_delta(o, do)
    wrappers = {"dq": fa.flash_bwd_dq, "dkv": fa.flash_bwd_dkv}
    before = {n: dict(w.launches_by_variant) for n, w in wrappers.items()}
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    variants = {}
    for n, w in wrappers.items():
        (variants[n],) = [k for k, c in w.launches_by_variant.items()
                          if c != before[n][k]]
    assert variants == {"dq": fa.dq_variant(dtype, h, hkv),
                        "dkv": fa.dkv_variant(dtype, h, hkv)}, variants
    ref_delta = fa.flash_bwd_delta_plain(o, do)
    ref = fa.flash_bwd_plain_from_delta(q, k, v, lse, delta, do, **kw)

    # Live (query, key) pairs of these inputs: the work the kernels need.
    qpos = torch.arange(sq, device="cuda") + q_offset
    kpos = torch.arange(sk, device="cuda") + k_offset
    live = torch.ones(b, sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        live &= (qpos[:, None] >= kpos[None, :])[None]
    if segments:
        live &= q_seg[:, :, None] == kv_seg[:, None, :]
    pairs = h * int(live.sum())  # per query head
    esize = torch.finfo(dtype).bits // 8
    n_q, n_kv, rows = q.numel() * esize, k.numel() * esize, b * h * sq * 4
    seg_bytes = b * (sq + sk) * 4 if segments else 0
    dl_bytes = rows if dlse else 0
    iters = 10 if sq * sk > 1 << 20 else 30

    # Library yardstick: the backward of one scaled_dot_product_attention
    # call (forward outside the timing), KV heads repeated, the mask built
    # beforehand; it computes dq, dk and dv together.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kt = kt.repeat_interleave(h // hkv, dim=1)
    vt = vt.repeat_interleave(h // hkv, dim=1)
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    plain_causal = causal and not segments and q_offset == k_offset == 0 \
        and sq == sk
    out = F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=plain_causal,
        attn_mask=None if plain_causal else live[:, None])
    dot = do.transpose(1, 2).contiguous()

    def library():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    library_ms = timer(library, iters=iters)
    plain_ms = timer(lambda: fa.flash_bwd_plain_from_delta(
        q, k, v, lse, delta, do, **kw), iters=iters)
    rows_out = {
        # Delta's yardstick is one vecdot over (B, Sq, H): it rounds its
        # output to the inputs' dtype, where Delta keeps fp32.
        "delta": _err_row(
            {"delta": (delta, ref_delta)}, torch.float32,
            timer(lambda: fa.flash_bwd_delta(o, do), iters=iters),
            timer(lambda: fa.flash_bwd_delta_plain(o, do), iters=iters),
            timer(lambda: torch.linalg.vecdot(do, o), iters=iters),
            2 * n_q + rows, 2 * d * b * h * sq),
        "dq": _err_row(
            {"dq": (dq, ref[0])}, dtype,
            timer(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                  iters=iters), plain_ms, library_ms,
            3 * n_q + 2 * n_kv + 2 * rows + dl_bytes + seg_bytes,
            2 * 3 * d * pairs, variants["dq"]),
        "dkv": _err_row(
            {"dk": (dk, ref[1]), "dv": (dv, ref[2])}, dtype,
            timer(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                  iters=iters), plain_ms, library_ms,
            2 * n_q + 4 * n_kv + 2 * rows + dl_bytes + seg_bytes,
            2 * 4 * d * pairs, variants["dkv"]),
    }
    for n, variant in variants.items():
        rows_out[n]["variant"] = variant

    def dq():
        return (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),)

    def dkv():
        return fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)

    # At every mma shape the old fma kernel of K2 or K3 (on no path now)
    # beside mma in turns on these inputs, held to the same tolerance
    # (bound against the FMA units' rate).
    for key, call, names in (("dq", dq, ("dq",)), ("dkv", dkv, ("dk", "dv"))):
        if variants[key] != "mma" or d not in fa.VARIANT_HEAD_DIMS["fma"]:
            continue
        refs = ref[:1] if key == "dq" else ref[1:]
        times, outs = _in_turns(timer, call, f"{key}_variant",
                                ("fma", "mma", "mma", "fma"))
        f_ok, f_err, _ = _bwd_errs(dict(zip(names, zip(outs["fma"], refs))),
                                   dtype)
        rows_out[key]["fma_beside"] = {
            "fma_ms": times["fma"], "mma_ms": times["mma"],
            "max_abs_err": f_err, "ok": f_ok,
            **_bound(rows_out[key]["bytes"], rows_out[key]["flops"],
                     PEAK_FLOPS[str(dtype)])}
        rows_out[key]["ok"] = rows_out[key]["ok"] and f_ok
    return {"case": label, "shape": dict(
        b=b, h=h, hkv=hkv, d=d, sq=sq, sk=sk, dtype=str(dtype), causal=causal,
        q_offset=q_offset, k_offset=k_offset, segments=segments, dlse=dlse),
        "ok": all(r["ok"] for r in rows_out.values()),
        "empty_rows": int((~live.any(-1)).sum()), **rows_out}


def _empty_calls_count_nothing(torch, fa):
    """A call on empty inputs returns zero-filled outputs without a launch,
    so no wrapper counts it."""
    wrappers = (fa.flash_fwd, fa.flash_bwd_delta, fa.flash_bwd_dq,
                fa.flash_bwd_dkv)
    by_variant = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [w.launches for w in wrappers] + [
        dict(w.launches_by_variant) for w in by_variant]
    q = torch.empty(1, 0, 4, 64, dtype=torch.bfloat16, device="cuda")
    kv = torch.randn(1, 16, 2, 64, device="cuda").to(torch.bfloat16)
    rows = torch.empty(1, 4, 0, device="cuda")
    fa.flash_fwd(q, kv, kv)
    # a decode-shaped query over an empty cache: O = 0, LSE = NEG_INF
    o, lse = fa.flash_fwd(torch.ones(1, 1, 4, 64, dtype=torch.bfloat16,
                                     device="cuda"), kv[:, :0], kv[:, :0])
    assert not o.any() and bool((lse == fa.NEG_INF).all())
    fa.flash_bwd_delta(q, q)
    fa.flash_bwd_dq(q, kv, kv, q, rows, rows)
    dk, dv = fa.flash_bwd_dkv(q, kv, kv, q, rows, rows)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] + [
        w.launches_by_variant for w in by_variant] == before, \
        "an empty call counted"
    assert not dk.any() and not dv.any(), "dK/dV of no queries must be 0"


def phase_kernel_bwd(results):
    import torch

    from tpucfn_torch.kernels import flash_attention as fa

    timer = Timer(torch)
    counters = (fa.flash_bwd_delta, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [c.launches for c in counters]
    rows = []
    for label, kw in _bwd_cases(torch):
        row = _bwd_case(torch, timer, label, **kw)
        emit({"kernel_bwd_case": row})
        rows.append(row)
        torch.cuda.empty_cache()
    results["kernel_bwd_rows"] = rows
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"backward kernels disagree with the plain "
                             f"backward: {bad}")
    if any(c.launches == n for c, n in zip(counters, before)):
        raise AssertionError("the comparisons never launched a kernel")
    for key, kernel, want in (("dq", "K2", {"sm90", "mma"}),
                              ("dkv", "K3", {"sm90", "mma"})):
        missing = want - {r[key]["variant"] for r in rows}
        if missing:
            raise AssertionError(f"no comparison launched the {missing} "
                                 f"{kernel} variant")
    _empty_calls_count_nothing(torch, fa)
    return {"cases": len(rows), "worst_max_abs_err": {
        k: max(r[k]["max_abs_err"] for r in rows)
        for k in ("delta", "dq", "dkv")}}


# ---- phases 5 and 6: serving -------------------------------------------------
class _Calls:
    """Records every K1-launching call of an engine, from any thread: the
    entry point, its query rows per batch row (the prefill bucket, 1 for
    a decode step, the verify width) and its host time (each call ends in
    a device-to-host copy of tokens, so the host time is complete); and
    with ``offsets``, the cache index each verify starts from (its query
    offsets; reading it synchronizes, so only one leg asks)."""

    def __init__(self, engine, offsets=False):
        import threading

        self.engine, self.record_offsets = engine, offsets
        self.lock = threading.Lock()
        self.clear()
        for name in ("prefill_batch", "decode", "verify"):
            setattr(engine, name, self._wrap(name, getattr(engine, name)))

    def clear(self):
        self.calls, self.seconds, self.offsets = [], {}, []

    def _wrap(self, name, inner):
        def recorded(*a, **kw):
            idx = (self.engine.cache.index.tolist()
                   if name == "verify" and self.record_offsets else None)
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            dt = time.perf_counter() - t0
            sq = 1 if name == "decode" else a[1]
            with self.lock:
                self.calls.append((name, sq))
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                if idx is not None:
                    self.offsets.append(idx)
            return out

        return recorded

    def count(self, name):
        return sum(1 for n, _ in self.calls if n == name)


def _teacher_forced_logits(torch, model, prompt, out):
    """Logits at the positions that predict each generated token, from one
    decode-mode pass over prompt + generated[:-1] on a fresh cache."""
    seq = torch.tensor([prompt + out[:-1]], device="cuda")
    cache = model.init_cache(1)
    with torch.no_grad():
        hidden = model(seq, cache=cache, return_hidden=True)
        return model.logits(hidden[0, len(prompt) - 1:])


def _profile(torch, fn, steps, kernel=None, classes=None):
    """Host wall time and device kernel time per call of ``fn`` over a
    short profiled window (torch.profiler with CUDA activity); the device
    busy share is kernel time over wall time (one stream, no overlap).
    ``kernel``: a name whose kernels' device ms per call is reported
    apart.  ``classes``: name -> substrings of kernel names; each class's
    device ms per call and share of the device time (first match wins,
    the rest is "other")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # Device rows that are kernels, not user annotations (an annotation
    # such as "Optimizer.step#AdamW.step" spans the kernels it encloses).
    kernels = [r for r in prof.key_averages()
               if r.device_type == DeviceType.CUDA
               and not getattr(r, "is_user_annotation", False)]
    device_ms = sum(r.self_device_time_total for r in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda r: -r.self_device_time_total)[:12]
    named = {} if kernel is None else {
        f"{kernel}_device_ms": sum(r.self_device_time_total for r in kernels
                                   if kernel in r.key) / 1e3 / steps}
    if classes and kernels:
        by = dict.fromkeys([*classes, "other"], 0.0)
        for r in kernels:
            key = r.key.lower()
            cls = next((c for c, subs in classes.items()
                        if any(x in key for x in subs)), "other")
            by[cls] += r.self_device_time_total / 1e3 / steps
        named["device_ms_by_class"] = by
        named["device_share_by_class"] = {c: ms / device_ms
                                          for c, ms in by.items()}
    return {**named, "wall_ms": wall_ms,
            "device_ms": device_ms if kernels else "not measured",
            "device_busy_share": device_ms / wall_ms if kernels else None,
            "kernels_per_call": sum(r.count for r in kernels) / steps,
            "top_device_ms": [[r.key[:60], r.self_device_time_total / 1e3
                               / steps] for r in top]}


def _serve_prompts(vocab):
    """The serving phases' prompts: SERVE_LENGTHS, then two prompts of a
    shared SERVE_SHARED-token prefix and their own tails."""
    import numpy as np

    rs = np.random.RandomState(0)
    shared = rs.randint(0, vocab, SERVE_SHARED).tolist()
    prompts = [rs.randint(0, vocab, n).tolist() for n in SERVE_LENGTHS]
    return prompts + [shared + rs.randint(0, vocab, n).tolist()
                      for n in SERVE_TAILS]


def phase_serve_llama3_1b(results):
    import torch

    from tpucfn_torch.kernels import flash_attention as fa
    from tpucfn_torch.models.llama import Llama
    from tpucfn_torch.serve import Server
    from tpucfn_torch.serve.engine import demo_llama_engine

    cache_len, max_new = 2048, SERVE_MAX_NEW
    cfg, engine = demo_llama_engine("llama3-1b", seed=0, max_batch=8,
                                    cache_len=cache_len, prefill_width=4,
                                    device="cuda")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ffn_dim, cfg.vocab_size) == \
        (2048, 16, 32, 8, 64, 8192, 128256), cfg
    prompts = _serve_prompts(cfg.vocab_size)

    # Warm-up (cuBLAS handles, the kernel library): one short request on a
    # throwaway Server over the same engine.
    warm = Server(engine, num_blocks=16, block_size=16)
    warm.submit(prompts[0], max_new_tokens=2)
    warm.run_until_idle()

    rec = _Calls(engine)
    server = Server(engine, num_blocks=cache_len * 8 // 16, block_size=16,
                    prefix_cache=True, max_prefill_batch=4)
    _zero_launch_counts()
    reqs = [server.submit(p, max_new_tokens=max_new) for p in prompts]
    server.run_until_idle()
    torch.cuda.synchronize()
    launches = fa.flash_fwd.launches
    by_variant = dict(fa.flash_fwd.launches_by_variant)
    # the run's; later calls below are not counted
    counts = {name: rec.count(name) for name in ("prefill_batch", "decode")}
    counts.update({name + "_s": rec.seconds[name]
                   for name in ("prefill_batch", "decode")})
    calls = counts["prefill_batch"] + counts["decode"]
    results["serve_launches"] = {"flash_fwd_sm90": by_variant["sm90"],
                                 "flash_fwd_decode_sm90": by_variant["decode"]}

    snap = server.metrics.snapshot()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert snap["completed"] == len(prompts), snap
    assert server.kv.allocator.num_used == 0, server.kv.allocator.num_used
    assert launches == cfg.n_layers * calls, (launches, calls)
    # Every prefill (a bucket of >= 16 tokens x 4 query heads per KV head:
    # >= 64 packed rows) on the wgmma kernel, every decode (1 token x 4
    # heads: 4 rows) on the decode variant, none on mma or fma.
    assert by_variant == {"sm90": cfg.n_layers * counts["prefill_batch"],
                          "decode": cfg.n_layers * counts["decode"],
                          "mma": 0, "fma": 0}, by_variant
    assert snap["prefix_hit_requests"] >= 1, snap

    plain = Llama.from_state_dict(engine.model.cfg, engine.model.state_dict(),
                                  decode=True, device="cuda")
    worst, match, total = 0.0, 0, 0
    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        ref = _teacher_forced_logits(torch, plain, p, out)
        got = _teacher_forced_logits(torch, engine.model, p, out)
        assert torch.isfinite(got).all() and got.shape == (max_new, cfg.vocab_size)
        worst = max(worst, (ref[-1] - got[-1]).abs().max().item())
        match += int((ref.argmax(-1).cpu() == torch.tensor(out)).sum())
        total += len(out)
    assert worst <= LOGITS_TOL_BF16, worst

    tpot = [(r.t_done - r.t_first_token) / (len(r.tokens) - 1) for r in reqs]
    # Where the time goes: a decode step over all 8 slots, and a full-width
    # prefill call (4 lanes x 512 tokens), profiled after the run.
    profile_decode = _profile(
        torch, lambda: engine.decode({s: 1 for s in range(8)}), 6,
        kernel="flash_fwd_decode")
    long_prompts = [(s, prompts[5], 0, 0.0) for s in range(4)]
    profile_prefill = _profile(
        torch, lambda: engine.prefill_batch(long_prompts, 512), 2)
    return {"requests": len(reqs), "completed": snap["completed"],
            "kv_blocks_used_after": server.kv.allocator.num_used,
            "prefill_calls": counts["prefill_batch"],
            "decode_steps": counts["decode"],
            "k1_launches": launches,
            "k1_launches_expected": cfg.n_layers * calls,
            "k1_launches_by_variant": by_variant,
            "prefix_hit_requests": snap["prefix_hit_requests"],
            "last_logits_max_abs_err": worst,
            "logits_tol": LOGITS_TOL_BF16,
            "greedy_match_rate": match / total,
            "ttft_s": snap["ttft_s"], "tpot_s_mean": sum(tpot) / len(tpot),
            "prefill_tokens_per_s": snap["prefilled_tokens"]
            / counts["prefill_batch_s"],
            "decode_tokens_per_s": snap["decode_tokens"] / counts["decode_s"],
            "decode_step_ms_mean": counts["decode_s"] / counts["decode"] * 1e3,
            "prefilled_tokens": snap["prefilled_tokens"],
            "decode_tokens": snap["decode_tokens"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "profile_decode_step": profile_decode,
            "profile_prefill_4x512": profile_prefill}


def phase_serve_tiny_fp32(results):
    import numpy as np
    import torch

    from tpucfn_torch.models.generate import generate
    from tpucfn_torch.serve import Server
    from tpucfn_torch.serve.engine import demo_llama_engine

    cfg, engine = demo_llama_engine("tiny", seed=1, max_batch=4, cache_len=128,
                                    device="cuda")
    assert cfg.dtype == torch.float32
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
               for n in (3, 9, 17, 30, 41, 64)]
    server = Server(engine, num_blocks=64, block_size=8)
    _zero_launch_counts()
    reqs = [server.submit(p, max_new_tokens=12) for p in prompts]
    server.run_until_idle()
    counts = _launch_counts()
    results["serve_tiny_launches"] = {"flash_fwd_mma": counts["k1_mma"]}
    # fp32: every K1 launch (prefill and decode) on the mma variant
    assert counts["k1_mma"] > 0 and counts["k1_mma"] == counts["k1"], counts
    params = engine.model.state_dict()
    for p, r in zip(prompts, reqs):
        ref = generate(cfg, params, [p], max_new_tokens=12)[0, len(p):]
        assert r.result(timeout=0) == ref.tolist(), (p, r.tokens, ref)
    assert server.kv.allocator.num_used == 0
    return {"requests": len(reqs), "identical": True,
            "k1_mma_launches": counts["k1_mma"]}


# ---- phases 7, 8 and 9: speculative decoding, the router, the serve CLI ----
SPEC_MAX_NEW = 96
ROUTER_MAX_NEW = 64
# The divergent draft's controller (k = 4, window 4) halves k after every
# window of 4 proposing rounds below the shrink threshold: 4, 2, 1, off.
SPEC_OFF_AFTER_ROUNDS = 12
SPEC_TPS_GAIN_MIN = 1.5     # the reference's gate (benches/serve_bench.py)
SPEC_TPOT_RATIO_MAX = 1.3   # the reference's gate, worst-case draft
SPEC_TINY_PASSES = 20      # passes of each tiny leg, in turns
# A bf16 token flip (spec against plain) must sit at a near-tie: the plain
# run's top-2 logit gap there under the logits tolerance.
SPEC_NEAR_TIE = LOGITS_TOL_BF16


def _expected_k1(recorders):
    """K1 launches that the recorded calls imply: (total, by variant), a
    call launching one per layer of its engine's model, in the variant
    ``fwd_variant`` picks at its shape."""
    from tpucfn_torch.kernels import flash_attention as fa

    want = dict.fromkeys(fa.flash_fwd.launches_by_variant, 0)
    for rec in recorders:
        cfg = rec.engine.model.cfg
        for _, sq in rec.calls:
            want[fa.fwd_variant(cfg.dtype, sq, cfg.n_heads,
                                cfg.n_kv_heads)] += cfg.n_layers
    return sum(want.values()), want


def _k1_counts():
    from tpucfn_torch.kernels import flash_attention as fa

    return fa.flash_fwd.launches, dict(fa.flash_fwd.launches_by_variant)


class _LoopGuard:
    """The most threads ever inside one engine's entry points at once (the
    cache is updated in place: two serve loops on one engine corrupt it)."""

    def __init__(self, engine):
        import threading

        self.lock = threading.Lock()
        self.active = self.most = 0
        for name in ("prefill_batch", "decode", "copy_prefix", "verify",
                     "rollback"):
            setattr(engine, name, self._wrap(getattr(engine, name)))

    def _wrap(self, inner):
        def guarded(*a, **kw):
            with self.lock:
                self.active += 1
                self.most = max(self.most, self.active)
            try:
                return inner(*a, **kw)
            finally:
                with self.lock:
                    self.active -= 1

        return guarded


def _spec_leg(torch, engine, prompts, max_new, server_kw, recorders,
              fresh_controller=None):
    """One leg of the reference's drill (``benches/serve_bench.py``): a
    warm-up Server over the engine (each prompt bucket, the verify widths,
    rollback), the controller reset after it (the timed pass pays the
    whole shrink-to-off transient), then one timed pass over ``prompts``.
    K1 counts and the call recorders cover the timed pass only."""
    import gc

    from tpucfn_torch.serve import Server
    from tpucfn_torch.serve.scheduler import prefill_bucket

    cache_len = engine.cache_len
    warm = Server(engine, **server_kw)
    for b in sorted({prefill_bucket(len(q), cache_len) for q in prompts}):
        warm.submit([1] * min(b, cache_len - max_new),
                    max_new_tokens=min(max_new, 24))
    warm.run_until_idle()
    if fresh_controller is not None:
        engine.controller = fresh_controller()
    ks = []
    ctl = getattr(engine, "controller", None)
    if ctl is not None:
        inner = ctl.round_k

        def round_k():
            ks.append(inner())
            return ks[-1]

        ctl.round_k = round_k
    for rec in recorders:
        rec.clear()
    _zero_launch_counts()
    gc.collect()  # no earlier leg's garbage is collected inside this one
    server = Server(engine, **server_kw)
    t0 = time.perf_counter()
    reqs = [server.submit(q, max_new_tokens=max_new) for q in prompts]
    server.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_variant = _k1_counts()
    snap = server.metrics.snapshot()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert snap["completed"] == len(prompts), snap
    assert server.kv.allocator.num_used == 0, server.kv.allocator.num_used
    tpots = [(r.t_done - r.t_first_token) / (len(r.tokens) - 1)
             for r in reqs]
    decode_s = sum(rec.seconds.get("decode", 0.0)
                   + rec.seconds.get("verify", 0.0) for rec in recorders)
    return [r.result(timeout=0) for r in reqs], {
        "wall_s": wall, "k1_launches": launches,
        "k1_launches_by_variant": by_variant,
        "calls": {name: sum(rec.count(name) for rec in recorders)
                  for name in ("prefill_batch", "decode", "verify")},
        # the target's host ms per call (recorders[0] is the target's)
        "target_host_ms_per_call": {
            name: t / recorders[0].count(name) * 1e3
            for name, t in recorders[0].seconds.items()},
        "tokens_per_target_step": snap["tokens_per_target_step"],
        "acceptance_rate": snap["spec_acceptance_rate"],
        "spec_rounds": snap["spec_rounds"],
        "spec_proposed": snap["spec_proposed"],
        "spec_accepted": snap["spec_accepted"],
        "decode_rounds": snap["decode_rounds"],
        "tpot_s_mean": sum(tpots) / len(tpots), "tpot_s_max": max(tpots),
        "ttft_s": snap["ttft_s"],
        "decode_tokens_per_s": snap["decode_tokens"] / decode_s,
        "round_ks": ks}


def _check_k1(leg, recorders):
    """The leg's K1 launches equal n_layers x the calls of each engine,
    and by variant what ``fwd_variant`` gives at each call's shape."""
    total, want = _expected_k1(recorders)
    assert leg["k1_launches"] == total, (leg["k1_launches"], total)
    assert leg["k1_launches_by_variant"] == want, (
        leg["k1_launches_by_variant"], want)
    return want


def _controller_off(ks):
    """(proposing rounds before the controller first reads 0, proposing
    rounds after it, rounds after it): the rounds after it propose only
    on the controller's probes (k = 1, one in every probe_every)."""
    first = ks.index(0)
    after = ks[first:]
    return (sum(1 for k in ks[:first] if k), [k for k in after if k],
            len(after))


def _verify_logits_err(torch, model, plain, prompt, run):
    """Max |logit| difference between the kernel path and the plain path
    over one verify-shaped pass: each model prefills ``prompt`` into a
    fresh one-row cache, then scores ``run`` (W tokens) in one forward."""
    outs = []
    with torch.no_grad():
        for m in (model, plain):
            cache = m.init_cache(1)
            m(torch.tensor([prompt], device="cuda"), cache=cache,
              return_hidden=True)
            h = m(torch.tensor([run], device="cuda"), cache=cache,
                  return_hidden=True)
            outs.append(m.logits(h[0]))
    assert torch.isfinite(outs[0]).all()
    return (outs[0] - outs[1]).abs().max().item()


def _flips(torch, model, prompts, ref, out):
    """Where a spec leg's tokens first differ from the plain leg's: the
    plain run's teacher-forced top-2 logit gap at that position."""
    gaps = []
    for p, a, b in zip(prompts, ref, out):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        logits = _teacher_forced_logits(torch, model, p, a)
        top = logits[j].topk(2).values
        gaps.append({"position": j, "top2_gap": (top[0] - top[1]).item(),
                     "plain_minus_spec": (logits[j, a[j]]
                                          - logits[j, b[j]]).item()})
    return gaps


def _verify_at_serving_offsets(torch, timer, offsets):
    """K1 at the verify pass's shapes (width 5 and 9 on ``mma``) and the
    decode step's (width 1 on ``decode``), with the query offsets a verify
    of the self-draft leg started from: one kernel case each, then the
    three timed in turns on the same cache (1, 5, 9, 9, 5, 1)."""
    from tpucfn_torch.kernels import flash_attention as fa

    cap = 2048
    rows, shapes = [], {}
    for sq in (1, 5, 9):
        off = [min(o, cap - sq) for o in offsets]
        label = ("decode" if sq == 1 else f"verify_sq{sq}") + \
            "_serving_offsets"
        rows.append(_one_case(torch, timer, label, 8, 32, 8, 64, sq, cap,
                              torch.bfloat16, off))
        shapes[sq] = off
    g = torch.Generator("cuda").manual_seed(7)
    k = torch.randn(8, cap, 8, 64, generator=g, device="cuda").bfloat16()
    v = torch.randn(8, cap, 8, 64, generator=g, device="cuda").bfloat16()
    qs = {sq: (torch.randn(8, sq, 32, 64, generator=g,
                           device="cuda").bfloat16(),
               torch.tensor(off, dtype=torch.int32, device="cuda"))
          for sq, off in shapes.items()}
    turns = {}
    for sq in (1, 5, 9, 9, 5, 1):
        q, off = qs[sq]
        turns.setdefault(sq, []).append(timer(
            lambda q=q, off=off: fa.flash_fwd(q, k, v, causal=True,
                                              q_offset=off)))
    return rows, {"offsets": offsets,
                  "turns_ms": {f"sq{sq}": ms for sq, ms in turns.items()}}


def phase_serve_spec_llama3_1b(results):
    import gc

    import numpy as np
    import torch

    from tpucfn_torch.models.llama import Llama
    from tpucfn_torch.serve.engine import ServeEngine, demo_llama_engine
    from tpucfn_torch.serve.spec import SpecDecoder, SpecKController

    # the reference's drill first, on its own
    tiny = _spec_tiny_fp32(torch, results)
    cache_len, max_new = 2048, SPEC_MAX_NEW
    cfg, engine = demo_llama_engine("llama3-1b", seed=0, max_batch=8,
                                    cache_len=cache_len, prefill_width=4,
                                    device="cuda")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab_size) == (2048, 16, 32, 8, 128256), cfg
    prompts = _serve_prompts(cfg.vocab_size)
    server_kw = dict(num_blocks=cache_len * 8 // 16, block_size=16,
                     prefix_cache=True, max_prefill_batch=4)

    def eng(params):
        return ServeEngine.from_llama(cfg, params, max_batch=8,
                                      cache_len=cache_len, prefill_width=4,
                                      device="cuda")

    self_draft = eng(engine.params)       # the target's own weights
    _, divergent = demo_llama_engine("llama3-1b", seed=1, max_batch=8,
                                     cache_len=cache_len, prefill_width=4,
                                     device="cuda")
    rec_t, rec_s, rec_d = (_Calls(engine, offsets=True), _Calls(self_draft),
                           _Calls(divergent))
    ref, plain = _spec_leg(torch, engine, prompts, max_new, server_kw, [rec_t])
    plain["k1_expected"] = _check_k1(plain, [rec_t])
    spec_self = SpecDecoder(engine, self_draft, k=4)
    out_self, hi = _spec_leg(torch, spec_self, prompts, max_new, server_kw,
                             [rec_t, rec_s])
    hi["k1_expected"] = _check_k1(hi, [rec_t, rec_s])
    verify_offsets = list(rec_t.offsets)
    rec_t.record_offsets = False
    verify_calls = rec_t.count("verify")
    verify_s = rec_t.seconds["verify"] / verify_calls
    spec_div = SpecDecoder(
        engine, divergent,
        controller=SpecKController(k=4, window=4, probe_every=64))
    out_div, lo = _spec_leg(
        torch, spec_div, prompts, max_new, server_kw, [rec_t, rec_d],
        fresh_controller=lambda: SpecKController(k=4, window=4,
                                                 probe_every=64))
    lo["k1_expected"] = _check_k1(lo, [rec_t, rec_d])
    results["spec_launches"] = {
        v: sum(leg["k1_launches_by_variant"][v] for leg in (plain, hi, lo))
        for v in ("sm90", "decode", "mma")}
    for leg in (hi, lo):
        assert leg["k1_launches_by_variant"]["mma"] > 0, leg
        assert leg["k1_launches_by_variant"]["fma"] == 0, leg

    # the reference's gate: tokens per target step, self draft over plain
    gain = hi["tokens_per_target_step"] / plain["tokens_per_target_step"]
    assert gain >= SPEC_TPS_GAIN_MIN, gain
    before, probes, off_rounds = _controller_off(lo["round_ks"])
    assert before <= SPEC_OFF_AFTER_ROUNDS, lo["round_ks"]
    assert all(k == 1 for k in probes) and \
        len(probes) <= off_rounds // 64 + 1, lo["round_ks"]

    # bf16: a flip against plain only at a near-tie
    flips = {"self": _flips(torch, engine.model, prompts, ref, out_self),
             "divergent": _flips(torch, engine.model, prompts, ref, out_div)}
    worst_gap = max((f["top2_gap"] for fs in flips.values() for f in fs),
                    default=0.0)
    assert worst_gap < SPEC_NEAR_TIE, flips
    plain_model = Llama.from_state_dict(cfg, engine.model.state_dict(),
                                        decode=True, device="cuda")
    verify_err = max(_verify_logits_err(torch, engine.model, plain_model, p,
                                        ref[i][:5])
                     for i, p in enumerate(prompts))
    assert verify_err <= LOGITS_TOL_BF16, verify_err

    timer = Timer(torch)
    mid = verify_offsets[len(verify_offsets) // 2]
    rows, turns = _verify_at_serving_offsets(torch, timer, mid)
    assert all(r["ok"] for r in rows), rows
    assert [r["variant"] for r in rows] == ["decode", "mma", "mma"], rows
    results["kernel_rows"] = results.get("kernel_rows", []) + rows
    for r in rows:
        emit({"kernel_case": r})
    profile_verify = _profile(
        torch, lambda: engine.verify({s: [1] * 5 for s in range(8)}, 5), 6,
        kernel="flash_fwd_mma")
    profile_decode = _profile(
        torch, lambda: engine.decode({s: 1 for s in range(8)}), 6,
        kernel="flash_fwd_decode")
    out = {"max_new": max_new, "requests": len(prompts),
           "legs": {"plain": plain, "self": hi, "divergent": lo},
           "tokens_per_target_step_gain": gain,
           "divergent_tpot_ratio": lo["tpot_s_mean"] / plain["tpot_s_mean"],
           "self_tpot_ratio": hi["tpot_s_mean"] / plain["tpot_s_mean"],
           "divergent_controller": {"proposing_rounds_before_off": before,
                                    "probes": len(probes),
                                    "rounds_off": off_rounds},
           "flips": {k: len(v) for k, v in flips.items()},
           "flip_gaps": flips, "verify_logits_max_abs_err": verify_err,
           "logits_tol": LOGITS_TOL_BF16,
           "verify_calls": verify_calls,
           "verify_host_ms_per_call": verify_s * 1e3,
           "verify_offsets_timed": mid, "k1_turns": turns,
           "profile_verify_w5": profile_verify,
           "profile_decode_step": profile_decode,
           "tiny_fp32": tiny}
    del engine, self_draft, divergent, spec_self, spec_div, plain_model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _spec_tiny_fp32(torch, results):
    """The reference's drill as it runs (``benches/serve_bench.py
    --spec``): tiny in fp32, a self draft and a divergent nano draft
    (seed 1, controller k 4, window 4, probes every 64), 8 prompts of
    8-96 tokens, 96 new, no prefix cache.  Spec output equals plain's
    token for token; the self draft reaches 1.5x the tokens per target
    step; the worst-case draft's TPOT is within 1.3x plain's (the mean
    of twenty passes each, in turns)."""
    import numpy as np

    from tpucfn_torch.serve.engine import ServeEngine, demo_llama_engine
    from tpucfn_torch.serve.spec import SpecDecoder, SpecKController

    cache_len, max_new = 256, SPEC_MAX_NEW
    cfg, target = demo_llama_engine("tiny", seed=0, max_batch=8,
                                    cache_len=cache_len, prefill_width=4,
                                    device="cuda")
    assert cfg.dtype == torch.float32
    draft = ServeEngine.from_llama(cfg, target.params, max_batch=8,
                                   cache_len=cache_len, prefill_width=4,
                                   device="cuda")
    _, nano = demo_llama_engine("nano", seed=1, max_batch=8,
                                cache_len=cache_len, prefill_width=4,
                                device="cuda")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, rs.randint(8, 97)).tolist()
               for _ in range(8)]
    server_kw = dict(num_blocks=512, block_size=16, prefix_cache=False,
                     max_prefill_batch=4)
    recs = [_Calls(e) for e in (target, draft, nano)]

    def leg(engine, recorders, **kw):
        out, row = _spec_leg(torch, engine, prompts, max_new, server_kw,
                             recorders, **kw)
        want = _check_k1(row, recorders)
        assert want["mma"] == row["k1_launches"], want  # fp32: all on mma
        assert out == ref, "spec output differs from plain"
        row.pop("round_ks")
        return row

    # Plain and the worst-case draft in turns, SPEC_TINY_PASSES each
    # (plain, nano, nano, plain, plain, nano, ...): on this host-bound
    # step one pass's TPOT varies by up to ~30% within a run.
    fresh = lambda: SpecKController(k=4, window=4, probe_every=64)  # noqa: E731
    lo_spec = SpecDecoder(target, nano, controller=fresh())
    ref, plain = _spec_leg(torch, target, prompts, max_new, server_kw,
                           recs[:1])
    plain.pop("round_ks")
    _check_k1(plain, recs[:1])
    turns = [("plain", plain)]
    for name in (("divergent_nano", "divergent_nano", "plain", "plain")
                 * (SPEC_TINY_PASSES // 2))[:-1]:
        turns.append((name, leg(target, recs[:1]) if name == "plain" else
                      leg(lo_spec, [recs[0], recs[2]],
                          fresh_controller=fresh)))
    hi = leg(SpecDecoder(target, draft, k=4), recs[:2])
    tpot = {k: [r["tpot_s_mean"] for n, r in turns if n == k]
            for k in ("plain", "divergent_nano")}
    gain = hi["tokens_per_target_step"] / plain["tokens_per_target_step"]
    ratio = sum(tpot["divergent_nano"]) / sum(tpot["plain"])
    assert gain >= SPEC_TPS_GAIN_MIN, gain
    assert ratio <= SPEC_TPOT_RATIO_MAX, (ratio, tpot)
    results["spec_tiny_launches"] = sum(
        r["k1_launches_by_variant"]["mma"] for _, r in turns) + \
        hi["k1_launches_by_variant"]["mma"]
    return {"identical": True, "tokens_per_target_step_gain": gain,
            "worst_case_tpot_ratio": ratio, "tpot_s_in_turns": tpot,
            "legs": {"plain": plain, "self": hi,
                     "divergent_nano": turns[1][1]}}


def _router_prompts(vocab, n=16):
    import numpy as np

    rs = np.random.RandomState(2)
    return [rs.randint(0, vocab, rs.randint(16, 513)).tolist()
            for _ in range(n)]


def phase_serve_router_llama3_1b(results):
    import gc
    import tempfile
    import threading

    import torch

    from tpucfn_torch.obs.registry import MetricRegistry
    from tpucfn_torch.serve import ReplicaRouter, Server
    from tpucfn_torch.serve.engine import ServeEngine, demo_llama_engine
    from tpucfn_torch.serve.spec import SpecDecoder

    cache_len = 2048
    cfg, e0 = demo_llama_engine("llama3-1b", seed=0, max_batch=8,
                                cache_len=cache_len, prefill_width=4,
                                device="cuda")

    def eng():
        return ServeEngine.from_llama(cfg, e0.params, max_batch=8,
                                      cache_len=cache_len, prefill_width=4,
                                      device="cuda")

    d0, e1 = eng(), eng()
    engines = {"target0": e0, "draft0": d0, "replica1": e1}
    guards = {k: _LoopGuard(e) for k, e in engines.items()}
    recs = [_Calls(e) for e in engines.values()]
    # replica 0 speculative (as --spec-replicas 0); built outside the
    # factory, so a relaunch reuses the engine pair
    replica_engines = [SpecDecoder(e0, d0, k=4), e1]
    servers = {0: [], 1: []}

    def factory(i):
        srv = Server(replica_engines[i], num_blocks=cache_len * 8 // 16,
                     block_size=16, prefix_cache=True, max_prefill_batch=4)
        servers[i].append(srv)
        return srv

    root = Path(tempfile.mkdtemp(prefix="serve_router_llama3_1b-"))
    router = ReplicaRouter(factory, 2, registry=MetricRegistry(),
                           hedge_ms=0.0, ft_dir=root / "serve-ft")
    states, stop = [], threading.Event()

    def watch():  # the replicas' state changes, on the router's clock
        last = None
        while not stop.is_set():
            now = router.clock()
            cur = [rep.state(now) for rep in router.replicas]
            if cur != last:
                states.append((now, cur))
                last = cur
            time.sleep(0.002)

    prompts = _router_prompts(cfg.vocab_size)
    _zero_launch_counts()
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    router.start()
    try:
        first = [router.submit(p, max_new_tokens=ROUTER_MAX_NEW)
                 for p in prompts[:12]]
        t_end = time.monotonic() + 300
        while not all(servers[i][0].metrics.snapshot()["generated_tokens"]
                      for i in (0, 1)):
            assert time.monotonic() < t_end, "no tokens on both replicas"
            time.sleep(0.005)
        t_kill = router.clock()
        router.kill_replica(1)
        kill_call_s = router.clock() - t_kill
        later = [router.submit(p, max_new_tokens=ROUTER_MAX_NEW)
                 for p in prompts[12:]]
        for r in first + later:
            assert r.done.wait(300), "request never completed"
    finally:
        router.stop()
        stop.set()
        watcher.join(5)
    torch.cuda.synchronize()
    launches, by_variant = _k1_counts()
    snap = router.snapshot()
    reqs = first + later
    assert all(r.error is None and len(r.tokens) == ROUTER_MAX_NEW
               for r in reqs), [(r.status, r.error) for r in reqs]
    assert snap["completed"] == len(reqs), snap
    assert snap["failovers"] >= 1 or snap["retries"] >= 1, snap
    assert len(servers[1]) == 2, "replica 1 was not relaunched"
    assert any(s[1][1] == "half_open" for s in states if s[0] > t_kill), \
        states
    served_after = servers[1][1].metrics.snapshot()["completed"]
    assert served_after >= 1, served_after
    most = {k: g.most for k, g in guards.items()}
    assert all(m == 1 for m in most.values()), most
    leaked = {f"{i}.{j}": s.kv.allocator.num_used
              for i in (0, 1) for j, s in enumerate(servers[i])
              if s.failed is None}
    assert not any(leaked.values()), leaked
    total, want = _expected_k1(recs)
    assert launches == total, (launches, total)
    assert by_variant == want, (by_variant, want)
    assert by_variant["mma"] > 0 and by_variant["fma"] == 0, by_variant
    results["router_launches"] = {v: by_variant[v]
                                  for v in ("sm90", "decode", "mma")}
    retried = [r for r in reqs if r.retries > 0]
    first_retried = min((r.attempts[-1].sreq.t_first_token for r in retried),
                        default=None)
    out = {"requests": len(reqs), "completed": snap["completed"],
           "tokens_each": ROUTER_MAX_NEW,
           "router": {k: snap[k] for k in ("retries", "failovers", "hedges",
                                           "failed", "latency_s")},
           "retried_requests": len(retried),
           "kill_call_s": kill_call_s,
           "kill_to_first_retried_token_s": (
               first_retried - t_kill if first_retried is not None else None),
           "replica1_served_after_relaunch": served_after,
           "state_changes": [[round(t - t_kill, 4), s] for t, s in states],
           "most_loops_on_one_engine": most,
           "kv_blocks_used_after": leaked,
           "k1_launches": launches, "k1_launches_by_variant": by_variant,
           "events": [json.loads(line)["kind"] for line in
                      (root / "serve-ft" / "events.jsonl").read_text()
                      .splitlines()]}
    del e0, d0, e1, engines, replica_engines, servers, router
    gc.collect()
    torch.cuda.empty_cache()
    return out


SERVE_PROFILE_S = 2.0
# K1's decode variant as the profiler names it
SERVE_DECODE_KERNEL = "flash_fwd_decode_kernel"


def phase_serve_cli_llama3_1b(results):
    """``python -m tpucfn_torch.cli serve`` at llama3-1b, 2 replicas, a
    self draft on each, under ``TPUCFN_FT_DIR``: once every request is
    in, ``cli obs profile`` asks its endpoint for a 2 s ``POST
    /profile`` capture, which must name K1's decode kernel; then SIGTERM,
    and ``cli obs`` over its run dir."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    root = Path(tempfile.mkdtemp(prefix="serve_cli_llama3_1b-"))
    run, ft = root / "run", root / "ft"
    env = {**os.environ, "TPUCFN_FT_DIR": str(ft),
           "TPUCFN_FT_HEARTBEAT_S": "0.5"}
    for k in ("TPUCFN_OBS_PORT", "TPUCFN_COMPILE_CACHE_ADDRS"):
        env.pop(k, None)
    n, drain_grace = 16, 30.0
    cmd = [sys.executable, "-m", "tpucfn_torch.cli", "serve", "--preset",
           "llama3-1b", "--replicas", "2", "--spec-draft", "self",
           "--cache-len", "2048", "--synthetic", str(n), "--max-new",
           str(ROUTER_MAX_NEW), "--obs-port", "0", "--trace-dir",
           str(run / "trace"), "--drain-grace", str(drain_grace)]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    err_lines, url = [], []
    got_url = threading.Event()

    def read_err():
        for line in proc.stderr:
            err_lines.append(line)
            if line.startswith("obs endpoint: "):
                url.append(line.split(": ", 1)[1].strip())
                got_url.set()

    reader = threading.Thread(target=read_err, daemon=True)
    reader.start()
    try:
        assert got_url.wait(300), "".join(err_lines)
        metrics = {}
        while metrics.get("router_requests_total") != float(n):
            assert proc.poll() is None, "".join(err_lines)
            assert time.monotonic() - t0 < 600, metrics
            time.sleep(0.02)
            try:
                metrics = _prometheus(_http(url[0])[1])
            except OSError:
                metrics = {}
        live = sorted(k for k in metrics
                      if k.startswith(("router_", "serve_spec_")))
        # POST /profile while the requests decode (once a decode round is
        # in the trace: the first prefills also build the replicas' RoPE
        # tables), through the port's ``obs profile``
        def decoding():
            text = "".join(f.read_text() for f in
                           (run / "trace").glob("trace-*.jsonl"))
            return any(f'"name": "{n}"' in text
                       for n in ("decode_round", "spec_propose"))

        while not decoding():
            assert proc.poll() is None, "".join(err_lines)
            assert time.monotonic() - t0 < 600, "no decode round traced"
            time.sleep(0.02)
        host = url[0].split("//", 1)[1].split("/", 1)[0]
        t_profile = time.monotonic()
        rc, body = _cli_main(["obs", "profile", "--host", host,
                              "--seconds", str(SERVE_PROFILE_S)])
        profile_s = time.monotonic() - t_profile
        assert rc == 0, (rc, body, "".join(err_lines)[-4000:])
        capture = json.loads(body)
        profiled = _trace_kernels(Path(capture["artifact"]) / "trace.json")
        hb = ft / "hb-host000.jsonl"
        beat0 = json.loads(hb.read_text().splitlines()[-1])
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()  # to the exit (stderr goes to `reader`)
        proc.wait(timeout=60)
        drain_s = time.monotonic() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(10)
    err = "".join(err_lines)
    assert proc.returncode == 0, err[-4000:]
    assert "SIGTERM: draining" in err, err[-4000:]
    assert f"served {n}/{n}" in err, err[-4000:]
    assert drain_s <= drain_grace, drain_s
    assert any(k.startswith("router_") for k in live) and \
        {"serve_spec_acceptance_rate", "serve_spec_k"} <= set(live), live
    beats = [json.loads(line) for line in hb.read_text().splitlines()]
    assert beats[-1]["seq"] > beat0["seq"], (beat0, beats[-1])
    snap = json.loads(out.strip().splitlines()[-1])["router"]
    assert snap["completed"] == n and snap["failed"] == 0, snap
    obs = subprocess.run(
        [sys.executable, "-m", "tpucfn_torch.cli", "obs", "--run-dir",
         str(run), "--json"], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=300)
    assert obs.returncode == 0, obs.stderr[-4000:]
    rows = json.loads(obs.stdout)["requests"]
    assert len(rows) == n and all(r["outcome"] == "ok" for r in rows), rows
    spec_rows = [r for r in rows if r["spec_propose_s"] > 0]
    assert spec_rows and all(r["spec_verify_s"] > 0 for r in spec_rows), \
        rows
    decode = {k: v for k, v in profiled.items() if SERVE_DECODE_KERNEL in k}
    assert decode, {k: v for k, v in profiled.items() if "flash" in k}
    shutil.rmtree(root, ignore_errors=True)
    return {"rc": proc.returncode, "requests": n,
            "profile": {"seconds": capture["seconds"],
                        "dur_s": capture["dur_s"], "client_s": profile_s,
                        "decode_kernels": decode,
                        "flash_kernels": {k: v for k, v in profiled.items()
                                          if "flash_" in k},
                        "distinct_kernels": len(profiled)},
            "drain_s": drain_s, "drain_grace_s": drain_grace,
            "run_s": time.monotonic() - t0,
            "live_series": live, "heartbeats": len(beats),
            "router": {k: snap[k] for k in ("completed", "retries",
                                            "failovers", "latency_s")},
            "obs_rows": len(rows), "obs_rows_with_spec": len(spec_rows)}


# ---- phases 10 and 11: training ---------------------------------------------
# Loss of the kernel path against the plain attention path at the same
# params and batch (llama3-1b, bf16): the plain forward rounds P to bf16
# before PV (as the JAX dense op does) and K1 keeps it fp32, carried
# through 16 layers; gradients are held to a cosine similarity instead.
TRAIN_LOSS_TOL_BF16 = 0.02
GRAD_COSINE_MIN = 0.99
# tiny fp32, kernel path against plain path over a few AdamW steps: fp32
# sum order only, slightly amplified by the steps.
TINY_LOSS_TOL_FP32 = 1e-4
LAUNCHES_PER_LAYER = {"k1": 2, "k2": 1, "k3": 1, "delta": 1}  # full remat


def _launch_counts():
    """Launches per wrapper, and of K1, K2 and K3 per variant."""
    from tpucfn_torch.kernels import flash_attention as fa

    k1 = fa.flash_fwd.launches_by_variant
    k2 = fa.flash_bwd_dq.launches_by_variant
    k3 = fa.flash_bwd_dkv.launches_by_variant
    return {"k1": fa.flash_fwd.launches, "k2": fa.flash_bwd_dq.launches,
            "k3": fa.flash_bwd_dkv.launches,
            "delta": fa.flash_bwd_delta.launches,
            "k1_sm90": k1["sm90"], "k1_decode": k1["decode"],
            "k1_mma": k1["mma"], "k1_fma": k1["fma"],
            "k2_sm90": k2["sm90"], "k2_mma": k2["mma"], "k2_fma": k2["fma"],
            "k3_sm90": k3["sm90"], "k3_mma": k3["mma"], "k3_fma": k3["fma"]}


def _launches_by_head_dim():
    """Launches of K1, K2, K3 and Delta by head dim."""
    from tpucfn_torch.kernels import flash_attention as fa

    return {k: dict(f.launches_by_head_dim) for k, f in (
        ("k1", fa.flash_fwd), ("k2", fa.flash_bwd_dq),
        ("k3", fa.flash_bwd_dkv), ("delta", fa.flash_bwd_delta))}


def _zero_launch_counts():
    from tpucfn_torch.kernels import flash_attention as fa

    for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
              fa.flash_bwd_delta):
        f.launches = 0
        f.launches_by_head_dim = {}
    for f in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        f.launches_by_variant = dict.fromkeys(f.launches_by_variant, 0)


def _example_chain(total_steps):
    """The optimizer chain of examples/llama3_8b_fsdp.py."""
    from tpucfn_torch.train import (adamw, chain, clip_by_global_norm,
                                    warmup_cosine_decay_schedule)

    warmup = max(1, min(100, total_steps // 10))
    return chain(clip_by_global_norm(1.0), adamw(
        warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total_steps),
        b1=0.9, b2=0.95, weight_decay=0.1))


def _token_batch(torch, n, seq_len, vocab):
    import numpy as np

    from tpucfn_torch.data import synthetic_tokens

    tokens = np.stack([x["tokens"] for x in synthetic_tokens(
        n, seq_len=seq_len, vocab=vocab, seed=0)])
    return {"tokens": torch.as_tensor(tokens, device="cuda")}


def _grad_parity(torch, cfg, params, batch, chunk_size, z_loss):
    """Loss and every parameter's gradient through the kernels and through
    the plain attention op, at the same params and batch."""
    from tpucfn_torch.ops.attention import dot_product_attention
    from tpucfn_torch.train import llama_train_fns

    names = list(params)
    out = []
    for attention_fn in (None, dot_product_attention):
        _, loss_fn = llama_train_fns(cfg, attention_fn=attention_fn,
                                     chunk_size=chunk_size, z_loss=z_loss)
        loss, _ = loss_fn(params, {}, batch, None)
        out.append((loss.item(), torch.autograd.grad(
            loss, [params[n] for n in names])))
    return _parity_row(names, *out)


def _parity_row(names, kernel, plain):
    """The kernel path's (loss, grads) against the plain path's: the loss
    difference and each gradient's cosine similarity, the worst named."""
    (k_loss, k_grads), (p_loss, p_grads) = kernel, plain
    cosines = {}
    for n, a, b in zip(names, k_grads, p_grads):
        a, b = a.double().flatten(), b.double().flatten()
        den = a.norm() * b.norm()
        cosines[n] = 1.0 if den == 0 else float(a @ b / den)
    worst = min(cosines, key=cosines.get)
    return {"kernel_loss": k_loss, "plain_loss": p_loss,
            "loss_abs_diff": abs(k_loss - p_loss),
            "loss_tol": TRAIN_LOSS_TOL_BF16,
            "grad_cosine_min": cosines[worst], "grad_cosine_min_at": worst,
            "grad_cosine_tol": GRAD_COSINE_MIN, "tensors": len(cosines),
            "zero_grads": sum(1 for g in k_grads if not g.any())}


def phase_train_llama3_1b(results):
    import dataclasses

    import torch

    from tpucfn_torch.models.llama import LlamaConfig
    from tpucfn_torch.train import Trainer, llama_train_fns

    cfg = dataclasses.replace(LlamaConfig.llama3_1b(),
                              param_dtype=torch.float32, remat=True)
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.ffn_dim, cfg.vocab_size) == \
        (2048, 16, 32, 8, 64, 8192, 128256), cfg
    steps, b, seq, chunk, z_loss = 4, 2, 2048, 512, 1e-4
    init_fn, loss_fn = llama_train_fns(cfg, chunk_size=chunk, z_loss=z_loss)
    trainer = Trainer(None, None, loss_fn, _example_chain(steps), init_fn,
                      device="cuda")
    state = trainer.init(0)
    batch = _token_batch(torch, b, seq, cfg.vocab_size)
    n_params = sum(p.numel() for p in state.params.values())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, step_s, per_step, seen = [], [], [], _launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        now = _launch_counts()
        per_step.append({k: now[k] - seen[k] for k in now})
        seen = now
    results["train_launches"] = seen
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    expected = {k: n * cfg.n_layers for k, n in LAUNCHES_PER_LAYER.items()}
    # Every K1, K2 and K3 launch of the step on the tensor-core variants.
    expected.update(k1_sm90=expected["k1"], k1_decode=0, k1_mma=0,
                    k1_fma=0, k2_sm90=expected["k2"], k2_mma=0, k2_fma=0,
                    k3_sm90=expected["k3"], k3_mma=0, k3_fma=0)
    assert all(c == expected for c in per_step), (per_step, expected)
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0], losses

    steady = sum(step_s[1:]) / (steps - 1)
    results["train_step_ms"] = steady * 1e3
    tokens = b * seq
    matmul_params = n_params - cfg.vocab_size * cfg.dim \
        - (2 * cfg.n_layers + 1) * cfg.dim  # no embedding lookup, no norms
    attn_flops = (3 * 4 * cfg.head_dim * cfg.n_heads * b
                  * seq * (seq + 1) // 2 * cfg.n_layers)
    model_flops = 6 * matmul_params * tokens + attn_flops
    profile = _profile(torch, lambda: trainer.step(state, batch), 1)
    parity = _grad_parity(torch, cfg, state.params, batch, chunk, z_loss)
    assert parity["loss_abs_diff"] <= TRAIN_LOSS_TOL_BF16, parity
    assert parity["grad_cosine_min"] >= GRAD_COSINE_MIN, parity
    return {"card": results.get("card"), "params": n_params,
            "batch": [b, seq], "losses": losses,
            "launches_per_step": per_step[-1],
            "launches_expected_per_step": expected,
            "step_ms": [t * 1e3 for t in step_s],
            "step_ms_steady_mean": steady * 1e3,
            "tokens_per_s": tokens / steady,
            "model_flops_per_step": model_flops,
            "mfu_vs_989_tflops": model_flops / steady / 989e12,
            "peak_mem_gib": peak_gib, "profile_step": profile,
            "parity_after_steps": parity}


def phase_train_tiny_fp32(results):
    import dataclasses

    import torch

    from tpucfn_torch.models.llama import LlamaConfig
    from tpucfn_torch.ops.attention import dot_product_attention
    from tpucfn_torch.train import Trainer, adamw, llama_train_fns

    cfg = dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32)
    assert cfg.dtype == torch.float32
    batch = _token_batch(torch, 8, 64, cfg.vocab_size)
    runs = {}
    for name, attention_fn in (("kernel", None),
                               ("plain", dot_product_attention)):
        init_fn, loss_fn = llama_train_fns(cfg, attention_fn=attention_fn,
                                           chunk_size=16)
        trainer = Trainer(None, None, loss_fn, adamw(1e-3), init_fn,
                          device="cuda")
        state = trainer.init(0)
        _zero_launch_counts()
        losses = []
        for _ in range(6):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
        runs[name] = (losses, _launch_counts())
    (k_losses, k_counts), (p_losses, p_counts) = runs["kernel"], runs["plain"]
    diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    assert diff <= TINY_LOSS_TOL_FP32, (k_losses, p_losses)
    assert all(k_counts[k] == 6 * n * cfg.n_layers
               for k, n in LAUNCHES_PER_LAYER.items()), k_counts
    # fp32 runs K1, K2 and K3 on mma (3xTF32), none on fma
    assert (k_counts["k1_mma"], k_counts["k2_mma"], k_counts["k3_mma"]) == (
        k_counts["k1"], k_counts["k2"], k_counts["k3"]), k_counts
    assert not any(p_counts.values()), p_counts
    results["train_tiny_launches"] = k_counts
    assert k_losses[-1] < k_losses[0], k_losses
    return {"kernel_losses": k_losses, "plain_losses": p_losses,
            "loss_max_abs_diff": diff, "loss_tol": TINY_LOSS_TOL_FP32,
            "kernel_launches": k_counts}


# ---- phase 12 --------------------------------------------------------------
EXAMPLE_LOSS_REL_TOL = 1e-3  # a relaunch's losses against an uninterrupted run


class _SegmentCalls:
    """Counts the flash calls that carry segment ids (the packed path),
    by wrapping ``flash_attention`` while a run lasts."""

    def __init__(self, fa):
        self.fa, self.real, self.count = fa, fa.flash_attention, 0

    def __enter__(self):
        def counted(*a, **kw):
            if kw.get("segment_ids") is not None:
                self.count += 1
            return self.real(*a, **kw)

        self.fa.flash_attention = counted
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention = self.real


class _WaitForSaveBefore:
    """While a run lasts, the loop's checkpoint call after step ``step - 1``
    first waits for the write in flight to be durable, so step ``step``
    on runs with none."""

    def __init__(self, step):
        from tpucfn_torch.ckpt import CheckpointManager

        self.cls, self.real, self.step = (CheckpointManager,
                                          CheckpointManager.save, step)

    def __enter__(self):
        def save(mgr, step, state, **kw):
            if step == self.step - 1:
                mgr.wait()
            return self.real(mgr, step, state, **kw)

        self.cls.save = save
        return self

    def __exit__(self, *exc):
        self.cls.save = self.real


class _SaveOnly:
    """While a run lasts, the loop's checkpoint saves are made only at
    ``steps`` (none when empty): any other save call returns as a save
    that the interval skips.  Enter it before ``_WaitForSaveBefore``,
    whose wait must run on every save call, made or not.  For the runs whose gates read no checkpoint
    written there, so the phase does not wait for writes (llama3-1b at 2
    layers is 7.8 GB a save, at 16 layers 18 GB; ~0.6 GB/s)."""

    def __init__(self, steps=()):
        from tpucfn_torch.ckpt import CheckpointManager

        self.cls, self.real = CheckpointManager, CheckpointManager.save
        self.steps = set(steps)

    def __enter__(self):
        def save(mgr, step, state, **kw):
            if int(step) not in self.steps:
                return False
            return self.real(mgr, step, state, **kw)

        self.cls.save = save
        return self

    def __exit__(self, *exc):
        self.cls.save = self.real


# The example as a subprocess job with every checkpoint save skipped
# (``_SaveOnly(())`` in the child): the planes drill's cold leg, whose
# gates read no checkpoint.
NO_SAVE_EXAMPLE = [
    sys.executable, "-c",
    "import sys\n"
    "from tpucfn_torch.ckpt import CheckpointManager\n"
    "CheckpointManager.save = lambda self, step, state, **kw: False\n"
    "from tpucfn_torch.examples.llama3_8b_fsdp import main\n"
    "sys.exit(main(sys.argv[1:]))"]


def _run_example(argv, per_step=None, example="llama3_8b_fsdp"):
    """The port's example (``tpucfn_torch/examples/<example>.py``) through
    its ``main(argv)``; its stdout is kept (and returned) and each
    ``Trainer.step``'s launches are appended to ``per_step``."""
    import contextlib
    import importlib
    import io

    from tpucfn_torch.train import trainer as tr

    real_step = tr.Trainer.step

    def counted(self, state, batch):
        before = _launch_counts()
        out = real_step(self, state, batch)
        after = _launch_counts()
        if per_step is not None:
            per_step.append({k: after[k] - before[k] for k in after})
        return out

    ex = importlib.import_module(f"tpucfn_torch.examples.{example}")
    out = io.StringIO()
    tr.Trainer.step = counted
    try:
        with _flight_hooks_go_with_the_run(), contextlib.redirect_stdout(out):
            rc = ex.main(argv)
    finally:
        tr.Trainer.step = real_step
    assert rc == 0, out.getvalue()[-2000:]
    return out.getvalue()


def _flight_hooks_go_with_the_run():
    """A loop run in this process arms its flight ring's dump for the
    process's exit (atexit and SIGTERM).  Here the run ends when the
    block does, and its run dir is removed before the exit: the hooks go
    with the run."""
    import atexit
    import contextlib
    import signal

    from tpucfn_torch.obs.flight import FlightRecorder

    @contextlib.contextmanager
    def scope():
        real_install = FlightRecorder.install_dump_handlers
        armed = []

        def install(rec, d, *a, **kw):
            armed.append((rec, signal.getsignal(signal.SIGTERM)))
            return real_install(rec, d, *a, **kw)

        FlightRecorder.install_dump_handlers = install
        try:
            yield
        finally:
            FlightRecorder.install_dump_handlers = real_install
            for rec, sigterm in armed:
                atexit.unregister(rec._dump_quietly)
                signal.signal(signal.SIGTERM, sigterm)

    return scope()


def _exit_after_last_beat(ev, beats):
    """Each rank incarnation's seconds from its last heartbeat to the
    coordinator's next event (its exit, the relaunch, or the detect of
    its kill): the silence the dead-rank verdict (six beats) must not
    reach while a rank that finished is still exiting."""
    last = {}
    for b in beats:
        last[b["pid"]] = max(last.get(b["pid"], 0.0), b["t"])
    out = {}
    for pid, t in last.items():
        nxt = [e["ts"] for e in ev if e["ts"] > t and e["kind"] in (
            "host_exit", "launch", "detect", "done")]
        out[str(pid)] = min(nxt) - t if nxt else None
    return out


def _whole_2_layers(results):
    """The uninterrupted 2-layer run (``FT_JOB`` in this process, no
    planes) that the example's resume and the ft drill hold their losses
    to, run once by whichever phase comes first.  It saves no checkpoint
    (its gates read its losses only), so every step runs with no write in
    flight: the drill's planes-off steps."""
    import shutil
    import tempfile

    import torch

    if "whole_2_layers" not in results:
        root = Path(tempfile.mkdtemp(prefix="whole_2_layers-"))
        try:
            torch.cuda.empty_cache()
            with _SaveOnly(()):
                _run_example(FT_JOB + ["--run-dir", str(root)])
            results["whole_2_layers"] = _run_record(root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()
    return results["whole_2_layers"]


def _run_record(run_dir):
    """Losses, time_to_first_step and trace spans of a finished run."""
    from tpucfn_torch.obs.trace import read_trace_dir

    rows = [json.loads(line) for line in
            (run_dir / "logs" / "train-host000.jsonl").read_text().splitlines()]
    spans = read_trace_dir(run_dir / "trace")

    def named(name):
        return [r for r in spans if r["name"] == name]

    return {"losses": {r["step"]: r["loss"] for r in rows if "loss" in r},
            "time_to_first_step": next(r["time_to_first_step"] for r in rows
                                       if "time_to_first_step" in r),
            "step_s": [r["dur_s"] for r in named("step")],
            "step_spans": [(r["trace_id"], r["start"], r["dur_s"])
                           for r in named("step")],
            "data_wait_s": [r["dur_s"] for r in named("data_wait")],
            "ckpt_call_s": [r["dur_s"] for r in named("ckpt")],
            "ckpt_write": [{"step": r["trace_id"], "start": r["start"],
                            "s": r["dur_s"],
                            "stage_s": r["attrs"]["stage_s"],
                            "bytes": r["attrs"]["bytes"]}
                           for r in named("ckpt_write")],
            "ckpt_restore": [{"step": r["trace_id"], "s": r["dur_s"],
                              "bytes": r["attrs"]["bytes"]}
                             for r in named("ckpt_restore")]}


def phase_example_llama3_1b(results):
    """The port's example, ``python tpucfn_torch/examples/llama3_8b_fsdp.py``,
    through its ``main(argv)``: the dispatch table's family re-tuned, a
    full-depth llama3-1b run, a resume, and a packed run."""
    import shutil
    import tempfile

    import torch

    from tpucfn_torch.data import ShardedDataset
    from tpucfn_torch.kernels import flash_attention as fa
    from tpucfn_torch.kernels import flash_autotune
    from tpucfn_torch.obs.registry import default_registry

    root = Path(tempfile.mkdtemp(prefix="example_llama3_1b-"))
    free_gb = shutil.disk_usage(root).free / 1e9
    print(f"example_llama3_1b: {free_gb:.1f} GB free under {root}",
          flush=True)
    out = {"card": results.get("card"), "disk_free_gb": free_gb}
    base = ["--model", "1b", "--seq-len", "2048", "--batch-size", "2",
            "--log-every", "1"]
    try:
        # 1. the example's family, tuned now beside the committed entry
        t = flash_autotune.tune(2048, 64, persist=False)
        out["tune"] = {**t, "committed_speedup": flash_autotune.lookup_speedup(
            2048, 64, torch.bfloat16, True)}
        print(json.dumps({"example_tune": out["tune"]}), flush=True)

        # 2. full width and depth, 10 steps, the final force-save.  Two
        # examples, so every step trains on the same batch: a fresh batch
        # each step cannot show learning in a few steps (the synthetic
        # sequences follow a permutation of the 128256-token vocabulary,
        # learned pair by pair), a repeated one must.  Step 1's save (the
        # directory's first) is written while steps 2-5 run; the loop then
        # waits for it to be durable, so steps 6-10 run with no write in
        # flight.  The final force-save (18 GB more) is not made: no gate
        # reads it, and the resume below saves and restores at 2 layers.
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        _zero_launch_counts()
        with _SaveOnly({1}), _WaitForSaveBefore(6):
            text = _run_example(base + ["--steps", "10", "--num-examples",
                                        "2", "--run-dir", str(root / "full")],
                                per_step)
        results["example_launches"] = _launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rec = _run_record(root / "full")
        losses = [rec["losses"][i] for i in range(1, 11)]
        assert all(map(math.isfinite, losses)), losses
        assert losses[-1] < losses[0], losses
        expected = {k: n * 16 for k, n in LAUNCHES_PER_LAYER.items()}
        expected.update(k1_sm90=expected["k1"], k1_decode=0, k1_mma=0,
                        k1_fma=0, k2_sm90=expected["k2"], k2_mma=0, k2_fma=0,
                        k3_sm90=expected["k3"], k3_mma=0, k3_fma=0)
        assert len(per_step) == 10 and all(c == expected for c in per_step), (
            per_step, expected)
        assert peak_gib < 80, peak_gib
        # The steady steps (3 on), split by whether a checkpoint write
        # overlapped them.
        writes = [(w["start"], w["start"] + w["s"]) for w in rec["ckpt_write"]]
        windows = {True: [], False: []}
        for step, start, dur in rec["step_spans"]:
            if step >= 3:
                windows[any(a < start + dur and start < b
                            for a, b in writes)].append((step, dur))
        assert windows[False], (rec["step_spans"], writes)
        mfu = default_registry().metrics()["train_mfu"].value
        final = [line for line in text.splitlines()
                 if line.startswith("final:")][0]
        bare = results.get("train_step_ms")

        def loop(window):
            if not window:
                return None
            ms = sum(d for _, d in window) / len(window) * 1e3
            return {"steps": [s for s, _ in window], "step_ms": ms,
                    "loop_cost_ms": None if bare is None else ms - bare,
                    "tokens_per_s": 2 * 2048 / (ms / 1e3)}

        if windows[False]:
            results["example_loop_ms"] = loop(windows[False])["step_ms"]
        out["full"] = {
            "losses": losses, "launches_per_step": per_step[-1],
            "launches_expected_per_step": expected,
            "time_to_first_step_s": rec["time_to_first_step"],
            "step_ms": [x * 1e3 for x in rec["step_s"]],
            "bare_trainer_step_ms": bare,
            "loop_no_write_in_flight": loop(windows[False]),
            "loop_write_in_flight": loop(windows[True]),
            "final_line": final,
            "data_wait_ms_mean": sum(rec["data_wait_s"]) * 1e3
            / len(rec["data_wait_s"]),
            "data_wait_ms": [x * 1e3 for x in rec["data_wait_s"]],
            "mfu_gauge": mfu, "ckpt_call_s": rec["ckpt_call_s"],
            "ckpt_write": rec["ckpt_write"], "peak_mem_gib": peak_gib}
        print(json.dumps({"example_full": out["full"]}), flush=True)
        shutil.rmtree(root / "full")

        # 3. resume, at full width and 2 layers, against the uninterrupted
        # run that the ft drill's losses are held to as well: cut at step
        # 3 (its force-save, the only one made), relaunched up to step 6
        # of the same schedule (no save at the end)
        two = base + ["--layers", "2"]
        whole = _whole_2_layers(results)["losses"]
        cut = root / "cut"
        with _SaveOnly({3}):
            _run_example(FT_JOB + ["--stop-after", "3", "--run-dir",
                                   str(cut)])
        with _SaveOnly(()):
            text = _run_example(FT_JOB + ["--stop-after", "6", "--run-dir",
                                          str(cut)])
        assert "resumed from step 3" in text, text[-2000:]
        rec = _run_record(cut)
        rel = [abs(rec["losses"][i] - whole[i]) / abs(whole[i])
               for i in (4, 5, 6)]
        assert max(rel) <= EXAMPLE_LOSS_REL_TOL, (rec["losses"], whole)
        out["resume"] = {
            "resumed_at": 3, "losses_relaunch": [rec["losses"][i]
                                                 for i in (4, 5, 6)],
            "losses_uninterrupted": [whole[i] for i in (4, 5, 6)],
            "max_rel_diff": max(rel), "exactly_equal": max(rel) == 0.0,
            "rel_tol": EXAMPLE_LOSS_REL_TOL,
            "ckpt_restore": rec["ckpt_restore"],
            "ckpt_write": rec["ckpt_write"]}
        print(json.dumps({"example_resume": out["resume"]}), flush=True)
        shutil.rmtree(cut)

        # 4. packed, the kernels' segment paths in every layer
        _zero_launch_counts()
        per_step = []
        with _SegmentCalls(fa) as seg_calls:
            _run_example(two + ["--packed", "--steps", "3", "--run-dir",
                                str(root / "packed")], per_step)
        results["example_packed_launches"] = _launch_counts()
        rec = _run_record(root / "packed")
        losses = [rec["losses"][i] for i in (1, 2, 3)]
        assert all(map(math.isfinite, losses)), losses
        expected = {k: n * 2 for k, n in LAUNCHES_PER_LAYER.items()}
        expected.update(k1_sm90=expected["k1"], k1_decode=0, k1_mma=0,
                        k1_fma=0, k2_sm90=expected["k2"], k2_mma=0, k2_fma=0,
                        k3_sm90=expected["k3"], k3_mma=0, k3_fma=0)
        assert all(c == expected for c in per_step), (per_step, expected)
        # every flash call of the run carried segment ids
        assert seg_calls.count == 3 * expected["k1"], seg_calls.count
        # K1, Delta, K2 and K3 at this path's shape with its first
        # batch's segment ids, beside the other rows of their kernels
        ds = ShardedDataset(sorted((root / "packed" / "data").glob(
            "*.tpurec")), batch_size_per_process=2, seed=0)
        segments = torch.as_tensor(next(ds.batches(1))["segments"])
        timer = Timer(torch)
        fwd = _one_case(torch, timer, "packed_llama3_1b", 2, 32, 8, 64,
                        2048, 2048, torch.bfloat16, [0, 0], seg_ids=segments)
        bwd = _bwd_case(torch, timer, "packed_llama3_1b", 2, 32, 8, 64,
                        2048, 2048, torch.bfloat16, seg_ids=segments)
        assert fwd["ok"] and bwd["ok"], (fwd, bwd)
        results.setdefault("kernel_rows", []).append(fwd)
        results.setdefault("kernel_bwd_rows", []).append(bwd)
        out["packed"] = {
            "losses": losses, "launches_per_step": per_step[-1],
            "segment_flash_calls": seg_calls.count,
            "documents_per_row": [int(r.max()) for r in segments],
            "kernel_rows": {"k1": {k: fwd[k] for k in KEYS + ("variant",)},
                            **{n: {k: bwd[n][k] for k in KEYS if k in bwd[n]}
                               for n in ("delta", "dq", "dkv")}}}
        print(json.dumps({"example_packed": out["packed"]}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    return out


# ---- phase 13 --------------------------------------------------------------
# The drill: 34 steps at full width and 2 layers (fresh batches, as the
# example's resume run), a save at step 1 (the directory's first) and
# every 20.  A kill at fleet step 21 lands with step 20's write open
# (step 20's save waited for step 1's write), so the relaunch resumes
# from step 1 and runs steps 2-20 with no write in flight: the profiler
# capture (about 9 steps) goes there.  A preemption notice at fleet step
# 24 (past the 23 that the killed rank's last heartbeat can show) drains
# at fleet step + FT_DRAIN_STEP_MARGIN, and the last relaunch resumes
# there and ends at 34.
FT_STEPS, FT_CKPT_EVERY, FT_KILL_AT, FT_NOTICE_AT = 34, 20, 21, 24
# The drain's target is the coordinator's view of the fleet step plus
# this margin.  That view lags the rank: a beat every 0.5 s, read every
# 0.25 s, is up to 0.75 s old, about 3 steps at 0.24 s a step.  At the
# coordinator's default margin of 2 the rank had passed the target when
# the drain file came, and stopped at its own next step (target 28,
# stopped at 30; target 29, stopped at 30).  6 steps leave room for that
# lag and a late beat, and the target stays below FT_STEPS.
FT_DRAIN_STEP_MARGIN = 6
FT_JOB = ["--model", "1b", "--layers", "2", "--seq-len", "2048",
          "--batch-size", "2", "--steps", str(FT_STEPS), "--log-every", "1"]
# Heartbeats every 0.5 s: the monitor calls a rank dead after 6 beats'
# silence (3 s).  At 0.25 s (dead at 1.5 s) the card showed gaps of up to
# 1.145 s in the resumed ranks, too close to a false HANG verdict.
FT_HEARTBEAT_S = 0.5
# How long the coordinator waits for the drained rank's clean exit (the
# notice carries no lead time).  The drain's force-save waits for the
# write in flight and then writes its own 7.8 GB: two writes, which took
# longer than the 30 s default on the card, where the rank was stopped
# before its save was durable and the relaunch resumed a step early.
FT_DRAIN_GRACE_S = 120.0
# The no-heartbeat-yet window after each (re)launch: it must cover a
# rank's boot on the card up to its first heartbeat (torch import, the
# built kernels loaded, the runtime joined), which the phase measures
# (boot_to_first_heartbeat_s) and holds under it.
FT_STARTUP_GRACE_S = 60.0
FT_PROFILE_S = 2.0
# the four kernels of the training step, as the profiler names them
FT_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dq_sm90_kernel",
              "flash_bwd_dkv_sm90_kernel", "flash_bwd_delta_kernel")


def _print_ft_record(root):
    """After a failed launch: the coordinator's events and the ranks' rc
    files under ``root`` (which incident, verdict or exit code decided
    the launch's rc), on stderr."""
    for path in sorted([*Path(root).rglob("ft/events.jsonl"),
                        *Path(root).rglob("ft/rc/*.json")]):
        print(f"--- {path}\n{path.read_text()[-6000:]}", file=sys.stderr)


def _free_port_pair():
    """A port P with P + 1 free as well (the supervisor and rank 0)."""
    import socket

    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            port = a.getsockname()[1]
            if port > 65000:
                continue
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", port + 1))
                except OSError:
                    continue
        return port
    raise RuntimeError("no free port pair")


def _http(url, method="GET", timeout=5.0):
    import urllib.request

    req = urllib.request.Request(url, method=method,
                                 data=b"" if method == "POST" else None)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def _prometheus(text):
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name.split("{")[0]] = float(value)
    return out


class _Scraper:
    """Polls the supervisor's and rank 0's obs endpoints while the launch
    runs: ``/healthz`` of both, rank 0's ``/metrics`` (the last scrape
    of each incarnation, by pid) and ``/flightrecorder``; notes the
    checkpoint directory's entries when the coordinator's first detect event
    lands; and once, as soon as the second incarnation reports a step,
    asks rank 0 for ``POST /profile?seconds=FT_PROFILE_S`` (steps 2-20 of
    that incarnation run with no checkpoint write in flight)."""

    def __init__(self, port, ft_dir, ckpt_dir):
        import threading

        self.port, self.ft_dir, self.ckpt_dir = port, ft_dir, ckpt_dir
        self.supervisor_ok = False
        self.health = {}       # pid -> last /healthz body
        self.metrics = {}      # pid -> last /metrics values
        self.flight = {}       # pid -> hbm samples of the last ring read
        self.pids = []         # rank 0's pids in launch order
        self.ckpt_at_detect = None  # the checkpoint dir's entries
        self.profile = None
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=FT_PROFILE_S + 120)

    def _detected(self):
        try:
            text = (self.ft_dir / "events.jsonl").read_text()
        except OSError:
            return False
        return any(json.loads(line)["kind"] == "detect"
                   for line in text.splitlines() if line.strip())

    def _run(self):
        import urllib.error

        base = f"http://127.0.0.1:{self.port}"
        rank = f"http://127.0.0.1:{self.port + 1}"
        while not self._stop.is_set():
            if self.ckpt_at_detect is None and self._detected():
                self.ckpt_at_detect = sorted(
                    d.name for d in self.ckpt_dir.iterdir())
            try:
                self.supervisor_ok |= _http(base + "/healthz")[0] == 200
            except OSError:
                pass
            try:
                code, body = _http(rank + "/healthz")
                h = json.loads(body)
                pid = h["pid"]
                if pid not in self.pids:
                    self.pids.append(pid)
                if code == 200:
                    self.health[pid] = h
                if (self.profile is None and len(self.pids) == 2
                        and (h.get("step") or 0) >= 2):
                    t0 = time.time()
                    try:
                        code, body = _http(
                            rank + f"/profile?seconds={FT_PROFILE_S}",
                            "POST", timeout=FT_PROFILE_S + 120)
                    except urllib.error.HTTPError as e:  # the phase fails
                        self.profile = {"status": e.code,
                                        "error": e.read().decode()}
                    else:
                        self.profile = {"status": code, "t0": t0,
                                        "t1": time.time(), **json.loads(body)}
                self.metrics[pid] = _prometheus(_http(rank + "/metrics")[1])
                ring = json.loads(_http(rank + "/flightrecorder")[1])
                hbm = [x for x in ring["samples"] if x["kind"] == "hbm"]
                if hbm:
                    self.flight[pid] = hbm
            except OSError:
                pass  # booting, or between incarnations
            except Exception as e:  # noqa: BLE001 — reported by the phase
                self.errors.append(repr(e))
            self._stop.wait(0.25)


def _jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.strip()]


def _trace_kernels(path):
    """Device kernels of a Chrome trace, by name, and how many times."""
    counts = {}
    for e in json.loads(Path(path).read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def _steady_steps(rec, exclude=()):
    """(step, ms, write in flight) of every step but the first after a
    (re)launch or a pause of over 2 s (a save that waits for the write
    before it), minus the windows in ``exclude`` ((start, end) on the
    spans' monotonic clock, which is the machine's)."""
    writes = [(w["start"], w["start"] + w["s"]) for w in rec["ckpt_write"]]
    out, prev = [], None
    for step, start, dur in rec["step_spans"]:
        first = (prev is None or step != prev[0] + 1
                 or start - prev[1] > 2.0)
        prev = (step, start + dur)
        if first or any(a < start + dur and start < b for a, b in exclude):
            continue
        out.append((step, dur * 1e3,
                    any(a < start + dur and start < b for a, b in writes)))
    return out


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


# The goodput report's buckets sum to its wall by construction (idle and
# restart downtime are residuals); the gate allows float noise and
# records that end within a window's last instant.
GOODPUT_SUM_TOL = 0.05
# The buckets each goodput summary prints: where the loop's wall went.
GOODPUT_SHOWN = ("productive_step", "compile", "compile_cached",
                 "compile_fetched", "data_wait", "ckpt", "lost_work",
                 "restart_downtime", "idle")


def _cli_main(argv):
    """The port's CLI (``python -m tpucfn_torch.cli``) in this process:
    its exit code and standard output."""
    import contextlib
    import io

    from tpucfn_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    return rc, buf.getvalue()


def _goodput_report(run_dir):
    """``obs goodput --json`` over ``run_dir``, its buckets held to sum
    to its wall within GOODPUT_SUM_TOL."""
    rc, text = _cli_main(["obs", "goodput", "--run-dir", str(run_dir),
                          "--json"])
    report = json.loads(text)
    total = sum(report["buckets"].values())
    assert (rc == 0 and report["num_hosts"] >= 1 and report["wall_s"] > 0
            and abs(total - report["wall_s"])
            <= GOODPUT_SUM_TOL * report["wall_s"]), (rc, report)
    return report


def _goodput_summary(report):
    """Wall seconds, each shown bucket's share of it, the incidents."""
    wall = report["wall_s"]
    return {"wall_s": wall, "goodput_ratio": report["goodput_ratio"],
            "shares": {b: report["buckets"][b] / wall
                       for b in GOODPUT_SHOWN},
            "sum_over_wall": sum(report["buckets"].values()) / wall,
            "restart_downtime_s": report["restart_downtime_s"],
            "lost_steps": report["lost_steps"],
            "incidents": [{k: i[k] for k in ("incident", "action",
                                              "planned", "downtime_s")}
                          for i in report["incidents"]]}


def _render_shares(summary):
    return (f"wall {summary['wall_s']:.2f} s, " + ", ".join(
        f"{b} {v:.4f}" for b, v in summary["shares"].items() if v))


def phase_ft_llama3_1b(results):
    """``create-stack`` and ``launch --ft`` drive the port's example at
    llama3-1b width (2 layers) under the gang coordinator, in
    subprocesses: a chaos kill and relaunch, a preemption drain, the obs
    endpoints of the live rank, and a profiler capture of its kernels."""
    import os
    import shutil
    import signal
    import tempfile

    import torch

    from tpucfn_torch.ft import read_heartbeats, replay_journal
    from tpucfn_torch.obs.trace import read_trace_dir

    t_phase, wall0 = time.perf_counter(), time.time()
    root = Path(tempfile.mkdtemp(prefix="ft_llama3_1b-"))
    state, name = root / "state", "smoke"
    run_dir = state / "clusters" / name
    ft_dir = run_dir / "ft"
    out = {"card": results.get("card"), "steps": FT_STEPS,
           "ckpt_every": FT_CKPT_EVERY, "kill_at_step": FT_KILL_AT,
           "notice_at_step": FT_NOTICE_AT, "heartbeat_s": FT_HEARTBEAT_S,
           "startup_grace_s": FT_STARTUP_GRACE_S,
           "drain_grace_s": FT_DRAIN_GRACE_S,
           "drain_step_margin": FT_DRAIN_STEP_MARGIN,
           "whole_run_in_phase": "whole_2_layers" not in results}
    try:
        # 1. the uninterrupted run, planes off (the example's, when that
        # phase ran first)
        whole = _whole_2_layers(results)

        # 2. the cluster, on the fake control plane
        env = dict(os.environ, PYTHONPATH=str(HERE))
        cli = [sys.executable, "-m", "tpucfn_torch.cli", "--state-dir",
               str(state)]
        r = subprocess.run(cli + ["create-stack", "--name", name,
                                  "--accelerator", "h100-1"], env=env,
                           cwd=HERE, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0 and f"CREATE_COMPLETE {name}" in r.stdout, (
            r.stdout, r.stderr)

        # 3. launch --ft with the chaos spec, scraped while it runs
        spec = root / "chaos.json"
        spec.write_text(json.dumps({"seed": 0, "events": [
            {"action": "kill", "at_step": FT_KILL_AT, "host": 0},
            {"action": "preempt_notice", "at_step": FT_NOTICE_AT,
             "host": 0}]}))
        port = _free_port_pair()
        log_out, log_err = root / "launch.out", root / "launch.err"
        with open(log_out, "w") as fo, open(log_err, "w") as fe, \
                _Scraper(port, ft_dir, run_dir / "ckpt") as scraper:
            wall_launch = time.time()
            proc = subprocess.Popen(
                cli + ["launch", "--name", name, "--ft",
                       "--ft-restart-budget", "1",
                       "--ft-heartbeat-interval", str(FT_HEARTBEAT_S),
                       "--ft-startup-grace", str(FT_STARTUP_GRACE_S),
                       "--ft-drain-grace", str(FT_DRAIN_GRACE_S),
                       "--ft-drain-step-margin", str(FT_DRAIN_STEP_MARGIN),
                       "--obs-port", str(port), "--chaos", str(spec), "--",
                       sys.executable, "-m",
                       "tpucfn_torch.examples.llama3_8b_fsdp", *FT_JOB,
                       "--ckpt-every", str(FT_CKPT_EVERY), "--run-dir",
                       str(run_dir)],
                env=env, cwd=HERE, stdout=fo, stderr=fe,
                start_new_session=True)
            try:
                rc = proc.wait(timeout=600)
                wall_end = time.time()
            finally:
                if proc.poll() is None:
                    # the coordinator and the ranks it spawned: one group
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        stdout = log_out.read_text()
        if rc != 0 or "launch finished rc=0" not in stdout:
            print(log_err.read_text()[-6000:], file=sys.stderr)
            _print_ft_record(root)
        assert rc == 0 and "launch finished rc=0" in stdout, (
            rc, stdout[-3000:])
        assert not scraper.errors, scraper.errors

        try:
            # 4. the coordinator's record: one unplanned restart (the kill,
            # budget 1 used) and one planned drain (no budget), in that order
            ev = _jsonl(ft_dir / "events.jsonl")
            fired = [r for r in replay_journal(
                ft_dir / "journal" / "journal.jsonl")[1]
                if r["kind"] == "chaos_fired"]
            kinds = [e["kind"] for e in ev]
            decides = [e for e in ev if e["kind"] == "decide"]
            incidents = [e for e in ev if e["kind"] == "goodput_incident"]
            sup = json.loads((ft_dir / "supervisor.json").read_text())
            out["events"] = kinds
            assert [f["action"] for f in fired] == ["kill", "preempt_notice"], \
                fired
            assert [(d["action"], d["planned"]) for d in decides][:1] == [
                ("gang_restart", False)], decides
            assert sum(1 for d in decides if not d["planned"]) == 1, decides
            assert kinds.count("drain") == 1, kinds
            assert [i["planned"] for i in incidents] == [False, True], incidents
            assert sup["budget"] == {"max_restarts": 1, "used": 1}, sup["budget"]
            drain = next(e for e in ev if e["kind"] == "drain")
            detect = next(e for e in ev if e["kind"] == "detect")
            relaunch = [e["ts"] for e in ev if e["kind"] == "launch"]
            steps_seen = {"kill_fleet_step": incidents[0]["fleet_step"],
                          "notice_fleet_step": incidents[1]["fleet_step"],
                          "drain_step": drain["step"]}
            out["steps_seen"] = steps_seen
            # in time: the kill, its detect and relaunch, then the notice
            # in the second incarnation, its drain, and the end
            assert (len(relaunch) == 3
                    and fired[0]["ts"] <= detect["ts"] < relaunch[1]
                    < fired[1]["ts"] <= drain["ts"] < relaunch[2]
                    and FT_KILL_AT <= steps_seen["kill_fleet_step"]
                    and FT_NOTICE_AT <= steps_seen["notice_fleet_step"]
                    and steps_seen["drain_step"] < FT_STEPS), (
                f"events out of order: {steps_seen}, {kinds}")

            # 5. the resumes: after the kill, from the newest step finalized
            # when it landed; after the drain, from the drain's force-save
            resumed = [int(line.rsplit(" ", 1)[1]) for line in stdout.splitlines()
                       if line.startswith("resumed from step")]
            stopped = [int(line.rsplit(" ", 1)[1]) for line in stdout.splitlines()
                       if line.startswith("preemption drain: stopping cleanly")]
            at_kill = scraper.ckpt_at_detect or []
            finalized = sorted(int(n) for n in at_kill if n.isdigit())
            out.update(resumed=resumed, drain_stopped_at=stopped,
                       ckpt_dir_at_kill=at_kill)
            assert finalized and len(resumed) == 2 and len(stopped) == 1, (
                resumed, stopped, at_kill)
            assert resumed[0] > 0 and resumed[0] == finalized[-1], (
                resumed, at_kill)
            # the kill landed while step FT_CKPT_EVERY's write was open
            assert any(n.startswith(f"{FT_CKPT_EVERY}.ckpt-tmp")
                       for n in at_kill), at_kill
            # the drain's target: the fleet step it saw plus the margin
            assert drain["step"] == (steps_seen["notice_fleet_step"]
                                     + FT_DRAIN_STEP_MARGIN), steps_seen
            assert resumed[1] == stopped[0] == drain["step"], (resumed, stopped)

            # 6. the losses: every step's equal to the uninterrupted run's
            rows = _jsonl(run_dir / "logs" / "train-host000.jsonl")
            losses = {r["step"]: r["loss"] for r in rows if "loss" in r}
            steps = list(range(1, FT_STEPS + 1))
            assert sorted(losses) == steps, sorted(losses)
            rel = max(abs(losses[i] - whole["losses"][i]) / abs(whole["losses"][i])
                      for i in steps)
            out["losses"] = [losses[i] for i in steps]
            out["losses_max_rel_diff"] = rel
            assert rel <= EXAMPLE_LOSS_REL_TOL, (losses, whole["losses"])

            # 7. the live endpoints of rank 0
            assert scraper.supervisor_ok, "the supervisor's /healthz never answered"
            assert len(scraper.pids) == 3, scraper.pids
            assert any(h.get("step") for h in scraper.health.values()), \
                scraper.health
            last = scraper.metrics[scraper.pids[-1]]
            for key in ("train_last_step", "device_hbm_used_bytes",
                        "device_hbm_peak_bytes", "device_hbm_limit_bytes"):
                assert last.get(key, 0) > 0, (key, last)
            hbm = [x for samples in scraper.flight.values() for x in samples]
            assert hbm and all(x["used"] > 0 and x["limit"] > 7e10 for x in hbm), \
                hbm[:3]
            prof = scraper.profile
            assert prof and prof["status"] == 200, prof
            kernels = _trace_kernels(Path(prof["artifact"]) / "trace.json")
            named = {k: sum(n for name_, n in kernels.items() if k in name_)
                     for k in FT_KERNELS}
            assert all(named.values()), (named, sorted(kernels)[:40])
            out["profile"] = {"seconds": prof["seconds"], "dur_s": prof["dur_s"],
                              "kernels_named": named,
                              "distinct_kernels": len(kernels)}
            out["metrics_last"] = {k: v for k, v in last.items()
                                   if k.startswith(("device_hbm", "kernel_",
                                                    "train_last_step"))}
            out["hbm_samples"] = len(hbm)
            # launches on this path, exactly: every step's log row holds
            # its rank's counters so far (those launched at all), so each
            # row of each incarnation must show K1/K2/K3 sm90 and Delta at
            # 4/2/2/2 a step since its resume, and nothing else
            keys = {"k1_sm90": "kernel_launches_flash_fwd_sm90",
                    "k2_sm90": "kernel_launches_flash_bwd_dq_sm90",
                    "k3_sm90": "kernel_launches_flash_bwd_dkv_sm90",
                    "delta": "kernel_launches_flash_bwd_delta"}
            per_step = {"k1_sm90": 2 * LAUNCHES_PER_LAYER["k1"],
                        "k2_sm90": 2 * LAUNCHES_PER_LAYER["k2"],
                        "k3_sm90": 2 * LAUNCHES_PER_LAYER["k3"],
                        "delta": 2 * LAUNCHES_PER_LAYER["delta"]}
            incarnations = []
            for r in rows:
                if "time_to_first_step" in r:
                    incarnations.append([])
                elif "loss" in r:
                    incarnations[-1].append(r)
            starts = [0] + resumed
            assert len(incarnations) == 3, len(incarnations)
            for start, inc in zip(starts, incarnations):
                for r in inc:
                    got = {k: v for k, v in r.items()
                           if k.startswith("kernel_launches_")}
                    want = {m: per_step[k] * (r["step"] - start)
                            for k, m in keys.items()}
                    assert got == want, (start, r["step"], got, want)
            by_incarnation = [{k: int(inc[-1][m]) for k, m in keys.items()}
                              for inc in incarnations]
            results["ft_launches"] = {
                k: sum(c[k] for c in by_incarnation) for k in keys}
            out["launches"] = results["ft_launches"]
            out["launches_by_incarnation"] = by_incarnation
            out["steps_by_incarnation"] = [
                [inc[0]["step"], inc[-1]["step"]] for inc in incarnations]

            # 8. the heartbeats read back, ending at the final step
            hb = read_heartbeats(ft_dir)
            assert hb[0]["step"] == FT_STEPS, hb
            beats = _jsonl(ft_dir / "hb-host000.jsonl")
            # each rank's largest gap between beats, with the step its
            # beat carried before the gap (None: before its first step)
            # and the seconds from its first beat to the gap
            gaps, first_t = {}, {}
            for a, b in zip(beats, beats[1:]):
                first_t.setdefault(a["pid"], a["t"])
                if a["pid"] == b["pid"] and b["t"] - a["t"] > gaps.get(
                        a["pid"], {"s": 0.0})["s"]:
                    gaps[a["pid"]] = {"s": b["t"] - a["t"], "step": a["step"],
                                      "at_s": a["t"] - first_t[a["pid"]]}
            out["heartbeat_max_gap"] = [gaps.get(p) for p in scraper.pids]
            out["exit_after_last_beat_s"] = _exit_after_last_beat(ev, beats)
            verdicts = [e for e in ev if e["kind"] == "detect"]
            out["detect_failures"] = [f for e in verdicts for f in e["failures"]]
            # no hang or straggler verdict: the kill and the notice only
            assert [f["kind"] for f in out["detect_failures"]] == [
                "crash", "preempt"], out["detect_failures"]

            # 9. the drill's times
            launches = [e for e in ev if e["kind"] == "launch"]
            relaunch_after_drain = next(e for e in launches
                                        if e["ts"] > drain["ts"])
            kill_t, notice_t = fired[0]["ts"], fired[1]["ts"]
            after_kill = next(r for r in rows if "loss" in r
                              and r["time"] > kill_t
                              and r["step"] == resumed[0] + 1)
            first_beat = {}
            for b in beats:
                first_beat.setdefault(b["pid"], b["t"])
            boots = [first_beat[pid] - e["ts"]
                     for e in launches for pid in e["pids"] if pid in first_beat]
            out["detect_latency_s"] = detect["ts"] - kill_t
            out["time_to_recover_s"] = after_kill["time"] - kill_t
            out["drain_latency_s"] = relaunch_after_drain["ts"] - notice_t
            # where the phase's wall time goes (the checks after the
            # launch are the rest of phase_s)
            starts = [e["ts"] for e in launches]
            out["wall_s"] = {
                "before_launch": wall_launch - wall0,
                "launch_to_first_rank": starts[0] - wall_launch,
                "first_incarnation": kill_t - starts[0],
                "kill_to_relaunch": starts[1] - kill_t,
                "second_incarnation": notice_t - starts[1],
                "notice_to_relaunch": starts[2] - notice_t,
                "last_incarnation": wall_end - starts[2]}
            out["notice_to_drain_file_s"] = drain["ts"] - notice_t
            out["boot_to_first_heartbeat_s"] = boots
            out["time_to_first_step_s"] = [r["time_to_first_step"] for r in rows
                                           if "time_to_first_step" in r]
            assert max(boots) < FT_STARTUP_GRACE_S, boots
            rec = _run_record(run_dir)
            spans = read_trace_dir(run_dir / "trace")
            capture = [(r["start"], r["start"] + r["dur_s"]) for r in spans
                       if r["name"] == "profile_capture"]
            # The killed rank's last write never ended, so it left no
            # ckpt_write span: its steps (all with a write in flight) are
            # left out, from the relaunch on (the first step whose number
            # falls) the writes are known.
            order = sorted(rec["step_spans"], key=lambda x: x[1])
            relaunched = next(i for i in range(1, len(order))
                              if order[i][0] <= order[i - 1][0])
            rec = dict(rec, step_spans=order[relaunched:])
            planes_on = _steady_steps(rec, exclude=capture)
            planes_off = _steady_steps(whole)
            in_capture = [x for x in _steady_steps(rec)
                          if x not in planes_on]
            on_free = _mean([ms for _, ms, w in planes_on if not w])
            off_free = _mean([ms for _, ms, w in planes_off if not w])
            cap_mean = _mean([ms for _, ms, _ in in_capture])
            # the capture ran where no write was in flight: its steps are
            # held to the write-free steps outside it
            assert (len(capture) == 1 and len(in_capture) >= 4
                    and not any(w for _, _, w in in_capture)), (
                capture, in_capture, rec["ckpt_write"])
            out["step_ms"] = {
                "planes_on_no_write": on_free,
                "planes_on_write_in_flight": _mean(
                    [ms for _, ms, w in planes_on if w]),
                "planes_off_no_write": off_free,
                "planes_cost_ms": (None if on_free is None or off_free is None
                                   else on_free - off_free),
                "planes_on_steps": planes_on, "planes_off_steps": planes_off,
                "example_llama3_1b_16_layers": (results.get("example_loop_ms")),
                "in_capture": in_capture, "in_capture_mean": cap_mean,
                "capture_cost_ms": (None if on_free is None
                                    else cap_mean - on_free)}

            # 10. the read side over the drill's run dir: the goodput
            # report (the kill's downtime attributed to its incident),
            # the kill's postmortem bundle, the critical path and the
            # merged Chrome trace
            kill_incident = incidents[0]["incident"]
            report = _goodput_report(run_dir)
            kill_row = next(i for i in report["incidents"]
                            if i["incident"] == kill_incident)
            assert report["restart_downtime_s"] > 0, report
            assert (kill_row["downtime_s"] or 0) > 0 \
                and not kill_row["planned"], kill_row
            rc, pm = _cli_main(["obs", "postmortem", "--run-dir",
                                str(run_dir), "--incident",
                                str(kill_incident), "--json"])
            pm = json.loads(pm)
            bundle = Path(pm["bundle"])
            pm_detect = next(e for e in pm["events"]
                             if e["kind"] == "detect")
            assert (rc == 0 and (bundle / "incident.json").is_file()
                    and (bundle / "report.md").is_file()
                    and pm["incident"]["incident"] == kill_incident
                    and [f["host"] for f in pm_detect["failures"]] == [0]), (
                rc, sorted(p.name for p in bundle.iterdir()),
                pm["incident"], pm_detect)
            rc, cp = _cli_main(["trace", "critpath", "--run-dir",
                                str(run_dir), "--json"])
            cp = json.loads(cp)
            assert rc == 0 and any(r["compute"] > 0 for r in cp["steps"]), cp
            rc, ex_out = _cli_main(["trace", "export", "--run-dir",
                                    str(run_dir), "--json"])
            exported = json.loads(ex_out)
            chrome = json.loads(Path(exported["out"]).read_text())
            assert rc == 0 and chrome["traceEvents"], exported
            out["read_side"] = {
                "goodput": _goodput_summary(report),
                "kill_incident": kill_row,
                "postmortem": {"bundle_files": sorted(
                    p.name for p in bundle.iterdir()),
                    "timeline_events": len(pm["timeline"]),
                    "flight_rows": len(pm["flight"]),
                    "notes": pm["notes"]},
                "critpath": {"steps": len(cp["steps"]),
                             "shares": cp["shares"],
                             "coverage_median": cp["coverage_median"],
                             "crosscheck": cp["crosscheck"]},
                "chrome_trace_events": len(chrome["traceEvents"])}
        except Exception:
            # what the coordinator and the rank said, for the failure
            for path in (ft_dir / "events.jsonl", log_out):
                if path.exists():
                    print(f"--- {path.name}\n{path.read_text()[-8000:]}",
                          file=sys.stderr)
            print(json.dumps({"ft_llama3_1b_partial": out}, default=str),
                  file=sys.stderr)
            raise
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"ft_llama3_1b on {results.get('card')}: detect "
              f"{out['detect_latency_s']:.3f} s, recover "
              f"{out['time_to_recover_s']:.2f} s, drain "
              f"{out['drain_latency_s']:.2f} s, step ms planes on/off "
              f"{out['step_ms']['planes_on_no_write']:.2f}/"
              f"{out['step_ms']['planes_off_no_write']:.2f}, in capture "
              f"{cap_mean:.2f}, phase {out['phase_s']:.1f} s", flush=True)
        print(f"ft_llama3_1b goodput on {results.get('card')}: "
              + _render_shares(out["read_side"]["goodput"]), flush=True)
        print(json.dumps({"ft_llama3_1b": out}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 14 --------------------------------------------------------------
# The launch planes at llama3-1b width (FT_JOB, 2 layers).  (a) a cold
# fleet: every kernel library the path loads built once with nvcc and
# published; (b) a warm fleet on two hosts, every library fetched, the
# batches served by an input host through a chaos proxy until a trickle
# there degrades the stream to local loading, then a coordinator kill the
# supervisor recovers by adoption.
PLANES_COLD_STEPS = 3
# the libraries the training step loads (K1, Delta, K2 and K3 sm90)
PLANES_LIBRARIES = ("flash_fwd_sm90", "flash_bwd", "flash_bwd_dq_sm90",
                    "flash_bwd_dkv_sm90")
# The trickle at fleet step 3; the coordinator kill at fleet step 30, when
# the stream has long degraded (the gate checks the order).
PLANES_THROTTLE_AT, PLANES_KILL_AT = 3, 30
PLANES_TRICKLE_BPS = 64.0
# Before the trickle the proxy paces the link: on loopback the proxy's send
# buffer grows to megabytes, so an unpaced link holds ~240 of these 16 KB
# batches ahead of the trainer (measured on the CPU), more than the run, and
# a trickle would never reach it.  Until the fleet's step 1 the trainer
# takes one batch, so whatever else the link carries then waits in its
# buffers and holds the degrade back by as many steps.  On an H100 80GB
# HBM3 at 700 W, at 1.5x the steady rate from the start, runs held 26-37
# batches past the trickle's step, by how long the first step took, and
# one degraded only at batch 41, past the run's 34 steps and the
# coordinator kill; at 2 batches a second until step 1, 12-25, and at 1.5,
# 13-18.  So until step 1 the link carries
# 1.5 batches a second (two thirds of a second a batch, a third of the op
# deadline), and from step 1 on 1.5x the rate the trainer consumes batches
# (one a steady step of the uninterrupted run) keeps it ahead of the loop.
PLANES_STARTUP_BATCHES_PER_S = 1.5
PLANES_PACE = 1.5
PLANES_OP_DEADLINE_S = 2.0   # the trainer's end-to-end deadline per batch
PLANES_DEGRADE_GATE_S = 10.0  # trickle to degraded (the reference's gate)
PLANES_RCVBUF = 64 * 1024
PLANES_BATCH_BYTES = 2 * 2048 * 4  # one served batch: 2 x 2048 int32 tokens


def _free_ports(n):
    """``n`` distinct free ports."""
    import socket

    out = []
    while len(out) < n:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            p = s.getsockname()[1]
        if p not in out:
            out.append(p)
    return out


def _cache_counts(row):
    return {k.removeprefix("compilecache_").removesuffix("_total"): v
            for k, v in row.items()
            if k.startswith("compilecache_") or k == "kernel_nvcc_runs"}


def _launches_each_step(rows, start=0):
    """Every loss row's kernel launches so far against 4/2/2/2 K1/K2/K3
    sm90/Delta a step since ``start``."""
    keys = {"kernel_launches_flash_fwd_sm90": 2 * LAUNCHES_PER_LAYER["k1"],
            "kernel_launches_flash_bwd_dq_sm90": 2 * LAUNCHES_PER_LAYER["k2"],
            "kernel_launches_flash_bwd_dkv_sm90": 2 * LAUNCHES_PER_LAYER["k3"],
            "kernel_launches_flash_bwd_delta":
                2 * LAUNCHES_PER_LAYER["delta"]}
    for r in rows:
        if "loss" not in r:
            continue
        got = {k: v for k, v in r.items() if k.startswith("kernel_launches_")}
        want = {k: n * (r["step"] - start) for k, n in keys.items()}
        assert got == want, (r["step"], got, want)
    last = [r for r in rows if "loss" in r][-1]
    return {"k1_sm90": int(last["kernel_launches_flash_fwd_sm90"]),
            "k2_sm90": int(last["kernel_launches_flash_bwd_dq_sm90"]),
            "k3_sm90": int(last["kernel_launches_flash_bwd_dkv_sm90"]),
            "delta": int(last["kernel_launches_flash_bwd_delta"])}


def phase_planes_llama3_1b(results):
    """(a) ``launch --compile-cache`` on ``h100-1`` with an empty kernel
    directory; (b) ``create-stack --accelerator h100-2`` and ``launch --ft
    --supervise --compile-cache --input-hosts 1 --chaos-proxy --chaos``,
    in subprocesses, the example at llama3-1b width (2 layers)."""
    import os
    import shutil
    import signal
    import statistics
    import tempfile

    from tpucfn_torch.examples import llama3_8b_fsdp as ex
    from tpucfn_torch.ft import replay_journal
    from tpucfn_torch.kernels import _build
    from tpucfn_torch.obs.trace import read_trace_dir

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="planes_llama3_1b-"))
    build_dir = _build.BUILD_DIR
    aside = build_dir.with_name(build_dir.name + ".planes-aside")
    out = {"card": results.get("card"), "libraries": list(PLANES_LIBRARIES),
           "throttle_at_step": PLANES_THROTTLE_AT,
           "kill_coordinator_at_step": PLANES_KILL_AT,
           "op_deadline_s": PLANES_OP_DEADLINE_S,
           "whole_run_in_phase": "whole_2_layers" not in results}
    cli = [sys.executable, "-m", "tpucfn_torch.cli"]
    env = dict(os.environ, PYTHONPATH=str(HERE))
    env.pop("TPUCFN_INPUT_ADDRS", None)

    def launch(state, argv, log, env_extra, timeout):
        with open(log.with_suffix(".out"), "w") as fo, \
                open(log.with_suffix(".err"), "w") as fe:
            proc = subprocess.Popen(
                cli + ["--state-dir", str(state), *argv],
                env={**env, **env_extra}, cwd=HERE, stdout=fo, stderr=fe,
                start_new_session=True)
            try:
                rc = proc.wait(timeout=timeout)
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        stdout = log.with_suffix(".out").read_text()
        if rc != 0 or "launch finished rc=0" not in stdout:
            print(log.with_suffix(".err").read_text()[-6000:],
                  file=sys.stderr)
            _print_ft_record(state)
        assert rc == 0 and "launch finished rc=0" in stdout, (
            rc, stdout[-3000:])
        return stdout

    try:
        whole = _whole_2_layers(results)
        steady = sorted(whole["step_s"][2:])
        step_s = statistics.median(steady)
        pace_bps = PLANES_PACE * PLANES_BATCH_BYTES / step_s
        out.update(whole_step_s=step_s, pace_bps=pace_bps)
        build_dir.mkdir(parents=True, exist_ok=True)
        os.replace(build_dir, aside)  # the build phase's libraries
        # the artifact servers of (a) and (b), the proxy, and the input
        # host's port (host 1 binds the base + 1)
        cc_a, cc_b, proxy_port, input_port = _free_ports(4)
        input_base = input_port - 1
        artifacts = root / "artifacts"

        # (a) the cold fleet: one host, nothing built, nothing published
        state_a, name_a = root / "state-a", "cold"
        run_a = state_a / "clusters" / name_a
        r = subprocess.run(cli + ["--state-dir", str(state_a), "create-stack",
                                  "--name", name_a, "--accelerator", "h100-1"],
                           env=env, cwd=HERE, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, (r.stdout, r.stderr)
        job_a = list(FT_JOB)
        job_a[job_a.index("--steps") + 1] = str(PLANES_COLD_STEPS)
        wall_a = time.time()
        launch(state_a, ["launch", "--name", name_a, "--compile-cache",
                         "--compile-cache-dir", str(artifacts),
                         "--compile-cache-port", str(cc_a), "--",
                         *NO_SAVE_EXAMPLE, *job_a,
                         "--ckpt-every", "1000", "--run-dir", str(run_a)],
               root / "launch-a",
               {"TPUCFN_COMPILE_CACHE_DIR": str(root / "store-a")}, 900)
        out["cold_wall_s"] = time.time() - wall_a
        rows_a = _jsonl(run_a / "logs" / "train-host000.jsonl")
        losses_a = [r["loss"] for r in rows_a if "loss" in r]
        assert len(losses_a) == PLANES_COLD_STEPS and all(
            math.isfinite(v) for v in losses_a), losses_a
        cold = _cache_counts([r for r in rows_a if "loss" in r][-1])
        built = sorted(p.name.rsplit("-", 1)[0]
                       for p in build_dir.glob("*.so"))
        out["cold"] = {"counters": cold, "built": built, "losses": losses_a,
                       "launches": _launches_each_step(rows_a)}
        n = len(PLANES_LIBRARIES)
        assert built == sorted(PLANES_LIBRARIES), built
        assert (cold["compiles"], cold["client_publishes"],
                cold["fetch_hits"], cold["kernel_nvcc_runs"]) == (n, n, 0, n), \
            cold
        spans_a = read_trace_dir(run_a / "trace")
        builds = {s["attrs"]["library"]: s["dur_s"] for s in spans_a
                  if s["name"] == "kernel_build"}
        assert sorted(builds) == sorted(PLANES_LIBRARIES), builds
        out["cold"]["build_s"] = builds
        out["cold"]["time_to_first_step"] = next(
            r["time_to_first_step"] for r in rows_a
            if "time_to_first_step" in r)

        # (b) the warm fleet: two hosts, the kernel directory empty again
        shutil.rmtree(build_dir, ignore_errors=True)
        state_b, name_b = root / "state-b", "planes"
        run_b = state_b / "clusters" / name_b
        ft_dir = run_b / "ft"
        r = subprocess.run(cli + ["--state-dir", str(state_b), "create-stack",
                                  "--name", name_b, "--accelerator", "h100-2"],
                           env=env, cwd=HERE, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, (r.stdout, r.stderr)
        # the shards the input host serves and the trainer falls back to,
        # staged before either starts, as the example stages them
        args_b = ex.build_parser().parse_args(
            FT_JOB + ["--run-dir", str(run_b)])
        shards = ex.stage_data(args_b, ex.model_config(args_b), run_b)
        startup_bps = PLANES_STARTUP_BATCHES_PER_S * PLANES_BATCH_BYTES
        out["startup_bps"] = startup_bps
        spec = {"seed": 0, "events": [
            {"action": "net_throttle", "at_s": 0, "rate_bps": startup_bps,
             "duration_s": 3600},
            {"action": "net_throttle", "at_step": 1, "rate_bps": pace_bps,
             "duration_s": 3600},
            {"action": "net_throttle", "at_step": PLANES_THROTTLE_AT,
             "rate_bps": PLANES_TRICKLE_BPS, "duration_s": 3600},
            {"action": "kill_coordinator", "at_step": PLANES_KILL_AT}]}
        serve = (f"{sys.executable} -m tpucfn_torch.cli data serve --shards "
                 f"{shards[0].parent} --batch-size 2 --host 127.0.0.1 "
                 "--idle-exit 2 --queue-batches 1 --sndbuf-kb 64")
        wall_b = time.time()
        stdout_b = launch(
            state_b,
            ["launch", "--name", name_b, "--ft", "--supervise",
             "--supervise-restarts", "1", "--ft-restart-budget", "0",
             "--ft-heartbeat-interval", str(FT_HEARTBEAT_S),
             "--ft-startup-grace", str(FT_STARTUP_GRACE_S),
             "--compile-cache", "--compile-cache-dir", str(artifacts),
             "--compile-cache-port", str(cc_b),
             "--input-hosts", "1", "--input-port", str(input_base),
             "--input-cmd", serve,
             "--chaos-proxy", f"{proxy_port}:127.0.0.1:{input_port}",
             "--chaos", json.dumps(spec), "--",
             # the trainer reaches its input host through the proxy
             "env", f"TPUCFN_INPUT_ADDRS=127.0.0.1:{proxy_port}",
             f"TPUCFN_INPUT_OP_DEADLINE_S={PLANES_OP_DEADLINE_S}",
             f"TPUCFN_INPUT_RCVBUF={PLANES_RCVBUF}",
             # with its saves: the final one keeps the rank alive past
             # the coordinator's restart, which must find it to adopt
             sys.executable, "-m", "tpucfn_torch.examples.llama3_8b_fsdp",
             *FT_JOB, "--ckpt-every", "1000", "--run-dir", str(run_b)],
            root / "launch-b",
            {"TPUCFN_COMPILE_CACHE_DIR": str(root / "store-b")}, 900)
        out["warm_wall_s"] = time.time() - wall_b
        try:
            rows = _jsonl(run_b / "logs" / "train-host000.jsonl")
            loss_rows = [r for r in rows if "loss" in r]
            warm = _cache_counts(loss_rows[-1])
            out["warm"] = {"counters": warm}
            # every library fetched: no build, no nvcc
            assert (warm["fetch_hits"], warm["compiles"],
                    warm["kernel_nvcc_runs"], warm["store_hits"],
                    warm["kernel_dir_hits"]) == (n, 0, 0, 0, 0), warm
            assert not [p for p in build_dir.glob("*.so")
                        if p.name.rsplit("-", 1)[0] not in PLANES_LIBRARIES]
            spans = read_trace_dir(run_b / "trace")
            fetches = {s["attrs"]["label"]: s["dur_s"] for s in spans
                       if s["name"] == "compile_fetch"}
            assert sorted(fetches) == sorted(PLANES_LIBRARIES), fetches
            out["warm"]["fetch_s"] = fetches
            out["warm"]["time_to_first_step"] = next(
                r["time_to_first_step"] for r in rows
                if "time_to_first_step" in r)

            # the coordinator: one launch, killed, restarted by the
            # supervisor, adopting the rank: no gang restart, no budget
            ev = _jsonl(ft_dir / "events.jsonl")
            kinds = [e["kind"] for e in ev]
            out["events"] = kinds
            assert kinds.count("launch") == 1 and "decide" not in kinds, kinds
            assert [k for k in kinds if k.startswith("coordinator_")] == [
                "coordinator_killed", "coordinator_restarted",
                "coordinator_adopted"], kinds
            killed = next(e for e in ev if e["kind"] == "coordinator_killed")
            adopted = next(e for e in ev if e["kind"] == "coordinator_adopted")
            assert adopted["budget_used"] == 0 and 0 in adopted["hosts"], \
                adopted
            sup = json.loads((ft_dir / "supervisor.json").read_text())
            assert sup["budget"]["used"] == 0, sup["budget"]
            rank_pid = next(e for e in ev if e["kind"] == "launch")["pids"][0]
            beats = _jsonl(ft_dir / "hb-host000.jsonl")
            assert {b["pid"] for b in beats} == {rank_pid}, (
                rank_pid, {b["pid"] for b in beats})
            out["exit_after_last_beat_s"] = _exit_after_last_beat(ev, beats)
            fired = [r for r in replay_journal(
                ft_dir / "journal" / "journal.jsonl")[1]
                if r["kind"] == "chaos_fired"]
            assert [f["action"] for f in fired] == [
                "net_throttle", "net_throttle", "net_throttle",
                "kill_coordinator"], fired

            # the input plane: served until the trickle, then local from
            # the exact cursor, inside the deadline's gate
            faults = [e for e in ev if e["kind"] == "chaos_net_fault"]
            degraded = [r for r in rows if "input_degraded_cursor" in r]
            assert len(faults) == 3 and len(degraded) == 1, (faults, degraded)
            trickle_t = faults[2]["ts"]
            deg = degraded[0]
            cursor = int(deg["input_degraded_cursor"])
            served = [json.loads(line) for line in stdout_b.splitlines()
                      if line.startswith('{"served_s"')]
            assert served and served[0]["connections"] >= 1, served
            latency = deg["input_degraded_wall"] - trickle_t
            out["input"] = {
                "degrade_latency_s": latency, "degraded_at_batch": cursor,
                "service": served[0],
                "trickle_after_step": max(
                    [r["step"] for r in loss_rows if r["time"] <= trickle_t],
                    default=0),
                "degraded_log_step": deg["step"]}
            assert 0 < latency <= PLANES_DEGRADE_GATE_S, latency
            assert PLANES_THROTTLE_AT <= cursor < FT_STEPS, cursor
            assert served[0]["batches_streamed"] >= cursor, served
            assert deg["input_degraded_wall"] < killed["ts"], (
                deg, killed)
            waits = {r["trace_id"]: r["dur_s"] for r in spans
                     if r["name"] == "data_wait"}
            out["input"]["data_wait_ms"] = {
                "served": _mean([1e3 * w for s, w in waits.items()
                                 if 1 < s <= cursor]),
                "local": _mean([1e3 * w for s, w in waits.items()
                                if s > cursor + 1]),
                "whole_run_local": _mean([1e3 * w for w in
                                          whole["data_wait_s"][1:]])}
            # how long the link ran at the startup pace: the first step
            out["input"]["first_step_s"] = next(
                (s["dur_s"] for s in spans
                 if s["name"] == "step" and s["trace_id"] == 1), None)
            out["coordinator_downtime_s"] = adopted["ts"] - killed["ts"]

            # the losses: every step's within 1e-3 of the uninterrupted run
            losses = {r["step"]: r["loss"] for r in loss_rows}
            steps = list(range(1, FT_STEPS + 1))
            assert sorted(losses) == steps, sorted(losses)
            rel = max(abs(losses[i] - whole["losses"][i])
                      / abs(whole["losses"][i]) for i in steps)
            out["losses_max_rel_diff"] = rel
            assert rel <= EXAMPLE_LOSS_REL_TOL, (losses, whole["losses"])
            # 4/2/2/2 K1/K2/K3 sm90/Delta every step, from step 0
            results["planes_launches"] = _launches_each_step(rows)
            out["launches"] = results["planes_launches"]
        except Exception:
            for path in (ft_dir / "events.jsonl",
                         root / "launch-b.out", root / "launch-b.err"):
                if path.exists():
                    print(f"--- {path.name}\n{path.read_text()[-8000:]}",
                          file=sys.stderr)
            print(json.dumps({"planes_llama3_1b_partial": out}, default=str),
                  file=sys.stderr)
            raise
        out["build_s_saved"] = (sum(out["cold"]["build_s"].values())
                                - sum(out["warm"]["fetch_s"].values()))
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"planes_llama3_1b on {results.get('card')}: time_to_first_step "
              f"cold {out['cold']['time_to_first_step']} s / warm "
              f"{out['warm']['time_to_first_step']} s, build "
              f"{sum(out['cold']['build_s'].values()):.2f} s against fetch "
              f"{sum(out['warm']['fetch_s'].values()):.3f} s, degrade "
              f"{out['input']['degrade_latency_s']:.2f} s at batch "
              f"{out['input']['degraded_at_batch']}, coordinator down "
              f"{out['coordinator_downtime_s']:.2f} s, phase "
              f"{out['phase_s']:.1f} s", flush=True)
        print(json.dumps({"planes_llama3_1b": out}), flush=True)
    finally:
        if aside.exists():
            shutil.rmtree(build_dir, ignore_errors=True)
            os.replace(aside, build_dir)
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 15: the provisioner policy loop ----------------------------------
# FT_JOB (llama3-1b width, 2 layers, 34 steps, no checkpoint write before
# the end) on h100-2: one trainer served by one input host, the
# coordinator running the goodput policy every PROVISION_INTERVAL_S.  The
# served trainer's data_wait share sits under the shrink threshold, so the
# policy calls the fleet data_rich and stops the input host; the cooldown
# keeps that the run's one actuation.  The threshold is the drill's, not
# the reference's default of 0.02: the share is mostly the first batch's
# wait (0.25-0.40 s) over a window that grows with the run, and on an
# NVIDIA H100 80GB HBM3 at 700.00 W it crossed 0.02 only at
# 0.0166-0.0197, some runs 13-15 steps in;
# a run whose share stayed above 0.02 through all 34 steps reached 0.02
# only during the final save, after the trainer had closed its stream
# and the input host had left (--idle-exit), so its shrink had no host
# to stop.  At 0.1 the first batch's wait would have to pass ~2.5 s.
# The input link's buffers are bounded as the planes drill bounds them
# (one queued batch, 64 KB socket buffers a side): with the kernel's
# default loopback buffers the stream can hold the whole run's batches
# ahead of the loop, and a trainer that never reads past them never sees
# its input host go.  So the degrade lands about 20 batches (buffers
# and prefetchers) after the shrink, inside the run.
PROVISION_INTERVAL_S = 1.0
PROVISION_COOLDOWN_S = 300.0
PROVISION_SHRINK_THRESHOLD = 0.1
# The buckets whose shares the phase prints before and after the shrink.
PROVISION_BUCKETS = ("step", "compile", "compile_cached", "data_wait",
                     "ckpt")


def _ledger_shares(records, lo, hi):
    """Each bucket's seconds over ``[lo, hi)`` (phase records by the time
    they were stamped, at the phase's end) as a share of ``hi - lo``."""
    wall = hi - lo
    sums = dict.fromkeys(PROVISION_BUCKETS, 0.0)
    for r in records:
        if r["kind"] == "phase" and lo <= r["t"] < hi \
                and r["bucket"] in sums:
            sums[r["bucket"]] += r["dur_s"]
    return {"wall_s": wall, "steps": sum(
        1 for r in records if r["kind"] == "phase" and lo <= r["t"] < hi
        and r["bucket"] in ("step", "compile", "compile_cached")),
        **{b: v / wall for b, v in sums.items()}}


def phase_provision_llama3_1b(results):
    """``create-stack --accelerator h100-2`` and ``launch --ft
    --input-hosts 1 --provision-policy goodput``, in subprocesses, the
    example at llama3-1b width (2 layers) fed by the input host: the
    policy's one shrink, the stream's degrade to local loading at the
    exact cursor, no restart; then ``obs goodput`` over the run."""
    import os
    import shutil
    import signal
    import tempfile

    from tpucfn_torch.examples import llama3_8b_fsdp as ex

    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="provision_llama3_1b-"))
    state, name = root / "state", "provision"
    run_dir = state / "clusters" / name
    ft_dir = run_dir / "ft"
    out = {"card": results.get("card"), "steps": FT_STEPS,
           "provision_interval_s": PROVISION_INTERVAL_S,
           "provision_cooldown_s": PROVISION_COOLDOWN_S,
           "shrink_threshold": PROVISION_SHRINK_THRESHOLD,
           "whole_run_in_phase": "whole_2_layers" not in results}
    cli = [sys.executable, "-m", "tpucfn_torch.cli", "--state-dir",
           str(state)]
    env = dict(os.environ, PYTHONPATH=str(HERE))
    env.pop("TPUCFN_INPUT_ADDRS", None)
    log_out, log_err = root / "launch.out", root / "launch.err"
    try:
        whole = _whole_2_layers(results)
        r = subprocess.run(cli + ["create-stack", "--name", name,
                                  "--accelerator", "h100-2"], env=env,
                           cwd=HERE, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, (r.stdout, r.stderr)
        # the shards the input host serves and the trainer falls back to,
        # staged before either starts, as the example stages them
        args = ex.build_parser().parse_args(
            FT_JOB + ["--run-dir", str(run_dir)])
        shards = ex.stage_data(args, ex.model_config(args), run_dir)
        input_base = _free_ports(1)[0] - 1  # host 1 binds the base + 1
        serve = (f"{sys.executable} -m tpucfn_torch.cli data serve --shards "
                 f"{shards[0].parent} --batch-size {args.batch_size} "
                 "--host 127.0.0.1 --idle-exit 2 --queue-batches 1 "
                 "--sndbuf-kb 64")
        wall0 = time.time()
        with open(log_out, "w") as fo, open(log_err, "w") as fe:
            proc = subprocess.Popen(
                cli + ["launch", "--name", name, "--ft",
                       "--ft-restart-budget", "0",
                       "--ft-heartbeat-interval", str(FT_HEARTBEAT_S),
                       "--ft-startup-grace", str(FT_STARTUP_GRACE_S),
                       "--input-hosts", "1", "--input-port", str(input_base),
                       "--input-cmd", serve,
                       "--provision-policy", "goodput",
                       "--provision-interval", str(PROVISION_INTERVAL_S),
                       "--provision-cooldown", str(PROVISION_COOLDOWN_S),
                       "--provision-shrink-threshold",
                       str(PROVISION_SHRINK_THRESHOLD),
                       "--", "env", f"TPUCFN_INPUT_RCVBUF={PLANES_RCVBUF}",
                       sys.executable, "-m",
                       "tpucfn_torch.examples.llama3_8b_fsdp", *FT_JOB,
                       "--ckpt-every", "1000", "--run-dir", str(run_dir)],
                env=env, cwd=HERE, stdout=fo, stderr=fe,
                start_new_session=True)
            try:
                rc = proc.wait(timeout=600)
            finally:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        out["launch_wall_s"] = time.time() - wall0
        stdout = log_out.read_text()
        if rc != 0 or "launch finished rc=0" not in stdout:
            print(log_err.read_text()[-6000:], file=sys.stderr)
            _print_ft_record(root)
        assert rc == 0 and "launch finished rc=0" in stdout, (
            rc, stdout[-3000:])
        try:
            # the coordinator: one decision, a data_rich shrink, and no
            # restart of the trainer
            ev = _jsonl(ft_dir / "events.jsonl")
            kinds = [e["kind"] for e in ev]
            out["events"] = kinds
            decisions = [e for e in ev if e["kind"] == "provision_decision"]
            assert [(d["action"], d["signal"]) for d in decisions] == [
                ("shrink_input_hosts", "data_rich")], decisions
            decision = decisions[0]
            out["decision"] = decision
            assert decision["data_wait_share"] < PROVISION_SHRINK_THRESHOLD, \
                decision
            actuated = next(e for e in ev if e["kind"] == "provision_actuated")
            assert actuated["action"] == "shrink_input_hosts", actuated
            sup = json.loads((ft_dir / "supervisor.json").read_text())
            metrics = sup["metrics"]
            out["provision_metrics"] = {k: v for k, v in metrics.items()
                                        if k.startswith("provision_")}
            assert (metrics.get("provision_shrink_total"),
                    metrics.get("provision_grow_total", 0)) == (1, 0), metrics
            assert (kinds.count("launch") == 1 and "decide" not in kinds
                    and "drain" not in kinds), kinds
            assert sup["budget"]["used"] == 0, sup["budget"]
            rank_pid = next(e for e in ev if e["kind"] == "launch")["pids"][0]
            beats = _jsonl(ft_dir / "hb-host000.jsonl")
            assert {b["pid"] for b in beats} == {rank_pid}, (
                rank_pid, {b["pid"] for b in beats})
            out["exit_after_last_beat_s"] = _exit_after_last_beat(ev, beats)

            # the input plane: served until the shrink, then local from
            # the exact cursor, once
            rows = _jsonl(run_dir / "logs" / "train-host000.jsonl")
            loss_rows = [r for r in rows if "loss" in r]
            degraded = [r for r in rows if "input_degraded_cursor" in r]
            served = [json.loads(line) for line in stdout.splitlines()
                      if line.startswith('{"served_s"')]
            assert len(degraded) == 1, degraded
            deg = degraded[0]
            assert deg["input_degraded_wall"] >= decision["ts"], (
                deg, decision)
            assert served and served[0]["connections"] >= 1 \
                and served[0]["batches_streamed"] >= 1, served
            out["input"] = {
                "degraded_at_batch": int(deg["input_degraded_cursor"]),
                "degraded_log_step": deg["step"],
                "degrade_after_decision_s":
                    deg["input_degraded_wall"] - decision["ts"],
                "decision_after_launch_s": decision["ts"] - wall0,
                "service": served[0],
                "steps_before_decision": sum(
                    1 for r in loss_rows if r["time"] <= decision["ts"])}

            # the losses: every step's within 1e-3 of the uninterrupted run
            losses = {r["step"]: r["loss"] for r in loss_rows}
            steps = list(range(1, FT_STEPS + 1))
            assert sorted(losses) == steps, sorted(losses)
            rel = max(abs(losses[i] - whole["losses"][i])
                      / abs(whole["losses"][i]) for i in steps)
            out["losses_max_rel_diff"] = rel
            assert rel <= EXAMPLE_LOSS_REL_TOL, (losses, whole["losses"])
            # 4/2/2/2 K1/K2/K3 sm90/Delta every step, from step 0
            results["provision_launches"] = _launches_each_step(rows)
            out["launches"] = results["provision_launches"]

            # where the loop's wall went, by the goodput ledger: the whole
            # run (obs goodput), and before and after the shrink
            report = _goodput_report(run_dir)
            out["goodput"] = _goodput_summary(report)
            ledger = _jsonl(run_dir / "goodput" / "goodput-host000.jsonl")
            t_open = ledger[0]["t"]
            t_end = ledger[-1]["t"]
            out["shares_before_shrink"] = _ledger_shares(
                ledger, t_open, actuated["ts"])
            out["shares_after_shrink"] = _ledger_shares(
                ledger, actuated["ts"], t_end + 1e-9)
        except Exception:
            for path in (ft_dir / "events.jsonl", log_out, log_err):
                if path.exists():
                    print(f"--- {path.name}\n{path.read_text()[-8000:]}",
                          file=sys.stderr)
            print(json.dumps({"provision_llama3_1b_partial": out},
                             default=str), file=sys.stderr)
            raise
        out["phase_s"] = time.perf_counter() - t_phase
        before, after = out["shares_before_shrink"], out["shares_after_shrink"]
        print(f"provision_llama3_1b on {results.get('card')}: shrink at "
              f"data_wait share {decision['data_wait_share']:.6f} "
              f"{out['input']['decision_after_launch_s']:.2f} s after "
              f"launch (step {out['input']['steps_before_decision']}), "
              f"degraded at batch {out['input']['degraded_at_batch']}; "
              "shares before / after: " + ", ".join(
                  f"{b} {before[b]:.4f} / {after[b]:.4f}"
                  for b in PROVISION_BUCKETS)
              + f"; run: {_render_shares(out['goodput'])}; phase "
              f"{out['phase_s']:.1f} s", flush=True)
        print(json.dumps({"provision_llama3_1b": out}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phases 16 and 17: the SD-1.5 UNet and BERT-base ----------------------
# The UNet's attention per training step, no remat, by head dim
# (tpucfn_torch/models/unet.py: a SpatialTransformer after each ResBlock of
# an attention stage, blocks_per_stage = 2 down and 3 up, and one in the
# middle block; each a self- and a cross-attention, one K1, K2, K3 and
# Delta each): the 64x64, 32x32 and 16x16 stages' five blocks at 40, 80
# and 160 (320, 640 and 1280 channels over 8 heads), the middle block's
# one at 160.
UNET_LAUNCHES_BY_HEAD_DIM = {40: 10, 80: 10, 160: 12}
UNET_LAUNCHES_PER_STEP = sum(UNET_LAUNCHES_BY_HEAD_DIM.values())  # 32
UNET_STEPS = 6
QUIET_FROM_STEP = 4  # the first step with no checkpoint write in flight
UNET_CLASSES = {"flash attention": ("flash_",),
                "convolution": ("conv", "fprop", "dgrad", "wgrad",
                                "implicit_gemm", "winograd", "nchwtonhwc",
                                "nhwctonchw"),
                "matmul": ("gemm", "sm90_xmma", "cutlass", "nvjet"),
                "norm": ("norm", "welford"),
                "optimizer": ("foreach", "multi_tensor", "adam")}
BERT_STEPS = 10


def _unet_parity(torch, cfg, params, batch, t, noise):
    """Loss and every parameter's gradient through the kernels and through
    the plain attention op, at the same params, batch, t and noise."""
    from tpucfn_torch.models.unet import UNet, ddpm_loss_from
    from tpucfn_torch.ops.attention import dot_product_attention

    def plain(q, k, v):
        return dot_product_attention(q, k, v, causal=False)

    names = list(params)
    out = []
    for attention_fn in (None, plain):
        model = UNet.from_state_dict(cfg, params, trainable=True,
                                     attention_fn=attention_fn)
        loss = ddpm_loss_from(model, batch, t, noise)
        out.append((loss.item(), torch.autograd.grad(
            loss, [params[n] for n in names])))
        del model, loss
        torch.cuda.empty_cache()
    return _parity_row(names, *out)


def _unet_tiny_fp32(torch):
    """The tiny fp32 UNet at 16x16, the kernel path against the plain
    path over a few AdamW steps on one batch: every K1, K2 and K3 launch
    on mma, at head dims 16 (the 16x16 stage) and 32 (the middle block)."""
    import numpy as np

    from tpucfn_torch.data import synthetic_latents
    from tpucfn_torch.models.unet import (UNet, UNetConfig, ddpm_loss,
                                          init_unet_params)
    from tpucfn_torch.ops.attention import dot_product_attention
    from tpucfn_torch.train import Trainer, adamw

    cfg = UNetConfig.tiny()
    ex = list(synthetic_latents(4, hw=16, ctx_len=8, ctx_dim=cfg.context_dim))
    batch = {k: torch.as_tensor(np.stack([e[k] for e in ex]), device="cuda")
             for k in ex[0]}
    runs = {}
    for name, attention_fn in (("kernel", None), ("plain", lambda q, k, v:
                               dot_product_attention(q, k, v, causal=False))):
        def loss_fn(params, mstate, b, g, attention_fn=attention_fn):
            model = UNet.from_state_dict(cfg, params, trainable=True,
                                         attention_fn=attention_fn)
            return ddpm_loss(model, b, g), ({}, mstate)

        trainer = Trainer(None, None, loss_fn, adamw(1e-3), lambda g: (
            init_unet_params(cfg, generator=g, device=g.device), {}),
            device="cuda")
        state = trainer.init(0)
        _zero_launch_counts()
        losses = []
        for _ in range(6):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
        runs[name] = (losses, _launch_counts(), _launches_by_head_dim())
    (k_losses, k_counts, k_dims), (p_losses, p_counts, _) = (
        runs["kernel"], runs["plain"])
    diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    assert diff <= TINY_LOSS_TOL_FP32, (k_losses, p_losses)
    # per step: 3 blocks at 16x16 (D = 16) and the middle block (D = 32),
    # each a self- and a cross-attention
    assert k_dims == {k: {16: 6 * 6, 32: 6 * 2} for k in k_dims}, k_dims
    assert (k_counts["k1_mma"], k_counts["k2_mma"], k_counts["k3_mma"]) == (
        k_counts["k1"], k_counts["k2"], k_counts["k3"]) == (48, 48, 48), \
        k_counts
    assert not any(p_counts.values()), p_counts
    return {"kernel_losses": k_losses, "plain_losses": p_losses,
            "loss_max_abs_diff": diff, "loss_tol": TINY_LOSS_TOL_FP32,
            "kernel_launches": k_counts, "launches_by_head_dim": k_dims}


def phase_train_unet_sd15(results):
    """The SD-1.5 UNet finetune through the port's example
    (``tpucfn_torch/examples/sd15_unet.py``, ``main(argv)``): full width
    and depth, 64x64x4 latents, a 77 x 768 context, batch 2, fp32 params,
    EMA 0.9999, on one repeated batch; then the kernel path against the
    plain attention path at the same params and draws; then the tiny fp32
    UNet."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpucfn_torch.data import synthetic_latents
    from tpucfn_torch.models.unet import UNetConfig, ddpm_noise_draws

    cfg = UNetConfig.sd15()
    assert (cfg.base_width, tuple(cfg.width_mults), cfg.n_heads,
            cfg.context_dim, cfg.dtype) == (
        320, (1, 2, 4, 4), 8, 768, torch.bfloat16), cfg
    root = Path(tempfile.mkdtemp(prefix="train_unet_sd15-"))
    out = {"card": results.get("card")}
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        _zero_launch_counts()
        # No checkpoint is saved (13.8 GB a save: params, two Adam
        # moments, the EMA; no gate reads one), so steps 4 on, past the
        # first steps' warm-up, run with no write in flight.
        with _SaveOnly(()):
            text = _run_example(["--batch-size", "2", "--steps",
                                 str(UNET_STEPS), "--num-examples", "2",
                                 "--log-every", "1", "--run-dir",
                                 str(root / "run")], per_step,
                                example="sd15_unet")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        results["unet_launches"] = _launch_counts()
        by_dim = _launches_by_head_dim()
        rec = _run_record(root / "run")
        losses = [rec["losses"][i] for i in range(1, UNET_STEPS + 1)]
        assert all(map(math.isfinite, losses)), losses
        n = UNET_LAUNCHES_PER_STEP
        expected = {"k1": n, "k2": n, "k3": n, "delta": n,
                    "k1_sm90": n, "k1_decode": 0, "k1_mma": 0, "k1_fma": 0,
                    "k2_sm90": n, "k2_mma": 0, "k2_fma": 0,
                    "k3_sm90": n, "k3_mma": 0, "k3_fma": 0}
        assert len(per_step) == UNET_STEPS and all(
            c == expected for c in per_step), (per_step, expected)
        # every attention at its stage's head dim, exactly
        assert by_dim == {k: {d: c * UNET_STEPS for d, c in
                              UNET_LAUNCHES_BY_HEAD_DIM.items()}
                          for k in by_dim}, by_dim
        assert peak_gib < 80, peak_gib
        quiet = rec["step_s"][QUIET_FROM_STEP - 1:]
        step_ms = sum(quiet) / len(quiet) * 1e3
        out.update({
            "losses": losses, "launches_per_step": per_step[-1],
            "launches_expected_per_step": expected,
            "launches_by_head_dim": by_dim,
            "step_ms": [x * 1e3 for x in rec["step_s"]],
            "step_ms_no_write_in_flight": step_ms,
            "images_per_s": 2 / (step_ms / 1e3),
            "time_to_first_step_s": rec["time_to_first_step"],
            "ckpt_write": rec["ckpt_write"],
            "final_line": [line for line in text.splitlines()
                           if line.startswith("final:")][0],
            "peak_mem_gib": peak_gib})
        shutil.rmtree(root / "run")
        torch.cuda.empty_cache()

        # The example's trainer step (loss, gradients, AdamW, EMA),
        # profiled; then the parity check on its params with the
        # zero-initialised output convolution drawn small (at zero every
        # other gradient is zero).
        from tpucfn_torch.examples.sd15_unet import make_fns
        from tpucfn_torch.train import Trainer, TrainerConfig, adamw

        ex = list(synthetic_latents(2, hw=64, ctx_len=77, ctx_dim=768))
        batch = {k: torch.as_tensor(np.stack([e[k] for e in ex]),
                                    device="cuda") for k in ex[0]}
        init_fn, loss_fn = make_fns(cfg)
        trainer = Trainer(None, None, loss_fn, adamw(1e-5), init_fn,
                          config=TrainerConfig(ema_decay=0.9999),
                          device="cuda")
        state = trainer.init(0)
        out["profile_step"] = _profile(
            torch, lambda: trainer.step(state, batch), 1, kernel="flash_",
            classes=UNET_CLASSES)
        params = state.params
        g = torch.Generator("cuda").manual_seed(0)
        with torch.no_grad():
            params["conv_out.weight"].normal_(0.0, 0.02, generator=g)
        t, noise = ddpm_noise_draws(batch["latents"], g)
        parity = _unet_parity(torch, cfg, params, batch, t, noise)
        out["parity"] = parity
        assert parity["loss_abs_diff"] <= TRAIN_LOSS_TOL_BF16, parity
        assert parity["grad_cosine_min"] >= GRAD_COSINE_MIN, parity
        del params, state, trainer
        torch.cuda.empty_cache()
        out["tiny_fp32"] = _unet_tiny_fp32(torch)
        results["unet_tiny_launches"] = out["tiny_fp32"]["kernel_launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def phase_train_bert_base(results):
    """BERT-base MLM through the port's example
    (``tpucfn_torch/examples/bert_base.py``, ``main(argv)``): seq 128,
    batch 32, 10 steps on one repeated batch.  Its attention is masked,
    so dense in both packages: no flash launch."""
    import shutil
    import tempfile

    import torch

    root = Path(tempfile.mkdtemp(prefix="train_bert_base-"))
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        _zero_launch_counts()
        with _WaitForSaveBefore(QUIET_FROM_STEP):
            _run_example(["--seq-len", "128", "--batch-size", "32",
                          "--steps", str(BERT_STEPS), "--num-examples", "32",
                          "--log-every", "1", "--run-dir", str(root / "run")],
                         per_step, example="bert_base")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rec = _run_record(root / "run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    losses = [rec["losses"][i] for i in range(1, BERT_STEPS + 1)]
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0], losses
    counts = _launch_counts()
    assert len(per_step) == BERT_STEPS and not any(counts.values()), counts
    quiet = rec["step_s"][QUIET_FROM_STEP - 1:]
    step_ms = sum(quiet) / len(quiet) * 1e3
    return {"card": results.get("card"), "losses": losses,
            "launches": counts, "step_ms": [x * 1e3 for x in rec["step_s"]],
            "step_ms_no_write_in_flight": step_ms,
            "tokens_per_s": 32 * 128 / (step_ms / 1e3),
            "peak_mem_gib": peak_gib}


# ---- phases 18, 19 and 20: MoE, the Mixtral import, LoRA ------------------
MOE_LAYERS = 4          # of llama3-1b's 16: 2.18 B parameters, ~35 GB of
#                         fp32 params, gradients and AdamW state (7.1 B,
#                         ~114 GB at 16)
MOE_EXPERTS = 8
MOE_TINY_LOSS_TOL_FP32 = 1e-4
# The ops of the MoE dispatch (routing, scatter-add, gather) and of their
# backward, as the profiler names the op that launched a kernel.
MOE_DISPATCH_OPS = ("aten::topk", "aten::cumsum", "aten::one_hot",
                    "aten::index_add", "aten::index_add_",
                    "aten::index_select", "aten::scatter_add_",
                    "aten::scatter_add", "aten::softmax", "aten::_softmax",
                    "aten::_softmax_backward_data", "aten::sort",
                    "aten::gather", "aten::index", "aten::index_put_",
                    "aten::eq", "aten::lt", "aten::where",
                    "aten::logsumexp", "aten::bincount")
# Mixtral-8x7B-v0.1's published config.json, at 4 of its 32 layers: 6.07 B
# parameters, ~12.4 GB in bf16 (93 GB at full depth).
MIXTRAL = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=4, num_attention_heads=32,
               num_key_value_heads=8, max_position_embeddings=32768,
               rope_theta=1e6, rms_norm_eps=1e-5, num_local_experts=8,
               num_experts_per_tok=2, sliding_window=None, rope_scaling=None,
               tie_word_embeddings=False)
MIXTRAL_LENGTHS = (64, 100, 200, 333, 512, 64)
MIXTRAL_MAX_NEW = 16
MIXTRAL_CACHE_LEN = 1024
LORA_RANK = 8
LORA_LR = 1e-3  # peak of the warmup-cosine chain: a usual LoRA rate
LORA_LENGTHS = (16, 48, 100, 128)
LORA_MAX_NEW = 16


def _profile_by_op(torch, fn, classify):
    """Device ms of one ``fn`` call by class.  The flash kernels by name;
    every other kernel by ``classify(kernel name, the name of the op that
    launched it, that op's input shapes)``; what no op launched (or no
    class took) is "other", so the classes sum to the device time.
    Returns the classes' ms, the device and wall ms and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA
            and not getattr(r, "is_user_annotation", False)]
    # each kernel name's device ms, counted once (an annotation's span on
    # the device, such as the optimizer step's, is not among them)
    total = {r.key: r.self_device_time_total / 1e3 for r in rows}
    device_ms = sum(total.values())
    by = {"flash kernels": sum(ms for name, ms in total.items()
                               if "flash_" in name)}
    # An op's ``kernels`` list what it launched; a kernel can be listed
    # under more than one op, so each name's own time is shared out over
    # the classes in proportion to what the ops list.
    listed = {}
    for evt in prof.events():
        for k in getattr(evt, "kernels", ()):
            if k.name not in total or "flash_" in k.name:
                continue
            cls = classify(k.name, evt.name, evt.input_shapes or [])
            per = listed.setdefault(k.name, {})
            per[cls] = per.get(cls, 0.0) + k.duration
    for name, per in listed.items():
        seen = sum(per.values())
        for cls, us in per.items():
            by[cls] = by.get(cls, 0.0) + (total[name] * us / seen
                                          if seen else 0.0)
    by["other"] = by.get("other", 0.0) + device_ms - sum(by.values())
    return {"device_ms_by_class": by, "device_ms": device_ms,
            "wall_ms": wall_ms, "device_busy_share": device_ms / wall_ms}


def _moe_class(vocab):
    def classify(kernel, op, shapes):
        if op == "aten::bmm":
            return "expert GEMMs"
        if op in MOE_DISPATCH_OPS:
            return "dispatch"
        if op in ("aten::mm", "aten::addmm", "aten::matmul", "aten::linear"):
            flat = [d for s in shapes for d in (s or [])]
            return "head" if vocab in flat else "layer GEMMs"
        if "adam" in kernel.lower() or "foreach" in kernel.lower() \
                or "multi_tensor" in kernel.lower():
            return "optimizer"
        return "other"

    return classify


class _Routes:
    """Records every MoE layer's top-k experts while a run lasts, by
    wrapping ``moe._route``."""

    def __init__(self):
        from tpucfn_torch.models import moe

        self.moe, self.real, self.calls = moe, moe._route, []

    def __enter__(self):
        def route(*a, **kw):
            out = self.real(*a, **kw)
            self.calls.append(out[2].detach().clone())
            return out

        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def _routing_diff(torch, cfg, params, batch):
    """The share of (token, slot) routing decisions that the kernel path's
    forward and the plain path's take differently (layer by layer, from
    inputs that differ by the attention's bf16 rounding)."""
    from tpucfn_torch.ops.attention import dot_product_attention
    from tpucfn_torch.train import llama_train_fns

    routes = []
    for attention_fn in (None, dot_product_attention):
        _, loss_fn = llama_train_fns(cfg, attention_fn=attention_fn)
        with torch.no_grad(), _Routes() as rec:
            loss_fn(params, {}, batch, None)
        routes.append(rec.calls)
    differ = sum(int((a != b).sum()) for a, b in zip(*routes))
    total = sum(a.numel() for a in routes[0])
    return {"decisions": total, "differ": differ, "share": differ / total,
            "layers": len(routes[0])}


def _moe_tiny_fp32(torch):
    """The tiny preset with a MoE (4 experts, top-2, capacity factor 1.25)
    in fp32, 6 AdamW steps through the kernels and through the plain
    attention: losses within 1e-4, every K1, K2 and K3 launch on mma."""
    import dataclasses

    from tpucfn_torch.models.llama import LlamaConfig
    from tpucfn_torch.models.moe import MoEConfig
    from tpucfn_torch.ops.attention import dot_product_attention
    from tpucfn_torch.train import Trainer, adamw, llama_train_fns

    cfg = dataclasses.replace(LlamaConfig.tiny(), param_dtype=torch.float32,
                              moe=MoEConfig(n_experts=4, top_k=2))
    batch = _token_batch(torch, 8, 64, cfg.vocab_size)
    runs = {}
    for name, attention_fn in (("kernel", None),
                               ("plain", dot_product_attention)):
        init_fn, loss_fn = llama_train_fns(cfg, attention_fn=attention_fn,
                                           chunk_size=16)
        trainer = Trainer(None, None, loss_fn, adamw(1e-3), init_fn,
                          device="cuda")
        state = trainer.init(0)
        _zero_launch_counts()
        losses, dropped = [], []
        for _ in range(6):
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
            dropped.append(metrics["moe_dropped_frac"].item())
        runs[name] = (losses, dropped, _launch_counts())
    (k_losses, k_dropped, k_counts), (p_losses, _, p_counts) = \
        runs["kernel"], runs["plain"]
    diff = max(abs(a - b) for a, b in zip(k_losses, p_losses))
    assert diff <= MOE_TINY_LOSS_TOL_FP32, (k_losses, p_losses)
    assert all(k_counts[k] == 6 * n * cfg.n_layers
               for k, n in LAUNCHES_PER_LAYER.items()), k_counts
    assert (k_counts["k1_mma"], k_counts["k2_mma"], k_counts["k3_mma"]) == (
        k_counts["k1"], k_counts["k2"], k_counts["k3"]), k_counts
    assert not any(p_counts.values()), p_counts
    return {"kernel_losses": k_losses, "plain_losses": p_losses,
            "loss_max_abs_diff": diff, "loss_tol": MOE_TINY_LOSS_TOL_FP32,
            "dropped_frac": k_dropped, "kernel_launches": k_counts}


def phase_train_moe_llama3_1b(results):
    """The reference example's ``--model 1b --moe-experts 8`` through
    ``Trainer``: llama3-1b's widths, 8 experts (top-2, capacity factor
    1.25) in each of 4 layers, 2 x 2048 tokens, remat, chunked CE with the
    aux loss, 4 steps on one batch; then the kernel path against the plain
    attention path and the tiny fp32 MoE on mma."""
    import dataclasses

    import torch

    from tpucfn_torch.models.llama import LlamaConfig, train_step_flops
    from tpucfn_torch.models.moe import MoEConfig, capacity
    from tpucfn_torch.train import Trainer, llama_train_fns

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(
        LlamaConfig.llama3_1b(), param_dtype=torch.float32, remat=True,
        n_layers=MOE_LAYERS, moe=MoEConfig(n_experts=MOE_EXPERTS))
    assert (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim,
            cfg.vocab_size, cfg.moe.top_k, cfg.moe.capacity_factor) == \
        (2048, 32, 8, 64, 8192, 128256, 2, 1.25), cfg
    steps, b, seq, chunk, z_loss = 4, 2, 2048, 512, 1e-4
    init_fn, loss_fn = llama_train_fns(cfg, chunk_size=chunk, z_loss=z_loss)
    trainer = Trainer(None, None, loss_fn, _example_chain(steps), init_fn,
                      device="cuda")
    state = trainer.init(0)
    batch = _token_batch(torch, b, seq, cfg.vocab_size)
    n_params = sum(p.numel() for p in state.params.values())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, dropped, step_s, per_step = [], [], [], []
    seen = _launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"].item())
        dropped.append(metrics["moe_dropped_frac"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        now = _launch_counts()
        per_step.append({k: now[k] - seen[k] for k in now})
        seen = now
    results["moe_launches"] = seen
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    expected = {k: n * cfg.n_layers for k, n in LAUNCHES_PER_LAYER.items()}
    expected.update(k1_sm90=expected["k1"], k1_decode=0, k1_mma=0,
                    k1_fma=0, k2_sm90=expected["k2"], k2_mma=0, k2_fma=0,
                    k3_sm90=expected["k3"], k3_mma=0, k3_fma=0)
    assert all(c == expected for c in per_step), (per_step, expected)
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0], losses
    assert peak_gib < 80, peak_gib

    steady = sum(step_s[1:]) / (steps - 1)
    flops = train_step_flops(cfg, b, seq, chunked_head=True)
    profile = _profile_by_op(torch, lambda: trainer.step(state, batch),
                             _moe_class(cfg.vocab_size))
    routing = _routing_diff(torch, cfg, state.params, batch)
    parity = _grad_parity(torch, cfg, state.params, batch, chunk, z_loss)
    assert parity["loss_abs_diff"] <= TRAIN_LOSS_TOL_BF16, parity
    assert parity["grad_cosine_min"] >= GRAD_COSINE_MIN, parity
    del state, trainer
    torch.cuda.empty_cache()
    tiny = _moe_tiny_fp32(torch)
    results["moe_tiny_launches"] = tiny["kernel_launches"]
    return {"card": results.get("card"), "params": n_params,
            "layers": cfg.n_layers, "experts": cfg.moe.n_experts,
            "capacity_per_layer": capacity(cfg.moe, b * seq),
            "batch": [b, seq], "losses": losses, "dropped_frac": dropped,
            "launches_per_step": per_step[-1],
            "launches_expected_per_step": expected,
            "step_ms": [t * 1e3 for t in step_s],
            "step_ms_steady_mean": steady * 1e3,
            "tokens_per_s": b * seq / steady,
            "train_step_flops": flops,
            "mfu_vs_989_tflops": flops / steady / 989e12,
            "peak_mem_gib": peak_gib, "profile_step": profile,
            "routing_vs_plain": routing, "parity_after_steps": parity,
            "tiny_fp32": tiny}


def _mixtral_hf_state_dict(torch, hf_cfg, generator):
    """Mixtral's HF names and shapes, bf16 on the card, drawn from
    ``generator``: every Linear and the embedding N(0, 0.02) (HF's
    ``initializer_range``), every norm weight one."""
    d, f = hf_cfg.hidden_size, hf_cfg.intermediate_size
    kv = hf_cfg.num_key_value_heads * d // hf_cfg.num_attention_heads

    def w(*shape):
        return torch.randn(shape, generator=generator, device="cuda",
                           dtype=torch.bfloat16).mul_(0.02)

    def ones(n):
        return torch.ones(n, device="cuda", dtype=torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(hf_cfg.vocab_size, d),
          "model.norm.weight": ones(d),
          "lm_head.weight": w(hf_cfg.vocab_size, d)}
    for i in range(hf_cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd.update({p + "self_attn.q_proj.weight": w(d, d),
                   p + "self_attn.k_proj.weight": w(kv, d),
                   p + "self_attn.v_proj.weight": w(kv, d),
                   p + "self_attn.o_proj.weight": w(d, d),
                   p + "input_layernorm.weight": ones(d),
                   p + "post_attention_layernorm.weight": ones(d),
                   p + "block_sparse_moe.gate.weight": w(
                       hf_cfg.num_local_experts, d)})
        for x in range(hf_cfg.num_local_experts):
            m = f"{p}block_sparse_moe.experts.{x}."
            sd.update({m + "w1.weight": w(f, d), m + "w3.weight": w(f, d),
                       m + "w2.weight": w(d, f)})
    return sd


def _greedy_ok(torch, plain, prompt, out):
    """Each greedy token of ``out`` against the plain model's
    teacher-forced logits: its argmax, or a near-tie there (top-2 gap
    under SPEC_NEAR_TIE).  Returns (argmax matches, near-tie misses, other
    misses, the plain logits)."""
    ref = _teacher_forced_logits(torch, plain, prompt, out)
    top2 = ref.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu()
    hit = ref.argmax(-1).cpu() == torch.tensor(out)
    near = (~hit) & (gap < SPEC_NEAR_TIE)
    return int(hit.sum()), int(near.sum()), int((~hit & ~near).sum()), ref


def phase_serve_mixtral_8x7b(results):
    """A Mixtral-8x7B-v0.1-shaped model (its published widths, 4 of its 32
    layers), its HF-named bf16 state dict made from a seed on the card,
    imported by the port's ``hf_convert``, served through
    ``ServeEngine.from_llama`` and the copied ``Server`` (8 slots)."""
    import types

    import numpy as np
    import torch

    from tpucfn_torch.kernels import flash_attention as fa
    from tpucfn_torch.models import hf_convert
    from tpucfn_torch.models.llama import Llama
    from tpucfn_torch.serve import Server
    from tpucfn_torch.serve.engine import ServeEngine

    torch.cuda.empty_cache()
    hf_cfg = types.SimpleNamespace(**MIXTRAL)
    t0 = time.perf_counter()
    hf_sd = _mixtral_hf_state_dict(torch, hf_cfg,
                                   torch.Generator("cuda").manual_seed(0))
    cfg = hf_convert.config_from_hf_mixtral(hf_cfg)
    params = hf_convert.params_from_hf_mixtral_state_dict(hf_sd, cfg)
    del hf_sd
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.ffn_dim, cfg.vocab_size, cfg.rope_theta, cfg.norm_eps,
            cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.capacity_factor) == \
        (4096, 4, 32, 8, 128, 14336, 32000, 1e6, 1e-5, 8, 2, 4.0), cfg
    n_params = sum(t.numel() for t in params.values())
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    expert_bytes = sum(t.numel() * t.element_size()
                       for n, t in params.items() if ".experts." in n)
    engine = ServeEngine.from_llama(cfg, params, max_batch=8,
                                    cache_len=MIXTRAL_CACHE_LEN,
                                    prefill_width=4, device="cuda")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
               for n in MIXTRAL_LENGTHS]
    warm = Server(engine, num_blocks=16, block_size=16)
    warm.submit(prompts[0], max_new_tokens=2)
    warm.run_until_idle()

    rec = _Calls(engine)
    server = Server(engine, num_blocks=MIXTRAL_CACHE_LEN * 8 // 16,
                    block_size=16, prefix_cache=False, max_prefill_batch=4)
    _zero_launch_counts()
    reqs = [server.submit(p, max_new_tokens=MIXTRAL_MAX_NEW) for p in prompts]
    server.run_until_idle()
    torch.cuda.synchronize()
    by_variant = dict(fa.flash_fwd.launches_by_variant)
    by_dim = dict(fa.flash_fwd.launches_by_head_dim)
    counts = {name: rec.count(name) for name in ("prefill_batch", "decode")}
    counts.update({name + "_s": rec.seconds[name]
                   for name in ("prefill_batch", "decode")})
    results["mixtral_launches"] = {"sm90": by_variant["sm90"],
                                   "decode": by_variant["decode"]}
    snap = server.metrics.snapshot()
    assert all(r.error is None for r in reqs), [r.error for r in reqs]
    assert snap["completed"] == len(prompts), snap
    assert server.kv.allocator.num_used == 0, server.kv.allocator.num_used
    # every prefill (a bucket of >= 64 tokens x GQA 4) on sm90 at D = 128,
    # every decode on the decode variant
    assert by_variant == {"sm90": cfg.n_layers * counts["prefill_batch"],
                          "decode": cfg.n_layers * counts["decode"],
                          "mma": 0, "fma": 0}, by_variant
    assert set(by_dim) == {128}, by_dim

    plain = Llama.from_state_dict(engine.model.cfg, engine.model.state_dict(),
                                  decode=True, device="cuda")
    hits = near = other = flips = decisions = 0
    worst = 0.0
    for p, r in zip(prompts, reqs):
        out = r.result(timeout=0)
        with _Routes() as routes_ref:
            h, n_, o, ref = _greedy_ok(torch, plain, p, out)
        with _Routes() as routes_got:
            got = _teacher_forced_logits(torch, engine.model, p, out)
        for a, b in zip(routes_ref.calls, routes_got.calls):
            flips += int((a != b).sum())
            decisions += a.numel()
        assert torch.isfinite(got).all() and got.shape == (
            MIXTRAL_MAX_NEW, cfg.vocab_size)
        worst = max(worst, (ref[-1] - got[-1]).abs().max().item())
        hits, near, other = hits + h, near + n_, other + o
    assert other == 0, (hits, near, other)

    tpot = [(r.t_done - r.t_first_token) / (len(r.tokens) - 1) for r in reqs]
    # A decode step over every slot, profiled: every expert weight is read
    # (the ragged dispatch multiplies all E experts' buffers).
    profile_decode = _profile(
        torch, lambda: engine.decode({s: 1 for s in range(8)}), 4,
        kernel="flash_fwd_decode")
    floor = {"expert_weights_ms": expert_bytes / PEAK_BYTES_S * 1e3,
             "all_weights_ms": weight_bytes / PEAK_BYTES_S * 1e3}
    # K1 at this model's shapes: a full-width prefill (4 lanes x 512 at
    # D = 128, GQA 4) and a decode step at the run's serving offsets
    timer = Timer(torch)
    offsets = [int(i) for i in engine.cache.index.tolist()]
    rows = [_one_case(torch, timer, "mixtral_prefill_sq512", 4, 32, 8, 128,
                      512, MIXTRAL_CACHE_LEN, torch.bfloat16, [0, 0, 0, 0]),
            _one_case(torch, timer, "mixtral_decode_serving_offsets", 8, 32,
                      8, 128, 1, MIXTRAL_CACHE_LEN, torch.bfloat16,
                      [max(0, o - 1) for o in offsets])]
    assert [r["variant"] for r in rows] == ["sm90", "decode"], rows
    assert all(r["ok"] for r in rows), rows
    results.setdefault("kernel_rows", []).extend(rows)
    return {"card": results.get("card"), "params": n_params,
            "weight_gib": weight_bytes / 2**30, "import_s": import_s,
            "requests": len(reqs), "completed": snap["completed"],
            "kv_blocks_used_after": server.kv.allocator.num_used,
            "prefill_calls": counts["prefill_batch"],
            "decode_steps": counts["decode"],
            "k1_launches_by_variant": by_variant,
            "k1_launches_by_head_dim": by_dim,
            "greedy_vs_plain": {"argmax": hits, "near_tie": near,
                                "other": other,
                                "near_tie_gap": SPEC_NEAR_TIE},
            # the teacher-forced passes' top-2 experts, kernel against
            # plain attention: a flip moves that token's MLP output whole
            "routing_vs_plain": {"decisions": decisions, "differ": flips,
                                 "share": flips / decisions},
            "last_logits_max_abs_err": worst,
            "ttft_s": snap["ttft_s"], "tpot_s_mean": sum(tpot) / len(tpot),
            "decode_step_ms_mean": counts["decode_s"] / counts["decode"] * 1e3,
            "decode_tokens_per_s": snap["decode_tokens"] / counts["decode_s"],
            "profile_decode_step": profile_decode,
            "decode_step_floor": floor,
            "kernel_rows": {r["case"]: {k: r[k] for k in KEYS + ("variant",)}
                            for r in rows},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def _greedy_tokens(engine, prompts, max_new):
    from tpucfn_torch.serve import Server

    server = Server(engine, num_blocks=64 * len(prompts), block_size=16,
                    prefix_cache=False)
    reqs = [server.submit(p, max_new_tokens=max_new) for p in prompts]
    server.run_until_idle()
    assert server.kv.allocator.num_used == 0
    return [r.result(timeout=0) for r in reqs]


def _lora_parity(torch, cfg, base, adapters, batch, chunk, z_loss):
    """The LoRA loss and every adapter's gradient through the kernels and
    through the plain attention, at the same adapters and batch."""
    from tpucfn_torch.ops.attention import dot_product_attention
    from tpucfn_torch.train import llama_train_fns, lora_train_fns

    names = list(adapters)
    out = []
    for attention_fn in (None, dot_product_attention):
        init_fn, loss_fn = llama_train_fns(cfg, attention_fn=attention_fn,
                                           chunk_size=chunk, z_loss=z_loss)
        _, lora_loss = lora_train_fns(init_fn, loss_fn, rank=LORA_RANK)
        loss, _ = lora_loss(adapters, {"base": base}, batch, None)
        out.append((loss.item(), torch.autograd.grad(
            loss, [adapters[n] for n in names])))
    return _parity_row(names, *out)


def phase_lora_llama3_1b(results):
    """Rank-8 LoRA adapters on the default targets of llama3-1b at full
    width and depth, the base frozen, 4 steps at 2 x 2048 through
    ``Trainer``; then the trained adapters merged into serving by
    ``ServeEngine.from_llama(lora_adapters=)``."""
    import dataclasses

    import numpy as np
    import torch

    from tpucfn_torch.models.llama import LlamaConfig
    from tpucfn_torch.serve.engine import ServeEngine
    from tpucfn_torch.train import (Trainer, adamw, chain,
                                    clip_by_global_norm, llama_train_fns,
                                    lora_materialize, lora_train_fns,
                                    warmup_cosine_decay_schedule)

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(LlamaConfig.llama3_1b(),
                              param_dtype=torch.float32, remat=True)
    steps, b, seq, chunk, z_loss = 4, 2, 2048, 512, 1e-4
    init_fn, loss_fn = llama_train_fns(cfg, chunk_size=chunk, z_loss=z_loss)
    lora_init_fn, lora_loss_fn = lora_train_fns(init_fn, loss_fn,
                                                rank=LORA_RANK)
    tx = chain(clip_by_global_norm(1.0), adamw(
        warmup_cosine_decay_schedule(0.0, LORA_LR, 1, steps),
        b1=0.9, b2=0.95, weight_decay=0.1))
    trainer = Trainer(None, None, lora_loss_fn, tx, lora_init_fn,
                      device="cuda")
    state = trainer.init(0)
    base = state.model_state["base"]
    batch = _token_batch(torch, b, seq, cfg.vocab_size)
    n_adapter = sum(p.numel() for p in state.params.values())
    n_base = sum(t.numel() for t in base.values())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, step_s, per_step = [], [], []
    seen = _launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        now = _launch_counts()
        per_step.append({k: now[k] - seen[k] for k in now})
        seen = now
    results["lora_launches"] = seen
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    expected = {k: n * cfg.n_layers for k, n in LAUNCHES_PER_LAYER.items()}
    expected.update(k1_sm90=expected["k1"], k1_decode=0, k1_mma=0,
                    k1_fma=0, k2_sm90=expected["k2"], k2_mma=0, k2_fma=0,
                    k3_sm90=expected["k3"], k3_mma=0, k3_fma=0)
    assert all(c == expected for c in per_step), (per_step, expected)
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0], losses
    steady = sum(step_s[1:]) / (steps - 1)
    parity = _lora_parity(torch, cfg, base, state.params, batch, chunk,
                          z_loss)
    assert parity["loss_abs_diff"] <= TRAIN_LOSS_TOL_BF16, parity
    assert parity["grad_cosine_min"] >= GRAD_COSINE_MIN, parity
    # only the adapters have optimizer state (AdamW's two moments)
    opt_numel = sum(t.numel() for t in state.tx.state_dict(
        state.opt_state, state.params).values() if t.dim())
    assert opt_numel == 2 * n_adapter, (opt_numel, n_adapter)

    # Serving: the trained adapters merged at construction, against an
    # engine over the weights merged beforehand, and the base alone.
    trained = {k: v.detach() for k, v in state.params.items()}
    serve_cfg = dataclasses.replace(cfg, param_dtype=None)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
               for n in LORA_LENGTHS]
    del trainer
    torch.cuda.empty_cache()
    tokens = {}
    for name, kw in (
            ("lora_adapters", dict(params=base, lora_adapters=trained)),
            ("merged", dict(params=lora_materialize(base, trained))),
            ("base", dict(params=base))):
        engine = ServeEngine.from_llama(serve_cfg, max_batch=8,
                                        cache_len=512, device="cuda", **kw)
        tokens[name] = _greedy_tokens(engine, prompts, LORA_MAX_NEW)
        del engine
        torch.cuda.empty_cache()
    assert tokens["lora_adapters"] == tokens["merged"], tokens
    assert tokens["lora_adapters"] != tokens["base"], tokens
    differ = sum(a != b for ta, tb in zip(tokens["lora_adapters"],
                                          tokens["base"])
                 for a, b in zip(ta, tb))
    return {"card": results.get("card"), "rank": LORA_RANK,
            "adapter_params": n_adapter, "base_params": n_base,
            "adapter_tensors": len(state.params),
            "optimizer_state_numel": opt_numel,
            "batch": [b, seq], "lr": LORA_LR, "losses": losses,
            "launches_per_step": per_step[-1],
            "launches_expected_per_step": expected,
            "step_ms": [t * 1e3 for t in step_s],
            "step_ms_steady_mean": steady * 1e3,
            "tokens_per_s": b * seq / steady, "peak_mem_gib": peak_gib,
            "parity_after_steps": parity,
            "serve": {"prompts": len(prompts), "max_new": LORA_MAX_NEW,
                      "lora_equals_merged": True,
                      "tokens_differing_from_base": differ}}


# ---- phases 21, 22 and 23: the ResNets and the selective remat policies --
RESNET50_STEPS = 12
RESNET50_BATCH = 128
RESNET_STEADY_FROM = 3  # steps 3-12: past the first steps' warm-up
RESNET20_STEPS = 30
# A profiled ResNet-50 step's kernels by class (first match wins); the
# BatchNorm statistics are the port's own fp32 sums ("reduce").
RESNET_CLASSES = {"convolution": ("conv", "fprop", "dgrad", "wgrad",
                                  "implicit_gemm", "winograd", "xmma",
                                  "cudnn", "nchwtonhwc", "nhwctonchw"),
                  "optimizer": ("foreach", "multi_tensor", "sgd"),
                  "norm": ("norm", "welford", "reduce"),
                  "elementwise": ("elementwise", "unrolled", "vectorized",
                                  "pooling", "max_pool")}
RESNET_STATS_TOL = 1e-3
# bf16 against fp32, each gradient: ResNet-50's BatchNorm parameters and
# some convolutions have gradients that are small sums of nearly
# cancelling terms (a BatchNorm's backward leaves its input gradient
# zero-mean per channel), so rounding the forward's activations to bf16
# alone, with an fp32 backward, moves them to a cosine of ~0.966-0.98 on
# the card (the ``floor`` the parity row prints beside each worst
# tensor), and the bf16 backward's own rounding to ~0.955.  All gradients
# together are held at GRAD_COSINE_MIN, each at this.
RESNET_GRAD_COSINE_EACH = 0.93
# The remat phase: llama3-1b, one batch of 2 x 2048, four steps a policy.
REMAT_POLICIES = ("full", "dots", "dots_no_batch", "none")
REMAT_STEPS = 4
REMAT_LOSS_REL_TOL = 1e-5
REMAT_GRAD_COSINE = 0.9999


def _cosines(names, grads, ref):
    """Each gradient's cosine similarity to ``ref``'s; a gradient that is
    all zero must be all zero in both (cosine 1 then)."""
    out = {}
    for n, a, b in zip(names, grads, ref):
        a, b = a.double().flatten(), b.double().flatten()
        if not a.any() or not b.any():
            assert not a.any() and not b.any(), (n, "zero in one only")
            out[n] = 1.0
            continue
        out[n] = float(a @ b / (a.norm() * b.norm()))
    return out


class _RoundActivations:
    """While it lasts, every convolution's and BatchNorm's output is
    rounded to bf16 in the forward and passed straight through in the
    backward: an fp32 model whose activations carry bf16's rounding and
    nothing else of it."""

    def __enter__(self):
        from tpucfn_torch.models import resnet

        self.cls = (resnet.Conv, resnet.BatchNorm)
        self.real = [c.forward for c in self.cls]

        def rounded(fwd):
            def forward(*a, **kw):
                y = fwd(*a, **kw)
                return y + (y.bfloat16().float() - y).detach()
            return forward

        for c, fwd in zip(self.cls, self.real):
            c.forward = rounded(fwd)
        return self

    def __exit__(self, *exc):
        for c, fwd in zip(self.cls, self.real):
            c.forward = fwd


def _resnet_parity(torch, cfg, params, stats, batch):
    """The bf16 channels_last model against the same model in fp32 at the
    same params, running statistics and batch: the loss, the cosine of
    every gradient and of all of them together, the worst tensors of each
    kind; and beside each worst tensor its floor, the cosine of the fp32
    model with only its activations rounded to bf16 (what bf16's
    rounding of the forward alone does to that gradient)."""
    import contextlib
    import dataclasses

    from tpucfn_torch.models.resnet import resnet_train_fns

    names = list(params)
    out = {}
    for run, dtype, ctx in (("bf16", torch.bfloat16, contextlib.nullcontext),
                            ("fp32", torch.float32, contextlib.nullcontext),
                            ("floor", torch.float32, _RoundActivations)):
        _, loss_fn, _ = resnet_train_fns(
            dataclasses.replace(cfg, dtype=dtype), label_smoothing=0.1)
        with ctx():
            loss, _ = loss_fn(params, {"batch_stats": stats}, batch, None)
            out[run] = (loss.item(), torch.autograd.grad(
                loss, [params[n] for n in names]))
    (b_loss, b_grads), (f_loss, f_grads), (_, r_grads) = (
        out["bf16"], out["fp32"], out["floor"])
    cos = _cosines(names, b_grads, f_grads)
    floor = _cosines(names, r_grads, f_grads)
    flat = _cosines(["all"], [torch.cat([g.flatten() for g in b_grads])],
                    [torch.cat([g.flatten() for g in f_grads])])["all"]
    kinds = {"conv and head weights": lambda n: n.endswith(".weight"),
             "BatchNorm scales and biases": lambda n: not n.endswith(
                 ".weight")}
    worst = {}
    for kind, pick in kinds.items():
        rows = sorted((c, n) for n, c in cos.items() if pick(n))[:4]
        worst[kind] = [{"tensor": n, "cosine": c, "floor": floor[n]}
                       for c, n in rows]
    weights_min = worst["conv and head weights"][0]["cosine"]
    return {"bf16_loss": b_loss, "fp32_loss": f_loss,
            "loss_abs_diff": abs(b_loss - f_loss),
            "loss_tol": TRAIN_LOSS_TOL_BF16, "grad_cosine_all": flat,
            "grad_cosine_min": min(cos.values()),
            "grad_cosine_min_at": min(cos, key=cos.get),
            "weight_grad_cosine_min": weights_min, "worst": worst,
            "floor_cosine_min": min(floor.values()),
            "tolerances": {"all": GRAD_COSINE_MIN,
                           "each": RESNET_GRAD_COSINE_EACH},
            "tensors": len(cos),
            "zero_grads": sum(1 for g in b_grads if not g.any())}


def _stem_stats_check(torch, cfg, batch):
    """One step from fresh running statistics: ``bn_stem``'s must be
    0.9 x the fresh ones + 0.1 x the batch mean and BIASED variance of
    the stem convolution's output (computed here in float64)."""
    from tpucfn_torch.models.resnet import ResNet, resnet_train_fns
    from tpucfn_torch.train import Trainer, sgd

    init_fn, loss_fn, _ = resnet_train_fns(cfg, label_smoothing=0.1)
    trainer = Trainer(None, None, loss_fn, sgd(0.1, momentum=0.9,
                                               nesterov=True), init_fn,
                      device="cuda")
    state = trainer.init(0)
    fresh = {k: v.clone() for k, v in
             state.model_state["batch_stats"].items()}
    with torch.no_grad():
        model = ResNet.from_state_dict(cfg, state.params, trainable=True)
        stem = model.conv_stem(batch["image"].to(cfg.dtype).permute(
            0, 3, 1, 2)).double()
        mean = stem.mean(dim=(0, 2, 3))
        var = stem.var(dim=(0, 2, 3), unbiased=False)
    state, _ = trainer.step(state, batch)
    got = state.model_state["batch_stats"]
    errs = {}
    for key, batch_value in (("mean", mean), ("var", var)):
        want = 0.9 * fresh[f"bn_stem.{key}"].double() + 0.1 * batch_value
        errs[key] = float((got[f"bn_stem.{key}"].double() - want).abs().max())
    unbiased = float((0.1 * (var * stem[:, 0].numel()
                             / (stem[:, 0].numel() - 1) - var)).abs().max())
    assert max(errs.values()) <= RESNET_STATS_TOL, errs
    return {"max_abs_err": errs, "tol": RESNET_STATS_TOL,
            "unbiased_would_differ_by": unbiased}


def phase_train_resnet50_imagenet(results):
    """The port's ImageNet example (``tpucfn_torch/examples/
    imagenet_resnet50.py``) through its ``main(argv)``: ResNet-50 at 224,
    batch 128, 12 steps over 256 synthetic images, no checkpoint; then a
    profiled step, the bf16 model against fp32 after two SGD steps, and
    the stem's running statistics after one step."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from tpucfn_torch.data import synthetic_imagenet
    from tpucfn_torch.models.resnet import (ResNetConfig, resnet_train_flops,
                                            resnet_train_fns)
    from tpucfn_torch.train import Trainer, sgd

    cfg = ResNetConfig.resnet50()
    assert (tuple(cfg.stage_sizes), cfg.width, cfg.bottleneck,
            cfg.num_classes, cfg.dtype) == ((3, 4, 6, 3), 64, True, 1000,
                                            torch.bfloat16), cfg
    b = RESNET50_BATCH
    root = Path(tempfile.mkdtemp(prefix="train_resnet50_imagenet-"))
    # cuDNN's heuristics pick the algorithms (no autotuning: it cost
    # ~15 s of the first step and again for the parity check's fp32
    # shapes); TF32 stays as ``main`` set it.
    out = {"card": results.get("card"),
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32}}
    try:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        _zero_launch_counts()
        with _SaveOnly(()):
            text = _run_example(
                ["--network", "resnet50", "--image-size", "224",
                 "--batch-size", str(b), "--num-examples", "256",
                 "--steps", str(RESNET50_STEPS), "--log-every", "1",
                 "--run-dir", str(root / "run")], per_step,
                example="imagenet_resnet50")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rec = _run_record(root / "run")
        shutil.rmtree(root / "run")
        losses = [rec["losses"][i] for i in range(1, RESNET50_STEPS + 1)]
        assert all(map(math.isfinite, losses)), losses
        assert len(per_step) == RESNET50_STEPS, len(per_step)
        # no flash kernel on this path
        assert not any(_launch_counts().values()), _launch_counts()
        assert peak_gib < 80, peak_gib
        steady = rec["step_s"][RESNET_STEADY_FROM - 1:]
        step_s = sum(steady) / len(steady)
        flops = resnet_train_flops(cfg, b, 224)
        waits = rec["data_wait_s"][RESNET_STEADY_FROM - 1:]
        out.update({
            "losses": losses,
            "step_ms": [x * 1e3 for x in rec["step_s"]],
            "step_ms_steady_mean": step_s * 1e3,
            "images_per_s": b / step_s,
            "train_step_flops": flops,
            "mfu_vs_989_tflops": flops / step_s / 989e12,
            "data_wait_ms_steady_mean": sum(waits) / len(waits) * 1e3,
            "time_to_first_step_s": rec["time_to_first_step"],
            "final_line": [line for line in text.splitlines()
                           if line.startswith("final:")][0],
            "peak_mem_gib": peak_gib})
        torch.cuda.empty_cache()

        # The example's step (loss, gradients, weight decay, SGD)
        # twice, the second profiled; the parity check after those
        # two SGD steps (at init every residual branch's convolutions
        # have a zero gradient: the blocks' last BatchNorm scales are
        # zero).
        ex = list(synthetic_imagenet(b, seed=0, image_size=224))
        batch = {"image": torch.as_tensor(
            np.stack([e["image"] for e in ex]), device="cuda"),
                 "label": torch.as_tensor(
            np.stack([e["label"] for e in ex]), device="cuda")}
        init_fn, loss_fn, _ = resnet_train_fns(cfg, label_smoothing=0.1)
        trainer = Trainer(None, None, loss_fn,
                          sgd(0.1, momentum=0.9, nesterov=True),
                          init_fn, device="cuda")
        state = trainer.init(0)
        out["profile_step"] = _profile(
            torch, lambda: trainer.step(state, batch), 1,
            classes=RESNET_CLASSES)
        out["profile_step"]["images_per_s"] = b / (
            out["profile_step"]["wall_ms"] / 1e3)
        parity = _resnet_parity(torch, cfg, state.params,
                                state.model_state["batch_stats"], batch)
        out["parity_after_steps"] = parity
        assert parity["loss_abs_diff"] <= TRAIN_LOSS_TOL_BF16, parity
        assert parity["grad_cosine_all"] >= GRAD_COSINE_MIN, parity
        assert parity["grad_cosine_min"] >= RESNET_GRAD_COSINE_EACH, \
            parity
        del state, trainer
        torch.cuda.empty_cache()
        out["stem_stats_after_one_step"] = _stem_stats_check(
            torch, cfg, batch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def _eval_reads_running_stats(torch):
    """ResNet-20's eval step, after two training steps, equals the model
    over the state's running statistics (``train=False``) and differs
    from it over fresh ones."""
    import numpy as np

    from tpucfn_torch.data import synthetic_cifar10
    from tpucfn_torch.models.resnet import (ResNet, ResNetConfig,
                                            resnet_train_fns)
    from tpucfn_torch.train import Trainer, sgd

    cfg = ResNetConfig.resnet20_cifar()
    ex = list(synthetic_cifar10(128, seed=3))
    batch = {"image": torch.as_tensor(np.stack([e["image"] for e in ex]),
                                      device="cuda"),
             "label": torch.as_tensor(np.stack([e["label"] for e in ex]),
                                      device="cuda")}
    init_fn, loss_fn, eval_loss_fn = resnet_train_fns(cfg)
    trainer = Trainer(None, None, loss_fn, sgd(0.1, momentum=0.9,
                                               nesterov=True), init_fn,
                      eval_loss_fn=eval_loss_fn, device="cuda")
    state = trainer.init(0)
    fresh = {k: v.clone() for k, v in
             state.model_state["batch_stats"].items()}
    for _ in range(2):
        state, _ = trainer.step(state, batch)
    got = trainer.eval_step(state, batch)["loss"].item()
    with torch.no_grad():
        model = ResNet.from_state_dict(cfg, state.params, trainable=True)
        labels = batch["label"].long()
        running = torch.nn.functional.cross_entropy(model(
            batch["image"], state.model_state["batch_stats"],
            train=False)[0], labels).item()
        at_fresh = torch.nn.functional.cross_entropy(model(
            batch["image"], fresh, train=False)[0], labels).item()
    assert abs(got - running) <= 1e-6 * max(1.0, abs(running)), (got, running)
    assert abs(got - at_fresh) > 1e-3, (got, at_fresh)
    return {"eval_loss": got, "over_running_stats": running,
            "over_fresh_stats": at_fresh}


def phase_train_resnet20_cifar(results):
    """The port's CIFAR example (``tpucfn_torch/examples/
    cifar10_resnet20.py``) through its ``main(argv)``: ResNet-20, batch
    128, 30 steps with pad-crop and mirror augmentation over synthetic
    CIFAR-10 images, an eval every 10 steps, no checkpoint."""
    import shutil
    import tempfile

    import torch

    root = Path(tempfile.mkdtemp(prefix="train_resnet20_cifar-"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        _zero_launch_counts()
        with _SaveOnly(()):
            _run_example(["--batch-size", "128", "--steps",
                          str(RESNET20_STEPS), "--augment",
                          "--eval-every", "10", "--log-every", "1",
                          "--run-dir", str(root / "run")], per_step,
                         example="cifar10_resnet20")
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        rec = _run_record(root / "run")
        rows = [json.loads(line) for line in (
            root / "run" / "logs" / "train-host000.jsonl"
        ).read_text().splitlines()]
        evals = {r["step"]: (r["eval_loss"], r["eval_accuracy"])
                 for r in rows if "eval_loss" in r}
        eval_check = _eval_reads_running_stats(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    losses = [rec["losses"][i] for i in range(1, RESNET20_STEPS + 1)]
    assert all(map(math.isfinite, losses)), losses
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    assert last < first, (first, last)
    assert sorted(evals) == [10, 20, 30], evals
    assert all(math.isfinite(v) for e in evals.values() for v in e), evals
    assert not any(_launch_counts().values()), _launch_counts()
    steady = rec["step_s"][RESNET_STEADY_FROM - 1:]
    step_s = sum(steady) / len(steady)
    return {"card": results.get("card"), "losses": losses,
            "mean_first_5": first, "mean_last_5": last,
            "eval_loss_accuracy": evals,
            "step_ms": [x * 1e3 for x in rec["step_s"]],
            "step_ms_steady_mean": step_s * 1e3,
            "images_per_s": 128 / step_s, "peak_mem_gib": peak_gib,
            "eval_reads_running_stats": eval_check}


def _product_counter():
    """A ``TorchDispatchMode`` that counts the matmul ops reaching the
    dispatcher (the flash kernels are ``ctypes`` launches: not counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountProducts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = dict.fromkeys(("mm", "addmm", "bmm", "baddbmm"),
                                        0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.counts:
                self.counts[name] += 1
            return func(*args, **(kwargs or {}))

    return CountProducts()


def _remat_grads(torch, cfg, params, batch, chunk, z_loss):
    """Loss and every gradient through the kernels at ``params``, the
    peak memory the forward and backward added to what was allocated
    before them (activations and the gradients; no optimizer state), and
    the products the backward ran."""
    from tpucfn_torch.train import llama_train_fns

    _, loss_fn = llama_train_fns(cfg, chunk_size=chunk, z_loss=z_loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    loss, _ = loss_fn(params, {}, batch, None)
    mode = _product_counter()
    with mode:
        grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    return (loss.item(), grads,
            (torch.cuda.max_memory_allocated() - before) / 2**30,
            mode.counts)


def phase_train_llama3_1b_remat(results):
    """llama3-1b at full width and depth, one batch of 2 x 2048, four
    ``Trainer`` steps under each remat policy (full, the selective
    ``dots`` and ``dots_no_batch``, none), one policy after the other from
    the same init; then the loss and every gradient at that init under
    each policy against full remat's."""
    import dataclasses

    import torch

    from tpucfn_torch.models.llama import LlamaConfig, train_step_flops
    from tpucfn_torch.train import Trainer, llama_train_fns

    base = dataclasses.replace(LlamaConfig.llama3_1b(),
                               param_dtype=torch.float32)
    b, seq, chunk, z_loss = 2, 2048, 512, 1e-4
    batch = _token_batch(torch, b, seq, base.vocab_size)
    n = base.n_layers
    full = {k: v * n for k, v in LAUNCHES_PER_LAYER.items()}
    full.update(k1_sm90=full["k1"], k1_decode=0, k1_mma=0, k1_fma=0,
                k2_sm90=full["k2"], k2_mma=0, k2_fma=0,
                k3_sm90=full["k3"], k3_mma=0, k3_fma=0)
    # no remat: K1 once a layer, in the forward only
    expected = {p: full for p in REMAT_POLICIES}
    expected["none"] = {**full, "k1": n, "k1_sm90": n}
    runs = {}
    torch.cuda.empty_cache()
    _zero_launch_counts()
    for policy in REMAT_POLICIES:
        cfg = dataclasses.replace(base, remat=policy)
        init_fn, loss_fn = llama_train_fns(cfg, chunk_size=chunk,
                                           z_loss=z_loss)
        trainer = Trainer(None, None, loss_fn, _example_chain(REMAT_STEPS),
                          init_fn, device="cuda")
        state = trainer.init(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, per_step = [], [], []
        seen = _launch_counts()
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            state, metrics = trainer.step(state, batch)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            now = _launch_counts()
            per_step.append({k: now[k] - seen[k] for k in now})
            seen = now
        steady = sum(step_s[1:]) / (REMAT_STEPS - 1)
        runs[policy] = {
            "losses": losses, "step_ms": [t * 1e3 for t in step_s],
            "step_ms_steady_mean": steady * 1e3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "train_step_flops": train_step_flops(cfg, b, seq,
                                                 chunked_head=True),
            "launches_per_step": per_step[-1]}
        runs[policy]["mfu_vs_989_tflops"] = (
            runs[policy]["train_step_flops"] / steady / 989e12)
        assert all(c == expected[policy] for c in per_step), (
            policy, per_step, expected[policy])
        assert all(map(math.isfinite, losses)), (policy, losses)
        del state, trainer
        torch.cuda.empty_cache()
    results["remat_launches"] = _launch_counts()
    # One profiled step under full remat and under dots: the device time
    # the saved products spare against the host time the selective
    # checkpoint's dispatch mode adds.
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(base, remat=policy)
        init_fn, loss_fn = llama_train_fns(cfg, chunk_size=chunk,
                                           z_loss=z_loss)
        trainer = Trainer(None, None, loss_fn, _example_chain(REMAT_STEPS),
                          init_fn, device="cuda")
        state = trainer.init(0)
        prof = _profile(torch, lambda: trainer.step(state, batch), 1)
        runs[policy]["profile_step"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "device_busy_share", "kernels_per_call")}
        del state, trainer
        torch.cuda.empty_cache()

    # The first step's loss and, at the same init, every gradient under
    # each policy against full remat's.
    init_fn, _ = llama_train_fns(base)
    params = {k: torch.nn.Parameter(v) for k, v in
              init_fn(torch.Generator("cuda").manual_seed(0))[0].items()}
    names = list(params)
    ref_loss, ref, peak, products = _remat_grads(torch, dataclasses.replace(
        base, remat="full"), params, batch, chunk, z_loss)
    runs["full"].update(fwd_bwd_peak_gib=peak, backward_products=products)
    parity = {}
    for policy in REMAT_POLICIES[1:]:
        loss, grads, peak, products = _remat_grads(
            torch, dataclasses.replace(base, remat=policy), params, batch,
            chunk, z_loss)
        runs[policy].update(fwd_bwd_peak_gib=peak,
                            backward_products=products)
        cos = _cosines(names, grads, ref)
        worst = min(cos, key=cos.get)
        first = runs[policy]["losses"][0]
        parity[policy] = {
            "first_step_loss_rel_diff":
                abs(first - runs["full"]["losses"][0])
                / abs(runs["full"]["losses"][0]),
            "loss_rel_diff": abs(loss - ref_loss) / abs(ref_loss),
            "grad_cosine_min": cos[worst], "grad_cosine_min_at": worst}
        del grads
        torch.cuda.empty_cache()
    del params, ref
    torch.cuda.empty_cache()
    for policy, row in parity.items():
        assert row["first_step_loss_rel_diff"] <= REMAT_LOSS_REL_TOL, (
            policy, row)
        assert row["loss_rel_diff"] <= REMAT_LOSS_REL_TOL, (policy, row)
        assert row["grad_cosine_min"] >= REMAT_GRAD_COSINE, (policy, row)
    order = ("none", "dots", "dots_no_batch", "full")
    for key in ("peak_mem_gib", "fwd_bwd_peak_gib"):
        peaks = [runs[p][key] for p in order]
        assert peaks == sorted(peaks, reverse=True), (key, dict(zip(
            order, peaks)))
    # The selective policies keep the projections' outputs: their
    # backward runs the products no remat's does; full remat's runs more
    # (it recomputes the projections).  The flash forward is no product:
    # its recompute shows in the K1 launches above.
    mm = {p: runs[p]["backward_products"]["mm"] for p in order}
    assert mm["dots"] == mm["dots_no_batch"] == mm["none"] < mm["full"], mm
    return {"card": results.get("card"), "batch": [b, seq],
            "policies": runs, "launches_expected_per_step": expected,
            "parity_vs_full": parity,
            "backward_mm_recomputed_by_full": mm["full"] - mm["none"],
            "tolerances": {"loss_rel": REMAT_LOSS_REL_TOL,
                           "grad_cosine": REMAT_GRAD_COSINE}}


KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "max_abs_err")


# ---- phase 24 --------------------------------------------------------------
# rl train's defaults (bandit, 8 envs, unroll 16, hidden 64), RL_ITERS
# iterations a run.
RL_ITERS = 60
# The reference's learning gate (tests/test_rl.py): lr 5e-2, 40 updates,
# the mean edge over the uniform policy of the last 10 above the first
# 10's by 0.05, and above 0.1.
RL_GATE_LR, RL_GATE_ITERS = 5e-2, 40
# The chaos drill (tests/test_rl_e2e.py): gridworld, unroll 8, 30
# iterations, a save every 5, 0.05 s of host sleep an iteration, host 0
# killed once the fleet step reaches 12 (the view trails the rank by up
# to a beat and a poll: 0.25 s beats put the kill a few iterations later,
# mid-interval and well before 30).
RL_DRILL_ITERS, RL_DRILL_CKPT_EVERY, RL_DRILL_KILL_AT = 30, 5, 12
RL_DRILL_JOB = ["--env", "gridworld", "--unroll", "8", "--iters",
                str(RL_DRILL_ITERS), "--ckpt-every", str(RL_DRILL_CKPT_EVERY),
                "--iter-sleep-s", "0.05", "--log-every", "1000"]
RL_DRILL_HEARTBEAT_S = 0.25
RL_ROW_KEYS = ("loss", "reward_mean", "entropy", "pushed", "popped")


def _rl_rows(run_dir):
    """rl-host000.jsonl by iteration, a resumed re-run winning."""
    return {r["iter"]: r for r in _jsonl(Path(run_dir) / "rl-host000.jsonl")}


def _rl_phase_ms(run_dir):
    """Median act / learn / refresh span (ms) of a run, iteration 1 (the
    warmup, charged to compile) left out."""
    from tpucfn_torch.obs.trace import read_trace_dir

    spans = {}
    for e in read_trace_dir(Path(run_dir) / "trace"):
        if e.get("trace_id", 0) > 1:
            spans.setdefault(e["name"], []).append(e["dur_s"] * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in spans.items()
            if k in ("act", "learn", "refresh")}


def _rl_in_process(torch, root, out):
    """The loop, actor and learner in this process on the card."""
    from tpucfn_torch.rl import (Actor, RLConfig, RLLearner, make_env,
                                 run_rl_loop)
    from tpucfn_torch.rl.loop import fold_in

    def cfg(name, **kw):
        return RLConfig(run_dir=str(root / name), fresh=True,
                        log_every=1000, **{"iters": RL_ITERS,
                                           "ckpt_every": RL_ITERS, **kw})

    # 1. rl train's defaults, twice with one seed, once with another
    seconds = out["seconds_by_part"] = {}
    for name, kw in (("a", {}), ("b", {}), ("c", {"seed": 1, "iters": 5})):
        t0 = time.perf_counter()
        run_rl_loop(cfg(name, **kw))
        seconds[f"run_{name}"] = time.perf_counter() - t0
    a, b, c = _rl_rows(root / "a"), _rl_rows(root / "b"), _rl_rows(root / "c")
    assert sorted(a) == list(range(1, RL_ITERS + 1)), sorted(a)
    assert all(math.isfinite(r[k]) for r in a.values()
               for k in ("loss", "reward_mean", "entropy")), a
    out["same_seed_identical"] = all(
        a[i][k] == b[i][k] for i in a for k in RL_ROW_KEYS)
    out["other_seed_differs"] = any(
        a[i][k] != c[i][k] for i in c for k in ("loss", "reward_mean"))
    assert out["same_seed_identical"] and out["other_seed_differs"]
    ms = _rl_phase_ms(root / "a")
    env_steps = 8 * 16
    out["bandit"] = {
        "first_loss": a[1]["loss"], "last_loss": a[RL_ITERS]["loss"],
        "last_reward_mean": a[RL_ITERS]["reward_mean"],
        "act_ms": ms["act"], "learn_ms": ms["learn"],
        "refresh_ms": ms["refresh"],
        "env_steps_per_s": env_steps / (ms["act"] / 1e3)}

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    # 2. the reference's learning gate
    t0 = time.perf_counter()
    env = make_env("bandit", num_envs=8)
    learner = RLLearner(None, env, lr=RL_GATE_LR)
    actor = Actor(env, learner.apply_fn, unroll=16)
    state = learner.init(0)
    es, obs = actor.reset(gen(1))
    edge = []
    for it in range(RL_GATE_ITERS):
        params = learner.refresh(state)
        es, obs, traj = actor.rollout(params, es, obs, gen(fold_in(7, it)))
        baseline = float(traj["obs"].mean())
        state, metrics = learner.step(state, traj)
        edge.append(float(metrics["reward_mean"]) - baseline)
    first, last = _mean(edge[:10]), _mean(edge[-10:])
    out["learning_gate"] = {"edge_first10": first, "edge_last10": last}
    assert last > first + 0.05 and last > 0.1, (first, last)

    # 3. a rollout of each env with every host sync an error, and the
    # actors' params unchanged by a learner step
    seconds["learning_gate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in ("bandit", "gridworld"):
        env = make_env(name, num_envs=8)
        learner = RLLearner(None, env)
        actor = Actor(env, learner.apply_fn, unroll=16)
        state = learner.init(0)
        params = learner.refresh(state)
        es, obs = actor.reset(gen(1))
        g = gen(2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, traj = actor.rollout(params, es, obs, g)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        before = {k: v.clone() for k, v in params.items()}
        state, _ = learner.step(state, traj)
        torch.cuda.synchronize()
        assert all(torch.equal(before[k], params[k]) for k in params), name
        assert not all(torch.equal(before[k], state.params[k])
                       for k in params), name
    out["rollout_host_syncs"] = 0
    seconds["sync_checks"] = time.perf_counter() - t0


def _rl_drill(root, out):
    """create-stack, then launch --ft --chaos (kill at iteration 12) of rl
    train on the card in subprocesses, against an uninterrupted rl train
    in this process."""
    import os
    import signal

    from tpucfn_torch.ft import replay_journal

    state, name = root / "state", "rl"
    run_dir = state / "clusters" / name
    ft_dir = run_dir / "ft"
    env = dict(os.environ, PYTHONPATH=str(HERE))
    cli = [sys.executable, "-m", "tpucfn_torch.cli", "--state-dir",
           str(state)]
    seconds = out["seconds_by_part"]
    # the cluster on the fake control plane (the CLI in this process: a
    # process of its own would spend its time importing torch)
    rc, text = _cli_main(["--state-dir", str(state), "create-stack",
                          "--name", name, "--accelerator", "h100-1"])
    assert rc == 0 and f"CREATE_COMPLETE {name}" in text, (rc, text)
    spec = root / "chaos.json"
    spec.write_text(json.dumps({"seed": 0, "events": [
        {"action": "kill", "at_step": RL_DRILL_KILL_AT, "host": 0}]}))
    log_out, log_err = root / "launch.out", root / "launch.err"
    t0, wall0 = time.perf_counter(), time.time()
    with open(log_out, "w") as fo, open(log_err, "w") as fe:
        proc = subprocess.Popen(
            cli + ["launch", "--name", name, "--ft",
                   "--ft-restart-budget", "1",
                   "--ft-heartbeat-interval", str(RL_DRILL_HEARTBEAT_S),
                   "--ft-backoff", "0",
                   "--ft-startup-grace", str(FT_STARTUP_GRACE_S),
                   "--chaos", str(spec), "--", sys.executable, "-m",
                   "tpucfn_torch.cli", "rl", "train", *RL_DRILL_JOB,
                   "--run-dir", str(run_dir)],
            env=env, cwd=HERE, stdout=fo, stderr=fe, start_new_session=True)
        try:
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                # the coordinator and the ranks it spawned: one group
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    seconds["launch"] = time.perf_counter() - t0
    stdout = log_out.read_text()
    if rc != 0 or "launch finished rc=0" not in stdout:
        print(log_err.read_text()[-6000:], file=sys.stderr)
    assert rc == 0 and "launch finished rc=0" in stdout, (rc, stdout[-3000:])

    ev = _jsonl(ft_dir / "events.jsonl")
    kinds = [e["kind"] for e in ev]
    fired = [r for r in replay_journal(ft_dir / "journal" / "journal.jsonl")[1]
             if r["kind"] == "chaos_fired"]
    decides = [e for e in ev if e["kind"] == "decide"]
    # each event's second from the launch's start
    out["events"] = [(e["kind"], round(e["ts"] - wall0, 3)) for e in ev]
    out["kill_fired_s"] = [round(f["ts"] - wall0, 3) for f in fired]
    # each incarnation's goodput window: its loop's start
    out["windows_s"] = [
        round(w["t"] - wall0, 3)
        for w in _jsonl(run_dir / "goodput" / "goodput-host000.jsonl")
        if w.get("kind") == "window"]
    assert [f["action"] for f in fired] == ["kill"], fired
    assert [(d["action"], d["planned"]) for d in decides] == [
        ("gang_restart", False)], decides
    assert "rl_run_start" in kinds, kinds
    resumed = next(e for e in ev if e["kind"] == "rl_resumed")
    out["resumed_from"] = resumed["ckpt_step"]
    assert (resumed["ckpt_step"] >= RL_DRILL_CKPT_EVERY
            and resumed["ckpt_step"] % RL_DRILL_CKPT_EVERY == 0
            and resumed["iteration"] == resumed["ckpt_step"]), resumed
    rows = _rl_rows(run_dir)
    out["pids"] = len({r["pid"] for r in rows.values()})
    assert out["pids"] == 2, out["pids"]

    # the uninterrupted run, in this process
    t0 = time.perf_counter()
    rc, text = _cli_main(["rl", "train", *RL_DRILL_JOB, "--run-dir",
                          str(root / "whole")])
    assert rc == 0, text[-2000:]
    seconds["uninterrupted"] = time.perf_counter() - t0
    ref = _rl_rows(root / "whole")
    steps = list(range(1, RL_DRILL_ITERS + 1))
    assert sorted(rows) == sorted(ref) == steps, (sorted(rows), sorted(ref))
    diff = [i for i in steps for k in RL_ROW_KEYS
            if rows[i][k] != ref[i][k]]
    out["rows_equal_uninterrupted"] = not diff
    assert not diff, (diff, rows[diff[0]], ref[diff[0]])

    report = _goodput_report(run_dir)
    b = report["buckets"]
    out["goodput"] = {"wall_s": report["wall_s"],
                      "sum_over_wall": sum(b.values()) / report["wall_s"],
                      **{k: b[k] for k in ("act", "learn", "refresh",
                                           "compile", "ckpt",
                                           "restart_downtime", "idle")}}
    for k in ("act", "learn", "refresh"):
        assert b[k] > 0, (k, b)


def phase_rl_anakin(results):
    """The RL plane on the card: the bandit at rl train's defaults, the
    learning gate, a rollout with every host sync an error, the refresh
    across a learner step, same-seed identity, and the chaos drill under
    launch --ft; no flash kernel launched."""
    import shutil
    import tempfile

    import torch

    root = Path(tempfile.mkdtemp(prefix="rl_anakin-"))
    out = {"card": results.get("card")}
    try:
        _zero_launch_counts()
        with _flight_hooks_go_with_the_run():
            _rl_in_process(torch, root, out)
            _rl_drill(root, out)
        launches = _launch_counts()
        out["flash_launches"] = sum(launches.values())
        assert not any(launches.values()), launches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 25 --------------------------------------------------------------
# ImageNet-shaped records (224 x 224 x 3 uint8 and a label) through the
# ResNet-50 example's staging.
INPUT_N, INPUT_SHARDS = 256, 4


def phase_input_native(results):
    """The native tpurecord reader, built from the checkout with g++, on
    ImageNet-shaped shards: the same records as the Python reader, the
    dataset on it, its CRC and truncation errors, and both readers'
    records/s (a warm page cache: the shards were just written)."""
    import shutil
    import tempfile

    from tpucfn_torch.data import ShardedDataset, native
    from tpucfn_torch.data.records import read_record_shard
    from tpucfn_torch.examples.common import stage_synthetic

    root = Path(tempfile.mkdtemp(prefix="input_native-"))
    out = {"card": results.get("card"), "records": INPUT_N,
           "shards": INPUT_SHARDS}
    try:
        t0 = time.perf_counter()
        available = native.native_available()
        out["load_s"] = time.perf_counter() - t0
        out["native_available"] = available
        assert available, native.native_error()
        paths = stage_synthetic("imagenet", root / "data", n=INPUT_N,
                                num_shards=INPUT_SHARDS)
        out["bytes"] = sum(p.stat().st_size for p in paths)

        def records_per_s(read):
            """Every record read, CRC-checked and handed over (bytes from
            the Python reader, views over the mapping from the native
            one); the best of three passes."""
            best = math.inf
            for _ in range(3):
                t = time.perf_counter()
                n = sum(1 for p in paths for _ in read(p))
                best = min(best, time.perf_counter() - t)
            assert n == INPUT_N, n
            return INPUT_N / best

        out["python_records_per_s"] = records_per_s(read_record_shard)
        out["native_records_per_s"] = records_per_s(
            native.read_record_shard_native)
        for p in paths:
            py = list(read_record_shard(p))
            assert [bytes(v) for v in native.read_record_shard_native(p)] \
                == py and py, p
        ds = ShardedDataset(paths, batch_size_per_process=32,
                            process_index=0, process_count=1)
        batch = next(iter(ds.epoch(0)))
        out["dataset_reader"] = ds.reader
        assert ds.reader == "native" and batch["image"].shape == (
            32, 224, 224, 3), (ds.reader, batch["image"].shape)

        bad = root / "flipped.tpurec"
        raw = bytearray(paths[0].read_bytes())
        raw[-3] ^= 0xFF
        bad.write_bytes(bytes(raw))
        r = native.NativeShardReader(bad)
        try:
            list(r)
            raise AssertionError("a flipped byte read back without error")
        except ValueError as e:
            assert "CRC" in str(e), e
        finally:
            r.close()
        cut = root / "cut.tpurec"
        cut.write_bytes(paths[0].read_bytes()[:-50])
        try:
            native.NativeShardReader(cut)
            raise AssertionError("a truncated shard opened without error")
        except ValueError as e:
            assert "truncated" in str(e), e
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ---- phase 26 --------------------------------------------------------------
# llama3-1b's attention (32 heads, 8 KV heads, D = 64), one row.  Each case:
# (label, S, W virtual ranks, dtype, causal, held against).
RING_HEADS = dict(h=32, hkv=8, d=64)
RING_CASES = (("ring_vs_full", 32768, 8, "bfloat16", True, "full"),
              ("ring_flash_vs_dense_fp32", 8192, 4, "float32", True,
               "dense"),
              ("ring_flash_vs_dense_bf16", 8192, 4, "bfloat16", True,
               "dense"),
              ("ring_noncausal", 8192, 4, "bfloat16", False, "dense"))
RING_VARIANT = {"bfloat16": "sm90", "float32": "mma"}


def _virtual_ring(torch, q, k, v, w, causal, hop_attention):
    """The port's ring over ``w`` virtual ranks in this process: rank i
    runs ``ring_hops`` (the hop loop of ``ring_attention``) on its Q block,
    handed at step t the K/V block of rank (i - t) % w, the one the
    neighbour exchange would have brought it; autograd takes each hop's
    gradients back to the blocks.  Returns the whole (B, S, H, D)."""
    from tpucfn_torch.kernels import ring_hops

    s = q.shape[1] // w

    def blk(t, j):
        return t[:, j * s:(j + 1) * s]

    return torch.cat([ring_hops(
        blk(q, i), lambda step, i=i: (blk(k, (i - step) % w),
                                      blk(v, (i - step) % w)),
        size=w, index=i, causal=causal, hop_attention=hop_attention)
        for i in range(w)], dim=1)


def _ring_case(torch, timer, label, s, w, dtype, causal, against):
    """One ring, forward and backward: its K1/K2/K3/Delta launches counted
    from 0 and gated exactly; out, dQ, dK, dV held against one
    full-sequence ``flash_attention_with_lse`` call or the same ring with
    dense hops, each tensor within ``BWD_REL_TOL`` of its reference's
    largest magnitude; the ring's time beside the full call's: CUDA
    events around a call (host gaps included) and the kernels' device
    time of a profiled call."""
    from tpucfn_torch.kernels import flash_attention as fa

    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(len(label))
    h, hkv, d = RING_HEADS["h"], RING_HEADS["hkv"], RING_HEADS["d"]
    q = torch.randn(1, s, h, d, generator=g, device="cuda").to(dt)
    k = torch.randn(1, s, hkv, d, generator=g, device="cuda").to(dt)
    v = torch.randn(1, s, hkv, d, generator=g, device="cuda").to(dt)
    do = torch.randn(1, s, h, d, generator=g, device="cuda").to(dt)
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def fwd_bwd(fn):
        out = fn()
        return [out.detach(), *torch.autograd.grad(out, (q, k, v), do)]

    def ring():
        return _virtual_ring(torch, q, k, v, w, causal, "flash")

    if against == "full":
        def reference():
            return fa.flash_attention_with_lse(q, k, v, causal=causal)[0]
    else:
        def reference():
            return _virtual_ring(torch, q, k, v, w, causal, "dense")

    _zero_launch_counts()
    got = fwd_bwd(ring)
    torch.cuda.synchronize()
    launches = _launch_counts()
    hops = w * (w + 1) // 2 if causal else w * w
    variant = RING_VARIANT[dtype]
    want = {"k1": hops, "k2": hops, "k3": hops, "delta": hops,
            f"k1_{variant}": hops, f"k2_{variant}": hops,
            f"k3_{variant}": hops}
    counted = {key: launches[key] for key in want}
    ref = fwd_bwd(reference)
    torch.cuda.synchronize()
    ok, worst, tensors = _bwd_errs(dict(zip(
        ("out", "dq", "dk", "dv"), zip(got, ref))), dt)
    row = {"case": label, "s": s, "virtual_ranks": w, "s_local": s // w,
           "dtype": dtype, "causal": causal, "against": against,
           "launches": launches, "launches_expected": want,
           "launches_ok": counted == want, "ok": ok, "max_abs_err": worst,
           "tensors": tensors,
           "ring": {"events_ms": timer(lambda: fwd_bwd(ring), iters=3,
                                      warmup=1),
                    **_profile(torch, lambda: fwd_bwd(ring), 1, "flash_")}}
    if against == "full":
        row["full"] = {"events_ms": timer(lambda: fwd_bwd(reference),
                                          iters=3, warmup=1),
                       **_profile(torch, lambda: fwd_bwd(reference), 1,
                                  "flash_")}
    del got, ref
    torch.cuda.empty_cache()
    return row


def phase_ring_llama3_1b(results):
    """Ring attention's numerics on the card at llama3-1b's attention
    shape: the port's hop loop over W virtual ranks with the exchange
    replaced (one card holds no two NCCL ranks), its launches gated
    exactly, held against the full call and the dense ring; then K1 and
    the backward kernels at the diagonal hop's and a past hop's shape,
    each against its plain version, rows beside the kernel phases'."""
    import torch

    timer = Timer(torch)
    rows = []
    totals = {}
    for case in RING_CASES:
        row = _ring_case(torch, timer, *case)
        emit({"ring_case": row})
        rows.append(row)
        for key, n in row["launches"].items():
            totals[key] = totals.get(key, 0) + n
    bad = [r["case"] for r in rows if not (r["ok"] and r["launches_ok"])]
    if bad:
        raise AssertionError(f"ring cases off: {bad}")
    results["ring_launches"] = totals

    bf, hop = torch.bfloat16, dict(b=1, sq=4096, sk=4096, **RING_HEADS)
    fwd = [_one_case(torch, timer, "ring_diagonal_hop", dtype=bf,
                     q_offset=[0], causal=True, **hop),
           _one_case(torch, timer, "ring_past_hop", dtype=bf, q_offset=[0],
                     causal=False, **hop)]
    bwd = [_bwd_case(torch, timer, "ring_diagonal_hop", dtype=bf, **hop),
           _bwd_case(torch, timer, "ring_past_hop", dtype=bf, causal=False,
                     dlse=True, **hop)]
    for row in fwd:
        emit({"kernel_case": row})
    for row in bwd:
        emit({"kernel_bwd_case": row})
    bad = [r["case"] for r in fwd + bwd if not r["ok"]]
    if bad:
        raise AssertionError(f"kernels off at the ring's hop shapes: {bad}")
    results["kernel_rows"] = results.get("kernel_rows", []) + fwd
    results["kernel_bwd_rows"] = results.get("kernel_bwd_rows", []) + bwd
    main = rows[0]
    return {"card": results.get("card"), "cases": len(rows),
            "launches": totals,
            "ring_vs_full_ms": {k: main["ring"][k] for k in (
                "events_ms", "device_ms")},
            "full_ms": {k: main["full"][k] for k in ("events_ms",
                                                     "device_ms")},
            "worst_rel_err": {r["case"]: max(
                t["max_abs_err"] / max(t["ref_max_abs"], 1e-30)
                for t in r["tensors"].values()) for r in rows}}


def _kernels_line(results):
    """One entry per kernel variant: launches counted on the paths that run
    it (each path counted from 0 on its own), times at its main path's
    shape, the worst error over every shape it was compared at."""
    fwd = results["kernel_rows"]
    bwd = results["kernel_bwd_rows"]
    train, tiny = results["train_launches"], results["train_tiny_launches"]
    example = results["example_launches"]
    packed = results["example_packed_launches"]
    ft = results["ft_launches"]
    planes = results["planes_launches"]
    provision = results["provision_launches"]
    serve = results["serve_launches"]
    serve_tiny = results["serve_tiny_launches"]
    spec, router = results["spec_launches"], results["router_launches"]
    unet, unet_tiny = results["unet_launches"], results["unet_tiny_launches"]
    moe, moe_tiny = results["moe_launches"], results["moe_tiny_launches"]
    mixtral, lora = results["mixtral_launches"], results["lora_launches"]
    remat = results["remat_launches"]
    ring = results["ring_launches"]
    from tpucfn_torch.kernels import flash_attention as fa

    def head_dims(name):
        """The head dims the kernel is built for."""
        if name == "flash_bwd_delta":
            return fa.HEAD_DIMS
        variant = next((v for v in ("decode", "mma", "fma")
                        if f"_{v}" in name), "sm90")
        return fa.VARIANT_HEAD_DIMS[variant]

    def entry(name, source, replaces, paths, rows, at, key=None):
        pick = (lambda r: r) if key is None else (lambda r: r[key])
        main = pick(next(r for r in rows if r["case"] == at))
        return {"name": name, "route": "cuda",
                "source": f"tpucfn_torch/kernels/csrc/{source}",
                "replaces": f"tpucfn/kernels/flash_attention.py:{replaces}",
                "launches": sum(paths.values()), "launches_by_path": paths,
                "head_dims": list(head_dims(name)),
                **{k: main[k] for k in KEYS},
                "max_abs_err": max(pick(r)["max_abs_err"] for r in rows),
                "at": at,
                "shapes": [{"case": r["case"], **{k: pick(r)[k] for k in KEYS}}
                           for r in rows]}

    def of(rows, variant, key=None):
        return [r for r in rows
                if (r if key is None else r[key])["variant"] == variant]

    def fma_beside(rows, key=None):
        """The old fma kernel's rows, from its turns beside mma: its own
        ms (the mean of its turns), error and bound; the plain and library
        times of the same inputs."""
        out = []
        for r in rows:
            row = r if key is None else r[key]
            if "fma_beside" not in row:  # a head dim fma is not built for
                continue
            fb = row["fma_beside"]
            out.append({"case": r["case"], **{k: fb[k] for k in (
                "max_abs_err", "bound_ms", "bound_by")},
                "ms": sum(fb["fma_ms"]) / len(fb["fma_ms"]),
                "plain_ms": row["plain_ms"],
                "library_ms": row["library_ms"]})
        return out

    kernels = [
        entry("flash_fwd_sm90", "flash_fwd_sm90.cu", 98,
              {"serve_llama3_1b": serve["flash_fwd_sm90"],
               "serve_spec_llama3_1b": spec["sm90"],
               "serve_router_llama3_1b": router["sm90"],
               "train_llama3_1b": train["k1_sm90"],
               "example_llama3_1b": example["k1_sm90"],
               "example_llama3_1b_packed": packed["k1_sm90"],
               "ft_llama3_1b": ft["k1_sm90"],
               "planes_llama3_1b": planes["k1_sm90"],
               "provision_llama3_1b": provision["k1_sm90"],
               "train_unet_sd15": unet["k1_sm90"],
               "train_moe_llama3_1b": moe["k1_sm90"],
               "serve_mixtral_8x7b": mixtral["sm90"],
               "lora_llama3_1b": lora["k1_sm90"],
               "train_llama3_1b_remat": remat["k1_sm90"],
               "ring_llama3_1b": ring["k1_sm90"]},
              of(fwd, "sm90"), "train_llama3_1b"),
        entry("flash_fwd_decode_sm90", "flash_fwd_decode_sm90.cu", 98,
              {"serve_llama3_1b": serve["flash_fwd_decode_sm90"],
               "serve_spec_llama3_1b": spec["decode"],
               "serve_router_llama3_1b": router["decode"],
               "serve_mixtral_8x7b": mixtral["decode"]},
              of(fwd, "decode"), "decode_llama3_1b"),
        # the verify pass of speculative decoding (widths 5 and 9: 20
        # and 36 packed rows), and every fp32 call
        entry("flash_fwd_mma_sm90", "flash_fwd_mma_sm90.cu", 98,
              {"serve_spec_llama3_1b": spec["mma"],
               "serve_router_llama3_1b": router["mma"],
               "serve_spec_tiny_fp32": results["spec_tiny_launches"],
               "serve_tiny_fp32": serve_tiny["flash_fwd_mma"],
               "train_tiny_fp32": tiny["k1_mma"],
               "train_unet_tiny_fp32": unet_tiny["k1_mma"],
               "train_moe_tiny_fp32": moe_tiny["k1_mma"],
               "ring_llama3_1b": ring["k1_mma"]},
              of(fwd, "mma"), "verify_sq5_serving_offsets"),
        # on no path: timed beside mma in turns
        entry("flash_fwd_fma", "flash_fwd.cu", 98, {},
              fma_beside(of(fwd, "mma")), "verify_sq5_serving_offsets"),
        entry("flash_bwd_delta", "flash_bwd.cu", 393,
              {"train_llama3_1b": train["delta"],
               "train_tiny_fp32": tiny["delta"],
               "example_llama3_1b": example["delta"],
               "example_llama3_1b_packed": packed["delta"],
               "ft_llama3_1b": ft["delta"],
               "planes_llama3_1b": planes["delta"],
               "provision_llama3_1b": provision["delta"],
               "train_unet_sd15": unet["delta"],
               "train_unet_tiny_fp32": unet_tiny["delta"],
               "train_moe_llama3_1b": moe["delta"],
               "train_moe_tiny_fp32": moe_tiny["delta"],
               "lora_llama3_1b": lora["delta"],
               "train_llama3_1b_remat": remat["delta"],
               "ring_llama3_1b": ring["delta"]}, bwd,
              "train_llama3_1b",
              "delta"),
        entry("flash_bwd_dq_sm90", "flash_bwd_dq_sm90.cu", 248,
              {"train_llama3_1b": train["k2_sm90"],
               "example_llama3_1b": example["k2_sm90"],
               "example_llama3_1b_packed": packed["k2_sm90"],
               "ft_llama3_1b": ft["k2_sm90"],
               "planes_llama3_1b": planes["k2_sm90"],
               "provision_llama3_1b": provision["k2_sm90"],
               "train_unet_sd15": unet["k2_sm90"],
               "train_moe_llama3_1b": moe["k2_sm90"],
               "lora_llama3_1b": lora["k2_sm90"],
               "train_llama3_1b_remat": remat["k2_sm90"],
               "ring_llama3_1b": ring["k2_sm90"]},
              of(bwd, "sm90", "dq"), "train_llama3_1b", "dq"),
        entry("flash_bwd_dq_mma_sm90", "flash_bwd_dq_mma_sm90.cu", 248,
              {"train_tiny_fp32": tiny["k2_mma"],
               "train_unet_tiny_fp32": unet_tiny["k2_mma"],
               "train_moe_tiny_fp32": moe_tiny["k2_mma"],
               "ring_llama3_1b": ring["k2_mma"]},
              of(bwd, "mma", "dq"), "fp32_d16_gqa2", "dq"),
        # on no path: timed beside mma in turns
        entry("flash_bwd_dq_fma", "flash_bwd.cu", 248, {},
              fma_beside(of(bwd, "mma", "dq"), "dq"), "fp32_d16_gqa2"),
        entry("flash_bwd_dkv_sm90", "flash_bwd_dkv_sm90.cu", 308,
              {"train_llama3_1b": train["k3_sm90"],
               "example_llama3_1b": example["k3_sm90"],
               "example_llama3_1b_packed": packed["k3_sm90"],
               "ft_llama3_1b": ft["k3_sm90"],
               "planes_llama3_1b": planes["k3_sm90"],
               "provision_llama3_1b": provision["k3_sm90"],
               "train_unet_sd15": unet["k3_sm90"],
               "train_moe_llama3_1b": moe["k3_sm90"],
               "lora_llama3_1b": lora["k3_sm90"],
               "train_llama3_1b_remat": remat["k3_sm90"],
               "ring_llama3_1b": ring["k3_sm90"]},
              of(bwd, "sm90", "dkv"), "train_llama3_1b", "dkv"),
        entry("flash_bwd_dkv_mma_sm90", "flash_bwd_dkv_mma_sm90.cu", 308,
              {"train_tiny_fp32": tiny["k3_mma"],
               "train_unet_tiny_fp32": unet_tiny["k3_mma"],
               "train_moe_tiny_fp32": moe_tiny["k3_mma"],
               "ring_llama3_1b": ring["k3_mma"]},
              of(bwd, "mma", "dkv"), "fp32_d16_gqa2", "dkv"),
        # on no path: timed beside mma in turns
        entry("flash_bwd_dkv_fma", "flash_bwd.cu", 308, {},
              fma_beside(of(bwd, "mma", "dkv"), "dkv"), "fp32_d16_gqa2"),
    ]
    # A kernel that a run of one of its paths never launched fails the
    # line (the old fma kernels of K1, K2 and K3 have no path).
    idle = [f"{k['name']} on {path}" for k in kernels
            for path, n in k["launches_by_path"].items() if not n]
    if idle:
        raise AssertionError(f"kernels never launched on a path: {idle}")
    return {"kernels": kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    wanted = [p for p in args.phases.split(",") if p]
    if not (HERE / "tpucfn_torch").is_dir():
        print("chip_smoke: the tpucfn_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fp32 means fp32: no TF32 in the plain versions' products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    results: dict = {}
    phase = Phase()
    fns = {"device": lambda: phase_device(results),
           "build": lambda: phase_build(),
           "kernel": lambda: phase_kernel(results),
           "kernel_bwd": lambda: phase_kernel_bwd(results),
           "serve_llama3_1b": lambda: phase_serve_llama3_1b(results),
           "serve_tiny_fp32": lambda: phase_serve_tiny_fp32(results),
           "serve_spec_llama3_1b": lambda: phase_serve_spec_llama3_1b(results),
           "serve_router_llama3_1b":
               lambda: phase_serve_router_llama3_1b(results),
           "serve_cli_llama3_1b": lambda: phase_serve_cli_llama3_1b(results),
           "train_llama3_1b": lambda: phase_train_llama3_1b(results),
           "train_tiny_fp32": lambda: phase_train_tiny_fp32(results),
           "example_llama3_1b": lambda: phase_example_llama3_1b(results),
           "ft_llama3_1b": lambda: phase_ft_llama3_1b(results),
           "planes_llama3_1b": lambda: phase_planes_llama3_1b(results),
           "provision_llama3_1b":
               lambda: phase_provision_llama3_1b(results),
           "train_unet_sd15": lambda: phase_train_unet_sd15(results),
           "train_bert_base": lambda: phase_train_bert_base(results),
           "train_moe_llama3_1b":
               lambda: phase_train_moe_llama3_1b(results),
           "serve_mixtral_8x7b": lambda: phase_serve_mixtral_8x7b(results),
           "lora_llama3_1b": lambda: phase_lora_llama3_1b(results),
           "train_resnet50_imagenet":
               lambda: phase_train_resnet50_imagenet(results),
           "train_resnet20_cifar":
               lambda: phase_train_resnet20_cifar(results),
           "train_llama3_1b_remat":
               lambda: phase_train_llama3_1b_remat(results),
           "rl_anakin": lambda: phase_rl_anakin(results),
           "input_native": lambda: phase_input_native(results),
           "ring_llama3_1b": lambda: phase_ring_llama3_1b(results)}
    for name in wanted:
        phase.run(name, fns[name])
        if phase.failed:
            return 1
    if set(wanted) != set(PHASES):
        print("chip_smoke: partial run, no result", file=sys.stderr)
        return 2
    # The card's name and power limit again, near the end of the output,
    # where a reader that keeps only the tail still finds it.
    try:
        line = _kernels_line(results)
    except AssertionError:
        traceback.print_exc()
        return 1
    print(results["card"] or "nvidia-smi: no output", flush=True)
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
