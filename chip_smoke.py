#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one GPU.

    python3 chip_smoke.py [--seed N]   # needs one CUDA device

Phases (any mismatch exits non-zero; nothing is caught and swallowed):

1. Device: the card's name, power limit and maximum SM clock; build the
   seven Hopper kernel libraries (top-k, attention, SSD and selective
   scan, and the backward of the last three) from the sources in this
   checkout, one ``nvcc`` each,
   all at once, and time the build; log each main-path kernel's
   registers a thread and spill bytes from ptxas's report of the build
   (the SSD backward's two bf16 entries and the selective-scan
   backward's bf16 ds-16 entry must spill nothing; both attention
   kernels at each (q.k, v) width pair built), the SASS loop counts
   of both scan kernels and of the selective-scan backward (its inner
   loops' instructions a state-step, and its global atomics and bulk
   reduce-adds, which must be none) and the tensor-core products in the
   backward entries.
2. The top-k kernel against its plain PyTorch version on the card, on
   the same synthetic inputs: indices equal, values bitwise. The 105-case
   matrix includes the shapes the later phases give the kernel (N=200,
   k=10; N=10,000, k=100; N=1,048,576, k=100); ``TOPK_EDGES`` add ±0 and
   ±NaN scores, an all-SENTINEL population, flat ties, k in {1, 100,
   8192} at N around the kernel's tiles and at 4M clients, and
   index_offset.
3. Selection at fleet scale: 1,048,576 clients, ``eafl``, k=100, three
   rounds of select + simulate_round; the kernel launches once a round,
   and the indices equal the same rounds run on the CPU (plain version).
4. Training parity: ``run_fl`` at the paper model's full width and the
   FLConfig defaults (200 clients, k=10, 10 local steps, B=20), three
   rounds, on the card and on the CPU, TF32 off. The CPU run ranks with
   the affine-folded exploit route, the card with the kernel.
5. Training at scale, the main path: 10,000 clients, k=100, three rounds
   on the card.
6. Timing, on the inputs that phases 5 and 3 gave the kernel: kernel,
   plain version and one ``torch.topk`` in turns, the kernel at k=1, the
   host microseconds of one wrapper call (no synchronise), and the
   card's name and power limit.

The fused engines (each round one step with no host read, captured in a
CUDA graph after a warm-up and replayed):

6a. Fused selection at fleet scale: ``run_rounds_scanned`` at 1,048,576
   clients, ``eafl``, k=100, 3 rounds; its picks, dropouts and batteries
   equal host rounds (``select`` + ``simulate_round``, the same kernel)
   with the same key rows; seconds for the 3 rounds.
6b. Fused training parity: ``run_fl_scanned`` against the host ``run_fl``
   on the card at the FLConfig defaults, full width, 3 rounds, TF32 off,
   plain and with faults (crash with retries, straggle, corrupt) and a
   budget, at tests/test_torch_training_engines.py's tolerances; then
   with ``checkpoint_every=1`` and resumed after round 1, both bitwise
   equal to the uninterrupted run (cuDNN's deterministic algorithms).
6c. The fused main path: ``run_fl_scanned`` at 10,000 clients, k=100, full
   width: a 3-round run minus a 1-round run, each less its warm-up and
   capture, over 2, is a round, beside phase 5's; set-up and warm-up +
   capture apart.
6d. A ``torch.profiler`` trace of one round of each engine at 10,000
   clients: the ten device operations that take the most time and the
   device's idle share.

The buffered-asynchronous (FedBuff) engines, buffer 25 and concurrency 100
at k = 100 (``examples/async_fedbuff.py``'s ratio), staleness power 0.5:

6e. Async selection at fleet scale: ``run_async_scanned`` at 1,048,576
   clients (bandwidths at their network's median, so arrivals tie),
   ``eafl``, 4 aggregations, each replayed from a CUDA graph; every
   flush, refill, staleness, damping weight, dropout and battery equal to
   eager steps of ``make_async_round_engine`` with the same keys, and each
   flush to the event clock recomputed on the host (the earliest arrivals,
   equal times lowest index first; the staleness; ``(1 + s) ** -0.5``);
   top-k at k = 100 for the fill and k = 25 a refill; seconds, with the
   fill, warm-up and capture apart.
6f. Async training parity: ``run_fl_async_scanned`` against the host
   event loop ``run_fl_async`` on the card, the FLConfig defaults at full
   width (200 clients, k = 10), buffer 4, concurrency 10, 6 aggregations,
   TF32 off, cuDNN's deterministic algorithms, plain and with a fleet
   budget and recharge: the flush and refill columns equal, the damping
   weights bitwise, the history at the tests' tolerances; it fails if no
   flush is stale or the budget refuses no batch. Then with
   ``checkpoint_every=2`` and resumed after aggregation 2, bitwise equal
   to the uninterrupted run.
6g. The async main path: ``run_fl(mode="async")`` at 10,000 clients, full
   width, host and fused engines: seconds an aggregation (a 3-aggregation
   run minus a 1-aggregation run, over 2), set-up, warm-up + capture and
   peak device memory apart, and one profiled aggregation of each (top
   device operations, idle share).

The front doors (the knob controller, the dispatch, the host oracle, the
``train`` launcher):

6h. ``run_fl`` with the UCB knob controller in the host loop, the FLConfig
   defaults at full width, cuDNN's deterministic algorithms, 7 rounds over
   five arms (k = 5, 10, 20; ``compression_sparsity`` under topk
   compression; ``buffer_size`` with ``staleness_power=0.5``): the
   untried arms pulled first in index order, each round's top-k launch at
   its arm's k and equal to its plain version, a run checkpointed after
   round 3 and resumed bitwise equal to the run without a break, and an
   all-inherit controller bitwise the controller-free run; then 10,000
   clients, k = 100: s/round with the all-inherit controller and its
   reward probe beside the same run without a controller, in turns
   (plain, controller, controller, plain), and one probe evaluation
   timed alone.
6i. ``run_rounds`` at 1,048,576 clients (phase 3's population, k = 100,
   3 rounds): ``"auto"`` resolves to ``"scanned"``, ``"async"`` to
   ``"async-scanned"`` (buffer 25, concurrency 100), and those and the
   forced names give trajectories index for index equal to direct calls
   of ``run_rounds_scanned`` and ``run_async_scanned``; then
   ``repro_torch.examples.million_client_selection`` on the card: the
   kernel against its plain version, and ``select`` (the kernel) against
   the host oracle ``select_host``, index for index, with both times,
   and its sharded step 4 on a one-shard mesh.
6j. ``python -m repro_torch.launch.train fl --rounds 2`` in a process of
   its own on the card: exit 0 and a ``history.json`` of 2 rounds.

The sharded synchronous engines, over a ``clients`` mesh
(``repro_torch/launch/mesh.py``; virtual shards in one process on the
one card, or a ``torch.distributed`` process group):

6k. ``run_rounds_sharded`` at 1,048,576 clients (phase 3's population,
   eafl, k = 100, 3 rounds) on virtual meshes of 1, 2 and 8 shards, each
   round one CUDA-graph replay that launches the top-k kernel once a
   shard with its own ``index_offset``: selected, chosen, succeeded,
   dropouts, batteries and selector state equal to ``run_rounds_scanned``
   with the same key; then one step where every score ties, which must
   pick the lowest indices on every mesh; seconds a replayed round and
   capture beside the single-device engine's.
6l. ``run_fl(engine="sharded")`` (one shard) and ``run_fl_sharded`` on
   4 shards at 10,000 clients, k = 100, full width, 3 rounds, against
   ``run_fl_scanned`` (cuDNN's deterministic algorithms): the selection
   columns equal, one shard bitwise, four within
   tests/test_torch_training_engines.py's tolerances; each replayed round
   timed alone beside the fused engine's, capture apart; one profiled
   round of the 4-shard engine (idle share); the fused engine's
   ``train-sync`` snapshot after round 2 resumed on 4 shards.
6m. A ``torch.distributed`` NCCL group of world size 1 (a ``FileStore``,
   bootstrap on the loopback) and ``run_rounds_sharded`` and
   ``run_async_sharded`` over its process-group mesh at 1,048,576
   clients: the collectives run through NCCL and are captured in the
   round's and the aggregation's graphs (counted during capture), and
   each run is bitwise the virtual one-shard mesh's.

The sharded buffered-asynchronous (FedBuff) engines and the restart
checker (buffer 25, concurrency 100, k = 100, as phases 6e-6g):

6n. ``run_async_sharded`` at 1,048,576 clients (phase 6e's population,
   where arrivals tie; eafl, 4 aggregations) on virtual meshes of 1, 2
   and 8 shards, each aggregation one CUDA-graph replay that launches
   the top-k kernel once a shard with its own ``index_offset`` (and the
   fill once a shard): the flush, refill, staleness, damping, clock and
   in-flight columns, the final event state and the selector state equal
   to ``run_async_scanned`` with the same key, batteries and summed
   statistics within rtol 1e-6; then one aggregation in which every
   arrival ties, across shard boundaries, which must complete the lowest
   indices with each one's own staleness on every mesh; each replayed
   aggregation timed alone beside the single device's, in turns, set-up
   and capture apart; one profiled aggregation of the single device and
   of 8 shards (top device operations, idle share).
6o. ``run_fl(mode="async", engine="sharded")`` (one shard) and
   ``run_fl_async_sharded`` on 4 shards at phase 6g's settings (10,000
   clients, full width, 3 aggregations) against ``run_fl_async_scanned``
   (cuDNN's deterministic algorithms): the flush, refill and version
   columns equal, one shard bitwise, four within tests/test_torch_
   training_engines.py's tolerances; each replayed aggregation timed alone
   beside the fused engine's, capture and peak memory apart; one profiled
   4-shard aggregation (idle share); the fused engine's ``train-async``
   snapshot after aggregation 2 resumed on 4 shards.
6p. ``launch/elastic_check.py``'s round-engine matrix on a 2-shard mesh
   at its default size, in this process: resume parity of the sync and
   async engines (single device and sharded), faults and the corruption
   smoke.

In phases 3 to 6p every call of the top-k kernel's wrapper is recorded,
inputs and outputs, and its outputs are held against the plain version on
the same inputs. Under capture the records are copies captured into the
graph, read after each replay; each replayed launch is also held against
an eager launch on its inputs.

The LM serving path (zamba2-1.2b, full width, random weights from
``--seed``):

7. ``flash_attention`` against its plain version: (B, S, H, KH, hd) in
   ``ATTN_SHAPES`` (the serve prompt's, the prefill's, a ragged S with
   hd=128, and GQA), bf16 and f32, causal and not; bf16 outputs also
   against the f32 attention of the same bf16 inputs (the tight check of
   the tensor-core kernel); bf16 rows that are not 16-byte aligned are
   rejected.
8. ``ssd_chunk`` against its plain version (the sequential recurrence):
   S in {32, 64, 128, 4096, 4000 (a ragged last chunk)} at nh=64, hd=64,
   ds=64, and the prefill's shape with slow decay, bf16 (tensor cores) and
   f32; bf16 outputs also against the f32 scan of the same bf16 inputs
   (the tight check; the slow-decay case at a limit of its own).
9. The main path of these kernels: ``make_prefill_step(CONFIG)`` on
   2 x 4096 tokens (a cut of ``prefill_32k``'s 32 x 32,768, for chip time
   and the plain route's memory). One forward must launch the attention
   kernel 6 times and the SSD kernel 38 times; the first call of each is
   held against its plain version and by its tight check, and the logits
   against the same forward on the plain route on the card.
10. Serving: ``launch/serve.py::generate`` at the reference's defaults
   (batch 4, prompt 32, gen 16); the replay's last prompt logits against
   one kernel-route forward over the prompt; tokens in range.
11. Timing of both kernels on the inputs the prefill gave them, beside
   their plain versions, their bounds and (attention) one
   ``scaled_dot_product_attention`` call, with the card's name and power
   limit.

The Mamba1 serving path (falcon-mamba-7b, full width, random weights from
``--seed``; zamba2's weights are freed first):

12. ``selective_scan`` against its plain version on ``SCAN_SHAPES`` (S in
   {1, 7, 32, 64, 4095, 4096}, di in {96, 512, 8192}, ds in {8, 16}, and
   the prefill's shape with slow decay), bf16 and f32, B and C strided;
   bf16 outputs also by the tight check.
13. The main path: ``make_prefill_step(CONFIG)`` on 2 x 4096 tokens. One
   forward must launch the scan 64 times; its first call is held against
   its plain version and by the tight check.
14. The routes at full width and depth on 2 x 256 tokens: f32 (TF32 off)
   kernel route against the plain route (a loop over time, 64 x 256
   steps); in bf16 the kernel route no further from the f32 logits than
   ``BF16_ROUTE_RATIO`` times the plain route.
15. Serving: ``generate`` at batch 4, prompt 32, gen 16; the replay
   against one kernel-route forward over the prompt (64 launches), and in
   f32 every replay step against the forward.
16. Timing of the scan on the inputs the prefill gave it, beside its plain
   version and its bound.

LM training (olmo-1b, full width, random weights from ``--seed``; falcon's
weights are freed first):

17. The attention backward kernel against its plain version (the
   explicit formulas in f32) on phase 7's shapes, the train step's
   (4, 4096, 16 heads of 128) and GQA with 24 query heads over 8 at a
   ragged S, bf16 and f32, causal and not, on the o and log-sum-exp that
   the forward kernel wrote: dq, dk, dv at the JAX package's attention
   tolerances, bf16 also by the tight check against the f32 backward of
   the same inputs; the log-sum-exp of both forward designs against the
   plain forward's.
18. The main path: ``make_train_step(get_config("olmo-1b"),
   default_optimizer())`` on ``lm_batch`` at 4 x 4096 (a cut of
   ``train_4k``'s 256 x 4096), 3 steps, counts set to 0 just before each
   step and read just after: 32 attention launches (the forward and the
   remat recompute) and 16 backward launches a step; the losses finite;
   a fourth step profiled (device time by layer, idle share). The first
   backward call held against its plain version and by the tight check.
   The routes: one step's loss and gradients in f32 (TF32 off) at full
   width, depth 2, on 2 x 1024 tokens, kernel route against the plain
   route (autograd through the query-chunked attention); in bf16 at full
   depth the kernel route's gradient no further from the f32 gradient
   than ``BF16_ROUTE_RATIO`` times the plain route's. Reduced zamba2 and
   falcon: the loss and every gradient under grad on the card, finite,
   through each scan's forward (twice a layer) and backward kernel.
19. ``python -m repro_torch.launch.train cohort --steps 10`` (reduced
   olmo-1b, as the reference; also ``--arch zamba2-1.2b`` and ``--arch
   falcon-mamba-7b``) and ``python -m
   repro_torch.examples.federated_llm_cohort``, and with them, each in its
   own process and all at once, ``train cohort`` of
   ``--arch phi4-mini-3.8b``, ``phi3-mini-3.8b``, ``minicpm3-4b``,
   ``internvl2-2b`` and ``musicgen-large``, the federated LLM cohort
   example of the last two, ``python -m
   repro_torch.examples.serve_decode`` (reduced phi3-mini-3.8b at the
   example's defaults) and ``python -m repro_torch.launch.dev_smoke`` (the
   ten reduced archs): each exits 0.
20. Timing, on the inputs the train step gave the backward kernel: the
   kernel, its plain version and ``scaled_dot_product_attention``'s
   backward (its forward and backward less its forward) in turns, beside
   the bound; the forward kernel with and without the log-sum-exp.

Training of the SSM archs (olmo's weights are freed first):

21. The SSD backward kernel against its plain version (the reverse
   recurrence in f32) on ``SSD_BWD_SHAPES`` (S in {1, 63, 64, 65, 4000,
   4096}, ds in {16, 64, 128}, slow decay), bf16 and f32, B and C
   strided, on the chunk states the forward kernel wrote: dx, dB, dC,
   ddt at the JAX package's SSD tolerances, and each gradient (dA, a sum
   over the batch and sequence, by this alone) by the tight check against
   the f32 backward of the same inputs. In bf16 the carry pass alone is
   also held against ``ref.ssd_chunk_bwd_carry`` (elementwise at the f32
   SSD tolerance, and by the f32 tight limit). Every case runs; a failure
   names each case that failed.
22. The main path: ``make_train_step(get_config("zamba2-1.2b"),
   default_optimizer())`` at full width and depth on ``lm_batch`` at 4 x
   4096, 3 steps, counts set to 0 just before each step and read just
   after: 76 SSD launches (the forward and the remat recompute), 38 SSD
   backward launches, 6 attention and 6 attention backward launches (the
   shared block, not rematerialised) a step; the losses finite; a fourth
   step profiled. The first SSD backward call held against its plain
   version and by the tight check. The routes: f32 at depth 2 on 2 x
   1024 tokens (kernel route against the plain chunked SSD), bf16 at full
   depth by ``BF16_ROUTE_RATIO``.
23. The selective-scan backward kernel against its plain version, as 21,
   on ``SCAN_BWD_SHAPES`` (S as there, di in {96, 100, 256, 512}, ds in
   {8, 16}).
24. The main path of falcon-mamba-7b at full width, ``FALCON_TRAIN_DEPTH``
   = 16 of its 64 layers (AdamW's f32 state for all 7.0B parameters
   passes 80 GB), as 22: 32 scan and 16 scan backward launches a step;
   the routes on 2 x ``ROUTE_LEN`` tokens (the plain route is a loop over
   time), bf16 at the step's depth.
25. Timing of both backward kernels on the inputs their train steps gave
   them: the kernel (CUDA events around 5 back-to-back calls, median of
   5 trials, two turns) and the plain version beside the bound (and, for
   the SSD's, the byte floor of its two-pass design); no single PyTorch
   call computes either gradient.

The dense and MLA archs (phi4-mini-3.8b, phi3-mini-3.8b, minicpm3-4b,
full width, random weights from ``--seed``; each arch's weights freed
before the next's):

26. Both attention kernels at the new (q.k, v) width pairs against their
   plain versions on ``WIDTH_SHAPES``: phi3's prefill (2, 4096, 32 heads,
   96, 96), minicpm3's (2, 4096, 40, 96, 64), phi4's (2, 4096, 24 over 8,
   128, 128), reduced minicpm3's (1, 32, 4, 48, 32) and a ragged S at
   each new width, bf16 and f32, causal and not: the output, the
   log-sum-exp and dq, dk, dv at the JAX package's attention tolerances,
   bf16 also by both tight checks; every case runs, a failure names each.
27-29. ``make_prefill_step(CONFIG)`` on 2 x 4096 tokens of phi4-mini,
   phi3-mini and minicpm3 at full width and depth: one forward must
   launch the attention kernel 32, 32 and 62 times; its first call held
   against its plain version and by the tight check; the logits against
   the plain route on the card (f32, and bf16 by ``BF16_ROUTE_RATIO``).
   Then ``generate`` at the serve defaults (batch 4, prompt 32, gen 16):
   the replay's last prompt logits against one kernel-route forward (for
   minicpm3 the absorbed decode against the decompressed prefill), and in
   f32 every replay step against the forward.
30. ``make_train_step`` of each at full width, cut by
   ``DENSE_TRAIN_CUT`` (phi3 16 of 32 layers, minicpm3 24 of 62, on 4 x
   4096; phi4 12 of 32 on 2 x 4096), 3 steps: each launches the
   attention forward twice a layer and its backward once; the losses
   finite; a fourth step profiled; the first backward call against its
   plain version and by the tight check; the routes (f32 at depth 2, bf16
   at the step's depth).
31. Timing of both kernels on the inputs the prefills and train steps
   gave them, beside the plain version, one
   ``scaled_dot_product_attention`` call (its forward, or its forward and
   backward less its forward; ``enable_gqa`` for phi4) and the bound,
   with the backend each SDPA call ran; and both kernels at
   phi3's shapes with hd 96 and 128 in turns (what the padding of 96 to
   two 64-column boxes costs).

The mixture-of-experts archs (llama4-scout-17b-a16e, deepseek-v2-236b,
full width, random weights from ``--seed``, cut in depth by
``MOE_SERVE_CUT``; each arch's weights freed before the next's):

32. Both attention kernels at deepseek's MLA widths (q.k 192, three
   64-column boxes; v 128) against their plain versions on
   ``WIDE_SHAPES``: deepseek's prefill (2, 4096, 128 heads), a small, a
   ragged and a GQA case, bf16 and f32, causal and not: the output and the
   log-sum-exp at the JAX package's attention tolerances, then dq, dk and
   dv of the backward kernel on them (the plain version a few heads at a
   time, :func:`plain_bwd`), bf16 also by the tight checks; every case
   runs, a failure names each.
33, 34. ``make_prefill_step`` on 2 x 4096 tokens of llama4 (6 of 48
   layers) and deepseek (1 dense + 3 MoE of 60): one forward must launch
   the attention kernel once a layer; the share of choices capacity
   dropped in each MoE layer; one profiled prefill (device time by op:
   matmuls, attention, the expert weights' casts, routing, gathers); the
   bf16 logits against the f32 plain route (``BF16_ROUTE_RATIO``) beside
   the share of choices the routes send to other experts; in f32 at depth
   2 on 2 x 1024 tokens the same experts on both routes (a flip fails,
   naming the smallest top-k margin) and the logits within
   ``F32_LOGIT_ATOL``; ``generate`` at the serve defaults (decode
   tokens/s, peak memory) and the replay against the forward at a
   capacity factor at which the forward drops nothing
   (:func:`moe_replay_capacity`: 16, 27 for deepseek; in f32 every
   position); the first attention call held
   against its plain version and by the tight check.
35. One full-width llama4 MoE layer in f32 on 1 x 1024 tokens, no
   optimizer: ``loss_fn``'s loss and every gradient leaf on the kernel
   route against the plain route, both routes choosing the same experts,
   the aux loss above 0 and the router's gradient not zero, the first
   attention backward call (GQA 40 over 8) against its plain version
   (:func:`moe_grad_routes`).
36. The attention forward timed at both prefills' inputs beside the plain
   version, one ``scaled_dot_product_attention`` call (``enable_gqa`` for
   llama4) and the bound.

The vision frontend and the multi-codebook heads (internvl2-2b: 1,024
precomputed patch embeddings before the text, GQA 16 over 8 at hd 128;
musicgen-large: 4 codebook streams, their embeddings summed, a head a
codebook, 32 heads of 64; full width, random weights from ``--seed``; each
arch's weights freed before the next's):

37, 38. ``make_prefill_step`` of each at full width and depth on 2 x 4096
   positions (internvl: 1,024 patches of ``vision_embeds`` and 3,072 text
   tokens; musicgen: a token a codebook a position): one forward must
   launch the attention kernel 24 and 48 times; its first call held
   against its plain version and by the tight check; the logits against
   the plain route (f32, and bf16 by ``BF16_ROUTE_RATIO``). Then
   ``generate`` at the serve defaults (musicgen's prompt and tokens a
   token a codebook): the replay against a forward of the same tokens (for
   internvl with an empty patch block: serving carries text tokens only),
   in f32 at every position.
39. ``make_train_step`` of each at full width and depth
   (``FRONTEND_TRAIN_CUT``: internvl's 24 layers, musicgen's 48, on 4 x
   4096), 3 steps: each launches the attention forward twice a layer
   and its backward once; the losses finite; the first backward call
   against its plain version and by the tight check; the routes (f32 at
   depth 2, bf16 at the step's depth; internvl's 2 x 1024 text tokens
   behind its 1,024 patches).
40. Both kernels timed on the inputs phases 37-39 gave them, beside the
   plain version, one ``scaled_dot_product_attention`` call
   (``enable_gqa`` for internvl) and the bound.

deepseek-v2-236b trains (full width, random weights from ``--seed``):

41. ``make_train_step`` at its dense first layer (``MOE_TRAIN_CUT``: an
   AdamW step over a full-width MoE layer passes one card) on 4 x 4096,
   3 steps: each launches the attention forward twice and its backward
   (at (192, 128)) once; the losses finite, s a step, tokens/s, peak
   memory and one profiled step; the first backward call against its
   plain version and by the tight check; the routes: f32 at depth 2 (the
   dense layer and the first MoE layer, 160 experts, top 6) on 2 x 1024
   tokens by :func:`moe_grad_routes` (the same experts on both routes,
   the loss and every gradient leaf, the aux loss, the router's
   gradient), bf16 at the step's depth.
42. The backward kernel timed on the step's first call beside the plain
   version, one ``scaled_dot_product_attention`` forward and backward
   less its forward (its backend named) and the bound.

The dry-run against the card:

43. ``launch/dryrun.py::trace_one`` of each train step timed above
   (olmo-1b, zamba2-1.2b, falcon-mamba-7b at 16 layers, the
   ``DENSE_TRAIN_CUT``, ``FRONTEND_TRAIN_CUT`` and ``MOE_TRAIN_CUT``
   cases) and of the 2 x 4096 prefills (phases 9, 13, 27-29, 33-34 at
   ``MOE_SERVE_CUT``, 37-38), on fake tensors of the card at the same
   config, cut and shape: the memory allocated and the launch counts
   unchanged across each trace; olmo-1b's and zamba2-1.2b's count equal
   on fake CPU tensors; for each case the counted and model TFLOP,
   t_compute, t_memory, the dominant term, the phase's measured step,
   ``roofline_share`` (max(t_compute, t_memory) / measured) and ``mfu``
   (model FLOPs / (measured x peak)), also at the fastest step, each at
   most 1.05, and the
   estimated peak within 0.5-1.5 x the phase's ``max_memory_allocated``.
   It fails first if ``H100_SXM`` does not describe the card (a name
   without "H100", or other than 132 SMs). It launches no kernel.

The correctness tooling (``repro_torch/analysis/runtime.py``) on the card:

44. The FLConfig defaults at full width (200 clients, k = 10), cuDNN's
   deterministic algorithms: ``run_fl_scanned`` and
   ``run_fl_async_scanned`` (buffer 4, concurrency 10), 6 rounds in 3
   checkpoint segments, each under ``strict_mode(debug_nans=True)`` and
   ``retrace_guard(watch=("round", "eval"))``: exactly one capture of
   each step across the segments, the trajectory bitwise the unguarded
   uninterrupted run's, and the top-k launches one a replay plus the
   warm-up (and the async fill's). Then 3 rounds of a hand-built
   ``StepGraphs`` replay under ``torch.cuda.set_sync_debug_mode("error")``
   (which must refuse a probe ``.item()``), and two planted faults must
   each be caught: a step that calls ``.item()`` raises under
   ``strict_mode``, and a second ``StepGraphs`` over the same step shows
   two captures of "round".

Each phase's wall time is logged. The last two lines of standard output
are the kernels' JSON summary and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0                           # default --seed of the LM phases

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOP_PER_S = 67e12             # float32 outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/topk_select.cu"
KERNEL_REPLACES = "src/repro/kernels/topk_select.py:42"
# float32 operations per client of the fused score, by mode, and of ucb
SCORE_FLOPS = {"eafl": 3, "oort": 0, "eafl-epj": 2}
UCB_FLOPS = 2


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 2
def topk_inputs(torch, n, seed, dev, *, ties=False, valid_frac=0.8,
                specials=False):
    """``ties``: every third client a copy of the first, or ``"flat"``:
    every a and b equal; ``specials``: half of ``a`` drawn from ±0, ±NaN
    and ±inf among values of both signs (``oort`` without ucb scores ``a``
    itself)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.rand(n, generator=g)
    b = torch.rand(n, generator=g)
    if ties == "flat":
        a.fill_(0.5)
        b.fill_(0.5)
    elif ties:
        a[::3] = a[0]
        b[::3] = b[0]
    if specials:
        nan = float("nan")
        pool = torch.tensor([0.0, -0.0, nan, -nan, float("inf"),
                             -float("inf")])
        a = a - 0.5
        pick = torch.rand(n, generator=g) < 0.5
        a[pick] = pool[torch.randint(0, len(pool), (int(pick.sum()),),
                                     generator=g)]
    valid = torch.rand(n, generator=g) < valid_frac
    ucb = torch.rand(n, generator=g) * 0.3
    return [t.to(dev) for t in (a, b, valid, ucb)]


TOPK_SIZES = (200, 4096, 10_000, 1_000_003, 1_048_576)   # phase 2's N
# the edge cases of the radix-select kernel: ±0 and ±NaN scores, an
# all-SENTINEL population, flat ties, k in {1, 100, 8192} at N on both
# sides of one and two 8192-client tiles and at 4M clients (two merge
# levels at k = 100), and index_offset on one and on several tiles
TOPK_EDGES = (
    [dict(n=20_000, k=300, mode="oort", ucb=False, specials=True,
          valid_frac=1.0),
     dict(n=9000, k=4500, mode="oort", ucb=False, specials=True,
          valid_frac=0.9),
     dict(n=1_048_576, k=100, mode="oort", ucb=False, specials=True,
          valid_frac=1.0),
     dict(n=50_000, k=1000, mode="eafl", ucb=True, valid_frac=0.0),
     dict(n=5000, k=100, mode="eafl", ucb=False, valid_frac=0.0),
     dict(n=100_000, k=1000, mode="oort", ucb=False, ties="flat",
          valid_frac=0.5),
     dict(n=1_048_576, k=100, mode="eafl", ucb=True, index_offset=1000),
     dict(n=5000, k=10, mode="eafl", ucb=True, index_offset=7)]
    + [dict(n=n, k=k, mode="eafl", ucb=True)
       for n in (8191, 8193, 10_000, 4 * 2**20) for k in (1, 100, 8192)
       if k <= n])


def topk_cases(sizes):
    """The 105 cases of the synthetic matrix (every N in ``sizes``), then
    ``TOPK_EDGES``."""
    cases = []
    for n in sizes:
        for k in (1, 10, 100):
            for mode in ("eafl", "oort", "eafl-epj"):
                for with_ucb in (False, True):
                    cases.append(dict(n=n, k=k, mode=mode, ucb=with_ucb))
        cases.append(dict(n=n, k=min(4096, n), mode="eafl", ucb=True))
        cases.append(dict(n=n, k=100, mode="eafl", ucb=True, ties=True))
        cases.append(dict(n=n, k=100, mode="oort", ucb=False,
                          valid_frac=50.0 / n))
    return cases, list(TOPK_EDGES)


def phase_kernel_vs_plain(torch, ops, ref, dev, sizes):
    cases, edges = topk_cases(sizes)
    for i, c in enumerate(cases + edges):
        a, b, valid, ucb = topk_inputs(
            torch, c["n"], i, dev, ties=c.get("ties", False),
            valid_frac=c.get("valid_frac", 0.8),
            specials=c.get("specials", False))
        if c["mode"] == "eafl-epj":
            b = b * 0.01
        kw = dict(f=0.3, k=c["k"], mode=c["mode"],
                  ucb=ucb if c["ucb"] else None,
                  index_offset=c.get("index_offset", 0))
        block = {"block_n": 8192} if c["k"] > 4096 else {}
        check_same(torch, ops.topk_reward(a, b, valid, **kw, **block),
                   ref.topk_reward(a, b, valid, **kw), c)
    log(f"phase 2: topk_reward kernel == plain on {len(cases)} cases, N in "
        f"{sorted(sizes)}, and {len(edges)} edge cases (±0 and ±NaN, all "
        f"SENTINEL, flat ties, k in (1, 100, 8192) at N in (8191, 8193, "
        f"10000, 4194304), index_offset): indices exact, values bitwise")
    return len(cases), len(edges)


def check_same(torch, kernel_out, plain_out, what):
    """Indices equal exactly, values bitwise; returns max |difference|."""
    (kv, ki), (pv, pi) = kernel_out, plain_out
    check(torch.equal(ki, pi), f"kernel indices differ: {what}")
    check(torch.equal(kv.view(torch.int32), pv.view(torch.int32)),
          f"kernel values differ bitwise: {what}")
    fin = torch.isfinite(kv)
    return float((kv[fin] - pv[fin]).abs().max()) if bool(fin.any()) else 0.0


# ------------------------------------------ recording the main path's calls
@contextlib.contextmanager
def recording(ops):
    """Record every call of ``ops.topk_reward`` (copies of its inputs and
    outputs) while the block runs; the launch counter is the wrapper's."""
    calls = []
    wrapper = ops.topk_reward

    def spy(a, b, valid, **kw):
        ins = (a.clone(), b.clone(), valid.clone())
        ucb = kw.get("ucb")
        kw_copy = dict(kw, ucb=None if ucb is None else ucb.clone())
        out = wrapper(a, b, valid, **kw)
        calls.append((ins, kw_copy, tuple(t.clone() for t in out)))
        return out

    ops.topk_reward = spy
    try:
        yield calls
    finally:
        ops.topk_reward = wrapper


def check_recorded(torch, ref, calls, label):
    """Each recorded kernel output against the plain version on the same
    inputs; returns the largest |difference| (0.0 when bitwise equal)."""
    check(calls, f"{label}: the kernel's wrapper was not called")
    err = 0.0
    for j, ((a, b, valid), kw, out) in enumerate(calls):
        err = max(err, check_same(torch, out,
                                  ref.topk_reward(a, b, valid, **kw),
                                  f"{label}, call {j}"))
    return err


# ------------------------------------------------------------------ phase 6
def cuda_ms(torch, fn, args_list, reps=20, trials=5):
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; median of ``trials``. The calls
    rotate over ``args_list`` (copies of the inputs, enough of them to
    exceed the L2 cache where they can)."""
    for args in args_list:
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            fn(*args_list[r % len(args_list)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def clone_strided(t):
    """A copy of ``t`` with ``t``'s strides, so a slice of a packed tensor
    stays a strided view (of a buffer of its own)."""
    return t.new_empty_strided(t.size(), t.stride()).copy_(t)


def copies(tensors, l2_bytes, most=16):
    """Enough copies of ``tensors`` (strides kept) to span twice the L2
    cache (at most ``most``); returns them and whether they exceed the
    cache."""
    nbytes = sum(t.nbytes for t in tensors if t is not None)
    count = max(1, min(most, math.ceil(2 * l2_bytes / nbytes)))
    sets = [tuple(None if t is None else clone_strided(t) for t in tensors)
            for _ in range(count)]
    return sets, count * nbytes > l2_bytes


def bound(a, b, valid, ucb, k, mode):
    """Least time for the function: each input byte read once, each output
    written once, at the HBM rate; its float32 operations at the peak rate.
    Returns ``(ms, "bytes" or "operations")``."""
    n = a.shape[0]
    nbytes = sum(t.nbytes for t in (a, b, valid, ucb) if t is not None)
    nbytes += 8 * k
    flops = n * (SCORE_FLOPS[mode] + (UCB_FLOPS if ucb is not None else 0))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def card_name_power():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi unavailable"


def host_us(torch, fn, args_list, calls=300):
    """Host microseconds per call of ``fn``: wall time of ``calls`` calls
    issued back to back with no synchronise (the device may lag behind),
    divided by ``calls``; the queue is drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(calls):
        fn(*args_list[r % len(args_list)])
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def phase_timing(torch, ops, ref, call, label, l2_bytes):
    """Time kernel, plain version and one ``torch.topk`` over the
    materialised score on a recorded call's inputs, in turns; also the
    kernel at k=1, and the host time of one call of the kernel's
    wrapper."""
    (a, b, valid), kw, _ = call
    ucb, k, mode = kw.get("ucb"), kw["k"], kw.get("mode", "eafl")
    extra = {key: v for key, v in kw.items() if key not in ("ucb",)}
    sets, cold = copies((a, b, valid, ucb), l2_bytes)

    def kern(a, b, valid, ucb, **over):
        return ops.topk_reward(a, b, valid, **dict(extra, ucb=ucb, **over))

    def plain(a, b, valid, ucb):
        return ref.topk_reward(a, b, valid, **dict(extra, ucb=ucb))

    scores, _ = copies((ref.reward_score(a, b, valid, f=kw["f"], ucb=ucb,
                                         mode=mode),), l2_bytes)
    first = dict(zip(("a", "b", "valid", "ucb"), sets[0]))
    check_same(torch, kern(**first, k=1),
               ref.topk_reward(**first, **dict(extra, k=1)), f"{label} k=1")
    row = {"n": int(a.shape[0]), "k": int(k), "mode": mode,
           "ucb": ucb is not None, "l2_cold": cold, "copies": len(sets)}
    # in turns, so a drift of the clock reaches all of them alike
    runs = {"ms": [], "plain_ms": [], "library_ms": [], "k1_ms": []}
    for _ in range(2):
        runs["ms"].append(cuda_ms(torch, kern, sets))
        runs["plain_ms"].append(cuda_ms(torch, plain, sets))
        runs["library_ms"].append(
            cuda_ms(torch, lambda s: torch.topk(s, k), scores))
        runs["k1_ms"].append(
            cuda_ms(torch, lambda *s: kern(*s, k=1), sets))
    row.update({key: statistics.median(v) for key, v in runs.items()})
    row["bound_ms"], row["bound_by"] = bound(a, b, valid, ucb, k, mode)
    row["host_us"] = host_us(torch, kern, sets)
    row["card"] = card_name_power()
    log(f"phase 6: topk_reward on {label}'s inputs, N={row['n']} k={k} "
        f"{mode}{'+ucb' if row['ucb'] else ''}, {len(sets)} input copies "
        f"({'beyond' if cold else 'inside'} the L2 cache), on "
        f"{row['card']}: kernel {row['ms']:.5f} ms (k=1: "
        f"{row['k1_ms']:.5f} ms; host {row['host_us']:.2f} us a wrapper "
        f"call), plain "
        f"{row['plain_ms']:.5f} ms, torch.topk {row['library_ms']:.5f} ms, "
        f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


# ------------------------------------------------------------------ phase 3
def fleet_population(torch, dev, n):
    """Phases 3 and 6a's population: half the fleet has history, so
    exploitation ranks about n/2 clients."""
    from repro_torch import prng
    from repro_torch.core.clients import make_population
    pop = make_population(prng.PRNGKey(0, dev), n)
    g = torch.Generator(device="cpu").manual_seed(3)
    return pop.replace(
        explored=(torch.rand(n, generator=g) < 0.5).to(dev),
        stat_util=(torch.rand(n, generator=g) * 50).to(dev),
        last_duration=(torch.rand(n, generator=g) * 400).to(dev))


def phase_selection(torch, ref, dev, n, rounds):
    from repro_torch import prng
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                            select)
    from repro_torch.federated.simulation import (round_cost_table,
                                                  simulate_round)
    from repro_torch.kernels import ops

    pop = fleet_population(torch, dev, n)
    em = EnergyModel(busy_fraction=0.02)
    cfg = SelectorConfig("eafl", k=100)

    def run(p, use_kernel):
        key = prng.PRNGKey(11, p.device)
        _, cost = round_cost_table(p, em, 3.0e6, 10, 20)
        state = SelectorState.create(cfg)
        picks = []
        for rnd in range(1, rounds + 1):
            key, ksel = prng.split(key)
            idx, state = select(ksel, cfg, state, p, cost,
                                use_kernel=use_kernel)
            p, out = simulate_round(p, idx, em, 3.0e6, 10, 20, rnd)
            picks.append((idx, out.new_dropouts))
        return picks

    with recording(ops) as calls:
        ops.LAUNCHES["topk_reward"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_dev = run(pop, True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.LAUNCHES["topk_reward"]
    check(launches == rounds,
          f"selection launched the kernel {launches} times in {rounds} rounds")
    err = check_recorded(torch, ref, calls, "phase 3")
    on_cpu = run(pop.to("cpu"), True)
    for r, ((i_d, d_d), (i_c, d_c)) in enumerate(zip(on_dev, on_cpu), 1):
        check(np.array_equal(i_d, i_c),
              f"round {r}: card and CPU picks differ")
        check(d_d == d_c, f"round {r}: dropouts differ")
        check(len(i_d) == cfg.k, f"round {r}: {len(i_d)} picks")
    log(f"phase 3: select+simulate_round N={n} eafl k=100 x{rounds} rounds: "
        f"{secs:.3f} s on the card, kernel launches {launches}, each call "
        f"== plain on its inputs, picks equal to the CPU run")
    return launches, err, calls[-1]


# --------------------------------------------------------------- phase 4/5
def fl_config(n_clients, k, rounds, **kw):
    from repro_torch.core.selection import SelectorConfig
    from repro_torch.federated.server import FLConfig
    return FLConfig(selector=SelectorConfig("eafl", k=k),
                    n_clients=n_clients, rounds=rounds, **kw)


def phase_training_parity(torch, ref, dev, cfg):
    """run_fl on the card against run_fl on the CPU. The two rank the
    exploit slots by different routes (the kernel on the card, the
    affine-folded score on the CPU), so the kernel is held against its
    plain version on the card's own recorded calls instead."""
    from repro_torch.federated.server import run_fl
    from repro_torch.kernels import ops

    with recording(ops) as calls:
        ops.LAUNCHES["topk_reward"] = 0
        on_dev = run_fl(cfg, device=dev)
        launches = ops.LAUNCHES["topk_reward"]
    err = check_recorded(torch, ref, calls, "phase 4")
    on_cpu = run_fl(cfg, device="cpu")
    for f in ("round", "cum_dropouts", "quarantined", "update_skipped"):
        check(getattr(on_dev, f) == getattr(on_cpu, f),
              f"{f}: {getattr(on_dev, f)} != {getattr(on_cpu, f)}")
    # tolerances of tests/test_torch_server.py; test accuracy allows two
    # argmax flips among the eval samples (conv sums in another order)
    for f in ("fairness", "participation", "wall_hours", "mean_battery",
              "energy_spent_j"):
        np.testing.assert_allclose(getattr(on_dev, f), getattr(on_cpu, f),
                                   rtol=1e-5, err_msg=f)
    np.testing.assert_allclose(on_dev.train_loss, on_cpu.train_loss,
                               rtol=2e-3, err_msg="train_loss")
    np.testing.assert_allclose(on_dev.test_acc, on_cpu.test_acc,
                               atol=2.0 / cfg.eval_samples, err_msg="test_acc")
    log(f"phase 4: run_fl full width, {cfg.n_clients} clients, k="
        f"{cfg.selector.k}, {cfg.rounds} rounds: card == cpu (train_loss "
        f"{on_dev.train_loss} vs {on_cpu.train_loss}); kernel launches "
        f"{launches}, each call == plain on its inputs")
    return launches, err


def phase_training_scale(torch, ref, dev, cfg):
    """The main path. One timed run of ``cfg.rounds`` rounds (the launches
    are counted there) after a timed one-round run: their difference over
    ``rounds - 1`` is the steady cost of a round without the set-up."""
    from repro_torch.federated.server import run_fl
    from repro_torch.kernels import ops

    def timed(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = run_fl(c, device=dev)
        torch.cuda.synchronize()
        return h, time.perf_counter() - t0

    _, one = timed(dataclasses.replace(cfg, rounds=1))
    torch.cuda.reset_peak_memory_stats()
    with recording(ops) as calls:
        ops.LAUNCHES["topk_reward"] = 0
        hist, secs = timed(cfg)
        launches = ops.LAUNCHES["topk_reward"]
    err = check_recorded(torch, ref, calls, "phase 5")
    check(np.isfinite(hist.train_loss).all(), f"loss {hist.train_loss}")
    check(hist.round == list(range(1, cfg.rounds + 1)), f"{hist.round}")
    per_round = (secs - one) / (cfg.rounds - 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"phase 5: run_fl full width, {cfg.n_clients} clients, k="
        f"{cfg.selector.k}, {cfg.rounds} rounds on the card: {secs:.3f} s "
        f"({one:.3f} s for 1 round), so {per_round:.3f} s/round and "
        f"{one - per_round:.3f} s set-up; kernel launches {launches}, each "
        f"call == plain on its inputs; train_loss {hist.train_loss}, "
        f"test_acc {hist.test_acc}, peak memory {peak:.2f} GiB")
    return launches, err, calls[-1], per_round


# ------------------------------------------ the fused engines (phases 6a-6d)
@contextlib.contextmanager
def graph_recording(torch, ops, replay):
    """Record every launch of ``ops.topk_reward`` while the block runs,
    eager or replayed from a CUDA graph: ``(calls, replayed)``, each a list
    of (inputs, kwargs, outputs). An eager call (a warm-up) is copied when
    it is made. A call under capture launches nothing, but its copies of
    the wrapper's inputs and outputs are device-to-device copies captured
    into the graph, into buffers the graph keeps: after each replay they
    hold that replay's launch, and are copied out then (into
    ``replayed``)."""
    # held: each graph's captured records, keyed by the StepGraphs object
    # (weakly: a new object may take a freed one's id)
    calls, replayed, pending = [], [], []
    held = weakref.WeakKeyDictionary()
    wrapper, run = ops.topk_reward, replay.StepGraphs.run

    def spy(a, b, valid, **kw):
        out = wrapper(a, b, valid, **kw)
        ucb = kw.get("ucb")
        rec = ((a.clone(), b.clone(), valid.clone()),
               dict(kw, ucb=None if ucb is None else ucb.clone()),
               tuple(t.clone() for t in out))
        (pending if torch.cuda.is_current_stream_capturing()
         else calls).append(rec)
        return out

    def run_and_read(self, name):
        run(self, name)
        graphs = held.setdefault(self, {})
        if name not in graphs:
            graphs[name] = list(pending)
            pending.clear()
        for ins, kw, outs in graphs[name]:
            replayed.append((tuple(t.clone() for t in ins),
                             dict(kw, ucb=None if kw["ucb"] is None
                                  else kw["ucb"].clone()),
                             tuple(t.clone() for t in outs)))

    ops.topk_reward, replay.StepGraphs.run = spy, run_and_read
    try:
        yield calls, replayed
    finally:
        ops.topk_reward, replay.StepGraphs.run = wrapper, run


def check_replayed(torch, ops, ref, calls, replayed, label, expect):
    """Each recorded launch (warm-up and replays) against the plain version
    on its inputs, indices exact and values bitwise; each replayed launch
    also against the kernel launched eagerly on the same inputs (these
    launches compare, and are made after the path's counts were read).
    Returns the largest |difference|."""
    check(len(replayed) == expect, f"{label}: {len(replayed)} replayed "
          f"launches recorded, expected {expect}")
    err = check_recorded(torch, ref, calls + replayed, label)
    for j, ((a, b, valid), kw, out) in enumerate(replayed):
        check_same(torch, out, ops.topk_reward(a, b, valid, **kw),
                   f"{label}: replayed launch {j} vs an eager one")
    return err


def phase_fused_selection(torch, ops, ref, dev, n, rounds):
    """6a: ``run_rounds_scanned`` at fleet scale, replayed from a CUDA
    graph, against host rounds (``select`` + ``simulate_round``, the same
    kernel) with the same key rows."""
    from repro_torch import prng
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                            select)
    from repro_torch.federated import replay
    from repro_torch.federated.simulation import (round_cost_table,
                                                  run_rounds_scanned,
                                                  simulate_round)

    pop = fleet_population(torch, dev, n)
    em = EnergyModel(busy_fraction=0.02)
    cfg = SelectorConfig("eafl", k=100)
    key = prng.PRNGKey(11, dev)
    with graph_recording(torch, ops, replay) as (calls, replayed), \
            graphs_made(replay) as made:
        ops.LAUNCHES["topk_reward"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _, traj = run_rounds_scanned(
            key, cfg, pop, SelectorState.create(cfg), em, 3.0e6, 10, 20,
            rounds)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.LAUNCHES["topk_reward"]
    capture = made[0].capture_s.get("round", 0.0)
    check(launches == rounds + 1, f"fused selection launched the kernel "
          f"{launches} times (warm-up and {rounds} replays expected)")
    err = check_replayed(torch, ops, ref, calls, replayed,
                         "phase 6a", rounds)
    _, cost = round_cost_table(pop, em, 3.0e6, 10, 20)
    state, p = SelectorState.create(cfg), pop
    for r, k in enumerate(prng.split(key, rounds)):
        idx, state = select(k, cfg, state, p, cost)
        p, out = simulate_round(p, idx, em, 3.0e6, 10, 20, r + 1)
        chosen = traj["chosen"][r]
        check(np.array_equal(traj["selected"][r][chosen], idx),
              f"round {r + 1}: fused and host picks differ")
        check(traj["new_dropouts"][r] == out.new_dropouts,
              f"round {r + 1}: dropouts differ")
    check(torch.equal(final.battery_pct, p.battery_pct),
          "fused and host batteries differ")
    row = {"run_s": secs, "capture_s": capture,
           "s_per_round_replayed": (secs - capture) / rounds,
           "card": card_name_power()}
    log(f"phase 6a: run_rounds_scanned N={n} eafl k=100 x{rounds} rounds "
        f"replayed from a CUDA graph on {row['card']}: {secs:.4f} s on the "
        f"card, of which warm-up and capture {capture:.4f} s (so "
        f"{row['s_per_round_replayed']:.5f} s a replayed round and the "
        f"trajectory's fetch), kernel launches {launches} (warm-up 1, "
        f"replayed {len(replayed)}), each == plain and == an eager launch "
        f"on its inputs; picks and batteries equal to host rounds with the "
        f"same keys")
    return len(replayed), err, row


HIST_EXACT = ("round", "cum_dropouts", "retries", "quarantined",
              "update_skipped", "budget_exhausted_round")
HIST_CLOSE = ("fairness", "participation", "wall_hours", "mean_battery",
              "energy_spent_j")


def check_engines_agree(host, fused, what, eval_samples):
    """tests/test_torch_training_engines.py's tolerances; test accuracy, as
    phase 4, within two argmax flips among the eval samples."""
    for f in HIST_EXACT:
        check(getattr(fused, f) == getattr(host, f),
              f"{what}: {f} {getattr(fused, f)} != {getattr(host, f)}")
    for f in HIST_CLOSE:
        np.testing.assert_allclose(getattr(fused, f), getattr(host, f),
                                   rtol=1e-5, err_msg=f"{what}: {f}")
    np.testing.assert_allclose(fused.train_loss, host.train_loss, rtol=2e-3,
                               err_msg=f"{what}: train_loss")
    np.testing.assert_allclose(fused.test_acc, host.test_acc,
                               atol=2.0 / eval_samples,
                               err_msg=f"{what}: test_acc")


def same_history(a, b):
    """Every history field equal, bit for bit (NaN equal to NaN)."""
    return all(np.array_equal(np.asarray(getattr(a, f), np.float64),
                              np.asarray(getattr(b, f), np.float64),
                              equal_nan=True)
               for f in a.as_dict() if f != "budget_exhausted_round") and \
        a.budget_exhausted_round == b.budget_exhausted_round


def phase_fused_parity(torch, ops, ref, dev, cfg):
    """6b: ``run_fl_scanned`` against the host ``run_fl`` on the card
    (the FLConfig defaults, full width, TF32 off): plain, and with faults
    and a budget; then killed after round 1 and resumed, bitwise equal to
    the uninterrupted run (cuDNN's deterministic algorithms)."""
    from repro_torch.federated import replay
    from repro_torch.federated.faults import FaultConfig
    from repro_torch.federated.server import run_fl, run_fl_scanned

    faults = FaultConfig(seed=1, crash_prob=0.2, max_retries=2,
                         straggle_prob=0.2, corrupt_prob=0.15)
    # the cohorts spend about 7.3 kJ in rounds 1-2 and 6.5 kJ in round 3:
    # the budget admits two rounds and refuses the third
    cases = {"plain": cfg, "faults+budget": dataclasses.replace(
        cfg, faults=faults, energy_budget_j=1.0e4, deadline_s=900.0)}
    out = {}
    with graph_recording(torch, ops, replay) as (calls, replayed):
        for name, c in cases.items():
            fused = run_fl_scanned(c, device=dev)
            host = run_fl(c, device=dev)
            check_engines_agree(host, fused, f"phase 6b {name}",
                                c.eval_samples)
            out[name] = {"train_loss": fused.train_loss,
                         "test_acc": fused.test_acc,
                         "retries": fused.retries,
                         "quarantined": fused.quarantined,
                         "budget_exhausted_round":
                             fused.budget_exhausted_round}
        check(sum(out["faults+budget"]["retries"]) > 0,
              "phase 6b: the faults drew no retry")
        check(out["faults+budget"]["budget_exhausted_round"] is not None,
              "phase 6b: the energy budget refused no round")
        torch.backends.cudnn.deterministic = True
        try:
            with tempfile.TemporaryDirectory() as tmp:
                c = cases["faults+budget"]
                whole = run_fl_scanned(c, device=dev)
                path = str(Path(tmp) / "fused-{round}.ckpt")
                seg = run_fl_scanned(dataclasses.replace(
                    c, checkpoint_path=path, checkpoint_every=1), device=dev)
                resumed = run_fl_scanned(dataclasses.replace(
                    c, resume_from=path.format(round=1)), device=dev)
        finally:
            torch.backends.cudnn.deterministic = False
    check(same_history(whole, seg), "phase 6b: the segmented run differs "
          "from the uninterrupted one")
    check(same_history(whole, resumed), "phase 6b: the run resumed after "
          "round 1 differs from the uninterrupted one")
    # one replay a round: 3 rounds of each case's fused run, of the
    # uninterrupted and of the segmented run, 2 of the resumed run
    expect = 3 * 2 + 3 + 3 + 2
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6b",
                         expect)
    log(f"phase 6b: run_fl_scanned == run_fl on the card, {cfg.n_clients} "
        f"clients, k={cfg.selector.k}, {cfg.rounds} rounds, full width "
        f"(plain, and faults+budget: retries {out['faults+budget']['retries']}"
        f", quarantined {out['faults+budget']['quarantined']}, budget "
        f"exhausted at round "
        f"{out['faults+budget']['budget_exhausted_round']}); segmented "
        f"and resumed-after-round-1 runs bitwise equal; {len(replayed)} "
        f"replayed launches, each == plain and == an eager launch: {out}")
    return len(replayed), err


def phase_fused_scale(torch, ops, ref, dev, cfg, host_per_round):
    """6c, the fused main path: ``run_fl_scanned`` at 10,000 clients. A
    3-round run minus a 1-round run, each less its steps' warm-up and
    capture (each run captures the round and the eval step once), over 2
    is a round; the set-up (the 1-round run less a round and less the
    capture) and the warm-up and capture are logged apart."""
    from repro_torch.federated import replay
    from repro_torch.federated.server import run_fl_scanned

    def timed(c):
        with graphs_made(replay) as made:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = run_fl_scanned(c, device=dev)
            torch.cuda.synchronize()
        return h, time.perf_counter() - t0, made[0]

    _, one, graphs_one = timed(dataclasses.replace(cfg, rounds=1))
    replays = []
    with graph_recording(torch, ops, replay) as (calls, replayed), \
            replay_timing(torch, replay, replays):
        ops.LAUNCHES["topk_reward"] = 0
        hist, secs, graphs = timed(cfg)
        launches = ops.LAUNCHES["topk_reward"]
    per_graph = graphs.launches.get("round", {}).get("topk_reward", 0)
    check(per_graph == 1, f"the round graph holds {per_graph} top-k launches")
    check(launches == 1 + cfg.rounds * per_graph,
          f"run_fl_scanned launched the kernel {launches} times")
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6c",
                         cfg.rounds)
    check(np.isfinite(hist.train_loss).all(), f"loss {hist.train_loss}")
    capture = sum(graphs.capture_s.values())
    capture_one = sum(graphs_one.capture_s.values())
    per_round = ((secs - capture) - (one - capture_one)) / (cfg.rounds - 1)
    row = {"s_per_round": per_round, "run_s": secs, "one_round_run_s": one,
           "replay_s": replays[1:],
           "capture_s": graphs.capture_s,
           "one_round_run_capture_s": graphs_one.capture_s,
           "set_up_s": one - per_round - capture_one,
           "host_s_per_round": host_per_round,
           "replayed_launches": cfg.rounds * per_graph,
           "warm_up_launches": launches - cfg.rounds * per_graph,
           "train_loss": hist.train_loss, "test_acc": hist.test_acc,
           "card": card_name_power()}
    log(f"phase 6c: run_fl_scanned full width, {cfg.n_clients} clients, k="
        f"{cfg.selector.k}, {cfg.rounds} rounds on {row['card']}: {secs:.3f} "
        f"s ({one:.3f} s for 1 round), each less its warm-up and capture "
        f"({graphs.capture_s} s; {graphs_one.capture_s} s), so "
        f"{per_round:.4f} s/round (host run_fl, phase 5: "
        f"{host_per_round:.4f} s/round; a round's replay alone, rounds 2 "
        f"and 3: {replays[1:]} s); set-up {row['set_up_s']:.3f} s; "
        f"kernel launches {launches} (warm-up {row['warm_up_launches']}, "
        f"replayed {row['replayed_launches']}), each == plain; train_loss "
        f"{hist.train_loss}, test_acc {hist.test_acc}")
    return row, err


@contextlib.contextmanager
def graphs_made(replay):
    """The ``StepGraphs`` the block creates, in order (each holds its steps'
    warm-up and capture seconds and the kernel launches a replay holds)."""
    made, init = [], replay.StepGraphs.__init__

    def record(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    replay.StepGraphs.__init__ = record
    try:
        yield made
    finally:
        replay.StepGraphs.__init__ = init


@contextlib.contextmanager
def replay_timing(torch, replay, times, step="round"):
    """Append the wall seconds of each ``step`` step of a fused engine
    (``"round"``, or the async selection engine's ``"agg"``) to ``times``,
    the device drained before and after it (the first includes its warm-up
    and capture)."""
    run = replay.StepGraphs.run

    def timed_run(self, name):
        if name != step:
            return run(self, name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(self, name)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)

    replay.StepGraphs.run = timed_run
    try:
        yield times
    finally:
        replay.StepGraphs.run = run


def trace_round(torch, run, step_hook, out_dir, name, top=10):
    """A ``torch.profiler`` trace of one round (the second) of ``run()``:
    ``step_hook(prof)`` makes the engine call ``prof.step()`` as each
    round starts. Returns the ``top`` device operations by total time and
    the device's idle share over the round (1 - the union of the device
    operations' intervals over the span from the round's start on the host
    to the end of its last device operation)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    trace = out_dir / f"trace_{name}.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(trace))
                 ) as prof:
        with step_hook(prof):
            run()
        torch.cuda.synchronize()
    return round_split(json.loads(trace.read_text())["traceEvents"], name,
                       top)


def round_split(events, name, top=10):
    """:func:`trace_round`'s reading of a chrome trace's events."""
    steps = [e for e in events if e.get("ph") == "X" and
             str(e.get("name", "")).startswith("ProfilerStep#")]
    check(steps, f"trace {name}: no profiler step")
    t0 = min(e["ts"] for e in steps)
    dev_ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset") and e["ts"] >= t0]
    check(dev_ops, f"trace {name}: no device operation")
    end = max(max(e["ts"] + e["dur"] for e in dev_ops),
              max(e["ts"] + e["dur"] for e in steps))
    busy, cur_s, cur_e = 0.0, None, None
    for e in sorted(dev_ops, key=lambda e: e["ts"]):
        s_, e_ = e["ts"], e["ts"] + e["dur"]
        if cur_e is None or s_ > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    totals = Counter()
    counts = Counter()
    for e in dev_ops:
        totals[e["name"][:100]] += e["dur"]
        counts[e["name"][:100]] += 1
    span = end - t0
    return {"span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / span, "device_ops": len(dev_ops),
            "top": [{"name": k, "ms": v / 1e3, "calls": counts[k]}
                    for k, v in totals.most_common(top)]}


def fused_steps(torch, replay, step="round"):
    """A ``step_hook`` for :func:`trace_round` that steps the profiler as
    each ``step`` step of a fused engine starts (``"round"``, or the
    async selection engine's ``"agg"``)."""
    @contextlib.contextmanager
    def hook(prof):
        run = replay.StepGraphs.run

        def stepping(self, name):
            if name == step:          # the last step's device work is done
                torch.cuda.synchronize()
                prof.step()
            return run(self, name)
        replay.StepGraphs.run = stepping
        try:
            yield
        finally:
            replay.StepGraphs.run = run
    return hook


def phase_profile(torch, dev, cfg):
    """6d: one round (the second) of each engine at 10,000 clients under
    ``torch.profiler`` (the traces, tens of MB, are read and dropped)."""
    from repro_torch.federated import replay
    from repro_torch.federated import server as tserver

    @contextlib.contextmanager
    def host_steps(prof):
        select = tserver.select

        def stepping(*a, **kw):
            torch.cuda.synchronize()
            prof.step()
            return select(*a, **kw)
        tserver.select = stepping
        try:
            yield
        finally:
            tserver.select = select

    rows = {}
    for name, engine, hook in (("host", "host", host_steps),
                               ("scanned", "scanned",
                                fused_steps(torch, replay))):
        with tempfile.TemporaryDirectory() as tmp:
            rows[name] = trace_round(
                torch, lambda: tserver.run_fl(cfg, engine=engine, device=dev),
                hook, Path(tmp), name)
        log(f"phase 6d: {name} engine, one round at {cfg.n_clients} clients "
            f"k={cfg.selector.k}: span {rows[name]['span_ms']:.2f} ms, device "
            f"busy {rows[name]['device_busy_ms']:.2f} ms, idle share "
            f"{rows[name]['idle_share']:.4f}, {rows[name]['device_ops']} "
            f"device operations; top: {rows[name]['top']}")
    return rows


# ------------------------------------------------ the async engines (6e-6g)
# FedBuff's knobs: examples/async_fedbuff.py's buffer-to-concurrency ratio
# (3 : 12) at k = 100, its staleness power
ASYNC_BUFFER, ASYNC_CONCURRENCY, ASYNC_POWER = 25, 100, 0.5
# 6f's fleet budget: the cohorts of 200 clients at full width spend about
# 3.9 kJ by the third aggregation and 9.8 kJ by the sixth, with 10
# clients' costs committed in flight, so 10 kJ refuses a refill (at the
# fourth aggregation in a run of the selection alone on the CPU)
ASYNC_BUDGET_J = 1.0e4


def async_fleet(torch, dev, n):
    """6e's population: phase 3's fleet with every client's bandwidths at
    its network's median (WiFi 40/15, 3G 6/2 Mbit/s), so six round times:
    arrivals tie, and the flush's order among equal times (lowest index
    first) decides who completes."""
    pop = fleet_population(torch, dev, n)
    wifi = pop.network == 0
    f32 = dict(dtype=torch.float32, device=dev)
    return pop.replace(
        down_mbps=torch.where(wifi, torch.tensor(40.0, **f32),
                              torch.tensor(6.0, **f32)),
        up_mbps=torch.where(wifi, torch.tensor(15.0, **f32),
                            torch.tensor(2.0, **f32)))


def expected_flush(t_done, start_version, server_version, b):
    """The flush the event clock calls for, recomputed on the host from the
    event state before it: the ``b`` earliest clients in flight (equal
    times lowest index first) and their staleness."""
    flying = np.nonzero(np.isfinite(t_done))[0]
    order = flying[np.lexsort((flying, t_done[flying]))]
    done = order[:b]
    return done, np.maximum(server_version - start_version[done], 0)


def check_flush(flush, before, b, power, label):
    """One aggregation's flush (host arrays) against its recomputation:
    the completed clients in order, their staleness, and the damping
    weights ``(1 + s) ** -power`` of the successful ones (float64, rtol
    1e-6; 0 elsewhere). Returns the largest staleness."""
    done, stale = expected_flush(*before, b)
    m = len(done)
    chosen = flush["comp_chosen"]
    check(int(chosen.sum()) == m and bool(chosen[:m].all()),
          f"{label}: {int(chosen.sum())} completions, {m} expected")
    check(np.array_equal(flush["completed"][:m], done),
          f"{label}: the flush completed {flush['completed'][:m]} where the "
          f"event clock calls for {done}")
    check(np.array_equal(flush["staleness"][:m], stale),
          f"{label}: staleness {flush['staleness'][:m]}, expected {stale}")
    s = flush["staleness"].astype(np.float64)
    expect = np.where(flush["succeeded"], (1.0 + s) ** -power, 0.0)
    check(np.allclose(flush["agg_weight"], expect, rtol=1e-6, atol=0.0),
          f"{label}: damping weights {flush['agg_weight']}, expected "
          f"{expect}")
    return int(stale.max()) if m else 0


def phase_async_selection(torch, ops, ref, dev, n, rounds):
    """6e: ``run_async_scanned`` at fleet scale, replayed from a CUDA
    graph, against eager steps of ``make_async_round_engine`` with the same
    keys, and each flush against its recomputation on the host."""
    from repro_torch import prng
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import SelectorConfig, SelectorState
    from repro_torch.federated import replay
    from repro_torch.federated.simulation import (AsyncEventState,
                                                  _async_xs,
                                                  make_async_round_engine,
                                                  run_async_scanned)

    pop = async_fleet(torch, dev, n)
    em = EnergyModel(busy_fraction=0.02)
    cfg = SelectorConfig("eafl", k=100)
    kw = dict(buffer_size=ASYNC_BUFFER, max_concurrency=ASYNC_CONCURRENCY,
              staleness_power=ASYNC_POWER)
    key = prng.PRNGKey(13, dev)
    with graph_recording(torch, ops, replay) as (calls, replayed), \
            graphs_made(replay) as made:
        ops.LAUNCHES["topk_reward"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _, traj = run_async_scanned(
            key, cfg, pop, SelectorState.create(cfg), em, 3.0e6, 10, 20,
            rounds, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.LAUNCHES["topk_reward"]
    capture = made[0].capture_s.get("agg", 0.0)
    check(launches == rounds + 2, f"async selection launched the kernel "
          f"{launches} times (the fill, the warm-up and {rounds} replays "
          f"expected)")
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6e",
                         rounds)
    ks = sorted({c[1]["k"] for c in calls + replayed})
    check(ks == [ASYNC_BUFFER, ASYNC_CONCURRENCY],
          f"phase 6e: top-k launched at k in {ks}")

    init_fill, step = make_async_round_engine(cfg, em, 3.0e6, 10, 20, **kw)
    key0, keys, refill = _async_xs(key, rounds)
    st, a, idx0, chosen0 = init_fill(key0, pop,
                                     SelectorState.create(cfg).canonical(dev),
                                     AsyncEventState.create(n, dev))
    check(np.array_equal(traj["fill_selected"],
                         idx0.to(torch.int32).cpu().numpy()),
          "phase 6e: the fill differs from an eager fill")
    p, stale_max = pop, 0
    for r in range(rounds):
        label = f"phase 6e, aggregation {r + 1}"
        before = (a.t_done.cpu().numpy(), a.start_version.cpu().numpy(),
                  int(a.server_version))
        p, st, a, flush, (ridx, rchosen) = step(keys[r], p, st, a, refill[r])
        flush = {k2: v.cpu().numpy() for k2, v in flush.items()}
        for name in ("completed", "comp_chosen", "succeeded", "staleness",
                     "agg_weight", "new_dropouts"):
            check(np.array_equal(traj[name][r], flush[name]),
                  f"{label}: {name} differs from the eager step")
        stale_max = max(stale_max, check_flush(flush, before, ASYNC_BUFFER,
                                               ASYNC_POWER, label))
        if r + 1 < rounds:
            sel, ch = ridx.cpu().numpy(), rchosen.cpu().numpy()
            check(np.array_equal(traj["selected"][r + 1], sel) and
                  np.array_equal(traj["chosen"][r + 1], ch),
                  f"{label}: the refill differs from the eager step")
            flying = np.isfinite(before[0])
            flying[flush["completed"][flush["comp_chosen"]]] = False
            check(not flying[sel[ch]].any(),
                  f"{label}: a client in flight was selected again")
        check(traj["mean_battery"][r] == float(p.battery_pct.mean()),
              f"{label}: mean battery differs from the eager step")
    check(torch.equal(final.battery_pct, p.battery_pct) and
          torch.equal(final.dropped, p.dropped),
          "phase 6e: the batteries differ from the eager steps")
    check(stale_max > 0, "phase 6e: no flush was stale")
    row = {"run_s": secs, "capture_s": capture,
           "s_per_agg_replayed": (secs - capture) / rounds,
           "launches": launches, "k": ks, "max_staleness": stale_max,
           "card": card_name_power()}
    log(f"phase 6e: run_async_scanned N={n} eafl k=100 buffer "
        f"{ASYNC_BUFFER} concurrency {ASYNC_CONCURRENCY} x{rounds} "
        f"aggregations replayed from a CUDA graph on {row['card']}: "
        f"{secs:.4f} s, of which the fill, warm-up and capture "
        f"{capture:.4f} s (so {row['s_per_agg_replayed']:.5f} s a replayed "
        f"aggregation and the fetch); top-k launches {launches} (the fill "
        f"at k={ASYNC_CONCURRENCY}, the warm-up, {len(replayed)} replayed "
        f"at k={ASYNC_BUFFER}), each == plain and each replayed one == an "
        f"eager launch; flushes, staleness (max {stale_max}), damping, "
        f"refills and batteries equal to eager steps and to the event "
        f"clock recomputed on the host")
    return launches, err, row


ASYNC_TRACE = ("completed", "comp_chosen", "succeeded", "staleness",
               "start_version", "selected", "chosen")


def check_traces(trace, traj, label):
    """The host loop's per-aggregation columns against the fused
    trajectory, index for index, the damping weights bit for bit."""
    for r, row in enumerate(trace):
        for name in ASYNC_TRACE:
            check(np.array_equal(row[name], traj[name][r]),
                  f"{label}, aggregation {r + 1}: {name} {row[name]} != "
                  f"{traj[name][r]}")
        check(np.array_equal(row["agg_weight"].view(np.int32),
                             traj["agg_weight"][r].view(np.int32)),
              f"{label}, aggregation {r + 1}: damping weights differ")


def phase_async_parity(torch, ops, ref, dev, cfg, budget=True,
                       restart=True):
    """6f: the fused async engine against the host event loop on the card
    (FLConfig defaults at full width, TF32 off), plain and (``budget``)
    with a fleet budget and recharge; then (``restart``) killed after
    aggregation 2 and resumed, bitwise equal to the uninterrupted run.
    All under cuDNN's deterministic algorithms: with the default ones the
    weight gradients' atomics make a run differ from itself, and stale
    updates amplify that past the tests' 2e-3 in train_loss within six
    aggregations; deterministic, each engine repeats itself bitwise and
    the two engines differ only by the flush's width."""
    from repro_torch.federated import replay
    from repro_torch.federated.async_server import (run_fl_async,
                                                    run_fl_async_scanned)

    cases = {"plain": cfg}
    if budget:
        cases["budget+recharge"] = dataclasses.replace(
            cfg, energy_budget_j=ASYNC_BUDGET_J, recharge_pct_per_hour=5.0,
            plugged_frac=0.4)
    out, stale_max = {}, 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with graph_recording(torch, ops, replay) as (calls, replayed):
            for name, c in cases.items():
                trace, cap = [], {}
                fused = run_fl_async_scanned(c, device=dev, _capture=cap)
                host = run_fl_async(c, device=dev, _trace=trace)
                check_engines_agree(host, fused, f"phase 6f {name}",
                                    c.eval_samples)
                check_traces(trace, cap["traj"], f"phase 6f {name}")
                stale_max = max([stale_max] + [int(t["staleness"].max())
                                               for t in trace])
                loss_f, loss_h = (np.asarray(h.train_loss, np.float64)
                                  for h in (fused, host))
                out[name] = {"train_loss": fused.train_loss,
                             "test_acc": fused.test_acc,
                             "train_loss_rel_diff": float(np.nanmax(
                                 np.abs(loss_f - loss_h) / np.abs(loss_h))),
                             "aggregations": len(fused.round),
                             "budget_exhausted_round":
                                 fused.budget_exhausted_round,
                             "staleness": [t["staleness"].tolist()
                                           for t in trace]}
            check(stale_max > 0, "phase 6f: no flush was stale")
            if budget:
                check(out["budget+recharge"]["budget_exhausted_round"]
                      is not None, "phase 6f: the budget refused no batch")
            if restart:
                with tempfile.TemporaryDirectory() as tmp:
                    c = cases["budget+recharge" if budget else "plain"]
                    whole = run_fl_async_scanned(c, device=dev)
                    path = str(Path(tmp) / "async-{round}.ckpt")
                    seg = run_fl_async_scanned(dataclasses.replace(
                        c, checkpoint_path=path, checkpoint_every=2),
                        device=dev)
                    resumed = run_fl_async_scanned(dataclasses.replace(
                        c, resume_from=path.format(round=2)), device=dev)
                check(same_history(whole, seg), "phase 6f: the segmented "
                      "run differs from the uninterrupted one")
                check(same_history(whole, resumed), "phase 6f: the run "
                      "resumed after aggregation 2 differs from the "
                      "uninterrupted one")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    # one replay an aggregation of each fused run (the eval graph holds no
    # top-k): each case's, and the uninterrupted, segmented and resumed runs
    expect = cfg.rounds * len(cases) + (3 * cfg.rounds - 2 if restart
                                        else 0)
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6f",
                         expect)
    log(f"phase 6f: run_fl_async_scanned == run_fl_async on the card, "
        f"{cfg.n_clients} clients, k={cfg.selector.k}, buffer "
        f"{cfg.buffer_size}, concurrency {cfg.max_concurrency}, "
        f"{cfg.rounds} aggregations, full width, cuDNN deterministic "
        f"({', '.join(cases)}): flush and refill columns equal, damping "
        f"bitwise, max staleness {stale_max}"
        + ("; segmented and resumed-after-aggregation-2 runs bitwise equal"
           if restart else "")
        + f"; {len(replayed)} replayed launches, each == plain and == an "
        f"eager launch: {out}")
    return len(replayed), err, out


def phase_async_scale(torch, ops, ref, dev, cfg):
    """6g, the async main path: ``run_fl(mode="async")`` at 10,000
    clients, host and fused engines in this call. For each: a 3-aggregation
    run minus a 1-aggregation run (the fused runs each less their warm-up
    and capture) over 2 is an aggregation; the set-up, the warm-up and
    capture and the peak device memory apart; then one profiled
    aggregation (the second) of each. Each engine's top-k count is set to
    0 just before its timed run and read just after."""
    from repro_torch.federated import async_server, replay
    from repro_torch.federated.server import run_fl

    def timed(c, engine):
        with graphs_made(replay) as made:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = run_fl(c, mode="async", engine=engine, device=dev)
            torch.cuda.synchronize()
        capture = sum(made[0].capture_s.values()) if made else 0.0
        return h, time.perf_counter() - t0, capture, made

    rows, errs = {}, []
    for engine in ("host", "scanned"):
        _, one, capture_one, _ = timed(dataclasses.replace(cfg, rounds=1),
                                       engine)
        torch.cuda.reset_peak_memory_stats()
        with graph_recording(torch, ops, replay) as (calls, replayed):
            ops.LAUNCHES["topk_reward"] = 0
            hist, secs, capture, made = timed(cfg, engine)
            launches = ops.LAUNCHES["topk_reward"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        fused = engine == "scanned"
        expect = cfg.rounds + (2 if fused else 1)
        check(launches == expect, f"phase 6g {engine}: the kernel launched "
              f"{launches} times, {expect} expected")
        errs.append(check_replayed(torch, ops, ref, calls, replayed,
                                   f"phase 6g {engine}",
                                   cfg.rounds if fused else 0))
        check(np.isfinite(hist.train_loss).all(), f"loss {hist.train_loss}")
        check(hist.round == list(range(1, cfg.rounds + 1)), f"{hist.round}")
        per_agg = ((secs - capture) - (one - capture_one)) / (cfg.rounds - 1)
        rows[engine] = {
            "s_per_agg": per_agg, "run_s": secs, "one_agg_run_s": one,
            "capture_s": made[0].capture_s if made else {},
            "set_up_s": one - per_agg - capture_one, "peak_gib": peak,
            "launches": launches, "train_loss": hist.train_loss,
            "test_acc": hist.test_acc}

    @contextlib.contextmanager
    def host_steps(prof):
        make = async_server._async_engine

        def stepping_engine(*a, **kw):
            init_fill, step = make(*a, **kw)

            def stepping(*s, **skw):
                torch.cuda.synchronize()
                prof.step()
                return step(*s, **skw)
            return init_fill, stepping
        async_server._async_engine = stepping_engine
        try:
            yield
        finally:
            async_server._async_engine = make

    # the fused engine's aggregation is its "round" step
    for engine, hook in (("host", host_steps),
                         ("scanned", fused_steps(torch, replay))):
        with tempfile.TemporaryDirectory() as tmp:
            rows[engine]["profile"] = trace_round(
                torch, lambda: run_fl(cfg, mode="async", engine=engine,
                                      device=dev),
                hook, Path(tmp), f"async_{engine}")
    card = card_name_power()
    for engine, row in rows.items():
        prof = row["profile"]
        row["card"] = card
        log(f"phase 6g: run_fl(mode='async', engine='{engine}') full width, "
            f"{cfg.n_clients} clients, k={cfg.selector.k}, buffer "
            f"{cfg.buffer_size}, concurrency {cfg.max_concurrency}, on "
            f"{card}: {row['run_s']:.3f} s for {cfg.rounds} aggregations "
            f"({row['one_agg_run_s']:.3f} s for 1), warm-up and capture "
            f"{row['capture_s']} s, so {row['s_per_agg']:.4f} s an "
            f"aggregation; set-up {row['set_up_s']:.3f} s; peak memory "
            f"{row['peak_gib']:.2f} GiB; top-k launches {row['launches']}, "
            f"each == plain; one profiled aggregation: span "
            f"{prof['span_ms']:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.4f}, {prof['device_ops']} device "
            f"operations; top: {prof['top']}")
    return rows, max(errs)

# ------------------------------------------ the front doors (6h, 6i, 6j)
def pulled_k(hist, arms, k):
    """Each round's cohort size under the controller: the pulled arm's k,
    or the config's when the arm inherits it (overcommit 1)."""
    return [k if arms[a].k is None else arms[a].k
            for a in hist.controller_arm]


def phase_controller(torch, ops, ref, dev, cfg, scale_cfg, host_per_round):
    """6h: ``run_fl`` with the UCB knob controller in the host loop, the
    paper model at full width (``cfg``: the FLConfig defaults), cuDNN's
    deterministic algorithms. Five arms: k = 5, 10, 20, one that sets
    ``compression_sparsity`` (under ``compression="topk"``) and one that
    sets ``buffer_size`` with ``staleness_power=0.5``; 7 rounds. The first
    five pulls are the untried arms in index order; each round launches
    the top-k kernel once at its arm's k, each launch equal to its plain
    version; a run checkpointed after round 3 and resumed equals the run
    without a break bitwise; a controller whose only arm inherits every
    knob reproduces the controller-free run bitwise. Then the main path's
    size (``scale_cfg``: 10,000 clients, k = 100): s/round with the
    all-inherit controller beside the run without one, in turns, and one
    reward probe (an evaluation of the test set) timed alone."""
    from repro_torch import prng
    from repro_torch.data.partition import make_test_set
    from repro_torch.federated.controller import Arm, ControllerConfig
    from repro_torch.federated.server import _accuracy_fn, run_fl
    from repro_torch.models.resnet import init_resnet

    arms = (Arm(k=5), Arm(k=10), Arm(k=20), Arm(compression_sparsity=0.25),
            Arm(buffer_size=4, staleness_power=0.5))
    c = dataclasses.replace(cfg, rounds=7, compression="topk",
                            compression_sparsity=0.05,
                            controller=ControllerConfig(arms=arms))
    inherit = ControllerConfig(arms=(Arm(),))
    torch.backends.cudnn.deterministic = True
    try:
        with recording(ops) as calls:
            ops.LAUNCHES["topk_reward"] = 0
            whole = run_fl(c, device=dev)
            launches = ops.LAUNCHES["topk_reward"]
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "ctrl-{round}.ckpt")
            seg = run_fl(dataclasses.replace(c, checkpoint_path=path,
                                             checkpoint_every=3), device=dev)
            resumed = run_fl(dataclasses.replace(
                c, resume_from=path.format(round=3)), device=dev)
        plain = run_fl(cfg, device=dev)
        one_arm = run_fl(dataclasses.replace(cfg, controller=inherit),
                         device=dev)
    finally:
        torch.backends.cudnn.deterministic = False
    ks = pulled_k(whole, arms, c.selector.k)
    check(whole.controller_arm[:5] == [0, 1, 2, 3, 4],
          f"phase 6h: first pulls {whole.controller_arm[:5]}")
    check(launches == c.rounds, f"phase 6h: the kernel launched {launches} "
          f"times in {c.rounds} rounds")
    check([kw["k"] for _, kw, _ in calls] == ks,
          f"phase 6h: launches at k {[kw['k'] for _, kw, _ in calls]}, "
          f"the pulled arms' k {ks}")
    err = check_recorded(torch, ref, calls, "phase 6h")
    check(same_history(whole, seg), "phase 6h: the checkpointed run differs "
          "from the uninterrupted one")
    check(same_history(whole, resumed), "phase 6h: the run resumed after "
          "round 3 differs from the uninterrupted one")
    check(one_arm.controller_arm == [0] * cfg.rounds,
          f"phase 6h: all-inherit pulls {one_arm.controller_arm}")
    check(same_history(plain, dataclasses.replace(one_arm,
                                                  controller_arm=[])),
          "phase 6h: the all-inherit controller moved the trajectory")

    def timed(run_cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = run_fl(run_cfg, device=dev)
        torch.cuda.synchronize()
        return h, time.perf_counter() - t0

    # the controller's s/round beside the same run without one, in turns
    # (plain, controller, controller, plain), each a 3-round run minus a
    # 1-round run over 2; each 3-round run's count set to 0 just before
    # it and read just after
    big = dataclasses.replace(scale_cfg, controller=inherit)
    turns, big_launches = [], []
    for name in ("plain", "controller", "controller", "plain"):
        run_cfg = big if name == "controller" else scale_cfg
        _, one = timed(dataclasses.replace(run_cfg, rounds=1))
        with recording(ops) as big_calls:
            ops.LAUNCHES["topk_reward"] = 0
            hist, secs = timed(run_cfg)
            turn_launches = ops.LAUNCHES["topk_reward"]
        check(turn_launches == run_cfg.rounds, f"phase 6h at "
              f"{run_cfg.n_clients} ({name}): the kernel launched "
              f"{turn_launches} times")
        err = max(err, check_recorded(torch, ref, big_calls,
                                      f"phase 6h 10k {name}"))
        check(np.isfinite(hist.train_loss).all(), f"loss {hist.train_loss}")
        if name == "controller":
            check(hist.controller_arm == [0] * run_cfg.rounds,
                  f"phase 6h 10k: pulls {hist.controller_arm}")
            big_launches.append(turn_launches)
        turns.append({"run": name, "s_per_round":
                      (secs - one) / (run_cfg.rounds - 1), "run_s": secs,
                      "one_round_run_s": one})
    per = {name: statistics.mean(t["s_per_round"] for t in turns
                                 if t["run"] == name)
           for name in ("plain", "controller")}
    key = prng.PRNGKey(big.seed, dev)
    test = make_test_set(key, big.eval_samples, big.n_classes, big.input_hw,
                         noise=big.data_noise)
    probe = _accuracy_fn(big.model, test)
    params = init_resnet(prng.fold_in(key, 1), big.model)
    probe_ms = cuda_ms(torch, probe, [(params,)])
    row = {"arms": [a.describe() for a in arms],
           "pulls": whole.controller_arm, "k_by_round": ks,
           "launches": launches, "train_loss": whole.train_loss,
           "test_acc": whole.test_acc, "turns_10k": turns,
           "s_per_round_10k": per["controller"],
           "plain_s_per_round_10k": per["plain"],
           "launches_10k": big_launches,
           "host_s_per_round_phase5": host_per_round,
           "probe_eval_ms": probe_ms, "card": card_name_power()}
    log(f"phase 6h: run_fl with the knob controller, {cfg.n_clients} "
        f"clients full width, {c.rounds} rounds, arms {row['arms']}: pulls "
        f"{whole.controller_arm} (untried first), top-k at k {ks}, "
        f"{launches} launches each == plain; checkpointed and resumed-"
        f"after-round-3 runs bitwise equal; the all-inherit controller "
        f"bitwise the controller-free run. At {big.n_clients} clients, k="
        f"{big.selector.k}, {big.rounds} rounds on {row['card']}, in turns "
        f"(plain, controller, controller, plain): "
        f"{[round(t['s_per_round'], 4) for t in turns]} s/round, so "
        f"{per['controller']:.4f} s/round with the all-inherit controller "
        f"and its reward probe against {per['plain']:.4f} without (host "
        f"run_fl, phase 5: {host_per_round:.4f} s/round); one probe "
        f"evaluation of {big.eval_samples} test samples {probe_ms:.4f} ms "
        f"(CUDA events); launches {big_launches} a controller run, each "
        f"== plain")
    return row, err


def phase_dispatch(torch, ops, ref, dev, n, rounds):
    """6i: the ``run_rounds`` front door at fleet scale (phase 3's
    population, eafl, k = 100, ``rounds`` rounds): ``"auto"`` resolves to
    ``"scanned"`` and ``"async"`` to ``"async-scanned"`` (buffer 25,
    concurrency 100); the forced names too; every leg's trajectory index
    for index equal to a direct call of ``run_rounds_scanned`` or
    ``run_async_scanned`` with the same key. Each leg's top-k count is set
    to 0 just before it and read just after. Then the million-client
    example twin on the card: the kernel against its plain version, and
    ``select`` (the kernel) against the host oracle ``select_host``, index
    for index, each timed."""
    from repro_torch import prng
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import SelectorConfig, SelectorState
    from repro_torch.examples import million_client_selection
    from repro_torch.federated import replay
    from repro_torch.federated.simulation import (run_async_scanned,
                                                  run_rounds,
                                                  run_rounds_scanned)

    pop = fleet_population(torch, dev, n)
    em = EnergyModel(busy_fraction=0.02)
    cfg = SelectorConfig("eafl", k=100)
    key = prng.PRNGKey(13, dev)
    args = (key, cfg, pop, SelectorState.create(cfg), em, 3.0e6, 10, 20,
            rounds)
    knobs = dict(buffer_size=ASYNC_BUFFER, max_concurrency=ASYNC_CONCURRENCY,
                 staleness_power=ASYNC_POWER)
    legs = {"auto": (lambda: run_rounds(*args), "scanned", 1),
            "scanned": (lambda: run_rounds(*args, mode="scanned"),
                        "scanned", 1),
            "direct scanned": (lambda: run_rounds_scanned(*args), None, 1),
            "async": (lambda: run_rounds(*args, mode="async", **knobs),
                      "async-scanned", 2),
            "async-scanned": (lambda: run_rounds(
                *args, mode="async-scanned", **knobs), "async-scanned", 2),
            "direct async": (lambda: run_async_scanned(*args, **knobs),
                             None, 2)}
    out, row = {}, {"engines": {}, "s": {}, "launches": {}}
    with graph_recording(torch, ops, replay) as (calls, replayed):
        for name, (run, engine, eager) in legs.items():
            ops.LAUNCHES["topk_reward"] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fpop, _, traj = run()
            torch.cuda.synchronize()
            row["s"][name] = time.perf_counter() - t0
            row["launches"][name] = ops.LAUNCHES["topk_reward"]
            # a warm-up launch (and the async fill) and one a replay
            check(row["launches"][name] == eager + rounds,
                  f"phase 6i {name}: {row['launches'][name]} launches")
            if engine is not None:
                check(traj["engine"] == engine, f"phase 6i {name}: engine "
                      f"{traj['engine']}, {engine} expected")
                row["engines"][name] = traj["engine"]
            out[name] = (fpop, traj)
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6i",
                         len(legs) * rounds)
    for name, base in (("auto", "direct scanned"),
                       ("scanned", "direct scanned"),
                       ("async", "direct async"),
                       ("async-scanned", "direct async")):
        (p, t), (bp, bt) = out[name], out[base]
        for f in bt:
            if f in ("engine", "final_event_state"):
                continue
            check(np.array_equal(np.asarray(t[f]), np.asarray(bt[f])),
                  f"phase 6i {name}: {f} differs from {base}")
        check(torch.equal(p.battery_pct, bp.battery_pct),
              f"phase 6i {name}: batteries differ from {base}")

    with graph_recording(torch, ops, replay) as (ex_calls, ex_replayed):
        ops.LAUNCHES["topk_reward"] = 0
        times = million_client_selection.main(
            ["--n", str(n), "--k", "100", "--rounds", str(rounds),
             "--device", str(dev)])
        ex_launches = ops.LAUNCHES["topk_reward"]
    # step 1's two launches (a warm-up and the timed one), step 2's two
    # select calls, step 3's warm-up and one a replayed round, and step
    # 4's (the sharded engine on a one-shard mesh) as many
    check(ex_launches == 2 + 2 + 2 * (1 + rounds),
          f"phase 6i: the example launched {ex_launches} times")
    err = max(err, check_replayed(torch, ops, ref, ex_calls, ex_replayed,
                                  "phase 6i example", 2 * rounds))
    row.update({"example_s": times, "example_launches": ex_launches,
                "card": card_name_power()})
    log(f"phase 6i: run_rounds at N={n}, eafl k=100, {rounds} rounds on "
        f"{row['card']}: engines {row['engines']}, every leg index for "
        f"index equal to the direct engine call; launches {row['launches']}"
        f", each == plain; seconds a leg {row['s']}. The million-client "
        f"example on the card: kernel == plain and select (kernel) == "
        f"select_host at N={n}; select {times['select_s']:.5f} s, "
        f"select_host {times['select_host_s']:.5f} s, kernel "
        f"{times['kernel_s']:.5f} s, plain {times['plain_s']:.5f} s, "
        f"{rounds} fused rounds {times['scan_s']:.4f} s, the same on a "
        f"one-shard mesh {times['shard_s']:.4f} s")
    return row, err


def phase_train_cli(torch):
    """6j: ``python -m repro_torch.launch.train fl --rounds 2`` in a
    process of its own, on the card (no ``--device``): it exits 0 and
    writes a ``history.json`` of 2 rounds with finite losses. Its kernel
    launches are that process's and are not counted here."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(SRC), env.get("PYTHONPATH")) if p)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "fl",
             "--rounds", "2", "--out", tmp], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 6j: train fl exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        hist = json.loads((Path(tmp) / "history.json").read_text())
    check(hist["round"] == [1, 2], f"phase 6j: rounds {hist['round']}")
    check(len(hist["test_acc"]) == 2 and np.isfinite(hist["train_loss"]).all(),
          f"phase 6j: history {hist}")
    row = {"s": secs, "train_loss": hist["train_loss"],
           "test_acc": hist["test_acc"], "card": card_name_power()}
    log(f"phase 6j: python -m repro_torch.launch.train fl --rounds 2 on "
        f"{row['card']}: exit 0 in {secs:.2f} s (process start, CUDA "
        f"initialisation and set-up included), history.json of 2 rounds, "
        f"train_loss {hist['train_loss']}, test_acc {hist['test_acc']}; "
        f"last line: {proc.stdout.strip().splitlines()[-1]}")
    return row


# --------------------------------------- the sharded engines (6k-6m)
SHARD_EXACT = ("selected", "chosen", "succeeded", "corrupt", "retries",
               "new_dropouts", "total_dropped", "round_duration")


def check_sharded_rounds(torch, got, base, label, exact_floats=False):
    """A ``run_rounds_sharded`` result against a ``run_rounds_scanned`` one
    on the same key: the index and count columns, durations, batteries,
    dropouts and the selector state equal; the summed floats within rtol
    1e-6 (equal too with ``exact_floats``)."""
    (p, st, t), (bp, bst, bt) = got, base
    for f in SHARD_EXACT + (("mean_battery", "energy_spent_pct",
                             "energy_spent_j") if exact_floats else ()):
        check(np.array_equal(t[f], bt[f]), f"{label}: {f} differs")
    for f in ("mean_battery", "energy_spent_pct", "energy_spent_j"):
        np.testing.assert_allclose(t[f], bt[f], rtol=1e-6,
                                   err_msg=f"{label}: {f}")
    check(torch.equal(p.battery_pct, bp.battery_pct),
          f"{label}: batteries differ")
    check(torch.equal(p.dropped, bp.dropped), f"{label}: dropouts differ")
    for f in ("round", "epsilon", "pacer_T", "util_ema"):
        check(float(getattr(st, f)) == float(getattr(bst, f)),
              f"{label}: state.{f} differs")


def timed_engine(torch, replay, fn, *args, **kw):
    """``fn(*args, **kw)`` on the card: ``(its result, seconds, the first
    StepGraphs it made)``."""
    with graphs_made(replay) as made:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, made[0]


def phase_sharded_selection(torch, ops, ref, dev, n, rounds,
                            counts=(1, 2, 8)):
    """6k: ``run_rounds_sharded`` at fleet scale on virtual ``clients``
    meshes of ``counts`` shards, one card, each round one CUDA-graph
    replay, against ``run_rounds_scanned`` with the same key (phase 3's
    population, eafl, k = 100). Each shard launches the top-k kernel with
    its own ``index_offset``; every launch is held against the plain
    version and each replayed one against an eager launch. The count is
    set to 0 just before each mesh's run and read just after. Then one
    step on a population whose scores all tie (exploitation only): the
    sharded step (``make_sharded_select_step``) picks the lowest indices,
    as the single-device step does."""
    from repro_torch import prng
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import (SelectorConfig, SelectorState,
                                            _device_select,
                                            make_sharded_select_step)
    from repro_torch.federated import replay
    from repro_torch.federated.simulation import (run_rounds_scanned,
                                                  run_rounds_sharded)
    from repro_torch.launch.mesh import make_client_mesh

    pop = fleet_population(torch, dev, n)
    cfg = SelectorConfig("eafl", k=100)
    args = (prng.PRNGKey(17, dev), cfg, pop, SelectorState.create(cfg),
            EnergyModel(busy_fraction=0.02), 3.0e6, 10, 20, rounds)
    rows = {}

    def timed(fn, **kw):
        """The run with each round step timed alone: the first holds the
        warm-up and the capture, the others are replays; the rest of the
        run (padding, layout, key split, fetch) is its set-up."""
        times = []
        with replay_timing(torch, replay, times):
            out, secs, graphs = timed_engine(torch, replay, fn, *args, **kw)
        return out, graphs, {
            "run_s": secs, "setup_s": secs - sum(times),
            "first_step_s": times[0],
            "capture_s": graphs.capture_s.get("round", 0.0),
            "replay_s": times[1:]}

    base, _, rows["scanned"] = timed(run_rounds_scanned)
    launches = {}
    with graph_recording(torch, ops, replay) as (calls, replayed):
        for d in counts:
            mesh = make_client_mesh(d)
            ops.LAUNCHES["topk_reward"] = 0
            got, graphs, rows[f"D={d}"] = timed(run_rounds_sharded,
                                                mesh=mesh)
            launches[d] = ops.LAUNCHES["topk_reward"]
            # one launch a shard in the warm-up and in each replay
            check(launches[d] == d * (1 + rounds), f"phase 6k D={d}: the "
                  f"kernel launched {launches[d]} times")
            held = graphs.launches.get("round")
            check(held == {"topk_reward": d},
                  f"phase 6k D={d}: the round graph holds {held}")
            check_sharded_rounds(torch, got, base, f"phase 6k D={d}")
        flat = pop.replace(
            stat_util=torch.ones_like(pop.stat_util),
            last_duration=torch.ones_like(pop.last_duration),
            battery_pct=torch.full_like(pop.battery_pct, 80.0),
            explored=torch.ones_like(pop.explored),
            dropped=torch.zeros_like(pop.dropped))
        pred = torch.full_like(pop.battery_pct, 3.0)
        tie_cfg = SelectorConfig("eafl", k=100, epsilon0=0.0,
                                 epsilon_min=0.0)
        key = prng.PRNGKey(23, dev)
        want_idx, _, _ = _device_select(key, tie_cfg, SelectorState.create(
            tie_cfg), flat, pred, dev.type == "cuda")
        check(torch.equal(want_idx, torch.arange(100, device=dev)),
              "phase 6k ties: the single-device step does not pick the "
              "lowest indices")
        for d in counts:
            idx, _, _ = make_sharded_select_step(
                tie_cfg, make_client_mesh(d), n)(
                key, SelectorState.create(tie_cfg), flat, pred)
            check(torch.equal(idx, want_idx), f"phase 6k ties D={d}: "
                  f"picks {idx[:8].tolist()}...")
    # the single-device engine again, so that the comparison is in turns
    _, _, rows["scanned, again"] = timed(run_rounds_scanned)
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6k",
                         sum(d * rounds for d in counts))
    offsets = sorted({kw.get("index_offset", 0)
                      for _, kw, _ in calls + replayed})
    want = sorted({s * (n // d) for d in counts for s in range(d)})
    check(offsets == want, f"phase 6k: index offsets {offsets}, {want} "
          f"expected")
    out = {"rows": rows, "launches": launches, "card": card_name_power()}
    log(f"phase 6k: run_rounds_sharded N={n} eafl k=100 x{rounds} rounds on "
        f"virtual meshes of {list(counts)} shards on {out['card']}, each "
        f"round one CUDA-graph replay: selected, chosen, succeeded, "
        f"dropouts, batteries and selector state equal to "
        f"run_rounds_scanned, and the all-ties step's picks the lowest "
        f"indices; kernel launches {launches} (one a shard in "
        f"the warm-up and in each replay, index offsets {offsets}), each "
        f"== plain and == an eager launch; seconds (the run, its set-up, "
        f"the first step with warm-up and capture, the capture alone, "
        f"each replayed round alone): {rows}")
    return out, err


def phase_sharded_training(torch, ops, ref, dev, cfg, counts=(1, 4)):
    """6l: ``run_fl`` with ``engine="sharded"`` (one shard) and
    ``run_fl_sharded`` on a 4-shard virtual mesh at 10,000 clients, full
    width, against ``run_fl_scanned`` on the card, cuDNN's deterministic
    algorithms: selected, chosen and succeeded equal round for round, the
    history at tests/test_torch_training_engines.py's tolerances (one
    shard bitwise). Each round replay is timed alone beside the fused
    engine's, in turns (fused, 1 shard, 4 shards, fused), warm-up and
    capture apart; one round of the 4-shard engine is profiled (idle
    share). A ``train-sync`` snapshot of the fused engine after round 2
    resumes in the 4-shard engine."""
    from repro_torch.federated import replay
    from repro_torch.federated.server import (run_fl, run_fl_scanned,
                                              run_fl_sharded)
    from repro_torch.launch.mesh import make_client_mesh

    cols = ("selected", "chosen", "succeeded")
    rows, launches, out = {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "scanned-{round}.ckpt")
            times = []
            with replay_timing(torch, replay, times):
                base, secs, graphs = timed_engine(
                    torch, replay, run_fl_scanned, dataclasses.replace(
                        cfg, checkpoint_path=path, checkpoint_every=2),
                    device=dev)
            base_cols = {f: graphs.traj[f].cpu().numpy() for f in cols}
            rows["scanned"] = {"run_s": secs, "capture_s": graphs.capture_s,
                               "replay_s": times[1:]}
            for d in counts:
                mesh = make_client_mesh(d)
                times = []
                with graph_recording(torch, ops, replay) as (calls,
                                                             replayed), \
                        replay_timing(torch, replay, times):
                    ops.LAUNCHES["topk_reward"] = 0
                    if d == 1:
                        hist, secs, graphs = timed_engine(
                            torch, replay, run_fl, cfg, engine="sharded",
                            device=dev)
                    else:
                        hist, secs, graphs = timed_engine(
                            torch, replay, run_fl_sharded, cfg, mesh=mesh,
                            device=dev)
                    launches[d] = ops.LAUNCHES["topk_reward"]
                check(launches[d] == d * (1 + cfg.rounds),
                      f"phase 6l D={d}: the kernel launched {launches[d]} "
                      f"times")
                err = check_replayed(torch, ops, ref, calls, replayed,
                                     f"phase 6l D={d}", d * cfg.rounds)
                out[f"max_abs_err_D={d}"] = err
                for f in cols:
                    check(np.array_equal(graphs.traj[f].cpu().numpy(),
                                         base_cols[f]),
                          f"phase 6l D={d}: {f} differs from the fused "
                          f"engine's")
                if d == 1:
                    check(same_history(base, hist), "phase 6l D=1: the "
                          "history differs from the fused engine's")
                check_engines_agree(base, hist, f"phase 6l D={d}",
                                    cfg.eval_samples)
                rows[f"D={d}"] = {"run_s": secs,
                                  "capture_s": graphs.capture_s,
                                  "replay_s": times[1:],
                                  "train_loss": hist.train_loss,
                                  "test_acc": hist.test_acc}
            resumed = run_fl_sharded(dataclasses.replace(
                cfg, resume_from=path.format(round=2)), n_shards=counts[-1],
                device=dev)
            check_engines_agree(base, resumed, f"phase 6l: the fused "
                                f"engine's snapshot resumed on "
                                f"{counts[-1]} shards", cfg.eval_samples)
            times = []
            with replay_timing(torch, replay, times):
                again, secs, graphs = timed_engine(torch, replay,
                                                   run_fl_scanned, cfg,
                                                   device=dev)
            check(same_history(base, again), "phase 6l: the fused engine "
                  "did not repeat itself")
            rows["scanned, again"] = {"run_s": secs,
                                      "capture_s": graphs.capture_s,
                                      "replay_s": times[1:]}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    d = counts[-1]
    with tempfile.TemporaryDirectory() as tmp:
        rows[f"D={d}"]["profile"] = trace_round(
            torch, lambda: run_fl_sharded(cfg, n_shards=d, device=dev),
            fused_steps(torch, replay), Path(tmp), f"sharded{d}")
    out.update({"rows": rows, "launches": launches,
                "card": card_name_power()})
    log(f"phase 6l: run_fl sharded (D in {list(counts)}) against "
        f"run_fl_scanned, {cfg.n_clients} clients, k={cfg.selector.k}, "
        f"{cfg.rounds} rounds, full width, on {out['card']}: selection "
        f"columns equal, D=1 bitwise, the history within the tests' "
        f"tolerances; the fused engine's snapshot after round 2 resumed "
        f"on {d} shards within them; kernel launches {launches}; seconds "
        f"(run, warm-up + capture, each replayed round alone) and the "
        f"{d}-shard round's profile: {rows}")
    return out, max(v for k, v in out.items() if k.startswith("max_abs"))


def phase_process_group(torch, ops, ref, dev, n, rounds):
    """6m: a ``torch.distributed`` NCCL group of world size 1 (a
    ``FileStore``, bootstrap on the loopback) and ``run_rounds_sharded``
    and ``run_async_sharded`` over its process-group mesh at fleet scale:
    the collectives run through NCCL and are captured in the round's and
    the aggregation's CUDA graphs (counted during capture); each run
    equals the virtual one-shard mesh's bitwise."""
    import torch.distributed as dist
    from repro_torch import prng
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import SelectorConfig, SelectorState
    from repro_torch.federated import replay
    from repro_torch.federated.simulation import (run_async_sharded,
                                                  run_rounds_sharded)
    from repro_torch.launch.mesh import make_client_mesh

    pop = fleet_population(torch, dev, n)
    cfg = SelectorConfig("eafl", k=100)
    args = (prng.PRNGKey(19, dev), cfg, pop, SelectorState.create(cfg),
            EnergyModel(busy_fraction=0.02), 3.0e6, 10, 20, rounds)
    virtual = run_rounds_sharded(*args, mesh=make_client_mesh(1))
    # the async engine (phase 6e's population, where arrivals tie)
    aargs = (prng.PRNGKey(31, dev), cfg, async_fleet(torch, dev, n),
             SelectorState.create(cfg), EnergyModel(busy_fraction=0.02),
             3.0e6, 10, 20, rounds)
    akw = dict(buffer_size=ASYNC_BUFFER, max_concurrency=ASYNC_CONCURRENCY,
               staleness_power=ASYNC_POWER)
    avirtual = run_async_sharded(*aargs, **akw, mesh=make_client_mesh(1))
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(torch.cuda.current_device()
                          if dev.index is None else dev.index)
    captured = Counter()
    sound = {name: getattr(dist, name) for name in ("all_reduce",
                                                    "all_gather")}

    def counting(name):
        def call(*a, **kw):
            if torch.cuda.is_current_stream_capturing():
                captured[name] += 1
            return sound[name](*a, **kw)
        return call

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = make_client_mesh()
            check(mesh.group is not None and mesh.size() == 1,
                  f"phase 6m: mesh {mesh}")
            for name in sound:
                setattr(dist, name, counting(name))
            with graph_recording(torch, ops, replay) as (calls, replayed):
                ops.LAUNCHES["topk_reward"] = 0
                got, secs, graphs = timed_engine(
                    torch, replay, run_rounds_sharded, *args, mesh=mesh)
                launches = ops.LAUNCHES["topk_reward"]
                sync_captured = Counter(captured)
                captured.clear()
                ops.LAUNCHES["topk_reward"] = 0
                agot, asecs, agraphs = timed_engine(
                    torch, replay, run_async_sharded, *aargs, **akw,
                    mesh=mesh)
                alaunches = ops.LAUNCHES["topk_reward"]
        finally:
            for name, fn in sound.items():
                setattr(dist, name, fn)
            dist.destroy_process_group()
    check(launches == 1 + rounds, f"phase 6m: the kernel launched "
          f"{launches} times")
    check(alaunches == 2 + rounds, f"phase 6m async: the kernel launched "
          f"{alaunches} times")
    for label, counted in (("", sync_captured), (" async", captured)):
        check(counted["all_reduce"] > 0 and counted["all_gather"] > 0,
              f"phase 6m{label}: collectives captured {dict(counted)}")
    check_sharded_rounds(torch, got, virtual, "phase 6m", exact_floats=True)
    check_async_rounds(torch, agot, avirtual, "phase 6m async",
                       exact_floats=True)
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6m",
                         2 * rounds)
    row = {"run_s": secs, "capture_s": graphs.capture_s.get("round", 0.0),
           "launches": launches, "captured_collectives": dict(sync_captured),
           "async_run_s": asecs,
           "async_capture_s": agraphs.capture_s.get("agg", 0.0),
           "async_launches": alaunches,
           "async_captured_collectives": dict(captured),
           "card": card_name_power()}
    log(f"phase 6m: run_rounds_sharded and run_async_sharded N={n} over an "
        f"NCCL process group of world size 1 on {row['card']}: "
        f"{dict(sync_captured)} and {dict(captured)} collective calls "
        f"captured in the round's and the aggregation's CUDA graphs, the "
        f"trajectories, batteries, event and selector states bitwise "
        f"equal to the virtual one-shard mesh's; kernel launches "
        f"{launches} and {alaunches}, each == plain; {secs:.4f} s with "
        f"warm-up and capture {row['capture_s']:.4f} s, and {asecs:.4f} s "
        f"with {row['async_capture_s']:.4f} s")
    return row, err


# ------------------------------- the sharded async engines (6n, 6o, 6p)
ASYNC_SHARD_EXACT = ("completed", "comp_chosen", "succeeded", "staleness",
                     "selected", "chosen", "fill_selected", "fill_chosen",
                     "total_dropped", "n_inflight", "round_duration",
                     "server_clock", "agg_weight")
ASYNC_SUMMED = ("mean_battery", "energy_spent_pct", "energy_spent_j")


def check_async_rounds(torch, got, base, label, exact_floats=False):
    """A ``run_async_sharded`` result against a ``run_async_scanned`` one
    on the same key: the flush, refill and count columns, the wall clock,
    the damping weights, dropouts, the event state's clocks and versions
    and the selector state equal; the summed statistics, batteries and
    spent joules within rtol 1e-6 (equal too with ``exact_floats``)."""
    (p, st, t), (bp, bst, bt) = got, base
    for f in ASYNC_SHARD_EXACT + (ASYNC_SUMMED if exact_floats else ()):
        check(np.array_equal(t[f], bt[f]), f"{label}: {f} differs")
    for f in ASYNC_SUMMED:
        np.testing.assert_allclose(t[f], bt[f], rtol=1e-6,
                                   err_msg=f"{label}: {f}")
    np.testing.assert_allclose(p.battery_pct.cpu().numpy(),
                               bp.battery_pct.cpu().numpy(), rtol=1e-6,
                               err_msg=f"{label}: batteries")
    check(torch.equal(p.dropped, bp.dropped), f"{label}: dropouts differ")
    e, be = t["final_event_state"], bt["final_event_state"]
    for f in ("t_done", "start_version", "server_clock", "server_version",
              "exhausted_round") + (("spent_j",) if exact_floats else ()):
        check(torch.equal(getattr(e, f), getattr(be, f)),
              f"{label}: event state {f} differs")
    np.testing.assert_allclose(float(e.spent_j), float(be.spent_j),
                               rtol=1e-6, err_msg=f"{label}: spent_j")
    for f in ("round", "epsilon", "pacer_T", "util_ema"):
        check(float(getattr(st, f)) == float(getattr(bst, f)),
              f"{label}: state.{f} differs")


def async_ties_step(torch, dev, n, cfg, em, kw, counts, key):
    """One eager aggregation in which every arrival ties: 40 clients in
    flight, 5 at the head of each eighth of the population, all due at
    the same offset, each with its own start version. On one device and
    on each mesh the flush must complete the 25 lowest indices (the merge
    keeps lax.top_k's order across shards) with the staleness of each
    one's own start version (gathered from its owner)."""
    from repro_torch.core.selection import SelectorState
    from repro_torch.federated.simulation import (AsyncEventState,
                                                  _astate_put,
                                                  make_async_round_engine)
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.launch.sharding import population_sharding

    pop = async_fleet(torch, dev, n)
    flying = (torch.arange(8, device=dev)[:, None] * (n // 8)
              + torch.arange(5, device=dev)).reshape(-1)
    a = AsyncEventState.create(n, dev)
    version = (torch.arange(40, device=dev) % 5 + 1).to(torch.int32)
    a = a._replace(t_done=a.t_done.index_fill(0, flying, 120.0),
                   start_version=a.start_version.index_copy(0, flying,
                                                            version),
                   server_version=torch.full((), 6, dtype=torch.int32,
                                             device=dev))
    want = flying[:ASYNC_BUFFER]
    want_stale = 6 - version[:ASYNC_BUFFER]
    st = SelectorState.create(cfg).canonical(dev)
    go = torch.ones((), dtype=torch.bool, device=dev)
    for d in (None,) + tuple(counts):
        if d is None:
            step = make_async_round_engine(cfg, em, 3.0e6, 10, 20, **kw)[1]
            flush = step(key, pop, st, a, go)[3]
        else:
            mesh = make_client_mesh(d)
            step = make_async_round_engine(cfg, em, 3.0e6, 10, 20, **kw,
                                           mesh=mesh, n_real=n)[1]
            flush = step(key, population_sharding(mesh)(pop), st,
                         _astate_put(a, mesh), go)[3]
        label = "one device" if d is None else f"D={d}"
        check(torch.equal(flush["completed"].long(), want),
              f"phase 6n ties {label}: completed "
              f"{flush['completed'][:8].tolist()}..., expected "
              f"{want[:8].tolist()}...")
        check(torch.equal(flush["staleness"], want_stale),
              f"phase 6n ties {label}: staleness "
              f"{flush['staleness'].tolist()}, expected "
              f"{want_stale.tolist()}")


def phase_async_sharded_selection(torch, ops, ref, dev, n, rounds,
                                  counts=(1, 2, 8)):
    """6n: ``run_async_sharded`` at fleet scale (phase 6e's population,
    arrivals tie) on virtual ``clients`` meshes of ``counts`` shards, one
    card, each aggregation one CUDA-graph replay, against
    ``run_async_scanned`` with the same key. The fill launches the top-k
    kernel once a shard at k = 100 and each replay once a shard at k =
    25, each with its shard's ``index_offset``; every launch is held
    against the plain version and each replayed one against an eager
    launch. The count is set to 0 just before each mesh's run and read
    just after. Each aggregation step is timed alone, in turns (single
    device, the meshes, the single device again), set-up (padding,
    layout, the fill, the fetch) and capture apart, and one aggregation
    of the single device and of the largest mesh is profiled. Then one
    aggregation in which every arrival ties (:func:`async_ties_step`)."""
    from repro_torch import prng
    from repro_torch.core.energy import EnergyModel
    from repro_torch.core.selection import SelectorConfig, SelectorState
    from repro_torch.federated import replay
    from repro_torch.federated.simulation import (run_async_scanned,
                                                  run_async_sharded)
    from repro_torch.launch.mesh import make_client_mesh

    pop = async_fleet(torch, dev, n)
    em = EnergyModel(busy_fraction=0.02)
    cfg = SelectorConfig("eafl", k=100)
    kw = dict(buffer_size=ASYNC_BUFFER, max_concurrency=ASYNC_CONCURRENCY,
              staleness_power=ASYNC_POWER)
    args = (prng.PRNGKey(29, dev), cfg, pop, SelectorState.create(cfg), em,
            3.0e6, 10, 20, rounds)
    rows = {}

    def timed(fn, **mkw):
        """The run with each aggregation step timed alone: the first holds
        the warm-up and the capture, the others are replays; the rest of
        the run (padding, layout, the fill, key split, fetch) is its
        set-up."""
        times = []
        with replay_timing(torch, replay, times, "agg"):
            out, secs, graphs = timed_engine(torch, replay, fn, *args,
                                             **kw, **mkw)
        return out, graphs, {
            "run_s": secs, "setup_s": secs - sum(times),
            "first_step_s": times[0],
            "capture_s": graphs.capture_s.get("agg", 0.0),
            "replay_s": times[1:]}

    base, _, rows["scanned"] = timed(run_async_scanned)
    launches = {}
    with graph_recording(torch, ops, replay) as (calls, replayed):
        for d in counts:
            mesh = make_client_mesh(d)
            ops.LAUNCHES["topk_reward"] = 0
            got, graphs, rows[f"D={d}"] = timed(run_async_sharded, mesh=mesh)
            launches[d] = ops.LAUNCHES["topk_reward"]
            # one launch a shard in the fill, the warm-up and each replay
            check(launches[d] == d * (2 + rounds), f"phase 6n D={d}: the "
                  f"kernel launched {launches[d]} times")
            held = graphs.launches.get("agg")
            check(held == {"topk_reward": d},
                  f"phase 6n D={d}: the aggregation graph holds {held}")
            check_async_rounds(torch, got, base, f"phase 6n D={d}")
        fills = [kw_["k"] for _, kw_, _ in calls
                 if kw_["k"] == ASYNC_CONCURRENCY]
        check(len(fills) == sum(counts), f"phase 6n: {len(fills)} fill "
              f"launches at k = {ASYNC_CONCURRENCY}, {sum(counts)} expected")
        check(all(kw_["k"] == ASYNC_BUFFER for _, kw_, _ in replayed),
              "phase 6n: a replayed launch not at the buffer's k")
        async_ties_step(torch, dev, n, cfg, em, kw, counts,
                        prng.PRNGKey(37, dev))
    _, _, rows["scanned, again"] = timed(run_async_scanned)
    # one profiled aggregation (the second) of the single device and of
    # the largest mesh: the device operations that set their times
    for name, fn, mkw in (("scanned", run_async_scanned, {}),
                          (f"D={counts[-1]}", run_async_sharded,
                           {"mesh": make_client_mesh(counts[-1])})):
        with tempfile.TemporaryDirectory() as tmp:
            rows[name]["profile"] = trace_round(
                torch, lambda: fn(*args, **kw, **mkw),
                fused_steps(torch, replay, "agg"), Path(tmp),
                f"async_selection_{name}")
    err = check_replayed(torch, ops, ref, calls, replayed, "phase 6n",
                         sum(d * rounds for d in counts))
    offsets = sorted({kw_.get("index_offset", 0)
                      for _, kw_, _ in calls + replayed})
    want = sorted({s * (n // d) for d in counts for s in range(d)})
    check(offsets == want, f"phase 6n: index offsets {offsets}, {want} "
          f"expected")
    out = {"rows": rows, "launches": launches, "card": card_name_power()}
    log(f"phase 6n: run_async_sharded N={n} eafl k=100 buffer "
        f"{ASYNC_BUFFER} concurrency {ASYNC_CONCURRENCY} x{rounds} "
        f"aggregations on virtual meshes of {list(counts)} shards on "
        f"{out['card']}, each aggregation one CUDA-graph replay: the flush, "
        f"refill, staleness, damping, clock and in-flight columns, the "
        f"event state and the selector state equal to run_async_scanned's, "
        f"batteries and summed statistics within rtol 1e-6; the all-ties "
        f"aggregation completes the lowest indices on every mesh; kernel "
        f"launches {launches} (one a shard in the fill, the warm-up and "
        f"each replay, index offsets {offsets}), each == plain and each "
        f"replayed one == an eager launch; seconds (the run, its set-up, "
        f"the first step with warm-up and capture, the capture alone, "
        f"each replayed aggregation alone): {rows}")
    return out, err


def phase_async_sharded_training(torch, ops, ref, dev, cfg, counts=(1, 4)):
    """6o: ``run_fl(mode="async", engine="sharded")`` (one shard) and
    ``run_fl_async_sharded`` on a 4-shard virtual mesh at phase 6g's
    settings, against ``run_fl_async_scanned`` on the card, cuDNN's
    deterministic algorithms: the flush, refill and version columns equal
    aggregation for aggregation, the history at tests/test_torch_
    training_engines.py's tolerances (one shard bitwise). Each
    aggregation replay is timed alone beside the fused engine's, in turns
    (fused, 1 shard, 4 shards, fused), warm-up and capture apart, with
    each run's peak device memory; one aggregation of the 4-shard engine
    is profiled (idle share). A ``train-async`` snapshot of the fused
    engine after aggregation 2 resumes in the 4-shard engine."""
    from repro_torch.federated import replay
    from repro_torch.federated.async_server import (run_fl_async_scanned,
                                                    run_fl_async_sharded)
    from repro_torch.federated.server import run_fl
    from repro_torch.launch.mesh import make_client_mesh

    cols = ASYNC_TRACE + ("agg_weight", "server_version", "n_inflight",
                          "round_duration", "server_clock")
    rows, launches, out = {}, {}, {}

    def timed(fn, *a, **kw):
        times = []
        torch.cuda.reset_peak_memory_stats()
        with replay_timing(torch, replay, times):
            hist, secs, graphs = timed_engine(torch, replay, fn, *a, **kw)
        return hist, graphs, {
            "run_s": secs, "capture_s": graphs.capture_s,
            "first_step_s": times[0], "replay_s": times[1:],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "async-{round}.ckpt")
            base, graphs, rows["scanned"] = timed(
                run_fl_async_scanned, dataclasses.replace(
                    cfg, checkpoint_path=path, checkpoint_every=2),
                device=dev)
            base_cols = {f: graphs.traj[f].cpu().numpy() for f in cols}
            # each run's peak memory is its own: the last engine freed
            del graphs
            for d in counts:
                with graph_recording(torch, ops, replay) as (calls,
                                                             replayed):
                    ops.LAUNCHES["topk_reward"] = 0
                    if d == 1:
                        hist, graphs, row = timed(
                            run_fl, cfg, mode="async", engine="sharded",
                            device=dev)
                    else:
                        hist, graphs, row = timed(
                            run_fl_async_sharded, cfg,
                            mesh=make_client_mesh(d), device=dev)
                    launches[d] = ops.LAUNCHES["topk_reward"]
                check(launches[d] == d * (2 + cfg.rounds),
                      f"phase 6o D={d}: the kernel launched {launches[d]} "
                      f"times")
                out[f"max_abs_err_D={d}"] = check_replayed(
                    torch, ops, ref, calls, replayed, f"phase 6o D={d}",
                    d * cfg.rounds)
                for f in cols:
                    check(np.array_equal(graphs.traj[f].cpu().numpy(),
                                         base_cols[f]),
                          f"phase 6o D={d}: {f} differs from the fused "
                          f"engine's")
                if d == 1:
                    check(same_history(base, hist), "phase 6o D=1: the "
                          "history differs from the fused engine's")
                check_engines_agree(base, hist, f"phase 6o D={d}",
                                    cfg.eval_samples)
                rows[f"D={d}"] = dict(row, train_loss=hist.train_loss,
                                      test_acc=hist.test_acc)
                del graphs, calls, replayed
            resumed = run_fl_async_sharded(dataclasses.replace(
                cfg, resume_from=path.format(round=2)), n_shards=counts[-1],
                device=dev)
            check_engines_agree(base, resumed, f"phase 6o: the fused "
                                f"engine's snapshot resumed on "
                                f"{counts[-1]} shards", cfg.eval_samples)
            again, _, rows["scanned, again"] = timed(run_fl_async_scanned,
                                                     cfg, device=dev)
            check(same_history(base, again), "phase 6o: the fused engine "
                  "did not repeat itself")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    d = counts[-1]
    with tempfile.TemporaryDirectory() as tmp:
        rows[f"D={d}"]["profile"] = trace_round(
            torch, lambda: run_fl_async_sharded(cfg, n_shards=d, device=dev),
            fused_steps(torch, replay), Path(tmp), f"async_sharded{d}")
    out.update({"rows": rows, "launches": launches,
                "card": card_name_power()})
    log(f"phase 6o: run_fl async sharded (D in {list(counts)}) against "
        f"run_fl_async_scanned, {cfg.n_clients} clients, k="
        f"{cfg.selector.k}, buffer {cfg.buffer_size}, concurrency "
        f"{cfg.max_concurrency}, {cfg.rounds} aggregations, full width, on "
        f"{out['card']}: flush, refill and version columns equal, D=1 "
        f"bitwise, the history within the tests' tolerances; the fused "
        f"engine's snapshot after aggregation 2 resumed on {d} shards "
        f"within them; kernel launches {launches}; seconds (run, warm-up + "
        f"capture, each replayed aggregation alone), peak memory and the "
        f"{d}-shard aggregation's profile: {rows}")
    return out, max(v for k, v in out.items() if k.startswith("max_abs"))


def phase_elastic(torch, ops, ref, dev, shards=2):
    """6p: ``python -m repro_torch.launch.elastic_check --devices 2``'s
    round-engine matrix in this process, on the card: resume parity of
    the sync and async engines, single-device and on a 2-shard virtual
    mesh, the faults leg and the corruption smoke. Every top-k launch it
    makes, eager or replayed, is held against the plain version."""
    from repro_torch.federated import replay
    from repro_torch.launch import elastic_check
    from repro_torch.launch.mesh import make_client_mesh

    with tempfile.TemporaryDirectory() as tmp, \
            graph_recording(torch, ops, replay) as (calls, replayed):
        t0 = time.perf_counter()
        elastic_check.check_engines(make_client_mesh(shards), dev, tmp)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    err = check_recorded(torch, ref, calls + replayed, "phase 6p")
    row = {"run_s": secs, "launches_checked": len(calls) + len(replayed),
           "card": card_name_power()}
    log(f"phase 6p: elastic_check's round-engine matrix on {shards} "
        f"shards on {row['card']}: every engine resumed bitwise, the "
        f"corrupt snapshots refused; {row['launches_checked']} top-k "
        f"launches, each == plain; {secs:.2f} s")
    return row, err


# ------------------------------------------------- LM kernels (phases 7-11)
BF16_FLOP_PER_S = 989e12           # H100 SXM data sheet, dense tensor cores
ATTN_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
ATTN_REPLACES = "src/repro/kernels/flash_attention.py:26"
SSD_SOURCE = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
SSD_REPLACES = "src/repro/kernels/ssd_chunk.py:27"
# kernel vs plain: the JAX package's own tolerances (tests/test_kernels.py),
# TF32 off; atol and rtol alike
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 1e-1}
# The tight check of the bf16 (tensor-core) attention kernel: its output's
# relative L2 distance from the f32 attention of the same bf16 inputs. The
# elementwise 2e-2 above is loose against outputs of ~0.03 at S=4096; this
# one scales with the output. On an H100 the sound kernel reads 1.7e-3 to
# 2.3e-3 (P and the output rounded to bf16 once each); planted faults
# (chip_faults.py) read from 3.2e-3 (accumulator kept in bf16, at the
# prefill shape) to 0.73, or NaN (the diagonal masked: row 0 then has no
# key).
ATTN_BF16_REL_L2 = 3e-3
# Full-width zamba2 logits (magnitude ~5). In f32 (TF32 off) the kernel
# route and the plain route agree to 2e-2 abs, the reference's own
# tolerance for decode vs forward (tests/test_decode_consistency.py). In
# bf16 a 38-layer random-weight model amplifies rounding: bf16 logits lie
# at a relative L2 distance of about 0.34 from f32, and two bf16 routes
# about 0.24 from each other. The two bf16 limits below are sanity checks
# of the whole path only: of five faults planted in the attention kernel
# (chip_faults.py) they caught one. The tight check above holds the kernel.
F32_LOGIT_ATOL = 2e-2
BF16_ROUTE_RATIO = 1.25
BF16_REPLAY_REL_L2 = 0.6
# falcon-mamba-7b's 64 random-weight layers amplify bf16 rounding further:
# on an H100 its bf16 logits lie 0.744 (kernel route) and 0.758 (plain)
# from f32, two bf16 routes 0.538 apart, and the replay read 0.648. So its
# replay limit only says the forward has not lost the logits (unrelated
# logits of equal norm read 1.41); the f32 replay check holds its decode.
MAMBA1_BF16_REPLAY_REL_L2 = 1.0
PREFILL_BATCH, PREFILL_LEN = 2, 4096   # cut of prefill_32k (32 x 32,768)
# The tight checks of the bf16 scan kernels, as for attention: the
# output's relative L2 distance from the f32 scan (the sequential
# recurrence) of the same bf16 inputs; the elementwise tolerances are loose
# against outputs of up to several tens. On an H100 the sound kernels read
# 1.650e-3 to 1.662e-3 (SSD) and 1.657e-3 to 1.780e-3 (selective scan, the
# largest on 2 x 7 x 96 outputs): y rounded to bf16 once. The limits are
# 1.24x the largest scan reading (1.32x the SSD's). Every planted fault
# (chip_faults.py) reads above them on some input: the closest, the scan
# state rounded to bf16, 3.16e-3 at the prefill shape (2.09e-3 on the
# prefill's call); the farthest 2.91.
SSD_BF16_REL_L2 = 2.2e-3
SCAN_BF16_REL_L2 = 2.2e-3
# With slow decay the carried state decides the SSD output, and a lost low
# half of a split operand shows there alone: dropped, the low part of h or
# of w x reads 2.051e-3 at the prefill shape (chip_probes.py), under the
# limit above, while the sound kernel reads at most 1.662e-3. The
# slow-decay cases hold this limit of their own.
SSD_BF16_REL_L2_SLOW = 1.85e-3
# dt about 0.02, as trained Mamba models set it: the state then outlives a
# 64-step chunk or a 32-step tile. At dt about 0.7 it decays within one,
# and an SSD kernel that dropped the carried state read 2.46e-3.
SLOW_DT_SHIFT = -4.0


def ssd_limit(dt_shift):
    """The SSD tight check's limit for inputs of ``dt_shift``."""
    return SSD_BF16_REL_L2_SLOW if dt_shift == SLOW_DT_SHIFT else \
        SSD_BF16_REL_L2

# ------------------------------------------ Mamba1 kernel (phases 12-16)
SCAN_SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
SCAN_REPLACES = "src/repro/kernels/selective_scan.py:26"
# kernel vs plain: the JAX package's own tolerances (tests/test_kernels.py)
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SCAN_LAUNCHES = 64                 # one per falcon-mamba-7b layer
ROUTE_LEN = 256                    # tokens a row of the route comparison
# special-function unit results per clock per SM (exp2 among them), CUDA
# C++ Programming Guide, arithmetic throughput, compute capability 9.0
SFU_PER_CLOCK_PER_SM = 16
# float32 operations per (state, step) around each exponential: dt * A,
# dx * B, the state's multiply-add and C . h's multiply-add
SCAN_FLOPS_PER_EXP = 6
# B, S, di, ds, dt shift: the serve prompt's and the prefill's shapes,
# S = 1, ragged S (7) and di (96, not a multiple of the kernel's 64
# channels), ds 8 and 16 (the reduced and the full config), the
# prefill's shape with slow decay (dt about 0.02), and full width with a
# ragged last tile (4095)
SCAN_SHAPES = [(1, 1, 8192, 16, 0.0), (2, 7, 96, 16, 0.0),
               (4, 32, 8192, 16, 0.0), (1, 64, 512, 8, 0.0),
               (2, 64, 96, 8, 0.0), (1, 4096, 96, 16, 0.0),
               (2, 4096, 512, 8, 0.0), (2, 4096, 8192, 16, 0.0),
               (2, 4096, 8192, 16, SLOW_DT_SHIFT),
               (2, 4095, 8192, 16, 0.0)]


def dtype_name(dt):
    return str(dt).replace("torch.", "")


def close(torch, got, exp, tol, what):
    """``|got - exp| <= tol + tol * |exp|`` elementwise (float32); returns
    the max abs difference."""
    got, exp = got.float(), exp.float()
    check(bool(torch.isfinite(got).all()), f"non-finite kernel output: {what}")
    err = (got - exp).abs()
    bad = err > tol + tol * exp.abs()
    check(not bool(bad.any()),
          f"kernel != plain beyond {tol}: {what} (max abs {float(err.max())})")
    return float(err.max())


def attn_rel_l2(torch, ref, out, q, k, v, causal):
    """Relative L2 distance of ``out`` from the f32 plain attention of the
    same inputs (TF32 off)."""
    return rel_l2(torch, out, ref.flash_attention(q.float(), k.float(),
                                                  v.float(), causal=causal))


def tight(torch, ref, out, q, k, v, causal, what):
    """The tight check of a bf16 attention output; returns its reading."""
    return held({"attention": attn_rel_l2(torch, ref, out, q, k, v, causal)},
                ATTN_BF16_REL_L2, what)


def rel_l2(torch, out, exact):
    """Relative L2 distance of ``out`` from ``exact`` (float32)."""
    return float((out.float() - exact).norm() / exact.norm())


def ssd_rel_l2(torch, ref, out, x, Bm, Cm, dt, A):
    """The SSD output's distance from the f32 scan of the same inputs."""
    return rel_l2(torch, out, ref.ssd_chunk(x.float(), Bm.float(),
                                            Cm.float(), dt, A))


def scan_rel_l2(torch, ref, out, x, dt, Bm, Cm, A, D):
    """The selective-scan output's distance from the f32 scan of the same
    inputs (the plain version before its final cast)."""
    return rel_l2(torch, out, ref.selective_scan(
        x.float(), dt.float(), Bm.float(), Cm.float(), A, D))


def held(readings, limit, what):
    """Fails unless every tight-check reading lies within ``limit`` (a NaN
    fails); returns the largest."""
    check(all(v <= limit for v in readings.values()),
          f"{what}: bf16 output vs the f32 computation of its inputs, "
          f"relative L2 {readings}, limit {limit}")
    return max(readings.values())


def attn_inputs(torch, B, S, H, KH, D, dtype, dev, seed, pad=0, dv=None):
    """q, k of width ``D`` and v of width ``dv`` (default ``D``). ``pad`` >
    0: rows start ``pad`` elements into a wider buffer, so they are not
    16-byte aligned."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(B, S, h, w + pad, generator=g).to(dtype).to(dev)
            [..., pad:] for h, w in ((H, D), (KH, D), (KH, dv or D))]


def ssd_inputs(torch, B, S, nh, hd, ds, dtype, dev, seed, dt_shift=0.0):
    """Bm and Cm are slices of one packed tensor, as in the model. dt is
    softplus(N(dt_shift, 1)): about 0.7 at 0, about 0.02 at
    ``SLOW_DT_SHIFT``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, S, nh, hd, generator=g).to(dtype).to(dev)
    bc = torch.randn(B, S, 2 * ds, generator=g).to(dtype).to(dev)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, nh, generator=g) + dt_shift).to(dev)
    A = -torch.exp(torch.randn(nh, generator=g)).to(dev)
    return [x, bc[..., :ds], bc[..., ds:], dt, A]


def scan_inputs(torch, B, S, di, ds, dtype, dev, seed, dt_shift=0.0):
    """Bm and Cm are slices of one packed tensor after 3 other columns, as
    in the model (there after the dt_rank columns). dt as in
    :func:`ssd_inputs`."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, S, di, generator=g).to(dtype).to(dev)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, di, generator=g) + dt_shift).to(dtype).to(dev)
    packed = torch.randn(B, S, 3 + 2 * ds, generator=g).to(dtype).to(dev)
    A = -torch.exp(torch.randn(di, ds, generator=g)).to(dev)
    D = torch.randn(di, generator=g).to(dev)
    return [x, dt, packed[..., 3:3 + ds], packed[..., 3 + ds:], A, D]


# B, S, H, KH, hd, pad (4: unaligned rows; the kernel rejects them in bf16)
ATTN_SHAPES = [(1, 32, 32, 32, 64, 0), (2, 4096, 32, 32, 64, 0),
               (1, 1000, 4, 4, 128, 0), (2, 256, 8, 2, 64, 0),
               (2, 256, 8, 2, 64, 4)]
# B, S, nh, hd, ds, dt shift: the last, full width with a ragged last
# chunk (4000 = 62 x 64 + 32)
SSD_SHAPES = [(1, 32, 64, 64, 64, 0.0), (2, 64, 64, 64, 64, 0.0),
              (1, 128, 64, 64, 64, 0.0), (2, 4096, 64, 64, 64, 0.0),
              (2, 4096, 64, 64, 64, SLOW_DT_SHIFT),
              (2, 4000, 64, 64, 64, 0.0)]


def phase_attn_vs_plain(torch, ops, ref, dev):
    errs, shapes, rel = {}, [], {}
    for i, (B, S, H, KH, D, pad) in enumerate(ATTN_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = attn_inputs(torch, B, S, H, KH, D, dt, dev, i, pad)
            name = dtype_name(dt)
            if pad and dt == torch.bfloat16:
                try:
                    ops.flash_attention(q, k, v)
                except ValueError:
                    continue
                raise SmokeFailure("unaligned bf16 rows were not rejected")
            for causal in (True, False):
                what = f"attention B={B} S={S} H={H} KH={KH} hd={D} pad=" \
                       f"{pad} {name} causal={causal}"
                out = ops.flash_attention(q, k, v, causal=causal)
                err = close(torch, out,
                            ref.flash_attention(q, k, v, causal=causal),
                            ATTN_TOL[name], what)
                errs[name] = max(errs.get(name, 0.0), err)
                if dt == torch.bfloat16:
                    rel[f"{B}x{S}x{H}x{KH}x{D} causal={causal}"] = tight(
                        torch, ref, out, q, k, v, causal, what)
                shapes.append([B, S, H, KH, D, pad, name, causal])
                del out
            del q, k, v
    torch.cuda.synchronize()
    log(f"phase 7: flash_attention kernel == plain on {len(shapes)} cases "
        f"(B,S,H,KH,hd,pad) in {ATTN_SHAPES}, bf16 (tensor cores; pad=4 "
        f"rejected) and f32, causal and not: max abs err {errs} (tol "
        f"{ATTN_TOL}, TF32 off); bf16 vs the f32 attention of its inputs, "
        f"relative L2 {rel} (limit {ATTN_BF16_REL_L2})")
    return errs, shapes, max(rel.values())


def phase_ssd_vs_plain(torch, ops, ref, dev):
    errs, shapes, rel, limits = {}, [], {}, {}
    for i, (B, S, nh, hd, ds, shift) in enumerate(SSD_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            args = ssd_inputs(torch, B, S, nh, hd, ds, dt, dev, 100 + i,
                              shift)
            name = dtype_name(dt)
            what = f"ssd B={B} S={S} nh={nh} hd={hd} ds={ds} dt shift " \
                   f"{shift} {name}"
            out = ops.ssd_chunk(*args)
            err = close(torch, out, ref.ssd_chunk(*args), SSD_TOL[name], what)
            errs[name] = max(errs.get(name, 0.0), err)
            if dt == torch.bfloat16:
                case = f"{B}x{S}x{nh}x{hd}x{ds} shift {shift}"
                rel[case] = ssd_rel_l2(torch, ref, out, *args)
                limits[case] = ssd_limit(shift)
            shapes.append([B, S, nh, hd, ds, shift, name])
    torch.cuda.synchronize()
    for case, limit in limits.items():
        held({case: rel[case]}, limit, "phase 8: ssd_chunk")
    top = max(rel.values())
    log(f"phase 8: ssd_chunk kernel == plain (sequential recurrence) on "
        f"{len(shapes)} cases (B,S,nh,hd,ds,dt shift) in {SSD_SHAPES}, bf16 "
        f"and f32, "
        f"B and C strided: max abs err {errs} (tol {SSD_TOL}); bf16 vs the "
        f"f32 scan of its inputs, relative L2 {rel} (limit "
        f"{SSD_BF16_REL_L2}, {SSD_BF16_REL_L2_SLOW} with slow decay)")
    return errs, shapes, top


@contextlib.contextmanager
def first_calls(ops, names):
    """Keep a copy of the inputs (and the output, or each output of a
    tuple) of the first call of each wrapper in ``names`` while the block
    runs; the launch counters stay the wrappers' own."""
    seen = {}
    saved = {n: getattr(ops, n) for n in names}

    def spy(name):
        wrapper = saved[name]

        def call(*args, **kw):
            out = wrapper(*args, **kw)
            if name not in seen:
                seen[name] = (tuple(clone_strided(a) for a in args),
                              dict(kw), tuple(t.clone() for t in out)
                              if isinstance(out, tuple) else out.clone())
            return out
        return call

    for n in names:
        setattr(ops, n, spy(n))
    try:
        yield seen
    finally:
        for n, w in saved.items():
            setattr(ops, n, w)


def logit_diff(torch, got, exp, what, rows=256):
    """Relative L2 distance, max abs difference and argmax agreement of
    two logit tensors (float32), ``rows`` positions at a time (at a
    vocabulary of 202,048 one f32 copy of 2 x 4096 logits is 6.6 GB);
    fails on a non-finite value."""
    g2 = got.reshape(-1, got.shape[-1])
    e2 = exp.reshape(-1, exp.shape[-1])
    num = den = mx = 0.0
    agree = 0
    for i in range(0, g2.shape[0], rows):
        g, e = g2[i:i + rows].float(), e2[i:i + rows].float()
        check(bool(torch.isfinite(g).all()), f"non-finite logits: {what}")
        d = g - e
        num += float(d.square().sum())
        den += float(e.square().sum())
        mx = max(mx, float(d.abs().max()))
        agree += int((g.argmax(-1) == e.argmax(-1)).sum())
    return {"rel_l2": math.sqrt(num / den), "max_abs": mx,
            "argmax_agree": agree / g2.shape[0]}


def codebooks(cfg):
    """The trailing token shape of ``cfg``: ``(n_codebooks,)`` for the
    multi-codebook heads, else ``()``."""
    return (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()


def lm_inputs(torch, cfg, g, rows, length):
    """A batch of ``rows`` x ``length`` positions for ``cfg`` on the host,
    drawn from the CPU generator ``g``: tokens (rows, length), or (rows,
    length, ncb) with codebooks; with the vision frontend the first
    ``cfg.n_patches`` positions are ``vision_embeds`` (0.02 N(0, 1), as
    ``lm_batch`` draws them) and the other ``length - n_patches`` text
    tokens. For the other archs the draw is ``randint`` alone, as
    before."""
    text = length - cfg.n_patches
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (rows, text) + codebooks(cfg),
                                     generator=g)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = 0.02 * torch.randn(
            (rows, cfg.n_patches, cfg.d_model), generator=g)
    return batch


def text_only(cfg, tokens):
    """A forward's batch of ``tokens`` alone: with the vision frontend an
    empty patch block, as the serving path (text tokens, no patches in the
    cache) sees it."""
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = tokens.new_zeros(
            (tokens.shape[0], 0, cfg.d_model), dtype=cfg.compute_dtype)
    return batch


ZAMBA_PREFILL_LAUNCHES = {"flash_attention": 6, "ssd_chunk": 38}


def phase_prefill(torch, ops, ref, dev, cfg, params, seed,
                  expect=ZAMBA_PREFILL_LAUNCHES, phase=9):
    """The main path of the LM kernels: ``make_prefill_step(CONFIG)`` on
    2 x 4096 tokens. One warm-up forward, then the counted one (counters
    set to 0 just before, read just after: it must launch each kernel of
    ``expect`` as often as it says), then the plain route on the card for
    comparison. The first call of each kernel is held against its plain
    version and by its tight check."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import forward_logits

    g = torch.Generator(device="cpu").manual_seed(seed)
    batch = to_device(lm_inputs(torch, cfg, g, PREFILL_BATCH, PREFILL_LEN),
                      dev)
    step = make_prefill_step(cfg, device=dev)
    step(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with first_calls(ops, tuple(expect)) as seen:
        for name in expect:
            ops.LAUNCHES[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: ops.LAUNCHES[n] for n in expect}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == expect,
          f"one {cfg.name} prefill launched {launches}; expected {expect}")
    check(logits.shape == (PREFILL_BATCH, PREFILL_LEN) + codebooks(cfg)
          + (cfg.vocab_size,), f"logits shape {tuple(logits.shape)}")
    # the recorded first call of each kernel against its plain version
    errs = {}
    (q, k, v), kw, out = seen["flash_attention"]
    errs["flash_attention"] = close(torch, out, ref.flash_attention(
        q, k, v, **kw), ATTN_TOL[dtype_name(q.dtype)],
        "prefill's first attention call")
    check(q.dtype == torch.bfloat16, f"prefill attention in {q.dtype}")
    rel_l2 = tight(torch, ref, out, q, k, v, kw.get("causal", True),
                   "prefill's first attention call")
    first = {"attention": [list(q.shape), int(k.shape[2]),
                           int(v.shape[3])]}
    ssd_rel = None
    if "ssd_chunk" in seen:
        args, _, out = seen["ssd_chunk"]
        errs["ssd_chunk"] = close(torch, out, ref.ssd_chunk(*args),
                                  SSD_TOL[dtype_name(args[0].dtype)],
                                  "prefill's first SSD call")
        check(args[0].dtype == torch.bfloat16,
              f"prefill SSD in {args[0].dtype}")
        ssd_rel = held({"prefill_call": ssd_rel_l2(torch, ref, out, *args)},
                       SSD_BF16_REL_L2,
                       f"phase {phase}: the prefill's first SSD call")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = forward_logits(cfg, params, batch, device=dev, use_kernel=False)
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    cfg32 = cfg.with_(compute_dtype=torch.float32)
    exact = forward_logits(cfg32, params, batch, device=dev, use_kernel=False)
    kern32 = forward_logits(cfg32, params, batch, device=dev, use_kernel=True)
    agree = {"f32_kernel_vs_plain": logit_diff(torch, kern32, exact, "f32"),
             "bf16_kernel_vs_f32": logit_diff(torch, logits, exact, "bf16"),
             "bf16_plain_vs_f32": logit_diff(torch, plain, exact, "bf16"),
             "bf16_kernel_vs_plain": logit_diff(torch, logits, plain, "bf16")}
    del plain, exact, kern32
    check(agree["f32_kernel_vs_plain"]["max_abs"] <= F32_LOGIT_ATOL,
          f"f32 prefill, kernel vs plain route: {agree['f32_kernel_vs_plain']}"
          f" (limit {F32_LOGIT_ATOL} abs)")
    check(agree["bf16_kernel_vs_f32"]["rel_l2"] <= BF16_ROUTE_RATIO
          * agree["bf16_plain_vs_f32"]["rel_l2"],
          f"bf16 prefill: the kernel route lies further from f32 than "
          f"{BF16_ROUTE_RATIO} x the plain route: {agree}")
    tok_s = PREFILL_BATCH * PREFILL_LEN / secs
    log(f"phase {phase}: {cfg.name} full width ({cfg.param_count():,} "
        f"params, {cfg.n_layers} layers) prefill of {PREFILL_BATCH} x "
        f"{PREFILL_LEN} positions ({cfg.n_patches} of them patch "
        f"embeddings, token shape {codebooks(cfg)} a position; a cut of "
        f"prefill_32k's 32 x 32,768) on "
        f"{card_name_power()}: {secs:.4f} s ({tok_s:.0f} tokens/s), "
        f"launches {launches}, peak memory {peak:.2f} GiB; the plain route "
        f"on the card {plain_secs:.4f} s; logits {agree}; first recorded "
        f"calls (attention q, KV heads, v width {first['attention']}) == "
        f"plain, max abs err {errs}; vs the f32 computation of their "
        f"inputs, relative L2: attention {rel_l2} (limit "
        f"{ATTN_BF16_REL_L2}), SSD {ssd_rel} (limit {SSD_BF16_REL_L2})")
    return {"arch": cfg.name, "secs": secs, "plain_secs": plain_secs,
            "launches": launches, "peak_gib": peak, "agree": agree,
            "errs": errs, "attn_rel_l2": rel_l2, "ssd_rel_l2": ssd_rel,
            "first_call": first, "tokens_per_s": tok_s}, seen


def phase_serve(torch, ops, dev, cfg, params, seed, expect, phase,
                replay_limit, replay_cfg=None):
    """``launch/serve.py::generate`` at the reference's defaults (batch 4,
    prompt 32, gen 16) on the full config; the replay's last prompt logits
    against one kernel-route forward over the prompt (within
    ``replay_limit``, relative L2), which must launch the kernels
    ``expect`` times. Then the card's twin of
    tests/test_decode_consistency.py: in f32 with an f32 cache, every step
    of the replay against the kernel-route forward. ``replay_cfg`` (default
    ``cfg``) is the config of the forwards and of the f32 replay: for MoE
    ``cfg`` at a capacity factor at which the forward drops no token (a
    decode token never fills its 4 slots), as that test sets 16."""
    replay_cfg = replay_cfg or cfg
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import forward_logits, init_cache

    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (4, 32) + codebooks(cfg),
                           generator=g).to(dev)
    torch.cuda.reset_peak_memory_stats()
    out = generate(cfg, params, prompt, 16, device=dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    toks = out.tokens
    check(toks.shape == (4, 16) + codebooks(cfg),
          f"generated {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "generated tokens out of range")
    before = dict(ops.LAUNCHES)
    full = forward_logits(replay_cfg, params, text_only(replay_cfg, prompt),
                          device=dev)
    fwd_launches = {n: ops.LAUNCHES[n] - before[n] for n in expect}
    check(fwd_launches == expect,
          f"the prompt forward launched {fwd_launches}, expected {expect}")
    agree = {"bf16_replay_vs_forward": logit_diff(
        torch, out.prompt_logits, full[:, -1:], "replay")}
    cfg32 = replay_cfg.with_(compute_dtype=torch.float32)
    P = prompt.shape[1]
    cache = init_cache(cfg32, prompt.shape[0], P, torch.float32, device=dev)
    step = make_serve_step(cfg32, ring=False, device=dev)
    steps = []
    for t in range(P):
        logits, cache = step(params, {"tokens": prompt[:, t:t + 1]}, cache, t)
        steps.append(logits)
    full32 = forward_logits(cfg32, params, text_only(cfg32, prompt),
                            device=dev)
    agree["f32_replay_vs_forward"] = logit_diff(
        torch, torch.cat(steps, dim=1), full32, "f32 replay")
    check(agree["f32_replay_vs_forward"]["max_abs"] <= F32_LOGIT_ATOL,
          f"f32 replay vs forward, all {P} positions: {agree} (limit "
          f"{F32_LOGIT_ATOL} abs)")
    check(agree["bf16_replay_vs_forward"]["rel_l2"] <= replay_limit,
          f"bf16 replay vs forward at the last prompt position: {agree} "
          f"(limit {replay_limit} relative L2)")
    tok_s = toks.numel() / out.decode_s
    log(f"phase {phase}: serve generate on {cfg.name} full width, batch 4, "
        f"prompt 32, gen 16: replay {out.prefill_s:.4f} s, decode "
        f"{out.decode_s:.4f} s ({tok_s:.1f} tokens/s), peak memory "
        f"{peak:.2f} GiB; prompt forward launches {fwd_launches}; logits "
        f"{agree}; tokens[0] {toks[0].tolist()}")
    return {"replay_s": out.prefill_s, "decode_s": out.decode_s,
            "decode_tokens_per_s": tok_s, "peak_gib": peak, "agree": agree,
            "prompt_forward_launches": fwd_launches}


def attn_bound(q, k, v, causal=True):
    """Least time: q, k, v read and o written once at the HBM rate; the
    products over the pairs the mask keeps, 2 * (Dqk + Dv) FLOP a pair
    (q.k, then p v), at the peak rate of the dtype (bf16 tensor cores, else
    f32 without them)."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    nbytes = q.nbytes + k.nbytes + v.nbytes + q.nbytes // D * Dv
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2 * (D + Dv) * pairs * B * H
    rate = BF16_FLOP_PER_S if q.element_size() == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_bound(x, Bm, Cm, dt, A, chunk=64):
    """Least time: every input read and y written once at the HBM rate;
    the chunked form's four products a chunk (C B^T, att x, C h, B^T x) at
    the peak rate of the dtype."""
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    nbytes = 2 * x.nbytes + Bm.nbytes + Cm.nbytes + dt.nbytes + A.nbytes
    n_chunks = -(-S // chunk)
    flops = 2 * chunk * (chunk * ds + chunk * hd + 2 * ds * hd) \
        * n_chunks * B * nh
    rate = BF16_FLOP_PER_S if x.element_size() == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_lm_timing(torch, ops, ref, seen, l2_bytes):
    """Each LM kernel on the inputs the prefill gave it: kernel, plain
    version and (attention) one ``scaled_dot_product_attention`` call, in
    turns. The sequential SSD plain version takes about a second a call and
    is timed with 1 call a trial instead of 20."""
    F = torch.nn.functional
    rows = {}
    (q, k, v), kw, _ = seen["flash_attention"]
    sets, cold = copies((q, k, v), l2_bytes)
    bhsd = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    runs = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(2):
        runs["ms"].append(cuda_ms(
            torch, lambda *a: ops.flash_attention(*a, **kw), sets))
        runs["plain_ms"].append(cuda_ms(
            torch, lambda *a: ref.flash_attention(*a, **kw), sets, reps=5,
            trials=3))
        runs["library_ms"].append(cuda_ms(
            torch, lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=kw.get("causal", True)), bhsd))
    row = {key: statistics.median(val) for key, val in runs.items()}
    row["bound_ms"], row["bound_by"] = attn_bound(q, k, v,
                                                  kw.get("causal", True))
    row.update(shape=list(q.shape), kv_heads=int(k.shape[2]),
               dtype=dtype_name(q.dtype), l2_cold=cold)
    row["card"] = card_name_power()
    rows["flash_attention"] = row
    log(f"phase 11: flash_attention at the prefill shape {row['shape']} "
        f"{row['dtype']} causal on {row['card']}: kernel {row['ms']:.5f} "
        f"ms, plain "
        f"{row['plain_ms']:.5f} ms, scaled_dot_product_attention "
        f"{row['library_ms']:.5f} ms, bound {row['bound_ms']:.6f} ms "
        f"({row['bound_by']})")

    args, _, _ = seen["ssd_chunk"]
    sets, cold = copies(args, l2_bytes)
    runs = {"ms": [], "plain_ms": []}
    for _ in range(2):
        runs["ms"].append(cuda_ms(torch, ops.ssd_chunk, sets))
        runs["plain_ms"].append(cuda_ms(torch, ref.ssd_chunk, sets, reps=1,
                                        trials=3))
    row = {key: statistics.median(val) for key, val in runs.items()}
    row["library_ms"] = None   # no single PyTorch call computes the scan
    row["bound_ms"], row["bound_by"] = ssd_bound(*args)
    row.update(shape=list(args[0].shape), ds=int(args[1].shape[-1]),
               dtype=dtype_name(args[0].dtype), l2_cold=cold)
    row["card"] = card_name_power()
    rows["ssd_chunk"] = row
    log(f"phase 11: ssd_chunk on {row['card']} at the prefill shape "
        f"{row['shape']} ds="
        f"{row['ds']} {row['dtype']}: kernel {row['ms']:.5f} ms, plain "
        f"(sequential) {row['plain_ms']:.5f} ms, no single PyTorch call "
        f"computes it, bound {row['bound_ms']:.6f} ms ({row['bound_by']})")
    return rows


# --------------------------------------------- Mamba1 path (phases 12-16)
def phase_scan_vs_plain(torch, ops, ref, dev):
    errs, shapes, rel = {}, [], {}
    for i, (B, S, di, ds, shift) in enumerate(SCAN_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            args = scan_inputs(torch, B, S, di, ds, dt, dev, 200 + i, shift)
            name = dtype_name(dt)
            what = f"selective_scan B={B} S={S} di={di} ds={ds} dt shift " \
                   f"{shift} {name}"
            out = ops.selective_scan(*args)
            err = close(torch, out, ref.selective_scan(*args),
                        SCAN_TOL[name], what)
            errs[name] = max(errs.get(name, 0.0), err)
            if dt == torch.bfloat16:
                rel[f"{B}x{S}x{di}x{ds} shift {shift}"] = scan_rel_l2(
                    torch, ref, out, *args)
            shapes.append([B, S, di, ds, shift, name])
            del args, out
    torch.cuda.synchronize()
    top = held(rel, SCAN_BF16_REL_L2, "phase 12: selective_scan")
    log(f"phase 12: selective_scan kernel == plain (sequential recurrence) "
        f"on {len(shapes)} cases (B,S,di,ds,dt shift) in {SCAN_SHAPES}, bf16 "
        f"and f32, "
        f"B and C strided: max abs err {errs} (tol {SCAN_TOL}); bf16 vs the "
        f"f32 scan of its inputs, relative L2 {rel} (limit "
        f"{SCAN_BF16_REL_L2})")
    return errs, shapes, top


def phase_mamba1_prefill(torch, ops, ref, dev, cfg, params, tokens):
    """The main path of the scan kernel: ``make_prefill_step(CONFIG)`` on
    the tokens (2 x 4096). One warm-up forward, then the counted one
    (counter set to 0 just before, read just after)."""
    from repro_torch.launch.steps import make_prefill_step

    batch = {"tokens": tokens}
    step = make_prefill_step(cfg, device=dev)
    step(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with first_calls(ops, ("selective_scan",)) as seen:
        ops.LAUNCHES["selective_scan"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ops.LAUNCHES["selective_scan"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == SCAN_LAUNCHES,
          f"one {cfg.name} prefill launched the scan {launches} times, "
          f"expected {SCAN_LAUNCHES}")
    B, S = tokens.shape
    check(logits.shape == (B, S, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    del logits
    args, _, out = seen["selective_scan"]
    check(args[0].dtype == torch.bfloat16, f"prefill scan in {args[0].dtype}")
    err = close(torch, out, ref.selective_scan(*args), SCAN_TOL["bfloat16"],
                "prefill's first scan call")
    rel = held({"prefill_call": scan_rel_l2(torch, ref, out, *args)},
               SCAN_BF16_REL_L2, "phase 13: the prefill's first scan call")
    tok_s = B * S / secs
    log(f"phase 13: {cfg.name} full width ({cfg.param_count():,} params) "
        f"prefill of {B} x {S} tokens (a cut of prefill_32k's 32 x 32,768): "
        f"{secs:.4f} s ({tok_s:.0f} tokens/s), scan launches {launches}, "
        f"peak memory {peak:.2f} GiB; the first scan call == plain, max abs "
        f"err {err}, vs the f32 scan of its inputs relative L2 {rel} (limit "
        f"{SCAN_BF16_REL_L2})")
    return {"secs": secs, "launches": launches, "peak_gib": peak,
            "tokens_per_s": tok_s, "max_abs_err": err,
            "scan_rel_l2": rel}, seen


def phase_mamba1_routes(torch, ops, dev, cfg, params, tokens):
    """Kernel route against plain route at full width and depth: in f32
    (TF32 off) within ``F32_LOGIT_ATOL``; in bf16 the kernel route no
    further from the f32 logits than ``BF16_ROUTE_RATIO`` x the plain
    route (a sanity check)."""
    from repro_torch.models.transformer import forward_logits

    batch = {"tokens": tokens}
    cfg32 = cfg.with_(compute_dtype=torch.float32)
    secs, logits = {}, {}
    for name, c, use_kernel in (("f32_plain", cfg32, False),
                                ("f32_kernel", cfg32, True),
                                ("bf16_plain", cfg, False),
                                ("bf16_kernel", cfg, True)):
        before = ops.LAUNCHES["selective_scan"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits[name] = forward_logits(c, params, batch, device=dev,
                                      use_kernel=use_kernel)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        n = ops.LAUNCHES["selective_scan"] - before
        check(n == (SCAN_LAUNCHES if use_kernel else 0),
              f"{name} forward launched the scan {n} times")
    exact = logits["f32_plain"]
    agree = {"f32_kernel_vs_plain": logit_diff(torch, logits["f32_kernel"],
                                               exact, "f32"),
             "bf16_kernel_vs_f32": logit_diff(torch, logits["bf16_kernel"],
                                              exact, "bf16 kernel"),
             "bf16_plain_vs_f32": logit_diff(torch, logits["bf16_plain"],
                                             exact, "bf16 plain"),
             "bf16_kernel_vs_plain": logit_diff(
                 torch, logits["bf16_kernel"], logits["bf16_plain"], "bf16")}
    del logits, exact
    check(agree["f32_kernel_vs_plain"]["max_abs"] <= F32_LOGIT_ATOL,
          f"f32 {cfg.name}, kernel vs plain route: "
          f"{agree['f32_kernel_vs_plain']} (limit {F32_LOGIT_ATOL} abs)")
    ratio = agree["bf16_kernel_vs_f32"]["rel_l2"] \
        / agree["bf16_plain_vs_f32"]["rel_l2"]
    check(ratio <= BF16_ROUTE_RATIO,
          f"bf16 {cfg.name}: the kernel route lies {ratio} x as far from "
          f"f32 as the plain route (limit {BF16_ROUTE_RATIO}): {agree}")
    B, S = tokens.shape
    log(f"phase 14: {cfg.name} full width and depth on {B} x {S} tokens, "
        f"kernel route vs plain route (a loop over time): logits {agree}; "
        f"bf16 route ratio {ratio} (limit {BF16_ROUTE_RATIO}); seconds "
        f"{secs}")
    return {"agree": agree, "bf16_route_ratio": ratio, "secs": secs}


# The kernels each library runs on the main paths, as fragments of their
# mangled names in ptxas's report (the SSD's at 32 columns a slice, ds 64,
# aligned rows; the attention backward's at hd 64 and 128; the SSD
# backward's two bf16 entries at ds 64, the carry pass and the
# chunk-local gradients; the selective-scan backward's bf16 entry at ds 16)
MAIN_ENTRIES = {"topk_select": "topk_select",
                "flash_attention": "flash_fwd_wgmma",
                "flash_attention_bwd": "flash_bwd_wgmma",
                "ssd_chunk": "ssd_fwd_mmaILi32ELi64ELb1E",
                "ssd_chunk_bwd": ("ssd_bwd_carryILi64E",
                                  "ssd_bwd_localILi64E"),
                "selective_scan": "scan_fwdI13__nv_bfloat16Li16E",
                "selective_scan_bwd": "scan_bwd_clusterI13__nv_bfloat16Li16E"}
SSD_BWD_DESIGN = ("ssd_bwd_carry (K over the chunks in reverse, a CTA a "
                  "batch and head, mma.sync on split e^l dy) then "
                  "ssd_bwd_local (a CTA a chunk and head group, two an SM: "
                  "chunk products on mma.sync with split f32 operands, dB "
                  "and dC summed over the group's heads in shared memory, "
                  "dA by parts)")
SCAN_BWD_DESIGN = ("scan_bwd_cluster (256-thread CTAs of 64 channels, two an "
                   "SM, the forward's 4 lanes a channel and its decay; "
                   "tiles in reverse, each recomputed from its state in "
                   "8-step sub-tiles; x, dt and dy staged by cp.async in "
                   "their own type into the rows just freed; dB and dC "
                   "summed over a warp's channels by shuffles, over the "
                   "CTA's warps, then over a 2-CTA cluster through "
                   "distributed shared memory into per-cluster f32 parts, "
                   "all in a fixed order and without atomics; dA and dD by "
                   "batch parts)")


def ptxas_usage(text):
    """ptxas's ``-v`` report -> ``{entry: {"registers": n, "spill_stores":
    bytes, "spill_loads": bytes}}``, entries by mangled name."""
    usage, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            usage[entry] = {"registers": None, "spill_stores": 0,
                            "spill_loads": 0}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[entry]["spill_stores"] = int(m.group(1))
            usage[entry]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[entry]["registers"] = int(m.group(1))
    return usage


def entry_usage(usage, fragment):
    """The entries of ``usage`` whose names hold ``fragment``: how many,
    their most registers a thread and most spill bytes (stores and loads).
    Fails if there is none. A tuple of fragments gives one such reading
    each, by fragment."""
    if isinstance(fragment, tuple):
        return {f: entry_usage(usage, f) for f in fragment}
    hits = [u for name, u in usage.items() if fragment in name]
    check(bool(hits), f"no kernel like {fragment!r} in the build's report")
    return {"entries": len(hits),
            "registers": max(h["registers"] for h in hits),
            "spill_bytes": max(h["spill_stores"] + h["spill_loads"]
                               for h in hits)}


def sass_loops(sass, fragment):
    """The loops (backward branches) of the first function in ``cuobjdump
    -sass`` text whose name holds ``fragment``, shortest first: each one's
    static instruction count and count by opcode (modifiers dropped)."""
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        if fragment not in func.split("\n", 1)[0]:
            continue
        ins = []
        for line in func.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_]*)[.\w]*(.*?);", line)
            if m:
                ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
        loops = []
        for addr, op, rest in ins:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and target and int(target.group(1), 16) < addr:
                top = int(target.group(1), 16)
                body = [o for a, o, _ in ins if top <= a <= addr]
                loops.append({"instructions": len(body),
                              "ops": dict(Counter(body))})
        return sorted(loops, key=lambda loop: loop["instructions"])
    raise SmokeFailure(f"no function like {fragment!r} in the SASS")


def scan_loop_counts(sass):
    """The bf16 selective scan's inner loop at ds 16 (its shortest loop
    with an exponential): instructions, exponentials (MUFU) and
    instructions a state-step (one exponential each)."""
    loop = next(lp for lp in sass_loops(sass, MAIN_ENTRIES["selective_scan"])
                if "MUFU" in lp["ops"])
    return {"instructions": loop["instructions"],
            "mufu": loop["ops"]["MUFU"],
            "per_state_step": loop["instructions"] / loop["ops"]["MUFU"]}


def scan_bwd_loop_counts(sass, fragment=MAIN_ENTRIES["selective_scan_bwd"]):
    """The selective-scan backward's two inner loops, its two shortest
    with an exponential: the first pass over a tile (7 iterations of 8
    steps a tile) and the sub-tile loop (8 iterations: the sub-tile again,
    the walk back, the sums); each iteration takes one exponential a
    state-step of its 8 steps. Instructions a state-step: 7/8 of the
    first's instructions over its exponentials, plus the second's. And
    the function's global atomics (REDG, ATOMG) and bulk reduce-adds
    (UTMAREDG)."""
    first, sub = [lp for lp in sass_loops(sass, fragment)
                  if "MUFU" in lp["ops"]][:2]
    ops = next(iter(sass_ops(sass, fragment).values()))
    return {"first_pass": {"instructions": first["instructions"],
                           "mufu": first["ops"]["MUFU"]},
            "sub_tile": {"instructions": sub["instructions"],
                         "mufu": sub["ops"]["MUFU"]},
            "per_state_step": 7 / 8 * first["instructions"]
            / first["ops"]["MUFU"] + sub["instructions"] / sub["ops"]["MUFU"],
            **{op: ops.get(op, 0) for op in ("REDG", "ATOMG", "UTMAREDG")}}


def ssd_loop_counts(sass, fragment=MAIN_ENTRIES["ssd_chunk"]):
    """The chunk loop (the longest loop with a barrier) of the SSD kernel
    named by ``fragment``: static instructions, tensor-core products
    (HMMA), scalar FMAs (FFMA) and exponentials (MUFU)."""
    loop = [lp for lp in sass_loops(sass, fragment) if "BAR" in lp["ops"]][-1]
    return {"kernel": fragment, "instructions": loop["instructions"],
            **{op: loop["ops"].get(op, 0) for op in ("HMMA", "FFMA", "MUFU")}}


def loop_counts(ops, paths, ssd_entry=MAIN_ENTRIES["ssd_chunk"],
                scan_bwd_entry=MAIN_ENTRIES["selective_scan_bwd"]):
    """Phase 1's SASS counts of the SSD (its kernel ``ssd_entry``) and scan
    kernels and of the selective-scan backward (its kernel
    ``scan_bwd_entry``, where ``paths`` has its library), from ``cuobjdump
    -sass`` (the toolkit's, beside nvcc) of the libraries at ``paths``
    (``{name: path}``); "no cuobjdump" where the toolkit has none."""
    tool = Path(ops._nvcc()).parent / "cuobjdump"
    out = {}
    for name, count in (
            ("ssd_chunk", lambda text: ssd_loop_counts(text, ssd_entry)),
            ("selective_scan", scan_loop_counts),
            ("selective_scan_bwd",
             lambda text: scan_bwd_loop_counts(text, scan_bwd_entry))):
        if name not in paths:
            continue
        if not tool.exists():
            out[name] = "no cuobjdump"
            continue
        proc = subprocess.run([str(tool), "-sass", str(paths[name])],
                              capture_output=True, text=True)
        check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
        out[name] = count(proc.stdout)
    return out


# The Hopper instructions counted in the backward kernel's SASS: wgmma
# (HGMMA), the TMA loads (UTMALDG) and the TMA reduce-adds into dq
# (UTMAREDG), beside the Ampere-era tensor-core products (HMMA) and the
# per-element global atomics (REDG, ATOMG) that the design replaced
BWD_SASS_OPS = ("HGMMA", "UTMALDG", "UTMAREDG", "HMMA", "REDG", "ATOMG")
BWD_DESIGN = ("flash_bwd_wgmma: TMA loads, warp-specialised wgmma (a "
              "producer and two consumer warpgroups over 128-key tiles), dQ "
              "by TMA bulk reduce-add")
BWD_WIDE_DESIGN = ("flash_bwd_wgmma_wide at (192, 128): 64-key tiles, both "
                   "consumer warpgroups on the same keys, S^T and dP^T split "
                   "by query columns, P^T and dS^T through shared memory, dK "
                   "and dV split by column boxes (dK's third box by queries), "
                   "dQ by TMA bulk reduce-add, heads the grid's outer axis")


def bf16_entry(name, dqk):
    """The bf16 kernel of library ``name`` at q.k width ``dqk``: the
    backward's own design past two 64-column boxes."""
    if name == "flash_attention_bwd" and dqk > 128:
        return "flash_bwd_wgmma_wide"
    return MAIN_ENTRIES[name]


def wgmma_serialized(text, fragment):
    """Whether ptxas's report says it serialized the wgmmas (C7511) of an
    entry whose name holds ``fragment``."""
    return any("C7511" in line and fragment in line
               for line in text.splitlines())


def sass_ops(sass, fragment):
    """Static count of each opcode (modifiers dropped) of every function in
    ``cuobjdump -sass`` text whose name holds ``fragment``: ``{function:
    {opcode: n}}``. Fails if there is none."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0].strip()
        if fragment in name:
            out[name] = dict(Counter(re.findall(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                func)))
    check(bool(out), f"no function like {fragment!r} in the SASS")
    return out


def bwd_sass_counts(ops, path, fragment=MAIN_ENTRIES["flash_attention_bwd"]):
    """Phase 1's ``BWD_SASS_OPS`` counts of each backward entry like
    ``fragment`` in the library at ``path`` (``cuobjdump -sass``); "no
    cuobjdump" where the toolkit has none."""
    tool = Path(ops._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return "no cuobjdump"
    proc = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr}")
    return {name: {op: counts.get(op, 0) for op in BWD_SASS_OPS}
            for name, counts in sass_ops(proc.stdout, fragment).items()}


def max_sm_clock_hz(torch, dev):
    """The card's maximum SM clock: ``nvidia-smi``'s ``clocks.max.sm``, else
    the device properties' ``clock_rate`` (kHz)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if line.strip().isdigit():
        return int(line) * 1e6
    khz = getattr(torch.cuda.get_device_properties(dev), "clock_rate", 0)
    check(khz > 0, "the card's maximum SM clock is unknown")
    return khz * 1e3


def scan_bound(x, dt, Bm, Cm, A, D, sms, clock_hz):
    """Least time: x, dt, B, C, A, D read and y written once at the HBM
    rate; one exponential per (batch, step, channel, state) on the
    special-function units (``SFU_PER_CLOCK_PER_SM`` a clock on ``sms`` SMs
    at ``clock_hz``), and ``SCAN_FLOPS_PER_EXP`` float32 operations around
    each at the peak rate. Returns ``(ms, "bytes" or "operations")``."""
    nbytes = 2 * x.nbytes + dt.nbytes + Bm.nbytes + Cm.nbytes + A.nbytes \
        + D.nbytes
    B, S, di = x.shape
    exps = B * S * di * Bm.shape[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(exps / (SFU_PER_CLOCK_PER_SM * sms * clock_hz),
                SCAN_FLOPS_PER_EXP * exps / F32_FLOP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_scan_timing(torch, ops, ref, seen, l2_bytes, sms, clock_hz):
    """The scan on the inputs the prefill gave it: kernel (20 back-to-back
    calls a trial) and plain version (1 call a trial, about half a second),
    5 trials each, in two turns."""
    args, _, _ = seen["selective_scan"]
    sets, cold = copies(args, l2_bytes)
    runs = {"ms": [], "plain_ms": []}
    for _ in range(2):
        runs["ms"].append(cuda_ms(torch, ops.selective_scan, sets))
        runs["plain_ms"].append(cuda_ms(torch, ref.selective_scan, sets,
                                        reps=1))
    row = {key: statistics.median(val) for key, val in runs.items()}
    row["library_ms"] = None   # no single PyTorch call computes the scan
    row["bound_ms"], row["bound_by"] = scan_bound(*args, sms, clock_hz)
    row.update(shape=list(args[0].shape), ds=int(args[2].shape[-1]),
               dtype=dtype_name(args[0].dtype), l2_cold=cold,
               sms=sms, max_sm_clock_mhz=clock_hz / 1e6)
    row["card"] = card_name_power()
    log(f"phase 16: selective_scan on {row['card']} at the prefill shape "
        f"{row['shape']} ds="
        f"{row['ds']} {row['dtype']}: kernel {row['ms']:.5f} ms, plain "
        f"(sequential) {row['plain_ms']:.5f} ms, no single PyTorch call "
        f"computes it, bound {row['bound_ms']:.6f} ms ({row['bound_by']}; "
        f"{sms} SMs at {clock_hz / 1e6:.0f} MHz)")
    return row


# ---------------------------------------- LM training (phases 17-20)
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
# no Pallas kernel: the reference differentiates its pure-jnp attention
BWD_REPLACES = "src/repro/models/attention.py:38"
# B, S, H, KH, hd: phase 7's shapes (pad 0) and the olmo-1b train step's
# (4, 4096, 16 heads of 128), GQA with 24 query heads over 8 at a ragged S
BWD_SHAPES = [s[:5] for s in ATTN_SHAPES if s[5] == 0] + [
    (4, 4096, 16, 16, 128), (2, 1000, 24, 8, 128)]
# The tight check of the bf16 backward: the relative L2 distance of each of
# dq, dk, dv from the f32 backward (the plain version) of the same inputs,
# q, k, v, o, lse and do as the kernel read them, so that it sees the
# kernel's own arithmetic: P and dS rounded to bf16 as operands of the
# tensor-core products (as the forward rounds P before P V), and each
# gradient rounded to bf16 once. (Measured from the f32 forward's o
# instead, D = rowsum(dO o O) carries o's bf16 rounding, which the
# cancellation in dP - D amplifies: dq read 7.4e-3 on the train step's
# first call.) On an H100 the sound kernel read 2.32e-3 to 2.39e-3 in
# phase 17 and 2.19e-3 on the train step's first call, both the mma.sync
# design and the wgmma one (flash_bwd_wgmma) that replaced it: they round
# at the same places; the planted faults (chip_faults.py) fail phase 17's
# checks.
ATTN_BWD_BF16_REL_L2 = 3.5e-3
TRAIN_BATCH, TRAIN_LEN = 4, 4096   # a cut of train_4k's 256 x 4096
TRAIN_STEPS = 3
ROUTE_DEPTH, ROUTE_BATCH, ROUTE_TOKENS = 2, 2, 1024
# f32 (TF32 off) one step's loss and gradients, kernel route against the
# plain route (autograd through the query-chunked attention), at full
# width and depth 2 on 2 x 1024 tokens
F32_LOSS_RTOL = 1e-5
F32_GRAD_REL_L2 = 1e-4


def attn_bwd_inputs(torch, B, S, H, KH, D, dtype, dev, seed, dv=None):
    """q, k (width ``D``), v and an output gradient do (width ``dv``,
    default ``D``)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    dv = dv or D
    return [torch.randn(B, S, h, w, generator=g).to(dtype).to(dev)
            for h, w in ((H, D), (KH, D), (KH, dv), (H, dv))]


# the most f32 scores (B x query heads x S x S) one call of the plain
# backward makes: at deepseek-v2-236b's (4, 4096, 128 heads) they would be
# 34 GB, each with the probabilities' and dS's tensors beside them
PLAIN_BWD_SCORES = 3 * 2**30


def plain_bwd(torch, ref, q, k, v, o, lse, do, causal=True):
    """``ref.flash_attention_bwd`` over slices of the KV heads (each with
    its query heads), each slice's scores at most ``PLAIN_BWD_SCORES``
    floats: the same arithmetic a head at a time (heads are independent),
    in one call where the whole fits."""
    B, S, H, _ = q.shape
    KH = k.shape[2]
    G = H // KH
    step = max(1, min(KH, PLAIN_BWD_SCORES // (B * G * S * S)))
    if step == KH:
        return ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    parts = [ref.flash_attention_bwd(
        q[:, :, a * G:b * G], k[:, :, a:b], v[:, :, a:b], o[:, :, a * G:b * G],
        lse[:, a * G:b * G], do[:, :, a * G:b * G], causal=causal)
        for a, b in ((a, min(a + step, KH)) for a in range(0, KH, step))]
    return tuple(torch.cat(g, dim=2) for g in zip(*parts))


def bwd_rel_l2(torch, ref, grads, q, k, v, o, lse, do, causal):
    """Each gradient's relative L2 distance from the f32 backward (the
    plain version, TF32 off) of the same inputs: q, k, v, o, lse and do as
    the kernel read them."""
    exact = plain_bwd(torch, ref, *(t.float() for t in (q, k, v, o)), lse,
                      do.float(), causal=causal)
    return {name: rel_l2(torch, g, e)
            for name, g, e in zip(("dq", "dk", "dv"), grads, exact)}


def phase_attn_bwd_vs_plain(torch, ops, ref, dev, shapes=None):
    """17: the backward kernel against its plain version on the same q, k,
    v, o, log-sum-exp and do (o and the log-sum-exp from the forward
    kernel), and the log-sum-exp of both forward designs against the plain
    forward's, at the JAX package's attention tolerances; bf16 gradients
    also by the tight check."""
    from repro_torch.kernels import flash_attention as fa

    errs, lse_errs, shapes_run, rel = {}, {}, [], {}
    fwd = ops.load_library("flash_attention")
    for i, (B, S, H, KH, D) in enumerate(shapes or BWD_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            name = dtype_name(dt)
            q, k, v, do = attn_bwd_inputs(torch, B, S, H, KH, D, dt, dev,
                                          300 + i)
            for causal in (True, False):
                what = f"attention backward B={B} S={S} H={H} KH={KH} " \
                       f"hd={D} {name} causal={causal}"
                o, lse = fa.launch(fwd, q, k, v, causal=causal,
                                   with_lse=True)
                _, plain_lse = ref.flash_attention_fwd_lse(q, k, v,
                                                           causal=causal)
                lse_errs[name] = max(lse_errs.get(name, 0.0), close(
                    torch, lse, plain_lse, ATTN_TOL[name],
                    f"log-sum-exp of the forward, {what}"))
                grads = ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                causal=causal)
                exp = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=causal)
                for gname, g, e in zip(("dq", "dk", "dv"), grads, exp):
                    check(g.dtype == dt and g.shape == e.shape,
                          f"{gname} {g.dtype} {tuple(g.shape)}: {what}")
                    errs[name] = max(errs.get(name, 0.0), close(
                        torch, g, e, ATTN_TOL[name], f"{gname}, {what}"))
                del exp
                if dt == torch.bfloat16:
                    case = f"{B}x{S}x{H}x{KH}x{D} causal={causal}"
                    rel[case] = held(bwd_rel_l2(torch, ref, grads, q, k, v,
                                                o, lse, do, causal),
                                     ATTN_BWD_BF16_REL_L2, what)
                shapes_run.append([B, S, H, KH, D, name, causal])
                del grads, o, lse, plain_lse
            del q, k, v, do
    torch.cuda.synchronize()
    log(f"phase 17: flash_attention_bwd kernel == plain on "
        f"{len(shapes_run)} cases (B,S,H,KH,hd) in {shapes or BWD_SHAPES}, "
        f"bf16 and f32, causal and not: max abs err {errs} (tol {ATTN_TOL}, "
        f"TF32 off); the log-sum-exp of both forward designs == plain, max "
        f"abs err {lse_errs}; bf16 gradients vs the f32 backward of their "
        f"inputs, relative L2 {rel} (limit {ATTN_BWD_BF16_REL_L2})")
    return errs, lse_errs, shapes_run, max(rel.values())


def step_kind(name):
    """The layer a device operation of a train step belongs to, by its
    kernel's name."""
    low = name.lower()
    if "flash_bwd" in name or "bwd_prep" in name or "cast_dq" in name:
        return "attention backward kernel"
    if "flash_fwd" in name:
        return "attention forward kernel"
    if "ssd_bwd" in name or "scan_bwd" in name:
        return "scan backward kernel"
    if "ssd_fwd" in name or "scan_fwd" in name:
        return "scan forward kernel"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "matmuls (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_step(torch, run, out_dir, top=10, kind=None):
    """A ``torch.profiler`` trace of one call of ``run()`` (a train step,
    or a prefill): :func:`round_split`'s span, busy time, idle share and
    top device operations, and the device time by ``kind`` of each
    operation's name (:func:`step_kind` unless given)."""
    kind = kind or step_kind
    from torch.profiler import ProfilerActivity, profile, schedule

    trace = out_dir / "trace_train_step.json"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=0, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(str(trace))
                 ) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
    events = json.loads(trace.read_text())["traceEvents"]
    row = round_split(events, "train_step", top)
    t0 = min(e["ts"] for e in events if e.get("ph") == "X" and
             str(e.get("name", "")).startswith("ProfilerStep#"))
    kinds = Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset") and e["ts"] >= t0:
            kinds[kind(str(e["name"]))] += e["dur"] / 1e3
    row["by_kind_ms"] = dict(kinds.most_common())
    return row


def grad_diff(torch, got, exact):
    """The largest relative L2 distance of a gradient leaf of ``got`` from
    the same leaf of ``exact``, and of the whole gradient (all leaves as
    one vector)."""
    worst = max(rel_l2(torch, g, e.float()) for g, e in zip(got, exact))
    num = math.sqrt(sum(float((g.float() - e.float()).norm()) ** 2
                        for g, e in zip(got, exact)))
    den = math.sqrt(sum(float(e.float().norm()) ** 2 for e in exact))
    return {"worst_leaf_rel_l2": worst, "rel_l2": num / den}


def loss_and_grads(torch, cfg, params, batch, dev, use_kernel):
    """``loss_fn``'s loss and the gradient of every parameter leaf the
    loss reads (a cut of zamba2's depth below ``attn_every`` leaves its
    shared attention block unread)."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.models.transformer import loss_fn

    leaves, spec = tree_flatten(params)
    leaves = [None if t is None else t.detach().requires_grad_(True)
              for t in leaves]
    loss, _ = loss_fn(cfg, tree_unflatten(leaves, spec), batch, device=dev,
                      use_kernel=use_kernel)
    grads = torch.autograd.grad(loss, [t for t in leaves if t is not None],
                                allow_unused=True)
    return float(loss), [g for g in grads if g is not None]


def attention_step_plan(cfg):
    """The attention launches a train step of a dense ``cfg`` must make:
    each layer's forward twice (the step and the remat recompute) and its
    backward once."""
    return {"flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}


def train_steps(torch, ops, cfg, dev, seed, want, record,
                batch_rows=TRAIN_BATCH):
    """The train step's main path: ``make_train_step(cfg,
    default_optimizer())`` on ``lm_batch`` at ``batch_rows`` x
    ``TRAIN_LEN``, ``TRAIN_STEPS`` steps, the counts of ``want`` set to 0
    just before each step and read just after (each must equal ``want``),
    the losses finite; then one profiled step. Returns ``(losses, secs,
    launches, peak GiB, profile, seen)``, ``seen`` the first call of the
    wrapper ``record`` (:func:`first_calls`)."""
    from repro_torch import prng
    from repro_torch.data import lm_batch
    from repro_torch.launch.steps import default_optimizer, make_train_step
    from repro_torch.models.transformer import init_params

    params = init_params(seed, cfg, device=dev)
    opt = default_optimizer()
    state = opt.init(params)
    step = make_train_step(cfg, opt, device=dev)
    key = prng.PRNGKey(seed, dev)
    losses, secs, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with first_calls(ops, (record,)) as seen:
        for i in range(TRAIN_STEPS):
            batch = lm_batch(prng.fold_in(key, i), cfg, batch_rows,
                             TRAIN_LEN)
            torch.cuda.synchronize()
            for n in want:
                ops.LAUNCHES[n] = 0
            t0 = time.perf_counter()
            params, state, loss, _ = step(params, state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches.append({n: ops.LAUNCHES[n] for n in want})
            losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(n == want for n in launches),
          f"{cfg.name} train steps launched {launches}; expected {want} a "
          f"step")
    check(all(math.isfinite(x) for x in losses), f"{cfg.name} losses "
                                                  f"{losses}")
    check(int(state["t"]) == TRAIN_STEPS, f"optimizer step {state['t']}")
    with tempfile.TemporaryDirectory() as tmp:   # a trace passes 64 MiB
        profile = profile_step(torch, lambda: step(params, state, batch),
                               Path(tmp))
    del params, state, step
    torch.cuda.empty_cache()
    return losses, secs, launches, peak, profile, seen


def train_routes(torch, cfg, seed, dev, route_len):
    """One step's loss and gradients on ``ROUTE_BATCH`` x ``route_len``
    tokens (behind ``cfg.n_patches`` patch embeddings with the vision
    frontend; a token a codebook with codebooks), kernel route against
    plain route: in f32 (TF32 off) at depth
    ``ROUTE_DEPTH`` (``F32_LOSS_RTOL`` on the loss, ``F32_GRAD_REL_L2`` a
    leaf; where those layers hold an MoE layer, by :func:`moe_grad_routes`,
    the same experts on both routes first), and in bf16 at ``cfg``'s
    depth, where the kernel route's
    gradient may lie no further from the f32 gradient than
    ``BF16_ROUTE_RATIO`` times the plain route's. Returns the readings
    ``(f32, bf16, ratio)``."""
    from repro_torch.models.transformer import init_params

    g = torch.Generator(device="cpu").manual_seed(seed + 2)
    drawn = to_device(lm_inputs(torch, cfg, g, ROUTE_BATCH,
                                cfg.n_patches + route_len + 1), dev)
    tokens = drawn.pop("tokens")
    rbatch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:], **drawn}
    cfg2 = cfg.with_(n_layers=ROUTE_DEPTH, compute_dtype=torch.float32)
    p2 = init_params(seed + 1, cfg2, device=dev)
    if moe_layers(cfg2):
        f32 = moe_grad_routes(torch, cfg2, p2, rbatch, dev,
                              f"f32 {cfg.name} depth {ROUTE_DEPTH}")
        del p2
    else:
        kl, kg = loss_and_grads(torch, cfg2, p2, rbatch, dev, True)
        pl, pg = loss_and_grads(torch, cfg2, p2, rbatch, dev, False)
        f32 = {"loss_rel": abs(kl - pl) / abs(pl),
               **grad_diff(torch, kg, pg)}
        del p2, kg, pg
        check(f32["loss_rel"] <= F32_LOSS_RTOL
              and f32["worst_leaf_rel_l2"] <= F32_GRAD_REL_L2,
              f"f32 {cfg.name} depth {ROUTE_DEPTH}, kernel vs plain route: "
              f"{f32} (limits {F32_LOSS_RTOL} loss, {F32_GRAD_REL_L2} a "
              f"leaf)")
    params = init_params(seed + 1, cfg, device=dev)
    _, exact = loss_and_grads(torch, cfg.with_(compute_dtype=torch.float32),
                              params, rbatch, dev, False)
    _, kern = loss_and_grads(torch, cfg, params, rbatch, dev, True)
    bf16 = {"kernel_vs_f32": grad_diff(torch, kern, exact)}
    del kern
    _, plain = loss_and_grads(torch, cfg, params, rbatch, dev, False)
    bf16["plain_vs_f32"] = grad_diff(torch, plain, exact)
    del plain, exact, params
    torch.cuda.empty_cache()
    ratio = bf16["kernel_vs_f32"]["rel_l2"] / bf16["plain_vs_f32"]["rel_l2"]
    check(ratio <= BF16_ROUTE_RATIO,
          f"bf16 {cfg.name}: the kernel route's gradient lies {ratio} x as "
          f"far from f32 as the plain route's (limit {BF16_ROUTE_RATIO}): "
          f"{bf16}")
    return f32, bf16, ratio


def phase_train_step(torch, ops, ref, dev, seed):
    """18: the main path of the attention kernels in training:
    ``make_train_step(get_config("olmo-1b"), default_optimizer())`` on
    ``lm_batch`` at 4 x 4096, 3 steps (counts set to 0 just before each,
    read just after); the first backward call held against its plain
    version; then the routes (f32 at depth 2, bf16 at full depth), and
    reduced zamba2 and falcon's loss and gradients through the scan
    kernels (each forward twice a layer under remat, each backward
    once)."""
    from repro_torch import prng
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import lm_batch
    from repro_torch.models.transformer import init_params

    cfg = get_config("olmo-1b")
    key = prng.PRNGKey(seed, dev)
    losses, secs, launches, peak, profile, seen = train_steps(
        torch, ops, cfg, dev, seed, attention_step_plan(cfg),
        "flash_attention_bwd")
    (q, k, v, o, lse, do), kw, grads = seen["flash_attention_bwd"]
    check(q.dtype == torch.bfloat16 and tuple(q.shape) == (
        TRAIN_BATCH, TRAIN_LEN, cfg.n_heads, cfg.resolved_head_dim),
        f"the step's backward call: {q.dtype} {tuple(q.shape)}")
    exp = ref.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    err = max(close(torch, g, e, ATTN_TOL["bfloat16"],
                    f"the step's first backward call, {n}")
              for n, g, e in zip(("dq", "dk", "dv"), grads, exp))
    del exp
    call_rel = held(bwd_rel_l2(torch, ref, grads, q, k, v, o, lse, do,
                               kw.get("causal", True)),
                    ATTN_BWD_BF16_REL_L2, "phase 18: the first backward call")
    timed_secs = secs[1:]
    tok_s = TRAIN_BATCH * TRAIN_LEN / statistics.median(timed_secs)

    # the routes: f32 (TF32 off) at depth 2, bf16 at full depth
    f32, bf16, ratio = train_routes(torch, cfg, seed, dev, ROUTE_TOKENS)

    # the scan kernels train: the reduced SSM archs' loss and gradients
    # under grad on the card, through each scan's forward and backward
    trained = {}
    for arch, pair in (("zamba2-1.2b", ("ssd_chunk", "ssd_chunk_bwd")),
                       ("falcon-mamba-7b",
                        ("selective_scan", "selective_scan_bwd"))):
        rcfg = get_reduced(arch)
        rp = init_params(seed, rcfg, device=dev)
        b = lm_batch(key, rcfg, 2, 64)
        for n in pair:
            ops.LAUNCHES[n] = 0
        rloss, rgrads = loss_and_grads(torch, rcfg, rp, b, dev, None)
        counts = {n: ops.LAUNCHES[n] for n in pair}
        check(math.isfinite(rloss)
              and all(bool(torch.isfinite(t).all()) for t in rgrads)
              and counts == {pair[0]: 2 * rcfg.n_layers,
                             pair[1]: rcfg.n_layers},
              f"reduced {arch} under grad on the card: loss {rloss}, "
              f"launches {counts}")
        trained[arch] = {"loss": rloss, "launches": counts}
    row = {"step_s": secs, "tokens_per_s": tok_s, "peak_gib": peak,
           "profile": profile,
           "losses": losses, "launches": launches, "max_abs_err": err,
           "call_rel_l2": call_rel, "f32_routes": f32, "bf16_routes": bf16,
           "bf16_route_ratio": ratio, "scan_archs_train": trained,
           "card": card_name_power()}
    log(f"phase 18: olmo-1b full width ({cfg.param_count():,} params) "
        f"train steps (make_train_step, AdamW) on {TRAIN_BATCH} x "
        f"{TRAIN_LEN} tokens (a cut of train_4k's 256 x 4096) on "
        f"{row['card']}: s a step {secs} ({tok_s:.0f} tokens/s over steps "
        f"2-{TRAIN_STEPS}), peak memory {peak:.2f} GiB, losses {losses}, "
        f"launches a step {launches}; one profiled step: span "
        f"{profile['span_ms']:.2f} ms, device busy "
        f"{profile['device_busy_ms']:.2f} ms, idle share "
        f"{profile['idle_share']:.4f}, {profile['device_ops']} device "
        f"operations, ms by layer {profile['by_kind_ms']}, top "
        f"{profile['top'][:5]}; the first backward call == plain, max "
        f"abs err {err}, vs the f32 backward relative L2 {call_rel}; f32 "
        f"depth {ROUTE_DEPTH} on {ROUTE_BATCH} x {ROUTE_TOKENS}, kernel vs "
        f"plain route: {f32}; bf16 full depth: {bf16}, ratio {ratio} (limit "
        f"{BF16_ROUTE_RATIO}); reduced SSM archs under grad through the "
        f"scan kernels: {trained}")
    return row, seen


def phase_cohort_cli(torch):
    """19: ``python -m repro_torch.launch.train cohort --steps 10`` (reduced
    olmo-1b, as the reference), the same for ``--arch zamba2-1.2b`` and
    ``--arch falcon-mamba-7b`` (through the scan kernels' backward
    kernels), of phi4-mini-3.8b, phi3-mini-3.8b, minicpm3-4b,
    internvl2-2b and musicgen-large, the federated LLM cohort example
    (and of the last two), ``python -m repro_torch.examples.serve_decode``
    (reduced phi3-mini-3.8b) and ``python -m repro_torch.launch.dev_smoke``
    (all ten reduced archs: a train forward/backward and a decode step
    each), each in its own process on the card, all together (each
    process spends most of its time starting); each must exit 0 (``train
    cohort`` raises unless its loss falls, the serving driver on tokens
    out of range, the dev smoke on a non-finite value)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    cohort = ["-m", "repro_torch.launch.train", "cohort", "--steps", "10"]

    def run(name, cmd):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                              text=True, env=env, cwd=str(ROOT),
                              timeout=600)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"phase 19: {' '.join(cmd)} exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        return name, {"s": secs,
                      "last_line": proc.stdout.strip().splitlines()[-1]}

    together = [
        ("train_cohort", cohort),
        ("train_cohort_zamba2", cohort + ["--arch", "zamba2-1.2b"]),
        ("train_cohort_falcon", cohort + ["--arch", "falcon-mamba-7b"]),
        ("federated_llm_cohort",
         ["-m", "repro_torch.examples.federated_llm_cohort"])] + [
        (f"train_cohort_{arch}", cohort + ["--arch", arch])
        for arch in DENSE_ARCHS + FRONTEND_ARCHS] + [
        (f"federated_llm_cohort_{arch}",
         ["-m", "repro_torch.examples.federated_llm_cohort", "--arch", arch])
        for arch in FRONTEND_ARCHS] + [
        ("serve_decode", ["-m", "repro_torch.examples.serve_decode"]),
        ("dev_smoke", ["-m", "repro_torch.launch.dev_smoke"])]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(together)) as pool:
        row = dict(pool.map(lambda job: run(*job), together))
    row["together_s"] = time.perf_counter() - t0
    log(f"phase 19: train cohort --steps 10 of olmo-1b, zamba2-1.2b, "
        f"falcon-mamba-7b, {', '.join(DENSE_ARCHS + FRONTEND_ARCHS)}, the "
        f"federated LLM cohort example (and of the last two), the "
        f"serve_decode example and the dev smoke of the ten archs on the "
        f"card, a process each, together: {row}")
    return row


def bwd_bound(q, k, v, causal=True):
    """Least time of the backward: q, k, v, o, do and the f32 log-sum-exp
    read and dq, dk, dv written once at the HBM rate; five products over
    the pairs the mask keeps, 2 FLOP a pair and column each: s recomputed,
    dK and dQ over the q.k width Dqk, dP and dV over the v width Dv, at the
    peak rate of the dtype."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    o_bytes = q.nbytes // D * Dv
    nbytes = 2 * (q.nbytes + k.nbytes + v.nbytes + o_bytes) + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2 * (3 * D + 2 * Dv) * pairs * B * H
    rate = BF16_FLOP_PER_S if q.element_size() == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sdpa_bwd_ms(torch, sets, causal, reps=5, trials=5, gqa=False):
    """``scaled_dot_product_attention`` forward and backward minus its
    forward alone, on the (B, H, S, hd) layout of each set (q, k, v, do);
    ms a call. ``gqa``: more query heads than KV heads (``enable_gqa``)."""
    F = torch.nn.functional
    leaves = [tuple(t.transpose(1, 2).contiguous().requires_grad_(i < 3)
                    for i, t in enumerate(s)) for s in sets]
    kw = {"is_causal": causal, "enable_gqa": gqa}

    def fwd(q, k, v, do):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, **kw)

    def fwd_bwd(q, k, v, do):
        out = F.scaled_dot_product_attention(q, k, v, **kw)
        torch.autograd.grad(out, (q, k, v), do)

    both = cuda_ms(torch, fwd_bwd, leaves, reps=reps, trials=trials)
    alone = cuda_ms(torch, fwd, leaves, reps=reps, trials=trials)
    return both - alone, both, alone


def phase_train_timing(torch, ops, ref, seen, l2_bytes):
    """20: the backward kernel on the inputs the train step gave it
    (kernel, plain version, SDPA's backward, in turns, two turns) beside
    its bound; the attention forward with and without the log-sum-exp."""
    from repro_torch.kernels import flash_attention as fa

    (q, k, v, o, lse, do), kw, _ = seen["flash_attention_bwd"]
    causal = kw.get("causal", True)
    sets, cold = copies((q, k, v, o, lse, do), l2_bytes)
    runs = {"ms": [], "plain_ms": [], "library_ms": []}
    sdpa = []
    for _ in range(2):
        runs["ms"].append(cuda_ms(
            torch, lambda *a: ops.flash_attention_bwd(*a, causal=causal),
            sets, reps=5))
        runs["plain_ms"].append(cuda_ms(
            torch, lambda *a: ref.flash_attention_bwd(*a, causal=causal),
            sets[:2], reps=1, trials=3))
        lib = sdpa_bwd_ms(torch, [(s[0], s[1], s[2], s[5]) for s in sets[:4]],
                          causal)
        runs["library_ms"].append(lib[0])
        sdpa.append(lib)
    row = {key: statistics.median(val) for key, val in runs.items()}
    row["bound_ms"], row["bound_by"] = bwd_bound(q, k, v, causal)
    row.update(shape=list(q.shape), kv_heads=int(k.shape[2]),
               dtype=dtype_name(q.dtype), l2_cold=cold,
               sdpa_fwd_bwd_and_fwd_ms=sdpa)
    fwd = ops.load_library("flash_attention")
    fsets = [s[:3] for s in sets]
    with_lse, without = [], []
    for _ in range(2):
        without.append(cuda_ms(torch, lambda *a: fa.launch(
            fwd, *a, causal=causal), fsets))
        with_lse.append(cuda_ms(torch, lambda *a: fa.launch(
            fwd, *a, causal=causal, with_lse=True), fsets))
    row["forward_ms"] = {"without_lse": statistics.median(without),
                         "with_lse": statistics.median(with_lse),
                         "sdpa": statistics.median(s[2] for s in sdpa)}
    row["card"] = card_name_power()
    log(f"phase 20: flash_attention_bwd at the olmo-1b step's shape "
        f"{row['shape']} {row['dtype']} causal={causal} on {row['card']}: "
        f"kernel {row['ms']:.5f} ms, plain {row['plain_ms']:.5f} ms, "
        f"scaled_dot_product_attention's backward {row['library_ms']:.5f} "
        f"ms (forward + backward less forward: {sdpa}), bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']}); the forward kernel "
        f"at that shape without / with the log-sum-exp "
        f"{row['forward_ms']['without_lse']:.5f} / "
        f"{row['forward_ms']['with_lse']:.5f} ms, "
        f"scaled_dot_product_attention's forward "
        f"{row['forward_ms']['sdpa']:.5f} ms")
    return row


# --------------------------- the dense and MLA archs (phases 26-31)
# B, S, H, KH, Dqk, Dv: phi3-mini-3.8b's prefill (hd 96), minicpm3-4b's
# (MLA: q.k 96, v 64, 40 heads), phi4-mini-3.8b's (GQA 24 over 8 at hd
# 128), reduced minicpm3-4b's (48, 32), and a ragged S at each new width
# (GQA at 96)
WIDTH_SHAPES = [(2, 4096, 32, 32, 96, 96), (2, 4096, 40, 40, 96, 64),
                (2, 4096, 24, 8, 128, 128), (1, 32, 4, 4, 48, 32),
                (1, 1000, 8, 4, 96, 96), (1, 1000, 8, 8, 96, 64),
                (2, 333, 4, 4, 48, 32)]
# the new archs' train steps at full width, each cut to (layers, batch
# rows of 4096 tokens) that its memory allows. AdamW's functional update
# peaked at 34.3 bytes a parameter in falcon-mamba-7b's step (62.30 GiB
# for 1,951,137,792 parameters, PR 25); the forward and backward hold
# about 16 bytes a parameter beside the activations and the loss head.
# phi3-mini-3.8b at 16 of 32 layers (1.91B parameters, about 61 GiB at the
# update; all 32 layers, 3.72B, pass 80 GB); minicpm3-4b at 24 of 62
# (1.69B, about 54 GiB). phi4-mini-3.8b's head dominates: its 200,064-token
# vocabulary makes 6.6 GB of bf16 logits at 4 x 4096 and 13.1 GB each f32
# copy that cross-entropy and its gradient make; at 8 layers on 4 x 4096
# its backward ran out of memory asking 12.21 GiB with 67.30 GiB held, so
# it runs 12 layers (1.82B, about 58 GiB at the update) on 2 x 4096, the
# head's part halved. The cuts also keep the phases within the script's
# time.
DENSE_TRAIN_CUT = {"phi3-mini-3.8b": (16, TRAIN_BATCH),
                   "phi4-mini-3.8b": (12, 2),
                   "minicpm3-4b": (24, TRAIN_BATCH)}
DENSE_ARCHS = ("phi4-mini-3.8b", "phi3-mini-3.8b", "minicpm3-4b")


def phase_attn_widths_vs_plain(torch, ops, ref, dev, shapes=None):
    """26: both attention kernels at the new (Dqk, Dv) pairs against their
    plain versions on ``WIDTH_SHAPES``, bf16 and f32, causal and not: the
    forward's output and log-sum-exp, and dq, dk, dv on the forward
    kernel's o and log-sum-exp, at the JAX package's attention tolerances;
    in bf16 also the tight checks (the output against the f32 attention,
    each gradient against the f32 backward, of the same inputs). Every
    case runs; a failure names each case that failed."""
    from repro_torch.kernels import flash_attention as fa

    fwd = ops.load_library("flash_attention")
    errs, rel, failed, run = {}, {}, {}, []
    for i, (B, S, H, KH, D, Dv) in enumerate(shapes or WIDTH_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            name = dtype_name(dt)
            q, k, v, do = attn_bwd_inputs(torch, B, S, H, KH, D, dt, dev,
                                          500 + i, Dv)
            for causal in (True, False):
                case = f"{B}x{S}x{H}x{KH} ({D}, {Dv}) {name} causal={causal}"
                try:
                    o, lse = fa.launch(fwd, q, k, v, causal=causal,
                                       with_lse=True)
                    check(o.shape == (B, S, H, Dv) and o.dtype == dt,
                          f"output {o.dtype} {tuple(o.shape)}")
                    plain_o, plain_lse = ref.flash_attention_fwd_lse(
                        q, k, v, causal=causal)
                    err = max(close(torch, o, plain_o, ATTN_TOL[name],
                                    f"output, {case}"),
                              close(torch, lse, plain_lse, ATTN_TOL[name],
                                    f"log-sum-exp, {case}"))
                    del plain_o, plain_lse
                    grads = ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal=causal)
                    exp = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                                  causal=causal)
                    for gname, g, e in zip(("dq", "dk", "dv"), grads, exp):
                        check(g.dtype == dt and g.shape == e.shape,
                              f"{gname} {g.dtype} {tuple(g.shape)}")
                        err = max(err, close(torch, g, e, ATTN_TOL[name],
                                             f"{gname}, {case}"))
                    del exp
                    if dt == torch.bfloat16:
                        rel[case] = {"forward": tight(
                            torch, ref, o, q, k, v, causal, case),
                            "backward": held(bwd_rel_l2(
                                torch, ref, grads, q, k, v, o, lse, do,
                                causal), ATTN_BWD_BF16_REL_L2, case)}
                    errs[name] = max(errs.get(name, 0.0), err)
                    del grads, o, lse
                except SmokeFailure as e:
                    failed[case] = str(e)[:300]
                run.append([B, S, H, KH, D, Dv, name, causal])
            del q, k, v, do
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    if failed:
        raise CaseFailures(f"phase 26 ({len(run)} cases)", failed)
    log(f"phase 26: flash_attention and flash_attention_bwd == plain on "
        f"{len(run)} cases (B,S,H,KH,Dqk,Dv) in {shapes or WIDTH_SHAPES}, "
        f"bf16 and f32, causal and not: max abs err {errs} (tol {ATTN_TOL}, "
        f"TF32 off); bf16 vs the f32 computation of its inputs, relative L2 "
        f"{rel} (limits {ATTN_BF16_REL_L2} forward, {ATTN_BWD_BF16_REL_L2} "
        f"backward)")
    return errs, run, {"forward": max(r["forward"] for r in rel.values()),
                       "backward": max(r["backward"] for r in rel.values())}


def phase_dense_serving(torch, ops, ref, dev, seed, arch, phase):
    """27-29 (37-38): ``arch`` at full width and depth, random weights from
    ``seed``: the prefill's main path (:func:`phase_prefill`: one forward
    of 2 x 4096 tokens must launch the attention kernel once a layer) and
    ``generate`` at the serve defaults (:func:`phase_serve`; for MLA the
    absorbed decode's replay against the decompressed prefill). Frees the
    weights; returns the two rows and the prefill's first attention
    call."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    params = init_params(seed, cfg, device=dev)
    expect = {"flash_attention": cfg.n_layers}
    prefill, seen = phase_prefill(torch, ops, ref, dev, cfg, params, seed,
                                  expect, phase)
    serve = phase_serve(torch, ops, dev, cfg, params, seed, expect, phase,
                        BF16_REPLAY_REL_L2)
    del params
    torch.cuda.empty_cache()
    return prefill, serve, seen


def phase_dense_train_step(torch, ops, ref, dev, seed, arch, phase=30,
                           cut=None):
    """30 (39): ``make_train_step(cfg, default_optimizer())`` of ``arch``
    at full width on ``lm_batch``, cut to ``cut[arch]`` (default
    ``DENSE_TRAIN_CUT``; layers, rows of 4096 positions) (:func:`train_steps`: each step launches the
    attention forward twice a layer and its backward once); the first backward call
    held against its plain version and by the tight check; the routes
    (:func:`train_routes`: f32 at depth 2, bf16 at the step's depth, on
    2 x 1024 tokens)."""
    from repro_torch.configs import get_config

    layers, rows = (cut or DENSE_TRAIN_CUT)[arch]
    cfg = get_config(arch).with_(n_layers=layers)
    torch.cuda.empty_cache()
    losses, secs, launches, peak, profile, seen = train_steps(
        torch, ops, cfg, dev, seed, attention_step_plan(cfg),
        "flash_attention_bwd", rows)
    (q, k, v, o, lse, do), kw, grads = seen["flash_attention_bwd"]
    check(q.dtype == torch.bfloat16 and q.shape[:2] == (rows, TRAIN_LEN),
          f"the {arch} step's backward call: {q.dtype} {tuple(q.shape)}")
    exp = plain_bwd(torch, ref, q, k, v, o, lse, do, **kw)
    err = max(close(torch, g, e, ATTN_TOL["bfloat16"],
                    f"the {arch} step's first backward call, {n}")
              for n, g, e in zip(("dq", "dk", "dv"), grads, exp))
    del exp
    call_rel = held(bwd_rel_l2(torch, ref, grads, q, k, v, o, lse, do,
                               kw.get("causal", True)),
                    ATTN_BWD_BF16_REL_L2,
                    f"phase {phase}: {arch}'s first backward call")
    torch.cuda.empty_cache()
    tok_s = rows * TRAIN_LEN / statistics.median(secs[1:])
    f32, bf16, ratio = train_routes(torch, cfg, seed, dev, ROUTE_TOKENS)
    row = {"arch": arch, "params": cfg.param_count(), "layers": cfg.n_layers,
           "tokens": [rows, TRAIN_LEN],
           "of_layers": get_config(arch).n_layers,
           "attention_shape": [list(q.shape), int(k.shape[2]),
                               int(v.shape[3])],
           "step_s": secs, "tokens_per_s": tok_s, "peak_gib": peak,
           "profile": profile, "losses": losses, "launches": launches,
           "max_abs_err": err, "call_rel_l2": call_rel,
           "f32_routes": f32, "bf16_routes": bf16, "bf16_route_ratio": ratio,
           "card": card_name_power()}
    log(f"phase {phase}: {arch} full width, {cfg.n_layers} of "
        f"{row['of_layers']} layers ({cfg.param_count():,} params) train "
        f"steps (make_train_step, AdamW, per-layer remat) on {rows} x "
        f"{TRAIN_LEN} tokens on {row['card']}: s a step {secs} ({tok_s:.0f} "
        f"tokens/s over steps 2-{TRAIN_STEPS}), peak memory {peak:.2f} GiB, "
        f"losses {losses}, launches a step {launches}; one profiled step: "
        f"span {profile['span_ms']:.2f} ms, device busy "
        f"{profile['device_busy_ms']:.2f} ms, idle share "
        f"{profile['idle_share']:.4f}, ms by layer {profile['by_kind_ms']}; "
        f"the first backward call (q, KV heads, v width "
        f"{row['attention_shape']}) == plain, max abs err {err}, vs the f32 "
        f"backward relative L2 {call_rel}; f32 depth {ROUTE_DEPTH} on "
        f"{ROUTE_BATCH} x {ROUTE_TOKENS}, kernel vs plain route: {f32}; bf16 "
        f"at depth {cfg.n_layers}: {bf16}, ratio {ratio} (limit "
        f"{BF16_ROUTE_RATIO})")
    return row, seen


def sdpa_backend(torch, q, k, v, causal, gqa):
    """The backend ``scaled_dot_product_attention`` picks for these (B, H,
    S, D) inputs (PyTorch's own choice, ``torch._fused_sdp_choice``); its
    backward runs the same backend's."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, is_causal=causal, enable_gqa=gqa)).name


def prefill_forward_rows(torch, ops, ref, prefills, l2_bytes):
    """The attention forward on each arch's first prefill call
    (``prefills``), in turns (two turns), beside the plain version, one
    ``scaled_dot_product_attention`` call (``enable_gqa`` where the query
    heads outnumber the KV heads) and the bound, with the backend SDPA
    ran: ``{"<arch> prefill forward": row}``."""
    F = torch.nn.functional
    rows = {}
    for arch, seen in prefills.items():
        (q, k, v), kw, _ = seen["flash_attention"]
        causal = kw.get("causal", True)
        gqa = q.shape[2] != k.shape[2]
        sets, cold = copies((q, k, v), l2_bytes)
        bhsd = [tuple(t.transpose(1, 2).contiguous() for t in st)
                for st in sets]
        sdpa = lambda *a: F.scaled_dot_product_attention(  # noqa: E731
            *a, is_causal=causal, enable_gqa=gqa)
        runs = {"ms": [], "plain_ms": [], "library_ms": []}
        for _ in range(2):
            runs["ms"].append(cuda_ms(
                torch, lambda *a: ops.flash_attention(*a, causal=causal),
                sets))
            runs["plain_ms"].append(cuda_ms(
                torch, lambda *a: ref.flash_attention(*a, causal=causal),
                sets[:2], reps=2, trials=3))
            runs["library_ms"].append(cuda_ms(torch, sdpa, bhsd))
        row = {key: statistics.median(val) for key, val in runs.items()}
        row["bound_ms"], row["bound_by"] = attn_bound(q, k, v, causal)
        row.update(shape=list(q.shape), kv_heads=int(k.shape[2]),
                   v_width=int(v.shape[3]), dtype=dtype_name(q.dtype),
                   l2_cold=cold, sdpa_backend=sdpa_backend(
                       torch, *bhsd[0], causal, gqa))
        rows[f"{arch} prefill forward"] = row
        del sets, bhsd
        torch.cuda.empty_cache()
    return rows


def train_backward_rows(torch, ops, ref, steps, l2_bytes):
    """The attention backward on each arch's first train-step call
    (``steps``), in turns (two turns), beside the plain version, SDPA's
    backward (forward and backward less forward; ``enable_gqa`` where the
    query heads outnumber the KV heads) and the bound, with the backend
    SDPA ran: ``{"<arch> train backward": row}``."""
    rows = {}
    for arch, seen in steps.items():
        (q, k, v, o, lse, do), kw, _ = seen["flash_attention_bwd"]
        causal = kw.get("causal", True)
        gqa = q.shape[2] != k.shape[2]
        sets, cold = copies((q, k, v, o, lse, do), l2_bytes)
        runs = {"ms": [], "plain_ms": [], "library_ms": []}
        lib = []
        for _ in range(2):
            runs["ms"].append(cuda_ms(
                torch, lambda *a: ops.flash_attention_bwd(*a, causal=causal),
                sets, reps=5))
            runs["plain_ms"].append(cuda_ms(
                torch, lambda *a: plain_bwd(torch, ref, *a, causal=causal),
                sets[:1], reps=1, trials=3))
            lib.append(sdpa_bwd_ms(
                torch, [(st[0], st[1], st[2], st[5]) for st in sets[:4]],
                causal, gqa=gqa))
            runs["library_ms"].append(lib[-1][0])
        row = {key: statistics.median(val) for key, val in runs.items()}
        row["bound_ms"], row["bound_by"] = bwd_bound(q, k, v, causal)
        row.update(shape=list(q.shape), kv_heads=int(k.shape[2]),
                   v_width=int(v.shape[3]), dtype=dtype_name(q.dtype),
                   l2_cold=cold, sdpa_fwd_bwd_and_fwd_ms=lib,
                   sdpa_backend=sdpa_backend(
                       torch, *(t.transpose(1, 2) for t in (q, k, v)),
                       causal, gqa))
        rows[f"{arch} train backward"] = row
        del sets
        torch.cuda.empty_cache()
    return rows


def log_timing(phase, name, row):
    log(f"phase {phase}: {name} at {row['shape']} over {row['kv_heads']} KV "
        f"heads, v width {row['v_width']}, {row['dtype']} causal, on "
        f"{row['card']}: kernel {row['ms']:.5f} ms, plain "
        f"{row['plain_ms']:.5f} ms, scaled_dot_product_attention "
        f"{row['library_ms']:.5f} ms (backend {row['sdpa_backend']}), bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']})")


def phase_dense_timing(torch, ops, ref, dev, prefills, steps, l2_bytes):
    """31: both attention kernels on the inputs the new archs' prefills
    (``prefills``: each arch's first forward call) and train steps
    (``steps``: each first backward call) gave them, in turns (two turns),
    beside the plain version, one ``scaled_dot_product_attention`` call
    (``enable_gqa`` where the query heads outnumber the KV heads; its
    backward as forward and backward less forward) and the bound; the
    backend each SDPA call ran. Then what the padding
    of a width of 96 to two 64-column boxes costs: both kernels at
    phi3-mini-3.8b's shapes with hd 96 and 128, in turns."""
    from repro_torch.kernels import flash_attention as fa

    rows = {**prefill_forward_rows(torch, ops, ref, prefills, l2_bytes),
            **train_backward_rows(torch, ops, ref, steps, l2_bytes)}
    card = card_name_power()
    for name, row in rows.items():
        row["card"] = card
        log_timing(31, name, row)
    fwd = ops.load_library("flash_attention")
    padding = {}
    for label, (B, S) in (("forward", (PREFILL_BATCH, PREFILL_LEN)),
                          ("backward", (TRAIN_BATCH, TRAIN_LEN))):
        ms = {96: [], 128: []}
        for D in (96, 128, 128, 96):
            q, k, v, do = attn_bwd_inputs(torch, B, S, 32, 32, D,
                                          torch.bfloat16, dev, 7)
            if label == "forward":
                ms[D].append(cuda_ms(torch, ops.flash_attention,
                                     [(q, k, v)]))
            else:
                o, lse = fa.launch(fwd, q, k, v, with_lse=True)
                ms[D].append(cuda_ms(torch, ops.flash_attention_bwd,
                                     [(q, k, v, o, lse, do)], reps=5))
                del o, lse
            del q, k, v, do
        padding[label] = {"shape": [B, S, 32], "ms_by_hd": ms,
                          "hd96_over_hd128": statistics.median(ms[96])
                          / statistics.median(ms[128])}
        torch.cuda.empty_cache()
    log(f"phase 31: the padding of hd 96 to two 64-column boxes, both "
        f"kernels at phi3-mini-3.8b's shapes (32 heads, causal, bf16) with "
        f"hd 96 and 128 in turns on {card}: {padding} (ms a call; 96 / 128 "
        f"of the products' work is 0.75)")
    rows["padding_hd96_vs_hd128"] = padding
    return rows

# ------------------------ mixture-of-experts serving (phases 32-36)
# B, S, H, KH, Dqk, Dv at deepseek-v2-236b's MLA pair (q.k 128 + 64 = 192,
# three 64-column boxes; v 128): its prefill (2 x 4096, 128 heads), and a
# small, a ragged and a GQA case
WIDE_SHAPES = [(2, 4096, 128, 128, 192, 128), (1, 32, 4, 4, 192, 128),
               (1, 1000, 16, 16, 192, 128), (2, 333, 8, 4, 192, 128)]
MOE_ARCHS = ("llama4-scout-17b-a16e", "deepseek-v2-236b")
# The serving cut of each MoE arch: full width, cut in depth to what one
# card holds with headroom. f32 master weights from --seed, 4 bytes a
# parameter:
# - llama4-scout-17b-a16e: 2,202,091,520 parameters a layer (16 experts
#   of 3 x 5120 x 8192, the shared expert, the router, GQA 40 over 8 of
#   128), 8.81 GB, and the tied 202,048 x 5120 embedding (1,034,485,760),
#   4.14 GB. 6 of 48 layers: 14,247,034,880 parameters, 56.99 GB (53.07
#   GiB). A prefill of 2 x 4096 adds one layer's bf16 expert stacks
#   while the layer runs (3 x 1.34 GB) and the logits: 3.3 GB in bf16,
#   6.6 GB in f32; the route comparison holds three of them at once
#   (13.2 GB) and compares 256 positions at a time (:func:`logit_diff`).
#   Seven layers would hold 65.8 GB of weights before those 13.2 GB, of
#   the card's 85 GB.
# - deepseek-v2-236b: its leading dense layer (337,969,152), each MoE
#   layer 3,972,104,192 (160 experts of 3 x 5120 x 1536, 2 shared, the
#   router, MLA with 128 heads), 15.9 GB, and the 102,400 x 5120 embedding
#   (524,288,000), 2.1 GB. 1 dense + 3 MoE of 60 layers: 12,778,569,728
#   parameters, 51.11 GB (47.60 GiB); the bf16 expert stacks are 3 x 2.5
#   GB while a layer runs. A fourth MoE layer (67 GB) would leave under
#   10 GB for them, the logits and the attention.
MOE_SERVE_CUT = {"llama4-scout-17b-a16e": 6, "deepseek-v2-236b": 4}
# The replay of decode against the forward wants a forward that drops no
# token (one decode token a row never fills its C = 4 slots; at 1.25 the
# forward drops). tests/test_decode_consistency.py sets capacity factor
# 16, which holds at the reduced configs. At full width it does not hold
# for deepseek-v2-236b: with random weights the tokens of a row crowd onto
# the same experts, and at 16 a 32-token row has C = 20 slots an expert
# (top 6 of 160): its f32 replay read 0.194 max abs against the forward
# on an H100. A row of S tokens drops none when C >= S, that is at a
# factor of at least E / K: 16 for llama4 (top 1 of 16), 27 for deepseek.
def moe_replay_capacity(cfg):
    return max(16.0, float(math.ceil(cfg.n_experts / cfg.experts_per_token)))


# bf16 replay vs forward at the last prompt position: in bf16 the decode
# and the forward route some tokens to other experts (their top-k margins
# lie under bf16's rounding), and a token routed apart in any layer has
# other logits. So this limit only says the decode has not lost the
# logits (unrelated logits of equal norm read 1.41), as for
# falcon-mamba-7b; the f32 replay at every position holds the decode.
MOE_BF16_REPLAY_REL_L2 = 1.0
# phase 35: one full-width llama4 layer (3,236,577,280 parameters with the
# embedding, 12.9 GB in f32; each route's gradient as much again) on
# 1 x 1024 tokens, in f32, no optimizer
MOE_GRAD_ARCH, MOE_GRAD_TOKENS = "llama4-scout-17b-a16e", 1024


@contextlib.contextmanager
def recorded_routes(torch, margins=False):
    """Record each ``models/moe.py::route`` call while the block runs, in
    call order: ``{"experts", "keep"}`` ((B, S, K) tensors) and with
    ``margins`` also ``"margin"``, the smallest top-k margin of its tokens
    (the k-th probability less the next), which computes more on the
    card."""
    from repro_torch.models import moe

    inner, calls = moe.route, []

    def route(cfg, router_w, x):
        r = inner(cfg, router_w, x)
        rec = {"experts": r.experts, "keep": r.keep}
        if margins:
            K = cfg.experts_per_token
            logits = x.detach().float() @ router_w.detach()
            p = torch.sort(torch.softmax(logits, -1), -1,
                           descending=True).values
            rec["margin"] = float((p[..., K - 1] - p[..., K]).min())
        calls.append(rec)
        return r

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = inner


def flipped_share(a, b):
    """Per MoE layer, the share of (token, rank) choices whose expert
    differs between two recordings of the same layers."""
    return [float((x["experts"] != y["experts"]).float().mean())
            for x, y in zip(a, b)]


def moe_op_kind(name):
    """:func:`step_kind`, with the MoE layer's own operations apart: the
    weight casts (f32 to bf16 copies), the routing (softmax, the stable
    sort, the slot scan) and the gathers and scatters of dispatch and
    combine."""
    low = name.lower()
    kind = step_kind(name)
    if not kind.startswith("other"):
        return kind
    if "copy" in low:
        return "casts and copies (expert weights to bf16)"
    if any(w in low for w in ("sort", "scan", "softmax", "topk")):
        return "routing (softmax, sort, slot scan)"
    if any(w in low for w in ("index", "gather", "scatter")):
        return "dispatch and combine (gathers, scatters)"
    return kind


def moe_layers(cfg):
    from repro_torch.models.transformer import build_stages
    return sum(n for kind, n in build_stages(cfg) if kind == "moe")


def first_layers(cfg, params, depth):
    """``cfg`` cut to ``depth`` layers and a view of ``params`` holding its
    first ``depth`` layers (no copy)."""
    from repro_torch.models.transformer import build_stages

    cut = cfg.with_(n_layers=depth)
    out = dict(params)
    out["stages"] = [st[:n] for (_, n), st in zip(build_stages(cut),
                                                  params["stages"])]
    return cut, out


def phase_attn_wide_vs_plain(torch, ops, ref, dev, shapes=None):
    """32: both attention kernels at (Dqk, Dv) = (192, 128) against their
    plain versions on ``WIDE_SHAPES``, bf16 and f32, causal and not: the
    output (the serving call, no log-sum-exp) and the log-sum-exp (the
    call that writes it) at the JAX package's attention tolerance, the
    two calls' outputs equal, bf16 also by the tight check; then the
    backward kernel on that o and log-sum-exp: dq, dk and dv against
    :func:`plain_bwd` at the same tolerance, bf16 also by the tight check
    (``ATTN_BWD_BF16_REL_L2``). Every case runs; a failure names each case
    that failed."""
    from repro_torch.kernels import flash_attention as fa

    lib = ops.load_library("flash_attention")
    errs, rel, failed, run = {}, {}, {}, []
    bwd_errs, bwd_rel = {}, {}
    for i, (B, S, H, KH, D, Dv) in enumerate(shapes or WIDE_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            name = dtype_name(dt)
            q, k, v = attn_inputs(torch, B, S, H, KH, D, dt, dev, 700 + i,
                                  dv=Dv)
            do = output_grad(torch, (B, S, H, Dv), dt, dev, 750 + i)
            for causal in (True, False):
                case = f"{B}x{S}x{H}x{KH} ({D}, {Dv}) {name} causal={causal}"
                try:
                    o = fa.launch(lib, q, k, v, causal=causal)
                    check(o.shape == (B, S, H, Dv) and o.dtype == dt,
                          f"output {o.dtype} {tuple(o.shape)}")
                    o2, lse = fa.launch(lib, q, k, v, causal=causal,
                                        with_lse=True)
                    check(torch.equal(o, o2), f"the output with the "
                          f"log-sum-exp differs from the serving call's, "
                          f"{case}")
                    del o2
                    plain_o, plain_lse = ref.flash_attention_fwd_lse(
                        q, k, v, causal=causal)
                    err = max(close(torch, o, plain_o, ATTN_TOL[name],
                                    f"output, {case}"),
                              close(torch, lse, plain_lse, ATTN_TOL[name],
                                    f"log-sum-exp, {case}"))
                    del plain_o, plain_lse
                    if dt == torch.bfloat16:
                        rel[case] = tight(torch, ref, o, q, k, v, causal,
                                          case)
                    errs[name] = max(errs.get(name, 0.0), err)
                    grads = ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                    causal=causal)
                    exp = plain_bwd(torch, ref, q, k, v, o, lse, do,
                                    causal=causal)
                    for gname, g, e in zip(("dq", "dk", "dv"), grads, exp):
                        check(g.dtype == dt and g.shape == e.shape,
                              f"{gname} {g.dtype} {tuple(g.shape)}: {case}")
                        bwd_errs[name] = max(bwd_errs.get(name, 0.0), close(
                            torch, g, e, ATTN_TOL[name],
                            f"{gname} of the backward, {case}"))
                    del exp
                    if dt == torch.bfloat16:
                        bwd_rel[case] = held(
                            bwd_rel_l2(torch, ref, grads, q, k, v, o, lse,
                                       do, causal),
                            ATTN_BWD_BF16_REL_L2, f"the backward, {case}")
                    del o, lse, grads
                except SmokeFailure as e:
                    failed[case] = str(e)[:300]
                run.append([B, S, H, KH, D, Dv, name, causal])
                torch.cuda.empty_cache()
            del q, k, v, do
    torch.cuda.synchronize()
    if failed:
        raise CaseFailures(f"phase 32 ({len(run)} cases)", failed)
    log(f"phase 32: flash_attention and flash_attention_bwd at (q.k, v) = "
        f"(192, 128) == plain on {len(run)} cases (B,S,H,KH,Dqk,Dv) in "
        f"{shapes or WIDE_SHAPES}, bf16 and f32, causal and not: max abs err "
        f"forward {errs}, backward {bwd_errs} (tol {ATTN_TOL}, TF32 off); "
        f"bf16 vs the f32 computation of its inputs, relative L2 forward "
        f"{rel} (limit {ATTN_BF16_REL_L2}), backward {bwd_rel} (limit "
        f"{ATTN_BWD_BF16_REL_L2})")
    return errs, run, max(rel.values()), bwd_errs, max(bwd_rel.values())


def moe_f32_routes(torch, cfg, params, tokens, dev):
    """f32 at depth ``ROUTE_DEPTH``, kernel route against plain route on
    ``tokens``: first every token's experts and kept slots the same on
    both routes (a flip fails, naming the smallest top-k margin), then the
    logits within ``F32_LOGIT_ATOL``."""
    from repro_torch.models.transformer import forward_logits

    cut, p2 = first_layers(cfg, params, ROUTE_DEPTH)
    cut = cut.with_(compute_dtype=torch.float32)
    batch = {"tokens": tokens}
    with recorded_routes(torch, margins=True) as kr:
        kern = forward_logits(cut, p2, batch, device=dev, use_kernel=True)
    with recorded_routes(torch, margins=True) as pr:
        plain = forward_logits(cut, p2, batch, device=dev, use_kernel=False)
    margin = min(r["margin"] for r in kr + pr)
    flips = flipped_share(kr, pr)
    same_keep = all(torch.equal(a["keep"], b["keep"]) for a, b in
                    zip(kr, pr))
    check(len(kr) == len(pr) == moe_layers(cut) and not any(flips)
          and same_keep,
          f"f32 {cfg.name} depth {ROUTE_DEPTH}: the kernel and plain routes "
          f"chose other experts for a share {flips} of the choices (slots "
          f"kept alike: {same_keep}); smallest top-k margin {margin:.3e}")
    diff = logit_diff(torch, kern, plain, "f32 depth 2")
    del kern, plain
    check(diff["max_abs"] <= F32_LOGIT_ATOL,
          f"f32 {cfg.name} depth {ROUTE_DEPTH}, kernel vs plain route: "
          f"{diff} (limit {F32_LOGIT_ATOL} abs)")
    return {"tokens": list(tokens.shape), "depth": ROUTE_DEPTH,
            "moe_layers": len(kr), "flipped": flips,
            "smallest_topk_margin": margin, "logits": diff}


def phase_moe_serving(torch, ops, ref, dev, seed, arch, phase):
    """33, 34: ``arch`` at full width, cut to ``MOE_SERVE_CUT[arch]``
    layers, random weights from ``seed``. The prefill's main path,
    ``make_prefill_step`` on 2 x 4096 tokens (one warm-up; the counted
    call, the attention count set to 0 just before it and read just
    after: one launch a layer), the share of token choices capacity
    dropped in each MoE layer, one profiled prefill (device time by
    :func:`moe_op_kind`); the routes: bf16 at the cut depth against the
    f32 plain route (logits by ``BF16_ROUTE_RATIO``, the share of choices
    routed apart), f32 at depth 2 (:func:`moe_f32_routes`); ``generate``
    at the serve defaults (:func:`phase_serve`, the replay against the
    forward at :func:`moe_replay_capacity`, whose forward must drop
    nothing). Frees the weights, then holds the
    prefill's first attention call against its plain version and by the
    tight check. Returns the row and that call."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.transformer import forward_logits, init_params

    full = get_config(arch)
    cfg = full.with_(n_layers=MOE_SERVE_CUT[arch])
    torch.cuda.empty_cache()
    params = init_params(seed, cfg, device=dev)
    weights_gib = sum(t.nbytes for t in tree_leaves(params)) / 2**30
    g = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=g).to(dev)
    batch = {"tokens": tokens}
    expect = {"flash_attention": cfg.n_layers}
    step = make_prefill_step(cfg, device=dev)
    step(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with first_calls(ops, ("flash_attention",)) as seen, \
            recorded_routes(torch) as routes:
        ops.LAUNCHES["flash_attention"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {"flash_attention": ops.LAUNCHES["flash_attention"]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launches == expect,
          f"one {cfg.name} prefill launched {launches}; expected {expect}")
    check(logits.shape == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(len(routes) == moe_layers(cfg),
          f"{len(routes)} MoE layers routed, expected {moe_layers(cfg)}")
    dropped = [1.0 - float(r["keep"].float().mean()) for r in routes]
    with tempfile.TemporaryDirectory() as tmp:   # a trace passes 64 MiB
        profile = profile_step(torch, lambda: step(params, batch),
                               Path(tmp), kind=moe_op_kind)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recorded_routes(torch) as plain_routes:
        plain = forward_logits(cfg, params, batch, device=dev,
                               use_kernel=False)
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    agree = {"bf16_kernel_vs_plain": logit_diff(torch, logits, plain,
                                                        "bf16")}
    cfg32 = cfg.with_(compute_dtype=torch.float32)
    with recorded_routes(torch) as exact_routes:
        exact = forward_logits(cfg32, params, batch, device=dev,
                               use_kernel=False)
    agree["bf16_plain_vs_f32"] = logit_diff(torch, plain, exact,
                                                    "bf16 plain")
    del plain
    agree["bf16_kernel_vs_f32"] = logit_diff(torch, logits, exact,
                                                     "bf16")
    del logits, exact
    flips = {"bf16_kernel_vs_plain": flipped_share(routes, plain_routes),
             "bf16_kernel_vs_f32": flipped_share(routes, exact_routes),
             "bf16_plain_vs_f32": flipped_share(plain_routes, exact_routes)}
    del routes, plain_routes, exact_routes
    ratio = (agree["bf16_kernel_vs_f32"]["rel_l2"]
             / agree["bf16_plain_vs_f32"]["rel_l2"])
    check(ratio <= BF16_ROUTE_RATIO,
          f"bf16 {cfg.name} prefill: the kernel route lies {ratio} x as far "
          f"from f32 as the plain route (limit {BF16_ROUTE_RATIO}): {agree}")
    torch.cuda.empty_cache()
    f32 = moe_f32_routes(torch, cfg, params,
                         tokens[:ROUTE_BATCH, :ROUTE_TOKENS], dev)
    torch.cuda.empty_cache()
    replay_cfg = cfg.with_(capacity_factor=moe_replay_capacity(cfg))
    with recorded_routes(torch) as serve_routes:
        serve = phase_serve(torch, ops, dev, cfg, params, seed, expect,
                            phase, MOE_BF16_REPLAY_REL_L2, replay_cfg)
    # phase_serve's last forward: the f32 one the f32 replay is held to
    replay_dropped = [1.0 - float(r["keep"].float().mean())
                      for r in serve_routes[-moe_layers(cfg):]]
    del serve_routes
    serve.update(capacity_factor=replay_cfg.capacity_factor,
                 forward_dropped_share_by_layer=replay_dropped)
    check(not any(replay_dropped), f"the replay's f32 forward at capacity "
          f"factor {replay_cfg.capacity_factor} dropped {replay_dropped}")
    del params, step
    torch.cuda.empty_cache()
    (q, k, v), kw, out = seen["flash_attention"]
    check(q.dtype == torch.bfloat16, f"prefill attention in {q.dtype}")
    err = close(torch, out, ref.flash_attention(q, k, v, **kw),
                ATTN_TOL[dtype_name(q.dtype)], "prefill's first attention "
                f"call, {arch}")
    call_rel = tight(torch, ref, out, q, k, v, kw.get("causal", True),
                     f"phase {phase}: the prefill's first attention call")
    torch.cuda.empty_cache()
    tok_s = PREFILL_BATCH * PREFILL_LEN / secs
    row = {"arch": arch, "layers": cfg.n_layers, "of_layers": full.n_layers,
           "params": cfg.param_count(), "weights_gib": weights_gib,
           "capacity": {"factor": cfg.capacity_factor},
           "prefill": {"tokens": [PREFILL_BATCH, PREFILL_LEN], "secs": secs,
                       "tokens_per_s": tok_s, "plain_secs": plain_secs,
                       "peak_gib": peak, "launches": launches,
                       "dropped_share_by_layer": dropped,
                       "profile": profile},
           "attention_call": [list(q.shape), int(k.shape[2]),
                              int(v.shape[3])],
           "attn_max_abs_err": err, "attn_rel_l2": call_rel,
           "bf16_routes": {"logits": agree, "ratio": ratio,
                           "flipped_share_by_layer": flips},
           "f32_routes": f32, "serve": serve, "card": card_name_power()}
    log(f"phase {phase}: {arch} full width, {cfg.n_layers} of "
        f"{full.n_layers} layers ({cfg.param_count():,} params, "
        f"{weights_gib:.2f} GiB of f32 weights) on {row['card']}: prefill "
        f"of {PREFILL_BATCH} x {PREFILL_LEN} tokens {secs:.4f} s "
        f"({tok_s:.0f} tokens/s), launches {launches}, peak memory "
        f"{peak:.2f} GiB; choices dropped by capacity (factor "
        f"{cfg.capacity_factor}) by MoE layer {dropped}; plain route on the "
        f"card {plain_secs:.4f} s; one profiled prefill: span "
        f"{profile['span_ms']:.2f} ms, device busy "
        f"{profile['device_busy_ms']:.2f} ms, idle share "
        f"{profile['idle_share']:.4f}, ms by op {profile['by_kind_ms']}; "
        f"bf16 logits {agree}, route ratio {ratio} (limit "
        f"{BF16_ROUTE_RATIO}), share of choices routed apart by layer "
        f"{flips}; f32 at depth {ROUTE_DEPTH} on {f32['tokens']} tokens: "
        f"the same experts on both routes (smallest top-k margin "
        f"{f32['smallest_topk_margin']:.3e}), logits {f32['logits']}; "
        f"serving at capacity factor {cfg.capacity_factor}, the replay at "
        f"{replay_cfg.capacity_factor} (its forward dropped "
        f"{replay_dropped}); the "
        f"first attention call (q, KV heads, v width "
        f"{row['attention_call']}) == plain, max abs err {err}, vs f32 "
        f"relative L2 {call_rel} (limit {ATTN_BF16_REL_L2})")
    return row, seen


def moe_grad_routes(torch, cfg, params, batch, dev, what):
    """f32 (TF32 off) ``loss_fn``'s loss and every gradient leaf of ``cfg``
    on ``batch``, no optimizer, by autograd on the kernel route (the
    attention forward twice a layer under remat, its backward once,
    counted) against the plain route (none launched): each route's MoE
    layers recorded (:func:`recorded_routes`), every token's experts and
    kept slots the same on both (a flip fails, naming the smallest top-k
    margin); the loss within ``F32_LOSS_RTOL``, every leaf within
    ``F32_GRAD_REL_L2``; the routers' aux loss above 0 and each router's
    gradient not zero on both; the first backward call against its plain
    version. Returns the readings."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    from repro_torch.kernels import ops, ref
    from repro_torch.models.transformer import loss_fn

    leaves, spec = tree_flatten(params)
    n_moe = moe_layers(cfg)
    router = [i for i, t in enumerate(leaves)
              if t.shape == (cfg.d_model, cfg.n_experts)]
    check(len(router) == n_moe >= 1, f"router leaves {router}")
    want = attention_step_plan(cfg)
    out = {}
    for use_kernel in (True, False):
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with first_calls(ops, ("flash_attention_bwd",)) as seen, \
                recorded_routes(torch, margins=True) as routes:
            before = {n: ops.LAUNCHES[n] for n in want}
            loss, metrics = loss_fn(cfg, tree_unflatten(leaves, spec), batch,
                                    device=dev, use_kernel=use_kernel)
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            launches = {n: ops.LAUNCHES[n] - before[n] for n in want}
        out[use_kernel] = {"loss": float(loss.detach()),
                           "ce": float(metrics["ce"].detach()),
                           "aux": float(metrics["aux"].detach()),
                           "grads": grads, "launches": launches,
                           "seen": seen, "routes": routes[:n_moe]}
        del loss, metrics
    kern, plain = out[True], out[False]
    check(kern["launches"] == want
          and plain["launches"] == dict.fromkeys(want, 0),
          f"{what}: launches: kernel route {kern['launches']} (expected "
          f"{want}), plain route {plain['launches']}")
    margin = min(r["margin"] for r in kern["routes"] + plain["routes"])
    flips = flipped_share(kern["routes"], plain["routes"])
    same_keep = all(torch.equal(a["keep"], b["keep"])
                    for a, b in zip(kern["routes"], plain["routes"]))
    check(len(kern["routes"]) == len(plain["routes"]) == n_moe
          and not any(flips) and same_keep,
          f"{what}: the kernel and plain routes chose other experts for a "
          f"share {flips} of the choices (slots kept alike: {same_keep}); "
          f"smallest top-k margin {margin:.3e}")
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    diff = grad_diff(torch, kern["grads"], plain["grads"])
    router_norm = {r: [float(out[r]["grads"][i].norm()) for i in router]
                   for r in (True, False)}
    check(loss_rel <= F32_LOSS_RTOL and diff["worst_leaf_rel_l2"]
          <= F32_GRAD_REL_L2,
          f"{what}, kernel vs plain route: loss rel {loss_rel}, gradients "
          f"{diff} (limits {F32_LOSS_RTOL} loss, {F32_GRAD_REL_L2} a leaf)")
    check(kern["aux"] > 0 and plain["aux"] > 0
          and all(n > 0 for ns in router_norm.values() for n in ns),
          f"{what}: aux {kern['aux']} / {plain['aux']}, router gradient "
          f"norms {router_norm}")
    (q, k, v, o, lse, do), kw, got = kern["seen"]["flash_attention_bwd"]
    exp = plain_bwd(torch, ref, q, k, v, o, lse, do, **kw)
    err = max(close(torch, gr, e, ATTN_TOL[dtype_name(q.dtype)],
                    f"{what}: the first backward call, {n}")
              for n, gr, e in zip(("dq", "dk", "dv"), got, exp))
    row = {"tokens": list(batch["tokens"].shape), "layers": cfg.n_layers,
           "moe_layers": n_moe, "loss": kern["loss"], "ce": kern["ce"],
           "aux": kern["aux"], "plain_loss": plain["loss"],
           "loss_rel": loss_rel, "grads": diff,
           "router_grad_norm": router_norm[True], "flipped": flips,
           "smallest_topk_margin": margin, "launches": kern["launches"],
           "bwd_call": [list(q.shape), int(k.shape[2]), int(v.shape[3])],
           "bwd_max_abs_err": err}
    del out, kern, plain, leaves, exp, got
    torch.cuda.empty_cache()
    return row


def phase_moe_grads(torch, ops, ref, dev, seed):
    """35: one full-width llama4-scout-17b-a16e MoE layer in f32 (TF32 off)
    on 1 x ``MOE_GRAD_TOKENS`` tokens, no optimizer: both routes' loss,
    gradients and routing by :func:`moe_grad_routes` (the first backward
    call: GQA, 40 query heads over 8)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = get_config(MOE_GRAD_ARCH).with_(n_layers=1,
                                          compute_dtype=torch.float32)
    torch.cuda.empty_cache()
    params = init_params(seed + 3, cfg, device=dev)
    g = torch.Generator(device="cpu").manual_seed(seed + 4)
    toks = torch.randint(0, cfg.vocab_size, (1, MOE_GRAD_TOKENS + 1),
                         generator=g).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    torch.cuda.reset_peak_memory_stats()
    row = {"arch": cfg.name, "params": cfg.param_count(),
           **moe_grad_routes(torch, cfg, params, batch, dev, "phase 35")}
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    row["card"] = card_name_power()
    del params
    torch.cuda.empty_cache()
    log(f"phase 35: {cfg.name} full width, one MoE layer ("
        f"{cfg.param_count():,} params with the embedding) in f32 on 1 x "
        f"{MOE_GRAD_TOKENS} tokens on {row['card']}: loss {row['loss']} (ce "
        f"{row['ce']}, aux {row['aux']}), kernel vs plain route: the same "
        f"experts (smallest top-k margin {row['smallest_topk_margin']:.3e}), "
        f"loss rel {row['loss_rel']}, gradients {row['grads']} (limits "
        f"{F32_LOSS_RTOL}, {F32_GRAD_REL_L2} a leaf); router gradient norm "
        f"{row['router_grad_norm']}; launches {row['launches']}; the first "
        f"backward call (q, KV heads, v width {row['bwd_call']}) == plain, "
        f"max abs err {row['bwd_max_abs_err']}; peak memory "
        f"{row['peak_gib']:.2f} GiB")
    return row


def phase_kernel_timing(torch, ops, ref, prefills, steps, l2_bytes,
                        phase):
    """36, 40, 42: both attention kernels on the inputs the prefills
    (``prefills``: each arch's first forward call) and train steps
    (``steps``: each first backward call) gave them, as phase 31 times the
    dense archs' (:func:`prefill_forward_rows`,
    :func:`train_backward_rows`)."""
    rows = {**prefill_forward_rows(torch, ops, ref, prefills, l2_bytes),
            **train_backward_rows(torch, ops, ref, steps, l2_bytes)}
    card = card_name_power()
    for name, row in rows.items():
        row["card"] = card
        log_timing(phase, name, row)
    return rows

# ---------- the vision frontend and the codebook heads (phases 37-40)
# internvl2-2b attends at (128, 128) with GQA 16 over 8, musicgen-large
# at (64, 64) with 32 heads: widths both attention kernels are built for.
FRONTEND_ARCHS = ("internvl2-2b", "musicgen-large")
# Their train steps at full width, cut to (layers, batch rows of 4096
# positions) as DENSE_TRAIN_CUT's, at the 34.3 bytes a parameter AdamW's
# functional update peaked at in falcon-mamba-7b's step:
# - internvl2-2b at full depth, 24 layers (1,699,497,984 parameters, 58.3
#   GB), on 4 x 4096: its tied 92,553-token head makes 3.0 GB of bf16
#   logits and 6.1 GB each f32 copy that cross-entropy and its gradient
#   hold, about 18 GB beside the 58 of the update, of the card's 85 GB;
# - musicgen-large: that rate gives 84.0 GB for all 48 layers
#   (2,449,473,536 parameters) and 56.4 GB for 32 (1,644,167,168); its
#   four 2,048-token heads make only 0.27 GB of bf16 logits. On an H100
#   80GB HBM3 (700 W) its step at 32 layers peaked at 49.63 GiB and at all
#   48 at 73.63 GiB (32.3 bytes a parameter) of the card's 79.1, so it
#   runs at full depth on 4 x 4096; internvl2-2b's step peaked at 51.31
#   GiB there.
FRONTEND_TRAIN_CUT = {"internvl2-2b": (24, TRAIN_BATCH),
                      "musicgen-large": (48, TRAIN_BATCH)}


# ------------------ deepseek-v2-236b's train step (phases 41-42)
# Its AdamW step at full width, cut to (layers, batch rows of 4096
# positions). AdamW's f32 parameters, gradients, m and v take 16 bytes a
# parameter before any transient; falcon-mamba-7b's step peaked at 34.3
# bytes a parameter, musicgen-large's at 32.3 (H100 80GB HBM3):
# - its dense first layer with the tied 102,400 x 5,120 embedding:
#   862,257,152 parameters, 13.80 GB steady (16 bytes), about 30 GB at the
#   update, plus the 4 x 4096 x 102,400 logits (3.4 GB in bf16, 6.7 GB
#   each f32 copy that cross-entropy and its gradient hold): under 50 GB
#   of the card's 85;
# - with its first MoE layer (3,972,104,192 parameters: 160 experts of 3 x
#   5120 x 1536, 2 shared, the router, MLA with 128 heads): 4,834,361,344
#   parameters, 77.3 GB steady, and no step over a full-width MoE layer
#   fits one card (llama4-scout-17b-a16e's one layer 3,236,577,280, 51.8
#   GB steady, about 110 GB at the update).
# So the step trains the dense layer; the f32 routes run at depth 2 (the
# dense layer and the first MoE layer, 19.3 GB of f32 weights and as much
# again for each route's gradients, no optimizer) on 2 x 1024 tokens.
MOE_TRAIN_CUT = {"deepseek-v2-236b": (1, TRAIN_BATCH)}
MOE_TRAIN_ARCH = "deepseek-v2-236b"


# ------------------------------------ scan training (phases 21-25)
SSD_BWD_SOURCE = "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu"
SCAN_BWD_SOURCE = "src/repro_torch/kernels/csrc/selective_scan_bwd.cu"
# no Pallas kernel: the reference differentiates its chunked SSD and its
# lax.scan with jax.grad
SSD_BWD_REPLACES = "src/repro/models/mamba.py:161"
SCAN_BWD_REPLACES = "src/repro/models/mamba.py:84"
# B, S, nh, hd, ds, dt shift: S below, at and past one 64-step chunk, the
# three ds the library is built for, and rows of 4096 (slow decay too) and
# 4000 (a ragged last chunk)
SSD_BWD_SHAPES = [(1, 1, 4, 64, 16, 0.0), (2, 63, 8, 64, 64, 0.0),
                  (1, 64, 4, 64, 128, 0.0), (2, 65, 8, 64, 16, 0.0),
                  (1, 4096, 4, 64, 64, 0.0),
                  (1, 4096, 4, 64, 64, SLOW_DT_SHIFT),
                  (1, 4000, 2, 64, 128, SLOW_DT_SHIFT)]
# B, S, di, ds, dt shift: S as above, ds 8 and 16, di not a multiple of
# the kernel's 32 channels (96, 100), a ragged last tile (4095)
SCAN_BWD_SHAPES = [(1, 1, 96, 16, 0.0), (2, 63, 96, 8, 0.0),
                   (1, 64, 512, 16, 0.0), (2, 65, 100, 16, 0.0),
                   (1, 4096, 512, 16, 0.0),
                   (1, 4096, 512, 16, SLOW_DT_SHIFT),
                   (2, 4095, 256, 8, 0.0)]
# The tight checks of the scan backward kernels: each gradient's relative
# L2 distance from the f32 backward (the plain version) of the same inputs
# and output gradient. Both kernels compute in f32 and round each bf16
# gradient once; on an H100 (phases 21 and 23) their bf16 gradients read
# 1.51e-3 to 2.04e-3 (dx, dB, dC, the scan's ddt) and their f32 ones at
# most 2.7e-5 (the SSD's dA). Every planted fault (chip_faults.py) fails
# phase 21 or 23. The bf16 limit holds gradients of at least
# TIGHT_MIN_SIZE entries: the rounding of a handful of values need not
# average out (dB and dC at S = 1 hold 16).
SCAN_BWD_BF16_REL_L2 = 2.2e-3
SCAN_BWD_F32_REL_L2 = 1e-4
TIGHT_MIN_SIZE = 1024
SSD_BWD_NAMES = ("dx", "dBm", "dCm", "ddt", "dA")
SCAN_BWD_NAMES = ("dx", "ddt", "dBm", "dCm", "dA", "dD")
# The gradients of A and D sum a term of every (batch, step): the plain
# version and the kernel add 4,096 and more f32 terms in other orders, so
# the elementwise 1e-4 of the JAX package's tolerances, set for one output
# of the scan, does not hold them (on an H100 the selective scan's f32 dA
# missed it at S = 4096), while their relative L2 distance stays far below
# SCAN_BWD_F32_REL_L2. These two are held by that relative L2 alone; the
# per-step gradients also elementwise at the JAX package's tolerances.
SUMMED_GRADS = ("dA", "dD")
# falcon-mamba-7b's train step at full width keeps 16 of its 64 layers:
# AdamW's f32 parameters, gradients and two moments take 16 bytes a
# parameter, 112 GB for all 7,005,536,256, about 31 GB at 16 layers
FALCON_TRAIN_DEPTH = 16
# least float32 operations a (batch, step, channel, state) of the scan's
# backward besides its exponential: the state's recurrence (the decay's
# argument, the update's product and multiply-add), g's multiply-add and
# decay, and the terms of dx, ddt (three), dB, dC and dA
SCAN_BWD_FLOPS_PER_EXP = 12


def grad_readings(torch, grads, exact, names):
    """Each gradient's relative L2 distance from ``exact`` (float32), by
    name: 0 where both are zero, inf where only ``exact`` is."""
    out = {}
    for name, g, e in zip(names, grads, exact):
        num = float((g.float() - e.float()).norm())
        den = float(e.float().norm())
        out[name] = num / den if den > 0 else (0.0 if num == 0 else math.inf)
    return out


def hold_grads(torch, grads, exact, names, what):
    """The tight check of a backward call: bf16 gradients of at least
    ``TIGHT_MIN_SIZE`` entries within ``SCAN_BWD_BF16_REL_L2`` of the f32
    backward of the same inputs, f32 gradients within
    ``SCAN_BWD_F32_REL_L2``; returns the readings (a NaN fails)."""
    rel = grad_readings(torch, grads, exact, names)
    for name, g in zip(names, grads):
        if g.dtype == torch.bfloat16:
            if g.numel() >= TIGHT_MIN_SIZE:
                held({name: rel[name]}, SCAN_BWD_BF16_REL_L2, what)
        else:
            held({name: rel[name]}, SCAN_BWD_F32_REL_L2, what)
    return rel


def output_grad(torch, shape, dtype, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype).to(dev)


class CaseFailures(SmokeFailure):
    """A phase's cases that failed: ``cases`` maps each one's name to its
    failure."""

    def __init__(self, phase, cases):
        self.cases = cases
        first = next(iter(cases.values()))
        super().__init__(f"{phase} failed on {len(cases)} cases "
                         f"{list(cases)}; the first: {first}")


def phase_ssd_bwd_vs_plain(torch, ops, ref, dev):
    """21: the SSD backward kernel against its plain version on the same
    inputs, output gradient and (for the kernel) the forward kernel's
    chunk states, bf16 and f32: the per-step gradients at the JAX
    package's SSD tolerances, and every gradient by the tight check
    against the f32 backward of the same inputs (the plain version
    computes in f32), dA (``SUMMED_GRADS``) by that alone. In bf16 the
    carry pass alone against ``ref.ssd_chunk_bwd_carry``: elementwise at
    the f32 SSD tolerance and by ``SCAN_BWD_F32_REL_L2``. Every case runs;
    a failure (``CaseFailures``) names each case that failed."""
    from repro_torch.kernels import ssd_chunk as sc

    fwd = ops.load_library("ssd_chunk")
    bwd = ops.load_library("ssd_chunk_bwd")
    errs, rel, shapes, failed = {}, {}, [], {}
    for i, (B, S, nh, hd, ds, shift) in enumerate(SSD_BWD_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            name = dtype_name(dt)
            case = f"{B}x{S}x{nh}x{hd}x{ds} shift {shift} {name}"
            args = ssd_inputs(torch, B, S, nh, hd, ds, dt, dev, 500 + i,
                              shift)
            dy = output_grad(torch, (B, S, nh, hd), dt, dev, 600 + i)
            what = f"ssd backward B={B} S={S} nh={nh} hd={hd} ds={ds} dt " \
                   f"shift {shift} {name}"
            try:
                if dt == torch.bfloat16:
                    carry = sc.launch_carry(bwd, args[2], args[3], args[4],
                                            dy)
                    exact = ref.ssd_chunk_bwd_carry(args[2], args[3],
                                                    args[4], dy)
                    errs["carry"] = max(errs.get("carry", 0.0), close(
                        torch, carry, exact, SSD_TOL["float32"],
                        f"the carry pass, {what}"))
                    rel[f"{case} carry"] = hold_grads(
                        torch, [carry], [exact], ["carry"],
                        f"the carry pass, {what}")
                    del carry, exact
                _, states = sc.launch(fwd, *args, with_states=True)
                grads = ops.ssd_chunk_bwd(*args, dy, states)
                exact = ref.ssd_chunk_bwd(*(a.float() for a in args),
                                          dy.float())
                for gname, g, e, a in zip(SSD_BWD_NAMES, grads, exact, args):
                    want = a.dtype if gname in ("dx", "dBm", "dCm") else \
                        torch.float32
                    check(g.dtype == want and g.shape == a.shape,
                          f"{gname} {g.dtype} {tuple(g.shape)}: {what}")
                    if gname not in SUMMED_GRADS:
                        errs[name] = max(errs.get(name, 0.0), close(
                            torch, g, e, SSD_TOL[name], f"{gname}, {what}"))
                rel[case] = hold_grads(torch, grads, exact, SSD_BWD_NAMES,
                                       what)
                del grads, exact, states
            except SmokeFailure as err:
                failed[case] = str(err)
            shapes.append([B, S, nh, hd, ds, shift, name])
    torch.cuda.synchronize()
    if failed:
        raise CaseFailures("phase 21", failed)
    log(f"phase 21: ssd_chunk_bwd kernel == plain (the reverse recurrence) "
        f"on {len(shapes)} cases (B,S,nh,hd,ds,dt shift) in "
        f"{SSD_BWD_SHAPES}, bf16 and f32, B and C strided; the bf16 carry "
        f"pass == plain: max abs err {errs} (tol {SSD_TOL}); each gradient "
        f"vs the f32 backward of its inputs, relative L2 {rel} (limits "
        f"{SCAN_BWD_BF16_REL_L2} bf16 from {TIGHT_MIN_SIZE} entries, "
        f"{SCAN_BWD_F32_REL_L2} f32)")
    carry_err = errs.pop("carry")
    return errs, shapes, rel, carry_err


def phase_scan_bwd_vs_plain(torch, ops, ref, dev):
    """23: the selective-scan backward kernel against its plain version,
    as phase 21."""
    from repro_torch.kernels import selective_scan as ss

    fwd = ops.load_library("selective_scan")
    errs, rel, shapes = {}, {}, []
    for i, (B, S, di, ds, shift) in enumerate(SCAN_BWD_SHAPES):
        for dt in (torch.bfloat16, torch.float32):
            name = dtype_name(dt)
            args = scan_inputs(torch, B, S, di, ds, dt, dev, 700 + i, shift)
            dy = output_grad(torch, (B, S, di), dt, dev, 800 + i)
            what = f"selective_scan backward B={B} S={S} di={di} ds={ds} " \
                   f"dt shift {shift} {name}"
            _, states = ss.launch(fwd, *args, with_states=True)
            grads = ops.selective_scan_bwd(*args, dy, states)
            exact = ref.selective_scan_bwd(*(a.float() for a in args),
                                           dy.float())
            for gname, g, e, a in zip(SCAN_BWD_NAMES, grads, exact, args):
                want = torch.float32 if gname in ("dA", "dD") else a.dtype
                check(g.dtype == want and g.shape == a.shape,
                      f"{gname} {g.dtype} {tuple(g.shape)}: {what}")
                if gname not in SUMMED_GRADS:
                    errs[name] = max(errs.get(name, 0.0), close(
                        torch, g, e, SCAN_TOL[name], f"{gname}, {what}"))
            rel[f"{B}x{S}x{di}x{ds} shift {shift} {name}"] = hold_grads(
                torch, grads, exact, SCAN_BWD_NAMES, what)
            shapes.append([B, S, di, ds, shift, name])
            del grads, exact, states
    torch.cuda.synchronize()
    log(f"phase 23: selective_scan_bwd kernel == plain (the reverse "
        f"recurrence) on {len(shapes)} cases (B,S,di,ds,dt shift) in "
        f"{SCAN_BWD_SHAPES}, bf16 and f32, B and C strided: max abs err "
        f"{errs} (tol {SCAN_TOL}); each gradient vs the f32 backward of its "
        f"inputs, relative L2 {rel} (limits {SCAN_BWD_BF16_REL_L2} bf16 "
        f"from {TIGHT_MIN_SIZE} entries, {SCAN_BWD_F32_REL_L2} f32)")
    return errs, shapes, rel


def scan_step_plan(cfg, arch):
    """The scan kernel pair of ``arch``, and the launches a train step
    must make: each scan layer's forward twice (the step and the remat
    recompute) and its backward once; zamba2's shared attention block,
    not rematerialised, once each way an invocation."""
    if arch == "zamba2-1.2b":
        n_attn = cfg.n_layers // cfg.attn_every
        return ("ssd_chunk", "ssd_chunk_bwd"), {
            "ssd_chunk": 2 * cfg.n_layers, "ssd_chunk_bwd": cfg.n_layers,
            "flash_attention": n_attn, "flash_attention_bwd": n_attn}
    return ("selective_scan", "selective_scan_bwd"), {
        "selective_scan": 2 * cfg.n_layers,
        "selective_scan_bwd": cfg.n_layers}


def phase_scan_train_step(torch, ops, ref, dev, seed, arch, phase):
    """22 (zamba2-1.2b, full width and depth) / 24 (falcon-mamba-7b, full
    width, ``FALCON_TRAIN_DEPTH`` layers): ``make_train_step(cfg,
    default_optimizer())`` on ``lm_batch`` at 4 x 4096, 3 steps, counts
    set to 0 just before each step and read just after; one profiled
    step; the first backward call of the scan held against its plain
    version (and by the tight check); then the routes: f32 (TF32 off) at
    depth 2, bf16 at the step's depth, on 2 x 1024 tokens (zamba2) or 2 x
    ``ROUTE_LEN`` (falcon: the plain Mamba1 route is a loop over time)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "falcon-mamba-7b":
        cfg = cfg.with_(n_layers=FALCON_TRAIN_DEPTH)
    (fwd, bwd), want = scan_step_plan(cfg, arch)
    torch.cuda.empty_cache()   # the last phase's cached blocks
    losses, secs, launches, peak, profile, seen = train_steps(
        torch, ops, cfg, dev, seed, want, bwd)

    args, _, grads = seen[bwd]
    names = SSD_BWD_NAMES if fwd == "ssd_chunk" else SCAN_BWD_NAMES
    check(args[0].dtype == torch.bfloat16 and args[0].shape[:2] == (
        TRAIN_BATCH, TRAIN_LEN),
        f"the {arch} step's backward call: {args[0].dtype} "
        f"{tuple(args[0].shape)}")
    plain = getattr(ref, bwd)
    exact = plain(*(a.float() for a in args[:-1]))   # f32 inside
    tol = SSD_TOL if fwd == "ssd_chunk" else SCAN_TOL
    err = max(close(torch, g, e, tol["bfloat16"],
                    f"the {arch} step's first backward call, {n}")
              for n, g, e in zip(names, grads, exact)
              if n not in SUMMED_GRADS)
    call_rel = hold_grads(torch, grads, exact, names,
                          f"phase {phase}: the first backward call")
    del exact
    torch.cuda.empty_cache()
    tok_s = TRAIN_BATCH * TRAIN_LEN / statistics.median(secs[1:])

    # the routes: f32 (TF32 off) at depth 2, bf16 at the step's depth
    route_len = ROUTE_TOKENS if arch == "zamba2-1.2b" else ROUTE_LEN
    f32, bf16, ratio = train_routes(torch, cfg, seed, dev, route_len)
    row = {"arch": arch, "params": cfg.param_count(), "layers": cfg.n_layers,
           "step_s": secs, "tokens_per_s": tok_s, "peak_gib": peak,
           "profile": profile, "losses": losses, "launches": launches,
           "max_abs_err": err, "call_rel_l2": call_rel,
           "f32_routes": f32, "bf16_routes": bf16, "bf16_route_ratio": ratio,
           "route_tokens": [ROUTE_BATCH, route_len],
           "card": card_name_power()}
    log(f"phase {phase}: {arch} full width, {cfg.n_layers} layers "
        f"({cfg.param_count():,} params) train steps (make_train_step, "
        f"AdamW, per-layer remat) on {TRAIN_BATCH} x {TRAIN_LEN} tokens on "
        f"{row['card']}: s a step {secs} ({tok_s:.0f} tokens/s over steps "
        f"2-{TRAIN_STEPS}), peak memory {peak:.2f} GiB, losses {losses}, "
        f"launches a step {launches}; one profiled step: span "
        f"{profile['span_ms']:.2f} ms, device busy "
        f"{profile['device_busy_ms']:.2f} ms, idle share "
        f"{profile['idle_share']:.4f}, {profile['device_ops']} device "
        f"operations, ms by layer {profile['by_kind_ms']}, top "
        f"{profile['top'][:5]}; the first {bwd} call == plain, max abs err "
        f"{err}, vs the f32 backward relative L2 {call_rel}; f32 depth "
        f"{ROUTE_DEPTH} on {ROUTE_BATCH} x {route_len}, kernel vs plain "
        f"route: {f32}; bf16 at depth {cfg.n_layers}: {bf16}, ratio {ratio} "
        f"(limit {BF16_ROUTE_RATIO})")
    return row, seen


def ssd_bwd_bound(x, Bm, Cm, dt, A, dy, chunk=64):
    """Least time of the SSD backward: x, dy, B, C, dt, A read and dx, dB,
    dC, ddt, dA written once at the HBM rate; the chunked form's nine
    products a chunk and head (C B^T, dy x^T, Dm^T dy, B K, E dt B, dy
    h0^T, E^T C, x K^T, C^T dy) at the peak rate of the dtype."""
    B, S, nh, hd = x.shape
    ds = Bm.shape[-1]
    nbytes = 2 * x.nbytes + dy.nbytes + 2 * (Bm.nbytes + Cm.nbytes) \
        + 2 * (dt.nbytes + A.nbytes)
    n_chunks = -(-S // chunk)
    flops = 2 * chunk * (chunk * (3 * ds + 2 * hd) + 4 * ds * hd) \
        * n_chunks * B * nh
    rate = BF16_FLOP_PER_S if x.element_size() == 2 else F32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_bwd_design_floor(x, Bm, Cm, dt, A, dy, states):
    """Least time of the two-pass bf16 design at the HBM rate (not the
    function's bound): the carry pass reads C, dt and dy and writes K
    (the states' size); the chunk-local pass reads x, dy, B, C, dt, the
    states and K and writes dx, ddt and dB and dC as f32 sums."""
    carry = Cm.nbytes + dt.nbytes + dy.nbytes + states.nbytes
    local = (x.nbytes + dy.nbytes + Bm.nbytes + Cm.nbytes + dt.nbytes
             + 2 * states.nbytes + x.nbytes + dt.nbytes + 2 * 4 * Bm.numel())
    return (carry + local) / HBM_BYTES_PER_S * 1e3


def scan_bwd_bound(x, dt, Bm, Cm, A, D, dy, sms, clock_hz):
    """Least time of the selective-scan backward: x, dt, dy, B, C, A, D
    read and dx, ddt, dB, dC, dA, dD written once at the HBM rate; one
    exponential per (batch, step, channel, state) on the special-function
    units, and ``SCAN_BWD_FLOPS_PER_EXP`` float32 operations around each
    at the peak rate."""
    nbytes = 2 * (x.nbytes + dt.nbytes + Bm.nbytes + Cm.nbytes + A.nbytes
                  + D.nbytes) + dy.nbytes
    B, S, di = x.shape
    exps = B * S * di * Bm.shape[-1]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(exps / (SFU_PER_CLOCK_PER_SM * sms * clock_hz),
                SCAN_BWD_FLOPS_PER_EXP * exps / F32_FLOP_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_scan_bwd_timing(torch, ops, ref, seen, l2_bytes, sms, clock_hz):
    """25: each scan backward kernel on the inputs its train step gave it
    (the first call, states included): the kernel (5 back-to-back calls a
    trial, median of 5 trials, two turns) and the plain version (1 call a
    trial, 3 trials, one turn: a sequential loop of several seconds)
    beside the bound (the SSD's also beside its design's byte floor); no
    single PyTorch call computes either gradient."""
    rows = {}
    for name, bound in (("ssd_chunk_bwd", ssd_bwd_bound),
                        ("selective_scan_bwd", scan_bwd_bound)):
        args, _, _ = seen[name]
        sets, cold = copies(args, l2_bytes)
        kernel, plain = getattr(ops, name), getattr(ref, name)
        runs = [cuda_ms(torch, kernel, sets, reps=5) for _ in range(2)]
        row = {"ms": statistics.median(runs), "ms_turns": runs,
               "plain_ms": cuda_ms(torch, lambda *a: plain(*a[:-1]),
                                   sets[:1], reps=1, trials=3),
               "library_ms": None}
        extra = (sms, clock_hz) if name == "selective_scan_bwd" else ()
        row["bound_ms"], row["bound_by"] = bound(*args[:-1], *extra)
        row.update(shape=list(args[0].shape),
                   ds=int(args[1 if name == "ssd_chunk_bwd" else 2].shape[-1]),
                   dtype=dtype_name(args[0].dtype), l2_cold=cold,
                   card=card_name_power())
        rows[name] = row
        log(f"phase 25: {name} at its train step's shape {row['shape']} "
            f"ds={row['ds']} {row['dtype']} on {row['card']}: kernel "
            f"{row['ms']:.5f} ms (turns {runs}), plain (sequential) "
            f"{row['plain_ms']:.5f} ms, no single PyTorch call computes it, "
            f"bound {row['bound_ms']:.6f} ms ({row['bound_by']})"
            + (f", the design's byte floor "
               f"{ssd_bwd_design_floor(*args):.6f} ms"
               if name == "ssd_chunk_bwd" else ""))
        del sets
    return rows


# ------------------------------ the dry-run against the card (phase 43)
# The H100_SXM spec is for this card: the name must hold "H100" and the
# card 132 SMs (the SXM5 part; the PCIe part has 114)
SPEC_SMS = 132
# no reading can pass the card's peak: a share above this is a fault of
# the count or of the spec, not a fast card
SHARE_LIMIT = 1.05
# the dry-run's peak of live bytes against the phase's
# max_memory_allocated; the measured peak also holds the copies of the
# first recorded call (first_calls) and the allocator's rounding
PEAK_RATIO = (0.5, 1.5)
# the cases whose count is also traced on fake CPU tensors: both routes
# must give the same count
CPU_TWINS = ("olmo-1b", "zamba2-1.2b")


def dryrun_case(label, cfg, mode, rows, length, measured_s, peak_gib,
                best_s=None):
    """One phase-43 case: ``cfg`` (cut as the phase ran it), the step's
    mode and (rows, positions), the phase's measured seconds (and its
    fastest step) and peak."""
    return {"label": label, "cfg": cfg, "mode": mode, "rows": rows,
            "len": length, "measured_s": measured_s,
            "best_s": measured_s if best_s is None else best_s,
            "measured_peak_gib": peak_gib}


def dryrun_train_case(label, cfg, row, rows=TRAIN_BATCH):
    """A train phase's row: its median step (steps 2 on), its fastest,
    and its peak."""
    return dryrun_case(label, cfg, "train", rows, TRAIN_LEN,
                       statistics.median(row["step_s"][1:]),
                       row["peak_gib"], min(row["step_s"][1:]))


def dryrun_prefill_case(label, cfg, row):
    """A prefill phase's row: its one timed forward and its peak."""
    return dryrun_case(label, cfg, "prefill", PREFILL_BATCH, PREFILL_LEN,
                       row["secs"], row["peak_gib"])


def dryrun_cases_from(rows):
    """The cases of phase 43's rows (the summary's ``dryrun`` entry), to
    run the phase again without the phases it reads."""
    from repro_torch.configs import get_config

    return [dryrun_case(r["label"], get_config(r["arch"]).with_(
        n_layers=r["layers"]), r["mode"], r["rows"], r["len"],
        r["measured_s"], r["measured_peak_gib"], r["best_s"])
        for r in rows]


def phase_dryrun(torch, ops, dev, cases):
    """43: ``launch/dryrun.py::trace_one`` of each case on fake tensors of
    the card (the config, cut and shape its phase ran), held against that
    phase's measured step: across each trace the memory allocated on the
    card and the kernels' launch counts (``LAUNCHES``, ``CAPTURED``) stay
    as they were; for ``CPU_TWINS`` the count on fake CPU tensors equals
    the card's; the roofline's share of the measured step
    (max(t_compute, t_memory) / measured) and the MFU (model FLOPs /
    (measured x peak)) are at most ``SHARE_LIMIT``; the dry-run's peak of
    live bytes lies within ``PEAK_RATIO`` of the phase's. Fails first if
    ``H100_SXM`` does not describe the card."""
    from repro_torch.configs.base import H100_SXM, InputShape
    from repro_torch.launch import dryrun

    props = torch.cuda.get_device_properties(dev)
    card = card_name_power()
    log(f"phase 43: {props.name}, {props.multi_processor_count} SMs, "
        f"{props.total_memory / 2**30:.2f} GiB; nvidia-smi: {card}; spec "
        f"H100_SXM {H100_SXM}")
    check("H100" in props.name and props.multi_processor_count == SPEC_SMS,
          f"H100_SXM does not describe the card {props.name} "
          f"({props.multi_processor_count} SMs, {card})")
    rows = []
    for case in cases:
        cfg = case["cfg"]
        shape = InputShape(f"{case['mode']}_{case['rows']}x{case['len']}",
                           case["len"], case["rows"], case["mode"])
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        counts0 = (dict(ops.LAUNCHES), dict(ops.CAPTURED))
        report, count = dryrun.trace_one(cfg, shape, dev)
        torch.cuda.synchronize()
        check(torch.cuda.memory_allocated(dev) == mem0
              and (dict(ops.LAUNCHES), dict(ops.CAPTURED)) == counts0,
              f"phase 43: the dry-run of {case['label']} allocated "
              f"{torch.cuda.memory_allocated(dev) - mem0} bytes or launched "
              f"a kernel ({counts0} -> {ops.LAUNCHES}, {ops.CAPTURED})")
        cpu_flops = None
        if case["label"] in CPU_TWINS:
            _, on_cpu = dryrun.trace_one(cfg, shape, "cpu")
            cpu_flops = on_cpu.dot_flops
            check(on_cpu.dot_flops == count.dot_flops
                  and on_cpu.flops_by_op == count.flops_by_op,
                  f"phase 43: {case['label']} counts {count.flops_by_op} "
                  f"on fake CUDA tensors, {on_cpu.flops_by_op} on fake CPU "
                  f"tensors")
        measured, best = case["measured_s"], case["best_s"]
        bound = max(report.t_compute, report.t_memory)
        share = bound / measured
        mfu = report.model_flops_total / (measured * H100_SXM.peak_flops)
        best_mfu = report.model_flops_total / (best * H100_SXM.peak_flops)
        est_gib = report.peak_mem_bytes / 2**30
        ratio = est_gib / case["measured_peak_gib"]
        row = {"label": case["label"], "arch": cfg.name,
               "layers": cfg.n_layers, "mode": case["mode"],
               "rows": case["rows"], "len": case["len"],
               "counted_tflop": count.dot_flops / 1e12,
               "model_tflop": report.model_flops_total / 1e12,
               "flops_by_op": count.flops_by_op, "cpu_flops": cpu_flops,
               "t_compute": report.t_compute, "t_memory": report.t_memory,
               "dominant": report.dominant, "measured_s": measured,
               "roofline_share": share, "mfu": mfu, "best_s": best,
               "best_roofline_share": bound / best, "best_mfu": best_mfu,
               "useful_ratio": report.useful_ratio,
               "est_peak_gib": est_gib,
               "argument_gib": report.argument_bytes / 2**30,
               "measured_peak_gib": case["measured_peak_gib"],
               "peak_ratio": ratio, "trace_s": count.trace_s}
        rows.append(row)
        log(f"phase 43: {case['label']} {case['mode']} {case['rows']} x "
            f"{case['len']} ({cfg.n_layers} layers): counted "
            f"{row['counted_tflop']:.4f} TFLOP, model "
            f"{row['model_tflop']:.4f} TFLOP; t_compute "
            f"{report.t_compute:.6f} s, t_memory {report.t_memory:.6f} s, "
            f"dominant {report.dominant}; measured {measured:.6f} s; "
            f"roofline_share {share:.4f}, mfu {mfu:.4f} (fastest step "
            f"{best:.6f} s: {bound / best:.4f}, {best_mfu:.4f}); estimated "
            f"peak "
            f"{est_gib:.2f} GiB (arguments {row['argument_gib']:.2f}) vs "
            f"measured max_memory_allocated "
            f"{case['measured_peak_gib']:.2f} GiB (x{ratio:.3f}); trace "
            f"{count.trace_s:.1f} s on {card}")
        check(max(share, mfu, bound / best, best_mfu) <= SHARE_LIMIT,
              f"phase 43: {case['label']} reads roofline_share {share}, "
              f"mfu {mfu} (fastest step {bound / best}, {best_mfu}; limit "
              f"{SHARE_LIMIT}): no card passes its peak")
        check(PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1],
              f"phase 43: {case['label']}'s estimated peak {est_gib:.2f} "
              f"GiB is x{ratio:.3f} the measured "
              f"{case['measured_peak_gib']:.2f} GiB (limits {PEAK_RATIO})")
    return {"card": card, "device": {
        "name": props.name, "sms": props.multi_processor_count,
        "total_memory": props.total_memory}, "spec": dataclasses.asdict(
            H100_SXM), "cases": rows}


# ------------------------------ the runtime sanitizers (phase 44)
SANITIZER_ROUNDS = 6               # 3 segments of checkpoint_every=2
SANITIZER_ASYNC = dict(buffer_size=4, max_concurrency=10)


def same_bits(a, b):
    """Two trees of tensors (dicts) equal bit for bit: names, shapes,
    dtypes and bytes."""
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].cpu().numpy().tobytes() == b[k].cpu().numpy().tobytes()
        for k in a)


def phase_sanitizers(torch, ops, dev, cfg):
    """44: the port's runtime sanitizers (``analysis/runtime.py``) on the
    fused engines at ``cfg`` (the FLConfig defaults, full width), under
    cuDNN's deterministic algorithms. ``run_fl_scanned`` and
    ``run_fl_async_scanned`` run ``cfg.rounds`` rounds in segments of 2
    under ``strict_mode(debug_nans=True)`` and ``retrace_guard``: one
    capture of "round" and of "eval" across the segments, the trajectory
    bitwise the unguarded uninterrupted run's, and the top-k launches one
    a replay plus the warm-up (and the async fill's). Then 3 rounds of a
    hand-built ``StepGraphs`` replay under
    ``torch.cuda.set_sync_debug_mode("error")``, and two planted faults
    must each be caught: a step that calls ``.item()`` under
    ``strict_mode``, and a second ``StepGraphs`` over the same step (two
    captures of "round")."""
    from repro_torch.analysis.runtime import (HostTransferError,
                                              retrace_guard, strict_mode)
    from repro_torch.federated import replay
    from repro_torch.federated.async_server import run_fl_async_scanned
    from repro_torch.federated.server import _fused_engine, run_fl_scanned

    row = {"card": card_name_power(), "rounds": cfg.rounds}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, run, c, eager in (
                ("run_fl_scanned", run_fl_scanned, cfg, 1),
                ("run_fl_async_scanned", run_fl_async_scanned,
                 dataclasses.replace(cfg, **SANITIZER_ASYNC), 2)):
            with graphs_made(replay) as made:
                plain = run(c, device=dev)
            plain_traj = {k: v.clone() for k, v in made[0].traj.items()}
            with tempfile.TemporaryDirectory() as tmp, \
                    graphs_made(replay) as made:
                seg = dataclasses.replace(
                    c, checkpoint_path=str(Path(tmp) / "s-{round}.ckpt"),
                    checkpoint_every=2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with strict_mode(debug_nans=True), \
                        retrace_guard(watch=("round", "eval")) as caps:
                    ops.LAUNCHES["topk_reward"] = 0
                    guarded = run(seg, device=dev)
                    launches = ops.LAUNCHES["topk_reward"]
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            captures = {s: caps.compiles_of(s) for s in ("round", "eval")}
            check(captures == {"round": 1, "eval": 1} and len(made) == 1,
                  f"phase 44 {name}: captures {captures} over "
                  f"{len(made)} StepGraphs, expected one of each step "
                  f"across the segments: {caps.records}")
            caps.assert_compiled_once("round", "eval")
            check(same_bits(made[0].traj, plain_traj)
                  and same_history(guarded, plain),
                  f"phase 44 {name}: the guarded segmented trajectory "
                  f"differs from the unguarded run's")
            per = made[0].launches.get("round", {}).get("topk_reward", 0)
            check(per == 1 and launches == c.rounds * per + eager,
                  f"phase 44 {name}: {launches} top-k launches, {per} a "
                  f"replay: expected {c.rounds} replays and {eager} eager")
            row[name] = {"launches": launches, "eager_launches": eager,
                         "captures": captures, "s": secs,
                         "capture_s": dict(made[0].capture_s)}

        steps, carry0 = _fused_engine(cfg, dev)
        with retrace_guard(watch=("round",)) as caps:
            graphs = replay.StepGraphs(carry0, 4)
            graphs.add("round", steps[0], advance=True)
            graphs.add("eval", steps[1], row=-1)
            graphs.run("round")         # the captures, before the mode
            graphs.run("eval")
            # planted: a second StepGraphs over the same step
            twice = replay.StepGraphs(carry0, 2)
            twice.add("round", steps[0], advance=True)
            twice.run("round")
        check(caps.compiles_of("round") == 2 and caps.retraced(),
              f"phase 44: a second StepGraphs over one step was not seen: "
              f"{caps.records}")
        del twice
        torch.cuda.synchronize()
        probe = torch.ones(4, device=dev)
        ops.LAUNCHES["topk_reward"] = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                graphs.run("round")
                graphs.run("eval")
            armed = False
            try:
                probe.sum().item()      # a sync: the mode must refuse it
            except RuntimeError:
                armed = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
        replays = ops.LAUNCHES["topk_reward"]
        traj = graphs.fetch(0, 4)
        check(armed, "phase 44: set_sync_debug_mode('error') let .item() "
              "synchronise")
        check(replays == 3 and np.isfinite(traj["test_acc"]).all(),
              f"phase 44: {replays} top-k launches in 3 replays under "
              f"sync debug, test_acc {traj['test_acc']}")
        row["sync_debug_replays"] = {"rounds": 3, "launches": replays}

        def reads_the_host(carry, ctr):
            carry, outs = steps[1](carry, ctr)
            return carry, dict(outs, acc=torch.full(
                (), outs["test_acc"].item(), device=dev))

        planted = replay.StepGraphs(carry0, 2)
        planted.add("eval", reads_the_host)
        caught = None
        try:
            with strict_mode():
                planted.run("eval")
        except HostTransferError as e:
            caught = str(e)
        check(caught is not None, "phase 44: a step's .item() ran under "
              "strict_mode")
        row["planted"] = {"item_in_step": caught,
                          "second_capture": caps.compiles_of("round")}
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.backends.cudnn.deterministic = deterministic
    log(f"phase 44: the sanitizers on the fused engines, {cfg.n_clients} "
        f"clients, k={cfg.selector.k}, full width, {cfg.rounds} rounds in 3 "
        f"segments under strict_mode(debug_nans=True) on {row['card']}: "
        f"run_fl_scanned {row['run_fl_scanned']['s']:.3f} s, "
        f"run_fl_async_scanned {row['run_fl_async_scanned']['s']:.3f} s, "
        f"one capture a step, trajectories bitwise the unguarded runs'; "
        f"top-k launches {row['run_fl_scanned']['launches']} / "
        f"{row['run_fl_async_scanned']['launches']} (one a replay, plus "
        f"the warm-up and the async fill); 3 replays under sync debug "
        f"'error' ({replays} launches); planted .item() caught "
        f"({caught}), planted second capture seen: {row}")
    return row


def to_device(tree, dev):
    """``tree`` (tuples, lists, dicts of tensors and other values) with
    every tensor moved to ``dev``: the first calls of a phase kept off the
    card while later phases run."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree.to(dev) if hasattr(tree, "to") else tree


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=SEED,
                    help="weights and tokens of the LM phases")
    seed = ap.parse_args(argv).seed
    # Expandable segments, set before torch starts its allocator: behind
    # the olmo-1b phases, falcon-mamba-7b's train step (phase 24, peak
    # about 60 GiB) ran out of memory with 36.8 GiB reserved but
    # unallocated, free memory split across segments that long-lived
    # tensors keep. CUDA graphs' private pools keep ordinary segments.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops, ref

    walls = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[name] = time.perf_counter() - t0
        log(f"{name}: {walls[name]:.2f} s wall")
        return out

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_name_power()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = max_sm_clock_hz(torch, dev)
    log(f"phase 1: card {card}, {sms} SMs, max SM clock "
        f"{clock_hz / 1e6:.0f} MHz; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("phase 1: TF32 off for cuDNN convolutions and matmuls "
        "(parity phases compare float32 with the CPU)")
    t0 = time.perf_counter()
    names = ("topk_select", "flash_attention", "flash_attention_bwd",
             "ssd_chunk", "ssd_chunk_bwd", "selective_scan",
             "selective_scan_bwd")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        paths = list(pool.map(ops.build_library, names))
    for name in names:
        ops.load_library(name)
    walls["phase 1"] = time.perf_counter() - t0
    log(f"phase 1: built {', '.join(p.name for p in paths)} from "
        f"src/repro_torch/kernels/csrc/ in parallel in "
        f"{walls['phase 1']:.2f} s")
    regs = {}
    for name in names:
        log_path = ops.ptxas_log(name)
        check(log_path.exists(), f"no build report {log_path}")
        regs[name] = entry_usage(ptxas_usage(log_path.read_text()),
                                 MAIN_ENTRIES[name])
    log(f"phase 1: each library's main-path kernel (ptxas): entries, most "
        f"registers a thread and spill bytes: {regs}")
    sass = loop_counts(ops, dict(zip(names, paths)))
    log(f"phase 1: SASS of the main-path SSD kernel's chunk loop (static "
        f"counts), of the scan's inner loop and of the scan backward's "
        f"inner loops: {sass}")
    check(regs["selective_scan_bwd"]["spill_bytes"] == 0,
          f"ptxas spills {regs['selective_scan_bwd']['spill_bytes']} bytes "
          f"in {MAIN_ENTRIES['selective_scan_bwd']}")
    if sass["selective_scan_bwd"] != "no cuobjdump":
        found = sass["selective_scan_bwd"]
        check(found["REDG"] + found["ATOMG"] + found["UTMAREDG"] == 0,
              f"the scan backward adds into global memory: {found}")
    log(f"phase 1: the scan backward ({SCAN_BWD_DESIGN}): registers and "
        f"spill bytes of its bf16 entry at ds 16 "
        f"{regs['selective_scan_bwd']}; its inner loops "
        f"{sass['selective_scan_bwd']}")
    from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, HEAD_DIMS
    for name, pairs in (("flash_attention", HEAD_DIMS),
                        ("flash_attention_bwd", BWD_HEAD_DIMS)):
        usage = ptxas_usage(ops.ptxas_log(name).read_text())
        regs[name]["by_head_size"] = {
            f"{dqk}/{dv}": entry_usage(usage, f"{bf16_entry(name, dqk)}"
                                              f"ILi{dqk}ELi{dv}E")
            for dqk, dv in pairs}
    wide = regs["flash_attention_bwd"]["by_head_size"]["192/128"]
    serialized = wgmma_serialized(
        ops.ptxas_log("flash_attention_bwd").read_text(),
        bf16_entry("flash_attention_bwd", 192))
    check(wide["spill_bytes"] == 0 and not serialized,
          f"{bf16_entry('flash_attention_bwd', 192)}: {wide}, ptxas "
          f"serialized its wgmmas: {serialized}")
    sass["flash_attention_bwd"] = bwd_sass_counts(
        ops, paths[names.index("flash_attention_bwd")])
    if sass["flash_attention_bwd"] != "no cuobjdump":
        for name, counts in sass["flash_attention_bwd"].items():
            check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                  f"{name}: no wgmma or no TMA load in its SASS: {counts}")
    log(f"phase 1: the attention forward and backward ({BWD_DESIGN}): "
        f"registers and spill bytes at each (q.k, v) width pair built: "
        f"forward {regs['flash_attention']['by_head_size']}, backward "
        f"{regs['flash_attention_bwd']['by_head_size']}; static SASS counts "
        f"{sass['flash_attention_bwd']}")
    for entry, use in regs["ssd_chunk_bwd"].items():
        check(use["spill_bytes"] == 0,
              f"ptxas spills {use['spill_bytes']} bytes in {entry}")
    sass["ssd_chunk_bwd"] = {
        entry: bwd_sass_counts(ops, paths[names.index("ssd_chunk_bwd")],
                               entry)
        for entry in MAIN_ENTRIES["ssd_chunk_bwd"]}
    for entry, found in sass["ssd_chunk_bwd"].items():
        if found != "no cuobjdump":
            check(all(c["HMMA"] > 0 for c in found.values()),
                  f"{entry}: no tensor-core product in its SASS: {found}")
    log(f"phase 1: the SSD backward ({SSD_BWD_DESIGN}): registers and spill "
        f"bytes of its bf16 entries at ds 64 {regs['ssd_chunk_bwd']}; static "
        f"SASS counts {sass['ssd_chunk_bwd']}")

    topk_cases_run = timed("phase 2", phase_kernel_vs_plain, torch, ops,
                           ref, dev, TOPK_SIZES)
    sel_launches, sel_err, fleet_call = timed(
        "phase 3", phase_selection, torch, ref, dev, 1_048_576, 3)
    par_launches, par_err = timed("phase 4", phase_training_parity, torch,
                                  ref, dev, fl_config(200, 10, 3))
    check(par_launches == 3, f"parity run launched {par_launches}")
    # the main path: counts set to 0 just before it, read just after
    launches, main_err, main_call, host_per_round = timed(
        "phase 5", phase_training_scale, torch, ref, dev,
        fl_config(10_000, 100, 3))
    check(launches == 3,
          f"run_fl launched the kernel {launches} times in 3 rounds")

    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 * 2**20)
    t0 = time.perf_counter()
    main = phase_timing(torch, ops, ref, main_call, "phase 5", l2)
    fleet = phase_timing(torch, ops, ref, fleet_call, "phase 3", l2)
    walls["phase 6"] = time.perf_counter() - t0

    # the fused engines, each path's count set to 0 just before it and
    # read just after (inside the phases)
    fsel_launches, fsel_err, fsel_row = timed(
        "phase 6a", phase_fused_selection, torch, ops, ref, dev, 1_048_576,
        3)
    fpar_launches, fpar_err = timed("phase 6b", phase_fused_parity, torch,
                                    ops, ref, dev, fl_config(200, 10, 3))
    fused_row, fused_err = timed("phase 6c", phase_fused_scale, torch, ops,
                                 ref, dev, fl_config(10_000, 100, 3),
                                 host_per_round)
    profile_rows = timed("phase 6d", phase_profile, torch, dev,
                         fl_config(10_000, 100, 3))
    # the async engines; each path's count set to 0 just before it and
    # read just after (inside the phases)
    asel_launches, asel_err, asel_row = timed(
        "phase 6e", phase_async_selection, torch, ops, ref, dev, 1_048_576,
        4)
    apar_launches, apar_err, apar_out = timed(
        "phase 6f", phase_async_parity, torch, ops, ref, dev,
        fl_config(200, 10, 6, buffer_size=4, max_concurrency=10,
                  staleness_power=ASYNC_POWER))
    async_rows, async_err = timed(
        "phase 6g", phase_async_scale, torch, ops, ref, dev,
        fl_config(10_000, 100, 3, buffer_size=ASYNC_BUFFER,
                  max_concurrency=ASYNC_CONCURRENCY,
                  staleness_power=ASYNC_POWER))

    # the front doors: the knob controller, the dispatch and the host
    # oracle, the train launcher; counts set to 0 just before each path
    # and read just after (inside the phases)
    ctrl_row, ctrl_err = timed(
        "phase 6h", phase_controller, torch, ops, ref, dev,
        fl_config(200, 10, 3), fl_config(10_000, 100, 3), host_per_round)
    disp_row, disp_err = timed("phase 6i", phase_dispatch, torch, ops, ref,
                               dev, 1_048_576, 3)
    cli_row = timed("phase 6j", phase_train_cli, torch)
    # the sharded engines; counts set to 0 just before each mesh's run and
    # read just after (inside the phases)
    shsel_row, shsel_err = timed("phase 6k", phase_sharded_selection, torch,
                                 ops, ref, dev, 1_048_576, 6)
    shtrain_row, shtrain_err = timed(
        "phase 6l", phase_sharded_training, torch, ops, ref, dev,
        fl_config(10_000, 100, 3))
    pg_row, pg_err = timed("phase 6m", phase_process_group, torch, ops,
                           ref, dev, 1_048_576, 3)
    # the sharded async engines and the restart checker; counts set to 0
    # just before each mesh's run and read just after (inside the phases)
    ashsel_row, ashsel_err = timed("phase 6n", phase_async_sharded_selection,
                                   torch, ops, ref, dev, 1_048_576, 4)
    ashtrain_row, ashtrain_err = timed(
        "phase 6o", phase_async_sharded_training, torch, ops, ref, dev,
        fl_config(10_000, 100, 3, buffer_size=ASYNC_BUFFER,
                  max_concurrency=ASYNC_CONCURRENCY,
                  staleness_power=ASYNC_POWER))
    elastic_row, elastic_err = timed("phase 6p", phase_elastic, torch, ops,
                                     ref, dev)

    attn_errs, attn_shapes, attn_rel = timed(
        "phase 7", phase_attn_vs_plain, torch, ops, ref, dev)
    ssd_errs, ssd_shapes, ssd_rel = timed(
        "phase 8", phase_ssd_vs_plain, torch, ops, ref, dev)
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    cfg = get_config("zamba2-1.2b")
    params = init_params(seed, cfg, device=dev)
    # the LM kernels' main path: counts set to 0 just before, read after
    prefill, seen = timed("phase 9", phase_prefill, torch, ops, ref, dev,
                          cfg, params, seed)
    serve = timed("phase 10", phase_serve, torch, ops, dev, cfg, params,
                  seed, {"flash_attention": 6, "ssd_chunk": 38}, 10,
                  BF16_REPLAY_REL_L2)
    lm_rows = timed("phase 11", phase_lm_timing, torch, ops, ref, seen, l2)
    del params, seen
    torch.cuda.empty_cache()

    scan_errs, scan_shapes, scan_rel = timed(
        "phase 12", phase_scan_vs_plain, torch, ops, ref, dev)
    cfg = get_config("falcon-mamba-7b")
    params = timed("falcon-mamba-7b init", init_params, seed, cfg,
                   device=dev)
    g = torch.Generator(device="cpu").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=g).to(dev)
    # the scan kernel's main path: count set to 0 just before, read after
    falcon_prefill, seen = timed("phase 13", phase_mamba1_prefill, torch,
                                 ops, ref, dev, cfg, params, tokens)
    routes = timed("phase 14", phase_mamba1_routes, torch, ops, dev, cfg,
                   params, tokens[:, :ROUTE_LEN])
    falcon_serve = timed("phase 15", phase_serve, torch, ops, dev, cfg,
                         params, seed, {"selective_scan": SCAN_LAUNCHES}, 15,
                         MAMBA1_BF16_REPLAY_REL_L2)
    del params
    torch.cuda.empty_cache()
    scan_row = timed("phase 16", phase_scan_timing, torch, ops, ref, seen,
                     l2, sms, clock_hz)
    del seen

    # LM training (olmo-1b): the backward kernel against its plain
    # version, then the train step's main path, counts set to 0 just
    # before each step and read just after (inside the phase)
    bwd_errs, lse_errs, bwd_shapes, bwd_rel = timed(
        "phase 17", phase_attn_bwd_vs_plain, torch, ops, ref, dev)
    train_row, seen = timed("phase 18", phase_train_step, torch, ops, ref,
                            dev, seed)
    cohort_row = timed("phase 19", phase_cohort_cli, torch)
    bwd_row = timed("phase 20", phase_train_timing, torch, ops, ref, seen,
                    l2)
    del seen

    # zamba2-1.2b and falcon-mamba-7b training: each scan backward kernel
    # against its plain version, then its train step's main path, counts
    # set to 0 just before each step and read just after (inside the phase)
    ssd_bwd_errs, ssd_bwd_shapes, ssd_bwd_rel, carry_err = timed(
        "phase 21", phase_ssd_bwd_vs_plain, torch, ops, ref, dev)
    zamba_train, seen = timed("phase 22", phase_scan_train_step, torch, ops,
                              ref, dev, seed, "zamba2-1.2b", 22)
    scan_bwd_errs, scan_bwd_shapes, scan_bwd_rel = timed(
        "phase 23", phase_scan_bwd_vs_plain, torch, ops, ref, dev)
    falcon_train, falcon_seen = timed(
        "phase 24", phase_scan_train_step, torch, ops, ref, dev, seed,
        "falcon-mamba-7b", 24)
    seen.update(falcon_seen)
    scan_bwd_rows = timed("phase 25", phase_scan_bwd_timing, torch, ops, ref,
                          seen, l2, sms, clock_hz)
    del seen, falcon_seen

    # the dense and MLA archs: both attention kernels at their (q.k, v)
    # width pairs; each arch's prefill and serving path at full width and
    # depth (counts set to 0 just before the prefill, read just after),
    # its weights freed before the next arch's; each one's train steps
    # (counts set to 0 just before each step, read just after); the first
    # calls kept on the host for the timing
    width_errs, width_cases, width_rel = timed(
        "phase 26", phase_attn_widths_vs_plain, torch, ops, ref, dev)
    dense, fwd_seen, bwd_seen = {}, {}, {}
    for phase, arch in zip((27, 28, 29), DENSE_ARCHS):
        prefill_row, serve_row, seen = timed(
            f"phase {phase}", phase_dense_serving, torch, ops, ref, dev,
            seed, arch, phase)
        dense[arch] = {"prefill": prefill_row, "serve": serve_row}
        fwd_seen[arch] = to_device(seen, "cpu")
    for arch in DENSE_ARCHS:
        dense[arch]["train"], seen = timed(
            f"phase 30 {arch}", phase_dense_train_step, torch, ops, ref, dev,
            seed, arch)
        bwd_seen[arch] = to_device(seen, "cpu")
    del seen
    dense_timing = timed(
        "phase 31", phase_dense_timing, torch, ops, ref, dev,
        to_device(fwd_seen, dev), to_device(bwd_seen, dev), l2)
    del fwd_seen, bwd_seen

    # the MoE archs' serving: the forward at (192, 128) against its plain
    # version; each arch's prefill and serving path at full width, cut in
    # depth (counts set to 0 just before the prefill, read just after),
    # its weights freed before the next arch's; llama4's loss and
    # gradients in f32; the forward timed at both prefills' inputs
    wide_errs, wide_cases, wide_rel, wide_bwd_errs, wide_bwd_rel = timed(
        "phase 32", phase_attn_wide_vs_plain, torch, ops, ref, dev)
    moe_rows, moe_seen = {}, {}
    for phase, arch in zip((33, 34), MOE_ARCHS):
        moe_rows[arch], seen = timed(f"phase {phase}", phase_moe_serving,
                                     torch, ops, ref, dev, seed, arch, phase)
        moe_seen[arch] = to_device(seen, "cpu")
    del seen
    moe_grads = timed("phase 35", phase_moe_grads, torch, ops, ref, dev,
                      seed)
    moe_timing = timed("phase 36", phase_kernel_timing, torch, ops, ref,
                       to_device(moe_seen, dev), {}, l2, 36)
    del moe_seen

    # the vision frontend and the codebook heads: each arch's prefill and
    # serving path at full width and depth (counts set to 0 just before
    # the prefill, read just after), its weights freed before the next
    # arch's; each one's train steps (counts set to 0 just before each
    # step, read just after); both kernels timed on the first calls
    frontend, fwd_seen, bwd_seen = {}, {}, {}
    for phase, arch in zip((37, 38), FRONTEND_ARCHS):
        prefill_row, serve_row, seen = timed(
            f"phase {phase}", phase_dense_serving, torch, ops, ref, dev,
            seed, arch, phase)
        frontend[arch] = {"prefill": prefill_row, "serve": serve_row}
        fwd_seen[arch] = to_device(seen, "cpu")
    for arch in FRONTEND_ARCHS:
        frontend[arch]["train"], seen = timed(
            f"phase 39 {arch}", phase_dense_train_step, torch, ops, ref, dev,
            seed, arch, 39, FRONTEND_TRAIN_CUT)
        bwd_seen[arch] = to_device(seen, "cpu")
    del seen
    frontend_timing = timed(
        "phase 40", phase_kernel_timing, torch, ops, ref,
        to_device(fwd_seen, dev), to_device(bwd_seen, dev), l2, 40)
    del fwd_seen, bwd_seen

    # deepseek-v2-236b trains: its AdamW steps at full width, cut to its
    # dense first layer (counts set to 0 just before each step, read just
    # after), the f32 routes over the dense and the first MoE layer; the
    # backward at (192, 128) timed on the step's first call
    moe_train, seen = timed(
        "phase 41", phase_dense_train_step, torch, ops, ref, dev, seed,
        MOE_TRAIN_ARCH, 41, MOE_TRAIN_CUT)
    moe_train_timing = timed(
        "phase 42", phase_kernel_timing, torch, ops, ref, {},
        {MOE_TRAIN_ARCH: seen}, l2, 42)
    del seen

    # the dry-run of each train step (and the 2 x 4096 prefills) the phases
    # above timed, on fake tensors of the card: nothing allocated or
    # launched; its roofline and peak held against the measured ones
    from repro_torch.configs import get_config
    cases = [dryrun_train_case("olmo-1b", get_config("olmo-1b"),
                               train_row),
             dryrun_train_case("zamba2-1.2b", get_config("zamba2-1.2b"),
                               zamba_train),
             dryrun_train_case("falcon-mamba-7b", get_config(
                 "falcon-mamba-7b").with_(n_layers=FALCON_TRAIN_DEPTH),
                 falcon_train)]
    for cut, rows_of in ((DENSE_TRAIN_CUT, dense), (FRONTEND_TRAIN_CUT,
                                                    frontend)):
        for arch, (layers, rows) in cut.items():
            cases.append(dryrun_train_case(
                arch, get_config(arch).with_(n_layers=layers),
                rows_of[arch]["train"], rows))
    layers, rows = MOE_TRAIN_CUT[MOE_TRAIN_ARCH]
    cases.append(dryrun_train_case(
        MOE_TRAIN_ARCH, get_config(MOE_TRAIN_ARCH).with_(n_layers=layers),
        moe_train, rows))
    cases += [dryrun_prefill_case("zamba2-1.2b", get_config("zamba2-1.2b"),
                                  prefill),
              dryrun_prefill_case("falcon-mamba-7b",
                                  get_config("falcon-mamba-7b"),
                                  falcon_prefill)]
    cases += [dryrun_prefill_case(arch, get_config(arch),
                                  rows_of[arch]["prefill"])
              for rows_of, archs in ((dense, DENSE_ARCHS),
                                     (frontend, FRONTEND_ARCHS))
              for arch in archs]
    cases += [dryrun_prefill_case(arch, get_config(arch).with_(
        n_layers=MOE_SERVE_CUT[arch]), moe_rows[arch]["prefill"])
        for arch in MOE_ARCHS]
    dryrun_row = timed("phase 43", phase_dryrun, torch, ops, dev, cases)
    # the sanitizers on the fused engines; each path's count set to 0 just
    # before it and read just after (inside the phase)
    sanitizer_row = timed("phase 44", phase_sanitizers, torch, ops, dev,
                          fl_config(200, 10, SANITIZER_ROUNDS))

    summary = {"kernels": [{
        "name": "topk_reward", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "checked": True,
        "launches": launches,
        "max_abs_err": max(sel_err, par_err, main_err, fsel_err, fpar_err,
                           fused_err, asel_err, apar_err, async_err,
                           ctrl_err, disp_err, shsel_err, shtrain_err,
                           pg_err, ashsel_err, ashtrain_err, elastic_err),
        "ms": main["ms"], "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "shape": {key: main[key] for key in ("n", "k", "mode", "ucb")},
        "build": regs["topk_select"],
        "timing": main, "fleet_shape": fleet,
        "phase2_cases": {"matrix": topk_cases_run[0],
                         "edges": topk_cases_run[1]},
        # the fused phases count replays times launches a graph holds
        # (each graph's warm-up launch besides: phase 6c's in fused_10k)
        "launches_by_phase": {"selection_1M": sel_launches,
                              "run_fl_parity": par_launches,
                              "run_fl_10k": launches,
                              "fused_selection_1M": fsel_launches,
                              "run_fl_scanned_parity": fpar_launches,
                              "run_fl_scanned_10k":
                                  fused_row["replayed_launches"],
                              "async_selection_1M": asel_launches,
                              "run_fl_async_parity_replayed": apar_launches,
                              "run_fl_async_10k_host":
                                  async_rows["host"]["launches"],
                              "run_fl_async_10k_fused":
                                  async_rows["scanned"]["launches"],
                              "controller_run_fl_200": ctrl_row["launches"],
                              "controller_run_fl_10k_by_turn":
                                  ctrl_row["launches_10k"],
                              "run_rounds_1M_by_leg": disp_row["launches"],
                              "million_client_example":
                                  disp_row["example_launches"],
                              "sharded_selection_1M_by_shards":
                                  shsel_row["launches"],
                              "sharded_run_fl_10k_by_shards":
                                  shtrain_row["launches"],
                              "process_group_selection_1M":
                                  pg_row["launches"],
                              "process_group_async_selection_1M":
                                  pg_row["async_launches"],
                              "async_sharded_selection_1M_by_shards":
                                  ashsel_row["launches"],
                              "async_sharded_run_fl_10k_by_shards":
                                  ashtrain_row["launches"]},
    }]}
    summary["fused"] = {"selection_1M_3_rounds": fsel_row,
                        "training_10k": fused_row, "profile": profile_rows}
    summary["async"] = {"selection_1M_4_aggregations": asel_row,
                        "parity_200": apar_out, "training_10k": async_rows}
    summary["front_doors"] = {"controller": ctrl_row, "dispatch": disp_row,
                              "train_cli": cli_row}
    summary["sharded"] = {"selection_1M": shsel_row,
                          "training_10k": shtrain_row,
                          "process_group": pg_row,
                          "async_selection_1M": ashsel_row,
                          "async_training_10k": ashtrain_row,
                          "elastic_check": elastic_row}
    for name, source, replaces, errs, shapes, row, n, by_phase, rel in (
            ("flash_attention", ATTN_SOURCE, ATTN_REPLACES, attn_errs,
             attn_shapes, lm_rows["flash_attention"],
             prefill["launches"]["flash_attention"],
             {"prefill_2x4096": prefill["launches"]["flash_attention"],
              "serve_prompt_forward":
                  serve["prompt_forward_launches"]["flash_attention"]},
             {"phase7_max": attn_rel, "prefill_call": prefill["attn_rel_l2"],
              "limit": ATTN_BF16_REL_L2}),
            ("ssd_chunk", SSD_SOURCE, SSD_REPLACES, ssd_errs, ssd_shapes,
             lm_rows["ssd_chunk"], prefill["launches"]["ssd_chunk"],
             {"prefill_2x4096": prefill["launches"]["ssd_chunk"],
              "serve_prompt_forward":
                  serve["prompt_forward_launches"]["ssd_chunk"]},
             {"phase8_max": ssd_rel, "prefill_call": prefill["ssd_rel_l2"],
              "limit": SSD_BF16_REL_L2,
              "limit_slow_decay": SSD_BF16_REL_L2_SLOW}),
            ("selective_scan", SCAN_SOURCE, SCAN_REPLACES, scan_errs,
             scan_shapes, scan_row, falcon_prefill["launches"],
             {"falcon_prefill_2x4096": falcon_prefill["launches"],
              "serve_prompt_forward":
                  falcon_serve["prompt_forward_launches"]["selective_scan"]},
             {"phase12_max": scan_rel,
              "prefill_call": falcon_prefill["scan_rel_l2"],
              "limit": SCAN_BF16_REL_L2})):
        first_call = prefill["errs"].get(name,
                                         falcon_prefill["max_abs_err"])
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "checked": True, "launches": n,
            "max_abs_err": max(max(errs.values()), first_call),
            "max_abs_err_by_dtype": errs,
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row, "checked_shapes": shapes,
            "launches_by_phase": by_phase, "bf16_rel_l2_vs_f32": rel,
            "build": regs[name],
        })
    summary["kernels"][1]["launches_by_phase"]["olmo_train_step"] = \
        train_row["launches"][0]["flash_attention"]
    summary["kernels"][1]["lse_max_abs_err_by_dtype"] = lse_errs
    # the forward at the train step's shape, beside SDPA's forward there
    summary["kernels"][1]["olmo_train_shape"] = {
        "shape": bwd_row["shape"], "kv_heads": bwd_row["kv_heads"],
        **bwd_row["forward_ms"]}
    summary["kernels"].append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": BWD_SOURCE, "replaces": BWD_REPLACES, "checked": True,
        "design": BWD_DESIGN,
        "launches": sum(n["flash_attention_bwd"]
                        for n in train_row["launches"]),
        "max_abs_err": max(max(bwd_errs.values()),
                           train_row["max_abs_err"]),
        "max_abs_err_by_dtype": bwd_errs,
        "ms": bwd_row["ms"], "kernel_ms": bwd_row["ms"],
        "plain_ms": bwd_row["plain_ms"], "bound_ms": bwd_row["bound_ms"],
        "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"], "shape": bwd_row,
        "checked_shapes": bwd_shapes,
        "launches_by_phase": {"olmo_train_step_by_step": [
            n["flash_attention_bwd"] for n in train_row["launches"]]},
        "bf16_rel_l2_vs_f32": {"phase17_max": bwd_rel,
                               "train_call": train_row["call_rel_l2"],
                               "limit": ATTN_BWD_BF16_REL_L2},
        "build": regs["flash_attention_bwd"],
    })
    by_name = {k["name"]: k["launches_by_phase"] for k in summary["kernels"]}
    for name, train in (("flash_attention", zamba_train),
                        ("flash_attention_bwd", zamba_train),
                        ("ssd_chunk", zamba_train),
                        ("selective_scan", falcon_train)):
        by_name[name][f"{train['arch']}_train_step_by_step"] = [
            n[name] for n in train["launches"]]
    for name, source, replaces, errs, shapes, train, rel in (
            ("ssd_chunk_bwd", SSD_BWD_SOURCE, SSD_BWD_REPLACES, ssd_bwd_errs,
             ssd_bwd_shapes, zamba_train, ssd_bwd_rel),
            ("selective_scan_bwd", SCAN_BWD_SOURCE, SCAN_BWD_REPLACES,
             scan_bwd_errs, scan_bwd_shapes, falcon_train, scan_bwd_rel)):
        row = scan_bwd_rows[name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "checked": True,
            "launches": sum(n[name] for n in train["launches"]),
            "max_abs_err": max(max(errs.values()), train["max_abs_err"]),
            "max_abs_err_by_dtype": errs,
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row, "checked_shapes": shapes,
            "launches_by_phase": {"train_step_by_step": [
                n[name] for n in train["launches"]]},
            "bf16_rel_l2_vs_f32": {"cases": rel,
                                   "train_call": train["call_rel_l2"],
                                   "limit_bf16": SCAN_BWD_BF16_REL_L2,
                                   "limit_f32": SCAN_BWD_F32_REL_L2},
            "build": regs[name],
        })
    ssd_bwd_row = next(k for k in summary["kernels"]
                       if k["name"] == "ssd_chunk_bwd")
    ssd_bwd_row.update(
        design=SSD_BWD_DESIGN, entries=list(MAIN_ENTRIES["ssd_chunk_bwd"]),
        carry_max_abs_err=carry_err)
    next(k for k in summary["kernels"]
         if k["name"] == "selective_scan_bwd").update(
        design=SCAN_BWD_DESIGN, entries=[MAIN_ENTRIES["selective_scan_bwd"]])
    for name in ("flash_attention", "flash_attention_bwd"):
        row = next(k for k in summary["kernels"] if k["name"] == name)
        for arch in DENSE_ARCHS:
            if name == "flash_attention":
                row["launches_by_phase"][f"{arch}_prefill_2x4096"] = \
                    dense[arch]["prefill"]["launches"][name]
                row["launches_by_phase"][f"{arch}_serve_prompt_forward"] = \
                    dense[arch]["serve"]["prompt_forward_launches"][name]
            row["launches_by_phase"][f"{arch}_train_step_by_step"] = [
                n[name] for n in dense[arch]["train"]["launches"]]
        row["width_pairs"] = {
            "checked_shapes": width_cases,
            "max_abs_err_by_dtype": width_errs,
            "bf16_rel_l2_vs_f32": {**width_rel,
                                   "limits": [ATTN_BF16_REL_L2,
                                              ATTN_BWD_BF16_REL_L2]},
            "timing": {k: v for k, v in dense_timing.items()
                       if k.endswith("forward" if name == "flash_attention"
                                     else "backward")},
            "padding_hd96_vs_hd128": dense_timing["padding_hd96_vs_hd128"][
                "forward" if name == "flash_attention" else "backward"]}
    row = next(k for k in summary["kernels"] if k["name"] == "flash_attention")
    for arch in MOE_ARCHS:
        row["launches_by_phase"][f"{arch}_prefill_2x4096"] = \
            moe_rows[arch]["prefill"]["launches"]["flash_attention"]
        row["launches_by_phase"][f"{arch}_serve_prompt_forward"] = \
            moe_rows[arch]["serve"]["prompt_forward_launches"][
                "flash_attention"]
    row["launches_by_phase"][f"{MOE_GRAD_ARCH}_f32_layer_loss_and_grads"] = \
        moe_grads["launches"]["flash_attention"]
    row["pair_192_128"] = {
        "checked_shapes": wide_cases, "max_abs_err_by_dtype": wide_errs,
        "bf16_rel_l2_vs_f32": {"phase32_max": wide_rel,
                               "limit": ATTN_BF16_REL_L2},
        "timing": moe_timing}
    # deepseek-v2-236b's train step (41) and its timing (42): the launches
    # a step of both kernels and of the f32 routes' kernel route
    for name in ("flash_attention", "flash_attention_bwd"):
        row = next(k for k in summary["kernels"] if k["name"] == name)
        row["launches_by_phase"][f"{MOE_TRAIN_ARCH}_train_step_by_step"] = [
            n[name] for n in moe_train["launches"]]
        row["launches_by_phase"][
            f"{MOE_TRAIN_ARCH}_f32_depth{ROUTE_DEPTH}_loss_and_grads"] = \
            moe_train["f32_routes"]["launches"][name]
    row = next(k for k in summary["kernels"]
               if k["name"] == "flash_attention_bwd")
    row["pair_192_128"] = {
        "design": BWD_WIDE_DESIGN, "checked_shapes": wide_cases,
        "max_abs_err_by_dtype": wide_bwd_errs,
        "bf16_rel_l2_vs_f32": {"phase32_max": wide_bwd_rel,
                               "train_call": moe_train["call_rel_l2"],
                               "limit": ATTN_BWD_BF16_REL_L2},
        "timing": moe_train_timing}
    row["max_abs_err"] = max(row["max_abs_err"], *wide_bwd_errs.values(),
                             moe_train["max_abs_err"])
    for name in ("flash_attention", "flash_attention_bwd"):
        row = next(k for k in summary["kernels"] if k["name"] == name)
        for arch in FRONTEND_ARCHS:
            if name == "flash_attention":
                row["launches_by_phase"][f"{arch}_prefill_2x4096"] = \
                    frontend[arch]["prefill"]["launches"][name]
                row["launches_by_phase"][f"{arch}_serve_prompt_forward"] = \
                    frontend[arch]["serve"]["prompt_forward_launches"][name]
            row["launches_by_phase"][f"{arch}_train_step_by_step"] = [
                n[name] for n in frontend[arch]["train"]["launches"]]
        row["frontend_archs_timing"] = {
            k: v for k, v in frontend_timing.items()
            if k.endswith("forward" if name == "flash_attention"
                          else "backward")}
    summary["dense_archs"] = dense
    summary["frontend_archs"] = frontend
    summary["moe_archs"] = {**moe_rows, "llama4_f32_layer_grads": moe_grads,
                            f"{MOE_TRAIN_ARCH}_train": moe_train}
    summary["olmo_1b"] = {"train": train_row, "cohort_cli": cohort_row}
    summary["zamba2_1_2b"] = {"train": zamba_train}
    summary["falcon_mamba_7b"] = {"train": falcon_train}
    summary["sass"] = sass
    summary["dryrun"] = dryrun_row
    summary["sanitizers"] = sanitizer_row
    summary["kernels"][0]["launches_by_phase"].update({
        "sanitized_run_fl_scanned_200":
            sanitizer_row["run_fl_scanned"]["launches"],
        "sanitized_run_fl_async_scanned_200":
            sanitizer_row["run_fl_async_scanned"]["launches"],
        "sync_debug_replays_200":
            sanitizer_row["sync_debug_replays"]["launches"]})
    summary["zamba2_1_2b"].update(prefill=prefill, serve=serve)
    summary["falcon_mamba_7b"].update(prefill=falcon_prefill, routes=routes,
                                      serve=falcon_serve)
    walls["total"] = time.perf_counter() - t_start
    summary["wall_s"] = walls
    log(card)
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
