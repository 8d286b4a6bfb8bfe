#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one card.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU rehearsal, no card

Phases, in order; any failure exits non-zero and nothing is caught:

1. device: require CUDA; print the card, its count and the nvidia-smi name
   and power limit; turn TF32 off for matmuls and cuDNN (fp32 stays fp32);
2. build the hand-written kernels (``src/repro_torch/kernels/csrc``) with
   nvcc and print the build seconds, the ptxas register report and every
   function that spills; then (phase ``calibrate``) the paper's one-time
   calibration, ``repro_torch.hw.calibrate``, in bf16 at H100-sized shapes
   (GEMM 4096-8192, GEMV 8192-16384): effective FLOP/s and HBM bytes/s
   printed beside the H100 profile's data-sheet peaks and their derates
   (nothing is gated on them);
3. kernels vs plain on the card: each of the nine kernels against its
   plain PyTorch version evaluated in fp32 on the same input values (the
   bf16 plain version's own error is logged beside it), at the shapes
   each serving path of phase 5 gives it and at small ragged shapes, in
   bf16
   (atol=5e-3, rtol=2e-2) and fp32 (atol=rtol=1e-4: the kernel sums in
   another order than the plain version's einsum); GQA and MHA, SWA,
   scalar and per-row positions / bases, ragged chunk, sequence and cache
   lengths, dead decode rows, zamba2's head dim 80, the bf16 prefill
   body's tiling edges (g = 1, 4, 8; query tiles of 128 / g cut short;
   key tiles that wrap the ring; pool blocks of 24 tokens; windows
   shorter than a tile; every head dim); the bf16 contiguous decode
   body's edges (positions at a split's first and last key and the key
   after, windows shorter than a tile and across splits, S not a multiple
   of the tile, B = 1, g = 1 / 4 / 8 / 16 at every head dim); the same
   body through the block table (paged decode: block, tile and split
   edges, pool blocks of 16 and 24, windows shorter than a block, g = 1 /
   3 / 4 / 6 / 7 / 8 / 12 / 16 at every head dim); g = 3 / 6 / 7 / 12
   for flash, both chunk kernels and contig decode; the SSD scan's y and
   final state, ragged S, S < Q, one and several chunks, Q 8 / 64 / 128,
   N 16 / 64 / 128 / 256, head dims past one 64-wide slice, an initial
   state, one 8192-token row; the KV sanitizer's probe held to its plain
   version exactly (decode and chunk, paged and contiguous, fp32 and
   bf16, SWA, a dead row, poison as the dtype stores it planted where a
   row reads, which must fire, and where none does, which must not); the
   prefix path's suffix dispatch (paged chunk at per-row bases 0, 17,
   1000 and 1023 in one call: bf16 and fp32, blocks of 16 and 24, g = 8
   and 12, head dims 128 and 80, and with the probe on ragged real
   columns); head dim 120 (h2o-danube-3-4b) through every attention
   kernel and the probe, bf16 and fp32, g = 1 and 4, windows shorter than
   a tile and of 4096 with positions and bases on both sides of it,
   ragged lengths; flash at Sq != Sk non-causal with Sk = 8 (whisper's
   cross attention) and whisper's encoder; command-r-plus's 96/8 heads;
   the ring cache's decode route (``ops.decode_attention_ring``) against
   the reference's ``slot_pos`` mask on a ring not yet full, exactly full
   and wrapped; the contiguous decode kernel on fp8 caches
   (``kv_cache_dtype``, float8_e4m3fn and float8_e5m2, values with
   subnormals and +-448) at rows 4, 4a, 4c and 4d's shapes and small fp32
   ragged and SWA cases, each held to its plain version (over max |V|)
   and bit for bit to the kernel on the cache upcast to q's dtype, the
   four rows timed with a bound of 1 byte a K/V element and SDPA on the
   upcast cache (upcast included) as the yardstick, and ``astype`` on
   the card over every bf16 value against the CPU's bytes. At each
   kernel's main shape it
   times the kernel, the plain version and, as a yardstick the port never
   calls, ``F.scaled_dot_product_attention`` on the gathered /
   head-repeated K/V (none for the SSD scan and the probe: no single
   PyTorch call computes them), each as the mean of 20 eager calls (``ms``,
   ``plain_ms``, ``library_ms``: the rate the host sustains), the kernel
   and SDPA also as the device time per call of a CUDA graph of 20 calls
   (``device_ms``, ``library_device_ms``: no host launch cost), and
   computes the bound (bytes over 3.35 TB/s vs operations over 989
   TFLOP/s bf16; only the keys each row reaches, each byte once);
   flash at the MoE, hybrid and legacy prompts, paged chunk at the suffix
   bases, contig decode at d=80 and the SSD scan at zamba2's shape are
   timed too, and the new paths' shapes: paged decode and chunk at
   danube's heads past its window, flash at danube's ring prompt (2 x
   6000 tokens, window 4096), command-r's 512 group and whisper's encoder
   and cross attention, contig decode at whisper's heads, through the
   ring route and at a ``pp`` step's microbatch (2 rows at one position),
   at a ``tp`` step's shard on one rank (8 rows at one position, 16/2 and
   32/4 heads, with its split over S and CTAs per SM printed), flash at the
   ``tp`` prefill's shard (16/2 heads, 1024 tokens, 4 and 8 rows),
   contig chunk at whisper's heads; and the host time of a
   flash call through ctypes, bf16 (tensor-map encodes) against fp32;
   then the training kernels: the flash forward's log-sum-exp against the
   plain one, and the flash backward (kernel 8, no Pallas counterpart)
   against the plain gradient in fp32 (fp32 within 1e-4 of each
   gradient's largest element, bf16 within 3x the bf16 plain version's
   own error) at the train path's q (1,2048,16,128) / k/v (1,2048,8,128)
   causal, g = 6 and 12, d 120 under danube's 4096 window, d 80, d 64
   non-causal with Sq != Sk (whisper's 448 x 1500 cross attention) and
   small ragged fp32 / bf16 edges; each of the first six timed with the
   forward-with-lse beside it and SDPA's backward as the yardstick;
   then the SSD scan's backward (kernel 9, no Pallas counterpart) against
   its plain version in fp32, both given the exact chunk entry states:
   every gradient within 1e-4 of its largest element, a bf16 dx / dB /
   dC also within one bf16 rounding, at mamba2's and zamba2's train
   shapes (rows 9 and 9a, one 2048-token row, timed, no library call
   computes it; the forward with and without its states output beside
   row 9) and at reduced edges (ragged S, S < Q, Q 128 / 64 / 12 / 8, N
   16 to 256, head dims 16 to 64, h0 and dh_final, bf16 and fp32);
4. engine parity, fp32: reduced configs, one init each, the same requests
   through the Engine on the card (kernels) and on the CPU (plain): paged
   bucketed, direct-to-pool chunked and overcommitted (grow + preempt)
   qwen3-32b, and overcommitted with the sanitizer on (the probe on every
   paged decode and chunk; it must launch, preempt and chunk); contig
   bucketed and contig chunked qwen3-32b; contig qwen3-32b through the
   legacy admission (one batch-1 prefill and one prefill shape per
   length, never chunked); phi3.5-moe and
   granite-moe on their auto (contig) layout with more requests than
   slots; mamba2-1.3b and zamba2-2.7b with SSD chunks of 8 (prompts span
   several), more requests than slots and an equal-length pair batched
   into one group; qwen2-vl-2b, command-r-plus-104b and h2o-danube-3-4b
   paged and chunked; whisper-tiny batched, chunked and legacy (contig);
   then the model entry points the engine does not drive: qwen2-vl's
   prefill from embeddings under an image grid's distinct M-RoPE streams
   and its embeds decode, danube's ring cache (a prompt past the window,
   decode across the ring's end, tokens equal to the linear cache's);
   then the prefix waves (full-block sharing, deferred
   and admission-time copy-on-write), plain and sanitized, whose tokens
   must also equal sharing off, and in the sanitized engine poison
   planted in a shared block a suffix reads (must raise) and in one it
   does not (must not). Greedy tokens and counters must match, every
   kernel must have launched (each recurrent scenario its own), and for
   MoE the
   smallest gap between the k-th and (k+1)-th router probability is logged
   (a routing flip on a near-tie is then told apart from a bug); then
   bf16: a 2-layer, 256-wide dense model with Qwen3-32B's 64/8 heads of
   128, paged and contig, prompts that run flash and chunk prefill, and
   256-wide mamba2 and zamba2 models with SSD heads of 64 and prompts of
   one to six SSD chunks; each one's prefill and first decode logits on
   the card against the same engine in fp32 on the CPU (every run fed the
   fp32 run's tokens), within 3x the bf16 CPU engine's own error; then
   poison planted in a mapped block of a bf16 paged engine on the card
   (KV_POISON as bf16 stores it, 998,244,352): with the sanitizer the
   next decode step, and mid-prefill the next chunk, must raise
   ``KVSanitizerError``; without it nothing may; then the fp32 server
   scenario: a reduced qwen3-32b behind a ``GlobalServer`` on two paged
   pipelines with placements, cost dispatch, KV migration and a store
   whose byte budget evicts, one interruption after 3 rounds; tokens per
   request and ``events`` identical on the card and the CPU, at least one
   KV attach and one eviction; then a ``use_prefix_share=True`` server
   (hot prefixes published, a new and a rebuilt pipeline warmed, a
   first-contact hit): tokens, events, clock and store bytes identical;
   then the pipeline-parallel serve step (``launch/pipeline.py``) at the
   reduced qwen3-32b in fp32, both of the ``pp`` path's stage layouts:
   four steps' tokens on the card equal the CPU's and the unsplit
   decode's, ``decode_attention`` launched m x sum(split) times a step;
   then training: two fp32 train steps (2 microbatches, the reference's
   AdamW without bf16 compression) of reduced qwen3-32b, granite-moe,
   qwen2-vl-2b, whisper-tiny, mamba2-1.3b and zamba2-2.7b (SSD chunks of
   12: 32 tokens walk two full chunks and a ragged one of 8) on the card
   and the CPU from one init, loss, every parameter and every first
   moment within 1e-4 relative, the flash forward and backward launched
   (the SSD scan and its backward for mamba2, all four for zamba2); a
   checkpoint after step 2 restored into a fresh card state gives step
   3's loss within 1e-6;
4c. ``cluster`` (host only): the port's discrete-event cluster simulator
   (``repro_torch.cluster``) on the paper's qwen3-32b cluster
   (``populate_cluster`` over ``paper_cluster``) for the worst 50-minute
   interruption window of a ``PAPER_POOLS`` trace, 3 req/s of
   azure-conversation-like traffic: on a ``Topology`` whose links stay
   idle (each pipeline a store link of its own; no transfer may wait) the
   DES must equal the closed form to 1e-6 in rps, downtime and cost;
   prints rps, cost and downtime;
5. sixteen serving paths at full width, bf16, random weights from a
   seeded generator on the card, the same traffic but for ``prefix`` and
   ``danube`` (16 requests of 64-2048 prompt tokens, some past
   ``prefill_chunk=512``, 32 new tokens each, ``max_len`` 2080, 8 slots);
   for each, one untimed warm-up pass, then
   ``--repeats`` timed runs (median wall reported), each on a fresh Engine
   with launch counts zeroed just before and read just after, and the
   kernels that path runs must have launched in each run:
   main   Qwen3-32B widths (d_model 5120, 64/8 heads, head dim 128, d_ff
          25600, vocab 151936), depth ``--layers``, paged layout: paged
          decode, paged chunk, flash;
   sanitize main with ``kv_sanitize=True``: the probe after every paged
          decode and chunk call, read once per dispatch;
   contig the same widths and depth on ``kv_layout="contig"`` (the A/B
          baseline of the paged layout): contig decode, contig chunk,
          flash;
   moe    Phi-3.5-MoE widths (d_model 4096, 32/8 heads, head dim 128, 16
          experts top-2, expert d_ff 6400, vocab 32064), depth
          ``--moe-layers``, auto (contig) layout, batch-1 exact-length
          admission: contig decode, flash;
   ssm    mamba2-1.3b at full width, depth ``--ssm-layers`` (24 of 48
          layers; 64 SSD heads of 64, state 128), auto (contig) layout,
          exact-length groups: the SSD scan;
   hybrid zamba2-2.7b at full width, depth ``--hybrid-layers`` (24 of 54
          Mamba2 layers: 4 shared-block applications, 32/32 heads of dim
          80), auto (contig) layout, exact-length groups: the SSD scan,
          flash, contig decode;
   server main's model, weights and traffic through a ``GlobalServer``
          (``dispatch="cost"``, ``use_kv_migration=True``, default
          ``FTTimes``) over three paged pipelines that carry the first
          placements of the port's paper-cluster plan for qwen3-32b and
          share one set of weights through a ``TensorStore``; after 8
          rounds one instance of the pipeline with the most live requests
          is interrupted; every request must finish with its tokens,
          migrated ones keeping theirs, at least one KV publish and attach,
          no payload left in a consistent store: paged decode, paged
          chunk, flash. It prints the virtual clock and round_s beside the
          wall, the events, the store's bytes at the interrupt, the engine
          rebuild's seconds and each pipeline's dispatches;
   pp     the paper's pipeline-parallel serve step: main's widths and
          depth, 8 rows of one 1024-token prompt length prefilled by the
          unsplit ``LM.prefill`` (contig, ``max_len`` 2080), the K/V laid
          into the PP layout, then 8 greedy PP steps in two stage layouts
          on this card: 2 stages at ``pod_flops`` [1.0, 0.5] (split [5,
          3], m 4) and 3 at [1.0, 0.6, 0.35] with m 4 (split [4, 3, 1]);
          the tokens must equal the unsplit ``LM.decode_step`` run one
          microbatch at a time (the same GEMM shapes) and
          ``decode_attention`` must launch m x sum(split) times a step;
          prints per layout the split, m, ticks per step, the median wall
          per step over ``--repeats`` runs, tok/s, the device-busy share,
          the launches per step and the peak GB; then split [5, 3] at m 4
          on a float8_e4m3fn cache (the prefill's K/V cast by
          ``astype``), whose tokens must equal the unsplit decode's on the
          same fp8 cache, every decode launch on it: contig decode;
   pp_ranks the same step as rank processes, one a stage
          (``build_step(serve_pp=True)`` on a (pod, data, model) mesh,
          ``run_ranks``, gloo, every rank on this card): the unsplit
          prefill's cache (8 rows of a 1024-token prompt, S 2080) goes to
          every rank, which keeps its layers, rows and KV heads; 8 steps
          at (2, 1, 1), split [5, 3], on a bf16 and a float8_e4m3fn cache
          (tokens and the last stage's logits bit-equal to the in-process
          step; fp32 at 2 layers: tokens equal to the unsplit decode) and
          at (2, 1, 2), split [4, 4] (the first step within path ``tp``'s
          ratio gate); ``decode_attention`` m x split[stage] times a step
          a rank, m hops a step; per world and rank: step wall, host
          queue, device busy, launches, hops and bytes, peak GB and the
          rank's seconds by part; with two cards, (2, 1, 1) over nccl,
          one rank a card: contig decode;
   tp     tensor parallelism (``launch/steps.py``'s ``build_step`` over a
          ``launch/mesh.py`` mesh of ranks, ``run_ranks``): main's widths,
          8 rows of a 1024-token prompt through ``prefill_step`` (cache
          S 2080, cut by sequence: ``store_cache`` lays it out by heads),
          then 8 greedy ``serve_step``s, on meshes (data 1, model 2),
          (1, 4) and (2, 2) in turns, every rank a process on
          this card (gloo over CUDA tensors, each all_reduce staged
          through the host); the unsplit ``LM`` runs first on the same
          card and weights. fp32 at 2 layers: every rank's tokens must
          equal the unsplit model's; bf16 at 4 layers: the prefill's
          last logits within 2e-2 of max |logit| of the unsplit bf16
          LM's; the first serve step's, on the fp32 prefill's cache as
          bf16 stores it (sharded) and tokens, at most 1.25 times as far
          from the unsplit LM evaluated in fp32 on the same values (the
          yardstick of phase 3) as the unsplit bf16 LM's (printed, with
          that LM on its rows in two halves against itself); then 8
          steps from the ranks' own prefill, each fed the
          unsplit bf16 model's token (equal argmaxes and
          the first divergence printed), decode and flash launched at the
          local heads (16/2 at model 4). Per mesh and rank: step wall,
          host queue, device busy, launches and all_reduce calls and
          bytes per step, peak GB and ``calibrate_allreduce`` over the
          model group (gloo through the host on one card: not a link);
          with four cards, (1, 4) over nccl, one rank per card: contig
          decode, flash;
   tp_seq the sequence-split KV cache (the reference's ``cache_seq``):
          qwen2-vl-2b (28 layers, 12/2 heads of 128) and whisper-tiny
          (6/6 heads) whole on a (1, 4) mesh of ranks on this card, one
          world for both (gloo); their KV heads do not divide 4, so each
          rank's cache holds every KV head of a quarter of the positions
          (whisper's cross cache too); 8 rows of a 1024-token prompt, 8
          serve steps, the decode kernel with its log-sum-exp output and
          the partials merged across the ranks; the gates of
          ``tp_families`` (fp32 tokens equal, bf16 within 1.25x the
          unsplit bf16 model's error from fp32, launches and all_reduce
          calls as reckoned), every step's decode with the lse output,
          the rank's K/V bytes as reckoned (qwen2-vl 119,275,520 at 8
          rows, S 2080, bf16) and qwen2-vl's first step on a
          float8_e4m3fn cache within 1.25x the unsplit fp8 step's error;
          prints the cache bytes beside the heads layout's, collectives a
          step (all_reduce / all_gather / all_to_all), step wall, host
          queue, device busy: flash, contig decode (with lse);
   prefill_seq the reference's ``seq`` rule (sequence-split
          activations) in ``build_step``'s prefill step, on gloo worlds of
          rank processes: (a) qwen3-32b's widths at 1 of 64 layers, bf16,
          8 rows of a 16384-token prompt on (1, 2), where ``build_rules``
          turns the rule on by itself (1.34 GB of residual stream); (b)
          granite-moe-3b-a800m at 4 layers and zamba2-2.7b at 6, fp32, 8
          rows of a 1024-token prompt on (1, 4), the rule through
          ``extra_rules``; each against the same step with ``{"seq":
          None}``, then serve steps on the cache cut by sequence. Gates:
          the rule on, the residual stream a rank holds cut, tokens equal,
          prefill logits within 2e-2 of max |logit| (a) or allclose 2e-5
          (b), (a)'s caches bit for bit, the prefill's collectives as
          ``pseq_reckoning`` writes them out (calls; (a) bytes too), every
          decode of the serve steps with its lse output; prints the peak
          GB of the prefill with and without the rule, its wall and
          collectives: flash, the SSD scan, contig decode (with lse);
   kv_fp8 fp8 KV caches: main's widths and depth through
          ``build_step``'s prefill step and serve steps on a (1, 1) mesh,
          8 rows of a 1024-token prompt, cache S 2080, the prefill's cache
          stored by ``BuiltStep.store_cache``, then 32 greedy serve steps
          on a bf16, a float8_e4m3fn and a float8_e5m2 cache in turns;
          gates: ``decode_attention`` launches layers x steps times a run,
          every one on the run's cache dtype; the first step's logits on
          an fp8 cache within the format's unit roundoff (2^-4, 2^-3) of
          max |logit| of the bf16 step on the fp8 values upcast; the fp8
          K/V bytes exactly half the bf16 ones; prints per format the step
          wall, tok/s, device busy, peak GB, the first step whose tokens
          leave the bf16 run's and the largest logit distance from it:
          flash (the prefill), contig decode;
   prefix main with ``prefix_share=True`` on its own traffic: four
          four-turn conversations over system prompts of 300, 1000, 1024
          and 1500 tokens, each request extending its predecessor's
          prompt by a user turn of 64-512 tokens: hits, shared tokens and
          copy-on-writes (a deferred one among them) must be > 0 and the
          pool must come back whole; the same traffic without sharing is
          timed in the same call, and its counters must equal those of
          the port's engine on the CPU at a reduced width: paged decode,
          paged chunk (the suffix dispatches), flash;
   legacy contig's model and traffic through ``admission="legacy"``
          (batch-1 exact-length prefill): flash, contig decode; its
          admit_s and retraces print beside contig's;
   vlm    qwen2-vl-2b whole (28 layers, 12/2 heads of 128, qkv bias,
          tied), paged, served from tokens (M-RoPE's three streams
          identical): paged decode, paged chunk, flash;
   cmdr   command-r-plus-104b at ``--cmdr-layers`` (8) of 64 (96/8 heads
          of 128 at d_model 12288, layernorm, tied 256000-token
          embedding; 31.5 GB of bf16 weights), paged: paged decode,
          paged chunk, flash;
   danube h2o-danube-3-4b whole (24 layers, 32/8 heads of 120, window
          4096), paged, on its own traffic: 16 requests of 2048-6000
          prompt tokens, half past the window, ``max_len`` 6176, all
          chunked: paged decode, paged chunk; then one ring-cache
          generation (2 rows of 6000 tokens, ``prefill(ring=True)``, 32
          greedy steps; flash and contig decode must launch) and, fed the
          same tokens, the linear cache: per-step logit difference and
          share of equal tokens printed, not gated;
   whisper whisper-tiny whole (4 + 4 layers, 6/6 heads of 64), contig
          (8 stubbed encoder frames a request): contig chunk, contig
          decode, flash (encoder, cross attention, prompt groups).
   Each model's params are freed before the next path is built;
6. ``train``: internlm2-1.8b whole (24 layers, d_model 2048, 16/8 heads
   of 128, vocab 92544, 1.9 B params), bf16, remat on, SyntheticLM(8,
   2048, seed 0) in choose_microbatches(8, 2048, 92544, 1) = 8
   microbatches, the reference's AdamW defaults (lr 3e-4 after 100
   warm-up steps): one warm-up step and six timed ones; the
   loss must be finite and fall, the flash forward and backward must
   launch; prints step seconds, the host's seconds to queue a step
   (``dispatch_s``, timed from a drained device), tok/s, model FLOPs /
   (step x 989 TFLOP/s), peak GB and launches per step (with ``--profile``, device
   busy / idle and time by category); no checkpoint at this width; then
   ``train_mamba2``: mamba2-1.3b whole (48 layers, d_model 2048, 64 SSD
   heads of 64, N 128, vocab 50280) the same way, four timed steps, the
   SSD scan and its backward launched; then ``train_mesh``: training over
   a mesh (``build_step``'s train step, FSDP over data, TP over model,
   ``launch/train_mesh.py``) on gloo worlds of rank processes on this
   card: internlm2-1.8b and mamba2-1.3b widths, SyntheticLM(4, 1024); a
   (data 2, model 2) world at 2 layers in fp32 (2 steps) held to the
   one-process step each rank then runs on this card (loss, grad_norm,
   every params and m leaf within 1e-4) and at 2 layers in bf16 (one
   timed step under a device-only profiler: first loss within 2e-2 of
   the one-process bf16 step's); a (pod 2, data 1, model 1) world of
   internlm2 bf16 the same way; the elastic sequence
   (the fp32 internlm2 run checkpointed from the mesh after step 2,
   ``plan_resize`` to 2 devices, a (1, 2) world restoring through
   ``state_shardings`` and taking step 3, equal to a one-process restore
   within 1e-4); launches per rank and step as ``tm_launches`` reckons
   them; per world and rank: step wall, host queue, device busy,
   gradient collectives a step, peak GB, global tok/s; then, on the (1,
   2) world, the ``seq`` rule in the train step: internlm2-1.8b widths at
   2 layers, 4 x 2048 tokens, one fp32 step with ``extra_rules={"seq":
   ("model",)}`` against one without it from the same init (bit-equal,
   or loss, grad_norm and every state leaf within 1e-6; printed which),
   then one timed bf16 step of each (peak GB, step wall, host queue,
   device busy, the cut's gathers, reduce-scatters and all_to_alls with
   their bytes, forward and backward; the flash forward with ``lse`` and
   its backward at the gathered sequence and the local heads); then
   ``dryrun`` (host only): the port's dry run on fake ranks
   (``launch/dryrun.py``) of qwen3-32b ``train_4k`` on (16, 16) with and
   without the ``seq`` rule (a rank's peak must fall), qwen3-32b
   ``decode_32k`` on (16, 16) and llama-3.1-70b ``decode_32k`` on (2, 16,
   16) with ``serve_pp``, and ``launch/roofline.py``'s terms for the
   ``train`` path's configuration on a (1, 1) mesh beside that path's
   step wall from this run; then ``lint``: (a) on the host,
   ``repro_torch.analysis`` (torchlint) over ``src/repro_torch`` against
   ``.torchlint-baseline``: no new finding and no stale entry, the
   findings printed by check; (b) on the card, a census of the host syncs
   PyTorch itself reports (``torch.cuda.set_sync_debug_mode("warn")``:
   the syncs that go through its sync hooks, ``memcpy_and_sync`` and
   ``stream_synchronize``, and no other) in three engines at 2 layers,
   the paged and the contig engine at Qwen3-32B widths and mamba2-1.3b,
   each serving the first 8 of main's requests (chunked admission
   included) for 16 new tokens: syncs per decode step and per admission
   by ``file:line`` and function (each at its innermost frame under
   ``src/repro_torch``, with the frame that called it), one JSON line;
   every site must lie on a line torchlint reports, baselined or
   suppressed with a reason, and the tokens must equal the same run's
   with the mode off;
7. a JSON line of per-kernel numbers (``decode_attention``'s row also
   carries its fp8 shapes and its launches by cache dtype in paths
   ``kv_fp8``, ``pp`` and ``pp_ranks``), the nvidia-smi line, and last ``{"ok": true,
   "device": {...}}``. A ``[time]`` line follows each phase.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis import torchlint  # noqa: E402
from repro_torch.analysis.baseline import load_baseline  # noqa: E402
from repro_torch.cluster import (PAPER_POOLS, ClusterSim,  # noqa: E402
                                 FTConfig, Topology,
                                 azure_conversation_like, generate_trace,
                                 interruption_events_for_window,
                                 select_scenario)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.core import Placement, Stage, populate_cluster  # noqa: E402
from repro_torch.hw import (AWS_INSTANCES, calibrate,  # noqa: E402
                            effective, paper_cluster, profiles)
from repro_torch.hw.calibration import (  # noqa: E402
    calibrate_model_allreduce)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import chunk_attention as ca  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import kv_probe as kvp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, mesh_for_rank,  # noqa: E402
                                     run_ranks)
from repro_torch.launch.pipeline import (build_pp_serve_step,  # noqa: E402
                                         pack_pp_params)
from repro_torch.launch.steps import build_step, serving_steps  # noqa: E402
from repro_torch.launch.train_mesh import (leaf_at, leaf_paths,  # noqa: E402
                                           rank_start)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import FP8_DTYPES, astype  # noqa: E402
from repro_torch.models.transformer import KV_KEYS, kv_select  # noqa: E402
from repro_torch.serving import (Engine, GlobalServer,  # noqa: E402
                                 ServeRequest, TensorStore)
from repro_torch.serving.kv_blocks import (KV_POISON,  # noqa: E402
                                           KVSanitizerError)
from repro_torch.train import (AdamWConfig, DataConfig,  # noqa: E402
                               SyntheticLM, choose_microbatches,
                               init_train_state, make_train_step)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import elastic as el  # noqa: E402
from repro_torch.train.data import to_torch  # noqa: E402
from repro_torch.train.optimizer import leaves  # noqa: E402

PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense FLOP/s
# (atol, rtol) of a kernel against its plain version evaluated in fp32 on
# the same input values. bf16: the kernel rounds P and the output to bf16,
# about one ulp of the element (2^-7 of it, inside rtol) and well under 5e-3
# elsewhere; one key too many or too few moves an element of an n-key row by
# about |v| / n, past the limit in the short rows every causal case has. The
# bf16 plain version is not the yardstick: it rounds the normalised
# probabilities to bf16 and is itself up to ~2e-2 off in rows of a few keys.
# fp32: the kernel sums in another order than the plain version's einsum.
TOL = {torch.bfloat16: (5e-3, 2e-2), torch.float32: (1e-4, 1e-4)}
QWEN = dict(nh=64, nkv=8, d=128)              # Qwen3-32B attention geometry
PHI = dict(nh=32, nkv=8, d=128)               # Phi-3.5-MoE attention geometry
ZAMBA = dict(nh=32, nkv=32, d=80)             # zamba2-2.7b shared attention
DANUBE = dict(nh=32, nkv=8, d=120)            # h2o-danube-3-4b (window 4096)
CMDR = dict(nh=96, nkv=8, d=128)              # command-r-plus-104b
WHISPER = dict(nh=6, nkv=6, d=64)             # whisper-tiny (MHA)
DANUBE_WINDOW = 4096
DANUBE_LEN = 6176             # the danube path's max_len: 6000 + 32 new
ENC_FRAMES = 8                # whisper's stubbed encoder frames per row
# positions across danube's window: the first key, either side of 4096,
# past it, the row's last key and one past it (the frozen dead row)
DANUBE_POS = [0, DANUBE_WINDOW - 1, DANUBE_WINDOW, DANUBE_WINDOW + 1, 5000,
              6000, DANUBE_LEN - 1, DANUBE_LEN]
HEAD_DIMS = _build.HEAD_DIMS
G_SWEEP = (1, 3, 4, 6, 7, 8, 12, 16)          # query heads per KV head
# groups that do not divide 128 (the prefill body pads its last rows; the
# decode body pads g to 16): (g, KV heads, head dim, window)
V1_CASES = [(3, 4, 32, None), (6, 2, 128, 50), (7, 2, 64, None),
            (12, 2, 80, None), (12, 1, 16, 50)]
GROUP = 4                     # the Engine's prefill_group: rows per prefill
BS = 16                       # the serving paths' KV block size
MAX_LEN = 2080                # 2048-token prompt + 32 new tokens
MOE = "phi3.5-moe-42b-a6.6b"
# serving paths of phase 5: the config, the Engine's layout and the kernels
# the path must launch; a config's depth flag is DEPTH_FLAG[config], and a
# config without one runs at full depth
PATHS = {
    "main": ("qwen3-32b", "auto",
             ("decode_attention_paged", "chunk_attention_paged",
              "flash_attention")),
    "sanitize": ("qwen3-32b", "auto",
                 ("decode_attention_paged", "chunk_attention_paged",
                  "flash_attention", "kv_probe")),
    "contig": ("qwen3-32b", "contig",
               ("decode_attention", "chunk_attention", "flash_attention")),
    "moe": (MOE, "auto", ("decode_attention", "flash_attention")),
    "ssm": ("mamba2-1.3b", "auto", ("ssd_scan",)),
    "hybrid": ("zamba2-2.7b", "auto",
               ("ssd_scan", "flash_attention", "decode_attention")),
    # the GlobalServer over three paged pipelines of main's model
    "server": ("qwen3-32b", "auto",
               ("decode_attention_paged", "chunk_attention_paged",
                "flash_attention")),
    # main's widths and depth through the pipeline-parallel serve step
    # (launch/pipeline.py): two uneven stage layouts on this card
    "pp": ("qwen3-32b", "contig", ("decode_attention",)),
    # the same step as rank processes, one a stage (build_step(serve_pp=
    # True) on a mesh with pod; launch/pipeline.py), TP inside a stage
    "pp_ranks": ("qwen3-32b", "contig", ("decode_attention",)),
    # main's widths and depth through build_step's prefill and serve steps
    # on tensor-parallel meshes of ranks on this card (launch/steps.py)
    "tp": ("qwen3-32b", "contig", ("decode_attention", "flash_attention")),
    # main's widths and depth through build_step's prefill and serve steps
    # on a (1, 1) mesh, the serve step on a bf16 cache and on fp8 caches
    # (kv_cache_dtype) in turns
    "kv_fp8": ("qwen3-32b", "contig", ("decode_attention",
                                       "flash_attention")),
    # the same for mamba2-1.3b and zamba2-2.7b (12 layers) and whisper-tiny
    # (TPF_FAMILIES; the first names the path)
    "tp_families": ("mamba2-1.3b", "contig",
                    ("ssd_scan", "flash_attention", "decode_attention")),
    # qwen2-vl-2b and whisper-tiny whole on a (1, 4) mesh of ranks: the
    # serve cache cut by sequence (cache_seq), the decode kernel's lse
    "tp_seq": ("qwen2-vl-2b", "contig",
               ("flash_attention", "decode_attention")),
    # the reference's seq rule in build_step's prefill step: qwen3-32b's
    # widths at 1 layer on (1, 2), build_rules turning it on by itself at
    # 8 x 16384 tokens; granite-moe and zamba2 on (1, 4) through
    # extra_rules; the serve steps on the cache cut by sequence
    "prefill_seq": ("qwen3-32b", "contig",
                    ("flash_attention", "ssd_scan", "decode_attention")),
    # main's model with prefix sharing, on shared-system-prompt traffic
    "prefix": ("qwen3-32b", "auto",
               ("decode_attention_paged", "chunk_attention_paged",
                "flash_attention")),
    # contig's model and traffic through the batch-1 legacy admission
    "legacy": ("qwen3-32b", "contig", ("flash_attention",
                                       "decode_attention")),
    # qwen2-vl-2b whole: M-RoPE (served from tokens: identical streams),
    # qkv bias, tied embeddings, 12/2 heads (g = 6)
    "vlm": ("qwen2-vl-2b", "auto",
            ("decode_attention_paged", "chunk_attention_paged",
             "flash_attention")),
    # command-r-plus-104b at --cmdr-layers of 64: 96/8 heads (g = 12) at
    # d_model 12288, layernorm, a 256000-token tied embedding
    "cmdr": ("command-r-plus-104b", "auto",
             ("decode_attention_paged", "chunk_attention_paged",
              "flash_attention")),
    # h2o-danube-3-4b whole: head dim 120 and the 4096 window, on prompts
    # past it (all chunked: no flash); then one ring-cache generation,
    # which must launch flash and the contiguous decode kernel
    "danube": ("h2o-danube-3-4b", "auto",
               ("decode_attention_paged", "chunk_attention_paged")),
    # whisper-tiny whole: the encoder-decoder on its contiguous layout
    "whisper": ("whisper-tiny", "auto",
                ("chunk_attention", "decode_attention", "flash_attention")),
}
# Engine keywords a path adds to the shared ones
PATH_KW = {"sanitize": dict(kv_sanitize=True),
           "prefix": dict(prefix_share=True),
           "legacy": dict(admission="legacy")}
# the prefix path's system prompts, one four-turn conversation each: 300
# fits prefill_chunk (its first request prefills in a group), 1024 is
# block-aligned, 1000 and 1500 are not
PREFIX_SYSTEM = (300, 1000, 1024, 1500)
DEPTH_FLAG = {"qwen3-32b": "layers", MOE: "moe_layers",
              "command-r-plus-104b": "cmdr_layers",
              "mamba2-1.3b": "ssm_layers", "zamba2-2.7b": "hybrid_layers"}
DANUBE_RING = (2, 6000, 32)   # the ring generation: rows, prompt, new tokens
ALL_PHASES = ("build", "calibrate", "kernels", "parity", "cluster") + tuple(
    PATHS) + ("train", "train_mamba2", "train_mesh", "dryrun", "lint")


def log(msg: str = "") -> None:
    print(msg, flush=True)


# -- phase 1: device -------------------------------------------------------------
def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": smi_line()}
    log(f"[device] {info['kind']} x{info['count']}; nvidia-smi: "
        f"{info['smi']}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32=False, "
        "torch.backends.cudnn.allow_tf32=False")
    return info


# -- phase 2: build --------------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.load()
    dt = time.perf_counter() - t0
    d = _build.build_dir()
    log(f"[build] {'built' if _build.build_info['built'] else 'loaded'} "
        f"{_build.build_info['path']} in {dt:.1f} s; entry points "
        f"{sorted(n for n in _build.SIGNATURES if getattr(lib, n))}")
    logf = d / "build.log"
    if logf.exists():
        spills, fn = 0, ""
        for line in logf.read_text().splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            fn = m.group(1) if m else fn
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills += 1
                log(f"[build] SPILL {fn}: {line.strip()}")
            elif ("Used" in line or "warning" in line.lower()
                  or "Performance Loss" in line):
                log(f"[build] {fn}: {line.strip()}")
        log(f"[build] {spills} functions spill")


# -- phase 2b: calibration -------------------------------------------------------
# H100-sized shapes for the ported hw.calibration pass in bf16: GEMMs big
# enough to run at the tensor cores' rate, GEMV matrices of 128-512 MiB so
# the HBM stream dominates and the 50 MB L2 holds no matrix
CALIB_GEMM = (4096, 6144, 8192)
CALIB_GEMV = (8192, 12288, 16384)


def phase_calibrate(dev, rehearsal: bool) -> None:
    """The paper's one-time calibration (``repro_torch.hw.calibrate``) in
    bf16: effective FLOP/s (GEMM median), HBM bytes/s (GEMV median) and the
    copy-based one-device link fit, printed beside the H100 profile's
    data-sheet peaks and the paper's derates of them. Nothing is gated on
    the numbers."""
    gemm, gemv = ((64, 96, 128), (128, 192, 256)) if rehearsal else (
        CALIB_GEMM, CALIB_GEMV)
    name = "cpu" if rehearsal else torch.cuda.get_device_name(0)
    res = calibrate(device_name=name, gemm_sizes=gemm, gemv_sizes=gemv,
                    dtype=torch.bfloat16, device=dev)
    peak = profiles.H100
    der = effective(peak)
    where = ("CPU rehearsal, not a device metric" if rehearsal
             else f"nvidia-smi: {smi_line()}")
    log(f"[calibrate] {name} ({where}), bf16, {res.wall_time_s:.2f} s")
    log(f"[calibrate] GEMM {gemm}: effective {res.eff_flops / 1e12:.1f} "
        f"TFLOP/s (samples "
        f"{[round(x / 1e12, 1) for x in res.samples['gemm_flops']]}); H100 "
        f"profile {peak.flops_bf16 / 1e12:.0f} TFLOP/s, derated "
        f"{der.flops_bf16 / 1e12:.1f} ({der.flops_bf16 / peak.flops_bf16:.2f}"
        f"x); measured / profile {res.eff_flops / peak.flops_bf16:.3f}")
    log(f"[calibrate] GEMV {gemv}: effective {res.eff_mem_bw / 1e9:.0f} "
        f"GB/s (samples "
        f"{[round(x / 1e9) for x in res.samples['gemv_bps']]}); H100 "
        f"profile {peak.mem_bw / 1e9:.0f} GB/s, derated "
        f"{der.mem_bw / 1e9:.0f} ({der.mem_bw / peak.mem_bw:.2f}x); "
        f"measured / profile {res.eff_mem_bw / peak.mem_bw:.3f}")
    log(f"[calibrate] one-device copy fit: alpha {res.net_alpha_s * 1e6:.2f}"
        f" us, beta {res.eff_net_bps / 1e9:.0f} GB/s (no link: the "
        f"collective degenerates to a copy on one card)")


# -- timing ----------------------------------------------------------------------
_WARM_STREAM = None


def time_ms(fn, iters: int = 20, warmup: int = 3, graph: bool = False
            ) -> float:
    """Mean time of ``fn`` in ms. On the card: CUDA events around
    ``iters`` eager calls (the rate the host sustains, the lower bound of a
    call in the serving loop), or with ``graph`` around one replay of a
    CUDA graph of ``iters`` calls (the device's time per call, without the
    host's launch cost, which exceeds the device time of a decode call).
    Otherwise the host clock around a loop (rehearsal only)."""
    if not graph or not torch.cuda.is_available():
        for _ in range(warmup):
            fn()
        if not torch.cuda.is_available():
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    global _WARM_STREAM
    if _WARM_STREAM is None:
        # one stream for every warm-up: each new stream that runs a cuBLAS
        # call keeps a workspace allocated for the rest of the process
        _WARM_STREAM = torch.cuda.Stream()
    side = _WARM_STREAM
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up off the capture stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_b = nbytes / PEAK_BYTES
    t_o = flops / PEAK_OPS[dtype]
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# -- phase 3: kernels vs plain ---------------------------------------------------
class Cases:
    """Random inputs on ``device`` from one seeded generator."""

    def __init__(self, device, seed: int = 0):
        self.dev = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def randn(self, *shape, dtype):
        return torch.randn(shape, generator=self.gen, device=self.dev,
                           dtype=torch.float32).to(dtype)

    def randint(self, lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=self.gen,
                             device=self.dev, dtype=torch.int32)

    def pool(self, b, mb, bs, nkv, d, dtype):
        n_blocks = 1 + b * mb
        pk = self.randn(n_blocks, bs, nkv, d, dtype=dtype)
        pv = self.randn(n_blocks, bs, nkv, d, dtype=dtype)
        perm = torch.randperm(b * mb, generator=self.gen, device=self.dev)
        tbl = (perm.reshape(b, mb) + 1).to(torch.int32)
        return pk, pv, tbl


def _visible(qpos: np.ndarray, s_virt: int, window) -> tuple:
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
    return np.minimum(qpos, s_virt - 1) - lo + 1, lo


def _kv_bytes(lo, hi, nkv, d, esz, tbl=None, bs=0) -> int:
    """Bytes of K/V that rows reaching keys ``lo[r]..hi[r]`` must read, each
    byte once: a contiguous row its own keys; through a block table each
    distinct pool block once, however many rows or table entries point at
    it (dead rows all point at trash block 0), plus the table entries each
    row reads."""
    if tbl is None:
        return int((hi - lo + 1).sum()) * nkv * d * 2 * esz
    ids = [tbl[r, l // bs:h // bs + 1] for r, (l, h) in enumerate(zip(lo, hi))]
    distinct = len(np.unique(np.concatenate(ids)))
    return distinct * bs * nkv * d * 2 * esz + 4 * sum(map(len, ids))


def decode_work(pos, s, nh, nkv, d, window, esz, tbl=None, bs=0,
                kv_esz=None):
    """Bytes and operations of one decode call over ``s`` (virtual) keys
    per row; a pool's when ``tbl`` is given, else a contiguous cache's.
    ``kv_esz``: bytes of a K/V element where they differ from q's (an fp8
    cache: 1)."""
    pos = np.asarray(pos).astype(np.int64)
    b = pos.shape[0]
    vis, lo = _visible(pos, s, window)
    hi = np.minimum(pos, s - 1)
    nbytes = (2 * b * nh * d * esz
              + _kv_bytes(lo, hi, nkv, d, kv_esz or esz, tbl, bs) + 4 * b)
    return nbytes, 4.0 * nh * d * vis.sum()


def chunk_work(bases, b, c, s, nh, nkv, d, window, esz, tbl=None, bs=0):
    """Each row reads its keys from the first query's window start through
    the last query's position, once each."""
    bases = np.broadcast_to(np.asarray(bases), (b,)).astype(np.int64)
    qpos = bases[:, None] + np.arange(c)[None, :]
    vis, _ = _visible(qpos, s, window)
    lo = np.maximum(0, bases - window + 1) if window else np.zeros(b, int)
    hi = np.minimum(bases + c - 1, s - 1)
    nbytes = (2 * b * c * nh * d * esz
              + _kv_bytes(lo, hi, nkv, d, esz, tbl, bs) + 4 * b)
    return nbytes, 4.0 * nh * d * vis.sum()


def flash_work(b, s, nh, nkv, d, window, esz, causal=True, sk=None):
    """q and out of ``s`` rows, K/V of ``sk`` (default ``s``); causal
    (and windowed) rows see their visible keys, non-causal rows all."""
    sk = s if sk is None else sk
    vis = _visible(np.arange(s), s, window)[0].sum() if causal else s * sk
    nbytes = (2 * b * s * nh * d + 2 * b * sk * nkv * d) * esz
    return nbytes, 4.0 * b * nh * d * vis


def _sdpa_inputs(q, k, v, mask):
    """(B,S,n,d) -> (B,n,S,d) with K/V heads repeated to the query heads."""
    g = q.shape[2] // k.shape[2]
    tr = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
    return (tr(q), tr(k.repeat_interleave(g, dim=2)),
            tr(v.repeat_interleave(g, dim=2)), mask)


def check(name, out, ref, dtype, label, plain_err: float) -> float:
    err = (out.float() - ref).abs().max().item()
    atol, rtol = TOL[dtype]
    ok = torch.allclose(out.float(), ref, atol=atol, rtol=rtol)
    finite = bool(torch.isfinite(out.float()).all())
    log(f"[kernels] {name:24s} {label:44s} max_abs_err={err:.3e} "
        f"(plain in {str(dtype)[6:]}: {plain_err:.3e}) atol={atol:g} "
        f"rtol={rtol:g} {'ok' if ok and finite else 'FAIL'}")
    if not (ok and finite):
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                         f"version ({label})")
    return err


def in_fp32(fn):
    """``fn`` evaluated in fp32 on the same input values (integer tables
    and positions as they are)."""
    def run(*args, **kw):
        return fn(*(a.float() if torch.is_tensor(a) and a.is_floating_point()
                    else a for a in args), **kw)
    return run


def compare(name, run, plain, cases, keep=()) -> tuple:
    """Each case ``(label, dtype, args, kw)`` through the kernel, held
    against its plain version evaluated in fp32 on the same input values
    (the error of the plain version in the case's dtype is logged beside
    it); returns the first case's args and error (the main shape, which is
    timed with the default keywords) and the args of the cases whose labels
    are in ``keep`` (timed too)."""
    main, kept = None, {}
    for label, dtype, args, kw in cases:
        ref = in_fp32(plain)(*args, **kw).float()
        plain_err = (plain(*args, **kw).float() - ref).abs().max().item()
        err = check(name, run(*args, **kw), ref, dtype, label, plain_err)
        main = main or (args, err)
        if label in keep:
            kept[label] = args
    return main + (kept,)


def time_both(fn) -> tuple:
    """(eager ms, device ms) of ``fn``: see ``time_ms``."""
    return time_ms(fn), time_ms(fn, graph=True)


def fmt_ms(ms, dev_ms) -> str:
    if ms is None:
        return "none"
    return f"{ms:.4f} ms" + ("" if dev_ms is None else
                             f" (device {dev_ms:.4f})")


def time_shape(name, run, args, library, work, shape, kw=None,
               plain=None) -> dict:
    """Time the kernel and its library yardstick at one more shape a
    serving path gives it, and its plain version where ``plain`` is given;
    the bound comes from ``work``."""
    kw = kw or {}
    ms, dev_ms = time_both(lambda: run(*args, **kw))
    lib_ms, lib_dev_ms = (None, None) if library is None else \
        time_both(library)
    plain_ms = None if plain is None else time_ms(
        lambda: plain(*args, **kw), iters=3, warmup=1)
    b_ms, b_by = bound(*work, torch.bfloat16)
    log(f"[kernels] {name:24s} kernel {ms:.4f} ms (device {dev_ms:.4f})  "
        f"library {fmt_ms(lib_ms, lib_dev_ms)}  plain "
        f"{fmt_ms(plain_ms, None)}  bound {b_ms:.4f} ms ({b_by})  {shape}")
    out = dict(shape=shape, ms=ms, device_ms=dev_ms, library_ms=lib_ms,
               library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    if plain is not None:
        out["plain_ms"] = plain_ms
    return out


def measure(name, module, run, plain, args, err, library, work, shape,
            plain_iters: int = 5, kw=None) -> dict:
    """Time the kernel, its plain version and the library yardstick (None:
    there is no library call) on the main case; the bound comes from
    ``work`` (bytes, operations)."""
    kw = kw or {}
    ms, dev_ms = time_both(lambda: run(*args, **kw))
    plain_ms = time_ms(lambda: plain(*args, **kw), iters=plain_iters,
                       warmup=min(3, plain_iters))
    lib_ms, lib_dev_ms = (None, None) if library is None else \
        time_both(library)
    b_ms, b_by = bound(*work, torch.bfloat16)
    return dict(name=name, route="cuda", source=module.SOURCE,
                replaces=module.REPLACES[name], max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, shape=shape)


def kv_inputs(cs, paged, b, s, nkv, d, bs, dtype) -> tuple:
    """K/V of ``b`` rows of ``s`` positions: a shuffled block pool of
    ``bs``-token blocks and its table (``s`` rounded up to whole blocks),
    or a contiguous cache. Returns (the kernel's K/V arguments, s)."""
    if paged:
        pk, pv, tbl = cs.pool(b, -(-s // bs), bs, nkv, d, dtype)
        return (pk, pv, tbl), tbl.shape[1] * bs
    return (cs.randn(b, s, nkv, d, dtype=dtype),
            cs.randn(b, s, nkv, d, dtype=dtype)), s


def dense_kv(kv_args, b) -> tuple:
    """Each row's K/V as (b, s, nkv, d), gathered through the table of a
    pool; for the library yardstick."""
    if len(kv_args) == 2:
        return kv_args
    pk, pv, tbl = kv_args
    return tuple(x[tbl.long()].reshape(b, -1, *x.shape[2:]) for x in (pk, pv))


def _geometry(geo: dict, rehearsal: bool) -> tuple:
    return (4, 2, 16) if rehearsal else (geo["nh"], geo["nkv"], geo["d"])


def kernel_decode(cs, dev, rehearsal, paged: bool) -> dict:
    """Decode attention against 8 rows of ``max_len`` 2080 with ragged
    positions and one dead row (paged: on the trash table; contiguous:
    frozen one past the end of its row, where the kernel clamps its reach).
    Paged (kernel 1) at the main path's Qwen3-32B heads; contiguous (kernel
    4) at Phi-3.5-MoE's 32/8 heads (MoE path, timed), Qwen3-32B's 64/8
    (contig path) and zamba2's 32/32 of dim 80 (hybrid path)."""
    name = "decode_attention_paged" if paged else "decode_attention"
    plain = getattr(da, name + "_plain")
    run = in_fp32(plain) if rehearsal else getattr(da, name)
    bf, f32 = torch.bfloat16, torch.float32
    geos = [QWEN] if paged else [PHI, QWEN, ZAMBA]
    B, S = 8, (64 if rehearsal else MAX_LEN)
    nh, nkv, d = _geometry(geos[0], rehearsal)
    specs = [(bf, (*_geometry(g, rehearsal), B, S, BS), None, True,
              f"main GQA {g['nh']}/{g['nkv']} bf16") for g in geos] + [
        (bf, (nh, nkv, d, B, S, BS), 256, True, "main SWA=256 bf16"),
        (bf, (4, 2, 16, 3, 37, 8), None, True, "GQA 4/2 d16 S=37 bf16"),
        (f32, (4, 2, 16, 3, 37, 8), None, True, "GQA 4/2 d16 S=37 fp32"),
        (f32, (4, 4, 32, 3, 40, 8), 8, False, "MHA d32 SWA=8 scalar pos fp32"),
        (f32, (8, 2, 64, 2, 300, 16), None, True, "GQA 8/2 d64 S=300 fp32"),
        (bf, (4, 4, 80, 3, 37, 8), None, True, "MHA d80 S=37 bf16"),
        (f32, (4, 4, 80, 3, 37, 8), None, True, "MHA d80 S=37 fp32")]
    d120 = "danube d120 SWA=4096 pos across the window bf16"
    whisper = "whisper MHA 6/6 d64 bf16"
    # a microbatch of the pp path's step: 2 rows at one position
    pp_label = "pp step mb=2 GQA 64/8 one pos bf16"
    pp_pos = PP_PROMPT + 16      # half-way through 32 steps
    if not rehearsal:
        # head dim 120 (h2o-danube-3-4b): its own geometry and window with
        # positions on both sides of it, g = 1 and 4, bf16 and fp32, short
        # windows, ragged positions; whisper-tiny's decoder heads
        specs += [
            (bf, (*_geometry(DANUBE, rehearsal), len(DANUBE_POS),
                  DANUBE_LEN, BS), DANUBE_WINDOW, DANUBE_POS, d120),
            (bf, (8, 8, 120, 3, 300, 24), 20, True,
             "g=1 d120 SWA=20 blocks of 24 bf16"),
            (bf, (32, 8, 120, 3, 300, BS), None, True, "g=4 d120 bf16"),
            (f32, (32, 8, 120, 3, 300, BS), 40, True, "g=4 d120 SWA=40 fp32"),
            (f32, (8, 8, 120, 3, 300, 24), None, True, "g=1 d120 fp32"),
            (bf, (*_geometry(WHISPER, rehearsal), B, S, BS), None, True,
             whisper)]
    # a tp path step on one rank: 8 rows at one position, Qwen3-32B's heads
    # split over a model axis of 4 (16/2) and of 2 (32/4)
    tp_pos = TP_PROMPT + 16      # half-way through 32 steps
    tp_geo = {m: dict(nh=QWEN["nh"] // m, nkv=QWEN["nkv"] // m, d=QWEN["d"])
              for m in (4, 2)}
    tp_label = {m: f"tp model {m} shard GQA {g['nh']}/{g['nkv']} one pos "
                   f"bf16" for m, g in tp_geo.items()}
    # a tp_families path step of zamba2's shared block on a rank of model
    # 4 (row 4g): 8 of its 32 MHA heads of 80, 8 rows at one position
    tpf_geo = dict(nh=ZAMBA["nh"] // 4, nkv=ZAMBA["nkv"] // 4, d=ZAMBA["d"])
    tpf_pos = 1040
    tpf_label = "tp_families zamba2 model 4 shard MHA 8/8 d80 one pos bf16"
    if not paged and not rehearsal:
        specs.append((bf, (*_geometry(QWEN, rehearsal), 2, S, BS), None,
                      [pp_pos] * 2, pp_label))
        specs += [(bf, (*_geometry(g, rehearsal), B, S, BS), None,
                   [tp_pos] * B, tp_label[m]) for m, g in tp_geo.items()]
        specs.append((bf, (*_geometry(tpf_geo, rehearsal), B, S, BS), None,
                      [tpf_pos] * B, tpf_label))
    if paged and not rehearsal:
        # the bf16 body through the block table (kernel 1 runs the contig
        # body's split walk with a paged key policy): positions at 0, at a
        # block's last key and the next (15 / 16, 23 / 24), at a tile's
        # (63 / 64 / 65) and a split's (1535 / 1536, 192-key splits when a
        # row is cut into 9) edges, the row's last key and one past it on
        # the trash table (the frozen dead row: the last row of every
        # case); pool blocks of 16 and 24 (a block straddles a 64-key
        # tile); windows shorter than a block and across splits; B = 1;
        # g = 1 / 3 / 4 / 6 / 7 / 8 / 12 / 16 at every head dim; g = 32
        # (the FP32-pipe body)
        e16 = [0, 15, 16, 63, 64, 65, 1535, 1536, MAX_LEN - 1, MAX_LEN]
        e24 = [0, 23, 24, 63, 64, 1535, 1536, 2087, 2088]   # S = 2088
        specs += [
            (bf, (32, 8, 128, len(e16), MAX_LEN, 16), None, e16,
             "g=4 block/tile/split edges + dead row bf16"),
            (bf, (32, 8, 128, len(e24), MAX_LEN, 24), None, e24,
             "g=4 blocks of 24 edges + dead row bf16"),
            (bf, (32, 8, 128, len(e16), MAX_LEN, 16), 8, e16,
             "g=4 SWA=8 < block bf16"),
            (bf, (32, 8, 128, len(e24), MAX_LEN, 24), 20, e24,
             "g=4 SWA=20 < block of 24 bf16"),
            (bf, (32, 8, 128, len(e16), MAX_LEN, 16), 300, e16,
             "g=4 SWA=300 across splits bf16"),
            (bf, (64, 8, 128, 1, 1000, BS), None, [999],
             "B=1 g=8 S=1000 bf16"),
            (bf, (32, 1, 16, 3, 200, BS), None, True,
             "g=32 d16 (FP32-pipe body) bf16")]
        specs += [
            (bf, (2 * g, 2, dd, 3, 300, (16, 24)[i % 2]), None, True,
             f"g={g} d{dd} blocks of {(16, 24)[i % 2]} bf16")
            for i, (dd, g) in enumerate(
                (dd, g) for dd in HEAD_DIMS for g in G_SWEEP)]
    if not paged and not rehearsal:
        # the bf16 contiguous body's edges: positions at 0, at a split's
        # last key, its first and the key after (64-key splits for short
        # rows; 192-key splits at 1535 / 1536 when a row is cut into 9),
        # the end of the row and the frozen dead row; windows shorter than
        # a tile and across splits; S not a multiple of the 64-key tile;
        # B = 1; g = 1 / 4 / 8 / 16 at every head dim; g = 32 (the
        # FP32-pipe body)
        edge = [0, 63, 64, 65, 1535, 1536, MAX_LEN - 1, MAX_LEN]
        specs += [
            (bf, (32, 8, 128, 8, MAX_LEN, BS), None, edge,
             "g=4 split edges + dead row bf16"),
            (bf, (32, 8, 128, 8, MAX_LEN, BS), 20, edge, "g=4 SWA=20 bf16"),
            (bf, (32, 8, 128, 8, MAX_LEN, BS), 300, edge,
             "g=4 SWA=300 across splits bf16"),
            (bf, (64, 8, 128, 1, 1000, BS), None, [999],
             "B=1 g=8 S=1000 bf16"),
            (bf, (16, 2, 64, 3, 1000, BS), None, [0, 640, 1000],
             "g=8 d64 S=1000 bf16"),
            (bf, (8, 8, 16, 3, 300, BS), None, True, "g=1 d16 bf16"),
            (bf, (16, 4, 32, 3, 300, BS), 40, True, "g=4 d32 SWA=40 bf16"),
            (bf, (32, 32, 80, 4, 700, BS), None, [0, 64, 699, 700],
             "g=1 d80 bf16"),
            (bf, (8, 2, 80, 3, 300, BS), None, True, "g=4 d80 bf16"),
            (bf, (32, 4, 128, 3, 500, BS), None, True, "g=8 d128 bf16"),
            (bf, (32, 2, 64, 3, 500, BS), None, True, "g=16 d64 bf16"),
            (bf, (32, 1, 16, 3, 200, BS), None, True,
             "g=32 d16 (FP32-pipe body) bf16")] + [
            (bf, (g * kv, kv, dd, 3, 400, BS), win, True,
             f"g={g} d{dd}{' SWA=50' if win else ''} bf16")
            for g, kv, dd, win in V1_CASES]

    def cases():
        for dtype, (h, kv, dd, b, s, bs), win, vec, label in specs:
            kvs, s = kv_inputs(cs, paged, b, s, kv, dd, bs, dtype)
            q = cs.randn(b, 1, h, dd, dtype=dtype)
            if isinstance(vec, list):       # explicit positions, row by row
                pos = torch.tensor(vec, dtype=torch.int32, device=dev)
            else:
                pos = cs.randint(0, s, (b,)) if vec else s - 3
            if paged:
                kvs[2][-1] = 0          # a dead row: trash table, frozen pos
            elif vec is True:
                pos[-1] = s             # a dead row, frozen past its row's end
            yield label, dtype, (q, *kvs, pos), dict(window=win)
    zlabel = f"main GQA {ZAMBA['nh']}/{ZAMBA['nkv']} bf16"
    # timed beside the main shape: the hybrid path's d=80 heads (contig),
    # the danube path's d=120 heads past the window (paged), the whisper
    # path's decoder heads (contig), a pp path step's microbatch (contig)
    ragged = "ragged pos, one dead row"
    timed = [] if rehearsal else (
        [(d120, DANUBE, DANUBE_WINDOW, ragged)] if paged else
        [(zlabel, ZAMBA, None, ragged), (whisper, WHISPER, None, ragged),
         (pp_label, QWEN, None, f"pos {pp_pos} in both rows")] + [
            (tp_label[m], g, None, f"pos {tp_pos} in every row")
            for m, g in tp_geo.items()])
    if not paged and not rehearsal:
        timed.append((tpf_label, tpf_geo, None,
                      f"pos {tpf_pos} in every row (row 4g)"))
    args, err, kept = compare(name, run, plain, cases(),
                              keep=[t[0] for t in timed])
    row = measure(name, da, run, plain, args, err,
                  *decode_yardstick(args, B, dev, nh, nkv, d, paged))
    row["timed_shapes"] = [
        time_shape(name, run, kept[label],
                   *decode_yardstick(kept[label], kept[label][0].shape[0],
                                     dev, *_geometry(geo, rehearsal), paged,
                                     window=win, note=note),
                   kw=dict(window=win), plain=plain)
        for label, geo, win, note in timed]
    if not paged and not rehearsal:
        for m, g in tp_geo.items():
            split, nsplit = da._plan(B, g["nh"], g["nkv"], S, 0, True,
                                     da._sm_count(dev.index or 0))
            log(f"[kernels] decode_attention {tp_label[m]}: S {S} in "
                f"{nsplit} splits of {split} keys, B x nkv x splits = "
                f"{B * g['nkv'] * nsplit} CTAs over "
                f"{da._sm_count(dev.index or 0)} SMs")
    if not paged:
        row["timed_shapes"] += kernel_ring(cs, dev, rehearsal)
        row["fp8_shapes"] = kernel_decode_fp8(cs, dev, rehearsal)
    return row


VLM = dict(nh=12, nkv=2, d=128)               # qwen2-vl-2b (12 / 2 heads)
TPS_MESH = (1, 4)             # path tp_seq's mesh: the cache cut into 4
LSE_REPLACES = da.REPLACES["decode_attention"]
# the lse rows' (query, KV) heads per head dim: qwen2-vl's 12 / 2 at 128
# (and the rehearsal's 16), whisper's 6 / 6 at 64, zamba2-like MHA at 80,
# danube's 32 / 8 at 120
LSE_HEADS = {16: (12, 2), 64: (6, 6), 80: (8, 8), 120: (32, 8),
             128: (12, 2)}


def _lse_check(label, dtype, got, ref, plain_err: float,
               vmax: float = 1.0) -> float:
    """The kernel's (out, lse) against the plain version's evaluated in
    fp32: the output (over max |V|) and the finite lse within the phase's
    tolerance, the rows that see no key -inf and 0 on both sides;
    ``plain_err``: the plain version's own output error in q's dtype."""
    (o, lse), (ro, rlse) = got, ref
    dead = torch.isneginf(rlse)
    same_dead = bool(torch.equal(torch.isneginf(lse), dead) and not o.float(
    ).reshape(dead.shape + (-1,))[dead].any())
    ok_lse = torch.allclose(torch.where(dead, 0, lse), torch.where(
        dead, 0, rlse), atol=TOL[dtype][0], rtol=TOL[dtype][1])
    err = check("decode_attention_lse", o.float() / vmax, ro.float() / vmax,
                dtype, f"{label} out", plain_err / vmax)
    lerr = (torch.where(dead, 0, lse) - torch.where(dead, 0, rlse)
            ).abs().max().item()
    log(f"[kernels] decode_attention_lse {label}: lse max_abs_err="
        f"{lerr:.3e}, rows that see no key -inf with output 0 on both "
        f"sides: {same_dead} ({int(dead[:, 0].sum())} rows) "
        f"{'ok' if ok_lse and same_dead else 'FAIL'}")
    if not (ok_lse and same_dead):
        raise SystemExit(f"chip_smoke: decode_attention's lse output "
                         f"disagrees with its plain version ({label})")
    return max(err, lerr)


def kernel_decode_lse(cs, dev, rehearsal) -> dict:
    """Kernel 4's log-sum-exp output (``lse=``: the partial of one slice of
    a cache cut by sequence, path tp_seq), held to the plain version's
    (out, lse) evaluated in fp32: bf16 and fp32 q, head dims 64 / 80 / 120
    / 128, caches in q's dtype, float8_e4m3fn and float8_e5m2, local
    positions before the slice (lse -inf, out 0), inside it, at and past
    its end, and a window. The kernel without ``lse`` gives, bit for bit,
    the output with it rounded to q's dtype (the null pointer leaves the
    combine as it was). Then the merge on the card: a (8, 2080, 2, 128)
    cache cut into 4 slices of 520, the kernel with ``lse`` on each at
    the local positions, ``merge_partials``, against the kernel on the
    whole cache (fp32 2e-5, bf16 2e-2). Timed at path tp_seq's shapes on
    a rank of (1, 4): qwen2-vl's gathered 12 query heads on a 520-key
    slice, whisper's 6 on its self and cross slices, against the same
    call without ``lse``."""
    name = "decode_attention_lse"
    plain = da.decode_attention_plain
    run = in_fp32(plain) if rehearsal else da.decode_attention
    bf, f32 = torch.bfloat16, torch.float32
    S = 64 if rehearsal else 520
    b = 8
    # local positions: before the slice, its first key, inside, its last
    # key, one past it, far past it, a ragged one, a frozen-row one
    pos_l = [-700, -1, 0, S // 3, S - 1, S, S + 900, 2 * S // 3]
    err, specs = 0.0, []
    for d in ((16,) if rehearsal else (64, 80, 120, 128)):
        for dtype in (bf, f32):
            for fmt in (None,) + tuple(FP8_DTYPES):
                specs.append((dtype, d, fmt, None))
        specs.append((bf, d, None, 200))
    for dtype, d, fmt, win in specs:
        nh, nkv = LSE_HEADS[d]
        q = cs.randn(b, 1, nh, d, dtype=dtype)
        if fmt:
            k, v = (fp8_cache(cs, (b, S, nkv, d), FP8_DTYPES[fmt])
                    for _ in range(2))
        else:
            k, v = (cs.randn(b, S, nkv, d, dtype=dtype) for _ in range(2))
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        lse = torch.empty((b, nh), dtype=f32, device=dev)
        got = run(q, k, v, pos, window=win, lse=lse)
        ref_lse = torch.empty_like(lse)
        ref = in_fp32(plain)(q, k, v, pos, window=win, lse=ref_lse)
        own = plain(q, k, v, pos, window=win, lse=torch.empty_like(lse))
        plain_err = (own[0] - ref[0]).abs().max().item()
        label = (f"q {str(dtype)[6:]} d{d} {nh}/{nkv} cache "
                 f"{fmt or str(dtype)[6:]}{f' SWA={win}' if win else ''} "
                 f"S={S} local pos {pos_l}")
        vmax = max(v.float().abs().max().item(), 1.0) if fmt else 1.0
        err = max(err, _lse_check(label, dtype, got, ref, plain_err, vmax))
        if not rehearsal:
            # without lse: the same kernel's output, rounded once to q's type
            bare = run(q, k, v, pos, window=win)
            same = torch.equal(_bits(bare), _bits(got[0].to(dtype)))
            log(f"[kernels] {name} {label}: the call without lse == its "
                f"fp32 output rounded to {str(dtype)[6:]}, bit for bit: "
                f"{same}")
            if not same:
                raise SystemExit(f"chip_smoke: decode_attention without "
                                 f"lse differs from its lse call ({label})")
    merge_err = kernel_lse_merge(cs, dev, rehearsal, run)
    row = dict(name=name, route="cuda", source=da.SOURCE,
               replaces=LSE_REPLACES, max_abs_err=max(err, merge_err),
               shape=f"q=({b},1,12,128) bf16, cache slice=({b},{S},2,128) "
                     f"bf16, local positions {pos_l}")
    if rehearsal:
        return row
    timed = [("tp_seq qwen2-vl rank slice", VLM, MAX_LEN // 4,
              MAX_LEN // 4 - 1),
             ("tp_seq whisper self slice", WHISPER, MAX_LEN // 4,
              (TP_PROMPT + 4) % (MAX_LEN // 4)),
             ("tp_seq whisper cross slice", WHISPER, TP_PROMPT // 4,
              TP_PROMPT // 4 - 1)]
    shapes = []
    for label, geo, s, p in timed:
        nh, nkv, d = geo["nh"], geo["nkv"], geo["d"]
        q = cs.randn(b, 1, nh, d, dtype=bf)
        k, v = (cs.randn(b, s, nkv, d, dtype=bf) for _ in range(2))
        pos = torch.full((b,), p, dtype=torch.int32, device=dev)
        lse = torch.empty((b, nh), dtype=f32, device=dev)
        lib, work, shape = decode_yardstick((q, k, v, pos), b, dev, nh, nkv,
                                            d, False,
                                            note=f"local pos {p} every row")
        # beside the bf16 output: the fp32 output's extra 2 bytes an
        # element and the lse
        work = (work[0] + b * nh * d * 2 + b * nh * 4, work[1])
        t = time_shape(name, run, (q, k, v, pos), lib, work,
                       f"{label}: {shape} + lse", kw=dict(lse=lse),
                       plain=plain)
        t["without_lse_ms"], t["without_lse_device_ms"] = time_both(
            lambda: run(q, k, v, pos))
        log(f"[kernels] {name} {label}: with lse {t['ms']:.4f} ms (device "
            f"{t['device_ms']:.4f}), without {t['without_lse_ms']:.4f} ms "
            f"(device {t['without_lse_device_ms']:.4f})")
        shapes.append(t)
    main = shapes[0]
    row.update(ms=main["ms"], device_ms=main["device_ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=main["library_ms"],
               library_device_ms=main["library_device_ms"],
               shape=main["shape"], timed_shapes=shapes[1:],
               without_lse_ms=main["without_lse_ms"],
               without_lse_device_ms=main["without_lse_device_ms"])
    return row


def kernel_lse_merge(cs, dev, rehearsal, run) -> float:
    """A (8, 2080, 2, 128) cache (rehearsal: (8, 64, 2, 16)) cut into 4
    sequence slices: the kernel with ``lse`` on each slice at the local
    positions, the partials merged by ``attention.merge_partials``,
    against the kernel on the whole cache; fp32 within 2e-5, bf16 within
    2e-2 (of max |out|: the merged output is rounded once, the whole
    call's partials are cut elsewhere). Positions: in the first slice,
    on each slice boundary and past the end, ragged."""
    b, s, nh, nkv, d = (8, 64, 12, 2, 16) if rehearsal else \
        (8, MAX_LEN, 12, 2, 128)
    w = s // 4
    pos = torch.tensor([3, w - 1, w, 2 * w + 7, 3 * w - 1, s - 1, s + 5,
                        s // 2], dtype=torch.int32, device=dev)
    worst = 0.0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for win in (None, w // 2 + 3):
            q = cs.randn(b, 1, nh, d, dtype=dtype)
            k, v = (cs.randn(b, s, nkv, d, dtype=dtype) for _ in range(2))
            whole = run(q, k, v, pos, window=win).float()
            parts, lses = [], []
            for r in range(4):
                lse = torch.empty((b, nh), dtype=torch.float32, device=dev)
                o, lse = run(q, k[:, r * w:(r + 1) * w].contiguous(),
                             v[:, r * w:(r + 1) * w].contiguous(),
                             pos - r * w, window=win, lse=lse)
                parts.append(o)
                lses.append(lse)
            merged = attn.merge_partials(torch.stack(parts),
                                         torch.stack(lses)).to(dtype)
            err = (merged.float() - whole).abs().max().item()
            rel = err / max(whole.abs().max().item(), 1e-30)
            ok = rel <= tol
            log(f"[kernels] decode_attention_lse merge of 4 slices of "
                f"({b},{w},{nkv},{d}) {str(dtype)[6:]}"
                f"{f' SWA={win}' if win else ''} against the kernel on the "
                f"whole cache: max_abs_err={err:.3e} rel={rel:.3e} (limit "
                f"{tol:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("chip_smoke: the merged slices disagree "
                                 "with the whole-cache decode")
            worst = max(worst, err)
    return worst


def decode_yardstick(args, b, dev, nh, nkv, d, paged, window=None,
                     note: str = "ragged pos, one dead row") -> tuple:
    """SDPA on the gathered K/V with the positions' (and window's) mask,
    the bytes and operations of the call, and its shape label."""
    q, pos = args[0], args[-1]
    k, v = dense_kv(args[1:-1], b)
    s = k.shape[1]
    t, p = torch.arange(s, device=dev)[None, :], pos.long()[:, None]
    vis = t <= p
    if window:
        vis &= t > p - window
    sq, sk, sv, sm = _sdpa_inputs(q, k, v, vis[:, None, None, :])
    tbl = args[3].cpu().numpy() if paged else None
    work = decode_work(pos.cpu().numpy(), s, nh, nkv, d, window, 2, tbl, BS)
    kv_shape = (f"pool=({args[1].shape[0]},{BS},{nkv},{d}) tbl=({b},"
                f"{tbl.shape[1]})" if paged else f"cache=({b},{s},{nkv},{d})")
    win = f" SWA={window}" if window else ""
    return (lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm),
            work, f"q=({b},1,{nh},{d}) {kv_shape}{win} {note} bf16")


def ring_slots(pos: int, s_alloc: int, dev) -> torch.Tensor:
    """``slot_pos`` of a ring of ``s_alloc`` slots after the token at
    ``pos`` was written: slot j holds the latest position p <= pos with p %
    s_alloc == j, or -1 (empty) where there is none."""
    j = torch.arange(s_alloc, device=dev)
    last = pos - (pos - j) % s_alloc
    return torch.where(j <= pos, last, -1).to(torch.int32)


def kernel_ring(cs, dev, rehearsal) -> list:
    """The ring (sliding-window) cache's decode route
    (``ops.decode_attention_ring``: the contiguous decode kernel at
    ``min(pos, S_alloc - 1)`` with no window) against its plain version,
    the reference's ``slot_pos`` mask, at danube's heads on a ring of 4096
    slots: not yet full, exactly full, wrapped (by a prompt past the
    window and by decode), bf16 and fp32. Timed at the ring generation's
    wrapped shape."""
    name = "decode_attention"

    def route(q, k, v, pos, slot_pos):     # the route ignores slot_pos
        return ops.decode_attention_ring(q, k, v, pos)
    run = in_fp32(route) if rehearsal else route
    plain = attn.decode_attention_ring
    nh, nkv, d = _geometry(DANUBE, rehearsal)
    ring = 32 if rehearsal else DANUBE_WINDOW
    b = 2
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for pos, what in ((ring // 3, "not full"), (ring - 1, "exactly full"),
                          (ring + ring // 2, "wrapped"),
                          (3 * ring + 7, "wrapped twice")):
            k = cs.randn(b, ring, nkv, d, dtype=dtype)
            v = cs.randn(b, ring, nkv, d, dtype=dtype)
            q = cs.randn(b, 1, nh, d, dtype=dtype)
            args = (q, k, v, torch.full((b,), pos, dtype=torch.int32,
                                        device=dev),
                    ring_slots(pos, ring, dev))
            cases.append((f"ring d{d} S_alloc={ring} pos={pos} {what} "
                          f"{str(dtype)[6:]}", dtype, args, {}))
    compare(name, run, plain, iter(cases))
    if rehearsal:
        return []
    q, k, v, pos, _ = cases[2][2]       # bf16, wrapped
    lib, work, _ = decode_yardstick((q, k, v, torch.clamp(pos, max=ring - 1)),
                                    b, dev, nh, nkv, d, False)
    return [time_shape(name, run, cases[2][2], lib, work,
                       f"ring q=({b},1,{nh},{d}) cache=({b},{ring},{nkv},{d}) "
                       f"pos={int(pos[0])} (pos_eff {ring - 1}) bf16",
                       plain=plain)]


def fp8_cache(cs, shape, fp8) -> torch.Tensor:
    """A K or V cache cast by ``astype`` from values of scale 2 with 2% of
    them at +-448 (float8_e4m3fn's largest) and 2% in the two formats'
    subnormal ranges (below 2^-6 and 2^-14)."""
    x = cs.randn(*shape, dtype=torch.float32) * 2
    flat = x.view(-1)
    idx = torch.randperm(flat.numel(), generator=cs.gen,
                         device=cs.dev)[: flat.numel() // 25]
    half = idx.numel() // 2
    u = torch.rand(idx.numel(), generator=cs.gen, device=cs.dev)
    flat[idx[:half]] = torch.where(u[:half] < 0.5, -448.0, 448.0)
    tiny = torch.where(u[half:] < 0.5, 2.0 ** -7, 2.0 ** -15)
    flat[idx[half:]] = (2 * torch.rand(idx.numel() - half, generator=cs.gen,
                                       device=cs.dev) - 1) * tiny
    return astype(x, fp8)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def kernel_decode_fp8(cs, dev, rehearsal) -> list:
    """Kernel 4 on fp8 caches (the reference's ``kv_cache_dtype``), each
    case in float8_e4m3fn and float8_e5m2, the cache with subnormals and
    +-448: rows 4 (Phi-3.5-MoE's 32/8 heads, ragged positions, a dead
    row), 4a (zamba2's 32/32 of 80), 4c (a ``pp`` step's microbatch at one
    position), 4d (danube's d-120 ring route, through
    ``ops.decode_attention_ring``) and small fp32-q ragged and SWA cases.
    Each is held to its plain version evaluated in fp32 (the phase's
    tolerance on the output over max |V|: the cache spans +-448), and bit
    for bit to the same kernel on the cache upcast to q's dtype (the same
    body and splits). Rows 4, 4a, 4c and 4d are timed; their bound counts
    1 byte a K/V element; the library yardstick is SDPA on the upcast
    cache, the upcast included. Then ``astype`` on the card over all
    65,536 bf16 values must give the CPU's bytes."""
    name = "decode_attention"
    plain = da.decode_attention_plain
    ring_route = (lambda q, k, v, pos, window=None:  # noqa: E731
                  ops.decode_attention_ring(q, k, v, pos))
    kern = in_fp32(plain) if rehearsal else da.decode_attention
    bf, f32 = torch.bfloat16, torch.float32
    S = 64 if rehearsal else MAX_LEN
    pp_pos = PP_PROMPT + 16      # half-way through 32 steps
    ring = 32 if rehearsal else DANUBE_WINDOW
    ring_pos = ring + ring // 2
    # (label, q dtype, geometry, rows, keys, window, positions, timed)
    specs = [
        ("row 4 GQA 32/8 ragged + dead row", bf, PHI, 8, S, None, True, True),
        ("row 4a MHA 32/32 d80 ragged + dead row", bf, ZAMBA, 8, S, None,
         True, True),
        ("row 4c pp mb=2 GQA 64/8 one pos", bf, QWEN, 2, S, None,
         [min(pp_pos, S - 1)] * 2, True),
        (f"row 4d ring route d120 S_alloc={ring} pos={ring_pos}", bf,
         DANUBE, 2, ring, None, [ring_pos] * 2, True),
        ("GQA 4/2 d16 S=37 ragged fp32", f32, dict(nh=4, nkv=2, d=16), 3,
         37, None, True, False),
        ("MHA d32 SWA=8 fp32", f32, dict(nh=4, nkv=4, d=32), 3, 40, 8, True,
         False),
        ("g=4 d120 SWA=40 fp32", f32, dict(nh=32, nkv=8, d=120), 3, 300, 40,
         True, False),
        ("g=4 d128 SWA=300 bf16", bf, dict(nh=32, nkv=8, d=128), 4, 1000,
         300, True, False)]
    out = []
    for fp8 in FP8_DTYPES.values():
        fmt = str(fp8)[6:]
        for label, dtype, geo, b, s, win, vec, timed in specs:
            nh, nkv, d = _geometry(geo, rehearsal)
            ring_case = label.startswith("row 4d")
            run = ((in_fp32(ring_route) if rehearsal else ring_route)
                   if ring_case else kern)
            q = cs.randn(b, 1, nh, d, dtype=dtype)
            k, v = (fp8_cache(cs, (b, s, nkv, d), fp8) for _ in range(2))
            if isinstance(vec, list):
                pos = torch.tensor(vec, dtype=torch.int32, device=dev)
            else:
                pos = cs.randint(0, s, (b,))
                pos[-1] = s                 # a dead row past its row's end
            kw = {} if ring_case else dict(window=win)
            ref_fn = plain
            if ring_case:               # the reference's slot_pos mask
                def ref_fn(q, k, v, pos, slots=ring_slots(ring_pos, ring,
                                                          dev)):
                    return attn.decode_attention_ring(q, k, v, pos, slots)
            got = run(q, k, v, pos, **kw)
            up = run(q, k.to(dtype), v.to(dtype), pos, **kw)
            same = torch.equal(_bits(got), _bits(up))
            ref = in_fp32(ref_fn)(q, k, v, pos, **kw).float()
            vmax = max(v.float().abs().max().item(), 1.0)
            plain_err = (ref_fn(q, k, v, pos, **kw).float()
                         - ref).abs().max().item()
            err = check(name, got.float() / vmax, ref / vmax, dtype,
                        f"{fmt} {label} /max|V|", plain_err / vmax)
            log(f"[kernels] {name:24s} {fmt} {label}: == the kernel on the "
                f"cache upcast to {str(dtype)[6:]} bit for bit: {same}")
            if not same:
                raise SystemExit(f"chip_smoke: {name} on a {fmt} cache "
                                 f"differs from the upcast cache ({label})")
            if not timed or rehearsal:
                continue
            pos_eff = torch.clamp(pos, max=s - 1) if ring_case else pos
            tr = lambda x: x.transpose(1, 2).contiguous()  # noqa: E731
            g = nh // nkv
            k8, v8 = (tr(x.view(torch.uint8).repeat_interleave(g, dim=2))
                      .view(fp8) for x in (k, v))
            t = torch.arange(s, device=dev)[None, :]
            mask = (t <= pos_eff.long()[:, None])[:, None, None, :]
            sq = tr(q)

            def library(k8=k8, v8=v8, sq=sq, mask=mask, dtype=dtype):
                return F.scaled_dot_product_attention(
                    sq, k8.to(dtype), v8.to(dtype), attn_mask=mask)
            work = decode_work(pos_eff.cpu().numpy(), s, nh, nkv, d, win, 2,
                               kv_esz=1)
            row = time_shape(
                name, run, (q, k, v, pos), library, work,
                f"{fmt} {label}: q=({b},1,{nh},{d}) cache=({b},{s},{nkv},"
                f"{d}) {fmt} bf16 q", kw=kw, plain=ref_fn)
            row.update(max_abs_err=err, kv_dtype=fmt,
                       equal_to_upcast=same)
            out.append(row)
    # the cast helper on the card: every bf16 bit pattern
    x = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(bf)
    for fp8 in FP8_DTYPES.values():
        cpu = astype(x, fp8).view(torch.uint8)
        card = astype(x.to(dev), fp8).view(torch.uint8).cpu()
        same = torch.equal(card, cpu)
        log(f"[kernels] common.astype to {str(fp8)[6:]} over all 65,536 "
            f"bf16 values on {dev.type} == on the CPU, byte for byte: "
            f"{same}")
        if not same:
            raise SystemExit(f"chip_smoke: astype to {fp8} differs on the "
                             f"card")
    return out


# per-row bases of the prefix path's suffix dispatch: unaligned with the
# blocks and the query tiles, different in one call, one row at base 0
SUFFIX_BASES = (0, 17, 1000, 1023)


def kernel_chunk(cs, dev, rehearsal, paged: bool) -> dict:
    """Chunk attention of Qwen3-32B's 512-token chunk at base 1024 against
    4 rows of ``max_len`` 2080: paged (kernel 2, main path) or contiguous
    (kernel 5, the contig path's transient group cache). Paged also at the
    prefix path's suffix dispatch: per-row bases ``SUFFIX_BASES`` (timed),
    swept over bf16 / fp32, blocks of 16 / 24, g = 8 / 12 and head dims
    128 / 80, and once with the probe on ragged real columns."""
    name = "chunk_attention_paged" if paged else "chunk_attention"
    plain = getattr(ca, name + "_plain")
    run = in_fp32(plain) if rehearsal else getattr(ca, name)
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, d = _geometry(QWEN, rehearsal)
    B, S, C = (4, 64, 16) if rehearsal else (4, MAX_LEN, 512)
    base = 2 * C
    specs = [
        (bf, (nh, nkv, d, B, C, S, BS), base, None,
         "main GQA scalar base bf16"),
        (bf, (nh, nkv, d, B, C, S, BS), "rows", None,
         "main GQA per-row bases bf16"),
        (bf, (nh, nkv, d, B, 11 if rehearsal else 300, S, BS), "rows", 256,
         "ragged C, SWA=256, per-row bf16"),
        (bf, (4, 2, 16, 2, 13, 37, 8), 20, None, "GQA 4/2 d16 C=13 S=37 bf16"),
        (f32, (4, 2, 16, 2, 13, 37, 8), 20, None,
         "GQA 4/2 d16 C=13 S=37 fp32"),
        (f32, (4, 4, 32, 2, 16, 64, 8), "rows", 8,
         "MHA d32 SWA=8 per-row fp32"),
        (f32, (8, 2, 64, 2, 24, 100, 16), 40, None,
         "GQA 8/2 d64 S=100 fp32")]
    # the bf16 body's tiling edges: 128 / g query positions per CTA (C not
    # a multiple of it), key tiles of 128 that wrap the ring and end mid
    # tile, pool blocks of 24 tokens that straddle a tile, windows shorter
    # than a tile, a row at base 0 (no earlier key), every head dim
    specs += [
        (bf, (16, 2, 128, 2, c, 1100, BS), "rows0", None,
         f"g=8 C={c} base 0 + per-row bf16") for c in (13, 300, 511)] + [
        (bf, (16, 2, 64, 2, 200, 700, 24), "rows0", None,
         "g=8 d64 blocks of 24 straddle tiles bf16"),
        (bf, (16, 2, 128, 2, 300, 900, BS), "rows", 40,
         "g=8 SWA=40 < tile bf16"),
        (bf, (8, 2, 32, 2, 77, 400, BS), "rows0", None, "g=4 d32 bf16"),
        (bf, (4, 4, 80, 2, 150, 500, BS), "rows0", None, "g=1 d80 bf16"),
        (bf, (4, 1, 16, 2, 45, 300, 8), "rows0", 20, "g=4 d16 SWA=20 bf16")]
    specs += [
        (bf, (g * kv, kv, dd, 2, 77, 500, (16, 24)[i % 2]), "rows0", win,
         f"g={g} d{dd} C=77{' SWA=50' if win else ''} bf16")
        for i, (g, kv, dd, win) in enumerate(V1_CASES)]

    # head dim 120 (h2o-danube-3-4b): the path's 512-token chunk at bases
    # on both sides of the 4096 window (a row whose chunk crosses it),
    # g = 1 and 4, bf16 and fp32, short windows, blocks of 24; whisper's
    # decoder chunk (contig: the transient group cache of its chunked
    # prefill)
    d120 = "danube d120 C=512 SWA=4096 bases across the window bf16"
    whisper = "whisper MHA 6/6 d64 C=512 base 1024 bf16"
    if not rehearsal:
        specs += [
            (bf, (*_geometry(DANUBE, rehearsal), 4, C, DANUBE_LEN, BS),
             (3584, 4096, 4608, 5600), DANUBE_WINDOW, d120),
            (bf, (32, 8, 120, 2, 300, 1100, BS), "rows0", None,
             "g=4 d120 C=300 bf16"),
            (bf, (8, 8, 120, 2, 150, 500, 24), "rows0", 50,
             "g=1 d120 SWA=50 blocks of 24 bf16"),
            (f32, (32, 8, 120, 2, 100, 600, BS), "rows", 40,
             "g=4 d120 SWA=40 per-row fp32"),
            (f32, (8, 8, 120, 2, 77, 500, 24), "rows0", None,
             "g=1 d120 blocks of 24 fp32"),
            (bf, (*_geometry(WHISPER, rehearsal), B, C, S, BS), (base,) * B,
             None, whisper)]
    suffix = "suffix GQA unaligned per-row bases bf16"
    if paged:
        sb = (0, 5, 30, 33) if rehearsal else SUFFIX_BASES
        specs += [(bf, (nh, nkv, d, B, C, S, BS), sb, None, suffix)] + [
            (dt, (g * 2, 2, dd, 4, 100, 1200, bs), SUFFIX_BASES, None,
             f"suffix bases g={g} d{dd} blocks of {bs} {str(dt)[6:]}")
            for dt in (bf, f32) for bs in (16, 24) for g in (8, 12)
            for dd in (128, 80)]

    def cases():
        for dtype, (h, kv, dd, b, c, s, bs), bases, win, label in specs:
            kvs, s = kv_inputs(cs, paged, b, s, kv, dd, bs, dtype)
            q = cs.randn(b, c, h, dd, dtype=dtype)
            if bases in ("rows", "rows0"):
                zero = bases == "rows0"
                bases = cs.randint(0, s - c + 1, (b,))
                if zero:
                    bases[0] = 0
            elif isinstance(bases, tuple):
                bases = torch.tensor(bases, dtype=torch.int32, device=dev)
            yield label, dtype, (q, *kvs, bases), dict(window=win)
    args, err, kept = compare(name, run, plain, cases(),
                              keep=(suffix, d120) if paged else (whisper,))
    # timed with the scalar base as a (B,) device tensor: the wrapper would
    # copy a Python int to the card on every call, a copy that waits for
    # the stream and would put the host's time into the kernel's
    args = (*args[:-1], torch.full((B,), base, dtype=torch.int32,
                                   device=dev))
    q = args[0]
    k, v = dense_kv(args[1:-1], B)
    s = k.shape[1]
    qpos = base + torch.arange(C, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] <= qpos[:, None])[None, None]
    sq, sk, sv, sm = _sdpa_inputs(q, k, v, mask)
    tbl = args[3].cpu().numpy() if paged else None
    work = chunk_work(base, B, C, s, nh, nkv, d, None, 2, tbl, BS)
    kv_shape = (f"pool=({args[1].shape[0]},{BS},{nkv},{d})" if paged
                else f"cache=({B},{s},{nkv},{d})")
    row = measure(name, ca, run, plain, args, err,
                  lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                         attn_mask=sm),
                  work, f"q=({B},{C},{nh},{d}) base={base} {kv_shape} bf16",
                  plain_iters=3)
    if paged:
        chunk_probe_case(cs, dev, rehearsal)
    # timed beside the main shape: the prefix path's suffix dispatch and
    # the danube path's chunk across its window (paged), the whisper path's
    # decoder chunk (contig)
    timed = [] if rehearsal else (
        [(suffix, "suffix ", QWEN, None), (d120, "", DANUBE, DANUBE_WINDOW)]
        if paged else [(whisper, "", WHISPER, None)])
    row["timed_shapes"] = [
        chunk_timed(name, run, kept[label], dev, *_geometry(geo, rehearsal),
                    win, paged, tag, plain=plain)
        for label, tag, geo, win in timed]
    return row


def chunk_timed(name, run, args, dev, nh, nkv, d, window, paged,
                tag="", plain=None) -> dict:
    """Time one more chunk shape beside SDPA on the gathered K/V under
    the per-row bases' (and window's) mask, and its plain version."""
    b, c = args[0].shape[:2]
    bases = args[-1]
    k, v = dense_kv(args[1:-1], b)
    qpos = bases[:, None].long() + torch.arange(c, device=dev)[None]
    t = torch.arange(k.shape[1], device=dev)[None, None, :]
    vis = t <= qpos[:, :, None]
    if window:
        vis &= t > qpos[:, :, None] - window
    sq, sk, sv, sm = _sdpa_inputs(args[0], k, v, vis[:, None])
    tbl = args[3].cpu().numpy() if paged else None
    kv_shape = (f"pool=({args[1].shape[0]},{BS},{nkv},{d})" if paged
                else f"cache=({b},{k.shape[1]},{nkv},{d})")
    win = f" SWA={window}" if window else ""
    return time_shape(
        name, run, args,
        lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=sm),
        chunk_work(bases.cpu().numpy(), b, c, k.shape[1], nh, nkv, d,
                   window, 2, tbl, BS),
        f"{tag}q=({b},{c},{nh},{d}) bases={tuple(bases.tolist())} "
        f"{kv_shape}{win} bf16", kw=dict(window=window), plain=plain)


def chunk_probe_case(cs, dev, rehearsal) -> None:
    """The suffix dispatch with the sanitizer armed: unaligned per-row
    bases, ``probe=True`` and ragged real columns (``probe_cols``), poison
    planted past one row's real columns but inside its chunk (read only by
    pad columns, which the probe skips). The output is held to the plain
    version at the bf16 tolerance, the probe exactly, and it must not
    fire."""
    nh, nkv, d = _geometry(QWEN, rehearsal)
    b, c, s = (4, 16, 64) if rehearsal else (4, 512, MAX_LEN)
    bases = torch.tensor((0, 5, 30, 33) if rehearsal else SUFFIX_BASES,
                         dtype=torch.int32, device=dev)
    cols = torch.tensor([c, c // 3, 1, c - 7], dtype=torch.int32, device=dev)
    (pk, pv, tbl), s = kv_inputs(cs, True, b, s, nkv, d, BS,
                                 torch.bfloat16)
    stored = torch.tensor(KV_POISON, dtype=torch.bfloat16).item()
    t = int(bases[1]) + c - 1                 # row 1's last pad column
    pk[tbl[1, t // BS].long(), t % BS] = stored
    q = cs.randn(b, c, nh, d, dtype=torch.bfloat16)
    args, kw = (q, pk, pv, tbl, bases), dict(probe=True, probe_cols=cols)
    plain = ca.chunk_attention_paged_plain
    run = in_fp32(plain) if rehearsal else ca.chunk_attention_paged
    out, pmax = run(*args, **kw)
    ref = in_fp32(plain)(*args)
    # row 1's pad columns read the planted poison: hold the real columns
    real = (torch.arange(c, device=dev)[None, :]
            < cols[:, None].long())[..., None, None]
    plain_err = (torch.where(real, plain(*args).float() - ref, 0)
                 ).abs().max().item()
    check("chunk_attention_paged", torch.where(real, out, 0),
          torch.where(real, ref, 0), torch.bfloat16,
          "suffix probe=True ragged probe_cols bf16", plain_err)
    exact = torch.equal(pmax, kvp.kv_probe_plain(pk, pv, tbl, bases, c, nh,
                                                 cols=cols))
    fired = pmax.max().item() >= stored
    log(f"[kernels] {'kv_probe':24s} suffix probe_cols exact={exact} "
        f"max={pmax.max().item():.9g} fired={fired} (poison past row 1's "
        f"real columns) {'ok' if exact and not fired else 'FAIL'}")
    if not exact or fired:
        raise SystemExit("chip_smoke: the suffix dispatch's probe disagrees "
                         "with its plain version or read a pad column")


def kernel_flash(cs, dev, rehearsal) -> dict:
    """Causal prefill attention: the dense paths' 4-prompt group at the
    512-token bucket (Qwen3-32B heads, timed), the MoE path's batch-1
    exact-length prompts at Phi-3.5-MoE's 32/8 heads (2048 and 1281
    tokens, the workload's longest two), the hybrid path's exact-length
    groups of 4 rows at zamba2's 32/32 heads of dim 80 (2048 tokens), and
    the legacy path's batch-1 exact-length prompt at Qwen3-32B's heads
    (2048 tokens)."""
    plain = fa.flash_attention_plain
    run = in_fp32(plain) if rehearsal else fa.flash_attention
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, d = _geometry(QWEN, rehearsal)
    B, S = (4, 32) if rehearsal else (4, 512)
    n1, n2, n3 = (40, 23, 19) if rehearsal else (2048, 1281, 300)
    specs = [
        (bf, (nh, nkv, d, B, S), True, None, "main GQA causal bf16"),
        (bf, (*_geometry(PHI, rehearsal), 1, n1), True, None,
         f"MoE prompt 32/8 S={n1} bf16"),
        (bf, (*_geometry(PHI, rehearsal), 1, n2), True, None,
         f"MoE prompt 32/8 S={n2} bf16"),
        (bf, (*_geometry(ZAMBA, rehearsal), GROUP, n1), True, None,
         f"zamba2 group 32/32 d80 S={n1} bf16"),
        (bf, (4, 4, 80, 2, 77), True, None, "MHA d80 S=77 bf16"),
        (f32, (4, 4, 80, 2, 77), True, None, "MHA d80 S=77 fp32"),
        (bf, (nh, nkv, d, 2, n3), True, 128, "ragged S, SWA=128 bf16"),
        (bf, (4, 2, 16, 2, 37), True, None, "GQA 4/2 d16 S=37 bf16"),
        (f32, (4, 2, 16, 2, 37), True, None, "GQA 4/2 d16 S=37 fp32"),
        (f32, (4, 4, 32, 2, 40), True, 8, "MHA d32 SWA=8 fp32"),
        (f32, (8, 2, 64, 1, 70), False, None, "GQA 8/2 d64 non-causal fp32"),
        (bf, (nh, nkv, d, 1, n1), True, None,
         f"legacy prompt 64/8 S={n1} bf16")]
    # the bf16 body's tiling edges: 128 / g query positions per CTA (S not
    # a multiple of it), windows shorter than a key tile, every head dim
    specs += [
        (bf, (16, 2, 128, 2, n), True, None, f"g=8 S={n} bf16")
        for n in (13, 300, 511)] + [
        (bf, (16, 2, 64, 1, 700), True, 16, "g=8 d64 SWA=16 bf16"),
        (bf, (8, 8, 64, 2, 400), True, 100, "g=1 d64 SWA=100 bf16"),
        (bf, (8, 2, 32, 2, 333), True, None, "g=4 d32 bf16"),
        (bf, (8, 2, 64, 1, 170), False, 64,
         "g=4 d64 non-causal SWA=64 bf16"),
        (bf, (4, 4, 16, 2, 200), False, None, "g=1 d16 non-causal bf16")]
    specs += [(bf, (g * kv, kv, dd, 2, 300), True, win,
               f"g={g} d{dd} S=300{' SWA=50' if win else ''} bf16")
              for g, kv, dd, win in V1_CASES]
    # head dim 120 (h2o-danube-3-4b): g = 1 and 4, bf16 and fp32, windows
    # shorter than a tile and of 4096 with queries on both sides of it (the
    # ring generation's prompt); command-r-plus's 96/8 heads (g = 12) at
    # the 512 bucket; whisper-tiny's encoder (8 frames, non-causal) and
    # cross attention (S_dec queries against the 8 encoder keys: Sq != Sk)
    dn = _geometry(DANUBE, rehearsal)
    n4 = 23 if rehearsal else 4600
    ring = f"danube ring prompt d120 S={n4} SWA=4096 bf16"
    cmdr = "cmdr group 96/8 S=512 bf16"
    enc = "whisper encoder 6/6 d64 S=8 non-causal bf16"
    cross = f"whisper cross Sq={S} Sk=8 non-causal bf16"
    ks = ENC_FRAMES
    specs += [
        (bf, (*dn, 1, n4), True, DANUBE_WINDOW, ring),
        (bf, (32, 8, 120, 2, 300), True, None, "g=4 d120 S=300 bf16"),
        (bf, (8, 8, 120, 2, 333), True, 50, "g=1 d120 SWA=50 bf16"),
        (f32, (32, 8, 120, 2, 77), True, 40, "g=4 d120 SWA=40 fp32"),
        (f32, (8, 8, 120, 2, 77), True, None, "g=1 d120 fp32"),
        (bf, (*_geometry(CMDR, rehearsal), B, S), True, None, cmdr),
        (bf, (*_geometry(WHISPER, rehearsal), B, ks), False, None, enc),
        (bf, (*_geometry(WHISPER, rehearsal), B, S, ks), False, None, cross),
        (bf, (6, 6, 64, 8, 1, ks), False, None,
         "whisper cross decode Sq=1 Sk=8 bf16"),
        (f32, (6, 6, 64, 3, 37, ks), False, None,
         "whisper cross Sq=37 Sk=8 fp32"),
        (bf, (8, 2, 120, 2, 77, 8), False, None,
         "g=4 d120 non-causal Sq=77 Sk=8 bf16")]

    def cases():
        for dtype, (h, kv, dd, b, s, *sk), causal, win, label in specs:
            sk = sk[0] if sk else s
            q = cs.randn(b, s, h, dd, dtype=dtype)
            k = cs.randn(b, sk, kv, dd, dtype=dtype)
            v = cs.randn(b, sk, kv, dd, dtype=dtype)
            yield label, dtype, (q, k, v), dict(causal=causal, window=win)
    # the tp path's prefill on one rank of a model axis of 4 (16/2 heads
    # of 128, 1024 tokens): 4 rows, and the 8 of the (1, 4) mesh
    tp = {b: f"tp model 4 shard 16/2 S=1024 {b} rows bf16" for b in (4, 8)}
    # the tp_families path's zamba2 shared-block prompt on a rank of model
    # 4 (row 3k: 8 of 32 heads of 80, 8 rows of 1024 tokens)
    tpf = "tp_families zamba2 model 4 shard 8/8 d80 S=1024 8 rows bf16"
    if not rehearsal:
        specs += [(bf, (16, 2, 128, b, 1024), True, None, tp[b])
                  for b in (4, 8)]
        specs.append((bf, (8, 8, 80, 8, TP_PROMPT), True, None, tpf))
    moe, zamba, legacy = specs[1][4], specs[3][4], specs[11][4]
    args, err, kept = compare("flash_attention", run, plain, cases(),
                              keep=(moe, zamba, legacy, cmdr, enc, cross)
                              + (() if rehearsal else tuple(tp.values())
                                 + (tpf,)))
    row = measure("flash_attention", fa, run, plain, args, err,
                  *flash_yardstick(args))
    # the MoE path's batch-1 prompt, the hybrid path's d=80 group, the
    # legacy path's batch-1 prompt, the cmdr path's 512 group, the whisper
    # path's encoder and cross attention, and the danube ring generation's
    # 6000-token prompt (timed only: its fp32 plain version would need
    # tens of GB)
    row["timed_shapes"] = [time_shape("flash_attention", run, kept[k],
                                      *flash_yardstick(kept[k], causal=c),
                                      kw=dict(causal=c), plain=plain)
                           for k, c in ((moe, True), (zamba, True),
                                        (legacy, True), (cmdr, True),
                                        (enc, False), (cross, False))
                           + (() if rehearsal else tuple(
                               (t, True) for t in tp.values()))]
    if not rehearsal:
        row["timed_shapes"].append(time_shape(
            "flash_attention", run, kept[tpf], *flash_yardstick(kept[tpf]),
            kw=dict(causal=True), plain=plain))
        row["timed_shapes"][-1]["shape"] = \
            "row 3k: " + row["timed_shapes"][-1]["shape"]
        big = tuple(cs.randn(2, 6000, h, 120, dtype=bf) for h in (32, 8, 8))
        row["timed_shapes"].append(time_shape(
            "flash_attention", run, big,
            *flash_yardstick(big, window=DANUBE_WINDOW),
            kw=dict(window=DANUBE_WINDOW)))
    if not rehearsal:
        row["host_us"] = launch_host_us(cs)
    return row


def launch_host_us(cs, n: int = 500) -> dict:
    """Host microseconds per call of the flash entry point at a tiny
    shape: bf16 (two tensor-map encodes, then the launch) against fp32
    (the launch alone), straight through ctypes."""
    lib = _build.load()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = cs.randn(1, 16, 8, 128, dtype=dtype)
        k = cs.randn(1, 16, 8, 128, dtype=dtype)
        o = torch.empty_like(q)
        stream = _build.stream_ptr(q.device)
        args = (q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(),
                None, 1, 16, 16, 8, 8, 128, 1, 0, 0.088,
                int(dtype == torch.bfloat16), stream)
        lib.rt_flash_attention(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            lib.rt_flash_attention(*args)
        out[str(dtype)[6:]] = (time.perf_counter() - t0) * 1e6 / n
        torch.cuda.synchronize()
    log(f"[kernels] flash_attention host us per call (ctypes, tiny shape): "
        f"bf16 {out['bfloat16']:.2f} (two tensor-map encodes + launch), "
        f"fp32 {out['float32']:.2f} (launch)")
    return out


def flash_yardstick(args, causal: bool = True, window=None) -> tuple:
    """SDPA on head-repeated K/V (causal, or under the window's mask), the
    bytes and operations of the call, and its shape label."""
    q, k = args[0], args[1]
    (b, s, nh, d), (sk, nkv) = q.shape, k.shape[1:3]
    sq, skk, sv, _ = _sdpa_inputs(*args, None)
    if window:
        t = torch.arange(s, device=q.device)
        sm = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            sq, skk, sv, attn_mask=sm)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            sq, skk, sv, is_causal=causal)
    kind = ("causal" if causal else "non-causal") + (
        f" SWA={window}" if window else "")
    return (lib, flash_work(b, s, nh, nkv, d, window, 2, causal, sk),
            f"q=({b},{s},{nh},{d}) k/v=({b},{sk},{nkv},{d}) {kind} bf16")


def kernel_probe(cs, dev, rehearsal) -> dict:
    """The KV sanitizer's probe (kernel 7) against its plain version,
    exactly (a maximum of absolute values does not round): decode (one
    column at ``pos``) and chunk (512 columns at base 1024; per-row
    columns, as the engine gives them), paged and contiguous, bf16 and
    fp32, SWA, a dead row on the trash table, poison (as the dtype stores
    it) planted in a block one row reads, and beyond every row's horizon.
    Timed at the sanitize path's paged decode shape (that of kernel 1)."""
    name = "kv_probe"
    plain = kvp.kv_probe_plain
    run = plain if rehearsal else kvp.kv_probe
    bf, f32 = torch.bfloat16, torch.float32
    nh, nkv, d = _geometry(QWEN, rehearsal)
    B, S, C = (4, 64, 16) if rehearsal else (8, MAX_LEN, 512)
    # (dtype, paged, (nh, nkv, d, b, s, bs), columns, window, poison, label)
    specs = [
        (bf, True, (nh, nkv, d, B, S, BS), 1, None, None,
         "main: decode paged, ragged pos, dead row bf16"),
        (bf, True, (nh, nkv, d, 4, S, BS), C, None, None,
         "chunk paged C=512 per-row bases bf16"),
        (bf, True, (nh, nkv, d, 4, S, BS), C, None, "cols",
         "chunk paged per-row columns bf16"),
        (bf, False, (nh, nkv, d, B, S, BS), 1, None, None,
         "decode contig bf16"),
        (bf, False, (nh, nkv, d, 4, S, BS), C, 256, None,
         "chunk contig SWA=256 bf16"),
        (bf, True, (nh, nkv, d, B, S, BS), 1, 100, "hot",
         "decode paged SWA=100 poison read bf16"),
        (bf, True, (nh, nkv, d, B, S, BS), 1, None, "cold",
         "decode paged poison unread bf16"),
        (bf, True, (nh, nkv, d, 4, S, 24), C, None, "hot",
         "chunk paged blocks of 24 poison read bf16"),
        (bf, False, (nh, nkv, d, 4, S, BS), C, None, "cold",
         "chunk contig poison unread bf16"),
        (f32, True, (8, 2, 64, 3, 300, 16), 1, None, "hot",
         "decode paged poison read fp32"),
        (f32, True, (8, 2, 64, 3, 300, 8), 24, 40, "cold",
         "chunk paged SWA=40 poison unread fp32"),
        (f32, False, (4, 4, 80, 3, 300, 16), 13, None, "hot",
         "chunk contig d80 poison read fp32")]
    if not rehearsal:
        # head dim 120 (h2o-danube-3-4b): 240-byte bf16 and 480-byte fp32
        # head rows, its window of 4096 over positions on both sides of it
        specs += [
            (bf, True, (32, 8, 120, B, DANUBE_LEN, BS), 1, DANUBE_WINDOW,
             None, "decode paged d120 SWA=4096 bf16"),
            (bf, True, (32, 8, 120, 4, DANUBE_LEN, 24), C, DANUBE_WINDOW,
             "hot", "chunk paged d120 SWA=4096 poison read bf16"),
            (bf, False, (32, 8, 120, 4, 900, BS), C, 100, "cold",
             "chunk contig d120 SWA=100 poison unread bf16"),
            (f32, True, (8, 8, 120, 3, 300, 16), 1, None, "hot",
             "decode paged d120 poison read fp32"),
            (f32, False, (8, 8, 120, 3, 300, 16), 13, 40, "cold",
             "chunk contig d120 SWA=40 poison unread fp32")]
    main = None
    for dtype, paged, (h, kv, dd, b, s, bs), c, win, poison, label in specs:
        kvs, s = kv_inputs(cs, paged, b, s, kv, dd, bs, dtype)
        pk, pv = kvs[0], kvs[1]
        tbl = kvs[2] if paged else None
        # "cold": no row reaches its last block (or last bs positions)
        reach = s - c - bs if poison == "cold" else s - c
        bases = cs.randint(0, reach + 1, (b,))
        if paged:
            tbl[-1] = 0                     # a dead row: trash table
        if c == 1:
            bases[-1] = s                   # frozen one past its last key
        cols = cs.randint(0, c + 1, (b,)) if poison == "cols" else None
        stored = torch.tensor(KV_POISON, dtype=dtype).item()
        if poison == "hot":                 # the position row 0 reads last
            t = bases[0].item() + c - 1
            if paged:
                pv[tbl[0, t // bs].long()] = stored
            else:
                pk[0, t] = -stored
        elif poison == "cold":              # every live row's last block
            if paged:
                pv[tbl[:-1, -1].long()] = stored
            else:
                pk[:b - 1 if c == 1 else b, s - 1] = -stored
        args = (pk, pv, tbl, bases, c, h)
        kw = dict(window=win, cols=cols)
        ref = plain(*args, **kw)
        out = run(*args, **kw)
        exact = out.shape == ref.shape and torch.equal(out, ref)
        top = out.max().item()
        fired = top >= stored
        ok = exact and fired == (poison == "hot")
        log(f"[kernels] {name:24s} {label:44s} exact={exact} max={top:.9g} "
            f"poison as stored={stored:.9g} fired={fired} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                             f"version or the poison check ({label})")
        main = main or (args, kw)
    args, kw = main
    pk, tbl, pos = args[0], args[2], args[3]
    work = probe_work(pos.cpu().numpy(), 1, pk.shape[1] * tbl.shape[1], nh,
                      nkv, d, None, 2, tbl.cpu().numpy(), BS)
    return measure(name, kvp, run, plain, args, 0.0, None, work,
                   f"pool=({pk.shape[0]},{BS},{nkv},{d}) tbl=({B},"
                   f"{tbl.shape[1]}) nh={nh} decode (c=1) ragged pos, one "
                   f"dead row bf16", kw=kw)


def probe_work(bases, c, s, nh, nkv, d, window, esz, tbl=None,
               bs=0) -> tuple:
    """Bytes and operations of one probe: the K/V bytes each row may read
    (each distinct block once, and the table entries), the bases and the
    (B, nh) fp32 output; two operations (|x|, max) per byte pair read."""
    bases = np.asarray(bases).astype(np.int64)
    lo = np.maximum(0, bases - window + 1) if window else np.zeros_like(
        bases)
    hi = np.minimum(bases + c - 1, s - 1)
    kv = _kv_bytes(lo, hi, nkv, d, esz, tbl, bs)
    b = len(bases)
    return kv + 4 * b + 4 * b * nh, 2.0 * kv / esz


def ssd_inputs(cs, b, s, nh, hd, n, dtype, init: bool) -> tuple:
    """SSD scan arguments as the model gives them: x, B and C strided views
    of one conv output, dt > 0 and a < 0 in fp32; an initial state when
    ``init``."""
    xbc = cs.randn(b, s, nh * hd + 2 * n, dtype=dtype) * 0.5
    x = xbc[..., :nh * hd].reshape(b, s, nh, hd)
    bm, cm = xbc[..., nh * hd:nh * hd + n], xbc[..., nh * hd + n:]
    dt = cs.randn(b, s, nh, dtype=torch.float32).abs() * 0.1 + 0.01
    a = -cs.randn(nh, dtype=torch.float32).abs() - 0.1
    h0 = (cs.randn(b, nh, hd, n, dtype=torch.float32) * 0.2 if init
          else None)
    return (x, dt, a, bm, cm), h0


def ssd_work(b, s, nh, hd, n, q, esz) -> tuple:
    """Bytes and operations of one SSD scan: x, y, B, C, dt, a and the final
    state moved once each; C B^T once per (row, chunk), shared by the heads
    as the kernel computes it (2 q^2 N), and per (row, head, chunk) the
    masked product, the carried state's contribution and the state update
    (2 q^2 hd + 4 q N hd), q the chunk's real length."""
    qs = [min(q, s - t) for t in range(0, s, q)]
    nbytes = (2 * b * s * nh * hd * esz + 2 * b * s * n * esz
              + 4 * (b * s * nh + nh + b * nh * hd * n))
    flops = sum(b * 2 * c * c * n + b * nh * (2 * c * c * hd + 4 * c * n * hd)
                for c in qs)
    return nbytes, float(flops)


def kernel_ssd(cs, dev, rehearsal) -> dict:
    """The Mamba2 SSD scan (kernel 6): y and the final state, at the shapes
    the ssm path (mamba2-1.3b: 64 heads of 64, N 128) and the hybrid path
    (zamba2-2.7b: 80 heads of 64, N 64) give it — exact-length groups of 4
    rows at the workload's longest prompt (2048, timed for mamba2) and a
    ragged one (1281), Q 128 — and one 2048-token row; and at small ragged
    shapes (S=37 and 100 with Q=64: one chunk and several, B > 1, an
    initial state) in bf16 and fp32."""
    name = "ssd_scan"
    plain = ssd.ssd_scan_plain
    run = in_fp32(plain) if rehearsal else ssd.ssd_scan
    bf, f32 = torch.bfloat16, torch.float32
    # (heads, head dim, state, chunk) of mamba2-1.3b and zamba2-2.7b
    m2 = (8, 16, 16, 16) if rehearsal else (64, 64, 128, 128)
    zb = (8, 16, 16, 16) if rehearsal else (80, 64, 64, 128)
    s1, s2 = (40, 23) if rehearsal else (2048, 1281)
    specs = [
        (bf, (GROUP, s1, *m2), False, f"main mamba2 group S={s1} bf16"),
        (bf, (1, s1, *m2), False, f"mamba2 one row S={s1} bf16"),
        (bf, (GROUP, s1, *zb), False, f"zamba2 group S={s1} bf16"),
        (bf, (GROUP, s2, *zb), False, f"zamba2 group ragged S={s2} bf16"),
        (bf, (2, 37, 4, 16, 16, 64), False, "S=37 Q=64 one chunk bf16"),
        (f32, (2, 37, 4, 16, 16, 64), False, "S=37 Q=64 one chunk fp32"),
        (bf, (3, 100, 4, 32, 32, 64), True, "S=100 Q=64 h0 bf16"),
        (f32, (3, 100, 4, 32, 32, 64), True, "S=100 Q=64 h0 fp32"),
        (f32, (2, 100, 8, 64, 128, 64), False, "N=128 S=100 Q=64 fp32")]
    # the tp_families path's prefill shards (rows 6b, 6c): mamba2 at model
    # 2 (32 of 64 heads: x a view in 2304 conv channels) and zamba2 at
    # model 4 (20 of 80 heads: 1408 channels), 8 rows of 1024 tokens
    tpf = {} if rehearsal else {
        "6b": (bf, (8, TP_PROMPT, 32, 64, 128, 128), False,
               "tp_families mamba2 model 2 shard S=1024 bf16"),
        "6c": (bf, (8, TP_PROMPT, 20, 64, 64, 128), False,
               "tp_families zamba2 model 4 shard S=1024 bf16"),
        # a rank of phase train_mesh's (2, 2) world (row 6m)
        "6m": (bf, (TM_ROWS // 2, TM_SEQ, 32, 64, 128, 128), False,
               "train_mesh mamba2 model 2 rank S=1024 bf16")}
    specs += list(tpf.values())
    if not rehearsal:
        # the bf16 tensor-core body's edges: S < Q, S not a multiple of Q,
        # Q 8 / 64 / 128, N 16 / 64 / 128 / 256 (one shared-memory buffer
        # at 256), head dims past one 64-wide slice and below it, an
        # initial state, one long row (64 chunks of carried state), and
        # N = 20 (not a multiple of 8: the FP32-pipe body)
        specs += [
            (bf, (2, 50, 4, 64, 64, 128), False, "S=50 < Q=128 bf16"),
            (bf, (2, 300, 4, 64, 128, 128), True, "S=300 N=128 h0 bf16"),
            (bf, (2, 200, 4, 64, 16, 64), False, "N=16 Q=64 bf16"),
            (bf, (1, 300, 2, 64, 256, 128), True, "N=256 h0 bf16"),
            (bf, (2, 150, 3, 80, 64, 64), True, "hd=80 (64 + 16) h0 bf16"),
            (bf, (2, 45, 4, 64, 64, 8), False, "Q=8 bf16"),
            (bf, (1, 8192, 8, 64, 128, 128), False, "long row S=8192 bf16"),
            (bf, (1, 40, 2, 16, 20, 16), False,
             "N=20 (FP32-pipe body) bf16")]
    main = kept = None
    shards = {}
    for dtype, (b, s, nh, hd, n, q), init, label in specs:
        args, h0 = ssd_inputs(cs, b, s, nh, hd, n, dtype, init)
        kw = dict(chunk=q, h0=h0)
        ref = [t.float() for t in in_fp32(plain)(*args, **kw)]
        plain_out = plain(*args, **kw)
        ssd.reset_bodies()
        outs = run(*args, **kw)
        if label in [t[3] for t in tpf.values()]:
            # the body the launch reported taking
            body = [k for k, v in ssd.body_counts.items() if v]
            shards[label] = (args, kw, (b, s, nh, hd, n, q), body)
        errs = []
        for out, r, p_out, part in zip(outs, ref, plain_out, ("y", "h")):
            p_err = (p_out.float() - r).abs().max().item()
            errs.append(check(name, out, r, dtype, f"{label} {part}", p_err))
        main = main or (args, kw, max(errs), (b, s, nh, hd, n, q))
        if label == specs[2][3]:        # the hybrid path's zamba2 group
            kept = (args, kw, (b, s, nh, hd, n, q))
    args, kw, err, (b, s, nh, hd, n, q) = main
    row = measure(name, ssd, run, plain, args, err, None,
                  ssd_work(b, s, nh, hd, n, q, 2), ssd_shape(b, s, nh, hd, n,
                                                             q),
                  plain_iters=3, kw=kw)
    args, kw, shp = kept
    row["timed_shapes"] = [time_shape(name, run, args, None,
                                      ssd_work(*shp, 2), ssd_shape(*shp),
                                      kw=kw, plain=plain)]
    for key, (_, _, _, label) in tpf.items():
        args, kw, shp, body = shards[label]
        log(f"[kernels] ssd_scan row {key} ({label}): the {body} body, as "
            f"the launch reported it (x row stride {args[0].stride(1)} "
            f"elements)")
        if body != ["tensor-core"]:
            raise SystemExit(f"chip_smoke: the SSD scan left its tensor-core "
                             f"body at the shard shape {label}")
        row["timed_shapes"].append(time_shape(
            name, run, args, None, ssd_work(*shp, 2),
            f"row {key}: {ssd_shape(*shp)}", kw=kw, plain=plain))
    return row


def ssd_shape(b, s, nh, hd, n, q) -> str:
    return (f"x=({b},{s},{nh},{hd}) b/c=({b},{s},{n}) Q={q} strided views "
            f"bf16")


# -- the SSD scan's backward (training) --------------------------------------------
# (label, dtype, (b, s, nh, hd, n, q), h0, dh_final): row 9 (mamba2-1.3b's
# train shape: one 2048-token row per microbatch, 64 heads of 64, N 128) and
# row 9a (zamba2-2.7b's: 80 heads of 64, N 64), as LM.loss gives them (no
# initial state, the final state's gradient None); then reduced edges: a
# ragged S, S < Q, Q 128 / 64 / 12 / 8, N 16 to 256, head dims 16 / 32 /
# 48, an initial state and a final-state gradient, bf16 and fp32
SSD_BWD_SPECS = [
    ("row 9 mamba2 train x=(1,2048,64,64) N=128 bf16", torch.bfloat16,
     (1, 2048, 64, 64, 128, 128), False, False),
    ("row 9a zamba2 train x=(1,2048,80,64) N=64 bf16", torch.bfloat16,
     (1, 2048, 80, 64, 64, 128), False, False),
    # a rank of phase train_mesh's (2, 2) world: mamba2's 64 SSD heads at
    # model 2, its 2 rows of the one 4 x 1024 microbatch
    ("row 9m train_mesh rank x=(2,1024,32,64) N=128 bf16", torch.bfloat16,
     (2, 1024, 32, 64, 128, 128), False, False),
    ("S=300 Q=128 h0 dh_final bf16", torch.bfloat16,
     (2, 300, 4, 64, 128, 128), True, True),
    ("S=300 Q=128 h0 dh_final fp32", torch.float32,
     (2, 300, 4, 64, 128, 128), True, True),
    ("S=100 Q=12 hd=32 h0 dh_final fp32", torch.float32,
     (3, 100, 4, 32, 32, 12), True, True),
    ("S=100 Q=12 hd=32 h0 dh_final bf16", torch.bfloat16,
     (3, 100, 4, 32, 32, 12), True, True),
    ("S=37 Q=64 hd=16 N=16 dh_final fp32", torch.float32,
     (2, 37, 4, 16, 16, 64), False, True),
    ("S=50 < Q=128 N=256 bf16", torch.bfloat16,
     (1, 50, 2, 64, 256, 128), False, True),
    ("S=45 Q=8 hd=48 h0 bf16", torch.bfloat16,
     (2, 45, 4, 48, 64, 8), True, False),
]
SSD_BWD_NAMES = ("dx", "ddt", "da", "db", "dc", "dh0")


def ssd_bwd_work(b, s, nh, hd, n, q, esz, init, dhf) -> tuple:
    """Bytes and operations of one SSD backward. Bytes: x, dy, dx (x's
    type), B, C, dB, dC, dt, ddt, a, da, the saved chunk entry states
    (fp32) and dh_final / dh0 once each. Operations over the causal
    triangles, per (row, head, chunk of c real positions): dy . xdt^T and
    M^T dy (c^2 hd each), the Q x Q products of dB and dC (c^2 N each), and
    the five c hd N products (S, h_in^T dy, dH^T xdt, dH B, h_in C); plus
    C B^T once per (row, chunk) (c^2 N, shared by the heads); 2 FLOPs a
    multiply-add."""
    qs = [min(q, s - t) for t in range(0, s, q)]
    state = 4 * b * nh * hd * n
    nbytes = (3 * b * s * nh * hd * esz + 4 * b * s * n * esz
              + 4 * (2 * b * s * nh + 2 * nh) + state * len(qs)
              + state * (int(init) + int(dhf)))
    flops = sum(b * c * c * n + b * nh * (c * c * hd + c * c * n
                                          + 5 * c * hd * n) for c in qs)
    return nbytes, 2.0 * flops


def kernel_ssd_bwd(cs, dev, rehearsal) -> dict:
    """The SSD scan's backward (kernel 9, no Pallas counterpart) against
    its plain version evaluated in fp32 on the same input values, both
    given the exact chunk entry states (``ssd_states_plain`` in fp32):
    every gradient within 1e-4 of its largest element (another summation
    order), a bf16 dx / dB / dC also within one bf16 rounding of it (2^-8
    of the largest element). Rows 9 and 9a are timed, with the forward
    with and without its states output beside row 9."""
    name = "ssd_scan_bwd"
    rows, main = [], None
    for label, dtype, shp, init, dhf in SSD_BWD_SPECS:
        b, s, nh, hd, n, q = shp
        if rehearsal:
            b, s, nh, hd, n, q = (min(b, 2), min(s, 40), min(nh, 4),
                                  min(hd, 16), min(n, 16), min(q, 16))
        args, h0 = ssd_inputs(cs, b, s, nh, hd, n, dtype, init)
        dy = cs.randn(b, s, nh, hd, dtype=dtype)
        dh = cs.randn(b, nh, hd, n, dtype=torch.float32) if dhf else None
        states = in_fp32(ssd.ssd_states_plain)(*args, q, h0)
        body = "plain version"
        if not rehearsal:
            kind, group, _ = ssd.bwd_plan(args[0], args[3], args[4], q)
            body = f"{kind} body, {group} heads a CTA"
            if label.startswith("row 9") and kind != "tensor-core":
                raise SystemExit(f"chip_smoke: {name} {label} took the "
                                 f"{body}, not the tensor-core body")
        refs = in_fp32(ssd.ssd_scan_bwd_plain)(*args, q, h0, dy, dh)
        if rehearsal:
            run = lambda: in_fp32(ssd.ssd_scan_bwd_plain)(  # noqa: E731
                *args, q, h0, dy, dh)
        else:
            run = lambda: ssd.ssd_scan_bwd(  # noqa: E731
                *args, q, states, dy, dh, want_dh0=init)
        got = run()
        errs, ok = [], True
        for i, (g, r) in enumerate(zip(got, refs)):
            if r is None:
                ok = ok and g is None
                continue
            big = r.abs().max().item()
            lim = 1e-4 * big + 1e-7 + (2 ** -8 * big if dtype ==
                                       torch.bfloat16 and i in (0, 3, 4)
                                       else 0.0)
            err = (g.float() - r).abs().max().item()
            ok = ok and bool(torch.isfinite(g.float()).all()) and err <= lim
            errs.append((SSD_BWD_NAMES[i], err, lim))
        log(f"[kernels] {name:24s} {label:44s} ({body}) "
            + "; ".join(f"{k} {e:.2e} (limit {lim:.2e})"
                        for k, e, lim in errs) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                             f"version ({label})")
        if main is None:
            main = max(e for _, e, _ in errs)
        if label.startswith("row 9"):
            work = ssd_bwd_work(b, s, nh, hd, n, q, 2, init, dhf)
            ms, dev_ms = time_both(run)
            b_ms, b_by = bound(*work, torch.bfloat16)
            row = dict(shape=label, body=body, ms=ms, device_ms=dev_ms,
                       library_ms=None, library_device_ms=None,
                       bound_ms=b_ms, bound_by=b_by,
                       share_of_bound=b_ms / dev_ms)
            row["plain_ms"] = time_ms(lambda: ssd.ssd_scan_bwd_plain(
                *args, q, h0, dy, dh), iters=3, warmup=1)
            if not rows:
                row["fwd_states"] = ssd_fwd_states_ms(args, q, h0, rehearsal)
            log(f"[kernels] {name:24s} backward {ms:.4f} ms (device "
                f"{dev_ms:.4f}, {100 * b_ms / dev_ms:.2f}% of bound)  bound "
                f"{b_ms:.4f} ms ({b_by}, {work[0] / 1e6:.1f} MB, "
                f"{work[1] / 1e9:.2f} GFLOP)  {label}")
            rows.append(row)
        del args, h0, dy, dh, states, refs, got
    first = rows[0]
    return dict(name=name, route="cuda", source=ssd.BWD_SOURCE,
                replaces=ssd.REPLACES[name], max_abs_err=main,
                ms=first["ms"], device_ms=first["device_ms"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=None,
                library_device_ms=None, shape=first["shape"],
                share_of_bound=first["share_of_bound"],
                fwd_states=first["fwd_states"], timed_shapes=rows[1:])


def ssd_fwd_states_ms(args, q, h0, rehearsal) -> dict:
    """Device ms of the forward kernel at the backward's main shape,
    without and with its chunk entry states output (what training adds
    to the serving launch)."""
    if rehearsal:
        return {}
    x, _, _, bm, _ = args
    states = torch.empty((x.shape[0], -(-x.shape[1] // q), *x.shape[2:],
                          bm.shape[-1]), dtype=torch.float32,
                         device=x.device)
    out = {}
    for key, st in (("without", None), ("with", states)):
        out[key] = time_ms(lambda: ssd.ssd_scan(  # noqa: E731
            *args, chunk=q, h0=h0, states=st), graph=True)
    log(f"[kernels] ssd_scan forward at the train shape: device "
        f"{out['without']:.4f} ms without the states output, "
        f"{out['with']:.4f} ms with it")
    return out


# -- the flash backward (training) -------------------------------------------------
# (label, dtype, (nh, nkv, d, b, sq, sk), causal, window): the train path's
# shape first (internlm2-1.8b: 16/8 heads of 128, one 2048-token row per
# microbatch), then g = 6 (qwen2-vl-2b), g = 12 (command-r-plus), d 120
# under danube's 4096 window past it, d 80 (zamba2), d 64 non-causal with
# Sq != Sk (whisper's cross attention at full width), and small fp32 and
# bf16 edges (ragged, windows, Sq != Sk both ways; a grid of 16 key tiles
# x KV heads whose steps the bf16 body splits over CTAs; lengths and a
# window that end inside its 128-key tiles). Every query row sees a key: a row that sees none gets
# the reference's uniform softmax from the plain version and 0 from the
# kernels, in the forward as in the backward
BWD_TRAIN = ("train q=(1,2048,16,128) k/v=(1,2048,8,128) causal bf16",
             torch.bfloat16, (16, 8, 128, 1, 2048, 2048), True, None)
BWD_SPECS = [
    BWD_TRAIN,
    ("g=6 qwen2-vl 12/2 d128 S=2048 causal bf16", torch.bfloat16,
     (12, 2, 128, 1, 2048, 2048), True, None),
    ("g=12 cmdr 96/8 d128 S=512 causal bf16", torch.bfloat16,
     (96, 8, 128, 1, 512, 512), True, None),
    ("d120 danube 32/8 S=4600 SWA=4096 bf16", torch.bfloat16,
     (32, 8, 120, 1, 4600, 4600), True, 4096),
    ("d80 zamba2 32/32 S=2048 causal bf16", torch.bfloat16,
     (32, 32, 80, 1, 2048, 2048), True, None),
    ("d64 whisper cross Sq=448 Sk=1500 non-causal bf16", torch.bfloat16,
     (6, 6, 64, 2, 448, 1500), False, None),
    # a rank of phase train_mesh's (2, 2) world: internlm2's 16/8 heads at
    # model 2, one 1024-token row per microbatch
    ("train_mesh rank q=(1,1024,8,128) k/v=(1,1024,4,128) causal bf16",
     torch.bfloat16, (8, 4, 128, 1, 1024, 1024), True, None),
    ("train shape fp32 S=512", torch.float32,
     (16, 8, 128, 1, 512, 512), True, None),
    ("g=6 d120 S=37 SWA=9 fp32", torch.float32,
     (12, 2, 120, 2, 37, 37), True, 9),
    ("g=12 d80 S=37 fp32", torch.float32, (12, 1, 80, 2, 37, 37), True, None),
    ("d16 Sq=13 Sk=37 non-causal fp32", torch.float32,
     (4, 2, 16, 2, 13, 37), False, None),
    ("d32 Sq=37 Sk=13 causal fp32", torch.float32,
     (4, 2, 32, 2, 37, 13), True, None),
    ("d64 S=200 SWA=40 non-causal fp32", torch.float32,
     (4, 2, 64, 2, 200, 200), False, 40),
    ("d16 S=37 g=2 bf16", torch.bfloat16, (4, 2, 16, 2, 37, 37), True, None),
    ("d32 Sq=13 Sk=37 non-causal bf16", torch.bfloat16,
     (6, 6, 32, 2, 13, 37), False, None),
    ("d64 S=300 SWA=50 g=8 bf16", torch.bfloat16,
     (16, 2, 64, 2, 300, 300), True, 50),
    ("split g=12 B=1 S=1024 d128 bf16", torch.bfloat16,
     (24, 2, 128, 1, 1024, 1024), True, None),
    ("tile edges Sq=129 Sk=257 SWA=70 g=4 bf16", torch.bfloat16,
     (8, 2, 128, 2, 129, 257), True, 70),
]
BWD_TIMED = [s[0] for s in BWD_SPECS[:7]]
BWD_MULTIPLE = 3              # bf16: within 3x the plain version's own error


def bwd_work(b, sq, sk, nh, nkv, d, causal, window, esz) -> tuple:
    """Bytes (q, out, dout, dq; k, v, dk, dv; lse once each) and operations
    of one backward: 2.5x the forward's matmul FLOPs over the visible
    keys."""
    qpos = np.arange(sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, int)
    vis = np.maximum(hi - lo + 1, 0).sum()
    nbytes = (4 * b * sq * nh * d + 4 * b * sk * nkv * d) * esz \
        + 4 * b * nh * sq
    return nbytes, 2.5 * 4.0 * b * nh * d * vis


def _bwd_case(cs, dtype, geo, causal, window):
    nh, nkv, d, b, sq, sk = geo
    return (cs.randn(b, sq, nh, d, dtype=dtype),
            cs.randn(b, sk, nkv, d, dtype=dtype),
            cs.randn(b, sk, nkv, d, dtype=dtype),
            cs.randn(b, sq, nh, d, dtype=dtype))


def sdpa_backward(q, k, v, dout, causal, window):
    """SDPA's backward alone on head-repeated K/V (the yardstick the port
    never calls): the forward runs once, each call is one
    ``autograd.grad`` of it."""
    sq, sk, sv, _ = _sdpa_inputs(q, k, v, None)
    leaves = [t.detach().requires_grad_(True) for t in (sq, sk, sv)]
    kw = dict(is_causal=causal)
    if window:
        kw = dict(attn_mask=fa._mask(q.shape[1], k.shape[1], causal, window,
                                     q.device)[0, 0, 0])
    with torch.enable_grad():
        out = F.scaled_dot_product_attention(*leaves, **kw)
    g = dout.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def kernel_flash_bwd(cs, dev, rehearsal) -> dict:
    """The flash forward's log-sum-exp (held to the plain one) and the
    backward kernel (held to the plain gradient in fp32: fp32 within 1e-4
    of each gradient's largest element, bf16 within 3x the plain version's
    own bf16 error), at the train path's shape and the other families';
    each timed shape also times the forward with the log-sum-exp and
    SDPA's backward."""
    name = "flash_attention_bwd"
    timed, main = {}, None
    for label, dtype, geo, causal, window in BWD_SPECS:
        if rehearsal:
            nh, nkv, d, b, sq, sk = geo
            short = min(sq, 40)
            geo = (nh // nkv, 1, d, 1, short, short if sq == sk else
                   min(sk, 50))
        q, k, v, dout = _bwd_case(cs, dtype, geo, causal, window)
        kw = dict(causal=causal, window=window)
        lse_ref = fa.flash_lse_plain(q, k, **kw)
        refs = fa.flash_attention_bwd_plain(q, k, v, dout, **kw)
        own = None
        if dtype == torch.bfloat16:
            with torch.enable_grad():
                ls = [t.detach().requires_grad_(True) for t in (q, k, v)]
                own = torch.autograd.grad(
                    fa.flash_attention_plain(*ls, **kw), ls, dout)
        if rehearsal:
            lse, got = lse_ref, tuple(r.to(dtype) for r in refs)
            out = in_fp32(fa.flash_attention_plain)(q, k, v, **kw).to(dtype)
            nsplit = 1
        else:
            lse = torch.empty(lse_ref.shape, dtype=torch.float32, device=dev)
            out = fa.flash_attention(q, k, v, lse=lse, **kw)
            got = fa.flash_attention_bwd(q, k, v, out, dout, lse, **kw)
            nsplit = fa.bwd_plan(q, k, **kw)[1]
            if label.startswith("split") and nsplit == 1:
                raise SystemExit(f"chip_smoke: {name} did not split its "
                                 f"key tiles' steps ({label})")
        lse_err = (lse - lse_ref).abs().max().item()
        errs, ok = [], lse_err <= 1e-3 + 1e-4 * lse_ref.abs().max().item()
        for i, (g, r) in enumerate(zip(got, refs)):
            err = (g.float() - r).abs().max().item()
            lim = (1e-4 * r.abs().max().item() + 1e-7 if own is None else
                   BWD_MULTIPLE * (own[i].float() - r).abs().max().item())
            finite = bool(torch.isfinite(g.float()).all())
            ok = ok and finite and err <= lim
            errs.append((err, lim))
        log(f"[kernels] {name:24s} {label:50s} split {nsplit}; lse "
            f"{lse_err:.2e}; "
            + "; ".join(f"d{n} {e:.2e} (limit {lim:.2e})"
                        for n, (e, lim) in zip("qkv", errs))
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain "
                             f"version ({label})")
        if main is None:
            main = max(e for e, _ in errs)
        if label in BWD_TIMED:
            timed[label] = (q, k, v, out, dout, lse, kw, geo)
        del q, k, v, dout, refs, own, got, out, lse
    rows = []
    for label in BWD_TIMED:
        q, k, v, out, dout, lse, kw, geo = timed[label]
        nh, nkv, d, b, sq, sk = geo
        work = bwd_work(b, sq, sk, nh, nkv, d, kw["causal"], kw["window"], 2)
        if rehearsal:
            run = lambda: fa.flash_attention_bwd_plain(  # noqa: E731
                q, k, v, dout, **kw)
            fwd = lambda: in_fp32(fa.flash_attention_plain)(  # noqa: E731
                q, k, v, **kw)
        else:
            run = lambda: fa.flash_attention_bwd(  # noqa: E731
                q, k, v, out, dout, lse, **kw)
            fwd = lambda: fa.flash_attention(  # noqa: E731
                q, k, v, lse=lse, **kw)
        ms, dev_ms = time_both(run)
        lib_ms = time_ms(sdpa_backward(q, k, v, dout, **kw))
        plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, dout, **kw), iters=3, warmup=1)
        f_ms, f_dev_ms = time_both(fwd)
        f_lib = flash_yardstick((q, k, v), **kw)
        f_lib_ms = time_ms(f_lib[0])
        b_ms, b_by = bound(*work, torch.bfloat16)
        fb_ms, fb_by = bound(*f_lib[1], torch.bfloat16)
        share = b_ms / dev_ms
        row = dict(shape=label, ms=ms, device_ms=dev_ms, library_ms=lib_ms,
                   library_device_ms=None, bound_ms=b_ms, bound_by=b_by,
                   share_of_bound=share, plain_ms=plain_ms,
                   fwd_lse=dict(ms=f_ms, device_ms=f_dev_ms,
                                library_ms=f_lib_ms, bound_ms=fb_ms,
                                bound_by=fb_by))
        log(f"[kernels] {name:24s} backward {ms:.4f} ms (device "
            f"{dev_ms:.4f}, {100 * share:.1f}% of bound)  SDPA backward "
            f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}); forward with "
            f"lse {f_ms:.4f} ms (device {f_dev_ms:.4f})  SDPA "
            f"{f_lib_ms:.4f} ms  bound {fb_ms:.4f} ms ({fb_by})  {label}")
        rows.append(row)
    first = rows[0]
    return dict(name=name, route="cuda", source=fa.BWD_SOURCE,
                replaces=fa.REPLACES[name], max_abs_err=main,
                ms=first["ms"], device_ms=first["device_ms"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                bound_by=first["bound_by"], library_ms=first["library_ms"],
                library_device_ms=None, shape=first["shape"],
                share_of_bound=first["share_of_bound"],
                fwd_lse=first["fwd_lse"], timed_shapes=rows[1:],
                host_us=None if rehearsal else bwd_host_us(cs))


def bwd_host_us(cs, n: int = 200, rounds: int = 7) -> dict:
    """Host microseconds per call of the backward entry point at a tiny
    shape, straight through ctypes: bf16 (the SM-count read, four
    tensor-map encodes, then three launches) against fp32 (three
    launches), in alternating rounds of ``n`` calls, median per dtype (the
    host's cores are shared, so one round of each can invert the order);
    the difference is the encodes' host time, the SM-count read
    included."""
    lib = _build.load()
    calls, times = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        q = cs.randn(1, 16, 8, 128, dtype=dtype)
        k = cs.randn(1, 16, 8, 128, dtype=dtype)
        lse = torch.zeros((1, 8, 16), device=q.device)
        grads = [torch.empty_like(q) for _ in range(3)]
        work = torch.empty(fa.bwd_plan(q, k)[0], device=q.device)
        keep = (q, k, lse, grads, work)
        args = (q.data_ptr(), k.data_ptr(), k.data_ptr(), q.data_ptr(),
                q.data_ptr(), lse.data_ptr(), work.data_ptr(),
                *(g.data_ptr() for g in grads), 1, 16, 16, 8, 8, 128, 1, 0,
                0.088, int(dtype == torch.bfloat16),
                _build.stream_ptr(q.device))
        calls[str(dtype)[6:]] = (args, keep)
        times[str(dtype)[6:]] = []
        lib.rt_flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for r in range(rounds):
        for key in (("bfloat16", "float32") if r % 2 == 0
                    else ("float32", "bfloat16")):
            args = calls[key][0]
            t0 = time.perf_counter()
            for _ in range(n):
                lib.rt_flash_attention_bwd(*args)
            times[key].append((time.perf_counter() - t0) * 1e6 / n)
            torch.cuda.synchronize()
    out = {key: float(np.median(v)) for key, v in times.items()}
    out["encode"] = out["bfloat16"] - out["float32"]
    log(f"[kernels] flash_attention_bwd host us per call (ctypes, tiny "
        f"shape, median of {rounds} alternating rounds of {n}): bf16 "
        f"{out['bfloat16']:.2f} (SM count, four tensor-map encodes + three "
        f"launches), fp32 {out['float32']:.2f} (three launches); encodes "
        f"{out['encode']:.2f}")
    return out


def phase_kernels(dev, rehearsal: bool) -> list:
    cs = Cases(dev)
    rows = [kernel_decode(cs, dev, rehearsal, paged=True),
            kernel_chunk(cs, dev, rehearsal, paged=True),
            kernel_flash(cs, dev, rehearsal),
            kernel_decode(cs, dev, rehearsal, paged=False),
            kernel_chunk(cs, dev, rehearsal, paged=False),
            kernel_ssd(cs, dev, rehearsal),
            kernel_probe(cs, dev, rehearsal),
            kernel_flash_bwd(cs, dev, rehearsal),
            kernel_ssd_bwd(cs, dev, rehearsal),
            kernel_decode_lse(cs, dev, rehearsal)]
    for r in rows:
        if "ms" not in r:       # the lse output: timed on the card only
            continue
        lib = fmt_ms(r["library_ms"], r["library_device_ms"])
        log(f"[kernels] {r['name']:24s} kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f})  plain "
            f"{r['plain_ms']:.4f} ms  library {lib}  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['shape']}")
    return rows


# -- phase 4: engine parity (fp32, card vs CPU) ----------------------------------
def _requests(specs, vocab, seed):
    rng = np.random.RandomState(seed)
    return [ServeRequest(prompt=rng.randint(0, vocab, n).tolist(),
                         max_new_tokens=m) for n, m in specs]


_BUCKETED = [(5, 8), (12, 6), (27, 9), (33, 4), (9, 7)]
_CHUNKED = [(40, 6), (17, 5), (3, 12), (29, 8)]
_MOE = [(5, 8), (12, 6), (27, 9), (9, 7), (20, 5)]
# the first admission on 3 slots groups the two 12-token prompts
_RECURRENT = [(5, 8), (12, 6), (12, 9), (27, 4), (9, 7)]
_SSD = dict(max_batch=3, max_len=64, model_kw={"ssd_chunk": 8})
PARITY = [
    ("bucketed", "qwen3-32b", dict(max_batch=4, max_len=64), _BUCKETED),
    ("chunked", "qwen3-32b", dict(max_batch=4, max_len=64, prefill_chunk=8),
     _CHUNKED),
    ("overcommit", "qwen3-32b",
     dict(max_batch=4, max_len=64, block_size=8, n_blocks=11,
          kv_overcommit=2.5, prefill_chunk=8),
     [(9, 20), (11, 20), (13, 20)]),
    # the sanitizer on (the device probe armed), overcommitted so that it
    # preempts and re-attaches, more requests than slots, chunked prompts
    # admitted into released (poisoned) blocks
    ("sanitized", "qwen3-32b",
     dict(max_batch=4, max_len=64, block_size=8, n_blocks=11,
          kv_overcommit=2.5, prefill_chunk=8, kv_sanitize=True),
     [(9, 20), (11, 20), (13, 20), (30, 6), (5, 9), (41, 4)]),
    ("contig", "qwen3-32b", dict(max_batch=4, max_len=64,
                                 kv_layout="contig"), _BUCKETED),
    ("contig_chunked", "qwen3-32b",
     dict(max_batch=4, max_len=64, kv_layout="contig", prefill_chunk=8),
     _CHUNKED),
    # the reference's batch-1 exact-length baseline (contig, never chunked)
    ("legacy", "qwen3-32b",
     dict(max_batch=4, max_len=64, prefill_chunk=8, admission="legacy"),
     _BUCKETED + [(33, 5)]),
    ("moe_phi", MOE, dict(max_batch=2, max_len=64), _MOE),
    ("moe_granite", "granite-moe-3b-a800m", dict(max_batch=2, max_len=64),
     _MOE),
    ("mamba2", "mamba2-1.3b", _SSD, _RECURRENT),
    ("zamba2", "zamba2-2.7b", _SSD, _RECURRENT),
    # the M-RoPE VLM from tokens (identical streams), paged, chunked
    ("vlm", "qwen2-vl-2b", dict(max_batch=4, max_len=64, prefill_chunk=8),
     _CHUNKED + [(12, 5)]),
    # command-r-plus's layernorm / tied / GQA trunk, paged, chunked
    ("cmdr", "command-r-plus-104b",
     dict(max_batch=4, max_len=64, prefill_chunk=8), _CHUNKED),
    # h2o-danube's window (8 when reduced) through paged chunk and decode
    ("danube", "h2o-danube-3-4b",
     dict(max_batch=4, max_len=64, prefill_chunk=8), _CHUNKED),
    # the encoder-decoder (contig): batched, chunked (cross cache warmed
    # per group), legacy batch-1
    ("whisper", "whisper-tiny", dict(max_batch=4, max_len=64), _BUCKETED),
    ("whisper_chunked", "whisper-tiny",
     dict(max_batch=4, max_len=64, prefill_chunk=8), _CHUNKED + [(12, 5)]),
    ("whisper_legacy", "whisper-tiny",
     dict(max_batch=4, max_len=64, prefill_chunk=8, admission="legacy"),
     _CHUNKED),
]
# kernels a scenario's card run must launch itself
PARITY_REQUIRED = {"sanitized": ("kv_probe", "decode_attention_paged",
                                 "chunk_attention_paged"),
                   "legacy": ("flash_attention", "decode_attention"),
                   "mamba2": ("ssd_scan",),
                   "zamba2": ("ssd_scan", "flash_attention",
                              "decode_attention"),
                   "vlm": ("flash_attention", "chunk_attention_paged",
                           "decode_attention_paged"),
                   "danube": ("chunk_attention_paged",
                              "decode_attention_paged"),
                   "whisper": ("flash_attention", "decode_attention"),
                   "whisper_chunked": ("flash_attention", "chunk_attention",
                                       "decode_attention"),
                   "whisper_legacy": ("flash_attention", "decode_attention")}


class RouterGap:
    """While active, the smallest gap between the k-th and (k+1)-th router
    probability over every token routed (how close a routing flip was)."""

    def __enter__(self):
        self.min = float("inf")
        self._orig = moe_mod.moe_apply

        def tracked(*a, **kw):
            out, probs, idx = self._orig(*a, **kw)
            k = idx.shape[1]
            top = torch.sort(probs, dim=-1, descending=True).values
            self.min = min(self.min, (top[:, k - 1] - top[:, k]).min().item())
            return out, probs, idx
        moe_mod.moe_apply = tracked
        return self

    def __exit__(self, *exc):
        moe_mod.moe_apply = self._orig


def _serve(eng, reqs, timing: dict | None = None) -> None:
    """Admit and step until every request is done. With ``timing``, add
    the host seconds spent in ``admit_many`` and ``step`` and the steps."""
    queue = list(reqs)
    while queue or eng.busy():
        if queue:
            ta = time.perf_counter()
            taken = {id(r) for r in eng.admit_many(queue)}
            queue = [r for r in queue if id(r) not in taken]
            if timing is not None:
                timing["admit_s"] += time.perf_counter() - ta
        ts = time.perf_counter()
        eng.step()
        if timing is not None:
            timing["step_s"] += time.perf_counter() - ts
            timing["steps"] += 1


def phase_engine_parity(dev) -> None:
    params = {}
    ops.reset_launch_counts()
    for name, arch, kw, specs in PARITY:
        cfg = get_config(arch).reduced()            # fp32, 4 layers, d16
        if arch not in params:
            cpu = build_model(cfg, device="cpu").init(seed=0)
            params[arch] = {"cpu": cpu, "dev": _tree_to(cpu, dev)}
        out, gaps = {}, {}
        for where in ("dev", "cpu"):
            eng = Engine(cfg, params[arch][where],
                         device=dev if where == "dev" else "cpu", **kw)
            reqs = _requests(specs, cfg.vocab, seed=1)
            before = ops.launch_counts()
            with RouterGap() as gap:
                _serve(eng, reqs)
            assert all(r.done for r in reqs), name
            out[where] = ([list(r.generated) for r in reqs],
                          dataclasses.asdict(eng.stats))
            gaps[where] = gap.min
            if where == "dev" and str(dev) != "cpu":
                after = ops.launch_counts()
                idle = [k for k in PARITY_REQUIRED.get(name, ())
                        if after[k] == before[k]]
                if idle:
                    raise SystemExit(f"chip_smoke: {idle} never launched in "
                                     f"the {name} parity run")
        same = out["dev"] == out["cpu"]
        extra = ""
        if cfg.n_experts:
            assert eng._group == 1 and eng.kv_layout == "contig", name
            extra = (f" min_router_gap dev={gaps['dev']:.3e} "
                     f"cpu={gaps['cpu']:.3e}")
        log(f"[engine-parity] {name:14s} {eng.kv_layout:6s} tokens+stats "
            f"identical={same} stats={out['dev'][1]}{extra}")
        if not same:
            raise SystemExit(f"chip_smoke: engine parity failed ({name}): "
                             f"{out}")
        if name == "contig_chunked" and not out["dev"][1]["chunk_scatters"]:
            raise SystemExit("chip_smoke: contig chunked parity ran no "
                             "chunk scatter")
        st = out["dev"][1]
        # legacy: one prefill shape per distinct length, a repeat none
        if name == "legacy" and not (
                st["prefill_retraces"] == len({n for n, _ in specs})
                and st["prefill_batches"] == st["prefills"] == len(specs)
                and not st["prefill_chunks"]):
            raise SystemExit(f"chip_smoke: legacy parity is not one "
                             f"batch-1 prefill per request: {st}")
        if name == "sanitized" and not (eng._kv_probe and st["preemptions"]
                                        and st["chunk_direct"]):
            raise SystemExit(f"chip_smoke: the sanitized parity run armed "
                             f"no probe, or did not preempt or chunk: {st}")
        if name in ("mamba2", "zamba2") and not (
                st["prefill_batches"] < st["prefills"]
                and eng.kv_layout == "contig"):
            raise SystemExit(f"chip_smoke: {name} parity formed no group "
                             f"of equal-length prompts: {st}")
        if name == "whisper_chunked" and not (st["chunk_scatters"]
                                              and eng.kv_layout == "contig"):
            raise SystemExit(f"chip_smoke: whisper chunked parity ran no "
                             f"chunk scatter: {st}")
    counts = ops.launch_counts()
    log(f"[engine-parity] launches {counts}")
    # serving launches every kernel but the backwards (phase 4b trains)
    serving = {k: n for k, n in counts.items()
               if k not in ("flash_attention_bwd", "ssd_scan_bwd")}
    if str(dev) != "cpu" and not all(serving.values()):
        raise SystemExit(f"chip_smoke: a kernel never launched: {counts}")


def image_grid_positions(b: int, t: int, h: int, w: int, n_text: int,
                         dev) -> torch.Tensor:
    """(3, B, S) M-RoPE streams of a ``t x h x w`` patch grid, then
    ``n_text`` text tokens numbered on from one past the grid's largest
    index in all three streams (Qwen2-VL's numbering)."""
    ti, hi, wi = torch.meshgrid(torch.arange(t), torch.arange(h),
                                torch.arange(w), indexing="ij")
    grid = torch.stack([ti.reshape(-1), hi.reshape(-1), wi.reshape(-1)])
    text = (grid.max() + 1 + torch.arange(n_text)).expand(3, n_text)
    pos = torch.cat([grid, text], dim=1)
    return pos[:, None].expand(3, b, pos.shape[1]).contiguous().to(dev)


def phase_model_parity(dev) -> None:
    """fp32, reduced configs, the card against the CPU through the model
    entry points the engine does not drive: qwen2-vl-2b's ``prefill`` from
    patch embeddings under a 2 x 4 x 4 image grid's distinct M-RoPE
    streams, then embeds decode steps; h2o-danube-3-4b's ring cache,
    ``prefill(ring=True)`` of a prompt past the window (8) and greedy
    decode across the ring's end, whose tokens must equal the linear
    (``ring=False``) run's. Logits within 1e-4, greedy tokens equal."""
    def same(tag, a, b):
        err = (a.float().cpu() - b.float()).abs().max().item()
        ok = err <= 1e-4 and torch.equal(a.argmax(-1).cpu(), b.argmax(-1))
        log(f"[model-parity] {tag:44s} max_abs_err={err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: model parity failed ({tag})")

    ops.reset_launch_counts()
    cfg = get_config("qwen2-vl-2b").reduced()
    m_cpu, m_dev = build_model(cfg, device="cpu"), build_model(cfg,
                                                                device=dev)
    cpu = m_cpu.init(seed=0)
    par = _tree_to(cpu, dev)
    gen = torch.Generator().manual_seed(3)
    pos = image_grid_positions(2, 2, 4, 4, 8, "cpu")
    emb = torch.randn(2, pos.shape[-1], cfg.d_model, generator=gen)
    lc, cc = m_cpu.prefill(cpu, {"embeds": emb, "positions": pos},
                           max_len=48)
    ld, cd = m_dev.prefill(par, {"embeds": emb.to(dev),
                                 "positions": pos.to(dev)}, max_len=48)
    same("vlm prefill embeds + image-grid M-RoPE", ld, lc)
    for i in range(3):
        e = torch.randn(2, 1, cfg.d_model, generator=gen)
        lc, cc = m_cpu.decode_step(cpu, cc, e)
        ld, cd = m_dev.decode_step(par, cd, e.to(dev))
        same(f"vlm embeds decode step {i}", ld, lc)
    cfg = get_config("h2o-danube-3-4b").reduced()
    m_cpu, m_dev = build_model(cfg, device="cpu"), build_model(cfg,
                                                                device=dev)
    cpu = m_cpu.init(seed=0)
    par = _tree_to(cpu, dev)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=gen)
    runs = {}
    for tag, model, p, where, ring in (("ring dev", m_dev, par, dev, True),
                                       ("ring cpu", m_cpu, cpu, "cpu", True),
                                       ("linear dev", m_dev, par, dev, False)):
        logits, cache = model.prefill(p, {"tokens": toks.to(where)},
                                      max_len=40, ring=ring)
        seq, steps = [], []
        for _ in range(12):
            seq.append(model.sample_greedy(logits.reshape(2, -1)))
            steps.append(logits.reshape(2, -1).float().cpu())
            logits, cache = model.decode_step(p, cache, seq[-1][:, None])
        runs[tag] = (torch.stack(seq, 1).cpu(), steps)
    assert runs["ring dev"][0].shape[1] + 20 > 2 * cfg.swa_window
    for i, (a, b) in enumerate(zip(runs["ring dev"][1], runs["ring cpu"][1])):
        same(f"danube ring prompt 20 > window 8, step {i}", a, b)
    equal = torch.equal(runs["ring dev"][0], runs["linear dev"][0])
    log(f"[model-parity] danube ring tokens == linear tokens: {equal}")
    counts = ops.launch_counts()
    log(f"[model-parity] launches {counts}")
    if not equal:
        raise SystemExit("chip_smoke: the ring cache's tokens differ from "
                         "the linear cache's")
    if str(dev) != "cpu" and not all(
            counts[k] for k in ("flash_attention", "decode_attention")):
        raise SystemExit(f"chip_smoke: the model parity runs launched no "
                         f"flash or contiguous decode: {counts}")


# phase 4 prefix scenarios: the donor / sharer traffic of
# tests/test_kv_prefix.py on the reduced qwen3-32b, blocks of 4 tokens, one
# admission call per wave: full-block sharing; a donor whose last block is
# partial and sharers diverging inside it, admitted in its call (deferred
# copy-on-write at the suffix dispatch); later sharers of the same block
# (copy-on-write at admission)
PREFIX_KW = dict(max_batch=8, max_len=64, block_size=4)
PREFIX_BASES = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8],
                [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5])


def prefix_waves() -> list:
    a, b = PREFIX_BASES
    return [[a + [10 + i, 20 + i] for i in range(4)],
            [b[:8] + [7, 7]] + [b[:8] + [7, 30 + i, 40 + i]
                                for i in range(3)],
            [b[:8] + [7, 60 + i, 70 + i] for i in range(2)]]


def prefix_scenario(cfg, params, dev, share=True, sanitize=False,
                    plant=None) -> dict:
    """Serve ``prefix_waves`` on a paged engine on ``dev``. With
    ``plant``, then plant the poison in a block shared from the first
    wave's prefix that the next sharer's suffix dispatch reads ("read") or
    does not ("unread") and admit that sharer; ``raised`` says whether it
    raised ``KVSanitizerError``. Returns tokens, counters and the pool's
    end state."""
    eng = Engine(cfg, params, device=dev, prefix_share=share,
                 kv_sanitize=sanitize, **PREFIX_KW)
    reqs = []
    for wave in prefix_waves():
        rs = [ServeRequest(prompt=list(p), max_new_tokens=4) for p in wave]
        reqs += rs
        _serve(eng, rs)
    out = dict(tokens=[list(r.generated) for r in reqs],
               stats=dataclasses.asdict(eng.stats),
               no_leak=eng.bm.check_no_leak(),
               in_use=eng.bm.blocks_in_use())
    if plant is not None:
        a = PREFIX_BASES[0]
        ids = eng._prefix.full_run(a)
        eng.cache["k"][:, ids[0] if plant == "read" else ids[2]] = KV_POISON
        sharer = ServeRequest(prompt=a[:8] + [50, 51, 52], max_new_tokens=3)
        try:
            _serve(eng, [sharer])
            out["raised"] = False
        except KVSanitizerError:
            out["raised"] = not sharer.generated   # before its first token
    return out


def phase_prefix_parity(dev) -> None:
    """The prefix scenarios, fp32, on the card and on the CPU: tokens,
    every counter and the pool's end state identical, the tokens those of
    the engine without sharing, hits, shared tokens and both kinds of
    copy-on-write, no block left in use; sanitized, the same plus the
    poison plants (a suffix dispatch reading a poisoned shared block must
    raise, one not reading it must not); on the card paged chunk (the
    suffix dispatches), paged decode and flash launched, and the probe
    when sanitized."""
    cfg = get_config("qwen3-32b").reduced()
    cpu = build_model(cfg, device="cpu").init(seed=0)
    card = _tree_to(cpu, dev)
    plain = prefix_scenario(cfg, cpu, "cpu", share=False)["tokens"]
    for tag, kw, need in (
            ("prefix", {}, PATHS["main"][2]),
            ("prefix_sanitized", dict(sanitize=True), PATHS["sanitize"][2])):
        before = ops.launch_counts()
        runs = {"dev": prefix_scenario(cfg, card, dev, **kw)}
        after = ops.launch_counts()
        runs["cpu"] = prefix_scenario(cfg, cpu, "cpu", **kw)
        ran = {k: after[k] - before[k] for k in after
               if after[k] != before[k]}
        st = runs["dev"]["stats"]
        ok = (runs["dev"] == runs["cpu"] and runs["dev"]["tokens"] == plain
              and runs["dev"]["no_leak"] and runs["dev"]["in_use"] == 0
              and st["prefix_hits"] == 8 and st["cow_copies"] == 5
              and st["prefix_shared_tokens"] > 0)
        if kw:
            for plant in ("read", "unread"):
                raised = [prefix_scenario(cfg, p, d, plant=plant,
                                          **kw)["raised"]
                          for p, d in ((card, dev), (cpu, "cpu"))]
                log(f"[engine-parity] {tag} poison {plant:6s} raised "
                    f"card/cpu={raised}")
                ok = ok and raised == [plant == "read"] * 2
        log(f"[engine-parity] {tag:16s} paged tokens+stats identical="
            f"{runs['dev'] == runs['cpu']} tokens == sharing off: "
            f"{runs['dev']['tokens'] == plain} stats={st} launches {ran}")
        if str(dev) != "cpu" and not all(ran.get(k) for k in need):
            raise SystemExit(f"chip_smoke: {tag} parity launched {ran}, "
                             f"needs {need}")
        if not ok:
            raise SystemExit(f"chip_smoke: {tag} parity failed: {runs}")


# bf16 engine checks. Dense: Qwen3-32B's attention geometry (64/8 heads of
# 128) on a narrow, shallow trunk; prompts below and above prefill_chunk,
# so the bucketed prefill runs flash and the longer prompts chunk prefill.
# Recurrent: mamba2 (8 SSD heads of 64, state 128) and zamba2 (8 SSD heads
# of 64, state 64; the shared block's 32/32 heads of 80) at width 256 and
# two trunk layers (zamba2: four, the shared block after the second and
# fourth), prompts of one to six SSD chunks of 128, so the scan carries its
# state across chunks and ragged tails
BF16_ENGINE = dict(n_layers=2, d_model=256, d_ff=512, n_heads=64,
                   n_kv_heads=8, head_dim=128)
BF16_PROMPTS = [(37, 2), (150, 2), (211, 2), (300, 2), (517, 2), (700, 2)]
BF16_KW = dict(max_batch=4, max_len=768, prefill_chunk=256, block_size=16)
BF16_RECURRENT = {
    "mamba2-1.3b": dict(n_layers=2, d_model=256, ssm_head_dim=64,
                        ssm_state=128),
    "zamba2-2.7b": dict(n_layers=4, d_model=256, d_ff=512, n_heads=32,
                        n_kv_heads=32, head_dim=80, ssm_head_dim=64,
                        ssm_state=64),
}


class TeacherForced:
    """While active, every greedy sample of ``model`` returns the next of
    ``tokens`` (recorded from a reference run when ``tokens`` is None) and
    records the logits it was given: prefill logits whole, decode logits of
    the live slots only. ``decodes`` bounds the decode steps recorded."""

    def __init__(self, eng, tokens=None, decodes: int = 1):
        self.eng, self.tokens, self.decodes = eng, tokens, decodes
        self.logits, self.sampled = [], []

    def __enter__(self):
        model, eng = self.eng.model, self.eng
        orig_sample, orig_decode = model.sample_greedy, model.decode_step
        self._orig = (orig_sample, orig_decode)
        state = {"decode": False, "n_dec": 0}

        def decode_step(*a, **kw):
            state["decode"] = True
            return orig_decode(*a, **kw)

        def sample(logits):
            out = orig_sample(logits)
            if self.tokens is not None:
                out = self.tokens[len(self.sampled)].to(out.device)
            self.sampled.append(out.cpu())
            if state["decode"]:
                state["n_dec"] += 1
                live = [i for i, r in enumerate(eng.slots) if r is not None]
                if state["n_dec"] <= self.decodes:
                    self.logits.append(logits[live].float().cpu())
            else:
                self.logits.append(logits.float().cpu())
            state["decode"] = False
            return out
        model.sample_greedy, model.decode_step = sample, decode_step
        return self

    def __exit__(self, *exc):
        self.eng.model.sample_greedy, self.eng.model.decode_step = self._orig


def phase_engine_bf16(dev) -> None:
    """bf16 serving on the card against the same engine in fp32 on the CPU:
    the prefill logits and the first decode step's, with every run fed the
    fp32 run's tokens. The dense model paged and contig (flash and chunked
    prefill), then mamba2 and zamba2 (the SSD scan, and zamba2's flash and
    contiguous decode). The bf16 plain engine on the CPU is run the same
    way; its error sets the tolerance."""
    base = dataclasses.replace(get_config("qwen3-32b").reduced(),
                               **BF16_ENGINE)
    for layout in ("paged", "contig"):
        need = ("flash_attention", "chunk_attention_paged"
                if layout == "paged" else "chunk_attention")
        _bf16_engine_check(dev, layout, base, dict(
            BF16_KW, kv_layout="auto" if layout == "paged" else layout),
            need, layout)
    for arch, widths in BF16_RECURRENT.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **widths)
        _bf16_engine_check(dev, arch.split("-")[0], cfg, dict(BF16_KW),
                           PARITY_REQUIRED[arch.split("-")[0]], "contig")


def _bf16_engine_check(dev, tag, base, kw, need, layout) -> None:
    cfg16 = dataclasses.replace(base, dtype="bfloat16")
    cfg32 = dataclasses.replace(base, dtype="float32")
    p16 = build_model(cfg16, device="cpu").init(seed=0)
    p32 = _tree_map(p16, lambda t: t.float())
    runs = {}
    for name, cfg, params, where in (
            ("cpu_fp32", cfg32, p32, "cpu"), ("cpu_bf16", cfg16, p16, "cpu"),
            ("card_bf16", cfg16, _tree_to(p16, dev), dev)):
        eng = Engine(cfg, params, device=where, **kw)
        ref = runs.get("cpu_fp32")
        reqs = _requests(BF16_PROMPTS, cfg.vocab, seed=2)
        before = ops.launch_counts()
        with TeacherForced(eng, ref.sampled if ref else None) as tf:
            _serve(eng, reqs)
        runs[name] = tf
        if str(where) != "cpu":
            after = ops.launch_counts()
            ran = {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}
            if not all(ran.get(k) for k in need):
                raise SystemExit(f"chip_smoke: bf16 {tag} engine check "
                                 f"launched {ran}, needs {need}")
        assert eng.kv_layout == layout, (eng.kv_layout, layout)
    ref = runs["cpu_fp32"].logits
    scale = max(t.abs().max().item() for t in ref)

    def err(run):
        got = runs[run].logits
        assert [t.shape for t in got] == [t.shape for t in ref], run
        return max((a - b).abs().max().item() for a, b in zip(got, ref))
    cpu_err, card_err = err("cpu_bf16"), err("card_bf16")
    # tolerance: the bf16 plain engine's own error against fp32, three
    # times over. The card rounds the same values to bf16 at other places
    # (cuBLAS's bf16 GEMMs accumulate in another order, the attention
    # kernels round P to bf16 once per key tile, the SSD scan rounds M, x dt
    # and the state to bf16 as tensor-core operands), each of the same size
    # as the plain engine's roundings; a kernel that drops or adds keys or
    # positions moves the logits by a whole attention or SSD output, far
    # past it.
    tol = 3 * cpu_err
    ok = card_err <= tol and all(
        bool(torch.isfinite(t).all()) for t in runs["card_bf16"].logits)
    log(f"[engine-bf16] {tag:7s} {len(ref)} logits calls (prefill + "
        f"first decode), |logits| <= {scale:.3f}: card bf16 max_abs_err="
        f"{card_err:.3e}, cpu bf16 (plain) {cpu_err:.3e}, tol 3x cpu "
        f"= {tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"chip_smoke: bf16 {tag} engine logits off the "
                         f"fp32 CPU engine ({card_err:.3e} > {tol:.3e})")


def phase_poison_bf16(dev) -> None:
    """The probe in a bf16 pool on the card, where KV_POISON is stored as
    998,244,352 (below the reference's threshold): poison planted in a
    mapped block of a sanitized paged engine (Qwen3-32B heads, two layers)
    raises ``KVSanitizerError`` at the next decode step and, mid-prefill,
    at the next chunk; the same plant without the sanitizer raises
    nothing."""
    cfg = dataclasses.replace(get_config("qwen3-32b").reduced(),
                              **BF16_ENGINE, dtype="bfloat16")
    params = _tree_to(build_model(cfg, device="cpu").init(seed=0), dev)
    stored = torch.tensor(KV_POISON, dtype=torch.bfloat16).item()
    for where, chunk in (("decode", 0), ("chunk", 16)):
        for sanitize in (True, False):
            eng = Engine(cfg, params, device=dev, max_batch=2, max_len=64,
                         block_size=16, prefill_chunk=chunk,
                         kv_sanitize=sanitize)
            req = ServeRequest(prompt=list(range(1, 41 if chunk else 21)),
                               max_new_tokens=8)
            assert eng.admit(req)
            eng.step()
            if chunk:
                assert not req.generated, "the prompt should be mid-prefill"
                slot = eng._pending[0].members[0].slot
            else:
                slot = next(i for i, r in enumerate(eng.slots) if r is req)
            eng.cache["k"][:, int(eng.bm.table[slot, 0])] = KV_POISON
            raised = None
            try:
                eng.step()
            except KVSanitizerError as e:
                raised = str(e)
            ok = (raised is not None) == sanitize
            log(f"[engine-poison] bf16 {where:6s} sanitize={sanitize!s:5s} "
                f"probe armed={eng._kv_probe} poison as stored={stored:.9g}"
                f" raised={raised!r} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"chip_smoke: bf16 poison plant at the "
                                 f"{where} step with sanitize={sanitize}: "
                                 f"raised={raised!r}")


# fp32 server scenario of phase 4: a reduced qwen3-32b on two paged
# pipelines that carry placements (so the dispatch weights, bucket tables,
# round lengths and the engines' cost victims come from the estimator), cost
# dispatch, KV migration through a store whose byte budget, set at the
# interrupt to the weights plus 1.5 payloads, evicts a published payload
SERVER_PROMPTS = [(9, 14), (21, 12), (13, 16), (30, 10), (5, 12), (17, 14),
                  (26, 9), (11, 15)]
SERVER_INSTS = (("g6e.xlarge", 1), ("g6.12xlarge", 4))


def _kv_keys(events, kind) -> list:
    return [d for _, k, d in events if k == kind]


def server_scenario(cfg, params, dev) -> dict:
    """Serve ``SERVER_PROMPTS`` through a GlobalServer on ``dev`` and
    interrupt, after 3 rounds, one instance of the pipeline with the most
    live requests. Returns what must be identical on the card and the CPU:
    tokens per request, ``events``, the clock, the store's end state."""
    spec = cfg.to_modelspec()
    server = GlobalServer(cfg, TensorStore(), device=dev, max_batch=4,
                          max_len=64, prefill_chunk=8, dispatch="cost",
                          use_kv_migration=True,
                          engine_kw=dict(block_size=8))
    for i, (name, tp) in enumerate(SERVER_INSTS):
        inst = dataclasses.replace(AWS_INSTANCES[name],
                                   device=effective(AWS_INSTANCES[name].device))
        pl = Placement(spec, (Stage(inst, tp, spec.n_layers, first=True,
                                    last=True),))
        server.add_pipeline(params, [f"{name}/{i}"], placement=pl)
    rng = np.random.RandomState(3)
    reqs = [ServeRequest(prompt=rng.randint(0, cfg.vocab, n).tolist(),
                         max_new_tokens=m, rid=i)
            for i, (n, m) in enumerate(SERVER_PROMPTS)]
    for r in reqs:
        server.submit(r)
    for _ in range(3):
        server.step()
        server.tick()
    victim = max(server.pipelines, key=lambda p: len(p.engine.active()))
    store = server.store
    payload = next(iter(victim.engine.export_live_kv().values()))
    store.budget_bytes = store.resident_bytes() + int(
        1.5 * (payload["k"].nbytes + payload["v"].nbytes))
    snap = {r.rid: list(r.generated)
            for r in server.interrupt_instance(victim.instance_ids[0])}
    server.run_until_drained()
    ok = all(r.done for r in reqs) and all(
        reqs[rid].generated[:len(t)] == t for rid, t in snap.items())
    published = _kv_keys(server.events, "kv_publish")
    attached = _kv_keys(server.events, "kv_attach")
    return dict(tokens=[list(r.generated) for r in reqs],
                events=list(server.events), clock=server.clock,
                store=(store.keys(), store.resident_bytes(),
                       store.check_consistent()),
                ok=ok, attached=attached,
                evicted=[k for k in published if k not in attached])


def phase_server_parity(dev) -> None:
    """``server_scenario`` on the card and on the CPU, fp32: identical
    tokens per request and ``events``; at least one KV attach, at least
    one payload evicted by the store's budget (its request recomputes), no
    published payload left behind, migrated requests' tokens kept; on the
    card paged decode, paged chunk and flash launched."""
    cfg = get_config("qwen3-32b").reduced()
    cpu = build_model(cfg, device="cpu").init(seed=0)
    before = ops.launch_counts()
    card = server_scenario(cfg, _tree_to(cpu, dev), dev)
    after = ops.launch_counts()
    ran = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    host = server_scenario(cfg, cpu, "cpu")
    kinds: dict = {}
    for _, k, _ in card["events"]:
        kinds[k] = kinds.get(k, 0) + 1
    same = card == host
    log(f"[server-parity] 2 paged pipelines, cost dispatch, KV migration, "
        f"budgeted store: tokens+events identical={same} events {kinds} "
        f"evicted {card['evicted']} clock {card['clock']:.6f} s (virtual)")
    need = PATHS["server"][2]
    if str(dev) != "cpu" and not all(ran.get(k) for k in need):
        raise SystemExit(f"chip_smoke: the server scenario launched {ran}, "
                         f"needs {need}")
    if not (same and card["ok"] and card["attached"] and card["evicted"]
            and card["store"][2]
            and not [k for k in card["store"][0] if k[0] == "__kv__"]):
        raise SystemExit(f"chip_smoke: server scenario failed: card "
                         f"{card} cpu {host}")


def server_prefix_scenario(cfg, params, dev) -> dict:
    """tests/test_kv_prefix.py's warm-up scenario on ``dev``: a GlobalServer
    with ``use_prefix_share=True`` serves 10 prompts opening with one of
    two 12-token system prompts (the first drawn 4 times in 5) on one
    paged pipeline, publishing the hot prefixes to the store; a second
    pipeline is added (it warms from the store), the first one's instance
    is interrupted (its rebuild warms again), and a first-contact request
    on the new pipeline maps the warmed blocks. Returns what must be
    identical on the card and the CPU."""
    rng = np.random.RandomState(3)
    heads = [rng.randint(1, cfg.vocab, 12).tolist() for _ in range(2)]
    reqs = [ServeRequest(prompt=heads[int(rng.rand() >= 0.8)]
                         + rng.randint(1, cfg.vocab, 4).tolist(),
                         max_new_tokens=4, rid=i) for i in range(10)]
    store = TensorStore()
    srv = GlobalServer(cfg, store, device=dev, max_batch=4, max_len=64,
                       engine_kw=dict(kv_layout="paged", block_size=4),
                       use_prefix_share=True, prefix_hot_hits=2)
    p0 = srv.add_pipeline(params, ["inst-A"])
    p0.queue.extend(reqs)
    srv.run_until_drained()
    p1 = srv.add_pipeline(params, ["inst-B"])
    srv.interrupt_instance("inst-A")
    probe = ServeRequest(prompt=heads[0] + [7, 9, 11, 13], max_new_tokens=3,
                         rid=100)
    p1.queue.append(probe)
    srv.run_until_drained()
    return dict(tokens=[list(r.generated) for r in reqs + [probe]],
                events=list(srv.events), clock=srv.clock,
                store=(store.keys(), sorted(store._bytes.items()),
                       store.resident_bytes(), store.check_consistent()),
                prefix=[(p.engine.stats.prefix_hits,
                         p.engine.stats.prefix_warmups,
                         p.engine.stats.cow_copies) for p in srv.pipelines],
                no_leak=all(p.engine.bm.check_no_leak()
                            for p in srv.pipelines))


def phase_server_prefix_parity(dev) -> None:
    """``server_prefix_scenario`` on the card and on the CPU, fp32:
    identical tokens, events, clock and store accounting, at least one
    prefix published and one warmed, the new pipeline's first-contact
    request served from warmed blocks, no leak."""
    cfg = get_config("qwen3-32b").reduced()
    cpu = build_model(cfg, device="cpu").init(seed=0)
    card = server_prefix_scenario(cfg, _tree_to(cpu, dev), dev)
    host = server_prefix_scenario(cfg, cpu, "cpu")
    kinds: dict = {}
    for _, k, _ in card["events"]:
        kinds[k] = kinds.get(k, 0) + 1
    same = card == host
    log(f"[server-parity] use_prefix_share: tokens+events+store identical="
        f"{same} events {kinds} (hits, warmups, cow) per pipeline "
        f"{card['prefix']} clock {card['clock']:.6f} s (virtual) store "
        f"bytes {card['store'][2]}")
    if not (same and kinds.get("prefix_publish") and kinds.get("prefix_warm")
            and card["prefix"][1][0] >= 1 and card["prefix"][1][1] >= 1
            and card["no_leak"] and card["store"][3]):
        raise SystemExit(f"chip_smoke: prefix server scenario failed: card "
                         f"{card} cpu {host}")


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# -- phase 5: full-width serving paths -------------------------------------------
def path_workload(path: str, depth: int, seed: int, rehearsal: bool):
    """A serving path's config, Engine keywords, a maker of its requests,
    the new tokens per request and the kernels it must launch.

    Every path but ``prefix`` serves the same traffic (prompt lengths and
    new tokens from ``seed``; prompt tokens from the config's vocab);
    ``prefix`` serves ``prefix_prompts``. A path's optional profile serves
    exactly its traffic too."""
    arch, layout, required = PATHS[path]
    if rehearsal:
        cfg = get_config(arch).reduced()
        n_req, lo, hi, chunk, max_len, new = 6, 4, 40, 8, 64, 4
    else:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        n_req, lo, hi, chunk, max_len, new = 16, 64, 2048, 512, MAX_LEN, 32
        if path == "danube":
            lo, hi, max_len = 2048, 6000, DANUBE_LEN
    eng_kw = dict(max_batch=8, max_len=max_len, prefill_chunk=chunk,
                  block_size=16, kv_layout=layout,
                  **PATH_KW.get(path, {}))
    rng = np.random.RandomState(seed)
    if path == "prefix":
        prompts = prefix_prompts(
            rng, cfg.vocab, (5, 20, 16, 25) if rehearsal else PREFIX_SYSTEM,
            *((2, 6, 60) if rehearsal else (64, 512, 2048)), chunk,
            eng_kw["block_size"])
    elif path == "danube":
        # 2048-6000 tokens, the first half past the window (at least half
        # of the traffic is), the longest first
        lens = rng.randint(lo, hi + 1, n_req)
        past = cfg.swa_window + 1
        lens[:n_req // 2] = rng.randint(past, hi + 1, n_req // 2)
        lens[0] = hi
        prompts = [rng.randint(0, cfg.vocab, int(n)).tolist() for n in lens]
    else:
        lens = rng.randint(lo, hi + 1, n_req)
        # both admission paths run (MoE admits exact length, never
        # chunked): three prompts past prefill_chunk, three within it
        lens[:3] = [hi, (hi + chunk) // 2 + 1, chunk + 1]
        lens[3:6] = rng.randint(lo, chunk + 1, 3)
        prompts = [rng.randint(0, cfg.vocab, int(n)).tolist() for n in lens]

    def make_requests():
        return [ServeRequest(prompt=list(p), max_new_tokens=new)
                for p in prompts]
    return cfg, eng_kw, make_requests, new, required


def prefix_prompts(rng, vocab, system, lo, hi, max_prompt, chunk, bs) -> list:
    """Shared-system-prompt chat traffic: one four-turn conversation per
    system prompt, request k of a conversation being its system prompt
    and user turns 1..k (``lo``-``hi`` tokens each, distinct, drawn from
    ``rng``), at most ``max_prompt`` tokens, ordered turn by turn. Each
    request extends its predecessor's whole prompt, and no prompt ends on
    a block boundary, so every continuation shares its predecessor's full
    blocks and copies its partial last block on write, at a suffix base
    unaligned with the blocks. The first conversation's first request
    fits ``chunk`` (it prefills in a group, pre-indexed, and its
    successor in the same admission call takes the deferred copy); the
    longer first turns prefill chunked and are shared once finished."""
    convs = []
    for i, n in enumerate(system):
        toks = rng.randint(0, vocab, n).tolist()
        conv = []
        for k in range(4):
            cap = min(hi, max_prompt - len(toks) - lo * (3 - k))
            if i == k == 0:
                cap = min(cap, chunk - len(toks))
            m = int(rng.randint(lo, cap + 1))
            if (len(toks) + m) % bs == 0:
                m += 1 if m < cap else -1
            toks = toks + rng.randint(0, vocab, m).tolist()
            conv.append(list(toks))
        convs.append(conv)
    return [conv[k] for k in range(4) for conv in convs]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _watch_logits(eng, finite: list) -> None:
    """Append, for every logits call of ``eng``'s model, whether all its
    values are finite (a device tensor, read once at the end)."""
    logits_fn = eng.model.logits

    def checked_logits(p, x):
        out = logits_fn(p, x)
        finite.append(torch.isfinite(out).all())
        return out
    eng.model.logits = checked_logits


def _count_deferred_cows(eng, box: dict) -> None:
    """Count, in ``box["deferred_cow"]``, the copy-on-writes ``eng`` defers
    to a suffix dispatch (its donor admitted in the same call)."""
    suffix = eng._admit_group_suffix

    def counted(items, blen):
        box["deferred_cow"] += sum(1 for it in items if it[4] is not None)
        return suffix(items, blen)
    box["deferred_cow"] = 0
    eng._admit_group_suffix = counted


def _timed_run(cfg, params, dev, eng_kw, reqs, new, required) -> dict:
    """Serve ``reqs`` on a fresh Engine; launch counts are zeroed just
    before and read just after. Fails unless every request finished with
    its token count and finite logits, and every kernel in ``required``
    launched. Returns the host times, launches, counters, tokens, the
    pool's end state and the deferred copy-on-writes."""
    eng = Engine(cfg, params, device=dev, **eng_kw)
    finite, box = [], {}
    _watch_logits(eng, finite)
    _count_deferred_cows(eng, box)
    timing = dict(admit_s=0.0, step_s=0.0, steps=0)
    ops.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    _serve(eng, reqs, timing)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    all_finite = bool(torch.stack(finite).all())
    done = all(r.done and len(r.generated) == new for r in reqs)
    if not (done and all_finite):
        raise SystemExit(f"chip_smoke: {cfg.name} path did not finish every "
                         f"request with finite logits")
    missing = [k for k in required if not counts[k]]
    if dev.type == "cuda" and missing:
        raise SystemExit(f"chip_smoke: {missing} never launched on the "
                         f"{cfg.name} path: {counts}")
    return dict(timing, wall=wall, counts=counts, layout=eng.kv_layout,
                stats=dataclasses.asdict(eng.stats),
                tokens=[list(r.generated) for r in reqs],
                blocks=eng.block_stats(),
                no_leak=eng.bm is None or eng.bm.check_no_leak(), **box)


def phase_path(dev, path: str, depth: int, seed: int, rehearsal: bool,
               repeats: int, profile_dir: Path | None = None) -> dict:
    cfg, eng_kw, make_requests, new, required = path_workload(
        path, depth, seed, rehearsal)
    tag = f"[{path}]"
    model = build_model(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(seed=seed)
    warm = Engine(cfg, params, device=dev, **eng_kw)
    _sync(dev)
    param_gb = model.param_count() * model.dtype.itemsize / 1e9
    cache = {k: t for k, t in warm.cache.items() if k != "pos"}
    cache_gb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e9
    log(f"{tag} {cfg.name} widths, {cfg.n_layers} of "
        f"{get_config(cfg.name).n_layers} layers, "
        f"{model.param_count() / 1e9:.3f} B params ({param_gb:.3f} GB "
        f"{cfg.dtype}), {warm.kv_layout} cache {sorted(cache)} "
        f"{cache_gb:.3f} GB, init {time.perf_counter() - t0:.1f} s")
    # warm-up: one untimed pass of the same traffic, so the timed runs do
    # not pay for first-use cuBLAS setup, allocator growth or first launches
    t0 = time.perf_counter()
    _serve(warm, make_requests())
    del warm, cache
    _sync(dev)
    log(f"{tag} warm-up pass (untimed workload) "
        f"{time.perf_counter() - t0:.3f} s")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(repeats):
        reqs = make_requests()
        r = _timed_run(cfg, params, dev, eng_kw, reqs, new, required)
        runs.append(r)
        st = r["stats"]
        step_tokens = st["tokens_out"] - st["prefills"]
        log(f"{tag} run {i}: wall_s={r['wall']:.3f} "
            f"admit_s={r['admit_s']:.3f} step_s={r['step_s']:.3f} "
            f"steps={r['steps']} out_tok_per_s={st['tokens_out'] / r['wall']:.2f}"
            f" step_tok_per_s={step_tokens / max(r['step_s'], 1e-9):.2f}")
    lens = np.array([len(p.prompt) for p in make_requests()])
    st = runs[0]["stats"]
    walls = sorted(r["wall"] for r in runs)
    wall = float(np.median(walls))
    log(f"{tag} requests={len(lens)} prompt_tokens={int(lens.sum())} "
        f"(min {int(lens.min())}, max {int(lens.max())}) "
        f"tokens_out={st['tokens_out']} per run; {repeats} warm runs, "
        f"wall_s median={wall:.3f} min={walls[0]:.3f} max={walls[-1]:.3f}")
    log(f"{tag} out_tok_per_s median={st['tokens_out'] / wall:.2f} "
        f"(step_tok_per_s: tokens emitted by step() over the time spent "
        f"in step())")
    if dev.type == "cuda":
        log(f"{tag} peak_mem_GB="
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    log(f"{tag} stats {st}")
    log(f"{tag} launches per run {[r['counts'] for r in runs]} "
        f"required={list(required)} all_finite=True all_done=True")
    admit_s = float(np.median([r["admit_s"] for r in runs]))
    if path == "prefix":
        prefix_checks(cfg, params, dev, eng_kw, make_requests, new, runs,
                      tag)
    if path == "danube":
        danube_ring(model, params, dev, rehearsal, seed, tag)
    if profile_dir is not None:
        reqs = make_requests()
        eng = Engine(cfg, params, device=dev, **eng_kw)
        phase_profile(path, lambda: _serve(eng, reqs), dev, wall,
                      profile_dir)
        del eng
    del params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(counts=runs[0]["counts"], tokens=runs[0]["tokens"],
                admit_s=admit_s, stats=st)


def danube_ring(model, params, dev, rehearsal: bool, seed: int,
                tag: str) -> None:
    """One generation through the ring (sliding-window) cache: 2 rows of a
    6000-token prompt, ``prefill(ring=True)`` (flash under the 4096
    window; the prompt's last 4096 positions laid out in the ring), then
    32 greedy steps through the ring decode route (the contiguous decode
    kernel at ``min(pos, 4095)``); it must launch flash and the contiguous
    decode kernel. The linear cache (``ring=False``) is fed the same
    tokens: the per-step logit difference and the share of equal greedy
    tokens are printed (bf16: not gated)."""
    b, s, new = (2, 20, 4) if rehearsal else DANUBE_RING
    gen = torch.Generator().manual_seed(seed + 7)
    toks = torch.randint(0, model.cfg.vocab, (b, s), generator=gen).to(dev)
    ops.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=s + new,
                                  ring=True)
    seq, ring_logits = [], []
    for _ in range(new):
        ring_logits.append(logits.reshape(b, -1).float())
        seq.append(model.sample_greedy(ring_logits[-1]))
        logits, cache = model.decode_step(params, cache, seq[-1][:, None])
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    slots = cache["k"].shape[2]
    del cache
    missing = [k for k in ("flash_attention", "decode_attention")
               if not counts[k]]
    if dev.type == "cuda" and missing:
        raise SystemExit(f"chip_smoke: the danube ring generation never "
                         f"launched {missing}: {counts}")
    logits, cache = model.prefill(params, {"tokens": toks}, max_len=s + new)
    diffs, equal = [], 0
    for i in range(new):
        lin = logits.reshape(b, -1).float()
        diffs.append((lin - ring_logits[i]).abs().max().item())
        equal += int((model.sample_greedy(lin) == seq[i]).sum())
        logits, cache = model.decode_step(params, cache, seq[i][:, None])
    del cache
    log(f"{tag} ring generation: {b} rows x {s} prompt tokens, {new} greedy "
        f"steps, ring of {slots} slots, wall_s={wall:.3f}, launches "
        f"{counts}")
    log(f"{tag} ring vs linear (same tokens fed): max |logit diff| per step "
        f"{[float(f'{d:.4g}') for d in diffs]}; equal greedy tokens "
        f"{equal}/{b * new}")


def prefix_checks(cfg, params, dev, eng_kw, make_requests, new, runs,
                  tag) -> None:
    """The prefix path's own checks: every timed run shared prefixes
    (hits, shared tokens, copy-on-writes, a deferred one among them) and
    gave every pool block back (no leak); the same traffic without
    sharing, timed the same way in the same call (its admit_s, and the
    share of equal tokens: bf16 rounds differently in other batch and
    kernel compositions); and the scheduler's counters, which depend on
    token ids and counts only, equal to the same traffic through the
    port's engine on the CPU at a reduced width (one layer, 4/2 heads of
    16, the full vocab)."""
    for i, r in enumerate(runs):
        st, bl = r["stats"], r["blocks"]
        ok = (st["prefix_hits"] > 0 and st["prefix_shared_tokens"] > 0
              and st["cow_copies"] > 0 and r["deferred_cow"] > 0
              and r["no_leak"] and bl["blocks_in_use"] == 0
              and bl["blocks_free"] == bl["n_blocks"] - 1)
        log(f"{tag} run {i}: prefix_hits={st['prefix_hits']} "
            f"prefix_shared_tokens={st['prefix_shared_tokens']} "
            f"cow_copies={st['cow_copies']} (deferred "
            f"{r['deferred_cow']}) blocks_free={bl['blocks_free']} of "
            f"{bl['n_blocks'] - 1} no_leak={r['no_leak']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the prefix path did not share, "
                             f"copy or give its blocks back: {st} {bl}")
    off_kw = dict(eng_kw, prefix_share=False)
    off = [_timed_run(cfg, params, dev, off_kw, make_requests(), new, ())
           for _ in runs]
    pairs = [(a, b) for ta, tb in zip(runs[0]["tokens"], off[0]["tokens"])
             for a, b in zip(ta, tb)]
    equal = sum(a == b for a, b in pairs)
    prompt = sum(len(r.prompt) for r in make_requests())
    med = {key: (float(np.median([r[key] for r in runs])),
                 float(np.median([r[key] for r in off])))
           for key in ("admit_s", "step_s", "wall")}
    log(f"{tag} same traffic, prefix_share=False, same call, medians "
        f"(sharing on, off): " + " ".join(
            f"{key}=({on:.3f}, {of:.3f})" for key, (on, of) in med.items())
        + f"; prompt tokens {prompt}, prefilled with sharing "
        f"{prompt - runs[0]['stats']['prefix_shared_tokens']}; chunk "
        f"dispatches ({runs[0]['stats']['prefill_chunks']}, "
        f"{off[0]['stats']['prefill_chunks']}); equal tokens "
        f"{equal}/{len(pairs)} = {equal / len(pairs):.3f}")
    small = dataclasses.replace(get_config(cfg.name).reduced(),
                                vocab=cfg.vocab, n_layers=1)
    host = Engine(small, build_model(small, device="cpu").init(seed=0),
                  device="cpu", **eng_kw)
    t0 = time.perf_counter()
    _serve(host, make_requests())
    same = dataclasses.asdict(host.stats) == runs[0]["stats"]
    log(f"{tag} scheduler counters == the port's engine on the CPU at "
        f"{small.d_model} wide, {small.n_layers} layer: {same} "
        f"({time.perf_counter() - t0:.1f} s host)")
    if not same:
        raise SystemExit(f"chip_smoke: prefix path counters "
                         f"{runs[0]['stats']} differ from the CPU run's "
                         f"{dataclasses.asdict(host.stats)}")


# -- phase 5, path "server": the GlobalServer over three pipelines ---------------
SERVER_INTERRUPT_ROUND = 8


def paper_plan() -> tuple:
    """(model spec, plan): the port's paper-cluster plan for the whole
    qwen3-32b (``populate_cluster``, beam_k=1, the paper's derated
    instances)."""
    spec = get_config("qwen3-32b").to_modelspec()
    insts = {n: dataclasses.replace(i, device=effective(i.device))
             for n, i in AWS_INSTANCES.items()}
    return spec, populate_cluster(spec, paper_cluster(), insts, 763, 232,
                                  beam_k=1)


def server_placements() -> list:
    """The first three pipelines of ``paper_plan``; when those three use
    one instance type, the third is swapped for the first later pipeline
    that adds one."""
    plan = paper_plan()[1]

    def kinds(pls):
        return {st.instance.name for p in pls for st in p.stages}
    pls = list(plan.pipelines[:3])
    if len(kinds(pls)) < 2:
        other = next((p for p in plan.pipelines[3:]
                      if kinds([p]) - kinds(pls)), None)
        if other is not None:
            pls[-1] = other
    return pls


def drive_server(srv, reqs, dev, finite: list,
                 at: int = SERVER_INTERRUPT_ROUND) -> dict:
    """Submit every request at once, then step and tick the server until
    it drains; after ``at`` rounds, interrupt the first instance of the
    pipeline with the most live requests. Times the engine
    rebuild inside ``interrupt_instance`` on the device and counts every
    dispatch, re-dispatches after the interrupt included."""
    info = dict(dispatched=[0] * len(srv.pipelines), interrupt=None)
    submit, build = srv.submit, srv._build_engine

    def counted(r):
        p = submit(r)
        if p is not None:
            info["dispatched"][p.pid] += 1
        return p

    def timed_build(*a, **kw):
        _sync(dev)
        t0 = time.perf_counter()
        eng = build(*a, **kw)
        _sync(dev)
        info["rebuild_s"] = time.perf_counter() - t0
        _watch_logits(eng, finite)
        return eng
    srv.submit = counted
    for r in reqs:
        srv.submit(r)
    rounds = 0
    while srv.pending():
        if rounds == at:
            victim = max(srv.pipelines, key=lambda p: len(p.engine.active()))
            inst = victim.instance_ids[0]
            srv._build_engine = timed_build
            affected = srv.interrupt_instance(inst)
            srv._build_engine = build
            info["snap"] = {r.rid: list(r.generated) for r in affected}
            info["interrupt"] = (victim.pid, inst, len(affected))
            info["resident_bytes"] = srv.store.resident_bytes()
        srv.step()
        srv.tick()
        rounds += 1
    info["rounds"] = rounds
    return info


def phase_server_path(dev, path: str, depth: int, seed: int,
                      rehearsal: bool, repeats: int,
                      profile_dir: Path | None = None) -> tuple:
    """The seventh serving path: main's model, weights and traffic through
    a ``GlobalServer`` (cost dispatch, KV migration) over three paged
    pipelines that carry the plan's placements, sharing one set of weights
    through a ``TensorStore``, with one spot interruption. Every run is a
    fresh server over the same attached weights. The pools are sized for
    every slot's worst case, so no pool preemption prices a victim."""
    cfg, eng_kw, make_requests, new, required = path_workload(
        path, depth, seed, rehearsal)
    tag = f"[{path}]"
    at = 2 if rehearsal else SERVER_INTERRUPT_ROUND     # 4 new tokens there
    srv_kw = dict(max_batch=eng_kw.pop("max_batch"),
                  max_len=eng_kw.pop("max_len"),
                  prefill_chunk=eng_kw.pop("prefill_chunk"),
                  dispatch="cost", use_kv_migration=True, engine_kw=eng_kw)
    t0 = time.perf_counter()
    pls = server_placements()
    log(f"{tag} plan (port's populate_cluster, qwen3-32b, paper cluster, "
        f"{time.perf_counter() - t0:.1f} s host): "
        f"{[p.describe() for p in pls]}")
    model = build_model(cfg, device=dev)
    params = model.init(seed=seed)
    _sync(dev)

    def build():
        srv = GlobalServer(cfg, TensorStore(), device=dev, **srv_kw)
        for i, pl in enumerate(pls):
            srv.add_pipeline(params, [f"{st.instance.name}/{i}.{j}"
                                      for j, st in enumerate(pl.stages)],
                             placement=pl)
        return srv

    def run() -> dict:
        srv, reqs, finite = build(), make_requests(), []
        for p in srv.pipelines:
            _watch_logits(p.engine, finite)
        ops.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        info = drive_server(srv, reqs, dev, finite, at)
        _sync(dev)
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        kinds: dict = {}
        for _, k, _ in srv.events:
            kinds[k] = kinds.get(k, 0) + 1
        by_rid = {r.rid: r for r in reqs}
        if info["interrupt"] is None:
            raise SystemExit(f"chip_smoke: the server drained before round "
                             f"{at}; nothing was interrupted")
        checks = {
            "done": all(r.done and len(r.generated) == new for r in reqs),
            "finite": bool(torch.stack(finite).all()),
            "migrated_kept": all(by_rid[rid].generated[:len(t)] == t
                                 for rid, t in info["snap"].items()),
            "kv_publish_and_attach": bool(kinds.get("kv_publish")
                                          and kinds.get("kv_attach")),
            "store_consistent": srv.store.check_consistent(),
            "no_kv_left": not srv.store.keys("__kv__"),
            "launched": dev.type != "cuda" or all(counts[k]
                                                  for k in required)}
        if not all(checks.values()):
            raise SystemExit(f"chip_smoke: server path failed {checks}: "
                             f"launches {counts}, events {kinds}")
        return dict(info, wall=wall, counts=counts, kinds=kinds,
                    clock=srv.clock,
                    round_s=[float(p.round_s) for p in srv.pipelines],
                    tokens_out=sum(len(r.generated) for r in reqs),
                    tokens=[list(r.generated) for r in reqs])

    t0 = time.perf_counter()
    run()
    log(f"{tag} {cfg.name} widths, {cfg.n_layers} of "
        f"{get_config(cfg.name).n_layers} layers, {len(pls)} pipelines on "
        f"one set of weights; warm-up pass (untimed workload) "
        f"{time.perf_counter() - t0:.3f} s")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    runs = []
    for i in range(repeats):
        r = run()
        runs.append(r)
        log(f"{tag} run {i}: wall_s={r['wall']:.3f} "
            f"out_tok_per_s={r['tokens_out'] / r['wall']:.2f} "
            f"rounds={r['rounds']} virtual_clock_s={r['clock']:.6f} "
            f"round_s={r['round_s']} events={r['kinds']} "
            f"interrupt(pid, instance, requests)={r['interrupt']} "
            f"store_resident_bytes_at_interrupt={r['resident_bytes']} "
            f"engine_rebuild_s={r['rebuild_s']:.4f} "
            f"dispatched={r['dispatched']}")
        gc.collect()
    walls = sorted(r["wall"] for r in runs)
    wall = float(np.median(walls))
    log(f"{tag} wall_s median={wall:.3f} min={walls[0]:.3f} "
        f"max={walls[-1]:.3f}; out_tok_per_s median="
        f"{runs[0]['tokens_out'] / wall:.2f} (wall, one card) against "
        f"the virtual clock's {runs[0]['tokens_out'] / runs[0]['clock']:.2f}"
        f" (estimated round_s of the modelled cluster)")
    if dev.type == "cuda":
        log(f"{tag} peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}"
            f"; nvidia-smi: {smi_line()}")
    log(f"{tag} launches per run {[r['counts'] for r in runs]} "
        f"required={list(required)}; every check passed")
    if profile_dir is not None:
        srv, reqs = build(), make_requests()
        phase_profile(path, lambda: drive_server(srv, reqs, dev, [], at),
                      dev, wall, profile_dir)
        del srv
    del params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(counts=runs[0]["counts"], tokens=runs[0]["tokens"])


# -- the pipeline-parallel serve step (path ``pp``) --------------------------------
# stage layouts: (name, pod_flops, n_microbatches or None for the
# reference's choice); at 8 of Qwen3-32B's layers, 8 rows and S 2080 the
# split comes out [5, 3] (m 4) and [4, 3, 1] (a one-layer stage)
PP_LAYOUTS = (("2 stages", [1.0, 0.5], None),
              ("3 stages", [1.0, 0.6, 0.35], 4))
# the pp path's fp8 run: the first layout on a float8_e4m3fn cache
PP_FP8 = ("2 stages, float8_e4m3fn cache", [1.0, 0.5], None,
          "float8_e4m3fn")
PP_ROWS, PP_PROMPT, PP_STEPS = 8, 1024, 8


def pp_layout_kv(full: torch.Tensor, split, m: int) -> torch.Tensor:
    """The unsplit prefill's contiguous K or V (L, b, S, nkv, d) laid into
    the PP step's layout (n_stages, lmax, m, b // m, S, nkv, d): stage s
    slot j holds layer sum(split[:s]) + j, microbatch i rows i*mb.. of it;
    padded slots are zero (an fp8 cache is laid out as its bytes)."""
    if full.dtype in FP8_DTYPES.values():
        return pp_layout_kv(full.view(torch.uint8), split, m).view(
            full.dtype)
    L, b = full.shape[:2]
    out = full.new_zeros((len(split), max(split), m, b // m)
                         + tuple(full.shape[2:]))
    off = 0
    for s, n in enumerate(split):
        out[s, :n] = full[off:off + n].reshape(
            (n, m, b // m) + tuple(full.shape[2:]))
        off += n
    assert off == L, (split, L)
    return out


def pp_unsplit_reference(model, params, full, first, m, steps) -> tuple:
    """The unsplit ``LM.decode_step`` on each microbatch's rows in turn
    (the PP step's GEMM shapes), ``steps`` greedy steps from the prefill:
    (tokens (b, steps), the last step's logits (b, 1, Vpad))."""
    b = first.shape[0]
    mb = b // m
    toks, last = [], []
    for i in range(m):
        rows = slice(i * mb, (i + 1) * mb)
        cache = {"k": full["k"][:, rows].clone(),
                 "v": full["v"][:, rows].clone(),
                 "pos": full["pos"][rows].clone()}
        cur, seq = first[rows], []
        for _ in range(steps):
            logits, cache = model.decode_step(params, cache, cur)
            cur = model.sample_greedy(logits).reshape(mb, 1)
            seq.append(cur)
        toks.append(torch.cat(seq, 1))
        last.append(logits)
        del cache
    return torch.cat(toks), torch.cat(last)


def _busy_s(fn, dev) -> tuple:
    """(device busy seconds, wall seconds) of ``fn()`` under
    torch.profiler: the device-side kernel and memcpy time (device
    activity only: recording every host op would slow the host-bound
    run it measures)."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    busy = 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dt = getattr(evt, "self_device_time_total", None)
            busy += evt.self_cuda_time_total if dt is None else dt
    if busy <= 0:
        raise SystemExit("chip_smoke: torch.profiler recorded no device "
                         "time")
    return busy / 1e6, wall


def phase_pp_path(dev, path: str, depth: int, seed: int, rehearsal: bool,
                  repeats: int, profile_dir: Path | None = None) -> dict:
    """The paper's pipeline-parallel serve step (``launch/pipeline.py``):
    Qwen3-32B widths at ``depth`` layers, bf16, random weights; 8 rows of
    one 1024-token prompt length prefilled by the unsplit ``LM.prefill``
    (contiguous cache of ``MAX_LEN``), their K/V laid into the PP layout,
    then ``PP_STEPS`` greedy PP steps for each of ``PP_LAYOUTS``, every
    stage on this card, and for ``PP_FP8`` (the first split with
    ``kv_cache_dtype="float8_e4m3fn"``: the prefill's K/V cast by
    ``astype``). Gate: the tokens equal the unsplit ``LM.decode_step``
    run one microbatch at a time on the same card (the same GEMM shapes;
    on the same fp8 cache for ``PP_FP8``), every logit finite; each step
    launches ``decode_attention`` m x sum(split) times (``PP_FP8``: every
    one on the fp8 cache). The layouts' ``repeats``
    timed runs alternate (a b, b a, a b, ...), each on freshly packed
    params and a fresh cache. Prints per layout the split, m, ticks per
    step, the median wall per step, tok/s, the device-busy share
    (torch.profiler), launches per step and the peak GB of its runs."""
    arch = PATHS[path][0]
    required = PATHS[path][2]
    tag = f"[{path}]"
    if rehearsal:
        cfg = get_config(arch).reduced()
        rows, prompt_len, steps, s_max = PP_ROWS, 6, 4, 16
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        rows, prompt_len, steps, s_max = PP_ROWS, PP_PROMPT, PP_STEPS, MAX_LEN
    model = build_model(cfg, device=dev)
    params = model.init(seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (rows, prompt_len), generator=gen,
                           device=dev)
    logits, full = model.prefill(params, {"tokens": prompt}, max_len=s_max)
    first = model.sample_greedy(logits).reshape(rows, 1)
    _sync(dev)
    log(f"{tag} {cfg.name} widths, {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, {model.param_count() / 1e9:.3f}"
        f" B params {cfg.dtype}; {rows} rows of a {prompt_len}-token prompt "
        f"prefilled by the unsplit LM.prefill, cache S={s_max}; "
        f"{steps} PP steps per run")
    # the unsplit decode's (tokens, logits) by (m, cache dtype)
    refs: dict = {}
    fulls = {None: full}
    layouts = []
    for name, flops, n_micro, *kv in PP_LAYOUTS + (PP_FP8,):
        kv = kv[0] if kv else None
        if kv not in fulls:
            fulls[kv] = {k: astype(v, FP8_DTYPES[kv]) if k in ("k", "v")
                         else v for k, v in full.items()}
        step, meta = build_pp_serve_step(
            cfg, ShapeSpec("pp", s_max, rows, "serve_step"), len(flops),
            devices=[dev] * len(flops), n_microbatches=n_micro,
            pod_flops=flops, kv_cache_dtype=kv)
        m = meta["n_microbatches"]
        if (m, kv) not in refs:
            refs[m, kv] = pp_unsplit_reference(model, params, fulls[kv],
                                               first, m, steps)
        seen: list = []
        head = meta["model"].logits
        meta["model"].logits = lambda p, x, head=head, seen=seen: (
            seen.append(head(p, x)) or seen[-1])
        layouts.append(dict(name=name, flops=flops, step=step, m=m, kv=kv,
                            split=meta["pp_split"], seen=seen, runs=[],
                            queued=[], peak=0.0))

    def run(lay: dict) -> tuple:
        split, m = lay["split"], lay["m"]
        packed = pack_pp_params(params, split)
        kvs = fulls[lay["kv"]]
        cache = {"k": pp_layout_kv(kvs["k"], split, m),
                 "v": pp_layout_kv(kvs["v"], split, m),
                 "pos": torch.tensor(prompt_len, dtype=torch.int32,
                                     device=dev)}
        cur, out = first, []
        lay["seen"].clear()
        ops.reset_launch_counts()
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(steps):
            cur, cache = lay["step"](packed, cache, cur)
            out.append(cur)
        queued = time.perf_counter() - t0
        _sync(dev)
        wall = time.perf_counter() - t0
        if dev.type == "cuda":
            lay["peak"] = max(lay["peak"],
                              torch.cuda.max_memory_allocated() / 1e9)
        lay["queued"].append(queued)
        lay["by_cache_dtype"] = ops.decode_launches_by_cache_dtype()
        return wall, ops.launch_counts(), torch.cat(out, 1)

    # the gate run doubles as each layout's warm-up
    for lay in layouts:
        _, _, got = run(lay)
        ref_toks, ref_logits = refs[lay["m"], lay["kv"]]
        seen, m = lay["seen"], lay["m"]
        finite = bool(torch.stack([torch.isfinite(x).all()
                                   for x in seen]).all())
        same = torch.equal(got.long(), ref_toks.long())
        dlog = (torch.cat(seen[-m:]).float()
                - ref_logits.float()).abs().max().item()
        lay["tokens"] = got.tolist()
        log(f"{tag} {lay['name']}: pod_flops={lay['flops']} split="
            f"{lay['split']} m={m} mb={rows // m} ticks_per_step="
            f"{m + len(lay['split']) - 1}; tokens over {steps} steps equal "
            f"to the unsplit decode (one microbatch at a time): {same}; last "
            f"step's logits max |diff| {dlog:.3e}; all logits finite "
            f"{finite}")
        if not (same and finite):
            raise SystemExit(f"chip_smoke: the PP step ({lay['name']}, "
                             f"split {lay['split']}) disagrees with the "
                             f"unsplit decode")
    for r in range(repeats):
        for lay in (layouts if r % 2 == 0 else layouts[::-1]):
            lay["runs"].append(run(lay))
    counts: dict = {}
    by_dtype: dict = {}
    for lay in layouts:
        m, split, runs = lay["m"], lay["split"], lay["runs"]
        want = steps * m * sum(split)
        launched = runs[0][1]["decode_attention"]
        kv_name = lay["kv"] or "bfloat16"
        if dev.type == "cuda" and (launched != want or any(
                not runs[0][1][k] for k in required)
                or lay["by_cache_dtype"] != {kv_name: want}):
            raise SystemExit(f"chip_smoke: the PP step launched "
                             f"decode_attention {launched} times in "
                             f"{steps} steps, not {want}, or not all on "
                             f"its {kv_name} cache: {runs[0][1]}, "
                             f"{lay['by_cache_dtype']}")
        for k, v in lay["by_cache_dtype"].items():
            by_dtype[k] = by_dtype.get(k, 0) + v
        walls = sorted(w / steps for w, _, _ in runs)
        per_step = float(np.median(walls))
        # the host's seconds to queue a step (each run starts drained)
        queued = float(np.median(lay["queued"][-repeats:])) / steps
        busy = peak = "not measured (CPU)"
        if dev.type == "cuda":
            peak = f"{lay['peak']:.3f}"
            busy_s, wall_s = _busy_s(lambda: run(lay), dev)
            busy = (f"{busy_s / (per_step * steps):.3f} ({busy_s:.4f} s "
                    f"of device time in a run; against the profiled run's "
                    f"{wall_s:.3f} s wall {busy_s / wall_s:.3f})")
        log(f"{tag} {lay['name']}: step_wall_s median={per_step:.5f} min="
            f"{walls[0]:.5f} max={walls[-1]:.5f} over {repeats} runs of "
            f"{steps} steps (layouts in turns); host_queue_s per step "
            f"median={queued:.5f}; out_tok_per_s={rows / per_step:.2f}; "
            f"device_busy_share={busy}; "
            f"decode_attention launches per step {launched / steps:g} (m x "
            f"sum(split) = {m * sum(split)}), by cache dtype a run "
            f"{lay['by_cache_dtype']}; launches per run {runs[0][1]}; "
            f"peak_mem_GB={peak}")
        for k, v in runs[0][1].items():
            counts[k] = counts.get(k, 0) + v
    if dev.type == "cuda":
        log(f"{tag} nvidia-smi: {smi_line()}")
    tokens = [lay["tokens"] for lay in layouts]
    del params, model, full, fulls, layouts, refs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(counts=counts, tokens=tokens, by_cache_dtype=by_dtype)


def phase_pp_parity(dev) -> None:
    """The PP step in fp32 at the reduced qwen3-32b: both stage layouts'
    tokens over 4 steps on the card equal the same run on the CPU (and the
    unsplit decode's); the card's steps launch ``decode_attention``."""
    cfg = get_config("qwen3-32b").reduced()
    params = build_model(cfg, device="cpu").init(seed=0)
    prompt = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab, (PP_ROWS, 6)))
    for name, flops, n_micro in PP_LAYOUTS:
        out = {}
        for where in (dev, torch.device("cpu")):
            model = build_model(cfg, device=where)
            p = _tree_to(params, where)
            logits, full = model.prefill(p, {"tokens": prompt.to(where)},
                                         max_len=16)
            first = model.sample_greedy(logits).reshape(PP_ROWS, 1)
            step, meta = build_pp_serve_step(
                cfg, ShapeSpec("pp", 16, PP_ROWS, "serve_step"), len(flops),
                devices=[where] * len(flops), n_microbatches=n_micro,
                pod_flops=flops)
            split, m = meta["pp_split"], meta["n_microbatches"]
            cache = {"k": pp_layout_kv(full["k"], split, m),
                     "v": pp_layout_kv(full["v"], split, m),
                     "pos": torch.tensor(6, dtype=torch.int32, device=where)}
            packed, cur, seq = pack_pp_params(p, split), first, []
            ops.reset_launch_counts()
            for _ in range(4):
                cur, cache = step(packed, cache, cur)
                seq.append(cur.cpu())
            launches = ops.launch_counts()["decode_attention"]
            ref, _ = pp_unsplit_reference(model, p, full, first, m, 4)
            out[where.type] = (torch.cat(seq, 1), ref.cpu(), launches)
        card, host = out[dev.type], out["cpu"]
        ok = (torch.equal(card[0], host[0]) and torch.equal(card[0].long(),
                                                            card[1].long())
              and (card[2] == 4 * m * sum(split) or dev.type != "cuda"))
        log(f"[pp-parity] {name}: split {split} m {m}, fp32 tokens card == "
            f"CPU {torch.equal(card[0], host[0])}, == unsplit decode "
            f"{torch.equal(card[0].long(), card[1].long())}; card "
            f"decode_attention launches {card[2]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: the fp32 PP step on the card "
                             f"disagrees with the CPU ({name})")


# -- tensor parallelism over a mesh of ranks (path ``tp``) ------------------------
# meshes run in turns, every rank on this card (gloo stages each all_reduce
# through the host); then (1, 4) over nccl, one rank per card, when there
# are four cards
TP_MESHES = ((1, 2), (1, 4), (2, 2))
TP_AXES = ("data", "model")
TP_ROWS, TP_PROMPT, TP_STEPS = 8, 1024, 8
TP_FP32_LAYERS = 2
# path tp's bf16 depth: below main's --layers, to keep the script in its
# time limit
TP_LAYERS = 4
# bf16 gates. Prefill: the ranks' last-position logits within TP_REL of max
# |logit| of the unsplit bf16 LM's. First serve step (on one cache and one
# set of tokens): its error against the unsplit LM evaluated in fp32 on the
# same values (the yardstick phase 3 holds a bf16 kernel to) at most
# TP_STEP_RATIO times the unsplit bf16 LM's own error there. A step is not
# held to TP_REL against the unsplit bf16 LM: that LM on its rows in two
# halves already differs from itself by about that much on this step
# (printed), while its prefill halves agree (PERF.md, tensor parallel).
TP_REL = 2e-2
TP_STEP_RATIO = 1.25


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _prefill_kw(cfg) -> dict:
    """``prefill``'s keywords as ``build_step``'s prefill step passes
    them: the ring cache for a decoder-only model."""
    return {} if cfg.is_encdec else {"ring": True}


def _on(inputs: dict, dev, rows=slice(None)) -> dict:
    """Numpy model inputs (their ``rows``) as tensors on ``dev``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(dev)
            for k, v in inputs.items()}


def tp_unsplit(cfg, dev, inputs: dict, steps: int, seed: int,
               max_len: int) -> dict:
    """The unsplit model on this card, the ranks' weights
    (``init(seed)``), on the prompt ``inputs`` (numpy): prefill logits and
    the greedy tokens (B, 1 + steps), on the host; its memory freed before
    the ranks start."""
    model = build_model(cfg, device=dev)
    params = model.init(seed=seed)
    with torch.no_grad():
        logits, cache = model.prefill(params, _on(inputs, dev),
                                      max_len=max_len, **_prefill_kw(cfg))
        cur = model.sample_greedy(logits).reshape(-1, 1).to(torch.int32)
        toks = [cur]
        for _ in range(steps):
            lg, cache = model.decode_step(params, cache, cur)
            cur = model.sample_greedy(lg).to(torch.int32)
            toks.append(cur)
    out = dict(prefill_logits=logits.float().cpu().numpy(),
               tokens=torch.cat(toks, 1).cpu().numpy())
    del model, params, cache, logits, lg
    _free(dev)
    return out


def tp_fp32_reference(cfg, dev, inputs: dict, seed: int,
                      max_len: int, kv_fp8: str | None = None) -> dict:
    """The yardstick of the bf16 gate, as phase 3 holds a bf16 kernel to
    its plain version evaluated in fp32 on the same input values: the
    unsplit ``LM`` in fp32 on the bf16 weights (``init(seed)`` upcast).
    Its prefill logits; a first serve step's input, its prefill cache as
    the bf16 cache stores it (k / v rounded to bf16) and its greedy
    tokens; that step's logits in fp32 on those values, and in bf16 by the
    unsplit bf16 ``LM`` (the unsplit model's own error, printed beside the
    ranks'). With ``kv_fp8``, the same step on that cache stored in fp8
    (the reference's rule: every K/V leaf), in fp32 on the fp8 values
    (``first8``) and by the unsplit bf16 ``LM`` reading the fp8 cache
    (``first16_8``). All on the host; the card's memory freed after. Any
    family: the recurrent ``ssd`` state stays fp32, as the bf16 model
    keeps it."""
    m16 = build_model(cfg, device=dev)
    p16 = m16.init(seed=seed)
    m32 = build_model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    p32 = _tree_map(p16, lambda t: t.float())
    kw = _prefill_kw(cfg)
    with torch.no_grad():
        logits, cache = m32.prefill(p32, _on(inputs, dev), max_len=max_len,
                                    **kw)
        tok = m32.sample_greedy(logits).reshape(-1, 1).to(torch.int32)
        cache_in = {k: v.to(m16.dtype)
                    if v.is_floating_point() and k != "ssd" else v
                    for k, v in cache.items()}
        del cache
        first32, _ = m32.decode_step(
            p32, {k: v.float() if v.is_floating_point() else v.clone()
                  for k, v in cache_in.items()}, tok)
        first16, _ = m16.decode_step(
            p16, {k: v.clone() for k, v in cache_in.items()}, tok)
        fp8 = {}
        if kv_fp8:
            c8 = {k: astype(v, FP8_DTYPES[kv_fp8]) if k in KV_KEYS else
                  v.clone() for k, v in cache_in.items()}
            f8, _ = m32.decode_step(p32, {k: v.float() if k in KV_KEYS
                                          else v.clone()
                                          for k, v in c8.items()}, tok)
            f16_8, _ = m16.decode_step(p16, c8, tok)
            fp8 = dict(first8=f8.float().cpu().numpy(),
                       first16_8=f16_8.float().cpu().numpy())
            del c8, f8, f16_8
        # the same unsplit bf16 LM on the rows in two halves: the same
        # function, other GEMM shapes (its own run-to-run floor)
        h = tok.shape[0] // 2
        halves, steps = [], []
        for rows in (slice(0, h), slice(h, None)):
            lg, _ = m16.prefill(p16, _on(inputs, dev, rows),
                                max_len=max_len, **kw)
            halves.append(lg.float().cpu())
            part = {k: v[rows].clone() if k == "pos" else v[:, rows].clone()
                    for k, v in cache_in.items()}
            st, _ = m16.decode_step(p16, part, tok[rows])
            steps.append(st.float().cpu())
    out = dict(prefill_logits=logits.float().cpu().numpy(),
               cache={k: v.cpu() for k, v in cache_in.items()},
               tokens=tok.cpu().numpy(), first=first32.float().cpu().numpy(),
               first16=first16.float().cpu().numpy(),
               halves=torch.cat(halves).numpy(),
               first16_halves=torch.cat(steps).numpy(), **fp8)
    del m16, p16, m32, p32, logits, cache_in, first32, first16
    _free(dev)
    return out


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| / max |b|."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _ulps(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| in bf16 units in the last place of max |b|."""
    top = max(float(np.abs(b).max()), 1e-30)
    return float(np.abs(a - b).max()) / 2.0 ** (np.floor(np.log2(top)) - 7)


def _tp_busy(fn, dev) -> tuple:
    """(device busy seconds, wall seconds) of ``fn()`` under a device-only
    torch.profiler pass."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = time.perf_counter() - t0
    busy = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dt = getattr(evt, "self_device_time_total", None)
            busy += evt.self_cuda_time_total if dt is None else dt
    return busy / 1e6, wall


def _tp_tokens32(mesh, dev, cfg, x, steps: int, max_len: int,
                 seed: int) -> np.ndarray:
    """The greedy tokens (B, 1 + steps) of this rank's prefill and serve
    steps of ``cfg`` from ``init(seed)``."""
    b = x["tokens"].shape[0]
    pre, srv, params = serving_steps(mesh, dev, cfg, b, max_len, seed=seed)
    tok, cache = pre.fn(params, x)
    cache = srv.store_cache(cache)
    cur = tok.reshape(b, 1)
    toks = [cur]
    for _ in range(steps):
        cur, cache = srv.fn(params, cache, cur)
        toks.append(cur)
    return torch.cat(toks, 1).cpu().numpy()


def tp_rank(mesh, dev, cfg32, cfg16, prompt: np.ndarray, steps: int,
            max_len: int, seed: int, forced: np.ndarray,
            first_step: tuple) -> dict:
    """One rank of path ``tp`` (``run_ranks`` calls it in every rank). fp32
    (``cfg32``): the greedy tokens. bf16 (``cfg16``): the prefill's
    last-position logits; ``steps`` serve steps, step i fed ``forced[:,
    i]`` (the unsplit model's tokens), with the kernel launches of the
    prefill and those steps; the logits of one serve step from this rank's
    shard of ``first_step`` = (a full cache, tokens (B, 1)); then, timed
    from the prefill's cache on the rank's own greedy tokens, each step's
    wall and host queue seconds, its launches and all_reduce calls and
    bytes, peak memory, the device's busy seconds in a profiled third run,
    and ``calibrate_model_allreduce``."""
    b = prompt.shape[0]
    x = {"tokens": torch.from_numpy(prompt).to(dev)}
    with torch.no_grad():
        out = {"tokens32": _tp_tokens32(mesh, dev, cfg32, x, steps,
                                        max_len, seed)}
        _free(dev)
        pre, srv, params = serving_steps(mesh, dev, cfg16, b, max_len,
                                         seed=seed)
        rows = pre.meta["rows"]
        ops.reset_launch_counts()
        tok, cache = pre.fn(params, x)
        cache = srv.store_cache(cache)
        keep = {k: v.clone() for k, v in cache.items()}
        out.update(rows=(rows.start, rows.stop),
                   prefill_logits=pre.last_logits.float().cpu().numpy(),
                   n_heads_local=pre.model.n_heads_local,
                   n_kv_local=pre.model.n_kv_local)
        feed = torch.from_numpy(forced).to(device=dev, dtype=torch.int32)
        first = tok.reshape(b, 1)
        toks = [first]
        for i in range(steps):
            cur, cache = srv.fn(params, cache, feed[:, i:i + 1])
            toks.append(cur)
        out["tokens"] = torch.cat(toks, 1).cpu().numpy()
        out["launches"] = ops.launch_counts()
        full, tokens = first_step
        shard = {k: v.to(dev) for k, v in srv.shard_cache(full).items()}
        srv.fn(params, shard, torch.from_numpy(tokens).to(
            device=dev, dtype=torch.int32))
        out["first_logits"] = srv.last_logits.float().cpu().numpy()
        del shard, cache, toks
        sharder = srv.meta["sharder"]
        cache = {k: v.clone() for k, v in keep.items()}
        ops.reset_launch_counts()
        sharder.reset_stats()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        walls, queued = [], []
        cur = first
        for _ in range(steps):
            t0 = time.perf_counter()
            cur, cache = srv.fn(params, cache, cur)
            queued.append(time.perf_counter() - t0)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
        out.update(step_wall_s=walls, host_queue_s=queued,
                   timed_launches=ops.launch_counts(),
                   allreduce=dict(sharder.stats),
                   peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None))
        if dev.type == "cuda":
            cache = {k: v.clone() for k, v in keep.items()}

            def run():
                cur, c = first, cache
                for _ in range(steps):
                    cur, c = srv.fn(params, c, cur)
            out["busy_s"], out["busy_wall_s"] = _tp_busy(run, dev)
        if mesh.shape["model"] > 1:
            out["calibrate"] = calibrate_model_allreduce(mesh, dev)
    return out


def phase_tp_path(dev, path: str, depth: int, seed: int, rehearsal: bool,
                  repeats: int, profile_dir: Path | None = None) -> dict:
    """Tensor parallelism (``launch/steps.py``'s ``build_step`` over a
    ``launch/mesh.py`` mesh): Qwen3-32B widths, 8 rows of one 1024-token
    prompt through ``prefill_step`` (cache of ``MAX_LEN``), then
    ``TP_STEPS`` greedy ``serve_step``s, on meshes (data 1, model 2), (1, 4) and (2, 2) in
    turns, every rank a process on this card (gloo over CUDA tensors).
    The unsplit ``LM`` runs first on the same card and weights; each rank
    runs ``tp_rank``. Gates: fp32 at 2 of the layers, every rank's tokens
    equal the unsplit model's; bf16 at ``TP_LAYERS``: the prefill's
    last-position logits within ``TP_REL`` (2e-2) of max |logit| of the
    unsplit bf16 LM's; the first serve step, run on the unsplit fp32
    prefill's cache as bf16 stores it (each rank's shard) and its tokens,
    at most ``TP_STEP_RATIO`` (1.25) times as far from the unsplit LM
    evaluated in fp32 on the same values (``tp_fp32_reference``) as the
    unsplit bf16 LM's step is (the other readings printed beside: the
    ranks' prefill against the fp32 LM, their step against the unsplit
    bf16 LM's, that LM re-batched against itself); every rank
    launches ``decode_attention`` and
    ``flash_attention`` at its local head counts. The bf16 run feeds every
    step the unsplit bf16 model's token: the equal argmaxes and the first
    divergence are printed, not gated. Per mesh and rank: step wall and
    host queue time, device busy, launches and all_reduce calls and bytes
    per step, peak GB, ``calibrate_allreduce`` over the model group. With
    four cards, (1, 4) once more over nccl, one rank per card."""
    arch = PATHS[path][0]
    required = PATHS[path][2]
    tag = f"[{path}]"
    base = get_config(arch)
    if rehearsal:
        cfg32 = base.reduced()
        cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
        rows, prompt_len, steps, s_max = 4, 6, 4, 16
        meshes = ((2, 2),)
    else:
        cfg16 = dataclasses.replace(base, n_layers=TP_LAYERS)
        cfg32 = dataclasses.replace(base, n_layers=TP_FP32_LAYERS,
                                    dtype="float32")
        rows, prompt_len, steps, s_max = (TP_ROWS, TP_PROMPT, TP_STEPS,
                                          MAX_LEN)
        meshes = TP_MESHES
    prompt = np.random.RandomState(seed).randint(
        0, cfg16.vocab, (rows, prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    ref32 = tp_unsplit(cfg32, dev, {"tokens": prompt}, steps, seed, s_max)
    ref16 = tp_unsplit(cfg16, dev, {"tokens": prompt}, steps, seed, s_max)
    exact = tp_fp32_reference(cfg16, dev, {"tokens": prompt}, seed, s_max)
    log(f"{tag} {base.name} widths; fp32 at {cfg32.n_layers} layers, "
        f"{cfg16.dtype} at {cfg16.n_layers} of {base.n_layers}; {rows} rows "
        f"of a {prompt_len}-token prompt, cache S={s_max}, {steps} steps; "
        f"unsplit LM on this card {time.perf_counter() - t0:.1f} s")
    rank_args = (cfg32, cfg16, prompt, steps, s_max, seed,
                 ref16["tokens"][:, :steps].copy(),
                 (exact.pop("cache"), exact["tokens"]))
    runs = [(m, "gloo", "cuda" if dev.type == "cuda" else "cpu")
            for m in meshes]
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 4:
        runs.append(((1, 4), "nccl", "cuda"))
    counts: dict = {}
    failed = []
    for mesh, backend, where in runs:
        t1 = time.perf_counter()
        outs = run_ranks(tp_rank, mesh, TP_AXES, backend=backend,
                         device=where, args=rank_args)
        name = f"mesh (data {mesh[0]}, model {mesh[1]}) {backend}"
        log(f"{tag} {name}: {len(outs)} ranks, "
            f"{time.perf_counter() - t1:.1f} s with the ranks' start")
        model_n = mesh[1]
        for rank, o16 in enumerate(outs):
            lo, hi = o16["rows"]
            same32 = bool(np.array_equal(o16["tokens32"], ref32["tokens"]))
            pre = _rel(o16["prefill_logits"], exact["prefill_logits"][lo:hi])
            first = _rel(o16["first_logits"][:, 0], exact["first"][lo:hi, 0])
            # the unsplit bf16 model's own error against the same yardstick,
            # and the ranks' prefill against the unsplit bf16 model's
            pre16 = _rel(ref16["prefill_logits"][lo:hi],
                         exact["prefill_logits"][lo:hi])
            first16 = _rel(exact["first16"][lo:hi, 0],
                           exact["first"][lo:hi, 0])
            step_vs16 = _rel(o16["first_logits"][:, 0],
                             exact["first16"][lo:hi, 0])
            vs16 = _rel(o16["prefill_logits"], ref16["prefill_logits"][lo:hi])
            got, want = o16["tokens"][:, 1:], ref16["tokens"][:, 1:]
            eq = got == want
            col = np.where(~eq.all(axis=0))[0]
            diverge = int(col[0]) if len(col) else None
            heads = (o16["n_heads_local"], o16["n_kv_local"])
            want_heads = (cfg16.n_heads // model_n,
                          cfg16.n_kv_heads // model_n)
            launched = o16["launches"]
            ok = (same32 and vs16 <= TP_REL
                  and first <= TP_STEP_RATIO * first16
                  and heads == want_heads
                  and (dev.type != "cuda"
                       or all(launched[k] for k in required)))
            walls = sorted(o16["step_wall_s"])
            per_step = float(np.median(walls))
            queue = float(np.median(o16["host_queue_s"]))
            ar = o16["allreduce"]
            tl = o16["timed_launches"]
            cal, peak = o16.get("calibrate"), o16["peak_gb"]
            busy = "not measured (CPU)"
            if "busy_s" in o16:
                busy = (f"{o16['busy_s'] / (per_step * steps):.3f} "
                        f"({o16['busy_s']:.4f} s of device time in a run of "
                        f"{steps} steps; against the profiled run's "
                        f"{o16['busy_wall_s']:.3f} s wall "
                        f"{o16['busy_s'] / o16['busy_wall_s']:.3f})")
            ulps = _ulps(o16["prefill_logits"],
                         ref16["prefill_logits"][lo:hi])
            log(f"{tag} {name} rank {rank}: rows [{lo}, {hi}) heads "
                f"{heads[0]}/{heads[1]}; fp32 tokens == unsplit {same32}; "
                f"{cfg16.dtype} prefill logits against the unsplit "
                f"{cfg16.dtype} LM's rel {vs16:.3e} ({ulps:.1f} bf16 ulps; "
                f"limit {TP_REL} of max |logit|); against the unsplit LM "
                f"in fp32 on the same weights {pre:.3e} (the unsplit "
                f"{cfg16.dtype} LM's own {pre16:.3e}); first step on the "
                f"fp32 prefill's cache as bf16 stores it and its tokens, "
                f"against the fp32 LM's step rel {first:.3e} (limit "
                f"{TP_STEP_RATIO} x the unsplit {cfg16.dtype} LM's own "
                f"{first16:.3e} = {TP_STEP_RATIO * first16:.3e}; against "
                f"the unsplit {cfg16.dtype} LM's step {step_vs16:.3e}); "
                f"{cfg16.dtype} argmax == unsplit {cfg16.dtype} "
                f"{int(eq.sum())}/{eq.size} fed the unsplit tokens, first "
                f"divergence at step {diverge}; launches prefill + "
                f"{steps} steps {launched} "
                f"{'ok' if ok else 'FAIL'}")
            log(f"{tag} {name} rank {rank}: step_wall_s median="
                f"{per_step:.5f} min={walls[0]:.5f} max={walls[-1]:.5f}; "
                f"host_queue_s median={queue:.5f}; device_busy_share="
                f"{busy}; decode_attention per step "
                f"{tl['decode_attention'] / steps:g}, flash_attention "
                f"{launched['flash_attention']} in the prefill; all_reduce "
                f"per step {ar['calls'] / steps:g} calls, "
                f"{ar['bytes'] / steps:.0f} bytes; peak_mem_GB="
                f"{'not measured (CPU)' if peak is None else round(peak, 3)}")
            if cal is not None:
                log(f"{tag} {name} rank {rank}: calibrate_allreduce over the "
                    f"model group: alpha {cal['alpha_s'] * 1e6:.2f} us, beta "
                    f"{cal['beta_bps'] / 1e9:.3f} GB/s ("
                    + ("gloo staged through the host, every rank on one "
                       "card: not a link" if backend == "gloo" else
                       "nccl, one rank per card") + ")")
            if not ok:
                failed.append(f"{name} rank {rank}")
            for k, v in launched.items():
                counts[k] = counts.get(k, 0) + v
    log(f"{tag} the unsplit {cfg16.dtype} LM on its rows in two halves "
        f"against itself on all 8 (the same function, other GEMM shapes): "
        f"prefill logits rel "
        f"{_rel(exact['halves'], ref16['prefill_logits']):.3e}, first step "
        f"rel {_rel(exact['first16_halves'], exact['first16']):.3e}")
    if failed:
        raise SystemExit(f"chip_smoke: tensor parallelism disagrees with the "
                         f"unsplit model or missed a kernel on {failed}")
    if n_cards < 4:
        log(f"{tag} (1, 4) over nccl did not run: it needs four cards, one "
            f"rank each (NCCL refuses two ranks on one device); this "
            f"machine has {n_cards}")
    if dev.type == "cuda":
        log(f"{tag} nvidia-smi: {smi_line()}")
    return dict(counts=counts, tokens=ref32["tokens"].tolist())


# -- tensor parallelism for the SSM, hybrid and encoder-decoder families -------
# (path ``tp_families``): mamba2-1.3b, zamba2-2.7b and whisper-tiny at full
# width on meshes (1, 2) and (1, 4) of rank processes on this card over
# gloo, as path ``tp`` runs them, every family in each world; per family the
# fp32 gate's depth (mamba2 2 layers, zamba2 one hybrid_period of 6, whisper
# whole) and the bf16 depth (None: whole), cut to keep the script in its
# time limit: mamba2 12 of 48 layers, zamba2 12 of 54 (2 shared-block
# applications), whisper whole
TPF_FAMILIES = (("mamba2-1.3b", 2, 12), ("zamba2-2.7b", 6, 12),
                ("whisper-tiny", None, None))
TPF_MESHES = ((1, 2), (1, 4))
# serve steps per family and world: a (1, 4) step of mamba2 / zamba2 takes
# ~0.8-0.9 s on gloo, and every phase shares the script's time limit
TPF_STEPS = 8
TPF_BUSY_STEPS = 2            # steps of the device-only profiled pass


def tpf_launches(cfg, steps: int, model_n: int) -> dict:
    """The kernel launches of one rank's prefill and ``steps`` serve steps
    of ``cfg`` on a model axis of ``model_n``, from the model code (every
    other kernel: none). Mamba2: one SSD scan a layer in the prefill; the
    hybrid's shared block: one flash a application in the prefill, one
    decode a application a step; a dense / VLM decoder: one flash a layer
    in the prefill, one decode a layer a step; the encoder-decoder: flash
    over each encoder layer and the decoder's self and cross attention in
    the prefill, its self-attention decode each step, and its cross
    attention each step by flash, or, on a cross cache cut by sequence
    (the KV heads do not divide the model axis), by the decode kernel with
    its log-sum-exp output."""
    seq = model_n > 1 and cfg.n_kv_heads % model_n != 0
    if cfg.is_encdec:
        return {"flash_attention": cfg.n_encoder_layers
                + (2 + steps * (not seq)) * cfg.n_layers,
                "decode_attention": steps * cfg.n_layers * (1 + seq)}
    if cfg.family not in ("ssm", "hybrid"):
        return {"flash_attention": cfg.n_layers,
                "decode_attention": steps * cfg.n_layers}
    apps = len(cfg.shared_attn_positions())
    out = {"ssd_scan": cfg.n_layers}
    if apps:
        out.update(flash_attention=apps, decode_attention=apps * steps)
    return out


def tpf_reduces(cfg, model_n: int) -> int:
    """The all_reduce calls of one serve step on a (1, ``model_n``) mesh,
    from the model code: two a Mamba2 layer whose SSD heads split (the
    gated norm's sums of squares, ``w_out``), one an attention block whose
    heads split (``wo``) and one an FFN whose columns split (``w_down``),
    and the vocab-parallel embedding and logits; a dimension splits where
    its count divides the model axis."""
    def split(n: int) -> int:
        return int(n % model_n == 0)
    n = 2 * split(cfg.padded_vocab)
    blocks = 2 * split(cfg.n_heads) + split(cfg.d_ff)   # encoder-decoder
    if cfg.is_encdec:
        return n + cfg.n_layers * blocks
    if cfg.family not in ("ssm", "hybrid"):
        return n + cfg.n_layers * (split(cfg.n_heads) + split(cfg.d_ff))
    n += 2 * cfg.n_layers * split(cfg.ssm_heads)
    return n + len(cfg.shared_attn_positions()) * (split(cfg.n_heads)
                                                   + split(cfg.d_ff))


def tpf_inputs(cfg, rows: int, prompt_len: int, seed: int) -> dict:
    """The prompt (numpy): tokens, and for the encoder-decoder its stubbed
    frontend's frames, one a prompt token as ``input_specs`` gives them,
    at values bf16 holds (the fp32 yardstick reads the same values)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab, (rows, prompt_len)).astype(
        np.int32)}
    if cfg.is_encdec:
        frames = torch.from_numpy(rng.randn(rows, prompt_len, cfg.d_model)
                                  .astype(np.float32))
        out["embeds"] = frames.bfloat16().float().numpy()
    return out


def tpf_rank(mesh, dev, cases: list, steps: int, max_len: int,
             seed: int) -> list:
    """One rank of path ``tp_families`` (``run_ranks`` calls it in every
    rank): ``_tpf_family`` for each family of ``cases`` in turn."""
    return [_tpf_family(mesh, dev, steps=steps, max_len=max_len, seed=seed,
                        **case) for case in cases]


def _tpf_family(mesh, dev, cfg32, cfg16, cfg16r, inputs: dict,
                forced: np.ndarray, first_step: tuple, steps: int,
                max_len: int, seed: int, kv_fp8: str | None = None
                ) -> dict:
    """One family on one rank. fp32 (``cfg32``): the greedy tokens. bf16
    at ``cfg32``'s depth (``cfg16r``, None where that is ``cfg16``'s): the
    prefill's last-position logits. bf16 (``cfg16``): the prefill's
    last-position logits, its local head counts
    and the SSD scan's launches by body; ``steps`` serve steps, step i fed
    ``forced[:, i]`` (the unsplit model's tokens), each timed (wall and
    host queue seconds), with the kernel launches of the prefill and those
    steps, the steps' all_reduce calls and bytes and the peak memory; the
    logits of one serve step from this rank's shard of ``first_step`` =
    (a full cache, tokens (B, 1)), and with ``kv_fp8`` of the same step on
    that shard stored in fp8 (``build_step(kv_cache_dtype=)``); the
    decode launches with the log-sum-exp output, the K/V bytes of the
    rank's cache; the device's busy seconds over ``TPF_BUSY_STEPS`` steps
    from the prefill's cache in a profiled pass."""
    b = inputs["tokens"].shape[0]
    x = _on(inputs, dev)
    cuda = dev.type == "cuda"
    with torch.no_grad():
        out = {"tokens32": _tp_tokens32(mesh, dev, cfg32, x, steps,
                                        max_len, seed)}
        _free(dev)
        if cfg16r is not None:
            pre, _, params = serving_steps(mesh, dev, cfg16r, b, max_len,
                                           seed=seed)
            pre.fn(params, x)
            out["prefill_logits_r"] = pre.last_logits.float().cpu().numpy()
            del pre, params
            _free(dev)
        pre, srv, params = serving_steps(mesh, dev, cfg16, b, max_len,
                                         seed=seed)
        rows, sharder, model = pre.meta["rows"], srv.meta["sharder"], \
            pre.model
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        ssd.reset_bodies()
        tok, cache = pre.fn(params, x)
        cache = srv.store_cache(cache)
        keep = {k: v.clone() for k, v in cache.items()}
        first = tok.reshape(b, 1)
        out.update(rows=(rows.start, rows.stop),
                   prefill_logits=pre.last_logits.float().cpu().numpy(),
                   heads=(model.n_heads_local, model.n_kv_local,
                          model.ssm_heads_local),
                   ssd_bodies=dict(ssd.body_counts))
        sharder.reset_stats()
        feed = torch.from_numpy(forced).to(device=dev, dtype=torch.int32)
        toks, walls, queued = [first], [], []
        _sync(dev)
        for i in range(steps):
            t0 = time.perf_counter()
            cur, cache = srv.fn(params, cache, feed[:, i:i + 1])
            queued.append(time.perf_counter() - t0)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
            toks.append(cur)
        out.update(tokens=torch.cat(toks, 1).cpu().numpy(),
                   launches=ops.launch_counts(),
                   decode_lse=ops.decode_lse_launches(),
                   cache_bytes=sum(v.numel() * v.element_size()
                                   for k, v in keep.items()
                                   if k in KV_KEYS),
                   allreduce=dict(sharder.stats), step_wall_s=walls,
                   host_queue_s=queued,
                   peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                            if cuda else None))
        full, tokens = first_step
        shard = {k: v.to(dev) for k, v in srv.shard_cache(full).items()}
        srv.fn(params, shard, torch.from_numpy(tokens).to(
            device=dev, dtype=torch.int32))
        out["first_logits"] = srv.last_logits.float().cpu().numpy()
        if kv_fp8:
            srv8 = build_step(cfg16, ShapeSpec("fp8", max_len, b,
                                               "serve_step"), mesh,
                              kv_cache_dtype=kv_fp8, device=dev)
            srv8.fn(params, srv8.store_cache(
                {k: v.to(dev) for k, v in srv8.shard_cache(full).items()}),
                torch.from_numpy(tokens).to(device=dev, dtype=torch.int32))
            out["first8_logits"] = srv8.last_logits.float().cpu().numpy()
            del srv8
        del shard, cache, toks
        if cuda:
            def run():
                cur, c = first, keep
                for _ in range(TPF_BUSY_STEPS):
                    cur, c = srv.fn(params, c, cur)
            out["busy_s"], out["busy_wall_s"] = _tp_busy(run, dev)
        del pre, srv, params, keep, model
    _free(dev)
    return out


def phase_tp_families(dev, path: str, depth: int, seed: int,
                      rehearsal: bool, repeats: int,
                      profile_dir: Path | None = None) -> dict:
    """Tensor parallelism for the SSM, hybrid and encoder-decoder families
    (``build_step`` over a ``launch/mesh.py`` mesh): mamba2-1.3b (64 SSD
    heads), zamba2-2.7b (80 SSD heads, a shared block of 32 heads of 80)
    at full width and the depths ``TPF_FAMILIES`` gives (12 of 48 and 12
    of 54 layers) and whisper-tiny (6 heads: the cache cut by sequence at
    model 4) whole, 8 rows of a 1024-token prompt (whisper: as many
    encoder frames)
    through ``prefill_step`` (cache of ``MAX_LEN``), then ``TPF_STEPS``
    serve steps, on meshes (1, 2) and (1, 4), every rank a process on this
    card (gloo), each world running every family in turn (``tpf_rank``).
    The unsplit models run first on the same card and weights. Gates, per
    family and rank: fp32 at a reduced depth (``TPF_FAMILIES``) the greedy
    tokens equal the unsplit model's; bf16 at that depth (whisper: whole)
    the prefill logits within path ``tp``'s ``TP_REL`` of the unsplit bf16
    model's (at 48 and 54 layers the bf16 recurrent models move by more
    than that under the row-parallel products' summation order alone, so
    full depth is not held to it: PERF.md, §6); bf16 at full depth the
    prefill logits and the first serve step on the unsplit fp32 prefill's
    cache (as bf16 stores it) each at most ``TP_STEP_RATIO`` times as far
    from the unsplit model evaluated in fp32 on the same weights as the
    unsplit bf16 model's (the form of path ``tp``'s step gate); the
    local head counts; the kernel launches of the prefill and the steps
    exactly ``tpf_launches``; the all_reduce calls of a step exactly
    ``tpf_reduces``, all in fp32 but the embedding's and the logits'; every
    SSD scan on its tensor-core body. Per family,
    mesh and rank: step wall and host queue time, device busy, all_reduce
    calls and bytes a step, peak GB."""
    tag = f"[{path}]"
    if rehearsal:
        rows, prompt_len, steps, s_max = 4, 6, 4, 16
        meshes = ((1, 2),)
    else:
        rows, prompt_len, steps, s_max = TP_ROWS, TP_PROMPT, TPF_STEPS, \
            MAX_LEN
        meshes = TPF_MESHES
    fams, cases = [], []
    for arch, fp32_layers, bf16_layers in TPF_FAMILIES:
        base = get_config(arch)
        if rehearsal:
            cfg32 = base.reduced()
            cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
        else:
            cfg16 = dataclasses.replace(base, n_layers=(
                bf16_layers or base.n_layers))
            cfg32 = dataclasses.replace(base, dtype="float32", n_layers=(
                fp32_layers or base.n_layers))
        # bf16 at the fp32 gate's depth, where rounding is not amplified
        cfg16r = dataclasses.replace(cfg32, dtype=cfg16.dtype)
        if cfg16r.n_layers == cfg16.n_layers:
            cfg16r = None
        inputs = tpf_inputs(cfg16, rows, prompt_len, seed)
        t0 = time.perf_counter()
        ref32 = tp_unsplit(cfg32, dev, inputs, steps, seed, s_max)
        ref16 = tp_unsplit(cfg16, dev, inputs, steps, seed, s_max)
        ref16r = ref16 if cfg16r is None else tp_unsplit(
            cfg16r, dev, inputs, 1, seed, s_max)
        exact = tp_fp32_reference(cfg16, dev, inputs, seed, s_max)
        log(f"{tag} {cfg16.name}: fp32 at {cfg32.n_layers} layers, "
            f"{cfg16.dtype} at {cfg16.n_layers}; {rows} rows of a "
            f"{prompt_len}-token prompt, cache S={s_max}, {steps} steps; "
            f"unsplit model on this card {time.perf_counter() - t0:.1f} s")
        log(f"{tag} {cfg16.name}: the unsplit {cfg16.dtype} model against "
            f"itself (the same function): on its rows in two halves, "
            f"prefill logits rel "
            f"{_rel(exact['halves'], ref16['prefill_logits']):.3e}, first "
            f"step rel {_rel(exact['first16_halves'], exact['first16']):.3e};"
            f" its own prefill against the model in fp32 "
            f"{_rel(ref16['prefill_logits'], exact['prefill_logits']):.3e}")
        fams.append((cfg32, cfg16, ref32, ref16, ref16r, exact))
        cases.append(dict(cfg32=cfg32, cfg16=cfg16, cfg16r=cfg16r,
                          inputs=inputs,
                          forced=ref16["tokens"][:, :steps].copy(),
                          first_step=(exact.pop("cache"), exact["tokens"])))
    where = "cuda" if dev.type == "cuda" else "cpu"
    counts: dict = {}
    failed = []
    for mesh in meshes:
        t1 = time.perf_counter()
        outs = run_ranks(tpf_rank, mesh, TP_AXES, backend="gloo",
                         device=where, args=(cases, steps, s_max, seed))
        name = f"mesh (data {mesh[0]}, model {mesh[1]}) gloo"
        log(f"{tag} {name}: {len(outs)} ranks, "
            f"{time.perf_counter() - t1:.1f} s with the ranks' start")
        model_n = mesh[1]
        for rank, per_family in enumerate(outs):
            for (cfg32, cfg16, ref32, ref16, ref16r, exact), o in zip(
                    fams, per_family):
                fail = tpf_check(tag, f"{name} rank {rank}", dev, cfg32,
                                 cfg16, model_n, steps, o, ref32, ref16,
                                 ref16r, exact)
                if fail:
                    failed.append(f"{cfg16.name} {name} rank {rank}: "
                                  f"{fail}")
                for k, v in o["launches"].items():
                    counts[k] = counts.get(k, 0) + v
                # whisper at model 4: its caches are cut by sequence
                counts["decode_attention_lse"] = (
                    counts.get("decode_attention_lse", 0) + o["decode_lse"])
    if failed:
        raise SystemExit(f"chip_smoke: tensor parallelism of the SSM, hybrid "
                         f"or encoder-decoder family failed a gate: {failed}")
    if dev.type == "cuda":
        log(f"{tag} nvidia-smi: {smi_line()}")
    return dict(counts=counts, tokens=[f[2]["tokens"].tolist()
                                       for f in fams])


def tpf_check(tag: str, where: str, dev, cfg32, cfg, model_n: int,
              steps: int, o: dict, ref32: dict, ref16: dict, ref16r: dict,
              exact: dict) -> str:
    """Log one family's readings on one rank of ``phase_tp_families`` and
    return the gates it fails (an empty string when it passes them)."""
    lo, hi = o["rows"]
    cuda = dev.type == "cuda"
    same32 = bool(np.array_equal(o["tokens32"], ref32["tokens"]))
    vs16 = _rel(o["prefill_logits"], ref16["prefill_logits"][lo:hi])
    vs16r = _rel(o.get("prefill_logits_r", o["prefill_logits"]),
                 ref16r["prefill_logits"][lo:hi])
    pre = _rel(o["prefill_logits"], exact["prefill_logits"][lo:hi])
    pre16 = _rel(ref16["prefill_logits"][lo:hi],
                 exact["prefill_logits"][lo:hi])
    first = _rel(o["first_logits"][:, 0], exact["first"][lo:hi, 0])
    first16 = _rel(exact["first16"][lo:hi, 0], exact["first"][lo:hi, 0])
    eq = o["tokens"][:, 1:] == ref16["tokens"][:, 1:]

    def local(n):
        return n // model_n if n % model_n == 0 else n
    want_heads = (local(cfg.n_heads), local(cfg.n_kv_heads),
                  local(cfg.ssm_heads) if cfg.ssm_state else 0)
    want_launch = tpf_launches(cfg, steps, model_n)
    launched = o["launches"]
    launch_ok = not cuda or all(v == want_launch.get(k, 0)
                                for k, v in launched.items())
    want_calls = steps * tpf_reduces(cfg, model_n)
    # every sum in fp32 but the vocab-parallel embedding's and logits'
    # (model dtype): the row-parallel partials and the gated norm's sums
    want_fp32 = want_calls - steps * 2 * int(cfg.padded_vocab % model_n == 0)
    ar = o["allreduce"]
    bodies = o["ssd_bodies"]
    ssd_ok = (not cuda or not cfg.ssm_state
              or bodies == {"cuda-core": 0, "tensor-core": cfg.n_layers})
    gates = {"fp32 tokens": same32,
             f"prefill at {cfg32.n_layers} layers": vs16r <= TP_REL,
             "prefill": pre <= TP_STEP_RATIO * pre16,
             "first step": first <= TP_STEP_RATIO * first16,
             "heads": tuple(o["heads"]) == want_heads,
             "launches": launch_ok, "all_reduce calls":
             ar["calls"] == want_calls,
             "fp32 all_reduce calls": ar["fp32_calls"] == want_fp32,
             "SSD body": ssd_ok}
    fail = ", ".join(k for k, v in gates.items() if not v)
    log(f"{tag} {cfg.name} {where}: rows [{lo}, {hi}) heads "
        f"{o['heads']} (attention, KV, SSD; want {want_heads}); fp32 "
        f"tokens == unsplit {same32}; {cfg.dtype} prefill logits at "
        f"{cfg32.n_layers} layers against the unsplit {cfg.dtype} model's "
        f"rel {vs16r:.3e} (limit {TP_REL}); at {cfg.n_layers} layers "
        f"against the unsplit model in fp32 on the same weights rel "
        f"{pre:.3e} (limit {TP_STEP_RATIO} x the unsplit {cfg.dtype} "
        f"model's own {pre16:.3e} = {TP_STEP_RATIO * pre16:.3e}; against "
        f"the unsplit {cfg.dtype} model's {vs16:.3e}, not gated); first "
        f"step "
        f"against the fp32 model's rel {first:.3e} (limit {TP_STEP_RATIO} "
        f"x the unsplit {cfg.dtype} model's own {first16:.3e} = "
        f"{TP_STEP_RATIO * first16:.3e}); argmax == unsplit {cfg.dtype} "
        f"{int(eq.sum())}/{eq.size} fed the unsplit tokens; launches "
        f"prefill + {steps} steps {launched} (want {want_launch}); SSD "
        f"bodies {bodies}; all_reduce {ar['calls']} calls (want "
        f"{want_calls}), {ar['fp32_calls']} of them fp32 (want {want_fp32}) "
        f"{'ok' if not fail else 'FAIL: ' + fail}")
    walls = sorted(o["step_wall_s"])
    per_step = float(np.median(walls))
    busy = "not measured (CPU)"
    if "busy_s" in o:
        busy = (f"{o['busy_s'] / o['busy_wall_s']:.4f} ({o['busy_s']:.4f} "
                f"s of device time in a profiled pass of {TPF_BUSY_STEPS} "
                f"steps, {o['busy_wall_s']:.3f} s wall)")
    peak = o["peak_gb"]
    log(f"{tag} {cfg.name} {where}: step_wall_s median={per_step:.5f} "
        f"min={walls[0]:.5f} max={walls[-1]:.5f}; host_queue_s median="
        f"{float(np.median(o['host_queue_s'])):.5f}; device_busy_share="
        f"{busy}; all_reduce per step {ar['calls'] / steps:g} calls, "
        f"{ar['bytes'] / steps:.0f} bytes; peak_mem_GB (prefill and steps)="
        f"{'not measured (CPU)' if peak is None else round(peak, 3)}")
    return fail


# -- the sequence-split KV cache (path ``tp_seq``) ---------------------------------
# qwen2-vl-2b (12 / 2 heads) and whisper-tiny (6 / 6) whole on TPS_MESH: the
# KV heads do not divide the model axis, so the serve cache is cut by
# sequence (the reference's cache_seq); the fp32 gate's depth per model
TPS_FAMILIES = (("qwen2-vl-2b", 4), ("whisper-tiny", None))
TPS_STEPS = 8
TPS_FP8 = "float8_e4m3fn"


def tps_cache_bytes(cfg, rows: int, s_max: int, s_enc: int, model_n: int,
                    rank: int) -> tuple:
    """A rank's K/V bytes (bf16) reckoned from the shapes: (cut by
    sequence: every KV head of S / model_n positions of each leaf; the
    layout by heads the port used before: the KV heads the rank's query
    heads read, or every head where the query heads are whole, at full
    length)."""
    lens = [s_max, s_max] + ([s_enc, s_enc] if cfg.is_encdec else [])
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    n_heads = nkv
    if nh % model_n == 0:
        n_heads = len(kv_select(nh, nkv, nh // model_n,
                                rank * (nh // model_n)))
    per = cfg.n_layers * rows * cfg.hd * 2
    return (sum(per * (s // model_n) * nkv for s in lens),
            sum(per * s * n_heads for s in lens))


def phase_tp_seq(dev, path: str, depth: int, seed: int, rehearsal: bool,
                 repeats: int, profile_dir: Path | None = None) -> dict:
    """The sequence-split KV cache (the reference's ``cache_seq`` rule,
    ``build_step`` over a ``launch/mesh.py`` mesh): qwen2-vl-2b (28
    layers, 12 / 2 heads of 128) and whisper-tiny (6 / 6 heads) whole on a
    (1, 4) mesh of rank processes on this card (gloo), one world running
    both (``tpf_rank``). Their KV heads do not divide 4, so each rank's
    serve cache holds every KV head of a quarter of the positions (the
    prefill step's cache already does), qwen2-vl's query heads stay split
    (3 a rank: q gathered, the partials sent to their heads' rank by one
    all_to_all) and whisper's attention is whole on every rank (the
    partials gathered), its cross cache cut too. 8 rows of a 1024-token
    prompt (whisper: as many encoder frames), ``TPS_STEPS`` serve steps.
    Gates, per model and rank, those of path ``tp_families``
    (``tpf_check``: fp32 tokens at ``TPS_FAMILIES``' depth equal to the
    unsplit model's, the bf16 prefill and first step at most
    ``TP_STEP_RATIO`` times as far from the model in fp32 as the unsplit
    bf16 model's, launches and all_reduce calls as reckoned) and: every
    decode of the steps launched with the log-sum-exp output; the rank's
    K/V bytes equal to ``tps_cache_bytes``; qwen2-vl's first step on a
    float8_e4m3fn serve cache at most ``TP_STEP_RATIO`` times as far from
    the fp32 model on the fp8 values as the unsplit fp8 step is. Per
    rank: the cache bytes beside the layout by heads, all_gather /
    all_to_all / all_reduce calls and bytes a step, step wall, host queue,
    device busy."""
    tag = f"[{path}]"
    mesh = TPS_MESH
    model_n = mesh[1]
    if rehearsal:           # 8 encoder frames: they cut into 4 slices
        rows, prompt_len, steps, s_max = 4, 8, 4, 16
    else:
        rows, prompt_len, steps, s_max = TP_ROWS, TP_PROMPT, TPS_STEPS, \
            MAX_LEN
    fams, cases = [], []
    for arch, fp32_layers in TPS_FAMILIES:
        base = get_config(arch)
        if rehearsal:
            cfg32 = base.reduced()
            if base.is_encdec:          # 6 heads: none divides the axis
                cfg32 = dataclasses.replace(cfg32, n_heads=6, n_kv_heads=6,
                                            head_dim=16)
            cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
        else:
            cfg16 = base
            cfg32 = dataclasses.replace(base, dtype="float32", n_layers=(
                fp32_layers or base.n_layers))
        cfg16r = dataclasses.replace(cfg32, dtype=cfg16.dtype)
        if cfg16r.n_layers == cfg16.n_layers:
            cfg16r = None
        fp8 = None if cfg16.is_encdec else TPS_FP8
        inputs = tpf_inputs(cfg16, rows, prompt_len, seed)
        t0 = time.perf_counter()
        ref32 = tp_unsplit(cfg32, dev, inputs, steps, seed, s_max)
        ref16 = tp_unsplit(cfg16, dev, inputs, steps, seed, s_max)
        ref16r = ref16 if cfg16r is None else tp_unsplit(
            cfg16r, dev, inputs, 1, seed, s_max)
        exact = tp_fp32_reference(cfg16, dev, inputs, seed, s_max,
                                  kv_fp8=fp8)
        log(f"{tag} {cfg16.name}: {cfg16.n_heads} / {cfg16.n_kv_heads} "
            f"heads of {cfg16.hd} on a model axis of {model_n}; fp32 at "
            f"{cfg32.n_layers} layers, {cfg16.dtype} at {cfg16.n_layers}; "
            f"{rows} rows of a {prompt_len}-token prompt, cache S={s_max}, "
            f"{steps} steps; unsplit model on this card "
            f"{time.perf_counter() - t0:.1f} s")
        fams.append((cfg32, cfg16, ref32, ref16, ref16r, exact, fp8))
        cases.append(dict(cfg32=cfg32, cfg16=cfg16, cfg16r=cfg16r,
                          inputs=inputs,
                          forced=ref16["tokens"][:, :steps].copy(),
                          first_step=(exact.pop("cache"), exact["tokens"]),
                          kv_fp8=fp8))
    where = "cuda" if dev.type == "cuda" else "cpu"
    t1 = time.perf_counter()
    outs = run_ranks(tpf_rank, mesh, TP_AXES, backend="gloo", device=where,
                     args=(cases, steps, s_max, seed))
    name = f"mesh (data {mesh[0]}, model {mesh[1]}) gloo"
    log(f"{tag} {name}: {len(outs)} ranks, {time.perf_counter() - t1:.1f} "
        f"s with the ranks' start")
    cuda = dev.type == "cuda"
    counts: dict = {}
    failed = []
    for rank, per_family in enumerate(outs):
        for (cfg32, cfg16, ref32, ref16, ref16r, exact, fp8), o in zip(
                fams, per_family):
            where_r = f"{name} rank {rank}"
            fail = tpf_check(tag, where_r, dev, cfg32, cfg16, model_n,
                             steps, o, ref32, ref16, ref16r, exact)
            lo, hi = o["rows"]
            want_b, heads_b = tps_cache_bytes(
                cfg16, hi - lo, s_max, prompt_len if cfg16.is_encdec else 0,
                model_n, rank)
            dec = o["launches"]["decode_attention"]
            gates = {"cache bytes": o["cache_bytes"] == want_b,
                     "decode with lse": not cuda or (
                         dec > 0 and o["decode_lse"] == dec)}
            line = ""
            if fp8:
                f8 = _rel(o["first8_logits"][:, 0], exact["first8"][lo:hi, 0])
                own8 = _rel(exact["first16_8"][lo:hi, 0],
                            exact["first8"][lo:hi, 0])
                gates[f"{fp8} first step"] = f8 <= TP_STEP_RATIO * own8
                line = (f"; first step on a {fp8} serve cache against the "
                        f"fp32 model on the fp8 values rel {f8:.3e} (limit "
                        f"{TP_STEP_RATIO} x the unsplit {fp8} step's own "
                        f"{own8:.3e} = {TP_STEP_RATIO * own8:.3e})")
            more = ", ".join(k for k, v in gates.items() if not v)
            ar = o["allreduce"]
            log(f"{tag} {cfg16.name} {where_r}: K/V cache {o['cache_bytes']:,}"
                f" B (reckoned {want_b:,}; laid out by heads {heads_b:,}); "
                f"decode launches {dec} in the prefill and {steps} steps, "
                f"{o['decode_lse']} with the lse output; a step: all_reduce "
                f"{ar['calls'] / steps:g} calls {ar['bytes'] / steps:.0f} B, "
                f"all_gather {ar['gather_calls'] / steps:g} calls "
                f"{ar['gather_bytes'] / steps:.0f} B, all_to_all "
                f"{ar['a2a_calls'] / steps:g} calls {ar['a2a_bytes'] / steps:.0f}"
                f" B{line} {'ok' if not more else 'FAIL: ' + more}")
            fail = ", ".join(f for f in (fail, more) if f)
            if fail:
                failed.append(f"{cfg16.name} {where_r}: {fail}")
            for k, v in o["launches"].items():
                counts[k] = counts.get(k, 0) + v
            counts["decode_attention_lse"] = (
                counts.get("decode_attention_lse", 0) + o["decode_lse"])
    if failed:
        raise SystemExit(f"chip_smoke: the sequence-split cache failed a "
                         f"gate: {failed}")
    if cuda:
        log(f"{tag} nvidia-smi: {smi_line()}")
    return dict(counts=counts, tokens=[f[2]["tokens"].tolist()
                                       for f in fams])


# -- sequence-split activations in the prefill step (path ``prefill_seq``) -------
# (a) qwen3-32b's widths at 1 of 64 layers on a (1, 2) mesh, 8 rows
# of a 16384-token prompt in bf16: the residual stream passes 1 GB, so the
# reference's build_rules turns the seq rule on by itself; (b) granite-moe
# (the reference's granite_prefill cell) and zamba2 (one hybrid_period of
# 6, the least depth the hybrid builds at) in fp32 on a (1, 4) mesh with
# the rule switched on through extra_rules, as the reference's hill-climber
# switches it; each against the same step with extra_rules {"seq": None}.
# The serve steps after each prefill run on the cache cut by sequence
# (extra_rules {"cache_seq": ("model",)}), so the decode kernel reads it
# with its log-sum-exp output.
PSEQ_BIG = ("qwen3-32b", (1, 2), 1, 8, 16384)   # arch, mesh, layers, rows, S
PSEQ_SMALL = (("granite-moe-3b-a800m", 4), ("zamba2-2.7b", 6))
PSEQ_SMALL_MESH, PSEQ_SMALL_ROWS, PSEQ_SMALL_PROMPT = (1, 4), 8, 1024
PSEQ_STEPS = 4                # serve steps after (a)'s prefills
PSEQ_SMALL_STEPS = 2          # and after (b)'s
PSEQ_NEW = 16                 # cache positions past the prompt
PSEQ_FP32_TOL = 2e-5          # (b): logits allclose, atol = rtol
SEQ_ON, SEQ_OFF = {"seq": ("model",)}, {"seq": None}
CACHE_CUT = {"cache_seq": ("model",)}


def pseq_rank(mesh, dev, cases: list) -> list:
    """One rank of path ``prefill_seq`` (``run_ranks`` calls it in every
    rank): ``_pseq_case`` for each case in turn."""
    return [_pseq_case(mesh, dev, **case) for case in cases]


def _pseq_run(pre, srv, params, x, steps: int, dev) -> tuple:
    """One prefill step and ``steps`` greedy serve steps: (the greedy
    tokens (B, 1 + steps) on the host, the prefill's cache moved to the
    host, its last-position logits, the rank's peak GB of the prefill,
    the prefill's collectives, its wall seconds)."""
    b = next(iter(x.values())).shape[0]
    cuda = dev.type == "cuda"
    sharder = pre.meta["sharder"]
    sharder.reset_stats()
    _free(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    tok, cache = pre.fn(params, x)
    _sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    stats = dict(sharder.stats)
    logits = pre.last_logits.float().cpu().numpy()
    host = {k: v.cpu() for k, v in cache.items()}
    cache = srv.store_cache(cache)
    cur = tok.reshape(b, 1)
    toks = [cur]
    for _ in range(steps):
        cur, cache = srv.fn(params, cache, cur)
        toks.append(cur)
    toks = torch.cat(toks, 1).cpu().numpy()
    del cache, tok, cur
    return toks, host, logits, peak, stats, wall


def _pseq_case(mesh, dev, cfg, inputs: dict, prompt: int, steps: int,
               seed: int, extra_on) -> dict:
    """One model on one rank: the prefill step with the ``seq`` rule
    (``extra_on`` on top of ``build_rules``; None: ``build_rules`` alone)
    and the same step with ``{"seq": None}``, each followed by ``steps``
    serve steps on the cache cut by sequence, from the same params. The
    seq-off run goes first; the kernel launch counts are zeroed just
    before the seq-on prefill and read after its serve steps."""
    b = inputs["tokens"].shape[0]
    x = _on(inputs, dev)
    max_len = prompt + PSEQ_NEW
    shape = ShapeSpec("prefill_seq", max_len, b, "prefill_step")
    with torch.no_grad():
        pre_on = build_step(cfg, shape, mesh, extra_rules=extra_on,
                            device=dev)
        pre_off = build_step(cfg, shape, mesh, extra_rules=SEQ_OFF,
                             device=dev)
        srv = build_step(cfg, ShapeSpec("serve", max_len, b, "serve_step"),
                         mesh, extra_rules=CACHE_CUT, device=dev)
        params = pre_on.init_params(seed)
        off = _pseq_run(pre_off, srv, params, x, steps, dev)
        ops.reset_launch_counts()
        ssd.reset_bodies()
        on = _pseq_run(pre_on, srv, params, x, steps, dev)
        launches = ops.launch_counts()
        lse = ops.decode_lse_launches()
        model = pre_on.model
        same = {k: bool(torch.equal(on[1][k], off[1][k])) for k in on[1]}
        diff = {k: float((on[1][k].float() - off[1][k].float()).abs().max())
                for k in on[1] if on[1][k].is_floating_point()}
        rows = pre_on.meta["rows"]
        out = dict(rows=(rows.start, rows.stop),
                   rules_seq=pre_on.meta["rules"]["seq"],
                   residual=model.residual_shape,
                   residual_off=pre_off.model.residual_shape,
                   tokens_on=on[0], tokens_off=off[0],
                   logits_on=on[2], logits_off=off[2],
                   peak_on=on[3], peak_off=off[3],
                   stats_on=on[4], stats_off=off[4],
                   wall_on=on[5], wall_off=off[5],
                   cache_equal=same, cache_diff=diff,
                   cache_shapes={k: tuple(v.shape) for k, v in on[1].items()},
                   launches=launches, decode_lse=lse,
                   ssd_bodies=dict(ssd.body_counts),
                   heads=(model.n_heads_local, model.n_kv_local,
                          model.ssm_heads_local))
        del pre_on, pre_off, srv, params, on, off, model
    _free(dev)
    return out


def pseq_reckoning(cfg, data: int, n: int, rows: int, prompt: int,
                   seq: bool) -> dict:
    """The collectives of one rank's prefill step (calls, and the bytes
    this rank puts in), written out from the model code, with the sequence
    cut over ``model`` (``seq``) or whole. Cut: a block that needs the
    whole sequence gathers it first (one all_gather of the rank's slice of
    (rows, S, d), of (rows, S, 2 d) for zamba2's shared block: every
    attention and Mamba2 mixer, every MoE, whose router sees every token,
    an FFN whose columns split); a row-parallel product whose rows split
    (``wo``, ``w_down``, ``w_out``, the MoE's combine) reduce-scatters its
    fp32 partials of (rows, S, d), and the vocab-parallel embedding its
    (rows, S, d) in the model dtype, into the rank's slice; the last
    position's hidden state is one all_reduce of (rows, 1, d). Whole:
    those sums are all_reduces of the same tensors. Both: the
    vocab-parallel logits (rows, Vpad), the Mamba2 gated norm's fp32 sums
    of squares (rows, S, 1) a layer whose SSD heads split, and one
    all_to_all a K/V leaf where the KV heads split (the prompt's K/V of
    the rank's heads padded to the cache's length). A batch split over
    ``data`` adds the MoE's (data, E) int64 queue tables a layer and the
    tokens' (rows x data,) int32 buffer."""
    esz = 2 if cfg.dtype == "bfloat16" else 4
    d, s = cfg.d_model, prompt
    max_len = prompt + PSEQ_NEW

    def split(x):
        return int(n > 1 and x % n == 0)
    heads, ffn, vocab = split(cfg.n_heads), split(cfg.d_ff), split(
        cfg.padded_vocab)
    kv = split(cfg.n_kv_heads) if cfg.n_kv_heads else 0
    whole = rows * s * d
    out = dict.fromkeys(("gather_calls", "gather_bytes", "rs_calls",
                         "rs_bytes", "calls", "bytes", "a2a_calls",
                         "a2a_bytes"), 0)

    def add(kind, calls, nbytes):
        key = "" if kind == "ar" else f"{kind}_"
        out[f"{key}calls"] += calls
        out[f"{key}bytes"] += calls * nbytes

    def row_parallel(calls, nbytes=whole * 4):
        add("rs" if seq else "ar", calls, nbytes)

    def gather(calls, width=d):
        if seq:
            add("gather", calls, rows * s // n * width * esz)
    if vocab:
        row_parallel(1, whole * esz)                    # the embedding
        add("ar", 1, rows * cfg.padded_vocab * esz)     # the logits
    if seq:
        add("ar", 1, rows * d * esz)                    # the last position
    if data > 1:
        add("ar", 1, rows * data * 4)                   # the tokens' rows
    layers, stack = cfg.n_layers, cfg.n_layers
    if cfg.family in ("ssm", "hybrid"):
        ssm = split(cfg.ssm_heads)
        gather(layers)
        row_parallel(layers * ssm)
        add("ar", layers * ssm, rows * s * 4)           # the gated norm
        stack = len(cfg.shared_attn_positions()) if cfg.n_heads else 0
        gather(stack, 2 * d)
        gather(stack * ffn)
        row_parallel(stack * (heads + ffn))
    else:
        moe = int(cfg.n_experts > 0)
        gather(layers * (1 + (ffn or moe)))
        row_parallel(layers * (heads + ffn))
        if moe and data > 1:
            add("ar", layers, data * cfg.n_experts * 8)
    if stack:
        add("a2a", 2 * kv, stack * rows * max_len * (cfg.n_kv_heads // n)
            * cfg.hd * esz)
    return out


def phase_prefill_seq(dev, path: str, depth: int, seed: int,
                      rehearsal: bool, repeats: int,
                      profile_dir: Path | None = None) -> dict:
    """The reference's ``seq`` rule in ``build_step``'s prefill step
    (sequence-split activations, Megatron-style: each block gathers the
    sequence, computes at its local heads or columns and reduce-scatters
    its row-parallel sums into the rank's slice; ``models/transformer.py``)
    on meshes of rank processes on this card (gloo). (a) ``PSEQ_BIG``:
    qwen3-32b's widths at 1 of 64 layers, bf16, 8 rows of a 16384-token
    prompt on (1, 2): ``build_rules`` turns ``seq`` on by itself (8 x
    16400 x 5120 x 2 B = 1.34 GB of residual stream > 1 GB); gates: the
    rule is on, the residual stream a rank holds is half the prompt, the
    greedy tokens of the prefill and ``PSEQ_STEPS`` serve steps equal the
    same step's with ``{"seq": None}``, its prefill logits within
    ``TP_REL`` (2e-2) of max |logit|, each rank's cache bit for bit the
    seq-off one's, the collectives of the prefill (calls and bytes) as
    ``pseq_reckoning`` writes them out; whether the logits are bit-equal
    is printed. (b) ``PSEQ_SMALL``: granite-moe-3b-a800m at 4 layers and
    zamba2-2.7b at 6, fp32, 8 rows of a 1024-token prompt on (1, 4), the
    rule through ``extra_rules``; gates: greedy tokens equal the seq-off
    step's, prefill logits allclose within ``PSEQ_FP32_TOL``, the
    collectives' calls as reckoned. Both: the serve steps on the cache cut
    by sequence (``cache_seq`` forced) launch the contiguous decode with
    its log-sum-exp output, every time. Per rank: peak GB of the prefill
    with and without the rule, prefill wall, collectives."""
    tag = f"[{path}]"
    where = "cuda" if dev.type == "cuda" else "cpu"
    arch, big_mesh, big_layers, big_rows, big_prompt = PSEQ_BIG
    small_mesh, small_rows = PSEQ_SMALL_MESH, PSEQ_SMALL_ROWS
    small_prompt, steps, small_steps = PSEQ_SMALL_PROMPT, PSEQ_STEPS, \
        PSEQ_SMALL_STEPS
    big = dataclasses.replace(get_config(arch), n_layers=big_layers)
    extra_big = None                   # build_rules alone turns it on
    if rehearsal:                      # reduced widths: the rule by hand
        big = get_config(arch).reduced()
        big = dataclasses.replace(big, dtype="bfloat16")
        big_rows, big_prompt, extra_big = 4, 16, SEQ_ON
        small_rows, small_prompt, steps, small_steps = 4, 16, 2, 1
    runs = [("(a)", big, big_mesh, big_rows, big_prompt, steps, extra_big)]
    for name, layers in PSEQ_SMALL:
        cfg = get_config(name)
        cfg = (cfg.reduced() if rehearsal else
               dataclasses.replace(cfg, n_layers=layers, dtype="float32"))
        runs.append(("(b)", cfg, small_mesh, small_rows, small_prompt,
                     small_steps, SEQ_ON))
    counts: dict = {}
    failed = []
    worlds: dict = {}
    for label, cfg, mesh, rows, prompt, st, extra in runs:
        case = dict(cfg=cfg, inputs=tpf_inputs(cfg, rows, prompt, seed),
                    prompt=prompt, steps=st, seed=seed, extra_on=extra)
        worlds.setdefault(mesh, []).append((label, case))
    for mesh, items in worlds.items():
        t1 = time.perf_counter()
        outs = run_ranks(pseq_rank, mesh, TP_AXES, backend="gloo",
                         device=where, args=([c for _, c in items],))
        name = f"mesh (data {mesh[0]}, model {mesh[1]}) gloo"
        log(f"{tag} {name}: {len(outs)} ranks, "
            f"{time.perf_counter() - t1:.1f} s with the ranks' start")
        for rank, per_case in enumerate(outs):
            for (label, case), o in zip(items, per_case):
                fail = pseq_check(tag, f"{name} rank {rank}", dev, label,
                                  case, mesh, o)
                if fail:
                    failed.append(f"{case['cfg'].name} {name} rank {rank}: "
                                  f"{fail}")
                for k, v in o["launches"].items():
                    counts[k] = counts.get(k, 0) + v
                counts["decode_attention_lse"] = (
                    counts.get("decode_attention_lse", 0) + o["decode_lse"])
    if failed:
        raise SystemExit(f"chip_smoke: the seq rule's prefill failed a "
                         f"gate: {failed}")
    if dev.type == "cuda":
        log(f"{tag} nvidia-smi: {smi_line()}")
    return dict(counts=counts)


def pseq_check(tag: str, where: str, dev, label: str, case: dict, mesh,
               o: dict) -> str:
    """Log one model's readings on one rank of ``phase_prefill_seq`` and
    return the gates it fails (an empty string when it passes them)."""
    cfg, prompt = case["cfg"], case["prompt"]
    data, n = mesh
    lo, hi = o["rows"]
    cuda = dev.type == "cuda"
    fp32 = cfg.dtype == "float32"
    tok_eq = bool(np.array_equal(o["tokens_on"], o["tokens_off"]))
    rel = _rel(o["logits_on"], o["logits_off"])
    bits = bool(np.array_equal(o["logits_on"], o["logits_off"]))
    close = bool(np.allclose(o["logits_on"], o["logits_off"],
                             atol=PSEQ_FP32_TOL, rtol=PSEQ_FP32_TOL))
    want_on = pseq_reckoning(cfg, data, n, hi - lo, prompt, True)
    want_off = pseq_reckoning(cfg, data, n, hi - lo, prompt, False)
    keys = ("gather_calls", "rs_calls", "calls", "a2a_calls")

    def calls(stats):
        return {k: stats[k] for k in keys}
    dec = o["launches"].get("decode_attention", 0)
    gates = {"seq rule": o["rules_seq"] == ("model",),
             "residual cut": (o["residual"][1] * n == prompt
                              and o["residual_off"][1] == prompt),
             "tokens": tok_eq,
             "logits": close if fp32 else rel <= TP_REL,
             "collective calls": (calls(o["stats_on"]) == calls(want_on)
                                  and calls(o["stats_off"])
                                  == calls(want_off)),
             "decode with lse": not cuda or (dec > 0
                                             and o["decode_lse"] == dec)}
    if label == "(a)":
        gates["cache bit-equal"] = all(o["cache_equal"].values())
        gates["collective bytes"] = (o["stats_on"] == dict(
            o["stats_on"], **want_on) and o["stats_off"] == dict(
            o["stats_off"], **want_off))
    fail = ", ".join(k for k, v in gates.items() if not v)

    def coll(stats):
        return (f"all_gather {stats['gather_calls']} calls "
                f"{stats['gather_bytes']:,} B, reduce-scatter "
                f"{stats['rs_calls']} calls {stats['rs_bytes']:,} B, "
                f"all_reduce {stats['calls']} calls {stats['bytes']:,} B, "
                f"all_to_all {stats['a2a_calls']} calls "
                f"{stats['a2a_bytes']:,} B")
    peak_on, peak_off = o["peak_on"], o["peak_off"]
    peaks = ("not measured (CPU)" if peak_on is None else
             f"{peak_on:.3f} with the rule, {peak_off:.3f} without")
    log(f"{tag} {label} {cfg.name} {cfg.dtype} {cfg.n_layers} layers "
        f"{where}: rows [{lo}, {hi}) of a {prompt}-token prompt; rules "
        f"seq {o['rules_seq']}; residual stream {tuple(o['residual'])} "
        f"(without the rule {tuple(o['residual_off'])}); heads "
        f"{o['heads']}; tokens (prefill + {case['steps']} steps) == seq "
        f"off {tok_eq}; prefill logits rel {rel:.3e}, bit-equal {bits}, "
        f"allclose {PSEQ_FP32_TOL} {close}; cache bit-equal "
        f"{o['cache_equal']} (max |diff| {o['cache_diff']}); decode "
        f"launches {dec}, {o['decode_lse']} with lse; launches "
        f"{o['launches']}, SSD bodies {o['ssd_bodies']} "
        f"{'ok' if not fail else 'FAIL: ' + fail}")
    log(f"{tag} {label} {cfg.name} {where}: prefill with the rule "
        f"{o['wall_on']:.3f} s, {coll(o['stats_on'])} (reckoned: "
        f"{coll(want_on)}); without {o['wall_off']:.3f} s, "
        f"{coll(o['stats_off'])} (reckoned: {coll(want_off)}); "
        f"peak_mem_GB (prefill) {peaks}")
    return fail


# -- the multi-process pipeline-parallel serve step (path ``pp_ranks``) -----------
# worlds of rank processes, one rank per stage (the mesh's pod coordinate),
# tensor parallel inside a stage over model; every rank on this card over
# gloo (each hop staged through the host). (2, 1, 1) at PP_LAYOUTS[0]'s
# pod_flops (split [5, 3], m 4), on a bf16 and a float8_e4m3fn cache, plus
# fp32 at PPR_FP32_LAYERS; (2, 1, 2) through build_step(serve_pp=True) (the
# even split). With two cards, (2, 1, 1) once more over nccl, one rank a
# card.
PPR_AXES = ("pod", "data", "model")
PPR_WORLDS = ((2, 1, 1), (2, 1, 2))
PPR_STEPS = 8
PPR_BUSY_STEPS = 4            # steps of the device-only profiled pass
PPR_FP32_LAYERS = 2
PPR_LOGIT_REL = 2e-2          # the logits gate if they are not bit-equal


def ppr_rank(mesh, dev, cases: list) -> list:
    """One rank of path ``pp_ranks`` (``run_ranks`` calls it in every rank):
    ``ppr_case`` for each case of its world."""
    return [ppr_case(mesh, dev, **case) for case in cases]


def ppr_shard(srv, cache: dict, s_max: int) -> dict:
    """``srv``'s shard of an unsplit cache that holds only the prompt's
    positions, on its device, zero-padded to ``s_max`` positions (the
    cache the parent's run has) and stored by ``store_cache``."""
    part = srv.shard_cache(cache)
    for key in ("k", "v"):
        t = part[key]
        full = t.new_zeros(t.shape[:3] + (s_max,) + t.shape[4:])
        full[:, :, :, :t.shape[3]] = t
        part[key] = full
    return srv.store_cache(part)


def ppr_case(mesh, dev, cfg, cache: dict, first: np.ndarray, steps: int,
             s_max: int, seed: int, pod_flops, kv_runs: tuple, repeats: int,
             first_step=None) -> dict:
    """This rank's PP stage of ``cfg`` (``init(seed)``'s numbers, the stage
    slice only), built by ``build_pp_serve_step`` with ``pod_flops`` or,
    without, by ``build_step(serve_pp=True)``; for each cache dtype of
    ``kv_runs`` (None: the model's) ``steps`` greedy steps from its shard
    of the unsplit ``cache`` (the prompt's positions, padded to
    ``s_max``: ``ppr_shard``) fed ``first`` (B, 1) first. The gate run
    returns the tokens, the last step's logits (last stage), the launches,
    the decode launches by cache dtype and the hops; with ``repeats``,
    that many timed runs (per step wall and host queue seconds), the peak
    GB and the device busy seconds of a profiled run of
    ``PPR_BUSY_STEPS``. ``first_step`` = (an unsplit cache, tokens (B,
    1)): the logits of one step from its shard. ``seconds``: the rank's
    time in each part."""
    rows = first.shape[0]
    shape = ShapeSpec("pp_ranks", s_max, rows, "serve_step")
    out = {}
    params = None
    with torch.no_grad():
        for kv in kv_runs:
            secs = {}
            t_part = time.perf_counter()

            def lap(name: str) -> None:
                nonlocal t_part
                _sync(dev)
                now = time.perf_counter()
                secs[name] = round(now - t_part, 3)
                t_part = now
            if pod_flops is None:
                srv = build_step(cfg, shape, mesh, serve_pp=True,
                                 kv_cache_dtype=kv, device=dev)
            else:
                srv = build_pp_serve_step(
                    cfg, shape, mesh, None, pod_flops=pod_flops,
                    kv_cache_dtype=kv, device=dev)
            if params is None:
                params = srv.init_params(seed)
            lap("build_init")
            start = ppr_shard(srv, cache, s_max)
            lap("shard")
            first_t = torch.from_numpy(first).to(dev)
            hops = srv.meta["hops"]

            def run(timed: bool = False, n: int = steps) -> tuple:
                c = {k: v.clone() for k, v in start.items()}
                cur, toks, walls, queued = first_t, [], [], []
                _sync(dev)
                for _ in range(n):
                    t0 = time.perf_counter()
                    cur, c = srv.fn(params, c, cur)
                    if timed:
                        queued.append(time.perf_counter() - t0)
                        _sync(dev)
                        walls.append(time.perf_counter() - t0)
                    toks.append(cur)
                _sync(dev)
                return torch.cat(toks, 1).cpu().numpy(), walls, queued

            ops.reset_launch_counts()
            hops.update(dict.fromkeys(hops, 0))
            toks, _, _ = run()
            lap("gate_run")
            last = srv.last_logits
            res = dict(tokens=toks, stage=srv.meta["stage"],
                       split=srv.meta["pp_split"],
                       m=srv.meta["n_microbatches"],
                       rows=(srv.meta["rows"].start, srv.meta["rows"].stop),
                       heads=(srv.model.n_heads_local,
                              srv.model.n_kv_local),
                       logits=None if last is None
                       else last.float().cpu().numpy(),
                       launches=ops.launch_counts(),
                       by_cache_dtype=ops.decode_launches_by_cache_dtype(),
                       hops=dict(hops))
            if repeats:
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                timed = [run(timed=True) for _ in range(repeats)]
                lap("timed_runs")
                res.update(step_wall_s=[w for _, ws, _ in timed for w in ws],
                           host_queue_s=[q for _, _, qs in timed
                                         for q in qs],
                           peak_gb=(torch.cuda.max_memory_allocated(dev)
                                    / 1e9 if dev.type == "cuda" else None))
                if dev.type == "cuda":
                    res["busy_s"], res["busy_wall_s"] = _tp_busy(
                        lambda: run(n=PPR_BUSY_STEPS), dev)
                    lap("profiled_run")
            if first_step is not None:
                full, tokens = first_step
                srv.fn(params, ppr_shard(srv, full, s_max),
                       torch.from_numpy(tokens).to(dev))
                res["first_logits"] = (None if srv.last_logits is None else
                                       srv.last_logits.float().cpu().numpy())
                lap("first_step")
            res["seconds"] = secs
            out[kv or cfg.dtype] = res
            del start
            _free(dev)
    return out


def ppr_prompt_part(cache: dict, prompt_len: int) -> dict:
    """An unsplit contiguous cache's K/V at the prompt's positions only,
    and its ``pos``, on the host: what the parent sends its ranks (the
    rest of the cache is zeros, which ``ppr_shard`` restores)."""
    out = {k: cache[k][:, :, :prompt_len].cpu() for k in ("k", "v")}
    out["pos"] = cache["pos"].cpu()
    return out


def ppr_in_process(model, params, full: dict, first, pod_flops, kv,
                   steps: int, prompt_len: int, dev) -> dict:
    """The in-process ``build_pp_serve_step`` of the same split, m and
    cache on this card (every stage here): its tokens (B, steps) and the
    last step's logits (B, 1, Vpad), microbatch order."""
    cfg = model.cfg
    rows, s_max = first.shape[0], full["k"].shape[2]
    step, meta = build_pp_serve_step(
        cfg, ShapeSpec("pp_ranks", s_max, rows, "serve_step"),
        len(pod_flops), devices=[dev] * len(pod_flops),
        pod_flops=pod_flops, kv_cache_dtype=kv)
    split, m = meta["pp_split"], meta["n_microbatches"]
    seen: list = []
    head = meta["model"].logits
    meta["model"].logits = lambda p, x: seen.append(head(p, x)) or seen[-1]
    kvs = {k: astype(full[k], FP8_DTYPES[kv]) if kv else full[k]
           for k in ("k", "v")}
    cache = {k: pp_layout_kv(kvs[k], split, m) for k in ("k", "v")}
    cache["pos"] = torch.tensor(prompt_len, dtype=torch.int32, device=dev)
    packed = pack_pp_params(params, split)
    cur, toks = first.to(dev), []
    with torch.no_grad():
        for _ in range(steps):
            seen.clear()
            cur, cache = step(packed, cache, cur)
            toks.append(cur)
    out = dict(tokens=torch.cat(toks, 1).cpu().numpy(), split=split, m=m,
               logits=torch.cat(seen).float().cpu().numpy())
    del cache, packed, kvs
    _free(dev)
    return out


def phase_pp_ranks_path(dev, path: str, depth: int, seed: int,
                        rehearsal: bool, repeats: int,
                        profile_dir: Path | None = None) -> dict:
    """The multi-process pipeline-parallel serve step (``launch/steps.py``'s
    ``build_step(serve_pp=True)`` and ``launch/pipeline.py``'s
    ``build_pp_serve_step`` on a mesh with a ``pod`` axis): Qwen3-32B
    widths at ``depth`` layers, bf16, random weights (``init(seed)``), 8
    rows of one 1024-token prompt prefilled by the unsplit ``LM.prefill``
    on this card (cache ``MAX_LEN``); its cache and first tokens go to
    every rank, which keeps its stage's layers of it, its rows and KV
    heads. World (2, 1, 1) at ``PP_LAYOUTS[0]``'s pod_flops runs
    ``PPR_STEPS`` steps on the bf16 cache and on the cache stored in
    float8_e4m3fn, plus the fp32 model at ``PPR_FP32_LAYERS``; world (2,
    1, 2) runs the bf16 steps and one step from the unsplit fp32
    prefill's cache as bf16 stores it. Gates: (2, 1, 1) tokens equal to
    the in-process PP step of the same split, m and cache on this card
    (bf16 and e4m3fn), the last stage's last-step logits bit-equal to it
    (else within ``PPR_LOGIT_REL`` of max |logit|, reported); fp32 tokens
    equal to the unsplit decode run one microbatch at a time; (2, 1, 2):
    the first step's logits at most ``TP_STEP_RATIO`` times as far from
    the unsplit fp32 LM as the unsplit bf16 LM's (path ``tp``'s gate);
    every stage rank launches ``decode_attention`` m x split[stage] times
    a step, every launch on the run's cache dtype, and sends / receives m
    hops a step. Prints per world, run and rank the step wall, host queue
    time, device busy, launches, hops and bytes a step and peak GB. With
    two cards, (2, 1, 1) once more over nccl, one rank a card."""
    arch = PATHS[path][0]
    required = PATHS[path][2]
    tag = f"[{path}]"
    base = get_config(arch)
    flops = PP_LAYOUTS[0][1]
    if rehearsal:
        cfg32 = base.reduced()
        cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
        rows, prompt_len, steps, s_max = PP_ROWS, 6, 4, 16
    else:
        cfg16 = dataclasses.replace(base, n_layers=depth)
        cfg32 = dataclasses.replace(base, n_layers=PPR_FP32_LAYERS,
                                    dtype="float32")
        rows, prompt_len, steps, s_max = (PP_ROWS, PP_PROMPT, PPR_STEPS,
                                          MAX_LEN)
    t_start = time.perf_counter()
    prompt = np.random.RandomState(seed).randint(
        0, cfg16.vocab, (rows, prompt_len)).astype(np.int32)
    host = {}
    for cfg in (cfg32, cfg16):
        model = build_model(cfg, device=dev)
        params = model.init(seed=seed)
        with torch.no_grad():
            logits, full = model.prefill(params, _on({"tokens": prompt},
                                                     dev), max_len=s_max)
            first = model.sample_greedy(logits).reshape(rows, 1).to(
                torch.int32)
            ref = {"cache": ppr_prompt_part(full, prompt_len),
                   "first": first.cpu().numpy()}
            if cfg is cfg32:
                m = build_pp_serve_step(
                    cfg, ShapeSpec("pp_ranks", s_max, rows, "serve_step"),
                    2, devices=[dev] * 2,
                    pod_flops=flops)[1]["n_microbatches"]
                ref["tokens"] = pp_unsplit_reference(
                    model, params, full, first, m, steps)[0].cpu().numpy()
            else:
                for kv in (None, "float8_e4m3fn"):
                    ref[kv] = ppr_in_process(model, params, full, first,
                                             flops, kv, steps, prompt_len,
                                             dev)
        host[cfg.dtype] = ref
        del model, params, full, logits
        _free(dev)
    exact = tp_fp32_reference(cfg16, dev, {"tokens": prompt}, seed, s_max)
    exact["cache"] = ppr_prompt_part(exact["cache"], prompt_len)
    log(f"{tag} {base.name} widths; fp32 at {cfg32.n_layers} layers, "
        f"{cfg16.dtype} at {cfg16.n_layers} of {base.n_layers}; {rows} rows "
        f"of a {prompt_len}-token prompt, cache S={s_max}, {steps} steps; "
        f"unsplit prefills, the in-process PP step and the fp32 yardstick "
        f"on this card {time.perf_counter() - t_start:.1f} s")
    h16, h32 = host[cfg16.dtype], host[cfg32.dtype]
    kv_runs = (None, "float8_e4m3fn")

    def world_cases(shape3) -> list:
        bf16 = dict(cfg=cfg16, cache=h16["cache"], first=h16["first"],
                    steps=steps, s_max=s_max, seed=seed, repeats=repeats)
        if shape3[2] > 1:                    # TP inside a stage: even split
            return [dict(bf16, pod_flops=None, kv_runs=(None,),
                         first_step=(exact["cache"], exact["tokens"]))]
        return [dict(cfg=cfg32, cache=h32["cache"], first=h32["first"],
                     steps=steps, s_max=s_max, seed=seed, pod_flops=flops,
                     kv_runs=(None,), repeats=0),
                dict(bf16, pod_flops=flops, kv_runs=kv_runs)]

    runs = [(w, "gloo", "cuda" if dev.type == "cuda" else "cpu")
            for w in PPR_WORLDS]
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards >= 2:
        runs.append(((2, 1, 1), "nccl", "cuda"))
    counts: dict = {}
    by_dtype: dict = {}
    failed = []
    for shape3, backend, where in runs:
        t1 = time.perf_counter()
        outs = run_ranks(ppr_rank, shape3, PPR_AXES, backend=backend,
                         device=where, args=(world_cases(shape3),))
        world = f"mesh (pod {shape3[0]}, data {shape3[1]}, model " \
                f"{shape3[2]}) {backend}"
        log(f"{tag} {world}: {len(outs)} ranks, "
            f"{time.perf_counter() - t1:.1f} s with the ranks' start")
        for rank, per_case in enumerate(outs):
            for case in per_case:
                for run_name, o in case.items():
                    ok, what = ppr_gate(o, run_name, shape3, cfg16, h16,
                                        h32, exact, required, steps, dev)
                    if not ok:
                        failed.append(f"{world} rank {rank} {run_name}")
                    log(f"{tag} {world} rank {rank} stage {o['stage']} "
                        f"{run_name}: split {o['split']} m {o['m']} rows "
                        f"{o['rows']} heads {o['heads'][0]}/"
                        f"{o['heads'][1]}; {what} "
                        f"{'ok' if ok else 'FAIL'}")
                    ppr_report(tag, f"{world} rank {rank} {run_name}", o,
                               steps)
                    if backend != "gloo":
                        continue
                    for k, v in o["launches"].items():
                        counts[k] = counts.get(k, 0) + v
                    for k, v in o["by_cache_dtype"].items():
                        by_dtype[k] = by_dtype.get(k, 0) + v
    if failed:
        raise SystemExit(f"chip_smoke: the multi-process PP step disagrees "
                         f"or missed a kernel on {failed}")
    if n_cards < 2:
        log(f"{tag} (2, 1, 1) over nccl did not run: it needs two cards, "
            f"one rank each (NCCL refuses two ranks on one device); this "
            f"machine has {n_cards}")
    if dev.type == "cuda":
        log(f"{tag} nvidia-smi: {smi_line()}")
    log(f"{tag} {time.perf_counter() - t_start:.1f} s")
    return dict(counts=counts, tokens=h16[None]["tokens"].tolist(),
                by_cache_dtype=by_dtype)


def ppr_gate(o: dict, run_name: str, shape3, cfg16, h16: dict, h32: dict,
             exact: dict, required, steps: int, dev) -> tuple:
    """(passed, what was read) for one rank's run of ``phase_pp_ranks_path``
    (module docstring of the phase)."""
    s, n, m = o["stage"], o["split"][o["stage"]], o["m"]
    last = s == shape3[0] - 1
    notes = []
    ok = o["heads"] == (cfg16.n_heads // shape3[2],
                        cfg16.n_kv_heads // shape3[2])
    want_hops = dict(sends=steps * m if not last else 0,
                     recvs=steps * m if s > 0 else 0)
    ok &= all(o["hops"][k] == v for k, v in want_hops.items())
    if run_name == "float32":
        same = bool(np.array_equal(o["tokens"], h32["tokens"]))
        ok &= same
        notes.append(f"fp32 tokens == the unsplit decode (one microbatch at "
                     f"a time) {same}")
    elif shape3[2] == 1:
        kv = None if run_name == "bfloat16" else run_name
        ref = h16[kv]
        same = bool(np.array_equal(o["tokens"], ref["tokens"]))
        ok &= same and o["split"] == ref["split"] and m == ref["m"]
        notes.append(f"tokens over {steps} steps == the in-process PP step's "
                     f"{same}")
        if last:
            equal = bool(np.array_equal(o["logits"], ref["logits"]))
            rel = _rel(o["logits"], ref["logits"])
            ok &= equal or rel <= PPR_LOGIT_REL
            notes.append(f"last step's logits bit-equal {equal} (rel "
                         f"{rel:.3e}, limit if not {PPR_LOGIT_REL})")
    else:
        same = bool(np.array_equal(o["tokens"], h16[None]["tokens"]))
        notes.append(f"tokens == the in-process [5, 3] step's {same} (not "
                     f"gated: another split, TP sums)")
        if last:
            first = _rel(o["first_logits"][:, 0], exact["first"][:, 0])
            own = _rel(exact["first16"][:, 0], exact["first"][:, 0])
            ok &= first <= TP_STEP_RATIO * own
            notes.append(f"first step on the fp32 prefill's cache as bf16 "
                         f"stores it, against the fp32 LM rel {first:.3e} "
                         f"(limit {TP_STEP_RATIO} x the unsplit bf16 LM's "
                         f"own {own:.3e})")
    if dev.type == "cuda":
        want = steps * m * n
        dec = o["launches"]["decode_attention"]
        dtype = "bfloat16" if run_name == "bfloat16" else run_name
        on = o["by_cache_dtype"]
        ok &= (dec == want and all(o["launches"][k] for k in required)
               and on == {dtype: want})
        notes.append(f"decode_attention {dec} launches (m x split[stage] x "
                     f"steps = {want}), by cache dtype {on}")
    return ok, "; ".join(notes)


def ppr_report(tag: str, name: str, o: dict, steps: int) -> None:
    """Log one rank's timed readings of ``phase_pp_ranks_path``."""
    hops = o["hops"]
    line = (f"{tag} {name}: hops a step {hops['sends'] / steps:g} sends, "
            f"{hops['recvs'] / steps:g} receives, "
            f"{hops['bytes'] / steps:.0f} bytes sent; decode_attention a "
            f"step {o['launches']['decode_attention'] / steps:g}")
    if "step_wall_s" in o:
        walls = sorted(o["step_wall_s"])
        per_step = float(np.median(walls))
        queue = float(np.median(o["host_queue_s"]))
        busy = "not measured (CPU)"
        if "busy_s" in o:
            busy = (f"{o['busy_s'] / (per_step * PPR_BUSY_STEPS):.3f} "
                    f"({o['busy_s']:.4f} s of device time in a profiled "
                    f"run of {PPR_BUSY_STEPS} steps; against its "
                    f"{o['busy_wall_s']:.3f} s wall "
                    f"{o['busy_s'] / o['busy_wall_s']:.3f})")
        peak = o["peak_gb"]
        line += (f"; step_wall_s median={per_step:.5f} min={walls[0]:.5f} "
                 f"max={walls[-1]:.5f} over {len(walls)} steps; "
                 f"host_queue_s median={queue:.5f}; out_tok_per_s="
                 f"{len(o['tokens']) / per_step:.2f}; device_busy_share="
                 f"{busy}; peak_mem_GB="
                 f"{'not measured (CPU)' if peak is None else round(peak, 3)}")
    log(line + f"; rank seconds {o['seconds']}")


# -- the cluster simulator (phase ``cluster``, host only) -----------------------
CLUSTER_WINDOW_MIN, CLUSTER_RATE = 50, 3.0


def phase_cluster(seed: int) -> None:
    """The port's ``ClusterSim`` on the paper's qwen3-32b cluster
    (``populate_cluster`` over ``paper_cluster``) for the worst
    ``CLUSTER_WINDOW_MIN``-minute interruption window of a ``PAPER_POOLS``
    trace (``select_scenario``), azure-conversation-like traffic at
    ``CLUSTER_RATE`` req/s: the closed form, then the discrete-event run
    on a ``Topology`` in which each pipeline has a store link of its own.
    The parity gate of tests/test_cluster_des.py: on idle links (checked:
    no transfer waited) the DES equals the closed form to 1e-6 in rps,
    downtime and cost, with the same completions and interruptions."""
    t0 = time.perf_counter()
    spec, plan = paper_plan()
    trace = generate_trace(PAPER_POOLS, minutes=2000, seed=seed)
    start, score, _ = select_scenario(trace, dur_min=CLUSTER_WINDOW_MIN)
    events = interruption_events_for_window(trace, start, CLUSTER_WINDOW_MIN)
    dur = CLUSTER_WINDOW_MIN * 60.0
    reqs = azure_conversation_like(duration_s=dur, rate_rps=CLUSTER_RATE,
                                   seed=seed)
    regions = [f"p{i}" for i in range(len(plan.pipelines))]
    base = ClusterSim(spec, plan.pipelines, FTConfig(),
                      regions=regions).run(reqs, dur, events=events)
    des = ClusterSim(spec, plan.pipelines, FTConfig(), network=Topology(),
                     regions=regions).run(reqs, dur, events=events)
    idle = all(v["wait_s"] == 0.0 for v in des.link_stats.values())
    close = all(abs(a - b) <= 1e-6 for a, b in (
        (des.rps, base.rps), (des.total_downtime_s, base.total_downtime_s),
        (des.cost_usd, base.cost_usd)))
    ok = (idle and close and len(des.completed) == len(base.completed)
          and des.interruptions == base.interruptions)
    for tag, r in (("closed form", base), ("DES, idle links", des)):
        log(f"[cluster] {tag}: rps={r.rps:.6f} cost_usd={r.cost_usd:.6f} "
            f"downtime_s={r.total_downtime_s:.6f} interruptions="
            f"{r.interruptions} completed={len(r.completed)} transfers="
            f"{r.transfers}")
    log(f"[cluster] {len(plan.pipelines)} pipelines "
        f"{[p.describe() for p in plan.pipelines]}; window start "
        f"{start} min (score {score}), {len(events)} pool events, "
        f"{len(reqs)} requests; links {des.link_stats}; idle {idle}; DES "
        f"== closed form {close}; {time.perf_counter() - t0:.1f} s host "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: the cluster simulator's DES differs "
                         "from its closed form on idle links")


# serving paths with a driver of their own (the rest run ``phase_path``)
# -- fp8 KV caches in build_step's serve step (path ``kv_fp8``) --------------------
KV_FP8_ROWS, KV_FP8_PROMPT, KV_FP8_STEPS = 8, 1024, 32
KV_FP8_FORMATS = (None, "float8_e4m3fn", "float8_e5m2")   # None: bf16
# the first step on an fp8 cache against the bf16 serve step on a bf16
# cache holding the fp8 cache's values upcast: the two differ only where
# each layer's new K/V, which the token then attends, is rounded to fp8.
# Limit: the format's unit roundoff, 2^-(mantissa bits + 1), of max
# |logit| (2e-2 does not hold at this random-weight depth: float8_e4m3fn
# reads 2.262e-2 on an H100 80GB HBM3, PERF.md section 6)
KV_FP8_REL = {"float8_e4m3fn": 2.0 ** -4, "float8_e5m2": 2.0 ** -3}


def _kv_bytes_of(cache: dict) -> int:
    return sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v"))


def phase_kv_fp8_path(dev, path: str, depth: int, seed: int,
                      rehearsal: bool, repeats: int,
                      profile_dir: Path | None = None) -> dict:
    """fp8 KV caches (``kv_cache_dtype``) in ``build_step``'s serve step:
    main's widths at ``depth`` layers, bf16, random weights, on a (1, 1)
    mesh in this process; 8 rows of one 1024-token prompt through the
    prefill step (cache S ``MAX_LEN``), stored by each serve step's
    ``store_cache``, then ``KV_FP8_STEPS`` greedy serve steps on a bf16,
    a float8_e4m3fn and a float8_e5m2 cache, in turns (``repeats`` timed
    runs after an untimed gate run, each from a fresh copy of the
    prefill's cache). Gates: each run launches ``decode_attention``
    exactly layers x steps times, every one on the run's cache dtype; the
    first step's logits on an fp8 cache lie within ``KV_FP8_REL`` (the
    format's unit roundoff) of max |logit| of the bf16 serve step on a
    bf16 cache holding the fp8 values upcast; the fp8 cache's K/V bytes
    are exactly half the bf16 one's. Printed, not gated: step wall median,
    tok/s, device busy, peak GB, the first step whose greedy tokens leave
    the bf16 run's and the largest logit distance over the steps."""
    arch, _, required = PATHS[path]
    tag = f"[{path}]"
    if rehearsal:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="bfloat16")
        rows, prompt_len, steps, s_max = KV_FP8_ROWS, 6, 4, 16
    else:
        cfg = dataclasses.replace(get_config(arch), n_layers=depth)
        rows, prompt_len, steps, s_max = (KV_FP8_ROWS, KV_FP8_PROMPT,
                                          KV_FP8_STEPS, MAX_LEN)
    mesh = mesh_for_rank((1, 1), ("data", "model"), 0)
    pre = build_step(cfg, ShapeSpec(path, s_max, rows, "prefill_step"), mesh,
                     device=dev)
    srv = {fmt: build_step(cfg, ShapeSpec(path, s_max, rows, "serve_step"),
                           mesh, kv_cache_dtype=fmt, device=dev)
           for fmt in KV_FP8_FORMATS}
    params = pre.init_params(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, (rows, prompt_len), generator=gen,
                           device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        tok, full = pre.fn(params, {"tokens": prompt})
    first = tok.reshape(rows, 1)
    _sync(dev)
    counts = ops.launch_counts()
    if dev.type == "cuda" and counts["flash_attention"] != cfg.n_layers:
        raise SystemExit(f"chip_smoke: {path}'s prefill step launched "
                         f"{counts} (flash_attention: one a layer)")
    log(f"{tag} {cfg.name} widths, {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, {cfg.dtype}; build_step on a "
        f"(1, 1) mesh; {rows} rows of a {prompt_len}-token prompt through "
        f"the prefill step, cache S={s_max}; {steps} serve steps a run on "
        f"{[f or 'bfloat16' for f in KV_FP8_FORMATS]} caches in turns; "
        f"the prefill step's launches {counts}")

    def fresh(fmt) -> dict:
        return srv[fmt].store_cache({k: v.clone() for k, v in full.items()})

    # gate: the first step on an fp8 cache against the bf16 step on its
    # values upcast
    nbytes = {None: _kv_bytes_of(fresh(None))}
    with torch.no_grad():
        for fmt in KV_FP8_FORMATS[1:]:
            c8 = fresh(fmt)
            nbytes[fmt] = _kv_bytes_of(c8)
            c16 = {k: v.to(pre.model.dtype) if k in ("k", "v") else v.clone()
                   for k, v in c8.items()}
            srv[fmt].fn(params, c8, first)
            srv[None].fn(params, c16, first)
            l8 = srv[fmt].last_logits.float()
            l16 = srv[None].last_logits.float()
            rel = ((l8 - l16).abs().max() / l16.abs().max()).item()
            half = nbytes[fmt] * 2 == nbytes[None]
            log(f"{tag} {fmt}: first step's logits from the bf16 step on "
                f"the fp8 values upcast {rel:.3e} of max |logit| (limit "
                f"{KV_FP8_REL[fmt]:g}); K/V bytes {nbytes[fmt]:,} vs bf16 "
                f"{nbytes[None]:,}, exactly half: {half}")
            if not (rel <= KV_FP8_REL[fmt] and half):
                raise SystemExit(f"chip_smoke: the {fmt} serve step fails "
                                 f"its first-step or bytes gate")
            del c8, c16

    def run(fmt, keep: bool = False) -> dict:
        cache = fresh(fmt)
        cur, toks, logits = first, [], []
        ops.reset_launch_counts()
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            for _ in range(steps):
                cur, cache = srv[fmt].fn(params, cache, cur)
                toks.append(cur)
                if keep:
                    logits.append(srv[fmt].last_logits.float())
        _sync(dev)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None)
        return dict(wall=wall, counts=ops.launch_counts(),
                    by_dtype=ops.decode_launches_by_cache_dtype(),
                    tokens=torch.cat(toks, 1), logits=logits, peak=peak)

    want = cfg.n_layers * steps
    gate = {fmt: run(fmt, keep=True) for fmt in KV_FP8_FORMATS}
    runs = {fmt: [] for fmt in KV_FP8_FORMATS}
    for r in range(repeats):
        for fmt in (KV_FP8_FORMATS if r % 2 == 0 else KV_FP8_FORMATS[::-1]):
            runs[fmt].append(run(fmt))
    base = gate[None]
    by_dtype: dict = {}
    for fmt in KV_FP8_FORMATS:
        name = fmt or "bfloat16"
        r0 = runs[fmt][0] if runs[fmt] else gate[fmt]
        ok = (r0["counts"]["decode_attention"] == want
              and r0["by_dtype"] == {name: want})
        if dev.type == "cuda" and not ok:
            raise SystemExit(f"chip_smoke: {path} {name}: decode_attention "
                             f"launched {r0['by_dtype']}, not {want} on "
                             f"{name}")
        for k, v in r0["counts"].items():
            counts[k] = counts.get(k, 0) + v
        for k, v in r0["by_dtype"].items():
            by_dtype[k] = by_dtype.get(k, 0) + v
        walls = sorted(r["wall"] / steps for r in runs[fmt]) or [
            gate[fmt]["wall"] / steps]
        per_step = float(np.median(walls))
        g = gate[fmt]
        same = (g["tokens"] == base["tokens"]).all(dim=0)
        leave = (int((~same).nonzero()[0, 0]) if not bool(same.all())
                 else None)
        dist = [((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(g["logits"], base["logits"])]
        busy = peak = "not measured (CPU)"
        if dev.type == "cuda":
            peak = f"{max(r['peak'] for r in runs[fmt] or [g]):.3f}"
            busy_s, wall_s = _busy_s(lambda fmt=fmt: run(fmt), dev)
            busy = (f"{busy_s / (per_step * steps):.3f} ({busy_s:.4f} s of "
                    f"device time in a run; profiled run's wall "
                    f"{wall_s:.3f} s)")
        log(f"{tag} {name}: step_wall_s median={per_step:.5f} min="
            f"{walls[0]:.5f} max={walls[-1]:.5f} over {len(walls)} runs of "
            f"{steps} steps (formats in turns); out_tok_per_s="
            f"{rows / per_step:.2f}; device_busy_share={busy}; peak_mem_GB="
            f"{peak}; K/V bytes {nbytes[fmt]:,}; decode_attention by cache "
            f"dtype a run {r0['by_dtype']}; launches a run {r0['counts']}")
        if fmt is not None:
            log(f"{tag} {name}: greedy tokens leave the bf16 run's at step "
                f"{leave} of {steps}; largest logit distance from the bf16 "
                f"run over the steps {max(dist):.3e} of max |logit| (before "
                f"the tokens leave: "
                f"{max(dist[:leave + 1] if leave is not None else dist):.3e})")
    if dev.type == "cuda":
        log(f"{tag} nvidia-smi: {smi_line()}")
    tokens = {f or "bfloat16": gate[f]["tokens"].tolist()
              for f in KV_FP8_FORMATS}
    del params, full, gate, runs, pre, srv
    _free(dev)
    return dict(counts=counts, tokens=tokens, by_cache_dtype=by_dtype)


PATH_PHASE = {"server": phase_server_path, "pp": phase_pp_path,
              "pp_ranks": phase_pp_ranks_path, "tp": phase_tp_path,
              "tp_families": phase_tp_families, "tp_seq": phase_tp_seq,
              "prefill_seq": phase_prefill_seq,
              "kv_fp8": phase_kv_fp8_path}


def check_paths(res: dict) -> None:
    """Across paths: the sanitizer's poison writes and probes are
    output-neutral (the sanitize path, main's model, params and traffic,
    emits main's greedy tokens); the legacy path's admission beside
    contig's (the same model, params and traffic)."""
    if "main" in res and "sanitize" in res:
        same = res["sanitize"]["tokens"] == res["main"]["tokens"]
        log(f"[sanitize] greedy tokens identical to main's: {same}")
        if not same:
            raise SystemExit("chip_smoke: the sanitize path's tokens differ "
                             "from the main path's")
    if "legacy" in res and "contig" in res:
        leg, con = res["legacy"], res["contig"]
        pairs = [(a, b) for ta, tb in zip(leg["tokens"], con["tokens"])
                 for a, b in zip(ta, tb)]
        log(f"[legacy] admit_s median={leg['admit_s']:.3f} "
            f"prefill_retraces={leg['stats']['prefill_retraces']} "
            f"prefill_batches={leg['stats']['prefill_batches']}; contig "
            f"admit_s median={con['admit_s']:.3f} prefill_retraces="
            f"{con['stats']['prefill_retraces']} prefill_batches="
            f"{con['stats']['prefill_batches']}; equal tokens "
            f"{sum(a == b for a, b in pairs)}/{len(pairs)}")


# -- phase 4b: training, card vs CPU -----------------------------------------------
TRAIN_PARITY = ("qwen3-32b", "granite-moe-3b-a800m", "qwen2-vl-2b",
                "whisper-tiny", "mamba2-1.3b", "zamba2-2.7b")
# the kernels each parity case must launch on the card, and its model
# keywords: SSD chunks of 12, so 32 tokens walk two full chunks and a
# ragged one of 8
FLASH = ("flash_attention", "flash_attention_bwd")
SSD = ("ssd_scan", "ssd_scan_bwd")
TRAIN_NEED = {"mamba2-1.3b": SSD, "zamba2-2.7b": SSD + FLASH}
TRAIN_MODEL_KW = {"mamba2-1.3b": {"ssd_chunk": 12},
                  "zamba2-2.7b": {"ssd_chunk": 12}}
# the parity steps run the reference's AdamW defaults (lr warming up from
# 3e-6) without the bf16 gradient compression: Adam's first steps move
# each weight by ~lr x sign(g), so a weight whose gradient lies within the
# two devices' rounding of 0 may move the other way (~1e-5 of a weight at
# the defaults, under the limit), and a gradient within an fp32 ulp of a
# bf16 rounding boundary rounds to the next bf16 value on one device only
# (2^-8 of the element). The first moment m, linear in the fp32
# gradients, is held too. Compression is held to the reference on the CPU
# (tests/test_torch_train_step.py).
PARITY_OPT = AdamWConfig(compress_grads_bf16=False)
# the train path's: the reference's defaults too (lr 3e-4 reached after
# 100 warm-up steps). Without the warm-up a fresh 1.9 B model oscillates
# (lr 1e-3: 11.31 -> 17.13 by step 3; 1e-4: 11.31, 9.71, 14.41, 8.22;
# NVIDIA H100 80GB HBM3, 700 W)
TRAIN_OPT = AdamWConfig()


def _max_rel(tree, ref, floor: float = 1e-7) -> tuple:
    """Over the leaves, the largest max|a - b| / (max|b| + floor / 1e-4)
    (at most 1e-4 passes: 1e-4 of the leaf's largest element, plus an
    absolute floor for leaves whose exact gradient is 0, a key bias, where
    both devices hold rounding noise), and its leaf's index."""
    errs = [(a.cpu() - b).abs().max().item()
            / (b.abs().max().item() + floor / 1e-4)
            for a, b in zip(leaves(tree), leaves(ref))]
    return max(errs), int(np.argmax(errs))


def _train_run(cfg, params, dev, steps, n_micro, state=None):
    """``steps`` train steps of reduced ``cfg`` on ``dev`` from ``params``
    (or ``state``): (losses, the state)."""
    model = build_model(cfg, device=dev, **TRAIN_MODEL_KW.get(cfg.name, {}))
    state = state or init_train_state(
        _tree_map(params, lambda t: t.to(dev, copy=True)))
    step_fn = make_train_step(model, PARITY_OPT, n_micro)
    data = SyntheticLM(cfg, DataConfig(4, 32, 0))
    losses = []
    for s in range(state.opt.step, state.opt.step + steps):
        state, m = step_fn(state, to_torch(data.batch_at(s), dev))
        losses.append(m["loss"].item())
    return losses, state


def phase_train_parity(dev) -> None:
    """Two fp32 train steps (2 microbatches, the reference's AdamW
    defaults but for the bf16 compression) of reduced qwen3-32b,
    granite-moe, qwen2-vl-2b, whisper-tiny, mamba2-1.3b and zamba2-2.7b
    (SSD chunks of 12) on the card and on the CPU from one init: the
    loss, every parameter and every first moment within 1e-4 relative (of
    the leaf's largest element, + 1e-7); the card's steps launch the
    flash forward and backward, and for the recurrent families the SSD
    scan and its backward. Then a checkpoint of the card's state after
    step 2, restored into a fresh state on the card: its step 3 loss
    equals the uninterrupted run's within 1e-6 relative."""
    card = dev.type == "cuda"
    ck_dir = ROOT / "build" / "chip_smoke_ckpt"
    for arch in TRAIN_PARITY:
        cfg = get_config(arch).reduced()
        params = build_model(cfg, device="cpu").init(seed=0)
        ops.reset_launch_counts()
        got, state = _train_run(cfg, params, dev, 2, 2)
        counts = ops.launch_counts()
        ref, ref_state = _train_run(cfg, params, "cpu", 2, 2)
        worst, at = _max_rel(state.params, ref_state.params)
        worst_m, at_m = _max_rel(state.opt.m, ref_state.opt.m)
        names = [n for n, _ in ckpt._flatten(ref_state.params)]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, ref))
        need = TRAIN_NEED.get(arch, FLASH)
        launched = all(counts[k] for k in need)
        ok = (worst <= 1e-4 and worst_m <= 1e-4 and loss_err <= 1e-4
              and (launched or not card))
        shutil.rmtree(ck_dir, ignore_errors=True)
        ckpt.save_checkpoint(str(ck_dir), 2, state)
        fresh = init_train_state(build_model(cfg, device=dev).init(seed=1))
        restored = ckpt.restore_checkpoint(str(ck_dir), 2, fresh)
        shutil.rmtree(ck_dir, ignore_errors=True)
        resumed, _ = _train_run(cfg, None, dev, 1, 2, state=restored)
        whole, _ = _train_run(cfg, None, dev, 1, 2, state=state)
        resume_err = abs(resumed[0] - whole[0]) / abs(whole[0])
        ok = ok and resume_err <= 1e-6
        log(f"[train-parity] {arch}: losses {got} vs CPU {ref} (max rel "
            f"{loss_err:.2e}); params max rel {worst:.2e} ({names[at]}), "
            f"m max rel {worst_m:.2e} ({names[at_m]}); launches "
            f"{ {k: counts[k] for k in need} }; checkpoint at step 2 -> "
            f"step 3 loss {resumed[0]:.6f} vs uninterrupted {whole[0]:.6f} "
            f"(rel {resume_err:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"chip_smoke: training on the card disagrees "
                             f"with the CPU ({arch})")


# -- phase 6: training at full width --------------------------------------------------
# (arch, timed steps after one warm-up, kernels that must launch): the
# dense case and the recurrent one. mamba2's step is about twice
# internlm2's, so it times four steps to keep the run inside its limit
TRAIN_CASES = {"train": ("internlm2-1.8b", 6, FLASH),
               "train_mamba2": ("mamba2-1.3b", 4, SSD)}
TRAIN_BATCH, TRAIN_SEQ = 8, 2048


def phase_train(dev, case: str, seed: int, rehearsal: bool,
                profile_dir: Path | None = None) -> dict:
    """One ``TRAIN_CASES`` model whole (internlm2-1.8b: 24 layers, d_model
    2048, 16/8 heads of 128, vocab 92544; mamba2-1.3b: 48 layers, d_model
    2048, 64 SSD heads of 64, N 128, vocab 50280), bf16, ``remat`` on,
    ``SyntheticLM(8, 2048, seed 0)`` in ``choose_microbatches(8, 2048,
    vocab, 1)`` microbatches, the reference's AdamW defaults: one warm-up
    step and the case's timed ones, each with launch counts zeroed just
    before and read just after. The loss must stay finite and fall and the
    case's kernels must launch; no checkpoint is written at this width."""
    tag = f"[{case}]"
    arch, steps, need = TRAIN_CASES[case]
    cfg = get_config(arch)
    batch, seq = TRAIN_BATCH, TRAIN_SEQ
    if rehearsal:
        cfg, batch, seq = cfg.reduced(), 4, 32
    n_micro = choose_microbatches(batch, seq, cfg.vocab, 1)
    model = build_model(cfg, device=dev, remat=True)
    t0 = time.perf_counter()
    state = init_train_state(model.init(seed=seed))
    _sync(dev)
    n_params = model.param_count()
    heads = (f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, N "
             f"{cfg.ssm_state}" if cfg.family == "ssm" else
             f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}")
    log(f"{tag} {cfg.name} {'reduced' if rehearsal else 'whole'}: "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {heads}, vocab "
        f"{cfg.vocab}, {n_params / 1e9:.3f} B params {cfg.dtype}; "
        f"batch {batch} x {seq}, {n_micro} microbatches, remat on; init "
        f"{time.perf_counter() - t0:.1f} s")
    step_fn = make_train_step(model, TRAIN_OPT, n_micro)
    data = SyntheticLM(cfg, DataConfig(batch, seq, 0))
    batches = [to_torch(data.batch_at(s), dev) for s in range(steps + 1)]
    t0 = time.perf_counter()
    state, m = step_fn(state, batches[0])
    first = m["loss"].item()
    log(f"{tag} warm-up step 0: loss {first:.4f} grad_norm "
        f"{m['grad_norm'].item():.4f} ({time.perf_counter() - t0:.2f} s)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    walls, queued, losses, counts = [], [], [], []
    for s in range(1, steps + 1):
        ops.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[s])
        queued.append(time.perf_counter() - t0)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        counts.append(ops.launch_counts())
        losses.append(m["loss"].item())
        log(f"{tag} step {s}: loss {losses[-1]:.4f} grad_norm "
            f"{m['grad_norm'].item():.4f} step_s {walls[-1]:.3f} "
            f"dispatch_s {queued[-1]:.3f}")
    wall = float(np.median(walls))
    # the step queues its work without a sync: when the host returns
    # about as the device finishes (a short tail), the host set the pace
    tails = [w - q for w, q in zip(walls, queued)]
    log(f"{tag} host dispatch median={np.median(queued):.3f} s, device "
        f"tail after it median={np.median(tails):.3f} s (a step starts on a "
        f"drained device)")
    tokens = batch * seq
    # attention: 12 x layers x heads x hd x causal keys (none for an SSM)
    vis = seq * (seq + 1) // 2            # causal keys per row, summed
    attn_flops = (0.0 if cfg.family == "ssm" else
                  12.0 * cfg.n_layers * cfg.n_heads * cfg.hd * vis * batch)
    model_flops = 6.0 * n_params * tokens + attn_flops
    log(f"{tag} step_s median={wall:.3f} min={min(walls):.3f} "
        f"max={max(walls):.3f}; tok_per_s={tokens / wall:.1f}; model FLOPs "
        f"per step {model_flops:.4e} (6 N tokens + attention, remat's "
        f"recompute and the SSD scan's own FLOPs not counted)")
    if dev.type == "cuda":
        log(f"{tag} model FLOPs / (step_s x 989 TFLOP/s) = "
            f"{model_flops / wall / PEAK_OPS[torch.bfloat16]:.4f}")
        log(f"{tag} peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.3f}"
            f" (nvidia-smi: {smi_line()})")
    per_step = {k: v for k, v in counts[0].items() if v}
    log(f"{tag} launches per step {per_step} (every timed step equal: "
        f"{all(c == counts[0] for c in counts)})")
    finite = all(np.isfinite([first] + losses))
    falls = losses[-1] < first
    every = all(b < a for a, b in zip([first] + losses, losses))
    log(f"{tag} losses finite {finite}, falling {falls} "
        f"({first:.4f} -> {losses[-1]:.4f}; at every step {every})")
    if not (finite and falls):
        raise SystemExit(f"chip_smoke: the {case} path's loss is not finite "
                         f"and falling")
    if dev.type == "cuda" and not all(counts[0][k] for k in need):
        raise SystemExit(f"chip_smoke: {need} did not launch on the {case} "
                         f"path: {counts[0]}")
    if profile_dir is not None:
        nxt = to_torch(data.batch_at(steps + 1), dev)
        phase_profile(case, lambda: step_fn(state, nxt), dev, wall,
                      profile_dir)
    del state, model, batches, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(counts=counts[0], wall=wall, losses=losses)


# -- phase 6b: training over a mesh ---------------------------------------------
# (phase ``train_mesh``): build_step's train step (launch/train_mesh.py) on
# gloo worlds of rank processes on this card, FSDP over data and TP over
# model: internlm2-1.8b and mamba2-1.3b widths, SyntheticLM(4, 1024)
TM_MODELS = ("internlm2-1.8b", "mamba2-1.3b")
TM_AXES = ("data", "model")
TM_POD_AXES = ("pod", "data", "model")
TM_ROWS, TM_SEQ = 4, 1024
# depth of both models in fp32 and bf16, cut to the script's time limit
TM_LAYERS = 2
# timed bf16 steps, the last under a device-only profiler (device busy);
# a rank's fp32 case before them warms it (the kernels loaded, the gloo
# pairs connected); a step on gloo takes seconds
TM_STEPS = 1
TM_FP32_STEPS = 2
TM_REL = 1e-4                 # fp32: loss, grad_norm, params and m
# the seq rule's case: internlm2-1.8b widths on (data 1, model 2), 4 rows
# of 2048 tokens; with the rule against without it in fp32 (bit-equal
# where the partials sum alike, else within 1e-6 of each leaf's largest
# element), then one bf16 step of each, timed
TM_SEQ_RULE = {"seq": ("model",)}
TM_SEQ_LEN = 2048
TM_SEQ_REL = 1e-6
TM_BF16_REL = 2e-2            # bf16: the first step's loss


def tm_launches(cfg, n_micro: int) -> dict:
    """A rank's kernel launches per train step, reckoned from the code:
    every attention (SSD) layer launches the flash forward (SSD scan)
    twice a microbatch, in the forward and in its rematerialisation, and
    the backward once."""
    if cfg.family in ("ssm", "hybrid"):
        fwd, bwd = SSD
    else:
        fwd, bwd = FLASH
    return {fwd: 2 * cfg.n_layers * n_micro, bwd: cfg.n_layers * n_micro}


def tm_rank(mesh, dev, cases: list) -> list:
    """One rank of phase ``train_mesh``: ``tm_case`` for each case (a case
    with ``seq_pair`` set: ``tm_seq_pair``)."""
    return [tm_seq_pair(mesh, dev, **{k: v for k, v in case.items()
                                      if k != "seq_pair"})
            if case.get("seq_pair") else tm_case(mesh, dev, **case)
            for case in cases]


def _host_rss_gb() -> float | None:
    """This process's resident host memory now, GB (``/proc/self/statm``);
    None where the system does not give it."""
    import os
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e9


def _rss_peak(fn) -> tuple:
    """``fn()`` while a thread samples the resident host memory every 10
    ms: (its result, GB before, the largest sample GB; None where the
    system does not give it). ``getrusage``'s peak would carry the
    parent's into a spawned rank."""
    import threading
    before = _host_rss_gb()
    peak = [before]
    done = threading.Event()

    def watch():
        while not done.wait(0.01):
            now = _host_rss_gb()
            if now is not None and (peak[0] is None or now > peak[0]):
                peak[0] = now
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        out = fn()
    finally:
        done.set()
        watcher.join()
    return out, before, peak[0]


def tm_case(mesh, dev, cfg, rows: int, seq: int, steps: int, first: int,
            opt, seed: int = 0, n_micro: int | None = None,
            once: bool = False, timed: bool = False, ref: bool = False,
            ckpt_dir: str | None = None, restore: tuple | None = None,
            elastic: tuple | None = None, pod: bool = False,
            extra_rules: dict | None = None) -> dict:
    """``steps`` train steps of ``build_step``'s train step for ``cfg`` on
    this rank (data: ``SyntheticLM(rows, seq)`` from batch ``first``;
    ``n_micro`` and ``once`` its ``n_microbatches`` and
    ``gather_weights_once``), from ``launch.train_mesh.rank_start``: the
    seeded init, or the checkpoint ``restore = (dir, step)`` onto the
    mesh ``resize_mesh(*elastic)`` builds; ``pod``: on a (pod, data 1,
    model 1) mesh of the world's ranks instead of ``mesh``;
    ``extra_rules`` on the step (the ``seq`` rule). Per step:
    loss, grad_norm, wall and host queue seconds, kernel launches, the
    step's own collectives (FSDP gathers, gradient sums) and the model's
    all_reduces, calls and bytes. ``timed``: peak GB, and the last step
    runs under a device-only profiler (device busy). ``ckpt_dir``: a
    checkpoint from the mesh after the last step. ``ref``: then, in this
    process, the one-process ``make_train_step`` on this card from the
    same init (or a one-process restore of the same checkpoint), on the
    same batches and microbatches: its losses and grad_norms, and
    ``tm_held`` of the rank's params and m against it. The seconds of
    each part (``secs``) and the resident host memory before the start
    and its peak during it (``host_gb``, sampled)."""
    t_case = time.perf_counter()
    started = time.time()
    if pod:
        n = int(np.prod(list(mesh.shape.values())))
        mesh = make_mesh((n, 1, 1), TM_POD_AXES)
    (built, state), *host_gb = _rss_peak(lambda: rank_start(
        mesh, dev, cfg, seq, rows, seed=seed, restore=restore,
        elastic=elastic, step_kw=dict(n_microbatches=n_micro,
                                      gather_weights_once=once,
                                      opt_cfg=opt, extra_rules=extra_rules)))
    secs = {"start": time.perf_counter() - t_case}
    model, comm = built.model, built.meta["comm"]
    stats = built.meta["sharder"].stats
    nm = built.meta["n_microbatches"]
    data = SyntheticLM(cfg, DataConfig(rows, seq, 0))
    out = {k: [] for k in ("loss", "grad_norm", "wall_s", "queue_s",
                           "launches", "comm", "allreduce")}
    if timed and dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for s in range(first, first + steps):
        batch = to_torch(data.batch_at(s), dev)
        ops.reset_launch_counts()
        comm.update(dict.fromkeys(comm, 0))
        stats.update(dict.fromkeys(stats, 0))
        if timed and dev.type == "cuda" and s == first + steps - 1:
            box = {}

            def one():
                t1 = time.perf_counter()
                box["out"] = built.fn(state, batch)
                box["queue"] = time.perf_counter() - t1
            out["busy_s"], wall = _tp_busy(one, dev)
            state, m = box["out"]
            out["queue_s"].append(box["queue"])
            out["wall_s"].append(wall)
        else:
            _sync(dev)
            t1 = time.perf_counter()
            state, m = built.fn(state, batch)
            out["queue_s"].append(time.perf_counter() - t1)
            _sync(dev)
            out["wall_s"].append(time.perf_counter() - t1)
        out["launches"].append(ops.launch_counts())
        out["comm"].append(dict(comm))
        out["allreduce"].append(dict(stats))
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
    secs["steps"] = time.perf_counter() - t0
    out.update(n_micro=nm, heads=(model.n_heads_local, model.n_kv_local,
                                  model.ssm_heads_local),
               rows=(built.meta["rows"].start, built.meta["rows"].stop),
               tokens=rows * seq, seq=built.layout.seq,
               residual=model.residual_shape)
    if timed and dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    if ckpt_dir is not None:
        t0 = time.perf_counter()
        ckpt.save_checkpoint(ckpt_dir, state.opt.step, state,
                             gather=lambda t: built.gather_state(t, dst=0))
        secs["save"] = time.perf_counter() - t0
    if ref:
        t0 = time.perf_counter()
        full = None
        if restore is not None:
            like = init_train_state(build_model(cfg, device=dev).init(
                seed=seed))
            # the rank's own restore has just checked every digest
            full = ckpt.restore_checkpoint(restore[0], restore[1], like,
                                           verify_digest=False)
            del like
        out["ref_loss"], out["ref_norm"], full = tm_one_process(
            cfg, dev, rows, seq, steps, first, opt, nm, seed, state=full)
        secs["reference"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["held"] = tm_held(built, state, full)
        secs["held"] = time.perf_counter() - t0
        del full
    out.update(secs=secs, started=started, host_gb=host_gb)
    del state, built
    _free(dev)
    return out


def tm_seq_pair(mesh, dev, cfg, rows: int, seq: int, first: int, opt,
                seed: int = 0) -> dict:
    """One fp32 step of ``build_step``'s train step with ``TM_SEQ_RULE``
    and one without it, from the same seeded init on the same batch
    (``SyntheticLM(rows, seq)`` batch ``first``): both steps' loss,
    grad_norm, launches, the cut's collectives (``Sharder.stats``) and the
    layout's ``seq``; over the rank's state leaves, how many are
    bit-equal and the largest ``_max_rel`` of the rest."""
    batch = to_torch(SyntheticLM(cfg, DataConfig(rows, seq, 0)).batch_at(
        first), dev)
    out, states = {}, {}
    for name, rules in (("off", None), ("seq", TM_SEQ_RULE)):
        built, state = rank_start(mesh, dev, cfg, seq, rows, seed=seed,
                                  step_kw=dict(opt_cfg=opt,
                                               extra_rules=rules))
        stats = built.meta["sharder"].stats
        stats.update(dict.fromkeys(stats, 0))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, m = built.fn(state, batch)
        _sync(dev)
        out[name] = dict(loss=m["loss"].item(),
                         grad_norm=m["grad_norm"].item(),
                         wall_s=time.perf_counter() - t0,
                         launches=ops.launch_counts(), stats=dict(stats),
                         seq=built.layout.seq,
                         n_micro=built.meta["n_microbatches"])
        states[name] = [t for tree in (state.params, state.opt.m,
                                       state.opt.v) for t in leaves(tree)]
        del built, state
    pairs = list(zip(states["seq"], states["off"]))
    equal = sum(bool(torch.equal(a, b)) for a, b in pairs)
    worst = max(((a.float() - b.float()).abs().max().item()
                 / (b.float().abs().max().item() + 1e-3)) for a, b in pairs)
    out.update(equal=equal, leaves=len(pairs), worst=worst)
    del states, pairs
    _free(dev)
    return out


def tm_seq_gates(tag: str, cfg, fp32: list, bf16: dict, dev, seq_len: int,
                 counts: dict) -> list:
    """The ``seq`` rule's case: the fp32 step with the rule against the
    one without it on every rank (loss and grad_norm bit-equal or within
    ``TM_SEQ_REL`` relative, every state leaf within it; the rule on, the
    cut's gathers and reduce-scatters run); the bf16 pair's readings
    printed, both losses finite and within ``TM_BF16_REL``, each rank's
    launches ``tm_launches`` on the card (added to ``counts``: the flash
    forward with ``lse`` and its backward at the gathered sequence and the
    local heads). Returns the failures."""
    failed = []
    o = fp32[0]
    bits = all(r["seq"]["loss"] == r["off"]["loss"]
               and r["seq"]["grad_norm"] == r["off"]["grad_norm"]
               and r["equal"] == r["leaves"] for r in fp32)
    lerr = max(abs(r["seq"]["loss"] - r["off"]["loss"])
               / abs(r["off"]["loss"]) for r in fp32)
    nerr = max(abs(r["seq"]["grad_norm"] - r["off"]["grad_norm"])
               / abs(r["off"]["grad_norm"]) for r in fp32)
    worst = max(r["worst"] for r in fp32)
    cut = all(r["seq"]["seq"] == "model" and r["off"]["seq"] is None
              and r["seq"]["stats"]["gather_calls"] > 0
              and r["seq"]["stats"]["rs_calls"] > 0 for r in fp32)
    ok = cut and (bits or (lerr <= TM_SEQ_REL and nerr <= TM_SEQ_REL
                           and worst <= TM_SEQ_REL))
    log(f"{tag} seq (1, 2) fp32 {cfg.n_layers} layers, {o['seq']['n_micro']} "
        f"microbatches: {'BIT-EQUAL' if bits else 'not bit-equal'} to the "
        f"seq-off step (loss {o['seq']['loss']} vs {o['off']['loss']}, rel "
        f"{lerr:.2e}; grad_norm {o['seq']['grad_norm']} vs "
        f"{o['off']['grad_norm']}, rel {nerr:.2e}; state leaves bit-equal "
        f"{[r['equal'] for r in fp32]} of {o['leaves']}, worst rel "
        f"{worst:.2e}, limit {TM_SEQ_REL}); the rule on {cut}; cut "
        f"collectives a step (rank 0, forward and backward) "
        f"{ {k: v for k, v in o['seq']['stats'].items() if v} }; step "
        f"walls {o['seq']['wall_s']:.2f} / {o['off']['wall_s']:.2f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("seq fp32")
    want = tm_launches(cfg, bf16["seq"][0]["n_micro"])
    for name in ("off", "seq"):
        for k, v in tm_report(tag, f"seq pair bf16 ({name})",
                              bf16[name]).items():
            if name == "seq":
                counts[k] = counts.get(k, 0) + v
    ls = [r["loss"][0] for r in bf16["seq"]]
    lo = [r["loss"][0] for r in bf16["off"]]
    got = [{k: c[k] for k in want} for r in bf16["seq"]
           for c in r["launches"]]
    launched = dev.type != "cuda" or all(g == want for g in got)
    rel = abs(ls[0] - lo[0]) / abs(lo[0])
    finite = bool(np.isfinite(ls + lo).all())
    peaks = [(r.get("peak_gb"), q.get("peak_gb"))
             for r, q in zip(bf16["seq"], bf16["off"])]
    ok = finite and rel <= TM_BF16_REL and launched and all(
        r["seq"] == "model" and r["residual"][1] == seq_len // 2
        for r in bf16["seq"])
    log(f"{tag} seq pair bf16 {cfg.n_layers} layers: loss with the rule "
        f"{ls[0]} vs without {lo[0]} (rel {rel:.2e}, limit {TM_BF16_REL}); "
        f"peak GB a rank (with, without) {peaks}; residual a rank "
        f"{bf16['seq'][0]['residual']}; launches a rank and step "
        f"{got[0] if got else None} (reckoned {want}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failed.append("seq bf16")
    return failed


def tm_one_process(cfg, dev, rows: int, seq: int, steps: int, first: int,
                   opt, n_micro: int, seed: int = 0, state=None) -> tuple:
    """The one-process ``make_train_step`` on this card from
    ``init(seed)`` (or ``state``): (losses, grad_norms, the final state's
    params and m)."""
    model = build_model(cfg, device=dev, remat=True)
    state = state or init_train_state(model.init(seed=seed))
    step_fn = make_train_step(model, opt, n_micro)
    data = SyntheticLM(cfg, DataConfig(rows, seq, 0))
    losses, norms = [], []
    for s in range(first, first + steps):
        state, m = step_fn(state, to_torch(data.batch_at(s), dev))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    kept = state.params, state.opt.m
    del model, state, step_fn
    _free(dev)
    return losses, norms, kept


def tm_held(built, local, ref: tuple) -> tuple:
    """Over this rank's params and m against its shards of the
    one-process ``ref`` (params, m), on the card: the largest
    ``_max_rel`` (max |a - b| over the leaf's largest element, plus
    1e-7 / 1e-4) of each, and its leaf."""
    worst = {"params": (0.0, None), "m": (0.0, None)}
    for key, mine, tree in (("params", local.params, ref[0]),
                            ("m", local.opt.m, ref[1])):
        for path in leaf_paths(mine):
            full = leaf_at(tree, path)
            want = built.layout.local(path, full)
            err = ((leaf_at(mine, path).float() - want.float()).abs().max()
                   .item() / (full.abs().max().item() + 1e-7 / 1e-4))
            if err > worst[key][0]:
                worst[key] = (err, "/".join(path))
    return worst["params"], worst["m"]


def _gb(values: list) -> str:
    """The largest of ``values`` in GB, or "not measured" where any is
    None."""
    if any(v is None for v in values):
        return "not measured"
    return f"{max(values):.2f} GB"


def tm_report(tag: str, name: str, outs: list) -> dict:
    """Print a world's per-rank readings of a timed bf16 run; return the
    launches summed over its ranks' timed steps."""
    total: dict = {}
    for rank, o in enumerate(outs):
        walls = o["wall_s"]
        per = float(np.median(walls))
        queue = float(np.median(o["queue_s"]))
        comm, ar = o["comm"][-1], o["allreduce"][-1]
        busy = "not measured (CPU)"
        if "busy_s" in o:
            busy = (f"{o['busy_s'] / walls[-1]:.3f} ({o['busy_s']:.4f} s of "
                    f"device time in the last step, profiled, of "
                    f"{walls[-1]:.3f} s)")
        peak = o.get("peak_gb")
        log(f"{tag} {name} rank {rank}: rows [{o['rows'][0]}, "
            f"{o['rows'][1]}) of each of {o['n_micro']} microbatches, heads "
            f"{o['heads'][0]}/{o['heads'][1]} SSD heads {o['heads'][2]}; "
            f"losses {[round(x, 5) for x in o['loss']]}; step_wall_s "
            f"median={per:.4f} min={min(walls):.4f} max={max(walls):.4f}; "
            f"host_queue_s median={queue:.4f}; device_busy_share={busy}; "
            f"per step: FSDP gathers {comm['gather_calls']} calls "
            f"{comm['gather_bytes']} bytes, gradient sums "
            f"{comm['grad_calls']} calls {comm['grad_bytes']} bytes, model "
            f"all_reduces (forward and backward) {ar['calls']} calls "
            f"{ar['bytes']} bytes, the seq cut's all_gathers "
            f"{ar['gather_calls']} calls {ar['gather_bytes']} bytes, "
            f"reduce-scatters {ar['rs_calls']} calls {ar['rs_bytes']} bytes, "
            f"all_to_alls {ar['a2a_calls']} calls {ar['a2a_bytes']} bytes "
            f"(forward, remat and backward); peak_mem_GB="
            f"{'not measured (CPU)' if peak is None else round(peak, 3)}; "
            f"global tok/s {o['tokens'] / per:.1f}; seconds "
            f"{ {k: round(v, 1) for k, v in o['secs'].items()} }")
        for c in o["launches"]:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
    return total


def tm_bf16_gate(tag: str, name: str, ranks: list, cfg, ref_loss: float,
                 model_n: int, dev, counts: dict) -> list:
    """A timed bf16 world's readings and gates: the first loss within
    ``TM_BF16_REL`` of the one-process bf16 step's, every loss finite on
    every rank, each rank's local heads, and (on the card) its launches in
    every step equal to ``tm_launches``. Adds the timed steps' launches to
    ``counts``; returns the failures."""
    for k, v in tm_report(tag, name, ranks).items():
        counts[k] = counts.get(k, 0) + v
    o = ranks[0]
    rel = abs(o["loss"][0] - ref_loss) / abs(ref_loss)
    finite = all(bool(np.isfinite(r["loss"]).all()) for r in ranks)
    want = tm_launches(cfg, o["n_micro"])
    got = [{k: c[k] for k in want} for r in ranks for c in r["launches"]]
    launched = dev.type != "cuda" or all(g == want for g in got)
    heads = (cfg.n_heads // model_n, cfg.n_kv_heads // model_n,
             cfg.ssm_heads // model_n if cfg.ssm_state else 0)
    same_heads = all(r["heads"] == heads for r in ranks)
    ok = rel <= TM_BF16_REL and finite and launched and same_heads
    log(f"{tag} {name} at {cfg.n_layers} layers: first loss {o['loss'][0]} "
        f"vs the one-process bf16 step's {ref_loss} (rel {rel:.2e}, limit "
        f"{TM_BF16_REL}); every loss finite {finite}; heads per rank "
        f"{heads}: {same_heads}; launches per rank and step {got[0]} "
        f"(reckoned {want}: 2 x layers x microbatches forward, remat "
        f"included, layers x microbatches backward; every rank and step "
        f"equal: {launched}) {'ok' if ok else 'FAIL'}")
    return [] if ok else [name]


def tm_fp32_gate(tag: str, name: str, ranks: list) -> list:
    """An fp32 case held against the one-process step each rank ran
    after it: loss and grad_norm within ``TM_REL`` relative, every params
    and m leaf within ``_max_rel`` ``TM_REL`` on every rank, the metrics
    equal on every rank. Returns the failures."""
    got = ranks[0]
    same = all(r["loss"] == got["loss"] and r["grad_norm"]
               == got["grad_norm"] for r in ranks)
    lerr = max(abs(a - b) / abs(b)
               for a, b in zip(got["loss"], got["ref_loss"]))
    nerr = max(abs(a - b) / abs(b)
               for a, b in zip(got["grad_norm"], got["ref_norm"]))
    perr, pat = max((r["held"][0] for r in ranks), key=lambda h: h[0])
    merr, mat = max((r["held"][1] for r in ranks), key=lambda h: h[0])
    ok = (same and lerr <= TM_REL and nerr <= TM_REL and perr <= TM_REL
          and merr <= TM_REL)
    log(f"{tag} {name}, {got['n_micro']} microbatches: losses "
        f"{got['loss']} vs one process {got['ref_loss']} (max rel "
        f"{lerr:.2e}), grad_norm {got['grad_norm']} vs {got['ref_norm']} "
        f"(max rel {nerr:.2e}); over the ranks params max rel {perr:.2e} "
        f"({pat}), m max rel {merr:.2e} ({mat}); metrics "
        f"equal on every rank {same}; step walls "
        f"{[round(w, 2) for w in got['wall_s']]} s; seconds "
        f"{ {k: round(v, 1) for k, v in got['secs'].items()} } "
        f"{'ok' if ok else 'FAIL'}")
    return [] if ok else [name]


def phase_train_mesh(dev, seed: int, rehearsal: bool) -> dict:
    """Training over a mesh (``build_step``'s train step, FSDP over data
    and TP over model, ``launch/train_mesh.py``), every rank a process on
    this card over gloo (``run_ranks``). internlm2-1.8b widths (d_model
    2048, 16/8 heads of 128, vocab 92544) and mamba2-1.3b widths (64 SSD
    heads of 64, N 128), ``SyntheticLM(4, 1024, seed 0)``, the reference's
    microbatch rule, remat on. World (data 2, model 2): fp32 at
    ``TM_LAYERS`` layers, ``TM_FP32_STEPS`` steps (AdamW defaults but
    for the bf16 compression, as phase 4b), each rank then running the
    one-process ``make_train_step`` on the card from the same init,
    batches and microbatches: loss and grad_norm within 1e-4 relative,
    every params and m leaf within ``_max_rel`` 1e-4; then bf16 at
    ``TM_LAYERS`` layers (the reference's AdamW defaults),
    ``TM_STEPS`` timed steps after the fp32 cases warmed the ranks, the
    last under a device-only profiler: the first loss within 2e-2
    relative of the one-process bf16 step's, every loss finite. Elastic:
    the (2, 2) fp32 internlm2 run (its FSDP shards gathered once a step)
    checkpoints after step 2 from the mesh; ``plan_resize`` of 4 devices
    and batch 4 to 2 devices at model 2 must give (1, 2) and batch 2; a
    (1, 2) world restores through ``state_shardings`` onto
    ``resize_mesh``'s mesh and takes step 3, whose loss and params must
    equal a one-process run restored from the same checkpoint on the
    same batch (each rank runs it after its step) within 1e-4; then those
    2 ranks as (pod 2, data 1, model 1): internlm2 bf16 in the (2, 2)
    world's 2 microbatches (a row a pod) the same way, DP over (pod,
    data). Every rank's launches per step must equal ``tm_launches`` at
    the local heads (8/4 attention heads, 32 SSD heads at model 2)."""
    tag = "[train_mesh]"
    t_start = time.perf_counter()
    where = "cuda" if dev.type == "cuda" else "cpu"
    fp32_opt, bf16_opt = PARITY_OPT, TRAIN_OPT
    ck_dir = ROOT / "build" / "chip_smoke_ckpt_mesh"
    shutil.rmtree(ck_dir, ignore_errors=True)
    cfgs = {}
    for arch in TM_MODELS:
        base = get_config(arch)
        if rehearsal:
            c16 = dataclasses.replace(base.reduced(), dtype="bfloat16")
            c32 = base.reduced()
        else:
            c16 = dataclasses.replace(base, n_layers=TM_LAYERS)
            c32 = dataclasses.replace(base, n_layers=TM_LAYERS,
                                      dtype="float32")
        cfgs[arch] = (c32, c16)
    rows, seq = TM_ROWS, (32 if rehearsal else TM_SEQ)
    nm = {a: choose_microbatches(rows, seq, c16.padded_vocab, 4)
          for a, (_, c16) in cfgs.items()}
    # the one-process bf16 references on this card (the fp32 ones run in
    # the ranks, after their own steps)
    t0 = time.perf_counter()
    ref16 = {arch: tm_one_process(c16, dev, rows, seq, 1, 0, bf16_opt,
                                  nm[arch], seed)[0][0]
             for arch, (_, c16) in cfgs.items()}
    log(f"{tag} one-process bf16 references on this card "
        f"{time.perf_counter() - t0:.1f} s: first losses {ref16}")
    failed = []
    counts: dict = {}
    # world (2, 2): fp32 gates (internlm2 checkpoints; its FSDP shards
    # gathered once a step), then bf16 timed
    cases = []
    for arch, (c32, c16) in cfgs.items():
        first = arch == TM_MODELS[0]
        cases.append(dict(cfg=c32, rows=rows, seq=seq, steps=TM_FP32_STEPS,
                          first=0, opt=fp32_opt, seed=seed, ref=True,
                          once=first, ckpt_dir=str(ck_dir) if first else None))
    for arch, (c32, c16) in cfgs.items():
        cases.append(dict(cfg=c16, rows=rows, seq=seq, steps=TM_STEPS,
                          first=0, opt=bf16_opt, seed=seed, timed=True))
    t0, w0 = time.perf_counter(), time.time()
    outs = run_ranks(tm_rank, (2, 2), TM_AXES, device=where, args=(cases,))
    log(f"{tag} world (data 2, model 2): 4 ranks, "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start "
        f"({min(o[0]['started'] for o in outs) - w0:.1f} s to the first "
        f"case)")
    for i, (arch, (c32, c16)) in enumerate(cfgs.items()):
        failed += tm_fp32_gate(tag, f"(2, 2) fp32 {arch} at {c32.n_layers} "
                               f"layers", [o[i] for o in outs])
    for i, (arch, (c32, c16)) in enumerate(cfgs.items()):
        ranks = [o[len(cfgs) + i] for o in outs]
        failed += tm_bf16_gate(tag, f"(2, 2) bf16 {arch}", ranks, c16,
                               ref16[arch], 2, dev, counts)
    saved_s = outs[0][0]["secs"]["save"]
    del outs
    # a world of the 2 survivors: the elastic restore, (2, 2) saved after
    # step 2, onto resize_mesh's (1, 2); then, on the same ranks, a (pod 2,
    # data 1, model 1) mesh: DP over (pod, data). The rule's 4
    # microbatches at 2 chips leave one row a microbatch, which resolve
    # cannot split over 2 pods (every rank would run the same rows): 2
    # microbatches, a row a pod, as the (2, 2) world's
    arch = TM_MODELS[0]
    c32, c16 = cfgs[arch]
    old = el.ElasticState(None, 4, rows)
    shape, batch2 = el.plan_resize(old, 2, model_axis=2)
    # then, on the (1, 2) mesh, the seq rule's case at 4 x TM_SEQ_LEN
    seq2 = 32 if rehearsal else TM_SEQ_LEN
    t0 = time.perf_counter()
    outs = run_ranks(tm_rank, shape, TM_AXES, device=where, args=([dict(
        cfg=c32, rows=batch2, seq=seq, steps=1, first=TM_FP32_STEPS,
        opt=fp32_opt, seed=seed + 1, ref=True,
        restore=(str(ck_dir), TM_FP32_STEPS), elastic=(old, 2, 2)), dict(
        cfg=c16, rows=rows, seq=seq, steps=TM_STEPS, first=0, opt=bf16_opt,
        seed=seed, n_micro=nm[arch], timed=True, pod=True), dict(
        seq_pair=True, cfg=c32, rows=rows, seq=seq2, first=0, opt=fp32_opt,
        seed=seed), dict(
        cfg=c16, rows=rows, seq=seq2, steps=1, first=0, opt=bf16_opt,
        seed=seed, timed=True), dict(
        cfg=c16, rows=rows, seq=seq2, steps=1, first=0, opt=bf16_opt,
        seed=seed, timed=True, extra_rules=TM_SEQ_RULE)],))
    log(f"{tag} world of 2 ranks: the elastic {shape} restore and step, "
        f"then (pod 2, data 1, model 1), then the seq rule's pair at "
        f"{rows} x {seq2} on {shape}, {time.perf_counter() - t0:.1f} s with "
        f"the ranks' start")
    ranks = [o[0] for o in outs]
    planned = shape == (1, 2) and batch2 == 2
    log(f"{tag} elastic: plan_resize(ElasticState(n_devices=4, "
        f"global_batch=4), 2, model_axis=2) = {shape}, batch {batch2} "
        f"{'ok' if planned else 'FAIL'}; the {shape} world restored step "
        f"{TM_FP32_STEPS} through state_shardings (resident host memory a "
        f"rank before it {_gb([r['host_gb'][0] for r in ranks])}, its "
        f"peak during it {_gb([r['host_gb'][1] for r in ranks])}, sampled "
        f"every 10 ms), each "
        f"rank then a one-process restore of it")
    failed += tm_fp32_gate(tag, f"elastic {shape} fp32 {arch} step "
                           f"{TM_FP32_STEPS + 1}", ranks)
    if not planned:
        failed.append("plan_resize")
    log(f"{tag} elastic seconds: the (2, 2) save from the mesh "
        f"{saved_s:.1f}, the (1, 2) ranks' build and restore "
        f"{max(r['secs']['start'] for r in ranks):.1f}, the one-process "
        f"restore and step {max(r['secs']['reference'] for r in ranks):.1f}")
    failed += tm_bf16_gate(tag, f"(2, 1, 1) bf16 {arch}",
                           [o[1] for o in outs], c16, ref16[arch], 1, dev,
                           counts)
    failed += tm_seq_gates(tag, c16, [o[2] for o in outs],
                           {"off": [o[3] for o in outs],
                            "seq": [o[4] for o in outs]}, dev, seq2, counts)
    shutil.rmtree(ck_dir, ignore_errors=True)
    log(f"{tag} phase seconds {time.perf_counter() - t_start:.1f}")
    if dev.type == "cuda":
        log(f"{tag} nvidia-smi: {smi_line()}")
    if failed:
        raise SystemExit(f"chip_smoke: training over a mesh failed on "
                         f"{failed}")
    return dict(counts=counts)

# -- the dry-run plane on fake ranks (host only) -----------------------------------
DRY_PROD = [
    # (label, a cell of dryrun.run_cells)
    ("qwen3-32b train_4k (16, 16)",
     dict(arch="qwen3-32b", shape="train_4k")),
    ("qwen3-32b train_4k (16, 16) seq",
     dict(arch="qwen3-32b", shape="train_4k",
          extra_rules={"seq": ["model"]})),
    ("qwen3-32b decode_32k (16, 16)",
     dict(arch="qwen3-32b", shape="decode_32k")),
    ("llama-3.1-70b decode_32k (2, 16, 16) serve_pp",
     dict(arch="llama-3.1-70b", shape="decode_32k", multi_pod=True,
          serve_pp=True)),
]


def phase_dryrun(train_wall: float | None) -> None:
    """Host only: the port's dry run on fake ranks (``launch/dryrun.py``:
    each traced rank a subprocess in a fake world, ``build_step`` on
    ``device="cpu"`` traced under ``FakeTensorMode``; every cell at once).
    ``DRY_PROD``: qwen3-32b ``train_4k`` on (16, 16) without and with the
    ``seq`` rule (a rank's peak and collective bytes: the rule's gain at
    production size), qwen3-32b ``decode_32k`` on (16, 16), llama-3.1-70b
    ``decode_32k`` on (2, 16, 16) with ``serve_pp`` (the first rank of
    each stage); then the ``train`` path's own configuration
    (internlm2-1.8b whole, 8 x 2048 tokens in its microbatches) on a (1,
    1) mesh: ``launch/roofline.py``'s three terms (H100 data-sheet
    figures, not measurements) beside the path's step wall measured in
    this run (``train_wall``; None: not measured). Gates: every cell
    traced with finite positive FLOPs and peak, the train cells'
    collectives present, the peak with the rule below the one without."""
    from repro_torch.launch import dryrun, roofline
    tag = "[dryrun]"
    t0 = time.perf_counter()
    own = dict(arch=TRAIN_CASES["train"][0],
               shape=[TRAIN_SEQ, TRAIN_BATCH, "train_step"],
               mesh=((1, 1), ("data", "model")))
    recs = dryrun.run_cells([c for _, c in DRY_PROD] + [own], quiet=True)
    failed = []
    for (label, _), rec in zip(DRY_PROD, recs):
        ma, ca, co = (rec["memory_analysis"], rec["cost_analysis"],
                      rec["collectives"])
        kinds = {k: (int(co["counts"][k]), co["rank_bytes"][k], co[k])
                 for k in co["counts"]}
        ok = (np.isfinite(ca["flops"]) and ca["flops"] > 0
              and ma["peak_memory_in_bytes"] > 0 and co["total"] > 0)
        log(f"{tag} {label}: a rank's peak {ma['peak_memory_in_bytes']} B "
            f"(args {ma['argument_size_in_bytes']} B), FLOPs "
            f"{ca['flops']:.6e}, op bytes {ca['bytes accessed']:.6e}, "
            f"collectives (calls, rank bytes, wire bytes a chip) {kinds}, "
            f"wire total {co['total']:.6e} (across nodes "
            f"{co['network']:.6e}); traced {rec['lower_s']} s "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(label)
    off, on = (r["memory_analysis"]["peak_memory_in_bytes"]
               for r in recs[:2])
    lower = on < off
    log(f"{tag} seq rule in qwen3-32b train_4k: a rank's peak {on} B with, "
        f"{off} B without ({(on - off) / off:+.1%}); collective wire bytes "
        f"a chip {recs[1]['collectives']['total']:.6e} with, "
        f"{recs[0]['collectives']['total']:.6e} without "
        f"{'ok' if lower else 'FAIL'}")
    if not lower:
        failed.append("seq peak")
    rec = recs[-1]
    flops = rec["tw_costs"]["flops"]
    terms = {"compute_s": flops / roofline.H100_PEAK_FLOPS,
             "memory_s": (rec["cost_analysis"]["bytes accessed"]
                          / roofline.H100_HBM_BPS),
             "collective_s": roofline.collective_seconds(
                 rec["collectives"])}
    cfg = get_config(own["arch"])
    model_s = (6.0 * cfg.to_modelspec().params_active() * TRAIN_BATCH
               * TRAIN_SEQ / roofline.H100_PEAK_FLOPS)
    wall = "not measured" if train_wall is None else f"{train_wall:.4f} s"
    log(f"{tag} train path ({own['arch']} whole, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, {rec['meta']['n_microbatches']} microbatches) on "
        f"(1, 1): roofline terms (H100 data sheet: 989 TFLOP/s bf16, 3.35 "
        f"TB/s) compute {terms['compute_s']:.4f} s (traced FLOPs "
        f"{flops:.6e}, remat included), memory {terms['memory_s']:.4f} s "
        f"(unfused op bytes {rec['cost_analysis']['bytes accessed']:.6e}), "
        f"collective {terms['collective_s']:.4f} s; 6 N tokens / peak "
        f"{model_s:.4f} s; peak {rec['memory_analysis']['peak_memory_in_bytes']} "
        f"B; the path's measured step wall {wall}")
    log(f"{tag} phase seconds {time.perf_counter() - t0:.1f} (host only)")
    if failed:
        raise SystemExit(f"chip_smoke: the dry run failed on {failed}")


# -- torchlint's gate and a census of the host syncs on the card -----------------
# the census's engines (chip_smoke paths): paged and contig Qwen3-32B widths,
# mamba2-1.3b; each at LINT_LAYERS layers on the first LINT_REQUESTS of the
# path's requests, LINT_NEW new tokens each
LINT_PATHS = ("main", "contig", "ssm")
LINT_LAYERS = 2
LINT_REQUESTS = 8
LINT_NEW = 16
PORT_SRC = ROOT / "src" / "repro_torch"
# the engine functions whose syncs are admission work (the rest of
# Engine.step is the decode step)
ADMISSION_FNS = ("Engine.admit_many", "Engine._advance_pending",
                 "Engine._readmit_preempted")


def lint_gate(tag: str) -> list:
    """torchlint over ``src/repro_torch`` against ``.torchlint-baseline``
    (the CLI's gate with ``--fail-on-stale``); returns every finding,
    the suppressed ones included."""
    config = torchlint.LintConfig(tests_dir=str(ROOT / "tests"),
                                  smoke_file=str(ROOT / "chip_smoke.py"))
    found = torchlint.analyze_paths([str(PORT_SRC)], config,
                                    suppressed=True)
    accepted = load_baseline(str(ROOT / ".torchlint-baseline"))
    kept = [f for f in found if f.suppressed is None]
    new = [f for f in kept if f.fingerprint not in accepted]
    stale = sorted(accepted - {f.fingerprint for f in kept})
    by_check: dict = {}
    for f in found:
        row = by_check.setdefault(f.check, [0, 0])
        row[f.suppressed is not None] += 1
    log(f"{tag} torchlint on {PORT_SRC.relative_to(ROOT)}: "
        + ", ".join(f"{c} {b} baselined / {s} suppressed"
                    for c, (b, s) in sorted(by_check.items()))
        + f"; new {len(new)}, stale {len(stale)}")
    for f in new:
        log(f"{tag} NEW {f.render()}")
    if new or stale:
        raise SystemExit(f"chip_smoke: torchlint found {len(new)} new "
                         f"finding(s) and {len(stale)} stale baseline "
                         f"entr{'y' if len(stale) == 1 else 'ies'} {stale}")
    return found


def _port_frames(frame) -> list:
    """(path as torchlint reports it, line, qualname) of each frame under
    ``src/repro_torch``, innermost first."""
    out = []
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if path.is_relative_to(PORT_SRC):
            rel = f"repro_torch/{path.relative_to(PORT_SRC).as_posix()}"
            out.append((rel, frame.f_lineno, frame.f_code.co_qualname))
        frame = frame.f_back
    return out


def _census_run(cfg, params, dev, eng_kw, prompts, count: bool) -> tuple:
    """Serve ``prompts`` for LINT_NEW tokens on a fresh Engine; with
    ``count``, under the sync debug mode, every reported sync attributed
    to its innermost port frame. Returns (tokens, engine stats, syncs)."""
    reqs = [ServeRequest(prompt=list(p), max_new_tokens=LINT_NEW)
            for p in prompts]
    eng = Engine(cfg, params, device=dev, **eng_kw)
    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            log(f"[lint] warning: {message}")
            return
        frames = _port_frames(sys._getframe(1))
        quals = {q for _, _, q in frames}
        where = ("admission" if quals & set(ADMISSION_FNS) else
                 "decode" if "Engine.step" in quals else "other")
        if not frames:      # no port frame: the innermost frames as "via"
            log(f"[lint] a sync outside the port: {message}")
            f, stack = sys._getframe(1), []
            while f is not None and len(stack) < 6:
                stack.append(f"{f.f_code.co_filename}:{f.f_lineno} "
                             f"{f.f_code.co_qualname}")
                f = f.f_back
            frames = [(filename, lineno, "?"),
                      ("stack", 0, " <- ".join(stack))]
        syncs.append((where, frames[:2]))
    _sync(dev)
    if not count:
        _serve(eng, reqs)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                _serve(eng, reqs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    _sync(dev)
    if not all(r.done and len(r.generated) == LINT_NEW for r in reqs):
        raise SystemExit(f"chip_smoke: the {cfg.name} census run left a "
                         f"request unfinished")
    return [list(r.generated) for r in reqs], eng.stats, syncs


def _census_sites(syncs: list, stats) -> dict:
    sites: dict = {}
    totals = {"decode": 0, "admission": 0, "other": 0}
    for where, frames in syncs:
        totals[where] += 1
        rel, line, qual = frames[0]
        site = sites.setdefault(f"{rel}:{line} {qual}", {
            "decode": 0, "admission": 0, "other": 0, "via": {}})
        site[where] += 1
        if len(frames) > 1:
            via = "{}:{} {}".format(*frames[1])
            site["via"][via] = site["via"].get(via, 0) + 1
    return {"per_decode_step": totals["decode"] / max(stats.decode_steps, 1),
            "decode_steps": stats.decode_steps, "decode": totals["decode"],
            "admission": totals["admission"], "admissions": stats.prefills,
            "per_admission": totals["admission"] / max(stats.prefills, 1),
            "chunks": stats.prefill_chunks,
            "prefill_batches": stats.prefill_batches,
            "other": totals["other"], "sites": sites}


def phase_lint(dev, seed: int, rehearsal: bool) -> None:
    """(a) torchlint's gate on the host; (b) the census of host syncs by
    site on the card (``LINT_PATHS``), held to torchlint's findings and
    to the tokens of the same run with the mode off. The CPU rehearsal
    runs (a) and the census's traffic at reduced width without counting:
    the sync debug mode is the card's."""
    tag = "[lint]"
    t0 = time.perf_counter()
    found = lint_gate(tag)
    # the lines a sync may lie on: each finding's, baselined or
    # suppressed with a reason
    known = {(f.path, f.line) for f in found
             if f.suppressed is None or f.suppressed.strip()}
    census, unseen = {}, []
    for path in LINT_PATHS:
        cfg, eng_kw, make_requests, _, _ = path_workload(
            path, LINT_LAYERS, seed, rehearsal)
        prompts = [r.prompt for r in make_requests()[:LINT_REQUESTS]]
        params = build_model(cfg, device=dev).init(seed=seed)
        ref, _, _ = _census_run(cfg, params, dev, eng_kw, prompts, False)
        if rehearsal:
            again, _, _ = _census_run(cfg, params, dev, eng_kw, prompts,
                                      False)
            if again != ref:
                raise SystemExit(f"chip_smoke: the {path} census traffic "
                                 f"is not deterministic")
            log(f"{tag} {path}: {cfg.name} reduced, {len(prompts)} "
                f"requests, tokens equal on a second run (no count: the "
                f"sync debug mode needs the card)")
            continue
        toks, stats, syncs = _census_run(cfg, params, dev, eng_kw, prompts,
                                         True)
        del params
        if toks != ref:
            raise SystemExit(f"chip_smoke: the {path} census run's tokens "
                             f"differ from the same run with the mode off")
        row = census[path] = _census_sites(syncs, stats)
        lens = [len(p) for p in prompts]
        log(f"{tag} {path}: {cfg.name} widths, {cfg.n_layers} layers, "
            f"{eng_kw.get('kv_layout')} layout, {len(prompts)} requests of "
            f"{min(lens)}-{max(lens)} prompt tokens, {LINT_NEW} new each: "
            f"{row['per_decode_step']:.4f} syncs per decode step "
            f"({row['decode']} over {row['decode_steps']} steps), "
            f"{row['admission']} in admission ({row['admissions']} "
            f"requests, {row['prefill_batches']} group prefills, "
            f"{row['chunks']} chunks), {row['other']} elsewhere; tokens "
            f"equal to the mode-off run")
        for name, site in sorted(row["sites"].items(),
                                 key=lambda kv: -kv[1]["decode"]
                                 - kv[1]["admission"]):
            rel, line = name.split(" ")[0].rsplit(":", 1)
            # a sync with no port frame on the stack (turning the mode on)
            # is not the port's: printed, not held to torchlint
            port = rel.startswith("repro_torch/")
            seen = (rel, int(line)) in known
            log(f"{tag} {path}   {site['decode']:5d} decode "
                f"{site['admission']:5d} admission {site['other']:3d} "
                f"other  {name}  via {site['via']}  "
                + ("torchlint" if seen else "UNSEEN" if port
                   else "outside the port"))
            if port and not seen:
                unseen.append(f"{path}: {name}")
        gc.collect()
        torch.cuda.empty_cache()
    if not rehearsal:
        log(f"{tag} the census counts the syncs PyTorch routes through its "
            f"sync hooks (memcpy_and_sync, stream_synchronize), no other")
        print(json.dumps({"syncs": census}), flush=True)
    log(f"{tag} phase seconds {time.perf_counter() - t0:.1f}")
    if unseen:
        raise SystemExit(f"chip_smoke: syncs at lines torchlint does not "
                         f"report: {unseen}")


# -- optional: profiler breakdown of each path -----------------------------------
BWD_KERNEL_NAMES = ("bwd::prep_kernel", "bwd::main_kernel",
                    "bwd::post_kernel", "dkdv_fma", "dq_fma",
                    "bwd_preprocess")
KERNEL_NAMES = ("decode_split_kernel", "decode_combine_kernel",
                "decode_sm90_kernel", "dec::combine_kernel", "chunk_kernel",
                "flash_kernel")
SSD_KERNEL_NAMES = ("ssd_cb_kernel", "ssd_scan_kernel", "ssd::scan_kernel")


def _category(name: str) -> str:
    if "probe_kernel" in name:
        return "kv probe (port kernel)"
    # before "bwd::main_kernel" and "chunk_kernel": ssd_bwd::* (the
    # backward's CUDA-core body) and ssd_bwd_sm90::* (its tensor-core one)
    if "ssd_bwd" in name:
        return "ssd scan backward (port kernel)"
    if any(k in name for k in BWD_KERNEL_NAMES):
        return "attention backward (port kernel)"
    if any(k in name for k in KERNEL_NAMES):
        return "attention (port kernels)"
    if any(k in name for k in SSD_KERNEL_NAMES):
        return "ssd scan (port kernel)"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "gemv", "nvjet")):
        return "matmul (cuBLAS)"
    if "index" in low or "scatter" in low or "gather" in low:
        return "index / scatter / gather"
    if "memcpy" in low or "memset" in low:
        return "memcpy / memset"
    return "other elementwise / reduction"


def phase_profile(path, serve, dev, unprofiled_wall: float,
                  out_dir: Path) -> None:
    """Serve a path's traffic once more (after its warm-up and timed runs;
    ``serve()`` runs it on an engine or server built beforehand) under
    torch.profiler; print the device time by category and the device's
    idle share against both the profiled wall and the path's median
    unprofiled wall (opt-in: ``--profile``)."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        _sync(dev)
        wall = time.perf_counter() - t0
    cats: dict = {}
    ports: dict = {}                # port kernel -> (device us, launches)
    for evt in prof.key_averages():
        # device-side kernel / memcpy rows only: an aten:: op's "self CUDA"
        # time is its kernels' time again
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = evt.self_cuda_time_total
        cat = _category(evt.key)
        cats[cat] = cats.get(cat, 0) + dt
        if "port kernel" in cat:
            t, n = ports.get(evt.key, (0, 0))
            ports[evt.key] = (t + dt, n + evt.count)
    busy = sum(cats.values()) / 1e6
    tag = f"[profile:{path}]"
    for name, (t, n) in sorted(ports.items(), key=lambda kv: -kv[1][0]):
        log(f"{tag} port kernel {t / 1e3:9.1f} ms {n:5d} launches "
            f"{t / max(n, 1):8.1f} us each  {name[:70]}")
    log(f"{tag} profiled wall_s={wall:.3f} device_busy_s={busy:.3f} "
        f"idle_share={max(0.0, 1 - busy / wall):.3f}; against the median "
        f"unprofiled warm wall_s={unprofiled_wall:.3f}: "
        f"idle_share={max(0.0, 1 - busy / unprofiled_wall):.3f}")
    for c, t in sorted(cats.items(), key=lambda kv: -kv[1]):
        log(f"{tag} {c:32s} {t / 1e3:10.1f} ms  {t / 1e6 / busy:.3f}")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=25)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_table_{path}.txt").write_text(table)
    log(f"{tag} top kernels in {out_dir / f'profile_table_{path}.txt'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8,
                    help="depth of the full-width Qwen3-32B model on the "
                         "paged main and contig paths (phase 5)")
    ap.add_argument("--moe-layers", type=int, default=8,
                    help="depth of the full-width Phi-3.5-MoE model on the "
                         "MoE path (phase 5)")
    ap.add_argument("--cmdr-layers", type=int, default=8,
                    help="depth of the full-width command-r-plus-104b model "
                         "on the cmdr path (phase 5; 64 layers need the "
                         "multi-device plane)")
    ap.add_argument("--ssm-layers", type=int, default=24,
                    help="depth of the full-width mamba2-1.3b model (48 "
                         "layers) on the ssm path (phase 5)")
    ap.add_argument("--hybrid-layers", type=int, default=24,
                    help="depth of the full-width zamba2-2.7b model (54 "
                         "layers) on the hybrid path (phase 5; a multiple "
                         "of its shared block's period of 6)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the phases that need no card on the CPU at a "
                         "tiny size with the plain versions; never prints "
                         "the ok line")
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of phases after 'device'; the serving "
                         "paths run in the order given (a partial run "
                         "never prints the ok line)")
    ap.add_argument("--repeats", type=int, default=2,
                    help="timed runs of each serving path after its warm-up "
                         "pass (phase 5); the median wall is reported")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="after each serving path's timed runs, serve its "
                         "traffic once more under torch.profiler and write "
                         "the kernel table to DIR (off by default)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - set(ALL_PHASES)
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    depth = {p: getattr(args, DEPTH_FLAG[PATHS[p][0]])
             if PATHS[p][0] in DEPTH_FLAG else None for p in PATHS}
    # serving paths run in the order --phases names them
    paths = [p for p in args.phases.split(",") if p in PATHS]
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        # one intra-op thread: the shapes are tiny, and a host shared with
        # other busy processes (a parallel test run) stalls every parallel
        # op at its barrier; alone, the rehearsal takes about 1.5 minutes
        torch.set_num_threads(1)
        log("[rehearsal] CPU, plain versions, tiny sizes; no ok line")
        if "calibrate" in phases:
            phase_calibrate(dev, rehearsal=True)
        if "kernels" in phases:
            phase_kernels(dev, rehearsal=True)
        if "parity" in phases:
            phase_engine_parity(dev)
            phase_model_parity(dev)
            phase_prefix_parity(dev)
            phase_engine_bf16(dev)
            phase_poison_bf16(dev)
            phase_server_parity(dev)
            phase_server_prefix_parity(dev)
            phase_pp_parity(dev)
            phase_train_parity(dev)
        if "cluster" in phases:
            phase_cluster(args.seed)
        check_paths({p: PATH_PHASE.get(p, phase_path)(
            dev, p, depth[p], args.seed, rehearsal=True,
            repeats=args.repeats) for p in paths})
        for case in TRAIN_CASES:
            if case in phases:
                phase_train(dev, case, args.seed, rehearsal=True)
        if "train_mesh" in phases:
            phase_train_mesh(dev, args.seed, rehearsal=True)
        if "dryrun" in phases:
            phase_dryrun(None)
        if "lint" in phases:
            phase_lint(dev, args.seed, rehearsal=True)
        log("[rehearsal] done")
        return 0
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        log(f"[time] {phase} done, {time.perf_counter() - t0:.1f} s since "
            f"start")
    info = phase_device()
    dev = torch.device("cuda", 0)
    rows = []
    counts = {}
    if "build" in phases:
        phase_build()
        done("build")
    if "calibrate" in phases:
        phase_calibrate(dev, rehearsal=False)
        done("calibrate")
    if "kernels" in phases:
        rows = phase_kernels(dev, rehearsal=False)
        done("kernels")
    if "parity" in phases:
        phase_engine_parity(dev)
        phase_model_parity(dev)
        phase_prefix_parity(dev)
        phase_engine_bf16(dev)
        phase_poison_bf16(dev)
        phase_server_parity(dev)
        phase_server_prefix_parity(dev)
        phase_pp_parity(dev)
        phase_train_parity(dev)
        done("parity")
    if "cluster" in phases:
        phase_cluster(args.seed)
        done("cluster")
    res = {}
    by_dtype = {}
    for p in paths:
        res[p] = PATH_PHASE.get(p, phase_path)(
            dev, p, depth[p], args.seed, rehearsal=False,
            repeats=args.repeats, profile_dir=args.profile)
        counts[p] = res[p]["counts"]
        if res[p].get("by_cache_dtype"):
            by_dtype[p] = res[p]["by_cache_dtype"]
        done(p)
    check_paths(res)
    walls = {}
    for case in TRAIN_CASES:
        if case in phases:
            got = phase_train(dev, case, args.seed, rehearsal=False,
                              profile_dir=args.profile)
            counts[case], walls[case] = got["counts"], got["wall"]
            done(case)
    if "train_mesh" in phases:
        counts["train_mesh"] = phase_train_mesh(dev, args.seed,
                                                rehearsal=False)["counts"]
        done("train_mesh")
    if "dryrun" in phases:
        phase_dryrun(walls.get("train"))
        done("dryrun")
    if "lint" in phases:
        phase_lint(dev, args.seed, rehearsal=False)
        done("lint")
    if phases != set(ALL_PHASES):
        log("[partial] phases run: " + ",".join(sorted(phases)))
        return 0
    for r in rows:
        # launches: each path's first timed run, summed over the paths
        r["launches_by_path"] = {p: c[r["name"]] for p, c in counts.items()
                                 if c.get(r["name"])}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["name"] == "decode_attention":
            # the paths that count the contiguous kernel's launches by the
            # cache's dtype (kv_fp8, pp, pp_ranks): the fp8 reads of the
            # main path
            r["launches_by_cache_dtype"] = by_dtype
    keys = ["name", "route", "source", "replaces", "launches",
            "launches_by_path", "launches_by_cache_dtype", "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "shape", "timed_shapes",
            "fp8_shapes", "host_us", "fwd_lse", "fwd_states"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
