"""On-card smoke run of the PyTorch/CUDA port (``deeplearning4j_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); imports nothing of
JAX or of the JAX package. Phases, each fatal on failure:

1. device  — CUDA present; the card's name and power limit; TF32 off.
2. build   — every kernel built from ``csrc/`` (one nvcc per source,
   started together).
3. kernels — each kernel held against its plain PyTorch version on the
   card at its path's shapes, with its time, the plain version's, a
   library call's and the least time the card could take: K2 (paged
   attention: the serving shape at half and full window, t = 1 and 4,
   q bf16 and f32; dh=64, 1- to 64-token blocks, a bf16 pool, t=33,
   B=1, rows that leave splits empty; a rerun must give the same bits;
   the first pass's partials folded in torch must agree and a fold
   that drops a split must fail its limits; its device time from a
   CUDA graph of back-to-back calls, also at 1, 2 and 4 first-pass
   blocks per SM), K1 (flash
   attention, forward and dQ/dK/dV, at training
   A's T=2048, at training B's T=32768 against a plain version chunked
   over query rows, and at edge cases down to T=1; its f32 split pass
   bit for bit against its plain version; planted faults must fail its
   bf16 and f32 limits; a rerun must give the same bits; SDPA's own f32
   readings as a report), plus the bf16 and
   f32 sweeps behind K1's auto-dispatch threshold ``FLASH_MIN_T`` (one
   for both), and K3
   (``conv_taps``, LeNet's conv1: its tensor-core kernel for bf16 x with
   bf16 W and the CUDA-core kernel for the rest, each case on the
   route it must take; at B=2048 in bf16 and f32, ragged and padded
   batches, 1x1, 3x3 and 7x7 kernels, 529 output pixels, 50 and 128
   channels (the CUDA-core kernel's output staged in pieces), an inf
   and a NaN whose non-finite outputs must sit where the plain
   version's do, in bf16 and in f32; each route's main case rerun bit
   for bit; a zeroed tap must fail the bf16 and the f32 limits). K2's
   chunk route at phase 13's shape (B=1, t=256 after a 1024-token
   spliced prefix, window 2048, bt 16, f32 pool, q bf16 and f32, and a
   ragged last chunk of 200 under its mask): held on the valid rows,
   timed eager and as a CUDA graph beside the plain version, SDPA over
   the pre-gathered window and the bound. K2 at phase 14's verify shape
   (B=8, t=33, lengths 33, 17, 5, 2, 1, 33, 9 and an idle row of
   length 1 whose table maps nothing, rows 192 to 325 tokens in, f32
   pool, q bf16 and f32; NaN past each row's real span): held on each
   row's real queries, the idle row exactly 0, timed as the chunk
   route is.
4. training A — the width-1024 flagship (random weights from a seed) on
   K1 and on dense attention from the same params, 4 ``fit`` steps each
   at B=2, T=2048 on the Markov task, f32 and bf16: loss trajectories
   agree (and at f32 the params), K1 launched 8 times per step forward
   and backward. Then the 4 batches as ``fit_scan`` windows on a net
   that replays its captured train step and on a net from the same
   params that runs the step eagerly: params and updater state
   bit-identical after each window, K1 launched 8 times forward and
   backward per step through the replays; s/step of both and the
   graph's memory.
5. training B — bench.py's 32k long-context row (bf16, B=2, T=32768):
   1 warm-up and 2 timed ``fit`` steps through K1 in auto mode; tokens/s,
   s/step, peak memory, finite losses, K1's launches and its share of
   the step.
6. serving — the flagship served by the paged-KV ``DecodeEngine``, its
   decode round replayed from one captured CUDA graph
   (``compile_counts()["decode"] == 1``): every request finishes, K2
   launched once per layer per decode step, and one decode step's
   forward runs with no host sync; tokens/s beside the same engine on
   eager rounds, and the graph's memory. Then the serving gate
   against an engine on the plain gather program: at f32 the greedy ids
   are identical on every request, a right program (the plain one with
   reordered score sums) passes that check and planted faults in the
   plain engine's attention fail it. At bf16 the free-running id
   agreement at prompt seed 0 is printed as a report, with each
   divergence's f32 log-probability gap; it has no bar. Then the same
   run with ``fused_rounds=4`` and ``async_rounds=True``: every request
   finishes, K2 launched once per layer per decode step the device ran,
   at most 1 stepped and 3 fused graphs and none more on a repeat,
   tokens/s beside the stepped graph rounds', each graph's memory; at
   f32 the ids identical to stepped graph rounds, and with 4 sampled
   requests identical to a stepped engine's from the same seed.
7. fused decode — bench.py's ``bench_fused_decode`` row 1 (the serving
   net, the dense engine at ``n_slots=1``, ``decode_chunk=1``, a
   16-token prompt, 129 new tokens), ``fused_rounds=8`` against stepped
   rounds at bf16 and f32: ids bit-identical, one fused graph (K=8) and
   none more on repeats; tokens/s of both (median of 3 interleaved).
8. decode B=1 — bench.py's ``bench_decode`` shape (the serving net, B=1,
   a 128-token prompt, 128 new tokens), at f32 and bf16: the
   ``rnn_time_step`` loop's p50 per token over 32 tokens; ``generate``
   from its captured graphs (tokens/s, median of 3 after a warm run, and
   the graph's memory); its ids against the loop's (identical at f32,
   >= 0.9 at bf16, bench.py's gate); one graph per pow2 bucket over
   n_tokens 5, 100, 128 and 129 and none more on a repeat; at f32 the
   graph against the eager body, ids identical and the final rnn state
   bit-equal. Then ``generate`` after an unmasked 2048-token prompt:
   K1's forward prefills it (one launch per layer) and the window slides
   while it generates; at f32 its ids are identical to the same run with
   the prefill forced dense (``use_flash=False``), at bf16 the agreement
   is printed.
9. dense engine — bench.py's ``bench_decode_batched`` shape: the
   default ``DecodeEngine`` (dense slots) at 8 slots, ``decode_chunk=32``,
   8 x 128-token prompts, 128 new tokens. bf16: aggregate tokens/s,
   median of 3 runs after a warm run, above the B=1 rate;
   ``compile_counts()`` unchanged across the timed runs with ``decode``
   1; ids against B=1 ``generate`` >= 0.9; sampled requests of one
   prompt from the same graph differ. f32: ids identical to B=1
   ``generate``, and the graph round against the eager round identical.
10. LeNet — bench.py's ``mnist_lenet5_train_throughput`` row:
   ``lenet5(lr=0.002)``, bf16 compute, B=2048 synthetic MNIST, 7
   ``fit_scan`` windows of 64 steps (the first captures the train
   step; the launch counts start after it), then 2 timed windows
   replayed from the graph (examples/s, s/step, peak memory, K3's
   launches == steps, every one of them and of ``evaluate``'s on the
   tensor-core kernel, and its share of the step), falling losses, and
   ``evaluate`` on 4096 test images at bench.py's 0.97 accuracy gate.
   Beside the timed windows, 2 eager windows (``train_graphs = None``)
   from a copy of the same params, and ms/step of both; then, under
   cuDNN's deterministic mode (f32's default conv2 weight gradient sums
   with atomics), a copy that captures its own graph and an eager copy,
   2 windows each: params and updater state bit-identical.
11. LeNet f32 — the same run of the zoo's default ``lenet5(lr=0.01)``
   (no compute dtype: f32 throughout), every K3 launch of training and
   ``evaluate`` on the CUDA-core kernel.
12. LeNet card vs CPU — one set of port params, 4 f32 ``fit`` steps at
   B=256 on the card (K3 on the CUDA-core kernel, the f32 route, and
   cuDNN's conv2) and on the CPU (the plain versions): loss trajectories
   and params agree.
13. prefix caches and chunked admission — (a) bench.py's
   ``bench_prefix_cache`` workload on the serving net at bf16 (16
   prompts of a 1024-token shared prefix and a 256-token tail, 64 new
   tokens, 8 slots, chunk 32, ``prefix_cache_rows=4, prefill_chunk=256,
   admission_policy="ttft"``), the dense engine and the paged one (bt
   16): a warm-up on another prefix, a cold round, a warm round. First-
   wave median TTFT cold and warm, warm tokens/s; gates: skipped-token
   ratio and hit rate >= 0.7, warm ids against B=1 ``generate`` >= 0.9,
   ``compile_counts()`` unchanged between rounds; paged: K2 launched
   once per layer per decode step (its t=1 launches) and per warm chunk
   (its t>1 launches, counted on their own), >= 16 blocks spliced, CoW
   copies <= 2 per admission, no row movers. (b) f32, both layouts:
   warm admissions of the first prompts and of one diverging inside a
   block against cold admissions on a cache-off engine, each slot's
   K/V and the first token's logits within 1e-4 (at admission and
   after all are admitted); paged, two spliced blocks swapped and a
   chunk that skips the copy-on-write must fail that, and a spliced
   block one position off must fail the K/V and the logits each; the
   warm paged engine on K2 gives ids identical to the plain gather
   engine's; warm against cold ids as a report. (c) ``bench_fused_decode`` row 2,
   the admission storm (width 512, 4 layers, window 1024, paged,
   ``prefill_chunk=8``, decode priority, async, ``fused_rounds=8``):
   the victim's ITL under the storm over stepped idle ITL (a report,
   beside the JAX bench's 1.1x + 3 ms bar), fused idle ITL; gates:
   every request finishes, no fused window while an admission is
   pending (dispatches against the ``serving_fused_rounds``
   histogram), and at f32 the victim's ids identical under the storm.
14. speculative decoding — bench.py's ``bench_decode_spec``: the serving
   net at bf16, 24 requests x 128 new tokens over 8 slots, chunk 32,
   ``spec_draft_len=32``, each prompt a 64-token random head and the
   model's own 128-token greedy continuation (the best 24 of 32
   candidates by an n-gram replay), on the dense and the paged layout
   (bt 16): a warm round, then 3 interleaved timed rounds of the
   spec-off and the spec-on engine. Spec-on and spec-off tokens/s and
   their ratio, acceptance, spec and fallback rounds, the final live K,
   the verify graphs' memory and capture seconds; gates: ids agree with
   spec-off >= 0.9, verify graphs in [1, log2(32) + 1], no graph
   captured after the warm round, paged K2 launched N_LAYERS times per
   verify pass (t > 1) and per decode step (t = 1). At f32, both
   layouts, the 8 least predictable prompts (128 new tokens, each
   drafting in at least 2 verify passes): spec-on ids identical to spec-off; with 2 of them
   sampled at temperature 1.0 the greedy ones stay identical and the
   sampled ones draft; two planted faults of the verify pass (no
   rewind; acceptance one past the first mismatch) must each break the
   identity. Each bf16 request whose ids differ from spec-off is
   reported with its first divergence and the f32 log-prob gap there.
15. fault handling — the serving net at f32, 8 slots, chunk 32,
   ``prefix_cache_rows=4, prefill_chunk=256``, ``paranoid``,
   ``max_retries=3``, a ``ManualClock``; 12 requests of 64 new tokens,
   each prompt a shared 96-token head and a 32-token tail. (a) Both
   layouts: the fault-free engine with ``paranoid`` off and on (ids
   identical; tokens/s of both; the health check's device ms a replay
   against a round's wall), then a ``FaultPlan`` of a NaN'd slot, a
   stall, a failed admission and a corrupted trie entry (each kind must
   land), a snapshot after 4 rounds through JSON, a fresh engine
   restored from it (its seconds) and the faulted engine both run to
   the end: every request not ended ``fault`` has the fault-free ids,
   at least one victim, one ``decode`` and one ``health_check`` graph
   an engine and none captured on a repeat, no poisoned block left;
   paged, K2 launched N_LAYERS times per decode step; a health verdict
   forced to healthy and a restore that re-prefills the current token
   must each make a request diverge. (b) A paged async engine: a
   request cancelled while its round is in flight, its neighbours' ids
   identical, its own a prefix; the greedy run's graph replays move
   the generator state ``snapshot`` reads. (c) A paged snapshot with 2
   sampled requests running, restored twice: identical ids. The
   kernels line does not change.
16. gateway — bench.py's ``bench_gateway_streaming``: the serving net
   at bf16 behind a ``ServingGateway`` (keep-alive 1 s, admission grace
   0.25 s), 8 slots, chunk 32, 8 concurrent SSE clients (in a process
   of their own) of 128-token prompts and 128 new tokens, on the dense
   and the paged layout: a
   warm round on an in-process engine and one through the gateway
   (while a client scrapes the lock-free endpoints and a profile hook
   records any torch call another thread makes while the stepping
   thread captures), then 3 interleaved in-process and HTTP rounds and
   one HTTP round under a ``/v1/metrics`` scraper. Reports: HTTP
   against in-process tokens/s, client TTFT p50 / p99 against the
   engine's, each engine's host time a step, the scrape's time. Gates:
   every stream's ids equal the in-process engine's, no graph captured
   across the timed rounds, the gateway's handler threads ran during a
   capture and made no torch call then; paged, K2 launched N_LAYERS times per decode step of the
   gateway's engine, counted over the HTTP rounds alone. At
   f32: the paged engine with ``spec_draft_len=32`` and
   ``prefix_cache_rows=4`` (the trie primed through ``/v1/warmup``)
   over HTTP, ids equal the in-process engine's with verify passes and
   splices in the run; observability (``record_timing`` and a tracer)
   on against off in process: ids and graphs identical, tokens/s of
   both; a paranoid paged engine with one NaN'd slot over HTTP: every
   stream equals the fault-free ids (the victim's retry streams
   nothing twice), and a fan-out that drops one delta and an
   ``_emit_delta`` that re-sends a retried request's tokens must each
   break that.
17. tenancy, KV transfer and the KV spill tiers — (a) bench.py's
   ``bench_tenant_qos_overhead`` shape on the serving net at bf16 (8
   slots, chunk 32, 8 x 128-token prompts, 128 new tokens; paged, bt
   16): a default-tenant ``TenantRegistry`` against none, 3 interleaved
   rounds after a warm round; tokens/s ratio as a report (JAX gates
   0.97x); gates: ids identical, no preemption or shed, no graph
   captured across the timed rounds, K2 launched N_LAYERS times per
   decode step. (b) At f32: 8 flood requests fill the slots, the flood
   quota drops to 6 and a premium arrival is admitted in the round it
   arrives by one QoS preemption; every request's ids equal a
   tenancy-off engine's; K2 N_LAYERS times per decode step. (c)
   ``bench_kv_transfer`` row 1's shape (width 512, 4 layers, window
   1024, 3 x 512-token prompts, 16 new tokens, 2 slots, chunk 8,
   ``prefix_cache_rows=4, prefill_chunk=64``): at bf16 warm admission
   (DKV1 import + TTFT) against recompute TTFT, median of 3, as a
   report; gates: >= 511 tokens spliced per warm admission, K2 launched
   STORM_LAYERS times per warm chunk (t > 1) and per decode step, each
   payload unpacked and packed back to the same bytes; a gateway whose
   ``/v1/kv/export`` and ``/v1/kv/import`` are hit while its stepping
   thread captures: the handler threads ran then and made no torch
   call. At f32 a receiver that imports the donor's payloads gives the
   donor's ids with the imported K/V bit-identical; a payload with two
   blocks swapped and one written one position off must each break
   that (the model has no positional encoding, so the swap shows in
   the K/V, not the ids). (d) ``bench_kv_tier`` row 1's shape (window
   544, 6 x 512-token prompts over a 48-block pool, 1 slot, chunk 8,
   ``prefix_cache_rows=8, prefill_chunk=64``, a 64 MiB host tier):
   tiered against untiered tokens/s over 2 timed passes after 2 set-up
   passes (JAX gates 2x; here a report) and the host time a round with
   a staged spill spends staging and draining; gates: every timed
   tiered admission reloaded, the tier's books reconcile, no graph
   captured across the timed passes; at f32 tiered ids identical to
   untiered with every revisit reloaded, and one prompt spilled to a
   disk ring and reloaded from it. Phase 17's K2 launches are gated in
   each part and not added to the kernels line, as phase 15's.
18. the serving fleet — 6 replica processes on the card, each the
   port's ``serve`` subcommand (``--device cuda --paged-kv
   --use-flash-paged on``, 8 slots, chunk 4, bt 16,
   ``--prefix-cache-rows 4 --prefill-chunk 64``) over a zip the port's
   ``write_model`` wrote from the serving net (f32, and f32 with two
   output classes swapped), started together after the build and
   each reporting its K2 build (0.0 s expected) before its ready line;
   the router and the fleet controller in this process, the clients in
   a child process. (a) 8 greedy f32 SSE streams of 96 tokens (prompts
   of 40-200 tokens) over 2 replicas; once every stream has 16 tokens
   the replica owning the most is SIGKILLed: every stream ends
   ``length`` with the in-process kernel engine's ids, its SSE event
   ids are its delivered-token counts (none repeated or missing), the
   router's replays >= the victim's open streams, none diverged. (b)
   A 512-token prompt on its affinity owner, then the router's
   warm-import hook forced against the other replica: one transfer,
   the receiver's ids identical with >= 511 tokens reused, a second
   call transfers nothing; its TTFT beside a cold 512-token recompute
   on the same replica. (c) ``FleetController.rolling_upgrade()`` over
   those 2 replicas (each newcomer warmed with 2 live prompts' KV; a
   first request, KV export and KV import on all 4 children before it)
   while 8 greedy f32 streams of 1024 tokens run: every
   stream ends ``length`` with identical ids and exact event ids, >= 1
   handed off by a drain, 2 ``fleet.scale`` spans in ``/v1/trace``, the
   old replicas reaped. The planted fault: (a)'s streams whose first 16
   reference tokens hold a swapped class, on one true replica; the
   swapped replica joins and the true one is SIGKILLed: every stream
   open at the kill ends ``fault`` through the replay's divergence
   check and no token the true model would not make is delivered.
   Printed: each child's boot seconds, its decode
   rounds from ``/v1/metrics`` and the derived K2 t = 1 launches
   (N_LAYERS x decode steps; they are the children's, not in the
   kernels line), the phase's wall; every child is reaped on every way
   out.
19. the rest of the layers — (a) the zoo's ``moe_transformer_lm`` at
   the flagship's width (4 blocks of causal attention, 8 heads, each
   followed by a residual ``MoeDense`` of 8 experts x 4096 hidden,
   capacity factor 1.25, top-1; random weights from a seed), 4 ``fit``
   steps on K1 and on dense attention from the same params at B=2,
   T=2048 on the Markov task, f32 and bf16: losses agree (5e-3 / 2e-2
   relative), K1 launched 4 times a step forward and backward, the aux
   losses finite; tokens/s, s/step, peak memory, and a step's parts
   (routing, the dispatch and combine einsums, the expert FFN, one
   whole ``MoeDense``, K1) timed alone between CUDA events with their
   share of the step; then 4-step ``fit_scan`` windows from the
   captured step against the eager loop, params, updater state and
   aux state bit-identical. (b) The same net served at bf16 by the
   paged engine at phase 6's knobs (8 slots, chunk 32, window 2048,
   12 x 128-token prompts x 128 new tokens), its rounds one captured
   graph: every request finishes, K2 launched 4 times per decode step;
   tokens/s against eager rounds. The f32 gate runs eager rounds traced
   forward by forward (each ``MoeDense`` call's expert choices, gaps
   and seats, each forward's output probabilities): the kernel engine
   and the plain engine with reordered sums against the plain-gather
   engine, ids identical or diverging at a near tie only
   (``trace_divergence``; limits ``MOE_GAP_LIMIT``, ``MOE_OUT_TOL``);
   the graph kernel engine's ids equal its eager run's; two planted
   attention faults must each be rejected, and "scale squared" is run
   as a report. (c) DL4J's GravesLSTMCharModellingExample shape (2 x
   GravesLSTM(200), tanh, softmax/MCXENT, RMSProp, l2, TBPTT 50,
   minibatch 32) on Markov sequences of 1000: every window on the card
   and, from a zip the card net wrote, on the CPU, losses within 5e-3
   relative and falling, s a window; ``rnn_time_step`` over 64 tokens
   against the full forward within 1e-4; the full-BPTT net's
   ``fit_scan`` (T=50) from its captured step bit-identical to the
   eager loop. (d) bench.py's DBN row (``dbn(lr=0.05,
   updater=NESTEROVS)``, 784-500-250-10, CD-1, 8192 synthetic MNIST in
   batches of 1024): pretrain epochs/s over 3-epoch windows, 40
   finetune epochs, accuracy on 2048 test images against 0.97. The
   phase prints its seconds.
20. ComputationGraph — (a) a DAG LM of the flagship's layers as graph
   vertices (vocab 64, width 1024, 8 causal ``TransformerBlock``
   vertices of 8 heads, block 4's and block 8's outputs meeting in an
   ``ElementWiseVertex(add)`` before the LayerNorm, ``RnnOutputLayer``,
   Adam with warmup_cosine, random weights from a seed) on K1 and on
   dense attention from the same params, 4 ``fit`` steps each at B=2,
   T=2048 on the Markov task, f32 and bf16: losses agree (5e-3 / 2e-2
   relative; at f32 the params too), K1 launched 8 times a step forward
   and backward from the graph's vertex loop; tokens/s, s/step, peak
   memory; ``training_scan_check`` (captured ``fit_scan`` windows
   bit-identical to the eager loop); the chain twin (no add vertex)
   from the flagship MLN's params: output and one ``fit`` step
   bit-identical to the MLN's, or within 1e-6 relative with the
   difference printed. (b) The DAG LM at bf16 served by the paged
   engine at phase 6's knobs, the decode round one captured graph:
   every request finishes, K2 launched 8 times a decode step; tokens/s
   against eager rounds; the f32 gate as phase 6 holds it (kernel ids
   identical to the plain-gather engine's, the reordered-sums program
   passing, the two planted faults rejected); the f32 net written to
   one graph zip, restored with ``restore_model`` and served: ids
   identical to the in-process engine's. (c) The zoo's ``mlp`` over
   1024 synthetic MNIST examples from one zip: 10 iterations each of
   LBFGS, ConjugateGradient and LineGradientDescent on the card and on
   the CPU, scores within 1e-3 relative and falling; HF's
   Hessian-vector product on a small attention net (dense attention)
   against a central difference of gradients; a double backward
   through K1, and HF over K1, raise; an ``EarlyStoppingTrainer`` with a
   ``LocalFileModelSaver`` and a ``CheckpointManager`` (the last 2 plus
   the best): the best model restores with its score, the manager's
   best step with outputs equal to it. The phase prints its seconds.
21. host-fed training — (a) bench.py's ``bench_flagship`` model and
   pool at full width (``transformer_lm_flagship(vocab=64, width=2048,
   n_layers=8, n_heads=16)``, bf16, 403 M params; 1024 Markov sequences
   of T=512 written as one DL4JTOK1 file) fed by
   ``TokenSequenceFileIterator(batch_size=16)`` inside
   ``NativeAsyncDataSetIterator(queue_size=8)`` (the C++ ring; the
   native library built with g++ first, ``native_available()`` True)
   into ``fit_stream(scan_steps=64)`` with a one-hot ingest: the first
   window's 64 scores and the params after it bit-identical to
   ``fit_scan`` on the same stacked window from the same params, Adam
   state, iteration and generators; K1 launched 8 times a step forward
   and backward; one captured step for the window key; finite scores
   falling over 3 host-fed epochs, the second run with host syncs made
   fatal (``set_sync_debug_mode("error")``); host-fed against device-resident
   tokens/s, the data wait and peak memory reported. (b)
   bench.py's ``bench_hostfed_cnn`` shape: ``wide_cnn(lr=0.005)`` at
   bf16, 65,536 u8 images (192 MiB) in one CIFAR-binary file in a temp
   dir, ``CifarBinStreamIterator`` inside the async wrapper into
   ``fit_stream(scan_steps=64)`` with a u8 -> bf16 ingest,
   ``sync_each_window`` False and True: finite, falling scores, one
   capture, the second False epoch with host syncs fatal; both host-fed
   / device-resident ratios reported; then the
   real-patches fixture through 120 f32 ``fit`` steps, the held-out
   accuracy reported. (c) The CLI in process: ``train`` of the zoo's
   f32 ``lenet5()`` conf JSON on 2048 MNIST images (an ``.npz`` of
   [N, 1, 28, 28]: the ``mnist`` source's flat rows do not fit a conv
   conf, in either package) at batch 256 on the card, K3
   (``conv_taps_f32``) launched on conv1 every step; ``test`` and
   ``predict``; ``predict --raw`` on the card against the CPU's from
   the same zip (argmax identical, within 1e-4); ``train --mesh dp=2``
   exits naming ROADMAP item 11. The phase prints its seconds.
22. decode without Python and the embedding trainers — (a)
   ``csrc/aoti_runner.cpp`` built with g++ against the torch wheel's
   libtorch (beside the compiles); the serving net's decode step (f32,
   B=1, window 2048, width 1024 x 8, random weights from a seed)
   AOT-compiled into a ``.pt2`` package; in a child process that
   loads ``native_rt/aoti.py`` by path and never imports torch, 128
   teacher-forced tokens through it with the cache on the card: every
   step's logits within 1e-4 of ``rnn_time_step`` on the same inputs
   and the greedy ids identical, and a second pass that feeds layer
   0's initial ``filled`` back every step must fail that; native and ``rnn_time_step`` p50 ms a token, the build
   and compile seconds, the package bytes; JAX's 6-16-3 MLP (30 fits)
   through the runner within 1e-5 of ``output``; a LeNet export must
   raise naming K3. (b) bench.py's ``bench_w2v`` (``raw_sentences() *
   10``, layer 100, window 5, min count 5, batch 2048, subsampling
   1e-3, NS 5, seed 3): a warm ``fit`` (it captures the chunk graph),
   3 timed epochs with host syncs fatal (words/s, captures unchanged),
   bench.py's gate sim(day, night) > 0.4 and 0.2 above sim(day,
   money); one HS epoch: two code-length classes captured, the tables
   finite, each class's chunk loss falling, its similarities a report;
   card against CPU from the same tables, pairs and draws: a 64-batch
   NS chunk from the trained tables and an 8-batch HS chunk from the
   tables as built within 1e-5, and a 64-batch HS chunk from the
   trained tables as a report beside the CPU's own reordered sums;
   replay against eager: a full chunk through ``_run_chunk`` with new
   pairs and learning rates against the eager body on copies of the
   same tables and negatives within 1e-5 (NS on ``fit``'s graph from
   the trained tables, HS on a graph captured under deterministic
   algorithms from the tables as built). (c)
   GloVe, ParagraphVectors (HS and NS ``infer_vector``) and DeepWalk
   (at twice the test's walks and epochs) held to the JAX tests'
   criteria on the card. The phase prints its
   seconds. No kernel runs on phase 22's paths; the kernels line does
   not change.

Each path's kernel launch counts are set to 0 just before it runs and
read just after (comparison launches do not count).

The line before the last is ``{"kernels": [...]}`` (K1's bf16 entries
at training B's shape, its f32 entries ``flash_attention_f32`` and
``flash_attention_f32_bwd`` at training A's, their launches from phase
A's f32 ``fit`` and counted ``fit_scan`` graph window, each plus its
prefill launches in phase 8 at its dtype; K2's from phase 6's stepped
and fused runs and phase 16's bf16 paged gateway's HTTP rounds,
``paged_attention_chunk`` (K2 at t=256) from phase 13a's paged warm
chunks, ``paged_attention_verify`` (K2 at t=33) from phase
14's paged timed rounds (phases 15, 17 and 18 add none: 15's and
17's K2 launches are gated in the phase, 18's are its children's;
phase 19 adds 19a's K1 launches, fit and the counted ``fit_scan``
window, at f32 and bf16, and 19b's K2 launches on its bf16 graph run,
phase 20 likewise 20a's and 20b's, and phase 21 21a's host-fed
epochs); K3's ``conv_taps`` and ``conv_taps_f32`` with their launches
from phases 10 and 11 (``conv_taps_f32`` plus 21c's card ``train``,
``test`` and ``predict``); every f32 operations bound at the
f32-accurate rate, ``F32_ACCURATE_FLOPS``); the last is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when any phase fails or no card is present.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores, bf16 and TF32 tensor-core
# FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
# the cheapest f32-accurate route the card has, for every f32 operations
# bound: split TF32 (three TF32 products for each f32 one), or the CUDA
# cores if they were faster
F32_ACCURATE_FLOPS = max(F32_FLOPS, TF32_FLOPS / 3)

# the serving path's shapes: bench.py's serving configuration
VOCAB, WIDTH, N_LAYERS, N_HEADS, WINDOW = 64, 1024, 8, 8, 2048
BLOCK_TOKENS, N_SLOTS, DECODE_CHUNK = 16, 8, 32
DEVICE = "cuda"
N_REQUESTS, PROMPT_LEN, N_GEN = 12, 128, 128

# max |kernel - plain| allowed: f32 queries differ only by summation
# order over <= 2048 keys; bf16 queries are rounded to bf16 on output
# and compared with the plain version run on the f32 upcast
TOL_F32 = 1e-5
TOL_BF16 = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    card = gpu_name_and_power()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; TF32 off for matmul and cuDNN")
    return card


def build_phase() -> None:
    from deeplearning4j_tpu_torch import cuda_build

    t0 = time.perf_counter()
    secs = cuda_build.build_all(["paged_attention", "flash_attention",
                                 "conv_taps"])
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s "
        "wall, nvcc sm_90a)")


def cuda_time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed ``iters`` times between CUDA events, so no host
    launch gap sits between the kernels (and the capture itself shows
    that ``fn`` neither syncs nor allocates outside the graph's pool)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _paged_case(rng, t, fill, q_dtype, dev, *, b=N_SLOTS,
                dh=WIDTH // N_HEADS, bt=BLOCK_TOKENS,
                kv_dtype=torch.float32, idle=True):
    """Kernel operands at the serving path's shapes: ``b`` rows (B =
    N_SLOTS by default), each with its own block table into one pool of
    ``kv_dtype`` (f32, the master dtype, by default). ``fill`` is "half"
    (1024 tokens written), "full" (past the 2048 window, so the head
    slid out) or "short" (20 + 37 r tokens in row r: live ranges shorter
    than the split count, so some splits are empty). With ``idle`` row 0
    is idle (nothing mapped: no valid key); row 1 has a raised floor
    inside a block, row 2's tail block holds NaN past the written span,
    and a free pool block is NaN-poisoned."""
    h, tm = N_HEADS, WINDOW
    ntab = (tm + t - 2) // bt + 2
    per_row = ntab + 2
    nb = b * per_row + 8
    pk = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    pv = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    perm = torch.randperm(nb, generator=rng, device=dev).tolist()
    free = perm[-1]
    pk[free] = float("nan")
    pv[free] = float("nan")
    bid = np.zeros((b, ntab), np.int32)
    bval = np.zeros((b, ntab), np.int32)
    lo_blk = np.zeros(b, np.int32)
    floor = np.zeros(b, np.int32)
    filled = np.zeros(b, np.int32)
    lengths = np.full(b, t, np.int32)
    nan_blocks = []
    for r in range(b):
        length = dict(half=tm // 2 + 3 * r, full=tm + 2 * bt + 5 + 3 * r,
                      short=20 + 37 * r)[fill]
        fl = max(0, length - tm)
        if r == 1:
            fl = length - (50 if fill == "short" else 300)
        filled[r] = length
        floor[r] = fl
        if r == 0 and idle:
            filled[r] = 0
            continue
        lo = max(fl, max(length - tm + 1, 0))
        lo_blk[r] = lo // bt
        for j in range(ntab):
            g = lo_blk[r] + j
            if g * bt > length + t - 1:
                break
            bid[r, j] = perm[r * per_row + j]
            bval[r, j] = 1
            if r == 2 and g == (length + t - 1) // bt:
                nan_blocks.append((bid[r, j], (length + t) % bt))
    for blk, first in nan_blocks:
        if first:
            pk[blk, first:] = float("nan")
            pv[blk, first:] = float("nan")
    q = torch.randn(b, h, t, dh, generator=rng, device=dev).to(q_dtype)

    def i32(a):
        return torch.as_tensor(a, device=dev)

    ops = (q, pk.to(kv_dtype), pv.to(kv_dtype), i32(bid), i32(bval),
           i32(lo_blk), i32(floor), i32(filled), i32(lengths))
    return ops, tm


def _paged_bound(ops, tm):
    """Least time for these inputs: every operand byte the function
    needs read once (the K/V of the blocks some real query may attend,
    the q rows of the real queries, the tables), the real queries'
    output rows written once; f32 flops of QKᵀ and P·V over the keys
    each real query (i < lengths) attends: those of a mapped block at
    or above the floor, inside its window and at or below its own
    position (a chunk's causal reach, not every query over every
    reachable key). A row's pad queries (i >= lengths) count nowhere."""
    q, pk, pv, bid, bval, lo_blk, floor, filled, lengths = ops
    b, h, t, dh = q.shape
    bt = pk.shape[1]
    g = lo_blk.long()[:, None] + torch.arange(bid.shape[1],
                                              device=q.device)[None, :]
    last = filled.long() + lengths.long() - 1      # a row's last real query
    reach = ((bval > 0) & (lengths > 0)[:, None]
             & ((g + 1) * bt > floor.long()[:, None])
             & (g * bt <= last[:, None]))
    n_blocks = int(reach.sum())
    kv_bytes = n_blocks * bt * h * dh * 2 * pk.element_size()
    n_real = int(lengths.long().clamp(0, t).sum())
    io_bytes = 2 * n_real * h * dh * q.element_size() + sum(
        a.numel() * a.element_size() for a in ops[3:])
    off = torch.arange(bt, device=q.device)
    kpos = (g[:, :, None] * bt + off).reshape(b, 1, -1)
    kval = ((bval > 0).repeat_interleave(bt, dim=1)[:, None]
            & (kpos >= floor.long()[:, None, None]))
    i = torch.arange(t, device=q.device)
    qpos = (filled.long()[:, None] + i)[:, :, None]
    real = (i[None, :] < lengths.long()[:, None])[:, :, None]
    pairs = int((kval & real & (kpos <= qpos) & (kpos > qpos - tm)).sum())
    flops = 4.0 * pairs * h * dh
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_ACCURATE_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_yardstick(ops, tm):
    """``F.scaled_dot_product_attention`` over the gathered window with
    a boolean mask: the same function for rows with a valid key, timed
    as a yardstick only (the port never calls it)."""
    q, pk, pv, bid, bval, lo_blk, floor, filled, lengths = ops
    b, h, t, dh = q.shape
    nb, bt = pk.shape[0], pk.shape[1]
    ntab = bid.shape[1]
    off = torch.arange(bt, device=q.device)
    gidx = (bid.long()[:, :, None] * bt + off).reshape(b, ntab * bt)
    g = lo_blk.long()[:, None] + torch.arange(ntab, device=q.device)
    kpos = (g[:, :, None] * bt + off).reshape(b, ntab * bt)
    kval = (bval > 0).repeat_interleave(bt, dim=1)
    vlive = (kval & (kpos < (filled + lengths).long()[:, None])
             & (kpos >= floor.long()[:, None]))

    def gather(pool):
        # lanes outside the written span may hold NaN: zero them (every
        # key a query may attend is inside it, so the function is kept)
        x = pool.reshape(nb * bt, h, dh)[gidx].transpose(1, 2)
        return torch.where(vlive[:, None, :, None], x, 0.0).contiguous()

    ek, ev = gather(pk), gather(pv)
    qpos = filled.long()[:, None] + torch.arange(t, device=q.device)
    ok = (kval[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
          & (kpos[:, None, :] > qpos[:, :, None] - tm)
          & (kpos[:, None, :] >= floor.long()[:, None, None]))
    qf = q.float()
    mask = ok[:, None]
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qf, ek, ev, attn_mask=mask)


def _paged_name(ops, fill, t):
    q, pk = ops[0], ops[1]
    return (f"paged_attention {fill} window, B={q.shape[0]}, t={t}, "
            f"dh={q.shape[3]}, bt={pk.shape[1]}, "
            f"q={str(q.dtype).split('.')[-1]}, "
            f"pool={str(pk.dtype).split('.')[-1]}")


def _paged_hold(ops, tm, fill, t, idle=True):
    """K2 against its plain version on the f32 upcast of q: max |err|
    within TOL_F32 (f32 q) or TOL_BF16 (bf16 q), finite, and the idle
    row (row 0, where ``idle``) exactly 0. Fatal otherwise. Returns the
    kernel's output, the plain version's and the error."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        paged_attention,
        paged_attention_reference,
    )

    got = paged_attention(*ops, tm=tm)
    torch.cuda.synchronize()
    want = paged_attention_reference(ops[0].float(), *ops[1:], tm=tm)
    err = float((got.float() - want).abs().max())
    tol = TOL_F32 if ops[0].dtype == torch.float32 else TOL_BF16
    finite = bool(torch.isfinite(got).all())
    zero_row = float(got[0].float().abs().max()) if idle else 0.0
    name = _paged_name(ops, fill, t)
    if not finite or err > tol or zero_row != 0.0:
        raise SystemExit(
            f"chip_smoke: {name}: max_abs_err {err} (tol {tol}), finite "
            f"{finite}, idle-row max {zero_row} (must be 0)")
    log(f"{name}: max_abs_err {err:.3e} (tol {tol})")
    return got, want, err


def _paged_times(ops, tm) -> dict:
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        paged_attention,
        paged_attention_reference,
    )

    ms = cuda_time_ms(lambda: paged_attention(*ops, tm=tm))
    plain_ms = cuda_time_ms(lambda: paged_attention_reference(*ops, tm=tm))
    lib_ms = cuda_time_ms(_sdpa_yardstick(ops, tm))
    bound_ms, bound_by = _paged_bound(ops, tm)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def _paged_log_times(name, times) -> None:
    log(f"{name} times: kernel {times['ms']:.4f} ms, plain "
        f"{times['plain_ms']:.4f} ms, sdpa {times['library_ms']:.4f} ms, "
        f"bound {times['bound_ms']:.4f} ms ({times['bound_by']}, "
        f"{times['bound_ms'] / times['ms']:.1%} of it)")


def paged_device_times(ops, tm, name, times) -> None:
    """K2's and SDPA's device times (CUDA-graph replays: no host gaps
    between launches) beside the bound."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    dev_ms = graph_time_ms(lambda: paged_attention(*ops, tm=tm))
    lib_dev_ms = graph_time_ms(_sdpa_yardstick(ops, tm))
    log(f"{name} device times (CUDA graph of 20 calls): kernel "
        f"{dev_ms:.4f} ms ({times['bound_ms'] / dev_ms:.1%} of the "
        f"{times['bound_ms']:.4f} ms bound), sdpa {lib_dev_ms:.4f} ms")
    paged_split_sweep(ops, tm, name, times["bound_ms"])


def paged_split_sweep(ops, tm, name, bound_ms) -> None:
    """K2's device time with the split counts that 1, 2 and 4 first-pass
    blocks per SM give (``PAGED_BLOCKS_PER_SM`` picks one). A reading,
    not a gate."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        PAGED_BLOCKS_PER_SM,
        _paged_attention_launch,
        paged_splits,
        sm_count,
    )

    b, h, t, _ = ops[0].shape
    sms = sm_count(ops[0].device.index)
    readings = []
    for per_sm in (1, 2, 4):
        splits = paged_splits(b, h, t, ops[3].shape[1], sms, per_sm)
        ms = graph_time_ms(lambda: _paged_attention_launch(
            *ops, tm=tm, splits=splits))
        readings.append(f"{per_sm} per SM ({splits} splits) {ms:.4f} ms "
                        f"({bound_ms / ms:.1%} of bound)")
    log(f"{name} split sweep on {sms} SMs (device times; "
        f"PAGED_BLOCKS_PER_SM = {PAGED_BLOCKS_PER_SM}): "
        + ", ".join(readings))


def paged_rerun_check(ops, tm, name) -> None:
    """K2 twice on the same inputs: the same bits (a split plan that is
    arithmetic on the inputs, fixed merge and combine orders, no
    atomics). Fatal on any difference."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    a = paged_attention(*ops, tm=tm)
    b = paged_attention(*ops, tm=tm)
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    log(f"{name}: rerun bit for bit {same}")
    if not same:
        raise SystemExit(f"chip_smoke: {name}: a rerun of K2 differs")


def _combine(m, l_, acc):
    """The second pass's fold of split partials, in torch (f32)."""
    top = m.max(dim=2, keepdim=True).values
    f = torch.exp(m - top)
    den = (f * l_).sum(dim=2)
    return (f[..., None] * acc).sum(dim=2) / torch.where(
        den == 0, 1.0, den)[..., None]


def paged_fault_check(ops, tm, want, name) -> None:
    """The first pass's partials, folded in torch over every split,
    agree with the plain version within TOL_F32 (they are f32); folded
    without the last split (a planted fault: a combine that drops a
    split) they must fail the bf16 limit. Fatal otherwise."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        _paged_attention_launch,
        paged_splits,
        sm_count,
    )

    b, h, t, _ = ops[0].shape
    splits = paged_splits(b, h, t, ops[3].shape[1],
                          sm_count(ops[0].device.index))
    _, (m, l_, acc) = _paged_attention_launch(*ops, tm=tm, splits=splits)
    torch.cuda.synchronize()
    whole = float((_combine(m, l_, acc) - want).abs().max())
    fault = float((_combine(m[:, :, :-1], l_[:, :, :-1], acc[:, :, :-1])
                   - want).abs().max())
    log(f"{name}: {splits} splits; partials folded in torch "
        f"max_abs_err {whole:.3e} (tol {TOL_F32}); planted fault (last "
        f"split dropped from the combine) {fault:.3e}: caught "
        f"{fault > TOL_BF16} (tol {TOL_BF16})")
    if not whole <= TOL_F32 or not fault > TOL_BF16:
        raise SystemExit(f"chip_smoke: {name}: partials {whole} (tol "
                         f"{TOL_F32}), dropped split {fault} must exceed "
                         f"{TOL_BF16}")


def kernel_phase() -> list:
    """K2 held against its plain version: the serving shape (B=8, H=8,
    dh=128, bt=16, f32 pool) at half and full window, t = 1 and 4, q
    bf16 and f32, all timed; at the half window dh=64, bt = 1, 4, 8, 32
    and 64 (below 16 a warp's 4-key groups are partly empty), a bf16
    pool, t=33 (ragged against the 4-query tile) and B=1; short
    rows that leave splits empty; a rerun bit for bit; the planted
    fault; B=1 at the full window timed beside the main case, and both
    timed at 1, 2 and 4 first-pass blocks per SM. Returns
    the kernels-line entry (the full window, t=1, q bf16)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev)
    rng.manual_seed(7)
    before = (paged_attention.launches, paged_attention.chunk_launches)
    bf16, f32 = torch.bfloat16, torch.float32
    main = None
    for fill in ("half", "full"):
        for t in (1, 4):
            for q_dtype in (bf16, f32):
                ops, tm = _paged_case(rng, t, fill, q_dtype, dev)
                got, want, err = _paged_hold(ops, tm, fill, t)
                times = _paged_times(ops, tm)
                name = _paged_name(ops, fill, t)
                _paged_log_times(name, times)
                if fill == "full" and q_dtype == bf16:
                    paged_rerun_check(ops, tm, name)
                    if t == 1:
                        paged_fault_check(ops, tm, want, name)
                        main = dict(max_abs_err=err, **times)
                        paged_device_times(ops, tm, name, times)
    half = [dict(dh=64), dict(dh=64, q_dtype=f32), dict(bt=32),
            dict(bt=64), dict(bt=64, dh=64, q_dtype=f32),
            dict(bt=1, q_dtype=f32), dict(bt=4),
            dict(bt=8, t=4, q_dtype=f32, kv_dtype=bf16),
            dict(kv_dtype=bf16), dict(kv_dtype=bf16, q_dtype=f32),
            dict(kv_dtype=bf16, dh=64, t=4), dict(t=33),
            dict(t=33, q_dtype=f32, kv_dtype=bf16),
            dict(b=1, idle=False), dict(b=1, idle=False, t=4, q_dtype=f32)]
    for kw in half:
        kw = dict(dict(t=1, q_dtype=bf16), **kw)
        t, q_dtype = kw.pop("t"), kw.pop("q_dtype")
        ops, tm = _paged_case(rng, t, "half", q_dtype, dev, **kw)
        _paged_hold(ops, tm, "half", t, kw.get("idle", True))
    for t in (1, 4):
        for q_dtype in (bf16, f32):
            ops, tm = _paged_case(rng, t, "short", q_dtype, dev)
            _paged_hold(ops, tm, "short", t)
    ops, tm = _paged_case(rng, 1, "full", bf16, dev, b=1, idle=False)
    _paged_hold(ops, tm, "full", 1, idle=False)
    name = _paged_name(ops, "full", 1)
    times = _paged_times(ops, tm)
    _paged_log_times(name, times)
    paged_device_times(ops, tm, name, times)
    # comparison launches do not count toward the main path's run
    paged_attention.launches, paged_attention.chunk_launches = before
    return [dict(
        name="paged_attention", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/paged_attention.cu",
        replaces="deeplearning4j_tpu/nn/layers/attention.py:807",
        **main)]


# K2 at the chunk width: a paged warm admission streams its suffix
# through the slot's table at t = prefill_chunk, B=1 (phase 13's prefix
# workload: a 1024-token spliced prefix, 256-token chunks, the serving
# window and pool)
CHUNK_PREFIX, CHUNK_T, CHUNK_RAGGED = 1024, 256, 200


def _paged_chunk_case(rng, q_dtype, dev, valid=CHUNK_T):
    """K2's operands for one warm chunk: B=1, H=8, dh=128, bt=16, an f32
    pool; ``CHUNK_PREFIX`` tokens already in the table (the spliced
    prefix) and the chunk's ``CHUNK_T`` queries after them, of which the
    first ``valid`` are real (a ragged last chunk under its mask: its
    lanes past ``valid`` hold NaN, as a recycled block's stale lanes
    may). The table maps the prefix's and the chunk's blocks in a
    random order; one free pool block is NaN."""
    h, dh, bt, tm, t = N_HEADS, WIDTH // N_HEADS, BLOCK_TOKENS, WINDOW, \
        CHUNK_T
    ntab = (tm + t - 2) // bt + 2
    live = -(-(CHUNK_PREFIX + t) // bt)
    nb = live + 8
    pk = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    pv = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    perm = torch.randperm(nb, generator=rng, device=dev).tolist()
    pk[perm[-1]] = float("nan")
    pv[perm[-1]] = float("nan")
    bid = np.zeros((1, ntab), np.int32)
    bval = np.zeros((1, ntab), np.int32)
    bid[0, :live] = perm[:live]
    bval[0, :live] = 1
    for pos in range(CHUNK_PREFIX + valid, CHUNK_PREFIX + t):
        pk[bid[0, pos // bt], pos % bt] = float("nan")
        pv[bid[0, pos // bt], pos % bt] = float("nan")
    q = torch.randn(1, h, t, dh, generator=rng, device=dev).to(q_dtype)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    ops = (q, pk, pv, i32(bid), i32(bval), i32([0]), i32([0]),
           i32([CHUNK_PREFIX]), i32([valid]))
    return ops, tm


def _chunk_name(ops):
    q = ops[0]
    return (f"paged_attention chunk, B=1, t={q.shape[2]} "
            f"({int(ops[8][0])} valid), {CHUNK_PREFIX}-token spliced "
            f"prefix, dh={q.shape[3]}, bt={ops[1].shape[1]}, "
            f"q={str(q.dtype).split('.')[-1]}, "
            f"pool={str(ops[1].dtype).split('.')[-1]}")


def paged_chunk_kernel_phase() -> list:
    """K2's chunk route held against its plain version on the valid
    query rows (TOL_F32 / TOL_BF16 by q's dtype; those rows finite): q
    bf16 and f32, a full chunk and a ragged one. The full chunks are
    timed (eager, and from a CUDA graph of back-to-back calls) beside
    the plain version, SDPA over the pre-gathered window with the
    causal-offset mask, and the bound. Returns the kernels-line entry
    ``paged_attention_chunk`` (the bf16-q full chunk: phase 13's bf16
    engine); its launches come from phase 13."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        paged_attention,
        paged_attention_reference,
    )

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev)
    rng.manual_seed(13)
    before = (paged_attention.launches, paged_attention.chunk_launches)
    entry = None
    for valid in (CHUNK_T, CHUNK_RAGGED):
        for q_dtype in (torch.bfloat16, torch.float32):
            ops, tm = _paged_chunk_case(rng, q_dtype, dev, valid)
            name = _chunk_name(ops)
            got = paged_attention(*ops, tm=tm)[:, :, :valid]
            want = paged_attention_reference(ops[0].float(), *ops[1:],
                                             tm=tm)[:, :, :valid]
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            tol = TOL_F32 if q_dtype == torch.float32 else TOL_BF16
            finite = bool(torch.isfinite(got).all())
            log(f"{name}: max_abs_err {err:.3e} (tol {tol}), valid rows "
                f"finite {finite}")
            if not finite or not err <= tol:
                raise SystemExit(f"chip_smoke: {name}: max_abs_err {err} "
                                 f"(tol {tol}), finite {finite}")
            if valid != CHUNK_T:
                continue
            times = _paged_times(ops, tm)
            _paged_log_times(name, times)
            dev_ms = graph_time_ms(lambda: paged_attention(*ops, tm=tm))
            lib_dev_ms = graph_time_ms(_sdpa_yardstick(ops, tm))
            log(f"{name} device times (CUDA graph of 20 calls): kernel "
                f"{dev_ms:.4f} ms ({times['bound_ms'] / dev_ms:.1%} of "
                f"the bound), sdpa {lib_dev_ms:.4f} ms")
            if q_dtype == torch.bfloat16:
                entry = dict(max_abs_err=err, **times)
    paged_attention.launches, paged_attention.chunk_launches = before
    return [dict(
        name="paged_attention_chunk", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/paged_attention.cu",
        replaces="deeplearning4j_tpu/nn/layers/attention.py:807",
        **entry)]


# K2 at the verify shape: a speculative round's verify pass sends every
# slot's [current token | draft] through the paged attend at t = width +
# 1 (33 at K=32), each row with its own length (1 for a row that drafted
# nothing), beside an idle slot whose table maps nothing (phase 14's
# paged engine: 8 slots, bt 16, the serving window and f32 pool, rows
# a couple of hundred tokens in)
VERIFY_LENGTHS = (33, 17, 5, 2, 1, 33, 9, 1)
VERIFY_IDLE = 7


def _paged_verify_case(rng, q_dtype, dev):
    """K2's operands for one verify pass: B=8, H=8, dh=128, bt=16,
    t=33, an f32 pool; row r holds ``192 + 19 r`` tokens (the idle row
    ``VERIFY_IDLE`` none: its table is unmapped, its length 1) and its
    first ``VERIFY_LENGTHS[r]`` queries are real. Each row maps the
    blocks up to its last query's position in a random order; the lanes
    past each row's real span hold NaN (a rejected tail or a recycled
    block's stale lanes), and one free pool block is NaN."""
    h, dh, bt, tm = N_HEADS, WIDTH // N_HEADS, BLOCK_TOKENS, WINDOW
    t, b = max(VERIFY_LENGTHS), len(VERIFY_LENGTHS)
    ntab = (tm + t - 2) // bt + 2
    filled = [0 if r == VERIFY_IDLE else 192 + 19 * r for r in range(b)]
    need = [-(-(f + t) // bt) for f in filled]
    nb = sum(need) + 8
    pk = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    pv = torch.randn(nb, bt, h, dh, generator=rng, device=dev)
    perm = torch.randperm(nb, generator=rng, device=dev).tolist()
    pk[perm[-1]] = float("nan")
    pv[perm[-1]] = float("nan")
    bid = np.zeros((b, ntab), np.int32)
    bval = np.zeros((b, ntab), np.int32)
    used = 0
    for r in range(b):
        if r == VERIFY_IDLE:
            continue
        bid[r, :need[r]] = perm[used:used + need[r]]
        bval[r, :need[r]] = 1
        used += need[r]
        pos = np.arange(filled[r] + VERIFY_LENGTHS[r], need[r] * bt)
        rows = torch.as_tensor(bid[r, pos // bt].astype(np.int64),
                               device=dev)
        lanes = torch.as_tensor(pos % bt, device=dev)
        pk[rows, lanes] = float("nan")
        pv[rows, lanes] = float("nan")
    q = torch.randn(b, h, t, dh, generator=rng, device=dev).to(q_dtype)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    ops = (q, pk, pv, i32(bid), i32(bval), i32([0] * b), i32([0] * b),
           i32(filled), i32(VERIFY_LENGTHS))
    return ops, tm


def _verify_name(ops):
    q = ops[0]
    return (f"paged_attention verify, B={q.shape[0]}, t={q.shape[2]}, "
            f"lengths {list(VERIFY_LENGTHS)} (row {VERIFY_IDLE} idle), "
            f"dh={q.shape[3]}, bt={ops[1].shape[1]}, "
            f"q={str(q.dtype).split('.')[-1]}, "
            f"pool={str(ops[1].dtype).split('.')[-1]}")


def paged_verify_kernel_phase() -> list:
    """K2's t > 1 route at the verify shape, held against its plain
    version on each row's real queries (TOL_F32 / TOL_BF16 by q's
    dtype; finite; the idle row's exactly 0), q bf16 and f32. The bf16
    case is timed (eager, and from a CUDA graph of back-to-back calls)
    beside the plain version, SDPA over the pre-gathered window with the
    causal-offset mask, and the bound (each real query's causal reach).
    Returns the kernels-line entry ``paged_attention_verify``; its
    launches come from phase 14's paged runs."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        paged_attention,
        paged_attention_reference,
    )

    dev = torch.device("cuda")
    rng = torch.Generator(device=dev)
    rng.manual_seed(14)
    before = (paged_attention.launches, paged_attention.chunk_launches)
    entry = None
    for q_dtype in (torch.bfloat16, torch.float32):
        ops, tm = _paged_verify_case(rng, q_dtype, dev)
        name = _verify_name(ops)
        t = ops[0].shape[2]
        real = (torch.arange(t, device=dev)[None, :]
                < ops[8][:, None])[:, None, :, None]
        got = paged_attention(*ops, tm=tm).float()
        want = paged_attention_reference(ops[0].float(), *ops[1:], tm=tm)
        torch.cuda.synchronize()
        err = float(torch.where(real, got - want, 0.0).abs().max())
        finite = bool(torch.isfinite(torch.where(real, got, 0.0)).all())
        idle = float(got[VERIFY_IDLE, :, 0].abs().max())
        tol = TOL_F32 if q_dtype == torch.float32 else TOL_BF16
        log(f"{name}: max_abs_err {err:.3e} over the real queries (tol "
            f"{tol}), finite {finite}, idle row max {idle}")
        if not finite or not err <= tol or idle != 0.0:
            raise SystemExit(f"chip_smoke: {name}: max_abs_err {err} (tol "
                             f"{tol}), finite {finite}, idle row {idle} "
                             "(must be 0)")
        if q_dtype != torch.bfloat16:
            continue
        times = _paged_times(ops, tm)
        _paged_log_times(name, times)
        dev_ms = graph_time_ms(lambda: paged_attention(*ops, tm=tm))
        lib_dev_ms = graph_time_ms(_sdpa_yardstick(ops, tm))
        log(f"{name} device times (CUDA graph of 20 calls): kernel "
            f"{dev_ms:.4f} ms ({times['bound_ms'] / dev_ms:.1%} of the "
            f"bound), sdpa {lib_dev_ms:.4f} ms")
        entry = dict(max_abs_err=err, **times)
    paged_attention.launches, paged_attention.chunk_launches = before
    return [dict(
        name="paged_attention_verify", route="cuda",
        source="deeplearning4j_tpu_torch/csrc/paged_attention.cu",
        replaces="deeplearning4j_tpu/nn/layers/attention.py:807",
        **entry)]


# K1 (flash attention): the training path's shapes are B=2, H=8, dh=128
# at phase A's T=2048 and at phase B's T=LONG_T; the kernels line
# reports the LONG_T shape, the one its launches are counted at. Each
# case is held against the plain version on the f32 upcast by three
# measures, each with its limit: max |out - ref| ("out"); each grad's
# max |g - r| / max |r| ("grad"); and the scale-free ||x - r|| / ||r||
# of the output and of each grad ("norm"), which a fault confined to
# late rows moves where the max measures may not. PERF.md gives the
# sound readings and the planted-fault readings each limit sits between.
FLASH_B, FLASH_H = 2, 8
FLASH_TOL = {torch.float32: dict(out=1e-4, grad=1e-3, norm=1e-5),
             torch.bfloat16: dict(out=2e-2, grad=1e-2, norm=6e-3)}
FLASH_SWEEP_T = (512, 1024, 2048, 4096)
# f32 up to the first T where dense no longer fits the card
FLASH_SWEEP_T_F32 = (512, 1024, 2048, 4096, 8192, 16384, 32768)
# query rows per chunk of the chunked plain version: a [B, H, 512, T]
# f32 score block at a time (1 GiB at T=32768)
FLASH_REF_ROWS = 512
# planted faults, each a drop(qpos, kpos) of keys a faulty kernel would
# leave out, confined to the late half of the rows: the check must fail
# each of them at both dtypes' limits (the bf16 kernels step over keys
# in tiles of 128 in the forward and 64 in dQ, over queries in tiles of
# 64 in dK/dV; the f32 kernels over keys in tiles of 64 in the forward
# and 32 in dQ, over queries in tiles of 32 in dK/dV)
FLASH_FAULTS = {
    "diagonal key dropped in rows >= T/2":
        lambda t: lambda qp, kp: (qp >= t // 2) & (kp == qp),
    "first 64-key tile dropped in rows >= T/2":
        lambda t: lambda qp, kp: (qp >= t // 2) & (kp < 64),
}


def _flash_case(gen, t, dh, dtype, dev, b=FLASH_B, h=FLASH_H):
    """q/k/v/dO [b, h, t, dh] from a seeded generator; q's row 3 (where
    T > 3) is zero in every head."""
    shape = (b, h, t, dh)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(4))
    if t > 3:
        q[:, :, 3, :] = 0.0
    return [a.to(dtype) for a in (q, k, v, do)]


def _flash_flops(t, dh, causal):
    """Executed forward flops (QKᵀ and P·V); causal counts half the
    square. The backward does 2.5x the forward."""
    f = 4.0 * FLASH_B * FLASH_H * t * t * dh
    return f / 2 if causal else f


def _flash_bound(t, dh, dtype, causal, backward, peak=None):
    """Least time: each operand read once and each output written once
    (fwd: q, k, v -> o, lse; bwd: q, k, v, o, dO, lse -> dq, dk, dv)
    over HBM bytes/s, or the flops over the dtype's peak (f32: the f32-
    accurate rate; ``peak`` overrides it)."""
    el = FLASH_B * FLASH_H * t * dh * (2 if dtype == torch.bfloat16 else 4)
    rows = FLASH_B * FLASH_H * t * 4
    nbytes = (8 * el + 2 * rows) if backward else (4 * el + rows)
    flops = _flash_flops(t, dh, causal) * (2.5 if backward else 1.0)
    if peak is None:
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_ACCURATE_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grad_fn(fn, q, k, v, do, causal):
    """fwd+bwd of ``fn`` as one timed call, and the backward alone on a
    graph kept alive (``retain_graph``)."""
    qr, kr, vr = (a.detach().requires_grad_(True) for a in (q, k, v))

    def both():
        out = fn(qr, kr, vr, causal)
        return torch.autograd.grad(out, (qr, kr, vr), do)

    out = fn(qr, kr, vr, causal)

    def back():
        return torch.autograd.grad(out, (qr, kr, vr), do,
                                   retain_graph=True)

    return both, back


def _sdpa(q, k, v, causal):
    """SDPA as the yardstick; at f32 pinned to its memory-efficient
    backend (SDPBackend.EFFICIENT_ATTENTION), at bf16 left to PyTorch's
    choice."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    pin = (sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)
           if q.dtype == torch.float32 else contextlib.nullcontext())
    with pin:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal)


def _flash_reference_chunked(q, k, v, do, causal, drop=None,
                             rows=FLASH_REF_ROWS):
    """The function of ``flash_attention_reference`` (f32, the exact
    ``dh ** -0.5``, causal by select) over query-row chunks, with dQ,
    dK and dV by autograd chunk by chunk, so a long T never holds its
    [T, T] scores at once. ``do=None`` gives the output alone;
    ``drop(qpos, kpos)`` marks keys to leave out (a planted fault).
    Returns f32 (out,) or (out, dq, dk, dv)."""
    t, dh = q.shape[2], q.shape[3]
    qf, kf, vf = (a.detach().float() for a in (q, k, v))
    grads = do is not None
    out = torch.empty_like(qf)
    if grads:
        dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    neg = torch.tensor(-1e30, device=q.device)
    for s in range(0, t, rows):
        e = min(s + rows, t)
        n = e if causal else t
        qpos = torch.arange(s, e, device=q.device)[:, None]
        kpos = torch.arange(n, device=q.device)[None, :]
        keep = torch.ones(e - s, n, dtype=torch.bool, device=q.device)
        if causal:
            keep &= kpos <= qpos
        if drop is not None:
            keep &= ~drop(qpos, kpos)
        qc, kc, vc = (a[:, :, lo:hi].detach().requires_grad_(grads)
                      for a, lo, hi in ((qf, s, e), (kf, 0, n), (vf, 0, n)))
        with torch.set_grad_enabled(grads):
            sc = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * dh ** -0.5
            w = torch.softmax(torch.where(keep, sc, neg), dim=-1)
            oc = torch.einsum("bhqk,bhkd->bhqd", w, vc)
            if grads:
                gq, gk, gv = torch.autograd.grad(oc, (qc, kc, vc),
                                                 do[:, :, s:e].float())
        out[:, :, s:e] = oc.detach()
        if grads:
            dq[:, :, s:e] = gq
            dk[:, :, :n] += gk
            dv[:, :, :n] += gv
    return (out, dq, dk, dv) if grads else (out,)


def _flash_errors(out, grads, ref, ref_grads) -> dict:
    """The three measures of FLASH_TOL: ``out`` a number, ``grad`` one
    per dq/dk/dv, ``norm`` one per out/dq/dk/dv. A reference grad that
    is zero everywhere (dQ and dK at T=1, where each row's softmax has
    one key and so no gradient) has no scale of its own: its ``grad``
    and ``norm`` are taken against the largest reference grad's."""
    maxes = [float(r.abs().max()) for r in ref_grads]
    norms = [float(r.norm()) for r in ref_grads]

    def scaled(x, own, top):
        return x / (own if own > 0 else top)

    pairs = list(zip(grads, ref_grads))
    return dict(
        out=float((out.float() - ref).abs().max()),
        grad=[scaled(float((g.float() - r).abs().max()), m, max(maxes))
              for (g, r), m in zip(pairs, maxes)],
        norm=[float((out.float() - ref).norm() / ref.norm())]
        + [scaled(float((g.float() - r).norm()), n, max(norms))
           for (g, r), n in zip(pairs, norms)])


def _flash_failed(errs, dtype) -> list:
    """The measures over their limits at ``dtype``."""
    tol = FLASH_TOL[dtype]
    worst = dict(out=errs["out"], grad=max(errs["grad"]),
                 norm=max(errs["norm"]))
    return [m for m in tol if not worst[m] <= tol[m]]


def _flash_log(name, errs, dtype) -> None:
    tol = FLASH_TOL[dtype]
    log(f"{name}: out max_abs_err {errs['out']:.3e} (tol {tol['out']}); "
        f"dq/dk/dv max err / max|ref| {[f'{e:.3e}' for e in errs['grad']]}"
        f" (tol {tol['grad']}); ||err|| / ||ref|| of out/dq/dk/dv "
        f"{[f'{e:.3e}' for e in errs['norm']]} (tol {tol['norm']})")


def _flash_hold(name, dtype, out, grads, ref, ref_grads) -> dict:
    """Hold K1's output and grads against the plain version's; fatal on
    a NaN or a measure over its limit. Returns the measures."""
    errs = _flash_errors(out, grads, ref, ref_grads)
    _flash_log(name, errs, dtype)
    finite = all(bool(torch.isfinite(a).all()) for a in (out, *grads))
    failed = _flash_failed(errs, dtype)
    if not finite or failed:
        raise SystemExit(f"chip_smoke: {name}: over the limit on "
                         f"{failed}, finite {finite}: {errs}")
    return errs


def _k1_grads(q, k, v, do, causal):
    """K1's output and dQ/dK/dV through autograd."""
    from deeplearning4j_tpu_torch.nn.layers.attention import flash_attention

    qr, kr, vr = (a.detach().requires_grad_(True) for a in (q, k, v))
    out = flash_attention(qr, kr, vr, causal)
    grads = torch.autograd.grad(out, (qr, kr, vr), do)
    torch.cuda.synchronize()
    return out.detach(), grads


def flash_rerun_check(name, q, k, v, do, causal) -> None:
    """K1's forward and backward twice on the same inputs: O, LSE, dQ,
    dK and dV must match bit for bit (no atomics, a fixed summation
    order). Fatal on any difference."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    runs = []
    for _ in range(2):
        o, lse = flash_attention_fwd(q, k, v, causal)
        runs.append((o, lse) + flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal))
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"{name}: rerun bit for bit (O, LSE, dQ, dK, dV) {same}")
    if not all(same):
        raise SystemExit(f"chip_smoke: {name}: a rerun of K1 differs: "
                         f"O, LSE, dQ, dK, dV equal {same}")


def flash_long_case(gen, dev) -> tuple:
    """K1 at phase B's shape (B=2, H=8, T=LONG_T, dh=128, bf16, causal)
    held against the chunked plain version (the whole [T, T] scores do
    not fit the card), with its times, the plain version's (its
    backward timed as chunked fwd+bwd less chunked fwd), SDPA's and the
    bounds. Returns the kernels-line entries."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    t, dh, bf16 = LONG_T, WIDTH // N_HEADS, torch.bfloat16
    name = f"flash_attention T={t}, dh={dh}, causal, bfloat16"
    q, k, v, do = _flash_case(gen, t, dh, bf16, dev)
    out, grads = _k1_grads(q, k, v, do, True)
    ref, *ref_grads = _flash_reference_chunked(q, k, v, do, True)
    errs = _flash_hold(name + " (chunked plain)", bf16, out, grads, ref,
                       ref_grads)
    del out, grads, ref, ref_grads
    flash_rerun_check(name, q, k, v, do, True)
    o, lse = flash_attention_fwd(q, k, v, True)
    ms = cuda_time_ms(lambda: flash_attention_fwd(q, k, v, True), iters=5,
                      warmup=1)
    bwd_ms = cuda_time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                      True),
                          iters=5, warmup=1)
    plain_ms = cuda_time_ms(
        lambda: _flash_reference_chunked(q, k, v, None, True), iters=2,
        warmup=1)
    plain_both_ms = cuda_time_ms(
        lambda: _flash_reference_chunked(q, k, v, do, True), iters=2,
        warmup=1)
    lib_ms = cuda_time_ms(lambda: _sdpa(q, k, v, True), iters=5, warmup=1)
    _, l_back = _grad_fn(_sdpa, q, k, v, do, True)
    lib_bwd_ms = cuda_time_ms(l_back, iters=5, warmup=1)
    bound, by = _flash_bound(t, dh, bf16, True, False)
    bbound, bby = _flash_bound(t, dh, bf16, True, True)
    plain_bwd_ms = plain_both_ms - plain_ms
    log(f"{name} times: kernel fwd {ms:.4f} ms, bwd {bwd_ms:.4f} ms; "
        f"chunked plain fwd {plain_ms:.4f}, fwd+bwd {plain_both_ms:.4f}, "
        f"bwd (the difference) {plain_bwd_ms:.4f} ms; sdpa fwd "
        f"{lib_ms:.4f}, bwd {lib_bwd_ms:.4f} ms; bound fwd {bound:.4f} ms "
        f"({by}, {bound / ms:.2%} of it), bwd {bbound:.4f} ms ({bby}, "
        f"{bbound / bwd_ms:.2%} of it)")
    return {
        "flash_attention": dict(
            max_abs_err=errs["out"], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=lib_ms),
        "flash_attention_bwd": dict(
            max_abs_err=max(errs["grad"]), ms=bwd_ms,
            plain_ms=plain_bwd_ms, bound_ms=bbound, bound_by=bby,
            library_ms=lib_bwd_ms)}


def flash_fault_readings(q, k, v, do, ref, ref_grads) -> None:
    """The chunked plain version held against the whole one (f32, so
    at the f32 limits), then each planted fault's readings against the
    bf16 and the f32 limits: the check must fail every fault at both."""
    t = q.shape[2]
    chunked, *c_grads = _flash_reference_chunked(q, k, v, do, True)
    _flash_hold(f"chunked plain vs plain T={t}, float32", torch.float32,
                chunked, c_grads, ref, ref_grads)
    for fault, drop in FLASH_FAULTS.items():
        f_out, *f_grads = _flash_reference_chunked(q, k, v, do, True,
                                                   drop=drop(t))
        errs = _flash_errors(f_out, f_grads, ref, ref_grads)
        _flash_log(f"planted fault T={t}: {fault}", errs, torch.bfloat16)
        for dtype in (torch.bfloat16, torch.float32):
            failed = _flash_failed(errs, dtype)
            log(f"planted fault T={t}: {fault}: caught at "
                f"{str(dtype).split('.')[-1]} by {failed}")
            if not failed:
                raise SystemExit(f"chip_smoke: the {dtype} limits pass a "
                                 f"planted fault ({fault}): {errs}")


def _dense_grad_fn(q, k, v, do):
    from deeplearning4j_tpu_torch.nn.layers.attention import _dense_attention

    both, _ = _grad_fn(
        lambda a, b, c, causal: _dense_attention(a, b, c, causal, None),
        q, k, v, do, True)
    return both


def flash_sweep(gen, dev) -> None:
    """The threshold behind K1's auto dispatch (``FLASH_MIN_T``, one
    for bf16 and f32): K1 fwd+bwd against dense fwd+bwd at B=2, H=8,
    dh=128, causal, with dense's peak memory above its inputs; bf16 over
    FLASH_SWEEP_T, f32 over FLASH_SWEEP_T_F32 up to the first T where
    dense does not fit the card. Logs whether each T's faster path is
    the one the rule picks."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        FLASH_MIN_T,
        flash_attention,
    )

    for dtype, ts in ((torch.bfloat16, FLASH_SWEEP_T),
                      (torch.float32, FLASH_SWEEP_T_F32)):
        sweep = []
        for t in ts:
            iters = 10 if t <= 4096 else 2
            q, k, v, do = _flash_case(gen, t, 128, dtype, dev)
            k_both, _ = _grad_fn(flash_attention, q, k, v, do, True)
            k_ms = cuda_time_ms(k_both, iters=iters, warmup=1)
            del k_both
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                d_both = _dense_grad_fn(q, k, v, do)
                d_ms = cuda_time_ms(d_both, iters=iters, warmup=1)
                d_mem = torch.cuda.max_memory_allocated() - base
                del d_both
            except torch.cuda.OutOfMemoryError:
                d_ms = d_mem = None
            torch.cuda.empty_cache()
            rule = t >= FLASH_MIN_T
            faster = d_ms is None or k_ms < d_ms
            sweep.append((t, k_ms, d_ms, d_mem, rule == faster))
            if d_ms is None:
                break
        log(f"FLASH_MIN_T sweep ({str(dtype).split('.')[-1]}, B=2, H=8, "
            f"dh=128, causal, fwd+bwd ms; dense peak memory above its "
            f"inputs; threshold {FLASH_MIN_T}): " + "; ".join(
                f"T={t}: kernel {a:.4f}, dense "
                + (f"{b:.4f}, dense memory {m / 2**30:.3f} GiB"
                   if b is not None else "does not fit the card")
                + f", rule {'agrees' if ok else 'DISAGREES'}"
                for t, a, b, m, ok in sweep))


def flash_split_check(gen, dev) -> None:
    """K1's f32 split pass (``f32_operands``: big and small tf32
    planes, and those of the transpose in the kernels' row order) held
    against its plain version bit for bit, at phase A's shape and at
    ragged T. Fatal on any difference."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        f32_operands,
        f32_operands_reference,
    )

    same = {}
    modes = ((True, False), (False, True), (True, True), (True, False))
    for t, dh in ((PARITY_T, 128), (77, 128), (1, 64), (2049, 64)):
        xs = [torch.randn((FLASH_B, FLASH_H, t, dh), generator=gen,
                          device=dev) for _ in modes]
        ops = [(x, r, c) for x, (r, c) in zip(xs, modes)]
        # one launch for four operands, as the backward's, and one each
        for i, got in enumerate(f32_operands(ops)
                                + [f32_operands([op])[0] for op in ops]):
            x, r, c = ops[i % len(ops)]
            same[(t, dh, i)] = torch.equal(
                got, f32_operands_reference(x, r, c))
    log(f"flash_attention f32 split pass vs plain, bit for bit (T, dh, "
        f"operand; 0-3 in one launch, 4-7 one launch each): {same}")
    if not all(same.values()):
        raise SystemExit(f"chip_smoke: K1's f32 split pass differs from "
                         f"its plain version: {same}")


def flash_kernel_phase() -> tuple:
    """K1 forward and backward held against the plain version on the
    f32 upcast at phase A's and phase B's shapes and at edge cases;
    planted-fault readings; times; the FLASH_MIN_T sweep. Returns the
    kernels-line entries (bf16 at LONG_T, f32 at phase A's T) and K1's
    fwd + bwd ms at LONG_T."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    before = (flash_attention.launches, flash_attention.bwd_launches)
    flash_split_check(gen, dev)
    entries = {}
    cases = [(2048, 128, True), (1000, 128, True), (2049, 128, True),
             (1024, 64, True), (1024, 128, False),
             # shorter than one tile, or ragged against 128
             (1, 128, True), (77, 128, True), (129, 128, True),
             (77, 64, True)]
    for t, dh, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = _flash_case(gen, t, dh, dtype, dev)
            out, grads = _k1_grads(q, k, v, do, causal)
            qf, kf, vf = (a.float().requires_grad_(True) for a in (q, k, v))
            ref = flash_attention_reference(qf, kf, vf, causal)
            ref_grads = torch.autograd.grad(ref, (qf, kf, vf), do.float())
            ref = ref.detach()
            name = (f"flash_attention T={t}, dh={dh}, "
                    f"{'causal' if causal else 'full'}, "
                    f"{str(dtype).split('.')[-1]}")
            errs = _flash_hold(name, dtype, out, grads, ref, ref_grads)
            if t != 2048:
                continue
            if dtype == torch.float32:
                flash_fault_readings(q, k, v, do, ref, ref_grads)
            flash_rerun_check(name, q, k, v, do, causal)
            qc, kc, vc, oc = (a.contiguous() for a in (q, k, v, out))
            _, lse = flash_attention_fwd(qc, kc, vc, causal)
            ms = cuda_time_ms(lambda: flash_attention_fwd(qc, kc, vc, causal))
            bwd_ms = cuda_time_ms(lambda: flash_attention_bwd(
                qc, kc, vc, oc, lse, do, causal))
            both, _ = _grad_fn(flash_attention, q, k, v, do, causal)
            both_ms = cuda_time_ms(both)
            plain_ms = cuda_time_ms(
                lambda: flash_attention_reference(q, k, v, causal))
            p_both, p_back = _grad_fn(flash_attention_reference, q, k, v, do,
                                      causal)
            plain_bwd_ms = cuda_time_ms(p_back)
            plain_both_ms = cuda_time_ms(p_both)
            lib_ms = cuda_time_ms(lambda: _sdpa(q, k, v, causal))
            l_both, l_back = _grad_fn(_sdpa, q, k, v, do, causal)
            lib_bwd_ms = cuda_time_ms(l_back)
            lib_both_ms = cuda_time_ms(l_both)
            bound, by = _flash_bound(t, dh, dtype, causal, False)
            bbound, bby = _flash_bound(t, dh, dtype, causal, True)
            log(f"{name} times: kernel fwd {ms:.4f} ms, bwd {bwd_ms:.4f} ms,"
                f" fwd+bwd {both_ms:.4f} ms; plain fwd {plain_ms:.4f}, bwd "
                f"{plain_bwd_ms:.4f}, fwd+bwd {plain_both_ms:.4f} ms; sdpa "
                f"fwd {lib_ms:.4f}, bwd {lib_bwd_ms:.4f}, fwd+bwd "
                f"{lib_both_ms:.4f} ms; bound fwd {bound:.4f} ms ({by}, "
                f"{bound / ms:.1%} of it), bwd {bbound:.4f} ms ({bby}, "
                f"{bbound / bwd_ms:.1%} of it)")
            if dtype != torch.float32:
                continue
            qr, kr, vr = (a.detach().requires_grad_(True) for a in (q, k, v))
            s_out = _sdpa(qr, kr, vr, causal)
            s_grads = torch.autograd.grad(s_out, (qr, kr, vr), do)
            _flash_log(f"sdpa (EFFICIENT_ATTENTION) T={t}, dh={dh}, float32 "
                       "(a report, no bar)", _flash_errors(
                           s_out.detach(), s_grads, ref, ref_grads), dtype)
            old, _ = _flash_bound(t, dh, dtype, causal, False, F32_FLOPS)
            bold, _ = _flash_bound(t, dh, dtype, causal, True, F32_FLOPS)
            log(f"{name}: the bound at the CUDA cores' {F32_FLOPS / 1e12:.0f}"
                f" TFLOP/s would be fwd {old:.4f} ms ({old / ms:.1%} of it),"
                f" bwd {bold:.4f} ms ({bold / bwd_ms:.1%} of it)")
            entries["flash_attention_f32"] = dict(
                max_abs_err=errs["out"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=lib_ms)
            entries["flash_attention_f32_bwd"] = dict(
                max_abs_err=max(errs["grad"]), ms=bwd_ms,
                plain_ms=plain_bwd_ms, bound_ms=bbound, bound_by=bby,
                library_ms=lib_bwd_ms)
    entries = {**flash_long_case(gen, dev), **entries}
    flash_sweep(gen, dev)
    flash_attention.launches, flash_attention.bwd_launches = before
    src = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
    rep = "deeplearning4j_tpu/nn/layers/attention.py:729"
    k1_long_ms = (entries["flash_attention"]["ms"]
                  + entries["flash_attention_bwd"]["ms"])
    return [dict(name=name, route="cuda", source=src, replaces=rep, **e)
            for name, e in entries.items()], k1_long_ms


# K3 (conv_taps): LeNet conv1's shape on the training path is B=2048,
# 1 -> 20 channels, 5x5, 28x28 -> 24x24, bf16 x and bf16 W (the net's
# compute dtype), which conv_taps routes to the tensor-core kernel; f32
# operands, and bf16 x with an f32 W, go to the CUDA-core kernel.
# Each case is held against the plain version (the tap loop) on the
# same inputs. f32 differs only in summation order (fused multiply-
# adds): max |err| <= CONV_TOL_F32 * max |ref|. bf16: at most
# CONV_TOL_ULPS bf16 ulp from the plain version run in bf16 (the f32
# sums differ by a rounding or so, then round once; the tensor-core
# kernel recomputes in order each output whose sum cancels).
CONV_B, CONV_O, CONV_K, CONV_HW = 2048, 20, 5, 28
CONV_TOL_F32 = 1e-5
CONV_TOL_ULPS = 1.0
# the planted fault: the centre tap of every channel zeroed
CONV_FAULT_TAP = (2, 2)
_BF16, _F32 = torch.bfloat16, torch.float32
# (batch, kernel size, image size, padding, x dtype, W dtype); the
# first is the main case (the LeNet path's), the second the CUDA-core
# kernel at that shape with f32 W, as the LeNet path ran it before the
# tensor-core kernel
CONV_CASES = (
    (CONV_B, CONV_K, CONV_HW, 0, _BF16, _BF16),
    (CONV_B, CONV_K, CONV_HW, 0, _BF16, _F32),
    (CONV_B, CONV_K, CONV_HW, 0, _F32, _F32),
    (1, CONV_K, CONV_HW, 0, _BF16, _BF16),
    (1, CONV_K, CONV_HW, 0, _F32, _F32),
    (CONV_B + 1, CONV_K, CONV_HW, 0, _BF16, _BF16),
    (CONV_B + 1, CONV_K, CONV_HW, 0, _F32, _F32),
    (64, CONV_K, CONV_HW, 2, _BF16, _BF16),
    (64, CONV_K, CONV_HW, 2, _F32, _F32),
    (64, 3, CONV_HW, 0, _BF16, _BF16), (64, 3, CONV_HW, 0, _F32, _F32),
    (64, 1, CONV_HW, 0, _BF16, _BF16),
    (64, 7, CONV_HW, 3, _BF16, _BF16),
    # 23x23 = 529 output pixels (not a multiple of 16 or 8), H*W odd
    (64, CONV_K, 27, 0, _BF16, _BF16),
    # the CUDA-core kernel's guarded path (1x1, 7x7 padded), its strips
    # past a row's end (23x23), and an output whose 16-byte stores do not
    # line up (bf16, 20 x 529 elements an image)
    (64, 1, CONV_HW, 0, _F32, _F32), (64, 7, CONV_HW, 3, _F32, _F32),
    (64, CONV_K, 27, 0, _F32, _F32), (64, CONV_K, 27, 0, _BF16, _F32),
    # images that fill a block, the output in pieces: the CUDA-core
    # kernel's ring 3 deep (f32 128x128), 4 deep (bf16 x 128x128), 1 deep
    # (f32 200x200), and none, the strips storing from registers (bf16 x
    # 200x200, f32 200x200 padded, f32 240x240: the largest square image
    # whose padded f32 copy and W fit a block at 20 channels)
    (4, CONV_K, 128, 0, _F32, _F32), (4, CONV_K, 128, 0, _BF16, _F32),
    (4, CONV_K, 200, 0, _F32, _F32), (4, CONV_K, 200, 0, _BF16, _F32),
    (4, CONV_K, 200, 2, _F32, _F32), (4, CONV_K, 240, 0, _F32, _F32))
# the CUDA-core kernel with more channels than two output buffers hold:
# (batch, channels, kernel size, image size, padding, x dtype), staged
# in pieces of channel-rows that start and end inside a channel
CONV_PIECE_CASES = ((64, 128, CONV_K, CONV_HW, 0, _F32),
                    (64, 128, CONV_K, CONV_HW, 2, _F32),
                    (64, 50, CONV_K, 27, 0, _BF16))


def _conv_case(gen, b, k, hw, dtype, w_dtype, dev, o=CONV_O):
    """x [b, 1, hw, hw] in ``dtype`` and bf16-representable w [o, k, k]
    in ``w_dtype`` (the bf16 training weights, or their f32 upcast)."""
    x = torch.rand(b, 1, hw, hw, generator=gen, device=dev).to(dtype)
    w = (torch.randn(o, k, k, generator=gen, device=dev)
         * 0.1).bfloat16().to(w_dtype)
    return x, w


def _bf16_ulp_map(got, want):
    """|got - want| in bf16 ulps of the larger magnitude, elementwise."""
    g, r = got.float(), want.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (g - r).abs() / ulp


def _bf16_ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of the larger magnitude."""
    return float(_bf16_ulp_map(got, want).max())


def _conv_errors(got, want) -> dict:
    err = float((got.float() - want.float()).abs().max())
    return dict(max_abs_err=err,
                rel=err / max(float(want.float().abs().max()), 1e-30),
                ulps=_bf16_ulps(got, want))


def _conv_failed(errs, dtype) -> bool:
    if dtype == torch.float32:
        return not errs["rel"] <= CONV_TOL_F32
    return not errs["ulps"] <= CONV_TOL_ULPS


def _conv_bound(b, o, k, hw, pad, dtype):
    """Least time: x read once, out written once (and w), over HBM
    bytes/s, or the multiply-adds (2 flops each) over the card's peak
    for the operands' type: bf16 x with bf16-valued w (``_conv_case``,
    as on the LeNet path) at the bf16 tensor-core rate, f32 at the f32
    rate."""
    ho = hw + 2 * pad - k + 1
    el = 2 if dtype == torch.bfloat16 else 4
    nbytes = (b * hw * hw + b * o * ho * ho) * el + o * k * k * 4
    flops = 2.0 * b * o * k * k * ho * ho
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_ACCURATE_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, t_bytes, t_ops


def _conv_name(b, k, hw, pad, dtype, w_dtype):
    return (f"conv_taps B={b}, {hw}x{hw}, {k}x{k}, pad {pad}, x "
            f"{str(dtype).split('.')[-1]}, W {str(w_dtype).split('.')[-1]}")


def conv_nonfinite_check(x, w) -> None:
    """x with one inf and one NaN (bf16 x and W: the tensor-core kernel;
    f32: the CUDA-core kernel): the non-finite outputs sit exactly where
    the plain version's do, and the finite ones hold the dtype's limit."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        conv_taps,
        conv_taps_reference,
    )

    x = x.clone()
    x[3, 0, 10, 10] = float("inf")
    x[7, 0, 0, x.shape[3] - 1] = float("nan")
    got = conv_taps(x, w)
    torch.cuda.synchronize()
    want = conv_taps_reference(x, w)
    same = {what: bool(torch.equal(fn(got), fn(want))) for what, fn in (
        ("nan", torch.isnan), ("+inf", torch.isposinf),
        ("-inf", torch.isneginf))}
    fin = torch.isfinite(want) & torch.isfinite(got)
    errs = _conv_errors(got[fin], want[fin])
    name = _conv_name(x.shape[0], w.shape[1], x.shape[2], 0, x.dtype,
                      w.dtype)
    log(f"{name} with an inf and a NaN: non-finite outputs "
        f"{int((~torch.isfinite(want)).sum())}, positions as the plain "
        f"version's {same}; finite outputs {errs['ulps']:.2f} bf16 ulps, "
        f"/ max|ref| {errs['rel']:.3e}")
    if not all(same.values()) or _conv_failed(errs, x.dtype):
        raise SystemExit(f"chip_smoke: {name} non-finite case: {same}, "
                         f"{errs}")


def conv_main_checks(x, w, got, want) -> None:
    """A main case rerun bit for bit, and the planted fault (the centre
    tap zeroed) failing the dtype's limit; for f32, whether the kernel's
    output equals the plain version's bit for bit (a report: the kernel
    sums with fused multiply-adds, the plain version rounds each product)."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import conv_taps

    name = _conv_name(x.shape[0], w.shape[1], x.shape[2], 0, x.dtype,
                      w.dtype)
    again = conv_taps(x, w)
    rerun = bool(torch.equal(again, got))
    bad_w = w.clone()
    bad_w[:, CONV_FAULT_TAP[0], CONV_FAULT_TAP[1]] = 0.0
    f_errs = _conv_errors(conv_taps(x, bad_w), want)
    torch.cuda.synchronize()
    caught = _conv_failed(f_errs, x.dtype)
    log(f"{name}: rerun bit-identical {rerun}; output bit-equal to the "
        f"plain version's {bool(torch.equal(got, want))}; planted fault "
        f"(tap {CONV_FAULT_TAP} zeroed): {f_errs['ulps']:.1f} bf16 ulps, "
        f"/ max|ref| {f_errs['rel']:.3e}, max_abs_err "
        f"{f_errs['max_abs_err']:.3e}: caught {caught}")
    if not rerun or not caught:
        raise SystemExit(f"chip_smoke: K3 {name}: rerun identical {rerun}, "
                         f"planted fault {f_errs}")


def conv_pieces_check(gen, dev) -> None:
    """The CUDA-core kernel at CONV_PIECE_CASES (more channels than its
    two output buffers hold) against the plain version, at the dtype's
    limit."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        conv_taps,
        conv_taps_reference,
    )

    for b, o, k, hw, pad, dtype in CONV_PIECE_CASES:
        x, w = _conv_case(gen, b, k, hw, dtype, _F32, dev, o=o)
        mma0 = conv_taps.mma_launches
        got = conv_taps(x, w, (pad, pad))
        torch.cuda.synchronize()
        errs = _conv_errors(got, conv_taps_reference(x, w, (pad, pad)))
        name = f"{_conv_name(b, k, hw, pad, dtype, _F32)}, O={o}"
        log(f"{name} (CUDA cores, staged in pieces): max_abs_err "
            f"{errs['max_abs_err']:.3e}, / max|ref| {errs['rel']:.3e}, "
            f"bf16 ulps {errs['ulps']:.2f}")
        if (conv_taps.mma_launches != mma0 or _conv_failed(errs, dtype)
                or not bool(torch.isfinite(got).all())):
            raise SystemExit(f"chip_smoke: {name}: over the limit or on "
                             f"the wrong route: {errs}")


def conv_kernel_phase() -> list:
    """K3 held against its plain version in every CONV_CASES case, each
    on the route conv_taps must take (bf16 x with bf16 W: the tensor-
    core kernel; the rest: the CUDA-core kernel), plus an inf and a
    NaN in each route's main case (bf16 at B=64, f32 at B=2048); each
    main case rerun bit for bit; the planted fault must fail the bf16
    and the f32 limit; the CUDA-core kernel's guarded any-size path held
    to the same limit, and its output staged in pieces (CONV_PIECE_CASES)
    too. Times at B=2048: the tensor-core kernel, the
    CUDA-core kernel with f32 W (bf16 x, as the LeNet path ran it before
    the tensor-core kernel) and with f32 x and W, cuDNN's ``F.conv2d``,
    the plain version and the bound. Returns the kernels-line entries of
    the two routes (without launches): ``conv_taps``, the tensor-core
    kernel the LeNet path runs, and ``conv_taps_f32``, the CUDA-core
    kernel at f32."""
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        _conv_taps_launch,
        conv_taps,
        conv_taps_plan,
        conv_taps_reference,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    before = (conv_taps.launches, conv_taps.mma_launches)
    entries, mains = {}, {}
    for b, k, hw, pad, dtype, w_dtype in CONV_CASES:
        x, w = _conv_case(gen, b, k, hw, dtype, w_dtype, dev)
        mma0 = conv_taps.mma_launches
        got = conv_taps(x, w, (pad, pad))
        torch.cuda.synchronize()
        mma = conv_taps.mma_launches - mma0 == 1
        want = conv_taps_reference(x, w, (pad, pad))
        errs = _conv_errors(got, want)
        name = _conv_name(b, k, hw, pad, dtype, w_dtype)
        route = "tensor cores" if mma else (
            "CUDA cores, ring stages and channel-rows a piece %s"
            % (conv_taps_plan(CONV_O, hw, hw, k, k, pad, pad,
                              x.element_size()),))
        log(f"{name} ({route}): "
            f"max_abs_err {errs['max_abs_err']:.3e}, / max|ref| "
            f"{errs['rel']:.3e} (f32 tol {CONV_TOL_F32}), bf16 ulps "
            f"{errs['ulps']:.2f} (bf16 tol {CONV_TOL_ULPS})")
        if mma != (dtype == w_dtype == _BF16):
            raise SystemExit(f"chip_smoke: {name} took the wrong route")
        if (_conv_failed(errs, dtype) or got.shape != want.shape
                or not bool(torch.isfinite(got).all())):
            raise SystemExit(f"chip_smoke: {name}: over the limit: {errs}")
        if (b, k, hw, pad) != (CONV_B, CONV_K, CONV_HW, 0):
            continue
        (bound, by), t_bytes, t_ops = _conv_bound(b, CONV_O, k, hw, pad,
                                                  dtype)
        plain_ms = cuda_time_ms(lambda: conv_taps_reference(x, w), iters=20)
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.conv2d(x, w.to(dtype)[:, None]),
            iters=100)
        ms = cuda_time_ms(lambda: conv_taps(x, w), iters=100)
        dev_ms = graph_time_ms(lambda: conv_taps(x, w))
        log(f"{name} times: kernel {ms:.4f} ms (device {dev_ms:.4f} ms, "
            f"a CUDA graph of 20 calls), plain {plain_ms:.4f} ms, cudnn "
            f"conv2d {lib_ms:.4f} ms; bound {bound:.4f} ms ({by}; bytes "
            f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms), {bound / ms:.1%} "
            f"of it ({bound / dev_ms:.1%} of the device time)")
        entry = dict(max_abs_err=errs["max_abs_err"], ms=ms,
                     plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     library_ms=lib_ms)
        if mma or dtype == _F32:
            entries["conv_taps" if mma else "conv_taps_f32"] = entry
            mains[dtype] = (x, w, got, want)
        else:
            guarded = _conv_taps_launch(x, w, (0, 0), guarded=True)
            g_errs = _conv_errors(guarded, want)
            guarded_ms = cuda_time_ms(
                lambda: _conv_taps_launch(x, w, (0, 0), guarded=True),
                iters=100)
            log(f"{name}: the CUDA-core kernel's guarded any-size path "
                f"{guarded_ms:.4f} ms "
                f"({guarded_ms / ms:.2f}x its 5x5 path), bf16 ulps "
                f"{g_errs['ulps']:.2f}")
            if _conv_failed(g_errs, dtype):
                raise SystemExit(f"chip_smoke: {name}, guarded path: over "
                                 f"the limit: {g_errs}")

    for x, w, got, want in mains.values():
        conv_main_checks(x, w, got, want)
    conv_nonfinite_check(*_conv_case(gen, 64, CONV_K, CONV_HW, _BF16, _BF16,
                                      dev))
    conv_nonfinite_check(*mains[_F32][:2])
    conv_pieces_check(gen, dev)
    conv_taps.launches, conv_taps.mma_launches = before
    src = "deeplearning4j_tpu_torch/csrc/conv_taps.cu"
    rep = "scripts/lenet_breakdown.py:148"
    return [dict(name=n, route="cuda", source=src, replaces=rep, **e)
            for n, e in entries.items()]


# training: the flagship at full width on the Markov task
TRAIN_VOCAB, TRAIN_B = 64, 2
PARITY_T, PARITY_STEPS = 2048, 4
# loss-trajectory agreement, K1 net vs dense net (ROADMAP's 5e-3 at f32
# with TF32 off; bf16 rounds at other places in the two attentions)
PARITY_RTOL = {"float32": 5e-3, "bfloat16": 2e-2}
# at f32 the params after the 4 steps agree too (max |diff|; 1.2e-6
# measured). At bf16 they are not held: Adam's normalized step turns
# rounding-level gradient differences into lr-sized param differences.
PARITY_PARAM_ATOL = {"float32": 1e-5}
# bench.py's 32k long-context row: 1 warm-up and 2 timed steps
LONG_T, LONG_STEPS = 32768, 3


def _flagship(compute_dtype, use_flash, **kw):
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship

    conf = transformer_lm_flagship(vocab=TRAIN_VOCAB, width=WIDTH,
                                   n_layers=N_LAYERS, n_heads=N_HEADS,
                                   seed=11, **kw)
    for c in conf.confs:
        if compute_dtype != "float32":
            c.compute_dtype = compute_dtype
        if hasattr(c.layer, "use_flash"):
            c.layer.use_flash = use_flash
    return conf


def _markov_batches(n_batches, t, sample_seed):
    from deeplearning4j_tpu_torch.datasets.markov import markov_lm_batches

    f, y, floor = markov_lm_batches(TRAIN_VOCAB, TRAIN_B * n_batches, t,
                                    seed=0, sample_seed=sample_seed)
    return [(f[i:i + TRAIN_B], y[i:i + TRAIN_B])
            for i in range(0, len(f), TRAIN_B)], floor


def _train(net, batches):
    """fit each batch; returns the losses and the wall of each step."""
    losses, walls = [], []
    for f, y in batches:
        t0 = time.perf_counter()
        net.fit(f, y)
        losses.append(float(net.score_value))   # syncs the step
        walls.append(time.perf_counter() - t0)
    return losses, walls


def training_parity_phase(card: str) -> dict:
    """Phase A: two flagship nets from the same params, one on K1 and
    one on dense attention, 4 fit steps each at B=2, T=2048; the loss
    trajectories agree and K1 launched 8 times per step each way.
    Returns K1's f32 launches (forward, backward) on this run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    batches, _ = _markov_batches(PARITY_STEPS, PARITY_T, sample_seed=1)
    launches = {}
    for cd in ("float32", "bfloat16"):
        kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
        k1 = MultiLayerNetwork(_flagship(cd, True, **kw),
                               device=DEVICE).init()
        dense = MultiLayerNetwork(_flagship(cd, False, **kw),
                                  device=DEVICE).init()
        for key, p in k1.param_table().items():
            dense.set_param(key, p)
        flash_attention.launches = flash_attention.bwd_launches = 0
        paged_attention.launches = 0
        k_loss, k_wall = _train(k1, batches)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        d_loss, d_wall = _train(dense, batches)
        dense_launches = flash_attention.launches - fwd
        rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, d_loss))
        pdiff = max(float((k1.param_table()[k] - p).abs().max())
                    for k, p in dense.param_table().items())
        p_tol = PARITY_PARAM_ATOL.get(cd, float("inf"))
        log(f"training A [{cd}]: K1 losses {[f'{x:.6f}' for x in k_loss]}, "
            f"dense {[f'{x:.6f}' for x in d_loss]}; max rel diff {rel:.3e} "
            f"(tol {PARITY_RTOL[cd]}); max |param diff| {pdiff:.3e} (tol "
            f"{p_tol}); K1 launches fwd {fwd}, bwd {bwd} over "
            f"{PARITY_STEPS} steps; s/step K1 {[round(w, 4) for w in k_wall]}"
            f", dense {[round(w, 4) for w in d_wall]} [{card}]")
        want = N_LAYERS * PARITY_STEPS
        if (not rel <= PARITY_RTOL[cd] or not pdiff <= p_tol
                or fwd != want or bwd != want
                or dense_launches != 0 or paged_attention.launches != 0
                or not all(np.isfinite(k_loss + d_loss))):
            raise SystemExit(
                f"chip_smoke: training phase A [{cd}] failed: rel {rel}, "
                f"param diff {pdiff}, K1 launches {fwd}/{bwd} (want "
                f"{want}), dense net's {dense_launches}, paged "
                f"{paged_attention.launches}")
        del k1, dense
        torch.cuda.empty_cache()
        s_fwd, s_bwd = training_scan_check(
            card, f"training A [{cd}]",
            lambda: MultiLayerNetwork(_flagship(cd, True, **kw),
                                      device=DEVICE).init(),
            batches, N_LAYERS)
        if cd == "float32":
            launches = {"flash_attention_f32": fwd + s_fwd,
                        "flash_attention_f32_bwd": bwd + s_bwd}
    return launches


def _nets_equal(a, b) -> bool:
    """Whether two nets hold the same params, updater state and layer
    state (BatchNorm statistics, MoE aux losses), bit for bit."""
    from deeplearning4j_tpu_torch.nn.streaming import tree_leaves

    la = (tree_leaves(a.params) + tree_leaves(a.updater_state)
          + tree_leaves(a.state))
    lb = (tree_leaves(b.params) + tree_leaves(b.updater_state)
          + tree_leaves(b.state))
    return (len(la) == len(lb) and a.iteration == b.iteration
            and all(torch.equal(x, y) for x, y in zip(la, lb)))


def _timed_scan(net, feats, labels) -> float:
    """One fit_scan window, synchronised; its seconds per step."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit_scan(feats, labels)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / feats.shape[0]


def training_scan_check(card: str, label: str, make, batches,
                        n_attn: int) -> tuple:
    """A ``fit_scan`` check: the batches as one window, on a net from
    ``make()`` that replays its captured train step and on another from
    ``make()`` (the same params) that runs the step eagerly
    (``train_graphs = None``, the private switch); after each of 2
    windows their params, updater state and layer state are
    bit-identical. The first window captures the graph (its warm-up
    runs the step once more on copies); over the second K1 launches
    ``n_attn`` times forward and backward per step, all through the
    replays. Returns those launches (forward, backward)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import flash_attention

    feats = torch.as_tensor(np.stack([f for f, _ in batches]),
                            device=DEVICE)
    labels = torch.as_tensor(np.stack([y for _, y in batches]),
                             device=DEVICE)
    graph, eager = make(), make()
    eager.train_graphs = None
    same = [_nets_equal(graph, eager)]
    t0 = time.perf_counter()
    graph.fit_scan(feats, labels)                 # captures the step
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    eager.fit_scan(feats, labels)
    same.append(_nets_equal(graph, eager))
    flash_attention.launches = flash_attention.bwd_launches = 0
    g_s = _timed_scan(graph, feats, labels)
    fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
    e_s = _timed_scan(eager, feats, labels)
    same.append(_nets_equal(graph, eager))
    runner = graph.train_graphs
    log(f"{label}: fit_scan, {len(batches)} steps a window, from its "
        f"captured graph against the eager loop from the same params: "
        f"params, updater and layer state bit-identical {same} (start, "
        f"after each window); graph {g_s:.4f} s/step, eager {e_s:.4f} "
        f"s/step ({e_s / g_s:.3f}x); first window with the capture "
        f"{capture_s:.3f} s; {len(runner)} graph ({runner.captures} "
        f"capture; {_graph_memory(runner)}); K1 launches over "
        f"the second graph window fwd {fwd}, bwd {bwd} [{card}]")
    want = n_attn * len(batches)
    if (not all(same) or fwd != want or bwd != want or len(runner) != 1
            or runner.captures != 1):
        raise SystemExit(
            f"chip_smoke: {label} fit_scan failed: "
            f"bit-identical {same}, K1 launches {fwd}/{bwd} (want {want}),"
            f" graphs {len(runner)} ({runner.captures} captures)")
    del graph, eager
    torch.cuda.empty_cache()
    return fwd, bwd


def training_long_phase(card: str, k1_ms: float) -> dict:
    """Phase B: bench.py's long-context row (width 1024, 8 blocks, 8
    heads, bf16, lr 3e-4, warmup 10, total 1000) at B=2, T=32768 on
    Markov tokens: 1 warm-up and 2 timed fit steps, K1 in auto mode.
    ``k1_ms`` is K1's fwd + bwd ms at this shape (kernels phase).
    Returns K1's launches on this run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    t = LONG_T
    batches, floor = _markov_batches(LONG_STEPS, t, sample_seed=2)
    net = MultiLayerNetwork(_flagship("bfloat16", None, lr=3e-4,
                                      warmup_steps=10, total_steps=1000),
                            device=DEVICE).init()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.bwd_launches = 0
    paged_attention.launches = 0
    losses, walls = _train(net, batches)
    fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.mean(walls[1:]))
    dense_gb = TRAIN_B * N_HEADS * t * t * 2 / 1e9
    log(f"training B: T={t}, B={TRAIN_B}, bf16; losses "
        f"{[f'{x:.6f}' for x in losses]} (entropy floor {floor:.4f}); "
        f"s/step {[round(w, 3) for w in walls]} (first is warm-up); "
        f"{TRAIN_B * t / step_s:.1f} tokens/s over the timed steps; peak "
        f"memory {peak / 2**30:.3f} GiB; K1 launches fwd {fwd}, bwd {bwd} "
        f"[{card}]. Dense path not attempted: its scores alone are "
        f"[{TRAIN_B}, {N_HEADS}, {t}, {t}] bf16 = {dense_gb:.1f} GB per "
        "layer")
    want = N_LAYERS * LONG_STEPS
    if (not all(np.isfinite(losses)) or fwd != want or bwd != want
            or paged_attention.launches != 0):
        raise SystemExit(f"chip_smoke: training phase B failed: losses "
                         f"{losses}, K1 launches {fwd}/{bwd} (want {want})")
    del net
    torch.cuda.empty_cache()
    log(f"training B: K1 {N_LAYERS} layers x (fwd + bwd) = "
        f"{N_LAYERS * k1_ms / 1e3 / step_s:.1%} of the step (K1 timed "
        "alone at this shape in the kernels phase)")
    return {"flash_attention": fwd, "flash_attention_bwd": bwd}


# the serving gate, the kernel engine against the plain engine (the
# gather program, use_flash_paged=False), at prompt seed 0. It decides
# at f32: the greedy ids identical on every request (ROADMAP: "greedy
# ids identical at f32"), for the kernel engine and for a right program
# (the plain one with its score sums reordered), while each planted
# fault in the plain engine's attention must differ. At bf16 it prints
# the kernel engine's free-running id agreement with the plain engine,
# per request, with the f32 log-probability gap at each first
# divergence: a report, with no bar. On these random weights no bf16
# reading separates right programs from the "newest key dropped" fault
# (PERF.md §6; ROADMAP Queue 3, item 5, closed with that ruling).
# The prompt sets default_rng(s), s in SERVING_SEEDS, are those of
# scripts/torch_serving_agreement.py's readings over seeds.
SERVING_SEEDS = tuple(range(8))


def _paged_fault_newest_key_dropped(ref):
    """Each query placed one position early: its newest key (its own)
    is no longer causal and its V lane is zeroed; past the window one
    key older than the window is admitted."""
    def fn(q, pk, pv, bid, bval, lo_blk, floor, filled, lengths, *, tm):
        return ref(q, pk, pv, bid, bval, lo_blk, floor, filled - 1,
                   lengths, tm=tm)
    return fn


def _paged_fault_scale_squared(ref):
    """Scores scaled by dh^-1 in place of dh^-1/2."""
    def fn(q, pk, pv, *rest, tm):
        return ref(q * q.shape[-1] ** -0.5, pk, pv, *rest, tm=tm)
    return fn


def reordered_sums(ref):
    """A right program: the plain version with its score sums over dh
    taken in reverse order (the same function, other roundings)."""
    def fn(q, pk, pv, *rest, tm):
        return ref(q.flip(-1), pk.flip(-1), pv.flip(-1), *rest,
                   tm=tm).flip(-1)
    return fn


def _paged_fault_old_keys_dropped(ref):
    """Keys more than 16 positions behind each row's first query are
    ignored (its ``floor`` raised)."""
    def fn(q, pk, pv, bid, bval, lo_blk, floor, filled, lengths, *, tm):
        return ref(q, pk, pv, bid, bval, lo_blk,
                   torch.maximum(floor, filled - 16), filled, lengths,
                   tm=tm)
    return fn


#: planted faults of the plain engine's attention the f32 gate must
#: reject (each wraps ``paged_attention_reference``)
PLANTED_FAULTS = {"newest key dropped": _paged_fault_newest_key_dropped,
                  "scale squared": _paged_fault_scale_squared}
#: the MoE LM's (phase 19b): its attention scores are ~1e-2 on random
#: weights, so "scale squared" moves its probabilities by ~1e-7, inside
#: f32 summation noise; that one is run and reported, not gated
MOE_PLANTED_FAULTS = {"newest key dropped": _paged_fault_newest_key_dropped,
                      "old keys dropped": _paged_fault_old_keys_dropped}


@contextlib.contextmanager
def paged_reference_wrapped(wrap):
    """Within the block, the plain paged attention (the gather program
    ``_paged_attend`` calls for ``use_flash_paged=False``) is
    ``wrap(paged_attention_reference)``; ``wrap=None`` leaves it. The
    CUDA kernel is untouched."""
    from deeplearning4j_tpu_torch.nn.layers import attention

    ref = attention.paged_attention_reference
    if wrap is not None:
        attention.paged_attention_reference = wrap(ref)
    try:
        yield
    finally:
        attention.paged_attention_reference = ref


def serving_prompts(seed: int, n=None, length=None, vocab=None) -> list:
    """The serving workload's prompts from ``default_rng(seed)``: ``n``
    (N_REQUESTS) prompts of ``length`` (PROMPT_LEN) ids below ``vocab``
    (VOCAB)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab or VOCAB, length or PROMPT_LEN).tolist()
            for _ in range(n or N_REQUESTS)]


def serve_ids(engine, prompts, n_gen=None) -> tuple:
    """Greedy-serve ``prompts`` on ``engine``, ``n_gen`` (N_GEN) new
    tokens each; returns the results in submission order and the wall
    seconds of the run."""
    from deeplearning4j_tpu_torch.serving import Request

    ids = [engine.submit(Request(list(p), n_gen or N_GEN)) for p in prompts]
    t0 = time.perf_counter()
    res = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return [res[i] for i in ids], time.perf_counter() - t0


def request_agreement(a, b) -> float:
    """The share of positions where two id sequences of one request
    agree; a position only one of them reached counts as a
    disagreement."""
    n = max(len(a), len(b))
    if n == 0:
        return 1.0
    m = min(len(a), len(b))
    return float((np.asarray(a[:m]) == np.asarray(b[:m])).sum()) / n


def agreement(runs_a, runs_b) -> list:
    """:func:`request_agreement` of each request of two runs, in order."""
    if len(runs_a) != len(runs_b):
        raise ValueError(
            f"runs of {len(runs_a)} and {len(runs_b)} requests")
    return [request_agreement(a, b) for a, b in zip(runs_a, runs_b)]


def first_divergence(a, b):
    """The first position where two id sequences differ (the shorter
    one's length if one is a prefix of the other), or None when they
    are identical."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def logprob_gap(net, prompt, shared, tok_a: int, tok_b: int) -> float:
    """log p(tok_a) - log p(tok_b) for the token after ``prompt`` +
    ``shared``, from ``net.output`` (a full forward, no cache) of an
    LM-shaped net (an MLN or a graph) with one-hot input. Near 0 means a
    near-tie."""
    ids = torch.as_tensor(list(prompt) + list(shared), dtype=torch.long)
    graph = hasattr(net, "lm_shape")      # a ComputationGraph
    vocab = net.lm_shape()[2] if graph else net.conf.confs[0].layer.n_in
    x = torch.nn.functional.one_hot(ids, vocab).T[None].float()
    out = net.output(x)
    probs = (out[0] if graph else out)[0, :, -1].double()
    return float(torch.log(probs[tok_a]) - torch.log(probs[tok_b]))


def _serving_net(compute_dtype: str, device=None):
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = transformer_lm_flagship(vocab=VOCAB, width=WIDTH,
                                   n_layers=N_LAYERS, n_heads=N_HEADS,
                                   seed=11)
    for c in conf.confs:
        if compute_dtype != "float32":
            c.compute_dtype = compute_dtype
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = WINDOW
    return MultiLayerNetwork(conf, device=device or DEVICE).init()


def decode_forward_sync_check(eng, prompts) -> None:
    """One decode step's network forward (``DecodeEngine._forward``, the
    paged attend with its K/V scatter and K2 in every layer) over full
    slots, run under ``torch.cuda.set_sync_debug_mode("error")``: any
    host synchronisation in it raises. Fatal if one does."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.serving import Request

    for p in prompts[:N_SLOTS]:
        eng.submit(Request(list(p), N_GEN))
    eng.step()                   # admissions and one round
    active = sum(s is not None for s in eng._slots)
    with torch.no_grad():
        rnn = eng._paged_rnn_rows(eng._kv_tabs)
        x = F.one_hot(eng._toks.long(), eng.vocab).to(
            eng.net._dtype)[:, :, None]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = eng._forward(x, None, rnn)
        except RuntimeError as e:
            raise SystemExit(f"chip_smoke: a decode step's forward syncs "
                             f"the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out).all()) or active != N_SLOTS:
        raise SystemExit(f"chip_smoke: sync check: {active} active slots, "
                         "non-finite output")
    log(f"serving: one decode step's forward over {active} slots ran under "
        "set_sync_debug_mode('error') without a host sync")
    eng.run()


def near_tie_report(net32, prompts, ids_a, ids_b, label) -> None:
    """For each request whose two id runs diverge: the first divergent
    position, the two tokens, and log p(a) - log p(b) there from the
    f32 ``net.output`` forward on the shared prefix. Evidence only."""
    for r, (p, a, b) in enumerate(zip(prompts, ids_a, ids_b)):
        at = first_divergence(a, b)
        if at is None or at >= min(len(a), len(b)):
            continue
        gap = logprob_gap(net32, p, a[:at], a[at], b[at])
        log(f"  {label} request {r}: first divergence at token {at}: "
            f"{a[at]} vs {b[at]}, f32 log-prob gap {gap:+.4e}")


def serving_phase(card: str) -> int:
    """The flagship served by the paged-KV engine on the card (the main
    run: bf16, prompt seed 0, timed), one decode step's forward checked
    for host syncs, then the serving gate: f32 ids identical between the
    kernel engine and the plain engine, and between the plain engine and
    a right program (the plain one with reordered sums); each planted
    fault rejected by that check. Beside it, as a report, the main run's
    bf16 free-running id agreement with the plain engine at prompt seed
    0, with a near-tie report for each request that diverges. Returns
    the paged-attention kernel's launches on the main run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    net = _serving_net("bfloat16")
    # the forward is right on a small input: finite softmax rows
    x = torch.zeros(2, VOCAB, 16, device=DEVICE)
    x[:, 3, :] = 1.0
    probs = net.output(x)
    sums = probs.sum(dim=1)
    if (probs.shape != (2, VOCAB, 16) or not torch.isfinite(probs).all()
            or float((sums - 1).abs().max()) > 1e-4):
        raise SystemExit(f"chip_smoke: flagship output() is wrong: shape "
                         f"{tuple(probs.shape)}, row sums {sums}")
    geometry = dict(paged_kv=True, block_tokens=BLOCK_TOKENS,
                    n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK)
    prompts = serving_prompts(0)

    eng = DecodeEngine(net, **geometry)
    r0 = _reserved()
    eng.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))   # warm-up
    eng.run()                    # captures the decode round's graph
    graph_mem = _reserved() - r0 - _tree_bytes(eng._pool)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps0 = eng.stats["decode_steps"]
    paged_attention.launches = 0
    results, wall = serve_ids(eng, prompts)
    launches = paged_attention.launches
    steps = eng.stats["decode_steps"] - steps0
    peak = torch.cuda.max_memory_allocated()
    bad = [(r.id, r.finish_reason, len(r.tokens)) for r in results
           if r.finish_reason != "length" or len(r.tokens) != N_GEN]
    if bad:
        raise SystemExit(f"chip_smoke: requests did not finish: {bad}")
    if launches != N_LAYERS * steps or launches == 0:
        raise SystemExit(
            f"chip_smoke: paged_attention launched {launches} times for "
            f"{steps} decode steps x {N_LAYERS} layers")
    counts = eng.compile_counts()
    if counts["decode"] != 1 or eng._graphs.captures != 1:
        raise SystemExit(f"chip_smoke: the paged decode round is not one "
                         f"captured graph: {counts}, "
                         f"{eng._graphs.captures} captures")
    ttft = float(np.median([r.ttft_s for r in results]))
    rate = N_REQUESTS * N_GEN / wall
    log(f"serving (kernel): {N_REQUESTS} requests x {N_GEN} tokens, "
        f"{rate:.1f} tokens/s aggregate, median TTFT "
        f"{ttft * 1e3:.1f} ms, peak memory {peak / 2**30:.3f} GiB, "
        f"{steps} decode steps, {launches} kernel launches; the decode "
        f"round one captured graph ({counts}), its memory "
        f"{graph_mem / 2**20:.1f} MiB [{card}]")
    decode_forward_sync_check(eng, prompts)
    del eng
    eager = DecodeEngine(net, **geometry)
    eager._graphs = None          # the round body, eagerly
    eager.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))
    eager.run()
    eager_res, eager_wall = serve_ids(eager, prompts)
    eager_rate = N_REQUESTS * N_GEN / eager_wall
    same = [r.tokens for r in eager_res] == [r.tokens for r in results]
    log(f"serving (kernel), graph rounds against eager rounds: "
        f"{rate:.1f} against {eager_rate:.1f} tokens/s "
        f"({rate / eager_rate:.2f}x); ids "
        f"identical {same} [{card}]")
    del eager

    net32 = _serving_net("float32")
    for key, p in net.param_table().items():
        net32.set_param(key, p)

    def free_ids(model, use_flash_paged, seed, wrap=None):
        with paged_reference_wrapped(wrap):
            res, secs = serve_ids(DecodeEngine(
                model, use_flash_paged=use_flash_paged, **geometry),
                serving_prompts(seed))
        return [r.tokens for r in res], secs

    def rounded(xs):
        return [round(x, 4) for x in xs]

    def mean(xs):
        return float(np.mean(xs))

    # f32, the gate: identical ids, the kernel engine and a right program
    # against the plain engine; each planted fault must differ
    kernel32, _ = free_ids(net32, True, 0)
    plain32, _ = free_ids(net32, False, 0)
    reord32, _ = free_ids(net32, False, 0, reordered_sums)
    identical = kernel32 == plain32
    right32 = reord32 == plain32
    log(f"serving gate f32, prompt seed 0: kernel ids identical to plain "
        f"{identical} (per request {rounded(agreement(kernel32, plain32))})"
        f"; plain with reordered sums identical {right32}")
    near_tie_report(net32, prompts, kernel32, plain32, "f32 seed 0")

    # bf16, a report: the main run's free-running agreement with the
    # plain engine at prompt seed 0
    kernel16 = [r.tokens for r in results]
    plain16, plain_wall = free_ids(net, False, 0)
    per = agreement(kernel16, plain16)
    log(f"serving bf16 report, prompt seed 0: free-running id agreement of "
        f"the kernel engine with the plain engine {mean(per):.4f} (per "
        f"request {rounded(per)}; no bar: on these random weights no bf16 "
        f"reading separates right programs from a planted fault); plain "
        f"engine {N_REQUESTS * N_GEN / plain_wall:.1f} tokens/s [{card}]")
    near_tie_report(net32, prompts, kernel16, plain16,
                    "bf16 seed 0, kernel vs plain")

    caught = {}
    for name, wrap in PLANTED_FAULTS.items():
        fault32, _ = free_ids(net32, False, 0, wrap)
        caught[name] = fault32 != kernel32
        log(f"serving gate, planted fault ({name}) in the plain engine: f32 "
            f"ids identical {not caught[name]} (per request "
            f"{rounded(agreement(kernel32, fault32))})")
    log(f"serving gate: f32 ids identical {identical} (right program "
        f"{right32}); planted faults rejected {caught} [{card}]")
    if not identical or not right32 or not all(caught.values()):
        raise SystemExit(
            f"chip_smoke: serving gate failed: f32 ids identical "
            f"{identical}, right program identical {right32}, planted "
            f"faults rejected {caught}")
    return launches + fused_serving_check(card, net, net32, results, rate)


# fused and async rounds at the serving shape: 4 rounds of 32 tokens
# cover one request's 128 new tokens
FUSED_ROUNDS = 4
SAMPLED_REQUESTS, SAMPLED = 4, dict(temperature=0.9, top_k=4)


def _graph_counts(counts) -> tuple:
    return counts["decode"], counts["fused_decode"]


def _graph_memory(runner) -> str:
    """Each graph's reserved-memory growth and capture seconds (warm-up
    and instantiation included)."""
    return ", ".join(f"{k}: {v / 2**20:.1f} MiB, {runner.seconds[k]:.3f} s"
                     for k, v in runner.memory.items())


def serve_requests(engine, prompts, kws) -> list:
    """Serve ``prompts`` (N_GEN new tokens each, ``kws[i]`` the i-th
    request's sampling) and return their ids in submission order."""
    from deeplearning4j_tpu_torch.serving import Request

    rids = [engine.submit(Request(list(p), N_GEN, **kw))
            for p, kw in zip(prompts, kws)]
    res = engine.run()
    return [res[i].tokens for i in rids]


def fused_serving_check(card: str, net, net32, stepped, stepped_rate
                        ) -> int:
    """Phase 6's fused and async rounds: the same paged run with
    ``fused_rounds=4`` and ``async_rounds=True`` (bf16, timed after a
    run that captures its graphs): every request finishes, K2 launched
    once per layer per decode step the device ran (K * chunk a fused
    window), ``decode`` <= 1 and ``fused_decode`` <= 3 graphs and none
    more on the timed repeat; tokens/s against a stepped engine on graph
    rounds (medians of 3 interleaved runs), beside the main run's
    ``stepped_rate``, and ids against its bf16 ids ``stepped`` (a
    report). At f32 the
    ids equal the stepped engine's on graph rounds; with 4 sampled
    requests the fused engine's ids equal a stepped engine's from the
    same seed. Returns K2's launches over the timed run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    geometry = dict(paged_kv=True, block_tokens=BLOCK_TOKENS,
                    n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                    use_flash_paged=True)
    knobs = dict(fused_rounds=FUSED_ROUNDS, async_rounds=True)
    prompts = serving_prompts(0)
    eng = DecodeEngine(net, **geometry, **knobs)
    ref = DecodeEngine(net, **geometry)          # stepped, for the timing
    for e in (eng, ref):
        e.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))
        e.run()
    t0 = time.perf_counter()
    serve_ids(eng, prompts)                      # captures the rest
    capture_run_s = time.perf_counter() - t0
    serve_ids(ref, prompts)
    counts0 = eng.compile_counts()
    steps0, chunks0 = eng.stats["decode_steps"], eng.stats["chunks"]
    paged_attention.launches = 0
    results, wall = serve_ids(eng, prompts)
    launches = paged_attention.launches
    steps = eng.stats["decode_steps"] - steps0
    chunks = eng.stats["chunks"] - chunks0
    walls = {"fused": [wall], "stepped": []}
    for name, e in (("stepped", ref), ("stepped", ref), ("fused", eng),
                    ("fused", eng), ("stepped", ref)):
        walls[name].append(serve_ids(e, prompts)[1])
    counts1 = eng.compile_counts()
    rate = N_REQUESTS * N_GEN / float(np.median(walls["fused"]))
    ref_rate = N_REQUESTS * N_GEN / float(np.median(walls["stepped"]))
    del ref
    fused_k = eng.histograms["serving_fused_rounds"]
    host = eng.histograms["serving_host_step_s"]
    same16 = [r.tokens for r in results] == [r.tokens for r in stepped]
    bad = [(r.id, r.finish_reason, len(r.tokens)) for r in results
           if r.finish_reason != "length" or len(r.tokens) != N_GEN]
    log(f"serving fused+async (fused_rounds={FUSED_ROUNDS}): {rate:.1f} "
        f"tokens/s aggregate against {ref_rate:.1f} on stepped graph "
        f"rounds ({rate / ref_rate:.3f}x; medians of 3 interleaved runs, "
        f"walls {({k: [round(w, 4) for w in v] for k, v in walls.items()})}"
        f" s; the main run's stepped rate {stepped_rate:.1f}); "
        f"{chunks} dispatches for "
        f"{steps} decode steps, {launches} K2 launches; decode / "
        f"fused_decode graphs {_graph_counts(counts0)} -> "
        f"{_graph_counts(counts1)}; graphs "
        f"{{{_graph_memory(eng._graphs)}}}; "
        f"fused K observed {fused_k.count} times (mean "
        f"{fused_k.sum / max(fused_k.count, 1):.2f}); host step p50 "
        f"{host.quantile(0.5) * 1e3:.3f} ms over {host.count}; the first "
        f"run with its captures {capture_run_s:.3f} s; bf16 ids identical "
        f"to stepped graph rounds {same16} (a report) [{card}]")
    if (bad or launches != N_LAYERS * steps or launches == 0
            or counts1 != counts0 or counts1["decode"] > 1
            or not 1 <= counts1["fused_decode"] <= 3):
        raise SystemExit(
            f"chip_smoke: fused serving failed: unfinished {bad}, K2 "
            f"launches {launches} for {steps} steps x {N_LAYERS} layers, "
            f"compile_counts {counts0} -> {counts1}")
    del eng

    ids = {}
    for name, kw in (("stepped", {}), ("fused", knobs)):
        e = DecodeEngine(net32, **geometry, **kw)
        ids[name] = [r.tokens for r in serve_ids(e, prompts)[0]]
        del e
    kws = [SAMPLED if i < SAMPLED_REQUESTS else {}
           for i in range(N_REQUESTS)]
    sampled = {}
    for name, kw in (("stepped", {}), ("fused", knobs)):
        e = DecodeEngine(net, seed=5, **geometry, **kw)
        sampled[name] = serve_requests(e, prompts, kws)
        del e
    same32 = ids["fused"] == ids["stepped"]
    same_sampled = sampled["fused"] == sampled["stepped"]
    moved = sum(a != b for a, b in zip(sampled["fused"][:SAMPLED_REQUESTS],
                                       [r.tokens for r in stepped]))
    log(f"serving fused+async: f32 ids identical to stepped graph rounds "
        f"{same32}; {SAMPLED_REQUESTS} sampled requests (temperature "
        f"{SAMPLED['temperature']}, top-k {SAMPLED['top_k']}) identical to "
        f"a stepped engine's from the same seed {same_sampled} ({moved} of "
        f"them differ from their greedy run) [{card}]")
    if not same32 or not same_sampled:
        raise SystemExit(f"chip_smoke: fused serving failed: f32 ids "
                         f"identical {same32}, sampled {same_sampled}")
    torch.cuda.empty_cache()
    return launches


def fused_decode_phase(card: str) -> None:
    """bench.py's ``bench_fused_decode`` row 1 (width 1024, 8 blocks, 8
    heads, window 2048; the default dense engine at ``n_slots=1``,
    ``decode_chunk=1``; a 16-token prompt from default_rng(0), 129 new
    tokens), ``fused_rounds=8`` against stepped rounds, at bf16 and f32:
    ids bit-identical, exactly one fused graph (K=8) and none more on
    the repeats; tokens/s of both, median of 3 interleaved runs after a
    warm run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    prompt = np.random.default_rng(0).integers(0, VOCAB, 16).tolist()
    n_gen, fuse_k = 129, 8
    for cd in ("bfloat16", "float32"):
        net = _serving_net(cd)
        engines = {"stepped": DecodeEngine(net, n_slots=1, decode_chunk=1),
                   "fused": DecodeEngine(net, n_slots=1, decode_chunk=1,
                                         fused_rounds=fuse_k)}

        def one(eng):
            rid = eng.submit(Request(list(prompt), n_gen))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = eng.run()[rid].tokens
            torch.cuda.synchronize()
            return tokens, n_gen / (time.perf_counter() - t0)

        flash_attention.launches = paged_attention.launches = 0
        warm = {name: one(e)[0] for name, e in engines.items()}
        counts0 = engines["fused"].compile_counts()
        keys = engines["fused"]._graphs.keys()
        rates = {name: [] for name in engines}
        same = warm["fused"] == warm["stepped"]
        for _ in range(3):
            for name, e in engines.items():
                ids, r = one(e)
                rates[name].append(r)
                same = same and ids == warm["stepped"]
        counts1 = engines["fused"].compile_counts()
        launches = (flash_attention.launches, paged_attention.launches)
        med = {name: float(np.median(r)) for name, r in rates.items()}
        log(f"fused decode [{cd}] (bench_fused_decode row 1): stepped "
            f"{med['stepped']:.1f} tokens/s, fused_rounds={fuse_k} "
            f"{med['fused']:.1f} tokens/s ({med['fused'] / med['stepped']:.3f}"
            f"x; median of 3 interleaved after a warm run, runs "
            f"{ {k: [round(x, 1) for x in v] for k, v in rates.items()} }); "
            f"ids bit-identical {same}; fused graphs {keys}, decode / "
            f"fused_decode graphs {_graph_counts(counts0)} -> "
            f"{_graph_counts(counts1)}; graphs "
            f"{{{_graph_memory(engines['fused']._graphs)}}}; K1 / K2 "
            f"launches "
            f"{launches} [{card}]")
        if (not same or keys != [("fused", fuse_k)] or counts1 != counts0
                or len(warm["fused"]) != n_gen or launches != (0, 0)):
            raise SystemExit(
                f"chip_smoke: fused decode [{cd}] failed: ids identical "
                f"{same}, fused graphs {keys}, compile_counts {counts0} -> "
                f"{counts1}, K1/K2 launches {launches}")
        del engines, net
        torch.cuda.empty_cache()


def _reserved() -> int:
    """The card's reserved memory after freeing the allocator's unused
    cache: what live tensors and captured graphs' pools hold."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _tree_bytes(tree) -> int:
    from deeplearning4j_tpu_torch.nn.streaming import tree_leaves

    return sum(a.numel() * a.element_size() for a in tree_leaves(tree))


# streaming decode: bench.py's bench_decode shape (the serving net, B=1,
# a 128-token prompt, 128 new tokens; 32 timed rnn_time_step tokens) and
# bench_decode_batched's (the dense engine, 8 slots, decode_chunk 32, 8
# prompts). At bf16 the ids are held at bench.py's 0.9 agreement; at f32
# they are identical.
DECODE_LOOP_TOKENS = 32
DECODE_BUCKET_NS = (5, 100, 128, 129)
DECODE_AGREEMENT = 0.9
# the K1 prefill: an unmasked prompt of a whole window (K1 from
# FLASH_MIN_T = 512 on), so the window slides while it generates
K1_PREFILL_T = WINDOW


def _one_hot_ids(ids):
    x = torch.zeros((1, VOCAB, len(ids)), dtype=torch.float32)
    x[0, torch.as_tensor(list(ids)), torch.arange(len(ids))] = 1.0
    return x.to(DEVICE)


def _generate_ids(net, prompt, n, graphs=True):
    """``generate`` from an empty state: the captured graphs, or with
    ``graphs=False`` the private eager body; returns the ids as a list
    and the wall seconds (synchronised)."""
    net.rnn_clear_previous_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if graphs:
        ids = net.generate(prompt, n)
    else:
        ids = net._generate(prompt, n, None)
    ids = ids[0].tolist()
    return ids, time.perf_counter() - t0


def _states_equal(a, b) -> bool:
    from deeplearning4j_tpu_torch.nn.streaming import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def decode_b1_phase(card: str, cd: str) -> tuple:
    """Phase 8 at one dtype: the rnn_time_step loop, ``generate`` from
    its captured graphs, their agreement, the graph count per bucket, and
    at f32 the graph against the eager body. Returns the net and
    ``generate``'s tokens/s."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.nn.streaming import scan_length_bucket

    net = _serving_net(cd)
    prompt = _one_hot_ids(serving_prompts(0, n=1)[0])
    net.rnn_clear_previous_state()
    flash_attention.launches = paged_attention.launches = 0
    out = net.rnn_time_step(prompt)
    tok = int(out[0, :, -1].argmax())
    loop_ids, lat = [tok], []
    for _ in range(DECODE_LOOP_TOKENS):
        t0 = time.perf_counter()
        out = net.rnn_time_step(_one_hot_ids([tok]))
        tok = int(out[0, :, 0].argmax())
        lat.append(time.perf_counter() - t0)
        loop_ids.append(tok)
    r0 = _reserved()
    ids, _ = _generate_ids(net, prompt, N_GEN)      # captures bucket 128
    graph_mem = _reserved() - r0 - _tree_bytes(net._rnn_state)
    walls = [_generate_ids(net, prompt, N_GEN)[1] for _ in range(3)]
    rate = N_GEN / float(np.median(walls))
    match = request_agreement(ids[:len(loop_ids)], loop_ids)
    launches = (flash_attention.launches, paged_attention.launches)
    counts = {}
    for _ in range(2):
        for n in DECODE_BUCKET_NS:
            _generate_ids(net, prompt, n)
        counts[len(counts)] = (len(net.generate_graphs),
                               net.generate_graphs.captures)
    buckets = sorted({scan_length_bucket(n - 1) for n in DECODE_BUCKET_NS})
    log(f"decode B=1 [{cd}]: rnn_time_step loop p50 "
        f"{float(np.median(lat)) * 1e3:.3f} ms per token over "
        f"{DECODE_LOOP_TOKENS}; generate {N_GEN} tokens from the captured "
        f"graph {rate:.1f} tokens/s (median of 3 after a warm run, walls "
        f"{[round(w, 4) for w in walls]} s); ids agree with the loop "
        f"{match:.4f}; the bucket-{scan_length_bucket(N_GEN - 1)} graph's "
        f"memory {graph_mem / 2**20:.1f} MiB; graphs after n_tokens "
        f"{DECODE_BUCKET_NS} (buckets {buckets}): {counts[0][0]} "
        f"({counts[0][1]} captures), after a repeat {counts[1][0]} "
        f"({counts[1][1]}); "
        f"K1 / K2 launches {launches} [{card}]")
    bar = 1.0 if cd == "float32" else DECODE_AGREEMENT
    if (match < bar or counts[0][0] != len(buckets)
            or counts[1] != counts[0] or launches != (0, 0)):
        raise SystemExit(
            f"chip_smoke: decode B=1 [{cd}] failed: loop agreement {match} "
            f"(bar {bar}), graphs {counts} for buckets {buckets}, K1/K2 "
            f"launches {launches} (a 128-token prefill is dense)")
    if cd == "float32":
        g_ids, _ = _generate_ids(net, prompt, N_GEN)
        g_state = net._rnn_state
        e_ids, e_wall = _generate_ids(net, prompt, N_GEN, graphs=False)
        same_state = _states_equal(g_state, net._rnn_state)
        log(f"decode B=1 [{cd}]: the captured graph against the eager body "
            f"({N_GEN / e_wall:.1f} tokens/s): ids identical {g_ids == e_ids},"
            f" final rnn state bit-equal {same_state} [{card}]")
        if g_ids != e_ids or not same_state:
            raise SystemExit("chip_smoke: generate's graph differs from its "
                             "eager body")
    return net, rate


def decode_k1_prefill_phase(card: str, net, cd: str) -> int:
    """Phase 8's K1 prefill at one dtype: ``generate`` after an unmasked
    K1_PREFILL_T-token prompt (K1's forward, one launch per layer), then
    the same run with the prefill forced dense. Identical ids at f32;
    at bf16 the agreement is printed. Returns K1's forward launches."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )

    prompt = _one_hot_ids(serving_prompts(1, n=1, length=K1_PREFILL_T)[0])
    flash_attention.launches = paged_attention.launches = 0
    k1_ids, wall = _generate_ids(net, prompt, N_GEN)
    launches = (flash_attention.launches, paged_attention.launches)
    beans = [c.layer for c in net.conf.confs if hasattr(c.layer,
                                                         "use_flash")]
    for bean in beans:
        bean.use_flash = False
    try:
        dense_ids, _ = _generate_ids(net, prompt, N_GEN)
    finally:
        for bean in beans:
            bean.use_flash = None
    match = request_agreement(k1_ids, dense_ids)
    log(f"decode K1 prefill [{cd}]: a {K1_PREFILL_T}-token prompt then "
        f"{N_GEN} tokens ({wall:.3f} s with the prefill); K1 / K2 launches "
        f"{launches}; ids agree with the dense prefill's {match:.4f} "
        f"[{card}]")
    if (launches != (N_LAYERS, 0)
            or (cd == "float32" and k1_ids != dense_ids)):
        raise SystemExit(
            f"chip_smoke: K1 prefill [{cd}] failed: launches {launches} "
            f"(want ({N_LAYERS}, 0)), agreement {match}")
    return launches[0]


def dense_engine_phase(card: str, nets: dict, b1_rate: float) -> None:
    """Phase 9: the dense-slot engine at bench_decode_batched's shape,
    bf16 timed and gated at 0.9 against B=1 ``generate``, f32 identical
    to it and to the engine on eager rounds."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    prompts = serving_prompts(0, n=N_SLOTS)
    for cd in ("bfloat16", "float32"):
        net = nets[cd]
        solo = [_generate_ids(net, _one_hot_ids(p), N_GEN)[0]
                for p in prompts]
        eng = DecodeEngine(net, n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK)
        r0 = _reserved()
        flash_attention.launches = paged_attention.launches = 0
        res, _ = serve_ids(eng, prompts)            # warm: captures
        graph_mem = _reserved() - r0 - _tree_bytes(eng._pool)
        ids = [r.tokens for r in res]
        per = agreement(ids, solo)
        counts0 = eng.compile_counts()
        walls = [serve_ids(eng, prompts)[1] for _ in range(3)]
        counts1 = eng.compile_counts()
        launches = (flash_attention.launches, paged_attention.launches)
        rate = N_SLOTS * N_GEN / float(np.median(walls))
        log(f"dense engine [{cd}]: {N_SLOTS} slots x {N_GEN} tokens, "
            f"{rate:.1f} tokens/s aggregate (median of 3 after a warm run, "
            f"walls {[round(w, 4) for w in walls]} s; B=1 bf16 generate "
            f"{b1_rate:.1f}); ids agree with B=1 generate {np.mean(per):.4f} "
            f"(per request {[round(x, 4) for x in per]}); compile_counts "
            f"{counts0} -> {counts1}; the round graph's memory "
            f"{graph_mem / 2**20:.1f} MiB; K1 / K2 launches {launches} "
            f"[{card}]")
        ok = (counts0 == counts1 and counts1["decode"] == 1
              and launches == (0, 0))
        if cd == "bfloat16":
            ok = ok and np.mean(per) >= DECODE_AGREEMENT and rate > b1_rate
            # the graph captured on greedy batches samples the rows that
            # ask for it: one prompt, N_SLOTS sampled requests
            rids = [eng.submit(Request(prompts[0], DECODE_CHUNK + 1,
                                       temperature=1.0, top_k=8))
                    for _ in range(N_SLOTS)]
            res = eng.run()
            runs = {tuple(res[i].tokens) for i in rids}
            log(f"dense engine [{cd}]: {N_SLOTS} sampled requests of one "
                f"prompt (temperature 1, top-k 8) from the same graph: "
                f"{len(runs)} distinct runs; compile_counts "
                f"{eng.compile_counts()} [{card}]")
            ok = (ok and len(runs) > 1
                  and eng.compile_counts()["decode"] == 1)
        else:
            eager = DecodeEngine(net, n_slots=N_SLOTS,
                                 decode_chunk=DECODE_CHUNK)
            eager._graphs = None
            eager_ids = [r.tokens for r in serve_ids(eager, prompts)[0]]
            log(f"dense engine [{cd}]: ids identical to B=1 generate "
                f"{ids == solo}, graph rounds to eager rounds "
                f"{ids == eager_ids} [{card}]")
            ok = ok and ids == solo and ids == eager_ids
            del eager
        if not ok:
            raise SystemExit(f"chip_smoke: dense engine [{cd}] failed: "
                             f"agreement {per}, rate {rate} (B=1 "
                             f"{b1_rate}), counts {counts0} -> {counts1}, "
                             f"launches {launches}")
        del eng
        torch.cuda.empty_cache()


def decode_phases(card: str) -> dict:
    """Phases 8 and 9. Returns K1's prefill launches by kernels-line
    entry (bf16 ``flash_attention``, f32 ``flash_attention_f32``)."""
    nets, rates, k1 = {}, {}, {}
    for cd, entry in (("float32", "flash_attention_f32"),
                      ("bfloat16", "flash_attention")):
        nets[cd], rates[cd] = decode_b1_phase(card, cd)
        k1[entry] = decode_k1_prefill_phase(card, nets[cd], cd)
    dense_engine_phase(card, nets, rates["bfloat16"])
    return k1


# Phase 13: prefix caches and chunked admission. (a) bench.py's
# bench_prefix_cache workload: 16 prompts of a 1024-token shared prefix
# and a 256-token tail, 64 new tokens, prefix_cache_rows=4,
# prefill_chunk=256, admission_policy="ttft", on the serving geometry
PREFIX_SHARED, PREFIX_TAIL = CHUNK_PREFIX, 256
PREFIX_REQUESTS, PREFIX_GEN, PREFIX_ROWS, PREFIX_CHUNK = 16, 64, 4, CHUNK_T
# bench.py's gates: skipped prompt tokens and warm hit rate in round 2
PREFIX_GATE = 0.7
# the port's f32 forward tolerance (atol and rtol; ROADMAP, rules)
F32_STATE_TOL = 1e-4
# (b) the f32 gate's admissions: the first prompts, then one that
# diverges from the last inside a block (its splice shares a partial
# block, so its chunk must copy it first)
PREFIX_F32_PROMPTS, PREFIX_MID = 8, 7


def prefix_workload() -> tuple:
    """bench_prefix_cache's prompts from ``default_rng(0)``: the 16
    measured prompts, then the two warm-up prompts on another prefix
    (first token forced distinct, so the measured cold round misses)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, VOCAB, PREFIX_SHARED).tolist()
    prompts = [shared + rng.integers(0, VOCAB, PREFIX_TAIL).tolist()
               for _ in range(PREFIX_REQUESTS)]
    other = rng.integers(0, VOCAB, PREFIX_SHARED).tolist()
    other[0] = (shared[0] + 1) % VOCAB
    warm_up = [other + rng.integers(0, VOCAB, PREFIX_TAIL).tolist()
               for _ in range(2)]
    return prompts, warm_up


def prefix_engine(net, layout: str, **kw):
    """The prefix phase's engine: the serving geometry with the prefix
    cache and 256-token chunks, dense or paged (bt 16)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    geometry = dict(n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                    prefix_cache_rows=PREFIX_ROWS,
                    prefill_chunk=PREFIX_CHUNK, admission_policy="ttft")
    if layout == "paged":
        geometry.update(paged_kv=True, block_tokens=BLOCK_TOKENS)
    geometry.update(kw)
    return DecodeEngine(net, **geometry)


def warm_chunks(results, chunk: int) -> int:
    """Suffix chunks the warm admissions among ``results`` streamed."""
    return sum(-(-(r.prompt_len - r.prefix_tokens_reused) // chunk)
               for r in results if r.prefix_tokens_reused)


def prefix_cache_phase(card: str, net) -> int:
    """Phase 13a on the bf16 serving net, dense then paged: warm-up on
    another prefix (two runs), round 1 (cold) and round 2 (warm) of the
    16 prompts. Gates: every request finishes; round 2's skipped-token
    ratio and hit rate >= 0.7; round 2's ids against B=1 ``generate``
    >= 0.9 on the first wave; ``compile_counts()`` unchanged between
    the rounds; paged: K2 launched once per layer per decode step (its
    t=1 launches) and once per layer per warm chunk (its t>1 launches,
    counted on their own), >= 16 blocks spliced, CoW copies <= 2 per
    admission, no row movers. Returns K2's warm-chunk launches of the
    paged rounds."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    prompts, warm_up = prefix_workload()
    solo = [_generate_ids(net, _one_hot_ids(p), PREFIX_GEN)[0]
            for p in prompts[:N_SLOTS]]
    chunk_launches = 0
    for layout in ("dense", "paged"):
        eng = prefix_engine(net, layout)
        for p in warm_up:
            serve_ids(eng, [p], PREFIX_GEN)
        paged_attention.launches = paged_attention.chunk_launches = 0
        steps0 = eng.stats["decode_steps"]
        cold, cold_wall = serve_ids(eng, prompts, PREFIX_GEN)
        counts1 = eng.compile_counts()
        skipped1 = eng.stats["prefill_tokens_skipped"]
        hits1 = eng.prefix_cache.stats["hits"]
        warm, warm_wall = serve_ids(eng, prompts, PREFIX_GEN)
        # K2 at t=1 (decode) and t>1 (warm chunks), each counted
        chunk_n = paged_attention.chunk_launches
        launches = paged_attention.launches - chunk_n
        counts2 = eng.compile_counts()
        steps = eng.stats["decode_steps"] - steps0
        skip = ((eng.stats["prefill_tokens_skipped"] - skipped1)
                / (PREFIX_REQUESTS * (PREFIX_SHARED + PREFIX_TAIL)))
        hit_rate = (eng.prefix_cache.stats["hits"] - hits1) / PREFIX_REQUESTS
        per = agreement([r.tokens for r in warm[:N_SLOTS]], solo)
        cold_ttft = float(np.median([r.ttft_s for r in cold[:N_SLOTS]
                                     if r.prefix_tokens_reused == 0]))
        warm_ttft = float(np.median([r.ttft_s for r in warm[:N_SLOTS]]))
        rate = PREFIX_REQUESTS * PREFIX_GEN / warm_wall
        chunks = warm_chunks(cold + warm, PREFIX_CHUNK)
        bad = [(r.id, r.finish_reason, len(r.tokens)) for r in cold + warm
               if r.finish_reason != "length"
               or len(r.tokens) != PREFIX_GEN]
        st = eng.stats
        log(f"prefix [{layout}, bf16] (bench_prefix_cache): median TTFT "
            f"of the first wave cold {cold_ttft * 1e3:.1f} ms, warm "
            f"{warm_ttft * 1e3:.1f} ms ({warm_ttft / cold_ttft:.3f}x); "
            f"warm round {rate:.1f} tokens/s aggregate (cold round "
            f"{PREFIX_REQUESTS * PREFIX_GEN / cold_wall:.1f}); skipped "
            f"ratio {skip:.4f}, warm hit rate {hit_rate:.4f}; warm ids "
            f"against B=1 generate {np.mean(per):.4f} (per request "
            f"{[round(x, 4) for x in per]}); compile_counts {counts1} -> "
            f"{counts2}; {st['chunks_scheduled']} chunks, {chunks} warm, "
            f"{steps} decode steps, K2 launches {launches} decode + "
            f"{chunk_n} chunk; spliced "
            f"{st['prefix_blocks_spliced']}, CoW copies {st['cow_copies']}"
            f", admitted {st['admitted']}, preempted {st['preempted']}, "
            f"deferred {st['paged_admit_deferred']} [{card}]")
        ok = (not bad and skip >= PREFIX_GATE and hit_rate >= PREFIX_GATE
              and np.mean(per) >= DECODE_AGREEMENT and counts1 == counts2
              and counts2["decode"] == 1)
        if layout == "paged":
            chunk_launches = chunk_n
            ok = (ok and launches == N_LAYERS * steps
                  and chunk_n == N_LAYERS * chunks and chunks > 0
                  and st["prefix_blocks_spliced"] >= 16
                  and st["cow_copies"] <= 2 * st["admitted"]
                  and "prefix_fetch" not in counts2
                  and "prefix_store" not in counts2)
        else:
            ok = (ok and launches == chunk_n == 0
                  and "prefix_fetch" in counts2)
        if not ok:
            raise SystemExit(
                f"chip_smoke: prefix phase [{layout}] failed: unfinished "
                f"{bad}, skip {skip}, hit rate {hit_rate}, agreement "
                f"{per}, counts {counts1} -> {counts2}, K2 launches "
                f"{launches} for {steps} steps and {chunk_n} for {chunks} "
                f"warm chunks x {N_LAYERS} layers, stats {st}")
        del eng
        torch.cuda.empty_cache()
    return chunk_launches


def slot_kv(eng, slot: int, n: int) -> list:
    """Per layer (k, v) [H, n, dh] of ``slot``'s newest ``n`` positions:
    gathered through its block table (paged) or read from its pool row
    (dense); copies."""
    out = []
    if eng.paged_kv:
        tab, bt = eng._kv_tabs[slot], eng.block_tokens
        idx = torch.as_tensor(
            [tab.blocks[p // bt] * bt + p % bt
             for p in range(tab.length - n, tab.length)],
            device=eng.device)
        for st in eng._pool.values():
            nb, _, h, dh = st["pk"].shape
            out.append(tuple(st[name].view(nb * bt, h, dh)[idx]
                             .transpose(0, 1).clone()
                             for name in ("pk", "pv")))
    else:
        for st in eng._pool.values():
            w = st["k"].shape[2]
            out.append(tuple(st[name][slot][:, w - n:].clone()
                             for name in ("k", "v")))
    return out


def admit_only(eng, prompt, slot: int, after_start=None) -> tuple:
    """Admit ``prompt`` into ``slot`` through the engine's admission
    path (start, then chunks under the round budget until it completes)
    with no decode round between; ``after_start(eng)`` runs after the
    start (a planted fault's hook). Returns the first token's output
    probabilities [V] and :func:`slot_kv` of the prompt's positions."""
    from deeplearning4j_tpu_torch.serving import Request

    probs = []
    sample = eng._sample_one

    def keep(p, req):
        probs.append(p[0].float().clone())
        return sample(p, req)

    eng._sample_one = keep
    try:
        eng.submit(Request(list(prompt), 2))
        eng._start_admission(eng.scheduler.pop_admissible(), slot)
        if after_start is not None:
            after_start(eng)
        while eng._pending:
            eng._advance_pending()
    finally:
        del eng._sample_one
    if eng._slots[slot] is None:
        raise SystemExit(f"chip_smoke: admission into slot {slot} did not "
                         "complete")
    return probs[-1], slot_kv(eng, slot, len(prompt))


def _kv_err(a, b) -> float:
    """The largest |a - b| - rtol |b| over every layer's K and V (<= atol
    passes the f32 limit)."""
    return max(float(((x - y).abs() - F32_STATE_TOL * y.abs()).max())
               for la, lb in zip(a, b) for x, y in zip(la, lb))


def _logits_err(a, b) -> float:
    """The largest |a - b| - rtol |b| between the logits of two output
    distributions ``a`` and ``b`` (probabilities [V]), each recovered
    as its log-probabilities less their mean (logits are defined up to
    a constant)."""
    la, lb = a.log(), b.log()
    la, lb = la - la.mean(), lb - lb.mean()
    return float(((la - lb).abs() - F32_STATE_TOL * lb.abs()).max())


def f32_warm_admissions(net32, layout, prompts, cold, fault=None) -> tuple:
    """Admit ``prompts`` in order, one slot each, on a cache-on engine
    (256-token chunks) and hold each admission's state and first-token
    logits against ``cold`` (the cache-off engine's), at admission and
    again once all are admitted (a write into a block another slot
    shares shows there). ``fault``: "splice" swaps the first warm
    admission's two middle spliced blocks (each one block position off:
    the same keys in another order, which attention cannot see);
    "shift" maps the first of those two positions to the block of the
    second (a block's keys twice, another's missing: the output moves);
    "cow" makes every block look unshared, so a chunk writes into a
    shared block. Returns (worst K/V error, worst logits error, the
    engine's CoW copies, prefill tokens skipped)."""
    eng = prefix_engine(net32, layout, n_slots=len(prompts))
    planted = {}

    def splice_off(e):
        p = e._pending[-1]
        if planted or p.tab is None or not p.matched:
            return
        mid = len(p.tab.blocks) // 2
        g0, g1 = sorted(p.tab.blocks)[mid - 1:mid + 1]
        blocks = p.tab.blocks
        planted.update(tab=p.tab, g=g0, bid=blocks[g0])
        if fault == "splice":
            blocks[g0], blocks[g1] = blocks[g1], blocks[g0]
        else:
            blocks[g0] = blocks[g1]

    if fault == "cow":
        eng.block_pool.refcount = lambda bid: 1
    kv_err = logits_err = -np.inf
    for slot, p in enumerate(prompts):
        probs, kv = admit_only(
            eng, p, slot, splice_off if fault in ("splice", "shift")
            else None)
        kv_err = max(kv_err, _kv_err(kv, cold[slot][1]))
        logits_err = max(logits_err, _logits_err(probs, cold[slot][0]))
    for slot, p in enumerate(prompts):
        kv_err = max(kv_err, _kv_err(slot_kv(eng, slot, len(p)),
                                     cold[slot][1]))
    if fault == "shift":
        # the slot's table holds the references the splice took: give
        # it back the block it dropped before its blocks are released
        planted["tab"].blocks[planted["g"]] = planted["bid"]
    out = (kv_err, logits_err,
           eng.block_pool.stats["cow_copies"] if eng.paged_kv else 0,
           eng.stats["prefill_tokens_skipped"])
    eng.run()
    del eng
    return out


def prefix_f32_phase(card: str, net16) -> None:
    """Phase 13b, f32 (the bf16 net's params at the master dtype), paged
    and dense: warm admissions of the first prompts and of one that
    diverges inside a block, held against cold admissions of the same
    prompts on a cache-off engine: each slot's window K/V and the first
    token's logits within 1e-4 (atol and rtol), at admission and after
    all are admitted. Paged: three planted faults must fail those
    checks (two spliced blocks swapped, a chunk that skips the
    copy-on-write: each caught by the K/V; a spliced block one position
    off: caught by the K/V and by the logits each); the paged warm
    engine on K2 gives
    greedy ids identical to the same engine on the plain gather
    program, both rounds. Warm-against-cold ids are a report."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    net32 = _serving_net("float32")
    for key, p in net16.param_table().items():
        net32.set_param(key, p)
    prompts = prefix_workload()[0]
    mid = (prompts[PREFIX_MID][:PREFIX_SHARED + 6]
           + prompts[PREFIX_MID - 1][PREFIX_SHARED + 6:])
    check = prompts[:PREFIX_F32_PROMPTS] + [mid]
    failures = []
    for layout in ("dense", "paged"):
        kw = dict(paged_kv=True, block_tokens=BLOCK_TOKENS) \
            if layout == "paged" else {}
        ref = DecodeEngine(net32, n_slots=1, decode_chunk=DECODE_CHUNK,
                           **kw)
        cold = []
        for p in check:
            cold.append(admit_only(ref, p, 0))
            ref.run()
        del ref
        kv_err, logits_err, cow, skipped = f32_warm_admissions(
            net32, layout, check, cold)
        ok = kv_err <= F32_STATE_TOL and logits_err <= F32_STATE_TOL
        log(f"prefix f32 gate [{layout}]: {len(check)} admissions "
            f"({skipped} prompt tokens from the cache), warm against "
            f"cold: K/V worst |d| - rtol|ref| {kv_err:.3e}, first-token "
            f"logits {logits_err:.3e} (limit {F32_STATE_TOL}); "
            f"CoW copies {cow if layout == 'paged' else 'n/a'} [{card}]")
        if not ok or skipped == 0:
            failures.append(f"{layout}: K/V {kv_err}, logits "
                            f"{logits_err}, skipped {skipped}")
        if layout == "dense":
            continue
        for fault in ("splice", "cow", "shift"):
            f_kv, f_logits, f_cow, _ = f32_warm_admissions(
                net32, layout, check, cold, fault)
            by_kv, by_logits = (f_kv > F32_STATE_TOL,
                                f_logits > F32_STATE_TOL)
            caught = (by_kv and by_logits if fault == "shift"
                      else by_kv or by_logits)
            log(f"prefix f32 gate, planted fault ({fault}): K/V "
                f"{f_kv:.3e}, logits {f_logits:.3e}, CoW copies "
                f"{f_cow}: caught by the K/V {by_kv}, by the logits "
                f"{by_logits}")
            if not caught:
                failures.append(f"planted fault {fault} not caught")
        del cold
        torch.cuda.empty_cache()

    # K2 against the plain gather program, and warm against cold ids
    first = prompts[:N_SLOTS]
    runs = {}
    for name, flash in (("kernel", True), ("plain", False)):
        eng = prefix_engine(net32, "paged", use_flash_paged=flash)
        runs[name] = [[r.tokens for r in serve_ids(eng, first,
                                                   PREFIX_GEN)[0]]
                      for _ in range(2)]
        del eng
    off = DecodeEngine(net32, n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                       paged_kv=True, block_tokens=BLOCK_TOKENS,
                       use_flash_paged=True)
    cold_ids = [r.tokens for r in serve_ids(off, first, PREFIX_GEN)[0]]
    del off
    same = runs["kernel"] == runs["plain"]
    per = agreement(runs["kernel"][1], cold_ids)
    log(f"prefix f32 gate [paged]: warm engine on K2 against the plain "
        f"gather program, ids identical {same} (both rounds); warm round "
        f"against a cache-off engine, a report: agreement "
        f"{np.mean(per):.4f} (per request {[round(x, 4) for x in per]}) "
        f"[{card}]")
    near_tie_report(net32, first, runs["kernel"][1], cold_ids,
                    "f32 warm vs cache-off")
    if not same:
        failures.append("K2 ids differ from the plain gather program's")
    del net32
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"chip_smoke: prefix f32 gate failed: {failures}")


# (c) bench_fused_decode row 2, the admission storm (bench.py:1564-1640):
# width 512, 4 layers, window 1024, bt 16, 8 slots, chunk 32, paged,
# prefill_chunk=8, decode priority, async and fused_rounds=8; a victim
# (24-token prompt, 256 new tokens) against 24 arrivals of 8-token
# prompts and 2 new tokens, fed while fewer than 2 wait
STORM_WIDTH, STORM_LAYERS, STORM_WINDOW, STORM_FUSE = 512, 4, 1024, 8
STORM_VICTIM, STORM_ARRIVALS = (24, 256), (24, 8, 2)
STORM_WARM_GEN = (257, 97, 65, 33, 2)
STORM_TRIPLES = 3


def _storm_net(compute_dtype: str, window: int = None):
    """bench.py's width-512, 4-layer serving net (the storm's, the KV
    transfer rows' and, at window 544, the KV tier rows')."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = transformer_lm_flagship(vocab=VOCAB, width=STORM_WIDTH,
                                   n_layers=STORM_LAYERS, n_heads=N_HEADS,
                                   seed=11)
    for c in conf.confs:
        if compute_dtype != "float32":
            c.compute_dtype = compute_dtype
        if hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = window or STORM_WINDOW
    return MultiLayerNetwork(conf, device=DEVICE).init()


def storm_engine(net):
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(net, n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                       paged_kv=True, block_tokens=BLOCK_TOKENS,
                       prefill_chunk=8, admission_policy="decode", seed=0,
                       async_rounds=True, fused_rounds=STORM_FUSE)
    eng.dispatches = []
    run_graph = eng._run_graph

    def record(key, body, ops):
        # (graph key, an admission pending) at every decode dispatch
        eng.dispatches.append((key, bool(eng._pending)))
        return run_graph(key, body, ops)

    eng._run_graph = record
    return eng


def victim_run(eng, victim, rng, storm: bool) -> tuple:
    """bench.py's ``victim_itl``: the victim, and with ``storm`` the
    arrivals fed while fewer than 2 wait, stepped to the end. The port's
    results carry no phase clock, so the victim's e2e is the time its
    result appears less its submit time. Returns (victim ids, its mean
    ITL in seconds, every result)."""
    from deeplearning4j_tpu_torch.serving import Request

    n_arr, arr_len, arr_gen = STORM_ARRIVALS
    rid = eng.submit(Request(list(victim), STORM_VICTIM[1]))
    t_submit = eng._submit_t[rid]
    res, fed, t_end = {}, 0, None
    while eng.has_work():
        if storm and fed < n_arr and eng.scheduler.pending < 2:
            eng.submit(Request(rng.integers(0, VOCAB, arr_len).tolist(),
                               arr_gen))
            fed += 1
        eng.step(res)
        if t_end is None and rid in res:
            t_end = time.perf_counter()
    r = res[rid]
    itl = (t_end - t_submit - r.ttft_s) / (len(r.tokens) - 1)
    return r.tokens, itl, list(res.values())


def storm_phase(card: str) -> None:
    """Phase 13c: bench.py's ``fused_itl_storm_ratio`` row on the port.
    bf16: the warm-up of every fused bucket, then 3 interleaved triples
    (stepped idle with fusing off, fused idle, storm); the ratio of the
    storm's median victim ITL to the stepped idle median, beside the JAX
    bench's 1.1x + 3 ms bar (a report), and the fused idle ITL. Gates:
    every request finishes; no fused window dispatched while an
    admission was pending, and the ``serving_fused_rounds`` histogram
    counts exactly the fused dispatches; at f32 the victim's ids under
    the storm identical to its idle ids."""
    rng = np.random.default_rng(1)
    victim = np.random.default_rng(2).integers(
        0, VOCAB, STORM_VICTIM[0]).tolist()
    net = _storm_net("bfloat16")
    eng = storm_engine(net)
    from deeplearning4j_tpu_torch.serving import Request

    # capture every fused bucket and the stepped round before the
    # timed runs
    for fuse, n in [(STORM_FUSE, n) for n in STORM_WARM_GEN] + [(0, 33)]:
        eng.fused_rounds = fuse
        eng.submit(Request(rng.integers(0, VOCAB, 8).tolist(), n))
        eng.run()
    itls = {"idle": [], "fused_idle": [], "storm": []}
    every = []
    for _ in range(STORM_TRIPLES):
        for name, fuse, storm in (("idle", 0, False),
                                  ("fused_idle", STORM_FUSE, False),
                                  ("storm", STORM_FUSE, True)):
            eng.fused_rounds = fuse
            _, itl, results = victim_run(eng, victim, rng, storm)
            itls[name].append(itl)
            every += results
    fused = [k for k, _ in eng.dispatches if k != "decode"]
    mixed = [k for k, pend in eng.dispatches if k != "decode" and pend]
    hist = eng.histograms["serving_fused_rounds"].count
    med = {k: float(np.median(v)) for k, v in itls.items()}
    ratio = med["storm"] / med["idle"]
    bar = 1.1 * med["idle"] + 3e-3
    bad = [(r.id, r.finish_reason) for r in every
           if r.finish_reason != "length"]
    log(f"storm [bf16] (bench_fused_decode row 2): victim ITL medians "
        f"stepped idle {med['idle'] * 1e3:.3f} ms, fused idle "
        f"{med['fused_idle'] * 1e3:.3f} ms "
        f"({med['idle'] / med['fused_idle']:.3f}x), storm "
        f"{med['storm'] * 1e3:.3f} ms: ratio {ratio:.3f} (JAX bench bar "
        f"1.1x + 3 ms = {bar * 1e3:.3f} ms: within {med['storm'] <= bar}; "
        f"a report); runs (ms) "
        f"{ {k: [round(x * 1e3, 3) for x in v] for k, v in itls.items()} }"
        f"; {len(eng.dispatches)} dispatches, {len(fused)} fused "
        f"(histogram {hist}), {len(mixed)} fused with an admission "
        f"pending; {len(every)} requests, unfinished {bad} [{card}]")
    if bad or mixed or hist != len(fused) or not fused:
        raise SystemExit(
            f"chip_smoke: storm failed: unfinished {bad}, fused windows "
            f"with an admission pending {mixed}, histogram {hist} against "
            f"{len(fused)} fused dispatches")
    del eng, net
    net32 = _storm_net("float32")
    ids = {}
    for storm in (False, True):
        eng = storm_engine(net32)
        ids[storm] = victim_run(eng, victim, rng, storm)[0]
        del eng
    same = ids[False] == ids[True]
    log(f"storm [f32]: the victim's {len(ids[True])} ids under the storm "
        f"identical to idle {same} [{card}]")
    if not same:
        raise SystemExit(f"chip_smoke: storm f32 victim ids differ: first "
                         f"at {first_divergence(ids[False], ids[True])}")
    del net32
    torch.cuda.empty_cache()


def prefix_phases(card: str) -> int:
    """Phase 13 (a, b, c). Returns K2's warm-chunk launches."""
    net = _serving_net("bfloat16")
    launches = prefix_cache_phase(card, net)
    prefix_f32_phase(card, net)
    del net
    torch.cuda.empty_cache()
    storm_phase(card)
    return launches


# Phase 14: speculative decoding, bench.py's bench_decode_spec: the
# serving net at bf16, the engine at 8 slots, decode_chunk 32,
# spec_draft_len 32; 24 requests x 128 new tokens, each prompt a 64-token
# random head and the model's own 128-token greedy continuation, the best
# 24 of 32 candidates by an n-gram replay of their next 128 tokens (the
# filter builds the workload; it measures nothing)
SPEC_K, SPEC_REQUESTS, SPEC_CANDIDATES = 32, 24, 32
SPEC_HEAD, SPEC_CONT, SPEC_GEN = 64, 128, 128
SPEC_TIMED = 3
# the f32 identity gate: the workload's 8 least predictable prompts (the
# last 8 kept: the most rejections, where the rewind and the acceptance
# rule show), SPEC_GEN new tokens, so that verify passes run on states
# an earlier pass rewound (the gate asks each request to draft in
# SPEC_F32_MIN_ROUNDS of them); the mixed run samples the first 2 of
# them at temperature 1.0
SPEC_F32_REQUESTS, SPEC_SAMPLED, SPEC_F32_MIN_ROUNDS = 8, 2, 2
SPEC_LAYOUTS = {"dense": {},
                "paged": dict(paged_kv=True, block_tokens=BLOCK_TOKENS)}


def spec_workload(net) -> tuple:
    """bench_decode_spec's prompts from ``default_rng(0)``: the 32
    candidates' continuations from one B=32 greedy run (the private
    eager ``generate`` body: one run, no graph to capture), each scored
    by how often a fresh ``NgramDraftTable`` seeded with the prompt
    drafts the true next token over the following 128; the best 24
    prompts and their scores."""
    from deeplearning4j_tpu_torch.serving import NgramDraftTable

    rng = np.random.default_rng(0)
    heads = [rng.integers(0, VOCAB, SPEC_HEAD).tolist()
             for _ in range(SPEC_CANDIDATES)]
    x = torch.zeros((SPEC_CANDIDATES, VOCAB, SPEC_HEAD))
    for b, head in enumerate(heads):
        x[b, torch.as_tensor(head), torch.arange(SPEC_HEAD)] = 1.0
    net.rnn_clear_previous_state()
    streams = net._generate(x.to(DEVICE), SPEC_CONT + SPEC_GEN,
                            None).tolist()
    net.rnn_clear_previous_state()
    cands = []
    for head, stream in zip(heads, streams):
        prompt = head + stream[:SPEC_CONT]
        table = NgramDraftTable()
        table.seed(0, prompt)
        hits = 0
        for tok in stream[SPEC_CONT:]:
            d = table.draft(0, 1)
            hits += bool(d and d[0] == tok)
            table.extend(0, [tok])
        cands.append((hits, prompt))
    cands.sort(key=lambda c: -c[0])
    best = cands[:SPEC_REQUESTS]
    return [p for _, p in best], [h for h, _ in best]


def spec_round(engine, prompts, n_gen, kws=None) -> tuple:
    """One synchronised run of ``prompts`` (``kws[i]`` the i-th
    request's sampling); returns the results in submission order and
    the aggregate tokens/s."""
    from deeplearning4j_tpu_torch.serving import Request

    kws = kws or [{}] * len(prompts)
    rids = [engine.submit(Request(list(p), n_gen, **kw))
            for p, kw in zip(prompts, kws)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.run()
    torch.cuda.synchronize()
    out = [res[i] for i in rids]
    return out, sum(len(r.tokens) for r in out) / (time.perf_counter() - t0)


def _spec_engine(net, layout, k=None):
    """The phase's engine on ``layout``: ``spec_draft_len`` ``k``
    (SPEC_K by default; 0: the spec-off engine)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    return DecodeEngine(net, n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                        spec_draft_len=SPEC_K if k is None else k,
                        **SPEC_LAYOUTS[layout])


def _verify_graphs(engine) -> str:
    g = engine._graphs
    return ", ".join(f"width {k[1]}: {g.memory[k] / 2**20:.1f} MiB, "
                     f"{g.seconds[k]:.3f} s" for k in g.keys()
                     if isinstance(k, tuple) and k[0] == "verify")


def spec_bench(card: str, net, prompts, layout: str) -> int:
    """bench_decode_spec on one layout: a warm round of the spec-off and
    the spec-on engine, then ``SPEC_TIMED`` interleaved timed rounds of
    each. Gates: spec-on ids agree with spec-off >= 0.9 (bench.py's
    bar); verify graphs in [1, log2(K) + 1]; no graph captured by either
    engine after the warm round; over the timed rounds (the counts set
    to 0 after the warm round, whose captures run each body once
    before recording it), paged, K2's t > 1 launches equal N_LAYERS per
    verify pass and its t = 1 launches N_LAYERS per decode step (dense,
    none). Returns the paged spec engine's K2 t > 1 launches over the
    timed rounds (0 dense), and the warm round's spec-on and spec-off
    ids (for :func:`near_tie_report`)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    base = _spec_engine(net, layout, k=0)
    spec = _spec_engine(net, layout)
    base_res, _ = spec_round(base, prompts, SPEC_GEN)     # warm: captures
    spec_res, _ = spec_round(spec, prompts, SPEC_GEN)
    per = agreement([r.tokens for r in spec_res],
                    [r.tokens for r in base_res])
    counts0 = (base.compile_counts(), spec.compile_counts())
    caps0 = (base._graphs.captures, spec._graphs.captures)
    stats0 = dict(spec.stats)
    steps0 = base.stats["decode_steps"] + spec.stats["decode_steps"]
    paged_attention.launches = paged_attention.chunk_launches = 0
    rates = {"off": [], "on": []}
    for _ in range(SPEC_TIMED):
        rates["off"].append(spec_round(base, prompts, SPEC_GEN)[1])
        rates["on"].append(spec_round(spec, prompts, SPEC_GEN)[1])
    counts1 = (base.compile_counts(), spec.compile_counts())
    caps1 = (base._graphs.captures, spec._graphs.captures)
    chunk = paged_attention.chunk_launches
    step = paged_attention.launches - chunk
    st = spec.stats
    drafted = st["spec_drafted"] - stats0["spec_drafted"]
    accepted = st["spec_accepted"] - stats0["spec_accepted"]
    passes = st["spec_rounds"] - stats0["spec_rounds"]
    on, off = float(np.median(rates["on"])), float(np.median(rates["off"]))
    verify = counts1[1]["verify"]
    steps = base.stats["decode_steps"] + st["decode_steps"] - steps0
    log(f"spec decode [{layout}, bfloat16] (bench_decode_spec): spec-on "
        f"{on:.1f} tokens/s, spec-off {off:.1f} ({on / off:.3f}x; medians "
        f"of {SPEC_TIMED} interleaved after a warm round, runs "
        f"{ {k: [round(r, 1) for r in v] for k, v in rates.items()} }); "
        f"ids agree with spec-off {np.mean(per):.4f} (per request min "
        f"{min(per):.4f}); acceptance over the timed rounds {accepted} / "
        f"{drafted} = {accepted / max(drafted, 1):.4f}; over all "
        f"{st['spec_rounds']} spec rounds and {st['spec_fallback_rounds']} "
        f"fallback rounds, final draft_len {spec.scheduler.draft_len}; "
        f"verify graphs {verify} ({_verify_graphs(spec)}); decode graph "
        f"{_graph_memory(base._graphs)} (spec-off); captures after the "
        f"warm round {caps0} -> {caps1}; K2 launches over the timed rounds "
        f"t = 1 {step} ({steps} decode steps), t > 1 {chunk} ({passes} "
        f"verify passes) [{card}]")
    ok = (np.mean(per) >= 0.9 and 1 <= verify <= int(np.log2(SPEC_K)) + 1
          and counts0 == counts1 and caps0 == caps1
          and passes > 0)
    if layout == "paged":
        ok = (ok and chunk == N_LAYERS * passes
              and step == N_LAYERS * steps)
    else:
        ok = ok and chunk == step == 0
    if not ok:
        raise SystemExit(
            f"chip_smoke: spec decode [{layout}] failed: agreement {per}, "
            f"verify graphs {verify}, counts {counts0} -> {counts1}, "
            f"captures {caps0} -> {caps1}, K2 t > 1 {chunk} against "
            f"{N_LAYERS} x {passes} verify passes, t = 1 "
            f"{step} against {N_LAYERS} x {steps} steps")
    del base, spec
    torch.cuda.empty_cache()
    return (chunk if layout == "paged" else 0,
            ([r.tokens for r in spec_res], [r.tokens for r in base_res]))


@contextlib.contextmanager
def _spec_fault(name):
    """A planted fault of the verify pass, patched into the engine
    module within the block: "no rewind" leaves each row's rejected
    tail in the cache (``drop_newest_tokens`` returns the state as it
    is); "one past the mismatch" accepts one draft token more than the
    rule does (at most the row's draft)."""
    from deeplearning4j_tpu_torch.serving import engine as engine_module

    attr = {"no rewind": "drop_newest_tokens",
            "one past the mismatch": "stochastic_acceptance"}[name]
    orig = getattr(engine_module, attr)

    def no_rewind(rnn, drop):
        return rnn

    def one_past(probs, draft, lens, *rest):
        return torch.minimum(orig(probs, draft, lens, *rest) + 1,
                             lens).to(torch.int32)

    setattr(engine_module, attr,
            no_rewind if name == "no rewind" else one_past)
    try:
        yield
    finally:
        setattr(engine_module, attr, orig)


SPEC_FAULTS = ("no rewind", "one past the mismatch")


def _count_verify_passes(engine) -> collections.Counter:
    """Request id -> the verify passes that request drafted in, counted
    as ``engine`` lands them (a read beside its own accounting)."""
    passes = collections.Counter()
    land = engine._land_verify

    def counted(drafts, lens, *rest):
        passes.update(engine._slots[s].request.id for s in drafts
                      if lens[s] > 0)
        return land(drafts, lens, *rest)

    engine._land_verify = counted
    return passes


def spec_f32_gate(card: str, net32, prompts, layout: str) -> None:
    """At f32 the spec-on engine's greedy ids are identical to the
    spec-off engine's on the last ``SPEC_F32_REQUESTS`` prompts, each
    drafting in at least ``SPEC_F32_MIN_ROUNDS`` verify passes; with the first
    ``SPEC_SAMPLED`` of them sampled at temperature 1.0 the greedy ones
    stay identical and the sampled ones draft; each planted fault
    (:func:`_spec_fault`) must break the identity. A divergence is
    printed with its f32 log-probability gap. Fatal on any failure."""
    prompts = prompts[-SPEC_F32_REQUESTS:]
    want = [r.tokens for r in spec_round(_spec_engine(net32, layout, k=0),
                                         prompts, SPEC_GEN)[0]]
    eng = _spec_engine(net32, layout)
    passes = _count_verify_passes(eng)
    greedy = spec_round(eng, prompts, SPEC_GEN)[0]
    got = [r.tokens for r in greedy]
    passes = [passes[r.id] for r in greedy]
    st = dict(eng.stats)
    from deeplearning4j_tpu_torch.serving import Request

    rids = [eng.submit(Request(list(p), SPEC_GEN, temperature=1.0))
            for p in prompts[:SPEC_SAMPLED]]
    rids += [eng.submit(Request(list(p), SPEC_GEN))
             for p in prompts[SPEC_SAMPLED:]]
    res = eng.run()
    mixed = [res[i] for i in rids]
    sampled_drafted = [r.spec_drafted for r in mixed[:SPEC_SAMPLED]]
    greedy_same = ([r.tokens for r in mixed[SPEC_SAMPLED:]]
                   == want[SPEC_SAMPLED:])
    caught = {}
    for name in SPEC_FAULTS:
        with _spec_fault(name):
            bad = [r.tokens for r in spec_round(
                _spec_engine(net32, layout), prompts, SPEC_GEN)[0]]
        caught[name] = bad != want
    log(f"spec decode [{layout}, float32]: {len(prompts)} x "
        f"{SPEC_GEN} tokens, ids identical to spec-off {got == want} "
        f"({st['spec_accepted']} / {st['spec_drafted']} accepted over "
        f"{st['spec_rounds']} spec rounds; per request verify passes "
        f"{passes}, drafted {[r.spec_drafted for r in greedy]}, accepted "
        f"{[r.spec_accepted for r in greedy]}); mixed run ({SPEC_SAMPLED} "
        f"sampled at temperature 1.0, {SPEC_GEN} tokens): greedy ids "
        f"identical {greedy_same}, "
        f"sampled requests drafted {sampled_drafted}; planted faults "
        f"caught {caught} [{card}]")
    if got != want:
        near_tie_report(net32, prompts, got, want, "spec f32")
    if not greedy_same:
        near_tie_report(net32, prompts[SPEC_SAMPLED:],
                        [r.tokens for r in mixed[SPEC_SAMPLED:]],
                        want[SPEC_SAMPLED:], "spec f32 mixed")
    if (got != want or not greedy_same or min(sampled_drafted) < 1
            or st["spec_accepted"] < 1
            or min(passes) < SPEC_F32_MIN_ROUNDS
            or not all(caught.values())):
        raise SystemExit(f"chip_smoke: spec decode [{layout}] f32 gate "
                         f"failed: identical {got == want}, greedy in the "
                         f"mixed run {greedy_same}, sampled drafted "
                         f"{sampled_drafted}, verify passes per request "
                         f"{passes} (each at least {SPEC_F32_MIN_ROUNDS}),"
                         f" faults caught {caught}")
    del eng
    torch.cuda.empty_cache()


def spec_phase(card: str) -> int:
    """Phase 14. Returns K2's t > 1 launches of the paged spec engine's
    runs (``paged_attention_verify``)."""
    net = _serving_net("bfloat16")
    prompts, hits = spec_workload(net)
    log(f"spec decode workload: {len(prompts)} prompts of {SPEC_HEAD} + "
        f"{SPEC_CONT} tokens, n-gram replay hits of the kept candidates "
        f"{hits[0]}..{hits[-1]} of {SPEC_GEN}")
    launches, bf16_ids = 0, {}
    for layout in SPEC_LAYOUTS:
        n, bf16_ids[layout] = spec_bench(card, net, prompts, layout)
        launches += n
    del net
    torch.cuda.empty_cache()
    net32 = _serving_net("float32")
    for layout, (on_ids, off_ids) in bf16_ids.items():
        near_tie_report(net32, prompts, on_ids, off_ids,
                        f"spec bf16 [{layout}] spec-on vs spec-off")
    for layout in SPEC_LAYOUTS:
        spec_f32_gate(card, net32, prompts, layout)
    del net32
    torch.cuda.empty_cache()
    return launches


# Phase 15: fault handling. The serving net of phase 6 at f32, 8 slots,
# chunk 32, prefix_cache_rows 4, prefill_chunk 256, paranoid, max_retries
# 3, a ManualClock; 12 requests of 64 new tokens, each prompt a shared
# 96-token head and its own 32-token tail, so later admissions hit the
# trie. The plan's rounds follow this workload's schedule, the same on
# both layouts (requests 0-3 are admitted in round 0 and finish in round
# 1, 4-7 are admitted in round 1, 8-11 warm in round 2): a NaN in slot 0
# and a stall in round 1, a failed admission and a corrupted trie entry
# in round 2. The phase asserts that each kind landed; the engine takes
# its snapshot after FAULT_SNAPSHOT_AFTER rounds.
FAULT_HEAD, FAULT_TAIL, FAULT_REQUESTS, FAULT_GEN = 96, 32, 12, 64
FAULT_ROWS, FAULT_CHUNK, FAULT_RETRIES, FAULT_STALL_S = 4, 256, 3, 1.0
FAULT_PLAN = ((1, "nan", {"slot": 0}), (1, "stall", {"seconds": 2.0}),
              (2, "admit_fail", {}), (2, "cache_corrupt", {}))
FAULT_SNAPSHOT_AFTER = 4
FAULT_LAYOUTS = {"dense": {},
                 "paged": dict(paged_kv=True, block_tokens=BLOCK_TOKENS)}
# (b) the request cancelled while its async round is in flight; (c) the
# sampled requests of the double restore
FAULT_CANCELLED, FAULT_SAMPLED = 3, 2
HEALTH_REPS = 20


def fault_prompts() -> list:
    rng = np.random.default_rng(15)
    head = rng.integers(0, VOCAB, FAULT_HEAD).tolist()
    return [head + rng.integers(0, VOCAB, FAULT_TAIL).tolist()
            for _ in range(FAULT_REQUESTS)]


def fault_engine(net, layout: str, **kw):
    """The phase's engine on ``layout`` (paranoid unless ``kw`` says
    otherwise), on a fresh ``ManualClock``."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine, ManualClock

    geometry = dict(n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                    prefix_cache_rows=FAULT_ROWS, prefill_chunk=FAULT_CHUNK,
                    paranoid=True, max_retries=FAULT_RETRIES,
                    stall_threshold_s=FAULT_STALL_S, clock=ManualClock(),
                    **FAULT_LAYOUTS[layout])
    geometry.update(kw)
    return DecodeEngine(net, **geometry)


def fault_plan():
    from deeplearning4j_tpu_torch.serving import FaultEvent, FaultPlan

    return FaultPlan([FaultEvent(r, kind, **kw)
                      for r, kind, kw in FAULT_PLAN])


def _serve_all(eng, prompts, kws=None) -> tuple:
    """Submit ``prompts`` (FAULT_GEN new tokens, ``kws[i]`` the i-th
    request's sampling) and run; (results in order, seconds)."""
    from deeplearning4j_tpu_torch.serving import Request

    kws = kws or [{}] * len(prompts)
    rids = [eng.submit(Request(list(p), FAULT_GEN, **kw))
            for p, kw in zip(prompts, kws)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    return [res[i] for i in rids], time.perf_counter() - t0


def _diverged(results, want) -> list:
    """Indices of the requests that did not end ``fault`` and whose ids
    differ from ``want`` (None results are skipped)."""
    return [i for i, r in enumerate(results) if r is not None
            and r.finish_reason != "fault" and r.tokens != want[i]]


def _health_ms(eng) -> float:
    """Device ms of one replay of the engine's captured health check
    (CUDA events around HEALTH_REPS back-to-back replays)."""
    ops = {"pool": eng._pool, "toks": eng._toks}
    eng._run_graph("health_check", eng._health_body, ops)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(HEALTH_REPS):
        eng._run_graph("health_check", eng._health_body, ops)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / HEALTH_REPS


def _k2_step_launches() -> int:
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    return paged_attention.launches - paged_attention.chunk_launches


@contextlib.contextmanager
def _fault_planted(name):
    """A planted fault of the failure layer, patched into
    ``DecodeEngine`` within the block: "all healthy" forces every health
    verdict to healthy; "current token re-prefilled" makes a restore's
    ``_rebuild_slot`` re-prefill the slot's current token too (its
    cache then holds that token before the next round feeds it)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    attr = {"all healthy": "_health",
            "current token re-prefilled": "_rebuild_slot"}[name]
    orig = getattr(DecodeEngine, attr)

    def all_healthy(self):
        return np.ones(self.n_slots + (self.kv_blocks if self.paged_kv
                                       else 0), bool)

    def with_current(self, slot, request, tokens, *rest, **kw):
        orig(self, slot, request, list(tokens) + [tokens[-1]], *rest, **kw)
        self._slots[slot].tokens = list(tokens)

    setattr(DecodeEngine, attr,
            all_healthy if name == "all healthy" else with_current)
    try:
        yield
    finally:
        setattr(DecodeEngine, attr, orig)


FAULT_PLANTED = ("all healthy", "current token re-prefilled")


def chaos_run(net, layout: str, prompts, snap=None) -> dict:
    """The fault plan on a paranoid engine: FAULT_SNAPSHOT_AFTER rounds,
    a snapshot through JSON, then a fresh engine restored from it
    finishes, and the faulted engine runs on to its end too. With
    ``snap`` given, only the restore of ``snap`` and its run. Returns
    the engines, their results in submission order, the plan, the
    snapshot and the restore's seconds."""
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        ManualClock,
        Request,
    )

    out = {}
    res = {}
    if snap is None:
        plan = out["plan"] = fault_plan()
        eng = out["eng"] = fault_engine(net, layout, fault_plan=plan)
        rids = [eng.submit(Request(list(p), FAULT_GEN)) for p in prompts]
        for _ in range(FAULT_SNAPSHOT_AFTER):
            eng.step(res)
        snap = json.loads(json.dumps(eng.snapshot()))
    else:
        rids = list(range(len(prompts)))
    out["snapshot"] = snap
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng2 = out["eng2"] = DecodeEngine.restore(net, snap, clock=ManualClock())
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    res2 = dict(res)
    res2.update(eng2.run())
    # with ``snap`` given, requests that ended before it read None
    out["restored"] = [res2.get(i) for i in rids]
    if "eng" in out:
        res.update(out["eng"].run())
        out["continued"] = [res[i] for i in rids]
    return out


def fault_layout_phase(card: str, net, prompts, layout: str) -> None:
    """(a) on one layout. The fault-free engine, paranoid off and on (a
    first run, then a timed second run on the warm trie): ids identical
    (the first runs are the reference), tokens/s of both, the health
    check's device ms against the round's wall. The chaos run
    (:func:`chaos_run`): every kind of the plan landed, at least one
    victim, and every request that did not end ``fault`` has the
    reference ids, on the faulted engine run on and on the restored
    one; ``decode`` and ``health_check`` graphs 1 on both, none captured
    by the restored engine on a repeat of the workload; paged, K2
    launched N_LAYERS times per decode step (each decode graph's
    capture runs its body once: DECODE_CHUNK steps more per engine) and
    no poisoned block left. Each planted fault (:func:`_fault_planted`)
    must make a request diverge. Fatal on failure."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention

    ref, rates = None, {}
    for para in (False, True):
        eng = fault_engine(net, layout, paranoid=para)
        first, _ = _serve_all(eng, prompts)
        dec0, chunks0 = eng.stats["decode_time_s"], eng.stats["chunks"]
        timed, secs = _serve_all(eng, prompts)
        rates[para] = sum(len(r.tokens) for r in timed) / secs
        ids = [r.tokens for r in first]
        if ref is None:
            ref = ids
        elif ids != ref:
            raise SystemExit(f"chip_smoke: fault [{layout}]: paranoid "
                             "changed the fault-free ids")
        if para:
            health_ms = _health_ms(eng)
            round_ms = (1e3 * (eng.stats["decode_time_s"] - dec0)
                        / (eng.stats["chunks"] - chunks0))
        del eng
        torch.cuda.empty_cache()
    paged_attention.launches = paged_attention.chunk_launches = 0
    run = chaos_run(net, layout, prompts)
    eng, eng2 = run["eng"], run["eng2"]
    counts = (eng.compile_counts(), eng2.compile_counts())
    caps0, counts0 = eng2._graphs.captures, counts[1]
    repeat, _ = _serve_all(eng2, prompts)
    caps1, counts1 = eng2._graphs.captures, eng2.compile_counts()
    steps = sum(e.stats["decode_steps"] for e in (eng, eng2))
    k2 = _k2_step_launches()
    k2_want = N_LAYERS * (steps + 2 * DECODE_CHUNK)
    kinds = sorted({e.kind for e in run["plan"].injected})
    victims = sum(r.retries > 0 for r in run["continued"])
    bad = (_diverged(run["continued"], ref), _diverged(run["restored"], ref),
           [i for i, r in enumerate(repeat) if r.finish_reason != "length"])
    fails = {k: eng.stats[k] for k in eng.FAILURE_KEYS if eng.stats[k]}
    poisoned = [sorted(e.block_pool.poisoned) if e.paged_kv else []
                for e in (eng, eng2)]
    snap, restore_s = run["snapshot"], run["restore_s"]
    live = sum(s is not None for s in snap["slots"])
    del eng, eng2, run
    torch.cuda.empty_cache()
    caught = {}
    with _fault_planted("all healthy"):
        eng = fault_engine(net, layout, fault_plan=fault_plan())
        faulted, _ = _serve_all(eng, prompts)
        caught["all healthy"] = bool(_diverged(faulted, ref))
        del eng
        torch.cuda.empty_cache()
    with _fault_planted("current token re-prefilled"):
        run = chaos_run(net, layout, prompts, snap=snap)
        caught["current token re-prefilled"] = bool(
            _diverged(run["restored"], ref))
        del run
        torch.cuda.empty_cache()
    log(f"fault [{layout}, float32]: {FAULT_REQUESTS} x {FAULT_GEN} tokens, "
        f"plan landed {kinds}, failure counts {fails}, victims {victims}; "
        f"ids against the fault-free run: diverged continued {bad[0]}, "
        f"restored {bad[1]} (snapshot after {FAULT_SNAPSHOT_AFTER} rounds: "
        f"{live} live slots, {len(snap['queue'])} queued, "
        f"{len(snap['requeue'])} requeued); graphs faulted / restored "
        f"{counts}, restored captures {caps0} -> {caps1} on a repeat "
        f"(unfinished {bad[2]}); K2 t = 1 launches {k2} (want "
        f"{N_LAYERS} x ({steps} steps + 2 x {DECODE_CHUNK} capture)"
        f"{'' if layout == 'paged' else ': dense, none'}); poisoned blocks "
        f"at the end {poisoned}; planted faults caught {caught}; fault-free "
        f"tokens/s paranoid off {rates[False]:.1f}, on {rates[True]:.1f} "
        f"({rates[True] / rates[False]:.4f}x; second runs, warm trie); "
        f"health check {health_ms:.4f} ms a replay (device, CUDA events "
        f"over {HEALTH_REPS}) against a round's wall {round_ms:.3f} ms "
        f"({100 * health_ms / round_ms:.2f}%; the round's wall from "
        f"dispatch to its token sync, timed run); restore "
        f"{restore_s:.3f} s ({live} slots and the trie re-prefilled) "
        f"[{card}]")
    want_kinds = sorted({kind for _, kind, _ in FAULT_PLAN})
    graphs_ok = all(c["decode"] == 1 and c["health_check"] == 1
                    for c in counts)
    ok = (kinds == want_kinds and victims >= 1 and fails.get("slow_steps")
          and not any(bad) and graphs_ok and caps0 == caps1
          and counts0 == counts1 and all(caught.values())
          and poisoned == [[], []])
    if layout == "paged":
        ok = ok and k2 == k2_want
    else:
        ok = ok and k2 == 0
    if not ok:
        raise SystemExit(
            f"chip_smoke: fault [{layout}] failed: plan {kinds}, victims "
            f"{victims}, diverged {bad}, graphs {counts} -> {counts1}, "
            f"captures {caps0} -> {caps1}, K2 {k2} against {k2_want}, "
            f"poisoned {poisoned}, planted faults caught {caught}")


def fault_async_cancel(card: str, net, prompts) -> None:
    """(b) A paged async engine serving the first N_SLOTS prompts; the
    request FAULT_CANCELLED is cancelled while the engine's first round
    is in flight. The neighbours' ids are those of the same engine run
    without the cancel, the cancelled request's a prefix of its own.
    The uncancelled run is greedy only, so its generator moves only
    through the graph replays: a state read after it that equals the
    seeded one would mean ``get_state()`` misses the replays (the
    snapshot's ``torch_rng_state``). Fatal on failure."""
    from deeplearning4j_tpu_torch.serving import Request

    prompts = prompts[:N_SLOTS]
    eng = fault_engine(net, "paged", async_rounds=True)
    seeded = eng._gen.get_state().clone()
    ref, _ = _serve_all(eng, prompts)
    moved = not torch.equal(eng._gen.get_state(), seeded)
    del eng
    eng = fault_engine(net, "paged", async_rounds=True)
    rids = [eng.submit(Request(list(p), FAULT_GEN)) for p in prompts]
    res = {}
    eng.step(res)
    inflight = (eng._inflight is not None
                and rids[FAULT_CANCELLED] in eng._inflight.rids.values())
    cancelled = eng.cancel(rids[FAULT_CANCELLED])
    while eng.has_work():
        eng.step(res)
    got = [res[i] for i in rids]
    cut = got[FAULT_CANCELLED]
    n = len(cut.tokens)
    others = [i for i in range(len(prompts)) if i != FAULT_CANCELLED
              and got[i].tokens != ref[i].tokens]
    trie = {b for t in eng.prefix_cache.tables() for b in t.blocks.values()}
    prefix = (cut.finish_reason == "cancelled" and 0 < n < FAULT_GEN
              and cut.tokens == ref[FAULT_CANCELLED].tokens[:n])
    log(f"fault async cancel [paged, float32]: request {FAULT_CANCELLED} "
        f"cancelled with its round in flight {inflight and cancelled}, "
        f"returned {n} tokens, a prefix of its uncancelled ids {prefix}; "
        f"neighbours differing {others}; blocks in use at the end "
        f"{eng.block_pool.used_blocks}, held by the trie {len(trie)}; "
        f"generator state moved by the greedy run's replays {moved} "
        f"[{card}]")
    if not (inflight and cancelled and prefix and not others and moved
            and eng.block_pool.used_blocks == len(trie)):
        raise SystemExit(
            f"chip_smoke: fault async cancel failed: in flight {inflight}, "
            f"cancelled {cancelled}, prefix {prefix}, neighbours {others}, "
            f"generator moved {moved}")
    del eng
    torch.cuda.empty_cache()


def fault_sampled_restore(card: str, net, prompts) -> None:
    """(c) The paged engine with the first FAULT_SAMPLED of N_SLOTS
    requests sampled at temperature 1.0: a snapshot after round 0 (the
    first 4 requests running, the sampled ones among them),
    restored twice, each restore run to its end: identical ids, sampled
    requests included. Fatal on failure."""
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        ManualClock,
        Request,
    )

    eng = fault_engine(net, "paged")
    for i, p in enumerate(prompts[:N_SLOTS]):
        eng.submit(Request(list(p), FAULT_GEN,
                           temperature=1.0 if i < FAULT_SAMPLED else 0.0))
    eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    del eng
    runs = []
    for _ in range(2):
        eng = DecodeEngine.restore(net, snap, clock=ManualClock())
        runs.append({k: r.tokens for k, r in eng.run().items()})
        del eng
        torch.cuda.empty_cache()
    same = runs[0] == runs[1]
    sampled = [snap["slots"][i]["request"]["id"] for i in range(N_SLOTS)
               if snap["slots"][i] is not None
               and snap["slots"][i]["request"]["temperature"] > 0]
    log(f"fault sampled restore [paged, float32]: {len(runs[0])} requests "
        f"({len(sampled)} sampled live at the snapshot) finish with "
        f"identical ids on two restores {same} [{card}]")
    if not same or len(runs[0]) != N_SLOTS or not sampled:
        raise SystemExit(f"chip_smoke: fault sampled restore failed: "
                         f"identical {same}, requests {len(runs[0])}, "
                         f"sampled live {sampled}")


def fault_phase(card: str) -> None:
    """Phase 15: (a) chaos parity with snapshot/restore on both layouts,
    (b) a cancel with an async round in flight, (c) two restores of a
    snapshot with sampled requests."""
    net = _serving_net("float32")
    prompts = fault_prompts()
    for layout in FAULT_LAYOUTS:
        fault_layout_phase(card, net, prompts, layout)
    fault_async_cancel(card, net, prompts)
    fault_sampled_restore(card, net, prompts)
    del net
    torch.cuda.empty_cache()


# Phase 16: the gateway, bench.py's bench_gateway_streaming: the serving
# net at bf16, 8 slots, chunk 32, 8 concurrent SSE clients (one thread
# each, in a process of their own: _Clients) of 128-token prompts
# (serving seed 0) and 128 new tokens through
# a ServingGateway (keep-alive 1 s, admission grace 0.25 s: the burst
# shares round 1), on both layouts: a warm round on an in-process engine
# (the reference ids) and one through the gateway's own engine, then
# GATEWAY_TRIALS interleaved in-process and HTTP rounds, then one more
# HTTP round while a client scrapes /v1/metrics. At f32 (the phase's
# gates): the paged engine with spec_draft_len 32 and prefix_cache_rows
# 4 over HTTP (the trie primed with the prompts' shared head through
# /v1/warmup, so every admission splices the same blocks whatever the
# arrival order); a paranoid paged engine with one NaN'd slot over HTTP,
# correct and with two planted delta faults; and observability
# (record_timing and a tracer) on against off in process.
GATEWAY_TRIALS = 3
GATEWAY_KEEPALIVE_S, GATEWAY_GRACE_S = 1.0, 0.25
GATEWAY_LAYOUTS = {"dense": {},
                   "paged": dict(paged_kv=True, block_tokens=BLOCK_TOKENS,
                                 use_flash_paged=True)}
GATEWAY_GEN32 = 64
#: timed pairs of the in-process observability on / off runs
GATEWAY_OBS_PAIRS = 5
GATEWAY_SPEC = dict(spec_draft_len=32, prefix_cache_rows=4)
GATEWAY_PLANTED = ("drops one delta", "re-sends the tail after a retry")
#: the endpoints a scraper hammers while the stepping thread captures:
#: those that answer without the gateway's lock (a handler that takes
#: it, as ``/v1/requests/<id>`` does, waits out the stepping thread's
#: round and cannot race its capture)
GATEWAY_SCRAPED = ("/v1/healthz", "/v1/metrics", "/v1/trace")
#: the pause after each pass of that scraper (an unpaused one made
#: 2,208-2,439 requests during one capture and stretched phase 16 to
#: 66.8 s on an NVIDIA H100 80GB HBM3 at 700.00 W)
GATEWAY_SCRAPE_PAUSE_S = 0.02


def gateway_head_prompts() -> tuple:
    """The f32 speculative run's prompts: a shared FAULT_HEAD-token head
    (whole blocks) and FAULT_TAIL-token tails whose first tokens all
    differ, so every admission's longest cached prefix is the head."""
    rng = np.random.default_rng(16)
    head = rng.integers(0, VOCAB, FAULT_HEAD).tolist()
    prompts = []
    for i in range(N_SLOTS):
        tail = rng.integers(0, VOCAB, FAULT_TAIL).tolist()
        tail[0] = i
        prompts.append(head + tail)
    return head, prompts


def _inproc_round(eng, prompts, n_gen) -> tuple:
    """Submit ``prompts`` (``n_gen`` new tokens) to ``eng`` and run it
    in process: (tokens/s from the first submit to the last token, ids
    in order, results in order)."""
    from deeplearning4j_tpu_torch.serving import Request

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(Request(list(p), n_gen)) for p in prompts]
    res = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = [res[i] for i in rids]
    return sum(len(r.tokens) for r in out) / dt, [r.tokens for r in out], out


def _client_round(job) -> dict:
    """One round of gateway clients, one thread per prompt, all started
    together: ``job`` is {"address", "prompts", "n_gen", "mode": "sse"
    (streams) or "blocking" (``/v1/generate``), and optionally "router":
    true for a ``RouterClient``}. Returns each client's concatenated
    ids, its terminal and (SSE) its time to the first delta and its
    events as (SSE id, tokens delivered through the event), the
    clients' errors by index, and the round's wall."""
    from deeplearning4j_tpu_torch.serving.client import GatewayClient
    from deeplearning4j_tpu_torch.serving.router import RouterClient

    cls = RouterClient if job.get("router") else GatewayClient
    client = cls(job["address"], timeout_s=600.0)
    prompts, n_gen = job["prompts"], job["n_gen"]
    n = len(prompts)
    outs, results, ttfts, errors = [None] * n, [None] * n, [None] * n, {}
    events = [None] * n

    def one(i):
        try:
            t_sub = time.perf_counter()
            if job["mode"] == "blocking":
                results[i] = client.generate(prompts[i], n_gen)
                outs[i] = results[i]["tokens"]
                return
            st = client.stream(prompts[i], n_gen)
            toks, first, evs = [], None, []
            for delta in st:
                if first is None:
                    first = time.perf_counter() - t_sub
                toks.extend(delta)
                evs.append((st.last_event_id, len(toks)))
            outs[i], results[i], ttfts[i] = toks, st.result, first
            events[i] = evs
        except Exception as e:      # the phase names the failed client
            errors[i] = repr(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    errors.update({i: "still running" for i, t in enumerate(threads)
                   if t.is_alive()})
    return {"outs": outs, "results": results, "ttfts": ttfts,
            "events": events, "errors": errors, "wall": wall}


def _client_loop() -> None:
    """The client process's body (``_Clients``): one JSON job a line in,
    one ``_client_round`` result a line out, until stdin closes."""
    print("ready", flush=True)
    for line in sys.stdin:
        print(json.dumps(_client_round(json.loads(line))), flush=True)


class _Clients:
    """The gateway phase's clients, in a process of their own: clients
    that are threads of the server's process would take its interpreter
    lock from the gateway's stepping and handler threads, which no user
    of a gateway pays. ``round`` runs one ``_client_round`` there and
    adds its tokens/s over the round's wall; a client that fails fails
    the phase. A context manager: the process ends on exit."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             "chip_smoke._client_loop()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env)
        if self.proc.stdout.readline().strip() != "ready":
            self.close()
            raise SystemExit("chip_smoke: the client process did not start")

    def round(self, address, prompts, n_gen, mode="sse",
              router=False) -> dict:
        self.proc.stdin.write(json.dumps(
            {"address": address, "prompts": prompts, "n_gen": n_gen,
             "mode": mode, "router": router}) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise SystemExit("chip_smoke: the client process ended")
        out = json.loads(line)
        if out["errors"]:
            raise SystemExit(f"chip_smoke: gateway clients failed: "
                             f"{out['errors']}")
        out["rate"] = sum(len(o) for o in out["outs"]) / out["wall"]
        return out

    def close(self) -> None:
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=60)
        except Exception:
            self.proc.kill()
            self.proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


SCRAPER_THREAD = "chip_smoke scraper"


class _Scraper:
    """A client thread that sends ``paths`` in turn until stopped, only
    while ``while_()`` holds where one is given (it polls it every
    millisecond), pausing ``pause_s`` after each pass: a path is a GET,
    a ``(method, path, body)`` triple any request. The wall of each
    ``/v1/metrics`` scrape is kept, and every answer's status by
    (method, path less its query)."""

    def __init__(self, address, paths, while_=None, pause_s=0.0):
        import http.client
        import urllib.parse

        self._http = http.client
        self.host = urllib.parse.urlsplit(address).netloc
        self.paths = paths
        self.while_ = while_
        self.pause_s = pause_s
        self.metrics_s: list = []
        self.statuses: collections.Counter = collections.Counter()
        self.n = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=SCRAPER_THREAD)

    def _run(self):
        while not self._stop.is_set():
            if self.while_ is not None and not self.while_():
                time.sleep(0.001)
                continue
            for item in self.paths:
                method, path, body = (("GET", item, None)
                                      if isinstance(item, str) else item)
                conn = self._http.HTTPConnection(self.host, timeout=60)
                t0 = time.perf_counter()
                conn.request(method, path, body=body)
                resp = conn.getresponse()
                resp.read()
                if path == "/v1/metrics":
                    self.metrics_s.append(time.perf_counter() - t0)
                self.statuses[(method, path.partition("?")[0],
                               resp.status)] += 1
                conn.close()
                self.n += 1
            time.sleep(self.pause_s)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


class _CaptureWatch:
    """Records every call into torch made by a thread other than the
    gateway's stepping thread while a ``GraphRunner`` captures a graph
    (the stepping thread captures; CUDA work from a handler thread
    meanwhile would break the capture, and no handler may launch any).
    ``threading.setprofile`` reaches the threads started inside
    ``watching()`` (the gateway's stepping thread, each connection's
    handler thread); the hook removes itself from the stepping thread
    and from the scraper's own thread. ``overlap`` counts the events
    the gateway's other threads ran during captures: that they raced
    the capture at all."""

    def __init__(self):
        self.capturing = 0
        self.stepper = None
        self.stray: list = []
        self.overlap = 0
        self.captures = 0
        self._torch_dir = os.path.dirname(torch.__file__)

    def _hook(self, frame, event, arg):
        if (threading.get_ident() == self.stepper
                or threading.current_thread().name == SCRAPER_THREAD):
            sys.setprofile(None)
            return
        if not self.capturing:
            return
        self.overlap += 1
        name = None
        if event == "call":
            if frame.f_code.co_filename.startswith(self._torch_dir):
                name = frame.f_code.co_name
        elif event == "c_call":
            mod = getattr(arg, "__module__", None) or ""
            if (mod.startswith("torch")
                    or isinstance(getattr(arg, "__self__", None),
                                  torch.Tensor)):
                name = getattr(arg, "__name__", repr(arg))
        if name is not None:
            self.stray.append((threading.current_thread().name, name))

    @contextlib.contextmanager
    def watching(self):
        from deeplearning4j_tpu_torch.nn import cuda_graphs

        orig = cuda_graphs.GraphRunner._capture
        watch = self

        def capture(runner, *args, **kw):
            watch.capturing += 1
            watch.captures += 1
            try:
                return orig(runner, *args, **kw)
            finally:
                watch.capturing -= 1

        cuda_graphs.GraphRunner._capture = capture
        threading.setprofile(self._hook)
        try:
            yield self
        finally:
            threading.setprofile(None)
            cuda_graphs.GraphRunner._capture = orig


def _gateway(engine, watch=None):
    """A started ServingGateway over ``engine`` at the phase's keep-alive
    and admission grace (its stepping thread registered with ``watch``)."""
    from deeplearning4j_tpu_torch.serving import ServingGateway

    gw = ServingGateway(engine, keepalive_s=GATEWAY_KEEPALIVE_S,
                        admission_grace_s=GATEWAY_GRACE_S).start()
    if watch is not None:
        watch.stepper = gw._stepper.ident
    return gw


def _quantile_ms(values, q) -> float:
    return float(np.quantile(np.asarray(values, np.float64), q)) * 1e3


def _host_step_ms(eng) -> float:
    """The engine's median host time between a round's token sync and
    the next dispatch (``serving_host_step_s``), ms."""
    return eng.histograms["serving_host_step_s"].quantile(0.5) * 1e3


def gateway_layout_phase(card: str, net, layout: str, clients) -> int:
    """bench_gateway_streaming on ``layout`` at bf16, the SSE clients in
    ``clients``' process. Gates: every stream's ids equal the in-process
    engine's, no graph captured across the timed HTTP rounds, handler
    threads ran during the stepping thread's capture and made no torch
    call; paged,
    K2 launched N_LAYERS times per decode step of the gateway's engine
    (its capture's warm-up steps included). Returns K2's t = 1 launches
    under the gateway, counted over its HTTP rounds alone (the
    in-process engine's rounds, which give the ids and the rate the
    gateway is held to, are not counted)."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    prompts = serving_prompts(0, n=N_SLOTS)
    geometry = dict(n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                    **GATEWAY_LAYOUTS[layout])
    inproc = DecodeEngine(net, **geometry)
    _, ref, _ = _inproc_round(inproc, prompts, N_GEN)
    gw_eng = DecodeEngine(net, **geometry)
    launches = 0

    def http_round(address):
        nonlocal launches
        paged_attention.launches = paged_attention.chunk_launches = 0
        h = clients.round(address, prompts, N_GEN)
        launches += _k2_step_launches()
        return h

    watch = _CaptureWatch()
    with watch.watching():
        gw = _gateway(gw_eng, watch)
        try:
            # scraping only while the stepping thread captures, a pass
            # every GATEWAY_SCRAPE_PAUSE_S, keeps the profile hook's cost
            # (the GIL the handler threads take) small
            with _Scraper(gw.address, GATEWAY_SCRAPED,
                          lambda: watch.capturing > 0,
                          GATEWAY_SCRAPE_PAUSE_S) as scraper:
                warm = http_round(gw.address)
        except BaseException:
            gw.close()
            raise
    diverged = [i for i in range(N_SLOTS)
                if warm["outs"][i] != ref[i]
                or warm["results"][i]["tokens"] != ref[i]]
    try:
        counts0 = gw_eng.compile_counts()
        in_rates, http_rates, ttft_client, ttft_engine = [], [], [], []
        for _ in range(GATEWAY_TRIALS):
            rate, ids, _ = _inproc_round(inproc, prompts, N_GEN)
            in_rates.append(rate)
            diverged += [i for i in range(N_SLOTS) if ids[i] != ref[i]]
            h = http_round(gw.address)
            http_rates.append(h["rate"])
            ttft_client += h["ttfts"]
            ttft_engine += [r["ttft_s"] for r in h["results"]]
            diverged += [i for i in range(N_SLOTS)
                         if h["outs"][i] != ref[i]]
        counts1 = gw_eng.compile_counts()
        with _Scraper(gw.address, ("/v1/metrics",)) as metrics:
            scraped = http_round(gw.address)
    finally:
        gw.close()
    steps = (gw_eng.stats["decode_steps"]
             + DECODE_CHUNK * gw_eng._graphs.captures)
    want_k2 = N_LAYERS * steps if layout == "paged" else 0
    in_rate, http_rate = float(np.median(in_rates)), float(np.median(
        http_rates))
    log(f"gateway [{layout}, bf16]: {N_SLOTS} SSE clients x {N_GEN} "
        f"tokens in a process of their own, chunk {DECODE_CHUNK}; HTTP "
        f"{http_rate:.1f} tokens/s (trials "
        f"{[round(r, 1) for r in http_rates]}) against in-process "
        f"run() {in_rate:.1f} from submit (trials "
        f"{[round(r, 1) for r in in_rates]}): {http_rate / in_rate:.3f}x "
        f"(a report; JAX gates 0.9x); client "
        f"TTFT p50 {_quantile_ms(ttft_client, 0.5):.1f} ms, p99 "
        f"{_quantile_ms(ttft_client, 0.99):.1f} against the engine's "
        f"timing p50 {_quantile_ms(ttft_engine, 0.5):.1f}, p99 "
        f"{_quantile_ms(ttft_engine, 0.99):.1f}; host time a step "
        f"(token sync to next dispatch, p50) gateway "
        f"{_host_step_ms(gw_eng):.3f} ms, in-process "
        f"{_host_step_ms(inproc):.3f}; /v1/metrics while streaming "
        f"p50 {_quantile_ms(metrics.metrics_s, 0.5):.2f} ms, max "
        f"{max(metrics.metrics_s) * 1e3:.2f} over "
        f"{len(metrics.metrics_s)} scrapes (that round "
        f"{scraped['rate']:.1f} tokens/s); during the warm round's "
        f"{watch.captures} captures the scraper made {scraper.n} requests "
        f"and the gateway's other threads ran {watch.overlap} Python "
        f"calls, {len(watch.stray)} into torch; graphs {counts0} -> "
        f"{counts1}; ids diverged {sorted(set(diverged))}; K2 t = 1 "
        f"launches under the gateway {launches} (want {want_k2}"
        + (f": {N_LAYERS} layers x {steps} steps" if want_k2 else "")
        + f") [{card}]")
    if (diverged or counts1 != counts0 or watch.stray
            or watch.captures < 1 or watch.overlap < 1
            or launches != want_k2 or metrics.metrics_s == []):
        raise SystemExit(
            f"chip_smoke: gateway {layout} failed: diverged "
            f"{sorted(set(diverged))}, graphs {counts0} -> {counts1}, "
            f"torch calls during captures {watch.stray[:8]}, captures "
            f"{watch.captures}, calls raced {watch.overlap}, K2 launches "
            f"{launches} (want {want_k2})")
    del inproc, gw_eng
    torch.cuda.empty_cache()
    return launches


def _stream_failures(h, want) -> list:
    """The clients whose concatenated deltas or terminal tokens differ
    from ``want``."""
    return [i for i in range(len(want))
            if h["outs"][i] != want[i]
            or h["results"][i]["tokens"] != want[i]]


def gateway_spec_phase(card: str, net32, clients) -> None:
    """The f32 paged engine with speculation and the prefix cache over
    HTTP: every stream's ids equal the in-process engine's (deltas from
    verify passes, splices and the admissions' first tokens), with
    verify passes and splices in the gateway's run."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine, GatewayClient

    head, prompts = gateway_head_prompts()
    geometry = dict(n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                    **GATEWAY_LAYOUTS["paged"], **GATEWAY_SPEC)
    inproc = DecodeEngine(net32, **geometry)
    _inproc_round(inproc, [head], 1)          # what /v1/warmup does
    _, ref, _ = _inproc_round(inproc, prompts, N_GEN)
    gw_eng = DecodeEngine(net32, **geometry)
    gw = _gateway(gw_eng)
    try:
        warmed = GatewayClient(gw.address).warmup([head])
        h = clients.round(gw.address, prompts, N_GEN)
    finally:
        gw.close()
    bad = _stream_failures(h, ref)
    st = gw_eng.stats
    log(f"gateway [paged, f32, spec_draft_len 32, prefix_cache_rows 4]: "
        f"warmup {warmed}; {len(bad)} of {N_SLOTS} streams differ from "
        f"the in-process ids; verify passes {st['spec_rounds']}, drafted "
        f"{st['spec_drafted']}, accepted {st['spec_accepted']}; blocks "
        f"spliced {st['prefix_blocks_spliced']}, prompt tokens skipped "
        f"{st['prefill_tokens_skipped']}; graphs "
        f"{gw_eng.compile_counts()} [{card}]")
    if (bad or st["spec_rounds"] < 1 or st["spec_accepted"] < 1
            or st["prefix_blocks_spliced"] < 1):
        raise SystemExit(f"chip_smoke: gateway f32 speculative run failed:"
                         f" streams {bad} differ, stats {st}")
    del inproc, gw_eng
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _delta_planted(name, eng):
    """A planted fault of delivery, within the block: "drops one delta"
    drops the first delta the gateway's fan-out receives; "re-sends the
    tail after a retry" forgets a retried request's high-water mark once,
    so its regenerated tokens stream again."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    if name == "drops one delta":
        fan_out, dropped = eng.on_delta, []

        def dropping(rid, tokens):
            if dropped:
                fan_out(rid, tokens)
            else:
                dropped.append(rid)

        eng.on_delta = dropping
        try:
            yield
        finally:
            eng.on_delta = fan_out
        return
    orig, resent = DecodeEngine._emit_delta, set()

    def resend(self, rid, tokens):
        if self._retries.get(rid) and rid not in resent:
            resent.add(rid)
            self._delta_sent[rid] = 0
        orig(self, rid, tokens)

    DecodeEngine._emit_delta = resend
    try:
        yield
    finally:
        DecodeEngine._emit_delta = orig


def gateway_f32_phase(card: str, clients) -> None:
    """At f32: the speculative run; observability on against off in
    process (ids and graphs identical, tokens/s of both); then a paranoid
    paged engine with one NaN'd slot over HTTP: the victim's greedy
    retry streams nothing twice and every stream equals the fault-free
    ids, and each planted delta fault breaks that."""
    from deeplearning4j_tpu_torch.profiler.tracer import Tracer
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        FaultEvent,
        FaultPlan,
    )

    net32 = _serving_net("float32")
    gateway_spec_phase(card, net32, clients)
    prompts = serving_prompts(1, n=N_SLOTS)
    geometry = dict(n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK,
                    paranoid=True, max_retries=2, **GATEWAY_LAYOUTS["paged"])
    tracer = Tracer()
    on = DecodeEngine(net32, tracer=tracer, **geometry)
    off = DecodeEngine(net32, record_timing=False, flight_recorder=0,
                       **geometry)
    runs = {"on": [], "off": []}
    for _ in range(1 + GATEWAY_OBS_PAIRS):
        for name, eng in (("on", on), ("off", off)):
            runs[name].append(_inproc_round(eng, prompts, GATEWAY_GEN32))
    same = all(a[1] == b[1] for a, b in zip(runs["on"], runs["off"]))
    timed = runs["on"][-1][2][0].timing is not None
    graphs = (on.compile_counts(), off.compile_counts())
    rate = {k: [r[0] for r in v[1:]] for k, v in runs.items()}
    med = {k: float(np.median(v)) for k, v in rate.items()}
    log(f"gateway observability [paged, f32]: record_timing and a tracer "
        f"on against off, {N_SLOTS} x {GATEWAY_GEN32} tokens: ids "
        f"identical {same}; graphs {graphs[0]} / {graphs[1]}; tokens/s "
        f"median of {GATEWAY_OBS_PAIRS} interleaved pairs after a warm "
        f"pair {med['on']:.1f} / {med['off']:.1f} "
        f"({med['on'] / med['off']:.3f}x; on "
        f"{[round(r, 1) for r in rate['on']]}, off "
        f"{[round(r, 1) for r in rate['off']]}); "
        f"{len(tracer.spans())} spans, timing filled {timed} [{card}]")
    if not same or graphs[0] != graphs[1] or not timed:
        raise SystemExit(f"chip_smoke: observability changed the run: ids "
                         f"identical {same}, graphs {graphs}")
    want = runs["off"][0][1]
    del on, off
    torch.cuda.empty_cache()
    gw_eng = DecodeEngine(net32, **geometry)
    gw = _gateway(gw_eng)
    caught = {}
    try:
        for name in (None,) + GATEWAY_PLANTED:
            with gw._engine_access():
                # the first round admits and decodes all 8; the NaN lands
                # in the second, after slot 0 streamed its first delta
                gw_eng.fault_plan = FaultPlan([FaultEvent(
                    gw_eng._round + 1, "nan", slot=0)])
                retries0 = gw_eng.stats["retries"]
            with (_delta_planted(name, gw_eng) if name
                  else contextlib.nullcontext()):
                h = clients.round(gw.address, prompts, GATEWAY_GEN32)
            bad = _stream_failures(h, want)
            retried = gw_eng.stats["retries"] - retries0
            if name is None:
                log(f"gateway faults [paged, f32, paranoid]: a NaN'd slot "
                    f"over HTTP: {retried} retry, {len(bad)} streams "
                    f"differ from the fault-free ids [{card}]")
                if bad or retried < 1:
                    raise SystemExit(
                        f"chip_smoke: gateway fault run failed: streams "
                        f"{bad} differ, {retried} retries")
            else:
                caught[name] = bool(bad) and retried >= 1
    finally:
        gw.close()
    log(f"gateway planted delta faults caught: {caught} [{card}]")
    if not all(caught.values()):
        raise SystemExit(f"chip_smoke: a planted delta fault passed the "
                         f"stream check: {caught}")
    del gw_eng, net32
    torch.cuda.empty_cache()


def gateway_phase(card: str) -> int:
    """Phase 16: the gateway on both layouts at bf16, then the f32 gates,
    every client in one process of their own. Returns K2's t = 1
    launches under the bf16 gateways."""
    net = _serving_net("bfloat16")
    launches = 0
    with _Clients() as clients:
        for layout in GATEWAY_LAYOUTS:
            launches += gateway_layout_phase(card, net, layout, clients)
        del net
        torch.cuda.empty_cache()
        gateway_f32_phase(card, clients)
    return launches


# Phase 17: tenancy, KV transfer and the KV spill tiers. (a) bench.py's
# bench_tenant_qos_overhead shape on the serving net at bf16 (8 slots,
# chunk 32, 8 x 128-token prompts, 128 new tokens; paged, bt 16): a
# default-tenant registry against none, TENANT_TIMED interleaved rounds
# after a warm round. (b) At f32 on the same engine geometry: a flooder
# fills every slot, its quota is then cut to TENANT_FLOOD_QUOTA slots
# (a live re-registration: the flooder is over it) and a premium
# arrival preempts an over-quota slot. (c) bench_kv_transfer row 1's
# shape (the width-512 4-layer net, window 1024, 3 x 512-token prompts,
# 16 new tokens, 2 slots, chunk 8, prefix_cache_rows 4, prefill_chunk
# 64): warm admission (import + TTFT) against recompute TTFT at bf16;
# at f32 the receiver's ids and imported K/V against the donor's, with
# two planted payload faults; a gateway whose /v1/kv/export and
# /v1/kv/import are hit while its stepping thread captures. (d)
# bench_kv_tier row 1's shape (the same net at window 544, 6 x 512-token
# prompts over a 48-block pool, 1 slot, chunk 8, prefix_cache_rows 8,
# prefill_chunk 64, a 64 MiB host tier): tiered against untiered
# tokens/s over 2 timed passes after 2 set-up passes, the host time a
# staged spill costs a round, ids at f32 and one disk-ring reload.
TENANT_TIMED = 3
TENANT_FLOOD_GEN, TENANT_PREMIUM_GEN, TENANT_FLOOD_QUOTA = 64, 16, 6
KV_PROMPT_LEN, KV_GEN, KV_TRIALS = 512, 16, 3
KV_ENGINE = dict(n_slots=2, decode_chunk=8, paged_kv=True,
                 block_tokens=BLOCK_TOKENS, prefix_cache_rows=4,
                 prefill_chunk=64, seed=0, use_flash_paged=True)
KV_FAULTS = ("two blocks swapped", "written one position off")
TIER_WINDOW, TIER_PROMPTS, TIER_GEN, TIER_BLOCKS = 544, 6, 8, 48
TIER_ENGINE = dict(n_slots=1, decode_chunk=8, paged_kv=True,
                   block_tokens=BLOCK_TOKENS, kv_blocks=TIER_BLOCKS,
                   prefix_cache_rows=8, prefill_chunk=64, seed=0,
                   use_flash_paged=True)
TIER_HOST_BYTES, TIER_SETUP, TIER_TIMED = 64 << 20, 2, 2


def _paged_geometry() -> dict:
    return dict(n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK, paged_kv=True,
                block_tokens=BLOCK_TOKENS, use_flash_paged=True)


def _decode_steps(eng) -> int:
    """Decode steps the engine's device ran: its rounds' and each graph
    capture's (a capture runs the round's body once)."""
    return eng.stats["decode_steps"] + eng.decode_chunk * eng._graphs.captures


def tenant_overhead_phase(card: str) -> None:
    """17a: the FIFO engine and one with a default-tenant registry at
    bf16, a warm round each, then TENANT_TIMED interleaved rounds.
    Report: tokens/s of both and their ratio (JAX gates 0.97x; here a
    report). Gates: ids identical, no preemption or shed, no graph
    captured across the timed rounds, K2 launched N_LAYERS times per
    decode step."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import DecodeEngine, TenantRegistry

    net = _serving_net("bfloat16")
    prompts = serving_prompts(0, n=N_SLOTS)
    engines = {"fifo": DecodeEngine(net, **_paged_geometry()),
               "fair": DecodeEngine(net, tenants=TenantRegistry(),
                                    **_paged_geometry())}
    ref = {name: _inproc_round(eng, prompts, N_GEN)[1]
           for name, eng in engines.items()}
    diverged = ref["fair"] != ref["fifo"]
    counts0 = {k: e.compile_counts() for k, e in engines.items()}
    steps0 = sum(_decode_steps(e) for e in engines.values())
    paged_attention.launches = paged_attention.chunk_launches = 0
    rates = {name: [] for name in engines}
    for _ in range(TENANT_TIMED):
        for name, eng in engines.items():
            rate, ids, _ = _inproc_round(eng, prompts, N_GEN)
            rates[name].append(rate)
            diverged |= ids != ref["fifo"]
    launches = _k2_step_launches()
    steps = sum(_decode_steps(e) for e in engines.values()) - steps0
    counts1 = {k: e.compile_counts() for k, e in engines.items()}
    fair = engines["fair"].stats
    acted = {k: fair[k] for k in ("qos_preempted", "preempted", "shed")}
    med = {k: float(np.median(v)) for k, v in rates.items()}
    graphs = {k: (counts0[k]["decode"], counts1[k]["decode"])
              for k in engines}
    log(f"tenancy overhead [paged, bf16]: {N_SLOTS} x {N_GEN} tokens, "
        f"chunk {DECODE_CHUNK}; default-tenant registry "
        f"{med['fair']:.1f} tokens/s against none {med['fifo']:.1f} "
        f"(median of {TENANT_TIMED} interleaved rounds; fair "
        f"{[round(r, 1) for r in rates['fair']]}, fifo "
        f"{[round(r, 1) for r in rates['fifo']]}): "
        f"{med['fair'] / med['fifo']:.3f}x (a report; JAX gates 0.97x); "
        f"ids identical {not diverged}; QoS acted {acted}; decode graphs "
        f"before / after the timed rounds {graphs}, all counts unchanged "
        f"{counts0 == counts1}; K2 t = 1 launches {launches} (want "
        f"{N_LAYERS} x {steps} steps) [{card}]")
    if (diverged or any(acted.values()) or counts1 != counts0
            or launches != N_LAYERS * steps):
        raise SystemExit(
            f"chip_smoke: tenancy overhead failed: diverged {diverged}, "
            f"QoS acted {acted}, graphs {counts0} -> {counts1}, K2 "
            f"launches {launches} (want {N_LAYERS * steps})")
    del engines, net
    torch.cuda.empty_cache()


def tenant_preemption_phase(card: str) -> None:
    """17b at f32: N_SLOTS flood requests fill every slot, the flood
    quota drops to TENANT_FLOOD_QUOTA (the flooder is over it) and a
    premium request arrives. Gates: one QoS preemption, the premium
    request admitted in the round it arrives, every request's ids equal
    a tenancy-off engine's, K2 launched N_LAYERS times per decode
    step."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        Request,
        TenantRegistry,
        TenantSpec,
    )

    net32 = _serving_net("float32")
    flood_prompts = serving_prompts(2, n=N_SLOTS)
    premium = serving_prompts(3, n=1)[0]
    reg = TenantRegistry((TenantSpec("premium", priority=2),
                          TenantSpec("flood")))
    eng = DecodeEngine(net32, tenants=reg, **_paged_geometry())
    admitted_at = {}
    start = eng._start_admission

    def record(request, slot):
        admitted_at.setdefault(request.id, eng._round)
        return start(request, slot)

    eng._start_admission = record
    paged_attention.launches = paged_attention.chunk_launches = 0
    flood = [eng.submit(Request(list(p), TENANT_FLOOD_GEN, tenant="flood"))
             for p in flood_prompts]
    res = {}
    eng.step(res)
    full = all(s is not None for s in eng._slots)
    reg.register(TenantSpec("flood", max_slots=TENANT_FLOOD_QUOTA))
    arrival = eng._round
    prem = eng.submit(Request(list(premium), TENANT_PREMIUM_GEN,
                              tenant="premium"))
    while eng.has_work():
        eng.step(res)
    launches = _k2_step_launches()
    steps = _decode_steps(eng)
    off = DecodeEngine(net32, **_paged_geometry())
    rids = [off.submit(Request(list(p), TENANT_FLOOD_GEN))
            for p in flood_prompts]
    rids.append(off.submit(Request(list(premium), TENANT_PREMIUM_GEN)))
    want = off.run()
    diverged = [i for i, (a, b) in enumerate(zip(flood + [prem], rids))
                if res[a].tokens != want[b].tokens]
    log(f"tenancy preemption [paged, f32]: {N_SLOTS} flood requests fill "
        f"the slots ({full}), the flood quota drops to "
        f"{TENANT_FLOOD_QUOTA}, a premium request arrives in round "
        f"{arrival} and is admitted in round {admitted_at.get(prem)}; "
        f"QoS preemptions {eng.stats['qos_preempted']}, preempted "
        f"{eng.stats['preempted']}; tenant_stats {eng.tenant_stats}; ids "
        f"against a tenancy-off engine diverged {diverged}; K2 t = 1 "
        f"launches {launches} (want {N_LAYERS} x {steps} steps) [{card}]")
    if (not full or admitted_at.get(prem) != arrival
            or eng.stats["qos_preempted"] != 1 or diverged
            or any(res[i].finish_reason != "length" for i in res)
            or launches != N_LAYERS * steps):
        raise SystemExit(
            f"chip_smoke: tenancy preemption failed: full {full}, premium "
            f"admitted in {admitted_at.get(prem)} (arrived {arrival}), QoS "
            f"preemptions {eng.stats['qos_preempted']}, diverged "
            f"{diverged}, K2 launches {launches} (want "
            f"{N_LAYERS * steps})")
    del eng, off, net32
    torch.cuda.empty_cache()


def kv_prompts() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, VOCAB, KV_PROMPT_LEN).tolist()
            for _ in range(KV_TRIALS)]


def _run_one(eng, prompt, n_gen):
    from deeplearning4j_tpu_torch.serving import Request

    rid = eng.submit(Request(list(prompt), n_gen))
    return eng.run()[rid]


def _donor_payloads(net, prompts) -> tuple:
    """A donor engine's ids for each prompt and its export after it."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    donor = DecodeEngine(net, **KV_ENGINE)
    refs, payloads = [], []
    for p in prompts:
        refs.append(_run_one(donor, p, KV_GEN).tokens)
        payloads.append(donor.export_kv(p))
    if any(pay is None for pay in payloads):
        raise SystemExit("chip_smoke: the KV donor exported nothing")
    return refs, payloads


def _kv_fault(payload: bytes, name: str) -> bytes:
    """A planted payload fault: "two blocks swapped" exchanges the
    first two blocks of every layer's K and V (the same keys in another
    order: a model without positional encoding cannot see it in its
    ids, the imported K/V check does); "written one position off" moves
    every token's K and V one position later (the first kept, the last
    lost)."""
    from deeplearning4j_tpu_torch.serving import pack_prefix, unpack_prefix

    u = unpack_prefix(payload)
    h = u["header"]
    layers = []
    for name_ in sorted(u["layers"]):
        out = []
        for t in u["layers"][name_]:
            t = t.clone()
            if name == "two blocks swapped":
                t[[0, 1]] = t[[1, 0]]
            else:
                flat = t.reshape(-1, *t.shape[2:])
                flat[1:] = flat[:-1].clone()
            out.append(t)
        layers.append((name_,) + tuple(out))
    return pack_prefix(h["tokens"], h["blocks"], h["floor"],
                       h["block_tokens"], layers)


def _imported_kv_err(eng, rid, payload) -> float:
    """Max |slot K/V - payload K/V| over the payload's positions (the
    donor's K/V), read through the table of the slot holding ``rid``
    (after its admission, before it finishes)."""
    from deeplearning4j_tpu_torch.serving import unpack_prefix

    u = unpack_prefix(payload)
    n = u["header"]["length"] - u["header"]["floor"]
    slot = next(i for i, s in enumerate(eng._slots)
                if s is not None and s.request.id == rid)
    tab = eng._kv_tabs[slot]
    got = slot_kv(eng, slot, tab.length)
    err = 0.0
    for (k, v), name in zip(got, sorted(u["layers"])):
        for have, want in zip((k, v), u["layers"][name]):
            want = want.reshape(-1, *want.shape[2:])[:n].transpose(0, 1)
            err = max(err, float((have[:, :n].float().cpu()
                                  - want.float()).abs().max()))
    return err


def _warm_receiver_ids(net32, prompts, payloads, donor) -> tuple:
    """A fresh f32 receiver imports each payload, then serves its
    prompt: (ids, the K/V errors against the ``donor`` payloads after
    each admission)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    recv = DecodeEngine(net32, **KV_ENGINE)
    ids, errs = [], []
    for p, pay, truth in zip(prompts, payloads, donor):
        if not recv.import_kv(pay)["imported"]:
            raise SystemExit("chip_smoke: an f32 KV import was declined")
        rid = recv.submit(Request(list(p), KV_GEN))
        res = recv.step()
        errs.append(_imported_kv_err(recv, rid, truth) if rid not in res
                    else np.inf)
        res.update(recv.run())
        ids.append(res[rid].tokens)
    return ids, errs


def kv_capture_watch(card: str, net, prompts, payloads) -> None:
    """A fresh paged gateway with a prefix cache: while its stepping
    thread captures its first decode graph, a client hits
    ``/v1/kv/export`` and ``/v1/kv/import`` (a donor's payload) again
    and again. Gates: those handler threads ran during the capture and
    made no torch call then, and every hit answered (export 200 or 404,
    import 200)."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine, GatewayClient

    eng = DecodeEngine(net, **KV_ENGINE)
    export = "/v1/kv/export?tokens=" + ",".join(map(str, prompts[1]))
    paths = (export, ("POST", "/v1/kv/import", payloads[1]))
    watch = _CaptureWatch()
    with watch.watching():
        gw = _gateway(eng, watch)
        try:
            with _Scraper(gw.address, paths, lambda: watch.capturing > 0,
                          GATEWAY_SCRAPE_PAUSE_S) as scraper:
                out = GatewayClient(gw.address, timeout_s=600.0).generate(
                    prompts[0], KV_GEN)
        finally:
            gw.close()
    bad = {k: n for k, n in scraper.statuses.items()
           if k[2] not in ((200, 404) if k[0] == "GET" else (200,))}
    kv_hits = sum(scraper.statuses.values())
    log(f"KV gateway capture watch [paged, bf16]: {watch.captures} "
        f"captures; the client made {kv_hits} /v1/kv hits "
        f"({dict(scraper.statuses)}) and the gateway's other threads ran "
        f"{watch.overlap} Python calls during them, {len(watch.stray)} "
        f"into torch; generate finished {out['finish_reason']} [{card}]")
    if (watch.stray or watch.captures < 1 or watch.overlap < 1
            or kv_hits < 2 or bad or out["finish_reason"] != "length"):
        raise SystemExit(
            f"chip_smoke: KV capture watch failed: torch calls during "
            f"captures {watch.stray[:8]}, captures {watch.captures}, calls "
            f"raced {watch.overlap}, hits {kv_hits}, bad answers {bad}")
    del eng


def kv_transfer_phase(card: str) -> None:
    """17c. bf16: a donor warms and exports KV_TRIALS prompts (each
    payload unpacks and packs back to the same bytes); a cold receiver's
    recompute TTFT against a warm receiver's import wall + TTFT, median
    of KV_TRIALS. Gates: every warm admission splices >= 511 tokens and
    runs K2 STORM_LAYERS times per warm chunk (t > 1) and per decode
    step. f32: a receiver that imports the donor's payloads gives the
    donor's ids with the imported K/V bit-identical to the payload;
    each planted payload fault (KV_FAULTS) must break that. Then the
    gateway capture watch."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import (
        DecodeEngine,
        pack_prefix,
        unpack_prefix,
    )

    net = _storm_net("bfloat16")
    prompts = kv_prompts()
    refs, payloads = _donor_payloads(net, prompts)
    repack = []
    for pay in payloads:
        u = unpack_prefix(pay)
        h = u["header"]
        repack.append(pack_prefix(
            h["tokens"], h["blocks"], h["floor"], h["block_tokens"],
            [(n,) + u["layers"][n] for n in sorted(u["layers"])]) == pay)
    cold = DecodeEngine(net, **KV_ENGINE)
    warm = DecodeEngine(net, **KV_ENGINE)
    cold_ttft, warm_cost, reused, agree, k2 = [], [], [], [], []
    for i, p in enumerate(prompts):
        cold_ttft.append(_run_one(cold, p, KV_GEN).ttft_s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = warm.import_kv(payloads[i])
        torch.cuda.synchronize()
        t_import = time.perf_counter() - t0
        if not out["imported"]:
            raise SystemExit(f"chip_smoke: KV import declined: {out}")
        chunks0, steps0 = warm.stats["chunks_scheduled"], _decode_steps(warm)
        paged_attention.launches = paged_attention.chunk_launches = 0
        res = _run_one(warm, p, KV_GEN)
        k2.append((paged_attention.chunk_launches,
                   warm.stats["chunks_scheduled"] - chunks0,
                   _k2_step_launches(), _decode_steps(warm) - steps0))
        warm_cost.append(t_import + res.ttft_s)
        reused.append(res.prefix_tokens_reused)
        agree.append(request_agreement(res.tokens, refs[i]))
    k2_bad = [c for c in k2 if c[0] != STORM_LAYERS * c[1]
              or c[2] != STORM_LAYERS * c[3] or not c[1] or not c[3]]
    cold_med, warm_med = float(np.median(cold_ttft)), float(np.median(
        warm_cost))
    log(f"KV transfer [paged, bf16, width {STORM_WIDTH}, {STORM_LAYERS} "
        f"layers, window {STORM_WINDOW}]: {KV_TRIALS} x {KV_PROMPT_LEN}-"
        f"token prompts, payload {len(payloads[0])} bytes; recompute TTFT "
        f"{cold_med * 1e3:.2f} ms ({[round(t * 1e3, 2) for t in cold_ttft]})"
        f" against import + warm TTFT {warm_med * 1e3:.2f} ms "
        f"({[round(t * 1e3, 2) for t in warm_cost]}): "
        f"{cold_med / warm_med:.2f}x (a report; JAX gates > 1x); tokens "
        f"spliced {reused}; warm ids against the donor's "
        f"{[round(a, 3) for a in agree]}; unpack + pack gives the same "
        f"bytes {repack}; K2 (chunk launches, warm chunks, t = 1 launches,"
        f" decode steps) a warm admission {k2} [{card}]")
    if (min(reused) < KV_PROMPT_LEN - 1 or k2_bad or not all(repack)):
        raise SystemExit(
            f"chip_smoke: KV transfer failed: spliced {reused}, K2 {k2_bad},"
            f" repack {repack}")
    kv_capture_watch(card, net, prompts, payloads)
    del cold, warm, net
    torch.cuda.empty_cache()
    net32 = _storm_net("float32")
    refs32, payloads32 = _donor_payloads(net32, prompts)
    ids, errs = _warm_receiver_ids(net32, prompts, payloads32, payloads32)
    caught = {}
    for name in KV_FAULTS:
        bad = [_kv_fault(payloads32[0], name)]
        f_ids, f_errs = _warm_receiver_ids(net32, prompts[:1], bad,
                                           payloads32[:1])
        caught[name] = (f_ids[0] != refs32[0], f_errs[0] > 0)
    log(f"KV transfer [paged, f32]: receiver ids identical to the donor's "
        f"{ids == refs32}, imported K/V max error {max(errs)}; planted "
        f"payload faults caught (ids differ, K/V differ): {caught} [{card}]")
    if ids != refs32 or max(errs) != 0.0 or not all(any(c) for c in
                                                  caught.values()):
        raise SystemExit(
            f"chip_smoke: KV transfer f32 failed: ids identical "
            f"{ids == refs32}, K/V errors {errs}, faults caught {caught}")
    del net32
    torch.cuda.empty_cache()


def tier_prompts() -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(0, VOCAB, KV_PROMPT_LEN).tolist()
            for _ in range(TIER_PROMPTS)]


def _tier_pass(eng, prompts) -> list:
    return [_run_one(eng, p, TIER_GEN).tokens for p in prompts]


class _SpillClock:
    """Host time of an engine's spill path a round: the staging
    (``_stage_spill``: the gather and the pinned copies enqueued), the
    wait for the staged copies' events at the drain, and the rest of
    the drain (``drain_spills``: packing and the tier's put), wrapped
    on the instance; ``rounds`` holds (staged, stage s, wait s, drain
    s less the wait) for each step() that staged a spill."""

    def __init__(self, eng):
        self.eng, self.rounds = eng, []
        self._stage, self._drain = eng._stage_spill, eng.drain_spills
        self._cur = [0, 0.0, 0.0, 0.0]
        eng.prefix_cache.on_evict = self.stage
        eng.drain_spills = self.drain
        step = eng.step

        def timed_step(results=None):
            self._cur = [0, 0.0, 0.0, 0.0]
            out = step(results)
            if self._cur[0]:
                self.rounds.append(tuple(self._cur))
            return out

        eng.step = timed_step

    def stage(self, tokens, tab):
        t0 = time.perf_counter()
        self._stage(tokens, tab)
        self._cur[0] += 1
        self._cur[1] += time.perf_counter() - t0

    def drain(self):
        t0 = time.perf_counter()
        for staged in self.eng._pending_spills:
            if staged[-1] is not None:
                staged[-1].synchronize()
        t1 = time.perf_counter()
        n = self._drain()
        self._cur[2] += t1 - t0
        self._cur[3] += time.perf_counter() - t1
        return n


def kv_tier_phase(card: str) -> None:
    """17d. bf16: the untiered and the tiered engine, TIER_SETUP passes
    over the prompts each (cold, then the revisit path's first run),
    then TIER_TIMED timed passes each. Report: tokens/s of both and
    their ratio (JAX gates 2x; here a report), the host time a round
    with a staged spill spends staging and draining. Gates: every timed
    tiered admission reloaded from the host tier, the tier's books
    reconcile, no graph captured across the timed passes. f32: two
    passes on each engine, ids identical and every revisit reloaded.
    A disk-ring engine (host budget 0): one prompt, its entry spilled
    to the ring and reloaded with the same ids."""
    import tempfile

    from deeplearning4j_tpu_torch.serving import DecodeEngine

    prompts = tier_prompts()
    net = _storm_net("bfloat16", TIER_WINDOW)
    walls, ids, out = {}, {}, {}
    for tiered in (False, True):
        eng = DecodeEngine(net, kv_host_tier_bytes=TIER_HOST_BYTES
                           if tiered else 0, **TIER_ENGINE)
        for _ in range(TIER_SETUP):
            _tier_pass(eng, prompts)
        counts0 = eng.compile_counts()
        reloads0 = eng.stats["kv_tier_reloads"]
        spill = _SpillClock(eng) if tiered else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids[tiered] = [t for _ in range(TIER_TIMED)
                       for t in _tier_pass(eng, prompts)]
        torch.cuda.synchronize()
        walls[tiered] = time.perf_counter() - t0
        out[tiered] = (eng.compile_counts() == counts0,
                       eng.stats["kv_tier_reloads"] - reloads0)
        if tiered:
            tier, books = eng.kv_tier.stats, len(eng.kv_tier)
            reconciled = tier["spills"] == (tier["reloads"] + tier["drops"]
                                            + books)
        del eng
    toks = sum(len(t) for t in ids[True])
    rate = {k: toks / w for k, w in walls.items()}
    stage_ms = [r[1] * 1e3 for r in spill.rounds]
    wait_ms = [r[2] * 1e3 for r in spill.rounds]
    drain_ms = [r[3] * 1e3 for r in spill.rounds]
    agree = float(np.mean([request_agreement(a, b)
                           for a, b in zip(ids[True], ids[False])]))
    want = TIER_TIMED * TIER_PROMPTS
    log(f"KV tiers [paged, bf16, window {TIER_WINDOW}, {TIER_PROMPTS} x "
        f"{KV_PROMPT_LEN}-token prompts over {TIER_BLOCKS} blocks]: tiered "
        f"{rate[True]:.1f} tokens/s against untiered {rate[False]:.1f} "
        f"over {TIER_TIMED} passes: {rate[True] / rate[False]:.2f}x (a "
        f"report; JAX gates 2x); timed reloads {out[True][1]} (want "
        f"{want}); tier books {tier}, {books} resident, reconciled "
        f"{reconciled}; graphs unchanged {out[True][0]} / {out[False][0]}; "
        f"host time a round with a staged spill ({len(spill.rounds)} "
        f"rounds, {sum(r[0] for r in spill.rounds)} spills): staging p50 "
        f"{np.median(stage_ms):.3f} ms, waiting for the staged host "
        f"copies p50 {np.median(wait_ms):.3f} ms (max {max(wait_ms):.3f}),"
        f" packing and putting p50 {np.median(drain_ms):.3f} ms (max "
        f"{max(drain_ms):.3f}); ids "
        f"tiered against untiered {agree:.3f} [{card}]")
    if (out[True][1] != want or not reconciled or not out[True][0]
            or not out[False][0]):
        raise SystemExit(
            f"chip_smoke: KV tiers failed: reloads {out[True][1]} (want "
            f"{want}), reconciled {reconciled}, graphs unchanged "
            f"{out[True][0]} / {out[False][0]}")
    del net
    torch.cuda.empty_cache()
    net32 = _storm_net("float32", TIER_WINDOW)
    off = DecodeEngine(net32, **TIER_ENGINE)
    on = DecodeEngine(net32, kv_host_tier_bytes=TIER_HOST_BYTES,
                      **TIER_ENGINE)
    ids32 = {k: _tier_pass(e, prompts) + _tier_pass(e, prompts)
             for k, e in (("off", off), ("on", on))}
    reloads32 = on.stats["kv_tier_reloads"]
    with tempfile.TemporaryDirectory() as ring:
        disk = DecodeEngine(net32, kv_disk_tier_path=ring, **TIER_ENGINE)
        first = _run_one(disk, prompts[0], TIER_GEN).tokens
        while disk.prefix_cache.evict_one():
            pass
        disk.drain_spills()
        files = len(os.listdir(ring))
        again = _run_one(disk, prompts[0], TIER_GEN).tokens
        disk_hits = disk.kv_tier.stats["hits_disk"]
        disk_reloads = disk.kv_tier.stats["reloads"]
    log(f"KV tiers [paged, f32]: two passes, ids tiered against untiered "
        f"identical {ids32['on'] == ids32['off']}, reloads {reloads32} "
        f"(want {TIER_PROMPTS}); disk ring: {files} file spilled, "
        f"{disk_hits} disk hit, {disk_reloads} reload, ids identical "
        f"{again == first} [{card}]")
    if (ids32["on"] != ids32["off"] or reloads32 != TIER_PROMPTS
            or files != 1 or disk_hits != 1 or disk_reloads != 1
            or again != first):
        raise SystemExit(
            f"chip_smoke: KV tiers f32 failed: ids identical "
            f"{ids32['on'] == ids32['off']}, reloads {reloads32}, disk "
            f"files {files}, hits {disk_hits}, reloads {disk_reloads}, "
            f"ids {again == first}")
    del off, on, disk, net32
    torch.cuda.empty_cache()


def tenancy_kv_phase(card: str) -> None:
    """Phase 17: (a) and (b) tenancy, (c) KV transfer and the gateway's
    KV endpoints under a capture, (d) the KV tiers. K2's launches here
    are gated in each part and not added to the kernels line."""
    tenant_overhead_phase(card)
    tenant_preemption_phase(card)
    kv_transfer_phase(card)
    kv_tier_phase(card)


# Phase 18: the serving fleet. Every replica is its own process on the
# card: the port's ``serve`` subcommand over a zip the port's
# write_model wrote from the serving net (f32, and f32 with two
# output classes swapped), paged (bt 16), 8 slots, chunk FLEET_CHUNK,
# prefix_cache_rows 4, prefill_chunk 64, K2 forced on. The router and
# the fleet controller run in this process, the clients in a child
# process of their own (phase 16's). (a) 8 greedy f32 SSE streams of
# 96 tokens (prompts of 40-200 tokens) over 2 replicas; once every
# stream has 16 tokens the replica owning the most is SIGKILLed: every
# stream ends ``length`` with the in-process kernel engine's ids and
# exact SSE event ids, replays >= the victim's open streams, none
# diverged. (b) a 512-token prompt generated on its affinity owner,
# the router's warm-import hook forced against the other replica: one
# transfer, the receiver's ids identical with >= 511 prompt tokens
# reused, a second forced call transfers nothing; warm against cold
# TTFT on the receiver as a report. (c) FleetController.rolling_upgrade
# under 8 greedy f32 streams of FLEET_UPGRADE_GEN tokens: nothing
# dropped or delivered twice, ids identical, fleet.scale spans in
# /v1/trace, the old replicas reaped. The planted fault: the streams
# whose first 16 reference tokens hold one of the two swapped classes,
# on one true replica; the swapped replica joins and the true one is
# SIGKILLed: every replayed stream ends ``fault`` through the replay's
# divergence check with only reference tokens delivered.
FLEET_PROMPTS, FLEET_GEN, FLEET_KILL_AT = 8, 96, 16
FLEET_PROMPT_LENS = (40, 200)
FLEET_CHUNK, FLEET_PREFILL, FLEET_PREFIX_ROWS = 4, 64, 4
FLEET_KV_LEN, FLEET_KV_GEN = 512, 16
FLEET_UPGRADE_GEN, FLEET_UPGRADE_AT = 1024, 8
#: live affinity prompts the upgrade ships to each newcomer: its warm
#: step (export + import of each prompt's f32 KV) took 3.1-4.6 s at the
#: default 8, longer than some streams it should find in flight
FLEET_WARM_PROMPTS = 2
FLEET_BOOT_S, FLEET_DRAIN_S = 300.0, 0.1
#: the fleet's children: (replica id, zip); the upgrade's new
#: generation is booted with the rest, under the ids the controller
#: mints (``id_prefix`` "gen2")
FLEET_CHILDREN = (("a32", "f32"), ("b32", "f32"), ("f32", "f32"),
                  ("gen2-0", "f32"), ("gen2-1", "f32"),
                  ("swapped", "swapped"))


def fleet_prompts(seed: int, n=None, lens=None) -> list:
    rng = np.random.default_rng(1800 + seed)
    lo, hi = lens or FLEET_PROMPT_LENS
    return [rng.integers(0, VOCAB, int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n or FLEET_PROMPTS)]


def _fleet_flash() -> str:
    """The children's ``--use-flash-paged``: the kernel forced on the
    card; "auto" (the plain version) on a CPU rehearsal."""
    return "on" if DEVICE == "cuda" else "auto"


def _fleet_engine(net):
    """An in-process engine with a fleet child's ``serve`` flags."""
    from deeplearning4j_tpu_torch.serving import DecodeEngine

    return DecodeEngine(net, n_slots=N_SLOTS, decode_chunk=FLEET_CHUNK,
                        paged_kv=True, block_tokens=BLOCK_TOKENS,
                        prefix_cache_rows=FLEET_PREFIX_ROWS,
                        prefill_chunk=FLEET_PREFILL,
                        use_flash_paged=True if DEVICE == "cuda" else None)


def _fleet_ref(net, prompts, n_gen) -> list:
    res, _ = serve_ids(_fleet_engine(net), prompts, n_gen)
    return [list(r.tokens) for r in res]


def swap_head_classes(net, a: int, b: int) -> None:
    """Exchange two classes of the net's output layer in place: the
    columns of its ``W`` ([n_in, n_out]) and the entries of its ``b``.
    Greedy ids are unchanged until the first position whose argmax is
    one of the two, and differ there."""
    head = net.params[str(len(net.params) - 1)]
    with torch.no_grad():
        for name in ("W", "b"):
            p = head[name]
            idx = torch.arange(p.shape[-1], device=p.device)
            idx[a], idx[b] = b, a
            p.copy_(p.index_select(p.dim() - 1, idx))
    net.params_version += 1


def swap_pair(ref_ids, at: int) -> tuple:
    """The two classes whose swap changes the most reference streams
    within their first ``at`` tokens, and the indices of those
    streams."""
    heads = [set(r[:at]) for r in ref_ids]
    classes = sorted(set().union(*heads))
    best = max(((a, b) for i, a in enumerate(classes)
                for b in classes[i + 1:]) if len(classes) > 1
               else [(classes[0], (classes[0] + 1) % VOCAB)],
               key=lambda ab: sum(bool(h & set(ab)) for h in heads))
    return best, [i for i, h in enumerate(heads) if h & set(best)]


class _FleetChild:
    """One ``serve`` child: its ``ReplicaProcess`` (stderr to a log
    file), its boot seconds and the build seconds it reported."""

    def __init__(self, replica_id: str, zip_path: str, logdir: str):
        from deeplearning4j_tpu_torch.serving.replica_proc import (
            ReplicaProcess,
            free_port,
        )

        port = free_port()
        self.log = os.path.join(logdir, f"{replica_id}.log")
        serve = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli",
                 "serve", "--model", zip_path, "--device", DEVICE,
                 "--host", "127.0.0.1", "--port", str(port),
                 "--replica-id", replica_id, "--slots", str(N_SLOTS),
                 "--decode-chunk", str(FLEET_CHUNK), "--paged-kv",
                 "--block-tokens", str(BLOCK_TOKENS),
                 "--prefix-cache-rows", str(FLEET_PREFIX_ROWS),
                 "--prefill-chunk", str(FLEET_PREFILL),
                 "--use-flash-paged", _fleet_flash()]
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [HERE] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        # exec: the process the handle signals is the interpreter
        self.t0 = time.perf_counter()
        self.proc = ReplicaProcess(
            ["bash", "-c", 'exec "$@" 2>>"$0"', self.log] + serve,
            replica_id=replica_id, port=port, ready_pattern="serving on",
            env=env, cwd=HERE)
        self.replica_id, self.address = replica_id, self.proc.address
        self.boot_s = self.build_s = self.rounds = None

    def wait_ready(self) -> None:
        try:
            self.proc.wait_ready(timeout_s=FLEET_BOOT_S)
        except RuntimeError as e:
            raise SystemExit(f"chip_smoke: fleet child {self.replica_id} "
                             f"did not boot ({e}); stderr:\n"
                             f"{self.stderr_tail()}")
        self.boot_s = time.perf_counter() - self.t0
        built = [ln for ln in self.proc.boot_lines
                 if ln.startswith("built paged_attention in ")]
        if not built and DEVICE == "cuda":
            raise SystemExit(f"chip_smoke: fleet child {self.replica_id} "
                             f"reported no K2 build: "
                             f"{self.proc.boot_lines}")
        self.build_s = (float(built[0].split()[-2]) if built else None)

    def stderr_tail(self, n: int = 4000) -> str:
        try:
            with open(self.log) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def scrape_rounds(self):
        """Decode rounds the child's engine dispatched, from its
        ``/v1/metrics`` (the ``serving_round_s`` count); kept as the
        last reading, None once it cannot answer."""
        from deeplearning4j_tpu_torch.profiler.tracer import (
            parse_exposition,
        )
        from deeplearning4j_tpu_torch.serving import GatewayClient

        with contextlib.suppress(Exception):
            text = GatewayClient(self.address, timeout_s=10.0).metrics()
            h = parse_exposition(text)["histograms"].get("serving_round_s")
            self.rounds = int(h["count"]) if h else 0
        return self.rounds

    @property
    def alive(self) -> bool:
        return self.proc.alive

    def sigkill(self) -> None:
        self.scrape_rounds()
        self.proc.sigkill()

    def shutdown(self) -> None:
        if self.alive:
            self.scrape_rounds()
        self.proc.shutdown()


def _fleet_router(children, **kw):
    """A started router over ``children``, once every one is live under
    its own id and speaks the KV transfer plane."""
    from deeplearning4j_tpu_torch.serving import ServingRouter

    router = ServingRouter([c.address for c in children],
                           affinity_block_tokens=BLOCK_TOKENS,
                           health_interval_s=0.05, failure_threshold=2,
                           replica_timeout_s=600.0, **kw).start()
    want = {c.replica_id for c in children}
    _fleet_wait(lambda: {r["replica_id"] for r in router.replica_status()
                         if r["state"] == "live" and r["kv_capable"]}
                >= want, "the router to see every replica live")
    return router


def _fleet_wait(cond, what: str, timeout: float = 120.0) -> None:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"chip_smoke: timed out waiting for {what}")
        time.sleep(0.002)


def _open_rids(router, n_gen) -> dict:
    """Router request id -> replica address of every stream still short
    of its ``n_gen`` tokens (one whose last tokens are already on their
    way cannot be caught by a kill)."""
    with router._lock:
        return {e.rid: e.replica_address for e in router._journal.values()
                if not e.done.is_set() and e.replica_address
                and len(e.tokens) < n_gen}


def _fleet_streams(clients, router, prompts, n_gen, at, action) -> dict:
    """Run the clients' SSE round through the router in a thread; once
    every stream is journaled with ``at`` tokens (or done), call
    ``action()`` and let the round finish. Returns the round's output
    with ``acted`` (what ``action`` returned)."""
    box = {}

    def run():
        try:
            box["out"] = clients.round(router.address, prompts, n_gen,
                                       router=True)
        except BaseException as e:     # named below, in this thread
            box["error"] = e

    t = threading.Thread(target=run, name="chip_smoke fleet clients")
    t.start()

    def ready():
        if not t.is_alive():
            return True
        with router._lock:
            entries = list(router._journal.values())
        return len(entries) >= len(prompts) and all(
            len(e.tokens) >= at or e.done.is_set() for e in entries)

    _fleet_wait(ready, f"every stream to pass {at} tokens", 600.0)
    acted = action() if t.is_alive() else None
    t.join(timeout=900)
    if "error" in box or t.is_alive():
        raise SystemExit(f"chip_smoke: fleet clients failed: "
                         f"{box.get('error', 'still running')}")
    out = box["out"]
    out["acted"] = acted
    return out


def _events_exact(toks, events) -> bool:
    ids = [eid for eid, _ in events or []]
    return (bool(ids) and all(eid == n for eid, n in events)
            and ids == sorted(set(ids)) and ids[-1] == len(toks))


def _diverged_rids(router) -> list:
    with router._lock:
        return sorted(e.rid for e in router._journal.values()
                      if any(h[1] == "replay_diverged" for h in e.history))


def _replay_gaps_ms(router) -> list:
    """Each replay's gap (the stream's break to its first fresh token
    after the replay), in ms, from the router's ``router.replay``
    spans (its histogram holds them only at bucket resolution)."""
    return sorted(e["dur"] / 1e3 for e in router.tracer.events()
                  if e.get("name") == "router.replay")


def _gaps_text(router) -> str:
    gaps = _replay_gaps_ms(router)
    if not gaps:
        return "none"
    return (f"p50 {gaps[len(gaps) // 2]:.3f} ms, max {gaps[-1]:.3f} ms "
            f"over {len(gaps)}")


def _kill_top_owner(router, children, n_gen) -> tuple:
    """SIGKILL the child owning the most open streams: (child, its open
    streams then)."""
    addr, n_open = collections.Counter(
        _open_rids(router, n_gen).values()).most_common(1)[0]
    victim = next(c for c in children if c.address == addr)
    victim.sigkill()
    return victim, n_open


def fleet_replay_check(card: str, clients, children, prompts, ref,
                       label: str) -> object:
    """(a): stream, kill the top owner, check. Returns the survivor."""
    router = _fleet_router(children)
    try:
        out = _fleet_streams(
            clients, router, prompts, FLEET_GEN, FLEET_KILL_AT,
            lambda: _kill_top_owner(router, children, FLEET_GEN))
        victim, n_open = out["acted"] or (None, 0)
        audit = router.journal_audit()
        diverged = _diverged_rids(router)
        reasons = collections.Counter(r["finish_reason"]
                                      for r in out["results"])
        same = sum(o == w for o, w in zip(out["outs"], ref))
        exact = sum(_events_exact(o, e)
                    for o, e in zip(out["outs"], out["events"]))
        log(f"fleet {label}: killed {getattr(victim, 'replica_id', None)}"
            f" with {n_open} open streams; replays "
            f"{router.stats['replays']}, diverged {len(diverged)}, "
            f"finish {dict(reasons)}, ids identical {same}/"
            f"{len(prompts)}, exact event ids {exact}/{len(prompts)}, "
            f"lost {audit['lost']}, open {audit['open']}; replay gap "
            f"{_gaps_text(router)} ({card})")
        if (victim is None or n_open < 1
                or reasons != {"length": len(prompts)}
                or same != len(prompts) or exact != len(prompts)
                or router.stats["replays"] < n_open or diverged
                or audit["lost"] or audit["open"]):
            raise SystemExit(f"chip_smoke: fleet replay {label} "
                             "failed (see the line above)")
        return next(c for c in children if c is not victim)
    finally:
        router.close()


def fleet_planted_check(card: str, clients, owner, swapped, prompts,
                        ref) -> None:
    """The planted fault: streams on one true replica, the swapped
    replica joins, the true one dies; every stream open at the kill
    must end ``fault`` through the divergence check with only
    reference tokens delivered (and any that finished first must have
    the reference ids)."""
    router = _fleet_router([owner])

    def join_and_kill():
        router.add_replica(swapped.address, replica_id=swapped.replica_id)
        _fleet_wait(lambda: any(
            r["replica_id"] == swapped.replica_id and r["state"] == "live"
            for r in router.replica_status()), "the swapped replica")
        open_rids = set(_open_rids(router, FLEET_UPGRADE_GEN))
        owner.sigkill()
        return open_rids

    try:
        out = _fleet_streams(clients, router, prompts, FLEET_UPGRADE_GEN,
                             FLEET_KILL_AT, join_and_kill)
        open_rids = out["acted"] or set()
        diverged = set(_diverged_rids(router))
        caught, wrong = [], []
        for i, (o, r) in enumerate(zip(out["outs"], out["results"])):
            if o != ref[i][:len(o)]:
                wrong.append(i)       # a token the true model never made
            if r["id"] in open_rids:
                caught.append(r["finish_reason"] == "fault"
                              and r["id"] in diverged)
            elif r["finish_reason"] != "length" or o != ref[i]:
                wrong.append(i)
        log(f"fleet planted (two output classes swapped on the "
            f"survivor): {len(open_rids)} of {len(prompts)} streams open "
            f"at the kill, {sum(caught)} ended fault through the "
            f"divergence check, wrong tokens delivered on {wrong} "
            f"({card})")
        if not caught or not all(caught) or wrong:
            raise SystemExit("chip_smoke: fleet planted fault was not "
                             "caught (see the line above)")
    finally:
        router.close()


def fleet_kv_check(card: str, pair, prompt, cold_prompt, ref) -> None:
    """(b): the router's warm-import hook forced against the cold
    replica after the prompt ran on its affinity owner."""
    from deeplearning4j_tpu_torch.serving import GatewayClient, RouterClient

    router = _fleet_router(pair)
    try:
        # a first request on each replica, so neither TTFT below pays
        # a first round's capture
        for c in pair:
            GatewayClient(c.address, timeout_s=600.0).generate(
                cold_prompt[:FLEET_PREFILL // 2], 2)
        out = RouterClient(router.address, timeout_s=600.0).generate(
            prompt, FLEET_KV_GEN)
        owner = router._journal[out["id"]].replica_address
        other = next(r for r in router._replicas if r.address != owner)
        before = router.stats["kv_transfers"]
        entry = router._journal_entry(list(prompt),
                                      {"max_new_tokens": FLEET_KV_GEN})
        router._maybe_kv_transfer(entry, other)
        moved = router.stats["kv_transfers"] - before
        receiver = GatewayClient(other.address, timeout_s=600.0)
        warm = receiver.generate(prompt, FLEET_KV_GEN)
        entry2 = router._journal_entry(list(prompt),
                                       {"max_new_tokens": FLEET_KV_GEN})
        router._maybe_kv_transfer(entry2, other)
        again = router.stats["kv_transfers"] - before - moved
        cold = receiver.generate(cold_prompt, FLEET_KV_GEN)
        log(f"fleet KV: owner ids identical {out['tokens'] == ref}, "
            f"transfers {moved} then {again}, "
            f"{router.stats['kv_transferred_tokens']} tokens shipped; "
            f"receiver ids identical {warm['tokens'] == ref}, reused "
            f"{warm['prefix_tokens_reused']}/{len(prompt)}; receiver "
            f"TTFT warm {warm['ttft_s'] * 1e3:.2f} ms, cold recompute "
            f"{cold['ttft_s'] * 1e3:.2f} ms ({card})")
        if (out["tokens"] != ref or moved != 1 or again != 0
                or warm["tokens"] != ref
                or warm["prefix_tokens_reused"] < len(prompt) - 1):
            raise SystemExit("chip_smoke: fleet warm import failed "
                             "(see the line above)")
    finally:
        router.close()


def fleet_warm_kv_paths(children) -> None:
    """A first request, a KV export and a KV import on each child (the
    export of each child's prompt goes into the next child), so that
    the upgrade's warm step pays no first use: on the card a child's
    first export took 0.4-1.4 s and its first import 1.7 s, against
    streams that last about 4 s."""
    from deeplearning4j_tpu_torch.serving import GatewayClient

    t0 = time.perf_counter()
    prompts = fleet_prompts(2, n=len(children), lens=(128, 160))
    gws = [GatewayClient(c.address, timeout_s=600.0) for c in children]
    errors = []

    def first(gw, p):
        try:
            gw.generate(p, 2)
        except Exception as e:          # named below, in this thread
            errors.append(e)

    firsts = [threading.Thread(target=first, args=(gw, p))
              for gw, p in zip(gws, prompts)]
    for w in firsts:
        w.start()
    for w in firsts:
        w.join()
    imported = []
    for i, (gw, p) in enumerate(zip(gws, prompts)):
        payload = gw.kv_export(p)
        out = (gws[(i + 1) % len(gws)].kv_import(payload)
               if payload is not None else {})
        imported.append(bool(out.get("imported")))
    log(f"fleet upgrade warm-up: a first request, a KV export and a KV "
        f"import on each of {len(children)} children in "
        f"{time.perf_counter() - t0:.2f} s; imported {imported}")
    if errors or not all(imported):
        raise SystemExit(f"chip_smoke: fleet warm-up failed: {errors}")


def fleet_upgrade_check(card: str, clients, seeds, new_gen, prompts,
                        ref) -> None:
    """(c): a rolling upgrade of ``seeds`` to ``new_gen`` (the factory
    hands out the children booted under the controller's ids) while
    greedy streams run. Every child's KV paths are warmed first
    (``fleet_warm_kv_paths``): the drains must find streams in flight,
    and a cold newcomer's warm step took 2.7-4.6 s of the streams'
    4 s."""
    from deeplearning4j_tpu_torch.serving import (
        FleetController,
        RouterClient,
    )

    fleet_warm_kv_paths(list(seeds) + list(new_gen))
    pool = {c.replica_id: c for c in new_gen}
    router = _fleet_router(seeds)
    ctl = FleetController(router, replica_factory=pool.pop,
                          min_replicas=1, max_replicas=4, cooldown_s=0.0,
                          drain_timeout_s=FLEET_DRAIN_S, id_prefix="gen2",
                          warm_prompts_cap=FLEET_WARM_PROMPTS)
    for c in seeds:
        ctl.adopt(c)
    try:
        t0 = time.perf_counter()
        out = _fleet_streams(clients, router, prompts, FLEET_UPGRADE_GEN,
                             FLEET_UPGRADE_AT, ctl.rolling_upgrade)
        summary = out["acted"] or {"upgraded": 0, "steps": []}
        audit = router.journal_audit()
        handed = sum(s.get("handed_off") or 0 for s in summary["steps"])
        same = sum(o == w for o, w in zip(out["outs"], ref))
        exact = sum(_events_exact(o, e)
                    for o, e in zip(out["outs"], out["events"]))
        reasons = collections.Counter(r["finish_reason"]
                                      for r in out["results"])
        spans = [e["args"].get("action") for e in RouterClient(
            router.address).trace_events()["traceEvents"]
            if e.get("name") == "fleet.scale"]
        reaped = [c.replica_id for c in seeds if not c.alive]
        log(f"fleet upgrade: {summary['upgraded']} replaced in "
            f"{time.perf_counter() - t0:.2f} s of streaming (steps "
            f"{[s.get('dur_s') for s in summary['steps']]} s, warmed "
            f"{[s.get('warmed') for s in summary['steps']]}), "
            f"{handed} streams handed off, finish {dict(reasons)}, ids "
            f"identical {same}/{len(prompts)}, exact event ids "
            f"{exact}/{len(prompts)}, lost {audit['lost']}, open "
            f"{audit['open']}, fleet.scale spans {spans}, reaped "
            f"{reaped} ({card})")
        if (summary["upgraded"] != len(seeds) or handed < 1
                or reasons != {"length": len(prompts)}
                or same != len(prompts) or exact != len(prompts)
                or audit["lost"] or audit["open"]
                or spans.count("upgrade") != len(seeds)
                or len(reaped) != len(seeds)):
            raise SystemExit("chip_smoke: fleet rolling upgrade failed "
                             "(see the line above)")
    finally:
        ctl.close()
        router.close()


def fleet_phase(card: str) -> None:
    """Phase 18: the fleet of ``serve`` children on the card. Every
    child is reaped on every way out. K2's launches there are the
    children's, printed as derived counts; the kernels line keeps this
    process's own."""
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch.serving.replica_proc import shutdown_all
    from deeplearning4j_tpu_torch.util.model_serializer import (
        snapshot,
        write_snapshot,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    children = []
    try:
        nets = {"f32": _serving_net("float32")}
        zips = {k: os.path.join(tmp, f"{k}.zip")
                for k in ("f32", "swapped")}
        prompts = fleet_prompts(0)
        up_prompts = fleet_prompts(1)
        kv_prompt, kv_cold = serving_prompts(18, 2, FLEET_KV_LEN)
        t0 = time.perf_counter()
        # the planted run streams the long continuation of (a)'s
        # prompts; its first FLEET_GEN ids are (a)'s reference
        ref_long = _fleet_ref(nets["f32"], prompts, FLEET_UPGRADE_GEN)
        ref32 = [r[:FLEET_GEN] for r in ref_long]
        (sa, sb), covered = swap_pair(ref32, FLEET_KILL_AT)
        net_w = _serving_net("float32")
        swap_head_classes(net_w, sa, sb)
        # the params come to the host on this thread: the references
        # below capture graphs, and a capture fails when another thread
        # issues CUDA work; the threads only deflate and write
        writers = [threading.Thread(target=write_snapshot,
                                    args=(snapshot(net), zips[k]))
                   for k, net in (("f32", nets["f32"]),
                                  ("swapped", net_w))]
        for w in writers:
            w.start()
        ref_up = _fleet_ref(nets["f32"], up_prompts, FLEET_UPGRADE_GEN)
        ref_kv = _fleet_ref(nets["f32"], [kv_prompt], FLEET_KV_GEN)[0]
        log(f"fleet references: {time.perf_counter() - t0:.1f} s; planted "
            f"swap of classes {sa} and {sb} covers streams {covered}")
        for w in writers:
            w.join()
        del net_w
        torch.cuda.empty_cache()
        log(f"fleet zips written: {time.perf_counter() - t_phase:.1f} s")
        t0 = time.perf_counter()
        children = [_FleetChild(rid, zips[z], tmp)
                    for rid, z in FLEET_CHILDREN]
        errors = []

        def boot(c):
            try:
                c.wait_ready()
            except SystemExit as e:
                log(str(e))
                errors.append(c.replica_id)

        waits = [threading.Thread(target=boot, args=(c,))
                 for c in children]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
        if errors:
            raise SystemExit(f"chip_smoke: fleet children failed to boot: "
                             f"{errors}")
        log(f"fleet boot: {len(children)} children in "
            f"{time.perf_counter() - t0:.1f} s; boot s "
            + ", ".join(f"{c.replica_id} {c.boot_s:.1f}" for c in children)
            + "; K2 build s "
            + ", ".join(f"{c.replica_id} {c.build_s}" for c in children))
        by = {c.replica_id: c for c in children}
        with _Clients() as clients:
            survivor = fleet_replay_check(
                card, clients, [by["a32"], by["b32"]], prompts, ref32,
                "f32")
            fleet_kv_check(card, [survivor, by["f32"]], kv_prompt,
                           kv_cold, ref_kv)
            fleet_upgrade_check(card, clients, [survivor, by["f32"]],
                                [by["gen2-0"], by["gen2-1"]], up_prompts,
                                ref_up)
            fleet_planted_check(card, clients, by["gen2-0"],
                                by["swapped"],
                                [prompts[i] for i in covered],
                                [ref_long[i] for i in covered])
        for c in children:
            if c.alive:
                c.scrape_rounds()
        total = 0
        for c in children:
            steps = None if c.rounds is None else c.rounds * FLEET_CHUNK
            total += N_LAYERS * (steps or 0)
            log(f"fleet child {c.replica_id}: decode rounds {c.rounds}, "
                f"steps {steps}, derived K2 t=1 launches "
                f"{None if steps is None else N_LAYERS * steps}")
        log(f"fleet: derived K2 t=1 launches in the children {total} "
            f"(N_LAYERS x decode steps; graph captures not counted)")
    finally:
        shutdown_all(children)
        leaked = [c.replica_id for c in children if c.alive]
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
        log(f"phase 18 wall: {time.perf_counter() - t_phase:.1f} s; "
            f"children left running {leaked}")
    if leaked:
        raise SystemExit(f"chip_smoke: fleet children not reaped: {leaked}")



# LeNet: bench.py's mnist_lenet5_train_throughput row (lenet5(lr=0.002),
# bf16 compute, B=2048, 8 synthetic batches stacked into fit_scan
# windows of 64 steps, 1 + 6 set-up windows, the 0.97 gate on 4096
# synthetic test images); then 2 timed windows. The same run in f32:
# the zoo's default lenet5() (no compute dtype) at lr 0.01, where f32
# LeNet converges at B=2048 (BENCHMARKS.md, mixed precision).
LENET_B, LENET_WINDOW, LENET_SETUP, LENET_TIMED = 2048, 64, 7, 2
LENET_N_TRAIN, LENET_N_TEST, LENET_EVAL_BATCH = 8 * 2048, 4096, 1024
LENET_LR = {"bfloat16": 0.002, "float32": 0.01}
ACCURACY_GATE = 0.97
# card vs CPU: one set of params, 4 f32 fit steps at B=256, TF32 off;
# losses within ROADMAP's 5e-3 relative, params within max |diff|
# 1e-6 (2.98e-8 measured on an H100: summation order only)
LENET_PARITY_B, LENET_PARITY_STEPS = 256, 4
LENET_PARITY_RTOL = 5e-3
LENET_PARITY_PARAM_ATOL = 1e-6
# the unprofiled ms/step of the eager fit_scan loop before the train step
# was captured (this script, two runs on an H100 80GB HBM3 at 700 W, a
# step without the health scalars), printed beside this run's
LENET_EAGER_BEFORE_MS = {"bfloat16": "3.0863-3.1344",
                         "float32": "2.8778-3.1289"}


def _lenet(lr, compute_dtype=None, device=None):
    from deeplearning4j_tpu_torch.models.zoo import lenet5
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = lenet5(lr=lr)
    if compute_dtype is not None:
        for c in conf.confs:
            c.compute_dtype = compute_dtype
    return MultiLayerNetwork(conf, device=device or DEVICE).init()


def lenet_phase(card: str, k3_ms: float, dtype: str = "bfloat16") -> int:
    """Phases 10 and 11: train LeNet as bench.py does (bf16 compute) or as
    the zoo builds it (f32: no compute dtype), time 2 windows, gate the
    accuracy; every K3 launch of the training and evaluate path must go
    to the route of the dtype (bf16: the tensor-core kernel; f32: the
    CUDA-core kernel). ``k3_ms`` is that kernel's time at this shape
    (kernels phase). Returns its launches over the training steps."""
    from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )
    from deeplearning4j_tpu_torch.nn.layers.convolution import conv_taps

    lr = LENET_LR[dtype]
    net = _lenet(lr, dtype if dtype != "float32" else None)
    ds = mnist_dataset(train=True, num_examples=LENET_N_TRAIN)
    batches = ds.batch_by(LENET_B)
    reps = -(-LENET_WINDOW // len(batches))
    feats = np.stack([b.features for b in batches] * reps)[:LENET_WINDOW]
    labels = np.stack([b.labels for b in batches] * reps)[:LENET_WINDOW]
    feats = torch.as_tensor(feats.reshape(LENET_WINDOW, LENET_B, 1, 28, 28),
                            device=DEVICE)
    labels = torch.as_tensor(labels, device=DEVICE)
    torch.cuda.synchronize()
    # the first window captures the train step (its warm-up launches K3
    # once more, on copies): the count starts after it
    t0 = time.perf_counter()
    first = [float(x) for x in net.fit_scan(feats, labels)]
    capture_s = time.perf_counter() - t0
    conv_taps.launches = conv_taps.mma_launches = 0
    flash_attention.launches = flash_attention.bwd_launches = 0
    paged_attention.launches = 0
    t0 = time.perf_counter()
    for _ in range(LENET_SETUP - 1):
        net.fit_scan(feats, labels)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    twin = _lenet_twin(net, lr, dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(LENET_TIMED):
        t0 = time.perf_counter()
        last = net.fit_scan(feats, labels)
        last_loss = [float(x) for x in last]      # syncs the window
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    launches, mma_launches = conv_taps.launches, conv_taps.mma_launches
    steps = (LENET_SETUP - 1 + LENET_TIMED) * LENET_WINDOW
    others = (flash_attention.launches, flash_attention.bwd_launches,
              paged_attention.launches)
    step_s = float(np.mean(walls)) / LENET_WINDOW
    eager_walls = []
    for _ in range(LENET_TIMED):
        t0 = time.perf_counter()
        [float(x) for x in twin.fit_scan(feats, labels)]
        eager_walls.append(time.perf_counter() - t0)
    eager_step_s = float(np.mean(eager_walls)) / LENET_WINDOW
    same = lenet_identity_check(net, lr, dtype, feats, labels)
    runner = net.train_graphs
    log(f"LeNet [{dtype}]: fit_scan from its captured graph "
        f"{step_s * 1e3:.4f} ms/step, the eager loop from a copy of the "
        f"same params {eager_step_s * 1e3:.4f} ms/step "
        f"({eager_step_s / step_s:.3f}x; the eager loop before capture, "
        f"unprofiled: {LENET_EAGER_BEFORE_MS[dtype]}); under cuDNN's "
        f"deterministic mode, a "
        f"copy that captures its own graph and a copy that runs eagerly, "
        f"{LENET_TIMED} windows each: params and updater state "
        f"bit-identical {same}; {len(runner)} graph ({runner.captures} "
        f"capture; {_graph_memory(runner)}); the capture window "
        f"{capture_s:.3f} s [{card}]")
    if not same or len(runner) != 1 or runner.captures != 1:
        raise SystemExit(f"chip_smoke: LeNet {dtype}: the captured fit_scan "
                         f"differs from the eager loop ({same}) or holds "
                         f"{len(runner)} graphs ({runner.captures} captures)")
    del twin
    test = mnist_dataset(train=False, num_examples=LENET_N_TEST,
                         as_image=True)
    conv_taps.launches = conv_taps.mma_launches = 0
    accuracy = net.evaluate(test.batch_by(LENET_EVAL_BATCH)).accuracy()
    eval_launches, eval_mma = conv_taps.launches, conv_taps.mma_launches
    falling = np.mean(last_loss) < np.mean(first)
    mma = dtype == "bfloat16"
    route = "on the tensor cores" if mma else "on the CUDA cores"
    log(f"LeNet: lenet5(lr={lr}), {dtype}, B={LENET_B}; set-up "
        f"{LENET_SETUP} x {LENET_WINDOW} steps (the first captures; the "
        f"other {LENET_SETUP - 1} in {setup_s:.3f} s), first "
        f"window losses {first[0]:.6f} -> {first[-1]:.6f}, last timed "
        f"window {last_loss[0]:.6f} -> {last_loss[-1]:.6f}; timed windows "
        f"{[round(w, 4) for w in walls]} s: "
        f"{LENET_B / step_s:.1f} examples/s, {step_s * 1e3:.4f} ms/step; "
        f"peak memory {peak / 2**30:.3f} GiB; K3 launches {launches} over "
        f"{steps} steps ({mma_launches} on the tensor cores), "
        f"{eval_launches} over {LENET_N_TEST // LENET_EVAL_BATCH} evaluate "
        f"batches ({eval_mma} on the tensor cores); K3 {route} "
        f"{k3_ms:.4f} ms x 1 launch a step = {k3_ms / (step_s * 1e3):.1%} "
        f"of the step; synthetic test accuracy {accuracy:.4f} (gate "
        f"{ACCURACY_GATE}) [{card}]")
    if (launches != steps or mma_launches != (launches if mma else 0)
            or others != (0, 0, 0)
            or eval_mma != (eval_launches if mma else 0)
            or eval_launches != LENET_N_TEST // LENET_EVAL_BATCH
            or not np.all(np.isfinite(first + last_loss)) or not falling
            or accuracy < ACCURACY_GATE):
        raise SystemExit(
            f"chip_smoke: LeNet {dtype} phase failed: K3 launches "
            f"{launches} (want {steps}, tensor cores {mma_launches}), "
            f"evaluate {eval_launches} (tensor cores {eval_mma}), other "
            f"kernels {others}, "
            f"losses {first} ... {last_loss}, accuracy {accuracy}")
    del net, feats, labels
    torch.cuda.empty_cache()
    return launches


def _lenet_twin(net, lr, dtype, eager=True):
    """A LeNet from a copy of ``net``'s params, updater state and
    iteration; with ``eager`` its ``fit_scan`` runs eagerly
    (``train_graphs = None``, the private switch)."""
    from deeplearning4j_tpu_torch.nn.streaming import tree_map

    twin = _lenet(lr, dtype if dtype != "float32" else None)
    for key, p in net.param_table().items():
        twin.set_param(key, p)
    twin.updater_state = tree_map(torch.clone, net.updater_state)
    twin.iteration = net.iteration
    if eager:
        twin.train_graphs = None
    return twin


def lenet_identity_check(net, lr, dtype, feats, labels) -> bool:
    """Whether a copy of ``net`` that captures its own ``fit_scan`` graph
    and a copy that runs the step eagerly hold bit-identical params and
    updater state after LENET_TIMED windows, under cuDNN's deterministic
    mode. Without it f32 LeNet's conv2 weight gradient
    (``wgrad_alg0_engine``) sums with atomics: two eager runs from the
    same params differ (max |diff| 8.4e-6 after 2 windows on the H100),
    so no check could hold the graph to the eager loop bit for bit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        graph = _lenet_twin(net, lr, dtype, eager=False)
        eager = _lenet_twin(net, lr, dtype)
        for _ in range(LENET_TIMED):
            graph.fit_scan(feats, labels)
            eager.fit_scan(feats, labels)
        return _nets_equal(graph, eager) and len(graph.train_graphs) == 1
    finally:
        torch.backends.cudnn.deterministic = prev

def lenet_parity_phase(card: str) -> None:
    """Phase 12: one set of port params on the card and on the CPU, 4
    f32 fit steps each at B=256: the card runs K3 (the CUDA-core kernel,
    the f32 route, once a step) and cuDNN's conv2, the CPU the plain tap
    loop and its conv2."""
    from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset
    from deeplearning4j_tpu_torch.nn.layers.convolution import conv_taps

    card_net = _lenet(0.01)
    cpu_net = _lenet(0.01, device="cpu")
    for key, p in card_net.param_table().items():
        cpu_net.set_param(key, p.cpu())
    ds = mnist_dataset(train=True,
                       num_examples=LENET_PARITY_B * LENET_PARITY_STEPS,
                       as_image=True)
    batches = [(b.features, b.labels) for b in ds.batch_by(LENET_PARITY_B)]
    conv_taps.launches = conv_taps.mma_launches = 0
    card_loss, card_wall = _train(card_net, batches)
    launches, mma_launches = conv_taps.launches, conv_taps.mma_launches
    cpu_loss, _ = _train(cpu_net, batches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
    pdiff = max(float((p.cpu() - cpu_net.param_table()[k]).abs().max())
                for k, p in card_net.param_table().items())
    log(f"LeNet card vs CPU (f32, B={LENET_PARITY_B}): card losses "
        f"{[f'{x:.6f}' for x in card_loss]}, CPU "
        f"{[f'{x:.6f}' for x in cpu_loss]}; max rel diff {rel:.3e} (tol "
        f"{LENET_PARITY_RTOL}); max |param diff| {pdiff:.3e} (tol "
        f"{LENET_PARITY_PARAM_ATOL}); K3 launches {launches}; card s/step "
        f"{[round(w, 4) for w in card_wall]} [{card}]")
    if (not rel <= LENET_PARITY_RTOL or not pdiff <= LENET_PARITY_PARAM_ATOL
            or launches != LENET_PARITY_STEPS or mma_launches != 0
            or not np.all(np.isfinite(card_loss))):
        raise SystemExit(f"chip_smoke: LeNet card vs CPU failed: rel {rel},"
                         f" param diff {pdiff}, K3 launches {launches} "
                         f"({mma_launches} on the tensor cores)")


# phase 19: the rest of the layers. (a, b) The zoo's moe_transformer_lm
# at the flagship's width (4 blocks of causal attention, 8 heads, each
# followed by a residual MoeDense of 8 experts x 4096 hidden, capacity
# factor 1.25, top-1; ~285 M params): 4 fit steps on K1 and on dense
# attention at B=2, T=2048 (f32 and bf16), fit_scan graph against eager,
# then served at phase 6's knobs. (c) DL4J's
# GravesLSTMCharModellingExample shape under truncated BPTT. (d)
# bench.py's DBN row.
MOE_WIDTH, MOE_BLOCKS, MOE_HEADS, MOE_EXPERTS = 1024, 4, 8, 8
MOE_HIDDEN, MOE_CF, MOE_TOP_K = 0, 1.25, 1
MOE_T, MOE_STEPS = 2048, 4
# the f32 serving gate of the MoE LM compares two runs forward by
# forward (``trace_divergence``). At the first forward where they differ,
# the divergence is a near tie when (1) every expert flipped in the
# first MoE layer that flips any has a router top-1/top-2 probability
# gap below MOE_GAP_LIMIT, and (2) in the sequences no flip touched, the
# output probabilities agree within MOE_OUT_TOL and every argmax that
# differs has an output top-1/top-2 gap below MOE_GAP_LIMIT. Runs that
# differ only in summation order move these probabilities by ~1e-8.
MOE_GAP_LIMIT, MOE_OUT_TOL = 1e-5, 1e-6
LSTM_HIDDEN, LSTM_BATCH, LSTM_T, LSTM_TBPTT = 200, 32, 1000, 50
LSTM_RTOL, LSTM_STREAM, LSTM_STREAM_ATOL = 5e-3, 64, 1e-4
DBN_N, DBN_BATCH, DBN_WARM, DBN_WINDOWS, DBN_EPOCHS = 8192, 1024, 2, 9, 3
DBN_FINETUNE, DBN_TEST_N = 40, 2048


def _moe_conf(compute_dtype, use_flash, window=None):
    from deeplearning4j_tpu_torch.models.zoo import moe_transformer_lm

    conf = moe_transformer_lm(
        n_in=TRAIN_VOCAB, width=MOE_WIDTH, n_blocks=MOE_BLOCKS,
        n_heads=MOE_HEADS, n_classes=TRAIN_VOCAB, n_experts=MOE_EXPERTS,
        n_hidden=MOE_HIDDEN, capacity_factor=MOE_CF, top_k=MOE_TOP_K,
        seed=11)
    for c in conf.confs:
        if compute_dtype != "float32":
            c.compute_dtype = compute_dtype
        if hasattr(c.layer, "use_flash"):
            c.layer.use_flash = use_flash
        if window is not None and hasattr(c.layer, "stream_max_t"):
            c.layer.stream_max_t = window
    return conf


def _moe_net(compute_dtype, use_flash, window=None, like=None):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    net = MultiLayerNetwork(_moe_conf(compute_dtype, use_flash, window),
                            device=DEVICE).init()
    if like is not None:
        for key, p in like.param_table().items():
            net.set_param(key, p)
    return net


def _moe_layers(net) -> list:
    from deeplearning4j_tpu_torch.nn.layers.moe import MoeDense

    return [str(i) for i, c in enumerate(net.conf.confs)
            if isinstance(c.layer, MoeDense)]


def moe_step_breakdown(card: str, cd: str, net, step_s: float) -> None:
    """Where a MoE train step's time goes: the parts of one MoeDense
    layer timed alone at the step's shapes (tokens [B*T, width], the
    layer's own params at the compute dtype) between CUDA events, each
    forward + backward, and K1 forward + backward at the attention's
    shape; each times the number of blocks over the step's seconds."""
    from deeplearning4j_tpu_torch.nn.layers.attention import flash_attention
    from deeplearning4j_tpu_torch.parallel import expert_parallel as ep

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cd]
    si = _moe_layers(net)[0]
    p = {k: v.detach().to(dt).requires_grad_(True)
         for k, v in net.params[si].items()}
    n_tok = TRAIN_B * MOE_T
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    x = torch.randn(n_tok, MOE_WIDTH, generator=gen, device=DEVICE,
                    dtype=dt).requires_grad_(True)
    cap = ep.expert_capacity(n_tok, MOE_EXPERTS, MOE_CF, MOE_TOP_K)
    with torch.no_grad():
        logits = x.float() @ p["router"].float()
        dispatch, combine, _ = ep.route_top_k(logits, cap, MOE_TOP_K)
        xe0 = torch.einsum("bec,bd->ecd", dispatch.to(dt), x)
        ye0 = ep._expert_ffn(xe0, p["W_up"], p["W_down"])

    def backward(out):
        out.backward(torch.ones_like(out))

    def routing():
        lg = x.float() @ p["router"].float()
        ep.route_top_k(lg, cap, MOE_TOP_K)

    def dispatch_fb():
        backward(torch.einsum("bec,bd->ecd", dispatch.to(dt), x))

    xe = xe0.detach().requires_grad_(True)

    def ffn_fb():
        backward(ep._expert_ffn(xe, p["W_up"], p["W_down"]))

    ye = ye0.detach().requires_grad_(True)

    def combine_fb():
        backward(torch.einsum("bec,ecd->bd", combine.to(dt), ye))

    def layer_fb():
        y, aux = ep.moe_apply(p, x, MOE_CF, MOE_TOP_K)
        backward(y + aux)

    dh = MOE_WIDTH // MOE_HEADS
    q, k, v = (torch.randn(TRAIN_B, MOE_HEADS, MOE_T, dh, generator=gen,
                           device=DEVICE, dtype=dt).requires_grad_(True)
               for _ in range(3))
    launches = (flash_attention.launches, flash_attention.bwd_launches)

    def k1_fb():
        backward(flash_attention(q, k, v, True))

    parts = {"routing (fwd)": routing, "dispatch einsum": dispatch_fb,
             "expert FFN": ffn_fb, "combine einsum": combine_fb,
             "whole MoeDense": layer_fb, "K1": k1_fb}
    ms = {name: cuda_time_ms(fn, iters=5, warmup=1)
          for name, fn in parts.items()}
    flash_attention.launches, flash_attention.bwd_launches = launches
    shares = ", ".join(
        f"{name} {t:.3f} ms ({MOE_BLOCKS * t / 1e3 / step_s:.1%})"
        for name, t in ms.items())
    log(f"19a [{cd}]: a step's parts timed alone (fwd + bwd, x "
        f"{MOE_BLOCKS} blocks over the {step_s:.4f} s step): {shares}; "
        f"capacity {cap} per expert, dispatch/combine [{n_tok}, "
        f"{MOE_EXPERTS}, {cap}] [{card}]")


def moe_training_phase(card: str) -> dict:
    """19a: the MoE LM from one set of params on K1 and on dense
    attention, 4 fit steps each at B=2, T=2048 on the Markov task, f32
    and bf16: losses agree (5e-3 relative at f32, 2e-2 at bf16), K1
    launched once per block per step forward and backward, every MoE
    layer's aux loss finite; tokens/s, s/step, peak memory and the MoE
    parts' share of the step; then ``training_scan_check``. Returns K1's
    launches by kernel-line name."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )

    batches, floor = _markov_batches(MOE_STEPS, MOE_T, sample_seed=19)
    launches = {}
    for cd in ("float32", "bfloat16"):
        k1 = _moe_net(cd, True)
        dense = _moe_net(cd, False, like=k1)
        n_params = sum(p.numel() for p in k1.param_table().values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention.bwd_launches = 0
        paged_attention.launches = 0
        k_loss, k_wall = _train(k1, batches)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        peak = torch.cuda.max_memory_allocated()
        aux = [float(k1.state[si]["aux_loss"]) for si in _moe_layers(k1)]
        d_loss, d_wall = _train(dense, batches)
        dense_launches = flash_attention.launches - fwd
        rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, d_loss))
        step_s = float(np.mean(k_wall[1:]))
        log(f"19a [{cd}]: MoE LM {n_params / 1e6:.1f} M params, B="
            f"{TRAIN_B}, T={MOE_T}; K1 losses "
            f"{[f'{x:.6f}' for x in k_loss]}, dense "
            f"{[f'{x:.6f}' for x in d_loss]} (entropy floor {floor:.4f}); "
            f"max rel diff {rel:.3e} (tol {PARITY_RTOL[cd]}); aux losses "
            f"{[round(a, 5) for a in aux]}; K1 launches fwd {fwd}, bwd "
            f"{bwd} over {MOE_STEPS} steps; s/step K1 "
            f"{[round(w, 4) for w in k_wall]} (first warms up), dense "
            f"{[round(w, 4) for w in d_wall]}; "
            f"{TRAIN_B * MOE_T / step_s:.1f} tokens/s over steps 2-"
            f"{MOE_STEPS}; peak memory {peak / 2**30:.3f} GiB [{card}]")
        want = MOE_BLOCKS * MOE_STEPS
        if (not rel <= PARITY_RTOL[cd] or fwd != want or bwd != want
                or dense_launches != 0 or paged_attention.launches != 0
                or not all(np.isfinite(k_loss + d_loss + aux))):
            raise SystemExit(
                f"chip_smoke: phase 19a [{cd}] failed: rel {rel}, K1 "
                f"launches {fwd}/{bwd} (want {want}), dense net's "
                f"{dense_launches}, paged {paged_attention.launches}, aux "
                f"{aux}")
        del dense
        torch.cuda.empty_cache()
        moe_step_breakdown(card, cd, k1, step_s)
        s_fwd, s_bwd = training_scan_check(
            card, f"19a [{cd}]", lambda: _moe_net(cd, True, like=k1),
            batches, MOE_BLOCKS)
        del k1
        torch.cuda.empty_cache()
        name = "flash_attention_f32" if cd == "float32" else (
            "flash_attention")
        launches[name] = fwd + s_fwd
        launches[name + "_bwd"] = bwd + s_bwd
    return launches


class _MoeTrace:
    """What each forward of an eager engine computed: per MoeDense call
    (in layer order) the top-1 expert of every token row, its
    top-1/top-2 router probability gap and whether it kept a seat, and
    per network forward its output probabilities [B, V, T]. Host copies,
    one sync per call: for the f32 gate only."""

    def __init__(self):
        self.calls = []      # one per network forward
        self._route = []

    def route(self, probs, kept):
        top = probs.topk(2, dim=-1)
        self._route.append((top.indices[:, 0].cpu(),
                            (top.values[:, 0] - top.values[:, 1]).cpu(),
                            kept.cpu()))

    def forward(self, out):
        self.calls.append({"route": self._route, "out": out.float().cpu()})
        self._route = []


@contextlib.contextmanager
def moe_traced(eng, trace):
    """Within the block, every ``route_top_k`` call and every forward of
    ``eng`` records into ``trace``."""
    from deeplearning4j_tpu_torch.parallel import expert_parallel as ep

    route = ep.route_top_k

    def traced_route(logits, capacity, top_k=1, normalize_gates=True):
        f32 = torch.promote_types(logits.dtype, torch.float32)
        res = route(logits, capacity, top_k, normalize_gates)
        trace.route(torch.softmax(logits.to(f32), dim=-1),
                    res[0].sum(dim=(1, 2)) > 0)
        return res

    forward = eng._forward

    def traced_forward(x, mask, rnn):
        out, new_rnn = forward(x, mask, rnn)
        trace.forward(out)
        return out, new_rnn

    ep.route_top_k = traced_route
    eng._forward = traced_forward
    try:
        yield
    finally:
        ep.route_top_k = route
        del eng._forward


def _top2_gap(probs, dim):
    top = probs.topk(2, dim=dim)
    return (top.indices.select(dim, 0),
            top.values.select(dim, 0) - top.values.select(dim, 1))


def trace_divergence(a, b) -> tuple:
    """Walk two traces forward by forward (see MOE_GAP_LIMIT): returns
    (the first differing forward as {call, its root flips and the
    largest root gap, the sequences touched, the largest output
    difference and argmax gap over the untouched ones, near_tie}, or
    None; the largest output difference before it). A token row of a
    MoE call is sequence ``row // T`` of the forward's [B, V, T]
    output."""
    worst = 0.0
    for i, (ca, cb) in enumerate(zip(a.calls, b.calls)):
        if len(ca["route"]) != len(cb["route"]) or (
                ca["out"].shape != cb["out"].shape):
            return {"call": i, "shapes differ": True,
                    "near_tie": False}, worst
        n_b, _, n_t = cb["out"].shape
        touched = torch.zeros(n_b, dtype=torch.bool)
        root = None
        for (ea, _, ka), (eb, gb, kb) in zip(ca["route"], cb["route"]):
            moved = ea != eb
            if root is None and bool(moved.any()):
                root = gb[moved]
            touched |= (moved | (ka != kb)).reshape(n_b, n_t).any(dim=1)
        keep = ~touched
        diff = (ca["out"] - cb["out"]).abs().amax(dim=1)[keep]   # [b', T]
        am_a, _ = _top2_gap(ca["out"][keep], 1)
        am_b, gap_b = _top2_gap(cb["out"][keep], 1)
        argmax_gaps = gap_b[am_a != am_b]
        out_diff = float(diff.max()) if diff.numel() else 0.0
        if root is None and not argmax_gaps.numel() and (
                out_diff <= MOE_OUT_TOL):
            worst = max(worst, out_diff)
            continue
        root_gap = float(root.max()) if root is not None else 0.0
        argmax_gap = (float(argmax_gaps.max()) if argmax_gaps.numel()
                      else 0.0)
        tie = (root_gap < MOE_GAP_LIMIT and out_diff <= MOE_OUT_TOL
               and argmax_gap < MOE_GAP_LIMIT)
        return {"call": i,
                "root flips": 0 if root is None else int(root.numel()),
                "root gap": root_gap,
                "sequences touched": int(touched.sum()),
                "out diff untouched": out_diff,
                "argmax flips untouched": int(argmax_gaps.numel()),
                "argmax gap": argmax_gap, "near_tie": tie}, worst
    if len(a.calls) != len(b.calls):
        return {"call": min(len(a.calls), len(b.calls)),
                "forwards differ": True, "near_tie": False}, worst
    return None, worst


def _trace_min_gaps(trace) -> tuple:
    """The smallest nonzero router and output top-1/top-2 gaps over a
    run (exact ties, as an idle row of zeros gives, resolve the same way
    in both runs)."""
    def smallest(gaps):
        pos = [float(g[g > 0].min()) for g in gaps if bool((g > 0).any())]
        return min(pos, default=float("inf"))

    router = smallest([g for c in trace.calls for _, g, _ in c["route"]])
    out = smallest([_top2_gap(c["out"], 1)[1] for c in trace.calls])
    return router, out


def moe_serving_phase(card: str) -> int:
    """19b: the MoE LM served at bf16 by the paged engine at phase 6's
    knobs (8 slots, chunk 32, window 2048, 12 x 128-token prompts x 128
    new tokens), its rounds replayed from one captured graph: every
    request finishes, K2 launched once per block per decode step;
    tokens/s against eager rounds. Then the f32 gate on eager rounds
    (traced): the kernel engine and a right program (the plain one with
    reordered sums) against the plain-gather engine, ids identical or
    diverging only at a near tie (``trace_divergence``); each planted
    fault must diverge at no near tie; the graph kernel engine's f32 ids
    equal its eager run's. Returns K2's launches on the bf16 graph
    run."""
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request

    net = _moe_net("bfloat16", None, window=WINDOW)
    geometry = dict(paged_kv=True, block_tokens=BLOCK_TOKENS,
                    n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK)
    prompts = serving_prompts(0)
    eng = DecodeEngine(net, use_flash_paged=True, **geometry)
    eng.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))   # warm-up
    eng.run()                    # captures the decode round's graph
    steps0 = eng.stats["decode_steps"]
    paged_attention.launches = 0
    results, wall = serve_ids(eng, prompts)
    launches = paged_attention.launches
    steps = eng.stats["decode_steps"] - steps0
    bad = [(r.id, r.finish_reason, len(r.tokens)) for r in results
           if r.finish_reason != "length" or len(r.tokens) != N_GEN]
    counts = eng.compile_counts()
    rate = N_REQUESTS * N_GEN / wall
    eager = DecodeEngine(net, **geometry)
    eager._graphs = None
    eager.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))
    eager.run()
    eager_res, eager_wall = serve_ids(eager, prompts)
    eager_rate = N_REQUESTS * N_GEN / eager_wall
    agree = float(np.mean(agreement([r.tokens for r in results],
                                    [r.tokens for r in eager_res])))
    log(f"19b: MoE LM served (bf16, paged, {N_SLOTS} slots, chunk "
        f"{DECODE_CHUNK}): {N_REQUESTS} x {N_GEN} tokens, graph rounds "
        f"{rate:.1f} tokens/s against eager rounds {eager_rate:.1f} "
        f"({rate / eager_rate:.2f}x); {steps} decode steps, {launches} K2 "
        f"launches; {counts}; graph / eager id agreement {agree:.4f} "
        f"[{card}]")
    if (bad or launches != MOE_BLOCKS * steps or launches == 0
            or counts["decode"] != 1):
        raise SystemExit(
            f"chip_smoke: phase 19b failed: unfinished {bad}, K2 "
            f"launches {launches} for {steps} steps x {MOE_BLOCKS} blocks, "
            f"{counts}")
    del eng, eager
    torch.cuda.empty_cache()

    net32 = _moe_net("float32", None, window=WINDOW, like=net)
    del net

    def traced_run(use_flash_paged, wrap=None):
        trace = _MoeTrace()
        e = DecodeEngine(net32, use_flash_paged=use_flash_paged,
                         **geometry)
        e._graphs = None
        with paged_reference_wrapped(wrap), moe_traced(e, trace):
            res, _ = serve_ids(e, prompts)
        return [r.tokens for r in res], trace

    kernel_ids, kernel_tr = traced_run(True)
    plain_ids, plain_tr = traced_run(False)
    reord_ids, reord_tr = traced_run(False, reordered_sums)
    graph_ids = [r.tokens for r in serve_ids(DecodeEngine(
        net32, use_flash_paged=True, **geometry), prompts)[0]]

    def verdict(ids, tr):
        div, worst = trace_divergence(tr, plain_tr)
        same = ids == plain_ids
        ok = (same and div is None) or (div is not None
                                        and div["near_tie"])
        return same, div, worst, ok

    k_same, k_div, k_worst, k_ok = verdict(kernel_ids, kernel_tr)
    r_same, r_div, r_worst, r_ok = verdict(reord_ids, reord_tr)
    router_gap, out_gap = _trace_min_gaps(kernel_tr)
    log(f"19b gate f32: kernel ids identical to plain {k_same}, first "
        f"difference {k_div}, max |output diff| before it {k_worst:.3e};"
        f" right program (reordered sums) identical {r_same}, {r_div}, "
        f"{r_worst:.3e}; limits: gap {MOE_GAP_LIMIT}, output "
        f"{MOE_OUT_TOL}; smallest gaps over the kernel run: router "
        f"top-1/top-2 {router_gap:.3e}, output {out_gap:.3e} over "
        f"{len(kernel_tr.calls)} forwards; graph rounds' ids equal the "
        f"eager kernel run's {graph_ids == kernel_ids} [{card}]")
    caught = {}
    for name, wrap in dict(MOE_PLANTED_FAULTS,
                           **PLANTED_FAULTS).items():
        f_ids, f_tr = traced_run(False, wrap)
        _, f_div, f_worst, f_ok = verdict(f_ids, f_tr)
        gated = name in MOE_PLANTED_FAULTS
        if gated:
            caught[name] = not f_ok
        log(f"19b gate, planted fault ({name}{'' if gated else ', report'}"
            f"): first difference {f_div} (max |output diff| before it "
            f"{f_worst:.3e}); rejected {not f_ok}")
    if not (k_ok and r_ok and all(caught.values())
            and graph_ids == kernel_ids):
        raise SystemExit(
            f"chip_smoke: phase 19b gate failed: kernel {k_div} (ids "
            f"identical {k_same}), right program {r_div}, planted faults "
            f"rejected {caught}, graph ids equal eager "
            f"{graph_ids == kernel_ids}")
    del net32
    torch.cuda.empty_cache()
    return launches


def _char_lstm_conf(tbptt: bool):
    """DL4J's GravesLSTMCharModellingExample (2 x GravesLSTM(200), tanh,
    softmax/MCXENT, RMSProp decay 0.95, l2 1e-3, Xavier, TBPTT 50) over
    the Markov vocab, at lr 0.002: the example's 0.1 moves every weight
    by ~0.45 on RMSProp's first step (lr / sqrt(1 - decay)) and the
    Markov losses climb past 20 within 3 windows."""
    from deeplearning4j_tpu_torch.nn.conf import (
        NeuralNetConfiguration,
        Updater,
    )
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.enums import (
        BackpropType,
        WeightInit,
    )
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    b = (NeuralNetConfiguration.Builder().seed(12345).learning_rate(0.002)
         .rms_decay(0.95).regularization(True).l2(0.001)
         .weight_init(WeightInit.XAVIER).updater(Updater.RMSPROP).list()
         .layer(0, L.GravesLSTM(n_in=TRAIN_VOCAB, n_out=LSTM_HIDDEN,
                                activation="tanh"))
         .layer(1, L.GravesLSTM(n_in=LSTM_HIDDEN, n_out=LSTM_HIDDEN,
                                activation="tanh"))
         .layer(2, L.RnnOutputLayer(n_in=LSTM_HIDDEN, n_out=TRAIN_VOCAB,
                                    activation="softmax",
                                    loss_function=LossFunction.MCXENT)))
    if tbptt:
        b = (b.backprop_type(BackpropType.TRUNCATED_BPTT)
             .t_bptt_forward_length(LSTM_TBPTT)
             .t_bptt_backward_length(LSTM_TBPTT))
    return b.build()


class _WindowClock:
    """Per truncated-BPTT window: the score (a host read, so a sync)
    and the seconds since the last window."""

    invoked_every = 1

    def __init__(self):
        self.scores, self.secs = [], []
        self._t = time.perf_counter()

    def iteration_done(self, model, iteration):
        self.scores.append(float(model.score_value))
        now = time.perf_counter()
        self.secs.append(now - self._t)
        self._t = now


def lstm_phase(card: str) -> None:
    """19c: the char-modelling LSTM at its published widths on Markov
    sequences of 1000 (64 tokens, minibatch 32): one batch of
    truncated-BPTT windows of 50 on the card and, from a zip the card
    net wrote, on the CPU: per-window losses within 5e-3 relative and
    falling; ``rnn_time_step`` over 64 tokens equals the full forward
    within 1e-4; the full-BPTT net's ``fit_scan`` (T=50, 2 steps a
    window) through ``training_scan_check``."""
    import tempfile

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.markov import markov_lm_batches
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
        write_model,
    )

    feats, labels, floor = markov_lm_batches(TRAIN_VOCAB, LSTM_BATCH,
                                             LSTM_T, seed=0, sample_seed=3)
    net = MultiLayerNetwork(_char_lstm_conf(True), device=DEVICE).init()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lstm.zip")
        write_model(net, path)
        cpu = restore_model(path, device="cpu")
    card_clock, cpu_clock = _WindowClock(), _WindowClock()
    net.set_listeners(card_clock)
    cpu.set_listeners(cpu_clock)
    net.fit(DataSet(feats, labels))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # many tiny ops: threads only contend
    try:
        cpu.fit(DataSet(feats, labels))
    finally:
        torch.set_num_threads(threads)
    a, b = card_clock.scores, cpu_clock.scores
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    falls = float(np.mean(a[-4:])) < float(np.mean(a[:4]))
    secs = card_clock.secs[1:]
    log(f"19c: GravesLSTM x 2 ({LSTM_HIDDEN}), TBPTT {LSTM_TBPTT} over T="
        f"{LSTM_T}, batch {LSTM_BATCH}: {len(a)} windows; card losses "
        f"{[round(x, 4) for x in a]} (entropy floor {floor:.4f}); max rel "
        f"diff to the CPU {rel:.3e} (tol {LSTM_RTOL}); falling {falls}; "
        f"{float(np.median(secs)):.4f} s a window on the card (median, "
        f"eager; first {card_clock.secs[0]:.3f} s), CPU "
        f"{float(np.median(cpu_clock.secs)):.4f} s [{card}]")
    if (len(a) != len(b) or len(a) < 8 or not rel <= LSTM_RTOL
            or not falls):
        raise SystemExit(f"chip_smoke: phase 19c TBPTT failed: {len(a)} / "
                         f"{len(b)} windows, rel {rel}, falling {falls}")
    x = torch.as_tensor(feats[:4, :, :LSTM_STREAM], device=DEVICE)
    full = net.output(x)
    net.rnn_clear_previous_state()
    steps = [net.rnn_time_step(x[:, :, t]) for t in range(LSTM_STREAM)]
    err = float((torch.cat(steps, dim=2) - full).abs().max())
    log(f"19c: rnn_time_step over {LSTM_STREAM} tokens against the full "
        f"forward: max |diff| {err:.3e} (tol {LSTM_STREAM_ATOL}) [{card}]")
    if not err <= LSTM_STREAM_ATOL:
        raise SystemExit(f"chip_smoke: phase 19c rnn_time_step off by "
                         f"{err}")
    def full_bptt_twin():
        twin = MultiLayerNetwork(_char_lstm_conf(False),
                                 device=DEVICE).init()
        for key, p in net.param_table().items():
            twin.set_param(key, p)
        return twin

    windows = [(feats[:, :, i:i + LSTM_TBPTT], labels[:, :, i:i + LSTM_TBPTT])
               for i in (0, LSTM_TBPTT)]
    training_scan_check(card, f"19c (full BPTT, T={LSTM_TBPTT})",
                        full_bptt_twin, windows, 0)


def dbn_phase(card: str) -> None:
    """19d: bench.py's DBN row: ``dbn(lr=0.05, updater=NESTEROVS)``,
    784-500-250-10, CD-1, 8192 synthetic MNIST in batches of 1024; 2
    warm-up pretrain passes, then 9 windows of 3 pretrain epochs
    (epochs/s, the median of the 5 middle windows, as bench.py), 40
    finetune epochs, and the accuracy on 2048 test images against
    bench.py's 0.97 gate."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset
    from deeplearning4j_tpu_torch.models.zoo import dbn
    from deeplearning4j_tpu_torch.nn.conf import Updater
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    batches = mnist_dataset(train=True, num_examples=DBN_N).batch_by(
        DBN_BATCH)
    net = MultiLayerNetwork(dbn(lr=0.05, updater=Updater.NESTEROVS),
                            device=DEVICE).init()
    for _ in range(DBN_WARM):
        net.pretrain(ListDataSetIterator(batches))
    rates = []
    for _ in range(DBN_WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DBN_EPOCHS):
            net.pretrain(ListDataSetIterator(batches))
        torch.cuda.synchronize()
        rates.append(DBN_EPOCHS / (time.perf_counter() - t0))
    trimmed = sorted(rates)[2:-2] or rates
    t0 = time.perf_counter()
    for _ in range(DBN_FINETUNE):
        for b in batches:
            net.fit(b)
    torch.cuda.synchronize()
    fine_s = time.perf_counter() - t0
    test = mnist_dataset(train=False, num_examples=DBN_TEST_N)
    acc = float(net.evaluate(test.batch_by(1024)).accuracy())
    log(f"19d: DBN 784-500-250-10, CD-1, {DBN_N} examples in batches of "
        f"{DBN_BATCH}: {float(np.median(trimmed)):.3f} pretrain epochs/s "
        f"(median of {len(trimmed)} middle {DBN_EPOCHS}-epoch windows; all "
        f"{[round(r, 3) for r in rates]}); {DBN_FINETUNE} finetune epochs "
        f"in {fine_s:.2f} s; accuracy {acc:.4f} on {DBN_TEST_N} test "
        f"images (gate {ACCURACY_GATE}) [{card}]")
    if not acc >= ACCURACY_GATE:
        raise SystemExit(f"chip_smoke: phase 19d DBN accuracy {acc}")


def rest_of_layers_phase(card: str) -> dict:
    """Phase 19: 19a-19d; returns K1's and K2's launches on its main
    paths by kernel-line name."""
    t0 = time.perf_counter()
    launches = moe_training_phase(card)
    launches["paged_attention"] = moe_serving_phase(card)
    lstm_phase(card)
    dbn_phase(card)
    log(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return launches


# phase 20: ComputationGraph end to end. The DAG LM is the flagship's
# layers as graph vertices ("block0".."block7", "ln", "out"), with
# block 4's and block 8's outputs meeting in an add vertex before the
# LayerNorm.
DAG_SKIP = ("block3", "block7")
DAG_STEPS = 4
# the chain twin (no add vertex) against the flagship MLN from the same
# params, on the card: bit-identical, or at most this far apart
# (relative) with the difference printed
TWIN_RTOL = 1e-6
# 20c: the solvers card against CPU (f32 sums in another order on
# another device, over 10 line-searched iterations), the examples of
# synthetic MNIST they see, and the HF product's limit against its
# central difference (relative to max |Hv|; f32 gradients differenced
# at a step of 1e-2 along a unit vector)
SOLVER_ITERS = 10
SOLVER_EXAMPLES = 1024
SOLVER_RTOL = 1e-3
HVP_FD_EPS = 1e-2
HVP_FD_TOL = 5e-2
ES_EPOCHS = 4


def _dag_conf(compute_dtype, use_flash, chain=False, window=None,
              lr=1e-3, warmup_steps=2, total_steps=100):
    """The DAG LM (``chain``: its twin without the add vertex) with the
    flagship's global knobs: seed 11, Adam with warmup_cosine, Xavier."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.enums import Updater, WeightInit
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ElementWiseOp,
        ElementWiseVertex,
        LayerVertex,
    )
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        TransformerBlock,
    )
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    g = (NeuralNetConfiguration.Builder().seed(11).learning_rate(lr)
         .lr_policy("warmup_cosine").lr_warmup_steps(warmup_steps)
         .lr_total_steps(total_steps).updater(Updater.ADAM)
         .activation("identity").weight_init(WeightInit.XAVIER)
         .graph_builder().add_inputs("in"))
    prev = "in"
    for i in range(N_LAYERS):
        g.add_layer(f"block{i}", TransformerBlock(
            n_in=TRAIN_VOCAB if i == 0 else WIDTH, n_out=WIDTH,
            n_heads=N_HEADS, causal=True), prev)
        prev = f"block{i}"
    if not chain:
        g.add_vertex("skip", ElementWiseVertex(op=ElementWiseOp.ADD),
                     *DAG_SKIP)
        prev = "skip"
    g.add_layer("ln", L.LayerNormalization(n_in=WIDTH, n_out=WIDTH), prev)
    g.add_layer("out", L.RnnOutputLayer(
        n_in=WIDTH, n_out=TRAIN_VOCAB, activation="softmax",
        loss_function=LossFunction.MCXENT), "ln")
    conf = g.set_outputs("out").build()
    for v in conf.vertices.values():
        if not isinstance(v, LayerVertex):
            continue
        if compute_dtype != "float32":
            v.conf.compute_dtype = compute_dtype
        if hasattr(v.conf.layer, "use_flash"):
            v.conf.layer.use_flash = use_flash
        if window is not None and hasattr(v.conf.layer, "stream_max_t"):
            v.conf.layer.stream_max_t = window
    return conf


def _dag_net(compute_dtype, use_flash, like=None, **kw):
    """A DAG LM on the card, its params ``like``'s when given."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    net = ComputationGraph(_dag_conf(compute_dtype, use_flash, **kw),
                           device=DEVICE).init()
    if like is not None:
        net.set_params_flat(like.params_flat())
    return net


def _twin_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (0.0 when bit-identical)."""
    if torch.equal(a, b):
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def dag_chain_twin_check(card: str, batch) -> None:
    """20a's twin: the chain graph (no add vertex) and the flagship MLN
    from the same params (MLN layer i = vertex ``block<i>``, then "ln",
    "out"), f32 on K1: the output and one ``fit`` step (score, every
    param, Adam's state) bit-identical on the card, or within
    ``TWIN_RTOL`` with the difference printed."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.streaming import tree_leaves, tree_map

    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    mln = MultiLayerNetwork(_flagship("float32", True, **kw),
                            device=DEVICE).init()
    twin = ComputationGraph(_dag_conf("float32", True, chain=True, **kw),
                            device=DEVICE).init()
    names = [f"block{i}" for i in range(N_LAYERS)] + ["ln", "out"]
    twin.params = {name: tree_map(torch.clone, mln.params[str(i)])
                   for i, name in enumerate(names)}
    twin.params_version += 1
    f, y = batch
    x = torch.as_tensor(f, device=DEVICE)
    diffs = {"output": _twin_diff(twin.output(x)[0], mln.output(x))}
    mln.fit(f, y)
    twin.fit(f, y)
    diffs["score"] = _twin_diff(twin.score_value.reshape(1),
                                mln.score_value.reshape(1))
    for tree in ("params", "updater_state"):
        pairs = [(a, b) for i, name in enumerate(names) for a, b in zip(
            tree_leaves(getattr(twin, tree)[name]),
            tree_leaves(getattr(mln, tree)[str(i)]))]
        diffs[tree] = max(_twin_diff(a, b) for a, b in pairs)
    exact = all(d == 0.0 for d in diffs.values())
    log(f"20a chain twin (f32, K1, B={TRAIN_B}, T={PARITY_T}) against the "
        f"flagship MLN from the same params: max relative difference "
        f"{ {k: f'{v:.3e}' for k, v in diffs.items()} }; bit-identical "
        f"{exact} (limit {TWIN_RTOL}) [{card}]")
    if not all(d <= TWIN_RTOL for d in diffs.values()):
        raise SystemExit(f"chip_smoke: 20a chain twin differs from the "
                         f"MLN: {diffs}")
    del mln, twin
    torch.cuda.empty_cache()


def dag_training_phase(card: str) -> dict:
    """20a: the DAG LM from one set of params on K1 and on dense
    attention, 4 fit steps each at B=2, T=2048 on the Markov task, f32
    and bf16: losses agree (5e-3 relative at f32, 2e-2 at bf16; at f32
    the params too), K1 launched once per block per step forward and
    backward through the graph's vertex loop; tokens/s, s/step, peak
    memory; then ``training_scan_check`` (captured ``fit_scan`` windows
    bit-identical to the eager loop) and the chain twin. Returns K1's
    launches by kernel-line name."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        paged_attention,
    )

    batches, floor = _markov_batches(DAG_STEPS, PARITY_T, sample_seed=20)
    launches = {}
    for cd in ("float32", "bfloat16"):
        k1 = _dag_net(cd, True)
        dense = _dag_net(cd, False, like=k1)
        n_params = k1.num_params()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention.bwd_launches = 0
        paged_attention.launches = 0
        k_loss, k_wall = _train(k1, batches)
        fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
        peak = torch.cuda.max_memory_allocated()
        d_loss, d_wall = _train(dense, batches)
        dense_launches = flash_attention.launches - fwd
        rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, d_loss))
        pdiff = float((k1.params_flat() - dense.params_flat()).abs().max())
        p_tol = PARITY_PARAM_ATOL.get(cd, float("inf"))
        step_s = float(np.mean(k_wall[1:]))
        log(f"20a [{cd}]: DAG LM ({N_LAYERS} blocks, {DAG_SKIP[0]} + "
            f"{DAG_SKIP[1]} -> ln) {n_params / 1e6:.1f} M params, B="
            f"{TRAIN_B}, T={PARITY_T}; K1 losses "
            f"{[f'{x:.6f}' for x in k_loss]}, dense "
            f"{[f'{x:.6f}' for x in d_loss]} (entropy floor {floor:.4f}); "
            f"max rel diff {rel:.3e} (tol {PARITY_RTOL[cd]}); max |param "
            f"diff| {pdiff:.3e} (tol {p_tol}); K1 launches fwd {fwd}, bwd "
            f"{bwd} over {DAG_STEPS} steps; s/step K1 "
            f"{[round(w, 4) for w in k_wall]} (first warms up), dense "
            f"{[round(w, 4) for w in d_wall]}; "
            f"{TRAIN_B * PARITY_T / step_s:.1f} tokens/s over steps 2-"
            f"{DAG_STEPS}; peak memory {peak / 2**30:.3f} GiB [{card}]")
        want = N_LAYERS * DAG_STEPS
        if (not rel <= PARITY_RTOL[cd] or not pdiff <= p_tol
                or fwd != want or bwd != want
                or dense_launches != 0 or paged_attention.launches != 0
                or not all(np.isfinite(k_loss + d_loss))):
            raise SystemExit(
                f"chip_smoke: phase 20a [{cd}] failed: rel {rel}, param "
                f"diff {pdiff}, K1 launches {fwd}/{bwd} (want {want}), "
                f"dense net's {dense_launches}, paged "
                f"{paged_attention.launches}")
        del dense
        torch.cuda.empty_cache()
        s_fwd, s_bwd = training_scan_check(
            card, f"20a [{cd}]", lambda: _dag_net(cd, True, like=k1),
            batches, N_LAYERS)
        del k1
        torch.cuda.empty_cache()
        name = "flash_attention_f32" if cd == "float32" else (
            "flash_attention")
        launches[name] = fwd + s_fwd
        launches[name + "_bwd"] = bwd + s_bwd
    dag_chain_twin_check(card, batches[0])
    return launches


def dag_serving_phase(card: str, tmp: str) -> int:
    """20b: the DAG LM served at bf16 by the paged engine at phase 6's
    knobs, its decode round one captured graph: every request finishes,
    K2 launched once per block per decode step; tokens/s against eager
    rounds. The f32 gate as phase 6 holds it: the kernel engine's greedy
    ids identical to the plain-gather engine's, the reordered-sums
    program identical, the planted faults rejected. Then the f32 net
    through a graph zip (``restore_model``) serves the kernel engine's
    ids. Returns K2's launches on the bf16 graph run."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.attention import paged_attention
    from deeplearning4j_tpu_torch.serving import DecodeEngine, Request
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
        write_model,
    )

    net = _dag_net("bfloat16", None, window=WINDOW)
    geometry = dict(paged_kv=True, block_tokens=BLOCK_TOKENS,
                    n_slots=N_SLOTS, decode_chunk=DECODE_CHUNK)
    prompts = serving_prompts(0)
    eng = DecodeEngine(net, use_flash_paged=True, **geometry)
    eng.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))   # warm-up
    eng.run()                    # captures the decode round's graph
    steps0 = eng.stats["decode_steps"]
    paged_attention.launches = 0
    results, wall = serve_ids(eng, prompts)
    launches = paged_attention.launches
    steps = eng.stats["decode_steps"] - steps0
    bad = [(r.id, r.finish_reason, len(r.tokens)) for r in results
           if r.finish_reason != "length" or len(r.tokens) != N_GEN]
    counts = eng.compile_counts()
    rate = N_REQUESTS * N_GEN / wall
    layers = sorted(eng._pool)
    eager = DecodeEngine(net, **geometry)
    eager._graphs = None
    eager.submit(Request(prompts[0][:16], DECODE_CHUNK + 1))
    eager.run()
    eager_res, eager_wall = serve_ids(eager, prompts)
    eager_rate = N_REQUESTS * N_GEN / eager_wall
    agree = float(np.mean(agreement([r.tokens for r in results],
                                    [r.tokens for r in eager_res])))
    log(f"20b: DAG LM served (bf16, paged, {N_SLOTS} slots, chunk "
        f"{DECODE_CHUNK}): {N_REQUESTS} x {N_GEN} tokens, graph rounds "
        f"{rate:.1f} tokens/s against eager rounds {eager_rate:.1f} "
        f"({rate / eager_rate:.2f}x); {steps} decode steps, {launches} K2 "
        f"launches; {counts}; pool layers {layers}; graph / eager id "
        f"agreement {agree:.4f} [{card}]")
    if (bad or launches != N_LAYERS * steps or launches == 0
            or counts["decode"] != 1 or eng._graphs.captures != 1):
        raise SystemExit(
            f"chip_smoke: phase 20b failed: unfinished {bad}, K2 "
            f"launches {launches} for {steps} steps x {N_LAYERS} blocks, "
            f"{counts}")
    del eng, eager
    torch.cuda.empty_cache()

    net32 = _dag_net("float32", None, like=net, window=WINDOW)
    del net

    def free_ids(model, use_flash_paged, wrap=None):
        with paged_reference_wrapped(wrap):
            res, _ = serve_ids(DecodeEngine(
                model, use_flash_paged=use_flash_paged, **geometry),
                prompts)
        return [r.tokens for r in res]

    kernel32 = free_ids(net32, True)
    plain32 = free_ids(net32, False)
    reord32 = free_ids(net32, False, reordered_sums)
    identical, right32 = kernel32 == plain32, reord32 == plain32
    caught = {name: free_ids(net32, False, wrap) != kernel32
              for name, wrap in PLANTED_FAULTS.items()}
    log(f"20b gate f32: kernel ids identical to plain {identical} (per "
        f"request {[round(a, 4) for a in agreement(kernel32, plain32)]});"
        f" plain with reordered sums identical {right32}; planted faults "
        f"rejected {caught} [{card}]")
    near_tie_report(net32, prompts, kernel32, plain32, "20b f32")
    path = os.path.join(tmp, "dag32.zip")
    t0 = time.perf_counter()
    write_model(net32, path)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    del net32
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loaded = restore_model(path, device=DEVICE)
    load_s = time.perf_counter() - t0
    zip_ids = free_ids(loaded, True)
    os.remove(path)
    log(f"20b: the f32 DAG LM through a {size / 2**20:.1f} MiB graph zip "
        f"(written in {write_s:.1f} s, restored in {load_s:.1f} s, a "
        f"{type(loaded).__name__}) serves ids identical to the in-process "
        f"kernel engine's {zip_ids == kernel32} [{card}]")
    if (not identical or not right32 or not all(caught.values())
            or zip_ids != kernel32
            or not isinstance(loaded, ComputationGraph)):
        raise SystemExit(
            f"chip_smoke: phase 20b gate failed: f32 ids identical "
            f"{identical}, right program {right32}, planted faults "
            f"rejected {caught}, zip ids identical {zip_ids == kernel32}")
    del loaded
    torch.cuda.empty_cache()
    return launches


def _solver_data():
    from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset

    return mnist_dataset(train=True, num_examples=SOLVER_EXAMPLES)


def solver_card_cpu_check(card: str, tmp: str) -> None:
    """20c: the zoo's ``mlp`` (784-500-10) from one zip, 10 iterations
    each of LBFGS, ConjugateGradient and LineGradientDescent over 1024
    synthetic MNIST examples on the card and on the CPU: every
    iteration's score within ``SOLVER_RTOL`` relative and falling."""
    from deeplearning4j_tpu_torch.models.zoo import mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener,
    )
    from deeplearning4j_tpu_torch.util.model_serializer import (
        restore_model,
        write_model,
    )

    ds = _solver_data()
    path = os.path.join(tmp, "mlp.zip")
    write_model(MultiLayerNetwork(mlp(), device=DEVICE).init(), path)
    for name in ("LBFGS", "ConjugateGradient", "LineGradientDescent"):
        runs = {}
        for dev in (DEVICE, "cpu"):
            net = restore_model(path, device=dev)
            scores = CollectScoresIterationListener()
            net.set_listeners(scores)
            t0 = time.perf_counter()
            getattr(solver, name)(net, max_iterations=SOLVER_ITERS
                                  ).optimize(ds)
            runs[dev] = ([s for _, s in scores.scores],
                         time.perf_counter() - t0)
        card_s, cpu_s = runs[DEVICE][0], runs["cpu"][0]
        n = min(len(card_s), len(cpu_s))
        rel = max(abs(a - b) / abs(b) for a, b in zip(card_s, cpu_s))
        log(f"20c {name}: {len(card_s)} / {len(cpu_s)} iterations card / "
            f"CPU, scores {[round(s, 6) for s in card_s]} (card), max rel "
            f"diff {rel:.3e} (limit {SOLVER_RTOL}); "
            f"{runs[DEVICE][1]:.3f} s card, {runs['cpu'][1]:.3f} s CPU "
            f"[{card}]")
        if (len(card_s) != len(cpu_s) or n < 2 or not rel <= SOLVER_RTOL
                or not card_s[-1] < card_s[0]):
            raise SystemExit(f"chip_smoke: 20c {name} card against CPU "
                             f"failed: {card_s} vs {cpu_s}")
    os.remove(path)


def hvp_and_double_backward_check(card: str) -> None:
    """20c: HF's Hessian-vector product on a small attention net on the
    card (dense attention) against a central difference of its
    gradients, printed and held within ``HVP_FD_TOL`` of max |Hv|; a
    double backward through K1 raises, and so does HF on the same net
    with ``use_flash=True``."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.markov import markov_lm_batches
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship
    from deeplearning4j_tpu_torch.nn.conf.enums import OptimizationAlgorithm
    from deeplearning4j_tpu_torch.nn.layers.attention import flash_attention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.solver import FlatProblem

    conf = transformer_lm_flagship(vocab=16, width=128, n_layers=2,
                                   n_heads=2, seed=5)
    for c in conf.confs:
        c.optimization_algo = OptimizationAlgorithm.HESSIAN_FREE
        c.num_iterations = 1
        if hasattr(c.layer, "use_flash"):
            c.layer.use_flash = False
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    f, y, _ = markov_lm_batches(16, 2, 256, seed=0, sample_seed=7)
    problem = FlatProblem(net, DataSet(f, y))
    x0 = problem.x0
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    v = torch.randn(x0.shape, generator=gen, device=DEVICE)
    v = v / v.norm()
    hv = problem.hessian_vector_product(x0, v)
    g_plus = problem.value_and_grad(x0 + HVP_FD_EPS * v)[1]
    g_minus = problem.value_and_grad(x0 - HVP_FD_EPS * v)[1]
    fd = (g_plus - g_minus) / (2 * HVP_FD_EPS)
    err = float((hv - fd).abs().max() / hv.abs().max())
    cos = float(torch.dot(hv, fd) / (hv.norm() * fd.norm()))
    log(f"20c HF product (2 blocks, width 128, T=256, dense attention, "
        f"{x0.numel()} params): max |Hv - central difference| / max |Hv| "
        f"{err:.3e} (limit {HVP_FD_TOL}, step {HVP_FD_EPS}), cosine "
        f"{cos:.6f}, max |Hv| {float(hv.abs().max()):.4e} [{card}]")
    if not err <= HVP_FD_TOL:
        raise SystemExit(f"chip_smoke: 20c HF product differs from the "
                         f"central difference: {err}")
    launches = (flash_attention.launches, flash_attention.bwd_launches)
    q, k, vv = (torch.randn((1, 2, 256, 64), generator=gen, device=DEVICE,
                            dtype=torch.bfloat16).requires_grad_(True)
                for _ in range(3))
    out = flash_attention(q, k, vv, True)
    raised = {}
    try:
        torch.autograd.grad(out.float().square().sum(), q,
                            create_graph=True)
        raised["double backward"] = None
    except RuntimeError as e:
        raised["double backward"] = str(e)
    for c in net.conf.confs:
        if hasattr(c.layer, "use_flash"):
            c.layer.use_flash = True
    try:
        net.fit(f, y)
        raised["HF over K1"] = None
    except RuntimeError as e:
        raised["HF over K1"] = str(e)
    flash_attention.launches, flash_attention.bwd_launches = launches
    log(f"20c: a double backward through K1 and HF over K1 raise: "
        f"{ {k: (m or 'no raise')[:90] for k, m in raised.items()} } "
        f"[{card}]")
    if not all(m and "double backward through K1" in m
               for m in raised.values()):
        raise SystemExit(f"chip_smoke: 20c K1 second derivative did not "
                         f"raise: {raised}")
    del net, problem
    torch.cuda.empty_cache()


def early_stopping_checkpoint_check(card: str, tmp: str) -> None:
    """20c: an ``EarlyStoppingTrainer`` on the zoo's ``mlp`` over
    synthetic MNIST (4 batches of 256, 512 held out) with a
    ``LocalFileModelSaver`` and, through its listener, a
    ``CheckpointManager`` (keep the last 2 plus the best) saving every
    epoch: the best model restores from the saver with its score, and
    the manager's best step restores with outputs equal to it."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    ds = _solver_data()
    train = ListDataSetIterator([ds.get_range(i, i + 256)
                                 for i in range(0, 1024 - 512, 256)]
                                + [ds.get_range(512, 768)])
    test = ListDataSetIterator([ds.get_range(768, 1024)])
    saver = es.LocalFileModelSaver(os.path.join(tmp, "es"), device=DEVICE)
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep_last_n=2,
                            keep_best=True)

    class Checkpoints(es.EarlyStoppingListener):
        def on_epoch(self, epoch, score, config, net):
            mgr.save(epoch, net, iterator=train, score=score)

    cfg = (es.EarlyStoppingConfiguration.Builder()
           .score_calculator(es.DataSetLossCalculator(test))
           .epoch_termination_conditions(
               es.MaxEpochsTerminationCondition(ES_EPOCHS),
               es.ScoreImprovementEpochTerminationCondition(2))
           .model_saver(saver).build())
    net = MultiLayerNetwork(mlp(lr=0.05), device=DEVICE).init()
    t0 = time.perf_counter()
    result = es.EarlyStoppingTrainer(cfg, net, train, Checkpoints()).fit()
    mgr.wait_until_finished()
    wall = time.perf_counter() - t0
    best = saver.get_best_model()
    best_score = es.DataSetLossCalculator(test).calculate_score(best)
    restored, meta = mgr.restore(step=mgr.best_step(), device=DEVICE)
    x = torch.as_tensor(ds.features[768:], device=DEVICE)
    same = torch.equal(restored.output(x), best.output(x))
    log(f"20c early stopping: {result.termination_reason.value} "
        f"({result.termination_details}), {result.total_epochs} epochs in "
        f"{wall:.2f} s, scores { {e: round(s, 6) for e, s in result.score_vs_epoch.items()} }, "
        f"best epoch {result.best_model_epoch}; the saver's best model "
        f"scores {best_score:.6f} (recorded {result.best_model_score:.6f})"
        f"; checkpoint steps kept {mgr.all_steps()}, best "
        f"{mgr.best_step()} (score {meta['score']:.6f}); its outputs equal "
        f"the saver's best model's {same} [{card}]")
    steps = sorted(result.score_vs_epoch)
    want_kept = sorted(set(steps[-2:]) | {result.best_model_epoch})
    if (not same or abs(best_score - result.best_model_score)
            > 1e-6 * abs(result.best_model_score)
            or mgr.best_step() != result.best_model_epoch
            or mgr.all_steps() != want_kept
            or not np.isfinite(list(result.score_vs_epoch.values())).all()):
        raise SystemExit(
            f"chip_smoke: 20c early stopping / checkpoints failed: same "
            f"outputs {same}, best score {best_score} vs "
            f"{result.best_model_score}, steps {mgr.all_steps()} (want "
            f"{want_kept}), best step {mgr.best_step()}")


def graph_phase(card: str) -> dict:
    """Phase 20: 20a-20c; returns K1's and K2's launches on its main
    paths by kernel-line name."""
    import tempfile

    t0 = time.perf_counter()
    launches = dag_training_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        launches["paged_attention"] = dag_serving_phase(card, tmp)
        solver_card_cpu_check(card, tmp)
        hvp_and_double_backward_check(card)
        early_stopping_checkpoint_check(card, tmp)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")
    return launches


# phase 21: host-fed training and the data runtime. (a) is
# bench.py:bench_flagship's model and token pool fed from a DL4JTOK1
# file, (b) bench.py:bench_hostfed_cnn's shape, (c) the CLI's train /
# test / predict on LeNet-5.
HOSTFED_VOCAB, HOSTFED_T, HOSTFED_B, HOSTFED_POOL = 64, 512, 16, 1024
HOSTFED_WIDTH, HOSTFED_LAYERS, HOSTFED_HEADS = 2048, 8, 16
HOSTFED_K = 64          # scan steps a window: the pool is one window
# host-fed epochs: the first alone (one window, held against the first
# fit_scan window), the other two through one fit_stream call (two
# windows with no host sync between them: the second's upload is queued
# while the first's replays run), held against fit_scan's second and
# third windows
HOSTFED_EPOCHS = 3
HOSTFED_RESIDENT = 2    # device-resident windows timed after the capture
HOSTFED_DENSE_STEPS = 4  # eager fit steps, K1 against dense attention
HOSTFED_QUEUE = 8
CNN_B, CNN_K = 1024, 64
CNN_EPOCHS = 2          # host-fed epochs for each sync_each_window value
CNN_RESIDENT = 2
CNN_REAL_STEPS = 120
CLI_EXAMPLES, CLI_BATCH, CLI_TEST = 2048, 256, 1024
CLI_PREDICT_TOL = 1e-4


def _one_hot_ingest(vocab, dtype):
    """``fit_stream``'s device-side ingest for token ids: [K, B, T] ids
    -> one-hot [K, B, V, T] at ``dtype``, as a comparison against an
    ``arange`` on the ids' device (no range check, so no host read)."""
    def ingest(ids):
        classes = torch.arange(vocab, device=ids.device)[:, None]
        return (ids.long()[..., None, :] == classes).to(dtype)
    return ingest


@contextlib.contextmanager
def _no_host_sync(what: str):
    """Run the block under ``torch.cuda.set_sync_debug_mode("error")``:
    any host synchronisation in it is fatal."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: {what} synced the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _net_state(net):
    """What a train step moves: params, layer and updater state,
    iteration and the generators' states (the host one and
    ``fit_scan``'s per-layer ones)."""
    clone = lambda t: {k: clone(v) for k, v in t.items()} if isinstance(
        t, dict) else (t.clone() if isinstance(t, torch.Tensor) else t)
    return (clone(net.params), clone(net.state), clone(net.updater_state),
            net.iteration, net._gen.get_state(),
            [g.get_state() for g in net._scan_generators()])


def _set_net_state(net, saved) -> None:
    params, state, upd, it, gen, scan_gens = saved
    net.params, net.state, net.updater_state = params, state, upd
    net.iteration = it
    net.params_version += 1
    net._gen.set_state(gen)
    for g, st in zip(net._scan_generators(), scan_gens):
        g.set_state(st)


def _hostfed_conf(use_flash=None):
    """21a's flagship conf at bf16 compute; ``use_flash=False`` gives
    the dense-attention twin (None: the auto rule, K1 at T=512)."""
    from deeplearning4j_tpu_torch.models.zoo import transformer_lm_flagship

    K = HOSTFED_K
    conf = transformer_lm_flagship(
        vocab=HOSTFED_VOCAB, width=HOSTFED_WIDTH, n_layers=HOSTFED_LAYERS,
        n_heads=HOSTFED_HEADS, lr=2e-4, warmup_steps=K,
        total_steps=(HOSTFED_EPOCHS + HOSTFED_RESIDENT + 1) * K)
    for c in conf.confs:
        c.compute_dtype = "bfloat16"
        if use_flash is not None and hasattr(c.layer, "use_flash"):
            c.layer.use_flash = use_flash
    return conf


def hostfed_k1_check() -> None:
    """21a's K1 at the phase's own shape (B=16, H=16, T=512, dh=128,
    bf16, causal: 256 (batch, head) tiles), forward and backward held
    against the plain version on the f32 upcast at FLASH_TOL's bf16
    limits; the planted faults at this shape must fail the limits of
    both dtypes; a rerun bit for bit. Comparison launches: the counts
    are put back."""
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        flash_attention,
        flash_attention_reference,
    )

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    t, dh, bf16 = HOSTFED_T, HOSTFED_WIDTH // HOSTFED_HEADS, torch.bfloat16
    before = (flash_attention.launches, flash_attention.bwd_launches)
    q, k, v, do = _flash_case(gen, t, dh, bf16, dev, b=HOSTFED_B,
                              h=HOSTFED_HEADS)
    out, grads = _k1_grads(q, k, v, do, True)
    qf, kf, vf = (a.float().requires_grad_(True) for a in (q, k, v))
    ref = flash_attention_reference(qf, kf, vf, True)
    ref_grads = torch.autograd.grad(ref, (qf, kf, vf), do.float())
    ref = ref.detach()
    name = (f"21a: flash_attention B={HOSTFED_B}, H={HOSTFED_HEADS}, "
            f"T={t}, dh={dh}, causal, bfloat16")
    _flash_hold(name, bf16, out, grads, ref, ref_grads)
    flash_fault_readings(q, k, v, do, ref, ref_grads)
    flash_rerun_check(name, q, k, v, do, True)
    flash_attention.launches, flash_attention.bwd_launches = before


def hostfed_dense_check(card: str, net, toks: np.ndarray) -> None:
    """21a's K1 against dense attention through the net:
    HOSTFED_DENSE_STEPS eager ``fit`` steps on the pool's first batches
    from the net's params, on K1 and on a ``use_flash=False`` twin; the
    losses agree within PARITY_RTOL at bf16, K1 launched 8 times a step
    each way on the K1 net and never on the twin. The params' max
    difference is reported, not held (at bf16 Adam's normalized step
    turns rounding-level gradient differences into lr-sized ones). The
    caller restores the net's state; the counts are put back."""
    from deeplearning4j_tpu_torch.nn.layers.attention import flash_attention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    V, B, T = HOSTFED_VOCAB, HOSTFED_B, HOSTFED_T
    ids = toks.reshape(-1, B, T + 1)[:HOSTFED_DENSE_STEPS]
    hot = np.eye(V, dtype=np.float32)[ids].transpose(0, 1, 3, 2)
    batches = [(h[..., :-1], h[..., 1:]) for h in hot]
    dense = MultiLayerNetwork(_hostfed_conf(False), device=DEVICE).init()
    dense.set_params_flat(net.params_flat())
    before = (flash_attention.launches, flash_attention.bwd_launches)
    k_loss, k_wall = _train(net, batches)
    fwd = flash_attention.launches - before[0]
    bwd = flash_attention.bwd_launches - before[1]
    d_loss, d_wall = _train(dense, batches)
    dense_launches = flash_attention.launches - before[0] - fwd
    flash_attention.launches, flash_attention.bwd_launches = before
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_loss, d_loss))
    pdiff = float((net.params_flat() - dense.params_flat()).abs().max())
    log(f"21a: K1 vs dense attention, {HOSTFED_DENSE_STEPS} eager fit "
        f"steps at B={B}, T={T}, bf16 from one set of params: K1 losses "
        f"{[f'{x:.6f}' for x in k_loss]}, dense "
        f"{[f'{x:.6f}' for x in d_loss]}; max rel diff {rel:.3e} (tol "
        f"{PARITY_RTOL['bfloat16']}); max |param diff| {pdiff:.3e} (a "
        f"report); K1 launches fwd {fwd}, bwd {bwd}, dense twin's "
        f"{dense_launches}; s/step K1 {[round(w, 4) for w in k_wall]}, "
        f"dense {[round(w, 4) for w in d_wall]} [{card}]")
    want = HOSTFED_LAYERS * HOSTFED_DENSE_STEPS
    if (not rel <= PARITY_RTOL["bfloat16"] or fwd != want or bwd != want
            or dense_launches != 0
            or not all(np.isfinite(k_loss + d_loss))):
        raise SystemExit(
            f"chip_smoke: phase 21a K1 vs dense failed: rel {rel}, K1 "
            f"launches {fwd}/{bwd} (want {want}), dense twin's "
            f"{dense_launches}")
    del dense
    torch.cuda.empty_cache()


def hostfed_flagship_phase(card: str, tmp: str) -> dict:
    """21a: the width-2048 flagship, bf16 compute, trained host-fed:
    the Markov pool written once as a DL4JTOK1 file, read by
    ``TokenSequenceFileIterator`` inside ``NativeAsyncDataSetIterator``
    (the C++ ring) into ``fit_stream`` with a one-hot ingest. First K1
    at the phase's shape against its plain version
    (``hostfed_k1_check``) and through the net against dense attention
    (``hostfed_dense_check``). Then, from one starting state, three
    ``fit_scan`` windows on the stacked pool (the reference; the second
    and third timed as the device-resident rate), and host-fed: one
    epoch alone, then two epochs through one ``fit_stream`` call
    (``MultipleEpochsIterator``, two windows, host syncs fatal), each
    bit-identical to the matching ``fit_scan`` window (scores and
    params). K1 8 times a step forward and backward; one captured step
    for the window key; finite, falling scores. Host-fed against
    device-resident tokens/s (JAX's ratio, bench.py:550), the data wait
    and peak memory are reported. Returns K1's launches over the
    host-fed epochs."""
    from deeplearning4j_tpu_torch.datasets.iterator import (
        MultipleEpochsIterator,
    )
    from deeplearning4j_tpu_torch.datasets.markov import (
        make_chain,
        sample_tokens,
    )
    from deeplearning4j_tpu_torch.datasets.streaming import (
        TokenSequenceFileIterator,
        write_token_file,
    )
    from deeplearning4j_tpu_torch.native_rt import (
        NativeAsyncDataSetIterator,
        native_available,
    )
    from deeplearning4j_tpu_torch.native_rt.lib import NativeLib
    from deeplearning4j_tpu_torch.nn.layers.attention import flash_attention
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    earlier = NativeLib._instance is not None   # an earlier phase's load
    t0 = time.perf_counter()
    if not native_available():
        raise SystemExit("chip_smoke: phase 21a: the native data library "
                         "did not build (native_available() is False)")
    log("21a: native data library (native/dl4j_native.cpp, g++ -O3) "
        + ("loaded at its first use in an earlier phase" if earlier else
           f"built and loaded in {time.perf_counter() - t0:.2f} s"))
    hostfed_k1_check()
    V, T, B, K = HOSTFED_VOCAB, HOSTFED_T, HOSTFED_B, HOSTFED_K
    net = MultiLayerNetwork(_hostfed_conf(), device=DEVICE).init()
    chain, _, floor = make_chain(V, seed=0)
    toks = sample_tokens(chain, HOSTFED_POOL, T, seed=1)
    path = os.path.join(tmp, "flagship_tokens.bin")
    write_token_file(path, toks, vocab=V)
    ingest = _one_hot_ingest(V, torch.bfloat16)

    def stream(epochs=1):
        base = TokenSequenceFileIterator(path, batch_size=B)
        if epochs > 1:
            base = MultipleEpochsIterator(epochs, base)
        return NativeAsyncDataSetIterator(base, queue_size=HOSTFED_QUEUE)

    saved = _net_state(net)
    hostfed_dense_check(card, net, toks)
    _set_net_state(net, saved)
    # the same window stacked by hand, resident on the device
    ids = torch.as_tensor(toks.reshape(-1, B, T + 1)[:K], device=DEVICE)
    feats, labels = ingest(ids[..., :-1]), ingest(ids[..., 1:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = [net.fit_scan(feats, labels).cpu()]     # captures the step
    capture_s = time.perf_counter() - t0
    want_params = [net.params_flat()]
    res_rates = []
    for _ in range(HOSTFED_RESIDENT):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want.append(net.fit_scan(feats, labels).cpu())
        res_rates.append(K * B * T / (time.perf_counter() - t0))
    want_params.append(net.params_flat())
    _set_net_state(net, saved)
    del saved
    flash_attention.launches = flash_attention.bwd_launches = 0
    wait0 = net.train_telemetry.data_wait_s
    torch.cuda.reset_peak_memory_stats()
    host_rates, host_scores, same, same_params = [], [], [], []
    for epochs, ref in ((1, 0), (HOSTFED_EPOCHS - 1, -1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the two-window call runs with host syncs made fatal: a
        # window's upload, ingest and replays must not wait on the card
        with (_no_host_sync("21a: two host-fed windows") if epochs > 1
              else contextlib.nullcontext()):
            scores = net.fit_stream(stream(epochs), scan_steps=K,
                                    ingest=ingest, ingest_labels=ingest)
        host_scores.append(scores.cpu())      # syncs the call
        host_rates.append(epochs * K * B * T / (time.perf_counter() - t0))
        same.append(bool(torch.equal(host_scores[-1], want[ref])))
        same_params.append(bool(torch.equal(net.params_flat(),
                                            want_params[ref])))
    del want_params
    peak = torch.cuda.max_memory_allocated()
    data_wait = net.train_telemetry.data_wait_s - wait0
    fwd, bwd = flash_attention.launches, flash_attention.bwd_launches
    runner = net.train_graphs
    first, last = host_scores[0], host_scores[-1]
    finite = all(bool(torch.isfinite(s).all()) for s in host_scores)
    falling = float(last.mean()) < float(first.mean())
    steps = HOSTFED_EPOCHS * K
    res = float(np.median(res_rates))
    log(f"21a: flagship width {HOSTFED_WIDTH} x {HOSTFED_LAYERS}, bf16, "
        f"{net.num_params() / 1e6:.1f} M params, B={B}, T={T}, pool "
        f"{HOSTFED_POOL} from a DL4JTOK1 file through the C++ ring "
        f"(queue {HOSTFED_QUEUE}) into fit_stream(scan_steps={K}), one-hot "
        f"ingest; bit-identical to fit_scan on the same stacked windows "
        f"(one window alone, then the last of two windows in one call): "
        f"scores {same}, params {same_params}; mean score of fit_scan's "
        f"windows {[round(float(s.mean()), 6) for s in want]}, host-fed "
        f"{[round(float(s.mean()), 6) for s in host_scores]} (entropy "
        f"floor {floor:.4f}); the two-window call under "
        f"set_sync_debug_mode('error') without a host sync; K1 launches "
        f"fwd {fwd}, bwd {bwd} over {steps} steps; {len(runner)} graph, "
        f"{runner.captures} capture (the capture window "
        f"{capture_s:.2f} s); host-fed {[round(r, 1) for r in host_rates]}"
        f" tokens/s (one window; two windows in one call), device-"
        f"resident {[round(r, 1) for r in res_rates]} tokens/s: ratios "
        f"{[round(r / res, 4) for r in host_rates]} (against the median); "
        f"data wait {data_wait:.4f} s over {HOSTFED_EPOCHS} epochs; peak "
        f"memory {peak / 2**30:.3f} GiB [{card}]")
    want_k1 = HOSTFED_LAYERS * steps
    if (not all(same) or not all(same_params) or fwd != want_k1
            or bwd != want_k1 or len(runner) != 1 or runner.captures != 1
            or not finite or not falling):
        raise SystemExit(
            f"chip_smoke: phase 21a failed: identical {same} (params "
            f"{same_params}), K1 {fwd}/{bwd} (want {want_k1}), graphs "
            f"{len(runner)} ({runner.captures} captures), finite {finite}, "
            f"falling {falling}")
    del net, feats, labels, ids
    torch.cuda.empty_cache()
    return {"flash_attention": fwd, "flash_attention_bwd": bwd}


def _cifar_rows(path: str, n: int) -> np.ndarray:
    """bench.py:bench_hostfed_cnn's template task as u8 pixels, written
    as one CIFAR-binary file; returns the labels."""
    rng = np.random.default_rng(0)
    templates = rng.normal(size=(10, 3, 32, 32)).astype(np.float32)
    cls = rng.integers(0, 10, n)
    x = 0.5 * templates[cls] + rng.normal(size=(n, 3, 32, 32))
    xu8 = np.clip((x + 4.0) * (255.0 / 8.0), 0, 255).astype(np.uint8)
    rows = np.concatenate([cls.astype(np.uint8)[:, None],
                           xu8.reshape(n, -1)], axis=1)
    rows.tofile(path)
    return cls


def hostfed_cnn_phase(card: str, tmp: str) -> None:
    """21b: ``wide_cnn(lr=0.005)`` at bf16 fed host-side as
    bench.py:bench_hostfed_cnn: 65,536 u8 images (201 MB) in one
    CIFAR-binary file, ``CifarBinStreamIterator`` inside
    ``NativeAsyncDataSetIterator`` into ``fit_stream(scan_steps=64)``
    with a u8 -> bf16 ingest, ``sync_each_window`` False and then True;
    scores finite and falling, one captured step for the key; host-fed
    against device-resident examples/s for both. Then bench.py's real
    patches (the CIFAR-binary fixture) through ``fit`` for 120 steps,
    the held-out accuracy reported. No TPU kernel runs here: the convs
    have three or more input channels (cuDNN, as JAX's are ``lax.conv``
    outside Pallas)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fixtures import (
        real_patches_cifar,
    )
    from deeplearning4j_tpu_torch.datasets.streaming import (
        CifarBinStreamIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import wide_cnn
    from deeplearning4j_tpu_torch.native_rt import NativeAsyncDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    B, K = CNN_B, CNN_K
    conf = wide_cnn(lr=0.005)
    for c in conf.confs:
        c.compute_dtype = "bfloat16"
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    path = os.path.join(tmp, "train_batch.bin")
    cls = _cifar_rows(path, K * B)
    mib = os.path.getsize(path) / 2**20

    def ingest(a):
        return a.to(torch.bfloat16) * (8.0 / 255.0) - 4.0

    raw = np.fromfile(path, np.uint8).reshape(K, B, 3073)
    feats_dev = torch.as_tensor(raw[..., 1:].reshape(K, B, 3, 32, 32),
                                device=DEVICE)
    del raw
    labels_dev = torch.as_tensor(np.eye(10, dtype=np.float32)[cls].reshape(
        K, B, 10), device=DEVICE)
    first = net.fit_scan(ingest(feats_dev), labels_dev).cpu()   # captures
    res_rates = []
    for _ in range(CNN_RESIDENT):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(net.fit_scan(ingest(feats_dev), labels_dev)[-1])
        res_rates.append(K * B / (time.perf_counter() - t0))
    del feats_dev, labels_dev
    host = {}
    last = None
    for sync in (False, True):
        rates = []
        for epoch in range(CNN_EPOCHS):
            it = NativeAsyncDataSetIterator(
                CifarBinStreamIterator([path], batch_size=B),
                queue_size=HOSTFED_QUEUE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (_no_host_sync("21b: a host-fed epoch")
                  if not sync and epoch == 1 else contextlib.nullcontext()):
                scores = net.fit_stream(it, scan_steps=K, ingest=ingest,
                                        sync_each_window=sync)
            last = scores.cpu()
            rates.append(K * B / (time.perf_counter() - t0))
        host[sync] = rates
    runner = net.train_graphs
    finite = bool(torch.isfinite(first).all() and torch.isfinite(last).all())
    falling = float(last.mean()) < float(first.mean())
    res = float(np.median(res_rates))
    ratios = {s: float(np.median(r)) / res for s, r in host.items()}
    log(f"21b: wide_cnn(lr=0.005), bf16, B={B}, {K * B} u8 images "
        f"({mib:.1f} MiB) in one CIFAR-binary file through the C++ ring "
        f"into fit_stream(scan_steps={K}); mean score first window "
        f"{float(first.mean()):.6f}, last {float(last.mean()):.6f}; "
        f"device-resident {[round(r, 1) for r in res_rates]} examples/s; "
        f"host-fed sync_each_window=False "
        f"{[round(r, 1) for r in host[False]]} (ratio "
        f"{ratios[False]:.4f}), True {[round(r, 1) for r in host[True]]} "
        f"(ratio {ratios[True]:.4f}; the second False epoch under "
        f"set_sync_debug_mode('error') without a host sync); "
        f"{len(runner)} graph, {runner.captures} capture [{card}]")
    if (not finite or not falling or len(runner) != 1
            or runner.captures != 1):
        raise SystemExit(
            f"chip_smoke: phase 21b failed: finite {finite}, falling "
            f"{falling}, graphs {len(runner)} ({runner.captures} captures)")
    del net
    torch.cuda.empty_cache()
    rtr, rte = real_patches_cifar(n_test=40, seed=0)
    pad = lambda y: np.pad(np.asarray(y), ((0, 0), (0, 8)))  # noqa: E731
    rnet = MultiLayerNetwork(wide_cnn(lr=0.01), device=DEVICE).init()
    rds = DataSet(rtr.features, pad(rtr.labels))
    t0 = time.perf_counter()
    for _ in range(CNN_REAL_STEPS):
        rnet.fit(rds)
    out = rnet.output(rte.features).float().cpu().numpy()
    fit_s = time.perf_counter() - t0
    acc = float((out.argmax(1) == np.asarray(rte.labels).argmax(1)).mean())
    log(f"21b: wide_cnn(lr=0.01) f32 on the real-patches fixture "
        f"({rtr.num_examples()} train, {rte.num_examples()} held out), "
        f"{CNN_REAL_STEPS} fit steps in {fit_s:.2f} s: held-out accuracy "
        f"{acc:.4f} (a report; bench.py gates 0.9) [{card}]")
    if not np.isfinite(out).all():
        raise SystemExit("chip_smoke: phase 21b: non-finite outputs on "
                         "the real patches")


def cli_phase(card: str, tmp: str) -> int:
    """21c: the CLI in process (``cli.driver.main``), so the launch
    counters are read: ``train`` of the zoo's f32 ``lenet5()`` conf JSON
    on 2048 MNIST images at batch 256, one epoch, on the card, K3
    (``conv_taps`` on its CUDA-core kernel, ``conv_taps_f32``) launched
    on conv1 at every step; ``test`` and ``predict`` on the zip;
    ``predict --raw`` on the card against the CPU's from the same zip
    (argmax identical, probabilities within 1e-4); ``train --mesh dp=2``
    exits naming ROADMAP item 11. Both packages' ``mnist`` source gives
    flat [N, 784] rows, which a conv conf does not take, so the images
    go in as an ``.npz`` of [N, 1, 28, 28]. Returns K3's launches over
    the card's train, test and predict."""
    import io

    from deeplearning4j_tpu_torch.cli.driver import main as cli
    from deeplearning4j_tpu_torch.datasets.mnist import mnist_dataset
    from deeplearning4j_tpu_torch.models.zoo import lenet5
    from deeplearning4j_tpu_torch.nn.layers.convolution import conv_taps

    conf = os.path.join(tmp, "lenet5.json")
    with open(conf, "w") as f:
        f.write(lenet5().to_json())
    data = {}
    for name, train, n in (("train", True, CLI_EXAMPLES),
                           ("test", False, CLI_TEST)):
        ds = mnist_dataset(train=train, num_examples=n, as_image=True)
        data[name] = os.path.join(tmp, f"mnist_{name}.npz")
        np.savez(data[name], features=ds.features, labels=ds.labels)
    model = os.path.join(tmp, "lenet5.zip")
    conv_taps.launches = conv_taps.mma_launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc_train = cli(["train", "--conf", conf, "--input", data["train"],
                        "--output", model, "--batch-size", str(CLI_BATCH),
                        "--epochs", "1", "--device", DEVICE])
    train_s = time.perf_counter() - t0
    train_launches, train_mma = conv_taps.launches, conv_taps.mma_launches
    with contextlib.redirect_stdout(out):
        rc_test = cli(["test", "--model", model, "--input", data["test"],
                       "--device", DEVICE])
        preds = {}
        for side, dev in (("card", DEVICE), ("cpu", "cpu")):
            if side == "cpu":
                card_launches = conv_taps.launches
            preds[side] = os.path.join(tmp, f"probs_{side}.csv")
            rc = cli(["predict", "--model", model, "--input", data["test"],
                      "--raw", "--has-labels", "--output", preds[side],
                      "--device", dev])
            if rc != 0:
                raise SystemExit(f"chip_smoke: phase 21c: predict on {dev} "
                                 f"returned {rc}")
    text = out.getvalue()
    acc_lines = [ln for ln in text.splitlines() if "Accuracy" in ln]
    p_card = np.loadtxt(preds["card"], delimiter=",", ndmin=2)
    p_cpu = np.loadtxt(preds["cpu"], delimiter=",", ndmin=2)
    diff = float(np.abs(p_card - p_cpu).max())
    same_argmax = bool((p_card.argmax(1) == p_cpu.argmax(1)).all())
    try:
        cli(["train", "--conf", conf, "--input", data["train"], "--output",
             os.path.join(tmp, "mesh.zip"), "--mesh", "dp=2",
             "--device", DEVICE])
        mesh_msg = None
    except SystemExit as e:
        mesh_msg = str(e)
    steps = -(-CLI_EXAMPLES // CLI_BATCH)
    log(f"21c: cli train lenet5 (f32) on {CLI_EXAMPLES} MNIST images, "
        f"batch {CLI_BATCH}, 1 epoch: rc {rc_train} in {train_s:.2f} s, K3 "
        f"launches {train_launches} ({train_mma} on the tensor cores) over "
        f"{steps} steps and the final score's forward; test rc {rc_test} "
        f"({acc_lines[0].strip() if acc_lines else 'no accuracy line'}); "
        f"predict --raw card vs CPU on {len(p_card)} images: argmax "
        f"identical {same_argmax}, max |prob diff| {diff:.3e} (tol "
        f"{CLI_PREDICT_TOL}); K3 launches over train, test and the card's "
        f"predict {card_launches}; train --mesh dp=2: {mesh_msg!r} "
        f"[{card}]")
    if (rc_train != 0 or rc_test != 0 or train_launches != steps + 1
            or train_mma != 0 or not same_argmax
            or not diff <= CLI_PREDICT_TOL or not acc_lines
            or mesh_msg is None or "item 11" not in mesh_msg):
        raise SystemExit(
            f"chip_smoke: phase 21c failed: train rc {rc_train} with K3 "
            f"{train_launches} (want {steps + 1}, tensor cores "
            f"{train_mma}), test rc {rc_test}, argmax identical "
            f"{same_argmax}, prob diff {diff}, --mesh {mesh_msg!r}")
    return card_launches


def hostfed_phase(card: str) -> dict:
    """Phase 21: 21a-21c in a temp dir removed afterwards; returns K1's
    and K3's launches on their paths by kernel-line name."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_hostfed_")
    try:
        launches = hostfed_flagship_phase(card, tmp)
        hostfed_cnn_phase(card, tmp)
        launches["conv_taps_f32"] = cli_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 22: decode without Python, and the embedding trainers
# ---------------------------------------------------------------------------

# 22a: the serving net's decode step at f32, B=1, in the AOTInductor
# runner; 128 teacher-forced tokens held at 1e-4 against rnn_time_step
RUNNER_STEPS = 128
RUNNER_TOL = 1e-4
RUNNER_MLP_TOL = 1e-5
RUNNER_MLP_FITS = 30

# the run stage: a process that loads the veneer by file path, never
# imports torch, and drives the runner on the card
RUNNER_CHILD = r"""
import importlib.util, json, sys, time
import numpy as np
veneer, lib, work, platform = sys.argv[1:5]
spec = importlib.util.spec_from_file_location("aoti_veneer", veneer)
aoti = importlib.util.module_from_spec(spec)
spec.loader.exec_module(aoti)
jobs = json.load(open(work + "/jobs.json"))
client = aoti.NativeClient(platform, 0, library=lib)
report = {"platform": client.platform(),
          "device_count": client.device_count()}
np.save(work + "/mlp_out.npy",
        client.run(work + "/mlp.pt2", np.load(work + "/mlp_x.npy")))
xs = np.load(work + "/xs.npy")
z = np.load(work + "/cache0.npz")
cache0 = [z["arr_%d" % i] for i in range(len(z.files))]
prog = aoti.CompiledProgram(client, work + "/decode.pt2")
for name, frozen in jobs["passes"]:
    # frozen: None, or the cache leaf (one layer's filled) fed back as it
    # came in at every step instead of the step's new one (the planted
    # fault: that layer's cache never grows)
    cache = [aoti.buffer_from_host(client, c) for c in cache0]
    logits, lat = [], []
    for x in xs:
        t0 = time.perf_counter()
        inp = aoti.buffer_from_host(client, x)
        res = prog.execute([inp] + cache)
        logits.append(res[0].to_host())
        lat.append(time.perf_counter() - t0)
        inp.destroy()
        res[0].destroy()
        if frozen is not None:
            res[1 + frozen].destroy()
            res[1 + frozen] = cache[frozen]
        for i, b in enumerate(cache):
            if i != frozen:
                b.destroy()
        cache = res[1:]
    for b in cache:
        b.destroy()
    np.save(work + "/" + name + "_logits.npy", np.stack(logits))
    report[name + "_ms"] = [t * 1e3 for t in lat]
prog.destroy()
client.close()
report["torch_imported"] = "torch" in sys.modules
print(json.dumps(report))
"""


def _runner_mlp(dev):
    """JAX's native-serving MLP (6-16-3, tanh, softmax/MCXENT, lr 0.1)
    after 30 ``fit`` steps on 96 seeded examples; returns (net, the
    8-example probe)."""
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    rng = np.random.default_rng(0)
    cls = rng.integers(0, 3, 96)
    x = rng.normal(loc=cls[:, None], size=(96, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[cls]
    conf = (NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .list()
            .layer(0, L.DenseLayer(n_in=6, n_out=16, activation="tanh"))
            .layer(1, L.OutputLayer(n_in=16, n_out=3, activation="softmax",
                                    loss_function=LossFunction.MCXENT))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    for _ in range(RUNNER_MLP_FITS):
        net.fit(x, y)
    return net, x[:8]


def runner_phase(card: str, tmp: str) -> None:
    """22a: build ``csrc/aoti_runner.cpp`` with g++ against the torch
    wheel's libtorch (in a thread, beside the packages' compiles);
    AOT-compile the serving net's decode step (f32, B=1, window 2048,
    width 1024 x 8 layers); in a child process that loads the veneer by
    path and never imports torch, run 128 teacher-forced tokens through
    it with the cache on the card. Gate: every step's logits within 1e-4
    of ``rnn_time_step`` on the same inputs and the greedy ids
    identical; a second pass that feeds layer 0's initial ``filled``
    back at every step (the planted fault) must fail that. The 6-16-3
    MLP's package within 1e-5 of ``output``; a LeNet export must raise
    naming K3. Prints the native and ``rnn_time_step`` p50 ms per token,
    the build and compile seconds and the package bytes."""
    from deeplearning4j_tpu_torch.cuda_build import KernelNotExportable
    from deeplearning4j_tpu_torch.models.zoo import lenet5
    from deeplearning4j_tpu_torch.native_rt import aoti
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    built = {}

    def build():
        t0 = time.perf_counter()
        try:
            built["lib"] = aoti.build_runner()
        except Exception as e:  # re-raised below, in this thread
            built["error"] = e
        built["s"] = time.perf_counter() - t0

    builder = threading.Thread(target=build, name="aoti runner build")
    builder.start()
    net = _serving_net("float32")
    mod, x0, template, tree = aoti.decode_step_module(net)
    paths = tree.paths()
    leaf = next(i for i, p in enumerate(paths) if p[-1] == "filled")
    t0 = time.perf_counter()
    aoti.serialize_for_native(mod, x0, *[torch.as_tensor(t) for t in
                                         template],
                              package_path=os.path.join(tmp, "decode.pt2"),
                              device=DEVICE)
    compile_s = time.perf_counter() - t0
    pkg_bytes = os.path.getsize(os.path.join(tmp, "decode.pt2"))

    mlp, probe = _runner_mlp(DEVICE)
    aoti.export_network_for_native(mlp, probe,
                                   os.path.join(tmp, "mlp.pt2"))
    mlp_ref = mlp.output(probe).cpu().numpy()
    np.save(os.path.join(tmp, "mlp_x.npy"), probe)
    np.savez(os.path.join(tmp, "cache0.npz"), *template)
    with open(os.path.join(tmp, "jobs.json"), "w") as f:
        json.dump({"passes": [["decode", None], ["frozen", leaf]]}, f)

    lenet = MultiLayerNetwork(lenet5(), device=DEVICE).init()
    try:
        aoti.export_network(lenet, np.zeros((8, 1, 28, 28), np.float32))
        lenet_msg = None
    except KernelNotExportable as e:
        lenet_msg = str(e)

    # the reference, timed once no compile shares the host
    rng = np.random.default_rng(22)
    ids = rng.integers(0, VOCAB, RUNNER_STEPS)
    xs = np.zeros((RUNNER_STEPS, 1, VOCAB, 1), np.float32)
    xs[np.arange(RUNNER_STEPS), 0, ids, 0] = 1.0
    np.save(os.path.join(tmp, "xs.npy"), xs)
    net.rnn_clear_previous_state()
    ref, ref_ms = [], []
    for x in xs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.append(net.rnn_time_step(x).cpu().numpy())
        ref_ms.append((time.perf_counter() - t0) * 1e3)
    ref = np.stack(ref)
    builder.join()
    if "error" in built:
        raise SystemExit(f"chip_smoke: 22a: the runner did not build: "
                         f"{built['error']}")
    lib, build_s = built["lib"], built["s"]
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", RUNNER_CHILD, aoti.__file__, str(lib), tmp,
         DEVICE], capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise SystemExit(f"chip_smoke: 22a: the runner process failed "
                         f"({child.returncode}):\n{child.stderr[-3000:]}")
    report = json.loads(child.stdout.strip().splitlines()[-1])
    got = {n: np.load(os.path.join(tmp, f"{n}_logits.npy"))
           for n in ("decode", "frozen")}
    errs = {n: float(np.abs(g.reshape(ref.shape) - ref).max())
            for n, g in got.items()}
    same_ids = {n: bool((g.reshape(ref.shape).argmax(2)
                         == ref.argmax(2)).all()) for n, g in got.items()}
    mlp_err = float(np.abs(np.load(os.path.join(tmp, "mlp_out.npy"))
                           - mlp_ref).max())
    native_p50 = float(np.median(report["decode_ms"]))
    ref_p50 = float(np.median(ref_ms))
    log(f"22a: runner built in {build_s:.2f} s beside the compiles (g++, "
        f"libtorch of torch "
        f"{torch.__version__}); decode step AOT-compiled in "
        f"{compile_s:.1f} s, package {pkg_bytes} bytes; "
        f"{len(template)} cache leaves; runner process "
        f"({report['platform']}, {report['device_count']} device(s)) "
        f"{child_s:.1f} s, torch imported there {report['torch_imported']}")
    log(f"22a: {RUNNER_STEPS} teacher-forced tokens at B=1, window "
        f"{WINDOW}, width {WIDTH} x {N_LAYERS}: max |native - "
        f"rnn_time_step| {errs['decode']:.3e} (tol {RUNNER_TOL}), greedy "
        f"ids identical {same_ids['decode']}; planted fault (layer "
        f"{paths[leaf][0]}'s initial filled fed back): max err "
        f"{errs['frozen']:.3e}, ids identical {same_ids['frozen']}; "
        f"native p50 {native_p50:.3f} "
        f"ms per token (upload, step, logits to host) against "
        f"rnn_time_step's {ref_p50:.3f} ms (ratio "
        f"{native_p50 / ref_p50:.3f}); MLP 6-16-3 max err {mlp_err:.3e} "
        f"(tol {RUNNER_MLP_TOL}); LeNet export: {lenet_msg!r} [{card}]")
    fault_caught = errs["frozen"] > RUNNER_TOL or not same_ids["frozen"]
    if (report["torch_imported"] or not errs["decode"] <= RUNNER_TOL
            or not same_ids["decode"] or not fault_caught
            or not mlp_err <= RUNNER_MLP_TOL or lenet_msg is None
            or "K3" not in lenet_msg):
        raise SystemExit(
            f"chip_smoke: 22a failed: torch imported "
            f"{report['torch_imported']}, decode err {errs['decode']} ids "
            f"{same_ids['decode']}, frozen fault caught {fault_caught}, "
            f"MLP err {mlp_err}, LeNet refusal {lenet_msg!r}")


# 22b: bench.py's bench_w2v configuration (raw_sentences() x 10, NS)
W2V_CONF = dict(layer_size=100, window=5, min_word_frequency=5,
                batch_size=2048, seed=3, subsampling=1e-3)
W2V_TIMED = 3
W2V_SIM_CLOSE = 0.4    # bench.py: sim(day, night) above this
W2V_SIM_GAP = 0.2      # and this far above sim(day, money)
W2V_CARD_CPU_TOL = 1e-5


def _w2v_sims(w2v) -> tuple:
    return (w2v.similarity("day", "night"), w2v.similarity("day", "money"))


def _graph_keys(runner) -> list:
    return sorted(runner.keys(), key=str)


# batches of the gated HS chunk: from the tables as built, where the
# update is well conditioned (a reordering of the CPU's own sums moves
# 8 batches by ~3e-7)
W2V_HS_CHECK_BATCHES = 8


def _w2v_chunk(dev, kind, model, tables, cen, ctx, lrs, lmax, draws=None,
               shuffle=False):
    """``len(lrs)`` batches of ``kind`` on copies of ``tables`` on
    ``dev`` through the step functions; ``shuffle`` reorders each
    batch's pairs (the same update, summed in another order). Returns
    the tables on the host."""
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import (
        hs_batch,
        ns_batch,
    )

    t0, t1 = (t.to(dev).clone() for t in tables)
    hs_tables = [t.to(dev) for t in model._hs_tables(lmax)] if (
        kind == "hs") else None
    for i in range(len(lrs)):
        c, x = cen[i], ctx[i]
        if shuffle:
            p = torch.randperm(len(c), generator=torch.Generator()
                               .manual_seed(i))
            c, x = c[p], x[p]
        c, x, lr = c.to(dev), x.to(dev), lrs[i].to(dev)
        if kind == "ns":
            ns_batch(t0, t1, model._neg_table.to(dev), c, x, lr,
                     draws[i].to(dev))
        else:
            hs_batch(t0, t1, *hs_tables, c, x, lr)
    return t0.cpu(), t1.cpu()


def _w2v_check_pairs(model, sents, s_n: int, seed: int = 5):
    """``s_n`` full batches of one code-length class (the first batch's)
    mined from the first 20000 sentences: (centers, contexts) [S, B]
    int32 on the host, and the class's l_max."""
    flat, seq = model._tokenize_corpus(sents[:20000])
    batches = list(model._mine_pairs_from_ids(
        flat, seq, np.random.default_rng(seed)))
    lmax = batches[0][2]
    sel = [b for b in batches if b[2] == lmax][:s_n]
    if len(sel) < s_n:
        raise SystemExit(f"chip_smoke: 22b: {len(sel)} batches of class "
                         f"{lmax}, {s_n} needed")
    return (torch.as_tensor(np.stack([b[0] for b in sel]).astype(np.int32)),
            torch.as_tensor(np.stack([b[1] for b in sel]).astype(np.int32)),
            lmax)


def _max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def w2v_card_cpu_check(card: str, ns, hs, hs_built, sents) -> None:
    """The same chunk on the card and on the CPU from the same tables,
    pairs, learning rates and negatives' draws, each table within
    W2V_CARD_CPU_TOL (the card's atomic scatter-adds sum in another
    order): a full NS chunk from the trained NS tables, and an HS chunk
    of W2V_HS_CHECK_BATCHES from the HS tables as built. A full HS chunk
    from the trained HS tables is a report beside the CPU's own
    reordered sums: there the batched update is ill-conditioned (a hot
    Huffman node's summed update can cross the logit clamp), so
    summation order alone moves it by O(1)."""
    errs = {}
    for name, kind, model, tables, s_n in (
            ("NS", "ns", ns, (ns.syn0, ns.syn1neg), ns._DISPATCH_CHUNK),
            ("HS, as built", "hs", hs, hs_built, W2V_HS_CHECK_BATCHES),
            ("HS, trained", "hs", hs, (hs.syn0, hs.syn1),
             hs._DISPATCH_CHUNK)):
        cen, ctx, lmax = _w2v_check_pairs(model, sents, s_n)
        lrs = torch.linspace(0.025, 0.01, len(cen))
        draws = None
        if kind == "ns":
            draws = torch.randint(0, model._neg_table.shape[0],
                                  (len(cen), cen.shape[1], model.negative),
                                  generator=torch.Generator().manual_seed(9))
        args = (kind, model, tables, cen, ctx, lrs, lmax, draws)
        cpu = _w2v_chunk("cpu", *args)
        errs[name] = _max_diff(_w2v_chunk(DEVICE, *args), cpu)
        moved = float((cpu[0] - tables[0].cpu()).abs().max())
        extra = ""
        if name == "HS, trained":
            own = _max_diff(_w2v_chunk("cpu", *args, shuffle=True), cpu)
            extra = (f"; the CPU against itself with each batch's pairs "
                     f"reordered {own:.3e}: a report, no bar")
        log(f"22b: card vs CPU, {name}: {len(cen)} batches of "
            f"{cen.shape[1]}{', l_max ' + str(lmax) if kind == 'hs' else ''}"
            f": max |card - CPU| {errs[name]:.3e} over both tables (tol "
            f"{W2V_CARD_CPU_TOL}; syn0 moved by {moved:.3e}){extra} "
            f"[{card}]")
    gated = {k: v for k, v in errs.items() if k != "HS, trained"}
    if not all(e <= W2V_CARD_CPU_TOL for e in gated.values()):
        raise SystemExit(f"chip_smoke: 22b card vs CPU failed: {gated}")


def _replay_vs_eager(model, kind, cen, ctx, lrs, lmax):
    """One full chunk through ``model._run_chunk`` (a replay of the graph
    ``fit`` captured for its shape: new indices and learning rates
    copied into its static inputs, the model's tables updated in place,
    negatives from the registered generator) against the eager body on
    copies of the same tables, the generator's state put back between
    the two so that both draw the same negatives. Returns (max table
    difference, replayed loss, eager loss, how far syn0 moved)."""
    names = ("syn0", "syn1") if kind == "hs" else ("syn0", "syn1neg")
    tables = tuple(getattr(model, n).clone() for n in names)
    start = tables[0].clone()
    state = model._gen.get_state()
    key, captures = (kind, *cen.shape, lmax), model.graphs.captures
    if key not in model.graphs:
        raise SystemExit(f"chip_smoke: 22b: no graph {key} to replay")
    got = model._run_chunk(kind, cen, ctx, lrs, lmax)
    if model.graphs.captures != captures:
        raise SystemExit(f"chip_smoke: 22b: {key} captured again")
    model._gen.set_state(state)
    if kind == "hs":
        want = model.hs_chunk(cen, ctx, lrs, lmax, tables)
    else:
        want = model.ns_chunk(cen, ctx, lrs, None, tables)
    after = [getattr(model, n) for n in names]
    moved = float((after[0] - start).abs().max())
    return _max_diff(after, tables), float(got), float(want), moved


@contextlib.contextmanager
def _deterministic_algorithms():
    """``torch.use_deterministic_algorithms`` on (warnings only), so that
    ``index_add_`` on the card sums in a sorted order, not by atomics."""
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def w2v_replay_check(card: str, ns, hs, hs_built, sents) -> None:
    """A full chunk replayed through ``_run_chunk`` (the path ``fit``
    takes), against the eager chunk body on the same tables, pairs,
    learning rates and negatives, each table within W2V_CARD_CPU_TOL and
    the chunk losses as close. The pairs and learning rates differ from
    those the graphs were captured with, so stale static inputs fail, as
    does a generator the replay does not advance (the eager draws would
    differ). NS: ``fit``'s own graph from the trained NS tables. HS: the
    same 64 batches from the tables as built move syn0 by ~0.3, and the
    atomic scatter-adds' order alone then moved the tables by 1.1e-5 on
    an H100 (replay against eager on ``fit``'s graph); so the HS graph is
    captured again through ``_run_chunk`` under deterministic
    algorithms (``index_add_`` in sorted order) on other pairs, and
    replayed and run eagerly under them from the tables as built. Run
    after ``w2v_card_cpu_check``: it drops the HS model's graphs and
    leaves its tables changed."""
    errs = {}
    for name, kind, model in (("NS, trained", "ns", ns),
                              ("HS, as built, deterministic", "hs", hs)):
        cen, ctx, lmax = _w2v_check_pairs(model, sents,
                                          model._DISPATCH_CHUNK, seed=6)
        cen, ctx = cen.to(DEVICE), ctx.to(DEVICE)
        lrs = torch.linspace(0.02, 0.005, len(cen), device=DEVICE)
        if kind == "ns":
            err, got, want, moved = _replay_vs_eager(model, kind, cen, ctx,
                                                     lrs, lmax)
        else:
            c0, x0, l0 = _w2v_check_pairs(model, sents,
                                          model._DISPATCH_CHUNK, seed=7)
            if l0 != lmax:
                raise SystemExit(f"chip_smoke: 22b: classes {l0}, {lmax}")
            model.graphs.drop()
            with _deterministic_algorithms():
                model._run_chunk(kind, c0.to(DEVICE), x0.to(DEVICE),
                                 torch.full((len(c0),), 0.025,
                                            device=DEVICE), lmax)
                model.syn0.copy_(hs_built[0])
                model.syn1.copy_(hs_built[1])
                err, got, want, moved = _replay_vs_eager(
                    model, kind, cen, ctx, lrs, lmax)
        errs[name] = (err, abs(got - want) / max(1.0, abs(want)))
        log(f"22b: replay vs eager, {name}: {len(cen)} batches of "
            f"{cen.shape[1]}, key {(kind, *cen.shape, lmax)}: max |replay "
            f"- eager| {err:.3e} over both tables, chunk loss {got:.6f} "
            f"vs {want:.6f} (tol {W2V_CARD_CPU_TOL}; syn0 moved by "
            f"{moved:.3e}) [{card}]")
    if not all(e <= W2V_CARD_CPU_TOL and d <= W2V_CARD_CPU_TOL
               for e, d in errs.values()):
        raise SystemExit(f"chip_smoke: 22b replay vs eager failed: {errs}")


def w2v_phase(card: str) -> None:
    """22b: bench.py's ``bench_w2v`` (``raw_sentences() * 10``, layer
    100, window 5, min_word_frequency 5, batch 2048, subsampling 1e-3,
    NS 5, seed 3): one warm ``fit`` (it captures the chunk graphs), then
    3 timed epochs with host syncs fatal; words/s, the captures per chunk
    shape; bench.py's gate sim(day, night) > 0.4 and 0.2 above sim(day,
    money). Then one HS epoch: both code-length classes captured, the
    tables finite, each class's chunk loss falling over the pass; its
    similarities as a report. Then card against CPU
    (``w2v_card_cpu_check``) and replay against eager
    (``w2v_replay_check``)."""
    from deeplearning4j_tpu_torch.datasets.fixtures import raw_sentences
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

    sents = raw_sentences() * 10
    n_words = sum(len(s.split()) for s in sents)
    ns = Word2Vec(use_hierarchic_softmax=False, negative=5, device=DEVICE,
                  **W2V_CONF)
    t0 = time.perf_counter()
    ns.build_vocab_from(sents)
    vocab_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ns.fit(sents)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    caps = (ns.graphs.captures, _graph_keys(ns.graphs))
    rates = []
    for _ in range(W2V_TIMED):
        t0 = time.perf_counter()
        with _no_host_sync("22b: a Word2Vec epoch"):
            ns.fit(sents)
        torch.cuda.synchronize()
        rates.append(n_words / (time.perf_counter() - t0))
    close, far = _w2v_sims(ns)
    losses = [d["ns"] for d in ns.pass_losses]
    quality = close > W2V_SIM_CLOSE and close - far > W2V_SIM_GAP
    log(f"22b: Word2Vec NS at bench_w2v's configuration, {len(sents)} "
        f"sentences / {n_words} words, vocab {ns.vocab.num_words()} (built "
        f"in {vocab_s:.2f} s): warm fit {warm_s:.2f} s with "
        f"{caps[0]} captures {caps[1]} ("
        f"{[round(v, 3) for v in ns.graphs.seconds.values()]} s); "
        f"{W2V_TIMED} timed epochs with host syncs fatal: words/s median "
        f"{float(np.median(rates)):.1f}, spread "
        f"[{min(rates):.1f}, {max(rates):.1f}]; captures after them "
        f"{ns.graphs.captures}; pass losses {[round(x, 4) for x in losses]};"
        f" sim(day, night) {close:.4f}, sim(day, money) {far:.4f} (gate "
        f"> {W2V_SIM_CLOSE} and {W2V_SIM_GAP} apart: {quality}) [{card}]")
    if (not quality or ns.graphs.captures != caps[0]
            or not np.isfinite(losses).all()):
        raise SystemExit(
            f"chip_smoke: 22b Word2Vec NS failed: sims {close}, {far}, "
            f"captures {caps[0]} then {ns.graphs.captures}, losses {losses}")

    hs = Word2Vec(use_hierarchic_softmax=True, negative=0, device=DEVICE,
                  **W2V_CONF)
    hs.build_vocab_from(sents)
    hs_built = (hs.syn0.clone(), hs.syn1.clone())
    t0 = time.perf_counter()
    hs.fit(sents)
    torch.cuda.synchronize()
    hs_s = time.perf_counter() - t0
    by_class = collections.defaultdict(list)
    for key, loss in hs.chunk_losses:
        if key[1] == hs._DISPATCH_CHUNK:
            by_class[key[3]].append(float(loss))
    falling = {k: v[-1] < v[0] for k, v in by_class.items()}
    finite = bool(torch.isfinite(hs.syn0).all()
                  and torch.isfinite(hs.syn1).all())
    keys = _graph_keys(hs.graphs)
    close, far = _w2v_sims(hs)
    log(f"22b: one HS epoch in {hs_s:.2f} s ({n_words / hs_s:.1f} words/s),"
        f" graphs {keys}; chunk losses by class (first, last of "
        f"{[len(v) for v in by_class.values()]} full chunks): "
        f"{ {k: (round(v[0], 4), round(v[-1], 4)) for k, v in by_class.items()} }"
        f", falling {falling}; tables finite {finite}; pass loss "
        f"{hs.pass_losses[-1]['hs']:.4f}; report: sim(day, night) "
        f"{close:.4f}, sim(day, money) {far:.4f} [{card}]")
    if (len(keys) != 2 or len({k[3] for k in keys}) != 2 or not finite
            or len(falling) != 2 or not all(falling.values())):
        raise SystemExit(
            f"chip_smoke: 22b HS epoch failed: graphs {keys}, finite "
            f"{finite}, falling {falling}")
    w2v_card_cpu_check(card, ns, hs, hs_built, sents)
    w2v_replay_check(card, ns, hs, hs_built, sents)


def _topic_corpus(n=300, seed=0):
    """tests/test_glove_paragraph.py's day/night corpus."""
    rng = np.random.default_rng(seed)
    day = ["day", "sun", "light", "morning", "noon"]
    night = ["night", "moon", "dark", "evening", "star"]
    return [" ".join(rng.choice(day if rng.random() < 0.5 else night,
                                size=6)) for _ in range(n)], day, night


# DeepWalk on the two 6-cliques at twice the JAX test's walks and
# epochs (20 and 2): at its size the criterion holds for some seeds of
# the port's initial tables and not others; at this size it holds with
# a wide margin (tests/test_torch_port_deepwalk.py, on the CPU)
DW_WALKS_PER_VERTEX, DW_EPOCHS = 40, 4


def embedding_rest_phase(card: str) -> None:
    """22c: GloVe, ParagraphVectors and DeepWalk on the card, each held
    to the JAX tests' own criteria at their sizes: GloVe's last pass
    loss below half its first and sim(day, sun) above sim(day, moon);
    PV's document vectors nearer within a topic than across it, and
    ``infer_vector`` nearer its own topic's document, with hierarchical
    softmax and with negative sampling; DeepWalk's two 6-cliques (at
    twice the test's walks and epochs), mean similarity within a clique
    above the mean across the bridge."""
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    from deeplearning4j_tpu_torch.nlp.glove import Glove
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import (
        ParagraphVectors,
    )

    t0 = time.perf_counter()
    corpus, day, night = _topic_corpus()
    glove = Glove(layer_size=16, window=4, min_word_frequency=5, epochs=40,
                  learning_rate=0.05, x_max=10.0, seed=1, device=DEVICE)
    glove.fit([s.split() for s in corpus])
    g_ok = (glove.losses[-1] < glove.losses[0] * 0.5
            and glove.similarity("day", "sun")
            > glove.similarity("day", "moon"))
    glove_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    docs, labels = [], []
    for i in range(30):
        topic, prefix = (day, "DAY") if i % 2 == 0 else (night, "NIGHT")
        docs.append(" ".join(rng.choice(topic, size=12)))
        labels.append(f"{prefix}_{i}")
    pv = ParagraphVectors(layer_size=24, epochs=30, learning_rate=0.05,
                          seed=5, device=DEVICE)
    pv.fit_documents(docs, labels)

    def cos(a, b):
        return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)
                                     + 1e-12))

    same = cos(pv.doc_vector("DAY_0"), pv.doc_vector("DAY_2"))
    cross = cos(pv.doc_vector("DAY_0"), pv.doc_vector("NIGHT_1"))
    rng = np.random.default_rng(2)
    docs = [" ".join(rng.choice(day, size=10)) for _ in range(10)]
    docs += [" ".join(rng.choice(night, size=10)) for _ in range(10)]
    labels = [f"D{i}" for i in range(10)] + [f"N{i}" for i in range(10)]
    infer = {}
    for mode, kw in (("hs", {}), ("ns", dict(use_hierarchic_softmax=False,
                                             negative=3))):
        m = ParagraphVectors(layer_size=24, epochs=40, seed=8, device=DEVICE,
                             **kw)
        m.fit_documents(docs, labels)
        v = m.infer_vector("sun light noon day")
        infer[mode] = (cos(v, m.doc_vector("D0")), cos(v, m.doc_vector("N0")),
                       bool(np.isfinite(v).all()))
    p_ok = same > cross and all(d > n and f for d, n, f in infer.values())
    pv_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    g = Graph(12)
    for base in (0, 6):
        for i in range(6):
            for j in range(i + 1, 6):
                g.add_edge(base + i, base + j)
    g.add_edge(0, 6)
    dw = DeepWalk(vector_size=32, window_size=4,
                  walks_per_vertex=DW_WALKS_PER_VERTEX, epochs=DW_EPOCHS,
                  seed=7, batch_size=512, learning_rate=0.05, device=DEVICE)
    dw.initialize(g)
    dw.fit(walk_length=20)
    in_clique = float(np.mean([dw.similarity(i, j) for i in range(6)
                               for j in range(i + 1, 6)]))
    across = float(np.mean([dw.similarity(i, j + 6) for i in range(1, 6)
                            for j in range(1, 6)]))
    dw_s = time.perf_counter() - t0
    log(f"22c: GloVe (16-d, 40 epochs, {len(corpus)} sentences) in "
        f"{glove_s:.2f} s: loss {glove.losses[0]:.4f} -> "
        f"{glove.losses[-1]:.4f}, sim(day, sun) "
        f"{glove.similarity('day', 'sun'):.4f} vs sim(day, moon) "
        f"{glove.similarity('day', 'moon'):.4f}: {g_ok}; ParagraphVectors "
        f"in {pv_s:.2f} s: DAY_0~DAY_2 {same:.4f} vs DAY_0~NIGHT_1 "
        f"{cross:.4f}; infer_vector('sun light noon day') vs D0 / N0 "
        f"(HS, NS): {infer}: {p_ok}; DeepWalk (two 6-cliques, 32-d, "
        f"{DW_WALKS_PER_VERTEX} walks a vertex, {DW_EPOCHS} epochs) in "
        f"{dw_s:.2f} s: within {in_clique:.4f} vs across {across:.4f} "
        f"[{card}]")
    if not (g_ok and p_ok and in_clique > across):
        raise SystemExit(
            f"chip_smoke: 22c failed: GloVe {g_ok}, PV {p_ok} ({same}, "
            f"{cross}, {infer}), DeepWalk {in_clique} vs {across}")


def embedding_phase(card: str) -> None:
    """Phase 22: the runner (22a) in a temp dir removed afterwards, then
    the embedding trainers (22b, 22c)."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runner_")
    try:
        runner_phase(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t1 = time.perf_counter()
    w2v_phase(card)
    t2 = time.perf_counter()
    embedding_rest_phase(card)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s (22a {t1 - t0:.1f} s, "
        f"22b {t2 - t1:.1f} s, 22c {time.perf_counter() - t2:.1f} s)")


def main() -> int:
    card = device_phase()
    build_phase()
    kernels = kernel_phase()
    kernels += paged_chunk_kernel_phase()
    kernels += paged_verify_kernel_phase()
    flash, k1_long_ms = flash_kernel_phase()
    kernels += flash
    conv = conv_kernel_phase()
    kernels += conv
    launches = training_parity_phase(card)
    launches.update(training_long_phase(card, k1_long_ms))
    launches["paged_attention"] = serving_phase(card)
    fused_decode_phase(card)
    for name, n in decode_phases(card).items():
        launches[name] += n
    t13 = time.perf_counter()
    launches["paged_attention_chunk"] = prefix_phases(card)
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    launches["paged_attention_verify"] = spec_phase(card)
    log(f"phase 14: {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    fault_phase(card)
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    launches["paged_attention"] += gateway_phase(card)
    log(f"phase 16: {time.perf_counter() - t16:.1f} s")
    t17 = time.perf_counter()
    tenancy_kv_phase(card)
    log(f"phase 17: {time.perf_counter() - t17:.1f} s")
    fleet_phase(card)
    k3_ms = {k["name"]: k["ms"] for k in conv}
    launches["conv_taps"] = lenet_phase(card, k3_ms["conv_taps"])
    launches["conv_taps_f32"] = lenet_phase(card, k3_ms["conv_taps_f32"],
                                            "float32")
    lenet_parity_phase(card)
    for name, n in rest_of_layers_phase(card).items():
        launches[name] += n
    for name, n in graph_phase(card).items():
        launches[name] += n
    for name, n in hostfed_phase(card).items():
        launches[name] += n
    embedding_phase(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
