#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--report PATH]

Phases, each of which fails the run (non-zero exit) when it fails:

  0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
  1. the CUDA kernels built anew from ``src/repro_torch/csrc`` (one nvcc
     per source, all at once), timed; ``-Xptxas -v``'s registers and
     spills per kernel.  The flash library's wgmma kernels must not spill
     nor have their wgmma serialised, and its SASS (``cuobjdump -sass``)
     must hold HGMMA (wgmma) and UTMALDG (TMA loads), and the library
     must hold the mma.sync kernels at the 7 tile widths in bf16 and f16
     and the column-group kernels past head dim 256 (bf16, f16, f32); the
     chunk_scan kernels at 64 channels in f32 and bf16 may not spill, the
     library must hold them at 64 and 128 channels and the channel-block
     kernel past 128, in f32, bf16 and f16, and its SASS
     must hold TF32 HMMA (its products on the tensor cores); no
     ``fed_agg`` or ``pairwise_dist`` kernel may spill, and the
     pairwise_dist library's SASS must hold TF32 HMMA (the tiled Gram).
     The tiles added for the kernels' whole domain (flash_mma_kernel off
     bf16 at 32, flash_f32_kernel off 32, 64, 80 and 128, the wide
     kernels, chunk_scan at 128 channels and past, f16) have their
     registers and spills printed, not gated;
  2. ``fed_agg`` against its plain version on the card, max abs error: one
     segment, and two segments in one launch (C in 64, 9, 1 beside C2 in
     0, 1, 4, 8), both base alignments, ``out`` aliasing ``base``; a bf16
     stack and a transposed-view stack (cast once by the wrapper) against
     the plain version over the cast;
  3. ``pairwise_dist_sq`` against its plain version (in float64), error
     over max(D, 1), at M in 1, 2, 8, 9, 65, 66, 130 (the few-rows design
     up to 8 rows, the tiled one above), as one stack and in the
     leading-row form (row 0 from its own pointer) against the plain
     version over the concatenation; on rows a quarter of a TF32 spacing
     off TF32 numbers (one TF32 pass errs by 2^-11 of D there); close rows
     (ref + 1e-3 randn) at phase 5's limit; a bf16 and a transposed-view
     stack against the plain version over the cast; two calls on one
     input must be bit-equal, and one call at M = 2 must launch exactly
     one kernel (profiler);
  4. the main path: ``repro_torch.fl_constellation_sim.main`` runs
     asyncfleo-hap with MNIST_CNN at full width (N = 206,922), S = 40,
     J = 30, b = 32, 3 epochs, IID shards of the example's synthetic data.
     ``fed_agg`` must launch once per epoch step (bank and carry in one
     launch); the host-side history must equal a CPU run of the port on
     the same inputs; the last accuracy must be above 0.10;
  5. the grouping path: ``GroupingState.observe_orbit`` through
     ``pairwise_dist_sq`` on each orbit's rows of a bank trained from the
     main path's final model, against the plain route: the same groups;
  6. timings at the main path's shapes, in a process of their own
     (kernel time from the profiler's device trace over 200 calls, which
     must hold each call's kernels, inputs cycled through more than the
     50 MB L2; CUDA events and the host clock beside it): eq. 14 over
     bank and carry in one launch beside two one-segment calls, the plain
     version and two ``torch.addmv`` (bound 17.3 us), each segment alone,
     the whole grouping call ``dist_to_ref``, ``pairwise_dist_sq`` at 2
     and 65 rows beside its plain version and ``torch.cdist`` and at M
     from 4 to 130 (the few-rows design up to 8, the tiled one from 9),
     the one-CTA floors; then the warm 3-epoch wall time and a
     ``torch.profiler`` table of the top device ops;
  7. ``flash_attention`` against its plain version on the card: the JAX
     package's kernel sweep (S = 200 and KV = 1 included; causal, window
     48 and non-causal; f32 and bf16), a strided-view case, the serving
     path's prefill shape (B 4, S 2048, H 32, KV 8, hd 128, bf16, causal
     and window 512), hubert-xlarge's (B 4, S 2048, H = KV = 16, hd 80,
     bf16, non-causal), zamba2-2.7b's shared attention (B 4, S 2048, H =
     KV = 32, hd 80, bf16, causal), hd 80 under window 48, and S = 1000 at hd 64, 80
     and 128 (a ragged last K/V tile after the TMA rings wrap); the whole
     domain: head dims 8, 40, 96, 192 and 256 at S 200 (causal, window 48
     and non-causal, f32 and bf16), hd 36 in bf16 (element loads), B * H
     = 65,600 at hd 32 and 80 in f32 and bf16 (past grid.y), and hd 64
     bf16 views TMA cannot map; f16 on every mma.sync tile; past head dim
     256, hd 264, 300, 384 and 512 at S 1024 (causal, window 512) in f32,
     bf16 and f16, B * H = 65,600 at hd 300, and q, k, v of three dtypes
     (widened to f32, the output in q's).  Every case launches the kernel
     once, the column-group kernels exactly where hd > 256
     (``flash_attention.wide_launches``).  At the sweep's input spread the max abs error is within 1e-5
     (f32), 2e-2 (bf16) and 2.5e-3 (f16); every bf16 case, also at a
     spread of 2 that makes the softmax peaked, holds each element within
     2^-7 |want| + 2^-8 rms(want's row), every f16 one within 2^-10
     |want| + 2^-11 rms(want's row);
  8. model-level route parity: qwen3-4b at full width with 2 layers in
     f32, prefill logits through the kernel route against the plain route
     (2e-4), and 16 decode steps against the full forward (1e-4);
  9. the serving path: ``repro_torch.serve_decode.main`` at
     ``--full-width`` qwen3-4b (36 layers), B 4, a 2048-token prefill
     through the kernel, 32 greedy decode steps over a 2048-slot cache.
     ``flash_attention`` must launch exactly 36 times per prefill and the
     other kernels never, in the entry point's run and in the warm one;
     the logits must be finite.  Prefill wall, decode
     ms/token (warm), the device busy share and the top device ops of one
     prefill plus 4 decode steps (``PROFILED_STEPS``); the qwen3-4b
     weights are freed after it;
 10. ``flash_attention`` timed at the prefill shape (causal, window
     512), at hubert-xlarge's, at zamba2-2.7b's, and at head dims 96
     ([4, 2048, 32, 32, 96], Phi-3-mini's heads), 256 ([4, 2048, 16, 8,
     256], Gemma 2 9B's; also in f16) and 512 ([4, 2048, 16, 16, 512],
     the column-group kernel; 50 calls a timing, the backend SDPA picks
     printed), causal,
     beside its plain version, ``scaled_dot_product_attention`` (the
     library yardstick, never called by the port; with a boolean band mask
     for window 512) and its bound;
 11. ``chunk_scan`` against its plain version (the sequential recurrence)
     on the card: the JAX package's kernel sweep (three shapes, RWKV6 and
     Mamba2 modes, f32 and bf16), a zamba2-shaped Mamba2 case (H 40, K 64,
     V 128), a strided-view case, short and ragged chunks, the serving
     shape (B 4, T 2048, H 64, K = V = 64, chunk 128, bf16, RWKV6), every
     log-decay at the clamp (-1) at chunk 128 in both modes, where the TPU
     kernel's factorisation overflows, many chunks (T 2048, chunk 16: 128
     steps of the state pass), one chunk (T = chunk = 128) and V 192
     (three V tiles) in Mamba2 mode; then Mamba2 in zamba2's own call
     form (``models/mamba.block``'s: r the conv output's C columns
     broadcast over the heads, head stride 0; v its x columns, row stride
     5248; k = B dt; a scalar decay per head), at B 2 x 256 steps in f32
     and at the serving shape (B 4, T 2048, H 40, K 64, V 128, chunk 128)
     in bf16, each on the kernel's 16-byte load path and, with the conv
     output shifted by one element, on its element loads; the whole
     domain: (K, V, chunk, T) in (128, 64, 256, 512), (256, 64, 64, 256),
     (6, 10, 16, 64) and (96, 130, 32, 96) in both modes, f32 and bf16,
     and mamba2-2.7b's Mamba2 layers in the model's call form at the
     serving size (B 4, T 2048, H 80, K 128, V 64, chunk 256, bf16); past
     K 256: K 264, 300 and 512 x V 64 and 130, both modes, chunks of 64
     and 128, in f32, bf16 and f16, and every decay at the clamp at K 512;
     f16 at K 8 to 256; r, k, v of three dtypes (widened to f32, y in
     v's).  Every case launches the kernel once, the channel-block kernel
     exactly where K > 128 (``chunk_scan.wide_launches``).  f32: max abs error <= 5e-5 on y and the final state; bf16:
     every y element within 2^-7 |want| + 2^-8 rms(want's row), f16 within
     2^-10 |want| + 2^-11 rms(want's row), the state within 5e-5; all of
     it finite.  The
     distance to the plain version of the kernel's own decomposition
     (``chunk_scan_blocked_ref``, 3 TF32 passes) is printed beside it;
 12. model-level route parity: rwkv6-7b at full width with 2 layers,
     B 2 x 256 tokens (two chunks): f32 logits through the kernel route
     against the plain route (2e-4); 16 decode steps against the full
     forward in float64 (1e-4; the plain route: the kernel takes f32 and
     bf16), with the same comparison in f32 through the kernel and the
     plain route printed beside it.  In f32 the first positions are
     ill-conditioned at this width (a rank-1 WKV state under the per-head
     group norm, eps 64e-5, turns rounding of 1e-7 into logit differences
     of ~3e-4, whichever route computes the forward), so f32 does not
     gate;
 13. the serving path: ``repro_torch.serve_decode.main`` at
     ``--full-width`` rwkv6-7b (32 layers), B 4, a 2048-token prefill
     through ``chunk_scan``, 32 greedy decode steps over the recurrent
     state.  ``chunk_scan`` must launch exactly 32 times per prefill and
     the other kernels never; the logits must be finite.  The same numbers
     as phase 9, and the lowest in-chunk cumulative log-decay of the
     prefill's 32 layers (how close the JAX package's factorisation came
     to overflowing on this input);
 14. ``chunk_scan`` timed at rwkv6-7b's serving shape, at zamba2's and
     at mamba2-2.7b's ([4, 2048, 80, 128, 64], chunk 256; Mamba2, in the
     model's call form) and at K 512 ([4, 2048, 16, 512, 64], chunk 64,
     the channel-block kernel; its plain version by CUDA events around one
     call): the kernel (one launch a call)
     and the wrapper (every kernel of a call: the zeroing of its sync
     buffer too), beside its plain version and its bound both ways —
     bytes, which bound the tensor-core route, and operations at the f32
     FMA peak of the earlier design (no single PyTorch call computes the
     recurrence);
 15. hubert-xlarge at its published width (head dim 80) through
     ``registry.apply``: the kernel route against the plain route at 2
     layers in f32, B 2 x 300 frames (2e-4); then the 48-layer forward in
     bf16 over B 4 x 2048 frames, which must launch ``flash_attention``
     exactly 48 times and the other kernels never, and give finite
     logits;
 16. the event-driven path: ``repro_torch.fl_constellation_sim.main`` with
     ``--event-driven``, the README quickstart (asyncfleo-pipelined, 3
     rounds in flight, MNIST_CNN at full width, S = 40, 2 epochs, IID),
     then the same scheme with ``ps_channels=1`` through ``FLSimulation``
     with ``SimConfig(event_driven=True)``.  Each run must record 2
     epochs of finite accuracy, launch ``fed_agg`` once per epoch step
     (more on a fallback step, as phase 4), and give the host-side history
     of a CPU run of the port on the same inputs, each accuracy within one
     test sample of it and the final model within 1e-4; the quickstart must
     hold at least 2 rounds in flight.  Wall time (cold, then warm),
     events popped, rounds opened, the host segments and the card's busy
     share of one profiled warm run;
 17. the fault path: (a) the README's robustness smoke,
     ``repro_torch.fl_constellation_sim.main`` with ``--event-driven
     --dropout 0.2 --compute-spread 1.0 --staleness-fn poly``
     (asyncfleo-gs, MNIST_CNN at full width, S = 40, 2 epochs, IID);
     (b) asyncfleo-twohap for 4 epochs with every recovery axis of
     DESIGN.md §11 at once (burst loss with AIMD backoff, PS outages,
     energy budgets, fault-aware selection), which must show sink
     failovers, energy deferrals and failed transfers.  Each run must
     give a CPU run's host history, accuracy and final model (as phase
     16) and its whole ``rt.stats`` (every fault counter, printed) and
     launch ``fed_agg`` once per commit (more
     only on a fallback step).  (c) the quickstart with
     ``SimConfig(visibility="sparse")``: phase 16's host history,
     accuracy, final model and ``fed_agg`` launches; then the
     200-satellite ``hapring:4`` geometry over 3 days compiled dense and
     sparse, with equal windows (seconds,
     peak allocations and kept bytes of each compile).  Walls (cold, then
     warm) and the busy share of one profiled run of (a);
 18. Table II: the eight schemes of ``benchmarks/table2.py`` on the epoch
     loop through ``run_schemes`` (MNIST_CNN at full width, S = 40, 2
     epochs each, the paper's non-IID split, 3 days), each twice on the
     card (the second warm).  Each must record 2 finite accuracies and
     launch ``fed_agg`` once per epoch step (more only on a fallback
     step, as phase 4).  The four that no earlier phase runs on the card
     (fedisl-ideal, fedsat, fedhap, asyncfleo-twohap) must give the host
     history of a CPU run of the port (the four CPU runs at once, one
     process each), each accuracy within one test sample, the final
     model within 1e-4 and the same divergence groups; records, best
     accuracy, launches, walls and groups printed;
 19. observability: phase 16's quickstart with a ``Tracer`` and a
     ``DispatchProfiler(block=False)``, then ``block=True``, then no
     profiler.  Each run's history and final model must equal phase 16's
     bit for bit; the profiler's dispatches must equal ``fed_agg``'s
     launches, its triggers the commits (1.0 dispatch a trigger) and its
     cold dispatches those of phase 16's CPU run (traced and profiled);
     the Chrome and JSONL exports (per-PS tracks added) must validate
     and hold that CPU run's span and instant counts.  The step's
     host-dispatch seconds and device-inclusive seconds are printed
     beside each run's wall and phase 16's busy time;
 20. the stacked and legacy simulator paths: phase 4's configuration
     (asyncfleo-hap, 3 epochs), then asyncfleo-twohap with
     ``agg_timeout_s=120`` (stragglers carried), then fedsat (the legacy
     path's per-arrival EMA, one ``fed_agg`` a model), each through
     ``FLSimulation`` with ``use_fused_step=False`` and with
     ``use_model_bank=False`` beside the fused path, at full width on one
     workload.  Every run must launch ``fed_agg`` exactly as often as its
     path's code predicts (``predicted_launches``) and give the fused
     run's host rows (epoch, time, models, gamma, stale groups) and
     groups.  The stacked run's models and accuracies must be bit-equal to
     the fused run's.  The legacy run (another summation order): the first
     record's model within 1e-5 and its accuracy equal, the final model
     within 1e-4 (SGD amplifies the reordering from epoch to epoch), at
     most 40 final test predictions different and every accuracy within
     7 test samples.  A known-bad control, the legacy path with one update
     lost at the last record, must fail each of those three limits;
 21. the sweep engine: (a) 8 scenarios of the testbed at
     ``make_model(width=321)`` (N = 206,403), seed x strategy x link rate
     on the paper constellation, through ``run_scenarios`` sequentially,
     then batched in exact mode: per scenario the history, the final
     weights' bytes, the logical step counts and ``rt.stats`` must be
     equal, with fewer physical than logical steps; the vmap mode within
     1e-4 of exact; ``fed_agg`` on the rows of (3, N) and (4, N) stacks at
     N = 206,922 (odd rows only 8-byte aligned) bit-equal to aligned
     copies.  (b) 3 scenarios of the MNIST_CNN pool at full width through
     ``run_scenarios(trainer_factory=...)``: no batch key, so every step
     runs solo; batched bit-identical to sequential.  Walls and
     ``batcher.summary()`` printed;
 22. model-level route parity: zamba2-2.7b at full width with 2 groups
     (12 Mamba2 layers, the shared block twice) in f32, B 2 x 256 tokens
     (two chunks): kernel-route logits against the plain route (2e-4),
     and 16 decode steps against the full forward through both routes
     (1e-4), with the float64 figure printed beside them;
 23. the serving path of phase 9 at ``--full-width`` zamba2-2.7b (54
     Mamba2 layers, the shared attention block before every 6), B 4, a
     2048-token prefill, 32 decode steps over the Mamba2 states and a
     2048-slot KV cache a group: ``chunk_scan`` must launch exactly 54
     times a prefill, ``flash_attention`` exactly 9, the other kernels
     never; the same numbers as phase 9;
 24. model-level parity of the moe family in f32: (a) deepseek-v2-236b
     at full width cut to 2 layers (the dense MLA layer and one MoE
     layer; MLA's query low-rank branch), MoE capacity factor 64 (no
     token drops), B 2 x 256: 16 decode steps (the absorbed MLA over the
     latent cache) against the full forward (the expanded MLA) within
     1e-4, and the forward with ``q_chunks=4`` against one chunk within
     1e-5, the float64 figures printed beside both; (b) kimi-k2-1t-a32b at
     its reduced config (GQA attention over MoE layers): kernel-route
     logits against the plain route (2e-4), ``flash_attention`` launching
     exactly once a layer a prefill, 16 decode steps against the full
     forward (1e-4);
 25. serving deepseek-v2-236b at full width cut to 3 layers (1 dense, 2
     MoE; the published capacity factor 1.25) through
     ``repro_torch.serve_decode.serve``, B 4, a 2048-token prefill, 32
     decode steps over a 2048-slot latent cache: none of the four kernels
     may launch (MLA attends in plain PyTorch, as the JAX package does in
     XLA); the same numbers as phase 9, and the share of the prefill's
     token-to-expert assignments that each MoE layer drops;
 27. LM training: ``repro_torch.launch.train.train`` on qwen3-4b at full
     width cut to 2 layers in f32, 5 AdamW steps of B 4 x 2048 with remat
     off and on.  None of the four kernels may launch; the losses must be
     finite and the two runs equal (bit for bit, or within the stated
     bound); step walls and peak memory printed.  Then one step's f32
     gradient against the same step in float64 on the card at B 2 x 128,
     per leaf within 1e-3 of its max (set before the first run), a limit
     that the known-bad control (the attention output detached, what a
     kernel without a backward would give) must fail; and
     ``flash_attention`` and ``chunk_scan`` must refuse CUDA inputs that
     require grad, before launching;
 28. LM FL at the example's width: ``repro_torch.llm_federated_pretrain.
     run`` at its defaults (qwen3-4b reduced, 4 layers, d_model 256; 8
     satellites, seq 128, 32 sequences a satellite, J = 4, 3 epochs) on the
     card and in a CPU process of the port started before phase 24.  The
     host history fields must be equal; the final model (L2 distance over
     its norm) and every eval loss within limits set from sound and
     known-bad readings, which a lost-update control (the card's run with
     one selected model replaced by the global it trained from, at the
     last commit) must fail; ``fed_agg`` once a fused epoch,
     ``flash_attention`` once a layer an evaluation;
 29. LM FL at full width: the same ``run`` on qwen3-4b cut to 1 layer in
     f32 (N = 878,845,696), 4 satellites, 2 epochs: one ``fed_agg`` launch
     a fused epoch, each commit within 1e-5 of ``fed_agg_ref`` on the same
     bank and carry, ``flash_attention`` once an evaluation, no other
     kernel; the eval loss by epoch, wall, peak memory and the CUDA-event
     spans of training, aggregation and evaluation.  Then, in a process of
     their own, ``fed_agg`` timed over that bank and carry ([4 + 4, N])
     and over the bank alone, and ``flash_attention`` in f32 at the
     evaluator's shape ([16, 128, 32, 8, 128], causal), beside their plain
     versions, library calls and bounds;
 30. the mesh runtime (``launch/mesh.py``; one card, so one rank over
     NCCL or two processes over gloo): (a) phase 4's configuration for 2
     epochs through ``FLSimulation`` with ``SimConfig(mesh=
     make_data_mesh())`` in a one-rank NCCL group: its records equal phase
     4's first two, its model the bits of the unsharded run, one
     ``fed_agg`` launch a step; (b) the same as two processes sharing the
     card in a gloo group with CUDA tensors, each training half of the
     participants: phase 4's host history, the two ranks bit-equal,
     ``fed_agg`` once a fused epoch on each rank; in the first epoch each
     rank's trained rows bit-equal to the unsharded step's trained in the
     same row blocks and the aggregate within 1e-5 of it; the final model
     within 1e-4 of the unsharded run (30 SGD steps an epoch amplify the
     order of sums: 1.2e-5 at 2 epochs); (c) ``make_ep_moe_layer`` on one
     deepseek-v2-236b MoE layer at full width (15.1 GB of f32 expert
     weights) over 2 x 2048 tokens in a one-rank NCCL group at a capacity
     factor where nothing drops, against ``moe_ffn_reference`` within a
     derived tolerance (at most 1e-4 of max |y|); (d) ``make_fl_round`` on
     the qwen3-4b reduced loss (4 satellites, J = 2) against the same
     steps and eq. 14 written out, within 1e-5.  No other kernel launches
     on these paths; the phase's wall is printed;
 31. the dry-run tools (``launch/dryrun.py``, ``ep_dryrun.py``,
     ``fl_dryrun.py``; no kernel on their path): (a) ``dryrun_one`` on
     ``launch.train``'s step at one rank in phase 27's configuration, in a
     process of its own (a fake world of one rank): its argument bytes
     equal to those the card holds for the params, AdamW state and batch,
     its FLOPs to ``FlopCounterMode``'s count of one real step on the
     card, its predicted peak within 5 % of phase 27's measured peak
     (above what the process held before each run) for remat off and on,
     and the arguments alone (the known-bad control) outside it; (b)
     ``dryrun --arch qwen3-4b --shape train_4k`` with and without
     ``--multi-pod``, qwen3-4b prefill_32k, llama3-8b and internvl2-1b
     train_4k, deepseek-v2-236b prefill_32k with and without
     ``--multi-pod``, kimi-k2-1t-a32b prefill_32k, ``ep_dryrun --arch
     kimi-k2-1t-a32b`` and ``fl_dryrun`` over fake worlds of 256 and 512
     ranks, each its own process, all at once: each exits 0, prints its
     row and never initialises CUDA; each ``dryrun`` row's temp within
     0.5-2x the reference's (constants from its CPU run) and no ``view``,
     ``_unsafe_view``, ``flip``, ``index_put``, ``index_add`` or
     ``searchsorted`` replicated; (c) qwen3-4b train_4k and prefill_32k
     cut to one layer and deepseek-v2-236b prefill_32k to one lead and
     one MoE layer, beside (b): each collective of the residual stream's
     bytes or more paired with one of the reference program's, nothing
     replicated; the phase's wall is printed;
 33. SSM and hybrid training, after phase 31 (the kernel line stays last):
     (a) ``repro_torch.launch.train.train`` on zamba2-2.7b at full width
     cut to one group (6 Mamba2 layers and the shared attention block) and
     on rwkv6-7b cut to 2 layers, f32, 3 AdamW steps of B 4 x 2048 with
     remat off and on, through the plain chunked scan
     (``scan_ops._ChunkedScan``, which saves its operands and one state a
     chunk and recomputes a chunk at a time in its backward).  None of the
     four kernels may launch; the losses must be finite and the two runs
     equal (phase 27's rule); step walls and peak memory printed, beside
     the same run (remat off) through the form before.  (b) the
     bytes one ``chunked_scan`` call saves for its backward
     (``saved_tensors_hooks``) at zamba2's Mamba2 layer [4, 2048, 40, 64,
     128] and rwkv6-7b's [4, 2048, 64, 64, 64], chunk 128, f32: at most its
     operands' storages, T / chunk + 1 states and 1 MB; autograd's own
     graph of the same sub-block form printed beside it.  (c) one step's
     gradient at B 2 x 256 (two chunks), per leaf within 1e-3 of its max
     (phase 27's limit): through the chunked scan against through the
     sequential recurrence, both in float64, a limit that the known-bad
     control (the state handed between chunks detached in the scan's
     backward) must fail; zamba2's f32 gradient against float64 too.
     rwkv6-7b's f32 gradient against float64 is printed beside the same
     figure through the sub-block form under autograd's own graph (the
     form before): at this width it is ill-conditioned (phase 12);
 32. one JSON line of per-kernel numbers (the two LM kernels also at
     zamba2's shapes, as ``flash_attention:zamba2`` and
     ``chunk_scan:zamba2``, with phase 23's launches; past the widths one
     CTA holds, as ``flash_attention:wide_hd`` and ``chunk_scan:wide_k``
     at phase 10's and 14's shapes, with the column-group and
     channel-block launches counted on the serving paths (9, 13, 23, 25),
     hubert's forward (15) and the LM FL evaluators (28, 29); ``fed_agg:lm``
     and ``flash_attention:lm_eval`` at phase 29's shapes and
     launches).

The last three lines are that JSON line, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Without a card, or without the
repository beside it, it exits non-zero and prints no result.  A run
takes under 20 minutes on an H100 (its walls: PERF.md §5), most of the
spread in its host-bound phases (the CPU references of phases 4, 16-18
and 28, the profiler traces' processing on the host).
``--report PATH`` also writes every number of the run there as JSON,
with the seconds at which each phase started.
"""
import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN_N = 206922                     # MNIST_CNN's parameters, the main path's N
F32_EPS = 2.0 ** -24
L2_BYTES = 50 * 2 ** 20
FED_AGG_TOL = 1e-5                  # max abs error, outputs of order 1
PDIST_TOL = 1e-5                    # error / max(D, 1)
# max abs error of attention outputs of order 0.5, inputs randn * 0.5 (the
# JAX package's kernel sweep, tests/test_kernels.py): f32 only reorders
# sums; bf16 rounds the output
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2.5e-3}
# bf16, every element and every input spread: |got - want| <= 2^-7 |want|
# + 2^-8 rms(want's row).  The kernel and the plain version both compute
# in f32 and round once to bf16, so they differ by at most one bf16
# spacing (<= 2^-7 |want|); the row term covers elements near zero.
FLASH_BF16_REL, FLASH_BF16_ROW = 2.0 ** -7, 2.0 ** -8
# f16: the same form at f16's spacing, 2^3 finer than bf16's (10 stored
# mantissa bits to 7); its abs tolerance above is bf16's 2e-2 over 2^3
FLASH_F16_REL, FLASH_F16_ROW = 2.0 ** -10, 2.0 ** -11
HALF_FORMS = {"bfloat16": (FLASH_BF16_REL, FLASH_BF16_ROW),
              "float16": (FLASH_F16_REL, FLASH_F16_ROW)}
# input spreads: the sweep's 0.5 (scores of std 0.25, a near-uniform
# softmax, so each output is a mean over the keys) and 2.0 (scores of std
# about 4: a peaked softmax whose outputs move with any error in the
# scores' scale, the mask or the probabilities)
FLASH_SPREADS = (0.5, 2.0)
ROUTE_TOL = 2e-4                    # kernel vs plain route, model logits
DECODE_TOL = 1e-4                   # decode vs full forward, model logits
# MLA's q_chunks=4 vs one chunk, model logits in f32: the same products
# over fewer keys for the early chunks (the masked keys add exact zeros)
MLA_CHUNKS_TOL = 1e-5
PREFILL = dict(B=4, S=2048, H=32, KV=8, hd=128)   # the serving prefill
# hubert-xlarge's attention at its published width, over B 4 x 2048 frames
HUBERT_ATTN = dict(B=4, S=2048, H=16, KV=16, hd=80)
# zamba2-2.7b's shared attention block over the serving prefill
ZAMBA_ATTN = dict(B=4, S=2048, H=32, KV=32, hd=80)
# the kernels' whole domain beyond the serving shapes: flash head dims off
# 32, 64, 80 and 128 (phase 7), B * H past grid.y's 65,535 (B, S, H, KV,
# hd), and the prefill-sized timings of phase 10: Phi-3-mini's head dim 96
# (32 heads) and Gemma 2 9B's 256 (16 query heads, 8 KV heads)
WIDE_HEAD_DIMS = (8, 40, 96, 192, 256)
WIDE_BH = (1025, 16, 64, 8, 32)
PHI3_ATTN = dict(B=4, S=2048, H=32, KV=32, hd=96)
GEMMA2_ATTN = dict(B=4, S=2048, H=16, KV=8, hd=256)
# head dims past one CTA's tile (the column-group kernels, any dtype):
# checked at S 1024 causal and under window 512 (phase 7), B * H past
# grid.y at hd 300, and timed at [4, 2048, 16, 16, 512] bf16 causal
# (phase 10)
WIDER_HEAD_DIMS = (264, 300, 384, 512)
WIDER_BH = (1025, 16, 64, 8, 300)
WIDE_HD_ATTN = dict(B=4, S=2048, H=16, KV=16, hd=512)
HALF_HEAD_DIMS = (8, 40, 80, 96, 128, 160, 192, 256)   # f16's mma.sync tiles
# chunk_scan, max abs error of y and the final state in f32 (the JAX
# package's sweep atol, without its rtol = 0.1 slack), and of the f32 final
# state in every case (both sides widen the same bf16 inputs to f32)
SCAN_TOL = 5e-5
SCAN_SERVE = dict(B=4, T=2048, H=64, K=64, V=64, chunk=128)  # rwkv6-7b
# zamba2-2.7b's Mamba2 layers over the serving prefill (K = ssm_state, V =
# ssm_head_dim); the conv output's row holds x (H V), B (K) and C (K)
SCAN_ZAMBA = dict(B=4, T=2048, H=40, K=64, V=128, chunk=128)
# the scan's whole domain beyond the serving shapes, as (K, V, chunk, T):
# K 128 with chunks of 256, K 256, K and V off multiples of 4, V past two
# column tiles; and mamba2-2.7b's Mamba2 layers (d_state 128, head dim 64,
# 80 heads, chunk 256) over the serving prefill
WIDE_SCAN = ((128, 64, 256, 512), (256, 64, 64, 256), (6, 10, 16, 64),
             (96, 130, 32, 96))
SCAN_MAMBA2 = dict(B=4, T=2048, H=80, K=128, V=64, chunk=256)
# K past the 256-channel tiles (the kernel streams them in blocks): checked
# at T 256 in both modes, f32, bf16 and f16, chunks of 64 and 128 (phase
# 11), and timed at [4, 2048, 16, 512, 64] chunk 64 bf16 Mamba2 (phase 14)
WIDER_K = (264, 300, 512)
WIDER_K_V = (64, 130)
SCAN_WIDE_K = dict(B=4, T=2048, H=16, K=512, V=64, chunk=64)
F32_EXP_MAX = 88.72                 # log of the largest finite f32


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


T0 = time.perf_counter()
PHASE_STARTS = []                   # (seconds since start, phase heading)


# launches of the column-group and channel-block kernels on the main
# paths, by wrapper: a path sets the counts to 0 (``zero_counts``) just
# before its run and adds them here (``add_wide``) just after it
WIDE_ON_PATHS = {"flash_attention": 0, "chunk_scan": 0}


def zero_counts(wrappers) -> None:
    """Every wrapper's launch counts to 0, the wide kernels' too."""
    for w in wrappers:
        w.launches = 0
        if hasattr(w, "wide_launches"):
            w.wide_launches = 0


def add_wide(wrappers) -> dict:
    """Add the wide kernels' launches since ``zero_counts(wrappers)`` to
    ``WIDE_ON_PATHS``; returns them by wrapper."""
    got = {w.__name__: w.wide_launches for w in wrappers
           if hasattr(w, "wide_launches")}
    for name, n in got.items():
        WIDE_ON_PATHS[name] += n
    return got


def phase(msg: str) -> None:
    t = time.perf_counter() - T0
    PHASE_STARTS.append((round(t, 1), msg.split(":")[0]))
    print(f"# {msg} [{t:.1f} s]", flush=True)


def phase_walls(total_s: float) -> list:
    """[(phase heading, seconds from its heading to the next heading or
    the run's end)] in the order the phases ran (a heading is printed
    when its phase starts, but phase 1's once the build is done)."""
    ends = [t for t, _ in PHASE_STARTS[1:]] + [total_s]
    return [(name, max(end - t, 0.0))
            for (t, name), end in zip(PHASE_STARTS, ends)]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cycled_inputs(make, nbytes: int):
    """Enough copies of one input set (from ``make()``) that cycling
    through them streams more than twice the L2 cache: each launch finds
    its inputs cold, as the main path does."""
    return [make() for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]


TRACE_EDGE_S = 0.02    # idle card on each side of a trace window's edges
TRACES = {"taken": 0, "retaken": 0}    # time_device's, over the run


def time_device(torch, fn, sets, reps: int = 200, only=None,
                per_call=None):
    """Per call of ``fn`` over ``reps`` calls cycling through ``sets``:
    (device ms: the summed durations of the kernels it launched — of those
    whose name holds ``only``, if given — from the profiler's CUPTI trace;
    queue ms: CUDA events around the queued calls, which include the gaps
    when the host enqueues slower than the card runs; host ms: the wall
    time of one enqueue; device operations, kernels and copies, from the
    same trace).  The trace is the active step of a profiler schedule
    whose warm-up step runs the same ``reps`` calls first, so that
    neither edge of the recorded window falls on a counted call (a trace
    that starts or stops around them has come back one launch short).
    The profiler keeps a device record only if it starts and ends inside
    the window on the host's clock, to which the card's timestamps are
    converted, so each edge also lies ``TRACE_EDGE_S`` of idle card
    from the nearest call, more than one of phase 29's 11 ms ``fed_agg``
    launches: on one H100 host its traces held 9 of 10 of them three
    times running (``scripts/trace_edges.py`` compares the two margins).
    ``TRACES`` counts the traces taken and those taken again.
    ``per_call``, where given, is the number of those operations one call
    launches: a trace that does not hold exactly ``per_call * reps`` is
    taken again, and the run fails after three."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    end.record()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    queue = start.elapsed_time(end) / reps
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _step in range(2):          # warm-up, then recorded
                for i in range(reps):
                    fn(*sets[i % len(sets)])
                torch.cuda.synchronize()
                time.sleep(TRACE_EDGE_S)    # before the window's edge
                prof.step()
                time.sleep(TRACE_EDGE_S)    # and after it
        TRACES["taken"] += 1
        # the schedule's step marker spans the device too: not an op
        ops = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and not e.key.startswith("ProfilerStep")
               and (only is None or only in e.key)]
        count = sum(e.count for e in ops)
        if per_call is None or count == per_call * reps:
            break
        TRACES["retaken"] += 1
    else:
        fail(f"three profiler traces of {reps} calls held {count} device "
             f"operations" + (f" named {only!r}" if only else "")
             + f", not {per_call} a call: "
             f"{sorted((e.key[:60], e.count) for e in ops)}")
    dev_us = sum(e.self_device_time_total for e in ops)
    if dev_us <= 0:
        fail("the profiler recorded no device time for a timed kernel"
             + (f" named {only!r}; it saw "
                f"{sorted({e.key[:60] for e in prof.key_averages()})}"
                if only else ""))
    return dev_us / reps / 1e3, queue, host, count / reps


def hw():
    """The card's roofline constants: ``repro_torch.launch.mesh``'s (the
    H100 SXM5 80GB HBM3 data sheet at 700 W), importable once ``main``
    has put the repository's ``src`` on the path."""
    from repro_torch.launch import mesh
    return mesh


def bound_ms(nbytes: float, flops: float, peak=None):
    peak = hw().PEAK_FLOPS_F32 if peak is None else peak
    t_b = nbytes / hw().HBM_BW * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: the work this mask needs."""
    total = 0
    for q in range(Sq):
        hi = min(Sk, q + 1) if causal else Sk
        lo = max(0, q - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def top_device_ops(prof, n: int = 12):
    """(busy ms, device kernel launches, the n kernels with the most
    device time) of a trace."""
    dev_ops = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in dev_ops) / 1e3
    count = sum(e.count for e in dev_ops)
    dev_ops.sort(key=lambda e: -e.self_device_time_total)
    return busy_ms, count, [dict(name=e.key[:90],
                                 ms=e.self_device_time_total / 1e3,
                                 count=e.count) for e in dev_ops[:n]]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             "repository")
    sys.path.insert(0, str(SRC))

    from repro_torch import kernels
    from repro_torch.core.grouping import GroupingState
    from repro_torch.core.links import model_bits
    from repro_torch.core.modelbank import FlatSpec, ModelBank, pad_bucket_ids
    from repro_torch.fl_constellation_sim import (build_workload, main as
                                                  sim_main, run_schemes)
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    from repro_torch.kernels.pairwise_dist import pairwise_dist_sq
    from repro_torch.kernels.pairwise_dist.ref import pairwise_dist_sq_ref

    dev = torch.device("cuda")
    report = {}
    # ---- 0. the card ------------------------------------------------------
    card = card_line()
    phase(f"phase 0: {torch.cuda.get_device_name(0)} ({card}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    report["card"] = card

    # ---- 1. build ---------------------------------------------------------
    for name in kernels.SOURCES:      # anew, for the compiler's report
        kernels.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = kernels.build_all(verbose=True)
    build_s = time.perf_counter() - t0
    phase(f"phase 1: kernels {list(kernels.SOURCES)} built in "
          f"{build_s:.1f} s into {kernels.BUILD_DIR}")
    report["build_s"] = build_s
    report["ptxas"] = check_build(kernels, logs)

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # ---- 2. fed_agg vs plain ----------------------------------------------
    phase("phase 2: fed_agg kernel vs plain (max abs error)")
    fed_err = 0.0
    for C in (64, 4, 1, 3):
        for N in (206922, 10003, 1001):
            stack = randn(C, N)
            gamma = torch.rand(C, generator=gen, device=dev) / C
            buf = randn(N + 1)
            for bw in (0.0, 0.35):
                for base in (buf[:N], buf[1:]):   # 16-byte aligned or not
                    got = fed_agg(stack, gamma, base, bw)
                    want = fed_agg_ref(stack, gamma, base, bw)
                    err = float((got - want).abs().max())
                    fed_err = max(fed_err, err)
                    if not err <= FED_AGG_TOL:
                        fail(f"fed_agg C={C} N={N} bw={bw}: error {err}")
                # out is base: the carry pass's in-place contract
                out = buf[:N].clone()
                want = fed_agg_ref(stack, gamma, out, bw)
                fed_agg(stack, gamma, out, bw, out=out)
                err = float((out - want).abs().max())
                fed_err = max(fed_err, err)
                if not err <= FED_AGG_TOL:
                    fail(f"fed_agg aliased C={C} N={N} bw={bw}: error {err}")
            print(f"  C={C:2d} N={N:6d}: ok")
    # two segments in one launch (the epoch step's bank and carry) against
    # the plain version's two-segment form
    for C in (64, 9, 1):
        for C2 in (0, 1, 4, 8):
            for N in (206922, 10003, 1001):
                stack, stack2 = randn(C, N), randn(C2, N)
                gamma = torch.rand(C, generator=gen, device=dev) / C
                gamma2 = torch.rand(C2, generator=gen, device=dev) / 4
                seg2 = dict(stack2=stack2, gamma2=gamma2)
                buf = randn(N + 1)
                for base in (buf[:N], buf[1:]):   # 16-byte aligned or not
                    got = fed_agg(stack, gamma, base, 0.35, **seg2)
                    want = fed_agg_ref(stack, gamma, base, 0.35, stack2,
                                       gamma2)
                    err = float((got - want).abs().max())
                    fed_err = max(fed_err, err)
                    if not err <= FED_AGG_TOL:
                        fail(f"fed_agg C={C} C2={C2} N={N}: error {err}")
                out = buf[:N].clone()
                want = fed_agg_ref(stack, gamma, out, 0.35, stack2, gamma2)
                fed_agg(stack, gamma, out, 0.35, out=out, **seg2)
                err = float((out - want).abs().max())
                fed_err = max(fed_err, err)
                if not err <= FED_AGG_TOL:
                    fail(f"fed_agg aliased C={C} C2={C2} N={N}: error {err}")
        print(f"  C={C:2d} + C2 in (0, 1, 4, 8), N in (206922, 10003, 1001): "
              f"ok")
    # stacks that are not contiguous f32, which the wrapper casts once
    # (as the reference does): bf16 rows, and a transposed view
    for name, stack in (("bf16", randn(9, 10003).bfloat16()),
                        ("transposed view", randn(10003, 9).T)):
        gamma = torch.rand(9, generator=gen, device=dev) / 9
        base = randn(10003)
        got = fed_agg(stack, gamma, base, 0.35)
        want = fed_agg_ref(stack.float().contiguous(), gamma, base, 0.35)
        err = float((got - want).abs().max())
        fed_err = max(fed_err, err)
        if not err <= FED_AGG_TOL:
            fail(f"fed_agg {name} stack: error {err}")
        print(f"  {name} stack (9, 10003): error {err:.3e}")
    empty = fed_agg(torch.zeros((0, 1001), device=dev),
                    torch.zeros(0, device=dev), buf[:1001], 0.35)
    if not torch.allclose(empty, 0.35 * buf[:1001], atol=0, rtol=1e-6):
        fail("fed_agg C=0 is not bw * base")
    torch.cuda.synchronize()
    print(f"fed_agg: max abs error {fed_err:.3e} over 24 one-segment and 36 "
          f"two-segment shapes, both base alignments, aliased out, a bf16 "
          f"and a transposed stack, C=0 (tolerance {FED_AGG_TOL})")

    # ---- 3. pairwise_dist_sq vs plain -------------------------------------
    phase("phase 3: pairwise_dist_sq kernel vs plain (error / max(D, 1)); "
          "both designs, the leading-row form, repeats bit-equal")

    def held(label, rows, want, limit):
        """pairwise_dist_sq on ``rows`` (an (M, N) stack, or (ref, stack)
        for the leading-row form) against ``want`` (the plain version in
        float64): max abs error within ``limit``, D symmetric, two calls
        bit-equal.  Returns the error."""
        def call():
            return (pairwise_dist_sq(rows[1], ref=rows[0])
                    if isinstance(rows, tuple) else pairwise_dist_sq(rows))
        got, again = call(), call()
        err = float((got.double() - want).abs().max())
        if not err <= limit or not torch.equal(got, got.T):
            fail(f"pairwise_dist_sq {label}: error {err} > {limit}")
        if not torch.equal(got, again):
            fail(f"pairwise_dist_sq {label}: two calls on one input differ")
        return err

    pd_err = pd_abs = 0.0
    # up to 8 rows the few-rows design, above it the tiled one
    for M in (1, 2, 8, 9, 65, 66, 130):
        for N in (MAIN_N, 4097):
            x = randn(M, N)
            # the plain version in float64: at M = 1, D is exactly 0 and
            # the f32 plain version's own rounding (~eps n) is all of it
            want = pairwise_dist_sq_ref(x.double())
            scale = max(float(want.max()), 1.0)
            forms = {"stack": x}
            # row 0 from its own pointer beside rows 1.. (dist_to_ref's
            # form): the concatenation is x itself
            if M >= 2:
                forms["ref"] = (x[0], x[1:])
            errs = []
            for name, rows in forms.items():
                abs_err = held(f"M={M} N={N} {name}", rows, want,
                               PDIST_TOL * scale)
                pd_err = max(pd_err, abs_err / scale)
                pd_abs = max(pd_abs, abs_err)
                errs.append(f"{name} {abs_err / scale:.2e}")
            print(f"  M={M:3d} N={N:6d}: scaled {', '.join(errs)} (max D "
                  f"{scale:.3e}); repeats bit-equal")
    # rows that tell one TF32 pass from three: every value is a (1 + 2^-12),
    # a in {-1, 0, 1}, a quarter of a TF32 spacing above a TF32 number.  One
    # pass rounds each operand to a and falls short by 2^-11 of D, all in
    # one direction (50x PDIST_TOL); 3xTF32 (hi hi + hi lo + lo hi, lo =
    # a 2^-12 exactly) misses only lo lo, 2^-24 of D
    tf32_err = 0.0
    for M in (2, 8, 9, 65):
        a = torch.randint(-1, 2, (M, MAIN_N), generator=gen, device=dev)
        x = a.float() * (1.0 + 2.0 ** -12)
        want = pairwise_dist_sq_ref(x.double())
        scale = max(float(want.max()), 1.0)
        for name, rows in (("stack", x), ("ref", (x[0], x[1:]))):
            err = held(f"TF32-sensitive M={M} {name}", rows, want,
                       PDIST_TOL * scale) / scale
            tf32_err = max(tf32_err, err)
    print(f"  rows a quarter TF32 spacing off, M in (2, 8, 9, 65): max "
          f"scaled error {tf32_err:.3e} (one TF32 pass: {2.0 ** -11:.2e})")
    # close rows, as grouping feeds them (a partial model beside w0):
    # ref + 1e-3 randn, most digits of n_i + n_j - 2 G cancel; phase 5's
    # limit eps max(n) sqrt(N)
    close = {}
    for M in (2, 8, 9, 65):
        r = randn(MAIN_N)
        rest = r[None, :] + 1e-3 * randn(M - 1, MAIN_N)
        x = torch.cat([r[None, :], rest])
        x64 = x.double()
        want = pairwise_dist_sq_ref(x64)
        tol = F32_EPS * float((x64 * x64).sum(1).max()) * math.sqrt(MAIN_N)
        err = max(held(f"close rows M={M} {name}", rows, want, tol)
                  for name, rows in (("stack", x), ("ref", (r, rest))))
        close[M] = dict(abs_err=err, max_d=float(want.max()), limit=tol)
        print(f"  close rows M={M:2d}, both forms: abs error {err:.3e} (max "
              f"D {float(want.max()):.3e}, limit {tol:.3e})")
    # stacks that are not contiguous f32, cast once by the wrapper: bf16
    # rows, and a transposed view, each against the plain version over the
    # cast (in float64)
    cast = {}
    for name, x in (("bf16", randn(9, 4097).bfloat16()),
                    ("transposed view", randn(4097, 9).T)):
        want = pairwise_dist_sq_ref(x.double())
        scale = max(float(want.max()), 1.0)
        cast[name] = held(f"{name} stack", x, want, PDIST_TOL * scale) / scale
        print(f"  {name} stack (9, 4097): scaled error {cast[name]:.3e}")
    report["pairwise_dist_checks"] = dict(
        max_scaled=pd_err, max_abs=pd_abs, tf32_sensitive_scaled=tf32_err,
        close_rows=close, cast_stacks=cast)
    # one kernel a call at the grouping shape: 20 calls in the trace, and
    # every device operation of theirs that one kernel
    from torch.profiler import ProfilerActivity, profile
    x2 = randn(2, MAIN_N)
    pairwise_dist_sq(x2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            pairwise_dist_sq(x2)
        torch.cuda.synchronize()
    ops = {e.key[:60]: e.count for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")}
    if len(ops) != 1 or round(sum(ops.values()) / 20) != 1:
        fail(f"20 pairwise_dist_sq calls at M = 2 ran {ops}, not one kernel "
             f"a call")
    torch.cuda.synchronize()
    print(f"pairwise_dist_sq: max scaled error {pd_err:.3e} (tolerance "
          f"{PDIST_TOL}), max abs {pd_abs:.3e}; one kernel a call at M = 2 "
          f"(profiler)")

    # ---- 4. the main path -------------------------------------------------
    phase("phase 4: main path — repro_torch.fl_constellation_sim.main, "
          "asyncfleo-hap, MNIST_CNN, S=40, J=30, b=32, 3 epochs, IID")
    argv = ["--schemes", "asyncfleo-hap", "--epochs", "3", "--iid",
            "--device", "cuda"]
    fed_agg.launches = 0
    pairwise_dist_sq.launches = 0
    t0 = time.perf_counter()
    results = sim_main(argv)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    main_launches = fed_agg.launches
    sim, hist = results["asyncfleo-hap"]
    prog = sim.trainer._epoch_programs[sim._spec]
    steps = prog.dispatches + prog.fallback_dispatches
    print(f"main path: {len(hist)} epochs in {wall_first:.2f} s (first run), "
          f"{steps} epoch steps ({prog.fallback_dispatches} fallback), "
          f"fed_agg launches {main_launches}, segments "
          f"{ {k: round(v, 3) for k, v in sim.segment_seconds.items()} }")
    if len(hist) != 3:
        fail(f"main path ran {len(hist)} epochs, not 3")
    # one launch a step (bank and carry together); a fallback step
    # aggregates afterwards, with more launches
    if main_launches < steps or (prog.fallback_dispatches == 0
                                 and main_launches != steps):
        fail(f"fed_agg launched {main_launches} times for {steps} steps")
    if not all(math.isfinite(r.accuracy) for r in hist):
        fail("non-finite accuracy")
    if not hist[-1].accuracy > 0.10:
        fail(f"last accuracy {hist[-1].accuracy} is not above 0.10")
    w_flat = sim._w_flat
    if w_flat.shape != (206922,) or not bool(torch.isfinite(w_flat).all()):
        fail("the global model is not a finite (206922,) vector")
    # the shapes the main path gave the kernels
    bits = model_bits(sim._spec.unflatten(w_flat))
    recv = sim.plan.downlink_times(0.0, bits, 0)
    n_part = int(sum(1 for r in recv if math.isfinite(r)))
    C_bank = len(pad_bucket_ids(range(n_part))[0])
    print(f"  epoch 0: {n_part} participants, bank ({C_bank}, 206922), "
          f"carry (4, 206922)")

    t0 = time.perf_counter()
    cpu = build_workload(iid=True, device="cpu")
    cpu_hist = run_schemes(["asyncfleo-hap"], cpu, epochs=3)[
        "asyncfleo-hap"][1]
    cpu_s = time.perf_counter() - t0
    if len(cpu_hist) != len(hist):
        fail(f"{label}: the CPU run recorded {len(cpu_hist)} epochs, the "
             f"card's {len(hist)}")
    for a, b in zip(hist, cpu_hist):
        ka = (a.epoch, a.time_s, a.num_models, a.gamma, a.stale_groups)
        kb = (b.epoch, b.time_s, b.num_models, b.gamma, b.stale_groups)
        if ka != kb:
            fail(f"card and CPU histories differ: {ka} vs {kb}")
    for a, b in zip(hist, cpu_hist):
        print(f"  epoch {a.epoch}: t={a.time_s / 3600:.3f} h "
              f"acc={a.accuracy:.4f} (CPU {b.accuracy:.4f}) "
              f"models={a.num_models} gamma={a.gamma:.3f} "
              f"stale_groups={a.stale_groups}")
    print(f"host history equals the CPU run of the port (3 epochs, "
          f"{cpu_s:.1f} s on the CPU)")
    report["main_path"] = {
        "wall_s_first": wall_first, "fed_agg_launches": main_launches,
        "epoch_steps": steps, "participants_epoch0": n_part,
        "segments_s": sim.segment_seconds,
        "history": [vars(r) for r in hist],
        "history_cpu": [vars(r) for r in cpu_hist], "cpu_s": cpu_s}

    # ---- 5. grouping through pairwise_dist --------------------------------
    phase("phase 5: grouping path — GroupingState.observe_orbit through "
          "pairwise_dist_sq vs the plain route")
    pool, w0 = sim.trainer, results_w0(sim)
    ids, _n = pad_bucket_ids(range(pool.num_clients))
    params = sim._spec.unflatten(w_flat)
    trained, _ = pool.train_stacked(params, pool.epoch_inputs(ids), ids,
                                    seed=12345)
    stack = FlatSpec.of(params).flatten_stacked(trained)
    states = {True: GroupingState(use_dist_kernel=True),
              False: GroupingState(use_dist_kernel=False)}
    for st in states.values():
        st.set_reference(w0)
    const = sim.constellation
    orbit_ids = const.orbit_ids()
    pairwise_dist_sq.launches = 0
    for o in range(const.num_orbits):
        rows = [s for s in range(const.num_sats) if orbit_ids[s] == o]
        bank = ModelBank(sim._spec, stack[rows].contiguous())
        sizes = [pool.data_size(s) for s in rows]
        for st in states.values():
            st.observe_orbit(o, bank, sizes)
    torch.cuda.synchronize()
    group_launches = pairwise_dist_sq.launches
    ref = states[True].ref_device()
    n_max = max(float(ref @ ref), float((stack[:const.num_sats] ** 2)
                                        .sum(1).max()))
    tol_d2 = F32_EPS * n_max * math.sqrt(ref.numel())
    worst = 0.0
    for o in range(const.num_orbits):
        dk, dp = states[True].distances[o], states[False].distances[o]
        worst = max(worst, abs(dk * dk - dp * dp))
        print(f"  orbit {o}: d kernel {dk:.7f} plain {dp:.7f}, "
              f"|d_k^2 - d_p^2| = {abs(dk * dk - dp * dp):.3e}")
    print(f"groups: kernel {states[True].groups}, plain "
          f"{states[False].groups}; pairwise_dist_sq launches "
          f"{group_launches}; worst |d^2 error| {worst:.3e} (tolerance "
          f"eps*max(n)*sqrt(N) = {tol_d2:.3e})")
    if group_launches < const.num_orbits:
        fail(f"pairwise_dist_sq launched {group_launches} times for "
             f"{const.num_orbits} orbits")
    if states[True].groups != states[False].groups:
        fail("kernel and plain routes grouped the orbits differently")
    if not worst <= tol_d2:
        fail(f"grouping distances differ by {worst} > {tol_d2}")
    report["grouping"] = {"launches": group_launches, "worst_d2_err": worst,
                          "tol_d2": tol_d2,
                          "groups": states[True].groups}

    # ---- 6. timings -------------------------------------------------------
    phase("phase 6: timings (kernel time from the profiler's device trace "
          "over 200 calls; inputs cycled through > 2x L2)")
    timings = timings_process(C_bank)
    for name, t in timings.items():
        print(f"{name} {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, "
              f"{t['launches']:g} launch(es) a call (queued "
              f"{t['queue_ms'] * 1e3:.1f} us/call, host enqueue "
              f"{t['host_ms'] * 1e3:.1f} us/call), bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})"
              + "".join(f", {k} {t[k] * 1e3:.2f} us" for k in (
                  "plain_ms", "library_ms", "two_calls_ms") if k in t))
    report["timings"] = timings

    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        run_schemes(["asyncfleo-hap"], sim_workload(sim), epochs=3)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    print(f"warm 3-epoch wall (s): {warm}")
    report["warm_wall_s"] = warm

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_schemes(["asyncfleo-hap"], sim_workload(sim), epochs=3)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    busy_ms, _, top = top_device_ops(prof)
    wall_ms = min(warm) * 1e3
    share = busy_ms / wall_ms if busy_ms else float("nan")
    print(f"profile: device busy {busy_ms:.1f} ms; warm wall {wall_ms:.1f} "
          f"ms unprofiled ({wall_prof * 1e3:.1f} ms profiled); busy share "
          f"of the unprofiled wall {share:.3f}"
          + ("" if busy_ms else " — the profiler showed no device time: "
             "not measured"))
    for t in top:
        print(f"  {t['ms']:9.3f} ms x{t['count']:<6d} {t['name']}")
    report["profile"] = dict(busy_ms=busy_ms, wall_ms=wall_ms,
                             wall_ms_profiled=wall_prof * 1e3,
                             busy_share=share, top=top)

    # ---- 7-10. LM serving, dense family ----------------------------------
    from repro_torch.configs import get_config
    from repro_torch.kernels.chunk_scan import chunk_scan
    from repro_torch.kernels.flash_attention import flash_attention
    fa_err, fa_err_zamba, fa_err_wide = flash_vs_plain(torch, dev, gen,
                                                       report)
    route_parity(torch, dev, report)
    fa_launches = serving_path(
        torch, dev, report, arch="qwen3-4b", phase_no=9,
        expected={flash_attention: get_config("qwen3-4b").num_layers,
                  fed_agg: 0, pairwise_dist_sq: 0, chunk_scan: 0},
        extra_argv=["--cache-len", str(PREFILL["S"])])["flash_attention"]
    fa_all = flash_timings(torch, dev, gen, report)
    fa = fa_all["prefill"]

    # ---- 11-14. LM serving, RWKV6 -----------------------------------------
    cs_err, cs_err_zamba, cs_err_wide = scan_vs_plain(torch, dev, gen,
                                                      report)
    rwkv_route_parity(torch, dev, report)
    cs_launches = serving_path(
        torch, dev, report, arch="rwkv6-7b", phase_no=13,
        expected={chunk_scan: get_config("rwkv6-7b").num_layers,
                  fed_agg: 0, pairwise_dist_sq: 0, flash_attention: 0},
        extra_argv=[], after=lowest_in_chunk_decay)["chunk_scan"]
    cs_all = scan_timings(torch, dev, gen, report)
    cs = cs_all["rwkv6"]

    # ---- 15. hubert-xlarge, head dim 80 ----------------------------------
    hubert_path(torch, dev, report,
                others=(fed_agg, pairwise_dist_sq, chunk_scan))

    # ---- 16. the event-driven path ---------------------------------------
    quickstart, quickstart_w, quickstart_work = event_path(
        torch, report, others=(pairwise_dist_sq, flash_attention, chunk_scan))

    # ---- 17. the fault path ----------------------------------------------
    fault_path(torch, report, quickstart, quickstart_w,
               others=(pairwise_dist_sq, flash_attention, chunk_scan))

    # ---- 18. Table II ------------------------------------------------------
    table2_path(torch, report,
                others=(pairwise_dist_sq, flash_attention, chunk_scan))

    # ---- 19. observability -------------------------------------------------
    observability_path(torch, report, quickstart, quickstart_w,
                       quickstart_work,
                       others=(pairwise_dist_sq, flash_attention, chunk_scan))

    # ---- 20. the stacked and legacy simulator paths ----------------------
    simulator_paths(torch, report,
                    others=(pairwise_dist_sq, flash_attention, chunk_scan))

    # ---- 21. the sweep engine ---------------------------------------------
    sweep_path(torch, report,
               others=(pairwise_dist_sq, flash_attention, chunk_scan))

    # ---- 22-23. LM serving, the hybrid family (zamba2-2.7b) ---------------
    zamba_route_parity(torch, dev, report)
    zcfg = get_config("zamba2-2.7b")
    z_launches = serving_path(
        torch, dev, report, arch="zamba2-2.7b", phase_no=23,
        expected={chunk_scan: zcfg.num_layers,
                  flash_attention: zcfg.num_layers // zcfg.attn_every,
                  fed_agg: 0, pairwise_dist_sq: 0},
        extra_argv=["--cache-len", str(PREFILL["S"])])

    # ---- 24-25. LM serving, the moe family (deepseek-v2, kimi-k2) --------
    # phase 28's CPU run goes on meanwhile: phases 24-27 keep the host's
    # cores mostly free
    lm_cpu = lm_fl_cpu_start()
    moe_route_parity(torch, dev, report, flash_attention)
    serving_path(
        torch, dev, report, arch="deepseek-v2-236b", phase_no=25,
        expected={flash_attention: 0, chunk_scan: 0, fed_agg: 0,
                  pairwise_dist_sq: 0},
        cfg=get_config("deepseek-v2-236b").replace(num_layers=3),
        after=moe_drop_share)

    # ---- 27-29. LM training ----------------------------------------------
    lm_wrappers = (fed_agg, pairwise_dist_sq, flash_attention, chunk_scan)
    train_path(torch, dev, report, lm_wrappers)
    lm_fl_path(torch, dev, report, lm_cpu, lm_wrappers)
    lm_full = lm_fl_full_width(torch, dev, report, lm_wrappers)
    lm_t = report["lm_kernel_timings"] = lm_timings_process(
        lm_full["params"])

    # ---- 30. the mesh runtime ---------------------------------------------
    mesh_runtime(torch, dev, report, sim, hist, lm_wrappers)

    # ---- 31. the dry-run tools -------------------------------------------
    dryrun_path(torch, dev, report)

    # ---- 33. SSM and hybrid training ----------------------------------------
    ssm_train_path(torch, dev, report, lm_wrappers)

    # ---- 32. the kernel line ----------------------------------------------
    phase("phase 32: the kernel line")
    fb, pg = timings["eq14_bank_carry"], timings["pairwise_dist_grouping"]
    fl, fe = lm_t["fed_agg_lm"], lm_t["flash_lm_eval"]
    fz, cz = fa_all["zamba2"], cs_all["zamba2"]
    fw, cw = fa_all["wide_hd"], cs_all["wide_k"]
    print(f"the wide kernels' launches on the main paths (phases 9, 13, "
          f"15, 23, 25, 28, 29): {WIDE_ON_PATHS}")
    kernel_line = {"kernels": [
        dict(name="fed_agg", route="cuda",
             source="src/repro_torch/csrc/fed_agg.cu",
             replaces="src/repro/kernels/fed_agg/kernel.py:22",
             launches=main_launches, max_abs_err=fed_err, ms=fb["ms"],
             plain_ms=fb["plain_ms"], bound_ms=fb["bound_ms"],
             bound_by=fb["bound_by"], library_ms=fb["library_ms"]),
        dict(name="pairwise_dist_sq", route="cuda",
             source="src/repro_torch/csrc/pairwise_dist.cu",
             replaces="src/repro/kernels/pairwise_dist/kernel.py:23",
             launches=group_launches, max_abs_err=pd_abs, ms=pg["ms"],
             plain_ms=pg["plain_ms"], bound_ms=pg["bound_ms"],
             bound_by=pg["bound_by"], library_ms=pg["library_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:29",
             launches=fa_launches, max_abs_err=fa_err, ms=fa["ms"],
             plain_ms=fa["plain_ms"], bound_ms=fa["bound_ms"],
             bound_by=fa["bound_by"], library_ms=fa["library_ms"]),
        dict(name="chunk_scan", route="cuda",
             source="src/repro_torch/csrc/chunk_scan.cu",
             replaces="src/repro/kernels/chunk_scan/kernel.py:20",
             launches=cs_launches, max_abs_err=cs_err, ms=cs["ms"],
             plain_ms=cs["plain_ms"], bound_ms=cs["bound_ms"],
             bound_by=cs["bound_by"], library_ms=None),
        # the same two kernels on zamba2-2.7b's serving path (phase 23),
        # at its shapes
        dict(name="flash_attention:zamba2", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:29",
             launches=z_launches["flash_attention"],
             max_abs_err=fa_err_zamba, ms=fz["ms"], plain_ms=fz["plain_ms"],
             bound_ms=fz["bound_ms"], bound_by=fz["bound_by"],
             library_ms=fz["library_ms"]),
        dict(name="chunk_scan:zamba2", route="cuda",
             source="src/repro_torch/csrc/chunk_scan.cu",
             replaces="src/repro/kernels/chunk_scan/kernel.py:20",
             launches=z_launches["chunk_scan"], max_abs_err=cs_err_zamba,
             ms=cz["ms"], plain_ms=cz["plain_ms"], bound_ms=cz["bound_ms"],
             bound_by=cz["bound_by"], library_ms=None),
        # the same two kernels past the widths one CTA holds: head dim 512
        # (the column-group kernel, phase 10's timing, phase 7's errors)
        # and K 512 (the channel-block kernel, phases 14 and 11), with
        # their launches counted over the main paths that reach the
        # wrappers
        dict(name="flash_attention:wide_hd", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:29",
             launches=WIDE_ON_PATHS["flash_attention"],
             max_abs_err=fa_err_wide, ms=fw["ms"],
             plain_ms=fw["plain_ms"], bound_ms=fw["bound_ms"],
             bound_by=fw["bound_by"], library_ms=fw["library_ms"]),
        dict(name="chunk_scan:wide_k", route="cuda",
             source="src/repro_torch/csrc/chunk_scan.cu",
             replaces="src/repro/kernels/chunk_scan/kernel.py:20",
             launches=WIDE_ON_PATHS["chunk_scan"],
             max_abs_err=cs_err_wide, ms=cw["ms"],
             plain_ms=cw["plain_ms"], bound_ms=cw["bound_ms"],
             bound_by=cw["bound_by"], library_ms=None),
        # LM FL at full width (phase 29): eq. 14 over the (4, N) bank and
        # the (4, N) carry at qwen3-4b's N for one layer, and the
        # evaluator's f32 attention
        dict(name="fed_agg:lm", route="cuda",
             source="src/repro_torch/csrc/fed_agg.cu",
             replaces="src/repro/kernels/fed_agg/kernel.py:22",
             launches=lm_full["launches"]["fed_agg"],
             max_abs_err=max(lm_full["fed_agg_err"]), ms=fl["ms"],
             plain_ms=fl["plain_ms"], bound_ms=fl["bound_ms"],
             bound_by=fl["bound_by"], library_ms=fl["library_ms"]),
        dict(name="flash_attention:lm_eval", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:29",
             launches=lm_full["launches"]["flash_attention"],
             max_abs_err=fe["max_abs_err"], ms=fe["ms"],
             plain_ms=fe["plain_ms"], bound_ms=fe["bound_ms"],
             bound_by=fe["bound_by"], library_ms=fe["library_ms"]),
    ]}
    report["kernels"] = kernel_line["kernels"]
    total_s = time.perf_counter() - T0
    report["phase_starts_s"] = PHASE_STARTS + [(round(total_s, 1), "end")]
    report["phase_walls_s"] = phase_walls(total_s)
    print("phase walls (s): " + ", ".join(
        f"{name} {wall:.1f}" for name, wall in report["phase_walls_s"]))
    report["profiler_traces"] = dict(TRACES)
    print(f"profiler traces (time_device): {TRACES['taken']} taken, "
          f"{TRACES['retaken']} of them again for a record short, "
          f"{4 * TRACE_EDGE_S * TRACES['taken']:.1f} s of idle edges")
    print(f"chip_smoke: every phase passed in {total_s:.1f} s ({card}; "
          f"phase 30, the mesh runtime, "
          f"{report['mesh_runtime']['wall_s']:.1f} s of it)")
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps(kernel_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# device operations one call of each of kernel_timings' cases launches
# (the fed_agg kernels of eq. 14's call; dist_to_ref is the kernel and a
# sqrt; the tiled Gram above 8 rows is three kernels); timing an older
# checkout's package, set its own counts here first
KERNELS_A_CALL = dict(eq14_bank_carry=1, fed_agg_bank=1, fed_agg_carry=1,
                      dist_to_ref_grouping=2, pairwise_dist_grouping=1,
                      pairwise_dist_m65=3, floor_fed_agg=1,
                      floor_pairwise_dist=1)


def kernel_timings(torch, dev, gen, c_bank: int = 64) -> dict:
    """Phase 6's kernel timings at the main path's shapes (N = 206,922):
    - eq. 14 over the bank (``c_bank`` rows) and the carry (4 rows) as
      ``combine_stacked`` runs it with two live terms (its fed_agg kernels
      only: the weights' host copies are not counted);
    - each segment alone through ``fed_agg``;
    - the grouping call ``dist_to_ref(pm[None], w0)``, every kernel it
      launches;
    - ``pairwise_dist_sq`` at 2 and 65 rows, every kernel of the call;
    - the one-CTA floors, ``fed_agg`` at C = 1, N = 1024 and
      ``pairwise_dist_sq`` at M = 2, N = 1024 (inputs warm in L2): what a
      launch alone costs on this card.
    Each entry: device ms a call, CUDA-event queue ms and host enqueue ms a
    call, device operations a call (``KERNELS_A_CALL``, which the trace
    must hold) and the bound."""
    import numpy as np
    from repro_torch.core.aggregation import combine_stacked
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.kernels.pairwise_dist import dist_to_ref, pairwise_dist_sq
    N = MAIN_N
    C_carry = 4

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def weights(c):
        return torch.rand(c, generator=gen, device=dev) / c

    out = {}

    def case(key, shape, fn, sets, nbytes, flops, only=None):
        k_ms, q_ms, host_ms, n = time_device(
            torch, fn, sets, only=only, per_call=KERNELS_A_CALL[key])
        b_ms, by = bound_ms(nbytes, flops)
        out[key] = dict(shape=shape, ms=k_ms, queue_ms=q_ms,
                        host_ms=host_ms, bound_ms=b_ms, bound_by=by,
                        launches=n)

    rows = c_bank + C_carry
    w_bank = np.asarray(weights(c_bank).cpu())
    w_carry = np.asarray(weights(C_carry).cpu())
    nbytes = (rows * N + 2 * N + rows) * 4
    case("eq14_bank_carry", [c_bank, C_carry, N],
         lambda s, s2, b: combine_stacked([(s, w_bank), (s2, w_carry)], b,
                                          0.35),
         cycled_inputs(lambda: (randn(c_bank, N), randn(C_carry, N),
                                randn(N)), nbytes),
         nbytes, 2.0 * rows * N, only="fed_agg")
    for key, C in (("fed_agg_bank", c_bank), ("fed_agg_carry", C_carry)):
        nbytes = (C * N + 2 * N + C) * 4
        case(key, [C, N], lambda s, g, b: fed_agg(s, g, b, 0.35, out=b),
             cycled_inputs(lambda: (randn(C, N), weights(C), randn(N)),
                           nbytes), nbytes, 2.0 * C * N)
    nbytes = (2 * N + 1) * 4
    case("dist_to_ref_grouping", [1, N], dist_to_ref,
         cycled_inputs(lambda: (randn(1, N), randn(N)), nbytes), nbytes,
         6.0 * N)
    for key, M in (("pairwise_dist_grouping", 2), ("pairwise_dist_m65", 65)):
        nbytes = (M * N + M * M) * 4
        case(key, [M, N], pairwise_dist_sq,
             cycled_inputs(lambda: (randn(M, N),), nbytes), nbytes,
             float(M * (M + 1)) * N)
    n1 = 1024
    case("floor_fed_agg", [1, n1],
         lambda s, g, b: fed_agg(s, g, b, 0.35, out=b),
         [(randn(1, n1), weights(1), randn(n1))], (3 * n1 + 1) * 4,
         2.0 * n1)
    case("floor_pairwise_dist", [2, n1], pairwise_dist_sq,
         [(randn(2, n1),)], (2 * n1 + 4) * 4, 6.0 * n1)
    return out


def timings_process(c_bank: int) -> dict:
    """``kernel_timings`` and ``kernel_yardsticks`` in a process of their
    own.  In the smoke's process, after phases 2-5, an H100's profiler
    traces held 199 and 198 of 200 fed_agg launches, three traces
    running, where fresh processes' traces held every launch of every
    case."""
    code = (f"import json, sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
            "import torch, chip_smoke as cs\n"
            "dev = torch.device('cuda')\n"
            "gen = torch.Generator(device=dev).manual_seed(0)\n"
            f"t = cs.kernel_timings(torch, dev, gen, {c_bank})\n"
            f"cs.kernel_yardsticks(torch, dev, gen, t, {c_bank})\n"
            "print(json.dumps(t))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"phase 6's timing process failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def kernel_yardsticks(torch, dev, gen, timings: dict, c_bank: int) -> None:
    """Phase 6's yardsticks, added to ``kernel_timings``' entries: beside
    eq. 14 in one launch, two one-segment calls (the way before it was one
    launch), the plain version and two ``torch.addmv``; beside the carry
    alone and the ``fed_agg`` floor, the plain version and one
    ``torch.addmv``; beside ``pairwise_dist_sq`` at 2 and 65 rows and its
    floor, the plain version and ``torch.cdist``.  Then
    ``pairwise_dist_sq`` at more M: the few-rows design up to 8 rows (one
    kernel), the tiled one from 9 (three)."""
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    from repro_torch.kernels.pairwise_dist import pairwise_dist_sq
    from repro_torch.kernels.pairwise_dist.ref import pairwise_dist_sq_ref
    N = MAIN_N
    C_carry = 4

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def weights(c):
        return torch.rand(c, generator=gen, device=dev) / c

    rows = c_bank + C_carry
    sets = cycled_inputs(lambda: (randn(c_bank, N), weights(c_bank),
                                  randn(C_carry, N), weights(C_carry),
                                  randn(N)), (rows * N + 2 * N + rows) * 4)

    def two(s, g, s2, g2, b):
        fed_agg(s, g, b, 0.35, out=b)
        return fed_agg(s2, g2, b, 1.0, out=b)

    def library(s, g, s2, g2, b):
        return torch.addmv(torch.addmv(b, s.t(), g, beta=0.35), s2.t(), g2)

    timings["eq14_bank_carry"].update(
        two_calls_ms=time_device(torch, two, sets, per_call=2)[0],
        plain_ms=time_device(torch, lambda s, g, s2, g2, b: fed_agg_ref(
            s, g, b, 0.35, s2, g2), sets)[0],
        library_ms=time_device(torch, library, sets)[0])
    # the carry alone, through eq. 14's one-term path, and the one-CTA
    # floors: the plain version and one torch.addmv beside each
    for key, C, n in (("fed_agg_carry", C_carry, N), ("floor_fed_agg", 1,
                                                      1024)):
        sets = cycled_inputs(lambda: (randn(C, n), weights(C), randn(n)),
                             (C * n + 2 * n + C) * 4)
        timings[key].update(
            plain_ms=time_device(torch, lambda s, g, b: fed_agg_ref(
                s, g, b, 0.35), sets)[0],
            library_ms=time_device(torch, lambda s, g, b: torch.addmv(
                b, s.t(), g, beta=0.35), sets)[0])
    sets = [(randn(2, 1024),)]
    timings["floor_pairwise_dist"].update(
        plain_ms=time_device(torch, pairwise_dist_sq_ref, sets)[0],
        library_ms=time_device(torch, lambda x: torch.cdist(
            x, x, compute_mode="use_mm_for_euclid_dist"), sets)[0])
    for key, M in (("pairwise_dist_grouping", 2), ("pairwise_dist_m65", 65)):
        sets = cycled_inputs(lambda: (randn(M, N),), M * N * 4)
        timings[key].update(
            plain_ms=time_device(torch, pairwise_dist_sq_ref, sets)[0],
            library_ms=time_device(torch, lambda x: torch.cdist(
                x, x, compute_mode="use_mm_for_euclid_dist"), sets)[0])
    for M in (4, 6, 8, 9, 16, 33, 66, 130):
        nbytes = (M * N + M * M) * 4
        sets = cycled_inputs(lambda: (randn(M, N),), nbytes)
        b_ms, by = bound_ms(nbytes, float(M * (M + 1)) * N)
        k_ms, q_ms, host_ms, n = time_device(
            torch, pairwise_dist_sq, sets, per_call=1 if M <= 8 else 3)
        timings[f"pairwise_dist_m{M}"] = dict(
            shape=[M, N], ms=k_ms, queue_ms=q_ms, host_ms=host_ms,
            bound_ms=b_ms, bound_by=by, launches=n)


def kernel_name(mangled: str) -> str:
    """The last length-prefixed name ending in "kernel" in a mangled
    symbol, with its integer or element-type template arguments:
    flash_wgmma_kernel<128,128>, chunk_scan_kernel<bf16,64>,
    flash_mma_kernel<f16,256>."""
    import re
    found = mangled
    for m in re.finditer(r"\d+", mangled):
        for d in range(m.start(), m.end()):
            n = int(mangled[d:m.end()])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("kernel"):
                found = name
                arg = r"f|13__nv_bfloat16|6__half|Li\d+E"
                args = re.match(rf"I((?:{arg})+)E", mangled[m.end() + n:])
                if args:
                    names = {"f": "f32", "13__nv_bfloat16": "bf16",
                             "6__half": "f16"}
                    found += "<" + ",".join(
                        names.get(a, a.strip("LiE"))
                        for a in re.findall(arg, args.group(1))) + ">"
                break
    return found


def ptxas_kernels(log: str):
    """Per kernel of one source's ``-Xptxas -v`` output: (name with its
    template arguments, registers, spill stores, spill loads), and the
    lines where ptxas says it serialised wgmma or ignored setmaxnreg."""
    import re
    out, name, warn = [], None, []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            name = kernel_name(m.group(1))
            spills = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills))
            name = None
        if "serialized" in line or "setmaxnreg ignored" in line:
            warn.append(line.strip())
    return out, warn


def sass_of(kernels, name: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<name>.cu``."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(kernels.library_path(name))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass {name} failed: {sass.stderr.strip()[:300]}")
    return sass.stdout


def check_build(kernels, logs) -> dict:
    """Phase 1's checks: registers and spills per kernel; the wgmma
    kernel of flash_attention without spills and without serialised
    wgmma; HGMMA (wgmma) and UTMALDG (TMA loads) in its library's SASS;
    the chunk_scan kernels at 64 channels without spills, and TF32 HMMA
    in its library's SASS.  The wider tiles' registers and spills are
    printed and kept in the report, not gated."""
    report = {}
    for name, log in logs.items():
        rows, warn = ptxas_kernels(log)
        for k, regs, st, ld in rows:
            print(f"  {name}: {k}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")
        for w in warn:
            print(f"  {name}: ptxas: {w[:160]}")
        report[name] = dict(kernels=rows, warnings=warn)
    for name in ("fed_agg", "pairwise_dist"):
        spilled = [r for r in report[name]["kernels"] if r[2] or r[3]]
        if spilled:
            fail(f"the {name} kernels spill: {spilled}")
    tf32 = sum(".TF32" in line for line in
               sass_of(kernels, "pairwise_dist").splitlines()
               if "HMMA" in line)
    print(f"  pairwise_dist SASS: {tf32} TF32 HMMA (the tiled Gram's "
          f"mma.sync)")
    if not tf32:
        fail("the pairwise_dist library's SASS holds no TF32 HMMA")
    report["pairwise_dist_sass"] = dict(tf32=tf32)
    flash = report["flash_attention"]
    wgmma = [r for r in flash["kernels"] if r[0].startswith("flash_wgmma")]
    if len(wgmma) != 3:
        fail(f"ptxas reported {len(wgmma)} wgmma kernels, not 3 (hd 64, 80, "
             f"128)")
    if any(st or ld for _, _, st, ld in wgmma):
        fail(f"the wgmma flash kernels spill: {wgmma}")
    if flash["warnings"]:
        fail(f"ptxas serialised wgmma or ignored setmaxnreg: "
             f"{flash['warnings']}")
    sass = sass_of(kernels, "flash_attention")
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    print(f"  flash_attention SASS: {counts['HGMMA']} HGMMA (wgmma), "
          f"{counts['UTMALDG']} UTMALDG (TMA loads)")
    if not all(counts.values()):
        fail(f"the flash_attention library's SASS lacks wgmma or TMA: "
             f"{counts}")
    report["flash_sass"] = counts
    # the serving shapes' kernels keep their gates; the tiles added for the
    # whole domain (flash_mma_kernel off bf16 at 32, every f16 tile,
    # flash_f32_kernel off 32, 64, 80 and 128, the column-group kernels past
    # 256, chunk_scan_kernel at 128 channels and in f16, the channel-block
    # kernel past 128) are printed, not gated
    dts = ("f32", "bf16", "f16")
    want = {*(f"flash_mma_kernel<{t},{hd}>" for t in dts[1:]
              for hd in (32, 64, 96, 128, 160, 192, 256)),
            *(f"flash_mma_wide_kernel<{t}>" for t in dts[1:]),
            "flash_f32_wide_kernel"}
    got = {r[0] for r in flash["kernels"]}
    if not want <= got:
        fail(f"ptxas reported no flash kernels {sorted(want - got)}")
    scan = [r for r in report["chunk_scan"]["kernels"]
            if r[0].startswith("chunk_scan_")]
    if sorted(r[0] for r in scan) != sorted(
            [f"chunk_scan_kernel<{t},{k}>" for t in dts for k in (64, 128)]
            + [f"chunk_scan_wide_kernel<{t}>" for t in dts]):
        fail(f"ptxas reported chunk_scan kernels {[r[0] for r in scan]}, "
             f"not f32, bf16 and f16 at 64 and 128 channels and past")
    served = [r for r in scan
              if r[0] in ("chunk_scan_kernel<f32,64>",
                          "chunk_scan_kernel<bf16,64>")]
    if any(st or ld for _, _, st, ld in served):
        fail(f"the chunk_scan kernels at 64 channels spill: {served}")
    present = {"flash_mma_kernel<bf16,32>", *(f"flash_f32_kernel<{hd}>"
                                              for hd in (32, 64, 80, 128))}
    wide = [r for r in flash["kernels"]
            if r[0].startswith(("flash_mma", "flash_f32"))
            and r[0] not in present] + [r for r in scan if r not in served]
    print(f"  the whole domain's wider tiles (not gated): "
          + ", ".join(f"{k} {regs} registers, spills {st}/{ld} B"
                      for k, regs, st, ld in wide))
    report["wide_tiles"] = wide
    hmma = [line for line in sass_of(kernels, "chunk_scan").splitlines()
            if "HMMA" in line]
    tf32 = sum(".TF32" in line for line in hmma)
    print(f"  chunk_scan SASS: {len(hmma)} HMMA, {tf32} of them TF32 "
          f"(mma.sync.m16n8k8 on the tensor cores)")
    if not tf32:
        fail("the chunk_scan library's SASS holds no TF32 HMMA")
    report["chunk_scan_sass"] = dict(hmma=len(hmma), tf32=tf32)
    return report


EVENT_SCHEME = "asyncfleo-pipelined"


def event_run(work, scheme=EVENT_SCHEME, epochs=2, spec_kw=None,
              **sim_kw):
    """``scheme`` through ``FLSimulation`` with
    ``SimConfig(event_driven=True)`` over 3 days, from ``work.w0``;
    ``spec_kw`` replaces strategy fields, ``sim_kw`` sets more
    ``SimConfig`` fields.  Returns (the simulation, its history)."""
    from repro_torch.core.simulator import FLSimulation, SimConfig
    from repro_torch.fl.strategies import get_strategy
    spec = get_strategy(scheme)
    if spec_kw:
        spec = dataclasses.replace(spec, **spec_kw)
    sim = FLSimulation(spec, work.pool, work.evaluator,
                       SimConfig(duration_s=3 * 86400.0, event_driven=True,
                                 **sim_kw))
    return sim, sim.run(work.w0, max_epochs=epochs)


def pipelined_run(work, ps_channels=None, **sim_kw):
    """``EVENT_SCHEME``, 2 epochs, through ``event_run``; ``ps_channels``
    sets the PS channels."""
    spec_kw = None if ps_channels is None else dict(ps_channels=ps_channels)
    return event_run(work, spec_kw=spec_kw, **sim_kw)


def step_counts(pool):
    """(one-step epochs, fallback epochs) the pool has run so far, over
    the epoch programs cached on it."""
    progs = getattr(pool, "_epoch_programs", {}).values()
    return (sum(p.dispatches for p in progs),
            sum(p.fallback_dispatches for p in progs))


FAULT_KEYS = ("transfers_failed", "transfer_retries",
              "dropped_after_max_retries", "dropped_unreachable",
              "rerouted_arrivals", "sink_failovers", "dropped_outage",
              "outage_deferrals", "energy_deferrals",
              "energy_skipped_recruits", "dropped_energy",
              "fault_aware_skips", "arrivals_expected", "arrivals_committed")


def check_event_run(label, sim, hist, launches, steps, cpu_hist, cpu_w,
                    epochs=2, cpu_stats=None) -> dict:
    """Phases 16 and 17's checks of one event-driven run on the card:
    ``check_launches``, ``hold_against_cpu`` against the reference run
    (``cpu_hist``, its final flat model ``cpu_w``) and, given
    ``cpu_stats``, its whole ``rt.stats``.  Returns the run's numbers."""
    one, fallback = steps
    no_train = len(hist) - one - fallback
    rt = sim.runtime
    popped = sum(rt.events.counts.values()) - len(rt.events)
    stats = dict(rt.stats)
    print(f"{label}: {len(hist)} epochs, {one + fallback} epoch steps "
          f"({fallback} fallback), fed_agg launches {launches}, events "
          f"popped {popped} ({rt.events.counts}), rounds opened "
          f"{stats['rounds_opened']}, max in flight "
          f"{stats['max_rounds_in_flight']}, segments "
          f"{ {k: round(v, 3) for k, v in sim.segment_seconds.items()} }")
    check_launches(label, hist, launches, steps, epochs)
    w_diff = hold_against_cpu(label, sim, hist, cpu_hist, cpu_w)
    if cpu_stats is not None:
        if stats != cpu_stats:
            fail(f"{label}: card and CPU stats differ: {stats} vs "
                 f"{cpu_stats}")
        print(f"  stats equal the CPU run's; faults: "
              f"{ {k: stats[k] for k in FAULT_KEYS} }, backoff delays "
              f"{stats['backoff_delays_s']}")
    return dict(fed_agg_launches=launches, epoch_steps=one,
                fallback_steps=fallback, no_train_commits=no_train,
                w_max_abs_diff=w_diff, events_popped=popped,
                event_counts=dict(rt.events.counts), stats=stats,
                contention=rt.contention_stats(),
                segments_s=dict(sim.segment_seconds),
                history=[vars(r) for r in hist],
                history_cpu=[vars(r) for r in cpu_hist])


def check_launches(label, hist, launches, steps, epochs) -> None:
    """``epochs`` finite records, and ``fed_agg`` once per epoch step
    (more only on a fallback step; a record with nothing to train
    launches it at most once, and not at all when every weight is
    zero)."""
    one, fallback = steps
    no_train = len(hist) - one - fallback
    if len(hist) != epochs:
        fail(f"{label} recorded {len(hist)} epochs, not {epochs}")
    if not all(math.isfinite(r.accuracy) for r in hist):
        fail(f"{label}: non-finite accuracy")
    if (no_train < 0 or launches < one + fallback
            or (fallback == 0 and launches > one + no_train)):
        fail(f"{label}: fed_agg launched {launches} times for "
             f"{one + fallback} epoch steps and {no_train} commits without "
             "training")


def hold_against_cpu(label, sim, hist, cpu_hist, cpu_w) -> float:
    """The card's history against the reference run's: host fields equal,
    each accuracy within one test sample, the final flat model within
    atol 1e-4 of ``cpu_w`` (the parity tests' tolerance).  Returns max
    |card - reference| over the model."""
    import torch
    if len(cpu_hist) != len(hist):
        fail(f"{label}: the CPU run recorded {len(cpu_hist)} epochs, the "
             f"card's {len(hist)}")
    for a, b in zip(hist, cpu_hist):
        ka = (a.epoch, a.time_s, a.num_models, a.gamma, a.stale_groups)
        kb = (b.epoch, b.time_s, b.num_models, b.gamma, b.stale_groups)
        if ka != kb:
            fail(f"{label}: card and CPU histories differ: {ka} vs {kb}")
    one_sample = 1.0 / len(sim.evaluator.labels)
    for a, b in zip(hist, cpu_hist):
        print(f"  epoch {a.epoch}: t={a.time_s / 3600:.3f} h "
              f"acc={a.accuracy:.4f} (CPU {b.accuracy:.4f}) "
              f"models={a.num_models} gamma={a.gamma:.3f} "
              f"stale_groups={a.stale_groups}")
        if not abs(a.accuracy - b.accuracy) <= one_sample + 1e-6:
            fail(f"{label}: epoch {a.epoch}'s accuracy {a.accuracy} is more "
                 f"than one test sample from the CPU's {b.accuracy}")
    w = sim._w_flat
    if w.shape != cpu_w.shape or not bool(torch.isfinite(w).all()):
        fail(f"{label}: the global model is not a finite {tuple(cpu_w.shape)}"
             " vector")
    w_diff = float((w.cpu().double() - cpu_w.cpu().double()).abs().max())
    print(f"  final model {tuple(w.shape)}: max |card - CPU| {w_diff:.3e} "
          f"(max |w| {float(cpu_w.abs().max()):.3e})")
    if not w_diff <= 1e-4:
        fail(f"{label}: the final model is {w_diff} from the CPU run's, "
             "more than 1e-4")
    return w_diff


def event_path(torch, report, *, others) -> tuple:
    """Phase 16: the README quickstart on the event-driven runtime, at
    full width on the card, then with one PS channel; each run against a
    CPU run of the port, then warm walls and one profiled run.  Returns
    the quickstart's numbers, its final flat model and its workload."""
    from repro_torch.fl_constellation_sim import (build_workload, main as
                                                  sim_main)
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.obs import DispatchProfiler, Tracer, add_runtime_tracks
    phase(f"phase 16: event-driven path — repro_torch.fl_constellation_sim."
          f"main --event-driven, {EVENT_SCHEME}, MNIST_CNN, S=40, J=30, "
          f"b=32, 2 epochs, IID; then ps_channels=1")
    argv = ["--schemes", EVENT_SCHEME, "--epochs", "2", "--iid",
            "--event-driven", "--device", "cuda"]
    for w in (fed_agg,) + tuple(others):
        w.launches = 0
    t0 = time.perf_counter()
    sim, hist = sim_main(argv)[EVENT_SCHEME]
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = fed_agg.launches
    other = {w.__name__: w.launches for w in others}
    steps = step_counts(sim.trainer)
    work = sim_workload(sim)

    t0 = time.perf_counter()
    cpu = build_workload(iid=True, device="cpu")
    # the quickstart's CPU run traced and profiled (read-only), phase 19's
    # reference counts
    cpu_tr, cpu_prof = Tracer(), DispatchProfiler()
    cpu_runs = {None: pipelined_run(cpu, tracer=cpu_tr, profiler=cpu_prof),
                1: pipelined_run(cpu, 1)}
    add_runtime_tracks(cpu_tr, cpu_runs[None][0].runtime)
    cpu_s = time.perf_counter() - t0

    out = {"wall_s_first": cold, "cpu_s": cpu_s, "other_launches": other,
           "cpu_obs": dict(spans=len(cpu_tr.spans),
                           instants=len(cpu_tr.instants),
                           summary=cpu_prof.summary())}
    out["quickstart"] = check_event_run(
        "quickstart", sim, hist, launches, steps, cpu_runs[None][1],
        cpu_runs[None][0]._w_flat)
    rounds = out["quickstart"]["stats"]["max_rounds_in_flight"]
    if rounds < 2:
        fail(f"the quickstart held {rounds} round(s) in flight, not 2 or "
             "more")
    if any(other.values()):
        fail(f"the event path launched other kernels: {other}")

    before = step_counts(sim.trainer)
    fed_agg.launches = 0
    sim1, hist1 = pipelined_run(work, ps_channels=1)
    torch.cuda.synchronize()
    after = step_counts(sim1.trainer)
    out["ps_channels_1"] = check_event_run(
        "ps_channels=1", sim1, hist1, fed_agg.launches,
        (after[0] - before[0], after[1] - before[1]), cpu_runs[1][1],
        cpu_runs[1][0]._w_flat)
    print(f"  contention: {out['ps_channels_1']['contention']}")

    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        pipelined_run(work)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipelined_run(work)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    busy_ms, n_kernels, top = top_device_ops(prof)
    wall_ms = min(warm) * 1e3
    share = busy_ms / wall_ms if busy_ms else float("nan")
    per_step = launches / max(1, sum(steps))
    print(f"event path: cold {cold:.2f} s (workload build included), warm "
          f"{warm} s; fed_agg {launches} launches for {sum(steps)} epoch "
          f"steps ({per_step:g} a commit); device busy {busy_ms:.1f} ms "
          f"over {n_kernels} device operations; warm wall {wall_ms:.1f} ms "
          f"unprofiled ({wall_prof * 1e3:.1f} ms profiled); busy share "
          f"{share:.3f}" + ("" if busy_ms else " — the profiler showed no "
                            "device time: not measured")
          + f"; CPU runs {cpu_s:.1f} s")
    for t in top:
        print(f"  {t['ms']:9.3f} ms x{t['count']:<6d} {t['name']}")
    out.update(warm_wall_s=warm, busy_ms=busy_ms, kernel_launches=n_kernels,
               wall_ms=wall_ms, wall_ms_profiled=wall_prof * 1e3,
               busy_share=share, fed_agg_per_commit=per_step, top=top)
    report["event_path"] = out
    return out["quickstart"], sim._w_flat, work


# phase 17 (a): the README's robustness smoke (20% transfer loss, compute
# spread 1.0, the poly staleness discount)
FAULT_SCHEME = "asyncfleo-gs"
FAULT_ARGV = ["--schemes", FAULT_SCHEME, "--epochs", "2", "--iid",
              "--event-driven", "--dropout", "0.2", "--compute-spread", "1.0",
              "--staleness-fn", "poly"]
# phase 17 (b): every recovery axis of DESIGN.md §11 at once on the two
# HAPs: burst loss with AIMD backoff, each HAP dark 30% of every 2 h,
# batteries that cannot pay for an uplink right after training, and
# fault-aware selection.  Seed 1 makes a PS go dark under an open round
# (a sink failover) within the 4 epochs
RECOVERY_SCHEME = "asyncfleo-twohap"
RECOVERY_EPOCHS = 4
RECOVERY_FAULT = dict(seed=1, loss_prob=0.3, burst_len_s=1800.0,
                      max_retries=3, retry_backoff_s=60.0,
                      adaptive_backoff=True, ps_outage_fraction=0.3,
                      ps_outage_period_s=7200.0, battery_j=60.0,
                      train_energy_j=50.0, tx_energy_j=20.0, recharge_w=0.01)
# phase 17 (c): the 200-satellite geometry of tests/test_sparse_contacts.py
WALKER200 = dict(num_orbits=10, sats_per_orbit=20, altitude_m=600e3,
                 inclination_deg=60.0)


def recovery_run(work):
    """Phase 17 (b)'s run through ``event_run``."""
    from repro_torch.sched import FaultModel
    return event_run(work, RECOVERY_SCHEME, RECOVERY_EPOCHS,
                     spec_kw=dict(fault_aware_selection=True),
                     fault_model=FaultModel(**RECOVERY_FAULT))


def compile_plans(days: float = 3.0, dt_s: float = 10.0) -> dict:
    """Phase 17 (c)'s geometry: walker200 under ``hapring:4`` compiled
    dense and sparse over ``days`` at ``dt_s``; the windows must be equal.
    Seconds of each compile (host clock), the peak of its allocations
    (tracemalloc, a second compile) and the bytes its timeline keeps."""
    import tracemalloc
    import numpy as np
    from repro_torch.core.constellation import WalkerDelta, make_ps_nodes
    from repro_torch.sched import ContactPlan
    cst, nodes = WalkerDelta(**WALKER200), make_ps_nodes("hapring:4")

    def compile_(vis):
        return ContactPlan.compile(cst, nodes, days * 86400.0, dt_s,
                                   visibility=vis)

    def kept(obj):
        if isinstance(obj, np.ndarray):
            return obj.nbytes
        if isinstance(obj, (list, tuple)):
            return sum(kept(o) for o in obj)
        return 0

    out, wins = {}, {}
    for vis in ("dense", "sparse"):
        t0 = time.perf_counter()
        plan = compile_(vis)
        secs = time.perf_counter() - t0
        wins[vis] = [(w.sat, w.node, w.t_start, w.t_end, w.delay_s)
                     for w in plan.windows()]
        held = sum(kept(v) for v in vars(plan.timeline).values())
        del plan
        tracemalloc.start()
        compile_(vis)
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        out[vis] = dict(compile_s=secs, peak_bytes=peak, timeline_bytes=held,
                        windows=len(wins[vis]))
        print(f"  walker200 hapring:4, {days:g} days at dt {dt_s:g} s, "
              f"{vis}: compile {secs:.2f} s, peak allocations "
              f"{peak / 2**20:.1f} MiB, timeline keeps "
              f"{held / 2**20:.2f} MiB, {len(wins[vis])} windows")
    if not wins["dense"] or wins["dense"] != wins["sparse"]:
        fail("walker200: the sparse plan's windows differ from the dense "
             "plan's")
    return out


def fault_path(torch, report, quickstart, quickstart_w, *, others) -> None:
    """Phase 17: (a) the README's robustness smoke through
    ``fl_constellation_sim.main`` at full width on the card; (b) every
    §11 recovery axis at once; each against a CPU run of the port (host
    history, accuracy, final model and every stat); (c) the quickstart
    with sparse visibility against phase 16's dense run (``quickstart``,
    its final model ``quickstart_w``), then the walker200 geometry
    compiled dense and sparse.  Then warm walls and one profiled run of
    (a)."""
    from repro_torch.fl_constellation_sim import main as sim_main
    from repro_torch.fl_constellation_sim import run_schemes
    from repro_torch.kernels.fed_agg import fed_agg
    phase(f"phase 17: fault path — repro_torch.fl_constellation_sim.main "
          f"{' '.join(FAULT_ARGV)}, MNIST_CNN, S=40; then {RECOVERY_SCHEME} "
          f"with every recovery axis, {RECOVERY_EPOCHS} epochs; then "
          f"{EVENT_SCHEME} with sparse visibility")
    for w in (fed_agg,) + tuple(others):
        w.launches = 0
    t0 = time.perf_counter()
    sim, hist = sim_main(FAULT_ARGV + ["--device", "cuda"])[FAULT_SCHEME]
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = fed_agg.launches
    steps = step_counts(sim.trainer)
    work = sim_workload(sim)
    smoke_fault = sim.fault

    before = steps
    fed_agg.launches = 0
    sim_b, hist_b = recovery_run(work)
    torch.cuda.synchronize()
    after = step_counts(sim_b.trainer)
    launches_b = fed_agg.launches
    steps_b = (after[0] - before[0], after[1] - before[1])

    before = after
    fed_agg.launches = 0
    sim_c, hist_c = pipelined_run(work, visibility="sparse")
    torch.cuda.synchronize()
    after = step_counts(sim_c.trainer)
    launches_c = fed_agg.launches
    steps_c = (after[0] - before[0], after[1] - before[1])
    other = {w.__name__: w.launches for w in others}

    t0 = time.perf_counter()
    cpu_sim, cpu_hist = sim_main(FAULT_ARGV + ["--device", "cpu"])[
        FAULT_SCHEME]
    cpu_b, cpu_hist_b = recovery_run(sim_workload(cpu_sim))
    cpu_s = time.perf_counter() - t0

    out = {"wall_s_first": cold, "cpu_s": cpu_s, "other_launches": other}
    out["smoke"] = check_event_run(
        "robustness smoke", sim, hist, launches, steps, cpu_hist,
        cpu_sim._w_flat, cpu_stats=dict(cpu_sim.runtime.stats))
    out["recovery"] = check_event_run(
        "every recovery axis", sim_b, hist_b, launches_b, steps_b,
        cpu_hist_b, cpu_b._w_flat, epochs=RECOVERY_EPOCHS,
        cpu_stats=dict(cpu_b.runtime.stats))
    st = out["recovery"]["stats"]
    for key in ("sink_failovers", "energy_deferrals", "transfers_failed"):
        if not st[key] > 0:
            fail(f"every recovery axis: {key} is {st[key]}, not > 0")
    if any(other.values()):
        fail(f"the fault path launched other kernels: {other}")

    out["sparse_quickstart"] = check_event_run(
        "quickstart, sparse visibility", sim_c, hist_c, launches_c, steps_c,
        [types.SimpleNamespace(**r) for r in quickstart["history"]],
        quickstart_w)
    if launches_c != quickstart["fed_agg_launches"]:
        fail(f"the sparse quickstart launched fed_agg {launches_c} times, "
             f"the dense one {quickstart['fed_agg_launches']}")
    print("  the sparse quickstart's host history, accuracy, final model and "
          "fed_agg launches equal phase 16's dense run")
    out["walker200"] = compile_plans()

    def smoke_run():
        return run_schemes([FAULT_SCHEME], work, epochs=2, event_driven=True,
                           staleness_fn="poly", fault_model=smoke_fault)

    warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        smoke_run()
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smoke_run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    busy_ms, n_kernels, top = top_device_ops(prof)
    wall_ms = min(warm) * 1e3
    share = busy_ms / wall_ms if busy_ms else float("nan")
    per_commit = launches / max(1, len(hist))
    print(f"fault path: robustness smoke cold {cold:.2f} s (workload build "
          f"included), warm {warm} s; fed_agg {launches} launches for "
          f"{len(hist)} commits ({per_commit:g} a commit); device busy "
          f"{busy_ms:.1f} ms over {n_kernels} device operations; warm wall "
          f"{wall_ms:.1f} ms unprofiled ({wall_prof * 1e3:.1f} ms "
          f"profiled); busy share {share:.3f}"
          + ("" if busy_ms else " — the profiler showed no device time: "
             "not measured") + f"; CPU runs {cpu_s:.1f} s")
    for t in top:
        print(f"  {t['ms']:9.3f} ms x{t['count']:<6d} {t['name']}")
    out.update(warm_wall_s=warm, busy_ms=busy_ms, kernel_launches=n_kernels,
               wall_ms=wall_ms, wall_ms_profiled=wall_prof * 1e3,
               busy_share=share, fed_agg_per_commit=per_commit, top=top)
    report["fault_path"] = out


# phase 18: the schemes of the paper's Table II (benchmarks/table2.py) on
# its non-IID split.  Each is held against a CPU run of the port where no
# earlier phase runs it on the card; a full-width CPU run takes about 28 s
# an epoch of 40 participants on the card's host, so holding all eight
# would take minutes
TABLE2 = ["fedisl", "fedisl-ideal", "fedsat", "fedspace", "fedhap",
          "asyncfleo-gs", "asyncfleo-hap", "asyncfleo-twohap"]
TABLE2_HELD = ("fedisl-ideal", "fedsat", "fedhap", "asyncfleo-twohap")
TABLE2_EPOCHS = 2


def table2_cpu_runs(schemes) -> dict:
    """Each scheme of ``schemes`` on the CPU through ``run_schemes`` on the
    non-IID workload, all at once, one process each sharing the host's
    cores.  Returns {scheme: (history records, final flat model,
    groups)}."""
    import os
    import tempfile
    import torch
    threads = max(1, (os.cpu_count() or 1) // len(schemes))
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        try:
            for name in schemes:
                code = (f"import sys, torch\n"
                        f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
                        f"torch.set_num_threads({threads})\n"
                        "from repro_torch.fl_constellation_sim import "
                        "build_workload, run_schemes\n"
                        f"sim, hist = run_schemes([{name!r}], build_workload("
                        f"iid=False, device='cpu'), epochs={TABLE2_EPOCHS})"
                        f"[{name!r}]\n"
                        "torch.save(dict(history=[vars(r) for r in hist], "
                        "w=sim._w_flat, groups=sim.grouping.groups), "
                        f"{tmp + '/' + name + '.pt'!r})\n")
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", code], stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True)
            errs = {name: p.communicate(timeout=900)[1]
                    for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = {}
        for name, p in procs.items():
            if p.returncode != 0:
                fail(f"phase 18's CPU run of {name} failed:\n"
                     f"{errs[name][-3000:]}")
            d = torch.load(f"{tmp}/{name}.pt")
            out[name] = ([types.SimpleNamespace(**r) for r in d["history"]],
                         d["w"], d["groups"])
    return out


def table2_path(torch, report, *, others) -> None:
    """Phase 18: each Table II scheme on the epoch loop at full width on
    the card, twice (the second run warm); those in ``TABLE2_HELD``
    against a CPU run of the port on the same non-IID shards: history,
    accuracy and final model as phase 16 holds them, and the same
    divergence groups."""
    from repro_torch.fl_constellation_sim import build_workload, run_schemes
    from repro_torch.kernels.fed_agg import fed_agg
    phase(f"phase 18: Table II — repro_torch.fl_constellation_sim."
          f"run_schemes, {len(TABLE2)} schemes, MNIST_CNN, S=40, J=30, "
          f"b=32, {TABLE2_EPOCHS} epochs each, non-IID, 3 days; "
          f"{', '.join(TABLE2_HELD)} against CPU runs")
    work = build_workload(iid=False, device="cuda")
    for w in (fed_agg,) + tuple(others):
        w.launches = 0
    out, runs = {}, {}
    for name in TABLE2:
        before = step_counts(work.pool)
        fed_agg.launches = 0
        t0 = time.perf_counter()
        sim, hist = run_schemes([name], work, epochs=TABLE2_EPOCHS)[name]
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = fed_agg.launches
        after = step_counts(work.pool)
        steps = (after[0] - before[0], after[1] - before[1])
        t0 = time.perf_counter()
        run_schemes([name], work, epochs=TABLE2_EPOCHS)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        groups = sim.grouping.groups
        print(f"{name}: {len(hist)} records, accuracy "
              f"{[round(r.accuracy, 4) for r in hist]}, best "
              f"{max(r.accuracy for r in hist):.4f}, fed_agg {launches} "
              f"launches for {sum(steps)} epoch steps ({steps[1]} "
              f"fallback; {launches / len(hist):g} an epoch), cold "
              f"{cold:.3f} s, warm {warm:.3f} s, {len(groups)} groups "
              f"{groups}")
        check_launches(name, hist, launches, steps, TABLE2_EPOCHS)
        runs[name] = (sim, hist)
        out[name] = dict(
            fed_agg_launches=launches, epoch_steps=steps[0],
            fallback_steps=steps[1], wall_s_first=cold, warm_wall_s=warm,
            groups=groups, best_accuracy=max(r.accuracy for r in hist),
            history=[vars(r) for r in hist])
    other = {w.__name__: w.launches for w in others}
    if any(other.values()):
        fail(f"the Table II runs launched other kernels: {other}")
    t0 = time.perf_counter()
    cpu = table2_cpu_runs(TABLE2_HELD)
    cpu_s = time.perf_counter() - t0
    for name in TABLE2_HELD:
        (sim, hist), (cpu_hist, cpu_w, cpu_groups) = runs[name], cpu[name]
        print(f"{name} against its CPU run:")
        out[name]["w_max_abs_diff"] = hold_against_cpu(name, sim, hist,
                                                       cpu_hist, cpu_w)
        if sim.grouping.groups != cpu_groups:
            fail(f"{name}: card groups {sim.grouping.groups}, CPU groups "
                 f"{cpu_groups}")
        out[name]["history_cpu"] = [vars(r) for r in cpu_hist]
    print(f"Table II: {len(TABLE2_HELD)} schemes held against CPU runs of "
          f"the port ({cpu_s:.1f} s, in {len(TABLE2_HELD)} processes at "
          f"once)")
    report["table2"] = dict(schemes=out, cpu_s=cpu_s)


def observability_path(torch, report, quickstart, quickstart_w, work, *,
                       others) -> None:
    """Phase 19: phase 16's quickstart (``quickstart``, its final flat
    model ``quickstart_w``, on its workload ``work``) with a ``Tracer``
    and a ``DispatchProfiler`` that does not block, then one that blocks,
    then none: each bit-identical to phase 16's run; the profiler's counts
    against ``fed_agg``'s launches, the commits and a CPU run's; the
    traces exported and validated; the step's host-dispatch and
    device-inclusive seconds beside the walls and phase 16's busy time.
    The CPU run is phase 16's, traced and profiled."""
    import tempfile
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.obs import (DispatchProfiler, Tracer,
                                 add_runtime_tracks, export_chrome,
                                 export_jsonl, validate_chrome_trace)
    phase(f"phase 19: observability — phase 16's quickstart ({EVENT_SCHEME}"
          f", 2 epochs) traced, with DispatchProfiler(block=False), then "
          f"block=True, then no profiler; Chrome and JSONL export")
    ev = report["event_path"]
    cpu_obs = ev["cpu_obs"]
    cpu_counts = (cpu_obs["spans"], cpu_obs["instants"])
    for w in (fed_agg,) + tuple(others):
        w.launches = 0
    out = {"runs": {}}
    for label, prof in (("block=False", DispatchProfiler()),
                        ("block=True", DispatchProfiler(block=True)),
                        ("no profiler", None)):
        tracer = Tracer()
        fed_agg.launches = 0
        t0 = time.perf_counter()
        sim, hist = pipelined_run(work, tracer=tracer, profiler=prof)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fed_agg.launches
        if ([vars(r) for r in hist] != quickstart["history"]
                or not torch.equal(sim._w_flat, quickstart_w)):
            fail(f"{label}: the traced quickstart's history or final model "
                 "differs from phase 16's run")
        run = dict(wall_s=wall, fed_agg_launches=launches)
        print(f"{label}: wall {wall:.3f} s, {launches} fed_agg launches, "
              f"{len(hist)} commits, history and model equal phase 16's")
        if prof is not None:
            summ = run["summary"] = prof.summary()
            print(f"  summary {summ}")
            want = dict(dispatches=launches, triggers=len(hist),
                        dispatches_per_trigger=1.0,
                        cold_dispatches=cpu_obs["summary"][
                            "cold_dispatches"])
            got = {k: summ[k] for k in want}
            if got != want:
                fail(f"{label}: profiler counts {got}, expected {want}")
        add_runtime_tracks(tracer, sim.runtime)
        with tempfile.TemporaryDirectory() as tmp:
            obj = export_chrome(tracer, f"{tmp}/trace.json")
            with open(f"{tmp}/trace.json") as f:
                errors = (validate_chrome_trace(obj)
                          + validate_chrome_trace(json.load(f)))
            lines = export_jsonl(tracer, f"{tmp}/trace.jsonl")
        counts = (len(tracer.spans), len(tracer.instants))
        if errors or counts != cpu_counts or lines != sum(counts):
            fail(f"{label}: trace errors {errors[:5]}, spans and instants "
                 f"{counts} (CPU run {cpu_counts}), {lines} JSONL lines")
        run.update(spans=counts[0], instants=counts[1],
                   chrome_events=len(obj["traceEvents"]))
        out["runs"][label] = run
    other = {w.__name__: w.launches for w in others}
    if any(other.values()):
        fail(f"the observability runs launched other kernels: {other}")
    host = out["runs"]["block=False"]
    dev = out["runs"]["block=True"]
    host_s = host["summary"]["compile_s"] + host["summary"]["dispatch_s"]
    dev_s = dev["summary"]["compile_s"] + dev["summary"]["dispatch_s"]
    busy_s, warm_s = ev["busy_ms"] / 1e3, ev["wall_ms"] / 1e3
    split = dict(host_dispatch_s=host_s, host_wall_s=host["wall_s"],
                 device_inclusive_s=dev_s, blocking_wall_s=dev["wall_s"],
                 outside_step_s=dev["wall_s"] - dev_s,
                 phase16_busy_s=busy_s, phase16_warm_wall_s=warm_s)
    print(f"wall split: step dispatch on the host {host_s:.3f} s of a "
          f"{host['wall_s']:.3f} s wall ({host_s / host['wall_s']:.3f}); "
          f"step with the device waited for {dev_s:.3f} s of "
          f"{dev['wall_s']:.3f} s ({dev_s / dev['wall_s']:.3f}); outside "
          f"the step {dev['wall_s'] - dev_s:.3f} s; phase 16: busy "
          f"{busy_s:.3f} s of a warm {warm_s:.3f} s wall; traces "
          f"{cpu_counts[0]} spans and {cpu_counts[1]} instants, as phase "
          f"16's CPU run's")
    out["split"] = split
    report["observability"] = out


# phase 20: the stacked and legacy simulator paths at full width, each run
# held against the fused path's run of the same configuration on the card
# (the fused path is held against the CPU in phase 4, the CPU tests hold
# the rest)
PATH_MODES = ("fused", "stacked", "legacy")
PATH_CONFIGS = (("asyncfleo-hap", {}),
                ("asyncfleo-twohap", dict(agg_timeout_s=120.0)),
                ("fedsat", {}))
# The legacy path sums each record's models in selection order, the fused
# one in bank order.  The first record aggregates the same trained models
# (tensor math on identical inputs: 1e-5, its accuracy equal); every later
# record trains from globals that differ by that rounding, and J = 30 SGD
# steps amplify it by 10-40x an epoch.  The limits on the last record are
# set from scripts/path_divergence.py's readings at record 3 on an H100
# (PERF.md): sound pairs (legacy - fused on the card and on the CPU, the
# card's fused run against the CPU's) reach 4.7e-5 legacy - fused (1.7e-4
# card - CPU), 12 differing test predictions and 2 test samples of
# accuracy; the known-bad control below (one update lost) reads 2.4e-4
# and 4.1e-4, 120 and 191 predictions, 26 and 47 samples.  Each limit lies
# near the geometric mean of the two.  They hold only at PATH_EPOCHS = 3:
# the sound legacy - fused distance passes 1e-4 at record 4 on hap
# (1.7e-4), so the depth is not to be moved without new readings.
PATH_EPOCHS = 3
PATH_SAME_INPUT_TOL = 1e-5
PATH_TRAINED_TOL = 1e-4
PATH_FLIP_LIMIT = 40        # differing test predictions at the last record
PATH_ACC_SAMPLES = 7        # test samples of accuracy at any record
CONTROL_RECORD = PATH_EPOCHS - 1


class SeenModels:
    """A workload's evaluator that keeps a flat copy of every model it
    evaluates: each record's global model, on every path (the legacy path
    keeps no flat copy of its own)."""

    def __init__(self, evaluator):
        self.evaluator, self.seen = evaluator, []

    def eval_async(self, params):
        from repro_torch.core.modelbank import flatten_tree
        self.seen.append(flatten_tree(params))
        return self.evaluator.eval_async(params)


def path_run(work, scheme, mode, **sim_kw):
    """``scheme`` on the epoch loop (3 days, ``PATH_EPOCHS`` epochs) on one
    simulator path: ``SimConfig(use_fused_step=False)`` is the stacked
    path, ``use_model_bank=False`` the legacy one.  Returns (the
    simulation, its history, each record's flat global model)."""
    from repro_torch.core.simulator import FLSimulation, SimConfig
    from repro_torch.fl.strategies import get_strategy
    ev = SeenModels(work.evaluator)
    sim = FLSimulation(get_strategy(scheme), work.pool, ev,
                       SimConfig(duration_s=3 * 86400.0,
                                 use_model_bank=mode != "legacy",
                                 use_fused_step=mode == "fused", **sim_kw))
    return sim, sim.run(work.w0, max_epochs=PATH_EPOCHS), ev.seen


def lost_update_run(work, scheme, **sim_kw):
    """The known-bad control: the legacy path with one fault, at the last
    record, in ``asyncfleo_aggregate``: the first model of the first group
    replaced by the global it was trained from (one satellite's update
    lost).  Returns what ``path_run`` returns."""
    from repro_torch.core import aggregation as agg
    clean = agg.asyncfleo_aggregate

    def lossy(w_prev, groups, models, metas, beta, **kw):
        if beta == CONTROL_RECORD:
            models = list(models)
            models[next(iter(groups.values()))[0]] = dict(w_prev)
        return clean(w_prev, groups, models, metas, beta, **kw)

    agg.asyncfleo_aggregate = lossy
    try:
        return path_run(work, scheme, "legacy", **sim_kw)
    finally:
        agg.asyncfleo_aggregate = clean


def predicted_launches(mode, agg_mode, hist, fallback_steps) -> int:
    """The ``fed_agg`` launches each path's code makes for a run that
    recorded ``hist`` (every record aggregating at least one model with a
    non-zero weight, as asyncfleo, fedavg, per-arrival and interval modes
    do):
    - fused (``_fused_commit``): one a step, whose launch takes the bank
      and the carry together, plus one ``combine_stacked`` after each
      fallback step; a commit without training launches one
      ``combine_stacked`` too — so one a record plus one a fallback;
    - stacked (``_stacked_epoch``): one ``combine_stacked`` a record over
      at most two segments (bank and carry), one launch;
    - legacy (``_legacy_epoch``): one ``weighted_sum`` a record
      (``fedavg``, ``asyncfleo_aggregate``, the interval rule), but the
      per-arrival EMA chains one a model."""
    if mode == "fused":
        return len(hist) + fallback_steps
    if mode == "legacy" and agg_mode == "per_arrival":
        return sum(r.num_models for r in hist)
    return len(hist)


def test_logits(torch, work, spec, w_flat):
    """The CNN's logits over the workload's test set at the flat model
    ``w_flat``."""
    from repro_torch.models import cnn
    ev = work.evaluator
    imgs = torch.from_numpy(ev.images).to(w_flat.device)[None]
    params = {k: v[None] for k, v in spec.unflatten(w_flat).items()}
    return cnn.apply(params, work.pool.cfg, imgs)[0]


def against_fused(torch, work, run, fused) -> dict:
    """A run's distance to the fused run of its configuration: max |w -
    w_fused| and the accuracy difference by record, and the test
    predictions that differ at the last record."""
    diffs = [float((a.double() - b.double()).abs().max())
             for a, b in zip(run["seen"], fused["seen"])]
    accs = [a.accuracy - b.accuracy
            for a, b in zip(run["hist"], fused["hist"])]
    flips = int((test_logits(torch, work, fused["spec"], run["seen"][-1])
                 .argmax(-1) != test_logits(torch, work, fused["spec"],
                                            fused["seen"][-1]).argmax(-1))
                .sum())
    return dict(w_max_abs_diff_by_record=diffs, acc_diff_by_record=accs,
                final_prediction_flips=flips)


def legacy_faults(d, n_test: int) -> dict:
    """What the legacy path's limits find wrong in ``against_fused``'s
    reading ``d`` over a test set of ``n_test`` samples: {limit: message}
    for each limit it fails (empty: none)."""
    diffs, accs = d["w_max_abs_diff_by_record"], d["acc_diff_by_record"]
    samples = [round(abs(a) * n_test) for a in accs]
    flips = d["final_prediction_flips"]
    out = {}
    if not diffs[0] <= PATH_SAME_INPUT_TOL or samples[0]:
        out["first record"] = (
            f"the first record's model is {diffs[0]:.3e} from the fused "
            f"run's (limit {PATH_SAME_INPUT_TOL}), its accuracy "
            f"{samples[0]} test samples")
    if not diffs[-1] <= PATH_TRAINED_TOL:
        out["model"] = (f"the final model is {diffs[-1]:.3e} from the fused "
                        f"run's (limit {PATH_TRAINED_TOL})")
    if flips > PATH_FLIP_LIMIT:
        out["predictions"] = (f"{flips} final test predictions differ "
                              f"(limit {PATH_FLIP_LIMIT})")
    if max(samples) > PATH_ACC_SAMPLES:
        out["accuracy"] = (f"accuracies {samples} test samples from the "
                           f"fused run's (limit {PATH_ACC_SAMPLES})")
    return out


def simulator_paths(torch, report, *, others) -> None:
    """Phase 20: ``PATH_CONFIGS`` on the fused, stacked and legacy paths at
    full width on the card, each on one workload (its pool draws the same
    minibatch indices on every path).  Every run launches ``fed_agg``
    exactly as ``predicted_launches`` says and gives the fused run's host
    rows and groups.  The stacked path computes the fused path's sums in
    the same order: every record's model and accuracy bit-equal.  The
    legacy path sums each record's models in selection order and is held
    by ``legacy_faults``; for each asyncfleo configuration the known-bad
    control (``lost_update_run``) must fail each of its limits on the
    last record."""
    from repro_torch.fl_constellation_sim import build_workload
    from repro_torch.kernels.fed_agg import fed_agg
    phase(f"phase 20: stacked and legacy simulator paths — FLSimulation "
          f"with use_fused_step=False, then use_model_bank=False, against "
          f"the fused path; MNIST_CNN, S=40, J=30, b=32, {PATH_EPOCHS} "
          f"epochs, IID: {[c for c, _ in PATH_CONFIGS]}")
    work = build_workload(iid=True, device="cuda")
    n_test = len(work.evaluator.images)
    for w in (fed_agg,) + tuple(others):
        w.launches = 0
    out = {}
    for scheme, sim_kw in PATH_CONFIGS:
        label = scheme + "".join(f" {k}={v:g}" for k, v in sim_kw.items())
        runs = {}
        for mode in PATH_MODES:
            before = step_counts(work.pool)
            fed_agg.launches = 0
            t0 = time.perf_counter()
            sim, hist, seen = path_run(work, scheme, mode, **sim_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fed_agg.launches
            fallback = step_counts(work.pool)[1] - before[1]
            want = predicted_launches(mode, sim.spec.agg_mode, hist,
                                      fallback)
            rows = [(r.epoch, r.time_s, r.num_models, r.gamma,
                     r.stale_groups) for r in hist]
            print(f"{label} {mode}: {len(hist)} records, fed_agg {launches} "
                  f"launches (predicted {want}), wall {wall:.3f} s, "
                  f"accuracy {[round(r.accuracy, 4) for r in hist]}, "
                  f"groups {sim.grouping.groups}, segments "
                  f"{ {k: round(v, 3) for k, v in sim.segment_seconds.items()} }")
            if len(hist) != PATH_EPOCHS or len(seen) != PATH_EPOCHS or not \
                    all(math.isfinite(r.accuracy) for r in hist):
                fail(f"{label} {mode}: {len(hist)} records, not "
                     f"{PATH_EPOCHS} finite ones")
            if launches != want:
                fail(f"{label} {mode}: fed_agg launched {launches} times, "
                     f"the code predicts {want}")
            runs[mode] = dict(rows=rows, hist=hist, seen=seen, wall_s=wall,
                              fed_agg_launches=launches, spec=sim._spec,
                              groups=sim.grouping.groups)
        fused = runs["fused"]
        res = {"fused": dict(wall_s=fused["wall_s"],
                             fed_agg_launches=fused["fed_agg_launches"],
                             history=[vars(r) for r in fused["hist"]])}
        for mode in ("stacked", "legacy"):
            run = runs[mode]
            if run["rows"] != fused["rows"] or run["groups"] != fused[
                    "groups"]:
                fail(f"{label} {mode}: host rows {run['rows']} and groups "
                     f"{run['groups']} differ from the fused run's "
                     f"{fused['rows']}, {fused['groups']}")
            d = against_fused(torch, work, run, fused)
            res[mode] = dict(wall_s=run["wall_s"],
                             fed_agg_launches=run["fed_agg_launches"], **d)
            print(f"  {mode} against fused: host rows and groups equal; max "
                  f"|w - w_fused| by record "
                  f"{[f'{x:.3e}' for x in d['w_max_abs_diff_by_record']]}, "
                  f"accuracy differences "
                  f"{[round(a, 4) for a in d['acc_diff_by_record']]}, "
                  f"{d['final_prediction_flips']} final predictions differ")
            if mode == "stacked":
                if any(d["w_max_abs_diff_by_record"]) or any(
                        d["acc_diff_by_record"]):
                    fail(f"{label} stacked: not bit-equal to the fused run")
                continue
            faults = legacy_faults(d, n_test)
            if faults:
                fail(f"{label} legacy: " + "; ".join(faults.values()))
        if sim.spec.agg_mode == "asyncfleo":
            _sim, hist, seen = lost_update_run(work, scheme, **sim_kw)
            d = against_fused(torch, work, dict(hist=hist, seen=seen), fused)
            caught = legacy_faults(d, n_test)
            print(f"  known-bad control (one update lost at record "
                  f"{CONTROL_RECORD + 1}): max |w - w_fused| by record "
                  f"{[f'{x:.3e}' for x in d['w_max_abs_diff_by_record']]}, "
                  f"accuracy differences "
                  f"{[round(a, 4) for a in d['acc_diff_by_record']]}, "
                  f"{d['final_prediction_flips']} final predictions differ; "
                  f"rejected for: {sorted(caught)}")
            missed = {"model", "predictions", "accuracy"} - set(caught)
            if missed:
                fail(f"{label}: the legacy limits {sorted(missed)} pass the "
                     f"known-bad control {d}")
            res["lost_update_control"] = dict(rejected_for=caught, **d)
        out[label] = res
    other = {w.__name__: w.launches for w in others}
    if any(other.values()):
        fail(f"the simulator paths launched other kernels: {other}")
    report["simulator_paths"] = out


# phase 21: the scenario sweep engine.  (a) 8 scenarios of the testbed at
# the main path's size, seed x strategy x link rate, sequential against
# batched; (b) 3 scenarios of the MNIST_CNN pool, which has no batch key
SWEEP_WIDTH = 321                   # 2 w^2 + w = 206,403 parameters
SWEEP_AXES = dict(seed=[0, 1], strategy=["asyncfleo-pipelined", "fedisl"],
                  rate_bps=[16e6, 1e5])
SWEEP_EPOCHS = 4
SWEEP_TARGET = 0.9
POOL_SWEEP_SEEDS = [0, 1, 2]
POOL_SWEEP_EPOCHS = 2


def sweep_key(r):
    """Everything a sweep result must share with its twin, bit for bit:
    the history, the final weights' bytes, the logical step counts, the
    convergence delay and the runtime stats."""
    return ([tuple(vars(h).values()) for h in r.history],
            r.final_weights.tobytes(), r.dispatches, r.fallback_dispatches,
            r.convergence_delay_s, r.stats)


def sweep_path(torch, report, *, others) -> None:
    """Phase 21: the sweep engine on the card.  (a) ``SWEEP_AXES`` over the
    testbed at ``make_model(width=SWEEP_WIDTH)``: sequential, then batched
    in exact mode, bit-identical per scenario, with fewer physical than
    logical steps; then the vmap mode within 1e-4 of exact; the batched
    step's rows at the MNIST_CNN N (rows only 8-byte aligned), B odd and
    even, bit-equal to solo ``fed_agg`` calls on aligned copies.  (b) The
    MNIST_CNN pool at full width through ``run_scenarios(trainer_factory
    =...)``: no batch key, so every step runs solo; sequential against
    batched, bit-identical."""
    import numpy as np
    from repro_torch.fl_constellation_sim import build_workload
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.sweep import (DispatchBatcher, ScenarioSpec, grid,
                                   make_model, run_scenarios)
    n_sweep = 2 * SWEEP_WIDTH ** 2 + SWEEP_WIDTH
    specs = grid(ScenarioSpec(), **SWEEP_AXES)
    phase(f"phase 21: sweep engine — run_scenarios, {len(specs)} testbed "
          f"scenarios at N = {n_sweep} ({' x '.join(SWEEP_AXES)}), "
          f"sequential vs batched (exact, vmap); then "
          f"{len(POOL_SWEEP_SEEDS)} MNIST_CNN pool scenarios")
    dev = torch.device("cuda")
    for w in (fed_agg,) + tuple(others):
        w.launches = 0
    w0 = make_model(width=SWEEP_WIDTH, device=dev)
    kw = dict(max_epochs=SWEEP_EPOCHS, target_accuracy=SWEEP_TARGET)
    out = {}
    walls = {}
    for label, batched, mode in (("sequential", False, "exact"),
                                 ("batched", True, "exact"),
                                 ("vmap", True, "vmap")):
        batcher = DispatchBatcher(mode=mode) if batched else None
        fed_agg.launches = 0
        t0 = time.perf_counter()
        res = run_scenarios(specs, w0, batched=batched, batcher=batcher,
                            **kw)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        logical = sum(r.dispatches + r.fallback_dispatches for r in res)
        out[label] = dict(wall_s=walls[label], logical_steps=logical,
                          fed_agg_launches=fed_agg.launches,
                          results=res,
                          summary=None if batcher is None
                          else batcher.summary())
        print(f"{label}: wall {walls[label]:.3f} s, {logical} logical "
              f"steps, fed_agg launches {fed_agg.launches}"
              + ("" if batcher is None else f", {batcher.summary()}"))
    seq, bat, vm = (out[k]["results"] for k in ("sequential", "batched",
                                                "vmap"))
    # the sequential sweep launches from one thread: one launch a step at
    # least (commits without training add their own)
    if out["sequential"]["fed_agg_launches"] < out["sequential"][
            "logical_steps"]:
        fail(f"the sequential sweep launched fed_agg "
             f"{out['sequential']['fed_agg_launches']} times for "
             f"{out['sequential']['logical_steps']} steps")
    if not out["batched"]["fed_agg_launches"] > 0:
        fail("the batched sweep never launched fed_agg")
    for s, b in zip(seq, bat):
        if sweep_key(s) != sweep_key(b):
            fail(f"batched and sequential differ for {s.spec}")
        if not s.epochs or not np.isfinite(s.final_weights).all():
            fail(f"{s.spec}: {s.epochs} records, finite weights "
                 f"{bool(np.isfinite(s.final_weights).all())}")
    summ = out["batched"]["summary"]
    if not summ["physical_dispatches"] < out["batched"]["logical_steps"]:
        fail(f"batched sweep: {summ['physical_dispatches']} physical steps "
             f"for {out['batched']['logical_steps']} logical ones")
    vdiff = max(float(np.abs(v.final_weights - b.final_weights).max())
                for v, b in zip(vm, bat))
    if not vdiff <= 1e-4 or any(len(v.history) != len(b.history)
                                for v, b in zip(vm, bat)):
        fail(f"vmap mode: max |w - w_exact| {vdiff} (limit 1e-4)")
    print(f"testbed sweep: batched bit-identical to sequential in all "
          f"{len(specs)} scenarios (histories, weight bytes, logical steps, "
          f"stats); {summ['physical_dispatches']} physical for "
          f"{out['batched']['logical_steps']} logical steps; vmap max |w - "
          f"w_exact| {vdiff:.3e}; walls sequential "
          f"{walls['sequential']:.3f} s, batched {walls['batched']:.3f} s, "
          f"vmap {walls['vmap']:.3f} s; convergence delays (h) "
          f"{[None if r.convergence_delay_s is None else round(r.convergence_delay_s / 3600, 3) for r in bat]}")

    # rows of a (B, N) stack at N = 206,922 (2 mod 4) are only 8-byte
    # aligned where b is odd; the per-element sum must not depend on the
    # vector width fed_agg picks from them
    gen = torch.Generator(device=dev).manual_seed(21)
    bank = torch.randn(64, MAIN_N, generator=gen, device=dev)
    carry = torch.randn(4, MAIN_N, generator=gen, device=dev)
    g = torch.rand(64, generator=gen, device=dev) / 64
    g2 = torch.rand(4, generator=gen, device=dev) / 4
    big = torch.randn(65, MAIN_N, generator=gen, device=dev)
    for B in (3, 4):
        stack = torch.randn(B, MAIN_N, generator=gen, device=dev)
        for b in range(B):
            solo = stack[b].clone()
            fed_agg(bank, g, solo, 0.35, out=solo, stack2=carry, gamma2=g2)
            fed_agg(bank, g, stack[b], 0.35, out=stack[b], stack2=carry,
                    gamma2=g2)
            shifted = fed_agg(big[1:], g, None, 0.0)
            aligned = fed_agg(big[1:].clone(), g, None, 0.0)
            if not (torch.equal(solo, stack[b])
                    and torch.equal(shifted, aligned)):
                fail(f"fed_agg on row {b} of a ({B}, {MAIN_N}) stack is not "
                     "bit-equal to the call on an aligned copy")
    print(f"fed_agg at N = {MAIN_N}: rows of (3, N) and (4, N) stacks and an "
          f"8-byte-aligned bank bit-equal to aligned copies")

    # (b) the MNIST_CNN pool: no batch key, every step solo
    work = build_workload(iid=True, device="cuda")
    pspecs = grid(ScenarioSpec(), seed=POOL_SWEEP_SEEDS)
    pkw = dict(max_epochs=POOL_SWEEP_EPOCHS,
               trainer_factory=lambda _w0: work.pool,
               evaluator_factory=lambda: work.evaluator)
    pool_out = {}
    for label, batched in (("sequential", False), ("batched", True)):
        batcher = DispatchBatcher() if batched else None
        fed_agg.launches = 0
        t0 = time.perf_counter()
        res = run_scenarios(pspecs, work.w0, batched=batched,
                            batcher=batcher, **pkw)
        torch.cuda.synchronize()
        pool_out[label] = dict(
            wall_s=time.perf_counter() - t0, results=res,
            fed_agg_launches=fed_agg.launches,
            summary=None if batcher is None else batcher.summary())
        print(f"pool {label}: wall {pool_out[label]['wall_s']:.3f} s, "
              f"fed_agg launches {fed_agg.launches}, accuracy "
              f"{[[round(h.accuracy, 4) for h in r.history] for r in res]}"
              + ("" if batcher is None else f", {batcher.summary()}"))
    pseq, pbat = pool_out["sequential"]["results"], pool_out["batched"][
        "results"]
    for s, b in zip(pseq, pbat):
        if sweep_key(s) != sweep_key(b):
            fail(f"pool sweep: batched and sequential differ for {s.spec}")
        if len(s.history) != POOL_SWEEP_EPOCHS:
            fail(f"pool sweep: {s.spec} recorded {len(s.history)} epochs")
    psumm = pool_out["batched"]["summary"]
    plogical = sum(r.dispatches + r.fallback_dispatches for r in pbat)
    if psumm["batched_dispatches"] or psumm["solo_dispatches"] != plogical:
        fail(f"pool sweep: {psumm} for {plogical} logical steps; every "
             "step must run solo")
    if not pool_out["sequential"]["fed_agg_launches"] >= plogical > 0:
        fail(f"pool sweep: {pool_out['sequential']['fed_agg_launches']} "
             f"fed_agg launches for {plogical} steps")
    print(f"pool sweep: batched bit-identical to sequential, {plogical} "
          f"steps all solo")
    other = {w.__name__: w.launches for w in others}
    if any(other.values()):
        fail(f"the sweeps launched other kernels: {other}")
    for d in (out, pool_out):
        for v in d.values():
            v["results"] = [dict(spec=vars(r.spec), epochs=r.epochs,
                                 dispatches=r.dispatches,
                                 history=[vars(h) for h in r.history])
                            for r in v["results"]]
    report["sweep"] = dict(testbed=out, pool=pool_out,
                           vmap_max_abs_diff=vdiff)


def results_w0(sim):
    """The main path's initial model (kept by the grouping state as w0)."""
    return sim._spec.unflatten(sim.grouping.ref_device())


def sim_workload(sim):
    """The main path's workload again, from its initial model."""
    from repro_torch.fl_constellation_sim import Workload
    return Workload(sim.trainer, sim.evaluator, results_w0(sim))


def flash_vs_plain(torch, dev, gen, report) -> tuple:
    """Phase 7: the kernel against its plain version; the largest abs
    error at the sweep's input spread (where its tolerances hold), over
    all cases and over zamba2's shape."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
    phase("phase 7: flash_attention kernel vs plain (max abs error; bf16 "
          "also error / (2^-7 |want| + 2^-8 rms(want row)), f16 the same at "
          "2^-10 and 2^-11)")

    def check(name, q, k, v, causal, window, spread):
        before = (flash_attention.launches, flash_attention.wide_launches)
        got = flash_attention(q, k, v, causal=causal, window=window)
        if flash_attention.launches != before[0] + 1:
            fail(f"flash_attention {name}: the wrapper launched "
                 f"{flash_attention.launches - before[0]} kernels, not one")
        if flash_attention.wide_launches - before[1] != int(q.shape[3] > 256):
            fail(f"flash_attention {name}: the column-group kernels ran "
                 f"{flash_attention.wide_launches - before[1]} times at head "
                 f"dim {q.shape[3]}")
        want = attention_ref_bshd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        if got.dtype != q.dtype:
            fail(f"flash_attention {name}: output dtype {got.dtype}")
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        err = float(diff.max())
        rms = float(want.square().mean().sqrt())
        dt = str(q.dtype).split(".")[-1]
        scaled = None
        if dt in HALF_FORMS:
            rel, row = HALF_FORMS[dt]
            row_rms = want.square().mean(-1, keepdim=True).sqrt()
            limit = rel * want.abs() + row * row_rms
            scaled = float((diff / limit).max())
        print(f"  {name}: max abs error {err:.3e}, rms |want| {rms:.3e}"
              + (f", scaled error {scaled:.3f}" if scaled is not None
                 else ""))
        abs_tol = FLASH_TOL[dt] if spread == FLASH_SPREADS[0] else None
        if abs_tol is not None and not err <= abs_tol:
            fail(f"flash_attention {name}: max abs error {err} > {abs_tol} "
                 f"(rms |want| {rms})")
        if scaled is not None and not scaled <= 1.0:
            fail(f"flash_attention {name}: scaled error {scaled} > 1 (max "
                 f"abs error {err}, rms |want| {rms})")
        return dict(name=name, spread=spread, max_abs_err=err,
                    rms_want=rms, scaled_err=scaled, dtype=dt,
                    shape=[*q.shape[:3], k.shape[2], q.shape[3]])

    def randn(shape, dtype, spread):
        return (torch.randn(*shape, generator=gen, device=dev)
                * spread).to(dtype)

    cases = []
    for B, S, H, KV, hd in ((1, 128, 2, 2, 64), (2, 256, 4, 2, 64),
                            (1, 200, 4, 1, 32), (2, 64, 8, 8, 128)):
        for causal, window in ((True, 0), (True, 48), (False, 0)):
            cases.append((B, S, H, KV, hd, causal, window, "float32",
                          FLASH_SPREADS[0]))
            for spread in FLASH_SPREADS:
                cases.append((B, S, H, KV, hd, causal, window, "bfloat16",
                              spread))
    P, Hu = PREFILL, HUBERT_ATTN
    for window in (0, 512):
        for spread in FLASH_SPREADS:
            cases.append((P["B"], P["S"], P["H"], P["KV"], P["hd"], True,
                          window, "bfloat16", spread))
    # hd 80: hubert-xlarge's shape (non-causal), zamba2's shared attention
    # (causal), and a window
    Z = ZAMBA_ATTN
    for spread in FLASH_SPREADS:
        cases.append((Hu["B"], Hu["S"], Hu["H"], Hu["KV"], Hu["hd"], False,
                      0, "bfloat16", spread))
        cases.append((Z["B"], Z["S"], Z["H"], Z["KV"], Z["hd"], True, 0,
                      "bfloat16", spread))
    # S = 1000: eight K/V tiles of 128 keys, the last one ragged (104
    # keys), after the two-stage rings have wrapped three times
    for B, S, H, KV, hd, causal, window in ((1, 200, 4, 2, 80, True, 48),
                                            (2, 1000, 4, 2, 64, True, 0),
                                            (2, 1000, 4, 2, 64, False, 0),
                                            (2, 1000, 4, 2, 80, True, 0),
                                            (2, 1000, 4, 2, 80, False, 0),
                                            (2, 1000, 4, 2, 128, True, 0),
                                            (2, 1000, 4, 2, 128, False, 0)):
        cases.append((B, S, H, KV, hd, causal, window, "float32",
                      FLASH_SPREADS[0]))
        for spread in FLASH_SPREADS:
            cases.append((B, S, H, KV, hd, causal, window, "bfloat16",
                          spread))
    # the whole domain: head dims off the serving ones, on the mma.sync
    # and f32 kernels' padded tiles (8 and 40 zero-filled to 32 and 64, 96,
    # 192 and 256 their own), and hd 36 in bf16 (rows of 72 bytes: element
    # loads)
    for hd in WIDE_HEAD_DIMS:
        for causal, window in ((True, 0), (True, 48), (False, 0)):
            cases.append((1, 200, 4, 2, hd, causal, window, "float32",
                          FLASH_SPREADS[0]))
            for spread in FLASH_SPREADS:
                cases.append((1, 200, 4, 2, hd, causal, window, "bfloat16",
                              spread))
    for spread in FLASH_SPREADS:
        cases.append((1, 200, 4, 2, 36, True, 0, "bfloat16", spread))
    # B * H past grid.y's 65,535 (the mma.sync and f32 kernels stride over
    # it), at hd 32 and at hd 80, which the wgmma kernel takes below that
    # B * H
    for B, S, H, KV, hd in (WIDE_BH, (1025, 16, 64, 8, 80)):
        cases.append((B, S, H, KV, hd, True, 0, "float32",
                      FLASH_SPREADS[0]))
        for spread in FLASH_SPREADS:
            cases.append((B, S, H, KV, hd, True, 0, "bfloat16", spread))
    # f16 on every mma.sync tile (hd 8 and 40 zero-filled to 32 and 64,
    # 80 to 96, the others their own), and at 64 as a view TMA would map
    for hd in HALF_HEAD_DIMS:
        for spread in FLASH_SPREADS:
            cases.append((1, 200, 4, 2, hd, True, 48, "float16", spread))
    for spread in FLASH_SPREADS:
        cases.append((2, 256, 4, 2, 64, True, 0, "float16", spread))
    results = []
    for B, S, H, KV, hd, causal, window, dt, spread in cases:
        dtype = getattr(torch, dt)
        q = randn((B, S, H, hd), dtype, spread)
        k = randn((B, S, KV, hd), dtype, spread)
        v = randn((B, S, KV, hd), dtype, spread)
        results.append(check(
            f"B={B} S={S:4d} H={H:2d} KV={KV} hd={hd:3d} causal={causal:d} "
            f"window={window:3d} {dt:8s} spread {spread}", q, k, v, causal,
            window, spread))
    # hd 64 bf16 as a view TMA cannot map (its base 2 bytes off 16): the
    # mma.sync kernel's 64-wide tile, element loads
    for spread in FLASH_SPREADS:
        B, S, H, KV, hd = 2, 300, 8, 2, 64
        buf = randn((B * S * (H + 2 * KV) * hd + 1,), torch.bfloat16, spread)
        fused = buf[1:].view(B, S, (H + 2 * KV) * hd)
        q = fused[..., :H * hd].view(B, S, H, hd)
        k = fused[..., H * hd:(H + KV) * hd].view(B, S, KV, hd)
        v = fused[..., (H + KV) * hd:].view(B, S, KV, hd)
        results.append(check(
            f"unaligned views B={B} S={S} H={H} KV={KV} hd={hd} causal "
            f"bfloat16 spread {spread}", q, k, v, True, 0, spread))
    # q, k, v as strided views into one fused (B, S, (H + 2 KV) hd) tensor
    for dt in ("float32", "bfloat16"):
        B, S, H, KV, hd = 2, 300, 8, 2, 64
        fused = randn((B, S, (H + 2 * KV) * hd), getattr(torch, dt),
                      FLASH_SPREADS[0])
        q = fused[..., :H * hd].view(B, S, H, hd)
        k = fused[..., H * hd:(H + KV) * hd].view(B, S, KV, hd)
        v = fused[..., (H + KV) * hd:].view(B, S, KV, hd)
        results.append(check(
            f"strided views B={B} S={S} H={H} KV={KV} hd={hd} window=100 "
            f"{dt}", q, k, v, True, 100, FLASH_SPREADS[0]))
    results += flash_wide_vs_plain(torch, check, randn)
    worst = max(r["max_abs_err"] for r in results
                if r["spread"] == FLASH_SPREADS[0])
    scaled = max(r["scaled_err"] for r in results
                 if r["scaled_err"] is not None)
    wide = max(r["max_abs_err"] for r in results
               if r["spread"] == FLASH_SPREADS[0] and r["shape"][4] > 256)
    zamba = max(r["max_abs_err"] for r in results
                if r["spread"] == FLASH_SPREADS[0]
                and r["shape"] == [Z[x] for x in ("B", "S", "H", "KV", "hd")])
    print(f"flash_attention: {len(results)} cases pass, one launch each; "
          f"max abs error at spread {FLASH_SPREADS[0]} {worst:.3e} "
          f"(tolerances {FLASH_TOL}; at zamba2's shape {zamba:.3e}; past "
          f"head dim 256 {wide:.3e}), largest bf16 or f16 scaled error "
          f"{scaled:.3f} (limit 1)")
    report["flash_errors"] = results
    return worst, zamba, wide


def flash_wide_vs_plain(torch, check, randn) -> list:
    """Phase 7's cases past head dim 256 (the column-group kernels) and in
    mixed dtypes: hd 264, 300, 384 and 512 at S 1024 (causal, and under
    window 512) in f32, bf16 and f16; B * H = 65,600 at hd 300; q, k, v
    in f16, bf16 and f32 (widened to f32, the output in q's dtype) at hd
    128 and 300.  ``check`` is phase 7's; returns its results and prints
    the phase's wall."""
    t0 = time.perf_counter()
    cases = []
    for hd in WIDER_HEAD_DIMS:
        for window in (0, 512):
            cases.append((1, 1024, 4, 2, hd, True, window, ("float32",) * 3,
                          FLASH_SPREADS[0]))
            for dt in HALF_FORMS:
                for spread in FLASH_SPREADS:
                    cases.append((1, 1024, 4, 2, hd, True, window, (dt,) * 3,
                                  spread))
    B, S, H, KV, hd = WIDER_BH
    for dt in ("float32", *HALF_FORMS):
        cases.append((B, S, H, KV, hd, True, 0, (dt,) * 3, FLASH_SPREADS[0]))
    for hd in (128, 300):
        for dts in (("float16", "bfloat16", "float32"),
                    ("float32", "bfloat16", "float16"),
                    ("bfloat16", "float16", "bfloat16")):
            for spread in FLASH_SPREADS:
                cases.append((1, 200, 4, 2, hd, True, 48, dts, spread))
    results = []
    for B, S, H, KV, hd, causal, window, dts, spread in cases:
        q = randn((B, S, H, hd), getattr(torch, dts[0]), spread)
        k = randn((B, S, KV, hd), getattr(torch, dts[1]), spread)
        v = randn((B, S, KV, hd), getattr(torch, dts[2]), spread)
        kind = dts[0] if len(set(dts)) == 1 else "/".join(dts)
        results.append(check(
            f"B={B} S={S:4d} H={H:2d} KV={KV} hd={hd:3d} causal={causal:d} "
            f"window={window:3d} {kind:8s} spread {spread}", q, k, v, causal,
            window, spread))
        del q, k, v
    print(f"  past head dim 256 and mixed dtypes: {len(results)} cases in "
          f"{time.perf_counter() - t0:.1f} s")
    return results


def route_parity(torch, dev, report) -> None:
    """Phase 8: qwen3-4b at full width, 2 layers, f32: kernel route vs
    plain route, and decode vs the full forward."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import registry as R
    phase("phase 8: model-level route parity — qwen3-4b full width, 2 "
          "layers, f32")
    cfg = get_config("qwen3-4b").replace(num_layers=2, dtype="float32",
                                         remat=False)
    params = R.init_params(1, cfg, device=dev)
    B, S = 2, 300
    toks = torch.tensor(token_stream(1, B * S, cfg.vocab_size)
                        .reshape(B, S), dtype=torch.long, device=dev)
    plain, _ = R.apply(params, cfg, {"tokens": toks}, impl="plain")
    flash, _ = R.apply(params, cfg, {"tokens": toks}, impl="kernel")
    route_err = float((flash - plain).abs().max())
    T = 16
    full, _ = R.apply(params, cfg, {"tokens": toks[:, :T]}, impl="kernel")
    cache = R.init_cache(cfg, B, T, torch.float32, device=dev)
    outs = []
    for t in range(T):
        lg, cache = R.decode_step(params, cfg, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    dec_err = float((torch.stack(outs, 1) - full).abs().max())
    scale = float(plain.abs().max())
    print(f"kernel vs plain route: logits ({B}, {S}, {cfg.vocab_size}) max "
          f"abs difference {route_err:.3e} (tolerance {ROUTE_TOL}; max "
          f"|logit| {scale:.2f}); {T} decode steps vs the full forward "
          f"{dec_err:.3e} (tolerance {DECODE_TOL})")
    if not route_err <= ROUTE_TOL:
        fail(f"kernel and plain routes differ by {route_err}")
    if not dec_err < DECODE_TOL:
        fail(f"decode differs from the full forward by {dec_err}")
    report["route_parity"] = dict(route_err=route_err, decode_err=dec_err,
                                  max_logit=scale)
    del params, plain, flash, full, cache
    torch.cuda.empty_cache()


# decode steps in the serving phases' profiled run (after a prefill): the
# trace's processing takes the card's host about 0.75 s a thousand device
# operations (phase 9's prefill and 32 steps of qwen3-4b, 132,652
# operations, took ~100 s), most of a serving phase's wall when it
# profiled 32 steps
PROFILED_STEPS = 4


def serving_path(torch, dev, report, *, arch, phase_no, expected,
                 extra_argv=(), cfg=None, after=None) -> dict:
    """Phases 9, 13, 23 and 25: the serving entry point at full width of
    ``arch``: ``serve_decode.main --full-width``, or, given ``cfg`` (the
    published config cut in depth), ``serve_decode.serve`` on it over a
    cache of the prefill's length.  ``expected`` maps each kernel wrapper
    to the launches one prefill must make (0 for a kernel the path must
    not reach); the entry point's run and the warm run must each make
    exactly those.  ``after(torch, params, cfg, out)`` runs on the model
    before its weights are freed, with the phase's numbers ``out``.
    Returns each wrapper's launches in the entry point's run, by name."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import registry as R
    from repro_torch.serve_decode import SEED, main as serve_main, serve
    B, P, T = PREFILL["B"], PREFILL["S"], 32
    kw = dict(batch=B, tokens=T, cache_len=P, prefill_len=P, device=dev)
    want = {w.__name__: n for w, n in expected.items()}
    if cfg is None:
        what = (f"repro_torch.serve_decode.main --full-width {arch}, B={B}, "
                f"prefill {P}, {T} decode tokens " + " ".join(extra_argv))
    else:
        what = (f"repro_torch.serve_decode.serve on {arch} at full width cut "
                f"to {cfg.num_layers} layers, B={B}, prefill {P}, {T} "
                f"decode tokens over a {P}-slot cache")
    phase(f"phase {phase_no}: serving path — {what}; launches a prefill "
          f"{want}")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(expected)
    t0 = time.perf_counter()
    if cfg is None:
        res = serve_main(["--full-width", "--arch", arch, "--batch", str(B),
                          "--prefill-len", str(P), "--tokens", str(T),
                          "--device", "cuda", *extra_argv])
        cfg, params = res["cfg"], res["params"]
    else:
        params = R.init_params(SEED, cfg, device=dev)
        res = serve(params, cfg, **kw)
    first_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in expected}
    wide = add_wide(expected)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"first run (with init): {first_s:.2f} s; prefill "
          f"{res['prefill_s'] * 1e3:.1f} ms; launches {launches} (of the "
          f"wide kernels {wide}); peak memory {peak_gb:.1f} GB")
    if launches != want:
        fail(f"the {arch} serving path launched {launches} in one prefill, "
             f"not {want}")
    if res["prefill_logits_shape"] != (B, P, cfg.vocab_size):
        fail(f"prefill logits {res['prefill_logits_shape']}")
    if res["tokens"].shape != (B, T) or not bool(
            torch.isfinite(res["logits"]).all()):
        fail("decode gave no finite logits")

    before = {w.__name__: w.launches for w in expected}
    t0 = time.perf_counter()
    warm = serve(params, cfg, **kw)
    wall_ms = (time.perf_counter() - t0) * 1e3
    warm_launches = {w.__name__: w.launches - before[w.__name__]
                     for w in expected}
    if warm_launches != want:
        fail(f"the warm {arch} run launched {warm_launches}, not {want}")
    steps_ms = sorted(x * 1e3 for x in warm["step_s"][1:])
    decode_ms = steps_ms[len(steps_ms) // 2]
    # the profile: one prefill and PROFILED_STEPS decode steps, beside the
    # same run unprofiled
    short = dict(kw, tokens=PROFILED_STEPS)
    t0 = time.perf_counter()
    serve(params, cfg, **short)
    short_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(params, cfg, **short)
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, n_kernels, top = top_device_ops(prof)
    share = busy_ms / short_ms if busy_ms else float("nan")
    print(f"warm: prefill {warm['prefill_s'] * 1e3:.1f} ms ({B}x{P} "
          f"tokens, {B * P / warm['prefill_s']:.0f} tok/s); decode median "
          f"{decode_ms:.2f} ms/token-step (min {steps_ms[0]:.2f}, max "
          f"{steps_ms[-1]:.2f}; {B / decode_ms * 1e3:.1f} tok/s at B={B}); "
          f"prefill + {T} steps {wall_ms:.1f} ms")
    print(f"profile of one prefill + {PROFILED_STEPS} decode steps: device "
          f"busy {busy_ms:.1f} ms over {n_kernels} kernel launches, busy "
          f"share of the unprofiled wall ({short_ms:.1f} ms; "
          f"{prof_ms:.1f} ms profiled) {share:.3f}"
          + ("" if busy_ms else " — no device time recorded: not measured"))
    for t in top:
        print(f"  {t['ms']:9.3f} ms x{t['count']:<6d} {t['name']}")
    out = dict(
        first_run_s=first_s, prefill_ms_first=res["prefill_s"] * 1e3,
        prefill_ms=warm["prefill_s"] * 1e3, decode_ms_median=decode_ms,
        decode_ms_steps=steps_ms, wall_ms=wall_ms,
        profiled_steps=PROFILED_STEPS, wall_ms_short=short_ms,
        wall_ms_profiled=prof_ms, busy_ms=busy_ms, busy_share=share,
        kernel_launches=n_kernels, top=top, launches=launches,
        wide_launches=wide, peak_gb=peak_gb)
    report[f"serving_{arch}"] = out
    if after is not None:
        after(torch, params, cfg, out)
    del res, warm, params
    torch.cuda.empty_cache()
    return launches


def flash_timings(torch, dev, gen, report) -> dict:
    """Phase 10: the kernel at the prefill shape (causal, and window 512),
    at hubert-xlarge's (non-causal, hd 80), at zamba2's shared attention
    (causal, hd 80, H = KV = 32), and at the whole domain's head dims 96
    (Phi-3-mini's heads), 256 (Gemma 2 9B's; bf16 and f16) and 512,
    causal, beside its plain version, the library yardstick and its bound.
    Returns every shape's numbers."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
    F = torch.nn.functional
    phase("phase 10: flash_attention timings at the prefill shape, at "
          "hubert-xlarge's, at zamba2's and at head dims 96, 256 (bf16 and "
          "f16) and 512 (device time from the profiler trace; inputs cycled through > 2x "
          "L2)")
    P, Hu, Z = PREFILL, HUBERT_ATTN, ZAMBA_ATTN
    out = {}
    gemma2 = tuple(GEMMA2_ATTN[x] for x in ("B", "S", "H", "KV", "hd"))
    for key, (B, S, H, KV, hd), causal, window, dt in (
            ("prefill", (P["B"], P["S"], P["H"], P["KV"], P["hd"]), True, 0,
             "bfloat16"),
            ("prefill_w512", (P["B"], P["S"], P["H"], P["KV"], P["hd"]),
             True, 512, "bfloat16"),
            ("hubert", (Hu["B"], Hu["S"], Hu["H"], Hu["KV"], Hu["hd"]),
             False, 0, "bfloat16"),
            ("zamba2", (Z["B"], Z["S"], Z["H"], Z["KV"], Z["hd"]), True, 0,
             "bfloat16"),
            ("hd96", tuple(PHI3_ATTN[x] for x in ("B", "S", "H", "KV", "hd")),
             True, 0, "bfloat16"),
            ("hd256", gemma2, True, 0, "bfloat16"),
            ("hd256_f16", gemma2, True, 0, "float16"),
            ("wide_hd", tuple(WIDE_HD_ATTN[x]
                              for x in ("B", "S", "H", "KV", "hd")), True,
             0, "bfloat16")):
        wide = hd > 256           # 50 calls a timing: it is the slowest
        reps = 50 if wide else 200
        t_wall = time.perf_counter()
        elt = 2
        nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * elt

        def make():
            return tuple((torch.randn(*shape, generator=gen, device=dev)
                          * 0.5).to(getattr(torch, dt))
                         for shape in ((B, S, H, hd), (B, S, KV, hd),
                                       (B, S, KV, hd)))
        sets = cycled_inputs(make, nbytes)
        k_ms, q_ms, host_ms, _ = time_device(
            torch, lambda q, k, v: flash_attention(
                q, k, v, causal=causal, window=window), sets, reps=reps)
        p_ms, *_ = time_device(
            torch, lambda q, k, v: attention_ref_bshd(
                q, k, v, causal=causal, window=window), sets, reps=10)
        # the library call: SDPA, causal or with the window's boolean band
        # mask (qpos - window < kpos <= qpos)
        pos = torch.arange(S, device=dev)
        band = ((pos[None, :] <= pos[:, None])
                & (pos[:, None] - pos[None, :] < window)) if window else None

        def library(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=band, is_causal=causal and band is None,
                enable_gqa=True).transpose(1, 2)
        lib_err = float((library(*sets[0]).float() - flash_attention(
            *sets[0], causal=causal, window=window).float()).abs().max())
        if not lib_err <= FLASH_TOL[dt]:
            fail(f"the library yardstick at {key} computes another "
                 f"function: {lib_err} from the kernel")
        l_ms, *_ = time_device(torch, library, sets, reps=reps)
        # the bound counts Q K^T once; the column-group kernel computes it
        # once a group of 256 columns (executed_flops)
        flops = 4.0 * hd * B * H * attention_pairs(S, S, causal, window)
        b_ms, by = bound_ms(nbytes, flops, hw().PEAK_FLOPS_BF16)
        t = dict(shape=[B, S, H, KV, hd], dtype=dt, causal=causal,
                 window=window, ms=k_ms, queue_ms=q_ms, host_ms=host_ms, plain_ms=p_ms,
                 library_ms=l_ms, library_err=lib_err, bound_ms=b_ms,
                 bound_by=by, flops=flops, tflops=flops / k_ms / 1e9)
        if wide:
            groups = -(-hd // 256)
            t["executed_flops"] = flops / 2 * (groups + 1)
            t["library_backend"] = sdpa_backend(torch, library, sets[0],
                                                causal)
            t["wall_s"] = time.perf_counter() - t_wall
        out[key] = t
        print(f"flash_attention [{B}, {S}, {H}, {KV}, {hd}] {dt} "
              f"{'causal' if causal else 'non-causal'} window={window}: "
              f"kernel {k_ms:.4f} ms ({t['tflops']:.1f} TFLOP/s; queued "
              f"{q_ms:.4f} ms/call, host enqueue {host_ms * 1e3:.1f} "
              f"us/call), bound {b_ms:.4f} ms ({by}), plain {p_ms:.3f} ms, "
              f"library {l_ms:.4f} ms (scaled_dot_product_attention"
              + (", boolean band mask" if window else "")
              + f"; {lib_err:.2e} from the kernel)")
        if wide:
            print(f"  hd {hd}: {groups} column groups, each computing Q K^T "
                  f"whole: {t['executed_flops']:.3e} flops executed for the "
                  f"bound's {flops:.3e}; the library took "
                  f"{t['library_backend']}; {t['wall_s']:.1f} s of wall")
    report["flash_timings"] = out
    return out


def sdpa_backend(torch, library, args, causal: bool) -> str:
    """Which of ``scaled_dot_product_attention``'s backends accept these
    (B, S, heads, hd) inputs alone, and the one its dispatcher picks for
    them (``torch._fused_sdp_choice``)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    takes = []
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal's reasons
                library(*args)
            torch.cuda.synchronize()
            takes.append(name)
        except RuntimeError:
            pass
    q, k, v = (t.transpose(1, 2) for t in args)
    try:
        picked = SDPBackend(torch._fused_sdp_choice(
            q, k, v, None, 0.0, causal, scale=None, enable_gqa=True)).name
    except (AttributeError, TypeError, ValueError, RuntimeError) as e:
        picked = f"not reported ({type(e).__name__})"
    return (f"{picked} (accepted alone: "
            f"{', '.join(takes) or 'no backend'})")


def hubert_path(torch, dev, report, *, others) -> None:
    """Phase 15: hubert-xlarge at its published width (head dim 80)
    through ``registry.apply``: the kernel route against the plain route
    at 2 layers in f32 over B 2 x 300 frames, then the full 48-layer
    forward in bf16 over B 4 x 2048 frames, which must launch
    ``flash_attention`` once a layer, ``others`` never, and give finite
    logits."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import registry as R
    cfg = get_config("hubert-xlarge")
    Hu = HUBERT_ATTN
    phase(f"phase 15: hubert-xlarge (d_model {cfg.d_model}, {cfg.num_heads} "
          f"heads of {cfg.resolved_head_dim}) — registry.apply, route "
          f"parity at 2 layers in f32, then {cfg.num_layers} layers in "
          f"{cfg.dtype} over B {Hu['B']} x {Hu['S']} frames")
    gen = torch.Generator(device=dev).manual_seed(2)
    small = cfg.replace(num_layers=2, dtype="float32", remat=False)
    params = R.init_params(1, small, device=dev)
    batch = {"frame_embeds": torch.randn(2, 300, cfg.d_model, generator=gen,
                                         device=dev)}
    plain, _ = R.apply(params, small, batch, impl="plain")
    kern, _ = R.apply(params, small, batch, impl="kernel")
    route_err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    print(f"kernel vs plain route (f32, 2 layers): logits {tuple(kern.shape)} "
          f"max abs difference {route_err:.3e} (tolerance {ROUTE_TOL}; max "
          f"|logit| {scale:.2f})")
    if not (math.isfinite(scale) and route_err <= ROUTE_TOL):
        fail(f"hubert-xlarge kernel and plain routes differ by {route_err}")
    del params, plain, kern

    params = R.init_params(1, cfg, device=dev)
    batch = {"frame_embeds": torch.randn(Hu["B"], Hu["S"], cfg.d_model,
                                         generator=gen, device=dev)}
    zero_counts((flash_attention, *others))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = R.apply(params, cfg, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches
    other = {w.__name__: w.launches for w in others}
    wide = add_wide((flash_attention, *others))
    t0 = time.perf_counter()
    R.apply(params, cfg, batch)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"forward of {cfg.num_layers} layers: {first_ms:.1f} ms first, "
          f"{warm_ms:.1f} ms warm; flash_attention launches {launches}; "
          f"other kernels {other}; of the wide kernels {wide}; logits "
          f"{tuple(logits.shape)}")
    if launches != cfg.num_layers:
        fail(f"flash_attention launched {launches} times in a forward of "
             f"{cfg.num_layers} layers")
    if any(other.values()):
        fail(f"the hubert-xlarge forward launched other kernels: {other}")
    if tuple(logits.shape) != (Hu["B"], Hu["S"], cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        fail("the hubert-xlarge forward gave no finite logits of the "
             "expected shape")
    report["hubert"] = dict(route_err=route_err, max_logit=scale,
                            launches=launches, wide_launches=wide,
                            forward_ms_first=first_ms,
                            forward_ms_warm=warm_ms)
    del params, logits
    torch.cuda.empty_cache()


def scan_vs_plain(torch, dev, gen, report) -> tuple:
    """Phase 11: the chunk_scan kernel against its plain version (the
    sequential recurrence); returns the largest abs error of the f32 cases
    (y and the final state), over all and over zamba2's call form."""
    from repro_torch.kernels.chunk_scan import chunk_scan
    from repro_torch.kernels.chunk_scan.ref import (chunk_scan_blocked_ref,
                                                    chunk_scan_ref)
    phase("phase 11: chunk_scan kernel vs plain (max abs error of y and the "
          "final state; bf16 y also error / (2^-7 |want| + 2^-8 rms(want "
          "row)), f16 y the same at 2^-10 and 2^-11; the distance to the "
          "blocked plain version, 3 TF32 passes, beside it)")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def check(B, T, H, K, V, chunk, mode, dt, ld_const=None, ld_scale=0.8,
              strided=False, dts=None):
        """``dts``: r's, k's and v's dtypes where they differ (``dt``
        names the case)."""
        rwkv = mode == "rwkv"
        if strided:       # r, k, v as views into one fused projection
            fused = (randn(B, T, H, 2 * K + V) * 0.3).to(getattr(torch, dt))
            r, k, v = fused[..., :K], fused[..., K:2 * K], fused[..., 2 * K:]
        else:
            r, k = ((randn(B, T, H, K) * 0.3).to(getattr(torch, d))
                    for d in (dts or (dt, dt))[:2])
            v = (randn(B, T, H, V) * 0.3).to(
                getattr(torch, dts[2] if dts else dt))
        s0 = randn(B, H, K, V) * 0.1
        shape = (B, T, H, K) if rwkv else (B, T, H)
        ld = (-torch.rand(*shape, generator=gen, device=dev) * ld_scale
              if ld_const is None else torch.full(shape, ld_const,
                                                  device=dev))
        name = (f"B={B} T={T:4d} H={H:2d} K={K:2d} V={V:3d} chunk={chunk:3d} "
                f"{mode:5s} {dt:8s}" + (" strided" if strided else "")
                + (f" ld={ld_const}" if ld_const is not None else ""))
        u = randn(H, K) * 0.2 if rwkv else None
        return compare(name, dt, r, k, v, ld, s0, chunk, u)

    def check_model_form(B, T, H, K, V, chunk, dt, aligned=True):
        """Mamba2 in ``models/mamba.block``'s call form: one conv output
        (B, T, H V + 2 K) holds x | B | C; v is its x columns viewed
        (B, T, H, V) (row stride H V + 2 K), r its C columns broadcast
        over the heads (head stride 0), k = B * dt materialised, the
        decay a scalar per head (B, T, H) in f32.  ``aligned=False``
        shifts the conv output by one element: its rows are no longer 16
        bytes apart, so the kernel takes its element loads."""
        dtype = getattr(torch, dt)
        width = H * V + 2 * K
        buf = (randn(B, T, width + (0 if aligned else 1)) * 0.3).to(dtype)
        xc = buf if aligned else buf[..., 1:]
        v = xc[..., :H * V].view(B, T, H, V)
        Bm, Cm = xc[..., H * V:H * V + K], xc[..., H * V + K:]
        dt_h = torch.nn.functional.softplus(randn(B, T, H) - 2.0)
        k = Bm.view(B, T, 1, K) * dt_h[..., None].to(dtype)
        r = Cm.view(B, T, 1, K).expand(B, T, H, K)
        ld = -dt_h * torch.exp(randn(H) * 0.5)
        if r.stride(2) != 0 or v.stride(1) != width + (0 if aligned else 1):
            fail(f"chunk_scan model form: strides r {r.stride()}, v "
                 f"{v.stride()}")
        name = (f"B={B} T={T:4d} H={H:2d} K={K:2d} V={V:3d} chunk={chunk:3d} "
                f"mamba {dt:8s} model form, r head stride 0, v row stride "
                f"{v.stride(1)}" + ("" if aligned else " (element loads)"))
        s0 = randn(B, H, K, V) * 0.1
        return compare(name, dt, r, k, v, ld, s0, chunk, None,
                       model_form=True)

    def compare(name, dt, r, k, v, ld, s0, chunk, u, model_form=False):
        kw = dict(include_current=u is None, bonus=u)
        before = (chunk_scan.launches, chunk_scan.wide_launches)
        y, s_fin = chunk_scan(r, k, v, ld, s0, chunk=chunk, **kw)
        if chunk_scan.launches != before[0] + 1:
            fail(f"chunk_scan {name}: the wrapper launched "
                 f"{chunk_scan.launches - before[0]} kernels, not one")
        if chunk_scan.wide_launches - before[1] != int(r.shape[3] > 128):
            fail(f"chunk_scan {name}: the channel-block kernel ran "
                 f"{chunk_scan.wide_launches - before[1]} times at K "
                 f"{r.shape[3]}")
        y_want, s_want = chunk_scan_ref(r, k, v, ld, s0, **kw)
        y_blk, s_blk = chunk_scan_blocked_ref(r, k, v, ld, s0, chunk=chunk,
                                              tf32_passes=3, **kw)
        torch.cuda.synchronize()
        if y.dtype != v.dtype or s_fin.dtype != torch.float32:
            fail(f"chunk_scan {name}: output dtypes {y.dtype}, {s_fin.dtype}")
        dt = str(v.dtype).split(".")[-1]
        if not (bool(torch.isfinite(y).all())
                and bool(torch.isfinite(s_fin).all())):
            fail(f"chunk_scan {name}: non-finite output")
        yg, yw = y.float(), y_want.float()
        y_err = float((yg - yw).abs().max())
        s_err = float((s_fin - s_want).abs().max())
        blk_err = max(float((yg - y_blk.float()).abs().max()),
                      float((s_fin - s_blk).abs().max()))
        scaled = None
        if dt in HALF_FORMS:
            rel, row = HALF_FORMS[dt]
            row_rms = yw.square().mean(-1, keepdim=True).sqrt()
            limit = rel * yw.abs() + row * row_rms
            scaled = float(((yg - yw).abs() / limit).max())
        print(f"  {name}: y {y_err:.3e}, state {s_err:.3e}, rms |y| "
              f"{float(yw.square().mean().sqrt()):.3e}"
              + (f", scaled {scaled:.3f}" if scaled is not None else "")
              + f"; to the blocked version {blk_err:.3e}")
        if dt == "float32" and not y_err <= SCAN_TOL:
            fail(f"chunk_scan {name}: y error {y_err} > {SCAN_TOL}")
        if not s_err <= SCAN_TOL:
            fail(f"chunk_scan {name}: state error {s_err} > {SCAN_TOL}")
        if scaled is not None and not scaled <= 1.0:
            fail(f"chunk_scan {name}: scaled error {scaled} > 1")
        return dict(name=name, dtype=dt, y_err=y_err, s_err=s_err,
                    scaled_err=scaled, blocked_err=blk_err,
                    model_form=model_form, K=r.shape[3])

    results = []
    for B, T, H, K, V, chunk in ((1, 64, 2, 8, 16, 16),
                                 (2, 128, 3, 16, 32, 32),
                                 (1, 96, 1, 4, 64, 32)):
        for mode in ("rwkv", "mamba"):
            for dt in ("float32", "bfloat16"):
                results.append(check(B, T, H, K, V, chunk, mode, dt))
    for dt in ("float32", "bfloat16"):
        results.append(check(1, 256, 40, 64, 128, 128, "mamba", dt))  # zamba2
        results.append(check(2, 300, 3, 64, 64, 100, "rwkv", dt,
                             strided=True))
    results.append(check(2, 24, 2, 64, 64, 128, "rwkv", "float32"))
    results.append(check(2, 21, 2, 12, 20, 128, "mamba", "float32"))
    c = SCAN_SERVE
    results.append(check(c["B"], c["T"], c["H"], c["K"], c["V"], c["chunk"],
                         "rwkv", "bfloat16", ld_scale=1.2))
    # every step at the clamp: the TPU kernel's factor exp(-L) reaches
    # exp(128) within a chunk of 128, past f32's exp(88.72)
    for mode in ("rwkv", "mamba"):
        for dt in ("float32", "bfloat16"):
            results.append(check(1, 256, 2, 64, 64, 128, mode, dt,
                                 ld_const=-1.0))
    print(f"  at ld = -1, chunk 128: the TPU kernel's exp(-L) would reach "
          f"exp(128.0) > exp({F32_EXP_MAX}) (not a finite f32)")
    # many chunks (128 steps of the state pass), one chunk, three V tiles
    results.append(check(2, 2048, 4, 64, 64, 16, "rwkv", "float32"))
    results.append(check(2, 128, 4, 64, 64, 128, "rwkv", "float32"))
    results.append(check(2, 256, 4, 64, 192, 128, "mamba", "float32"))
    # zamba2's Mamba2 layers in the model's call form: f32 at 256 steps,
    # bf16 at the serving shape, both load paths
    z = SCAN_ZAMBA
    for aligned in (True, False):
        results.append(check_model_form(2, 256, z["H"], z["K"], z["V"],
                                         z["chunk"], "float32", aligned))
        results.append(check_model_form(z["B"], z["T"], z["H"], z["K"],
                                        z["V"], z["chunk"], "bfloat16",
                                        aligned))
    # the whole domain: K up to 256 (the 128- and 256-channel kernels),
    # K and V off multiples of 4 (element loads; odd V one element at a
    # time), chunks longer than a sub-block (256 at K 128; 64 at K 256 in
    # f32, whose sub-blocks are 32 steps); then mamba2-2.7b's Mamba2 layers
    # in the model's call form at the serving size
    for K, V, chunk, T in WIDE_SCAN:
        for mode in ("rwkv", "mamba"):
            for dt in ("float32", "bfloat16"):
                results.append(check(2, T, 2, K, V, chunk, mode, dt))
    m = SCAN_MAMBA2
    results.append(check_model_form(m["B"], m["T"], m["H"], m["K"], m["V"],
                                    m["chunk"], "bfloat16"))
    # K past the 256-channel tiles (the channel-block kernel), f16 on every
    # tile width, and r, k, v in three dtypes (widened to f32, y in v's)
    t0 = time.perf_counter()
    n_wide = len(results)
    for K in WIDER_K:
        for V in WIDER_K_V:
            for chunk in (64, 128):
                for mode in ("rwkv", "mamba"):
                    for dt in ("float32", *HALF_FORMS):
                        results.append(check(1, 256, 2, K, V, chunk, mode,
                                             dt))
    for mode in ("rwkv", "mamba"):
        for dt in ("float32", "bfloat16"):
            results.append(check(1, 256, 2, 512, 64, 128, mode, dt,
                                 ld_const=-1.0))
        for K in (8, 64, 128, 256):
            results.append(check(2, 128, 3, K, 32, 64, mode, "float16"))
        for K in (64, 300):
            results.append(check(1, 128, 2, K, 64, 64, mode, "mixed",
                                 dts=("float16", "float32", "bfloat16")))
    print(f"  past K 256, f16 and mixed dtypes: {len(results) - n_wide} "
          f"cases in {time.perf_counter() - t0:.1f} s")
    zamba = max(max(r["y_err"], r["s_err"]) for r in results
                if r["dtype"] == "float32" and r["model_form"])
    worst = max(max(r["y_err"], r["s_err"]) for r in results
                if r["dtype"] == "float32")
    scaled = max(r["scaled_err"] for r in results
                 if r["scaled_err"] is not None)
    wide = max(max(r["y_err"], r["s_err"]) for r in results
               if r["dtype"] == "float32" and r["K"] > 256)
    print(f"chunk_scan: {len(results)} cases pass, one launch each; max abs "
          f"error in f32 {worst:.3e} (tolerance {SCAN_TOL}; in zamba2's call "
          f"form {zamba:.3e}; past K 256 {wide:.3e}), largest bf16 or f16 "
          f"scaled error {scaled:.3f} (limit 1), every output finite")
    report["chunk_scan_errors"] = results
    return worst, zamba, wide


def decode_vs_full(torch, cfg, params, toks, impl) -> list:
    """Decode ``toks`` (B, T) one token a step from an empty cache and
    hold each step's logits against the full forward over ``toks``
    through ``impl``: the largest |difference| at each position."""
    from repro_torch.models import registry as R
    B, T = toks.shape
    full, _ = R.apply(params, cfg, {"tokens": toks}, impl=impl)
    cache = R.init_cache(cfg, B, T, getattr(torch, cfg.dtype),
                         device=toks.device)
    outs = []
    for t in range(T):
        lg, cache = R.decode_step(params, cfg, cache, toks[:, t:t + 1])
        outs.append(lg[:, 0])
    return (torch.stack(outs, 1) - full).abs().amax(dim=(0, 2)).tolist()


def to_double(tree):
    """A param tree in float64, converted in place leaf by leaf (so the
    whole tree never lies on the card in both dtypes at once)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            to_double(v)
        else:
            tree[k] = v.double()
    return tree


def rwkv_route_parity(torch, dev, report) -> None:
    """Phase 12: rwkv6-7b at full width, 2 layers: the kernel route vs the
    plain route in f32, and decode vs the full forward in float64 (and,
    printed, in f32 through the kernel route)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import registry as R
    phase("phase 12: model-level route parity — rwkv6-7b full width, 2 "
          "layers; decode vs the full forward in float64")
    cfg = get_config("rwkv6-7b").replace(num_layers=2, dtype="float32",
                                         remat=False)
    params = R.init_params(1, cfg, device=dev)
    B, S = 2, 2 * cfg.chunk_size
    toks = torch.tensor(token_stream(1, B * S, cfg.vocab_size)
                        .reshape(B, S), dtype=torch.long, device=dev)
    plain, _ = R.apply(params, cfg, {"tokens": toks}, impl="plain")
    kern, _ = R.apply(params, cfg, {"tokens": toks}, impl="kernel")
    route_err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    del plain, kern
    T = 16
    dec_f32 = decode_vs_full(torch, cfg, params, toks[:, :T], "kernel")
    dec_f32_plain = decode_vs_full(torch, cfg, params, toks[:, :T], "plain")
    dec_f64 = decode_vs_full(torch, cfg.replace(dtype="float64"),
                             to_double(params), toks[:, :T], "plain")
    dec_err = max(dec_f64)
    print(f"kernel vs plain route (f32): logits ({B}, {S}, {cfg.vocab_size}) "
          f"max abs difference {route_err:.3e} (tolerance {ROUTE_TOL}; max "
          f"|logit| {scale:.2f}); {T} decode steps vs the full forward in "
          f"float64 {dec_err:.3e} (tolerance {DECODE_TOL}); in f32 (not "
          f"gated) through the kernel route {max(dec_f32):.3e}, the plain "
          f"route {max(dec_f32_plain):.3e}; by position, kernel route: "
          + " ".join(f"{x:.1e}" for x in dec_f32))
    if not (math.isfinite(scale) and route_err <= ROUTE_TOL):
        fail(f"rwkv6-7b kernel and plain routes differ by {route_err}")
    if not dec_err < DECODE_TOL:
        fail(f"rwkv6-7b decode differs from the full forward by {dec_err}")
    report["rwkv_route_parity"] = dict(
        route_err=route_err, decode_err_f64=dec_err, max_logit=scale,
        decode_err_f64_by_position=dec_f64,
        decode_err_f32_by_position=dec_f32,
        decode_err_f32_plain_by_position=dec_f32_plain)
    del params
    torch.cuda.empty_cache()


def lowest_in_chunk_decay(torch, params, cfg, out) -> None:
    """Phase 13, after the timed runs: one more prefill of the serving
    prompt, recording each layer's clamped log-decay — its mean, the share
    of steps at the clamp, and the lowest cumulative sum within a chunk
    (where the JAX package's factor exp(-L) would overflow below
    -88.72)."""
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import scan_ops
    from repro_torch.serve_decode import SEED
    B, P = PREFILL["B"], PREFILL["S"]
    layers = []
    orig = scan_ops.chunked_scan

    def spy(r, k, v, log_decay, state0=None, *, chunk, **kw):
        ld = scan_ops._prep_decay(log_decay, r.shape[-1])
        L = ld.reshape(ld.shape[0], -1, chunk, *ld.shape[2:]).cumsum(2)
        layers.append(dict(
            lowest_cumsum=float(L.min()), mean=float(ld.mean()),
            at_clamp=float((ld <= -scan_ops.LOG_DECAY_CLAMP).float().mean())))
        return orig(r, k, v, log_decay, state0, chunk=chunk, **kw)

    prompt = torch.tensor(token_stream(SEED, B * P, cfg.vocab_size)
                          .reshape(B, P), dtype=torch.long,
                          device=params["final_norm"].device)
    scan_ops.chunked_scan = spy
    try:
        logits = make_prefill_step(cfg)(params, {"tokens": prompt})
    finally:
        scan_ops.chunked_scan = orig
    if len(layers) != cfg.num_layers or not bool(
            torch.isfinite(logits).all()):
        fail("the recorded prefill did not run every layer to finite logits")
    low = min(range(len(layers)), key=lambda i: layers[i]["lowest_cumsum"])
    print(f"log-decay over the prefill's {len(layers)} layers: mean "
          f"{sum(x['mean'] for x in layers) / len(layers):.4f} a step, "
          f"{max(x['at_clamp'] for x in layers) * 100:.2f} % of steps at "
          f"the clamp in the layer with most; lowest in-chunk cumulative "
          f"sum {layers[low]['lowest_cumsum']:.2f} (layer {low}; the JAX "
          f"package's exp(-L) overflows below -{F32_EXP_MAX})")
    out["decay"] = dict(layers=layers, lowest_layer=low)


def scan_timings(torch, dev, gen, report) -> dict:
    """Phase 14: the kernel at rwkv6-7b's serving shape (RWKV6 mode), at
    zamba2's and at mamba2-2.7b's (Mamba2 mode, in the model's call form:
    r with a head stride of 0, v a view of the conv output; K 128 and
    chunk 256 at mamba2-2.7b's), beside its plain version and its bound.
    Returns every shape's numbers."""
    from repro_torch.kernels.chunk_scan import chunk_scan
    from repro_torch.kernels.chunk_scan.ref import chunk_scan_ref
    c, z = SCAN_SERVE, SCAN_ZAMBA
    m = SCAN_MAMBA2
    phase(f"phase 14: chunk_scan timings at rwkv6-7b's serving shape "
          f"[{c['B']}, {c['T']}, {c['H']}, {c['K']}, {c['V']}] chunk "
          f"{c['chunk']} bf16 RWKV6, at zamba2's [{z['B']}, {z['T']}, "
          f"{z['H']}, {z['K']}, {z['V']}] Mamba2, at mamba2-2.7b's "
          f"[{m['B']}, {m['T']}, {m['H']}, {m['K']}, {m['V']}] chunk "
          f"{m['chunk']} Mamba2 and at K 512 (device time from the profiler "
          f"trace; inputs cycled through > 2x L2)")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def rwkv_inputs():
        B, T, H, K, V = (c[x] for x in ("B", "T", "H", "K", "V"))
        return ((randn(B, T, H, K) * 0.3).bfloat16(),
                (randn(B, T, H, K) * 0.3).bfloat16(),
                (randn(B, T, H, V) * 0.3).bfloat16(),
                -torch.rand(B, T, H, K, generator=gen, device=dev) * 1.2,
                randn(B, H, K, V) * 0.1, randn(H, K) * 0.2)

    def mamba_inputs(z):
        """As ``models/mamba.block`` passes them: v and r views of one
        conv output, k = B * dt, the decay (B, T, H) f32."""
        B, T, H, K, V = (z[x] for x in ("B", "T", "H", "K", "V"))
        xc = (randn(B, T, H * V + 2 * K) * 0.3).bfloat16()
        dt_h = torch.nn.functional.softplus(randn(B, T, H) - 2.0)
        return (xc[..., H * V + K:].view(B, T, 1, K).expand(B, T, H, K),
                xc[..., H * V:H * V + K].view(B, T, 1, K)
                * dt_h[..., None].bfloat16(),
                xc[..., :H * V].view(B, T, H, V),
                -dt_h * torch.exp(randn(H) * 0.5),
                randn(B, H, K, V) * 0.1, None)

    out = {}
    m, wk = SCAN_MAMBA2, SCAN_WIDE_K
    for key, cfg, make in (("rwkv6", c, rwkv_inputs),
                           ("zamba2", z, lambda: mamba_inputs(z)),
                           ("mamba2", m, lambda: mamba_inputs(m)),
                           ("wide_k", wk, lambda: mamba_inputs(wk))):
        B, T, H, K, V, Lc = (cfg[x] for x in ("B", "T", "H", "K", "V",
                                              "chunk"))
        rwkv = key == "rwkv6"
        wide = K > 128         # the channel-block kernel
        t_wall = time.perf_counter()
        # bytes each input is read and each output written once: r, k, v
        # and y in bf16 (zamba2's r is one (B, T, K) row block read by
        # every head), the decay in f32 (a channel each for RWKV6, a scalar
        # a head for Mamba2), s0 and s_fin in f32, the bonus u
        nbytes = (B * T * (H if rwkv else 1) * K * 2 + B * T * H * K * 2
                  + 2 * B * T * H * V * 2 + B * T * H * (K if rwkv else 1)
                  * 4 + 2 * B * H * K * V * 4 + (H * K * 4 if rwkv else 0))
        kw = dict(include_current=not rwkv)

        def kernel(r, k, v, ld, s0, u):
            return chunk_scan(r, k, v, ld, s0, bonus=u, chunk=Lc, **kw)

        def plain(r, k, v, ld, s0, u):
            return chunk_scan_ref(r, k, v, ld, s0, bonus=u, **kw)

        sets = cycled_inputs(make, nbytes)
        k_ms, q_ms, host_ms, _ = time_device(
            torch, kernel, sets,
            only="chunk_scan_wide_kernel" if wide else "chunk_scan_kernel")
        w_ms, *_ = time_device(torch, kernel, sets)
        # one call of the plain version: its 2048 steps launch ~30,000
        # device operations, whose trace takes the host ~20 s to process;
        # past K 256 CUDA events around one call instead (the gaps between
        # its operations included), to keep the phase short
        p_ms = (events_ms(torch, plain, sets[0]) if wide
                else time_device(torch, plain, sets, reps=1)[0])
        # query-key pairs a chunk: s < t (RWKV6, the bonus apart) or
        # s <= t (Mamba2)
        pairs = Lc * (Lc - 1) // 2 if rwkv else Lc * (Lc + 1) // 2
        flops = B * H * (T // Lc) * 2.0 * (Lc * K * V + pairs * K
                                           + pairs * V + K * Lc * V)
        # the products run on the tensor cores (TF32 operands): the bound
        # is the bytes; the earlier design's products on the f32 FMA units
        b_ms, by = bound_ms(nbytes, flops, peak=hw().PEAK_FLOPS_TF32)
        fma_ms = flops / hw().PEAK_FLOPS_F32 * 1e3
        tf32_ms = flops / hw().PEAK_FLOPS_TF32 * 1e3
        t = dict(shape=[B, T, H, K, V], chunk=Lc, ms=k_ms, wrapper_ms=w_ms,
                 queue_ms=q_ms, host_ms=host_ms, plain_ms=p_ms,
                 library_ms=None, bound_ms=b_ms, bound_by=by,
                 bound_fma_ms=fma_ms, bound_tf32_ms=tf32_ms, flops=flops,
                 nbytes=nbytes, tflops=flops / k_ms / 1e9,
                 plain_timer="events" if wide else "profiler",
                 wall_s=time.perf_counter() - t_wall)
        out[key] = t
        print(f"chunk_scan [{B}, {T}, {H}, {K}, {V}] chunk {Lc} bf16 "
              f"{'RWKV6' if rwkv else 'Mamba2, model call form'}: kernel "
              f"{k_ms:.4f} ms ({t['tflops']:.1f} TFLOP/s; the wrapper "
              f"{w_ms:.4f} ms; queued {q_ms:.4f} ms/call, host enqueue "
              f"{host_ms * 1e3:.1f} us/call), bound {b_ms:.4f} ms ({by}, "
              f"{nbytes / 1e6:.1f} MB; the {flops:.3e} flops take "
              f"{tf32_ms:.4f} ms at the TF32 tensor-core peak, {fma_ms:.4f} "
              f"ms at the f32 FMA peak of the earlier design), plain "
              f"{p_ms:.2f} ms{' (CUDA events, one call)' if wide else ''}, "
              f"library none (no single PyTorch call computes the "
              f"recurrence)" + (f"; {t['wall_s']:.1f} s of wall" if wide
                                else ""))
    report["chunk_scan_timings"] = out
    return out


def events_ms(torch, fn, args) -> float:
    """CUDA events around one call of ``fn(*args)`` after a warm one (ms):
    the device's span of the call, gaps between its operations
    included."""
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def zamba_route_parity(torch, dev, report) -> None:
    """Phase 22: zamba2-2.7b at full width with 2 groups (12 Mamba2
    layers, the shared block twice), f32: the kernel route against the
    plain route, and 16 decode steps against the full forward through both
    routes (as ``tests/test_torch_mamba.py`` holds them on the CPU), with
    the same comparison in float64 (the plain route) printed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import registry as R
    base = get_config("zamba2-2.7b")
    cfg = base.replace(num_layers=2 * base.attn_every, dtype="float32",
                       remat=False)
    phase(f"phase 22: model-level route parity — zamba2-2.7b full width, "
          f"{cfg.num_layers} Mamba2 layers in 2 groups, f32")
    params = R.init_params(1, cfg, device=dev)
    B, S = 2, 2 * cfg.chunk_size
    toks = torch.tensor(token_stream(1, B * S, cfg.vocab_size)
                        .reshape(B, S), dtype=torch.long, device=dev)
    plain, _ = R.apply(params, cfg, {"tokens": toks}, impl="plain")
    kern, _ = R.apply(params, cfg, {"tokens": toks}, impl="kernel")
    route_err = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    del plain, kern
    T = 16
    dec_kernel = decode_vs_full(torch, cfg, params, toks[:, :T], "kernel")
    dec_plain = decode_vs_full(torch, cfg, params, toks[:, :T], "plain")
    params = to_double(params)
    dec_f64 = decode_vs_full(torch, cfg.replace(dtype="float64"), params,
                             toks[:, :T], "plain")
    dec_err = max(max(dec_kernel), max(dec_plain))
    print(f"kernel vs plain route (f32): logits ({B}, {S}, {cfg.vocab_size}) "
          f"max abs difference {route_err:.3e} (tolerance {ROUTE_TOL}; max "
          f"|logit| {scale:.2f}); {T} decode steps vs the full forward in "
          f"f32 {dec_err:.3e} (tolerance {DECODE_TOL}; kernel route "
          f"{max(dec_kernel):.3e}, plain route {max(dec_plain):.3e}; in "
          f"float64, not gated, {max(dec_f64):.3e}); by position, kernel "
          f"route: " + " ".join(f"{x:.1e}" for x in dec_kernel))
    if not (math.isfinite(scale) and route_err <= ROUTE_TOL):
        fail(f"zamba2-2.7b kernel and plain routes differ by {route_err}")
    if not dec_err < DECODE_TOL:
        fail(f"zamba2-2.7b decode differs from the full forward by "
             f"{dec_err}")
    report["zamba_route_parity"] = dict(
        route_err=route_err, decode_err=dec_err, max_logit=scale,
        decode_err_kernel_by_position=dec_kernel,
        decode_err_plain_by_position=dec_plain,
        decode_err_f64_by_position=dec_f64)
    del params
    torch.cuda.empty_cache()


MOE_PARITY_FACTOR = 64.0    # capacity factor under which nothing drops


def moe_route_parity(torch, dev, report, flash_attention) -> None:
    """Phase 24: the moe family in f32, as ``tests/test_torch_moe.py``
    holds it on the CPU.  (a) deepseek-v2-236b at full width, 2 layers
    (the dense MLA layer, one MoE layer): decode against the full forward,
    ``q_chunks=4`` against one chunk, and both again in float64 (printed,
    not gated).  (b) kimi-k2-1t-a32b reduced: the kernel route against
    the plain route with ``flash_attention`` launching once a layer, and
    decode against the full forward."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models import registry as R
    cfg = get_config("deepseek-v2-236b").replace(
        num_layers=2, dtype="float32", remat=False,
        moe_capacity_factor=MOE_PARITY_FACTOR)
    phase(f"phase 24: model-level parity — deepseek-v2-236b full width, "
          f"{cfg.num_layers} layers (MLA; q_lora_rank {cfg.q_lora_rank}; "
          f"{cfg.num_experts} experts top-{cfg.top_k}, capacity factor "
          f"{MOE_PARITY_FACTOR:g}), f32; kimi-k2-1t-a32b reduced")
    params = R.init_params(1, cfg, device=dev)
    B, S, T = 2, 256, 16
    toks = torch.tensor(token_stream(1, B * S, cfg.vocab_size)
                        .reshape(B, S), dtype=torch.long, device=dev)

    def chunks_err(cfg, params):
        one, _ = R.apply(params, cfg, {"tokens": toks})
        four, _ = R.apply(params, cfg, {"tokens": toks}, q_chunks=4)
        return float((four - one).abs().max()), float(one.abs().max())

    chunk_err, scale = chunks_err(cfg, params)
    dec = decode_vs_full(torch, cfg, params, toks[:, :T], "plain")
    cfg64 = cfg.replace(dtype="float64")
    params = to_double(params)
    chunk_err64, _ = chunks_err(cfg64, params)
    dec64 = decode_vs_full(torch, cfg64, params, toks[:, :T], "plain")
    del params
    torch.cuda.empty_cache()
    print(f"deepseek-v2-236b, 2 layers: {T} decode steps (absorbed MLA over "
          f"the latent cache) vs the full forward (expanded MLA) "
          f"{max(dec):.3e} (tolerance {DECODE_TOL}; float64, not gated, "
          f"{max(dec64):.3e}); q_chunks=4 vs 1 over ({B}, {S}) "
          f"{chunk_err:.3e} (tolerance {MLA_CHUNKS_TOL}; float64 "
          f"{chunk_err64:.3e}); max |logit| {scale:.2f}; by position: "
          + " ".join(f"{x:.1e}" for x in dec))
    if not (math.isfinite(scale) and max(dec) < DECODE_TOL):
        fail(f"deepseek-v2-236b decode differs from the full forward by "
             f"{max(dec)}")
    if not chunk_err <= MLA_CHUNKS_TOL:
        fail(f"deepseek-v2-236b q_chunks=4 differs from one chunk by "
             f"{chunk_err}")

    kcfg = get_config("kimi-k2-1t-a32b").reduced().replace(
        remat=False, dtype="float32", moe_capacity_factor=MOE_PARITY_FACTOR)
    kparams = R.init_params(1, kcfg, device=dev)
    ktoks = torch.tensor(token_stream(2, B * S, kcfg.vocab_size)
                         .reshape(B, S), dtype=torch.long, device=dev)
    plain, _ = R.apply(kparams, kcfg, {"tokens": ktoks}, impl="plain")
    flash_attention.launches = 0
    kern, aux = R.apply(kparams, kcfg, {"tokens": ktoks}, impl="kernel")
    launches = flash_attention.launches
    route_err = float((kern - plain).abs().max())
    kscale = float(plain.abs().max())
    del plain, kern
    kdec = decode_vs_full(torch, kcfg, kparams, ktoks[:, :T], "kernel")
    print(f"kimi-k2-1t-a32b reduced ({kcfg.num_layers} layers, "
          f"{kcfg.num_experts} experts top-{kcfg.top_k}): kernel vs plain "
          f"route ({B}, {S}) {route_err:.3e} (tolerance {ROUTE_TOL}; max "
          f"|logit| {kscale:.2f}; aux {float(aux):.4f}); flash_attention "
          f"launches in one prefill {launches}; {T} decode steps vs the "
          f"full forward {max(kdec):.3e} (tolerance {DECODE_TOL})")
    if launches != kcfg.num_layers:
        fail(f"kimi-k2's kernel route launched flash_attention {launches} "
             f"times in a {kcfg.num_layers}-layer prefill")
    if not (math.isfinite(kscale) and route_err <= ROUTE_TOL):
        fail(f"kimi-k2 kernel and plain routes differ by {route_err}")
    if not max(kdec) < DECODE_TOL:
        fail(f"kimi-k2 decode differs from the full forward by {max(kdec)}")
    report["moe_route_parity"] = dict(
        deepseek_decode_err=max(dec), deepseek_decode_err_f64=max(dec64),
        deepseek_chunks_err=chunk_err, deepseek_chunks_err_f64=chunk_err64,
        deepseek_max_logit=scale, deepseek_decode_err_by_position=dec,
        kimi_route_err=route_err, kimi_decode_err=max(kdec),
        kimi_flash_launches=launches, kimi_max_logit=kscale)
    del kparams
    torch.cuda.empty_cache()


def moe_drop_share(torch, params, cfg, out) -> None:
    """Phase 25's ``after``: one more prefill of the serving prompt, with
    ``moe_ffn`` wrapped to count from the router's own top-k how many
    token-to-expert assignments each MoE layer's capacity drops."""
    from repro_torch.data.synthetic import token_stream
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import moe as MOE
    from repro_torch.serve_decode import SEED
    B, P = PREFILL["B"], PREFILL["S"]
    dev = params["final_norm"].device
    prompt = torch.tensor(token_stream(SEED, B * P, cfg.vocab_size)
                          .reshape(B, P), dtype=torch.long, device=dev)
    layers = []
    moe_ffn = MOE.moe_ffn

    def counting(p, cfg, x, **kw):
        T, E, k = x.shape[0] * x.shape[1], cfg.num_experts, cfg.top_k
        ids = MOE.route(p, cfg, x.reshape(T, -1))[2]
        C = MOE.moe_capacity(T, E, k, cfg.moe_capacity_factor)
        load = torch.bincount(ids.flatten(), minlength=E)
        layers.append(dict(capacity=C, max_load=int(load.max()),
                           assignments=T * k,
                           dropped=int((load - C).clamp(min=0).sum())))
        return moe_ffn(p, cfg, x, **kw)

    MOE.moe_ffn = counting
    try:
        make_prefill_step(cfg)(params, {"tokens": prompt})
    finally:
        MOE.moe_ffn = moe_ffn
    if len(layers) != cfg.num_layers - cfg.first_dense_layers:
        fail(f"the prefill ran {len(layers)} MoE layers")
    share = (sum(l["dropped"] for l in layers)
             / sum(l["assignments"] for l in layers))
    print(f"MoE capacity factor {cfg.moe_capacity_factor}: dropped share "
          f"of the prefill's assignments {share:.4f}; by layer "
          + "; ".join(f"{l['dropped']} of {l['assignments']} (capacity "
                      f"{l['capacity']}, busiest expert {l['max_load']})"
                      for l in layers))
    out.update(moe_layers=layers, dropped_share=share)


# ---- LM training: phases 27-29 ---------------------------------------------

TRAIN_ARCH = "qwen3-4b"
# phase 27: the train step at full width, 2 layers in f32, 5 AdamW steps of
# B 4 x 2048 (launch.train's lr), with remat off and on
TRAIN = dict(layers=2, B=4, S=2048, steps=5, lr=1e-3)
# remat on and off run the same kernels on the same inputs, so they should
# agree bit for bit; the stated bound where they do not: each loss within
# 1e-6 of the other, relatively, and the updated weights within 1e-6 but
# for AdamW's sign flips (an element whose gradient rounding sets moves by
# +-lr either way), at most 1e-4 of the weights
REMAT_LOSS_REL, REMAT_W_TOL, FLIP_SHARE = 1e-6, 1e-6, 1e-4
# the f32 gradient against the float64 one on the card, per leaf, |g32 -
# g64| over the leaf's max |g64|, at B 2 x 128.  Set before the first run:
# f32 GEMMs over K <= 9728 err by ~sqrt(K) 2^-24 of their scale, so sound
# readings should lie near 1e-6-1e-4; a gradient that a forward-only kernel
# dropped (the attention output detached: q, k, v get none) errs by 1.0 on
# wq, wk, wv and the q/k norms
GRAD64 = dict(B=2, S=128)
GRAD64_LIMIT = 1e-3
# phase 28: llm_federated_pretrain.run at the example's defaults
LM_FL = dict(sats=8, seq=128, seqs_per_sat=32, local_iters=4, epochs=3)
# phase 28's limits on card - CPU: the final model's L2 distance over its
# norm and the largest eval-loss difference.  Set from an H100's readings
# (PERF.md §6): the sound card run read 4.50e-5 and 2.86e-6 (AdamW flips
# ~500 of 2.9M elements by more than 1e-4), the lost-update control
# 4.39e-3 and 1.93e-2; each limit lies near the geometric mean of the two
LM_FL_MODEL_REL = 4e-4
LM_FL_EVAL_TOL = 2e-4
# phase 29: the same run at full width, qwen3-4b cut to 1 layer, f32
LM_FL_FULL = dict(sats=4, seq=128, seqs_per_sat=32, local_iters=4, epochs=2)
# the kernel line's LM shapes: fed_agg over phase 29's bank and carry, and
# flash_attention at the evaluator's call (16 sequences of 128 tokens)
LM_EVAL_ATTN = dict(B=16, S=128, H=32, KV=8, hd=128)


def flips(torch, a, b, tol):
    """(max |a - b|, elements of |a - b| beyond ``tol``, ||a - b|| /
    ||b||) of two flat tensors, in float64."""
    d = (a.double() - b.double()).abs()
    return (float(d.max()), int((d > tol).sum()),
            float(torch.linalg.norm(d) / torch.linalg.norm(b.double())))


def leaf_errors(torch, got, want):
    """Per leaf, max |got - want| over max |want| ('/'-joined paths)."""
    from repro_torch.tree import tree_leaves, tree_paths
    out = {}
    for (path, g), w in zip(tree_paths(got), tree_leaves(want)):
        w = w.double()
        scale = float(w.abs().max())
        err = float((g.double() - w).abs().max())
        out["/".join(path)] = err / scale if scale else err
    return out


class EpochFedAgg:
    """``core.epoch_step.fed_agg`` wrapped for one simulator run (a context
    manager): ``hook(real, i, stack, gamma, base, base_weight, **kw)``
    makes the ``i``-th call of the run."""

    def __init__(self, hook):
        self.hook, self.calls = hook, 0

    def __enter__(self):
        from repro_torch.core import epoch_step
        self.real = epoch_step.fed_agg

        def wrapped(stack, gamma, base=None, base_weight=0.0, **kw):
            i, self.calls = self.calls, self.calls + 1
            return self.hook(self.real, i, stack, gamma, base, base_weight,
                             **kw)
        epoch_step.fed_agg = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core import epoch_step
        epoch_step.fed_agg = self.real


def train_path(torch, dev, report, wrappers) -> None:
    """Phase 27: ``launch.train.train`` on qwen3-4b at full width cut to
    2 layers in f32, remat off then on (no kernel may launch; equal
    results); the f32 gradient against float64 on the card, with the
    attention output detached as the known-bad control; the forward-only
    kernels' refusals on CUDA tensors."""
    from repro_torch.configs import get_config
    from repro_torch.core.modelbank import flatten_tree
    from repro_torch.kernels.chunk_scan import chunk_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import make_batch, train
    from repro_torch.models import layers as L
    from repro_torch.models import registry as R
    T = TRAIN
    cfg = get_config(TRAIN_ARCH).replace(num_layers=T["layers"],
                                         dtype="float32")
    n = R.analytic_param_count(cfg)
    phase(f"phase 27: LM training — repro_torch.launch.train.train on "
          f"{TRAIN_ARCH} at full width cut to {T['layers']} layers, f32 "
          f"({n:,} parameters), {T['steps']} AdamW steps of B "
          f"{T['B']} x {T['S']}, remat off and on; f32 gradients against "
          f"float64")
    for w in wrappers:
        w.launches = 0
    runs = {}
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        # what is held before the run (the other run's weights among it):
        # phase 31 holds its prediction against the peak above it
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        out = train(cfg.replace(remat=remat), steps=T["steps"],
                    batch=T["B"], seq=T["S"], lr=T["lr"], device=dev,
                    log=None)
        wall = time.perf_counter() - t0
        runs[remat] = dict(
            losses=out["losses"], step_s=out["step_s"], wall_s=wall,
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            base_gb=base / 1e9, flat=flatten_tree(out["params"]))
        del out
        r = runs[remat]
        print(f"remat={remat}: losses {[round(x, 5) for x in r['losses']]}; "
              f"step wall (s) {[round(x, 3) for x in r['step_s']]} (the "
              f"first with the allocator's warm-up); peak memory "
              f"{r['peak_gb']:.1f} GB; {wall:.1f} s with init")
    launches = {w.__name__: w.launches for w in wrappers}
    if any(launches.values()):
        fail(f"phase 27's training launched kernels: {launches}")
    if not all(math.isfinite(x) for r in runs.values() for x in r["losses"]):
        fail("phase 27: a non-finite training loss")
    a, b = runs[False], runs[True]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                        b["losses"]))
    w_max, w_beyond, _ = flips(torch, a["flat"], b["flat"], REMAT_W_TOL)
    bit_equal = a["losses"] == b["losses"] and torch.equal(a["flat"],
                                                           b["flat"])
    same = "bit-equal" if bit_equal else "not bit-equal"
    print(f"remat against no remat: {same}; losses {loss_rel:.3e} apart "
          f"(relative, bound "
          f"{REMAT_LOSS_REL}), weights max {w_max:.3e}, {w_beyond} of {n:,} "
          f"beyond {REMAT_W_TOL} (bound {FLIP_SHARE} of them)")
    if not bit_equal and not (loss_rel <= REMAT_LOSS_REL
                              and w_beyond <= FLIP_SHARE * n):
        fail("phase 27: remat changed the training beyond its bound")
    for r in runs.values():
        del r["flat"]
    torch.cuda.empty_cache()

    # f32 gradients against float64, and the detached-attention control
    B2, S2 = GRAD64["B"], GRAD64["S"]
    params = R.init_params(0, cfg, device=dev)
    batch = make_batch(cfg, B2, S2, seed=0, device=dev)
    _, _, g32 = loss_and_grads(params, cfg, batch)
    plain = L.attention_scores
    L.attention_scores = lambda *a, **k: plain(*a, **k).detach()
    try:
        _, _, g_bad = loss_and_grads(params, cfg, batch)
    finally:
        L.attention_scores = plain
    cfg64 = cfg.replace(dtype="float64")
    _, _, g64 = loss_and_grads(to_double(params), cfg64,
                               make_batch(cfg64, B2, S2, seed=0, device=dev))
    del params
    sound = leaf_errors(torch, g32, g64)
    bad = leaf_errors(torch, g_bad, g64)
    del g32, g_bad, g64
    torch.cuda.empty_cache()
    worst = max(sound, key=sound.get)
    worst_bad = max(bad, key=bad.get)
    print(f"gradients at B {B2} x {S2}, f32 against float64, per leaf "
          f"max|g32 - g64| / max|g64|: worst {sound[worst]:.3e} ({worst}; "
          f"limit {GRAD64_LIMIT}, set before the run); the control with "
          f"the attention output detached: worst {bad[worst_bad]:.3e} "
          f"({worst_bad}), {sum(v > GRAD64_LIMIT for v in bad.values())} "
          f"of {len(bad)} leaves beyond the limit")
    if not sound[worst] <= GRAD64_LIMIT:
        fail(f"phase 27: the f32 gradient of {worst} is {sound[worst]} from "
             f"float64")
    if not bad[worst_bad] > GRAD64_LIMIT:
        fail("phase 27: the limit does not reject the detached attention")

    # the forward-only kernels refuse grad on CUDA tensors, before a launch
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    before = (flash_attention.launches, chunk_scan.launches)
    refused = []
    for name, call in (
            ("flash_attention", lambda: flash_attention(
                rnd(1, 16, 2, 64).requires_grad_(True), rnd(1, 16, 2, 64),
                rnd(1, 16, 2, 64))),
            ("chunk_scan", lambda: chunk_scan(
                rnd(1, 16, 2, 16), rnd(1, 16, 2, 16), rnd(1, 16, 2, 16),
                (-rnd(1, 16, 2, 16).abs()).requires_grad_(True),
                chunk=16))):
        try:
            call()
        except RuntimeError as e:
            if "forward-only" in str(e):
                refused.append(name)
    if refused != ["flash_attention", "chunk_scan"] or before != (
            flash_attention.launches, chunk_scan.launches):
        fail(f"phase 27: under grad on the card the kernels refused "
             f"{refused} and launched "
             f"{flash_attention.launches - before[0]}, "
             f"{chunk_scan.launches - before[1]} times")
    print(f"under grad on CUDA tensors {refused} raise before launching")
    report["lm_train"] = dict(
        params=n, runs={str(k): v for k, v in runs.items()},
        launches=launches, remat_bit_equal=bit_equal,
        remat_loss_rel=loss_rel, remat_w_max=w_max,
        remat_w_beyond=w_beyond, grad64_limit=GRAD64_LIMIT,
        grad64_errors=sound, grad64_control_errors=bad,
        refusals=refused)


def lm_fl_cpu_start():
    """Phase 28's CPU run of the port, started in a process of its own
    (stopped at exit): (process, output path)."""
    import atexit
    import tempfile
    path = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_fl_")) / "cpu.pt"
    code = (f"import sys, torch\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
            "torch.set_num_threads(6)\n"
            "from repro_torch.llm_federated_pretrain import example_config, "
            "run\n"
            f"res = run(example_config({TRAIN_ARCH!r}), device='cpu', "
            f"log=None, **{LM_FL!r})\n"
            "torch.save(dict(history=[vars(r) for r in res['history']], "
            f"w=res['sim']._w_flat, wall_s=res['wall_s']), {str(path)!r})\n")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc, path


def lm_fl_path(torch, dev, report, cpu_job, wrappers) -> None:
    """Phase 28: ``llm_federated_pretrain.run`` at the example's defaults on
    the card, against the same run on the CPU (``cpu_job``), with a
    known-bad control: the card's run with one selected model replaced by
    the global it trained from at the last commit."""
    import shutil
    from repro_torch.llm_federated_pretrain import SEED, example_config, run
    from repro_torch.models import registry as R
    from repro_torch.tree import tree_map
    cfg = example_config(TRAIN_ARCH)
    # the CPU run's weights: a torch.Generator on the card draws others
    host = R.init_params(SEED, cfg, device="cpu")
    phase(f"phase 28: LM FL — repro_torch.llm_federated_pretrain.run at "
          f"the example's defaults ({TRAIN_ARCH} reduced, {cfg.num_layers} "
          f"layers, d_model {cfg.d_model}; {LM_FL}), card against CPU")
    zero_counts(wrappers)
    positive = []

    def record(real, i, stack, gamma, base, bw, **kw):
        positive.append(bool((gamma > 0).any()))
        return real(stack, gamma, base, bw, **kw)

    t0 = time.perf_counter()
    with EpochFedAgg(record):
        res = run(cfg, device=dev, log=None,
                  params=tree_map(lambda t: t.to(dev), host), **LM_FL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sim, hist = res["sim"], res["history"]
    prog = sim.trainer._epoch_programs[sim._spec]
    steps = (prog.dispatches, prog.fallback_dispatches)
    launches = {w.__name__: w.launches for w in wrappers}
    wide = add_wide(wrappers)
    print(f"card: {len(hist)} records in {wall:.2f} s, {sum(steps)} epoch "
          f"steps ({steps[1]} fallback), launches {launches} (of the wide "
          f"kernels {wide})")
    check_launches("phase 28", hist, launches["fed_agg"], steps,
                   LM_FL["epochs"])
    if steps[1] == 0 and launches["fed_agg"] != steps[0]:
        fail(f"phase 28: fed_agg launched {launches['fed_agg']} times for "
             f"{steps[0]} fused epochs")
    want = {"fed_agg": launches["fed_agg"], "pairwise_dist_sq": 0,
            "chunk_scan": 0,
            "flash_attention": len(hist) * cfg.num_layers}
    if launches != want:
        fail(f"phase 28 launched {launches}, not {want}")
    w_card = sim._w_flat.clone()
    del res, sim

    # the known-bad control: at the last commit with a selected model, the
    # heaviest bank row replaced by the global it trained from
    last = max(i for i, p in enumerate(positive) if p)

    def lose(real, i, stack, gamma, base, bw, **kw):
        if i == last:
            stack[int(torch.argmax(gamma))].copy_(base)
        return real(stack, gamma, base, bw, **kw)

    with EpochFedAgg(lose):
        bad = run(cfg, device=dev, log=None,
                  params=tree_map(lambda t: t.to(dev), host), **LM_FL)
    bad_hist, w_bad = bad["history"], bad["sim"]._w_flat.clone()
    del bad

    proc, path = cpu_job
    t0 = time.perf_counter()
    err = proc.communicate(timeout=900)[1]
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 28's CPU run failed:\n{err[-3000:]}")
    cpu = torch.load(path)
    shutil.rmtree(path.parent, ignore_errors=True)
    cpu_hist = [types.SimpleNamespace(**r) for r in cpu["history"]]
    w_cpu = cpu["w"].to(dev)
    if len(cpu_hist) != len(hist):
        fail(f"phase 28: the CPU run recorded {len(cpu_hist)} epochs")
    for a, b in zip(hist, cpu_hist):
        ka = (a.epoch, a.time_s, a.num_models, a.gamma, a.stale_groups)
        kb = (b.epoch, b.time_s, b.num_models, b.gamma, b.stale_groups)
        if ka != kb:
            fail(f"phase 28: card and CPU histories differ: {ka} vs {kb}")
        print(f"  epoch {a.epoch}: t={a.time_s / 3600:.3f} h eval_loss "
              f"{-a.accuracy:.6f} (CPU {-b.accuracy:.6f}, control "
              f"{-bad_hist[a.epoch].accuracy:.6f}) models={a.num_models}")
    readings = {}
    for label, h, w in (("card", hist, w_card), ("control", bad_hist, w_bad)):
        w_max, beyond, rel = flips(torch, w, w_cpu, 1e-4)
        ev = max(abs(x.accuracy - y.accuracy) for x, y in zip(h, cpu_hist))
        readings[label] = dict(w_max=w_max, w_beyond_1e4=beyond, w_rel=rel,
                               eval_max_diff=ev)
        print(f"{label} - CPU: final model max {w_max:.3e}, {beyond} of "
              f"{w.numel():,} beyond 1e-4, L2 over the norm {rel:.3e} (limit "
              f"{LM_FL_MODEL_REL}); eval loss max {ev:.3e} (limit "
              f"{LM_FL_EVAL_TOL})")
    s, c = readings["card"], readings["control"]
    if not (s["w_rel"] <= LM_FL_MODEL_REL and s["eval_max_diff"]
            <= LM_FL_EVAL_TOL):
        fail("phase 28: the card's run is outside its limits of the CPU's")
    if not (c["w_rel"] > LM_FL_MODEL_REL and c["eval_max_diff"]
            > LM_FL_EVAL_TOL):
        fail("phase 28: the limits do not reject the lost-update control")
    print(f"the CPU run took {cpu['wall_s']:.1f} s (waited {waited:.1f} s "
          f"for it); host fields equal; the control fails both limits")
    report["lm_fl"] = dict(
        config=LM_FL, wall_s=wall, cpu_wall_s=cpu["wall_s"],
        epoch_steps=steps, launches=launches, readings=readings,
        model_rel_limit=LM_FL_MODEL_REL, eval_limit=LM_FL_EVAL_TOL,
        history=[vars(r) for r in hist],
        history_cpu=[vars(r) for r in cpu_hist])


def lm_fl_full_width(torch, dev, report, wrappers) -> dict:
    """Phase 29: ``llm_federated_pretrain.run`` on qwen3-4b at full width
    cut to 1 layer in f32: one fed_agg launch a fused epoch, each commit
    held against ``fed_agg_ref`` on the same bank, flash_attention once an
    evaluation; CUDA-event spans of the training, the aggregation and the
    evaluation; peak memory."""
    from repro_torch import llm_federated_pretrain as LFP
    from repro_torch.configs import get_config
    from repro_torch.fl.client import LMPool
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    from repro_torch.models import registry as R
    cfg = get_config(TRAIN_ARCH).replace(num_layers=1, dtype="float32",
                                         remat=False)
    N = R.analytic_param_count(cfg)
    phase(f"phase 29: LM FL at full width — llm_federated_pretrain.run on "
          f"{TRAIN_ARCH} cut to 1 layer, f32 (N = {N:,}); {LM_FL_FULL}")
    zero_counts(wrappers)
    spans = {"train": [], "fed_agg": [], "eval": []}
    errs = []

    def span(key):
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        spans[key].append(pair)
        return pair

    def check(real, i, stack, gamma, base, bw, **kw):
        base0 = base.clone()
        e0, e1 = span("fed_agg")
        e0.record()
        out = real(stack, gamma, base, bw, **kw)
        e1.record()
        s2, g2 = kw.get("stack2"), kw.get("gamma2")
        err, step = 0.0, 1 << 26
        for a in range(0, N, step):
            want = fed_agg_ref(stack[:, a:a + step], gamma,
                               base0[a:a + step], bw,
                               None if s2 is None else s2[:, a:a + step], g2)
            err = max(err, float((out[a:a + step] - want).abs().max()))
        errs.append(err)
        del base0
        return out

    train_stacked = LMPool.train_stacked
    make_evaluator = LFP.make_evaluator

    def timed_train(self, *a, **k):
        e0, e1 = span("train")
        e0.record()
        out = train_stacked(self, *a, **k)
        e1.record()
        return out

    def timed_evaluator(*a, **k):
        ev = make_evaluator(*a, **k)

        def evaluator(p):
            e0, e1 = span("eval")
            e0.record()
            v = ev(p)
            e1.record()
            return v
        return evaluator

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    LMPool.train_stacked, LFP.make_evaluator = timed_train, timed_evaluator
    try:
        t0 = time.perf_counter()
        with EpochFedAgg(check):
            res = LFP.run(cfg, device=dev, log=None, **LM_FL_FULL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        LMPool.train_stacked, LFP.make_evaluator = train_stacked, \
            make_evaluator
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    sim, hist = res["sim"], res["history"]
    prog = sim.trainer._epoch_programs[sim._spec]
    steps = (prog.dispatches, prog.fallback_dispatches)
    launches = {w.__name__: w.launches for w in wrappers}
    wide = add_wide(wrappers)
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
    print(f"{len(hist)} records, wall {wall:.2f} s, peak memory {peak:.1f} "
          f"GB, {sum(steps)} epoch steps ({steps[1]} fallback), launches "
          f"{launches} (of the wide kernels {wide})")
    for r in hist:
        print(f"  epoch {r.epoch}: t={r.time_s / 3600:.3f} h eval_loss "
              f"{-r.accuracy:.5f} models={r.num_models}")
    print(f"CUDA-event spans (ms): training {[round(x, 1) for x in ms['train']]}"
          f", fed_agg {[round(x, 3) for x in ms['fed_agg']]} (bound "
          f"{(10 * N * 4) / hw().HBM_BW * 1e3:.2f} ms over the bank "
          f"and the carry, 6.30 over the bank alone), evaluation "
          f"{[round(x, 1) for x in ms['eval']]}; fed_agg against fed_agg_ref "
          f"by commit {[f'{e:.2e}' for e in errs]} (tolerance "
          f"{FED_AGG_TOL})")
    if sim._spec.num_params != N:
        fail(f"phase 29's bank has {sim._spec.num_params} columns, not {N}")
    check_launches("phase 29", hist, launches["fed_agg"], steps,
                   LM_FL_FULL["epochs"])
    want = {"fed_agg": sum(steps), "pairwise_dist_sq": 0, "chunk_scan": 0,
            "flash_attention": len(hist) * cfg.num_layers}
    if steps[1] or launches != want:
        fail(f"phase 29 launched {launches}, not {want} ({steps[1]} "
             f"fallback steps)")
    if not errs or not max(errs) <= FED_AGG_TOL:
        fail(f"phase 29's aggregates are {errs} from fed_agg_ref")
    if not all(math.isfinite(r.accuracy) for r in hist):
        fail("phase 29: a non-finite eval loss")
    out = dict(params=N, config=LM_FL_FULL, wall_s=wall, peak_gb=peak,
               epoch_steps=steps, launches=launches, fed_agg_err=errs,
               spans_ms=ms, eval_loss=[-r.accuracy for r in hist],
               history=[vars(r) for r in hist])
    report["lm_fl_full"] = out
    del res, sim
    torch.cuda.empty_cache()
    return out


def lm_timings_process(N: int) -> dict:
    """``lm_kernel_timings`` in a process of its own: in the smoke's
    process, after phases 1-29, an H100's profiler traces of ``fed_agg``
    at phase 29's shape held no device operation three times, where a
    fresh process's traces held every launch (PERF.md §7), as phase 6
    found for its own timings."""
    code = (f"import json, sys\n"
            f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
            "import torch, chip_smoke as cs\n"
            "dev = torch.device('cuda')\n"
            "gen = torch.Generator(device=dev).manual_seed(0)\n"
            f"out = cs.lm_kernel_timings(torch, dev, gen, {N})\n"
            "print(json.dumps(dict(out, traces=cs.TRACES)))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        fail(f"phase 29's timing process failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, n in out.pop("traces").items():
        TRACES[key] += n
    for key in ("fed_agg_lm", "fed_agg_lm_bank"):
        t = out[key]
        print(f"fed_agg {t['shape']} (bank, carry, N): kernel {t['ms']:.3f} "
              f"ms, bound {t['bound_ms']:.3f} ms ({t['bound_by']}), plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms "
              f"({'two' if t['shape'][1] else 'one'} torch.addmv)")
    t = out["flash_lm_eval"]
    print(f"flash_attention {t['shape']} f32 causal: kernel {t['ms']:.4f} "
          f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, f32 peak), "
          f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms "
          f"(SDPA f32, {t['library_err']:.2e} from the kernel); kernel - "
          f"plain {t['max_abs_err']:.2e}")
    return out


def lm_kernel_timings(torch, dev, gen, N: int) -> dict:
    """The kernel line's LM shapes: ``fed_agg`` over phase 29's bank (4
    rows) and carry (4 rows) of N columns, and over the bank alone; and
    ``flash_attention`` in f32 at the evaluator's call, beside their plain
    versions, library calls and bounds."""
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.kernels.fed_agg.ref import fed_agg_ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref_bshd
    F = torch.nn.functional
    out = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    C = LM_FL_FULL["sats"]
    s, s2, b = randn(C, N), randn(C, N), randn(N)
    g = torch.rand(C, generator=gen, device=dev) / C
    g2 = torch.rand(C, generator=gen, device=dev) / C
    for key, two in (("fed_agg_lm", True), ("fed_agg_lm_bank", False)):
        kw = dict(stack2=s2, gamma2=g2) if two else {}
        rows = 2 * C if two else C
        nbytes = (rows * N + 2 * N + rows) * 4
        k_ms, q_ms, host_ms, n = time_device(
            torch, lambda: fed_agg(s, g, b, 0.35, out=b, **kw), [()],
            reps=10, per_call=1)
        p_ms = time_device(torch, lambda: fed_agg_ref(
            s, g, b, 0.35, *((s2, g2) if two else ())), [()], reps=3)[0]
        lib = ((lambda: torch.addmv(torch.addmv(b, s.t(), g, beta=0.35),
                                    s2.t(), g2)) if two else
               (lambda: torch.addmv(b, s.t(), g, beta=0.35)))
        l_ms = time_device(torch, lib, [()], reps=3)[0]
        bm, by = bound_ms(nbytes, 2.0 * rows * N)
        out[key] = dict(shape=[C, C if two else 0, N], ms=k_ms,
                        queue_ms=q_ms, host_ms=host_ms, plain_ms=p_ms,
                        library_ms=l_ms, bound_ms=bm, bound_by=by,
                        launches=n)
    del s, s2, b
    torch.cuda.empty_cache()

    A = LM_EVAL_ATTN
    B, S, H, KV, hd = A["B"], A["S"], A["H"], A["KV"], A["hd"]
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * 4
    sets = cycled_inputs(lambda: tuple(randn(*shape) * 0.5 for shape in (
        (B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))), nbytes)
    got = flash_attention(*sets[0], causal=True)
    err = float((got - attention_ref_bshd(*sets[0], causal=True))
                .abs().max())
    if not err <= FLASH_TOL["float32"]:
        fail(f"flash_attention f32 at the evaluator's shape is {err} from "
             f"its plain version")
    k_ms, q_ms, host_ms, _ = time_device(
        torch, lambda q, k, v: flash_attention(q, k, v, causal=True), sets)
    p_ms = time_device(torch, lambda q, k, v: attention_ref_bshd(
        q, k, v, causal=True), sets, reps=20)[0]

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
    lib_err = float((library(*sets[0]) - got).abs().max())
    l_ms = time_device(torch, library, sets)[0]
    flops = 4.0 * hd * B * H * attention_pairs(S, S, True, 0)
    bm, by = bound_ms(nbytes, flops)
    out["flash_lm_eval"] = dict(
        shape=[B, S, H, KV, hd], dtype="float32", ms=k_ms, queue_ms=q_ms,
        host_ms=host_ms, plain_ms=p_ms, library_ms=l_ms, library_err=lib_err,
        bound_ms=bm, bound_by=by, max_abs_err=err)
    return out


# phase 30: the mesh runtime (launch/mesh.py) on the one card.  (a), (c)
# and (d) run in a one-rank NCCL group; (b) as two processes sharing the
# card in a gloo group (NCCL refuses two ranks on one device; gloo sums
# CUDA tensors through the host).  Runs across several cards wait for a
# machine with more than one
MESH_EPOCHS = 2
MESH_WORLD = 2
EP_SHAPE = (2, 2048)                 # tokens through the MoE layer
EP_FACTOR = 1.0                      # one rank: C = T k slots, none drop
FL_SATS, FL_ITERS, FL_LR = 4, 2, 0.05
FL_TOL = 1e-5


def epoch_trace(prog) -> dict:
    """Record, on the host, the rows each step of ``prog`` trains (a
    rank's own rows on a mesh) and the model it ends with."""
    rec = {"rows": [], "w": []}
    train, step = prog._train, prog.step

    def traced_train(*args, **kw):
        stack, losses = train(*args, **kw)
        rec["rows"].append(stack.cpu())
        return stack, losses

    def traced_step(*args, **kw):
        out = step(*args, **kw)
        rec["w"].append(out[0].cpu())
        return out
    prog._train, prog.step = traced_train, traced_step
    return rec


def mesh_sim(work, mesh, epochs=MESH_EPOCHS, trace=False):
    """Phase 4's configuration (asyncfleo-hap over 3 days) on ``work``,
    with ``mesh``: (simulation, history, wall s, and with ``trace``
    ``epoch_trace``'s record)."""
    import torch
    from repro_torch.core.epoch_step import make_epoch_program
    from repro_torch.core.simulator import FLSimulation, SimConfig
    from repro_torch.fl.strategies import get_strategy
    rec = (epoch_trace(make_epoch_program(work.pool, work.w0, mesh=mesh))
           if trace else None)
    sim = FLSimulation(get_strategy("asyncfleo-hap"), work.pool,
                       work.evaluator,
                       SimConfig(duration_s=3 * 86400.0, mesh=mesh))
    t0 = time.perf_counter()
    hist = sim.run(work.w0, max_epochs=epochs)
    torch.cuda.synchronize()
    return sim, hist, time.perf_counter() - t0, rec


def mesh_rank(rank: int, world: int, store: str, out: str) -> None:
    """Phase 30 (b)'s rank: phase 4's workload built anew on cuda:0, run
    on a data mesh over a ``world``-process gloo group; the history, the
    rows it trained in the first epoch, the model after each epoch, the
    steps and each kernel's launches go to ``out``."""
    import torch
    import torch.distributed as dist
    from repro_torch.fl_constellation_sim import build_workload
    from repro_torch.kernels.chunk_scan import chunk_scan
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.pairwise_dist import pairwise_dist_sq
    from repro_torch.launch.mesh import make_data_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        work = build_workload(iid=True, device="cuda")
        mesh = make_data_mesh(device="cuda")
        wrappers = (fed_agg, pairwise_dist_sq, flash_attention, chunk_scan)
        for w in wrappers:
            w.launches = 0
        sim, hist, wall, rec = mesh_sim(work, mesh, trace=True)
        prog = sim._fused_prog
        torch.save(dict(history=[vars(r) for r in hist],
                        w=sim._w_flat.cpu(), wall_s=wall,
                        rows0=rec["rows"][0], w_by_epoch=rec["w"],
                        steps=(prog.dispatches, prog.fallback_dispatches),
                        launches={w.__name__: w.launches for w in wrappers},
                        mesh=repr(mesh)), out)
    finally:
        dist.destroy_process_group()


def mesh_ranks_start(tmp: Path) -> list:
    """Phase 30 (b)'s processes, started (stopped at exit)."""
    import atexit
    procs = []
    for rank in range(MESH_WORLD):
        code = (f"import sys\n"
                f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]\n"
                "import chip_smoke as cs\n"
                f"cs.mesh_rank({rank}, {MESH_WORLD}, "
                f"{str(tmp / 'store')!r}, {str(tmp / f'rank{rank}.pt')!r})\n")
        procs.append(subprocess.Popen([sys.executable, "-c", code],
                                      stdout=subprocess.DEVNULL,
                                      stderr=subprocess.PIPE, text=True))

    def stop():
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    atexit.register(stop)
    return procs


class HalvesPool:
    """A pool whose fused-epoch training runs each epoch's participants in
    two halves: the row blocks, and so the batch shapes, that the ranks of
    a two-rank data mesh train (phase 30 (b)).  Everything else is the
    wrapped pool's."""

    def __init__(self, pool):
        self.pool = pool

    def __getattr__(self, name):
        return getattr(self.pool, name)

    def epoch_train_fn(self):
        import torch
        fn = self.pool.epoch_train_fn()

        def train(params, inputs, ids, seed):
            h = len(ids) // 2
            (a, la), (b, lb) = (fn(params, tuple(t[lo:hi] for t in inputs),
                                   ids[lo:hi], seed)
                                for lo, hi in ((0, h), (h, len(ids))))
            return ({k: torch.cat([a[k], b[k]]) for k in a},
                    torch.cat([la, lb]))
        return train


def host_rows(hist):
    """The host fields of history records (objects or their ``vars``)."""
    return [tuple((r if isinstance(r, dict) else vars(r))[k] for k in
                  ("epoch", "time_s", "num_models", "gamma", "stale_groups"))
            for r in hist]


def mesh_runtime(torch, dev, report, main_sim, main_hist, wrappers) -> None:
    """Phase 30: the mesh runtime on the card.  (a) the epoch path on a
    one-rank data mesh (NCCL); (b) the same on two processes sharing the
    card (gloo); (c) expert-parallel MoE, one deepseek-v2-236b layer at
    full width; (d) the constellation-parallel FL round on the qwen3-4b
    reduced loss.  ``main_sim``/``main_hist``: phase 4's run."""
    import tempfile

    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.fl.sharded import make_fl_round
    from repro_torch.kernels.fed_agg import fed_agg
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import moe as MOE
    from repro_torch.models import registry as R
    from repro_torch.models.moe_ep import make_ep_moe_layer
    from repro_torch.tree import tree_leaves, tree_map
    card = report["card"]
    others = [w for w in wrappers if w is not fed_agg]
    phase(f"phase 30: mesh runtime — (a) phase 4's configuration, "
          f"{MESH_EPOCHS} epochs, on a one-rank NCCL data mesh; (b) the "
          f"same over {MESH_WORLD} gloo processes sharing the card; (c) "
          f"expert-parallel MoE, deepseek-v2-236b at full width; (d) the FL "
          f"round on the qwen3-4b reduced loss")
    t_phase = time.perf_counter()
    out = report["mesh_runtime"] = {"card": card}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    procs = mesh_ranks_start(tmp)

    # ---- (a) the epoch path, one rank -----------------------------------
    work = sim_workload(main_sim)
    _s, plain_hist, _w, _r = mesh_sim(work, None)
    plain_w = _s._w_flat.clone()
    # (b)'s yardstick: the unsharded step with each epoch's participants
    # trained in the two ranks' row blocks (the same batch shapes)
    _s, _h, _w, halves = mesh_sim(dataclasses.replace(
        work, pool=HalvesPool(work.pool)), None, trace=True)
    mesh = make_data_mesh(device=dev)
    if (dist.get_backend(), mesh.shape) != ("nccl", (1, 1)):
        fail(f"(a): the data mesh is {mesh} over {dist.get_backend()}, not "
             f"one NCCL rank")
    for w in wrappers:
        w.launches = 0
    sim, hist, wall, _r = mesh_sim(work, mesh)
    launches = {w.__name__: w.launches for w in wrappers}
    steps = sim._fused_prog.dispatches + sim._fused_prog.fallback_dispatches
    rows_equal = [vars(r) for r in hist] == \
        [vars(r) for r in main_hist[:MESH_EPOCHS]]
    bits_equal = torch.equal(sim._w_flat, plain_w)
    print(f"(a) one-rank mesh {mesh}: {len(hist)} epochs in {wall:.3f} s, "
          f"{steps} steps, launches {launches}; records equal phase 4's "
          f"first {MESH_EPOCHS}: {rows_equal}; model bit-equal to the "
          f"unsharded run of the same epochs: {bits_equal}")
    if not rows_equal or not bits_equal:
        fail("(a): the one-rank mesh run is not phase 4's run")
    if launches["fed_agg"] != steps or any(w.launches for w in others):
        fail(f"(a): launches {launches} for {steps} steps")
    out["a"] = dict(wall_s=wall, steps=steps, launches=launches)

    # ---- (c) expert-parallel MoE, one layer at full width ----------------
    cfg = get_config("deepseek-v2-236b").replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(30)
    p = MOE.init_moe_ffn(gen, cfg, device=dev)
    expert_gb = sum(p[k].numel() * 4 for k in ("we1", "we3", "we2")) / 1e9
    x = torch.randn(*EP_SHAPE, cfg.d_model, generator=gen, device=dev) * 0.5
    mesh11 = make_host_mesh(device=dev)
    moe = make_ep_moe_layer(cfg, mesh11, capacity_factor=EP_FACTOR)
    for w in wrappers:
        w.launches = 0
    ep_s = []
    for _ in range(2):              # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe(p, x)
        torch.cuda.synchronize()
        ep_s.append(time.perf_counter() - t0)
    dropped = int(moe.dropped)
    ep_launches = {w.__name__: w.launches for w in wrappers}
    t0 = time.perf_counter()
    want = MOE.moe_ffn_reference(p, cfg, x)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    err = float((y - want).abs().max())
    scale = float(want.abs().max())
    # both sides sum the same products over d, over f and over the k
    # routed experts and the shared one, in other orders: f32 rounding of
    # a K-term sum moves it by about eps sqrt(K) of its scale; 4x margin,
    # and never looser than 1e-4 of max |y|
    derived = 4 * F32_EPS * (math.sqrt(cfg.d_model) +
                             math.sqrt(cfg.moe_d_ff) +
                             math.sqrt(cfg.top_k + 1)) * scale
    tol = min(derived, 1e-4 * scale)
    del p, want
    torch.cuda.empty_cache()
    print(f"(c) deepseek-v2-236b MoE layer (d {cfg.d_model}, "
          f"{cfg.num_experts} experts, moe_d_ff {cfg.moe_d_ff}, top-"
          f"{cfg.top_k}, {cfg.num_shared_experts} shared; {expert_gb:.1f} GB "
          f"of f32 expert weights) on {EP_SHAPE[0]}x{EP_SHAPE[1]} tokens, "
          f"one NCCL rank, capacity factor {EP_FACTOR:g}: dropped "
          f"{dropped}, aux {float(aux):.6f}; max |ep - moe_ffn_reference| "
          f"{err:.3e} (tolerance {tol:.3e} = min(4 eps (sqrt d + sqrt f + "
          f"sqrt(k + 1)), 1e-4) x max |y| {scale:.3e}); {ep_s[0]:.3f} s "
          f"cold, {ep_s[1]:.3f} s warm, the reference {ref_s:.3f} s; "
          f"launches {ep_launches}")
    if dropped or not math.isfinite(float(aux)):
        fail(f"(c): {dropped} assignments dropped, aux {float(aux)}")
    if not err <= tol or any(ep_launches.values()):
        fail(f"(c): error {err} > {tol} or launches {ep_launches}")
    out["c"] = dict(err=err, tol=tol, max_y=scale, dropped=dropped,
                    ep_s=ep_s, ref_s=ref_s, expert_gb=expert_gb,
                    launches=ep_launches)

    # ---- (d) the FL round, one rank --------------------------------------
    lcfg = get_config("qwen3-4b").reduced().replace(dtype="float32",
                                                    remat=False)
    params = R.init_params(4, lcfg, device=dev)
    toks = torch.randint(0, lcfg.vocab_size, (FL_SATS, FL_ITERS, 2, 64),
                         generator=gen, device=dev)
    weights = torch.tensor([0.4, 0.3, 0.2, 0.1], device=dev)

    def loss(params, batch):
        return R.train_loss(params, lcfg, {"tokens": batch},
                            impl="plain")[0]

    fl_round = make_fl_round(loss, make_data_mesh(device=dev),
                             local_iters=FL_ITERS, lr=FL_LR)
    for w in wrappers:
        w.launches = 0
    fl_s = []
    for _ in range(2):              # cold, then warm
        t0 = time.perf_counter()
        new, mean_loss = fl_round(params, toks, weights)
        torch.cuda.synchronize()
        fl_s.append(time.perf_counter() - t0)
    fl_launches = {w.__name__: w.launches for w in wrappers}
    # the same J steps a satellite and eq. 14 written out
    total = tree_map(torch.zeros_like, params)
    losses = []
    for s in range(FL_SATS):
        q = params
        for j in range(FL_ITERS):
            l_, _m, g = loss_and_grads(q, lcfg, {"tokens": toks[s, j]})
            q = tree_map(lambda a, b: a - FL_LR * b, q, g)
            losses.append(float(l_))
        total = tree_map(lambda t, a: t + weights[s] * a, total, q)
    gamma = float(weights.sum())
    want = tree_map(lambda g, t: (1.0 - gamma) * g + t, params, total)
    fl_err = max(float((a - b).abs().max())
                 for a, b in zip(tree_leaves(new), tree_leaves(want)))
    loss_err = abs(float(mean_loss) - sum(losses) / len(losses))
    print(f"(d) make_fl_round, qwen3-4b reduced in f32 ({lcfg.num_layers} "
          f"layers, d_model {lcfg.d_model}), {FL_SATS} satellites, J = "
          f"{FL_ITERS}, one NCCL rank: max |round - plain| {fl_err:.3e} "
          f"(tolerance {FL_TOL}), mean loss {float(mean_loss):.6f} "
          f"(|diff| {loss_err:.3e}); {fl_s[0]:.3f} s cold, {fl_s[1]:.3f} s "
          f"warm; launches {fl_launches}")
    if not fl_err <= FL_TOL or not loss_err <= FL_TOL * 10:
        fail(f"(d): round error {fl_err}, loss error {loss_err}")
    if any(fl_launches.values()):
        fail(f"(d): launches {fl_launches}")
    out["d"] = dict(err=fl_err, loss_err=loss_err, wall_s=fl_s,
                    launches=fl_launches)
    dist.destroy_process_group()

    # ---- (b) two processes on the one card -------------------------------
    ranks = []
    for rank, proc in enumerate(procs):
        try:
            _o, err_text = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            fail(f"(b): rank {rank} did not end in time")
        if proc.returncode != 0:
            fail(f"(b): rank {rank} failed:\n{err_text[-3000:]}")
        ranks.append(torch.load(tmp / f"rank{rank}.pt"))
    for rank, r in enumerate(ranks):
        steps_b = sum(r["steps"])
        print(f"(b) rank {rank} of {MESH_WORLD} ({r['mesh']}): "
              f"{len(r['history'])} epochs in {r['wall_s']:.3f} s, steps "
              f"{r['steps']}, launches {r['launches']}")
        if host_rows(r["history"]) != host_rows(main_hist[:MESH_EPOCHS]):
            fail(f"(b): rank {rank}'s host history is not phase 4's")
        if r["launches"]["fed_agg"] != steps_b or r["steps"][1] or any(
                r["launches"][w.__name__] for w in others):
            fail(f"(b): rank {rank} launched {r['launches']} for "
                 f"{r['steps']} steps")
        if not torch.equal(r["w"], ranks[0]["w"]) or \
                r["history"] != ranks[0]["history"]:
            fail(f"(b): rank {rank}'s model or history differs from rank 0's")
    # the first epoch: each rank trains exactly the rows the unsharded
    # step trains in its block, and the aggregate differs by the order of
    # the sums (eq. 14 on identical rows: 1e-5); the final model after
    # J = 30 SGD steps an epoch, which amplify any reordering, against the
    # unsharded run at the training tolerance (1e-4)
    m = halves["rows"][0].shape[0] // MESH_WORLD
    rows_equal = all(torch.equal(r["rows0"],
                                 halves["rows"][0][k * m:(k + 1) * m])
                     for k, r in enumerate(ranks))
    first = float((ranks[0]["w_by_epoch"][0] - halves["w"][0]).abs().max())
    final = float((ranks[0]["w"].to(dev) - plain_w).abs().max())
    final_halves = float((ranks[0]["w"] - halves["w"][-1]).abs().max())
    halves_plain = float((halves["w"][-1].to(dev) - plain_w).abs().max())
    acc = [(a["accuracy"], b.accuracy) for a, b in
           zip(ranks[0]["history"], main_hist)]
    print(f"(b) host history equals phase 4's; ranks bit-equal; epoch 0: "
          f"the ranks' trained rows bit-equal to the unsharded step's in the "
          f"same row blocks: {rows_equal}, the aggregate "
          f"{first:.3e} from it (tolerance {FED_AGG_TOL}); after "
          f"{MESH_EPOCHS} epochs: {final:.3e} from the unsharded run "
          f"(tolerance 1e-4), {final_halves:.3e} from the row-block run, "
          f"which is {halves_plain:.3e} from the unsharded run (30 SGD "
          f"steps an epoch amplify the order of sums); accuracy (two ranks, "
          f"phase 4) {acc}")
    if not rows_equal or not first <= FED_AGG_TOL:
        fail(f"(b): the first epoch's rows equal: {rows_equal}, aggregate "
             f"{first} from the unsharded step's")
    if not final <= 1e-4:
        fail(f"(b): the two-rank model is {final} from the unsharded run")
    out["b"] = dict(rows_equal=rows_equal, first_epoch=first, final=final,
                    final_vs_row_blocks=final_halves,
                    row_blocks_vs_unsharded=halves_plain, accuracy=acc,
                    ranks=[dict(wall_s=r["wall_s"], steps=r["steps"],
                                launches=r["launches"]) for r in ranks])
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 30: {out['wall_s']:.1f} s ({card})")


# ---- SSM and hybrid training: phase 33 --------------------------------------

# launch.train at published width cut in depth, f32, 3 AdamW steps of B 4 x
# 2048 with remat off and on: zamba2-2.7b cut to one group (6 Mamba2 layers
# and the shared attention block), rwkv6-7b cut to 2 layers
SSM_TRAIN = (("zamba2-2.7b", 6), ("rwkv6-7b", 2))
SSM_STEPS = dict(B=4, S=2048, steps=3, lr=1e-3)
# one step's gradients at B 2 x 256, two chunks of 128, so that the control
# (the state handed between chunks detached in the scan's backward) has a
# state to lose; per leaf within phase 27's GRAD64_LIMIT of its max: the
# chunked scan's float64 gradient against the sequential recurrence's, and
# zamba2's f32 gradient against float64.  rwkv6-7b's f32 gradient is
# printed, not gated: at this width the per-head group norm over a
# near-zero WKV state at the first positions turns f32 rounding into
# gradient differences of ~2e-3 of a leaf's max whichever form of the scan
# computes it (phase 12; tests/test_torch_train.py holds it in float64)
SSM_GRAD64 = dict(B=2, S=256)
SSM_F32_GATED = ("zamba2-2.7b",)
# one chunked_scan call's saved bytes under autograd, at zamba2's Mamba2
# layer (B, T, H, K, V; chunk 128) and rwkv6-7b's layer, in f32: at most
# its operands' storages, T / chunk + 1 states and SCAN_SAVED_SLACK
SCAN_SAVED_SHAPES = (("zamba2-2.7b", "mamba", (4, 2048, 40, 64, 128)),
                     ("rwkv6-7b", "rwkv", (4, 2048, 64, 64, 64)))
SCAN_SAVED_SLACK = 1 << 20


def scan_saved_bytes(torch, dev, report) -> dict:
    """Phase 33 (b): the bytes one ``scan_ops.chunked_scan`` call saves for
    its backward (``launch.collectives.saved_bytes``) at each of
    ``SCAN_SAVED_SHAPES``, against its bound; autograd's own graph of the
    same sub-block form (``scan_ops._scan`` without the Function, the form
    before it) printed beside it."""
    from repro_torch.launch.collectives import saved_bytes
    from repro_torch.models import scan_ops
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for arch, mode, (B, T, H, K, V) in SCAN_SAVED_SHAPES:
        chunk = 128
        rwkv = mode == "rwkv"

        def leaf(*shape, scale=0.3):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).requires_grad_(True)
        ops = [leaf(B, T, H, K), leaf(B, T, H, K), leaf(B, T, H, V),
               (-torch.rand(*((B, T, H, K) if rwkv else (B, T, H)),
                            generator=gen, device=dev)).requires_grad_(True),
               leaf(B, H, K, V, scale=0.1),
               leaf(H, K, scale=0.2) if rwkv else None]
        kw = dict(include_current=not rwkv, chunk=chunk)
        inputs = sum(t.untyped_storage().nbytes() for t in ops
                     if t is not None)
        state = B * H * K * V * 4
        bound = inputs + (T // chunk + 1) * state + SCAN_SAVED_SLACK
        new, res = saved_bytes(scan_ops.chunked_scan, *ops[:5],
                               bonus=ops[5], **kw)
        del res
        old, res = saved_bytes(scan_ops._scan, *ops, **kw)
        del res
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        print(f"  {arch} [{B}, {T}, {H}, {K}, {V}] chunk {chunk}: saved "
              f"{new / 1e6:.1f} MB = operands {inputs / 1e6:.1f} MB + "
              f"{(new - inputs) / 1e6:.1f} MB (bound {bound / 1e6:.1f} MB: "
              f"{T // chunk + 1} states of {state / 1e6:.2f} MB and 1 MB); "
              f"autograd's own graph of the same form {old / 1e6:.1f} MB")
        if not new <= bound:
            fail(f"phase 33 (b): one {arch} scan saves {new} B, above its "
                 f"bound {bound}")
        out[arch] = dict(shape=[B, T, H, K, V], chunk=chunk, saved=new,
                         operands=inputs, bound=bound, graph_saved=old)
        del ops
    return out


def ssm_train_path(torch, dev, report, wrappers) -> None:
    """Phase 33: SSM and hybrid training on the card through the plain
    chunked scan (``scan_ops._ChunkedScan``): (a) ``launch.train.train``
    on each of ``SSM_TRAIN`` at published width cut in depth, f32, remat
    off and on: finite losses, no kernel launched, the two runs equal (bit
    for bit, or within phase 27's bound), and remat off through the form
    before (autograd's own graph of ``scan_ops._scan``) for its step wall
    and peak; (b) one scan call's saved bytes
    at the layers' shapes within their bound; (c) one step's float64
    gradient through the chunked scan against through the sequential
    recurrence per leaf within ``GRAD64_LIMIT``, which the known-bad
    control (the state between chunks detached in the scan's backward)
    must fail, and the f32 gradient against float64 (gated for
    ``SSM_F32_GATED``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.modelbank import flatten_tree
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.launch.train import make_batch, train
    from repro_torch.models import registry as R
    from repro_torch.models import scan_ops
    T = SSM_STEPS
    t_phase = time.perf_counter()
    phase(f"phase 33: SSM and hybrid training — launch.train.train on "
          f"{', '.join(f'{a} cut to {n} layers' for a, n in SSM_TRAIN)} at "
          f"full width, f32, {T['steps']} AdamW steps of B {T['B']} x "
          f"{T['S']}, remat off and on; a scan's saved bytes; f32 "
          f"gradients against float64")
    for w in wrappers:
        w.launches = 0
    out = {"train": {}, "grad64": {}}
    for arch, layers in SSM_TRAIN:
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
        n = R.analytic_param_count(cfg)
        runs = {}
        for remat in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            res = train(cfg.replace(remat=remat), steps=T["steps"],
                        batch=T["B"], seq=T["S"], lr=T["lr"], device=dev,
                        log=None)
            wall = time.perf_counter() - t0
            runs[remat] = dict(
                losses=res["losses"], step_s=res["step_s"], wall_s=wall,
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                flat=flatten_tree(res["params"]))
            del res
            r = runs[remat]
            print(f"  {arch} ({n:,} parameters) remat={remat}: losses "
                  f"{[round(x, 5) for x in r['losses']]}; step wall (s) "
                  f"{[round(x, 3) for x in r['step_s']]} (the first with "
                  f"the allocator's warm-up); peak memory "
                  f"{r['peak_gb']:.1f} GB; {wall:.1f} s with init")
        # what the recompute costs: the same run (remat off) through
        # autograd's own graph of the sub-block form, the form before
        real = scan_ops._ChunkedScan.apply
        scan_ops._ChunkedScan.apply = staticmethod(scan_ops._scan)
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            res = train(cfg, steps=T["steps"], batch=T["B"], seq=T["S"],
                        lr=T["lr"], device=dev, log=None)
        finally:
            scan_ops._ChunkedScan.apply = real
        before = dict(losses=res["losses"], step_s=res["step_s"],
                      peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del res
        print(f"  {arch} through the form before (remat off): losses "
              f"{[round(x, 5) for x in before['losses']]}; step wall (s) "
              f"{[round(x, 3) for x in before['step_s']]}; peak memory "
              f"{before['peak_gb']:.1f} GB")
        if not all(math.isfinite(x) for r in runs.values()
                   for x in r["losses"]):
            fail(f"phase 33: a non-finite {arch} training loss")
        a, b = runs[False], runs[True]
        loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                            b["losses"]))
        w_max, w_beyond, _ = flips(torch, a["flat"], b["flat"], REMAT_W_TOL)
        bit_equal = a["losses"] == b["losses"] and torch.equal(a["flat"],
                                                               b["flat"])
        print(f"  {arch} remat against no remat: "
              f"{'bit-equal' if bit_equal else 'not bit-equal'}; losses "
              f"{loss_rel:.3e} apart, weights max {w_max:.3e}, {w_beyond} "
              f"beyond {REMAT_W_TOL}")
        if not bit_equal and not (loss_rel <= REMAT_LOSS_REL
                                  and w_beyond <= FLIP_SHARE * n):
            fail(f"phase 33: remat changed {arch}'s training beyond its "
                 f"bound")
        for r in runs.values():
            del r["flat"]
        out["train"][arch] = dict(
            layers=layers, params=n, runs={str(k): v for k, v in runs.items()},
            remat_bit_equal=bit_equal, remat_loss_rel=loss_rel,
            remat_w_max=w_max, remat_w_beyond=w_beyond, form_before=before)
        torch.cuda.empty_cache()
    launches = {w.__name__: w.launches for w in wrappers}
    if any(launches.values()):
        fail(f"phase 33's training launched kernels: {launches}")
    out["launches"] = launches

    out["saved"] = scan_saved_bytes(torch, dev, report)

    B2, S2 = SSM_GRAD64["B"], SSM_GRAD64["S"]
    real_chunk, real_scan = scan_ops._chunk, scan_ops.chunked_scan

    def grads(params, cfg, dtype, scan=None, chunk=None):
        """One step's gradients, in ``dtype``, with ``chunked_scan`` or
        ``_chunk`` replaced while it runs."""
        cfg = cfg.replace(dtype=dtype)
        scan_ops.chunked_scan = scan or real_scan
        scan_ops._chunk = chunk or real_chunk
        try:
            return loss_and_grads(
                to_double(params) if dtype == "float64" else params, cfg,
                make_batch(cfg, B2, S2, seed=0, device=dev))[2]
        finally:
            scan_ops.chunked_scan, scan_ops._chunk = real_scan, real_chunk

    def recurrence(r, k, v, ld, state0=None, *, include_current=True,
                   bonus=None, **_):
        return scan_ops.recurrent_scan(r, k, v, ld, state0, bonus=bonus,
                                       include_current=include_current)

    def detached(rq, kq, vq, ldq, S, *a):
        return real_chunk(rq, kq, vq, ldq, S.detach(), *a)

    def form_before(*a, impl="plain", **kw):
        return scan_ops._scan(*a[:4], a[4] if len(a) > 4 else None,
                              kw.get("bonus"), kw["include_current"],
                              kw["chunk"])
    for arch, layers in SSM_TRAIN:
        cfg = get_config(arch).replace(num_layers=layers)
        params = R.init_params(0, cfg, device=dev)
        g64 = grads(params, cfg, "float64")
        want = grads(params, cfg, "float64", scan=recurrence)
        errs = {
            # the gate: the chunked scan's backward against autograd
            # through the sequential recurrence, both in float64
            "float64": leaf_errors(torch, g64, want),
            "control": leaf_errors(torch, grads(
                params, cfg, "float64", chunk=detached), want),
            # phase 27's rule: the f32 gradient against float64
            "f32": leaf_errors(torch, grads(params, cfg, "float32"), g64),
            "f32_before": leaf_errors(torch, grads(
                params, cfg, "float32", scan=form_before), g64)}
        del params, g64, want
        torch.cuda.empty_cache()
        worst = {k: max(e, key=e.get) for k, e in errs.items()}
        line = "; ".join(f"{k} {errs[k][w]:.3e} ({w})"
                         for k, w in worst.items())
        print(f"  {arch} gradients at B {B2} x {S2}, per leaf max|g - "
              f"want| / max|want| (limit {GRAD64_LIMIT}), worst: {line}; "
              f"{sum(v > GRAD64_LIMIT for v in errs['control'].values())} "
              f"of {len(errs['control'])} control leaves beyond the limit")
        if not errs["float64"][worst["float64"]] <= GRAD64_LIMIT:
            fail(f"phase 33: {arch}'s float64 gradient through the chunked "
                 f"scan is {errs['float64'][worst['float64']]} from the "
                 f"recurrence's")
        if not errs["control"][worst["control"]] > GRAD64_LIMIT:
            fail(f"phase 33: the limit does not reject {arch}'s detached "
                 f"state")
        if arch in SSM_F32_GATED and not (
                errs["f32"][worst["f32"]] <= GRAD64_LIMIT):
            fail(f"phase 33: {arch}'s f32 gradient of {worst['f32']} is "
                 f"{errs['f32'][worst['f32']]} from float64")
        out["grad64"][arch] = {k: dict(worst=worst[k], errors=e)
                               for k, e in errs.items()}
    if launches != {w.__name__: w.launches for w in wrappers}:
        fail("phase 33 launched a kernel after its training runs")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 33: {out['wall_s']:.1f} s ({report.get('card', '')})")
    report["ssm_train"] = out


# ---- the dry-run tools: phase 31 --------------------------------------------

# phase 31 (a): launch.dryrun's trace of launch.train's step at one rank,
# in phase 27's configuration, against the card.  Set before the first
# run: the predicted peak (arguments + traced temp) within 5 % of phase
# 27's measured max_memory_allocated above what its process held before
# the run, remat off and on; the arguments alone, the known-bad control,
# outside it
DRYRUN_PEAK_REL = 0.05
DRYRUN_ONE_RANK = """
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import dryrun_one
arch, layers, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    int(sys.argv[4])
cfg = get_config(arch).replace(num_layers=layers, dtype="float32")
shape = ShapeConfig(f"train_b{B}_s{S}", S, B, "train")
rows = {str(r): dryrun_one(arch, shape.name, cfg=cfg, shape=shape,
                           mesh_shape=(1, 1), remat=r, verbose=False)
        for r in (False, True)}
print(json.dumps({"rows": rows, "cuda_initialized":
                  torch.cuda.is_initialized()}))
"""
# phase 31 (b): the production-mesh CLIs, each a process of its own, with
# what torch.cuda.is_initialized() says at its end
DRYRUN_CLIS = (
    ("dryrun", ["--arch", "qwen3-4b", "--shape", "train_4k"]),
    ("dryrun", ["--arch", "qwen3-4b", "--shape", "train_4k", "--multi-pod"]),
    ("dryrun", ["--arch", "qwen3-4b", "--shape", "prefill_32k"]),
    ("dryrun", ["--arch", "llama3-8b", "--shape", "train_4k"]),
    ("dryrun", ["--arch", "internvl2-1b", "--shape", "train_4k"]),
    ("dryrun", ["--arch", "deepseek-v2-236b", "--shape", "prefill_32k"]),
    ("dryrun", ["--arch", "deepseek-v2-236b", "--shape", "prefill_32k",
                "--multi-pod"]),
    ("dryrun", ["--arch", "kimi-k2-1t-a32b", "--shape", "prefill_32k"]),
    ("ep_dryrun", ["--arch", "kimi-k2-1t-a32b"]),
    ("fl_dryrun", []),
)
# the reference's per-device temp bytes (``memory.temp_size_bytes``) of
# the same rows, (arch, shape, multi-pod): ``PYTHONPATH=src
# JAX_PLATFORMS=cpu python -m repro.launch.dryrun --arch A --shape S
# [--multi-pod]`` on a CPU (jax 0.9.0), the JAX package as of commit
# 2caf50e.  This host has no JAX.  Each dry-run row's temp is held within
# DRYRUN_TEMP_RATIO of its reference, and its ``replicated`` names none of
# the ops that once replicated the step's activations
DRYRUN_REF_TEMP = {
    ("qwen3-4b", "train_4k", False): 38000395600,
    ("qwen3-4b", "train_4k", True): 18673173776,
    ("qwen3-4b", "prefill_32k", False): 43565236528,
    ("llama3-8b", "train_4k", False): 53687354608,
    ("internvl2-1b", "train_4k", False): 125977478064,
    # scripts/dryrun_reference.json's rows (its memory keys are the JAX
    # package's dry-run's, bit for bit)
    ("deepseek-v2-236b", "prefill_32k", False): 281564699824,
    ("deepseek-v2-236b", "prefill_32k", True): 275239689392,
    ("kimi-k2-1t-a32b", "prefill_32k", False): 519153682184,
}
DRYRUN_TEMP_RATIO = 2.0
# and at least this share of it: every row here is a train or prefill
# step, where the port's temp reads 0.58-1.51x the reference's
# (``scripts/dryrun_parity.py``, torch 2.11 and 2.13; the MoE prefills
# 0.70-0.71x on torch 2.13); a trace that lost storages would size a run
# too small
DRYRUN_TEMP_FLOOR = 0.5
DRYRUN_REPLICATED_OPS = ("aten.view.", "aten._unsafe_view.", "aten.flip.",
                         "aten.index_put", "aten.index_add",
                         "aten.searchsorted")
DRYRUN_CLI = """
import importlib, sys, torch
mod = importlib.import_module("repro_torch.launch." + sys.argv[1])
rc = mod.main(sys.argv[2:])
print("cuda_initialized", torch.cuda.is_initialized())
sys.exit(rc)
"""


# phase 31 (c): qwen3-4b's step cut to one layer, and deepseek-v2-236b's
# to one lead and one MoE layer (what the reference's counts hold: XLA
# counts each scanned layer loop's body once) over the fake 256-rank
# world, each arch in a process of its own; each of its collectives
# paired with the reference program's (``scripts/dryrun_reference.json``,
# its rows' ``collectives`` at the program's dtypes, written on a CPU by
# ``scripts/dryrun_reference_row.py``: the card's host has no JAX) of
# the same kind and type.  The run fails if a collective of at least the
# residual stream's bytes a rank (B/16 x S x d in bf16) is left unpaired
DRYRUN_PAIR_ARCHS = {"qwen3-4b": (1, ("train_4k", "prefill_32k")),
                     "deepseek-v2-236b": (2, ("prefill_32k",))}
DRYRUN_PAIRS = """
import json, sys, torch
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import dryrun_one, quiet_dtensor
quiet_dtensor()
arch, layers, shapes = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
cfg = get_config(arch).replace(num_layers=layers)
rows = {}
for shape in shapes:
    row = dryrun_one(arch, shape, cfg=cfg, verbose=False)
    rows[shape] = {k: row[k] for k in ("collectives", "collective_bytes",
                                       "lower_s", "replicated")}
print(json.dumps({"rows": rows, "cuda_initialized":
                  torch.cuda.is_initialized()}))
"""


def dryrun_pairs(arch, proc, wall) -> dict:
    """Phase 31 (c): the paired table of ``DRYRUN_PAIRS``'s rows of
    ``arch`` (its finished process ``proc``) against the reference
    program's."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.collectives import (pair_with_reference,
                                                residual_bytes)
    stdout, stderr = proc
    lines = stdout.strip().splitlines()
    layers = DRYRUN_PAIR_ARCHS[arch][0]
    if not lines or not lines[-1].startswith("{"):
        fail(f"phase 31 (c): the {arch} dry-runs at {layers} layers "
             f"printed no rows:\n{stderr[-3000:]}")
    got = json.loads(lines[-1])
    if got["cuda_initialized"]:
        fail("phase 31 (c): the dry-run initialised CUDA")
    ref = {(r["arch"], r["shape"], r["multi_pod"]): r for r in json.loads(
        (ROOT / "scripts" / "dryrun_reference.json").read_text())}
    out = {"wall_s": wall}
    cfg = get_config(arch)
    for shape, row in got["rows"].items():
        theirs = ref[(arch, shape, False)]
        least = residual_bytes(cfg, get_shape(shape))
        pairs = pair_with_reference(row["collectives"],
                                    theirs["collectives"], least)
        mine = row["collective_bytes"].get("all-reduce", 0)
        want = theirs["collective_bytes_program"].get("all-reduce", 0)
        gathered = row["collective_bytes"].get("all-gather", 0)
        print(f"  {arch} {shape}, {layers} layer(s) on 16 x 16 (traced "
              f"in {row['lower_s']} s): all-reduce {mine:,} B a device, "
              f"the reference program's {want:,} B ({mine / want:.4f}x; "
              f"XLA's CPU bytes "
              f"{theirs['collective_bytes'].get('all-reduce', 0):,}); "
              f"all-gather {gathered:,} B, the program's "
              f"{theirs['collective_bytes_program'].get('all-gather', 0):,}"
              f" B; each collective, the residual stream's {least:,} B or "
              f"more gated:")
        for p in pairs:
            if p["ref"] is None:
                pair = "UNPAIRED" if p["gated"] else "no pair"
            else:
                pair = (f"{p['ref']['op_name'].rsplit('/', 2)[-2:]} over "
                        f"{p['ref']['ranks']}")
            print(f"    {'*' if p['gated'] else ' '} {p['kind']} "
                  f"{p['shape']} {p['bytes']:,} B over {p['ranks']} at "
                  f"{p['site']} <-> {pair}")
        unpaired = [p for p in pairs if p["gated"] and p["ref"] is None]
        if unpaired:
            fail(f"phase 31 (c): {arch} {shape}: collectives the "
                 f"reference's program does not make: {unpaired}")
        if row["replicated"]:
            fail(f"phase 31 (c): {arch} {shape} replicated "
                 f"{row['replicated']}")
        out[shape] = dict(all_reduce=mine, ref_all_reduce_program=want,
                          all_gather=gathered,
                          gated=sum(p["gated"] for p in pairs),
                          pairs=pairs, lower_s=row["lower_s"])
    return out


def storage_bytes(trees) -> int:
    """The bytes of the distinct storages of the tensors in ``trees``, each
    in the caching allocator's 512-byte units: what the card holds for
    them (the allocator's blocks can be larger: a block it does not split
    keeps up to 1 MB of a segment's rounding)."""
    from repro_torch.launch.collectives import alloc_bytes
    from repro_torch.tree import tree_leaves
    seen = {}
    for tree in trees:
        for t in tree_leaves(tree):
            st = t.untyped_storage()
            seen[st.data_ptr()] = alloc_bytes(st.nbytes())
    return sum(seen.values())


def dryrun_parity(name, lines) -> dict:
    """Phase 31 (b)'s gate on a ``launch.dryrun`` CLI's row (its JSON
    line and its ``memory_analysis:`` line): temp between
    ``DRYRUN_TEMP_FLOOR`` and ``DRYRUN_TEMP_RATIO`` times the
    reference's, no op of
    ``DRYRUN_REPLICATED_OPS`` replicated."""
    import ast
    [row] = [json.loads(line) for line in lines if line.startswith("{")]
    [mem] = [ast.literal_eval(line.split(":", 1)[1].strip())
             for line in lines if line.startswith("memory_analysis:")]
    ref = DRYRUN_REF_TEMP[(row["arch"], row["shape"], row["multi_pod"])]
    ratio = mem["temp_size_bytes"] / ref
    bad = [r for r in row["replicated"]
           if any(op in r for op in DRYRUN_REPLICATED_OPS)]
    print(f"  {row['arch']} {row['shape']}{' multi-pod' * row['multi_pod']}: "
          f"temp {mem['temp_size_bytes'] / 1e9:.2f} GB a device, the "
          f"reference's {ref / 1e9:.2f} GB: {ratio:.3f}x (limits "
          f"{DRYRUN_TEMP_FLOOR}, {DRYRUN_TEMP_RATIO}); replicated "
          f"{row['replicated']}; largest live at the peak "
          f"{row['peak_holders'][:4]}")
    if not DRYRUN_TEMP_FLOOR <= ratio <= DRYRUN_TEMP_RATIO:
        fail(f"phase 31 (b): {name}: temp {ratio:.3f}x the reference's, "
             f"outside [{DRYRUN_TEMP_FLOOR}, {DRYRUN_TEMP_RATIO}]")
    if bad:
        fail(f"phase 31 (b): {name} replicated {bad}")
    return dict(temp_bytes=mem["temp_size_bytes"], ref_temp_bytes=ref,
                ratio=ratio, replicated=row["replicated"],
                argument_bytes=mem["argument_size_bytes"],
                lower_s=row["lower_s"])


def dryrun_path(torch, dev, report) -> None:
    """Phase 31: the dry-run tools (``launch.dryrun``, ``ep_dryrun``,
    ``fl_dryrun``; no kernel on their path).  (a) the dry-run of
    ``launch.train``'s step at one rank in phase 27's configuration: its
    argument bytes and FLOPs exactly the card's for one real step, its
    predicted peak within ``DRYRUN_PEAK_REL`` of phase 27's measured peak
    for remat off and on, the arguments alone outside it; (b) the
    production-mesh CLIs over fake worlds of 256 and 512 ranks, each its
    own process: exit 0, a row, CUDA never initialised; each
    ``launch.dryrun`` row's temp within ``DRYRUN_TEMP_FLOOR`` and
    ``DRYRUN_TEMP_RATIO`` of the reference's (``dryrun_parity``), the
    MoE family's prefills among them; (c) qwen3-4b's step cut to one
    layer and deepseek-v2-236b's to one lead and one MoE layer, their
    collectives paired with the reference program's (``dryrun_pairs``),
    started beside (b)."""
    import os
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.launch.train import make_batch
    from repro_torch.models import registry as R
    T = TRAIN
    t_phase = time.perf_counter()
    phase(f"phase 31: the dry-run tools — (a) launch.dryrun of "
          f"launch.train's step at one rank ({TRAIN_ARCH}, {T['layers']} "
          f"layers, f32, B {T['B']} x {T['S']}) against the card; (b) the "
          f"production-mesh dry-runs, each its own process; (c) the "
          f"collectives of {', '.join(DRYRUN_PAIR_ARCHS)} cut to their "
          f"first layers against the reference program's")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", DRYRUN_ONE_RANK, TRAIN_ARCH,
         str(T["layers"]), str(T["B"]), str(T["S"])],
        capture_output=True, text=True, env=env, timeout=600)
    if proc.returncode != 0:
        fail(f"phase 31 (a)'s dry-run failed:\n{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    if got["cuda_initialized"]:
        fail("phase 31 (a): the dry-run initialised CUDA")
    cfg = get_config(TRAIN_ARCH).replace(num_layers=T["layers"],
                                         dtype="float32")
    out = {"a": {}, "b": {}}
    for remat in (False, True):
        row = got["rows"][str(remat)]
        mem = row["memory"]
        c = cfg.replace(remat=remat)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        opt = make_optimizer(T["lr"])
        params = R.init_params(0, c, device=dev)
        state = opt.init(params)
        batch = make_batch(c, T["B"], T["S"], seed=0, device=dev)
        # the dry-run's batch spec holds int32 tokens, as the reference's
        batch["tokens"] = batch["tokens"].to(torch.int32)
        torch.cuda.synchronize(dev)
        allocated = torch.cuda.memory_allocated(dev) - base
        held = storage_bytes([params, state, batch])
        torch.cuda.reset_peak_memory_stats(dev)
        with FlopCounterMode(display=False) as fc:
            new = make_train_step(c, opt)(params, state, batch)
        torch.cuda.synchronize(dev)
        step_peak = torch.cuda.max_memory_allocated(dev) - base
        flops = fc.get_total_flops()
        del new, params, state, batch
        run27 = report["lm_train"]["runs"][str(remat)]
        measured = (run27["peak_gb"] - run27["base_gb"]) * 1e9
        predicted = mem["peak_size_bytes"]
        rel = abs(predicted - measured) / measured
        control = abs(mem["argument_size_bytes"] - measured) / measured
        print(f"remat={remat}: arguments {mem['argument_size_bytes']:,} B "
              f"predicted, {held:,} B held on the card (their storages in "
              f"512-byte units; the allocator's blocks {allocated:,} B, "
              f"{allocated - held:,} B of segment rounding); FLOPs "
              f"{row['flops']:.6e} predicted ({row['flops_per_device']:.6e} "
              f"on rank 0), {flops:.6e} counted on the card's step "
              f"(PERF.md: ~3.1e13 a step); peak {predicted / 1e9:.3f} GB "
              f"predicted (temp {mem['temp_size_bytes'] / 1e9:.3f} GB) "
              f"against phase 27's {measured / 1e9:.3f} GB (its peak "
              f"{run27['peak_gb']:.3f} GB less the {run27['base_gb']:.3f} "
              f"GB held before its run): {rel:.2%} "
              f"apart (limit {DRYRUN_PEAK_REL:.0%}), this step's own "
              f"{step_peak / 1e9:.3f} GB; the arguments alone "
              f"{control:.2%} apart; traced in {row['lower_s']} s")
        if mem["argument_size_bytes"] != held:
            fail(f"phase 31 (a): the dry-run's argument bytes "
                 f"{mem['argument_size_bytes']} are not the card's {held}")
        if not row["flops"] == row["flops_per_device"] == flops:
            fail(f"phase 31 (a): FLOPs {row['flops']} (rank 0 "
                 f"{row['flops_per_device']}) predicted, {flops} counted")
        if not rel <= DRYRUN_PEAK_REL:
            fail(f"phase 31 (a): the predicted peak is {rel:.2%} from the "
                 f"measured one (remat={remat})")
        if not control > DRYRUN_PEAK_REL:
            fail("phase 31 (a): the limit does not reject the arguments "
                 "alone")
        out["a"][str(remat)] = dict(
            argument_bytes=mem["argument_size_bytes"], held_bytes=held,
            allocated_bytes=allocated,
            flops=row["flops"], card_flops=flops,
            predicted_peak=predicted, measured_peak=measured,
            step_peak=step_peak, rel=rel, control_rel=control,
            lower_s=row["lower_s"], replicated=row["replicated"])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    pairs_procs = {arch: subprocess.Popen(
        [sys.executable, "-c", DRYRUN_PAIRS, arch, str(layers), *shapes],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, (layers, shapes) in DRYRUN_PAIR_ARCHS.items()}
    procs = [(mod, argv, time.perf_counter(), subprocess.Popen(
        [sys.executable, "-c", DRYRUN_CLI, mod] + argv, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for mod, argv in DRYRUN_CLIS]
    for mod, argv, start, p in procs:
        stdout, stderr = p.communicate(timeout=900)
        wall = time.perf_counter() - start
        name = " ".join([mod] + argv)
        lines = stdout.strip().splitlines()
        if p.returncode != 0:
            fail(f"phase 31 (b): {name} exited {p.returncode}:\n"
                 f"{stderr[-3000:]}")
        if not lines or lines[-1] != "cuda_initialized False":
            fail(f"phase 31 (b): {name} ended with "
                 f"{lines[-1:] or 'no output'}")
        if len(lines) < 2:
            fail(f"phase 31 (b): {name} printed no row")
        print(f"{name}: {wall:.1f} s; " + " | ".join(
            line[:600] for line in lines[:-1]))
        out["b"][name] = dict(wall_s=wall, rows=lines[:-1])
        if mod == "dryrun":
            out["b"][name]["parity"] = dryrun_parity(name, lines[:-1])
    out["b_wall_s"] = time.perf_counter() - t0
    print("phase 31 (c): qwen3-4b's step cut to one layer and "
          "deepseek-v2-236b's to one lead and one MoE layer, their "
          "collectives paired with the reference program's")
    out["c"] = {}
    for arch, p in pairs_procs.items():
        out["c"][arch] = dryrun_pairs(arch, p.communicate(timeout=600),
                                      time.perf_counter() - t0)
        if p.returncode != 0:
            fail(f"phase 31 (c): {arch} exited {p.returncode}")
    out["wall_s"] = time.perf_counter() - t_phase
    card = report.get("card", "")
    print(f"phase 31: {out['wall_s']:.1f} s, (b) {out['b_wall_s']:.1f} s "
          f"({card})")
    report["dryrun"] = out


if __name__ == "__main__":
    main()
