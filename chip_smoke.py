#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. environment: the card's name and power limit, torch/CUDA/nvcc/triton versions;
2. build every CUDA source of csrc/ (one nvcc each, started together, the
   stream's native batcher by g++ beside them) and time each build; the
   head kernels' build is waited for here, the decode kernel's at the start
   of phase 8 and the flash kernels' at the start of phase 12 (the first
   phases that launch them), so the CNN phases run while nvcc compiles the
   rest; print each tensor-core flash instance's (forward, dq,
   dkv, and the quantized forward's 8-bit ones) registers, spills, dynamic
   shared memory and blocks per SM, the head forward's and backward's
   cluster instances' registers, shared memory, blocks per SM and clusters
   at once, the backward's group rule (BWD_GROUP_MAX beside the clusters the
   card runs at once; the rule at B 16, 64, 256, 4096, held to the CUDA
   source's), and the same for the decode kernel's split instances (K/V in
   q's dtype and int8);
3. each fused-head kernel against its plain PyTorch version on the card,
   with the replica axis, at (N, B) in {(1, 1), (4, 16), (4, 64), (1, 4096),
   (2, 200)} (atol = rtol = 1e-4, f32 with another summation order): the
   forward, the backward's group sums, the reduce where a replica has more
   than one group (and no reduce launch where it has one), the whole
   backward through autograd; each bitwise under a rerun;
4. the port's CNN Engine on the card (kernels="cuda", data_parallel, 512
   rows, 4 workers stacked, 2 epochs, replayed from its captured CUDA
   graphs) against the float64 numpy oracle in tests/oracle_numpy.py, with
   the engine's own shuffle orders fed to both (train loss within 5e-4,
   params max-rel within 2e-3); the same programs run eagerly on the card
   (the engine's `_capture` hook), a second graphed run and a 2-epoch
   `run_span` must each equal the graphed run bit for bit (params,
   momentum, every metric, eval included);
5. the CNN main path at full width through the user's entry point,
   `train.cli.main`: data_parallel, 4 workers, 50,000 synthetic train rows
   and 10,000 test rows, 2 epochs, batch 16, --kernels cuda and torch, each
   per epoch and with --fused. The kernels' counters, replays included,
   must equal 782 + 157 forward launches, 782 backward launches and no
   reduce launch per epoch (one launch a step for all 4 replicas); the
   train loss must fall and the final validation accuracy reach 50%; a
   --fused run charges its spans to TRAINING. Then one point of
   run_training.sh's sweep (B 64, per epoch), where the reduce runs once a
   step;
6. fused-head kernel times beside their bound, their plain version and a
   PyTorch library call (the torch.baddbmm + relu chain, its autograd
   backward, torch.sum), at (N, B) in {(4, 16), (1, 16), (1, 128), (1,
   4096)}: per call in an eager loop timed with CUDA events, and device time
   from the same calls captured in a CUDA graph; the reduce and the whole
   backward at B 4096 with the bytes of sums written there against one
   row per 16-row tile; the replicas' convolutions grouped against one per
   replica; gates at (4, 16): the forward's device time is at most the
   baddbmm chain's, the backward's at most the autograd backward's;
7. a torch.profiler trace of one graphed epoch of the CNN engine at full
   width (4 workers x 12,500 rows, eval of 10,000): wall time, device busy
   time, idle share and the top kernels;
8. the decode-attention kernels (f32, bf16, int8 K/V with bf16 q) against
   their plain versions on the card: B in {1, 8}, (H, Dh) in {(8, 64),
   (4, 128), (4, 8)}, total in {16, 256, 2048}, pos a scalar and vectors
   holding 0 and total-1, K/V contiguous, as a transposed view and as a
   view 8 bytes off a 16-byte boundary; each case on the route
   `decode_route` gives (aligned: split; misaligned and int8 at Dh 8:
   simt), read from the route counters; f32 atol = rtol = 1e-5, bf16/int8
   1.6e-2 (two bf16 ulps at 1); two calls must give the same bits, and so
   must a shorter cache and, at B = 8, each (b, h) row alone in a batch of
   1, and each int8 split case must equal the bf16 split route on its
   dequantized cache bit for bit; `decode_pieces` against the CUDA
   source's piece rows; the plain
   version's bits for one row padded to 48 and 2048 columns, alone and in
   a batch of 8, contiguous and transposed, bf16 and int8 K/V, all equal
   (`plain_invariance`);
9. the LM serving main path at full width through `serve.http.build_server`,
   the stack `python -m distributed_neural_network_tpu_torch.serve` builds:
   d512/L8/H8/d_ff 2048/vocab 256, bf16, seed 0, max_batch 8, 129 blocks of
   16, max_seq_len 256, prefill_chunk 16, --warmup (every bucket's CUDA
   graph captured; each decode and prefill call a replay), HTTP on
   127.0.0.1:0;
   24 greedy requests over HTTP/SSE (prompts of 16/64/128 tokens, 32 new
   each) sent open loop at 4 req/s, for --precision bf16 and int8-kv, each
   with --decode-impl cuda and torch. Gates: 24/24 complete; the prefill
   calls the prompts' whole chunks (each prompt but its last token in
   chunks of 16 on the chunk grid, whatever the arrivals' overlap); >= 99%
   per-token agreement with the port's offline bf16 generate() (each served
   token against generate's choice after the same served history, where a
   choice that generate's two routes make differently is a tie: see
   Oracle.agreement), and for bf16 with cuda also >= 99% with the streams
   zipped position by position;
   with cuda the decode kernel launches = (the engine's decode calls +
   prefill calls) x 8 layers, all on the split route (bf16 and int8-kv),
   with torch none; the serving ledger conserves. The bf16 torch run is
   also held to generate(decode_impl="torch"), the same route: token-exact,
   per token and zipped (generate() has no int8 K/V). The cuda runs of bf16
   and int8-kv are served again with the engine run eagerly (its `_capture`
   hook), for the graphs' effect on req/s, TTFT, inter-token gaps and ms per
   tick; those runs are gated on completion, the ledger and the launch
   formula;
10. decode-kernel times at B = 8, (H, Dh) in {(8, 64), (4, 128)}, live
   prefix 64 and 256: per call and device time, bound, plain version, the
   simt route on the same values (misaligned views), and
   scaled_dot_product_attention with a boolean mask as the library
   yardstick (int8: dequantize, then SDPA); gates: each split route's
   device time at (8, 8, 64, 256) is at most its library call's;
11. the serving engine driven directly, graphed and eager, bf16 and
   int8-kv: warmup's time over the whole grid and the graph pool's bytes,
   then a torch.profiler trace of 20 steady decode ticks (batch 8): idle
   share (busy = the union of the device intervals), the decode kernel's
   share, host calls per tick (graph launches, kernel launches, copies) and
   top kernels;
12. the flash kernels (forward, dq, dkv) against their plain versions on the
   card: (B, H) in {(1, 1), (2, 8)}, S in {1, 64, 200, 2048}, D in {64, 128,
   16}, causal and not, f32 and bf16, contiguous and a strided (B, S, H, D)
   view; bf16 at D 32 (the mma route) and D 40 (the simt route), and
   misaligned views (simt); and the main path's own shape FLASH_MAIN (16,
   2048, 8, 64) causal bf16, and the mesh's FLASH_MESH ((16, 2048, 4, 64)
   at --tp 2, (16, 2048, 2, 64) at --tp 4, (2, 2048, 4, 64) at --dp 2 --tp
   2 --accum-steps 4, (8, 2048, 8, 64) at --dp 2; inputs from a generator
   of their own), and the remat runs' FLASH_REMAT (32, 2048, 4, 128) (phase
   27; a generator of its own); each case, forward and backward, on the route
   the stated rule gives it (`expected_route`, read from the route
   counters: FLASH_MAIN on mma; the forward's mma route is wgmma at D 48
   and 64, mma.sync at 16, 32 and 128);
   f32 atol = rtol = 1e-4, bf16 1.6e-2, lse 1e-4; and the quantized
   forward (int8, fp8) on codes at the kernel's own k tile, at B 2, at
   FLASH_MAIN and at --tp 2's (16, 2048, 4, 64) (int8 2e-2; fp8 mean error
   1e-4 and max two e4m3 steps, see
   FP8_STEP), each on both of its routes (`quant_route`: the codes as they
   come on mma, the same codes 8 bytes off a 16-byte boundary on simt);
   every kernel gives the same bits on a second call. The kernel line's
   max_abs_err is the one at FLASH_MAIN, max_abs_err_mesh the largest at
   FLASH_MESH (the quantized kernel's on mma, at --tp 2's shape),
   max_abs_err_remat the one at FLASH_REMAT (forward, dq, dkv);
13. the LM training main path at full width through `lm_train.main`, the
   repo's flagship row lm_flash_d512_L8_seq2048_bf16 with nothing cut
   (d512/L8/H8/d_ff 2048/vocab 32768, batch 16, seq 2048, bf16, SGD lr 0.01
   momentum 0.9, 20 steps, a loss read every 10 steps as the JAX row's
   unfenced loop): --attn flash, then --precision int8 and fp8, then the
   plain route (--attn ring; its (B, H, S, S) buffers fit in device memory,
   so without --remat-attn), and the four again in mirrored order, so that
   routes are compared in turns. Gates: each flash counter equals its
   formula (flash_counts) and is 0 on the plain route, every forward, dq,
   dkv and quantized-forward launch of a kernel-route run on the mma route
   (mma_counts); finite losses; each kernel route's (flash, int8, fp8)
   logged losses within LOSS_TOL of the plain route's, and every weight's
   step-0 gradient within GRAD_TOL of the plain route's (route_compare; `python3 chip_smoke.py --route-check` runs this check
   alone). Then FORMULA_STEPS-step runs at full width with --remat,
   --remat-attn, --accum-steps 2, eval batches (--data-path, --eval-every),
   and int8 with --remat-attn and eval, each held to flash_counts. Every
   run replays its step (and eval) from a CUDA graph; the flash run is made
   again with the step run eagerly ("flash eager", in the mirrored order
   too, held to the same formulas). Prints tokens/s, ms per step, the first
   step's time (capture included) and MFU against the bf16 dense peak;
14. learnability: the copy task at d32/L2/H4/d_ff 64/vocab 32/seq 16/batch
   32, lr 0.3, 300 steps, --attn flash --generate 7: final loss < 0.2 and
   the greedy continuation matches the repeat on > 90% of positions; its
   head dim 8 puts every flash launch on the simt route;
15. flash kernel times at (B, S, H, D) = (16, 2048, 8, 64) and (16, 2048, 4,
   128), causal bf16: per call, device time in a CUDA graph, bound, plain
   version, and the dispatch's `lib` route (scaled_dot_product_attention,
   is_causal=True) forward and forward + backward as the library yardstick;
   the forward and the backward pair on the simt route too (the same values
   in misaligned views);
   the forward's device time against SDPA's forward and its bound, and the
   pair's summed device time against SDPA's whole backward; the quantized
   forward (int8 and fp8 on mma, int8 on simt) against its operations
   bound at the int8 peak, beside the bf16 forward and SDPA's forward;
16. a torch.profiler trace of 3 steady full-width training steps, graphed
   and eager: the first step's time (the capture), the graph pool's bytes,
   idle share, the flash kernels' share, host calls per step and the top
   kernels;
17. the CNN trainer across processes: (a) phase 4's run (512 rows, 2
   epochs, --kernels cuda) as 2 ranks x 2 workers under gloo on the one
   card (tests/torch_rank_worker.py): both ranks' histories equal, the
   gathered sync bitwise the in-process one (a (4, 62,007) stack, 5 live
   masks), within phase 4's oracle bounds, and the largest difference from
   phase 4's in-process run printed; (b) one rank over NCCL holding all 4
   workers, the all-reduce captured in the sync and eval graphs: bitwise
   phase 4's graphed run; (c) full width through the user's entry point,
   `python -m torch.distributed.run --standalone --nproc-per-node 2 -m
   distributed_neural_network_tpu_torch.train.cli --regime data_parallel
   --nb-proc 4 --epochs 2 --batch-size 16 --lr 0.01 --data synthetic
   --synthetic-size 50000 --kernels cuda`: both ranks' SUMMARY metrics equal, the gloo line
   printed, each rank's head counters (its SUMMARY) at phase 5's formula,
   the loss falling and validation accuracy >= 50% on each rank; epoch wall
   time and images/s beside phase 5's one-process run; (d) the 2 x 2 run at
   full width with its second epoch under the profiler on each rank: the
   card's idle share over the union of both ranks' device intervals ((a),
   (d) and phase 22's 2 x 2 runs in one launch of the ranks);
18. streaming: the native batcher built (`native.available()`); full width
   with --input-mode stream --kernels cuda per epoch: launches as phase 5,
   the loss falling, accuracy >= 50%; images/s and a profiled stream
   epoch's idle share (its graphs captured by `Engine.compile()` before it)
   beside the hbm run (phases 5, 7); at 512 rows the
   stream engine within the oracle bounds on the stream's own orders, and
   beside the hbm engine fed those orders;
19. bf16: full width with --compute-dtype bfloat16, --kernels cuda (launches
   as phase 5) and torch (none), the loss falling and accuracy >= 50%; at
   512 rows the graphed bf16 run bitwise equal to its eager run; epoch wall
   time, images/s, a profiled bf16 epoch's idle share (as phase 7), and the
   grouped convs' device time a step in bf16 beside f32;
20. graphed against eager: (a) serving, bf16 and int8-kv on both decode
   routes, full width: phase 9's 24 prompts admitted in order as slots and
   blocks allow (request SAMPLED sampled), prefill chunks of 16, through an
   engine run eagerly and a graphed one, each warmed up to WARM_WIDTH
   blocks so that the wider buckets are first met, and captured, mid-run:
   the tokens and the final K/V pools (and scales) bit for bit; (b) the LM
   step and eval (LM_GRAPH_CASES): 3 flash bf16 steps at full width, and
   4 steps each of int8, --accum-steps 2 and adam + cosine + clip at full
   width and 2 layers, eagerly and graphed: the losses, eval losses,
   parameters and optimizer state bit for bit;
21. the LM on the data axis (`port_probes/lm_dp_world.py`): `lm_train.main`
   at LM_ARGS with --attn flash in one process (--dp 1: sgd, adam, 4 steps;
   `port_probes/lm_mesh_world.py`'s flash-sgd and flash-adam, whose updates
   phase 24 reads; and the one-process runs of phases 24-26 and 28(c)), then
   one launch of 2 ranks sharing the card over gloo, each running every
   case of phases 21-23 (and then 29(e)'s, 33's uninterrupted run, 24-26's,
   28(c)'s and 32's) through `lm_train.main`
   (--dp 2; the counters set to 0 before each run): sgd and adam, 4 steps: every step's loss
   within LOSS_TOL relative of --dp 1's, the ranks' SUMMARY lines and
   parameters equal, each rank's flash launches the formula, all on the
   mma route; ms per step, tokens/s, 3 profiled steps' idle share (the
   union of both ranks' device intervals), the collectives' time a step
   (run alone on the step's buffers) and the collective form;
22. --accum-steps 4 with --grad-sync end, overlap --bucket-mb 4 and 16 at
   --dp 2, 3 steps: losses within LOSS_TOL of end, the bucket count
   `plan_buckets`'s, ms per step; the CNN at phase 4's run with --sync-mode
   step --grad-sync overlap (10 KB buckets) bitwise its end run, in one
   process graphed and on 2 ranks x 2 workers over gloo (run in phase 17's
   launch of the ranks);
23. --optimizer zero and zero-adam at --dp 2, 4 steps: the parameters
   bitwise phase 21's sgd / adam run's; each rank's zero-adam state
   (`memory_allocated` around `init_lm_momentum`) within 1% of its shards'
   bytes (half the replicated state plus the padding), beside adam's;
24. the model axis (`port_probes/lm_mesh_world.py`, run by phase 21's
   launch of 2 ranks sharing the card over gloo, the counters set to 0
   before each run): `lm_train.main` at LM_ARGS with --tp 2 --attn flash,
   sgd and adam, 4 steps: every step's loss within LOSS_TOL relative of
   the one-process run on the same route (phase 21's sgd and adam and
   their updates; and --precision int8 against its own one-process run: the
   quantized forward's launches on the tp path), the parameter update
   (gathered parameters minus the initial ones) within the probe's
   UPDATE_TOL of the one-process run's in relative L2, leaf by leaf, the
   ranks' SUMMARY lines, losses and gathered parameters (`gather_params`)
   equal, each rank's flash launches the formula, all on the mma route,
   every call at (16, 2048, 4, 64), a shape of phase 12's FLASH_MESH; ms per
   step, tokens/s, MFU over the one card, the
   collectives' time per step (the model axis's all-reduces each timed
   alone at their shape, times their count) and the step's segments (the
   forward and backward eager between graphs: gloo collectives inside);
25. the sequence axis: --sp 2 with --attn ring, ulysses and zigzag at
   global batch 8 (cut from 16: the one-process reference's plain
   attention holds (B, H, S, S) scores), each within LOSS_TOL of the
   one-process --attn ring run at batch 8 and its update within
   UPDATE_TOL; and --dp 2 (phase 21's sgd run) through the same three-axis
   mesh code, held the same way to the one-process run and compared with
   phase 21's losses.
26. the pipeline axis (`port_probes/pp_world.py`, 2 ranks sharing the
   card over gloo, run by phase 21's launch of the ranks): `lm_train.main` at LM_ARGS with --pp 2
   --microbatches 4, GPipe and --pp-interleave 2, 4 steps (cut from 20),
   each held to the one-process run on the plain attention (the pipeline's
   blocks attend with it, as in JAX): every step's loss within LOSS_TOL,
   the parameter update within UPDATE_TOL leaf by leaf, the ranks' SUMMARY
   lines, losses and gathered parameters equal, the SUMMARY's mesh and
   pp_bubble_frac the JAX CLI's, no flash launch; ms per step, 3 profiled
   steps' idle share, pp_bubble_frac and each rank's peak memory;
27. remat policies on the single-card graphed flash step
   (`port_probes/remat_policies.py`) at batch 32, H 4, D 128 (FLASH_REMAT,
   held in phase 12): --remat with no policy, dots_saveable,
   dots_with_no_batch_dims_saveable, nothing_saveable, and no remat, 4
   steps each: every policy's losses and parameters bitwise the no-policy
   run's, the no-remat run within LOSS_TOL; the flash launches the formula
   (the forward twice a layer under remat) on mma at FLASH_REMAT; each
   run's peak memory, graphed ms per step and launches a step;
28. mixture of experts (`parallel/moe.py`): (a) `lm_train.main` at LM_ARGS
   with --experts 8 at the JAX defaults (top-2, capacity factor 2.0, sort
   dispatch, z-loss weight 0.1), 4 steps graphed, --attn flash and the
   plain route (--attn ring): tokens/s, ms per step, MFU (the top-2
   experts counted), peak memory, flash launches a step; gates: the flash
   counters at their formula, all on mma, none on the plain route; the
   logged losses within LOSS_TOL of the plain route and every weight's
   step-0 gradient within GRAD_TOL, each token routed to the plain route's
   experts on both routes (`pinned_routing`; why: port_probes/moe_route_noise.py);
   3 steps and 2 eval batches graphed bitwise eager (phase 20's check);
   one eager step under the profiler (its kernels' device time by group:
   routing, index_add, gather, matmuls, flash); (b) `moe_ffn` sort against dense on
   the card at T 64 (f32, d 512, d_ff 2048, 8 experts, top-2) at the
   no-drop capacity and at 4: output and aux within 1e-5, gradients within
   2e-4; (c) --dp 2 (the experts over the data axis, ep 2) on 2 ranks
   sharing the card over gloo at depth 2 (`port_probes/moe_world.py`, run
   by phase 21's launch of the ranks): the
   losses within LOSS_TOL of one process, the update within UPDATE_TOL
   leaf by leaf (the expert leaves printed), the ranks' SUMMARY lines and
   gathered parameters equal, each rank's flash launches the formula, the
   collectives' time a step (the gradient sync and the all-to-alls); (d)
   the MoE `generate` (dense dispatch, capacity = batch) of 16 prompts of
   64 tokens, 32 new, greedy, on the decode kernel's route: its decode
   launches the formula, all on the split route, and its tokens against
   decode_impl="torch" per token (after the same history, as phase 9) at
   >= 0.99;
29. checkpoint, resume, trace, run record (`resume_phase`): (a) the CNN
   main path at full width with --fused --kernels cuda and
   --failure-probability 0.5, 4 epochs against 2 with --checkpoint-dir and a
   --resume to 4: per-epoch metrics, params and momentum (the final
   checkpoints) bitwise, the resumed run's head launches the formula of its
   2 epochs; (b) the flagship LM row with --attn flash, Adam and a cosine
   schedule, graphed, 6 steps against --stop-at-step 3 and a --resume to 6:
   losses, params and Adam state bitwise, the resumed step one graph, every
   run's flash launches the formula of the steps it ran, all on mma; (c) the
   same run with --chaos-sigterm-after 2, a real SIGTERM to this process
   (the flag read at the next step's launch): an emergency checkpoint at
   step 3 and a clean return, and the resume from it bitwise (b)'s
   uninterrupted run; (d) --trace-out, --step-stats and --run-record on (a) and on a 6-step
   LM run (bitwise the untraced one; ms per step tracer off / on in the same
   call): tools/trace_summary.py reads the traces with rc 0, the records
   read back through `utils/goodput.py` (tools/goodput.py imports the JAX
   package, so it needs flax, which the card's machine lacks; the CPU tests
   run it on the port's records), conserve and hold the build and captures under compile; the
   checkpoints' save and restore seconds and bytes; a full-width server under
   --trace-out answering 4 requests on the decode kernel, its trace (request
   lanes and the serve record inside) read the same ways; (e) --dp 2 on
   2 ranks sharing the card over gloo at depth 2 (`port_probes/ckpt_world.py`'s flow,
   run by phase 21's launch of the ranks):
   the resume bitwise the uninterrupted run on both ranks, the flash
   launches the formula, the ranks' trace shards merged by
   tools/trace_merge.py. `python3 chip_smoke.py --resume-check` runs the
   build and this phase alone (with its own launch of the ranks);
30. the training guard and its chaos (`guard_phase`), in process through
   `lm_train.main` and `train.cli.main`: (a) the flagship LM row with
   --attn flash, Adam and a cosine schedule, GUARD_STEPS steps, --guard
   off, warn, warn, off in one call: the warn runs' losses, parameters and
   Adam state bitwise the off runs', ms per step of each; (b) --guard skip
   --chaos-nan-step 2 --stop-at-step 3: parameters, m, v and t bitwise an
   unguarded --stop-at-step 2 run, the skip logged and counted; the whole
   skip run one graph (captured once), finite after the skip, its flash
   launches the formula, all on mma; (c) --guard rollback
   --chaos-spike-step GUARD_SPIKE --snapshot-every GUARD_SNAPSHOT with
   --trace-out and --run-record: one rollback, lr_scale 0.5, the losses
   before the snapshot bitwise (a)'s off run's, the step captured once (the
   backed-off lr read from its buffer), the flash launches those of the
   steps run (replays included), the record's rollback_recompute above 0,
   tools/trace_summary.py's guard events table with the spike and the
   restore; the snapshots' and the restore's seconds and bytes; (d) --guard
   abort --chaos-nan-step 1: GuardAbort with the JAX text; (e) the CNN main
   path per epoch (phase 29's run without --fused, 3 epochs): --guard warn
   --fused (the per-epoch fallback line) bitwise the unguarded run, head
   launches the formula; `Engine.run(guard=)` with a rollback guard whose
   observation of epoch 2 is multiplied by CNN_SPIKE once: the epoch-0
   snapshot restored bitwise, the lr halved, the programs built and
   captured again, the head launches the formula of the 6 epochs run, and
   the recompile detector on the engine's step program (`_step`) counting no
   recompile. `python3 chip_smoke.py --guard-check` runs the build and this
   phase alone;
31. the monitor (`monitor_phase`, `train/monitor.py`), in process through
   `lm_train.main` and `train.cli.main`: (a) the flagship LM row of phase 30
   (flash, Adam, cosine, graphed), MONITOR_STEPS steps, bare / full stack /
   full stack / bare in one call (the full stack: --metrics-port 0 with the
   registry, server and watchdog, and the heartbeat file, flight dump and run
   record armed by their environment variables): the monitored step within
   1% of the bare step, the losses, parameters and Adam state bitwise, one
   graph a step, the flash launches the formula (all mma), recompiles_total
   and watchdog_stall_total 0, the heartbeat at the last step, the flight
   dump from run_start to run_end, the record read back; (b) a
   MONITOR_STALL_S host stall after step MONITOR_STALL_AT
   (--chaos-stall-step) with the watchdog at poll 0.05 s and a 0.2 s floor
   and --watchdog-escalate preempt: the stall flagged once (its heartbeat
   age against the adaptive threshold), its watchdog/stall instant and the
   escalation in --trace-out, stall badput in the run record, the flight
   dump's events, the run stopped after the next step at an emergency
   checkpoint, its losses bitwise the bare run's; (c) the resume from it with
   GET /profile?steps=2 over HTTP as it starts: bitwise the bare run
   (params, Adam state and the profiled steps' losses), one torch.profiler
   capture of the two steps after the first beat, a Chrome trace holding one
   cudaGraphLaunch a step (whether the flash kernels show by name is
   printed); (d) recompiles_total 0 in those LM runs and in phase 30(e)'s
   CNN rollback; (e) the CNN main path --fused with --metrics-port 0, 2
   epochs in one span: the epochs' metrics bitwise the unmonitored run's,
   the head launches the formula, phase_seconds_total and train_steps_total
   in the registry's export. `python3 chip_smoke.py --monitor-check` runs
   the build and this phase alone;
32. elastic resume (`elastic_phase`, `port_probes/elastic_world.py`'s flow
   at the flagship width, --attn flash): (a) --dp 2 --optimizer zero-adam on
   2 ranks sharing the card over gloo (run by phase 21's launch of the
   ranks), its checkpoint after step 1 (written by both ranks: (b)'s
   hand-off) resumed in this process
   with --resume --elastic --dp 1 --optimizer adam: the resume log names
   the data axis and the optimizer layout, accum 1 -> 2, the continued
   losses within 1e-3 of the uninterrupted run (phase 23's zero-adam run, the
   same flags), the resumed step one graph, the flash launches the formula
   (all mma); reshard_seconds and the bytes read; (b) --chaos-shrink-at-step
   1 --chaos-shrink-to 1 on those 2 ranks: rank 1 leaves with exit 0, rank
   0 finishes every step single (dp 1) with accum 2, steps 0-1 bitwise the
   uninterrupted run's and the rest within 1e-3, its step captured again as
   one graph, both ranks' flash launches the formula of the steps each ran;
   ms a step before and after; (c) the CNN: phase 29(a)'s 4-worker
   checkpoint restored at 2 workers (`Checkpointer.restore_latest(elastic=
   True)`: the surviving momentum rows and the params bitwise the saved
   ones), then --resume --elastic --fused at --nb-proc 2 for 2 epochs
   through `train.cli.main`: the head launches the formula at 2 workers.
   `python3 chip_smoke.py --elastic-check` runs the build and this phase
   alone (with its own launch of the ranks);
33. the elastic supervisor (`supervisor_phase`,
   `port_probes/supervisor_world.py`'s flow): the user's launcher, `python -m
   distributed_neural_network_tpu_torch.launch --nprocs 2 --chaos-kill-rank 1
   --chaos-kill-at-step 3`, over 2 ranks of the LM entry point sharing the
   card over gloo at the flagship width (LM_ARGS, --attn flash --dp {devices}
   --steps 6 --stop-at-step 6 --checkpoint-every 2 --resume --elastic), each
   rank `lm_train.cli()` (the probe's `worker`, which then writes the rank's
   flash launch counters): (a) --chaos-kill-signal KILL: the launcher exits 0,
   SUPERVISOR_SUMMARY exit ok, final_size 1, 2 generations and the one
   failure rank 1's SIGKILL (rank 0 collateral: its collective failed, it
   exits 0), postmortem.json with rank 1's flight dump and heartbeat,
   generation 1 resumed from the newest periodic checkpoint with the elastic
   lines (dp 2 -> 1, accum 1 -> 2), one graph a step, its flash launches the
   formula (all mma), every loss within 1e-3 of the uninterrupted dp-2 run
   of the same flags (run in phase 21's launch of the ranks), the fleet
   run_record.json valid with a restart gap; (b) --chaos-kill-signal TERM:
   rank 1 exits PREEMPT_RC after the emergency checkpoint, the one failure
   its `preempt`, final_size 1, generation 1 resumed at the step after the
   emergency checkpoint (every step run once), the losses as in (a). Both:
   the launcher (which imports no torch) never maps the CUDA driver nor
   opens a /dev/nvidia* file (`/proc/PID/maps`, `/proc/PID/fd`; the workers
   do: the control), never shows among the card's compute processes, and
   leaves none of its workers there (checked once both have ended). (a) and
   (b) run at once, each launcher over its own 2 ranks (4 ranks share the
   card and the host; no gate depends on the timing). Prints the restart
   seconds (death -> respawn), death -> first step, the grace spent and ms a
   step in each generation. `python3 chip_smoke.py
   --supervisor-check` runs the flash build and this phase alone (with its
   own launch of the ranks for the uninterrupted run).

The phases' in-process runs share one copy of each synthetic CIFAR-10
split (`memoize_synthetic`).

The last lines are the kernel table as one JSON object, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import http.client
import json
import functools
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 peak outside the tensor
# cores, bf16 dense tensor-core peak
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12  # the int8 / fp8 dense tensor-core peak, same sheet
TOL = 1e-4
# flash kernels vs plain: bf16 as the decode kernels (two bf16 ulps at 1).
# Quantized forward: p comes from expf in the kernel and torch.exp in the
# plain version, which differ in the last bits, so now and then a code of p
# rounds the other way. An int8 code step moves o by at most 1/127 of the
# row's largest term: atol = rtol = 2e-2. An e4m3 step is up to 1/8 of its
# term, so fp8 is gated on the mean error (1e-4; such flips are rare) and on
# a max error of two steps, 2 * (1/8) * max |v|
QUANT_TOL = 2e-2
FP8_MEAN_TOL, FP8_STEP = 1e-4, 0.25
DECODE = "distributed_neural_network_tpu/ops/decode_pallas.py"
FLASH = "distributed_neural_network_tpu/ops/flash_pallas.py"
# the repo's flagship LM training row lm_flash_d512_L8_seq2048_bf16 (bench.py,
# geometry in train/measure.py measure_lm_training), nothing cut
LM_SHAPE = {"batch_size": 16, "seq_len": 2048, "vocab": 32768, "d_model": 512, "n_layers": 8,
            "n_heads": 8, "d_ff": 2048}
LM_ARGS = [a for k, v in LM_SHAPE.items() for a in ("--" + k.replace("_", "-"), str(v))] + [
    "--dtype", "bfloat16", "--lr", "0.01", "--momentum", "0.9", "--seed", "0"]
LM_STEPS, LM_LOG_EVERY = 20, 10
# the attention inputs that LM_ARGS give each flash kernel: (B, S, H, D)
FLASH_MAIN = (16, 2048, 8, 64)
# those the mesh's axes give them (B / dp rows, H / tp heads a rank): --tp 2
# (phase 24; --precision int8 there too), --tp 4 and --dp 2 --tp 2
# --accum-steps 4 (port_probes/lm_mesh_world.py on four cards), --dp 2
# (phases 21-23 and 25)
FLASH_MESH = ((16, 2048, 4, 64), (16, 2048, 2, 64), (2, 2048, 4, 64), (8, 2048, 8, 64))
# those of the remat-policy runs (phase 27: the JAX bench row
# lm_flash_d512_L8_seq2048_bf16_hd128_dots_b32's batch 32, H 4, D 128)
FLASH_REMAT = (32, 2048, 4, 128)
# kernel route vs plain route from the same init and batches, bf16 (scores
# and softmax in bf16 on the plain route, f32 in the kernels): the logged
# losses (steps 0, 10, 19; the loss moves about 0.27 over the 20 steps;
# measured differences 4e-5 to 6e-5) within LOSS_TOL, and the gradient of
# every weight at step 0 (each layer of a stacked leaf on its own) within
# GRAD_TOL in relative L2 norm (measured: 0.0115 at worst)
LOSS_TOL = 1e-3
GRAD_TOL = 5e-2
# the launch-formula runs of phase 13 (--remat, --remat-attn, --accum-steps,
# eval) take this many steps at full width
FORMULA_STEPS = 4
# phase 28: the flagship row with --experts 8 at the JAX defaults (top-2,
# capacity factor 2.0, sort dispatch, z-loss weight 0.1), this many steps
MOE_EXPERTS, MOE_STEPS = 8, 4
MOE_ARGS = ["--experts", str(MOE_EXPERTS)]
# phase 29: the LM resume's optimizer and schedule (Adam's counter and the
# schedule's step are in the checkpoint), and the CNN main path's run with
# --fused and a fault mask (the cursor: seed and epoch)
LM_RESUME = ["--attn", "flash", "--optimizer", "adam", "--lr-schedule", "cosine",
             "--warmup-steps", "1"]
RESUME_WORLD_LAYERS = 2  # phase 29(e)'s depth
# phase 29(e)'s records and checkpoints (gigabytes; removed in phase 29),
# written by the ranks phase 21 starts
RESUME_WORLD_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                                "ckpt_world2")
# phase 32's records and checkpoints (gigabytes; removed in phase 32): the LM
# runs' written by the ranks phase 21 starts, the CNN's copied from phase 29(a)
ELASTIC_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "elastic_world2")
ELASTIC_CNN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "elastic_cnn")
# phase 33's supervised runs (checkpoints: gigabytes; removed in phase 33) and
# its uninterrupted run's record and checkpoints, written by the ranks phase
# 21 starts
SV_RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "supervisor")
SV_WHOLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs", "supervisor_whole")
# the one-process LM runs' parameter updates (~236 MB each), written in phase
# 21, read by its launch's ranks (phases 24-25's runs), removed in phase 21
MESH_UPDATES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                            "lm_mesh_updates")
CNN_RESUME = ["--regime", "data_parallel", "--nb-proc", "4", "--kernels", "cuda", "--fused",
              "--data", "synthetic", "--synthetic-size", "50000", "--batch-size", "16",
              "--lr", "0.01", "--failure-probability", "0.5", "--seed", "3", "--device", "cuda"]
# phase 30: the guard's LM runs (LM_ARGS + LM_RESUME) take GUARD_STEPS
# steps; the skip run's gradients are NaN at GUARD_NAN; the rollback run's
# observed loss is spiked at GUARD_SPIKE (the spike detector arms after the
# guard's 10 warm-up observations), with a snapshot every GUARD_SNAPSHOT
# steps; the CNN runs are phase 29's main path per epoch (--fused falls back)
GUARD_STEPS, GUARD_NAN, GUARD_SPIKE, GUARD_SNAPSHOT = 14, 2, 12, 5
CNN_GUARD = [a for a in CNN_RESUME if a != "--fused"]
CNN_GUARD_EPOCHS, CNN_SPIKE = 3, 1e6
# phase 31: the monitor's LM runs (LM_ARGS + LM_RESUME) take MONITOR_STEPS
# steps; the stalled run sleeps MONITOR_STALL_S on the host after step
# MONITOR_STALL_AT; the CNN runs are phase 29's main path (--fused) for
# MONITOR_CNN_EPOCHS epochs
MONITOR_STEPS, MONITOR_STALL_AT, MONITOR_STALL_S, MONITOR_CNN_EPOCHS = 20, 9, 2.0, 2
SERVE_ARGS = ["--device", "cuda", "--port", "0", "--d-model", "512", "--n-layers", "8",
              "--n-heads", "8", "--d-ff", "2048", "--vocab", "256", "--dtype", "bfloat16",
              "--seed", "0", "--max-batch", "8", "--num-blocks", "129", "--block-size", "16",
              "--max-seq-len", "256", "--prefill-chunk", "16", "--warmup"]
N_REQUESTS, RATE, MAX_NEW, PROMPT_LENS = 24, 4.0, 32, (16, 64, 128)
# the CNN head's (replicas N, rows B): the main path's shape (4 workers at
# batch 16, one launch for all), the cases held to the plain versions (a
# batch of 1, the main path, run_training.sh's B 64, 4,096 rows, ragged B),
# the timed shapes, and where the reduce's kernel line is timed (the main
# path never launches it: one group at B 16)
HEAD_MAIN = (4, 16)
HEAD_CASES = ((1, 1), HEAD_MAIN, (4, 64), (1, 4096), (2, 200))
HEAD_TIMED = (HEAD_MAIN, (1, 16), (1, 128), (1, 4096))
REDUCE_SHAPE = (1, 4096)
# phase 4's CNN run (512 synthetic rows of seed 3, 128 test rows), which
# phases 17-19 run again across processes, streamed and in bf16
CNN_SMALL = {"lr": 0.01, "momentum": 0.9, "batch_size": 16, "epochs": 2, "nb_proc": 4,
             "regime": "data_parallel", "kernels": "cuda", "seed": 0}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


@contextmanager
def phase(name):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{name}' FAILED", file=sys.stderr, flush=True)
        sys.exit(1)
    print(f"   ({name}: {time.perf_counter() - t0:.1f} s)", flush=True)


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


@contextmanager
def uncounted(*counters):
    """Launches made inside are not main-path launches: each launch-counter
    dict gets its values back on the way out."""
    saved = [dict(c) for c in counters]
    try:
        yield
    finally:
        for c, values in zip(counters, saved):
            c.update(values)


# ------------------------------------------------------------------- helpers


def head_inputs(torch, b, device, seed, n=1):
    """x (n, b, 400) and n replicas' weights (in, out) and biases, each
    replica its own draw."""
    g = torch.Generator().manual_seed(seed)
    shapes = [(b, 400), (400, 120), (120,), (120, 84), (84,), (84, 10), (10,)]
    scales = [1.0, 0.05, 1.0, 0.05, 1.0, 0.05, 1.0]
    return [(torch.randn(n, *s, generator=g) * k).to(device) for s, k in zip(shapes, scales)]


def max_err(torch, a, b):
    if isinstance(a, (list, tuple)):
        return max(max_err(torch, x, y) for x, y in zip(a, b))
    return float((a.detach() - b.detach()).abs().max())


def assert_close(torch, name, a, b):
    for i, (x, y) in enumerate(zip(a, b) if isinstance(a, (list, tuple)) else [(a, b)]):
        ok = torch.allclose(x.detach(), y.detach(), atol=TOL, rtol=TOL)
        check(ok, f"{name}[{i}] differs: max abs err {max_err(torch, x, y)}")


def time_ms(torch, fn, iters=200, warmup=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters=50, replays=5):
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed, so host dispatch cost drops out. None if `fn` cannot be
    captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # captured on the warm-up's stream, whose library workspaces the
        # warm-up made
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        print(f"   (graph capture failed: {str(e).splitlines()[0]})")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def l2_cold(torch, t):
    """A function that returns the next of enough copies of `t` that
    cycling through them reads each from HBM: between two reads of one copy
    the others move twice the card's L2."""
    l2 = getattr(torch.cuda.get_device_properties(t.device), "L2_cache_size", 0) or 50 << 20
    copies = [t.clone() for _ in range(ceil(2 * l2, t.numel() * t.element_size()) + 1)]
    at = [0]

    def nxt():
        at[0] = (at[0] + 1) % len(copies)
        return copies[at[0]]

    return nxt


def fmt(t):
    return "n/a" if t is None else f"{t:.5f}"


def ceil(a, b):
    return -(-a // b)


def head_launches(batch, epochs, workers=4):
    """The head kernels' launches of a full-width CNN run (4 workers, 50,000
    rows, 10,000 test rows): per epoch one forward and one backward launch
    per step for all the replicas, one forward per eval batch, the reduce per
    step where a replica's batch forms more than one group."""
    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    steps = ceil(50_000 // workers, batch) * epochs
    evals = ceil(ceil(10_000, workers), batch) * epochs
    return {"fused_mlp3_fwd": steps + evals, "fused_mlp3_bwd": steps,
            "fused_mlp3_bwd_reduce": steps if fh.bwd_groups(batch) > 1 else 0}


def bound_ms(bytes_moved, flops, peak_flops=PEAK_F32_FLOPS):
    """(least time in ms, what bounds it) on the card's published peaks."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def pct(xs, q):
    """Nearest-rank percentile (None when empty)."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def print_ptxas(lib):
    """One line per library from the compiler's log (printed and returned):
    its kernel instances, their register range and those that spill
    (mangled names)."""
    log = lib[: -len(".so")] + ".log"
    if not os.path.isfile(log):
        return
    name, regs, spills = None, [], []
    for line in open(log):
        if "Function properties for" in line:
            name = line.split("for")[-1].strip()
        elif "spill stores" in line:
            stores = int(line.split("bytes spill stores")[0].split(",")[-1])
            if stores:
                spills.append(f"{name[:70]} ({stores} B)")
        elif "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
    if regs:
        line = (f"ptxas {os.path.basename(lib)}: {len(regs)} kernel instances, {min(regs)}-"
                f"{max(regs)} registers; spills: {'; '.join(spills) or 'none'}")
        print("   " + line)
        return line


def ptxas_instances(lib, stem):
    """{"kernel<[T,]A[,B[,C]]>": {"registers", "spill_stores", "spill_loads"[,
    "static_smem"]}} from the compiler's log, for the kernel instances whose
    name holds `stem` (T: f32 or bf16 where the first template argument is
    a type; A, B, C: the integral ones, a bool as 0 or 1)."""
    out, name = {}, None
    for line in open(lib[: -len(".so")] + ".log"):
        if "Function properties for" in line:
            m = re.search(r"(?<=\d)((?:flash|mlp3|decode)_[a-z0-9_]+?_kernel)I(f|13__nv_bfloat16)?"
                          r"L[ib](\d+)E(?:L[ib](\d+)E)?(?:L[ib](\d+)E)?", line)
            args = ([{"f": "f32"}.get(m.group(2), "bf16")] if m and m.group(2) else []) + [
                g for g in (m.groups()[2:] if m else ()) if g]
            name = f"{m.group(1)}<{','.join(args)}>" if m and stem in m.group(1) else None
        elif name and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name] = {"spill_stores": int(stores), "spill_loads": int(loads)}
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(line.split("Used")[1].split()[0])
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                out[name]["static_smem"] = int(smem.group(1))
    return out


def device_busy_s(prof, DeviceType):
    """Seconds in which the card ran at least one kernel, copy or memset:
    the union of the device events' intervals (replays of a captured graph
    report kernels whose intervals overlap, so their sum can exceed the wall
    time)."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                              if e.device_type == DeviceType.CUDA):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e6


def profile_rows(prof, DeviceType):
    """(kernel name, device us, count) rows: kernel rows only, since an
    operator's row repeats its kernels' device time."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


HOST_CALLS = {"graph": ("cudaGraphLaunch",), "kernel": ("cudaLaunchKernel", "cuLaunchKernel"),
              "copy": ("cudaMemcpyAsync",)}


def host_calls(prof, DeviceType):
    """The host's launches in a profiled window, from the CUDA runtime and
    driver calls the profiler records: graph launches, kernel launches
    (cudaLaunchKernel*, cuLaunchKernel*) and async copies."""
    out = dict.fromkeys(HOST_CALLS, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            for kind, names in HOST_CALLS.items():
                if e.key.startswith(names):
                    out[kind] += e.count
    return out


def pool_bytes(torch, handle):
    """Bytes of the device segments in memory pool `handle` (a graph
    pool), from the allocator's snapshot; None where it does not say."""
    segs = torch.cuda.memory._snapshot()["segments"]
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs if tuple(s["segment_pool_id"]) == tuple(handle))


def profiled_window(torch, fn, n, part):
    """`fn` run n times under torch.profiler, synchronised: wall, device busy
    (`device_busy_s`), the kernels' summed time, idle share, host calls
    (`host_calls`), the top 12 kernels and the kernels whose name holds
    `part`: their summed time, launches and share of the kernels' sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = profile_rows(prof, DeviceType)
    busy = device_busy_s(prof, DeviceType)
    total = sum(r[1] for r in rows) / 1e6
    mine = [r for r in rows if part in r[0]]
    part_s = sum(r[1] for r in mine) / 1e6
    return {"wall_s": wall, "device_busy_s": busy, "kernel_sum_s": total,
            "idle_share": 1 - busy / wall if busy else None,
            "host_calls": host_calls(prof, DeviceType), "part": part, "part_s": part_s,
            "part_launches": sum(r[2] for r in mine),
            "part_share": part_s / total if total else None,
            "top": sorted(rows, key=lambda r: -r[1])[:12]}


def profiled_epoch(torch, eng, epoch):
    """Run `epoch` of a CNN engine under torch.profiler (after a run that
    captured its programs): wall, device busy (`device_busy_s`), the kernels'
    summed time, idle share and the top 12 kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_epoch(epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = profile_rows(prof, DeviceType)
    busy = device_busy_s(prof, DeviceType)
    return {"wall_s": wall, "device_busy_s": busy, "kernel_sum_s": sum(r[1] for r in rows) / 1e6,
            "idle_share": 1 - busy / wall if busy else None,
            "top": sorted(rows, key=lambda r: -r[1])[:12]}


def head_work(n, b, fh):
    """(bytes, flops) each kernel must move/do for n replicas at batch b
    (inputs read once, outputs written once; the backward writes one row of
    sums per group, the reduce reads them)."""
    w = fh.GRAD_SIZE  # weights + biases
    groups = fh.bwd_groups(b)
    mac = 400 * 120 + 120 * 84 + 84 * 10
    fwd = (4 * n * (b * 400 + w + b * (10 + 120 + 84)), 2 * n * b * mac)
    bwd = (4 * n * (b * (10 + 400 + 120 + 84) + (w - 214) + b * 400 + groups * w),
           4 * n * b * mac)
    red = (4 * n * (groups * w + w), n * groups * w)
    return {"fwd": fwd, "bwd": bwd, "reduce": red}


# ------------------------------------------------------------ serving helpers


DECODE_LAYOUTS = ("contiguous", "strided", "misaligned")


def decode_inputs(torch, kind, b, h, d, total, layout, dev, g):
    """q and the K/V cache in one of DECODE_LAYOUTS: contiguous (B, H, S,
    Dh); the transposed (B, S, H, Dh) slab the serving engine passes; or
    that slab's head dims starting 8 bytes into rows of Dh + 16 elements
    (off a 16-byte boundary: the simt route); plus the int8 kernel's
    scales."""
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    kvdt = torch.int8 if kind == "int8" else qdt
    q = torch.randn(b, h, d, device=dev, generator=g).to(qdt)
    shape = (b, h, total, d) if layout == "contiguous" else (b, total, h, d)
    k, v = (torch.randn(*shape, device=dev, generator=g) for _ in "kv")
    if kind == "int8":
        k, v = ((t * 40).round().clamp(-127, 127) for t in (k, v))
    if layout == "misaligned":
        off = 8 // torch.empty(0, dtype=kvdt).element_size()

        def shift(t):
            buf = torch.zeros(b, total, h, d + 16, device=dev, dtype=kvdt)
            buf[..., off:off + d] = t
            return buf[..., off:off + d]

        k, v = shift(k), shift(v)
    if layout != "contiguous":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    k, v = k.to(kvdt), v.to(kvdt)
    if kind != "int8":
        return q, k, v, {}
    kw = {name: torch.rand(b, h, total, device=dev, generator=g) * 0.05 + 1e-3
          for name in ("k_scale", "v_scale")}
    return q, k, v, kw


def sse_request(port, prompt, max_new, out):
    """One streamed request; fills `out` with the tokens, their arrival
    times and the done frame."""
    t0 = time.perf_counter()
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", "/v1/generate", json.dumps({"prompt": prompt, "max_new_tokens": max_new}),
              {"Content-Type": "application/json"})
    r = c.getresponse()
    toks, stamps, done = [], [], None
    if r.status == 200:
        for line in iter(r.readline, b""):
            if not line.startswith(b"data: "):
                continue
            doc = json.loads(line[6:])
            if "token" in doc:
                toks.append(doc["token"])
                stamps.append(time.perf_counter())
            else:
                done = doc
                break
    else:
        r.read()
    c.close()
    out.update(status=r.status, tokens=toks, stamps=stamps, t0=t0,
               t_done=time.perf_counter(), done=done)


def open_loop(port, prompts, arrivals):
    """Send every request at its arrival offset (s) from now, each on its
    own thread; return the per-request results in order."""
    results = [{} for _ in prompts]
    start = time.perf_counter()

    def one(i):
        time.sleep(max(0.0, start + arrivals[i] - time.perf_counter()))
        sse_request(port, prompts[i], MAX_NEW, results[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    return results


class Oracle:
    """The port's offline bf16 generate() on the served model, on either
    route (decode kernel "cuda", plain "torch"): its streams for the served
    prompts, and how far the served streams agree with them."""

    def __init__(self, torch, tfm, prompts, dev, cfg=None):
        self.torch, self.tfm, self.prompts, self.dev = torch, tfm, prompts, dev
        # the served model (phase 9), or `cfg` (phase 28's MoE model)
        self.cfg = cfg or tfm.TransformerConfig(vocab_size=256, d_model=512, n_heads=8,
                                                n_layers=8, d_ff=2048, dtype=torch.bfloat16)
        self.params = tfm.init_params(0, self.cfg, dev)
        self.routes = {"cuda": self.route_streams("cuda")}

    def route_streams(self, impl):
        """generate()'s streams on route `impl` for every prompt (prompts of
        one length in one batch)."""
        streams = [None] * len(self.prompts)
        for n in sorted({len(p) for p in self.prompts}):
            idx = [i for i, p in enumerate(self.prompts) if len(p) == n]
            out = self.generate([self.prompts[i] for i in idx], MAX_NEW, impl)
            for row, i in zip(out, idx):
                streams[i] = row
        return streams

    def generate(self, prompts, n_new, impl="cuda"):
        out = self.tfm.generate(self.params, self.torch.tensor(prompts, device=self.dev),
                                self.cfg, max_new_tokens=n_new, decode_impl=impl)
        return out[:, len(prompts[0]):].tolist()

    def near_ties(self, gap=0.02):
        """Share of the oracle's own greedy choices whose top-2 logit gap is
        under `gap`: how often a rounding difference can flip a stream."""
        torch, n_close, n = self.torch, 0, 0
        for p, want in zip(self.prompts, self.routes["cuda"]):
            toks = torch.tensor([p + want], device=self.dev)
            h = self.tfm.apply_hidden(self.params, toks, self.cfg)[0][0, len(p) - 1: -1]
            # f32 logits, as the engine and generate() form them
            logits = h.float() @ self.params["head"].to(self.cfg.dtype).float()
            top2 = logits.topk(2, dim=-1).values
            n_close += int(((top2[:, 0] - top2[:, 1]) < gap).sum())
            n += len(want)
        return n_close / n

    def agreement(self, served, impl="cuda"):
        """(per-token agreement, the same up to the oracle's own rounding,
        stream agreement) of the served streams against generate() on route
        `impl`.

        Per token: each served token against generate()'s choice after the
        same prompt and the same earlier served tokens (generate runs again
        from the served prefix after each disagreement). Up to rounding: a
        disagreement counts as agreement when generate's other route (the
        same function, summed in another order) picks the served token after
        that history, i.e. where the bf16 model itself has no single answer.
        Stream: the two streams zipped position by position, the JAX serving
        row's form, in which one flipped near-tie makes every later token
        count as wrong."""
        if impl not in self.routes:
            self.routes[impl] = self.route_streams(impl)
        other = "torch" if impl == "cuda" else "cuda"
        agree = ties = zipped = total = 0
        for p, want, got in zip(self.prompts, self.routes[impl], served):
            zipped += sum(int(a == b) for a, b in zip(got, want))
            total += len(got)
            j, ref = 0, want
            while j < len(got):
                if ref[0] == got[j]:
                    agree, j, ref = agree + 1, j + 1, ref[1:]
                    continue
                ties += int(self.generate([p + got[:j]], 1, impl=other)[0][0] == got[j])
                j += 1
                if j < len(got):
                    ref = self.generate([p + got[:j]], len(got) - j, impl)[0]
        n = max(total, 1)
        return agree / n, (agree + ties) / n, zipped / n


def plain_invariance(torch, da, dev, g):
    """Phase 8's check of the plain decode version on the card, at the
    shapes its two callers give it (the serving engine's bucket slab and
    generate()'s static cache): one (b, h) row's live prefix of 37 columns
    padded to 48 and to 2048 columns, alone and at position 3 of a batch of
    8 whose other rows sit at other positions, in a contiguous (B, H, S, Dh)
    cache and as the engine's transposed (B, S, H, Dh) slab, must give the
    same bits; for bf16 K/V and for int8 K/V with per-slot scales. Returns
    the number of surroundings compared per dtype."""
    h, d, n = 8, 64, 37
    n_cases = 0
    for quantized in (False, True):
        kv_dt = torch.int8 if quantized else torch.bfloat16

        def rand(*shape):
            x = torch.randn(*shape, device=dev, generator=g)
            return (x * 40).round().clamp(-127, 127).to(kv_dt) if quantized else x.to(kv_dt)

        q_row = torch.randn(h, d, device=dev, generator=g).to(torch.bfloat16)
        k_row, v_row = rand(n, h, d), rand(n, h, d)
        s_row = [torch.rand(n, h, device=dev, generator=g) * 0.05 + 1e-3 for _ in "kv"]
        outs = []
        for total in (48, 2048):
            for batch, at in ((1, 0), (8, 3)):
                for transposed in (False, True):
                    k, v = rand(batch, total, h, d), rand(batch, total, h, d)
                    k[at, :n], v[at, :n] = k_row, v_row
                    scales = [torch.rand(batch, total, h, device=dev, generator=g) * 0.05 + 1e-3
                              for _ in "kv"]
                    for sc, row in zip(scales, s_row):
                        sc[at, :n] = row
                    q = torch.randn(batch, h, d, device=dev, generator=g).to(torch.bfloat16)
                    q[at] = q_row
                    pos = torch.randint(0, total, (batch,), device=dev, generator=g)
                    pos[at] = n - 1
                    k, v = k.transpose(1, 2), v.transpose(1, 2)
                    scales = [sc.transpose(1, 2) for sc in scales]
                    if not transposed:
                        k, v = k.contiguous(), v.contiguous()
                        scales = [sc.contiguous() for sc in scales]
                    kw = dict(zip(("k_scale", "v_scale"), scales)) if quantized else {}
                    outs.append(da.decode_attention_plain(q, k, v, pos, **kw)[at])
        check(all(torch.equal(outs[0], o) for o in outs[1:]),
              f"the plain decode version's bits change with the row's surroundings "
              f"({'int8' if quantized else 'bf16'} K/V)")
        n_cases = len(outs)
    return n_cases


# -------------------------------------------------------------- flash helpers


FLASH_LAYOUTS = ("contiguous", "strided", "misaligned")


def flash_inputs(torch, b, s, h, d, dtype, layout, dev, g):
    """q, k, v, dO (B, S, H, D) in one of FLASH_LAYOUTS: contiguous; the (B,
    S, H, D) view of a (B, H, S, D) buffer (strided on S and H, read in
    place by the kernels); or head dims 4 .. 4 + D of a (B, S, H, D + 8)
    buffer, whose base is 8 bytes (bf16) off a 16-byte boundary."""
    def one():
        if layout == "strided":
            return torch.randn(b, h, s, d, device=dev, generator=g).to(dtype).transpose(1, 2)
        if layout == "misaligned":
            return torch.randn(b, s, h, d + 8, device=dev, generator=g).to(dtype)[..., 4:4 + d]
        return torch.randn(b, s, h, d, device=dev, generator=g).to(dtype)
    return one(), one(), one(), one()


def expected_route(torch, d, dtype, layout):
    """The route the stated rule gives these inputs, forward and backward
    alike (ops/flash_attention.py `fwd_route`, `bwd_route`), from the case
    alone: "mma" for bf16 with D % 16 == 0 in an aligned layout, "simt"
    otherwise."""
    return "mma" if dtype == torch.bfloat16 and d % 16 == 0 and layout != "misaligned" else "simt"


def flash_vs_plain(torch, fa, dev):
    """Phase 12: every flash kernel against its plain version on the card,
    and bitwise against itself on a second call; each case, forward and
    backward, on the route the stated rule gives it (`expected_route`),
    shown by the route counters. Returns the number of cases, the worst max
    abs errors per kernel over all cases ("flash_dq mma bf16", ... per route
    too), and those at the main path's own shape (FLASH_MAIN: (B, S, H, D) =
    (16, 2048, 8, 64), causal, bf16, contiguous, on the mma route; int8 and
    fp8 for the quantized kernel; "flash_fwd o": o's alone) and the largest
    at the mesh's shapes (FLASH_MESH, the same way: "flash_fwd mesh", ...;
    the quantized kernel at FLASH_MESH[0], --tp 2's) and at the remat
    runs' (FLASH_REMAT: "flash_fwd remat", "flash_dq remat", "flash_dkv
    remat")."""
    g = torch.Generator(dev).manual_seed(12)
    g_mesh = torch.Generator(dev).manual_seed(24)
    g_remat = torch.Generator(dev).manual_seed(27)
    worst, main, n = {}, {}, 0
    main_case = FLASH_MAIN + (True, torch.bfloat16, "contiguous")
    mesh_cases = [shape + (True, torch.bfloat16, "contiguous") for shape in FLASH_MESH]
    remat_case = FLASH_REMAT + (True, torch.bfloat16, "contiguous")

    def record(name, err, is_main, is_mesh=False, is_remat=False):
        worst[name] = max(worst.get(name, 0.0), err)
        if is_main:
            main[name] = max(main.get(name, 0.0), err)
        if is_mesh:
            main[f"{name} mesh"] = max(main.get(f"{name} mesh", 0.0), err)
        if is_remat:
            main[f"{name} remat"] = max(main.get(f"{name} remat", 0.0), err)

    cases = [(b, s, h, d, causal, dtype, layout)
             for (b, h) in ((1, 1), (2, 8)) for s in (1, 64, 200, 2048) for d in (64, 128, 16)
             for causal in (True, False) for dtype in (torch.float32, torch.bfloat16)
             for layout in ("contiguous", "strided")]
    # bf16 on both backward routes: D 32 (mma), D 40 (simt: D % 16 != 0) and
    # misaligned views (simt)
    cases += [(2, s, 8, d, causal, torch.bfloat16, layout)
              for s in (64, 200) for d in (32, 40) for causal in (True, False)
              for layout in ("contiguous", "strided")]
    cases += [(2, s, 8, d, causal, torch.bfloat16, "misaligned")
              for s in (1, 200) for d in (64, 128) for causal in (True, False)]
    cases += [main_case] + mesh_cases + [remat_case]
    for case in cases:
        b, s, h, d, causal, dtype, layout = case
        is_main, is_mesh, is_remat = case == main_case, case in mesh_cases, case == remat_case
        tol = 1e-4 if dtype == torch.float32 else 1.6e-2
        q, k, v, do = flash_inputs(torch, b, s, h, d, dtype, layout, dev,
                                   g_remat if is_remat else g_mesh if is_mesh else g)
        where = f"B={b} S={s} H={h} D={d} causal={causal} {dtype} {layout}"
        route = fa.bwd_route(q, k, v, do)
        check(route == expected_route(torch, d, dtype, layout) == fa.fwd_route(q, k, v),
              f"routes: forward {fa.fwd_route(q, k, v)}, backward {route}, the rule says "
              f"{expected_route(torch, d, dtype, layout)}: {where}")
        before = dict(fa.ROUTE_LAUNCHES)
        o, lse = fa.flash_fwd(q, k, v, causal=causal)
        o2, lse2 = fa.flash_fwd(q, k, v, causal=causal)
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"flash_fwd not bitwise reproducible: {where}")
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal=causal)
        for name, x, y, t in (("o", o, o_p, tol), ("lse", lse, lse_p, TOL)):
            ok = torch.allclose(x.float(), y.float(), atol=t, rtol=t)
            check(ok, f"flash_fwd {name} max abs err {max_err(torch, x.float(), y.float())}: "
                  f"{where}")
        err_o = max_err(torch, o.float(), o_p.float())
        record("flash_fwd", max(err_o, max_err(torch, lse, lse_p)), is_main, is_mesh, is_remat)
        record(f"flash_fwd {route} {'f32' if dtype == torch.float32 else 'bf16'}", err_o, False)
        if is_main:
            main["flash_fwd o"] = err_o
        delta = fa.flash_delta(o, do)
        dq = fa.flash_dq(q, k, v, do, lse, delta, causal=causal)
        dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, causal=causal)
        check(torch.equal(dq, fa.flash_dq(q, k, v, do, lse, delta, causal=causal)),
              f"flash_dq not bitwise reproducible: {where}")
        dk2, dv2 = fa.flash_dkv(q, k, v, do, lse, delta, causal=causal)
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"flash_dkv not bitwise reproducible: {where}")
        ran = {key: n_ - before[key] for key, n_ in fa.ROUTE_LAUNCHES.items()}
        want = {key: 2 if key.endswith("_" + route) and "quant" not in key else 0 for key in ran}
        check(ran == want, f"route launches {ran} != {want}: {where}")
        dq_p = fa.flash_dq_plain(q, k, v, do, lse, delta, causal=causal)
        dk_p, dv_p = fa.flash_dkv_plain(q, k, v, do, lse, delta, causal=causal)
        for name, x, y in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
            ok = torch.allclose(x.float(), y.float(), atol=tol, rtol=tol)
            check(ok, f"flash {name} max abs err {max_err(torch, x.float(), y.float())}: "
                  f"{where}")
        errs = {"flash_dq": max_err(torch, dq.float(), dq_p.float()),
                "flash_dkv": max(max_err(torch, dk.float(), dk_p.float()),
                                 max_err(torch, dv.float(), dv_p.float()))}
        for name, err in errs.items():
            record(name, err, is_main, is_mesh, is_remat)
            record(f"{name} {route} {'f32' if dtype == torch.float32 else 'bf16'}", err, False)
        n += 1
    # the quantized forward on codes, at the kernel's own k tile (BLOCK_K)
    qcases = [(fmt, 2, s, 8, d, causal, out, "strided" if s == 200 else "contiguous")
              for fmt in ("int8", "fp8") for s in (64, 200, 2048) for d in (64, 128)
              for causal in (True, False) for out in (torch.bfloat16, torch.float32)]
    qcases += [(fmt,) + case for fmt in ("int8", "fp8") for case in (main_case, mesh_cases[0])]
    for fmt, *case in qcases:
        b, s, h, d, causal, out, layout = case
        is_main, is_mesh = tuple(case) == main_case, tuple(case) == mesh_cases[0]
        q, k, v, _ = flash_inputs(torch, b, s, h, d, out, layout, dev, g)
        qc, sq, kc, sk, vc, sv = fa.quantize_qkv(q, k, v, fmt)
        o_p, lse_p = fa.flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv, causal=causal,
                                              out_dtype=out)
        v_max = float((vc.float() * sv[..., None]).abs().max())
        # the codes as they come (aligned: the mma route) and the same codes
        # 8 bytes off a 16-byte boundary (the simt route)
        for route, codes in (("mma", (qc, kc, vc)), ("simt", misaligned_codes(torch, qc, kc, vc))):
            where = f"{fmt} B={b} S={s} H={h} D={d} causal={causal} out {out} {layout} {route}"
            check(fa.quant_route(*codes) == route,
                  f"route {fa.quant_route(*codes)}, the rule says {route}: {where}")
            before = dict(fa.ROUTE_LAUNCHES)
            o, lse = fa.flash_fwd_quant_codes(*codes, sq, sk, sv, causal=causal, out_dtype=out)
            o2, lse2 = fa.flash_fwd_quant_codes(*codes, sq, sk, sv, causal=causal, out_dtype=out)
            check(torch.equal(o, o2) and torch.equal(lse, lse2),
                  f"flash_fwd_quant not bitwise reproducible: {where}")
            ran = {key: n_ - before[key] for key, n_ in fa.ROUTE_LAUNCHES.items()}
            want = {key: 2 if key == f"flash_fwd_quant_{route}" else 0 for key in ran}
            check(ran == want, f"route launches {ran} != {want}: {where}")
            diff = (o.float() - o_p.float()).abs()
            err = float(diff.max())
            if fmt == "int8":
                ok = torch.allclose(o.float(), o_p.float(), atol=QUANT_TOL, rtol=QUANT_TOL)
            else:
                ok = float(diff.mean()) <= FP8_MEAN_TOL and err <= FP8_STEP * v_max
            check(ok and torch.allclose(lse, lse_p, atol=TOL, rtol=TOL),
                  f"flash_fwd_quant max abs err {err}, mean {float(diff.mean())} "
                  f"(lse {max_err(torch, lse, lse_p)}): {where}")
            record(f"flash_fwd_quant {route} {fmt}", err, False)
            if route == "mma":
                record("flash_fwd_quant", err, is_main, is_mesh)
                if is_main:
                    main[f"flash_fwd_quant {fmt}"] = err
            n += 1
    torch.cuda.synchronize()
    return n, worst, main


def misaligned_codes(torch, *codes):
    """Copies of 8-bit codes (B, S, H, D) whose head dims start 8 bytes into
    rows of D + 16 bytes: off a 16-byte boundary, so on the simt route."""
    out = []
    for t in codes:
        buf = torch.zeros(*t.shape[:-1], t.shape[-1] + 16, dtype=torch.int8, device=t.device)
        view = buf.view(t.dtype)[..., 8:8 + t.shape[-1]]
        view.copy_(t)
        out.append(view)
    return out


def flash_work(b, s, h, d):
    """(bytes, operations) each causal flash kernel must move and do at (B,
    S, H, D): bf16 tensors, 1-byte codes and f32 scales for the quantized
    kernel, f32 lse and delta (inputs read once, outputs written once; the
    causal triangle counts S(S+1)/2 pairs)."""
    pairs = s * (s + 1) // 2
    mat = b * s * h * d  # elements of one (B, S, H, D) tensor
    rows = b * h * s
    mm = 2 * b * h * d * pairs  # one (pairs x D) product
    return {
        "flash_fwd": (4 * mat * 2 + rows * 4, 2 * mm),
        "flash_fwd_quant": (3 * mat * 1 + 3 * rows * 4 + mat * 2 + rows * 4, 2 * mm),
        "flash_dq": (5 * mat * 2 + 2 * rows * 4, 3 * mm),
        "flash_dkv": (6 * mat * 2 + 2 * rows * 4, 4 * mm),
    }


def flash_counts(steps, *, quant=False, remat=False, accum=1, evals=0, eval_batches=0):
    """The flash launches a kernel-route training run at LM_SHAPE must
    make: each micro-batch's forward launches the forward kernel once per
    layer, and once more when a checkpoint (--remat or --remat-attn)
    recomputes it in backward; its backward launches dq and dkv once per
    layer; an eval batch launches the forward alone."""
    layers = LM_SHAPE["n_layers"]
    fwd = layers * (steps * accum * (2 if remat else 1) + evals * eval_batches)
    bwd = layers * steps * accum
    return {"flash_fwd": 0 if quant else fwd, "flash_fwd_quant": fwd if quant else 0,
            "flash_dq": bwd, "flash_dkv": bwd}


def mma_counts(want):
    """The launches by route that a run at LM_SHAPE (D 64, the model's
    aligned projections) must make, from its `flash_counts`: every forward,
    quantized forward (int8 / fp8 codes of those projections), dq and dkv
    launch on the mma route, none on the simt route."""
    return {f"{k}_{r}": want[k] if r == "mma" else 0
            for k in ("flash_fwd", "flash_fwd_quant", "flash_dq", "flash_dkv")
            for r in ("mma", "simt")}


@contextmanager
def eager_lm(lmtrain):
    """`lm_train.main` inside runs its train step and eval eagerly on the
    card (their `_capture` hook), for the graphed path's eager twin."""
    make_step, make_eval = lmtrain.make_lm_train_step, lmtrain.make_eval_fn

    def eager(make):
        def made(*a, **kw):
            fn = make(*a, **kw)
            fn._capture = False
            return fn
        return made

    lmtrain.make_lm_train_step, lmtrain.make_eval_fn = eager(make_step), eager(make_eval)
    try:
        yield
    finally:
        lmtrain.make_lm_train_step, lmtrain.make_eval_fn = make_step, make_eval


def lm_run(torch, fa, lm_train, steps, extra, capture=True):
    """One `lm_train.main` run on the card at LM_ARGS + `extra`, the flash
    counters set to 0 just before it, its step replayed from a CUDA graph
    (or, `capture` false, run eagerly): its launches (and by route), logged
    losses {step: loss}, tokens/s, ms per step, MFU and peak memory."""
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    lines = []

    def log(line):
        if not line.startswith("step "):
            print("   " + line, flush=True)
        lines.append(line)

    for counters in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        for key in counters:
            counters[key] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (nullcontext() if capture else eager_lm(lmtrain)):
        rc = lm_train.main(["--device", "cuda", "--steps", str(steps), "--log-every",
                            str(LM_LOG_EVERY)] + LM_ARGS + extra, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = dict(fa.LAUNCHES), dict(fa.ROUTE_LAUNCHES)
    check(rc == 0, f"lm_train.main {extra} returned {rc}")
    summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
    # the step lines print 4 decimals; SUMMARY has the first and last loss in full
    losses = {int(l.split()[1]): float(l.split()[3]) for l in lines
              if l.startswith("step ") and l.split()[2] == "loss"}
    logged = sorted({i for i in range(steps) if i % LM_LOG_EVERY == 0} | {steps - 1})
    check(sorted(losses) == logged, f"{extra}: logged losses {losses}")
    losses.update({0: summary["first_loss"], steps - 1: summary["final_loss"]})
    check(all(math.isfinite(x) for x in losses.values()), f"{extra}: losses {losses}")
    first = next(l for l in lines if l.startswith("(first step"))
    return {"extra": extra, "steps": steps, "launches": counts, "routes": routes, "losses": losses,
            "wall_s": wall, "first_step_s": float(first.split(": ")[1].rstrip("s)")), "tokens_per_s": summary["tokens_per_s"],
            "mfu_pct": summary["mfu_pct"], "eval": summary["eval"],
            "ms_per_step": 1e3 * summary["wall_s_post_compile"] / (steps - 1),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def named_grads(params, grads):
    """{name: gradient} from `grads` in `tree_leaves` order; a stacked layer
    leaf (n_layers, ...) gives one entry per layer."""
    out, it = {}, iter(grads)
    for key in sorted(params):
        if isinstance(params[key], dict):
            for sub in sorted(params[key]):
                g = next(it)
                out.update({f"{key}.{sub}[{i}]": g[i] for i in range(g.shape[0])})
        else:
            out[key] = next(it)
    return out


ROUTES = {"plain": ("ring", ""), "flash": ("flash", ""), "int8": ("flash", "int8"),
          "fp8": ("flash", "fp8")}


@contextmanager
def pinned_routing(moe, chosen):
    """Inside, every `sort_route` call records its experts (T, k) into
    `chosen` (a list) or, once `chosen` holds a run's calls, takes them from
    it in call order: the gates and slots then follow from the probabilities
    of the run at hand (`route_coordinates`), so the gradients flow as
    usual, but no token is routed otherwise than in the recorded run."""
    sort_route, replay = moe.sort_route, bool(chosen)
    at = iter(list(chosen))

    def route(probs, top_k, capacity):
        if not replay:
            chosen.append(probs.topk(top_k, dim=-1, sorted=True).indices)
        experts = next(at) if replay else chosen[-1]
        return moe.route_coordinates(probs, probs.gather(1, experts), experts, capacity)

    moe.sort_route = route
    try:
        yield
    finally:
        moe.sort_route = sort_route


def route_grad_errs(torch, tfm, lmtrain, dev, routes=("flash", "int8", "fp8"), experts=0):
    """The relative L2 error of every weight's step-0 gradient (the flagship
    model and seed, the copy-task batch lm_train makes; with `experts`, its
    mixture of that many experts) on each kernel route of `routes` against
    the plain route: {route: {name: err}}. With experts, every route routes
    each token to the plain route's experts (`pinned_routing`; why:
    port_probes/moe_route_noise.py)."""
    from distributed_neural_network_tpu_torch.parallel import moe

    chosen = []
    sh = LM_SHAPE
    toks, tgts = lmtrain.make_copy_task(torch.Generator().manual_seed(1), batch=sh["batch_size"],
                                        seq_len=sh["seq_len"], vocab=sh["vocab"], device=dev)
    params = None
    grads = {}
    for route in ("plain",) + tuple(routes):
        attn, quant = ROUTES[route]
        cfg = tfm.TransformerConfig(vocab_size=sh["vocab"], d_model=sh["d_model"],
                                    n_heads=sh["n_heads"], n_layers=sh["n_layers"],
                                    d_ff=sh["d_ff"], dtype=torch.bfloat16, attn_quant=quant,
                                    n_experts=experts)
        if params is None:
            params = tfm.init_params(0, cfg, dev)
            leaves = lmtrain.tree_leaves(params)
            for x in leaves:
                x.requires_grad_(True)
        with pinned_routing(moe, chosen) if experts else nullcontext():
            loss = lmtrain.lm_loss(params, toks, tgts, cfg, attn_impl=attn)
            grads[route] = named_grads(params, torch.autograd.grad(loss, leaves))
    ref = grads.pop("plain")
    return {route: {name: float((g[name] - ref[name]).norm() / ref[name].norm().clamp_min(1e-30))
                    for name in ref} for route, g in grads.items()}


def route_compare(torch, fa, tfm, lmtrain, dev, kernel_rows, plain_row, experts=0):
    """The kernel routes (`kernel_rows`: {"flash" | "int8" | "fp8": an
    `lm_run` row}) against the plain route: the logged losses and the
    step-0 gradients (of the model with `experts` experts). Prints every
    reading before it gates any (LOSS_TOL, GRAD_TOL on every kernel
    route)."""
    d_loss = {route: max(abs(row["losses"][i] - plain_row["losses"][i])
                         for i in plain_row["losses"]) for route, row in kernel_rows.items()}
    with uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):  # not the main path's launches
        errs = route_grad_errs(torch, tfm, lmtrain, dev, tuple(kernel_rows), experts)
    worst = {route: max(e.items(), key=lambda kv: kv[1]) for route, e in errs.items()}
    print(f"   kernel routes vs plain route: logged losses (steps {sorted(plain_row['losses'])}) "
          f"max |difference| " + ", ".join(f"{r} {x:.6f}" for r, x in d_loss.items())
          + f" (tolerance {LOSS_TOL}); step-0 gradients, worst relative L2 error per route: "
          + ", ".join(f"{route} {err:.5f} ({name})" for route, (name, err) in worst.items())
          + f" (tolerance {GRAD_TOL})", flush=True)
    for route in errs:
        rows = sorted(errs[route].items(), key=lambda kv: -kv[1])[:4]
        print(f"   {route}: " + ", ".join(f"{name} {err:.5f}" for name, err in rows))
    out = {"loss_diff": d_loss, "grad_rel_err": {r: {"worst": n, "err": e}
                                                 for r, (n, e) in worst.items()}}
    for route, x in d_loss.items():
        check(x <= LOSS_TOL, f"{route} route's losses off the plain route by {x}")
    for route, (name, err) in worst.items():
        check(err <= GRAD_TOL,
              f"{route} route's gradient {name} off the plain route by relative {err}")
    return out


def route_check() -> int:
    """`python3 chip_smoke.py --route-check`: phase 13's kernel routes against
    the plain route alone (build, one flash, int8, fp8 and plain run of
    LM_STEPS steps each, the step-0 gradients), for showing that a copy of
    the repo with a fault planted in a kernel fails it. Exits 1 when a gate
    fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    fa.build()
    rows = {route: lm_run(torch, fa, lm_train, LM_STEPS, extra) for route, extra in (
        ("flash", ["--attn", "flash"]), ("int8", ["--attn", "flash", "--precision", "int8"]),
        ("fp8", ["--attn", "flash", "--precision", "fp8"]), ("plain", ["--attn", "ring"]))}
    plain = rows.pop("plain")
    try:
        route_compare(torch, fa, tfm, lmtrain, torch.device("cuda"), rows, plain)
    except SmokeFailure as e:
        print(f"route check FAILED: {e}")
        return 1
    print("route check passed")
    return 0


# ------------------------------------------------------------ graph helpers


# phase 20: request SAMPLED is sampled (temperature 0.8, seed 7); the engines
# are warmed up to WARM_WIDTH blocks, so widths 8 and 16 (prompts of 128 +
# 32 tokens need 10 blocks) are first met, and captured, mid-run
SAMPLED, WARM_WIDTH = 5, 4
# phase 20's LM cases: (name, layers, steps, options); depth cut to 2 layers
# for all but the first
LM_GRAPH_CASES = (
    ("flash bf16", LM_SHAPE["n_layers"], 3, {}),
    ("int8", 2, 4, {"quant": "int8"}),
    ("accum 2", 2, 4, {"accum_steps": 2}),
    ("adam cosine clip", 2, 4, {"optimizer": "adam", "lr": 0.01, "lr_schedule": "cosine",
                                "clip_norm": 0.5, "weight_decay": 0.01}),
)


def serve_engine(precision, impl, capture):
    """A full-width engine with phase 9's flags (no warmup, its scheduler
    loop closed: the caller steps it), captured or (`capture` false) eager
    on the card."""
    from distributed_neural_network_tpu_torch.serve.http import build_server

    args = [a for a in SERVE_ARGS if a != "--warmup"]
    srv, sched, eng = build_server(args + ["--precision", precision, "--decode-impl", impl],
                                   log=lambda line: None)
    sched.close(finalize=False)
    srv.close()
    eng._capture = capture
    return eng


def scripted_serve(torch, eng, prompts):
    """Phase 20's ticks: warmup up to WARM_WIDTH blocks, then the prompts
    admitted in order as slots and blocks allow (request SAMPLED sampled),
    preempted ones first, stepped to the end. Returns the streams, the
    ticks, their wall time, warmup's time and the programs built after it
    (buckets first met mid-run), the pools' state and the device memory the
    warmup reserved."""
    from collections import deque

    from distributed_neural_network_tpu_torch.serve.engine import Sequence

    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng.warmup(max_width_blocks=WARM_WIDTH)
    warm_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved() - reserved
    warm = eng.compiled_programs()["total"]
    seqs = [Sequence(i, p, MAX_NEW, temperature=0.8 if i == SAMPLED else 0.0, seed=7)
            for i, p in enumerate(prompts)]
    queue, ticks = deque(seqs), 0
    kv, cap = eng.kv, eng.ecfg.max_batch
    t0 = time.perf_counter()
    while queue or eng.has_work() or eng.preempted:
        for waiting in (eng.preempted, queue):
            while (waiting and len(eng.active) < cap
                   and kv.can_fit(waiting[0].prompt_len + 1)):
                eng.add(waiting.popleft())
        eng.step()
        ticks += 1
        check(ticks < 5000, "phase 20's tick script did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    state = [t.clone() for t in (eng.k_pool, eng.v_pool, eng.k_scale, eng.v_scale)
             if t is not None]
    graphs = [b.program.graph is not None for fam in eng._programs.values()
              for b in fam.values()]
    return {"streams": [s.out for s in seqs], "ticks": ticks, "wall_s": wall,
            "warmup_s": warm_s, "warmup_reserved_bytes": reserved,
            "mid_run_programs": eng.compiled_programs()["total"] - warm,
            "programs": eng.compiled_programs(), "all_graphed": all(graphs),
            "none_graphed": not any(graphs), "state": state}


def serve_graphs_vs_eager(torch, prompts):
    """Phase 20 for serving: for bf16 and int8-kv on both decode routes,
    the same tick script on an eager engine and on a graphed one: tokens and
    pools (and scales) bitwise, every bucket of the graphed engine captured
    (some mid-run) and none of the eager one's. Returns one row per case."""
    rows = []
    for precision in ("bf16", "int8-kv"):
        for impl in ("cuda", "torch"):
            runs = {}
            for mode in ("eager", "graphed"):
                eng = serve_engine(precision, impl, mode == "graphed")
                runs[mode] = scripted_serve(torch, eng, prompts)
                del eng
            e, g = runs["eager"], runs["graphed"]
            same_tokens = e["streams"] == g["streams"]
            same_pools = len(e["state"]) == len(g["state"]) and all(
                torch.equal(a, b) for a, b in zip(e["state"], g["state"]))
            row = {"precision": precision, "decode_impl": impl, "tokens_bitwise": same_tokens,
                   "pools_bitwise": same_pools, "ticks": g["ticks"],
                   "mid_run_programs": g["mid_run_programs"], "programs": g["programs"],
                   **{f"{m}_{k}": runs[m][k] for m in runs
                      for k in ("wall_s", "warmup_s", "warmup_reserved_bytes")}}
            rows.append(row)
            print(f"   serving {precision:7s} {impl:5s}: {g['ticks']} ticks, tokens bitwise "
                  f"{same_tokens}, pools bitwise {same_pools}; {g['mid_run_programs']} buckets "
                  f"first met mid-run, programs {g['programs']}; ms per tick graphed "
                  f"{1e3 * g['wall_s'] / g['ticks']:.3f}, eager {1e3 * e['wall_s'] / e['ticks']:.3f}"
                  f"; warmup graphed {g['warmup_s']:.2f} s ({g['warmup_reserved_bytes']} B "
                  f"reserved), eager {e['warmup_s']:.2f} s", flush=True)
            check(same_tokens and same_pools,
                  f"serving {precision} {impl}: the graphed engine differs from the eager one "
                  f"(tokens {same_tokens}, pools {same_pools})")
            check(g["all_graphed"] and e["none_graphed"] and g["mid_run_programs"] > 0,
                  f"serving {precision} {impl}: graphed {g['all_graphed']}, eager none "
                  f"{e['none_graphed']}, buckets met mid-run {g['mid_run_programs']}")
            check(e["ticks"] == g["ticks"] and e["programs"] == g["programs"],
                  f"serving {precision} {impl}: ticks or programs differ")
    return rows


def lm_graphs_vs_eager(torch, name, n_layers, steps, opts):
    """Phase 20 for one LM case: `steps` steps at LM_SHAPE's width (depth
    `n_layers`) from the same init and batches, eagerly and graphed, then
    the eval loss of two batches: losses, eval losses, parameters and
    optimizer state bitwise. Returns the case's row (first-step and
    steady times of each mode, the graph's reserved memory)."""
    import functools

    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.ops.schedule import warmup_cosine
    from distributed_neural_network_tpu_torch.train import lm as lmtrain

    sh, dev = LM_SHAPE, torch.device("cuda")
    opts = dict(opts)
    quant = opts.pop("quant", "")
    experts = opts.pop("experts", 0)
    if opts.get("lr_schedule") == "cosine":
        opts["lr_schedule"] = functools.partial(warmup_cosine, base_lr=opts["lr"],
                                                total_steps=steps, warmup_steps=1,
                                                min_lr_frac=0.1)
    opts.setdefault("lr", 0.01)
    cfg = tfm.TransformerConfig(vocab_size=sh["vocab"], d_model=sh["d_model"],
                                n_heads=sh["n_heads"], n_layers=n_layers, d_ff=sh["d_ff"],
                                dtype=torch.bfloat16, attn_quant=quant, n_experts=experts)
    g = torch.Generator().manual_seed(20)
    batches = [lmtrain.make_copy_task(g, batch=sh["batch_size"], seq_len=sh["seq_len"],
                                      vocab=sh["vocab"], device=dev) for _ in range(steps)]
    runs = {}
    for mode in ("eager", "graphed"):
        params = tfm.init_params(0, cfg, dev)
        mom = lmtrain.init_lm_momentum(params, opts.get("optimizer", "sgd"))
        step = lmtrain.make_lm_train_step(cfg, device=dev, attn_impl="flash", momentum=0.9,
                                          **opts)
        ev = lmtrain.make_eval_fn(cfg, attn_impl="flash")
        step._capture = ev._capture = mode == "graphed"
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        losses = [step(params, mom, *batches[0], 0)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses += [step(params, mom, *batches[i], i) for i in range(1, steps)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        evals = [ev(params, *b) for b in batches[:2]]
        moments = mom if isinstance(mom, list) else mom["m"] + mom["v"]
        runs[mode] = {"losses": torch.stack(losses), "evals": torch.stack(evals),
                      "state": [t.detach().clone() for t in lmtrain.tree_leaves(params) + moments],
                      "first_s": t1 - t0, "ms_per_step": 1e3 * (t2 - t1) / (steps - 1),
                      "reserved_bytes": torch.cuda.memory_reserved() - reserved,
                      "graphed": step.program.graph is not None and ev.program.graph is not None,
                      "eager": step.program.graph is None and ev.program.graph is None}
        del params, mom, step, ev, moments
    e, gr = runs["eager"], runs["graphed"]
    same = {"losses": torch.equal(e["losses"], gr["losses"]),
            "evals": torch.equal(e["evals"], gr["evals"]),
            "state": all(torch.equal(a, b) for a, b in zip(e["state"], gr["state"]))}
    row = {"case": name, "layers": n_layers, "steps": steps, "bitwise": same,
           "losses": gr["losses"].tolist(), "eager_losses": e["losses"].tolist(),
           **{f"{m}_{k}": runs[m][k] for m in runs
              for k in ("first_s", "ms_per_step", "reserved_bytes")}}
    print(f"   LM {name} (L{n_layers}, {steps} steps): bitwise {same}; losses "
          f"{[round(x, 6) for x in row['losses']]}; first step graphed {gr['first_s']:.2f} s "
          f"(capture incl.), eager {e['first_s']:.2f} s; ms per later step graphed "
          f"{gr['ms_per_step']:.2f}, eager {e['ms_per_step']:.2f}; graphed step's reserved "
          f"memory {gr['reserved_bytes']} B", flush=True)
    check(all(same.values()), f"LM {name}: the graphed step differs from the eager one: {same}")
    check(gr["graphed"] and e["eager"], f"LM {name}: captured {gr['graphed']}, eager "
          f"{e['eager']}")
    torch.cuda.empty_cache()
    return row


# phase 28's profile: kernel-name substrings -> group, a kernel in the first
# group it matches (the rest: elementwise chains, reductions, copies, the
# loss)
MOE_KERNEL_GROUPS = {
    "routing (top-k, scan)": ("topk", "TopK", "scan", "radix", "bitonic"),
    "index_add (dispatch; combine backward)": ("indexFunc",),
    "gather (combine; dispatch backward)": ("indexSelect", "gather"),
    "matmuls (cuBLAS)": ("nvjet", "gemm", "cutlass", "sm90_"),
    "flash kernels": ("flash_",),
}


def moe_step_profile(torch, tfm, lmtrain, dev) -> dict:
    """One eager step of the flagship row with MOE_EXPERTS experts (flash)
    under torch.profiler, after a warm-up step: the device time of its
    kernels, by MOE_KERNEL_GROUPS and the top kernels (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sh = LM_SHAPE
    cfg = tfm.TransformerConfig(vocab_size=sh["vocab"], d_model=sh["d_model"],
                                n_heads=sh["n_heads"], n_layers=sh["n_layers"], d_ff=sh["d_ff"],
                                dtype=torch.bfloat16, n_experts=MOE_EXPERTS)
    params = tfm.init_params(0, cfg, dev)
    mom = lmtrain.init_lm_momentum(params)
    step = lmtrain.make_lm_train_step(cfg, device=dev, attn_impl="flash", lr=0.01)
    step._capture = False
    toks, tgts = lmtrain.make_copy_task(torch.Generator().manual_seed(1), batch=sh["batch_size"],
                                        seq_len=sh["seq_len"], vocab=sh["vocab"], device=dev)
    step(params, mom, toks, tgts, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, mom, toks, tgts, 1)
        torch.cuda.synchronize()
    rows = sorted(profile_rows(prof, DeviceType), key=lambda r: -r[1])
    total = sum(r[1] for r in rows) / 1e3
    groups = dict.fromkeys(MOE_KERNEL_GROUPS, 0.0)
    for name, us, _ in rows:
        g = next((g for g, keys in MOE_KERNEL_GROUPS.items() if any(k in name for k in keys)),
                 None)
        if g is not None:
            groups[g] += us / 1e3
    del step, params, mom
    torch.cuda.empty_cache()
    return {"device_ms": total, "groups_ms": groups,
            "top": [(name[:120], us / 1e3, n) for name, us, n in rows[:16]]}


def moe_phase(torch, fa, da, kernels, dev, ranks_c) -> dict:
    """Phase 28 (module docstring): the MoE path's runs and gates; adds the
    MoE path's launches to `kernels` and returns what it measured. `ranks_c`:
    (c)'s ranks' records, its one-process reference and that reference's
    seconds (the ranks run in phase 21's launch)."""
    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.models import transformer as tfm
    from distributed_neural_network_tpu_torch.parallel.moe import expert_capacity, moe_ffn
    from distributed_neural_network_tpu_torch.train import lm as lmtrain
    from port_probes import moe_world as MW

    moe_run, part_s, t_part = {}, {}, time.perf_counter()
    # (a) the flagship row with 8 experts at the JAX defaults, one process,
    # graphed: the kernel route (flash) and the plain route (--attn ring)
    moe_rows = {}
    for name, attn in (("flash", "flash"), ("plain", "ring")):
        row = lm_run(torch, fa, lm_train, MOE_STEPS, ["--attn", attn] + MOE_ARGS)
        moe_rows[name] = row
        counts = row["launches"]
        print(f"   MoE {name}: {row['tokens_per_s']} tokens/s, {row['ms_per_step']:.2f} ms per "
              f"step (first step {row['first_step_s']:.2f} s), MFU {row['mfu_pct']}% of the "
              f"bf16 dense peak (top-2 experts counted), losses {row['losses']}, peak memory "
              f"{row['peak_mem_gib']:.2f} GiB, flash launches a step "
              f"{ {k: v / MOE_STEPS for k, v in counts.items()} }, by route "
              f"{row['routes']}", flush=True)
        want = (flash_counts(MOE_STEPS) if name == "flash"
                else dict.fromkeys(counts, 0))
        check(counts == want, f"MoE {name}: flash launches {counts} != expected {want}")
        check(row["routes"] == mma_counts(want),
              f"MoE {name}: launches by route {row['routes']} != {mma_counts(want)}")
    for key in ("flash_fwd", "flash_dq", "flash_dkv"):
        kernels[key]["launches_moe"] = moe_rows["flash"]["launches"][key]
    moe_run["runs"] = moe_rows
    moe_run["route"] = route_compare(torch, fa, tfm, lmtrain, dev, {"flash": moe_rows["flash"]},
                                     moe_rows["plain"], experts=MOE_EXPERTS)
    with uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        moe_run["graphs"] = lm_graphs_vs_eager(torch, "MoE", LM_SHAPE["n_layers"], 3,
                                               {"experts": MOE_EXPERTS})
        prof = moe_run["profile"] = moe_step_profile(torch, tfm, lmtrain, dev)
    print(f"   one eager MoE flash step under the profiler: {prof['device_ms']:.2f} ms of kernels; "
          f"by group (ms) { {g: round(v, 3) for g, v in prof['groups_ms'].items()} }; top kernels "
          f"{[(n[:90], round(ms, 3), c) for n, ms, c in prof['top']]}", flush=True)
    part_s["a"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (b) the two dispatch forms on the card, f32 at T 64 (full-width
    # d, d_ff and experts), at the no-drop capacity and at a binding one
    g = torch.Generator().manual_seed(28)
    t_, d_, f_ = 64, LM_SHAPE["d_model"], LM_SHAPE["d_ff"]
    shapes = ((t_, d_), (d_, MOE_EXPERTS), (MOE_EXPERTS, d_, f_), (MOE_EXPERTS, f_),
              (MOE_EXPERTS, f_, d_), (MOE_EXPERTS, d_), (t_, d_))
    scales = (1.0, d_ ** -0.5, d_ ** -0.5, 0.1, f_ ** -0.5, 0.1, 1.0)
    base = [(torch.randn(sh, generator=g) * k).to(dev) for sh, k in zip(shapes, scales)]
    w_out = base.pop()
    moe_run["dispatch"] = {}
    for cap in (expert_capacity(t_, MOE_EXPERTS, 2, 2.0), 4):
        got = {}
        for impl in ("sort", "dense"):
            ins = [t.clone().requires_grad_() for t in base]
            y, aux = moe_ffn(*ins, top_k=2, capacity=cap, dispatch_impl=impl,
                             z_loss_weight=0.1)
            ((y * w_out).sum() + aux).backward()
            got[impl] = (y.detach(), aux.detach(), [t.grad for t in ins])
        (ys, auxs, gs), (yd, auxd, gd) = got["sort"], got["dense"]
        err_y = max(max_err(torch, ys, yd), abs(float(auxs - auxd)))
        err_g = max(float(((a - b).abs() / (b.abs() + 1.0)).max()) for a, b in zip(gs, gd))
        moe_run["dispatch"][cap] = {"out": err_y, "grads": err_g}
        print(f"   moe_ffn sort against dense at T {t_}, capacity {cap}: output and aux max "
              f"abs err {err_y:.3e} (tolerance 1e-5), gradients max err {err_g:.3e} "
              f"(|a - b| / (|b| + 1); tolerance 2e-4)", flush=True)
        check(err_y <= 1e-5, f"moe_ffn sort vs dense at capacity {cap}: output {err_y}")
        check(err_g <= 2e-4, f"moe_ffn sort vs dense at capacity {cap}: gradients {err_g}")
    part_s["b"], t_part = time.perf_counter() - t_part, time.perf_counter()

    # (c) --dp 2 (ep 2) on 2 ranks sharing the card over gloo, depth 2: the
    # ranks ran in phase 21's launch
    ranks, ref, ref_s = ranks_c
    moe_run["ranks"] = MW.check(2, ranks, ref, LM_ARGS, mma_counts=mma_counts)
    moe_run["seconds"] = {"one_process": ref_s}
    for name, row in moe_run["ranks"].items():
        coll = row["collective_ms"]
        print(f"   {name} (2 layers): {row['ms_per_step']:.2f} ms per step, "
              f"{row['tokens_per_s']} tokens/s; losses {[round(x, 5) for x in row['losses']]}, "
              f"max relative difference from one process {row['max_rel_vs_one_process']:.2e}; "
              f"parameter update within {row['update_rel_max']:.2e} of one process's (worst "
              f"leaf {row['update_rel_leaf']}; expert leaves "
              f"{ {k: round(v, 4) for k, v in row['update_rel_experts'].items()} }); the "
              f"ranks' SUMMARY lines and gathered parameters equal; the collectives alone per "
              f"step (ms, each rank): gradient sync {[fmt(c['sync']) for c in coll]}, "
              f"all-to-alls {[fmt(c['all_to_all']) for c in coll]}; segments: "
              f"{row['segments']}; one process {ref_s:.1f} s, 2 ranks in phase 21's launch",
              flush=True)

    # (d) MoE generate (the dense dispatch at a capacity of the batch) on
    # the decode kernel's route, against decode_impl="torch"
    cfg_moe = tfm.TransformerConfig(vocab_size=LM_SHAPE["vocab"], d_model=LM_SHAPE["d_model"],
                                    n_heads=LM_SHAPE["n_heads"],
                                    n_layers=LM_SHAPE["n_layers"], d_ff=LM_SHAPE["d_ff"],
                                    dtype=torch.bfloat16, n_experts=MOE_EXPERTS)
    part_s["c"], t_part = time.perf_counter() - t_part, time.perf_counter()
    ptoks, _ = lmtrain.make_copy_task(torch.Generator().manual_seed(28), batch=16,
                                      seq_len=64, vocab=LM_SHAPE["vocab"])
    for counters in (da.LAUNCHES, da.ROUTE_LAUNCHES):
        for key in counters:
            counters[key] = 0
    oracle = Oracle(torch, tfm, ptoks.tolist(), dev, cfg=cfg_moe)
    launches, routes = dict(da.LAUNCHES), dict(da.ROUTE_LAUNCHES)
    want = (64 + MAX_NEW - 1) * LM_SHAPE["n_layers"]  # one launch a layer and position
    with uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
        per_token, _, zipped = oracle.agreement(oracle.routes["cuda"], impl="torch")
    kernels["decode_attention"]["launches_moe"] = launches["decode_attention"]
    moe_run["generate"] = {"per_token": per_token, "zipped": zipped, "launches": launches,
                           "routes": routes}
    print(f"   MoE generate (16 prompts of 64 tokens, {MAX_NEW} new, greedy): the decode "
          f"kernel's stream against decode_impl='torch' per token {per_token:.4f} (gate "
          f">= 0.99), zipped {zipped:.4f}; decode launches {launches} (formula {want}), by "
          f"route {routes}", flush=True)
    check(launches["decode_attention"] == want and launches["decode_attention_q8"] == 0,
          f"MoE generate: decode launches {launches} != {want}")
    check(routes.get("decode_attention_split") == want,
          f"MoE generate: launches by route {routes}")
    check(per_token >= 0.99, f"MoE generate: per-token agreement {per_token} < 0.99")
    part_s["d"] = time.perf_counter() - t_part
    moe_run["part_s"] = part_s
    print(f"   seconds by part: {part_s}")
    return moe_run


# ------------------------------------------------------------ phase 29 helpers


def _tool(*argv) -> subprocess.CompletedProcess:
    """One of the repo's stdlib tools (tools/*.py) on a file of this run."""
    return subprocess.run([sys.executable, os.path.join(ROOT, "tools", argv[0]), *argv[1:]],
                          capture_output=True, text=True, timeout=120)


def _read_record(record, what):
    """A run record through the readers of `utils/goodput.py` (the port's
    copy of those tools/goodput.py uses; the tool imports the JAX package,
    so it needs flax, which the card's machine lacks): validated and
    rendered. Its buckets sum to its wall: `GoodputLedger.finalize` asserts
    that before it writes."""
    from distributed_neural_network_tpu_torch.utils import goodput as gp

    rec = gp.read_record(record)
    check(bool(gp.render_record(rec)), f"{what}: the run record does not read back")
    return rec


def _telemetry_check(trace, record, what):
    """A trace read by tools/trace_summary.py with rc 0 and a run record
    read back (`_read_record`) whose compile bucket (the kernels' build and
    the graphs' capture) is not empty."""
    proc = _tool("trace_summary.py", trace)
    check(proc.returncode == 0, f"{what}: tools/trace_summary.py exited {proc.returncode}: "
          f"{proc.stderr[-1500:]}")
    rec = _read_record(record, what)
    check(rec["final"] and rec["badput_s"]["compile"] > 0,
          f"{what}: no compile time in the run record")
    return rec


def resume_phase(torch, fa, fh, da, kernels, dev) -> dict:
    """Phase 29 (module docstring): checkpoint, exact resume, SIGTERM,
    telemetry and two ranks; adds the resumed paths' launches to `kernels`
    and returns what it measured."""
    import gc
    import signal

    import numpy as np

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.serve.http import build_server, shutdown
    from distributed_neural_network_tpu_torch.train import cli
    from port_probes import ckpt_world as CW

    out = os.path.join(ROOT, "chiprun_out", "resume")
    ck = os.path.join(ROOT, "runs", "resume_ckpt")  # gigabytes: removed below
    shutil.rmtree(ck, ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    res, part_s, t_part = {}, {}, time.perf_counter()

    def same_checkpoint(a, b):
        """Two checkpoints' leaves equal bit for bit and their meta equal."""
        metas = []
        for d in (a, b):
            with open(os.path.join(d, "meta.json")) as f:
                metas.append(json.load(f))
        return CW._same_checkpoint(a, b) and metas[0] == metas[1]

    try:
        # (a) the CNN at full width, fused, with a fault mask: 4 epochs
        # against 2 and a resume to 4
        def cnn(name, epochs, *extra):
            lines = []
            for k in fh.LAUNCHES:
                fh.LAUNCHES[k] = 0
            rc = cli.main(CNN_RESUME + ["--epochs", str(epochs), "--log-dir",
                                        os.path.join(out, "log"), "--checkpoint-dir",
                                        os.path.join(ck, name), *extra], log=lines.append)
            check(rc == 0, f"29(a) {name}: cli.main returned {rc}")
            return ([l for l in lines if l.startswith(("Global", "Validation"))], lines,
                    dict(fh.LAUNCHES))

        trace_a, rec_a = os.path.join(out, "cnn_trace.json"), os.path.join(out, "cnn_record.json")
        whole, _, _ = cnn("cnn_whole", 4)
        first, lines_b, _ = cnn("cnn_resumed", 2, "--trace-out", trace_a, "--step-stats",
                                "--run-record", rec_a)
        rest, lines_c, launches_c = cnn("cnn_resumed", 4, "--resume")
        check(first + rest == whole, f"29(a): the resumed CNN's metrics differ: {first + rest} "
              f"/ {whole}")
        check(same_checkpoint(*(os.path.join(ck, n, "step_3") for n in ("cnn_whole",
                                                                         "cnn_resumed"))),
              "29(a): the resumed CNN's params, momentum or history differ")
        want = head_launches(16, 2)
        check(launches_c == want, f"29(a): the resumed run's launches {launches_c} != {want}")
        # phase 32(c) resumes this 4-worker checkpoint at 2 workers
        shutil.rmtree(ELASTIC_CNN, ignore_errors=True)
        shutil.copytree(os.path.join(ck, "cnn_resumed"), ELASTIC_CNN)
        for name, count in launches_c.items():
            kernels[name]["launches_resume"] = count
        rec = _telemetry_check(trace_a, rec_a, "29(a)")
        restored = next(l for l in lines_c if l.startswith("(Resumed from checkpoint"))
        saved = next(l for l in lines_b if l.startswith("(Last checkpoint"))
        res["cnn"] = {"bitwise": True, "launches_resumed": launches_c,
                      "restore": restored, "save": saved,
                      "save_events": rec["events"].get("checkpoint_save"),
                      "record_badput": rec["badput_s"], "goodput_ratio": rec["goodput_ratio"],
                      "step_stats": [l for l in lines_b if l.startswith("  ")]}
        print(f"   (a) CNN, 4 epochs against 2 + --resume to 4 (50,000 rows, --fused, "
              f"--failure-probability 0.5): per-epoch metrics, params and momentum bitwise; "
              f"the resumed run's head launches {launches_c}; {saved}; {restored}; "
              f"checkpoint_save events {rec['events'].get('checkpoint_save')}")
        part_s["a"] = time.perf_counter() - t_part

        # (b) the flagship LM row, flash, Adam, cosine, graphed: 6 steps
        # against 3 and a resume to 6; (d) the same 6 steps traced
        def lm(name, *extra):
            lines, result = [], {}
            for c in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
                c.update(dict.fromkeys(c, 0))
            rc = lm_train.main(["--device", "cuda", "--steps", str(CW.STEPS), "--log-every", "1",
                                *LM_ARGS, *LM_RESUME, *extra], log=lines.append, result=result)
            check(rc == 0, f"29 {name}: lm_train.main returned {rc}")
            summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
            row = {"losses": result["losses"], "launches": dict(fa.LAUNCHES),
                   "routes": dict(fa.ROUTE_LAUNCHES), "summary": summary, "lines": lines,
                   "checkpoint": result["checkpoint"], "segments": result["step"].segments,
                   "state": [x.detach().clone() for x in (
                       *lm_tree(result["params"]), *result["mom"]["m"], *result["mom"]["v"])],
                   "t": result["mom"]["t"]}
            row["ms_per_step"] = 1e3 * summary["wall_s_post_compile"] / max(
                summary["last_step"] - summary["start_step"], 1)
            del result
            gc.collect()
            torch.cuda.empty_cache()
            return row

        def lm_tree(params):
            from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

            return tree_leaves(params)

        def same_state(a, b):
            return a["t"] == b["t"] and all(torch.equal(x, y) for x, y in zip(a["state"],
                                                                               b["state"]))

        def launches_ok(row, steps, what):
            want = flash_counts(steps)
            check(row["launches"] == want and row["routes"] == mma_counts(want),
                  f"{what}: flash launches {row['launches']} / {row['routes']}, want {want}")

        trace_t = os.path.join(out, "lm_trace.json")
        rec_t = os.path.join(out, "lm_record.json")
        rows = {"whole": lm("whole")}
        rows["traced"] = lm("traced", "--trace-out", trace_t, "--step-stats", "--run-record",
                            rec_t)
        rows["stopped"] = lm("stopped", "--checkpoint-dir", os.path.join(ck, "lm"),
                             "--stop-at-step", str(CW.STOP))
        rows["resumed"] = lm("resumed", "--checkpoint-dir", os.path.join(ck, "lm"), "--resume",
                             "--stop-at-step", str(CW.STEPS))
        whole_l = rows["whole"]["losses"]
        check(rows["traced"]["losses"] == whole_l and same_state(rows["traced"], rows["whole"]),
              "29(d): the traced LM run differs from the untraced one")
        check(rows["stopped"]["losses"] == whole_l[:CW.STOP]
              and rows["resumed"]["losses"] == whole_l[CW.STOP:],
              f"29(b): losses {rows['stopped']['losses']} + {rows['resumed']['losses']} / "
              f"{whole_l}")
        check(same_state(rows["resumed"], rows["whole"]),
              "29(b): the resumed LM's params or Adam state differ")
        check(rows["resumed"]["segments"] == "graph", f"29(b): the resumed step is "
              f"{rows['resumed']['segments']}")
        for name, steps in (("whole", CW.STEPS), ("traced", CW.STEPS), ("stopped", CW.STOP),
                            ("resumed", CW.STEPS - CW.STOP)):
            launches_ok(rows[name], steps, f"29(b) {name}")
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels[name]["launches_resume"] = rows["resumed"]["launches"][name]
        rec = _telemetry_check(trace_t, rec_t, "29(d) LM")
        res["lm"] = {"losses": whole_l, "bitwise": True,
                     "save": rows["stopped"]["checkpoint"]["save"],
                     "restore": rows["resumed"]["checkpoint"]["restore"],
                     "ms_per_step": {k: rows[k]["ms_per_step"] for k in ("whole", "traced")},
                     "record_badput": rec["badput_s"], "goodput_ratio": rec["goodput_ratio"],
                     "launches_resumed": rows["resumed"]["launches"]}
        sv, rs = res["lm"]["save"], res["lm"]["restore"]
        print(f"   (b) LM flagship row, flash, Adam, cosine, graphed: 6 steps against 3 + "
              f"--resume to 6: losses, params and Adam state bitwise, the resumed step one "
              f"graph; flash launches at the formula of the steps run, all mma (resumed "
              f"{rows['resumed']['launches']}); checkpoint save {sv[1]:,} B in {sv[0]:.3f} s, "
              f"restore {rs[1]:,} B in {rs[0]:.3f} s")
        print(f"   (d) LM tracer off / on (--trace-out --step-stats --run-record), same call: "
              f"{rows['whole']['ms_per_step']:.2f} / {rows['traced']['ms_per_step']:.2f} ms per "
              f"step; the traced run bitwise the untraced one; its record: goodput ratio "
              f"{rec['goodput_ratio']}, badput {rec['badput_s']}")
        part_s["b+d"] = time.perf_counter() - t_part - sum(part_s.values())

        # (c) a real SIGTERM to this process after step 2, delivered by the
        # entry point's chaos monkey (--chaos-sigterm-after): the flag is read
        # at the next step's launch, so the emergency checkpoint is at step 3
        cdir = os.path.join(ck, "sigterm")
        handler = signal.getsignal(signal.SIGTERM)
        row = lm("sigterm", "--checkpoint-dir", cdir, "--chaos-sigterm-after", "2")
        lines, summary = row["lines"], row["summary"]
        with open(os.path.join(out, "sigterm.log"), "w") as f:
            f.write("\n".join(lines))
        check(signal.getsignal(signal.SIGTERM) is handler, "29(c): the handler was not put back")
        stop = summary["last_step"]
        check(summary["preempted"] and stop == 3 and "(chaos: delivering SIGTERM after step 2)"
              in lines and any(l.startswith(f"(emergency checkpoint at step {stop}")
                               for l in lines),
              f"29(c): no emergency checkpoint: {summary}")
        check(row["losses"] == whole_l[:stop + 1], f"29(c): losses {row['losses']} / {whole_l}")
        row = lm("sigterm-resumed", "--checkpoint-dir", cdir, "--resume", "--stop-at-step",
                 str(CW.STEPS))
        check(row["losses"] == whole_l[stop + 1:] and same_state(row, rows["whole"]),
              f"29(c): the resume after SIGTERM differs: {row['losses']} / {whole_l}")
        launches_ok(row, CW.STEPS - stop - 1, "29(c) resumed")
        res["sigterm"] = {"stopped_after": stop, "bitwise": True}
        print(f"   (c) SIGTERM to this process after step 2 (--chaos-sigterm-after 2): emergency "
              f"checkpoint at step {stop}, a clean return; the resume from it bitwise the "
              f"uninterrupted run")
        del rows, row
        gc.collect()
        torch.cuda.empty_cache()
        part_s["c"] = time.perf_counter() - t_part - sum(part_s.values())

        # (d) serving with --trace-out: a few requests through the decode kernel
        trace_s = os.path.join(out, "serve_trace.json")
        for c in (da.LAUNCHES, da.ROUTE_LAUNCHES):
            c.update(dict.fromkeys(c, 0))
        srv, sched, _ = build_server(SERVE_ARGS + ["--precision", "bf16", "--decode-impl",
                                                   "cuda", "--trace-out", trace_s],
                                     log=lambda line: None)
        rng = np.random.default_rng(29)
        try:
            results = open_loop(srv.port, [rng.integers(0, 256, size=n).tolist()
                                           for n in (16, 64, 128, 16)], [0.0, 0.05, 0.1, 0.15])
        finally:
            record = shutdown(srv, sched)
        check(all(r["status"] == 200 and len(r["tokens"]) == MAX_NEW for r in results),
              "29(d) serving: a request failed")
        with open(trace_s) as f:
            doc = json.load(f)
        rec_s = os.path.join(out, "serve_record.json")
        with open(rec_s, "w") as f:
            json.dump(doc["goodput"], f)
        proc = _tool("trace_summary.py", trace_s)
        check(proc.returncode == 0, f"29(d) serving: tools/trace_summary.py: "
              f"{proc.stderr[-1500:]}")
        _read_record(rec_s, "29(d) serving")
        lanes = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
        decode = dict(da.LAUNCHES)
        check(decode["decode_attention"] > 0 and record["taxonomy"] == "serve",
              f"29(d) serving: decode launches {decode}")
        kernels["decode_attention"]["launches_resume"] = decode["decode_attention"]
        res["serve"] = {"lanes": sorted(lanes), "decode_launches": decode,
                        "goodput_ratio": record["goodput_ratio"]}
        print(f"   (d) serving, 4 requests under --trace-out: {len(lanes)} request lanes, the "
              f"serve record embedded (goodput ratio {record['goodput_ratio']}), the trace read "
              f"by tools/trace_summary.py, the record read back; decode launches {decode}")
        part_s["d serve"] = time.perf_counter() - t_part - sum(part_s.values())

        # (e) two ranks on the one card over gloo, --dp 2, through
        # port_probes/ckpt_world.py's flow, at depth 2 (cut from 8: every
        # collective crosses host memory); its runs were made by phase 21's
        # launch of the ranks (a fresh rank process costs seconds)
        wout = RESUME_WORLD_OUT
        depth = LM_SHAPE["n_layers"] // RESUME_WORLD_LAYERS
        if os.path.exists(os.path.join(wout, "rank1.json")):
            ranks = CW.read_ranks(2, wout)
        else:  # phase 29 alone (--resume-check): its own launch
            ranks = CW.run_world(2, wout, LM_ARGS + ["--n-layers", str(RESUME_WORLD_LAYERS)],
                                 CW.RUNS[2], timeout=600)
        world = CW.check(ranks, CW.RUNS[2], wout, launches=lambda name, steps: {
            k: v // depth for k, v in flash_counts(steps).items()})
        for name in world:
            shutil.copy(os.path.join(wout, f"{name}_trace_merged.json"), out)
        res["world2"] = world
        row = world["dp2"]
        print(f"   (e) --dp 2 on 2 ranks sharing the card (gloo), {RESUME_WORLD_LAYERS} layers: "
              f"the resume bitwise the "
              f"uninterrupted run on both ranks; save (s, B) per rank {row['save']}, restore "
              f"{row['restore']}; the ranks' trace shards merged; segments "
              f"{row['segments_resumed']}")
        part_s["e"] = time.perf_counter() - t_part - sum(part_s.values())
    finally:
        shutil.rmtree(ck, ignore_errors=True)
        shutil.rmtree(RESUME_WORLD_OUT, ignore_errors=True)
    res["seconds"] = part_s
    print(f"   parts (s): {json.dumps({k: round(v, 1) for k, v in part_s.items()})}")
    return res


def resume_check() -> int:
    """`python3 chip_smoke.py --resume-check`: phase 29 alone (after the
    kernels' build), for iterating on it; exits 1 when a gate fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import decode_attention as da
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    for m in (fh, da, fa):
        m.build()
    kernels = {k: {} for k in ("fused_mlp3_fwd", "fused_mlp3_bwd", "fused_mlp3_bwd_reduce",
                               "flash_fwd", "flash_dq", "flash_dkv", "decode_attention")}
    try:
        res = resume_phase(torch, fa, fh, da, kernels, torch.device("cuda"))
    except SmokeFailure as e:
        print(f"resume check FAILED: {e}")
        return 1
    print(json.dumps({"kernels": kernels, "seconds": res["seconds"]}))
    print("resume check passed")
    return 0


# ------------------------------------------------------------ phase 30 helpers


class _SpikedGuard:
    """A `train/guard.py` TrainingGuard whose observed loss at `epoch` is
    multiplied by `scale` once (the ChaosMonkey.perturb pattern), keeping a
    copy of every snapshot it takes."""

    def __init__(self, guard, epoch, scale=100.0):
        self.guard, self.epoch, self.scale, self.fired = guard, epoch, scale, False
        self.snapshots = []

    def observe(self, step, loss, **kw):
        if step == self.epoch and not self.fired:
            self.fired = True
            loss = loss * self.scale
        return self.guard.observe(step, loss, **kw)

    def maybe_snapshot(self, step, state, **kw):
        taken = self.guard.maybe_snapshot(step, state, **kw)
        if taken:
            snap_step, tree = self.guard.peek_snapshot()
            self.snapshots.append((snap_step, tree))
        return taken

    def __getattr__(self, name):
        return getattr(self.guard, name)


def guard_phase(torch, fa, fh, kernels, dev) -> dict:
    """Phase 30 (module docstring): the training guard and its chaos on the
    LM and CNN entry points; adds the guarded paths' launches to `kernels`
    and returns what it measured."""
    import gc

    import numpy as np

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.data.cifar10 import load_split
    from distributed_neural_network_tpu_torch.train import cli
    from distributed_neural_network_tpu_torch.train import guard as G
    from distributed_neural_network_tpu_torch.train import lm as lmtrain
    from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves
    from port_probes import ckpt_world as CW

    out = os.path.join(ROOT, "chiprun_out", "guard")
    ck = os.path.join(ROOT, "runs", "guard_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    os.makedirs(out, exist_ok=True)
    res, part_s, t_part = {}, {}, time.perf_counter()
    captures, capture_all = [], lmtrain.capture_all

    def counted(*a, **kw):
        captures.append(1)
        return capture_all(*a, **kw)

    def lm(name, *extra):
        """One `lm_train.main` run at LM_ARGS + LM_RESUME, GUARD_STEPS steps,
        the flash counters set to 0 just before it, the step's captures
        counted: its losses, launches, lines, SUMMARY, segments, guard
        record and a copy of its state."""
        lines, result = [], {}
        for c in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
            c.update(dict.fromkeys(c, 0))
        captures.clear()
        lmtrain.capture_all = counted
        try:
            rc = lm_train.main(["--device", "cuda", "--steps", str(GUARD_STEPS), "--log-every",
                                "1", *LM_ARGS, *LM_RESUME, *extra], log=lines.append,
                               result=result)
        finally:
            lmtrain.capture_all = capture_all
        check(rc == 0, f"30 {name}: lm_train.main returned {rc}")
        summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
        row = {"losses": result["losses"], "launches": dict(fa.LAUNCHES),
               "routes": dict(fa.ROUTE_LAUNCHES), "summary": summary, "lines": lines,
               "segments": result["step"].segments, "captures": len(captures),
               "guard": result["guard"], "t": result["mom"]["t"],
               "state": [x.detach().clone() for x in (
                   *tree_leaves(result["params"]), *result["mom"]["m"], *result["mom"]["v"])],
               "ms_per_step": 1e3 * summary["wall_s_post_compile"] / max(
                   summary["last_step"] - summary["start_step"], 1)}
        del result
        gc.collect()
        torch.cuda.empty_cache()
        return row

    def same_state(a, b):
        return a["t"] == b["t"] and all(torch.equal(x, y) for x, y in zip(a["state"],
                                                                           b["state"]))

    def launches_ok(row, steps, what):
        want = flash_counts(steps)
        check(row["launches"] == want and row["routes"] == mma_counts(want),
              f"30{what}: flash launches {row['launches']} / {row['routes']}, want {want}")

    try:
        # (a) off, warn, warn, off in one call: the health output only observes
        order = (("off", "off"), ("warn", "warn"), ("warn2", "warn"), ("off2", "off"))
        rows = {name: lm(name, "--guard", g) for name, g in order}
        for name, _ in order:
            check(rows[name]["losses"] == rows["off"]["losses"]
                  and same_state(rows[name], rows["off"]),
                  f"30(a): the {name} run's losses or state differ from the unguarded run's")
            launches_ok(rows[name], GUARD_STEPS, f"(a) {name}")
        ms = {name: rows[name]["ms_per_step"] for name, _ in order}
        off_ms = (ms["off"] + ms["off2"]) / 2
        warn_ms = (ms["warn"] + ms["warn2"]) / 2
        res["off_warn"] = {"ms_per_step": ms, "warn_over_off": warn_ms / off_ms - 1.0}
        print(f"   (a) LM flagship row, flash, Adam, cosine, {GUARD_STEPS} steps, --guard off, "
              f"warn, warn, off: losses, params and Adam state bitwise; ms per step "
              f"{ms['off']:.2f}, {ms['warn']:.2f}, {ms['warn2']:.2f}, {ms['off2']:.2f} (warn "
              f"over off {100 * res['off_warn']['warn_over_off']:+.2f}%)")
        reference = rows["off"]
        for name in ("warn", "warn2", "off2"):
            del rows[name]
        part_s["a"] = time.perf_counter() - t_part

        # (b) skip: the NaN step leaves everything as it was, counter too
        s3 = lm("skip-stop3", "--guard", "skip", "--chaos-nan-step", str(GUARD_NAN),
                "--stop-at-step", str(GUARD_NAN + 1))
        p2 = lm("stop2", "--stop-at-step", str(GUARD_NAN))
        check(s3["losses"][:GUARD_NAN] == p2["losses"] and same_state(s3, p2)
              and s3["t"] == GUARD_NAN,
              f"30(b): the skipped step changed the state (t {s3['t']} / {p2['t']})")
        check(any(f"step {GUARD_NAN} nonfinite -> skip" in l for l in s3["lines"])
              and s3["summary"]["guard_summary"]["skipped"] == 1,
              f"30(b): no skip: {s3['summary']['guard_summary']}")
        launches_ok(s3, GUARD_NAN + 1, "(b) stop 3")
        whole = lm("skip", "--guard", "skip", "--chaos-nan-step", str(GUARD_NAN))
        check(whole["segments"] == "graph" and whole["captures"] == 1,
              f"30(b): the guarded step is {whole['segments']}, captured {whole['captures']}x")
        check(all(math.isfinite(x) for x in whole["losses"][GUARD_NAN + 1:])
              and whole["summary"]["guard_summary"]["skipped"] == 1,
              f"30(b): losses after the skip {whole['losses']}")
        launches_ok(whole, GUARD_STEPS, "(b) whole")
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels[name]["launches_guard"] = whole["launches"][name]
        res["skip"] = {"bitwise": True, "segments": whole["segments"],
                       "losses": whole["losses"], "launches": whole["launches"],
                       "ms_per_step": whole["ms_per_step"]}
        print(f"   (b) --guard skip --chaos-nan-step {GUARD_NAN} --stop-at-step {GUARD_NAN + 1}: "
              f"params, m, v and t bitwise an unguarded --stop-at-step {GUARD_NAN} run; the "
              f"{GUARD_STEPS}-step skip run one graph ({whole['segments']}, captured once), "
              f"finite after the skip, {whole['ms_per_step']:.2f} ms per step (the gated "
              f"update), flash launches {whole['launches']} (all mma)")
        del s3, p2, whole
        part_s["b"] = time.perf_counter() - t_part - sum(part_s.values())

        # (c) rollback: the snapshot restored into the captured step, the lr
        # backed off in its buffer, the replay in the run record
        trace, record = os.path.join(out, "rollback_trace.json"), os.path.join(
            out, "rollback_record.json")
        rb = lm("rollback", "--guard", "rollback", "--chaos-spike-step", str(GUARD_SPIKE),
                "--snapshot-every", str(GUARD_SNAPSHOT), "--trace-out", trace,
                "--run-record", record)
        snap_at = GUARD_SPIKE // GUARD_SNAPSHOT * GUARD_SNAPSHOT
        gs = rb["summary"]["guard_summary"]
        check(gs["rollbacks"] == 1 and gs["lr_scale"] == 0.5 and any(
            l.startswith(f"(guard: resuming from step {snap_at} at lr_scale=0.5")
            for l in rb["lines"]), f"30(c): {gs}")
        check(rb["losses"][:snap_at] == reference["losses"][:snap_at]
              and len(rb["losses"]) == GUARD_STEPS
              and all(math.isfinite(x) for x in rb["losses"]),
              f"30(c): losses {rb['losses']} / {reference['losses']}")
        check(rb["captures"] == 1 and rb["segments"] == "graph",
              f"30(c): the step captured {rb['captures']}x ({rb['segments']})")
        # the spike's verdict is read after the next step's launch: the steps
        # from the snapshot to that one run twice
        replayed = GUARD_SPIKE + 2 - snap_at
        launches_ok(rb, GUARD_STEPS + replayed, "(c)")
        rec = _telemetry_check(trace, record, "30(c)")
        check(rec["badput_s"]["rollback_recompute"] > 0,
              f"30(c): no rollback_recompute in {rec['badput_s']}")
        proc = _tool("trace_summary.py", trace)
        table = next((l for l in proc.stdout.splitlines() if l.startswith("Guard events:")), "")
        check("restore=1" in table and "rollback=1" in table and "spikes=1" in table,
              f"30(c): guard events table {table!r}")
        snaps, restores = rb["guard"]["snapshots"], rb["guard"]["restores"]
        res["rollback"] = {"losses": rb["losses"], "guard": gs, "table": table,
                           "snapshots": snaps, "restores": restores,
                           "rollback_recompute_s": rec["badput_s"]["rollback_recompute"],
                           "captured_again": rb["captures"] > 1}
        print(f"   (c) --guard rollback --chaos-spike-step {GUARD_SPIKE} --snapshot-every "
              f"{GUARD_SNAPSHOT}: one rollback to step {snap_at}, lr_scale 0.5, the losses before "
              f"it bitwise the unguarded run's; step program captured again: no (one capture, "
              f"{rb['segments']}); snapshots (step, s, B) "
              f"{[(st, round(sec, 3), b) for st, sec, b in snaps]}; restore "
              f"{[round(sec, 3) for sec in restores]} s; run record rollback_recompute "
              f"{rec['badput_s']['rollback_recompute']:.3f} s; {table}")
        del rb, reference, rows
        gc.collect()
        torch.cuda.empty_cache()
        part_s["c"] = time.perf_counter() - t_part - sum(part_s.values())

        # (d) abort: GuardAbort with the JAX text, no return
        lines = []
        try:
            lm_train.main(["--device", "cuda", "--steps", str(GUARD_STEPS), "--log-every", "1",
                           *LM_ARGS, *LM_RESUME, "--guard", "abort", "--chaos-nan-step", "1"],
                          log=lines.append)
            check(False, "30(d): lm_train.main returned under --guard abort")
        except G.GuardAbort as e:
            text = str(e)
        check(text.startswith("guard policy 'abort': non-finite step") and "--guard warn" in text,
              f"30(d): {text}")
        gc.collect()
        torch.cuda.empty_cache()
        res["abort"] = text
        print(f"   (d) --guard abort --chaos-nan-step 1: GuardAbort ({text[:60]}...)")
        part_s["d"] = time.perf_counter() - t_part - sum(part_s.values())

        # (e) the CNN main path per epoch: warn (through --fused's fallback)
        # bitwise the unguarded run; a rollback through Engine.run(guard=)
        def cnn(name, *extra):
            lines = []
            for k in fh.LAUNCHES:
                fh.LAUNCHES[k] = 0
            rc = cli.main(CNN_GUARD + ["--epochs", str(CNN_GUARD_EPOCHS), "--log-dir",
                                       os.path.join(out, "log"), "--checkpoint-dir",
                                       os.path.join(ck, name), *extra], log=lines.append)
            check(rc == 0, f"30(e) {name}: cli.main returned {rc}")
            return lines, dict(fh.LAUNCHES)

        plain, _ = cnn("cnn_plain")
        warn, launches = cnn("cnn_warn", "--guard", "warn", "--fused")
        check("(fused mode cannot observe per-epoch health inside one dispatch; --guard uses "
              "the per-epoch path)" in warn, "30(e): no per-epoch fallback line")
        metrics = [[l for l in ls if l.startswith(("Global", "Validation"))] for ls in (plain,
                                                                                       warn)]
        last = f"step_{CNN_GUARD_EPOCHS - 1}"
        check(metrics[0] == metrics[1] and CW._same_checkpoint(
            os.path.join(ck, "cnn_plain", last), os.path.join(ck, "cnn_warn", last)),
            "30(e): the warn run's metrics, params or momentum differ from the unguarded run's")
        want = head_launches(16, CNN_GUARD_EPOCHS)
        check(launches == want, f"30(e): warn head launches {launches} != {want}")
        for name, count in launches.items():
            kernels[name]["launches_guard"] = count
        i = CNN_GUARD.index
        cfg = TrainConfig(lr=0.01, momentum=0.9, batch_size=16, epochs=CNN_GUARD_EPOCHS,
                          nb_proc=4, regime="data_parallel", kernels="cuda",
                          seed=int(CNN_GUARD[i("--seed") + 1]),
                          failure_probability=float(CNN_GUARD[i("--failure-probability") + 1]))
        split = load_split(True, source="synthetic", synthetic_size=50_000, seed=cfg.seed)
        test = load_split(False, source="synthetic", synthetic_size=10_000, seed=cfg.seed)
        for k in fh.LAUNCHES:
            fh.LAUNCHES[k] = 0
        eng = Engine(cfg, split, test, device=dev)
        # the CLI's recompile detector on the epoch's step program: the
        # rollback's rebuild re-baselines it, so it counts no recompile
        from distributed_neural_network_tpu_torch.train.monitor import RecompileDetector
        from distributed_neural_network_tpu_torch.utils.obs import MetricsRegistry

        eng.recompiles = RecompileDetector(eng._step, registry=MetricsRegistry())
        # the snapshot at epoch 0 only; the detector armed after two epochs
        # (after one, its variance is 0 and any rise is a spike); epoch 2's
        # loss spiked (x1e6: at this width it falls from about 0.25 to 2e-5
        # in one epoch, so x100 would sit below the running mean)
        guard = _SpikedGuard(G.TrainingGuard(G.GuardConfig(
            policy="rollback", warmup_steps=2, snapshot_every=CNN_GUARD_EPOCHS),
            log=lambda _: None), epoch=CNN_GUARD_EPOCHS - 1, scale=CNN_SPIKE)
        t0 = time.perf_counter()
        hist = eng.run(log=lambda _: None, guard=guard)
        cnn_s = time.perf_counter() - t0
        launches = dict(fh.LAUNCHES)
        ran = 2 * CNN_GUARD_EPOCHS  # every epoch, then all of them again
        summ = guard.summary()
        (s0, first), (s1, again) = guard.snapshots
        check(summ["rollbacks"] == 1 and summ["lr_scale"] == 0.5 and eng.config.lr == 0.005
              and s0 == s1 == 0 and all(np.array_equal(a, b) for a, b in zip(
                  tree_leaves(first), tree_leaves(again))),
              f"30(e) rollback: {summ}, lr {eng.config.lr}, snapshots at {s0}, {s1}")
        check([m.epoch for m in hist] == list(range(CNN_GUARD_EPOCHS))
              and launches == head_launches(16, ran),
              f"30(e) rollback: history {[m.epoch for m in hist]}, launches {launches} != "
              f"{head_launches(16, ran)}")
        recompiles = eng.recompiles.counter.value
        check(recompiles == 0 and eng._step._cache_size() == 1,
              f"30(e) rollback: recompiles_total {recompiles}, the rebuilt step program built "
              f"{eng._step._cache_size()}x")
        res["cnn"] = {"bitwise": True, "launches_warn": want, "rollback": summ,
                      "rollback_launches": launches, "rollback_run_s": cnn_s,
                      "final_val_acc": hist[-1].val_acc, "recompiles_total": recompiles}
        print(f"   (e) CNN main path per epoch, {CNN_GUARD_EPOCHS} epochs: --guard warn (--fused "
              f"falls back, with the JAX line) bitwise the unguarded run, head launches {want}; "
              f"Engine.run(guard=) with epoch {CNN_GUARD_EPOCHS - 1}'s loss spiked "
              f"x{CNN_SPIKE:g}: one "
              f"rollback to the epoch-0 snapshot (restored bitwise), lr 0.01 -> 0.005, the "
              f"programs built and captured again, {ran} epochs run, head launches {launches}, "
              f"recompiles_total {recompiles:g} ({cnn_s:.1f} s)")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        part_s["e"] = time.perf_counter() - t_part - sum(part_s.values())
    finally:
        lmtrain.capture_all = capture_all
        shutil.rmtree(ck, ignore_errors=True)
    res["seconds"] = part_s
    print(f"   parts (s): {json.dumps({k: round(v, 1) for k, v in part_s.items()})}")
    return res


def guard_check() -> int:
    """`python3 chip_smoke.py --guard-check`: phase 30 alone (after the
    kernels' build), for iterating on it; exits 1 when a gate fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    for m in (fh, fa):
        m.build()
    kernels = {k: {} for k in ("fused_mlp3_fwd", "fused_mlp3_bwd", "fused_mlp3_bwd_reduce",
                               "flash_fwd", "flash_dq", "flash_dkv")}
    t0 = time.perf_counter()
    try:
        res = guard_phase(torch, fa, fh, kernels, torch.device("cuda"))
    except SmokeFailure as e:
        print(f"guard check FAILED: {e}")
        return 1
    print(json.dumps({"kernels": kernels, "seconds": res["seconds"],
                      "total_s": time.perf_counter() - t0, "off_warn": res["off_warn"]}))
    print("guard check passed")
    return 0


def _flight_kinds(path):
    with open(path) as f:
        return [e["kind"] for e in json.load(f)["events"]]


def monitor_phase(torch, fa, fh, kernels, dev, guard_run=None) -> dict:
    """Phase 31 (module docstring): the monitor on the LM and CNN entry
    points, in process; adds the monitored paths' launches to `kernels` and
    returns what it measured."""
    import functools
    import gc
    import urllib.request

    from distributed_neural_network_tpu_torch import lm_train
    from distributed_neural_network_tpu_torch.train import cli
    from distributed_neural_network_tpu_torch.train import lm as lmtrain
    from distributed_neural_network_tpu_torch.train import monitor as MON
    from distributed_neural_network_tpu_torch.utils import obs
    from distributed_neural_network_tpu_torch.utils.goodput import RUN_RECORD_ENV
    from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

    out = os.path.join(ROOT, "chiprun_out", "monitor")
    ck = os.path.join(ROOT, "runs", "monitor_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    res, part_s, t_part = {}, {}, time.perf_counter()
    captures, capture_all = [], lmtrain.capture_all
    monitors, attach = [], MON.attach_monitor
    env_keys = ("DNN_TPU_HEARTBEAT_FILE", obs.FLIGHT_ENV, RUN_RECORD_ENV)
    env_saved = {k: os.environ.get(k) for k in env_keys}

    def counted(*a, **kw):
        captures.append(1)
        return capture_all(*a, **kw)

    def attached(**kw):
        monitors.append(attach(**kw))
        return monitors[-1]

    def full_stack(name):
        """The supervisor's files (heartbeat, flight dump, run record) armed
        by their environment variables, as a supervised worker has them."""
        files = {k: os.path.join(out, f"{name}_{stem}.json") for k, stem in zip(
            env_keys, ("heartbeat", "flight", "record"))}
        os.environ.update(files)
        obs.FLIGHT.reset()
        return files

    def lm(name, *extra, on_line=None):
        """One `lm_train.main` run at LM_ARGS + LM_RESUME, MONITOR_STEPS
        steps, the flash counters set to 0 just before it, its captures and
        monitor kept."""
        lines, result = [], {}

        def log(line):
            lines.append(line)
            if on_line is not None:
                on_line(line)

        for c in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
            c.update(dict.fromkeys(c, 0))
        captures.clear()
        monitors.clear()
        lmtrain.capture_all, MON.attach_monitor = counted, attached
        try:
            rc = lm_train.main(["--device", "cuda", "--steps", str(MONITOR_STEPS),
                                "--log-every", "1", *LM_ARGS, *LM_RESUME, *extra], log=log,
                               result=result)
        finally:
            lmtrain.capture_all, MON.attach_monitor = capture_all, attach
            for k in env_keys:
                os.environ.pop(k, None)
        check(rc == 0, f"31 {name}: lm_train.main returned {rc}")
        summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
        mon = monitors[0]
        row = {"losses": result["losses"], "launches": dict(fa.LAUNCHES),
               "routes": dict(fa.ROUTE_LAUNCHES), "summary": summary, "lines": lines,
               "segments": result["step"].segments, "captures": len(captures),
               "t": result["mom"]["t"], "monitor": mon,
               "samples": obs.parse_prom_samples(mon.registry.render()),
               "recompiles": None if mon.recompiles is None else mon.recompiles.counter.value,
               "state": [x.detach().clone() for x in (
                   *tree_leaves(result["params"]), *result["mom"]["m"], *result["mom"]["v"])],
               "ms_per_step": 1e3 * summary["wall_s_post_compile"] / max(
                   summary["last_step"] - summary["start_step"], 1)}
        del result
        gc.collect()
        torch.cuda.empty_cache()
        return row

    def same_state(a, b):
        return a["t"] == b["t"] and all(torch.equal(x, y) for x, y in zip(a["state"],
                                                                           b["state"]))

    def one_graph(row, steps, what):
        want = flash_counts(steps)
        check(row["segments"] == "graph" and row["captures"] == 1,
              f"31{what}: the step is {row['segments']}, captured {row['captures']}x")
        check(row["launches"] == want and row["routes"] == mma_counts(want),
              f"31{what}: flash launches {row['launches']} / {row['routes']}, want {want}")

    try:
        # (a) bare, full stack, full stack, bare in one call
        order = (("bare", False), ("full", True), ("full2", True), ("bare2", False))
        rows = {}
        for name, full in order:
            files = full_stack(name) if full else None
            rows[name] = lm(name, *(["--metrics-port", "0"] if full else []))
            rows[name]["files"] = files
        ref = rows["bare"]
        for name, full in order:
            row = rows[name]
            check(row["losses"] == ref["losses"] and same_state(row, ref),
                  f"31(a): the {name} run's losses or state differ from the bare run's")
            one_graph(row, MONITOR_STEPS, f"(a) {name}")
            mon = row["monitor"]
            if not full:
                check(mon.server is None and mon.registry is obs.NULL_REGISTRY,
                      f"31(a): the {name} run has a monitor")
                continue
            smp = row["samples"]
            check(mon.watchdog is not None and mon.heartbeat is not None
                  and smp["train_steps_total"][()] == MONITOR_STEPS
                  and row["recompiles"] == 0
                  and smp.get("watchdog_stall_total", {}).get((), 0) == 0,
                  f"31(a) {name}: steps {smp.get('train_steps_total')}, recompiles "
                  f"{row['recompiles']}, stalls {smp.get('watchdog_stall_total')}")
            with open(row["files"]["DNN_TPU_HEARTBEAT_FILE"]) as f:
                hb = json.load(f)
            kinds = _flight_kinds(row["files"][obs.FLIGHT_ENV])
            rec = _read_record(row["files"][RUN_RECORD_ENV], f"31(a) {name}")
            check(hb["step"] == MONITOR_STEPS - 1 and kinds[0] == "run_start"
                  and kinds[-2:] == ["goodput_final", "run_end"] and rec["final"]
                  and rec["steps"] == MONITOR_STEPS,
                  f"31(a) {name}: heartbeat {hb}, flight {kinds}, record steps {rec['steps']}")
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels[name]["launches_monitor"] = rows["full"]["launches"][name]
        ms = {name: rows[name]["ms_per_step"] for name, _ in order}
        bare_ms = (ms["bare"] + ms["bare2"]) / 2
        full_ms = (ms["full"] + ms["full2"]) / 2
        over = full_ms / bare_ms - 1.0
        check(over <= 0.01, f"31(a): the monitored step costs {100 * over:+.2f}% (> 1%): {ms}")
        res["overhead"] = {"ms_per_step": ms, "full_over_bare": over,
                           "final_loss": ref["losses"][-1]}
        print(f"   (a) LM flagship row, flash, Adam, cosine, {MONITOR_STEPS} steps, bare / full "
              f"stack (registry, server, watchdog, heartbeat file, flight recorder, run "
              f"record) / full / bare: ms per step {ms['bare']:.2f}, {ms['full']:.2f}, "
              f"{ms['full2']:.2f}, {ms['bare2']:.2f} (full over bare {100 * over:+.2f}%); "
              f"losses (final {ref['losses'][-1]!r}), params and Adam state bitwise; one "
              f"graph a step (captured once); flash launches {rows['full']['launches']} (all "
              f"mma); recompiles_total 0, watchdog_stall_total 0; heartbeat, flight dump and "
              f"record written")
        bare = {k: ref[k] for k in ("losses", "state", "t")}
        del rows, ref
        gc.collect()
        torch.cuda.empty_cache()
        part_s["a"] = time.perf_counter() - t_part

        # (b) a 2 s host stall after step MONITOR_STALL_AT, the watchdog at
        # poll 0.05 s and a 0.2 s floor, escalating: the run stops after the
        # next step at an emergency checkpoint; the resume is (c)'s run
        cdir = os.path.join(ck, "stall")
        trace = os.path.join(out, "stall_trace.json")
        cfg = MON.WatchdogConfig
        MON.WatchdogConfig = functools.partial(cfg, poll_interval_s=0.05, min_stall_s=0.2)
        try:
            files = full_stack("stall")
            row = lm("stall", "--metrics-port", "0", "--watchdog-escalate", "preempt",
                     "--chaos-stall-step", str(MONITOR_STALL_AT), "--chaos-stall-seconds",
                     str(MONITOR_STALL_S), "--checkpoint-dir", cdir, "--trace-out", trace)
        finally:
            MON.WatchdogConfig = cfg
        stop = MONITOR_STALL_AT + 1
        smp, summary = row["samples"], row["summary"]
        check(summary["preempted"] and summary["last_step"] == stop
              and f"(emergency checkpoint at step {stop}; resume with --resume to continue "
              "bit-exactly)" in row["lines"] and row["recompiles"] == 0,
              f"31(b): {summary}")
        check(row["losses"] == bare["losses"][:stop + 1],
              f"31(b): losses {row['losses']} / {bare['losses']}")
        with open(files[obs.FLIGHT_ENV]) as f:
            events = json.load(f)["events"]
        kinds = [e["kind"] for e in events]
        # the stall is flagged once; the emergency checkpoint's save after
        # the next step (705 MB, about 1.4 s against a threshold of about
        # 1 s) may be flagged as an episode of its own
        flags = [e for e in events if e["kind"] == "watchdog_stall"]
        flag = flags[0] if flags else {}
        check([e["step"] for e in flags][:1] == [MONITOR_STALL_AT]
              and [e["step"] for e in flags].count(MONITOR_STALL_AT) == 1
              and smp["watchdog_stall_total"][()] == len(flags)
              and {"chaos", "watchdog_escalate", "preempt", "checkpoint_save",
                   "run_end"} <= set(kinds), f"31(b): flight events {events}")
        rec = _read_record(files[RUN_RECORD_ENV], "31(b)")
        check(rec["badput_s"]["stall"] > 0, f"31(b): no stall badput in {rec['badput_s']}")
        with open(trace) as f:
            instants = [e for e in json.load(f)["traceEvents"] if e["name"] == "watchdog/stall"
                        and e["args"].get("step") == MONITOR_STALL_AT]
        check(len(instants) == 2 and instants[1]["args"].get("action") == "escalate",
              f"31(b): the trace's watchdog/stall instants at step {MONITOR_STALL_AT}: "
              f"{instants}")
        one_graph(row, stop + 1, "(b)")
        res["stall"] = {"heartbeat_age_s": flag["heartbeat_age_s"],
                        "threshold_s": flag["threshold_s"], "flags": flags,
                        "flag_after_threshold_s": flag["heartbeat_age_s"] - flag["threshold_s"],
                        "stall_badput_s": rec["badput_s"]["stall"], "stopped_after": stop}
        print(f"   (b) a {MONITOR_STALL_S:g} s host stall after step {MONITOR_STALL_AT} "
              f"(--chaos-stall-step), the watchdog at poll 0.05 s, floor 0.2 s, escalating: "
              f"flagged once at heartbeat age {flag['heartbeat_age_s']} s against the adaptive "
              f"threshold {flag['threshold_s']} s (10 x the steady p95), a watchdog/stall "
              f"instant and its escalation in the trace, stall badput "
              f"{rec['badput_s']['stall']} s in the run record, the flight dump {kinds}; the run "
              f"stopped after step {stop} at an emergency checkpoint; stall episodes flagged at "
              f"steps {[e['step'] for e in flags]}")
        del row
        gc.collect()
        torch.cuda.empty_cache()
        part_s["b"] = time.perf_counter() - t_part - sum(part_s.values())

        # (c) the resume, with GET /profile?steps=2 over HTTP as it starts: the
        # capture takes the two steps after the first beat
        pdir = os.path.join(out, "profile")
        asked = []

        def ask(line):
            if line.startswith("(metrics server: "):
                url = line.split()[2].rsplit("/metrics", 1)[0]
                with urllib.request.urlopen(url + "/profile?steps=2", timeout=10) as r:
                    asked.append((r.status, json.loads(r.read())))

        row = lm("resumed", "--metrics-port", "0", "--profile-dir", pdir, "--checkpoint-dir",
                 cdir, "--resume", "--stop-at-step", str(MONITOR_STEPS), on_line=ask)
        check(asked and asked[0][0] == 200 and asked[0][1]["ok"], f"31(c): /profile {asked}")
        check(row["losses"] == bare["losses"][stop + 1:]
              and same_state(row, bare) and row["recompiles"] == 0,
              f"31(c): the profiled resume differs: {row['losses']} / {bare['losses']}")
        prof = row["monitor"].profiler
        first = stop + 1
        want_dir = os.path.join(pdir, f"profile_step{first}_x2")
        check(prof.captures == 1 and prof.last_dir == want_dir,
              f"31(c): captures {prof.captures} in {prof.last_dir}, error {prof.error}")
        with open(os.path.join(want_dir, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        launches = [e for e in events if e.get("name", "").startswith("cudaGraphLaunch")]
        names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
        flash = sorted(n for n in names if "flash" in n)
        check(len(launches) == 2, f"31(c): {len(launches)} graph launches in the profile, want 2")
        one_graph(row, MONITOR_STEPS - first, "(c)")
        stalls = row["samples"].get("watchdog_stall_total", {}).get((), 0)
        res["profile"] = {"dir": want_dir, "graph_launches": len(launches),
                          "kernel_names": len(names), "flash_kernels_by_name": flash,
                          "events": len(events), "watchdog_stall_total": stalls,
                          "bytes": os.path.getsize(os.path.join(want_dir, "trace.json"))}
        print(f"   (c) --resume with GET /profile?steps=2 at its start: the resume bitwise the "
              f"bare run (losses of the profiled steps included, params, Adam state); one "
              f"capture, {os.path.relpath(want_dir, ROOT)}/trace.json (Chrome JSON, "
              f"{len(events)} events, {res['profile']['bytes']:,} B) holds {len(launches)} "
              f"cudaGraphLaunch (one a step) and {len(names)} kernel names; the flash kernels "
              f"{'by name: ' + ', '.join(flash) if flash else 'not by name (the graph replay only)'}"
              f"; watchdog_stall_total in that run {stalls:g}")
        del row
        gc.collect()
        torch.cuda.empty_cache()
        part_s["c"] = time.perf_counter() - t_part - sum(part_s.values())

        # (d) no recompile: the LM runs above, and phase 30(e)'s CNN rollback
        cnn_rb = (guard_run or {}).get("cnn", {}).get("recompiles_total")
        res["recompiles"] = {"lm": 0, "cnn_rollback": cnn_rb}
        print(f"   (d) recompiles_total 0 in every LM run above; phase 30(e)'s CNN rollback "
              f"(the programs built and captured again): "
              f"{'not run here' if cnn_rb is None else f'{cnn_rb:g}'}")

        # (e) the CNN main path --fused with --metrics-port 0, in process,
        # against the same run unmonitored
        def cnn(name, *extra):
            lines = []
            for k in fh.LAUNCHES:
                fh.LAUNCHES[k] = 0
            monitors.clear()
            MON.attach_monitor = attached
            try:
                rc = cli.main(CNN_RESUME + ["--epochs", str(MONITOR_CNN_EPOCHS), "--log-dir",
                                            os.path.join(out, "log"), *extra], log=lines.append)
            finally:
                MON.attach_monitor = attach
            check(rc == 0, f"31(e) {name}: cli.main returned {rc}")
            return ([l for l in lines if l.startswith(("Global", "Validation"))],
                    dict(fh.LAUNCHES), monitors[0])

        plain, want, _ = cnn("plain")
        lines, launches, mon = cnn("monitored", "--metrics-port", "0")
        smp = obs.parse_prom_samples(mon.registry.render())
        phases = {dict(k)["phase"] for k in smp.get("phase_seconds_total", {})}
        check(lines == plain and launches == want == head_launches(16, MONITOR_CNN_EPOCHS),
              f"31(e): the monitored epochs {lines} / {plain}, launches {launches} / {want}")
        check(phases >= {"data_loading", "training"}
              and smp["train_steps_total"][()] == MONITOR_CNN_EPOCHS
              and mon.recompiles.counter.value == 0,
              f"31(e): phases {phases}, steps {smp.get('train_steps_total')}")
        for name, count in launches.items():
            kernels[name]["launches_monitor"] = count
        res["cnn"] = {"phases": sorted(phases), "launches": launches, "bitwise": True}
        print(f"   (e) CNN main path --fused --metrics-port 0, {MONITOR_CNN_EPOCHS} epochs in one "
              f"span: the epochs' metrics bitwise the unmonitored run's, head launches "
              f"{launches} (unchanged), phase_seconds_total for {sorted(phases)}, "
              f"train_steps_total {smp['train_steps_total'][()]:g}, recompiles_total 0")
        part_s["e"] = time.perf_counter() - t_part - sum(part_s.values())
    finally:
        lmtrain.capture_all, MON.attach_monitor = capture_all, attach
        for k, v in env_saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs.FLIGHT.reset()
        shutil.rmtree(ck, ignore_errors=True)
    res["seconds"] = part_s
    print(f"   parts (s): {json.dumps({k: round(v, 1) for k, v in part_s.items()})}")
    return res


def monitor_check() -> int:
    """`python3 chip_smoke.py --monitor-check`: phase 31 alone (after the
    kernels' build), for iterating on it; exits 1 when a gate fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    for m in (fh, fa):
        m.build()
    memoize_synthetic()
    kernels = {k: {} for k in ("fused_mlp3_fwd", "fused_mlp3_bwd", "fused_mlp3_bwd_reduce",
                               "flash_fwd", "flash_dq", "flash_dkv")}
    t0 = time.perf_counter()
    try:
        res = monitor_phase(torch, fa, fh, kernels, torch.device("cuda"))
    except SmokeFailure as e:
        print(f"monitor check FAILED: {e}")
        return 1
    print(json.dumps({"kernels": kernels, "seconds": res["seconds"],
                      "total_s": time.perf_counter() - t0, "overhead": res["overhead"],
                      "stall": res["stall"], "profile": res["profile"]}))
    print("monitor check passed")
    return 0


# ------------------------------------------------------------ phase 32 helpers


def elastic_phase(torch, fa, fh, kernels, dev, ranks=None, whole=None) -> dict:
    """Phase 32 (module docstring): the LM's elastic resume and in-process
    shrink, and the CNN's --elastic resume; adds the paths' launches to
    `kernels` and returns what it measured. `ranks`: the records of
    ELASTIC_OUT's runs, made by phase 21's launch of the ranks, and `whole`
    the uninterrupted run's losses (phase 23's zero-adam run); without
    them (``--elastic-check``) the phase launches its own 2 ranks."""
    import numpy as np

    from distributed_neural_network_tpu_torch.data.cifar10 import load_split
    from distributed_neural_network_tpu_torch.train import cli
    from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig
    from distributed_neural_network_tpu_torch.utils.checkpoint import Checkpointer
    from port_probes import elastic_world as EW

    res, part_s, t_part = {}, {}, time.perf_counter()
    try:
        if ranks is None:
            shutil.rmtree(ELASTIC_OUT, ignore_errors=True)
            ranks = EW.run_world(2, ELASTIC_OUT, LM_ARGS,
                                 EW.world_runs(2, ELASTIC_OUT, stopped=False), timeout=900)
            whole = ranks[0]["runs"]["whole"]["losses"]
            part_s["ranks"] = time.perf_counter() - t_part
        # (a) the dp-2 ZeRO-Adam checkpoint (the shrink's hand-off, written by
        # both ranks) resumed in this process at dp 1 with Adam: the data axis
        # 2 -> 1, the optimizer's layout, accum 1 -> 2
        t_a = time.perf_counter()
        EW.take_stopped(ELASTIC_OUT)
        r1 = EW.run_one(LM_ARGS, "cuda", "r1", EW.resume_runs(ELASTIC_OUT, 1, "adam")[0][1])
        part_s["a"] = time.perf_counter() - t_a
        try:
            world = EW.check(2, ranks, whole=whole,
                             resumed=[("r1", r1, 2, 1, 1, "adam", 2)])
        except AssertionError as e:
            raise SmokeFailure(f"32: {e}") from e
        a, b = world["r1"], world["shrink"]
        check(a["segments"] == "graph", f"32(a): the resumed step is {a['segments']}, not one "
              "graph")
        want_a = flash_counts(EW.STEPS - EW.STOP, accum=2)
        check(r1["launches"] == want_a and r1["routes"] == mma_counts(want_a),
              f"32(a): flash launches {r1['launches']} / {r1['routes']} != {want_a}")
        (ra,) = a["reshards"]
        print(f"   (a) --dp 2 --optimizer zero-adam (2 ranks, gloo) checkpointed after step "
              f"{EW.STOP - 1}, --resume --elastic --dp 1 --optimizer adam in one process: "
              f"{'; '.join(x for x in r1['log'] if 'elastic' in x)}; losses "
              f"{a['losses']} against the uninterrupted {whole[EW.STOP:]} (within "
              f"{EW.LOSS_TOL:g}); reshard_seconds {ra['seconds']:.3f} s, {ra['bytes']:,} B read; "
              f"the resumed step one graph; flash launches {r1['launches']} (all mma)")
        # (b) the in-process shrink 2 -> 1 (run by the ranks)
        survivor = ranks[0]["runs"]["shrink"]
        want_b = {k: v + w for (k, v), w in zip(
            flash_counts(EW.SHRINK_AT + 1).items(),
            flash_counts(EW.STEPS - EW.SHRINK_AT - 1, accum=2).values())}
        want_left = flash_counts(EW.SHRINK_AT + 1)
        check(survivor["launches"] == want_b and survivor["routes"] == mma_counts(want_b),
              f"32(b): the survivor's flash launches {survivor['launches']} != {want_b}")
        check(ranks[1]["runs"]["shrink"]["launches"] == want_left,
              f"32(b): the leaving rank's flash launches {ranks[1]['runs']['shrink']['launches']}"
              f" != {want_left}")
        check(b["segments"] == "graph", f"32(b): the survivor's step is {b['segments']}")
        (rb,) = b["reshards"]
        print(f"   (b) --chaos-shrink-at-step {EW.SHRINK_AT} --chaos-shrink-to 1 on 2 ranks: "
              f"rank 1 exited 0 ({b['left_log'][0][-1]}); rank 0 finished every step on mesh "
              f"{b['mesh']} with accum {b['accum_steps']}: losses {b['losses']}, steps 0-"
              f"{EW.SHRINK_AT} bitwise the uninterrupted run's, the rest within "
              f"{EW.LOSS_TOL:g}; reshard_seconds {rb['seconds']:.3f} s, {rb['bytes']:,} B read; "
              f"ms a step before / after the shrink {b['ms_before']} / {b['ms_after']}; the "
              f"survivor's step one graph; flash launches {survivor['launches']} (the leaving "
              f"rank {ranks[1]['runs']['shrink']['launches']})")
        for k in want_a:
            if k in kernels:
                kernels[k]["launches_elastic"] = {"resume": r1["launches"][k],
                                                  "shrink": survivor["launches"][k]}
        res["lm"] = {"resume": a, "shrink": b, "whole": whole}
        # (c) the CNN: phase 29(a)'s 4-worker checkpoint resumed at 2 workers
        t_c = time.perf_counter()
        if not os.path.isdir(ELASTIC_CNN):
            rc = cli.main(CNN_RESUME + ["--epochs", "2", "--log-dir", os.path.join(
                ELASTIC_OUT, "log"), "--checkpoint-dir", ELASTIC_CNN], log=lambda line: None)
            check(rc == 0, f"32(c): the 4-worker CNN run returned {rc}")
        ck = Checkpointer(ELASTIC_CNN)
        last = ck.latest_epoch()
        with np.load(os.path.join(ELASTIC_CNN, f"step_{last}", "state.npz")) as z:
            saved = [z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[1]))]
        train = load_split(True, source="synthetic", synthetic_size=50_000, seed=3)
        test = load_split(False, source="synthetic", synthetic_size=10_000, seed=3)
        with uncounted(fh.LAUNCHES):
            eng = Engine(TrainConfig(lr=0.01, batch_size=16, nb_proc=2, kernels="cuda",
                                     regime="data_parallel", failure_probability=0.5, seed=3),
                         train, test, device=dev)
            lines = []
            nxt = ck.restore_latest(eng, elastic=True, log=lines.append)
            from distributed_neural_network_tpu_torch.utils.tree import tree_leaves

            got = [np.asarray(x) for x in tree_leaves(eng.state_tree())]
            del eng
        n_params = len(got) // 2
        mom_saved, mom_got = saved[:n_params], got[:n_params]
        check(nxt == last + 1 and all(np.array_equal(g, s[:2]) for g, s in zip(mom_got,
                                                                               mom_saved))
              and all(np.array_equal(g, s) for g, s in zip(got[n_params:], saved[n_params:])),
              "32(c): the restored momentum rows or params are not the saved ones")
        check(any("momentum stack resharded 4 -> 2" in l for l in lines), f"32(c): {lines}")
        fh.LAUNCHES.update(dict.fromkeys(fh.LAUNCHES, 0))
        out_lines = []
        rc = cli.main([*CNN_RESUME[:CNN_RESUME.index("--nb-proc")], "--nb-proc", "2",
                       *CNN_RESUME[CNN_RESUME.index("--nb-proc") + 2:], "--epochs",
                       str(last + 3), "--log-dir", os.path.join(ELASTIC_OUT, "log"),
                       "--checkpoint-dir", ELASTIC_CNN, "--resume", "--elastic"],
                      log=out_lines.append)
        launches_c = dict(fh.LAUNCHES)
        check(rc == 0, f"32(c): cli.main returned {rc}")
        want_c = head_launches(16, 2, workers=2)
        check(launches_c == want_c, f"32(c): head launches {launches_c} != {want_c}")
        for name, count in launches_c.items():
            kernels[name]["launches_elastic"] = count
        summary = json.loads(next(l for l in out_lines if l.startswith("SUMMARY "))[8:])
        part_s["c"] = time.perf_counter() - t_c
        res["cnn"] = {"log": lines, "launches": launches_c, "summary": summary}
        print(f"   (c) CNN, phase 29(a)'s 4-worker checkpoint (epoch {last}) --resume --elastic "
              f"at 2 workers --fused: {lines[-1]}; the surviving momentum rows and the params "
              f"bitwise the saved ones; 2 epochs: head launches {launches_c} (the formula at 2 "
              f"workers); final validation accuracy {summary.get('final_val_acc')}")
    finally:
        shutil.rmtree(ELASTIC_OUT, ignore_errors=True)
        shutil.rmtree(ELASTIC_CNN, ignore_errors=True)
    res["seconds"] = part_s
    print(f"   parts (s): {json.dumps({k: round(v, 1) for k, v in part_s.items()})}")
    return res


def elastic_check() -> int:
    """`python3 chip_smoke.py --elastic-check`: phase 32 alone (after the
    kernels' build, with its own launch of the ranks), for iterating on it;
    exits 1 when a gate fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    for m in (fh, fa):
        m.build()
    memoize_synthetic()
    kernels = {k: {} for k in ("fused_mlp3_fwd", "fused_mlp3_bwd", "fused_mlp3_bwd_reduce",
                               "flash_fwd", "flash_dq", "flash_dkv")}
    t0 = time.perf_counter()
    try:
        res = elastic_phase(torch, fa, fh, kernels, torch.device("cuda"))
    except SmokeFailure as e:
        print(f"elastic check FAILED: {e}")
        return 1
    print(json.dumps({"kernels": kernels, "seconds": res["seconds"],
                      "total_s": time.perf_counter() - t0}, default=str))
    print("elastic check passed")
    return 0


def supervisor_phase(torch, fa, kernels, whole=None) -> dict:
    """Phase 33 (module docstring): the elastic supervisor over 2 ranks of
    the LM entry point sharing the card, a crash and a preemption; adds
    generation 1's launches to `kernels` and returns what it measured.
    `whole`: the uninterrupted run's rank-0 record (SV_WHOLE's, made by
    phase 21's launch of the ranks: its losses and per-step ms); without it
    (``--supervisor-check``) the phase launches its own 2 ranks for it."""
    from port_probes import supervisor_world as SW

    res, part_s, t_part = {}, {}, time.perf_counter()
    out = os.path.join(ROOT, "chiprun_out", "supervisor")
    os.makedirs(out, exist_ok=True)
    try:
        if whole is None:
            whole = SW.run_whole(2, SV_WHOLE, LM_ARGS)
            part_s["whole"] = time.perf_counter() - t_part
        # the launcher's workers need the card's memory this process cached
        torch.cuda.empty_cache()
        # (a) and (b) run at once, each launcher over its own 2 ranks: no gate
        # depends on the timing; the times printed are those of 4 ranks
        # sharing the card and the host (PERF.md has the phase's runs one at
        # a time)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(2) as pool:
            futures = {sig: pool.submit(SW.supervise, 2, os.path.join(SV_RUNS, sig.lower()),
                                        LM_ARGS, sig=sig, kill_rank=1, timeout=400)
                       for sig in ("KILL", "TERM")}
            runs = {sig: f.result() for sig, f in futures.items()}
        part_s["a+b"] = time.perf_counter() - t0
        # once both are done, none of their workers may be left on the card
        after = SW.compute_apps()
        for part, sig in (("a", "KILL"), ("b", "TERM")):
            run = runs[sig]
            run["apps_after"] = after
            with open(os.path.join(out, f"{sig.lower()}_launcher.log"), "w") as f:
                f.write("\n".join(f"{t:9.3f} {line}" for t, line in run["lines"]))
            for g, gen in run["gens"].items():
                for r, rank in gen["ranks"].items():
                    with open(os.path.join(out, f"{sig.lower()}_gen{g}_rank{r}.log"), "w") as f:
                        f.write(rank["log"])
            try:
                row = SW.check(run, whole["losses"], whole_ms=whole["step_ms"],
                               flash_counts=flash_counts, mma_counts=mma_counts, concurrent=2)
            except AssertionError as e:
                raise SmokeFailure(f"33({part}): {e}") from e
            res[sig] = row
            ms = row["ms_per_step"]
            print(f"   ({part}) --chaos-kill-signal {sig} to rank 1 at heartbeat step "
                  f"{row['kill_step']} ((a) and (b) at once): launcher exit 0, "
                  f"{json.dumps(row['summary'])}; exit codes "
                  f"{row['returncodes']}; generation 1 resumed from step {row['resumed_from']} "
                  f"at dp 1 (accum 2), one graph a step, flash launches {row['launches_gen1']} "
                  f"(the formula, all mma); losses gen 0 {row['losses']['gen0']} (bitwise the "
                  f"uninterrupted run: {row['losses']['gen0_bitwise']}), gen 1 "
                  f"{row['losses']['gen1']} (within 1e-3 of "
                  f"{whole['losses'][row['resumed_from'] + 1:]}); "
                  f"restart {row['restart_s']:.3f} s death -> respawn (backoff "
                  f"{row['backoff_s']:g} s), {row['death_to_first_step_s']:.3f} s death -> first "
                  f"step; grace spent {row['grace_spent_s']:.3f} s; ms a step gen 0 {ms[0]}, "
                  f"gen 1 {ms[1]} (the uninterrupted dp-2 run's trace, steps 1-5: "
                  f"{row['ms_per_step_whole']}); the launcher held no CUDA driver "
                  f"({row['launcher_cuda']}; the workers {row['workers_cuda']}); compute "
                  f"processes before {row['apps_before']}, during {row['apps_during']}, after "
                  f"both {row['apps_after']}")
        for k in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels[k]["launches_supervisor"] = {sig.lower(): res[sig]["launches_gen1"][k]
                                                 for sig in res}
    finally:
        shutil.rmtree(SV_RUNS, ignore_errors=True)
        shutil.rmtree(SV_WHOLE, ignore_errors=True)
    res["seconds"] = part_s
    print(f"   parts (s): {json.dumps({k: round(v, 1) for k, v in part_s.items()})}")
    return res


def supervisor_check() -> int:
    """`python3 chip_smoke.py --supervisor-check`: phase 33 alone (after the
    flash kernels' build, with its own launch of the ranks for the
    uninterrupted run), for iterating on it; exits 1 when a gate fails."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa

    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    fa.build()
    kernels = {k: {} for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    t0 = time.perf_counter()
    try:
        res = supervisor_phase(torch, fa, kernels)
    except SmokeFailure as e:
        print(f"supervisor check FAILED: {e}")
        return 1
    print(json.dumps({"kernels": kernels, "seconds": res["seconds"],
                      "total_s": time.perf_counter() - t0}, default=str))
    print("supervisor check passed")
    return 0


def timed_build(m) -> tuple:
    """Build kernel module `m`'s CUDA source: (library path, seconds)."""
    t0 = time.perf_counter()
    return m.build(), time.perf_counter() - t0


def join_build(env, name, future) -> str:
    """Wait for one kernel build started in phase 2 (a build that failed
    raises here) and print its library, seconds and ptxas lines."""
    lib, seconds = future.result()
    env["build_s_each"][name] = seconds
    print(f"built {os.path.relpath(lib, ROOT)} in {seconds:.2f} s (started in phase 2 with the "
          "others, in parallel)")
    env["ptxas"].append(print_ptxas(lib))
    return lib


def head_build(env, fh, lib) -> None:
    """Phase 2's checks of the head kernels' instances (module docstring)."""
    # the head forward's cluster instances (<blocks per 16-row tile>)
    env["head_fwd_instances"] = ptxas_instances(lib, "mlp3_fwd")
    for name, info in sorted(env["head_fwd_instances"].items()):
        info.update(fh.fwd_info(int(name.split("<")[1][:-1])))
        print(f"   {name}: {info['registers']} registers, spill stores "
              f"{info['spill_stores']} B; {info['static_smem']} B of static shared memory, "
              f"{info['blocks_per_sm']} blocks per SM, {info['active_clusters']} clusters "
              f"at once")
    check(len(env["head_fwd_instances"]) == 2,
          f"head forward instances {sorted(env['head_fwd_instances'])}")
    # the head backward's one instance (<blocks per 16-row tile>), the
    # size the rule gives
    env["head_bwd_instances"] = ptxas_instances(lib, "mlp3_bwd")
    for name, info in sorted(env["head_bwd_instances"].items()):
        info.update(fh.bwd_info())
        print(f"   {name}: {info['registers']} registers, spill stores "
              f"{info['spill_stores']} B; {info['smem_bytes']} B of dynamic shared memory, "
              f"{info['blocks_per_sm']} blocks per SM, {info['active_clusters']} clusters "
              f"at once")
        check(info["cluster"] == fh.bwd_cluster(16),
              f"the backward is built at {info['cluster']} blocks a tile, the rule says "
              f"{fh.bwd_cluster(16)}")
    check(sorted(env["head_bwd_instances"]) == [f"mlp3_bwd_kernel<{fh.bwd_cluster(16)}>"],
          f"head backward instances {sorted(env['head_bwd_instances'])}")
    # the backward's group rule: BWD_GROUP_MAX beside the clusters the
    # card runs at once, and the rule at four batches against the CUDA
    # source's own
    bwd = fh.bwd_info()
    env["bwd_groups"] = {"group_max": fh.BWD_GROUP_MAX,
                         "active_clusters": bwd["active_clusters"],
                         "rule": {b: fh.bwd_groups(b) for b in (16, 64, 256, 4096)}}
    print(f"   backward group rule: BWD_GROUP_MAX {fh.BWD_GROUP_MAX}, {bwd['active_clusters']} "
          f"clusters of {bwd['cluster']} at once; groups at B 16, 64, 256, 4096: "
          f"{env['bwd_groups']['rule']}")
    for b in (1, 16, 17, 64, 256, 1024, 1025, 4096, 8192):
        check(fh.bwd_groups(b) == fh.kernel_bwd_groups(b),
              f"group rule at B {b}: {fh.bwd_groups(b)} here, {fh.kernel_bwd_groups(b)} "
              f"in the CUDA source")


def decode_build(env, da, lib) -> None:
    """The decode kernel's split instances, checked when its build is
    joined (before phase 8)."""
    import torch

    # the decode kernel's split instances (<q's dtype, lanes per row,
    # vectors a lane>; decode_split_q8_kernel: int8 K/V on q's dtype's
    # lanes), each at its largest head dim and a cache of 256 rows
    env["decode_split_instances"] = ptxas_instances(lib, "decode_split")
    for name, info in sorted(env["decode_split_instances"].items()):
        dt, lanes, vecs = name.split("<")[1][:-1].split(",")
        f32, q8 = dt == "f32", "_q8_" in name
        info["head_dim"] = int(lanes) * int(vecs) * (4 if f32 else 8)
        info.update(da.split_info(torch.float32 if f32 else torch.bfloat16,
                                  info["head_dim"], 256, q8=q8))
        print(f"   {name} (Dh {info['head_dim']}): {info['registers']} registers, spill "
              f"stores {info['spill_stores']} B; {info['static_smem']} B of static shared "
              f"memory, {info['blocks_per_sm']} blocks per SM, clusters of "
              f"{info['cluster']}, {info['active_clusters']} at once")
    n_q8 = sum("_q8_" in n for n in env["decode_split_instances"])
    check(len(env["decode_split_instances"]) == 26 and n_q8 == 13,
          f"decode split instances {sorted(env['decode_split_instances'])}")


def flash_build(env, fa, lib) -> None:
    """The flash kernels' tensor-core instances, checked when their build is
    joined (before phase 12)."""
    import torch

    # the tensor-core instances: dq and dkv per padded head dim, the
    # forward's mma.sync ones (16, 32, 128) and its wgmma one (64)
    env["mma_instances"] = {n: i for n, i in ptxas_instances(lib, "_mma_").items()
                            if "quant" not in n}
    env["mma_instances"].update(ptxas_instances(lib, "_wgmma_"))
    for name, info in sorted(env["mma_instances"].items()):
        dp = int(name.split("<")[1][:-1])
        info.update(fa.mma_info(name.split("_mma")[0].split("_wgmma")[0], dp))
        print(f"   {name}: {info['registers']} registers, spill stores "
              f"{info['spill_stores']} B, spill loads {info['spill_loads']} B; "
              f"{info['smem_bytes']} B of dynamic shared memory, {info['blocks_per_sm']} "
              f"blocks per SM")
    check(len(env["mma_instances"]) == 12, f"mma instances {sorted(env['mma_instances'])}")
    # the quantized forward's 8-bit tensor-core instances <o's dtype,
    # int8 (1) or e4m3 (0), padded head dim>
    env["quant_mma_instances"] = ptxas_instances(lib, "quant_mma")
    for name, info in sorted(env["quant_mma_instances"].items()):
        out, int8, dp = name.split("<")[1][:-1].split(",")
        info.update(fa.mma_info("flash_fwd_quant", int(dp),
                                out_dtype=torch.float32 if out == "f32" else torch.bfloat16,
                                fmt="int8" if int8 == "1" else "fp8"))
        print(f"   {name}: {info['registers']} registers, spill stores "
              f"{info['spill_stores']} B, spill loads {info['spill_loads']} B; "
              f"{info['smem_bytes']} B of dynamic shared memory, {info['blocks_per_sm']} "
              f"blocks per SM")
    check(len(env["quant_mma_instances"]) == 12,
          f"quantized mma instances {sorted(env['quant_mma_instances'])}")


def memoize_synthetic() -> None:
    """Make the port's synthetic CIFAR-10 splits once per process: the
    phases' many in-process CLI runs and engines at 50,000 rows then share
    one copy of each (seeded, so the same bits; nothing writes into a
    split) instead of generating it again each time."""
    from distributed_neural_network_tpu_torch.data import cifar10
    from distributed_neural_network_tpu_torch.train import cli

    load, memo = cifar10.load_split, {}

    @functools.wraps(load)
    def load_split(train, **kw):
        if kw.get("source") != "synthetic":
            return load(train, **kw)
        key = (train, tuple(sorted(kw.items())))
        if key not in memo:
            memo[key] = load(train, **kw)
        return memo[key]

    cifar10.load_split = cli.load_split = load_split


# -------------------------------------------------------------------- phases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from distributed_neural_network_tpu_torch.ops import _nvcc
    from distributed_neural_network_tpu_torch.ops import decode_attention as da
    from distributed_neural_network_tpu_torch.ops import flash_attention as fa
    from distributed_neural_network_tpu_torch.ops import fused_head as fh

    dev = torch.device("cuda")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    memoize_synthetic()
    kernels = {
        "fused_mlp3_fwd": {"route": "cuda", "replaces":
                           "distributed_neural_network_tpu/ops/pallas_kernels.py:62"},
        "fused_mlp3_bwd": {"route": "cuda", "replaces":
                           "distributed_neural_network_tpu/ops/pallas_kernels.py:84"},
        "fused_mlp3_bwd_reduce": {"route": "cuda", "replaces":
                                  "distributed_neural_network_tpu/ops/pallas_kernels.py:84"},
    }
    for k in kernels.values():
        k["source"] = "distributed_neural_network_tpu_torch/csrc/fused_mlp3.cu"
    for name, line in (("decode_attention", 95), ("decode_attention_q8", 133)):
        kernels[name] = {"route": "cuda", "replaces": f"{DECODE}:{line}",
                         "source": "distributed_neural_network_tpu_torch/csrc/decode_attention.cu"}
    for name, line in (("flash_fwd", 157), ("flash_fwd_quant", 280), ("flash_dq", 414),
                       ("flash_dkv", 447)):
        kernels[name] = {"route": "cuda", "replaces": f"{FLASH}:{line}",
                         "source": "distributed_neural_network_tpu_torch/csrc/flash_attention.cu"}

    with phase("1 environment"):
        print(f"card: {smi}")
        try:
            import triton

            triton_v = triton.__version__
        except ImportError:
            triton_v = "absent"
        nvcc = run([_nvcc.nvcc(), "--version"]).splitlines()
        env = {"card": smi, "versions": f"python {sys.version.split()[0]}, torch "
               f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc "
               f"{nvcc[-1] if nvcc else '?'}, triton {triton_v}"}
        print(env["versions"])
        print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    with phase("2 build"):
        # every CUDA source's nvcc and the stream's native batcher (g++, phase
        # 18) start together; the phases wait for a kernel's build only where
        # they first launch it: the head kernels here, the decode kernel
        # before phase 8, the flash kernels before phase 12
        t0 = time.perf_counter()
        from distributed_neural_network_tpu_torch import native

        build_pool = ThreadPoolExecutor(4)
        batcher = build_pool.submit(native.available)
        builds = {m: build_pool.submit(timed_build, mod)
                  for m, mod in (("head", fh), ("decode", da), ("flash", fa))}
        env.update(build_s_each={}, ptxas=[])
        head_build(env, fh, join_build(env, "head", builds["head"]))
        fh._lib()
        env["build_s"] = time.perf_counter() - t0

    with phase("3 kernels vs plain"), uncounted(fh.LAUNCHES):
        # comparison launches are not main-path launches; each (N, B) on its
        # own inputs per replica: one forward and one backward launch for all
        # N, the reduce only where a replica has more than one group
        for n, b in HEAD_CASES:
            args = head_inputs(torch, b, dev, seed=b, n=n)
            out_k = fh.mlp3_forward(*args, residuals=True)
            out_r = fh.mlp3_forward_reference(*args)
            assert_close(torch, f"fwd (N {n}, B {b})", out_k, out_r)
            again = fh.mlp3_forward(*args, residuals=True)
            check(all(torch.equal(a, c) for a, c in zip(out_k, again)),
                  f"forward is not bitwise reproducible at (N {n}, B {b})")
            check(torch.equal(fh.mlp3_forward(*args, residuals=False)[0], out_k[0]),
                  f"forward logits differ without residuals at (N {n}, B {b})")
            x, w1, b1, w2, b2, w3, b3 = args
            gout = torch.randn(n, b, 10, device=dev,
                               generator=torch.Generator(dev).manual_seed(b))
            _, h1, h2 = out_r
            part_k = fh.mlp3_bwd_partials(gout, x, h1, h2, w1, w2, w3)
            part_r = fh.mlp3_bwd_partials_reference(gout, x, h1, h2, w1, w2, w3)
            groups = fh.bwd_groups(b)
            check(part_k[1].shape == (n, groups, fh.GRAD_SIZE),
                  f"backward sums {tuple(part_k[1].shape)} at (N {n}, B {b})")
            assert_close(torch, f"bwd (N {n}, B {b})", part_k, part_r)
            check(all(torch.equal(a, c) for a, c in zip(
                part_k, fh.mlp3_bwd_partials(gout, x, h1, h2, w1, w2, w3))),
                  f"backward is not bitwise reproducible at (N {n}, B {b})")
            errs = {"fused_mlp3_fwd": max_err(torch, out_k, out_r),
                    "fused_mlp3_bwd": max_err(torch, part_k, part_r)}
            before = fh.LAUNCHES["fused_mlp3_bwd_reduce"]
            full = fh.mlp3_backward(gout, x, h1, h2, w1, w2, w3)
            reduces = fh.LAUNCHES["fused_mlp3_bwd_reduce"] - before
            check(reduces == (groups > 1),
                  f"(N {n}, B {b}), {groups} groups: {reduces} reduce launches")
            check(all(torch.equal(a, c) for a, c in zip(
                full, fh.mlp3_backward(gout, x, h1, h2, w1, w2, w3))),
                  f"the whole backward is not bitwise reproducible at (N {n}, B {b})")
            if groups > 1:
                red_k = fh.mlp3_bwd_reduce(part_r[1])
                red_r = part_r[1].sum(1)
                assert_close(torch, f"reduce (N {n}, B {b})", red_k, red_r)
                errs["fused_mlp3_bwd_reduce"] = max_err(torch, red_k, red_r)
            # forward and all 7 gradients through autograd
            leaves = [a.clone().requires_grad_() for a in args]
            grads_k = torch.autograd.grad(fh.fused_mlp3(*leaves), leaves, gout)
            grads_r = torch.autograd.grad(fh.mlp3_reference(*leaves), leaves, gout)
            assert_close(torch, f"autograd (N {n}, B {b})", grads_k, grads_r)
            print(f"(N {n}, B {b:5d}) {groups:2d} groups, {reduces} reduce launches: max_abs_err "
                  f"{errs}  grads {max_err(torch, grads_k, grads_r):.3g}")
            if (n, b) == HEAD_MAIN:
                for name in ("fused_mlp3_fwd", "fused_mlp3_bwd"):
                    kernels[name]["max_abs_err"] = errs[name]
            if (n, b) == REDUCE_SHAPE:
                kernels["fused_mlp3_bwd_reduce"]["max_abs_err"] = errs["fused_mlp3_bwd_reduce"]
        print("forward, backward and the whole backward bitwise reproducible at every (N, B); "
              "the reduce launched exactly where a replica has more than one group")

    with phase("4 oracle on the card"):
        import numpy as np
        from oracle_numpy import reference_trajectory

        from distributed_neural_network_tpu_torch.data.cifar10 import load_split
        from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

        split = load_split(True, source="synthetic", synthetic_size=512, seed=3)
        test = load_split(False, source="synthetic", synthetic_size=128, seed=3)
        cfg = TrainConfig(**CNN_SMALL)
        eng = Engine(cfg, split, test, device=dev)
        orders = [[eng.default_order(e, d).numpy() for d in range(4)] for e in range(2)]
        oracle = reference_trajectory(
            eng.state_tree()["params"], split.images, split.labels, n_workers=4,
            batch_size=16, epochs=2, lr=cfg.lr, momentum=cfg.momentum, orders=orders,
        )
        # the same programs run eagerly on the card (the engine's private
        # hook), a second graphed run, and a 2-epoch fused span
        twin, eager, span = (Engine(cfg, split, test, device=dev) for _ in range(3))
        eager._capture = False
        got = {"graphed": [], "twin": [], "eager": []}
        for e in range(2):
            for name, engine in (("graphed", eng), ("twin", twin), ("eager", eager)):
                got[name].append(engine.run_epoch(e))
            m = got["graphed"][-1]
            params = eng.state_tree()["params"]
            rel = max(
                float(np.max(np.abs(params[l][k] - oracle[e]["params"][l][k])
                             / (np.abs(oracle[e]["params"][l][k]) + 1e-3)))
                for l in params for k in params[l]
            )
            dl = abs(m.train_loss - oracle[e]["train_loss"])
            print(f"epoch {e}: train loss {m.train_loss:.6f} (oracle "
                  f"{oracle[e]['train_loss']:.6f}, |d| {dl:.2e}), params max-rel {rel:.2e}, "
                  f"val acc {m.val_acc:.2f} %")
            check(dl < 5e-4, f"epoch {e} train loss off the oracle by {dl}")
            check(rel < 2e-3, f"epoch {e} params off the oracle by max-rel {rel}")
        got["span"] = span.run_span(0, 2)
        check(eng._step.graph is not None and eager._step.graph is None,
              "the engine's programs were not captured (or the eager run's were)")
        state = {name: [*e.params, *e.mom] for name, e in
                 (("graphed", eng), ("twin", twin), ("eager", eager), ("span", span))}
        for name in ("twin", "eager", "span"):
            same = got[name] == got["graphed"] and all(
                torch.equal(a, b) for a, b in zip(state[name], state["graphed"]))
            check(same, f"the {name} run differs from the graphed run: {got[name]} "
                        f"against {got['graphed']}")
        print("graphed run bitwise equal to its eager run on the card, to a second graphed "
              "run and to a 2-epoch fused span (params, momentum, every metric)")
        # phases 17-19 hold their runs at this size to this one
        p4 = {"cfg": cfg, "history": got["graphed"], "oracle": oracle,
              "state": [t.clone() for t in (*eng.params, *eng.mom)],
              "params": eng.state_tree()["params"]}

    full = ["--regime", "data_parallel", "--nb-proc", "4", "--data", "synthetic",
            "--synthetic-size", "50000", "--epochs", "2", "--batch-size", "16",
            "--lr", "0.01", "--log-dir", os.path.join(ROOT, "chiprun_out", "log")]
    main_path = {}
    with phase("5 main path, full width"):
        from distributed_neural_network_tpu_torch.train import cli

        def cnn_run(argv, label):
            lines = []

            def log(line):
                print("   " + line, flush=True)
                lines.append(line)

            for name in fh.LAUNCHES:
                fh.LAUNCHES[name] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(argv, log=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(fh.LAUNCHES)
            check(rc == 0, f"cli.main returned {rc}")
            summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
            losses = [float(l.split(":")[1]) for l in lines
                      if l.startswith("Global Average Training Loss")]
            phases = {key: float(next(l for l in lines if l.startswith(label_)).split(":")[1])
                      for key, label_ in (("train_s", "Time spent on training"),
                                          ("eval_s", "Time spent on evaluation"),
                                          ("sync_s", "Time spent on parent communication"))}
            epochs = int(argv[argv.index("--epochs") + 1])
            images = (50_000 // 4) * 4 * epochs
            r = {"label": label, "wall_s": wall, **phases, "launches": counts,
                 "images_per_s": images / phases["train_s"],
                 "epoch_wall_s": summary["wall_clock_s"] / epochs, "losses": losses,
                 "summary": summary}
            print(f"   {label}: launches {counts}; training {phases['train_s']:.3f} s, sync "
                  f"{phases['sync_s']:.3f} s, eval {phases['eval_s']:.3f} s; "
                  f"{r['images_per_s']:.1f} images/s; epoch wall {r['epoch_wall_s']:.3f} s; "
                  f"final_val_acc {summary['final_val_acc']}")
            check(len(losses) == epochs and losses[-1] < losses[0],
                  f"train loss did not fall: {losses}")
            check(summary["final_val_acc"] is not None and summary["final_val_acc"] >= 50.0,
                  f"final_val_acc {summary['final_val_acc']} < 50")
            return r

        # the checked main-path run first, then torch, then both fused
        want = head_launches(16, 2)
        print(f"   expected launches with the kernels: {want}")
        for fused in (False, True):
            for kern in ("cuda", "torch"):
                label = f"kernels={kern}{' --fused' if fused else ''}"
                r = cnn_run(full + ["--kernels", kern] + (["--fused"] if fused else []), label)
                main_path.setdefault(kern + (" fused" if fused else ""), []).append(r)
                if kern == "cuda":
                    check(r["launches"] == want, f"{label}: launches {r['launches']} != {want}")
                    if not fused:
                        for name, count in r["launches"].items():
                            kernels[name]["launches"] = count
                else:
                    check(not any(r["launches"].values()),
                          f"kernels=torch launched fused kernels: {r['launches']}")
                if fused:
                    check(r["sync_s"] == 0.0 and r["eval_s"] == 0.0,
                          f"{label}: the span's time was not all charged to TRAINING")
        # one point of run_training.sh's sweep (B 1-64), where each replica's
        # batch forms 4 groups and the reduce runs once per step
        sweep = full[:full.index("--batch-size")] + ["--batch-size", "64", "--lr", "0.01",
                                                     "--log-dir", full[-1]]
        r = cnn_run(sweep + ["--kernels", "cuda"], "run_training.sh point, B 64")
        main_path["cuda B 64"] = [r]
        want64 = head_launches(64, 2)
        check(r["launches"] == want64, f"B 64: launches {r['launches']} != {want64}")
        kernels["fused_mlp3_bwd_reduce"]["launches_b64"] = r["launches"]["fused_mlp3_bwd_reduce"]

    times = []
    with phase("6 times"), uncounted(fh.LAUNCHES):
        for n, b in HEAD_TIMED:
            args = head_inputs(torch, b, dev, seed=7, n=n)
            x, w1, b1, w2, b2, w3, b3 = args
            _, h1, h2 = fh.mlp3_forward_reference(*args)
            g = torch.randn(n, b, 10, device=dev)
            sums = fh.mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3)[1]
            leaves = [a.clone().requires_grad_() for a in args]

            def lib_fwd():
                hh1 = torch.baddbmm(b1.unsqueeze(1), x, w1).relu_()
                hh2 = torch.baddbmm(b2.unsqueeze(1), hh1, w2).relu_()
                return torch.baddbmm(b3.unsqueeze(1), hh2, w3)

            def lib_leaves_fwd(ls=leaves):
                lh1 = torch.baddbmm(ls[2].unsqueeze(1), ls[0], ls[1]).relu()
                lh2 = torch.baddbmm(ls[4].unsqueeze(1), lh1, ls[3]).relu()
                return torch.baddbmm(ls[6].unsqueeze(1), lh2, ls[5])

            lib_out = lib_leaves_fwd()

            def lib_fwd_bwd():
                # fresh leaves and a fresh graph on the capturing stream: the
                # autograd engine then never waits on another stream
                ls = [a.detach().requires_grad_() for a in args]
                return torch.autograd.grad(lib_leaves_fwd(ls), ls, g)

            def lib_bwd_device_ms():
                # the backward's device time is forward + backward, both
                # captured, less the forward alone
                both = graph_ms(torch, lib_fwd_bwd)
                fwd = graph_ms(torch, lambda: lib_leaves_fwd([a.detach() for a in args]))
                return None if both is None or fwd is None else both - fwd

            work = head_work(n, b, fh)
            rows = {
                "fused_mlp3_fwd": (
                    lambda: fh.mlp3_forward(*args, residuals=True),
                    lambda: fh.mlp3_forward_reference(*args),
                    lib_fwd, None, work["fwd"]),
                "fused_mlp3_bwd": (
                    lambda: fh.mlp3_bwd_partials(g, x, h1, h2, w1, w2, w3),
                    lambda: fh.mlp3_bwd_partials_reference(g, x, h1, h2, w1, w2, w3),
                    lambda: torch.autograd.grad(lib_out, leaves, g, retain_graph=True),
                    lib_bwd_device_ms, work["bwd"]),
            }
            if fh.bwd_groups(b) > 1:
                # the group rows are read from HBM, as the bound counts
                # them: one set of rows, replayed, would sit in L2
                cold = l2_cold(torch, sums)
                rows["fused_mlp3_bwd_reduce"] = (
                    lambda: fh.mlp3_bwd_reduce(cold()), lambda: cold().sum(1),
                    lambda: torch.sum(cold(), 1), None, work["reduce"])
            for name, (kern_fn, plain_fn, lib_fn, lib_dev, (nbytes, flops)) in rows.items():
                t_k, t_p, t_l = (time_ms(torch, f) for f in (kern_fn, plain_fn, lib_fn))
                d_k, d_p = (graph_ms(torch, f) for f in (kern_fn, plain_fn))
                d_l = lib_dev() if lib_dev else graph_ms(torch, lib_fn)
                bms, by = bound_ms(nbytes, flops)
                print(f"(N {n}, B {b:5d}) {name:22s} per call: kernel {t_k:.5f} ms  plain "
                      f"{t_p:.5f} ms  library {t_l:.5f} ms | device (graph): kernel {fmt(d_k)} ms"
                      f"  plain {fmt(d_p)} ms  library {fmt(d_l)} ms | bound {bms:.6f} ms "
                      f"({by}: {nbytes} B, {flops} FLOP)")
                times.append({"N": n, "B": b, "name": name, "ms": t_k, "plain_ms": t_p,
                              "library_ms": t_l, "graph_ms": d_k, "plain_graph_ms": d_p,
                              "library_graph_ms": d_l, "bound_ms": bms, "bound_by": by,
                              "groups": fh.bwd_groups(b)})
                if (n, b) == (HEAD_MAIN if name != "fused_mlp3_bwd_reduce" else REDUCE_SHAPE):
                    kernels[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                         bound_ms=bms, bound_by=by, graph_ms=d_k)
            for name, what in (("fused_mlp3_fwd", "the baddbmm chain's"),
                               ("fused_mlp3_bwd", "the autograd backward's")):
                t = next(t for t in times if (t["N"], t["B"], t["name"]) == (n, b, name))
                ratio = (t["graph_ms"] / t["library_graph_ms"]
                         if t["graph_ms"] and t["library_graph_ms"] else None)
                t["ratio"] = ratio
                print(f"(N {n}, B {b:5d}) {name}: device {fmt(t['graph_ms'])} ms, "
                      f"{fmt(ratio)}x {what}")
                if (n, b) == HEAD_MAIN:
                    check(ratio is not None and ratio <= 1.0,
                          f"{name}'s device time at (N {n}, B {b}) is {fmt(ratio)}x {what}")
            if b == 4096:
                whole = graph_ms(torch, lambda: fh.mlp3_backward(g, x, h1, h2, w1, w2, w3))
                kern = next(t["graph_ms"] for t in times
                            if (t["N"], t["B"], t["name"]) == (n, b, "fused_mlp3_bwd"))
                on_path = None if None in (whole, kern) else whole - kern
                old = ceil(b, fh.BWD_TILE_ROWS) * fh.GRAD_SIZE * 4
                new = fh.bwd_groups(b) * fh.GRAD_SIZE * 4
                env["b4096"] = {"whole_backward_graph_ms": whole, "old_partial_bytes": old,
                                "partial_bytes": new, "reduce_on_path_graph_ms": on_path}
                if (n, b) == REDUCE_SHAPE:
                    kernels["fused_mlp3_bwd_reduce"]["on_path_graph_ms"] = on_path
                print(f"(N {n}, B {b}) whole backward (kernel + reduce) {fmt(whole)} ms, the "
                      f"reduce's share of it {fmt(on_path)} ms (its rows just written, in L2); "
                      f"rows of sums written and read back: {new} B ({fh.bwd_groups(b)} "
                      f"groups) against {old} B (one row per 16-row tile)")
        # the replicas' convolutions: one grouped conv per layer (the model's)
        # against one conv per replica, forward + weight/input gradients, at
        # the main path's (N 4, B 16)
        gen = torch.Generator().manual_seed(0)
        cx = torch.randn(16, 4 * 3, 32, 32, generator=gen).to(dev)
        cw = [(torch.randn(4 * co, ci, 5, 5, generator=gen) * 0.1).to(dev).requires_grad_()
              for co, ci in ((6, 3), (16, 6))]
        cb = [torch.zeros(4 * co, device=dev, requires_grad=True) for co in (6, 16)]

        def convs(per_replica):
            h = cx
            for w, bias in zip(cw, cb):
                if per_replica:
                    ci, co = w.shape[1], w.shape[0] // 4
                    h = torch.cat([torch.nn.functional.conv2d(
                        h[:, d * ci:(d + 1) * ci], w[d * co:(d + 1) * co],
                        bias[d * co:(d + 1) * co]) for d in range(4)], 1)
                else:
                    h = torch.nn.functional.conv2d(h, w, bias, groups=4)
                h = torch.nn.functional.max_pool2d(torch.relu(h), 2)
            return torch.autograd.grad(h.square().sum(), [*cw, *cb])

        conv = {"grouped_graph_ms": graph_ms(torch, lambda: convs(False)),
                "per_replica_graph_ms": graph_ms(torch, lambda: convs(True))}
        env["convs"] = conv
        print(f"convs of 4 replicas at B 16, forward + backward, device (graph): grouped "
              f"{fmt(conv['grouped_graph_ms'])} ms, one per replica "
              f"{fmt(conv['per_replica_graph_ms'])} ms")
        for kern, runs in main_path.items():
            for r in runs:
                print(f"main path {r['label']}: epoch wall {r['epoch_wall_s']:.3f} s, training "
                      f"{r['train_s']:.3f} s, {r['images_per_s']:.1f} images/s, final_val_acc "
                      f"{r['summary']['final_val_acc']:.2f} %")

    profile = {}
    with phase("7 where the time goes"), uncounted(fh.LAUNCHES):
        from distributed_neural_network_tpu_torch.data.cifar10 import load_split
        from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

        split = load_split(True, source="synthetic", synthetic_size=50_000, seed=0)
        test = load_split(False, source="synthetic", synthetic_size=10_000, seed=0)
        cfg = TrainConfig(lr=0.01, batch_size=16, nb_proc=4, kernels="cuda")
        eng = Engine(cfg, split, test, device=dev)
        eng.run_epoch(0)  # captures the programs
        steps = ceil(50_000 // 4, 16)
        profile = dict(profiled_epoch(torch, eng, 1), steps=steps)
        wall, busy = profile["wall_s"], profile["device_busy_s"]
        print(f"one graphed epoch at full width (4 workers x 12,500 rows, {steps} steps, eval "
              f"of 10,000 rows): wall {wall:.3f} s ({1e3 * wall / steps:.3f} ms/step), device "
              f"busy {busy:.3f} s (the union of the device intervals; their sum "
              f"{profile['kernel_sum_s']:.3f} s), idle share "
              f"{'not measured' if not busy else f'{1 - busy / wall:.3f}'}")
        for key, us, count in profile["top"]:
            print(f"   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
        del eng, split, test

    with phase("8 decode kernels vs plain"), uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
        decode_build(env, da, join_build(env, "decode", builds["decode"]))
        da._lib()
        # comparison launches are not main-path launches
        g = torch.Generator(dev).manual_seed(0)
        n_checks = 0
        worst, routes = {}, {}
        for kind in ("float32", "bfloat16", "int8"):
            tol = 1e-5 if kind == "float32" else 1.6e-2
            for b in (1, 8):
                for h, d in ((8, 64), (4, 128), (4, 8)):
                    for total in (16, 256, 2048):
                        vec = torch.randint(0, total, (b,), device=dev, generator=g,
                                            dtype=torch.int32)
                        vec[0], vec[-1] = 0, total - 1
                        vecs = [vec] if b > 1 else [vec[:1] * 0, vec[:1] * 0 + total - 1]
                        for layout in DECODE_LAYOUTS:
                            q, k, v, kw = decode_inputs(torch, kind, b, h, d, total, layout,
                                                        dev, g)
                            route = da.decode_route(q, k, v, kw.get("k_scale"))
                            # int8 at Dh 8 is half a 16-byte vector: simt
                            want_route = ("split" if layout != "misaligned"
                                          and (kind != "int8" or d % 16 == 0) else "simt")
                            fn = "decode_attention_q8" if kw else "decode_attention"
                            for pos in (0, total - 1, *vecs):
                                where = (f"{kind} B={b} H={h} Dh={d} total={total} {layout} "
                                         f"pos={pos if isinstance(pos, int) else pos.tolist()}")
                                check(route == want_route,
                                      f"route {route}, the rule says {want_route}: {where}")
                                before = dict(da.ROUTE_LAUNCHES)
                                o1 = da.decode_cache_attention(q, k, v, pos, **kw)
                                o2 = da.decode_cache_attention(q, k, v, pos, **kw)
                                ref = da.decode_attention_plain(q, k, v, pos, **kw)
                                check(torch.equal(o1, o2), f"not bitwise reproducible: {where}")
                                err = max_err(torch, o1.float(), ref.float())
                                check(torch.allclose(o1.float(), ref.float(), atol=tol, rtol=tol),
                                      f"kernel vs plain max abs err {err}: {where}")
                                # the bits may not depend on the cache length ...
                                m = int(pos if isinstance(pos, int) else pos.max()) + 1
                                kw_m = {n: t[:, :, :m] for n, t in kw.items()}
                                o3 = da.decode_cache_attention(q, k[:, :, :m], v[:, :, :m], pos,
                                                               **kw_m)
                                check(torch.equal(o1, o3), f"bits change with the cache length: {where}")
                                calls = 3
                                if b > 1:
                                    # ... nor on the batch: row 3 alone in a batch of 1
                                    kw_1 = {n: t[3:4] for n, t in kw.items()}
                                    o4 = da.decode_cache_attention(
                                        q[3:4].contiguous(), k[3:4], v[3:4],
                                        pos if isinstance(pos, int) else pos[3:4], **kw_1)
                                    check(torch.equal(o4, o1[3:4]),
                                          f"bits change with the batch: {where}")
                                    calls = 4
                                ran = {key: n_ - before[key] for key, n_ in da.ROUTE_LAUNCHES.items()}
                                want = {key: calls if key == f"{fn}_{route}" else 0 for key in ran}
                                check(ran == want, f"route launches {ran} != {want}: {where}")
                                if kw and route == "split":
                                    # the int8 split route is the bf16 split route on
                                    # the dequantized cache, bit for bit
                                    kd, vd = ((t.float() * kw[n][..., None]).to(q.dtype)
                                              for t, n in ((k, "k_scale"), (v, "v_scale")))
                                    check(torch.equal(o1, da.decode_cache_attention(q, kd, vd, pos)),
                                          f"int8 split differs from bf16 split on the "
                                          f"dequantized cache: {where}")
                                worst[kind] = max(worst.get(kind, 0.0), err)
                                routes[kind, route] = routes.get((kind, route), 0) + 1
                                if (h, d) == (8, 64) and total <= 256 and layout != "misaligned":
                                    worst[kind, "main"] = max(worst.get((kind, "main"), 0.0), err)
                                n_checks += 1
        torch.cuda.synchronize()
        # the split rule as the CUDA source computes it
        mism = [(n, d) for d in (4, 8, 16, 24, 64, 128, 256) for n in range(0, 4200, 3)
                if da.kernel_piece_rows(n, d) != da.piece_rows(n, d)]
        check(not mism, f"decode_pieces disagrees with the CUDA source at (n, Dh) {mism[:5]}")
        plain_same = plain_invariance(torch, da, dev, g)
        kernels["decode_attention"]["max_abs_err"] = worst["bfloat16", "main"]
        kernels["decode_attention_q8"]["max_abs_err"] = worst["int8", "main"]
        print(f"{n_checks} cases within tolerance, each on the route the rule gives "
              f"({', '.join(f'{k} {r}: {n}' for (k, r), n in sorted(routes.items()))}), bitwise "
              f"reproducible and independent of the cache length and the batch; max abs err "
              f"f32 {worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}, int8 "
              f"{worst['int8']:.3g} (at B<=8, H=8, Dh=64, total<=256, aligned: bf16 "
              f"{worst['bfloat16', 'main']:.3g}, int8 {worst['int8', 'main']:.3g}); "
              f"decode_pieces agrees with the CUDA source; the plain version gives one row "
              f"the same bits in {plain_same} surroundings (cache of 48 and 2048 columns, "
              f"alone and in a batch of 8, contiguous and transposed; bf16 and int8 K/V)")

    serving = []
    with phase("9 serving main path, full width"):
        import numpy as np

        from distributed_neural_network_tpu_torch.models import transformer as tfm
        from distributed_neural_network_tpu_torch.serve.http import build_server

        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 256, size=PROMPT_LENS[i % 3]).tolist()
                   for i in range(N_REQUESTS)]
        arrivals = np.cumsum(rng.exponential(1.0 / RATE, size=N_REQUESTS)).tolist()
        # the engine prefills all but a prompt's last token, in whole chunks
        chunk = int(SERVE_ARGS[SERVE_ARGS.index("--prefill-chunk") + 1])
        want_pre = sum(ceil(len(p) - 1, chunk) for p in prompts)
        t0 = time.perf_counter()
        with uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
            oracle = Oracle(torch, tfm, prompts, dev)
            ties = oracle.near_ties()
        print(f"offline bf16 generate() oracle for {N_REQUESTS} prompts in "
              f"{time.perf_counter() - t0:.2f} s; {ties:.4f} of its greedy choices have a "
              f"top-2 logit gap under 0.02")
        # the main path's four runs, graphed, and the kernel route's two
        # again with the engine run eagerly (its `_capture` hook; warmed up
        # eagerly before any request), for the graphs' end-to-end effect
        for precision, impl, mode in (("bf16", "cuda", "graphed"), ("bf16", "cuda", "eager"),
                                      ("bf16", "torch", "graphed"),
                                      ("int8-kv", "cuda", "graphed"),
                                      ("int8-kv", "cuda", "eager"),
                                      ("int8-kv", "torch", "graphed")):
            main_run = mode == "graphed"
            args = SERVE_ARGS if main_run else [a for a in SERVE_ARGS if a != "--warmup"]
            srv, sched, eng = build_server(
                args + ["--precision", precision, "--decode-impl", impl],
                log=lambda line: print("   " + line, flush=True))
            if not main_run:
                eng._capture = False
                eng.warmup()
            try:
                for counters in (da.LAUNCHES, da.ROUTE_LAUNCHES):
                    for name in counters:
                        counters[name] = 0
                calls0, pre0, ticks0 = eng.decode_calls, eng.prefill_calls, eng.ticks
                torch.cuda.synchronize()
                results = open_loop(srv.port, prompts, arrivals)
                torch.cuda.synchronize()
                launches, by_route = dict(da.LAUNCHES), dict(da.ROUTE_LAUNCHES)
                calls, ticks = eng.decode_calls - calls0, eng.ticks - ticks0
                pre_calls = eng.prefill_calls - pre0
            finally:
                rec = sched.close()  # finalize asserts the ledger's conservation
                srv.close()
            done = [r for r in results
                    if r.get("done") and r["done"].get("status") == "done"
                    and len(r["tokens"]) == MAX_NEW]
            served = [r.get("tokens", []) for r in results]
            same_route = None
            with uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
                strict, agree, stream_agree = oracle.agreement(served)
                if (precision, impl) == ("bf16", "torch"):
                    # the plain route's own contract: generate() on the same
                    # route (generate() has no int8 K/V, so bf16 only)
                    same_route = dict(zip(("strict_agreement", "agreement",
                                           "stream_agreement"),
                                          oracle.agreement(served, impl="torch")))
            n_tok = sum(len(r.get("tokens", [])) for r in results)
            window = max(r["t_done"] for r in results) - min(r["t0"] for r in results)
            ttft = [r["stamps"][0] - r["t0"] for r in results if r.get("stamps")]
            gaps = [b - a for r in results for a, b in zip(r["stamps"], r["stamps"][1:])]
            step_s = rec["goodput_s"] + rec["badput_s"]["prefill"] + rec["badput_s"][
                "kv_alloc_stall"]
            conserved = abs(rec["goodput_s"] + sum(rec["badput_s"].values())
                            - rec["wall_s"]) <= 1e-5 * max(rec["wall_s"], 1.0)
            row = {"precision": precision, "decode_impl": impl, "mode": mode,
                   "completed": len(done),
                   "agreement": agree, "strict_agreement": strict,
                   "stream_agreement": stream_agree, "tokens": n_tok,
                   "req_per_s": len(done) / window, "tokens_per_s": n_tok / window,
                   "ttft_p50_s": pct(ttft, 0.5), "ttft_p99_s": pct(ttft, 0.99),
                   "intertoken_p99_s": pct(gaps, 0.99), "ticks": ticks,
                   "decode_calls": calls, "prefill_calls": pre_calls, "step_ms_per_tick": 1e3 * step_s / max(ticks, 1),
                   "goodput_ratio": rec["goodput_ratio"], "launches": launches,
                   "launches_by_route": by_route, "same_route": same_route,
                   "badput_s": rec["badput_s"], "wall_s": rec["wall_s"]}
            serving.append(row)
            print(f"   {precision:7s} {impl:5s} {mode:7s}: {len(done)}/{N_REQUESTS} done, agreement "
                  f"per token {agree:.4f} (strict {strict:.4f}), stream {stream_agree:.4f} "
                  f"over {n_tok} tokens; "
                  f"{row['req_per_s']:.3f} req/s, "
                  f"{row['tokens_per_s']:.1f} tokens/s; TTFT p50 {row['ttft_p50_s']:.4f} s "
                  f"p99 {row['ttft_p99_s']:.4f} s; inter-token p99 "
                  f"{row['intertoken_p99_s']:.4f} s; {row['step_ms_per_tick']:.3f} ms per "
                  f"engine tick ({ticks} ticks, {calls} decode calls, {pre_calls} prefill "
                  f"calls); goodput ratio "
                  f"{rec['goodput_ratio']}; launches {launches}, by route {by_route}")
            if same_route is not None:
                print(f"   {precision:7s} {impl:5s} against generate(decode_impl=\"torch\"), "
                      f"the same route: per token {same_route['strict_agreement']:.4f} "
                      f"(up to the kernel route's rounding {same_route['agreement']:.4f}), "
                      f"stream {same_route['stream_agreement']:.4f}")
            check(len(done) == N_REQUESTS, f"{len(done)}/{N_REQUESTS} requests completed")
            check(pre_calls == want_pre,
                  f"{pre_calls} prefill calls != {want_pre}, the prompts' chunks of {chunk}")
            check(conserved, f"serving ledger does not conserve: {rec}")
            if not main_run:
                # the eager twin: measured beside the main path, gated on its
                # completion, ledger and launch formula only
                n = (calls + pre_calls) * 8
                name = "decode_attention_q8" if precision == "int8-kv" else "decode_attention"
                check(launches == {k: (n if k == name else 0) for k in launches},
                      f"eager {precision}: decode launches {launches} != (decode calls {calls} "
                      f"+ prefill calls {pre_calls}) x 8 layers")
                continue
            check(agree >= 0.99,
                  f"per-token agreement {agree:.4f} < 0.99 vs offline generate")
            if (precision, impl) == ("bf16", "cuda"):
                # generate()'s arithmetic on the card, so the JAX row's
                # stream form of the gate holds as well
                check(stream_agree >= 0.99,
                      f"stream agreement {stream_agree:.4f} < 0.99 vs offline generate")
            if same_route is not None:
                # the plain route's bits depend on a row's live prefix
                # alone (masked_decode_attention), so the server and
                # generate() on that route give the same tokens
                check(same_route["strict_agreement"] == 1.0
                      and same_route["stream_agreement"] == 1.0,
                      f"--decode-impl torch is not token-exact against generate(decode_impl="
                      f"\"torch\"): per token {same_route['strict_agreement']:.4f}, zipped "
                      f"{same_route['stream_agreement']:.4f}")
            name = "decode_attention_q8" if precision == "int8-kv" else "decode_attention"
            if impl == "cuda":
                n = (calls + pre_calls) * 8
                want = {k: (n if k == name else 0) for k in launches}
                check(calls > 0 and launches == want,
                      f"decode launches {launches} != (decode calls {calls} + prefill calls "
                      f"{pre_calls}) x 8 layers")
                # every launch on the split route (the engine's slab is
                # aligned, Dh 64 is whole 16-byte vectors in bf16 and int8)
                route = f"{name}_split"
                want = {k: (n if k == route else 0) for k in by_route}
                check(by_route == want, f"decode launches by route {by_route} != {want}")
                kernels[name]["launches"] = launches[name]
            else:
                check(not any(launches.values()) and not any(by_route.values()),
                      f"--decode-impl torch launched {launches}")

    decode_times = []
    with phase("10 decode kernel times"), uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
        import torch.nn.functional as F

        g = torch.Generator(dev).manual_seed(1)
        b, total = 8, 256
        for h, d in ((8, 64), (4, 128)):
            for prefix in (64, 256):
                for kind in ("bfloat16", "int8"):
                    q, k, v, kw = decode_inputs(torch, kind, b, h, d, total, "strided", dev, g)
                    pos = torch.full((b,), prefix - 1, dtype=torch.int32, device=dev)
                    mask = (torch.arange(total, device=dev) < prefix)[None, None, None, :]

                    def lib(q=q, k=k, v=v, kw=kw, mask=mask):
                        if kw:
                            k = (k.float() * kw["k_scale"][..., None]).to(q.dtype)
                            v = (v.float() * kw["v_scale"][..., None]).to(q.dtype)
                        return F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask)

                    fns = (lambda q=q, k=k, v=v, kw=kw, pos=pos:
                           da.decode_cache_attention(q, k, v, pos, **kw),
                           lambda q=q, k=k, v=v, kw=kw, pos=pos:
                           da.decode_attention_plain(q, k, v, pos, **kw), lib)
                    t_k, t_p, t_l = (time_ms(torch, f) for f in fns)
                    d_k, d_p, d_l = (graph_ms(torch, f) for f in fns)
                    route = da.decode_route(q, k, v, kw.get("k_scale"))
                    simt = {}
                    if route == "split":
                        # the same values in misaligned views: the simt route
                        # (the one-block kernel) at this shape, in this call
                        mq, mk, mv, _ = decode_inputs(torch, kind, b, h, d, total, "misaligned",
                                                      dev, g)
                        mq.copy_(q), mk.copy_(k), mv.copy_(v)
                        check(da.decode_route(mq, mk, mv, kw.get("k_scale")) == "simt",
                              "phase 10's misaligned copies are not on the simt route")

                        def simt_fn(q=mq, k=mk, v=mv, pos=pos, kw=kw):
                            return da.decode_cache_attention(q, k, v, pos, **kw)

                        simt = {"ms": time_ms(torch, simt_fn), "graph_ms": graph_ms(torch, simt_fn)}
                    kv_bytes = 2 * b * h * prefix * d * (1 if kw else 2)
                    nbytes = kv_bytes + 2 * b * h * d * 2 + b * 4 + (
                        2 * b * h * prefix * 4 if kw else 0)
                    flops = 4 * b * h * prefix * d
                    bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
                    name = "decode_attention_q8" if kw else "decode_attention"
                    decode_times.append({
                        "name": name, "route": route, "B": b, "H": h, "Dh": d, "prefix": prefix,
                        "total": total, "ms": t_k, "graph_ms": d_k, "plain_ms": t_p,
                        "plain_graph_ms": d_p, "library_ms": t_l, "library_graph_ms": d_l,
                        "simt_ms": simt.get("ms"), "simt_graph_ms": simt.get("graph_ms"),
                        "bound_ms": bms, "bound_by": by, "bytes": nbytes, "flops": flops})
                    print(f"{name:20s} B={b} H={h} Dh={d} prefix {prefix:3d} ({route}): per call "
                          f"kernel {t_k:.5f} ms plain {t_p:.5f} ms library {t_l:.5f} ms | device "
                          f"(graph): kernel {fmt(d_k)} ms plain {fmt(d_p)} ms library "
                          f"{fmt(d_l)} ms" + (f" simt route {fmt(simt['graph_ms'])} ms" if simt
                                              else "")
                          + f" | bound {bms:.6f} ms ({by}: {nbytes} B, {flops} FLOP)")
                    if (h, d, prefix) == (8, 64, 256):
                        kernels[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                             bound_ms=bms, bound_by=by, graph_ms=d_k)
                        lib_name = "dequantize + SDPA" if kw else "SDPA"
                        ratio = d_k / d_l if d_k and d_l else None
                        print(f"   {name} split route at (B, H, Dh, prefix) = (8, 8, 64, 256): "
                              f"{fmt(ratio)}x {lib_name}'s device time, "
                              f"{fmt(simt['graph_ms'] / d_k if d_k else None)}x faster than "
                              f"the simt route, {fmt(d_k / bms if d_k else None)}x its bound")
                        check(ratio is not None and ratio <= 1.0,
                              f"{name}'s device time at (8, 8, 64, 256) is {fmt(ratio)}x "
                              f"{lib_name}'s")

    serve_profile = {}
    with phase("11 where the serving time goes"), uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES):
        from distributed_neural_network_tpu_torch.serve.engine import Sequence

        # the engine driven directly (no HTTP), graphed and eager in turns:
        # the grid's capture (or eager warmup) time and its graph pool, then
        # 20 profiled ticks at batch 8
        for precision in ("bf16", "int8-kv"):
            for mode in ("graphed", "eager"):
                eng = serve_engine(precision, "cuda", mode == "graphed")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n_grid = eng.warmup()
                warm_s = time.perf_counter() - t0
                pool = pool_bytes(torch, eng._pool) if eng._pool is not None else None
                rng = np.random.default_rng(5)
                seqs = [Sequence(i, rng.integers(0, 256, size=64).tolist(), 64) for i in range(8)]
                for s_ in seqs:
                    eng.add(s_)
                while any(s_.pos < s_.prompt_len for s_ in seqs):
                    eng.step()
                for _ in range(5):
                    eng.step()
                n_ticks = 20
                prof_row = profiled_window(torch, eng.step, n_ticks, "decode_")
                prof_row.update(ticks=n_ticks, grid=n_grid, warmup_s=warm_s, pool_bytes=pool,
                                programs=eng.compiled_programs())
                serve_profile[f"{precision} {mode}"] = prof_row
                busy, wall = prof_row["device_busy_s"], prof_row["wall_s"]
                calls = {k: v / n_ticks for k, v in prof_row["host_calls"].items()}
                print(f"{precision} {mode}: warmup of the {n_grid}-bucket grid {warm_s:.3f} s"
                      + (f", graph pool {pool} B" if mode == "graphed" else "")
                      + f"; {n_ticks} decode ticks at batch 8 (positions 69-88): wall {wall:.4f} s "
                      f"({1e3 * wall / n_ticks:.3f} ms/tick), device busy {busy:.4f} s, idle share "
                      f"{fmt(prof_row['idle_share'])}; the decode kernel "
                      f"{1e3 * prof_row['part_s']:.3f} ms over {prof_row['part_launches']} "
                      f"launches ({fmt(prof_row['part_share'])} of the kernels' summed time); host "
                      f"calls per tick: graph launches {calls['graph']:.2f}, kernel launches "
                      f"{calls['kernel']:.2f}, async copies {calls['copy']:.2f}")
                for key, us, count in prof_row["top"]:
                    print(f"   {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
                check(prof_row["part_launches"] > 0, f"{precision} {mode}: no decode kernel in "
                      f"the profiled ticks")
                if mode == "graphed":
                    check(calls["graph"] > 0, f"{precision}: no graph launch in the profiled ticks")
                del eng

    with phase("12 flash kernels vs plain"):
        flash_build(env, fa, join_build(env, "flash", builds["flash"]))
        fa._lib()
        batcher.result()
        build_pool.shutdown()
        env["build_s"] = max(env["build_s"], max(env["build_s_each"].values()))
        with uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):  # comparison launches
            n, worst, main_err = flash_vs_plain(torch, fa, dev)
        flash_checks = {"cases": n, "worst": worst, "main": main_err}
        for name in ("flash_fwd", "flash_fwd_quant", "flash_dq", "flash_dkv"):
            kernels[name]["max_abs_err"] = main_err[name]
            kernels[name]["max_abs_err_mesh"] = main_err[f"{name} mesh"]
            if f"{name} remat" in main_err:
                kernels[name]["max_abs_err_remat"] = main_err[f"{name} remat"]
        print(f"{n} cases within tolerance and bitwise reproducible; max abs err over all "
              f"cases {worst}; at the main path's shape (B, S, H, D) = {FLASH_MAIN}, "
              f"(\"... mesh\", the largest) at the mesh's {FLASH_MESH} and (\"... remat\") at "
              f"the remat runs' {FLASH_REMAT}, causal bf16 (the quantized kernel: the larger of "
              f"int8 and fp8, at the first) {main_err}")

    lm_runs, lm_checks = {}, {}
    with phase("13 LM training main path, full width"):
        import numpy as np

        from distributed_neural_network_tpu_torch import lm_train
        from distributed_neural_network_tpu_torch.models import transformer as tfm
        from distributed_neural_network_tpu_torch.train import lm as lmtrain

        # the step replayed from its CUDA graph, and ("flash eager") the same
        # flash run with the step run eagerly (its `_capture` hook)
        runs = (("flash", ["--attn", "flash"], {}, True),
                ("flash eager", ["--attn", "flash"], {}, False),
                ("int8", ["--attn", "flash", "--precision", "int8"], {"quant": True}, True),
                ("fp8", ["--attn", "flash", "--precision", "fp8"], {"quant": True}, True),
                ("plain", ["--attn", "ring"], None, True))
        # each route twice, in mirrored order (flash, flash eager, int8, fp8,
        # plain, plain, fp8, int8, flash eager, flash), so a drift along the
        # call shows and routes are compared in turns
        for name, extra, formula, capture in runs + runs[::-1]:
            row = lm_run(torch, fa, lm_train, LM_STEPS, extra, capture)
            counts = row["launches"]
            first = name not in lm_runs
            lm_runs.setdefault(name, []).append(row)
            loss = row["losses"]
            print(f"   {name}: {row['tokens_per_s']} tokens/s, {row['ms_per_step']:.2f} ms per "
                  f"step (first step {row['first_step_s']:.2f} s), MFU {row['mfu_pct']}% of the "
                  f"bf16 dense peak, losses {loss[0]:.4f} "
                  f"-> {loss[LM_STEPS - 1]:.4f}, peak memory {row['peak_mem_gib']:.2f} GiB, "
                  f"launches {counts}, by route {row['routes']}", flush=True)
            want = (dict.fromkeys(counts, 0) if formula is None
                    else flash_counts(LM_STEPS, **formula))
            check(counts == want, f"{name}: flash launches {counts} != expected {want}")
            check(row["routes"] == mma_counts(want),
                  f"{name}: launches by route {row['routes']} != {mma_counts(want)}")
            if first and name == "flash":
                for key in ("flash_fwd", "flash_dq", "flash_dkv"):
                    kernels[key]["launches"] = counts[key]
            elif first and name == "int8":
                kernels["flash_fwd_quant"]["launches"] = counts["flash_fwd_quant"]
        for name, rows in lm_runs.items():
            steps_ms = ", ".join(f"{r['ms_per_step']:.2f}" for r in rows)
            print(f"   {name}: ms per step {steps_ms} (in the order run)")
        lm_checks["route"] = route_compare(
            torch, fa, tfm, lmtrain, dev, {r: lm_runs[r][0] for r in ("flash", "int8", "fp8")},
            lm_runs["plain"][0])

        # the launch formulas under recomputation, accumulation and eval, at
        # full width for FORMULA_STEPS steps (eval batches from a corpus of
        # random tokens written here and removed after)
        corpus = os.path.join(ROOT, "chiprun_out", "lm_tokens.npy")
        os.makedirs(os.path.dirname(corpus), exist_ok=True)
        np.save(corpus, np.random.default_rng(13).integers(0, 32768, 1 << 20, dtype=np.uint16))
        ev = ["--data-path", corpus, "--eval-every", "2", "--eval-batches", "2"]
        n_ev = {"evals": FORMULA_STEPS // 2, "eval_batches": 2}
        lm_checks["formulas"] = {}
        try:
            for name, extra, formula in (
                    ("--remat", ["--attn", "flash", "--remat"], {"remat": True}),
                    ("--remat-attn", ["--attn", "flash", "--remat-attn"], {"remat": True}),
                    ("--accum-steps 2", ["--attn", "flash", "--accum-steps", "2"], {"accum": 2}),
                    ("eval", ["--attn", "flash"] + ev, n_ev),
                    ("int8 --remat-attn eval", ["--attn", "flash", "--precision", "int8",
                                                "--remat-attn"] + ev,
                     {"quant": True, "remat": True, **n_ev})):
                row = lm_run(torch, fa, lm_train, FORMULA_STEPS, extra)
                want = flash_counts(FORMULA_STEPS, **formula)
                lm_checks["formulas"][name] = {"launches": row["launches"], "want": want,
                                               "routes": row["routes"], "formula": formula}
                print(f"   {name}: launches {row['launches']} (formula {formula}: {want}); "
                      f"by route {row['routes']}", flush=True)
                check(row["launches"] == want,
                      f"{name}: flash launches {row['launches']} != expected {want}")
                check(row["routes"] == mma_counts(want),
                      f"{name}: launches by route {row['routes']} != {mma_counts(want)}")
                check(("evals" not in formula) == (row["eval"] is None)
                      and (row["eval"] is None or math.isfinite(row["eval"]["eval_loss"])),
                      f"{name}: eval {row['eval']}")
        finally:
            os.remove(corpus)

    learn = {}
    with phase("14 learnability"):
        lines = []
        for counters in (fa.LAUNCHES, fa.ROUTE_LAUNCHES):
            for key in counters:
                counters[key] = 0
        rc = lm_train.main(["--device", "cuda", "--steps", "300", "--batch-size", "32",
                            "--seq-len", "16", "--vocab", "32", "--d-model", "32", "--n-heads",
                            "4", "--n-layers", "2", "--d-ff", "64", "--lr", "0.3", "--attn",
                            "flash", "--generate", "7", "--log-every", "100"],
                           log=lambda line: (print("   " + line, flush=True), lines.append(line)))
        counts = dict(fa.LAUNCHES)
        summary = json.loads(next(l for l in lines if l.startswith("SUMMARY "))[8:])
        gens = [l for l in lines if l.startswith("gen[")]
        hits = total = 0
        for g_line in gens:
            prompt = json.loads(g_line.split("prompt=")[1].split(" completion=")[0])
            done = json.loads(g_line.split("completion=")[1])
            # prompt = the first half + its first token again: the rest repeats
            hits += sum(int(a == b) for a, b in zip(done, prompt[1:8]))
            total += len(done)
        learn = {"final_loss": summary["final_loss"], "match": hits / max(total, 1),
                 "launches": counts}
        print(f"copy task: final loss {summary['final_loss']:.4f}, greedy continuation "
              f"matches the repeat on {hits}/{total} positions; launches {counts}")
        check(rc == 0 and len(gens) == 2, "lm_train.main did not generate")
        check(summary["final_loss"] < 0.2, f"final loss {summary['final_loss']} >= 0.2")
        check(hits / max(total, 1) > 0.9, f"continuation match {hits}/{total} <= 0.9")
        check(counts["flash_fwd"] == counts["flash_dq"] == counts["flash_dkv"] == 300 * 2,
              f"learnability launches {counts} != 300 steps x 2 layers")
        # head dim 8 is outside the mma rule: every launch on the simt route
        check(all(n == (600 if key.endswith("_simt") and "quant" not in key else 0)
                  for key, n in fa.ROUTE_LAUNCHES.items()),
              f"learnability launches by route {fa.ROUTE_LAUNCHES}")

    flash_times, flash_pair = [], []
    with phase("15 flash kernel times"), uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        # the library yardstick: the dispatch's `lib` route, one
        # scaled_dot_product_attention(is_causal=True) call on (B, H, S, D) views
        from distributed_neural_network_tpu_torch.ops.flash import flash_local_attention

        g = torch.Generator(dev).manual_seed(15)
        for b, s_, h, d in (FLASH_MAIN, (16, 2048, 4, 128)):
            q, k, v, do = flash_inputs(torch, b, s_, h, d, torch.bfloat16, "contiguous", dev, g)
            o, lse = fa.flash_fwd(q, k, v)
            delta = fa.flash_delta(o, do)
            qc, sq, kc, sk, vc, sv = fa.quantize_qkv(q, k, v, "int8")
            fc, fsq, fkc, fsk, fvc, fsv = fa.quantize_qkv(q, k, v, "fp8")
            # the same values in misaligned views: the simt route (the scalar
            # kernels) at this shape, timed in the same call
            mis = flash_inputs(torch, b, s_, h, d, torch.bfloat16, "misaligned", dev, g)
            for x, y in zip(mis, (q, k, v, do)):
                x.copy_(y)
            mis_codes = misaligned_codes(torch, qc, kc, vc)
            check(fa.bwd_route(q, k, v, do) == fa.fwd_route(q, k, v) == "mma"
                  and fa.bwd_route(*mis) == fa.fwd_route(*mis[:3]) == "simt"
                  and fa.quant_route(qc, kc, vc) == fa.quant_route(fc, fkc, fvc) == "mma"
                  and fa.quant_route(*mis_codes) == "simt",
                  "phase 15's inputs are not on the routes they time")

            def sdpa_fwd():
                return flash_local_attention(q, k, v, impl="lib")

            def sdpa_fwd_bwd():
                ls = [x.detach().requires_grad_() for x in (q, k, v)]
                return torch.autograd.grad(flash_local_attention(*ls, impl="lib"), ls, do)

            lib = {"fwd": (time_ms(torch, sdpa_fwd, iters=50), graph_ms(torch, sdpa_fwd, iters=10)),
                   "fwd_bwd": (time_ms(torch, sdpa_fwd_bwd, iters=50),
                               graph_ms(torch, sdpa_fwd_bwd, iters=10))}
            bwd = tuple(None if fb is None or f is None else fb - f
                        for fb, f in zip(lib["fwd_bwd"], lib["fwd"]))
            work = flash_work(b, s_, h, d)
            rows = {
                "flash_fwd": (lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_fwd_plain(q, k, v),
                              lib["fwd"], PEAK_BF16_FLOPS),
                "flash_fwd simt": (lambda: fa.flash_fwd(*mis[:3]), None, lib["fwd"],
                                   PEAK_BF16_FLOPS),
                "flash_fwd_quant": (
                    lambda: fa.flash_fwd_quant_codes(qc, kc, vc, sq, sk, sv,
                                                     out_dtype=torch.bfloat16),
                    lambda: fa.flash_fwd_quant_plain(qc, kc, vc, sq, sk, sv,
                                                     out_dtype=torch.bfloat16),
                    (None, None), PEAK_INT8_OPS),
                "flash_fwd_quant fp8": (
                    lambda: fa.flash_fwd_quant_codes(fc, fkc, fvc, fsq, fsk, fsv,
                                                     out_dtype=torch.bfloat16),
                    lambda: fa.flash_fwd_quant_plain(fc, fkc, fvc, fsq, fsk, fsv,
                                                     out_dtype=torch.bfloat16),
                    (None, None), PEAK_INT8_OPS),
                "flash_fwd_quant simt": (
                    lambda: fa.flash_fwd_quant_codes(*mis_codes, sq, sk, sv,
                                                     out_dtype=torch.bfloat16),
                    None, (None, None), PEAK_INT8_OPS),
                "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta),
                             lambda: fa.flash_dq_plain(q, k, v, do, lse, delta), bwd,
                             PEAK_BF16_FLOPS),
                "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta),
                              lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta), bwd,
                              PEAK_BF16_FLOPS),
                "flash_dq simt": (lambda: fa.flash_dq(*mis, lse, delta), None, bwd,
                                  PEAK_BF16_FLOPS),
                "flash_dkv simt": (lambda: fa.flash_dkv(*mis, lse, delta), None, bwd,
                                   PEAK_BF16_FLOPS),
            }
            dev_ms = {}
            for name, (kern_fn, plain_fn, (t_l, d_l), peak) in rows.items():
                t_k = time_ms(torch, kern_fn, iters=20, warmup=3)
                d_k = graph_ms(torch, kern_fn, iters=10, replays=3)
                t_p = d_p = None
                if plain_fn is not None:  # the other rows share the mma rows' plain version
                    t_p = time_ms(torch, plain_fn, iters=3, warmup=1)
                    d_p = graph_ms(torch, plain_fn, iters=2, replays=2)
                nbytes, ops = work[name.split()[0]]
                bms, by = bound_ms(nbytes, ops, peak)
                dev_ms[name] = d_k
                flash_times.append({"name": name, "B": b, "S": s_, "H": h, "D": d, "ms": t_k,
                                    "graph_ms": d_k, "plain_ms": t_p, "plain_graph_ms": d_p,
                                    "library_ms": t_l, "library_graph_ms": d_l,
                                    "sdpa_fwd_bwd_ms": lib["fwd_bwd"][0], "bound_ms": bms,
                                    "bound_by": by, "bytes": nbytes, "ops": ops})
                print(f"{name:16s} B={b} S={s_} H={h} D={d}: per call kernel {t_k:.4f} ms plain "
                      f"{fmt(t_p)} ms library {fmt(t_l)} ms | device (graph): kernel {fmt(d_k)} "
                      f"ms plain {fmt(d_p)} ms library {fmt(d_l)} ms | bound {bms:.5f} ms "
                      f"({by}: {nbytes} B, {ops} ops) | kernel/bound {t_k / bms:.1f}x",
                      flush=True)
                if (h, d) == (8, 64) and name in kernels:
                    kernels[name].update(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bms,
                                         bound_by=by, graph_ms=d_k)
            fwd_row = next(t for t in flash_times[::-1] if t["name"] == "flash_fwd")
            if None not in (fwd_row["graph_ms"], lib["fwd"][1]):
                kern = "wgmma" if d == 64 else "mma.sync"
                print(f"forward (B, S, H, D) = ({b}, {s_}, {h}, {d}), device time: flash_fwd "
                      f"{fwd_row['graph_ms']:.4f} ms (mma route, the {kern} kernel), "
                      f"{fwd_row['graph_ms'] / lib['fwd'][1]:.2f}x SDPA's forward "
                      f"({lib['fwd'][1]:.4f} ms) and {fwd_row['graph_ms'] / fwd_row['bound_ms']:.1f}x "
                      f"its bound; the simt route {fmt(dev_ms['flash_fwd simt'])} ms", flush=True)
            quant = {key: dev_ms[key] for key in ("flash_fwd_quant", "flash_fwd_quant fp8",
                                                  "flash_fwd_quant simt")}
            if None not in (*quant.values(), fwd_row["graph_ms"], lib["fwd"][1]):
                q_row = next(t for t in flash_times[::-1] if t["name"] == "flash_fwd_quant")
                print(f"quantized forward (B, S, H, D) = ({b}, {s_}, {h}, {d}), device time: "
                      f"int8 mma {quant['flash_fwd_quant']:.4f} ms, fp8 mma "
                      f"{quant['flash_fwd_quant fp8']:.4f} ms, int8 simt "
                      f"{quant['flash_fwd_quant simt']:.4f} ms; int8 mma is "
                      f"{quant['flash_fwd_quant'] / q_row['bound_ms']:.1f}x its bound, "
                      f"{quant['flash_fwd_quant'] / fwd_row['graph_ms']:.2f}x the bf16 forward "
                      f"({fwd_row['graph_ms']:.4f} ms) and "
                      f"{quant['flash_fwd_quant'] / lib['fwd'][1]:.2f}x SDPA's bf16 forward "
                      f"({lib['fwd'][1]:.4f} ms, for reference: not the same function)",
                      flush=True)
            print(f"   SDPA causal at this shape: forward {lib['fwd'][0]:.4f} ms, forward + "
                  f"backward {lib['fwd_bwd'][0]:.4f} ms per call (library_ms of flash_dq and "
                  f"flash_dkv is SDPA's whole backward, dq, dk and dv together); the quantized "
                  f"kernel has no single PyTorch call for the same function")
            if None not in (dev_ms["flash_dq"], dev_ms["flash_dkv"], bwd[1]):
                pair = {"B": b, "S": s_, "H": h, "D": d, "dq_ms": dev_ms["flash_dq"],
                        "dkv_ms": dev_ms["flash_dkv"],
                        "pair_ms": dev_ms["flash_dq"] + dev_ms["flash_dkv"],
                        "simt_pair_ms": None if None in (dev_ms["flash_dq simt"],
                                                         dev_ms["flash_dkv simt"])
                        else dev_ms["flash_dq simt"] + dev_ms["flash_dkv simt"],
                        "sdpa_bwd_ms": bwd[1]}
                pair["x_sdpa_bwd"] = pair["pair_ms"] / pair["sdpa_bwd_ms"]
                flash_pair.append(pair)
                print(f"backward pair (B, S, H, D) = ({b}, {s_}, {h}, {d}), device time: flash_dq "
                      f"{pair['dq_ms']:.4f} + flash_dkv {pair['dkv_ms']:.4f} = "
                      f"{pair['pair_ms']:.4f} ms (mma route) against SDPA's whole backward "
                      f"{pair['sdpa_bwd_ms']:.4f} ms: {pair['x_sdpa_bwd']:.2f}x; the simt route "
                      f"at this shape {fmt(pair['simt_pair_ms'])} ms", flush=True)
            del q, k, v, do, o, lse, delta, qc, kc, vc, fc, fkc, fvc, mis, mis_codes
            torch.cuda.empty_cache()

    lm_profile = {}
    with phase("16 where the training time goes"), uncounted(fa.LAUNCHES, fa.ROUTE_LAUNCHES):
        from distributed_neural_network_tpu_torch.models import transformer as tfm
        from distributed_neural_network_tpu_torch.train import lm as lmtrain

        cfg = tfm.TransformerConfig(vocab_size=32768, d_model=512, n_heads=8, n_layers=8,
                                    d_ff=2048, dtype=torch.bfloat16)
        toks, tgts = lmtrain.make_copy_task(torch.Generator().manual_seed(1), batch=16,
                                            seq_len=2048, vocab=32768, device=dev)
        # 3 steady steps replayed from the step's graph, then the same eagerly
        for mode in ("graphed", "eager"):
            params = tfm.init_params(0, cfg, dev)
            mom = lmtrain.init_lm_momentum(params)
            step = lmtrain.make_lm_train_step(cfg, device=dev, lr=0.01, attn_impl="flash")
            step._capture = mode == "graphed"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, mom, toks, tgts)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            step(params, mom, toks, tgts)
            n_steps = 3
            prof = profiled_window(torch, lambda: step(params, mom, toks, tgts), n_steps, "flash_")
            graph = step.program.graph
            prof.update(steps=n_steps, first_step_s=first_s,
                        pool_bytes=pool_bytes(torch, graph.pool()) if graph is not None else None)
            lm_profile[mode] = prof
            wall, busy = prof["wall_s"], prof["device_busy_s"]
            calls = {k: v / n_steps for k, v in prof["host_calls"].items()}
            print(f"{mode}: first step {first_s:.3f} s"
                  + (f" (capture incl.), graph pool {prof['pool_bytes']} B" if graph else "")
                  + f"; {n_steps} steady steps at full width (flash, bf16): wall {wall:.3f} s "
                  f"({1e3 * wall / n_steps:.1f} ms/step), device busy {busy:.3f} s, idle share "
                  f"{fmt(prof['idle_share'])}, flash kernels {fmt(prof['part_share'])} of the "
                  f"kernels' summed time; host calls per step: graph launches "
                  f"{calls['graph']:.1f}, kernel launches {calls['kernel']:.1f}, async copies "
                  f"{calls['copy']:.1f}")
            for key, us, count in prof["top"]:
                print(f"   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
            check((graph is not None) == (mode == "graphed"), f"{mode}: graph {graph}")
            del params, mom, step, graph
            torch.cuda.empty_cache()

    across = {}
    with phase("17 across processes"):
        import numpy as np
        import torch.distributed as tdist
        from oracle_numpy import reference_trajectory
        from torch_rank_worker import busy_union, free_port, launch

        from distributed_neural_network_tpu_torch.data.cifar10 import load_split
        from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

        check(TrainConfig(**CNN_SMALL) == p4["cfg"], "phase 4's configuration moved")
        split4 = load_split(True, source="synthetic", synthetic_size=512, seed=3)
        test4 = load_split(False, source="synthetic", synthetic_size=128, seed=3)
        # (a) 2 ranks x 2 workers under gloo on the one card, phase 4's run;
        # the same launch of the ranks runs (d)'s profiled full-width run and
        # phase 22's step-sync runs (a fresh rank process costs seconds)
        out17 = os.path.join(ROOT, "chiprun_out", "ranks17")
        os.makedirs(out17, exist_ok=True)
        spec = {"device": "cuda", "out": out17, "sync": {"n": 4, "p": 62_006 + 1, "seed": 0},
                "runs": [{"name": "phase4", "config": CNN_SMALL,
                          "train": {"size": 512, "seed": 3}, "test": {"size": 128, "seed": 3}},
                         {"name": "full", "profile": True, "config": CNN_SMALL,
                          "train": {"size": 50_000, "seed": 0},
                          "test": {"size": 10_000, "seed": 0}}]
                + [{"name": gs, "config": {**CNN_SMALL, "sync_mode": "step", "grad_sync": gs,
                                           "bucket_mb": 0.01},
                    "train": {"size": 512, "seed": 3}, "test": {"size": 128, "seed": 3}}
                   for gs in ("end", "overlap")]}
        t0 = time.perf_counter()
        procs = launch(2, spec, timeout=600)
        across["gloo_2x2_s"] = time.perf_counter() - t0
        for r, proc in enumerate(procs):
            check(proc.returncode == 0, f"rank {r} exited {proc.returncode}: {proc.stderr[-3000:]}")
        ranks = []
        for r in range(2):
            with open(os.path.join(out17, f"phase4_rank{r}.json")) as f:
                info = json.load(f)
            with open(os.path.join(out17, f"sync_rank{r}.json")) as f:
                sync = json.load(f)
            check(sync["bitwise"] == [True] * 5,
                  f"rank {r}: the gathered sync is not bitwise the in-process one: {sync}")
            check(info["backend"] == "gloo" and info["captured"] and info["workers"] == [2 * r, 2 * r + 1],
                  f"rank {r}: {info}")
            ranks.append((info, dict(np.load(os.path.join(out17, f"phase4_rank{r}.npz")))))
        check(ranks[0][0]["history"] == ranks[1][0]["history"],
              f"the ranks' histories differ: {ranks[0][0]['history']} / {ranks[1][0]['history']}")
        hist, flat = ranks[0]
        final = {l: {k: flat[f"params/{l}/{k}"] for k in p4["params"][l]} for l in p4["params"]}
        want = p4["oracle"]
        for e in range(2):
            dl = abs(hist["history"][e]["train_loss"] - want[e]["train_loss"])
            check(dl < 5e-4, f"2 x 2: epoch {e} train loss off the oracle by {dl}")
        rel = max(float(np.max(np.abs(final[l][k] - want[-1]["params"][l][k])
                               / (np.abs(want[-1]["params"][l][k]) + 1e-3)))
                  for l in final for k in final[l])
        check(rel < 2e-3, f"2 x 2: params off the oracle by max-rel {rel}")
        d_loss = max(abs(h["train_loss"] - m.train_loss)
                     for h, m in zip(hist["history"], p4["history"]))
        d_par = max(float(np.abs(final[l][k] - p4["params"][l][k]).max())
                    for l in final for k in final[l])
        across["gloo_2x2"] = {"oracle_params_max_rel": rel, "d_loss_vs_in_process": d_loss,
                              "d_params_vs_in_process": d_par, "history": hist["history"]}
        print(f"(a) 2 ranks x 2 workers, gloo on one card (the launch with (d) and phase 22's "
              f"runs {across['gloo_2x2_s']:.1f} s with start-up): histories equal on both ranks; the gathered sync bitwise the "
              f"in-process one (5 masks); oracle: params max-rel {rel:.2e}; largest difference "
              f"from phase 4's in-process run: loss {d_loss:.3e}, params {d_par:.3e}")
        # (b) one rank over NCCL holding all 4 workers: the all-reduce is
        # captured in the sync graph; bitwise phase 4's graphed run
        tdist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                 world_size=1, rank=0,
                                 device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            eng1 = Engine(p4["cfg"], split4, test4, device=dev)
            hist1 = [eng1.run_epoch(e) for e in range(2)]
            check(eng1.mesh.joined and tdist.get_backend() == "nccl", "not an NCCL group")
            check(len(eng1._sync.graphs) == 1 and len(eng1._sync.segments) == 1
                  and len(eng1._eval.segments) == 1,
                  "the NCCL all-reduce was not captured in its program's one graph")
            same = hist1 == p4["history"] and all(
                torch.equal(a, b) for a, b in zip((*eng1.params, *eng1.mom), p4["state"]))
            check(same, f"NCCL world 1 differs from phase 4's graphed run: {hist1} / "
                        f"{p4['history']}")
            del eng1
        finally:
            tdist.destroy_process_group()
        print("(b) 1 rank over NCCL, the all-reduce captured in the sync and eval graphs: "
              "bitwise phase 4's graphed run (params, momentum, every metric)")
        # (c) full width through the user's entry point under torchrun
        log17 = os.path.join(ROOT, "chiprun_out", "log17")
        jsonl = os.path.join(log17, "m.jsonl")
        for stale in (jsonl, os.path.join(log17, "m_rank1.jsonl")):
            if os.path.exists(stale):
                os.remove(stale)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
               "2", "-m", "distributed_neural_network_tpu_torch.train.cli", "--regime",
               "data_parallel", "--nb-proc", "4", "--epochs", "2", "--batch-size", "16", "--lr",
               "0.01", "--data", "synthetic", "--synthetic-size", "50000", "--kernels", "cuda",
               "--log-dir", log17,
               "--metrics-jsonl", jsonl]
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        across["torchrun_s"] = time.perf_counter() - t0
        with open(os.path.join(ROOT, "chiprun_out", "phase17_torchrun.log"), "w") as f:
            f.write(proc.stdout + "\n" + proc.stderr)
        check(proc.returncode == 0, f"torchrun exited {proc.returncode}: {proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        summaries = sorted((json.loads(l[8:]) for l in lines if l.startswith("SUMMARY ")),
                           key=lambda s: s["rank"])
        check([s["rank"] for s in summaries] == [0, 1],
              f"SUMMARY lines: {summaries}; stdout ends: {proc.stdout[-3000:]}")
        keys = ("final_train_loss", "final_val_acc", "best_val_acc")
        check([summaries[0][k] for k in keys] == [summaries[1][k] for k in keys],
              f"the ranks' SUMMARY metrics differ: {summaries}")
        want = head_launches(16, 2)
        per_rank = []
        for r, summary in enumerate(summaries):
            check(f"(Multi-process: rank {r}/2, backend gloo, device cuda:0)" in lines,
                  f"rank {r}'s backend line is missing")
            check(summary["head_launches"] == want,
                  f"rank {r}: head launches {summary['head_launches']} != {want}")
            suffix = "" if r == 0 else f"_rank{r}"
            with open(os.path.join(log17, f"m{suffix}.jsonl")) as f:
                events = [json.loads(l) for l in f]
            losses = [e["value"] for e in events if e.get("series") == "train/loss"]
            check(len(losses) == 2 and losses[-1] < losses[0], f"rank {r}: losses {losses}")
            check(summary["final_val_acc"] >= 50.0, f"rank {r}: val acc {summary['final_val_acc']}")
            with open(os.path.join(log17, f"bs16_log_epochs2_proc4_children{suffix}.txt")) as f:
                train_s = float(next(l for l in f if l.startswith("Time spent on training"))
                                .split(":")[1])
            per_rank.append({"train_s": train_s, "wall_clock_s": summary["wall_clock_s"],
                             "losses": losses, "launches": summary["head_launches"]})
        images = (50_000 // 4) * 4 * 2
        across["torchrun"] = {
            "ranks": per_rank, "summary": summaries[0],
            "epoch_wall_s": max(r["wall_clock_s"] for r in per_rank) / 2,
            "images_per_s": images / max(r["train_s"] for r in per_rank)}
        base = main_path["cuda"][0]
        print(f"(c) torchrun, 2 ranks x 2 workers at full width ({across['torchrun_s']:.1f} s "
              f"with start-up): SUMMARY equal on both ranks (final_val_acc "
              f"{summaries[0]['final_val_acc']:.2f} %); launches per rank {want}; epoch wall "
              f"{across['torchrun']['epoch_wall_s']:.3f} s and "
              f"{across['torchrun']['images_per_s']:.1f} images/s, against phase 5's one "
              f"process {base['epoch_wall_s']:.3f} s and {base['images_per_s']:.1f} images/s")
        # (d) the 2 x 2 run at full width once more (in (a)'s launch), its
        # second epoch under the profiler on each rank: the card's idle share
        # over the union of both ranks' device intervals
        traces = []
        for r in range(2):
            with open(os.path.join(out17, f"full_rank{r}.json")) as f:
                traces.append(json.load(f)["trace"])
        wall_us = max(t["end_us"] for t in traces) - min(t["start_us"] for t in traces)
        shares = [busy_union(t["busy"]) / (t["end_us"] - t["start_us"]) for t in traces]
        aligned = all(abs(t["trace_start_us"] - t["start_us"]) < 1e6 for t in traces)
        union = (busy_union([(t["trace_start_us"] + a, t["trace_start_us"] + b)
                             for t in traces for a, b in t["busy"]]) if aligned else None)
        across["profile"] = {"wall_s": wall_us / 1e6, "rank_busy_share": shares,
                             "clocks_aligned": aligned,
                             "device_busy_s": None if union is None else union / 1e6,
                             "idle_share": None if union is None else 1 - union / wall_us}
        print(f"(d) a profiled full-width epoch of 2 ranks x 2 workers: wall "
              f"{wall_us / 1e6:.3f} s, each rank's device-busy share {shares}; the card's "
              f"idle share over both ranks' intervals "
              f"{fmt(across['profile']['idle_share'])}"
              f"{'' if aligned else ' (not measured: the traces clocks differ from the host)'}")
        # the full-width traces are large; the results above keep what they say
        os.remove(os.path.join(out17, "full_rank0.json"))
        os.remove(os.path.join(out17, "full_rank1.json"))

    stream_run = {}
    with phase("18 streaming"):
        from distributed_neural_network_tpu_torch import native

        check(native.available(), "the native batcher did not build on this machine")
        want = head_launches(16, 2)
        r = cnn_run(full + ["--kernels", "cuda", "--input-mode", "stream"], "stream, kernels=cuda")
        check(r["launches"] == want, f"stream: launches {r['launches']} != {want}")
        stream_run["cli"] = r
        # one stream epoch at full width under the profiler, as phase 7
        raw = load_split(True, source="synthetic", synthetic_size=50_000, seed=0,
                         normalize_images=False)
        test = load_split(False, source="synthetic", synthetic_size=10_000, seed=0)
        eng = Engine(TrainConfig(lr=0.01, batch_size=16, nb_proc=4, kernels="cuda",
                                 input_mode="stream"), raw, test, device=dev)
        with uncounted(fh.LAUNCHES):
            eng.compile()  # the graphs captured before the profiled epoch, no warm-up epoch
            stream_run["profile"] = profiled_epoch(torch, eng, 1)
        wall, busy = stream_run["profile"]["wall_s"], stream_run["profile"]["device_busy_s"]
        del eng, raw, test
        hbm = main_path["cuda"][0]
        print(f"stream at full width: {r['images_per_s']:.1f} images/s, epoch wall "
              f"{r['epoch_wall_s']:.3f} s (hbm, phase 5: {hbm['images_per_s']:.1f} images/s, "
              f"{hbm['epoch_wall_s']:.3f} s); a profiled stream epoch: wall {wall:.3f} s, device "
              f"busy {busy:.3f} s, idle share "
              f"{'not measured' if not busy else f'{1 - busy / wall:.3f}'} (hbm, phase 7: "
              f"{fmt(profile.get('idle_share'))})")
        for key, us, count in stream_run["profile"]["top"][:8]:
            print(f"   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
        # at phase 4's size: the oracle on the stream's orders, and the hbm
        # engine fed them
        raw4 = load_split(True, source="synthetic", synthetic_size=512, seed=3,
                          normalize_images=False)
        with uncounted(fh.LAUNCHES):
            seng = Engine(TrainConfig(**CNN_SMALL, input_mode="stream"), raw4, test4, device=dev)
            heng = Engine(TrainConfig(**CNN_SMALL), split4, test4, device=dev,
                          orders=seng.default_order)
            orders = [[seng.default_order(e, d).numpy() for d in range(4)] for e in range(2)]
            oracle = reference_trajectory(seng.state_tree()["params"], split4.images,
                                          split4.labels, n_workers=4, batch_size=16, epochs=2,
                                          lr=0.01, momentum=0.9, orders=orders)
            d_hbm = []
            for e in range(2):
                ms, mh = seng.run_epoch(e), heng.run_epoch(e)
                params = seng.state_tree()["params"]
                rel = max(float(np.max(np.abs(params[l][k] - oracle[e]["params"][l][k])
                                       / (np.abs(oracle[e]["params"][l][k]) + 1e-3)))
                          for l in params for k in params[l])
                dl = abs(ms.train_loss - oracle[e]["train_loss"])
                check(dl < 5e-4 and rel < 2e-3,
                      f"stream epoch {e}: loss off the oracle by {dl}, params by max-rel {rel}")
                d_hbm.append(abs(ms.train_loss - mh.train_loss))
            same = all(torch.equal(a, b) for a, b in zip(seng.params, heng.params))
        stream_run["small"] = {"oracle_params_max_rel": rel, "d_loss_vs_hbm": d_hbm,
                               "bitwise_hbm": same}
        print(f"stream at 512 rows: within the oracle on the stream's orders (params max-rel "
              f"{rel:.2e}); against the hbm engine fed the same orders: loss differences "
              f"{d_hbm}, params bitwise {same}")
        del seng, heng

    bf16_run = {}
    with phase("19 bf16"):
        import torch.nn.functional as F

        want = head_launches(16, 2)
        for kern in ("cuda", "torch"):
            r = cnn_run(full + ["--kernels", kern, "--compute-dtype", "bfloat16"],
                        f"bf16, kernels={kern}")
            check(r["launches"] == (want if kern == "cuda" else dict.fromkeys(want, 0)),
                  f"bf16 {kern}: launches {r['launches']}")
            bf16_run[kern] = r
        # the graphed bf16 run against its eager run, at phase 4's size
        with uncounted(fh.LAUNCHES):
            cfgb = TrainConfig(**CNN_SMALL, compute_dtype="bfloat16")
            graphed, eager = (Engine(cfgb, split4, test4, device=dev) for _ in range(2))
            eager._capture = False
            got_b = {"graphed": [graphed.run_epoch(e) for e in range(2)],
                     "eager": [eager.run_epoch(e) for e in range(2)]}
            check(graphed._step.graph is not None and eager._step.graph is None,
                  "bf16: the programs were not captured (or the eager run's were)")
            same = got_b["graphed"] == got_b["eager"] and all(
                torch.equal(a, b) for a, b in zip((*graphed.params, *graphed.mom),
                                                  (*eager.params, *eager.mom)))
            check(same, f"bf16: the graphed run differs from its eager run: {got_b}")
            del graphed, eager

            # the model's convs at the main path's (N 4, B 16), forward +
            # backward through the casts of the f32 parameters
            def convs_at(dtype):
                ws = [w.detach().clone().requires_grad_() for w in cw]
                bs = [b.detach().clone().requires_grad_() for b in cb]

                def f():
                    h = cx.to(dtype)
                    for w, b in zip(ws, bs):
                        h = F.conv2d(h, w.to(dtype), b.to(dtype), groups=4)
                        h = F.max_pool2d(torch.relu(h), 2)
                    return torch.autograd.grad(h.float().square().sum(), [*ws, *bs])

                return graph_ms(torch, f)

            bf16_run["convs_graph_ms"] = {"float32": convs_at(torch.float32),
                                          "bfloat16": convs_at(torch.bfloat16)}
            # one graphed bf16 epoch at full width under the profiler, as phase 7
            split = load_split(True, source="synthetic", synthetic_size=50_000, seed=0)
            test = load_split(False, source="synthetic", synthetic_size=10_000, seed=0)
            eng = Engine(TrainConfig(lr=0.01, batch_size=16, nb_proc=4, kernels="cuda",
                                     compute_dtype="bfloat16"), split, test, device=dev)
            eng.run_epoch(0)
            bf16_run["profile"] = profiled_epoch(torch, eng, 1)
            wall, busy = bf16_run["profile"]["wall_s"], bf16_run["profile"]["device_busy_s"]
            del eng, split, test
        f32 = main_path["cuda"][0]
        print(f"a profiled bf16 epoch at full width: wall {wall:.3f} s, device busy {busy:.3f} "
              f"s, idle share {fmt(bf16_run['profile']['idle_share'])} (f32, phase 7: "
              f"{fmt(profile.get('idle_share'))})")
        for key, us, count in bf16_run["profile"]["top"][:8]:
            print(f"   {us / 1e3:9.2f} ms  {count:6d}x  {key[:90]}")
        print(f"bf16 graphed run bitwise equal to its eager run (512 rows, 2 epochs); grouped "
              f"convs a step, device (graph): bf16 {fmt(bf16_run['convs_graph_ms']['bfloat16'])} "
              f"ms, f32 {fmt(bf16_run['convs_graph_ms']['float32'])} ms")
        for kern in ("cuda", "torch"):
            r = bf16_run[kern]
            print(f"bf16 kernels={kern}: epoch wall {r['epoch_wall_s']:.3f} s, "
                  f"{r['images_per_s']:.1f} images/s, final_val_acc "
                  f"{r['summary']['final_val_acc']:.2f} % (f32 kernels=cuda: "
                  f"{f32['epoch_wall_s']:.3f} s, {f32['images_per_s']:.1f} images/s)")

    graphs_run = {}
    with phase("20 graphed against eager"), uncounted(da.LAUNCHES, da.ROUTE_LAUNCHES, fa.LAUNCHES,
                                                      fa.ROUTE_LAUNCHES):
        graphs_run["serving"] = serve_graphs_vs_eager(torch, prompts)
        graphs_run["lm"] = [lm_graphs_vs_eager(torch, *case) for case in LM_GRAPH_CASES]

    dp_run = {}
    with phase("21 LM data parallel, 2 ranks on the one card"):
        from port_probes import lm_dp_world as W
        from torch_rank_worker import busy_union, launch

        # the one-process runs of the same global batch, then every run of
        # phases 21-26, 28(c), 29(e), 32 and 33's uninterrupted run in one
        # launch of the ranks (gloo: they share the card; a fresh rank process
        # costs seconds). The one-process runs are port_probes/lm_mesh_world.py's
        # (flash-sgd and flash-adam the same flags as phases 21-23's sgd and
        # adam), pp_world.py's and moe_world.py's; the ranks read their updates
        from port_probes import lm_mesh_world as M
        from port_probes import moe_world as MW
        from port_probes import pp_world as PW

        pp_updates = os.path.join(ROOT, "runs", "pp_updates")
        moe_updates = os.path.join(ROOT, "runs", "moe_updates")
        mesh_out = os.path.join(ROOT, "chiprun_out", "lm_mesh")
        pp_out = os.path.join(ROOT, "chiprun_out", "pp")
        moe_out = os.path.join(ROOT, "chiprun_out", "moe")
        t0 = time.perf_counter()
        mesh_ref = M.reference(LM_ARGS, ["flash-sgd", "flash-adam", "flash-int8", "ring-b8"],
                               updates=MESH_UPDATES)
        ref = {"sgd": mesh_ref["flash-sgd"], "adam": mesh_ref["flash-adam"]}
        t_pp = time.perf_counter()
        pp_ref = PW.reference(LM_ARGS, ["plain"], updates=pp_updates)
        t_moe = time.perf_counter()
        moe_ref = MW.reference(LM_ARGS, ["moe-L2"], updates=moe_updates)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        from port_probes import ckpt_world as CW

        # phase 29(e)'s runs (port_probes/ckpt_world.py at depth 2) in the same ranks
        ckpt = CW.make_spec(RESUME_WORLD_OUT, LM_ARGS + ["--n-layers", str(RESUME_WORLD_LAYERS)],
                            CW.RUNS[2])
        from port_probes import elastic_world as EW
        from port_probes import supervisor_world as SW

        # phase 33's uninterrupted run (port_probes/supervisor_world.py's flags
        # at dp 2); and phase 32's (port_probes/elastic_world.py at dp 2), last:
        # its shrink leaves rank 1 out of the group
        shutil.rmtree(SV_WHOLE, ignore_errors=True)
        shutil.rmtree(ELASTIC_OUT, ignore_errors=True)
        elastic = EW.make_spec(ELASTIC_OUT, LM_ARGS,
                               EW.world_runs(2, ELASTIC_OUT, whole=False, stopped=False))
        try:
            ranks = W.run_world(2, os.path.join(ROOT, "chiprun_out", "lm_dp"), LM_ARGS,
                                timeout=1500, then=[
                                    ("ckpt_world", ckpt),
                                    ("supervisor_world", SW.make_spec(SV_WHOLE, LM_ARGS, 2)),
                                    ("lm_mesh_world", M.make_spec(2, mesh_out, LM_ARGS,
                                                                  MESH_UPDATES)),
                                    ("pp_world", PW.make_spec(2, pp_out, LM_ARGS, pp_updates)),
                                    ("moe_world", MW.make_spec(2, moe_out, LM_ARGS,
                                                               moe_updates)),
                                    ("elastic_world", elastic)])
        finally:
            for d in (MESH_UPDATES, pp_updates, moe_updates):
                shutil.rmtree(d, ignore_errors=True)
        ranks_s = time.perf_counter() - t1
        # phases 24-26 and 28(c) read their records from this launch
        later_ranks = {"mesh": M.read_ranks(2, mesh_out),
                       "pp": (PW.read_ranks(2, pp_out), pp_ref, t_moe - t_pp),
                       "moe": (MW.read_ranks(2, moe_out), moe_ref, t1 - t_moe)}
        dp_run = W.check(2, ranks, ref, LM_ARGS, flash_counts=flash_counts,
                         mma_counts=mma_counts, busy_union=busy_union)
        dp_run["one_process"] = ref
        dp_run["seconds"] = {"one_process": t1 - t0, "ranks": ranks_s}
        runs = dp_run["runs"]
        form = runs["sgd"]["form"]
        print(f"   one process (dp 1; the mesh, pipeline and MoE references) {t1 - t0:.1f} s; "
              f"2 ranks, every run of phases 21-26, 28(c), 29(e), 32 and 33's uninterrupted "
              f"run, {ranks_s:.1f} s with start-up; backend {runs['sgd']['backend']}, "
              f"{runs['sgd']['cards']} card")
        print(f"   collective form: {form}")
        for name in ("sgd", "adam"):
            row = runs[name]
            print(f"   {name} --dp 2: {row['ms_per_step']:.2f} ms per step, "
                  f"{row['tokens_per_s']} tokens/s, MFU {row['mfu_pct']}% (1 card); losses "
                  f"{[round(x, 5) for x in row['losses']]}, max relative difference from one "
                  f"process {row['max_rel_vs_one_process']:.2e}; the ranks' SUMMARY lines "
                  f"equal; flash launches per rank {row['launches_per_rank']} (all mma)")
        prof = runs["sgd"]["profile"]
        print(f"   sgd --dp 2, 3 profiled steps: wall {prof['wall_s']:.3f} s, the card's idle "
              f"share over both ranks' device intervals {fmt(prof['idle_share'])}")
        print(f"   the collectives alone, per step (ms, each rank): sgd "
              f"{[fmt(x) for x in runs['sgd']['collective_ms']]}, zero "
              f"{[fmt(x) for x in runs['zero']['collective_ms']]}; graph segments of a step: "
              f"sgd {runs['sgd']['segments']}, zero {runs['zero']['segments']}")

    with phase("22 grad sync: end and overlap"):
        for name in ("end4", "overlap4", "overlap16"):
            row = runs[name]
            extra = (f", {row['n_buckets']} buckets (plan_buckets), losses within "
                     f"{row['max_rel_vs_end']:.2e} of end" if "n_buckets" in row else "")
            print(f"   --accum-steps 4 {name}: {row['ms_per_step']:.2f} ms per step, "
                  f"{row['tokens_per_s']} tokens/s; the collectives alone "
                  f"{[fmt(x) for x in row['collective_ms']]} ms per step; graph segments "
                  f"{row['segments']}{extra}")
        # the CNN at phase 4's shape, --sync-mode step, one gather per leaf
        # bucket of 10 KB a replica against one for all: bitwise, in one
        # process and on 2 ranks x 2 workers (gloo)
        from distributed_neural_network_tpu_torch.data.cifar10 import load_split
        from distributed_neural_network_tpu_torch.train.engine import Engine, TrainConfig

        split4 = load_split(True, source="synthetic", synthetic_size=512, seed=3)
        test4 = load_split(False, source="synthetic", synthetic_size=128, seed=3)
        cnn = {}
        for gs in ("end", "overlap"):
            cfg = TrainConfig(**{**CNN_SMALL, "sync_mode": "step", "grad_sync": gs,
                                 "bucket_mb": 0.01})
            eng = Engine(cfg, split4, test4, device=dev)
            cnn[gs] = ([eng.run_epoch(e) for e in range(2)],
                       [p.detach().clone() for p in eng.params], len(eng._step.segments))
            del eng
        check(cnn["end"][0] == cnn["overlap"][0]
              and all(torch.equal(a, b) for a, b in zip(cnn["end"][1], cnn["overlap"][1])),
              f"CNN step sync in buckets differs from end: {cnn['end'][0]} / {cnn['overlap'][0]}")
        # the 2 ranks x 2 workers runs came with phase 17's launch of the ranks
        out22 = out17
        segs = {}
        for r in range(2):
            got = {}
            for gs in ("end", "overlap"):
                with open(os.path.join(out22, f"{gs}_rank{r}.json")) as f:
                    info = json.load(f)
                got[gs] = (info["history"], dict(np.load(os.path.join(out22, f"{gs}_rank{r}.npz"))))
                segs[gs] = info["segments"]
            check(got["end"][0] == got["overlap"][0] and all(
                np.array_equal(got["end"][1][k], got["overlap"][1][k]) for k in got["end"][1]),
                f"rank {r}: the CNN's bucketed step sync differs from end")
        dp_run["cnn"] = {"final_val_acc": cnn["end"][0][-1].val_acc, "segments_2x2": segs}
        print(f"   CNN, phase 4's run with --sync-mode step: --grad-sync overlap (10 KB "
              f"buckets) bitwise --grad-sync end in one process (graphed) and on 2 ranks x 2 "
              f"workers over gloo; graphs and eager parts per program on the ranks: end "
              f"{segs['end']}, overlap {segs['overlap']}")

    with phase("23 ZeRO-1"):
        for name in ("zero", "zero-adam"):
            row = runs[name]
            print(f"   --optimizer {name} --dp 2: parameters after 4 steps bitwise the "
                  f"{'sgd' if name == 'zero' else 'adam'} run's; {row['ms_per_step']:.2f} ms "
                  f"per step, {row['tokens_per_s']} tokens/s")
        sb = dp_run["state_bytes"]
        print(f"   optimizer state per rank (memory_allocated around init_lm_momentum): "
              f"zero-adam {sb['per_rank']['zero-adam']['allocated']:,} B against adam "
              f"{sb['replicated_adam']:,} B (ratio {sb['ratio']:.4f}; the shards hold "
              f"{sb['zero_adam_want']:,} B; padding {sb['padding_floats']} floats over the "
              f"ranks); zero "
              f"{sb['per_rank']['zero']['allocated']:,} B against sgd "
              f"{sb['per_rank']['sgd']['allocated']:,} B")

    mesh_run = {}
    with phase("24 LM tensor parallel, 2 ranks on the one card"):
        from port_probes import lm_mesh_world as M

        # the ranks ran in phase 21's launch, against the one-process runs made
        # before it
        mesh_run = {"runs": M.check(2, later_ranks["mesh"], mesh_ref, LM_ARGS,
                                    flash_counts=flash_counts, mma_counts=mma_counts,
                                    flash_checked=(FLASH_MAIN,) + FLASH_MESH),
                    "one_process": mesh_ref,
                    "seconds": {"runs": sum(r["seconds"] for r in
                                            later_ranks["mesh"][0]["runs"].values())},
                    "cuts": {"sequence runs' global batch": "16 -> 8"}}
        runs24 = mesh_run["runs"]
        print(f"   one process (--precision int8, --attn ring at batch 8, sgd and adam) with "
              f"phase 21; 2 ranks in phase 21's launch, the runs of phases 24-25 "
              f"{mesh_run['seconds']['runs']:.1f} s of lm_train.main; collective form: "
              f"{runs24['tp2-sgd']['form']}")
        for name in ("tp2-sgd", "tp2-adam", "tp2-int8"):
            row = runs24[name]
            coll = row["collective_ms"][0]
            print(f"   {name} --tp 2 --attn flash: {row['ms_per_step']:.2f} ms per step, "
                  f"{row['tokens_per_s']} tokens/s, MFU {row['mfu_pct']}% ({row['cards']} card); "
                  f"losses {[round(x, 5) for x in row['losses']]}, max relative difference "
                  f"from one process {row['max_rel_vs_one_process']:.2e}; parameter update "
                  f"within {row['update_rel_max']:.2e} of one process's (relative L2, worst leaf "
                  f"{row['update_rel_leaf']}); the ranks' SUMMARY "
                  f"lines and gathered parameters equal; flash launches per rank "
                  f"{row['launches_per_rank']} (all mma) at {row['flash_shapes']}; the "
                  f"collectives alone per step (rank 0, ms): model-axis all-reduces "
                  f"{fmt(coll.get('model', 0.0))}, sync {fmt(coll['sync'])}; segments: "
                  f"{row['segments']}")

    with phase("25 LM sequence parallel, 2 ranks on the one card"):
        for name in ("sp2-ring", "sp2-ulysses", "sp2-zigzag"):
            row = runs24[name]
            coll = row["collective_ms"][0]
            print(f"   {name} (batch 8): {row['ms_per_step']:.2f} ms per step, "
                  f"{row['tokens_per_s']} tokens/s, MFU {row['mfu_pct']}%; losses "
                  f"{[round(x, 5) for x in row['losses']]}, max relative difference from one "
                  f"process --attn ring {row['max_rel_vs_one_process']:.2e}, parameter update "
                  f"{row['update_rel_max']:.2e} (worst leaf {row['update_rel_leaf']}); the "
                  f"collectives "
                  f"alone per step (rank 0, ms): sequence axis {fmt(coll.get('seq', 0.0))}, "
                  f"sync {fmt(coll['sync'])}; segments: {row['segments']}")
        row = runs24["dp2"]
        same = row["losses"] == dp_run["runs"]["sgd"]["losses"]
        mesh_run["dp2_bitwise_phase21"] = same
        print(f"   --dp 2 through create_lm_mesh(2, 1, 1): {row['ms_per_step']:.2f} ms per step, "
              f"losses {[round(x, 5) for x in row['losses']]} within "
              f"{row['max_rel_vs_one_process']:.2e} of one process (parameter update "
              f"{row['update_rel_max']:.2e}); "
              f"{'bitwise' if same else 'not bitwise'} phase 21's --dp 2 sgd losses; segments: "
              f"{row['segments']}")

    pp_run = {}
    with phase("26 LM pipeline parallel, 2 ranks on the one card"):
        from port_probes import pp_world as PW
        from torch_rank_worker import busy_union

        # the ranks ran in phase 21's launch
        ranks, ref, ref_s = later_ranks["pp"]
        pp_run = {"runs": PW.check(2, ranks, ref, LM_ARGS, busy_union=busy_union),
                  "one_process": ref, "seconds": {"one_process": ref_s},
                  "cuts": {"steps": f"{PW.STEPS}"}}
        print(f"   one process (--attn ring, the plain attention the pipeline's blocks run) "
              f"{ref_s:.1f} s; 2 ranks, both runs, in phase 21's launch")
        for name, row in pp_run["runs"].items():
            prof = row.get("profile") or {}
            print(f"   {name}: {row['ms_per_step']:.2f} ms per step, {row['tokens_per_s']} "
                  f"tokens/s, pp_bubble_frac {row['pp_bubble_frac']}, peak memory per rank "
                  f"{[round(x, 2) for x in row['peak_mem_gib']]} GiB, idle share "
                  f"{prof.get('idle_share')}; losses {[round(x, 5) for x in row['losses']]}, max "
                  f"relative difference from one process {row['max_rel_vs_one_process']:.2e}, "
                  f"parameter update {row['update_rel_max']:.2e} (worst leaf "
                  f"{row['update_rel_leaf']}); no flash launch; segments: {row['segments']}")

    remat_run = {}
    with phase("27 remat policies, the graphed flash step"):
        from port_probes import remat_policies as RP

        remat_run = RP.run_policies(torch, LM_ARGS, flash_counts=flash_counts,
                                    mma_counts=mma_counts, flash_remat=FLASH_REMAT,
                                    loss_tol=LOSS_TOL)
        for key in ("flash_fwd", "flash_dq", "flash_dkv"):
            kernels[key]["launches_remat"] = int(
                remat_run["dots_saveable"]["launches_per_step"][key] * RP.STEPS)
        for name, row in remat_run.items():
            held = ("" if "bitwise_vs_remat" not in row else
                    f"; {'bitwise' if row['bitwise_vs_remat'] else 'not bitwise'} the --remat "
                    f"run (losses within {row['max_rel_loss_vs_remat']:.2e}, parameters "
                    f"{row['max_abs_param_vs_remat']:.2e})")
            print(f"   {name} (batch 32, H 4, D 128): peak memory {row['peak_mem_gib']:.2f} GiB, "
                  f"{row['ms_per_step']:.2f} ms per step graphed, {row['tokens_per_s']} "
                  f"tokens/s, flash launches a step {row['launches_per_step']}{held}")

    moe_run = {}
    with phase("28 LM mixture of experts"):
        moe_run = moe_phase(torch, fa, da, kernels, dev, later_ranks["moe"])

    resume_run = {}
    with phase("29 checkpoint, resume, trace, run record"):
        resume_run = resume_phase(torch, fa, fh, da, kernels, dev)

    guard_run = {}
    with phase("30 training guard and chaos"):
        guard_run = guard_phase(torch, fa, fh, kernels, dev)

    monitor_run = {}
    with phase("31 monitor"):
        monitor_run = monitor_phase(torch, fa, fh, kernels, dev, guard_run)

    elastic_run = {}
    with phase("32 elastic resume"):
        from port_probes import elastic_world as EW

        elastic_run = elastic_phase(torch, fa, fh, kernels, dev,
                                    EW.read_ranks(2, ELASTIC_OUT),
                                    dp_run["runs"]["zero-adam"]["losses"])

    supervisor_run = {}
    with phase("33 supervisor"):
        from port_probes import supervisor_world as SW

        supervisor_run = supervisor_phase(torch, fa, kernels, SW.read_ranks(2, SV_WHOLE)[0])

    designs = {"fused_mlp3_fwd": f"one launch for all replicas, a cluster of "
                                 f"{fh.fwd_cluster(16)} blocks per (replica, 16-row tile)",
               "fused_mlp3_bwd": f"one launch for all replicas, a cluster of "
                                 f"{fh.bwd_cluster(16)} blocks per (replica, group of tiles), "
                                 f"W1 split by rows, the group's sums in registers (the "
                                 f"gradient itself at one group)",
               "fused_mlp3_bwd_reduce": "each replica's group rows summed in group order, "
                                        "one thread per element; not launched at one group; "
                                        "timed with its rows read from HBM "
                                        "(on_path_graph_ms: its share of the whole backward, "
                                        "the rows just written)",
               "decode_attention": "split route: the live prefix in up to 8 pieces, one "
                                   "block of a cluster each, rows per lane group by 16-byte "
                                   "loads, merged in order on rank 0",
               "decode_attention_q8": "split route on decode_attention's lanes and sums, "
                                      "int8 codes loaded 8 bytes a lane with each row's "
                                      "scales, code x scale rounded to q's dtype: bitwise "
                                      "the bf16 route on the dequantized cache",
               "flash_fwd": "wgmma (tensor cores; mma.sync at D 16/32/128)",
               "flash_fwd_quant": "mma.sync m16n8k32 on 8-bit codes (int8 into int32, e4m3 "
                                  "into f32 per k32 step), p's codes packed from the "
                                  "accumulators, V by ldmatrix.trans and a byte permute",
               "flash_dq": "mma.sync (tensor cores)", "flash_dkv": "mma.sync (tensor cores)"}
    for name, k in kernels.items():
        k["design"] = designs.get(name, "scalar (no tensor cores)")
    table = [{"name": name, **k} for name, k in kernels.items()]
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for row in table:
        missing = [k for k in keys if k not in row]
        if missing:
            print(f"chip_smoke: kernel {row['name']} lacks {missing}", file=sys.stderr)
            return 1
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "env": env, "kernels": table, "times": times,
                   "main_path": main_path,
                   "profile": profile, "serving": serving, "decode_times": decode_times,
                   "serve_profile": serve_profile, "flash_times": flash_times,
                   "flash_pair": flash_pair, "flash_checks": flash_checks,
                   "lm_runs": lm_runs, "lm_checks": lm_checks, "learn": learn,
                   "lm_profile": lm_profile, "graphs": graphs_run, "across": across,
                   "stream": stream_run,
                   "bf16": bf16_run, "data_axis": dp_run, "model_seq_axes": mesh_run,
                   "pipeline": pp_run, "remat_policies": remat_run, "moe": moe_run,
                   "resume": resume_run, "guard": guard_run, "monitor": monitor_run,
                   "elastic": elastic_run, "supervisor": supervisor_run}, f,
                  indent=1, default=str)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(route_check() if sys.argv[1:] == ["--route-check"]
             else resume_check() if sys.argv[1:] == ["--resume-check"]
             else guard_check() if sys.argv[1:] == ["--guard-check"]
             else monitor_check() if sys.argv[1:] == ["--monitor-check"]
             else elastic_check() if sys.argv[1:] == ["--elastic-check"]
             else supervisor_check() if sys.argv[1:] == ["--supervisor-check"] else main())
