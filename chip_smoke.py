#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero before the last line:

1. Device: the card's name, and its name and power limit as nvidia-smi
   reports them. Without a CUDA device the script exits 1 at once.
2. Build: every CUDA source under featurenet_tpu_torch/ops/csrc is
   compiled with nvcc into build/kernels/ (one nvcc each, in parallel).
3. Kernels against their plain versions, on the card, each row with its
   error, its time, the plain version's time, one library call's time (a
   yardstick the port never calls) and the bound:
   - conv3d_fwd at sprint64's three stride-1 3³ forward shapes at batch 64
     (a serving bucket) and 256 (a train step), at the three dx shapes of a
     train step (channels swapped: 32←32, 64→32, 64→64), at batch 1
     (serving's smallest bucket, where the kernel takes its small tiles;
     off the summed figures), at pod64's 5³ conv2 (batch 8, off the
     main path), and at the three forward and three dx shapes of one
     pod64 rank's step in the dp phase (128 rows: conv2 5³ 32→32 at 32³,
     3³ 32→64 and 64→64 at 16³; 5 timed calls each, the dp_ figures);
     yardstick F.conv3d;
   - conv3d_dw (fp32) and conv_dw_folded (bf16 on the tensor cores, and
     fp32 in SIMT off the main path) at the three batch-256
     weight-gradient shapes and at pod64's conv2, and conv3d_dw at the
     three weight-gradient shapes of a pod64 rank's step; yardstick
     cuDNN's weight gradient (aten.convolution_backward) in the kernel's
     input type.
4. Serve path: the sprint64 Predictor at full width (R=64, features
   32/32/64/64, hidden 128, 24 classes) from seeded weights, behind the
   InferenceService (buckets 1,4,16,64) and its HTTP server. The service's
   warmup captures one CUDA graph per bucket: each must capture exactly 3
   conv3d_fwd launches (one per 3³ block), and the traffic must launch none
   (every dispatch replays a graph: the Predictor's replay count must equal
   the batcher's dispatches). STL parts go to POST /predict over one
   keep-alive connection, then a concurrent burst of voxel grids to POST
   /predict_voxels. Every answer must be a 200 with a class; the served
   probabilities must match the same weights run through the plain conv;
   under torch.profiler each replay must run 3 conv3d_fwd_kernel on the
   card.
5. Graphs (`graphs` line): per serving precision (fp32, bf16, int8) a fresh
   sprint64 Predictor captures every bucket; per bucket the graphed
   probabilities must be bitwise the eager forward's on the same input,
   and the device ms of both, the capture seconds and the memory the
   generation reserves are printed.
6. Reload (`reload` line): sprint64 served from one checkpoint over HTTP
   while keep-alive clients post voxel grids; mid-burst a corrupted
   candidate must get 409 with the old version still serving, then POST
   /admin/reload swaps to a second checkpoint. Every request must be
   answered 200 with one of the two generations' eager probabilities
   (PROB_ATOL), the old one's before the swap and the new one's after it,
   /healthz must name the new version, and no request may launch a kernel.
6a. Wire (`wire` phase), sprint64 at full width:
   - `programs`: `cli programs --config sprint64 --warm` as a subprocess on
     the card: the 11 catalog rows, and each applicable program captured
     (serve* at buckets 1/4/16/64, serve_packed* at batch 256; 3
     conv3d_fwd per graph) or skipped with its reason.
   - `serve_packed`: per precision (fp32, bf16, int8) the packed program at
     batches 256 and 1 on 256 synthetic parts: labels against the argmax
     of the same precision's serve program on the unpacked grids (bitwise
     at fp32, a failure otherwise; at bf16 and int8 a differing row is
     printed with its top-2 logit gap), device ms per replay of both
     (CUDA events), the bytes and device ms of copying the batch to the
     card packed and as float32, and 3 conv3d_fwd_kernel device events per
     replay (correlation ids).
   - `stream`: `cli serve --config sprint64 --seed S --port 0 --run-dir D
     --slo-p99-ms 250 --queue-limit 256` as a subprocess; 256 parts through
     `stream_load` (POST /predict_voxels_stream, one keep-alive socket),
     every label the in-process Predictor's (a near-tie, top-2
     probabilities within 1e-6, is counted and exempt); a torn frame gets
     a 400 `bad_stream`; GET /metrics before and after counts 256 more
     served and carries the serving p99; SIGTERM drains with exit 0;
     `D/events.jsonl` holds serve_start, serve_batch and serve_stop.
   - `loadgen`: `measure_trace_overhead`'s percentage, then
     `bench_serving` on sprint64 at BENCH_LOAD_FRACTION (0.3) of two
     closed-loop rates, the fp32 serve_packed replay at batch 256 (the
     reference benchmark's basis) and the float32 request path (the trace
     probe's rate with its sampler off): the sustained rate, p50/p99,
     occupancy and rejections.
   The phase's own launches (captures and eager warmups) are the `wire`
   path of conv3d_fwd.
7. Train path, once per conv backend (pallas, hybrid_dw, xla): the sprint64
   Trainer at full width and batch 256 from a seed, dropout 0.5, a few
   steps on synthetic parts, then one eval batch. Every loss must be
   finite; parameters and batch-norm statistics must move; every kernel
   of the backend must launch exactly its count per step (pallas: 6
   conv3d_fwd, 3 conv3d_dw + 3 slab sums; hybrid_dw: 3 conv_dw_folded + 3
   slab sums, no conv3d_fwd; xla, the JAX default lowering through
   F.conv3d: none of the three kernels; plus 3 conv3d_fwd per pallas eval
   batch). Then, from the trained state and one batch on the card with
   dropout off, one step through the kernels must match the same step
   through the plain versions (not under xla, whose "kernel" and plain
   versions are the same library call; the bf16 model's gradients against
   the kernels' forward with the plain backward, see STEP_TOL). Device ms
   per step (CUDA events; alone, and while the producer threads generate), samples/s with the data wait, and the
   data-wait share are printed; before the train phases, the parts/s that
   one host thread generates and that the Prefetcher delivers. Then 3
   steps on the card's batch under torch.profiler print a `profile` line:
   the top 8 CUDA kernels by device time, the device-busy share, and the
   device ms per step inside the port's profiler ranges (optimizer,
   bn_relu, casts).
8. Checkpoint path, under pallas at the same full width: the Trainer takes
   3 steps saving each into a temporary directory; a fresh Trainer resumes
   at step 3 with model, Adam moments, count and step bitwise equal; both
   take one step on one batch (cuDNN deterministic) and stay bitwise equal;
   one byte of step 3 is damaged and a restore walks back to step 2 (an
   explicit step 3 raises); Predictor.from_checkpoint serves parts from
   step 2 with the labels of the restored model, on the graph its first
   dispatch captures (3 conv3d_fwd), one replay per dispatch. The host ms
   of each save (snapshot and enqueue) are
   printed beside the pallas device step ms, with the writer's ms per save,
   the restore ms and the bytes of one step; launches are exact throughout.
9. Command line, as a user runs it on the card: `cli train --config
   sprint64 --checkpoint-dir D` (3 steps at batch 256, saving each), then
   `cli serve --checkpoint-dir D` answering voxel grids over HTTP until
   SIGTERM; the train run's `checkpoint` record (host ms per save, writer
   ms per save, bytes) is printed.
10. Cache path: the port's export_synthetic_cache writes the reference's
   benchmark at R=64, cut from 24 x 1000 to 24 x 250 parts (the time
   limit), into a temporary directory under .data/
   (export wall time and parts/s printed). sprint64 at batch 256 then
   trains from it for 50 steps under pallas and xla, once resident on the
   card (hbm_cache: the train split uploaded once, rows drawn there) and
   once streamed by the Prefetcher's threads, rotating 8 cube-group poses
   per batch in the step; then one exact eval pass over the ~1,200
   held-out rows. Per run (`cache_run` line): samples/s with the data wait, the
   data-wait share, device ms per step (CUDA events), the resident MB, and
   launches exact over the run and for one more step. Then the resident
   path is held against itself: the card's draw of a fixed index vector
   against the host gather of the same samples, and the 24 rotations on
   the card against the CPU's, bitwise; one resident step (drawn rows,
   rotated) through the kernels against the plain versions (STEP_TOL).
   Last, `cli train --config sprint64 --data-cache D --hbm-cache` runs 3
   steps in a subprocess on the card.
11. Robust training (`robust_k`, `robust` lines): robust64 at full width
   (R=64, batch 256, features 32/32/64/64, dropout 0.5; half of every
   batch's 8 groups affine-warped in the step, 0.5 % occupancy flips, 8
   steps per dispatch) from the cache phase's cache, under pallas. 16
   steps at k = 8 replay one CUDA graph, and from the same seeded state 16
   eager single steps run (the second under
   torch.cuda.set_sync_debug_mode("error")): the states agree within
   K_RTOL/K_ATOL (bitwise verdict printed), resident and streamed, with
   exact launches (the warmup's 8 eager steps and the capture's 8; replays
   none) and the memory reserved by an eager step and by the graph. Under
   torch.profiler one replay runs 8 x (6 conv3d_fwd + 3 conv3d_dw + 3 slab
   sums) on the card and launches none from Python; under hybrid_dw 8 x 3
   folded weight gradients and their sums. The warp on rows drawn from the
   resident split against its explicit-gather plain version (WARP_ATOL),
   groups not taken bitwise, the noise flipping exactly its mask, device
   cube codes bitwise the CPU's rotations. Device ms (CUDA events) of a
   robust64 step and a sprint64 resident step at k = 1 and per inner step
   at k = 8, of the warp (and its plain version) and of the noise;
   samples/s and the data-wait share over 25 steps at k = 1 and 8,
   resident and streamed; a `pacing` line: samples/s over 25 steps at k =
   8, resident and streamed, in turns with the loop paced
   (max_inflight_steps 8: it waits for the event of the dispatch one group
   back) and unpaced (above the run's length), beside the rates measured
   before the loop paced its dispatches.
   Last, `cli train --config robust64 --data-cache
   D --total-steps 16 --checkpoint-dir C`, `cli recalibrate --checkpoint-dir
   C --out-dir C2 --batches 8` and `cli eval --checkpoint-dir C2` as
   subprocesses: the recalibrated step's batch-norm statistics moved,
   everything else bitwise.
12. Precision ladder and fused33 (`precision_*` lines), sprint64 at full
   width. Serving: the Predictor at bf16 and at int8 behind the
   InferenceService (buckets 1/4/16/64) answers a burst of 85 voxel grids
   on its graphs, with the serve path's launch facts; the served
   probabilities match the same precision through the plain conv (2e-3);
   the int8 weights sit on the card as int8 and the fp32 parameters leave
   it; per precision (fp32 too) the resident weight bytes, the graphed
   and eager device ms at buckets 64 and 1 (from the `graphs` line), and
   top-1 agreement with fp32 on 256 synthetic parts (printed, not gated:
   the weights are random). Training at batch 256 from one batch on the
   card, under bf16_master and fp16_scaled, each with pallas and
   hybrid_dw: 3 steps (up to 6, until two updates applied), each under
   torch.cuda.set_sync_debug_mode("error") (a host synchronisation in the
   step raises), finite losses, every parameter and batch-norm statistic
   moved, the masters fp32, exact launches per step, device ms per step
   beside fp32's, and one step through the kernels against the plain
   versions (STEP_TOL, bf16 model). An fp16_scaled step at loss scale 2^30
   is skipped bitwise on the card under the same mode (masters, moments,
   count, BN statistics), its step advanced and its scale halved. fused33: 3 steps,
   no kernel of the package launched, device ms per step beside xla's, and
   logits within 2e-2 of xla's on the same weights.
13. Supervised training, after the precision ladder, from the robust
   phase's cache, through `cli train --supervise` subprocesses
   (`supervise_*` lines):
   - `supervise_robust`: robust64 (resident, k = 8, pallas, batch 256) for
     64 steps with SUPERVISE_FAULTS and `--restart-every 24`: child 1 is
     preempted (exit 75, its exit save truncated), child 2 walks back past
     the torn step and ends its segment (exit 75), child 3 loses its host
     (SIGKILL), child 4 finishes. The supervisor must count 2 planned
     restarts and 1 crash restart, and the last step must equal an
     unbroken `cli train` of the same run, bitwise or each tensor within
     STEP_TOL's fp32 gradient tolerance (the verdict printed). Per child:
     its wall seconds and beats; the time from each exit or kill to the
     next child's first beat; the killed child releasing the card before
     the next child's setup record.
   - `supervise_stall`: sprint64 streamed from the cache for 24 steps,
     `--stall-timeout 10`, input worker 0 hung at ticket 16 (past the first
     beat): exactly one stall verdict, detected within the timeout plus one
     poll of the last beat, the killed process group gone, and the respawn
     finishing with a finite loss and its last checkpoint.
   - `supervise_swap`: `cli serve --checkpoint-dir` of the stall run with
     `--inject-faults swap_corrupt@swap=1`: the first POST /admin/reload
     (to the robust run's checkpoint) gets 409 `ChecksumMismatch` and the
     old generation answers bitwise as before; the second swaps.
   No supervisor process holds a CUDA context: nvidia-smi never lists its
   pid and it never holds a GPU device node open, while the same probe
   sees its children hold one. The children's kernel launches (each `cli
   train` on the card ends with its counts) are the `supervise` path.
13a. The Trainer's run directory (`report` phase), from the same cache:
   - `report_run`: `cli train --config sprint64 --conv-backend pallas
     --data-cache D --hbm-cache --supervise --restart-every 20
     --total-steps 40 --checkpoint-every 20 --run-dir R --profile-dir P
     --profile-start 25 --profile-steps 3 --poll-device-memory` (two
     children at full width);
     then `cli report R` in processes where torch cannot be imported:
     `--json` (40 loop steps, 2 process starts, 1 planned restart and no
     other, heartbeats; the breakdown and its attributed fraction
     printed, and each child's segment reported alone: segment 1 has no
     trace window), `--validate` (no finding), `--trace` (spans on both
     children's tracks), `--gate R/gate_baseline.json` (exit 0, or 2 with a
     `gate_regression` event in the stream: the gate is never
     load-bearing). P holds one Chrome trace of steps 25-27; per step the
     `conv3d_fwd_kernel` and `conv3d_dw_partial` device events launched
     inside its `train_dispatch@<step>` range are printed, and the middle
     step must hold 6 and 3 (the profiler may lose events at its edges).
     The perf section (`perf` in the line) must hold the train program
     (`hbm_train_step`) with its analytic `flops` and its `peak_bytes`,
     the card's name as `device_kind` at the `known` tier, an `mfu`
     window with its p50 in (0, 1), and `device_memory` watermarks at most
     the card's `bytes_limit`; the report's gate values must hold `mfu`
     and `hbm_peak_train_bytes`, and `cli report --gate` on a baseline
     pinned from them must pass. The children's launches are the `report`
     path.
   - `report_cost`: one resident sprint64 `pallas` Trainer in this process
     takes 30 steps per turn, dark and with a run directory in turns, twice
     each: device ms per step (CUDA events around each turn, its end-of-run
     eval left out), the overhead, and the events and spans emitted per
     step. Printed, never gated.
13b. The model-quality plane (`quality` phase), on the `report` run's
   sprint64 `pallas` checkpoint C (40 steps: its probabilities are near
   uniform, so the recorder's 0.35 confidence floor keeps almost every
   request; captures are printed by reason):
   - `quality_pin`: `cli pin-quality --checkpoint-dir C --n 512`: a
     baseline of 512 parts.
   - `quality_serve`: `cli serve --checkpoint-dir C --run-dir D --quality
     --quality-baseline B --capture --port 0`, 512 POST /predict_voxels of
     synthetic parts in concurrent waves of 1, 4, 16 and 64, a drain; then
     `cli report D` without torch: `--validate` (no finding) and `--json`
     (the `serve` program's flops and peak_bytes, the serving mfu p50 in
     (0, 1), the confidence, margin, entropy and drift windows, captures
     by reason).
   - `quality_replay`: `cli replay D/capture --checkpoint-dir C` four
     times: the identity candidate, `--precision bf16`, `--precision
     int8`, `--conv-backend xla`; each one's agreement, flips, score_ms,
     per_request_ms and post_warmup_compiles (the graph captures made
     while scoring: 0, or the phase fails). The identity candidate must
     reach 0.967; a flip of it is printed with its two top probabilities.
     The other candidates may exit 2: their verdicts are printed.
   - `quality_overhead`: `measure_quality_overhead` at sprint64, buckets
     1/4/16, 192 requests, in three turns: each turn's tax and captured
     count, and the spread of the tax.
   The children's launches and the overhead probe's are the `quality`
   path.
13c. The incident plane (`incident` phase), sprint64 at full width from
   seeded weights (every answer held to the same weights' eager label; a
   top-2 gap under 1e-6 is a near-tie, counted and exempt):
   - `incident_calibrate`: an in-process service (buckets 1/4/16/64 on
     CUDA graphs) gives a sequential bucket-1 p99 and a 128-request
     burst's median; the SLO is their geometric mean (the burst must be
     INCIDENT_SEPARATION times the sequential p99).
   - `incident_serve`: `cli serve --config sprint64 --run-dir D
     --trace-sample 0 --slo-p99-ms SLO --alert-rules serving_p99_ms>SLO`
     under 128 keep-alive clients until the incident's capture is
     written, then one request at a time until GET /metrics reads
     incidents_open 0 (it must read 1 while open); exactly one incident;
     every request answered while it was open traced, some under the SLO
     (only force-all keeps those), none under the SLO kept outside it;
     the bundle complete, its stacks sampling the dispatch and HTTP
     threads; the child's launches its warmup's alone (replays only);
     then `cli incident list|show`, `cli report --json|--validate`
     without torch. The capture's wall and the sampler's ticks against
     its 100 due are printed, `sampler_starved` when under 80.
   - `incident_store`: the same burst and recovery in-process with a
     run directory and a `TimeSeriesStore` attached by `alerts.set_store`:
     `alerts_active` 1 then 0 in the store, the 1 in the bundle's
     `tsdb.json`, `cli dash --once` naming the bundle.
   - `incident_overhead`: `measure_incident_overhead`, three turns.
   The services' warmups, the probe's and the serve child's launches are
   the `incident` path.
13d. The serving fleet (`fleet` phase), after `incident`, on the `report`
   run's checkpoint: `cli fleet --replicas 2 --buckets 1,4,16,64 --capture
   --capture-sample 1.0 --inject-faults replica_loss@request=160` (two
   sprint64 replicas, each its own CUDA context, behind one router):
   - both ready (launch to ready s); the fleet process holds no CUDA
     context (not in nvidia-smi's compute apps, no /dev/nvidia node open;
     each replica holds one), the card's memory per replica;
   - 480 open-loop requests at 120/s through the router, a replica
     SIGKILLed at the 160th: 0 dropped, every label the in-process
     Predictor's (near-ties under 1e-6 exempt), the slot respawned and
     back in membership.json (`replica_rejoin`), loss to ready s;
   - 240 requests at 120/s to one replica directly, then through the
     router (p50, p99, rate);
   - `cli fleet rollout CK2` (the same weights one step later) under
     background load: both replicas swapped, the versions converged, 0
     dropped; `cli fleet rollout` of a checkpoint of another seed: the
     canary fails, exit 2, both replicas still on CK2's version;
   - SIGTERM: `fleet_stats` with 0 dropped and a rejoin; `cli report
     --json` (no torch): the fleet timeline's `fleet_replica_loss` and
     `fleet_replica_ready`, a tsdb series per target.
   The draining replicas' and the rollout processes' own counts are the
   `fleet` path (the SIGKILLed replica's count is lost with it).
13e. Data-parallel training (`dp` phase), after `fleet`, on the cache
   phase's cache: pod64 at full width (R=64, features 32/32/64/64, kernels
   7/5/3/3, 24 classes) under pallas, global batch 256:
   - two ranks of `cli --distributed train --hbm-cache --total-steps 4
     --checkpoint-every 2 --run-dir D` sharing the card over gloo (128
     rows each from its own block of the resident split), each rank
     through `cli.main` with its dispatches timed (CUDA events, then a
     synchronise) and its gradient all-reduce timed on the host clock: the
     mesh from each rank's loop_start (backend gloo, 2 processes), device
     ms per step and all-reduce ms per step by rank (gloo through the
     host, not NCCL's time), the final metrics and the exact eval bitwise
     equal on both ranks, n_evaluated equal to the held-out count, and
     each rank's launches: 6 conv3d_fwd and 3 conv3d_dw a step and 3
     conv3d_fwd an eval batch;
   - beside each other: the plain CLI resuming a copy of its step-2
     checkpoint in a new 2-rank world (step 4 and the eval bitwise the
     unbroken run's), a 1-rank nccl world of 2 steps at batch 128, and
     the same run without a process group (its checkpoint bitwise the
     nccl world's);
   - the 1-process run at batch 256 in this process on the same global
     batches (rank r's draws at rows [128r, 128r+128)): after 4 steps the
     batch-norm statistics within rtol 1e-3, atol 1e-4, the parameters
     within Adam's bound 2·Σlr (the share inside rtol 3e-4, atol 3e-6
     printed), the final loss within 1e-3 (bf16 activations); it runs
     with cuDNN's TF32 at PyTorch's default, as the ranks' `cli train`
     processes do (the port never sets it).
   The timed world's launches are the `dp` path.
13f. Elastic training (`elastic` phase), after `dp`, on the same cache:
   `cli train --elastic --world-size 2 --config pod64 --conv-backend
   pallas --hbm-cache`, global batch 256, 5 steps, a checkpoint every
   step, `--restart-every 3`, `--inject-faults host_loss@step=1`: the
   2-rank world (gloo on the one card) loses rank 1 after step 1, re-forms
   at one rank from the step-1 checkpoint, exits 75 at step 4, where slot
   1 rejoins, and the 2-rank world finishes step 5. /proc is sampled every
   20 ms beside it: no two generations' processes alive at once, none of
   a killed generation left when the next is spawned, the coordinator
   holding no GPU device node. Checked: the `{"elastic": ...}` verdict
   (exit 0, 1 loss, 1 rejoin, a planned boundary), the `mesh_reform`
   reasons start/host_loss/host_rejoin, membership.json at world 2, every
   loop_start at batch 256, run_end at step 5, each process of the 1- and
   2-rank generations at 6 conv3d_fwd and 3 conv3d_dw a step and 3
   conv3d_fwd an eval batch (by the pid on its `launches` line). The first
   step of each re-formed generation against a run restored from the same
   checkpoint: at one rank `cli.main(["train", ...])` in this process for
   a segment of one step (cuDNN's TF32 at PyTorch's default, as in a
   `cli train` process), bitwise; at two ranks the 1-process run in this process on the
   world's global batch (cuDNN's TF32 at the default likewise), to the
   dp phase's tolerances. The `elastic` line
   prints the recovery from the kill to generation 1's first step, split
   (detection, kill, backoff, cold start, restore, first step), and the
   grow boundary's cost, split likewise; its launches are the `elastic`
   path.
14. Robustness evaluation (`ood` phase), after the supervised runs:
   - `native`: the port's native voxelizer, built by g++ after the
     kernels (its build seconds; a build that fails fails the script), on
     8 sprint64 parts at 64³ (2 rotated): bitwise the numpy voxelizer, ms
     per part of each and the OpenMP threads.
   - `stl_cache`: `cli export-stl-data --per-class 1 --resolution 64`,
     then `cli build-cache` with `--workers 1` and `--workers 4`
     (subprocesses on the host): both caches bitwise each other and the
     `mesh_pose="remesh"` export of the same seed; meshes/s, MB of STL
     and of the cache.
   - `ood`: `cli eval-ood --per-class 1` in this process on a seeded
     sprint64 `pallas` checkpoint: 13 rows of 24 parts, the clean row's
     delta 0, one bucket-64 graph captured (12 conv3d_fwd launches, the
     `ood` path) and 312 forwards; host seconds in `_perturb` and in
     `predict_voxels`, the forwards' device ms; the clean and so3 rows'
     grids through the kernels against the plain conv (PROB_ATOL, labels
     equal away from a near-tie).
   - `tta`: 24 parts rotated in SO(3) through `predict_voxels(
     canonicalize=True)` (the `tta` path: 12 launches, one capture): host
     canonicalize s per part, device ms against 9 bucket-64 replays, the
     vote against the plain conv's (PROB_ATOL), a cube rotation of the
     input moving it by at most TTA_ATOL, and the device peak of a 64-part
     vote beside a bucket-64 forward's.
15. seg64 (`seg` phase), the segmenter at full width (R=64, batch 32, 3
   features per part, seg_features 32/64/128, proj_coords input channels,
   2 decoder blocks, ce_dice; bf16 compute, fp32 masters):
   - `seg_cache`: export_seg_cache of 512 parts: host s, parts/s, MB on
     disk.
   - `seg_train`: 30 steps resident on the card (hbm_cache: packed voxels
     and int8 seg uploaded once, the paired cube rotation in the step),
     every loss finite: device ms per step (CUDA events), samples/s, the
     data-wait share, the peak allocated MB beside the reference's byte
     model; 10 steps streamed from the cache (host rotation of voxels and
     seg together, the Prefetcher), their data-wait share; 2 steps from
     the synthetic stream, the host ms per 3-feature part.
   - `seg_profile`: 3 resident steps under torch.profiler: device ms per
     step by kernel family (cuDNN convolutions, gemm, elementwise/reduce/
     copy) and inside the forward's ranges (input context, casts, batch
     norm and ReLU, the transposed conv, the loss) and the optimizer's.
   - `seg_eval`: one exact pass over the held-out split (4 batches):
     mean IoU, voxel and foreground accuracy (printed, not gated).
   - `seg_serve`: the trained state saved and restored bitwise;
     Predictor.from_checkpoint at fp32, bf16 and int8, one CUDA graph per
     bucket (32, 1): graphed labels bitwise the eager ones, device ms of
     both, capture s and reserved MB per generation, resident weight
     bytes against fp32's, bf16's and int8's per-voxel agreement with
     fp32 (int8's also over 64 synthetic parts; printed, not gated); POST
     /predict_voxels answering the bincount of predict_voxels_seg.
   - `seg_affine`: 10 resident steps with the paired affine warp in the
     step (robust64's settings): device ms per step beside seg_train's,
     peak MB, finite losses; the warp alone at batch 32 against its plain
     gather (labels bitwise, voxels within 1e-5, every label held by its
     sample, untaken groups bitwise), device ms of both.
   - `seg_cli`: `cli export-seg-data`, `cli train --config seg64
     --data-cache D --hbm-cache --total-steps 4`, `cli eval` (its
     mean_iou the run's) and `cli infer --seg-out` on two STL parts, as
     subprocesses; `cli programs --config seg64 --warm` (serve_int8
     captured).
   - `seg_ood`: `cli eval-ood --seg-parts 16` on seg_cli's checkpoint:
     every row, the scale-0.7 control and each rotation row's
     delta_vs_scale_control; host s in _perturb_seg against
     predict_voxels_seg.
   - `seg_diagnose`: `python -m featurenet_tpu_torch.train.seg_diagnose`
     on seg_cli's checkpoint and cache (a subprocess on the card): its
     confusion matrix sums to the held-out split's voxels; the device it
     printed.
   - `seg_stl`: `cli export-stl-data --seg` of 48 parts, `cli build-cache`
     over it at 1 and 4 workers, both bitwise `cli export-seg-data` of the
     same seed; meshes/s and MB.
   - `seg_oracle`: seg_oracle.measure_ceiling(64, 3) over 64 samples.
   The segmenter runs no kernel of the package (its convolutions are the
   reference's XLA convolutions, here cuDNN's): every launch count stays 0
   in each line, the `seg` path of each kernel. A line's counts are its
   in-process runs' and those its subprocesses print of themselves
   (`cli train`, `cli eval`, `cli infer`, seg_diagnose, each on the card).
16. The wall time of every phase, one JSON line of per-kernel numbers
   (launches by path, the wire, cache, robust, supervise, report,
   quality, incident, fleet, dp, elastic, precision, ood, tta and seg runs'
   included), the
   nvidia-smi line, and the last line: {"ok": true, "device": {...}}.

TF32 is switched off for cuDNN and cuBLAS, so every fp32 comparison and
yardstick here is full fp32, except where this script stands in for a `cli
train` process (the dp and elastic references): there cuDNN's TF32 is at
PyTorch's default, on, as in that process.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import http.client
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32
# outside the tensor cores, the fp32 kernels' bound; bf16 dense tensor
# cores and HBM3 bandwidth from the port's one peak table (obs/perf.py).
PEAK_FP32_FLOPS = 67e12


def _h100_peaks() -> tuple[float, float]:
    from featurenet_tpu_torch.obs import perf

    return (perf.PEAK_FLOPS_BY_KIND[perf.H100],
            perf.PEAK_BYTES_PER_SEC_BY_KIND[perf.H100])

# Kernel vs plain: both sum K³·Cin fp32 products (up to 1728 here) in
# different orders, so they differ by rounding, ~sqrt(n)·2^-24 of the
# output's scale. Held to 1e-5 of the largest |output|.
KERNEL_REL_TOL = 1e-5
# Weight gradient vs plain: a sum over up to 256·16³ ≈ 1M positions per
# output. The kernels add each slab's ~8k products in order and then ~132
# slab partials; cuBLAS blocks its own way. Random-walk rounding of such
# sums is ~1e-6 of the output's scale; held to 2e-5. (A bf16 product is
# exact in fp32, so the bf16 rows have the same tolerance: the tensor-core
# kernel sums 16 products per mma from zero and adds each such sum to its
# fp32 total rounded to nearest: 0.85-1.3e-6 measured at the batch-256
# shapes.)
DW_REL_TOL = 2e-5
# Served probabilities vs the plain-conv forward of the same weights: the
# conv outputs differ by fp32 rounding, and a few of them then round to a
# neighbouring bf16 value (the model's activation dtype, 2^-8 relative);
# that moves probabilities by far less than 2e-3.
PROB_ATOL = 2e-3
# One train step through the kernels vs through the plain versions, from
# one state and batch, dropout off; gradients and batch-norm statistics
# are compared leaf by leaf as ||kernel - plain|| / ||plain||.
# - fp32 model: the conv outputs differ by fp32 rounding (~1e-6 of their
#   scale); ReLU and max-pool are not smooth, so an activation next to 0 or
#   a max-pool window with two near-equal values can switch sides and move
#   a gradient entry. Measured up to ~1e-3 per leaf; held to 1e-2.
# - bf16 model (the trained dtype): the same fp32 differences turn a few
#   activations into the neighbouring bf16 value (2^-8 relative, ~5e-4 of
#   them per conv), and with bf16's coarse values many max-pool windows
#   hold ties that one such step breaks, re-routing a whole gradient entry;
#   where batch norm's backward leaves a leaf's gradient mostly cancelled
#   (the stem's kernel), that moves the leaf by up to ~1e-1 and varies with
#   the state, and the plain step with its taps summed in the other order
#   (`grad_rel_err_plain_reordered`, printed) moves as far from the plain
#   step. Against the plain step the gradients cannot tell a fault from
#   rounding, so that error is printed (`grad_rel_err_vs_plain_step`), and
#   the gradients are held instead against the step that runs the kernels'
#   forward and the plain versions' backward (`forward_shared`): the same
#   activations and max-pool routes on both sides, so only the backward's
#   fp32 rounding and its bf16 casts differ. Held to 1e-1, which a wrong
#   tap, channel or slab in a backward kernel (an O(1) difference) exceeds;
#   a forward fault moves the loss and the batch-norm statistics, which are
#   held against the plain step.
# The loss is a forward quantity: 1e-4 (fp32) and 5e-3 (bf16). Updated
# parameters: Adam's step is lr·m̂/(√v̂+eps), and an entry whose gradient is
# rounding noise can move the other way, so they agree to 2·lr (plus 1e-6
# for the weight decay and fp32 rounding of the update).
# - bf16_master and fp16_scaled (bf16 model): the working copy is the same
#   cast of the same masters on both sides; the gradients are stored at the
#   working dtype, so an entry whose fp32 values straddle a rounding
#   boundary lands one ulp (2^-8 in bf16, 2^-11 in fp16) apart, far inside
#   the bf16 model's tolerance, which they are held to.
STEP_TOL = {"fp32": {"loss": 1e-4, "grad": 1e-2},
            "bf16": {"loss": 5e-3, "grad": 1e-1}}
# fp16_scaled's step against the plain step runs at this loss scale, well
# inside fp16's range for a step at batch 256 (an overflow fails the check).
RUNG_LOSS_SCALE = 2.0 ** 10
# The precision phase: training steps per run, serving parts per burst, the
# parts its agreement with fp32 is measured on, and the fused33 logits batch.
RUNG_STEPS = 3
RUNG_BURST = 85  # 64 + 16 + 4 + 1: every bucket when the queue drains
AGREEMENT_PARTS = 256
FUSED33_LOGITS_BATCH = 16
# Serving: the service's buckets (one CUDA graph each per precision), and
# the replays of each bucket profiled to count the forward kernel in them.
SERVE_BUCKETS = (1, 4, 16, 64)
REPLAY_PROFILE_REPS = 3
# The reload phase: keep-alive clients posting in a loop, over these grids.
RELOAD_CLIENTS = 16
RELOAD_GRIDS = 64
# Idle seconds at the end of a profiler window that counts kernel events.
# On the H100 the profiler loses device events at the edges of its window:
# the first one or two kernels of the window's first graph launch, or the
# last few milliseconds of kernels of its last ones (about one window in
# six; never one inside). So a window that counts events runs its counted
# graph launches between uncounted lead and tail launches, and the count
# is taken per launch from the events correlated with it
# (``graph_launch_events``).
PROFILE_PAD_S = 0.1
# The port's record_function ranges whose device ms the profile line splits.
PROFILE_RANGES = ("optimizer", "bn_relu", "casts")

SPRINT_BLOCKS = [(32, 32), (32, 64), (64, 64)]  # cin, cout of the 3³ blocks
TRAIN_BATCH = 256
TRAIN_STEPS = 5
EVAL_BATCHES = 1
# Producer threads: one per host core, at most 8 (the chip machine has 8).
TRAIN_WORKERS = min(8, len(os.sched_getaffinity(0)))
# The cache phase: the reference's 24 x 1000 benchmark at R=64 cut to 24 x
# 250 (the export is host-bound at ~400 parts/s, and the script must end
# inside its time limit), and 50 steps per run; the rotation check takes
# the first 64 drawn rows.
CACHE_PER_CLASS = 250
CACHE_STEPS = 50
ROTATION_CHECK_ROWS = 64

# The robust phase: robust64 (its k, 8) and sprint64 from the cache phase's
# cache; steps held graph against eager, steps of each rate run, and the
# command line's steps and recalibration batches.
ROBUST_K = 8
ROBUST_CHECK_STEPS = 16
ROBUST_RATE_STEPS = 25
ROBUST_CLI_STEPS = 16
RECAL_BATCHES = 8
# The pacing check: turns of ROBUST_RATE_STEPS steps at k = 8 at each
# max_inflight_steps (8, and above the run's length), and the rates this
# script measured before the train loop paced its dispatches (samples/s,
# resident and streamed; H100 80GB HBM3, 700 W), printed beside them.
PACING_TURNS = 2
UNPACED_LOOP_RATES = {"resident": 4774.1, "streamed": 4585.7}
# The supervise phase. robust64 resident at k = 8 for 64 steps, saving
# every 16, in segments of 24 steps: child 1 is preempted at its segment's
# end (step 24, saved truncated: the second save of that process), child 2
# walks back to 16 and ends its segment at 40, child 3 loses its host at
# the first boundary past 50 (step 56), child 4 resumes from 48 and
# finishes. sprint64 streamed for 24 steps, saving every 8, with worker 0
# of the input threads hung at ticket 16, well past the first beat (step
# 9, 8 steps in flight).
SUPERVISE_STEPS = 64
SUPERVISE_CKPT_EVERY = 16
SUPERVISE_RESTART_EVERY = 24
SUPERVISE_FAULTS = "sigterm@step=20,checkpoint_corrupt@save=2,host_loss@step=50"
STALL_STEPS = 24
STALL_CKPT_EVERY = 8
STALL_TIMEOUT_S = 10
STALL_FAULTS = "producer_hang@batch=16"
# k steps replayed on one CUDA graph against k eager steps from one state:
# the reference's k-step tolerance (tests/test_train.py). The graph runs the
# same kernels on the same inputs, draws the same numbers (each inner step's
# generators reseeded from (seed, step, stream) before the replay), so the
# states are expected bitwise equal; the verdict is printed.
K_RTOL, K_ATOL = 1e-6, 1e-7
# The affine warp (F.grid_sample in float64) against its explicit 8-corner
# gather in fp32 on the same draws, voxels in [0, 1] at R=64: the float64
# normalisation to [-1, 1] and back keeps each fp32 source coordinate, so
# both weight the corners from the same coordinates and differ by the
# fp32 rounding of the plain gather's weights and sum (a few 1e-7). Held
# to 1e-5, the bound the CPU tests hold the warp to against the reference.
WARP_ATOL = 1e-5
# The kernels' device events in one replay of a k-step graph, by kernel
# name (a substring of the symbol), per inner step: pallas runs 6 forward /
# dx convs, 3 weight gradients and their 3 slab sums; hybrid_dw 3 folded
# weight gradients and their 3 sums.
REPLAY_EVENTS = {
    "pallas": {"conv3d_fwd_kernel": 6, "conv3d_dw_partial": 3, "sum_slabs": 3,
               "dw_folded_partial": 0, "sum_unfold": 0},
    "hybrid_dw": {"conv3d_fwd_kernel": 0, "conv3d_dw_partial": 0, "sum_slabs": 0,
                  "dw_folded_partial": 3, "sum_unfold": 3},
}

# pod64's stride-1 blocks as the dp phase's ranks run them, 128 rows each:
# (grid, cin, cout, k): conv2 5³ at 32³, conv3 and conv4 3³ at 16³ (after
# the pool).
POD64_BLOCKS = [(32, 32, 32, 5), (16, 32, 64, 3), (16, 64, 64, 3)]
POD64_RANK_BATCH = 128
POD64_REPS = 5  # timed calls of a pod64 row (a conv2 call is ~1 TFLOP)

# (name, batch, grid, cin, cout, k, main path: "serve", "train", "dp" or
# None). "train" rows sum into a kernel's figures (sprint64's batch-256
# step), "dp" rows into its dp_ figures (one pod64 rank's step).
FWD_SHAPES = (
    [("serve", 64, 16, ci, co, 3, "serve") for ci, co in SPRINT_BLOCKS]
    + [("train fwd", TRAIN_BATCH, 16, ci, co, 3, "train") for ci, co in SPRINT_BLOCKS]
    + [("train dx", TRAIN_BATCH, 16, co, ci, 3, "train") for ci, co in SPRINT_BLOCKS]
    + [("serve b1", 1, 16, ci, co, 3, "serve") for ci, co in SPRINT_BLOCKS]
    + [("pod64 conv2", 8, 32, 32, 32, 5, None)]
    + [("pod64 fwd", POD64_RANK_BATCH, r, ci, co, k, "dp")
       for r, ci, co, k in POD64_BLOCKS]
    + [("pod64 dx", POD64_RANK_BATCH, r, co, ci, k, "dp")
       for r, ci, co, k in POD64_BLOCKS]
)
DW_SHAPES = (
    [("train dW", TRAIN_BATCH, 16, ci, co, 3, "train") for ci, co in SPRINT_BLOCKS]
    + [("pod64 conv2", 8, 32, 32, 32, 5, None)]
    + [("pod64 dW", POD64_RANK_BATCH, r, ci, co, k, "dp")
       for r, ci, co, k in POD64_BLOCKS]
)


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    """The least time for the work: the larger of operations over the
    peak rate and bytes (each input read once, each output written once)
    over the memory rate."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / _h100_peaks()[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _row(torch, kernel, what, shape, kernel_fn, plain_fn, lib_fn, flops,
         nbytes, peak, tol, path) -> dict:
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.abs().max())
    if not (err <= tol * scale):
        fail(f"{kernel} {what} {shape}: max abs err {err} > {tol} x {scale}")
    del got, want
    reps = POD64_REPS if path == "dp" else 20
    ms = time_ms(torch, kernel_fn, reps=reps)
    plain_ms = time_ms(torch, plain_fn, reps=min(reps, 10))
    lib_ms = time_ms(torch, lib_fn, reps=reps)
    bound, bound_by = bound_ms(flops, nbytes, peak)
    row = {"what": what, "shape": shape, "main_path": path is not None,
           "path": path,
           "max_abs_err": err, "max_rel_err": err / scale,
           "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound, "bound_by": bound_by,
           "tflops": flops / ms / 1e9}
    print(kernel, json.dumps(row), flush=True)
    return row


def check_kernels(torch, seed: int) -> dict[str, list[dict]]:
    import torch.nn.functional as F

    from featurenet_tpu_torch.ops import conv3d, conv_dw

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = {"conv3d_fwd": [], "conv3d_dw": [], "conv_dw_folded": []}
    for what, b, r, cin, cout, k, path in FWD_SHAPES:
        x = torch.randn((b, r, r, r, cin), device="cuda", generator=g)
        w = torch.randn((k, k, k, cin, cout), device="cuda", generator=g)
        w /= (k ** 3 * cin) ** 0.5
        x_ncdhw = x.permute(0, 4, 1, 2, 3)  # channels-last view, no copy
        w_oidhw = w.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        n = b * r ** 3
        rows["conv3d_fwd"].append(_row(
            torch, "conv3d_fwd", what, [b, r, r, r, cin, cout, k],
            lambda: conv3d.conv3d_fwd(x, w), lambda: conv3d.conv3d_plain(x, w),
            lambda: F.conv3d(x_ncdhw, w_oidhw, padding=(k - 1) // 2),
            2.0 * n * cout * k ** 3 * cin,
            4.0 * (n * cin + k ** 3 * cin * cout + n * cout),
            PEAK_FP32_FLOPS, KERNEL_REL_TOL, path))
        del x, w, x_ncdhw, w_oidhw
    for what, b, r, cin, cout, k, path in DW_SHAPES:
        # The dp path runs pallas: conv3d_dw alone.
        kernels = ((("conv3d_dw", torch.float32),) if path == "dp" else
                   (("conv3d_dw", torch.float32),
                    ("conv_dw_folded", torch.bfloat16),
                    ("conv_dw_folded", torch.float32)))
        for name, dtype in kernels:
            x = torch.randn((b, r, r, r, cin), device="cuda", generator=g).to(dtype)
            gy = torch.randn((b, r, r, r, cout), device="cuda", generator=g).to(dtype)
            w = torch.empty((cout, cin, k, k, k), device="cuda", dtype=dtype,
                            memory_format=torch.channels_last_3d)
            p = (k - 1) // 2
            fn = conv3d.conv3d_dw if name == "conv3d_dw" else conv_dw.conv_dw_folded

            def library(x=x, gy=gy, w=w, p=p):
                return torch.ops.aten.convolution_backward(
                    gy.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), w,
                    None, [1, 1, 1], [p, p, p], [1, 1, 1], False, [0, 0, 0], 1,
                    [False, True, False])[1]

            n = b * r ** 3
            size = x.element_size()
            bf16 = dtype == torch.bfloat16
            rows[name].append(_row(
                torch, name, f"{what} {'bf16' if bf16 else 'fp32'}",
                [b, r, r, r, cin, cout, k],
                lambda: fn(x, gy, k), lambda: conv_dw.conv_dw_plain(x, gy, k),
                library, 2.0 * n * cout * k ** 3 * cin,
                size * n * (cin + cout) + 4.0 * k ** 3 * cin * cout,
                _h100_peaks()[0] if bf16 else PEAK_FP32_FLOPS, DW_REL_TOL,
                # The main path runs conv_dw_folded in bf16 (hybrid_dw).
                path if name == "conv3d_dw" or bf16 else None))
            rows[name][-1]["dtype"] = "bf16" if bf16 else "fp32"
            del x, gy, w
    torch.cuda.empty_cache()
    return rows


def _post(conn, path: str, body: bytes):
    t0 = time.perf_counter()
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    payload = json.loads(resp.read())
    return resp.status, payload, (time.perf_counter() - t0) * 1e3


def serve_phase(torch, seed: int) -> dict:
    import numpy as np

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.mesh_primitives import mesh_box
    from featurenet_tpu_torch.data.stl import parse_stl, save_stl
    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
    from featurenet_tpu_torch.data.voxelize import voxelize
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.runtime import build_model, serve_forward
    from featurenet_tpu_torch.serve.http import make_server
    from featurenet_tpu_torch.serve.service import InferenceService

    cfg = get_config("sprint64")
    a = cfg.arch
    if (cfg.resolution, tuple(a.features), a.hidden, a.num_classes) != \
            (64, (32, 32, 64, 64), 128, 24):
        fail(f"sprint64 is not at full width: {cfg}")
    R = cfg.resolution
    pred = Predictor.from_seed(cfg, seed, batch=64, device="cuda")
    # The main path's run: the service's warmup captures one graph per
    # bucket (after WARMUP_ITERS eager runs each), then traffic replays them.
    _reset_counts()
    service = InferenceService(pred, buckets=SERVE_BUCKETS)
    warmup = _check_warmup(pred, "serve fp32")
    srv = make_server(service, port=0)
    th = threading.Thread(target=srv.serve_forever, name="serve-http", daemon=True)
    th.start()
    port = srv.server_address[1]
    rng = np.random.default_rng(seed)
    grids, answers, lat_stl, lat_burst = [], [], [], []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            parts = []
            for i in range(8):
                lo = rng.uniform(0.0, 0.3, 3)
                hi = lo + rng.uniform(0.2, 0.7, 3)
                path = os.path.join(tmp, f"part{i}.stl")
                save_stl(path, mesh_box(tuple(lo), tuple(hi)))
                with open(path, "rb") as f:
                    parts.append(f.read())
            burst = [voxelize(mesh_box(tuple(lo), tuple(lo + ext)), R).astype("<f4")
                     for lo, ext in zip(rng.uniform(0.0, 0.3, (64, 3)),
                                        rng.uniform(0.2, 0.7, (64, 3)))]
        batches0, replays0 = service.stats()["batches"], pred.replays
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        sock = None
        for data in parts:
            status, body, ms = _post(conn, "/predict", data)
            sock = sock or conn.sock
            if conn.sock is not sock:
                fail("STL requests did not share one keep-alive connection")
            answers.append((status, body))
            grids.append(voxelize(parse_stl(data), R).astype(np.float32))
            lat_stl.append(ms)
        conn.close()
        start = threading.Barrier(len(burst))
        results = [None] * len(burst)

        def client(i):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                c.connect()
                start.wait(60)
                results[i] = _post(c, "/predict_voxels", burst[i].tobytes())
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(burst))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        if any(t.is_alive() for t in threads) or any(r is None for r in results):
            fail("burst clients did not all finish")
        launches = _read_counts()
        st = service.stats()
        replays = pred.replays - replays0
    finally:
        srv.shutdown()
        srv.server_close()
    drained = service.drain()
    for status, body, ms in results:
        answers.append((status, body))
        lat_burst.append(ms)
    grids += [g.astype(np.float32) for g in burst]
    dispatches = st["batches"] - batches0
    for status, body in answers:
        if status != 200 or not {"label", "class_name", "prob", "top3"} <= set(body):
            fail(f"bad answer {status}: {body}")
    if dispatches < 1 or launches != warmup or replays != dispatches:
        fail(f"serve: launches {launches} after warmup's {warmup} (a replay "
             f"launches none); {replays} replays for {dispatches} dispatches")
    events = replay_kernel_events(torch, pred, "serve fp32")
    if drained["exit_code"] != 0 or drained["served"] != len(answers):
        fail(f"drain: {drained}")

    # The same weights through the plain conv on the card.
    plain = build_model(cfg, plain=True)
    plain.load_state_dict(pred.model.state_dict())
    plain = plain.to("cuda")
    x = torch.from_numpy(np.stack(grids)[..., None]).cuda()
    ref = torch.cat([serve_forward(plain, x[i:i + 64]) for i in range(0, len(x), 64)])
    ref = ref.cpu().numpy()
    if not (np.isfinite(ref).all() and np.allclose(ref.sum(-1), 1.0, atol=1e-4)):
        fail("plain-conv forward gives no probability distribution")
    index = {n: i for i, n in enumerate(CLASS_NAMES)}
    prob_err = 0.0
    for (_, body), row in zip(answers, ref):
        prob_err = max(prob_err, abs(body["prob"] - float(row.max())),
                       *(abs(p - float(row[index[n]])) for n, p in body["top3"]))
    if prob_err > PROB_ATOL:
        fail(f"served probabilities differ from the plain-conv forward by {prob_err}")
    # One full bucket through the graph and the plain conv, compared whole.
    kern = pred.forward(x[:64])
    with torch.inference_mode():
        base = serve_forward(plain, x[:64])
    bucket_err = float((kern - base).abs().max())
    if bucket_err > PROB_ATOL:
        fail(f"bucket-64 probabilities differ by {bucket_err}")
    out = {
        "requests": len(answers), "stl_requests": len(parts),
        "voxel_burst": len(burst), "dispatches": dispatches,
        "by_bucket": st["by_bucket"],
        "conv3d_fwd_launches": warmup["conv3d_fwd"],
        "capture_launches_per_graph": {b: pred.program_for(b).capture_launches["conv3d_fwd"]
                                       for b in SERVE_BUCKETS},
        "launches_during_traffic": launches["conv3d_fwd"] - warmup["conv3d_fwd"],
        "replays": replays, "conv3d_fwd_kernel_events_per_replay": events,
        "p50_ms_stl": statistics.median(lat_stl),
        "p50_ms_burst": statistics.median(lat_burst),
        "max_prob_err_vs_plain": prob_err, "bucket64_prob_err": bucket_err,
        "labels": sorted({b["class_name"] for _, b in answers}),
    }
    print("serve", json.dumps(out), flush=True)
    return out


def graphs_phase(torch, seed: int, smi_line: str) -> dict:
    """sprint64 at full width, per serving precision: capture every bucket's
    graph on a fresh Predictor (the largest first), then per bucket the
    graphed probabilities must be bitwise the eager forward's on the same
    input, and the device ms of both (CUDA events: copy-in, replay and
    clone-out against the eager forward) are printed, with the capture
    seconds, the conv3d_fwd launches each graph captured, the kernel's
    device events per replay, and the memory the generation reserves."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS

    cfg = get_config("sprint64")
    R = cfg.resolution
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = {b: (torch.rand((b, R, R, R, 1), device="cuda", generator=g) > 0.7).float()
          for b in SERVE_BUCKETS}
    out = {}
    for precision in SERVE_PRECISIONS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        pred = Predictor.from_seed(cfg, seed, batch=64, device="cuda",
                                   precision=precision)
        torch.cuda.synchronize()
        weights_mb = (torch.cuda.memory_reserved() - base) / 1e6
        t0 = time.perf_counter()
        progs = {b: pred.program_for(b) for b in sorted(SERVE_BUCKETS, reverse=True)}
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.empty_cache()  # the eager warmups' blocks, not the graphs'
        generation_mb = (torch.cuda.memory_reserved() - base) / 1e6
        buckets = {}
        for b in SERVE_BUCKETS:
            x = xs[b]
            graphed = pred.forward(x)
            with torch.inference_mode():
                eager = pred.forward_eager(x)
            if not torch.equal(graphed, eager):
                fail(f"graphs {precision} bucket {b}: graphed probabilities differ "
                     f"from the eager forward's by {float((graphed - eager).abs().max())}")
            with torch.inference_mode():
                eager_ms = time_ms(torch, lambda: pred.forward_eager(x))
            buckets[b] = {"graphed_ms": time_ms(torch, lambda: pred.forward(x)),
                          "eager_ms": eager_ms, "bitwise_eager": True,
                          "capture_s": progs[b].capture_s,
                          "capture_conv3d_fwd": progs[b].capture_launches["conv3d_fwd"]}
        events = replay_kernel_events(torch, pred, f"graphs {precision}")
        out[precision] = {"buckets": buckets, "build_s": build_s,
                          "capture_s": sum(p.capture_s for p in progs.values()),
                          "weights_reserved_mb": weights_mb,
                          "generation_reserved_mb": generation_mb,
                          "conv3d_fwd_kernel_events_per_replay": events}
        del pred, progs
    print("graphs", json.dumps({**out, "nvidia_smi": smi_line}), flush=True)
    return out


def _seeded_checkpoint(path: str, cfg, seed: int) -> str:
    """A one-step checkpoint directory of ``cfg``'s model from ``seed``,
    written by the port's CheckpointManager."""
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    state = create_state(build_model(cfg, seed=seed), cfg)
    state.step = 1
    mgr = CheckpointManager(path, config=cfg)
    mgr.save(state)
    mgr.close()
    return path


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _prob_err(body: dict, row, index: dict) -> float:
    """How far one answer (prob and top 3) is from a probability row."""
    return max(abs(body["prob"] - float(row.max())),
               *(abs(p - float(row[index[n]])) for n, p in body["top3"]))


def reload_phase(torch, seed: int, smi_line: str) -> dict:
    """sprint64 at full width served from checkpoint ``a`` over HTTP while
    RELOAD_CLIENTS keep-alive clients post voxel grids; mid-burst a
    corrupted copy of checkpoint ``b`` is refused with 409 (``a`` still
    serving), then ``POST /admin/reload`` swaps to ``b``. Every request must
    be answered 200 with one generation's eager forward (PROB_ATOL): ``a``'s
    before the swap began, ``b``'s after it returned; /healthz names ``b``
    after the flip. Prints the swap ms, the capture seconds and the memory
    reserved with one and with two generations resident."""
    import shutil

    import numpy as np

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES, generate_batch
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.runtime.registry import WARMUP_ITERS
    from featurenet_tpu_torch.serve.http import make_server
    from featurenet_tpu_torch.serve.service import InferenceService
    from featurenet_tpu_torch.train import checkpoint

    cfg = get_config("sprint64")
    R = cfg.resolution
    grids = generate_batch(np.random.default_rng(seed + 2), RELOAD_GRIDS,
                           R)["voxels"][..., 0].astype("<f4")
    index = {n: i for i, n in enumerate(CLASS_NAMES)}
    with tempfile.TemporaryDirectory() as tmp:
        a = _seeded_checkpoint(os.path.join(tmp, "a"), cfg, seed)
        b = _seeded_checkpoint(os.path.join(tmp, "b"), cfg, seed + 1)
        bad = os.path.join(tmp, "bad")
        shutil.copytree(b, bad)
        step = os.path.join(bad, checkpoint.step_filename(1))
        with open(step, "r+b") as fh:
            fh.seek(os.path.getsize(step) // 2)
            byte = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([byte[0] ^ 0xFF]))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        pred = Predictor.from_checkpoint(a, batch=64, device="cuda")
        _reset_counts()
        service = InferenceService(pred, buckets=SERVE_BUCKETS)
        _check_warmup(pred, "reload a")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        one_mb = (torch.cuda.memory_reserved() - base) / 1e6
        version_a = pred.model_version
        srv = make_server(service, port=0)
        threading.Thread(target=srv.serve_forever, name="serve-http",
                         daemon=True).start()
        port = srv.server_address[1]
        stop = threading.Event()
        answers, lock = [], threading.Lock()

        def client(i):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            try:
                k = i
                while not stop.is_set():
                    g = k % RELOAD_GRIDS
                    t0 = time.perf_counter()
                    status, body, _ = _post(c, "/predict_voxels", grids[g].tobytes())
                    with lock:
                        answers.append((t0, time.perf_counter(), g, status, body))
                    k += RELOAD_CLIENTS
            finally:
                c.close()

        def answered():
            with lock:
                return len(answers)

        def wait_for(n):
            deadline = time.perf_counter() + 120
            while answered() < n and time.perf_counter() < deadline:
                time.sleep(0.005)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(RELOAD_CLIENTS)]
        reserved_peak = None
        try:
            for t in threads:
                t.start()
            wait_for(RELOAD_CLIENTS)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            refused = _post(conn, "/admin/reload",
                            json.dumps({"checkpoint_dir": bad}).encode())
            health_refused = _get(port, "/healthz")
            wait_for(answered() + RELOAD_CLIENTS)
            torch.cuda.reset_peak_memory_stats()
            t_swap = time.perf_counter()
            swapped = _post(conn, "/admin/reload",
                            json.dumps({"checkpoint_dir": b}).encode())
            t_flip = time.perf_counter()
            conn.close()
            reserved_peak = (torch.cuda.max_memory_reserved() - base) / 1e6
            health = _get(port, "/healthz")
            wait_for(answered() + 2 * RELOAD_CLIENTS)
        finally:
            stop.set()
            for t in threads:
                t.join(180)
            srv.shutdown()
            srv.server_close()
        drained = service.drain()
        launches = _read_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        after_mb = (torch.cuda.memory_reserved() - base) / 1e6
        capture_s = sum(pred.program_for(k).capture_s for k in SERVE_BUCKETS)
        captured_b = pred.program_for(1).capture_launches
        if any(pred.program_for(k).capture_launches != captured_b
               for k in SERVE_BUCKETS):
            fail("reload: b's graphs captured different launches")
        x = torch.from_numpy(grids[..., None]).cuda()
        with torch.inference_mode():
            ref_b = pred.forward_eager(x).cpu().numpy()
            old = Predictor.from_checkpoint(a, batch=64, device="cuda")
            ref_a = old.forward_eager(x).cpu().numpy()
        del old
    if any(t.is_alive() for t in threads):
        fail("reload: burst clients did not all finish")
    status, body, _ = refused
    if status != 409 or body.get("error") != "swap_refused" \
            or body.get("model_version") != version_a \
            or health_refused[1].get("model_version") != version_a:
        fail(f"reload: the corrupted candidate got {status} {body}; "
             f"healthz {health_refused}")
    status, body, swap_wall_ms = swapped
    if status != 200 or not body.get("model_version", "").startswith("b@1-"):
        fail(f"reload: /admin/reload to b answered {status} {body}")
    version_b = body["model_version"]
    status, h = health
    if not (status == 200 and h["ready"] and h["model_version"] == version_b
            and h["checkpoint_dir"] == b):
        fail(f"reload: /healthz after the flip {health}")
    # Two warmups (a's at start-up, b's in the swap), and no launch from
    # the traffic: every dispatch replayed a graph.
    want = dict(_want_counts("xla", 0, 0),
                conv3d_fwd=2 * 3 * (WARMUP_ITERS + 1) * len(SERVE_BUCKETS))
    if launches != want or captured_b != dict(_want_counts("xla", 0, 0), conv3d_fwd=3):
        fail(f"reload: launches {launches}, not {want}; b's graphs captured "
             f"{captured_b}")
    if drained["exit_code"] != 0 or drained["served"] != len(answers):
        fail(f"reload: drain {drained} for {len(answers)} answers")
    gap = float(np.abs(ref_a - ref_b).max())
    by_gen, worst = {"a": 0, "b": 0}, 0.0
    for t0, t1, g, status, body in answers:
        if status != 200:
            fail(f"reload: a request was answered {status}: {body}")
        err = {"a": _prob_err(body, ref_a[g], index), "b": _prob_err(body, ref_b[g], index)}
        gen = min(err, key=err.get)
        if err[gen] > PROB_ATOL or (t1 < t_swap and gen != "a") \
                or (t0 > t_flip and gen != "b"):
            fail(f"reload: an answer ({t0:.3f}-{t1:.3f} s; swap {t_swap:.3f}-"
                 f"{t_flip:.3f} s) matches a by {err['a']}, b by {err['b']}")
        by_gen[gen] += 1
        worst = max(worst, err[gen])
    if by_gen["a"] == 0 or by_gen["b"] == 0:
        fail(f"reload: answers by generation {by_gen}; the swap was not mid-burst")
    out = {"requests": len(answers), "clients": RELOAD_CLIENTS,
           "answers_by_generation": by_gen, "max_prob_err_vs_eager": worst,
           "generations_max_prob_gap": gap,
           "refused": {"status": refused[0], "kind": refused[1].get("kind")},
           "from_version": version_a, "to_version": version_b,
           "swap_ms": swapped[1]["swap_ms"], "swap_wall_ms": swap_wall_ms,
           "capture_s_new_generation": capture_s,
           "reserved_mb_one_generation": one_mb,
           "reserved_mb_peak_during_swap": reserved_peak,
           "reserved_mb_after_swap": after_mb,
           "launches": launches, "nvidia_smi": smi_line}
    print("reload", json.dumps(out), flush=True)
    return out


def _reset_counts():
    from featurenet_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def _read_counts() -> dict[str, int]:
    from featurenet_tpu_torch.ops import launch_counts

    return launch_counts()


def _check_warmup(pred, what: str) -> dict[str, int]:
    """The launches of a service's warmup, counted from 0: every bucket's
    graph captured exactly 3 conv3d_fwd (one per 3³ block) and nothing
    else, after WARMUP_ITERS eager runs. Returns the counts."""
    from featurenet_tpu_torch.runtime.registry import WARMUP_ITERS

    counts = _read_counts()
    per_graph = dict(_want_counts("xla", 0, 0), conv3d_fwd=3)
    for b in SERVE_BUCKETS:
        prog = pred.program_for(b)
        if prog.graph is None or prog.capture_launches != per_graph:
            fail(f"{what}: bucket {b}'s graph captured {prog.capture_launches}, "
                 f"not {per_graph}")
    want = dict(_want_counts("xla", 0, 0),
                conv3d_fwd=3 * (WARMUP_ITERS + 1) * len(SERVE_BUCKETS))
    if counts != want:
        fail(f"{what}: warmup launched {counts}, not {want}")
    return counts


def graph_launch_events(torch, calls: list, names) -> list[dict]:
    """Under torch.profiler, each of ``calls`` (one CUDA graph launch each)
    once: the device events of each launch whose names contain each of
    ``names``, matched to the launch by correlation id. Every call also
    runs once before the counted ones and once after them, uncounted, so
    that the events the profiler loses at its window's edges
    (PROFILE_PAD_S) fall on launches that are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in ("lead", "counted", "tail"):
            for call in calls:
                call()
            torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    events = prof.events()
    launches = sorted((e.time_range.start, e.id) for e in events
                      if e.device_type == DeviceType.CPU
                      and e.name == "cudaGraphLaunch")
    if len(launches) != 3 * len(calls):
        fail(f"profiled {len(launches)} graph launches for {len(calls)} calls "
             f"run 3 times")
    counted = [cid for _, cid in launches[len(calls):2 * len(calls)]]
    per = {cid: dict.fromkeys(names, 0) for cid in counted}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.id in per:
            for n in names:
                per[e.id][n] += int(n in e.name)
    return [per[cid] for cid in counted]


def replay_kernel_events(torch, pred, what: str) -> float:
    """Under torch.profiler, REPLAY_PROFILE_REPS replays of every bucket's
    graph: the device events of conv3d_fwd_kernel in each replay, which
    must be 3 (the hand-written kernel runs inside each replay)."""
    R = pred.cfg.resolution
    xs = [torch.zeros((b, R, R, R, 1), device="cuda") for b in SERVE_BUCKETS]
    calls = [functools.partial(pred.forward, x) for x in xs
             for _ in range(REPLAY_PROFILE_REPS)]
    per = [c["conv3d_fwd_kernel"] for c in
           graph_launch_events(torch, calls, ("conv3d_fwd_kernel",))]
    if per != [3] * len(calls):
        fail(f"{what}: conv3d_fwd_kernel device events per replay {per}, "
             f"not 3 each")
    return sum(per) / len(per)


def _forward_shared_conv(torch):
    """``conv3d_p`` with the kernel's forward and the plain version's
    backward (autograd through ``conv3d_plain`` at the same inputs)."""
    from featurenet_tpu_torch.ops import conv3d

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x, w)
            return conv3d.conv3d_fwd(x, w)

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            with torch.enable_grad():
                xd, wd = x.detach().requires_grad_(), w.detach().requires_grad_()
                y = conv3d.conv3d_plain(xd, wd)
            return torch.autograd.grad(y, (xd, wd), g)

    return Conv.apply


def _plain_reordered_conv(torch):
    """``conv3d_plain`` with its taps summed in the reverse order: another
    fp32 rounding of the same plain conv."""
    import torch.nn.functional as F

    def conv(x, w):
        k, cout = w.shape[0], w.shape[-1]
        p = (k - 1) // 2
        b, d, h, wd, _ = x.shape
        xp = F.pad(x.float(), (0, 0, p, p, p, p, p, p))
        wf = w.float()
        out = torch.zeros((b, d, h, wd, cout), dtype=torch.float32, device=x.device)
        for kz in reversed(range(k)):
            for ky in reversed(range(k)):
                for kx in reversed(range(k)):
                    out = out + xp[:, kz:kz + d, ky:ky + h, kx:kx + wd, :] @ wf[kz, ky, kx]
        return out

    return conv


def _one_step(torch, trainer, snapshot, voxels, labels, convs: str, dtype,
              precision: str = "fp32"):
    """One train step from ``snapshot`` (model state + optimizer moments
    and count) on float ``voxels`` and ``labels``, dropout off, with
    activations in ``dtype`` and the working copy of ``precision``
    (fp16_scaled at a loss scale of RUNG_LOSS_SCALE), with ``convs``: the
    ``kernel``s, their ``plain`` versions, the kernels' forward and the
    plain backward (``forward_shared``), or the plain conv with its taps
    reordered (``plain_reordered``; the pallas blocks only); returns
    (loss, grads, new state_dict)."""
    import dataclasses

    from featurenet_tpu_torch.models.featurenet import FeatureNet
    from featurenet_tpu_torch.ops.conv3d import (
        HybridConv,
        PallasConv,
        conv3d_hybrid,
        conv3d_hybrid_plain,
    )
    from featurenet_tpu_torch.train.precision import get_policy
    from featurenet_tpu_torch.train.steps import loss_and_grads, make_optimizer

    cfg = trainer.cfg
    arch = dataclasses.replace(cfg.arch, dropout=0.0)
    model = FeatureNet(arch, cfg.resolution, dtype=dtype,
                       plain=convs in ("plain", "plain_reordered")).to("cuda")
    if convs in ("forward_shared", "plain_reordered"):
        pallas = (_forward_shared_conv(torch) if convs == "forward_shared"
                  else _plain_reordered_conv(torch))
        for m in model.modules():
            if isinstance(m, PallasConv):
                m.conv = pallas
            elif isinstance(m, HybridConv) and m.conv is conv3d_hybrid:
                m.conv = conv3d_hybrid_plain  # its forward is the library's
    model.load_state_dict(snapshot["model"])
    opt = make_optimizer(cfg, model.parameters())
    opt.count = snapshot["count"]
    for dst, src in zip(opt.mu + opt.nu, snapshot["mu"] + snapshot["nu"]):
        dst.copy_(src)
    policy = get_policy(precision)
    scale = (torch.tensor(RUNG_LOSS_SCALE, device="cuda")
             if policy.loss_scaling else None)
    grads, metrics = loss_and_grads(model, voxels, labels, cfg.label_smoothing,
                                    policy=policy, loss_scale=scale)
    grads = policy.master_grads(grads)
    if scale is not None:
        grads = [g * (1.0 / scale) for g in grads]
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            fail(f"{precision} step at loss scale {RUNG_LOSS_SCALE} overflowed")
    opt.update(grads)
    names = [n for n, _ in model.named_parameters()]
    return float(metrics["loss"].detach()), dict(zip(names, grads)), model.state_dict()


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / max(float(b.float().norm()), 1e-30))


def step_vs_plain(torch, trainer, snapshot, voxels, labels, backend,
                  precision: str = "fp32") -> dict:
    """The kernel step against the plain step (STEP_TOL): in fp32 and bf16
    under the fp32 policy; a reduced ``precision`` with the bf16 model
    only, the dtype it trains."""
    lr = float(trainer.state.optimizer.schedule(snapshot["count"]))
    out = {"lr": lr}
    models = [("fp32", torch.float32), ("bf16", torch.bfloat16)]
    if precision != "fp32":
        models = models[1:]
    for tag, dtype in models:
        name = tag if precision == "fp32" else precision

        def run(convs):
            return _one_step(torch, trainer, snapshot, voxels, labels, convs,
                             dtype, precision)

        def worst(grads, ref):
            err = {n: _rel(grads[n], ref[n]) for n in ref}
            return max(err.values()), max(err, key=err.get)

        loss_k, grads_k, state_k = run("kernel")
        loss_p, grads_p, state_p = run("plain")
        stats = [k for k in state_p if k.endswith((".mean", ".var"))]
        vs_plain, leaf = worst(grads_k, grads_p)
        r = {"loss_abs_err": abs(loss_k - loss_p),
             "grad_rel_err": vs_plain, "worst_leaf": leaf,
             "bn_stat_rel_err": max(_rel(state_k[k], state_p[k]) for k in stats),
             "param_abs_err": max(float((state_k[n] - state_p[n]).abs().max())
                                  for n in grads_p)}
        if tag == "bf16":  # see STEP_TOL: held against the forward-shared step
            r["grad_rel_err_vs_plain_step"] = vs_plain
            r["worst_leaf_vs_plain_step"] = leaf
            r["grad_rel_err"], r["worst_leaf"] = worst(grads_k, run("forward_shared")[1])
            if backend.startswith("pallas"):
                r["grad_rel_err_plain_reordered"] = worst(
                    run("plain_reordered")[1], grads_p)[0]
        out[name] = r
        tol = STEP_TOL[tag]
        if not (r["loss_abs_err"] <= tol["loss"] and r["grad_rel_err"] <= tol["grad"]
                and r["bn_stat_rel_err"] <= tol["grad"]
                and r["param_abs_err"] <= 2 * lr + 1e-6):
            fail(f"train {backend}: {name} kernel step vs plain step {r} "
                 f"exceeds {tol} (params: 2 x lr {lr})")
    return out


def host_generation(torch, seed: int, workers: int) -> dict:
    """Synthetic 64³ parts per second (generate_batch + to_wire) that one
    host thread makes, and that the trainer's Prefetcher with ``workers``
    threads delivers to the card from its start through ``workers``
    batches of TRAIN_BATCH: the input rate a train step cannot outrun."""
    import numpy as np

    from featurenet_tpu_torch.data.dataset import Prefetcher, SyntheticVoxelDataset
    from featurenet_tpu_torch.data.synthetic import generate_batch, to_wire

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    to_wire(generate_batch(rng, 64, 64))
    one = 64 / (time.perf_counter() - t0)
    n = workers
    t0 = time.perf_counter()
    feed = Prefetcher(SyntheticVoxelDataset(64, TRAIN_BATCH, seed=seed), "cuda",
                      num_workers=workers)
    try:
        for _ in range(n):
            next(feed)
        torch.cuda.synchronize()
    finally:
        feed.close()
    out = {"one_thread_parts_per_sec": one, "workers": workers,
           "prefetcher_parts_per_sec": n * TRAIN_BATCH / (time.perf_counter() - t0),
           "cpus": len(os.sched_getaffinity(0))}
    print("data", json.dumps(out), flush=True)
    return out


def profile_steps(torch, trainer, batch, backend: str, steps: int = 3) -> dict:
    """``steps`` train steps on a batch already on the card under
    torch.profiler (CPU and CUDA activity): the top CUDA kernels by total
    device time, the device-busy share of the window from the first
    device event's start to the last one's end (the union of device event
    intervals over that span), and the device ms per step of the kernels
    launched inside each of the port's PROFILE_RANGES (the optimizer
    update, the forward's batch-norm and ReLU epilogues, its casts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def is_kernel(e):  # record_function ranges also appear on the device side
        return e.device_type == DeviceType.CUDA and not e.is_user_annotation

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    kernels = sorted((e for e in averages if is_kernel(e)),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in kernels)
    ranges = {name: sum(e.device_time_total for e in averages
                        if e.key == name and e.device_type == DeviceType.CPU)
              / 1e3 / steps for name in PROFILE_RANGES}
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if is_kernel(e))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    window_us = spans[-1][1] - spans[0][0] if spans else 0.0
    out = {"backend": backend, "steps": steps, "wall_ms_profiled": wall_ms,
           "device_ms_per_step": device_us / 1e3 / steps,
           "device_window_ms": window_us / 1e3,
           "device_busy_share": busy_us / window_us if window_us else None,
           # Forward ranges only: the backward's kernels run on autograd's
           # thread, outside them.
           "range_device_ms_per_step": ranges,
           "top_kernels": [{"name": e.key[:120], "calls": e.count,
                            "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
                            "share": e.self_device_time_total / device_us if device_us else None}
                           for e in kernels[:8]]}
    if device_us == 0:
        out["device_time"] = "key_averages() recorded no device time"
    print("profile", json.dumps(out), flush=True)
    return out


def train_phase(torch, seed: int, backend: str) -> dict:
    import dataclasses

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.dataset import Prefetcher
    from featurenet_tpu_torch.train.loop import Trainer
    from featurenet_tpu_torch.train.steps import unpack_voxels

    cfg = get_config("sprint64", seed=seed, total_steps=TRAIN_STEPS,
                     global_batch=TRAIN_BATCH, log_every=1,
                     eval_every=TRAIN_STEPS, eval_batches=EVAL_BATCHES,
                     data_workers=TRAIN_WORKERS)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend=backend))
    a = cfg.arch
    if (cfg.resolution, cfg.global_batch, tuple(a.features), a.hidden,
            a.num_classes, a.dropout) != (64, TRAIN_BATCH, (32, 32, 64, 64), 128,
                                          24, 0.5):
        fail(f"sprint64 training is not at full width: {cfg}")
    with open(os.devnull, "w") as sink:
        trainer = Trainer(cfg, device="cuda", stream=sink)
        before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _read_counts()
    steps = TRAIN_STEPS
    want = _want_counts(backend, steps, EVAL_BATCHES)
    if counts != want:
        fail(f"train {backend}: launches {counts} != {want}")
    hist = [r for r in trainer.logger.history if r["kind"] == "train"]
    losses = [r["loss"] for r in hist]
    if len(losses) != steps or not all(map(lambda v: v == v and abs(v) < 1e30, losses)):
        fail(f"train {backend}: losses {losses}")
    after = trainer.state.model.state_dict()
    moved = {k: float((after[k] - before[k]).abs().max()) for k in before}
    params = [n for n, _ in trainer.state.model.named_parameters()]
    stats = [k for k in before if k.endswith((".mean", ".var"))]
    if not all(moved[k] > 0 for k in params + stats):
        fail(f"train {backend}: some parameters or BN stats did not move: {moved}")
    evals = [r for r in trainer.logger.history if r["kind"] == "eval"]
    if len(evals) != 1 or not 0.0 <= evals[0]["accuracy"] <= 1.0:
        fail(f"train {backend}: eval records {evals}")

    # Device time of one step on a batch already on the card.
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             next(trainer.train_data.worker_iter(0)).items()}
    snapshot = {"model": {k: v.clone() for k, v in after.items()},
                "count": trainer.state.optimizer.count,
                "mu": [t.clone() for t in trainer.state.optimizer.mu],
                "nu": [t.clone() for t in trainer.state.optimizer.nu]}
    step_ms = time_ms(torch, lambda: trainer.step(batch), reps=5, warmup=1)
    # The same while the producer threads generate: they share the GIL
    # with the thread that launches the step.
    feed = Prefetcher(trainer.train_data, "cuda", num_workers=cfg.data_workers)
    try:
        busy_ms = time_ms(torch, lambda: trainer.step(batch), reps=5, warmup=1)
    finally:
        feed.close()

    profile_steps(torch, trainer, batch, backend)

    # One step through the kernels vs the plain versions, same state/batch
    # (xla runs the same library call both ways).
    versus = (step_vs_plain(torch, trainer, snapshot, unpack_voxels(batch["voxels"]),
                            batch["label"], backend)
              if backend != "xla" else None)
    t = trainer.timing
    out = {
        "backend": backend, "steps": steps, "global_batch": cfg.global_batch,
        "data_workers": cfg.data_workers, "losses": losses,
        "eval_accuracy": evals[0]["accuracy"], "launches": counts,
        "launches_per_step": {k: v / steps for k, v in counts.items()},
        "run_s": run_s, "device_step_ms": step_ms,
        "device_step_ms_producers_busy": busy_ms,
        "samples_per_sec_with_data_wait": steps * cfg.global_batch / t["wall_s"],
        "data_wait_share": t["data_wait_s"] / t["wall_s"],
        # Host seconds of the steps themselves (launch, sync, logging),
        # first-use set-up included: wall minus data wait.
        "step_wall_s": t["wall_s"] - t["data_wait_s"],
        "step_vs_plain": versus,
    }
    print("train", json.dumps(out), flush=True)
    del trainer
    torch.cuda.empty_cache()
    return out


def _want_counts(backend: str, steps: int, eval_batches: int) -> dict[str, int]:
    """Kernel launches of ``steps`` train steps and ``eval_batches`` eval
    batches under ``backend``."""
    want = dict.fromkeys(("conv3d_fwd", "conv3d_dw", "conv3d_dw_sum",
                          "conv_dw_folded", "conv_dw_folded_sum"), 0)
    if backend == "pallas":
        want.update(conv3d_fwd=6 * steps + 3 * eval_batches,
                    conv3d_dw=3 * steps, conv3d_dw_sum=3 * steps)
    elif backend == "hybrid_dw":
        want.update(conv_dw_folded=3 * steps, conv_dw_folded_sum=3 * steps)
    return want


def _train_state(trainer) -> dict:
    """Model state, Adam moments by parameter name, count and step."""
    opt = trainer.state.optimizer
    names = [n for n, _ in trainer.state.model.named_parameters()]
    return {"model": dict(trainer.state.model.state_dict()),
            "mu": dict(zip(names, opt.mu)), "nu": dict(zip(names, opt.nu)),
            "count": int(opt.count), "step": trainer.state.step}


def _bitwise_equal(torch, a: dict, b: dict) -> bool:
    return ((a["count"], a["step"]) == (b["count"], b["step"])
            and all(set(a[g]) == set(b[g]) and
                    all(torch.equal(a[g][k], b[g][k]) for k in a[g])
                    for g in ("model", "mu", "nu")))


def checkpoint_phase(torch, seed: int, device_step_ms: float, smi_line: str) -> dict:
    """Train with checkpoints, resume, walk back past a damaged step and
    serve from the checkpoint directory, all at sprint64's full width."""
    import numpy as np

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.runtime import serve_forward
    from featurenet_tpu_torch.runtime.registry import WARMUP_ITERS
    from featurenet_tpu_torch.train import checkpoint
    from featurenet_tpu_torch.train.loop import Trainer
    from featurenet_tpu_torch.train.steps import unpack_voxels

    steps, parts, bucket = 3, 40, 16
    counts = dict.fromkeys(_read_counts(), 0)

    def add(got: dict, want: dict, what: str):
        if got != want:
            fail(f"checkpoint {what}: launches {got} != {want}")
        for k, v in got.items():
            counts[k] += v

    with tempfile.TemporaryDirectory() as tmp, open(os.devnull, "w") as sink:
        ck = os.path.join(tmp, "ck")
        cfg = get_config("sprint64", seed=seed, total_steps=steps,
                         global_batch=TRAIN_BATCH, log_every=1, eval_every=steps,
                         eval_batches=EVAL_BATCHES, data_workers=TRAIN_WORKERS,
                         checkpoint_dir=ck, checkpoint_every=1)
        a = cfg.arch
        if (cfg.resolution, tuple(a.features), a.hidden, a.num_classes,
                a.conv_backend) != (64, (32, 32, 64, 64), 128, 24, "pallas"):
            fail(f"checkpoint phase is not sprint64 at full width: {cfg}")
        first = Trainer(cfg, device="cuda", stream=sink)
        torch.cuda.synchronize()
        _reset_counts()
        first.run()
        torch.cuda.synchronize()
        add(_read_counts(), _want_counts("pallas", steps, EVAL_BATCHES), "run")
        if first.ckpt.all_steps() != [1, 2, 3]:
            fail(f"checkpoint steps on disk {first.ckpt.all_steps()}")

        second = Trainer(cfg, device="cuda", stream=sink)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if second.resume_if_available() != steps:
            fail(f"resumed at step {second.state.step}, not {steps}")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if not _bitwise_equal(torch, _train_state(first), _train_state(second)):
            fail("the resumed state differs from the trained one")

        # One more step each on one batch: cuDNN (the stem's conv) picks
        # deterministic algorithms here, so the two must stay bitwise equal.
        batch = {k: torch.from_numpy(v).cuda() for k, v in
                 next(first.train_data.worker_iter(0)).items()}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            _reset_counts()
            first.step(batch)
            second.step(batch)
            torch.cuda.synchronize()
            add(_read_counts(), _want_counts("pallas", 2, 0), "resumed step")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if not _bitwise_equal(torch, _train_state(first), _train_state(second)):
            fail("one step after the resume differs from the same step of the "
                 "run that never stopped")

        # Damage one byte of the newest step: a restore walks back.
        path = os.path.join(ck, checkpoint.step_filename(steps))
        with open(path, "r+b") as fh:
            fh.seek(os.path.getsize(path) // 2)
            byte = fh.read(1)
            fh.seek(-1, os.SEEK_CUR)
            fh.write(bytes([byte[0] ^ 0xFF]))
        mgr = checkpoint.CheckpointManager(ck)
        try:
            mgr.restore(second.state, step=steps)
            fail("an explicit restore of the damaged step did not raise")
        except checkpoint.ChecksumMismatch:
            pass
        mgr.restore(second.state)
        if (mgr.restored_step, second.state.step) != (steps - 1, steps - 1):
            fail(f"walk-back restored step {mgr.restored_step}")

        # Serve from the checkpoint directory: step 2, through the kernel,
        # on the graph the first dispatch captures (after WARMUP_ITERS
        # eager runs), which every dispatch replays.
        pred = Predictor.from_checkpoint(ck, batch=bucket, device="cuda")
        if not pred.model_version.startswith(f"ck@{steps - 1}-"):
            fail(f"model_version {pred.model_version}")
        packed = next(first.eval_data.worker_iter(0))["voxels"][:parts]
        grids = unpack_voxels(torch.from_numpy(packed)).numpy()
        _reset_counts()
        labels, probs = pred.predict_voxels(grids)
        torch.cuda.synchronize()
        dispatches = -(-parts // bucket)
        add(_read_counts(), dict(_want_counts("xla", 0, 0),
                                 conv3d_fwd=3 * (WARMUP_ITERS + 1)), "serving")
        if (pred.replays, pred.program_for(bucket).capture_launches["conv3d_fwd"]) \
                != (dispatches, 3):
            fail(f"checkpoint serving: {pred.replays} replays for {dispatches} "
                 f"dispatches; {pred.program_for(bucket).capture_launches}")
        x = torch.from_numpy(grids).cuda()
        want = torch.cat([serve_forward(second.state.model, x[i:i + bucket])
                          for i in range(0, parts, bucket)]).cpu().numpy()
        if not np.array_equal(labels, want.argmax(-1)):
            fail("labels served from the checkpoint differ from the restored "
                 "model's")
        prob_err = float(np.abs(probs - want).max())

        # Saves back to back, one per step on a batch already on the card:
        # the third save waits for a free snapshot slot.
        back = []
        for _ in range(5):
            first.step(batch)
            t0 = time.perf_counter()
            first.ckpt.save(first.state)
            back.append((time.perf_counter() - t0) * 1e3)
        first.ckpt.wait()
        t = first.timing
        w = first.ckpt.timing
        out = {
            "steps": steps, "steps_on_disk": [1, 2, 3], "resumed_step": steps,
            "resume_bitwise": True, "resumed_step_bitwise": True,
            "walked_back_to": mgr.restored_step,
            "served_parts": parts, "dispatches": dispatches,
            "model_version": pred.model_version, "max_prob_err": prob_err,
            "launches": counts,
            "save_ms_mean_in_run": t["save_s"] / t["saves"] * 1e3,
            "saves_in_run": t["saves"],
            "save_ms_back_to_back": back,
            "device_step_ms_pallas": device_step_ms,
            "writer_ms_per_save": w["write_s"] / w["writes"] * 1e3,
            "writes": w["writes"],
            "restore_ms": restore_ms,
            "checkpoint_bytes": w["bytes"],
            "nvidia_smi": smi_line,
        }
        first.ckpt.close()
        second.ckpt.close()
    print("checkpoint", json.dumps(out), flush=True)
    del first, second, pred
    torch.cuda.empty_cache()
    return out


def cli_phase(seed: int) -> dict:
    """``cli train --checkpoint-dir D`` then ``cli serve --checkpoint-dir
    D`` in subprocesses on the card; every process is stopped on the way
    out."""
    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "featurenet_tpu_torch.cli"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        tr = subprocess.run(cli + ["train", "--config", "sprint64", "--seed",
                                   str(seed), "--total-steps", "3",
                                   "--checkpoint-dir", ck, "--checkpoint-every",
                                   "1", "--eval-batches", "1"],
                            cwd=root, capture_output=True, text=True, timeout=600)
        train_s = time.perf_counter() - t0
        if tr.returncode != 0:
            fail(f"cli train exited {tr.returncode}: {tr.stderr[-2000:]}")
        records = [json.loads(line) for line in tr.stdout.splitlines()]
        saved = [r for r in records if r.get("kind") == "checkpoint"]
        if len(saved) != 1 or saved[0]["saves"] != 3:
            fail(f"cli train saved {saved}")
        t0 = time.perf_counter()
        srv = subprocess.Popen(cli + ["serve", "--checkpoint-dir", ck, "--port",
                                      "0", "--duration-s", "300"],
                               cwd=root, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        try:
            banner = json.loads(srv.stdout.readline())["serving"]
            ready_s = time.perf_counter() - t0
            if not banner["model_version"].startswith("ck@3-"):
                fail(f"cli serve banner {banner}")
            rng = np.random.default_rng(seed)
            conn = http.client.HTTPConnection("127.0.0.1", banner["port"],
                                              timeout=120)
            answers = []
            for _ in range(4):
                grid = np.zeros((64, 64, 64), "<f4")
                lo = rng.integers(4, 24, 3)
                hi = lo + rng.integers(12, 36, 3)
                grid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1.0
                status, body, _ = _post(conn, "/predict_voxels", grid.tobytes())
                if status != 200 or "class_name" not in body:
                    fail(f"cli serve answered {status}: {body}")
                answers.append(body["class_name"])
            conn.close()
            srv.send_signal(signal.SIGTERM)
            out, err = srv.communicate(timeout=120)
        finally:
            if srv.poll() is None:
                srv.kill()
                srv.communicate()
        if srv.returncode != 0:
            fail(f"cli serve exited {srv.returncode}: {err[-2000:]}")
        stats = json.loads(out.strip().splitlines()[-1])["serve_stats"]
        if stats["served"] != len(answers):
            fail(f"cli serve stats {stats}")
    out = {"train_s": train_s, "checkpoint_record": saved[0],
           "serve_ready_s": ready_s, "model_version": banner["model_version"],
           "served": stats["served"], "labels": answers}
    print("cli", json.dumps(out), flush=True)
    return out


def _cache_run(torch, seed: int, cache: str, backend: str, resident: bool):
    """sprint64 at batch 256 for CACHE_STEPS steps from ``cache`` under
    ``backend``, resident on the card or streamed by TRAIN_WORKERS
    producer threads, rotating in the step; then one eval pass over the
    held-out split. Returns the run's record and the trainer."""
    import dataclasses

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = get_config("sprint64", seed=seed, total_steps=CACHE_STEPS,
                     global_batch=TRAIN_BATCH, log_every=CACHE_STEPS // 2,
                     eval_every=CACHE_STEPS, data_workers=TRAIN_WORKERS,
                     data_cache=cache, hbm_cache=resident)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend=backend))
    a = cfg.arch
    if (cfg.resolution, tuple(a.features), a.hidden, a.num_classes, a.dropout,
            cfg.device_augment, cfg.augment_groups) != \
            (64, (32, 32, 64, 64), 128, 24, 0.5, True, 8):
        fail(f"cache run is not sprint64 at full width with in-step rotation: {cfg}")
    mode = "hbm" if resident else "cache"
    with open(os.devnull, "w") as sink:
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device="cuda", stream=sink)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if resident and not (trainer._data.is_cuda and trainer._labels.is_cuda):
            fail("the resident split is not on the card")
        eval_batches = -(-len(trainer.eval_data) // TRAIN_BATCH)
        _reset_counts()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _read_counts()
    want = _want_counts(backend, CACHE_STEPS, eval_batches)
    if counts != want:
        fail(f"train {mode} {backend}: launches {counts} != {want}")
    hist = trainer.logger.history
    windows = [r for r in hist if r["kind"] == "train"]
    losses = [r["loss"] for r in windows]
    evals = [r for r in hist if r["kind"] == "eval"]
    if len(losses) != 2 or not all(v == v and abs(v) < 1e30 for v in losses):
        fail(f"train {mode} {backend}: losses {losses}")
    if len(evals) != 1 or evals[0]["samples"] != len(trainer.eval_data):
        fail(f"train {mode} {backend}: eval records {evals}")
    # Launches of exactly one more step, and device ms per step (CUDA
    # events): on rows drawn from the resident split, or on a batch already
    # on the card; both rotate in the step.
    batch = None if resident else {
        k: torch.from_numpy(v).cuda()
        for k, v in next(trainer.train_data.worker_iter(0)).items()}
    torch.cuda.synchronize()
    _reset_counts()
    trainer.step(batch)
    torch.cuda.synchronize()
    per_step = _read_counts()
    if per_step != _want_counts(backend, 1, 0):
        fail(f"train {mode} {backend}: one step launched {per_step}")
    step_ms = time_ms(torch, lambda: trainer.step(batch), reps=5, warmup=1)
    t = trainer.timing
    out = {
        "mode": mode, "backend": backend, "steps": CACHE_STEPS,
        "global_batch": cfg.global_batch,
        "data_workers": 0 if resident else cfg.data_workers,
        "setup_s": setup_s, "run_s": run_s, "losses": losses,
        "eval_samples": evals[0]["samples"], "eval_batches": eval_batches,
        "eval_accuracy": evals[0]["accuracy"],
        "launches": counts, "launches_per_step": per_step,
        "device_step_ms": step_ms,
        "samples_per_sec_with_data_wait": CACHE_STEPS * cfg.global_batch / t["wall_s"],
        # The logger's rate over each half of the run: the first half pays
        # the run's first-use costs, the second is steady.
        "samples_per_sec_by_half": [r["samples_per_sec"] for r in windows],
        "data_wait_share": t["data_wait_s"] / t["wall_s"],
        "samples_per_sec_device_bound": cfg.global_batch / step_ms * 1e3,
        **trainer.resident,
    }
    print("cache_run", json.dumps(out), flush=True)
    return out, trainer


def cache_checks(torch, seed: int, trainer) -> dict:
    """The resident path held against itself: the card's draw of a fixed
    index vector against the host gather of the same samples, the card's
    cube rotations against the CPU's, and one resident step (the drawn
    rows, rotated) through the kernels against the plain versions."""
    import numpy as np

    from featurenet_tpu_torch.ops.augment import draw_codes, rotate_grids
    from featurenet_tpu_torch.train.steps import gather_rows, step_voxels, unpack_bits

    data = trainer.train_data
    idx = np.random.default_rng(seed).integers(0, len(data), TRAIN_BATCH)
    got = gather_rows(trainer._data, trainer._labels, torch.from_numpy(idx).cuda())
    samples = data.resident_order()[idx]
    if not (np.array_equal(got["voxels"].cpu().numpy(), data._gather(samples))
            and np.array_equal(got["label"].cpu().numpy(), data.labels[samples])):
        fail("the card's draw differs from the host gather of the same samples")
    grids = unpack_bits(got["voxels"][:ROTATION_CHECK_ROWS])
    host = grids.cpu()
    for code in range(24):
        if not torch.equal(rotate_grids(grids, code).cpu(), rotate_grids(host, code)):
            fail(f"cube rotation {code} differs between the card and the CPU")
    codes = draw_codes(torch.Generator().manual_seed(seed), TRAIN_BATCH,
                       trainer.cfg.augment_groups)
    opt = trainer.state.optimizer
    snapshot = {"model": {k: v.clone() for k, v in
                          trainer.state.model.state_dict().items()},
                "count": opt.count, "mu": [t.clone() for t in opt.mu],
                "nu": [t.clone() for t in opt.nu]}
    versus = step_vs_plain(torch, trainer, snapshot,
                           step_voxels(got["voxels"], codes), got["label"],
                           "pallas resident")
    return {"draw_rows": TRAIN_BATCH, "draw_bitwise": True,
            "rotation_codes": 24, "rotation_rows": ROTATION_CHECK_ROWS,
            "rotation_bitwise": True, "step_codes": codes,
            "resident_step_vs_plain": versus}


def cache_cli(seed: int, cache: str, eval_samples: int) -> dict:
    """``cli train --config sprint64 --data-cache D --hbm-cache`` in a
    subprocess on the card, 3 steps: its records must show the resident
    split and one exact eval pass over ``eval_samples`` rows."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    tr = subprocess.run([sys.executable, "-m", "featurenet_tpu_torch.cli", "train",
                         "--config", "sprint64", "--seed", str(seed),
                         "--data-cache", cache, "--hbm-cache", "--total-steps", "3"],
                        cwd=root, capture_output=True, text=True, timeout=600)
    train_s = time.perf_counter() - t0
    if tr.returncode != 0:
        fail(f"cli train --hbm-cache exited {tr.returncode}: {tr.stderr[-2000:]}")
    records = [json.loads(line) for line in tr.stdout.splitlines()]
    kinds = {r.get("kind"): r for r in records}
    if not (records[0]["config"]["hbm_cache"] and kinds["setup"].get("hbm_resident_rows")
            and kinds["train"]["step"] == 3 and kinds["eval"]["samples"] == eval_samples):
        fail(f"cli train --hbm-cache records {records[1:]}")
    return {"train_s": train_s, "setup": kinds["setup"],
            "loss": kinds["train"]["loss"], "eval_samples": kinds["eval"]["samples"]}


def cache_phase(torch, seed: int, smi_line: str, cache: str) -> dict:
    """Export the synthetic parts at 24 x CACHE_PER_CLASS into a
    packed cache at ``cache``, then train sprint64 from it under pallas and
    xla, resident and streamed, and hold the resident path against
    itself."""
    from featurenet_tpu_torch.data.offline import export_synthetic_cache

    t0 = time.perf_counter()
    index = export_synthetic_cache(cache, per_class=CACHE_PER_CLASS,
                                   resolution=64, seed=seed)
    export_s = time.perf_counter() - t0
    parts = sum(index["counts"].values())
    runs, checks = {}, None
    for backend in ("pallas", "xla"):
        for resident in (True, False):
            run, trainer = _cache_run(torch, seed, cache, backend, resident)
            runs[f"train_{run['mode']}_{backend}"] = run
            if resident and backend == "pallas":
                checks = cache_checks(torch, seed, trainer)
            del trainer
            torch.cuda.empty_cache()
    cli = cache_cli(seed, cache, runs["train_hbm_pallas"]["eval_samples"])
    out = {"per_class": CACHE_PER_CLASS, "parts": parts, "resolution": 64,
           "cut": "24 x 1000 -> 24 x 250", "export_s": export_s, "export_parts_per_sec": parts / export_s,
           "cache_mb": parts * 64 ** 3 / 8 / 1e6,
           "hbm_resident_mb": runs["train_hbm_pallas"]["hbm_resident_mb"],
           "hbm_resident_rows": runs["train_hbm_pallas"]["hbm_resident_rows"],
           **{f"{k}_{m}": runs[k][m] for k in runs
              for m in ("samples_per_sec_with_data_wait", "data_wait_share",
                        "device_step_ms")},
           "launches_per_step": {k: runs[k]["launches_per_step"] for k in runs},
           "checks": checks, "cli": cli, "nvidia_smi": smi_line}
    print("cache", json.dumps(out), flush=True)
    return {"runs": runs, **out}


def _robust_cfg(seed: int, cache: str, name: str = "robust64",
                backend: str = "pallas", **kw):
    """``name`` (robust64, or sprint64 resident at robust64's k) from
    ``cache`` at full width under ``backend``; fails unless robust64 keeps
    its recipe."""
    import dataclasses

    from featurenet_tpu_torch.config import get_config

    extra = {} if name == "robust64" else dict(hbm_cache=True,
                                               steps_per_dispatch=ROBUST_K)
    cfg = get_config(name, seed=seed, data_cache=cache,
                     data_workers=TRAIN_WORKERS, **{**extra, **kw})
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend=backend))
    a = cfg.arch
    if (cfg.resolution, cfg.global_batch, tuple(a.features), a.hidden,
            a.num_classes, a.dropout) != (64, TRAIN_BATCH, (32, 32, 64, 64),
                                          128, 24, 0.5):
        fail(f"{name} is not at full width: {cfg}")
    if name == "robust64" and (cfg.augment_affine, cfg.augment_affine_prob,
                               cfg.augment_noise, cfg.augment_groups) != \
            (True, 0.5, 0.005, 8):
        fail(f"robust64 lost its recipe: {cfg}")
    return cfg


def _compare_states(torch, a, b) -> dict:
    """Two trainers' states: every tensor a step writes, and the steps."""
    pairs = list(zip(a.state.tensors(), b.state.tensors()))
    out = {"steps": [a.state.step, b.state.step],
           "bitwise": all(torch.equal(x, y) for x, y in pairs),
           "max_abs_diff": max(float((x.double() - y.double()).abs().max())
                               for x, y in pairs),
           "within_tol": all(torch.allclose(x, y, rtol=K_RTOL, atol=K_ATOL)
                             for x, y in pairs)}
    if a.state.step != b.state.step or not out["within_tol"]:
        fail(f"k steps on the graph differ from eager steps: {out}")
    return out


def _replay_events(torch, trainer, backend: str) -> dict:
    """One k-step replay under torch.profiler: its kernels' device events
    by name, which must be k times REPLAY_EVENTS[backend], with no launch
    from Python (the wrappers' counters stay put)."""
    before = _read_counts()
    (got,) = graph_launch_events(
        torch, [lambda: trainer.dispatch(None, ROBUST_K)], REPLAY_EVENTS[backend])
    want = {k: ROBUST_K * v for k, v in REPLAY_EVENTS[backend].items()}
    if got != want or _read_counts() != before:
        fail(f"{backend}: one replay ran {got} kernel events (want {want}); "
             f"Python launches {before} -> {_read_counts()}")
    return got


def _k_against_eager(torch, seed: int, cache: str, resident: bool, sink) -> dict:
    """robust64 for ROBUST_CHECK_STEPS steps at k = 8 through the graph and,
    from the same seeded state, as eager single steps (the second under
    sync-debug "error"): states within K_RTOL/K_ATOL, launches exact."""
    import itertools

    from featurenet_tpu_torch.train.loop import Trainer

    graphed = Trainer(_robust_cfg(seed, cache, hbm_cache=resident), "cuda",
                      stream=sink)
    eager = Trainer(_robust_cfg(seed, cache, hbm_cache=resident,
                                steps_per_dispatch=1), "cuda", stream=sink)
    batches = None if resident else [
        {k: torch.from_numpy(v).cuda() for k, v in b.items()}
        for b in itertools.islice(graphed.train_data.worker_iter(0),
                                  ROBUST_CHECK_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    before = _read_counts()
    for i in range(ROBUST_CHECK_STEPS):
        batch = batches[i] if batches else None
        if i == 1:
            _step_without_sync(torch, eager, batch)
        else:
            eager.step(batch)
    torch.cuda.synchronize()
    eager_launches = {k: v - before[k] for k, v in _read_counts().items()}
    k1_peak_mb = (torch.cuda.max_memory_reserved() - base) / 2 ** 20
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_reserved()
    before = _read_counts()
    for g in range(0, ROBUST_CHECK_STEPS, ROBUST_K):
        graphed.dispatch(batches[g:g + ROBUST_K] if batches else None, ROBUST_K)
    torch.cuda.synchronize()
    graph_launches = {k: v - before[k] for k, v in _read_counts().items()}
    k8_peak_mb = (torch.cuda.max_memory_reserved() - base) / 2 ** 20
    torch.cuda.empty_cache()
    k8_held_mb = (torch.cuda.memory_reserved() - base) / 2 ** 20
    (key, prog), = graphed.programs.items()
    # The warmup's k eager steps and the capture's k: the replays launch none.
    want_step = _want_counts("pallas", 1, 0)
    if (eager_launches != _want_counts("pallas", ROBUST_CHECK_STEPS, 0)
            or graph_launches != _want_counts("pallas", 2 * ROBUST_K, 0)
            or prog.capture_launches != _want_counts("pallas", ROBUST_K, 0)):
        fail(f"robust launches: eager {eager_launches}, graph {graph_launches}, "
             f"captured {prog.capture_launches}; per step {want_step}")
    out = {"path": key[0], "k": key[1], "precision": key[2],
           "steps": ROBUST_CHECK_STEPS, **_compare_states(torch, graphed, eager),
           "capture_s": prog.capture_s, "capture_launches": prog.capture_launches,
           "eager_step_sync_free": True,
           "k1_eager_peak_reserved_mb": k1_peak_mb,
           "k8_graph_peak_reserved_mb": k8_peak_mb,
           "k8_graph_held_reserved_mb": k8_held_mb}
    print("robust_k", json.dumps(out), flush=True)
    return out, graphed, eager


def _rate(trainer, steps: int) -> dict:
    """``trainer.run`` for ``steps`` more steps: samples/s over the steps'
    wall (data wait included) and the data-wait share."""
    t = dict(trainer.timing)
    trainer.run(num_steps=trainer.state.step + steps)
    wall = trainer.timing["wall_s"] - t["wall_s"]
    return {"steps": steps, "samples_per_sec": steps * trainer.cfg.global_batch / wall,
            "data_wait_share": (trainer.timing["data_wait_s"] - t["data_wait_s"]) / wall}


def _pacing(trainer) -> dict:
    """samples/s of ``trainer`` (k = 8) over ROBUST_RATE_STEPS steps, in
    PACING_TURNS turns at max_inflight_steps 8 (paced: the loop waits for
    the event of the dispatch one group back) and above the run's length
    (unpaced), on the same trainer and graph."""
    import dataclasses

    base = trainer.cfg
    modes = {"paced": 8, "unpaced": 10 ** 9}
    turns = {m: [] for m in modes}
    try:
        for _ in range(PACING_TURNS):
            for mode, depth in modes.items():
                trainer.cfg = dataclasses.replace(base, max_inflight_steps=depth)
                turns[mode].append(_rate(trainer, ROBUST_RATE_STEPS)["samples_per_sec"])
    finally:
        trainer.cfg = base
    mean = {m: statistics.mean(v) for m, v in turns.items()}
    return {"turns": turns, "mean": mean,
            "paced_over_unpaced": mean["paced"] / mean["unpaced"]}


def _augment_alone(torch, trainer) -> dict:
    """The affine warp on the card against its plain gather (WARP_ATOL) on
    rows drawn from the resident split, groups not taken passing bitwise;
    the noise flipping exactly its mask; the device cube codes bitwise the
    CPU's rotations; and the device ms of the warp, its plain version and
    the noise (draw and flip) at robust64's batch."""
    from featurenet_tpu_torch.ops import augment
    from featurenet_tpu_torch.train.steps import gather_rows, unpack_bits

    cfg = trainer.cfg
    g = torch.Generator(device="cuda").manual_seed(cfg.seed)
    idx = torch.randint(0, trainer._data.shape[0], (TRAIN_BATCH,), generator=g,
                        device="cuda")
    bits = unpack_bits(gather_rows(trainer._data, trainer._labels, idx)["voxels"])
    voxels = bits.float()
    full = augment.draw_affine(g, TRAIN_BATCH, cfg.augment_groups, prob=1.0)
    err = float((augment.affine_warp(voxels, *full)
                 - augment.affine_warp_plain(voxels, *full)).abs().max())
    half = augment.draw_affine(g, TRAIN_BATCH, cfg.augment_groups,
                               prob=cfg.augment_affine_prob)
    warped = augment.affine_warp(voxels, *half)
    kept = ~half.take.repeat_interleave(TRAIN_BATCH // cfg.augment_groups)
    passed = torch.equal(warped[kept], voxels[kept])
    flips = augment.draw_flips(g, tuple(voxels.shape), cfg.augment_noise)
    noisy = augment.occupancy_noise(voxels, flips)
    exact = torch.equal(noisy != voxels, flips)
    codes = torch.randint(0, 24, (cfg.augment_groups,), generator=g, device="cuda")
    host = bits[:ROTATION_CHECK_ROWS].cpu()
    gathered = augment.rotate_by_codes(bits[:ROTATION_CHECK_ROWS], codes).cpu()
    rotated = torch.equal(gathered, augment.rotate_groups(host, codes.tolist()))
    if not (err <= WARP_ATOL and passed and exact and rotated):
        fail(f"augment on the card: warp vs plain {err} (tol {WARP_ATOL}), "
             f"untaken groups bitwise {passed}, flips exact {exact}, device "
             f"codes bitwise {rotated}")
    return {"warp_max_abs_err_vs_plain": err, "warp_tol": WARP_ATOL,
            "taken_groups": int(half.take.sum()), "untaken_bitwise": passed,
            "flips_exact": exact, "flipped_share": float(flips.float().mean()),
            "device_codes_bitwise": rotated,
            "warp_ms": time_ms(torch, lambda: augment.affine_warp(voxels, *half)),
            "warp_plain_ms": time_ms(torch, lambda: augment.affine_warp_plain(
                voxels, *half), reps=5),
            "noise_ms": time_ms(torch, lambda: augment.occupancy_noise(
                voxels, augment.draw_flips(g, tuple(voxels.shape), cfg.augment_noise)))}


def _hybrid_replay(torch, seed: int, cache: str, sink) -> dict:
    """robust64 under hybrid_dw, resident, at k = 8: the captured graph
    holds 8 steps' folded weight gradients, and one replay runs them."""
    from featurenet_tpu_torch.train.loop import Trainer

    trainer = Trainer(_robust_cfg(seed, cache, backend="hybrid_dw"), "cuda",
                      stream=sink)
    trainer.dispatch(None, ROBUST_K)
    (prog,) = trainer.programs.values()
    if prog.capture_launches != _want_counts("hybrid_dw", ROBUST_K, 0):
        fail(f"hybrid_dw graph captured {prog.capture_launches}")
    out = {"capture_launches": prog.capture_launches,
           "replay_events": _replay_events(torch, trainer, "hybrid_dw"),
           "device_step_ms_k8": time_ms(torch, lambda: trainer.dispatch(
               None, ROBUST_K), reps=3, warmup=1) / ROBUST_K}
    del trainer
    return out


def robust_cli(seed: int, cache: str) -> dict:
    """``cli train --config robust64 --data-cache D --total-steps 16
    --checkpoint-dir C``, ``cli recalibrate --checkpoint-dir C --out-dir C2
    --batches 8`` and ``cli eval --checkpoint-dir C2`` in subprocesses on
    the card: the recalibrated step moves the batch-norm statistics and
    nothing else."""
    import torch

    from featurenet_tpu_torch.train.checkpoint import step_filename

    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "featurenet_tpu_torch.cli"]

    def run(*args) -> list[dict]:
        t0 = time.perf_counter()
        p = subprocess.run([*cli, *args], cwd=root, capture_output=True,
                           text=True, timeout=600)
        if p.returncode != 0:
            fail(f"cli {args[0]} exited {p.returncode}: {p.stderr[-2000:]}")
        walls[args[0]] = time.perf_counter() - t0
        return [json.loads(line) for line in p.stdout.splitlines()]

    walls: dict[str, float] = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck, ck2 = os.path.join(tmp, "ck"), os.path.join(tmp, "ck2")
        trained = run("train", "--config", "robust64", "--seed", str(seed),
                      "--data-cache", cache, "--total-steps", str(ROBUST_CLI_STEPS),
                      "--checkpoint-dir", ck)
        (recal,) = run("recalibrate", "--checkpoint-dir", ck, "--out-dir", ck2,
                       "--batches", str(RECAL_BATCHES))
        (ev,) = run("eval", "--checkpoint-dir", ck2)
        name = step_filename(ROBUST_CLI_STEPS)
        a, b = (torch.load(os.path.join(d, name), map_location="cpu",
                           weights_only=True) for d in (ck, ck2))
    stats = [k for k in a["model"] if k.endswith((".mean", ".var"))]
    moved = all(not torch.equal(a["model"][k], b["model"][k]) for k in stats)
    same = (all(torch.equal(a["model"][k], b["model"][k])
                for k in a["model"] if k not in stats)
            and all(torch.equal(a[m][k], b[m][k]) for m in ("mu", "nu") for k in a[m])
            and int(a["count"]) == int(b["count"]) and a["step"] == b["step"])
    cfg = trained[0]["config"]
    train_recs = [r for r in trained if r.get("kind") == "train"]
    if not (moved and same and recal["from_step"] == ROBUST_CLI_STEPS
            and cfg["steps_per_dispatch"] == ROBUST_K and cfg["augment_affine"]
            and train_recs and train_recs[-1]["step"] == ROBUST_CLI_STEPS
            and ev["eval"]["samples"] > 0):
        fail(f"robust cli: stats moved {moved}, rest bitwise {same}, {recal}, "
             f"{train_recs}, {ev}")
    return {"walls_s": walls, "train_loss": train_recs[-1]["loss"],
            "recalibrated": recal, "bn_stats_moved": moved,
            "rest_bitwise": same, "eval": ev["eval"]}


def robust_phase(torch, seed: int, cache: str, smi_line: str) -> dict:
    """robust64 at full width from the cache phase's cache: k = 8 on one
    CUDA graph against eager steps (resident and streamed), the kernels
    inside a replay (pallas and hybrid_dw), the augmentation on the card,
    device ms and samples/s at k = 1 and 8 beside sprint64's, and the
    command line's train, recalibrate and eval."""
    from featurenet_tpu_torch.train.loop import Trainer

    _reset_counts()
    with open(os.devnull, "w") as sink:
        res, graphed, eager = _k_against_eager(torch, seed, cache, True, sink)
        events = _replay_events(torch, graphed, "pallas")
        aug = _augment_alone(torch, graphed)
        ms = {"robust64_k1": time_ms(torch, eager.step, reps=5, warmup=1),
              "robust64_k8": time_ms(torch, lambda: graphed.dispatch(None, ROBUST_K),
                                     reps=3, warmup=1) / ROBUST_K}
        rates = {"hbm_k8": _rate(graphed, ROBUST_RATE_STEPS),
                 "hbm_k1": _rate(eager, ROBUST_RATE_STEPS)}
        pacing = {"resident": _pacing(graphed)}
        del graphed, eager
        torch.cuda.empty_cache()
        streamed, graphed, eager = _k_against_eager(torch, seed, cache, False, sink)
        rates.update(cache_k8=_rate(graphed, ROBUST_RATE_STEPS),
                     cache_k1=_rate(eager, ROBUST_RATE_STEPS))
        pacing["streamed"] = _pacing(graphed)
        del graphed, eager
        torch.cuda.empty_cache()
        sprint = Trainer(_robust_cfg(seed, cache, "sprint64"), "cuda", stream=sink)
        ms["sprint64_k1"] = time_ms(torch, sprint.step, reps=5, warmup=1)
        ms["sprint64_k8"] = time_ms(torch, lambda: sprint.dispatch(None, ROBUST_K),
                                    reps=3, warmup=1) / ROBUST_K
        del sprint
        torch.cuda.empty_cache()
        hybrid = _hybrid_replay(torch, seed, cache, sink)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = _read_counts()
    print("pacing", json.dumps({**pacing, "k": ROBUST_K, "steps": ROBUST_RATE_STEPS,
                                "before_pacing_samples_per_sec": UNPACED_LOOP_RATES,
                                "nvidia_smi": smi_line}), flush=True)
    cli = robust_cli(seed, cache)
    out = {"k_vs_eager_resident": res, "k_vs_eager_streamed": streamed,
           "replay_events_pallas": events, "hybrid_dw": hybrid,
           "augment": aug, "device_step_ms": ms, "rates": rates, "pacing": pacing,
           "launches": launches, "cli": cli, "nvidia_smi": smi_line}
    print("robust", json.dumps(out), flush=True)
    return out


def _smi_apps() -> list[tuple[int, str]]:
    """(pid, used memory) of every compute process nvidia-smi lists."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    apps = []
    for line in out.stdout.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps.append((int(pid), mem.strip()))
    return apps


def _smi_used_mib() -> int | None:
    """The card's memory in use, MiB, as nvidia-smi reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    first = out.stdout.strip().splitlines()[:1]
    return int(first[0]) if first and first[0].strip().isdigit() else None


def _gpu_fds(pid: int) -> list[str]:
    """The GPU device nodes (/dev/nvidia<N>) process ``pid`` holds open: a
    CUDA context opens its device's node."""
    found = []
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia") and target[11:].isdigit():
                found.append(target)
    except OSError:
        pass
    return found


def _group_alive(pgid: int) -> list[int]:
    """Live processes of process group ``pgid``."""
    alive = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[2]) == pgid and fields[0] != "Z":
            alive.append(int(name))
    return alive


class _Watched:
    """``cli train --supervise`` in a subprocess, watched: its stdout JSON
    lines and stderr lines with their arrival times, the heartbeat file's
    mtimes, and once a second nvidia-smi's compute processes and memory in
    use, the GPU device nodes the supervisor holds open, and which of its
    children hold one (a CUDA context opens its device's node; nvidia-smi
    may not see the pids of a container)."""

    def __init__(self, argv: list[str], heartbeat: str | None, root: str):
        self.t0 = time.time()
        self.out: list[tuple[float, dict]] = []
        self.err: list[tuple[float, str]] = []
        self.beats: list[float] = []
        self.smi: list[tuple[float, list]] = []
        self.own_gpu_fds: set[str] = set()
        self.card_held: dict[int, list[float]] = {}  # child pid -> sample times
        self._hb = heartbeat
        self._stop = threading.Event()
        self.proc = subprocess.Popen(argv, cwd=root, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
        self._threads = [threading.Thread(target=f, daemon=True) for f in
                         (self._read_out, self._read_err, self._watch_beats,
                          self._watch_card)]
        for t in self._threads:
            t.start()

    def _read_out(self):
        for line in self.proc.stdout:
            try:
                self.out.append((time.time(), json.loads(line)))
            except ValueError:
                self.out.append((time.time(), {"raw": line.rstrip()}))

    def _read_err(self):
        for line in self.proc.stderr:
            self.err.append((time.time(), line.rstrip()))

    def _watch_beats(self):
        last = None
        while not self._stop.is_set():
            try:
                m = os.stat(self._hb).st_mtime if self._hb else None
            except OSError:
                m = None
            if m is not None and m != last:
                self.beats.append(m)
                last = m
            time.sleep(0.005)

    def _watch_card(self):
        while not self._stop.is_set():
            t = time.time()
            self.own_gpu_fds.update(_gpu_fds(self.proc.pid))
            for _, r in self.records("supervisor"):
                if r["supervisor"] == "spawn" and _gpu_fds(r["pid"]):
                    self.card_held.setdefault(r["pid"], []).append(t)
            self.smi.append((t, _smi_apps(), _smi_used_mib()))
            self._stop.wait(1.0)

    def wait(self, timeout: float) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            self._stop.set()
            for t in self._threads:
                t.join(timeout=30)
        return rc

    def records(self, key: str) -> list[tuple[float, dict]]:
        return [(t, r) for t, r in self.out if key in r]

    def children(self) -> list[dict]:
        """One entry per child the supervisor spawned: pid, wall seconds
        from its spawn to the supervisor's next verdict, its beats, its
        first beat, how it ended and the verdict's time."""
        sup = [(t, r) for t, r in self.records("supervisor")]
        kids = []
        for i, (t, r) in enumerate(sup):
            if r["supervisor"] != "spawn":
                continue
            end_t, end = next(((u, s) for u, s in sup[i + 1:]
                               if s["supervisor"] != "spawn"), (None, {}))
            beats = [b for b in self.beats if t < b <= (end_t or 1e18)]
            kids.append({"pid": r["pid"], "spawn_t": t, "end_t": end_t,
                         "ended": end.get("supervisor"),
                         "wall_s": (end_t - t) if end_t else None,
                         "beats": len(beats),
                         "first_beat_t": beats[0] if beats else None,
                         "last_beat_t": beats[-1] if beats else None})
        return kids

    def check_no_context(self) -> dict:
        """The supervisor's pid: never listed by nvidia-smi and never
        holding a GPU device node open, while the same probe sees its
        children hold one."""
        sup_pid = self.proc.pid
        listed = sorted({p for _, apps, _ in self.smi for p, _ in apps})
        if sup_pid in listed or self.own_gpu_fds or not self.card_held:
            fail(f"the supervisor (pid {sup_pid}) holds a CUDA context, or the "
                 f"probe sees none: nvidia-smi pids {listed}, its device nodes "
                 f"{self.own_gpu_fds}, children holding the card {self.card_held}")
        used = [m for _, _, m in self.smi if m is not None]
        return {"supervisor_pid": sup_pid, "supervisor_gpu_fds": sorted(self.own_gpu_fds),
                "children_seen_holding_the_card": sorted(self.card_held),
                "smi_pids_seen": listed,
                "smi_max_apps": max(len(apps) for _, apps, _ in self.smi),
                "smi_used_mib_max": max(used) if used else None,
                "smi_samples": len(self.smi)}


def _cli(*args) -> list[str]:
    return [sys.executable, "-m", "featurenet_tpu_torch.cli", *args]


def _exit_kind(record: dict) -> str:
    return "preempt_exit" if "preempt_exit" in record else "planned_restart_exit"


def _launch_lines(watched) -> list[dict]:
    return [r["launches"] for _, r in watched.records("launches")]


def _ck_tensors(path: str) -> dict:
    import torch

    p = torch.load(path, map_location="cpu", weights_only=True)
    out = {f"model.{k}": v for k, v in p["model"].items()}
    out.update({f"{m}.{k}": v for m in ("mu", "nu") for k, v in p[m].items()})
    out.update({k: p[k] for k in ("loss_scale", "good_steps")})
    return out, int(p["step"]), int(p["count"])


def _same_run(a: str, b: str) -> dict:
    """Two checkpoint files of one step: bitwise, or each tensor's largest
    difference relative to its largest magnitude, held to STEP_TOL's fp32
    gradient tolerance."""
    ta, sa, ca = _ck_tensors(a)
    tb, sb, cb = _ck_tensors(b)
    rel = {}
    for k in ta:
        d = float((ta[k].double() - tb[k].double()).abs().max())
        rel[k] = d / max(float(tb[k].double().abs().max()), 1e-30)
    worst = max(rel, key=rel.get)
    out = {"step": [sa, sb], "count": [ca, cb],
           "bitwise": all(v == 0.0 for v in rel.values()),
           "max_rel_diff": rel[worst], "worst_tensor": worst,
           "tensors_differing": sorted(k for k, v in rel.items() if v)}
    if (sa, ca) != (sb, cb) or rel[worst] > STEP_TOL["fp32"]["grad"]:
        fail(f"the supervised run ends away from the unbroken one: {out}")
    return out


def supervise_robust(seed: int, cache: str, tmp: str) -> tuple[dict, list, str]:
    """robust64 (resident, k = 8, pallas, batch 256) for SUPERVISE_STEPS
    steps under ``cli train --supervise`` with SUPERVISE_FAULTS: preempted
    at its first segment's end (the step saved there truncated), a planned
    restart at the next, a host loss (SIGKILL) in the third child. Then
    the same run unbroken; the last steps must agree."""
    from featurenet_tpu_torch.train.checkpoint import step_filename

    root = os.path.dirname(os.path.abspath(__file__))
    ck, ck_ref = os.path.join(tmp, "robust_ck"), os.path.join(tmp, "robust_ref")
    hb = os.path.join(tmp, "robust_hb")
    common = ["--config", "robust64", "--seed", str(seed), "--data-cache", cache,
              "--total-steps", str(SUPERVISE_STEPS), "--checkpoint-every",
              str(SUPERVISE_CKPT_EVERY)]
    smi_before = (_smi_apps(), _smi_used_mib())
    run = _Watched(_cli("train", *common, "--checkpoint-dir", ck, "--supervise",
                        "--heartbeat-file", hb, "--restart-every",
                        str(SUPERVISE_RESTART_EVERY), "--inject-faults",
                        SUPERVISE_FAULTS), hb, root)
    rc = run.wait(600)
    smi_after = (_smi_apps(), _smi_used_mib())
    sup = [r for _, r in run.records("supervisor")]
    done = sup[-1] if sup else {}
    kids = run.children()
    fallbacks = [json.loads(line)["checkpoint_fallback"] for _, line in run.err
                 if line.startswith('{"checkpoint_fallback"')]
    exits = [r for _, r in run.out if r.get("kind") == "setup"
             and ("preempt_exit" in r or "planned_restart_exit" in r)]
    if not (rc == 0 and done.get("supervisor") == "done"
            and (done["restarts"], done["stalls"], done["planned"]) == (1, 0, 2)
            and [k["ended"] for k in kids] == ["planned_restart", "planned_restart",
                                               "backoff", "done"]
            and fallbacks == [{"from_step": SUPERVISE_RESTART_EVERY,
                               "to_step": SUPERVISE_CKPT_EVERY}]
            and [_exit_kind(r) for r in exits] == ["preempt_exit",
                                                   "planned_restart_exit"]):
        fail(f"supervise_robust: rc {rc}, {done}, children {kids}, fallbacks "
             f"{fallbacks}, exits {exits}; stderr {[l for _, l in run.err][-40:]}")
    # The SIGKILLed child (host_loss): its context released before the next
    # child's setup record (no sample after it finds the killed pid in
    # nvidia-smi or holding the card), and the time from the kill to the
    # next beat.
    killed = kids[2]
    next_setup_t = next(t for t, r in run.out if r.get("kind") == "setup"
                        and t > killed["end_t"])
    held_after = [t for t in run.card_held.get(killed["pid"], []) if t >= next_setup_t]
    listed_after = [t for t, apps, _ in run.smi if t >= next_setup_t
                    and killed["pid"] in {p for p, _ in apps}]
    if (held_after or listed_after or not run.card_held.get(killed["pid"])
            or _group_alive(killed["pid"])):
        fail(f"the killed child {killed['pid']} held the card after the next "
             f"setup record ({held_after}, {listed_after}), or was never seen "
             f"holding it ({run.card_held})")
    t_ref = time.perf_counter()
    ref = subprocess.run(_cli("train", *common, "--checkpoint-dir", ck_ref),
                         cwd=root, capture_output=True, text=True, timeout=600)
    ref_s = time.perf_counter() - t_ref
    if ref.returncode != 0:
        fail(f"unbroken robust64 run exited {ref.returncode}: {ref.stderr[-2000:]}")
    same = _same_run(os.path.join(ck, step_filename(SUPERVISE_STEPS)),
                     os.path.join(ck_ref, step_filename(SUPERVISE_STEPS)))
    ref_launches = [json.loads(line)["launches"] for line in ref.stdout.splitlines()
                    if line.startswith('{"launches"')]
    out = {"config": "robust64", "steps": SUPERVISE_STEPS, "k": ROBUST_K,
           "faults": SUPERVISE_FAULTS, "restart_every": SUPERVISE_RESTART_EVERY,
           "result": done, "fallbacks": fallbacks,
           "exits": [{"step": r["step"], "exit": _exit_kind(r)} for r in exits],
           "children": [{k: v for k, v in c.items() if not k.endswith("_t")}
                        for c in kids],
           "kill_to_next_first_beat_s": kids[3]["first_beat_t"] - killed["end_t"],
           "exit_to_next_first_beat_s": [kids[i + 1]["first_beat_t"] - kids[i]["end_t"]
                                         for i in range(len(kids) - 1)],
           "killed_pid": killed["pid"], "killed_released_before_next_setup": True,
           "killed_last_seen_holding_to_next_setup_s":
               next_setup_t - max(run.card_held[killed["pid"]]),
           "vs_unbroken": same, "unbroken_s": ref_s, "wall_s": time.time() - run.t0,
           "nvidia_smi_apps_and_used_mib_before": smi_before,
           "nvidia_smi_apps_and_used_mib_after": smi_after,
           **run.check_no_context()}
    return out, _launch_lines(run) + ref_launches, ck


def supervise_stall(seed: int, cache: str, tmp: str) -> tuple[dict, list, str]:
    """sprint64 streamed from the cache (batch 256) for STALL_STEPS steps
    under ``cli train --supervise --stall-timeout STALL_TIMEOUT_S`` with a
    producer hung past the first beat: one stall verdict, the hung
    child's whole group gone, the respawn finishing with a finite loss."""
    import inspect

    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.supervisor import supervise

    poll_s = inspect.signature(supervise).parameters["poll_s"].default
    root = os.path.dirname(os.path.abspath(__file__))
    ck, hb = os.path.join(tmp, "stall_ck"), os.path.join(tmp, "stall_hb")
    run = _Watched(_cli("train", "--config", "sprint64", "--seed", str(seed),
                        "--data-cache", cache, "--total-steps", str(STALL_STEPS),
                        "--checkpoint-every", str(STALL_CKPT_EVERY),
                        "--checkpoint-dir", ck, "--supervise", "--heartbeat-file",
                        hb, "--stall-timeout", str(STALL_TIMEOUT_S),
                        "--inject-faults", STALL_FAULTS), hb, root)
    rc = run.wait(600)
    sup = [r for _, r in run.records("supervisor")]
    kids = run.children()
    stalls = [(t, r) for t, r in run.records("supervisor") if r["supervisor"] == "stall"]
    trains = [r for _, r in run.out if r.get("kind") == "train"]
    if not (rc == 0 and len(stalls) == 1 and sup[-1] == {
            "supervisor": "done", "restarts": 1, "stalls": 1, "planned": 0}
            and trains and trains[-1]["step"] == STALL_STEPS
            and math.isfinite(trains[-1]["loss"])
            and CheckpointManager(ck).latest_step() == STALL_STEPS):
        fail(f"supervise_stall: rc {rc}, {sup}, trains {trains}; stderr "
             f"{[l for _, l in run.err][-40:]}")
    t_stall, stall = stalls[0]
    hung = kids[0]
    if _group_alive(stall["pid"]):
        fail(f"the stalled child's group {stall['pid']} is still alive")
    latency = t_stall - hung["last_beat_t"]
    if not STALL_TIMEOUT_S <= latency <= STALL_TIMEOUT_S + poll_s + 1.0:
        fail(f"stall detected {latency:.2f} s after the last beat (timeout "
             f"{STALL_TIMEOUT_S}, poll {poll_s})")
    out = {"config": "sprint64", "mode": "streamed", "steps": STALL_STEPS,
           "faults": STALL_FAULTS, "stall_timeout_s": STALL_TIMEOUT_S,
           "poll_s": poll_s, "result": sup[-1],
           "detection_latency_s": latency,
           "detection_bound_s": STALL_TIMEOUT_S + poll_s,
           "heartbeat_age_at_verdict_s": stall["heartbeat_age_s"],
           "killed_group_gone": True, "final_loss": trains[-1]["loss"],
           "children": [{k: v for k, v in c.items() if not k.endswith("_t")}
                        for c in kids],
           "stall_to_next_first_beat_s": kids[1]["first_beat_t"] - t_stall,
           "wall_s": time.time() - run.t0, **run.check_no_context()}
    return out, _launch_lines(run), ck


def supervise_swap(served: str, candidate: str) -> dict:
    """``cli serve --checkpoint-dir served --inject-faults swap_corrupt@swap=1``:
    the first POST /admin/reload to ``candidate`` gets 409 and the old
    generation answers bitwise as before; the second swaps."""
    import numpy as np

    root = os.path.dirname(os.path.abspath(__file__))
    srv = subprocess.Popen(_cli("serve", "--checkpoint-dir", served, "--port", "0",
                                "--duration-s", "300", "--inject-faults",
                                "swap_corrupt@swap=1"),
                           cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        banner = json.loads(srv.stdout.readline())["serving"]
        conn = http.client.HTTPConnection("127.0.0.1", banner["port"], timeout=120)
        grid = np.zeros((64, 64, 64), "<f4")
        grid[10:40, 12:50, 8:30] = 1.0
        grid[20:30, 20:30, 8:60] = 0.0
        body = grid.tobytes()
        s0, first, _ = _post(conn, "/predict_voxels", body)
        reload = json.dumps({"checkpoint_dir": candidate}).encode()
        s1, refused, _ = _post(conn, "/admin/reload", reload)
        s2, again, _ = _post(conn, "/predict_voxels", body)
        s3, swapped, _ = _post(conn, "/admin/reload", reload)
        s4, after, _ = _post(conn, "/predict_voxels", body)
        conn.close()
        status, health = _get(banner["port"], "/healthz")
        srv.send_signal(signal.SIGTERM)
        out, err = srv.communicate(timeout=120)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.communicate()
    ok = (s0 == s2 == s4 == 200 and s1 == 409 and refused["error"] == "swap_refused"
          and refused["kind"] == "ChecksumMismatch"
          and refused["model_version"] == banner["model_version"]
          and again == first and s3 == 200 and swapped["ok"]
          and swapped["model_version"] == health["model_version"] != banner["model_version"]
          and srv.returncode == 0)
    if not ok:
        fail(f"supervise_swap: {s0} {s1} {refused} {s2} {s3} {swapped} {s4} "
             f"{health} rc {srv.returncode} {err[-2000:]}")
    return {"refused": {"status": s1, "kind": refused["kind"]},
            "old_generation_bitwise": again == first,
            "swapped_to": swapped["model_version"], "swap_ms": swapped["swap_ms"],
            "answer_changed": after != first, "from": banner["model_version"],
            "supervisor": "none (cli serve has no supervisor process)"}


def supervise_phase(seed: int, cache: str, smi_line: str) -> dict:
    """The supervised runs: ``supervise_robust``, ``supervise_stall`` and
    ``supervise_swap``, each its own line; the kernel launches their
    ``cli train`` processes reported."""
    launches: dict[str, int] = {}

    def line(name, fn, *args):
        t0 = time.perf_counter()
        out, reported, ckpt = fn(*args)
        for counts in reported:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        out.update(phase_s=time.perf_counter() - t0,
                   processes_reporting_launches=len(reported), nvidia_smi=smi_line)
        print(name, json.dumps(out), flush=True)
        return ckpt

    with tempfile.TemporaryDirectory(dir=os.path.dirname(cache)) as tmp:
        robust_ck = line("supervise_robust", supervise_robust, seed, cache, tmp)
        stall_ck = line("supervise_stall", supervise_stall, seed, cache, tmp)
        t0 = time.perf_counter()
        swap = supervise_swap(stall_ck, robust_ck)
        swap.update(phase_s=time.perf_counter() - t0, nvidia_smi=smi_line)
        print("supervise_swap", json.dumps(swap), flush=True)
    if not (launches.get("conv3d_fwd") and launches.get("conv3d_dw")):
        fail(f"the supervised children reported no kernel launches: {launches}")
    return {"launches": launches}


def _rung_serving(torch, seed: int, precision: str, grids, fp32_pred,
                  graphs: dict) -> dict:
    """sprint64 served at ``precision`` behind the InferenceService (buckets
    SERVE_BUCKETS, one graph each): a burst of voxel grids; the warmup
    captures 3 conv3d_fwd per graph and the traffic launches none, one
    replay per dispatch, 3 conv3d_fwd_kernel device events per replay; the
    served probabilities against the same precision through the plain
    conv, the resident weight bytes, and top-1 agreement with fp32 on
    AGREEMENT_PARTS parts (printed, not gated). The device ms per bucket
    come from the ``graphs`` line."""
    import numpy as np

    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.runtime import build_model, serve_forward
    from featurenet_tpu_torch.serve.service import InferenceService
    from featurenet_tpu_torch.train.precision import serve_params_cast

    cfg = fp32_pred.cfg
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    pred = Predictor.from_seed(cfg, seed, batch=64, device="cuda",
                               precision=precision)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - base
    if precision == "int8":
        ints = [t for t in pred._qparams.values() if t.dtype == torch.int8]
        if len(ints) != 6 or not all(t.is_cuda for t in ints):
            fail(f"int8 weights are not resident as int8 on the card: "
                 f"{[(t.dtype, t.device) for t in pred._qparams.values()]}")
    if not all(p.is_meta for p in pred.model.parameters()):
        fail(f"{precision}: the fp32 parameters stayed on the card")
    _reset_counts()
    service = InferenceService(pred, buckets=SERVE_BUCKETS,
                               queue_limit=2 * RUNG_BURST)
    warmup = _check_warmup(pred, f"serve {precision}")
    batches0, replays0 = service.stats()["batches"], pred.replays
    futs = [service.submit_voxels(g) for g in grids]
    rows = np.stack([f.result(timeout=120) for f in futs])
    launches = _read_counts()
    st = service.stats()
    replays = pred.replays - replays0
    drained = service.drain()
    dispatches = st["batches"] - batches0
    if (dispatches < 1 or launches != warmup or replays != dispatches
            or st["precision"] != precision):
        fail(f"serve {precision}: launches {launches} after warmup's {warmup}, "
             f"{replays} replays for {dispatches} dispatches, stats {st}")
    if drained["exit_code"] != 0:
        fail(f"serve {precision}: drain {drained}")
    events = replay_kernel_events(torch, pred, f"serve {precision}")
    plain = build_model(cfg, seed=seed, plain=True).to("cuda")
    params = serve_params_cast({k: v.detach() for k, v in plain.named_parameters()},
                               precision)
    x = torch.from_numpy(np.stack(grids)[..., None]).cuda()
    ref = torch.cat([serve_forward(plain, x[i:i + 64], params)
                     for i in range(0, len(x), 64)]).cpu().numpy()
    prob_err = float(np.abs(rows - ref).max())
    if not (np.isfinite(rows).all() and prob_err <= PROB_ATOL):
        fail(f"serve {precision}: probabilities differ from the plain conv "
             f"by {prob_err}")
    agree = pred.agreement(n=AGREEMENT_PARTS, seed=seed)
    ms = graphs[precision]["buckets"]
    out = {"precision": precision, "requests": len(grids),
           "dispatches": dispatches, "by_bucket": st["by_bucket"],
           "conv3d_fwd_launches": warmup["conv3d_fwd"],
           "launches_during_traffic": launches["conv3d_fwd"] - warmup["conv3d_fwd"],
           "replays": replays, "conv3d_fwd_kernel_events_per_replay": events,
           "max_prob_err_vs_plain": prob_err,
           "resident_weight_bytes": pred.resident_weight_bytes,
           "fp32_resident_weight_bytes": fp32_pred.resident_weight_bytes,
           "cuda_bytes_allocated_by_predictor": allocated,
           "device_ms_bucket64": ms[64]["graphed_ms"],
           "device_ms_bucket1": ms[1]["graphed_ms"],
           "eager_device_ms_bucket64": ms[64]["eager_ms"],
           "eager_device_ms_bucket1": ms[1]["eager_ms"],
           "top1_agreement_vs_fp32": agree, "agreement_parts": AGREEMENT_PARTS}
    print("precision_serve", json.dumps(out), flush=True)
    del service, pred, plain
    return out


def _rung_trainer(torch, seed: int, backend: str, precision: str):
    import dataclasses

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = get_config("sprint64", seed=seed, global_batch=TRAIN_BATCH,
                     data_workers=1, train_precision=precision)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend=backend))
    a = cfg.arch
    if (cfg.resolution, tuple(a.features), a.hidden, a.num_classes,
            a.dropout) != (64, (32, 32, 64, 64), 128, 24, 0.5):
        fail(f"precision phase is not sprint64 at full width: {cfg}")
    with open(os.devnull, "w") as sink:
        return Trainer(cfg, device="cuda", stream=sink)


def _rung_training(torch, seed: int, backend: str, precision: str, batch,
                   fp32_step_ms: float) -> dict:
    """sprint64 at batch 256 under ``backend`` and ``precision``: RUNG_STEPS
    steps from one batch on the card (more, up to 2·RUNG_STEPS, until two
    updates applied), each under torch.cuda.set_sync_debug_mode("error")
    (no step reads the card on the host), exact launches, finite losses,
    every parameter and batch-norm statistic moved, device ms per step, and
    one step through the kernels against the plain versions (STEP_TOL)."""
    from featurenet_tpu_torch.train.steps import unpack_voxels

    trainer = _rung_trainer(torch, seed, backend, precision)
    state, opt = trainer.state, trainer.state.optimizer
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    torch.cuda.synchronize()
    _reset_counts()
    raw = []
    while len(raw) < RUNG_STEPS or (int(opt.count) < 2 and len(raw) < 2 * RUNG_STEPS):
        raw.append(_step_without_sync(torch, trainer, batch))
    metrics = [{k: float(v) for k, v in m.items()} for m in raw]
    torch.cuda.synchronize()
    counts = _read_counts()
    steps = len(metrics)
    want = _want_counts(backend, steps, 0)
    if counts != want:
        fail(f"train {backend} {precision}: launches {counts} != {want}")
    losses = [m["loss"] for m in metrics]
    if not all(v == v and abs(v) < 1e30 for v in losses):
        fail(f"train {backend} {precision}: losses {losses}")
    after = state.model.state_dict()
    moved = {k: float((after[k] - before[k]).abs().max()) for k in before}
    if int(opt.count) < 2 or not all(v > 0 for v in moved.values()):
        fail(f"train {backend} {precision}: {int(opt.count)} updates; moved {moved}")
    if not all(p.dtype == torch.float32 for p in state.model.parameters()):
        fail(f"train {backend} {precision}: the masters are not fp32")
    snapshot = {"model": {k: v.clone() for k, v in after.items()},
                "count": opt.count, "mu": [t.clone() for t in opt.mu],
                "nu": [t.clone() for t in opt.nu]}
    step_ms = time_ms(torch, lambda: trainer.step(batch), reps=5, warmup=1)
    versus = step_vs_plain(torch, trainer, snapshot, unpack_voxels(batch["voxels"]),
                           batch["label"], f"{backend} {precision}",
                           precision=precision)
    out = {"backend": backend, "precision": precision, "steps": steps,
           "global_batch": TRAIN_BATCH, "losses": losses,
           "grads_finite": [m.get("grads_finite") for m in metrics],
           "loss_scale": [m.get("loss_scale") for m in metrics],
           "updates": int(snapshot["count"]), "launches": counts,
           "sync_debug_mode": "error",
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "device_step_ms": step_ms, "fp32_device_step_ms": fp32_step_ms,
           "samples_per_sec_device_bound": TRAIN_BATCH / step_ms * 1e3,
           "fp32_samples_per_sec_device_bound": TRAIN_BATCH / fp32_step_ms * 1e3,
           "step_vs_plain": versus}
    print("precision_train", json.dumps(out), flush=True)
    return out, trainer


def _step_without_sync(torch, trainer, batch) -> dict:
    """One ``trainer.step`` under torch.cuda.set_sync_debug_mode("error"): a
    host synchronisation inside the step raises. Returns its metrics, still
    on the card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return trainer.step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _overflow_skip(torch, trainer, batch) -> dict:
    """An fp16_scaled step at loss scale 2^30 on the card, under sync-debug
    "error": skipped bitwise (masters, moments, count, BN statistics),
    step + 1, scale halved."""
    state, opt = trainer.state, trainer.state.optimizer
    state.loss_scale.fill_(2.0 ** 30)
    before = ([v.clone() for v in state.model.state_dict().values()]
              + [t.clone() for t in opt.mu + opt.nu])
    count, step = opt.count, state.step
    torch.cuda.synchronize()
    _reset_counts()
    m = _step_without_sync(torch, trainer, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    after = list(state.model.state_dict().values()) + list(opt.mu + opt.nu)
    bitwise = all(torch.equal(a, b) for a, b in zip(before, after))
    out = {"grads_finite": float(m["grads_finite"]),
           "loss_scale": float(state.loss_scale),
           "good_steps": int(state.good_steps),
           "count_unchanged": torch.equal(opt.count, count),
           "step_advanced": state.step == step + 1, "bitwise": bitwise,
           "launches": counts}
    if not (out["grads_finite"] == 0.0 and out["loss_scale"] == 2.0 ** 29
            and out["good_steps"] == 0 and out["count_unchanged"]
            and out["step_advanced"] and bitwise
            and counts == _want_counts("pallas", 1, 0)):
        fail(f"the fp16 overflow step was not skipped bitwise: {out}")
    print("precision_overflow", json.dumps(out), flush=True)
    return out


def _fused33(torch, seed: int, batch, xla_step_ms: float) -> dict:
    """sprint64 under fused33 at batch 256: RUNG_STEPS steps (no kernel of
    the package launches), device ms per step beside xla's, and the logits
    against the xla backend's on the same weights (2e-2)."""
    import dataclasses

    from featurenet_tpu_torch.models.featurenet import FeatureNet
    from featurenet_tpu_torch.train.steps import unpack_voxels

    trainer = _rung_trainer(torch, seed, "fused33", "fp32")
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    torch.cuda.synchronize()
    _reset_counts()
    losses = [float(trainer.step(batch)["loss"]) for _ in range(RUNG_STEPS)]
    torch.cuda.synchronize()
    counts = _read_counts()
    if counts != _want_counts("fused33", RUNG_STEPS, 0):
        fail(f"train fused33: launches {counts}")
    after = trainer.state.model.state_dict()
    if not (all(v == v and abs(v) < 1e30 for v in losses)
            and all(not torch.equal(after[k], before[k]) for k in before)):
        fail(f"train fused33: losses {losses}, or a tensor did not move")
    step_ms = time_ms(torch, lambda: trainer.step(batch), reps=5, warmup=1)
    cfg = trainer.cfg
    x = unpack_voxels(batch["voxels"][:FUSED33_LOGITS_BATCH])
    logits = {}
    for backend in ("fused33", "xla"):
        arch = dataclasses.replace(cfg.arch, conv_backend=backend)
        model = FeatureNet(arch, cfg.resolution).to("cuda")
        model.load_state_dict(trainer.state.model.state_dict())
        with torch.inference_mode():
            logits[backend] = model(x).float()
    err = (logits["fused33"] - logits["xla"]).abs()
    bound = 2e-2 + 2e-2 * logits["xla"].abs()
    if not bool((err <= bound).all()):
        fail(f"fused33 logits differ from xla's by {float(err.max())}")
    out = {"backend": "fused33", "steps": RUNG_STEPS, "losses": losses,
           "launches": counts, "device_step_ms": step_ms,
           "xla_device_step_ms": xla_step_ms,
           "logits_max_abs_err_vs_xla": float(err.max()),
           "logits_batch": FUSED33_LOGITS_BATCH}
    print("precision_fused33", json.dumps(out), flush=True)
    del trainer
    return out


def precision_phase(torch, seed: int, train: dict, graphs: dict,
                    smi_line: str) -> dict:
    """The precision ladder and fused33 at sprint64's full width: serving at
    bf16 and int8, training under bf16_master and fp16_scaled with pallas
    and hybrid_dw, an fp16 overflow skipped on the card, and fused33 beside
    xla. Returns the per-path launch counts and the records."""
    import numpy as np

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.dataset import SyntheticVoxelDataset
    from featurenet_tpu_torch.data.synthetic import generate_batch
    from featurenet_tpu_torch.infer import Predictor

    cfg = get_config("sprint64")
    grids = list(generate_batch(np.random.default_rng(seed + 1), RUNG_BURST,
                                cfg.resolution)["voxels"][..., 0])
    fp32_pred = Predictor.from_seed(cfg, seed, batch=64, device="cuda")
    ms = graphs["fp32"]["buckets"]
    serve = {"fp32": {"device_ms_bucket64": ms[64]["graphed_ms"],
                      "device_ms_bucket1": ms[1]["graphed_ms"],
                      "eager_device_ms_bucket64": ms[64]["eager_ms"],
                      "eager_device_ms_bucket1": ms[1]["eager_ms"],
                      "resident_weight_bytes": fp32_pred.resident_weight_bytes}}
    print("precision_serve", json.dumps({"precision": "fp32", **serve["fp32"]}),
          flush=True)
    for p in ("bf16", "int8"):
        serve[p] = _rung_serving(torch, seed, p, grids, fp32_pred, graphs)
    del fp32_pred
    torch.cuda.empty_cache()

    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        SyntheticVoxelDataset(64, TRAIN_BATCH, seed=seed).worker_iter(0)).items()}
    runs, overflow = {}, None
    for backend in ("pallas", "hybrid_dw"):
        for p in ("bf16_master", "fp16_scaled"):
            run, trainer = _rung_training(torch, seed, backend, p, batch,
                                          train[backend]["device_step_ms"])
            runs[f"train_{backend}_{p}"] = run
            if backend == "pallas" and p == "fp16_scaled":
                overflow = _overflow_skip(torch, trainer, batch)
            del trainer
            torch.cuda.empty_cache()
    fused = _fused33(torch, seed, batch, train["xla"]["device_step_ms"])
    torch.cuda.empty_cache()
    launches = {f"serve_{p}": {"conv3d_fwd": serve[p]["conv3d_fwd_launches"]}
                for p in ("bf16", "int8")}
    launches.update({k: r["launches"] for k, r in runs.items()})
    launches["train_pallas_fp16_scaled_overflow"] = overflow["launches"]
    launches["train_fused33"] = fused["launches"]
    out = {"serve": {p: {k: v for k, v in r.items() if k in (
               "resident_weight_bytes", "device_ms_bucket64", "device_ms_bucket1",
               "eager_device_ms_bucket64", "eager_device_ms_bucket1",
               "top1_agreement_vs_fp32", "max_prob_err_vs_plain")}
               for p, r in serve.items()},
           "train_device_step_ms": {k: r["device_step_ms"] for k, r in runs.items()},
           "train_fp32_device_step_ms": {b: train[b]["device_step_ms"]
                                         for b in ("pallas", "hybrid_dw", "xla")},
           "overflow_skip_bitwise": overflow["bitwise"],
           "fused33_device_step_ms": fused["device_step_ms"],
           "fused33_logits_max_abs_err_vs_xla": fused["logits_max_abs_err_vs_xla"],
           "nvidia_smi": smi_line}
    print("precision", json.dumps(out), flush=True)
    return {"launches": launches, **out}

# The ood phase: parts per class of the eval-ood report, the native line's
# parts (two of them rotated), the STL tree's parts per class, the build
# pool's widths, the parts of the canonicalized TTA and of the peak-memory
# TTA. TTA_ATOL: one cube rotation of the input permutes the 24 forwards
# the vote sums, so only the fp32 order of the sum changes.
OOD_PER_CLASS = 1
NATIVE_PARTS, NATIVE_ROTATED = 8, 2
STL_PER_CLASS = 1
STL_WORKERS = (1, 4)
TTA_PARTS, TTA_MEMORY_PARTS = 24, 64
TTA_ATOL = 1e-5


class _Forwards:
    """Device ms of every ``Predictor.forward`` call while installed (CUDA
    events around each call: copy-in, replay, clone-out)."""

    def __init__(self, torch):
        from featurenet_tpu_torch.infer import Predictor

        self._torch, self._cls = torch, Predictor
        self._orig = Predictor.forward
        self.events = []

    def __enter__(self):
        torch, orig, events = self._torch, self._orig, self.events

        def timed(pred, voxels):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(pred, voxels)
            b.record()
            events.append((a, b))
            return out

        self._cls.forward = timed
        return self

    def __exit__(self, *exc):
        self._cls.forward = self._orig
        return False

    def ms(self) -> float:
        self._torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def native_line(seed: int, build_info: dict, smi_line: str) -> dict:
    """The port's native voxelizer on the card's host: NATIVE_PARTS
    sprint64 parts (64³) through ``voxels_to_mesh`` (NATIVE_ROTATED of
    them rotated), voxelized natively and in numpy: bitwise equal."""
    import numpy as np

    from featurenet_tpu_torch import native
    from featurenet_tpu_torch.data.synthetic import generate_sample
    from featurenet_tpu_torch.data.voxel_to_mesh import (
        random_rotation_matrix,
        rotate_mesh,
        voxels_to_mesh,
    )
    from featurenet_tpu_torch.data.voxelize import voxelize

    if not native.available():
        fail("the native voxelizer does not build or load")
    rng = np.random.default_rng(seed)
    meshes = []
    for i in range(NATIVE_PARTS):
        part = generate_sample(rng, 64, label=(3 * i) % 24)[0]
        tris = voxels_to_mesh(part)
        if i < NATIVE_ROTATED:
            tris = rotate_mesh(tris, random_rotation_matrix(rng))
        meshes.append(tris)
    times = {"native": 0.0, "numpy": 0.0}
    for i, tris in enumerate(meshes):
        got = {}
        for backend in times:
            t0 = time.perf_counter()
            got[backend] = voxelize(tris, 64, fill=True, backend=backend)
            times[backend] += time.perf_counter() - t0
        if not np.array_equal(got["native"], got["numpy"]):
            fail(f"native voxelization of part {i} differs from numpy in "
                 f"{int((got['native'] != got['numpy']).sum())} voxels")
    out = {"build_s": build_info["seconds"], "cached": build_info["cached"],
           "parts": NATIVE_PARTS, "rotated": NATIVE_ROTATED, "resolution": 64,
           "triangles_per_part": sum(len(t) for t in meshes) / len(meshes),
           "native_ms_per_part": times["native"] / NATIVE_PARTS * 1e3,
           "numpy_ms_per_part": times["numpy"] / NATIVE_PARTS * 1e3,
           "omp_threads": native.omp_threads(), "cpu_count": os.cpu_count(),
           "bitwise_numpy": True, "nvidia_smi": smi_line}
    print("native", json.dumps(out), flush=True)
    return out


def _tree_mb(root: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files) / 1e6


def _same_cache(a: str, b: str) -> bool:
    names = sorted(os.listdir(b))
    if sorted(os.listdir(a)) != names:
        return False
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            if name == "index.json":
                if json.load(fa) != json.load(fb):
                    return False
            elif fa.read() != fb.read():
                return False
    return True


def stl_cache_line(seed: int, tmp: str, smi_line: str) -> dict:
    """``cli export-stl-data`` (STL_PER_CLASS parts per class at 64³), then
    ``cli build-cache`` at each of STL_WORKERS, as subprocesses on the
    host: the caches must be bitwise each other and the ``mesh_pose=
    "remesh"`` export of the same seed."""
    import numpy as np

    from featurenet_tpu_torch.data.offline import export_synthetic_cache

    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "featurenet_tpu_torch.cli"]
    tree = os.path.join(tmp, "stl")

    def run(*args) -> dict:
        t0 = time.perf_counter()
        p = subprocess.run(cli + list(args), cwd=root, capture_output=True,
                           text=True, timeout=600)
        if p.returncode != 0:
            fail(f"cli {args[0]} exited {p.returncode}: {p.stderr[-2000:]}")
        return {**json.loads(p.stdout.strip().splitlines()[-1]),
                "wall_s": time.perf_counter() - t0}

    exported = run("export-stl-data", "--out", tree, "--per-class",
                   str(STL_PER_CLASS), "--resolution", "64", "--seed", str(seed))
    meshes = sum(exported["exported"].values())
    builds = {}
    for w in STL_WORKERS:
        out = os.path.join(tmp, f"built_w{w}")
        r = run("build-cache", "--stl-root", tree, "--out", out,
                "--resolution", "64", "--workers", str(w))
        if sum(r["built"].values()) != meshes:
            fail(f"build-cache --workers {w} built {r['built']}")
        builds[w] = {"wall_s": r["wall_s"], "build_s": r["seconds"],
                     "meshes_per_s": meshes / r["seconds"], "dir": out}
    remesh = os.path.join(tmp, "remesh")
    t0 = time.perf_counter()
    export_synthetic_cache(remesh, per_class=STL_PER_CLASS, resolution=64,
                           seed=seed, mesh_pose="remesh")
    remesh_s = time.perf_counter() - t0
    first = builds[STL_WORKERS[0]]["dir"]
    for w in STL_WORKERS[1:]:
        if not _same_cache(builds[w]["dir"], first):
            fail(f"build-cache --workers {w} differs from --workers "
                 f"{STL_WORKERS[0]}")
    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES

    for cls in CLASS_NAMES:
        if not np.array_equal(np.load(os.path.join(first, f"{cls}.npy")),
                              np.load(os.path.join(remesh, f"{cls}.npy"))):
            fail(f"the STL-built cache differs from the remesh export in {cls}")
    out = {"meshes": meshes, "resolution": 64,
           "export_stl_wall_s": exported["wall_s"], "stl_mb": _tree_mb(tree),
           "cache_mb": _tree_mb(first),
           "builds": {str(w): {k: v for k, v in b.items() if k != "dir"}
                      for w, b in builds.items()},
           "remesh_export_s": remesh_s, "cpu_count": os.cpu_count(),
           "bitwise_across_workers": True, "bitwise_remesh_export": True,
           "nvidia_smi": smi_line}
    print("stl_cache", json.dumps(out), flush=True)
    return out


def _plain_model(pred):
    """The plain-conv copy of ``pred``'s fp32 weights, on the card."""
    from featurenet_tpu_torch.runtime import build_model

    plain = build_model(pred.cfg, plain=True)
    plain.load_state_dict(pred.model.state_dict())
    return plain.to("cuda")


def _plain_probs(torch, model, grids, tta: bool = False):
    """``model``'s probabilities for numpy ``grids`` ``[N,R,R,R]``, in
    chunks of 64 on the card; with ``tta`` the mean over the 24
    ``CUBE_GROUP`` rotations, summed in their order."""
    import numpy as np

    from featurenet_tpu_torch.ops.augment import CUBE_GROUP, apply_rotation
    from featurenet_tpu_torch.runtime import serve_forward

    out = []
    for s in range(0, len(grids), 64):
        x = torch.from_numpy(
            np.ascontiguousarray(grids[s:s + 64], np.float32)[..., None]).cuda()
        if not tta:
            out.append(serve_forward(model, x).cpu().numpy())
            continue
        acc = None
        for perm, flips in CUBE_GROUP:
            p = serve_forward(model, apply_rotation(x, perm, flips).contiguous())
            acc = p if acc is None else acc + p
        out.append((acc / len(CUBE_GROUP)).cpu().numpy())
    return np.concatenate(out)


def _against_plain(kernel, plain, what: str) -> dict:
    """Kernel probabilities within PROB_ATOL of the plain conv's, and the
    same label wherever the plain top-2 margin is at least PROB_ATOL."""
    import numpy as np

    err = float(np.abs(kernel - plain).max())
    if not err <= PROB_ATOL:
        fail(f"{what}: kernel probabilities {err} from the plain conv's "
             f"(> {PROB_ATOL})")
    top2 = np.sort(plain, axis=-1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) < PROB_ATOL
    flips = (kernel.argmax(-1) != plain.argmax(-1)) & ~near
    if flips.any():
        fail(f"{what}: {int(flips.sum())} labels differ from the plain conv's "
             "away from a near-tie")
    return {"max_abs_err": err, "near_ties": int(near.sum()),
            "labels_differ_at_near_ties": int(
                (kernel.argmax(-1) != plain.argmax(-1)).sum())}


def ood_line(torch, seed: int, ck: str, tmp: str, smi_line: str) -> dict:
    """``cli eval-ood --per-class 1`` on the card (in this process) over
    every DEFAULT_LEVELS row of a seeded sprint64 ``pallas`` checkpoint:
    13 rows of 24 parts, the clean row's delta 0; the host seconds in
    ``_perturb``, the wall of the ``predict_voxels`` calls, the forwards'
    device ms (each the upload of a host batch padded to 64, the replay
    and the clone; the first also the capture) and the launches of the
    run; then the clean and so3 rows' grids through the kernels against
    the plain conv."""
    import io

    import numpy as np

    from featurenet_tpu_torch import cli, ood
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.runtime.registry import WARMUP_ITERS

    kept_rows = (("clean", None), ("rotation", "so3"))
    perturb = ood._perturb
    host = {"s": 0.0, "kept": {k: [] for k in kept_rows}}

    def timed(family, level, grid, rng):
        t0 = time.perf_counter()
        g = perturb(family, level, grid, rng)
        host["s"] += time.perf_counter() - t0
        if (family, level) in host["kept"]:
            host["kept"][(family, level)].append(g)
        return g

    predict = Predictor.predict_voxels

    def timed_predict(pred, grids, **kw):
        t0 = time.perf_counter()
        out = predict(pred, grids, **kw)
        host["predict_s"] += time.perf_counter() - t0
        return out

    host["predict_s"] = 0.0
    rows_path = os.path.join(tmp, "rows.json")
    printed = io.StringIO()
    _reset_counts()
    ood._perturb, Predictor.predict_voxels = timed, timed_predict
    try:
        with _Forwards(torch) as fw, contextlib.redirect_stdout(printed):
            t0 = time.perf_counter()
            rc = cli.main(["eval-ood", "--checkpoint-dir", ck, "--per-class",
                           str(OOD_PER_CLASS), "--seed", str(seed),
                           "--out", rows_path])
            wall = time.perf_counter() - t0
    finally:
        ood._perturb, Predictor.predict_voxels = perturb, predict
    counts = _read_counts()
    device_ms = fw.ms()
    with open(rows_path) as fh:
        rows = json.load(fh)
    if rc != 0 or [json.loads(ln) for ln in printed.getvalue().splitlines()] != rows:
        fail(f"cli eval-ood returned {rc}; printed rows differ from --out's")
    n = 24 * OOD_PER_CLASS
    if [(r["family"], r["level"]) for r in rows] != list(ood.DEFAULT_LEVELS):
        fail(f"eval-ood rows {[(r['family'], r['level']) for r in rows]}")
    if any(r["n"] != n for r in rows) or rows[0]["delta_vs_clean"] != 0.0:
        fail(f"eval-ood rows {rows}")
    want = dict(_want_counts("xla", 0, 0), conv3d_fwd=3 * (WARMUP_ITERS + 1))
    if counts != want:
        fail(f"eval-ood launched {counts}, not {want} (one bucket-64 graph)")
    if len(fw.events) != len(rows) * 24:
        fail(f"eval-ood ran {len(fw.events)} forwards, not {len(rows) * 24}")
    pred = Predictor.from_checkpoint(ck, batch=64)
    plain = _plain_model(pred)
    checks = {}
    for key in kept_rows:
        grids = np.stack(host["kept"][key]).astype(np.float32)
        _, probs = pred.predict_voxels(grids)
        checks[f"{key[0]}_{key[1]}"] = _against_plain(
            probs, _plain_probs(torch, plain, grids), f"ood {key}")
    out = {"rows": len(rows), "parts_per_row": n, "wall_s": wall,
           "perturb_host_s": host["s"], "predict_voxels_wall_s": host["predict_s"],
           "forwards": len(fw.events),
           "forward_device_ms": device_ms,
           "device_share": device_ms / 1e3 / wall,
           "launches": counts, "kernel_vs_plain": checks,
           "accuracy": {f"{r['family']}_{r['level']}": r["accuracy"] for r in rows},
           "nvidia_smi": smi_line}
    print("ood", json.dumps(out), flush=True)
    return out


def _turn(grids, code: int):
    """Numpy ``[N,R,R,R]`` grids rotated by CUBE_GROUP[code]."""
    import numpy as np

    from featurenet_tpu_torch.ops.augment import CUBE_GROUP

    perm, flips = CUBE_GROUP[code]
    g = np.transpose(grids, (0, *(1 + p for p in perm)))
    return np.ascontiguousarray(np.flip(g, [1 + i for i, f in enumerate(flips) if f]))


def tta_line(torch, seed: int, ck: str, smi_line: str) -> dict:
    """TTA_PARTS parts (one per class, each rotated uniformly in SO(3)
    through ``rotate_part``) through ``predict_voxels(canonicalize=True)``
    on the checkpoint of the ood line: host canonicalize s per part, device
    ms and replays against nine bucket-64 replays; the vote against the
    plain conv's; a cube rotation of the input moving the vote by at most
    TTA_ATOL; and the peak device memory of a TTA_MEMORY_PARTS-part vote
    beside a bucket-64 forward's."""
    import importlib

    import numpy as np

    from featurenet_tpu_torch.data.synthetic import generate_batch, generate_sample
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.ood import rotate_part
    from featurenet_tpu_torch.runtime.registry import WARMUP_ITERS

    canon_mod = importlib.import_module("featurenet_tpu_torch.data.canonicalize")
    rng = np.random.default_rng(seed + 1)
    grids = np.stack([rotate_part(generate_sample(rng, 64, label=c)[0], rng)
                      for c in range(TTA_PARTS)]).astype(np.float32)
    pred = Predictor.from_checkpoint(ck, batch=64)
    orig = canon_mod.canonicalize
    canon = {"s": 0.0, "grids": []}

    def timed(g, **kw):
        t0 = time.perf_counter()
        c = orig(g, **kw)
        canon["s"] += time.perf_counter() - t0
        canon["grids"].append(c)
        return c

    _reset_counts()
    _, tta = pred.predict_voxels(grids, tta_rotations=True)  # captures b64
    canon_mod.canonicalize = timed
    try:
        with _Forwards(torch) as fw:
            t0 = time.perf_counter()
            _, probs = pred.predict_voxels(grids, canonicalize=True)
            wall = time.perf_counter() - t0
    finally:
        canon_mod.canonicalize = orig
    counts = _read_counts()
    want = dict(_want_counts("xla", 0, 0), conv3d_fwd=3 * (WARMUP_ITERS + 1))
    if counts != want:
        fail(f"tta launched {counts}, not {want} (one bucket-64 graph)")
    replays = -(-TTA_PARTS * 24 // 64)
    if len(fw.events) != replays:
        fail(f"tta over {TTA_PARTS} parts ran {len(fw.events)} forwards, "
             f"not {replays}")
    device_ms = fw.ms()
    x64 = torch.from_numpy(grids[:1].repeat(64, 0)[..., None]).cuda()
    replay_ms = time_ms(torch, lambda: pred.forward(x64))
    plain = _plain_model(pred)
    vs_plain = _against_plain(
        probs, _plain_probs(torch, plain, np.stack(canon["grids"]), tta=True),
        "tta canonicalized")
    _, turned = pred.predict_voxels(_turn(grids, 17), tta_rotations=True)
    turn_err = float(np.abs(turned - tta).max())
    if not turn_err <= TTA_ATOL:
        fail(f"tta moved {turn_err} under a cube rotation of the input")
    # Peak memory over what the Predictor holds (its graph pool included).
    many = generate_batch(rng, TTA_MEMORY_PARTS, 64)["voxels"][..., 0]
    peaks = {}
    for what, fn in (
            ("tta", lambda: pred.predict_voxels(many, tta_rotations=True)),
            ("graphed_forward", lambda: pred.forward(x64)),
            ("eager_forward", lambda: pred.forward_eager(x64))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
        peaks[what] = (torch.cuda.max_memory_allocated() - base) / 1e6
    out = {"parts": TTA_PARTS, "canonicalize_host_s_per_part":
           canon["s"] / TTA_PARTS, "wall_s": wall, "forwards": len(fw.events),
           "device_ms": device_ms, "bucket64_replay_ms": replay_ms,
           "device_ms_over_replays": device_ms / (replays * replay_ms),
           "launches": counts, "kernel_vs_plain": vs_plain,
           "cube_rotation_max_abs_diff": turn_err,
           "peak_mb_over_base": {f"{k}_b64" if k != "tta" else
                                 f"tta_{TTA_MEMORY_PARTS}_parts": v
                                 for k, v in peaks.items()},
           "nvidia_smi": smi_line}
    print("tta", json.dumps(out), flush=True)
    return out


def ood_phase(torch, seed: int, native_info: dict, smi_line: str) -> dict:
    """The robustness-evaluation lines: ``native``, ``stl_cache``, ``ood``
    and ``tta``. Returns the ood and tta runs' launches."""
    from featurenet_tpu_torch.config import get_config

    native_line(seed, native_info, smi_line)
    with tempfile.TemporaryDirectory() as tmp:
        stl_cache_line(seed, tmp, smi_line)
        cfg = get_config("sprint64")
        if cfg.arch.conv_backend != "pallas":
            fail(f"sprint64 serves through {cfg.arch.conv_backend}, not pallas")
        ck = _seeded_checkpoint(os.path.join(tmp, "ck"), cfg, seed)
        ood = ood_line(torch, seed, ck, tmp, smi_line)
        tta = tta_line(torch, seed, ck, smi_line)
    return {"launches": {"ood": ood["launches"], "tta": tta["launches"]}}


# --- seg64: the segmenter on the card ------------------------------------------

SEG_CACHE_PARTS = 512
SEG_TRAIN_STEPS = 30
SEG_STREAM_STEPS = 10
SEG_SYNTH_STEPS = 2
SEG_PROFILE_STEPS = 2
SEG_SERVE_BUCKETS = (32, 1)
SEG_SERVE_PRECISIONS = ("fp32", "bf16", "int8")
SEG_INT8_AGREEMENT_PARTS = 64
# seg_affine: robust64's affine settings (prob 0.5, the default scale
# range, rotation on) on a resident seg64 run, cut from 10,000 steps.
SEG_AFFINE_STEPS = 10
SEG_AFFINE_PROB = 0.5
SEG_WARP_VOXEL_ATOL = WARP_ATOL
# seg_ood: fresh parts a row, cut from the reference's 60.
SEG_OOD_PARTS = 16
# seg_stl: parts in the STL tree, and the ingest's worker counts.
SEG_STL_PARTS = 48
SEG_STL_WORKERS = (1, 4)
# seg_oracle: samples, cut from the reference's 1,024.
SEG_ORACLE_SAMPLES = 64
SEG_HTTP_GRIDS = 3
SEG_CLI_PARTS = 64
SEG_CLI_STEPS = 4
# Kernel-name families of a seg64 step's profile, matched in order.
SEG_FAMILIES = (
    ("conv (cuDNN fprop, dgrad, wgrad)",
     ("conv", "cudnn", "xmma", "fprop", "dgrad", "wgrad", "implicit", "winograd")),
    ("gemm", ("gemm", "cutlass", "cublas")),
    ("elementwise, reduce, copy",
     ("elementwise", "reduce", "vectorized", "copy", "cat", "index", "scatter",
      "gather", "softmax", "batch_norm", "arange", "fill")),
)
SEG_RANGES = ("input_context", "casts", "bn_relu", "conv_transpose", "loss",
              "optimizer")


def _seg_act_bytes(cfg) -> int:
    """The reference's byte model of a segmenter train step's activations
    per sample (``featurenet_tpu/ops/membytes.py``
    ``segmenter_act_bytes_per_sample``, 3.2 live bf16 tensors per block),
    copied here: a sanity line beside the card's peak, not a target."""
    R, blk = cfg.resolution, 3.2 * 2
    in_ch = {"none": 1, "proj": 4, "proj_coords": 7}[cfg.seg_input_context]
    total = 4 * R ** 3 + 2 * in_ch * R ** 3
    d = R
    for f in cfg.seg_features:
        total += int(blk * f * d ** 3)
        d //= 2
        total += int(blk * f * d ** 3)
    for _ in range(cfg.seg_bottleneck_blocks):
        total += int(blk * cfg.seg_features[-1] * 2 * d ** 3)
    for f in reversed(cfg.seg_features):
        d *= 2
        total += 2 * f * d ** 3 + 2 * 2 * f * d ** 3
        total += int(blk * f * d ** 3) * cfg.seg_decoder_blocks
    return total + 3 * 4 * 25 * R ** 3 + 4 * R ** 3


def _seg_cfg(seed: int, **kw):
    from featurenet_tpu_torch.config import get_config

    cfg = get_config("seg64", seed=seed, **kw)
    if (cfg.task, cfg.resolution, cfg.global_batch, cfg.num_features,
            tuple(cfg.seg_features), cfg.seg_input_context,
            cfg.seg_decoder_blocks, cfg.seg_loss) != (
            "segment", 64, 32, 3, (32, 64, 128), "proj_coords", 2, "ce_dice"):
        fail(f"seg64 is not at full width: {cfg}")
    return cfg


def _finite(v) -> bool:
    return v == v and abs(v) < 1e30


def _losses_of(trainer) -> list:
    """A list that collects each dispatch's loss tensor (on the card, no
    readback) as ``trainer`` runs."""
    losses, dispatch = [], trainer.dispatch

    def kept(batches, take):
        metrics = dispatch(batches, take)
        losses.append(metrics["loss"])
        return metrics

    trainer.dispatch = kept
    return losses


def _finite_losses(torch, losses: list, steps: int, what: str) -> list[float]:
    values = torch.stack(losses).tolist()
    if len(values) != steps or not all(_finite(v) for v in values):
        fail(f"seg_train {what}: losses {values}")
    return values


def seg_cache_line(seed: int, cache: str, smi_line: str) -> dict:
    from featurenet_tpu_torch.data.offline import export_seg_cache

    t0 = time.perf_counter()
    index = export_seg_cache(cache, num_parts=SEG_CACHE_PARTS, resolution=64,
                             num_features=3, seed=seed)
    host_s = time.perf_counter() - t0
    mb = _tree_mb(cache)
    out = {"parts": sum(s["count"] for s in index["shards"]),
           "shards": len(index["shards"]), "resolution": 64,
           "num_features": 3, "label_order": index["label_order"],
           "host_s": host_s, "parts_per_s": SEG_CACHE_PARTS / host_s,
           "host_ms_per_part": host_s / SEG_CACHE_PARTS * 1e3,
           "mb_on_disk": mb, "nvidia_smi": smi_line}
    print("seg_cache", json.dumps(out), flush=True)
    return out


def _seg_step_ms(torch, trainer, batch, reps: int = 5) -> float:
    return time_ms(torch, lambda: trainer.step(batch), reps=reps, warmup=1)


def seg_train_line(torch, seed: int, cache: str, smi_line: str):
    """seg64 resident on the card (hbm_cache, the paired rotation in the
    step) for SEG_TRAIN_STEPS steps, then streamed from the cache (host
    rotation, the Prefetcher) and from the synthetic stream. Returns the
    line and the resident trainer."""
    from featurenet_tpu_torch.train.loop import Trainer

    with open(os.devnull, "w") as sink:
        # The preset's schedule and cadence; the runs stop early, with no
        # eval pass, each step's loss kept on the card (_losses_of).
        cfg = _seg_cfg(seed, data_cache=cache, hbm_cache=True,
                       eval_every=10 ** 6, data_workers=TRAIN_WORKERS)
        if not (cfg.device_augment and cfg.augment_groups == 8):
            fail(f"seg64 resident run does not rotate in the step: {cfg}")
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device="cuda", stream=sink)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if not (trainer._labels.is_cuda and trainer._labels.dtype == torch.int8):
            fail("the resident seg is not int8 on the card")
        torch.cuda.reset_peak_memory_stats()
        base_mb = torch.cuda.memory_allocated() / 1e6
        losses = _losses_of(trainer)
        trainer.run(num_steps=SEG_TRAIN_STEPS)
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        losses = _finite_losses(torch, losses, SEG_TRAIN_STEPS, "resident")
        t = trainer.timing
        step_ms = _seg_step_ms(torch, trainer, None)
        resident = {"steps": SEG_TRAIN_STEPS, "setup_s": setup_s,
                    "device_step_ms": step_ms,
                    "samples_per_sec_device_bound": cfg.global_batch / step_ms * 1e3,
                    "samples_per_sec_with_data_wait":
                        SEG_TRAIN_STEPS * cfg.global_batch / t["wall_s"],
                    "data_wait_share": t["data_wait_s"] / t["wall_s"],
                    "losses_finite": True, "first_loss": losses[0],
                    "last_loss": losses[-1],
                    "peak_allocated_mb": peak_mb,
                    "allocated_before_mb": base_mb,
                    "reference_byte_model_mb": _seg_act_bytes(cfg) * cfg.global_batch / 1e6,
                    **trainer.resident}

        # Streamed from the cache: the host rotates voxels and seg together.
        scfg = _seg_cfg(seed, data_cache=cache, eval_every=10 ** 6,
                        data_workers=TRAIN_WORKERS)
        streamed = Trainer(scfg, device="cuda", stream=sink)
        if not streamed.train_data.augment or scfg.device_augment:
            fail("streamed seg64 does not rotate on the host")
        sl = _losses_of(streamed)
        streamed.run(num_steps=SEG_STREAM_STEPS)
        torch.cuda.synchronize()
        st = streamed.timing
        _finite_losses(torch, sl, SEG_STREAM_STEPS, "streamed")

        # The synthetic stream: 3-feature parts made on the host.
        ycfg = _seg_cfg(seed, data_workers=1)
        synth = Trainer(ycfg, device="cuda", stream=sink)
        it = synth.train_data.worker_iter(0)
        t0 = time.perf_counter()
        batches = [next(it) for _ in range(SEG_SYNTH_STEPS)]
        host_s = time.perf_counter() - t0
        for b in batches:
            m = synth.step({k: torch.from_numpy(v).cuda() for k, v in b.items()})
            if not _finite(float(m["loss"])):
                fail(f"seg_train synthetic: loss {float(m['loss'])}")
        del synth, streamed
    out = {"resident": resident,
           "streamed": {"steps": SEG_STREAM_STEPS, "data_workers": TRAIN_WORKERS,
                        "samples_per_sec_with_data_wait":
                            SEG_STREAM_STEPS * scfg.global_batch / st["wall_s"],
                        "data_wait_share": st["data_wait_s"] / st["wall_s"],
                        "losses_finite": True},
           "synthetic": {"steps": SEG_SYNTH_STEPS, "num_features": 3,
                         "host_ms_per_sample":
                             host_s / (SEG_SYNTH_STEPS * ycfg.global_batch) * 1e3,
                         "losses_finite": True},
           "nvidia_smi": smi_line}
    print("seg_train", json.dumps(out), flush=True)
    return out, trainer


def seg_profile_line(torch, trainer, smi_line: str) -> dict:
    """SEG_PROFILE_STEPS resident seg64 steps under torch.profiler: device
    ms per step by kernel family (matched on the kernel's name) and inside
    each of SEG_RANGES (forward ranges; the optimizer's is its whole
    update), the top kernels and the device-busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def is_kernel(e):
        return e.device_type == DeviceType.CUDA and not e.is_user_annotation

    trainer.step()  # outside the window: nothing first-use inside it
    torch.cuda.synchronize()
    steps = SEG_PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = sorted((e for e in averages if is_kernel(e)),
                     key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in kernels)
    families = {name: 0.0 for name, _ in SEG_FAMILIES}
    families["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        fam = next((name for name, words in SEG_FAMILIES
                    if any(w in key for w in words)), "other")
        families[fam] += e.self_device_time_total / 1e3 / steps
    ranges = {name: sum(e.device_time_total for e in averages
                        if e.key == name and e.device_type == DeviceType.CPU)
              / 1e3 / steps for name in SEG_RANGES}
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if is_kernel(e))
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    window_us = spans[-1][1] - spans[0][0] if spans else 0.0
    out = {"steps": steps, "device_ms_per_step": device_us / 1e3 / steps,
           "device_busy_share": busy_us / window_us if window_us else None,
           "family_device_ms_per_step": families,
           "range_device_ms_per_step": ranges,
           "top_kernels": [{"name": e.key[:120], "calls": e.count,
                            "device_ms_per_step": e.self_device_time_total / 1e3 / steps}
                           for e in kernels[:10]],
           "nvidia_smi": smi_line}
    if device_us == 0:
        out["device_time"] = "key_averages() recorded no device time"
    print("seg_profile", json.dumps(out), flush=True)
    return out


def seg_eval_line(trainer, smi_line: str) -> dict:
    ev = trainer.evaluate()
    fg = _seg_fg_accuracy(trainer)
    if not (0.0 <= ev["mean_iou"] <= 1.0 and len(ev["per_class_iou"]) == 25):
        fail(f"seg_eval: {ev}")
    out = {"batches": ev["batches"], "samples": ev["samples"],
           "mean_iou": ev["mean_iou"], "voxel_accuracy": ev["accuracy"],
           "fg_accuracy": fg, "loss": ev["loss"],
           "per_class_iou": ev["per_class_iou"], "nvidia_smi": smi_line}
    print("seg_eval", json.dumps(out), flush=True)
    return out


def _seg_fg_accuracy(trainer) -> float:
    """Foreground voxel accuracy over the same held-out pass (the eval
    sums count every voxel)."""
    import torch

    from featurenet_tpu_torch.train.steps import unpack_voxels

    hit = total = 0.0
    model = trainer.state.model
    with torch.no_grad():
        for batch in trainer.eval_data.epoch_batches(trainer.cfg.global_batch):
            x = unpack_voxels(torch.from_numpy(batch["voxels"]).cuda())
            seg = torch.from_numpy(batch["seg"]).cuda().long()
            keep = torch.from_numpy(batch["mask"]).cuda()[:, None, None, None] > 0
            fg = (seg > 0) & keep
            pred = model(x, train=False).argmax(dim=-1)
            hit += float(((pred == seg) & fg).sum())
            total += float(fg.sum())
    return hit / total if total else 0.0


def seg_serve_line(torch, seed: int, trainer, tmp: str, smi_line: str) -> dict:
    """The trained state saved and restored bitwise; Predictor.from_checkpoint
    at fp32, bf16 and int8 with graphs at SEG_SERVE_BUCKETS: graphed labels
    bitwise the eager ones, device ms of both, capture s and reserved MB
    per generation, resident weight bytes, bf16's and int8's per-voxel
    agreement with fp32 on the buckets' inputs, and int8's over
    SEG_INT8_AGREEMENT_PARTS synthetic parts (printed, not gated: the
    reference gates no segmenter); POST /predict_voxels answering the
    bincount of predict_voxels_seg."""
    import numpy as np

    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.http import make_server
    from featurenet_tpu_torch.serve.service import InferenceService
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.loop import Trainer

    ck = os.path.join(tmp, "seg_ck")
    mgr = CheckpointManager(ck, config=trainer.cfg)
    t0 = time.perf_counter()
    mgr.save(trainer.state)
    mgr.wait()
    save_s = time.perf_counter() - t0
    mgr.close()
    with open(os.devnull, "w") as sink:
        fresh = Trainer(trainer.cfg, device="cuda", stream=sink)
    t0 = time.perf_counter()
    CheckpointManager(ck).restore(fresh.state)
    restore_s = time.perf_counter() - t0
    if not _bitwise_equal(torch, _train_state(trainer), _train_state(fresh)):
        fail("seg_serve: the restored seg64 state is not bitwise the saved one")
    del fresh
    R = trainer.cfg.resolution
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = {b: (torch.rand((b, R, R, R, 1), device="cuda", generator=g) > 0.6).float()
          for b in SEG_SERVE_BUCKETS}
    gens, labels = {}, {}
    preds = {}
    for precision in SEG_SERVE_PRECISIONS:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_reserved()
        pred = Predictor.from_checkpoint(ck, batch=max(SEG_SERVE_BUCKETS),
                                         device="cuda", precision=precision)
        t0 = time.perf_counter()
        progs = {b: pred.program_for(b) for b in SEG_SERVE_BUCKETS}
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        buckets = {}
        for b in SEG_SERVE_BUCKETS:
            x = xs[b]
            n = pred.replays
            graphed = pred.forward(x)
            with torch.inference_mode():
                eager = pred.forward_eager(x)
            if pred.replays != n + 1 or progs[b].graph is None:
                fail(f"seg_serve {precision} bucket {b}: not answered by its graph")
            if graphed.dtype != torch.int8 or tuple(graphed.shape) != (b, R, R, R):
                fail(f"seg_serve {precision}: labels {graphed.dtype} {tuple(graphed.shape)}")
            if not torch.equal(graphed, eager):
                fail(f"seg_serve {precision} bucket {b}: graphed labels differ "
                     f"from eager at {int((graphed != eager).sum())} voxels")
            if any(progs[b].capture_launches.values()):
                fail(f"seg_serve: a capture launched {progs[b].capture_launches}")
            with torch.inference_mode():
                eager_ms = time_ms(torch, lambda: pred.forward_eager(x), reps=5)
            buckets[b] = {"graphed_ms": time_ms(torch, lambda: pred.forward(x), reps=5),
                          "eager_ms": eager_ms, "bitwise_eager": True,
                          "capture_s": progs[b].capture_s}
            labels[(precision, b)] = graphed
        gens[precision] = {"buckets": buckets, "build_s": build_s,
                           "generation_reserved_mb":
                               (torch.cuda.memory_reserved() - base) / 1e6,
                           "resident_weight_bytes": pred.resident_weight_bytes}
        if precision == "int8":
            gens["int8"]["voxel_agreement_with_fp32"] = {
                "parts": SEG_INT8_AGREEMENT_PARTS,
                "agreement": pred.agreement(n=SEG_INT8_AGREEMENT_PARTS, seed=seed)}
        if precision == "fp32":
            preds[precision] = pred
        del pred, progs
    fp32_bytes = gens["fp32"]["resident_weight_bytes"]
    for precision in SEG_SERVE_PRECISIONS:
        gens[precision]["resident_weight_fraction_of_fp32"] = (
            gens[precision]["resident_weight_bytes"] / fp32_bytes)
    agree = {precision: {b: float((labels[(precision, b)]
                                   == labels[("fp32", b)]).float().mean())
                         for b in SEG_SERVE_BUCKETS}
             for precision in SEG_SERVE_PRECISIONS if precision != "fp32"}

    pred = preds["fp32"]
    rng = np.random.default_rng(seed)
    grids = (rng.random((SEG_HTTP_GRIDS, R, R, R)) > 0.5).astype(np.float32)
    want = pred.predict_voxels_seg(grids)
    # One bucket, the batch predict_voxels_seg pads to: the same program
    # answers both, so the labels must agree exactly.
    service = InferenceService(pred, buckets=(pred.batch,), max_wait_ms=2)
    srv = make_server(service, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=120)
        t0 = time.perf_counter()
        for grid, lab in zip(grids, want):
            status, body, _ = _post(conn, "/predict_voxels", grid.astype("<f4").tobytes())
            counts = np.bincount(lab.ravel().astype(np.int64), minlength=25)
            expect = {c: int(counts[i + 1]) for i, c in enumerate(CLASS_NAMES)
                      if counts[i + 1]}
            if status != 200 or body != {"voxel_counts": expect}:
                fail(f"seg_serve /predict_voxels answered {status}: {body} "
                     f"(want {expect})")
        http_ms = (time.perf_counter() - t0) * 1e3 / SEG_HTTP_GRIDS
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        service.drain()
    out = {"checkpoint_save_s": save_s, "restore_s": restore_s,
           "restored_bitwise": True, "generations": gens,
           "voxel_agreement_with_fp32": agree,
           "http_predict_voxels": {"requests": SEG_HTTP_GRIDS,
                                   "ms_per_request": http_ms,
                                   "voxel_counts_equal_bincount": True},
           "nvidia_smi": smi_line}
    print("seg_serve", json.dumps(out), flush=True)
    return out


class _Cli:
    """One ``featurenet_tpu_torch.cli`` subprocess (or one of another
    ``module``), started at once; ``records()`` waits for it and returns
    its JSON lines, failing the script on a non-zero exit."""

    def __init__(self, name: str, *args, module: str = "featurenet_tpu_torch.cli"):
        self.name = name
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def records(self) -> list[dict]:
        try:
            out, err = self.proc.communicate(timeout=600)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.communicate()
        self.wall_s = time.perf_counter() - self.t0
        if self.proc.returncode != 0:
            fail(f"cli {self.name} exited {self.proc.returncode}: {err[-2000:]}")
        return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def seg_cli_line(seed: int, tmp: str, export: _Cli, smi_line: str) -> dict:
    """``cli export-seg-data`` (``export``, started with the phase: it runs
    on the host alone), ``cli train --config seg64 --data-cache``
    (resident), then ``cli eval`` and ``cli infer --seg-out`` on two STL
    parts side by side, as subprocesses on the card; then ``cli programs
    --config seg64 --warm`` (every serving precision's graphs, int8
    included) in this process."""
    import numpy as np

    from featurenet_tpu_torch.data.stl import save_stl
    from featurenet_tpu_torch.data.synthetic import generate_sample
    from featurenet_tpu_torch.data.voxel_to_mesh import voxels_to_mesh

    cache, ck, out_dir = (os.path.join(tmp, n) for n in ("cli_seg", "cli_ck", "cli_out"))
    exp = export.records()
    if exp[-1] != {"exported": SEG_CLI_PARTS, "shards": 1}:
        fail(f"cli export-seg-data printed {exp}")
    train = _Cli("train", "train", "--config", "seg64", "--data-cache", cache,
                 "--hbm-cache", "--total-steps", str(SEG_CLI_STEPS),
                 "--checkpoint-dir", ck, "--seed", str(seed))
    recs = train.records()
    train_losses = [r["loss"] for r in recs if r.get("kind") == "train"]
    tev = [r for r in recs if r.get("kind") == "eval"]
    if not tev or not all(_finite(v) for v in train_losses) or \
            recs[-1].get("launches") is None or any(recs[-1]["launches"].values()):
        fail(f"cli train (seg64) records {recs[-3:]}")
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(2):
        part, _, _ = generate_sample(rng, 64, num_features=3)
        paths.append(os.path.join(tmp, f"seg_part{i}.stl"))
        save_stl(paths[-1], voxels_to_mesh(part.astype(bool)))
    evaluate = _Cli("eval", "eval", "--checkpoint-dir", ck)
    infer = _Cli("infer", "infer", "--checkpoint-dir", ck, "--seg-out", out_dir,
                 *paths)
    ev = evaluate.records()[-1]["eval"]
    rows = infer.records()
    # Each subprocess's own kernel launches, which it prints on the card.
    children = {"train": recs[-1].get("launches"), "eval": ev.get("launches"),
                "infer": rows.pop()["launches"] if rows and "launches" in rows[-1]
                else None}
    if any(c is None for c in children.values()):
        fail(f"seg_cli: a subprocess printed no launches (not on the card): "
             f"{children}")
    if ev["mean_iou"] != tev[-1]["mean_iou"]:
        fail(f"cli eval mean_iou {ev['mean_iou']} != the run's {tev[-1]['mean_iou']}")
    for r in rows:
        lab = np.load(r["labels_path"])["labels"]
        if lab.shape != (64, 64, 64) or lab.dtype != np.int8 or \
                sum(r["voxel_counts"].values()) != int((lab > 0).sum()):
            fail(f"cli infer --seg-out row {r}")
    # The catalog's programs of seg64 built ahead, serve_int8 among them
    # (in this process: the three generations are freed on return).
    warm, warm_s = _cli_here("programs", "--config", "seg64", "--warm")
    built = warm[-1]["warmup"]
    if built.get("serve_int8", {}).get("source") != "capture" or any(
            built[n].get("source") != "capture" for n in ("serve", "serve_bf16")):
        fail(f"cli programs --warm (seg64) built {built}")
    walls = {c.name: c.wall_s for c in (export, train, evaluate, infer)}
    walls["programs"] = warm_s
    out = {"walls_s": walls, "exported": SEG_CLI_PARTS,
           "train_steps": SEG_CLI_STEPS, "train_losses": train_losses,
           "eval_mean_iou": ev["mean_iou"], "eval_samples": ev["samples"],
           "infer_rows": [{"path": os.path.basename(r["path"]),
                           "voxel_counts": r["voxel_counts"]} for r in rows],
           "programs_warm": {n: {k: v for k, v in r.items()
                                 if k in ("source", "build_s", "batches", "skipped")}
                             for n, r in built.items()},
           "subprocess_launches": children, "nvidia_smi": smi_line}
    print("seg_cli", json.dumps(out), flush=True)
    return out


def _cli_here(*args) -> tuple[list[dict], float]:
    """``cli.main(args)`` in this process (no interpreter or torch start):
    its JSON lines and its wall; a non-zero exit fails the script."""
    import io

    from featurenet_tpu_torch import cli

    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(list(args))
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"cli {args[0]} returned {rc}")
    return ([json.loads(ln) for ln in printed.getvalue().splitlines()
             if ln.startswith("{")], wall)


def seg_affine_line(torch, seed: int, cache: str, train: dict,
                    smi_line: str) -> dict:
    """seg64 resident from the phase's cache with the paired affine warp in
    the step (robust64's settings: take probability SEG_AFFINE_PROB, the
    default scale range, rotation on) for SEG_AFFINE_STEPS steps: device
    ms per step beside seg_train's cube-rotation step, peak allocated MB,
    finite losses. Then the warp alone at batch 32 on resident rows:
    ``affine_warp_pair`` against ``affine_warp_pair_plain`` (labels
    bitwise, voxels within SEG_WARP_VOXEL_ATOL), every warped label 0 or
    one its sample held, untaken groups bitwise, the device ms of both."""
    from featurenet_tpu_torch.ops.augment import (
        affine_warp_pair,
        affine_warp_pair_plain,
        draw_affine,
    )
    from featurenet_tpu_torch.train.loop import Trainer
    from featurenet_tpu_torch.train.steps import draw_rows, gather_rows, unpack_voxels

    with open(os.devnull, "w") as sink:
        cfg = _seg_cfg(seed, data_cache=cache, hbm_cache=True,
                       eval_every=10 ** 6, augment_affine=True,
                       augment_affine_prob=SEG_AFFINE_PROB)
        if not (cfg.device_augment and cfg.augment_affine_rotate
                and cfg.augment_scale_range == (0.7, 1.05)):
            fail(f"seg_affine: not robust64's affine settings: {cfg}")
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device="cuda", stream=sink)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if "affine" not in trainer._draws.streams or "codes" in trainer._draws.streams:
            fail(f"seg_affine: the step draws {trainer._draws.streams}")
        torch.cuda.reset_peak_memory_stats()
        losses = _losses_of(trainer)
        trainer.run(num_steps=SEG_AFFINE_STEPS)
        torch.cuda.synchronize()
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        losses = _finite_losses(torch, losses, SEG_AFFINE_STEPS, "affine")
        step_ms = _seg_step_ms(torch, trainer, None)

        b = cfg.global_batch
        g = torch.Generator(device="cuda").manual_seed(seed)
        batch = gather_rows(trainer._data, trainer._labels,
                            draw_rows(g, trainer._data.shape[0], b), "seg")
        vox, seg = unpack_voxels(batch["voxels"]), batch["seg"]
        opts = dict(scale_range=cfg.augment_scale_range, rotate=True,
                    translate_vox=cfg.augment_translate_vox)
        draw = draw_affine(g, b, cfg.augment_groups, 1.0, **opts)
        fast_v, fast_s = affine_warp_pair(vox, seg, *draw)
        plain_v, plain_s = affine_warp_pair_plain(vox, seg, *draw)
        if not torch.equal(fast_s, plain_s):
            fail(f"seg_affine: warped labels differ from the plain gather at "
                 f"{int((fast_s != plain_s).sum())} voxels")
        verr = float((fast_v - plain_v).abs().max())
        if verr > SEG_WARP_VOXEL_ATOL:
            fail(f"seg_affine: warped voxels {verr} from the plain gather")
        n_cls = 25
        held = torch.zeros((b, n_cls), dtype=torch.bool, device="cuda")
        held.scatter_(1, seg.reshape(b, -1).long(), True)
        held[:, 0] = True
        got = torch.zeros_like(held).scatter_(1, fast_s.reshape(b, -1).long(), True)
        if bool((got & ~held).any()):
            fail("seg_affine: a warped label its sample did not hold")
        half = draw._replace(take=torch.arange(len(draw.take), device="cuda") % 2 == 0)
        hv, hs = affine_warp_pair(vox, seg, *half)
        per = b // len(draw.take)
        for grp in range(1, len(draw.take), 2):
            sl = slice(grp * per, (grp + 1) * per)
            if not (torch.equal(hv[sl], vox[sl]) and torch.equal(hs[sl], seg[sl])):
                fail(f"seg_affine: untaken group {grp} changed")
        changed = float((fast_s != seg).float().mean())
        warp_ms = time_ms(torch, lambda: affine_warp_pair(vox, seg, *draw), reps=10)
        plain_ms = time_ms(torch, lambda: affine_warp_pair_plain(vox, seg, *draw),
                           reps=3, warmup=1)
        del trainer
    cube = train["resident"]
    out = {"steps": SEG_AFFINE_STEPS, "setup_s": setup_s,
           "affine": {"prob": cfg.augment_affine_prob,
                      "scale_range": list(cfg.augment_scale_range),
                      "rotate": cfg.augment_affine_rotate,
                      "translate_vox": cfg.augment_translate_vox,
                      "ramp_steps": cfg.augment_ramp_steps,
                      "groups": cfg.augment_groups},
           "device_step_ms": step_ms,
           "cube_rotation_step_ms": cube["device_step_ms"],
           "step_ms_over_cube": step_ms / cube["device_step_ms"],
           "peak_allocated_mb": peak_mb,
           "cube_rotation_peak_allocated_mb": cube["peak_allocated_mb"],
           "losses_finite": True, "first_loss": losses[0], "last_loss": losses[-1],
           "warp_alone": {"batch": b, "groups": len(draw.take),
                          "warp_device_ms": warp_ms,
                          "plain_gather_device_ms": plain_ms,
                          "labels_bitwise_plain": True,
                          "voxel_max_abs_err": verr,
                          "voxel_atol": SEG_WARP_VOXEL_ATOL,
                          "labels_held_by_sample": True,
                          "untaken_groups_bitwise": True,
                          "labels_changed_share": changed},
           "nvidia_smi": smi_line}
    print("seg_affine", json.dumps(out), flush=True)
    return out


def seg_ood_line(seed: int, ck: str, tmp: str, smi_line: str) -> dict:
    """``cli eval-ood --seg-parts SEG_OOD_PARTS`` on the card (in this
    process) on seg_cli's checkpoint: every SEG_DEFAULT_LEVELS row, the
    clean row's delta 0, the scale-0.7 control row there and each rotation
    row's ``delta_vs_scale_control``; the wall, and the host seconds in
    ``_perturb_seg`` against the wall of the ``predict_voxels_seg``
    calls."""
    from featurenet_tpu_torch import ood
    from featurenet_tpu_torch.infer import Predictor

    perturb, predict = ood._perturb_seg, Predictor.predict_voxels_seg
    host = {"perturb_s": 0.0, "predict_s": 0.0}

    def timed(*a):
        t0 = time.perf_counter()
        r = perturb(*a)
        host["perturb_s"] += time.perf_counter() - t0
        return r

    def timed_predict(pred, grids):
        t0 = time.perf_counter()
        r = predict(pred, grids)
        host["predict_s"] += time.perf_counter() - t0
        return r

    rows_path = os.path.join(tmp, "seg_ood_rows.json")
    ood._perturb_seg, Predictor.predict_voxels_seg = timed, timed_predict
    try:
        printed, wall = _cli_here("eval-ood", "--checkpoint-dir", ck,
                                  "--seg-parts", str(SEG_OOD_PARTS),
                                  "--seed", str(seed), "--out", rows_path)
    finally:
        ood._perturb_seg, Predictor.predict_voxels_seg = perturb, predict
    with open(rows_path) as fh:
        rows = json.load(fh)
    if printed != rows:
        fail("cli eval-ood (seg): printed rows differ from --out's")
    if [(r["family"], r["level"]) for r in rows] != list(ood.SEG_DEFAULT_LEVELS):
        fail(f"seg eval-ood rows {[(r['family'], r['level']) for r in rows]}")
    if any(r["n"] != SEG_OOD_PARTS or not 0.0 <= r["mean_iou"] <= 1.0
           for r in rows) or rows[0]["delta_vs_clean"] != 0.0:
        fail(f"seg eval-ood rows {rows}")
    if not any(r["family"] == "scale" and r["level"] == ood.ROTATION_PRESCALE
               for r in rows) or not all(
            "delta_vs_scale_control" in r for r in rows if r["family"] == "rotation"):
        fail(f"seg eval-ood: no scale-{ood.ROTATION_PRESCALE} control: {rows}")
    out = {"rows": rows, "parts_per_row": SEG_OOD_PARTS, "wall_s": wall,
           "perturb_seg_host_s": host["perturb_s"],
           "predict_voxels_seg_wall_s": host["predict_s"],
           "nvidia_smi": smi_line}
    print("seg_ood", json.dumps(out), flush=True)
    return out


def seg_diagnose_line(ck: str, cache: str, smi_line: str) -> dict:
    """``python -m featurenet_tpu_torch.train.seg_diagnose`` on seg_cli's
    checkpoint and cache, a subprocess on the card: its confusion matrix
    sums to the held-out split's voxels; the device and the kernel
    launches are the ones the subprocess reports of itself."""
    from featurenet_tpu_torch.data.offline import SegCacheDataset
    from featurenet_tpu_torch.train.checkpoint import load_run_config

    run = _Cli("seg_diagnose", "--checkpoint-dir", ck, "--data-cache", cache,
               module="featurenet_tpu_torch.train.seg_diagnose")
    recs = run.records()
    if len(recs) != 2 or "launches" not in recs[1] or \
            not recs[1]["device"].startswith("cuda"):
        fail(f"seg_diagnose: no device and launches line from the card: {recs[-1:]}")
    rec, child = recs
    cfg = load_run_config(ck)
    test = SegCacheDataset(cache, global_batch=cfg.global_batch, split="test",
                           test_fraction=cfg.test_fraction)
    want = len(test.rows) * cfg.resolution ** 3
    if rec["voxels"] != want or not 0.0 <= rec["mean_iou"] <= 1.0 or \
            len(rec["per_class_iou"]) != 25:
        fail(f"seg_diagnose counted {rec['voxels']} voxels, not {want}: {rec}")
    out = {"report": rec, "test_rows": len(test.rows), "voxels": want,
           "wall_s": run.wall_s, "device": child["device"],
           "subprocess_launches": {"seg_diagnose": child["launches"]},
           "nvidia_smi": smi_line}
    print("seg_diagnose", json.dumps(out), flush=True)
    return out


def seg_stl_line(seed: int, tmp: str, smi_line: str) -> dict:
    """``cli export-stl-data --seg`` and ``cli export-seg-data`` of the same
    seed, then ``cli build-cache`` over the tree at each of
    SEG_STL_WORKERS (a spawn pool beside this process's CUDA context), all
    in this process and on the host: every cache's shards bitwise the
    exported cache's; meshes/s and MB."""
    tree, ref = (os.path.join(tmp, n) for n in ("seg_stl", "seg_stl_ref"))
    exported, export_s = _cli_here("export-stl-data", "--seg", "--out", tree,
                                   "--num-parts", str(SEG_STL_PARTS),
                                   "--seed", str(seed))
    if exported != [{"exported": SEG_STL_PARTS, "kind": "segment_stl"}]:
        fail(f"cli export-stl-data --seg printed {exported}")
    _cli_here("export-seg-data", "--out", ref, "--num-parts",
              str(SEG_STL_PARTS), "--seed", str(seed))
    with open(os.path.join(ref, "index.json")) as fh:
        shards = json.load(fh)["shards"]
    builds = {}
    for w in SEG_STL_WORKERS:
        out_dir = os.path.join(tmp, f"seg_stl_cache_w{w}")
        recs, wall = _cli_here("build-cache", "--stl-root", tree, "--out",
                               out_dir, "--workers", str(w))
        rec = recs[-1]
        with open(os.path.join(out_dir, "index.json")) as fh:
            index = json.load(fh)
        if rec["built"] != SEG_STL_PARTS or rec["kind"] != "segment" or \
                index["shards"] != shards:
            fail(f"cli build-cache (seg, {w} workers) built {rec}, {index}")
        for sh in shards:
            for kind in ("voxels", "seg"):
                name = f"{sh['stem']}.{kind}.npy"
                with open(os.path.join(out_dir, name), "rb") as fa, \
                        open(os.path.join(ref, name), "rb") as fb:
                    same = fa.read() == fb.read()
                if not same:
                    fail(f"seg build-cache ({w} workers): {name} differs from "
                         "export-seg-data's")
        builds[str(w)] = {"seconds": rec["seconds"], "wall_s": wall,
                          "meshes_per_s": SEG_STL_PARTS / rec["seconds"],
                          "cache_mb": _tree_mb(out_dir)}
    out = {"parts": SEG_STL_PARTS, "export_stl_s": export_s,
           "export_stl_parts_per_s": SEG_STL_PARTS / export_s,
           "stl_tree_mb": _tree_mb(tree), "builds": builds,
           "bitwise_export_seg_data": True, "cpu_count": os.cpu_count(),
           "nvidia_smi": smi_line}
    print("seg_stl", json.dumps(out), flush=True)
    return out


def seg_oracle_line(seed: int, smi_line: str) -> dict:
    """``seg_oracle.measure_ceiling`` at seg64's shape over
    SEG_ORACLE_SAMPLES parts (host only, numpy)."""
    from featurenet_tpu_torch.data.seg_oracle import measure_ceiling

    t0 = time.perf_counter()
    got = measure_ceiling(64, 3, samples=SEG_ORACLE_SAMPLES, seed=seed)
    wall = time.perf_counter() - t0
    keys = ("iou_random_pair", "iou_canonical", "iou_extent_guess",
            "iou_overlap_worst", "ambiguous_voxel_fraction")
    if got["samples"] != SEG_ORACLE_SAMPLES or not all(
            0.0 <= got[k] <= 1.0 for k in keys):
        fail(f"seg_oracle: {got}")
    out = {"ceiling": got, "wall_s": wall, "nvidia_smi": smi_line}
    print("seg_oracle", json.dumps(out), flush=True)
    return out


def seg_phase(torch, seed: int, smi_line: str) -> dict:
    """seg64 at full width: ``seg_cache``, ``seg_train``, ``seg_profile``,
    ``seg_eval``, ``seg_serve``, ``seg_affine``, ``seg_cli``, ``seg_ood``,
    ``seg_diagnose``, ``seg_stl`` and ``seg_oracle`` lines. The segmenter
    runs no kernel of the package: every count must stay 0 in each line,
    which holds its in-process runs (the counts are set to 0 before each
    line and read after) and the counts its subprocesses report of
    themselves (``subprocess_launches``: seg_cli's train, eval and infer,
    seg_diagnose)."""
    walls, launches = {}, {}

    def part(name, fn, *a):
        _reset_counts()
        t = time.perf_counter()
        r = fn(*a)
        walls[name] = time.perf_counter() - t
        launches[name] = _read_counts()
        for counts in (r.get("subprocess_launches", {}).values()
                       if isinstance(r, dict) else ()):
            _add_counts(launches[name], counts)
        return r

    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".data")
    os.makedirs(data_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=data_dir) as tmp:
        # The data commands run on the host alone: started with the phase.
        export = _Cli("export-seg-data", "export-seg-data", "--out",
                      os.path.join(tmp, "cli_seg"), "--num-parts",
                      str(SEG_CLI_PARTS), "--seed", str(seed))
        try:
            cache = os.path.join(tmp, "seg64")
            part("seg_cache", seg_cache_line, seed, cache, smi_line)
            train, trainer = part("seg_train", seg_train_line, torch, seed,
                                  cache, smi_line)
            part("seg_profile", seg_profile_line, torch, trainer, smi_line)
            part("seg_eval", seg_eval_line, trainer, smi_line)
            part("seg_serve", seg_serve_line, torch, seed, trainer, tmp, smi_line)
            del trainer
            torch.cuda.empty_cache()
            part("seg_affine", seg_affine_line, torch, seed, cache, train, smi_line)
            torch.cuda.empty_cache()
            part("seg_cli", seg_cli_line, seed, tmp, export, smi_line)
            ck, cli_cache = os.path.join(tmp, "cli_ck"), os.path.join(tmp, "cli_seg")
            part("seg_ood", seg_ood_line, seed, ck, tmp, smi_line)
            torch.cuda.empty_cache()
            part("seg_diagnose", seg_diagnose_line, ck, cli_cache, smi_line)
            part("seg_stl", seg_stl_line, seed, tmp, smi_line)
            part("seg_oracle", seg_oracle_line, seed, smi_line)
        finally:
            if export.proc.poll() is None:
                export.proc.kill()
                export.proc.communicate()
    counts = {k: sum(line.get(k, 0) for line in launches.values())
              for line in launches.values() for k in line}
    if any(counts.values()):
        fail(f"seg: the segmenter launched kernels of the package: {launches}")
    print("seg", json.dumps({"walls_s": walls, "launches": counts,
                             "launches_by_line": launches}), flush=True)
    return {"launches": counts}


# The wire phase: the packed programs' batches, the stream's frames and the
# loadgen's requests; the load generator's offered rate is
# BENCH_LOAD_FRACTION of the closed-loop rate measured here (the packed fp32
# program at batch 256, the reference benchmark's serving number).
WIRE_PARTS = 256
WIRE_BATCHES = (256, 1)
WIRE_STREAM_FRAMES = 256
WIRE_LOAD_REQUESTS = 512
WIRE_SLO_P99_MS = 250.0


def _gap(torch, pred, grid) -> float:
    """The top-2 logit gap of one part under ``pred``'s live generation."""
    from featurenet_tpu_torch.runtime import forward_with

    with torch.inference_mode():
        x = torch.from_numpy(grid[None, ..., None]).cuda()
        logits = forward_with(pred.model, pred._dispatch_params(), x).float()
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


def _h2d_ms(torch, host) -> float:
    """Device ms of copying ``host`` (a pageable tensor) to the card."""
    dev = torch.empty_like(host, device="cuda")
    return time_ms(torch, lambda: dev.copy_(host))


def wire_programs_line(proc, smi_line: str) -> dict:
    """``cli programs --config sprint64 --warm`` on the card: every catalog
    row, and each applicable program built (serve* at the buckets,
    serve_packed* at batch 256, each capturing 3 conv3d_fwd per graph) or
    skipped with its reason."""
    recs = proc.records()
    rows = [r for r in recs if "program" in r]
    warm = next((r["warmup"] for r in recs if "warmup" in r), None)
    if warm is None or len(rows) != 11:
        fail(f"cli programs printed {recs}")
    applicable = [r["program"] for r in rows if r["applicable"]]
    if sorted(warm) != sorted(applicable):
        fail(f"cli programs --warm built {sorted(warm)}, not {applicable}")
    want3 = dict(_want_counts("xla", 0, 0), conv3d_fwd=3)
    for name, rec in warm.items():
        if "skipped" in rec:
            continue
        per_graph = {k: v * len(rec["batches"]) for k, v in want3.items()}
        if rec["source"] != "capture" or rec["capture_launches"] != per_graph:
            fail(f"cli programs --warm {name}: {rec}, want {per_graph} captured")
        if name.startswith("serve_packed") and rec["batches"] != [256]:
            fail(f"cli programs --warm {name} at {rec['batches']}, not [256]")
    out = {"wall_s": proc.wall_s, "rows": rows, "warmup": warm,
           "nvidia_smi": smi_line}
    print("programs", json.dumps(out), flush=True)
    return out


def wire_serve_packed_line(torch, seed: int, grids, smi_line: str) -> dict:
    """Per precision, the sprint64 packed program at batches 256 and 1 on
    the phase's parts: labels against the argmax of the same precision's
    serve program on the unpacked grids (bitwise at fp32; at bf16 and int8
    a differing row is printed with its top-2 logit gap), device ms per
    replay of both (CUDA events, the batch already on the card), the host
    to device copy of the batch packed and as float32 (bytes and device
    ms), and 3 conv3d_fwd_kernel device events per replay."""
    import numpy as np

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import pack_voxels
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS

    cfg = get_config("sprint64")
    packed_host = torch.from_numpy(pack_voxels(grids))
    float_host = torch.from_numpy(np.ascontiguousarray(grids[..., None]))
    copies = {b: {"packed_bytes": packed_host[:b].nbytes,
                  "float32_bytes": float_host[:b].nbytes,
                  "packed_h2d_ms": _h2d_ms(torch, packed_host[:b]),
                  "float32_h2d_ms": _h2d_ms(torch, float_host[:b])}
              for b in WIRE_BATCHES}
    packed_dev, float_dev = packed_host.cuda(), float_host.cuda()
    want3 = dict(_want_counts("xla", 0, 0), conv3d_fwd=3)
    out = {}
    for precision in SERVE_PRECISIONS:
        torch.cuda.empty_cache()
        pred = Predictor.from_seed(cfg, seed, batch=max(WIRE_BATCHES),
                                   device="cuda", precision=precision)
        rows = {}
        for b in WIRE_BATCHES:
            prog = pred.packed_program_for(b)
            if prog.graph is None or prog.capture_launches != want3:
                fail(f"serve_packed {precision} b{b} captured {prog.capture_launches}")
            serve = pred.program_for(b)
            labels = prog(packed_host[:b]).cpu().numpy()
            want = serve(float_host[:b]).argmax(-1).cpu().numpy()
            diff = np.flatnonzero(labels != want)
            differing = [{"row": int(i), "packed": int(labels[i]), "serve": int(want[i]),
                          "top2_logit_gap": _gap(torch, pred, grids[i])}
                         for i in diff]
            if precision == "fp32" and differing:
                fail(f"serve_packed fp32 b{b} labels differ from serve's argmax: "
                     f"{differing}")
            events = [c["conv3d_fwd_kernel"] for c in graph_launch_events(
                torch, [functools.partial(prog, packed_dev[:b])] * REPLAY_PROFILE_REPS,
                ("conv3d_fwd_kernel",))]
            if events != [3] * REPLAY_PROFILE_REPS:
                fail(f"serve_packed {precision} b{b}: conv3d_fwd_kernel events "
                     f"per replay {events}")
            rows[b] = {"packed_ms": time_ms(torch, lambda: prog(packed_dev[:b])),
                       "serve_ms": time_ms(torch, lambda: serve(float_dev[:b])),
                       "labels_equal_serve_argmax": not differing,
                       "differing_rows": differing,
                       "capture_s": prog.capture_s,
                       "conv3d_fwd_kernel_events_per_replay": 3,
                       **copies[b]}
        out[precision] = rows
        del pred, prog, serve
    print("serve_packed", json.dumps({**out, "nvidia_smi": smi_line}), flush=True)
    return out


def _metric(text: str, line_prefix: str):
    for line in text.splitlines():
        if line.startswith(line_prefix + " "):
            return float(line.rsplit(" ", 1)[1])
    return None


def wire_stream_line(torch, seed: int, grids, serve, run_dir: str,
                     smi_line: str) -> dict:
    """``serve`` (``cli serve --config sprint64 --seed S --port 0 --run-dir
    D --slo-p99-ms 250``, started with the phase): WIRE_STREAM_FRAMES parts
    through ``stream_load`` over one keep-alive socket, each label the
    in-process Predictor's on the same seed; a torn frame answered 400
    ``bad_stream``; GET /metrics before and after counting the frames
    served and carrying the serving p99; SIGTERM draining with exit 0; and
    ``D/events.jsonl`` holding serve_start, serve_batch and serve_stop."""
    import struct

    import numpy as np

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.loadgen import stream_load

    banner = json.loads(serve.stdout.readline())["serving"]
    port = banner["port"]
    served = 'featurenet_requests_total{outcome="served"}'
    before = _get_text(port, "/metrics")
    frames = grids[:WIRE_STREAM_FRAMES]
    out = stream_load("127.0.0.1", port, frames, trace_id=f"wire{seed}")
    after = _get_text(port, "/metrics")
    pred = Predictor.from_seed(get_config("sprint64"), seed, batch=64, device="cuda")
    want, probs = pred.predict_voxels(frames)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    near_tie = top2[:, 1] - top2[:, 0] < 1e-6
    got = np.array([ln.get("label", -1) for ln in out["lines"]])
    traces = [ln.get("trace") for ln in out["lines"]]
    if out["status"] != 200 or out["answered"] != len(frames) or \
            traces != [f"wire{seed}.{i}" for i in range(len(frames))]:
        fail(f"stream: status {out['status']}, answered {out['answered']}, "
             f"lines {out['lines'][:3]}")
    wrong = np.flatnonzero((got != want) & ~near_tie)
    if wrong.size:
        fail(f"stream: frames {wrong.tolist()} answered {got[wrong].tolist()}, "
             f"the Predictor {want[wrong].tolist()}")
    want_bytes = 64 ** 3 * 4
    torn_body = struct.pack("<I", want_bytes) + frames[0].astype("<f4").tobytes()[:100]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    status, torn, _ = _post(conn, "/predict_voxels_stream", torn_body)
    conn.close()
    if status != 400 or torn.get("error") != "bad_stream":
        fail(f"stream: a torn frame answered {status}: {torn}")
    counted = (_metric(after, served) or 0) - (_metric(before, served) or 0)
    p99 = _metric(after, 'featurenet_serving_ms{q="0.99"}')
    if counted != len(frames) or p99 is None:
        fail(f"stream: /metrics counted {counted} served, serving p99 {p99}")
    serve.send_signal(signal.SIGTERM)
    rest, err = serve.communicate(timeout=120)
    stats = [json.loads(ln)["serve_stats"] for ln in rest.splitlines()
             if ln.startswith('{"serve_stats"')]
    if serve.returncode != 0 or not stats:
        fail(f"stream: cli serve exited {serve.returncode}: {err[-2000:]}")
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        kinds = {json.loads(ln)["ev"] for ln in fh}
    if not {"serve_start", "serve_batch", "serve_stop"} <= kinds:
        fail(f"stream: events.jsonl holds {sorted(kinds)}")
    res = {"frames": len(frames), "wall_s": out["wall_s"],
           "frames_per_sec": out["frames_per_sec"], "reconnects": out["reconnects"],
           "labels_equal_predictor": True, "near_ties": int(near_tie.sum()),
           "torn_frame": {"status": status, "error": torn["error"]},
           "metrics_served_delta": counted, "metrics_serving_p99_ms": p99,
           "drain": {k: stats[-1][k] for k in ("served", "batches", "occupancy",
                                              "by_bucket", "active_serving_alerts",
                                              "exit_code")},
           "exit_code": serve.returncode, "event_kinds": sorted(kinds),
           "nvidia_smi": smi_line}
    print("stream", json.dumps(res), flush=True)
    return res


def _get_text(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode("utf-8")
    finally:
        conn.close()


def wire_loadgen_line(torch, seed: int, packed_per_s: float,
                      smi_line: str) -> dict:
    """``measure_trace_overhead``'s percentage on sprint64 on the card, then
    ``bench_serving`` at BENCH_LOAD_FRACTION (capped at BENCH_QPS_CAP) of
    two closed-loop rates: the fp32 serve_packed rate at batch 256 (the
    reference benchmark's basis) and the float32 request path's rate that
    the trace probe measured with its sampler off."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.serve.loadgen import (
        BENCH_LOAD_FRACTION,
        BENCH_QPS_CAP,
        bench_serving,
        measure_trace_overhead,
    )

    cfg = get_config("sprint64")
    trace = measure_trace_overhead(cfg, device="cuda")
    rows = {}
    for basis, rate in (("serve_packed_b256", packed_per_s),
                        ("float32_requests", trace["trace_dark_qps"])):
        qps = min(BENCH_QPS_CAP, BENCH_LOAD_FRACTION * rate)
        row = bench_serving(cfg, qps=qps, n_requests=WIRE_LOAD_REQUESTS,
                            device="cuda")
        if row["serve_qps_sustained"] is None or row["serve_p99_ms"] is None:
            fail(f"loadgen ({basis}): {row}")
        rows[basis] = {"closed_loop_per_s": rate, **row}
    out = {"load_fraction": BENCH_LOAD_FRACTION, **rows, **trace,
           "nvidia_smi": smi_line}
    print("loadgen", json.dumps(out), flush=True)
    return out


def wire_phase(torch, seed: int, smi_line: str) -> dict:
    """The serving wire at sprint64 full width: `programs`, `serve_packed`,
    `stream` and `loadgen` lines. ``cli programs --warm`` and ``cli serve``
    start with the phase as subprocesses (their warmups overlap) and are
    done before the in-process lines time anything. The launches counted
    are this process's (the packed programs' and the loadgen services'
    captures and eager warmups; replays launch none)."""
    import numpy as np

    from featurenet_tpu_torch.data.synthetic import generate_batch

    _reset_counts()
    walls = {}
    grids = generate_batch(np.random.default_rng(seed + 7), WIRE_PARTS,
                           64)["voxels"][..., 0].astype("<f4")
    with tempfile.TemporaryDirectory() as tmp:
        run_dir = os.path.join(tmp, "run")
        programs = _Cli("programs", "programs", "--config", "sprint64", "--warm")
        # A queue bound above the stream's frames: the stream submits them
        # all before the first batch returns.
        serve = subprocess.Popen(
            [sys.executable, "-m", "featurenet_tpu_torch.cli", "serve",
             "--config", "sprint64", "--seed", str(seed), "--port", "0",
             "--run-dir", run_dir, "--slo-p99-ms", str(WIRE_SLO_P99_MS),
             "--queue-limit", str(WIRE_STREAM_FRAMES)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            t = time.perf_counter()
            wire_programs_line(programs, smi_line)
            walls["programs"] = time.perf_counter() - t
            t = time.perf_counter()
            wire_stream_line(torch, seed, grids, serve, run_dir, smi_line)
            walls["stream"] = time.perf_counter() - t
        finally:
            for proc in (programs.proc, serve):
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    packed = wire_serve_packed_line(torch, seed, grids, smi_line)
    walls["serve_packed"] = time.perf_counter() - t
    t = time.perf_counter()
    rate = 256 / packed["fp32"][256]["packed_ms"] * 1e3
    wire_loadgen_line(torch, seed, rate, smi_line)
    walls["loadgen"] = time.perf_counter() - t
    counts = _read_counts()
    if counts["conv3d_fwd"] < 1 or any(v for k, v in counts.items()
                                       if k != "conv3d_fwd"):
        fail(f"wire: launches {counts}")
    print("wire", json.dumps({"walls_s": walls, "launches": counts}), flush=True)
    return {"launches": counts}

# The report phase: one supervised sprint64 run from the cache phase's
# cache, two segments of REPORT_SEGMENT steps, its steps
# [REPORT_PROFILE_START, +REPORT_PROFILE_STEPS) traced; then the dark cost
# of the run directory, REPORT_COST_STEPS resident steps per turn.
REPORT_STEPS = 40
REPORT_SEGMENT = 20
REPORT_PROFILE_START = 25
REPORT_PROFILE_STEPS = 3
REPORT_COST_STEPS = 30
REPORT_COST_TURNS = 2
# The device events of one eager pallas train step, by kernel name (a
# substring of the symbol).
STEP_EVENTS = {"conv3d_fwd_kernel": 6, "conv3d_dw_partial": 3}


def _report_cli(*args) -> subprocess.CompletedProcess:
    """``cli report`` in a process where torch cannot be imported: the
    report path needs the standard library alone."""
    code = ("import sys; sys.modules['torch'] = None\n"
            "from featurenet_tpu_torch import cli\n"
            f"sys.exit(cli.main({list(args)!r}))\n")
    return subprocess.run([sys.executable, "-c", code],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=300)


def _step_kernel_events(trace: dict) -> dict[int, dict[str, int]]:
    """Per traced step of a Trainer's torch.profiler trace (its
    ``train_dispatch@<step>`` ranges): the device events whose launch
    (matched by correlation id) lies inside the step's range, by
    STEP_EVENTS name. The backward's launches come from autograd's device
    thread while the range's thread waits in ``backward()``, so a launch
    is matched to a range by time, on any thread."""
    evs = trace["traceEvents"]
    ranges = [(int(e["name"].split("@")[1]), e["ts"], e["ts"] + e["dur"])
              for e in evs if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("train_dispatch@")]
    launch_step = {}
    for e in evs:
        if e.get("cat") != "cuda_runtime":
            continue
        for step, t0, t1 in ranges:
            if t0 <= e["ts"] <= t1:
                launch_step[(e.get("args") or {}).get("correlation")] = step
    per = {step: dict.fromkeys(STEP_EVENTS, 0) for step, *_ in ranges}
    for e in evs:
        if e.get("cat") != "kernel":
            continue
        step = launch_step.get((e.get("args") or {}).get("correlation"))
        if step is None:
            continue
        for n in STEP_EVENTS:
            per[step][n] += int(n in e["name"])
    return dict(sorted(per.items()))


def _segment_reports(run: str) -> list[dict]:
    """The report of each child's lines alone: the events from one
    supervisor ``spawn`` to the next. Segment 1 runs without the trace
    window, so its breakdown is that of an unprofiled run; segment 2's
    holds the window. Beside it, the first ``dispatch`` span (the
    process's cold first step) against the median of the others."""
    from featurenet_tpu_torch.obs import report as obs_report

    events, _ = obs_report.load_events(run)
    cuts = [e["t"] for e in events
            if e.get("ev") == "supervisor" and e.get("phase") == "spawn"]
    out = []
    for i, t0 in enumerate(cuts):
        t1 = cuts[i + 1] if i + 1 < len(cuts) else math.inf
        seg = [e for e in events if t0 <= e["t"] < t1]
        rep = obs_report.build_report(seg)
        loop = rep.get("loop") or {}
        dispatch = [e["dur_s"] * 1e3 for e in seg if e.get("ev") == "span"
                    and e.get("name") == "dispatch"]
        out.append({
            "steps": loop.get("steps"), "wall_s": loop.get("wall_s"),
            "step_ms": loop.get("step_ms"),
            "breakdown_s": {k: v["seconds"]
                            for k, v in (rep.get("breakdown") or {}).items()},
            "attributed_fraction": rep.get("attributed_fraction"),
            "first_dispatch_ms": dispatch[0] if dispatch else None,
            "median_dispatch_ms": (statistics.median(dispatch[1:])
                                   if len(dispatch) > 1 else None),
        })
    return out


def _report_perf(rep: dict, kind: str, program: str, what: str) -> dict:
    """The perf section of a report: ``program``'s row with its flops and
    peak_bytes, the card's name at the known tier, an mfu p50 in (0, 1),
    and each device_memory watermark within the card's limit."""
    perf = rep.get("perf") or {}
    row = (perf.get("programs") or {}).get(program) or {}
    mfu = perf.get("mfu") or {}
    # A serving program's peak_bytes is the rise of the process's peak
    # across its capture: 0 when a larger bucket captured first set it
    # (quality_serve_line checks the largest bucket's).
    if not (row.get("flops") and isinstance(row.get("peak_bytes"), (int, float))):
        fail(f"{what}: perf program {program!r} lacks flops or peak_bytes: "
             f"{perf.get('programs')}")
    if perf.get("device_kind") != kind or perf.get("tier") != "known":
        fail(f"{what}: perf device {perf.get('device_kind')!r} tier "
             f"{perf.get('tier')!r}, not {kind!r} known")
    if not (mfu.get("p50") is not None and 0.0 < mfu["p50"] < 1.0):
        fail(f"{what}: mfu window {mfu}, not a p50 in (0, 1)")
    for dev, mem in (perf.get("device_memory") or {}).items():
        if not mem.get("bytes_limit") or mem["watermark_bytes"] > mem["bytes_limit"]:
            fail(f"{what}: device {dev} memory {mem}")
    return perf


def report_run_line(seed: int, cache: str, tmp: str, smi_line: str,
                    kind: str) -> dict:
    """``cli train --supervise --run-dir D --profile-dir P
    --poll-device-memory`` on sprint64 (pallas, resident from ``cache``)
    for REPORT_STEPS steps in two segments, then ``cli report D`` (--json
    with its perf section, --validate, --trace, --gate) in processes
    without torch, and the kernels of P's trace per step."""
    ck, run, prof, trace_out = (os.path.join(tmp, n) for n in
                                ("ck", "run", "prof", "trace.json"))
    t0 = time.perf_counter()
    train = subprocess.run(
        _cli("train", "--config", "sprint64", "--conv-backend", "pallas",
             "--seed", str(seed), "--data-cache", cache, "--hbm-cache",
             "--supervise", "--restart-every", str(REPORT_SEGMENT),
             "--total-steps", str(REPORT_STEPS), "--checkpoint-every",
             str(REPORT_SEGMENT), "--checkpoint-dir", ck, "--run-dir", run,
             "--profile-dir", prof, "--profile-start", str(REPORT_PROFILE_START),
             "--profile-steps", str(REPORT_PROFILE_STEPS),
             "--poll-device-memory"),
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    train_s = time.perf_counter() - t0
    if train.returncode != 0:
        fail(f"report: supervised cli train exited {train.returncode}: "
             f"{train.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in train.stdout.splitlines()
             if ln.startswith("{")]
    launches = [r["launches"] for r in lines if "launches" in r]
    sup = [r["supervisor"] for r in lines if "supervisor" in r]
    if len(launches) != 2 or sup.count("spawn") != 2 or sup[-1] != "done":
        fail(f"report: the supervised run did not run two children to the end: "
             f"supervisor {sup}, {len(launches)} launch reports")

    t0 = time.perf_counter()
    got = _report_cli("report", run, "--json")
    if got.returncode != 0:
        fail(f"report: cli report --json exited {got.returncode}: {got.stderr[-2000:]}")
    rep = json.loads(got.stdout)
    sv = rep.get("supervisor") or {}
    hb = rep.get("heartbeat") or {}
    if (rep["loop"]["steps"] != REPORT_STEPS or rep["process_starts"] != 2
            or sv.get("planned_restarts") != 1 or sv.get("restarts") != 0
            or not hb.get("beats") or rep.get("attributed_fraction") is None):
        fail(f"report: the report is not that of the run: loop {rep.get('loop')}, "
             f"process_starts {rep.get('process_starts')}, supervisor {sv}, "
             f"heartbeat {hb}")
    validate = _report_cli("report", run, "--validate")
    if validate.returncode != 0 or '"validate": "ok"' not in validate.stdout:
        fail(f"report --validate: {validate.stdout[-2000:]} {validate.stderr[-2000:]}")
    traced = _report_cli("report", run, "--trace", trace_out)
    if traced.returncode != 0:
        fail(f"report --trace exited {traced.returncode}: {traced.stderr[-2000:]}")
    with open(trace_out) as fh:
        chrome = json.load(fh)["traceEvents"]
    span_tracks = {e["pid"] for e in chrome if e.get("ph") == "X"}
    if len(span_tracks) < 2:
        fail(f"report --trace: spans on {len(span_tracks)} process track(s), "
             "not both children's")
    gate = _report_cli("report", run, "--gate",
                       os.path.join(run, "gate_baseline.json"))
    with open(os.path.join(run, "events.jsonl")) as fh:
        phases = [e.get("phase") for e in map(json.loads, fh)
                  if e.get("ev") == "supervisor"]
    if gate.returncode not in (0, 2) or (
            gate.returncode == 2 and "gate_regression" not in phases):
        fail(f"report --gate exited {gate.returncode} (supervisor phases "
             f"{phases}): {gate.stdout[-2000:]} {gate.stderr[-2000:]}")
    perf = _report_perf(rep, kind, "hbm_train_step", "report")
    if not perf.get("device_memory"):
        fail(f"report: --poll-device-memory recorded no device_memory: {perf}")
    from featurenet_tpu_torch.obs import gates as obs_gates

    gate_vals = obs_gates.report_gate_values(rep)
    pinned = {k: gate_vals.get(k) for k in ("mfu", "hbm_peak_train_bytes")}
    if None in pinned.values():
        fail(f"report: gate values lack the perf keys: {gate_vals}")
    perf_base = os.path.join(tmp, "perf_baseline.json")
    with open(perf_base, "w") as fh:
        json.dump(obs_gates.make_baseline(pinned), fh)
    perf_gate = _report_cli("report", run, "--gate", perf_base)
    if perf_gate.returncode != 0:
        fail(f"report --gate on its own perf pins exited "
             f"{perf_gate.returncode}: {perf_gate.stdout[-2000:]}")
    report_s = time.perf_counter() - t0
    segments = _segment_reports(run)
    if ([g["steps"] for g in segments] != [REPORT_SEGMENT] * 2
            or any(g["attributed_fraction"] is None for g in segments)):
        fail(f"report: the segments' own reports are not two of "
             f"{REPORT_SEGMENT} steps: {segments}")

    files = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    if len(files) != 1:
        fail(f"report: the profile directory holds {files}, not one trace")
    with open(os.path.join(prof, files[0])) as fh:
        per_step = _step_kernel_events(json.load(fh))
    want_steps = list(range(REPORT_PROFILE_START,
                            REPORT_PROFILE_START + REPORT_PROFILE_STEPS))
    if list(per_step) != want_steps:
        fail(f"report: the trace holds steps {list(per_step)}, not {want_steps}")
    # The profiler may lose device events at its window's edges (the
    # PROFILE_PAD_S note): the middle step is held exact.
    middle = want_steps[len(want_steps) // 2]
    if per_step[middle] != STEP_EVENTS:
        fail(f"report: traced step {middle} ran {per_step[middle]}, not "
             f"{STEP_EVENTS}")
    return {
        "train_s": train_s, "report_s": report_s,
        "supervisor": sup, "loop": rep["loop"],
        "process_starts": rep["process_starts"],
        "planned_restarts": sv["planned_restarts"],
        "heartbeat": hb, "breakdown": rep.get("breakdown"),
        "attributed_fraction": rep["attributed_fraction"],
        "segments": segments,
        "slo_windows": (rep.get("slo") or {}).get("windows"),
        "prefetch_queue_depth": rep.get("prefetch_queue_depth"),
        "validate": json.loads(validate.stdout.strip().splitlines()[-1]),
        "trace_span_tracks": len(span_tracks),
        "trace_events": len(chrome),
        "gate_exit": gate.returncode, "gate": gate.stdout.strip().splitlines(),
        "perf": perf, "perf_gate": perf_gate.stdout.strip().splitlines(),
        "profile_file": files[0], "kernel_events_per_step": per_step,
        "launches_per_child": launches, "nvidia_smi": smi_line,
    }, launches


def report_cost_line(torch, seed: int, cache: str, tmp: str,
                     smi_line: str) -> dict:
    """The run directory's cost on the loop: one resident sprint64 pallas
    Trainer takes REPORT_COST_STEPS steps per turn, dark and with a run
    directory in turns, REPORT_COST_TURNS times each; device ms per step
    from CUDA events around each turn (its end-of-run eval left out), and
    the events, spans among them, emitted per step."""
    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.obs import events as obs_events
    from featurenet_tpu_torch.train.loop import Trainer

    if obs.active():
        fail("report: a run directory is still open before the dark turns")
    import dataclasses

    cfg = get_config("sprint64", seed=seed, data_cache=cache, hbm_cache=True)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend="pallas"))
    with open(os.devnull, "w") as sink:
        trainer = Trainer(cfg, device="cuda", stream=sink)
        trainer.evaluate = lambda: {}  # the turn's end is not an eval pass
        trainer.run(num_steps=REPORT_COST_STEPS)  # warm: kernels, allocator
        torch.cuda.synchronize()
        turns = {"dark": [], "run_dir": []}
        per_step = {}
        for turn in range(REPORT_COST_TURNS):
            for mode in ("dark", "run_dir"):
                if mode == "run_dir":
                    obs.init_run(os.path.join(tmp, f"cost_{turn}"),
                                 process_index=0)
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                start.record()
                trainer.run(num_steps=trainer.state.step + REPORT_COST_STEPS)
                end.record()
                end.synchronize()
                turns[mode].append(start.elapsed_time(end) / REPORT_COST_STEPS)
                if mode == "run_dir":
                    kinds = obs_events.kind_counts()
                    obs.close_run()
                    per_step = {k: v / REPORT_COST_STEPS for k, v in kinds.items()}
    dark, lit = statistics.median(turns["dark"]), statistics.median(turns["run_dir"])
    return {"ms_per_step": turns, "median_dark_ms": dark,
            "median_run_dir_ms": lit,
            "run_dir_overhead_pct": (lit - dark) / dark * 100.0,
            "events_per_step": per_step, "spans_per_step": per_step.get("span"),
            "nvidia_smi": smi_line}


def report_phase(torch, seed: int, cache: str, tmp: str, smi_line: str) -> dict:
    """The Trainer's run directory on the card (`report_run`,
    `report_cost` lines) in ``tmp``, where the run's checkpoint stays for
    the `quality` phase; the launches are those the supervised children
    reported, the `report` path."""
    launches: dict[str, int] = {}
    t0 = time.perf_counter()
    out, reported = report_run_line(seed, cache, tmp, smi_line,
                                    torch.cuda.get_device_name(0))
    out["phase_s"] = time.perf_counter() - t0
    print("report_run", json.dumps(out), flush=True)
    for counts in reported:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    t0 = time.perf_counter()
    cost = report_cost_line(torch, seed, cache, tmp, smi_line)
    cost["phase_s"] = time.perf_counter() - t0
    print("report_cost", json.dumps(cost), flush=True)
    torch.cuda.empty_cache()
    if not (launches.get("conv3d_fwd") and launches.get("conv3d_dw")):
        fail(f"report: the supervised children reported no kernel launches: "
             f"{launches}")
    return {"launches": launches, "checkpoint": os.path.join(tmp, "ck")}


# The quality phase: a pinned baseline of QUALITY_PARTS parts, as many
# requests served in concurrent waves of the bucket sizes, four replay
# candidates, and the quality tax over QUALITY_OVERHEAD_REQUESTS requests in
# QUALITY_OVERHEAD_TURNS turns.
QUALITY_PARTS = 512
QUALITY_WAVES = (1, 4, 16, 64)
QUALITY_OVERHEAD_REQUESTS = 192
QUALITY_OVERHEAD_TURNS = 3
QUALITY_MIN_AGREEMENT = 0.967
QUALITY_CANDIDATES = {"identity": (), "bf16": ("--precision", "bf16"),
                      "int8": ("--precision", "int8"),
                      "xla": ("--conv-backend", "xla")}


def _cli_records(what: str, *args, ok=(0,)) -> tuple[int, list[dict], float]:
    """One ``cli`` subprocess on the card, run to its end: its exit code
    (one of ``ok``, else the script fails), its JSON lines and its wall."""
    t0 = time.perf_counter()
    proc = subprocess.run(_cli(*args), cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode not in ok:
        fail(f"{what}: cli {args[0]} exited {proc.returncode}: "
             f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")
    return (proc.returncode, [json.loads(ln) for ln in proc.stdout.splitlines()
                              if ln.startswith("{")], wall)


def _add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _serve_waves(port: int, grids) -> tuple[list[dict], float]:
    """POST /predict_voxels of every grid, in concurrent waves of
    QUALITY_WAVES' sizes in turn (each wave answered before the next),
    one keep-alive connection per client thread; every answer a 200 with
    a label."""
    import concurrent.futures

    local = threading.local()
    conns = []

    def post(i):
        conn = getattr(local, "conn", None)
        if conn is None:
            conn = local.conn = http.client.HTTPConnection("127.0.0.1", port,
                                                           timeout=120)
            conns.append(conn)
        status, body, _ = _post(conn, "/predict_voxels", grids[i].tobytes())
        if status != 200 or "label" not in body:
            raise RuntimeError(f"request {i}: {status} {body}")
        return body

    answers: list[dict] = []
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max(QUALITY_WAVES)) as pool:
        i, w = 0, 0
        while i < len(grids):
            k = min(QUALITY_WAVES[w % len(QUALITY_WAVES)], len(grids) - i)
            answers += list(pool.map(post, range(i, i + k)))
            i, w = i + k, w + 1
    wall = time.perf_counter() - t0
    for conn in conns:
        conn.close()
    return answers, wall


def quality_serve_line(seed: int, ck: str, baseline: str, tmp: str,
                       kind: str, smi_line: str) -> tuple[dict, dict]:
    """``cli serve --quality --quality-baseline --capture`` on the
    checkpoint, QUALITY_PARTS requests in waves, a drain, then ``cli
    report`` (--validate, --json) without torch."""
    import numpy as np

    from featurenet_tpu_torch.data.synthetic import generate_batch

    run = os.path.join(tmp, "serve_run")
    grids = np.ascontiguousarray(generate_batch(
        np.random.default_rng(seed + 11), QUALITY_PARTS, 64)["voxels"][..., 0],
        dtype="<f4")
    t0 = time.perf_counter()
    srv = subprocess.Popen(
        _cli("serve", "--checkpoint-dir", ck, "--run-dir", run, "--quality",
             "--quality-baseline", baseline, "--capture", "--port", "0",
             "--duration-s", "600"),
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        banner = json.loads(srv.stdout.readline())["serving"]
        ready_s = time.perf_counter() - t0
        try:
            answers, wall = _serve_waves(banner["port"], grids)
        except RuntimeError as e:
            fail(f"quality: cli serve {e}")
        srv.send_signal(signal.SIGTERM)
        out, err = srv.communicate(timeout=120)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.communicate()
    if srv.returncode != 0:
        fail(f"quality: cli serve exited {srv.returncode}: {err[-2000:]}")
    stats = json.loads(out.strip().splitlines()[-1])["serve_stats"]
    cap, qual = stats.get("capture") or {}, stats.get("quality") or {}
    if (stats["served"] != QUALITY_PARTS or not cap.get("captured")
            or qual.get("seen") != QUALITY_PARTS or not qual.get("baseline")):
        fail(f"quality: cli serve stats {stats}")
    validate = _report_cli("report", run, "--validate")
    if validate.returncode != 0 or '"validate": "ok"' not in validate.stdout:
        fail(f"quality: report --validate {validate.stdout[-2000:]}")
    got = _report_cli("report", run, "--json")
    if got.returncode != 0:
        fail(f"quality: report --json exited {got.returncode}: {got.stderr[-2000:]}")
    rep = json.loads(got.stdout)
    perf = _report_perf(rep, kind, "serve", "quality")
    with open(os.path.join(run, "events.jsonl")) as fh:
        costs = [e for e in map(json.loads, fh) if e.get("ev") == "program_cost"]
    # A serving peak_bytes is the rise of the process's peak across a
    # capture, so the report's last "serve" row (bucket 1) may read 0; the
    # largest bucket, captured first, must raise it.
    first = max(costs, key=lambda e: e.get("batch") or 0, default={})
    if not (first.get("peak_bytes") or 0) > 0:
        fail(f"quality: the largest bucket's program_cost has no peak_bytes: {costs}")
    quality = rep.get("quality") or {}
    if not all(quality.get(k) for k in ("confidence", "margin", "entropy",
                                         "drift_score", "drift", "captures")):
        fail(f"quality: the report's quality section lacks a field: {quality}")
    return {
        "ready_s": ready_s, "requests_wall_s": wall,
        "requests_per_s": QUALITY_PARTS / wall,
        "labels": len({a["label"] for a in answers}),
        "by_bucket": stats["by_bucket"], "occupancy": stats["occupancy"],
        "capture": cap, "tracker": qual,
        "serve_programs": {k: v for k, v in perf["programs"].items()
                           if k.startswith("serve")},
        "program_cost_by_batch": {e.get("batch"): {
            k: e.get(k) for k in ("flops", "peak_bytes", "precision")}
            for e in costs},
        "serving_mfu": perf["mfu"], "device_kind": perf["device_kind"],
        "windows": {k: quality[k] for k in ("confidence", "margin", "entropy",
                                            "drift_score")},
        "drift": quality["drift"], "captures": quality["captures"],
        "validate": json.loads(validate.stdout.strip().splitlines()[-1]),
        "nvidia_smi": smi_line,
    }, {"launches": stats.get("launches") or {}, "capture": cap["dir"]}


def _flip_top2(torch, ck: str, capture: str) -> list[dict]:
    """The identity candidate's flips scored again here: each flipped
    request's recorded label and confidence beside the two top
    probabilities now (near-uniform rows can tie)."""
    import numpy as np

    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.recorder import read_captures, unpack_grid

    recs = [r for r in read_captures(capture) if r.get("label") is not None]
    pred = Predictor.from_checkpoint(ck, batch=32)
    labels, probs = pred.predict_voxels(
        np.stack([unpack_grid(r["voxels"]) for r in recs]))
    out = []
    for r, lab, pr in zip(recs, labels.tolist(), probs):
        if lab != r["label"]:
            top = np.argsort(pr)[::-1][:2]
            out.append({"trace": r.get("trace"), "recorded": r["label"],
                        "recorded_confidence": r.get("confidence"),
                        "label": lab, "top2": [[int(i), float(pr[i])] for i in top]})
    del pred
    torch.cuda.empty_cache()
    return out


def quality_replay_line(torch, ck: str, capture: str, tmp: str,
                        smi_line: str) -> tuple[dict, dict]:
    """``cli replay`` of the ring for each QUALITY_CANDIDATES candidate:
    no graph captured while scoring; the identity candidate at or above
    QUALITY_MIN_AGREEMENT (its run directory validated); the others'
    verdicts printed."""
    launches: dict[str, int] = {}
    out: dict = {}
    for name, extra in QUALITY_CANDIDATES.items():
        run = os.path.join(tmp, f"replay_{name}")
        rc, recs, wall = _cli_records(
            f"quality replay {name}", "replay", capture, "--checkpoint-dir", ck,
            "--run-dir", run, *extra, ok=(0,) if name == "identity" else (0, 2))
        r = next((x["replay"] for x in recs if "replay" in x), None)
        if r is None or r["post_warmup_compiles"] != 0:
            fail(f"quality: replay {name} captured while scoring: {recs}")
        _add_counts(launches, r.get("launches") or {})
        out[name] = {"exit": rc, "wall_s": wall, **{k: r[k] for k in (
            "n", "agreement", "ok", "flips", "confidence_delta", "score_ms",
            "per_request_ms", "post_warmup_compiles")},
            "candidate": r["candidate"]}
    ident = out["identity"]
    if ident["agreement"] < QUALITY_MIN_AGREEMENT:
        fail(f"quality: identity replay agreement {ident['agreement']} < "
             f"{QUALITY_MIN_AGREEMENT}: {ident}")
    if ident["flips"]:
        ident["flipped"] = _flip_top2(torch, ck, capture)
    validate = _report_cli("report", os.path.join(tmp, "replay_identity"),
                           "--validate")
    if validate.returncode != 0:
        fail(f"quality: report --validate of the replay run: {validate.stdout[-2000:]}")
    out["nvidia_smi"] = smi_line
    return out, launches


def quality_phase(torch, seed: int, ck: str, smi_line: str) -> dict:
    """The model-quality plane on the card (`quality_pin`,
    `quality_serve`, `quality_replay`, `quality_overhead` lines) from the
    `report` run's checkpoint; the launches are the children's reports and
    the overhead probe's, the `quality` path."""
    import dataclasses

    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.serve.loadgen import measure_quality_overhead

    kind = torch.cuda.get_device_name(0)
    launches: dict[str, int] = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(ck)) as tmp:
        baseline = os.path.join(tmp, "quality_baseline.json")
        _, recs, wall = _cli_records("quality pin", "pin-quality",
                                     "--checkpoint-dir", ck, "--n",
                                     str(QUALITY_PARTS), "--out", baseline)
        pinned = next((r["quality_baseline"] for r in recs
                       if "quality_baseline" in r), None)
        if pinned is None or pinned["n"] != QUALITY_PARTS:
            fail(f"quality: pin-quality printed {recs}")
        _add_counts(launches, pinned.get("launches") or {})
        print("quality_pin", json.dumps({**pinned, "wall_s": wall,
                                         "nvidia_smi": smi_line}), flush=True)

        t0 = time.perf_counter()
        served, child = quality_serve_line(seed, ck, baseline, tmp, kind,
                                           smi_line)
        served["phase_s"] = time.perf_counter() - t0
        _add_counts(launches, child["launches"])
        print("quality_serve", json.dumps(served), flush=True)

        t0 = time.perf_counter()
        replays, counts = quality_replay_line(torch, ck, child["capture"], tmp,
                                              smi_line)
        replays["phase_s"] = time.perf_counter() - t0
        _add_counts(launches, counts)
        print("quality_replay", json.dumps(replays), flush=True)

    cfg = get_config("sprint64", seed=seed)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend="pallas"))
    _reset_counts()
    t0 = time.perf_counter()
    turns = [measure_quality_overhead(cfg, n_requests=QUALITY_OVERHEAD_REQUESTS,
                                      device="cuda")
             for _ in range(QUALITY_OVERHEAD_TURNS)]
    _add_counts(launches, _read_counts())
    pcts = [t["quality_overhead_pct"] for t in turns]
    tax = {"turns": turns, "quality_overhead_pct_min": min(pcts),
           "quality_overhead_pct_max": max(pcts),
           "wall_s": time.perf_counter() - t0, "nvidia_smi": smi_line}
    print("quality_overhead", json.dumps(tax), flush=True)
    torch.cuda.empty_cache()
    if not launches.get("conv3d_fwd"):
        fail(f"quality: no conv3d_fwd launch on the quality path: {launches}")
    return {"launches": launches}


# The incident phase: sprint64 served while its serving_p99_ms rule fires,
# opens, captures and closes one incident (obs/incidents.py). The SLO lies
# between two latencies measured first on the card: sequential bucket-1
# requests' p99 and a concurrent burst's median. The burst and the
# recovery are bounded in the windows' emission cycles (DEFAULT_EMIT_EVERY_S):
# the rule fires within INCIDENT_FIRE_CYCLES of the burst's start, and the
# burst goes on until the capture (the sampler's DEFAULT_SAMPLE_S, its hard
# deadline twice that) is written; the recovery sends one request at a
# time until the alert resolves, within INCIDENT_RESOLVE_CYCLES of the
# window (DEFAULT_WINDOW samples) holding recovery requests alone.
INCIDENT_PARTS = 256
INCIDENT_CLIENTS = 128  # two bucket-64 batches in flight
INCIDENT_CALIB_SEQ = 64
INCIDENT_CALIB_BURSTS = 3
INCIDENT_SEPARATION = 4.0  # the burst's median over the sequential p99
INCIDENT_FIRE_CYCLES = 3
INCIDENT_RESOLVE_CYCLES = 3
INCIDENT_OVERHEAD_REQUESTS = 192
INCIDENT_OVERHEAD_TURNS = 3
INCIDENT_RULE = "serving_p99_ms"


def _incident_grids(seed: int):
    import numpy as np

    from featurenet_tpu_torch.data.synthetic import generate_batch

    return np.ascontiguousarray(generate_batch(
        np.random.default_rng(seed + 13), INCIDENT_PARTS, 64)["voxels"][..., 0],
        dtype="<f4")


def _eager_labels(torch, pred, grids):
    """The labels (and top-2 gap) of the Predictor's eager forward."""
    import numpy as np

    probs = []
    with torch.inference_mode():
        for i in range(0, len(grids), 64):
            x = torch.from_numpy(grids[i:i + 64, ..., None]).cuda()
            probs.append(pred.forward_eager(x).float().cpu().numpy())
    probs = np.concatenate(probs)
    top2 = np.sort(probs, axis=-1)[:, -2:]
    return probs.argmax(-1), top2[:, 1] - top2[:, 0]


def _incident_service(pred, rules=(), run_dir=None):
    from featurenet_tpu_torch.serve.service import InferenceService

    return InferenceService(pred, buckets=SERVE_BUCKETS, queue_limit=256,
                            rules=rules, run_dir=run_dir,
                            slo_p99_ms=float("inf"))


def incident_calibrate(pred, grids, smi_line: str) -> dict:
    """The two latencies the SLO is set between, from one in-process
    service on the card (no rules, no run directory): INCIDENT_CALIB_SEQ
    requests one at a time (bucket 1) and INCIDENT_CALIB_BURSTS bursts of
    INCIDENT_CLIENTS requests at once (bucket 64)."""
    service = _incident_service(pred)
    try:
        seq = []
        for g in grids[:INCIDENT_CALIB_SEQ]:
            f = service.submit_voxels(g)
            f.result(timeout=120)
            seq.append(f.latency_ms)
        burst = []
        for _ in range(INCIDENT_CALIB_BURSTS):
            futs = [service.submit_voxels(g) for g in grids[:INCIDENT_CLIENTS]]
            for f in futs:
                f.result(timeout=120)
            burst += [f.latency_ms for f in futs]
    finally:
        service.drain()
    from featurenet_tpu_torch.obs.report import _pct

    seq_p99, burst_p50 = _pct(sorted(seq), 99), _pct(sorted(burst), 50)
    if not seq_p99 * INCIDENT_SEPARATION <= burst_p50:
        fail(f"incident: a burst's median {burst_p50} ms is not "
             f"{INCIDENT_SEPARATION}x the sequential p99 {seq_p99} ms")
    return {"seq_p99_ms": seq_p99, "burst_p50_ms": burst_p50,
            "slo_p99_ms": round((seq_p99 * burst_p50) ** 0.5, 3),
            "nvidia_smi": smi_line}


class _Burst:
    """INCIDENT_CLIENTS threads, each posting grids over its own keep-alive
    connection until ``stop``; every answer recorded with its trace id and
    the client's send and receive times (epoch s, the server's axis)."""

    def __init__(self, port: int, grids, tag: str):
        self.port, self.grids, self.tag = port, grids, tag
        self.stop = threading.Event()
        self.records: list[dict] = []
        self.errors: list[str] = []
        self._lock = threading.Lock()
        self.threads = [threading.Thread(target=self._client, args=(c,),
                                         daemon=True)
                        for c in range(INCIDENT_CLIENTS)]

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def _client(self, c: int):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        i = 0
        try:
            while not self.stop.is_set():
                k = (c + i * INCIDENT_CLIENTS) % len(self.grids)
                rec = _post_traced(conn, self.grids, k, f"{self.tag}-{c}-{i}")
                with self._lock:
                    self.records.append(rec)
                i += 1
        except Exception as e:  # reported by the phase
            with self._lock:
                self.errors.append(f"client {c}: {type(e).__name__}: {e}")
        finally:
            conn.close()

    def join(self):
        self.stop.set()
        for t in self.threads:
            t.join(180)
        if any(t.is_alive() for t in self.threads):
            fail(f"incident: burst clients of {self.tag} did not finish")


def _post_traced(conn, grids, k: int, trace: str) -> dict:
    t_send = time.time()
    conn.request("POST", "/predict_voxels", body=grids[k].tobytes(),
                 headers={"X-Featurenet-Trace": trace})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    return {"trace": trace, "k": k, "status": resp.status,
            "label": body.get("label"), "t_send": t_send, "t_recv": time.time()}


def _wait_until(pred, deadline_s: float, what: str, poll_s: float = 0.05):
    t_end = time.perf_counter() + deadline_s
    while not pred():
        if time.perf_counter() > t_end:
            fail(f"incident: {what} within {deadline_s:.1f} s")
        time.sleep(poll_s)


def _bundle_done(bundle: str) -> bool:
    try:
        with open(os.path.join(bundle, "manifest.json")) as fh:
            return bool(json.load(fh).get("files"))
    except (OSError, ValueError):
        return False


def _capture_line(b: dict, events: list) -> dict:
    """A bundle's capture: its wall (incident_open to incident_capture on
    the events' clock), the sampler's samples and ticks against its
    cadence, and the samples per thread."""
    from featurenet_tpu_torch.obs import incidents, stacksampler

    man = b["manifest"] or {}
    cap = man.get("capture") or {}
    t = {e["ev"]: e["t"] for e in events
         if e.get("id") == b["id"] and e["ev"].startswith("incident_")}
    expected = incidents.DEFAULT_SAMPLE_S * stacksampler.DEFAULT_HZ
    # The HTTP server's request threads folded into one entry.
    threads: dict = {}
    for name, n in stacksampler.thread_totals(b["stacks"] or {}).items():
        if "process_request_thread" in name:
            row = threads.setdefault("http_request_threads",
                                     {"threads": 0, "samples": 0})
            row["threads"] += 1
            row["samples"] += n
        else:
            threads[name] = n
    return {"capture_wall_s": round(t["incident_capture"] - t["incident_open"], 3)
            if {"incident_capture", "incident_open"} <= set(t) else None,
            "stack_samples": cap.get("stack_samples"),
            "stack_ticks": cap.get("stack_ticks"),
            "stack_ticks_expected": expected,
            "stack_duration_s": cap.get("stack_duration_s"),
            "stack_truncated": cap.get("stack_truncated"),
            "sampler_starved": bool(cap.get("stack_truncated"))
            or (cap.get("stack_ticks") or 0) < 0.8 * expected,
            "threads": threads}


def _check_bundle(b: dict, what: str, http_threads: bool) -> None:
    from featurenet_tpu_torch.obs import incidents, stacksampler

    man = b["manifest"] or {}
    if b["missing"] or not set(incidents.BUNDLE_FILES) <= set(man.get("files") or ()):
        fail(f"{what}: bundle {b['id']} missing {b['missing']}, files "
             f"{man.get('files')}")
    names = stacksampler.thread_totals(b["stacks"] or {})
    if "serve-batcher" not in names or (http_threads and not any(
            "process_request_thread" in n for n in names)):
        fail(f"{what}: stacks.folded samples no dispatch or HTTP thread: "
             f"{sorted(names)}")


def incident_serve_line(seed: int, grids, labels, gaps, slo: float,
                        tmp: str, smi_line: str) -> tuple[dict, dict]:
    """``cli serve --config sprint64 --run-dir D --trace-sample 0
    --slo-p99-ms SLO --alert-rules serving_p99_ms>SLO`` as a subprocess: a
    burst of INCIDENT_CLIENTS keep-alive clients until the incident's
    capture is written, then one request at a time until GET /metrics
    reads ``incidents_open 0``; SIGTERM; then ``cli incident list|show``
    and ``cli report --json|--validate`` without torch."""
    from featurenet_tpu_torch.obs import incidents, windows
    from featurenet_tpu_torch.runtime.registry import WARMUP_ITERS

    emit_s = windows.DEFAULT_EMIT_EVERY_S
    run = os.path.join(tmp, "serve_run")
    t0 = time.perf_counter()
    srv = subprocess.Popen(
        _cli("serve", "--config", "sprint64", "--seed", str(seed), "--port", "0",
             "--run-dir", run, "--trace-sample", "0", "--slo-p99-ms", str(slo),
             "--alert-rules", f"{INCIDENT_RULE}>{slo}:critical",
             "--queue-limit", "256", "--duration-s", "600"),
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    gauge = 'featurenet_incidents_open'
    readings: list[tuple[float, float]] = []
    try:
        port = json.loads(srv.stdout.readline())["serving"]["port"]
        ready_s = time.perf_counter() - t0

        def read_gauge() -> float:
            v = _metric(_get_text(port, "/metrics"), gauge)
            readings.append((time.time(), v))
            return v

        if read_gauge() != 0:
            fail(f"incident_serve: {gauge} before the burst: {readings}")
        t_burst = time.perf_counter()
        burst = _Burst(port, grids, f"inc{seed}").start()
        inc_dir = incidents.incidents_dir(run)
        _wait_until(lambda: read_gauge() == 1, INCIDENT_FIRE_CYCLES * emit_s,
                    f"{gauge} did not read 1 during the burst", poll_s=0.25)
        t_open_seen = time.perf_counter() - t_burst
        _wait_until(lambda: os.path.isdir(inc_dir) and os.listdir(inc_dir),
                    emit_s, "the bundle's directory did not appear")
        (bundle_id,) = os.listdir(inc_dir)
        _wait_until(lambda: _bundle_done(os.path.join(inc_dir, bundle_id)),
                    2 * incidents.DEFAULT_SAMPLE_S + emit_s,
                    "the capture was not written during the burst")
        burst.join()
        burst_s = time.perf_counter() - t_burst
        if burst.errors:
            fail(f"incident_serve: burst {burst.errors[:3]}")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        recovery: list[dict] = []
        t_rec = time.perf_counter()
        deadline = INCIDENT_RESOLVE_CYCLES * emit_s
        while True:
            k = len(recovery) % len(grids)
            recovery.append(_post_traced(conn, grids, k,
                                         f"rec{seed}-{len(recovery)}"))
            if len(recovery) % 16 == 0 and read_gauge() == 0:
                break
            if time.perf_counter() - t_rec > deadline + emit_s:
                fail(f"incident_serve: {gauge} still 1 after "
                     f"{len(recovery)} recovery requests: {readings[-3:]}")
        conn.close()
        recovery_s = time.perf_counter() - t_rec
        srv.send_signal(signal.SIGTERM)
        out, err = srv.communicate(timeout=120)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.communicate()
    if srv.returncode != 0:
        fail(f"incident_serve: cli serve exited {srv.returncode}: {err[-2000:]}")
    stats = json.loads(out.strip().splitlines()[-1])["serve_stats"]
    requests = burst.records + recovery
    bad = [r for r in requests if r["status"] != 200 or r["label"] is None]
    wrong = [r for r in requests if r["label"] != int(labels[r["k"]])
             and gaps[r["k"]] >= 1e-6]
    if bad or wrong:
        fail(f"incident_serve: {len(bad)} failed, {len(wrong)} wrong answers: "
             f"{(bad + wrong)[:3]}")
    # No request launched a kernel from Python: the child's counts are its
    # warmup's (WARMUP_ITERS eager runs and one capture of 3 per bucket).
    want = dict(_want_counts("xla", 0, 0),
                conv3d_fwd=3 * (WARMUP_ITERS + 1) * len(SERVE_BUCKETS))
    if stats.get("launches") != want:
        fail(f"incident_serve: launches {stats.get('launches')}, not {want}")
    with open(os.path.join(run, "events.jsonl")) as fh:
        events = [json.loads(ln) for ln in fh]
    opens = [e for e in events if e["ev"] == "incident_open"]
    closes = [e for e in events if e["ev"] == "incident_close"]
    if len(opens) != 1 or len(closes) != 1 or opens[0]["rule"] != INCIDENT_RULE \
            or stats.get("incidents", {}).get("opened_total") != 1:
        fail(f"incident_serve: opens {opens}, closes {closes}, "
             f"stats {stats.get('incidents')}")
    t_open, t_close = opens[0]["t"], closes[0]["t"]
    kept = {e["trace"]: e for e in events if e["ev"] == "request_done"}
    inside = [r for r in requests if t_open < r["t_send"] and r["t_recv"] < t_close]
    missing = [r["trace"] for r in inside if r["trace"] not in kept]
    under = [t for t, e in kept.items() if e["total_ms"] <= slo
             and t_open < e["t"] < t_close]
    after = [t for t, e in kept.items() if e["total_ms"] <= slo and e["t"] > t_close]
    before = [t for t, e in kept.items() if e["total_ms"] <= slo and e["t"] < t_open]
    if missing or not under or after or before:
        fail(f"incident_serve: traces: {len(missing)} answered while open not "
             f"kept {missing[:3]}, {len(under)} under the SLO kept while open, "
             f"{len(after)} kept after the close {after[:3]}, {len(before)} "
             "before the open")
    if max(v for _, v in readings) != 1 or readings[-1][1] != 0:
        fail(f"incident_serve: {gauge} readings {readings}")
    (entry,) = incidents.list_incidents(run)
    b = incidents.load_bundle(run, entry["id"])
    _check_bundle(b, "incident_serve", http_threads=True)
    listed = _report_cli("incident", "list", run, "--json")
    shown = _report_cli("incident", "show", run)
    rep = _report_cli("report", run, "--json")
    validate = _report_cli("report", run, "--validate")
    if listed.returncode or json.loads(listed.stdout) != [entry] \
            or shown.returncode or entry["id"] not in shown.stdout \
            or "missing:" in shown.stdout:
        fail(f"incident_serve: cli incident list {listed.stdout[-500:]} "
             f"{listed.stderr[-500:]} show {shown.stdout[-1000:]}")
    inc = json.loads(rep.stdout).get("incidents") or {} if not rep.returncode else {}
    if inc.get("opened") != 1 or inc.get("closed") != 1 \
            or [x["id"] for x in inc.get("bundles", ())] != [entry["id"]]:
        fail(f"incident_serve: report incidents {inc} {rep.stderr[-1000:]}")
    if validate.returncode or '"validate": "ok"' not in validate.stdout:
        fail(f"incident_serve: report --validate {validate.stdout[-2000:]}")
    return {
        "slo_p99_ms": slo, "ready_s": ready_s,
        "burst": {"requests": len(burst.records), "wall_s": burst_s,
                  "open_seen_after_s": t_open_seen},
        "recovery": {"requests": len(recovery), "wall_s": recovery_s},
        "near_ties": int(sum(gaps[r["k"]] < 1e-6 for r in requests)),
        "incident": {k: entry.get(k) for k in ("id", "rule", "value",
                                              "threshold", "duration_s")},
        **_capture_line(b, events),
        "traces_kept_while_open": len([t for t, e in kept.items()
                                       if t_open < e["t"] < t_close]),
        "traces_under_slo_kept_while_open": len(under),
        "answered_while_open": len(inside),
        "traces_kept_outside": len([t for t, e in kept.items()
                                    if not t_open < e["t"] < t_close]),
        "metrics_readings": len(readings),
        "by_bucket": stats["by_bucket"], "served": stats["served"],
        "report_incidents": {k: inc[k] for k in ("opened", "closed", "by_rule")},
        "validate": json.loads(validate.stdout.strip().splitlines()[-1]),
        "nvidia_smi": smi_line,
    }, {"launches": stats.get("launches") or {}}


def incident_store_line(pred, grids, labels, gaps, slo: float, tmp: str,
                        smi_line: str) -> dict:
    """An in-process sprint64 service with a run directory and a
    ``TimeSeriesStore`` attached by ``alerts.set_store`` (as the reference's
    ``cli fleet`` wires one): the same burst (concurrent submits) and
    recovery; the store holds ``alerts_active`` 1 then 0, the bundle's
    ``tsdb.json`` that 1, and ``cli dash --once`` renders the run directory
    alone with the bundle on its incident line."""
    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.obs import alerts, incidents, tsdb, windows

    emit_s = windows.DEFAULT_EMIT_EVERY_S
    run = os.path.join(tmp, "store_run")
    obs.init_run(run, extra={"cmd": "incident_store"}, process_index=0)
    store = tsdb.TimeSeriesStore.open(run)
    alerts.set_store(store)
    rule = alerts.AlertRule(INCIDENT_RULE, ">", slo, "critical")
    service = _incident_service(pred, rules=[rule], run_dir=run)
    service.batcher.trace_sample = 0.0
    answers: list[tuple[int, object]] = []
    stop = threading.Event()
    errors: list[str] = []

    def submitter(c: int):
        try:
            i = 0
            while not stop.is_set():
                ks = [(c * 32 + i * 64 + j) % len(grids) for j in range(32)]
                futs = [service.submit_voxels(grids[k]) for k in ks]
                for k, f in zip(ks, futs):
                    answers.append((k, f.result(timeout=120)))
                i += 1
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")

    try:
        mgr = incidents.manager()
        t_burst = time.perf_counter()
        threads = [threading.Thread(target=submitter, args=(c,), daemon=True)
                   for c in range(INCIDENT_CLIENTS // 32)]
        for t in threads:
            t.start()
        _wait_until(lambda: mgr.open_count() == 1, INCIDENT_FIRE_CYCLES * emit_s,
                    "incident_store: no incident opened during the burst")
        (inc_id,) = mgr.open_ids()
        bundle = os.path.join(incidents.incidents_dir(run), inc_id)
        _wait_until(lambda: _bundle_done(bundle), 2 * incidents.DEFAULT_SAMPLE_S
                    + emit_s, "incident_store: the capture was not written")
        stop.set()
        for t in threads:
            t.join(180)
        burst_s = time.perf_counter() - t_burst
        t_rec, n_rec = time.perf_counter(), 0
        while mgr.open_count():
            k = n_rec % len(grids)
            answers.append((k, service.submit_voxels(grids[k]).result(timeout=120)))
            n_rec += 1
            if time.perf_counter() - t_rec > (INCIDENT_RESOLVE_CYCLES + 1) * emit_s:
                fail(f"incident_store: still open after {n_rec} requests")
        recovery_s = time.perf_counter() - t_rec
    finally:
        stop.set()
        st = service.drain()
        alerts.set_store(None)
        store.close()
        obs.close_run()
        windows.uninstall()
    if errors:
        fail(f"incident_store: submitters {errors[:3]}")
    wrong = [k for k, row in answers
             if int(row.argmax()) != int(labels[k]) and gaps[k] >= 1e-6]
    if wrong:
        fail(f"incident_store: {len(wrong)} answers differ from the eager labels")
    reader = tsdb.TimeSeriesStore.open(run)
    mirror = [v for _, v in reader.query("alerts_active", {"rule": INCIDENT_RULE})]
    b = incidents.load_bundle(run, inc_id)
    _check_bundle(b, "incident_store", http_threads=False)
    sliced = [s["samples"] for s in (b["tsdb"] or {}).get("series", ())
              if s["metric"] == "alerts_active"]
    if mirror != [1.0, 0.0] or not sliced or [v for _, v in sliced[0]] != [1.0] \
            or st.get("incidents", {}).get("opened_total") != 1:
        fail(f"incident_store: store {mirror}, bundle slice {sliced}, "
             f"stats {st.get('incidents')}")
    dash = _report_cli("dash", run, "--once")
    line = [ln for ln in dash.stdout.splitlines() if ln.startswith("incidents:")]
    if dash.returncode or not line or inc_id not in line[0]:
        fail(f"incident_store: cli dash --once {dash.stdout[-1500:]} "
             f"{dash.stderr[-1000:]}")
    with open(os.path.join(run, "events.jsonl")) as fh:
        events = [json.loads(ln) for ln in fh]
    return {"slo_p99_ms": slo, "answers": len(answers),
            "burst_wall_s": burst_s, "recovery": {"requests": n_rec,
                                                  "wall_s": recovery_s},
            "alerts_active": mirror, "store": reader.stats(),
            "bundle_tsdb_series": len(b["tsdb"]["series"]),
            "dash_incident_line": line[0], "dash_lines": len(dash.stdout.splitlines()),
            **_capture_line(b, events), "nvidia_smi": smi_line}


def incident_phase(torch, seed: int, smi_line: str) -> dict:
    """The incident plane on the card (`incident_calibrate`,
    `incident_serve`, `incident_store`, `incident_overhead` lines); the
    launches are the in-process services' warmups, the overhead probe's
    and the serve child's, the `incident` path."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.loadgen import measure_incident_overhead

    grids = _incident_grids(seed)
    pred = Predictor.from_seed(get_config("sprint64"), seed, batch=64,
                               device="cuda")
    labels, gaps = _eager_labels(torch, pred, grids)
    _reset_counts()
    t0 = time.perf_counter()
    calib = incident_calibrate(pred, grids, smi_line)
    calib["wall_s"] = time.perf_counter() - t0
    print("incident_calibrate", json.dumps(calib), flush=True)
    slo = calib["slo_p99_ms"]
    launches = _read_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        served, child = incident_serve_line(seed, grids, labels, gaps,
                                            slo, tmp, smi_line)
        served["phase_s"] = time.perf_counter() - t0
        _add_counts(launches, child["launches"])
        print("incident_serve", json.dumps(served), flush=True)
        _reset_counts()
        t0 = time.perf_counter()
        stored = incident_store_line(pred, grids, labels, gaps, slo, tmp,
                                     smi_line)
        stored["phase_s"] = time.perf_counter() - t0
        _add_counts(launches, _read_counts())
        print("incident_store", json.dumps(stored), flush=True)
    del pred
    torch.cuda.empty_cache()
    cfg = get_config("sprint64", seed=seed)
    _reset_counts()
    t0 = time.perf_counter()
    turns = [measure_incident_overhead(cfg, n_requests=INCIDENT_OVERHEAD_REQUESTS,
                                       device="cuda")
             for _ in range(INCIDENT_OVERHEAD_TURNS)]
    _add_counts(launches, _read_counts())
    pcts = [t["incident_overhead_pct"] for t in turns]
    tax = {"turns": turns, "incident_overhead_pct_min": min(pcts),
           "incident_overhead_pct_max": max(pcts),
           "wall_s": time.perf_counter() - t0, "nvidia_smi": smi_line}
    print("incident_overhead", json.dumps(tax), flush=True)
    torch.cuda.empty_cache()
    if not launches.get("conv3d_fwd"):
        fail(f"incident: no conv3d_fwd launch on the incident path: {launches}")
    return {"launches": launches}


# The fleet phase: `cli fleet` of FLEET_REPLICAS sprint64 replicas on the
# card from the `report` run's checkpoint, FLEET_REQUESTS open-loop
# requests at FLEET_QPS through the router with the replica_loss site at
# FLEET_KILL_AT (the reference bench's 1/3 kill point at twice its rate),
# the direct-against-routed bursts of FLEET_COMPARE requests, a passing and
# a failing `cli fleet rollout` under background load of FLEET_BG_QPS.
FLEET_REPLICAS = 2
FLEET_REQUESTS = 480
FLEET_QPS = 120.0
FLEET_KILL_AT = 160
FLEET_COMPARE = 240
FLEET_BG_QPS = 40.0
FLEET_GRIDS = 64
FLEET_READY_S = 240.0  # launch to all ready, and a loss to its rejoin
# A served top probability against the same bucket's eager one: equal but
# for float rounding (sprint64's bf16 activations make buckets differ by
# up to ~3e-3 from each other, so each bucket is compared on its own).
FLEET_PROB_ULP = 1e-6


def _next_step_checkpoint(ck: str, out: str) -> str:
    """The newest step of ``ck`` saved again, one step later, into ``out``:
    the same weights under a new step and version."""
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_run_config,
    )
    from featurenet_tpu_torch.train.state import create_state

    cfg = load_run_config(ck)
    state = create_state(build_model(cfg, seed=0), cfg)
    src = CheckpointManager(ck)
    src.restore(state)
    src.close()
    state.step = int(state.step) + 1
    mgr = CheckpointManager(out, config=cfg)
    mgr.save(state)
    mgr.close()
    return out


def _run_events(run: str) -> list[dict]:
    """Every event line of every stream of a run directory, by time."""
    out = []
    for name in sorted(os.listdir(run)):
        if name.startswith("events") and name.endswith(".jsonl"):
            with open(os.path.join(run, name)) as fh:
                for line in fh:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        pass  # a torn tail line
    return sorted(out, key=lambda e: e.get("t", 0.0))


def _fleet_health(port: int) -> dict:
    try:
        return _get(port, "/healthz")[1]
    except (OSError, http.client.HTTPException, ValueError):
        return {}


def _fleet_probs(torch, pred, grids) -> dict:
    """The Predictor's eager probabilities of every grid at each serving
    bucket (the grids in chunks of the bucket's size): what a replica's
    graph for that bucket answers, bitwise, whatever shares the batch."""
    out = {}
    with torch.inference_mode():
        for b in SERVE_BUCKETS:
            out[b] = torch.cat([
                pred.forward_eager(torch.from_numpy(
                    grids[i:i + b, ..., None]).cuda()).float().cpu()
                for i in range(0, len(grids), b)]).numpy()
    return out


def _fleet_labels(outcomes, probs: dict, what: str) -> dict:
    """Every answered request (request i sent grid i % FLEET_GRIDS) must
    carry the label and top probability the Predictor gives its grid at
    one of the serving buckets (within FLEET_PROB_ULP); how many answers
    each bucket's forward matched first."""
    answered = 0
    by_bucket = {b: 0 for b in probs}
    for i, o in enumerate(outcomes):
        if o is None or o.get("status") != 200:
            continue
        answered += 1
        j = i % FLEET_GRIDS
        hit = next((b for b, p in probs.items()
                    if o["label"] == int(p[j].argmax())
                    and abs(o["body"]["prob"] - float(p[j].max()))
                    <= FLEET_PROB_ULP), None)
        if hit is None:
            fail(f"fleet {what}: request {i} answered {o['label']} at "
                 f"{o['body']['prob']}, the Predictor by bucket "
                 f"{ {b: (int(p[j].argmax()), float(p[j].max())) for b, p in probs.items()} }")
        by_bucket[hit] += 1
    return {"answered": answered, "matched_bucket": by_bucket}


class _BackgroundLoad:
    """Open-loop bursts through the router until stopped: the load a
    rollout runs under."""

    def __init__(self, port: int, grids):
        self.port, self.grids = port, grids
        self.stats: list[dict] = []
        self.outcomes: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from featurenet_tpu_torch.fleet.loadgen import http_load

        while not self._stop.is_set():
            st, outs = http_load("127.0.0.1", self.port, FLEET_BG_QPS,
                                 int(FLEET_BG_QPS), self.grids)
            self.stats.append(st)
            self.outcomes += outs

    def stop(self) -> dict:
        self._stop.set()
        self._thread.join(timeout=120)
        return {k: sum(s[k] for s in self.stats)
                for k in ("answered", "rejected", "dropped", "retried")}


def _fleet_rollout(ck: str, run: str, what: str, ok_rc: int,
                   port: int, grids) -> tuple[dict, float, dict]:
    """`cli fleet rollout ck --run-dir run` under background load; its
    exit code must be ``ok_rc`` and the load must drop nothing."""
    load = _BackgroundLoad(port, grids)
    t0 = time.perf_counter()
    try:
        rc, recs, _ = _cli_records(f"fleet {what}", "fleet", "rollout", ck,
                                   "--run-dir", run, ok=(ok_rc,))
    finally:
        bg = load.stop()
    wall = time.perf_counter() - t0
    out = next((r["fleet_rollout"] for r in recs if "fleet_rollout" in r), None)
    if out is None or not str(out.get("device", "")).startswith("cuda"):
        fail(f"fleet {what}: no rollout verdict on the card: {recs}")
    if bg["dropped"]:
        fail(f"fleet {what}: the background load dropped {bg['dropped']}: {bg}")
    return out, wall, bg


def fleet_phase(torch, seed: int, ck: str, smi_line: str) -> dict:
    """The serving fleet on the card (`fleet` line): `cli fleet` with the
    replica_loss site, the loss absorbed and the slot rejoined, labels held
    to an in-process Predictor, no CUDA context in the fleet process, a
    passing and a failing rollout, the report's fleet timeline. The
    launches are those the draining replicas and the rollout processes
    report of themselves (the SIGKILLed replica's are lost with it), the
    `fleet` path."""
    import dataclasses

    import numpy as np

    from featurenet_tpu_torch.data.synthetic import generate_batch
    from featurenet_tpu_torch.elastic.membership import read_membership
    from featurenet_tpu_torch.fleet.loadgen import http_load
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.train.checkpoint import load_run_config

    grids = np.ascontiguousarray(generate_batch(
        np.random.default_rng(seed + 21), FLEET_GRIDS, 64)["voxels"][..., 0],
        dtype="<f4")
    pred = Predictor.from_checkpoint(ck, batch=64, device="cuda")
    probs = _fleet_probs(torch, pred, grids)
    del pred
    torch.cuda.empty_cache()
    launches: dict[str, int] = {}
    line: dict = {"replicas": FLEET_REPLICAS, "nvidia_smi": smi_line}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(ck)) as tmp:
        run = os.path.join(tmp, "run")
        ck2 = _next_step_checkpoint(ck, os.path.join(tmp, "ck_next"))
        bad = _seeded_checkpoint(os.path.join(tmp, "ck_other"),
                                 load_run_config(ck), seed + 101)
        used_before = _smi_used_mib()
        t0 = time.perf_counter()
        err = open(os.path.join(tmp, "fleet.err"), "w")
        proc = subprocess.Popen(
            _cli("fleet", "--checkpoint-dir", ck, "--replicas",
                 str(FLEET_REPLICAS), "--buckets", "1,4,16,64", "--capture",
                 "--capture-sample", "1.0", "--run-dir", run, "--port", "0",
                 "--inject-faults", f"replica_loss@request={FLEET_KILL_AT}"),
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            banner = json.loads(proc.stdout.readline())["fleet"]
            port = banner["port"]
            while _fleet_health(port).get("healthy", 0) < FLEET_REPLICAS:
                if proc.poll() is not None or \
                        time.perf_counter() - t0 > FLEET_READY_S:
                    fail(f"fleet: {FLEET_REPLICAS} replicas not ready in "
                         f"{FLEET_READY_S} s: {_fleet_health(port)}")
                time.sleep(0.1)
            line["ready_s"] = time.perf_counter() - t0
            used_ready = _smi_used_mib()
            apps = _smi_apps()
            fleet_pid = banner["pid"]
            spawns = {e["host"]: e["pid"] for e in _run_events(run)
                      if e.get("ev") == "supervisor" and e.get("phase") == "spawn"}
            held = {slot: _gpu_fds(pid) for slot, pid in spawns.items()}
            if (fleet_pid in {p for p, _ in apps} or _gpu_fds(fleet_pid)
                    or not all(held.values())):
                fail(f"fleet: the fleet process (pid {fleet_pid}) holds a CUDA "
                     f"context, or a replica holds none: nvidia-smi {apps}, "
                     f"its device nodes {_gpu_fds(fleet_pid)}, the replicas' "
                     f"{held}")
            line["no_cuda_context"] = {
                "fleet_pid": fleet_pid, "fleet_gpu_fds": [],
                "replica_pids": spawns, "smi_apps": apps,
                # nvidia-smi may not see a container's pids: the card's
                # used memory with the replicas up, over the count.
                "used_mib_before": used_before, "used_mib_ready": used_ready,
                "mib_per_replica": (None if None in (used_before, used_ready)
                                    else (used_ready - used_before)
                                    / FLEET_REPLICAS),
                "smi_mib_by_replica": {slot: dict(apps).get(pid, "not listed")
                                       for slot, pid in spawns.items()},
            }

            st, outs = http_load("127.0.0.1", port, FLEET_QPS, FLEET_REQUESTS,
                                 grids)
            if st["dropped"] or st["answered"] + st["rejected"] != FLEET_REQUESTS:
                fail(f"fleet: the load through the loss dropped requests: {st}")
            line["load"] = {**st, **_fleet_labels(outs, probs, "load")}
            t_kill = time.perf_counter()
            while True:
                m = read_membership(run)
                if m is not None and m.reason == "replica_rejoin" \
                        and len(m.members) == FLEET_REPLICAS:
                    break
                if time.perf_counter() - t_kill > FLEET_READY_S:
                    fail(f"fleet: no rejoin in {FLEET_READY_S} s: {m}")
                time.sleep(0.1)
            events = _run_events(run)
            loss = next((e for e in events if e["ev"] == "fleet_replica_loss"),
                        None)
            if loss is None:
                fail("fleet: the replica_loss site fired no fleet_replica_loss")
            back = next(e for e in events if e["ev"] == "fleet_replica_ready"
                        and e["t"] > loss["t"] and e["replica"] == loss["replica"])
            line["loss"] = {"replica": loss["replica"], "reason": loss["reason"],
                            "respawn_to_ready_s": back["t"] - loss["t"],
                            "membership": dataclasses.asdict(m)}

            # Through the router against one replica alone, same load.
            health = _fleet_health(port)
            direct_port = int(sorted(health["ports"].items())[0][1])
            cmp_ = {}
            for what, p in (("direct", direct_port), ("routed", port)):
                s, o = http_load("127.0.0.1", p, FLEET_QPS, FLEET_COMPARE, grids)
                if s["dropped"] or s["answered"] != FLEET_COMPARE:
                    fail(f"fleet {what}: {s}")
                cmp_[what] = {**{k: s[k] for k in ("sustained_qps", "p50_ms",
                                                   "p99_ms", "offered_qps")},
                              **_fleet_labels(o, probs, what)}
            line["direct_vs_routed"] = cmp_

            old = set(health["versions"].values())
            out, wall, bg = _fleet_rollout(ck2, run, "rollout", 0, port, grids)
            new = out["version"]
            if (not out["ok"] or sorted(out["swapped"]) != list(range(FLEET_REPLICAS))
                    or not out["converged"]
                    or set(_fleet_health(port)["versions"].values()) != {new}
                    or new in old):
                fail(f"fleet rollout: {out}")
            _add_counts(launches, out.get("launches") or {})
            line["rollout"] = {"wall_s": wall, "per_replica_s": wall / FLEET_REPLICAS,
                               "version": new, "from": sorted(old),
                               "steps": out["steps"], "background": bg}

            out, wall, bg = _fleet_rollout(bad, run, "rollout_bad", 2, port, grids)
            if (out["ok"] or not out["reason"].startswith("canary_failed")
                    or set(_fleet_health(port)["versions"].values()) != {new}):
                fail(f"fleet failing rollout: {out}")
            _add_counts(launches, out.get("launches") or {})
            line["rollout_bad"] = {"wall_s": wall, "reason": out["reason"],
                                   "rolled_back": out["rolled_back"],
                                   "converged": out["converged"],
                                   "background": bg}
            proc.send_signal(signal.SIGTERM)
            stdout, _ = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            err.close()
        if proc.returncode != 0:
            with open(os.path.join(tmp, "fleet.err")) as fh:
                fail(f"fleet: cli fleet exited {proc.returncode}: "
                     f"{fh.read()[-2000:]}")
        stats = json.loads(stdout.strip().splitlines()[-1])["fleet_stats"]
        if stats["dropped"] or stats["replicas"]["rejoins"] < 1:
            fail(f"fleet: fleet_stats {stats}")
        line["fleet_stats"] = {k: stats[k] for k in (
            "routed", "answered", "rejected", "spillovers", "resubmits",
            "dropped", "pool", "scrape")}
        line["fleet_stats"]["replicas"] = stats["replicas"]
        # Each draining replica's own count (the SIGKILLed one's went with
        # it; its respawn's stdout file took the slot's name).
        children = {}
        for slot in range(FLEET_REPLICAS):
            with open(os.path.join(run, f"replica.{slot}.out")) as fh:
                serve = [json.loads(ln)["serve_stats"] for ln in fh
                         if ln.startswith('{"serve_stats"')]
            if not serve:
                fail(f"fleet: replica {slot} printed no serve_stats")
            children[slot] = serve[-1].get("launches") or {}
            _add_counts(launches, children[slot])
        line["replica_launches"] = children

        got = _report_cli("report", run, "--json")
        if got.returncode != 0:
            fail(f"fleet: report --json exited {got.returncode}: {got.stderr[-2000:]}")
        rep = json.loads(got.stdout)
        timeline = [e["event"] for e in (rep.get("fleet") or {}).get("timeline", [])]
        series = (rep.get("fleet_timeline") or {}).get("targets") or {}
        if ("fleet_replica_loss" not in timeline
                or "fleet_replica_ready" not in timeline or not series):
            fail(f"fleet: the report's fleet timeline {timeline}, series {series}")
        line["report"] = {"timeline": {e: timeline.count(e) for e in sorted(set(timeline))},
                          "tsdb_targets": {t: s["samples"] for t, s in series.items()},
                          "rollout": rep["fleet"].get("rollout")}
    line["launches"] = launches
    print("fleet", json.dumps(line), flush=True)
    if not launches.get("conv3d_fwd"):
        fail(f"fleet: no conv3d_fwd launch on the fleet path: {launches}")
    return {"launches": launches}


# --- dp: data-parallel training across processes --------------------------

DP_RANKS = 2
DP_BATCH = 256  # the global batch: 128 rows per rank
DP_STEPS = 4
DP_CKPT_EVERY = 2
DP_NCCL_BATCH = 128
DP_NCCL_STEPS = 2
DP_TIMEOUT_S = 300  # each world's process-group timeout and wall bound
# 2-rank against 1-process at one global batch: the batch-norm statistics
# to the reference's data-mesh parity (tests/test_parallel.py), the
# parameters to Adam's bound (bf16 activations: a gradient that is rounding
# noise may take the other sign, and an early Adam update is close to
# lr x sign(g)), with the share inside the reference's rtol/atol printed.
DP_STATS_RTOL, DP_STATS_ATOL = 1e-3, 1e-4
DP_PARAM_RTOL, DP_PARAM_ATOL = 3e-4, 3e-6
DP_LOSS_RTOL = 1e-3
# Launches per step of a pod64 pallas step: 3 forward + 3 dx conv3d_fwd,
# 3 conv3d_dw; an eval batch runs 3 conv3d_fwd.
DP_STEP_LAUNCHES = {"conv3d_fwd": 6, "conv3d_dw": 3, "conv_dw_folded": 0}


def _dp_rank_main(argv: list[str]) -> int:
    """One rank of the dp phase's timed world: ``cli.main(argv)`` (the
    entry point ``python -m featurenet_tpu_torch.cli`` runs) with each
    dispatch timed by CUDA events on its stream, synchronised after it,
    and the gradient all-reduce timed on the host clock between two
    synchronisations; prints ``{"dp_timing": ...}`` after the CLI's lines."""
    import torch

    from featurenet_tpu_torch import cli
    from featurenet_tpu_torch.train import loop, steps

    step_ms, reduce_ms = [], []
    dispatch, sync = loop.Trainer.dispatch, steps.sync_gradients

    def timed_dispatch(self, batches, take):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = dispatch(self, batches, take)
        b.record()
        b.synchronize()
        step_ms.append(a.elapsed_time(b) / take)
        return out

    def timed_sync(grads, metrics):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sync(grads, metrics)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    loop.Trainer.dispatch, steps.sync_gradients = timed_dispatch, timed_sync
    rc = cli.main(argv)
    print(json.dumps({"dp_timing": {"step_ms": step_ms,
                                    "allreduce_ms": reduce_ms}}), flush=True)
    return rc


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_start(args: list[str], ranks: int, timed: bool = False,
              distributed: bool = True) -> list[subprocess.Popen]:
    """``ranks`` processes of one world on the card (torchrun's
    environment, one free port), each ``cli [--distributed] args``; the
    timed world runs each rank through ``_dp_rank_main``."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = str(_free_port())
    flags = (["--distributed", "--distributed-timeout", str(DP_TIMEOUT_S)]
             if distributed else [])
    procs = []
    for r in range(ranks):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(ranks),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        cmd = ([sys.executable, os.path.abspath(__file__), "--dp-rank"] if timed
               else _cli())
        procs.append(subprocess.Popen(cmd + flags + args, cwd=here, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def _dp_wait(procs, what: str) -> list[list[dict]]:
    """Each process's JSON lines; all must exit 0 within DP_TIMEOUT_S, and
    none is left running."""
    deadline = time.monotonic() + DP_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                fail(f"dp {what}: a rank outlived {DP_TIMEOUT_S} s")
            if p.returncode != 0:
                fail(f"dp {what}: a rank exited {p.returncode}: {out[-1500:]} "
                     f"{err[-3000:]}")
            outs.append([json.loads(ln) for ln in out.splitlines()
                         if ln.startswith("{")])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _dp_kind(records: list[dict], kind: str) -> dict:
    found = [r for r in records if r.get("kind") == kind]
    if not found:
        fail(f"dp: no {kind} record in {records[-3:]}")
    return found[-1]


def _dp_key(records: list[dict], key: str) -> dict:
    found = [r[key] for r in records if key in r]
    if not found:
        fail(f"dp: no {key} line")
    return found[-1]


def _dp_same_files(a: str, b: str, step: int) -> bool:
    import torch

    x = torch.load(os.path.join(a, f"step_{step}.pt"), weights_only=True)
    y = torch.load(os.path.join(b, f"step_{step}.pt"), weights_only=True)
    if x["step"] != y["step"] or int(x["count"]) != int(y["count"]):
        return False
    return all(torch.equal(x[g][k], y[g][k])
               for g in ("model", "mu", "nu") for k in x[g])


@contextlib.contextmanager
def _cli_precision(torch):
    """cuDNN's TF32 at PyTorch's default (on), as in a ``cli train``
    process, which never sets it; this script turns it off elsewhere."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# What a 1-process reference in this script runs under, printed beside
# each comparison with a world of `cli train` processes.
CLI_PRECISION = "cuDNN TF32 at PyTorch's default (on) on both sides"


def _dp_reference(torch, cfg, ck: str, device: str = "cuda",
                  start: int = 0) -> dict:
    """The 1-process run of ``cfg`` (streamed: its ``hbm_cache`` off) at its
    global batch on a DP_RANKS-rank resident world's global batches (rank
    r's rows as its own draws gave them, at rows ``[r·B/W, (r+1)·B/W)``),
    from step ``start`` (restored from ``cfg.checkpoint_dir``) on, held
    against the world's step-``cfg.total_steps`` checkpoint in ``ck``;
    under ``_cli_precision``, as the world's processes run."""
    from featurenet_tpu_torch.data.offline import VoxelCacheDataset
    from featurenet_tpu_torch.train.loop import Trainer
    from featurenet_tpu_torch.train.steps import StepDraws, gather_rows

    blocks = []
    for r in range(DP_RANKS):
        ds = VoxelCacheDataset(cfg.data_cache, cfg.global_batch, "train",
                               cfg.test_fraction, seed=cfg.seed,
                               num_hosts=DP_RANKS, host_id=r)
        vox, lab, _ = ds.materialize_split(multiple_of=DP_RANKS,
                                           num_shards=DP_RANKS, shard_id=r)
        blocks.append((torch.from_numpy(vox).to(device),
                       torch.from_numpy(lab).to(device),
                       StepDraws(cfg, 1, device, rows=len(lab),
                                 num_shards=DP_RANKS, shard=r)))
    trainer = Trainer(cfg, device=device)
    if start and trainer.resume_if_available() != start:
        fail(f"dp reference: {cfg.checkpoint_dir} does not restore step {start}")
    _reset_counts()
    metrics = None
    with _cli_precision(torch):
        for s in range(start, cfg.total_steps):
            parts = []
            for data, labels, draws in blocks:
                draws.seed(s, 1)
                parts.append(gather_rows(data, labels, draws.draw_rows(0)))
            metrics = trainer.step({k: torch.cat([p[k] for p in parts])
                                    for k in parts[0]})
        if device == "cuda":
            torch.cuda.synchronize()
    launches = _read_counts()
    world = torch.load(os.path.join(ck, f"step_{cfg.total_steps}.pt"),
                       weights_only=True)
    mine = trainer.state.model.state_dict()
    lr = sum(float(trainer.state.optimizer.schedule(s))
             for s in range(start, cfg.total_steps))
    bound = 2.0 * lr + 1e-6
    stats = {"max_rel_of_scale": 0.0, "max_abs": 0.0}
    params = {"max_rel_of_scale": 0.0, "max_abs": 0.0, "outside_ref_tol": 0,
              "entries": 0}
    ok = True
    for k, want in mine.items():
        got = world["model"][k].to(want.device)
        diff = (got - want).abs()
        # Relative to the tensor's scale: an entry near 0 has no scale of
        # its own.
        rel = float(diff.max() / want.abs().max().clamp_min(1e-30))
        is_stat = k.endswith((".mean", ".var"))
        row = stats if is_stat else params
        row["max_abs"] = max(row["max_abs"], float(diff.max()))
        row["max_rel_of_scale"] = max(row["max_rel_of_scale"], rel)
        if is_stat:
            ok &= bool((diff <= DP_STATS_ATOL + DP_STATS_RTOL * want.abs()).all())
        else:
            ok &= float(diff.max()) <= bound
            params["outside_ref_tol"] += int(
                (diff > DP_PARAM_ATOL + DP_PARAM_RTOL * want.abs()).sum())
            params["entries"] += diff.numel()
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "params": params, "param_bound": bound, "stats": stats,
           "launches": launches, "ok": ok}
    del trainer, blocks
    torch.cuda.empty_cache()
    return out


def dp_phase(torch, seed: int, cache: str, tmp: str, smi_line: str) -> dict:
    """pod64 at full width under pallas, data-parallel over two ranks of
    ``cli --distributed train`` sharing the card over gloo: the timed
    world's steps, its lockstep checkpoints and exact eval; a resume of its
    step-2 checkpoint against its step 4; a 1-rank nccl world against the
    run without a process group; the 1-process run at the global batch."""
    import shutil

    from featurenet_tpu_torch.data.offline import VoxelCacheDataset

    t0 = time.perf_counter()
    ck, run = os.path.join(tmp, "dp_ck"), os.path.join(tmp, "dp_run")
    common = ["train", "--config", "pod64", "--conv-backend", "pallas",
              "--data-cache", cache, "--hbm-cache", "--seed", str(seed)]
    world = _dp_wait(_dp_start(
        common + ["--global-batch", str(DP_BATCH), "--total-steps",
                  str(DP_STEPS), "--checkpoint-every", str(DP_CKPT_EVERY),
                  "--checkpoint-dir", ck, "--run-dir", run],
        DP_RANKS, timed=True), "world")
    world_s = time.perf_counter() - t0

    # The resume of step 2 (a 2-rank world of the plain CLI) beside a 1-rank
    # nccl world and the same run without a process group.
    resumed = os.path.join(tmp, "dp_resumed")
    os.makedirs(resumed)
    for name in (f"step_{DP_CKPT_EVERY}.pt", f"checksum.{DP_CKPT_EVERY}.json",
                 "config.json"):
        shutil.copy(os.path.join(ck, name), os.path.join(resumed, name))
    one = common + ["--global-batch", str(DP_NCCL_BATCH), "--total-steps",
                    str(DP_NCCL_STEPS), "--checkpoint-every", str(DP_NCCL_STEPS)]
    nccl_ck, plain_ck = os.path.join(tmp, "dp_nccl"), os.path.join(tmp, "dp_plain")
    t1 = time.perf_counter()
    procs = (_dp_start(["train", "--checkpoint-dir", resumed, "--run-dir",
                        os.path.join(tmp, "dp_resumed_run")], DP_RANKS)
             + _dp_start(one + ["--checkpoint-dir", nccl_ck, "--run-dir",
                                os.path.join(tmp, "dp_nccl_run")], 1)
             + _dp_start(one + ["--checkpoint-dir", plain_ck], 1,
                         distributed=False))
    outs = _dp_wait(procs, "resume and nccl")
    side_s = time.perf_counter() - t1
    resume, nccl, plain = outs[:DP_RANKS], outs[DP_RANKS], outs[DP_RANKS + 1]

    from featurenet_tpu_torch.config import get_config

    t2 = time.perf_counter()
    ref = _dp_reference(torch, get_config(
        "pod64", global_batch=DP_BATCH, data_cache=cache, seed=seed,
        total_steps=DP_STEPS), ck)
    ref_s = time.perf_counter() - t2

    train = [_dp_kind(r, "train") for r in world]
    evals = [_dp_kind(r, "eval") for r in world]
    keys = ("loss", "accuracy", "grad_norm")
    metrics_equal = all({k: t[k] for k in keys} == {k: train[0][k] for k in keys}
                        for t in train)
    evals_equal = all({k: v for k, v in e.items() if k != "batches"}
                      == {k: v for k, v in evals[0].items() if k != "batches"}
                      for e in evals)
    held_out = len(VoxelCacheDataset(cache, DP_BATCH, "test"))
    launches = [{k: _dp_key(r, "launches")[k] for k in DP_STEP_LAUNCHES}
                for r in world]
    want = [{k: DP_STEPS * n + (3 * e["batches"] if k == "conv3d_fwd" else 0)
             for k, n in DP_STEP_LAUNCHES.items()} for e in evals]
    timing = [_dp_key(r, "dp_timing") for r in world]
    printed = [_dp_key(r, "distributed")["backend"] for r in world]
    starts = []
    for r in range(DP_RANKS):
        with open(os.path.join(run, "events.jsonl" if r == 0
                               else f"events.{r}.jsonl")) as fh:
            starts += [json.loads(ln) for ln in fh if '"loop_start"' in ln]
    nccl_mesh = None
    with open(os.path.join(tmp, "dp_nccl_run", "events.jsonl")) as fh:
        nccl_mesh = [json.loads(ln) for ln in fh if '"loop_start"' in ln][-1]["mesh"]
    resume_bitwise = _dp_same_files(resumed, ck, DP_STEPS) and all(
        {k: v for k, v in _dp_kind(r, "eval").items() if k != "batches"}
        == {k: v for k, v in evals[0].items() if k != "batches"} for r in resume)
    nccl_bitwise = (_dp_same_files(nccl_ck, plain_ck, DP_NCCL_STEPS)
                    and {k: _dp_kind(nccl, "train")[k] for k in keys}
                    == {k: _dp_kind(plain, "train")[k] for k in keys})
    loss_rel = abs(train[0]["loss"] - ref["metrics"]["loss"]) / abs(
        ref["metrics"]["loss"])
    out = {
        "world": DP_RANKS, "backend": starts[0]["mesh"].get("backend"),
        "backend_printed_by_rank": printed,
        "mesh": starts[0]["mesh"], "loop_starts": len(starts),
        "config": "pod64 R=64 features 32/32/64/64 kernels 7/5/3/3 pallas, "
                  f"global batch {DP_BATCH} ({DP_BATCH // DP_RANKS} per rank), "
                  f"{DP_STEPS} resident steps, checkpoints every {DP_CKPT_EVERY}",
        "device_ms_per_step_by_rank": [
            statistics.median(t["step_ms"][1:]) for t in timing],
        "step_ms_by_rank": [t["step_ms"] for t in timing],
        "allreduce_ms_per_step_by_rank": [
            statistics.median(t["allreduce_ms"][1:]) for t in timing],
        "allreduce_note": "gloo between two ranks sharing one card goes "
                          "through the host: not NCCL's time; host clock "
                          "between two synchronisations, the gradients and "
                          "metrics in one flat buffer",
        "metrics_bitwise_across_ranks": metrics_equal,
        "metrics": {k: train[0][k] for k in keys},
        "eval_bitwise_across_ranks": evals_equal,
        "n_evaluated": evals[0]["samples"], "held_out": held_out,
        "eval_accuracy": evals[0]["accuracy"],
        "eval_batches_by_rank": [e["batches"] for e in evals],
        "resume_bitwise": resume_bitwise,
        "nccl_1rank_backend": nccl_mesh.get("backend"),
        "nccl_1rank_bitwise_no_group": nccl_bitwise,
        "vs_1process": {"precision": CLI_PRECISION,
                        "loss_rel": loss_rel, "loss_rtol": DP_LOSS_RTOL,
                        "params": ref["params"], "param_bound": ref["param_bound"],
                        "param_ref_tol": [DP_PARAM_RTOL, DP_PARAM_ATOL],
                        "stats": ref["stats"],
                        "stats_tol": [DP_STATS_RTOL, DP_STATS_ATOL]},
        "launches_by_rank": launches, "launches_want": want,
        "launches_resume_by_rank": [_dp_key(r, "launches") for r in resume],
        "launches_nccl": _dp_key(nccl, "launches"),
        "launches_plain": _dp_key(plain, "launches"),
        "launches_1process": ref["launches"],
        "walls_s": {"world": world_s, "resume_nccl_plain": side_s,
                    "reference": ref_s},
        "nvidia_smi": smi_line,
    }
    print("dp", json.dumps(out), flush=True)
    if (out["backend"] != "gloo" or printed != ["gloo"] * DP_RANKS
            or out["mesh"]["processes"] != DP_RANKS):
        fail(f"dp: mesh {out['mesh']}")
    if (out["nccl_1rank_backend"] != "nccl"
            or _dp_key(nccl, "distributed")["backend"] != "nccl"):
        fail(f"dp: the 1-rank world ran {nccl_mesh}")
    if not (metrics_equal and evals_equal):
        fail("dp: the ranks' metrics or evals differ")
    if out["n_evaluated"] != held_out:
        fail(f"dp: evaluated {out['n_evaluated']} of {held_out} held-out rows")
    if not resume_bitwise:
        fail("dp: the resumed run is not bitwise the unbroken one")
    if not nccl_bitwise:
        fail("dp: the 1-rank nccl world is not bitwise the run without one")
    if launches != want:
        fail(f"dp: launches {launches}, want {want}")
    if not ref["ok"] or loss_rel > DP_LOSS_RTOL:
        fail(f"dp: 2 ranks against 1 process: {out['vs_1process']}")
    return {"launches": {k: sum(c.get(k, 0) for c in launches) for k in
                         DP_STEP_LAUNCHES}, **out}


# --- elastic: the world shrinks on a host's loss and grows back ------------

ELASTIC_STEPS = 5  # generation 0: step 1; 1: steps 2-4; 2: step 5
ELASTIC_FAULTS = "host_loss@step=1"  # the last rank dies after step 1's save
ELASTIC_RESTART_EVERY = 3  # the 1-rank generation's planned exit at step 4
ELASTIC_TIMEOUT_S = 300
ELASTIC_SAMPLE_S = 0.02


def _json_objects(text: str) -> list[dict]:
    """The JSON objects in ``text``, in order: processes that share one
    stdout and write unbuffered may interleave their lines."""
    dec, out, i = json.JSONDecoder(), [], 0
    while (i := text.find("{", i)) >= 0:
        try:
            obj, i = dec.raw_decode(text, i)
            out.append(obj)
        except ValueError:
            i += 1
    return out


class _ChildWatch:
    """The children of process ``pid`` sampled from /proc every
    ELASTIC_SAMPLE_S on a thread: per child its generation and rank (from
    its command line), when it was first seen, when it exited (first seen a
    zombie, or gone), when it was reaped (gone from /proc) and when it was
    first seen holding a GPU device node; the samples in which children of
    two generations were alive, or held the card, at once; and the GPU
    device nodes ``pid`` itself ever held."""

    def __init__(self, pid: int):
        self.pid = pid
        self.kids: dict[int, dict] = {}
        self.own_fds: set[str] = set()
        self.overlap: list[tuple[float, list]] = []
        self.card_overlap: list[tuple[float, list]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _children(self) -> dict[int, str]:
        out = {}
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            try:
                with open(f"/proc/{name}/stat") as fh:
                    fields = fh.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == self.pid:
                out[int(name)] = fields[0]
        return out

    @staticmethod
    def _place(pid: int) -> tuple[int | None, int | None]:
        """(generation, rank) from the child's command line; (None, None)
        between its fork and its exec."""
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                argv = fh.read().decode(errors="replace").split("\0")
        except OSError:
            return None, None

        def flag(name):
            return int(argv[argv.index(name) + 1]) if name in argv else None

        return flag("--elastic-generation"), flag("--elastic-rank")

    def _run(self):
        while not self._stop.is_set():
            t = time.time()
            self.own_fds.update(_gpu_fds(self.pid))
            now = self._children()
            alive, holding = set(), set()
            for pid, state in now.items():
                k = self.kids.setdefault(pid, {
                    "generation": None, "rank": None, "seen_t": t,
                    "exit_t": None, "gone_t": None, "card_t": None})
                if k["generation"] is None:
                    k["generation"], k["rank"] = self._place(pid)
                if state == "Z":
                    k["exit_t"] = k["exit_t"] or t
                    continue
                if k["generation"] is None:
                    continue
                alive.add(k["generation"])
                if _gpu_fds(pid):
                    k["card_t"] = k["card_t"] or t
                    holding.add(k["generation"])
            for pid, k in self.kids.items():
                if pid not in now and k["gone_t"] is None:
                    k["gone_t"] = t
                    k["exit_t"] = k["exit_t"] or t
            if len(alive) > 1:
                self.overlap.append((t, sorted(alive)))
            if len(holding) > 1:
                self.card_overlap.append((t, sorted(holding)))
            self._stop.wait(ELASTIC_SAMPLE_S)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def kill_all(self) -> None:
        for pid, k in self.kids.items():
            if k["gone_t"] is None:
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass


def _written_t(ck: str, step: int) -> float:
    """When checkpoint step ``step`` was written whole (its last file)."""
    return max(os.stat(os.path.join(ck, f)).st_mtime
               for f in (f"step_{step}.pt", f"checksum.{step}.json"))


def _restored_cli_step(torch, ck: str) -> int:
    """``cli train`` in this process on checkpoint directory ``ck`` for a
    segment of one step (then its planned exit, 75), under
    ``_cli_precision``, as a ``cli train`` process runs; returns the exit
    code. Its output lines are dropped."""
    import io

    from featurenet_tpu_torch import cli

    try:
        with _cli_precision(torch), contextlib.redirect_stdout(io.StringIO()):
            code = cli.main(["train", "--checkpoint-dir", ck, "--restart-every",
                             "1", "--supervised-child"])
    except SystemExit as e:
        code = e.code
    torch.cuda.empty_cache()
    return code


def elastic_phase(torch, seed: int, cache: str, tmp: str, smi_line: str) -> dict:
    """pod64 at full width under pallas, as an elastic world of two ranks
    sharing the card over gloo that loses rank 1 after step 1, re-forms at
    one rank, grows back to two at the planned boundary of step 4 and
    finishes its 5 steps; the first step of each re-formed generation
    against a run restored from the same checkpoint; the recovery's and
    the grow boundary's seconds, split."""
    import dataclasses
    import shutil

    from featurenet_tpu_torch.config import config_from_dict

    here = os.path.dirname(os.path.abspath(__file__))
    ck, run = os.path.join(tmp, "elastic_ck"), os.path.join(tmp, "elastic_run")
    argv = _cli("--distributed-timeout", str(DP_TIMEOUT_S), "train", "--elastic",
                "--world-size", str(DP_RANKS), "--config", "pod64",
                "--conv-backend", "pallas", "--data-cache", cache, "--hbm-cache",
                "--seed", str(seed), "--global-batch", str(DP_BATCH),
                "--total-steps", str(ELASTIC_STEPS), "--checkpoint-every", "1",
                "--keep-checkpoints", str(ELASTIC_STEPS + 1),
                "--restart-every", str(ELASTIC_RESTART_EVERY),
                "--inject-faults", ELASTIC_FAULTS,
                "--checkpoint-dir", ck, "--run-dir", run)
    out_path, err_path = (os.path.join(tmp, f"elastic.{s}") for s in ("out", "err"))
    t0 = time.perf_counter()
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(argv, cwd=here, stdout=out, stderr=err)
        watch = _ChildWatch(proc.pid)
        try:
            rc = proc.wait(timeout=ELASTIC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            watch.kill_all()
            watch.stop()
    run_s = time.perf_counter() - t0
    with open(out_path) as fh:
        text = fh.read()
    with open(err_path) as fh:
        err_text = fh.read()
    if rc != 0:
        fail(f"elastic: cli train --elastic exited {rc}: {text[-2000:]} "
             f"{err_text[-3000:]}")
    recs = _json_objects(text)
    result = recs[-1].get("elastic") if recs else None
    events = _run_events(run)
    spawns = [e for e in events
              if e["ev"] == "supervisor" and e.get("phase") == "spawn"]
    place = {e["pid"]: (e["generation"], e["rank"]) for e in spawns}
    gens = sorted({g for g, _ in place.values()})
    pids = {g: sorted((r, p) for p, (gg, r) in place.items() if gg == g)
            for g in gens}

    def of(pid, ev, **match):
        return [e for e in events if e.get("pid") == pid and e["ev"] == ev
                and all(e.get(k) == v for k, v in match.items())]

    starts = {p: of(p, "loop_start") for p in place}
    world = {g: [starts[p][0]["mesh"]["processes"] if starts[p] else None
                 for _, p in pids[g]] for g in gens}
    first = {g: [starts[p][0]["step"] if starts[p] else None
                 for _, p in pids[g]] for g in gens}
    reasons = [e["reason"] for e in events if e["ev"] == "mesh_reform"]
    batches = sorted({e["global_batch"] for e in events if e["ev"] == "loop_start"})
    with open(os.path.join(run, "membership.json")) as fh:
        membership = json.load(fh)
    run_end = [e["step"] for e in events if e["ev"] == "run_end"]

    # Launches: each process's line, by its pid; the killed generation 0's
    # ranks may print none (SIGKILL) or one over a step cut short.
    lines = {r["pid"]: r["launches"] for r in recs if "launches" in r and "pid" in r}
    launches, want, killed = {}, {}, {}
    for p, (g, r) in sorted(place.items(), key=lambda kv: kv[1]):
        name = f"gen{g}_rank{r}"
        if g == 0:
            if p in lines:
                killed[name] = {k: lines[p][k] for k in DP_STEP_LAUNCHES}
            continue
        end = of(p, "loop_end")
        steps = end[-1]["step"] - starts[p][0]["step"] if end and starts[p] else None
        evals = sum(int(e.get("batches", 0)) for e in of(p, "metrics", kind="eval"))
        launches[name] = ({k: lines[p][k] for k in DP_STEP_LAUNCHES}
                          if p in lines else None)
        want[name] = {k: (steps or 0) * n + (3 * evals if k == "conv3d_fwd" else 0)
                      for k, n in DP_STEP_LAUNCHES.items()}

    # The first step of each re-formed generation against a run restored
    # from the checkpoint it restored.
    if (gens != [0, 1, 2] or None in first[1] + first[2]
            or first[2][0] + 1 != ELASTIC_STEPS
            or set(place) - set(watch.kids)):
        fail(f"elastic: generations {gens}, worlds {world}, first steps "
             f"{first}, pids {sorted(place)} sampled {sorted(watch.kids)}")
    s1, s2 = first[1][0], first[2][0]

    def restored_copy(step: int, name: str) -> str:
        d = os.path.join(tmp, name)
        os.makedirs(d)
        for f in (f"step_{step}.pt", f"checksum.{step}.json", "config.json"):
            shutil.copy(os.path.join(ck, f), os.path.join(d, f))
        return d

    t1 = time.perf_counter()
    one_ck = restored_copy(s1, "elastic_ref1")
    one_rc = _restored_cli_step(torch, one_ck)
    one_s = time.perf_counter() - t1
    if one_rc != 75:  # the planned exit after its one-step segment
        fail(f"elastic: the restored 1-process cli train exited {one_rc}")
    one_bitwise = _dp_same_files(one_ck, ck, s1 + 1)
    with open(os.path.join(ck, "config.json")) as fh:
        saved = config_from_dict(json.load(fh))
    # Generation 2's one step is the run's last: the reference runs the
    # same schedule to the same end.
    cfg = dataclasses.replace(
        saved, checkpoint_dir=restored_copy(s2, "elastic_ref2"),
        hbm_cache=False, elastic=False, min_world_size=1,
        restart_every_steps=None, inject_faults=None, heartbeat_file=None,
        run_dir=None).validate()
    if cfg.total_steps != ELASTIC_STEPS:
        fail(f"elastic: the run's config holds {cfg.total_steps} steps")
    t2 = time.perf_counter()
    two = _dp_reference(torch, cfg, ck, start=s2)
    two_s = time.perf_counter() - t2
    world_loss = [e["loss"] for _, p in pids[2]
                  for e in of(p, "metrics", kind="train", step=s2 + 1)]
    loss_rel = (abs(world_loss[0] - two["metrics"]["loss"])
                / abs(two["metrics"]["loss"])) if world_loss else None

    # The recovery from the kill to generation 1's first step, and the grow
    # boundary from generation 1's last step to generation 2's first.
    kid = watch.kids
    lost_pid = pids[0][1][1]
    t_fault = os.stat(os.path.join(run, "fault_host_loss.fired")).st_mtime
    gen0_gone = max(kid[p]["gone_t"] for _, p in pids[0])
    spawn_t = {g: min(e["t"] for e in spawns if e["generation"] == g) for g in gens}
    backoff = [e for e in events if e["ev"] == "supervisor"
               and e.get("phase") == "backoff"]

    def restore(pid):
        spans = of(pid, "span", name="checkpoint_restore")
        return spans[0]["t"], spans[-1]["t"] + spans[-1]["dur_s"]

    p1 = pids[1][0][1]
    r1_start, r1_end = restore(p1)
    step1_t = _written_t(ck, s1 + 1)
    recovery = {
        "detection_s": kid[lost_pid]["gone_t"] - t_fault,
        "kill_s": gen0_gone - kid[lost_pid]["gone_t"],
        "backoff_s": spawn_t[1] - gen0_gone,
        "backoff_sleep_s": backoff[0]["delay_s"] if backoff else None,
        "cold_start_s": r1_start - spawn_t[1],
        "restore_s": r1_end - r1_start,
        "first_step_s": step1_t - r1_end,
        "total_s": step1_t - t_fault,
    }
    p2 = [p for _, p in pids[2]]
    r2 = [restore(p) for p in p2]
    step2_t = min(e["t"] for p in p2
                  for e in of(p, "metrics", kind="train", step=s2 + 1))
    last1_t = _written_t(ck, s2)
    grow = {
        "exit_s": kid[p1]["exit_t"] - last1_t,
        "detection_s": spawn_t[2] - kid[p1]["exit_t"],
        "cold_start_s": max(a for a, _ in r2) - spawn_t[2],
        "restore_s": max(b for _, b in r2) - max(a for a, _ in r2),
        "first_step_s": step2_t - max(b for _, b in r2),
        "total_s": step2_t - last1_t,
    }
    spawn_after_exit = {
        f"gen{g}": min(kid[p]["seen_t"] for _, p in pids[g])
        - max(kid[p]["exit_t"] for _, p in pids[g - 1]) for g in gens[1:]}
    out = {
        "config": "pod64 R=64 features 32/32/64/64 kernels 7/5/3/3 pallas, "
                  f"global batch {DP_BATCH}, {ELASTIC_STEPS} resident steps, "
                  f"a checkpoint every step, --restart-every "
                  f"{ELASTIC_RESTART_EVERY}, {ELASTIC_FAULTS}, ranks on one "
                  "card over gloo",
        "result": result, "mesh_reform_reasons": reasons,
        "worlds": world, "first_steps": first, "global_batches": batches,
        "run_end": run_end, "membership": membership,
        "recovery_s": recovery, "grow_boundary_s": grow,
        "next_spawn_after_last_exit_s": spawn_after_exit,
        "overlap_samples": watch.overlap[:5],
        "card_overlap_samples": watch.card_overlap[:5],
        "children_seen_holding_the_card": sum(
            k["card_t"] is not None for k in kid.values()),
        "coordinator_gpu_fds": sorted(watch.own_fds),
        "launches_by_process": launches, "launches_want": want,
        "launches_killed_generation": killed,
        "one_rank_vs_restored_cli_bitwise": one_bitwise,
        "two_ranks_vs_1process": {
            "precision": CLI_PRECISION, "step": s2 + 1, "loss_rel": loss_rel, "loss_rtol": DP_LOSS_RTOL,
            "params": two["params"], "param_bound": two["param_bound"],
            "param_ref_tol": [DP_PARAM_RTOL, DP_PARAM_ATOL],
            "stats": two["stats"], "stats_tol": [DP_STATS_RTOL, DP_STATS_ATOL]},
        "walls_s": {"elastic_run": run_s, "restored_cli": one_s,
                    "reference_1process": two_s},
        "nvidia_smi": smi_line,
    }
    print("elastic", json.dumps(out), flush=True)
    print("elastic_recovery", json.dumps({
        "recovery_s": recovery, "grow_boundary_s": grow,
        "nvidia_smi": smi_line}), flush=True)
    if (not result or result["exit_code"] != 0 or result["losses"] != 1
            or result["rejoins"] != 1 or result["planned"] < 1):
        fail(f"elastic: the verdict {result}")
    if reasons != ["start", "host_loss", "host_rejoin"]:
        fail(f"elastic: mesh_reform reasons {reasons}")
    if world != {0: [2, 2], 1: [1], 2: [2, 2]} or batches != [DP_BATCH]:
        fail(f"elastic: worlds {world}, global batches {batches}")
    if (membership["world_size"] != DP_RANKS
            or run_end != [ELASTIC_STEPS] * DP_RANKS):
        fail(f"elastic: membership {membership}, run_end at {run_end}")
    if launches != want:
        fail(f"elastic: launches {launches}, want {want}")
    if (watch.overlap or watch.card_overlap or watch.own_fds
            or min(spawn_after_exit.values()) <= 0
            or not out["children_seen_holding_the_card"]):
        fail(f"elastic: generations overlapped or the coordinator held the "
             f"card: {out}")
    if not one_bitwise:
        fail("elastic: the 1-rank generation's first step is not bitwise the "
             "restored one-process run's")
    if not two["ok"] or loss_rel is None or loss_rel > DP_LOSS_RTOL:
        fail(f"elastic: 2 ranks against 1 process: {out['two_ranks_vs_1process']}")
    total = {k: sum(c[k] for c in list(launches.values()) + list(killed.values())
                    if c) for k in DP_STEP_LAUNCHES}
    return {"launches": total, **out}


def _kernel_entry(name, source, replaces, rows, launches_by_path):
    """A kernel's figures: ``ms``, ``plain_ms``, ``bound_ms`` and
    ``library_ms`` sum its "train" rows (sprint64's step), the ``dp_``
    ones its "dp" rows (one pod64 rank's step); the error is the largest
    of both."""
    main = [r for r in rows if r["path"] == "train"]
    dp = [r for r in rows if r["path"] == "dp"]

    def sums(rs, prefix=""):
        return {f"{prefix}ms": sum(r["kernel_ms"] for r in rs),
                f"{prefix}plain_ms": sum(r["plain_ms"] for r in rs),
                f"{prefix}bound_ms": sum(r["bound_ms"] for r in rs),
                f"{prefix}bound_by": "operations" if all(
                    r["bound_by"] == "operations" for r in rs) else "bytes",
                f"{prefix}library_ms": sum(r["library_ms"] for r in rs)}

    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches_by_path.values()),
        "launches_by_path": launches_by_path,
        "max_abs_err": max(r["max_abs_err"] for r in main + dp),
        **sums(main), **(sums(dp, "dp_") if dp else {}),
        "shapes": rows,
    }


def main() -> int:
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of the dp phase's world
        return _dp_rank_main(sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from featurenet_tpu_torch.ops import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "not available"
    print(f"device: {name} x{torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)

    from featurenet_tpu_torch import native

    t0 = time.perf_counter()
    report = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    native_info = native.build()  # raises if g++ cannot build it
    print(f"build native: {native_info['seconds']:.2f} s"
          f"{' (cached)' if native_info['cached'] else ''}", flush=True)
    for kname, r in report.items():
        info = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "spill" in ln or ln == "cached"]
        print(f"build {kname}: {r['seconds']:.2f} s; " + " | ".join(info), flush=True)

    walls = {}

    def phase(name, fn, *a):
        t = time.perf_counter()
        result = fn(*a)
        walls[name] = time.perf_counter() - t
        print(f"phase {name}: {walls[name]:.1f} s", flush=True)
        return result

    rows = phase("kernels", check_kernels, torch, args.seed)
    _reset_counts()
    serve = phase("serve", serve_phase, torch, args.seed)
    graphs = phase("graphs", graphs_phase, torch, args.seed, smi_line)
    reload = phase("reload", reload_phase, torch, args.seed, smi_line)
    wire = phase("wire", wire_phase, torch, args.seed, smi_line)["launches"]
    phase("data", host_generation, torch, args.seed, TRAIN_WORKERS)
    train = {b: phase(f"train_{b}", train_phase, torch, args.seed, b)
             for b in ("pallas", "hybrid_dw", "xla")}
    ckpt = phase("checkpoint", checkpoint_phase, torch, args.seed,
                 train["pallas"]["device_step_ms"], smi_line)
    phase("cli", cli_phase, args.seed)
    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".data")
    os.makedirs(data_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=data_dir) as tmp:
        cache_dir = os.path.join(tmp, "cls64")
        cache = phase("cache", cache_phase, torch, args.seed, smi_line,
                      cache_dir)["runs"]
        robust = phase("robust", robust_phase, torch, args.seed, cache_dir,
                       smi_line)["launches"]
        rungs = phase("precision", precision_phase, torch, args.seed, train,
                      graphs, smi_line)["launches"]
        supervised = phase("supervise", supervise_phase, args.seed, cache_dir,
                           smi_line)["launches"]
        report_tmp = os.path.join(tmp, "report")
        os.makedirs(report_tmp)
        report_out = phase("report", report_phase, torch, args.seed,
                           cache_dir, report_tmp, smi_line)
        reported = report_out["launches"]
        quality = phase("quality", quality_phase, torch, args.seed,
                        report_out["checkpoint"], smi_line)["launches"]
        incident = phase("incident", incident_phase, torch, args.seed,
                         smi_line)["launches"]
        fleet = phase("fleet", fleet_phase, torch, args.seed,
                      report_out["checkpoint"], smi_line)["launches"]
        dp = phase("dp", dp_phase, torch, args.seed, cache_dir, tmp,
                   smi_line)["launches"]
        elastic = phase("elastic", elastic_phase, torch, args.seed, cache_dir,
                        tmp, smi_line)["launches"]
    robustness = phase("ood", ood_phase, torch, args.seed, native_info,
                       smi_line)["launches"]
    seg = phase("seg", seg_phase, torch, args.seed, smi_line)["launches"]
    print("phase_walls", json.dumps(walls), flush=True)

    # ms, plain_ms, library_ms and bound_ms sum one train step's shapes
    # (batch 256): conv3d_fwd its 3 forward + 3 dx convs (not the serving
    # rows), conv3d_dw and conv_dw_folded (bf16) their 3 weight gradients;
    # the dp_ figures one pod64 rank's step (128 rows). Launches are the
    # counts of each main-path run.
    tp, th = train["pallas"]["launches"], train["hybrid_dw"]["launches"]
    tx, tc = train["xla"]["launches"], ckpt["launches"]
    cached = {k: cache[k]["launches"] for k in cache}
    kernels = [
        _kernel_entry("conv3d_fwd", "featurenet_tpu_torch/ops/csrc/conv3d_fwd.cu",
                      "featurenet_tpu/ops/conv3d.py:160", rows["conv3d_fwd"],
                      {"serve": serve["conv3d_fwd_launches"],
                       "reload": reload["launches"]["conv3d_fwd"],
                       "wire": wire["conv3d_fwd"],
                       "train_pallas": tp["conv3d_fwd"],
                       "train_hybrid_dw": th["conv3d_fwd"],
                       "train_xla": tx["conv3d_fwd"],
                       "checkpoint": tc["conv3d_fwd"],
                       **{k: v["conv3d_fwd"] for k, v in cached.items()},
                       "robust": robust["conv3d_fwd"],
                       "supervise": supervised["conv3d_fwd"],
                       "report": reported["conv3d_fwd"],
                       "quality": quality["conv3d_fwd"],
                       "incident": incident["conv3d_fwd"],
                       "fleet": fleet["conv3d_fwd"],
                       "dp": dp["conv3d_fwd"],
                       "elastic": elastic["conv3d_fwd"],
                       **{k: v["conv3d_fwd"] for k, v in rungs.items()},
                       **{k: v["conv3d_fwd"] for k, v in robustness.items()},
                       "seg": seg["conv3d_fwd"]}),
        _kernel_entry("conv3d_dw", "featurenet_tpu_torch/ops/csrc/conv3d_dw.cu",
                      "featurenet_tpu/ops/conv3d.py:192", rows["conv3d_dw"],
                      {"train_pallas": tp["conv3d_dw"],
                       "train_xla": tx["conv3d_dw"],
                       "checkpoint": tc["conv3d_dw"],
                       **{k: v["conv3d_dw"] for k, v in cached.items()},
                       "robust": robust["conv3d_dw"],
                       "supervise": supervised["conv3d_dw"],
                       "report": reported["conv3d_dw"],
                       "dp": dp["conv3d_dw"],
                       "elastic": elastic["conv3d_dw"],
                       **{k: v["conv3d_dw"] for k, v in rungs.items()
                          if k.startswith("train")},
                       "seg": seg["conv3d_dw"]}),
        _kernel_entry("conv_dw_folded",
                      "featurenet_tpu_torch/ops/csrc/conv_dw_folded.cu",
                      "featurenet_tpu/ops/conv_dw.py:163", rows["conv_dw_folded"],
                      {"train_hybrid_dw": th["conv_dw_folded"],
                       "train_xla": tx["conv_dw_folded"],
                       "checkpoint": tc["conv_dw_folded"],
                       **{k: v["conv_dw_folded"] for k, v in cached.items()},
                       "robust": robust["conv_dw_folded"],
                       "supervise": supervised.get("conv_dw_folded", 0),
                       "report": reported.get("conv_dw_folded", 0),
                       "dp": dp["conv_dw_folded"],
                       "elastic": elastic["conv_dw_folded"],
                       **{k: v["conv_dw_folded"] for k, v in rungs.items()
                          if k.startswith("train")},
                       "seg": seg["conv_dw_folded"]}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"nvidia-smi: {smi_line}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
