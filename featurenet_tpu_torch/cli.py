"""Command line for the PyTorch port.

    python -m featurenet_tpu_torch.cli export-data --out .data/c \
        [--per-class 1000 --resolution 64 --seed 0 --param-range mid|tails|LO,HI \
         --mesh-pose none|remesh|so3 --margin-jitter LO,HI]
    python -m featurenet_tpu_torch.cli export-seg-data --out .data/seg64 \
        [--num-parts 2400 --resolution 64 --num-features 3 --seed 0 \
         --label-order canonical|generation]
    python -m featurenet_tpu_torch.cli export-stl-data --out .data/stl \
        [--per-class 10 --resolution 64 --seed 0] \
        [--seg --num-parts 2400 --num-features 3 \
         --label-order canonical|generation]
    python -m featurenet_tpu_torch.cli build-cache --stl-root .data/stl \
        --out .data/c [--resolution 64 --workers N]
    python -m featurenet_tpu_torch.cli eval-ood --checkpoint-dir CK \
        [--per-class 50 --seg-parts 60 --seed 777 --families rotation,noise \
         --canonicalize --tta --out rows.json]
    torchrun --nproc-per-node N -m featurenet_tpu_torch.cli --distributed \
        [--distributed-timeout S] train --config pod64 ...
    python -m featurenet_tpu_torch.cli train --config sprint64 --device cuda \
        [--data-cache .data/c [--hbm-cache]] [--steps-per-dispatch K] \
        [--augment-affine [--augment-affine-prob P --augment-ramp-steps N \
         --no-augment-affine-rotate --augment-scale-range LO HI \
         --augment-translate-vox T]] [--augment-noise F] \
        [--checkpoint-dir CK --checkpoint-every N --keep-checkpoints K \
         --init-from OTHER_CK --resolution R --total-steps N --global-batch B \
         --eval-batches E --conv-backend pallas|hybrid_dw|xla|fused33 \
         --train-precision fp32|bf16_master|fp16_scaled \
         --serve-precision fp32|bf16|int8 --seed S] \
        [--seg-loss balanced_ce|ce_dice|dice \
         --seg-input-context none|proj|proj_coords] \
        [--supervise --checkpoint-dir CK [--stall-timeout S --max-restarts N \
         --heartbeat-file F --restart-every N]] [--inject-faults SPEC] \
        [--elastic --checkpoint-dir CK --run-dir D [--world-size N \
         --min-world-size M --local-devices L --readmit auto|agent]] \
        [--run-dir D [--alert-rules SPEC] [--poll-device-memory]] \
        [--tb-dir T] [--profile-dir P [--profile-start 10 --profile-steps 5]]
    python -m featurenet_tpu_torch.cli serve --checkpoint-dir CK --port 0 \
        [--precision fp32|bf16|int8] [--inject-faults SPEC] \
        [--slo-p99-ms 250 | --alert-rules SPEC] [--drain] \
        [--trace-sample F] [--run-dir D] [--batch-queue-limit N] \
        [--quality [--quality-baseline B]] \
        [--capture [--capture-sample F] [--capture-dir C]]
    python -m featurenet_tpu_torch.cli pin-quality --checkpoint-dir CK \
        [--n 512 --seed 0 --batch 32 --precision P --out B]
    python -m featurenet_tpu_torch.cli replay D/capture --checkpoint-dir CK \
        [--precision P --conv-backend B --batch 32 --min-agreement 0.967 \
         --run-dir D2]
    python -m featurenet_tpu_torch.cli serve --config sprint64 --seed 0 \
        --buckets 1,4,16,64 --port 0 --device cuda
    python -m featurenet_tpu_torch.cli fleet --checkpoint-dir CK --run-dir R \
        [--replicas 2 --device cuda --buckets 1,4,16,64 --port 8000 \
         --capture [--capture-sample F] --inject-faults SPEC --drain \
         --slos SPEC --autoscale [--min-replicas 1 --max-replicas N]]
    python -m featurenet_tpu_torch.cli fleet rollout CK2 --run-dir R \
        [--min-agreement 0.967 --batch 32 --device cuda --precision P]
    python -m featurenet_tpu_torch.cli serve --weights w.npz --port 0
    python -m featurenet_tpu_torch.cli eval --checkpoint-dir CK \
        [--serve-precision fp32|bf16|int8]
    python -m featurenet_tpu_torch.cli infer --checkpoint-dir CK \
        [--precision fp32|bf16|int8] [--seg-out DIR] \
        [--run-dir D [--alert-rules SPEC]] part.stl ...
    python -m featurenet_tpu_torch.cli recalibrate --checkpoint-dir CK \
        --out-dir CK2 [--batches 64 --data-cache D]
    python -m featurenet_tpu_torch.cli programs [--config pod64] \
        [--train-precision P --serve-precision P] [--warm [--device cpu]] \
        [--run-dir D]
    python -m featurenet_tpu_torch.cli report RUN_DIR [--json] \
        [--trace t.json] [--follow [--interval S]] [--gate BASELINE] \
        [--validate] [--request TRACE_ID]
    python -m featurenet_tpu_torch.cli incident list|show RUN_DIR [ID] [--json]
    python -m featurenet_tpu_torch.cli dash RUN_DIR [--once] [--interval 2] \
        [--window-s 300] [--slos SPEC]

Every subcommand but ``report``, ``incident``, ``dash`` and the four data
commands runs on the card
unless ``--device cpu`` is given. The data commands run on the host alone
and never create a CUDA context (``export-data`` and ``build-cache`` take
``--run-dir`` for their ``export_class`` / ``build_cache_class`` and
``voxelize`` spans): ``export-seg-data`` writes multi-feature
parts with their per-voxel labels into a segmentation cache
(``data/offline.py`` ``export_seg_cache``) and prints ``{"exported": N,
"shards": S}``; ``export-data`` writes the synthetic parts
into a packed voxel cache (``data/offline.py``; ``--param-range``,
``--mesh-pose`` and ``--margin-jitter`` as ``export_synthetic_cache``
takes them) and prints ``{"exported": {class: count}, ...}``;
``export-stl-data`` writes them as an STL class tree
(``voxel_to_mesh.export_stl_tree``) and prints ``{"exported": {class:
count}}``, or with ``--seg`` (``--num-parts``, ``--num-features``,
``--label-order``) the segmentation tree of STL parts and per-voxel label
sidecars (``export_seg_stl_tree``) and prints ``{"exported": N, "kind":
"segment_stl"}``; ``build-cache`` voxelizes such a tree (or any tree of
``<class>/*.stl``) into a packed cache over ``--workers`` processes
(default: one per core) and prints ``{"built": {class: count},
"seconds": wall}``, or a segmentation tree into a segmentation cache
(``offline.build_seg_cache``) and prints ``{"built": N, "kind":
"segment", "seconds": wall}``. ``--resolution`` applies to a
classification tree (default 64); a segmentation tree's resolution is its
sidecars', and a flag that contradicts it is refused.

A segmentation run (``train --config seg64``) trains the segmenter from a
segmentation cache (``--data-cache``, ``--hbm-cache``) or from synthetic
multi-feature parts; ``--seg-loss`` and ``--seg-input-context`` override
the preset's loss and input channels (the latter is part of the model's
identity, so a resumed run refuses a change). ``eval`` of a segment
checkpoint prints ``mean_iou`` and ``per_class_iou``; ``infer`` prints one
``{"path", "voxel_counts"}`` line per part and with ``--seg-out DIR``
writes each part's label grid to ``DIR/<stem>_seg.npz`` (key ``labels``,
int8 ``[R, R, R]``); ``serve`` answers ``/predict`` and
``/predict_voxels`` with ``{"voxel_counts": ...}``.

``eval-ood`` prints the robustness report of a checkpoint (``ood.py``),
one JSON row per (family, level), and with ``--out`` also writes the rows
to a JSON file. The task comes from the checkpoint's ``config.json``: a
classifier is scored over ``--per-class`` parts of each class, and
``--canonicalize`` undoes each part's pose before it is classified and
implies ``--tta``, the mean over the 24 cube rotations; a segmenter over
``--seg-parts`` parts a row (``evaluate_ood_seg``), where
``--canonicalize`` and ``--tta`` are refused.

``train`` prints one ``{"config": {...}}`` line, then the Trainer's JSON
records (``setup``, ``train`` every ``log_every`` steps, ``eval``). With
``--checkpoint-dir`` it saves there; a directory that already holds a
checkpoint resumes from its newest good step and takes its config from the
``config.json`` beside it, with the policy flags given applied on top
(``--config`` naming another preset is refused). ``--data-cache`` trains
from a cache and evaluates on its held-out split; ``--hbm-cache`` uploads
the train split to the card once and draws every batch there.
``--steps-per-dispatch K`` runs K steps per dispatch (one CUDA graph on the
card). ``--augment-affine`` and its knobs, and ``--augment-noise``, are the
reference's in-step augmentation flags (``config.py``); ``robust64`` sets
them.

``train --supervise`` runs training under a stall supervisor
(``train/supervisor.py``): it re-executes the same command as a child
process (the supervision flags stripped, ``--heartbeat-file`` and
``--supervised-child`` added), watches the heartbeat the child touches at
every confirmed point of progress, and restarts the child, which resumes
from its newest good checkpoint, when it crashes or its heartbeat is
older than ``--stall-timeout`` seconds (default 600), up to
``--max-restarts`` times (default 5). A child exiting 75 (a preemption, or
the end of a ``--restart-every N`` segment) is respawned for free. It
requires ``--checkpoint-dir``, uses a private temporary heartbeat file
unless ``--heartbeat-file`` names one, and exits with the last child's
code; the supervisor process itself never touches the card.
``--restart-every`` without ``--supervise`` is refused: nothing would
respawn the child. ``--inject-faults SPEC`` (``train`` and ``serve``)
injects the faults of ``faults.py``; a supervisor installs only
``spawn_fail`` itself and hands the spec to every child, whose markers in
the run directory (else the checkpoint directory) fire each fault once
per run. On the card, ``train`` ends with a ``{"launches": {...}, "pid":
P}`` line: the kernel launches of its process.

``train --elastic`` (``--checkpoint-dir`` and ``--run-dir`` required) runs
the elastic coordinator (``elastic/``) in a process that never opens the
card. It spawns ``--world-size`` children, each the command a supervisor
would spawn (``--heartbeat-file D/heartbeat.<slot>``) with the hidden
``--elastic-rank``, ``--elastic-world``, ``--elastic-port`` and
``--elastic-generation``: a child of a world of more than one process
joins that generation's process group over ``127.0.0.1:<port>`` (a fresh
port per generation, ``--distributed-timeout``, the device and backend of
``--distributed``); a world of one opens none. When a child dies or its
heartbeat is older than ``--stall-timeout``, the whole generation is
killed and the survivors respawn as the largest world over the lowest
slots that the global batch divides, each resuming from the newest good
checkpoint; below ``--min-world-size`` the world restarts at full
strength. A lost slot
rejoins at the next boundary where every child exits 75 (``--restart-every
N`` is legal here): each one under ``--readmit auto``, under ``agent`` only
one that signalled into ``D/membership.json``. ``--max-restarts`` bounds
the unplanned re-forms. The default config is ``pod64``; the coordinator
hands the config it planned with to every child. It ends with
``{"elastic": {"exit_code", "generations", "reforms", "losses", "rejoins",
"planned"}}`` and exits with that code. Refused: with ``--supervise`` or
``--distributed``, a global batch that ``--world-size`` x
``--local-devices`` does not divide, and ``--local-devices`` other than 1
(a slot is one process on one device; the flag is the reference's
planner input). ``--inject-faults`` fires ``spawn_fail`` in the
coordinator and hands the spec to every child.

``--distributed train`` (under ``torchrun``, or any launcher that sets its
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) trains data-parallel across the processes of that world
(``parallel/mesh.py``, ``train/loop.py``): each joins the process group
(timeout ``--distributed-timeout`` seconds, default 1800) on
``cuda:LOCAL_RANK % device_count``, over ``nccl`` when every rank of the
host has a card of its own and over ``gloo`` on the CPU or when ranks share
a card (NCCL refuses two ranks on one device), and prints ``{"distributed":
{"rank", "world", "device", "backend"}}`` first (a run directory's
``loop_start`` events carry the mesh with the backend). ``--global-batch``
is the global batch; each rank prints its own records, whose metrics are
the world's. ``--supervise`` is refused with it, and so is a k-step CUDA
graph (``--steps-per-dispatch`` above 1 on the card) at its capture;
``--distributed`` applies to ``train`` alone.

``train --run-dir D`` writes the run directory (``obs/``; ``train/loop.py``
lists the events): spans, heartbeats, metrics, the loop's events, window
summaries and alerts over ``--alert-rules`` (default: the built-in
rules); under ``--supervise`` the supervisor writes its ``supervisor``
events into the same stream, checks each child's telemetry on its exit 0
and gates each clean segment against ``D/gate_baseline.json``, pinned
from the first. ``--profile-dir P`` traces steps ``[max(--profile-start,
first step), +--profile-steps)`` with ``torch.profiler`` into ``P`` as a
Chrome trace; ``--tb-dir T`` writes the logged scalars as TensorBoard
events (refused when the ``tensorboard`` package is missing).

``report RUN_DIR`` folds a run directory's event streams into the
step-time breakdown, input-pipeline health, heartbeat and supervisor
timeline, serving latency and SLO view (``obs/report.py``); ``--json``
prints the dict, ``--trace`` writes the spans as a Chrome trace,
``--follow`` re-renders while the run is live, ``--validate`` lints the
event schema (exit 1 on findings), ``--gate`` judges the report against a
baseline (exit 2 on a regression), ``--request`` prints one request's
timeline (exit 2 when absent). It imports the standard library only:
never torch, never CUDA.

``incident list RUN_DIR`` prints one line per incident bundle under
``RUN_DIR/incidents`` (``obs/incidents.py``), oldest first; ``incident
show RUN_DIR [ID]`` renders one bundle's post-mortem (the newest by
default), naming any missing or torn piece; ``--json`` prints the index or
the loaded bundle. ``dash RUN_DIR`` renders the run's time-series store
(``RUN_DIR/tsdb``, ``obs/dash.py``) every ``--interval`` seconds, or once
with ``--once``: per-target sparklines, the burn-rate gauges of ``--slos``
(``metric(<|>)threshold@objective%``, default ``serving_p99_ms<250@99%``)
and the incident line. Both read the files alone, with the standard
library only.

``recalibrate`` re-estimates the batch-norm statistics of the newest step
in ``--checkpoint-dir`` over ``--batches`` clean training batches (train-
mode forwards, no augmentation, no update) and saves the result at the
same step into ``--out-dir`` with the run's config; the source is never
modified. It prints ``{"recalibrated": OUT, "from_step": N, "batches":
B}``.

``--train-precision`` picks the training precision policy (fp32 masters
under each; ``bf16_master`` and ``fp16_scaled`` differentiate a reduced
working copy, the latter with dynamic loss scaling) and
``--serve-precision`` the precision the run's eval (and, through its
``config.json``, its serving) runs at; both are run policy, so a resumed
run may change them.

``programs`` prints the program catalog of a preset, one JSON row per
program (``program``, ``doc``, ``precision``, ``applicable``; the
reference's rows), building nothing; ``--warm`` then builds every
applicable program the port builds ahead (``runtime/registry.py``
``warmup``: the serving graphs of each precision at the buckets
1,4,16,64, the packed ones at ``global_batch``, the k-step train graph)
on the card unless ``--device cpu``, and prints ``{"warmup": {program:
{"source", "build_s", "precision", "capture_launches"} | {"skipped":
reason}}}``.

``serve`` installs SLO alert rules over the serving windows
(``--slo-p99-ms``, default 250: ``serving_p99_ms`` and
``queue_wait_ms_p99`` against it; ``--alert-rules`` replaces them).
Drained, it exits 2 when the dispatcher did not stop in time and, with
``--drain``, also when a serving alert is still unresolved (a CI latency
gate); else 0. ``--run-dir D`` writes ``D/run.json`` and
``D/events.jsonl`` (``serve_start``, ``serve_batch``, ``overload``,
``serve_stop``, window summaries, alerts, sampled request timelines at
``--trace-sample``). ``--batch-queue-limit`` caps the ``batch`` lane.

``serve --quality`` feeds the ``confidence``, ``confidence_margin`` and
``prediction_entropy`` windows per answered request and installs the
confidence alert rule; ``--quality-baseline B`` (from ``pin-quality``) adds
the ``quality_drift_score`` window and its rule. ``--capture`` keeps a
flight-recorder ring of served requests in ``D/capture`` (or
``--capture-dir``; ``serve/recorder.py``), refused without either. Both
need a classify checkpoint. ``pin-quality`` scores ``--n`` synthetic parts
with a checkpoint and writes their class mix to
``CK/quality_baseline.json`` (or ``--out``), printing
``{"quality_baseline": {...}}``. ``replay RING`` re-scores a ring's
answered requests with a candidate (another checkpoint, ``--precision``,
``--conv-backend``) through one serving program built before scoring,
prints ``{"replay": {...}}`` (agreement with the recorded labels, flips,
confidence deltas, ``score_ms``, ``post_warmup_compiles``: the programs
built while scoring, 0 when the warmup held) and exits 2 below
``--min-agreement``. On the card, ``serve_stats``, ``replay`` and
``quality_baseline`` carry the process's kernel ``launches``.

``train --poll-device-memory`` samples the card's memory at every
heartbeat into ``device_memory`` events (the report's perf section).

``infer --run-dir D`` writes an ``infer_batch`` span per forward (the
``serving_ms`` window) and the part's ``voxelize`` spans; with
``--alert-rules`` a serving alert still active at the end exits 2.

``fleet`` runs ``--replicas`` supervised ``serve --port 0`` children on
``--device`` behind one router (``fleet/``), in a process that never
opens the card: each child gets ``--replica-id <slot>`` (in its banner,
``/healthz`` and refusal bodies), ``--heartbeat-file R/heartbeat.<slot>``
(touched once a second while it is ready or swapping) and its own event
stream ``R/events.<slot+1>.jsonl``; a dead or silent child is respawned
and routed to again once its ``/healthz`` is ready, the roster kept in
``R/membership.json``. It prints ``{"fleet": {...}}`` with the router's
port, serves until SIGTERM/SIGINT (or ``--duration-s``), then prints
``{"fleet_stats": {...}}``; ``--drain`` exits 2 on an unresolved serving
alert or a dropped admitted request. ``--inject-faults`` fires
``replica_loss`` and ``spawn_fail`` here and hands the whole spec to
every child. ``fleet rollout CK2 --run-dir R`` swaps a live fleet onto a
candidate one replica at a time, each canaried on its own capture ring
(``fleet --capture``) first, and prints ``{"fleet_rollout": {...}}``; a
failed canary, a refused swap or a replica lost mid-swap rolls the
swapped replicas back and exits 2.

``serve``, ``eval`` and ``infer`` read a checkpoint directory read-only and
configure themselves from its ``config.json``; ``--conv-backend`` picks
another lowering of the same model, ``--precision`` (``serve``, ``infer``)
and ``--serve-precision`` (``eval``) another serving precision of the
same weights (default: the config's ``serve_precision``). ``--weights`` reads a file written by
``convert.save_npz``. ``serve`` prints one ``{"serving": {...}}`` banner
line with the bound port once the service is warm, serves until
SIGTERM/SIGINT (or ``--duration-s``), then drains and prints
``{"serve_stats": {...}}``. ``eval`` prints one ``{"eval": {...}}`` line
over one pass of the cache's held-out split when the run's config names
a cache, else over ``eval_batches`` batches of the held-out synthetic
stream; ``infer`` one JSON line per STL part. On the card, ``eval``'s line
carries the process's kernel ``launches`` and ``infer`` ends with a
``{"launches": {...}}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import signal
import sys
import threading
import time

DEFAULT_PRESET = "sprint64"


def _parser() -> argparse.ArgumentParser:
    from featurenet_tpu_torch.config import PRESETS, SEG_LOSSES
    from featurenet_tpu_torch.models.featurenet import CONV_BACKENDS
    from featurenet_tpu_torch.models.segmenter import INPUT_CONTEXTS
    from featurenet_tpu_torch.train.precision import (
        SERVE_PRECISIONS,
        TRAIN_PRECISIONS,
    )

    def precision(p, flag, dest, choices, what):
        p.add_argument(flag, choices=choices, dest=dest,
                       help=f"{what} (default: the config's; see "
                            "featurenet_tpu_torch.train.precision)")

    def common(p, config_help):
        p.add_argument("--config", choices=sorted(PRESETS), help=config_help)
        p.add_argument("--conv-backend", choices=sorted(CONV_BACKENDS),
                       dest="conv_backend",
                       help="lowering of the stride-1 conv blocks (not part "
                            "of a checkpoint's identity)")
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    ap = argparse.ArgumentParser(
        prog="featurenet_tpu_torch.cli",
        epilog="report RUN_DIR, incident list|show RUN_DIR, dash RUN_DIR: "
               "read a run directory (no torch needed; see `report --help`, "
               "`incident --help`, `dash --help`)")
    ap.add_argument("--distributed", action="store_true",
                    help="train: join the torch.distributed world of "
                         "torchrun's environment and train data-parallel")
    ap.add_argument("--distributed-timeout", type=float,
                    dest="distributed_timeout", default=1800.0,
                    help="seconds a collective may wait for the other ranks "
                         "(default 1800)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_srv = sub.add_parser("serve", help="HTTP/1.1 inference service over a "
                                         "continuous batcher")
    src = p_srv.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                     help="serve the newest verified step of this run")
    src.add_argument("--weights", help="port weight file (convert.save_npz); "
                                       "carries its config")
    src.add_argument("--seed", type=int, help="serve random weights from this seed")
    common(p_srv, f"preset served with --seed (default {DEFAULT_PRESET}); "
                  "with --checkpoint-dir it must be the run's")
    precision(p_srv, "--precision", "precision", SERVE_PRECISIONS,
              "serving weight precision")
    p_srv.add_argument("--buckets", default="1,4,16,64",
                       help="comma list of dispatch batch sizes (default 1,4,16,64)")
    p_srv.add_argument("--max-wait-ms", type=float, default=5.0, dest="max_wait_ms")
    p_srv.add_argument("--queue-limit", type=int, default=64, dest="queue_limit")
    p_srv.add_argument("--host", default="127.0.0.1")
    p_srv.add_argument("--port", type=int, default=8000,
                       help="HTTP port (0 = ephemeral; printed in the banner)")
    p_srv.add_argument("--duration-s", type=float, default=None, dest="duration_s",
                       help="stop after this many seconds (default: until signalled)")
    p_srv.add_argument("--inject-faults", dest="inject_faults",
                       help="fault spec (featurenet_tpu_torch.faults); serving "
                            "sites: replica_slow@request=N, swap_corrupt@swap=N, "
                            "replica_loss_rollout@swap=N")
    p_srv.add_argument("--batch-queue-limit", type=int, default=None,
                       dest="batch_queue_limit",
                       help="admission cap of the batch lane (default: half "
                            "of --queue-limit)")
    p_srv.add_argument("--slo-p99-ms", type=float, default=250.0,
                       dest="slo_p99_ms",
                       help="end-to-end p99 latency SLO: installs "
                            "serving_p99_ms>SLO:critical and "
                            "queue_wait_ms_p99>SLO rules (default 250; "
                            "--alert-rules replaces them)")
    p_srv.add_argument("--alert-rules", dest="alert_rules",
                       help="full rule spec metric(>|<)threshold[:severity],... "
                            "(featurenet_tpu_torch.obs.alerts)")
    p_srv.add_argument("--drain", action="store_true",
                       help="exit 2 when a serving alert is still unresolved "
                            "after the final window flush (a CI latency gate)")
    p_srv.add_argument("--trace-sample", type=float, dest="trace_sample",
                       help="request-tracing sample rate in [0, 1]; "
                            "rejections, errors and SLO breaches are always "
                            "kept (default: the config's trace_sample)")
    p_srv.add_argument("--run-dir", dest="run_dir",
                       help="observability directory: run.json and "
                            "events.jsonl (serve_batch, overload, window "
                            "summaries, alerts, request timelines)")
    p_srv.add_argument("--quality", action="store_true",
                       help="model-quality telemetry (classify checkpoints): "
                            "per-request top-1 confidence, top1-top2 margin "
                            "and entropy windows, and the confidence alert "
                            "rule")
    p_srv.add_argument("--quality-baseline", dest="quality_baseline",
                       help="pinned class-mix baseline (quality_baseline.json "
                            "from `pin-quality`): implies --quality and adds "
                            "the quality_drift_score window and its rule")
    p_srv.add_argument("--capture", action="store_true",
                       help="flight recorder: a bounded, sampled JSONL ring "
                            "of served requests under <run-dir>/capture; "
                            "rejections, errors, low-confidence predictions "
                            "and SLO breaches always kept (`replay` "
                            "re-scores it)")
    p_srv.add_argument("--capture-sample", type=float, default=None,
                       dest="capture_sample",
                       help="capture rate in [0, 1] of healthy traffic (a "
                            "trace-id hash; default 0.05)")
    p_srv.add_argument("--capture-dir", dest="capture_dir",
                       help="capture ring directory (default "
                            "<run-dir>/capture; implies --capture)")
    p_srv.add_argument("--replica-id", dest="replica_id",
                       help="this replica's name in a fleet: in the banner, "
                            "/healthz and every refusal body (`fleet` sets "
                            "it on each child)")
    p_srv.add_argument("--heartbeat-file", dest="heartbeat_file",
                       help="touch this file once a second while the service "
                            "is ready or swapping weights (the fleet "
                            "manager's liveness protocol)")
    # The event stream this process owns (a fleet's router keeps 0, replica
    # slot its slot+1).
    p_srv.add_argument("--process-index", type=int, dest="process_index",
                       help=argparse.SUPPRESS)

    p_flt = sub.add_parser("fleet", help="N supervised `serve` replicas behind "
                                         "one router (featurenet_tpu_torch."
                                         "fleet); `fleet rollout` rolls new "
                                         "weights across a live fleet")
    p_flt.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                       help="the checkpoint every replica serves (required "
                            "to launch a fleet)")
    p_flt.add_argument("--replicas", type=int, default=2,
                       help="serving replicas (default 2); each a supervised "
                            "`serve --port 0` child, routed to once its "
                            "/healthz is ready")
    p_flt.add_argument("--device", default="cuda",
                       help="each replica's device: cuda (default) or cpu; "
                            "the fleet process itself uses none")
    p_flt.add_argument("--buckets", default="1,4,16,64",
                       help="per-replica bucket ladder (see `serve`)")
    p_flt.add_argument("--max-wait-ms", type=float, default=5.0,
                       dest="max_wait_ms")
    p_flt.add_argument("--queue-limit", type=int, default=64,
                       dest="queue_limit",
                       help="per-replica admission bound (see `serve`)")
    p_flt.add_argument("--batch-shed-depth", type=int, default=8,
                       dest="batch_shed_depth",
                       help="a batch-lane request goes only to a replica "
                            "whose load is under this; above it everywhere, "
                            "batch sheds at once with Retry-After (default 8)")
    p_flt.add_argument("--host", default="127.0.0.1")
    p_flt.add_argument("--port", type=int, default=8000,
                       help="router HTTP port (0 = ephemeral; in the banner)")
    p_flt.add_argument("--slo-p99-ms", type=float, default=250.0,
                       dest="slo_p99_ms",
                       help="end-to-end p99 SLO of the router's alert rules, "
                            "its scale verdicts and each replica (default "
                            "250)")
    p_flt.add_argument("--slos",
                       help="burn-rate objectives "
                            "'metric<threshold@objective%%[:severity]',... "
                            "(default: one p99 objective from --slo-p99-ms)")
    p_flt.add_argument("--precision", choices=SERVE_PRECISIONS,
                       help="replica serving precision (see `serve`)")
    p_flt.add_argument("--duration-s", type=float, default=None,
                       dest="duration_s",
                       help="stop after this many seconds (default: until "
                            "signalled)")
    p_flt.add_argument("--drain", action="store_true",
                       help="exit 2 on an unresolved fleet serving alert or "
                            "any dropped admitted request")
    p_flt.add_argument("--run-dir", dest="run_dir",
                       help="required: the router's stream 0 (fleet_* "
                            "events), membership.json, heartbeats, replica "
                            "stdout files, the store (tsdb/); replica slot "
                            "writes events.<slot+1>.jsonl")
    p_flt.add_argument("--trace-sample", type=float, dest="trace_sample",
                       help="replica request-tracing sample rate (see `serve`)")
    p_flt.add_argument("--inject-faults", dest="inject_faults",
                       help="fault spec: replica_loss@request=N SIGKILLs a "
                            "live replica at the router's Nth request, "
                            "spawn_fail@spawn=N fails the Nth spawn; the "
                            "replicas get the whole spec (replica_slow, "
                            "swap_corrupt, replica_loss_rollout)")
    p_flt.add_argument("--quality", action="store_true",
                       help="per-replica model-quality telemetry (see `serve`)")
    p_flt.add_argument("--quality-baseline", dest="quality_baseline",
                       help="pinned class-mix baseline for every replica")
    p_flt.add_argument("--capture", action="store_true",
                       help="per-replica flight recorder under "
                            "<run-dir>/capture/replica<slot> (what `fleet "
                            "rollout` canaries on)")
    p_flt.add_argument("--capture-sample", type=float, default=None,
                       dest="capture_sample",
                       help="per-replica capture rate (see `serve`)")
    p_flt.add_argument("--autoscale", action="store_true",
                       help="act on the scale verdicts: add a replica on a "
                            "sustained add, drain and park one on a "
                            "sustained shed (hysteresis, cooldown)")
    p_flt.add_argument("--min-replicas", type=int, default=1,
                       dest="min_replicas",
                       help="autoscale floor (default 1)")
    p_flt.add_argument("--max-replicas", type=int, default=None,
                       dest="max_replicas",
                       help="autoscale ceiling (default --replicas + 2)")
    p_flt.add_argument("--scale-hysteresis", type=int, default=3,
                       dest="scale_hysteresis",
                       help="identical actionable verdicts in a row before "
                            "the autoscaler acts (default 3)")
    p_flt.add_argument("--scale-cooldown-s", type=float, default=30.0,
                       dest="scale_cooldown_s",
                       help="seconds since the last action before the next "
                            "(default 30)")
    flt_sub = p_flt.add_subparsers(dest="fleet_cmd", metavar="{rollout}")
    p_rol = flt_sub.add_parser(
        "rollout", help="roll a candidate checkpoint across a live fleet one "
                        "replica at a time (canary on its capture ring, "
                        "drain, POST /admin/reload, verify); a failure rolls "
                        "the swapped replicas back and exits 2")
    p_rol.add_argument("rollout_checkpoint_dir", metavar="checkpoint_dir",
                       help="the candidate checkpoint directory")
    # SUPPRESS: a value given before the subcommand survives.
    p_rol.add_argument("--run-dir", dest="run_dir", default=argparse.SUPPRESS,
                       help="the live fleet's run directory (its router's "
                            "address, the capture rings, the rollout events)")
    p_rol.add_argument("--device", default=argparse.SUPPRESS,
                       help="the canary's device: cuda (default) or cpu")
    p_rol.add_argument("--config", choices=sorted(PRESETS),
                       help="must be the candidate's (it self-configures)")
    p_rol.add_argument("--conv-backend", choices=sorted(CONV_BACKENDS),
                       dest="conv_backend",
                       help="the canary's lowering of the candidate")
    p_rol.add_argument("--precision", choices=SERVE_PRECISIONS,
                       help="the canary's precision (default: the "
                            "candidate config's)")
    p_rol.add_argument("--min-agreement", type=float, default=0.967,
                       dest="min_agreement",
                       help="per-replica canary gate: the candidate must "
                            "agree with this share of the replica's captured "
                            "labels (default 0.967)")
    p_rol.add_argument("--batch", type=int, default=32,
                       help="canary scoring batch (default 32)")
    p_rol.add_argument("--swap-timeout-s", type=float, default=120.0,
                       dest="swap_timeout_s",
                       help="per-replica /admin/reload deadline (default 120)")
    p_rol.add_argument("--converge-timeout-s", type=float, default=120.0,
                       dest="converge_timeout_s",
                       help="bounded wait for the roster's version tags to "
                            "converge (default 120)")

    p_pin = sub.add_parser("pin-quality", help="pin a predicted-class-mix "
                                               "baseline from a classify "
                                               "checkpoint's pass over "
                                               "synthetic parts")
    p_pin.add_argument("--checkpoint-dir", required=True, dest="checkpoint_dir")
    common(p_pin, "must be the run's (the checkpoint self-configures)")
    precision(p_pin, "--precision", "precision", SERVE_PRECISIONS,
              "serving precision of the pass")
    p_pin.add_argument("--n", type=int, default=512,
                       help="parts to score (default 512)")
    p_pin.add_argument("--seed", type=int, default=0,
                       help="synthetic parts' seed (default 0)")
    p_pin.add_argument("--batch", type=int, default=32,
                       help="scoring batch (default 32)")
    p_pin.add_argument("--out", default=None,
                       help="baseline path (default "
                            "<checkpoint-dir>/quality_baseline.json)")

    p_rpl = sub.add_parser("replay", help="re-score a capture ring (`serve "
                                          "--capture`) with a candidate; "
                                          "exit 2 below --min-agreement")
    p_rpl.add_argument("capture_dir", help="capture ring directory "
                                           "(e.g. <run-dir>/capture)")
    p_rpl.add_argument("--checkpoint-dir", required=True, dest="checkpoint_dir",
                       help="the candidate checkpoint")
    common(p_rpl, "must be the run's (the checkpoint self-configures)")
    precision(p_rpl, "--precision", "precision", SERVE_PRECISIONS,
              "candidate serving precision")
    p_rpl.add_argument("--batch", type=int, default=32,
                       help="scoring batch: one program, built before "
                            "scoring, so scoring builds none (default 32)")
    p_rpl.add_argument("--min-agreement", type=float, default=0.967,
                       dest="min_agreement",
                       help="exit 2 when the candidate agrees with fewer "
                            "than this share of the recorded predictions "
                            "(default 0.967)")
    p_rpl.add_argument("--run-dir", dest="run_dir",
                       help="observability directory for the "
                            "replay_verdict event")

    p_prog = sub.add_parser("programs", help="list a preset's program catalog; "
                                             "--warm builds them")
    p_prog.add_argument("--config", choices=sorted(PRESETS), default="pod64",
                        help="preset whose catalog to list (default pod64)")
    precision(p_prog, "--train-precision", "train_precision", TRAIN_PRECISIONS,
              "training precision the train programs are listed under")
    precision(p_prog, "--serve-precision", "serve_precision", SERVE_PRECISIONS,
              "serving precision eval_step is listed under")
    p_prog.add_argument("--warm", action="store_true",
                        help="build every applicable program the port builds "
                             "ahead")
    p_prog.add_argument("--run-dir", dest="run_dir",
                        help="observability directory: the warmup's "
                             "program_compile events")
    p_prog.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, for --warm")

    p_tr = sub.add_parser("train", help="train a preset on synthetic parts "
                                        "or a voxel or segmentation cache")
    common(p_tr, f"preset to train (default {DEFAULT_PRESET}); a resumed "
                 "run takes its checkpoint's")
    precision(p_tr, "--train-precision", "train_precision", TRAIN_PRECISIONS,
              "training precision policy")
    precision(p_tr, "--serve-precision", "serve_precision", SERVE_PRECISIONS,
              "precision of the run's eval and serving")
    p_tr.add_argument("--resolution", type=int,
                      help="voxel grid edge (part of the model's identity)")
    p_tr.add_argument("--total-steps", type=int, dest="total_steps")
    p_tr.add_argument("--global-batch", type=int, dest="global_batch")
    p_tr.add_argument("--eval-batches", type=int, dest="eval_batches")
    p_tr.add_argument("--data-workers", type=int, dest="data_workers")
    p_tr.add_argument("--seed", type=int)
    p_tr.add_argument("--checkpoint-dir", dest="checkpoint_dir",
                      help="save checkpoints here; resume from the newest "
                           "good one if there is one")
    p_tr.add_argument("--checkpoint-every", type=int, dest="checkpoint_every")
    p_tr.add_argument("--keep-checkpoints", type=int, dest="keep_checkpoints")
    p_tr.add_argument("--init-from", dest="init_from",
                      help="warm start: weights from this checkpoint "
                           "directory, step 0, fresh optimizer moments")
    p_tr.add_argument("--data-cache", dest="data_cache",
                      help="train from this packed voxel cache (export-data)")
    p_tr.add_argument("--hbm-cache", dest="hbm_cache", action="store_true",
                      default=None,
                      help="upload the cache's train split to the device once "
                           "and draw every batch there")
    p_tr.add_argument("--steps-per-dispatch", type=int, dest="steps_per_dispatch",
                      help="train steps per dispatch (one CUDA graph on the "
                           "card; numerically k single steps)")
    p_tr.add_argument("--augment-affine", action="store_true", default=None,
                      dest="augment_affine",
                      help="arbitrary-angle SO(3) rotation and scale in the "
                           "step in place of the cube rotation")
    p_tr.add_argument("--augment-affine-prob", type=float,
                      dest="augment_affine_prob",
                      help="per-group probability the affine warp applies "
                           "(default 1.0)")
    p_tr.add_argument("--augment-ramp-steps", type=int, dest="augment_ramp_steps",
                      help="ramp the affine probability linearly from 0 over "
                           "this many steps (default 0: no ramp)")
    p_tr.add_argument("--no-augment-affine-rotate", action="store_false",
                      default=None, dest="augment_affine_rotate",
                      help="affine without rotation: scale and translation only")
    p_tr.add_argument("--augment-scale-range", type=float, nargs=2,
                      dest="augment_scale_range", metavar=("LO", "HI"),
                      help="uniform scale window of the affine warp "
                           "(default 0.7 1.05)")
    p_tr.add_argument("--augment-translate-vox", type=float,
                      dest="augment_translate_vox",
                      help="uniform per-axis translation of the affine warp, "
                           "in voxels (default 0)")
    p_tr.add_argument("--augment-noise", type=float, dest="augment_noise",
                      help="per-voxel occupancy bit-flip rate in the step "
                           "(0 = off)")
    p_tr.add_argument("--seg-loss", dest="seg_loss", choices=SEG_LOSSES,
                      help="segmentation loss variant (segment presets)")
    p_tr.add_argument("--seg-input-context", dest="seg_input_context",
                      choices=INPUT_CONTEXTS,
                      help="segmenter input channels: axis projections, and "
                           "coordinates")
    p_tr.add_argument("--inject-faults", dest="inject_faults",
                      help="fault spec 'site[@counter=N[:every=M]],...' "
                           "(featurenet_tpu_torch.faults), e.g. "
                           "sigterm@step=120,checkpoint_corrupt@save=2; each "
                           "fault fires once per run (markers in the run "
                           "directory, else the checkpoint directory)")
    p_tr.add_argument("--run-dir", dest="run_dir",
                      help="run directory: run.json and events.jsonl "
                           "(spans, heartbeats, metrics, supervisor "
                           "events); read it with `cli report`")
    p_tr.add_argument("--alert-rules", dest="alert_rules",
                      help="SLO alert rules 'metric(>|<)threshold"
                           "[:severity],...' over the run's windows "
                           "(featurenet_tpu_torch.obs.alerts); default: the "
                           "built-in rules")
    p_tr.add_argument("--poll-device-memory", action="store_true",
                      default=None, dest="poll_device_memory",
                      help="sample the card's allocated, peak and total "
                           "bytes at every heartbeat as device_memory "
                           "events (the report's watermark; needs --run-dir)")
    p_tr.add_argument("--profile-dir", dest="profile_dir",
                      help="trace steps [profile-start, +profile-steps) "
                           "with torch.profiler into this directory")
    p_tr.add_argument("--profile-start", type=int, dest="profile_start",
                      help="first traced step (default 10; a resumed run "
                           "starts no earlier than its first step)")
    p_tr.add_argument("--profile-steps", type=int, dest="profile_steps",
                      help="traced steps (default 5)")
    p_tr.add_argument("--tb-dir", dest="tb_dir",
                      help="also write the logged scalars as TensorBoard "
                           "events here")
    p_tr.add_argument("--heartbeat-file", dest="heartbeat_file",
                      help="touch this file at each confirmed point of "
                           "progress (used by --supervise)")
    p_tr.add_argument("--supervise", action="store_true",
                      help="run under a stall supervisor: restart from the "
                           "newest checkpoint on a crash or a stale "
                           "heartbeat; requires --checkpoint-dir")
    p_tr.add_argument("--stall-timeout", type=float, default=600.0,
                      dest="stall_timeout",
                      help="seconds of heartbeat staleness that count as a "
                           "hang (default 600)")
    p_tr.add_argument("--max-restarts", type=int, default=5, dest="max_restarts",
                      help="restarts allowed before the supervisor gives up")
    p_tr.add_argument("--restart-every", type=int, dest="restart_every_steps",
                      help="supervised runs: checkpoint and respawn a fresh "
                           "process every N steps (not a restart)")
    # Set by the supervisor on its child, which may take --restart-every.
    p_tr.add_argument("--supervised-child", action="store_true",
                      dest="supervised_child", help=argparse.SUPPRESS)
    p_tr.add_argument("--elastic", action="store_true", default=None,
                      help="run under the elastic coordinator: --world-size "
                           "training processes, the world re-formed at the "
                           "surviving count on a host's loss (resumed from "
                           "the newest checkpoint, the global batch kept) "
                           "and recovered hosts re-admitted at the next "
                           "generation boundary; requires --checkpoint-dir "
                           "and --run-dir")
    p_tr.add_argument("--world-size", type=int, default=1, dest="world_size",
                      help="(--elastic) host slots at full strength, one "
                           "training process each (default 1)")
    p_tr.add_argument("--min-world-size", type=int, dest="min_world_size",
                      help="(--elastic) the smallest admissible world; fewer "
                           "survivors force a full-strength restart "
                           "(default 1)")
    p_tr.add_argument("--local-devices", type=int, default=1,
                      dest="local_devices",
                      help="(--elastic) devices per host slot, the planner's "
                           "feasibility input; a slot is one process on one "
                           "device, so only 1 (the default) is accepted")
    p_tr.add_argument("--readmit", choices=["auto", "agent"], default="auto",
                      help="(--elastic) re-admission at a generation "
                           "boundary: 'auto' re-offers every lost slot, "
                           "'agent' only slots whose host agent signalled "
                           "recovery into membership.json")
    # Set by the elastic coordinator on each child: its place in the
    # generation's world.
    for flag in ("--elastic-rank", "--elastic-world", "--elastic-port",
                 "--elastic-generation"):
        p_tr.add_argument(flag, type=int, help=argparse.SUPPRESS)

    p_exp = sub.add_parser("export-data", help="write the synthetic parts "
                                               "into a packed voxel cache")
    p_exp.add_argument("--out", required=True)
    p_exp.add_argument("--per-class", type=int, default=1000, dest="per_class")
    p_exp.add_argument("--resolution", type=int, default=64)
    p_exp.add_argument("--seed", type=int, default=0)
    p_exp.add_argument("--param-range", dest="param_range", default=None,
                       help="feature-parameter quantile window: 'mid', "
                            "'tails', or 'lo,hi' (default: full range)")
    p_exp.add_argument("--mesh-pose", dest="mesh_pose", default="none",
                       choices=["none", "remesh", "so3"],
                       help="route parts through the STL pipeline: 'remesh' "
                            "= STL normalization, identity pose; 'so3' = "
                            "also a uniform random rotation")
    p_exp.add_argument("--margin-jitter", dest="margin_jitter", default=None,
                       help="'lo,hi': per-part normalization margin "
                            "(default fixed 0.05)")
    p_exp.add_argument("--run-dir", dest="run_dir",
                       help="run directory for the export's spans")

    p_seg = sub.add_parser("export-seg-data", help="write multi-feature parts "
                                                   "with per-voxel labels into "
                                                   "a segmentation cache")
    p_seg.add_argument("--out", required=True)
    p_seg.add_argument("--num-parts", type=int, default=2400, dest="num_parts")
    p_seg.add_argument("--resolution", type=int, default=64)
    p_seg.add_argument("--num-features", type=int, default=3, dest="num_features")
    p_seg.add_argument("--seed", type=int, default=0)
    p_seg.add_argument("--label-order", choices=["canonical", "generation"],
                       default="canonical", dest="label_order",
                       help="label of a voxel several features cover: the "
                            "lowest class id's (canonical, default) or the "
                            "first drawn (generation)")

    p_stl = sub.add_parser("export-stl-data", help="write the synthetic parts "
                                                   "as an STL class tree")
    p_stl.add_argument("--out", required=True)
    p_stl.add_argument("--per-class", type=int, default=10, dest="per_class")
    p_stl.add_argument("--resolution", type=int, default=64)
    p_stl.add_argument("--seed", type=int, default=0)
    p_stl.add_argument("--seg", action="store_true",
                       help="segmentation tree: multi-feature parts with "
                            "per-voxel label sidecars (<part>.seg.npy)")
    p_stl.add_argument("--num-parts", type=int, default=2400, dest="num_parts",
                       help="(--seg) total parts in the tree")
    p_stl.add_argument("--num-features", type=int, default=3,
                       dest="num_features",
                       help="(--seg) features carved per part")
    p_stl.add_argument("--label-order", choices=["canonical", "generation"],
                       default="canonical", dest="label_order",
                       help="(--seg) label of a voxel several features "
                            "cover: the lowest class id's (canonical, "
                            "default) or the first drawn (generation)")

    p_bld = sub.add_parser("build-cache", help="voxelize an STL class tree "
                                               "into a packed voxel cache")
    p_bld.add_argument("--stl-root", dest="stl_root", required=True)
    p_bld.add_argument("--out", required=True)
    p_bld.add_argument("--resolution", type=int, default=None,
                       help="classification trees only (default 64); a "
                            "segmentation tree's resolution is its "
                            "sidecars', so a contradicting flag is refused")
    p_bld.add_argument("--workers", type=int, default=None,
                       help="processes voxelizing files (default: cpu "
                            "count; 1 = inline)")
    p_bld.add_argument("--run-dir", dest="run_dir",
                       help="run directory for the build's spans")

    p_ood = sub.add_parser("eval-ood", help="robustness report of a "
                                            "checkpoint under rotation, noise, "
                                            "morphology, parameter tails and "
                                            "scale")
    p_ood.add_argument("--checkpoint-dir", dest="checkpoint_dir", required=True)
    p_ood.add_argument("--per-class", type=int, default=50, dest="per_class")
    p_ood.add_argument("--seg-parts", type=int, default=60, dest="seg_parts",
                       help="segment checkpoints: fresh draws per row (the "
                            "task comes from the checkpoint's config)")
    p_ood.add_argument("--seed", type=int, default=777)
    p_ood.add_argument("--families", default=None,
                       help="comma list: clean,rotation,noise,morph,tails,scale")
    p_ood.add_argument("--out", default=None,
                       help="also write the report rows as a JSON file")
    p_ood.add_argument("--canonicalize", action="store_true",
                       help="classify checkpoints: undo each part's pose "
                            "(min-AABB) before classifying it; implies --tta")
    p_ood.add_argument("--tta", action="store_true", dest="tta_rotations",
                       help="classify checkpoints: average the probabilities "
                            "over the 24 cube rotations (24x the device work)")
    p_ood.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    p_ev = sub.add_parser("eval", help="evaluate a checkpoint on the held-out "
                                       "synthetic stream")
    p_ev.add_argument("--checkpoint-dir", dest="checkpoint_dir", required=True)
    common(p_ev, "must be the run's preset when given")
    precision(p_ev, "--serve-precision", "serve_precision", SERVE_PRECISIONS,
              "precision of the evaluated forward")
    p_ev.add_argument("--eval-batches", type=int, dest="eval_batches")
    p_ev.add_argument("--global-batch", type=int, dest="global_batch")

    p_inf = sub.add_parser("infer", help="classify (or segment) STL parts "
                                         "with a checkpoint")
    p_inf.add_argument("--checkpoint-dir", dest="checkpoint_dir", required=True)
    common(p_inf, "must be the run's preset when given")
    precision(p_inf, "--precision", "precision", SERVE_PRECISIONS,
              "serving weight precision")
    p_inf.add_argument("--seg-out", dest="seg_out",
                       help="segment checkpoints: also write each part's "
                            "label grid to DIR/<stem>_seg.npz")
    p_inf.add_argument("--run-dir", dest="run_dir",
                       help="run directory: infer_batch and voxelize spans, "
                            "the serving window")
    p_inf.add_argument("--alert-rules", dest="alert_rules",
                       help="serving SLO rules over the run's windows; a "
                            "serving alert active at the end exits 2 "
                            "(needs --run-dir)")
    p_inf.add_argument("paths", nargs="+", help="STL files")

    p_rec = sub.add_parser("recalibrate",
                           help="re-estimate a checkpoint's batch-norm "
                                "statistics over clean training batches and "
                                "save them as a new checkpoint")
    p_rec.add_argument("--checkpoint-dir", dest="checkpoint_dir", required=True)
    p_rec.add_argument("--out-dir", dest="out_dir", required=True,
                       help="directory of the recalibrated checkpoint (the "
                            "source is never modified)")
    p_rec.add_argument("--batches", type=int, default=64,
                       help="clean training batches to run (default 64)")
    p_rec.add_argument("--data-cache", dest="data_cache",
                       help="another path of the run's data cache")
    p_rec.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    return ap


def _report_parser() -> argparse.ArgumentParser:
    """``report``'s parser: kept apart from ``_parser``, which imports the
    config and with it torch."""
    p = argparse.ArgumentParser(
        prog="featurenet_tpu_torch.cli report", allow_abbrev=False,
        description="analyze a run directory's event streams (no torch "
                    "needed)")
    p.add_argument("run_dir", help="directory a run wrote with --run-dir")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the report dict as JSON")
    p.add_argument("--trace", default=None,
                   help="also write the spans as a Chrome trace to this "
                        "path (chrome://tracing, ui.perfetto.dev)")
    p.add_argument("--follow", action="store_true",
                   help="re-read the streams and re-render every --interval "
                        "seconds until the run ends or Ctrl-C")
    p.add_argument("--interval", type=float, default=3.0,
                   help="--follow re-render period in seconds (default 3)")
    p.add_argument("--gate", default=None, metavar="BASELINE_JSON",
                   help="judge the report against this baseline "
                        "(obs/gates.py); exit 2 on a regression")
    p.add_argument("--validate", action="store_true",
                   help="event-schema lint; exit 1 on findings")
    p.add_argument("--request", default=None, metavar="TRACE_ID",
                   dest="request_trace",
                   help="print one request's timeline (exit 2 when the id "
                        "is not in the run)")
    return p


def _incident_parser() -> argparse.ArgumentParser:
    """``incident``'s parser, apart from ``_parser`` (torch)."""
    p = argparse.ArgumentParser(
        prog="featurenet_tpu_torch.cli incident", allow_abbrev=False,
        description="post-mortem over a run directory's incident bundles "
                    "(no torch needed)")
    p.add_argument("action", choices=["list", "show"],
                   help="list: one line per bundle, oldest first; show: one "
                        "incident's post-mortem")
    p.add_argument("run_dir", help="run directory (bundles live under "
                                   "<run_dir>/incidents)")
    p.add_argument("incident_id", nargs="?", default=None,
                   help="show only: the incident id (default: the newest)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="the bundle index (list) or the loaded bundle (show) "
                        "as JSON")
    return p


def _dash_parser() -> argparse.ArgumentParser:
    """``dash``'s parser, apart from ``_parser`` (torch)."""
    p = argparse.ArgumentParser(
        prog="featurenet_tpu_torch.cli dash", allow_abbrev=False,
        description="terminal dashboard over a run directory's time-series "
                    "store (no torch needed)")
    p.add_argument("run_dir", help="run directory (the store lives at "
                                   "<run_dir>/tsdb)")
    p.add_argument("--once", action="store_true",
                   help="render one frame and exit")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh interval in seconds (default 2)")
    p.add_argument("--window-s", type=float, default=300.0, dest="window_s",
                   help="sparkline look-back window in seconds (default 300)")
    p.add_argument("--slos", default=None,
                   help="burn-rate objectives of the gauges (e.g. "
                        "'serving_p99_ms<250@99%%'; default: that one)")
    return p


def _with_backend(cfg, backend):
    if not backend:
        return cfg
    return dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend=backend))


def _policy(args, names) -> dict:
    return {k: getattr(args, k) for k in names if getattr(args, k) is not None}


def _cfg_from_checkpoint(saved, args, **policy):
    """The config persisted with a run, with run-policy overrides and the
    conv backend from the flags. A ``--config`` naming another preset would
    restore the weights into another model, so it is refused."""
    if args.config and args.config != saved.name:
        raise SystemExit(
            f"flags contradict the config persisted with this checkpoint: "
            f"--config {args.config} (checkpoint: {saved.name}) -- drop the "
            "flag (the checkpoint self-configures), or point at a run "
            "trained with these settings"
        )
    # What belongs to the run that saved, not to its resumes or readers,
    # unless given again: a stale heartbeat path, a fault spec, a segment
    # length (an unsupervised resume would exit 75 mid-run), and the run's
    # telemetry directories.
    from featurenet_tpu_torch.config import check_identity

    for k in ("heartbeat_file", "restart_every_steps", "inject_faults",
              "run_dir", "profile_dir", "tb_dir"):
        policy.setdefault(k, None)
    policy.setdefault("poll_device_memory", False)
    policy.setdefault("elastic", False)
    policy.setdefault("min_world_size", 1)
    cfg = _with_backend(dataclasses.replace(saved, **policy),
                        args.conv_backend).validate()
    try:
        check_identity(saved, cfg)  # e.g. --seg-input-context
    except ValueError as e:
        raise SystemExit(str(e))
    return cfg


def _saved_config(directory: str):
    from featurenet_tpu_torch.train.checkpoint import load_run_config

    saved = load_run_config(directory)
    if saved is None:
        raise SystemExit(f"{directory!r} holds no config.json; not a port "
                         "checkpoint directory")
    return saved


def _supervised(args) -> int:
    """The supervisor process of ``train --supervise``: it spawns the same
    command as its child and never touches the card itself."""
    import os
    import tempfile

    from featurenet_tpu_torch import faults
    from featurenet_tpu_torch.train.supervisor import child_argv_from_cli, supervise

    if not args.checkpoint_dir:
        raise SystemExit("--supervise requires --checkpoint-dir: a restarted "
                         "run must resume, not silently retrain from scratch")
    if args.inject_faults:
        # The spec reaches every child unchanged; here only the
        # supervisor's own site may fire.
        try:
            faults.check_wired(args.inject_faults)
            faults.install(args.inject_faults, only={"spawn_fail"})
        except ValueError as e:
            raise SystemExit(f"--inject-faults: {e}")
    hb, hb_is_temp = args.heartbeat_file, False
    if not hb:
        fd, hb = tempfile.mkstemp(prefix="fn_heartbeat_")
        os.close(fd)
        hb_is_temp = True
    try:
        result = supervise(child_argv_from_cli(args.raw_argv, hb),
                           heartbeat_file=hb,
                           stall_timeout_s=args.stall_timeout,
                           max_restarts=args.max_restarts,
                           log=lambda line: print(line, flush=True),
                           # The child's --run-dir reaches it unchanged;
                           # the supervisor writes into the same stream.
                           run_dir=args.run_dir)
    finally:
        if hb_is_temp:
            try:
                os.unlink(hb)
            except OSError:
                pass
    return result.exit_code


def _elastic(args) -> int:
    """The coordinator process of ``train --elastic``: it spawns and
    re-forms the world of children and never touches the card itself."""
    from featurenet_tpu_torch import faults
    from featurenet_tpu_torch.elastic import ElasticCoordinator

    if args.supervise:
        raise SystemExit("--elastic already supervises its world (it is the "
                         "N-host generalization of --supervise) -- drop "
                         "--supervise")
    if args.distributed:
        raise SystemExit("--elastic forms each generation's process group "
                         "itself -- drop --distributed")
    if not args.checkpoint_dir:
        raise SystemExit("--elastic requires --checkpoint-dir: a re-formed "
                         "world resumes from the latest checkpoint, not from "
                         "scratch")
    if not args.run_dir:
        raise SystemExit("--elastic requires --run-dir: the membership file, "
                         "per-slot heartbeats, and the coordinator's event "
                         "stream live there")
    # Refused here, not in N children: the planner would otherwise form
    # generation 0 below the requested strength without a word.
    cfg = _train_config(args, "pod64")
    devices = args.world_size * args.local_devices
    if cfg.global_batch % devices:
        raise SystemExit(
            f"--elastic: global batch {cfg.global_batch} is not divisible by "
            f"world-size {args.world_size} x local-devices "
            f"{args.local_devices} = {devices} device(s) -- the coordinator "
            "preserves the global batch across re-forms, so the "
            "full-strength world could never form; adjust --global-batch or "
            "the world shape")
    if args.local_devices != 1:
        raise SystemExit(
            f"--elastic: --local-devices {args.local_devices}: each host slot "
            "here is one process on one device, so the world's devices are "
            "its world size -- drop the flag or pass 1")
    if args.inject_faults:
        # The spec reaches every child unchanged; here only the
        # coordinator's own site may fire.
        try:
            faults.check_wired(args.inject_faults)
            faults.install(args.inject_faults, state_dir=args.run_dir,
                           only={"spawn_fail"})
        except ValueError as e:
            raise SystemExit(f"--inject-faults: {e}")
    # Every child runs the config planned here: without --config a fresh
    # run's children would fall back to train's own default preset.
    raw = args.raw_argv if args.config else [*args.raw_argv, "--config",
                                             cfg.name]
    run_dir = args.run_dir
    result = ElasticCoordinator(
        args.world_size,
        lambda members, rank, generation, port: elastic_child_argv(
            raw, run_dir, members, rank, generation, port),
        run_dir,
        min_world_size=args.min_world_size or 1,
        global_batch=cfg.global_batch,
        local_devices=args.local_devices,
        stall_timeout_s=args.stall_timeout,
        max_reforms=args.max_restarts,
        readmit=args.readmit,
        log=lambda line: print(line, flush=True),
    ).run()
    print(json.dumps({"elastic": dataclasses.asdict(result)}), flush=True)
    return result.exit_code


def elastic_child_argv(raw, run_dir: str, members, rank: int,
                       generation: int, port: int) -> list[str]:
    """The command of ``members[rank]``'s child in an elastic generation:
    the supervised child's (``--heartbeat-file`` the slot's) with its place
    in the world."""
    from featurenet_tpu_torch.elastic import heartbeat_path
    from featurenet_tpu_torch.train.supervisor import child_argv_from_cli

    return child_argv_from_cli(raw, heartbeat_path(run_dir, members[rank])) + [
        "--elastic-rank", str(rank),
        "--elastic-world", str(len(members)),
        "--elastic-port", str(port),
        "--elastic-generation", str(generation),
    ]


def _train(args) -> int:
    if args.restart_every_steps and not (args.supervise or args.supervised_child
                                         or args.elastic):
        raise SystemExit(
            "--restart-every requires --supervise: a segmented run exits "
            "(code 75) at every segment boundary and only the supervisor "
            "respawns it -- without one, training silently stops at step N"
        )
    if args.elastic and not args.supervised_child:
        return _elastic(args)
    if args.supervise:
        if args.distributed:
            raise SystemExit("--distributed with --supervise is not ported: "
                             "a supervisor respawns one process, not a world")
        return _supervised(args)
    if args.distributed:
        from featurenet_tpu_torch.parallel.mesh import init_from_env

        return _in_world(args, init_from_env(args.device,
                                             args.distributed_timeout))
    if args.elastic_rank is not None and (args.elastic_world or 0) > 1:
        # An elastic child joins its generation's world; a world of one
        # opens no process group.
        from featurenet_tpu_torch.parallel.mesh import init_world

        world = args.elastic_world
        return _in_world(args, init_world(
            args.device, args.elastic_rank, world, args.elastic_rank, world,
            f"127.0.0.1:{args.elastic_port}", args.distributed_timeout))
    return _train_here(args)


def _train_config(args, default: str):
    """The config ``train`` runs: the one persisted in ``--checkpoint-dir``
    with the flags' run policy, else the preset (``default`` without
    ``--config``) with the flags."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.train.checkpoint import load_run_config

    policy = _policy(args, ("resolution", "total_steps", "global_batch",
                            "eval_batches",
                            "data_workers", "seed", "checkpoint_dir",
                            "checkpoint_every", "keep_checkpoints",
                            "init_from", "data_cache", "hbm_cache",
                            "train_precision", "serve_precision",
                            "steps_per_dispatch", "augment_affine",
                            "augment_affine_prob", "augment_ramp_steps",
                            "augment_affine_rotate", "augment_scale_range",
                            "augment_translate_vox", "augment_noise",
                            "seg_loss", "seg_input_context",
                            "inject_faults", "heartbeat_file",
                            "restart_every_steps", "run_dir", "alert_rules",
                            "poll_device_memory", "profile_dir",
                            "profile_start", "profile_steps", "tb_dir",
                            "elastic", "min_world_size"))
    if "augment_scale_range" in policy:
        policy["augment_scale_range"] = tuple(policy["augment_scale_range"])
    saved = load_run_config(args.checkpoint_dir) if args.checkpoint_dir else None
    if saved is not None:
        return _cfg_from_checkpoint(saved, args, **policy)
    return _with_backend(get_config(args.config or default, **policy),
                         args.conv_backend)


def _train_here(args) -> int:
    """``train`` in this process, on ``args.device``."""
    import os

    from featurenet_tpu_torch.ops import launch_counts
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = _train_config(args, DEFAULT_PRESET)
    print(json.dumps({"config": dataclasses.asdict(cfg)}, default=str),
          flush=True)
    trainer = Trainer(cfg, device=args.device)
    try:
        trainer.run()
    finally:
        if trainer.device.type == "cuda":
            # The pid tells the lines of a world's processes apart.
            print(json.dumps({"launches": launch_counts(),
                              "pid": os.getpid()}), flush=True)
        if cfg.run_dir:
            from featurenet_tpu_torch import obs

            obs.close_run()
    return 0


def _in_world(args, joined: tuple[str, str]) -> int:
    """``_train_here`` in the process group just joined (``joined`` is its
    ``(device, backend)``), the group destroyed on the way out."""
    import torch.distributed as dist

    args.device, backend = joined
    print(json.dumps({"distributed": {"rank": dist.get_rank(),
                                      "world": dist.get_world_size(),
                                      "device": args.device,
                                      "backend": backend}}), flush=True)
    try:
        return _train_here(args)
    finally:
        dist.destroy_process_group()


def _recalibrate(args) -> int:
    import os

    from featurenet_tpu_torch.config import AFFINE_DEFAULTS
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.loop import Trainer

    if args.batches < 1:
        raise SystemExit("recalibrate: --batches must be >= 1 (a 0-batch run "
                         "would save an unchanged copy labeled as recalibrated)")
    if os.path.realpath(args.out_dir) == os.path.realpath(args.checkpoint_dir):
        raise SystemExit("recalibrate: --out-dir must differ from "
                         "--checkpoint-dir (the source is never modified)")
    saved = _saved_config(args.checkpoint_dir)
    # The clean host stream of the run's data: no resident upload, no
    # augmentation, one step per dispatch, no warm start; the checkpoint is
    # restored read-only (a damaged newest step is walked past, not
    # deleted).
    cfg = dataclasses.replace(
        saved, checkpoint_dir=None, hbm_cache=False, steps_per_dispatch=1,
        init_from=None, augment=False, augment_affine=False,
        augment_noise=0.0, data_cache=args.data_cache or saved.data_cache,
        **AFFINE_DEFAULTS).validate()
    trainer = Trainer(cfg, device=args.device)
    try:
        CheckpointManager(args.checkpoint_dir).restore(trainer.state)
    except FileNotFoundError:
        raise SystemExit("recalibrate: no checkpoint to restore")
    at = trainer.state.step
    trainer.recalibrate_bn(args.batches)
    # The run's own config, so a resume from out-dir is the same run.
    out = CheckpointManager(args.out_dir, config=dataclasses.replace(
        saved, checkpoint_dir=args.out_dir))
    out.save(trainer.state)
    out.close()
    print(json.dumps({"recalibrated": args.out_dir, "from_step": at,
                      "batches": args.batches}), flush=True)
    return 0


def _pair(text: str | None):
    """``"lo,hi"`` as a float pair; another string (or ``None``) as is."""
    if text and "," in text:
        return tuple(float(v) for v in text.split(","))
    return text


@contextlib.contextmanager
def _data_run(args, cmd: str):
    """A data command's run directory (``--run-dir``), closed on the way
    out; process 0's stream, read from no torch topology."""
    if not args.run_dir:
        yield
        return
    from featurenet_tpu_torch import obs

    obs.init_run(args.run_dir, extra={"cmd": cmd}, process_index=0)
    try:
        yield
    finally:
        obs.close_run()


def _export_data(args) -> int:
    from featurenet_tpu_torch.data.offline import export_synthetic_cache

    with _data_run(args, "export-data"):
        index = export_synthetic_cache(args.out, per_class=args.per_class,
                                       resolution=args.resolution,
                                       seed=args.seed,
                                       param_range=_pair(args.param_range),
                                       mesh_pose=args.mesh_pose,
                                       margin_jitter=_pair(args.margin_jitter))
    print(json.dumps({"exported": index["counts"],
                      "param_range": index["param_range"],
                      "mesh_pose": index["mesh_pose"],
                      "margin_jitter": index["margin_jitter"]}), flush=True)
    return 0


def _export_seg_data(args) -> int:
    from featurenet_tpu_torch.data.offline import export_seg_cache

    index = export_seg_cache(args.out, num_parts=args.num_parts,
                             resolution=args.resolution,
                             num_features=args.num_features, seed=args.seed,
                             label_order=args.label_order)
    print(json.dumps({"exported": sum(s["count"] for s in index["shards"]),
                      "shards": len(index["shards"])}), flush=True)
    return 0


def _export_stl_data(args) -> int:
    if args.seg:
        from featurenet_tpu_torch.data.voxel_to_mesh import export_seg_stl_tree

        index = export_seg_stl_tree(
            args.out, num_parts=args.num_parts, resolution=args.resolution,
            num_features=args.num_features, seed=args.seed,
            label_order=args.label_order)
        print(json.dumps({"exported": index["num_parts"],
                          "kind": "segment_stl"}), flush=True)
        return 0
    from featurenet_tpu_torch.data.voxel_to_mesh import export_stl_tree

    index = export_stl_tree(args.out, per_class=args.per_class,
                            resolution=args.resolution, seed=args.seed)
    print(json.dumps({"exported": index["counts"]}), flush=True)
    return 0


def _build_cache(args) -> int:
    import os

    from featurenet_tpu_torch.data.offline import build_cache, build_seg_cache

    # A segmentation tree (index kind "segment_stl") takes the sidecar
    # ingest; a class-directory tree takes build_cache.
    tree = {}
    idx_path = os.path.join(args.stl_root, "index.json")
    if os.path.exists(idx_path):
        with open(idx_path) as fh:
            tree = json.load(fh)
    t0 = time.perf_counter()
    if tree.get("kind") == "segment_stl":
        if args.resolution is not None and args.resolution != tree.get("resolution"):
            raise SystemExit(
                f"--resolution {args.resolution} contradicts the "
                f"segmentation tree's sidecar resolution "
                f"{tree.get('resolution')}: per-voxel labels only exist at "
                "the exported grid; drop the flag")
        with _data_run(args, "build-cache"):
            index = build_seg_cache(args.stl_root, args.out,
                                    workers=args.workers)
        print(json.dumps({"built": sum(s["count"] for s in index["shards"]),
                          "kind": "segment",
                          "seconds": time.perf_counter() - t0}), flush=True)
        return 0
    with _data_run(args, "build-cache"):
        index = build_cache(args.stl_root, args.out,
                            resolution=args.resolution or 64,
                            workers=args.workers)
    print(json.dumps({"built": index["counts"],
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def _eval_ood(args) -> int:
    from featurenet_tpu_torch.ood import evaluate_ood, evaluate_ood_seg
    from featurenet_tpu_torch.train.checkpoint import load_run_config

    families = args.families.split(",") if args.families else None
    saved = load_run_config(args.checkpoint_dir)
    if saved is not None and saved.task == "segment":
        if args.canonicalize or args.tta_rotations:
            raise SystemExit(
                "eval-ood: --canonicalize/--tta are classify-only "
                "(per-voxel labels would need the inverse warp)")
        rows = evaluate_ood_seg(args.checkpoint_dir, parts=args.seg_parts,
                                seed=args.seed, families=families,
                                device=args.device)
    else:
        rows = evaluate_ood(
            args.checkpoint_dir, per_class=args.per_class, seed=args.seed,
            families=families, canonicalize=args.canonicalize,
            tta_rotations=args.tta_rotations, device=args.device)
    for r in rows:
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


def _eval(args) -> int:
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.train.loop import eval_dataset, evaluate

    cfg = _cfg_from_checkpoint(_saved_config(args.checkpoint_dir), args,
                               **_policy(args, ("eval_batches", "global_batch",
                                                "serve_precision")))
    # The masters, as the train-time eval reads them; the eval step casts
    # them to the serving precision.
    pred = Predictor.from_checkpoint(args.checkpoint_dir, config=cfg,
                                     batch=cfg.global_batch, device=args.device,
                                     precision="fp32")
    ev = evaluate(pred.model, eval_dataset(cfg), cfg.eval_batches, pred.device,
                  cfg.serve_precision)
    out = {"config": cfg.name, "model_version": pred.model_version,
           "serve_precision": cfg.serve_precision,
           **{k: v for k, v in ev.items() if k != "confusion"}}
    if pred.device.type == "cuda":
        from featurenet_tpu_torch.ops import launch_counts

        out["launches"] = launch_counts()
    print(json.dumps({"eval": out}), flush=True)
    return 0


def _infer(args) -> int:
    import os

    import numpy as np

    from featurenet_tpu_torch.infer import Predictor, SegPrediction

    cfg = _cfg_from_checkpoint(_saved_config(args.checkpoint_dir), args)
    if args.seg_out and cfg.task != "segment":
        raise SystemExit(
            f"--seg-out only applies to segmentation checkpoints (config "
            f"{cfg.name!r} has task={cfg.task!r}); it would write nothing")
    if args.alert_rules and not args.run_dir:
        raise SystemExit("infer: --alert-rules needs --run-dir (no run, no "
                         "windows: the rules would gate nothing)")
    if args.run_dir:
        from featurenet_tpu_torch import obs
        from featurenet_tpu_torch.config import config_to_dict
        from featurenet_tpu_torch.obs import windows
        from featurenet_tpu_torch.obs.alerts import parse_rules

        rules = None
        if args.alert_rules:
            try:
                rules = parse_rules(args.alert_rules)
            except ValueError as e:
                raise SystemExit(f"--alert-rules: {e}")
        obs.init_run(args.run_dir, config=config_to_dict(cfg),
                     extra={"cmd": "infer"}, process_index=0)
        if rules is not None:
            windows.install(windows.WindowAggregator(rules=rules))
    pred = Predictor.from_checkpoint(args.checkpoint_dir, config=cfg,
                                     batch=min(len(args.paths), 32),
                                     device=args.device,
                                     precision=args.precision)
    if args.seg_out:
        os.makedirs(args.seg_out, exist_ok=True)
    used: set = set()
    for p in pred.predict_stl(args.paths):
        if isinstance(p, SegPrediction):
            row = {"path": p.path, "voxel_counts": p.voxel_counts}
            if args.seg_out:
                # Parts of one stem from two directories keep both grids.
                stem = os.path.splitext(os.path.basename(p.path))[0]
                name, i = f"{stem}_seg.npz", 1
                while name in used:
                    name, i = f"{stem}_{i}_seg.npz", i + 1
                used.add(name)
                row["labels_path"] = os.path.join(args.seg_out, name)
                np.savez_compressed(row["labels_path"], labels=p.labels)
        else:
            row = dataclasses.asdict(p)
        print(json.dumps({**row, "precision": pred.precision,
                          "model_version": pred.model_version}), flush=True)
    if pred.device.type == "cuda":
        from featurenet_tpu_torch.ops import launch_counts

        print(json.dumps({"launches": launch_counts()}), flush=True)
    if args.run_dir:
        # The serving windows' last summaries, then the SLO verdict: a
        # serving alert still active here exits 2 (a CI latency gate).
        from featurenet_tpu_torch.obs.alerts import is_serving_metric

        windows.flush()
        stuck = [m for m in windows.active_alerts() if is_serving_metric(m)]
        obs.close_run()
        if stuck:
            print(json.dumps({"serving_alerts_active": stuck}), flush=True)
            return 2
    return 0


def _serve(args) -> int:
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.convert import load_npz
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.batcher import normalize_buckets
    from featurenet_tpu_torch.serve.http import ENDPOINTS, make_server
    from featurenet_tpu_torch.serve.service import InferenceService

    try:
        buckets = normalize_buckets(
            [int(b) for b in args.buckets.split(",") if b.strip()]
        )
    except ValueError:
        raise SystemExit(
            f"serve: --buckets must be comma-separated batch sizes >= 1, "
            f"got {args.buckets!r}"
        )
    rules = None  # the service installs serve_rules(--slo-p99-ms)
    if args.alert_rules:
        from featurenet_tpu_torch.obs.alerts import parse_rules

        try:
            rules = parse_rules(args.alert_rules)
        except ValueError as e:
            raise SystemExit(f"--alert-rules: {e}")
    if args.inject_faults:
        from featurenet_tpu_torch import faults

        try:
            faults.check_wired(args.inject_faults)
            # Markers in the run directory: a respawned fleet replica does
            # not fire a site a previous incarnation fired.
            faults.install(args.inject_faults, state_dir=args.run_dir)
        except ValueError as e:
            raise SystemExit(f"--inject-faults: {e}")
    if args.trace_sample is not None and not 0.0 <= args.trace_sample <= 1.0:
        raise SystemExit(f"--trace-sample is a probability in [0, 1]; got "
                         f"{args.trace_sample}")
    policy = _policy(args, ("trace_sample",))
    if args.checkpoint_dir:
        cfg = _cfg_from_checkpoint(_saved_config(args.checkpoint_dir), args,
                                   **policy)
        pred = Predictor.from_checkpoint(args.checkpoint_dir, config=cfg,
                                         batch=max(buckets), device=args.device,
                                         precision=args.precision)
    elif args.weights:
        state, cfg = load_npz(args.weights)
        pred = Predictor(state, _with_backend(dataclasses.replace(cfg, **policy),
                                              args.conv_backend),
                         batch=max(buckets), device=args.device,
                         model_version=args.weights, precision=args.precision)
    else:
        cfg = _with_backend(get_config(args.config or DEFAULT_PRESET, **policy),
                            args.conv_backend)
        pred = Predictor.from_seed(cfg, args.seed, batch=max(buckets),
                                   device=args.device, precision=args.precision)
    quality, recorder = _quality_plane(args, pred)
    if args.run_dir:
        from featurenet_tpu_torch import obs
        from featurenet_tpu_torch.config import config_to_dict

        obs.init_run(args.run_dir, config=config_to_dict(pred.cfg),
                     extra={"cmd": "serve"}, process_index=args.process_index)
    service = InferenceService(pred, buckets=buckets,
                               max_wait_ms=args.max_wait_ms,
                               queue_limit=args.queue_limit, rules=rules,
                               slo_p99_ms=args.slo_p99_ms,
                               batch_queue_limit=args.batch_queue_limit,
                               quality=quality, recorder=recorder,
                               run_dir=args.run_dir, replica=args.replica_id)
    beat_stop = threading.Event()
    if args.heartbeat_file:
        from featurenet_tpu_torch.train.heartbeat import touch_heartbeat

        def beat():
            # While ready, and while a swap has the replica cordoned: it is
            # alive and working then, and must not be killed as stalled.
            while not beat_stop.is_set():
                if service.ready() or service.reloading():
                    touch_heartbeat(args.heartbeat_file)
                beat_stop.wait(1.0)

        threading.Thread(target=beat, name="serve-heartbeat",
                         daemon=True).start()
    srv = make_server(service, host=args.host, port=args.port)
    server_thread = threading.Thread(target=srv.serve_forever,
                                     name="serve-http", daemon=True)
    server_thread.start()
    print(json.dumps({"serving": {
        "host": srv.server_address[0], "port": srv.server_address[1],
        "buckets": list(buckets), "max_wait_ms": args.max_wait_ms,
        "queue_limit": args.queue_limit, "precision": pred.precision,
        "config": pred.cfg.name, "task": pred.cfg.task,
        "conv_backend": pred.cfg.arch.conv_backend,
        "device": str(pred.device), "model_version": pred.model_version,
        "slo_p99_ms": args.slo_p99_ms, "trace_sample": pred.cfg.trace_sample,
        "run_dir": args.run_dir, "replica": args.replica_id,
        "endpoints": ENDPOINTS,
        "quality": quality is not None,
        "capture_dir": recorder.root if recorder is not None else None,
    }}), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait(timeout=args.duration_s)
    beat_stop.set()
    srv.shutdown()
    srv.server_close()
    server_thread.join(timeout=10.0)
    st = service.drain()
    if args.run_dir:
        from featurenet_tpu_torch import obs

        obs.close_run()
    if pred.device.type == "cuda":
        from featurenet_tpu_torch.ops import launch_counts

        st["launches"] = launch_counts()
    print(json.dumps({"serve_stats": st}), flush=True)
    # Without --drain the SLO verdict is reported, and only a drain that
    # timed out fails the exit.
    return st["exit_code"] if args.drain else (2 if st["drain_timeout"] else 0)


def _quality_plane(args, pred):
    """The ``QualityTracker`` and ``FlightRecorder`` that ``serve``'s
    ``--quality``/``--quality-baseline`` and ``--capture``/
    ``--capture-sample``/``--capture-dir`` ask for (None each when not
    asked), refused for a segmenter and for a ring with nowhere to live."""
    want_quality = args.quality or bool(args.quality_baseline)
    want_capture = (args.capture or bool(args.capture_dir)
                    or args.capture_sample is not None)
    if (want_quality or want_capture) and pred.cfg.task != "classify":
        raise SystemExit(
            "serve: --quality/--capture need a classify checkpoint "
            f"(task={pred.cfg.task!r}) — confidence and drift are "
            "class-probability notions")
    quality = recorder = None
    if want_quality:
        from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
        from featurenet_tpu_torch.obs.quality import QualityTracker, load_baseline

        baseline = None
        if args.quality_baseline:
            try:
                baseline = load_baseline(args.quality_baseline)["dist"]
            except (OSError, ValueError) as e:
                raise SystemExit(f"--quality-baseline: {e}")
        quality = QualityTracker(len(CLASS_NAMES), baseline=baseline)
    if want_capture:
        from featurenet_tpu_torch.serve import recorder as _recorder

        root = args.capture_dir
        if not root:
            if not args.run_dir:
                raise SystemExit(
                    "serve: --capture needs --run-dir (or an explicit "
                    "--capture-dir) — the ring has to live somewhere")
            root = _recorder.capture_dir(args.run_dir)
        try:
            recorder = _recorder.FlightRecorder(
                root, sample=(_recorder.DEFAULT_SAMPLE
                              if args.capture_sample is None
                              else args.capture_sample),
                slo_ms=args.slo_p99_ms)
        except ValueError as e:
            raise SystemExit(f"--capture-sample: {e}")
    return quality, recorder


def _pin_quality(args) -> int:
    """``pin-quality``: the class mix of a classify checkpoint over ``--n``
    synthetic parts, pinned as the drift baseline."""
    import os

    import numpy as np

    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES, generate_batch
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.obs import quality as _quality

    if args.n < 1:
        raise SystemExit(f"pin-quality: --n must be >= 1, got {args.n}")
    cfg = _cfg_from_checkpoint(_saved_config(args.checkpoint_dir), args)
    pred = Predictor.from_checkpoint(args.checkpoint_dir, config=cfg,
                                     batch=min(args.batch, args.n),
                                     device=args.device,
                                     precision=args.precision)
    if pred.cfg.task != "classify":
        raise SystemExit(
            "pin-quality: a drift baseline is a predicted-CLASS "
            f"distribution — task={pred.cfg.task!r} has none")
    rng = np.random.default_rng(args.seed)
    counts = [0] * len(CLASS_NAMES)
    remaining = args.n
    while remaining > 0:
        k = min(remaining, max(args.batch, 1) * 8)
        grids = generate_batch(rng, k, pred.cfg.resolution)["voxels"]
        labels, _ = pred.predict_voxels(grids)
        for lab in labels.tolist():
            counts[int(lab)] += 1
        remaining -= k
    out = args.out or os.path.join(args.checkpoint_dir,
                                   _quality.BASELINE_FILENAME)
    rec = _quality.save_baseline(
        out, counts, class_names=list(CLASS_NAMES),
        source={"checkpoint_dir": args.checkpoint_dir, "n": args.n,
                "seed": args.seed, "precision": pred.precision})
    top = sorted(range(len(rec["dist"])), key=lambda i: -rec["dist"][i])[:5]
    summary = {"path": out, "n": rec["n"],
               "top": [{"class": CLASS_NAMES[i], "p": rec["dist"][i]}
                       for i in top]}
    if pred.device.type == "cuda":
        from featurenet_tpu_torch.ops import launch_counts

        summary["launches"] = launch_counts()
    print(json.dumps({"quality_baseline": summary}), flush=True)
    return 0


def _score_capture_ring(pred, recs: list):
    """Re-score capture records (each with a recorded ``label``) through
    ``pred``'s serving program at its batch, which must be built already.
    Returns ``(labels, probs, score_ms, post_warmup_compiles)``: the
    programs built while scoring, counted from the active sink's
    ``program_compile`` events (on the card a graph capture)."""
    import numpy as np

    from featurenet_tpu_torch.obs import events as _events
    from featurenet_tpu_torch.serve.recorder import unpack_grid

    grids = np.stack([unpack_grid(r["voxels"]) for r in recs])
    warm = _events.kind_counts().get("program_compile", 0)
    t0 = time.perf_counter()
    labels, probs = pred.predict_voxels(grids)
    score_ms = (time.perf_counter() - t0) * 1e3
    compiles = _events.kind_counts().get("program_compile", 0) - warm
    return labels, probs, score_ms, compiles


def _replay(args) -> int:
    """``replay``: the replay canary (see ``_score_capture_ring``); exits
    2 below ``--min-agreement``."""
    import shutil
    import tempfile

    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.recorder import read_captures

    if not 0.0 <= args.min_agreement <= 1.0:
        raise SystemExit(f"replay: --min-agreement must be in [0, 1], got "
                         f"{args.min_agreement}")
    # Only answered requests carry a recorded prediction to agree with.
    recs = [r for r in read_captures(args.capture_dir)
            if r.get("label") is not None]
    if not recs:
        raise SystemExit(
            f"replay: no re-scorable capture records under "
            f"{args.capture_dir!r} — the ring is missing, empty, or holds "
            "only rejections/errors")
    cfg = _cfg_from_checkpoint(_saved_config(args.checkpoint_dir), args)
    # The verdict event needs a sink, and the zero-compile evidence its
    # program_compile count: a throwaway run directory when none is given.
    own_run = not args.run_dir
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="replay_")
    obs.init_run(run_dir, extra={"cmd": "replay"})
    try:
        pred = Predictor.from_checkpoint(args.checkpoint_dir, config=cfg,
                                         batch=min(args.batch, len(recs)),
                                         device=args.device,
                                         precision=args.precision)
        if pred.cfg.task != "classify":
            raise SystemExit("replay: capture rings hold classify traffic — "
                             f"the candidate is task={pred.cfg.task!r}")
        # The warmup: the one program scoring runs, built here; a build
        # after this point is a canary failure in itself.
        pred.program_for(pred.batch)
        labels, probs, score_ms, compiles = _score_capture_ring(pred, recs)

        def cls(c: int) -> str:
            return CLASS_NAMES[c] if 0 <= c < len(CLASS_NAMES) else str(c)

        n = len(recs)
        agree = 0
        flips: dict = {}
        conf_deltas = []
        for i, r in enumerate(recs):
            old, new = int(r["label"]), int(labels[i])
            if old == new:
                agree += 1
            else:
                key = f"{cls(old)}->{cls(new)}"
                flips[key] = flips.get(key, 0) + 1
            if r.get("confidence") is not None:
                conf_deltas.append(float(probs[i, new]) - float(r["confidence"]))
        agreement = agree / n
        ok = agreement >= args.min_agreement
        obs.emit("replay_verdict", agreement=round(agreement, 6), n=n, ok=ok,
                 min_agreement=args.min_agreement, flips=sum(flips.values()),
                 post_warmup_compiles=compiles)
        out = {
            "capture_dir": args.capture_dir,
            "candidate": {"checkpoint_dir": args.checkpoint_dir,
                          "precision": pred.precision,
                          "conv_backend": pred.cfg.arch.conv_backend,
                          "device": str(pred.device)},
            "n": n,
            "agreement": round(agreement, 6),
            "min_agreement": args.min_agreement,
            "ok": ok,
            "flips": dict(sorted(flips.items(), key=lambda kv: -kv[1])),
            "confidence_delta": {
                "mean": round(sum(conf_deltas) / len(conf_deltas), 6),
                "max_abs": round(max(abs(d) for d in conf_deltas), 6),
            } if conf_deltas else None,
            "score_ms": round(score_ms, 3),
            "per_request_ms": round(score_ms / n, 3),
            "post_warmup_compiles": compiles,
        }
        if pred.device.type == "cuda":
            from featurenet_tpu_torch.ops import launch_counts

            out["launches"] = launch_counts()
        print(json.dumps({"replay": out}), flush=True)
    finally:
        obs.close_run()
        if own_run:
            shutil.rmtree(run_dir, ignore_errors=True)
    return 0 if ok else 2


def _fleet(args) -> int:
    """``fleet``: the router, the replica manager and the scraper in this
    process, which never touches a device; each replica is a ``serve``
    child on ``--device``."""
    if getattr(args, "fleet_cmd", None) == "rollout":
        return _fleet_rollout(args)
    import os

    from featurenet_tpu_torch import faults, obs
    from featurenet_tpu_torch.fleet.loadgen import replica_argv
    from featurenet_tpu_torch.fleet.replica import Autoscaler, ReplicaManager
    from featurenet_tpu_torch.fleet.router import FleetRouter
    from featurenet_tpu_torch.fleet.scraper import ROUTER_TARGET, MetricsScraper
    from featurenet_tpu_torch.obs import alerts as _alerts
    from featurenet_tpu_torch.obs import tsdb as _tsdb

    if not args.checkpoint_dir:
        raise SystemExit("fleet: --checkpoint-dir is required to launch a fleet")
    if args.replicas < 1:
        raise SystemExit(f"fleet: --replicas must be >= 1, got {args.replicas}")
    max_replicas = (args.max_replicas if args.max_replicas is not None
                    else args.replicas + 2)
    if args.autoscale:
        if args.min_replicas < 1:
            raise SystemExit(f"fleet: --min-replicas must be >= 1, got "
                             f"{args.min_replicas}")
        if not args.min_replicas <= args.replicas <= max_replicas:
            raise SystemExit(
                f"fleet: --replicas {args.replicas} must sit inside "
                f"[--min-replicas {args.min_replicas}, --max-replicas "
                f"{max_replicas}]")
    if not args.run_dir:
        raise SystemExit(
            "fleet: --run-dir is required — the roster (membership.json), "
            "per-replica heartbeats, stdout banners, and the fleet event "
            "stream all live there")
    if args.inject_faults:
        # This process fires replica_loss and spawn_fail; the replicas get
        # the whole spec on their argv and fire their own sites.
        try:
            faults.check_wired(args.inject_faults)
            faults.install(args.inject_faults, state_dir=args.run_dir,
                           only={"replica_loss", "spawn_fail"})
        except ValueError as e:
            raise SystemExit(f"--inject-faults: {e}")
    if args.quality_baseline:
        from featurenet_tpu_torch.obs.quality import load_baseline

        try:
            load_baseline(args.quality_baseline)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--quality-baseline: {e}")
    slos = None
    if args.slos:
        try:
            slos = _alerts.parse_slos(args.slos)
        except ValueError as e:
            raise SystemExit(f"--slos: {e}")
    if args.device != "cpu":
        # The replicas' kernel, built once here (nvcc only, no CUDA
        # context), so no child compiles it on its cold start.
        from featurenet_tpu_torch.ops import build

        build.build_all(["conv3d_fwd"])
    run_dir = os.path.abspath(args.run_dir)
    # The manifest lists no card: this process must not open the card.
    obs.init_run(run_dir, extra={"cmd": "fleet"}, process_index=0,
                 devices=False)

    def spawn(slot, hb):
        return replica_argv(
            args.checkpoint_dir, slot, hb, run_dir=run_dir, device=args.device,
            buckets=args.buckets, max_wait_ms=args.max_wait_ms,
            queue_limit=args.queue_limit, slo_p99_ms=args.slo_p99_ms,
            precision=args.precision, inject_faults=args.inject_faults,
            trace_sample=args.trace_sample, quality=args.quality,
            quality_baseline=args.quality_baseline, capture=args.capture,
            capture_sample=args.capture_sample)

    manager = ReplicaManager(args.replicas, spawn, run_dir, host="127.0.0.1")
    # The scraper's samples land in <run_dir>/tsdb: the router's burn
    # verdicts, `dash` and the report's fleet timeline read them, and the
    # alert mirror writes alerts_active beside them.
    store = _tsdb.TimeSeriesStore.open(run_dir)
    _alerts.set_store(store)
    router = FleetRouter(manager, slo_p99_ms=args.slo_p99_ms,
                         batch_shed_depth=args.batch_shed_depth, store=store,
                         slos=slos, run_dir=run_dir)
    manager.start()
    autoscaler = None
    if args.autoscale:
        autoscaler = Autoscaler(manager, router.scale_state,
                                min_replicas=args.min_replicas,
                                max_replicas=max_replicas,
                                hysteresis=args.scale_hysteresis,
                                cooldown_s=args.scale_cooldown_s)
    srv = router.make_server(host=args.host, port=args.port)
    port = srv.server_address[1]
    scraper = MetricsScraper(store, manager.pool, lambda: {
        **{str(s): p for s, p in manager.stats()["ports"].items()},
        ROUTER_TARGET: port})
    scraper.start()
    if autoscaler is not None:
        autoscaler.start()
    obs.emit("fleet_start", replicas=args.replicas, host=srv.server_address[0],
             port=port)
    threading.Thread(target=srv.serve_forever, name="fleet-http",
                     daemon=True).start()
    print(json.dumps({"fleet": {
        "host": srv.server_address[0], "port": port, "pid": os.getpid(),
        "replicas": args.replicas, "device": args.device,
        "buckets": args.buckets, "batch_shed_depth": args.batch_shed_depth,
        "autoscale": None if autoscaler is None else autoscaler.stats(),
        "run_dir": run_dir,
    }}), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait(timeout=args.duration_s)
    # Stop acting first, take a last scrape while the replicas live, then
    # drain the router and stop the children.
    if autoscaler is not None:
        autoscaler.stop()
    scraper.stop()
    srv.shutdown()
    srv.server_close()
    st = router.drain()
    manager.stop()
    st["scrape"] = scraper.stats()
    if autoscaler is not None:
        st["autoscale"] = autoscaler.stats()
    _alerts.set_store(None)
    store.close()
    obs.close_run()
    print(json.dumps({"fleet_stats": st}), flush=True)
    return st["exit_code"] if args.drain else 0


# The rollout's event stream: far above any replica's slot+1, so `fleet
# rollout` appends to a live fleet's run directory without a collision.
_ROLLOUT_STREAM = 1000


def _fleet_router_address(run_dir: str):
    """The live fleet's router ``(host, port)`` from the last
    ``fleet_start`` event of the run's stream 0 (the router's), or None
    when the directory holds no fleet."""
    import os

    from featurenet_tpu_torch.obs.events import events_filename

    addr = None
    try:
        with open(os.path.join(run_dir, events_filename(0)),
                  encoding="utf-8") as fh:
            for line in fh:
                try:
                    e = json.loads(line)
                except ValueError:
                    continue  # the torn tail of a live stream
                if e.get("ev") == "fleet_start":
                    addr = (e.get("host"), e.get("port"))
    except OSError:
        return None
    if not addr or not addr[0] or not addr[1]:
        return None
    return addr[0], int(addr[1])


def _wait_one_version(pool, host: str, router_port: int, timeout_s: float,
                      expect=None) -> bool:
    """Poll the router's roster until every replica with a version tag
    reports the same one (``expect`` when given); False on timeout."""
    import http.client

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            _, raw = pool.get(host, router_port, "/healthz", 10.0)
            doc = json.loads(raw.decode("utf-8"))
        except (OSError, http.client.HTTPException, ValueError):
            time.sleep(0.5)
            continue
        vals = set((doc.get("versions") or {}).values())
        if (len(vals) == 1 and doc.get("healthy")
                and (expect is None or vals == {expect})):
            return True
        time.sleep(0.5)
    return False


def _fleet_rollout(args) -> int:
    """``fleet rollout CK``: one replica at a time, canary the candidate on
    the replica's own capture ring (``_score_capture_ring``, as `replay`),
    swap it with ``POST /admin/reload`` (the replica cordons itself and the
    router spills its traffic to the others), note its new version; then
    wait for the roster to converge. A failed canary, a refused swap or a
    replica's death rolls every swapped replica back to its old checkpoint
    and exits 2."""
    import http.client
    import os

    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.fleet.pool import ConnectionPool
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.recorder import read_captures

    candidate = args.rollout_checkpoint_dir
    if not 0.0 <= args.min_agreement <= 1.0:
        raise SystemExit(f"fleet rollout: --min-agreement must be in [0, 1], "
                         f"got {args.min_agreement}")
    run_dir = getattr(args, "run_dir", None)
    if not run_dir:
        raise SystemExit(
            "fleet rollout: --run-dir is required — it names the LIVE fleet "
            "(router address from its event stream, capture rings under "
            "<run-dir>/capture, rollout events into the same run)")
    addr = _fleet_router_address(run_dir)
    if addr is None:
        raise SystemExit(
            f"fleet rollout: no fleet_start event under {run_dir!r} — point "
            "--run-dir at the run directory of a live `cli fleet`")
    host, router_port = addr
    pool = ConnectionPool(timeout_s=args.swap_timeout_s)

    def get_json(port: int, path: str) -> tuple:
        status, raw = pool.get(host, port, path, 10.0)
        try:
            return status, json.loads(raw.decode("utf-8"))
        except ValueError:
            return status, {}

    def reload(port: int, ckpt: str) -> tuple:
        status, raw, _ = pool.post(
            host, port, "/admin/reload",
            json.dumps({"checkpoint_dir": ckpt}).encode(),
            {"Content-Type": "application/json"}, args.swap_timeout_s)
        try:
            return status, json.loads(raw.decode("utf-8"))
        except ValueError:
            return status, {}

    try:
        status, health = get_json(router_port, "/healthz")
    except (OSError, http.client.HTTPException) as e:
        raise SystemExit(f"fleet rollout: router at {host}:{router_port} is "
                         f"unreachable ({e}) — the fleet must be live to roll")
    ports = {int(s): int(p) for s, p in (health.get("ports") or {}).items()}
    if status != 200 or not ports:
        raise SystemExit(f"fleet rollout: fleet at {host}:{router_port} is not "
                         f"ready (status {status}, ports {ports}) — nothing "
                         "to roll")
    # Each replica's old identity off its own /healthz: its version, and
    # the checkpoint a rollback swaps back to.
    roster: dict = {}
    for slot, port in sorted(ports.items()):
        try:
            st, h = get_json(port, "/healthz")
        except (OSError, http.client.HTTPException):
            continue
        if st == 200 and h.get("ready"):
            roster[slot] = {"port": port,
                            "old_version": h.get("model_version", "unversioned"),
                            "old_checkpoint_dir": h.get("checkpoint_dir")}
    if not roster:
        raise SystemExit("fleet rollout: no ready replicas answered /healthz — "
                         "refusing to roll a degraded fleet")
    cfg = _cfg_from_checkpoint(_saved_config(candidate), args)
    obs.init_run(run_dir, extra={"cmd": "fleet-rollout"},
                 process_index=_ROLLOUT_STREAM)
    out: dict = {}
    try:
        # The canary's one program, built before any scoring; the
        # replicas' own graphs are untouched.
        pred = Predictor.from_checkpoint(candidate, config=cfg,
                                         batch=args.batch,
                                         device=getattr(args, "device", "cuda"),
                                         precision=args.precision)
        if pred.cfg.task != "classify":
            raise SystemExit("fleet rollout: capture rings hold classify "
                             f"traffic — the candidate is task={pred.cfg.task!r}")
        pred.program_for(pred.batch)
        target = pred.model_version
        obs.emit("rollout_start", checkpoint_dir=str(candidate),
                 replicas=sorted(roster), to_version=target)
        swapped: list = []
        steps: list = []
        failure = None
        for slot in sorted(roster):
            info = roster[slot]
            recs = [r for r in read_captures(
                        os.path.join(run_dir, "capture", f"replica{slot}"))
                    if r.get("label") is not None]
            agreement = None
            if recs:
                labels, _, _, compiles = _score_capture_ring(pred, recs)
                agree = sum(int(r["label"]) == int(labels[i])
                            for i, r in enumerate(recs))
                agreement = agree / len(recs)
                obs.emit("replay_verdict", agreement=round(agreement, 6),
                         n=len(recs), ok=agreement >= args.min_agreement,
                         min_agreement=args.min_agreement,
                         flips=len(recs) - agree,
                         post_warmup_compiles=compiles, replica=slot)
                if agreement < args.min_agreement:
                    obs.emit("rollout_step", replica=slot, ok=False,
                             agreement=round(agreement, 6),
                             reason="canary_failed")
                    failure = (f"canary_failed(replica={slot},"
                               f"agreement={agreement:.4f})")
                    break
            try:
                st, doc = reload(info["port"], candidate)
            except (OSError, http.client.HTTPException) as e:
                # Died mid-swap: the manager respawns it on its old
                # checkpoint; the swapped peers roll back to match.
                obs.emit("rollout_step", replica=slot, ok=False,
                         reason=f"replica_lost: {e}")
                failure = f"replica_lost(replica={slot})"
                break
            if st != 200:
                kind = doc.get("kind") or st
                obs.emit("rollout_step", replica=slot, ok=False,
                         reason=f"swap_refused:{kind}")
                failure = f"swap_refused(replica={slot},kind={kind})"
                break
            swapped.append(slot)
            step = {"replica": slot, "canary_n": len(recs),
                    "agreement": (None if agreement is None
                                  else round(agreement, 6)),
                    "swap_ms": doc.get("swap_ms"),
                    "model_version": doc.get("model_version")}
            steps.append(step)
            obs.emit("rollout_step", replica=slot, ok=True,
                     **{k: v for k, v in step.items() if k != "replica"})
        if failure is not None:
            rolled, failed = [], []
            for slot in reversed(swapped):
                old = roster[slot]["old_checkpoint_dir"]
                try:
                    ok = bool(old) and reload(roster[slot]["port"], old)[0] == 200
                except (OSError, http.client.HTTPException):
                    ok = False
                (rolled if ok else failed).append(slot)
            obs.emit("rollout_rollback", reason=failure, rolled_back=rolled,
                     failed=failed)
            converged = _wait_one_version(pool, host, router_port,
                                          args.converge_timeout_s)
            obs.emit("rollout_done", ok=False, swapped=[], reason=failure,
                     rolled_back=rolled)
            out = {"ok": False, "reason": failure, "rolled_back": rolled,
                   "rollback_failed": failed, "converged": converged,
                   "steps": steps}
        else:
            converged = _wait_one_version(pool, host, router_port,
                                          args.converge_timeout_s,
                                          expect=target)
            obs.emit("rollout_done", ok=True, swapped=swapped, version=target,
                     converged=converged)
            out = {"ok": True, "version": target, "swapped": swapped,
                   "converged": converged, "steps": steps}
        if pred.device.type == "cuda":
            from featurenet_tpu_torch.ops import launch_counts

            out["launches"] = launch_counts()
        print(json.dumps({"fleet_rollout": {
            "checkpoint_dir": candidate, "run_dir": run_dir,
            "min_agreement": args.min_agreement, "device": str(pred.device),
            **out}}), flush=True)
    finally:
        pool.close()
        obs.close_run()
    return 0 if out.get("ok") else 2


def _programs(args) -> int:
    from featurenet_tpu_torch.config import config_to_dict, get_config
    from featurenet_tpu_torch.runtime.registry import list_programs, warmup

    cfg = get_config(args.config,
                     **_policy(args, ("train_precision", "serve_precision")))
    if args.run_dir:
        from featurenet_tpu_torch import obs

        obs.init_run(args.run_dir, config=config_to_dict(cfg),
                     extra={"cmd": "programs"})
    try:
        for row in list_programs(cfg):
            print(json.dumps(row), flush=True)
        if args.warm:
            print(json.dumps({"warmup": warmup(cfg, device=args.device)}),
                  flush=True)
    finally:
        if args.run_dir:
            obs.close_run()
    return 0


def _report(args) -> int:
    """``report``: the standard library only, so it works where the card
    (and torch) that made the run are gone."""
    import os

    from featurenet_tpu_torch.obs.report import (
        build_report_dir,
        discover_event_files,
        follow_report,
        format_report,
        format_request_timeline,
        load_events,
        request_timeline,
        validate_events,
    )

    files = discover_event_files(args.run_dir)
    if not files:
        if not os.path.isdir(args.run_dir):
            raise SystemExit(
                f"report: {args.run_dir!r} is not a directory — was the run "
                "started with --run-dir pointing here?")
        names = sorted(os.listdir(args.run_dir))
        raise SystemExit(
            "report: no event stream (events.jsonl or events.<i>.jsonl) in "
            f"{args.run_dir!r} — "
            + (f"found: {', '.join(names)}" if names
               else "the directory is empty")
            + "; was the run started with --run-dir pointing here?")
    if args.follow:
        try:
            follow_report(args.run_dir, interval=args.interval)
        except KeyboardInterrupt:
            print()  # a clean ^C: no traceback over the live view
        return 0
    events, bad = load_events(args.run_dir)
    if args.request_trace:
        tl = request_timeline(events, args.request_trace)
        if args.as_json:
            print(json.dumps(tl, indent=1, default=str))
        else:
            print(format_request_timeline(tl))
        return 0 if tl["found"] else 2
    if args.validate:
        findings = validate_events(events, bad_lines=bad)
        for f in findings:
            print(json.dumps(f, default=str))
        if findings:
            raise SystemExit(
                f"validate: {len(findings)} finding(s) across {len(events)} "
                f"event(s) in {len(files)} stream(s)")
        print(json.dumps({"validate": "ok", "events": len(events),
                          "streams": len(files)}))
        return 0
    rep = build_report_dir(args.run_dir)
    if args.as_json:
        print(json.dumps(rep, indent=1, default=str))
    else:
        print(format_report(rep))
    if args.trace:
        from featurenet_tpu_torch.obs.spans import chrome_trace

        with open(args.trace, "w") as fh:
            json.dump(chrome_trace(events), fh)
        print(json.dumps({"trace": args.trace}))
    if args.gate:
        from featurenet_tpu_torch.obs.gates import (
            evaluate_gates,
            format_gates,
            load_baseline,
            report_gate_values,
        )

        result = evaluate_gates(report_gate_values(rep),
                                load_baseline(args.gate))
        print(format_gates(result, args.gate))
        if not result["ok"]:
            return 2
    return 0


def _incident(args) -> int:
    """``incident list|show``: reads the bundles alone; a damaged bundle
    renders with a ``missing:`` line, never a traceback."""
    import os

    from featurenet_tpu_torch.obs import incidents as _incidents

    if args.action == "list":
        entries = _incidents.list_incidents(args.run_dir)
        if args.as_json:
            print(json.dumps(entries, indent=1, default=str))
            return 0
        if not entries:
            print("no incident bundles under "
                  f"{_incidents.incidents_dir(args.run_dir)}")
            return 0
        for e in entries:
            dur = (f"  duration={e['duration_s']:.3f}s"
                   if isinstance(e.get("duration_s"), (int, float)) else "")
            print(f"{e['id']}  rule={e.get('rule', '?')}  "
                  f"severity={e.get('severity', '?')}  "
                  f"state={e.get('state', '?')}{dur}")
        return 0
    incident_id = args.incident_id
    if incident_id is None:
        entries = _incidents.list_incidents(args.run_dir)
        if not entries:
            raise SystemExit("incident show: no bundles under "
                             f"{_incidents.incidents_dir(args.run_dir)}")
        incident_id = entries[-1]["id"]
    bundle = _incidents.load_bundle(args.run_dir, incident_id)
    if not os.path.isdir(bundle["dir"]):
        raise SystemExit(f"incident show: no bundle {incident_id!r} under "
                         f"{_incidents.incidents_dir(args.run_dir)}")
    if args.as_json:
        print(json.dumps(bundle, indent=1, default=str))
    else:
        print(_incidents.format_incident(bundle), end="")
    return 0


def _dash(args) -> int:
    """``dash``: one frame (``--once``) or a redraw every ``--interval``
    seconds until Ctrl-C, from the store alone."""
    from featurenet_tpu_torch.obs.dash import render_frame

    def frame() -> str:
        return render_frame(args.run_dir, window_s=args.window_s,
                            slos=args.slos)

    try:
        if args.once:
            print(frame(), end="")
            return 0
        while True:
            print("\x1b[2J\x1b[H" + frame(), end="", flush=True)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        print()
    except ValueError as e:
        raise SystemExit(f"dash: {e}")
    return 0


def main(argv=None) -> int:
    raw = list(argv) if argv is not None else sys.argv[1:]
    if raw[:1] == ["report"]:
        return _report(_report_parser().parse_args(raw[1:]))
    if raw[:1] == ["incident"]:
        return _incident(_incident_parser().parse_args(raw[1:]))
    if raw[:1] == ["dash"]:
        return _dash(_dash_parser().parse_args(raw[1:]))
    args = _parser().parse_args(argv)
    args.raw_argv = raw
    if args.distributed and args.cmd != "train":
        raise SystemExit(f"--distributed applies to train, not {args.cmd}")
    return {"train": _train, "serve": _serve, "eval": _eval,
            "infer": _infer, "export-data": _export_data,
            "export-seg-data": _export_seg_data,
            "export-stl-data": _export_stl_data, "build-cache": _build_cache,
            "eval-ood": _eval_ood, "recalibrate": _recalibrate,
            "programs": _programs, "pin-quality": _pin_quality,
            "replay": _replay, "fleet": _fleet}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
