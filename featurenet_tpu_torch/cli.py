"""Command line for the PyTorch port.

    python -m featurenet_tpu_torch.cli export-data --out .data/c \
        [--per-class 1000 --resolution 64 --seed 0 --param-range mid|tails|LO,HI \
         --mesh-pose none|remesh|so3 --margin-jitter LO,HI]
    python -m featurenet_tpu_torch.cli export-seg-data --out .data/seg64 \
        [--num-parts 2400 --resolution 64 --num-features 3 --seed 0 \
         --label-order canonical|generation]
    python -m featurenet_tpu_torch.cli export-stl-data --out .data/stl \
        [--per-class 10 --resolution 64 --seed 0]
    python -m featurenet_tpu_torch.cli build-cache --stl-root .data/stl \
        --out .data/c [--resolution 64 --workers N]
    python -m featurenet_tpu_torch.cli eval-ood --checkpoint-dir CK \
        [--per-class 50 --seed 777 --families rotation,noise --canonicalize \
         --tta --out rows.json]
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
         --heartbeat-file F --restart-every N]] [--inject-faults SPEC]
    python -m featurenet_tpu_torch.cli serve --checkpoint-dir CK --port 0 \
        [--precision fp32|bf16|int8] [--inject-faults SPEC]
    python -m featurenet_tpu_torch.cli serve --config sprint64 --seed 0 \
        --buckets 1,4,16,64 --port 0 --device cuda
    python -m featurenet_tpu_torch.cli serve --weights w.npz --port 0
    python -m featurenet_tpu_torch.cli eval --checkpoint-dir CK \
        [--serve-precision fp32|bf16|int8]
    python -m featurenet_tpu_torch.cli infer --checkpoint-dir CK \
        [--precision fp32|bf16|int8] [--seg-out DIR] part.stl ...
    python -m featurenet_tpu_torch.cli recalibrate --checkpoint-dir CK \
        --out-dir CK2 [--batches 64 --data-cache D]

Every subcommand but the four data commands runs on the card unless
``--device cpu`` is given. The data commands run on the host alone and
never create a CUDA context: ``export-seg-data`` writes multi-feature
parts with their per-voxel labels into a segmentation cache
(``data/offline.py`` ``export_seg_cache``) and prints ``{"exported": N,
"shards": S}``; ``export-data`` writes the synthetic parts
into a packed voxel cache (``data/offline.py``; ``--param-range``,
``--mesh-pose`` and ``--margin-jitter`` as ``export_synthetic_cache``
takes them) and prints ``{"exported": {class: count}, ...}``;
``export-stl-data`` writes them as an STL class tree
(``voxel_to_mesh.export_stl_tree``) and prints ``{"exported": {class:
count}}``; ``build-cache`` voxelizes such a tree (or any tree of
``<class>/*.stl``) into a packed cache over ``--workers`` processes
(default: one per core) and prints ``{"built": {class: count},
"seconds": wall}``. The
segmentation STL trees are not ported: ``export-stl-data --seg`` and a
``segment_stl`` tree are refused (ROADMAP Queue A.3).

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

``eval-ood`` prints the robustness report of a classify checkpoint
(``ood.py``), one JSON row per (family, level), and with ``--out`` also
writes the rows to a JSON file; ``--canonicalize`` undoes each part's
pose before it is classified and implies ``--tta``, the mean over the 24
cube rotations. A segmentation checkpoint is refused.

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
the checkpoint directory fire each fault once per run. On the card,
``train`` ends with a ``{"launches": {...}}`` line: the kernel launches of
its process.

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
stream; ``infer`` one JSON line per STL part.
"""

from __future__ import annotations

import argparse
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

    ap = argparse.ArgumentParser(prog="featurenet_tpu_torch.cli")
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
                           "fault fires once per run (markers in the "
                           "checkpoint directory)")
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
                       help="segmentation tree (not ported; refused)")

    p_bld = sub.add_parser("build-cache", help="voxelize an STL class tree "
                                               "into a packed voxel cache")
    p_bld.add_argument("--stl-root", dest="stl_root", required=True)
    p_bld.add_argument("--out", required=True)
    p_bld.add_argument("--resolution", type=int, default=64)
    p_bld.add_argument("--workers", type=int, default=None,
                       help="processes voxelizing files (default: cpu "
                            "count; 1 = inline)")

    p_ood = sub.add_parser("eval-ood", help="robustness report of a classify "
                                            "checkpoint under rotation, noise, "
                                            "morphology, parameter tails and "
                                            "scale")
    p_ood.add_argument("--checkpoint-dir", dest="checkpoint_dir", required=True)
    p_ood.add_argument("--per-class", type=int, default=50, dest="per_class")
    p_ood.add_argument("--seed", type=int, default=777)
    p_ood.add_argument("--families", default=None,
                       help="comma list: clean,rotation,noise,morph,tails,scale")
    p_ood.add_argument("--out", default=None,
                       help="also write the report rows as a JSON file")
    p_ood.add_argument("--canonicalize", action="store_true",
                       help="undo each part's pose (min-AABB) before "
                            "classifying it; implies --tta")
    p_ood.add_argument("--tta", action="store_true", dest="tta_rotations",
                       help="average the probabilities over the 24 cube "
                            "rotations (24x the device work)")
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
    # unless given again: a stale heartbeat path, a fault spec, and a
    # segment length (an unsupervised resume would exit 75 mid-run).
    from featurenet_tpu_torch.config import check_identity

    for k in ("heartbeat_file", "restart_every_steps", "inject_faults"):
        policy.setdefault(k, None)
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
                           log=lambda line: print(line, flush=True))
    finally:
        if hb_is_temp:
            try:
                os.unlink(hb)
            except OSError:
                pass
    return result.exit_code


def _train(args) -> int:
    if args.restart_every_steps and not (args.supervise or args.supervised_child):
        raise SystemExit(
            "--restart-every requires --supervise: a segmented run exits "
            "(code 75) at every segment boundary and only the supervisor "
            "respawns it -- without one, training silently stops at step N"
        )
    if args.supervise:
        return _supervised(args)
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.ops import launch_counts
    from featurenet_tpu_torch.train.checkpoint import load_run_config
    from featurenet_tpu_torch.train.loop import Trainer

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
                            "restart_every_steps"))
    if "augment_scale_range" in policy:
        policy["augment_scale_range"] = tuple(policy["augment_scale_range"])
    saved = load_run_config(args.checkpoint_dir) if args.checkpoint_dir else None
    if saved is not None:
        cfg = _cfg_from_checkpoint(saved, args, **policy)
    else:
        cfg = _with_backend(get_config(args.config or DEFAULT_PRESET, **policy),
                            args.conv_backend)
    print(json.dumps({"config": dataclasses.asdict(cfg)}, default=str),
          flush=True)
    trainer = Trainer(cfg, device=args.device)
    try:
        trainer.run()
    finally:
        if trainer.device.type == "cuda":
            print(json.dumps({"launches": launch_counts()}), flush=True)
    return 0


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


def _export_data(args) -> int:
    from featurenet_tpu_torch.data.offline import export_synthetic_cache

    index = export_synthetic_cache(args.out, per_class=args.per_class,
                                   resolution=args.resolution, seed=args.seed,
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
    from featurenet_tpu_torch.data.voxel_to_mesh import export_stl_tree

    if args.seg:
        raise SystemExit("export-stl-data --seg: the segmentation STL tree "
                         "is not ported yet (ROADMAP Queue A.3)")
    index = export_stl_tree(args.out, per_class=args.per_class,
                            resolution=args.resolution, seed=args.seed)
    print(json.dumps({"exported": index["counts"]}), flush=True)
    return 0


def _build_cache(args) -> int:
    import os

    from featurenet_tpu_torch.data.offline import build_cache

    tree = os.path.join(args.stl_root, "index.json")
    if os.path.exists(tree):
        with open(tree) as fh:
            if json.load(fh).get("kind") == "segment_stl":
                raise SystemExit(
                    f"build-cache: {args.stl_root} is a segmentation STL "
                    "tree; its ingest is not ported yet (ROADMAP Queue A.3)")
    t0 = time.perf_counter()
    index = build_cache(args.stl_root, args.out, resolution=args.resolution,
                        workers=args.workers)
    print(json.dumps({"built": index["counts"],
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


def _eval_ood(args) -> int:
    import os

    from featurenet_tpu_torch.ood import evaluate_ood
    from featurenet_tpu_torch.train.checkpoint import CONFIG_FILENAME

    sidecar = os.path.join(args.checkpoint_dir, CONFIG_FILENAME)
    if os.path.exists(sidecar):
        with open(sidecar) as fh:
            if json.load(fh).get("task") == "segment":
                raise SystemExit(
                    "eval-ood: a segmentation checkpoint's report "
                    "(evaluate_ood_seg) is not ported yet (ROADMAP Queue A.3)")
    rows = evaluate_ood(
        args.checkpoint_dir, per_class=args.per_class, seed=args.seed,
        families=args.families.split(",") if args.families else None,
        canonicalize=args.canonicalize, tta_rotations=args.tta_rotations,
        device=args.device)
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
    print(json.dumps({"eval": {
        "config": cfg.name, "model_version": pred.model_version,
        "serve_precision": cfg.serve_precision,
        **{k: v for k, v in ev.items() if k != "confusion"}}}), flush=True)
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
    if args.inject_faults:
        from featurenet_tpu_torch import faults

        try:
            faults.check_wired(args.inject_faults)
            faults.install(args.inject_faults)
        except ValueError as e:
            raise SystemExit(f"--inject-faults: {e}")
    if args.checkpoint_dir:
        cfg = _cfg_from_checkpoint(_saved_config(args.checkpoint_dir), args)
        pred = Predictor.from_checkpoint(args.checkpoint_dir, config=cfg,
                                         batch=max(buckets), device=args.device,
                                         precision=args.precision)
    elif args.weights:
        state, cfg = load_npz(args.weights)
        pred = Predictor(state, _with_backend(cfg, args.conv_backend),
                         batch=max(buckets), device=args.device,
                         model_version=args.weights, precision=args.precision)
    else:
        cfg = _with_backend(get_config(args.config or DEFAULT_PRESET),
                            args.conv_backend)
        pred = Predictor.from_seed(cfg, args.seed, batch=max(buckets),
                                   device=args.device, precision=args.precision)
    service = InferenceService(pred, buckets=buckets,
                               max_wait_ms=args.max_wait_ms,
                               queue_limit=args.queue_limit)
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
        "endpoints": ENDPOINTS,
    }}), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait(timeout=args.duration_s)
    srv.shutdown()
    srv.server_close()
    server_thread.join(timeout=10.0)
    st = service.drain()
    print(json.dumps({"serve_stats": st}), flush=True)
    return st["exit_code"]


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    args.raw_argv = list(argv) if argv is not None else sys.argv[1:]
    return {"train": _train, "serve": _serve, "eval": _eval,
            "infer": _infer, "export-data": _export_data,
            "export-seg-data": _export_seg_data,
            "export-stl-data": _export_stl_data, "build-cache": _build_cache,
            "eval-ood": _eval_ood, "recalibrate": _recalibrate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
