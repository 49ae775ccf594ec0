"""Configuration and the presets (port of the parts of
``featurenet_tpu/config.py`` that serving and training read).

Kept: the model identity (``name``, ``task``, ``resolution``, ``arch``, and
for ``task="segment"`` the segmenter's ``seg_features``,
``seg_input_context``, ``seg_decoder_blocks`` and
``seg_bottleneck_blocks``; ``models/segmenter.py``), ``seg_loss``
(``balanced_ce``, ``ce_dice``, ``dice``; ``train/steps.py``),
``serve_precision`` (``fp32``, ``bf16``, ``int8``), ``seed``, the training
recipe -- batch, data workers, eval batches, optimizer, schedule, label
smoothing, clipping, ``train_precision`` (``fp32``, ``bf16_master``,
``fp16_scaled``; ``train/precision.py``) and the log/eval cadence -- with
the JAX presets' values, and the checkpoint fields (``checkpoint_dir``,
``checkpoint_every``, ``keep_checkpoints``, ``init_from``), and the
supervision fields (``restart_every_steps``, ``max_inflight_steps``,
``inject_faults``, ``heartbeat_file``; ``train/supervisor.py``), and the
observability fields (``run_dir``, ``alert_rules``, ``trace_sample``,
``poll_device_memory``; ``obs/``; ``profile_dir``, ``profile_start``, ``profile_steps``, the
Trainer's ``torch.profiler`` window; ``tb_dir``, the TensorBoard scalars
of ``utils/logging.py``). A
``config.json`` that the JAX package writes beside its checkpoints loads
through ``config_from_dict`` (the fields the port lacks are dropped), and
``check_identity`` holds a requested config to a persisted one as the
JAX package's does.

Data: synthetic parts streamed from the host, or a packed voxel cache
(``data_cache``, ``data/offline.py``), streamed or, with ``hbm_cache``,
resident on the device. ``augment``/``augment_device``/``augment_groups``
select the in-step pose augmentation as the reference's fields do
(``device_augment``): the cube-group rotation, or with ``augment_affine``
the affine warp (``augment_affine_prob``, ``augment_ramp_steps``,
``augment_affine_rotate``, ``augment_scale_range``,
``augment_translate_vox``); ``augment_noise`` flips occupancy after either
(``ops/augment.py``). ``steps_per_dispatch`` runs k train steps per
dispatch, one CUDA graph on the card (``train/loop.py``). The reference's
validation of these fields is kept. ``mesh_data``, ``mesh_model`` and
``spatial`` are the reference's mesh fields (``parallel/mesh.py``): a
data-parallel run spans the processes of a ``torch.distributed`` world;
a model axis above 1 is refused once clamped to the world (abc128's 2
clamps to 1 on one process). A ``config.json`` written without them
loads with their defaults.

``task="segment"`` (the ``seg64`` preset) trains and serves the per-voxel
segmenter from synthetic multi-feature parts or a segmentation cache
(``data/offline.py``); a streamed cache rotates on the host, a resident
one in the step, voxels and target together. With ``augment_affine`` a
resident segment run warps voxels and target by the same affine draw in
the step (``ops/augment.py``); a streamed one has no in-step augmentation
and is refused, as the reference refuses it. A segmenter serves at every
``serve_precision``, ``int8`` included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from featurenet_tpu_torch import faults
from featurenet_tpu_torch.models.featurenet import (
    FeatureNetArch,
    deep_arch,
    tiny_arch,
)
from featurenet_tpu_torch.models.segmenter import INPUT_CONTEXTS
from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS, TRAIN_PRECISIONS

OPTIMIZERS = ("adamw", "adam", "sgd")
TASKS = ("classify", "segment")
SEG_LOSSES = ("balanced_ce", "ce_dice", "dice")


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = "pod64"
    task: str = "classify"
    resolution: int = 64
    arch: FeatureNetArch = dataclasses.field(default_factory=FeatureNetArch)
    # The segmenter (task="segment", models/segmenter.py): encoder widths,
    # loss variant (train/steps.segmentation_loss), input context channels
    # ("none", "proj", "proj_coords") and the refine convs per decoder
    # stage and in the bottleneck. All but seg_loss are identity fields.
    seg_features: tuple[int, ...] = (32, 64, 128)
    seg_loss: str = "balanced_ce"
    seg_input_context: str = "none"
    seg_decoder_blocks: int = 1
    seg_bottleneck_blocks: int = 1
    # Serving weight precision (train/precision.py serve_params_cast):
    # "fp32" masters, a "bf16" working copy, or "int8" per-channel
    # quantized weights; the model computes in its bf16 activation dtype
    # under each, as in the JAX package. Eval runs the same forward.
    serve_precision: str = "fp32"
    seed: int = 0

    # Data: synthetic parts generated on the host (data/dataset.py), or a
    # packed voxel cache (data/offline.py) whose train split is streamed
    # or, with hbm_cache, uploaded to the device once and drawn from there.
    # A cache holds out test_fraction of each class for eval.
    global_batch: int = 96
    num_features: int = 1
    eval_batches: int = 8
    data_workers: int = 2
    data_cache: Optional[str] = None
    hbm_cache: bool = False
    test_fraction: float = 0.2
    # Pose augmentation of cache-backed training (ops/augment.py);
    # synthetic streaming already randomizes pose at generation.
    # augment_device poses inside the train step, augment_groups poses per
    # batch; else the cache's host workers rotate each sample.
    augment: bool = True
    augment_device: bool = True
    augment_groups: int = 8
    # Per-voxel occupancy bit-flip rate, applied in the step after the pose.
    augment_noise: float = 0.0
    # The affine warp in place of the cube rotation: per group, a uniform
    # SO(3) rotation (off: scale and translation only) times a uniform scale
    # in augment_scale_range, shifted by up to augment_translate_vox voxels
    # per axis, taken with probability augment_affine_prob, ramped linearly
    # from 0 over the first augment_ramp_steps steps.
    augment_affine: bool = False
    augment_affine_prob: float = 1.0
    augment_ramp_steps: int = 0
    augment_affine_rotate: bool = True
    augment_scale_range: tuple[float, float] = (0.7, 1.05)
    augment_translate_vox: float = 0.0
    # Train steps per dispatch: one CUDA graph of k steps on the card.
    steps_per_dispatch: int = 1

    # Parallelism (parallel/mesh.py): the mesh's axis sizes over the
    # processes of a torch.distributed world (None: every process on
    # data), and depth partitioning over the model axis. Only the data
    # axis is ported: a model axis that stays above 1 once clamped to the
    # world, and spatial with one, are refused where a run is set up.
    # Run policy, not identity: a checkpoint restores on any mesh.
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    spatial: bool = False

    # Optimization (train/steps.py).
    optimizer: str = "adamw"
    peak_lr: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    total_steps: int = 3000
    label_smoothing: float = 0.0
    grad_clip: float = 0.0
    # Training precision policy (train/precision.py): fp32 masters under
    # each; "bf16_master" and "fp16_scaled" differentiate a bf16 or fp16
    # working copy, "fp16_scaled" with dynamic loss scaling.
    train_precision: str = "fp32"
    log_every: int = 50
    eval_every: int = 500

    # Checkpoints (train/checkpoint.py): saved every checkpoint_every steps
    # and at the end when checkpoint_dir is set, the newest
    # keep_checkpoints kept. init_from is a warm start: weights and
    # batch-norm statistics from that checkpoint directory, step 0 and
    # fresh optimizer moments; a checkpoint in checkpoint_dir still wins.
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    keep_checkpoints: int = 3
    init_from: Optional[str] = None

    # Supervised runs (train/supervisor.py). restart_every_steps: save and
    # exit 75 every N steps so the supervisor respawns a fresh process
    # (free, not a restart); needs checkpoint_dir. max_inflight_steps: the
    # train steps dispatched ahead of confirmed progress (the loop waits
    # for the dispatch that many steps back, then beats). inject_faults:
    # a fault spec (faults.py), its markers in checkpoint_dir.
    # heartbeat_file: touched at every confirmed point of progress (a
    # paced completion, an eval batch read back, a completed save); the
    # supervisor watches its mtime.
    restart_every_steps: Optional[int] = None
    max_inflight_steps: int = 8
    inject_faults: Optional[str] = None
    heartbeat_file: Optional[str] = None

    # Run-scoped observability (obs/). run_dir: the directory of run.json
    # and events.jsonl (None: no obs file I/O). alert_rules: threshold
    # rules "metric(>|<)threshold[:severity]", comma-separated, over the
    # rolling windows (obs/alerts.py); None: the defaults. trace_sample:
    # the share of healthy serving requests whose timeline lands in the
    # stream (obs/tracing.py); rejections, errors and SLO breaches are
    # always kept.
    run_dir: Optional[str] = None
    alert_rules: Optional[str] = None
    trace_sample: float = 1.0
    # The device-memory watermark (obs/perf.py): the Trainer samples
    # torch.cuda's allocated, peak and total bytes at every heartbeat (off
    # the dispatch path) as device_memory events; nothing on the CPU. Only
    # meaningful with run_dir (no sink, no events).
    poll_device_memory: bool = False

    # Profiling: with profile_dir, train steps [profile_start,
    # profile_start + profile_steps) run under torch.profiler (CPU and CUDA
    # activities) and the trace is written into profile_dir as a Chrome
    # trace (train/loop.py). tb_dir: also write the logged scalars as
    # TensorBoard events there (utils/logging.py).
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 5
    tb_dir: Optional[str] = None

    @property
    def device_augment(self) -> bool:
        """Whether pose augmentation runs inside the train step rather than
        in the host workers: always when augmenting a resident split (it
        has no host pass), and for a streamed cache with
        ``augment_device``; never for synthetic streaming."""
        if not (self.augment and self.augment_groups > 0):
            return False
        if self.hbm_cache:
            return True
        return bool(self.data_cache and self.augment_device
                    and self.task == "classify")

    def validate(self) -> "Config":
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}; one of {TASKS}")
        if self.seg_loss not in SEG_LOSSES:
            raise ValueError(f"unknown seg_loss {self.seg_loss!r}")
        if self.seg_input_context not in INPUT_CONTEXTS:
            raise ValueError(
                f"unknown seg_input_context {self.seg_input_context!r}")
        if self.seg_decoder_blocks < 1 or self.seg_bottleneck_blocks < 1:
            raise ValueError(
                "seg_decoder_blocks and seg_bottleneck_blocks must be >= 1")
        features = tuple(self.seg_features)
        if features != self.seg_features:  # a JSON list compares unequal
            object.__setattr__(self, "seg_features", features)
        if self.serve_precision not in SERVE_PRECISIONS:
            raise ValueError(
                f"unknown serve_precision {self.serve_precision!r}; one of "
                f"{', '.join(SERVE_PRECISIONS)}"
            )
        if self.train_precision not in TRAIN_PRECISIONS:
            raise ValueError(
                f"unknown train_precision {self.train_precision!r}; one of "
                f"{', '.join(TRAIN_PRECISIONS)}"
            )
        if self.resolution < 1:
            raise ValueError(f"resolution must be >= 1, got {self.resolution}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {self.optimizer!r}; one of {OPTIMIZERS}"
            )
        for name in ("global_batch", "num_features", "eval_batches",
                     "data_workers", "log_every", "eval_every",
                     "checkpoint_every", "keep_checkpoints"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.warmup_steps < 0 or self.total_steps < 0:
            raise ValueError("warmup_steps and total_steps must be >= 0")
        if self.inject_faults:
            # A typo'd or unwired site must fail at config time: a spec
            # that never fires makes a chaos test pass by testing nothing.
            faults.check_wired(self.inject_faults)
        if self.alert_rules:
            # A rule naming a metric that does not exist would never
            # evaluate: an SLO that watches nothing.
            from featurenet_tpu_torch.obs.alerts import parse_rules

            parse_rules(self.alert_rules)
        if not (0.0 <= self.trace_sample <= 1.0):
            raise ValueError(f"trace_sample is a probability in [0, 1]; got "
                             f"{self.trace_sample}")
        if self.profile_start < 0 or self.profile_steps < 1:
            raise ValueError(
                f"profile_start must be >= 0 and profile_steps >= 1; got "
                f"{self.profile_start} and {self.profile_steps}")
        if self.tb_dir:
            # torch.utils.tensorboard writes through the tensorboard
            # package: without it the scalars could not be written.
            import importlib.util

            if importlib.util.find_spec("tensorboard") is None:
                raise ValueError(
                    f"tb_dir={self.tb_dir!r} needs the 'tensorboard' package "
                    "(torch.utils.tensorboard writes through it), which is "
                    "not installed")
        if self.restart_every_steps is not None:
            if self.restart_every_steps <= 0:
                raise ValueError(
                    f"restart_every_steps must be positive, got "
                    f"{self.restart_every_steps}"
                )
            if not self.checkpoint_dir:
                raise ValueError(
                    "restart_every_steps requires checkpoint_dir: a "
                    "segmented run resumes from its checkpoint"
                )
        if self.mesh_model < 1 or (self.mesh_data is not None
                                   and self.mesh_data < 1):
            raise ValueError(f"mesh axes must be >= 1, got mesh_data="
                             f"{self.mesh_data} mesh_model={self.mesh_model}")
        if self.hbm_cache:
            if self.spatial:
                raise ValueError(
                    "hbm_cache is incompatible with spatial sharding: the "
                    "resident dataset shards batch rows over 'data', not "
                    "depth over 'model'"
                )
            if not self.data_cache:
                raise ValueError(
                    "hbm_cache requires data_cache (the split that gets "
                    "uploaded is the offline cache's train split)"
                )
            if self.augment and self.augment_groups < 1:
                raise ValueError(
                    "hbm_cache with augment=True needs augment_groups >= 1: "
                    "the resident dataset's only augmentation path is the "
                    "in-step device rotation"
                )
            if self.augment and not self.augment_device:
                raise ValueError(
                    "hbm_cache with augment=True requires device "
                    "augmentation (augment_device=True): the resident "
                    "dataset has no host-side augmentation path, so "
                    "augment=True would otherwise be silently ignored -- "
                    "pass augment=False to train unaugmented"
                )
        if self.task == "segment":
            self._validate_segment()
        self._validate_augment()
        if self.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got "
                             f"{self.steps_per_dispatch}")
        return self

    def _validate_segment(self) -> None:
        """The reference's divisibility check."""
        down = 2 ** len(self.seg_features)
        if self.resolution % down:
            raise ValueError(
                f"segment task: resolution {self.resolution} must be "
                f"divisible by 2**len(seg_features) = {down}"
            )

    def _validate_augment(self) -> None:
        """The reference's checks of the affine and noise fields."""
        # A list-valued scale range (a hand-built Config) compares equal to
        # the tuple default.
        scale_range = tuple(self.augment_scale_range)
        if scale_range != self.augment_scale_range:
            object.__setattr__(self, "augment_scale_range", scale_range)
        if not self.augment_affine:
            non_default = [n for n, d in AFFINE_DEFAULTS.items()
                           if getattr(self, n) != d]
            if non_default:
                raise ValueError(
                    f"{', '.join(non_default)} configured but augment_affine "
                    "is off -- the knobs would be silently ignored; pass "
                    "augment_affine=True (--augment-affine)"
                )
        if not 0.0 < self.augment_affine_prob <= 1.0:
            raise ValueError(f"augment_affine_prob is a per-group probability "
                             f"in (0, 1]; got {self.augment_affine_prob}")
        if self.augment_ramp_steps < 0:
            raise ValueError("augment_ramp_steps must be >= 0")
        if self.augment_translate_vox < 0:
            raise ValueError("augment_translate_vox must be >= 0 voxels")
        lo, hi = self.augment_scale_range
        if not 0.0 < lo <= hi:
            raise ValueError(f"augment_scale_range must satisfy 0 < lo <= hi; "
                             f"got ({lo}, {hi})")
        if (self.augment_affine and not self.augment_affine_rotate
                and self.augment_scale_range == (1.0, 1.0)
                and self.augment_translate_vox == 0.0):
            raise ValueError(
                "augment_affine with rotation off, scale (1,1), and translate "
                "0 is the identity -- disable augment_affine instead of "
                "paying the resample for nothing"
            )
        if self.augment_affine and not self.device_augment:
            raise ValueError(
                "augment_affine runs inside the train step and needs device "
                "augmentation active (augment=True, augment_groups>=1, and a "
                "data_cache with augment_device=True or hbm_cache) -- as "
                "configured the flag would be silently ignored"
            )
        if not 0.0 <= self.augment_noise < 0.5:
            raise ValueError(
                f"augment_noise is a per-voxel bit-flip probability in "
                f"[0, 0.5); got {self.augment_noise} (0.01 = 1% of voxels)"
            )

    def validate_training(self) -> "Config":
        """``validate`` plus what training alone needs."""
        self.validate()
        if self.resolution % 8:
            raise ValueError(
                "resolution must be divisible by 8 (the wire format "
                "bit-packs voxels along the W axis)"
            )
        return self


# The affine knobs' defaults: set while augment_affine is off, they refuse.
AFFINE_DEFAULTS = {
    "augment_affine_prob": 1.0,
    "augment_ramp_steps": 0,
    "augment_affine_rotate": True,
    "augment_scale_range": (0.7, 1.05),
    "augment_translate_vox": 0.0,
}


def _replace_arch(**kw) -> FeatureNetArch:
    return dataclasses.replace(FeatureNetArch(), **kw)


_FAST = dict(global_batch=256, peak_lr=3e-4, warmup_steps=200)

PRESETS = {
    "smoke16": lambda: Config(
        name="smoke16", resolution=16, arch=tiny_arch(), global_batch=32,
        peak_lr=3e-3, warmup_steps=10, total_steps=200, log_every=20,
        eval_every=100, eval_batches=2, checkpoint_every=100,
    ),
    "xla32": lambda: Config(name="xla32", resolution=32, global_batch=64,
                            total_steps=2000),
    "pod64": lambda: Config(name="pod64", resolution=64, global_batch=128,
                            total_steps=5000, peak_lr=3e-4, warmup_steps=200),
    "fast64": lambda: Config(
        name="fast64", resolution=64, total_steps=4000, **_FAST,
        arch=_replace_arch(kernels=(7, 3, 3, 3)),
    ),
    "turbo64": lambda: Config(
        name="turbo64", resolution=64, total_steps=4000, **_FAST,
        arch=_replace_arch(kernels=(7, 3, 3, 3),
                           pool_after=(True, False, False, True)),
    ),
    "warp64": lambda: Config(
        name="warp64", resolution=64, total_steps=8000, **_FAST,
        arch=_replace_arch(kernels=(7, 3, 3, 3), strides=(4, 1, 1, 1),
                           pool_after=(False, False, False, True)),
    ),
    "sprint64": lambda: Config(
        name="sprint64", resolution=64, total_steps=8000, **_FAST,
        arch=_replace_arch(kernels=(5, 3, 3, 3), strides=(4, 1, 1, 1),
                           pool_after=(False, False, False, True)),
    ),
    "robust64": lambda: Config(
        name="robust64", resolution=64, total_steps=16000, **_FAST,
        arch=_replace_arch(kernels=(5, 3, 3, 3), strides=(4, 1, 1, 1),
                           pool_after=(False, False, False, True)),
        data_cache=".data/cls64_cache", hbm_cache=True, steps_per_dispatch=8,
        augment_affine=True, augment_affine_prob=0.5, augment_noise=0.005,
    ),
    # The reference's seg64: ce_dice, axis-projection and coordinate
    # input channels, two refine convs per decoder stage.
    "seg64": lambda: Config(
        name="seg64", task="segment", resolution=64, global_batch=32,
        num_features=3, total_steps=10000, peak_lr=5e-4, seg_loss="ce_dice",
        seg_input_context="proj_coords", seg_decoder_blocks=2,
    ),
    # The reference's pod-scale mesh: depth over a model axis of 2, which
    # clamps to 1 on one process.
    "abc128": lambda: Config(name="abc128", resolution=128, arch=deep_arch(),
                             global_batch=32, total_steps=8000, peak_lr=3e-4,
                             spatial=True, mesh_model=2),
}


def get_config(name: str, **overrides) -> Config:
    """Look up a preset and apply field overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg.validate()


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> Config:
    """Rebuild a ``Config`` from ``config_to_dict`` output, the port's or
    the JAX package's; unknown keys are dropped and JSON lists come back as
    the tuples the arch and ``augment_scale_range`` expect."""
    known = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in d.items() if k in known}
    for k in ("augment_scale_range", "seg_features"):
        if k in kw:
            kw[k] = tuple(kw[k])
    if "arch" in kw:
        known_a = {f.name for f in dataclasses.fields(FeatureNetArch)}
        kw["arch"] = FeatureNetArch(**{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in kw["arch"].items() if k in known_a
        })
    return Config(**kw).validate()


# Fields that define the trained artifact: a checkpoint restores only under
# these values. The rest (schedule, data, cadence, paths) is run policy.
IDENTITY_FIELDS = ("task", "resolution", "arch", "seg_features",
                   "seg_input_context", "seg_decoder_blocks",
                   "seg_bottleneck_blocks")


def _identity_view(cfg: Config, field: str):
    """The identity-relevant value of ``field``. ``arch.conv_backend``
    selects a lowering, not a model (every backend holds the same
    ``[K,K,K,Cin,Cout]`` kernel), so a checkpoint restores under any."""
    v = getattr(cfg, field)
    if field == "arch":
        v = dataclasses.replace(v, conv_backend="xla")
    return v


def check_identity(saved: Config, requested: Config) -> None:
    """Raise ``ValueError`` when ``requested`` disagrees with the identity
    persisted with a checkpoint."""
    bad = [f for f in IDENTITY_FIELDS
           if _identity_view(saved, f) != _identity_view(requested, f)]
    if bad:
        detail = "; ".join(
            f"{f}: checkpoint={_identity_view(saved, f)!r} "
            f"requested={_identity_view(requested, f)!r}"
            for f in bad
        )
        raise ValueError(
            "explicit flags contradict the config persisted with this "
            f"checkpoint ({detail}) -- drop the flags to use the persisted "
            "config, or point at a checkpoint trained with these settings"
        )
