"""Inference: weights → class predictions for voxel grids or STL files
(port of ``featurenet_tpu/infer.py``'s ``Predictor``).

Usage:
    p = Predictor.from_checkpoint("runs/ck")         # on the card
    p = Predictor(*load_npz("w.npz"))                # a convert.save_npz file
    p = Predictor.from_checkpoint("runs/ck", precision="int8")
    labels, probs = p.predict_voxels(grids)          # [N,R,R,R] occupancy
    labels, probs = p.predict_voxels(grids, tta_rotations=True)  # 24-pose vote
    labels, probs = p.predict_voxels(grids, canonicalize=True)   # + pose undone
    results = p.predict_stl(["part.stl", ...])       # end-to-end
    p.swap_params("runs/ck2")                        # hot swap, zero downtime
    p.agreement()                                    # top-1 vs fp32 serving
    labels = p.packed_program_for(256)(packed)       # uint8 [256,R,R,R/8] wire
    labels = seg.predict_voxels_seg(grids)           # a segment checkpoint:
    results = seg.predict_stl(["part.stl", ...])     # int8 [N,R,R,R], SegPrediction

A Predictor serves on one device whatever mesh its checkpoint was trained
on: ``mesh_data``, ``mesh_model`` and ``spatial`` are run policy
(``parallel/mesh.py``), so a data-parallel run's checkpoint, or a JAX
pod-scale one, restores and serves here as the reference's one-device
Predictor does.

Inputs are padded to the compile batch as in the JAX package, so every
dispatch has one of a few shapes, and each shape has its serving program
(``runtime/registry.py``): on the card a CUDA graph captured at first use
(the service captures every bucket at warmup), replayed by every dispatch;
on the CPU the eager forward.

``precision`` (default: the config's ``serve_precision``) is the serving
weight precision. ``fp32`` serves the masters. ``bf16`` casts a bf16
working copy of every parameter once, when a generation is built, and
keeps it on the device. ``int8`` quantizes the weights once
(``runtime/quantize.py``), keeps the int8 tensors and their scales on the
device and dequantizes them inside each dispatch's program, so int8 is
what sits in device memory. Under both reduced rungs the model's own
parameters leave the device (``meta`` placeholders, which a forward
without the working copy cannot read); the batch-norm statistics stay fp32
on the device, and the fp32 masters stay on the host for ``agreement``.
``resident_weight_bytes`` counts the parameter bytes the device holds.

Packed serving (``packed_program_for``, a classifier only): the
``serve_packed``/``serve_packed_bf16``/``serve_packed_int8`` program of
this precision at one batch takes the bit-packed wire batch (``uint8
[b, R, R, R/8]``, ``data.synthetic.pack_voxels``), unpacks it on the
device and returns the argmax labels (``int32 [b]``), all inside one CUDA
graph on the card: 32x fewer bytes cross to the device than float32
grids.

Weight generations: everything one set of weights serves with (its device
module with its batch-norm statistics, its working copy or int8 tensors,
its ``model_version`` and ``checkpoint_dir``, its programs) is one
``_Weights`` bundle. A dispatch reads the live bundle once, and
``swap_params`` builds a new bundle on the caller's thread, captures its
programs for every batch the old one had, and then flips one reference:
dispatches in flight finish on the old generation, the next one runs the
new, and a swap that fails raises before the flip.

A segmentation checkpoint (``task="segment"``) serves through the same
programs: each one's body is the segmenter's forward and the per-voxel
argmax on the device (``runtime.serve_forward``), so a dispatch reads back
int8 labels ``[b, R, R, R]``, never the logit volume. ``predict_voxels_seg``
returns those labels; ``predict_stl`` returns a ``SegPrediction`` per part
(the labels and the feature-voxel counts by class name);
``predict_voxels`` refuses a segmenter, and ``predict_voxels_seg`` a
classifier. A segmenter serves at every precision: at ``int8`` its conv,
transposed-conv and head kernels are quantized on their output channel
(the trailing axis of the Flax layout) and the fp32 masters stay on the
host, as the classifier's do. ``agreement`` is the per-voxel match for a
segmenter, the top-1 match for a classifier.

Robust serving (``predict_voxels``): ``tta_rotations=True`` averages the
probabilities over the 24 cube rotations (``ops/augment.py``'s
``CUBE_GROUP``, the reference's order). Each chunk of parts is uploaded
to the device once; the rotations are made there with ``permute`` and
``flip`` and streamed, rotation-major, through the serving program at the
Predictor's batch, so the device holds one chunk, one staging batch and
one forward's activations, never 24 rotated copies. The probabilities are
summed in fp32 in rotation order and divided by 24, as the reference's
``mean(axis=0)`` over its host-stacked rotations. ``canonicalize=True``
first undoes each part's arbitrary pose on the host
(``data/canonicalize.py``, numpy float64) and implies the vote, which
resolves the 24-fold ambiguity the canonical pose leaves.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import threading
import time
from typing import Sequence

import numpy as np
import torch

from featurenet_tpu_torch import obs
from featurenet_tpu_torch.config import Config, check_identity, get_config
from featurenet_tpu_torch.data.stl import load_stl
from featurenet_tpu_torch.data.synthetic import CLASS_NAMES, generate_batch
from featurenet_tpu_torch.data.voxelize import voxelize
from featurenet_tpu_torch.obs import perf as _perf
from featurenet_tpu_torch.ops.augment import CUBE_GROUP, apply_rotation
from featurenet_tpu_torch.ops.flops import classifier_forward_flops
from featurenet_tpu_torch.runtime import (
    build_model,
    forward_with,
    resolve_device,
    serve_forward,
)
from featurenet_tpu_torch.runtime.quantize import (
    agreement,
    dequantize_tree,
    quantize_tree,
    tree_bytes,
)
from featurenet_tpu_torch.runtime.registry import ServeProgram, ServePrograms
from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS, serve_params_cast
from featurenet_tpu_torch.train.checkpoint import (
    CheckpointManager,
    checksum_path,
    load_run_config,
)
from featurenet_tpu_torch.train.state import TrainState
from featurenet_tpu_torch.train.steps import unpack_voxels


def checkpoint_version(checkpoint_dir: str, step: int) -> str:
    """The ``model_version`` tag of a checkpoint step:
    ``<dirname>@<step>-<sha256 prefix of its checksum sidecar>``, so two
    directories with the same step number and other bytes get other tags;
    ``<dirname>@<step>`` for a step without a sidecar."""
    base = os.path.basename(os.path.normpath(os.path.abspath(checkpoint_dir)))
    tag = f"{base}@{int(step)}"
    try:
        with open(checksum_path(checkpoint_dir, step), "rb") as fh:
            return f"{tag}-{hashlib.sha256(fh.read()).hexdigest()[:8]}"
    except OSError:
        return tag


@dataclasses.dataclass
class Prediction:
    path: str
    label: int
    class_name: str
    prob: float
    top3: list[tuple[str, float]]


@dataclasses.dataclass
class SegPrediction:
    path: str
    # Predicted feature voxels by class name (background excluded); empty
    # when no feature voxel is predicted.
    voxel_counts: dict[str, int]
    # Per-voxel labels [R, R, R] int8: 0 = stock or air, 1+c = class c.
    labels: np.ndarray = dataclasses.field(repr=False)


def voxel_counts(labels: np.ndarray) -> dict[str, int]:
    """The feature voxels of a label grid by class name (class ids past the
    canonical block as ``class_<id>``), background and absent classes
    left out."""
    counts = np.bincount(np.asarray(labels, np.int32).ravel(),
                         minlength=len(CLASS_NAMES) + 1)
    return {(CLASS_NAMES[c - 1] if c - 1 < len(CLASS_NAMES) else f"class_{c - 1}"):
            int(counts[c]) for c in range(1, len(counts)) if counts[c]}


def _drop_parameters(model: torch.nn.Module) -> None:
    """Replace every parameter of ``model`` by a ``meta`` placeholder of
    its shape and dtype, so its device memory is freed and only a forward
    that passes a working copy (``torch.func.functional_call``) runs."""
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is not None:
                module._parameters[name] = torch.nn.Parameter(
                    torch.empty_like(p, device="meta"), requires_grad=False)


def _restore_for_serving(checkpoint_dir: str, config: Config | str | None = None):
    """The weights of the newest verified step of ``checkpoint_dir`` (a
    step that fails is walked past, never deleted), for a cold start
    (``Predictor.from_checkpoint``) and a hot swap (``swap_params``, whose
    ``config`` is the live one, so a candidate of another identity raises
    before anything changes). Returns ``(state_dict, cfg, model_version)``."""
    saved = load_run_config(checkpoint_dir)
    if config is None:
        if saved is None:
            raise FileNotFoundError(
                f"{checkpoint_dir!r} has no config.json; pass config="
            )
        cfg = saved
    else:
        cfg = get_config(config) if isinstance(config, str) else config
        if saved is not None:
            check_identity(saved, cfg)
    model = build_model(cfg)
    mgr = CheckpointManager(checkpoint_dir)
    mgr.restore_init(TrainState(model, optimizer=None))
    mgr.close()
    return (model.state_dict(), cfg,
            checkpoint_version(checkpoint_dir, mgr.restored_step))


def _dispatch_params(serve_params: dict | None, qparams: dict | None,
                     scales: dict | None) -> dict | None:
    """The parameters of one dispatch: the bf16 working copy, the int8
    tensors dequantized, or ``None`` (the model's own fp32 parameters)."""
    return serve_params if qparams is None else dequantize_tree(qparams, scales)


def _serve_weights(model: torch.nn.Module, serve_params: dict | None,
                   qparams: dict | None, scales: dict | None,
                   voxels: torch.Tensor) -> torch.Tensor:
    """One generation's eager serving forward, the body its programs
    capture."""
    return serve_forward(model, voxels,
                         _dispatch_params(serve_params, qparams, scales))


@torch.inference_mode()
def _serve_packed_weights(model: torch.nn.Module, serve_params: dict | None,
                          qparams: dict | None, scales: dict | None,
                          packed: torch.Tensor) -> torch.Tensor:
    """One generation's eager packed serving forward: unpack the wire
    batch, the model at the generation's precision, argmax to int32
    labels (the reference's ``serve_packed`` body)."""
    logits = forward_with(model, _dispatch_params(serve_params, qparams, scales),
                          unpack_voxels(packed))
    return logits.argmax(dim=-1).to(torch.int32)


@dataclasses.dataclass(eq=False)
class _Weights:
    """One generation of serving weights, bundled so a hot swap is a single
    reference flip: a dispatch reads ``Predictor._weights`` once and takes
    everything it runs from that one read, so a swap landing between two
    dispatches never mixes generations within one forward."""

    model: torch.nn.Module            # its own device module, BN buffers included
    masters: dict[str, torch.Tensor]  # fp32, on the host (agreement)
    serve_params: dict | None         # the resident bf16 working copy
    qparams: dict | None              # int8 only: the int8 tensors ...
    scales: dict | None               # ... and their scales
    version: str
    checkpoint_dir: str | None
    programs: ServePrograms | None = None  # their ``body`` is the eager forward
    packed: ServePrograms | None = None    # the serve_packed* programs (classify)


class Predictor:
    """Eval-mode ``FeatureNet`` (or ``FeatureNetSegmenter``) on one device,
    fed padded fixed-shape batches through one serving program per batch,
    at one serving precision (see the module docstring).

    ``state`` is a port ``state_dict`` (``convert.from_flax``,
    ``convert.load_npz``); ``device`` defaults to ``"cuda"`` and raises
    when there is no card, unless the caller asks for ``"cpu"``;
    ``precision`` defaults to ``cfg.serve_precision``, and an unknown one
    raises ``ValueError``. ``replays`` counts the dispatches a CUDA graph
    answered.
    """

    def __init__(self, state: dict[str, torch.Tensor], cfg: Config,
                 batch: int = 32, device="cuda",
                 model_version: str = "unversioned",
                 precision: str | None = None,
                 checkpoint_dir: str | None = None):
        cfg.validate()
        precision = cfg.serve_precision if precision is None else precision
        if precision not in SERVE_PRECISIONS:
            raise ValueError(f"unknown serving precision {precision!r}; one "
                             f"of {', '.join(SERVE_PRECISIONS)}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.precision = precision
        self.replays = 0
        self._replay_lock = threading.Lock()
        # The card's peak row: each batched forward's wall folds into the
        # mfu window against its program's flops (the unknown tier, no
        # sample, on the CPU).
        self._peaks = _perf.local_device_peaks(self.device)
        self._weights = self._build_weights(state, model_version, checkpoint_dir)

    def _build_weights(self, state: dict[str, torch.Tensor], version: str,
                       checkpoint_dir: str | None) -> _Weights:
        """One generation on the device at this Predictor's precision, with
        no program built yet: the construction path and the swap path."""
        model = build_model(self.cfg)
        model.load_state_dict(state)
        masters = {k: v.detach().clone() for k, v in model.named_parameters()}
        model = model.to(self.device)
        on_device = {k: v.detach() for k, v in model.named_parameters()}
        serve_params = qparams = scales = None
        if self.precision == "bf16":
            serve_params = serve_params_cast(on_device, "bf16")
        elif self.precision == "int8":
            qparams, scales = quantize_tree(on_device)
        if self.precision != "fp32":
            del on_device
            _drop_parameters(model)
        w = _Weights(model, masters, serve_params, qparams, scales, version,
                     checkpoint_dir)
        # The body is a function of the tensors, not of the bundle: no
        # cycle, so a retired generation (its graphs and their memory pool
        # included) is freed as soon as no dispatch holds it.
        tensors = (model, serve_params, qparams, scales)
        # The analytic forward count (ops/flops.py); a segmenter has none.
        fps = (classifier_forward_flops(self.cfg.arch, self.cfg.resolution)
               if self.cfg.task == "classify" else None)
        w.programs = ServePrograms(self.precision,
                                   functools.partial(_serve_weights, *tensors),
                                   self.cfg.resolution, self.device,
                                   flops_per_sample=fps)
        if self.cfg.task == "classify":
            w.packed = ServePrograms(
                self.precision, functools.partial(_serve_packed_weights, *tensors),
                self.cfg.resolution, self.device, packed=True,
                flops_per_sample=fps)
        return w

    # The live generation's parts, read through the one bundle, so every
    # reader follows a swap.
    @property
    def model(self) -> torch.nn.Module:
        return self._weights.model

    @property
    def model_version(self) -> str:
        return self._weights.version

    @property
    def checkpoint_dir(self) -> str | None:
        return self._weights.checkpoint_dir

    @property
    def _masters(self):
        return self._weights.masters

    @property
    def _serve_params(self):
        return self._weights.serve_params

    @property
    def _qparams(self):
        return self._weights.qparams

    @property
    def _scales(self):
        return self._weights.scales

    @property
    def resident_weight_bytes(self) -> int:
        """The parameter bytes the live generation keeps on its device:
        fp32 masters, the bf16 copy, or the int8 tensors (biases and
        batch-norm vectors fp32) with their scales."""
        if self.precision == "bf16":
            return tree_bytes(self._serve_params)
        if self.precision == "int8":
            return tree_bytes(self._qparams, self._scales)
        return tree_bytes(dict(self.model.named_parameters()))

    def _dispatch_params(self):
        """The parameters of one dispatch (``None``: the model's own)."""
        w = self._weights
        return _dispatch_params(w.serve_params, w.qparams, w.scales)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        config: Config | str | None = None, batch: int = 32,
                        device="cuda", precision: str | None = None
                        ) -> "Predictor":
        """Weights from the newest verified step of a checkpoint directory
        (read-only: a step that fails is walked past, never deleted).

        ``config=None`` takes the ``config.json`` persisted with the run;
        an explicit config (or preset name) must agree with its identity
        (``config.check_identity``), and may pick another
        ``conv_backend``."""
        dev = resolve_device(device)
        state, cfg, version = _restore_for_serving(checkpoint_dir, config)
        return cls(state, cfg, batch=batch, device=dev, model_version=version,
                   precision=precision, checkpoint_dir=checkpoint_dir)

    @classmethod
    def from_seed(cls, cfg: Config, seed: int, batch: int = 32,
                  device="cuda", precision: str | None = None) -> "Predictor":
        """Random weights from ``seed`` (see ``models.featurenet.init_weights``)."""
        state = build_model(cfg, seed=seed).state_dict()
        return cls(state, cfg, batch=batch, device=device,
                   model_version=f"seed{seed}", precision=precision)

    def swap_params(self, checkpoint_dir: str) -> str:
        """Hot-swap the serving weights to another checkpoint of the same
        model identity with zero downtime: restore, cast or quantize, and
        capture the new generation's programs for every batch the live one
        has, all on the caller's thread while the live generation keeps
        serving; then flip one reference. Raises before the flip (identity
        mismatch, a missing or unreadable checkpoint, a failed capture), so
        a failed swap leaves the old generation serving. Returns the new
        ``model_version``."""
        state, _, version = _restore_for_serving(checkpoint_dir, self.cfg)
        new = self._build_weights(state, version, checkpoint_dir)
        new.programs.build(self._weights.programs.batches())
        if new.packed is not None:
            new.packed.build(self._weights.packed.batches())
        self._weights = new
        return version

    def agreement(self, n: int = 48, seed: int = 0,
                  reference_precision: str = "fp32",
                  candidate_precision: str | None = None) -> float:
        """Top-1 (a segmenter: per-voxel) agreement between two serving
        precisions of this Predictor's weights (``candidate_precision``
        defaults to its own) on ``n`` synthetic parts from ``seed``: the
        precision-agnostic accuracy gate (``runtime.quantize.agreement``)."""
        grids = generate_batch(np.random.default_rng(seed), n,
                               self.cfg.resolution)["voxels"]
        masters = {k: v.to(self.device) for k, v in self._masters.items()}
        return agreement(self.model, masters,
                         torch.from_numpy(grids).to(self.device),
                         reference_precision=reference_precision,
                         candidate_precision=candidate_precision or self.precision)

    def int8_agreement(self, n: int = 48, seed: int = 0) -> float:
        """The int8 rung of ``agreement``."""
        return self.agreement(n=n, seed=seed, candidate_precision="int8")

    def program_for(self, batch: int) -> ServeProgram:
        """The ``serve``/``serve_bf16``/``serve_int8`` program at this batch
        on the live generation (``registry.serve_program_name``), built at
        first use and memoized: building one per bucket before traffic is
        the serving warmup, after which no request shape captures."""
        return self._weights.programs.get(batch)

    def packed_program_for(self, batch: int) -> ServeProgram:
        """The ``serve_packed*`` program at this batch and precision on the
        live generation (``registry.serve_program_name(precision,
        packed=True)``): ``uint8 [batch, R, R, R/8]`` → ``int32 [batch]``
        labels, built at first use and memoized. A classifier only, as the
        reference gates it."""
        w = self._weights
        if w.packed is None:
            raise ValueError("the serve_packed programs serve a classify "
                             f"checkpoint; this one has task={self.cfg.task!r}")
        if self.cfg.resolution % 8:
            raise ValueError(f"the packed wire needs a resolution divisible "
                             f"by 8, got {self.cfg.resolution}")
        return w.packed.get(batch)

    def forward_padded(self, voxels: np.ndarray, batch: int | None = None) -> np.ndarray:
        """Probabilities (a segmenter: int8 per-voxel labels) for an
        already padded ``[batch, R, R, R, 1]`` array, read back to the
        host. The continuous batcher calls this once per dispatch with its
        chosen bucket."""
        if batch is not None and voxels.shape[0] != batch:
            raise ValueError(f"padded batch {voxels.shape[0]} != bucket {batch}")
        x = torch.from_numpy(np.ascontiguousarray(voxels, dtype=np.float32))
        return self.forward(x).cpu().numpy()

    def forward(self, voxels: torch.Tensor) -> torch.Tensor:
        """Probabilities (a segmenter: int8 labels) on the device for ``[B,
        R, R, R, 1]`` voxels (on the device or the host): one dispatch, the
        program at batch ``B`` of the live generation, read once."""
        w = self._weights
        out = w.programs.get(voxels.shape[0])(voxels)
        if self.device.type == "cuda":
            with self._replay_lock:
                self.replays += 1
        return out

    def forward_eager(self, voxels: torch.Tensor) -> torch.Tensor:
        """The live generation's eager forward of ``voxels`` on the device:
        what its programs captured, for comparing and timing the two."""
        return self._weights.programs.body(voxels)

    def predict_voxels(self, grids: np.ndarray, canonicalize: bool = False,
                       tta_rotations: bool = False
                       ) -> tuple[np.ndarray, np.ndarray]:
        """Classify ``[N, R, R, R]`` (or ``[N,R,R,R,1]``) occupancy grids.
        Returns ``(labels int32 [N], probs float32 [N, num_classes])``.

        ``tta_rotations=True``: the mean probability over the 24 cube
        rotations of each part (24 times the device work).
        ``canonicalize=True``: each part's pose is undone on the host
        first (min-AABB search and re-voxelization, ``data/
        canonicalize.py``); implies ``tta_rotations``."""
        if self.cfg.task == "segment":
            raise ValueError(
                "this Predictor wraps a segmentation checkpoint; use "
                "predict_voxels_seg (per-voxel labels), not class "
                "probabilities")
        g = self._validated(grids)
        n = g.shape[0]
        if n == 0:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, self.cfg.arch.num_classes), np.float32))
        if canonicalize:
            from featurenet_tpu_torch.data.canonicalize import (
                canonicalize as _canon,
            )

            g = np.stack([_canon(g[i, ..., 0] > 0.5).astype(np.float32)
                          for i in range(n)])[..., None]
            tta_rotations = True  # the vote resolves the 24-fold ambiguity
        probs = self._tta_forward(g) if tta_rotations else self._batched_forward(g)
        return probs.argmax(axis=-1).astype(np.int32), probs

    @torch.inference_mode()
    def _tta_forward(self, g: np.ndarray) -> np.ndarray:
        """Mean probabilities over the 24 ``CUBE_GROUP`` rotations of each
        part of ``g`` ``[N, R, R, R, 1]``. Per chunk of ``batch`` parts:
        one upload, then the rotation-major stream of (rotation, part)
        rows, made on the device into a staging batch and run through the
        program at ``batch``; each part's rows are added in rotation
        order in fp32."""
        b, rots = self.batch, len(CUBE_GROUP)
        classes = self.cfg.arch.num_classes
        out = np.empty((g.shape[0], classes), np.float32)
        staging = torch.empty((b,) + g.shape[1:], dtype=torch.float32,
                              device=self.device)
        for s in range(0, g.shape[0], b):
            parts = torch.from_numpy(np.ascontiguousarray(g[s:s + b])).to(self.device)
            m = parts.shape[0]
            acc = torch.zeros((m, classes), dtype=torch.float32, device=self.device)
            total = rots * m
            for row0 in range(0, total, b):
                rows = min(b, total - row0)
                spans = []  # (staging row, part, count) of one rotation each
                k = 0
                while k < rows:
                    r, i = divmod(row0 + k, m)
                    take = min(m - i, rows - k)
                    perm, flips = CUBE_GROUP[r]
                    staging[k:k + take].copy_(
                        apply_rotation(parts[i:i + take], perm, flips))
                    spans.append((k, i, take))
                    k += take
                if rows < b:
                    staging[rows:].zero_()
                probs = self.forward(staging)
                for k, i, take in spans:
                    acc[i:i + take] += probs[k:k + take]
            out[s:s + m] = (acc / rots).cpu().numpy()
        return out

    def _batched_forward(self, g: np.ndarray) -> np.ndarray:
        """Chunk/pad ``g`` to the compile batch, run, trim, concat. In a
        run each chunk is an ``infer_batch`` span (the ``serving_ms``
        window): the forward and its readback, the request's latency. The
        same wall folds into the ``mfu`` window against the program's
        ``flops``."""
        out = []
        for s in range(0, g.shape[0], self.batch):
            chunk = g[s:s + self.batch]
            pad = self.batch - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)]
                )
            t0 = time.perf_counter()
            with obs.span("infer_batch", n=self.batch - pad, batch=self.batch):
                y = self.forward_padded(chunk)
            _perf.observe_dispatch(self.program_for(self.batch).cost,
                                   time.perf_counter() - t0, peaks=self._peaks)
            out.append(y[: self.batch - pad])
        return np.concatenate(out, axis=0)

    def _validated(self, grids: np.ndarray) -> np.ndarray:
        g = np.asarray(grids, dtype=np.float32)
        if g.ndim == 4:
            g = g[..., None]
        R = self.cfg.resolution
        if g.shape[1:] != (R, R, R, 1):
            raise ValueError(f"expected [N,{R},{R},{R}(,1)] grids, got {g.shape}")
        return g

    def predict_voxels_seg(self, grids: np.ndarray) -> np.ndarray:
        """Per-voxel labels of ``[N, R, R, R]`` (or ``[N,R,R,R,1]``) grids
        from a segmentation checkpoint: int8 ``[N, R, R, R]``, 0 = stock or
        air, 1+c = feature class c."""
        if self.cfg.task != "segment":
            raise ValueError("this Predictor wraps a classification "
                             "checkpoint; use predict_voxels")
        g = self._validated(grids)
        if g.shape[0] == 0:
            r = self.cfg.resolution
            return np.zeros((0, r, r, r), np.int8)
        return self._batched_forward(g)

    def predict_stl(self, paths: Sequence[str], fill: bool = True
                    ) -> list[Prediction] | list[SegPrediction]:
        """End-to-end: STL file → normalized voxel grid → class + top-3, or
        for a segmentation checkpoint the per-voxel labels and their
        feature-voxel counts (``SegPrediction``)."""
        if not paths:
            return []
        R = self.cfg.resolution
        grids = np.stack([voxelize(load_stl(p), R, fill=fill) for p in paths])
        if self.cfg.task == "segment":
            return [SegPrediction(path=path, voxel_counts=voxel_counts(lab),
                                  labels=lab)
                    for path, lab in zip(paths, self.predict_voxels_seg(grids))]
        labels, probs = self.predict_voxels(grids)
        out = []
        for path, lab, pr in zip(paths, labels, probs):
            order = np.argsort(pr)[::-1][:3]
            out.append(Prediction(
                path=path, label=int(lab), class_name=CLASS_NAMES[int(lab)],
                prob=float(pr[lab]),
                top3=[(CLASS_NAMES[i], float(pr[i])) for i in order],
            ))
        return out
