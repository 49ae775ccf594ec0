"""Inference: weights → class predictions for voxel grids or STL files
(port of ``featurenet_tpu/infer.py``'s ``Predictor``).

Usage:
    p = Predictor.from_checkpoint("runs/ck")         # on the card
    p = Predictor(*load_npz("w.npz"))                # a convert.save_npz file
    p = Predictor.from_checkpoint("runs/ck", precision="int8")
    labels, probs = p.predict_voxels(grids)          # [N,R,R,R] occupancy
    results = p.predict_stl(["part.stl", ...])       # end-to-end
    p.agreement()                                    # top-1 vs fp32 serving

Inputs are padded to the compile batch as in the JAX package, so every
dispatch has one of a few shapes.

``precision`` (default: the config's ``serve_precision``) is the serving
weight precision. ``fp32`` serves the masters. ``bf16`` casts a bf16
working copy of every parameter once, at construction, and keeps it on the
device. ``int8`` quantizes the weights once, at construction
(``runtime/quantize.py``), keeps the int8 tensors and their scales on the
device and dequantizes them for each dispatch, so int8 is what sits in
device memory. Under both reduced rungs the model's own parameters leave
the device (``meta`` placeholders, which a forward without the working
copy cannot read); the batch-norm statistics stay fp32 on the device, and
the fp32 masters stay on the host for ``agreement``.
``resident_weight_bytes`` counts the parameter bytes the device holds.

Canonicalization, test-time rotations and hot swaps are not ported yet.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Sequence

import numpy as np
import torch

from featurenet_tpu_torch.config import Config, check_identity, get_config
from featurenet_tpu_torch.data.stl import load_stl
from featurenet_tpu_torch.data.synthetic import CLASS_NAMES, generate_batch
from featurenet_tpu_torch.data.voxelize import voxelize
from featurenet_tpu_torch.runtime import build_model, resolve_device, serve_forward
from featurenet_tpu_torch.runtime.quantize import (
    agreement,
    dequantize_tree,
    quantize_tree,
    tree_bytes,
)
from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS, serve_params_cast
from featurenet_tpu_torch.train.checkpoint import (
    CheckpointManager,
    checksum_path,
    load_run_config,
)
from featurenet_tpu_torch.train.state import TrainState


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


def _drop_parameters(model: torch.nn.Module) -> None:
    """Replace every parameter of ``model`` by a ``meta`` placeholder of
    its shape and dtype, so its device memory is freed and only a forward
    that passes a working copy (``torch.func.functional_call``) runs."""
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is not None:
                module._parameters[name] = torch.nn.Parameter(
                    torch.empty_like(p, device="meta"), requires_grad=False)


class Predictor:
    """Eval-mode ``FeatureNet`` on one device, fed padded fixed-shape
    batches, at one serving precision (see the module docstring).

    ``state`` is a port ``state_dict`` (``convert.from_flax``,
    ``convert.load_npz``); ``device`` defaults to ``"cuda"`` and raises
    when there is no card, unless the caller asks for ``"cpu"``;
    ``precision`` defaults to ``cfg.serve_precision``, and an unknown one
    raises ``ValueError``.
    """

    def __init__(self, state: dict[str, torch.Tensor], cfg: Config,
                 batch: int = 32, device="cuda",
                 model_version: str = "unversioned",
                 precision: str | None = None):
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
        self.model_version = model_version
        model = build_model(cfg)
        model.load_state_dict(state)
        self._masters = {k: v.detach().clone()
                         for k, v in model.named_parameters()}
        self.model = model.to(self.device)
        on_device = {k: v.detach() for k, v in self.model.named_parameters()}
        # What each dispatch reads: the model's own parameters (fp32), a
        # resident bf16 copy, or resident int8 tensors and their scales.
        self._serve_params = self._qparams = self._scales = None
        if precision == "bf16":
            self._serve_params = serve_params_cast(on_device, "bf16")
        elif precision == "int8":
            self._qparams, self._scales = quantize_tree(on_device)
        if precision != "fp32":
            del on_device
            _drop_parameters(self.model)

    @property
    def resident_weight_bytes(self) -> int:
        """The parameter bytes this Predictor keeps on its device: fp32
        masters, the bf16 copy, or the int8 tensors (biases and batch-norm
        vectors fp32) with their scales."""
        if self.precision == "bf16":
            return tree_bytes(self._serve_params)
        if self.precision == "int8":
            return tree_bytes(self._qparams, self._scales)
        return tree_bytes(dict(self.model.named_parameters()))

    def _dispatch_params(self):
        """The parameters of one dispatch (``None``: the model's own)."""
        if self.precision == "bf16":
            return self._serve_params
        if self.precision == "int8":
            return dequantize_tree(self._qparams, self._scales)
        return None

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
        return cls(model.state_dict(), cfg, batch=batch, device=dev,
                   model_version=checkpoint_version(checkpoint_dir,
                                                    mgr.restored_step),
                   precision=precision)

    @classmethod
    def from_seed(cls, cfg: Config, seed: int, batch: int = 32,
                  device="cuda", precision: str | None = None) -> "Predictor":
        """Random weights from ``seed`` (see ``models.featurenet.init_weights``)."""
        state = build_model(cfg, seed=seed).state_dict()
        return cls(state, cfg, batch=batch, device=device,
                   model_version=f"seed{seed}", precision=precision)

    def agreement(self, n: int = 48, seed: int = 0,
                  reference_precision: str = "fp32",
                  candidate_precision: str | None = None) -> float:
        """Top-1 agreement between two serving precisions of this
        Predictor's weights (``candidate_precision`` defaults to its own)
        on ``n`` synthetic parts from ``seed``: the precision-agnostic
        accuracy gate (``runtime.quantize.agreement``)."""
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

    def forward_padded(self, voxels: np.ndarray, batch: int | None = None) -> np.ndarray:
        """Probabilities for an already padded ``[batch, R, R, R, 1]`` array,
        read back to the host. The continuous batcher calls this once per
        dispatch with its chosen bucket."""
        if batch is not None and voxels.shape[0] != batch:
            raise ValueError(f"padded batch {voxels.shape[0]} != bucket {batch}")
        x = torch.from_numpy(np.ascontiguousarray(voxels, dtype=np.float32))
        return self.forward(x.to(self.device)).cpu().numpy()

    def forward(self, voxels: torch.Tensor) -> torch.Tensor:
        """Probabilities on the device for ``[B, R, R, R, 1]`` voxels already
        there: one dispatch at this Predictor's precision."""
        return serve_forward(self.model, voxels, self._dispatch_params())

    def predict_voxels(self, grids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Classify ``[N, R, R, R]`` (or ``[N,R,R,R,1]``) occupancy grids.
        Returns ``(labels int32 [N], probs float32 [N, num_classes])``."""
        g = self._validated(grids)
        if g.shape[0] == 0:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, self.cfg.arch.num_classes), np.float32))
        probs = self._batched_forward(g)
        return probs.argmax(axis=-1).astype(np.int32), probs

    def _batched_forward(self, g: np.ndarray) -> np.ndarray:
        """Chunk/pad ``g`` to the compile batch, run, trim, concat."""
        out = []
        for s in range(0, g.shape[0], self.batch):
            chunk = g[s:s + self.batch]
            pad = self.batch - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)]
                )
            out.append(self.forward_padded(chunk)[: self.batch - pad])
        return np.concatenate(out, axis=0)

    def _validated(self, grids: np.ndarray) -> np.ndarray:
        g = np.asarray(grids, dtype=np.float32)
        if g.ndim == 4:
            g = g[..., None]
        R = self.cfg.resolution
        if g.shape[1:] != (R, R, R, 1):
            raise ValueError(f"expected [N,{R},{R},{R}(,1)] grids, got {g.shape}")
        return g

    def predict_stl(self, paths: Sequence[str], fill: bool = True) -> list[Prediction]:
        """End-to-end: STL file → normalized voxel grid → class + top-3."""
        if not paths:
            return []
        R = self.cfg.resolution
        grids = np.stack([voxelize(load_stl(p), R, fill=fill) for p in paths])
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
