"""Inference: weights → class predictions for voxel grids or STL files
(port of ``featurenet_tpu/infer.py``'s ``Predictor``, fp32 serving).

Usage:
    p = Predictor.from_checkpoint("runs/ck")         # on the card
    p = Predictor(*load_npz("w.npz"))                # a convert.save_npz file
    labels, probs = p.predict_voxels(grids)          # [N,R,R,R] occupancy
    results = p.predict_stl(["part.stl", ...])       # end-to-end

Inputs are padded to the compile batch as in the JAX package, so every
dispatch has one of a few shapes. Canonicalization, test-time rotations,
bf16/int8 weights and hot swaps are not ported yet.
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
from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
from featurenet_tpu_torch.data.voxelize import voxelize
from featurenet_tpu_torch.runtime import build_model, resolve_device, serve_forward
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


class Predictor:
    """Eval-mode ``FeatureNet`` on one device, fed padded fixed-shape
    batches.

    ``state`` is a port ``state_dict`` (``convert.from_flax``,
    ``convert.load_npz``); ``device`` defaults to ``"cuda"`` and raises
    when there is no card, unless the caller asks for ``"cpu"``.
    """

    def __init__(self, state: dict[str, torch.Tensor], cfg: Config,
                 batch: int = 32, device="cuda",
                 model_version: str = "unversioned"):
        cfg.validate()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch = int(batch)
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.precision = cfg.serve_precision
        self.model_version = model_version
        model = build_model(cfg)
        model.load_state_dict(state)
        self.model = model.to(self.device)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        config: Config | str | None = None, batch: int = 32,
                        device="cuda") -> "Predictor":
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
                                                    mgr.restored_step))

    @classmethod
    def from_seed(cls, cfg: Config, seed: int, batch: int = 32,
                  device="cuda") -> "Predictor":
        """Random weights from ``seed`` (see ``models.featurenet.init_weights``)."""
        state = build_model(cfg, seed=seed).state_dict()
        return cls(state, cfg, batch=batch, device=device,
                   model_version=f"seed{seed}")

    def forward_padded(self, voxels: np.ndarray, batch: int | None = None) -> np.ndarray:
        """Probabilities for an already padded ``[batch, R, R, R, 1]`` array,
        read back to the host. The continuous batcher calls this once per
        dispatch with its chosen bucket."""
        if batch is not None and voxels.shape[0] != batch:
            raise ValueError(f"padded batch {voxels.shape[0]} != bucket {batch}")
        x = torch.from_numpy(np.ascontiguousarray(voxels, dtype=np.float32))
        probs = serve_forward(self.model, x.to(self.device))
        return probs.cpu().numpy()

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
