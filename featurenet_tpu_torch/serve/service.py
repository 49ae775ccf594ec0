"""The inference service: a ``Predictor`` behind the continuous batcher
(port of ``featurenet_tpu/serve/service.py`` without its alerts, quality
plane, flight recorder and incidents).

- **Warmup**: construction builds the Predictor's serving program for
  every bucket (``Predictor.program_for``, the largest first), so the
  kernels are built and loaded and every shape the batcher can dispatch is
  a captured CUDA graph on the card before the first request.
- **Hot swap**: ``reload`` (``POST /admin/reload``) verifies a candidate
  checkpoint and swaps the Predictor's weight generation under traffic
  (``Predictor.swap_params``); the replica is cordoned (not ready) while it
  swaps, and a refusal leaves the old generation serving.
- **Tasks**: a classifier answers each request with its class and top-3,
  a segmenter with the feature-voxel counts of its per-voxel labels
  (``format_row``); a segment checkpoint hot-swaps like a classify one.
- **Precision**: the service serves its ``Predictor``'s precision
  (``fp32``, ``bf16``, ``int8``), which ``stats`` (``GET /stats``) reports.
- **The upload path**: ``submit_stl_bytes`` parses and voxelizes raw STL
  bytes in the caller's thread (an HTTP worker), never the dispatch
  thread, then enqueues the grid.
- **Fault sites** (``faults.py``): ``replica_slow@request=N`` drags the
  Nth forward by ``SLOW_SLEEP_S``; ``reload`` counts its attempts, and at
  the Nth ``replica_loss_rollout@swap=N`` SIGKILLs this process before
  the cordon, ``swap_corrupt@swap=N`` refuses the candidate with the
  ``ChecksumMismatch`` a real mismatch raises (the old generation serves
  on).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional, Sequence

import numpy as np

from featurenet_tpu_torch import faults
from featurenet_tpu_torch.data.stl import parse_stl
from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
from featurenet_tpu_torch.data.voxelize import voxelize
from featurenet_tpu_torch.infer import voxel_counts
from featurenet_tpu_torch.serve.batcher import (
    DEFAULT_BUCKETS,
    DEFAULT_MAX_WAIT_MS,
    DEFAULT_QUEUE_LIMIT,
    ContinuousBatcher,
    PendingRequest,
    normalize_buckets,
    normalize_lane,
)
from featurenet_tpu_torch.train.checkpoint import CheckpointManager, ChecksumMismatch


class InferenceService:
    """Continuous-batching serving over a ``Predictor``.

    ``batch_queue_limit`` caps the ``batch`` lane (default: half the
    admission bound), so bulk traffic sheds before interactive traffic.
    """

    def __init__(self, predictor, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
                 queue_limit: int = DEFAULT_QUEUE_LIMIT,
                 batch_queue_limit: Optional[int] = None):
        self.predictor = predictor
        self.cfg = predictor.cfg
        # The Predictor's serving precision (None for a predictor that
        # names none).
        self.precision = getattr(predictor, "precision", None)
        self.buckets = normalize_buckets(buckets)
        self._t_start = time.perf_counter()
        self._ready = False
        self._reload_cordon = False
        self._swap_lock = threading.Lock()
        self._forwards = 0  # the fault sites' counters
        self._swaps = 0
        for b in sorted(self.buckets, reverse=True):
            predictor.program_for(b)
        if batch_queue_limit is None:
            batch_queue_limit = max(1, queue_limit // 2)
        self.batcher = ContinuousBatcher(
            self._forward, buckets=self.buckets, max_wait_ms=max_wait_ms,
            queue_limit=queue_limit,
            lane_limits={"batch": int(batch_queue_limit)},
        )
        self._ready = True

    def _forward(self, bucket: int, padded: np.ndarray) -> np.ndarray:
        self._forwards += 1
        if faults.maybe_fail("replica_slow", request=self._forwards):
            time.sleep(faults.SLOW_SLEEP_S)  # latency, not death
        return self.predictor.forward_padded(padded, batch=bucket)

    # -- request entry points ------------------------------------------------
    def submit_voxels(self, grid: np.ndarray,
                      lane: str = "interactive") -> PendingRequest:
        """Enqueue one ``[R,R,R]`` (or ``[R,R,R,1]``) occupancy grid."""
        g = np.asarray(grid, dtype=np.float32)
        if g.ndim == 3:
            g = g[..., None]
        R = self.cfg.resolution
        if g.shape != (R, R, R, 1):
            raise ValueError(f"expected one [{R},{R},{R}(,1)] grid, got {g.shape}")
        return self.batcher.submit(g, lane=normalize_lane(lane))

    def submit_stl_bytes(self, data: bytes, fill: bool = True,
                         lane: str = "interactive") -> PendingRequest:
        """Raw STL bytes → parse → normalize+voxelize → enqueue; malformed
        bytes raise ``ValueError`` before anything is admitted."""
        grid = voxelize(parse_stl(data), self.cfg.resolution, fill=fill)
        return self.submit_voxels(grid.astype(np.float32), lane=lane)

    def format_row(self, row: np.ndarray) -> dict:
        """One request's output row as the wire response: class + top-3 of
        a probability row, or for a segmentation checkpoint the
        feature-voxel counts of its label grid (``voxel_counts``)."""
        if self.cfg.task == "segment":
            return {"voxel_counts": voxel_counts(row)}
        probs = np.asarray(row, np.float32)
        label = int(probs.argmax())
        order = np.argsort(probs)[::-1][:3]
        return {
            "label": label,
            "class_name": CLASS_NAMES[label],
            "prob": float(probs[label]),
            "top3": [(CLASS_NAMES[int(i)], float(probs[i])) for i in order],
        }

    def predict(self, fut: PendingRequest, timeout: Optional[float] = None) -> dict:
        return self.format_row(fut.result(timeout))

    # -- lifecycle -----------------------------------------------------------
    def stats(self) -> dict:
        """The batcher's counters and the Predictor's serving precision."""
        return {**self.batcher.stats(), "precision": self.precision}

    def ready(self) -> bool:
        """True between warmup completing and drain beginning, except while
        ``reload`` swaps the weights (the cordon)."""
        return self._ready and not self._reload_cordon

    def reloading(self) -> bool:
        """True while ``reload`` is mid-swap: the replica is not ready but
        alive and answering."""
        return self._reload_cordon

    def health(self) -> dict:
        """The /healthz payload: readiness, uptime, queue depth, and which
        weights this replica serves and where they came from."""
        out = {
            "ready": self.ready(),
            "uptime_s": round(time.perf_counter() - self._t_start, 3),
            "queue_depth": self.batcher.stats()["queue_depth"],
            "model_version": getattr(self.predictor, "model_version",
                                     "unversioned"),
        }
        ckpt = getattr(self.predictor, "checkpoint_dir", None)
        if ckpt is not None:
            out["checkpoint_dir"] = ckpt
        return out

    def reload(self, checkpoint_dir: str) -> dict:
        """Zero-downtime weight hot swap (``POST /admin/reload``): verify the
        candidate's newest step against its checksum sidecar, then swap the
        Predictor's generation (``Predictor.swap_params``). The restore,
        the cast and the captures run here, on the caller's thread (an HTTP
        worker), never the dispatch thread, so requests keep being answered
        throughout. Any failure (no step, a checksum mismatch, another
        identity, an unreadable checkpoint, a failed capture) raises before
        the flip and leaves the old generation serving. One swap at a
        time."""
        with self._swap_lock:
            self._swaps += 1
            n = self._swaps
            from_version = getattr(self.predictor, "model_version", "unversioned")
            if faults.maybe_fail("replica_loss_rollout", swap=n):
                os.kill(os.getpid(), signal.SIGKILL)  # death mid-reload
            t0 = time.perf_counter()
            self._reload_cordon = True
            try:
                mgr = CheckpointManager(checkpoint_dir)
                try:
                    step = mgr.latest_step()
                    if step is None:
                        raise ValueError("no finalized checkpoint step in "
                                         f"{checkpoint_dir!r}")
                    if faults.maybe_fail("swap_corrupt", swap=n):
                        raise ChecksumMismatch(
                            "injected swap_corrupt: candidate checkpoint "
                            "fails content verification")
                    mgr.verify(step)
                finally:
                    mgr.close()
                version = self.predictor.swap_params(checkpoint_dir)
            finally:
                self._reload_cordon = False
            return {
                "ok": True,
                "model_version": version,
                "from_version": from_version,
                "swap_ms": round((time.perf_counter() - t0) * 1e3, 3),
            }

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Stop accepting and answer everything admitted; ``exit_code`` is
        2 when the drain timed out with requests unanswered, else 0."""
        self._ready = False
        st = self.batcher.drain(timeout_s)
        st["exit_code"] = 2 if st["drain_timeout"] else 0
        return st
