"""The inference service: a ``Predictor`` behind the continuous batcher,
with an SLO-gated drain and an incident manager (port of
``featurenet_tpu/serve/service.py``).

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
- **SLO gating**: the service installs alert rules over the serving
  windows (``serve_rules``: end-to-end ``serving_p99_ms`` and
  ``queue_wait_ms_p99`` against ``slo_p99_ms``; a ``rules`` list replaces
  them, ``rules=()`` leaves the installed aggregator alone). ``drain()``
  flushes the last window cycle and reports the serving alerts still
  unresolved; its ``exit_code`` is 2 on such an alert or on a drain
  timeout, else 0. Requests carry trace ids (``obs/tracing.py``) at
  ``Config.trace_sample``; ``serve_start``, ``serve_batch``, ``overload``,
  ``serve_stop`` and ``swap`` events go to the run's sink when one is
  installed (``obs.init_run``).
- **Incidents**: with a ``run_dir`` the service arms the process-wide
  incident manager (``obs/incidents.py``): a serving alert firing over the
  windows opens an incident, freezes a bundle under
  ``<run_dir>/incidents/`` and keeps every request's trace until the alert
  resolves. ``drain()`` adds the manager's counters (``incidents``) and
  disarms it.
- **Perf**: each bucket's program cost (``ServeProgram.cost``, captured at
  warmup) and the card's peak row go to the batcher, which folds each
  dispatch's wall into the ``mfu`` window (``obs/perf.py``).
- **Model quality** (a classifier only; a segmenter is refused):
  ``quality`` (an ``obs.quality.QualityTracker``) takes each answered
  request's top-1 confidence, margin, entropy and label, and its alert
  rules (``quality_rules``: the confidence floor, and the drift ceiling
  when a baseline is pinned) join ``serve_rules``; ``recorder`` (a
  ``serve.recorder.FlightRecorder``) is offered every answered, failed and
  rejected request. Both run in the batcher's hooks, which swallow what
  they raise.
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

from featurenet_tpu_torch import faults, obs
from featurenet_tpu_torch.data.stl import parse_stl
from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
from featurenet_tpu_torch.data.voxelize import voxelize
from featurenet_tpu_torch.infer import voxel_counts
from featurenet_tpu_torch.obs import alerts as _alerts
from featurenet_tpu_torch.obs import perf as _perf
from featurenet_tpu_torch.obs import quality as _quality
from featurenet_tpu_torch.obs import windows as _windows
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

# The default p99 end-to-end SLO of the serving rules: generous, so an
# unconfigured service still notices a pathological tail.
DEFAULT_SLO_P99_MS = 250.0


def serve_rules(slo_p99_ms: float = DEFAULT_SLO_P99_MS) -> list:
    """The default rules plus the two serving rules: end-to-end p99
    latency over the SLO (critical) and queue-wait p99 over it."""
    return list(_alerts.DEFAULT_RULES) + [
        _alerts.AlertRule("serving_p99_ms", ">", float(slo_p99_ms), "critical"),
        _alerts.AlertRule("queue_wait_ms_p99", ">", float(slo_p99_ms), "warning"),
    ]


class InferenceService:
    """Continuous-batching serving over a ``Predictor``.

    ``rules=None`` installs ``serve_rules(slo_p99_ms)`` over the rolling
    windows, a rule list installs those, ``rules=()`` leaves the installed
    aggregator alone. ``batch_queue_limit`` caps the ``batch`` lane
    (default: half the admission bound), so bulk traffic sheds before
    interactive traffic. ``run_dir`` arms the incident manager over that
    run directory (the caller installs its event sink, ``obs.init_run``).
    """

    def __init__(self, predictor, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
                 queue_limit: int = DEFAULT_QUEUE_LIMIT,
                 rules: Optional[Sequence] = None,
                 slo_p99_ms: float = DEFAULT_SLO_P99_MS,
                 batch_queue_limit: Optional[int] = None,
                 quality=None, recorder=None,
                 run_dir: Optional[str] = None):
        self.predictor = predictor
        self.cfg = predictor.cfg
        if (quality is not None or recorder is not None) \
                and self.cfg.task != "classify":
            raise ValueError(
                "quality telemetry and the flight recorder need a classify "
                f"checkpoint, got task={self.cfg.task!r}")
        self.quality = quality
        self.recorder = recorder
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
        costs = {b: getattr(predictor.program_for(b), "cost", None)
                 for b in sorted(self.buckets, reverse=True)}
        if rules is None:
            rules = serve_rules(slo_p99_ms)
            if quality is not None:
                # The drift rule only with a baseline to drift from.
                rules += list(_quality.quality_rules(
                    with_drift=quality.baseline is not None))
        if rules:
            _windows.install(_windows.WindowAggregator(rules=list(rules)))
        if batch_queue_limit is None:
            batch_queue_limit = max(1, queue_limit // 2)
        self.batcher = ContinuousBatcher(
            self._forward, buckets=self.buckets, max_wait_ms=max_wait_ms,
            queue_limit=queue_limit,
            trace_sample=getattr(self.cfg, "trace_sample", 1.0),
            trace_slo_ms=float(slo_p99_ms),
            lane_limits={"batch": int(batch_queue_limit)},
            cost_for=costs.get,
            peaks=_perf.local_device_peaks(getattr(predictor, "device", "cpu")),
            on_result=(self._on_result if quality is not None
                       or recorder is not None else None),
            on_reject=self._on_reject if recorder is not None else None,
        )
        self._incidents = None
        if run_dir is not None:
            from featurenet_tpu_torch.obs import incidents as _incidents

            self._incidents = _incidents.arm(run_dir)
        obs.emit("serve_start", buckets=list(self.buckets),
                 max_wait_ms=float(max_wait_ms), queue_limit=int(queue_limit))
        self._ready = True

    def _forward(self, bucket: int, padded: np.ndarray) -> np.ndarray:
        self._forwards += 1
        if faults.maybe_fail("replica_slow", request=self._forwards):
            time.sleep(faults.SLOW_SLEEP_S)  # latency, not death
        return self.predictor.forward_padded(padded, batch=bucket)

    # -- the batcher's hooks (telemetry: the batcher swallows what they
    # raise) ------------------------------------------------------------------
    def _on_result(self, p, row, total_ms: float, outcome: str) -> None:
        """Per answered request, on the dispatcher thread: reduce the
        probability row to floats for the tracker and offer the request to
        the recorder."""
        confidence = label = None
        if row is not None:
            probs = np.asarray(row, np.float32)
            label = int(probs.argmax())
            confidence, margin, entropy = _quality.confidence_stats(
                probs.tolist())
            if self.quality is not None:
                self.quality.observe(label, confidence, margin, entropy)
        if self.recorder is not None:
            self.recorder.maybe_capture(
                p.voxels, p.trace_id, label=label, confidence=confidence,
                total_ms=total_ms, outcome=outcome)

    def _on_reject(self, p) -> None:
        """Per rejection: always worth a capture."""
        self.recorder.maybe_capture(p.voxels, p.trace_id, outcome="rejected")

    # -- request entry points ------------------------------------------------
    def submit_voxels(self, grid: np.ndarray, trace_id: Optional[str] = None,
                      lane: str = "interactive") -> PendingRequest:
        """Enqueue one ``[R,R,R]`` (or ``[R,R,R,1]``) occupancy grid;
        ``trace_id`` adopts the caller's id (``None`` mints one)."""
        g = np.asarray(grid, dtype=np.float32)
        if g.ndim == 3:
            g = g[..., None]
        R = self.cfg.resolution
        if g.shape != (R, R, R, 1):
            raise ValueError(f"expected one [{R},{R},{R}(,1)] grid, got {g.shape}")
        return self.batcher.submit(g, trace_id=trace_id, lane=normalize_lane(lane))

    def submit_stl_bytes(self, data: bytes, fill: bool = True,
                         trace_id: Optional[str] = None,
                         lane: str = "interactive") -> PendingRequest:
        """Raw STL bytes → parse → normalize+voxelize → enqueue; malformed
        bytes raise ``ValueError`` before anything is admitted."""
        grid = voxelize(parse_stl(data), self.cfg.resolution, fill=fill)
        return self.submit_voxels(grid.astype(np.float32), trace_id=trace_id,
                                  lane=lane)

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
        """The batcher's counters, the Predictor's serving precision, and
        the quality tracker's and the recorder's counters when present."""
        st = {**self.batcher.stats(), "precision": self.precision}
        if self.quality is not None:
            st["quality"] = self.quality.stats()
        if self.recorder is not None:
            st["capture"] = self.recorder.stats()
        return st

    def ready(self) -> bool:
        """True between warmup completing and drain beginning, except while
        ``reload`` swaps the weights (the cordon)."""
        return self._ready and not self._reload_cordon

    def reloading(self) -> bool:
        """True while ``reload`` is mid-swap: the replica is not ready but
        alive and answering."""
        return self._reload_cordon

    def health(self) -> dict:
        """The /healthz payload: readiness, uptime, the last rolling-window
        emission seq, queue depth, and which weights this replica serves and
        where they came from."""
        out = {
            "ready": self.ready(),
            "uptime_s": round(time.perf_counter() - self._t_start, 3),
            "window_seq": _windows.last_seq(),
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
        time. Every attempt is a ``swap`` event."""
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
            except Exception as e:
                obs.emit("swap", ok=False, from_version=from_version,
                         swap_ms=round((time.perf_counter() - t0) * 1e3, 3),
                         checkpoint_dir=str(checkpoint_dir),
                         error=f"{type(e).__name__}: {e}")
                raise
            finally:
                self._reload_cordon = False
            swap_ms = round((time.perf_counter() - t0) * 1e3, 3)
            obs.emit("swap", ok=True, from_version=from_version,
                     swap_ms=swap_ms, to_version=version,
                     checkpoint_dir=str(checkpoint_dir))
            return {
                "ok": True,
                "model_version": version,
                "from_version": from_version,
                "swap_ms": swap_ms,
            }

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Stop accepting, answer everything admitted, flush the last window
        cycle and report the SLO verdict: ``active_serving_alerts`` names
        the serving alerts (``alerts.is_serving_metric``) still unresolved,
        and ``exit_code`` is 2 when there is one or the drain timed out with
        requests unanswered, else 0."""
        self._ready = False
        st = self.batcher.drain(timeout_s)
        _windows.flush()
        # The last cycle may have resolved an alert and closed its
        # incident: disarm after it, so durations cover the real window.
        if self._incidents is not None:
            from featurenet_tpu_torch.obs import incidents as _incidents

            st["incidents"] = self._incidents.stats()
            _incidents.disarm(self._incidents)
        active = [m for m in _windows.active_alerts()
                  if _alerts.is_serving_metric(m)]
        st["active_serving_alerts"] = active
        st["exit_code"] = 2 if (active or st["drain_timeout"]) else 0
        if self.recorder is not None:
            self.recorder.close()
            st["capture"] = self.recorder.stats()
        if self.quality is not None:
            st["quality"] = self.quality.stats()
        return st
