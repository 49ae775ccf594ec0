"""Continuous batcher: the serving front end's scheduling core (port of
``featurenet_tpu/serve/batcher.py``).

Requests are numpy arrays and the model is an injected
``forward(bucket, padded)`` callable, so everything here runs on a bare CPU
with a fake forward.

- **Flush policy**: a batch dispatches when the queue reaches the largest
  bucket OR the oldest pending request has waited ``max_wait_ms``.
- **Bucket ladder**: the batch is padded to the smallest configured bucket
  that fits it (``pick_bucket``); buckets are the only shapes dispatched.
  A deadline flush that would fill its bucket less than half takes a full
  smaller bucket instead and leaves the rest queued.
- **De-mux**: each request's future receives its own output row; padding
  rows are dropped. A forward error resolves every future of that batch
  with the error.
- **Admission control**: at the queue bound (or a lane's bound) ``submit``
  fast-rejects with ``OverloadError``.
- **Priority lanes**: ``interactive`` (default) and ``batch``; a per-lane
  cap lets ``batch`` shed first.

Telemetry, never load-bearing (``obs/``): each request feeds
``queue_wait_ms`` (enqueue → dispatch) and ``serving_ms`` (enqueue →
response) into the rolling windows; the batcher emits ``serve_start``
(from the service), ``serve_batch`` per dispatch (``bucket``, ``n``,
``pad``, ``batch_seq``, ``dur_ms``), ``overload`` per rejection and
``serve_stop`` at its first drain. ``submit`` mints or adopts a trace
context per request (``obs/tracing.py``); the dispatcher stamps each with
the ``batch_seq`` it rode and completes it at de-mux with the queue and
device split. Rejections, forward errors and requests over
``trace_slo_ms`` are always sampled; the rest at ``trace_sample``.

Injected, so the batcher stays free of any backend:

- ``cost_for(bucket)`` (the bucket's program cost) and ``peaks`` (the
  card's peak row): each successful dispatch's wall, forward and readback,
  folds into the ``mfu`` window (``obs/perf.py``);
- ``on_result(p, row, total_ms, outcome)`` per answered request (``row``
  is None on a forward error) and ``on_reject(p)`` per rejection: the
  service's quality tracker and flight recorder. Both are telemetry: what
  they raise is counted and swallowed.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

from featurenet_tpu_torch import obs
from featurenet_tpu_torch.obs import tracing as _tracing
from featurenet_tpu_torch.obs import windows as _windows

DEFAULT_BUCKETS = (1, 4, 16, 64)
DEFAULT_MAX_WAIT_MS = 5.0
DEFAULT_QUEUE_LIMIT = 64

# Unknown lane strings normalize to "interactive": a misspelled priority
# degrades to the stricter admission, never to silent bulk treatment.
LANES = ("interactive", "batch")


def normalize_lane(lane: Optional[str]) -> str:
    return lane if lane in LANES else "interactive"


class OverloadError(RuntimeError):
    """Fast rejection at the admission bound. ``response`` is the wire
    body the HTTP front end returns with a 503; ``retry_after_s`` is the
    backoff hint it sends as ``Retry-After``."""

    def __init__(self, queue_depth: int, limit: int,
                 trace_id: Optional[str] = None,
                 lane: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(f"serving queue full ({queue_depth}/{limit})")
        self.queue_depth = int(queue_depth)
        self.limit = int(limit)
        # The rejected request's trace id, which the HTTP layer echoes.
        self.trace_id = trace_id
        self.lane = lane
        self.retry_after_s = retry_after_s

    @property
    def response(self) -> dict:
        out = {"error": "overload", "queue_depth": self.queue_depth,
               "limit": self.limit}
        if self.lane is not None:
            out["lane"] = self.lane
        if self.retry_after_s is not None:
            out["retry_after_s"] = round(self.retry_after_s, 3)
        return out


def normalize_buckets(buckets: Sequence[int]) -> tuple[int, ...]:
    """The bucket ladder: sorted, deduplicated, all >= 1."""
    bs = tuple(sorted({int(b) for b in buckets}))
    if not bs or bs[0] < 1:
        raise ValueError(f"buckets must be positive batch sizes, got {buckets!r}")
    return bs


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that fits ``n`` rows (else the largest)."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


class PendingRequest:
    """One enqueued request: a future resolved with this request's own
    output row (or the batch's forward error), carrying its trace
    context."""

    __slots__ = ("voxels", "t_enq", "t_done", "value", "error", "_event",
                 "ctx", "lane")

    def __init__(self, voxels: np.ndarray,
                 ctx: Optional[_tracing.TraceContext] = None,
                 lane: str = "interactive"):
        self.voxels = voxels
        self.lane = lane
        self.t_enq = time.perf_counter()
        self.t_done: Optional[float] = None
        self.value = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self.ctx = ctx

    @property
    def trace_id(self) -> Optional[str]:
        return self.ctx.trace_id if self.ctx is not None else None

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_ms(self) -> Optional[float]:
        """Enqueue → response, once resolved."""
        if self.t_done is None:
            return None
        return (self.t_done - self.t_enq) * 1e3

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"serving request not answered within {timeout}s")
        if self.error is not None:
            raise RuntimeError(f"serving forward failed: {self.error}") from self.error
        return self.value


class ContinuousBatcher:
    """Bounded request queue + one dispatcher thread implementing the
    flush / bucket / de-mux / admission contract in the module doc.

    ``forward(bucket, padded)`` receives a ``[bucket, ...]`` array whose
    first ``n <= bucket`` rows are real requests and returns an indexable
    ``[bucket, ...]`` result (row i answers request i). ``trace_sample``
    is the healthy-traffic sampling rate; a request over ``trace_slo_ms``
    is always sampled.
    """

    def __init__(self, forward: Callable, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
                 queue_limit: int = DEFAULT_QUEUE_LIMIT,
                 trace_sample: float = 1.0,
                 trace_slo_ms: Optional[float] = None,
                 lane_limits: Optional[dict] = None,
                 cost_for: Optional[Callable] = None,
                 peaks: Optional[dict] = None,
                 on_result: Optional[Callable] = None,
                 on_reject: Optional[Callable] = None):
        bs = normalize_buckets(buckets)
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        for lane, lim in (lane_limits or {}).items():
            if lane not in LANES:
                raise ValueError(
                    f"unknown lane {lane!r} in lane_limits; known lanes: "
                    f"{', '.join(LANES)}"
                )
            if lim < 0:
                raise ValueError(f"lane_limits[{lane!r}] must be >= 0, got {lim}")
        if not (0.0 <= trace_sample <= 1.0):
            raise ValueError(f"trace_sample must be in [0, 1], got {trace_sample}")
        self.forward = forward
        self.cost_for = cost_for
        self.peaks = peaks
        self.on_result = on_result
        self.on_reject = on_reject
        self._hook_errors = 0
        self.trace_sample = float(trace_sample)
        self.trace_slo_ms = trace_slo_ms
        self.buckets = bs
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.queue_limit = int(queue_limit)
        self.lane_limits = dict(lane_limits or {})
        # The queue turns over on the flush-deadline cadence, so "come back
        # after ~2 deadlines" is the earliest a retry could find room.
        self.retry_after_s = max(0.05, 2.0 * self.max_wait_s)
        self._cv = threading.Condition()
        self._queue: deque[PendingRequest] = deque()
        self._lane_depth: dict[str, int] = {}
        self._lane_rejected: dict[str, int] = {}
        self._draining = False
        self._stopped = False
        self._served = 0
        self._rejected = 0
        self._errors = 0
        self._batches = 0
        self._rows = 0
        self._capacity = 0
        # The dispatch sequence number, advanced by the dispatcher thread
        # alone; serve_batch and each request_dispatch carry it.
        self._batch_seq = 0
        self._by_bucket: dict[int, int] = {}
        self._worker = threading.Thread(target=self._run, name="serve-batcher",
                                        daemon=True)
        self._worker.start()

    # -- producer side -------------------------------------------------------
    def submit(self, voxels: np.ndarray, trace_id: Optional[str] = None,
               lane: str = "interactive") -> PendingRequest:
        """Enqueue one request; returns its future. Raises ``OverloadError``
        at the queue or lane bound and ``RuntimeError`` after ``drain()``.
        ``trace_id`` adopts the caller's id; ``None`` mints one."""
        lane = normalize_lane(lane)
        p = PendingRequest(voxels, lane=lane)
        with self._cv:
            if self._draining:
                raise RuntimeError("batcher is draining; no new requests accepted")
            # Admitted after the draining check, so a refusal there is no
            # admitted trace (admitted = done + rejected).
            ctx = p.ctx = _tracing.admit(trace_id, self.trace_sample)
            depth = len(self._queue)
            lane_cap = self.lane_limits.get(lane)
            if depth >= self.queue_limit or (
                lane_cap is not None and self._lane_depth.get(lane, 0) >= lane_cap
            ):
                self._rejected += 1
                self._lane_rejected[lane] = self._lane_rejected.get(lane, 0) + 1
            else:
                self._queue.append(p)
                self._lane_depth[lane] = self._lane_depth.get(lane, 0) + 1
                self._cv.notify_all()
                depth = -1
        if depth >= 0:
            # Outside the lock: a slow filesystem must not lengthen
            # admission.
            obs.emit("overload", queue_depth=depth, limit=self.queue_limit,
                     lane=lane)
            _tracing.reject(ctx, depth, self.queue_limit)
            if self.on_reject is not None:
                try:
                    self.on_reject(p)
                except Exception:
                    # Another thread (the dispatcher's hook) counts too.
                    with self._cv:
                        self._hook_errors += 1
            raise OverloadError(depth, self.queue_limit, trace_id=ctx.trace_id,
                                lane=lane, retry_after_s=self.retry_after_s)
        return p

    # -- dispatcher thread ---------------------------------------------------
    def _run(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            self._dispatch(batch)

    def _next_batch(self) -> Optional[list[PendingRequest]]:
        """Block until the flush policy says dispatch; None = drained."""
        max_b = self.buckets[-1]
        with self._cv:
            while not self._queue:
                if self._draining:
                    return None
                self._cv.wait()
            # Draining flushes immediately: a shutdown must not pad out
            # its own deadline.
            while len(self._queue) < max_b and not self._draining:
                now = time.perf_counter()
                deadline = self._queue[0].t_enq + self.max_wait_s
                if now >= deadline:
                    break
                self._cv.wait(timeout=deadline - now)
            k = min(len(self._queue), max_b)
            fit = pick_bucket(k, self.buckets)
            if fit > k and 2 * k < fit:
                full = [b for b in self.buckets if b <= k]
                if full:
                    k = full[-1]
            batch = [self._queue.popleft() for _ in range(k)]
            for p in batch:
                self._lane_depth[p.lane] -= 1
            return batch

    def _dispatch(self, batch: list[PendingRequest]) -> None:
        n = len(batch)
        bucket = pick_bucket(n, self.buckets)
        self._batch_seq += 1
        seq = self._batch_seq
        t_disp = time.perf_counter()
        for p in batch:
            _windows.observe("queue_wait_ms", (t_disp - p.t_enq) * 1e3)
            _tracing.dispatch(p.ctx, seq, bucket, bucket - n)
        arr = np.stack([p.voxels for p in batch])
        if bucket > n:
            arr = np.concatenate(
                [arr, np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)]
            )
        out = None
        err: Optional[BaseException] = None
        try:
            with obs.span("serve_dispatch", bucket=bucket, n=n, batch_seq=seq):
                out = self.forward(bucket, arr)
        except Exception as e:  # resolve the batch; the batcher survives
            err = e
        t_done = time.perf_counter()
        outcome = "error" if err is not None else "ok"
        if err is None and self.cost_for is not None:
            from featurenet_tpu_torch.obs import perf as _perf

            # The forward returns a host array, so the wall spans the
            # replay and its readback: the served batch's own wall.
            _perf.observe_dispatch(self.cost_for(bucket), t_done - t_disp,
                                   peaks=self.peaks)
        # Counted before any request is answered: a client that reads
        # /stats or /metrics right after its answer sees its request.
        with self._cv:
            self._batches += 1
            self._rows += n
            self._capacity += bucket
            self._by_bucket[bucket] = self._by_bucket.get(bucket, 0) + 1
            if err is None:
                self._served += n
            else:
                self._errors += n
        for i, p in enumerate(batch):
            if err is not None:
                p.error = err
            else:
                p.value = out[i]
            p.t_done = t_done
            p._event.set()
            # Queue wait + dispatch + device + readback: what an SLO is
            # written against.
            _windows.observe("serving_ms", (t_done - p.t_enq) * 1e3)
            _tracing.done(p.ctx, queue_wait_ms=(t_disp - p.t_enq) * 1e3,
                          dispatch_ms=(t_done - t_disp) * 1e3,
                          total_ms=(t_done - p.t_enq) * 1e3, outcome=outcome,
                          slo_ms=self.trace_slo_ms)
            if self.on_result is not None:
                try:
                    self.on_result(p, None if err is not None else out[i],
                                   (t_done - p.t_enq) * 1e3, outcome)
                except Exception:
                    with self._cv:
                        self._hook_errors += 1
        obs.emit("serve_batch", bucket=bucket, n=n, pad=bucket - n,
                 batch_seq=seq, dur_ms=round((t_done - t_disp) * 1e3, 3))

    # -- lifecycle / introspection -------------------------------------------
    def stats(self) -> dict:
        with self._cv:
            cap = self._capacity
            return {
                "served": self._served,
                "rejected": self._rejected,
                "errors": self._errors,
                "batches": self._batches,
                # Real rows / padded capacity: the padding tax of the ladder.
                "occupancy": round(self._rows / cap, 4) if cap else None,
                "by_bucket": dict(sorted(self._by_bucket.items())),
                "queue_depth": len(self._queue),
                "by_lane": {
                    lane: {
                        "queued": self._lane_depth.get(lane, 0),
                        "rejected": self._lane_rejected.get(lane, 0),
                        "limit": self.lane_limits.get(lane),
                    }
                    for lane in LANES
                    if self._lane_depth.get(lane, 0)
                    or self._lane_rejected.get(lane, 0)
                    or lane in self.lane_limits
                },
            }

    def drain(self, timeout_s: float = 30.0) -> dict:
        """Stop accepting, answer everything admitted, stop the dispatcher
        and return final stats; ``drain_timeout`` is true when the join
        timed out (a wedged forward), with a warning. The first drain emits
        ``serve_stop``. Idempotent."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        self._worker.join(timeout=timeout_s)
        st = self.stats()
        st["drain_timeout"] = self._worker.is_alive()
        if st["drain_timeout"]:
            obs.warn("serve_drain_timeout",
                     f"dispatcher still running {timeout_s}s after drain; "
                     f"{st['queue_depth']} request(s) may go unanswered")
        with self._cv:
            first = not self._stopped
            self._stopped = True
        if first:
            obs.emit("serve_stop", served=st["served"], rejected=st["rejected"])
        return st
