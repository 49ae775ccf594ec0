"""Request-scoped tracing for the serving path (port of
``featurenet_tpu/obs/tracing.py``).

- A **trace id** is minted at admission, or taken from the caller's
  ``X-Featurenet-Trace`` header when it is well formed (at most 64 chars
  of ``[A-Za-z0-9._-]``; anything else is replaced by a minted one), and
  is echoed on the response.
- The batcher gives each request a ``TraceContext`` and records
  ``request_admit``, ``request_dispatch``, ``request_done`` and
  ``request_reject`` into the event stream. A dispatch carries its
  ``batch_seq``, which ties the N trace ids of one batch to its
  ``serve_batch`` event.
- **Tail-biased sampling**: events are buffered on the context and the
  keep-or-drop decision is made at completion, when the outcome is known.
  Rejections, errors and requests over the serving SLO are always kept;
  healthy traffic is kept at ``Config.trace_sample``, a pure hash of the
  trace id (``sampled``), so any two processes agree on it.

With no event sink installed nothing is buffered; a minted id costs one
``os.urandom`` read. While an incident is open (``obs/incidents.py``) the
incident manager sets ``set_force_all``: every request's timeline is kept,
so the bundle's events tail holds the bad window's complete traces. The
flag resets with the run's counters.
"""

from __future__ import annotations

import hashlib
import os
import re
import threading
import time
from typing import Optional

from featurenet_tpu_torch.obs import events as _events

# The propagation header: read on the request, echoed on every response.
TRACE_HEADER = "X-Featurenet-Trace"

_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (64 random bits)."""
    return os.urandom(8).hex()


def normalize_trace_id(raw: Optional[str]) -> str:
    """The caller's id when it is well formed, a minted one otherwise
    (``None`` included)."""
    if raw and _ID_RE.match(raw):
        return raw
    return mint_trace_id()


def sampled(trace_id: str, rate: float) -> bool:
    """The rate decision: the first 8 bytes of the id's SHA-256 as a
    fraction of 2^64, against ``rate``."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = int.from_bytes(
        hashlib.sha256(trace_id.encode("utf-8")).digest()[:8], "big")
    return h / float(1 << 64) < rate


class TraceContext:
    """One request's trace: its id and the buffered events the sampler
    flushes or drops at completion (``None`` when no sink was active at
    admission: the dark path buffers nothing)."""

    __slots__ = ("trace_id", "sample_rate", "_buffered", "_finished")

    def __init__(self, trace_id: str, sample_rate: float):
        self.trace_id = trace_id
        self.sample_rate = float(sample_rate)
        self._buffered: Optional[list[dict]] = [] if _events.active() else None
        self._finished = False


# Process-wide sampling counters for /metrics, reset with the run.
_counters = {"admitted": 0, "done": 0, "sampled": 0, "forced": 0,
             "rejected": 0}
_counters_lock = threading.Lock()

# Incident mode: every request is kept while it is set. Reset with the
# run, so a leaked flag never un-samples the next one.
_force_all = False


def set_force_all(on: bool) -> None:
    global _force_all
    _force_all = bool(on)


def force_all() -> bool:
    return _force_all


def counters() -> dict:
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    global _force_all
    _force_all = False
    with _counters_lock:
        for k in _counters:
            _counters[k] = 0


def admit(trace_id: Optional[str] = None,
          sample_rate: float = 1.0) -> TraceContext:
    """Mint (or adopt) a trace context at admission and buffer its
    ``request_admit`` event."""
    ctx = TraceContext(normalize_trace_id(trace_id), sample_rate)
    with _counters_lock:
        _counters["admitted"] += 1
    if ctx._buffered is not None:
        ctx._buffered.append({"kind": "request_admit", "t": time.time(),
                              "thread": threading.get_ident()})
    return ctx


def dispatch(ctx: Optional[TraceContext], batch_seq: int, bucket: int,
             pad: int) -> None:
    """Buffer ``request_dispatch``: the request left the queue on batch
    ``batch_seq``, padded into ``bucket``."""
    if ctx is None or ctx._buffered is None:
        return
    ctx._buffered.append({
        "kind": "request_dispatch", "t": time.time(),
        "batch_seq": int(batch_seq), "bucket": int(bucket), "pad": int(pad),
        "thread": threading.get_ident(),
    })


def _flush_buffered(ctx: TraceContext) -> None:
    """Emit the buffered events with the times they happened."""
    for rec in ctx._buffered or ():
        if rec["kind"] == "request_admit":
            _events.emit("request_admit", t=rec["t"], trace=ctx.trace_id,
                         thread=rec["thread"])
        elif rec["kind"] == "request_dispatch":
            _events.emit("request_dispatch", t=rec["t"],
                         trace=ctx.trace_id, batch_seq=rec["batch_seq"],
                         bucket=rec["bucket"], pad=rec["pad"],
                         thread=rec["thread"])
    ctx._buffered = []


def reject(ctx: Optional[TraceContext], queue_depth: int,
           limit: int) -> None:
    """An admission rejection: always kept, flushed at once."""
    if ctx is None or ctx._finished:
        return
    ctx._finished = True
    with _counters_lock:
        _counters["rejected"] += 1
        _counters["forced"] += 1
    if ctx._buffered is None:
        return
    _flush_buffered(ctx)
    _events.emit("request_reject", trace=ctx.trace_id,
                 queue_depth=int(queue_depth), limit=int(limit))


def done(ctx: Optional[TraceContext], queue_wait_ms: float,
         dispatch_ms: float, total_ms: float, outcome: str = "ok",
         slo_ms: Optional[float] = None) -> None:
    """Completion: keep the timeline when it is forced (incident mode, an
    error, or over ``slo_ms``) or sampled at the context's rate, else drop
    it."""
    if ctx is None or ctx._finished:
        return
    ctx._finished = True
    forced = _force_all or outcome != "ok" or (
        slo_ms is not None and total_ms > slo_ms)
    keep = forced or sampled(ctx.trace_id, ctx.sample_rate)
    with _counters_lock:
        _counters["done"] += 1
        if keep:
            _counters["sampled"] += 1
        if forced:
            _counters["forced"] += 1
    if not keep or ctx._buffered is None:
        ctx._buffered = None
        return
    _flush_buffered(ctx)
    _events.emit("request_done", trace=ctx.trace_id,
                 queue_wait_ms=round(float(queue_wait_ms), 3),
                 dispatch_ms=round(float(dispatch_ms), 3),
                 total_ms=round(float(total_ms), 3),
                 outcome=outcome, forced=forced)
