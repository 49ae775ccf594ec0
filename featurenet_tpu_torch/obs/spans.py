"""Context-manager timing spans and the Chrome trace export (port of
``featurenet_tpu/obs/spans.py``; stdlib only).

A span times a named region and emits one ``span`` event on exit::

    with obs.span("data_wait", take=4):
        batches = tuple(next(stream) for _ in range(4))

Emitted fields: ``name``, ``dur_s``, ``t`` (wall-clock *start*, so trace
viewers place the interval correctly), ``thread`` (ident), ``parent`` (the
enclosing span's name, tracked per-thread), plus any caller fields. The
duration clock is ``perf_counter`` — monotonic, immune to NTP steps that
would corrupt a wall-clock subtraction mid-run.

Nesting is tracked in a thread-local stack, so producer threads, the train
loop, and an eval pass each get independent, correctly-parented spans with
no cross-thread locking beyond the sink's own line lock.

When no run is active (``events._sink is None``) ``span()`` returns a
shared no-op singleton: one ``None`` check, no clock reads, no allocation
beyond the call itself — the hot dispatch loop pays nothing.
"""

from __future__ import annotations

import threading
import time

from featurenet_tpu_torch.obs import events as _events
from featurenet_tpu_torch.obs import windows as _windows

_tls = threading.local()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "fields", "_t0", "_wall0")

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self.name)
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        stack = _tls.stack
        stack.pop()
        _events.emit(
            "span",
            t=self._wall0,
            name=self.name,
            dur_s=dur,
            thread=threading.get_ident(),
            parent=stack[-1] if stack else None,
            **self.fields,
        )
        # Live-SLO feed: the spans that are window metrics (data_wait,
        # infer_batch) land in the rolling aggregator too — the duration
        # is already in hand, so the live view costs no extra clock read.
        _windows.observe_span(self.name, dur, self.fields)
        return False


def span(name: str, **fields):
    """A timing span, or the shared no-op when no run is active."""
    if _events._sink is None:
        return _NULL
    return _Span(name, fields)


# --- Chrome trace export -----------------------------------------------------

_SPAN_META = ("t", "ev", "name", "dur_s", "thread", "parent", "pid",
              "process_index")


def chrome_trace(events: list[dict]) -> dict:
    """Fold ``span`` events into Chrome tracing's JSON object format
    (load via chrome://tracing or https://ui.perfetto.dev). Complete
    ("ph":"X") events, microsecond timestamps rebased to the earliest
    event so the viewer opens at t=0; tid is the thread ident.

    Tracks: every distinct ``(process_index, os pid)`` writer gets its own
    synthetic trace pid — OS pids from different hosts can collide, so the
    raw pid cannot be the track key in a merged multi-host log — with a
    ``process_name`` metadata record naming the host and real pid, and
    ``process_sort_index`` ordering tracks by host.

    ``window_summary`` events export as counter ("ph":"C") tracks — one
    per metric — so the rolling p50/p95/p99 render as stepped series
    above the span lanes they summarize (the ``mfu`` window rides this
    path). ``device_memory`` events (the heartbeat-cadence memory poller,
    ``obs/perf.py``) export as one counter track per device.

    Sampled request traces (obs.tracing) export as ASYNC events — one
    ``b``/``e`` pair per trace id spanning admit→done (or →reject), with
    an instant at the dispatch point — plus a flow arrow ("ph":"s"/"f")
    from the admit to the dispatch, so a batch's N fanned-in requests
    are visually tied to the ``serve_dispatch`` span carrying the same
    ``batch_seq``."""
    spans = [e for e in events if e.get("ev") == "span" and "dur_s" in e]
    windows = [e for e in events
               if e.get("ev") == "window_summary" and "metric" in e]
    mem = [e for e in events
           if e.get("ev") == "device_memory" and "bytes_in_use" in e]
    reqs = [e for e in events
            if e.get("ev") in ("request_admit", "request_dispatch",
                               "request_done", "request_reject")
            and "trace" in e]
    if not spans and not windows and not mem and not reqs:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = min(e["t"] for e in spans + windows + mem + reqs)
    track_ids: dict[tuple, int] = {}

    def track(e: dict) -> int:
        key = (e.get("process_index", 0) or 0, e.get("pid", 0))
        if key not in track_ids:
            track_ids[key] = len(track_ids)
        return track_ids[key]

    out = []
    for e in spans:
        out.append({
            "name": e.get("name", "?"),
            "ph": "X",
            "ts": (e["t"] - t0) * 1e6,
            "dur": e["dur_s"] * 1e6,
            "pid": track(e),
            "tid": e.get("thread", 0),
            "args": {k: v for k, v in e.items() if k not in _SPAN_META},
        })
    for e in windows:
        out.append({
            "name": f"window {e['metric']}",
            "ph": "C",
            "ts": (e["t"] - t0) * 1e6,
            "pid": track(e),
            "args": {
                k: e[k] for k in ("p50", "p95", "p99")
                if isinstance(e.get(k), (int, float))
            },
        })
    for e in mem:
        out.append({
            "name": f"device {e.get('device', 0)} memory",
            "ph": "C",
            "ts": (e["t"] - t0) * 1e6,
            "pid": track(e),
            "args": {
                k: e[k] for k in ("bytes_in_use", "peak_bytes_in_use")
                if isinstance(e.get(k), (int, float))
            },
        })
    # Async request lanes + flow arrows (one lane per sampled trace id;
    # the b/e pair spans the request's whole server-side life, the flow
    # links its admit point into the dispatch that served it).
    _ASYNC_PH = {"request_admit": "b", "request_done": "e",
                 "request_reject": "e"}
    by_trace: dict[str, list[dict]] = {}
    for e in reqs:
        by_trace.setdefault(str(e["trace"]), []).append(e)
    for trace, evs in sorted(by_trace.items()):
        evs.sort(key=lambda e: e["t"])
        for e in evs:
            ph = _ASYNC_PH.get(e["ev"], "n")
            out.append({
                "name": "request",
                "cat": "request",
                "ph": ph,
                "id": trace,
                "ts": (e["t"] - t0) * 1e6,
                "pid": track(e),
                "tid": e.get("thread", 0),
                "args": {
                    k: e[k] for k in ("batch_seq", "bucket", "pad",
                                      "queue_wait_ms", "dispatch_ms",
                                      "total_ms", "outcome")
                    if e.get(k) is not None
                },
            })
        admit = next((e for e in evs if e["ev"] == "request_admit"), None)
        disp = next((e for e in evs if e["ev"] == "request_dispatch"),
                    None)
        if admit is not None and disp is not None:
            for e, ph in ((admit, "s"), (disp, "f")):
                out.append({
                    "name": "request-flow",
                    "cat": "request",
                    "ph": ph,
                    "id": trace,
                    "ts": (e["t"] - t0) * 1e6,
                    "pid": track(e),
                    "tid": e.get("thread", 0),
                    **({"bp": "e"} if ph == "f" else {}),
                })
    meta = []
    for (host, ospid), tpid in sorted(track_ids.items(), key=lambda kv: kv[1]):
        meta.append({
            "name": "process_name", "ph": "M", "pid": tpid,
            "args": {"name": f"host {host} (pid {ospid})"},
        })
        meta.append({
            "name": "process_sort_index", "ph": "M", "pid": tpid,
            "args": {"sort_index": host},
        })
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}
