"""Process-wide JSONL event sink and run manifest (port of
``featurenet_tpu/obs/events.py``).

Wire format: one JSON object per line in ``<run_dir>/events.jsonl``, each
carrying ``t`` (epoch seconds), ``ev`` (the event type) and ``pid``.
Process 0 writes ``events.jsonl`` and owns ``run.json``; process i > 0
writes ``events.<i>.jsonl`` (``events_filename``), so no two hosts share a
file.

Concurrency: one lock per sink serializes threads, and the file is opened
``O_APPEND`` with each event one ``os.write`` of one complete line, so
processes appending to one stream interleave whole lines, never
fragments. The manifest is written once per run directory; a respawned
process finds it and only appends a ``run_start`` event.

The module-level sink is what ``emit``/``gauge``/``warn`` consult; with
none installed each returns after one ``None`` check, so a run without a
``run_dir`` does no file I/O. Once ``init_run`` installs a sink,
everything the process does logs into that run until ``close_run()`` or
an ``init_run`` naming another directory.

A write that fails at the OS level (ENOSPC, a quota) turns the sink dark
with one stderr line; the run goes on without telemetry. The
``sink_enospc`` fault site (``faults.py``, counter ``emit``: the sink's
Nth emit) injects that failure.

The event tap (``set_tap``) is one process-wide subscriber that sees every
event any sink of the process emits, even a dark one's: the incident
manager (``obs/incidents.py``) watches alert transitions, gate regressions
and replica losses through it.
"""

from __future__ import annotations

import errno
import json
import os
import sys
import threading
import time
from typing import Any, Optional

from featurenet_tpu_torch import faults

MANIFEST_FILENAME = "run.json"
EVENTS_FILENAME = "events.jsonl"


def events_filename(process_index: Optional[int] = 0) -> str:
    """Per-process event stream name: ``events.jsonl`` for process 0,
    ``events.<i>.jsonl`` for process i > 0."""
    if not process_index:
        return EVENTS_FILENAME
    return f"events.{int(process_index)}.jsonl"


def _device_topology() -> dict:
    """The device and process topology for the manifest, from
    ``torch.cuda`` and ``torch.distributed``. Guarded: a process without
    torch's CUDA runtime still writes a valid manifest."""
    try:
        import torch

        dist = torch.distributed
        ready = dist.is_available() and dist.is_initialized()
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {
            "version": torch.__version__,
            "cuda": torch.version.cuda,
            "process_index": dist.get_rank() if ready else 0,
            "process_count": dist.get_world_size() if ready else 1,
            "device_count": count,
            "devices": [{"id": i, "platform": "gpu",
                         "device_kind": torch.cuda.get_device_name(i)}
                        for i in range(count)],
        }
    except Exception as e:  # no torch runtime: the manifest stays valid
        return {"error": str(e)}


def run_manifest(run_dir: str, config: Optional[dict] = None,
                 extra: Optional[dict] = None) -> dict:
    import datetime
    import socket

    m: dict[str, Any] = {
        "run_dir": os.path.abspath(run_dir),
        "start_unix": time.time(),
        "start_time": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "pid": os.getpid(),
        "hostname": socket.gethostname(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "config": config,
        "torch": _device_topology(),
    }
    if extra:
        m.update(extra)
    return m


class EventSink:
    """Append-only JSONL writer for one run directory."""

    def __init__(self, run_dir: str, filename: str = EVENTS_FILENAME):
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.path = os.path.join(self.run_dir, filename)
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._emits = 0
        # Per-kind emit counts, read by the /metrics exporter.
        self._kind_counts: dict[str, int] = {}
        # A raw O_APPEND fd: each emit is one os.write of one whole line,
        # which a buffered file object would split at its buffer boundary.
        self._fd: Optional[int] = os.open(
            self.path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)

    def emit(self, ev: str, **fields) -> None:
        """Write one event line. A ``t`` in ``fields`` overrides the
        stamp (a buffered trace event keeps the time it happened)."""
        record = {"t": fields.pop("t", None) or time.time(), "ev": ev,
                  "pid": self._pid}
        record.update(fields)
        data = (json.dumps(record, default=str) + "\n").encode("utf-8")
        # The tap is consulted before the write lock (it may emit events
        # of its own) and sees the event even when the sink is dark. What
        # it raises never reaches the emit site.
        tap = _tap
        if tap is not None:
            try:
                tap(ev, record)
            except Exception:
                pass
        with self._lock:
            if self._fd is None:
                return
            self._emits += 1
            self._kind_counts[ev] = self._kind_counts.get(ev, 0) + 1
            try:
                if faults.maybe_fail("sink_enospc", emit=self._emits):
                    raise OSError(errno.ENOSPC, "injected ENOSPC",
                                  self.path)
                # A short write loses this line's atomicity already;
                # finishing its tail beats gluing it onto the next record.
                view = memoryview(data)
                while view:
                    view = view[os.write(self._fd, view):]
            except OSError as e:
                fd, self._fd = self._fd, None
                try:
                    os.close(fd)
                except OSError:
                    pass
                print(json.dumps({
                    "sink_error": f"event sink write failed "
                    f"({type(e).__name__}: {e}); telemetry for this "
                    "process goes dark, the run continues",
                    "path": self.path,
                }), file=sys.stderr)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None


# --- the module-level (process-wide) sink ------------------------------------

_sink: Optional[EventSink] = None
_install_lock = threading.Lock()

# The process-wide event tap: one slot, one subscriber.
_tap = None


def set_tap(fn) -> None:
    """Install (or, with None, remove) the event tap, called as ``fn(ev,
    record)`` from the emitting thread after the record is built and
    before it is written. It must be cheap."""
    global _tap
    _tap = fn


def init_run(run_dir: str, config: Optional[dict] = None,
             extra: Optional[dict] = None,
             process_index: Optional[int] = None) -> EventSink:
    """Install the process-wide sink for ``run_dir`` and write ``run.json``
    if it is absent (process 0 only). Re-initializing the same directory
    keeps appending; another directory first flushes the old run's window
    cycle into the old stream, drops the aggregator and the tracing
    counters, and closes the old sink. Every call appends a
    ``run_start`` event. ``process_index`` None reads the topology."""
    global _sink
    if process_index is None:
        process_index = _device_topology().get("process_index", 0) or 0
    # windows and tracing import this module at their top.
    from featurenet_tpu_torch.obs import tracing as _tracing
    from featurenet_tpu_torch.obs import windows as _windows

    with _install_lock:
        target = os.path.abspath(run_dir)
        filename = events_filename(process_index)
        path = os.path.join(target, filename)
        if _sink is None or _sink.path != path:
            if _sink is not None:
                _windows.flush()
                _windows.uninstall()
                _tracing.reset_counters()
                _sink.close()
            _sink = EventSink(target, filename=filename)
        _windows.ensure_default()
        if process_index == 0:
            manifest_path = os.path.join(target, MANIFEST_FILENAME)
            if not os.path.exists(manifest_path):
                tmp = manifest_path + ".tmp"  # never half a manifest
                with open(tmp, "w", encoding="utf-8") as fh:
                    json.dump(run_manifest(run_dir, config, extra), fh,
                              indent=1, default=str)
                os.replace(tmp, manifest_path)
        _sink.emit("run_start", process_index=process_index)
        return _sink


def active() -> bool:
    return _sink is not None


def kind_counts() -> dict[str, int]:
    """Per-kind emit counts of the active sink (empty when dark)."""
    s = _sink
    if s is None:
        return {}
    with s._lock:
        return dict(s._kind_counts)


def emit(ev: str, **fields) -> None:
    """Emit to the process-wide sink; one ``None`` check when there is
    none."""
    s = _sink
    if s is None:
        return
    s.emit(ev, **fields)


def gauge(name: str, value, **fields) -> None:
    """A point-in-time measurement (a queue depth, a duration)."""
    s = _sink
    if s is None:
        return
    s.emit("gauge", name=name, value=value, **fields)


def warn(name: str, msg: str, **fields) -> None:
    """One JSON warning line on stderr and, with a run active, a
    ``warning`` event."""
    print(json.dumps({name: msg, **fields}), file=sys.stderr)
    s = _sink
    if s is not None:
        s.emit("warning", name=name, msg=msg, **fields)


def close_run() -> None:
    """Flush the window cycle while the sink can still write it, then drop
    the aggregator, the tracing counters and the sink: no obs state
    crosses from one run to the next in a process."""
    global _sink
    from featurenet_tpu_torch.obs import tracing as _tracing
    from featurenet_tpu_torch.obs import windows as _windows

    if _sink is not None:
        _windows.flush()
    _windows.uninstall()
    _tracing.reset_counters()
    with _install_lock:
        if _sink is not None:
            _sink.close()
            _sink = None
