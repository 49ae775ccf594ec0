"""Run-scoped observability (port of the core of ``featurenet_tpu/obs``).

Setting ``Config.run_dir`` (``cli serve --run-dir``, ``cli programs
--run-dir``) makes the process write into one run directory:

- ``run.json``: the manifest (config, device topology, start time;
  ``events.init_run``, process 0 only);
- ``events.jsonl``: the append-only, thread-safe event log
  (``events.EventSink``); process i > 0 writes ``events.<i>.jsonl``.

Live SLOs ride the same stream: the rolling windows (``windows.py``) keep
the last samples of the serving latency and queue wait, emit
``window_summary`` events, and evaluate the threshold alert rules
(``alerts.py``), which fire ``alert`` events; request tracing
(``tracing.py``) keeps per-request timelines, tail-biased. With no
run_dir every hook is one ``None`` check and no file I/O.

Not ported yet: spans, the report and its CLI (ROADMAP Queue A.2(b)); the
perf, quality, incident, tsdb and dashboard planes and the burn-rate
alerts (Queue A.2(c)).
"""

from featurenet_tpu_torch.obs.events import (
    EventSink,
    active,
    close_run,
    emit,
    events_filename,
    gauge,
    init_run,
    warn,
)
from featurenet_tpu_torch.obs.windows import flush as flush_windows
from featurenet_tpu_torch.obs.windows import observe

__all__ = [
    "EventSink",
    "active",
    "close_run",
    "emit",
    "events_filename",
    "flush_windows",
    "gauge",
    "init_run",
    "observe",
    "warn",
]
