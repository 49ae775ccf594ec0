"""Run-scoped observability (port of the core of ``featurenet_tpu/obs``).

Setting ``Config.run_dir`` (``cli train|serve|infer|programs|export-data|
build-cache --run-dir``) makes the process write into one run directory:

- ``run.json``: the manifest (config, device topology, start time;
  ``events.init_run``, process 0 only);
- ``events.jsonl``: the append-only, thread-safe event log
  (``events.EventSink``); process i > 0 writes ``events.<i>.jsonl``.

Live SLOs ride the same stream: the rolling windows (``windows.py``) keep
the last samples of the serving latency and queue wait, emit
``window_summary`` events, and evaluate the threshold alert rules
(``alerts.py``), which fire ``alert`` events; request tracing
(``tracing.py``) keeps per-request timelines, tail-biased. Timing spans (``spans.span``) nest per thread and emit one
``span`` event each on exit; ``data_wait`` and ``infer_batch`` feed their
windows too. With no run_dir every hook is one ``None`` check and no file
I/O.

Post hoc, ``python -m featurenet_tpu_torch.cli report <run_dir>`` folds
the streams into a step-time breakdown (data wait, dispatch, readback,
eval, checkpoint), the input pipeline's health, the heartbeat and the
supervisor's restart timeline, serving latency and the SLO view
(``report.py``); ``--trace`` exports the spans as a Chrome trace
(``spans.chrome_trace``), ``--validate`` lints the schema and ``--gate``
judges the report against a pinned baseline (``gates.py``). The report
path imports the standard library only, never torch.

The perf plane (``perf.py``: per-program cost, the ``mfu`` window, the
device-memory watermark) and the model-quality plane (``quality.py``, with
the flight recorder ``serve/recorder.py``) ride the same stream.

The incident plane (``incidents.py``) watches the stream through the event
tap: an alert firing freezes a bundle under ``<run_dir>/incidents/`` (the
windows, the events tail, the host's folded thread stacks from
``stacksampler.py``, the store's slice) and keeps every request's trace
until it resolves. The time-series store (``tsdb.py``, ``<run_dir>/tsdb``)
outlives every process; the alert mirror and the burn-rate objectives
(``alerts.py``), ``cli dash`` (``dash.py``) and the report's fleet timeline
read it. ``cli incident`` reads the bundles.
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
from featurenet_tpu_torch.obs.spans import chrome_trace, span
from featurenet_tpu_torch.obs.windows import flush as flush_windows
from featurenet_tpu_torch.obs.windows import observe

__all__ = [
    "EventSink",
    "active",
    "chrome_trace",
    "close_run",
    "emit",
    "events_filename",
    "flush_windows",
    "gauge",
    "init_run",
    "observe",
    "span",
    "warn",
]
