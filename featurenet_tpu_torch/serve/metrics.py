"""Prometheus text exporter for the serving path (port of
``featurenet_tpu/serve/metrics.py``).

``GET /metrics`` folds the numbers the process already keeps (the
batcher's counters, the event sink's per-kind counts, the tracing
sampler's totals, and the rolling-window summaries) into the Prometheus
text exposition format (version 0.0.4), so a monitor scrapes the windows
the SLO alerts fire on. No histogram buckets: quantile gauges
(``featurenet_serving_ms{q="0.99"}``) carry the nearest-rank percentiles
of the ``window_summary`` events.

``METRIC_NAMES`` is the closed registry of every family the exporter can
emit; the window gauges derive from ``alerts.WINDOW_METRICS``.
``build_info`` carries the torch version where the reference carries
JAX's. ``incidents_open`` is the incident manager's count of open
incidents (``obs/incidents.py``; 0 when none is armed). The fleet
router's exporter waits for the fleet (ROADMAP Queue A.4).
"""

from __future__ import annotations

from featurenet_tpu_torch.obs import events as _events
from featurenet_tpu_torch.obs import tracing as _tracing
from featurenet_tpu_torch.obs import windows as _windows
from featurenet_tpu_torch.obs.alerts import WINDOW_METRICS

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_PREFIX = "featurenet_"

# Event kinds exported as counters, with their metric names: those the
# port emits (a graph built ahead is a program_compile). The reference's
# executable-cache and connection-pool counters come with those layers.
_EVENT_COUNTERS = {
    "program_compile": "program_compiles_total",
    "overload": "overloads_total",
    "serve_batch": "serve_batches_total",
}

_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))

# Every family this exporter can emit (base names, no labels), and the
# series the alert mirror appends to the store (``alerts_active``).
METRIC_NAMES = frozenset(
    {
        "ready",
        "uptime_seconds",
        "window_seq",
        "requests_total",          # by outcome: served/rejected/error
        "serve_queue_depth",
        "serve_occupancy",
        "trace_admitted_total",
        "trace_sampled_total",
        "trace_forced_total",
        "build_info",
        "alerts_active",
        "incidents_open",
    }
    | set(_EVENT_COUNTERS.values())
    | set(WINDOW_METRICS)
    | {f"{m}_count" for m in WINDOW_METRICS}
)

# One HELP string per family (the reference's wording).
_HELP = {
    "ready": "1 between warmup completing and drain beginning",
    "uptime_seconds": "process uptime",
    "window_seq": "rolling-window emission sequence number",
    "requests_total": "requests by outcome (served/rejected/error)",
    "serve_queue_depth": "continuous batcher queue depth",
    "serve_occupancy": "mean dispatched-batch occupancy",
    "trace_admitted_total": "requests admitted to tracing decisions",
    "trace_sampled_total": "requests sampled into traces",
    "trace_forced_total": "SLO-breach forced trace samples",
    "build_info": "constant 1; labels carry build identity",
    "program_compiles_total": "serving programs built ahead",
    "overloads_total": "admission-bound rejections",
    "serve_batches_total": "dispatched serving batches",
    "alerts_active": "1 while the labeled alert rule is firing",
    "incidents_open": "incidents currently open in this process",
}


def _help_for(name: str) -> str:
    h = _HELP.get(name)
    if h is not None:
        return h
    if name.endswith("_count"):
        return f"samples in the {name[:-len('_count')]} rolling window"
    return f"rolling-window quantile gauge over {name} samples"


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _build_info_labels(serve_precision: str, conv_backend: str,
                       model_version: str = "n/a") -> str:
    import torch

    return (
        f'{{torch_version="{_escape_label(torch.__version__)}",'
        f'serve_precision="{_escape_label(serve_precision)}",'
        f'conv_backend="{_escape_label(conv_backend)}",'
        f'model_version="{_escape_label(model_version)}"}}'
    )


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    # The exposition format spells non-finite samples NaN/+Inf/-Inf.
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return format(f, "g")


def _row(lines: list[str], name: str, value, labels: str = "",
         kind: str | None = None) -> None:
    """One exposition row, with its ``# HELP``/``# TYPE`` pair when
    ``kind`` is given (the family's first row)."""
    full = _PREFIX + name
    if kind is not None:
        lines.append(f"# HELP {full} {_help_for(name)}")
        lines.append(f"# TYPE {full} {kind}")
    lines.append(f"{full}{labels} {_fmt(value)}")


def render_metrics(service) -> str:
    """The /metrics body of one ``InferenceService``: counters, then the
    rolling-window quantile gauges. A window without samples emits
    nothing, and a dark sink no event counters."""
    lines: list[str] = []

    def row(name: str, value, labels: str = "",
            kind: str | None = None) -> None:
        _row(lines, name, value, labels, kind)

    cfg = getattr(service, "cfg", None)
    row("build_info", 1, _build_info_labels(
        getattr(cfg, "serve_precision", "unknown"),
        getattr(getattr(cfg, "arch", None), "conv_backend", "unknown"),
        model_version=getattr(getattr(service, "predictor", None),
                              "model_version", "unversioned"),
    ), kind="gauge")

    health = service.health()
    row("ready", health["ready"], kind="gauge")
    row("uptime_seconds", health["uptime_s"], kind="gauge")
    if health.get("window_seq") is not None:
        row("window_seq", health["window_seq"], kind="gauge")

    st = service.stats()
    row("requests_total", st["served"], '{outcome="served"}', kind="counter")
    row("requests_total", st["rejected"], '{outcome="rejected"}')
    row("requests_total", st["errors"], '{outcome="error"}')
    row("serve_queue_depth", st["queue_depth"], kind="gauge")
    if st.get("occupancy") is not None:
        row("serve_occupancy", st["occupancy"], kind="gauge")

    kinds = _events.kind_counts()
    for ev, name in sorted(_EVENT_COUNTERS.items()):
        if ev in kinds:
            row(name, kinds[ev], kind="counter")

    tc = _tracing.counters()
    row("trace_admitted_total", tc["admitted"], kind="counter")
    row("trace_sampled_total", tc["sampled"], kind="counter")
    row("trace_forced_total", tc["forced"], kind="counter")

    row("incidents_open", _incidents_open(), kind="gauge")

    _window_lines(lines)
    return "\n".join(lines) + "\n"


def _incidents_open() -> int:
    """The open incidents (0 with no manager armed). Imported here: the
    incident plane pulls in the store and the windows."""
    from featurenet_tpu_torch.obs import incidents as _incidents

    return _incidents.open_count()


def _window_lines(lines: list[str]) -> None:
    """The rolling-window quantile gauges and their sample counts."""
    for metric, summary in sorted(_windows.snapshot().items()):
        full = _PREFIX + metric
        lines.append(f"# HELP {full} {_help_for(metric)}")
        lines.append(f"# TYPE {full} gauge")
        for q, stat in _QUANTILES:
            lines.append(f'{full}{{q="{q}"}} {_fmt(summary[stat])}')
        count = f"{metric}_count"
        lines.append(f"# HELP {_PREFIX}{count} {_help_for(count)}")
        lines.append(f"# TYPE {_PREFIX}{count} gauge")
        lines.append(f"{_PREFIX}{count} {summary['n']}")
