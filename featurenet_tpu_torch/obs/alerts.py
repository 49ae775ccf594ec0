"""Threshold SLO alert rules over the rolling windows (port of the
threshold half of ``featurenet_tpu/obs/alerts.py``).

A rule is a threshold over a window-derived metric, written
``metric(>|<)threshold[:severity]`` (``Config.alert_rules``, ``cli serve
--alert-rules``, comma-separated), and is evaluated each time the
aggregator (``obs/windows.py``) emits its ``window_summary`` events.
``metric`` is a derived metric (``DERIVED_METRICS``) or a window
percentile ``<window>_<stat>`` (``queue_wait_ms_p99``, ...); severity is
one of ``SEVERITIES`` (default ``warning``). A spec replaces the default
rules, and a metric that does not exist is refused at config time.

Alerts are hysteretic: a rule crossing into violation fires one ``alert``
event (``state="fire"``) and stays silent until the metric recovers,
which emits the paired ``state="resolve"``. Alerts only write telemetry.

``data_wait_spread`` (the spread of per-host data-wait fractions) carries
``scope="report"``: no one process sees it, so the in-process engine
skips it. The reference's burn-rate rules and the mirror of alert
transitions into a time-series store need its tsdb and wait for ROADMAP
Queue A.2(d).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

from featurenet_tpu_torch.obs import events as _events

SEVERITIES = ("info", "warning", "critical")

# The raw rolling windows the aggregator keeps (obs/windows.py keys its
# ring buffers off this tuple, so the rule parser and the aggregator name
# the same metrics).
WINDOW_METRICS = (
    "step_ms",          # per-step loop wall
    "data_wait_ms",     # host blocked on the input pipeline, per step
    "queue_depth",      # input queue depth at each consumer pop
    "heartbeat_age_s",  # inter-beat age at each confirmed progress point
    "serving_ms",       # per-request enqueue → response latency
    "queue_wait_ms",    # per-request enqueue → dispatch wait
    "connect_ms",       # a fleet pool's TCP connect wall per fresh channel
    "mfu",              # per-dispatch model-flops utilization
    "achieved_bw_fraction",  # per-dispatch bytes over wall over peak
    "confidence",       # per-request top-1 probability
    "confidence_margin",  # per-request top-1 − top-2 probability
    "prediction_entropy",  # per-request softmax entropy (nats)
    "quality_drift_score",  # predicted-class mix vs a pinned baseline
)

_WINDOW_STATS = ("p50", "p95", "p99", "max", "mean")

# Metrics computed across windows rather than read off one of them.
DERIVED_METRICS = (
    "data_wait_fraction",   # sum(data_wait_ms) / sum(step_ms)
    "step_p99_ratio",       # p99(step_ms) / p50(step_ms)
    "heartbeat_age_s",      # max of the heartbeat window
    "queue_depth",          # p50 of the depth window
    "serving_p99_ms",       # p99 of the serving window
    "data_wait_spread",     # cross-host; report scope only
    "mfu",                  # p50 of the mfu window (rules use `<`)
)

REPORT_SCOPE_METRICS = frozenset({"data_wait_spread"})


@dataclasses.dataclass(frozen=True)
class AlertRule:
    metric: str
    op: str  # ">" (higher is worse) or "<" (lower is worse)
    threshold: float
    severity: str = "warning"

    @property
    def scope(self) -> str:
        return ("report" if self.metric in REPORT_SCOPE_METRICS
                else "process")

    def violated(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" else \
            value < self.threshold


# The defaults: a starving device, a blown step-time tail, a heartbeat
# going quiet, and (report scope) a wide cross-host data-wait spread.
DEFAULT_RULES = (
    AlertRule("data_wait_fraction", ">", 0.5, "warning"),
    AlertRule("step_p99_ratio", ">", 4.0, "warning"),
    AlertRule("heartbeat_age_s", ">", 60.0, "critical"),
    AlertRule("data_wait_spread", ">", 0.25, "warning"),
)


def known_metrics() -> set[str]:
    out = set(DERIVED_METRICS)
    for m in WINDOW_METRICS:
        out.update(f"{m}_{s}" for s in _WINDOW_STATS)
    return out


def is_serving_metric(metric: str) -> bool:
    """Whether a rule metric reads the serving windows (request latency,
    queue wait): an unresolved serving alert fails a serving drain, a
    training-side alert never does."""
    return metric.startswith(("serving", "queue_wait"))


_RULE_RE = re.compile(
    r"^(?P<metric>[a-z0-9_]+)(?P<op>[<>])(?P<threshold>[0-9.eE+-]+)"
    r"(?::(?P<severity>[a-z]+))?$"
)


def parse_rules(spec: Optional[str]) -> list[AlertRule]:
    """Parse an ``--alert-rules`` spec; ``None`` or empty gives the
    defaults. Metric names, operators, thresholds and severities are
    checked, so a typo fails at config time."""
    if not spec:
        return list(DEFAULT_RULES)
    rules: list[AlertRule] = []
    seen: set[str] = set()
    valid = known_metrics()
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _RULE_RE.match(entry)
        if m is None:
            raise ValueError(
                f"malformed alert rule {entry!r}: expected "
                "metric(>|<)threshold[:severity]"
            )
        metric = m.group("metric")
        if metric not in valid:
            raise ValueError(
                f"unknown alert metric {metric!r} in {entry!r}; known: "
                f"{', '.join(sorted(valid))}"
            )
        if metric in seen:
            raise ValueError(f"duplicate alert metric {metric!r} in {spec!r}")
        seen.add(metric)
        try:
            threshold = float(m.group("threshold"))
        except ValueError:
            raise ValueError(
                f"alert threshold in {entry!r} must be a number"
            ) from None
        severity = m.group("severity") or "warning"
        if severity not in SEVERITIES:
            raise ValueError(
                f"unknown alert severity {severity!r} in {entry!r}; "
                f"one of {', '.join(SEVERITIES)}"
            )
        rules.append(AlertRule(metric, m.group("op"), threshold, severity))
    if not rules:
        raise ValueError(f"empty alert-rules spec {spec!r}")
    return rules


def fire(rule: AlertRule, value: float, window: int,
         state: str = "fire") -> None:
    """One ``alert`` event: ``state="fire"`` as the rule crosses into
    violation, ``"resolve"`` as it recovers. ``window`` is the
    aggregator's emission sequence number."""
    _events.emit("alert", rule=rule.metric, severity=rule.severity,
                 value=round(float(value), 6), threshold=rule.threshold,
                 window=window, state=state)
