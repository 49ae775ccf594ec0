"""SLO alert rules (port of ``featurenet_tpu/obs/alerts.py``): threshold
rules over the rolling windows, and burn-rate objectives over the
time-series store.

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
skips it.

With a store attached (``set_store``), every transition is also an
``alerts_active{rule}`` sample, 1 on fire and 0 on resolve, so ``cli
dash`` and the report draw alert timelines from the store alone.

A burn-rate objective (``metric(<|>)threshold@objective%[:severity]``,
``parse_slos``; ``op`` states the good direction) is judged by
``BurnEvaluator`` at a fast and a slow look-back window over a store's
scraped series: a window's burn rate is its fraction of bad samples over
the error budget (1 - objective), and the rule fires only while both
windows burn above ``max_burn``, with the threshold rules' fire/resolve
hysteresis and ``alert`` event (rule ``<metric>_burn``).
"""

from __future__ import annotations

import dataclasses
import re
import time
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


# The store that mirrors alert transitions (one per process, like the
# sink); its append absorbs every failure.
_store = None


def set_store(store) -> None:
    """Attach (or, with None, detach) the store that mirrors alert
    transitions."""
    global _store
    _store = store


def fire(rule: AlertRule, value: float, window: int,
         state: str = "fire") -> None:
    """One ``alert`` event: ``state="fire"`` as the rule crosses into
    violation, ``"resolve"`` as it recovers. ``window`` is the
    aggregator's emission sequence number. With a store attached, also an
    ``alerts_active{rule}`` sample (1 or 0)."""
    _events.emit("alert", rule=rule.metric, severity=rule.severity,
                 value=round(float(value), 6), threshold=rule.threshold,
                 window=window, state=state)
    store = _store
    if store is not None:
        store.append("alerts_active", 1.0 if state == "fire" else 0.0,
                     {"rule": rule.metric})


# --- multi-window burn-rate objectives ----------------------------------------

DEFAULT_FAST_WINDOW_S = 300.0    # 5 m
DEFAULT_SLOW_WINDOW_S = 3600.0   # 1 h

# Percentile stat → the exporter's quantile label on a scraped series
# (serve/metrics.py's _QUANTILES; mean and max are not exported).
_STAT_TO_Q = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}


def burn_selector(metric: str) -> Optional[tuple[str, dict]]:
    """A burn metric's (series, labels) in the store: ``serving_p99_ms`` →
    (``serving_ms``, ``{"q": "0.99"}``); None when no series carries it."""
    if metric == "serving_p99_ms":
        return "serving_ms", {"q": "0.99"}
    base, _, stat = metric.rpartition("_")
    if base in WINDOW_METRICS and stat in _STAT_TO_Q:
        return base, {"q": _STAT_TO_Q[stat]}
    return None


def known_burn_metrics() -> set[str]:
    out = {"serving_p99_ms"}
    for m in WINDOW_METRICS:
        out.update(f"{m}_{s}" for s in _STAT_TO_Q)
    return out


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """``value op threshold`` should hold for ``objective`` of the samples
    (``serving_p99_ms<250@99%``). ``op`` is the good direction, the
    opposite of ``AlertRule``'s."""
    metric: str
    op: str           # "<" (good below) or ">" (good above)
    threshold: float
    objective: float  # a fraction in (0, 1)
    severity: str = "critical"
    fast_s: float = DEFAULT_FAST_WINDOW_S
    slow_s: float = DEFAULT_SLOW_WINDOW_S
    max_burn: float = 1.0

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def bad(self, value: float) -> bool:
        ok = value < self.threshold if self.op == "<" else \
            value > self.threshold
        return not ok

    @property
    def name(self) -> str:
        """The alert's rule name: the metric with ``_burn``, apart from a
        threshold alert over the same metric."""
        return f"{self.metric}_burn"


# p99 under the default SLO for 99% of the samples, over 5 m and 1 h.
DEFAULT_BURN_RULES = (
    BurnRateRule("serving_p99_ms", "<", 250.0, 0.99, "critical"),
)

_SLO_RE = re.compile(
    r"^(?P<metric>[a-z0-9_]+)(?P<op>[<>])(?P<threshold>[0-9.eE+-]+)"
    r"@(?P<objective>[0-9.]+)%(?::(?P<severity>[a-z]+))?$"
)


def parse_slos(spec: Optional[str],
               fast_s: float = DEFAULT_FAST_WINDOW_S,
               slow_s: float = DEFAULT_SLOW_WINDOW_S) -> list[BurnRateRule]:
    """Parse a burn-rate spec (comma-separated
    ``metric(<|>)threshold@objective%[:severity]``); ``None`` or empty
    gives the default objective. A typo fails here, as in
    ``parse_rules``."""
    if not spec:
        return [dataclasses.replace(r, fast_s=fast_s, slow_s=slow_s)
                for r in DEFAULT_BURN_RULES]
    rules: list[BurnRateRule] = []
    seen: set[str] = set()
    valid = known_burn_metrics()
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        m = _SLO_RE.match(entry)
        if m is None:
            raise ValueError(
                f"malformed burn-rate SLO {entry!r}: expected "
                "metric(>|<)threshold@objective%[:severity]"
            )
        metric = m.group("metric")
        if metric not in valid:
            raise ValueError(
                f"unknown burn-rate metric {metric!r} in {entry!r}; "
                f"known: {', '.join(sorted(valid))}"
            )
        if metric in seen:
            raise ValueError(f"duplicate SLO metric {metric!r} in {spec!r}")
        seen.add(metric)
        try:
            threshold = float(m.group("threshold"))
            objective = float(m.group("objective")) / 100.0
        except ValueError:
            raise ValueError(
                f"SLO numbers in {entry!r} must be numeric"
            ) from None
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"SLO objective in {entry!r} must be in (0, 100)% "
                "exclusive — a 100% objective has no error budget to burn"
            )
        severity = m.group("severity") or "critical"
        if severity not in SEVERITIES:
            raise ValueError(
                f"unknown SLO severity {severity!r} in {entry!r}; "
                f"one of {', '.join(SEVERITIES)}"
            )
        rules.append(BurnRateRule(metric, m.group("op"), threshold,
                                  objective, severity,
                                  fast_s=fast_s, slow_s=slow_s))
    if not rules:
        raise ValueError(f"empty burn-rate SLO spec {spec!r}")
    return rules


def burn_rate(samples, rule: BurnRateRule, window_s: float,
              now: Optional[float] = None) -> Optional[float]:
    """One window's burn rate over (t, value) samples: the bad fraction
    over the error budget. None for an empty window, which neither fires
    nor resolves."""
    if now is None:
        now = time.time()
    cutoff = now - float(window_s)
    vals = [v for t, v in samples if t >= cutoff]
    if not vals:
        return None
    bad = sum(1 for v in vals if rule.bad(v))
    return (bad / len(vals)) / rule.budget


class BurnEvaluator:
    """Multi-window burn evaluation over a store, with the threshold
    engine's hysteresis and ``alert`` events: the rule is
    ``<metric>_burn``, the value the smaller window's burn rate, the
    threshold ``max_burn``. One store query per rule and pass."""

    def __init__(self, store, rules: Optional[list] = None):
        self.store = store
        self.rules = list(DEFAULT_BURN_RULES) if rules is None else \
            list(rules)
        self._active: dict[str, bool] = {}
        self._seq = 0

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One pass: per rule both windows' burn rates and the verdict,
        emitting an ``alert`` on each transition. Returns ``{metric:
        {fast, slow, firing, active}}``."""
        if now is None:
            now = time.time()
        self._seq += 1
        out = {}
        for rule in self.rules:
            sel = burn_selector(rule.metric)
            if sel is None:
                continue
            samples = self.store.query(
                sel[0], sel[1], since_s=rule.slow_s, now=now
            )
            fast = burn_rate(samples, rule, rule.fast_s, now)
            slow = burn_rate(samples, rule, rule.slow_s, now)
            firing = (fast is not None and slow is not None
                      and fast > rule.max_burn and slow > rule.max_burn)
            active = self._active.get(rule.metric, False)
            if firing != active:
                # Both must burn to fire: the smaller rate crossed last.
                value = min(v for v in (fast, slow) if v is not None) \
                    if (fast is not None or slow is not None) else 0.0
                fire(AlertRule(rule.name, ">", rule.max_burn,
                               rule.severity),
                     value, self._seq,
                     state="fire" if firing else "resolve")
                self._active[rule.metric] = firing
            out[rule.metric] = {
                "fast": fast, "slow": slow,
                "firing": firing, "active": firing,
            }
        return out

    def active_alerts(self) -> list[str]:
        return sorted(m for m, on in self._active.items() if on)
