"""Rolling-window aggregation (port of ``featurenet_tpu/obs/windows.py``).

In-process ring buffers, bounded by count and by age, of the health
signals ``alerts.WINDOW_METRICS`` names (serving latency and queue wait
here; step time, data wait and the rest as their layers come to the
port). Each emission cycle writes one ``window_summary`` event per metric
observed since the last (n, p50, p95, p99, mean, max, and the cycle's
``seq``), then evaluates the alert rules (``obs/alerts.py``). Every
sample is a host float the caller already holds, so watching costs no
device synchronisation.

The aggregator is process-wide and optional: ``observe`` with none
installed is one attribute load and a ``None`` check. ``events.init_run``
installs a default-rule aggregator beside the sink, the Trainer and ``cli
infer`` install one with the run's rules, and the inference service one
with its serving rules. ``observe_span`` is the span-exit hook
(``obs/spans.py``): the spans that are window metrics feed their windows.
The reference's raw-sample read for a fleet router (``samples``, ROADMAP
Queue A.4) comes with its caller.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from featurenet_tpu_torch.obs import alerts as _alerts
from featurenet_tpu_torch.obs import events as _events


def _pct(sorted_vals: list, q: float):
    """Nearest-rank percentile of an already sorted list (the reference
    report's formula, so the live windows and a post-hoc report agree)."""
    if not sorted_vals:
        return None
    i = int(round(q / 100.0 * (len(sorted_vals) - 1)))
    return sorted_vals[min(max(i, 0), len(sorted_vals) - 1)]


# Spans that are window metrics: span name -> (metric, scale, the field a
# span's duration is divided by). A k-step dispatch's data_wait covers
# ``take`` steps, and the sample is per step.
SPAN_METRICS = {
    "data_wait": ("data_wait_ms", 1e3, "take"),
    "infer_batch": ("serving_ms", 1e3, None),
}

DEFAULT_WINDOW = 128       # samples per ring buffer
DEFAULT_MAX_AGE_S = 300.0  # and none older than this
DEFAULT_EMIT_EVERY_S = 5.0


class RollingWindow:
    """Ring buffer of (timestamp, value) bounded by count and age."""

    __slots__ = ("maxlen", "max_age_s", "_samples")

    def __init__(self, maxlen: int = DEFAULT_WINDOW,
                 max_age_s: Optional[float] = DEFAULT_MAX_AGE_S):
        self.maxlen = maxlen
        self.max_age_s = max_age_s
        self._samples: deque = deque(maxlen=maxlen)

    def add(self, value: float, now: float) -> None:
        self._samples.append((now, float(value)))

    def values(self, now: float) -> list[float]:
        if self.max_age_s is not None:
            cutoff = now - self.max_age_s
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
        return [v for _, v in self._samples]

    def summary(self, now: float) -> Optional[dict]:
        vals = sorted(self.values(now))
        if not vals:
            return None
        return {
            "n": len(vals),
            "p50": round(_pct(vals, 50), 4),
            "p95": round(_pct(vals, 95), 4),
            "p99": round(_pct(vals, 99), 4),
            "mean": round(sum(vals) / len(vals), 4),
            "max": round(vals[-1], 4),
        }

    def total(self, now: float) -> float:
        return sum(self.values(now))


class WindowAggregator:
    """A rolling window per ``alerts.WINDOW_METRICS`` metric, with periodic
    ``window_summary`` emission and alert-rule evaluation.

    A cycle runs at most every ``emit_every_s`` seconds (on an
    ``observe``), emits one summary per metric observed since the last,
    all under one increasing ``seq``, then evaluates the process-scope
    rules. ``flush()`` forces a cycle, so a short run lands its summaries.
    """

    def __init__(self, rules: Optional[list] = None,
                 window: int = DEFAULT_WINDOW,
                 max_age_s: Optional[float] = DEFAULT_MAX_AGE_S,
                 emit_every_s: float = DEFAULT_EMIT_EVERY_S):
        self.rules = list(_alerts.DEFAULT_RULES) if rules is None else \
            list(rules)
        self.emit_every_s = emit_every_s
        self._win = {m: RollingWindow(window, max_age_s)
                     for m in _alerts.WINDOW_METRICS}
        self._dirty: set[str] = set()
        self._lock = threading.Lock()
        self._seq = 0
        self._last_emit = time.perf_counter()
        # Per rule metric: True between a fire and its resolve.
        self._alert_active: dict[str, bool] = {}

    def observe(self, metric: str, value: float) -> None:
        win = self._win.get(metric)
        if win is None:
            return  # an unknown metric is ignored, never raised
        now = time.perf_counter()
        with self._lock:
            win.add(value, now)
            self._dirty.add(metric)
            if now - self._last_emit >= self.emit_every_s:
                self._emit_locked(now)

    def flush(self) -> None:
        with self._lock:
            self._emit_locked(time.perf_counter())

    # -- internals (self._lock held) -----------------------------------------
    def _emit_locked(self, now: float) -> None:
        if not self._dirty:
            return
        self._last_emit = now
        self._seq += 1
        for metric in sorted(self._dirty):
            s = self._win[metric].summary(now)
            if s is None:
                continue
            _events.emit("window_summary", metric=metric, n=s["n"],
                         p50=s["p50"], p95=s["p95"], p99=s["p99"],
                         mean=s["mean"], max=s["max"], seq=self._seq)
        self._dirty.clear()
        for rule in self.rules:
            if rule.scope != "process":
                continue
            value = self.rule_value(rule.metric, now)
            if value is None:
                continue
            active = self._alert_active.get(rule.metric, False)
            if rule.violated(value) and not active:
                _alerts.fire(rule, value, self._seq, state="fire")
                self._alert_active[rule.metric] = True
            elif not rule.violated(value) and active:
                _alerts.fire(rule, value, self._seq, state="resolve")
                self._alert_active[rule.metric] = False

    def active_alerts(self) -> list[str]:
        """The rule metrics fired and not resolved (the serving drain reads
        this after its last ``flush()``)."""
        with self._lock:
            return sorted(m for m, on in self._alert_active.items() if on)

    def snapshot(self) -> dict:
        """The current summary of each window with samples: what the
        ``/metrics`` exporter reads, so scrapes and alerts judge the same
        windows."""
        now = time.perf_counter()
        with self._lock:
            out = {}
            for metric, win in self._win.items():
                s = win.summary(now)
                if s is not None:
                    out[metric] = s
            return out

    def samples(self, metric: str) -> list[tuple[float, float]]:
        """The raw ``(perf_counter, value)`` samples of one window, pruned by
        age: the fleet router's burn-rate fallback without a store."""
        with self._lock:
            win = self._win.get(metric)
            if win is None:
                return []
            win.values(time.perf_counter())  # prune by age in place
            return list(win._samples)

    @property
    def seq(self) -> int:
        """The latest emission sequence number (0: none yet)."""
        with self._lock:
            return self._seq

    def rule_value(self, metric: str, now: float) -> Optional[float]:
        """A rule metric on the current windows: a derived metric or a
        ``<window>_<stat>`` lookup; ``None`` while its windows are empty."""
        if metric == "data_wait_fraction":
            steps = self._win["step_ms"].total(now)
            if steps <= 0:
                return None
            return self._win["data_wait_ms"].total(now) / steps
        if metric == "step_p99_ratio":
            vals = sorted(self._win["step_ms"].values(now))
            p50 = _pct(vals, 50)
            if not p50:
                return None
            return _pct(vals, 99) / p50
        if metric == "heartbeat_age_s":
            vals = self._win["heartbeat_age_s"].values(now)
            return max(vals) if vals else None
        if metric == "queue_depth":
            return _pct(sorted(self._win["queue_depth"].values(now)), 50)
        if metric == "serving_p99_ms":
            return _pct(sorted(self._win["serving_ms"].values(now)), 99)
        if metric == "mfu":
            return _pct(sorted(self._win["mfu"].values(now)), 50)
        base, _, stat = metric.rpartition("_")
        win = self._win.get(base)
        if win is not None and stat in _alerts._WINDOW_STATS:
            s = win.summary(now)
            return None if s is None else s[stat]
        return None


# --- the module-level (process-wide) aggregator ------------------------------

_agg: Optional[WindowAggregator] = None


def install(agg: Optional[WindowAggregator]) -> None:
    global _agg
    _agg = agg


def uninstall() -> None:
    global _agg
    _agg = None


def active() -> bool:
    return _agg is not None


def ensure_default() -> None:
    """Install a default-rule aggregator if there is none (``init_run``'s
    hook)."""
    global _agg
    if _agg is None:
        _agg = WindowAggregator()


def observe(metric: str, value: float) -> None:
    """Feed one sample; one ``None`` check with no aggregator."""
    agg = _agg
    if agg is None:
        return
    agg.observe(metric, value)


def observe_span(name: str, dur_s: float,
                 fields: Optional[dict] = None) -> None:
    """The span-exit hook: a ``SPAN_METRICS`` span's duration, per step,
    into its window; one ``None`` check with no aggregator."""
    agg = _agg
    if agg is None:
        return
    m = SPAN_METRICS.get(name)
    if m is None:
        return
    value = dur_s * m[1]
    if m[2] is not None and fields:
        div = fields.get(m[2])
        if isinstance(div, (int, float)) and div > 1:
            value /= div
    agg.observe(m[0], value)


def flush() -> None:
    agg = _agg
    if agg is not None:
        agg.flush()


def active_alerts() -> list[str]:
    """The installed aggregator's unresolved alert metrics (none without
    one)."""
    agg = _agg
    if agg is None:
        return []
    return agg.active_alerts()


def snapshot() -> dict:
    """The installed aggregator's window summaries (empty without one)."""
    agg = _agg
    if agg is None:
        return {}
    return agg.snapshot()


def samples(metric: str) -> list[tuple[float, float]]:
    """One window's raw ``(perf_counter, value)`` samples from the installed
    aggregator (empty when none)."""
    agg = _agg
    if agg is None:
        return []
    return agg.samples(metric)


def last_seq() -> Optional[int]:
    """The installed aggregator's latest emission seq (``None`` without
    one, 0 before its first emission): ``/healthz`` carries it."""
    agg = _agg
    if agg is None:
        return None
    return agg.seq
