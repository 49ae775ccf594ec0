"""Model-quality telemetry: confidence statistics and prediction-mix
drift over the serving path (port of ``featurenet_tpu/obs/quality.py``;
standard library only).

Per answered request, the top-1 confidence, the top1−top2 margin and the
softmax entropy feed the rolling windows (``confidence``,
``confidence_margin``, ``prediction_entropy`` in ``alerts.
WINDOW_METRICS``), and a rolling predicted-class histogram is scored
against a pinned baseline distribution by total variation
(``quality_drift_score``): 0 for the same mix, 1 for disjoint support.
They ride the ordinary windows, so they reach ``GET /metrics`` and ``cli
report``, and rules such as ``confidence_p50<0.5`` or
``quality_drift_score_p50>0.25`` fire and resolve through the alert
engine.

The baseline is a JSON file (``quality_baseline.json``) that ``cli
pin-quality`` writes from a pass over the synthetic parts: the class mix
the model is expected to emit on healthy traffic.

The tracker is fed floats, never tensors: the service reduces each
probability row to (label, confidence, margin, entropy) in the batcher's
result hook, so this module imports no torch.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
from typing import Optional, Sequence

from featurenet_tpu_torch.obs import events as _events
from featurenet_tpu_torch.obs import windows as _windows
from featurenet_tpu_torch.obs.alerts import AlertRule

BASELINE_FILENAME = "quality_baseline.json"

# Rolling histogram span: wide enough that one weird batch doesn't spike
# the score, short enough that a real mix shift (or its recovery) clears
# the window within a few emission cycles.
DEFAULT_WINDOW = 512

# Emit one `quality_drift` event per this many observed predictions —
# the report's quality section folds these; per-request events would
# dwarf the stream they ride in.
DEFAULT_EMIT_EVERY = 64

# Default alert thresholds (`quality_rules`): a median top-1 confidence
# under the floor is a model losing its grip; a median drift score over
# the ceiling is a prediction mix that no longer resembles the pinned
# baseline.
DEFAULT_CONFIDENCE_FLOOR = 0.5
DEFAULT_DRIFT_CEILING = 0.25


def confidence_stats(probs: Sequence[float]) -> tuple[float, float, float]:
    """(top-1 confidence, top1−top2 margin, entropy in nats) of one
    probability row. Pure stdlib math over floats — the caller hands us
    a plain sequence, not an array."""
    if not probs:
        return 0.0, 0.0, 0.0
    top1 = top2 = 0.0
    ent = 0.0
    for p in probs:
        p = float(p)
        if p > top1:
            top1, top2 = p, top1
        elif p > top2:
            top2 = p
        if p > 0.0:
            ent -= p * math.log(p)
    return top1, top1 - top2, ent


def drift_score(counts: Sequence[float],
                baseline: Sequence[float]) -> float:
    """Total-variation distance between a predicted-class count vector
    and a baseline distribution: ``0.5 * sum |p_i - q_i|`` after
    normalizing the counts. 0 = identical mix, 1 = disjoint support.
    Classes beyond either vector's length count as probability zero, so
    a baseline pinned on an older class universe still scores."""
    n = float(sum(counts))
    if n <= 0.0:
        return 0.0
    width = max(len(counts), len(baseline))
    tv = 0.0
    for i in range(width):
        p = float(counts[i]) / n if i < len(counts) else 0.0
        q = float(baseline[i]) if i < len(baseline) else 0.0
        tv += abs(p - q)
    return 0.5 * tv


def save_baseline(path: str, counts: Sequence[int], *,
                  class_names: Optional[Sequence[str]] = None,
                  source: Optional[dict] = None) -> dict:
    """Normalize a class-count vector and pin it as the baseline
    artifact (atomic tmp+replace, like run.json). Returns the record
    written. Refuses an empty count vector — a baseline that matches
    nothing is an SLO that tests nothing."""
    total = int(sum(counts))
    if total <= 0:
        raise ValueError(
            "quality baseline needs at least one prediction to pin"
        )
    rec = {
        "version": 1,
        "n": total,
        "dist": [round(int(c) / total, 6) for c in counts],
    }
    if class_names:
        rec["class_names"] = list(class_names)
    if source:
        rec["source"] = source
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(rec, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return rec


def load_baseline(path: str) -> dict:
    """Read and validate a pinned baseline. Raises ValueError on a
    malformed artifact — the same config-time refusal convention as the
    alert-rule parser: a baseline that silently fails to load is drift
    monitoring that silently never runs."""
    try:
        with open(path, encoding="utf-8") as fh:
            rec = json.load(fh)
    except (OSError, ValueError) as e:
        raise ValueError(f"unreadable quality baseline {path!r}: {e}") \
            from None
    dist = rec.get("dist")
    if not isinstance(dist, list) or not dist or \
            not all(isinstance(v, (int, float)) and v >= 0 for v in dist):
        raise ValueError(
            f"quality baseline {path!r} has no usable 'dist' vector"
        )
    total = float(sum(dist))
    if not 0.99 <= total <= 1.01:
        raise ValueError(
            f"quality baseline {path!r} dist sums to {total:.4f}, "
            "expected ~1.0"
        )
    return rec


def baseline_path(run_dir: str) -> str:
    return os.path.join(run_dir, BASELINE_FILENAME)


def quality_rules(
    confidence_floor: float = DEFAULT_CONFIDENCE_FLOOR,
    drift_ceiling: float = DEFAULT_DRIFT_CEILING,
    *,
    with_drift: bool = True,
) -> tuple[AlertRule, ...]:
    """The quality plane's alert pair: confidence collapse (median top-1
    under the floor) and, when a baseline is pinned, prediction-mix
    drift (median TV score over the ceiling). Both are ordinary window
    rules — `obs.alerts.is_serving_metric` does not match them, so a
    firing quality alert never fails a serving drain; it pages, it does
    not take the service down."""
    rules = [AlertRule("confidence_p50", "<", float(confidence_floor),
                       "warning")]
    if with_drift:
        rules.append(AlertRule("quality_drift_score_p50", ">",
                               float(drift_ceiling), "warning"))
    return tuple(rules)


class QualityTracker:
    """Rolling model-quality state for one serving process.

    ``observe(label, confidence, margin, entropy)`` is called once per
    answered request (from the batcher's single dispatcher thread; the
    lock keeps multi-writer callers safe anyway). It feeds the three
    confidence windows, advances the rolling per-class histogram, and —
    when a baseline distribution is pinned — scores the current window
    against it, feeding ``quality_drift_score`` and emitting a
    ``quality_drift`` event every ``emit_every`` predictions. Everything
    here is telemetry: no exception escapes into the serving path
    because nothing here raises past arithmetic on floats.
    """

    def __init__(self, num_classes: int,
                 baseline: Optional[Sequence[float]] = None,
                 window: int = DEFAULT_WINDOW,
                 emit_every: int = DEFAULT_EMIT_EVERY):
        self.num_classes = int(num_classes)
        self.baseline = list(baseline) if baseline is not None else None
        self.window = max(1, int(window))
        self.emit_every = max(1, int(emit_every))
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()
        self._counts = [0] * self.num_classes
        self._seen = 0
        self.last_score: Optional[float] = None

    def observe(self, label: int, confidence: float, margin: float,
                entropy: float) -> Optional[float]:
        """Fold one answered request; returns the current drift score
        (None when no baseline is pinned)."""
        _windows.observe("confidence", float(confidence))
        _windows.observe("confidence_margin", float(margin))
        _windows.observe("prediction_entropy", float(entropy))
        with self._lock:
            label = int(label)
            if 0 <= label < self.num_classes:
                self._ring.append(label)
                self._counts[label] += 1
                if len(self._ring) > self.window:
                    self._counts[self._ring.popleft()] -= 1
            self._seen += 1
            if self.baseline is None:
                return None
            score = drift_score(self._counts, self.baseline)
            self.last_score = score
            emit_now = self._seen % self.emit_every == 0
            n = len(self._ring)
            top = max(range(self.num_classes),
                      key=self._counts.__getitem__) if n else None
        _windows.observe("quality_drift_score", score)
        if emit_now:
            _events.emit("quality_drift", score=round(score, 6), n=n,
                         top_class=top)
        return score

    def stats(self) -> dict:
        with self._lock:
            return {
                "seen": self._seen,
                "window_n": len(self._ring),
                "drift_score": self.last_score,
                "baseline": self.baseline is not None,
            }
