"""Report-driven regression gates: a run judges itself (port of the report
half of ``featurenet_tpu/obs/gates.py``; stdlib only).

A gate pins a baseline of a run's report scalars (data-wait fraction,
step time, serving latency, restart count, ...) with a tolerance, and a
later report is evaluated against it mechanically:

- ``cli report <run_dir> --gate baseline.json`` exits 2 on any
  regression;
- a supervised run pins its first clean segment and judges every later
  one (``train/supervisor.py``).

Baseline JSON shape (``{"gates": {...}}`` wrapper optional)::

    {"gates": {
        "data_wait_fraction": {"value": 0.25, "tolerance": 0.10},
        "serving_p99_ms":     {"value": 12.0, "tolerance": 0.15},
        "restarts":           {"value": 0, "tolerance_abs": 1}
    }}

``tolerance`` is relative (default 0.10), ``tolerance_abs`` absolute
(default 0: the only slack a zero baseline can have); both may be given
and add. ``direction`` says which way is a regression: ``"max"`` = higher
is worse, ``"min"`` = lower is worse. An unknown metric defaults to
``"max"``. A metric the baseline pins but the report lacks fails
("missing"): a gate that cannot see its metric must not pass.

The perf keys read the report's perf section (``obs/perf.py``): ``mfu``,
the p50 of the rolling MFU, regresses downward, and
``hbm_peak_train_bytes``, the largest ``peak_bytes`` of the train
programs, upward. The reference's bench half (``BENCH_GATE_KEYS``,
``bench_gate_values``, ``mfu_train``, ``serve_mfu`` and the other bench
keys of the tables below) waits for the port's benchmark (ROADMAP Queue
A.5).
"""

from __future__ import annotations

import json
from typing import Optional

DEFAULT_TOLERANCE = 0.10

# Which way is worse, per metric ``report_gate_values`` gives: everything
# a run report yields regresses upward.
DIRECTIONS = {
    "data_wait_fraction": "max",
    "step_ms": "max",
    "serving_p99_ms": "max",
    "serving_mean_ms": "max",
    "restarts": "max",
    "stalls": "max",
    "heartbeat_max_age_s": "max",
    "bad_lines": "max",
    # Cross-host data-wait spread: a widening one is throughput leaking
    # to the slowest host.
    "data_wait_spread": "max",
    # A fleet run's dropped admitted requests, pinned at zero.
    "fleet_requests_dropped": "max",
    # The perf section: the rolling MFU is throughput restated against
    # the card's peak; the train programs' peak memory eats headroom.
    "mfu": "min",
    "hbm_peak_train_bytes": "max",
}


def report_gate_values(rep: dict) -> dict[str, float]:
    """The gateable scalars of a run report (``obs.report.build_report``).
    Only metrics the run recorded appear: a train run with no serving
    spans has no ``serving_p99_ms`` to gate."""
    vals: dict[str, float] = {}
    bd = rep.get("breakdown")
    if bd:
        vals["data_wait_fraction"] = bd["data_wait"]["fraction"]
    loop = rep.get("loop") or {}
    if loop.get("step_ms") is not None:
        vals["step_ms"] = loop["step_ms"]
    sv = rep.get("serving_latency_ms")
    if sv:
        vals["serving_p99_ms"] = sv["p99"]
        vals["serving_mean_ms"] = sv["mean"]
    sup = rep.get("supervisor")
    vals["restarts"] = float((sup or {}).get("restarts", 0))
    vals["stalls"] = float((sup or {}).get("stalls", 0))
    hb = rep.get("heartbeat")
    if hb and hb.get("max_age_s") is not None:
        vals["heartbeat_max_age_s"] = hb["max_age_s"]
    dwf = (rep.get("host_skew") or {}).get("data_wait_fraction")
    if dwf and dwf.get("spread") is not None:
        vals["data_wait_spread"] = dwf["spread"]
    # Absent when unrecorded: a CPU run has no mfu window, a program
    # without peak_bytes no memory pin.
    perf = rep.get("perf") or {}
    mfu_row = perf.get("mfu")
    if isinstance(mfu_row, dict) and mfu_row.get("p50") is not None:
        vals["mfu"] = float(mfu_row["p50"])
    train_peaks = [
        row["peak_bytes"]
        for name, row in (perf.get("programs") or {}).items()
        if name in ("train_step", "multi_train_step", "hbm_train_step")
        and isinstance(row.get("peak_bytes"), (int, float))
    ]
    if train_peaks:
        vals["hbm_peak_train_bytes"] = float(max(train_peaks))
    fleet = rep.get("fleet") or {}
    if isinstance(fleet.get("dropped"), (int, float)):
        vals["fleet_requests_dropped"] = float(fleet["dropped"])
    vals["bad_lines"] = float(rep.get("bad_lines", 0))
    return vals


def make_baseline(values: dict[str, float],
                  tolerance: float = DEFAULT_TOLERANCE) -> dict:
    """A pin-ready baseline of the current values."""
    return {
        "gates": {
            name: {
                "value": v,
                "tolerance": tolerance,
                "direction": DIRECTIONS.get(name, "max"),
            }
            for name, v in sorted(values.items())
        }
    }


# Pins that need absolute slack on top of the relative tolerance: a
# relative tolerance on a near-zero baseline pins "never change". The
# reference's table also holds its bench keys (ROADMAP Queue A.5).
NOISY_KEY_ABS_SLACK = {
    "data_wait_spread": 0.1,
}


def apply_abs_slack(baseline: dict) -> dict:
    """Stamp ``NOISY_KEY_ABS_SLACK`` onto a ``make_baseline`` result's pins
    (in place; returns it), on the keys actually pinned."""
    for noisy, slack in NOISY_KEY_ABS_SLACK.items():
        pin = baseline.get("gates", {}).get(noisy)
        if pin is not None:
            pin["tolerance_abs"] = slack
    return baseline


def evaluate_gates(values: dict[str, float], baseline: dict) -> dict:
    """Judge ``values`` against a baseline. Returns ``{"ok", "failed":
    [names], "gates": [per-gate records]}``; ``ok`` only when every
    pinned metric is present and within its limit."""
    spec = baseline.get("gates", baseline)
    gates: list[dict] = []
    failed: list[str] = []
    for name in sorted(spec):
        b = spec[name]
        if not isinstance(b, dict):
            b = {"value": b}
        base = float(b["value"])
        tol = float(b.get("tolerance", DEFAULT_TOLERANCE))
        tol_abs = float(b.get("tolerance_abs", 0.0))
        direction = b.get("direction") or DIRECTIONS.get(name, "max")
        rec: dict = {
            "metric": name,
            "baseline": base,
            "tolerance": tol,
            "direction": direction,
        }
        if tol_abs:
            rec["tolerance_abs"] = tol_abs
        value = values.get(name)
        if value is None:
            rec.update(status="missing", value=None)
            failed.append(name)
            gates.append(rec)
            continue
        value = float(value)
        if direction == "min":
            limit = base * (1.0 - tol) - tol_abs
            ok = value >= limit - 1e-12
        else:
            limit = base * (1.0 + tol) + tol_abs
            ok = value <= limit + 1e-12
        rec.update(
            status="pass" if ok else "fail",
            value=value,
            limit=round(limit, 6),
        )
        if not ok:
            failed.append(name)
        gates.append(rec)
    return {"ok": not failed, "failed": failed, "gates": gates}


def load_baseline(path: str) -> dict:
    with open(path, encoding="utf-8") as fh:
        baseline = json.load(fh)
    spec = baseline.get("gates", baseline)
    if not isinstance(spec, dict) or not spec:
        raise ValueError(
            f"baseline {path!r} pins no gates — expected "
            '{"gates": {"<metric>": {"value": ...}}} or a flat '
            "metric→value object"
        )
    return baseline


def format_gates(result: dict, baseline_path: Optional[str] = None) -> str:
    lines = []
    head = "gate: " + ("PASS" if result["ok"] else "FAIL")
    if baseline_path:
        head += f" (baseline {baseline_path})"
    lines.append(head)
    for g in result["gates"]:
        arrow = "<=" if g["direction"] == "max" else ">="
        if g["status"] == "missing":
            lines.append(
                f"  MISSING {g['metric']}: pinned at {g['baseline']} but "
                "absent from this report"
            )
        else:
            lines.append(
                f"  {'ok' if g['status'] == 'pass' else 'FAIL':<4} "
                f"{g['metric']:<36} {g['value']:>12.4g} {arrow} "
                f"{g['limit']:<12.4g} (baseline {g['baseline']:g}, "
                f"tol {g['tolerance'] * 100:g}%"
                + (f" + {g['tolerance_abs']:g}" if g.get("tolerance_abs")
                   else "")
                + ")"
            )
    return "\n".join(lines)
