"""``cli dash``: the terminal dashboard of a run directory's time-series
store (port of ``featurenet_tpu/obs/dash.py``).

Every number comes off the store (``obs/tsdb.py``): per-target qps, p99
and queue-depth sparklines, the burn-rate gauges (the same rules and math
as ``alerts.BurnEvaluator``), the model-quality panel, connection reuse,
the roster and scrape failures, and one line of the incident plane. So a
frame renders the same from a live run and from a finished one; ``cli
dash --once`` prints one frame. The per-target series are the fleet
scraper's (ROADMAP Queue A.4); a store that holds only the alert mirror's
``alerts_active`` series renders with no targets, its gauges and its
incident line.

Standard library only, read-only: ``render_frame`` returns a string and
the CLI reprints it (ANSI clear and redraw, no curses).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from featurenet_tpu_torch.obs import alerts as _alerts
from featurenet_tpu_torch.obs import incidents as _incidents
from featurenet_tpu_torch.obs import tsdb as _tsdb

DEFAULT_WINDOW_S = 300.0
SPARK_SLOTS = 32

_BLOCKS = "▁▂▃▄▅▆▇█"

ROUTER_TARGET = "router"


def _spark(vals: list) -> str:
    """One sparkline: a list of per-slot values (None = no data → a
    space) scaled to the 8 block glyphs. All-equal non-zero data renders
    mid-height, honest absence renders as gaps."""
    present = [v for v in vals if v is not None]
    if not present:
        return " " * len(vals)
    lo, hi = min(present), max(present)
    span = hi - lo
    out = []
    for v in vals:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(_BLOCKS[3] if hi else _BLOCKS[0])
        else:
            idx = int((v - lo) / span * (len(_BLOCKS) - 1))
            out.append(_BLOCKS[max(0, min(idx, len(_BLOCKS) - 1))])
    return "".join(out)


def _bucket(samples: list, now: float, window_s: float,
            slots: int = SPARK_SLOTS) -> list:
    """Slot the window's (t, v) samples into ``slots`` buckets, last
    value per bucket (gauges are scraped snapshots — last wins)."""
    out: list = [None] * slots
    t0 = now - window_s
    for t, v in samples:
        if t < t0 or t > now:
            continue
        i = min(int((t - t0) / window_s * slots), slots - 1)
        out[i] = v
    return out


def _rates(samples: list) -> list:
    """Consecutive-sample rates of a cumulative counter: (t, per-second
    increase). A counter reset (process restart) shows as a gap, not a
    negative spike."""
    out = []
    for (t1, v1), (t2, v2) in zip(samples, samples[1:]):
        dt = t2 - t1
        if dt <= 0 or v2 < v1:
            continue
        out.append((t2, (v2 - v1) / dt))
    return out


def _fmt(v, digits: int = 1) -> str:
    if v is None:
        return "-"
    return f"{v:.{digits}f}"


def _replica_targets(store) -> list[str]:
    """Every target the scraper has written samples for, replicas
    first (numeric order), router last."""
    targets = set()
    for _metric, labels in store.series():
        t = labels.get("replica")
        if t is not None:
            targets.add(t)
    reps = sorted((t for t in targets if t != ROUTER_TARGET),
                  key=lambda s: (not s.isdigit(), int(s) if s.isdigit()
                                 else 0, s))
    if ROUTER_TARGET in targets:
        reps.append(ROUTER_TARGET)
    return reps


def render_frame(run_dir: str, *, window_s: float = DEFAULT_WINDOW_S,
                 slos: Optional[str] = None,
                 fast_s: float = _alerts.DEFAULT_FAST_WINDOW_S,
                 slow_s: float = _alerts.DEFAULT_SLOW_WINDOW_S,
                 now: Optional[float] = None) -> str:
    """One dashboard frame from the store alone. ``now`` pins the frame
    time for tests; live use reads the wall clock (the store's axis)."""
    if now is None:
        now = time.time()
    store = _tsdb.TimeSeriesStore.open(run_dir)
    targets = _replica_targets(store)
    if not store.series():
        # Friendly empty state instead of a meaningless table: a brand
        # new run_dir, a typo'd path, and a finished-but-never-scraped
        # run all land here (the store absorbs the missing directory).
        where = _tsdb.store_dir(run_dir)
        why = ("no such directory" if not os.path.isdir(where)
               else "no samples yet")
        return (
            f"fleet dash · {run_dir} · 0 target(s)\n"
            f"no telemetry series under {where} ({why}) — the store is "
            f"populated by the fleet scraper (`cli fleet --run-dir`), "
            f"so point dash at a fleet run_dir or wait for the first "
            f"scrape round\n"
            f"{_incident_line(run_dir)}\n"
        )
    lines = [
        f"fleet dash · {run_dir} · window {window_s:g}s · "
        f"{len(targets)} target(s)",
        "",
    ]
    head = (f"{'replica':<8} {'qps':<{SPARK_SLOTS + 8}} "
            f"{'p99_ms':<{SPARK_SLOTS + 9}} {'queue':<{SPARK_SLOTS + 6}}")
    lines.append(head)
    for target in targets:
        if target == ROUTER_TARGET:
            served = store.query("fleet_requests_total",
                                 {"outcome": "answered",
                                  "replica": target},
                                 since_s=window_s + 60, now=now)
        else:
            served = store.query("requests_total",
                                 {"outcome": "served", "replica": target},
                                 since_s=window_s + 60, now=now)
        qps = _bucket(_rates(served), now, window_s)
        p99s = store.query("serving_ms", {"q": "0.99", "replica": target},
                           since_s=window_s, now=now)
        p99 = _bucket(p99s, now, window_s)
        depth = _bucket(
            store.query("serve_queue_depth", {"replica": target},
                        since_s=window_s, now=now),
            now, window_s,
        )
        last_qps = next((v for v in reversed(qps) if v is not None), None)
        last_p99 = next((v for v in reversed(p99) if v is not None), None)
        last_dep = next((v for v in reversed(depth) if v is not None),
                        None)
        lines.append(
            f"{target:<8} {_spark(qps)} {_fmt(last_qps):>6}  "
            f"{_spark(p99)} {_fmt(last_p99):>7}  "
            f"{_spark(depth)} {_fmt(last_dep, 0):>4}"
        )

    # Burn gauges: the same rules + math the router's verdicts use.
    lines.append("")
    rules = _alerts.parse_slos(slos, fast_s=fast_s, slow_s=slow_s)
    for rule in rules:
        sel = _alerts.burn_selector(rule.metric)
        if sel is None:
            continue
        samples = store.query(sel[0], sel[1], since_s=rule.slow_s,
                              now=now)
        fast = _alerts.burn_rate(samples, rule, rule.fast_s, now)
        slow = _alerts.burn_rate(samples, rule, rule.slow_s, now)
        firing = (fast is not None and slow is not None
                  and fast > rule.max_burn and slow > rule.max_burn)
        state = "FIRING" if firing else "ok"
        lines.append(
            f"burn {rule.metric} ({rule.op}{rule.threshold:g}@"
            f"{rule.objective * 100:g}%): fast {_fmt(fast, 2)}  "
            f"slow {_fmt(slow, 2)}  [{state}]"
        )

    # Model-quality panel: only when the quality plane is on (some
    # target exported confidence windows into the store). Confidence
    # p50 collapsing and the drift score rising are exactly the two
    # lines the quality alert rules watch.
    q_rows = []
    for target in targets:
        conf_s = store.query("confidence", {"q": "0.5", "replica": target},
                             since_s=window_s, now=now)
        drift_s = store.query("quality_drift_score",
                              {"q": "0.5", "replica": target},
                              since_s=window_s, now=now)
        if not conf_s and not drift_s:
            continue
        conf = _bucket(conf_s, now, window_s)
        drift = _bucket(drift_s, now, window_s)
        last_c = next((v for v in reversed(conf) if v is not None), None)
        last_d = next((v for v in reversed(drift) if v is not None), None)
        q_rows.append(
            f"{target:<8} {_spark(conf)} {_fmt(last_c, 3):>7}  "
            f"{_spark(drift)} {_fmt(last_d, 3):>7}"
        )
    if q_rows:
        lines.append("")
        lines.append(
            f"{'quality':<8} {'confidence p50':<{SPARK_SLOTS + 9}} "
            f"{'drift p50':<{SPARK_SLOTS + 9}}"
        )
        lines.extend(q_rows)

    # Fleet-level channel reuse (router counters) + roster + collection
    # health.
    opened = store.latest("connections_opened_total",
                          {"replica": ROUTER_TARGET})
    reused = store.latest("connections_reused_total",
                          {"replica": ROUTER_TARGET})
    if opened and reused and (opened[1] + reused[1]) > 0:
        ratio = reused[1] / (opened[1] + reused[1])
        lines.append(f"conn reuse: {ratio:.3f} "
                     f"(opened {opened[1]:g}, reused {reused[1]:g})")
    healthy = total = 0
    for target in targets:
        if target == ROUTER_TARGET:
            continue
        total += 1
        last = store.latest("ready", {"replica": target})
        if last is not None and last[1] > 0:
            healthy += 1
    fails = 0
    for metric, labels in store.series():
        if metric == "scrape_failures_total":
            last = store.latest(metric, labels)
            if last is not None:
                fails += int(last[1])
    lines.append(f"roster: {healthy}/{total} replicas ready · "
                 f"scrape failures: {fails}")
    lines.append(_incident_line(run_dir))
    return "\n".join(lines) + "\n"


def _incident_line(run_dir: str) -> str:
    """The incident plane's one-line dash summary, from the bundle
    directory alone: open/recent counts + the last incident's identity.
    A run with no incidents renders a friendly empty state (``--once``
    must stay CI-renderable on any run_dir)."""
    bundles = _incidents.list_incidents(run_dir)
    if not bundles:
        return "incidents: none recorded"
    n_open = sum(1 for b in bundles if b.get("state") == "open")
    last = bundles[-1]
    return (
        f"incidents: {n_open} open · {len(bundles)} recent · last "
        f"{last['id']} ({last.get('rule', '?')}, "
        f"{last.get('state', '?')})"
    )
