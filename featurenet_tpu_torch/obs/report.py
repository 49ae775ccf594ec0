"""Post-hoc run analysis: fold the run's event stream(s) into answers
(port of ``featurenet_tpu/obs/report.py``).

``build_report`` turns a run directory's event log into the questions an
operator actually asks after a run (or a crash):

- **Where did the wall-clock go?** Step-time breakdown over the train
  loop's window(s): data-wait vs dispatch vs readback vs eval vs
  checkpoint seconds and fractions, with ``other`` as the explicit
  remainder so the fractions always account for 100% of loop wall time.
- **Did the input pipeline starve the device?** Prefetch queue-depth
  percentiles (a queue pinned at 0 = starved consumer) and producer
  batch-generation timing.
- **Was the run healthy?** Heartbeat count + max inter-beat age, the
  supervisor's restart/stall timeline, warning counts, and every
  ``run_start`` (each process (re)spawn) in order.
- **How fast is serving?** Per-batch ``infer_batch`` latency percentiles.
- **Which host is the problem?** Multi-process runs write one stream per
  host (``events.<i>.jsonl``); ``load_events`` discovers and merges them,
  tagging every record with its ``process_index``, and the report grows a
  per-host breakdown (data-wait fraction, heartbeat gaps, warnings) plus
  cross-host skew stats — the slowest host's data-wait is where a lockstep
  mesh actually spends its time.

``EventTail`` + ``follow_report`` are the live view: re-read the same
streams incrementally (seek to the last offset, parse only new complete
lines) and re-render while the run is hot.

Everything here is stdlib-only and never imports torch: the report CLI
must run on a machine (or in a moment) where the card that produced the
run is gone.

The perf section folds ``program_cost``, ``program_compile`` and
``device_memory`` events and the ``mfu`` window against ``obs.perf``'s
peak table (standard library only). The incidents section folds the
``incident_*`` events, and ``build_report_dir`` adds the bundles on disk
(``obs/incidents.py``) and the fleet timeline read from the run's
time-series store alone (``fleet_timeline_section``, ``obs/tsdb.py``).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Iterable, Optional

from featurenet_tpu_torch.obs.events import EVENTS_FILENAME, MANIFEST_FILENAME

# Loop-attributed span names, in display order. "device" time is
# dispatch + readback: the dispatch call enqueues work, the readback is
# where the host actually blocks on device execution.
LOOP_CATEGORIES = ("data_wait", "dispatch", "readback", "eval", "checkpoint")

# Every span name the package emits. The report keys aggregations off
# these literals, so a renamed emit site would silently fall out of its
# section (tests/test_torch_report.py holds the port's emit sites to it).
KNOWN_SPAN_NAMES = frozenset({
    *LOOP_CATEGORIES,
    # checkpoint internals (train/checkpoint.py): checkpoint_save is the
    # host-blocking snapshot and enqueue; checkpoint_write is the
    # background writer's copy to the host and file write (where save_slow
    # latency lands, off the step path).
    "checkpoint_save", "checkpoint_restore", "checkpoint_wait",
    "checkpoint_write",
    # serving (infer.py) and the metrics readback (utils/logging.py)
    "infer_batch",
    # the continuous batcher's compiled-forward dispatch (serve/batcher.py)
    "serve_dispatch",
    # offline export / ingest (data/offline.py, data/voxelize.py)
    "build_cache_class", "export_class", "export_seg_shard",
    "seg_cache_flush", "build_seg_cache", "voxelize",
})

_PER_HOST_RE = re.compile(r"events\.(\d+)\.jsonl\Z")


def discover_event_files(run_dir: str) -> list[tuple[str, int]]:
    """Every event stream in ``run_dir`` as ``(path, process_index)``,
    index-ordered. Accepts the legacy single-file layout (``events.jsonl``
    = host 0), the per-host layout (``events.<i>.jsonl``), and any mix —
    including a dir where host 0's file is missing (e.g. only non-zero
    hosts shared this filesystem)."""
    try:
        names = os.listdir(run_dir)
    except OSError:
        return []
    found: list[tuple[str, int]] = []
    for name in names:
        if name == EVENTS_FILENAME:
            found.append((os.path.join(run_dir, name), 0))
        else:
            m = _PER_HOST_RE.match(name)
            if m:
                found.append((os.path.join(run_dir, name), int(m.group(1))))
    return sorted(found, key=lambda pi: pi[1])


def _parse_lines(lines: Iterable[str], process_index: int,
                 events: list[dict]) -> int:
    """Parse JSONL lines into ``events`` (tagging each record with its
    stream's ``process_index``); returns the unparseable-line count (a
    torn line from a killed process must not take the report down with
    it — it is exactly the crashed run we are here to inspect)."""
    bad = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            e = json.loads(line)
        except ValueError:
            bad += 1
            continue
        if isinstance(e, dict) and "t" in e and "ev" in e:
            e.setdefault("process_index", process_index)
            events.append(e)
        else:
            bad += 1
    return bad


def load_events(run_dir: str) -> tuple[list[dict], int]:
    """All events from every discovered per-host stream, merged and
    time-ordered, each tagged with the ``process_index`` of the stream it
    came from; plus the count of unparseable lines across all streams.
    Raises ``FileNotFoundError`` when the directory holds no event stream
    at all (callers can render what *was* found)."""
    files = discover_event_files(run_dir)
    if not files:
        raise FileNotFoundError(
            f"no event stream ({EVENTS_FILENAME} or events.<i>.jsonl) "
            f"in {run_dir!r}"
        )
    events: list[dict] = []
    bad = 0
    for path, idx in files:
        with open(path, encoding="utf-8") as fh:
            bad += _parse_lines(fh, idx, events)
    events.sort(key=lambda e: e["t"])
    return events, bad


def load_manifest(run_dir: str) -> Optional[dict]:
    path = os.path.join(run_dir, MANIFEST_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)


def _pct(sorted_vals: list, q: float):
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return None
    i = int(round(q / 100.0 * (len(sorted_vals) - 1)))
    return sorted_vals[min(max(i, 0), len(sorted_vals) - 1)]


def _loop_windows(events: list[dict]) -> list[tuple[dict, dict]]:
    """(start, end) event pairs. A trailing start without an end is the
    run that was SIGKILLed mid-loop (a supervisor stall verdict skips the
    finally block) — exactly the segment worth diagnosing — so it is
    closed synthetically at the last event's timestamp instead of being
    dropped; the synthetic end carries ``truncated: True`` and the
    highest step any event in the window reported."""
    def close(start: dict, t_end: float) -> dict:
        last_step = max(
            (e["step"] for e in events
             if start["t"] <= e["t"] <= t_end
             and isinstance(e.get("step"), (int, float))),
            default=start.get("step", 0),
        )
        return {"t": t_end, "step": int(last_step),
                "wall_s": t_end - start["t"], "truncated": True}

    windows = []
    start = None
    for e in events:
        if e["ev"] == "loop_start":
            # A start while one is pending = the previous segment died
            # without its loop_end and a respawn began; close the dead
            # one at the respawn boundary so its spans stay attributed.
            if start is not None and e["t"] > start["t"]:
                windows.append((start, close(start, e["t"])))
            start = e
        elif e["ev"] == "loop_end" and start is not None:
            windows.append((start, e))
            start = None
    if start is not None and events and events[-1]["t"] > start["t"]:
        windows.append((start, close(start, events[-1]["t"])))
    return windows


def _loop_stats(events: list[dict]) -> tuple[dict, Optional[dict],
                                             Optional[float]]:
    """One host's loop section: ``(loop, breakdown, attributed_fraction)``
    — the latter two None when no loop wall was recorded. Shared by the
    main report body and the per-host summaries so both attribute span
    time the same way."""
    windows = _loop_windows(events)
    wall = sum(
        end.get("wall_s", end["t"] - start["t"]) for start, end in windows
    )
    steps = sum(
        end.get("step", 0) - start.get("step", 0) for start, end in windows
    )
    spans = [e for e in events if e["ev"] == "span" and "dur_s" in e]
    in_window = [
        s for s in spans
        if any(st["t"] <= s["t"] <= en["t"] for st, en in windows)
    ]
    cat_s = {c: 0.0 for c in LOOP_CATEGORIES}
    for s in in_window:
        if s.get("name") in cat_s:
            cat_s[s["name"]] += s["dur_s"]
    loop = {
        "windows": len(windows),
        "truncated_windows": sum(
            1 for _, end in windows if end.get("truncated")
        ),
        "wall_s": round(wall, 4),
        "steps": steps,
        "step_ms": round(wall / steps * 1e3, 2) if steps else None,
    }
    if wall <= 0:
        return loop, None, None
    attributed = sum(cat_s.values())
    breakdown = {
        c: {"seconds": round(v, 4), "fraction": round(v / wall, 4)}
        for c, v in cat_s.items()
    }
    other = max(wall - attributed, 0.0)
    breakdown["other"] = {
        "seconds": round(other, 4),
        "fraction": round(other / wall, 4),
    }
    return loop, breakdown, round(min(attributed / wall, 1.0), 4)


def _host_summary(events: list[dict]) -> dict:
    """Per-host digest for the multi-host section: where did THIS host's
    loop wall go, did its heartbeat gap (stall attribution — the host
    whose beats stopped is the one that hung), what did it warn about."""
    loop, breakdown, attributed = _loop_stats(events)
    out: dict = {
        "events": len(events),
        "wall_s": loop["wall_s"],
        "steps": loop["steps"],
        "step_ms": loop["step_ms"],
    }
    if breakdown is not None:
        out["fractions"] = {
            name: row["fraction"] for name, row in breakdown.items()
        }
        out["attributed_fraction"] = attributed
    starts = [e["t"] for e in events if e["ev"] == "loop_start"]
    if starts:
        out["t_first_loop_start"] = round(min(starts), 3)
    beat_ts = sorted(e["t"] for e in events if e["ev"] == "heartbeat")
    ages = [e.get("age_s") for e in events
            if e["ev"] == "heartbeat" and e.get("age_s") is not None]
    out["heartbeat"] = {
        "beats": len(beat_ts),
        "max_age_s": round(max(ages), 3) if ages else None,
        # Largest observed silence between consecutive beats, extended to
        # the host's last event: a host that stopped beating mid-run shows
        # the gap even though no later beat ever stamped an age.
        "max_gap_s": round(max(
            [b - a for a, b in zip(beat_ts, beat_ts[1:])]
            + ([events[-1]["t"] - beat_ts[-1]] if events else []),
        ), 3) if beat_ts else None,
    }
    n_warn = sum(1 for e in events if e["ev"] == "warning")
    if n_warn:
        out["warnings"] = n_warn
    # Latest window_summary per metric for THIS host: multi-host serving
    # skew (one host's p99 blowing while the fleet median looks fine) is
    # invisible in the merged headline — the host table is where it reads.
    wins: dict = {}
    for e in events:
        if e["ev"] == "window_summary" and e.get("metric"):
            wins[e["metric"]] = {
                k: e[k] for k in ("n", "p50", "p99", "seq") if k in e
            }
    if wins:
        out["windows"] = wins
    return out


def _host_skew(hosts: dict[int, dict]) -> dict:
    """Cross-host skew: how far apart the hosts' loops started, how
    unevenly the input pipeline starved them, and whether any host fell
    out of step (lockstep dispatch means the global step time is the
    slowest host's — a fat data-wait spread is free throughput)."""
    skew: dict = {}
    starts = [h["t_first_loop_start"] for h in hosts.values()
              if h.get("t_first_loop_start") is not None]
    if len(starts) >= 2:
        skew["loop_start_skew_s"] = round(max(starts) - min(starts), 3)
    walls = [h["wall_s"] for h in hosts.values() if h.get("wall_s")]
    if len(walls) >= 2:
        skew["wall_s_skew"] = round(max(walls) - min(walls), 4)
    dw = [h["fractions"]["data_wait"] for h in hosts.values()
          if h.get("fractions")]
    if len(dw) >= 2:
        skew["data_wait_fraction"] = {
            "min": round(min(dw), 4),
            "max": round(max(dw), 4),
            "spread": round(max(dw) - min(dw), 4),
        }
    steps = {i: h["steps"] for i, h in hosts.items()}
    if len(set(steps.values())) > 1:
        # Hosts run the same global loop; a step mismatch means a stream
        # is truncated (killed host) or a host diverged — surface it.
        skew["step_mismatch"] = steps
    return skew


def _report_rules(manifest: Optional[dict]) -> list:
    """The alert rules this run was configured with — read back from the
    manifest's persisted config so the post-hoc judge applies the same
    thresholds the live engine did; defaults when absent/garbled."""
    from featurenet_tpu_torch.obs.alerts import DEFAULT_RULES, parse_rules

    spec = ((manifest or {}).get("config") or {}).get("alert_rules")
    try:
        return parse_rules(spec)
    except (ValueError, TypeError):
        return list(DEFAULT_RULES)


def _slo_section(events: list[dict], primary: list[dict]) -> dict:
    """Fold ``window_summary`` + ``alert`` events into the SLO view:
    latest window percentiles per metric (primary host — the canonical
    loop) and per-rule alert counts across every host (an alert on host 3
    must not be invisible in the headline). Alerts are hysteresis pairs:
    a rule is ACTIVE while its last transition on ANY host is an
    unresolved ``state="fire"``; ``count`` counts fires, ``resolves``
    their recoveries. Legacy streams (pre-hysteresis, no ``state``) fall
    back to the old heuristic — the last alert's ``window`` seq matching
    that host's latest summary."""
    out: dict = {}
    windows: dict = {}
    for e in primary:
        if e["ev"] == "window_summary":
            row = {
                k: e[k] for k in ("n", "p50", "p95", "p99", "mean", "max",
                                  "seq")
                if k in e
            }
            row["t"] = round(e["t"], 3)
            windows[e["metric"]] = row
    if windows:
        out["windows"] = windows
    latest_seq: dict[int, int] = {}
    for e in events:
        if e["ev"] == "window_summary" and isinstance(e.get("seq"), int):
            h = int(e.get("process_index") or 0)
            latest_seq[h] = max(latest_seq.get(h, 0), e["seq"])
    alerts: dict = {}
    last_per_host: dict[tuple, dict] = {}
    for e in events:
        if e["ev"] != "alert":
            continue
        r = alerts.setdefault(
            e["rule"], {"count": 0, "resolves": 0, "active": False}
        )
        if e.get("state") == "resolve":
            r["resolves"] += 1
        else:
            r["count"] += 1
        r["last_value"] = e.get("value")
        r["threshold"] = e.get("threshold")
        r["severity"] = e.get("severity")
        last_per_host[(e["rule"], int(e.get("process_index") or 0))] = e
    # Active = ANY host whose latest transition is an unresolved fire — a
    # rule still live on host 0 must not be masked by a later-timestamped
    # recovered firing on host 3.
    for (rule, h), e in last_per_host.items():
        if "state" in e:
            if e["state"] == "fire":
                alerts[rule]["active"] = True
        elif e.get("window") is not None \
                and e["window"] == latest_seq.get(h):
            alerts[rule]["active"] = True
    if alerts:
        out["alerts"] = alerts
    return out


def _perf_section(events: list[dict], slo: dict) -> dict:
    """Performance attribution (``obs/perf.py``): fold the
    ``program_cost``, ``program_compile`` and ``device_memory`` events and
    the rolling ``mfu`` window into a per-program table. The peak table
    and the roofline verdict are ``obs.perf``'s module-level data, never a
    live device. A counter a program did not report has no cell, and a
    device kind without a peak reads as the explicit unknown tier, never
    a number."""
    from featurenet_tpu_torch.obs import perf as _perf

    programs: dict[str, dict] = {}
    device_kind = None
    for e in events:
        if e["ev"] == "program_cost" and e.get("program"):
            row = programs.setdefault(str(e["program"]), {})
            # Latest capture wins (a rebuilt program re-reports itself).
            for k in ("flops", "bytes", "temp_bytes", "peak_bytes",
                      "argument_bytes", "output_bytes", "alias_bytes",
                      "optimal_seconds"):
                if isinstance(e.get(k), (int, float)):
                    row[k] = e[k]
            if e.get("precision"):
                row["precision"] = str(e["precision"])
            if e.get("device_kind"):
                device_kind = e["device_kind"]
        elif e["ev"] == "program_compile" and e.get("program"):
            row = programs.setdefault(str(e["program"]), {})
            row["compile_s"] = round(
                row.get("compile_s", 0.0) + float(e.get("dur_s") or 0.0), 3
            )
    out: dict = {}
    peaks = _perf.device_peaks(device_kind)
    for row in programs.values():
        fl, by = row.get("flops"), row.get("bytes")
        if fl and by:
            row["intensity_flops_per_byte"] = round(fl / by, 2)
        verdict = _perf.roofline(fl, by, peaks)
        if verdict is not None:
            row["roofline"] = verdict
    if programs:
        out["programs"] = dict(sorted(programs.items()))
    if device_kind is not None:
        out["device_kind"] = device_kind
        out["tier"] = peaks["tier"]
        if peaks.get("peak_flops"):
            out["peak_tflops"] = round(peaks["peak_flops"] / 1e12, 1)
    mfu = (slo.get("windows") or {}).get("mfu")
    if mfu:
        out["mfu"] = mfu
    bw = (slo.get("windows") or {}).get("achieved_bw_fraction")
    if bw:
        out["achieved_bw_fraction"] = bw
    # The device-memory watermark: last and peak bytes per polled device
    # (every host's stream counts: each polls its own devices).
    mem: dict[str, dict] = {}
    for e in events:
        if e["ev"] != "device_memory" or "bytes_in_use" not in e:
            continue
        key = f"{int(e.get('process_index') or 0)}/{e.get('device', 0)}"
        d = mem.setdefault(key, {"samples": 0, "watermark_bytes": 0})
        d["samples"] += 1
        d["bytes_in_use"] = e["bytes_in_use"]
        d["watermark_bytes"] = max(
            d["watermark_bytes"], e["bytes_in_use"],
            e.get("peak_bytes_in_use") or 0,
        )
        if e.get("bytes_limit") is not None:
            d["bytes_limit"] = e["bytes_limit"]
    if mem:
        out["device_memory"] = dict(sorted(mem.items()))
    return out


def _traces_section(events: list[dict],
                    trace_sample: float = 1.0) -> dict:
    """Fold the sampled per-request timelines (obs.tracing) into the
    answers an operator asks of the tail: how many requests were
    sampled/forced, which ten were slowest (WITH their batch
    attribution — the bucket and dispatch they rode), and how far the
    client-observed latency sits above the server's own (``loadgen``
    summary vs the sampled ``request_done`` p99: the skew is queueing
    upstream of admission, measured on one clock). Every host's stream
    counts — a fleet's requests land wherever they were served.

    ``trace_sample`` is the rate the run was configured with (from the
    manifest): below 1.0 the sampled ``request_done`` set is tail-
    biased BY DESIGN (forced slow/failed requests stay, healthy ones
    drop), so its percentiles overstate the true server latency — they
    are labeled as sample-biased and the client-vs-server skew is
    suppressed rather than reported against a biased denominator."""
    done = [e for e in events if e["ev"] == "request_done"]
    rejects = [e for e in events if e["ev"] == "request_reject"]
    if not done and not rejects:
        return {}
    out: dict = {
        "sampled": len(done),
        "rejected": len(rejects),
        "forced": sum(1 for e in done if e.get("forced"))
        + len(rejects),
        "errors": sum(1 for e in done if e.get("outcome") == "error"),
    }
    # Batch attribution per trace: the dispatch event carries the seq /
    # bucket / pad the request rode (last one wins — retries don't exist
    # today, but a re-dispatched future would be the interesting one).
    disp: dict[str, dict] = {}
    for e in events:
        if e["ev"] == "request_dispatch" and e.get("trace"):
            disp[e["trace"]] = e
    slowest = sorted(
        done, key=lambda e: e.get("total_ms") or 0.0, reverse=True
    )[:10]
    out["slowest"] = [
        {
            "trace": e.get("trace"),
            "total_ms": e.get("total_ms"),
            "queue_wait_ms": e.get("queue_wait_ms"),
            "dispatch_ms": e.get("dispatch_ms"),
            "outcome": e.get("outcome"),
            "batch_seq": (disp.get(e.get("trace")) or {}).get("batch_seq"),
            "bucket": (disp.get(e.get("trace")) or {}).get("bucket"),
        }
        for e in slowest
    ]
    complete = trace_sample >= 1.0
    if not complete:
        out["sample_rate"] = trace_sample
        out["sample_biased"] = True
    totals = sorted(
        e["total_ms"] for e in done
        if isinstance(e.get("total_ms"), (int, float))
    )
    if totals:
        out["server_p50_ms"] = round(_pct(totals, 50), 3)
        out["server_p99_ms"] = round(_pct(totals, 99), 3)
    lg = [e for e in events if e["ev"] == "loadgen"]
    if lg:
        last = lg[-1]
        client = {
            k: last.get(k) for k in ("n", "client_p50_ms", "client_p99_ms")
        }
        if complete and totals \
                and isinstance(last.get("client_p99_ms"), (int, float)):
            client["skew_p99_ms"] = round(
                last["client_p99_ms"] - _pct(totals, 99), 3
            )
        out["client"] = client
    return out


def request_timeline(events: list[dict], trace_id: str) -> dict:
    """One request's admit→dispatch→done (or reject) timeline, merged
    across every host stream and time-ordered. Returns ``{"trace",
    "found", "events": [...]}`` where each row carries its host, the
    offset from the first event, and the kind-specific fields — the
    answer to "what happened to THIS request"."""
    rows = sorted(
        (e for e in events
         if e.get("ev") in REQUEST_EVENT_KINDS
         and e.get("trace") == trace_id),
        key=lambda e: e["t"],
    )
    if not rows:
        return {"trace": trace_id, "found": False, "events": []}
    t0 = rows[0]["t"]
    return {
        "trace": trace_id,
        "found": True,
        "events": [
            {
                "event": e["ev"],
                "t": round(e["t"], 6),
                "offset_ms": round((e["t"] - t0) * 1e3, 3),
                "host": int(e.get("process_index") or 0),
                **{k: v for k, v in e.items()
                   if k not in ("ev", "t", "trace", "pid",
                                "process_index", "thread")},
            }
            for e in rows
        ],
    }


def format_request_timeline(tl: dict) -> str:
    """Human rendering of ``request_timeline`` (the CLI's ``--request``
    output)."""
    if not tl["found"]:
        return (
            f"trace {tl['trace']}: no events in this run dir — the id "
            "may be wrong, or the request fell outside the sampling "
            "rate (rejections, errors, and SLO breaches are always "
            "sampled; healthy traffic at Config.trace_sample)"
        )
    lines = [f"trace {tl['trace']}"]
    for e in tl["events"]:
        detail = {k: v for k, v in e.items()
                  if k not in ("event", "t", "offset_ms", "host")}
        lines.append(
            f"  +{e['offset_ms']:>9.3f} ms  host {e['host']}  "
            f"{e['event']:<16} {detail or ''}"
        )
    return "\n".join(lines)


def build_report(events: list[dict], manifest: Optional[dict] = None,
                 bad_lines: int = 0) -> dict:
    by_host: dict[int, list[dict]] = {}
    for e in events:
        by_host.setdefault(int(e.get("process_index") or 0), []).append(e)
    # Host 0's stream carries the canonical loop (plus the supervisor's
    # events); a run dir holding only non-zero hosts' streams still
    # reports, anchored on the lowest index present.
    primary_idx = 0 if 0 in by_host or not by_host else min(by_host)
    primary = by_host.get(primary_idx, [])

    rep: dict = {"n_events": len(events), "bad_lines": bad_lines}
    if manifest:
        cfg = manifest.get("config") or {}
        rep["run"] = {
            "run_dir": manifest.get("run_dir"),
            "start_time": manifest.get("start_time"),
            "config_name": cfg.get("name"),
            "task": cfg.get("task"),
            # The port's run.json keeps its topology under "torch"
            # (obs/events.py); the reference's under "jax".
            "process_index": (manifest.get("torch") or {}).get("process_index"),
            "device_count": (manifest.get("torch") or {}).get("device_count"),
        }
    # Primary host only: this field is the respawn counter (the restart
    # timeline), and every host's init_run emits one run_start — counting
    # across hosts would read a clean 4-host run as three restarts.
    rep["process_starts"] = sum(
        1 for e in primary if e["ev"] == "run_start"
    )

    # --- step-time breakdown over the primary host's loop window(s) ---------
    loop, breakdown, attributed = _loop_stats(primary)
    rep["loop"] = loop
    if breakdown is not None:
        rep["breakdown"] = breakdown
        rep["attributed_fraction"] = attributed
    spans = [e for e in primary if e["ev"] == "span" and "dur_s" in e]

    # --- per-host breakdown + cross-host skew (multi-process runs) ----------
    if len(by_host) > 1:
        rep["hosts"] = {
            i: _host_summary(evts) for i, evts in sorted(by_host.items())
        }
        rep["host_skew"] = _host_skew(rep["hosts"])

    # --- live SLOs: rolling-window summaries + alert firings ----------------
    slo = _slo_section(events, primary)
    # The one rule no single process can judge: cross-host data-wait
    # spread. The report is where the streams merge, so it is evaluated
    # here, with the thresholds the run was configured with.
    dwf = (rep.get("host_skew") or {}).get("data_wait_fraction")
    if dwf and dwf.get("spread") is not None:
        for rule in _report_rules(manifest):
            if rule.scope == "report" and rule.metric == "data_wait_spread" \
                    and rule.violated(dwf["spread"]):
                slo.setdefault("alerts", {})[rule.metric] = {
                    "count": 1,
                    "last_value": dwf["spread"],
                    "threshold": rule.threshold,
                    "severity": rule.severity,
                    "active": True,
                    "source": "report",
                }
    if slo:
        rep["slo"] = slo

    # --- input pipeline (primary host) --------------------------------------
    depths = sorted(
        e["value"] for e in primary
        if e["ev"] == "gauge" and e.get("name") == "prefetch_queue_depth"
    )
    if depths:
        rep["prefetch_queue_depth"] = {
            "n": len(depths),
            "p10": _pct(depths, 10),
            "p50": _pct(depths, 50),
            "p90": _pct(depths, 90),
            "max": depths[-1],
        }
    gen = sorted(
        e["value"] for e in primary
        if e["ev"] == "gauge" and e.get("name") == "producer_batch_s"
    )
    if gen:
        rep["producer_batch_s"] = {
            "n": len(gen),
            "mean": round(sum(gen) / len(gen), 4),
            "p90": round(_pct(gen, 90), 4),
            "max": round(gen[-1], 4),
        }

    # --- liveness / supervision --------------------------------------------
    # Heartbeats: primary host (per-host gaps live in rep["hosts"]); the
    # supervisor timeline spans every stream — it writes into host 0's
    # file, but synthetic/merged logs may carry it anywhere.
    beats = [e for e in primary if e["ev"] == "heartbeat"]
    if beats:
        ages = [e.get("age_s") for e in beats if e.get("age_s") is not None]
        rep["heartbeat"] = {
            "beats": len(beats),
            "max_age_s": round(max(ages), 3) if ages else None,
        }
    sup = [e for e in events if e["ev"] == "supervisor"]
    if sup:
        phases = [e.get("phase") for e in sup]
        rep["supervisor"] = {
            "stalls": phases.count("stall"),
            "restarts": phases.count("restart"),
            "planned_restarts": phases.count("planned_restart"),
            "backoffs": phases.count("backoff"),
            "gate_regressions": phases.count("gate_regression"),
            "timeline": [
                {"t": round(e["t"], 3), "phase": e.get("phase"),
                 **{k: v for k, v in e.items()
                    if k not in ("t", "ev", "phase")}}
                for e in sup
            ],
        }
    # Recovery events: preemptions drained to a checkpoint, restores
    # that fell back past a corrupt step, and the elastic membership
    # timeline (mesh re-forms with their per-slot leave/join
    # transitions) — every host's stream counts (a preempted host ≠
    # host 0 in general; the coordinator writes into host 0's).
    rec = [e for e in events
           if e["ev"] in ("preempt", "checkpoint_fallback", "mesh_reform",
                          "host_leave", "host_join")]
    if rec:
        rep["recovery"] = {
            "preempts": sum(e["ev"] == "preempt" for e in rec),
            "checkpoint_fallbacks": sum(
                e["ev"] == "checkpoint_fallback" for e in rec
            ),
            "mesh_reforms": sum(e["ev"] == "mesh_reform" for e in rec),
            "host_leaves": sum(e["ev"] == "host_leave" for e in rec),
            "host_joins": sum(e["ev"] == "host_join" for e in rec),
            "timeline": [
                {"t": round(e["t"], 3), "event": e["ev"],
                 **{k: v for k, v in e.items()
                    if k not in ("t", "ev", "pid")}}
                for e in rec
            ],
        }

    # --- runtime registry: compiles vs executable-cache verdicts ------------
    # Every host's stream counts (respawned children each pay their own
    # compiles — that is exactly the cost the cache exists to collapse).
    rts = [e for e in events
           if e["ev"] in ("program_compile", "cache_hit", "cache_miss",
                          "cache_reject")]
    if rts:
        compiles = [e for e in rts if e["ev"] == "program_compile"]
        rep["runtime"] = {
            "compiles": len(compiles),
            "compile_s": round(
                sum(e.get("dur_s", 0.0) for e in compiles), 3
            ),
            "cache_hits": sum(e["ev"] == "cache_hit" for e in rts),
            "cache_misses": sum(e["ev"] == "cache_miss" for e in rts),
            "cache_rejects": sum(e["ev"] == "cache_reject" for e in rts),
            "programs": sorted({
                e.get("program", "?") for e in rts
            }),
            "rejects": [
                {"program": e.get("program"), "reason": e.get("reason")}
                for e in rts if e["ev"] == "cache_reject"
            ],
        }

    # --- performance attribution (obs.perf) ---------------------------------
    perf = _perf_section(events, slo)
    if perf:
        rep["perf"] = perf

    # --- serving ------------------------------------------------------------
    lat = sorted(
        s["dur_s"] * 1e3 for s in spans if s.get("name") == "infer_batch"
    )
    if lat:
        rep["serving_latency_ms"] = {
            "batches": len(lat),
            "rows": sum(
                s.get("n", 0) for s in spans if s.get("name") == "infer_batch"
            ),
            "mean": round(sum(lat) / len(lat), 3),
            "p50": round(_pct(lat, 50), 3),
            "p90": round(_pct(lat, 90), 3),
            "p99": round(_pct(lat, 99), 3),
            "max": round(lat[-1], 3),
        }

    # --- serving front end (continuous batcher) -----------------------------
    # Every host's stream counts, like the runtime section: a serving
    # fleet is one service per host and each one's batches/overloads are
    # part of the answer.
    sb = [e for e in events if e["ev"] == "serve_batch"]
    n_over = sum(1 for e in events if e["ev"] == "overload")
    stops = [e for e in events if e["ev"] == "serve_stop"]
    if sb or n_over or stops:
        srows = sum(e.get("n", 0) for e in sb)
        scap = sum(e.get("bucket", 0) for e in sb)
        by_bucket: dict[str, int] = {}
        for e in sb:
            key = str(e.get("bucket", "?"))
            by_bucket[key] = by_bucket.get(key, 0) + 1
        serve: dict = {
            "batches": len(sb),
            "rows": srows,
            "occupancy": round(srows / scap, 4) if scap else None,
            "by_bucket": dict(sorted(
                by_bucket.items(),
                key=lambda kv: (not kv[0].isdigit(),
                                int(kv[0]) if kv[0].isdigit() else 0),
            )),
            "overloads": n_over,
        }
        if stops:
            serve["served"] = stops[-1].get("served")
            serve["rejected"] = stops[-1].get("rejected")
        rep["serve"] = serve

    # --- model quality (obs.quality / serve.recorder / cli replay) -----------
    # The quality plane's fold: confidence/entropy/drift windows (already
    # summarized by the SLO section — mirrored here so the model's story
    # reads in one place), the drift snapshots' trajectory, what the
    # flight recorder kept and why, and the latest replay-canary verdict.
    # Every host's stream counts: each replica tracks its own mix.
    quality: dict = {}
    qwin = slo.get("windows") or {}
    for metric, out_key in (("confidence", "confidence"),
                            ("confidence_margin", "margin"),
                            ("prediction_entropy", "entropy"),
                            ("quality_drift_score", "drift_score")):
        row = qwin.get(metric)
        if row:
            quality[out_key] = row
    qd = [e for e in events if e["ev"] == "quality_drift"]
    if qd:
        scores = [e.get("score") for e in qd
                  if isinstance(e.get("score"), (int, float))]
        quality["drift"] = {
            "snapshots": len(qd),
            "last_score": qd[-1].get("score"),
            "max_score": round(max(scores), 6) if scores else None,
        }
    caps = [e for e in events if e["ev"] == "capture"]
    if caps:
        by_reason: dict[str, int] = {}
        for e in caps:
            r = str(e.get("reason", "?"))
            by_reason[r] = by_reason.get(r, 0) + 1
        quality["captures"] = {
            "count": len(caps),
            "by_reason": dict(sorted(by_reason.items())),
        }
    rv = [e for e in events if e["ev"] == "replay_verdict"]
    if rv:
        last_v = rv[-1]
        quality["replay"] = {
            "runs": len(rv),
            "agreement": last_v.get("agreement"),
            "n": last_v.get("n"),
            "ok": last_v.get("ok"),
        }
    if quality:
        rep["quality"] = quality

    # --- persistent-connection data plane (fleet.pool) ------------------------
    # Channel lifecycle events, merged across streams: opened vs reused
    # is the pooling payoff (reuse_ratio — the bench gate pins the fleet
    # flavor), retired-by-reason is the churn story (a spike of "broken"
    # is replica loss; "max_age"/"idle_overflow" is policy working as
    # designed). Surfaced top-level and mirrored into the serve/fleet
    # sections so the fold reads next to the traffic it carried.
    conn_ev = [e for e in events
               if e["ev"] in ("conn_open", "conn_reuse", "conn_retire")]
    connections = None
    if conn_ev:
        retired: dict[str, int] = {}
        for e in conn_ev:
            if e["ev"] == "conn_retire":
                reason = str(e.get("reason", "?"))
                retired[reason] = retired.get(reason, 0) + 1
        opened = sum(e["ev"] == "conn_open" for e in conn_ev)
        reused = sum(e["ev"] == "conn_reuse" for e in conn_ev)
        connections = {
            "opened": opened,
            "reused": reused,
            "reuse_ratio": round(reused / (opened + reused), 4)
            if (opened + reused) else None,
            "retired": dict(sorted(retired.items())),
        }
        rep["connections"] = connections
        if rep.get("serve") is not None:
            rep["serve"]["connections"] = connections

    # --- serving fleet (fleet/, ROADMAP Queue A.4) ---------------------------
    # Roster transitions + routing outcomes, merged across every stream
    # (the router owns stream 0; each replica writes its own). The
    # timeline is the mesh_reform-style roster history: who was lost
    # why, and when each respawn turned ready again.
    fl = [e for e in events
          if isinstance(e.get("ev"), str)
          and (e["ev"].startswith("fleet_")
               or e["ev"].startswith("rollout_") or e["ev"] == "swap")]
    if fl:
        starts = [e for e in fl if e["ev"] == "fleet_start"]
        stops = [e for e in fl if e["ev"] == "fleet_stop"]
        sheds: dict[str, int] = {}
        for e in fl:
            if e["ev"] == "fleet_shed":
                lane = str(e.get("lane", "?"))
                sheds[lane] = sheds.get(lane, 0) + 1
        verdicts: dict[str, int] = {}
        for e in fl:
            if e["ev"] == "fleet_scale":
                v = str(e.get("verdict", "?"))
                verdicts[v] = verdicts.get(v, 0) + 1
        # Actions actually TAKEN (fleet_autoscale), as opposed to the
        # advisory verdict changes counted above.
        autoscale: dict[str, int] = {}
        for e in fl:
            if e["ev"] == "fleet_autoscale":
                a = str(e.get("action", "?"))
                autoscale[a] = autoscale.get(a, 0) + 1
        fleet: dict = {
            "replicas": starts[-1].get("replicas") if starts else None,
            "ready_events": sum(
                e["ev"] == "fleet_replica_ready" for e in fl
            ),
            "losses": sum(
                e["ev"] == "fleet_replica_loss" for e in fl
            ),
            "spillovers": sum(e["ev"] == "fleet_spillover" for e in fl),
            "resubmits": sum(e["ev"] == "fleet_resubmit" for e in fl),
            "sheds": sheds,
            "scale_verdicts": verdicts,
            "timeline": [
                {"t": round(e["t"], 3), "event": e["ev"],
                 **{k: v for k, v in e.items()
                    if k not in ("t", "ev", "pid", "process_index")}}
                for e in fl
                if e["ev"] in ("fleet_start", "fleet_replica_ready",
                               "fleet_replica_loss", "fleet_scale",
                               "fleet_autoscale", "fleet_stop", "swap",
                               "rollout_start", "rollout_step",
                               "rollout_rollback", "rollout_done")
            ],
        }
        if autoscale:
            fleet["autoscale_actions"] = autoscale
        # The rollout arc, when one ran: the orchestrator's verdict plus
        # the per-replica swap attempts (the mixed-version window reads
        # off the timeline's model_version tags).
        swaps = [e for e in fl if e["ev"] == "swap"]
        dones = [e for e in fl if e["ev"] == "rollout_done"]
        rollbacks = [e for e in fl if e["ev"] == "rollout_rollback"]
        if swaps or dones or rollbacks:
            fleet["rollout"] = {
                "swaps_ok": sum(bool(e.get("ok")) for e in swaps),
                "swaps_refused": sum(not e.get("ok") for e in swaps),
                "rollbacks": len(rollbacks),
                "ok": bool(dones[-1].get("ok")) if dones else None,
                "version": dones[-1].get("version") if dones else None,
            }
        if stops:
            fleet["routed"] = stops[-1].get("routed")
            fleet["answered"] = stops[-1].get("answered")
            fleet["rejected"] = stops[-1].get("rejected")
            fleet["dropped"] = stops[-1].get("dropped")
        if connections is not None:
            fleet["connections"] = connections
        rep["fleet"] = fleet

    # --- request-level traces (obs.tracing) ----------------------------------
    ts_rate = ((manifest or {}).get("config") or {}).get("trace_sample")
    traces = _traces_section(
        events,
        trace_sample=ts_rate if isinstance(ts_rate, (int, float)) else 1.0,
    )
    if traces:
        rep["traces"] = traces

    # --- incident plane (obs.incidents) --------------------------------------
    # From the streams (open and close across every host);
    # build_report_dir adds the bundles on disk, which outlive a tail.
    inc_open = [e for e in events if e["ev"] == "incident_open"]
    inc_close = [e for e in events if e["ev"] == "incident_close"]
    if inc_open or inc_close:
        closed_ids = {e.get("id") for e in inc_close}
        by_rule: dict[str, int] = {}
        for e in inc_open:
            r = str(e.get("rule", "?"))
            by_rule[r] = by_rule.get(r, 0) + 1
        rep["incidents"] = {
            "opened": len(inc_open),
            "closed": len(inc_close),
            "by_rule": by_rule,
            "still_open": sorted(
                str(e.get("id")) for e in inc_open
                if e.get("id") not in closed_ids
            ),
            "durations_s": [e.get("duration_s") for e in inc_close
                            if e.get("duration_s") is not None],
        }

    # --- warnings / metrics -------------------------------------------------
    # Warnings aggregate across every host (a warning on host 3 must not
    # be invisible in the headline); metrics records would be N-fold
    # duplicates of the same global values, so the primary host speaks.
    warns = [e for e in events if e["ev"] == "warning"]
    if warns:
        by_name: dict[str, int] = {}
        for e in warns:
            by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"), 0) + 1
        rep["warnings"] = by_name
    metrics = [e for e in primary if e["ev"] == "metrics"]
    if metrics:
        last: dict[str, dict] = {}
        for e in metrics:
            last[e.get("kind", "?")] = {
                k: v for k, v in e.items() if k not in ("ev",)
            }
        rep["metrics"] = {"count": len(metrics), "last": last}
    return rep


def fleet_timeline_section(run_dir: str, window_s: float = 3600.0,
                           now: Optional[float] = None) -> Optional[dict]:
    """The fleet timeline from the time-series store alone: per target
    (each replica and the router) the scraped ``serving_ms{q=0.99}`` over
    the look-back window (samples, last, median, max, a sparkline). None
    without a store or a target."""
    # tsdb and dash import this module's _pct: import them at call time.
    from featurenet_tpu_torch.obs import tsdb as _tsdb
    from featurenet_tpu_torch.obs.dash import SPARK_SLOTS, _bucket, _spark

    if not os.path.isdir(_tsdb.store_dir(run_dir)):
        return None
    store = _tsdb.TimeSeriesStore.open(run_dir)
    targets: dict[str, dict] = {}
    series = store.series()
    if not series:
        return None
    if now is None:
        # A finished run's "now" is its store's last sample, so a report
        # read days later shows the hour the fleet served.
        now = max(
            (s[0] for m, lb in series
             for s in [store.latest(m, lb)] if s is not None),
            default=time.time(),
        )
    names = sorted({lb.get("replica") for _m, lb in series
                    if lb.get("replica") is not None})
    for target in names:
        samples = store.query("serving_ms",
                              {"q": "0.99", "replica": target},
                              since_s=window_s, now=now)
        if not samples:
            continue
        vals = sorted(v for _t, v in samples)
        targets[target] = {
            "samples": len(samples),
            "p99_ms_last": round(samples[-1][1], 3),
            "p99_ms_median": round(_pct(vals, 50), 3),
            "p99_ms_max": round(vals[-1], 3),
            "spark": _spark(_bucket(samples, now, window_s, SPARK_SLOTS)),
        }
    if not targets:
        return None
    fails = 0
    for metric, labels in series:
        if metric == "scrape_failures_total":
            last = store.latest(metric, labels)
            if last is not None:
                fails += int(last[1])
    return {
        "window_s": float(window_s),
        "t_end": round(now, 3),
        "targets": targets,
        "scrape_failures": fails,
    }


def build_report_dir(run_dir: str) -> dict:
    """``build_report`` of a run directory's streams and manifest, with the
    fleet timeline of its store and the inventory of its incident
    bundles."""
    events, bad = load_events(run_dir)
    rep = build_report(events, load_manifest(run_dir), bad_lines=bad)
    timeline = fleet_timeline_section(run_dir)
    if timeline is not None:
        rep["fleet_timeline"] = timeline
    # The bundles outlive the stream's tail and a dark sink.
    from featurenet_tpu_torch.obs import incidents as _incidents

    bundles = _incidents.list_incidents(run_dir)
    if bundles:
        rep.setdefault("incidents", {})["bundles"] = bundles
    return rep


def _fmt_s(v: float) -> str:
    return f"{v:.3f}s" if v < 100 else f"{v:.1f}s"


def _skew_parts(skew: dict) -> list:
    """Human fragments of the cross-host skew stats — ONE renderer shared
    by the report body and the live tail's header, so the two views can
    never drift on formulas or labels."""
    parts = []
    if skew.get("loop_start_skew_s") is not None:
        parts.append(f"loop-start skew {skew['loop_start_skew_s']}s")
    if skew.get("wall_s_skew") is not None:
        parts.append(f"wall skew {skew['wall_s_skew']}s")
    dwf = skew.get("data_wait_fraction")
    if dwf:
        parts.append(
            f"data-wait spread {dwf['spread'] * 100:.1f}pp "
            f"({dwf['min'] * 100:.1f}%–{dwf['max'] * 100:.1f}%)"
        )
    return parts


def _perf_headline(pf: dict) -> str:
    """The perf section's one-line MFU readout — ONE renderer shared by
    the report body and the live tail (``follow_perf_line``), so the two
    views can never drift. The unknown peak tier is EXPLICIT: a device
    kind with no peak-table entry reads ``mfu: unknown (<kind>)``, never
    a number."""
    if pf.get("tier") == "known":
        head = f"perf: device {pf.get('device_kind')}"
        if pf.get("peak_tflops"):
            head += f" (peak {pf['peak_tflops']} TF/s)"
        mfu = pf.get("mfu")
        if mfu:
            head += (f"; mfu p50 {mfu.get('p50')} p99 {mfu.get('p99')} "
                     f"(n={mfu.get('n')})")
        else:
            head += "; mfu: no samples"
        bw = pf.get("achieved_bw_fraction")
        if bw:
            head += f"; bw fraction p50 {bw.get('p50')}"
        return head
    kind = pf.get("device_kind")
    return f"perf: mfu: unknown ({kind or 'no device kind recorded'})"


def format_report(rep: dict) -> str:
    """Human-readable rendering (the CLI's default output; --json gives
    the raw dict)."""
    lines = []
    run = rep.get("run") or {}
    head = "run"
    if run.get("config_name"):
        head += f" [{run['config_name']}/{run.get('task')}]"
    if run.get("start_time"):
        head += f" started {run['start_time']}"
    if run.get("device_count") is not None:
        head += f", {run['device_count']} device(s)"
    lines.append(head)
    lines.append(
        f"events: {rep['n_events']}"
        + (f" ({rep['bad_lines']} unparseable)" if rep.get("bad_lines") else "")
        + f", process starts: {rep.get('process_starts', 0)}"
    )
    loop = rep.get("loop", {})
    if loop.get("wall_s"):
        trunc = loop.get("truncated_windows", 0)
        lines.append(
            f"loop: {loop['steps']} step(s) over {loop['windows']} "
            f"window(s), wall {_fmt_s(loop['wall_s'])}"
            + (f", {loop['step_ms']} ms/step" if loop.get("step_ms") else "")
            + (f" ({trunc} window(s) truncated by a kill)" if trunc else "")
        )
    bd = rep.get("breakdown")
    if bd:
        lines.append("step-time breakdown (fractions of loop wall):")
        for name in (*LOOP_CATEGORIES, "other"):
            row = bd[name]
            lines.append(
                f"  {name:<11} {row['seconds']:>9.3f}s  "
                f"{row['fraction'] * 100:5.1f}%"
            )
        lines.append(
            f"  attributed (non-other): "
            f"{rep['attributed_fraction'] * 100:.1f}%"
        )
    hosts = rep.get("hosts")
    if hosts:
        lines.append(f"hosts: {len(hosts)} event stream(s)")
        lines.append(
            "  host   wall        steps  data_wait  beats  max_gap  warn"
        )
        for i in sorted(hosts):
            h = hosts[i]
            fr = h.get("fractions") or {}
            dw = fr.get("data_wait")
            hb = h.get("heartbeat") or {}
            gap = hb.get("max_gap_s")
            lines.append(
                f"  {i:<5}  {_fmt_s(h['wall_s']):>9}  {h['steps']:>5}  "
                + (f"{dw * 100:8.1f}%" if dw is not None else f"{'—':>9}")
                + f"  {hb.get('beats', 0):>5}  "
                + (f"{gap:>6.1f}s" if gap is not None else f"{'—':>7}")
                + f"  {h.get('warnings', 0):>4}"
            )
        if any(hosts[i].get("windows") for i in hosts):
            lines.append("  host windows (latest p50/p99):")
            for i in sorted(hosts):
                wins = hosts[i].get("windows")
                if not wins:
                    continue
                lines.append(
                    f"    {i}: " + ", ".join(
                        f"{m} {wins[m].get('p50')}/{wins[m].get('p99')}"
                        for m in sorted(wins)
                    )
                )
        skew = rep.get("host_skew") or {}
        parts = _skew_parts(skew)
        if parts:
            lines.append("host skew: " + ", ".join(parts))
        if skew.get("step_mismatch"):
            lines.append(
                "  STEP MISMATCH across hosts (truncated stream or "
                f"diverged host): {skew['step_mismatch']}"
            )
    slo = rep.get("slo") or {}
    sw = slo.get("windows")
    if sw:
        lines.append("SLO windows (latest):")
        for metric in sorted(sw):
            row = sw[metric]
            lines.append(
                f"  {metric:<16} n={row.get('n', 0):<4} "
                f"p50 {row.get('p50')}  p95 {row.get('p95')}  "
                f"p99 {row.get('p99')}  max {row.get('max')}"
            )
    sa = slo.get("alerts")
    if sa:
        lines.append("alerts:")
        for rule in sorted(sa):
            a = sa[rule]
            lines.append(
                f"  {'ACTIVE' if a.get('active') else 'fired '} "
                f"{rule:<22} ×{a['count']}"
                + (f" (resolved ×{a['resolves']})" if a.get("resolves")
                   else "")
                + f"  last {a.get('last_value')} "
                f"vs {a.get('threshold')} ({a.get('severity')})"
            )
    rt = rep.get("runtime")
    if rt:
        lines.append(
            f"runtime: {rt['compiles']} compile(s) "
            f"({rt['compile_s']}s), cache {rt['cache_hits']} hit(s) / "
            f"{rt['cache_misses']} miss(es) / {rt['cache_rejects']} "
            f"reject(s)"
        )
        for r in rt["rejects"]:
            lines.append(
                f"  REJECT {r.get('program')}: {r.get('reason')}"
            )
    pf = rep.get("perf")
    if pf:
        lines.append(_perf_headline(pf))
        progs = pf.get("programs") or {}
        if progs:
            lines.append(
                "  program                 precision      gflops    acc MB"
                "   peak MB  roofline       compile"
            )

            def cell(v, scale, fmt):
                return format(v / scale, fmt) if v is not None else "—"

            for name in sorted(progs):
                row = progs[name]
                lines.append(
                    f"  {name:<22}  "
                    f"{row.get('precision') or '—':<11}  "
                    f"{cell(row.get('flops'), 1e9, '8.2f'):>8}  "
                    f"{cell(row.get('bytes'), 1e6, '8.1f'):>8}  "
                    f"{cell(row.get('peak_bytes'), 1e6, '8.1f'):>8}"
                    f"  {row.get('roofline') or '—':<13}"
                    + (f"  {row['compile_s']}s" if row.get("compile_s")
                       is not None else "  —")
                )
        dm = pf.get("device_memory")
        if dm:
            lines.append(
                "  device memory watermark: " + ", ".join(
                    f"host/dev {k}: {v['watermark_bytes'] / 1e6:.1f} MB"
                    + (f" of {v['bytes_limit'] / 1e6:.0f} MB"
                       if v.get("bytes_limit") else "")
                    for k, v in dm.items()
                )
            )
    q = rep.get("prefetch_queue_depth")
    if q:
        lines.append(
            f"prefetch queue depth: p10 {q['p10']} p50 {q['p50']} "
            f"p90 {q['p90']} max {q['max']} (n={q['n']})"
        )
    g = rep.get("producer_batch_s")
    if g:
        lines.append(
            f"producer batch gen: mean {g['mean'] * 1e3:.1f} ms "
            f"p90 {g['p90'] * 1e3:.1f} ms (n={g['n']})"
        )
    hb = rep.get("heartbeat")
    if hb:
        age = hb.get("max_age_s")
        lines.append(
            f"heartbeat: {hb['beats']} beat(s)"
            + (f", max age {age}s" if age is not None else "")
        )
    sup = rep.get("supervisor")
    if sup:
        lines.append(
            f"supervisor: {sup['stalls']} stall(s), {sup['restarts']} "
            f"restart(s), {sup['planned_restarts']} planned"
        )
        for e in sup["timeline"]:
            detail = {k: v for k, v in e.items() if k not in ("t", "phase")}
            lines.append(f"  t={e['t']:.3f} {e['phase']} {detail or ''}")
    rc = rep.get("recovery")
    if rc:
        lines.append(
            f"recovery: {rc['preempts']} preemption(s), "
            f"{rc['checkpoint_fallbacks']} checkpoint fallback(s)"
            + (f", {rc['mesh_reforms']} mesh re-form(s)"
               if rc.get("mesh_reforms") else "")
        )
        for e in rc["timeline"]:
            detail = {k: v for k, v in e.items() if k not in ("t", "event")}
            lines.append(f"  t={e['t']:.3f} {e['event']} {detail or ''}")
    sv = rep.get("serving_latency_ms")
    if sv:
        lines.append(
            f"serving latency: {sv['batches']} batch(es), {sv['rows']} "
            f"row(s); mean {sv['mean']} ms p50 {sv['p50']} ms "
            f"p90 {sv['p90']} ms p99 {sv['p99']} ms max {sv['max']} ms"
        )
    se = rep.get("serve")
    if se:
        occ = se.get("occupancy")
        lines.append(
            f"serve: {se['batches']} batch(es), {se['rows']} request(s)"
            + (f", occupancy {occ * 100:.1f}%" if occ is not None else "")
            + (f", overloads {se['overloads']}" if se.get("overloads")
               else "")
            + (f"; drained served={se['served']} rejected={se['rejected']}"
               if se.get("served") is not None else "")
        )
        if se.get("by_bucket"):
            lines.append(
                "  by bucket: " + ", ".join(
                    f"{k}×{v}" for k, v in se["by_bucket"].items()
                )
            )
    qa = rep.get("quality")
    if qa:
        conf = qa.get("confidence")
        dw = qa.get("drift_score")
        head = "quality:"
        if conf:
            head += (f" confidence p50 {conf.get('p50')} "
                     f"p99 {conf.get('p99')} (n={conf.get('n')})")
        if qa.get("entropy"):
            head += f", entropy p50 {qa['entropy'].get('p50')}"
        if dw:
            head += f", drift p50 {dw.get('p50')} max {dw.get('max')}"
        lines.append(head)
        dr = qa.get("drift")
        if dr:
            lines.append(
                f"  drift: {dr['snapshots']} snapshot(s), "
                f"last {dr.get('last_score')}, max {dr.get('max_score')}"
            )
        cp = qa.get("captures")
        if cp:
            lines.append(
                f"  captures: {cp['count']}"
                + (" (" + ", ".join(
                    f"{k}×{v}" for k, v in cp["by_reason"].items()
                   ) + ")" if cp.get("by_reason") else "")
            )
        rp = qa.get("replay")
        if rp:
            lines.append(
                f"  replay: {rp['runs']} run(s), last agreement "
                f"{rp.get('agreement')} over {rp.get('n')} request(s) "
                f"({'ok' if rp.get('ok') else 'BELOW GATE'})"
            )
    fl = rep.get("fleet")
    if fl:
        lines.append(
            f"fleet: {fl.get('replicas')} replica(s); "
            f"{fl['losses']} loss(es), {fl['ready_events']} ready "
            f"event(s), {fl['spillovers']} spillover(s), "
            f"{fl['resubmits']} re-submit(s)"
            + (", sheds " + ", ".join(
                f"{k}×{v}" for k, v in fl["sheds"].items()
               ) if fl.get("sheds") else "")
            + (f"; drained routed={fl['routed']} "
               f"answered={fl.get('answered')} "
               f"rejected={fl.get('rejected')} dropped={fl['dropped']}"
               if fl.get("routed") is not None else "")
        )
        if fl.get("scale_verdicts"):
            lines.append(
                "  scale verdicts: " + ", ".join(
                    f"{k}×{v}" for k, v in sorted(
                        fl["scale_verdicts"].items()
                    )
                ) + " (advisory)"
            )
        for e in fl.get("timeline", ()):
            detail = {k: v for k, v in e.items()
                      if k not in ("t", "event")}
            lines.append(f"  t={e['t']:.3f} {e['event']} {detail or ''}")
    ft = rep.get("fleet_timeline")
    if ft:
        lines.append(
            f"fleet timeline (tsdb, last {ft['window_s']:g}s): "
            f"{len(ft['targets'])} target(s), "
            f"{ft['scrape_failures']} scrape failure(s)"
        )
        for target, row in sorted(ft["targets"].items()):
            lines.append(
                f"  {target:<8} p99 {row['spark']} "
                f"last {row['p99_ms_last']} ms · "
                f"median {row['p99_ms_median']} ms · "
                f"max {row['p99_ms_max']} ms "
                f"({row['samples']} sample(s))"
            )
    cn = rep.get("connections")
    if cn:
        ratio = cn.get("reuse_ratio")
        lines.append(
            f"connections: {cn['opened']} opened, "
            f"{cn['reused']} reused"
            + (f" (reuse {ratio * 100:.1f}%)"
               if ratio is not None else "")
            + (", retired " + ", ".join(
                f"{k}×{v}" for k, v in cn["retired"].items()
               ) if cn.get("retired") else "")
        )
    tr = rep.get("traces")
    if tr:
        lines.append(
            f"traces: {tr['sampled']} sampled request(s) "
            f"({tr['forced']} forced: rejects/errors/SLO breaches)"
            + (f", {tr['rejected']} reject(s)" if tr.get("rejected")
               else "")
            + (f"; server p50/p99 {tr.get('server_p50_ms')}/"
               f"{tr.get('server_p99_ms')} ms"
               + (" (tail-biased sample — rate "
                  f"{tr['sample_rate']}, overstates the true tail)"
                  if tr.get("sample_biased") else "")
               if tr.get("server_p99_ms") is not None else "")
        )
        cl = tr.get("client")
        if cl:
            lines.append(
                f"  client (loadgen): p50 {cl.get('client_p50_ms')} ms "
                f"p99 {cl.get('client_p99_ms')} ms"
                + (f", p99 skew over server {cl['skew_p99_ms']} ms"
                   if cl.get("skew_p99_ms") is not None else "")
            )
        if tr.get("slowest"):
            lines.append(
                "  slowest    trace             total     queue  "
                "dispatch  batch  bucket  outcome"
            )
            for row in tr["slowest"]:
                lines.append(
                    f"    {str(row.get('trace')):<16}  "
                    f"{row.get('total_ms') or 0:>8.3f}  "
                    f"{row.get('queue_wait_ms') or 0:>8.3f}  "
                    f"{row.get('dispatch_ms') or 0:>8.3f}  "
                    f"{str(row.get('batch_seq') or '—'):>5}  "
                    f"{str(row.get('bucket') or '—'):>6}  "
                    f"{row.get('outcome')}"
                )
    inc = rep.get("incidents")
    if inc:
        head = (f"incidents: {inc.get('opened', 0)} opened, "
                f"{inc.get('closed', 0)} closed")
        if inc.get("by_rule"):
            head += " (" + ", ".join(
                f"{k}×{v}" for k, v in sorted(inc["by_rule"].items())
            ) + ")"
        if inc.get("still_open"):
            head += "; STILL OPEN: " + ", ".join(inc["still_open"])
        lines.append(head)
        for b in inc.get("bundles", ()):
            lines.append(
                f"  {b['id']}  rule={b.get('rule', '?')} "
                f"state={b.get('state', '?')}"
                + (f" duration={b['duration_s']}s"
                   if b.get("duration_s") is not None else "")
            )
    w = rep.get("warnings")
    if w:
        lines.append(
            "warnings: " + ", ".join(f"{k}×{v}" for k, v in sorted(w.items()))
        )
    m = rep.get("metrics")
    if m:
        lines.append(f"metrics records: {m['count']}")
        for kind in sorted(m["last"]):
            rec = m["last"][kind]
            keep = {
                k: rec[k]
                for k in ("step", "loss", "accuracy", "samples_per_sec")
                if k in rec
            }
            lines.append(f"  last {kind}: {json.dumps(keep)}")
    return "\n".join(lines)


# --- live tail ---------------------------------------------------------------

class EventTail:
    """Incremental reader over a run directory's event stream(s).

    Each ``poll()`` re-discovers the per-host files (a late host's stream
    appears mid-run), seeks every known file to its last consumed offset,
    and parses only the new COMPLETE lines — a partial trailing line (a
    writer mid-``write`` on a non-POSIX filesystem, or a reader racing the
    kernel) is left for the next poll rather than counted as corrupt.
    Nothing is ever re-parsed: the PARSING cost of a poll is only the
    bytes appended since the last one. (Each re-render still folds the
    full accumulated history — build_report is O(events) — which is fine
    for the runs this repo produces; a multi-day tail would want a
    windowed report.)
    """

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self.events: list[dict] = []
        self.bad = 0
        self._offsets: dict[str, int] = {}

    def poll(self) -> list[dict]:
        """Consume and return the newly appended events (also accumulated
        into ``self.events``, unsorted — sort before reporting)."""
        new: list[dict] = []
        for path, idx in discover_event_files(self.run_dir):
            offset = self._offsets.get(path, 0)
            try:
                size = os.path.getsize(path)
                if size <= offset:
                    continue
                with open(path, "rb") as fh:
                    fh.seek(offset)
                    chunk = fh.read(size - offset)
            except OSError:
                continue  # rotated/removed underneath us: re-poll later
            last_nl = chunk.rfind(b"\n")
            if last_nl < 0:
                continue  # no complete line yet
            self._offsets[path] = offset + last_nl + 1
            lines = chunk[:last_nl].decode("utf-8", "replace").splitlines()
            self.bad += _parse_lines(lines, idx, new)
        self.events.extend(new)
        return new


def is_terminal_event(e: dict) -> bool:
    """True when this event can mean the run is over: a ``run_end`` (one
    host completed its full step budget) or the supervisor's final verdict
    (``done`` / ``giving_up`` — restart budget exhausted). A supervisor
    verdict ends the whole run; a ``run_end`` ends only its own host's
    stream — ``follow_report`` waits for one per discovered stream, so a
    fast host finishing first doesn't declare a still-running mesh done."""
    return e.get("ev") == "run_end" or (
        e.get("ev") == "supervisor"
        and e.get("phase") in ("done", "giving_up")
    )


def follow_header(rep: dict, run_dir: str) -> str:
    """The live tail's one-line banner: where the mesh stands *right now* —
    host count, per-host loop-start skew, and the cross-host data-wait
    spread (a fat spread on a lockstep mesh is free throughput, worth
    noticing while the run is still hot, not in the post-mortem). Falls
    back to a single-host marker when only one stream exists."""
    parts = [f"following {run_dir}"]
    hosts = rep.get("hosts")
    if hosts:
        parts.append(f"{len(hosts)} hosts")
        parts.extend(_skew_parts(rep.get("host_skew") or {}))
    else:
        parts.append("single host")
    return "== " + " | ".join(parts)


def follow_slo_line(rep: dict) -> Optional[str]:
    """The live tail's second line: the latest window percentiles and the
    rules firing *right now* — degradation visible while it happens, not
    in the post-mortem. None when the run carries no SLO telemetry."""
    slo = rep.get("slo") or {}
    parts = []
    windows = slo.get("windows") or {}
    for metric in ("step_ms", "data_wait_ms", "queue_depth",
                   "heartbeat_age_s", "serving_ms", "queue_wait_ms"):
        row = windows.get(metric)
        if row:
            parts.append(
                f"{metric} p50 {row.get('p50')}/p99 {row.get('p99')}"
            )
    active = sorted(
        rule for rule, a in (slo.get("alerts") or {}).items()
        if a.get("active")
    )
    if active:
        parts.append("ALERTS: " + ", ".join(active))
    if not parts:
        return None
    return "== slo | " + " | ".join(parts)


def follow_perf_line(rep: dict) -> Optional[str]:
    """The live tail's perf readout next to the SLO line: the current
    rolling MFU (or its explicit unknown tier) and the device-memory
    watermark. None when the run carries no perf telemetry."""
    pf = rep.get("perf")
    if not pf:
        return None
    parts = [_perf_headline(pf)[len("perf: "):]]
    dm = pf.get("device_memory")
    if dm:
        top = max(v["watermark_bytes"] for v in dm.values())
        parts.append(f"device-memory watermark {top / 1e6:.1f} MB")
    return "== perf | " + " | ".join(parts)


def follow_report(
    run_dir: str,
    interval: float = 3.0,
    out: Callable[[str], None] = print,
    clock: Callable[[float], None] = time.sleep,
    max_polls: Optional[int] = None,
    clear: bool = True,
) -> None:
    """Live tail: re-render the report every ``interval`` seconds while the
    run is hot; return when a terminal event appears (``is_terminal_event``)
    or after ``max_polls`` polls (tests). Ctrl-C is the caller's concern —
    the CLI wraps this in a KeyboardInterrupt handler so ^C exits cleanly
    rather than with a stack trace."""
    tail = EventTail(run_dir)
    manifest = None
    polls = 0
    ended_hosts: set[int] = set()
    supervisor_verdict = False
    while True:
        new = tail.poll()
        if manifest is None:
            manifest = load_manifest(run_dir)
        if new or polls == 0:
            events = sorted(tail.events, key=lambda e: e["t"])
            rep = build_report(events, manifest, bad_lines=tail.bad)
            prefix = "\x1b[2J\x1b[H" if clear else ""
            slo_line = follow_slo_line(rep)
            perf_line = follow_perf_line(rep)
            out(
                prefix + follow_header(rep, run_dir) + "\n"
                + (slo_line + "\n" if slo_line else "")
                + (perf_line + "\n" if perf_line else "")
                + format_report(rep)
                + f"\n-- following {run_dir} ({len(events)} events, "
                f"re-render every {interval:g}s; Ctrl-C to stop)"
            )
        for e in new:
            if e.get("ev") == "run_end":
                ended_hosts.add(int(e.get("process_index") or 0))
            elif is_terminal_event(e):
                supervisor_verdict = True
        # The supervisor's verdict ends everything; run_end is per host —
        # exit only once every discovered stream has produced one, so the
        # slowest host's tail (and the final checkpoint it is writing)
        # still renders.
        streams = {idx for _, idx in discover_event_files(run_dir)}
        if supervisor_verdict or (streams and ended_hosts >= streams):
            out("-- run ended; follow exiting")
            return
        polls += 1
        if max_polls is not None and polls >= max_polls:
            return
        clock(interval)


# --- event-schema lint -------------------------------------------------------

KNOWN_EVENT_KINDS = frozenset({
    "run_start", "run_end", "span", "gauge", "metrics", "warning",
    "heartbeat", "supervisor", "loop_start", "loop_end",
    # Recovery events (the fault-tolerance layer): a SIGTERM drain that
    # checkpointed and exited for a planned respawn, and a restore that
    # fell back past a corrupt latest checkpoint.
    "preempt", "checkpoint_fallback",
    # Live-SLO events (obs.windows / obs.alerts): a rolling-window
    # percentile snapshot, and an alert rule crossing into violation
    # (state="fire") or recovering (state="resolve") — hysteresis pairs,
    # never per-cycle re-fires.
    "window_summary", "alert",
    # Runtime-registry events (runtime/registry.py): a program's build
    # (a CUDA graph capture in the port), and the reference's persistent
    # executable cache's verdicts —
    # hit (deserialized, compile skipped), miss (no entry), reject (entry
    # present but corrupt/stale/probe-refused; degraded to fresh compile).
    "program_compile", "cache_hit", "cache_miss", "cache_reject",
    # Performance attribution (obs.perf): a built program's compiled
    # cost/memory counters (every field beyond `program` is capture-path-
    # optional — a backend without cost analysis emits an honestly
    # partial record), and one device's memory_stats() sample from the
    # opt-in heartbeat-cadence poller.
    "program_cost", "device_memory",
    # Serving front end (serve/): service came up with its
    # bucket ladder, one dispatched batch (bucket/fill/padding), one
    # admission fast-reject at the queue bound, and the drain record.
    "serve_start", "serve_batch", "overload", "serve_stop",
    # Elastic membership (the reference's elastic/, ROADMAP Queue A.4): the coordinator
    # re-formed the mesh at a new world size (shrink on host loss, grow
    # on re-admission), and the per-slot transitions — a host charged as
    # lost, a recovered host re-admitted at a generation boundary.
    "mesh_reform", "host_leave", "host_join",
    # Request-level tracing (obs.tracing): the per-request serving
    # timeline — admitted into the queue, dispatched on a batch
    # (batch_seq ties it to its serve_dispatch span), completed with the
    # queue/device split, or fast-rejected at the admission bound.
    # Tail-biased sampled: rejections, errors, and SLO breaches are
    # always present; healthy traffic at the Config.trace_sample rate.
    "request_admit", "request_dispatch", "request_done", "request_reject",
    # The open-loop load generator's client-side summary: what the
    # CALLER observed (client p50/p99 vs the server's serving_ms windows
    # — the skew between them is real queueing, measured on one clock).
    "loadgen",
    # Serving fleet (fleet/, ROADMAP Queue A.4): the router came up over N
    # replicas; a replica turned ready (first warmup or a respawn
    # rejoining the roster) / was charged lost (death, stall, startup
    # timeout); one overloaded replica's request spilled to the next
    # healthy one; one in-flight request was re-submitted to a survivor
    # after its replica died under it; a batch-lane request was shed at
    # the router; an advisory scaling verdict changed; the router's
    # drain record (routed / answered / rejected / dropped — dropped is
    # the gate-pinned zero).
    "fleet_start", "fleet_replica_ready", "fleet_replica_loss",
    "fleet_spillover", "fleet_resubmit", "fleet_shed", "fleet_scale",
    "fleet_stop",
    # The acting control loop (fleet.replica.Autoscaler): the roster
    # actually moved — an add or shed taken on a SUSTAINED verdict after
    # hysteresis + cooldown damping (fleet_scale above stays the
    # advisory verdict-change record).
    "fleet_autoscale",
    # Zero-downtime weight rollout: one replica's live hot-swap attempt
    # (ok either way — a refused swap is an event too), and the
    # orchestrator's arc — rollout began over N replicas, one replica
    # finished its canary+swap step, already-swapped replicas were
    # rolled back (canary failure / replica death mid-rollout), rollout
    # finished with its converged version.
    "swap", "rollout_start", "rollout_step", "rollout_rollback",
    "rollout_done",
    # Persistent-connection data plane (fleet.pool): a fresh channel
    # opened (carrying its connect_ms — the handshake cost pooling
    # amortizes), an idle keep-alive channel reused, and a channel
    # retired with its reason (broken / max_age / idle_overflow /
    # server_close / probe_failure / replica_loss / shutdown).
    "conn_open", "conn_reuse", "conn_retire",
    # Model-quality plane (obs.quality / serve.recorder / cli replay):
    # a rolling prediction-mix drift snapshot (TV score of the live
    # predicted-class histogram vs the pinned baseline), one request
    # captured into the flight-recorder ring (with the reason it was
    # kept — sampled, or forced: low_confidence / rejected /
    # slo_breach), and a replay canary's verdict (agreement of a
    # candidate against a recorded capture ring).
    "quality_drift", "capture", "replay_verdict",
    # Incident plane (obs.incidents): an alert firing opened a
    # diagnostic bundle (at most one per rule, flap-damped by a
    # post-close cooldown), its capture landed on disk (tsdb slice /
    # windows / roster / events tail / folded host stacks), and the
    # paired resolve closed it with its duration.
    "incident_open", "incident_capture", "incident_close",
})

# Fields (beyond t/ev) a record must carry for the report to fold it.
REQUIRED_EVENT_FIELDS = {
    "span": ("name", "dur_s"),
    "gauge": ("name", "value"),
    "warning": ("name", "msg"),
    "supervisor": ("phase",),
    "loop_start": ("step",),
    "loop_end": ("step",),
    "metrics": ("kind",),
    "preempt": ("step",),
    "checkpoint_fallback": ("from_step", "to_step"),
    "window_summary": ("metric", "n", "p50", "p95", "p99"),
    "alert": ("rule", "severity", "value", "threshold", "window", "state"),
    "program_compile": ("program", "dur_s"),
    # program_cost: only the program name is required — flops/bytes/
    # peak_bytes are honest-absence fields (a backend may answer none of
    # them), so the schema must not condemn a degraded capture.
    "program_cost": ("program",),
    "device_memory": ("device", "bytes_in_use"),
    "cache_hit": ("program",),
    "cache_miss": ("program",),
    "cache_reject": ("program", "reason"),
    "serve_start": ("buckets", "max_wait_ms", "queue_limit"),
    "serve_batch": ("bucket", "n", "batch_seq"),
    "overload": ("queue_depth", "limit"),
    "serve_stop": ("served", "rejected"),
    "mesh_reform": ("generation", "from_n", "to_n", "reason"),
    "host_leave": ("host", "generation", "reason"),
    "host_join": ("host", "generation"),
    "request_admit": ("trace",),
    "request_dispatch": ("trace", "batch_seq", "bucket", "pad"),
    "request_done": ("trace", "queue_wait_ms", "dispatch_ms", "total_ms",
                     "outcome"),
    "request_reject": ("trace", "queue_depth", "limit"),
    "loadgen": ("n", "client_p50_ms", "client_p99_ms"),
    "fleet_start": ("replicas",),
    "fleet_replica_ready": ("replica",),
    "fleet_replica_loss": ("replica", "reason"),
    "fleet_spillover": ("trace", "from_replica"),
    "fleet_resubmit": ("trace", "from_replica"),
    "fleet_shed": ("lane",),
    "fleet_scale": ("verdict",),
    "fleet_autoscale": ("action", "from_n", "to_n", "reason"),
    "fleet_stop": ("routed", "dropped"),
    "swap": ("ok", "from_version", "swap_ms"),
    "rollout_start": ("checkpoint_dir", "replicas"),
    "rollout_step": ("replica", "ok"),
    "rollout_rollback": ("reason", "rolled_back"),
    "rollout_done": ("ok", "swapped"),
    "conn_open": ("endpoint",),
    "conn_reuse": ("endpoint",),
    "conn_retire": ("endpoint", "reason"),
    "quality_drift": ("score", "n"),
    "capture": ("trace", "reason"),
    "replay_verdict": ("agreement", "n", "ok"),
    "incident_open": ("id", "rule", "severity", "value"),
    "incident_capture": ("id", "files"),
    "incident_close": ("id", "rule", "duration_s"),
}

# The event kinds that carry a per-request ``trace`` id — the timeline
# view (``cli report --request``) and the traces section key off this.
REQUEST_EVENT_KINDS = ("request_admit", "request_dispatch",
                       "request_done", "request_reject")

# Required at EMIT sites (the analysis linter holds new code to the full
# tuples above) but tolerated as absent by ``validate_events``: archived
# run dirs predate the field and must keep validating, mirroring the
# legacy fallbacks the report sections already implement.
LEGACY_OPTIONAL_FIELDS = {
    "alert": ("state",),  # pre-hysteresis streams re-fired with no state
    # pre-tracing serve streams carried no dispatch sequence number
    "serve_batch": ("batch_seq",),
}

# Wall-clock start stamps vs perf_counter durations: a parent records its
# start before the child does and emits after, so real nesting violates
# containment only by clock jitter — allow a small slack.
_NEST_EPS_S = 0.05


def validate_events(events: list[dict], bad_lines: int = 0) -> list[dict]:
    """Schema lint: unknown event kinds, missing required fields, negative
    durations, and non-monotonic span nesting (a span naming a ``parent``
    must fit inside some same-thread span of that name — a child interval
    escaping its parent means a torn/reordered stream or a broken clock).
    Returns finding dicts (``check`` / ``msg`` / optional ``event``);
    empty = clean. Malformed telemetry should fail fast in CI, not
    corrupt reports quietly."""
    findings: list[dict] = []
    if bad_lines:
        findings.append({
            "check": "parse",
            "msg": f"{bad_lines} unparseable line(s) in the stream(s)",
        })
    spans_by_thread: dict[tuple, list[dict]] = {}
    for e in events:
        ev = e.get("ev")
        if ev not in KNOWN_EVENT_KINDS:
            findings.append({
                "check": "unknown_kind",
                "msg": f"unknown event kind {ev!r}",
                "event": e,
            })
            continue
        legacy_ok = LEGACY_OPTIONAL_FIELDS.get(ev, ())
        missing = [
            f for f in REQUIRED_EVENT_FIELDS.get(ev, ())
            if f not in e and f not in legacy_ok
        ]
        if missing:
            findings.append({
                "check": "missing_fields",
                "msg": f"{ev!r} event missing required field(s) "
                       f"{missing}",
                "event": e,
            })
            continue
        if ev == "span":
            if e["dur_s"] < 0:
                findings.append({
                    "check": "negative_duration",
                    "msg": f"span {e.get('name')!r} has dur_s {e['dur_s']}",
                    "event": e,
                })
                continue
            key = (e.get("process_index", 0), e.get("pid"), e.get("thread"))
            spans_by_thread.setdefault(key, []).append(e)
    for group in spans_by_thread.values():
        for s in group:
            parent = s.get("parent")
            if not parent:
                continue
            candidates = [q for q in group if q.get("name") == parent]
            if not candidates:
                findings.append({
                    "check": "orphan_parent",
                    "msg": f"span {s.get('name')!r} names parent "
                           f"{parent!r} but no such span exists on its "
                           "thread",
                    "event": s,
                })
            elif not any(
                q["t"] - _NEST_EPS_S <= s["t"]
                and s["t"] + s["dur_s"] <= q["t"] + q["dur_s"] + _NEST_EPS_S
                for q in candidates
            ):
                findings.append({
                    "check": "span_nesting",
                    "msg": f"span {s.get('name')!r} "
                           f"[t={s['t']:.3f}, dur={s['dur_s']:.3f}] is not "
                           f"contained in any {parent!r} span on its "
                           "thread (non-monotonic nesting)",
                    "event": s,
                })
    return findings
