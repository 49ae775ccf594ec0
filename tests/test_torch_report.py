"""The port's run directory against the JAX package's, on the CPU, at
smoke16 width on one torch thread.

- ``span``: the same sequence of calls in both packages writes the same
  span events (names, parents, fields, per-thread nesting), the shared
  ``_NULL`` when no run is active, and feeds the same windows.
- The report path on the same event streams and manifests: ``load_events``,
  ``build_report``, ``format_report``, ``validate_events``,
  ``chrome_trace``, ``request_timeline`` and the gates give what the JAX
  package's give. The stated differences: the manifest's topology sits
  under ``"torch"`` in the port's ``run.json`` (``"jax"`` in the
  reference's). The incident and fleet-timeline sections are compared
  here too, and in ``test_torch_incidents.py`` and ``test_torch_tsdb.py``
  against bundles and stores; the perf section and its gate keys in
  ``test_torch_perf.py``.
- A CPU ``Trainer`` with a ``run_dir`` writes the reference Trainer's
  event kinds and loop spans; its report has the loop fields and no
  validation finding. The trace window starts at a resumed run's first
  step and survives an exception.
- The supervisor's ``run_dir`` half against the JAX supervisor on the same
  scripted fake children (the telemetry verdict, the segment gate pinning
  then judging, a dark sink's torn last line); ``sink_enospc`` in both
  sinks and in a Trainer that finishes dark.
- ``cli report`` in a process where torch cannot be imported, and ``cli
  report --validate`` finding nothing in the run directory of every
  command that writes one.
- ``tb_dir`` is tested in ``test_torch_tb.py``, apart: its writers
  import TensorFlow.

Comparisons are exact unless a field is a clock reading.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from featurenet_tpu import faults as jax_faults
from featurenet_tpu import obs as jax_obs
from featurenet_tpu.obs import events as jax_events
from featurenet_tpu.obs import gates as jax_gates
from featurenet_tpu.obs import report as jax_report
from featurenet_tpu.obs import spans as jax_spans
from featurenet_tpu.obs import windows as jax_windows
from featurenet_tpu.train import supervisor as jax_supervisor
from featurenet_tpu_torch import cli, faults, obs
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.obs import events, gates, report, spans, windows
from featurenet_tpu_torch.train import supervisor
from featurenet_tpu_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "featurenet_tpu_torch")


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for mod in (obs, jax_obs):
        mod.close_run()
    faults.uninstall()
    jax_faults.uninstall()
    yield
    for mod in (obs, jax_obs):
        mod.close_run()
    faults.uninstall()
    jax_faults.uninstall()
    torch.set_num_threads(threads)


def _lines(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


# --- spans -------------------------------------------------------------------

def _span_calls(pkg_obs, pkg_spans, pkg_windows, run_dir):
    """One scripted sequence of spans; returns the events normalized (clock
    readings dropped, threads numbered by first appearance) and the window
    snapshot's sample counts."""
    assert pkg_spans.span("eval") is pkg_spans._NULL  # dark: the shared no-op
    pkg_obs.init_run(run_dir, process_index=0)
    pkg_windows.install(pkg_windows.WindowAggregator())
    with pkg_spans.span("eval", step=3):
        with pkg_spans.span("checkpoint", step=3):
            with pkg_spans.span("checkpoint_save", step=3):
                pass
        with pkg_spans.span("readback", src="metrics", step=3):
            pass

    def worker():
        with pkg_spans.span("data_wait", take=4):
            with pkg_spans.span("voxelize", tris=12):
                pass

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    for n in (1, 3):
        with pkg_spans.span("infer_batch", n=n, batch=4):
            pass
    with pytest.raises(ValueError):
        with pkg_spans.span("dispatch", take=1, mode="hbm"):
            raise ValueError("the span still closes")
    with pkg_spans.span("data_wait", take=1):
        pass
    counts = {m: s["n"] for m, s in pkg_windows.snapshot().items()}
    pkg_obs.close_run()
    threads: dict = {}
    out = []
    for e in _lines(os.path.join(run_dir, "events.jsonl")):
        e.pop("t")
        e.pop("pid")
        if e["ev"] == "span":
            assert e.pop("dur_s") >= 0
            e["thread"] = threads.setdefault(e["thread"], len(threads))
        if e["ev"] == "window_summary":
            e = {"ev": e["ev"], "metric": e["metric"], "n": e["n"]}
        out.append(e)
    return out, counts


def test_span_nesting_parents_and_windows_match_jax(tmp_path):
    port = _span_calls(obs, spans, windows, str(tmp_path / "port"))
    ref = _span_calls(jax_obs, jax_spans, jax_windows, str(tmp_path / "jax"))
    assert port == ref
    evs, counts = port
    assert counts == {"data_wait_ms": 2, "serving_ms": 2}
    parents = {e["name"]: e["parent"] for e in evs if e["ev"] == "span"}
    assert parents["checkpoint_save"] == "checkpoint"
    assert parents["readback"] == "eval"
    assert parents["voxelize"] == "data_wait"
    assert parents["eval"] is None


def test_data_wait_window_is_per_step():
    agg = windows.WindowAggregator()
    ref = jax_windows.WindowAggregator()
    windows.install(agg)
    jax_windows.install(ref)
    try:
        for w in (windows, jax_windows):
            w.observe_span("data_wait", 0.008, {"take": 4})
            w.observe_span("infer_batch", 0.003, {"n": 2})
            w.observe_span("dispatch", 1.0, {"take": 4})  # not a window
        assert agg.snapshot() == ref.snapshot()
        assert agg.snapshot()["data_wait_ms"]["max"] == pytest.approx(2.0)
    finally:
        windows.uninstall()
        jax_windows.uninstall()


def test_port_span_names_are_known_to_the_report():
    """Every literal span name in the port's sources is in
    ``KNOWN_SPAN_NAMES`` (the report keys its sections off them), and the
    registry is the reference's."""
    found = set()
    for root, _, names in os.walk(PORT):
        for n in names:
            if n.endswith(".py"):
                with open(os.path.join(root, n)) as fh:
                    found |= set(re.findall(r'\bspan\(\s*"([a-z_]+)"', fh.read()))
    assert found and found <= report.KNOWN_SPAN_NAMES
    assert {"data_wait", "dispatch", "readback", "eval", "checkpoint",
            "checkpoint_save", "checkpoint_write", "checkpoint_restore",
            "checkpoint_wait", "infer_batch", "serve_dispatch",
            "build_cache_class", "export_class", "export_seg_shard",
            "voxelize"} <= found
    assert report.KNOWN_SPAN_NAMES == jax_report.KNOWN_SPAN_NAMES
    assert report.LOOP_CATEGORIES == jax_report.LOOP_CATEGORIES
    assert report.KNOWN_EVENT_KINDS == jax_report.KNOWN_EVENT_KINDS
    assert report.REQUIRED_EVENT_FIELDS == jax_report.REQUIRED_EVENT_FIELDS


# --- the report path on synthetic streams ------------------------------------

T0 = 1.7e9


def _loop(host, t, steps, wall, dw, pid=100, truncate=False):
    """One loop window of ``steps`` steps over ``wall`` seconds: spans of
    each category, heartbeats, gauges, a metrics record."""
    ev = [{"t": t, "ev": "loop_start", "pid": pid, "step": 0, "stop": steps,
           "total": steps, "global_batch": 32}]
    dt = wall / (steps + 2)
    for i in range(steps):
        s = t + (i + 1) * dt
        ev += [
            {"t": s, "ev": "span", "pid": pid, "name": "data_wait",
             "dur_s": dw * dt, "thread": 1, "parent": None, "take": 1},
            {"t": s + dw * dt, "ev": "span", "pid": pid, "name": "dispatch",
             "dur_s": 0.3 * dt, "thread": 1, "parent": None, "take": 1},
            {"t": s + 0.5 * dt, "ev": "span", "pid": pid, "name": "readback",
             "dur_s": 0.1 * dt, "thread": 1, "parent": None, "step": i + 1},
            {"t": s + 0.7 * dt, "ev": "heartbeat", "pid": pid,
             "age_s": round(dt, 3) if i else None},
            {"t": s + 0.7 * dt, "ev": "gauge", "pid": pid,
             "name": "prefetch_queue_depth", "value": i % 3},
            {"t": s + 0.1 * dt, "ev": "gauge", "pid": pid,
             "name": "producer_batch_s", "value": 0.01 * (i + 1), "worker": 0},
        ]
    e = t + (steps + 1) * dt
    ev += [
        {"t": e, "ev": "span", "pid": pid, "name": "eval", "dur_s": 0.5 * dt,
         "thread": 1, "parent": None},
        {"t": e + 0.1 * dt, "ev": "span", "pid": pid, "name": "readback",
         "dur_s": 0.01 * dt, "thread": 1, "parent": "eval", "src": "metrics",
         "step": steps},
        {"t": e + 0.6 * dt, "ev": "span", "pid": pid, "name": "checkpoint",
         "dur_s": 0.2 * dt, "thread": 1, "parent": None, "step": steps},
        {"t": e + 0.61 * dt, "ev": "span", "pid": pid, "name": "checkpoint_save",
         "dur_s": 0.1 * dt, "thread": 1, "parent": "checkpoint", "step": steps},
        {"t": e + 0.9 * dt, "ev": "metrics", "pid": pid, "kind": "train",
         "step": steps, "loss": 1.5 + host, "accuracy": 0.25,
         "samples_per_sec": 100.0},
        {"t": e + 0.9 * dt, "ev": "window_summary", "pid": pid,
         "metric": "step_ms", "n": steps, "p50": 10.0 + host, "p95": 12.0,
         "p99": 13.0, "mean": 10.5, "max": 13.0, "seq": 1},
    ]
    if not truncate:
        ev.append({"t": t + wall, "ev": "loop_end", "pid": pid, "step": steps,
                   "wall_s": wall})
    return ev


def _serving(t, pid=300):
    ev = [{"t": t, "ev": "serve_start", "pid": pid, "buckets": [1, 4],
           "max_wait_ms": 2.0, "queue_limit": 64}]
    for i in range(6):
        tr = f"req-{i}"
        s = t + 0.01 * (i + 1)
        ev += [
            {"t": s, "ev": "request_admit", "pid": pid, "trace": tr},
            {"t": s + 0.001, "ev": "request_dispatch", "pid": pid, "trace": tr,
             "batch_seq": i // 2 + 1, "bucket": 4, "pad": 2},
            {"t": s + 0.002, "ev": "span", "pid": pid, "name": "serve_dispatch",
             "dur_s": 0.001, "thread": 7, "parent": None, "bucket": 4, "n": 2,
             "batch_seq": i // 2 + 1},
            {"t": s + 0.002, "ev": "span", "pid": pid, "name": "infer_batch",
             "dur_s": 0.001 * (i + 1), "thread": 7, "parent": None, "n": 2,
             "batch": 4},
            {"t": s + 0.004, "ev": "request_done", "pid": pid, "trace": tr,
             "queue_wait_ms": 1.0, "dispatch_ms": 2.0 + i, "total_ms": 3.0 + i,
             "outcome": "ok", "forced": i == 5},
        ]
    ev += [
        {"t": t + 0.2, "ev": "request_reject", "pid": pid, "trace": "req-x",
         "queue_depth": 64, "limit": 64},
        {"t": t + 0.2, "ev": "overload", "pid": pid, "queue_depth": 64,
         "limit": 64},
        {"t": t + 0.21, "ev": "serve_batch", "pid": pid, "bucket": 4, "n": 2,
         "pad": 2, "batch_seq": 1},
        {"t": t + 0.22, "ev": "serve_batch", "pid": pid, "bucket": 1, "n": 1,
         "pad": 0, "batch_seq": 2},
        {"t": t + 0.23, "ev": "program_compile", "pid": pid,
         "program": "serve", "dur_s": 0.4},
        {"t": t + 0.23, "ev": "program_cost", "pid": pid, "program": "serve",
         "flops": 2e9, "bytes": 1e8, "peak_bytes": 3e8, "device_kind": "cpu"},
        {"t": t + 0.24, "ev": "device_memory", "pid": pid, "device": 0,
         "bytes_in_use": 12345, "peak_bytes_in_use": 23456},
        {"t": t + 0.25, "ev": "window_summary", "pid": pid,
         "metric": "serving_ms", "n": 6, "p50": 5.0, "p95": 8.0, "p99": 8.0,
         "mean": 5.5, "max": 8.0, "seq": 2},
        {"t": t + 0.25, "ev": "window_summary", "pid": pid, "metric": "mfu",
         "n": 6, "p50": 0.2, "p95": 0.3, "p99": 0.3, "mean": 0.2, "max": 0.3,
         "seq": 2},
        {"t": t + 0.26, "ev": "alert", "pid": pid, "rule": "serving_p99_ms",
         "severity": "warning", "value": 8.0, "threshold": 5.0, "window": 2,
         "state": "fire"},
        {"t": t + 0.27, "ev": "loadgen", "pid": pid, "n": 6,
         "client_p50_ms": 6.0, "client_p99_ms": 10.0},
        {"t": t + 0.28, "ev": "conn_open", "pid": pid, "endpoint": "a:1",
         "connect_ms": 0.3},
        {"t": t + 0.29, "ev": "conn_reuse", "pid": pid, "endpoint": "a:1"},
        {"t": t + 0.30, "ev": "conn_retire", "pid": pid, "endpoint": "a:1",
         "reason": "shutdown"},
        {"t": t + 0.31, "ev": "incident_open", "pid": pid, "id": "inc-1",
         "rule": "serving_p99_ms", "severity": "warning", "value": 8.0},
        {"t": t + 0.32, "ev": "fleet_start", "pid": pid, "replicas": 2},
        {"t": t + 0.33, "ev": "fleet_replica_loss", "pid": pid, "replica": 1,
         "reason": "exit"},
        {"t": t + 0.34, "ev": "swap", "pid": pid, "ok": True,
         "from_version": "a", "swap_ms": 3.0},
        {"t": t + 0.35, "ev": "quality_drift", "pid": pid, "score": 0.1, "n": 6},
        {"t": t + 0.36, "ev": "fleet_stop", "pid": pid, "routed": 6,
         "answered": 6, "rejected": 0, "dropped": 0},
        {"t": t + 0.4, "ev": "serve_stop", "pid": pid, "served": 6,
         "rejected": 1},
    ]
    return ev


def _supervised(t):
    ev = [{"t": t, "ev": "run_start", "pid": 100, "process_index": 0},
          {"t": t + 0.1, "ev": "supervisor", "pid": 99, "phase": "spawn",
           "attempt": 1}]
    ev += _loop(0, t + 1, 4, 2.0, 0.2, pid=100)
    ev += [{"t": t + 3.5, "ev": "preempt", "pid": 100, "step": 4},
           {"t": t + 3.6, "ev": "supervisor", "pid": 99,
            "phase": "planned_restart", "count": 1},
           {"t": t + 3.7, "ev": "run_start", "pid": 101, "process_index": 0},
           {"t": t + 3.8, "ev": "checkpoint_fallback", "pid": 101,
            "from_step": 4, "to_step": 2, "error": "x"},
           {"t": t + 3.9, "ev": "warning", "pid": 101, "name": "producer_error",
            "msg": "worker 0 died", "worker": 0}]
    ev += _loop(0, t + 4, 4, 3.0, 0.4, pid=101, truncate=True)
    ev += [{"t": t + 7.5, "ev": "supervisor", "pid": 99, "phase": "stall",
            "heartbeat_age_s": 30.0},
           {"t": t + 7.6, "ev": "supervisor", "pid": 99, "phase": "restart",
            "attempt": 2, "reason": "stall"},
           {"t": t + 7.7, "ev": "supervisor", "pid": 99,
            "phase": "gate_regression", "failed": ["step_ms"]},
           {"t": t + 8.0, "ev": "run_end", "pid": 101, "step": 8, "total": 8},
           {"t": t + 8.1, "ev": "supervisor", "pid": 99, "phase": "done",
            "restarts": 1}]
    return ev


def _stream(case: str) -> tuple[dict[int, list], list[str]]:
    """Per-stream events of one scripted run, and garbage lines for host 0."""
    if case == "train":
        return {0: [{"t": T0, "ev": "run_start", "pid": 100}]
                + _loop(0, T0 + 1, 6, 3.0, 0.25)
                + [{"t": T0 + 4.5, "ev": "run_end", "pid": 100, "step": 6}]}, []
    if case == "supervised":
        return {0: _supervised(T0)}, ['{"t": 1, "ev": "span", "name": "x", ',
                                      "not json"]
    if case == "multi_host":
        return {i: [{"t": T0 + i * 0.1, "ev": "run_start", "pid": 100 + i,
                     "process_index": i}]
                + _loop(i, T0 + 1 + i * 0.2, 5 + (i == 2), 3.0 + i, 0.1 * (i + 1),
                        pid=100 + i)
                for i in range(3)}, []
    if case == "serving":
        return {0: [{"t": T0, "ev": "run_start", "pid": 300}] + _serving(T0 + 1)
                + [{"t": T0 + 2, "ev": "mystery", "pid": 300},
                   {"t": T0 + 2, "ev": "gauge", "pid": 300, "name": "x"},
                   {"t": T0 + 2, "ev": "span", "pid": 300, "name": "dispatch",
                    "dur_s": -1.0, "thread": 1}]}, []
    raise KeyError(case)


CASES = ("train", "supervised", "multi_host", "serving")
TOPOLOGY = {"process_index": 0, "device_count": 1, "process_count": 1}


def _write(run_dir, case: str, key: str) -> None:
    os.makedirs(run_dir)
    streams, garbage = _stream(case)
    for idx, evs in streams.items():
        name = events.events_filename(idx)
        with open(os.path.join(run_dir, name), "w") as fh:
            for e in evs:
                fh.write(json.dumps(e) + "\n")
            if idx == 0:
                for g in garbage:
                    fh.write(g + "\n")
    with open(os.path.join(run_dir, events.MANIFEST_FILENAME), "w") as fh:
        json.dump({"run_dir": "/r", "start_time": "2026-01-01T00:00:00+00:00",
                   "config": {"name": "smoke16", "task": "classify",
                              "alert_rules": "data_wait_spread>0.05",
                              "trace_sample": 1.0},
                   key: TOPOLOGY}, fh)


@pytest.fixture(params=CASES)
def streams(request, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    _write(port, request.param, "torch")
    _write(ref, request.param, "jax")
    ev, bad = report.load_events(port)
    jev, jbad = jax_report.load_events(ref)
    assert (ev, bad) == (jev, jbad)
    return request.param, port, ref, ev, bad


def test_build_report_matches_jax(streams):
    case, port, ref, ev, bad = streams
    rep = report.build_report(ev, report.load_manifest(port), bad_lines=bad)
    jrep = jax_report.build_report(ev, jax_report.load_manifest(ref),
                                   bad_lines=bad)
    assert rep == jrep
    assert rep["run"]["device_count"] == 1  # read under "torch"
    if case == "serving":
        assert "incidents" in rep and rep["perf"] == jrep["perf"]
    assert report.build_report_dir(port) == jax_report.build_report_dir(ref)
    # The rendering, but for the word XLA.
    text = report.format_report(rep)
    jtext = jax_report.format_report(jrep).replace("s XLA)", "s)")
    assert text == jtext


def test_validate_events_matches_jax(streams):
    case, _, _, ev, bad = streams
    got = report.validate_events(ev, bad_lines=bad)
    assert got == jax_report.validate_events(ev, bad_lines=bad)
    assert bool(got) == (case in ("supervised", "serving"))


def test_chrome_trace_matches_jax(streams):
    _, _, _, ev, _ = streams
    got = spans.chrome_trace(ev)
    assert got == jax_spans.chrome_trace(ev)
    assert got["traceEvents"]


def test_gates_match_jax(streams):
    case, _, ref, ev, bad = streams
    rep = report.build_report(ev, report.load_manifest(ref), bad_lines=bad)
    jrep = jax_report.build_report(ev, jax_report.load_manifest(ref),
                                   bad_lines=bad)
    vals = gates.report_gate_values(rep)
    jvals = jax_gates.report_gate_values(jrep)
    assert vals == jvals
    base = gates.apply_abs_slack(gates.make_baseline(vals, tolerance=0.2))
    assert base == jax_gates.apply_abs_slack(
        jax_gates.make_baseline(vals, tolerance=0.2))
    worse = {k: v * 1.5 + 1 for k, v in vals.items()}
    for v in (vals, worse, {}):
        got = gates.evaluate_gates(v, base)
        assert got == jax_gates.evaluate_gates(v, base)
        assert gates.format_gates(got, "b.json") == jax_gates.format_gates(
            got, "b.json")
    assert gates.evaluate_gates(vals, base)["ok"]
    assert not gates.evaluate_gates(worse, base)["ok"]
    assert {k: gates.DIRECTIONS[k] for k in vals} == {
        k: jax_gates.DIRECTIONS[k] for k in vals}


def test_request_timeline_and_follow(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    _write(port, "serving", "torch")
    _write(ref, "serving", "jax")
    ev, _ = report.load_events(port)
    for tid in ("req-3", "req-x", "absent"):
        tl = report.request_timeline(ev, tid)
        assert tl == jax_report.request_timeline(ev, tid)
        assert report.format_request_timeline(tl) == \
            jax_report.format_request_timeline(tl)
    out: list = []
    report.follow_report(port, out=out.append, clock=lambda s: None,
                         max_polls=2, clear=False)
    assert "serve:" in out[0] and "== slo |" in out[0]
    # A supervisor's terminal verdict ends the live tail.
    sup = str(tmp_path / "sup")
    _write(sup, "supervised", "torch")
    out = []
    report.follow_report(sup, out=out.append, clock=lambda s: None,
                         max_polls=5, clear=False)
    assert out[-1] == "-- run ended; follow exiting"


def test_event_tail_keeps_a_partial_line_for_the_next_poll(tmp_path):
    d = str(tmp_path)
    path = os.path.join(d, "events.jsonl")
    with open(path, "w") as fh:
        fh.write('{"t": 1, "ev": "run_start"}\n{"t": 2, "ev": "he')
    tail, jtail = report.EventTail(d), jax_report.EventTail(d)
    assert tail.poll() == jtail.poll() and len(tail.events) == 1
    with open(path, "a") as fh:
        fh.write('artbeat", "age_s": null}\n')
    assert tail.poll() == jtail.poll() == [
        {"t": 2, "ev": "heartbeat", "age_s": None, "process_index": 0}]


# --- the Trainer's run directory ---------------------------------------------

RUN_STEPS = 6


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A CPU smoke16 Trainer with a run directory and a checkpoint
    directory; 6 steps."""
    d = tmp_path_factory.mktemp("port_run")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_config("smoke16", total_steps=RUN_STEPS, log_every=2,
                         eval_every=RUN_STEPS, checkpoint_every=3,
                         max_inflight_steps=2, data_workers=1,
                         run_dir=str(d / "run"), checkpoint_dir=str(d / "ck"))
        with open(os.devnull, "w") as sink:
            Trainer(cfg, device="cpu", stream=sink).run()
    finally:
        obs.close_run()
        torch.set_num_threads(threads)
    return d


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference Trainer on the same config (no checkpoints), 4 steps."""
    from featurenet_tpu.config import get_config as jax_get_config
    from featurenet_tpu.train.loop import Trainer as JaxTrainer

    d = tmp_path_factory.mktemp("jax_run")
    cfg = jax_get_config("smoke16", total_steps=4, log_every=2, eval_every=4,
                         max_inflight_steps=2, data_workers=1,
                         run_dir=str(d / "run"))
    try:
        JaxTrainer(cfg).run()
    finally:
        jax_obs.close_run()
    return d


def test_trainer_run_dir_reports_the_loop(port_run):
    run = str(port_run / "run")
    ev, bad = report.load_events(run)
    assert report.validate_events(ev, bad) == []
    rep = report.build_report_dir(run)
    assert rep["loop"]["steps"] == RUN_STEPS and rep["loop"]["windows"] == 1
    assert rep["loop"]["truncated_windows"] == 0 and rep["process_starts"] == 1
    assert set(rep["breakdown"]) == {*report.LOOP_CATEGORIES, "other"}
    assert all(rep["breakdown"][c]["seconds"] > 0 for c in report.LOOP_CATEGORIES)
    assert 0 < rep["attributed_fraction"] <= 1
    assert rep["heartbeat"]["beats"] >= 3
    assert rep["prefetch_queue_depth"]["n"] >= RUN_STEPS
    assert rep["producer_batch_s"]["n"] >= RUN_STEPS
    assert set(rep["metrics"]["last"]) == {"setup", "train", "eval", "checkpoint"}
    assert {"step_ms", "data_wait_ms", "queue_depth"} <= set(rep["slo"]["windows"])
    kinds = [e["ev"] for e in ev]
    # The run's end, then the windows' last summaries (flushed at close).
    assert kinds[0] == "run_start" and "run_end" in kinds
    assert set(kinds[kinds.index("run_end") + 1:]) <= {"window_summary", "alert"}
    start = next(e for e in ev if e["ev"] == "loop_start")
    assert (start["step"], start["stop"], start["total"], start["global_batch"]) \
        == (0, RUN_STEPS, RUN_STEPS, 32)
    with open(os.path.join(run, "run.json")) as fh:
        manifest = json.load(fh)
    assert "torch" in manifest and "jax" not in manifest
    assert manifest["config"]["run_dir"] == run


def test_trainer_events_match_the_reference_trainer(port_run, jax_run):
    """The port's Trainer writes the reference Trainer's event kinds (but
    the perf plane's) and its loop spans, with the same fields, and the
    report folds both into the same sections."""
    ev, _ = report.load_events(str(port_run / "run"))
    jev, _ = jax_report.load_events(str(jax_run / "run"))
    kinds = {e["ev"] for e in ev}
    jkinds = {e["ev"] for e in jev} - {"program_compile", "program_cost", "alert"}
    assert jkinds <= kinds - {"alert"}
    def fields(evs, kind, name=None):
        return {frozenset(k for k in e if k not in ("t", "dur_s"))
                for e in evs if e["ev"] == kind and e.get("name", name) == name}
    for kind, name in (("span", "data_wait"), ("span", "dispatch"),
                       ("span", "readback"), ("span", "eval"),
                       ("heartbeat", None), ("loop_end", None), ("run_end", None),
                       ("gauge", "prefetch_queue_depth"),
                       ("gauge", "producer_batch_s")):
        assert fields(ev, kind, name) >= fields(jev, kind, name), (kind, name)
    # The loop_start of the port carries the mesh, as the reference's.
    assert fields(ev, "loop_start") == fields(jev, "loop_start")
    rep = report.build_report_dir(str(port_run / "run"))
    jrep = jax_report.build_report_dir(str(jax_run / "run"))
    assert set(jrep) - set(rep) <= {"perf", "runtime"}
    assert set(rep["loop"]) == set(jrep["loop"])
    assert set(rep["breakdown"]) == set(jrep["breakdown"])


def test_trace_window_starts_at_a_resumed_runs_first_step(port_run, tmp_path):
    """Resumed at step 6 with profile_start 2: steps 6 and 7 are traced,
    not 2 and 3."""
    import shutil

    ck = str(tmp_path / "ck")
    shutil.copytree(port_run / "ck", ck)
    prof = str(tmp_path / "prof")
    cfg = get_config("smoke16", total_steps=RUN_STEPS + 2, log_every=100,
                     eval_every=100, checkpoint_every=100, data_workers=1,
                     checkpoint_dir=ck, profile_dir=prof, profile_start=2,
                     profile_steps=2)
    with open(os.devnull, "w") as sink:
        Trainer(cfg, device="cpu", stream=sink).run()
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].startswith(
        f"trace_steps_{RUN_STEPS}-{RUN_STEPS + 2}_")
    with open(os.path.join(prof, files[0])) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    ranges = sorted(n for n in names if str(n).startswith("train_dispatch@"))
    assert ranges == [f"train_dispatch@{RUN_STEPS}", f"train_dispatch@{RUN_STEPS + 1}"]


def test_trace_window_closes_on_an_exception_with_its_trace(tmp_path):
    prof = str(tmp_path / "prof")
    cfg = get_config("smoke16", total_steps=6, data_workers=1, profile_dir=prof,
                     profile_start=0, profile_steps=4, run_dir=str(tmp_path / "run"))
    with open(os.devnull, "w") as sink:
        t = Trainer(cfg, device="cpu", stream=sink)
        real = t.dispatch

        def dispatch(batches, take):
            if t.state.step == 2:
                raise RuntimeError("a step fails inside the window")
            return real(batches, take)

        t.dispatch = dispatch
        with pytest.raises(RuntimeError, match="inside the window"):
            t.run()
    obs.close_run()
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].startswith("trace_steps_0-2_")
    ev, bad = report.load_events(str(tmp_path / "run"))
    end = [e for e in ev if e["ev"] == "loop_end"]
    assert [e["step"] for e in end] == [2] and "run_end" not in {e["ev"] for e in ev}


# --- sink_enospc ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3])
def test_sink_enospc_turns_both_sinks_dark(tmp_path, capfd, n):
    for name, sink_mod, fmod in (("port", events, faults),
                                 ("jax", jax_events, jax_faults)):
        fmod.install(f"sink_enospc@emit={n}")
        try:
            sink = sink_mod.EventSink(str(tmp_path / name))
            for i in range(5):
                sink.emit("gauge", name="x", value=i)
            sink.close()
        finally:
            fmod.uninstall()
    err = capfd.readouterr().err
    assert err.count("sink_error") == 2 and err.count('"fault_injected"') == 2
    port = [e["value"] for e in _lines(str(tmp_path / "port" / "events.jsonl"))]
    assert port == list(range(n - 1)) == [
        e["value"] for e in _lines(str(tmp_path / "jax" / "events.jsonl"))]


def test_sink_enospc_run_finishes_dark(tmp_path, capfd):
    run = str(tmp_path / "run")
    cfg = get_config("smoke16", total_steps=4, log_every=2, eval_every=4,
                     data_workers=1, run_dir=run, inject_faults="sink_enospc@emit=10",
                     checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    with open(os.devnull, "w") as sink:
        last = Trainer(cfg, device="cpu", stream=sink).run()
    obs.close_run()
    assert last["eval_batches"] == 2.0 and np.isfinite(last["loss"])
    assert len(_lines(os.path.join(run, "events.jsonl"))) == 9
    assert os.path.exists(os.path.join(run, "fault_sink_enospc.fired"))
    assert "sink_error" in capfd.readouterr().err
    ev, bad = report.load_events(run)
    assert bad == 0 and report.build_report(ev)["process_starts"] == 1


# --- the supervisor's run_dir half --------------------------------------------

POLL_S = 0.05


def _child(d, script: str) -> str:
    """A fake child: ``n`` is its attempt (0 first), ``beat()`` touches the
    heartbeat, ``loop(wall)`` appends one loop window of 4 steps to the
    run's stream, ``raw(s)`` appends bytes as they are."""
    return (
        "import json, os, sys, time\n"
        f"a={str(d / 'attempts')!r}; hb={str(d / 'hb')!r}\n"
        f"ev={str(d / 'run' / 'events.jsonl')!r}\n"
        "n = len(open(a).read()) if os.path.exists(a) else 0\n"
        "open(a, 'a').write('x')\n"
        "def beat():\n"
        "    time.sleep(0.05); open(hb, 'a').close(); os.utime(hb, None)\n"
        "def raw(s):\n"
        "    fd = os.open(ev, os.O_APPEND | os.O_CREAT | os.O_WRONLY)\n"
        "    os.write(fd, s.encode()); os.close(fd)\n"
        "def put(**e):\n"
        "    raw(json.dumps({'t': time.time(), 'pid': os.getpid(), **e}) + '\\n')\n"
        "def loop(wall, dw=0.1):\n"
        "    t = time.time()\n"
        "    put(ev='run_start', process_index=0)\n"
        "    put(ev='loop_start', step=4 * n)\n"
        "    put(ev='span', name='data_wait', dur_s=dw * wall, thread=1,\n"
        "        parent=None, take=4)\n"
        "    raw(json.dumps({'t': t + wall, 'ev': 'loop_end', 'pid': os.getpid(),\n"
        "                    'step': 4 * n + 4, 'wall_s': wall}) + '\\n')\n"
        + script
    )


SUPERVISED = {
    # A garbage line among the first child's lines: its exit 0 is not
    # trusted, a telemetry_corrupt restart; the second child is clean.
    "telemetry_corrupt": "beat()\nloop(1.0)\nif n == 0:\n    raw('garbage\\n')\n"
                         "    put(ev='heartbeat', age_s=None)\n",
    # Two segments at one speed: pinned, then judged ok.
    "gate_ok": "beat()\nloop(1.0)\nsys.exit(75 if n == 0 else 0)\n",
    # The second segment three times slower: a gate_regression, no restart.
    "gate_regression": "beat()\nloop(1.0 if n == 0 else 3.0)\n"
                       "sys.exit(75 if n == 0 else 0)\n",
    # A sink that died on a short write: its torn last line is not
    # corruption.
    "dark_sink": "beat()\nloop(1.0)\nraw('{\"t\": 1, \"ev\": \"sp')\n",
    # No loop in the segment: nothing to gate.
    "no_loop": "beat()\n",
    # A crash, then a clean child: one restart.
    "crash": "beat()\nloop(1.0)\nsys.exit(3 if n == 0 else 0)\n",
}


def _supervise(mod, tmp_path, case):
    d = tmp_path / f"{case}_{mod.__name__.split('.')[0]}"
    (d / "run").mkdir(parents=True)
    records = []
    res = mod.supervise([sys.executable, "-c", _child(d, SUPERVISED[case])],
                        heartbeat_file=str(d / "hb"), stall_timeout_s=5.0,
                        max_restarts=2, poll_s=POLL_S, grace_s=30.0,
                        log=lambda line: records.append(json.loads(line)),
                        run_dir=str(d / "run"), backoff_base_s=0.0)
    phases = []
    with open(d / "run" / "events.jsonl") as fh:
        for ln in fh:
            # The supervisor's next line lands glued to a torn fragment,
            # and a garbage line is no event.
            if '"ev": "supervisor"' in ln:
                phases.append(json.loads(ln[ln.rfind('{"t"'):])["phase"])
    pin = d / "run" / supervisor.GATE_BASELINE_FILENAME
    baseline = json.loads(pin.read_text()) if pin.exists() else None
    return res, [r["supervisor"] for r in records], phases, baseline, d


@pytest.mark.parametrize("case", sorted(SUPERVISED))
def test_supervisor_run_dir_half_matches_jax(tmp_path, case):
    res, kinds, phases, baseline, d = _supervise(supervisor, tmp_path, case)
    jres, jkinds, jphases, jbaseline, _ = _supervise(jax_supervisor, tmp_path, case)
    assert (res.exit_code, res.restarts, res.stalls, res.planned) == (
        jres.exit_code, jres.restarts, jres.stalls, jres.planned)
    assert kinds == jkinds and phases == jphases
    if baseline is not None or jbaseline is not None:
        assert baseline["gates"].keys() == jbaseline["gates"].keys()
        for k, pin in baseline["gates"].items():
            assert {f: v for f, v in pin.items() if f != "value"} == {
                f: v for f, v in jbaseline["gates"][k].items() if f != "value"}
    want = {
        "telemetry_corrupt": ["spawn", "telemetry_corrupt", "restart", "spawn",
                              "auto_pin", "done"],
        "gate_ok": ["spawn", "auto_pin", "planned_restart", "spawn", "gate",
                    "done"],
        "gate_regression": ["spawn", "auto_pin", "planned_restart", "spawn",
                            "gate_regression", "done"],
        "dark_sink": ["spawn", "auto_pin", "done"],
        "no_loop": ["spawn", "done"],
        "crash": ["spawn", "restart", "spawn", "auto_pin", "done"],
    }[case]
    assert phases == want
    assert res.exit_code == 0
    if case != "no_loop":
        rep = report.build_report_dir(str(d / "run"))
        assert rep["supervisor"]["timeline"][0]["phase"] == "spawn"


def test_segment_gate_errors_are_never_load_bearing(tmp_path):
    """A baseline the gate cannot read: a gate_error log line, the run
    still done."""
    d = tmp_path / "g"
    (d / "run").mkdir(parents=True)
    (d / "run" / supervisor.GATE_BASELINE_FILENAME).write_text("{not json")
    records = []
    res = supervisor.supervise(
        [sys.executable, "-c", _child(d, SUPERVISED["gate_ok"])],
        heartbeat_file=str(d / "hb"), poll_s=POLL_S, grace_s=30.0,
        log=lambda line: records.append(json.loads(line)),
        run_dir=str(d / "run"), backoff_base_s=0.0)
    assert res.exit_code == 0 and res.planned == 1
    assert [r["supervisor"] for r in records].count("gate_error") == 2


# --- cli report -------------------------------------------------------------------

def _no_torch(*args, module=False):
    """``cli report`` in a fresh process where importing torch fails."""
    if module:
        code = ("import runpy, sys; sys.modules['torch'] = None\n"
                f"sys.argv = ['cli'] + {list(args)!r}\n"
                "runpy.run_module('featurenet_tpu_torch.cli', run_name='__main__')\n")
    else:
        code = ("import sys; sys.modules['torch'] = None\n"
                "from featurenet_tpu_torch import cli\n"
                f"rc = cli.main({list(args)!r})\n"
                "assert 'torch' not in {m.split('.')[0] for m, v in sys.modules.items()"
                " if v is not None}\n"
                "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_cli_report_runs_without_torch(port_run, tmp_path):
    run = str(port_run / "run")
    got = _no_torch("report", run, "--json")
    assert got.returncode == 0, got.stderr
    assert json.loads(got.stdout) == json.loads(json.dumps(
        report.build_report_dir(run), default=str))
    got = _no_torch("report", run, "--validate", module=True)
    assert got.returncode == 0, got.stderr
    assert json.loads(got.stdout)["validate"] == "ok"
    trace = str(tmp_path / "t.json")
    base = str(tmp_path / "base.json")
    with open(base, "w") as fh:
        json.dump(gates.make_baseline({"step_ms": 1e-3, "bad_lines": 0.0}), fh)
    got = _no_torch("report", run, "--trace", trace, "--gate", base)
    assert got.returncode == 2, got.stderr  # step_ms regressed past 1 µs
    assert "loop: 6 step(s)" in got.stdout and "FAIL step_ms" in got.stdout
    with open(trace) as fh:
        assert any(e.get("ph") == "X" for e in json.load(fh)["traceEvents"])
    got = _no_torch("report", run, "--request", "nope")
    assert got.returncode == 2 and "no events in this run dir" in got.stdout
    got = _no_torch("report", run, "--follow", "--interval", "0.01")
    assert got.returncode == 0 and "run ended" in got.stdout


def test_cli_report_names_what_a_directory_holds(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="the directory is empty"):
        cli.main(["report", str(empty)])
    (empty / "run.json").write_text("{}")
    with pytest.raises(SystemExit, match="found: run.json; was the run started"):
        cli.main(["report", str(empty)])
    with pytest.raises(SystemExit, match="is not a directory"):
        cli.main(["report", str(tmp_path / "nowhere")])
    bad = tmp_path / "bad"
    _write(str(bad), "serving", "torch")
    with pytest.raises(SystemExit, match=r"validate: 3 finding\(s\)"):
        cli.main(["report", str(bad), "--validate"])
    assert capsys.readouterr().out.count('"check"') == 3


# --- every command's run directory validates ---------------------------------

def _validates(run_dir) -> list[str]:
    ev, bad = report.load_events(str(run_dir))
    assert report.validate_events(ev, bad) == []
    return sorted({e["ev"] for e in ev})


def test_cli_train_run_dir_validates(tmp_path, capsys):
    run = tmp_path / "run"
    assert cli.main(["train", "--config", "smoke16", "--device", "cpu",
                     "--total-steps", "2", "--data-workers", "1",
                     "--run-dir", str(run), "--alert-rules",
                     "step_p99_ratio>1000"]) == 0
    capsys.readouterr()
    kinds = _validates(run)
    assert {"loop_start", "loop_end", "run_end", "span", "metrics"} <= set(kinds)


def test_cli_train_supervised_run_dir_validates(tmp_path):
    run, ck = tmp_path / "run", tmp_path / "ck"
    out = subprocess.run(
        [sys.executable, "-m", "featurenet_tpu_torch.cli", "train", "--config",
         "smoke16", "--device", "cpu", "--total-steps", "2", "--data-workers",
         "1", "--checkpoint-dir", str(ck), "--checkpoint-every", "1",
         "--eval-batches", "1", "--supervise", "--restart-every", "1",
         "--stall-timeout", "60",
         "--run-dir", str(run)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    kinds = _validates(run)
    assert "supervisor" in kinds
    rep = report.build_report_dir(str(run))
    assert rep["loop"]["steps"] == 2 and rep["process_starts"] == 2
    assert rep["supervisor"]["planned_restarts"] == 1
    assert [e["phase"] for e in rep["supervisor"]["timeline"]] == [
        "spawn", "auto_pin", "planned_restart", "spawn",
        rep["supervisor"]["timeline"][4]["phase"], "done"]
    assert rep["supervisor"]["timeline"][4]["phase"] in ("gate", "gate_regression")
    assert os.path.exists(run / supervisor.GATE_BASELINE_FILENAME)


def test_cli_serve_run_dir_validates(tmp_path):
    import http.client

    run = tmp_path / "run"
    proc = subprocess.Popen(
        [sys.executable, "-m", "featurenet_tpu_torch.cli", "serve", "--config",
         "smoke16", "--seed", "0", "--device", "cpu", "--port", "0",
         "--buckets", "1", "--run-dir", str(run), "--trace-sample", "1.0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        port = json.loads(proc.stdout.readline())["serving"]["port"]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predict_voxels",
                     body=np.zeros((16, 16, 16), "<f4").tobytes())
        assert conn.getresponse().status == 200
        conn.close()
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0
    kinds = _validates(run)
    assert {"serve_start", "serve_batch", "serve_stop", "request_done",
            "span"} <= set(kinds)
    rep = report.build_report_dir(str(run))
    assert rep["serve"]["served"] == 1 and rep["traces"]["sampled"] == 1


def test_cli_programs_run_dir_validates(tmp_path, capsys):
    run = tmp_path / "run"
    assert cli.main(["programs", "--config", "smoke16", "--run-dir",
                     str(run)]) == 0
    capsys.readouterr()
    assert _validates(run) == ["run_start"]


def test_cli_data_commands_run_dirs_validate(tmp_path, capsys):
    exp, stl, bld = tmp_path / "exp", tmp_path / "stl", tmp_path / "bld"
    assert cli.main(["export-data", "--out", str(tmp_path / "c"), "--per-class",
                     "1", "--resolution", "16", "--run-dir", str(exp)]) == 0
    assert cli.main(["export-stl-data", "--out", str(stl), "--per-class", "1",
                     "--resolution", "16"]) == 0
    assert cli.main(["build-cache", "--stl-root", str(stl), "--out",
                     str(tmp_path / "b"), "--resolution", "16", "--workers",
                     "1", "--run-dir", str(bld)]) == 0
    capsys.readouterr()
    assert _validates(exp) == ["run_start", "span"]
    ev, _ = report.load_events(str(exp))
    assert sum(e.get("name") == "export_class" for e in ev) == 24
    _validates(bld)
    ev, _ = report.load_events(str(bld))
    names = [e.get("name") for e in ev if e["ev"] == "span"]
    assert names.count("build_cache_class") == 24 and names.count("voxelize") == 24
    assert all(e["parent"] == "build_cache_class" for e in ev
               if e.get("name") == "voxelize")


def test_cli_infer_run_dir_validates(port_run, tmp_path, capsys):
    stl = tmp_path / "stl"
    assert cli.main(["export-stl-data", "--out", str(stl), "--per-class", "1",
                     "--resolution", "16"]) == 0
    parts = sorted(str(p) for p in stl.rglob("*.stl"))[:3]
    run = tmp_path / "run"
    argv = ["infer", "--checkpoint-dir", str(port_run / "ck"), "--device", "cpu",
            "--run-dir", str(run), *parts]
    assert cli.main(argv + ["--alert-rules", "serving_p99_ms>100000"]) == 0
    capsys.readouterr()
    kinds = _validates(run)
    assert {"span", "window_summary"} <= set(kinds)
    rep = report.build_report_dir(str(run))
    assert rep["serving_latency_ms"]["rows"] == 3
    # A serving SLO no forward meets: the alert is active at the end, exit 2.
    assert cli.main(argv + ["--alert-rules", "serving_p99_ms>0.000001"]) == 2
    assert "serving_alerts_active" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="needs --run-dir"):
        cli.main(["infer", "--checkpoint-dir", str(port_run / "ck"), "--device",
                  "cpu", "--alert-rules", "serving_p99_ms>1", parts[0]])
