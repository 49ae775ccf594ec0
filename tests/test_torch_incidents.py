"""The port's incident plane against the JAX package's, on the CPU.

Each test drives both packages with the same inputs and compares what
they decide and write, exactly:

- ``obs/stacksampler.py``: the folded text and its parse on a seeded
  profile; the live sampler naming a busy thread and never itself, and
  stopping at its hard deadline with the partial profile kept.
- ``obs/incidents.py``: one event sequence through both
  ``IncidentManager``s, step by step (the real alert funnel
  ``alerts.fire`` → the event tap; the supervisor's one-shot
  ``gate_regression``; a replica-loss storm), giving the same opened,
  closed, suppressed and one-shot decisions, the same force-all flag and
  the same bundle inventory; the bundle's pieces; going dark on a failed
  write; pruning; damaged bundles named by ``load_bundle``, and
  ``format_incident`` on one bundle directory.
- ``cli incident`` and the ``incidents_open`` gauge; the ``alerts_active``
  store mirror; the report's ``incidents`` and ``fleet_timeline``
  sections from ``build_report_dir`` on one run directory; the dash's
  incident line; the event registry; the overhead probe's refusal.

A bundle's ids, open times, durations and stack counts are clock
readings; the comparisons drop them, or read one bundle directory with
both packages' readers.
"""

import json
import os
import shutil
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from featurenet_tpu import obs as jax_obs
from featurenet_tpu.cli import main as jax_cli
from featurenet_tpu.obs import alerts as jax_alerts
from featurenet_tpu.obs import dash as jax_dash
from featurenet_tpu.obs import incidents as jax_incidents
from featurenet_tpu.obs import report as jax_report
from featurenet_tpu.obs import stacksampler as jax_stacksampler
from featurenet_tpu.obs import tracing as jax_tracing
from featurenet_tpu.obs import tsdb as jax_tsdb
from featurenet_tpu_torch import cli, obs
from featurenet_tpu_torch.obs import (
    alerts,
    dash,
    incidents,
    report,
    stacksampler,
    tracing,
    tsdb,
)

JAX = SimpleNamespace(name="jax", obs=jax_obs, alerts=jax_alerts,
                      incidents=jax_incidents, tracing=jax_tracing,
                      tsdb=jax_tsdb, stacksampler=jax_stacksampler,
                      report=jax_report, dash=jax_dash, cli=jax_cli)
PORT = SimpleNamespace(name="torch", obs=obs, alerts=alerts,
                       incidents=incidents, tracing=tracing, tsdb=tsdb,
                       stacksampler=stacksampler, report=report, dash=dash,
                       cli=cli.main)
PKGS = (JAX, PORT)
T0 = 1_700_000_000.0

# Clock readings of a bundle's manifest and list entry.
CLOCK_KEYS = ("id", "opened_unix", "opened_time", "duration_s",
              "closed_unix", "pid", "capture")


@pytest.fixture(autouse=True)
def _clean():
    for p in PKGS:
        p.incidents.reset()
        p.alerts.set_store(None)
        p.obs.close_run()
    yield
    for p in PKGS:
        p.incidents.reset()
        p.alerts.set_store(None)
        p.obs.close_run()


def _rule(p):
    return p.alerts.AlertRule("serving_p99_ms", ">", 50.0, "critical")


def _fire(p, value: float = 123.0, window: int = 1, state: str = "fire"):
    """Through the real funnel: ``alerts.fire`` emits the ``alert`` event
    the tap dispatches."""
    p.alerts.fire(_rule(p), value, window, state=state)


def _wait(pred, timeout_s: float = 10.0, what: str = "condition"):
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.02)


def _wait_captured(p, run_dir: str, incident_id: str) -> dict:
    """Until the capture thread wrote the manifest's ``files``."""

    def done():
        b = p.incidents.load_bundle(run_dir, incident_id)
        return bool((b["manifest"] or {}).get("files"))

    _wait(done, 15.0, f"{p.name} capture of {incident_id}")
    return p.incidents.load_bundle(run_dir, incident_id)


def _runs(tmp_path) -> dict:
    """One run directory per package, each with its sink installed."""
    out = {}
    for p in PKGS:
        out[p.name] = str(tmp_path / p.name / "run")
        p.obs.init_run(out[p.name], extra={"cmd": "t"}, process_index=0)
    return out


def _entries(p, run_dir: str) -> list:
    """``list_incidents`` without its clock readings."""
    return [{k: v for k, v in e.items() if k not in CLOCK_KEYS}
            for e in p.incidents.list_incidents(run_dir)]


def _state(p, mgr) -> dict:
    return {"stats": mgr.stats(), "open": mgr.open_count(),
            "force_all": p.tracing.force_all(),
            "module_open": p.incidents.open_count()}


def _event_kinds(run_dir: str) -> list:
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        return [json.loads(ln)["ev"] for ln in fh]


# --- the stack sampler -------------------------------------------------------

def test_stacksampler_names_threads_and_folds_as_jax():
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(100))

    th = threading.Thread(target=spin, name="busy-loop", daemon=True)
    th.start()
    try:
        profiles = {p.name: p.stacksampler.sample_stacks(0.25, hz=100.0)
                    for p in PKGS}
    finally:
        stop.set()
        th.join()
    for prof in profiles.values():
        assert sorted(prof) == ["duration_s", "folded", "samples",
                                "ticks", "truncated"]
        assert prof["samples"] > 0 and prof["ticks"] > 0
        assert not prof["truncated"]
        totals = stacksampler.thread_totals(prof["folded"])
        assert "busy-loop" in totals and "MainThread" not in totals
        busy = [s for s in prof["folded"] if s.startswith("busy-loop;")]
        assert busy and any("spin" in s for s in busy)
    # Each package folds the other's profile alike.
    for prof in profiles.values():
        assert stacksampler.render_folded(prof) == \
            jax_stacksampler.render_folded(prof)


def test_stacksampler_render_parse_roundtrip_as_jax():
    rng = np.random.default_rng(0)
    frames = [f"{f}.py:{g}" for f in "abcdef" for g in ("run", "wait", "f")]
    folded = {}
    for _ in range(40):
        depth = int(rng.integers(1, 6))
        stack = ";".join([f"thread-{int(rng.integers(4))}"]
                         + [frames[int(i)] for i in
                            rng.integers(len(frames), size=depth)])
        folded[stack] = folded.get(stack, 0) + int(rng.integers(1, 50))
    profile = {"folded": folded, "samples": sum(folded.values()),
               "ticks": 9, "duration_s": 1.0, "truncated": False}
    text = stacksampler.render_folded(profile)
    assert text == jax_stacksampler.render_folded(profile)
    counts = [int(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()]
    assert counts == sorted(counts, reverse=True)
    for raw in (text, "garbage\n" + text + "torn tail x"):
        assert stacksampler.parse_folded(raw) == \
            jax_stacksampler.parse_folded(raw) == folded
    assert stacksampler.thread_totals(folded) == \
        jax_stacksampler.thread_totals(folded)
    assert stacksampler.render_folded({"folded": {}}) == "" == \
        jax_stacksampler.render_folded({"folded": {}})


def test_stacksampler_hard_deadline_keeps_partial_profile_as_jax():
    for p in PKGS:
        t0 = time.monotonic()
        profile = p.stacksampler.sample_stacks(5.0, hz=50.0, max_wall_s=0.2)
        assert time.monotonic() - t0 < 2.0
        assert profile["truncated"] and profile["duration_s"] < 5.0


# --- the manager through the alert funnel ------------------------------------

def test_incident_lifecycle_flap_damping_and_cooldown_as_jax(tmp_path):
    """One event sequence, step by step through both managers: the same
    opens, suppressions, closes and force-all flag after every step."""
    runs = _runs(tmp_path)
    mgrs = {p.name: p.incidents.arm(runs[p.name], cooldown_s=0.4,
                                    sample_s=0.05) for p in PKGS}
    for p in PKGS:
        assert p.incidents.arm(runs[p.name]) is mgrs[p.name]
        assert p.incidents.manager() is mgrs[p.name]
    trail = {p.name: [] for p in PKGS}

    def step(fn):
        for p in PKGS:
            fn(p)
            trail[p.name].append(_state(p, mgrs[p.name]))

    step(lambda p: _fire(p))                            # opens
    step(lambda p: _fire(p, 200.0, 2))                  # already open
    ids = {p.name: mgrs[p.name].open_ids()[0] for p in PKGS}
    bundles = {p.name: _wait_captured(p, runs[p.name], ids[p.name])
               for p in PKGS}
    step(lambda p: _fire(p, 1.0, 3, state="resolve"))   # closes
    step(lambda p: _fire(p))                            # cooldown damps it
    time.sleep(0.45)
    step(lambda p: _fire(p))                            # opens again
    step(lambda p: _fire(p, state="resolve"))
    for p in PKGS:
        p.incidents.disarm(mgrs[p.name])
        trail[p.name].append(_state(p, mgrs[p.name]))
    assert trail["torch"] == trail["jax"]
    opened = [s["stats"]["opened_total"] for s in trail["torch"]]
    assert opened == [1, 1, 1, 1, 2, 2, 2]
    assert [s["force_all"] for s in trail["torch"]] == \
        [True, True, False, False, True, False, False]
    assert _entries(PORT, runs["torch"]) == _entries(JAX, runs["jax"])
    assert len(_entries(PORT, runs["torch"])) == 2
    man, jman = (bundles[k]["manifest"] for k in ("torch", "jax"))
    assert {k: v for k, v in man.items() if k not in CLOCK_KEYS} == \
        {k: v for k, v in jman.items() if k not in CLOCK_KEYS}
    assert man["pid"] == os.getpid() and man["state"] == "open"
    assert set(man["files"]) == set(incidents.BUNDLE_FILES) == \
        set(jax_incidents.BUNDLE_FILES)
    for p in PKGS:
        p.obs.close_run()
    kinds = {k: _event_kinds(r) for k, r in runs.items()}
    assert kinds["torch"] == kinds["jax"]
    assert kinds["torch"].count("incident_open") == 2
    assert kinds["torch"].count("incident_close") == 2
    assert "incident_capture" in kinds["torch"]


def test_incident_bundle_contents_as_jax(tmp_path):
    runs = _runs(tmp_path)
    roster = {"generation": 3, "world_size": 2, "members": [0, 1],
              "min_world_size": 1, "reason": "test", "ready": []}
    got = {}
    for p in PKGS:
        run_dir = runs[p.name]
        store = p.tsdb.TimeSeriesStore.open(run_dir)
        now = time.time()
        for i in range(10):
            store.append("serving_ms", 100.0 + i,
                         {"q": "0.99", "replica": "0"}, t=now - 10 + i)
        store.close()
        with open(os.path.join(run_dir, "membership.json"), "w") as fh:
            json.dump(roster, fh)
        for _ in range(40):
            p.obs.emit("probe", n=1)
        mgr = p.incidents.arm(run_dir, sample_s=0.1, lookback_s=300.0)
        _fire(p)
        (inc_id,) = mgr.open_ids()
        b = _wait_captured(p, run_dir, inc_id)
        _fire(p, state="resolve")
        p.incidents.disarm(mgr)
        got[p.name] = (inc_id, b)
    (pid, b), (jid, jb) = got["torch"], got["jax"]
    assert b["missing"] == jb["missing"] == []
    assert b["roster"] == jb["roster"] == roster
    assert b["tsdb"]["lookback_s"] == jb["tsdb"]["lookback_s"] == 300.0
    assert [(s["metric"], s["labels"], [v for _, v in s["samples"]])
            for s in b["tsdb"]["series"]] == \
        [(s["metric"], s["labels"], [v for _, v in s["samples"]])
         for s in jb["tsdb"]["series"]]
    assert b["windows"] == jb["windows"]
    # The capture thread reads the stream while the firing thread writes
    # the alert and incident_open lines: those two race in both packages.
    racing = {"alert", "incident_open"}
    for tail in (b["events_tail"], jb["events_tail"]):
        assert {r["ev"] for r in tail} - racing == {"run_start", "probe"}
    assert [(r["ev"], r["stream"]) for r in b["events_tail"]
            if r["ev"] not in racing] == \
        [(r["ev"], r["stream"]) for r in jb["events_tail"]
         if r["ev"] not in racing]
    assert sum(r["ev"] == "probe" for r in b["events_tail"]) == 40
    assert stacksampler.thread_totals(b["stacks"])
    assert b["manifest"]["capture"]["stack_samples"] == sum(b["stacks"].values())
    # Both readers on one bundle directory: the same dict and post-mortem.
    for run_dir, inc_id in ((runs["torch"], pid), (runs["jax"], jid)):
        one = incidents.load_bundle(run_dir, inc_id)
        assert one == jax_incidents.load_bundle(run_dir, inc_id)
        text = incidents.format_incident(one)
        assert text == jax_incidents.format_incident(one)
        assert inc_id in text and "tsdb slice: " in text
        assert "roster: 2 member(s)" in text and "stacks: " in text
        assert "missing:" not in text


def test_one_shot_gate_regression_and_loss_storm_as_jax(tmp_path):
    runs = _runs(tmp_path)
    mgrs = {p.name: p.incidents.arm(runs[p.name], sample_s=0.05) for p in PKGS}
    trail = {p.name: [] for p in PKGS}
    for p in PKGS:
        p.obs.emit("supervisor", phase="gate_regression",
                   failed=["mfu", "value"])
    for p in PKGS:
        m = mgrs[p.name]
        _wait(lambda: m.open_count() == 0 and m.stats()["opened_total"] == 1,
              what="gate_regression capture and close")
        trail[p.name].append(_entries(p, runs[p.name]))
        (entry,) = p.incidents.list_incidents(runs[p.name])
        b = p.incidents.load_bundle(runs[p.name], entry["id"])
        trail[p.name].append(b["manifest"]["failed"])
        trail[p.name].append("one-shot capture" in
                             p.incidents.format_incident(b))
    for slot in (0, 1):  # two losses are business as usual
        for p in PKGS:
            p.obs.emit("fleet_replica_loss", slot=slot, inflight=0)
            trail[p.name].append(mgrs[p.name].stats())
    for p in PKGS:  # the third in the window is a storm
        p.obs.emit("fleet_replica_loss", slot=0, inflight=0)
    for p in PKGS:
        m = mgrs[p.name]
        _wait(lambda: m.stats()["opened_total"] == 2 and m.open_count() == 0,
              what="storm capture and close")
        trail[p.name].append(_entries(p, runs[p.name]))
        p.incidents.disarm(m)
    assert trail["torch"] == trail["jax"]
    gate, failed, one_shot = trail["torch"][:3]
    assert gate == [{"rule": "gate_regression", "severity": "critical",
                     "state": "closed", "value": 2.0, "threshold": 0.0,
                     "one_shot": True}]
    assert failed == ["mfu", "value"] and one_shot
    storm = [e for e in trail["torch"][-1] if e["rule"] == "replica_loss_storm"]
    assert len(storm) == 1 and storm[0]["value"] == 3.0


def test_manager_goes_dark_on_bundle_write_failure_as_jax(tmp_path, capsys):
    runs = _runs(tmp_path)
    mgrs = {}
    for p in PKGS:
        # incidents/ is a file: every bundle's makedirs fails.
        with open(p.incidents.incidents_dir(runs[p.name]), "w") as fh:
            fh.write("not a directory")
        mgrs[p.name] = p.incidents.arm(runs[p.name], sample_s=0.05)
        _fire(p)
    for p in PKGS:
        m = mgrs[p.name]
        _wait(lambda: m.stats()["dark"], what="go-dark")
    err = capsys.readouterr().err
    warns = [json.loads(ln) for ln in err.splitlines() if "incident_error" in ln]
    assert sorted(w["dir"] for w in warns) == sorted(m.dir for m in
                                                    mgrs.values())
    assert len({w["incident_error"].split(" (")[0] for w in warns}) == 1
    for p in PKGS:
        _fire(p, state="resolve")
    time.sleep(0.45)
    for p in PKGS:
        _fire(p)
    st = {k: m.stats() for k, m in mgrs.items()}
    assert st["torch"] == st["jax"]
    assert st["torch"]["opened_total"] == 1 and st["torch"]["dropped"] >= 1
    for p in PKGS:
        p.incidents.disarm(mgrs[p.name])


def test_bundle_pruning_keeps_newest_as_jax(tmp_path):
    runs = _runs(tmp_path)
    mgrs = {p.name: p.incidents.arm(runs[p.name], cooldown_s=0.0,
                                    sample_s=0.02, max_bundles=2)
            for p in PKGS}
    for i in range(4):
        for p in PKGS:
            _fire(p, 100.0 + i, i)
            (inc_id,) = mgrs[p.name].open_ids()
            _wait_captured(p, runs[p.name], inc_id)
            _fire(p, window=i, state="resolve")
        time.sleep(0.002)  # distinct millisecond ids
    for p in PKGS:
        p.incidents.disarm(mgrs[p.name])
    kept = {p.name: _entries(p, runs[p.name]) for p in PKGS}
    assert kept["torch"] == kept["jax"]
    assert [e["value"] for e in kept["torch"]] == [102.0, 103.0]


# --- damaged bundles and cli incident -----------------------------------------

def _one_closed_incident(p, run_dir: str) -> str:
    mgr = p.incidents.arm(run_dir, sample_s=0.05)
    _fire(p)
    (inc_id,) = mgr.open_ids()
    _wait_captured(p, run_dir, inc_id)
    _fire(p, state="resolve")
    p.incidents.disarm(mgr)
    return inc_id


def _cli_out(p, argv, capsys):
    """One package's ``cli`` stdout, or its SystemExit message."""
    try:
        p.cli(argv)
    except SystemExit as e:
        return ("exit", str(e), capsys.readouterr().out)
    return ("ok", capsys.readouterr().out)


def test_degraded_bundles_name_whats_missing_as_jax(tmp_path, capsys):
    run_dir = str(tmp_path / "run")
    obs.init_run(run_dir, extra={"cmd": "t"}, process_index=0)
    inc_id = _one_closed_incident(PORT, run_dir)
    obs.close_run()
    bundle = os.path.join(incidents.incidents_dir(run_dir), inc_id)
    # A torn manifest, a pruned store slice, vanished stacks.
    with open(os.path.join(bundle, "manifest.json"), "w") as fh:
        fh.write('{"id": "torn...')
    os.unlink(os.path.join(bundle, "tsdb.json"))
    os.unlink(os.path.join(bundle, "stacks.folded"))
    b = incidents.load_bundle(run_dir, inc_id)
    assert b == jax_incidents.load_bundle(run_dir, inc_id)
    assert "manifest.json (torn/unparseable JSON)" in b["missing"]
    assert "tsdb.json (absent)" in b["missing"]
    assert "stacks.folded (absent)" in b["missing"]
    assert incidents.list_incidents(run_dir) == \
        jax_incidents.list_incidents(run_dir) == \
        [{"id": inc_id, "state": "damaged"}]
    for argv in (["incident", "show", run_dir, inc_id],
                 ["incident", "list", run_dir]):
        out = _cli_out(PORT, argv, capsys)
        assert out == _cli_out(JAX, argv, capsys)
    show = _cli_out(PORT, ["incident", "show", run_dir, inc_id], capsys)[1]
    assert "missing:" in show and "tsdb.json (absent)" in show
    assert "state=damaged" in _cli_out(PORT, ["incident", "list", run_dir],
                                       capsys)[1]


def test_cli_incident_empty_and_unknown_as_jax(tmp_path, capsys):
    run_dir = str(tmp_path / "empty")
    os.makedirs(run_dir)
    outs = []
    for argv in (["incident", "list", run_dir],
                 ["incident", "list", run_dir, "--json"],
                 ["incident", "show", run_dir],
                 ["incident", "show", run_dir, "inc-x"]):
        out = _cli_out(PORT, argv, capsys)
        assert out == _cli_out(JAX, argv, capsys)
        outs.append(out)
    assert "no incident bundles" in outs[0][1]
    assert outs[2][0] == "exit" and "no bundles" in outs[2][1]
    assert outs[3][0] == "exit" and "no bundle 'inc-x'" in outs[3][1]


def test_cli_incident_show_json_and_latest_default_as_jax(tmp_path, capsys):
    run_dir = str(tmp_path / "run")
    obs.init_run(run_dir, extra={"cmd": "t"}, process_index=0)
    inc_id = _one_closed_incident(PORT, run_dir)
    obs.close_run()
    outs = []
    for argv in (["incident", "show", run_dir],
                 ["incident", "show", run_dir, inc_id, "--json"],
                 ["incident", "list", run_dir, "--json"],
                 ["incident", "list", run_dir]):
        out = _cli_out(PORT, argv, capsys)
        assert out == _cli_out(JAX, argv, capsys)
        outs.append(out[1])
    assert inc_id in outs[0]
    b = json.loads(outs[1])
    assert b["id"] == inc_id and b["missing"] == []
    (entry,) = json.loads(outs[2])
    assert entry["id"] == inc_id and entry["state"] == "closed"


# --- the store mirror, /metrics, the report, the dash -------------------------

def test_alerts_active_mirror_series_as_jax(tmp_path):
    got = {}
    for p in PKGS:
        run_dir = str(tmp_path / p.name)
        store = p.tsdb.TimeSeriesStore.open(run_dir)
        p.alerts.set_store(store)
        try:
            p.alerts.fire(_rule(p), 123.0, 1, state="fire")
            p.alerts.fire(_rule(p), 1.0, 2, state="resolve")
        finally:
            p.alerts.set_store(None)
            store.close()
        p.alerts.fire(_rule(p), 99.0, 3, state="fire")  # detached: nothing
        got[p.name] = run_dir
    for reader in (tsdb, jax_tsdb):
        vals = {k: [v for _t, v in reader.TimeSeriesStore.open(d).query(
                    "alerts_active", {"rule": "serving_p99_ms"},
                    since_s=3600.0)] for k, d in got.items()}
        assert vals["torch"] == vals["jax"] == [1.0, 0.0]
    assert sorted(os.listdir(tsdb.store_dir(got["torch"]))) == \
        sorted(os.listdir(jax_tsdb.store_dir(got["jax"])))


def test_metrics_export_incidents_open_gauge(tmp_path):
    from featurenet_tpu.serve import metrics as jax_metrics
    from featurenet_tpu_torch.serve import metrics

    assert "incidents_open" in metrics.METRIC_NAMES
    assert "alerts_active" in metrics.METRIC_NAMES
    assert metrics._help_for("alerts_active") == \
        jax_metrics._help_for("alerts_active")
    stub = SimpleNamespace(
        cfg=SimpleNamespace(serve_precision="fp32",
                            arch=SimpleNamespace(conv_backend="reference")),
        health=lambda: {"ready": True, "uptime_s": 1.0, "window_seq": 0},
        stats=lambda: {"served": 0, "rejected": 0, "errors": 0,
                       "queue_depth": 0, "occupancy": 0.0},
    )

    def gauges():
        return [[ln for ln in m.render_metrics(stub).splitlines()
                 if ln.startswith("featurenet_incidents_open ")]
                for m in (metrics, jax_metrics)]

    lines = [gauges()]
    runs = _runs(tmp_path)
    mgrs = {p.name: p.incidents.arm(runs[p.name], sample_s=0.05) for p in PKGS}
    for p in PKGS:
        _fire(p)
    lines.append(gauges())
    for p in PKGS:
        _fire(p, state="resolve")
    lines.append(gauges())
    for p in PKGS:
        p.incidents.disarm(mgrs[p.name])
    assert [port for port, _ in lines] == [ref for _, ref in lines]
    assert [port for port, _ in lines] == [["featurenet_incidents_open 0"],
                                           ["featurenet_incidents_open 1"],
                                           ["featurenet_incidents_open 0"]]


def test_report_incidents_section_as_jax(tmp_path):
    """The report's ``incidents`` and ``fleet_timeline`` sections of one
    run directory (its events, its bundles, its store) in both."""
    run_dir = str(tmp_path / "run")
    obs.init_run(run_dir, extra={"cmd": "t"}, process_index=0)
    inc_id = _one_closed_incident(PORT, run_dir)
    obs.close_run()
    store = tsdb.TimeSeriesStore.open(run_dir)
    for i in range(8):
        store.append("serving_ms", 10.0 + i * i, {"q": "0.99", "replica": "0"},
                     t=T0 + i)
    store.append("scrape_failures_total", 2.0, {"replica": "router"}, t=T0)
    store.close()
    events, bad = report.load_events(run_dir)
    assert (events, bad) == jax_report.load_events(run_dir)
    rep = report.build_report(events)
    jrep = jax_report.build_report(events)
    assert rep["incidents"] == jrep["incidents"]
    sec = rep["incidents"]
    assert sec["opened"] == 1 and sec["closed"] == 1
    assert sec["by_rule"] == {"serving_p99_ms": 1} and sec["still_open"] == []
    rep_d = report.build_report_dir(run_dir)
    jrep_d = jax_report.build_report_dir(run_dir)
    for key in ("incidents", "fleet_timeline"):
        assert rep_d[key] == jrep_d[key]
    (bundle,) = rep_d["incidents"]["bundles"]
    assert bundle["id"] == inc_id
    assert rep_d["fleet_timeline"]["targets"]["0"]["samples"] == 8

    def lines_of(text):
        """The rendering's incident and fleet-timeline lines."""
        heads = ("incidents:", "fleet timeline", "  inc-", "  0 ")
        return [ln for ln in text.splitlines() if ln.startswith(heads)]

    text = report.format_report(rep_d)
    assert lines_of(text) == lines_of(jax_report.format_report(jrep_d))
    assert len(lines_of(text)) == 4
    assert "incidents: 1 opened, 1 closed" in text and inc_id in text
    # An open without its close renders STILL OPEN in both.
    open_only = [e for e in events if e["ev"] != "incident_close"]
    r2, j2 = report.build_report(open_only), jax_report.build_report(open_only)
    assert r2["incidents"] == j2["incidents"]
    assert r2["incidents"]["still_open"] == [inc_id]
    text = report.format_report(r2)
    assert lines_of(text) == lines_of(jax_report.format_report(j2))
    assert "STILL OPEN" in text


def test_dash_incident_line_as_jax(tmp_path, capsys):
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    frame = dash.render_frame(empty, now=T0)
    assert frame == jax_dash.render_frame(empty, now=T0)
    assert "incidents: none recorded" in frame
    assert _cli_out(PORT, ["dash", empty, "--once"], capsys) == \
        _cli_out(JAX, ["dash", empty, "--once"], capsys)
    run_dir = str(tmp_path / "run")
    obs.init_run(run_dir, extra={"cmd": "t"}, process_index=0)
    store = tsdb.TimeSeriesStore.open(run_dir)
    store.append("ready", 1.0, {"replica": "0"}, t=T0)
    store.close()
    inc_id = _one_closed_incident(PORT, run_dir)
    obs.close_run()
    frame = dash.render_frame(run_dir, now=T0)
    assert frame == jax_dash.render_frame(run_dir, now=T0)
    assert (f"incidents: 0 open · 1 recent · last {inc_id} "
            f"(serving_p99_ms, closed)") in frame
    # A bundle a JAX run wrote reads the same in the port's dash.
    shutil.copytree(run_dir, str(tmp_path / "copy"))
    assert dash._incident_line(str(tmp_path / "copy")) == \
        jax_dash._incident_line(run_dir)


# --- the service's manager ------------------------------------------------------

def test_service_arms_the_manager_and_drain_disarms_it_as_jax(tmp_path):
    """A service with a run directory arms the incident manager; a drain
    whose last window cycle fires the serving rule opens an incident,
    reports the manager's counters and disarms it, in both packages."""
    import jax
    import torch

    from featurenet_tpu import infer as jax_infer
    from featurenet_tpu.config import get_config as jax_get_config
    from featurenet_tpu.obs import windows as jax_windows
    from featurenet_tpu.runtime import Runtime
    from featurenet_tpu.serve.service import InferenceService as JaxService
    from featurenet_tpu_torch import infer
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data import synthetic
    from featurenet_tpu_torch.obs import windows
    from featurenet_tpu_torch.serve.service import InferenceService

    jcfg = jax_get_config("smoke16")
    jstate = Runtime(jcfg, cache=None).build("init")(jax.random.key(0))
    grids = synthetic.generate_batch(np.random.default_rng(5), 4,
                                     16)["voxels"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    got = {}
    try:
        for p in PKGS:
            run_dir = str(tmp_path / p.name / "run")
            p.obs.init_run(run_dir, extra={"cmd": "serve"}, process_index=0)
            if p is PORT:
                pred = infer.Predictor.from_seed(get_config("smoke16"), 0,
                                                 batch=1, device="cpu")
                Svc, win = InferenceService, windows
            else:
                pred = jax_infer.Predictor(jstate.params, jstate.batch_stats,
                                           jcfg, batch=1)
                Svc, win = JaxService, jax_windows
            rule = p.alerts.AlertRule("serving_p99_ms", ">", 0.0, "critical")
            svc = Svc(pred, buckets=(1,), max_wait_ms=0.0, rules=[rule],
                      run_dir=run_dir)
            armed = p.incidents.manager()
            assert armed is not None and armed.run_dir == run_dir
            for i, g in enumerate(grids):
                svc.predict(svc.submit_voxels(g, trace_id=f"req-{i}"), 60)
            st = svc.drain()
            got[p.name] = {
                "incidents": st["incidents"],
                "exit_code": st["exit_code"],
                "active": st["active_serving_alerts"],
                "manager": p.incidents.manager(),
                "force_all": p.tracing.force_all(),
                # The trigger's value is the run's own p99 latency.
                "entries": [{k: v for k, v in e.items() if k != "value"}
                            for e in _entries(p, run_dir)],
            }
            p.obs.close_run()
            got[p.name]["kinds"] = [k for k in _event_kinds(run_dir)
                                    if k.startswith(("incident", "alert"))]
            win.uninstall()
    finally:
        torch.set_num_threads(threads)
    assert got["torch"] == got["jax"]
    assert got["torch"]["incidents"] == {"open": 1, "opened_total": 1,
                                         "dropped": 0, "dark": False}
    assert got["torch"]["manager"] is None and not got["torch"]["force_all"]
    # The tap runs before the alert's own write; disarm closes the
    # incident, then joins the capture thread.
    assert got["torch"]["kinds"] == ["incident_open", "alert",
                                     "incident_close", "incident_capture"]


# --- registries and the overhead probe's precondition --------------------------

def test_incident_kinds_in_event_registry_as_jax():
    for kind in ("incident_open", "incident_capture", "incident_close"):
        assert kind in report.KNOWN_EVENT_KINDS
        assert report.REQUIRED_EVENT_FIELDS[kind] == \
            jax_report.REQUIRED_EVENT_FIELDS[kind]
    assert report.REQUIRED_EVENT_FIELDS["incident_open"] == (
        "id", "rule", "severity", "value")


def test_incident_overhead_probe_refuses_active_run(tmp_path):
    from featurenet_tpu.serve.loadgen import (
        measure_incident_overhead as jax_probe,
    )
    from featurenet_tpu_torch.serve.loadgen import measure_incident_overhead

    for p, probe in ((PORT, measure_incident_overhead), (JAX, jax_probe)):
        p.obs.init_run(str(tmp_path / p.name), extra={"cmd": "t"},
                       process_index=0)
        with pytest.raises(RuntimeError, match="close_run"):
            probe(None)
        assert p.obs.active()  # the refusal left the caller's run alone
        p.obs.close_run()
