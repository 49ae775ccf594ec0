"""The port's time-series store, burn-rate objectives, ``cli dash`` and the
report's fleet timeline against the JAX package's, on the CPU.

- ``obs/tsdb.py``: the same appends, made from a seed, write the same
  segment files byte for byte in both packages; each package reads the
  other's store; ``query``, ``percentile``, ``latest``, ``series`` and
  ``stats`` agree; rotation, resume, pruning, the torn-tail reader, the
  dark writer and its drop counter under concurrent appends behave as the
  reference's.
- ``obs/alerts.py``'s burn half: ``parse_slos`` (rules and refusals),
  ``burn_selector``, ``burn_rate`` on seeded samples and the
  ``BurnEvaluator``'s fire/resolve sequence and ``alert`` events.
- ``obs/dash.py``: ``render_frame(now=...)`` on one store, and ``cli dash
  --once`` on one run directory with the clock pinned.
- ``obs/report.py``'s ``fleet_timeline_section(now=...)`` on one store.

Every comparison is exact (the only arithmetic is the reference's own
``round``). The reference modules are standard library only and run as
they are.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

from featurenet_tpu import obs as jax_obs
from featurenet_tpu.cli import main as jax_cli
from featurenet_tpu.obs import alerts as jax_alerts
from featurenet_tpu.obs import dash as jax_dash
from featurenet_tpu.obs import report as jax_report
from featurenet_tpu.obs import tsdb as jax_tsdb
from featurenet_tpu_torch import cli, obs
from featurenet_tpu_torch.obs import alerts, dash, report, tsdb

T0 = 1_700_000_000.0  # every series test pins `now` to this epoch anchor
PKGS = (("jax", jax_tsdb), ("torch", tsdb))


@pytest.fixture(autouse=True)
def _clean():
    for mod in (obs, jax_obs):
        mod.close_run()
    for mod in (alerts, jax_alerts):
        mod.set_store(None)
    yield
    for mod in (alerts, jax_alerts):
        mod.set_store(None)
    for mod in (obs, jax_obs):
        mod.close_run()


def _files(root: str) -> dict:
    """Every segment of a store: name → bytes."""
    out = {}
    for n in sorted(os.listdir(root)):
        with open(os.path.join(root, n), "rb") as fh:
            out[n] = fh.read()
    return out


def _appends(seed: int, n: int = 60) -> list:
    """A seeded sequence of (metric, value, labels, t) appends over a few
    series, with unsafe characters and unsorted label dicts."""
    rng = np.random.default_rng(seed)
    metrics = ("serving_ms", "ready", "serve_queue_depth", "bad name")
    out = []
    for i in range(n):
        m = metrics[int(rng.integers(len(metrics)))]
        labels = {"replica": str(int(rng.integers(3)))}
        if m == "serving_ms":
            labels = {"q": ("0.5", "0.99")[int(rng.integers(2))], **labels}
        if m == "bad name":
            labels = {"k/": "a b"}
        out.append((m, float(np.round(rng.exponential(40.0), 6)), labels,
                    T0 + i * 0.5 + float(rng.uniform(0, 0.4))))
    return out


def _reads(store, now: float) -> dict:
    """Every read of a store, with ``now`` pinned."""
    out = {"series": store.series(), "stats": store.stats()}
    for metric, labels in store.series():
        key = tsdb.series_key(metric, labels)
        out[key] = {
            "all": store.query(metric, labels),
            "recent": store.query(metric, labels, since_s=10.0, now=now),
            "latest": store.latest(metric, labels),
            "p": [store.percentile(metric, q, labels) for q in
                  (0, 1, 50, 90, 99, 100)],
        }
    out["merged"] = store.query("serving_ms", {"q": "0.99"})
    out["by_replica"] = store.query("serving_ms", {"replica": "0"},
                                    since_s=5.0, now=now)
    out["none"] = (store.latest("nope"), store.query("nope"),
                   store.percentile("serving_ms", 50, {"q": "0.95"}))
    return out


# --- the store ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_tsdb_append_query_roundtrip_matches_jax(tmp_path, seed):
    """The same appends write the same bytes; every read agrees, and each
    package reads the other's store the same."""
    seq = _appends(seed)
    stores = {}
    for name, mod in PKGS:
        store = mod.TimeSeriesStore(str(tmp_path / name))
        for m, v, lb, t in seq:
            assert store.append(m, v, lb, t=t)
        stores[name] = store
    assert _files(str(tmp_path / "torch")) == _files(str(tmp_path / "jax"))
    now = seq[-1][3]
    reads = {k: _reads(s, now) for k, s in stores.items()}
    assert reads["torch"] == reads["jax"]
    assert reads["torch"]["stats"]["appended"] == len(seq)
    for s in stores.values():
        s.close()
    # Each package's reader over the other's directory.
    cross = {
        "torch_reads_jax": _reads(tsdb.TimeSeriesStore(str(tmp_path / "jax")),
                                  now),
        "jax_reads_torch": _reads(jax_tsdb.TimeSeriesStore(
            str(tmp_path / "torch")), now),
    }
    for got in cross.values():
        got.pop("stats")
        want = dict(reads["jax"])
        want.pop("stats")
        assert got == want


def test_tsdb_percentile_is_nearest_rank_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    vals = rng.normal(50.0, 20.0, 101).round(4).tolist()
    got = {}
    for name, mod in PKGS:
        store = mod.TimeSeriesStore(str(tmp_path / name))
        for i, v in enumerate(vals):
            store.append("serving_ms", v, {"q": "0.5"}, t=T0 + i)
        got[name] = [store.percentile("serving_ms", q, {"q": "0.5"})
                     for q in (0, 10, 25, 50, 75, 90, 95, 99, 100)]
        got[name].append(store.percentile("serving_ms", 99, {"q": "0.95"}))
        got[name].append(store.percentile("serving_ms", 50, {"q": "0.5"},
                                          since_s=10.0, now=T0 + 100))
        store.close()
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == sorted(vals)[50]
    assert got["torch"][9] is None


@pytest.mark.parametrize("metric,labels", [
    ("serving_ms", {"replica": "0", "q": "0.99"}),
    ("bad name", {"k/": "a b"}),
    ("ready", None),
    ("alerts_active", {"rule": "serving_p99_ms"}),
    ("x;y", {"é": "v=1", "z": "2.5"}),
])
def test_tsdb_series_key_roundtrip_and_sanitize_as_jax(metric, labels):
    key = tsdb.series_key(metric, labels)
    assert key == jax_tsdb.series_key(metric, labels)
    assert tsdb.parse_series_key(key) == jax_tsdb.parse_series_key(key)
    if labels:
        assert tsdb.series_key(metric, dict(reversed(list(labels.items())))) \
            == key


def test_tsdb_reader_skips_torn_tail_and_garbage_as_jax(tmp_path):
    got = {}
    for name, mod in PKGS:
        root = str(tmp_path / name)
        store = mod.TimeSeriesStore(root)
        for i in range(3):
            store.append("ready", 1.0, {"replica": "0"}, t=T0 + i)
        store.close()
        (seg,) = [os.path.join(root, n) for n in os.listdir(root)]
        with open(seg, "ab") as fh:
            fh.write(b"not json at all\n")         # a foreign line
            fh.write(b'{"t":' + str(T0).encode())  # a torn tail
        before = store.query("ready", {"replica": "0"})
        # A reopened writer terminates the tear and appends past it.
        store2 = mod.TimeSeriesStore(root)
        store2.append("ready", 0.0, {"replica": "0"}, t=T0 + 9)
        got[name] = (before, store2.query("ready"))
        store2.close()
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0]) == 3
    assert got["torch"][1][-1] == (T0 + 9, 0.0)
    assert _files(str(tmp_path / "torch")) == _files(str(tmp_path / "jax"))


def test_tsdb_rotation_resume_and_prune_as_jax(tmp_path):
    got = {}
    for name, mod in PKGS:
        root = str(tmp_path / name / "ts")
        store = mod.TimeSeriesStore(root, segment_bytes=64, max_bytes=10**9)
        for i in range(10):
            store.append("ready", float(i), t=T0 + i)
        segs = sorted(os.listdir(root))
        store.close()
        # A reopened store resumes the highest segment.
        store2 = mod.TimeSeriesStore(root, segment_bytes=64, max_bytes=10**9)
        store2.append("ready", 10.0, t=T0 + 10)
        resumed = (sorted(os.listdir(root)) == segs, store2.query("ready"))
        store2.close()
        files = _files(root)
        # A tight byte budget drops the oldest closed segments on rotation.
        pstore = mod.TimeSeriesStore(str(tmp_path / name / "pruned"),
                                     segment_bytes=64, max_bytes=150)
        for i in range(30):
            pstore.append("ready", float(i), t=T0 + i)
        pruned = [v for _, v in pstore.query("ready")]
        pstore.close()
        got[name] = (segs, resumed, files, pruned)
    assert got["torch"] == got["jax"]
    segs, resumed, _, pruned = got["torch"]
    assert len(segs) > 1 and resumed[0]
    assert pruned[-1] == 29.0 and len(pruned) < 30 and 0.0 not in pruned


def test_tsdb_goes_dark_on_oserror_as_jax(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    got = {}
    for name, mod in PKGS:
        store = mod.TimeSeriesStore(str(blocker / name))
        results = [store.append("ready", 1.0), store.append("ready", 1.0)]
        got[name] = (results, store.stats(), store.query("ready"))
        store.close()
    assert got["torch"] == got["jax"]
    results, st, samples = got["torch"]
    assert results == [False, False] and samples == []
    assert st["dark"] and st["dropped"] == 2 and st["appended"] == 0


def test_tsdb_drop_counter_exact_under_concurrent_appends_as_jax(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    n_threads, per_thread = 8, 200
    got = {}
    for name, mod in PKGS:
        store = mod.TimeSeriesStore(str(blocker / name))
        store.append("ready", 1.0)  # trips the dark latch

        def hammer():
            for i in range(per_thread):
                store.append("ready", float(i))

        threads = [threading.Thread(target=hammer, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        got[name] = store.stats()
        store.close()
    assert got["torch"] == got["jax"]
    assert got["torch"]["dropped"] == 1 + n_threads * per_thread
    assert got["torch"]["appended"] == 0


# --- burn-rate objectives -------------------------------------------------------

@pytest.mark.parametrize("spec,windows", [
    ("serving_p99_ms<250@99%", {}),
    ("queue_wait_ms_p95<50@95%:warning", {"fast_s": 30.0, "slow_s": 600.0}),
    (None, {"fast_s": 5.0, "slow_s": 60.0}),
    ("", {}),
    ("serving_ms_p50>1e2@90%:info, confidence_p99>0.2@50%", {}),
    ("serving_p99_ms=250@99%", {}),
    ("made_up_metric<250@99%", {}),
    ("serving_p99_ms<250@99%,serving_p99_ms<9@50%", {}),
    ("serving_p99_ms<250@100%", {}),
    ("serving_p99_ms<250@99%:fatal", {}),
    ("serving_p99_ms<1.2.3@99%", {}),
    (",", {}),
])
def test_parse_slos_accepts_and_refuses_as_jax(spec, windows):
    try:
        want = [dataclasses.asdict(r) for r in
                jax_alerts.parse_slos(spec, **windows)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            alerts.parse_slos(spec, **windows)
        assert str(got.value) == str(e)
        return
    rules = alerts.parse_slos(spec, **windows)
    assert [dataclasses.asdict(r) for r in rules] == want
    assert [(r.budget, r.name) for r in rules] == \
        [(r.budget, r.name) for r in jax_alerts.parse_slos(spec, **windows)]


def test_burn_selector_maps_percentile_stats_as_jax():
    assert alerts.known_burn_metrics() == jax_alerts.known_burn_metrics()
    names = sorted(alerts.known_burn_metrics()) + [
        "serving_ms_mean", "serving_ms_max", "nope_p99", "mfu", "serving_ms"]
    assert [alerts.burn_selector(m) for m in names] == \
        [jax_alerts.burn_selector(m) for m in names]
    assert alerts.burn_selector("serving_p99_ms") == ("serving_ms",
                                                      {"q": "0.99"})
    assert alerts.burn_selector("serving_ms_mean") is None


def test_burn_rate_math_and_honest_absence_as_jax():
    rng = np.random.default_rng(5)
    samples = [(T0 - float(i), float(v)) for i, v in
               enumerate(rng.exponential(80.0, 400).round(3))]
    rules = [(op, thr, obj) for op, thr, obj in
             (("<", 100.0, 0.99), ("<", 250.0, 0.9), (">", 10.0, 0.5))]
    got, want = [], []
    for op, thr, obj in rules:
        r, jr = (mod.BurnRateRule("serving_p99_ms", op, thr, obj)
                 for mod in (alerts, jax_alerts))
        for window, now in ((300.0, T0), (30.0, T0), (3600.0, T0 + 100),
                            (300.0, T0 + 10_000)):
            got.append(alerts.burn_rate(samples, r, window, now=now))
            want.append(jax_alerts.burn_rate(samples, jr, window, now=now))
        got.append([r.bad(v) for _, v in samples[:50]])
        want.append([jr.bad(v) for _, v in samples[:50]])
    assert got == want
    rule = alerts.BurnRateRule("serving_p99_ms", "<", 100.0, 0.99)
    two_bad = [(T0 - i, 50.0) for i in range(98)] + [(T0 - 1, 400.0),
                                                     (T0 - 2, 400.0)]
    assert alerts.burn_rate(two_bad, rule, 300.0, now=T0) == \
        jax_alerts.burn_rate(two_bad, jax_alerts.BurnRateRule(
            "serving_p99_ms", "<", 100.0, 0.99), 300.0, now=T0)
    assert alerts.burn_rate([], rule, 300.0, now=T0) is None


def _alert_records(run_dir: str) -> list:
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        return [{k: v for k, v in json.loads(ln).items()
                 if k not in ("t", "pid")} for ln in fh
                if json.loads(ln)["ev"] == "alert"]


def test_burn_evaluator_fire_resolve_hysteresis_as_jax(tmp_path):
    """One sample sequence through both evaluators: the same verdict each
    pass, the same ``alert`` events."""
    results = {}
    for name, pkg_obs, mod, store_mod in (("jax", jax_obs, jax_alerts,
                                           jax_tsdb),
                                          ("torch", obs, alerts, tsdb)):
        run_dir = str(tmp_path / name / "run")
        pkg_obs.init_run(run_dir, process_index=0)
        store = store_mod.TimeSeriesStore(str(tmp_path / name / "ts"))
        rule = mod.BurnRateRule("serving_p99_ms", "<", 250.0, 0.99,
                                fast_s=10.0, slow_s=60.0)
        ev = mod.BurnEvaluator(store, [rule])
        passes = [ev.evaluate(now=T0)["serving_p99_ms"]]
        for i in range(20):
            store.append("serving_ms", 400.0, {"q": "0.99", "replica": "0"},
                         t=T0 - i)
        passes.append(ev.evaluate(now=T0)["serving_p99_ms"])
        passes.append(ev.active_alerts())
        passes.append(ev.evaluate(now=T0)["serving_p99_ms"])  # no re-fire
        for i in range(20):
            store.append("serving_ms", 50.0, {"q": "0.99", "replica": "0"},
                         t=T0 + 30 + i * 0.4)
        passes.append(ev.evaluate(now=T0 + 40)["serving_p99_ms"])
        passes.append(ev.active_alerts())
        store.close()
        pkg_obs.close_run()
        results[name] = (passes, _alert_records(run_dir))
    assert results["torch"] == results["jax"]
    passes, fired = results["torch"]
    assert passes[0] == {"fast": None, "slow": None, "firing": False,
                         "active": False}
    assert passes[1]["firing"] and passes[2] == ["serving_p99_ms"]
    assert not passes[4]["firing"] and passes[4]["fast"] == 0.0
    assert passes[5] == []
    assert [(r["rule"], r["state"]) for r in fired] == [
        ("serving_p99_ms_burn", "fire"), ("serving_p99_ms_burn", "resolve")]


# --- cli dash and the fleet timeline --------------------------------------------

def _synthetic_fleet_store(mod, run_dir: str, now: float) -> None:
    """The scraper's series for one replica and the router, as the
    reference's dash tests write them."""
    store = mod.TimeSeriesStore.open(run_dir)
    for i in range(10):
        t = now - 10 + i
        store.append("requests_total", i * 5.0,
                     {"outcome": "served", "replica": "0"}, t=t)
        store.append("serving_ms", 20.0 + i,
                     {"q": "0.99", "replica": "0"}, t=t)
        store.append("serve_queue_depth", 1.0, {"replica": "0"}, t=t)
        store.append("fleet_requests_total", i * 9.0,
                     {"outcome": "answered", "replica": "router"}, t=t)
        store.append("serving_ms", 30.0,
                     {"q": "0.99", "replica": "router"}, t=t)
        store.append("confidence", 0.5 + i / 40, {"q": "0.5", "replica": "0"},
                     t=t)
    store.append("ready", 1.0, {"replica": "0"}, t=now)
    store.append("connections_opened_total", 2.0,
                 {"replica": "router"}, t=now)
    store.append("connections_reused_total", 8.0,
                 {"replica": "router"}, t=now)
    store.append("scrape_failures_total", 3.0,
                 {"replica": "router"}, t=now)
    store.close()


@pytest.mark.parametrize("slos", [None, "serving_p99_ms<25@90%,"
                                        "queue_wait_ms_p99<5@99%"])
def test_render_frame_from_store_alone_as_jax(tmp_path, slos):
    runs = {}
    for name, mod in PKGS:
        runs[name] = str(tmp_path / name)
        _synthetic_fleet_store(mod, runs[name], T0)
    assert _files(tsdb.store_dir(runs["torch"])) == \
        _files(tsdb.store_dir(runs["jax"]))
    frame = dash.render_frame(runs["jax"], now=T0, slos=slos)
    assert frame == jax_dash.render_frame(runs["jax"], now=T0, slos=slos)
    assert dash.render_frame(runs["torch"], now=T0, slos=slos,
                             window_s=60.0) == \
        jax_dash.render_frame(runs["torch"], now=T0, slos=slos,
                              window_s=60.0)
    lines = frame.splitlines()
    assert lines[0].startswith(f"fleet dash · {runs['jax']}")
    assert "2 target(s)" in lines[0]
    assert "conn reuse: 0.800 (opened 2, reused 8)" in frame
    assert "roster: 1/1 replicas ready · scrape failures: 3" in frame
    assert "incidents: none recorded" in frame
    # An empty run directory: the friendly empty state, in both.
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert dash.render_frame(empty, now=T0) == \
        jax_dash.render_frame(empty, now=T0)


def test_cli_dash_once_matches_jax(tmp_path, capsys, monkeypatch):
    run_dir = str(tmp_path / "run")
    _synthetic_fleet_store(tsdb, run_dir, T0)
    monkeypatch.setattr(time, "time", lambda: T0)
    assert cli.main(["dash", run_dir, "--once"]) == 0
    port = capsys.readouterr().out
    jax_cli(["dash", run_dir, "--once"])
    assert port == capsys.readouterr().out
    assert port.startswith("fleet dash ·")
    with pytest.raises(SystemExit) as e:
        cli.main(["dash", run_dir, "--once", "--slos", "nope<1@9%"])
    with pytest.raises(SystemExit) as je:
        jax_cli(["dash", run_dir, "--once", "--slos", "nope<1@9%"])
    assert str(e.value) == str(je.value)


def test_fleet_timeline_section_from_store_alone_as_jax(tmp_path):
    assert report.fleet_timeline_section(str(tmp_path / "nowhere")) is None
    assert jax_report.fleet_timeline_section(str(tmp_path / "nowhere")) is None
    run_dir = str(tmp_path / "run")
    _synthetic_fleet_store(tsdb, run_dir, T0)
    sec = report.fleet_timeline_section(run_dir)
    assert sec == jax_report.fleet_timeline_section(run_dir)
    for kw in ({"now": T0 + 5}, {"window_s": 4.0, "now": T0}):
        assert report.fleet_timeline_section(run_dir, **kw) == \
            jax_report.fleet_timeline_section(run_dir, **kw)
    assert sorted(sec["targets"]) == ["0", "router"]
    assert sec["targets"]["0"]["samples"] == 10
    assert sec["targets"]["0"]["p99_ms_last"] == 29.0
    assert sec["scrape_failures"] == 3
    assert sec["t_end"] == T0  # the store's last sample, not the clock
