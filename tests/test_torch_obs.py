"""The port's obs core (``featurenet_tpu_torch/obs``) and its Prometheus
exporter against the JAX package's on the same inputs: the rolling windows
and the aggregator's summaries and events on one sample sequence and one
explicit clock, the alert-rule parser's accepts and refusals, the trace
sampler's decisions, the event sink's kinds, keys and counts, and the
exporter's exposition, line for line but the ``build_info`` label
(``torch_version`` where the reference has ``jax_version``)."""

import json
import os
import types

import numpy as np
import pytest

from featurenet_tpu.obs import alerts as jax_alerts
from featurenet_tpu.obs import events as jax_events
from featurenet_tpu.obs import tracing as jax_tracing
from featurenet_tpu.obs import windows as jax_windows
from featurenet_tpu.serve import metrics as jax_metrics
from featurenet_tpu_torch.obs import alerts, events, tracing, windows
from featurenet_tpu_torch.serve import metrics

PAIRS = ((jax_events, jax_windows, jax_alerts, jax_tracing),
         (events, windows, alerts, tracing))


class Clock:
    """An explicit perf_counter for both aggregators."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (jax_windows, windows):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=c))
    return c


@pytest.fixture
def runs(tmp_path):
    """Both packages' sinks installed, each in its own run directory; both
    closed after the test."""
    dirs = []
    for i, (ev, *_rest) in enumerate(PAIRS):
        d = tmp_path / f"run{i}"
        ev.init_run(str(d), process_index=0)
        dirs.append(d)
    yield dirs
    for ev, win, _, tr in PAIRS:
        ev.close_run()
        win.uninstall()
        tr.reset_counters()


def _records(d, drop=("t", "pid", "thread")):
    with open(os.path.join(d, "events.jsonl")) as fh:
        return [{k: v for k, v in json.loads(ln).items() if k not in drop}
                for ln in fh]


def _serving_rules(mod):
    return list(mod.DEFAULT_RULES) + [
        mod.AlertRule("serving_p99_ms", ">", 50.0, "critical"),
        mod.AlertRule("queue_wait_ms_p99", ">", 20.0, "warning")]


def test_rolling_window_matches_jax_with_age_pruning():
    rng = np.random.default_rng(0)
    ref, port = jax_windows.RollingWindow(16, 10.0), windows.RollingWindow(16, 10.0)
    now = 0.0
    for v in rng.exponential(30.0, 60):
        now += float(rng.uniform(0.0, 1.5))
        ref.add(v, now)
        port.add(v, now)
        assert port.summary(now) == ref.summary(now)
        assert port.total(now) == ref.total(now)
    assert port.summary(now + 100.0) is None and ref.summary(now + 100.0) is None


def test_aggregator_summaries_and_alerts_match_jax(clock, runs):
    """One sample sequence through both aggregators on one clock: a quiet
    stretch, a slow one (both serving rules fire), a quiet one (they
    resolve). Each cycle's window_summary and alert events, the active
    alerts after each sample, the snapshot and the seq agree."""
    aggs = [win.WindowAggregator(rules=_serving_rules(al), window=32,
                                 emit_every_s=2.0)
            for _, win, al, _ in PAIRS]
    for (_, win, _, _), agg in zip(PAIRS, aggs):
        win.install(agg)
    rng = np.random.default_rng(1)
    for n, scale in ((40, 5.0), (40, 200.0), (60, 5.0)):
        for _ in range(n):
            clock.now += 0.3
            wait, total = (float(x) for x in rng.exponential(scale, 2))
            for _, win, _, _ in PAIRS:
                win.observe("queue_wait_ms", wait)
                win.observe("serving_ms", wait + total)
                win.observe("not_a_window", 1.0)  # ignored by both
            assert aggs[1].active_alerts() == aggs[0].active_alerts()
    for _, win, _, _ in PAIRS:
        win.flush()
    assert aggs[1].snapshot() == aggs[0].snapshot()
    assert aggs[1].seq == aggs[0].seq and windows.last_seq() == jax_windows.last_seq()
    ref, port = (_records(d) for d in runs)
    assert port == ref
    kinds = [r["ev"] for r in port]
    fired = [(r["rule"], r["state"]) for r in port if r["ev"] == "alert"]
    assert kinds.count("window_summary") > 10
    assert ("serving_p99_ms", "fire") in fired and ("serving_p99_ms", "resolve") in fired
    assert windows.active_alerts() == jax_windows.active_alerts()


@pytest.mark.parametrize("spec", [
    None, "", "serving_p99_ms>250", "serving_p99_ms>250:critical,queue_wait_ms_p99>100",
    "mfu<0.3:warning", "step_p99_ratio>4,data_wait_fraction>0.5:info",
    "queue_depth_p50<1e-3", " serving_ms_max>1e3 , heartbeat_age_s>60 ",
    "serving_p99_ms>>250", "serving_p99>250", "serving_p99_ms>abc",
    "serving_p99_ms>250:urgent", "serving_p99_ms>1,serving_p99_ms>2", ",",
    "serving_p99_ms=250", "Serving_p99_ms>250", "serving_p99_ms>1.2.3",
])
def test_parse_rules_accepts_and_refuses_as_jax(spec):
    try:
        want = [vars(r) for r in jax_alerts.parse_rules(spec)]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            alerts.parse_rules(spec)
        assert str(got.value) == str(e)
        return
    assert [vars(r) for r in alerts.parse_rules(spec)] == want
    assert [r.scope for r in alerts.parse_rules(spec)] == \
        [r.scope for r in jax_alerts.parse_rules(spec)]


def test_rule_metadata_matches_jax():
    assert alerts.WINDOW_METRICS == jax_alerts.WINDOW_METRICS
    assert alerts.known_metrics() == jax_alerts.known_metrics()
    for m in sorted(alerts.known_metrics()):
        assert alerts.is_serving_metric(m) == jax_alerts.is_serving_metric(m)


@pytest.mark.parametrize("rate", [0.0, 0.1, 1.0])
def test_sampler_agrees_with_jax(rate):
    rng = np.random.default_rng(7)
    ids = [rng.bytes(8).hex() for _ in range(1000)]
    ids[:3] = ["stream.0", "abc", "x" * 64]
    got = [tracing.sampled(i, rate) for i in ids]
    assert got == [jax_tracing.sampled(i, rate) for i in ids]
    if rate == 0.1:
        assert 50 < sum(got) < 150
    for raw in ("ok-id.1", "bad id", "", None, "x" * 65, "y" * 64):
        assert (tracing.normalize_trace_id(raw) == raw) == \
            (jax_tracing.normalize_trace_id(raw) == raw)


def test_event_sink_and_tracing_write_what_jax_writes(runs, capsys):
    """The same emits, gauges, warnings and request timelines (a kept
    request, a dropped one, a forced error, a rejection) through both
    packages: the same kinds and keys line for line, the same per-kind
    counts and sampling counters."""
    for ev, _, _, tr in PAIRS:
        tr.reset_counters()
        ev.emit("custom", a=1, b=[1, 2], c={"x": 1.5})
        ev.gauge("queue_depth", 3, where="test")
        ev.warn("thing_warning", "careful", n=2)
        kept = tr.admit("keep.1", 1.0)
        tr.dispatch(kept, 1, 4, 3)
        tr.done(kept, 1.0, 2.0, 3.0)
        dropped = tr.admit("drop.1", 0.0)
        tr.dispatch(dropped, 2, 1, 0)
        tr.done(dropped, 1.0, 1.0, 2.0)
        err = tr.admit("err.1", 0.0)
        tr.done(err, 1.0, 1.0, 2.0, outcome="error")
        slow = tr.admit("slow.1", 0.0)
        tr.done(slow, 1.0, 1.0, 300.0, slo_ms=250.0)
        tr.reject(tr.admit("rej.1", 0.0), 64, 64)
    ref, port = (_records(d) for d in runs)
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    assert port == ref
    assert events.kind_counts() == jax_events.kind_counts()
    assert tracing.counters() == jax_tracing.counters()
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1] == json.dumps({"thing_warning": "careful", "n": 2})
    for d in runs:
        assert json.load(open(os.path.join(d, "run.json")))["pid"] == os.getpid()


def test_dark_sink_writes_nothing(tmp_path):
    events.close_run()
    assert not events.active() and events.kind_counts() == {}
    events.emit("x", a=1)
    ctx = tracing.admit("dark.1", 1.0)
    assert ctx._buffered is None
    tracing.done(ctx, 1.0, 1.0, 2.0)
    assert list(tmp_path.iterdir()) == []
    tracing.reset_counters()


class _StubService:
    """One stub service both exporters render: fixed health and stats."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.predictor = types.SimpleNamespace(model_version="seed0")

    def health(self):
        return {"ready": True, "uptime_s": 12.5, "window_seq": windows.last_seq()}

    def stats(self):
        return {"served": 40, "rejected": 2, "errors": 1, "queue_depth": 3,
                "occupancy": 0.8125}


def test_render_metrics_matches_jax_line_for_line(clock, runs):
    cfg = types.SimpleNamespace(serve_precision="bf16",
                                arch=types.SimpleNamespace(conv_backend="pallas"))
    for ev, win, al, tr in PAIRS:
        win.install(win.WindowAggregator(rules=_serving_rules(al)))
        ev.emit("serve_batch", bucket=4, n=3, pad=1)
        ev.emit("overload", queue_depth=64, limit=64)
        tr.done(tr.admit("a.1", 1.0), 1.0, 1.0, 2.0)
        for v in (3.0, 5.0, 8.0, float("inf")):
            win.observe("serving_ms", v)
        win.observe("queue_wait_ms", 1.25)
        win.flush()
    got = metrics.render_metrics(_StubService(cfg)).splitlines()
    want = jax_metrics.render_metrics(_StubService(cfg)).splitlines()
    assert len(got) == len(want)
    import jax
    import torch

    assert got[2] == want[2].replace(f'jax_version="{jax.__version__}"',
                                     f'torch_version="{torch.__version__}"')
    assert got[:2] + got[3:] == want[:2] + want[3:]
    names = {ln.split()[2][len("featurenet_"):] for ln in got if ln.startswith("# TYPE")}
    assert names <= metrics.METRIC_NAMES
    assert 'featurenet_serving_ms{q="0.99"} +Inf' in got
