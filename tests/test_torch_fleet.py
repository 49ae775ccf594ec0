"""The port's serving fleet against the JAX package's, on the CPU, over
fakes (no subprocess): ``scale_verdict`` on a grid; ``parse_exposition``
on the port's own ``/metrics`` text and hand-written edge cases; the two
packages' ``FleetRouter``s over the same scripted replica servers (ok,
overload 503, dead port, a socket that closes after each answer) and the
same requests, with equal statuses, bodies, ``Retry-After``, chosen
replicas, counters, pool counters and router ``/metrics``; the
``replica_loss`` site at the Nth routed request; the ``ConnectionPool``
through the same sequences; the ``Autoscaler``'s steps; the membership
document byte for byte; ``replica_argv`` (the port's spawns
``featurenet_tpu_torch.cli``, drops ``--exec-cache-dir`` and adds
``--device``); the serve child contract (``--replica-id`` in ``/healthz``
and refusal bodies, the heartbeat while ready, its own event stream);
and ``cli fleet``'s and ``cli fleet rollout``'s refusals, message for
message. Exact equality throughout."""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

import featurenet_tpu.cli as jax_cli
import featurenet_tpu.elastic.coordinator as jax_coord
import featurenet_tpu.elastic.membership as jax_membership
import featurenet_tpu.fleet.loadgen as jax_loadgen
import featurenet_tpu.fleet.pool as jax_pool
import featurenet_tpu.fleet.replica as jax_replica
import featurenet_tpu.fleet.router as jax_router
import featurenet_tpu.fleet.scraper as jax_scraper
import featurenet_tpu.serve.metrics as jax_metrics
from featurenet_tpu_torch import cli, faults, obs
from featurenet_tpu_torch.elastic import coordinator as coord
from featurenet_tpu_torch.elastic import membership
from featurenet_tpu_torch.fleet import loadgen, pool, replica, router, scraper
from featurenet_tpu_torch.obs import alerts, incidents, windows
from featurenet_tpu_torch.serve import metrics

PKGS = {
    "jax": {"pool": jax_pool, "replica": jax_replica, "router": jax_router,
            "metrics": jax_metrics},
    "torch": {"pool": pool, "replica": replica, "router": router,
              "metrics": metrics},
}


@pytest.fixture(autouse=True)
def _clean():
    def reset():
        faults.uninstall()
        incidents.reset()
        alerts.set_store(None)
        obs.close_run()
        windows.uninstall()

    reset()
    yield
    reset()


# --- fakes -------------------------------------------------------------------

def _fake_replica(respond):
    """A scripted HTTP/1.1 keep-alive replica: ``respond(path, headers) ->
    (status, payload, extra_headers)``; ``hits`` records each POST."""
    hits: list = []

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def do_POST(self):  # noqa: N802
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            hits.append(self.headers.get("X-Featurenet-Trace"))
            status, payload, extra = respond(self.path, dict(self.headers))
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, args=(0.05,),
                     daemon=True).start()
    return srv, srv.server_address[1], hits


def _ok(label):
    return lambda path, h: (200, {"label": label,
                                  "trace": h.get("X-Featurenet-Trace")}, {})


def _overloaded(path, h):
    return 503, {"error": "overload", "queue_depth": 9, "limit": 8,
                 "retry_after_s": 0.07}, {"Retry-After": "0.070"}


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _closing_server():
    """A raw server that answers one request per connection, then hangs
    up: every pooled reuse finds a stale channel."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    hits: list = []

    def run():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            with c:
                data = b""
                while b"\r\n\r\n" not in data:
                    chunk = c.recv(65536)
                    if not chunk:
                        break
                    data += chunk
                if b"\r\n\r\n" not in data:
                    continue
                head, rest = data.split(b"\r\n\r\n", 1)
                want = 0
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length:"):
                        want = int(line.split(b":")[1])
                while len(rest) < want:
                    chunk = c.recv(65536)
                    if not chunk:
                        break
                    rest += chunk
                hits.append(1)
                c.sendall(b'HTTP/1.1 200 OK\r\nContent-Length: 11\r\n\r\n'
                          b'{"label":5}')

    threading.Thread(target=run, daemon=True).start()
    return srv, srv.getsockname()[1], hits


class FakeFleet:
    """The router's provider contract, scripted."""

    def __init__(self, cands):
        self.cands = list(cands)
        self.failed: list[int] = []
        self.killed_at: list[int] = []
        self.router = None

    def candidates(self):
        return sorted(self.cands, key=lambda c: (c.score, c.slot))

    def note_inflight(self, slot, delta):
        pass

    def note_failure(self, slot):
        self.failed.append(slot)
        self.cands = [c for c in self.cands if c.slot != slot]

    def kill_one(self):
        self.killed_at.append(self.router.stats()["routed"])

    def ready_count(self):
        return len(self.cands)

    def stats(self):
        return {"replicas": len(self.cands)}


# Each scenario: replica kinds with their scores, then the requests
# (lane, trace id), and whether the router drains before the last one.
SCENARIOS = {
    "least_queue": ([("ok", 0), ("ok", 5)],
                    [("interactive", f"lq-{i}") for i in range(4)], False),
    "spillover": ([("overload", 0), ("ok", 3)],
                  [("interactive", "spill-7")], False),
    "fleet_wide_503": ([("overload", 0)], [("interactive", "full-1")], False),
    "resubmit": ([("dead", 0), ("ok", 2)], [("interactive", "rs-1")], False),
    "second_death_drops": ([("dead", 0), ("dead", 1), ("ok", 2)],
                           [("interactive", "drop-1")], False),
    "batch_sheds_first": ([("ok", 9)],
                          [("batch", "b-1"), ("interactive", "i-1")], False),
    "batch_under_bar": ([("ok", 3), ("ok", 12)],
                        [("batch", "b-2"), ("bogus-lane", "b-3")], False),
    "stale_channels": ([("closing", 0)],
                       [("interactive", f"st-{i}") for i in range(3)], False),
    "draining": ([("ok", 0)], [("interactive", "d-1"),
                               ("interactive", "d-2")], True),
}


def _run_scenario(pkg: str, name: str):
    mods = PKGS[pkg]
    kinds, requests, drain_last = SCENARIOS[name]
    servers, hits, cands = [], [], []
    for slot, (kind, score) in enumerate(kinds):
        if kind == "dead":
            port, h = _dead_port(), []
        elif kind == "closing":
            srv, port, h = _closing_server()
            servers.append(srv)
        else:
            srv, port, h = _fake_replica(_ok(slot + 1) if kind == "ok"
                                         else _overloaded)
            servers.append(srv)
        hits.append(h)
        cands.append(mods["replica"].Candidate(slot, "127.0.0.1", port, score))
    fleet = FakeFleet(cands)
    r = mods["router"].FleetRouter(fleet, rules=(), scale_every_s=3600.0)
    fleet.router = r
    answers = []
    try:
        for i, (lane, trace) in enumerate(requests):
            if drain_last and i == len(requests) - 1:
                r.drain()
            status, data, headers = r.route("/predict_voxels", b"grid",
                                            trace_id=trace, lane=lane)
            answers.append((status, json.loads(data.decode()), dict(headers)))
        st = r.stats()
        text = mods["metrics"].render_router_metrics(r)
    finally:
        r.drain()
        for s in servers:
            (s.close if isinstance(s, socket.socket) else s.shutdown)()
    st.pop("replicas")
    return {"answers": answers, "stats": st, "hits": [list(h) for h in hits],
            "failed": fleet.failed,
            "metrics": [ln for ln in text.splitlines()
                        if "build_info" not in ln]}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_matches_reference(name):
    got = _run_scenario("torch", name)
    want = _run_scenario("jax", name)
    assert got == want
    # Each scenario's point, on the port's run.
    st = got["stats"]
    if name == "spillover":
        assert st["spillovers"] == 1 and got["answers"][0][0] == 200
        assert got["answers"][0][1]["trace"] == "spill-7"
    if name == "fleet_wide_503":
        assert got["answers"][0][0] == 503
        assert float(got["answers"][0][2]["Retry-After"]) == pytest.approx(0.07)
    if name == "resubmit":
        assert st["resubmits"] == 1 and st["dropped"] == 0
        assert got["failed"] == [0]
    if name == "second_death_drops":
        assert got["answers"][0][0] == 502 and st["dropped"] == 1
        assert got["hits"][2] == []
    if name == "batch_sheds_first":
        assert got["answers"][0][1]["shed"] is True and st["shed"] == 1
        assert got["hits"] == [["i-1"]]
    if name == "stale_channels":
        assert st["resubmits"] == 0 and st["answered"] == 3
        assert st["pool"]["retired"]["broken"] == 2
    if name == "draining":
        assert got["answers"][1][0] == 503
        assert got["answers"][1][2]["Connection"] == "close"


def test_replica_loss_fires_at_the_nth_routed_request():
    faults.install("replica_loss@request=3")
    srv, port, _ = _fake_replica(_ok(1))
    fleet = FakeFleet([replica.Candidate(0, "127.0.0.1", port, 0)])
    r = router.FleetRouter(fleet, rules=(), scale_every_s=3600.0)
    fleet.router = r
    try:
        for _ in range(6):
            assert r.route("/predict_voxels", b"g")[0] == 200
    finally:
        r.drain()
        srv.shutdown()
    assert fleet.killed_at == [3]
    assert faults.WIRED == set(faults.SITES)


@pytest.mark.parametrize("ready", [0, 1, 3])
def test_scale_verdict_matches_reference(ready):
    burns = [None, 0.0, 0.05, 0.5, 1.0, 1.5, 4.0]
    for fast in burns:
        for slow in burns:
            for depth in (0.0, 0.5, 3.0, 8.0, 9.0):
                for max_burn in (1.0, 2.0):
                    args = (fast, slow, depth, ready, max_burn)
                    assert router.scale_verdict(*args) == \
                        jax_router.scale_verdict(*args), args


EXPOSITION_CASES = [
    'a_total 1\n# HELP a_total x\n# TYPE a_total counter\n',
    'm{q="0.99"} 12.5 1700000000\n',
    'm{a="x,y",b="z"} 3\n',
    'm{a="quote \\" inside"} 1\n',
    'm{a="back\\\\slash\\\\n"} 2\n',
    'm{a="new\\nline"} 2\n',
    'm{a="unterminated} 1\n',
    'm{a=novalue} 1\n',
    'm 1e400\nn NaN\no +Inf\np -Inf\nq notanumber\n',
    '   \n\nm{} 4\n{a="b"} 5\n',
    'm{a="1",} 6\n',
]


def test_parse_exposition_matches_reference():
    srv, port, _ = _fake_replica(_ok(1))
    fleet = FakeFleet([replica.Candidate(0, "127.0.0.1", port, 0)])
    windows.install(windows.WindowAggregator(rules=[]))
    r = router.FleetRouter(fleet, rules=(), scale_every_s=3600.0)
    try:
        for _ in range(3):
            r.route("/predict_voxels", b"g")
        windows.observe("queue_wait_ms", 1.5)
        texts = [metrics.render_router_metrics(r)] + EXPOSITION_CASES
    finally:
        r.drain()
        srv.shutdown()
    for text in texts:
        got = scraper.parse_exposition(text)
        # repr: NaN is not equal to itself.
        assert repr(got) == repr(jax_scraper.parse_exposition(text)), text
    parsed = dict(((n, tuple(sorted(lb.items()))), v)
                  for n, lb, v in scraper.parse_exposition(texts[0]))
    assert parsed[("featurenet_fleet_requests_total",
                   (("outcome", "answered"),))] == 3
    assert parsed[("featurenet_connections_opened_total", ())] == 1
    assert scraper.ROUTER_TARGET == jax_scraper.ROUTER_TARGET
    assert scraper.SCRAPER_SERIES == jax_scraper.SCRAPER_SERIES
    assert set(scraper.SCRAPER_SERIES) <= metrics.METRIC_NAMES


class _Store:
    def __init__(self):
        self.rows = []

    def append(self, metric, value, labels=None, t=None):
        self.rows.append((metric, value, dict(labels or {})))
        return True


def test_scraper_rows_match_reference():
    """One scrape of a replica-shaped target and a dead one: the same
    series, labels (``replica``, ``version`` from ``build_info``) and
    failure counts in both packages' stores."""
    body = ("# TYPE featurenet_build_info gauge\n"
            'featurenet_build_info{model_version="ck@3-ab"} 1\n'
            'featurenet_requests_total{outcome="served"} 7\n'
            "featurenet_not_registered 1\n"
            'featurenet_serving_ms{q="0.99"} 4.5\n')

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def do_GET(self):  # noqa: N802
            data = body.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    out = {}
    try:
        for name, sm, pm in (("torch", scraper, pool), ("jax", jax_scraper,
                                                          jax_pool)):
            store, p = _Store(), pm.ConnectionPool()
            s = sm.MetricsScraper(store, p, lambda: {
                "0": srv.server_address[1], "1": _dead_port()})
            assert s.scrape_once() == 3  # build_info, requests, serving_ms
            p.close()
            out[name] = ([(m, v, lb) for m, v, lb in store.rows
                          if m != "scrape_duration_ms"],
                         {k: v for k, v in s.stats().items()})
    finally:
        srv.shutdown()
    assert out["torch"] == out["jax"]
    rows = out["torch"][0]
    assert ("requests_total", 7.0, {"outcome": "served", "replica": "0",
                                    "version": "ck@3-ab"}) in rows
    assert ("scrape_failures_total", 1, {"replica": "1"}) in rows


def _pool_sequence(pm):
    """Reuse, the idle bound, max-age, stale reuse on a closing peer, a
    dead endpoint, retire_endpoint: every stats() along the way."""
    seen = []
    srv, port, _ = _fake_replica(_ok(1))
    p = pm.ConnectionPool()
    for _ in range(4):
        assert p.post("127.0.0.1", port, "/x", b"g", {}, 10.0)[0] == 200
    seen.append(p.stats())
    assert p.retire_endpoint("127.0.0.1", port, "probe_failure") == 1
    assert p.get("127.0.0.1", port, "/x", 10.0)[0] in (501, 200)
    seen.append(p.stats())
    p.close()
    seen.append(p.stats())
    with pytest.raises(OSError):
        p.checkout("127.0.0.1", port)
    q = pm.ConnectionPool(max_idle_per_endpoint=1, max_age_s=0.2)
    a = q.checkout("127.0.0.1", port)
    b = q.checkout("127.0.0.1", port)
    q.checkin(a)
    q.checkin(b)
    seen.append(q.stats())
    time.sleep(0.25)
    q.retire(q.checkout("127.0.0.1", port), "shutdown")
    seen.append(q.stats())
    q.close()
    srv.shutdown()
    closing, cport, _ = _closing_server()
    c = pm.ConnectionPool()
    for _ in range(3):
        assert c.post("127.0.0.1", cport, "/x", b"g", {}, 10.0)[:2] == \
            (200, b'{"label":5}')
    seen.append(c.stats())
    closing.close()
    with pytest.raises(OSError):
        c.post("127.0.0.1", _dead_port(), "/x", b"g", {}, 2.0)
    seen.append(c.stats())
    c.close()
    for bad in ({"max_idle_per_endpoint": 0}, {"max_age_s": 0}):
        with pytest.raises(ValueError):
            pm.ConnectionPool(**bad)
    return seen


def test_pool_matches_reference():
    got, want = _pool_sequence(pool), _pool_sequence(jax_pool)
    assert got == want
    assert got[0]["opened"] == 1 and got[0]["reused"] == 3
    assert got[3]["retired"] == {"idle_overflow": 1}
    assert got[5]["retired"] == {"broken": 2}
    assert pool.RETIRE_REASONS == jax_pool.RETIRE_REASONS


class _ScaleManager:
    def __init__(self, n):
        self.n = n
        self.calls = []

    def add_one(self):
        self.calls.append("add")
        self.n += 1
        return self.n - 1

    def shed_one(self):
        self.calls.append("shed")
        if self.n <= 1:
            return None
        self.n -= 1
        return self.n


def _st(verdict, bf=2.0, bs=1.5, qd=0.0):
    return {"verdict": verdict, "burn_fast": bf, "burn_slow": bs,
            "queue_depth": qd}


SCALE_SEQ = ([_st("add")] * 4 + [_st("hold")] + [_st("add")] * 3
             + [_st("shed", None, None)] * 4 + [_st("add", None, None)] * 3
             + [_st("add", None, None, qd=9.0)] * 4
             + [_st("shed", 0.0, 0.01)] * 8 + [_st("add")] * 12)


@pytest.mark.parametrize("kw", [
    {"min_replicas": 1, "max_replicas": 4, "hysteresis": 3,
     "cooldown_s": 5.0},
    {"min_replicas": 2, "max_replicas": 3, "hysteresis": 1,
     "cooldown_s": 0.0},
    {"min_replicas": 1, "max_replicas": 8, "hysteresis": 2,
     "cooldown_s": 30.0},
])
def test_autoscaler_steps_match_reference(kw):
    runs = {}
    for name, mod in (("torch", replica), ("jax", jax_replica)):
        mgr = _ScaleManager(2)
        a = mod.Autoscaler(mgr, lambda: {}, **kw)
        out = [a.step(st, float(t)) for t, st in enumerate(SCALE_SEQ)]
        runs[name] = (out, mgr.calls, mgr.n, a.stats())
    assert runs["torch"] == runs["jax"]
    for bad in ({"min_replicas": 0}, {"min_replicas": 3, "max_replicas": 2}):
        with pytest.raises(ValueError):
            replica.Autoscaler(_ScaleManager(2), lambda: {}, **bad)


@pytest.mark.parametrize("m", [
    (0, (), 1, "start", ()),
    (3, (0, 2), 1, "replica_loss", ()),
    (7, (0, 1, 2), 2, "replica_rejoin", (5,)),
])
def test_membership_document_matches_reference(tmp_path, m):
    a, b = str(tmp_path / "torch"), str(tmp_path / "jax")
    membership.write_membership(a, membership.Membership(*m))
    jax_membership.write_membership(b, jax_membership.Membership(*m))
    with open(membership.membership_path(a), "rb") as fa, \
            open(jax_membership.membership_path(b), "rb") as fb:
        assert fa.read() == fb.read()
    assert membership.read_membership(b) == membership.Membership(*m)
    for slot in (1, 4):
        assert membership.signal_ready(a, slot) == \
            jax_membership.signal_ready(b, slot)
    assert membership.ready_slots(a) == jax_membership.ready_slots(b)
    assert membership.read_membership(str(tmp_path / "none")) is None
    assert coord.heartbeat_path(a, 3) == jax_coord.heartbeat_path(a, 3)


@pytest.mark.parametrize("kw", [
    {},
    {"run_dir": "/r", "buckets": "1,4,16,64", "precision": "bf16",
     "inject_faults": "replica_slow@request=2", "trace_sample": 0.5,
     "quality_baseline": "/b.json", "capture": True,
     "capture_sample": 1.0, "queue_limit": 8, "slo_p99_ms": 40.0},
    {"run_dir": "/r", "quality": True, "capture": True},
    {"capture": True},
])
def test_replica_argv_matches_reference(kw):
    want = jax_loadgen.replica_argv("CK", 1, "/hb", **kw,
                                    exec_cache_dir="/cache")
    i = want.index("--exec-cache-dir")
    want = want[:i] + want[i + 2:]
    want[want.index("featurenet_tpu.cli")] = "featurenet_tpu_torch.cli"
    j = want.index("--process-index") + 2
    want[j:j] = ["--device", "cpu"]
    assert loadgen.replica_argv("CK", 1, "/hb", device="cpu", **kw) == want


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small CPU forwards
    yield
    torch.set_num_threads(threads)


def test_serve_child_contract(tmp_path, monkeypatch, one_thread):
    """``cli serve --replica-id 7 --heartbeat-file F --process-index 3``:
    the banner and /healthz name the replica, the heartbeat is touched
    while it serves, the events go to stream 3; an in-process service's
    refusals (draining 503, swap 409) name it too."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve import http as serve_http
    from featurenet_tpu_torch.serve.service import InferenceService

    hb, run = str(tmp_path / "hb"), str(tmp_path / "run")
    made = []
    real = serve_http.make_server

    def spy(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(serve_http, "make_server", spy)
    seen = {}

    def probe():
        while not made:
            time.sleep(0.05)
        url = f"http://127.0.0.1:{made[0].server_address[1]}/healthz"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and "health" not in seen:
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    seen["health"] = json.loads(resp.read())
            except OSError:
                time.sleep(0.05)
        seen["mtime"] = os.path.getmtime(hb) if os.path.exists(hb) else None

    t = threading.Thread(target=probe)
    t.start()
    rc = cli.main(["serve", "--config", "smoke16", "--seed", "0", "--device",
                   "cpu", "--buckets", "1", "--port", "0", "--duration-s",
                   "2.5", "--replica-id", "7", "--heartbeat-file", hb,
                   "--process-index", "3", "--run-dir", run])
    t.join()
    assert rc == 0
    assert seen["health"]["replica"] == "7" and seen["health"]["ready"]
    assert seen["mtime"] is not None and os.path.getmtime(hb) >= seen["mtime"]
    assert os.path.exists(os.path.join(run, "events.3.jsonl"))
    assert not os.path.exists(os.path.join(run, "events.jsonl"))

    pred = Predictor.from_seed(get_config("smoke16"), 0, batch=1, device="cpu")
    svc = InferenceService(pred, buckets=(1,), rules=(), replica="7")
    srv = real(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/admin/reload",
            data=json.dumps({"checkpoint_dir": str(tmp_path / "no")}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 409
        assert json.loads(e.value.read())["replica"] == "7"
        svc.drain()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict_voxels",
            data=np.zeros((16, 16, 16), "<f4").tobytes())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        body = json.loads(e.value.read())
        assert e.value.code == 503 and body["error"] == "draining"
        assert body["replica"] == "7"
    finally:
        srv.shutdown()
        srv.server_close()


REFUSALS = [
    ["fleet"],
    ["fleet", "--checkpoint-dir", "CK", "--replicas", "0"],
    ["fleet", "--checkpoint-dir", "CK", "--autoscale", "--min-replicas", "0"],
    ["fleet", "--checkpoint-dir", "CK", "--autoscale", "--replicas", "5",
     "--max-replicas", "3"],
    ["fleet", "--checkpoint-dir", "CK"],
    ["fleet", "--checkpoint-dir", "CK", "--run-dir", "{run}",
     "--inject-faults", "tyop@x=1"],
    ["fleet", "--checkpoint-dir", "CK", "--run-dir", "{run}",
     "--quality-baseline", "{run}/missing.json"],
    ["fleet", "--checkpoint-dir", "CK", "--run-dir", "{run}",
     "--slos", "serving_p99_ms<250@200%"],
    ["fleet", "rollout", "CK2"],
    ["fleet", "rollout", "CK2", "--run-dir", "{run}"],
    ["fleet", "rollout", "CK2", "--run-dir", "{run}", "--min-agreement", "2"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=range(len(REFUSALS)))
def test_cli_fleet_refusals_match_reference(tmp_path, argv):
    run = str(tmp_path / "run")
    argv = [a.replace("{run}", run) for a in argv]
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value.code, str)
    assert not torch.cuda.is_initialized()
