"""The port's serving wire against the JAX package's on the same inputs:
``POST /predict_voxels_stream`` through both packages' ``make_server``
driven by one stub service (status codes, error kinds, per-frame lines and
``<stream>.<i>`` trace ids), ``poisson_load``'s arrival schedule from one
seed, the ``serve_packed*`` programs' labels against the reference's spec
functions at smoke16, the program catalog's rows for sprint64, seg64 and
pod64, and the command line: ``cli programs [--warm]`` and ``cli serve
--drain`` exiting on the SLO verdict.

Packed labels against JAX: both sides compute in bf16 activations from
the same weights, so the logits differ by a few bf16 roundings; a label
may flip only where the reference's top-2 logits are that close, and the
labels are held equal wherever its gap exceeds 0.05 (a bf16 ulp of a logit
of size 4 is 0.016)."""

import http.client
import json
import signal
import struct
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.runtime import Runtime
from featurenet_tpu.runtime import list_programs as jax_list_programs
from featurenet_tpu.runtime.registry import build_model as jax_build_model
from featurenet_tpu.serve import batcher as jax_batcher
from featurenet_tpu.serve import http as jax_http
from featurenet_tpu.serve import loadgen as jax_loadgen
from featurenet_tpu_torch import cli, convert
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.data.synthetic import generate_batch, pack_voxels
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.runtime import registry
from featurenet_tpu_torch.serve import batcher, loadgen
from featurenet_tpu_torch.serve import http as port_http

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
R = 4  # the stub service's grids: 256 bytes a frame


class _Future:
    def __init__(self, trace_id, value=None, error=None):
        self.trace_id, self._value, self._error = trace_id, value, error

    def result(self, timeout=None):
        if self._error is not None:
            raise RuntimeError(f"serving forward failed: {self._error}")
        return self._value


class _StubService:
    """A service both packages' HTTP servers drive: a frame whose first
    voxel is 7 is shed (the given package's ``OverloadError``), one whose
    first voxel is 9 fails its forward; otherwise the answer is the
    frame's first voxel as a label."""

    def __init__(self, overload_error):
        self.cfg = types.SimpleNamespace(resolution=R)
        self.batcher = types.SimpleNamespace(retry_after_s=0.05)
        self._overload = overload_error

    def submit_voxels(self, grid, trace_id=None, lane="interactive"):
        v = float(grid.ravel()[0])
        if v == 7:
            raise self._overload(64, 64, trace_id=trace_id, lane=lane,
                                 retry_after_s=0.05)
        return _Future(trace_id, value=v, error="boom" if v == 9 else None)

    def format_row(self, row):
        return {"label": int(row)}


def _frame(v, n=R ** 3 * 4):
    return struct.pack("<I", n) + np.full(R ** 3, v, "<f4").tobytes()


STREAMS = {
    "three": b"".join(_frame(v) for v in (1, 2, 3)),
    "shed_and_failed": b"".join(_frame(v) for v in (1, 7, 9, 4)),
    "torn_prefix": _frame(1) + b"\x01\x02",
    "wrong_length": _frame(1) + _frame(2, n=12)[:4] + b"\0" * 12,
    "short_payload": _frame(1) + _frame(2)[:40],
    "empty": b"",
}


def _post_stream(port, body, trace="s1"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/predict_voxels_stream", body=body,
                     headers={"X-Featurenet-Trace": trace})
        resp = conn.getresponse()
        raw = resp.read().decode("utf-8")
        lines = [json.loads(ln) for ln in raw.splitlines() if ln.strip()]
        return (resp.status, resp.getheader("X-Featurenet-Trace"),
                resp.getheader("Connection"), lines)
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers():
    out = []
    for mod, bmod in ((jax_http, jax_batcher), (port_http, batcher)):
        srv = mod.make_server(_StubService(bmod.OverloadError), port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out.append(srv)
    yield [s.server_address[1] for s in out]
    for s in out:
        s.shutdown()
        s.server_close()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_jax(servers, name):
    ref, port = (_post_stream(p, STREAMS[name]) for p in servers)
    assert port == ref
    status, trace, _, lines = port
    assert trace == "s1"
    if name == "three":
        assert status == 200 and lines == [
            {"frame": i, "trace": f"s1.{i}", "label": i + 1} for i in range(3)]
    elif name == "shed_and_failed":
        assert [ln.get("error") for ln in lines] == [None, "overload",
                                                     "forward_failed", None]
    else:
        assert status == 400 and lines[0]["error"] == "bad_stream"


def test_stream_id_too_long_is_replaced_and_endpoints_match(servers):
    status, trace, _, lines = _post_stream(servers[1], STREAMS["three"],
                                           trace="x" * 60)
    assert status == 200 and len(trace) == 16
    assert [ln["trace"] for ln in lines] == [f"{trace}.{i}" for i in range(3)]
    assert port_http.ENDPOINTS == jax_http._ENDPOINTS


class _FakeTime:
    """perf_counter and sleep on one fake clock that sleeping advances."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, s):
        self.now += s


class _LoadService:
    """Records the fake clock at each submit; sheds request 3 once."""

    def __init__(self, clock, overload_error):
        self.clock, self.stamps, self._overload = clock, [], overload_error
        self.cfg = types.SimpleNamespace(resolution=R)
        self.shed = {3}

    def submit_voxels(self, grid, trace_id=None, lane="interactive"):
        i = len(self.stamps)
        self.stamps.append(self.clock.now)
        if i in self.shed:
            self.shed.discard(i)
            raise self._overload(8, 8, trace_id=trace_id, retry_after_s=0.01)
        return types.SimpleNamespace(
            trace_id=trace_id, t_done=self.clock.now + 0.002, latency_ms=2.0,
            result=lambda timeout=None: None)

    def stats(self):
        return {"occupancy": 0.5, "by_bucket": {1: 3}}


def test_poisson_load_draws_the_jax_schedule(monkeypatch):
    grids = np.zeros((2, R, R, R), np.float32)
    runs = []
    for mod, bmod in ((jax_loadgen, jax_batcher), (loadgen, batcher)):
        clock = _FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        svc = _LoadService(clock, bmod.OverloadError)
        stats, futs = mod.poisson_load(svc, qps=400.0, n_requests=50,
                                       rng=np.random.default_rng(5), grids=grids)
        runs.append((svc.stamps, {k: v for k, v in stats.items()
                                  if k != "client_by_trace"}, len(futs)))
    assert runs[1] == runs[0]
    assert runs[1][1]["retried"] == 1 and runs[1][2] == 50
    assert loadgen.BENCH_LOAD_FRACTION == jax_loadgen.BENCH_LOAD_FRACTION
    assert loadgen.BENCH_QPS_CAP == jax_loadgen.BENCH_QPS_CAP


@pytest.fixture(scope="module")
def smoke16():
    """smoke16 from the Flax init at key 0: the JAX variables (host numpy)
    and the port state_dict bridged from them."""
    jcfg = jax_get_config("smoke16")
    v = jax_build_model(jcfg).init(jax.random.key(0),
                                   jnp.zeros((1, 16, 16, 16, 1), jnp.float32),
                                   train=False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(v))
    return jcfg, v, convert.from_flax(v, get_config("smoke16").arch)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_serve_packed_labels_match_the_reference_spec(smoke16, precision):
    """The port's packed program (eager on the CPU) against the reference's
    ``serve_packed*`` spec function under ``jax.jit`` on the same packed
    batch and bridged weights; and against the port's own serve program's
    argmax on the unpacked grids, exactly."""
    from featurenet_tpu.runtime.quantize import quantize_tree
    from featurenet_tpu.train.precision import serve_params_cast

    jcfg, v, state = smoke16
    b = 24
    grids = generate_batch(np.random.default_rng(11), b, 16)["voxels"]
    packed = pack_voxels(grids)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pred = Predictor(state, get_config("smoke16"), batch=b, device="cpu",
                         precision=precision)
        prog = pred.packed_program_for(b)
        got = prog(torch.from_numpy(packed)).numpy()
        serve = pred.program_for(b)(torch.from_numpy(grids)).argmax(-1).numpy()
    finally:
        torch.set_num_threads(threads)
    assert prog.name == registry.serve_program_name(precision, packed=True)
    assert got.dtype == np.int32 and np.array_equal(got, serve)
    rt = Runtime(jcfg, cache=None)
    name = "serve_packed" if precision == "fp32" else f"serve_packed_{precision}"
    fn = jax.jit(rt.spec(name, global_batch=b).fn)
    if precision == "int8":
        q, s = quantize_tree(v["params"])
        want = fn(q, s, v["batch_stats"], packed)
    else:
        params = (serve_params_cast(v["params"], "bf16") if precision == "bf16"
                  else v["params"])
        want = fn({"params": params, "batch_stats": v["batch_stats"]}, packed)
    want = np.asarray(want)
    logits = np.asarray(jax_build_model(jcfg).apply(v, grids, train=False),
                        np.float32)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 0.05
    assert clear.sum() >= b // 2
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("preset", ["sprint64", "seg64", "pod64"])
def test_list_programs_rows_are_the_reference_rows(preset):
    assert registry.list_programs(get_config(preset)) == \
        jax_list_programs(jax_get_config(preset))


def test_packed_programs_refuse_a_segmenter():
    seg = get_config("seg64", resolution=16, seg_features=(4, 8))
    pred = Predictor.from_seed(seg, 0, batch=1, device="cpu")
    with pytest.raises(ValueError, match="classify"):
        pred.packed_program_for(1)
    assert registry.warmup(seg, device="cpu", names=["serve_int8"]) == {
        "serve_int8": {"skipped": "int8 segment serving is not ported "
                                  "(ROADMAP Queue A.3)"}}


def test_cli_programs_lists_the_reference_rows_and_warms(capsys):
    assert cli.main(["programs"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows == jax_list_programs(jax_get_config("pod64"))
    assert cli.main(["programs", "--config", "smoke16", "--warm",
                     "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    warm = lines[-1]["warmup"]
    applicable = [r["program"] for r in lines[:-1] if r["applicable"]]
    assert sorted(warm) == sorted(applicable)
    for name in ("serve", "serve_bf16", "serve_int8"):
        assert warm[name]["source"] == "eager"
        assert warm[name]["batches"] == [64, 16, 4, 1]
    for name in ("serve_packed", "serve_packed_bf16", "serve_packed_int8"):
        assert warm[name]["batches"] == [32]  # smoke16's global_batch
        assert warm[name]["precision"] == registry.program_precision(
            get_config("smoke16"), name)
    assert all("skipped" in warm[n] for n in ("init", "train_step", "eval_step"))


@pytest.mark.parametrize("slo,code", [("0.001", 2), (None, 0)])
def test_cli_serve_drain_exits_on_the_slo_verdict(tmp_path, slo, code):
    """``cli serve --drain``: one request, then SIGTERM. Under a 0.001 ms
    SLO the serving alert is active at drain and the process exits 2;
    under the default 250 ms it exits 0. The run directory holds the
    serving events."""
    import os

    args = ["serve", "--seed", "0", "--config", "smoke16", "--device", "cpu",
            "--port", "0", "--buckets", "1", "--drain", "--run-dir",
            str(tmp_path / "run")] + (["--slo-p99-ms", slo] if slo else [])
    proc = subprocess.Popen([sys.executable, "-m", "featurenet_tpu_torch.cli", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        banner = json.loads(proc.stdout.readline())["serving"]
        conn = http.client.HTTPConnection("127.0.0.1", banner["port"], timeout=60)
        conn.request("POST", "/predict_voxels",
                     body=np.zeros((16, 16, 16), "<f4").tobytes(),
                     headers={"X-Featurenet-Trace": "req-1"})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("X-Featurenet-Trace") == "req-1"
        resp.read()
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert 'featurenet_requests_total{outcome="served"} 1' in text
        conn.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == code, err
    stats = json.loads(out.strip().splitlines()[-1])["serve_stats"]
    assert stats["exit_code"] == code
    assert ("serving_p99_ms" in stats["active_serving_alerts"]) == (code == 2)
    with open(tmp_path / "run" / "events.jsonl") as fh:
        kinds = [json.loads(ln)["ev"] for ln in fh]
    assert {"run_start", "program_compile", "serve_start", "serve_batch",
            "request_done", "window_summary", "serve_stop"} <= set(kinds)
    assert ("alert" in kinds) == (code == 2)
