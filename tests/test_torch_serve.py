"""The port's serving path on the CPU: STL parse and voxelize against the
JAX package, the batcher's bucket and admission contract, and the service
+ HTTP round trip against the JAX ``_serve_fn`` softmax.

The served model computes in bf16 activations on both sides (the JAX
``build_model`` default), so served probabilities are held to 1e-2: a
few bf16 ulps of logits near 1, scaled by the softmax's slope (< 1/4).
"""

import http.client
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.data import mesh_primitives as jax_mesh
from featurenet_tpu.data import stl as jax_stl
from featurenet_tpu.data.voxelize import voxelize as jax_voxelize
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu.runtime.registry import _serve_fn
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import Config
from featurenet_tpu_torch.data.mesh_primitives import mesh_box
from featurenet_tpu_torch.data.stl import load_stl, parse_stl, save_stl
from featurenet_tpu_torch.data.voxelize import voxelize
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.models.featurenet import FeatureNetArch
from featurenet_tpu_torch.serve.batcher import (
    ContinuousBatcher,
    OverloadError,
    normalize_buckets,
    normalize_lane,
    pick_bucket,
)
from featurenet_tpu_torch.serve.http import make_server
from featurenet_tpu_torch.serve.service import InferenceService

R = 16
ARCH = dict(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
            strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
            hidden=32)
BOXES = [((0.2, 0.2, 0.2), (0.8, 0.8, 0.8)),
         ((0.1, 0.3, 0.2), (0.9, 0.7, 0.5)),
         ((0.0, 0.0, 0.0), (1.0, 0.2, 0.6))]


def _stl_bytes(tmp_path, tris, name="part"):
    path = str(tmp_path / f"{name}.stl")
    save_stl(path, tris)
    with open(path, "rb") as f:
        return f.read()


def _ascii_stl(tris) -> bytes:
    lines = ["solid t"]
    for tri in tris:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {x:.7f} {y:.7f} {z:.7f}" for x, y, z in tri]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid t")
    return "\n".join(lines).encode()


# -- data path --------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", BOXES)
def test_stl_and_voxelize_match_jax(tmp_path, lo, hi):
    tris = mesh_box(lo, hi)
    np.testing.assert_array_equal(tris, jax_mesh.mesh_box(lo, hi))
    data = _stl_bytes(tmp_path, tris)
    for blob in (data, _ascii_stl(tris)):
        got = parse_stl(blob)
        np.testing.assert_array_equal(got, jax_stl.parse_stl(blob))
    np.testing.assert_array_equal(load_stl(str(tmp_path / "part.stl")), tris)
    for fill in (True, False):
        want = jax_voxelize(tris, R, fill=fill, backend="numpy")
        np.testing.assert_array_equal(voxelize(tris, R, fill=fill), want)


def test_parse_stl_rejects_garbage():
    with pytest.raises(ValueError, match="malformed STL"):
        parse_stl(b"not an stl at all")


# -- batcher -----------------------------------------------------------------

def test_bucket_ladder():
    assert normalize_buckets([16, 1, 4, 4]) == (1, 4, 16)
    with pytest.raises(ValueError):
        normalize_buckets([0, 4])
    bs = (1, 4, 16, 64)
    assert [pick_bucket(n, bs) for n in (1, 2, 4, 5, 17, 64, 99)] == \
        [1, 4, 4, 16, 64, 64, 64]
    assert normalize_lane("batch") == "batch"
    assert normalize_lane("bulk") == "interactive"


def test_batcher_pads_demuxes_and_counts():
    seen = []

    def forward(bucket, arr):
        seen.append((bucket, arr.shape[0]))
        return arr.reshape(bucket, -1).sum(axis=1)

    b = ContinuousBatcher(forward, buckets=(1, 4), max_wait_ms=50)
    futs = [b.submit(np.full((2, 2), i, np.float32)) for i in range(3)]
    assert [f.result(5.0) for f in futs] == [0.0, 4.0, 8.0]
    st = b.drain()
    assert seen == [(4, 4)]  # 3 rows padded into one bucket-4 dispatch
    assert st["served"] == 3 and st["batches"] == 1 and st["occupancy"] == 0.75
    assert st["drain_timeout"] is False
    with pytest.raises(RuntimeError, match="draining"):
        b.submit(np.zeros((2, 2), np.float32))


def test_batcher_overload_and_lane_shedding():
    release = threading.Event()

    def forward(bucket, arr):
        release.wait(10.0)
        return np.zeros(bucket)

    b = ContinuousBatcher(forward, buckets=(1,), max_wait_ms=0, queue_limit=2,
                          lane_limits={"batch": 1})
    try:
        first = b.submit(np.zeros(1))  # taken by the (blocked) dispatcher
        deadline = time.monotonic() + 5.0
        while b.stats()["queue_depth"] and time.monotonic() < deadline:
            time.sleep(0.01)
        b.submit(np.zeros(1), lane="batch")
        with pytest.raises(OverloadError) as e:
            b.submit(np.zeros(1), lane="batch")  # lane cap first
        assert e.value.response["lane"] == "batch"
        b.submit(np.zeros(1))
        with pytest.raises(OverloadError) as e:
            b.submit(np.zeros(1))  # global bound
        assert e.value.response["error"] == "overload"
        assert e.value.response["limit"] == 2 and e.value.retry_after_s > 0
    finally:
        release.set()
    first.result(5.0)
    st = b.drain()
    assert st["rejected"] == 2 and st["served"] == 3
    assert st["by_lane"]["batch"]["rejected"] == 1


def test_batcher_forward_error_resolves_batch():
    def forward(bucket, arr):
        raise ValueError("boom")

    b = ContinuousBatcher(forward, buckets=(2,), max_wait_ms=1)
    f = b.submit(np.zeros(1))
    with pytest.raises(RuntimeError, match="boom"):
        f.result(5.0)
    assert b.drain()["errors"] == 1


# -- service + HTTP ----------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """One JAX model and its port twin with bridged weights."""
    arch = FeatureNetArch(**ARCH)
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend="pallas", **ARCH))
    v = jax.device_get(jmodel.init(jax.random.key(0),
                                   jnp.zeros((1, R, R, R, 1)), train=False))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), v)
    serve = _serve_fn(types.SimpleNamespace(
        model=jmodel, cfg=types.SimpleNamespace(task="classify")))
    cfg = Config(name="test16", resolution=R, arch=arch)
    return serve, v, cfg, convert.from_flax(v, arch)


def _jax_probs(models, grids):
    serve, v, _, _ = models
    x = jnp.asarray(np.asarray(grids, np.float32)[..., None])
    return np.asarray(serve(v["params"], v["batch_stats"], x))


def test_predictor_matches_jax_serve_fn(models, tmp_path):
    _, _, cfg, state = models
    p = Predictor(state, cfg, batch=2, device="cpu")
    grids = np.stack([voxelize(mesh_box(lo, hi), R) for lo, hi in BOXES])
    labels, probs = p.predict_voxels(grids)  # 3 rows over batch 2: pads
    want = _jax_probs(models, grids)
    np.testing.assert_allclose(probs, want, atol=1e-2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert labels.dtype == np.int32 and labels.shape == (3,)
    paths = []
    for i, (lo, hi) in enumerate(BOXES):
        paths.append(str(tmp_path / f"b{i}.stl"))
        save_stl(paths[-1], mesh_box(lo, hi))
    preds = p.predict_stl(paths)
    assert [q.label for q in preds] == labels.tolist()
    assert all(len(q.top3) == 3 and q.top3[0][1] == q.prob for q in preds)


def _post(conn, path, body, headers=None):
    conn.request("POST", path, body=body, headers=headers or {})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read()), resp


@pytest.fixture
def one_thread():
    """A served test's small forwards on one torch thread: under xdist a
    thread team per worker slows each forward many times over, and the
    drain's exit code now carries the default 250 ms latency SLO."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_http_round_trip_matches_jax(models, tmp_path, one_thread):
    _, _, cfg, state = models
    service = InferenceService(Predictor(state, cfg, batch=4, device="cpu"),
                               buckets=(1, 4), max_wait_ms=2)
    srv = make_server(service, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["ready"]
        sock = None
        grids = []
        for i, (lo, hi) in enumerate(BOXES):
            tris = mesh_box(lo, hi)
            grids.append(voxelize(tris, R))
            status, body, _ = _post(conn, "/predict", _stl_bytes(tmp_path, tris, f"p{i}"))
            assert status == 200, body
            assert set(body) == {"label", "class_name", "prob", "top3"}
            want = _jax_probs(models, grids[-1][None])[0]
            assert abs(body["prob"] - want[body["label"]]) < 1e-2
            assert abs(body["prob"] - want.max()) < 1e-2
            sock = sock or conn.sock
            assert conn.sock is sock  # one keep-alive connection
        status, body, _ = _post(conn, "/predict_voxels",
                                grids[0].astype("<f4").tobytes())
        assert status == 200
        want = _jax_probs(models, grids[0][None])[0]
        assert abs(body["prob"] - want.max()) < 1e-2
        assert _post(conn, "/predict", b"garbage")[:2][0] == 400
        status, body, _ = _post(conn, "/predict_voxels", b"\0" * 12)
        assert status == 400 and body["error"] == "bad_voxels"
        assert _post(conn, "/nope", b"x")[0] == 404
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        st = json.loads(resp.read())
        assert resp.status == 200 and st["served"] == 4
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    st = service.drain()
    assert st["exit_code"] == 0 and not service.ready()


class _StubPredictor:
    """A forward that blocks until released, for the 503/504 paths."""

    def __init__(self):
        self.cfg = Config(name="stub", resolution=2, arch=FeatureNetArch())
        self.model_version = "stub"
        self.block = False
        self.entered = threading.Event()
        self.release = threading.Event()

    def program_for(self, batch):
        return None  # nothing to build ahead of traffic

    def forward_padded(self, voxels, batch=None):
        if self.block:
            self.entered.set()
            self.release.wait(10.0)
        return np.full((voxels.shape[0], 24), 1.0 / 24, np.float32)


def test_http_overload_and_timeout():
    pred = _StubPredictor()
    service = InferenceService(pred, buckets=(1,), max_wait_ms=0, queue_limit=1)
    pred.block = True
    srv = make_server(service, port=0, request_timeout_s=1.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    body = np.zeros(8, "<f4").tobytes()
    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=10)
             for _ in range(3)]
    try:
        # The first request is taken by the dispatcher, whose forward
        # blocks; the second fills the queue; the third is shed.
        conns[0].request("POST", "/predict_voxels", body=body)
        assert pred.entered.wait(5.0)
        conns[1].request("POST", "/predict_voxels", body=body)
        deadline = time.monotonic() + 5.0
        while service.stats()["queue_depth"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        status, payload, resp = _post(conns[2], "/predict_voxels", body)
        assert status == 503 and payload["error"] == "overload"
        assert float(resp.getheader("Retry-After")) > 0
        r0 = conns[0].getresponse()
        assert r0.status == 504 and json.loads(r0.read())["error"] == "timeout"
    finally:
        pred.release.set()
        for c in conns:
            c.close()
        srv.shutdown()
        srv.server_close()
    st = service.drain()
    # The timed-out request and the one queued behind it took over a
    # second, past the default 250 ms SLO: the drain names both serving
    # alerts and exits 2.
    assert st["rejected"] == 1
    assert st["active_serving_alerts"] == ["queue_wait_ms_p99", "serving_p99_ms"]
    assert st["exit_code"] == 2
