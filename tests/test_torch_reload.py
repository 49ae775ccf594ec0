"""Weight hot swaps on the CPU: ``Predictor.swap_params``,
``InferenceService.reload`` and ``POST /admin/reload``, at smoke16.

Checkpoints are written by the port's own ``CheckpointManager`` from the
JAX init at two keys, so after a swap the port is held against the JAX
``Predictor`` built on the swapped-in weights, on the same numpy inputs.
Both sides compute in bf16 activations, so probabilities are held to
1e-2 (a few bf16 ulps of logits, scaled by the softmax's slope < 1/4).
Every refusal (a missing directory, another identity, a checksum that
does not match) must leave the old generation serving: its version and
its answers, bitwise.
"""

import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.infer import Predictor as JaxPredictor
from featurenet_tpu.runtime import Runtime
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.data import synthetic
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.models.featurenet import FeatureNet
from featurenet_tpu_torch.serve.http import ENDPOINTS, make_server
from featurenet_tpu_torch.serve.service import InferenceService
from featurenet_tpu_torch.train import checkpoint
from featurenet_tpu_torch.train.state import create_state

R = 16


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _save(path, cfg, state_dict) -> str:
    """A one-step checkpoint directory of ``cfg``'s model holding
    ``state_dict``."""
    model = FeatureNet(cfg.arch, cfg.resolution)
    model.load_state_dict(state_dict)
    state = create_state(model, cfg)
    state.step = 1
    mgr = checkpoint.CheckpointManager(str(path), config=cfg)
    mgr.save(state)
    mgr.close()
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """smoke16 checkpoints ``a`` and ``b`` from the JAX init at keys 0 and
    1, and the JAX variables of each."""
    root = tmp_path_factory.mktemp("reload")
    jcfg = jax_get_config("smoke16")
    init = Runtime(jcfg, cache=None).build("init")
    cfg = get_config("smoke16")
    out = {"jcfg": jcfg, "cfg": cfg}
    for name, key in (("a", 0), ("b", 1)):
        js = init(jax.random.key(key))
        v = _np({"params": js.params, "batch_stats": js.batch_stats})
        out[name] = _save(root / name, cfg, convert.from_flax(v, cfg.arch))
        out[f"jax_{name}"] = v
    return out


def _grids(n=4, seed=5):
    return synthetic.generate_batch(np.random.default_rng(seed), n, R)["voxels"]


@pytest.fixture
def one_thread():
    """A served test's small forwards on one torch thread: under xdist a
    thread team per worker slows each forward many times over, and the
    drain's exit code now carries the default 250 ms latency SLO."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_swap_params_flips_the_generation_and_matches_jax(ckpts):
    """``swap_params`` to ``b`` flips ``model_version`` and
    ``checkpoint_dir``, builds the new generation's program for every
    bucket the old one had, and serves ``b``'s weights: the JAX Predictor's
    probabilities on them within 1e-2."""
    pred = Predictor.from_checkpoint(ckpts["a"], batch=4, device="cpu")
    for b in (1, 4):
        pred.program_for(b)
    v1 = pred.model_version
    assert v1.startswith("a@1-") and pred.checkpoint_dir == ckpts["a"]
    x = _grids()
    before = pred.forward_padded(x)
    old = pred._weights
    v2 = pred.swap_params(ckpts["b"])
    assert v2 == pred.model_version and v2.startswith("b@1-")
    assert pred.checkpoint_dir == ckpts["b"]
    assert pred._weights is not old and pred._weights.programs.batches() == [1, 4]
    got = pred.forward_padded(x)
    vb = ckpts["jax_b"]
    want = np.asarray(JaxPredictor(vb["params"], vb["batch_stats"], ckpts["jcfg"],
                                   batch=4).forward_padded(x))
    np.testing.assert_allclose(got, want, atol=1e-2)
    assert not np.array_equal(got, before)
    # The old generation is whole: what it answered, it still answers.
    with torch.inference_mode():
        assert np.array_equal(old.programs.body(torch.from_numpy(x)).numpy(), before)


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_swap_keeps_the_precision(ckpts, precision):
    """A reduced rung swaps into the same rung: the new generation holds
    only its working copy or int8 tensors, and serves ``b`` as a Predictor
    built on ``b`` at that rung does, bitwise."""
    pred = Predictor.from_checkpoint(ckpts["a"], batch=4, device="cpu",
                                     precision=precision)
    pred.swap_params(ckpts["b"])
    fresh = Predictor.from_checkpoint(ckpts["b"], batch=4, device="cpu",
                                      precision=precision)
    assert all(p.is_meta for p in pred.model.parameters())
    assert pred.resident_weight_bytes == fresh.resident_weight_bytes
    x = _grids()
    assert np.array_equal(pred.forward_padded(x), fresh.forward_padded(x))


def _other_identity(ckpts, tmp_path) -> str:
    cfg = ckpts["cfg"]
    other = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch,
                                                              hidden=32))
    model = FeatureNet(other.arch, R)
    return _save(tmp_path / "other", other, model.state_dict())


@pytest.mark.parametrize("where", ["missing", "empty", "other_identity"])
def test_a_refused_swap_leaves_the_old_generation(ckpts, tmp_path, where):
    pred = Predictor.from_checkpoint(ckpts["a"], batch=4, device="cpu")
    x = _grids()
    before, version, live = pred.forward_padded(x), pred.model_version, pred._weights
    if where == "missing":
        target, error = str(tmp_path / "nowhere"), FileNotFoundError
    elif where == "empty":
        os.makedirs(tmp_path / "empty")
        target, error = str(tmp_path / "empty"), FileNotFoundError
    else:
        target, error = _other_identity(ckpts, tmp_path), ValueError
    with pytest.raises(error):
        pred.swap_params(target)
    assert pred._weights is live and pred.model_version == version
    assert pred.checkpoint_dir == ckpts["a"]
    assert np.array_equal(pred.forward_padded(x), before)


def _corrupt_copy(src, dst) -> str:
    """A copy of checkpoint ``src`` with one byte of its step flipped."""
    import shutil

    shutil.copytree(src, dst)
    path = os.path.join(dst, checkpoint.step_filename(1))
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0xFF]))
    return dst


def test_reload_verifies_cordons_and_refuses_a_checksum_mismatch(ckpts, tmp_path,
                                                                 one_thread):
    """``reload`` cordons the service (``ready()`` false, ``reloading()``
    true) for the swap's duration, returns the new identity and the swap's
    ms, and refuses a candidate whose step does not match its checksum
    sidecar with the old version still serving and ready."""
    pred = Predictor.from_checkpoint(ckpts["a"], batch=4, device="cpu")
    service = InferenceService(pred, buckets=(1, 4), max_wait_ms=1)
    seen, swap = [], pred.swap_params

    def spy(ckpt):
        seen.append((service.ready(), service.reloading(), service.health()["ready"]))
        return swap(ckpt)

    pred.swap_params = spy
    try:
        grid = _grids(1)[0]
        first = service.predict(service.submit_voxels(grid), timeout=30)
        bad = _corrupt_copy(ckpts["b"], str(tmp_path / "bad"))
        with pytest.raises(checkpoint.ChecksumMismatch):
            service.reload(bad)
        assert seen == []  # refused before the swap began
        assert service.ready() and not service.reloading()
        assert pred.model_version.startswith("a@1-")
        assert service.predict(service.submit_voxels(grid), timeout=30) == first
        out = service.reload(ckpts["b"])
        assert seen == [(False, True, False)]
        assert service.ready() and not service.reloading()
        assert out["ok"] is True and out["model_version"].startswith("b@1-")
        assert out["from_version"].startswith("a@1-") and out["swap_ms"] > 0
        health = service.health()
        assert health["model_version"] == out["model_version"]
        assert health["checkpoint_dir"] == ckpts["b"]
        assert pred._weights.programs.batches() == [1, 4]
    finally:
        assert service.drain()["exit_code"] == 0


def _post_json(port, path, data: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_json(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_admin_reload_endpoint_contract():
    """The HTTP shape of the hot-swap endpoint against a stub service (the
    reference's test of the same name, tests/test_fleet.py): 400 on
    garbage, 409 ``swap_refused`` naming the refusal kind and the
    still-serving version, 200 with the new identity."""

    class _StubPredictor:
        model_version = "old@1-aaaa1111"

    class _StubService:
        predictor = _StubPredictor()

        def reload(self, checkpoint_dir):
            if "corrupt" in checkpoint_dir:
                raise ValueError("injected: candidate fails verify")
            return {"ok": True, "model_version": "new@2-bbbb2222",
                    "from_version": "old@1-aaaa1111", "swap_ms": 12.5}

    srv = make_server(_StubService(), "127.0.0.1", 0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        status, doc = _post_json(port, "/admin/reload", b"{nope")
        assert status == 400 and doc["error"] == "bad_json"
        status, doc = _post_json(port, "/admin/reload",
                                 json.dumps({"other": 1}).encode())
        assert status == 400 and doc["error"] == "bad_reload"
        status, doc = _post_json(port, "/admin/reload",
                                 json.dumps([1, 2]).encode())
        assert status == 400 and doc["error"] == "bad_reload"
        status, doc = _post_json(port, "/admin/reload", json.dumps(
            {"checkpoint_dir": "/tmp/corrupt"}).encode())
        assert status == 409, doc
        assert doc["error"] == "swap_refused" and doc["kind"] == "ValueError"
        assert doc["model_version"] == "old@1-aaaa1111"
        status, doc = _post_json(port, "/admin/reload", json.dumps(
            {"checkpoint_dir": "/tmp/good"}).encode())
        assert status == 200, doc
        assert doc["ok"] is True and doc["model_version"] == "new@2-bbbb2222"
        assert "POST /admin/reload" in ENDPOINTS
    finally:
        srv.shutdown()
        srv.server_close()


def test_admin_reload_over_http_swaps_a_real_service(ckpts, tmp_path, one_thread):
    """A smoke16 service from ``a`` behind the HTTP server: a corrupted
    candidate gets 409 and ``a`` keeps serving; ``/admin/reload`` to ``b``
    answers 200, ``/healthz`` then names ``b``, and ``/predict_voxels``
    answers with ``b``'s probabilities."""
    pred = Predictor.from_checkpoint(ckpts["a"], batch=4, device="cpu")
    service = InferenceService(pred, buckets=(1, 4), max_wait_ms=1)
    srv = make_server(service, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    grid = _grids(1)[0].astype("<f4")
    try:
        status, first = _post_json(port, "/predict_voxels", grid.tobytes())
        assert status == 200
        bad = _corrupt_copy(ckpts["b"], str(tmp_path / "bad"))
        status, doc = _post_json(port, "/admin/reload",
                                 json.dumps({"checkpoint_dir": bad}).encode())
        assert status == 409 and doc["kind"] == "ChecksumMismatch"
        assert doc["model_version"].startswith("a@1-")
        assert _post_json(port, "/predict_voxels", grid.tobytes()) == (200, first)
        status, doc = _post_json(port, "/admin/reload", json.dumps(
            {"checkpoint_dir": ckpts["b"]}).encode())
        assert status == 200 and doc["model_version"].startswith("b@1-")
        status, health = _get_json(port, "/healthz")
        assert status == 200 and health["ready"]
        assert health["model_version"] == doc["model_version"]
        assert health["checkpoint_dir"] == ckpts["b"]
        status, got = _post_json(port, "/predict_voxels", grid.tobytes())
        fresh = Predictor.from_checkpoint(ckpts["b"], batch=1, device="cpu")
        want = service.format_row(fresh.forward_padded(grid[None])[0])
        assert status == 200 and got["label"] == want["label"]
        assert abs(got["prob"] - want["prob"]) <= 1e-6
    finally:
        srv.shutdown()
        srv.server_close()
        assert service.drain()["exit_code"] == 0
