"""The one real multi-process fleet on the CPU: ``cli fleet --device cpu``
with two ``cli serve`` children at smoke16 (buckets 1,4, one torch thread
each), ~60 open-loop requests through the router with
``replica_loss@request=20``: nothing dropped, the killed slot back in
``membership.json`` (``replica_rejoin``), every label a port
``Predictor``'s. Then one ``cli fleet rollout`` whose first swap SIGKILLs
its replica (``replica_loss_rollout@swap=1``, a child-side site on every
replica's argv, fired once per run through the run directory's markers):
it rolls back and exits 2, as the reference does
(``tests/test_fleet.py:2027``), and the fleet drains with exit 0."""

from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.data.synthetic import generate_batch
from featurenet_tpu_torch.elastic.membership import read_membership
from featurenet_tpu_torch.fleet.loadgen import http_load
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.runtime import build_model
from featurenet_tpu_torch.train.checkpoint import CheckpointManager
from featurenet_tpu_torch.train.state import create_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUESTS = 60
DEADLINE_S = 120.0


def _health(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    except (OSError, ValueError):
        return {}
    finally:
        conn.close()


def _until(what: str, cond) -> None:
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} within {DEADLINE_S} s")
        time.sleep(0.1)


def test_fleet_survives_replica_loss_and_rolls_back_a_killed_swap(tmp_path):
    cfg = get_config("smoke16")
    ck = str(tmp_path / "ck")
    state = create_state(build_model(cfg, seed=0), cfg)
    state.step = 1
    mgr = CheckpointManager(ck, config=cfg)
    mgr.save(state)
    mgr.close()
    grids = generate_batch(np.random.default_rng(3), 12, 16)["voxels"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, _ = Predictor.from_checkpoint(ck, batch=4, device="cpu") \
            .predict_voxels(grids)
    finally:
        torch.set_num_threads(threads)
    run = str(tmp_path / "run")
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "featurenet_tpu_torch.cli"]
    proc = subprocess.Popen(
        cmd + ["fleet", "--checkpoint-dir", ck, "--replicas", "2", "--device",
               "cpu", "--buckets", "1,4", "--port", "0", "--run-dir", run,
               "--capture", "--capture-sample", "1.0", "--drain",
               "--inject-faults",
               "replica_loss@request=20,replica_loss_rollout@swap=1"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port = json.loads(proc.stdout.readline())["fleet"]["port"]
        _until("both replicas ready", lambda: _health(port).get("healthy") == 2)
        st, outs = http_load("127.0.0.1", port, 20.0, REQUESTS, grids)
        assert st["dropped"] == 0 and st["answered"] == REQUESTS, st
        assert [o["label"] for o in outs] == \
            [int(want[i % len(grids)]) for i in range(REQUESTS)]

        def rejoined():
            m = read_membership(run)
            return m is not None and m.reason == "replica_rejoin" \
                and m.members == (0, 1)

        _until("the killed slot's rejoin", rejoined)
        version = set(_health(port)["versions"].values())
        rp = subprocess.run(cmd + ["fleet", "rollout", ck, "--run-dir", run,
                                   "--device", "cpu"],
                            cwd=str(tmp_path), env=env, capture_output=True,
                            text=True, timeout=120)
        assert rp.returncode == 2, rp.stderr[-2000:]
        out = json.loads(rp.stdout.strip().splitlines()[-1])["fleet_rollout"]
        assert not out["ok"] and out["reason"] == "replica_lost(replica=0)"
        assert out["rolled_back"] == [] and out["converged"]
        _until("the swapped-away slot's rejoin",
               lambda: _health(port).get("rejoins") == 2
               and _health(port).get("healthy") == 2)
        assert set(_health(port)["versions"].values()) == version
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-2000:]
    stats = json.loads(stdout.strip().splitlines()[-1])["fleet_stats"]
    assert stats["dropped"] == 0
    assert stats["replicas"]["losses"] == 2 and stats["replicas"]["rejoins"] == 2
    with open(os.path.join(run, "events.jsonl")) as fh:
        kinds = [json.loads(ln)["ev"] for ln in fh]
    assert kinds.count("fleet_replica_loss") == 2
    assert os.path.exists(os.path.join(run, "fault_replica_loss.fired"))
    assert os.path.exists(os.path.join(run, "fault_replica_loss_rollout.fired"))
    for slot in (0, 1):
        assert os.path.exists(os.path.join(run, f"events.{slot + 1}.jsonl"))
    with open(os.path.join(run, "run.json")) as fh:
        assert json.load(fh)["torch"]["devices"] == []
