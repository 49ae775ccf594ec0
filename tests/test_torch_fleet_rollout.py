"""``cli fleet rollout`` against a live fleet in this process, on the CPU:
two in-process ``InferenceService``s at smoke16, each behind its own
HTTP server with a capture ring under ``<run>/capture/replica<slot>``,
behind the port's ``FleetRouter`` and its HTTP front end, the router's
``fleet_start`` in the run's stream 0. No subprocess. A self-rollout (the
same weights one step later) swaps both replicas and converges; a
candidate of another seed fails its canary, exits 2 and leaves both on
their version; ``swap_corrupt@swap=1`` is refused (409) and nothing
swaps; a refusal at the second replica rolls the first back; and the
canary's agreement is ``cli replay``'s on the same ring."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch

from featurenet_tpu_torch import cli, faults, obs
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.data.synthetic import generate_batch
from featurenet_tpu_torch.fleet.replica import Candidate
from featurenet_tpu_torch.fleet.router import FleetRouter
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.obs import alerts, incidents, windows
from featurenet_tpu_torch.runtime import build_model
from featurenet_tpu_torch.serve.http import make_server
from featurenet_tpu_torch.serve.recorder import FlightRecorder
from featurenet_tpu_torch.serve.service import InferenceService
from featurenet_tpu_torch.train.checkpoint import CheckpointManager
from featurenet_tpu_torch.train.state import create_state

REQUESTS = 24


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("rollout_ck")
    cfg = get_config("smoke16")
    out = {}
    for name, seed, step in (("ck", 0, 1), ("ck2", 0, 2), ("other", 5, 1)):
        state = create_state(build_model(cfg, seed=seed), cfg)
        state.step = step
        mgr = CheckpointManager(str(root / name), config=cfg)
        mgr.save(state)
        mgr.close()
        out[name] = str(root / name)
    return out


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # many small forwards

    def reset():
        faults.uninstall()
        incidents.reset()
        alerts.set_store(None)
        obs.close_run()
        windows.uninstall()

    reset()
    yield
    reset()
    torch.set_num_threads(threads)


class LiveFleet:
    """The router's provider over in-process services: every replica ready,
    its version read live off the service; ``first`` is the least loaded."""

    def __init__(self, services, ports):
        self.services, self.ports = services, ports
        self.first = 0

    def candidates(self):
        return sorted((Candidate(s, "127.0.0.1", p, int(s != self.first))
                       for s, p in enumerate(self.ports)),
                      key=lambda c: (c.score, c.slot))

    def note_inflight(self, slot, delta):
        pass

    def note_failure(self, slot):
        pass

    def kill_one(self):
        return None

    def ready_count(self):
        return len(self.ports)

    def stats(self):
        return {"replicas": len(self.ports),
                "ports": dict(enumerate(self.ports)),
                "versions": {s: svc.health()["model_version"]
                             for s, svc in enumerate(self.services)}}


@pytest.fixture
def fleet(tmp_path, checkpoints):
    run = str(tmp_path / "run")
    services, servers = [], []
    for slot in range(2):
        pred = Predictor.from_checkpoint(checkpoints["ck"], batch=4,
                                         device="cpu")
        rec = FlightRecorder(os.path.join(run, "capture", f"replica{slot}"),
                             sample=1.0)
        svc = InferenceService(pred, buckets=(1, 4), rules=(), recorder=rec,
                               replica=str(slot))
        srv = make_server(svc, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        services.append(svc)
        servers.append(srv)
    live = LiveFleet(services, [s.server_address[1] for s in servers])
    router = FleetRouter(live, rules=(), scale_every_s=3600.0)
    front = router.make_server("127.0.0.1", 0)
    threading.Thread(target=front.serve_forever, daemon=True).start()
    obs.init_run(run, extra={"cmd": "fleet"}, process_index=0, devices=False)
    obs.emit("fleet_start", replicas=2, host="127.0.0.1",
             port=front.server_address[1])
    obs.close_run()
    grids = generate_batch(np.random.default_rng(1), REQUESTS, 16)["voxels"]
    for i, g in enumerate(grids):
        live.first = i % 2  # each ring holds half the traffic
        status, _, _ = router.route("/predict_voxels",
                                    np.ascontiguousarray(g, "<f4").tobytes())
        assert status == 200, i
    yield {"run": run, "services": services, "router": router}
    router.drain()
    front.shutdown()
    front.server_close()
    for srv, svc in zip(servers, services):
        srv.shutdown()
        srv.server_close()
        svc.drain()


def _rollout(capsys, ck: str, run: str) -> tuple[int, dict]:
    capsys.readouterr()
    rc = cli.main(["fleet", "rollout", ck, "--run-dir", run, "--device", "cpu"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith('{"fleet_rollout"')]
    assert len(out) == 1
    return rc, out[0]["fleet_rollout"]


def _versions(fleet) -> set:
    return {s.health()["model_version"] for s in fleet["services"]}


def _events(run: str, ev: str) -> list[dict]:
    with open(os.path.join(run, "events.1000.jsonl")) as fh:
        return [e for e in map(json.loads, fh) if e["ev"] == ev]


def test_self_rollout_swaps_every_replica_and_converges(fleet, checkpoints,
                                                        capsys):
    before = _versions(fleet)
    rc, out = _rollout(capsys, checkpoints["ck2"], fleet["run"])
    assert rc == 0 and out["ok"] and out["converged"]
    assert out["swapped"] == [0, 1]
    assert [s["agreement"] for s in out["steps"]] == [1.0, 1.0]
    assert [s["canary_n"] for s in out["steps"]] == [REQUESTS // 2] * 2
    assert _versions(fleet) == {out["version"]} and out["version"] not in before
    assert [e["ok"] for e in _events(fleet["run"], "rollout_done")] == [True]


def test_other_seed_fails_the_canary_and_exits_2(fleet, checkpoints, capsys):
    before = _versions(fleet)
    rc, out = _rollout(capsys, checkpoints["other"], fleet["run"])
    assert rc == 2 and not out["ok"]
    assert out["reason"].startswith("canary_failed(replica=0,")
    assert out["rolled_back"] == [] and out["converged"]
    assert _versions(fleet) == before
    # The canary's arithmetic is `cli replay`'s on the same ring.
    verdict = _events(fleet["run"], "replay_verdict")[0]
    ring = os.path.join(fleet["run"], "capture", "replica0")
    capsys.readouterr()
    assert cli.main(["replay", ring, "--checkpoint-dir", checkpoints["other"],
                     "--device", "cpu", "--min-agreement", "0"]) == 0
    replay = json.loads(capsys.readouterr().out.splitlines()[-1])["replay"]
    assert replay["agreement"] == verdict["agreement"] < 0.967
    assert replay["n"] == verdict["n"]
    assert replay["flips"] and sum(replay["flips"].values()) == verdict["flips"]


def test_swap_corrupt_is_refused_and_nothing_swaps(fleet, checkpoints, capsys):
    before = _versions(fleet)
    faults.install("swap_corrupt@swap=1")
    rc, out = _rollout(capsys, checkpoints["ck2"], fleet["run"])
    assert rc == 2
    assert out["reason"] == "swap_refused(replica=0,kind=ChecksumMismatch)"
    assert out["steps"] == [] and out["rolled_back"] == []
    assert _versions(fleet) == before


def test_refusal_at_the_second_replica_rolls_the_first_back(
        fleet, checkpoints, capsys, monkeypatch):
    before = _versions(fleet)

    def refuse(ckpt):
        raise ValueError("refused")

    monkeypatch.setattr(fleet["services"][1], "reload", refuse)
    rc, out = _rollout(capsys, checkpoints["ck2"], fleet["run"])
    assert rc == 2
    assert out["reason"] == "swap_refused(replica=1,kind=ValueError)"
    assert [s["replica"] for s in out["steps"]] == [0]
    assert out["rolled_back"] == [0] and out["rollback_failed"] == []
    assert out["converged"] and _versions(fleet) == before
    rb = _events(fleet["run"], "rollout_rollback")
    assert [e["rolled_back"] for e in rb] == [[0]]
