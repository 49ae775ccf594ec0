"""Recovery in the port, on the CPU at smoke16: the fault sites of the
train loop, the checkpoints, the input threads, the cache and the hot
swap, each against the behaviour of the JAX package's
(``tests/test_faults.py``, ``tests/test_recovery_e2e.py``):

- a ``sigterm`` preempts a resident k = 3 run at the first dispatch
  boundary past N, saving that step and exiting 75; a fresh Trainer on the
  same directory finishes bitwise equal to an unbroken run;
- the heartbeat is touched only after confirmed progress (a paced
  completion, an eval batch read back), never at loop entry;
- ``checkpoint_corrupt`` truncates the step and skips its sidecar, so a
  resume walks back; ``checkpoint_restore_error`` walks back without
  touching the disk; ``save_slow`` drags the writer, never ``save``;
- ``producer_crash`` and ``cache_read_error`` surface as
  ``ProducerError``; a ``producer_hang`` still lets ``close()`` return;
- ``swap_corrupt`` answers ``POST /admin/reload`` with 409 while the old
  generation answers bitwise, and the next reload swaps; ``replica_slow``
  drags a forward;
- ``cli train --supervise`` with a preemption and a truncated checkpoint
  ends with exit 0 and the last step on disk;
- the JAX and port trainers, on the same config with
  ``restart_every_steps`` and a ``sigterm`` site, exit 75 at the same steps
  and leave the same checkpoint steps.

Exact equality throughout (bitwise states, identical step lists); the
resumed run is bitwise because every draw is a function of (seed, step,
stream) and the restore copies every tensor a step reads.
"""

import dataclasses
import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from featurenet_tpu import faults as jax_faults
from featurenet_tpu_torch import faults
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.data import offline, synthetic
from featurenet_tpu_torch.data.dataset import (
    Prefetcher,
    ProducerError,
    SyntheticVoxelDataset,
)
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.models.featurenet import FeatureNet, init_weights
from featurenet_tpu_torch.serve.http import make_server
from featurenet_tpu_torch.serve.service import InferenceService
from featurenet_tpu_torch.train import loop
from featurenet_tpu_torch.train.checkpoint import CheckpointManager, checksum_path
from featurenet_tpu_torch.train.loop import Trainer
from featurenet_tpu_torch.train.state import create_state
from featurenet_tpu_torch.train.supervisor import RESTART_EXIT_CODE
from test_torch_reload import _post_json

ROOT = pathlib.Path(__file__).resolve().parents[1]
R = 16


@pytest.fixture(autouse=True)
def _no_port_plan():
    faults.uninstall()
    yield
    faults.uninstall()


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recovery") / "c16")
    offline.export_synthetic_cache(root, per_class=3, resolution=R, seed=1)
    return root


def _resident(cache, **kw):
    base = dict(data_cache=cache, hbm_cache=True, global_batch=8,
                steps_per_dispatch=3, total_steps=9, log_every=10**6,
                eval_every=10**6, checkpoint_every=10**6, data_workers=1)
    return get_config("smoke16", **{**base, **kw})


def _states_equal(a, b) -> bool:
    return (a.state.step == b.state.step
            and all(torch.equal(x, y)
                    for x, y in zip(a.state.tensors(), b.state.tensors())))


def test_sigterm_exits_75_at_the_boundary_and_resumes_bitwise(cache, tmp_path):
    ck, hb = str(tmp_path / "ck"), str(tmp_path / "hb")
    cfg = _resident(cache, checkpoint_dir=ck, heartbeat_file=hb,
                    inject_faults="sigterm@step=4")
    out = io.StringIO()
    t = Trainer(cfg, device="cpu", stream=out)
    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as e:
        t.run()
    assert e.value.code == RESTART_EXIT_CODE
    assert signal.getsignal(signal.SIGTERM) is prev
    assert t.state.step == 6 and t.ckpt.all_steps() == [6]  # 4 crossed at 6
    assert os.path.exists(hb) and os.path.exists(os.path.join(ck, "fault_sigterm.fired"))
    records = [json.loads(line) for line in out.getvalue().splitlines()]
    assert records[-1] == {"step": 6, "kind": "setup", "preempt_exit": 1.0}
    # A respawned process: the same spec, whose marker keeps it from firing.
    faults.uninstall()
    resumed = Trainer(cfg, device="cpu", stream=io.StringIO())
    resumed.run()
    assert resumed.state.step == 9 and resumed.ckpt.latest_step() == 9
    unbroken = Trainer(dataclasses.replace(cfg, checkpoint_dir=None,
                                           inject_faults=None, heartbeat_file=None),
                       device="cpu", stream=io.StringIO())
    unbroken.run()
    assert _states_equal(resumed, unbroken)


def test_heartbeat_only_after_confirmed_progress(cache, tmp_path, monkeypatch):
    """k = 3 with max_inflight_steps 3: one dispatch in flight, so the
    first beat follows the second dispatch (the first one's completion);
    then one per dispatch, and one per eval batch read back and after the
    eval. None at loop entry."""
    cfg = _resident(cache, max_inflight_steps=3, heartbeat_file=str(tmp_path / "hb"))
    t = Trainer(cfg, device="cpu", stream=io.StringIO())
    beats = []
    monkeypatch.setattr(loop, "touch_heartbeat",
                        lambda path: beats.append(t.state.step))
    t.run()
    n_eval = t.logger.history[-1]["batches"]
    assert n_eval >= 1 and beats == [6, 9] + [9] * (int(n_eval) + 1)


def _small_state(step=0):
    cfg = get_config("smoke16")
    model = FeatureNet(cfg.arch, cfg.resolution)
    init_weights(model, 0)
    state = create_state(model, cfg)
    state.step = step
    return state


def test_checkpoint_fault_sites(tmp_path):
    # checkpoint_corrupt: the second save is truncated with no sidecar.
    faults.install("checkpoint_corrupt@save=2")
    mgr = CheckpointManager(str(tmp_path / "a"))
    for step in (1, 2):
        mgr.save(_small_state(step))
    mgr.wait()
    path = tmp_path / "a" / "step_2.pt"
    assert path.stat().st_size < (tmp_path / "a" / "step_1.pt").stat().st_size
    assert not os.path.exists(checksum_path(str(tmp_path / "a"), 2))
    state = _small_state()
    mgr.restore(state, cleanup=True)
    assert state.step == 1 and mgr.all_steps() == [1]
    mgr.close()
    # checkpoint_restore_error: the first attempt fails, the disk is kept.
    faults.install("checkpoint_restore_error@restore=1")
    mgr = CheckpointManager(str(tmp_path / "b"))
    for step in (1, 2):
        mgr.save(_small_state(step))
    mgr.wait()
    state = _small_state()
    mgr.restore(state)
    assert state.step == 1 and mgr.all_steps() == [1, 2]
    mgr.close()
    # save_slow: the writer drags, the step thread's save does not.
    faults.install("save_slow@save=2")
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(_small_state(1))
    mgr.wait()
    second = _small_state(2)
    t0 = time.perf_counter()
    mgr.save(second)
    enqueue = time.perf_counter() - t0
    mgr.wait()
    written = time.perf_counter() - t0
    assert enqueue < faults.SLOW_SLEEP_S <= written
    assert mgr.all_steps() == [1, 2]
    mgr.close()


def test_input_fault_sites(cache):
    faults.install("producer_crash@batch=1")
    it = Prefetcher(SyntheticVoxelDataset(R, 2, seed=0), "cpu", num_workers=1)
    next(it)  # ticket 0 is clean
    with pytest.raises(ProducerError) as exc:
        next(it)
    assert exc.value.worker == 0 and isinstance(exc.value.__cause__,
                                                faults.InjectedFault)
    it.close()
    faults.install("producer_hang@batch=1")
    it = Prefetcher(SyntheticVoxelDataset(R, 2, seed=0), "cpu", num_workers=1)
    next(it)
    t0 = time.monotonic()
    it.close()  # the hung worker is released by the stop event
    assert time.monotonic() - t0 < 5.0
    assert not any(t.is_alive() for t in it._threads)
    faults.install("cache_read_error@read=2")
    ds = offline.VoxelCacheDataset(cache, global_batch=4, split="train", seed=0)
    it = Prefetcher(ds, "cpu", num_workers=1)
    try:
        next(it)
        with pytest.raises(ProducerError, match="cache_read_error"):
            next(it)
            next(it)
    finally:
        it.close()


def _seeded_checkpoint(path, seed) -> str:
    cfg = get_config("smoke16")
    model = FeatureNet(cfg.arch, cfg.resolution)
    init_weights(model, seed)
    state = create_state(model, cfg)
    state.step = 1
    mgr = CheckpointManager(str(path), config=cfg)
    mgr.save(state)
    mgr.close()
    return str(path)


def test_swap_corrupt_is_refused_and_the_old_generation_serves(tmp_path):
    a = _seeded_checkpoint(tmp_path / "a", 0)
    b = _seeded_checkpoint(tmp_path / "b", 1)
    faults.install("swap_corrupt@swap=1,replica_slow@request=1")
    service = InferenceService(Predictor.from_checkpoint(a, batch=4, device="cpu"),
                               buckets=(1, 4), max_wait_ms=1)
    srv = make_server(service, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    grid = synthetic.generate_batch(np.random.default_rng(5), 1, R)["voxels"][0]
    body = grid.astype("<f4").tobytes()
    try:
        t0 = time.perf_counter()
        status, first = _post_json(port, "/predict_voxels", body)
        assert status == 200 and time.perf_counter() - t0 >= faults.SLOW_SLEEP_S
        status, doc = _post_json(port, "/admin/reload",
                                 json.dumps({"checkpoint_dir": b}).encode())
        assert status == 409 and doc["error"] == "swap_refused"
        assert doc["kind"] == "ChecksumMismatch" and doc["model_version"].startswith("a@1-")
        assert _post_json(port, "/predict_voxels", body) == (200, first)
        status, doc = _post_json(port, "/admin/reload",
                                 json.dumps({"checkpoint_dir": b}).encode())
        assert status == 200 and doc["model_version"].startswith("b@1-")
        assert _post_json(port, "/predict_voxels", body)[1] != first
    finally:
        srv.shutdown()
        srv.server_close()
        st = service.drain()
    # replica_slow dragged the first request past the default 250 ms SLO:
    # the drain names the serving alert and exits 2.
    assert st["active_serving_alerts"] == ["serving_p99_ms"]
    assert st["exit_code"] == 2


def test_cli_supervised_run_survives_preemption_and_a_torn_step(tmp_path):
    """Child 1 saves steps 1 and 2 (the second truncated) and is preempted
    at step 2: exit 75, a free respawn. Child 2 walks back past the torn
    step to step 1 and finishes: the supervisor exits 0 with step 4 on
    disk and one planned restart."""
    ck = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-m", "featurenet_tpu_torch.cli", "train", "--config",
         "smoke16", "--device", "cpu", "--total-steps", "4", "--global-batch", "4",
         "--eval-batches", "1", "--checkpoint-every", "1", "--data-workers", "1",
         "--checkpoint-dir", ck, "--supervise", "--stall-timeout", "60",
         "--inject-faults", "sigterm@step=2,checkpoint_corrupt@save=2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    sup = [r["supervisor"] for r in lines if "supervisor" in r]
    assert sup == ["spawn", "planned_restart", "spawn", "done"]
    assert lines[-1] == {"supervisor": "done", "restarts": 0, "stalls": 0,
                         "planned": 1}
    exits = [r for r in lines if r.get("kind") == "setup" and "preempt_exit" in r]
    assert [r["step"] for r in exits] == [2]
    fallback = [json.loads(line)["checkpoint_fallback"]
                for line in proc.stderr.splitlines()
                if line.startswith('{"checkpoint_fallback"')]
    assert fallback == [{"from_step": 2, "to_step": 1}]
    assert CheckpointManager(ck).latest_step() == 4
    assert os.path.exists(os.path.join(ck, "step_4.pt"))


def test_segments_and_preemption_exit_where_jax_exits(tmp_path):
    """One JAX and one port Trainer, each run twice on its own directory:
    a 4-step segment exits 75 at step 4, then the resumed run is preempted
    by ``sigterm@step=6`` and exits 75 at step 6, both packages leaving
    steps 2, 4 and 6 on disk."""
    from featurenet_tpu.config import get_config as jax_get_config
    from featurenet_tpu.train.loop import Trainer as JaxTrainer

    over = dict(total_steps=8, restart_every_steps=4, inject_faults="sigterm@step=6",
                checkpoint_every=2, global_batch=8, data_workers=1,
                eval_every=10**6, log_every=10**6, eval_batches=1)
    exits = {}
    jax_ck, port_ck = str(tmp_path / "jax"), str(tmp_path / "port")
    trainers = {
        "jax": JaxTrainer(jax_get_config("smoke16", checkpoint_dir=jax_ck, **over)),
        "port": Trainer(get_config("smoke16", checkpoint_dir=port_ck, **over),
                        device="cpu", stream=io.StringIO()),
    }
    try:
        for pkg, t in trainers.items():
            exits[pkg] = []
            for _ in range(2):
                with pytest.raises(SystemExit) as e:
                    t.run()
                exits[pkg].append((e.value.code, int(t.state.step)))
    finally:
        jax_faults.uninstall()
    assert exits["port"] == exits["jax"] == [(75, 4), (75, 6)]
    jax_steps = sorted(int(n) for n in os.listdir(jax_ck) if n.isdigit())
    assert trainers["port"].ckpt.all_steps() == jax_steps == [2, 4, 6]
