"""The port's supervisor and heartbeat against the JAX package's, on the
CPU. Both ``supervise`` functions run the same scripted fake children
(``python -c`` scripts coordinating through files), the JAX one with
``run_dir=None``; each case must give the same ``SuperviseResult`` and the
same sequence of record kinds. Both ``HeartbeatMonitor`` classes read the
same scripted mtimes; ``child_argv_from_cli`` strips the same flags. The
supervised ``cli train`` never touches CUDA in the supervisor process.
Exact equality throughout."""

import json
import os
import sys
import time

import pytest

from featurenet_tpu import faults as jax_faults
from featurenet_tpu.train import heartbeat as jax_heartbeat
from featurenet_tpu.train import supervisor as jax_supervisor
from featurenet_tpu_torch import faults
from featurenet_tpu_torch.train import heartbeat, supervisor

POLL_S = 0.05
STALL_S = 1.0


@pytest.fixture(autouse=True)
def _no_port_plan():
    faults.uninstall()
    yield
    faults.uninstall()


def _attempt(d):
    """Preamble of a fake child: ``n`` is this attempt's ordinal (0 first),
    ``beat()`` touches the heartbeat."""
    return (
        "import os, sys, time\n"
        f"a={str(d / 'attempts')!r}; hb={str(d / 'hb')!r}\n"
        "n = len(open(a).read()) if os.path.exists(a) else 0\n"
        "open(a, 'a').write('x')\n"
        "def beat():\n"
        "    time.sleep(0.05); open(hb, 'a').close(); os.utime(hb, None)\n"
    )


CASES = {
    "exit0": "beat()\n",
    "crash_then_success": "beat()\nsys.exit(3 if n == 0 else 0)\n",
    "hang_after_beat": "beat()\nif n == 0:\n    time.sleep(60)\n",
    "exit75_after_beat": "beat()\nsys.exit(75 if n < 2 else 0)\n",
    "exit75_before_beat": "if n == 0:\n    sys.exit(75)\nbeat()\n",
    "two_startup_failures": "sys.exit(4)\n",
    "spawn_fail": "beat()\n",
    "crashes_past_the_budget": "beat()\nsys.exit(9)\n",
}


def _run(pkg, tmp_path, case):
    d = tmp_path / f"{case}_{pkg}"
    d.mkdir()
    mod = supervisor if pkg == "port" else jax_supervisor
    if case == "spawn_fail":
        (faults if pkg == "port" else jax_faults).install("spawn_fail@spawn=1")
    records = []
    kw = dict(heartbeat_file=str(d / "hb"), stall_timeout_s=STALL_S,
              max_restarts=2, poll_s=POLL_S, grace_s=30.0,
              log=lambda line: records.append(json.loads(line)),
              backoff_base_s=0.0)
    if pkg == "jax":
        kw["run_dir"] = None
    try:
        res = mod.supervise([sys.executable, "-c", _attempt(d) + CASES[case]], **kw)
    finally:
        faults.uninstall()
        jax_faults.uninstall()
    return res, [r["supervisor"] for r in records], records


@pytest.mark.parametrize("case", sorted(CASES))
def test_supervise_matches_jax(tmp_path, case):
    port, port_kinds, records = _run("port", tmp_path, case)
    ref, ref_kinds, _ = _run("jax", tmp_path, case)
    assert dataclasses_tuple(port) == dataclasses_tuple(ref)
    assert port_kinds == ref_kinds
    want = {
        "exit0": (0, 0, 0, 0),
        "crash_then_success": (0, 1, 0, 0),
        "hang_after_beat": (0, 1, 1, 0),
        "exit75_after_beat": (0, 0, 0, 2),
        "exit75_before_beat": (0, 1, 0, 0),
        "two_startup_failures": (4, 1, 0, 0),
        "spawn_fail": (0, 1, 0, 0),
        "crashes_past_the_budget": (9, 2, 0, 0),
    }[case]
    assert dataclasses_tuple(port) == want
    if case == "hang_after_beat":
        stall = next(r for r in records if r["supervisor"] == "stall")
        assert STALL_S <= stall["heartbeat_age_s"] <= STALL_S + 1.0
        assert not os.path.exists(f"/proc/{stall['pid']}")  # killed and reaped
    if case == "spawn_fail":
        assert [r.get("reason") for r in records
                if r["supervisor"] == "restart"] == ["exit_13"]


def dataclasses_tuple(res):
    return (res.exit_code, res.restarts, res.stalls, res.planned)


def test_heartbeat_monitor_matches_jax(tmp_path):
    """Both monitors over scripted mtimes: the grace before the first beat,
    the sticky ``beaten`` flag, a stale age after a beat, the re-created
    deleted file, and ``recheck``."""
    out = {}
    for pkg, mod in (("port", heartbeat), ("jax", jax_heartbeat)):
        path = str(tmp_path / f"hb_{pkg}")
        mon = mod.HeartbeatMonitor(path, stall_timeout_s=5.0, grace_s=0.2)
        seq = []
        mon.reset()
        seq.append((mon.poll(), mon.beaten))
        time.sleep(0.25)
        seq.append((mon.poll(), mon.beaten))  # no beat past the grace
        mon.reset()
        now = time.time()
        os.utime(path, (now + 1, now + 1))  # a beat
        seq.append((mon.poll(), mon.beaten))
        os.utime(path, (now - 10, now - 10))  # silent for 10 s after beating
        seq.append((mon.poll(), mon.beaten))
        os.unlink(path)  # an external cleaner
        seq.append((mon.poll(), mon.beaten, os.path.exists(path)))
        mon.reset()
        seq.append(mon.recheck())
        os.utime(path, (now + 2, now + 2))
        seq.append(mon.recheck())
        mod.touch_heartbeat(str(tmp_path / f"new_{pkg}"))
        seq.append(os.path.exists(tmp_path / f"new_{pkg}"))
        out[pkg] = seq
    assert out["port"] == out["jax"]
    assert out["port"][:4] == [("ok", False), ("stall", False), ("ok", True),
                               ("stall", True)]


@pytest.mark.parametrize("argv", [
    ["train", "--config", "pod64", "--supervise", "--stall-timeout", "30",
     "--max-restarts=9", "--checkpoint-dir", "runs/x"],
    ["train", "--supervise", "--heartbeat-file", "/a/hb", "--restart-every", "4",
     "--inject-faults", "sigterm@step=2", "--stall-timeout=5",
     "--heartbeat-file=/b", "--checkpoint-dir", "c"],
])
def test_child_argv_matches_jax(argv):
    port = supervisor.child_argv_from_cli(argv, "/tmp/hb")
    ref = jax_supervisor.child_argv_from_cli(argv, "/tmp/hb")
    assert port[:3] == [sys.executable, "-m", "featurenet_tpu_torch.cli"]
    assert ref[:3] == [sys.executable, "-m", "featurenet_tpu.cli"]
    assert port[3:] == ref[3:]
    assert port[-3:] == ["--heartbeat-file", "/tmp/hb", "--supervised-child"]
    assert supervisor.RESTART_EXIT_CODE == jax_supervisor.RESTART_EXIT_CODE == 75


def test_cli_supervisor_creates_no_cuda_context(monkeypatch, tmp_path):
    """``cli train --supervise`` reaches ``supervise`` with CUDA never
    initialised in its process, installs only ``spawn_fail`` of the spec,
    hands the child the whole command, and exits with its code; the
    refusals come first."""
    import torch

    from featurenet_tpu_torch import cli

    seen = {}

    def fake_supervise(argv, heartbeat_file, **kw):
        seen.update(argv=argv, hb=heartbeat_file, kw=kw,
                    cuda=torch.cuda.is_initialized(),
                    spawn_fail=faults.maybe_fail("spawn_fail", spawn=1),
                    sigterm=faults.maybe_fail("sigterm", step=9))
        return supervisor.SuperviseResult(7, 0, 0)

    monkeypatch.setattr(supervisor, "supervise", fake_supervise)
    argv = ["train", "--config", "smoke16", "--device", "cpu", "--supervise",
            "--checkpoint-dir", str(tmp_path / "ck"), "--stall-timeout", "3",
            "--inject-faults", "sigterm@step=2,spawn_fail@spawn=1",
            "--restart-every", "4"]
    assert cli.main(argv) == 7
    assert not seen["cuda"] and seen["spawn_fail"] and not seen["sigterm"]
    assert seen["argv"][3:] == argv[:5] + argv[6:8] + argv[10:] + [
        "--heartbeat-file", seen["hb"], "--supervised-child"]
    assert seen["kw"]["stall_timeout_s"] == 3.0
    assert not os.path.exists(seen["hb"])  # the private heartbeat is removed
    for bad, match in (
            (["train", "--supervise"], "requires --checkpoint-dir"),
            (["train", "--restart-every", "4", "--checkpoint-dir", "c"],
             "requires --supervise"),
            (["train", "--supervise", "--checkpoint-dir", "c",
              "--inject-faults", "replica_loss@request=1"], "not wired")):
        with pytest.raises(SystemExit, match=match):
            cli.main(bad)
