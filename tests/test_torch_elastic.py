"""Elastic training in the port (``featurenet_tpu_torch/elastic/``, ``cli
train --elastic``) against the JAX package's (``featurenet_tpu/elastic/``).

1. The planner's three functions against the reference's over a grid of
   global batches, devices per host, world sizes and floors, the refusals
   (``InfeasibleWorld``, ``ValueError``) with the same words.
2. Both coordinators over the same fake children (``python -c`` scripts
   that beat a heartbeat file and exit with a code; no torch, no JAX),
   every scenario run by both packages side by side in threads: the
   ``ElasticResult``, the ``mesh_reform``, ``host_leave`` and ``host_join``
   events, the ``supervisor`` phases and the final ``membership.json``
   must be equal. Scenarios: a shrink, a re-admission at a planned
   boundary, a full-world loss below ``min_world_size``, a re-admitted
   host that fails to come up and is shed again, ``readmit="agent"``, one
   rank exiting 75 beside a rank that hangs (a SIGTERM reaches each rank's
   loop alone), a startup failure retried, the give-up verdicts, and
   ``spawn_fail``.
3. The CLI: the refusals against the reference's on the same command
   lines, an elastic child's command line against the reference's
   ``child_argv_from_cli``, the config the coordinator plans with reaching
   every child (``pod64`` without ``--config``), a child asked for the
   card that is not there.
4. The Config fields, and a JAX ``config.json`` carrying them.
5. One real ``cli train --elastic`` of two CPU processes (gloo, smoke16):
   ``host_loss`` after step 1 shrinks the world to one rank, the planned
   boundary at step 4 grows it back to two, the budget of 5 steps is
   reached, and the merged report counts three re-forms.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import os
import subprocess
import sys

import pytest

from featurenet_tpu import faults as ref_faults
from featurenet_tpu.elastic import coordinator as ref_coordinator
from featurenet_tpu.elastic import planner as ref_planner
from featurenet_tpu_torch import faults
from featurenet_tpu_torch.elastic import coordinator, planner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- 1. the planner ----------------------------------------------------------

BATCHES = (1, 3, 6, 8, 12, 25, 96, 128, 256)


def _outcome(fn, *a, **kw):
    """``("ok", value)`` or ``(exception class name, message)``."""
    try:
        return ("ok", fn(*a, **kw))
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("local_devices", [0, 1, 2, 4])
def test_feasible_world_sizes_match_the_reference(local_devices):
    for batch, hosts in itertools.product((0,) + BATCHES, range(7)):
        got = _outcome(planner.feasible_world_sizes, batch, local_devices, hosts)
        want = _outcome(ref_planner.feasible_world_sizes, batch, local_devices,
                        hosts)
        assert got == want, (batch, local_devices, hosts)


@pytest.mark.parametrize("world", [-1, 0, 1, 2, 3, 4, 5, 8])
def test_per_host_batch_matches_the_reference(world):
    for batch in BATCHES:
        got = _outcome(planner.per_host_batch, batch, world)
        assert got == _outcome(ref_planner.per_host_batch, batch, world)


@pytest.mark.parametrize("min_world_size", [0, 1, 2, 3])
def test_plan_world_matches_the_reference(min_world_size):
    refusals = 0
    for n in range(6):
        for available in itertools.combinations(range(5), n):
            for batch, local in itertools.product(BATCHES, (1, 2)):
                kw = dict(min_world_size=min_world_size, global_batch=batch,
                          local_devices=local)
                got = _outcome(planner.plan_world, list(available), **kw)
                want = _outcome(ref_planner.plan_world, list(available), **kw)
                assert got == want, (available, kw)
                refusals += got[0] != "ok"
    assert refusals  # the grid reaches the refusals


def test_infeasible_world_is_a_runtime_error_and_the_default_is_one_device():
    assert issubclass(planner.InfeasibleWorld, RuntimeError)
    with pytest.raises(planner.InfeasibleWorld):
        planner.plan_world([0], min_world_size=2, global_batch=8)
    assert planner.plan_world([3, 0, 2], min_world_size=1,
                              global_batch=4) == (0, 2)


def test_the_package_exports_the_references_names():
    import featurenet_tpu.elastic as ref
    import featurenet_tpu_torch.elastic as port

    names = ("ElasticCoordinator", "ElasticResult", "plan_world",
             "feasible_world_sizes", "per_host_batch", "InfeasibleWorld",
             "heartbeat_path", "Membership", "MEMBERSHIP_FILENAME",
             "read_membership", "write_membership", "signal_ready",
             "ready_slots")
    for name in names:
        assert hasattr(ref, name) and hasattr(port, name), name
    assert ([f.name for f in dataclasses.fields(port.ElasticResult)]
            == [f.name for f in dataclasses.fields(ref.ElasticResult)])


def test_the_coordinator_imports_neither_torch_nor_jax():
    code = ("import sys\n"
            "import featurenet_tpu_torch.elastic\n"
            "bad = [m for m in ('torch', 'jax', 'numpy') if m in sys.modules]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# --- 2. the coordinators over fake children ----------------------------------

HANG = "import time; time.sleep(60)"
# A child that fails before it ever beats (a host that cannot come up).
NO_BEAT = "no beat"


def _child(code: str, hb: str, exit_code: int | None = None) -> list[str]:
    """A fake child: touch the heartbeat strictly after the coordinator's
    baseline, then run ``code``; or, for ``NO_BEAT``, exit ``exit_code``
    at once."""
    if code == NO_BEAT:
        return [sys.executable, "-c", f"raise SystemExit({exit_code})"]
    return [sys.executable, "-c",
            "import os, time\n"
            f"hb = {hb!r}\n"
            "time.sleep(0.25); open(hb, 'a').close(); os.utime(hb, None)\n"
            "time.sleep(0.1)\n" + code]


def _signal_ready(run_dir: str, slot: int) -> str:
    """Child code: an agent's readiness signal for ``slot``, written into
    the membership file as ``membership.signal_ready`` writes it."""
    path = os.path.join(run_dir, "membership.json")
    return ("import json, os\n"
            f"p = {path!r}\n"
            "d = json.load(open(p))\n"
            f"d['ready'] = sorted(set(d['ready']) | {{{slot}}})\n"
            "open(p + '.tmp', 'w').write(json.dumps(d, indent=1))\n"
            "os.replace(p + '.tmp', p)\n"
            "raise SystemExit(75)\n")


# name -> (n_hosts, {(generation, slot): code or (NO_BEAT, exit code)},
#          coordinator keywords). A (generation, slot) not named exits 0
# after beating, or under "default" as that entry says.
SCENARIOS = {
    # Slot 1 crashes after beating; slot 0 hangs in its "collective" and
    # is killed with the generation; the survivor finishes alone.
    "shrink": (2, {(0, 0): HANG, (0, 1): "raise SystemExit(7)"}, {}),
    # ... and the survivor reaches a planned cut, where slot 1 rejoins.
    "readmit_at_boundary": (2, {(0, 0): HANG, (0, 1): "raise SystemExit(9)",
                                (1, 0): "raise SystemExit(75)"}, {}),
    # min_world_size 2: no shrink is admissible, so the world restarts at
    # full strength.
    "full_world_loss": (2, {(0, 0): HANG, (0, 1): "raise SystemExit(5)"},
                        {"min_world_size": 2}),
    # The re-admitted slot fails before it comes up while its peer is live:
    # it is shed again and the survivor finishes.
    "startup_shed": (2, {(0, 0): HANG, (0, 1): "raise SystemExit(9)",
                         (1, 0): "raise SystemExit(75)", (2, 0): HANG,
                         (2, 1): (NO_BEAT, 13)}, {}),
    # readmit="agent": the first boundary re-admits nobody; the slot comes
    # back at the boundary after its agent signalled.
    "agent": (2, {(0, 0): HANG, (0, 1): "raise SystemExit(9)",
                  (1, 0): "raise SystemExit(75)", (2, 0): "AGENT"},
              {"readmit": "agent"}),
    # A SIGTERM reaches each rank's loop alone: rank 0 drains and exits 75
    # while rank 1 hangs in its next collective. Nothing agrees on a stop
    # step; rank 1's heartbeat goes stale and it is charged as lost.
    "one_rank_sigterm": (2, {(0, 0): "raise SystemExit(75)", (0, 1): HANG},
                         {"stall_timeout_s": 1.5}),
    # One host that fails before beating: a startup failure, retried once.
    "startup_retry": (1, {(0, 0): (NO_BEAT, 3)}, {}),
    # ... twice: the give-up verdict with the child's code.
    "give_up": (1, {"default": (NO_BEAT, 3)}, {}),
    # No admissible world at all: the give-up verdict before any spawn.
    "infeasible": (2, {}, {"min_world_size": 2, "global_batch": 3,
                           "local_devices": 1}),
}


def _events(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _drive(pkg, run_dir: str, n_hosts: int, scenario: dict, kw: dict) -> dict:
    """Run ``pkg``'s coordinator (the reference's or the port's module)
    over ``scenario``'s children; returns what the comparison reads."""
    os.makedirs(run_dir, exist_ok=True)

    def spawn(members, rank, generation, port):
        slot = members[rank]
        code = scenario.get((generation, slot), scenario.get(
            "default", "raise SystemExit(0)"))
        if code == "AGENT":
            code = _signal_ready(run_dir, 1)
        if isinstance(code, tuple):
            return _child(code[0], "", code[1])
        return _child(code, pkg.heartbeat_path(run_dir, slot))

    kw = {"min_world_size": 1, "global_batch": 8, "local_devices": 2,
          "poll_s": 0.1, "grace_s": 30.0, "stall_timeout_s": 30.0,
          "backoff_base_s": 0.05, "log": lambda _: None, **kw}
    res = pkg.ElasticCoordinator(n_hosts, spawn, run_dir, **kw).run()
    events = _events(run_dir)
    try:
        with open(os.path.join(run_dir, "membership.json")) as fh:
            membership = json.load(fh)
    except FileNotFoundError:
        membership = None
    return {
        "result": dataclasses.asdict(res),
        "mesh_reform": [(e["generation"], e["from_n"], e["to_n"], e["reason"])
                        for e in events if e["ev"] == "mesh_reform"],
        "host_leave": [(e["host"], e["generation"], e["reason"])
                       for e in events if e["ev"] == "host_leave"],
        "host_join": [(e["host"], e["generation"])
                      for e in events if e["ev"] == "host_join"],
        "phases": [(e["phase"], e.get("host"), e.get("generation"))
                   for e in events if e["ev"] == "supervisor"],
        "membership": membership,
    }


@pytest.fixture(scope="module")
def driven(tmp_path_factory):
    """Every scenario by both coordinators, side by side; then
    ``spawn_fail@spawn=2`` by both (each package's fault plan is
    process-wide, so no other scenario runs beside it)."""
    root = tmp_path_factory.mktemp("elastic")
    out = {}
    with concurrent.futures.ThreadPoolExecutor(2 * len(SCENARIOS)) as pool:
        jobs = {(name, side): pool.submit(
                    _drive, pkg, str(root / side / name), n, sc, kw)
                for name, (n, sc, kw) in SCENARIOS.items()
                for side, pkg in (("ref", ref_coordinator),
                                  ("port", coordinator))}
        for key, job in jobs.items():
            out[key] = job.result()
    spec = "spawn_fail@spawn=2"
    scenario = {(0, 0): HANG}
    ref_faults.install(spec, state_dir=str(root / "ref" / "spawn_fail"),
                       only={"spawn_fail"})
    faults.install(spec, state_dir=str(root / "port" / "spawn_fail"),
                   only={"spawn_fail"})
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = {(("spawn_fail", side)): pool.submit(
                        _drive, pkg, str(root / side / "spawn_fail"), 2,
                        scenario, {})
                    for side, pkg in (("ref", ref_coordinator),
                                      ("port", coordinator))}
            for key, job in jobs.items():
                out[key] = job.result()
    finally:
        ref_faults.uninstall()
        faults.uninstall()
    return out


# What each scenario must give (the reference's verdicts, spelled out):
# ElasticResult fields, then the mesh_reform reasons.
EXPECTED = {
    "shrink": ((0, 2, 1, 1, 0, 0), ["start", "host_loss"]),
    "readmit_at_boundary": ((0, 3, 2, 1, 1, 1),
                            ["start", "host_loss", "host_rejoin"]),
    "full_world_loss": ((0, 2, 0, 1, 1, 0), ["start"]),
    "startup_shed": ((0, 4, 3, 2, 1, 1),
                     ["start", "host_loss", "host_rejoin", "host_loss"]),
    "agent": ((0, 4, 2, 1, 1, 2), ["start", "host_loss", "host_rejoin"]),
    "one_rank_sigterm": ((0, 2, 1, 1, 0, 0), ["start", "host_loss"]),
    "startup_retry": ((0, 2, 0, 0, 0, 0), ["start"]),
    "give_up": ((3, 2, 0, 0, 0, 0), ["start"]),
    "infeasible": ((1, 1, 0, 0, 0, 0), []),
    "spawn_fail": ((0, 2, 1, 1, 0, 0), ["start", "host_loss"]),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_coordinator_scenario_matches_the_reference(driven, name):
    ref, port = driven[(name, "ref")], driven[(name, "port")]
    assert port == ref
    result, reasons = EXPECTED[name]
    assert tuple(port["result"].values()) == result
    assert [r[3] for r in port["mesh_reform"]] == reasons


def test_the_scenarios_verdicts_in_detail(driven):
    shrink = driven[("shrink", "port")]
    assert shrink["host_leave"] == [(1, 0, "exit_7")]
    assert shrink["membership"]["members"] == [0]
    assert shrink["membership"]["reason"] == "host_loss"
    grown = driven[("readmit_at_boundary", "port")]
    assert grown["host_join"] == [(1, 2)]
    assert grown["membership"]["members"] == [0, 1]
    full = driven[("full_world_loss", "port")]
    assert full["host_join"] == [(1, 1)]
    assert full["membership"]["reason"] == "restart"
    shed = driven[("startup_shed", "port")]
    assert shed["host_leave"] == [(1, 0, "exit_9"), (1, 2, "exit_13")]
    assert shed["membership"]["members"] == [0]
    agent = driven[("agent", "port")]
    assert agent["host_join"] == [(1, 3)]
    assert agent["membership"] == {"generation": 3, "world_size": 2,
                                   "members": [0, 1], "min_world_size": 1,
                                   "reason": "host_rejoin", "ready": []}
    sigterm = driven[("one_rank_sigterm", "port")]
    assert sigterm["host_leave"] == [(1, 0, "stall")]
    assert ("stall", 1, 0) in sigterm["phases"]
    assert [p for p, _, _ in driven[("give_up", "port")]["phases"]].count(
        "giving_up") == 1
    assert driven[("infeasible", "port")]["membership"] is None
    assert driven[("spawn_fail", "port")]["host_leave"] == [(1, 0, "exit_13")]


# --- 3. the CLI --------------------------------------------------------------

def _refusal(main, argv) -> str:
    with pytest.raises((SystemExit, ValueError)) as e:
        main(argv)
    return str(e.value)


REFUSALS = [
    (["--elastic", "--world-size", "2"], "checkpoint-dir"),
    (["--elastic", "--world-size", "2", "--checkpoint-dir", "{ck}"], "run-dir"),
    (["--elastic", "--supervise", "--checkpoint-dir", "{ck}", "--run-dir",
      "{run}"], "drop --supervise"),
    (["--elastic", "--world-size", "3", "--local-devices", "1",
      "--global-batch", "8", "--checkpoint-dir", "{ck}", "--run-dir", "{run}"],
     "not divisible"),
    (["--elastic", "--world-size", "2", "--local-devices", "3",
      "--global-batch", "8", "--checkpoint-dir", "{ck}", "--run-dir", "{run}"],
     "not divisible"),
    # --restart-every is legal under --elastic: the refusal is the run-dir's.
    (["--elastic", "--restart-every", "2", "--checkpoint-dir", "{ck}"],
     "run-dir"),
    (["--restart-every", "2", "--checkpoint-dir", "{ck}"],
     "requires --supervise"),
    (["--min-world-size", "2", "--total-steps", "1"], "elastic is off"),
    (["--elastic", "--min-world-size", "0", "--checkpoint-dir", "{ck}",
      "--run-dir", "{run}"], "min_world_size must be >= 1"),
]


@pytest.mark.parametrize("args,words", REFUSALS)
def test_cli_refusals_match_the_reference(tmp_path, args, words):
    from featurenet_tpu import cli as ref_cli
    from featurenet_tpu_torch import cli

    argv = ["train", "--config", "smoke16"] + [
        a.format(ck=str(tmp_path / "ck"), run=str(tmp_path / "run"))
        for a in args]
    want = _refusal(ref_cli.main, argv)
    got = _refusal(cli.main, argv + ["--device", "cpu"])
    assert words in want
    assert words in got
    assert not os.path.exists(tmp_path / "run" / "events.jsonl")


def test_cli_refuses_elastic_with_distributed(tmp_path):
    from featurenet_tpu_torch import cli

    with pytest.raises(SystemExit, match="drop --distributed"):
        cli.main(["--distributed", "train", "--config", "smoke16", "--elastic",
                  "--checkpoint-dir", str(tmp_path / "ck"), "--run-dir",
                  str(tmp_path / "run")])


RAW = ["--distributed-timeout", "60", "train", "--elastic", "--world-size", "2",
       "--config", "pod64", "--checkpoint-dir", "CK", "--run-dir", "R",
       "--stall-timeout", "30", "--max-restarts=3", "--restart-every", "3",
       "--inject-faults", "host_loss@step=1", "--heartbeat-file=old",
       "--readmit", "agent"]


def test_elastic_child_argv_matches_the_reference():
    from featurenet_tpu.train.supervisor import child_argv_from_cli as ref_child
    from featurenet_tpu_torch.cli import elastic_child_argv

    got = elastic_child_argv(RAW, "R", [0, 2], 1, 3, 4567)
    hb = ref_coordinator.heartbeat_path("R", 2)
    want = ref_child(RAW, hb) + ["--elastic-rank", "1", "--elastic-world", "2",
                                 "--elastic-port", "4567",
                                 "--elastic-generation", "3"]
    assert got[:3] == [sys.executable, "-m", "featurenet_tpu_torch.cli"]
    assert want[:3] == [sys.executable, "-m", "featurenet_tpu.cli"]
    assert got[3:] == want[3:]
    assert "--stall-timeout" not in got and "--heartbeat-file=old" not in got


def test_cli_refuses_more_than_one_local_device(tmp_path):
    from featurenet_tpu_torch import cli

    with pytest.raises(SystemExit, match="one process on one device"):
        cli.main(["train", "--config", "smoke16", "--device", "cpu",
                  "--elastic", "--world-size", "2", "--local-devices", "2",
                  "--global-batch", "8", "--checkpoint-dir",
                  str(tmp_path / "ck"), "--run-dir", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run" / "events.jsonl")


@pytest.mark.parametrize("saved", [None, "smoke16"])
def test_elastic_children_run_the_coordinators_config(monkeypatch, tmp_path,
                                                      saved):
    """Without --config the coordinator plans with pod64, as the reference's
    does, and every child runs what it planned with; a checkpoint's own
    config wins over both."""
    from featurenet_tpu.config import get_config as ref_get
    from featurenet_tpu_torch import cli, elastic
    from featurenet_tpu_torch.config import config_to_dict, get_config

    ck, run = tmp_path / "ck", tmp_path / "run"
    if saved:
        ck.mkdir()
        (ck / "config.json").write_text(json.dumps(config_to_dict(
            get_config(saved))))
    planned = {}

    class Recorder:
        def __init__(self, world_size, spawn, run_dir, **kw):
            planned.update(kw, spawn=spawn)

        def run(self):
            return elastic.ElasticResult(0, 1, 0, 0, 0, 0)

    monkeypatch.setattr(elastic, "ElasticCoordinator", Recorder)
    assert cli.main(["train", "--elastic", "--world-size", "2",
                     "--checkpoint-dir", str(ck), "--run-dir", str(run)]) == 0
    want = saved or "pod64"
    assert planned["global_batch"] == get_config(want).global_batch
    assert ref_get(want).global_batch == get_config(want).global_batch
    for rank in (0, 1):
        child = cli._parser().parse_args(
            planned["spawn"]([0, 1], rank, 0, 4567)[3:])
        cfg = cli._train_config(child, cli.DEFAULT_PRESET)
        assert (cfg.name, cfg.global_batch) == (want, planned["global_batch"])
        assert cfg.elastic


def test_elastic_child_argv_parses_as_a_child():
    from featurenet_tpu_torch import cli

    args = cli._parser().parse_args(
        cli.elastic_child_argv(RAW, "R", [0, 1], 0, 2, 4567)[3:])
    assert args.supervised_child and args.elastic
    assert (args.elastic_rank, args.elastic_world, args.elastic_port,
            args.elastic_generation) == (0, 2, 4567, 2)
    assert args.heartbeat_file == os.path.abspath(os.path.join("R",
                                                               "heartbeat.0"))
    assert args.distributed_timeout == 60.0 and args.restart_every_steps == 3


@pytest.mark.parametrize("members", [[0], [0, 1]])
def test_an_elastic_child_without_a_card_fails(monkeypatch, tmp_path, members):
    import torch

    from featurenet_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = ["train", "--elastic", "--config", "smoke16", "--checkpoint-dir",
           str(tmp_path / "ck"), "--run-dir", str(tmp_path / "run")]
    argv = cli.elastic_child_argv(raw, str(tmp_path / "run"), members, 0, 0,
                                  coordinator._free_port())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv[3:])


# --- 4. the Config -----------------------------------------------------------

def test_config_elastic_fields_match_the_reference():
    from featurenet_tpu.config import Config as RefConfig
    from featurenet_tpu.config import get_config as ref_get
    from featurenet_tpu_torch.config import Config, get_config

    ref_fields = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(Config)}
    for name in ("elastic", "min_world_size"):
        assert fields[name] == ref_fields[name]
    for kw in ({"min_world_size": 0}, {"min_world_size": 2},
               {"min_world_size": -1, "elastic": True}):
        with pytest.raises(ValueError) as ref_err:
            ref_get("smoke16", **kw)
        with pytest.raises(ValueError) as err:
            get_config("smoke16", **kw)
        assert str(err.value).split(" ")[:3] == str(ref_err.value).split(" ")[:3]
    cfg = get_config("smoke16", elastic=True, min_world_size=2)
    assert (cfg.elastic, cfg.min_world_size) == (True, 2)


def test_a_jax_config_json_keeps_its_elastic_fields():
    from featurenet_tpu.config import config_to_dict as ref_to_dict
    from featurenet_tpu.config import get_config as ref_get
    from featurenet_tpu_torch.config import config_from_dict

    doc = json.loads(json.dumps(ref_to_dict(
        ref_get("pod64", elastic=True, min_world_size=2))))
    assert (doc["elastic"], doc["min_world_size"]) == (True, 2)
    cfg = config_from_dict(doc)
    assert (cfg.elastic, cfg.min_world_size) == (True, 2)
    with pytest.raises(ValueError, match="elastic is off"):
        config_from_dict({**doc, "elastic": False})


def test_a_plain_resume_does_not_inherit_the_elastic_floor():
    from featurenet_tpu_torch import cli
    from featurenet_tpu_torch.config import get_config

    saved = get_config("smoke16", elastic=True, min_world_size=2)
    args = cli._parser().parse_args(["train", "--device", "cpu"])
    cfg = cli._cfg_from_checkpoint(saved, args)
    assert (cfg.elastic, cfg.min_world_size) == (False, 1)
    args = cli._parser().parse_args(["train", "--elastic"])
    cfg = cli._cfg_from_checkpoint(saved, args, elastic=True)
    assert cfg.elastic and cfg.min_world_size == 1


# --- 5. one real elastic run on the CPU --------------------------------------

def test_cli_elastic_shrinks_on_host_loss_and_grows_back(tmp_path):
    ck, run = tmp_path / "ck", tmp_path / "run"
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "featurenet_tpu_torch.cli", "train", "--elastic",
         "--world-size", "2", "--config", "smoke16", "--device", "cpu",
         "--global-batch", "8", "--total-steps", "5", "--checkpoint-every", "1",
         "--keep-checkpoints", "8", "--restart-every", "3", "--data-workers",
         "1", "--eval-batches", "1", "--inject-faults", "host_loss@step=1",
         "--checkpoint-dir", str(ck), "--run-dir", str(run)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    # The children share the coordinator's stdout and write unbuffered, so
    # two processes' lines may interleave.
    from chip_smoke import _json_objects

    lines = _json_objects(out.stdout)
    assert lines[-1] == {"elastic": {"exit_code": 0, "generations": 3,
                                     "reforms": 2, "losses": 1, "rejoins": 1,
                                     "planned": 1}}
    worlds = [r["distributed"]["world"] for r in lines if "distributed" in r]
    assert worlds == [2, 2, 2, 2]  # generations 0 and 2; 1 opened no group

    from featurenet_tpu_torch.obs.report import build_report, load_events

    events, bad = load_events(str(run))
    assert bad == 0
    rep = build_report(events)
    assert rep["recovery"]["mesh_reforms"] == 3
    assert rep["recovery"]["host_leaves"] == 1
    assert rep["recovery"]["host_joins"] == 1
    assert [e["reason"] for e in events if e["ev"] == "mesh_reform"] == [
        "start", "host_loss", "host_rejoin"]
    starts = [e for e in events if e["ev"] == "loop_start"]
    assert {e["global_batch"] for e in starts} == {8}
    assert [(e["step"], e["mesh"]["processes"]) for e in starts
            if e.get("process_index", 0) == 0][-2:] == [(1, 1), (4, 2)]
    assert any(e["ev"] == "run_end" and e["step"] == 5 for e in events)
    train = [r for r in lines if r.get("kind") == "train"]
    assert len(train) == 2 and train[0]["loss"] == train[1]["loss"]
    with open(run / "membership.json") as fh:
        m = json.load(fh)
    assert (m["generation"], m["members"], m["reason"]) == (
        2, [0, 1], "host_rejoin")
    assert sorted(os.listdir(ck)) == sorted(
        [f"step_{s}.pt" for s in range(1, 6)]
        + [f"checksum.{s}.json" for s in range(1, 6)] + ["config.json"])
