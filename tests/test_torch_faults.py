"""The port's fault-injection registry against the JAX package's, on the
CPU: ``parse_spec`` on a table of valid and invalid specs gives the same
dict or the same ``ValueError``; ``FaultPlan.check`` fires at the same
calls for the same counter sequences (thresholds crossed by strides,
``:every=`` ladders, counters running backwards, and two plans sharing a
marker directory, as a respawned child does); the port refuses the sites
it does not wire yet, and its config keeps the supervision fields of a JAX
``config.json`` while a resume strips the ephemeral ones. Exact equality
throughout: the registry is integer bookkeeping."""

import argparse
import dataclasses
import json
import os
import tempfile

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from featurenet_tpu import faults as jax_faults
from featurenet_tpu.config import config_to_dict as jax_config_to_dict
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu_torch import cli, faults
from featurenet_tpu_torch.config import config_from_dict, get_config


@pytest.fixture(autouse=True)
def _no_port_plan():
    faults.uninstall()
    yield
    faults.uninstall()


SPECS = [
    # valid
    "checkpoint_corrupt@save=2,producer_hang@batch=40,sigterm@step=120",
    "producer_crash",
    " sigterm@step=3 , ",
    "sigterm@step=100:every=50,save_slow",
    "host_loss@step=-1",
    "swap_corrupt@swap=1,replica_loss_rollout@swap=2,replica_slow@request=0",
    "sink_enospc@emit=10,replica_loss@request=3",
    "cache_read_error@read=2,checkpoint_restore_error@restore=1,spawn_fail",
    "producer_slow@batch=8:every=4",
    # invalid
    "tyop_site@x=1",
    "sigterm@save=1",
    "sigterm@step=soon",
    "sigterm@step=1,sigterm@step=2",
    " , ",
    "",
    "sigterm@=3",
    "sigterm@step",
    "sigterm@step=100:evry=50",
    "sigterm@step=100:every=soon",
    "sigterm@step=100:every=0",
    "sigterm@step=100:every",
    "sigterm@step=1.5",
]


def _outcome(parse, spec):
    try:
        return ("ok", parse(spec))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    assert _outcome(faults.parse_spec, spec) == _outcome(jax_faults.parse_spec, spec)
    assert faults.SITES == jax_faults.SITES
    assert faults.SLOW_SLEEP_S == jax_faults.SLOW_SLEEP_S


def test_port_refuses_the_sites_it_does_not_wire():
    assert set(faults.SITES) - faults.WIRED == {"replica_loss"}
    for spec in ("replica_loss@request=1", "sigterm@step=2,replica_loss@request=1"):
        faults.parse_spec(spec)  # parses as in the reference
        with pytest.raises(ValueError, match="not wired"):
            faults.check_wired(spec)
        with pytest.raises(ValueError, match="not wired"):
            get_config("smoke16", inject_faults=spec)
    with pytest.raises(ValueError, match="unknown fault site"):
        get_config("smoke16", inject_faults="tyop@x=1")
    spec = ",".join(f"{s}@{c}=1" for s, c in sorted(faults.SITES.items())
                    if s in faults.WIRED)
    assert get_config("smoke16", inject_faults=spec).inject_faults == spec


# A check is (site, counter value or None for no counter).
_CHECK = st.tuples(st.sampled_from(["sigterm", "producer_crash", "save_slow"]),
                   st.one_of(st.none(), st.integers(-2, 40)))
_TRIGGER = st.one_of(
    st.just(""), st.builds(lambda n: f"={n}", st.integers(-2, 30)),
    st.builds(lambda n, m: f"={n}:every={m}", st.integers(-2, 30),
              st.integers(1, 7)))


def _spec(triggers):
    out = []
    for site, trig in zip(("sigterm", "producer_crash", "save_slow"), triggers):
        if trig == "":
            out.append(site)
        else:
            out.append(f"{site}@{faults.SITES[site]}{trig}")
    return ",".join(out)


def _fired(mod, spec, checks, state_dir=None, restart_at=None):
    """The checks' results through ``mod``'s plan; at ``restart_at`` a fresh
    plan over the same state dir takes over, as a respawned child's."""
    plan = mod.FaultPlan(spec, state_dir)
    out = []
    for i, (site, value) in enumerate(checks):
        if i == restart_at:
            plan = mod.FaultPlan(spec, state_dir)
        counter = {} if value is None else {mod.SITES[site]: value}
        out.append(plan.check(site, counter))
    return out


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(triggers=st.tuples(_TRIGGER, _TRIGGER, _TRIGGER),
       checks=st.lists(_CHECK, max_size=25),
       restart_at=st.one_of(st.none(), st.integers(0, 25)))
def test_fault_plan_fires_like_jax(triggers, checks, restart_at):
    spec = _spec(triggers)
    assert (_fired(faults, spec, checks)
            == _fired(jax_faults, spec, checks))
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        port = _fired(faults, spec, checks, a, restart_at)
        ref = _fired(jax_faults, spec, checks, b, restart_at)
        assert port == ref
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def test_strides_ladders_and_shared_markers(tmp_path):
    """The cases the reference's own tests name, through both packages:
    a threshold crossed by a stride, a ladder collapsing several rungs into
    one firing and never firing below its floor, and a second plan over
    the same marker directory skipping what the first fired."""
    cases = [
        ("sigterm@step=120", [112, 124, 124, 200]),
        ("sigterm@step=2:every=3", list(range(1, 10))),
        ("sigterm@step=2:every=3", [20, 20, 5, 23, 26, 24]),
    ]
    for spec, steps in cases:
        checks = [("sigterm", s) for s in steps]
        assert _fired(faults, spec, checks) == _fired(jax_faults, spec, checks)
    assert _fired(faults, cases[1][0], [("sigterm", s) for s in range(1, 10)]) == [
        s in (2, 5, 8) for s in range(1, 10)]
    for pkg, mod in (("port", faults), ("jax", jax_faults)):
        d = str(tmp_path / pkg)
        a = mod.FaultPlan("sigterm@step=2:every=3,producer_crash@batch=1", d)
        assert a.check("sigterm", {"step": 2}) and a.check("producer_crash", {"batch": 1})
        b = mod.FaultPlan("sigterm@step=2:every=3,producer_crash@batch=1", d)
        assert not b.check("sigterm", {"step": 2})
        assert not b.check("producer_crash", {"batch": 5})
        assert b.check("sigterm", {"step": 5})
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_install_only_and_the_off_path():
    assert not faults.active() and not faults.maybe_fail("sigterm", step=1)
    faults.install("producer_crash@batch=1,spawn_fail@spawn=1", only={"spawn_fail"})
    assert not faults.maybe_fail("producer_crash", batch=1)
    assert faults.maybe_fail("spawn_fail", spawn=1)
    faults.install(None)
    assert not faults.active()


def test_config_keeps_the_supervision_fields_and_resume_strips_them(tmp_path):
    """A JAX ``config.json`` with every supervision field set loads with
    them kept; the reference's defaults and refusals hold; a resume or a
    reader of a checkpoint (``_cfg_from_checkpoint``) drops the heartbeat
    path, the segment length and the fault spec unless given again."""
    over = dict(restart_every_steps=7, max_inflight_steps=3,
                inject_faults="sigterm@step=5", heartbeat_file="/x/hb",
                checkpoint_dir=str(tmp_path / "ck"))
    d = json.loads(json.dumps(jax_config_to_dict(jax_get_config("smoke16", **over)),
                              default=str))
    got = config_from_dict(d)
    for k, v in over.items():
        assert getattr(got, k) == v, k
    port, ref = get_config("smoke16"), jax_get_config("smoke16")
    for k in ("restart_every_steps", "max_inflight_steps", "inject_faults",
              "heartbeat_file"):
        assert getattr(port, k) == getattr(ref, k), k
    for bad in (dict(restart_every_steps=-5, checkpoint_dir="x"),
                dict(restart_every_steps=10)):
        with pytest.raises(ValueError, match="restart_every_steps"):
            get_config("smoke16", **bad)
        with pytest.raises(ValueError, match="restart_every_steps"):
            jax_get_config("smoke16", **bad)
    args = argparse.Namespace(config=None, conv_backend=None)
    stripped = cli._cfg_from_checkpoint(got, args)
    assert (stripped.restart_every_steps, stripped.inject_faults,
            stripped.heartbeat_file) == (None, None, None)
    assert stripped == dataclasses.replace(got, restart_every_steps=None,
                                           inject_faults=None, heartbeat_file=None)
    again = cli._cfg_from_checkpoint(got, args, heartbeat_file="/y/hb",
                                     restart_every_steps=2)
    assert (again.heartbeat_file, again.restart_every_steps) == ("/y/hb", 2)


def test_supervision_modules_import_only_the_stdlib():
    """``faults.py`` and ``train/heartbeat.py`` import the standard library
    alone, ``train/supervisor.py`` those two and the obs modules of its
    ``run_dir`` half besides, and those obs modules (with the store, the
    dash and the incident plane the report reads) the standard library,
    ``faults`` and each other (``obs/events.py`` imports torch only inside
    the manifest's topology probe, which the supervisor's sink never
    calls): the supervisor process never needs torch for its own work."""
    import ast
    import pathlib
    import sys

    port = pathlib.Path(faults.__file__).parent
    obs_mods = {"featurenet_tpu_torch.obs", "featurenet_tpu_torch.obs.events",
                "featurenet_tpu_torch.obs.gates",
                "featurenet_tpu_torch.obs.report",
                "featurenet_tpu_torch.obs.alerts",
                "featurenet_tpu_torch.obs.windows",
                "featurenet_tpu_torch.obs.tracing",
                "featurenet_tpu_torch.obs.spans"}
    # What the report reads at call time: the store, the dash, the
    # incident plane.
    store_mods = {"featurenet_tpu_torch.obs.tsdb",
                  "featurenet_tpu_torch.obs.dash",
                  "featurenet_tpu_torch.obs.incidents",
                  "featurenet_tpu_torch.obs.stacksampler"}
    obs_ok = obs_mods | store_mods | {"featurenet_tpu_torch.faults"}
    allowed = {"faults.py": set(), "train/heartbeat.py": set(),
               "train/supervisor.py": {"featurenet_tpu_torch.faults",
                                       "featurenet_tpu_torch.train.heartbeat"}
               | obs_mods,
               "obs/__init__.py": obs_ok, "obs/events.py": obs_ok | {"torch"},
               "obs/gates.py": obs_ok, "obs/report.py": obs_ok,
               "obs/alerts.py": obs_ok, "obs/windows.py": obs_ok,
               "obs/tracing.py": obs_ok, "obs/spans.py": obs_ok,
               "obs/tsdb.py": obs_ok, "obs/dash.py": obs_ok,
               "obs/incidents.py": obs_ok, "obs/stacksampler.py": obs_ok}
    for name, extra in allowed.items():
        tree = ast.parse((port / name).read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                mods.add(node.module if node.module != "featurenet_tpu_torch"
                         else f"featurenet_tpu_torch.{node.names[0].name}")
        bad = {m for m in mods if m.split(".")[0] not in sys.stdlib_module_names
               and m not in extra}
        assert not bad, (name, bad)
