"""Deterministic fault injection for the recovery paths (port of
``featurenet_tpu/faults.py``; stdlib only).

A run configured with ``Config.inject_faults`` / ``--inject-faults`` fails
in a precisely scripted way, so the recovery paths (the supervisor's
restart, the checkpoint walk-back, the preemption exit, the producer's
structured error, the swap refusal) are tested by real injected failures
inside real runs.

Spec DSL (comma-separated, one entry per site)::

    checkpoint_corrupt@save=2,producer_hang@batch=40,sigterm@step=120

Each entry is ``site[@counter=N[:every=M]]``: the fault fires the first
time the site calls ``maybe_fail(site, counter=value)`` with ``value >= N``
(counters are site-defined ordinals -- the step number, the Nth save, the
Nth gather; see ``SITES`` -- and may stride past N: a k-step dispatch
advances the step by k, worker w's tickets go w, w+W, ...). A bare
``site`` fires on the site's first check. Without ``:every=`` every fault
fires **once**: in memory for the process, and -- when ``install`` is
given a ``state_dir`` -- once per *run*, via a ``fault_<site>.fired``
marker file that respawned children (a supervisor re-executes the same
argv, so the same spec) see and skip. Attempt 1 dies, attempt 2 finds the
marker and runs clean.

``:every=M`` makes the trigger repeatable: thresholds form the ladder N,
N+M, N+2M, ... and the site fires once per rung, at the first check whose
counter reaches it (several rungs crossed in one stride collapse into one
firing at the highest rung crossed). The marker becomes per firing,
``fault_<site>.fired.<T>`` for rung ``T``, so a respawned child skips the
rungs already fired this run but still fires the later ones.

Off costs nothing: ``maybe_fail`` with no plan installed is one module
attribute load and a ``None`` check.

``SITES`` names every site of the reference with its counter, so any spec
the JAX package parses parses the same here. ``WIRED`` is the set of sites
the port has wired, every site of ``SITES``; ``Config.validate`` refuses a
spec naming a site outside it (``check_wired``), since a fault that can
never fire would let a chaos run pass by testing nothing.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Optional


class InjectedFault(RuntimeError):
    """Stand-in for a real failure, raised by an injection site."""


# Every site of the reference, with the counter its caller passes. A spec
# naming an unknown site is an error at parse time.
SITES = {
    "checkpoint_corrupt": "save",        # Nth CheckpointManager.save
    "checkpoint_restore_error": "restore",  # Nth restore attempt
    "sigterm": "step",                   # train-loop step number
    "producer_crash": "batch",           # prefetch ticket ordinal
    "producer_hang": "batch",            # prefetch ticket ordinal
    "producer_slow": "batch",            # prefetch ticket ordinal (latency)
    "cache_read_error": "read",          # Nth cache _gather call
    "sink_enospc": "emit",               # Nth EventSink.emit
    "spawn_fail": "spawn",               # Nth supervisor child spawn
    # Nth CheckpointManager.save (latency; sleeps in the writer thread,
    # never on the step's thread).
    "save_slow": "save",
    # The last host of the process group SIGKILLs itself at the first step
    # boundary >= N: no drain, no exit protocol. With one process, this
    # process is the last host.
    "host_loss": "step",                 # train-loop step number
    # Serving sites. replica_loss fires in a fleet router at its Nth
    # routed request; replica_slow in a replica's forward at its Nth
    # dispatched batch, dragging it by SLOW_SLEEP_S.
    "replica_loss": "request",           # Nth routed fleet request
    "replica_slow": "request",           # Nth replica forward dispatch
    # Both count the replica's Nth reload attempt. swap_corrupt hands the
    # swap a checksum-mismatched candidate, refused before any reference
    # flips; replica_loss_rollout SIGKILLs the replica mid-reload.
    "swap_corrupt": "swap",              # Nth replica reload attempt
    "replica_loss_rollout": "swap",      # Nth replica reload attempt
}

# The sites the port wires: all of them (replica_loss in the fleet router,
# fleet/router.py; spawn_fail in the supervisor and the replica manager).
WIRED = frozenset(SITES)

# How long the latency sites (producer_slow, save_slow, replica_slow)
# sleep per firing.
SLOW_SLEEP_S = 0.25


def parse_spec(spec: str) -> dict[str, Optional[tuple]]:
    """``"a@k=1,b,c@k=5:every=2"`` →
    ``{"a": ("k", 1), "b": None, "c": ("k", 5, 2)}``: a 2-tuple is a
    one-shot threshold, a 3-tuple adds the re-fire stride. Validates
    sites, counter names and stride syntax, so a typo fails the run at
    config time, not silently."""
    out: dict[str, Optional[tuple]] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        site, sep, trigger = entry.partition("@")
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} in inject spec {spec!r}; "
                f"known sites: {', '.join(sorted(SITES))}"
            )
        if site in out:
            raise ValueError(f"duplicate fault site {site!r} in {spec!r}")
        if not sep:
            out[site] = None
            continue
        trigger, colon, stride = trigger.partition(":")
        name, eq, value = trigger.partition("=")
        if not eq or not name:
            raise ValueError(
                f"malformed trigger {entry!r}: expected "
                "site@counter=N[:every=M]"
            )
        if name != SITES[site]:
            raise ValueError(
                f"site {site!r} counts {SITES[site]!r}, not {name!r} "
                f"(in {entry!r})"
            )
        try:
            n = int(value)
        except ValueError:
            raise ValueError(
                f"trigger value in {entry!r} must be an integer"
            ) from None
        if not colon:
            out[site] = (name, n)
            continue
        skey, seq, svalue = stride.partition("=")
        if skey != "every" or not seq:
            raise ValueError(
                f"malformed stride {entry!r}: expected "
                "site@counter=N:every=M"
            )
        try:
            every = int(svalue)
        except ValueError:
            raise ValueError(
                f"every value in {entry!r} must be an integer"
            ) from None
        if every <= 0:
            raise ValueError(
                f"every in {entry!r} must be positive (a zero/negative "
                "stride would re-fire on every check)"
            )
        out[site] = (name, n, every)
    if not out:
        raise ValueError(f"empty fault spec {spec!r}")
    return out


def check_wired(spec: str) -> dict[str, Optional[tuple]]:
    """``parse_spec``, then refuse a site the port does not wire yet."""
    sites = parse_spec(spec)
    unwired = sorted(set(sites) - WIRED)
    if unwired:
        raise ValueError(
            f"fault site(s) {', '.join(unwired)} in {spec!r} are not wired "
            "in the port; the fault could never fire"
        )
    return sites


class FaultPlan:
    """One parsed spec and its fired state (in memory and on-disk markers).

    ``only``: restrict the plan to these sites (the supervisor installs
    the shared spec with ``only={"spawn_fail"}``: the child-side sites
    must fire in the training process, not in the supervisor)."""

    def __init__(self, spec: str, state_dir: Optional[str] = None,
                 only: Optional[set] = None):
        self.spec = spec
        self.sites = parse_spec(spec)
        if only is not None:
            self.sites = {k: v for k, v in self.sites.items() if k in only}
        self.state_dir = os.path.abspath(state_dir) if state_dir else None
        self._fired: set[str] = set()
        # Repeatable sites: the highest rung fired so far, so a counter
        # that runs backwards (a restarted worker's tickets) never re-fires
        # a rung below one already taken.
        self._floor: dict[str, int] = {}
        self._lock = threading.Lock()

    def _marker(self, site: str, rung: Optional[int] = None) -> Optional[str]:
        """``fault_<site>.fired`` for a one-shot site,
        ``fault_<site>.fired.<rung>`` per rung of a repeatable one."""
        if self.state_dir is None:
            return None
        name = (f"fault_{site}.fired" if rung is None
                else f"fault_{site}.fired.{rung}")
        return os.path.join(self.state_dir, name)

    def check(self, site: str, counter: dict) -> bool:
        entry = self.sites.get(site, False)
        if entry is False:
            return False
        rung: Optional[int] = None  # None: one-shot (bare or N-threshold)
        if entry is not None:
            name, value = entry[0], entry[1]
            every = entry[2] if len(entry) > 2 else None
            got = counter.get(name)
            # A threshold crossing, not equality: counters may stride past
            # N, and a trigger that can silently never fire would make a
            # chaos test pass by testing nothing.
            if got is None or got < value:
                return False
            if every is not None:
                # The highest rung of N, N+M, ... this counter has crossed.
                rung = value + ((got - value) // every) * every
        key = site if rung is None else f"{site}@{rung}"
        if key in self._fired:
            return False
        with self._lock:
            if key in self._fired:
                return False
            if rung is not None and self._floor.get(site, rung - 1) >= rung:
                return False
            marker = self._marker(site, rung)
            if marker is not None and os.path.exists(marker):
                # Fired by an earlier process of this run.
                self._fired.add(key)
                if rung is not None:
                    self._floor[site] = rung
                return False
            self._fired.add(key)
            if rung is not None:
                self._floor[site] = rung
            if marker is not None:
                os.makedirs(self.state_dir, exist_ok=True)
                with open(marker, "w") as fh:
                    fh.write(json.dumps({"site": site, "pid": os.getpid(),
                                         "rung": rung, "counter": counter}))
        record = {"fault_injected": site, "pid": os.getpid(), **counter}
        if rung is not None:
            record["rung"] = rung
        print(json.dumps(record), file=sys.stderr, flush=True)
        return True


_plan: Optional[FaultPlan] = None


def install(spec: Optional[str], state_dir: Optional[str] = None,
            only: Optional[set] = None) -> None:
    """Install the process-wide fault plan, replacing any previous one.
    ``state_dir``: the directory of the cross-process markers (a run's
    checkpoint directory, so a supervised run's respawned children do not
    re-fire). ``only``: keep just these sites of the spec. A falsy
    ``spec`` uninstalls."""
    global _plan
    _plan = FaultPlan(spec, state_dir, only=only) if spec else None


def uninstall() -> None:
    global _plan
    _plan = None


def active() -> bool:
    return _plan is not None


def maybe_fail(site: str, **counter) -> bool:
    """True when the installed plan says this site should fail now."""
    plan = _plan
    if plan is None:
        return False
    return plan.check(site, counter)
