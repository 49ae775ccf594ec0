"""The elastic coordinator: an N-child supervisor that re-forms the world
(port of ``featurenet_tpu/elastic/coordinator.py``; stdlib only).

``train.supervisor.supervise`` watches ONE child and respawns the same
world; this coordinator owns a *generation* of N training processes (one
per host slot) and makes the world's size itself a recovery lever:

- **Host loss** (a child dies without the planned exit code, or its
  heartbeat goes stale): the whole generation is killed, since a lockstep
  world with a dead member is wedged in its next collective and nothing
  softer than SIGKILL is sure to land. The lost slot is removed and the
  survivors are respawned as generation G+1 at the smaller world, each
  process in a fresh ``torch.distributed`` group on a fresh port. Each
  child resumes from the newest good checkpoint (the state is replicated
  under pure data parallelism, so the restore needs no reshard; the feed
  is re-cut at the new world) with the per-host batch rescaled: the
  planner keeps the global batch.
- **Host recovery**: a lost slot is re-admitted at the next generation
  boundary, an all-exit-75 planned cut (``restart_every_steps``, a drained
  SIGTERM), so growth never interrupts a healthy generation. A re-admitted
  host that fails to come up is shed again as a loss; it does not take
  the run down.
- **Full-world loss** (the survivors fall below ``min_world_size``): every
  lost slot is re-admitted at once and the world restarts at full
  strength on the reform budget, the plain supervisor's respawn.

One loss verdict per reform: when several children die close together,
only the FIRST observed death is charged as a host loss. The rest are the
cascade of a world losing a member (peers error out of their collectives
within the same poll window) and of the coordinator's own kill; shedding
them too would shrink a healthy fleet to nothing on one bad host.

Every decision lands in host 0's event stream (the supervisor's
convention): ``supervisor`` events for spawn, stall, backoff,
planned_restart, done and giving_up, and the elastic kinds
``mesh_reform{generation, from_n, to_n, reason}`` on every change of size
and ``host_leave``/``host_join`` per slot. ``cli report`` folds them into
its recovery section; ``membership.json`` in the run directory is the
snapshot an external host agent reads.

Stdlib only: the coordinator process never opens the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import socket
import subprocess
import sys
import time
from typing import Callable, Optional, Sequence

from featurenet_tpu_torch import faults
from featurenet_tpu_torch.elastic.membership import (
    Membership,
    read_membership,
    ready_slots,
    write_membership,
)
from featurenet_tpu_torch.elastic.planner import InfeasibleWorld, plan_world
from featurenet_tpu_torch.train.heartbeat import HeartbeatMonitor
from featurenet_tpu_torch.train.supervisor import RESTART_EXIT_CODE, _kill_tree


def heartbeat_path(run_dir: str, slot: int) -> str:
    """The heartbeat file of one slot: a convention the supervising process
    and the argv it spawns the child with share."""
    return os.path.join(os.path.abspath(run_dir), f"heartbeat.{int(slot)}")


def _free_port() -> int:
    """A free port for the generation's process group. Rank 0 binds its
    TCP store there; each generation gets a fresh one, so a killed
    generation's store can never confuse the next."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class ElasticResult:
    exit_code: int      # 0: the run completed its whole step budget
    generations: int    # generations formed (generation 0 included)
    reforms: int        # changes of the world's size (shrink and grow)
    losses: int         # host-loss verdicts
    rejoins: int        # slots re-admitted
    planned: int        # all-exit-75 generation boundaries


@dataclasses.dataclass
class _GenOutcome:
    kind: str           # "done" | "planned" | "loss" | "startup"
    dead: set           # slots charged as lost (kind == "loss")
    beats: set          # slots that beat at least once
    exits: dict         # slot -> exit code (kill victims included)
    reason: str


class ElasticCoordinator:
    """Supervise an elastic world of up to ``n_hosts`` training processes.

    Args:
      n_hosts: host slots at full strength (slot ids ``0..n_hosts-1``).
      spawn: ``(members, rank, generation, port) -> argv``, the command of
        ``members[rank]``'s child. The child touches
        ``heartbeat_path(run_dir, members[rank])``, joins a
        ``torch.distributed`` group over ``127.0.0.1:<port>`` when
        ``len(members) > 1``, and follows the supervisor's exit protocol
        (0 done, 75 planned restart, anything else a crash).
      run_dir: the shared run directory: the membership file, the
        heartbeat files, the fault markers and host 0's event stream.
      min_world_size: the smallest admissible world; fewer surviving hosts
        force the full-strength restart (and, when even that cannot form,
        the give-up verdict).
      global_batch / local_devices: the planner's feasibility inputs; the
        preserved global batch must divide every admitted world's data
        axis. One process owns one device in the port, so
        ``local_devices`` is 1 unless the caller says otherwise.
      stall_timeout_s / grace_s / poll_s / backoff_*: the plain
        supervisor's knobs, applied per slot.
      max_reforms: unplanned re-forms (loss, full restart, startup retry)
        allowed before giving up; planned boundaries are free.
      readmit: the boundary's re-admission policy: "auto" re-offers every
        lost slot, "agent" only the slots that signalled recovery through
        ``membership.signal_ready``.
      env: the environment of every child (None: inherit).
    """

    def __init__(
        self,
        n_hosts: int,
        spawn: Callable[[Sequence[int], int, int, int], list],
        run_dir: str,
        *,
        min_world_size: int = 1,
        global_batch: int = 1,
        local_devices: int = 1,
        stall_timeout_s: float = 600.0,
        grace_s: Optional[float] = None,
        poll_s: float = 5.0,
        max_reforms: int = 8,
        backoff_base_s: float = 1.0,
        backoff_cap_s: float = 60.0,
        readmit: str = "auto",
        env: Optional[dict] = None,
        log=print,
    ):
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if readmit not in ("auto", "agent"):
            raise ValueError(
                f"readmit must be 'auto' or 'agent', got {readmit!r}"
            )
        self.n_hosts = n_hosts
        self.spawn = spawn
        self.run_dir = os.path.abspath(run_dir)
        self.min_world_size = min_world_size
        self.global_batch = global_batch
        self.local_devices = local_devices
        self.stall_timeout_s = stall_timeout_s
        self.grace_s = grace_s if grace_s is not None else max(
            stall_timeout_s, 600.0
        )
        self.poll_s = poll_s
        self.max_reforms = max_reforms
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.readmit = readmit
        self.env = env
        self.log = log
        self._spawns = 0
        self._rng = random.Random()  # backoff jitter

    # -- one generation -------------------------------------------------------

    def _run_generation(self, members: Sequence[int], generation: int,
                        port: int, record) -> _GenOutcome:
        # One heartbeat monitor per slot; reset gives each spawn a fresh
        # baseline: only a newer mtime proves this generation's child beat.
        mons = {
            slot: HeartbeatMonitor(
                heartbeat_path(self.run_dir, slot),
                self.stall_timeout_s, self.grace_s,
            )
            for slot in members
        }
        for mon in mons.values():
            mon.reset()
        procs: dict[int, subprocess.Popen] = {}
        for rank, slot in enumerate(members):
            self._spawns += 1
            argv = list(self.spawn(list(members), rank, generation, port))
            if faults.maybe_fail("spawn_fail", spawn=self._spawns):
                argv = [sys.executable, "-c", "raise SystemExit(13)"]
            procs[slot] = subprocess.Popen(
                argv, start_new_session=True, env=self.env
            )
            self.log(json.dumps({
                "coordinator": "spawn", "host": slot, "rank": rank,
                "generation": generation, "pid": procs[slot].pid,
            }))
            record("spawn", host=slot, rank=rank, generation=generation,
                   pid=procs[slot].pid)
        self_exits: dict[int, int] = {}
        stalled: Optional[int] = None
        first_crash: Optional[int] = None
        while True:
            # Complete the sweep before judging: breaking at the first dead
            # slot would make the loss verdict an artifact of dict order (a
            # lost slot 1 whose rank-0 peer errored out of the wedged
            # collective in the same poll window would read as "slot 0
            # died first" and shed the healthy host of the primary stream).
            sweep_dead: list[int] = []
            for slot, p in procs.items():
                if slot in self_exits:
                    continue
                rc = p.poll()
                if rc is not None:
                    self_exits[slot] = rc
                    if rc not in (0, RESTART_EXIT_CODE):
                        sweep_dead.append(slot)
            if sweep_dead and first_crash is None:
                # THE loss is the first observed death; within one sweep
                # the order is unobservable, so prefer the death that looks
                # like a host loss: killed by a signal, not an error exiting
                # through Python.
                first_crash = next(
                    (s for s in sweep_dead if self_exits[s] < 0),
                    sweep_dead[0],
                )
            if first_crash is not None or len(self_exits) == len(procs):
                break
            time.sleep(self.poll_s)
            for slot in members:
                if slot in self_exits:
                    continue
                if mons[slot].poll() == "stall":
                    stalled = slot
                    break
            if stalled is not None:
                self.log(json.dumps({
                    "coordinator": "stall", "host": stalled,
                    "generation": generation,
                }))
                record("stall", host=stalled, generation=generation)
                break
        if first_crash is not None:
            # A world failing fast (a bad flag, a broken cache) staggers its
            # exits over the spawn order: give the peers one short window
            # to die on their own before the kill below turns them into
            # "survivors we killed", the startup-against-loss test. An
            # isolated crash leaves its peers mid-step; they never exit here.
            deadline = time.monotonic() + min(self.poll_s, 0.5)
            while time.monotonic() < deadline \
                    and any(s not in self_exits for s in procs):
                for slot, p in procs.items():
                    if slot not in self_exits:
                        rc = p.poll()
                        if rc is not None:
                            self_exits[slot] = rc
                time.sleep(0.02)
        # The last beat sweep (a beat may have landed inside the last poll
        # window) before the kills below freeze the mtimes.
        for mon in mons.values():
            mon.recheck()
        beats = {slot for slot, mon in mons.items() if mon.beaten}
        exits = dict(self_exits)
        if first_crash is not None or stalled is not None:
            survivors_killed = 0
            for slot, p in procs.items():
                if p.poll() is None:
                    survivors_killed += 1
                    _kill_tree(p)
                exits.setdefault(slot, p.returncode)
            dead = {stalled} if stalled is not None else {first_crash}
            reason = ("stall" if stalled is not None
                      else f"exit_{self_exits[first_crash]}")
            if not beats and not survivors_killed:
                # Every member exited on its own before anyone came up: a
                # whole-generation startup failure (a bad flag, a broken
                # cache), not a host dying under load, and shrinking would
                # misdiagnose it. Had live peers to be killed, the crash
                # was isolated and its host is shed (kind "loss").
                return _GenOutcome("startup", set(), beats, exits, reason)
            return _GenOutcome("loss", dead, beats, exits, reason)
        for slot, p in procs.items():
            p.wait()
        if all(rc == 0 for rc in exits.values()):
            return _GenOutcome("done", set(), beats, exits, "done")
        if beats:
            # Uniform exit 75 (or a 0/75 mix at the budget's edge): the
            # generation checkpointed and asked for a fresh world, the
            # boundary where growth happens.
            return _GenOutcome("planned", set(), beats, exits, "planned")
        return _GenOutcome("startup", set(), beats, exits,
                           "exit_75_before_first_heartbeat")

    # -- the generation loop --------------------------------------------------

    def run(self) -> ElasticResult:
        from featurenet_tpu_torch.obs.events import EventSink, events_filename

        sink = EventSink(self.run_dir, filename=events_filename(0))

        def record(phase: str, **fields) -> None:
            sink.emit("supervisor", phase=phase, **fields)

        avail = set(range(self.n_hosts))
        lost: dict[int, int] = {}  # slot -> the generation it was lost in
        generation = 0
        prev_n = 0
        reason = "start"
        reforms = losses = rejoins = planned = 0
        reforms_used = 0
        startup_fails = 0
        consec_failures = 0

        def give_up(why: str, code: int) -> ElasticResult:
            self.log(json.dumps({"coordinator": "giving_up", "reason": why}))
            record("giving_up", reason=why, generation=generation,
                   losses=losses, reforms=reforms)
            sink.close()
            return ElasticResult(code if code else 1, generation + 1,
                                 reforms, losses, rejoins, planned)

        while True:
            try:
                members = plan_world(
                    avail,
                    min_world_size=self.min_world_size,
                    global_batch=self.global_batch,
                    local_devices=self.local_devices,
                )
            except InfeasibleWorld as e:
                return give_up(str(e), 1)
            if len(members) != prev_n:
                sink.emit("mesh_reform", generation=generation,
                          from_n=prev_n, to_n=len(members), reason=reason)
                self.log(json.dumps({
                    "coordinator": "mesh_reform", "generation": generation,
                    "from_n": prev_n, "to_n": len(members), "reason": reason,
                }))
                if prev_n:
                    reforms += 1
            # Keep the agent readiness signals of slots still out of the
            # world (the write replaces the whole document); a signal for a
            # slot now serving is consumed by its admission.
            prev = read_membership(self.run_dir)
            pending = tuple(sorted(
                set(prev.ready) - set(members)
            )) if prev is not None else ()
            write_membership(self.run_dir, Membership(
                generation=generation,
                members=tuple(members),
                min_world_size=self.min_world_size,
                reason=reason,
                ready=pending,
            ))
            out = self._run_generation(
                members, generation, _free_port(), record
            )
            if out.kind == "done":
                self.log(json.dumps({
                    "coordinator": "done", "generation": generation,
                    "world_size": len(members), "losses": losses,
                    "rejoins": rejoins, "planned": planned,
                }))
                record("done", generation=generation,
                       world_size=len(members), losses=losses,
                       rejoins=rejoins, planned=planned)
                sink.close()
                return ElasticResult(0, generation + 1, reforms, losses,
                                     rejoins, planned)
            if out.kind == "planned":
                planned += 1
                consec_failures = 0
                startup_fails = 0
                record("planned_restart", count=planned,
                       generation=generation)
                generation += 1
                prev_n = len(members)
                if lost:
                    # The boundary is where recovered hosts rejoin: "auto"
                    # offers every lost slot the next world (one still dead
                    # fails and is shed again without taking the run down),
                    # "agent" only the slots whose agent signalled
                    # readiness into membership.json.
                    back = sorted(lost) if self.readmit == "auto" else \
                        sorted(s for s in lost
                               if s in ready_slots(self.run_dir))
                    for slot in back:
                        sink.emit("host_join", host=slot,
                                  generation=generation)
                        rejoins += 1
                        del lost[slot]
                    avail |= set(back)
                    reason = "host_rejoin" if back else "planned"
                else:
                    reason = "planned"
                continue
            # Unplanned: a loss or a whole-generation startup failure.
            reforms_used += 1
            if out.kind == "startup":
                startup_fails += 1
                if startup_fails >= 2:
                    return give_up(
                        f"{out.reason} twice — deterministic startup "
                        "failure", max(out.exits.values(), default=1),
                    )
                reason = "restart"
            else:
                startup_fails = 0
                for slot in sorted(out.dead):
                    losses += 1
                    sink.emit("host_leave", host=slot,
                              generation=generation, reason=out.reason)
                    avail.discard(slot)
                    lost[slot] = generation
                reason = "host_loss"
                if len(avail) < self.min_world_size:
                    # Below the floor there is no world to shrink to:
                    # re-admit everything and restart at strength, on the
                    # reform budget, under readmit="agent" too (waiting for
                    # signals would idle the run on agents that may never
                    # come; a still-dead slot fails and is shed again).
                    for slot in sorted(lost):
                        sink.emit("host_join", host=slot,
                                  generation=generation + 1)
                        rejoins += 1
                    avail |= set(lost)
                    lost.clear()
                    reason = "restart"
            if reforms_used > self.max_reforms:
                return give_up(
                    f"reform budget exhausted ({self.max_reforms})",
                    max(out.exits.values(), default=1),
                )
            # Crash-loop backoff, the supervisor's shape: a deterministic
            # crash respawned at full speed would burn the reform budget in
            # seconds.
            consec_failures += 1
            delay = min(self.backoff_cap_s,
                        self.backoff_base_s * (2 ** (consec_failures - 1)))
            delay *= 0.5 + 0.5 * self._rng.random()
            if delay > 0:
                record("backoff", delay_s=round(delay, 3),
                       consecutive_failures=consec_failures)
                time.sleep(delay)
            generation += 1
            prev_n = len(members)
