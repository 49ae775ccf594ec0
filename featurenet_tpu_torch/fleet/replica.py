"""The replica manager: N supervised ``cli serve`` children and the roster,
and the autoscaler that acts on the router's verdicts (port of
``featurenet_tpu/fleet/replica.py``; stdlib only).

One replica is one ``featurenet_tpu_torch.cli serve --port 0`` child, its
own process with its own CUDA context on the card.

- **Spawn**: the child prints its banner (``{"serving": {..., "port":
  P}}``) into ``<run_dir>/replica.<slot>.out``; the manager tails that
  file to learn the port. A child that prints none within
  ``spawn_timeout_s`` is killed and charged as a startup loss. The
  ``spawn_fail`` fault site replaces the Nth spawn's argv with a process
  that exits 13.
- **Liveness**: exit-code polling, plus the heartbeat state machine
  (``train/heartbeat.HeartbeatMonitor``): the child touches its heartbeat
  file once a second while ready or swapping; a child alive but silent
  past ``stall_timeout_s`` is SIGKILLed (``train/supervisor._kill_tree``).
- **Readiness**: each replica's ``/healthz`` is probed every poll, off the
  tick thread, over the fleet's connection pool; a replica routes traffic
  only while its probe answers 200, and the probed ``queue_depth`` feeds
  the router's pick. A connection-level probe failure retires the
  endpoint's pooled channels.
- **Loss and respawn**: a lost replica respawns after an exponential
  backoff (``backoff_base_s`` doubling up to ``backoff_cap_s``, at most
  ``max_respawns`` in all) and rejoins the roster only when its
  ``/healthz`` turns ready. The port's child captures its own serving
  graphs at warmup (no executable cache to share); the kernels' nvcc build
  cache (``ops/build.py``) must already be warm.
- **Roster**: every ready or loss transition rewrites ``membership.json``
  (``elastic/membership.py``; reason ``start``, ``replica_loss``,
  ``replica_rejoin`` or ``scale_down``) and emits ``fleet_replica_ready``
  / ``fleet_replica_loss``.

The manager never imports torch: its process supervises the
device-owning children and never touches a device itself.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

from featurenet_tpu_torch import faults, obs
from featurenet_tpu_torch.elastic.coordinator import heartbeat_path
from featurenet_tpu_torch.elastic.membership import Membership, write_membership
from featurenet_tpu_torch.fleet.pool import ConnectionPool
from featurenet_tpu_torch.train.heartbeat import HeartbeatMonitor
from featurenet_tpu_torch.train.supervisor import _kill_tree

DEFAULT_POLL_S = 0.25
DEFAULT_GRACE_S = 300.0  # the warmup's allowance: CUDA init and captures
DEFAULT_STALL_TIMEOUT_S = 30.0
DEFAULT_SPAWN_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One routable replica as the router sees it: where to connect, and
    its ``score`` (probed queue depth + the router's in-flight count)."""

    slot: int
    host: str
    port: int
    score: int


class _Replica:
    """One slot's live state (the fields router threads read are guarded
    by the manager's lock)."""

    def __init__(self, slot: int):
        self.slot = slot
        self.proc: Optional[subprocess.Popen] = None
        self.out_path: Optional[str] = None
        self.out_offset = 0
        self.port: Optional[int] = None
        self.ready = False
        self.queue_depth = 0
        self.inflight = 0
        self.spawned_t = 0.0
        self.respawn_due = 0.0
        self.failures = 0  # consecutive, for the backoff
        self.was_lost = False  # a later ready is a rejoin
        self.mon: Optional[HeartbeatMonitor] = None
        self.probe_inflight = False  # one outstanding probe at a time
        # A slot shed by the autoscaler: neither respawned nor charged.
        self.parked = False
        self.model_version: Optional[str] = None  # from the last probe


class ReplicaManager:
    """Spawn and supervise ``n`` replicas; the router's health-gated view.

    ``spawn(slot, heartbeat_file) -> argv`` builds one replica's command
    (``fleet/loadgen.replica_argv``). The child prints the serve banner on
    stdout and touches ``heartbeat_file`` while ready."""

    def __init__(self, n: int, spawn: Callable[[int, str], list],
                 run_dir: str, *,
                 host: str = "127.0.0.1",
                 poll_s: float = DEFAULT_POLL_S,
                 grace_s: float = DEFAULT_GRACE_S,
                 stall_timeout_s: float = DEFAULT_STALL_TIMEOUT_S,
                 spawn_timeout_s: float = DEFAULT_SPAWN_TIMEOUT_S,
                 max_respawns: int = 16,
                 backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 10.0,
                 probe_timeout_s: float = 2.0,
                 env: Optional[dict] = None,
                 pool: Optional[ConnectionPool] = None):
        if n < 1:
            raise ValueError(f"replicas must be >= 1, got {n}")
        self.n = n
        self.spawn = spawn
        self.run_dir = os.path.abspath(run_dir)
        self.host = host
        self.poll_s = poll_s
        self.grace_s = grace_s
        self.stall_timeout_s = stall_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.max_respawns = max_respawns
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.probe_timeout_s = probe_timeout_s
        self.env = env
        # The fleet's one pool: probes here, forwards in the router.
        self.pool = pool or ConnectionPool()
        self._lock = threading.Lock()
        self._replicas = {slot: _Replica(slot) for slot in range(n)}
        self._spawns = 0
        self._losses = 0
        self._rejoins = 0
        self._generation = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        os.makedirs(self.run_dir, exist_ok=True)
        for r in self._replicas.values():
            self._spawn(r)
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-replicas", daemon=True)
        self._thread.start()

    def stop(self, timeout_s: float = 20.0) -> None:
        """SIGTERM every child (a serve child drains on it), wait, SIGKILL
        the stragglers, stop supervising."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 4 * self.poll_s))
        procs = [r.proc for r in self._replicas.values()
                 if r.proc is not None and r.proc.poll() is None]
        for p in procs:
            try:
                p.terminate()
            except OSError:
                pass
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _kill_tree(p)
        self.pool.close()

    # -- spawn and supervision -----------------------------------------------
    def _spawn(self, r: _Replica) -> None:
        # The tick thread and the autoscaler's add_one both spawn.
        with self._lock:
            self._spawns += 1
            spawn_seq = self._spawns
        hb = heartbeat_path(self.run_dir, r.slot)
        r.mon = HeartbeatMonitor(hb, self.stall_timeout_s, self.grace_s)
        r.mon.reset()
        argv = list(self.spawn(r.slot, hb))
        if faults.maybe_fail("spawn_fail", spawn=spawn_seq):
            argv = [sys.executable, "-c", "raise SystemExit(13)"]
        r.out_path = os.path.join(self.run_dir, f"replica.{r.slot}.out")
        r.out_offset = 0
        # Truncated: the banner scan must find this spawn's banner.
        fh = open(r.out_path, "wb")
        try:
            r.proc = subprocess.Popen(argv, stdout=fh, stderr=subprocess.STDOUT,
                                      start_new_session=True, env=self.env)
        finally:
            fh.close()
        r.port = None
        r.ready = False
        r.queue_depth = 0
        r.spawned_t = time.monotonic()
        obs.emit("supervisor", phase="spawn", host=r.slot, pid=r.proc.pid,
                 generation=self._generation)

    def _scan_banner(self, r: _Replica) -> Optional[int]:
        """The child's bound port from its stdout file."""
        try:
            with open(r.out_path, "rb") as fh:
                fh.seek(r.out_offset)
                chunk = fh.read()
        except OSError:
            return None
        # Only whole lines advance the offset; a torn tail is read again.
        end = chunk.rfind(b"\n")
        if end < 0:
            return None
        r.out_offset += end + 1
        for line in chunk[:end].splitlines():
            try:
                doc = json.loads(line.decode("utf-8", "replace"))
                if isinstance(doc, dict) and "serving" in doc:
                    return int(doc["serving"]["port"])
            except (ValueError, KeyError, TypeError):
                continue
        return None

    def _probe(self, port: int) -> Optional[dict]:
        """One pooled ``/healthz`` probe of the port the caller captured:
        the body on 200, else None. Only a connection-level failure retires
        the endpoint's channels: a warming or draining 503 came over a
        healthy channel."""
        try:
            status, body = self.pool.get(self.host, port, "/healthz",
                                         timeout_s=self.probe_timeout_s)
            if status != 200:
                return None
            return json.loads(body.decode("utf-8"))
        except (OSError, http.client.HTTPException, ValueError):
            self.pool.retire_endpoint(self.host, port, "probe_failure")
            return None

    def _lose(self, r: _Replica, reason: str) -> None:
        if r.proc is not None and r.proc.poll() is None:
            _kill_tree(r.proc)
        was_ready = r.ready
        port = r.port
        with self._lock:
            r.proc = None
            r.port = None
            r.ready = False
            r.was_lost = True
            r.failures += 1
            self._losses += 1
            delay = min(self.backoff_cap_s,
                        self.backoff_base_s * (2 ** (r.failures - 1)))
            r.respawn_due = time.monotonic() + delay
        if port is not None:
            self.pool.retire_endpoint(self.host, port, "replica_loss")
        obs.emit("fleet_replica_loss", replica=r.slot, reason=reason)
        if was_ready:
            self._write_roster("replica_loss")

    def _tick(self) -> None:
        now = time.monotonic()
        for r in list(self._replicas.values()):
            if r.parked:
                continue
            if r.proc is None:
                if now >= r.respawn_due and \
                        self._spawns - self.n < self.max_respawns:
                    self._spawn(r)
                continue
            rc = r.proc.poll()
            if rc is not None:
                self._lose(r, f"exit_{rc}")
                continue
            if r.port is None:
                port = self._scan_banner(r)
                if port is not None:
                    r.port = port
                elif now - r.spawned_t > self.spawn_timeout_s:
                    self._lose(r, "startup_timeout")
                continue
            if r.mon is not None and r.mon.poll() == "stall":
                # Alive, heartbeat stale: a wedged replica.
                self._lose(r, "stall")
                continue
            # The probe runs off the tick thread (one per replica at a
            # time): a wedged replica's probe blocks its full timeout.
            with self._lock:
                launch = not r.probe_inflight
                r.probe_inflight = launch
            if launch:
                threading.Thread(target=self._probe_update, args=(r,),
                                 name=f"fleet-probe-{r.slot}",
                                 daemon=True).start()

    def _probe_update(self, r: _Replica) -> None:
        """One ``/healthz`` probe and its fold into the slot's state."""
        try:
            port = r.port
            if port is None or r.proc is None:
                return
            health = self._probe(port)
            if health is None:
                # Not routable now; the kill verdict stays with the
                # heartbeat and the exit code.
                with self._lock:
                    r.ready = False
                return
            with self._lock:
                if r.port != port:  # lost or respawned meanwhile
                    return
                r.queue_depth = int(health.get("queue_depth") or 0)
                version = health.get("model_version")
                if isinstance(version, str):
                    r.model_version = version
                first_ready = not r.ready
                r.ready = True
                if first_ready:
                    r.failures = 0
                    if r.was_lost:
                        self._rejoins += 1
            if first_ready:
                obs.emit("fleet_replica_ready", replica=r.slot, port=r.port,
                         model_version=r.model_version)
                self._write_roster("replica_rejoin" if r.was_lost else "start")
        finally:
            with self._lock:
                r.probe_inflight = False

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:  # the one thread that respawns must live
                obs.warn("fleet_tick_error", repr(e)[:300])
            self._stop.wait(self.poll_s)

    def _write_roster(self, reason: str) -> None:
        """The ready set into ``membership.json``."""
        with self._lock:
            members = tuple(sorted(r.slot for r in self._replicas.values()
                                   if r.ready))
            self._generation += 1
            generation = self._generation
        write_membership(self.run_dir, Membership(
            generation=generation, members=members, min_world_size=1,
            reason=reason))

    # -- the router's view ---------------------------------------------------
    def candidates(self) -> list[Candidate]:
        """Ready replicas, least loaded first."""
        with self._lock:
            out = [Candidate(r.slot, self.host, r.port,
                             r.queue_depth + r.inflight)
                   for r in self._replicas.values()
                   if r.ready and r.port is not None]
        return sorted(out, key=lambda c: (c.score, c.slot))

    def note_inflight(self, slot: int, delta: int) -> None:
        with self._lock:
            r = self._replicas.get(slot)
            if r is not None:
                r.inflight = max(0, r.inflight + delta)

    def note_failure(self, slot: int) -> None:
        """A connection failure the router saw: out of the candidates now;
        the tick confirms the death and charges the loss."""
        with self._lock:
            r = self._replicas.get(slot)
            if r is not None:
                r.ready = False

    def kill_one(self) -> Optional[int]:
        """SIGKILL the highest live slot (the ``replica_loss`` site's arm);
        returns it, or None."""
        for r in sorted(self._replicas.values(), key=lambda x: -x.slot):
            if r.parked:
                continue
            if r.proc is not None and r.proc.poll() is None:
                _kill_tree(r.proc)
                return r.slot
        return None

    # -- the autoscaler's levers ---------------------------------------------
    def add_one(self) -> int:
        """Grow the roster by one: revive the lowest parked slot, else a new
        slot id. It joins the candidates when its ``/healthz`` turns ready.
        The caller owns the upper bound."""
        with self._lock:
            parked = sorted(r.slot for r in self._replicas.values()
                            if r.parked)
            if parked:
                r = self._replicas[parked[0]]
                r.parked = False
                r.failures = 0
                r.respawn_due = 0.0
            else:
                r = _Replica(max(self._replicas) + 1)
                self._replicas[r.slot] = r
            self.n += 1
        self._spawn(r)
        return r.slot

    def shed_one(self, drain_wait_s: float = 10.0) -> Optional[int]:
        """Shrink the roster by one: the highest ready slot leaves the
        candidates at once, its router in-flight drains (bounded), then it
        is SIGTERMed (a serve child drains its queue) and parked: neither
        respawned nor charged. Returns the slot, or None when nothing can
        go (the last replica never does)."""
        with self._lock:
            victims = sorted((r for r in self._replicas.values()
                              if r.ready and not r.parked),
                             key=lambda x: -x.slot)
            live = sum(1 for r in self._replicas.values()
                       if not r.parked and r.proc is not None)
            if not victims or live <= 1 or self.n <= 1:
                return None
            r = victims[0]
            r.parked = True
            r.ready = False
            self.n -= 1
        self._write_roster("scale_down")
        deadline = time.monotonic() + drain_wait_s
        while time.monotonic() < deadline:
            with self._lock:
                if r.inflight <= 0:
                    break
            time.sleep(self.poll_s)
        proc, port = r.proc, r.port
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
            except OSError:
                pass
            try:
                proc.wait(timeout=max(drain_wait_s, 5.0))
            except subprocess.TimeoutExpired:
                _kill_tree(proc)
        if port is not None:
            self.pool.retire_endpoint(self.host, port, "replica_loss")
        with self._lock:
            r.proc = None
            r.port = None
            r.queue_depth = 0
        return r.slot

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values() if r.ready)

    def stats(self) -> dict:
        with self._lock:
            return {
                "replicas": self.n,
                "ready": sum(1 for r in self._replicas.values() if r.ready),
                "parked": sum(1 for r in self._replicas.values() if r.parked),
                "spawns": self._spawns,
                "losses": self._losses,
                "rejoins": self._rejoins,
                "ports": {r.slot: r.port for r in self._replicas.values()
                          if r.port is not None},
                "versions": {r.slot: r.model_version
                             for r in self._replicas.values()
                             if r.model_version is not None},
            }


class Autoscaler:
    """Turn the router's ``scale_state()`` verdicts into ``add_one`` /
    ``shed_one``, damped three ways:

    - **Honest hold**: a ``shed`` with both burn rates ``None`` (no data)
      is held; an ``add`` with both ``None`` and no queued work (the cold
      fleet mid-warmup) is held too. An ``add`` backed by a queue stands.
    - **Hysteresis**: the same actionable verdict must hold for
      ``hysteresis`` consecutive evaluations.
    - **Cooldown**: at least ``cooldown_s`` since the last ACTION (not the
      last verdict change), so an oscillating verdict cannot fire on every
      rising edge.

    Never below ``min_replicas`` or above ``max_replicas`` (a verdict at a
    bound is refused without arming the cooldown). Every action is a
    ``fleet_autoscale`` event. ``step()`` takes the clock from its caller;
    ``start()`` runs it on its own thread."""

    def __init__(self, manager, scale_state: Callable[[], dict], *,
                 min_replicas: int = 1,
                 max_replicas: int = 8,
                 hysteresis: int = 3,
                 cooldown_s: float = 30.0,
                 interval_s: float = 1.0):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(f"max_replicas ({max_replicas}) must be >= "
                             f"min_replicas ({min_replicas})")
        self.manager = manager
        self.scale_state = scale_state
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.hysteresis = max(1, int(hysteresis))
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self.actions = 0
        self._streak_verdict = "hold"
        self._streak = 0
        self._last_action_t: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self, state: dict, now: float) -> Optional[dict]:
        """Judge one ``scale_state`` snapshot at ``now``; the action record
        (also a ``fleet_autoscale`` event) when the roster moved, else
        None."""
        verdict = state.get("verdict", "hold")
        burn_fast = state.get("burn_fast")
        burn_slow = state.get("burn_slow")
        if verdict == "shed" and burn_fast is None and burn_slow is None:
            verdict = "hold"
        if verdict == "add" and burn_fast is None and burn_slow is None \
                and (state.get("queue_depth") or 0) <= 0:
            verdict = "hold"
        if verdict == self._streak_verdict:
            self._streak += 1
        else:
            self._streak_verdict = verdict
            self._streak = 1
        if verdict not in ("add", "shed"):
            return None
        if self._streak < self.hysteresis:
            return None
        if self._last_action_t is not None and \
                now - self._last_action_t < self.cooldown_s:
            return None
        from_n = self.manager.n
        reason = (f"sustained_{verdict}(streak={self._streak},"
                  f"burn_fast={burn_fast},burn_slow={burn_slow},"
                  f"queue_depth={state.get('queue_depth')})")
        if verdict == "add":
            if from_n >= self.max_replicas:
                return None
            self.manager.add_one()
        else:
            if from_n <= self.min_replicas:
                return None
            if self.manager.shed_one() is None:
                return None
        to_n = self.manager.n
        self._last_action_t = now
        self._streak = 0
        self.actions += 1
        action = {"action": verdict, "from_n": from_n, "to_n": to_n,
                  "reason": reason}
        obs.emit("fleet_autoscale", action=verdict, from_n=from_n, to_n=to_n,
                 reason=reason)
        return action

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-autoscaler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(2.0, 2 * self.interval_s))
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step(self.scale_state(), time.monotonic())
            except Exception as e:  # the control loop outlives a bad tick
                obs.warn("fleet_autoscale_error", repr(e)[:300])
            self._stop.wait(self.interval_s)

    def stats(self) -> dict:
        return {"actions": self.actions, "streak": self._streak,
                "streak_verdict": self._streak_verdict,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas}
