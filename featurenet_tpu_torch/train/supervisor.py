"""Stall detection and automatic restart for training runs (port of
``featurenet_tpu/train/supervisor.py``; stdlib only).

A supervisor process watches a heartbeat file that the Trainer touches at
every confirmed point of device progress, and kills and restarts the
training process, which resumes from its newest good checkpoint, when the
heartbeat goes stale or the process dies. It has to be a separate process:
a stalled step can be a thread blocked inside the runtime, which only a
SIGKILL from outside reliably ends.

Used through ``python -m featurenet_tpu_torch.cli train --supervise
[...]``: the supervisor re-executes the same command line minus the
supervision flags, plus ``--heartbeat-file`` (``child_argv_from_cli``).
It requires ``--checkpoint-dir``: a restart without a resume would retrain
from scratch. The supervisor never touches the card itself; each child
makes its own CUDA context.

Not ported: the reference's ``run_dir`` half (the ``supervisor`` events in
the run's event log, the telemetry verdict on a child's exit and the
self-pinning segment gate), which reads the obs planes the port does not
have yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

from featurenet_tpu_torch import faults
from featurenet_tpu_torch.train.heartbeat import HeartbeatMonitor

# A child's exit code for "checkpointed, respawn me" (the planned-restart
# and preemption protocol): BSD's EX_TEMPFAIL, distinct from 0 (done) and
# from crash codes, so an unsupervised run exiting this way is visibly not
# finished.
RESTART_EXIT_CODE = 75


@dataclasses.dataclass
class SuperviseResult:
    exit_code: int  # the last child's exit code (0: success)
    restarts: int  # how many times the child was restarted
    stalls: int  # how many restarts were due to a stale heartbeat
    planned: int = 0  # planned respawns (exit 75 after progress), not counted


def _kill_tree(proc: subprocess.Popen) -> None:
    """SIGKILL the child's whole process group (its producer threads, the
    checkpoint writer, a graph replay in flight; nothing softer is sure
    to land)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        try:
            proc.kill()
        except ProcessLookupError:
            pass
    proc.wait()


def supervise(
    argv: Sequence[str],
    heartbeat_file: str,
    stall_timeout_s: float = 600.0,
    max_restarts: int = 5,
    poll_s: float = 5.0,
    grace_s: Optional[float] = None,
    log=print,
    backoff_base_s: float = 1.0,
    backoff_cap_s: float = 60.0,
) -> SuperviseResult:
    """Run ``argv`` under stall supervision; restart on a stall or a crash.

    Args:
      argv: the whole child command, without the supervision flags but with
        ``--heartbeat-file`` naming ``heartbeat_file`` (the caller builds
        it: a path invented here could never be the one the child touches).
      heartbeat_file: the file the child touches; refreshed before each
        spawn.
      stall_timeout_s: the heartbeat age that counts as a hang.
      max_restarts: restarts allowed before giving up.
      poll_s: the interval of the heartbeat polls (a child's exit is seen
        at once).
      grace_s: the stall clock's allowance for a child's cold start;
        ``max(stall_timeout_s, 600)`` by default.
      log: the sink of one-line JSON status records.
      backoff_base_s / backoff_cap_s: crash-loop backoff. Every unplanned
        restart sleeps ``min(cap, base * 2**(n-1))`` (n: consecutive
        unplanned restarts) times a jitter in [0.5, 1) before respawning.
        A planned restart (exit 75 after a beat) respawns at once, costs
        no restart and ends the streak.

    Two nonzero exits in a row before any heartbeat are a deterministic
    startup failure, and the supervisor gives up. Returns a
    ``SuperviseResult``; ``exit_code`` 0 means the child finished.
    """
    grace = grace_s if grace_s is not None else max(stall_timeout_s, 600.0)
    restarts = stalls = planned = 0
    # Consecutive nonzero exits before any heartbeat: one retry tolerates a
    # transient, two in a row is permanent.
    early_fails = 0
    # Consecutive unplanned respawns: the backoff's exponent.
    consec_failures = 0
    spawns = 0
    rng = random.Random()  # jitter only
    mon = HeartbeatMonitor(heartbeat_file, stall_timeout_s, grace)
    while True:
        mon.reset()
        spawns += 1
        spawn_argv = list(argv)
        if faults.maybe_fail("spawn_fail", spawn=spawns):
            # A child slot filled by a process that dies at once: a bad
            # binary path, a refused exec, an OOM kill at start.
            spawn_argv = [sys.executable, "-c", "raise SystemExit(13)"]
        proc = subprocess.Popen(spawn_argv, start_new_session=True)
        log(json.dumps({"supervisor": "spawn", "pid": proc.pid,
                        "attempt": restarts + 1}))
        stalled = False
        while True:
            try:
                # An exit ends the wait at once; the reference sleeps out
                # the poll interval first.
                rc = proc.wait(timeout=poll_s)
                break
            except subprocess.TimeoutExpired:
                pass
            if mon.poll() == "stall":
                stalled = True
                log(json.dumps({
                    "supervisor": "stall", "pid": proc.pid,
                    "heartbeat_age_s": round(mon.age_s, 1),
                }))
                _kill_tree(proc)
                rc = proc.returncode
                break
        # The last beat may have landed inside the last poll window.
        first_beat_seen = mon.recheck()
        if not stalled and rc == 0:
            log(json.dumps({"supervisor": "done", "restarts": restarts,
                            "stalls": stalls, "planned": planned}))
            return SuperviseResult(0, restarts, stalls, planned)
        if not stalled and rc == RESTART_EXIT_CODE and first_beat_seen:
            # Planned: the child checkpointed and asked for a fresh
            # process. Free, and real progress, so both streaks end.
            planned += 1
            early_fails = 0
            consec_failures = 0
            log(json.dumps({"supervisor": "planned_restart",
                            "count": planned}))
            continue
        if not stalled and not first_beat_seen:
            early_fails += 1
            if early_fails >= 2:
                log(json.dumps({
                    "supervisor": "giving_up",
                    "reason": f"exit_{rc} before first heartbeat, twice — "
                              "deterministic startup failure",
                    "restarts": restarts, "stalls": stalls,
                }))
                return SuperviseResult(rc if rc else 1, restarts, stalls,
                                       planned)
        else:
            early_fails = 0
        stalls += int(stalled)
        restarts += 1
        if restarts > max_restarts:
            log(json.dumps({"supervisor": "giving_up", "restarts": restarts - 1,
                            "stalls": stalls, "last_exit": rc}))
            return SuperviseResult(rc if rc else 1, restarts - 1, stalls,
                                   planned)
        reason = "stall" if stalled else f"exit_{rc}"
        consec_failures += 1
        delay = min(backoff_cap_s,
                    backoff_base_s * (2 ** (consec_failures - 1)))
        delay *= 0.5 + 0.5 * rng.random()
        if delay > 0:
            log(json.dumps({"supervisor": "backoff",
                            "delay_s": round(delay, 3),
                            "consecutive_failures": consec_failures}))
            time.sleep(delay)
        log(json.dumps({"supervisor": "restart", "attempt": restarts + 1,
                        "reason": reason}))


def child_argv_from_cli(argv: Sequence[str], heartbeat_file: str) -> list[str]:
    """This process's command line rewritten into the supervised child's:
    the supervision flags stripped, the heartbeat path and the
    ``--supervised-child`` marker added."""
    out = [sys.executable, "-m", "featurenet_tpu_torch.cli"]
    skip_next = False
    for a in argv:
        if skip_next:
            skip_next = False
            continue
        if a == "--supervise":
            continue
        if a in ("--stall-timeout", "--max-restarts", "--heartbeat-file"):
            skip_next = True
            continue
        if a.startswith(
            ("--stall-timeout=", "--max-restarts=", "--heartbeat-file=")
        ):
            continue
        out.append(a)
    out += ["--heartbeat-file", heartbeat_file]
    # The CLI refuses a bare --restart-every (nothing would respawn the
    # exit-75 child); this child's respawner is the supervisor.
    out.append("--supervised-child")
    return out
