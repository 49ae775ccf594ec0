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
makes its own CUDA context. It imports the standard library and the
port's stdlib-only modules (``faults``, ``heartbeat``, ``obs``), never
torch.

With ``run_dir`` (the child's ``--run-dir``) every decision is also a
``supervisor`` event in process 0's stream, beside the child's own events
(each emit is one ``O_APPEND`` write of one line, so the two writers
interleave whole lines). A child's exit 0 is then checked: the event lines
it appended are linted as ``cli report --validate`` lints them, and
structural corruption is a ``telemetry_corrupt`` restart on the failure
budget. Each clean segment is gated: the first pins
``<run_dir>/gate_baseline.json`` (``SEGMENT_GATE_METRICS``), every later
one is judged against it (``gate`` or ``gate_regression`` events). The
gate never changes a verdict: its own errors are a ``gate_error`` log
line.
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


def _stream_offsets(run_dir: str) -> dict[str, int]:
    """Byte size of every event stream now: the start of one child's
    window of lines."""
    from featurenet_tpu_torch.obs.report import discover_event_files

    return {
        path: os.path.getsize(path)
        for path, _ in discover_event_files(run_dir)
    }


# The validate_events checks that count as crash evidence: structural
# corruption (torn or garbage lines, fields the report cannot fold,
# impossible durations). Nesting and orphan-parent findings are left out:
# a sink that went dark mid-run (ENOSPC; the run goes on by design) leaves
# parents whose closing lines never landed, and restarting a finished run
# because its telemetry went dark would make telemetry load-bearing.
_CORRUPTION_CHECKS = frozenset({
    "parse", "unknown_kind", "missing_fields", "negative_duration",
})


def _window_events(run_dir: str,
                   offsets: dict[str, int]) -> tuple[list[dict], int]:
    """Parse only the event lines appended since ``offsets`` (one child's
    lifetime). A torn trailing fragment (no newline at the end) is what a
    sink that died on a short write leaves as its last bytes, and the
    child then finished dark by design: it is dropped uncounted, as the
    live tail drops a partial last line. Garbage followed by more lines
    still counts. One parser (``obs.report._parse_lines``) for the report,
    this verdict and the segment gate."""
    from featurenet_tpu_torch.obs.report import _parse_lines, discover_event_files

    events: list[dict] = []
    bad = 0
    for path, idx in discover_event_files(run_dir):
        try:
            with open(path, "rb") as fh:
                fh.seek(offsets.get(path, 0))
                data = fh.read()
        except OSError:
            continue
        if data and not data.endswith(b"\n"):
            data = data[:data.rfind(b"\n") + 1] if b"\n" in data else b""
        bad += _parse_lines(
            data.decode("utf-8", errors="replace").splitlines(), idx, events
        )
    events.sort(key=lambda e: e["t"])
    return events, bad


def _telemetry_findings(run_dir: str, offsets: dict[str, int]) -> list[dict]:
    """Lint only the event lines appended since ``offsets`` (an old torn
    line must not condemn every later child), narrowed to
    ``_CORRUPTION_CHECKS``."""
    from featurenet_tpu_torch.obs.report import validate_events

    events, bad = _window_events(run_dir, offsets)
    return [f for f in validate_events(events, bad_lines=bad)
            if f.get("check") in _CORRUPTION_CHECKS]


# --- segment gating (self-pinning regression gates) --------------------------

# The baseline pinned from the first clean segment's report, in
# obs/gates.py's shape (`cli report --gate <run_dir>/gate_baseline.json`
# reads it).
GATE_BASELINE_FILENAME = "gate_baseline.json"

# The metrics every training segment records. Restart and stall counts are
# cumulative (a second segment would always "regress" them), and serving
# and heartbeat metrics are absent from short segments.
SEGMENT_GATE_METRICS = ("step_ms", "data_wait_fraction", "data_wait_spread",
                        "bad_lines")

# Segments are short and each pays its own cold start, so the tolerance
# is loose: the gate catches drift, it does not re-measure the benchmark.
SEGMENT_GATE_TOLERANCE = 0.35


def segment_gate_values(run_dir: str, offsets: dict[str, int]) -> dict:
    """The gateable scalars of one segment: the report of the lines
    appended in the child's lifetime, narrowed to
    ``SEGMENT_GATE_METRICS``."""
    from featurenet_tpu_torch.obs.gates import report_gate_values
    from featurenet_tpu_torch.obs.report import build_report

    events, bad = _window_events(run_dir, offsets)
    rep = build_report(events, bad_lines=bad)
    vals = report_gate_values(rep)
    return {k: v for k, v in vals.items() if k in SEGMENT_GATE_METRICS}


def _gate_segment(run_dir: str, offsets: dict[str, int], record, log) -> None:
    """After a clean segment: pin a baseline from the first, judge every
    later one against it (``gate`` / ``gate_regression``). Never
    load-bearing: a failed gate changes no verdict and costs no restart,
    and an error of its own is a ``gate_error`` log line."""
    from featurenet_tpu_torch.obs import gates as obs_gates

    try:
        vals = segment_gate_values(run_dir, offsets)
        if "step_ms" not in vals:
            return  # no loop ran in this segment: nothing to judge
        path = os.path.join(run_dir, GATE_BASELINE_FILENAME)
        if not os.path.exists(path):
            baseline = obs_gates.make_baseline(
                vals, tolerance=SEGMENT_GATE_TOLERANCE
            )
            # A relative tolerance on a near-zero baseline (a well-fed
            # pipeline's data-wait fraction) pins "never change".
            for name, slack in (("data_wait_fraction", 0.05),
                                ("data_wait_spread", 0.1)):
                pin = baseline["gates"].get(name)
                if pin is not None:
                    pin["tolerance_abs"] = slack
            tmp = path + ".tmp"  # never half a baseline
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(baseline, fh, indent=1)
            os.replace(tmp, path)
            log(json.dumps({"supervisor": "auto_pin", "baseline": path,
                            "metrics": sorted(vals)}))
            record("auto_pin", baseline=path, metrics=sorted(vals))
            return
        result = obs_gates.evaluate_gates(vals, obs_gates.load_baseline(path))
        if result["ok"]:
            log(json.dumps({"supervisor": "gate", "ok": True}))
            record("gate", ok=True)
        else:
            log(json.dumps({"supervisor": "gate_regression",
                            "failed": result["failed"]}))
            record("gate_regression", failed=result["failed"],
                   values={k: vals.get(k) for k in result["failed"]})
    except Exception as e:  # the judge never kills the run
        log(json.dumps({"supervisor": "gate_error",
                        "error": repr(e)[:300]}))


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
    run_dir: Optional[str] = None,
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
      run_dir: the child's run directory: each decision is also a
        ``supervisor`` event there, and the telemetry verdict and the
        segment gate run (see the module docstring). A child's lines are
        linted on its exit 0; corrupt telemetry is crash evidence
        (``telemetry_corrupt``).
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
    sink = None
    if run_dir:
        from featurenet_tpu_torch.obs.events import EventSink, events_filename

        # Process 0's stream, which the child appends to as well.
        sink = EventSink(run_dir, filename=events_filename(0))

    def record(phase: str, **fields) -> None:
        if sink is not None:
            sink.emit("supervisor", phase=phase, **fields)

    def finish(result: SuperviseResult) -> SuperviseResult:
        if sink is not None:
            sink.close()
        return result

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
        # This child's window of lines: linted on its exit 0, and folded
        # into the segment report the gate judges.
        offsets = _stream_offsets(run_dir) if run_dir else {}
        spawns += 1
        spawn_argv = list(argv)
        if faults.maybe_fail("spawn_fail", spawn=spawns):
            # A child slot filled by a process that dies at once: a bad
            # binary path, a refused exec, an OOM kill at start.
            spawn_argv = [sys.executable, "-c", "raise SystemExit(13)"]
        proc = subprocess.Popen(spawn_argv, start_new_session=True)
        log(json.dumps({"supervisor": "spawn", "pid": proc.pid,
                        "attempt": restarts + 1}))
        record("spawn", pid=proc.pid, attempt=restarts + 1)
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
                record("stall", pid=proc.pid,
                       heartbeat_age_s=round(mon.age_s, 1))
                _kill_tree(proc)
                rc = proc.returncode
                break
        # The last beat may have landed inside the last poll window.
        first_beat_seen = mon.recheck()
        telemetry_bad = False
        if not stalled and rc == 0 and run_dir:
            # Exit 0 is a claim; the lines the child appended are the
            # evidence.
            try:
                findings = _telemetry_findings(run_dir, offsets)
            except Exception as e:  # the lint never kills the supervisor
                findings = []
                log(json.dumps({"supervisor": "validate_error",
                                "error": repr(e)}))
            if findings:
                telemetry_bad = True
                log(json.dumps({
                    "supervisor": "telemetry_corrupt",
                    "findings": len(findings),
                    "first": findings[0].get("msg"),
                }))
                record("telemetry_corrupt", findings=len(findings),
                       first=findings[0].get("msg"))
        if not stalled and rc == 0 and not telemetry_bad:
            # The last segment is gated like any other.
            if run_dir:
                _gate_segment(run_dir, offsets, record, log)
            log(json.dumps({"supervisor": "done", "restarts": restarts,
                            "stalls": stalls, "planned": planned}))
            record("done", restarts=restarts, stalls=stalls, planned=planned)
            return finish(SuperviseResult(0, restarts, stalls, planned))
        if not stalled and rc == RESTART_EXIT_CODE and first_beat_seen:
            # Planned: the child checkpointed and asked for a fresh
            # process. Free, and real progress, so both streaks end.
            planned += 1
            early_fails = 0
            consec_failures = 0
            if run_dir:
                _gate_segment(run_dir, offsets, record, log)
            log(json.dumps({"supervisor": "planned_restart",
                            "count": planned}))
            record("planned_restart", count=planned)
            continue
        if not stalled and not first_beat_seen and not telemetry_bad:
            early_fails += 1
            if early_fails >= 2:
                log(json.dumps({
                    "supervisor": "giving_up",
                    "reason": f"exit_{rc} before first heartbeat, twice — "
                              "deterministic startup failure",
                    "restarts": restarts, "stalls": stalls,
                }))
                record("giving_up", reason=f"exit_{rc} before first "
                       "heartbeat, twice", restarts=restarts, stalls=stalls)
                return finish(SuperviseResult(rc if rc else 1, restarts,
                                              stalls, planned))
        else:
            early_fails = 0
        stalls += int(stalled)
        restarts += 1
        if restarts > max_restarts:
            log(json.dumps({"supervisor": "giving_up", "restarts": restarts - 1,
                            "stalls": stalls, "last_exit": rc}))
            record("giving_up", restarts=restarts - 1, stalls=stalls,
                   last_exit=rc)
            return finish(SuperviseResult(rc if rc else 1, restarts - 1,
                                          stalls, planned))
        reason = ("stall" if stalled
                  else "telemetry_corrupt" if telemetry_bad
                  else f"exit_{rc}")
        consec_failures += 1
        delay = min(backoff_cap_s,
                    backoff_base_s * (2 ** (consec_failures - 1)))
        delay *= 0.5 + 0.5 * rng.random()
        if delay > 0:
            log(json.dumps({"supervisor": "backoff",
                            "delay_s": round(delay, 3),
                            "consecutive_failures": consec_failures}))
            record("backoff", delay_s=round(delay, 3),
                   consecutive_failures=consec_failures)
            time.sleep(delay)
        log(json.dumps({"supervisor": "restart", "attempt": restarts + 1,
                        "reason": reason}))
        record("restart", attempt=restarts + 1, reason=reason)


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
