"""The heartbeat and its stall state machine (port of
``featurenet_tpu/train/heartbeat.py``; stdlib only).

The Trainer touches a file at every confirmed point of device progress
(``touch_heartbeat``); the supervisor watches its mtime through a
``HeartbeatMonitor``:

- ``reset()`` touches the file and records its mtime as the baseline:
  only a strictly newer mtime proves the watched child itself beat, so the
  cold-start grace window (kernel build, data upload, graph capture)
  governs until the first beat.
- ``poll()`` returns this instant's verdict: ``"ok"``, or ``"stall"`` when
  the child never beat within ``grace_s``, or beat and then went silent
  past ``stall_timeout_s``. Before a stale-age verdict the mtime is read
  again: a beat can land between the sample and the verdict, and a
  SIGKILL on a live child costs a whole restart for nothing.
- A deleted heartbeat file (an external /tmp cleaner) is recreated with
  the baseline reset rather than raised: a dead watcher orphans the child
  it guards.
- ``recheck()`` is the last sweep after the child exits: the last beat may
  have landed inside the last poll window, and a crash seconds after real
  progress must not be read as a startup failure.
"""

from __future__ import annotations

import os
import time


def touch_heartbeat(path: str) -> None:
    """Create or touch the liveness file (the trainer to beat, a watcher to
    reset the baseline before each spawn)."""
    with open(path, "a"):
        os.utime(path, None)


class HeartbeatMonitor:
    """One watched heartbeat file's liveness state.

    ``beaten`` is sticky: once the child has proven liveness, a later
    quiet spell is judged against ``stall_timeout_s``, never against the
    startup grace again. ``age_s`` holds the heartbeat age observed at
    the latest ``poll()``, the number a stall verdict logs.
    """

    def __init__(self, path: str, stall_timeout_s: float, grace_s: float):
        self.path = path
        self.stall_timeout_s = stall_timeout_s
        self.grace_s = grace_s
        self.beaten = False
        self.age_s = 0.0
        self._base = 0.0
        self._started = 0.0

    def reset(self) -> None:
        """A fresh baseline for a new spawn: a stale file from the previous
        child must neither trigger nor mask a stall verdict for this one."""
        touch_heartbeat(self.path)
        self._base = os.path.getmtime(self.path)
        self._started = time.monotonic()
        self.beaten = False
        self.age_s = 0.0

    def _mtime(self) -> float:
        try:
            return os.path.getmtime(self.path)
        except OSError:
            # Deleted externally: recreate it and restart the baseline, so
            # first-beat detection stays honest.
            touch_heartbeat(self.path)
            self._base = os.path.getmtime(self.path)
            return self._base

    def poll(self) -> str:
        """One poll's verdict: ``"ok"`` or ``"stall"``."""
        mtime = self._mtime()
        if mtime > self._base:
            self.beaten = True
        age = time.time() - mtime  # mtimes are on the wall clock
        if not self.beaten:
            if time.monotonic() - self._started > self.grace_s:
                self.age_s = age
                return "stall"  # never came up at all
        elif age > self.stall_timeout_s:
            # Read again just before the verdict (see the module docstring).
            try:
                age = time.time() - os.path.getmtime(self.path)
            except OSError:
                pass
            if age > self.stall_timeout_s:
                self.age_s = age
                return "stall"
        self.age_s = age
        return "ok"

    def recheck(self) -> bool:
        """The last beat sweep after the child exited: whether the child
        ever beat (a startup failure or a run failure)."""
        try:
            if os.path.getmtime(self.path) > self._base:
                self.beaten = True
        except OSError:
            pass
        return self.beaten
