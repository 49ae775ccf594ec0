"""Checkpoints and resume for one process (port of
``featurenet_tpu/train/checkpoint.py``; the port's own file format).

A step is everything a run needs to resume: the model's ``state_dict``
(fp32 master parameters and the batch-norm ``mean``/``var`` buffers), the
optimizer's kind, moments ``mu`` and ``nu`` keyed by parameter name, its
``count`` (the schedule's step), ``TrainState.step`` (the dropout seed's
step), and the loss-scale state ``loss_scale`` and ``good_steps`` (inert
outside ``fp16_scaled``). The masters are fp32 under every precision
policy, so a step restores into a run of any ``train_precision``, with its
scale state: fp16_scaled → fp32 → fp16_scaled keeps the adapted scale. A
step saved before the scale state was kept has neither key; it restores
with the live state's scale state standing in (a fresh state's: 1.0 and
0, or ``LOSS_SCALE_INIT`` and 0 under ``fp16_scaled``), as the
reference's ``legacy_abstract`` does. Layout of a checkpoint directory:

- ``step_<n>.pt``: one step, a ``torch.save`` of plain tensors, ints and
  strings, written as ``step_<n>.pt.tmp`` and renamed once whole. It is
  read back with ``torch.load(..., weights_only=True)``, which unpickles no
  arbitrary object.
- ``checksum.<n>.json``: ``{"step_<n>.pt": sha256}``, written once the step
  is whole and verified before a byte of the step is restored.
- ``config.json``: the run's ``Config``, written once, atomically.

What the reference's manager guarantees, this one keeps:

- ``save`` stays off the step's critical path. It clones the state on the
  device on the caller's stream, records a CUDA event and makes a bounded
  enqueue, which blocks only when both snapshot slots are in flight. A
  writer thread waits on the event, copies the snapshot to pinned host
  memory on its own stream, writes, renames, writes the checksum and
  prunes to the newest ``keep`` steps. The writer reads only the clone,
  never the live tensors that the next step rewrites in place.
- A writer error is re-raised on the next ``save``, ``wait`` or
  ``close``, never swallowed; the first one is kept.
- ``restore`` with ``step=None`` walks back from the newest step to the
  newest one that verifies and loads, printing ``checkpoint_warning`` and
  ``checkpoint_fallback`` lines on stderr; ``cleanup=True`` (the resume
  caller only) deletes the newer steps that failed. An explicit ``step``
  raises instead. When every step fails, the error is chained to the first
  failure.
- Restores copy into the live tensors (``copy_``), so the optimizer, which
  holds the parameter tensors, keeps updating the model's parameters.

The fault sites (``faults.py``): ``checkpoint_corrupt@save=N`` is decided
at the Nth ``save`` of this manager and applied once the writer has
written that step: the file is truncated to half and its checksum sidecar
never written, the on-disk shape of a crash mid-write, which a resume
walks back past. ``save_slow@save=N`` sleeps ``SLOW_SLEEP_S`` in the
writer thread, never on the step's thread. ``checkpoint_restore_error@
restore=N`` fails the Nth restore attempt (counted per candidate step), so
the walk-back takes the next one.

``on_written(step)``, when given, is called from the writer thread after
each step it writes (the Trainer's heartbeat: a completed save is
confirmed progress).

Not ported: the multi-process lockstep save.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import sys
import threading
import time
from typing import Callable, Optional

import torch

from featurenet_tpu_torch import faults
from featurenet_tpu_torch.config import Config, config_from_dict, config_to_dict

CONFIG_FILENAME = "config.json"

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")
# The tensor groups of a step, and its loose tensors.
_GROUPS = ("model", "mu", "nu")
_SCALE_KEYS = ("loss_scale", "good_steps")


def load_run_config(directory: str) -> Optional[Config]:
    """The ``Config`` persisted with a run, or ``None`` when the directory
    has no ``config.json``."""
    path = os.path.join(os.path.abspath(directory), CONFIG_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return config_from_dict(json.load(fh))


class ChecksumMismatch(RuntimeError):
    """A step's bytes no longer match the checksum sidecar written when it
    was saved. Raised before the step is read, so a resume walks back past
    it as past a torn step; an explicitly requested step raises it."""


def step_filename(step: int) -> str:
    return f"step_{int(step)}.pt"


def checksum_path(root: str, step: int) -> str:
    return os.path.join(root, f"checksum.{int(step)}.json")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_file(payload: dict, path: str) -> None:
    """``payload`` to ``path`` via a temporary name, renamed once whole
    and flushed to the disk."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _truncate(path: str) -> None:
    """The injected ``checkpoint_corrupt``: cut a written step file to half
    its size."""
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)


def _snapshot(state) -> dict:
    """A copy of ``state`` in the checkpoint's layout, cloned on the
    tensors' device (on the caller's stream, so it is ordered before the
    next step's in-place updates)."""
    model = state.model
    opt = state.optimizer
    names = [n for n, _ in model.named_parameters()]
    if [id(p) for _, p in model.named_parameters()] != [id(p) for p in opt.params]:
        raise ValueError("the optimizer's parameters are not the model's, "
                         "in order; cannot key its moments by name")
    return {
        "step": int(state.step),
        "optimizer": opt.kind,
        # A device tensor until the writer has it on the host: reading it
        # here would wait for the step.
        "count": opt.count.detach().clone(),
        "model": {k: v.detach().clone() for k, v in model.state_dict().items()},
        "mu": {n: t.detach().clone() for n, t in zip(names, opt.mu)},
        "nu": {n: t.detach().clone() for n, t in zip(names, opt.nu)},
        **{k: getattr(state, k).detach().clone() for k in _SCALE_KEYS},
    }


def _check_tensors(what: str, got: dict, live: dict) -> None:
    if set(got) != set(live):
        raise KeyError(f"{what}: checkpoint has {sorted(set(got) ^ set(live))} "
                       "where the live state differs")
    for k, v in live.items():
        if tuple(got[k].shape) != tuple(v.shape):
            raise ValueError(f"{what}.{k}: checkpoint {tuple(got[k].shape)}, "
                             f"live {tuple(v.shape)}")


@torch.no_grad()
def _apply(state, payload: dict, optimizer: bool) -> None:
    """Copy ``payload`` into the live tensors of ``state`` (model, and with
    ``optimizer`` the moments, count and step). Everything is checked
    before the first copy, so a refused payload leaves ``state`` as it
    was."""
    live = state.model.state_dict()
    _check_tensors("model", payload["model"], live)
    if optimizer:
        opt = state.optimizer
        if payload["optimizer"] != opt.kind:
            raise ValueError(f"checkpoint optimizer {payload['optimizer']!r}, "
                             f"live {opt.kind!r}")
        names = [n for n, _ in state.model.named_parameters()]
        moments = [("mu", opt.mu), ("nu", opt.nu)]
        for key, tensors in moments:
            _check_tensors(key, payload[key], dict(zip(names, tensors)))
    for k, v in live.items():
        v.copy_(payload["model"][k])
    if optimizer:
        for key, tensors in moments:
            for n, t in zip(names, tensors):
                t.copy_(payload[key][n])
        opt.count = torch.tensor(int(payload["count"]), dtype=torch.int32,
                                 device=opt.count.device)
        state.step = int(payload["step"])
        for k in _SCALE_KEYS:
            if k in payload:
                getattr(state, k).copy_(payload[k])


class CheckpointManager:
    """Two-slot asynchronous saves and verified restores in ``directory``
    (see the module docstring).

    ``timing`` keeps the writer's seconds (device-to-host copy, write,
    checksum, pruning) over its ``writes`` and the bytes of the last step
    written; ``restored_step`` is the step the last restore took. The
    directory is created by the first ``save``, so a
    manager that only restores leaves the file system as it was.
    """

    # Snapshots in flight: the one being written and one queued behind
    # it. The writer holds its slot for the whole write, so the queue's
    # capacity is one less.
    SNAPSHOT_SLOTS = 2

    def __init__(self, directory: str, keep: int = 3,
                 config: Optional[Config] = None,
                 on_written: Optional[Callable[[int], None]] = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self._dir = os.path.abspath(directory)
        self._keep = int(keep)
        self._config = config
        self._on_written = on_written
        # The fault sites' counters: saves and restore attempts so far.
        self._saves = 0
        self._restores = 0
        self._queue: queue.Queue = queue.Queue(maxsize=self.SNAPSHOT_SLOTS - 1)
        self._writer: Optional[threading.Thread] = None
        self._writer_error: Optional[BaseException] = None
        self._stream = None
        self.restored_step: Optional[int] = None
        self.timing = {"writes": 0, "write_s": 0.0, "bytes": 0}

    # --- steps on disk --------------------------------------------------

    def all_steps(self) -> list[int]:
        """The complete steps in the directory, oldest first."""
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        steps = []
        for name in names:
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, step_filename(step))

    def _delete(self, step: int) -> None:
        for path in (self._path(step), checksum_path(self._dir, step)):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def _verify(self, step: int) -> None:
        """Raise ``ChecksumMismatch`` when the step's bytes disagree with its
        sidecar. A step without one (the process died between the rename
        and the sidecar) passes: the rename already made it whole."""
        try:
            with open(checksum_path(self._dir, step)) as fh:
                expected = json.load(fh)
        except FileNotFoundError:
            return
        name = step_filename(step)
        actual = {name: _sha256(self._path(step))}
        if actual != expected:
            raise ChecksumMismatch(
                f"checkpoint step {step} fails content verification: "
                f"{name} differs from its save-time checksum"
            )

    # --- saving ---------------------------------------------------------

    def _check_writer(self) -> None:
        err, self._writer_error = self._writer_error, None
        if err is not None:
            raise RuntimeError("background checkpoint write failed") from err

    def _write_config(self) -> None:
        if self._config is None:
            return
        path = os.path.join(self._dir, CONFIG_FILENAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(config_to_dict(self._config), fh, indent=1, default=str)
        os.replace(tmp, path)
        self._config = None

    def save(self, state) -> None:
        """Snapshot ``state`` on its device and hand it to the writer."""
        self._check_writer()
        os.makedirs(self._dir, exist_ok=True)
        self._write_config()
        snap = _snapshot(state)
        event = None
        first = next(iter(snap["model"].values()))
        if first.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(first.device))
        if self._writer is None:
            self._writer = threading.Thread(target=self._write_loop,
                                            name="ckpt-writer", daemon=True)
            self._writer.start()
        self._saves += 1
        # Decided here, in save order; applied once the step is written.
        corrupt = faults.maybe_fail("checkpoint_corrupt", save=self._saves)
        self._queue.put((snap, event, self._saves, corrupt))

    def _to_host(self, snap: dict, event) -> dict:
        """The snapshot on the host. On the card: wait for the clone's
        event on the writer's own stream, copy into pinned memory there,
        and wait for that stream only."""
        if event is None:
            return snap
        if self._stream is None:
            self._stream = torch.cuda.Stream(
                next(iter(snap["model"].values())).device)
        out = dict(snap)

        def pinned(v):
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            return host

        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            for key in _GROUPS:
                out[key] = {k: pinned(v) for k, v in snap[key].items()}
            for key in _SCALE_KEYS + ("count",):
                out[key] = pinned(snap[key])
        self._stream.synchronize()
        return out

    def _write_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            snap, event, save_n, corrupt = item
            try:
                t0 = time.perf_counter()
                if faults.maybe_fail("save_slow", save=save_n):
                    time.sleep(faults.SLOW_SLEEP_S)  # a dragging write
                host = self._to_host(snap, event)
                del snap, item  # free the device copy before the slow write
                host["count"] = int(host["count"])  # the file keeps an int
                step = host["step"]
                path = self._path(step)
                _write_file(host, path)
                if corrupt:
                    _truncate(path)
                else:
                    sidecar = checksum_path(self._dir, step)
                    with open(sidecar + ".tmp", "w") as fh:
                        json.dump({step_filename(step): _sha256(path)}, fh)
                    os.replace(sidecar + ".tmp", sidecar)
                for old in self.all_steps()[:-self._keep]:
                    self._delete(old)
                self.timing["writes"] += 1
                self.timing["write_s"] += time.perf_counter() - t0
                self.timing["bytes"] = os.path.getsize(path)
                if self._on_written is not None:
                    self._on_written(step)
            except Exception as e:  # re-raised by _check_writer
                if self._writer_error is None:
                    self._writer_error = e
            finally:
                self._queue.task_done()

    def wait(self) -> None:
        """Every queued step written; re-raises a writer error."""
        if self._writer is not None:
            self._queue.join()
        self._check_writer()

    def close(self) -> None:
        """``wait``, then stop the writer thread."""
        if self._writer is not None:
            self._queue.join()
            self._queue.put(None)
            self._writer.join(timeout=60.0)
            self._writer = None
        self._check_writer()

    # --- restoring ------------------------------------------------------

    def _load(self, step: Optional[int], cleanup: bool,
              apply: Callable[[dict], None]) -> int:
        if self._writer is not None:
            self._queue.join()
        self._check_writer()
        if step is not None:
            candidates = [int(step)]
        else:
            candidates = sorted(self.all_steps(), reverse=True)
            if not candidates:
                raise FileNotFoundError(f"no checkpoint to restore in {self._dir}")
        first_error: Optional[BaseException] = None
        for s in candidates:
            self._restores += 1
            try:
                if faults.maybe_fail("checkpoint_restore_error",
                                     restore=self._restores):
                    raise faults.InjectedFault(
                        f"checkpoint_restore_error at step {s}")
                self._verify(s)
                payload = torch.load(self._path(s), map_location="cpu",
                                     weights_only=True)
                apply(payload)
            except Exception as e:
                if step is not None:
                    raise
                first_error = first_error or e
                print(json.dumps({
                    "checkpoint_warning": f"restore of step {s} failed "
                    f"({type(e).__name__}: {e}); trying the previous "
                    "retained step",
                }), file=sys.stderr, flush=True)
                continue
            if s != candidates[0]:
                if cleanup:
                    for bad in candidates[:candidates.index(s)]:
                        self._delete(bad)
                print(json.dumps({"checkpoint_fallback": {
                    "from_step": candidates[0], "to_step": s}}),
                    file=sys.stderr, flush=True)
            self.restored_step = s
            return s
        raise RuntimeError(
            f"every retained checkpoint failed to restore (steps {candidates})"
        ) from first_error

    def restore(self, state, step: Optional[int] = None,
                cleanup: bool = False):
        """Restore ``state`` (model, optimizer moments and count, step,
        loss-scale state) in place from ``step``, or from the newest step that verifies; returns
        ``state``. ``cleanup`` also deletes the newer steps that failed:
        only the caller that owns the directory and re-saves those steps
        (``Trainer.resume_if_available``) passes it."""
        self._load(step, cleanup, lambda p: _apply(state, p, optimizer=True))
        return state

    def restore_init(self, state, step: Optional[int] = None):
        """Warm start: the model's parameters and batch-norm statistics
        only; ``state``'s step and optimizer are left as they are (only
        ``state.model`` is read). Never deletes a step."""
        self._load(step, False, lambda p: _apply(state, p, optimizer=False))
        return state

    def verify(self, step: Optional[int] = None) -> Optional[int]:
        """Verify one step (default: the newest) against its checksum
        without restoring it; returns the step, or ``None`` when there is
        none. Raises ``ChecksumMismatch``."""
        s = self.latest_step() if step is None else int(step)
        if s is None:
            return None
        self._verify(s)
        return s
