"""Flight recorder: a bounded, sampled capture ring of served requests
(port of ``featurenet_tpu/serve/recorder.py``; numpy and the standard
library, no torch).

Tracing keeps timelines; the recorder keeps the requests themselves: a
JSONL segment ring under ``<run_dir>/capture/``, one served request a line:
the voxels bit-packed and base64-encoded (a 64³ occupancy grid is 32 KiB
of bits, ~44 KB of JSON, against 1 MiB of float32), its trace id, the
prediction, the confidence, and why it was kept. ``cli replay`` re-scores
the ring against a candidate checkpoint, precision or conv backend.

The capture policy is tail-biased like the tracing sampler: rejected
requests, forward errors, predictions under ``confidence_floor`` and SLO
breaches are always kept; healthy traffic is sampled by a hash of the
trace id (``obs.tracing.sampled``), so processes agree on what to keep
without talking. Weights that predict near-uniform probabilities (seeded,
or briefly trained) fall under the default floor on almost every request,
so almost every request is kept.

Durability is the event sink's: an O_APPEND descriptor and one
``os.write`` per complete line (a crash tears at most the last line, which
readers skip); segments rotate at ``segment_bytes`` and the oldest closed
ones are deleted past ``max_bytes``. The first ``OSError`` turns the
recorder dark: every later capture is a counter bump, never a failed
request.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from typing import Optional

import numpy as np

from featurenet_tpu_torch import obs
from featurenet_tpu_torch.obs import tracing as _tracing

CAPTURE_DIRNAME = "capture"

DEFAULT_SAMPLE = 0.05
DEFAULT_CONFIDENCE_FLOOR = 0.35
DEFAULT_SEGMENT_BYTES = 1024 * 1024
DEFAULT_MAX_BYTES = 16 * 1024 * 1024

_SEG_PREFIX = "capture."
_SEG_SUFFIX = ".jsonl"
_SEG_WIDTH = 6


def capture_dir(run_dir: str) -> str:
    return os.path.join(run_dir, CAPTURE_DIRNAME)


def pack_grid(grid: np.ndarray) -> dict:
    """Occupancy grid → JSON-safe record: threshold to bits, pack, and
    base64. Lossless for 0/1 grids (the serving wire contract)."""
    g = np.asarray(grid)
    bits = np.packbits((g > 0.5).ravel())
    return {
        "shape": [int(s) for s in g.shape],
        "bits": base64.b64encode(bits.tobytes()).decode("ascii"),
    }


def unpack_grid(rec: dict) -> np.ndarray:
    """Inverse of ``pack_grid``: record → float32 occupancy grid."""
    shape = tuple(int(s) for s in rec["shape"])
    n = 1
    for s in shape:
        n *= s
    raw = np.frombuffer(base64.b64decode(rec["bits"]), np.uint8)
    return np.unpackbits(raw)[:n].reshape(shape).astype(np.float32)


def read_captures(path: str) -> list[dict]:
    """Every parseable capture record in a ring directory, segment order
    then line order. Torn tails and foreign lines are skipped, never
    raised, the event loader's reader contract."""
    try:
        names = os.listdir(path)
    except OSError:
        return []
    segs = []
    for n in names:
        if not (n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)):
            continue
        idx = n[len(_SEG_PREFIX): -len(_SEG_SUFFIX)]
        if idx.isdigit():
            segs.append((int(idx), os.path.join(path, n)))
    segs.sort()
    out = []
    for _idx, seg_path in segs:
        try:
            with open(seg_path, "rb") as fh:
                raw = fh.read()
        except OSError:
            continue
        lines = raw.split(b"\n")[:-1]  # drop the torn tail, if any
        for ln in lines:
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if isinstance(rec, dict) and "voxels" in rec:
                out.append(rec)
    return out


class FlightRecorder:
    """Writer half of the capture ring (one per serving process).

    ``maybe_capture`` is called once per answered request from the
    batcher's result hook (and once per rejection from the admission
    path — any thread; the lock serializes writers). It decides
    keep-or-drop (forced reasons first, then the deterministic sample)
    and appends one self-contained JSONL record. A ``capture`` event
    rides the run log per kept request so the report can count what the
    ring holds without reading it.
    """

    def __init__(self, root: str, *,
                 sample: float = DEFAULT_SAMPLE,
                 confidence_floor: float = DEFAULT_CONFIDENCE_FLOOR,
                 slo_ms: Optional[float] = None,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_bytes: int = DEFAULT_MAX_BYTES):
        if not (0.0 <= sample <= 1.0):
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        self.root = os.path.abspath(root)
        self.sample = float(sample)
        self.confidence_floor = float(confidence_floor)
        self.slo_ms = slo_ms
        self.segment_bytes = int(segment_bytes)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # Writer state: fd, segment index, bytes in the open segment.
        self._fd: Optional[int] = None
        self._seg = 0
        self._seg_bytes = 0
        self._dark = False
        self.captured = 0
        self.skipped = 0
        self.dropped = 0

    def reason_for(self, trace_id: Optional[str],
                   confidence: Optional[float],
                   total_ms: Optional[float],
                   outcome: str = "ok") -> Optional[str]:
        """The capture verdict: a forced reason, ``"sampled"``, or None
        (drop). Forced reasons win over sampling so the tail is always
        present whatever the rate."""
        if outcome == "rejected":
            return "rejected"
        if outcome == "error":
            return "error"
        if confidence is not None and confidence < self.confidence_floor:
            return "low_confidence"
        if self.slo_ms is not None and total_ms is not None \
                and total_ms > self.slo_ms:
            return "slo_breach"
        if trace_id and _tracing.sampled(trace_id, self.sample):
            return "sampled"
        return None

    def maybe_capture(self, voxels: np.ndarray, trace_id: Optional[str],
                      *, label: Optional[int] = None,
                      confidence: Optional[float] = None,
                      total_ms: Optional[float] = None,
                      outcome: str = "ok") -> bool:
        """Apply the capture policy to one request; True when a record
        landed in the ring."""
        reason = self.reason_for(trace_id, confidence, total_ms, outcome)
        if reason is None:
            with self._lock:
                self.skipped += 1
            return False
        rec: dict = {
            "t": round(time.time(), 3),
            "trace": trace_id,
            "reason": reason,
            "voxels": pack_grid(voxels),
        }
        if label is not None:
            rec["label"] = int(label)
        if confidence is not None:
            rec["confidence"] = round(float(confidence), 6)
        if total_ms is not None:
            rec["total_ms"] = round(float(total_ms), 3)
        line = json.dumps(rec, separators=(",", ":")).encode("utf-8") + b"\n"
        with self._lock:
            if self._dark:
                self.dropped += 1
                return False
            try:
                if self._fd is None:
                    self._open_writer_locked()
                elif self._seg_bytes + len(line) > self.segment_bytes \
                        and self._seg_bytes > 0:
                    self._rotate_locked()
                os.write(self._fd, line)
                self._seg_bytes += len(line)
                self.captured += 1
            except OSError:
                # Disk full / unlinked root: go dark for good — capture
                # must never take down the serving path it observes.
                self._go_dark_locked()
                self.dropped += 1
                return False
        # Emit outside the lock (the sink has its own): one event per
        # kept request, so the report counts the ring without reading it.
        obs.emit("capture", trace=trace_id, reason=reason)
        return True

    def stats(self) -> dict:
        with self._lock:
            return {
                "captured": self.captured,
                "skipped": self.skipped,
                "dropped": self.dropped,
                "dark": self._dark,
                "dir": self.root,
            }

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None

    # -- internals (lock held) ------------------------------------------------
    def _go_dark_locked(self) -> None:
        self._dark = True
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    def _seg_path(self, seg: int) -> str:
        return os.path.join(
            self.root, f"{_SEG_PREFIX[:-1]}.{seg:0{_SEG_WIDTH}d}{_SEG_SUFFIX}"
        )

    def _segments_locked(self) -> list[tuple[int, str, int]]:
        """(index, path, size) per existing segment, index order."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            if not (n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX)):
                continue
            idx = n[len(_SEG_PREFIX): -len(_SEG_SUFFIX)]
            if not idx.isdigit():
                continue
            path = os.path.join(self.root, n)
            try:
                out.append((int(idx), path, os.stat(path).st_size))
            except OSError:
                continue
        out.sort()
        return out

    def _open_writer_locked(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        # Resume the highest existing segment (a respawned replica keeps
        # one ordered ring), rolling over if it is already full.
        seg = max((s[0] for s in self._segments_locked()), default=0)
        path = self._seg_path(seg)
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
        size = os.fstat(fd).st_size
        if size >= self.segment_bytes:
            os.close(fd)
            seg += 1
            path = self._seg_path(seg)
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
            size = os.fstat(fd).st_size
        # Terminate a predecessor's torn tail before appending, so the
        # first new record doesn't fuse with the tear into one
        # unparsable line.
        if size > 0 and os.pread(fd, 1, size - 1) != b"\n":
            size += os.write(fd, b"\n")
        self._fd = fd
        self._seg = seg
        self._seg_bytes = size

    def _rotate_locked(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass
        self._seg += 1
        self._fd = os.open(
            self._seg_path(self._seg),
            os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644,
        )
        self._seg_bytes = 0
        # Prune closed segments oldest-first to the byte budget; the
        # open segment is never deleted.
        segs = [s for s in self._segments_locked() if s[0] != self._seg]
        total = sum(s[2] for s in segs)
        for _idx, path, size in segs:
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                pass
            total -= size
