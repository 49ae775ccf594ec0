"""Append-only time-series store in a run directory (port of
``featurenet_tpu/obs/tsdb.py``).

The live layers (rolling windows, pool counters, batcher stats) die with
their process; the store is what outlives them. A writer (the fleet's
scraper; the alert mirror ``alerts.set_store``) appends samples under
``<run_dir>/tsdb/``, and the burn-rate evaluator, ``cli dash``, the
report's fleet timeline and an incident bundle's ``tsdb.json`` read them
back from the files alone.

Layout: one JSONL segment sequence per metric and label set, the series
named in the file name (``serving_ms;q=0.99;replica=0.000000.jsonl``).
Each line is one ``{"t": epoch_seconds, "v": value}`` sample, written as
one ``os.write`` on an ``O_APPEND`` descriptor, so concurrent writers
interleave whole lines and a crash tears at most the last one. Readers
skip a torn tail and lines they cannot parse, and merge a series'
segments in time order. The files are byte for byte the reference's for
the same appends, so either package reads the other's store.

Segments rotate at ``segment_bytes``; each rotation drops closed segments
older than ``max_age_s``, then the oldest until the directory fits
``max_bytes``. The first ``OSError`` puts the writer dark: every later
``append`` counts a drop and does nothing else.

Timestamps are wall-clock epoch seconds: samples of several processes
land on one axis that still means something when read days later.
Standard library only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

# The one nearest-rank percentile of the windows, the report and the store.
from featurenet_tpu_torch.obs.report import _pct

STORE_DIRNAME = "tsdb"

DEFAULT_SEGMENT_BYTES = 256 * 1024
DEFAULT_MAX_BYTES = 64 * 1024 * 1024
DEFAULT_MAX_AGE_S = 24 * 3600.0

_SEG_SUFFIX = ".jsonl"
_SEG_WIDTH = 6

# The file-name-safe characters of metric names and label keys and
# values; anything else becomes "_".
_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-="
)


def _sanitize(token: str) -> str:
    return "".join(c if c in _SAFE else "_" for c in str(token))


def series_key(metric: str, labels: Optional[dict] = None) -> str:
    """A series' identity and file stem: the metric, then the sorted
    ``k=v`` labels, ``;``-joined (dict order never splits a series)."""
    parts = [_sanitize(metric)]
    for k in sorted(labels or {}):
        parts.append(f"{_sanitize(k)}={_sanitize(labels[k])}")
    return ";".join(parts)


def parse_series_key(key: str) -> tuple[str, dict]:
    """The inverse of ``series_key`` (up to sanitizing): stem → (metric,
    labels)."""
    parts = key.split(";")
    labels = {}
    for p in parts[1:]:
        k, _, v = p.partition("=")
        labels[k] = v
    return parts[0], labels


def store_dir(run_dir: str) -> str:
    return os.path.join(run_dir, STORE_DIRNAME)


class TimeSeriesStore:
    """Writer and reader over one ``<run_dir>/tsdb`` directory. The reader
    half scans the directory on every call, so a store opened on a
    finished run, or on one another process appends to, needs no writer
    state."""

    def __init__(self, root: str, *,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 max_age_s: float = DEFAULT_MAX_AGE_S):
        self.root = os.path.abspath(root)
        self.segment_bytes = int(segment_bytes)
        self.max_bytes = int(max_bytes)
        self.max_age_s = float(max_age_s)
        self._lock = threading.Lock()
        # Per series: [fd, segment index, bytes in the segment].
        self._writers: dict[str, list] = {}
        self._dark = False
        self.appended = 0
        self.dropped = 0

    @classmethod
    def open(cls, run_dir: str, **kw) -> "TimeSeriesStore":
        """The store of one run directory (``<run_dir>/tsdb``)."""
        return cls(store_dir(run_dir), **kw)

    # -- write path ----------------------------------------------------------
    def append(self, metric: str, value, labels: Optional[dict] = None,
               t: Optional[float] = None) -> bool:
        """Append one sample; True when it landed. Every failure is
        absorbed: a dark store counts the drop and returns False."""
        if self._dark:
            with self._lock:
                self.dropped += 1
            return False
        if t is None:
            t = time.time()
        line = json.dumps(
            {"t": round(float(t), 3), "v": float(value)},
            separators=(",", ":"),
        ).encode("utf-8") + b"\n"
        key = series_key(metric, labels)
        try:
            with self._lock:
                st = self._writers.get(key)
                if st is None:
                    st = self._open_writer_locked(key)
                    self._writers[key] = st
                elif st[2] + len(line) > self.segment_bytes and st[2] > 0:
                    self._rotate_locked(key, st)
                os.write(st[0], line)  # one write, one whole line
                st[2] += len(line)
                self.appended += 1
            return True
        except OSError:
            # A full disk, a removed root, the fd limit: dark for good.
            self._go_dark()
            with self._lock:
                self.dropped += 1
            return False

    def close(self) -> None:
        with self._lock:
            for st in self._writers.values():
                try:
                    os.close(st[0])
                except OSError:
                    pass
            self._writers.clear()

    def _go_dark(self) -> None:
        self._dark = True
        self.close()

    def _open_writer_locked(self, key: str) -> list:
        os.makedirs(self.root, exist_ok=True)
        # Resume the highest segment, so a reopened store keeps one ordered
        # sequence per series.
        seg = 0
        for _, idx, _p in self._segments_of(key):
            seg = max(seg, idx)
        path = self._seg_path(key, seg)
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
        size = os.fstat(fd).st_size
        if size >= self.segment_bytes:
            os.close(fd)
            seg += 1
            path = self._seg_path(key, seg)
            fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
            size = os.fstat(fd).st_size
        # A segment ending mid-line holds a predecessor's torn tail:
        # terminate it, or the first new sample would fuse with it into
        # one line the reader skips.
        if size > 0 and os.pread(fd, 1, size - 1) != b"\n":
            size += os.write(fd, b"\n")
        return [fd, seg, size]

    def _rotate_locked(self, key: str, st: list) -> None:
        try:
            os.close(st[0])
        except OSError:
            pass
        st[1] += 1
        path = self._seg_path(key, st[1])
        st[0] = os.open(path, os.O_RDWR | os.O_CREAT | os.O_APPEND, 0o644)
        st[2] = 0
        self._prune_locked()

    def _prune_locked(self) -> None:
        """Drop closed segments by age, then the oldest to the byte budget.
        A segment open for writing is never dropped."""
        active = {
            self._seg_path(k, st[1]) for k, st in self._writers.items()
        }
        segs = []  # (mtime, size, path)
        for key in self._series_keys():
            for path, _idx, stat in self._segments_of(key):
                if path in active:
                    continue
                segs.append((stat.st_mtime, stat.st_size, path))
        segs.sort()
        now = time.time()
        total = sum(s[1] for s in segs)
        for mtime, size, path in segs:
            too_old = now - mtime > self.max_age_s
            if not too_old and total <= self.max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                pass
            total -= size

    # -- directory scan ------------------------------------------------------
    def _seg_path(self, key: str, seg: int) -> str:
        return os.path.join(
            self.root, f"{key}.{seg:0{_SEG_WIDTH}d}{_SEG_SUFFIX}"
        )

    def _series_keys(self) -> list[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        keys = set()
        for n in names:
            if not n.endswith(_SEG_SUFFIX):
                continue
            stem = n[: -len(_SEG_SUFFIX)]
            stem, _, seg = stem.rpartition(".")
            if stem and seg.isdigit():
                keys.add(stem)
        return sorted(keys)

    def _segments_of(self, key: str):
        """(path, index, stat) of each segment of a series, by index."""
        out = []
        prefix = key + "."
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for n in names:
            if not (n.startswith(prefix) and n.endswith(_SEG_SUFFIX)):
                continue
            seg = n[len(prefix): -len(_SEG_SUFFIX)]
            if not seg.isdigit():
                continue
            path = os.path.join(self.root, n)
            try:
                out.append((path, int(seg), os.stat(path)))
            except OSError:
                continue
        out.sort(key=lambda s: s[1])
        return out

    # -- read path -----------------------------------------------------------
    def series(self) -> list[tuple[str, dict]]:
        """Every (metric, labels) series on disk."""
        return [parse_series_key(k) for k in self._series_keys()]

    def _matching_keys(self, metric: str,
                       labels: Optional[dict]) -> list[str]:
        """The series of ``metric`` whose labels include the filter's:
        ``{"q": "0.99"}`` merges that quantile across every replica."""
        want = {str(k): str(v) for k, v in (labels or {}).items()}
        out = []
        for key in self._series_keys():
            m, lb = parse_series_key(key)
            if m != metric:
                continue
            if all(lb.get(k) == v for k, v in want.items()):
                out.append(key)
        return out

    def query(self, metric: str, labels: Optional[dict] = None,
              since_s: Optional[float] = None,
              now: Optional[float] = None) -> list[tuple[float, float]]:
        """The merged (t, value) samples of every matching series in time
        order, within the last ``since_s`` seconds before ``now``."""
        if now is None:
            now = time.time()
        cutoff = None if since_s is None else now - float(since_s)
        out: list[tuple[float, float]] = []
        for key in self._matching_keys(metric, labels):
            for path, _idx, _stat in self._segments_of(key):
                out.extend(self._read_segment(path, cutoff))
        out.sort(key=lambda s: s[0])
        return out

    @staticmethod
    def _read_segment(path: str, cutoff: Optional[float]):
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return []
        # The chunk after the last newline is a torn write (or b"" when the
        # file ends in one): drop it.
        lines = raw.split(b"\n")[:-1]
        out = []
        for ln in lines:
            if not ln:
                continue
            try:
                rec = json.loads(ln)
                t, v = float(rec["t"]), float(rec["v"])
            except (ValueError, KeyError, TypeError):
                continue  # a torn or foreign line
            if cutoff is not None and t < cutoff:
                continue
            out.append((t, v))
        return out

    def percentile(self, metric: str, q: float,
                   labels: Optional[dict] = None,
                   since_s: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """Nearest-rank percentile of the merged samples in the window
        (None when it is empty)."""
        vals = sorted(v for _, v in self.query(
            metric, labels, since_s=since_s, now=now
        ))
        return _pct(vals, q)

    def latest(self, metric: str, labels: Optional[dict] = None
               ) -> Optional[tuple[float, float]]:
        """The newest (t, value) across the matching series, or None."""
        samples = self.query(metric, labels)
        return samples[-1] if samples else None

    def stats(self) -> dict:
        return {
            "appended": self.appended,
            "dropped": self.dropped,
            "dark": self._dark,
            "series": len(self._series_keys()),
        }
