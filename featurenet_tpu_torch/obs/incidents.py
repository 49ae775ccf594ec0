"""Alert-triggered incident bundles (port of
``featurenet_tpu/obs/incidents.py``).

The layers below detect trouble (windows, threshold and burn-rate alerts,
gate regressions, replica losses); by the time someone reads the report,
the bad minute's windows are overwritten and its unsampled requests are
gone. An incident freezes them when an alert fires, into a bundle under
``<run_dir>/incidents/<id>/``:

- ``manifest.json``: the rule, value, severity and threshold, the open and
  close times and duration, the capture inventory (written atomically);
- ``tsdb.json``: every series of the run's store over a look-back window;
- ``windows.json``: the live window snapshots the alert judged;
- ``roster.json``: the membership document of a fleet or elastic run,
  verbatim (optional: a standalone service has none);
- ``events_tail.jsonl``: the tail of every event stream, each record
  tagged with its stream;
- ``stacks.folded``: seconds of folded, thread-named host stacks
  (``obs/stacksampler.py``).

While any incident is open, tracing keeps every request
(``tracing.set_force_all``), so the events tail holds the window's
complete timelines.

At most one incident is open per rule, and a closed rule waits out a
cooldown before it opens another: a flapping metric makes one bundle per
cooldown. ``gate_regression`` (from the supervisor) and a replica-loss
storm (``STORM_THRESHOLD`` losses within ``STORM_WINDOW_S``) open one-shot
incidents that capture and close themselves.

Telemetry is never load-bearing: the first ``OSError`` of a bundle write
puts the manager dark for the run (drops counted, one stderr line); the
bundle count is bounded, oldest first; the readers name a missing or torn
piece instead of raising. The manager subscribes through the event tap
(``events.set_tap``). Standard library only.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
from typing import Optional

from featurenet_tpu_torch.obs import events as _events
from featurenet_tpu_torch.obs import stacksampler as _stacksampler
from featurenet_tpu_torch.obs import tracing as _tracing
from featurenet_tpu_torch.obs import tsdb as _tsdb
from featurenet_tpu_torch.obs import windows as _windows

INCIDENTS_DIRNAME = "incidents"
MANIFEST_FILENAME = "manifest.json"

DEFAULT_COOLDOWN_S = 60.0
DEFAULT_LOOKBACK_S = 600.0
DEFAULT_MAX_BUNDLES = 16
DEFAULT_SAMPLE_S = 2.0

# A replica-loss storm: this many fleet_replica_loss events in the window.
STORM_THRESHOLD = 3
STORM_WINDOW_S = 60.0

# Records per stream in events_tail.jsonl.
EVENTS_TAIL_LINES = 400

# What a complete capture writes besides the manifest; roster.json is
# optional and its absence is no damage.
BUNDLE_FILES = ("tsdb.json", "windows.json", "events_tail.jsonl",
                "stacks.folded")


def incidents_dir(run_dir: str) -> str:
    return os.path.join(os.path.abspath(run_dir), INCIDENTS_DIRNAME)


class IncidentManager:
    """One process's incident plane over one run directory, armed by
    ``arm(run_dir)``. Its state is guarded by ``self._lock``: the tap
    calls ``on_event`` from whichever thread emitted."""

    def __init__(self, run_dir: str, *,
                 cooldown_s: float = DEFAULT_COOLDOWN_S,
                 lookback_s: float = DEFAULT_LOOKBACK_S,
                 max_bundles: int = DEFAULT_MAX_BUNDLES,
                 sample_s: float = DEFAULT_SAMPLE_S,
                 sample_hz: float = _stacksampler.DEFAULT_HZ):
        self.run_dir = os.path.abspath(run_dir)
        self.dir = incidents_dir(run_dir)
        self.cooldown_s = float(cooldown_s)
        self.lookback_s = float(lookback_s)
        self.max_bundles = int(max_bundles)
        self.sample_s = float(sample_s)
        self.sample_hz = float(sample_hz)
        self._lock = threading.Lock()
        self._open: dict[str, dict] = {}       # rule -> live manifest
        self._t0: dict[str, float] = {}        # rule -> perf_counter at open
        self._cooldown: dict[str, float] = {}  # rule -> monotonic at close
        self._loss_times: list[float] = []     # the storm window (monotonic)
        self._threads: list[threading.Thread] = []
        self._opened_total = 0
        self._dropped = 0
        self._dark = False
        self._disarmed = False

    # -- the event tap (on the emitting thread) ------------------------------
    def on_event(self, ev: str, record: dict) -> None:
        """Dispatch one event. Opening is bookkeeping and a thread start;
        the caller may hold the windows' lock."""
        if ev == "alert":
            rule = record.get("rule")
            if not isinstance(rule, str):
                return
            if record.get("state") == "fire":
                self._maybe_open(
                    rule, severity=str(record.get("severity", "warning")),
                    value=record.get("value"),
                    threshold=record.get("threshold"),
                )
            elif record.get("state") == "resolve":
                self._close(rule)
        elif ev == "supervisor" \
                and record.get("phase") == "gate_regression":
            failed = record.get("failed") or ()
            self._maybe_open(
                "gate_regression", severity="critical",
                value=float(len(failed)), threshold=0.0,
                one_shot=True, detail={"failed": list(failed)},
            )
        elif ev == "fleet_replica_loss":
            with self._lock:
                now = time.monotonic()
                self._loss_times.append(now)
                self._loss_times = [
                    t for t in self._loss_times
                    if now - t <= STORM_WINDOW_S
                ]
                storm = len(self._loss_times) >= STORM_THRESHOLD
                losses = len(self._loss_times)
            if storm:
                self._maybe_open(
                    "replica_loss_storm", severity="critical",
                    value=float(losses), threshold=float(STORM_THRESHOLD),
                    one_shot=True,
                )

    # -- open / close ---------------------------------------------------------
    def _maybe_open(self, rule: str, *, severity: str, value, threshold,
                    one_shot: bool = False,
                    detail: Optional[dict] = None) -> None:
        with self._lock:
            if self._disarmed or self._dark:
                return
            if rule in self._open:
                return  # one open incident per rule
            last = self._cooldown.get(rule)
            if last is not None and \
                    time.monotonic() - last < self.cooldown_s:
                return  # the cooldown damps a flapping rule
            import datetime

            t_open = time.time()
            man = {
                "id": f"inc-{int(t_open * 1000):013d}-{rule}",
                "rule": rule,
                "severity": severity,
                "value": value,
                "threshold": threshold,
                "state": "open",
                "opened_unix": round(t_open, 3),
                "opened_time": datetime.datetime.fromtimestamp(
                    t_open, datetime.timezone.utc
                ).isoformat(timespec="seconds"),
                "pid": os.getpid(),
                "one_shot": bool(one_shot),
            }
            if detail:
                man.update(detail)
            self._open[rule] = man
            self._t0[rule] = time.perf_counter()
            self._opened_total += 1
            if len(self._open) == 1:
                _tracing.set_force_all(True)  # keep every request
            self._threads = [t for t in self._threads if t.is_alive()]
            th = threading.Thread(
                target=self._capture, args=(man, one_shot),
                name="incident-capture", daemon=True,
            )
            self._threads.append(th)
            th.start()
        _events.emit("incident_open", id=man["id"], rule=rule,
                     severity=severity, value=value,
                     threshold=threshold)

    def _close(self, rule: str) -> None:
        with self._lock:
            man = self._open.pop(rule, None)
            if man is None:
                return
            t0 = self._t0.pop(rule, None)
            self._cooldown[rule] = time.monotonic()
            man["state"] = "closed"
            man["duration_s"] = (
                round(time.perf_counter() - t0, 3) if t0 is not None
                else 0.0
            )
            man["closed_unix"] = round(time.time(), 3)
            if not self._open:
                _tracing.set_force_all(False)
        self._write_manifest(man)
        _events.emit("incident_close", id=man["id"], rule=rule,
                     duration_s=man["duration_s"])

    # -- the capture thread ---------------------------------------------------
    def _capture(self, man: dict, one_shot: bool) -> None:
        """Write the bundle on its own thread, so the alert path never
        waits on the disk or the sampler."""
        bundle = os.path.join(self.dir, man["id"])
        try:
            os.makedirs(bundle, exist_ok=True)
            self._write_manifest(man)
            files = []
            self._write_atomic(bundle, "tsdb.json",
                               json.dumps(self._tsdb_slice(), indent=1))
            files.append("tsdb.json")
            self._write_atomic(bundle, "windows.json", json.dumps(
                {"windows": _windows.snapshot()}, indent=1
            ))
            files.append("windows.json")
            roster = self._read_roster()
            if roster is not None:
                self._write_atomic(bundle, "roster.json", roster)
                files.append("roster.json")
            self._write_atomic(bundle, "events_tail.jsonl",
                               self._events_tail())
            files.append("events_tail.jsonl")
            # The stacks last: the sampler spends sample_s of wall, and the
            # snapshots above belong as near the fire as they can be.
            profile = _stacksampler.sample_stacks(
                self.sample_s, hz=self.sample_hz
            )
            self._write_atomic(bundle, "stacks.folded",
                               _stacksampler.render_folded(profile))
            files.append("stacks.folded")
            with self._lock:
                man["files"] = files
                man["capture"] = {
                    "stack_samples": profile["samples"],
                    "stack_ticks": profile["ticks"],
                    "stack_duration_s": profile["duration_s"],
                    "stack_truncated": profile["truncated"],
                }
            self._write_manifest(man)
            _events.emit("incident_capture", id=man["id"], files=files)
            self._prune()
        except OSError as e:
            self._go_dark(e)
        finally:
            if one_shot:
                # No resolve will come: the capture is the incident.
                self._close(man["rule"])

    # -- bundle pieces --------------------------------------------------------
    def _tsdb_slice(self) -> dict:
        """Every series of the run's store over the look-back window,
        through a read-only handle of its own."""
        now = time.time()
        series = []
        store = _tsdb.TimeSeriesStore.open(self.run_dir)
        try:
            for metric, labels in store.series():
                samples = store.query(metric, labels,
                                      since_s=self.lookback_s, now=now)
                if samples:
                    series.append({
                        "metric": metric,
                        "labels": labels,
                        "samples": [[round(t, 3), v] for t, v in samples],
                    })
        finally:
            store.close()
        return {"lookback_s": self.lookback_s,
                "now_unix": round(now, 3), "series": series}

    def _read_roster(self) -> Optional[str]:
        """``membership.json`` verbatim, or None when the run has none."""
        path = os.path.join(self.run_dir, "membership.json")
        try:
            with open(path, encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            return None

    def _events_tail(self) -> str:
        """The last records of every event stream, each tagged with its
        stream; only whole, parseable lines of a live stream are kept."""
        out: list[str] = []
        try:
            names = sorted(
                n for n in os.listdir(self.run_dir)
                if n.startswith("events") and n.endswith(".jsonl")
            )
        except OSError:
            return ""
        for name in names:
            path = os.path.join(self.run_dir, name)
            try:
                with open(path, "rb") as fh:
                    fh.seek(0, os.SEEK_END)
                    size = fh.tell()
                    back = min(size, EVENTS_TAIL_LINES * 512)
                    fh.seek(size - back)
                    raw = fh.read().decode("utf-8", "replace")
            except OSError:
                continue
            lines = raw.splitlines()
            if back < size and lines:
                lines = lines[1:]  # may start mid-record
            for line in lines[-EVENTS_TAIL_LINES:]:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a live stream's torn tail
                rec["stream"] = name
                out.append(json.dumps(rec, default=str))
        return "\n".join(out) + ("\n" if out else "")

    # -- durability -----------------------------------------------------------
    def _write_manifest(self, man: dict) -> None:
        bundle = os.path.join(self.dir, man["id"])
        try:
            os.makedirs(bundle, exist_ok=True)
            with self._lock:
                # The capture thread and a close share the one manifest
                # dict: serialize and write under the lock.
                data = json.dumps(dict(man), indent=1, default=str)
                tmp = os.path.join(bundle, MANIFEST_FILENAME + ".tmp")
                with open(tmp, "w", encoding="utf-8") as fh:
                    fh.write(data)
                os.replace(tmp,
                           os.path.join(bundle, MANIFEST_FILENAME))
        except OSError as e:
            self._go_dark(e)

    def _write_atomic(self, bundle: str, name: str, text: str) -> None:
        tmp = os.path.join(bundle, name + ".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
        os.replace(tmp, os.path.join(bundle, name))

    def _prune(self) -> None:
        """Bound the bundle count, oldest first (ids sort by open time); an
        open incident's bundle stays."""
        try:
            names = sorted(
                n for n in os.listdir(self.dir)
                if os.path.isdir(os.path.join(self.dir, n))
            )
        except OSError:
            return
        with self._lock:
            keep = {m["id"] for m in self._open.values()}
        excess = len(names) - self.max_bundles
        for name in names:
            if excess <= 0:
                break
            if name in keep:
                continue
            shutil.rmtree(os.path.join(self.dir, name),
                          ignore_errors=True)
            excess -= 1

    def _go_dark(self, e: Exception) -> None:
        """The first failed bundle write: dark for the run, one stderr
        line, drops counted; serving never notices."""
        with self._lock:
            self._dropped += 1
            first = not self._dark
            self._dark = True
        if first:
            print(json.dumps({
                "incident_error": f"incident bundle write failed "
                f"({type(e).__name__}: {e}); incident capture for this "
                "process goes dark, serving continues",
                "dir": self.dir,
            }), file=sys.stderr)

    # -- introspection / lifecycle --------------------------------------------
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def open_ids(self) -> list[str]:
        with self._lock:
            return sorted(m["id"] for m in self._open.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "open": len(self._open),
                "opened_total": self._opened_total,
                "dropped": self._dropped,
                "dark": self._dark,
            }

    def disarm(self) -> None:
        """Close the open incidents (with their true durations), join the
        capture threads and drop force-all. The bundles stay."""
        with self._lock:
            if self._disarmed:
                return
            self._disarmed = True
            rules = list(self._open)
            threads = list(self._threads)
        for rule in rules:
            self._close(rule)
        for th in threads:
            th.join(timeout=10.0)
        _tracing.set_force_all(False)


# --- the process-wide manager -------------------------------------------------

_manager: Optional[IncidentManager] = None
_slot_lock = threading.Lock()


def arm(run_dir: str, **kw) -> IncidentManager:
    """Install the process-wide manager for ``run_dir`` and the event tap.
    Arming the same run again returns the live manager; another run
    swaps it."""
    global _manager
    old = None
    with _slot_lock:
        if (_manager is not None and not _manager._disarmed
                and _manager.run_dir == os.path.abspath(run_dir)):
            return _manager
        old = _manager
        _manager = IncidentManager(run_dir, **kw)
        _events.set_tap(_manager.on_event)
        mgr = _manager
    if old is not None:
        old.disarm()
    return mgr


def disarm(manager: Optional[IncidentManager] = None) -> None:
    """Disarm ``manager`` (default: the installed one), removing the tap
    when it is the installed one; a stale handle disarms only itself."""
    global _manager
    with _slot_lock:
        m = manager if manager is not None else _manager
        if m is not None and m is _manager:
            _events.set_tap(None)
            _manager = None
    if m is not None:
        m.disarm()


def manager() -> Optional[IncidentManager]:
    return _manager


def open_count() -> int:
    m = _manager
    return m.open_count() if m is not None else 0


def reset() -> None:
    """Drop all process-wide incident state (the tap, the manager, the
    force-all flag), as ``obs.close_run`` drops the run's."""
    disarm()
    _tracing.set_force_all(False)


# --- reading bundles (cli incident, the report, cli dash) ---------------------


def list_incidents(run_dir: str) -> list[dict]:
    """Every bundle under ``<run_dir>/incidents``, oldest first, from the
    manifests; a damaged manifest gives a ``damaged`` entry."""
    base = incidents_dir(run_dir)
    out: list[dict] = []
    try:
        names = sorted(n for n in os.listdir(base)
                       if os.path.isdir(os.path.join(base, n)))
    except OSError:
        return out
    for name in names:
        entry: dict = {"id": name}
        try:
            with open(os.path.join(base, name, MANIFEST_FILENAME),
                      encoding="utf-8") as fh:
                man = json.load(fh)
            for k in ("rule", "severity", "state", "value", "threshold",
                      "opened_time", "duration_s", "one_shot"):
                if k in man:
                    entry[k] = man[k]
        except (OSError, ValueError):
            entry["state"] = "damaged"
        out.append(entry)
    return out


def load_bundle(run_dir: str, incident_id: str) -> dict:
    """One bundle; each absent or unparseable piece is named in
    ``missing`` (with why) instead of raising."""
    bundle = os.path.join(incidents_dir(run_dir), incident_id)
    out: dict = {
        "id": incident_id, "dir": bundle,
        "manifest": None, "tsdb": None, "windows": None,
        "roster": None, "events_tail": [], "stacks": None,
        "missing": [],
    }
    if not os.path.isdir(bundle):
        out["missing"].append(f"{bundle} (no such bundle)")
        return out

    def _read(name: str) -> Optional[str]:
        try:
            with open(os.path.join(bundle, name),
                      encoding="utf-8") as fh:
                return fh.read()
        except OSError:
            out["missing"].append(f"{name} (absent)")
            return None

    raw = _read(MANIFEST_FILENAME)
    if raw is not None:
        try:
            out["manifest"] = json.loads(raw)
        except ValueError:
            out["missing"].append(
                f"{MANIFEST_FILENAME} (torn/unparseable JSON)"
            )
    for key, name in (("tsdb", "tsdb.json"), ("windows", "windows.json")):
        if not os.path.exists(os.path.join(bundle, name)):
            out["missing"].append(f"{name} (absent)")
            continue
        raw = _read(name)
        if raw is None:
            continue
        try:
            out[key] = json.loads(raw)
        except ValueError:
            out["missing"].append(f"{name} (torn/unparseable JSON)")
    roster_path = os.path.join(bundle, "roster.json")
    if os.path.exists(roster_path):
        raw = _read("roster.json")
        if raw is not None:
            try:
                out["roster"] = json.loads(raw)
            except ValueError:
                out["missing"].append("roster.json (torn/unparseable JSON)")
    tail_path = os.path.join(bundle, "events_tail.jsonl")
    if os.path.exists(tail_path):
        raw = _read("events_tail.jsonl")
        for line in (raw or "").splitlines():
            try:
                out["events_tail"].append(json.loads(line))
            except ValueError:
                continue
    else:
        out["missing"].append("events_tail.jsonl (absent)")
    stacks_path = os.path.join(bundle, "stacks.folded")
    if os.path.exists(stacks_path):
        raw = _read("stacks.folded")
        if raw is not None:
            out["stacks"] = _stacksampler.parse_folded(raw)
    else:
        out["missing"].append("stacks.folded (absent)")
    return out


def format_incident(bundle: dict) -> str:
    """The post-mortem of one loaded bundle: the trigger, the timeline, the
    store slice and windows, the roster, the events tail's census, the
    stacks per thread, and a ``missing:`` line naming what is damaged."""
    man = bundle.get("manifest") or {}
    lines = [
        f"incident {bundle['id']}",
        f"  rule: {man.get('rule', '?')} · severity "
        f"{man.get('severity', '?')} · state {man.get('state', '?')}",
    ]
    if man.get("value") is not None:
        lines.append(
            f"  trigger: value {man.get('value')} vs threshold "
            f"{man.get('threshold')}"
        )
    if man.get("opened_time"):
        lines.append(f"  opened: {man['opened_time']}")
    if man.get("duration_s") is not None:
        lines.append(f"  duration: {man['duration_s']}s")
    if man.get("one_shot"):
        lines.append("  one-shot capture (no paired resolve)")
    cap = man.get("capture") or {}
    tsdb = bundle.get("tsdb")
    if tsdb is not None:
        n_series = len(tsdb.get("series") or [])
        n_samples = sum(len(s.get("samples") or ())
                        for s in tsdb.get("series") or [])
        lines.append(
            f"  tsdb slice: {n_series} series, {n_samples} samples over "
            f"{tsdb.get('lookback_s', '?')}s lookback"
        )
    win = (bundle.get("windows") or {}).get("windows") or {}
    if win:
        tops = ", ".join(
            f"{m} p99={s.get('p99')}" for m, s in sorted(win.items())[:4]
        )
        lines.append(f"  windows at fire: {tops}")
    roster = bundle.get("roster")
    if roster is not None:
        hosts = roster.get("members") or roster.get("hosts") or []
        lines.append(f"  roster: {len(hosts)} member(s), generation "
                     f"{roster.get('generation', '?')}")
    tail = bundle.get("events_tail") or []
    if tail:
        kinds: dict[str, int] = {}
        for rec in tail:
            k = rec.get("ev", "?")
            kinds[k] = kinds.get(k, 0) + 1
        census = ", ".join(f"{k}:{n}" for k, n in
                           sorted(kinds.items(), key=lambda kv: -kv[1])[:8])
        lines.append(f"  events tail: {len(tail)} records ({census})")
    stacks = bundle.get("stacks")
    if stacks:
        totals = _stacksampler.thread_totals(stacks)
        top = ", ".join(
            f"{name}:{n}" for name, n in
            sorted(totals.items(), key=lambda kv: -kv[1])[:6]
        )
        extra = ""
        if cap.get("stack_truncated"):
            extra = " (truncated at the sampler deadline; partial)"
        lines.append(
            f"  stacks: {sum(stacks.values())} samples across "
            f"{len(totals)} thread(s){extra} — {top}"
        )
        for stack, count in sorted(
                stacks.items(), key=lambda kv: -kv[1])[:3]:
            lines.append(f"    {count:>5}  {stack}")
    missing = bundle.get("missing") or []
    if missing:
        lines.append("  missing: " + "; ".join(missing))
    return "\n".join(lines) + "\n"
