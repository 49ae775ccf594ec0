"""The fleet's metrics scraper (port of ``featurenet_tpu/fleet/scraper.py``;
stdlib only).

A daemon thread of the ``cli fleet`` process: on a jittered interval it
fetches every replica's ``GET /metrics`` and the router's own over the
fleet's connection pool, parses the exposition text and appends each
sample to the run directory's store (``obs/tsdb.py``), labelled with the
target (``replica``) and the target's ``model_version`` from its
``build_info`` (``version``).

- **Never load-bearing**: a failed scrape bumps the target's count in the
  ``scrape_failures_total`` series; nothing raises into serving.
- **Closed registry**: only series whose base name is in
  ``serve/metrics.py``'s ``METRIC_NAMES`` are written.
- **Jittered cadence**: each round sleeps ``interval_s`` ± ``jitter_frac``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from featurenet_tpu_torch.obs.dash import ROUTER_TARGET  # noqa: F401
from featurenet_tpu_torch.serve.metrics import METRIC_NAMES, _PREFIX

# The scraper's own series (registered in METRIC_NAMES).
SCRAPER_SERIES = ("scrape_failures_total", "scrape_duration_ms")

DEFAULT_INTERVAL_S = 1.0
DEFAULT_JITTER_FRAC = 0.2
DEFAULT_TIMEOUT_S = 2.0


def parse_exposition(text: str) -> list[tuple[str, dict, float]]:
    """Prometheus text exposition 0.0.4 → ``(name, labels, value)``
    triples. Comments, ``# HELP``/``# TYPE`` and malformed lines are
    skipped (a half-written response must not stop a scrape)."""
    out: list[tuple[str, dict, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "{" in line:
            name, _, rest = line.partition("{")
            body, _, tail = rest.partition("}")
            labels = {}
            ok = True
            for pair in _split_label_pairs(body):
                k, eq, v = pair.partition("=")
                if not eq or len(v) < 2 or v[0] != '"' or v[-1] != '"':
                    ok = False
                    break
                labels[k.strip()] = _unescape(v[1:-1])
            if not ok:
                continue
            value_str = tail.strip()
        else:
            name, _, value_str = line.partition(" ")
            labels = {}
        name = name.strip()
        parts = value_str.split()
        if not name or not parts:
            continue
        try:
            value = float(parts[0])  # parts[1], if any, is a timestamp
        except ValueError:
            continue
        out.append((name, labels, value))
    return out


def _split_label_pairs(body: str) -> list[str]:
    """Split ``k="v",k2="v2"`` on the commas outside quotes."""
    pairs, cur, in_q, esc = [], [], False, False
    for ch in body:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\" and in_q:
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            pairs.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        pairs.append("".join(cur))
    return [p for p in (p.strip() for p in pairs) if p]


def _unescape(v: str) -> str:
    """One left-to-right pass over the escapes ``\\\\``, ``\\"``, ``\\n``
    (an escaped backslash before an ``n`` stays a backslash and an n)."""
    out = []
    i = 0
    while i < len(v):
        ch = v[i]
        if ch == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt in ("\\", '"'):
                out.append(nxt)
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(ch)
        i += 1
    return "".join(out)


class MetricsScraper:
    """The collection thread. ``targets()`` returns ``{label: port}``: the
    live replicas' ports by slot and the router's own under
    ``ROUTER_TARGET``; it is read again every round, so a lost or rejoined
    replica leaves or enters collection by itself."""

    def __init__(self, store, pool, targets: Callable[[], dict], *,
                 host: str = "127.0.0.1",
                 interval_s: float = DEFAULT_INTERVAL_S,
                 jitter_frac: float = DEFAULT_JITTER_FRAC,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 registry: frozenset = METRIC_NAMES):
        self.store = store
        self.pool = pool
        self.targets = targets
        self.host = host
        self.interval_s = float(interval_s)
        self.jitter_frac = float(jitter_frac)
        self.timeout_s = float(timeout_s)
        self.registry = registry
        self.rounds = 0
        self.samples = 0
        self.skipped = 0  # unregistered series
        self.failures: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._paused = False

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-scraper", daemon=True)
        self._thread.start()

    def stop(self, final_round: bool = True) -> None:
        """Stop the loop, then (by default) one last round so the store's
        tail holds the fleet's final state."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.timeout_s + self.interval_s * 2)
            self._thread = None
        if final_round:
            self.scrape_once()

    def pause(self, on: bool = True) -> None:
        """Suspend collection without stopping the thread."""
        self._paused = on

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self._paused:
                self.scrape_once()
            lo = self.interval_s * (1.0 - self.jitter_frac)
            hi = self.interval_s * (1.0 + self.jitter_frac)
            self._stop.wait(random.uniform(lo, hi))

    def scrape_once(self) -> int:
        """Scrape every current target once; returns the samples appended."""
        try:
            targets = dict(self.targets())
        except Exception:
            targets = {}
        appended = 0
        for target, port in sorted(targets.items()):
            appended += self._scrape_target(str(target), port)
        self.rounds += 1
        return appended

    def _scrape_target(self, target: str, port: int) -> int:
        t0 = time.perf_counter()
        now = time.time()
        try:
            status, body = self.pool.get(self.host, int(port), "/metrics",
                                         timeout_s=self.timeout_s)
            if status != 200:
                raise OSError(f"/metrics -> {status}")
            text = body.decode("utf-8", "replace")
        except Exception:
            n = self.failures.get(target, 0) + 1
            self.failures[target] = n
            self.store.append("scrape_failures_total", n,
                              {"replica": target}, t=now)
            return 0
        samples = parse_exposition(text)
        # The target's model_version labels every series of this round (a
        # rolling swap shows per replica); the router's "n/a" is none.
        version = None
        for name, labels, _value in samples:
            base = name[len(_PREFIX):] if name.startswith(_PREFIX) else name
            if base == "build_info":
                v = labels.get("model_version")
                if v and v != "n/a":
                    version = v
                break
        appended = 0
        for name, labels, value in samples:
            base = name[len(_PREFIX):] if name.startswith(_PREFIX) else name
            if base not in self.registry:
                self.skipped += 1
                continue
            labels = dict(labels)
            labels["replica"] = target
            if version is not None:
                labels["version"] = version
            if self.store.append(base, value, labels, t=now):
                appended += 1
        self.store.append("scrape_duration_ms",
                          (time.perf_counter() - t0) * 1e3,
                          {"replica": target}, t=now)
        self.samples += appended
        return appended

    def stats(self) -> dict:
        return {"rounds": self.rounds, "samples": self.samples,
                "skipped": self.skipped, "failures": dict(self.failures),
                "paused": self._paused}
