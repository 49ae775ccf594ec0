"""The fleet's persistent-connection layer: one pool for every hop (port
of ``featurenet_tpu/fleet/pool.py``; stdlib only).

This is the one module of the port's fleet that constructs
``http.client.HTTPConnection``; the router's forwards, the manager's
``/healthz`` probes, the scraper and the load generator check a channel
out of a pool and put it back.

- **Check-out / check-in**: ``checkout(host, port)`` hands back an idle
  keep-alive channel to that endpoint (or opens a fresh one), owned by the
  caller until ``checkin``. One pool serves many threads.
- **Bounded idle**: at most ``max_idle_per_endpoint`` channels are kept
  per endpoint; extras are retired on check-in (``idle_overflow``).
- **Max-age retirement**: a channel older than ``max_age_s`` is retired
  instead of reused (``max_age``).
- **Broken sockets**: a channel that dies mid-request is retired
  (``broken``). ``post``/``get`` retry ONCE on a fresh channel when the
  failure happened on a reused one (a keep-alive peer may close an idle
  channel between requests); a fresh channel's failure raises, which is
  the replica-loss shape the router's re-submit-once path absorbs. A
  timeout raises at once: the peer is alive but slow.
- **Health coupling**: ``retire_endpoint`` drops every idle channel of an
  endpoint now (a failed probe, a replica charged lost).

``conn_open``/``conn_reuse``/``conn_retire`` events go to the run's
stream, and each fresh connect feeds the ``connect_ms`` window; the pool
also keeps plain counters (``stats()``).
"""

from __future__ import annotations

import http.client
import threading
import time
from collections import deque
from typing import Optional

from featurenet_tpu_torch import obs
from featurenet_tpu_torch.obs import windows as _windows

# Sized to the load generator's worker concurrency (32), so a healthy
# burst's channels all come back to the idle set.
DEFAULT_MAX_IDLE_PER_ENDPOINT = 32
DEFAULT_MAX_AGE_S = 60.0
DEFAULT_TIMEOUT_S = 60.0

# The conn_retire event's reasons (a closed set).
RETIRE_REASONS = ("broken", "max_age", "idle_overflow", "server_close",
                  "probe_failure", "replica_loss", "shutdown")


class PooledChannel:
    """One keep-alive channel: the connection, its endpoint, its birth
    time and its use count. Owned by one caller between checkout and
    checkin."""

    __slots__ = ("conn", "host", "port", "opened_t", "uses")

    def __init__(self, conn: http.client.HTTPConnection, host: str,
                 port: int):
        self.conn = conn
        self.host = host
        self.port = port
        self.opened_t = time.monotonic()
        self.uses = 0

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def age_s(self) -> float:
        return time.monotonic() - self.opened_t


class ConnectionPool:
    """Bounded keep-alive channel pool over ``(host, port)`` endpoints."""

    def __init__(self,
                 max_idle_per_endpoint: int = DEFAULT_MAX_IDLE_PER_ENDPOINT,
                 max_age_s: float = DEFAULT_MAX_AGE_S,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if max_idle_per_endpoint < 1:
            raise ValueError(f"max_idle_per_endpoint must be >= 1, "
                             f"got {max_idle_per_endpoint}")
        if max_age_s <= 0:
            raise ValueError(f"max_age_s must be > 0, got {max_age_s}")
        self.max_idle_per_endpoint = int(max_idle_per_endpoint)
        self.max_age_s = float(max_age_s)
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._idle: dict[tuple[str, int], deque[PooledChannel]] = {}
        self._closed = False
        self._opened = 0
        self._reused = 0
        self._in_use = 0
        self._in_use_peak = 0
        self._retired: dict[str, int] = {}

    # -- check-out / check-in ------------------------------------------------
    def checkout(self, host: str, port: int,
                 timeout_s: Optional[float] = None,
                 fresh: bool = False) -> PooledChannel:
        """An exclusive channel to ``host:port``: the freshest idle one
        (max-age violators retired on the way), else a new connection.
        ``timeout_s`` re-arms the socket timeout for this use;
        ``fresh=True`` skips the idle set (the stale-reuse retry)."""
        with self._lock:
            if self._closed:
                # Refused like a dead endpoint: every caller handles OSError.
                raise OSError("connection pool is closed")
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        key = (host, int(port))
        ch: Optional[PooledChannel] = None
        while not fresh:
            with self._lock:
                q = self._idle.get(key)
                cand = q.pop() if q else None
            if cand is None:
                break
            if cand.age_s() > self.max_age_s or cand.conn.sock is None:
                self._retire(cand, "max_age" if cand.conn.sock is not None
                             else "server_close")
                continue
            ch = cand
            break
        if ch is None:
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
            t0 = time.perf_counter()
            conn.connect()
            connect_ms = (time.perf_counter() - t0) * 1e3
            ch = PooledChannel(conn, host, int(port))
            with self._lock:
                self._opened += 1
            _windows.observe("connect_ms", connect_ms)
            obs.emit("conn_open", endpoint=ch.endpoint,
                     connect_ms=round(connect_ms, 3))
        else:
            with self._lock:
                self._reused += 1
            if ch.conn.sock is not None:
                ch.conn.sock.settimeout(timeout)
            obs.emit("conn_reuse", endpoint=ch.endpoint, uses=ch.uses)
        ch.uses += 1
        with self._lock:
            self._in_use += 1
            self._in_use_peak = max(self._in_use_peak, self._in_use)
        return ch

    def checkin(self, ch: PooledChannel) -> None:
        """Return a healthy channel to the idle set; one past max-age,
        closed, or over the idle bound is retired instead."""
        with self._lock:
            self._in_use = max(0, self._in_use - 1)
        if ch.conn.sock is None:
            self._retire(ch, "server_close")
            return
        if ch.age_s() > self.max_age_s:
            self._retire(ch, "max_age")
            return
        key = (ch.host, ch.port)
        with self._lock:
            if not self._closed:
                q = self._idle.setdefault(key, deque())
                if len(q) < self.max_idle_per_endpoint:
                    q.append(ch)
                    return
        self._retire(ch, "idle_overflow" if not self._closed else "shutdown")

    def _retire(self, ch: PooledChannel, reason: str) -> None:
        try:
            ch.conn.close()
        except OSError:
            pass
        with self._lock:
            self._retired[reason] = self._retired.get(reason, 0) + 1
        obs.emit("conn_retire", endpoint=ch.endpoint, reason=reason,
                 uses=ch.uses)

    def retire(self, ch: PooledChannel, reason: str = "broken") -> None:
        """Retire a checked-out channel (its caller saw it break)."""
        with self._lock:
            self._in_use = max(0, self._in_use - 1)
        self._retire(ch, reason)

    def retire_endpoint(self, host: str, port: int,
                        reason: str = "probe_failure") -> int:
        """Drop every idle channel of an endpoint now; returns how many."""
        with self._lock:
            q = self._idle.pop((host, int(port)), None)
        if not q:
            return 0
        for ch in q:
            self._retire(ch, reason)
        return len(q)

    def close(self) -> None:
        """Retire every idle channel (``shutdown``); later check-ins are
        retired instead of pooled."""
        with self._lock:
            self._closed = True
            qs = list(self._idle.values())
            self._idle.clear()
        for q in qs:
            for ch in q:
                self._retire(ch, "shutdown")

    # -- requests ------------------------------------------------------------
    def post(self, host: str, port: int, path: str, body: bytes,
             headers: dict, timeout_s: Optional[float] = None
             ) -> tuple[int, bytes, Optional[float]]:
        """One pooled POST: ``(status, body_bytes, retry_after_s)``. Raises
        ``OSError``/``http.client.HTTPException`` when a fresh channel
        fails."""
        return self._request(host, port, "POST", path, body, headers,
                             timeout_s)

    def get(self, host: str, port: int, path: str,
            timeout_s: Optional[float] = None) -> tuple[int, bytes]:
        """One pooled GET: ``(status, body_bytes)``; raises as ``post``."""
        status, data, _ = self._request(host, port, "GET", path, None, {},
                                        timeout_s)
        return status, data

    def _request(self, host: str, port: int, method: str, path: str,
                 body: Optional[bytes], headers: dict,
                 timeout_s: Optional[float]
                 ) -> tuple[int, bytes, Optional[float]]:
        force_fresh = False
        while True:
            ch = self.checkout(host, port, timeout_s, fresh=force_fresh)
            reused = ch.uses > 1
            try:
                status, data, ra = self._roundtrip(ch, method, path, body,
                                                   headers)
            except (OSError, http.client.HTTPException) as e:
                self.retire(ch, "broken")
                if isinstance(e, TimeoutError):
                    raise  # a slow peer, not a stale channel
                if reused and not force_fresh:
                    force_fresh = True
                    continue
                raise
            self.checkin(ch)
            return status, data, ra

    @staticmethod
    def _roundtrip(ch: PooledChannel, method: str, path: str,
                   body: Optional[bytes], headers: dict
                   ) -> tuple[int, bytes, Optional[float]]:
        hdrs = dict(headers)
        if body is not None:
            hdrs.setdefault("Content-Type", "application/octet-stream")
        ch.conn.request(method, path, body=body, headers=hdrs)
        resp = ch.conn.getresponse()
        data = resp.read()  # drained: the channel is reusable
        ra = resp.getheader("Retry-After")
        try:
            ra = float(ra) if ra is not None else None
        except ValueError:
            ra = None
        if resp.will_close:
            ch.conn.close()  # the server's last response on this channel
        return resp.status, data, ra

    def stats(self) -> dict:
        with self._lock:
            opened, reused = self._opened, self._reused
            total = opened + reused
            return {
                "opened": opened,
                "reused": reused,
                "reuse_ratio": round(reused / total, 4) if total else None,
                "retired": dict(sorted(self._retired.items())),
                "idle": sum(len(q) for q in self._idle.values()),
                "in_use": self._in_use,
                "in_use_peak": self._in_use_peak,
                # Fresh connects beyond the working set the callers'
                # concurrency needed: channels that had to be reopened.
                "reconnects": max(0, opened - self._in_use_peak),
            }
