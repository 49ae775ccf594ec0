"""The fleet router: one HTTP front end over N serving replicas (port of
``featurenet_tpu/fleet/router.py``).

Routing policy, in the order a request meets it:

1. **Lane shed**: a ``batch``-lane request goes only to a replica whose
   load score is under ``batch_shed_depth``; when every healthy replica is
   above it, batch sheds at once (503 + ``Retry-After``, ``fleet_shed``)
   while interactive traffic still walks every replica.
2. **Health-gated least-queue-depth pick** from the replica provider's
   ``/healthz``-fed view (probed queue depth + the router's in-flight).
3. **Spillover**: a replica's overload or draining 503 means "try the next
   healthy replica" (``fleet_spillover``, the trace id kept in
   ``X-Featurenet-Trace``); the fleet-wide 503 with ``Retry-After`` comes
   only when every replica was tried.
4. **Re-submit once**: a connection that dies mid-request (the replica was
   SIGKILLed) goes to ONE survivor (``fleet_resubmit``; classification is
   pure, so it is idempotent). A second death is a 502 drop, counted in
   ``dropped``.

Every router→replica hop rides the provider's connection pool
(``fleet/pool.py``), shared with the manager's ``/healthz`` probes. The
``replica_loss`` fault site fires here, at the Nth routed request, and
SIGKILLs a live replica through the provider's ``kill_one``.

Scaling verdicts are advisory: the router feeds its end-to-end walls into
the ``serving_ms`` window, and a background cycle turns the burn rates of
its SLO (``alerts.BurnEvaluator`` over the scraper-fed store when one is
given, else the same math over the live window) and the roster's queue
depths into ``fleet_scale{verdict: add|shed|hold}`` events, which the
``Autoscaler`` (``fleet/replica.py``) may act on. With a ``run_dir`` the
router arms the process-wide incident manager (``obs/incidents.py``).

The router's process owns no device: nothing here touches torch's CUDA
state (its imports load torch through ``serve/service.py``, and create no
context).
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from featurenet_tpu_torch import faults, obs
from featurenet_tpu_torch.fleet.pool import ConnectionPool
from featurenet_tpu_torch.obs import alerts as _alerts
from featurenet_tpu_torch.obs import windows as _windows
from featurenet_tpu_torch.obs.tracing import TRACE_HEADER, normalize_trace_id
from featurenet_tpu_torch.serve.batcher import normalize_lane
from featurenet_tpu_torch.serve.http import PRIORITY_HEADER
from featurenet_tpu_torch.serve.service import DEFAULT_SLO_P99_MS, serve_rules

DEFAULT_BATCH_SHED_DEPTH = 8
DEFAULT_RETRY_AFTER_S = 0.25
DEFAULT_SCALE_EVERY_S = 5.0

ENDPOINTS = ["POST /predict", "POST /predict_voxels", "GET /stats",
             "GET /healthz", "GET /metrics"]

# Mean ready-replica queue depth above which the verdict is "add" even
# while the burn holds: building pressure is the earlier signal.
_SCALE_ADD_DEPTH = 8.0

# Burn below which an idle multi-replica fleet is provably oversized.
_SCALE_SHED_BURN = 0.1


def scale_verdict(burn_fast: Optional[float], burn_slow: Optional[float],
                  queue_depth: float, ready: int,
                  max_burn: float = 1.0) -> str:
    """One cycle's advisory verdict: ``add`` with no routable replica,
    when BOTH burn windows exceed ``max_burn``, or when queues build;
    ``shed`` when more than one replica idles and neither window burned
    (``None``, no samples, blocks nothing); else ``hold``."""
    if ready == 0:
        return "add"
    if (burn_fast is not None and burn_slow is not None
            and burn_fast > max_burn and burn_slow > max_burn):
        return "add"
    if queue_depth > _SCALE_ADD_DEPTH:
        return "add"
    if ready > 1 and queue_depth <= 0.5 and (
        burn_slow is None or burn_slow < _SCALE_SHED_BURN
    ) and (burn_fast is None or burn_fast < _SCALE_SHED_BURN):
        return "shed"
    return "hold"


class FleetRouter:
    """Route requests over a replica provider (``ReplicaManager``, or
    anything with ``candidates()``, ``note_inflight``, ``note_failure``,
    ``kill_one``, ``ready_count`` and ``stats``)."""

    def __init__(self, fleet, *,
                 slo_p99_ms: float = DEFAULT_SLO_P99_MS,
                 rules: Optional[Sequence] = None,
                 batch_shed_depth: int = DEFAULT_BATCH_SHED_DEPTH,
                 retry_after_s: float = DEFAULT_RETRY_AFTER_S,
                 request_timeout_s: float = 60.0,
                 scale_every_s: float = DEFAULT_SCALE_EVERY_S,
                 store=None,
                 slos: Optional[Sequence] = None,
                 burn_fast_s: float = _alerts.DEFAULT_FAST_WINDOW_S,
                 burn_slow_s: float = _alerts.DEFAULT_SLOW_WINDOW_S,
                 run_dir: Optional[str] = None):
        self.fleet = fleet
        self.slo_p99_ms = float(slo_p99_ms)
        self.batch_shed_depth = int(batch_shed_depth)
        self.retry_after_s = float(retry_after_s)
        self.request_timeout_s = float(request_timeout_s)
        self.scale_every_s = float(scale_every_s)
        # The burn-rate SLO the verdicts judge: ``slos``, else p99 under
        # slo_p99_ms for 99 % of samples.
        if slos is not None:
            self._slos = list(slos)
        else:
            self._slos = [_alerts.BurnRateRule(
                "serving_p99_ms", "<", self.slo_p99_ms, 0.99, "critical",
                fast_s=float(burn_fast_s), slow_s=float(burn_slow_s))]
        self._burn = _alerts.BurnEvaluator(store, self._slos) \
            if store is not None else None
        self.store = store
        # The provider's pool when it has one (probes and forwards share
        # it, and the manager closes it); else the router's own.
        shared = getattr(fleet, "pool", None)
        self._own_pool = shared is None
        self.pool: ConnectionPool = shared or ConnectionPool()
        self._lock = threading.Lock()
        self._routed = 0
        self._answered = 0
        self._rejected = 0
        self._shed = 0
        self._spillovers = 0
        self._resubmits = 0
        self._dropped = 0
        self._draining = False
        self._stopped = False
        if rules is None:
            rules = serve_rules(slo_p99_ms)
        if rules:
            _windows.install(_windows.WindowAggregator(rules=list(rules)))
        self._incidents = None
        if run_dir is not None:
            from featurenet_tpu_torch.obs import incidents as _incidents

            self._incidents = _incidents.arm(run_dir)
        self._last_verdict: Optional[str] = None
        self._scale_stop = threading.Event()
        self._scale_thread = threading.Thread(target=self._scale_loop,
                                              name="fleet-scale", daemon=True)
        self._scale_thread.start()

    # -- scaling verdicts (advisory) -----------------------------------------
    def scale_state(self) -> dict:
        """One cycle's inputs and verdict: both burn windows (the store's,
        else the live window's), the mean roster queue depth, ready count."""
        cands = self.fleet.candidates()
        depth = (sum(c.score for c in cands) / len(cands)) if cands else 0.0
        rule = self._slos[0]
        if self._burn is not None:
            res = self._burn.evaluate().get(rule.metric) or {}
            fast, slow = res.get("fast"), res.get("slow")
        else:
            samples = _windows.samples("serving_ms")
            now = time.perf_counter()
            fast = _alerts.burn_rate(samples, rule, rule.fast_s, now)
            slow = _alerts.burn_rate(samples, rule, rule.slow_s, now)
        verdict = scale_verdict(fast, slow, depth, len(cands), rule.max_burn)
        return {
            "verdict": verdict,
            "burn_fast": round(fast, 4) if fast is not None else None,
            "burn_slow": round(slow, 4) if slow is not None else None,
            "queue_depth": round(depth, 2),
            "replicas": len(cands),
        }

    def _scale_tick(self) -> None:
        st = self.scale_state()
        if st["verdict"] != self._last_verdict:
            self._last_verdict = st["verdict"]
            obs.emit("fleet_scale", verdict=st["verdict"],
                     burn_fast=st["burn_fast"], burn_slow=st["burn_slow"],
                     queue_depth=st["queue_depth"], replicas=st["replicas"])

    def _scale_loop(self) -> None:
        while not self._scale_stop.wait(self.scale_every_s):
            self._scale_tick()

    # -- routing -------------------------------------------------------------
    def _forward(self, cand, path: str, body: bytes, trace_id: str,
                 lane: str):
        """One pooled hop: ``(status, body_bytes, retry_after_s)``; raises
        only when a fresh connection fails (the replica-loss shape)."""
        return self.pool.post(cand.host, cand.port, path, body,
                              {TRACE_HEADER: trace_id, PRIORITY_HEADER: lane},
                              self.request_timeout_s)

    def route(self, path: str, body: bytes,
              trace_id: Optional[str] = None,
              lane: str = "interactive") -> tuple[int, bytes, dict]:
        """Route one request: ``(status, body_bytes, headers)``, the trace
        echo and any ``Retry-After`` in ``headers``."""
        lane = normalize_lane(lane)
        trace_id = normalize_trace_id(trace_id)
        headers = {TRACE_HEADER: trace_id}
        with self._lock:
            if self._draining:
                headers["Retry-After"] = f"{self.retry_after_s:.3f}"
                headers["Connection"] = "close"  # a draining fleet hangs up
                return 503, json.dumps(
                    {"error": "draining", "fleet": True}).encode(), headers
            self._routed += 1
            routed = self._routed
        if faults.maybe_fail("replica_loss", request=routed):
            # SIGKILL a live replica mid-stream: its in-flight requests
            # are what the re-submit path below absorbs.
            self.fleet.kill_one()
        t0 = time.perf_counter()
        tried: set = set()
        failed_once = False
        retry_hint = None
        while True:
            cands = [c for c in self.fleet.candidates() if c.slot not in tried]
            if lane == "batch" and cands:
                under = [c for c in cands if c.score < self.batch_shed_depth]
                if not under and not failed_once:
                    # Every healthy replica is above the batch bar: shed
                    # without occupying one. A request that already died
                    # on a replica may have been admitted there, so it is
                    # not shed: it falls through to the drop below.
                    with self._lock:
                        self._shed += 1
                    obs.emit("fleet_shed", lane=lane,
                             queue_depth=min(c.score for c in cands))
                    headers["Retry-After"] = f"{self.retry_after_s:.3f}"
                    return 503, json.dumps({
                        "error": "overload", "fleet": True, "lane": lane,
                        "shed": True, "retry_after_s": self.retry_after_s,
                    }).encode(), headers
                cands = under
            if not cands:
                ra = retry_hint if retry_hint is not None else self.retry_after_s
                headers["Retry-After"] = f"{ra:.3f}"
                if failed_once:
                    with self._lock:
                        self._dropped += 1
                    return 502, json.dumps({
                        "error": "replica_lost", "fleet": True,
                        "detail": "no surviving replica to re-submit to",
                    }).encode(), headers
                with self._lock:
                    self._rejected += 1
                return 503, json.dumps({
                    "error": "overload", "fleet": True, "lane": lane,
                    "retry_after_s": ra,
                }).encode(), headers
            cand = cands[0]
            tried.add(cand.slot)
            self.fleet.note_inflight(cand.slot, 1)
            try:
                status, data, ra = self._forward(cand, path, body, trace_id,
                                                 lane)
            except (OSError, http.client.HTTPException):
                self.fleet.note_failure(cand.slot)
                # The dead replica's idle channels are corpse sockets too.
                self.pool.retire_endpoint(cand.host, cand.port, "replica_loss")
                if failed_once:
                    with self._lock:
                        self._dropped += 1
                    return 502, json.dumps({
                        "error": "replica_lost", "fleet": True,
                        "replica": cand.slot,
                    }).encode(), headers
                failed_once = True
                with self._lock:
                    self._resubmits += 1
                obs.emit("fleet_resubmit", trace=trace_id,
                         from_replica=cand.slot)
                continue
            finally:
                self.fleet.note_inflight(cand.slot, -1)
            if status == 503:
                # Replica overload or drain: spill to the next replica;
                # its Retry-After rides along should the walk end in 503.
                retry_hint = ra if ra is not None else retry_hint
                with self._lock:
                    self._spillovers += 1
                obs.emit("fleet_spillover", trace=trace_id,
                         from_replica=cand.slot)
                continue
            if status == 200:
                with self._lock:
                    self._answered += 1
                # The fleet's end-to-end wall through every hop.
                _windows.observe("serving_ms", (time.perf_counter() - t0) * 1e3)
            return status, data, headers

    # -- HTTP front end ------------------------------------------------------
    def make_server(self, host: str = "127.0.0.1",
                    port: int = 0) -> ThreadingHTTPServer:
        """The router's HTTP/1.1 keep-alive server (not started):
        ``POST /predict``, ``/predict_voxels``; ``GET /healthz`` (the
        roster summary), ``/stats``, ``/metrics``."""
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = router.request_timeout_s + 15.0

            def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
                pass

            def _send(self, code: int, body: bytes, headers: dict,
                      content_type: str = "application/json") -> None:
                # A "Connection: close" header (the draining 503) also
                # flips the stdlib's close_connection flag.
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers.items():
                    if v is not None:
                        self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib name)
                if self.path == "/healthz":
                    healthy = router.fleet.ready_count()
                    ready = healthy > 0 and not router._draining
                    st = router.fleet.stats()
                    body = json.dumps({
                        "ready": ready, "fleet": True, "healthy": healthy,
                        "total": st.get("replicas", healthy),
                        "draining": router._draining, **st,
                    }).encode()
                    self._send(200 if ready else 503, body, {})
                elif self.path == "/stats":
                    self._send(200, json.dumps({"ok": True,
                                                **router.stats()}).encode(), {})
                elif self.path == "/metrics":
                    from featurenet_tpu_torch.serve.metrics import (
                        CONTENT_TYPE,
                        render_router_metrics,
                    )

                    self._send(200, render_router_metrics(router).encode(),
                               {}, content_type=CONTENT_TYPE)
                else:
                    self._send(404, json.dumps({
                        "error": "not_found", "endpoints": ENDPOINTS,
                    }).encode(), {})

            def do_POST(self):  # noqa: N802 (stdlib name)
                # Drain the body first: an unread body on a keep-alive
                # channel would be parsed as the next request.
                body = self.rfile.read(int(self.headers.get("Content-Length")
                                           or 0))
                if self.path not in ("/predict", "/predict_voxels"):
                    self._send(404, json.dumps({
                        "error": "not_found", "endpoints": ENDPOINTS,
                    }).encode(), {})
                    return
                status, data, headers = router.route(
                    self.path, body, trace_id=self.headers.get(TRACE_HEADER),
                    lane=self.headers.get(PRIORITY_HEADER))
                self._send(status, data, headers)

        srv = ThreadingHTTPServer((host, port), Handler)
        srv.daemon_threads = True
        return srv

    # -- introspection, lifecycle --------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {
                "routed": self._routed,
                "answered": self._answered,
                "rejected": self._rejected,
                "shed": self._shed,
                "spillovers": self._spillovers,
                "resubmits": self._resubmits,
                "dropped": self._dropped,
                "replicas": self.fleet.stats(),
            }
        out["pool"] = self.pool.stats()
        return out

    def drain(self) -> dict:
        """Stop routing, flush the last window cycle and report the fleet's
        verdict: ``exit_code`` 2 on an unresolved serving alert or any
        dropped admitted request, else 0."""
        with self._lock:
            self._draining = True
            first = not self._stopped
            self._stopped = True
        self._scale_stop.set()
        self._scale_thread.join(timeout=2.0)
        _windows.flush()
        # After the last flush, which may resolve an alert and close its
        # incident.
        if self._incidents is not None:
            from featurenet_tpu_torch.obs import incidents as _incidents

            _incidents.disarm(self._incidents)
        st = self.stats()
        # Only a pool the router made is the router's to close: the
        # manager's probes still run on its own.
        if self._own_pool:
            self.pool.close()
        active = [m for m in _windows.active_alerts()
                  if _alerts.is_serving_metric(m)]
        st["active_serving_alerts"] = active
        st["exit_code"] = 2 if (active or st["dropped"]) else 0
        if first:
            obs.emit("fleet_stop", routed=st["routed"], answered=st["answered"],
                     rejected=st["rejected"], dropped=st["dropped"])
        return st
