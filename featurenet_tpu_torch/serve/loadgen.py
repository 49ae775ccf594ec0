"""Open-loop load generator for the serving front end (port of
``featurenet_tpu/serve/loadgen.py``).

``poisson_load`` drives an ``InferenceService`` with Poisson arrivals: the
arrival times are drawn up front from the exponential gaps, and the
generator sleeps only while it is ahead of schedule, so a slow service
makes it submit late, never slower. A rejection carrying the server's
``retry_after_s`` is retried once after that backoff; a second refusal
counts as rejected. It returns the sustained rate, the server-side and
client-side p50/p99 and the buckets' occupancy.

``bench_serving`` is the benchmark row: a seeded-weights service (the rate
does not depend on the weights' values) at an offered rate, as flat
``serve_*`` fields; ``BENCH_LOAD_FRACTION`` of the closed-loop rate is the
rate a benchmark offers. ``measure_trace_overhead`` is the tracing tax:
the closed-loop rate with the sampler off against every request traced;
``measure_quality_overhead`` the model-quality tax: the quality tracker
and the flight recorder detached against attached;
``measure_incident_overhead`` the price of an armed incident manager.
``stream_load`` is the client of ``POST /predict_voxels_stream``: every
grid as one frame, over one keep-alive socket.
"""

from __future__ import annotations

import json
import time
from typing import Optional, Sequence

import numpy as np

from featurenet_tpu_torch import obs
from featurenet_tpu_torch.obs import tracing as _tracing
from featurenet_tpu_torch.obs.windows import _pct
from featurenet_tpu_torch.serve.batcher import OverloadError

# The offered load as a fraction of the closed-loop serving rate (deep
# enough to fill the big buckets, far enough from saturation that p99
# measures the service, not the queue), and a cap on the rate a Python
# thread can schedule.
BENCH_LOAD_FRACTION = 0.3
BENCH_QPS_CAP = 8000.0


# The seconds a generator waits for one accepted request's answer.
RESULT_TIMEOUT_S = 120.0


def poisson_load(service, qps: float, n_requests: int,
                 rng: Optional[np.random.Generator] = None,
                 grids: Optional[np.ndarray] = None) -> tuple[dict, list]:
    """Drive ``service`` with ``n_requests`` Poisson arrivals at ``qps``;
    returns ``(stats, futures)``, the futures of the accepted requests,
    resolved (request i's grid is ``grids[i % len(grids)]``). The stats
    are computed after every accepted request is answered, so
    ``sustained_qps`` is answers over the whole wall."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    if rng is None:
        rng = np.random.default_rng(0)
    if grids is None:
        from featurenet_tpu_torch.data.synthetic import generate_batch

        grids = generate_batch(rng, min(64, max(1, n_requests)),
                               service.cfg.resolution)["voxels"]
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=n_requests))
    t0 = time.perf_counter()
    futures: list = []
    submit_t: list[float] = []  # the client's submit stamp per future
    rejected = 0
    retried = 0
    retries: list[tuple[float, int]] = []  # (due stamp, grid index)

    def _try(i: int, may_retry: bool) -> None:
        nonlocal rejected, retried
        # The client mints its own trace id and stamps its clock before
        # the submit, on the clock the server stamps with.
        t_submit = time.perf_counter()
        try:
            futures.append(service.submit_voxels(
                grids[i % len(grids)], trace_id=_tracing.mint_trace_id()))
            submit_t.append(t_submit)
        except OverloadError as e:
            if may_retry and e.retry_after_s:
                retried += 1
                retries.append((time.perf_counter() + e.retry_after_s, i))
            else:
                rejected += 1

    for i in range(n_requests):
        while retries and retries[0][0] <= time.perf_counter():
            _try(retries.pop(0)[1], may_retry=False)
        ahead = arrivals[i] - (time.perf_counter() - t0)
        if ahead > 0:
            time.sleep(ahead)
        _try(i, may_retry=True)
    for due, i in retries:  # backoffs still due after the last arrival
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        _try(i, may_retry=False)
    for fut in futures:
        fut.result(timeout=RESULT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lats = sorted(f.latency_ms for f in futures)
    client_by_trace = {f.trace_id: round((f.t_done - ts) * 1e3, 3)
                       for f, ts in zip(futures, submit_t)}
    client = sorted(client_by_trace.values())
    st = service.stats()
    stats = {
        "offered_qps": round(n_requests / float(arrivals[-1]), 1),
        "sustained_qps": round(len(futures) / wall, 1) if wall > 0 else None,
        "accepted": len(futures),
        "rejected": rejected,
        "retried": retried,
        "p50_ms": round(_pct(lats, 50), 3) if lats else None,
        "p99_ms": round(_pct(lats, 99), 3) if lats else None,
        "client_p50_ms": round(_pct(client, 50), 3) if client else None,
        "client_p99_ms": round(_pct(client, 99), 3) if client else None,
        "client_by_trace": client_by_trace,
        "occupancy": st["occupancy"],
        "by_bucket": st["by_bucket"],
    }
    if client:
        obs.emit("loadgen", n=len(client),
                 client_p50_ms=stats["client_p50_ms"],
                 client_p99_ms=stats["client_p99_ms"],
                 offered_qps=stats["offered_qps"])
    return stats, futures


def stream_load(host: str, port: int, grids,
                trace_id: Optional[str] = None) -> dict:
    """Pipeline every grid of ``grids`` over one keep-alive socket as
    length-prefixed float32 frames (``POST /predict_voxels_stream``) and
    collect the per-frame JSON lines as the server streams them. Returns
    the status, the stream id the server echoed, the lines in frame order
    and the answered/error split."""
    import http.client
    import struct

    from featurenet_tpu_torch.obs.tracing import TRACE_HEADER

    frames = []
    for g in grids:
        a = np.asarray(g)
        payload = np.ascontiguousarray(a.reshape(a.shape[:3]), dtype="<f4").tobytes()
        frames.append(struct.pack("<I", len(payload)) + payload)
    body = b"".join(frames)
    headers = {"Content-Type": "application/octet-stream"}
    if trace_id:
        headers[TRACE_HEADER] = trace_id
    conn = http.client.HTTPConnection(host, port, timeout=RESULT_TIMEOUT_S)
    t0 = time.perf_counter()
    lines: list[dict] = []
    try:
        conn.request("POST", "/predict_voxels_stream", body=body,
                     headers=headers)
        resp = conn.getresponse()
        stream_id = resp.getheader(TRACE_HEADER)
        if resp.status != 200:
            try:
                err = json.loads(resp.read().decode("utf-8"))
            except ValueError:
                err = {}
            return {"status": resp.status, "stream_id": stream_id,
                    "frames": len(frames), "answered": 0,
                    "errors": len(frames), "lines": [], "detail": err,
                    "reconnects": 0}
        # readline through the chunked decoder: a line arrives as soon as
        # its frame resolves.
        while True:
            raw = resp.readline()
            if not raw:
                break
            raw = raw.strip()
            if raw:
                lines.append(json.loads(raw.decode("utf-8")))
    finally:
        conn.close()
    wall = time.perf_counter() - t0
    ok = [ln for ln in lines if "label" in ln or "voxel_counts" in ln]
    return {
        "status": 200,
        "stream_id": stream_id,
        "frames": len(frames),
        "answered": len(ok),
        "errors": len(lines) - len(ok),
        "lines": lines,
        "wall_s": round(wall, 4),
        "frames_per_sec": round(len(lines) / wall, 1) if wall > 0 else None,
        "reconnects": 0,
    }


def _build_service(cfg, buckets: Sequence[int], max_wait_ms: float,
                   queue_limit: int, device="cuda", **service_kw):
    """A service over seeded weights for ``cfg`` (the rate does not depend
    on the weights' values), warmed at ``buckets``."""
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.service import InferenceService

    pred = Predictor.from_seed(cfg, 0, batch=max(buckets), device=device)
    return InferenceService(pred, buckets=buckets, max_wait_ms=max_wait_ms,
                            queue_limit=queue_limit, **service_kw)


def bench_serving(cfg, qps: float, n_requests: int = 512,
                  device="cuda") -> dict:
    """The serving benchmark row: a seeded-weights service for ``cfg`` at
    the buckets 1/4/16/64, a 5 ms deadline and a queue bound of 256, the
    open-loop generator at ``qps``, a drain, and flat ``serve_*``
    fields."""
    service = _build_service(cfg, (1, 4, 16, 64), 5.0, 256, device=device)
    try:
        stats, _ = poisson_load(service, qps=qps, n_requests=n_requests,
                                rng=np.random.default_rng(0))
    finally:
        service.drain()
    return {
        "serve_qps_offered": stats["offered_qps"],
        "serve_qps_sustained": stats["sustained_qps"],
        "serve_p50_ms": stats["p50_ms"],
        "serve_p99_ms": stats["p99_ms"],
        # The gap between the client's p99 and the server's is queueing
        # before admission, on one clock.
        "serve_client_p50_ms": stats["client_p50_ms"],
        "serve_client_p99_ms": stats["client_p99_ms"],
        "serve_occupancy": stats["occupancy"],
        "serve_rejected": stats["rejected"],
        "serve_buckets": {str(k): v for k, v in stats["by_bucket"].items()},
        "serve_requests": n_requests,
    }


def _closed_loop_qps(service, grid, n_requests: int) -> float:
    """The request rate of ``n_requests`` submitted at once and all
    answered: the overhead probes' closed loop."""
    t0 = time.perf_counter()
    futs = [service.submit_voxels(grid) for _ in range(n_requests)]
    for f in futs:
        f.result(timeout=RESULT_TIMEOUT_S)
    return n_requests / (time.perf_counter() - t0)


def measure_trace_overhead(cfg, n_requests: int = 192,
                           device="cuda") -> dict:
    """The tracing tax: the closed-loop request rate through one warmed
    service with the sampler off (``trace_sample=0``: contexts are minted,
    nothing is kept) against every request traced (``trace_sample=1``),
    both with the sink active in a throwaway run directory, so the
    difference is the tracing's emission cost. It installs and closes its
    own run, so it refuses while one is active."""
    import shutil
    import tempfile

    if obs.active():
        raise RuntimeError("measure_trace_overhead installs and closes its "
                           "own obs run; close_run() the active run first")
    tmp = tempfile.mkdtemp(prefix="trace_overhead_")
    obs.init_run(tmp, extra={"cmd": "trace_overhead"}, process_index=0)
    grid = np.zeros((cfg.resolution,) * 3 + (1,), np.float32)
    service = None
    try:
        # No rules and an infinite SLO: a finite one would force-sample
        # the closed-loop burst's tail in both phases alike.
        service = _build_service(cfg, (1, 4, 16), max_wait_ms=2.0,
                                 queue_limit=max(256, n_requests),
                                 device=device, rules=(),
                                 slo_p99_ms=float("inf"))
        service.batcher.trace_sample = 0.0
        _closed_loop_qps(service, grid, n_requests)  # warm pass
        dark = _closed_loop_qps(service, grid, n_requests)
        service.batcher.trace_sample = 1.0
        traced = _closed_loop_qps(service, grid, n_requests)
    finally:
        if service is not None:
            service.drain()
        obs.close_run()
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "trace_overhead_pct": round(max(0.0, (dark - traced) / dark * 100.0), 2)
        if dark > 0 else None,
        "trace_dark_qps": round(dark, 1),
        "trace_sampled_qps": round(traced, 1),
        "trace_overhead_requests": n_requests,
    }


def measure_incident_overhead(cfg, n_requests: int = 192,
                              device="cuda") -> dict:
    """The incident plane's steady-state tax: the closed-loop request rate
    through one warmed service with no incident manager armed against one
    armed on the run directory (the event tap installed), on the same
    programs. Both phases trace every request (``trace_sample=1``), so the
    tap sits on the per-request emit path; no rules, so no alert fires and
    no incident opens: this is the price of being armed, not of a
    capture. It installs and closes its own run in a throwaway directory,
    so it refuses while one is active."""
    import shutil
    import tempfile

    from featurenet_tpu_torch.obs import incidents as _incidents

    if obs.active():
        raise RuntimeError("measure_incident_overhead installs and closes "
                           "its own obs run; close_run() the active run "
                           "first")
    tmp = tempfile.mkdtemp(prefix="incident_overhead_")
    obs.init_run(tmp, extra={"cmd": "incident_overhead"}, process_index=0)
    grid = np.zeros((cfg.resolution,) * 3 + (1,), np.float32)
    service = manager = None
    try:
        service = _build_service(cfg, (1, 4, 16), max_wait_ms=2.0,
                                 queue_limit=max(256, n_requests),
                                 device=device, rules=(),
                                 slo_p99_ms=float("inf"))
        service.batcher.trace_sample = 1.0  # the tap on the emit path
        _closed_loop_qps(service, grid, n_requests)  # warm pass
        dark = _closed_loop_qps(service, grid, n_requests)  # no manager armed
        manager = _incidents.arm(tmp)
        armed = _closed_loop_qps(service, grid, n_requests)
    finally:
        if manager is not None:
            _incidents.disarm(manager)
        if service is not None:
            service.drain()
        obs.close_run()
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "incident_overhead_pct": round(max(0.0, (dark - armed) / dark * 100.0),
                                       2) if dark > 0 else None,
        "incident_dark_qps": round(dark, 1),
        "incident_armed_qps": round(armed, 1),
        "incident_overhead_requests": n_requests,
    }


def measure_quality_overhead(cfg, n_requests: int = 192,
                             device="cuda") -> dict:
    """The model-quality tax: the closed-loop request rate through one
    warmed service with the batcher's hooks detached (what every serve
    without ``--quality``/``--capture`` runs) against attached (the
    confidence windows, the drift score against a uniform baseline, and
    the flight recorder at its default sample rate), on the same programs.
    The recorder's confidence floor is 0 here: seeded weights predict
    near-uniform probabilities, and force-capturing every request would
    measure the disk, not the tax on healthy traffic. It installs and
    closes its own run in a throwaway directory, so it refuses while one
    is active."""
    import shutil
    import tempfile

    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
    from featurenet_tpu_torch.obs.quality import QualityTracker
    from featurenet_tpu_torch.serve.recorder import FlightRecorder, capture_dir

    if obs.active():
        raise RuntimeError("measure_quality_overhead installs and closes its "
                           "own obs run; close_run() the active run first")
    tmp = tempfile.mkdtemp(prefix="quality_overhead_")
    obs.init_run(tmp, extra={"cmd": "quality_overhead"}, process_index=0)
    num_classes = len(CLASS_NAMES)
    quality = QualityTracker(num_classes,
                             baseline=[1.0 / num_classes] * num_classes)
    recorder = FlightRecorder(capture_dir(tmp), confidence_floor=0.0)
    grid = np.zeros((cfg.resolution,) * 3 + (1,), np.float32)
    service = None
    try:
        # No rules and an infinite SLO, as the trace probe: the per-request
        # quality math and capture policy, not the alert engine.
        service = _build_service(cfg, (1, 4, 16), max_wait_ms=2.0,
                                 queue_limit=max(256, n_requests),
                                 device=device, rules=(),
                                 slo_p99_ms=float("inf"), quality=quality,
                                 recorder=recorder)
        hooks = (service.batcher.on_result, service.batcher.on_reject)
        service.batcher.trace_sample = 0.0  # apart from the tracing tax
        service.batcher.on_result = service.batcher.on_reject = None
        _closed_loop_qps(service, grid, n_requests)  # warm pass
        off = _closed_loop_qps(service, grid, n_requests)
        service.batcher.on_result, service.batcher.on_reject = hooks
        on = _closed_loop_qps(service, grid, n_requests)
        captured = recorder.stats()["captured"]
    finally:
        if service is not None:
            service.drain()
        obs.close_run()
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "quality_overhead_pct": round(max(0.0, (off - on) / off * 100.0), 2)
        if off > 0 else None,
        "quality_off_qps": round(off, 1),
        "quality_on_qps": round(on, 1),
        "quality_overhead_requests": n_requests,
        "quality_captured": captured,
    }
