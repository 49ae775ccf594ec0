"""Open-loop HTTP load for the fleet, and one replica's spawn argv (port
of ``featurenet_tpu/fleet/loadgen.py``).

``http_load`` speaks the wire: Poisson arrivals POSTed to the router's
``/predict_voxels`` (raw float32 grid bytes), each with a minted trace id
and a priority lane. A 503 carrying ``Retry-After`` is honoured ONCE
(sleep the hint, retry) before it counts as a rejection. The client keeps
a keep-alive channel set (``fleet/pool.py``) sized to its worker threads;
``reconnects`` counts the fresh connects beyond that working set.

``replica_argv`` is the child contract of ``cli fleet``: one
``featurenet_tpu_torch.cli serve --port 0`` with the fleet's identity
flags. The reference's ``bench_fleet`` row waits for the port's benchmark.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from featurenet_tpu_torch.fleet.pool import ConnectionPool
from featurenet_tpu_torch.obs import tracing as _tracing
from featurenet_tpu_torch.obs.report import _pct
from featurenet_tpu_torch.obs.tracing import TRACE_HEADER
from featurenet_tpu_torch.serve.http import PRIORITY_HEADER


def _post(pool: ConnectionPool, host: str, port: int, path: str,
          body: bytes, lane: str,
          timeout_s: float) -> tuple[int, dict, Optional[float]]:
    """One pooled POST: ``(status, parsed body, Retry-After seconds)``.
    Connection-level failures raise ``OSError``/``HTTPException``."""
    status, raw, ra = pool.post(host, port, path, body, {
        TRACE_HEADER: _tracing.mint_trace_id(),
        PRIORITY_HEADER: lane,
    }, timeout_s)
    try:
        doc = json.loads(raw.decode("utf-8"))
    except ValueError:
        doc = {}
    return status, doc, ra


def http_load(host: str, port: int, qps: float, n_requests: int,
              grids: np.ndarray, lane: str = "interactive",
              rng: Optional[np.random.Generator] = None,
              timeout_s: float = 60.0,
              honor_retry_after: bool = True,
              max_workers: int = 32) -> tuple[dict, list]:
    """Drive ``host:port`` with ``n_requests`` Poisson arrivals at ``qps``
    (request i sends ``grids[i % len(grids)]``); returns ``(stats,
    outcomes)``, ``outcomes[i]`` request i's final status, latency, label
    and body. Open loop: the arrivals are scheduled ahead, a slow fleet
    is submitted to late but never slower; each request runs on a worker
    thread. A drop is any 5xx but a clean 503, or a connection death
    against ``host:port`` itself."""
    from concurrent.futures import ThreadPoolExecutor

    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    if rng is None:
        rng = np.random.default_rng(0)
    pool = ConnectionPool(max_idle_per_endpoint=max_workers,
                          max_age_s=600.0, timeout_s=timeout_s)
    payloads = [np.ascontiguousarray(g.reshape(g.shape[:3]),
                                     dtype="<f4").tobytes() for g in grids]
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=n_requests))
    outcomes: list[Optional[dict]] = [None] * n_requests

    def one(i: int) -> None:
        t_submit = time.perf_counter()
        body = payloads[i % len(payloads)]
        try:
            status, doc, ra = _post(pool, host, port, "/predict_voxels", body,
                                    lane, timeout_s)
            retried = False
            if status == 503 and honor_retry_after and ra:
                time.sleep(ra)
                retried = True
                # The backoff is server-directed waiting, not latency.
                t_submit = time.perf_counter()
                status, doc, ra = _post(pool, host, port, "/predict_voxels",
                                        body, lane, timeout_s)
        except (OSError, http.client.HTTPException) as e:
            outcomes[i] = {"status": None, "error": str(e)}
            return
        outcomes[i] = {
            "status": status,
            "latency_ms": (time.perf_counter() - t_submit) * 1e3,
            "label": doc.get("label"),
            "retried": retried,
            "body": doc,
        }

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max_workers) as workers:
        futs = []
        for i in range(n_requests):
            ahead = arrivals[i] - (time.perf_counter() - t0)
            if ahead > 0:
                time.sleep(ahead)
            futs.append(workers.submit(one, i))
        for f in futs:
            f.result()
    wall = time.perf_counter() - t0
    conn = pool.stats()
    pool.close()
    done = [o for o in outcomes if o is not None]
    ok = [o for o in done if o.get("status") == 200]
    rejected = sum(1 for o in done if o.get("status") == 503)
    dropped = sum(1 for o in done if o.get("status") is None
                  or (o["status"] >= 500 and o["status"] != 503))
    lats = sorted(o["latency_ms"] for o in ok)
    stats = {
        "offered_qps": round(n_requests / float(arrivals[-1]), 1),
        "sustained_qps": round(len(ok) / wall, 1) if wall > 0 else None,
        "answered": len(ok),
        "rejected": rejected,
        "dropped": dropped,
        "retried": sum(1 for o in done if o.get("retried")),
        "p50_ms": round(_pct(lats, 50), 3) if lats else None,
        "p99_ms": round(_pct(lats, 99), 3) if lats else None,
        "connects": conn["opened"],
        "conn_reuses": conn["reused"],
        "reconnects": conn["reconnects"],
    }
    return stats, outcomes


def replica_argv(ckpt_dir: str, slot: int, heartbeat_file: str, *,
                 run_dir: Optional[str] = None,
                 device: str = "cuda",
                 buckets: str = "1,4", max_wait_ms: float = 5.0,
                 queue_limit: int = 64,
                 slo_p99_ms: float = 250.0,
                 precision: Optional[str] = None,
                 inject_faults: Optional[str] = None,
                 trace_sample: Optional[float] = None,
                 quality: bool = False,
                 quality_baseline: Optional[str] = None,
                 capture: bool = False,
                 capture_sample: Optional[float] = None) -> list:
    """One replica's argv: ``cli serve --port 0`` with the replica id, its
    heartbeat file, its event stream (``--process-index slot+1``; the
    router owns stream 0) and the fleet's ``--device``. Capture rings are
    per slot (``<run_dir>/capture/replica<slot>``): a ring has one writer
    process."""
    argv = [
        sys.executable, "-m", "featurenet_tpu_torch.cli", "serve",
        "--checkpoint-dir", ckpt_dir, "--port", "0",
        "--buckets", buckets, "--max-wait-ms", str(max_wait_ms),
        "--queue-limit", str(queue_limit),
        "--slo-p99-ms", str(slo_p99_ms),
        "--replica-id", str(slot),
        "--heartbeat-file", heartbeat_file,
        "--process-index", str(slot + 1),
        "--device", device,
    ]
    if run_dir:
        argv += ["--run-dir", run_dir]
    if precision:
        argv += ["--precision", precision]
    if inject_faults:
        argv += ["--inject-faults", inject_faults]
    if trace_sample is not None:
        argv += ["--trace-sample", str(trace_sample)]
    if quality or quality_baseline:
        argv += ["--quality"]
    if quality_baseline:
        argv += ["--quality-baseline", quality_baseline]
    if capture and run_dir:
        argv += ["--capture-dir",
                 os.path.join(run_dir, "capture", f"replica{slot}")]
        if capture_sample is not None:
            argv += ["--capture-sample", str(capture_sample)]
    return argv
