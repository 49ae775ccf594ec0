"""Stdlib HTTP front end for the inference service (port of
``featurenet_tpu/serve/http.py``'s request/response endpoints).

- ``POST /predict``: raw STL bytes in, the prediction as JSON out.
- ``POST /predict_voxels``: raw float32 little-endian bytes of one
  ``[R,R,R]`` occupancy grid in, the same JSON out.
- ``GET /healthz``: readiness (503 while not ready, a reload's cordon
  included), ``model_version`` and ``checkpoint_dir``; ``GET /stats``:
  batcher counters.
- ``POST /admin/reload`` with ``{"checkpoint_dir": "<path>"}``: the
  zero-downtime weight hot swap (``InferenceService.reload``). ``200``
  with the new ``model_version``, ``from_version`` and ``swap_ms``;
  ``400`` ``bad_json`` or ``bad_reload`` for a body that is not that
  object; ``409`` ``swap_refused`` with the refusal's ``kind`` and
  ``detail`` and the ``model_version`` still serving.

Status codes carry the admission contract: ``200`` answered (body:
``InferenceService.format_row``); ``400`` unparseable STL or voxels;
``503`` overload (``OverloadError.response`` with a ``Retry-After``
header) or draining; ``504`` admitted but not answered within the
handler timeout; ``500`` the forward failed. Both POST endpoints read
``X-Featurenet-Priority`` (``interactive`` default, ``batch``).

The server speaks HTTP/1.1 with an exact ``Content-Length`` on every
response, so one connection serves any number of sequential requests; it
closes a connection only after a draining 503.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from featurenet_tpu_torch.serve.batcher import OverloadError, normalize_lane

DEFAULT_REQUEST_TIMEOUT_S = 60.0
PRIORITY_HEADER = "X-Featurenet-Priority"

ENDPOINTS = ["POST /predict", "POST /predict_voxels", "POST /admin/reload",
             "GET /stats", "GET /healthz"]


def parse_voxels(data: bytes, resolution: int) -> np.ndarray:
    """One ``[R,R,R]`` float32 grid from raw little-endian bytes,
    size-checked so a short body is a 400."""
    want = resolution ** 3 * 4
    if len(data) != want:
        raise ValueError(
            f"expected {want} bytes (float32 [{resolution}]^3 grid), got {len(data)}"
        )
    return np.frombuffer(data, dtype="<f4").reshape((resolution,) * 3)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # The listen backlog: a burst of clients connecting at once must queue
    # for accept, not be reset (the stdlib default is 5).
    request_queue_size = 256


def make_server(service, host: str = "127.0.0.1", port: int = 0,
                request_timeout_s: float = DEFAULT_REQUEST_TIMEOUT_S
                ) -> ThreadingHTTPServer:
    """Build (but do not start) the server; ``port=0`` binds an ephemeral
    port (read it from ``server_address``). Run ``serve_forever()`` on a
    thread and call ``shutdown()`` before draining the service."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = request_timeout_s + 15.0

        def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
            pass

        def _json(self, code: int, payload: dict,
                  retry_after_s: float | None = None,
                  close: bool = False) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after_s is not None:
                self.send_header("Retry-After", f"{retry_after_s:.3f}")
            if close:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib name)
            if self.path == "/stats":
                self._json(200, {"ok": True, **service.stats()})
            elif self.path == "/healthz":
                health = service.health()
                self._json(200 if health["ready"] else 503, health)
            else:
                self._json(404, {"error": "not_found", "endpoints": ENDPOINTS})

        def do_POST(self):  # noqa: N802 (stdlib name)
            # Read the body first: an unread body on a keep-alive channel
            # would be parsed as the next request.
            data = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if self.path == "/admin/reload":
                self._admin_reload(data)
                return
            if self.path not in ("/predict", "/predict_voxels"):
                self._json(404, {"error": "not_found", "endpoints": ENDPOINTS})
                return
            lane = normalize_lane(self.headers.get(PRIORITY_HEADER))
            try:
                if self.path == "/predict_voxels":
                    fut = service.submit_voxels(
                        parse_voxels(data, service.cfg.resolution), lane=lane
                    )
                else:
                    fut = service.submit_stl_bytes(data, lane=lane)
            except OverloadError as e:
                self._json(503, e.response, retry_after_s=e.retry_after_s)
                return
            except ValueError as e:
                self._json(400, {
                    "error": "bad_stl" if self.path == "/predict" else "bad_voxels",
                    "detail": str(e),
                })
                return
            except RuntimeError as e:
                # The batcher's "draining" refusal (OverloadError, also a
                # RuntimeError, is handled above): the server is going
                # away, so the channel closes.
                self._json(503, {"error": "draining", "detail": str(e)},
                           retry_after_s=service.batcher.retry_after_s,
                           close=True)
                return
            try:
                row = fut.result(timeout=request_timeout_s)
            except TimeoutError:
                self._json(504, {"error": "timeout", "timeout_s": request_timeout_s})
                return
            except RuntimeError as e:
                self._json(500, {"error": "forward_failed", "detail": str(e)})
                return
            self._json(200, service.format_row(row))

        def _admin_reload(self, data: bytes) -> None:
            try:
                payload = json.loads(data.decode("utf-8")) if data else {}
            except ValueError as e:
                self._json(400, {"error": "bad_json", "detail": str(e)})
                return
            ckpt = payload.get("checkpoint_dir") if isinstance(payload, dict) else None
            if not isinstance(ckpt, str) or not ckpt:
                self._json(400, {
                    "error": "bad_reload",
                    "detail": 'body must be {"checkpoint_dir": "<path>"}',
                })
                return
            try:
                out = service.reload(ckpt)
            except Exception as e:  # every refusal is a 409; the old weights serve
                self._json(409, {
                    "error": "swap_refused",
                    "kind": type(e).__name__,
                    "detail": str(e),
                    "model_version": getattr(service.predictor, "model_version",
                                             "unversioned"),
                })
                return
            self._json(200, out)

    return _Server((host, port), Handler)
