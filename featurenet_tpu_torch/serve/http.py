"""Stdlib HTTP front end for the inference service (port of
``featurenet_tpu/serve/http.py``).

- ``POST /predict``: raw STL bytes in, the prediction as JSON out.
- ``POST /predict_voxels``: raw float32 little-endian bytes of one
  ``[R,R,R]`` occupancy grid in, the same JSON out.
- ``POST /predict_voxels_stream``: a body of length-prefixed frames
  (``<u32 little-endian payload length><payload>`` repeated, each payload
  one ``/predict_voxels`` grid) under one ``Content-Length``; the response
  streams back one JSON line per frame (chunked), in frame order as each
  resolves. Each frame is its own batcher request with the trace id
  ``<stream>.<i>``; an overloaded, timed-out or failed frame is an error
  line for that frame, not a dropped stream. A torn frame (a truncated
  prefix, a wrong length, a short payload) or an empty body is a
  structured 400 ``bad_stream``, and a torn stream closes the connection.
- ``GET /healthz``: readiness (503 while not ready, a reload's cordon
  included), ``window_seq``, ``model_version``, ``checkpoint_dir`` and,
  for a fleet replica, ``replica``;
  ``GET /stats``: batcher counters; ``GET /metrics``: the Prometheus text
  exporter (``serve/metrics.py``).
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
handler timeout; ``500`` the forward failed. A fleet replica's refusals
(503, 409) and its reload answer name it (``replica``). The POST endpoints read
``X-Featurenet-Priority`` (``interactive`` default, ``batch``). A
well-formed ``X-Featurenet-Trace`` request header is adopted as the trace
id (``obs/tracing.py``); every predict response echoes the id it ran
under, minted when the caller sent none.

The server speaks HTTP/1.1 with an exact ``Content-Length`` (or chunked
framing, for the stream) on every response, so one connection serves any
number of sequential requests; it closes a connection only after a
draining 503 or a torn stream.
"""

from __future__ import annotations

import json
import struct
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from featurenet_tpu_torch.obs.tracing import (
    TRACE_HEADER,
    mint_trace_id,
    normalize_trace_id,
)
from featurenet_tpu_torch.serve.batcher import OverloadError, normalize_lane
from featurenet_tpu_torch.serve.metrics import CONTENT_TYPE, render_metrics

DEFAULT_REQUEST_TIMEOUT_S = 60.0
PRIORITY_HEADER = "X-Featurenet-Priority"

ENDPOINTS = ["POST /predict", "POST /predict_voxels",
             "POST /predict_voxels_stream", "POST /admin/reload",
             "GET /stats", "GET /healthz", "GET /metrics"]

# A frame's trace id "<stream>.<i>" must still fit the 64-char grammar:
# a longer stream id is replaced by a minted one.
_MAX_STREAM_ID_LEN = 48


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
                  trace_id: str | None = None,
                  retry_after_s: float | None = None,
                  close: bool = False) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if trace_id:
                self.send_header(TRACE_HEADER, trace_id)
            if retry_after_s is not None:
                self.send_header("Retry-After", f"{retry_after_s:.3f}")
            if close:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def _reject_body(self, payload: dict) -> dict:
            """A refusal's body, naming the replica when the service has a
            fleet identity (which backend refused, not just one did)."""
            if getattr(service, "replica", None) is not None:
                return {**payload, "replica": service.replica}
            return payload

        def do_GET(self):  # noqa: N802 (stdlib name)
            if self.path == "/stats":
                self._json(200, {"ok": True, **service.stats()})
            elif self.path == "/healthz":
                health = service.health()
                self._json(200 if health["ready"] else 503, health)
            elif self.path == "/metrics":
                body = render_metrics(service).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not_found", "endpoints": ENDPOINTS})

        def do_POST(self):  # noqa: N802 (stdlib name)
            if self.path == "/predict_voxels_stream":
                self._stream()
                return
            # Read the body first: an unread body on a keep-alive channel
            # would be parsed as the next request.
            data = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            if self.path == "/admin/reload":
                self._admin_reload(data)
                return
            if self.path not in ("/predict", "/predict_voxels"):
                self._json(404, {"error": "not_found", "endpoints": ENDPOINTS})
                return
            # Adopted (or minted) before the parse: a 400 echoes it too.
            trace_id = normalize_trace_id(self.headers.get(TRACE_HEADER))
            lane = normalize_lane(self.headers.get(PRIORITY_HEADER))
            try:
                if self.path == "/predict_voxels":
                    fut = service.submit_voxels(
                        parse_voxels(data, service.cfg.resolution),
                        trace_id=trace_id, lane=lane)
                else:
                    fut = service.submit_stl_bytes(data, trace_id=trace_id,
                                                   lane=lane)
            except OverloadError as e:
                self._json(503, self._reject_body(e.response),
                           trace_id=e.trace_id, retry_after_s=e.retry_after_s)
                return
            except ValueError as e:
                self._json(400, {
                    "error": "bad_stl" if self.path == "/predict" else "bad_voxels",
                    "detail": str(e),
                }, trace_id=trace_id)
                return
            except RuntimeError as e:
                # The batcher's "draining" refusal (OverloadError, also a
                # RuntimeError, is handled above): the server is going
                # away, so the channel closes.
                self._json(503, self._reject_body(
                               {"error": "draining", "detail": str(e)}),
                           trace_id=trace_id,
                           retry_after_s=service.batcher.retry_after_s,
                           close=True)
                return
            try:
                row = fut.result(timeout=request_timeout_s)
            except TimeoutError:
                self._json(504, {"error": "timeout", "timeout_s": request_timeout_s},
                           trace_id=fut.trace_id)
                return
            except RuntimeError as e:
                self._json(500, {"error": "forward_failed", "detail": str(e)},
                           trace_id=fut.trace_id)
                return
            self._json(200, service.format_row(row), trace_id=fut.trace_id)

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
                self._json(409, self._reject_body({
                    "error": "swap_refused",
                    "kind": type(e).__name__,
                    "detail": str(e),
                    "model_version": getattr(service.predictor, "model_version",
                                             "unversioned"),
                }))
                return
            self._json(200, self._reject_body(out))

        # -- the streamed multi-part protocol ------------------------------
        def _read_exact(self, n: int) -> bytes:
            """``n`` body bytes, or fewer when the peer stopped sending."""
            chunks = []
            while n > 0:
                chunk = self.rfile.read(n)
                if not chunk:
                    break
                chunks.append(chunk)
                n -= len(chunk)
            return b"".join(chunks)

        def _chunk(self, data: bytes) -> None:
            """One chunk of the chunked response, flushed at once."""
            self.wfile.write(f"{len(data):X}\r\n".encode("ascii") + data + b"\r\n")
            self.wfile.flush()

        def _stream(self) -> None:
            """``POST /predict_voxels_stream``: every frame read and
            submitted (or refused on its own), then one line per frame in
            frame order under one stream-wide deadline."""
            stream_id = normalize_trace_id(self.headers.get(TRACE_HEADER))
            if len(stream_id) > _MAX_STREAM_ID_LEN:
                stream_id = mint_trace_id()
            lane = normalize_lane(self.headers.get(PRIORITY_HEADER))
            remaining = int(self.headers.get("Content-Length") or 0)
            want = service.cfg.resolution ** 3 * 4
            frames: list = []  # (index, future | None, error line | None)

            def torn(detail: str) -> None:
                # The byte stream is unreliable past a torn frame, so the
                # channel closes (admitted frames still resolve).
                self._json(400, {
                    "error": "bad_stream", "detail": detail,
                    "frames_admitted": sum(1 for _, fut, _ in frames
                                           if fut is not None),
                }, trace_id=stream_id, close=True)

            while remaining > 0:
                if remaining < 4:
                    torn(f"torn length prefix at frame {len(frames)}: "
                         f"{remaining} byte(s) left, need 4")
                    return
                prefix = self._read_exact(4)
                if len(prefix) < 4:
                    torn(f"body ended inside frame {len(frames)}'s length prefix")
                    return
                remaining -= 4
                n = struct.unpack("<I", prefix)[0]
                if n != want:
                    torn(f"frame {len(frames)} declares {n} bytes; a "
                         f"[{service.cfg.resolution}]^3 float32 grid is {want}")
                    return
                if n > remaining:
                    torn(f"frame {len(frames)} declares {n} bytes but only "
                         f"{remaining} remain in the body")
                    return
                payload = self._read_exact(n)
                remaining -= len(payload)
                if len(payload) < n:
                    torn(f"body ended inside frame {len(frames)}'s payload "
                         f"({len(payload)}/{n} bytes)")
                    return
                i = len(frames)
                trace_id = f"{stream_id}.{i}"
                try:
                    fut = service.submit_voxels(
                        parse_voxels(payload, service.cfg.resolution),
                        trace_id=trace_id, lane=lane)
                    frames.append((i, fut, None))
                except OverloadError as e:
                    frames.append((i, None, {"trace": e.trace_id or trace_id,
                                             **self._reject_body(e.response)}))
                except RuntimeError as e:
                    frames.append((i, None, {"trace": trace_id,
                                             "error": "draining",
                                             "detail": str(e)}))
            if not frames:
                self._json(400, {"error": "bad_stream",
                                 "detail": "empty stream (no frames in body)"},
                           trace_id=stream_id)
                return
            # One deadline for the whole stream, not one per frame.
            deadline = time.monotonic() + request_timeout_s
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header(TRACE_HEADER, stream_id)
            self.end_headers()
            for i, fut, err in frames:
                if err is not None:
                    line: dict = {"frame": i, **err}
                else:
                    try:
                        row = fut.result(timeout=max(0.0, deadline - time.monotonic()))
                        line = {"frame": i, "trace": fut.trace_id,
                                **service.format_row(row)}
                    except TimeoutError:
                        line = {"frame": i, "trace": fut.trace_id,
                                "error": "timeout", "timeout_s": request_timeout_s}
                    except RuntimeError as e:
                        line = {"frame": i, "trace": fut.trace_id,
                                "error": "forward_failed", "detail": str(e)}
                try:
                    self._chunk(json.dumps(line).encode("utf-8") + b"\n")
                except OSError:
                    # The client hung up: stop writing to a dead socket.
                    self.close_connection = True
                    return
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return _Server((host, port), Handler)
