"""Metric logging: one JSON line per record on a stream, plus a history
(port of ``featurenet_tpu/utils/logging.py``'s ``MetricLogger``, without
TensorBoard or run events).

A record is ``{"step", "kind", <metrics>..., "samples_per_sec"}``; the
rate covers the wall time since the window started, data wait included.
Reading the metrics copies them to the host, which waits for the device.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any

import torch


class MetricLogger:
    def __init__(self, stream=None):
        self.stream = stream or sys.stdout
        self.history: list[dict[str, Any]] = []
        self._window_start: float | None = None
        self._window_samples = 0

    def start_window(self) -> None:
        self._window_start = time.perf_counter()
        self._window_samples = 0

    def count_samples(self, n: int) -> None:
        self._window_samples += n

    def log(self, step: int, metrics: dict, prefix: str = "train") -> dict:
        record: dict[str, Any] = {"step": int(step), "kind": prefix}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.item() if v.dim() == 0 else v.tolist()
            record[k] = float(v) if isinstance(v, (int, float)) else v
        if self._window_start is not None and self._window_samples:
            dt = time.perf_counter() - self._window_start
            record["samples_per_sec"] = self._window_samples / max(dt, 1e-9)
            self.start_window()
        self.history.append(record)
        print(json.dumps(record), file=self.stream, flush=True)
        return record
