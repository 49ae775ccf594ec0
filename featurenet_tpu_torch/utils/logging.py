"""Metric logging: one JSON line per record on a stream, plus a history,
mirrored into the run's event stream and, with ``tb_dir``, into
TensorBoard (port of ``featurenet_tpu/utils/logging.py``'s
``MetricLogger``).

A record is ``{"step", "kind", <metrics>..., "samples_per_sec"}``; the
rate covers the wall time since the window started, data wait included.
Reading the metrics copies them to the host, which waits for the device:
in a run with a ``run_dir`` that wait is a ``readback`` span with
``src="metrics"``, and the record is also a ``metrics`` event. With
``tb_dir`` each record's float scalars go to
``torch.utils.tensorboard.SummaryWriter`` as ``<kind>/<name>`` at the
record's step (vector metrics stay JSON-only), as the reference writes
them through CLU.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any

import torch

from featurenet_tpu_torch import obs


class MetricLogger:
    def __init__(self, stream=None, tb_dir: str | None = None):
        self.stream = stream or sys.stdout
        self.history: list[dict[str, Any]] = []
        self._window_start: float | None = None
        self._window_samples = 0
        self._tb = None
        if tb_dir:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(tb_dir)

    def start_window(self) -> None:
        self._window_start = time.perf_counter()
        self._window_samples = 0

    def count_samples(self, n: int) -> None:
        self._window_samples += n

    def log(self, step: int, metrics: dict, prefix: str = "train") -> dict:
        record: dict[str, Any] = {"step": int(step), "kind": prefix}
        # The host copies wait for the device: in a run, that wait is
        # attributed as device time.
        with obs.span("readback", src="metrics", step=int(step)):
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
        obs.emit("metrics", kind=prefix,
                 **{k: v for k, v in record.items() if k != "kind"})
        if self._tb is not None:
            for k, v in record.items():
                if isinstance(v, float) and k != "step":
                    self._tb.add_scalar(f"{prefix}/{k}", v, int(step))
        return record

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
            self._tb = None
