"""The serving programs: one per batch and precision, built ahead of
traffic (port of the serving half of ``featurenet_tpu/runtime/registry.py``:
``serve_program_name``, the ``serve``/``serve_bf16``/``serve_int8`` specs,
``Runtime.build`` and ``Runtime.warmup``).

The reference compiles one XLA executable per (program, batch) before the
first request, so a dispatch is one call into a compiled program. On the
card the counterpart is a CUDA graph: ``ServeProgram`` captures the serving
forward of one weight generation at one batch over a static fp32 input
``[b, R, R, R, 1]``, and a call copies the batch into that buffer, replays
the graph and returns a clone of its probabilities (the next replay
overwrites them; a segmenter's program returns int8 per-voxel labels, its
argmax made inside the graph). The captured body is the eager forward the
caller hands in, per-dispatch weight transforms included (the bf16 working copy through
``functional_call``, int8's dequantize), so a replay reads the weights the
generation holds at the addresses it held at capture.

How a generation's programs are captured (``ServePrograms``), and why:

- Each batch first runs eagerly ``WARMUP_ITERS`` times on the capture
  stream, so the kernels' libraries are loaded, every kernel instance's
  attributes are set and cuDNN has chosen its algorithms outside capture.
- The capture runs with ``capture_error_mode="thread_local"`` on the
  generation's own stream: a reload captures on an HTTP worker thread
  while the batcher's thread replays the live generation and reads back.
- The generation's programs share one memory pool of their own, never the
  live generation's; the largest batch is captured first. Graphs that
  share a pool must not run at once, so one lock per generation is held
  across the copy-in, the replay and the clone-out.
- The input is always copied into the static buffer, never swapped for
  another tensor: the kernels' launch plans read data pointers at capture.

A capture or replay that fails on the card raises; nothing falls back to
the eager forward. On the CPU, which a caller must ask for, a program is
the eager forward itself.

``TrainProgram`` is the training counterpart (the reference's
``multi_train_step`` and ``hbm_train_step`` programs): k train steps, each
drawing on the device, captured as one CUDA graph over the live train
state. Its warmup runs train for real, so the state is copied before the
warmup and copied back after the capture; the capture runs on a stream of
its own with ``capture_error_mode="thread_local"`` (the input threads and
the checkpoint writer go on with their own CUDA calls meanwhile), and the
step's draw generators are registered with the graph, which reads their
seeds at each replay.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from featurenet_tpu_torch.ops import launch_counts
from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS

# The eager runs of a batch on the capture stream before its capture.
WARMUP_ITERS = 3


def serve_program_name(precision: str) -> str:
    """The name of the serving program at one precision: ``serve``,
    ``serve_bf16`` or ``serve_int8`` (the one precision → program
    mapping)."""
    if precision not in SERVE_PRECISIONS:
        raise ValueError(f"unknown serving precision {precision!r}; one of "
                         f"{', '.join(SERVE_PRECISIONS)}")
    return "serve" if precision == "fp32" else f"serve_{precision}"


class ServeProgram:
    """One serving program: ``body`` at one batch, captured as a CUDA graph
    on the card, the eager ``body`` on the CPU. Built by ``ServePrograms``,
    whose lock, memory pool and stream it shares.

    ``capture_s`` is the wall time of the eager warmup and the capture;
    ``capture_launches`` the kernel launches recorded into the graph, by
    kernel (``ops.launch_counts``); ``graph`` is ``None`` on the CPU.
    """

    def __init__(self, name: str, body: Callable[[torch.Tensor], torch.Tensor],
                 batch: int, resolution: int, device: torch.device,
                 lock: threading.Lock, pool=None, stream=None):
        self.name = name
        self.batch = int(batch)
        self.shape = (self.batch, resolution, resolution, resolution, 1)
        self.device = device
        self._body = body
        self._lock = lock
        self.graph = None
        self.capture_s = 0.0
        self.capture_launches: dict[str, int] = {}
        if device.type == "cuda":
            self._capture(pool, stream)

    @torch.inference_mode()
    def _capture(self, pool, stream) -> None:
        t0 = time.perf_counter()
        self.static_in = torch.zeros(self.shape, dtype=torch.float32,
                                     device=self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP_ITERS):
                self._body(self.static_in)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.static_out = self._body(self.static_in)
        after = launch_counts()
        self.capture_launches = {k: after[k] - before[k] for k in after}
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    @torch.inference_mode()
    def __call__(self, voxels: torch.Tensor) -> torch.Tensor:
        """The body's output (probabilities ``[batch, classes]``, or a
        segmenter's int8 labels ``[batch, R, R, R]``) for ``voxels`` of
        this program's shape (on the card or the host; copied in on the
        card), on the program's device."""
        if tuple(voxels.shape) != self.shape:
            raise ValueError(f"{self.name}: input {tuple(voxels.shape)}, "
                             f"program {self.shape}")
        with self._lock:
            if self.graph is None:
                return self._body(voxels)
            self.static_in.copy_(voxels)
            self.graph.replay()
            return self.static_out.clone()


class ServePrograms:
    """The serving programs of one weight generation, one per batch,
    memoized: ``get(batch)`` builds (captures) a batch's program at first
    use. ``body`` is the generation's eager forward
    (``[b,R,R,R,1]`` fp32 → probabilities). The programs share one lock,
    and on the card one stream and one memory pool, all their own."""

    def __init__(self, precision: str,
                 body: Callable[[torch.Tensor], torch.Tensor],
                 resolution: int, device: torch.device):
        self.name = serve_program_name(precision)
        self.body = body
        self.resolution = resolution
        self.device = device
        self.lock = threading.Lock()
        self._programs: dict[int, ServeProgram] = {}
        self._pool = self._stream = None
        if device.type == "cuda":
            with torch.cuda.device(device):
                self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)

    def get(self, batch: int) -> ServeProgram:
        batch = int(batch)
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        with self.lock:
            prog = self._programs.get(batch)
            if prog is None:
                prog = ServeProgram(self.name, self.body, batch,
                                    self.resolution, self.device, self.lock,
                                    self._pool, self._stream)
                self._programs[batch] = prog
            return prog

    def build(self, batches) -> None:
        """Build the programs of ``batches``, the largest first (the
        smaller ones then reuse its pool's memory)."""
        for b in sorted({int(b) for b in batches}, reverse=True):
            self.get(b)

    def batches(self) -> list[int]:
        with self.lock:
            return sorted(self._programs)


# The eager runs of a train program's body on the capture stream before its
# capture: one loads the kernels and sets their attributes.
TRAIN_WARMUP_ITERS = 1


class TrainProgram:
    """``body`` (k train steps of ``state`` on inputs the caller holds at
    fixed addresses; returns the last step's metrics) captured as one CUDA
    graph on ``device``. ``generators`` are the CUDA generators ``body``
    draws from. A call replays the graph (the caller reseeds the
    generators and fills the inputs first) and returns a clone of its
    metrics; ``state.step`` is the caller's to advance.

    ``capture_s`` is the wall time of the warmup, the capture and the
    state's restore; ``capture_launches`` the kernel launches recorded
    into the graph, by kernel.
    """

    def __init__(self, name: str, body: Callable[[], dict], state,
                 generators, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"{name}: a train program is a CUDA graph; on "
                             f"{device} run the steps eagerly")
        self.name = name
        self.device = device
        t0 = time.perf_counter()
        tensors = state.tensors()
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        step = state.step
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(TRAIN_WARMUP_ITERS):
                body()
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = launch_counts()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self._out = body()
        after = launch_counts()
        torch.cuda.current_stream(device).wait_stream(stream)
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        state.step = step
        self.graph = graph
        self.capture_launches = {k: after[k] - before[k] for k in after}
        self.capture_s = time.perf_counter() - t0

    def __call__(self) -> dict:
        self.graph.replay()
        return {k: v.clone() for k, v in self._out.items()}
