"""The program catalog and the serving programs, built ahead of traffic
(port of ``featurenet_tpu/runtime/registry.py`` without its executable
cache: ``PROGRAMS``, ``list_programs``, ``program_precision``,
``serve_program_name``, the ``serve*`` and ``serve_packed*`` specs,
``Runtime.build`` and ``Runtime.warmup``).

The reference compiles one XLA executable per (program, batch) before the
first request, so a dispatch is one call into a compiled program. On the
card the counterpart is a CUDA graph: ``ServeProgram`` captures the serving
forward of one weight generation at one batch over a static fp32 input
``[b, R, R, R, 1]``, and a call copies the batch into that buffer, replays
the graph and returns a clone of its probabilities (the next replay
overwrites them; a segmenter's program returns int8 per-voxel labels, its
argmax made inside the graph). A ``serve_packed*`` program (classify only)
takes a static bit-packed ``uint8 [b, R, R, R/8]`` input instead, unpacks
it inside the graph (``train/steps.py`` ``unpack_voxels``) and returns
the argmax labels as ``int32 [b]``: a wire batch of 256 parts at R=64 is
8 MiB packed against 256 MiB of float32. The captured body is the eager forward the
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

``warmup`` builds every applicable catalog program the port builds ahead
(the serving graphs of each precision at the bucket ladder, the packed
ones at ``global_batch``, the k-step ``TrainProgram``) and reports the
rest as skipped with the reason; ``cli programs --warm`` prints it.

Each built program carries a ``cost`` dict and emits one ``program_cost``
event after its ``program_compile`` (``obs/perf.py``): ``flops``, the
analytic count of its work when the caller gives one (``ops/flops.py``: a
serving program's forward per sample × batch, a train program's step ×
batch × k), and on the card ``peak_bytes``. For a serving program that is
the rise of ``torch.cuda.max_memory_allocated`` across its warmup and
capture (what it added to the process's high-water mark, not its own
peak: 0 when a larger program built earlier had already set it). For a
train program it is the process's ``max_memory_allocated`` read after the
capture, as the Trainer's eager step reads it: weights, optimizer state
and resident data included, so the two kinds of train program compare.

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

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from featurenet_tpu_torch import obs
from featurenet_tpu_torch.config import Config
from featurenet_tpu_torch.obs import perf as _perf
from featurenet_tpu_torch.ops import launch_counts
from featurenet_tpu_torch.serve.batcher import DEFAULT_BUCKETS
from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS

# The eager runs of a batch on the capture stream before its capture.
WARMUP_ITERS = 3


def serve_program_name(precision: str, packed: bool = False) -> str:
    """The name of the serving program at one precision: ``serve``,
    ``serve_bf16``, ``serve_int8`` or, ``packed``, ``serve_packed``,
    ``serve_packed_bf16``, ``serve_packed_int8`` (the one precision →
    program mapping)."""
    if precision not in SERVE_PRECISIONS:
        raise ValueError(f"unknown serving precision {precision!r}; one of "
                         f"{', '.join(SERVE_PRECISIONS)}")
    base = "serve_packed" if packed else "serve"
    return base if precision == "fp32" else f"{base}_{precision}"


def _always(cfg: Config) -> bool:
    return True


def _classify(cfg: Config) -> bool:
    return cfg.task == "classify"


# The reference's catalog: name → (doc, applicable), its docs verbatim.
PROGRAMS: dict[str, tuple[str, Callable[[Config], bool]]] = {
    "init": ("sharded state init", _always),
    "train_step": ("one fused fwd+bwd+optimizer+BN step", _always),
    "multi_train_step": ("k train steps fused into one executable",
                         lambda cfg: cfg.steps_per_dispatch > 1),
    "hbm_train_step": (
        "train steps sampling batches from the HBM-resident split",
        lambda cfg: cfg.hbm_cache),
    "eval_step": ("exact-sum eval forward; serve-precision-variant", _always),
    "serve": ("serving forward, fp32 weights", _always),
    "serve_bf16": ("serving forward, bf16 working-copy weights", _always),
    "serve_int8": ("serving forward, int8 per-channel weights", _always),
    "serve_packed": ("packed-wire serving forward (bench/mesh)", _classify),
    "serve_packed_bf16": (
        "packed-wire serving forward, bf16 working-copy weights", _classify),
    "serve_packed_int8": ("packed-wire serving forward, int8 weights",
                          _classify),
}

# The programs whose weights run at the training precision, and the one at
# the serving precision; the serving programs name theirs.
TRAIN_PRECISION_PROGRAMS = frozenset(
    {"init", "train_step", "multi_train_step", "hbm_train_step"})
SERVE_PRECISION_PROGRAMS = frozenset({"eval_step"})

# What warmup cannot build: the resident split exists only once a run
# materializes it, and the port runs these eagerly, with nothing to build
# ahead.
_NEEDS_RUNTIME_ARGS = frozenset({"hbm_train_step"})
_EAGER = frozenset({"init", "train_step", "eval_step"})


def program_precision(cfg: Config, name: str) -> str:
    """The weight precision of one catalog program under ``cfg``."""
    if name.endswith("int8"):
        return "int8"
    if name.endswith("bf16"):
        return "bf16"
    if name in TRAIN_PRECISION_PROGRAMS:
        return cfg.train_precision
    if name in SERVE_PRECISION_PROGRAMS:
        return cfg.serve_precision
    return "fp32"


def list_programs(cfg: Config) -> list[dict]:
    """The catalog for ``cfg``, built nothing: one row per program with
    its ``program``, ``doc``, ``precision`` and ``applicable``."""
    return [{"program": name, "doc": doc,
             "precision": program_precision(cfg, name),
             "applicable": bool(applicable(cfg))}
            for name, (doc, applicable) in PROGRAMS.items()]


class ServeProgram:
    """One serving program: ``body`` over a static input of ``shape`` and
    ``dtype`` (batch first), captured as a CUDA graph on the card, the
    eager ``body`` on the CPU. Built by ``ServePrograms``, whose lock,
    memory pool and stream it shares.

    ``capture_s`` is the wall time of the eager warmup and the capture;
    ``capture_launches`` the kernel launches recorded into the graph, by
    kernel (``ops.launch_counts``); ``graph`` is ``None`` on the CPU. Each
    build is a ``program_compile`` event (the reference's name for a
    program built ahead), then a ``program_cost`` event of ``cost``:
    ``flops_per_sample`` × batch when given, and on the card
    ``peak_bytes``, the rise of the process's peak across the capture.
    """

    def __init__(self, name: str, body: Callable[[torch.Tensor], torch.Tensor],
                 shape: tuple, dtype: torch.dtype, device: torch.device,
                 lock: threading.Lock, pool=None, stream=None,
                 precision: Optional[str] = None,
                 flops_per_sample: Optional[float] = None):
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.batch = self.shape[0]
        self.dtype = dtype
        self.device = device
        self._body = body
        self._lock = lock
        self.graph = None
        self.capture_s = 0.0
        self.capture_launches: dict[str, int] = {}
        cost: dict = {}
        if flops_per_sample is not None:
            cost["flops"] = float(flops_per_sample) * self.batch
        if device.type == "cuda":
            before = _perf.peak_allocated(device)
            self._capture(pool, stream)
            cost["peak_bytes"] = _perf.peak_allocated(device) - before
        obs.emit("program_compile", program=name, batch=self.batch,
                 dur_s=round(self.capture_s, 3),
                 source="capture" if self.graph is not None else "eager")
        self.cost = _perf.emit_program_cost(
            name, cost, _perf.local_device_peaks(device), precision,
            batch=self.batch)

    @torch.inference_mode()
    def _capture(self, pool, stream) -> None:
        t0 = time.perf_counter()
        self.static_in = torch.zeros(self.shape, dtype=self.dtype,
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
        """The body's output (probabilities ``[batch, classes]``, a
        segmenter's int8 labels ``[batch, R, R, R]``, or a packed program's
        int32 labels ``[batch]``) for ``voxels`` of this program's shape
        and dtype (on the card or the host; copied in on the card), on the
        program's device."""
        if tuple(voxels.shape) != self.shape or voxels.dtype != self.dtype:
            raise ValueError(f"{self.name}: input {tuple(voxels.shape)} "
                             f"{voxels.dtype}, program {self.shape} {self.dtype}")
        with self._lock:
            if self.graph is None:
                return self._body(voxels)
            self.static_in.copy_(voxels)
            self.graph.replay()
            return self.static_out.clone()


class ServePrograms:
    """The serving programs of one weight generation, one per batch,
    memoized: ``get(batch)`` builds (captures) a batch's program at first
    use. ``body`` is the generation's eager forward: ``[b,R,R,R,1]`` fp32
    → probabilities, or with ``packed`` ``[b,R,R,R/8]`` uint8 → int32
    labels. The programs share one lock, and on the card one stream and
    one memory pool, all their own. ``flops_per_sample`` (the forward's
    analytic count; None for a segmenter) gives each program its
    ``flops``."""

    def __init__(self, precision: str,
                 body: Callable[[torch.Tensor], torch.Tensor],
                 resolution: int, device: torch.device, packed: bool = False,
                 flops_per_sample: Optional[float] = None):
        self.name = serve_program_name(precision, packed=packed)
        self.precision = precision
        self.flops_per_sample = flops_per_sample
        self.body = body
        self.resolution = resolution
        self.packed = packed
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
                r = self.resolution
                shape, dtype = (((batch, r, r, r // 8), torch.uint8)
                                if self.packed else
                                ((batch, r, r, r, 1), torch.float32))
                prog = ServeProgram(self.name, self.body, shape, dtype,
                                    self.device, self.lock, self._pool,
                                    self._stream, self.precision,
                                    self.flops_per_sample)
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
    into the graph, by kernel. ``cost`` (``flops`` when given, and
    ``peak_bytes``, the process's peak allocated bytes after the capture)
    is emitted as a ``program_cost`` event after the ``program_compile``
    event of the capture.
    """

    def __init__(self, name: str, body: Callable[[], dict], state,
                 generators, device: torch.device,
                 precision: Optional[str] = None,
                 flops: Optional[float] = None):
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
        launched = launch_counts()
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
        self.capture_launches = {k: after[k] - launched[k] for k in after}
        self.capture_s = time.perf_counter() - t0
        cost = {} if flops is None else {"flops": float(flops)}
        cost["peak_bytes"] = _perf.peak_allocated(device)
        obs.emit("program_compile", program=name,
                 dur_s=round(self.capture_s, 3), source="capture")
        self.cost = _perf.emit_program_cost(
            name, cost, _perf.local_device_peaks(device), precision)

    def __call__(self) -> dict:
        self.graph.replay()
        return {k: v.clone() for k, v in self._out.items()}


def _record(progs: list, precision: str, t0: float) -> dict:
    """One warmup record of a program family built as ``progs``."""
    launches: dict[str, int] = {}
    for p in progs:
        for k, v in p.capture_launches.items():
            launches[k] = launches.get(k, 0) + v
    return {"source": "capture" if progs[0].graph is not None else "eager",
            "build_s": round(time.perf_counter() - t0, 4),
            "precision": precision, "batches": [p.batch for p in progs],
            "capture_launches": launches}


def _warm_k_step(cfg: Config, device: torch.device) -> dict:
    """The streamed k-step ``TrainProgram`` of ``cfg`` captured on zero
    wire batches by a throwaway Trainer (its cache, when it names one,
    must exist); on the CPU the k steps run eagerly, with nothing to
    build."""
    import os

    from featurenet_tpu_torch.data.synthetic import WIRE_KEYS, generate_batch, to_wire
    from featurenet_tpu_torch.train.loop import Trainer

    precision = program_precision(cfg, "multi_train_step")
    if device.type != "cuda":
        return {"source": "eager", "build_s": 0.0, "precision": precision,
                "capture_launches": {}}
    if cfg.data_cache and not os.path.isdir(cfg.data_cache):
        return {"skipped": f"needs the data cache {cfg.data_cache!r}"}
    t0 = time.perf_counter()
    trainer = Trainer(dataclasses.replace(
        cfg, hbm_cache=False, checkpoint_dir=None, init_from=None,
        inject_faults=None, heartbeat_file=None), device=device)
    one = to_wire(generate_batch(np.random.default_rng(0), 1, cfg.resolution,
                                 num_features=cfg.num_features), cfg.task)
    k = cfg.steps_per_dispatch
    batches = [{key: torch.zeros((cfg.global_batch,) + one[key].shape[1:],
                                 dtype=torch.from_numpy(one[key]).dtype,
                                 device=device)
                for key in WIRE_KEYS[cfg.task]} for _ in range(k)]
    trainer.dispatch(batches, k)  # captures at its first use
    prog = trainer.programs[("streamed", k, trainer.state.precision)]
    torch.cuda.synchronize(device)
    return {"source": "capture", "build_s": round(time.perf_counter() - t0, 4),
            "precision": precision, "capture_launches": prog.capture_launches}


def warmup(cfg: Config, device="cuda", names: Optional[list[str]] = None,
           buckets=DEFAULT_BUCKETS, seed: int = 0) -> dict[str, dict]:
    """Build every requested applicable catalog program of ``cfg`` (all of
    them by default) that the port builds ahead, on seeded weights (the
    programs do not depend on the weights' values): per serving precision
    the ``serve*`` graphs at ``buckets`` and the ``serve_packed*`` graph at
    ``cfg.global_batch``, and the k-step ``TrainProgram`` where
    ``steps_per_dispatch > 1``. Returns per program ``{"source":
    "capture"|"eager", "build_s", "precision", "capture_launches"}``
    (serving ones also their ``batches``), or ``{"skipped": reason}``: a
    program that needs the resident split, or one the port runs eagerly."""
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    wanted = [n for n, (_, applicable) in PROGRAMS.items() if applicable(cfg)]
    if names is not None:
        unknown = sorted(set(names) - set(PROGRAMS))
        if unknown:
            raise ValueError(f"unknown programs {unknown}; the catalog holds "
                             f"{', '.join(PROGRAMS)}")
        wanted = [n for n in wanted if n in names]
    predictors: dict[str, Predictor] = {}
    out: dict[str, dict] = {}
    for name in wanted:
        if name in _NEEDS_RUNTIME_ARGS:
            out[name] = {"skipped": "needs resident-split arrays"}
            continue
        if name in _EAGER:
            out[name] = {"skipped": "runs eagerly in the port; nothing to "
                                    "build ahead"}
            continue
        if name == "multi_train_step":
            out[name] = _warm_k_step(cfg, dev)
            continue
        precision = program_precision(cfg, name)
        t0 = time.perf_counter()
        pred = predictors.get(precision)
        if pred is None:
            pred = predictors[precision] = Predictor.from_seed(
                cfg, seed, batch=max(buckets), device=dev, precision=precision)
        if name.startswith("serve_packed"):
            progs = [pred.packed_program_for(cfg.global_batch)]
        else:
            progs = [pred.program_for(b) for b in sorted(set(buckets), reverse=True)]
        out[name] = _record(progs, precision, t0)
    return out
