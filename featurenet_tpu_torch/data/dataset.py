"""Host-side input pipeline: seeded synthetic batches, produced in threads
and copied to the device (port of ``featurenet_tpu/data/dataset.py``'s
``SyntheticVoxelDataset``, with ``Prefetcher`` in place of
``prefetch_to_device``/``put_batch``: each process feeds its own device).

A data-parallel world shards the global batch by host: with ``num_hosts``
and ``host_id`` (``parallel/mesh.py`` ``feed_shards``) a dataset emits
``global_batch // num_hosts`` rows per batch, and refuses a global batch
that does not divide. Each producer worker owns an independent stream
(``SyntheticVoxelDataset.worker_iter``, seeded
``SeedSequence([seed, host_id, worker_id])``, the JAX package's fold) and a
fixed residue class of the ticket space (worker w fills tickets w, w+W,
w+2W, ...), so the merged stream depends only on (seed, workers), not on
thread scheduling. The workers are threads, as in the JAX package; numpy
releases the GIL for only part of a part's work, so how far they run in
parallel depends on the host. On the 8-core host of an H100 machine, 8
threads delivered about as many parts/s as one thread makes alone, and
slowed the thread that launches the train step (``chip_smoke.py``'s data
line and ``device_step_ms_producers_busy``).

A worker checks three fault sites (``faults.py``) at the top of each
ticket: ``producer_crash`` raises (surfacing as ``ProducerError``),
``producer_hang`` parks the worker until ``close()`` (the consumer starves,
and a supervisor's stall kill is the recovery), ``producer_slow`` sleeps
``SLOW_SLEEP_S``.

In a run with a ``run_dir`` (``obs/``) each worker gauges its batch time
(``producer_batch_s``, the generation alone, not the backpressure wait),
the consumer gauges the ready queue's depth after every pop
(``prefetch_queue_depth``, 0 when the consumer waited for the batch it
took) and feeds it to the ``queue_depth`` window, and a worker's error is
also a ``producer_error`` warning beside the supervisor's restart verdict.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Iterator

import numpy as np
import torch

from featurenet_tpu_torch import faults, obs
from featurenet_tpu_torch.data.synthetic import generate_batch, to_wire

# Batches each producer worker may have ready ahead of the consumer.
LOOKAHEAD = 2


class ProducerError(RuntimeError):
    """A producer worker died; raised in the consumer with the worker's
    traceback, the original exception chained as ``__cause__``."""

    def __init__(self, worker: int, tb: str):
        self.worker = worker
        super().__init__(f"prefetch producer worker {worker} died; worker "
                         f"traceback:\n{tb}")


class SyntheticVoxelDataset:
    """Infinite, seeded stream of synthetic feature batches in ``task``'s
    wire format (``synthetic.to_wire``: bit-packed voxels and mask, with
    labels for ``classify`` or the per-voxel int8 ``seg`` for
    ``segment``). ``num_features > 1`` carves that many features into each
    part (segmentation samples)."""

    def __init__(self, resolution: int = 64, global_batch: int = 96,
                 num_features: int = 1, seed: int = 0,
                 task: str = "classify", num_hosts: int = 1, host_id: int = 0):
        if global_batch % num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.resolution = resolution
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.num_features = num_features
        self.seed = seed
        self.task = task
        self.host_id = host_id

    def worker_iter(self, worker_id: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """An independent infinite stream of this host's rows for one
        producer worker."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, worker_id])
        )
        while True:
            yield to_wire(generate_batch(rng, self.local_batch, self.resolution,
                                         num_features=self.num_features),
                          self.task)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.worker_iter(0)


class Prefetcher:
    """Iterator of batches on ``device``, generated ahead by
    ``num_workers`` threads from ``source``, any object whose
    ``worker_iter(worker_id)`` gives one worker's stream of numpy wire
    batches (``SyntheticVoxelDataset``, ``offline.VoxelCacheDataset``).

    Each worker turns its numpy batch into tensors in pinned host memory
    (when ``device`` is CUDA); the consumer takes batches in ticket order
    and copies them with ``non_blocking=True``, so the copy overlaps the
    device's work. A worker may run at most ``LOOKAHEAD`` batches of its
    own ahead of the consumer. A worker's exception re-raises in the
    consumer as ``ProducerError``. ``close()`` stops the workers.
    """

    def __init__(self, source, device,
                 num_workers: int = 1):
        self.device = torch.device(device)
        self._pin = self.device.type == "cuda"
        self._workers = max(1, int(num_workers))
        self._lookahead = LOOKAHEAD * self._workers
        self._cond = threading.Condition()
        self._ready: dict[int, object] = {}
        self._next = 0
        self._stop = threading.Event()
        iters = [source.worker_iter(w) for w in range(self._workers)]
        self._threads = [
            threading.Thread(target=self._produce, args=(w, it), daemon=True,
                             name=f"prefetch-{w}")
            for w, it in enumerate(iters)
        ]
        for t in self._threads:
            t.start()

    def _produce(self, w: int, it) -> None:
        ticket = w
        try:
            while not self._stop.is_set():
                if faults.maybe_fail("producer_crash", batch=ticket):
                    raise faults.InjectedFault(f"producer_crash at ticket {ticket}")
                if faults.maybe_fail("producer_hang", batch=ticket):
                    self._stop.wait()
                    return
                if faults.maybe_fail("producer_slow", batch=ticket):
                    time.sleep(faults.SLOW_SLEEP_S)
                if obs.active():  # clock reads only in a run
                    t0 = time.perf_counter()
                    item = next(it)
                    obs.gauge("producer_batch_s",
                              round(time.perf_counter() - t0, 6), worker=w)
                else:
                    item = next(it)
                host = {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in item.items()}
                if self._pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
                with self._cond:
                    while (ticket >= self._next + self._lookahead
                           and not self._stop.is_set()):
                        self._cond.wait(0.1)
                    if self._stop.is_set():
                        return
                    self._ready[ticket] = host
                    self._cond.notify_all()
                ticket += self._workers
        except BaseException as e:  # surface in the consumer, never hang it
            err = ProducerError(w, traceback.format_exc())
            err.__cause__ = e
            with self._cond:
                self._ready[ticket] = err
                self._cond.notify_all()

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        with self._cond:
            while self._next not in self._ready:
                self._cond.wait(0.1)
            item = self._ready.pop(self._next)
            depth = len(self._ready)  # ready batches left after ours
            self._next += 1
            self._cond.notify_all()
        obs.gauge("prefetch_queue_depth", depth)
        obs.observe("queue_depth", depth)
        if isinstance(item, BaseException):
            if isinstance(item, ProducerError):
                obs.warn("producer_error",
                         f"prefetch worker {item.worker} died: "
                         f"{item.__cause__!r}", worker=item.worker)
            raise item
        return {k: v.to(self.device, non_blocking=True) for k, v in item.items()}

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
