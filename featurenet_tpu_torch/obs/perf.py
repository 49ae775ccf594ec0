"""Performance attribution: per-program cost, MFU and roofline accounting,
and the device-memory poller (port of ``featurenet_tpu/obs/perf.py``).

- **Per-program cost** (``program_cost`` events, ``emit_program_cost``).
  The reference reads an XLA executable's compiled cost and memory
  analyses. A CUDA graph or an eager train step has none, so the port's
  counters are:

  - ``flops``, the analytic count of ``ops/flops.py``: a serving program's
    forward per sample × its batch, a train program's
    ``train_step_flops_per_sample`` × batch × steps. It is the model's
    count, the same whichever conv backend runs the work. A profiler's
    count (``torch.utils.flop_counter``) is not used: it does not see the
    hand-written conv kernels, so a ``pallas`` program would read almost
    no conv FLOPs where an ``xla`` one reads them all. A segmenter's
    programs have no analytic count in the reference, so their ``flops``
    is absent;
  - ``peak_bytes``, measured, in two definitions. A serving program's is
    the rise of ``torch.cuda.max_memory_allocated`` across its graph's
    warmup and capture: what it added to the process's high-water mark,
    not its own peak (0 when a larger bucket captured first had set it).
    A train program's, graphed or eager, is the process's
    ``max_memory_allocated`` itself, read after the capture or at the
    eager step's first paced wait: weights, optimizer state and resident
    data included, so ``hbm_peak_train_bytes`` compares like with like;
  - ``bytes`` (bytes accessed) is absent, so the roofline verdict and
    ``achieved_bw_fraction`` are absent too, as the reference's contract
    allows for a partial capture.

- **Rolling MFU** (``observe_dispatch``): the train loop, the serving
  batcher and the Predictor fold each measured dispatch wall against the
  program's ``flops`` into the ``mfu`` window: FLOP/s over the device
  kind's peak. A device kind without a peak (the CPU, any card but the
  one in the table) is the ``unknown`` tier: no sample, never a guess.
- **Roofline** (``roofline``): arithmetic intensity against the ridge
  point; None whenever an input is missing.
- **Device memory** (``sample_device_memory``, ``Config.
  poll_device_memory``): on the heartbeat cadence, ``memory_allocated``,
  ``max_memory_allocated`` and the card's total memory per visible device
  as ``device_memory`` events.

Module-level imports are the standard library and ``obs.events``: ``cli
report`` reads the peak table and the roofline verdict from here where the
card and torch are gone. Everything that touches a device imports torch
inside the function.
"""

from __future__ import annotations

import sys
from typing import Optional

from featurenet_tpu_torch.obs import events as _events

# The card the port runs on, by ``torch.cuda.get_device_name()``: the H100
# SXM5 part. Its rates are NVIDIA's H100 datasheet figures (dense bf16
# tensor-core FLOP/s without sparsity, HBM3 bytes/s), a specification and
# not a measurement; they assume the card's full 700 W power limit. Every
# other name, the CPU's included, is the ``unknown`` tier. The one source
# of the port's peaks: ``ops/flops.py`` and ``chip_smoke.py``'s kernel
# bounds read this row.
H100 = "NVIDIA H100 80GB HBM3"

PEAK_FLOPS_BY_KIND: dict[str, float] = {
    H100: 989.4e12,
}

PEAK_BYTES_PER_SEC_BY_KIND: dict[str, float] = {
    H100: 3.35e12,
}


def device_peaks(device_kind: Optional[str]) -> dict:
    """The peak table's row for one device kind: ``tier`` is ``"known"``
    only when a peak FLOP/s entry exists; the ridge point (FLOPs per byte
    where compute and bandwidth bind equally) only when both peaks do."""
    kind = device_kind or "unknown"
    pf = PEAK_FLOPS_BY_KIND.get(kind)
    bw = PEAK_BYTES_PER_SEC_BY_KIND.get(kind)
    out: dict = {
        "device_kind": kind,
        "tier": "known" if pf else "unknown",
        "peak_flops": pf,
        "peak_bytes_per_sec": bw,
    }
    if pf and bw:
        out["ridge_flops_per_byte"] = pf / bw
    return out


def local_device_peaks(device="cpu") -> dict:
    """The peak row of ``device`` (a torch device or its name), keyed by
    the card's name (``torch.cuda.get_device_name``) or ``"cpu"``; the
    ``unknown`` tier when the kind cannot be read."""
    try:
        import torch

        device = torch.device(device)
        kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else device.type)
    except Exception:
        kind = None
    return device_peaks(kind)


def roofline(flops: Optional[float], bytes_accessed: Optional[float],
             peaks: Optional[dict]) -> Optional[str]:
    """``"compute-bound"`` / ``"memory-bound"`` by arithmetic intensity
    against the device's ridge point; None whenever an input is missing
    (an unknown device kind, a cost without ``bytes``)."""
    ridge = (peaks or {}).get("ridge_flops_per_byte")
    if not flops or not bytes_accessed or not ridge:
        return None
    return ("compute-bound" if flops / bytes_accessed >= ridge
            else "memory-bound")


def emit_program_cost(name: str, cost: dict, peaks: dict,
                      precision: Optional[str] = None, **extra) -> dict:
    """Emit one ``program_cost`` event for a built program: ``program``,
    ``device_kind``, ``precision`` when known, the cost's counters (those
    that are numbers >= 0) and ``extra`` (e.g. the batch). Returns the
    counters kept, for the caller to keep beside its program."""
    kept = {k: v for k, v in cost.items()
            if isinstance(v, (int, float)) and v >= 0}
    fields = {"precision": precision} if precision else {}
    _events.emit("program_cost", program=name,
                 device_kind=peaks.get("device_kind"), **fields, **kept,
                 **extra)
    return kept


def mfu_value(cost: Optional[dict], wall_s: float,
              peaks: Optional[dict]) -> Optional[float]:
    """Achieved MFU of one measured wall: ``flops`` over the wall over the
    device kind's peak, or None when the FLOPs, the peak or the wall is
    missing. The one formula the windows and a benchmark read."""
    if not cost or not peaks or wall_s <= 0:
        return None
    pf = peaks.get("peak_flops")
    fl = cost.get("flops")
    if not pf or not fl:
        return None
    return fl / wall_s / pf


def observe_dispatch(cost: Optional[dict], wall_s: float,
                     peaks: Optional[dict] = None) -> dict:
    """Fold one measured dispatch wall against its program's counters into
    the ``mfu`` / ``achieved_bw_fraction`` windows; returns the samples
    made, none when nothing is derivable (no cost, the unknown tier, a
    zero wall)."""
    out: dict = {}
    if not cost or not peaks or wall_s <= 0:
        return out
    from featurenet_tpu_torch.obs import windows as _windows

    m = mfu_value(cost, wall_s, peaks)
    if m is not None:
        out["mfu"] = m
        _windows.observe("mfu", m)
    bw = peaks.get("peak_bytes_per_sec")
    by = cost.get("bytes")
    if bw and by:
        out["achieved_bw_fraction"] = by / wall_s / bw
        _windows.observe("achieved_bw_fraction", out["achieved_bw_fraction"])
    return out


def peak_allocated(device) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of a CUDA ``device``; None on
    the host."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def sample_device_memory() -> list[dict]:
    """One ``device_memory`` event per visible card: ``bytes_in_use``
    (``memory_allocated``), ``peak_bytes_in_use`` (``max_memory_allocated``,
    never reset here: callers read the process's peak) and ``bytes_limit``
    (the card's total memory); a card the process holds no memory on is
    skipped. Returns ``[]`` without touching CUDA in a
    process that has not initialized it (a supervisor, ``cli report``), or
    where torch is not importable; never raises."""
    rows: list[dict] = []
    torch = sys.modules.get("torch")
    try:
        if torch is None or not torch.cuda.is_initialized():
            return rows
        count = torch.cuda.device_count()
        current = torch.cuda.current_device()
    except Exception:
        return rows
    for i in range(count):
        try:
            # A card this process holds no memory on has no context here;
            # mem_get_info would create one.
            if i != current and not torch.cuda.memory_reserved(i):
                continue
            row = {"device": i,
                   "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                   "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                   "bytes_limit": int(torch.cuda.mem_get_info(i)[1])}
        except Exception:
            continue
        rows.append(row)
        _events.emit("device_memory", **row)
    return rows
