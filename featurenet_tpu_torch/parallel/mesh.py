"""The mesh's data axis over ``torch.distributed`` (port of
``featurenet_tpu/parallel/mesh.py``).

The reference lays a ``('data', 'model')`` mesh over its devices and lets
XLA's SPMD partitioner insert every collective of the one compiled step.
The port runs one process per card, so its mesh is a record of ranks:
``make_mesh`` lays ``data × model`` over the world's processes (one
``MeshDevice`` each), ``mesh_summary`` is its JSON identity,
``feed_shards`` says which row group of the global batch this process
feeds, ``row_block`` which global rows those are (the reference's
``batch_sharding``/``batch_shardings`` over ``data``), and
``clamp_model_axis`` degrades a preset's model axis to what the world can
hold. Only the data axis is ported: a model axis above 1 (tensor
parallelism) and ``spatial`` partitioning are refused where a run is set
up (``train_mesh``).

The collectives the compiled step would hold are made explicit here, and
none of them runs without a process group:

- ``all_reduce_sum``: a differentiable sum over the world (forward and
  backward both all-reduce), the global batch-norm statistics of
  ``models/featurenet.py`` and the segmentation loss's batch sums;
- ``all_reduce_flat``: one all-reduce over a flat buffer of tensors (with
  ``mean``, then a division by the world size): the gradients and the
  step's metrics (``train/steps.py``), the eval sums (``train/loop.py``);
- ``broadcast_int``: a value of rank 0 on every rank (the step a resume
  restores, ``train/checkpoint.py``).

``init_from_env`` joins the world that ``torchrun`` describes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``); ``init_world`` joins one given explicitly, as each
generation of an elastic run does (``elastic/``, ``cli train --elastic``:
a fresh port per generation). The backend is ``nccl`` when every rank on the host has
a card of its own, and ``gloo`` on the CPU or when ranks share a card:
NCCL refuses two ranks on one device. Under ``gloo`` a collective on CUDA
tensors goes through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# The timeout of a process group that init_from_env joins, unless the
# caller gives one: a rank that dies leaves the others waiting this long.
DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass(frozen=True)
class MeshDevice:
    """One place in a mesh: the process that drives it and its device."""

    process_index: int
    device: str = ""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` is a ``[data, model]`` grid of ``MeshDevice``;
    ``backend`` the process group's, ``None`` without one."""

    devices: np.ndarray
    backend: Optional[str] = None
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def in_world() -> bool:
    """Whether this process belongs to a ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


def rank_world() -> tuple[int, int]:
    """This process's rank and the world size; ``(0, 1)`` without a
    process group."""
    if in_world():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def world_devices(device: str = "") -> list[MeshDevice]:
    """One ``MeshDevice`` per rank of the world, this rank's with
    ``device``."""
    rank, world = rank_world()
    return [MeshDevice(r, device if r == rank else "") for r in range(world)]


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """A ``('data', 'model')`` mesh over ``devices`` (default: one per rank
    of the world); ``data=None`` takes every device the model axis leaves."""
    devices = list(devices) if devices is not None else world_devices()
    n = len(devices)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} must divide device count {n}")
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} exceeds {n} devices")
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[:data * model]
    if backend is None and in_world():
        backend = dist.get_backend()
    return Mesh(grid.reshape(data, model), backend)


def mesh_summary(mesh: Mesh) -> dict:
    """JSON identity of a mesh: axis sizes, the device and process count,
    and the process group's backend when there is one."""
    out = {**{k: int(v) for k, v in mesh.shape.items()},
           "devices": int(mesh.devices.size),
           "processes": len({d.process_index for d in mesh.devices.flat})}
    if mesh.backend is not None:
        out["backend"] = mesh.backend
    return out


def feed_shards(mesh: Mesh, process_index: Optional[int] = None
                ) -> tuple[int, int]:
    """``(num_shards, shard_id)``: the global batch splits into
    ``num_shards`` equal row groups, and this process feeds group
    ``shard_id``. Processes that share a data row (a model axis spanning
    processes) feed the same group."""
    p = rank_world()[0] if process_index is None else process_index
    grid = mesh.devices
    rows = [r for r in range(grid.shape[0])
            if any(d.process_index == p for d in grid[r].flat)]
    k = len(rows)
    if not rows:
        raise ValueError(
            f"process {p} owns no devices in this mesh (shape "
            f"{dict(zip(mesh.axis_names, grid.shape))}); a feeding process "
            "must appear in the mesh")
    if rows != list(range(rows[0], rows[0] + k)):
        raise ValueError(f"process {p}'s devices occupy non-contiguous data "
                         f"rows {rows}; the host feed needs a contiguous block")
    data = grid.shape[0]
    if data % k:
        raise ValueError(f"data axis {data} not divisible by process "
                         f"row-block {k}")
    if rows[0] % k:
        raise ValueError(f"process {p}'s row block starts at {rows[0]}, not a "
                         f"multiple of its size {k}: row groups would overlap")
    return data // k, rows[0] // k


def row_block(mesh: Mesh, global_batch: int,
              process_index: Optional[int] = None) -> tuple[int, int]:
    """``[lo, hi)``: the rows of a global batch that this process holds."""
    num, shard = feed_shards(mesh, process_index)
    if global_batch % num:
        raise ValueError(f"global_batch {global_batch} must divide over "
                         f"{num} feed groups")
    local = global_batch // num
    return shard * local, (shard + 1) * local


def clamp_model_axis(model: int, n_devices: int) -> int:
    """The largest divisor of ``n_devices`` that is at most ``model``."""
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    m = min(model, n_devices)
    while n_devices % m:
        m -= 1
    return m


def train_mesh(cfg, device: str = "") -> Mesh:
    """The mesh a run of ``cfg`` trains on in this world: the model axis
    clamped to the world (with a ``mesh_warning`` when that changes it),
    the data axis ``cfg.mesh_data`` or the rest. A model axis above 1 and
    ``spatial`` with one are refused: only the data axis is ported."""
    from featurenet_tpu_torch import obs

    _, world = rank_world()
    model = clamp_model_axis(cfg.mesh_model, world)
    if model != cfg.mesh_model:
        obs.warn("mesh_warning",
                 f"mesh_model={cfg.mesh_model} does not divide the {world} "
                 f"process(es); running with mesh_model={model}")
    if model > 1:
        raise ValueError(
            f"mesh_model={model}: tensor parallelism (a model axis above 1) "
            "is not ported; only the data axis is"
            + (", and spatial partitioning rides the model axis"
               if cfg.spatial else ""))
    return make_mesh(cfg.mesh_data, model, devices=world_devices(device))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the world, differentiable: the gradient of
    each rank's input is the sum of every rank's output gradient."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    mean: bool = False) -> list[torch.Tensor]:
    """The sum (or with ``mean`` the mean) over the world of each of
    ``tensors`` (one dtype), by one all-reduce of a flat buffer; returns
    new tensors of their shapes."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    if mean:
        flat /= dist.get_world_size()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_int(value: Optional[int]) -> int:
    """Rank 0's ``value`` on every rank (other ranks pass anything)."""
    t = torch.tensor([-1 if value is None else int(value)], dtype=torch.int64,
                     device=_collective_device())
    dist.broadcast(t, src=0)
    return int(t.item())


def barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def choose_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when every one of the host's ``local_world`` ranks has a
    card of its own, else ``gloo`` (the CPU, or ranks sharing a card)."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_world(device: str, rank: int, world: int, local_rank: int,
               local_world: int, address: str,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[str, str]:
    """Join the process group of ``world`` ranks whose rank 0 serves its
    TCP store at ``address`` (``host:port``) as ``rank``; returns
    ``(device, backend)``: on the card ``cuda:local_rank % device_count``,
    made current. The backend is ``choose_backend``'s over the host's
    ``local_world`` ranks."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device "
                               "cpu to train on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = choose_backend(dev, local_world)
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return str(dev), backend


def init_from_env(device: str = "cuda",
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> tuple[str, str]:
    """Join the process group that ``torchrun``'s environment describes
    (``init_world`` with its ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``)."""
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in env]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment; "
                           f"{', '.join(missing)} not set")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    return init_world(device, rank, world, int(env.get("LOCAL_RANK", rank)),
                      int(env.get("LOCAL_WORLD_SIZE", world)),
                      f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", timeout_s)
