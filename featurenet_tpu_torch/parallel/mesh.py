"""The mesh's data and model axes over ``torch.distributed`` (port of
``featurenet_tpu/parallel/mesh.py``).

The reference lays a ``('data', 'model')`` mesh over its devices and lets
XLA's SPMD partitioner insert every collective of the one compiled step.
The port runs one process per card, so its mesh is a record of ranks:
``make_mesh`` lays ``data × model`` over the world's processes (one
``MeshDevice`` each, rank ``d·M + m`` at row ``d``, column ``m``),
``mesh_summary`` is its JSON identity, ``feed_shards`` says which row group
of the global batch this process feeds (processes that share a data row
feed the same rows), ``row_block`` which global rows those are and
``depth_block`` which depth planes of them this process computes on under
``spatial`` (the reference's ``batch_sharding``/``batch_shardings``), and
``clamp_model_axis`` degrades a preset's model axis to what the world can
hold. ``train_mesh`` is the mesh a run trains on; it refuses what is not
ported: a segmenter on a model axis, and a depth that the model axis
cannot split evenly at every stride and pool.

The model axis has the reference's two uses (``ModelAxis``, made by
``model_axis`` with its process groups, laid on a model by
``FeatureNet.shard``):

- channel (tensor) parallelism: ``param_shardings``/``state_shardings``
  (``_param_spec``, ``_MIN_SHARD_DIM``) column-shard every kernel whose
  output axis is at least 64 and divides over the model axis, and the
  optimizer moments with it; biases, batch norm and small kernels stay
  replicated. The port's conv kernels are ``[K,K,K,Cin,Cout]`` as the
  reference's, its dense weights ``[out, in]`` (``F.linear``), so their
  output axis is dim 0 there. Without ``spatial`` a sharded layer
  computes its own output channels on the full input (``model_enter``
  before, ``model_gather`` of the channels after);
- spatial partitioning: each model rank computes on its depth slab of
  the grid; a conv exchanges ``(K-1)/2`` halo planes with its neighbours
  (``halo_exchange``) and a sharded kernel is gathered whole for it
  (``weight_gather``, whose backward sums the slabs' partials and keeps
  this rank's columns).

The collectives the compiled step would hold are made explicit here, and
none of them runs without a process group:

- ``all_reduce_sum``: a differentiable sum over the world or a group
  (forward and backward both all-reduce), the global batch-norm
  statistics of ``models/featurenet.py`` and the segmentation loss's
  batch sums;
- ``model_sum``: a sum over the model axis whose backward is the identity,
  for sums whose result feeds compute every model rank repeats (the GAP
  head after the slabs' partial sums); ``model_enter``: the identity
  whose backward sums over the model axis, where replicated compute
  enters a column-parallel layer;
- ``model_gather``/``weight_gather``: a differentiable all-gather over
  the model axis; the backward keeps this rank's part (``model_gather``:
  what follows is replicated) or sums the parts first (``weight_gather``:
  a reduce-scatter of the slabs' partials);
- ``halo_exchange``: the depth planes of the neighbouring model ranks
  around this rank's slab, zeros at the grid's ends; its backward adds
  the gradient of the planes each rank lent back to the lender's;
- ``all_reduce_flat``: one all-reduce over a flat buffer of tensors (with
  ``mean``, then a division by the group's size): the gradients and the
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
tensors goes through the host; the gathers copy to the host themselves
and move bytes (any dtype travels as ``uint8``).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence

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


def check_spatial(cfg, model: int) -> None:
    """Refuse a depth that ``model`` slabs cannot split evenly at every
    stride and pool of ``cfg.arch`` (each slab must be a whole number of
    strides and pool windows), or whose slabs are thinner than a conv's
    halo."""
    a, r = cfg.arch, cfg.resolution
    for i, (s, p) in enumerate(zip(a.strides, a.pool_after)):
        unit = s * (2 if p else 1)
        if r % (model * unit):
            raise ValueError(
                f"spatial: depth {r} at block {i} does not split evenly over "
                f"model axis {model} (each slab must hold a multiple of "
                f"{unit} planes: stride {s}{', then a 2x pool' if p else ''});"
                " choose a resolution the model axis divides at every pool, "
                "or pass --no-spatial")
        k = a.kernels[i]
        if s == 1:
            halo, slab = k // 2, r // model
        else:  # the space-to-depth conv's taps (ops/stem.py)
            taps = [(j - (k - s) // 2) // s for j in range(k)]
            halo, slab = max(-min(taps), max(taps)), r // model // s
        if slab < halo:
            raise ValueError(
                f"spatial: block {i}'s slab of {slab} planes is thinner "
                f"than its {k}^3 conv's halo ({halo} planes)")
        r = r // s // (2 if p else 1)


def train_mesh(cfg, device: str = "") -> Mesh:
    """The mesh a run of ``cfg`` trains on in this world: the model axis
    clamped to the world (with a ``mesh_warning`` when that changes it),
    the data axis ``cfg.mesh_data`` or the rest. Refused with a model axis
    above 1: ``task="segment"`` (the segmenter trains on the data axis
    alone), and under ``spatial`` a depth the axis cannot split evenly."""
    from featurenet_tpu_torch import obs

    _, world = rank_world()
    model = clamp_model_axis(cfg.mesh_model, world)
    if model != cfg.mesh_model:
        obs.warn("mesh_warning",
                 f"mesh_model={cfg.mesh_model} does not divide the {world} "
                 f"process(es); running with mesh_model={model}")
    if model > 1 and cfg.task == "segment":
        raise ValueError(
            f"mesh_model={model} with task='segment' is not ported: the "
            "segmenter trains on the data axis alone; pass --mesh-model 1")
    if model > 1 and cfg.spatial:
        check_spatial(cfg, model)
    return make_mesh(cfg.mesh_data, model, devices=world_devices(device))


def depth_block(mesh: Mesh, depth: int,
                process_index: Optional[int] = None) -> tuple[int, int]:
    """``[lo, hi)``: the depth planes of a ``depth``-deep grid that this
    process computes on when ``spatial`` splits depth over ``model`` (the
    reference's ``batch_sharding(mesh, spatial=True)``)."""
    p = rank_world()[0] if process_index is None else process_index
    model = mesh.devices.shape[1]
    cols = [m for row in mesh.devices for m, d in enumerate(row)
            if d.process_index == p]
    if not cols:
        raise ValueError(f"process {p} owns no devices in this mesh")
    if depth % model:
        raise ValueError(f"depth {depth} does not split over model axis "
                         f"{model}")
    n = depth // model
    return cols[0] * n, (cols[0] + 1) * n


# --- parameter sharding rules (channel tensor parallelism) ----------------

# Kernels whose output-channel axis is at least this large are sharded over
# 'model'; smaller ones are replicated (collective latency would dominate).
_MIN_SHARD_DIM = 64


def _out_axis(name: str, ndim: int) -> Optional[int]:
    """The output axis of a port kernel: a conv ``...kernel``
    ``[K,K,K,Cin,Cout]`` its last, a dense ``...weight`` ``[out, in]`` its
    first (the transpose of the reference's ``[in, out]``); ``None`` for
    what the reference does not call a kernel."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel" and ndim >= 1:
        return ndim - 1
    if leaf == "weight" and ndim == 2:
        return 0
    return None


def _param_spec(name: str, shape, model_axis_size: int) -> tuple:
    """The reference's rule on a port tensor: per dim ``"model"`` or
    ``None`` (a ``PartitionSpec``'s entries); ``()`` is replicated."""
    shape = tuple(shape)
    if model_axis_size <= 1 or not shape:
        return ()
    axis = _out_axis(name, len(shape))
    if axis is None:
        return ()
    out_dim = shape[axis]
    if out_dim >= _MIN_SHARD_DIM and out_dim % model_axis_size == 0:
        return tuple("model" if i == axis else None for i in range(len(shape)))
    return ()


def shard_dim(name: str, shape, model_axis_size: int) -> Optional[int]:
    """The dim ``_param_spec`` shards over ``model``, or ``None``."""
    spec = _param_spec(name, shape, model_axis_size)
    return spec.index("model") if "model" in spec else None


def param_shardings(params, mesh: Mesh) -> dict[str, tuple]:
    """``{name: spec}`` for named parameters (a module's
    ``named_parameters()`` or a name → tensor dict): column parallelism
    for the large kernels, everything else replicated; with ``model=1``
    all replicated (the pure data-parallel pod64)."""
    msize = mesh.shape["model"]
    items = params.items() if isinstance(params, dict) else params
    return {n: _param_spec(n, t.shape, msize) for n, t in items}


def state_shardings(state, mesh: Mesh) -> dict[str, dict]:
    """The specs of a train state in the checkpoint's layout: the model's
    ``state_dict`` (batch-norm statistics replicate), and the optimizer's
    moments ``mu``/``nu``, which follow their parameter's rule, so a
    column-parallel kernel's moments live on the same shard as it;
    ``count`` and the loss-scale state replicate."""
    msize = mesh.shape["model"]
    model = state.model
    names = [n for n, _ in model.named_parameters()]
    full = full_shapes(model)
    out = {"model": {k: _param_spec(k, full.get(k, v.shape), msize)
                     for k, v in model.state_dict().items()}}
    opt = state.optimizer
    for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
        out[key] = {n: _param_spec(n, full.get(n, t.shape), msize)
                    for n, t in zip(names, moments)}
    out.update(count=(), loss_scale=(), good_steps=())
    return out


def full_shapes(model) -> dict[str, tuple]:
    """The whole (unsharded) shape of each parameter of ``model``: a
    sharded one's local shape times the model axis along its dim."""
    axis = getattr(model, "axis", None)
    dims = getattr(model, "shard_dims", {})
    out = {}
    for n, p in model.named_parameters():
        shape = list(p.shape)
        if n in dims:
            shape[dims[n]] *= axis.size
        out[n] = tuple(shape)
    return out


# --- the model axis ---------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """This process's place on a ``data × model`` mesh and the process
    groups of its collectives: ``group`` the ranks of its data row (the
    model axis), ``data_group`` those of its model column (the data axis);
    ``None`` for the world's group, or for a group of one, which no
    collective runs over.
    ``spatial``: each model rank computes on its depth slab."""

    size: int = 1
    index: int = 0
    spatial: bool = False
    data_size: int = 1
    data_index: int = 0
    group: Any = None
    data_group: Any = None

    def slab(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's depth slab of full-depth grids ``x [B, D, ...]``
        (``x`` itself unless ``spatial``)."""
        if not self.spatial:
            return x
        n = x.shape[1] // self.size
        return x[:, self.index * n:(self.index + 1) * n]


def axis_of(module) -> ModelAxis:
    """The ``ModelAxis`` that ``module`` (a model or a block) is laid on;
    one laid on none (``FeatureNet.shard`` not called, or a model axis of
    1) is data-parallel over the world: every rank on the data axis, the
    data axis's group the world's."""
    axis = getattr(module, "axis", None)
    if axis is not None:
        return axis
    rank, world = rank_world()
    return ModelAxis(data_size=world, data_index=rank)


def model_axis(mesh: Mesh, spatial: bool = False) -> ModelAxis:
    """The ``ModelAxis`` of this process on ``mesh``, with one process
    group per data row and per model column (every rank makes every group,
    in one order, as ``dist.new_group`` requires). A mesh whose model axis
    is 1 needs no group and ignores ``spatial``, as the reference does."""
    data, model = mesh.devices.shape
    rank = rank_world()[0]
    place = [(d, m) for d in range(data) for m in range(model)
             if mesh.devices[d, m].process_index == rank]
    if not place:
        raise ValueError(f"process {rank} owns no devices in this mesh")
    d, m = place[0]
    if model == 1:
        return ModelAxis(data_size=data, data_index=d)
    if any(mesh.devices[r, c].process_index != r * model + c
           for r in range(data) for c in range(model)):
        raise ValueError("the mesh's ranks are not laid out row-major (rank "
                         "= data row x model axis + column)")
    rows = [[r * model + c for c in range(model)] for r in range(data)]
    cols = [[r * model + c for r in range(data)] for c in range(model)]
    groups = [dist.new_group(r) for r in rows]
    data_groups = [dist.new_group(c) for c in cols]
    return ModelAxis(size=model, index=m, spatial=bool(spatial),
                     data_size=data, data_index=d, group=groups[d],
                     data_group=data_groups[m] if data > 1 else None)


def _gather(t: torch.Tensor, axis: ModelAxis) -> list[torch.Tensor]:
    """Every model rank's ``t`` (one shape), in model order: an all-gather
    of its bytes, through the host for CUDA tensors under ``gloo``."""
    t = t.contiguous()
    host = t.is_cuda and dist.get_backend(axis.group) == "gloo"
    raw = (t.cpu() if host else t).view(-1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(axis.size)]
    dist.all_gather(parts, raw, group=axis.group)
    out = [p.view(t.dtype).view(t.shape) for p in parts]
    return [p.to(t.device) for p in out] if host else out


@torch.no_grad()
def gather_shards(t: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """The whole tensor of which every model rank holds a column shard
    ``t`` along ``dim`` (not differentiable): a checkpoint's layout."""
    return torch.cat(_gather(t, axis), dim=dim)


def take_shard(t: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """This model rank's column shard of the whole tensor ``t``."""
    return t.chunk(axis.size, dim)[axis.index]


def _reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _reduce(x, axis.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum of ``x`` over the model axis; the backward hands each rank
    the output's gradient as it is, for a sum whose result feeds compute
    that every model rank repeats alike (the GAP head of a spatial run)."""
    return _ModelSum.apply(x, axis)


class _ModelEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.axis.group), None


def model_enter(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x``, replicated over the model axis, entering a column-parallel
    layer: the identity, whose backward sums the ranks' partial gradients
    (each rank's comes from its own output channels)."""
    return _ModelEnter.apply(x, axis)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, reduce):
        ctx.axis, ctx.dim, ctx.reduce = axis, dim, reduce
        return torch.cat(_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        axis = ctx.axis
        if ctx.reduce:
            grad = _reduce(grad, axis.group)
        return grad.chunk(axis.size, dim=ctx.dim)[axis.index].contiguous(), \
            None, None, None


def model_gather(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated along ``dim`` in model order
    (a column-parallel layer's output channels); the backward keeps this
    rank's part of the gradient, the compute after it being repeated alike
    on every model rank."""
    return _Gather.apply(x, axis, dim % x.dim(), False)


def weight_gather(w: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """A column-sharded kernel made whole for a slab's conv: the model
    ranks' shards concatenated along ``dim``; the backward sums the
    slabs' partial gradients over the model axis and keeps this rank's
    columns (a reduce-scatter)."""
    return _Gather.apply(w, axis, dim % w.dim(), True)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, axis):
        ctx.lo, ctx.hi, ctx.axis = lo, hi, axis
        d, m = x.shape[1], axis.index
        parts = _gather(torch.cat([x[:, :hi], x[:, d - lo:]], dim=1), axis)
        shape = list(x.shape)
        below = (parts[m - 1][:, hi:] if m > 0 else
                 x.new_zeros([shape[0], lo] + shape[2:]))
        above = (parts[m + 1][:, :hi] if m < axis.size - 1 else
                 x.new_zeros([shape[0], hi] + shape[2:]))
        return torch.cat([below, x, above], dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi, axis = ctx.lo, ctx.hi, ctx.axis
        d, m = g.shape[1] - lo - hi, axis.index
        own = g[:, lo:lo + d].clone()
        parts = _gather(torch.cat([g[:, :lo], g[:, lo + d:]], dim=1), axis)
        if m < axis.size - 1:  # my last lo planes were the next rank's halo
            own[:, d - lo:] += parts[m + 1][:, :lo]
        if m > 0:  # my first hi planes were the previous rank's
            own[:, :hi] += parts[m - 1][:, lo:]
        return own, None, None, None


def halo_exchange(x: torch.Tensor, lo: int, hi: int,
                  axis: ModelAxis) -> torch.Tensor:
    """This rank's depth slab ``x [B, d, ...]`` with ``lo`` planes of the
    previous model rank's slab below and ``hi`` of the next one's above
    (zeros past the grid's ends, which is SAME padding): ``[B, lo+d+hi,
    ...]``. Differentiable: the gradient of each lent plane goes back to
    its owner and is added there."""
    if max(lo, hi) > x.shape[1]:
        raise ValueError(f"halo of {lo}+{hi} planes around a slab of "
                         f"{x.shape[1]}")
    return _Halo.apply(x, lo, hi, axis)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the world (or ``group``), differentiable: the
    gradient of each rank's input is the sum of every rank's output
    gradient."""
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor],
                    mean: bool = False, group=None) -> list[torch.Tensor]:
    """The sum (or with ``mean`` the mean) over the world (or ``group``)
    of each of ``tensors`` (one dtype), by one all-reduce of a flat
    buffer; returns new tensors of their shapes."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
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
