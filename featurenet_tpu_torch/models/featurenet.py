"""The FeatureNet 3D-CNN voxel classifier in PyTorch (port of
``featurenet_tpu/models/featurenet.py``).

The JAX model's layout and precision are kept, so bridged weights give the
same logits:

- Activations stay NDHWC end to end; the flatten before ``Dense_0`` is in
  (d, h, w, c) order, which is the row order of the JAX kernel.
- Activations compute in ``dtype`` (bf16 by default); parameters and
  batch-norm statistics are fp32. Batch norm runs in fp32 as
  ``(x - mean) * (rsqrt(var + 1e-5) * scale) + bias``, then ReLU, then a
  cast to ``dtype``. Logits come out fp32.
- Strided blocks go through the space-to-depth stem (``ops/stem.py``),
  numerically the JAX ``stem_s2d`` path. Every stride-1 block goes
  through the arch's ``conv_backend``: ``"pallas"`` runs ``PallasConv``
  (the ``conv3d_p`` kernels for forward, dx and dW), ``"hybrid_dw"`` runs
  ``HybridConv`` (``F.conv3d`` forward and dx, the ``conv_dw_folded``
  kernel for dW); neither keeps the JAX VMEM fallback. ``"xla"``, the JAX
  default lowering (``nn.Conv``), runs ``HybridConv`` over ``conv3d_xla``:
  ``F.conv3d`` in the activation dtype with autograd, no kernel of this
  package. ``"fused33"`` runs its 3³ blocks through ``Fused33Conv``
  (``ops/conv33.py``, 27 tap-shifted channel matmuls summed in fp32) and
  any other stride-1 block through the ``xla`` block, as the JAX
  ``ConvBNRelu`` does.
- Parameters are fp32 masters; a reduced working copy (bf16, fp16, a
  dequantized int8 tree; ``train/precision.py``) can stand in for them
  through ``torch.func.functional_call``: each block casts what it reads
  as the JAX modules do, and batch norm computes in fp32 whatever the
  dtype of its ``scale`` and ``bias``.
- ``forward(voxels, train=...)`` takes the mode explicitly, as the JAX
  ``apply(..., train=...)`` does; ``nn.Module.training`` is not read.
  In train mode batch norm normalises with the batch's statistics, in
  fp32 with the biased variance ``mean(x²) - mean(x)²`` (Flax's
  ``use_fast_variance``), and moves the running statistics as
  ``0.9·running + 0.1·batch``; ``torch.nn.BatchNorm3d`` differs on both
  counts and is not used. Dropout applies after FC-128 with the
  caller's ``torch.Generator`` (Flax's mask: keep with probability
  ``1-rate``, scale kept values by ``1/(1-rate)``).
- In a ``torch.distributed`` world of more than one process (data
  parallelism, ``parallel/mesh.py``), each process holding an equal block
  of the global batch, the train mode computes what the reference's GSPMD
  step computes over the global batch: batch norm all-reduces each
  channel's sum and sum of squares (``all_reduce_sum``, whose backward
  all-reduces their gradients) and normalises with the global batch's
  statistics, so the running statistics stay equal on every rank; dropout
  draws the global batch's mask from the generator, which every rank
  seeds alike, and keeps its own rows. With one process (or none) no
  collective runs and nothing changes.
- On a model axis (``shard(axis)``, ``parallel/mesh.py`` ``ModelAxis``)
  the parameters that ``param_shardings`` shards are replaced by this
  rank's columns (``shard_dims`` says along which dim), and the forward
  computes what the one-process forward computes:

  - without ``spatial``, column parallelism: a block whose kernel is
    sharded computes its own output channels on the whole input
    (``model_enter`` before), batch norm on them with statistics over the
    data axis, then ``model_gather`` of the channels; the dense head's
    sharded ``dense0`` likewise, dropout applying the global mask's
    columns of this rank, so each model rank of a data row applies the
    same draw; everything else is repeated alike on every model rank,
    its batch norm's statistics over the data axis;
  - under ``spatial``, each model rank computes on its depth slab (convs
    through halo exchanges, a sharded kernel gathered whole), batch norm
    sums over every voxel of the global batch (data and model), ``max_pool2``
    and the residual add stay local, and the GAP head's slab partial sums
    go through ``model_sum``; the dense head is then column-parallel as
    above (a head without GAP first gathers the slabs' depth).

  ``grad_kinds`` says for each parameter how its gradient is reduced
  (``train/steps.py`` ``sync_gradients``).
- The 2³ max pool is ``F.max_pool3d`` on a channels-first view: its
  gradient goes to the first maximum of each window, as XLA's
  select-and-scatter does, where ``amax`` would split it among ties.
- The forward's dtype casts run inside the profiler range ``casts`` and
  batch norm with its ReLU inside ``bn_relu`` (``record_function``; with
  no profiler running they cost a few µs of host time), so a profile
  splits PyTorch's elementwise device time by op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from featurenet_tpu_torch.data.synthetic import NUM_CLASSES
from featurenet_tpu_torch.ops.conv3d import (
    HybridConv,
    PallasConv,
    conv3d_hybrid,
    conv3d_hybrid_plain,
    conv3d_p,
    conv3d_plain,
    conv3d_xla,
)
from featurenet_tpu_torch.ops.conv33 import Fused33Conv, fused33_conv
from featurenet_tpu_torch.ops.stem import SpaceToDepthConv
from featurenet_tpu_torch.parallel.mesh import (
    ModelAxis,
    all_reduce_sum,
    axis_of,
    halo_exchange,
    model_enter,
    model_gather,
    model_sum,
    shard_dim,
    weight_gather,
)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9

# conv_backend -> (block module, kernel conv, plain conv).
CONV_BACKENDS = {
    "pallas": (PallasConv, conv3d_p, conv3d_plain),
    "hybrid_dw": (HybridConv, conv3d_hybrid, conv3d_hybrid_plain),
    "xla": (HybridConv, conv3d_xla, conv3d_xla),
    "fused33": (Fused33Conv, fused33_conv, fused33_conv),
}


@dataclasses.dataclass(frozen=True)
class FeatureNetArch:
    """Architecture hyperparameters; defaults are the paper-shape stack:
    conv 32×7³/s2 → conv 32×5³ → pool → conv 64×3³ → conv 64×3³ → pool
    → FC-128 → FC-24."""

    features: Sequence[int] = (32, 32, 64, 64)
    kernels: Sequence[int] = (7, 5, 3, 3)
    strides: Sequence[int] = (2, 1, 1, 1)
    pool_after: Sequence[bool] = (False, True, False, True)
    hidden: int = 128
    dropout: float = 0.5
    num_classes: int = NUM_CLASSES
    head_gap: bool = False
    residual: bool = False
    # Backend of the stride-1 blocks: "pallas", "hybrid_dw", "xla" or
    # "fused33" (see the module docstring). The port's presets keep
    # "pallas", so its entry points run the hand-written kernels by
    # default; the JAX presets default to "xla", which loads and runs here
    # too.
    conv_backend: str = "pallas"

    def __post_init__(self):
        n = len(self.features)
        if not (len(self.kernels) == len(self.strides) == len(self.pool_after) == n):
            raise ValueError("arch lists must have equal length")
        if self.conv_backend not in CONV_BACKENDS:
            raise ValueError(
                f"unknown conv_backend {self.conv_backend!r}; one of "
                f"{sorted(CONV_BACKENDS)}"
            )


def tiny_arch(num_classes: int = NUM_CLASSES) -> FeatureNetArch:
    """The smoke16 arch: 2 conv blocks + head."""
    return FeatureNetArch(
        features=(16, 32), kernels=(3, 3), strides=(1, 1),
        pool_after=(True, True), hidden=64, dropout=0.2,
        num_classes=num_classes,
    )


def deep_arch(num_classes: int = NUM_CLASSES) -> FeatureNetArch:
    """The abc128 arch: deeper stack with a GAP head and residual skips."""
    return FeatureNetArch(
        features=(32, 64, 64, 128, 128, 256),
        kernels=(7, 3, 3, 3, 3, 3),
        strides=(2, 1, 1, 1, 1, 1),
        pool_after=(False, True, False, True, False, True),
        hidden=256, dropout=0.5, num_classes=num_classes,
        head_gap=True, residual=True,
    )


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2³/stride-2 VALID max pool over an NDHWC tensor."""
    y = F.max_pool3d(x.permute(0, 4, 1, 2, 3), kernel_size=2, stride=2)
    return y.permute(0, 2, 3, 4, 1)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            rows: tuple[int, int] = (1, 0), cols: tuple[int, int] = (1, 0)):
    """Flax's dropout: keep with probability ``1-rate``, scale by its inverse.
    ``x [B, N]`` is block ``r`` of ``rows = (R, r)`` row blocks of a global
    batch of ``R·B`` rows, and of its columns block ``c`` of ``cols = (C,
    c)``: the mask of the global ``[R·B, C·N]`` batch is drawn and this
    block of it kept."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    world, rank = rows
    b, n = x.shape[0], x.shape[-1]
    mask = torch.rand((b * world, *x.shape[1:-1], n * cols[0]),
                      generator=generator, device=x.device) < keep
    if world > 1:
        mask = mask[rank * b:(rank + 1) * b]
    if cols[0] > 1:
        mask = mask[..., cols[1] * n:(cols[1] + 1) * n]
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ConvBNRelu(nn.Module):
    """conv → batch norm (fp32) → ReLU → cast to ``dtype``."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int,
                 dtype: torch.dtype, backend: str, plain: bool):
        super().__init__()
        if stride > 1:
            if kernel < stride:
                raise ValueError(
                    f"strided block needs kernel >= stride, got {kernel}/{stride}"
                )
            self.conv = SpaceToDepthConv(cin, features, kernel, stride, dtype)
        else:
            if backend == "fused33" and kernel != 3:
                backend = "xla"  # the 3³ specialization only; as in JAX
            block, conv, plain_conv = CONV_BACKENDS[backend]
            self.conv = block(cin, features, kernel, dtype,
                              conv=plain_conv if plain else conv)
        self.stride = stride
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype
        # Set by FeatureNet.shard: the model axis and whether the conv's
        # kernel is column-sharded on it.
        self.axis: ModelAxis | None = None
        self.sharded = False

    def _stats_group(self):
        """``(group, ranks)``: where the batch statistics sum, ``ranks``
        equal blocks of the global batch's voxels (1: no collective)."""
        axis = axis_of(self)
        if axis.spatial:
            return None, axis.size * axis.data_size  # every voxel: the world
        return axis.data_group, axis.data_size

    def convolve(self, x: torch.Tensor) -> torch.Tensor:
        """The block's conv of ``x`` as it runs on its model axis: under
        ``spatial`` on this rank's depth slab with the neighbours' halo
        planes around it (``halo_exchange``: ``(K-1)/2`` each way for a
        stride-1 conv, cropped after; the stem's transformed padding,
        ``ops/stem.py``), a column-sharded kernel gathered whole first
        (``weight_gather``); otherwise the conv of ``x`` as it is (a
        column-parallel block's own output channels)."""
        axis = axis_of(self)
        if not axis.spatial:
            return self.conv(x)
        w = self.conv.kernel
        if self.sharded:
            w = weight_gather(w, axis, -1)
        if self.stride > 1:
            return self.conv(x, w, halo=lambda t, lo, hi: halo_exchange(
                t, lo, hi, axis))
        p, d = (w.shape[0] - 1) // 2, x.shape[1]
        return self.conv(halo_exchange(x, p, p, axis), w)[:, p:p + d]

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        axis = axis_of(self)
        cols = self.sharded and not axis.spatial  # column-parallel
        if cols:
            x = model_enter(x, axis)
        y = self.convolve(x)
        with record_function("casts"):
            y = y.float()
        with record_function("bn_relu"):
            scale, bias = self.scale, self.bias
            if cols:  # this rank's output channels
                part = slice(axis.index * y.shape[-1],
                             (axis.index + 1) * y.shape[-1])
                scale, bias = scale[part], bias[part]
            if train:
                axes = (0, 1, 2, 3)
                group, ranks = self._stats_group()
                if ranks > 1:
                    # The global batch's statistics: one all-reduce of both
                    # sums over the equal blocks.
                    n = y.numel() // y.shape[-1] * ranks
                    sums = all_reduce_sum(torch.stack(
                        [y.sum(dim=axes), (y * y).sum(dim=axes)]), group)
                    mean = sums[0] / n
                    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
                else:
                    mean = y.mean(dim=axes)
                    var = torch.clamp((y * y).mean(dim=axes) - mean * mean,
                                      min=0.0)
                with torch.no_grad():
                    stats = torch.stack([mean, var])
                    if cols:  # every channel's, so the buffers stay equal
                        stats = model_gather(stats, axis, -1)
                    self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * stats[0])
                    self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * stats[1])
            else:
                mean, var = self.mean, self.var
                if cols:
                    mean, var = mean[part], var[part]
            y = (y - mean) * (torch.rsqrt(var + BN_EPS) * scale) + bias
            y = F.relu(y)
        with record_function("casts"):
            y = y.to(self.dtype)
        return model_gather(y, axis, -1) if cols else y


class FeatureNet(nn.Module):
    """24-class voxel classifier: ``[B, R, R, R, 1]`` occupancy → fp32 logits.

    The stride-1 blocks run the kernels of ``arch.conv_backend``;
    ``plain=True`` gives the same model with every kernel replaced by its
    plain version, for comparison on the card.
    """

    def __init__(self, arch: FeatureNetArch, resolution: int,
                 dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        blocks, cin, r = [], 1, resolution
        for f, k, s, p in zip(arch.features, arch.kernels, arch.strides,
                              arch.pool_after):
            blocks.append(ConvBNRelu(cin, f, k, s, dtype, arch.conv_backend,
                                     plain))
            cin = f
            if r % s:
                raise ValueError(f"grid {r} not divisible by stride {s}")
            r //= s
            if p:
                r //= 2
        self.blocks = nn.ModuleList(blocks)
        flat = cin if arch.head_gap else cin * r ** 3
        if flat < 1:
            raise ValueError(f"resolution {resolution} pools away to nothing")
        self.dense0 = nn.Linear(flat, arch.hidden)
        self.dense1 = nn.Linear(arch.hidden, arch.num_classes)
        self.axis: ModelAxis | None = None
        # name -> the dim a parameter is column-sharded along (shard()).
        self.shard_dims: dict[str, int] = {}

    @torch.no_grad()
    def shard(self, axis: ModelAxis) -> "FeatureNet":
        """Lay the model on ``axis`` (see the module docstring): every
        parameter ``param_shardings`` shards becomes this rank's columns of
        it, in place of the whole. Call before an optimizer takes the
        parameters; a model axis of 1 changes nothing."""
        if self.axis is not None:
            raise ValueError("the model is already laid on a model axis")
        if axis.size == 1:
            return self
        self.axis = axis
        for name, p in list(self.named_parameters()):
            dim = shard_dim(name, p.shape, axis.size)
            if dim is None:
                continue
            owner, leaf = name.rsplit(".", 1)
            setattr(self.get_submodule(owner), leaf, nn.Parameter(
                p.chunk(axis.size, dim)[axis.index].clone()))
            self.shard_dims[name] = dim
        for i, block in enumerate(self.blocks):
            block.axis = axis
            block.sharded = f"blocks.{i}.conv.kernel" in self.shard_dims
        return self

    def grad_kinds(self) -> list[str]:
        """How each parameter's gradient (``parameters()`` order) is reduced
        on the model axis: ``"shard"`` a column shard, on its owner alone
        (a spatial slab's partials were summed by ``weight_gather``);
        ``"partial"`` a sum over the model ranks' parts (a spatial slab's
        partial, or a replicated vector of which a column-parallel layer
        used this rank's part); ``"replicated"`` the same on every model
        rank (compute every model rank repeats alike)."""
        axis = axis_of(self)
        out = []
        for name, _ in self.named_parameters():
            if name in self.shard_dims:
                out.append("shard")
            elif name.startswith("blocks."):
                i = int(name.split(".")[1])
                out.append("partial" if axis.spatial or self.blocks[i].sharded
                           else "replicated")
            elif name == "dense0.bias" and "dense0.weight" in self.shard_dims:
                out.append("partial")
            else:
                out.append("replicated")
        return out

    def forward(self, voxels: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits; ``train=True`` uses and updates batch statistics and
        applies dropout with ``generator``. On a spatial model axis
        ``voxels`` is this rank's depth slab (``ModelAxis.slab``)."""
        a, axis = self.arch, axis_of(self)
        with record_function("casts"):
            x = voxels.to(self.dtype)
        for block, f, s, p in zip(self.blocks, a.features, a.strides,
                                  a.pool_after):
            y = block(x, train)
            if a.residual and s == 1 and x.shape[-1] == f:
                y = y + x  # identity skip; pooling stays outside the branch
            x = max_pool2(y) if p else y
        if a.head_gap and axis.spatial:
            # The slabs' partial sums, summed over the model axis.
            n = x.shape[1] * axis.size * x.shape[2] * x.shape[3]
            x = (model_sum(x.float().sum(dim=(1, 2, 3)), axis) / n
                 ).to(self.dtype)
        elif a.head_gap:
            x = x.float().mean(dim=(1, 2, 3)).to(self.dtype)
        else:
            if axis.spatial:
                x = model_gather(x, axis, 1)
            x = x.reshape(x.shape[0], -1)
        with record_function("casts"):
            w0, b0, w1, b1 = (t.to(self.dtype) for t in (
                self.dense0.weight, self.dense0.bias, self.dense1.weight,
                self.dense1.bias))
        cols = "dense0.weight" in self.shard_dims
        if cols:  # column-parallel: this rank's hidden units
            h = w0.shape[0]
            x = model_enter(x, axis)
            b0 = b0[axis.index * h:(axis.index + 1) * h]
        x = F.relu(F.linear(x, w0, b0))
        if train:
            x = dropout(x, a.dropout, generator,
                        (axis.data_size, axis.data_index),
                        (axis.size, axis.index) if cols else (1, 0))
        if cols:
            x = model_gather(x, axis, -1)
        x = F.linear(x, w1, b1)
        with record_function("casts"):
            return x.float()


def _lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    # Flax's lecun_normal: a normal truncated at ±2σ, rescaled so the
    # truncated distribution keeps variance 1/fan_in.
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(model: FeatureNet, seed: int) -> FeatureNet:
    """Random weights from ``seed``: lecun-normal conv and dense kernels,
    zero biases, identity batch norm. Matches the JAX init in distribution,
    not in values."""
    g = torch.Generator().manual_seed(int(seed))
    for block in model.blocks:
        k = block.conv.kernel
        _lecun_normal_(k, k.shape[0] ** 3 * k.shape[3], g)
        block.scale.fill_(1.0)
        block.bias.zero_()
        block.mean.zero_()
        block.var.fill_(1.0)
    for dense in (model.dense0, model.dense1):
        _lecun_normal_(dense.weight, dense.in_features, g)
        dense.bias.zero_()
    return model
