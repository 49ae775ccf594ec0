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


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None):
    """Flax's dropout: keep with probability ``1-rate``, scale by its inverse."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
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
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = self.conv(x)
        with record_function("casts"):
            y = y.float()
        with record_function("bn_relu"):
            if train:
                axes = (0, 1, 2, 3)
                mean = y.mean(dim=axes)
                var = torch.clamp((y * y).mean(dim=axes) - mean * mean, min=0.0)
                with torch.no_grad():
                    self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                    self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
            else:
                mean, var = self.mean, self.var
            y = (y - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias
            y = F.relu(y)
        with record_function("casts"):
            return y.to(self.dtype)


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

    def forward(self, voxels: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits; ``train=True`` uses and updates batch statistics and
        applies dropout with ``generator``."""
        a = self.arch
        with record_function("casts"):
            x = voxels.to(self.dtype)
        for block, f, s, p in zip(self.blocks, a.features, a.strides,
                                  a.pool_after):
            y = block(x, train)
            if a.residual and s == 1 and x.shape[-1] == f:
                y = y + x  # identity skip; pooling stays outside the branch
            x = max_pool2(y) if p else y
        if a.head_gap:
            x = x.float().mean(dim=(1, 2, 3)).to(self.dtype)
        else:
            x = x.reshape(x.shape[0], -1)
        with record_function("casts"):
            w0, b0, w1, b1 = (t.to(self.dtype) for t in (
                self.dense0.weight, self.dense0.bias, self.dense1.weight,
                self.dense1.bias))
        x = F.relu(F.linear(x, w0, b0))
        if train:
            x = dropout(x, a.dropout, generator)
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
