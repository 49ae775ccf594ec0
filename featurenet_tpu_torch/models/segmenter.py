"""The per-voxel segmenter in PyTorch (port of
``featurenet_tpu/models/segmenter.py``, the ``seg64`` model).

A U-Net over the classifier's ``ConvBNRelu`` blocks, NDHWC end to end:

- Input context (``input_context``): the occupancy grid, then with
  ``"proj"`` or ``"proj_coords"`` the mean occupancy along each spatial
  axis broadcast back over it (in fp32), then with ``"proj_coords"`` the
  normalized coordinate ``linspace(0, 1, n)`` along each axis; the
  channels are concatenated in that order and only then cast to ``dtype``.
- Encoder: per width ``f`` of ``features``, a stride-1 3³ block (its output
  is the stage's skip) and a stride-2 3³ block. The stride-2 blocks run
  through the space-to-depth conv (``ops/stem.py``), as the reference's
  ``stem_s2d`` does; SAME padding for K=3, s=2 on an even size is 0 before
  and 1 after, the plan's ``(0, 1)``.
- Bottleneck: ``bottleneck_blocks`` stride-1 blocks of ``2·features[-1]``.
- Decoder: per stage, from the deepest, a 2³/stride-2 transposed conv with
  bias to ``f`` channels, the skip concatenated after it on channels, and
  ``decoder_blocks`` stride-1 blocks of ``f``.
- Head: a 1³ conv with bias to ``num_classes + 1`` logits (class 0 is
  background), returned in fp32.

Every stride-1 block uses the ``xla`` backend (``F.conv3d``), as the
reference builds the segmenter without a ``conv_backend`` and so takes
``nn.Conv``; the segmenter runs no kernel of this package.

The transposed conv is Flax's ``nn.ConvTranspose`` (``transpose_kernel=
False``, SAME padding): with k = 2 and stride 2 each output voxel ``2i+r``
takes one tap, ``x[i] · kernel[1-r]``, where ``F.conv_transpose3d`` takes
``x[i] · weight[r]``. The parameter keeps Flax's ``[2,2,2,Cin,Cout]``
layout and is flipped on every spatial axis at the call. Its bias and the
head's are added after the product in ``dtype``, as Flax adds them.

Parameter names map Flax's scopes one to one (``convert.from_flax``):
``ConvBNRelu_i`` → ``blocks.i`` (in creation order: the encoder's pairs,
the bottleneck, the decoder's refine blocks), ``ConvTranspose_j`` →
``ups.j`` and ``Conv_0`` → ``head``. ``forward(voxels, train=...)`` takes
the mode explicitly, as the classifier does; batch norm runs as there,
with the global batch's statistics in a data-parallel world of more than
one process (``ConvBNRelu``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from featurenet_tpu_torch.data.synthetic import NUM_CLASSES
from featurenet_tpu_torch.models.featurenet import ConvBNRelu, _lecun_normal_

INPUT_CONTEXTS = ("none", "proj", "proj_coords")


def context_channels(input_context: str) -> int:
    """The input channels of ``input_context``: the grid, its three axis
    projections, their three coordinates."""
    if input_context not in INPUT_CONTEXTS:
        raise ValueError(f"input_context {input_context!r} not in {INPUT_CONTEXTS}")
    return {"none": 1, "proj": 4, "proj_coords": 7}[input_context]


def input_context(voxels: torch.Tensor, mode: str) -> torch.Tensor:
    """``[B, D, H, W, 1]`` voxels → the fp32 input channels of ``mode``
    (see the module docstring), concatenated on the last axis."""
    v = voxels.float()
    chans = [v]
    if mode != "none":
        for ax in (1, 2, 3):
            chans.append(v.mean(dim=ax, keepdim=True).expand_as(v))
    if mode == "proj_coords":
        for ax in (1, 2, 3):
            n = v.shape[ax]
            shape = [1, 1, 1, 1, 1]
            shape[ax] = n
            coord = torch.linspace(0.0, 1.0, n, device=v.device).reshape(shape)
            chans.append(coord.expand_as(v))
    return torch.cat(chans, dim=-1)


def conv_transpose_2s2(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Flax's ``ConvTranspose(kernel_size=2, strides=2, padding="SAME")``
    of NDHWC ``x`` in x's dtype: ``kernel`` ``[2,2,2,Cin,Cout]`` flipped
    spatially for ``F.conv_transpose3d``, the bias added after."""
    w = kernel.to(x.dtype).flip((0, 1, 2)).permute(3, 4, 0, 1, 2)
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w, stride=2)
    return y.permute(0, 2, 3, 4, 1) + bias.to(x.dtype)


class ConvTranspose(nn.Module):
    """2³/stride-2 transposed conv with bias; parameters fp32 in Flax's
    layout (``kernel [2,2,2,Cin,Cout]``, ``bias [Cout]``)."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((2, 2, 2, cin, features)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("casts"):
            x = x.to(self.dtype)
        with record_function("conv_transpose"):
            return conv_transpose_2s2(x, self.kernel, self.bias)


class Head(nn.Module):
    """The 1³ conv with bias: a channel matmul in ``dtype``, the bias
    added after."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((1, 1, 1, cin, features)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("casts"):
            x = x.to(self.dtype)
            w = self.kernel.to(self.dtype).reshape(self.kernel.shape[3:])
        return torch.matmul(x, w) + self.bias.to(self.dtype)


class FeatureNetSegmenter(nn.Module):
    """Dense per-voxel classifier: ``[B, R, R, R, 1]`` occupancy → fp32
    logits ``[B, R, R, R, num_classes + 1]``; R must be divisible by
    ``2**len(features)``."""

    def __init__(self, features: Sequence[int] = (32, 64, 128),
                 num_classes: int = NUM_CLASSES,
                 dtype: torch.dtype = torch.bfloat16,
                 input_context: str = "none", decoder_blocks: int = 1,
                 bottleneck_blocks: int = 1):
        super().__init__()
        self.features = tuple(features)
        self.num_classes = num_classes
        self.dtype = dtype
        self.input_context = input_context
        self.decoder_blocks = decoder_blocks
        self.bottleneck_blocks = bottleneck_blocks

        def block(cin, f, stride=1):
            return ConvBNRelu(cin, f, 3, stride, dtype, "xla", plain=False)

        blocks, ups = [], []
        cin = context_channels(input_context)
        for f in self.features:
            blocks += [block(cin, f), block(f, f, stride=2)]
            cin = f
        for _ in range(bottleneck_blocks):
            blocks.append(block(cin, 2 * self.features[-1]))
            cin = 2 * self.features[-1]
        for f in reversed(self.features):
            ups.append(ConvTranspose(cin, f, dtype))
            cin = 2 * f
            for _ in range(decoder_blocks):
                blocks.append(block(cin, f))
                cin = f
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        self.head = Head(cin, num_classes + 1, dtype)

    def forward(self, voxels: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits; ``train=True`` uses and updates the batch statistics.
        ``generator`` is accepted for the train step's signature and not
        read: the segmenter has no dropout."""
        down = 2 ** len(self.features)
        if voxels.shape[1] % down:
            raise ValueError(f"grid {voxels.shape[1]} not divisible by {down}")
        with record_function("input_context"):
            x = input_context(voxels, self.input_context)
        with record_function("casts"):
            x = x.to(self.dtype)
        blocks = iter(self.blocks)
        skips = []
        for _ in self.features:
            x = next(blocks)(x, train)
            skips.append(x)
            x = next(blocks)(x, train)
        for _ in range(self.bottleneck_blocks):
            x = next(blocks)(x, train)
        for up, skip in zip(self.ups, reversed(skips)):
            x = torch.cat([up(x), skip], dim=-1)
            for _ in range(self.decoder_blocks):
                x = next(blocks)(x, train)
        x = self.head(x)
        with record_function("casts"):
            return x.float()


@torch.no_grad()
def init_segmenter_weights(model: FeatureNetSegmenter,
                           seed: int) -> FeatureNetSegmenter:
    """Random weights from ``seed``: lecun-normal kernels (fan-in over the
    taps and input channels), zero biases, identity batch norm. Matches
    the JAX init in distribution, not in values."""
    g = torch.Generator().manual_seed(int(seed))
    for block in model.blocks:
        k = block.conv.kernel
        _lecun_normal_(k, k.shape[0] ** 3 * k.shape[3], g)
        block.scale.fill_(1.0)
        block.bias.zero_()
        block.mean.zero_()
        block.var.fill_(1.0)
    for conv in (*model.ups, model.head):
        k = conv.kernel
        _lecun_normal_(k, k.shape[0] ** 3 * k.shape[3], g)
        conv.bias.zero_()
    return model
