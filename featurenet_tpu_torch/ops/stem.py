"""Space-to-depth reformulation of strided 3D convolutions (port of
``featurenet_tpu/ops/stem.py``).

A stride-``s`` SAME conv over ``x`` equals a stride-1 conv over the
space-to-depth transform of ``x`` (each s³ block of voxels becomes s³
channels) with a re-indexed weight. With ``p_lo = (K - s) // 2``, tap ``k``
of the original kernel lands at tap ``a = floor((k - p_lo) / s)`` and parity
``r = (k - p_lo) - s·a`` of the transformed one, whose kernel size is
``a_max - a_min + 1`` with asymmetric padding ``(-a_min, a_max)``.

The JAX package computes the stride-1 conv outside any Pallas kernel
(``_conv_s1`` hands it to XLA), so here it is ``F.conv3d``. ``F.conv3d``
pads symmetrically, and the 5³/s4 stem's transformed kernel is 2 wide with
padding (lo 0, hi 1), so the padding is applied with ``F.pad`` first.

On a spatial model axis ``x`` is a rank's depth slab of the grid. The slab
is transformed alone (its depth a multiple of the stride), and the caller's
``halo`` gives the transformed slab its depth padding ``(lo, hi)`` as
planes of the neighbours' transformed slabs (``parallel/mesh.py``
``halo_exchange``; zeros at the grid's ends are the SAME padding): for
abc128's 7³/s2 stem at R=128 over two ranks, rank r's output planes
``32r … 32r+31`` read input planes ``64r-2 … 64r+67``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function


def _plan(resolution: int, kernel: int, stride: int):
    """Static plan: ``(k2, (lo, hi), tap, parity)`` per axis."""
    if resolution % stride:
        raise ValueError(f"resolution {resolution} not divisible by stride {stride}")
    if kernel < stride:
        raise ValueError("space-to-depth needs kernel >= stride")
    pad_lo = (kernel - stride) // 2
    shifted = np.arange(kernel) - pad_lo
    tap = shifted // stride
    parity = shifted - tap * stride
    a_min, a_max = int(tap.min()), int(tap.max())
    return a_max - a_min + 1, (-a_min, a_max), tap - a_min, parity


def space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """[B, D, H, W, C] → [B, D/s, H/s, W/s, s³·C]; channel = ((rz·s+ry)·s+rx)·C + c."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // s, s, h // s, s, w // s, s, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, d // s, h // s, w // s, s * s * s * c)


@functools.lru_cache(maxsize=None)
def _scatter_index(resolution: int, kernel: int, stride: int,
                   device: torch.device) -> tuple:
    """``(k2, pads, index)``: where ``transform_weights`` scatters each tap,
    as index tensors on ``device``, made once per shape and device, so a
    forward copies nothing from the host (which would synchronise, and
    which a CUDA graph cannot capture). Made outside inference mode, so
    training forwards may index with them too."""
    k, s = kernel, stride
    k2, pads, tap, parity = _plan(resolution, k, s)
    kz, ky, kx = np.meshgrid(np.arange(k), np.arange(k), np.arange(k),
                             indexing="ij")
    pchan = (parity[kz] * s + parity[ky]) * s + parity[kx]
    with torch.inference_mode(False):
        index = tuple(
            torch.as_tensor(a.ravel(), device=device)
            for a in (tap[kz], tap[ky], tap[kx], pchan)
        )
    return k2, pads, index


def transform_weights(w: torch.Tensor, resolution: int, stride: int):
    """Scatter ``w[K,K,K,Cin,Cout]`` into the stride-1 weight
    ``w2[K2,K2,K2,s³·Cin,Cout]``; returns ``(w2, (lo, hi))``."""
    k, cin, cout = w.shape[0], w.shape[3], w.shape[4]
    s = stride
    k2, pads, index = _scatter_index(resolution, k, s, w.device)
    w2 = torch.zeros((k2, k2, k2, s ** 3, cin, cout), dtype=w.dtype,
                     device=w.device)
    w2[index] = w.reshape(k ** 3, cin, cout)
    return w2.reshape(k2, k2, k2, s ** 3 * cin, cout), pads


def _conv_s1(x2: torch.Tensor, w2: torch.Tensor, pads,
             depth_pads=None) -> torch.Tensor:
    lo, hi = pads
    dlo, dhi = pads if depth_pads is None else depth_pads
    xn = F.pad(x2.permute(0, 4, 1, 2, 3), (lo, hi, lo, hi, dlo, dhi))
    y = F.conv3d(xn, w2.permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def space_to_depth_conv(x: torch.Tensor, w: torch.Tensor, stride: int,
                        halo=None) -> torch.Tensor:
    """Stride-``s`` SAME conv of ``x [B,R,R,R,Cin]`` with ``w
    [K,K,K,Cin,Cout]``, computed as a stride-1 conv on s2d(x); with
    ``halo(x2, lo, hi)``, of a depth slab ``x [B,R/M,R,R,Cin]`` (see the
    module docstring)."""
    w2, pads = transform_weights(w, x.shape[2], stride)
    x2 = space_to_depth(x, stride)
    if halo is None:
        return _conv_s1(x2, w2, pads)
    return _conv_s1(halo(x2, *pads), w2, pads, (0, 0))


class SpaceToDepthConv(nn.Module):
    """Strided conv block (no bias) through the s2d reformulation; the
    parameter ``kernel`` keeps the ``[K,K,K,Cin,Cout]`` shape."""

    def __init__(self, cin: int, features: int, kernel_size: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        k = kernel_size
        self.kernel = nn.Parameter(torch.empty((k, k, k, cin, features)))
        self.stride = stride
        self.dtype = dtype

    def forward(self, x: torch.Tensor, w: torch.Tensor | None = None,
                halo=None) -> torch.Tensor:
        """``w``, when given, stands in for ``kernel``; ``halo`` as
        ``space_to_depth_conv``'s."""
        with record_function("casts"):
            w = self.kernel if w is None else w
            x, w = x.to(self.dtype), w.to(self.dtype)
        return space_to_depth_conv(x, w, self.stride, halo)
