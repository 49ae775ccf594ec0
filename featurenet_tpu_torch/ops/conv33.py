"""The 3³ stride-1 SAME convolution as 27 tap-shifted channel matmuls on the
channels-last grid (port of ``featurenet_tpu/ops/conv33.py``, the
``conv_backend="fused33"`` lowering)::

    out = Σ_{kz,ky,kx}  shift(x, kz-1, ky-1, kx-1) @ w[kz, ky, kx]

Each term is a ``[B·D·H·W, Cin] × [Cin, Cout]`` matmul read straight from
the NDHWC grid: a "shift" is a slice of the once-padded grid. The JAX
package computes each term with ``preferred_element_type=float32`` and
casts the sum once; ``torch.matmul`` on bf16 would round every term to
bf16, so here the operands are widened to fp32 instead (a bf16 or fp16
product is exact in fp32), the terms summed in fp32 (TF32 stays off, as
PyTorch's default is), and the sum cast to ``x``'s dtype once.

The JAX module is pure ``jnp``, not a Pallas kernel, so this is a plain
PyTorch module; its gradients come from autograd, as the JAX ones come
from autodiff.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def fused33_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3³ stride-1 SAME conv of ``x [B,D,H,W,Cin]`` with ``w
    [3,3,3,Cin,Cout]``: ``w`` cast to ``x``'s dtype, the 27 terms summed in
    fp32, the result in ``x``'s dtype."""
    if tuple(w.shape[:3]) != (3, 3, 3):
        raise ValueError(f"fused33_conv is specialized to 3^3 kernels; got "
                         f"{tuple(w.shape)}")
    if x.dim() != 5 or w.shape[3] != x.shape[4]:
        raise ValueError(f"fused33_conv: want x [B,D,H,W,Cin] and w "
                         f"[3,3,3,Cin,Cout], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    d, h, wd = x.shape[1:4]
    wf = w.to(x.dtype).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    acc = None
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                term = xp[:, kz:kz + d, ky:ky + h, kx:kx + wd, :] @ wf[kz, ky, kx]
                acc = term if acc is None else acc + term
    return acc.to(x.dtype)


class Fused33Conv(nn.Module):
    """Stride-1 SAME 3³ conv block backed by ``fused33_conv`` (no bias).

    ``kernel`` is ``[3,3,3,Cin,Cout]`` fp32, the parameter of the JAX
    module (which Flax names ``Conv_0``, as ``nn.Conv``'s, so one checkpoint
    serves both the ``xla`` and ``fused33`` lowerings). Activations stay in
    ``dtype``.
    """

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 dtype: torch.dtype = torch.bfloat16, conv=fused33_conv):
        super().__init__()
        if kernel_size != 3:
            raise ValueError(f"Fused33Conv is the 3^3 specialization; got "
                             f"kernel {kernel_size}")
        self.kernel = nn.Parameter(torch.empty((3, 3, 3, cin, features)))
        self.dtype = dtype
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.to(self.dtype), self.kernel)
