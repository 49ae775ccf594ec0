"""Stride-1 SAME 3D convolution, odd K: the port of ``conv3d_p`` and
``conv3d_hybrid`` with their gradients.

Layouts are the JAX ones: activations NDHWC ``[B,D,H,W,C]``, kernels DHWIO
``[K,K,K,Cin,Cout]``.

- ``conv3d_fwd(x, w)``: the forward, fp32. On a CUDA tensor it launches the
  hand-written kernel in ``csrc/conv3d_fwd.cu`` (built with ``nvcc`` at
  first use, see ``ops/build.py``) with the launch ``fwd_plan`` gives, or
  raises; on a CPU tensor it runs ``conv3d_plain``, the K³ tap-shift sum
  in fp32.
- ``conv3d_dw(x, g, k)``: the weight gradient, fp32. On a CUDA tensor it
  launches ``csrc/conv3d_dw.cu`` (partial tiles over slabs of positions,
  then a slab sum in fixed order) with the launch ``dw_plan`` gives, or
  raises; on a CPU tensor it runs ``conv_dw_plain`` (``ops/conv_dw.py``).
- ``conv3d_p``: a ``torch.autograd.Function`` like the JAX ``custom_vjp``
  (``_vjp_bwd``): forward ``conv3d_fwd``; dx is ``conv3d_fwd`` of the
  cotangent with the kernel flipped in (z,y,x) and Cin↔Cout swapped
  (stride-1 SAME odd-K is its own transpose); dW is ``conv3d_dw``.
- ``conv3d_hybrid``: forward and dx through ``F.conv3d`` in the activation
  dtype, as the JAX package hands them to XLA; dW through the
  ``conv_dw_folded`` kernel (``ops/conv_dw.py``).
- ``conv3d_xla``: the JAX ``conv_backend="xla"`` lowering, a library conv
  the JAX package leaves to XLA: ``F.conv3d`` in the activation dtype,
  dx and dW by autograd. It runs no kernel of this package.
- ``conv3d_plain`` and ``conv3d_hybrid_plain`` compute the same functions
  with every kernel replaced by its plain version (gradients by autograd);
  ``chip_smoke.py`` holds the kernels' training step against them.

``conv3d_fwd_launches``, ``conv3d_dw_launches`` and
``conv3d_dw_sum_launches`` count kernel launches (one per call on a CUDA
tensor), so a run can show that its convolutions went through the kernels.

The TPU kernel's VMEM plan (``_pick_tz``, ``pallas_conv_supported``,
``dw_folded_supported``) is a TPU limit and is not carried over: every
stride-1 odd-K block runs the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from featurenet_tpu_torch.ops import build
from featurenet_tpu_torch.ops.conv_dw import (
    check_dw_args,
    check_launch_args,
    conv_dw_folded,
    conv_dw_plain,
    plan_slabs,
)

conv3d_fwd_launches = 0
conv3d_dw_launches = 0
conv3d_dw_sum_launches = 0

_INT_LIMIT = 2 ** 31 - 1

# csrc/conv3d_fwd.cu's launch: BM·BN = threads x outputs per thread, 256
# threads of 8x8; a grid of fewer blocks than SMs takes the small tile, 128
# threads of 8x4, which gives twice the threads for the same work.
FWD_TILE_AREA = 256 * 8 * 8
FWD_SMALL_TILE_AREA = 128 * 8 * 4

# csrc/conv3d_dw.cu's launch: BM·BN = threads (256) x outputs per thread
# (kTM·kTN = 8x8), kBK positions per chunk, and the resident blocks per SM
# its launch bounds ask for (kMinBlocks), on an H100's 132 SMs.
DW_TILE_AREA = 256 * 8 * 8
DW_CHUNK = 16
DW_BLOCKS_PER_SM = 2
SMS = 132


def conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Reference: ``out = Σ_taps shift(pad(x)) @ w[tap]`` in fp32."""
    k, cout = w.shape[0], w.shape[-1]
    p = (k - 1) // 2
    b, d, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, p, p, p, p, p, p))
    wf = w.float()
    out = torch.zeros((b, d, h, wd, cout), dtype=torch.float32,
                      device=x.device)
    for kz in range(k):
        for ky in range(k):
            for kx in range(k):
                out += xp[:, kz:kz + d, ky:ky + h, kx:kx + wd, :] @ wf[kz, ky, kx]
    return out


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(
            f"conv3d_p: want x [B,D,H,W,Cin] and w [K,K,K,Cin,Cout], got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    k = w.shape[0]
    if tuple(w.shape[:3]) != (k, k, k) or k % 2 == 0:
        raise ValueError(f"conv3d_p: needs a cubic odd kernel, got {tuple(w.shape)}")
    if w.shape[3] != x.shape[4]:
        raise ValueError(
            f"conv3d_p: x has {x.shape[4]} channels, w expects {w.shape[3]}"
        )


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global conv3d_fwd_launches
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(
            f"conv3d_p kernel takes fp32, got {x.dtype} and {w.dtype}"
        )
    if w.device != x.device:
        raise ValueError(f"conv3d_p: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3d_p kernel takes contiguous x and w")
    b, d, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    if max(b, d, h, wd, cin, cout) > _INT_LIMIT:
        raise ValueError(f"conv3d_p: dimension too large in {tuple(x.shape)}")
    out = torch.empty((b, d, h, wd, cout), dtype=torch.float32,
                      device=x.device)
    plan = fwd_plan(x.shape, cout, x.data_ptr(), w.data_ptr())
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                b, d, h, wd, cin, cout, k, *plan, stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_fwd_f32 launch failed: cudaError {rc}")
    conv3d_fwd_launches += 1
    return out


class FwdPlan(NamedTuple):
    """How ``csrc/conv3d_fwd.cu`` is launched: output tile ``bm x bn`` and
    copy width ``vec`` (floats per ``cp.async``)."""
    bm: int
    bn: int
    vec: int


def fwd_plan(x_shape, cout: int, x_ptr: int, w_ptr: int, *,
             tile_area: int = FWD_TILE_AREA,
             small_tile_area: int = FWD_SMALL_TILE_AREA) -> FwdPlan:
    """The launch of ``conv3d_fwd`` for ``x [B,D,H,W,Cin]`` and ``Cout``, as
    a function of the shapes and the two base addresses only (the kernel
    size does not change it).

    The tile is ``bn`` = 32 columns for Cout ≤ 32, else 64, and ``bm`` =
    ``tile_area / bn`` rows; where that gives fewer blocks than ``SMS``
    (serving's small buckets), ``small_tile_area / bn`` rows. 16-byte
    copies need Cin and Cout multiples of 4 (4 channels of one position in
    one tap, and 4 columns of one weight row) and both bases 16-byte
    aligned; anything else takes 4-byte copies. The keywords let
    ``ab_conv_dw_folded.py`` plan a variant source's own tiles."""
    b, d, h, w, cin = x_shape
    bn = 32 if cout <= 32 else 64
    bm = tile_area // bn
    if -(-(b * d * h * w) // bm) * -(-cout // bn) < SMS:
        bm = small_tile_area // bn
    vec = 4 if (cin % 4 == 0 and cout % 4 == 0 and x_ptr % 16 == 0
                and w_ptr % 16 == 0) else 1
    return FwdPlan(bm, bn, vec)


def _kernel():
    lib = build.load("conv3d_fwd")
    fn = lib.conv3d_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3d_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3D conv, odd K, no gradient: the forward kernel."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3d_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_p: no kernel for device {x.device}")
    return _launch(x, w)


class DwPlan(NamedTuple):
    """How ``csrc/conv3d_dw.cu`` is launched: output tile ``bm x bn``,
    copy width ``vec`` (floats per ``cp.async``), and the slabs."""
    bm: int
    bn: int
    vec: int
    slabs: int
    slab_len: int


def dw_plan(x_shape, cout: int, k: int, x_ptr: int, g_ptr: int, *,
            tile_area: int = DW_TILE_AREA, chunk: int = DW_CHUNK,
            blocks_per_sm: int = DW_BLOCKS_PER_SM) -> DwPlan:
    """The launch of ``conv3d_dw`` for ``x [B,D,H,W,Cin]``, ``Cout`` and
    ``k``, as a function of the shapes and the two base addresses only.

    16-byte copies need Cin and Cout multiples of 4 (4 channels of one tap
    at one position, never across a tap) and both bases 16-byte aligned;
    anything else takes 4-byte copies. Slabs fill whole waves of
    ``blocks_per_sm`` resident blocks on each of ``SMS`` SMs: at most one
    wave unless the tiles alone are more, cut on ``chunk``. The keywords
    let ``ab_conv_dw_folded.py`` plan a variant source's own tiles."""
    b, d, h, w, cin = x_shape
    bn = 32 if cout <= 32 else 64
    bm = tile_area // bn
    vec = 4 if (cin % 4 == 0 and cout % 4 == 0 and x_ptr % 16 == 0
                and g_ptr % 16 == 0) else 1
    tiles = -(-(k ** 3 * cin) // bm) * -(-cout // bn)
    per_wave = max(1, SMS * blocks_per_sm // tiles)
    slabs, slab_len = plan_slabs(b * d * h * w, tiles, chunk,
                                 target=per_wave * tiles)
    return DwPlan(bm, bn, vec, slabs, slab_len)


def _launch_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    global conv3d_dw_launches, conv3d_dw_sum_launches
    check_launch_args("conv3d_dw", x, g, (torch.float32,))
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    plan = dw_plan(x.shape, cout, k, x.data_ptr(), g.data_ptr())
    part = torch.empty((plan.slabs, k ** 3 * cin * cout), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((k, k, k, cin, cout), dtype=torch.float32, device=x.device)
    fn = _kernel_dw()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
                b, d, h, w, cin, cout, k, *plan, stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_dw_f32 launch failed: cudaError {rc}")
    conv3d_dw_launches += 1
    conv3d_dw_sum_launches += 1
    return out


def _kernel_dw():
    lib = build.load("conv3d_dw")
    fn = lib.conv3d_dw_f32
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def conv3d_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Weight grad of ``conv3d_p``: ``[k,k,k,Cin,Cout]`` fp32 from fp32
    ``x [B,D,H,W,Cin]`` and cotangent ``g [B,D,H,W,Cout]``."""
    check_dw_args("conv3d_dw", x, g, k)
    if x.device.type == "cpu":
        return conv_dw_plain(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_dw: no kernel for device {x.device}")
    return _launch_dw(x, g, k)


def _flip(w: torch.Tensor) -> torch.Tensor:
    """The dx kernel: ``w`` flipped in (kz,ky,kx), Cin and Cout swapped."""
    return w.flip(0, 1, 2).transpose(3, 4).contiguous()


class _Conv3dP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3d_fwd(g, _flip(w)) if ctx.needs_input_grad[0] else None
        dw = conv3d_dw(x, g, w.shape[0]) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3d_p(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3D conv, odd K: ``[B,D,H,W,Cin] x [K,K,K,Cin,Cout]``,
    fp32, differentiable through the kernels."""
    _check(x, w)
    return _Conv3dP.apply(x, w)


def _library_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The stride-1 SAME conv as ``F.conv3d`` on NDHWC views, in x's dtype."""
    p = (w.shape[0] - 1) // 2
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype).permute(4, 3, 0, 1, 2),
                 padding=p)
    return y.permute(0, 2, 3, 4, 1).contiguous()


class _Conv3dHybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, weight_grad):
        ctx.save_for_backward(x, w)
        ctx.weight_grad = weight_grad
        return _library_conv(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = _library_conv(g, _flip(w)) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = ctx.weight_grad(x, g, w.shape[0]).to(w.dtype)
        return dx, dw, None


def conv3d_hybrid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv in x's dtype: ``F.conv3d`` forward and input
    grad, weight grad through the ``conv_dw_folded`` kernel (fp32)."""
    _check(x, w)
    return _Conv3dHybrid.apply(x.contiguous(), w, conv_dw_folded)


def conv3d_hybrid_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv3d_hybrid`` with the weight grad through ``conv_dw_plain``."""
    _check(x, w)
    return _Conv3dHybrid.apply(x.contiguous(), w, conv_dw_plain)


def conv3d_xla(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv in x's dtype through ``F.conv3d``, the fp32
    kernel cast to it (the JAX ``nn.Conv`` path); gradients by autograd."""
    _check(x, w)
    return _library_conv(x, w)


class PallasConv(nn.Module):
    """Stride-1 SAME conv block backed by ``conv3d_p`` (no bias).

    Keeps the JAX module's cast order: activations go to fp32, through the
    kernel, and back to the model dtype. ``kernel`` is ``[K,K,K,Cin,Cout]``
    fp32, as in the JAX module; a reduced working copy of it (bf16, fp16 or
    dequantized int8, ``train/precision.py``) is widened to fp32 by a
    differentiable cast, so the fp32 kernels see its values and its weight
    gradient comes back at its dtype, as the JAX ``_vjp_bwd`` returns
    ``dw.astype(w.dtype)``. ``conv`` is the function applied, the kernel's
    wrapper unless a caller passes ``conv3d_plain``.
    """

    def __init__(self, cin: int, features: int, kernel_size: int,
                 dtype: torch.dtype = torch.bfloat16, conv=conv3d_p):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"PallasConv needs an odd kernel, got {kernel_size}")
        k = kernel_size
        self.kernel = nn.Parameter(torch.empty((k, k, k, cin, features)))
        self.dtype = dtype
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("casts"):
            x, w = x.float().contiguous(), self.kernel.float()
        y = self.conv(x, w)
        with record_function("casts"):
            return y.to(self.dtype)


class HybridConv(nn.Module):
    """Stride-1 SAME conv block in the activation dtype (no bias), backed
    by ``conv3d_hybrid`` or, for ``conv_backend="xla"``, ``conv3d_xla``.

    Activations stay in ``dtype`` and the kernel is cast to it, as the JAX
    module's ``_xla_conv`` and ``nn.Conv`` do; the weight gradient comes
    back at the kernel's dtype (fp32 for the masters, the working dtype for
    a reduced working copy). ``conv`` is ``conv3d_hybrid`` unless a caller passes
    ``conv3d_hybrid_plain`` or ``conv3d_xla``.
    """

    def __init__(self, cin: int, features: int, kernel_size: int,
                 dtype: torch.dtype = torch.bfloat16, conv=conv3d_hybrid):
        super().__init__()
        if kernel_size % 2 == 0:
            raise ValueError(f"HybridConv needs an odd kernel, got {kernel_size}")
        k = kernel_size
        self.kernel = nn.Parameter(torch.empty((k, k, k, cin, features)))
        self.dtype = dtype
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with record_function("casts"):
            x = x.to(self.dtype)
        return self.conv(x, self.kernel)
