"""Weight gradient of a stride-1 SAME odd-K 3D conv, tap-folded: the port
of ``featurenet_tpu/ops/conv_dw.py::conv_dw_folded``.

``conv_dw_folded(x, g, k)`` takes activations ``x [B,D,H,W,Cin]`` and the
cotangent ``g [B,D,H,W,Cout]`` (both bf16 or both fp32) and returns
``dW [k,k,k,Cin,Cout]`` in fp32, summed in fp32:

    dW[tz,ty,tx,ci,co] = Σ_{b,z,y,x} x[b,z+tz-p,y+ty-p,x+tx-p,ci] · g[b,z,y,x,co]

- On a CUDA tensor it launches ``csrc/conv_dw_folded.cu`` (the folded
  product ``[k²·Cin, rows]ᵀ·[rows, k·Cout]`` in slabs, then a slab sum that
  un-folds) or raises; there is no fallback. bf16 runs the product on the
  tensor cores (``mma.sync``, fp32 sum), fp32 in SIMT FMAs.
- On a CPU tensor it runs ``conv_dw_plain``: the k³ shifted ``xᵀ·g``
  products in fp32, bf16 inputs upcast first.

``conv_dw_folded_launches`` counts the product kernel's launches and
``conv_dw_folded_sum_launches`` the slab sums (one each per call on a
CUDA tensor).

``plan_slabs`` splits a kernel's sum into slabs so that output tiles ×
slabs fill the card; it depends only on the shapes, so the result is the
same bits on every run. ``ops/conv3d.py``'s ``conv3d_dw`` shares it with
its own block target.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from featurenet_tpu_torch.ops import build

conv_dw_folded_launches = 0
conv_dw_folded_sum_launches = 0

# Blocks the folded kernel's launch aims for: four per SM of an H100 (132).
# ``conv3d_dw`` plans on its own target (``ops/conv3d.py``).
TARGET_BLOCKS = 4 * 132
# Fewest summed rows a slab is given, so a slab's partial tile is not
# dominated by its write.
MIN_SLAB = 256
# Positions per shared-memory chunk in the kernels (kBK; kMmaBK in the bf16
# tensor-core kernel); slabs are cut on chunk boundaries.
CHUNK = 16
MMA_CHUNK = 32
# Threads per block x outputs per thread in the folded kernels: BM·BN.
TILE_AREA = 256 * 8 * 4

_INT_LIMIT = 2 ** 31 - 1


def plan_slabs(length: int, tiles: int, chunk: int = CHUNK,
               target: int = TARGET_BLOCKS) -> tuple[int, int]:
    """``(slabs, slab_len)`` for a sum over ``length`` rows into ``tiles``
    output tiles: about ``target`` blocks in all (``ceil(target/tiles)``
    slabs at most), each slab a multiple of ``chunk`` rows and at least
    ``MIN_SLAB`` long (or the whole sum), the last one non-empty."""
    want = max(1, min(-(-target // tiles), length // MIN_SLAB))
    slab_len = -(-(-(-length // want)) // chunk) * chunk
    return -(-length // slab_len), slab_len


def folded_tile(k: int, cin: int, cout: int) -> int:
    """The column tile ``BN`` (32, 64 or 128; rows ``BM = TILE_AREA/BN``)
    that pads the folded ``[k²·Cin, k·Cout]`` output least."""
    rows, cols = k * k * cin, k * cout

    def padded(bn):
        bm = TILE_AREA // bn
        return (-(-rows // bm) * bm) * (-(-cols // bn) * bn), -bn

    return min((32, 64, 128), key=padded)


def conv_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Reference: ``dW[t] = shift_t(pad(x))ᵀ @ g`` for each of the k³ taps,
    in fp32."""
    p = (k - 1) // 2
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, p, p, p, p, p, p))
    gf = g.float().reshape(-1, cout)
    dw = torch.empty((k, k, k, cin, cout), dtype=torch.float32, device=x.device)
    for kz in range(k):
        for ky in range(k):
            for kx in range(k):
                xs = xp[:, kz:kz + d, ky:ky + h, kx:kx + w, :].reshape(-1, cin)
                dw[kz, ky, kx] = xs.T @ gf
    return dw


def check_dw_args(name: str, x: torch.Tensor, g: torch.Tensor, k: int) -> None:
    if x.dim() != 5 or g.dim() != 5 or x.shape[:4] != g.shape[:4]:
        raise ValueError(
            f"{name}: want x [B,D,H,W,Cin] and g [B,D,H,W,Cout], got "
            f"{tuple(x.shape)} and {tuple(g.shape)}"
        )
    if k < 1 or k % 2 == 0:
        raise ValueError(f"{name}: needs an odd kernel size, got {k}")


def check_launch_args(name: str, x: torch.Tensor, g: torch.Tensor,
                      dtypes) -> None:
    if x.dtype not in dtypes or g.dtype != x.dtype:
        raise TypeError(
            f"{name} kernel takes x and g of one type in {dtypes}, got "
            f"{x.dtype} and {g.dtype}"
        )
    if g.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, g on {g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous x and g")
    if max(*x.shape, g.shape[-1]) > _INT_LIMIT:
        raise ValueError(f"{name}: dimension too large in {tuple(x.shape)}")


def folded_plan(x: torch.Tensor, g: torch.Tensor, k: int) -> tuple[int, int, int]:
    """``(bn, slabs, slab_len)`` the folded kernel is launched with: the
    column tile, and slabs cut on its chunk (32 q-rows for bf16, 16 for
    fp32)."""
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    bn = folded_tile(k, cin, cout)
    bm = TILE_AREA // bn
    tiles = -(-(k * k * cin) // bm) * -(-(k * cout) // bn)
    chunk = MMA_CHUNK if x.dtype == torch.bfloat16 else CHUNK
    return (bn, *plan_slabs(b * d * h * (w + k - 1), tiles, chunk))


def _launch(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    global conv_dw_folded_launches, conv_dw_folded_sum_launches
    check_launch_args("conv_dw_folded", x, g, (torch.float32, torch.bfloat16))
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    bn, slabs, slab_len = folded_plan(x, g, k)
    part = torch.empty((slabs, k ** 3 * cin * cout), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((k, k, k, cin, cout), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
                int(x.dtype == torch.bfloat16), b, d, h, w, cin, cout, k, bn,
                slabs, slab_len, stream)
    if rc != 0:
        raise RuntimeError(f"conv_dw_folded launch failed: cudaError {rc}")
    conv_dw_folded_launches += 1
    conv_dw_folded_sum_launches += 1
    return out


def _kernel():
    lib = build.load("conv_dw_folded")
    fn = lib.conv_dw_folded
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def conv_dw_folded(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Weight grad of a stride-1 SAME odd-K conv: ``[k,k,k,Cin,Cout]`` fp32."""
    check_dw_args("conv_dw_folded", x, g, k)
    if x.device.type == "cpu":
        return conv_dw_plain(x, g, k)
    if x.device.type != "cuda":
        raise ValueError(f"conv_dw_folded: no kernel for device {x.device}")
    return _launch(x, g, k)
