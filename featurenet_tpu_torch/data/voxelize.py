"""STL→voxel rasterization (port of ``featurenet_tpu/data/voxelize.py``):
numpy, and the native C++ rasterizer (``featurenet_tpu_torch.native``).

1. ``normalize_mesh`` centers the triangle soup and scales it uniformly
   into ``[margin, 1-margin]³``.
2. ``fill=True``: parity ray casting — one vertical ray per (x, y)
   voxel-center column; a voxel is solid iff its center is inside the
   watertight mesh. ``fill_method="flood"`` instead rasterizes the
   surface and floods the exterior (``_fill_interior``), which tolerates
   small holes; it runs in numpy only.
3. ``fill=False``: the surface shell: in numpy a barycentric sampling of
   each triangle at under half a voxel's pitch, natively the exact
   triangle-box test (a superset).

``backend="auto"`` takes the native library when it builds here (g++),
else numpy; ``"native"`` requires it; ``"numpy"`` never uses it. The
native parity fill is bitwise the numpy one on watertight meshes.

The output is a ``bool [R, R, R]`` occupancy grid, index order ``[x, y, z]``.
"""

from __future__ import annotations

import numpy as np


def normalize_mesh(triangles: np.ndarray, margin: float = 0.05) -> np.ndarray:
    """Center + uniformly scale triangles into [margin, 1-margin]³."""
    tris = np.asarray(triangles, dtype=np.float32)
    lo = tris.reshape(-1, 3).min(axis=0)
    hi = tris.reshape(-1, 3).max(axis=0)
    center = (lo + hi) / 2.0
    extent = float((hi - lo).max())
    if extent <= 0:
        raise ValueError("degenerate mesh: zero spatial extent")
    scale = (1.0 - 2.0 * margin) / extent
    return (tris - center) * scale + 0.5


def _rasterize_surface(tris: np.ndarray, resolution: int) -> np.ndarray:
    """Mark every voxel touched by a dense point sampling of each triangle."""
    R = resolution
    grid = np.zeros((R, R, R), dtype=bool)
    v = tris * R  # voxel i spans [i, i+1)
    e01 = np.linalg.norm(v[:, 1] - v[:, 0], axis=1)
    e02 = np.linalg.norm(v[:, 2] - v[:, 0], axis=1)
    e12 = np.linalg.norm(v[:, 2] - v[:, 1], axis=1)
    max_edge = np.maximum(np.maximum(e01, e02), e12)
    n_sub = np.clip(np.ceil(max_edge * 2.0).astype(np.int64), 1, 4096)
    for n in np.unique(n_sub):
        sel = v[n_sub == n]
        i, j = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
        keep = (i + j) <= n
        a = (i[keep] / n).astype(np.float32)
        b = (j[keep] / n).astype(np.float32)
        c = 1.0 - a - b
        pts = (
            a[None, :, None] * sel[:, None, 0]
            + b[None, :, None] * sel[:, None, 1]
            + c[None, :, None] * sel[:, None, 2]
        ).reshape(-1, 3)
        idx = np.clip(np.floor(pts).astype(np.int64), 0, R - 1)
        grid[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return grid


def _voxelize_parity(tris: np.ndarray, resolution: int) -> np.ndarray:
    """Center-inside solid voxelization by vertical-ray parity counting.

    Each triangle toggles every voxel center above its crossing with the
    (x, y) rays through its projection; a cumulative parity along z gives
    inside/outside. Rays carry a sub-voxel jitter so shared edges do not
    double-count. Exact (to fp32) for watertight meshes.
    """
    R = resolution
    v = np.asarray(tris, dtype=np.float64) * R
    toggles = np.zeros((R, R, R + 1), dtype=np.int64)
    ex, ey = 7.3e-7, 3.1e-7
    for tri in v:
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = tri
        det = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        if abs(det) < 1e-12:
            continue  # degenerate or vertical: no xy area, no crossing
        ix_lo = max(0, int(np.ceil(min(x0, x1, x2) - 0.5 - ex)))
        ix_hi = min(R - 1, int(np.floor(max(x0, x1, x2) - 0.5 - ex)))
        iy_lo = max(0, int(np.ceil(min(y0, y1, y2) - 0.5 - ey)))
        iy_hi = min(R - 1, int(np.floor(max(y0, y1, y2) - 0.5 - ey)))
        if ix_lo > ix_hi or iy_lo > iy_hi:
            continue
        px = np.arange(ix_lo, ix_hi + 1, dtype=np.float64) + 0.5 + ex
        py = np.arange(iy_lo, iy_hi + 1, dtype=np.float64) + 0.5 + ey
        PX, PY = np.meshgrid(px, py, indexing="ij")
        a = ((y1 - y2) * (PX - x2) + (x2 - x1) * (PY - y2)) / det
        b = ((y2 - y0) * (PX - x2) + (x0 - x2) * (PY - y2)) / det
        c = 1.0 - a - b
        hit = (a >= 0) & (b >= 0) & (c >= 0)
        if not hit.any():
            continue
        zstar = a * z0 + b * z1 + c * z2
        k = np.ceil(zstar - 0.5).astype(np.int64)
        ii, jj = np.nonzero(hit)
        kk = np.clip(k[hit], 0, R)  # k == R toggles nothing (virtual layer)
        np.add.at(toggles, (ii + ix_lo, jj + iy_lo, kk), 1)
    return (np.cumsum(toggles[:, :, :R], axis=2) % 2).astype(bool)


def _fill_interior(surface: np.ndarray) -> np.ndarray:
    """Exterior flood fill by iterative dilation, then complement: the
    exterior grows from the six grid faces through empty voxels, and
    everything never reached (surface and enclosed volume) is solid."""
    R = surface.shape[0]
    empty = ~surface
    exterior = np.zeros_like(surface)
    for axis in range(3):
        face = [slice(None)] * 3
        face[axis] = 0
        exterior[tuple(face)] = empty[tuple(face)]
        face[axis] = R - 1
        exterior[tuple(face)] = empty[tuple(face)]
    while True:
        grown = exterior.copy()
        grown[1:, :, :] |= exterior[:-1, :, :]
        grown[:-1, :, :] |= exterior[1:, :, :]
        grown[:, 1:, :] |= exterior[:, :-1, :]
        grown[:, :-1, :] |= exterior[:, 1:, :]
        grown[:, :, 1:] |= exterior[:, :, :-1]
        grown[:, :, :-1] |= exterior[:, :, 1:]
        grown &= empty
        if (grown == exterior).all():
            break
        exterior = grown
    return ~exterior


def voxelize(
    triangles: np.ndarray,
    resolution: int = 64,
    fill: bool = True,
    normalize: bool = True,
    margin: float = 0.05,
    backend: str = "auto",
    fill_method: str = "parity",
) -> np.ndarray:
    """Voxelize a triangle soup to a ``bool [R, R, R]`` occupancy grid:
    the center-inside solid (``fill=True``) or the surface shell.

    ``backend``: ``"auto"`` (native when it builds, else numpy),
    ``"native"`` or ``"numpy"``. ``fill_method``: ``"parity"`` (exact, for
    watertight meshes) or ``"flood"`` (numpy only: ``backend="native"``
    with a flood fill raises rather than give parity semantics)."""
    tris = np.asarray(triangles, dtype=np.float32)
    if normalize:
        tris = normalize_mesh(tris, margin=margin)
    native_ok = (not fill) or fill_method == "parity"
    if backend == "native" and not native_ok:
        raise ValueError(
            "backend='native' has no flood fill; use "
            "fill_method='parity' or backend='numpy'/'auto'"
        )
    if backend != "numpy" and native_ok:
        try:
            from featurenet_tpu_torch.native import voxelize_native

            return voxelize_native(tris, resolution, fill)
        except Exception:
            if backend == "native":
                raise
    if not fill:
        return _rasterize_surface(tris, resolution)
    if fill_method == "flood":
        return _fill_interior(_rasterize_surface(tris, resolution))
    return _voxelize_parity(tris, resolution)
