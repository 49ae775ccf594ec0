"""Pose canonicalization: undo an arbitrary SO(3) rotation before serving
(port of ``featurenet_tpu/data/canonicalize.py``).

A machining part is a rectangular stock block with features carved into
it, so its pose is recoverable from the geometry: the volume of the
part's axis-aligned bounding box over all rotations is smallest when the
stock's faces are axis-aligned. ``estimate_canonical_rotation`` searches
SO(3) coarse to fine on the part's boundary voxels (a few hundred random
quaternions, then a greedy descent over shrinking axis-angle steps);
``canonicalize`` applies the inverse pose through the benchmark's exact
mesh pipeline (``voxels_to_mesh`` → rotate → ``voxelize`` at the training
margin), so the part re-enters the training distribution, pose and scale
normalized, up to the 24-fold cube-group ambiguity that
``Predictor.predict_voxels`` resolves with test-time rotations.

It stays numpy in float64 on the host: the search's argmin over random
candidates and its greedy refinement are discontinuous in the inputs, so
a float32 or device version would pick another incumbent on near-ties
and land on another pose. With the same grid and seed the rotation is
the JAX package's to rounding, and the canonical grid bitwise.
"""

from __future__ import annotations

import numpy as np

from featurenet_tpu_torch.data.voxel_to_mesh import rotate_mesh, voxels_to_mesh
from featurenet_tpu_torch.data.voxelize import voxelize


def _boundary_coords(grid: np.ndarray) -> np.ndarray:
    """[N, 3] float coords of boundary-occupied voxels (center-origin).

    Interior voxels never touch the AABB, so the 6-neighborhood boundary
    (~R² points instead of ~R³) carries the whole objective.
    """
    g = grid.astype(bool)
    interior = np.ones_like(g)
    for ax in range(3):
        for d in (1, -1):
            interior &= np.roll(g, d, axis=ax)
    surf = g & ~interior
    if not surf.any():  # degenerate (empty/full) — fall back to all voxels
        surf = g
    pts = np.argwhere(surf).astype(np.float64)
    return pts - (np.array(grid.shape, np.float64) - 1.0) / 2.0


def _aabb_volume(pts: np.ndarray, rot: np.ndarray) -> float:
    q = pts @ rot.T
    ext = q.max(axis=0) - q.min(axis=0)
    return float(ext[0] * ext[1] * ext[2])


def _axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    a = axis / np.linalg.norm(axis)
    K = np.array([
        [0, -a[2], a[1]],
        [a[2], 0, -a[0]],
        [-a[1], a[0], 0],
    ])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _quat_rot(q: np.ndarray) -> np.ndarray:
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def estimate_canonical_rotation(
    grid: np.ndarray,
    coarse_samples: int = 384,
    refine_rounds: int = 24,
    seed: int = 0,
) -> np.ndarray:
    """Rotation matrix R minimizing the AABB volume of ``R @ part``.

    Applying the returned R to the part aligns the stock's faces with the
    grid axes (up to cube-group ambiguity). Deterministic given ``seed``.
    """
    if not np.asarray(grid).astype(bool).any():
        return np.eye(3)  # empty grid: nothing to orient
    pts = _boundary_coords(grid)
    rng = np.random.default_rng(seed)

    best_rot = np.eye(3)
    best_vol = _aabb_volume(pts, best_rot)
    # Coarse pass: iid-normal quaternions are uniform on SO(3).
    for q in rng.normal(size=(coarse_samples, 4)):
        rot = _quat_rot(q)
        v = _aabb_volume(pts, rot)
        if v < best_vol:
            best_vol, best_rot = v, rot

    # Refinement: shrinking random axis-angle perturbations (accept-greedy).
    step = 0.2  # radians
    for i in range(refine_rounds):
        improved = False
        for axis in rng.normal(size=(8, 3)):
            for sign in (1.0, -1.0):
                rot = _axis_angle(axis, sign * step) @ best_rot
                v = _aabb_volume(pts, rot)
                if v < best_vol:
                    best_vol, best_rot, improved = v, rot, True
        if not improved:
            step *= 0.5
            if step < 1e-3:
                break
    return best_rot


def canonicalize(
    grid: np.ndarray,
    margin: float = 0.05,
    **estimate_kw,
) -> np.ndarray:
    """Re-orient a voxel part to its canonical (stock-axis-aligned) pose.

    Exact surface mesh → estimated inverse rotation → re-voxelize through
    the benchmark pipeline at ``margin`` — i.e. the output re-enters the
    STL-cache training distribution (pose AND scale normalized). The
    residual cube-group ambiguity is left to the caller (24-pose TTA)."""
    R = grid.shape[0]
    g = np.asarray(grid).astype(bool)
    if not g.any():
        return g  # empty grid: no surface to remesh
    rot = estimate_canonical_rotation(g, **estimate_kw)
    tris = rotate_mesh(voxels_to_mesh(g), rot)
    return voxelize(tris, R, fill=True, margin=margin)
