"""Voxel occupancy grid → watertight triangle mesh (port of
``featurenet_tpu/data/voxel_to_mesh.py``).

Every boundary face between an occupied and an empty voxel becomes two
triangles, so the surface is closed and wound outward; the STL→voxel
front end (``data/voxelize.py``, ``offline.build_cache``) ingests it like
any external part. Vertices lie on voxel-cell corners at ``index / R`` in
the unit cube, while the parity fill casts its rays through voxel centres
``(i + 0.5) / R``, never on a face plane, so
``voxelize(voxels_to_mesh(g), R, fill=True, normalize=False)`` gives back
``g`` exactly.

``export_stl_tree`` materializes the synthetic benchmark as an STL class
tree (``out_root/<class>/<class>_<i>.stl``), the on-disk shape of the
reference dataset. ``export_seg_stl_tree`` writes the segmentation
benchmark as STL parts with per-voxel label sidecars
(``parts/part_NNNNNNN.stl`` and ``.seg.npy``, int8 ``[R, R, R]``) and an
``index.json`` of kind ``segment_stl`` marked ``aligned_unit_cube``: the
meshes sit in the unit cube of their own grid, so the ingest
(``offline.build_seg_cache``) voxelizes them unnormalized and grid and
sidecar stay voxel-exact. It draws from ``export_seg_cache``'s per-shard
seed streams, so that ingest gives back the seg cache of the same
arguments byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

# One entry per face direction: (axis, positive side).
_DIRECTIONS = (
    (0, True), (0, False),
    (1, True), (1, False),
    (2, True), (2, False),
)


def random_rotation_matrix(
    rng: np.random.Generator, angle_deg=None
) -> np.ndarray:
    """A random 3D rotation: uniform over SO(3) (``angle_deg=None``, from a
    normalized Gaussian quaternion) or ``angle_deg`` about a uniformly
    random axis (Rodrigues)."""
    if angle_deg is None:
        q = rng.normal(size=4)
        w, x, y, z = q / np.linalg.norm(q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ], dtype=np.float64)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = np.deg2rad(float(angle_deg))
    K = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * (K @ K)


def rotate_mesh(tris: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """Rotate ``[n, 3, 3]`` triangles about their bounding-box centre."""
    pts = tris.reshape(-1, 3)
    center = (pts.min(0) + pts.max(0)) / 2.0
    return ((pts - center) @ rot.T + center).reshape(-1, 3, 3).astype(
        np.float32
    )


def _face_quads(cells: np.ndarray, axis: int, positive: bool) -> np.ndarray:
    """Quad corners ``[n, 4, 3]`` (float32, voxel-index coordinates) of the
    boundary faces of ``cells [n, 3]`` in direction ``axis``/``positive``,
    counter-clockwise seen from outside."""
    base = cells.astype(np.float32)
    if positive:
        base[:, axis] += 1.0
    u_axis, v_axis = [a for a in (0, 1, 2) if a != axis]
    quads = np.repeat(base[:, None, :], 4, axis=1)
    order = (
        ((0, 0), (1, 0), (1, 1), (0, 1))
        if (axis in (0, 2)) == positive
        else ((0, 0), (0, 1), (1, 1), (1, 0))
    )
    for corner, (du, dv) in enumerate(order):
        quads[:, corner, u_axis] += du
        quads[:, corner, v_axis] += dv
    return quads


def voxels_to_mesh(grid: np.ndarray, scale: float | None = None) -> np.ndarray:
    """The boundary surface of a ``bool [R, R, R]`` grid as ``float32 [n,
    3, 3]`` triangles (two per boundary face, wound outward). ``scale``
    multiplies the coordinates; the default ``1 / R`` places the grid in
    the unit cube. An empty grid gives zero triangles."""
    g = np.asarray(grid).astype(bool)
    if g.ndim != 3:
        raise ValueError(f"expected [R, R, R] grid, got {g.shape}")
    if scale is None:
        scale = 1.0 / max(g.shape)
    padded = np.pad(g, 1, constant_values=False)
    quad_list = []
    for axis, positive in _DIRECTIONS:
        shift = np.roll(padded, -1 if positive else 1, axis=axis)
        exposed = (padded & ~shift)[1:-1, 1:-1, 1:-1]
        quad_list.append(_face_quads(np.argwhere(exposed), axis, positive))
    quads = np.concatenate(quad_list, axis=0)
    # Quad [A, B, C, D] → triangles [A, B, C] and [A, C, D], both with the
    # quad's winding.
    tris = np.concatenate([quads[:, (0, 1, 2)], quads[:, (0, 2, 3)]], axis=0)
    return (tris * np.float32(scale)).astype(np.float32)


def export_stl_tree(
    out_root: str,
    per_class: int = 10,
    resolution: int = 64,
    seed: int = 0,
) -> dict:
    """Write ``per_class`` generated parts of every class as binary STL
    files ``out_root/<class>/<class>_<i>.stl``, one
    ``SeedSequence([seed, class_id])`` stream per class (sample ``i`` of a
    class is the same whatever ``per_class``). Returns ``{"counts": {class:
    n}}``."""
    from featurenet_tpu_torch.data.stl import save_stl
    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES, generate_sample

    counts = {}
    for cls_id, cls in enumerate(CLASS_NAMES):
        rng = np.random.default_rng(np.random.SeedSequence([seed, cls_id]))
        cdir = os.path.join(out_root, cls)
        os.makedirs(cdir, exist_ok=True)
        for i in range(per_class):
            voxels, _labels, _seg = generate_sample(
                rng, resolution, label=cls_id
            )
            save_stl(
                os.path.join(cdir, f"{cls}_{i:04d}.stl"),
                voxels_to_mesh(voxels),
                name=f"{cls}_{i}",
            )
        counts[cls] = per_class
    return {"counts": counts}


def export_seg_stl_tree(
    out_root: str,
    num_parts: int = 100,
    resolution: int = 64,
    num_features: int = 3,
    shard_size: int = 200,
    seed: int = 0,
    label_order: str = "canonical",
) -> dict:
    """Write ``num_parts`` multi-feature parts as
    ``out_root/parts/part_<i>.stl`` (the boundary surface, unit cube) with
    their labels beside them as ``part_<i>.seg.npy`` (int8 ``[R, R, R]``),
    one ``SeedSequence([seed, shard])`` stream per ``shard_size`` parts,
    and ``out_root/index.json`` (``kind: segment_stl``,
    ``aligned_unit_cube: true``); returns the index."""
    import json

    from featurenet_tpu_torch.data.offline import _generate_seg_sample
    from featurenet_tpu_torch.data.stl import save_stl

    pdir = os.path.join(out_root, "parts")
    os.makedirs(pdir, exist_ok=True)
    done = shard_id = 0
    while done < num_parts:
        n = min(shard_size, num_parts - done)
        rng = np.random.default_rng(np.random.SeedSequence([seed, shard_id]))
        for i in range(n):
            part, seg = _generate_seg_sample(rng, resolution, num_features,
                                             label_order)
            stem = os.path.join(pdir, f"part_{done + i:07d}")
            save_stl(stem + ".stl", voxels_to_mesh(part),
                     name=f"part_{done + i}")
            np.save(stem + ".seg.npy", seg.astype(np.int8))
        done += n
        shard_id += 1
    index = {
        "kind": "segment_stl",
        "resolution": resolution,
        "num_parts": num_parts,
        "num_features": num_features,
        "shard_size": shard_size,
        "seed": seed,
        "label_order": label_order,
        "aligned_unit_cube": True,
    }
    with open(os.path.join(out_root, "index.json"), "w") as fh:
        json.dump(index, fh, indent=1)
    return index
