"""Robustness (out-of-distribution) evaluation of a classifier (port of
the classify half of ``featurenet_tpu/ood.py``).

Each report row scores fresh generator draws, balanced per class and
seeded apart from every training seed, under one perturbation family at
one level:

  clean    — unperturbed draws: the in-distribution control row.
  rotation — an arbitrary rotation (a fixed angle about a random axis, or
             uniform ``"so3"``) applied in mesh space: exact surface
             (``voxels_to_mesh``) → rotate about the part's centre →
             re-voxelize. Training rotates by the 24-element cube group
             only, so any other pose is out of distribution.
  noise    — iid occupancy bit flips at rate p.
  morph    — one-voxel 6-neighbourhood dilation or erosion.
  tails    — every feature parameter drawn from the tails of its range
             (``synthetic.param_range("tails")``).
  scale    — the part re-normalized at another margin.

Every family passes through the STL benchmark's mesh → voxel pipeline
(``voxels_to_mesh`` → ``voxelize`` at the default margin), so the clean
row is the training modality, not the raw generator grid. The perturbed
grids are numpy functions of ``(seed, family, level, class, i)`` alone
(``_family_rng``, keyed by CRC digests), bitwise the JAX package's; only
the forwards run on the device (``Predictor.predict_voxels``, optionally
canonicalized and 24-pose voted). The segmentation report
(``evaluate_ood_seg``) is not ported.
"""

from __future__ import annotations

import zlib

import numpy as np

from featurenet_tpu_torch.data.synthetic import CLASS_NAMES, generate_sample
from featurenet_tpu_torch.data.voxel_to_mesh import (
    random_rotation_matrix,
    rotate_mesh,
    voxels_to_mesh,
)
from featurenet_tpu_torch.data.voxelize import voxelize

KNOWN_FAMILIES = ("clean", "rotation", "noise", "morph", "tails", "scale")

NUM_CLASSES = len(CLASS_NAMES)

# (family, level) rows of the default report. Rotation uses a fixed angle
# about a random axis per sample (clean dose-response); "so3" is a uniform
# random rotation.
DEFAULT_LEVELS: tuple = (
    ("clean", None),
    ("rotation", 5.0),
    ("rotation", 15.0),
    ("rotation", 45.0),
    ("rotation", "so3"),
    ("noise", 0.005),
    ("noise", 0.01),
    ("noise", 0.02),
    ("morph", "dilate"),
    ("morph", "erode"),
    ("tails", None),
    ("scale", 0.08),
    ("scale", 0.11),
)


def rotate_part(
    grid: np.ndarray, rng: np.random.Generator, angle_deg=None
) -> np.ndarray:
    """Mesh-space rotation of a voxel part: exact surface mesh → rotate
    about the center → re-voxelize (parity fill) at the same resolution.
    The mesh stays watertight under rotation, so the parity fill is exact;
    ``voxelize`` re-normalizes into the unit cube the way the STL pipeline
    normalizes every benchmark part."""
    R = grid.shape[0]
    tris = rotate_mesh(
        voxels_to_mesh(grid.astype(bool)),
        random_rotation_matrix(rng, angle_deg),
    )
    return voxelize(tris, R, fill=True)


def _shift(g: np.ndarray, ax: int, d: int) -> np.ndarray:
    out = np.zeros_like(g)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    if d > 0:
        dst[ax], src[ax] = slice(d, None), slice(None, -d)
    else:
        dst[ax], src[ax] = slice(None, d), slice(-d, None)
    out[tuple(dst)] = g[tuple(src)]
    return out


def dilate(g: np.ndarray) -> np.ndarray:
    """One-voxel 6-neighborhood binary dilation (zero boundary)."""
    out = g.copy()
    for ax in range(3):
        for d in (1, -1):
            out |= _shift(g, ax, d)
    return out


def erode(g: np.ndarray) -> np.ndarray:
    """One-voxel 6-neighborhood binary erosion.

    Boundary convention: implemented as ``~dilate(~g)`` with ``dilate``'s
    zero-padded shifts, so out-of-grid is treated as SOLID — a voxel on
    the grid boundary is never eroded from the outside. Harmless for this
    harness's margin-normalized parts (the stock never touches the grid
    edge), but an asymmetry vs ``dilate``'s zero boundary that a
    non-margined input would feel as silent under-erosion."""
    return ~dilate(~g)


def remesh(grid: np.ndarray, margin: float = 0.05) -> np.ndarray:
    """Pass a voxel part through the benchmark's mesh→voxel pipeline
    (exact surface extraction, re-normalization at ``margin``, parity
    fill). This is the normalization every STL-built training cache went
    through — fresh generator grids must take the same path or the
    'clean' row measures a scale shift, not the model."""
    R = grid.shape[0]
    return voxelize(voxels_to_mesh(grid.astype(bool)), R, fill=True,
                    margin=margin)


def _family_rng(seed: int, family: str, level) -> np.random.Generator:
    """Per-(family, level) stream keyed via stable CRC digests —
    reproducible across processes (Python's hash() is salted) and
    independent of which other rows a report includes."""
    return np.random.default_rng(np.random.SeedSequence([
        seed,
        zlib.crc32(family.encode()),
        zlib.crc32(repr(level).encode()),
    ]))


def _annotate_delta(rows: list[dict], key: str) -> list[dict]:
    """Delta of ``key`` vs the report's own clean control row."""
    clean = next(r[key] for r in rows if r["family"] == "clean")
    for r in rows:
        r["delta_vs_clean"] = round(r[key] - clean, 4)
    return rows


def _perturb(family: str, level, grid: np.ndarray, rng) -> np.ndarray:
    """One generated part under ``family`` at ``level``, through the mesh
    pipeline; draws from ``rng`` only for rotation and noise."""
    g = grid.astype(bool)
    if family in ("clean", "tails"):
        return remesh(g)
    if family == "rotation":
        # rotate_part re-voxelizes at the default margin itself.
        return rotate_part(g, rng, None if level == "so3" else float(level))
    if family == "noise":
        return remesh(g) ^ (rng.random(g.shape) < float(level))
    if family == "morph":
        g = remesh(g)
        return dilate(g) if level == "dilate" else erode(g)
    if family == "scale":
        return remesh(g, margin=float(level))
    raise ValueError(f"unknown OOD family {family!r}")


def evaluate_ood(
    checkpoint_dir: str,
    per_class: int = 50,
    seed: int = 777,
    levels=None,
    families=None,
    batch: int = 64,
    progress=None,
    canonicalize: bool = False,
    tta_rotations: bool = False,
    device="cuda",
) -> list[dict]:
    """The robustness report of a classification checkpoint: one row per
    (family, level) with its accuracy, mean and min per-class accuracy,
    the worst class, and the difference from the report's own clean row
    (always included, so the delta compares the same fresh-draw protocol).

    ``levels`` defaults to ``DEFAULT_LEVELS``; ``families`` keeps the
    rows of those families. The Predictor (``batch``, on ``device``,
    which is the card unless the caller asks for ``"cpu"``) classifies
    each class's ``per_class`` parts in one ``predict_voxels`` call;
    ``progress(family, level, class)`` is called after each."""
    from featurenet_tpu_torch.infer import Predictor

    if families:
        bad = sorted(set(families) - set(KNOWN_FAMILIES))
        if bad:
            raise ValueError(
                f"unknown OOD families {bad}; known: {sorted(KNOWN_FAMILIES)}"
            )
    p = Predictor.from_checkpoint(checkpoint_dir, batch=batch, device=device)
    R = p.cfg.resolution
    levels = list(levels if levels is not None else DEFAULT_LEVELS)
    if families:
        levels = [lv for lv in levels if lv[0] in families]
    if ("clean", None) not in levels:
        levels.insert(0, ("clean", None))

    rows = []
    for family, level in levels:
        rng = _family_rng(seed, family, level)
        confusion = np.zeros((NUM_CLASSES, NUM_CLASSES), np.int64)
        for c in range(NUM_CLASSES):
            grids = np.empty((per_class, R, R, R), np.float32)
            for i in range(per_class):
                part, _, _ = generate_sample(
                    rng, R, label=c,
                    param_range="tails" if family == "tails" else None,
                )
                grids[i] = _perturb(family, level, part, rng)
            pred, _ = p.predict_voxels(
                grids, canonicalize=canonicalize,
                tta_rotations=tta_rotations,
            )
            for q in pred:
                confusion[c, int(q)] += 1
            if progress:
                progress(family, level, c)
        per_cls = confusion.diagonal() / confusion.sum(axis=1)
        worst = int(per_cls.argmin())
        rows.append({
            "family": family,
            "level": level,
            "n": int(confusion.sum()),
            "accuracy": round(float(confusion.diagonal().sum()
                                    / confusion.sum()), 4),
            "mean_class_accuracy": round(float(per_cls.mean()), 4),
            "min_class_accuracy": round(float(per_cls[worst]), 4),
            "worst_class": CLASS_NAMES[worst],
        })
    return _annotate_delta(rows, "accuracy")
