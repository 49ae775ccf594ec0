"""Robustness (out-of-distribution) evaluation of a classifier or a
segmenter (port of ``featurenet_tpu/ood.py``).

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
canonicalized and 24-pose voted).

The segmentation report (``evaluate_ood_seg``) scores fresh
canonical-label multi-feature parts (``offline._generate_seg_sample``)
per (family, level) of ``SEG_DEFAULT_LEVELS`` by the exact summed
per-class IoU. Its labels live in the part's own grid, so no family
re-normalizes: rotation and scale warp voxels and labels together in grid
space (``affine_resample_pair``: trilinear and a 0.5 threshold for the
voxels, the nearest voxel for the labels, numpy float64 with ``np.rint``,
bitwise the reference's); noise and morph perturb the input alone. A
rotation row composes the fixed ``ROTATION_PRESCALE`` shrink, so its
control is the scale row at that level (``delta_vs_scale_control``),
which the report always carries beside a rotation row. The labels come
from ``Predictor.predict_voxels_seg`` on the device.
"""

from __future__ import annotations

import zlib

import numpy as np

from featurenet_tpu_torch.data.synthetic import (
    CLASS_NAMES,
    generate_sample,
    param_range,
)
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


# --- segmentation robustness -------------------------------------------------

SEG_DEFAULT_LEVELS: tuple = (
    ("clean", None),
    ("rotation", 5.0),
    ("rotation", 15.0),
    ("rotation", 45.0),
    ("rotation", "so3"),
    ("scale", 0.7),
    ("scale", 0.9),
    ("scale", 1.1),
    ("noise", 0.005),
    ("noise", 0.01),
    ("morph", "dilate"),
    ("morph", "erode"),
    ("tails", None),
)

# The shrink every seg rotation row composes, so rotated stock stays in
# the grid; the scale row at this level is their control.
ROTATION_PRESCALE = 0.7


def _annotate_rotation_control(rows: list[dict], key: str) -> list[dict]:
    """``delta_vs_scale_control`` of each rotation row: its ``key`` less
    the (scale, ``ROTATION_PRESCALE``) row's, the rotation's own cost
    (nothing when the report has no such row)."""
    control = next(
        (r[key] for r in rows
         if r["family"] == "scale" and r["level"] == ROTATION_PRESCALE),
        None,
    )
    if control is None:
        return rows
    for r in rows:
        if r["family"] == "rotation":
            r["delta_vs_scale_control"] = round(r[key] - control, 4)
    return rows


def _trilinear(vol: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Sample float ``vol`` [R,R,R] at ``src`` [3, N] (zero outside)."""
    R = vol.shape[0]
    f = np.floor(src).astype(np.int64)
    t = src - f
    out = np.zeros(src.shape[1], np.float32)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                idx = f + np.array([[dz], [dy], [dx]])
                w = (
                    (t[0] if dz else 1 - t[0])
                    * (t[1] if dy else 1 - t[1])
                    * (t[2] if dx else 1 - t[2])
                )
                valid = ((idx >= 0) & (idx < R)).all(axis=0)
                ic = np.clip(idx, 0, R - 1)
                out += w * np.where(
                    valid, vol[ic[0], ic[1], ic[2]], 0.0
                )
    return out


def affine_resample_pair(
    vox: np.ndarray,
    seg: np.ndarray | None,
    rot: np.ndarray | None = None,
    scale: float = 1.0,
) -> tuple[np.ndarray, np.ndarray | None]:
    """Grid-space affine about the centre: the voxels trilinear and
    thresholded at 0.5 (close to re-rasterizing the implicit surface), the
    labels nearest (``np.rint``, halves to even), 0 outside the grid."""
    R = vox.shape[0]
    c = (R - 1) / 2.0
    grid = np.stack(np.meshgrid(
        np.arange(R, dtype=np.float64),
        np.arange(R, dtype=np.float64),
        np.arange(R, dtype=np.float64),
        indexing="ij",
    )).reshape(3, -1)
    src = (grid - c) / scale
    if rot is not None:
        src = rot.T @ src
    src = src + c
    out_v = (_trilinear(vox.astype(np.float32), src) > 0.5).reshape(
        (R, R, R)
    )
    out_s = None
    if seg is not None:
        n = np.rint(src).astype(np.int64)
        valid = ((n >= 0) & (n < R)).all(axis=0)
        nc = np.clip(n, 0, R - 1)
        out_s = np.where(
            valid, seg[nc[0], nc[1], nc[2]], 0
        ).reshape((R, R, R)).astype(seg.dtype)
    return out_v, out_s


def _perturb_seg(family, level, vox, seg, rng):
    """(input voxels, ground truth) of one seg row: the geometry families
    warp both, noise and morph the input alone (the model should recover
    the underlying part's labels)."""
    if family in ("clean", "tails"):
        return vox, seg
    if family == "rotation":
        rot = random_rotation_matrix(
            rng, None if level == "so3" else float(level)
        )
        return affine_resample_pair(vox, seg, rot, ROTATION_PRESCALE)
    if family == "scale":
        return affine_resample_pair(vox, seg, None, float(level))
    if family == "noise":
        return vox ^ (rng.random(vox.shape) < float(level)), seg
    if family == "morph":
        g = dilate(vox) if level == "dilate" else erode(vox)
        return g, seg
    raise ValueError(f"unknown seg OOD family {family!r}")


def evaluate_ood_seg(
    checkpoint_dir: str,
    parts: int = 60,
    seed: int = 777,
    levels=None,
    families=None,
    batch: int = 16,
    progress=None,
    device="cuda",
) -> list[dict]:
    """The robustness report of a segmentation checkpoint: one row per
    (family, level) with the exact summed per-class IoU (``mean_iou``) and
    the voxel accuracy over ``parts`` fresh generator draws, and its
    difference from the report's clean row (always included; a rotation
    row also from the scale row at ``ROTATION_PRESCALE``, included
    whenever a rotation row is). The Predictor (``batch``, on ``device``,
    the card unless the caller asks for ``"cpu"``) labels each batch of
    ``batch`` parts; ``progress(family, level, done)`` is called after
    each."""
    from featurenet_tpu_torch.data.offline import _generate_seg_sample
    from featurenet_tpu_torch.infer import Predictor

    p = Predictor.from_checkpoint(checkpoint_dir, batch=batch, device=device)
    if p.cfg.task != "segment":
        raise ValueError("evaluate_ood_seg runs on segment checkpoints")
    R = p.cfg.resolution
    nf = p.cfg.num_features
    n_cls = NUM_CLASSES + 1

    known = {lv[0] for lv in SEG_DEFAULT_LEVELS}
    if families:
        bad = sorted(set(families) - known)
        if bad:
            raise ValueError(
                f"unknown seg OOD families {bad}; known: {sorted(known)}"
            )
    levels = list(levels if levels is not None else SEG_DEFAULT_LEVELS)
    if families:
        levels = [lv for lv in levels if lv[0] in families]
    if ("clean", None) not in levels:
        levels.insert(0, ("clean", None))
    if (any(lv[0] == "rotation" for lv in levels)
            and ("scale", ROTATION_PRESCALE) not in levels):
        levels.append(("scale", ROTATION_PRESCALE))

    rows = []
    for family, level in levels:
        rng = _family_rng(seed, family, level)
        inter = np.zeros(n_cls, np.float64)
        union = np.zeros(n_cls, np.float64)
        correct = total = 0
        for start in range(0, parts, batch):
            n = min(batch, parts - start)
            vox = np.empty((n, R, R, R), np.float32)
            gt = np.empty((n, R, R, R), np.int32)
            for i in range(n):
                with param_range("tails" if family == "tails" else None):
                    part, s = _generate_seg_sample(rng, R, nf, "canonical")
                v, s2 = _perturb_seg(family, level, part.astype(bool), s, rng)
                vox[i] = v.astype(np.float32)
                gt[i] = s2
            pred = p.predict_voxels_seg(vox).astype(np.int32)
            for c in range(n_cls):
                pc, tc = pred == c, gt == c
                inter[c] += (pc & tc).sum()
                union[c] += (pc | tc).sum()
            correct += (pred == gt).sum()
            total += pred.size
            if progress:
                progress(family, level, start + n)
        present = union > 0
        iou = np.where(present, inter / np.maximum(union, 1), 0.0)
        rows.append({
            "family": family,
            "level": level,
            "n": parts,
            "mean_iou": round(float(iou.sum() / max(present.sum(), 1)), 4),
            "voxel_accuracy": round(float(correct / total), 4),
        })
    return _annotate_rotation_control(
        _annotate_delta(rows, "mean_iou"), "mean_iou"
    )


def main(argv=None) -> None:
    """``python -m featurenet_tpu_torch.ood --checkpoint-dir CK``: the
    classify report's rows as JSON lines (the reference module's entry
    point), on the card unless ``--device cpu``."""
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="featurenet_tpu_torch.ood")
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--per-class", type=int, default=50)
    ap.add_argument("--seed", type=int, default=777)
    ap.add_argument("--families", default=None,
                    help="comma list: clean,rotation,noise,morph,tails,scale")
    ap.add_argument("--out", default=None, help="also write rows as JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fams = args.families.split(",") if args.families else None
    rows = evaluate_ood(
        args.checkpoint_dir, per_class=args.per_class, seed=args.seed,
        families=fams, device=args.device,
    )
    for r in rows:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
