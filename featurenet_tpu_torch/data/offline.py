"""The packed voxel caches: the STL-tree builds, the synthetic exports and
the readers (port of ``featurenet_tpu/data/offline.py``).

- Layout (``storage: "packed"`` in ``index.json``): one ``<cls>.npy`` per
  class holding bit-packed ``uint8 [N, R, R, R/8]`` voxels, byte for byte
  the wire format (``synthetic.pack_voxels``), a ``<cls>.files.json`` of
  provenance and a top-level ``index.json`` with the classes, counts and
  canonical ``label_ids``. The shards are read through ``np.load(...,
  mmap_mode="r")``, so the host holds the pages the sampler touches, not
  the cache. Legacy ``.npz`` caches (unpacked) are packed once at open.
- ``build_cache`` voxelizes an STL class tree (``root/<class>/*.stl``,
  the reference benchmark's layout) into that layout: each file through
  ``voxelize`` (parity fill, normalized at the default margin), in file
  order, inline or over a ``spawn`` process pool; the bytes do not depend
  on the worker count. Class directories named as a canonical class get
  its id; others get ids after the canonical 24, with a warning.
- ``export_synthetic_cache`` writes the parametric generator's parts in
  that layout, one ``SeedSequence([seed, class_id])`` stream per class, as
  the reference does: a cache written by either package has the same
  bytes and loads in the other. ``param_range`` restricts the feature
  parameters to a quantile window, ``mesh_pose`` routes every part
  through the STL pipeline (``"remesh"``: the identity pose, which gives
  the bytes ``build_cache`` gives on ``export_stl_tree``'s tree of the
  same seed; ``"so3"``: a uniform random rotation too), and
  ``margin_jitter=(lo, hi)`` draws each part's normalization margin; all
  three are recorded in ``index.json``.
- ``VoxelCacheDataset`` is a split of a cache (a fixed hash of each row's
  index holds out ``test_fraction`` of every class) in the classify wire
  format: an infinite sampled stream per producer worker
  (``worker_iter``), one exact pass (``epoch_batches``) and the seed-
  shuffled split for a device-resident upload (``materialize_split``).
  ``augment=True`` rotates each drawn sample on the host by one of the 24
  cube rotations; with device augmentation the train step rotates instead.

- The segmentation cache (``index.json`` ``"kind": "segment"``):
  ``export_seg_cache`` writes multi-feature parts in flat shards of
  ``seg_NNNN.voxels.npy`` (packed ``uint8 [N, R, R, R/8]``) and
  ``seg_NNNN.seg.npy`` (``int8 [N, R, R, R]``, 0 = stock or air, 1+class
  a feature's removal volume), one ``SeedSequence([seed, shard])`` stream
  per shard, the bytes the reference writes. ``label_order="canonical"``
  (the default) labels a voxel several features cover by the feature of
  the lowest class id, ``"generation"`` by the first drawn.
  ``SegCacheDataset`` is a split of it in the segment wire format, as
  ``VoxelCacheDataset`` is of a classify cache; its host augmentation
  rotates each sample's voxels and ``seg`` by one cube rotation together.
  Each reader refuses the other kind of cache. ``build_seg_cache``
  ingests a segmentation STL tree (``voxel_to_mesh.export_seg_stl_tree``:
  ``parts/*.stl`` with ``.seg.npy`` sidecars, ``index.json`` of kind
  ``segment_stl``) into that layout: each mesh voxelized unnormalized (the
  tree must declare ``aligned_unit_cube``), each sidecar checked for its
  shape and against the part (a labelled voxel must be air), inline or
  over a ``spawn`` pool, in shards of the tree's ``shard_size``; over an
  exported tree it gives ``export_seg_cache``'s bytes of the same
  arguments.

Both datasets shard by host as the reference's do: with ``num_hosts`` and
``host_id`` a worker's stream (``SeedSequence([seed, host_id,
worker_id])``) draws ``global_batch // num_hosts`` rows a batch;
``epoch_batches(batch, num_shards, shard_id)`` walks the ``shard_id``-th
decimation of the split (samples ``shard_id, shard_id + num_shards,
...``), every shard as many batches, so the sums of all shards count each
sample once; ``materialize_split(multiple_of, num_shards, shard_id)`` is
feed group ``shard_id``'s contiguous block of the seed-shuffled split,
trimmed to a multiple of ``multiple_of`` rows.

This module and what it imports are numpy and the standard library only
(no torch): ``build_cache``'s and ``build_seg_cache``'s spawned workers
import it and never touch the device.

Both datasets count their gathers and check the
``cache_read_error`` fault site (``faults.py``) at each one: the shape of
an mmapped shard vanishing under a live reader.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Iterator, Sequence

import numpy as np

from featurenet_tpu_torch import faults, obs
from featurenet_tpu_torch.data.stl import load_stl
from featurenet_tpu_torch.data.synthetic import (
    CLASS_NAMES,
    carve,
    generate_sample,
    generate_sample_with_removals,
    pack_voxels,
    random_orientation,
)
from featurenet_tpu_torch.data.voxel_to_mesh import (
    random_rotation_matrix,
    rotate_mesh,
    voxels_to_mesh,
)
from featurenet_tpu_torch.data.voxelize import voxelize

# The reference's stream constant for the resident split's shuffle.
RESIDENT_ORDER_STREAM = 0x4B10C5


def _voxelize_stl_packed(args: tuple[str, int, str, bool]) -> np.ndarray:
    """Worker: one STL file → bit-packed ``uint8 [R, R, R/8]`` occupancy.
    Module-level, so a process pool can pickle it. ``normalize=False`` is
    the aligned tree's path (a segmentation sidecar must stay voxel-exact
    with its mesh)."""
    path, resolution, backend, normalize = args
    grid = voxelize(load_stl(path), resolution, fill=True, backend=backend,
                    normalize=normalize)
    return pack_voxels(grid)


def build_cache(
    stl_root: str,
    out_root: str,
    resolution: int = 64,
    classes: Sequence[str] | None = None,
    backend: str = "auto",
    workers: int | None = None,
) -> dict:
    """Voxelize an STL class tree into packed per-class shards under
    ``out_root``; returns the index.

    ``workers``: the width of a ``spawn`` process pool over the files
    (``None``: ``os.cpu_count()``; 1 or less: inline). The pool keeps file
    order and each file is voxelized on its own, so the bytes do not
    depend on it. Unless ``backend="numpy"`` the native library is built
    here first, so the workers only load it.

    ``label_ids`` pins every class directory named as a canonical class
    to its id, even in a partial tree, so a cache-trained checkpoint
    agrees with the Predictor's id → name mapping; other directory names
    get ids after the canonical block (with a warning: training them needs
    ``num_classes`` to cover them)."""
    if resolution % 8:
        raise ValueError("resolution must be divisible by 8 (packed wire)")
    os.makedirs(out_root, exist_ok=True)
    if classes is None:
        found = {
            d for d in os.listdir(stl_root)
            if os.path.isdir(os.path.join(stl_root, d))
        }
        classes = [c for c in CLASS_NAMES if c in found] + sorted(
            found - set(CLASS_NAMES)
        )
    else:
        classes = list(classes)
    known = {c: i for i, c in enumerate(CLASS_NAMES)}
    next_id = len(CLASS_NAMES)
    label_ids = {}
    for cls in classes:
        if cls in known:
            label_ids[cls] = known[cls]
        else:
            label_ids[cls] = next_id
            next_id += 1
    if next_id > len(CLASS_NAMES):
        unknown = [c for c in classes if c not in known]
        msg = (f"build_cache: non-canonical class dirs {unknown} get label "
               "ids past the canonical block; training them needs "
               f"num_classes >= {next_id} (the presets have 24, and the "
               "Trainer refuses out-of-range labels)")
        warnings.warn(msg, stacklevel=2)
        # The run's record of it too (stderr has the Python warning).
        obs.emit("warning", name="build_cache_warning", msg=msg, dirs=unknown)
    index = {
        "resolution": resolution,
        "storage": "packed",
        "classes": [],
        "counts": {},
        "label_ids": label_ids,
    }
    if workers is None:
        workers = os.cpu_count() or 1
    if backend != "numpy":
        from featurenet_tpu_torch import native

        native.available()  # build it here, so the workers only load it
    pool = None
    if workers > 1:
        import multiprocessing

        # spawn, not fork: the caller may hold a CUDA context, which a
        # forked child must not inherit.
        pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        for cls in classes:
            cdir = os.path.join(stl_root, cls)
            files = sorted(
                f for f in os.listdir(cdir) if f.lower().endswith(".stl")
            )
            # One span per class (the pool's workers have no sink).
            with obs.span("build_cache_class", cls=cls, files=len(files),
                          workers=workers):
                packed = np.zeros(
                    (len(files), resolution, resolution, resolution // 8),
                    dtype=np.uint8,
                )
                work = [(os.path.join(cdir, f), resolution, backend, True)
                        for f in files]
                if pool is not None:
                    rows = pool.imap(
                        _voxelize_stl_packed, work,
                        chunksize=max(1, len(work) // (workers * 4) or 1),
                    )
                else:
                    rows = map(_voxelize_stl_packed, work)
                for i, row in enumerate(rows):
                    packed[i] = row
            np.save(os.path.join(out_root, f"{cls}.npy"), packed)
            with open(os.path.join(out_root, f"{cls}.files.json"), "w") as fh:
                json.dump(files, fh)
            index["classes"].append(cls)
            index["counts"][cls] = len(files)
    except BaseException:
        if pool is not None:
            # terminate, not close: close would first drain every queued
            # voxelization of the doomed build.
            pool.terminate()
            pool.join()
            pool = None
        raise
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    with open(os.path.join(out_root, "index.json"), "w") as fh:
        json.dump(index, fh, indent=1)
    return index


def export_synthetic_cache(out_root: str, per_class: int = 100,
                           resolution: int = 64, seed: int = 0,
                           orient: bool = True, param_range=None,
                           mesh_pose: str = "none",
                           margin_jitter: tuple | None = None) -> dict:
    """Write ``per_class`` generated parts of every class into the packed
    cache layout under ``out_root``; returns the index.

    ``param_range``: the feature-parameter quantile window (``"mid"``,
    ``"tails"``, ``(lo, hi)`` or ``None``; ``synthetic._ParamRange``).
    ``mesh_pose``: ``"none"`` packs the parts as generated; ``"remesh"``
    routes each through the STL pipeline (``voxels_to_mesh`` →
    ``voxelize``, normalized at the margin); ``"so3"`` also rotates the
    mesh uniformly at random. ``margin_jitter=(lo, hi)`` draws each part's
    normalization margin (default 0.05) and implies the mesh route."""
    if mesh_pose not in ("none", "remesh", "so3"):
        raise ValueError(
            f"mesh_pose {mesh_pose!r}: expected 'none', 'remesh', or 'so3'"
        )
    use_mesh = mesh_pose != "none" or margin_jitter is not None
    if resolution % 8:
        raise ValueError("resolution must be divisible by 8 (packed wire)")
    os.makedirs(out_root, exist_ok=True)
    index = {
        "resolution": resolution,
        "storage": "packed",
        "classes": [],
        "counts": {},
        "seed": seed,
        "label_ids": {cls: i for i, cls in enumerate(CLASS_NAMES)},
        "param_range": (
            list(param_range) if isinstance(param_range, (tuple, list))
            else param_range
        ),
        "mesh_pose": mesh_pose,
        "margin_jitter": list(margin_jitter) if margin_jitter else None,
    }
    for cls_id, cls in enumerate(CLASS_NAMES):
        rng = np.random.default_rng(np.random.SeedSequence([seed, cls_id]))
        with obs.span("export_class", cls=cls, n=per_class,
                      mesh_pose=mesh_pose):
            # Packed one part at a time: the transient is one unpacked grid.
            packed = np.zeros(
                (per_class, resolution, resolution, resolution // 8),
                dtype=np.uint8)
            for i in range(per_class):
                part, _, _ = generate_sample(rng, resolution, label=cls_id,
                                             orient=orient,
                                             param_range=param_range)
                if use_mesh:
                    tris = voxels_to_mesh(part.astype(bool))
                    if mesh_pose == "so3":
                        tris = rotate_mesh(tris, random_rotation_matrix(rng))
                    m = (0.05 if margin_jitter is None
                         else float(rng.uniform(*margin_jitter)))
                    part = voxelize(tris, resolution, fill=True, margin=m)
                packed[i] = pack_voxels(part)
        np.save(os.path.join(out_root, f"{cls}.npy"), packed)
        with open(os.path.join(out_root, f"{cls}.files.json"), "w") as fh:
            json.dump([f"synthetic_{i:05d}" for i in range(per_class)], fh)
        index["classes"].append(cls)
        index["counts"][cls] = per_class
    with open(os.path.join(out_root, "index.json"), "w") as fh:
        json.dump(index, fh, indent=1)
    return index


def _generate_seg_sample(rng: np.random.Generator, resolution: int,
                         num_features: int,
                         label_order: str) -> tuple[np.ndarray, np.ndarray]:
    """One segmentation sample ``(part bool [R³], seg int32 [R³])``. The
    part does not depend on ``label_order``; a voxel that several
    features' removal volumes cover is labelled by the feature of the
    lowest class id (``"canonical"``: a function of the part's features,
    so learnable) or by the first one drawn (``"generation"``)."""
    part, labels, seg, removals = generate_sample_with_removals(
        rng, resolution, num_features=num_features)
    if label_order == "canonical":
        _, seg = carve(labels, removals,
                       order=np.argsort(labels, kind="stable"),
                       resolution=resolution)
    elif label_order != "generation":
        raise ValueError(f"unknown label_order {label_order!r}")
    return part, seg


def export_seg_cache(out_root: str, num_parts: int = 2400,
                     resolution: int = 64, num_features: int = 3,
                     shard_size: int = 200, seed: int = 0,
                     label_order: str = "canonical") -> dict:
    """Write ``num_parts`` multi-feature parts with their per-voxel labels
    into the segmentation cache layout under ``out_root`` (see the module
    docstring), ``shard_size`` parts a shard; returns the index."""
    if resolution % 8:
        raise ValueError("resolution must be divisible by 8 (packed wire)")
    os.makedirs(out_root, exist_ok=True)
    index = {
        "kind": "segment",
        "resolution": resolution,
        "storage": "packed",
        "num_features": num_features,
        "shards": [],
        "seed": seed,
        "label_order": label_order,
    }
    done = shard_id = 0
    while done < num_parts:
        n = min(shard_size, num_parts - done)
        rng = np.random.default_rng(np.random.SeedSequence([seed, shard_id]))
        stem = f"seg_{shard_id:04d}"
        with obs.span("export_seg_shard", shard=stem, n=n):
            voxels = np.zeros((n, resolution, resolution, resolution // 8),
                              np.uint8)
            seg = np.zeros((n, resolution, resolution, resolution), np.int8)
            for i in range(n):
                part, s = _generate_seg_sample(rng, resolution, num_features,
                                               label_order)
                voxels[i] = pack_voxels(part)
                seg[i] = s.astype(np.int8)
            np.save(os.path.join(out_root, f"{stem}.voxels.npy"), voxels)
            np.save(os.path.join(out_root, f"{stem}.seg.npy"), seg)
        index["shards"].append({"stem": stem, "count": n})
        done += n
        shard_id += 1
    with open(os.path.join(out_root, "index.json"), "w") as fh:
        json.dump(index, fh, indent=1)
    return index


def build_seg_cache(
    stl_root: str,
    out_root: str,
    backend: str = "auto",
    workers: int | None = None,
    shard_size: int | None = None,
) -> dict:
    """Ingest a segmentation STL tree (meshes with per-voxel label
    sidecars) into the packed segmentation cache layout under
    ``out_root``; returns the index.

    Refused: a tree whose ``index.json`` is not of kind ``segment_stl``,
    or that does not declare ``aligned_unit_cube`` (normalizing would
    shift each part against its labels). Each mesh is voxelized with
    ``normalize=False`` at the tree's resolution, in part order, inline
    or over a ``spawn`` pool of ``workers`` (``None``: one per core); a
    sidecar of another shape, or a labelled voxel (a feature's removed
    volume) that the voxelized part occupies, is refused. Shards hold
    ``shard_size`` parts (default: the tree's)."""
    with open(os.path.join(stl_root, "index.json")) as fh:
        tree = json.load(fh)
    if tree.get("kind") != "segment_stl":
        raise ValueError(
            f"{stl_root} is not a segmentation STL tree (export with "
            "`cli export-stl-data --seg`); classification trees go "
            "through build_cache"
        )
    if not tree.get("aligned_unit_cube"):
        raise ValueError(
            "segmentation ingest needs aligned_unit_cube trees: per-voxel "
            "sidecars are only meaningful in the mesh's own grid frame, "
            "and normalization would shift the part against its labels"
        )
    resolution = int(tree["resolution"])
    if shard_size is None:
        shard_size = int(tree.get("shard_size", 200))
    pdir = os.path.join(stl_root, "parts")
    stems = sorted(f[:-4] for f in os.listdir(pdir)
                   if f.lower().endswith(".stl"))
    if not stems:
        raise ValueError(f"no .stl parts under {pdir}")
    os.makedirs(out_root, exist_ok=True)
    index = {
        "kind": "segment",
        "resolution": resolution,
        "storage": "packed",
        "num_features": tree.get("num_features"),
        "shards": [],
        "source": {"stl_tree": os.path.abspath(stl_root),
                   "label_order": tree.get("label_order")},
    }
    if workers is None:
        workers = os.cpu_count() or 1
    if backend != "numpy":
        from featurenet_tpu_torch import native

        native.available()  # build it here, so the workers only load it
    pool = None
    if workers > 1:
        import multiprocessing

        # spawn, not fork: the caller may hold a CUDA context.
        pool = multiprocessing.get_context("spawn").Pool(workers)
    try:
        work = [(os.path.join(pdir, s + ".stl"), resolution, backend, False)
                for s in stems]
        if pool is not None:
            rows = pool.imap(_voxelize_stl_packed, work,
                             chunksize=max(1, len(work) // (workers * 4) or 1))
        else:
            rows = map(_voxelize_stl_packed, work)
        shard_id = 0
        vox_buf, seg_buf = [], []

        def flush():
            nonlocal shard_id
            stem = f"seg_{shard_id:04d}"
            with obs.span("seg_cache_flush", shard=stem, n=len(vox_buf)):
                np.save(os.path.join(out_root, f"{stem}.voxels.npy"),
                        np.stack(vox_buf))
                np.save(os.path.join(out_root, f"{stem}.seg.npy"),
                        np.stack(seg_buf))
            index["shards"].append({"stem": stem, "count": len(vox_buf)})
            vox_buf.clear()
            seg_buf.clear()
            shard_id += 1

        with obs.span("build_seg_cache", parts=len(stems), workers=workers):
            for stem, packed in zip(stems, rows):
                seg = np.load(os.path.join(pdir, stem + ".seg.npy"))
                if seg.shape != (resolution,) * 3:
                    raise ValueError(
                        f"{stem}: sidecar shape {seg.shape} != grid "
                        f"{(resolution,) * 3}"
                    )
                part = np.unpackbits(packed, axis=-1).astype(bool)
                if (part & (seg > 0)).any():
                    raise ValueError(
                        f"{stem}: labeled voxels occupied in the voxelized "
                        "part -- mesh and sidecar are misaligned (was the "
                        "tree exported aligned_unit_cube?)"
                    )
                vox_buf.append(packed)
                seg_buf.append(seg.astype(np.int8))
                if len(vox_buf) >= shard_size:
                    flush()
            if vox_buf:
                flush()
    except BaseException:
        if pool is not None:
            pool.terminate()
            pool.join()
            pool = None
        raise
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    with open(os.path.join(out_root, "index.json"), "w") as fh:
        json.dump(index, fh, indent=1)
    return index


# One open cache per process, keyed by (directory, index mtime): the train
# and test splits index into the same per-class arrays.
_cache_memo: dict = {}


def _open_packed(cache_root: str, name: str) -> np.ndarray:
    """mmap one packed shard; fancy indexing copies out only the drawn
    rows' pages."""
    return np.load(os.path.join(cache_root, f"{name}.npy"), mmap_mode="r")


def _load_cache(cache_root: str):
    """``(index, {class: packed array})`` of the cache at ``cache_root``."""
    index_path = os.path.join(cache_root, "index.json")
    key = (os.path.abspath(cache_root), os.path.getmtime(index_path))
    if key not in _cache_memo:
        with open(index_path) as fh:
            index = json.load(fh)
        if index.get("kind") == "segment":
            raise ValueError(
                f"{cache_root} is a segmentation cache; use it with "
                "task='segment' (SegCacheDataset), not a classify config"
            )
        packed = {}
        for cls in index["classes"]:
            if index.get("storage") == "packed":
                packed[cls] = _open_packed(cache_root, cls)
            else:
                with np.load(os.path.join(cache_root, f"{cls}.npz")) as z:
                    packed[cls] = pack_voxels(z["voxels"])  # validates W%8
        _cache_memo.clear()  # hold at most one cache resident
        _cache_memo[key] = (index, packed)
    return _cache_memo[key]


def _load_seg_cache(cache_root: str):
    """``(index, voxel shards, seg shards)`` of the segmentation cache at
    ``cache_root``: lists of per-shard arrays, mmapped when packed, so a
    large cache is never read whole."""
    index_path = os.path.join(cache_root, "index.json")
    key = ("seg", os.path.abspath(cache_root), os.path.getmtime(index_path))
    if key not in _cache_memo:
        with open(index_path) as fh:
            index = json.load(fh)
        if index.get("kind") != "segment":
            raise ValueError(
                f"{cache_root} is not a segmentation cache (export with "
                "export_seg_cache / `cli export-seg-data`)"
            )
        voxels, seg = [], []
        for sh in index["shards"]:
            if index.get("storage") == "packed":
                voxels.append(_open_packed(cache_root, sh["stem"] + ".voxels"))
                seg.append(_open_packed(cache_root, sh["stem"] + ".seg"))
            else:
                with np.load(os.path.join(cache_root, sh["file"])) as z:
                    voxels.append(pack_voxels(z["voxels"]))  # validates W%8
                    seg.append(z["seg"])
        _cache_memo.clear()  # hold at most one cache resident
        _cache_memo[key] = (index, voxels, seg)
    return _cache_memo[key]


def _count_read(ds) -> None:
    """Count one gather of a cache dataset and check the
    ``cache_read_error`` fault site at it."""
    ds._reads += 1
    if faults.maybe_fail("cache_read_error", read=ds._reads):
        raise faults.InjectedFault(
            f"cache_read_error at gather #{ds._reads} (the mmapped shard "
            "behind this batch went away)")


def _resident_order(seed: int, n: int) -> np.ndarray:
    """The seed-shuffled order of a split's ``n`` samples that a
    device-resident upload lays out."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, RESIDENT_ORDER_STREAM]))
    return rng.permutation(n)


def _resident_block(seed: int, n: int, multiple_of: int, num_shards: int,
                    shard_id: int) -> tuple[np.ndarray, int]:
    """Feed group ``shard_id``'s contiguous block of the resident order,
    trimmed to a multiple of ``multiple_of`` rows, and the trimmed count."""
    keep = n - (n % max(multiple_of, 1))
    if keep < num_shards:
        raise ValueError(
            f"split has {n} rows; {keep} after trimming to a multiple of "
            f"{multiple_of} -- too few for {num_shards} feed groups")
    order = _resident_order(seed, n)[:keep]
    return (order[keep * shard_id // num_shards:
                  keep * (shard_id + 1) // num_shards], keep)


def _hash_split_rows(n: int, split: str, test_fraction: float) -> np.ndarray:
    """The rows of ``n`` that fall in ``split`` under a fixed per-index
    hash: the same rows are held out whatever the epoch."""
    h = (np.arange(n) * 2654435761 % 1000) / 1000.0
    keep = h >= test_fraction if split == "train" else h < test_fraction
    return np.nonzero(keep)[0].astype(np.int64)


def _epoch_index_batches(n: int, batch: int, num_shards: int = 1,
                         shard_id: int = 0):
    """``(indices, mask)`` batches of shard ``shard_id``'s part of one exact
    pass over ``n`` rows (rows ``shard_id, shard_id + num_shards, ...``);
    the last partial batch wraps to the front with ``mask = 0`` rows, so
    masked sums count every row once while every batch has ``batch`` rows.
    Every shard yields as many batches (the largest shard's count): the
    hosts of a world evaluate in lockstep."""
    if n <= 0:
        raise ValueError("epoch over an empty split")
    rows = np.arange(shard_id, n, num_shards, dtype=np.int64)
    largest = (n + num_shards - 1) // num_shards
    for b in range(max((largest + batch - 1) // batch, 1)):
        idx = rows[b * batch:(b + 1) * batch]
        mask = np.ones(batch, dtype=np.float32)
        if len(idx) < batch:
            mask[len(idx):] = 0.0
            idx = np.concatenate([idx, np.arange(batch - len(idx)) % n])
        yield idx, mask


class VoxelCacheDataset:
    """A split of a packed voxel cache in the classify wire format:
    ``voxels`` bit-packed ``uint8 [B, R, R, R/8]``, ``label`` int32 and
    ``mask`` float32, as ``SyntheticVoxelDataset`` gives, so the
    ``Prefetcher`` and the Trainer take either.

    ``split`` is ``"train"`` or ``"test"`` (a per-index hash holds out
    ``test_fraction`` of each class). ``augment=True`` rotates every drawn
    sample by a random cube rotation on the host; exact passes never
    augment. A class's label is its ``label_ids`` entry in the index.
    ``num_hosts``/``host_id`` shard the stream by host (see the module
    docstring).
    """

    def __init__(self, cache_root: str, global_batch: int = 96,
                 split: str = "train", test_fraction: float = 0.2,
                 seed: int = 0, augment: bool = False, num_hosts: int = 1,
                 host_id: int = 0):
        if global_batch % num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.index, packed = _load_cache(cache_root)
        self.resolution = int(self.index["resolution"])
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.seed = seed
        self.augment = augment
        self._reads = 0  # gathers so far (the cache_read_error counter)
        # Sample m is self._packed[self._cls_pos[m]][self.rows[m]]; only a
        # gather copies sample bytes out of the shared (mmapped) arrays.
        self._packed = [packed[cls] for cls in self.index["classes"]]
        label_ids = self.index.get("label_ids")
        if label_ids is None:
            # Positional labels are safe only when the stored order agrees
            # with the canonical ids; otherwise the class names would be
            # permuted silently.
            mismatched = [(pos, cls) for pos, cls in enumerate(self.index["classes"])
                          if cls in CLASS_NAMES and CLASS_NAMES.index(cls) != pos]
            if mismatched:
                pos, cls = mismatched[0]
                raise ValueError(
                    f"cache {cache_root!r} predates the label_ids index "
                    f"field and stores {cls!r} at position {pos} (canonical "
                    f"id {CLASS_NAMES.index(cls)}); positional labels would "
                    "silently permute class names. Rebuild the cache "
                    "(`cli export-data`)."
                )
            label_ids = {cls: pos for pos, cls in enumerate(self.index["classes"])}
        rows, labels, cls_pos = [], [], []
        for pos, cls in enumerate(self.index["classes"]):
            r = _hash_split_rows(self._packed[pos].shape[0], split, test_fraction)
            rows.append(r)
            cls_pos.append(np.full(len(r), pos, dtype=np.int32))
            labels.append(np.full(len(r), int(label_ids[cls]), dtype=np.int32))
        self.rows = np.concatenate(rows)
        self.labels = np.concatenate(labels)
        self._cls_pos = np.concatenate(cls_pos)
        if len(self.labels) == 0:
            raise ValueError(f"empty split {split!r} in {cache_root}")

    def __len__(self) -> int:
        return len(self.labels)

    def _gather(self, idx: np.ndarray,
                rng: np.random.Generator | None = None) -> np.ndarray:
        """Packed ``[len(idx), R, R, R/8]`` voxels of samples ``idx``: the
        stored bytes are the wire format, so without augmentation this is
        fancy indexing alone. With ``rng`` each sample is unpacked, rotated
        by one random cube rotation and packed again."""
        _count_read(self)
        rows = self.rows[idx]
        cls = self._cls_pos[idx]
        r = self.resolution
        out = np.empty((len(idx), r, r, r // 8), np.uint8)
        for p in np.unique(cls):
            m = cls == p
            out[m] = self._packed[p][rows[m]]
        if rng is not None:
            grids = np.unpackbits(out, axis=-1)
            out = pack_voxels(np.stack([random_orientation(rng)(g) for g in grids]))
        return out

    def resident_order(self) -> np.ndarray:
        """The seed-shuffled order of the split's samples that
        ``materialize_split`` lays out: resident row ``i`` is sample
        ``resident_order()[i]``."""
        return _resident_order(self.seed, len(self.labels))

    def materialize_split(self, multiple_of: int = 1, num_shards: int = 1,
                          shard_id: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
        """Feed group ``shard_id``'s block of the split for a
        device-resident upload: ``(packed voxels, labels, rows)``, rows the
        split's count trimmed to a multiple of ``multiple_of``; with the
        defaults the whole split in ``resident_order()``. The train step
        rotates on the device, so the rows are as stored."""
        rows, keep = _resident_block(self.seed, len(self.labels), multiple_of,
                                     num_shards, shard_id)
        return self._gather(rows), self.labels[rows], keep

    def worker_iter(self, worker_id: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """An independent infinite stream of uniformly drawn batches of
        this host's rows for one producer worker (``SeedSequence([seed,
        host_id, worker_id])``, the reference's fold)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, worker_id]))
        n = len(self.labels)
        while True:
            idx = rng.integers(0, n, size=self.local_batch)
            voxels = self._gather(idx, rng if self.augment else None)
            yield {"voxels": voxels, "label": self.labels[idx],
                   "mask": np.ones(self.local_batch, dtype=np.float32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.worker_iter(0)

    def epoch_batches(self, batch: int, num_shards: int = 1,
                      shard_id: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Shard ``shard_id``'s part of one exact pass over the split, every
        sample in one shard once; the last batch is padded with ``mask =
        0`` rows."""
        for idx, mask in _epoch_index_batches(len(self.labels), batch,
                                              num_shards, shard_id):
            yield {"voxels": self._gather(idx), "label": self.labels[idx],
                   "mask": mask}


class SegCacheDataset:
    """A split of a segmentation cache in the segment wire format:
    ``voxels`` bit-packed ``uint8 [B, R, R, R/8]``, ``seg`` int8 ``[B, R, R,
    R]`` and ``mask`` float32, as ``SyntheticVoxelDataset(task="segment")``
    gives. ``split`` holds out rows by the same per-index hash as
    ``VoxelCacheDataset``. ``augment=True`` rotates each drawn sample's
    voxels and ``seg`` by one random cube rotation together, on the host
    (a per-voxel target must turn with its part); exact passes never
    augment."""

    def __init__(self, cache_root: str, global_batch: int = 32,
                 split: str = "train", test_fraction: float = 0.2,
                 seed: int = 0, augment: bool = False, num_hosts: int = 1,
                 host_id: int = 0):
        if global_batch % num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")
        self.index, self._voxels, self._seg = _load_seg_cache(cache_root)
        self.resolution = int(self.index["resolution"])
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.host_id = host_id
        self.seed = seed
        self.augment = augment
        self._reads = 0
        # Row g of the cache is shard _shard_pos[g], row _row_in_shard[g].
        counts = [v.shape[0] for v in self._voxels]
        self._shard_pos = np.repeat(np.arange(len(counts), dtype=np.int32),
                                    counts)
        self._row_in_shard = (
            np.concatenate([np.arange(c, dtype=np.int64) for c in counts])
            if counts else np.zeros(0, np.int64))
        self.rows = _hash_split_rows(int(sum(counts)), split, test_fraction)
        if len(self.rows) == 0:
            raise ValueError(f"empty split {split!r} in {cache_root}")

    def __len__(self) -> int:
        return len(self.rows)

    def _gather(self, idx: np.ndarray, rng: np.random.Generator | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
        """``(packed voxels [n, R, R, R/8], seg int8 [n, R, R, R])`` of split
        rows ``idx``: fancy indexing of the stored bytes, which are the
        wire format. With ``rng`` each sample is unpacked, rotated with its
        ``seg`` by one random cube rotation, and packed again."""
        _count_read(self)
        g = self.rows[idx]
        sh, rw = self._shard_pos[g], self._row_in_shard[g]
        r = self.resolution
        vox = np.empty((len(g), r, r, r // 8), np.uint8)
        seg = np.empty((len(g), r, r, r), np.int8)
        for p in np.unique(sh):
            m = sh == p
            vox[m] = self._voxels[p][rw[m]]
            seg[m] = self._seg[p][rw[m]]
        if rng is not None:
            grids = np.unpackbits(vox, axis=-1)
            rot_v, rot_s = [], []
            for v, t in zip(grids, seg):
                rot = random_orientation(rng)
                rot_v.append(rot(v))
                rot_s.append(rot(t))
            vox = pack_voxels(np.stack(rot_v))
            seg = np.stack(rot_s)
        return vox, seg

    def resident_order(self) -> np.ndarray:
        """The seed-shuffled order ``materialize_split`` lays out."""
        return _resident_order(self.seed, len(self.rows))

    def materialize_split(self, multiple_of: int = 1, num_shards: int = 1,
                          shard_id: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
        """Feed group ``shard_id``'s block of the split for a
        device-resident upload: ``(packed voxels, seg int8, rows)``, as
        ``VoxelCacheDataset.materialize_split``; as stored (the train step
        rotates voxels and ``seg`` together on the device)."""
        rows, keep = _resident_block(self.seed, len(self.rows), multiple_of,
                                     num_shards, shard_id)
        vox, seg = self._gather(rows)
        return vox, seg, keep

    def worker_iter(self, worker_id: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """An independent infinite stream of uniformly drawn batches of
        this host's rows for one producer worker (``SeedSequence([seed,
        host_id, worker_id])``)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host_id, worker_id]))
        n = len(self.rows)
        while True:
            idx = rng.integers(0, n, size=self.local_batch)
            v, t = self._gather(idx, rng if self.augment else None)
            yield {"voxels": v, "seg": t,
                   "mask": np.ones(self.local_batch, dtype=np.float32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.worker_iter(0)

    def epoch_batches(self, batch: int, num_shards: int = 1,
                      shard_id: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """Shard ``shard_id``'s part of one exact pass over the split, every
        sample in one shard once; the last batch is padded with ``mask =
        0`` rows."""
        for idx, mask in _epoch_index_batches(len(self.rows), batch,
                                              num_shards, shard_id):
            v, t = self._gather(idx)
            yield {"voxels": v, "seg": t, "mask": mask}
