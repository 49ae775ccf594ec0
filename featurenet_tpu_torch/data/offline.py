"""The packed voxel cache: synthetic export and the classify reader (port of
the classify half of ``featurenet_tpu/data/offline.py``).

- Layout (``storage: "packed"`` in ``index.json``): one ``<cls>.npy`` per
  class holding bit-packed ``uint8 [N, R, R, R/8]`` voxels, byte for byte
  the wire format (``synthetic.pack_voxels``), a ``<cls>.files.json`` of
  provenance and a top-level ``index.json`` with the classes, counts and
  canonical ``label_ids``. The shards are read through ``np.load(...,
  mmap_mode="r")``, so the host holds the pages the sampler touches, not
  the cache. Legacy ``.npz`` caches (unpacked) are packed once at open.
- ``export_synthetic_cache`` writes the parametric generator's parts in
  that layout, one ``SeedSequence([seed, class_id])`` stream per class, as
  the reference does: a cache written by either package has the same
  bytes and loads in the other.
- ``VoxelCacheDataset`` is a split of a cache (a fixed hash of each row's
  index holds out ``test_fraction`` of every class) in the classify wire
  format: an infinite sampled stream per producer worker
  (``worker_iter``), one exact pass (``epoch_batches``) and the seed-
  shuffled split for a device-resident upload (``materialize_split``).
  ``augment=True`` rotates each drawn sample on the host by one of the 24
  cube rotations; with device augmentation the train step rotates instead.

The port runs one host, so the reference's host sharding (``num_hosts``,
``host_id``, ``num_shards``) is fixed at one host, id 0. Not ported yet:
``build_cache`` from an STL tree, the ``param_range``, ``mesh_pose`` and
``margin_jitter`` exports and the segmentation caches.

``VoxelCacheDataset`` counts its gathers and checks the
``cache_read_error`` fault site (``faults.py``) at each one: the shape of
an mmapped shard vanishing under a live reader.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from featurenet_tpu_torch import faults
from featurenet_tpu_torch.data.synthetic import (
    CLASS_NAMES,
    generate_sample,
    pack_voxels,
    random_orientation,
)

# The reference's stream constant for the resident split's shuffle.
RESIDENT_ORDER_STREAM = 0x4B10C5


def export_synthetic_cache(out_root: str, per_class: int = 100,
                           resolution: int = 64, seed: int = 0,
                           orient: bool = True) -> dict:
    """Write ``per_class`` generated parts of every class into the packed
    cache layout under ``out_root``; returns the index."""
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
        # The reference's provenance fields, at their defaults: the full
        # parameter range, parts as generated, no margin jitter.
        "param_range": None,
        "mesh_pose": "none",
        "margin_jitter": None,
    }
    for cls_id, cls in enumerate(CLASS_NAMES):
        rng = np.random.default_rng(np.random.SeedSequence([seed, cls_id]))
        # Packed one part at a time: the transient is one unpacked grid.
        packed = np.zeros((per_class, resolution, resolution, resolution // 8),
                          dtype=np.uint8)
        for i in range(per_class):
            part, _, _ = generate_sample(rng, resolution, label=cls_id,
                                         orient=orient)
            packed[i] = pack_voxels(part)
        np.save(os.path.join(out_root, f"{cls}.npy"), packed)
        with open(os.path.join(out_root, f"{cls}.files.json"), "w") as fh:
            json.dump([f"synthetic_{i:05d}" for i in range(per_class)], fh)
        index["classes"].append(cls)
        index["counts"][cls] = per_class
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
                f"{cache_root} is a segmentation cache; the port trains "
                "the classifier only"
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


def _hash_split_rows(n: int, split: str, test_fraction: float) -> np.ndarray:
    """The rows of ``n`` that fall in ``split`` under a fixed per-index
    hash: the same rows are held out whatever the epoch."""
    h = (np.arange(n) * 2654435761 % 1000) / 1000.0
    keep = h >= test_fraction if split == "train" else h < test_fraction
    return np.nonzero(keep)[0].astype(np.int64)


def _epoch_index_batches(n: int, batch: int):
    """``(indices, mask)`` batches of one exact pass over ``n`` rows; the
    last partial batch wraps to the front with ``mask = 0`` rows, so masked
    sums count every row once while every batch has ``batch`` rows."""
    if n <= 0:
        raise ValueError("epoch over an empty split")
    rows = np.arange(n, dtype=np.int64)
    for b in range(max((n + batch - 1) // batch, 1)):
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
    """

    def __init__(self, cache_root: str, global_batch: int = 96,
                 split: str = "train", test_fraction: float = 0.2,
                 seed: int = 0, augment: bool = False):
        self.index, packed = _load_cache(cache_root)
        self.resolution = int(self.index["resolution"])
        self.global_batch = global_batch
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
        self._reads += 1
        if faults.maybe_fail("cache_read_error", read=self._reads):
            raise faults.InjectedFault(
                f"cache_read_error at gather #{self._reads} (the mmapped "
                "shard behind this batch went away)")
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
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, RESIDENT_ORDER_STREAM]))
        return rng.permutation(len(self.labels))

    def materialize_split(self) -> tuple[np.ndarray, np.ndarray, int]:
        """The whole split for a device-resident upload: ``(packed voxels,
        labels, rows)`` in ``resident_order()``. The train step rotates on
        the device, so the rows are as stored."""
        order = self.resident_order()
        return self._gather(order), self.labels[order], len(order)

    def worker_iter(self, worker_id: int = 0) -> Iterator[dict[str, np.ndarray]]:
        """An independent infinite stream of uniformly drawn batches for
        one producer worker (``SeedSequence([seed, 0, worker_id])``, the
        reference's fold for host 0)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0, worker_id]))
        n = len(self.labels)
        while True:
            idx = rng.integers(0, n, size=self.global_batch)
            voxels = self._gather(idx, rng if self.augment else None)
            yield {"voxels": voxels, "label": self.labels[idx],
                   "mask": np.ones(self.global_batch, dtype=np.float32)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self.worker_iter(0)

    def epoch_batches(self, batch: int) -> Iterator[dict[str, np.ndarray]]:
        """One exact pass over the split, every sample once; the last
        batch is padded with ``mask = 0`` rows."""
        for idx, mask in _epoch_index_batches(len(self.labels), batch):
            yield {"voxels": self._gather(idx), "label": self.labels[idx],
                   "mask": mask}
