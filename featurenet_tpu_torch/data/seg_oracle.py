"""The measured IoU ceiling of segmentation under the generator's label
ambiguity (port of ``featurenet_tpu/data/seg_oracle.py``). Model-free,
numpy and the standard library only.

``generate_sample_with_removals`` carves its features in generation order,
and a voxel that several removal volumes cover keeps the earlier
feature's label, while the part itself (``stock & ~union(removals)``) does
not depend on the order. The features are drawn iid, so for any
permutation of a part's features, ``carve(labels, removals, order)`` is an
equally likely ground truth for the same input grid. Every number is the
eval metric of ``train.steps.aggregate_eval`` (per-class intersection and
union summed over the set, IoU per class, the mean over the classes
present):

- ``iou_random_pair``: two independently ordered ground truths of the same
  parts against each other, what a predictor that gets the geometry right
  and guesses the order scores;
- ``iou_canonical``: the canonical order (by class id, stable), the best
  deterministic tie-break, against the generator's order;
- ``iou_extent_guess``: against the canonical labels, each voxel that
  several features cover relabelled by a feature drawn uniformly among
  its covers (a predictor blind to extents through overlaps);
- ``iou_overlap_worst``: the same with the canonically last cover;
- ``overlap_error_share_at_0889`` (at R=64 and 3 features only): the share
  of a 0.889 model's gap the extent guess alone accounts for;
- ``ambiguous_voxel_fraction`` and ``per_class_iou_canonical``.

Run:  python -m featurenet_tpu_torch.data.seg_oracle [--resolution 64]
          [--num-features 3] [--samples 1024] [--seed 0]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from featurenet_tpu_torch.data.synthetic import (
    NUM_CLASSES,
    carve,
    generate_sample_with_removals,
)


def _accumulate_iou(inter, union, seg_true, seg_pred, n_cls):
    """Add one sample's per-class intersection and union counts."""
    t = seg_true.ravel()
    p = seg_pred.ravel()
    agree = t == p
    inter += np.bincount(t[agree], minlength=n_cls)[:n_cls]
    union += (
        np.bincount(t, minlength=n_cls)[:n_cls]
        + np.bincount(p, minlength=n_cls)[:n_cls]
        - np.bincount(t[agree], minlength=n_cls)[:n_cls]
    )


def _mean_iou(inter, union):
    present = union > 0
    iou = np.where(present, inter / np.maximum(union, 1), 0.0)
    return float(iou.sum() / max(int(present.sum()), 1)), iou, present


def measure_ceiling(
    resolution: int = 64,
    num_features: int = 3,
    samples: int = 1024,
    seed: int = 0,
) -> dict:
    """Monte-Carlo estimate of the ambiguity ceilings over ``samples``
    parts from ``SeedSequence([seed, 7001])``; returns the numbers of the
    module docstring."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7001]))
    n_cls = NUM_CLASSES + 1  # + background
    inter_rp = np.zeros(n_cls, np.int64)
    union_rp = np.zeros(n_cls, np.int64)
    inter_cn = np.zeros(n_cls, np.int64)
    union_cn = np.zeros(n_cls, np.int64)
    inter_eg = np.zeros(n_cls, np.int64)
    union_eg = np.zeros(n_cls, np.int64)
    inter_ow = np.zeros(n_cls, np.int64)
    union_ow = np.zeros(n_cls, np.int64)
    ambiguous = 0
    labeled = 0
    for _ in range(samples):
        _, labels, seg, removals = generate_sample_with_removals(
            rng, resolution, num_features=num_features
        )
        # Two more equally valid ground truths of the same part: a fresh
        # random order and the canonical one.
        perm = rng.permutation(num_features)
        _, seg_perm = carve(labels, removals, order=perm)
        canon = np.argsort(labels, kind="stable")
        _, seg_canon = carve(labels, removals, order=canon)
        _accumulate_iou(inter_rp, union_rp, seg, seg_perm, n_cls)
        _accumulate_iou(inter_cn, union_cn, seg, seg_canon, n_cls)
        # Ambiguous voxels: carved and covered by two removals or more.
        cover = np.stack([r.astype(bool) for r in removals])
        cover_n = cover.sum(axis=0)
        multi = (cover_n >= 2) & (seg_canon > 0)
        ambiguous += int(multi.sum())
        labeled += int((seg_canon > 0).sum())

        # Against the canonical labels, each multi-covered voxel (a) to a
        # uniformly guessed cover, (b) to the canonically last cover;
        # single-cover voxels stay as they are.
        if multi.any():
            cov_m = cover[:, multi]  # [k, n_multi]
            lab_sorted = labels[canon]
            cov_sorted = cov_m[canon]
            u = rng.random(cov_sorted.shape) * cov_sorted
            seg_guess = seg_canon.copy()
            seg_guess[multi] = 1 + lab_sorted[np.argmax(u, axis=0)]
            seg_worst = seg_canon.copy()
            k = cov_sorted.shape[0]
            last_idx = (k - 1) - np.argmax(cov_sorted[::-1], axis=0)
            seg_worst[multi] = 1 + lab_sorted[last_idx]
        else:
            seg_guess = seg_canon
            seg_worst = seg_canon
        _accumulate_iou(inter_eg, union_eg, seg_canon, seg_guess, n_cls)
        _accumulate_iou(inter_ow, union_ow, seg_canon, seg_worst, n_cls)

    miou_rp, iou_rp, present = _mean_iou(inter_rp, union_rp)
    miou_cn, iou_cn, _ = _mean_iou(inter_cn, union_cn)
    miou_eg, _, _ = _mean_iou(inter_eg, union_eg)
    miou_ow, _, _ = _mean_iou(inter_ow, union_ow)
    out_extra = {}
    if (resolution, num_features) == (64, 3):
        # Only at the shapes the 0.889 model was measured at.
        out_extra["overlap_error_share_at_0889"] = round(
            (1.0 - miou_eg) / (1.0 - 0.889), 3
        )
    return {
        "resolution": resolution,
        "num_features": num_features,
        "samples": samples,
        "iou_random_pair": round(miou_rp, 4),
        "iou_canonical": round(miou_cn, 4),
        "iou_extent_guess": round(miou_eg, 4),
        "iou_overlap_worst": round(miou_ow, 4),
        **out_extra,
        "ambiguous_voxel_fraction": round(ambiguous / max(labeled, 1), 4),
        "per_class_iou_canonical": [
            round(float(v), 4) if p else None
            for v, p in zip(iou_cn, present)
        ],
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="featurenet_tpu_torch.data.seg_oracle")
    parser.add_argument("--resolution", type=int, default=64)
    parser.add_argument("--num-features", type=int, default=3)
    parser.add_argument("--samples", type=int, default=1024)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    out = measure_ceiling(
        args.resolution, args.num_features, args.samples, args.seed
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
