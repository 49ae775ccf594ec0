"""Attribute a segmentation checkpoint's residual IoU gap, voxel by voxel
(port of ``featurenet_tpu/train/seg_diagnose.py``).

One exact pass over the held-out split of a segmentation cache
(``SegCacheDataset``, ``split="test"``) with the checkpoint's segmenter on
the device (the card unless the caller asks for the CPU): bit-packed
voxels in, unpacked there, the int8 argmax labels out. The voxel confusion
matrix over the labels (stock + the feature classes; the count is the
head's output width) is built on the host with ``np.bincount``. Reported:

- ``mean_iou`` as trained and ``per_class_iou`` (the eval metric of
  ``train.steps.aggregate_eval``);
- the families: connected components of the symmetrized row-normalized
  confusion graph over the feature classes, joined above ``threshold``;
- ``mean_iou_family_collapsed``: each family merged into one label in
  prediction and truth alike, and ``family_identity_cost``, the gap
  between the two, which is what class identity inside families costs;
- ``top_confused_pairs``, and ``voxels``, the count the matrix sums to
  (every voxel of the split's valid rows; the reference does not print
  it).

On the card ``main`` ends with a ``{"device": ..., "launches": {...}}``
line: the kernel launches of its process.

Run:  python -m featurenet_tpu_torch.train.seg_diagnose
          --checkpoint-dir CK --data-cache CACHE [--threshold 0.1]
          [--batch 32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _families(conf: np.ndarray, threshold: float) -> list[list[int]]:
    """Connected components of the symmetrized row-normalized confusion
    graph over the feature classes (label 0, stock, excluded): classes i
    and j are linked when either direction's rate exceeds ``threshold``."""
    n = conf.shape[0]
    row = conf.sum(axis=1, keepdims=True)
    rate = conf / np.maximum(row, 1)
    adj = np.zeros((n, n), bool)
    for i in range(1, n):
        for j in range(1, n):
            if i != j and (rate[i, j] > threshold or rate[j, i] > threshold):
                adj[i, j] = adj[j, i] = True
    seen, out = set(), []
    for i in range(1, n):
        if i in seen:
            continue
        comp, stack = [], [i]
        seen.add(i)
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in np.nonzero(adj[u])[0]:
                if v not in seen:
                    seen.add(int(v))
                    stack.append(int(v))
        if len(comp) > 1:
            out.append(sorted(comp))
    return out


def _mean_iou_from_confusion(conf: np.ndarray) -> tuple[float, np.ndarray]:
    """Exact per-class IoU of a voxel confusion matrix (intersection the
    diagonal, union row + column − diagonal) and its mean over the
    classes present."""
    inter = np.diag(conf).astype(np.float64)
    union = conf.sum(1) + conf.sum(0) - inter
    present = union > 0
    iou = np.where(present, inter / np.maximum(union, 1), 0.0)
    return float(iou.sum() / max(int(present.sum()), 1)), iou


def _collapse(conf: np.ndarray, families: list[list[int]]) -> np.ndarray:
    """Each family's rows and columns merged into one label: every label
    maps to its family's first member, then the matrix is summed in one
    pass (no positional deletion, which shifts the later families)."""
    n = conf.shape[0]
    mapping = np.arange(n)
    for fam in families:
        mapping[fam] = fam[0]
    _, inv = np.unique(mapping, return_inverse=True)
    m = int(inv.max()) + 1
    flat = inv[:, None] * m + inv[None, :]
    return (
        np.bincount(flat.ravel(), weights=conf.ravel(), minlength=m * m)
        .reshape(m, m)
        .astype(conf.dtype)
    )


def diagnose(
    checkpoint_dir: str,
    data_cache: str,
    threshold: float = 0.1,
    batch: int = 32,
    device="cuda",
) -> dict:
    """The report of the module docstring for ``checkpoint_dir``'s newest
    verified step over ``data_cache``'s held-out split, in batches of
    ``batch``, on ``device``."""
    import torch

    from featurenet_tpu_torch.data.offline import SegCacheDataset
    from featurenet_tpu_torch.data.synthetic import CLASS_NAMES
    from featurenet_tpu_torch.runtime import build_model, resolve_device
    from featurenet_tpu_torch.train.checkpoint import (
        CheckpointManager,
        load_run_config,
    )
    from featurenet_tpu_torch.train.state import TrainState
    from featurenet_tpu_torch.train.steps import unpack_voxels

    cfg = load_run_config(checkpoint_dir)
    if cfg is None or cfg.task != "segment":
        raise SystemExit(
            "seg_diagnose needs a segment checkpoint with a persisted "
            f"config (got {getattr(cfg, 'task', None)!r})"
        )
    dev = resolve_device(device)
    model = build_model(cfg)
    mgr = CheckpointManager(checkpoint_dir)
    mgr.restore_init(TrainState(model, optimizer=None))
    mgr.close()
    model = model.to(dev).eval()
    R = cfg.resolution

    @torch.inference_mode()
    def predict(packed: np.ndarray) -> np.ndarray:
        x = unpack_voxels(torch.from_numpy(packed).to(dev))
        return model(x, train=False).argmax(dim=-1).to(torch.int8).cpu().numpy()

    ds = SegCacheDataset(data_cache, global_batch=batch, split="test",
                         test_fraction=cfg.test_fraction)
    # The class count from the head's own output, as the checkpoint
    # predicts it.
    with torch.inference_mode():
        n_cls = model(torch.zeros((1, R, R, R, 1), device=dev),
                      train=False).shape[-1]
    conf = np.zeros((n_cls, n_cls), np.int64)
    for b in ds.epoch_batches(batch):
        pred = predict(b["voxels"])
        valid = b["mask"] > 0
        t = b["seg"][valid].ravel().astype(np.int64)
        p = pred[valid].ravel().astype(np.int64)
        conf += np.bincount(
            t * n_cls + p, minlength=n_cls * n_cls
        ).reshape(n_cls, n_cls)

    raw_miou, raw_iou = _mean_iou_from_confusion(conf)
    fams = _families(conf, threshold)
    collapsed_miou, _ = _mean_iou_from_confusion(_collapse(conf, fams))

    def name(i):  # label 0 is stock or air
        return "stock" if i == 0 else CLASS_NAMES[i - 1]

    row = conf.sum(1)
    top_pairs = sorted(
        (
            (float(conf[i, j] / max(row[i], 1)), name(i), name(j))
            for i in range(1, n_cls)
            for j in range(n_cls)
            if i != j and conf[i, j] > 0
        ),
        reverse=True,
    )[:8]
    return {
        "checkpoint": checkpoint_dir,
        "voxels": int(conf.sum()),
        "mean_iou": round(raw_miou, 4),
        "mean_iou_family_collapsed": round(collapsed_miou, 4),
        "family_identity_cost": round(collapsed_miou - raw_miou, 4),
        "families": [[name(c) for c in fam] for fam in fams],
        "confusion_threshold": threshold,
        "top_confused_pairs": [
            {"rate": round(r, 3), "true": t, "pred": p}
            for r, t, p in top_pairs
        ],
        "per_class_iou": {
            name(i): round(float(v), 4) for i, v in enumerate(raw_iou)
        },
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="featurenet_tpu_torch.train.seg_diagnose")
    ap.add_argument("--checkpoint-dir", required=True)
    ap.add_argument("--data-cache", required=True)
    ap.add_argument("--threshold", type=float, default=0.1,
                    help="row-normalized confusion rate above which two "
                         "classes are joined into a family")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from featurenet_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    print(json.dumps(diagnose(
        args.checkpoint_dir, args.data_cache, args.threshold, args.batch, dev,
    )), flush=True)
    if dev.type == "cuda":
        from featurenet_tpu_torch.ops import launch_counts

        # The device the pass ran on and the kernel launches of this
        # process, as ``cli train`` ends its run on the card.
        print(json.dumps({"device": str(dev), "launches": launch_counts()}),
              flush=True)


if __name__ == "__main__":
    main()
