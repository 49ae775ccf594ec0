#!/usr/bin/env python3
"""Time ways of computing the affine warp's voxels against each other on
one NVIDIA GPU, at robust64's and seg64's batches.

    python3 ab_affine_warp.py

Candidates, each given the same voxels and ``AffineDraw``:

- ``port``: ``ops/augment.py`` ``affine_warp`` (``F.grid_sample`` in
  float64);
- ``grid_sample_fp32``: the same call in fp32, whose normalisation of the
  source coordinates to [-1, 1] and back moves a coordinate near 64 by a
  few ulps;
- ``gather_loop``: one flat gather a corner at the fp32 coordinates, the
  out-of-grid masks folded into the per-axis weights, the terms summed in
  ``affine_warp_plain``'s order;
- ``embedding_bag``: ``F.embedding_bag`` over the 8 corners with their
  weights as per-sample weights, each group's grid as a table of
  (voxel, sample) rows.

Shapes: batch 256 of blocky grids (robust64), batch 32 of blocky grids
(seg64's parts under robust64's settings, no translation) and batch 32 of
dense random grids with a translation of up to a voxel; 64³, 8 groups,
every group taken. Each candidate's max error against
``affine_warp_plain``, whether it is bitwise that, its device ms (CUDA
events, mean of 20 calls after 3) and the rise of allocated memory over
one call are printed as one JSON line per shape, after the nvidia-smi
line. Exits 1 without a CUDA device.
"""

import itertools
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from featurenet_tpu_torch.ops import augment
from featurenet_tpu_torch.ops.augment import (_by_group, _from_groups,
                                              _select_taken, _source_coords)


def grid_sample_fp32(voxels, rot, scale, trans, take):
    shape = tuple(voxels.shape[1:4])
    src = _source_coords(shape, rot, scale, trans)
    grid = torch.stack([2.0 * src[i] / max(shape[i] - 1, 1) - 1.0
                        for i in (2, 1, 0)], dim=-1)
    warped = F.grid_sample(_by_group(voxels, take.shape[0]), grid,
                           mode="bilinear", padding_mode="zeros",
                           align_corners=True)
    return _select_taken(voxels, _from_groups(warped, voxels.shape), take)


def _corner_terms(src, shape):
    """Per axis, for the lower and upper corner: its flat-index term
    (clamped into the grid) and its weight (0 outside the grid)."""
    strides = (shape[1] * shape[2], shape[2], 1)
    terms, weights = [], []
    for axis, n in enumerate(shape):
        lower = torch.floor(src[axis])
        frac = src[axis] - lower
        i = lower.long()
        terms.append([i.clamp(0, n - 1) * strides[axis],
                      (i + 1).clamp(0, n - 1) * strides[axis]])
        weights.append([torch.where((i >= 0) & (i < n), 1.0 - frac, 0.0),
                        torch.where((i >= -1) & (i < n - 1), frac, 0.0)])
    return terms, weights


def gather_loop(voxels, rot, scale, trans, take):
    shape = tuple(voxels.shape[1:4])
    src = _source_coords(shape, rot, scale, trans)
    grids = _by_group(voxels, take.shape[0])
    g, ch = grids.shape[:2]
    flat = grids.reshape(g, ch, -1)
    terms, weights = _corner_terms(src, shape)
    out = None
    for a, b, c in itertools.product((0, 1), repeat=3):
        index = (terms[0][a] + terms[1][b] + terms[2][c]).reshape(g, 1, -1)
        weight = (weights[0][a] * weights[1][b] * weights[2][c]).reshape(g, 1, -1)
        vals = flat.gather(2, index.expand(g, ch, -1)).mul_(weight)
        out = vals if out is None else out.add_(vals)
    return _select_taken(voxels, _from_groups(out.reshape(grids.shape),
                                              voxels.shape), take)


def embedding_bag(voxels, rot, scale, trans, take):
    b, d, h, w, c = voxels.shape
    g = take.shape[0]
    per, n = b // g, d * h * w
    src = _source_coords((d, h, w), rot, scale, trans)
    table = voxels.reshape(g, per, n, c).permute(0, 2, 1, 3).reshape(g * n, per * c)
    terms, weights = _corner_terms(src, (d, h, w))
    base = (torch.arange(g, device=voxels.device) * n).view(g, 1, 1, 1)
    corners = list(itertools.product((0, 1), repeat=3))
    idx = torch.stack([terms[0][i] + terms[1][j] + terms[2][k] + base
                       for i, j, k in corners], dim=-1)
    wts = torch.stack([weights[0][i] * weights[1][j] * weights[2][k]
                       for i, j, k in corners], dim=-1)
    out = F.embedding_bag(idx.reshape(-1, 8), table, mode="sum",
                          per_sample_weights=wts.reshape(-1, 8))
    out = out.reshape(g, n, per, c).permute(0, 2, 1, 3).reshape(voxels.shape)
    return _select_taken(voxels, out, take)


CANDIDATES = {"port": augment.affine_warp, "grid_sample_fp32": grid_sample_fp32,
              "gather_loop": gather_loop, "embedding_bag": embedding_bag}
SHAPES = (("b256_blocky", 256, False, 0.0), ("b32_blocky", 32, False, 0.0),
          ("b32_dense_translate1", 32, True, 1.0))


def time_ms(fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_affine_warp: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name, b, dense, translate in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        if dense:
            x = (torch.rand((b, 64, 64, 64, 1), generator=g, device="cuda") < 0.4).float()
        else:
            x = torch.zeros((b, 64, 64, 64, 1), device="cuda")
            x[:, 8:56, 10:50, 12:60] = 1.0
        draw = augment.draw_affine(g, b, 8, 1.0, translate_vox=translate)
        plain = augment.affine_warp_plain(x, *draw)
        row = {"shape": name, "plain_ms": time_ms(
            lambda: augment.affine_warp_plain(x, *draw), reps=3, warmup=1)}
        for cand, fn in CANDIDATES.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            y = fn(x, *draw)
            torch.cuda.synchronize()
            row[cand] = {"max_abs_err_vs_plain": float((y - plain).abs().max()),
                         "bitwise_plain": bool(torch.equal(y, plain)),
                         "ms": time_ms(lambda: fn(x, *draw)),
                         "peak_rise_mb": (torch.cuda.max_memory_allocated() - base) / 1e6}
            del y
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
