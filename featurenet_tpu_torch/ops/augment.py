"""Pose augmentation inside the train step: the cube rotation group (port
of the cube-group half of ``featurenet_tpu/ops/augment.py``).

The 24 rotations of the cube are axis permutations combined with axis
flips, pure layout ops, so they run on the device as plain PyTorch
``permute`` and ``flip``, as they run as XLA ops in the reference.
``CUBE_GROUP`` is built in the reference's order, so code ``k`` is the
same rotation in both packages.

The batch is split into ``groups`` contiguous slices and each slice is
rotated by one code (``groups`` shrinks until it divides the batch), as
the reference's ``random_rotate_batch`` does; across steps every sample
still sees uniformly random poses. The codes are drawn on the host from
the caller's generator, so choosing a rotation never waits for the
device. ``rotate_groups`` takes the codes explicitly.

The train step rotates the unpacked 0/1 grid before its cast to float: a
rotation moves values and never changes one, so the result is bitwise
the same and the copy moves a quarter of the bytes.

Not ported yet: the affine warp (``random_affine_batch*``) and the
occupancy noise.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import torch

# The 24 proper rotations of the cube: axis permutations of (D, H, W)
# combined with axis flips whose overall determinant is +1.
CUBE_GROUP: list[tuple[tuple[int, int, int], tuple[bool, bool, bool]]] = []
for _perm in itertools.permutations((0, 1, 2)):
    _inv = sum(1 for i in range(3) for j in range(i + 1, 3) if _perm[i] > _perm[j])
    _perm_sign = -1 if _inv % 2 else 1
    for _flips in itertools.product((False, True), repeat=3):
        _flip_sign = -1 if sum(_flips) % 2 else 1
        if _perm_sign * _flip_sign == 1:
            CUBE_GROUP.append((_perm, _flips))
assert len(CUBE_GROUP) == 24


def apply_rotation(x: torch.Tensor, perm, flips) -> torch.Tensor:
    """Apply one cube rotation to the spatial dims 1-3 of ``[B, D, H, W,
    ...]`` ``x``."""
    order = (0, *(1 + p for p in perm), *range(4, x.dim()))
    x = x.permute(order)
    dims = [1 + i for i, f in enumerate(flips) if f]
    return torch.flip(x, dims) if dims else x


def rotate_grids(x: torch.Tensor, code: int) -> torch.Tensor:
    """Rotate ``[B, R, R, R, ...]`` ``x`` by group element ``code`` in
    ``[0, 24)``."""
    perm, flips = CUBE_GROUP[int(code)]
    return apply_rotation(x, perm, flips)


def group_count(batch: int, groups: int) -> int:
    """The largest count of equal contiguous slices of ``batch`` that is at
    most ``groups``."""
    while batch % groups:
        groups -= 1
    return groups


def rotate_groups(voxels: torch.Tensor, codes: Sequence[int]) -> torch.Tensor:
    """Rotate ``[B, R, R, R, C]`` voxels, slice ``i`` of ``len(codes)``
    contiguous slices by ``codes[i]``."""
    groups = len(codes)
    b = voxels.shape[0]
    if groups < 1 or b % groups:
        raise ValueError(f"{groups} rotation codes do not split a batch of {b}")
    step = b // groups
    return torch.cat([rotate_grids(voxels[i * step:(i + 1) * step], c)
                      for i, c in enumerate(codes)])


def draw_codes(generator: torch.Generator, batch: int, groups: int = 8) -> list[int]:
    """One code in ``[0, 24)`` per slice of a batch of ``batch``, from a
    CPU ``generator``."""
    n = group_count(batch, groups)
    return torch.randint(0, len(CUBE_GROUP), (n,), generator=generator).tolist()


def random_rotate_batch(voxels: torch.Tensor, generator: torch.Generator,
                        groups: int = 8) -> torch.Tensor:
    """Rotate ``[B, R, R, R, C]`` voxels, one random pose per batch group."""
    return rotate_groups(voxels, draw_codes(generator, voxels.shape[0], groups))
