"""Pose and noise augmentation inside the train step (port of
``featurenet_tpu/ops/augment.py`` and of the occupancy noise of
``featurenet_tpu/train/steps.py``).

The batch is split into ``groups`` contiguous slices (``groups`` shrinks
until it divides the batch), as the reference splits it, and each slice
gets one pose; across steps every sample still sees uniformly random
poses. Each augmentation is split into a draw and an apply: the draw
functions take a ``torch.Generator`` and make their draws on its device,
and the apply functions take the draws explicitly, so a caller (or a test
holding the reference's draws) decides what is drawn, and a train step
that draws on the device reads nothing back to the host.

- The cube rotation group: the 24 rotations are axis permutations combined
  with axis flips. ``CUBE_GROUP`` is built in the reference's order, so
  code ``k`` is the same rotation in both packages. ``rotate_grids`` and
  ``rotate_groups`` apply host codes with ``permute`` and ``flip``;
  ``rotate_by_codes`` applies device codes (``draw_code_tensor``) as one
  gather through 24 precomputed flat index maps (``cube_index_maps``),
  bitwise the same, with no host decision. The train step rotates the
  unpacked 0/1 grid before its cast to float: a rotation moves values and
  never changes one, so the result is bitwise the same and the gather
  moves a quarter of the bytes. ``rotate_pair_by_codes`` turns a
  segmentation batch's per-voxel target with its voxels, each group of
  both by the same code (the reference's ``random_rotate_batch_paired``).
- The affine warp (``random_affine_batch_paired``):
  ``affine_warp`` samples each output voxel ``p`` of a group at ``Rᵀ (p −
  c − t) / s + c`` about the grid centre ``c``, trilinearly, each corner
  outside the grid counting 0 (``map_coordinates(order=1,
  mode="constant")``), through ``F.grid_sample`` (``align_corners=True``,
  ``padding_mode="zeros"``) in float64: its normalisation of the source
  coordinates to [-1, 1] and back then keeps each fp32 coordinate to
  ~1e-15, so the corner weights are the coordinate's own, as the
  reference's are (in fp32 the round trip moves a coordinate near 64 by a
  few ulps); ``affine_warp_plain`` is the same warp as an explicit
  8-corner gather in fp32, for comparison. ``affine_warp_pair`` warps a
  segment batch: the voxels as ``affine_warp`` does, and their per-voxel
  target ``[B, D, H, W]`` by the same draw at order 0 (``map_coordinates(order=0)``): each
  output voxel takes the label of the source voxel nearest its source
  point, 0 where that lies outside the grid, so labels never blend. The
  nearest index rounds halves away from zero (``round_half_away``), as
  the reference's ``lax.round`` does; ``torch.round`` and
  ``grid_sample(mode="nearest")`` round them to even, so the labels go
  through one flat ``gather`` at indices computed here, and
  ``warp_labels_plain`` is the same sample as a per-group gather at three
  index tensors, for comparison. A group whose
  take flag is false comes out bitwise as it went in, voxels and labels
  alike. The step warps every group and
  then selects (branchless on the device), where the reference warps only
  the taken ones. ``draw_affine`` draws per group a quaternion (uniform
  SO(3), ``quat_to_matrix``), a scale, a translation and the take flag;
  ``affine_prob`` ramps the probability from a step count on the device.
- Occupancy noise: ``draw_flips`` draws a Bernoulli mask the shape of the
  voxels, and ``occupancy_noise`` flips them (``|v − flip|``).
"""

from __future__ import annotations

import functools
import itertools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

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


def draw_code_tensor(generator: torch.Generator, batch: int,
                     groups: int = 8) -> torch.Tensor:
    """One code in ``[0, 24)`` per slice of a batch of ``batch``, drawn on
    the generator's device (the values ``draw_codes`` gives on a CPU
    generator)."""
    n = group_count(batch, groups)
    return torch.randint(0, len(CUBE_GROUP), (n,), generator=generator,
                         device=generator.device)


@functools.lru_cache(maxsize=None)
def cube_index_maps(resolution: int, device: torch.device) -> torch.Tensor:
    """``int64 [24, R³]``: row ``k`` holds, for each voxel of a grid
    rotated by code ``k`` (flattened), the flat index of its source voxel.
    Made once per size and device, outside inference mode, so a step
    copies nothing from the host."""
    flat = torch.arange(resolution ** 3).reshape(1, resolution, resolution,
                                                 resolution)
    maps = torch.stack([rotate_grids(flat, k).reshape(-1)
                        for k in range(len(CUBE_GROUP))])
    with torch.inference_mode(False):
        return maps.to(device)


def rotate_by_codes(voxels: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``rotate_groups`` with the codes in a tensor (on the voxels'
    device): slice ``i`` of ``len(codes)`` contiguous slices of ``[B, R, R,
    R, C]`` voxels is gathered through ``cube_index_maps`` row
    ``codes[i]``."""
    b, r = voxels.shape[0], voxels.shape[1]
    groups = codes.shape[0]
    if groups < 1 or b % groups:
        raise ValueError(f"{groups} rotation codes do not split a batch of {b}")
    if tuple(voxels.shape[1:4]) != (r, r, r):
        raise ValueError(f"cube rotations need a cubic grid, got {tuple(voxels.shape)}")
    flat = voxels.reshape(groups, b // groups, r ** 3, -1)
    index = cube_index_maps(r, voxels.device)[codes]
    index = index[:, None, :, None].expand(flat.shape)
    return flat.gather(2, index).reshape(voxels.shape)


def rotate_pair_by_codes(voxels: torch.Tensor, seg: torch.Tensor,
                         codes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``rotate_by_codes`` of ``[B, R, R, R, C]`` voxels and of their
    per-voxel target ``seg [B, R, R, R]``, slice ``i`` of both by
    ``codes[i]``."""
    return (rotate_by_codes(voxels, codes),
            rotate_by_codes(seg[..., None], codes)[..., 0])


class AffineDraw(NamedTuple):
    """One step's affine draw for ``G`` groups: rotations ``[G, 3, 3]``,
    scales ``[G]``, translations in voxels ``[G, 3]`` (d, h, w) and take
    flags ``[G]`` (bool)."""
    rot: torch.Tensor
    scale: torch.Tensor
    trans: torch.Tensor
    take: torch.Tensor


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternions ``[..., 4]`` (w, x, y, z; normalized here) → rotation
    matrices ``[..., 3, 3]``; uniform over SO(3) for iid-normal ``q``."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def affine_prob(prob: float, ramp_steps: int, step: torch.Tensor):
    """The take probability at ``step`` (a device tensor): ``prob`` ramped
    linearly from 0 over the first ``ramp_steps`` steps, ``prob`` itself
    without a ramp."""
    if ramp_steps <= 0:
        return prob
    return prob * torch.clamp(step.float() / ramp_steps, 0.0, 1.0)


def draw_affine(generator: torch.Generator, batch: int, groups: int = 8,
                prob=1.0, scale_range=(0.7, 1.05), rotate: bool = True,
                translate_vox: float = 0.0) -> AffineDraw:
    """The affine draw of one step for a batch of ``batch`` (``group_count``
    groups), on the generator's device: a uniform rotation (the identity
    with ``rotate=False``), a scale uniform in ``scale_range``, a
    translation uniform in ``[-translate_vox, translate_vox]`` per axis
    (0 when that is 0), and a take flag true with probability ``prob`` (a
    float or a device tensor)."""
    n = group_count(batch, groups)
    dev = generator.device
    if rotate:
        rot = quat_to_matrix(torch.randn((n, 4), generator=generator, device=dev))
    else:
        rot = torch.eye(3, device=dev).expand(n, 3, 3)
    lo, hi = scale_range
    scale = torch.rand(n, generator=generator, device=dev) * (hi - lo) + lo
    if translate_vox > 0.0:
        u = torch.rand((n, 3), generator=generator, device=dev)
        trans = u * (2 * translate_vox) - translate_vox
    else:
        trans = torch.zeros((n, 3), device=dev)
    take = torch.rand(n, generator=generator, device=dev) < prob
    return AffineDraw(rot, scale, trans, take)


def _source_coords(shape, rot: torch.Tensor, scale: torch.Tensor,
                   trans: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Per group the source coordinates (d, h, w), each ``[G, D, H, W]``,
    of every output voxel of a ``(D, H, W)`` grid: ``Rᵀ (p − (c + t)) / s +
    c`` in the reference's order of operations."""
    g = scale.shape[0]
    centre = [(n - 1) / 2.0 for n in shape]
    s = scale.view(g, 1, 1, 1)
    shifted = []
    for axis, n in enumerate(shape):
        view = [1, 1, 1, 1]
        view[axis + 1] = n
        p = torch.arange(n, dtype=torch.float32, device=scale.device).view(view)
        t = trans[:, axis].view(g, 1, 1, 1)
        shifted.append((p - (centre[axis] + t)) / s)
    rt = rot.transpose(1, 2).reshape(g, 3, 3, 1, 1, 1)
    return tuple(rt[:, i, 0] * shifted[0] + rt[:, i, 1] * shifted[1]
                 + rt[:, i, 2] * shifted[2] + centre[i] for i in range(3))


def _by_group(voxels: torch.Tensor, groups: int) -> torch.Tensor:
    """``[B, D, H, W, C]`` → ``[G, (B/G)·C, D, H, W]``: each group's samples
    and channels as the channels of one grid."""
    b, d, h, w, c = voxels.shape
    if groups < 1 or b % groups:
        raise ValueError(f"{groups} affine draws do not split a batch of {b}")
    x = voxels.reshape(groups, b // groups, d, h, w, c)
    return x.permute(0, 1, 5, 2, 3, 4).reshape(groups, -1, d, h, w)


def _from_groups(x: torch.Tensor, shape) -> torch.Tensor:
    b, d, h, w, c = shape
    g = x.shape[0]
    return x.reshape(g, b // g, c, d, h, w).permute(0, 1, 3, 4, 5, 2).reshape(shape)


def _select_taken(voxels: torch.Tensor, warped: torch.Tensor,
                  take: torch.Tensor) -> torch.Tensor:
    g = take.shape[0]
    keep = take.view(g, *([1] * voxels.dim()))
    shape = (g, voxels.shape[0] // g, *voxels.shape[1:])
    return torch.where(keep, warped.reshape(shape),
                       voxels.reshape(shape)).reshape(voxels.shape)


def _warp_voxels(voxels: torch.Tensor, src: tuple[torch.Tensor, ...],
                 take: torch.Tensor) -> torch.Tensor:
    shape = tuple(voxels.shape[1:4])
    # grid_sample's last axis is (x, y, z) = (W, H, D), each normalised so
    # that -1 and 1 are the first and last voxel centres. In float64, so
    # that the normalisation and grid_sample's own unnormalisation return
    # each fp32 source coordinate to ~1e-15 of itself and the corner
    # weights are the coordinate's own; in fp32 that round trip moves a
    # coordinate near 64 by a few ulps, up to ~1.4e-5 of a value.
    grid = torch.stack([2.0 * src[i].double() / max(shape[i] - 1, 1) - 1.0
                        for i in (2, 1, 0)], dim=-1)
    warped = F.grid_sample(_by_group(voxels, take.shape[0]).double(), grid,
                           mode="bilinear", padding_mode="zeros",
                           align_corners=True)
    return _select_taken(voxels, _from_groups(warped.to(voxels.dtype),
                                              voxels.shape), take)


def affine_warp(voxels: torch.Tensor, rot: torch.Tensor, scale: torch.Tensor,
                trans: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """Warp float ``[B, D, H, W, C]`` voxels group by group by one
    ``AffineDraw``'s fields (trilinear, 0 outside the grid) through
    ``F.grid_sample`` in float64; groups whose take flag is false pass
    through bitwise."""
    src = _source_coords(tuple(voxels.shape[1:4]), rot, scale, trans)
    return _warp_voxels(voxels, src, take)


def affine_warp_plain(voxels: torch.Tensor, rot: torch.Tensor,
                      scale: torch.Tensor, trans: torch.Tensor,
                      take: torch.Tensor) -> torch.Tensor:
    """``affine_warp`` as an explicit gather: for each of the 8 corners of
    each source point, its weight (the product of the per-axis linear
    weights) times the voxel there, or 0 where the corner is outside the
    grid, summed."""
    shape = tuple(voxels.shape[1:4])
    src = _source_coords(shape, rot, scale, trans)
    grids = _by_group(voxels, take.shape[0])
    g, ch = grids.shape[:2]
    flat = grids.reshape(g, ch, -1)
    lower = [torch.floor(s) for s in src]
    frac = [s - lo for s, lo in zip(src, lower)]
    out = torch.zeros_like(grids)
    for corner in itertools.product((0, 1), repeat=3):
        index = torch.zeros_like(lower[0], dtype=torch.long)
        weight = torch.ones_like(frac[0])
        valid = torch.ones_like(frac[0], dtype=torch.bool)
        for axis, up in enumerate(corner):
            i = lower[axis].long() + up
            valid &= (i >= 0) & (i < shape[axis])
            index = index * shape[axis] + i.clamp(0, shape[axis] - 1)
            weight = weight * (frac[axis] if up else 1.0 - frac[axis])
        vals = flat.gather(2, index.reshape(g, 1, -1).expand(g, ch, -1))
        vals = torch.where(valid.reshape(g, 1, -1), vals, torch.zeros_like(vals))
        out += (weight.reshape(g, 1, -1) * vals).reshape(grids.shape)
    return _select_taken(voxels, _from_groups(out, voxels.shape), take)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """The nearest integer of float ``x``, halves away from zero (the
    reference's ``lax.round``): exact, since ``x − trunc(x)`` is exact in
    floating point, so a half is found only where ``x`` is one."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), torch.round(x))


def _nearest(src: tuple[torch.Tensor, ...], shape) -> tuple[list, torch.Tensor]:
    """Per axis the nearest source index of each output voxel, clamped
    into the grid, and where all three lie inside it before the clamp."""
    index, valid = [], None
    for axis, n in enumerate(shape):
        i = round_half_away(src[axis])
        ok = (i >= 0) & (i < n)
        valid = ok if valid is None else valid & ok
        index.append(i.clamp(0, n - 1).long())
    return index, valid


def _warp_labels(seg: torch.Tensor, src: tuple[torch.Tensor, ...],
                 take: torch.Tensor) -> torch.Tensor:
    """An integer target ``[B, D, H, W]`` sampled at order 0 at ``src`` as
    one flat gather in its own dtype; untaken groups as they were."""
    shape = tuple(seg.shape[1:4])
    g = take.shape[0]
    (i, j, k), valid = _nearest(src, shape)
    flat_index = ((i * shape[1] + j) * shape[2] + k).reshape(g, 1, -1)
    flat = seg.reshape(g, seg.shape[0] // g, -1)
    got = flat.gather(2, flat_index.expand(flat.shape))
    got = torch.where(valid.reshape(g, 1, -1), got, torch.zeros_like(got))
    return _select_taken(seg, got.reshape(seg.shape), take)


def warp_labels_plain(seg: torch.Tensor, rot: torch.Tensor,
                      scale: torch.Tensor, trans: torch.Tensor,
                      take: torch.Tensor) -> torch.Tensor:
    """The label half of ``affine_warp_pair`` as the reference writes it:
    each sample cast to fp32, indexed group by group at the three
    nearest-index tensors, 0 where the source point is outside the grid,
    cast back."""
    shape = tuple(seg.shape[1:4])
    src = _source_coords(shape, rot, scale, trans)
    (i, j, k), valid = _nearest(src, shape)
    g = take.shape[0]
    per = seg.shape[0] // g
    out = []
    for b in range(seg.shape[0]):
        grp = b // per
        v = seg[b].float()[i[grp], j[grp], k[grp]]
        out.append(torch.where(valid[grp], v, torch.zeros_like(v)).to(seg.dtype))
    return _select_taken(seg, torch.stack(out), take)


def affine_warp_pair(voxels: torch.Tensor, seg: torch.Tensor,
                     rot: torch.Tensor, scale: torch.Tensor,
                     trans: torch.Tensor, take: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``affine_warp`` of float ``[B, D, H, W, C]`` voxels and the order-0
    warp of their integer target ``[B, D, H, W]`` (the nearest source
    voxel's label, 0 outside the grid) by the same draw, from one set of
    source coordinates (the reference's ``random_affine_batch_paired``
    with ``seg``); groups whose take flag is false pass through bitwise."""
    src = _source_coords(tuple(voxels.shape[1:4]), rot, scale, trans)
    return _warp_voxels(voxels, src, take), _warp_labels(seg, src, take)


def affine_warp_pair_plain(voxels: torch.Tensor, seg: torch.Tensor,
                           rot: torch.Tensor, scale: torch.Tensor,
                           trans: torch.Tensor, take: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``affine_warp_pair`` through the plain gathers
    (``affine_warp_plain``, ``warp_labels_plain``), for comparison."""
    return (affine_warp_plain(voxels, rot, scale, trans, take),
            warp_labels_plain(seg, rot, scale, trans, take))


def draw_flips(generator: torch.Generator, shape, rate: float) -> torch.Tensor:
    """A Bernoulli(``rate``) bool mask of ``shape`` on the generator's
    device: the voxels ``occupancy_noise`` flips."""
    return torch.rand(shape, generator=generator, device=generator.device) < rate


def occupancy_noise(voxels: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Flip the occupancy of float 0/1-ish ``voxels`` where ``flips``:
    ``|v − flip|``, in the voxels' dtype."""
    return torch.abs(voxels - flips.to(voxels.dtype))
