"""Parametric generator for the 24 FeatureNet machining-feature classes
(port of ``featurenet_tpu/data/synthetic.py``; the port's own copy).

Each part is a stock cube with one parametric machining feature carved
out, generated directly in voxel space from a caller's
``np.random.Generator``: with the same seed it gives the same arrays, bit
for bit, as the JAX package's generator.

Every size and position draw goes through ``_u``, so a feature-parameter
quantile window restricts all of them at once (``param_range``: the
middle quantiles ``"mid"``, their complement ``"tails"``, an explicit
``(lo, hi)``, or ``None`` for the full range). The window is thread-local,
since dataset workers are threads; ``generate_sample`` and
``generate_batch`` take ``param_range=_INHERIT`` by default, which keeps
the caller's ambient window, while an explicit ``None`` forces the full
range. The OOD harness draws its ``tails`` row this way (``ood.py``).

Multi-feature parts (``num_features > 1``) are the segmentation samples:
``generate_sample_with_removals`` also returns each feature's removal
volume, and ``carve(..., order=)`` relabels the voxels several features
cover (``data/offline.py``'s ``label_order``).

Also here: ``pack_voxels``/``to_wire``, the bit-packed wire formats
(``WIRE_KEYS``: classify labels, or the per-voxel int8 ``seg``) that
``train/steps.unpack_voxels`` reads on the device.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np

CLASS_NAMES: tuple[str, ...] = (
    "o_ring",
    "through_hole",
    "blind_hole",
    "triangular_passage",
    "rectangular_passage",
    "circular_through_slot",
    "triangular_through_slot",
    "rectangular_through_slot",
    "rectangular_blind_slot",
    "triangular_pocket",
    "rectangular_pocket",
    "circular_end_pocket",
    "triangular_blind_step",
    "circular_blind_step",
    "rectangular_blind_step",
    "rectangular_through_step",
    "two_sided_through_step",
    "slanted_through_step",
    "chamfer",
    "round",
    "vertical_circular_end_blind_slot",
    "horizontal_circular_end_blind_slot",
    "six_sided_passage",
    "six_sided_pocket",
)
NUM_CLASSES = len(CLASS_NAMES)  # 24

# Stock cube occupies [MARGIN, 1-MARGIN]^3 of the unit grid.
MARGIN = 0.08

_coord_cache: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}


def _coords(R: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Voxel-center coordinate grids in [0,1], cached per resolution."""
    if R not in _coord_cache:
        c = (np.arange(R, dtype=np.float32) + 0.5) / R
        _coord_cache[R] = tuple(np.meshgrid(c, c, c, indexing="ij"))
    return _coord_cache[R]


def stock_mask(R: int) -> np.ndarray:
    X, Y, Z = _coords(R)
    lo, hi = MARGIN, 1.0 - MARGIN
    return (
        (X > lo) & (X < hi) & (Y > lo) & (Y < hi) & (Z > lo) & (Z < hi)
    )


# ---------------------------------------------------------------------------
# Geometric primitives (all return bool [R,R,R] removal masks).
# Conventions: stock spans [LO, HI]^3; "top" is z = HI; features are carved
# in a canonical pose and the finished grid is re-oriented afterwards.
# ---------------------------------------------------------------------------

LO, HI = MARGIN, 1.0 - MARGIN
S = HI - LO  # stock edge length


# --- feature-parameter quantile window ------------------------------------

PARAM_MID: tuple[float, float] = (0.15, 0.85)
_param_window = threading.local()

# "No spec given: keep whatever ambient window is active". Distinct from
# None, which forces the full range.
_INHERIT = object()


def _resolve_param_range(spec):
    """A param_range spec as ``("window"|"tails", lo, hi)``, or ``None``
    for the full range: ``"mid"`` is the PARAM_MID window, ``"tails"`` its
    complement ([0, lo) and (hi, 1] of each parameter's range), ``(lo,
    hi)`` an explicit quantile window."""
    if spec is None:
        return None
    if isinstance(spec, str):
        if spec == "mid":
            return ("window",) + PARAM_MID
        if spec == "tails":
            return ("tails",) + PARAM_MID
        raise ValueError(
            f"unknown param_range {spec!r}: expected 'mid', 'tails', a "
            "(lo, hi) pair, or None"
        )
    if not isinstance(spec, (tuple, list)) or len(spec) != 2:
        raise ValueError(
            f"param_range window must be a (lo, hi) pair, got {spec!r}"
        )
    lo, hi = float(spec[0]), float(spec[1])
    if not (0.0 <= lo < hi <= 1.0):
        raise ValueError(f"param_range window must satisfy 0<=lo<hi<=1, "
                         f"got ({lo}, {hi})")
    return ("window", lo, hi)


class _ParamRange:
    """Context manager scoping a feature-parameter quantile window.
    ``_INHERIT`` is a no-op: the ambient window stays in effect."""

    def __init__(self, spec):
        self._inherit = spec is _INHERIT
        self._spec = None if self._inherit else _resolve_param_range(spec)

    def __enter__(self):
        self._prev = getattr(_param_window, "spec", None)
        if not self._inherit:
            _param_window.spec = self._spec
        return self

    def __exit__(self, *exc):
        if not self._inherit:
            _param_window.spec = self._prev
        return False


# Public alias (the generation entry points take a ``param_range=`` kwarg
# that shadows the name locally, so they use the underscored class).
param_range = _ParamRange


def _u(rng: np.random.Generator, a: float, b: float) -> float:
    """A draw in ``[a, b)`` under the active window: one number from
    ``rng`` whatever the window."""
    spec = getattr(_param_window, "spec", None)
    if spec is None:
        return float(rng.uniform(a, b))
    kind, lo, hi = spec
    if kind == "window":
        q = lo + (hi - lo) * rng.uniform()
    else:  # tails: mass split between [0, lo) and (hi, 1] by width
        u = rng.uniform(0.0, lo + (1.0 - hi))
        q = u if u < lo else hi + (u - lo)
    return float(a + (b - a) * q)


def _cyl_z(R, cx, cy, r, z0, z1):
    X, Y, Z = _coords(R)
    return ((X - cx) ** 2 + (Y - cy) ** 2 < r * r) & (Z >= z0) & (Z <= z1)


def _cyl_x(R, cy, cz, r, x0, x1):
    X, Y, Z = _coords(R)
    return ((Y - cy) ** 2 + (Z - cz) ** 2 < r * r) & (X >= x0) & (X <= x1)


def _box(R, x0, x1, y0, y1, z0, z1):
    X, Y, Z = _coords(R)
    return (
        (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1) & (Z >= z0) & (Z <= z1)
    )


def _tri_prism_z(R, cx, cy, w, h, z0, z1):
    """Isoceles-triangle cross-section in (x,y) (apex +y), extruded in z."""
    X, Y, Z = _coords(R)
    # Triangle: base at y = cy, apex at (cx, cy + h); sides slope inward.
    in_tri = (
        (Y >= cy)
        & (Y <= cy + h * (1.0 - np.abs(X - cx) / (w / 2.0)))
    )
    return in_tri & (Z >= z0) & (Z <= z1)


def _hex_prism_z(R, cx, cy, r, z0, z1):
    """Regular-hexagon cross-section (circumradius r·2/√3 flats at r)."""
    X, Y, Z = _coords(R)
    u, v = X - cx, Y - cy
    c30 = np.float32(np.sqrt(3) / 2)
    inside = (
        (np.abs(u) < r)
        & (np.abs(0.5 * u + c30 * v) < r)
        & (np.abs(-0.5 * u + c30 * v) < r)
    )
    return inside & (Z >= z0) & (Z <= z1)


def _stadium_z(R, x0, x1, cy, hw, z0, z1, cap_lo=False, cap_hi=True):
    """Rectangle (x0..x1, cy±hw) with semicircular end caps in plan, in z-range."""
    X, Y, Z = _coords(R)
    rect = (X >= x0) & (X <= x1) & (np.abs(Y - cy) < hw)
    m = rect
    if cap_hi:
        m = m | (((X - x1) ** 2 + (Y - cy) ** 2 < hw * hw) & (X >= x1))
    if cap_lo:
        m = m | (((X - x0) ** 2 + (Y - cy) ** 2 < hw * hw) & (X <= x0))
    return m & (Z >= z0) & (Z <= z1)


# ---------------------------------------------------------------------------
# The 24 feature generators. Each returns a removal mask for a feature carved
# in canonical orientation (top face = +z, "front" side face = -x or -y).
# ---------------------------------------------------------------------------


def _f_o_ring(R, rng):
    r_out = _u(rng, 0.18, 0.32) * S
    r_in = r_out * _u(rng, 0.45, 0.7)
    depth = _u(rng, 0.2, 0.5) * S
    cx = _u(rng, LO + r_out + 0.05 * S, HI - r_out - 0.05 * S)
    cy = _u(rng, LO + r_out + 0.05 * S, HI - r_out - 0.05 * S)
    ring = _cyl_z(R, cx, cy, r_out, HI - depth, 1.0) & ~_cyl_z(
        R, cx, cy, r_in, 0.0, 1.0
    )
    return ring


def _f_through_hole(R, rng):
    r = _u(rng, 0.1, 0.25) * S
    cx = _u(rng, LO + r + 0.05 * S, HI - r - 0.05 * S)
    cy = _u(rng, LO + r + 0.05 * S, HI - r - 0.05 * S)
    return _cyl_z(R, cx, cy, r, 0.0, 1.0)


def _f_blind_hole(R, rng):
    r = _u(rng, 0.1, 0.25) * S
    depth = _u(rng, 0.3, 0.7) * S
    cx = _u(rng, LO + r + 0.05 * S, HI - r - 0.05 * S)
    cy = _u(rng, LO + r + 0.05 * S, HI - r - 0.05 * S)
    return _cyl_z(R, cx, cy, r, HI - depth, 1.0)


def _f_triangular_passage(R, rng):
    w = _u(rng, 0.3, 0.55) * S
    h = _u(rng, 0.3, 0.55) * S
    cx = _u(rng, LO + w / 2 + 0.05 * S, HI - w / 2 - 0.05 * S)
    cy = _u(rng, LO + 0.05 * S, HI - h - 0.05 * S)
    return _tri_prism_z(R, cx, cy, w, h, 0.0, 1.0)


def _f_rectangular_passage(R, rng):
    wx = _u(rng, 0.25, 0.5) * S
    wy = _u(rng, 0.25, 0.5) * S
    x0 = _u(rng, LO + 0.05 * S, HI - wx - 0.05 * S)
    y0 = _u(rng, LO + 0.05 * S, HI - wy - 0.05 * S)
    return _box(R, x0, x0 + wx, y0, y0 + wy, 0.0, 1.0)


def _f_circular_through_slot(R, rng):
    # Half-cylinder channel across the top face, running through in x.
    r = _u(rng, 0.12, 0.28) * S
    cy = _u(rng, LO + r + 0.05 * S, HI - r - 0.05 * S)
    return _cyl_x(R, cy, HI, r, 0.0, 1.0)


def _f_triangular_through_slot(R, rng):
    # V-groove across the top, through in x: apex points down (-z).
    w = _u(rng, 0.25, 0.5) * S
    d = _u(rng, 0.25, 0.5) * S
    cy = _u(rng, LO + w / 2 + 0.05 * S, HI - w / 2 - 0.05 * S)
    X, Y, Z = _coords(R)
    # Width tapers linearly from w at the top plane to 0 at depth d.
    frac = np.clip((Z - (HI - d)) / d, 0.0, 1.0)
    return (np.abs(Y - cy) < (w / 2.0) * frac) & (Z >= HI - d)


def _f_rectangular_through_slot(R, rng):
    w = _u(rng, 0.2, 0.45) * S
    d = _u(rng, 0.25, 0.6) * S
    cy = _u(rng, LO + w / 2 + 0.05 * S, HI - w / 2 - 0.05 * S)
    return _box(R, 0.0, 1.0, cy - w / 2, cy + w / 2, HI - d, 1.0)


def _f_rectangular_blind_slot(R, rng):
    # Open at top and at the -x side face; blind end inside.
    w = _u(rng, 0.2, 0.4) * S
    d = _u(rng, 0.25, 0.55) * S
    reach = _u(rng, 0.35, 0.65) * S
    cy = _u(rng, LO + w / 2 + 0.05 * S, HI - w / 2 - 0.05 * S)
    return _box(R, 0.0, LO + reach, cy - w / 2, cy + w / 2, HI - d, 1.0)


def _f_triangular_pocket(R, rng):
    w = _u(rng, 0.3, 0.55) * S
    h = _u(rng, 0.3, 0.55) * S
    d = _u(rng, 0.25, 0.6) * S
    cx = _u(rng, LO + w / 2 + 0.05 * S, HI - w / 2 - 0.05 * S)
    cy = _u(rng, LO + 0.05 * S, HI - h - 0.05 * S)
    return _tri_prism_z(R, cx, cy, w, h, HI - d, 1.0)


def _f_rectangular_pocket(R, rng):
    wx = _u(rng, 0.25, 0.5) * S
    wy = _u(rng, 0.25, 0.5) * S
    d = _u(rng, 0.25, 0.6) * S
    x0 = _u(rng, LO + 0.05 * S, HI - wx - 0.05 * S)
    y0 = _u(rng, LO + 0.05 * S, HI - wy - 0.05 * S)
    return _box(R, x0, x0 + wx, y0, y0 + wy, HI - d, 1.0)


def _f_circular_end_pocket(R, rng):
    # Stadium-shaped pocket (rect with two semicircular ends) from the top.
    hw = _u(rng, 0.1, 0.2) * S
    length = _u(rng, 0.25, 0.45) * S
    d = _u(rng, 0.25, 0.6) * S
    x0 = _u(rng, LO + hw + 0.05 * S, HI - hw - length - 0.05 * S)
    cy = _u(rng, LO + hw + 0.05 * S, HI - hw - 0.05 * S)
    return _stadium_z(
        R, x0, x0 + length, cy, hw, HI - d, 1.0, cap_lo=True, cap_hi=True
    )


def _f_triangular_blind_step(R, rng):
    # Corner step with a slanted (triangular-in-plan) inner wall, from top.
    a = _u(rng, 0.4, 0.8) * S
    b = _u(rng, 0.4, 0.8) * S
    d = _u(rng, 0.25, 0.55) * S
    X, Y, Z = _coords(R)
    plan = (X - LO) / a + (Y - LO) / b < 1.0
    return plan & (Z >= HI - d)


def _f_circular_blind_step(R, rng):
    # Corner step bounded by a circular arc in plan, from top.
    r = _u(rng, 0.35, 0.65) * S
    d = _u(rng, 0.25, 0.55) * S
    X, Y, Z = _coords(R)
    plan = (X - LO) ** 2 + (Y - LO) ** 2 < r * r
    return plan & (Z >= HI - d)


def _f_rectangular_blind_step(R, rng):
    a = _u(rng, 0.35, 0.65) * S
    b = _u(rng, 0.35, 0.65) * S
    d = _u(rng, 0.25, 0.55) * S
    return _box(R, 0.0, LO + a, 0.0, LO + b, HI - d, 1.0)


def _f_rectangular_through_step(R, rng):
    a = _u(rng, 0.25, 0.55) * S
    d = _u(rng, 0.25, 0.55) * S
    return _box(R, 0.0, LO + a, 0.0, 1.0, HI - d, 1.0)


def _f_two_sided_through_step(R, rng):
    a = _u(rng, 0.18, 0.35) * S
    b = _u(rng, 0.18, 0.35) * S
    d = _u(rng, 0.25, 0.55) * S
    left = _box(R, 0.0, LO + a, 0.0, 1.0, HI - d, 1.0)
    right = _box(R, HI - b, 1.0, 0.0, 1.0, HI - d, 1.0)
    return left | right


def _f_slanted_through_step(R, rng):
    # Through step whose riser wall is a slanted plane.
    a = _u(rng, 0.25, 0.5) * S
    d = _u(rng, 0.25, 0.55) * S
    slope = _u(rng, 0.4, 1.2)
    X, Y, Z = _coords(R)
    # Wall plane: x = LO + a + slope*(HI - z); removal on the -x side, top-down.
    return (X < LO + a + slope * (HI - Z)) & (Z >= HI - d)


def _f_chamfer(R, rng):
    # 45-ish° planar cut along the top +x edge (edge parallel to y).
    c = _u(rng, 0.2, 0.45) * S
    k = _u(rng, 0.7, 1.4)  # wall slope ratio
    X, Y, Z = _coords(R)
    return (X - (HI - c)) + k * (Z - (HI - c)) > c


def _f_round(R, rng):
    # Rounded (filleted) top +x edge: remove material outside the quarter-
    # cylinder of radius r whose axis runs along y at (HI-r, HI-r).
    r = _u(rng, 0.2, 0.42) * S
    X, Y, Z = _coords(R)
    cx, cz = HI - r, HI - r
    outside = (X - cx) ** 2 + (Z - cz) ** 2 > r * r
    return outside & (X > cx) & (Z > cz)


def _f_v_circ_end_blind_slot(R, rng):
    # Slot from the -x side face, top-open, rounded blind end (stadium, one cap).
    hw = _u(rng, 0.1, 0.2) * S
    reach = _u(rng, 0.35, 0.6) * S
    d = _u(rng, 0.25, 0.55) * S
    cy = _u(rng, LO + hw + 0.05 * S, HI - hw - 0.05 * S)
    return _stadium_z(
        R, 0.0, LO + reach, cy, hw, HI - d, 1.0, cap_lo=False, cap_hi=True
    )


def _f_h_circ_end_blind_slot(R, rng):
    # Slot cut into the -y side face, running horizontally (in x), with a
    # rounded blind end; spans a z-interval strictly inside the part, which
    # distinguishes it from the vertical variant (top-open).
    hw = _u(rng, 0.09, 0.16) * S
    # reach is bounded so x0's sample range below stays non-empty.
    reach = _u(rng, 0.3 * S, 0.82 * S - 2.0 * hw - 0.16 * S)
    z0 = _u(rng, LO + 0.1 * S, HI - 0.1 * S - 2.2 * hw)
    x0 = _u(rng, LO + hw + 0.08 * S, HI - hw - 0.08 * S - reach)
    X, Y, Z = _coords(R)
    cz = z0 + 1.1 * hw
    rect = (X >= x0) & (X <= x0 + reach) & (np.abs(Z - cz) < hw)
    cap = ((X - (x0 + reach)) ** 2 + (Z - cz) ** 2 < hw * hw) & (X >= x0 + reach)
    return (rect | cap) & (Y <= LO + _u(rng, 0.3, 0.6) * S)


def _f_six_sided_passage(R, rng):
    # Flat radius large enough that the hexagon's corners stand ~2+ voxels
    # proud of the inscribed circle at 64³ — below that the feature is
    # unresolvable from a round hole (measured: 49% of six-sided passages
    # classified as through_hole at r≥0.15 before this floor was raised).
    r = _u(rng, 0.22, 0.33) * S
    cx = _u(rng, LO + r * 1.2 + 0.05 * S, HI - r * 1.2 - 0.05 * S)
    cy = _u(rng, LO + r * 1.2 + 0.05 * S, HI - r * 1.2 - 0.05 * S)
    return _hex_prism_z(R, cx, cy, r, 0.0, 1.0)


def _f_six_sided_pocket(R, rng):
    r = _u(rng, 0.22, 0.33) * S  # resolvable hex flats — see passage note
    d = _u(rng, 0.25, 0.6) * S
    cx = _u(rng, LO + r * 1.2 + 0.05 * S, HI - r * 1.2 - 0.05 * S)
    cy = _u(rng, LO + r * 1.2 + 0.05 * S, HI - r * 1.2 - 0.05 * S)
    return _hex_prism_z(R, cx, cy, r, HI - d, 1.0)


_FEATURE_FNS: tuple[Callable, ...] = (
    _f_o_ring,
    _f_through_hole,
    _f_blind_hole,
    _f_triangular_passage,
    _f_rectangular_passage,
    _f_circular_through_slot,
    _f_triangular_through_slot,
    _f_rectangular_through_slot,
    _f_rectangular_blind_slot,
    _f_triangular_pocket,
    _f_rectangular_pocket,
    _f_circular_end_pocket,
    _f_triangular_blind_step,
    _f_circular_blind_step,
    _f_rectangular_blind_step,
    _f_rectangular_through_step,
    _f_two_sided_through_step,
    _f_slanted_through_step,
    _f_chamfer,
    _f_round,
    _f_v_circ_end_blind_slot,
    _f_h_circ_end_blind_slot,
    _f_six_sided_passage,
    _f_six_sided_pocket,
)
assert len(_FEATURE_FNS) == NUM_CLASSES


def random_orientation(rng: np.random.Generator):
    """One of the 24 rotations of the cube group, as a grid transform."""
    perm = list(rng.permutation(3))
    flips = [bool(rng.integers(0, 2)) for _ in range(3)]
    # Restrict to proper rotations (determinant +1): parity(perm) must equal
    # parity of the number of flips.
    perm_parity = int(
        sum(1 for i in range(3) for j in range(i + 1, 3) if perm[i] > perm[j])
    ) % 2
    if (sum(flips) % 2) != perm_parity:
        flips[0] = not flips[0]

    def apply(grid: np.ndarray) -> np.ndarray:
        g = np.transpose(grid, perm)
        for ax, f in enumerate(flips):
            if f:
                g = np.flip(g, axis=ax)
        return np.ascontiguousarray(g)

    return apply


def carve(
    labels: np.ndarray,
    removals: list[np.ndarray],
    order: Sequence[int] | None = None,
    resolution: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Carve feature removal volumes from stock, in ``order`` (default: as
    given).

    Returns ``(part bool [R³], seg int32 [R³])``: ``stock &
    ~union(removals)``, which no order changes, and each carved voxel
    labelled ``1+class`` of the first removal in ``order`` that covers it.
    ``resolution`` is needed only when there are no removals (plain stock,
    all-zero seg).
    """
    if not len(removals):
        if resolution is None:
            raise ValueError("carve with no removals needs resolution")
        R = resolution
        return stock_mask(R).copy(), np.zeros((R, R, R), dtype=np.int32)
    R = removals[0].shape[0]
    part = stock_mask(R).copy()
    seg = np.zeros((R, R, R), dtype=np.int32)
    for k in order if order is not None else range(len(removals)):
        carved = removals[k] & part
        seg[carved] = int(labels[k]) + 1
        part &= ~removals[k]
    return part, seg


def generate_sample_with_removals(
    rng: np.random.Generator,
    resolution: int = 64,
    label: int | None = None,
    num_features: int = 1,
    orient: bool = True,
    param_range=_INHERIT,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[np.ndarray]]:
    """``generate_sample`` that also returns each feature's removal volume:
    ``(voxels, labels, seg, removals)``, the removals ``bool [R³]`` in the
    final (oriented) frame and in generation order, so ``carve(labels,
    removals)`` gives ``(voxels, seg)`` again. The draws are
    ``generate_sample``'s: the same seed gives the same part."""
    R = resolution
    labels = np.empty(num_features, dtype=np.int32)
    removals: list[np.ndarray] = []
    with _ParamRange(param_range):
        for k in range(num_features):
            cls = (int(rng.integers(0, NUM_CLASSES))
                   if label is None else int(label))
            labels[k] = cls
            removal = _FEATURE_FNS[cls](R, rng)
            if num_features > 1:
                # Re-orient each extra feature so multi-feature parts do
                # not stack every feature on the same faces.
                removal = random_orientation(rng)(removal)
            removals.append(removal)
    if orient:
        # The stock cube is symmetric under the cube group, so orienting the
        # removals and carving commutes with carving then orienting.
        o = random_orientation(rng)
        removals = [o(r) for r in removals]
    part, seg = carve(labels, removals, resolution=R)
    return part, labels, seg, removals


def generate_sample(
    rng: np.random.Generator,
    resolution: int = 64,
    label: int | None = None,
    num_features: int = 1,
    orient: bool = True,
    param_range=_INHERIT,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate one part.

    Returns ``(voxels bool [R³], labels int32 [num_features], seg int32 [R³])``
    where seg is 0 on non-feature voxels and ``1+class`` on each feature's
    removal volume (clipped to the stock). ``param_range``: the
    feature-parameter quantile window (``_ParamRange``).
    """
    part, labels, seg, _ = generate_sample_with_removals(
        rng, resolution, label=label, num_features=num_features,
        orient=orient, param_range=param_range)
    return part, labels, seg


def generate_batch(
    rng: np.random.Generator,
    batch_size: int,
    resolution: int = 64,
    balanced: bool = True,
    num_features: int = 1,
    orient: bool = True,
    param_range=_INHERIT,
) -> dict[str, np.ndarray]:
    """Generate a batch dict: voxels [B,R,R,R,1] f32, label [B] i32,
    seg [B,R,R,R] i32, mask [B] f32 (all ones)."""
    R = resolution
    voxels = np.empty((batch_size, R, R, R, 1), dtype=np.float32)
    seg = np.empty((batch_size, R, R, R), dtype=np.int32)
    labels = np.empty((batch_size,), dtype=np.int32)
    for i in range(batch_size):
        forced = (i % NUM_CLASSES) if balanced and num_features == 1 else None
        part, labs, s = generate_sample(
            rng, R, label=forced, num_features=num_features, orient=orient,
            param_range=param_range,
        )
        voxels[i, ..., 0] = part
        labels[i] = labs[0]
        seg[i] = s
    return {
        "voxels": voxels,
        "label": labels,
        "seg": seg,
        "mask": np.ones(batch_size, dtype=np.float32),
    }


def pack_voxels(voxels: np.ndarray) -> np.ndarray:
    """Bit-pack occupancy ``[B, R, R, R]`` (or ``[...,1]``) → ``[B,R,R,R/8]``,
    MSB first along W: 8 voxels per byte, 32x smaller than float32."""
    if voxels.ndim == 5:
        voxels = voxels[..., 0]
    if voxels.shape[-1] % 8:
        raise ValueError(f"W={voxels.shape[-1]} not divisible by 8")
    return np.packbits(voxels.astype(bool), axis=-1)


# The keys of each task's wire batch.
WIRE_KEYS = {
    "classify": ("voxels", "label", "mask"),
    "segment": ("voxels", "seg", "mask"),
}


def to_wire(batch: dict[str, np.ndarray],
            task: str = "classify") -> dict[str, np.ndarray]:
    """Shrink a ``generate_batch`` dict to a task's wire format: bit-packed
    voxels and the mask, with the labels (``classify``) or the per-voxel
    ``seg`` as int8 (``segment``)."""
    if task == "classify":
        return {"voxels": pack_voxels(batch["voxels"]),
                "label": batch["label"], "mask": batch["mask"]}
    if task == "segment":
        return {"voxels": pack_voxels(batch["voxels"]),
                "seg": batch["seg"].astype(np.int8), "mask": batch["mask"]}
    raise ValueError(f"unknown task {task!r}")
