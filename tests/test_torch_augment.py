"""The in-step augmentation of the port (``featurenet_tpu_torch/ops/augment.py``)
against the JAX package's (``featurenet_tpu/ops/augment.py`` and the
occupancy noise of ``featurenet_tpu/train/steps.py``) on the CPU, on
inputs made from numpy seeds.

- A rotation moves values and never changes one, so the cube rotations
  (host codes and device codes) are held bitwise.
- The affine warp is handed the draws the reference makes from its key
  (its own split sequence, ``random_affine_batch_paired``) and held to
  1e-5 absolute: both compute fp32 source coordinates in the same order
  and sum the 8 trilinear terms of voxels in [0, 1], each corner weighted
  from the coordinate itself (the port through ``grid_sample`` in
  float64, which carries the fp32 coordinate through its normalisation;
  the port's coordinates are sums of three products where the
  reference takes a matrix product, an fp32 rounding apart); measured
  ~1e-6.
- The noise is ``|v - flip|`` of the reference's own mask: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.ops import augment as jax_augment
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu_torch.ops import augment
from featurenet_tpu_torch.train import steps

R = 6


def _grids(seed: int, b: int, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random((b, R, R, R, 1)) < 0.4).astype(dtype)


def test_cube_group_has_the_reference_order():
    assert augment.CUBE_GROUP == jax_augment.CUBE_GROUP
    assert len({(p, f) for p, f in augment.CUBE_GROUP}) == 24


@pytest.mark.parametrize("code", range(24))
def test_each_code_rotates_as_the_reference(code):
    x = _grids(code, 2)
    want = np.asarray(jax_augment.rotate_grids(jnp.asarray(x), code))
    got = augment.rotate_grids(torch.from_numpy(x), code)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rotations_of_an_asymmetric_grid_are_24_distinct_grids():
    x = torch.arange(R ** 3, dtype=torch.int32).reshape(1, R, R, R, 1)
    seen = {augment.rotate_grids(x, c).numpy().tobytes() for c in range(24)}
    assert len(seen) == 24


@pytest.mark.parametrize("b,groups", [(16, 8), (12, 8), (6, 8), (7, 8), (8, 1)])
def test_group_rotation_matches_random_rotate_batch(b, groups):
    """The reference draws one code per group from its key; fed the same
    codes, the port rotates the same slices the same way."""
    x = _grids(b + groups, b)
    key = jax.random.key(b * 31 + groups)
    want = np.asarray(jax_augment.random_rotate_batch(jnp.asarray(x), key, groups))
    n = augment.group_count(b, groups)
    codes = jax.random.randint(key, (n,), 0, 24).tolist()
    got = augment.rotate_groups(torch.from_numpy(x), codes)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_rotate_batch_draws_from_its_generator():
    x = torch.from_numpy(_grids(3, 12))
    a = augment.random_rotate_batch(x, torch.Generator().manual_seed(5), groups=8)
    b = augment.random_rotate_batch(x, torch.Generator().manual_seed(5), groups=8)
    assert torch.equal(a, b) and a.shape == x.shape
    codes = augment.draw_codes(torch.Generator().manual_seed(5), 12, 8)
    assert len(codes) == 6 and all(0 <= c < 24 for c in codes)
    assert torch.equal(a, augment.rotate_groups(x, codes))
    with pytest.raises(ValueError, match="do not split"):
        augment.rotate_groups(x, [0] * 5)


def test_rotating_before_the_cast_is_bitwise_the_same():
    """The step rotates the unpacked 0/1 bytes and then casts; the
    reference unpacks to float and rotates that."""
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 256, (4, 8, 8, 1), dtype=np.uint8)
    codes = [3, 17]
    got = steps.step_voxels(torch.from_numpy(packed), codes)
    unpacked = jax_steps.unpack_voxels(jnp.asarray(packed))
    want = np.concatenate([np.asarray(jax_augment.rotate_grids(unpacked[i * 2:(i + 1) * 2], c))
                           for i, c in enumerate(codes)])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# --- device codes --------------------------------------------------------------

@pytest.mark.parametrize("b,groups", [(16, 8), (12, 8), (7, 8)])
def test_device_codes_rotate_bitwise_as_rotate_groups(b, groups):
    """The gather through the 24 flat index maps, with the codes in a
    tensor drawn from a generator, is ``rotate_groups`` of the same codes
    (and ``draw_code_tensor`` draws ``draw_codes``'s values)."""
    x = torch.from_numpy(_grids(b, b, np.uint8))
    codes = augment.draw_code_tensor(torch.Generator().manual_seed(b), b, groups)
    assert codes.tolist() == augment.draw_codes(torch.Generator().manual_seed(b),
                                                b, groups)
    got = augment.rotate_by_codes(x, codes)
    np.testing.assert_array_equal(got.numpy(),
                                  augment.rotate_groups(x, codes.tolist()).numpy())
    every = torch.arange(24)
    x24 = torch.from_numpy(_grids(1, 24, np.uint8))
    np.testing.assert_array_equal(augment.rotate_by_codes(x24, every).numpy(),
                                  augment.rotate_groups(x24, range(24)).numpy())
    with pytest.raises(ValueError, match="do not split"):
        augment.rotate_by_codes(x, torch.tensor([0] * 5))


# --- the affine warp ------------------------------------------------------------

def _reference_affine_draw(key, b, groups, prob, scale_range, rotate, translate):
    """The draws ``random_affine_batch_paired`` makes from ``key``, as the
    port's ``AffineDraw`` (the rotation through the port's
    ``quat_to_matrix`` from the reference's normal draw)."""
    n = augment.group_count(b, groups)
    lo, hi = scale_range
    rots, scales, trans, takes = [], [], [], []
    for k in jax.random.split(key, n):
        kc, kp = jax.random.split(k)
        kq, ks, kt = jax.random.split(kc, 3)
        scales.append(np.asarray(jax.random.uniform(ks, (), minval=lo, maxval=hi)))
        trans.append(np.asarray(jax.random.uniform(
            kt, (3,), minval=-translate, maxval=translate)) if translate > 0.0
            else np.zeros(3, np.float32))
        q = np.array(jax.random.normal(kq, (4,)))
        rots.append(augment.quat_to_matrix(torch.from_numpy(q)) if rotate
                    else torch.eye(3))
        takes.append(bool(jax.random.bernoulli(kp, prob)))
    return augment.AffineDraw(torch.stack(rots),
                              torch.from_numpy(np.stack(scales)),
                              torch.from_numpy(np.stack(trans)),
                              torch.tensor(takes))


@pytest.mark.parametrize("prob,rotate,translate", [
    (0.0, True, 0.0), (0.5, False, 1.5), (1.0, True, 2.0)])
def test_affine_warp_matches_random_affine_batch_paired(prob, rotate, translate):
    """A non-cubic grid (D, H, W = 5, 6, 7, where swapping grid_sample's
    axes would show), two channels, 6 samples in 4 requested groups (3
    groups of 2); the plain gather as well."""
    rng = np.random.default_rng(int(prob * 10) + 3 * rotate)
    x = (rng.random((6, 5, 6, 7, 2)) * (rng.random((6, 5, 6, 7, 2)) < 0.5)
         ).astype(np.float32)
    key = jax.random.key(int(translate * 2) + 5)
    scale_range = (0.7, 1.05)
    want = np.asarray(jax_augment.random_affine_batch_paired(
        jnp.asarray(x), None, key, 4, scale_range=scale_range, rotate=rotate,
        translate_vox=translate, prob=prob)[0])
    draw = _reference_affine_draw(key, 6, 4, prob, scale_range, rotate, translate)
    got = augment.affine_warp(torch.from_numpy(x), *draw).numpy()
    plain = augment.affine_warp_plain(torch.from_numpy(x), *draw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain, want, rtol=0, atol=1e-5)
    kept = ~draw.take.repeat_interleave(2).numpy()
    np.testing.assert_array_equal(got[kept], x[kept])  # bitwise pass-through
    if prob == 0.0:
        np.testing.assert_array_equal(got, x)


def test_quaternion_matrix_matches_the_reference():
    q = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    want = np.stack([np.asarray(jax_augment._quat_to_matrix(jnp.asarray(r))) for r in q])
    got = augment.quat_to_matrix(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape), atol=1e-5)


def test_affine_draws_follow_their_options():
    """Identity rotations with ``rotate=False``, no translation at 0, the
    scale inside its window, the take flags' rate, and the ramp from a
    device step count (the reference's ``prob·clip(step/ramp, 0, 1)``)."""
    g = torch.Generator().manual_seed(1)
    d = augment.draw_affine(g, 4096, 4096, prob=0.25, scale_range=(0.8, 0.9),
                            rotate=False)
    assert torch.equal(d.rot, torch.eye(3).expand(4096, 3, 3))
    assert torch.equal(d.trans, torch.zeros(4096, 3))
    assert 0.8 <= float(d.scale.min()) and float(d.scale.max()) <= 0.9
    assert abs(float(d.take.float().mean()) - 0.25) < 0.03
    d = augment.draw_affine(g, 64, 8, translate_vox=2.0)
    assert d.rot.shape == (8, 3, 3) and float(d.trans.abs().max()) <= 2.0
    assert bool(d.take.all())
    ramp = [float(augment.affine_prob(0.5, 4, torch.tensor(s))) for s in (0, 2, 4, 9)]
    want = [float(0.5 * jnp.clip(jnp.int32(s) / 4, 0.0, 1.0)) for s in (0, 2, 4, 9)]
    assert ramp == want == [0.0, 0.25, 0.5, 0.5]
    assert augment.affine_prob(0.5, 0, torch.tensor(0)) == 0.5


# --- occupancy noise -------------------------------------------------------------

def test_noise_flips_the_reference_mask_bitwise():
    """The reference's step flips ``bernoulli(noise_rng, p, shape)`` as
    ``|v - flip|``; handed that mask, the port flips the same voxels, on a
    warped (fractional) grid as well as on a 0/1 one."""
    rng = np.random.default_rng(4)
    x = (rng.random((4, R, R, R, 1)) < 0.4).astype(np.float32)
    x[2:] *= rng.random((2, R, R, R, 1)).astype(np.float32)
    flip = jax.random.bernoulli(jax.random.key(8), 0.05, x.shape)
    want = np.asarray(jnp.abs(jnp.asarray(x) - flip.astype(jnp.float32)))
    got = augment.occupancy_noise(torch.from_numpy(x),
                                  torch.from_numpy(np.array(flip)))
    np.testing.assert_array_equal(got.numpy(), want)
    mask = augment.draw_flips(torch.Generator().manual_seed(0), (64, 32, 32), 0.005)
    assert mask.dtype == torch.bool and 0.004 < float(mask.float().mean()) < 0.006
