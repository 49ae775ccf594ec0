"""The cube-group rotation of the port (``featurenet_tpu_torch/ops/augment.py``)
against the JAX package's (``featurenet_tpu/ops/augment.py``) on the CPU.

A rotation moves values and never changes one, so every comparison here
is bitwise, on random 0/1 grids made from numpy seeds.
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
