"""The port's voxel → mesh pipeline against the JAX package's on the CPU.

Every function here is numpy on the same inputs, so each is held bitwise:
``voxels_to_mesh``, ``random_rotation_matrix`` from the same generator
state (and the state it leaves), ``rotate_mesh``, and the STL files
``export_stl_tree`` writes, byte for byte. Sizes: R=16, one part per class.
"""

import os

import numpy as np
import pytest

from featurenet_tpu.data import voxel_to_mesh as jax_v2m
from featurenet_tpu.data.synthetic import generate_sample as jax_generate_sample
from featurenet_tpu_torch.data import voxel_to_mesh as v2m
from featurenet_tpu_torch.data.synthetic import CLASS_NAMES, generate_sample
from featurenet_tpu_torch.data.voxelize import voxelize

R = 16


@pytest.mark.parametrize("label", [0, 7, 19])
def test_voxels_to_mesh_is_the_reference(label):
    grid, _, _ = generate_sample(np.random.default_rng(label), R, label=label)
    want, _, _ = jax_generate_sample(np.random.default_rng(label), R, label=label)
    np.testing.assert_array_equal(grid, want)
    tris = v2m.voxels_to_mesh(grid)
    assert tris.dtype == np.float32
    np.testing.assert_array_equal(tris, jax_v2m.voxels_to_mesh(grid))
    np.testing.assert_array_equal(v2m.voxels_to_mesh(grid, scale=1.0),
                                  jax_v2m.voxels_to_mesh(grid, scale=1.0))
    # The exact round trip of the geometry contract.
    back = voxelize(tris, R, fill=True, normalize=False, backend="numpy")
    np.testing.assert_array_equal(back, grid.astype(bool))


@pytest.mark.parametrize("angle", [None, 5.0, 45.0])
def test_rotation_draws_and_rotate_mesh_are_the_reference(angle):
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    rot = v2m.random_rotation_matrix(a, angle)
    want = jax_v2m.random_rotation_matrix(b, angle)
    np.testing.assert_array_equal(rot, want)
    assert a.bit_generator.state == b.bit_generator.state
    np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
    grid, _, _ = generate_sample(np.random.default_rng(2), R, label=3)
    tris = v2m.voxels_to_mesh(grid)
    np.testing.assert_array_equal(v2m.rotate_mesh(tris, rot),
                                  jax_v2m.rotate_mesh(tris, rot))


def test_empty_and_full_grids_as_the_reference():
    empty = np.zeros((4, 4, 4), bool)
    assert v2m.voxels_to_mesh(empty).shape == (0, 3, 3)
    np.testing.assert_array_equal(v2m.voxels_to_mesh(empty),
                                  jax_v2m.voxels_to_mesh(empty))
    full = np.ones((2, 2, 2), bool)
    tris = v2m.voxels_to_mesh(full)
    assert tris.shape == (48, 3, 3)  # 6 sides x 2x2 faces x 2 triangles
    np.testing.assert_array_equal(tris, jax_v2m.voxels_to_mesh(full))
    with pytest.raises(ValueError, match=r"\[R, R, R\]"):
        v2m.voxels_to_mesh(np.zeros((4, 4), bool))


def test_export_stl_tree_writes_the_reference_bytes(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    got = v2m.export_stl_tree(port, per_class=1, resolution=R, seed=4)
    want = jax_v2m.export_stl_tree(ref, per_class=1, resolution=R, seed=4)
    assert got == want
    assert sorted(os.listdir(port)) == sorted(CLASS_NAMES)
    for cls in CLASS_NAMES:
        assert os.listdir(os.path.join(port, cls)) == [f"{cls}_0000.stl"]
        with open(os.path.join(port, cls, f"{cls}_0000.stl"), "rb") as a, \
                open(os.path.join(ref, cls, f"{cls}_0000.stl"), "rb") as b:
            assert a.read() == b.read(), cls
