"""The port's native voxelizer (``featurenet_tpu_torch/native``, built by
g++ into ``build/native/``) against the JAX package's numpy voxelizer on
the CPU. The JAX package's own native build is never run here: every
reference call passes ``backend="numpy"``.

- Solid (``fill=True``, parity): the native fill uses the numpy path's
  jitter and ceiling rule in float64, so on watertight meshes it is
  bitwise the reference's numpy fill.
- Shell (``fill=False``): the native shell is the exact triangle-box test
  and the numpy shell a point sampling of each triangle, so by design the
  native shell is a superset of the reference's (the reference's own
  contract, ``tests/test_native.py``); it equals it where no triangle
  grazes a voxel between samples. The port's numpy shell is bitwise the
  reference's.

Meshes: two primitives, the exact surface of a generated part, and that
surface rotated off the grid axes, at R=16 and 32.
"""

import importlib

import numpy as np
import pytest

from featurenet_tpu.data.mesh_primitives import mesh_cylinder
from featurenet_tpu_torch import native
from featurenet_tpu_torch.data import voxelize as port_voxelize
from featurenet_tpu_torch.data.mesh_primitives import mesh_box
from featurenet_tpu_torch.data.synthetic import generate_sample
from featurenet_tpu_torch.data.voxel_to_mesh import (
    random_rotation_matrix,
    rotate_mesh,
    voxels_to_mesh,
)

# The module (the JAX package's ``data/__init__`` exports the function
# under the same name).
jax_voxelize = importlib.import_module("featurenet_tpu.data.voxelize")


def _meshes(R):
    grid, _, _ = generate_sample(np.random.default_rng(R), R, label=5)
    surface = voxels_to_mesh(grid)
    return {
        "box": mesh_box(),
        "cylinder": mesh_cylinder(),
        "part": surface,
        "rotated part": rotate_mesh(
            surface, random_rotation_matrix(np.random.default_rng(3))),
    }


def test_native_builds_into_the_build_tree():
    info = native.build()
    assert native.available()
    assert info["path"].endswith(".so")
    assert "/build/native/libfnvox-" in info["path"]
    assert native.omp_threads() >= 1


@pytest.mark.parametrize("fill", [True, False], ids=["solid", "shell"])
@pytest.mark.parametrize("R", [16, 32])
def test_native_against_the_reference_numpy_voxelizer(R, fill):
    for name, tris in _meshes(R).items():
        got = port_voxelize.voxelize(tris, R, fill=fill, backend="native")
        want = jax_voxelize.voxelize(tris, R, fill=fill, backend="numpy")
        assert got.dtype == bool and got.shape == (R, R, R)
        assert want.any(), name
        if fill:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert not (want & ~got).any(), name
            np.testing.assert_array_equal(
                port_voxelize.voxelize(tris, R, fill=False, backend="numpy"),
                want, err_msg=name)
        # "auto" takes the native library when it builds.
        np.testing.assert_array_equal(
            port_voxelize.voxelize(tris, R, fill=fill), got, err_msg=name)


def test_flood_fill_and_the_native_refusal_match_the_reference():
    tris = _meshes(16)["rotated part"]
    got = port_voxelize.voxelize(tris, 16, fill_method="flood")
    want = jax_voxelize.voxelize(tris, 16, fill_method="flood",
                                 backend="numpy")
    np.testing.assert_array_equal(got, want)
    surface = jax_voxelize._rasterize_surface(
        jax_voxelize.normalize_mesh(tris), 16)
    np.testing.assert_array_equal(port_voxelize._fill_interior(surface),
                                  jax_voxelize._fill_interior(surface))
    for mod in (port_voxelize, jax_voxelize):
        with pytest.raises(ValueError, match="no flood fill"):
            mod.voxelize(tris, 16, fill_method="flood", backend="native")
