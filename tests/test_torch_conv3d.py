"""The port's ``conv3d_p`` against the JAX package's Pallas ``conv3d_p``.

On the CPU the port's wrapper runs its plain version (the K³ tap-shift sum
in fp32) and the JAX kernel runs in Pallas interpret mode; both sum the
same fp32 products in different orders, hence rtol/atol 1e-4. The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.ops.conv3d import conv3d_p as jax_conv3d_p
from featurenet_tpu_torch.ops import build
from featurenet_tpu_torch.ops import conv3d as port


@pytest.mark.parametrize("k,cin,cout", [
    (3, 8, 8), (3, 8, 16), (3, 16, 8), (3, 4, 32), (5, 4, 8), (5, 8, 4),
])
def test_plain_conv_matches_jax_kernel(k, cin, cout):
    rng = np.random.default_rng(k * 100 + cin * 10 + cout)
    x = rng.standard_normal((2, 6, 8, 8, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, cin, cout)) * 0.1).astype(np.float32)
    want = np.asarray(jax_conv3d_p(jnp.asarray(x), jnp.asarray(w)))
    launches = port.conv3d_fwd_launches
    got = port.conv3d_p(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # The CPU path is the plain version; only a kernel launch counts.
    assert port.conv3d_fwd_launches == launches


@pytest.mark.parametrize("x_shape,w_shape", [
    ((1, 4, 4, 4, 3), (2, 2, 2, 3, 4)),   # even K
    ((1, 4, 4, 4, 3), (3, 3, 3, 2, 4)),   # channel mismatch
    ((4, 4, 4, 3), (3, 3, 3, 3, 4)),      # no batch dim
])
def test_conv_rejects_bad_shapes(x_shape, w_shape):
    with pytest.raises(ValueError):
        port.conv3d_p(torch.zeros(x_shape), torch.zeros(w_shape))


def test_conv_has_no_kernel_off_cuda():
    x = torch.zeros((1, 4, 4, 4, 2), device="meta")
    w = torch.zeros((3, 3, 3, 2, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        port.conv3d_p(x, w)


def test_pallas_conv_module_keeps_cast_order():
    rng = np.random.default_rng(0)
    m = port.PallasConv(4, 8, 3, dtype=torch.bfloat16)
    with torch.no_grad():
        m.kernel.copy_(torch.from_numpy(
            (rng.standard_normal((3, 3, 3, 4, 8)) * 0.1).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 4)).astype(np.float32))
    y = m(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    want = port.conv3d_plain(x.to(torch.bfloat16).float(), m.kernel.detach())
    assert torch.equal(y, want.to(torch.bfloat16))


def test_kernel_build_targets_hopper():
    """The build line asks nvcc for sm_90a, and the library name follows
    the source, so an edited kernel rebuilds. Nothing is built here."""
    assert set(build.SOURCES) == {"conv3d_fwd", "conv3d_dw", "conv_dw_folded"}
    for name, src in build.SOURCES.items():
        cmd = build.nvcc_command("nvcc", name, build.library_path(name))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[-1].endswith(f"csrc/{src}")
        assert build.library_path(name).parent == build.BUILD_DIR
        assert (build.SRC_DIR / src).is_file()


@pytest.mark.parametrize("shape,cout,plan", [
    ((256, 16, 16, 16, 32), 32, (512, 32, 4)),  # sprint64 train fwd / dx
    ((256, 16, 16, 16, 32), 64, (256, 64, 4)),
    ((256, 16, 16, 16, 64), 32, (512, 32, 4)),
    ((64, 16, 16, 16, 64), 64, (256, 64, 4)),  # serving's bucket 64
    ((8, 32, 32, 32, 32), 32, (512, 32, 4)),  # pod64's 5³ conv2
    ((2, 9, 9, 9, 8), 96, (64, 64, 4)),  # 6 x 2 column tiles: small
    ((1, 16, 16, 16, 32), 32, (128, 32, 4)),  # bucket 1: 8 blocks, small
    ((1, 16, 16, 16, 64), 64, (64, 64, 4)),
    ((16, 16, 16, 16, 32), 32, (128, 32, 4)),  # bucket 16: 128 blocks < 132
    ((16, 16, 16, 16, 64), 64, (256, 64, 4)),  # 256 blocks
    ((1, 5, 6, 7, 3), 5, (128, 32, 1)),
])
def test_fwd_plan_tile(shape, cout, plan):
    """The output tile follows Cout (≤32 columns → 512×32, else 256×64),
    a quarter the size (128 threads of 8×4 outputs) where the full one
    gives fewer blocks than SMs."""
    got = port.fwd_plan(shape, cout, 0, 256)
    assert tuple(got) == plan
    assert (got.bm, got.bn) in ((512, 32), (256, 64), (128, 32), (64, 64))
    full = port.FWD_TILE_AREA // got.bn
    blocks = -(-(shape[0] * shape[1] * shape[2] * shape[3]) // full)
    blocks *= -(-cout // got.bn)
    assert (got.bm == full) == (blocks >= port.SMS)


@pytest.mark.parametrize("cin,cout,x_ptr,w_ptr,vec", [
    (32, 64, 0, 16, 4), (4, 8, 4096, 64, 4), (12, 20, 0, 0, 4),
    (32, 64, 4, 16, 1), (32, 64, 0, 8, 1),  # a base off 16-byte alignment
    (33, 64, 0, 0, 1), (32, 65, 0, 0, 1), (3, 5, 0, 0, 1),  # a channel count
    (6, 8, 0, 0, 1), (8, 2, 0, 0, 1),
])
def test_fwd_plan_copy_width(cin, cout, x_ptr, w_ptr, vec):
    """16-byte copies only when Cin and Cout are multiples of 4 and both
    bases are 16-byte aligned."""
    assert port.fwd_plan((2, 4, 4, 4, cin), cout, x_ptr, w_ptr).vec == vec


def test_fwd_plan_is_a_function_of_shapes_and_addresses():
    """Same shapes and addresses, same plan, whatever was planned before;
    only an address's alignment, not its value, moves the copy width."""
    args = [((b, 16, 16, 16, c), co, xp, wp) for b in (1, 16, 256)
            for c, co in ((32, 32), (64, 32), (3, 5)) for xp, wp in ((0, 0), (4, 16))]
    first = [port.fwd_plan(*a) for a in args]
    assert [port.fwd_plan(*a) for a in reversed(args)] == first[::-1]
    for shape, cout, xp, wp in args:
        assert port.fwd_plan(shape, cout, xp + 4096, wp + 1 << 20) == \
            port.fwd_plan(shape, cout, xp, wp)
