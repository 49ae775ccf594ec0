"""The port's conv gradients against the JAX package's on the CPU.

- ``conv3d_p`` (autograd: dx through the forward with the flipped,
  channel-swapped kernel, dW through ``conv3d_dw``) against the JAX
  ``conv3d_p`` custom VJP, whose Pallas kernels run in interpret mode.
  Both sum the same fp32 products in other orders: rtol/atol 1e-4, as
  ``tests/test_ops.py::test_pallas_conv_vjp``.
- ``conv_dw_folded`` against the JAX ``conv_dw_folded`` in fp32 and bf16,
  at ``test_conv_dw_folded_matches_xla_vjp``'s shapes and at a sprint64
  block's channels: both form exact
  products (a bf16 product is exact in fp32) and sum in fp32, to 1e-5 of
  the largest entry.
- ``conv3d_hybrid`` forward and both gradients against the JAX
  ``conv3d_hybrid`` in fp32, at ``test_hybrid_conv_grads_match_xla_conv``'s
  tolerances.

On the CPU every wrapper runs its plain version and counts no launch; the
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.ops.conv3d import conv3d_hybrid as jax_conv3d_hybrid
from featurenet_tpu.ops.conv3d import conv3d_p as jax_conv3d_p
from featurenet_tpu.ops.conv_dw import conv_dw_folded as jax_conv_dw_folded
from featurenet_tpu_torch.ops import conv3d as port
from featurenet_tpu_torch.ops import conv_dw as port_dw


def _launch_counts():
    return (port.conv3d_fwd_launches, port.conv3d_dw_launches,
            port.conv3d_dw_sum_launches, port_dw.conv_dw_folded_launches,
            port_dw.conv_dw_folded_sum_launches)


def _port_grads(fn, x, w, loss):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fn(xt, wt)
    loss(out).backward()
    return out.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("shape,k,cin,cout", [
    ((2, 8, 8, 8), 3, 4, 8),   # test_pallas_conv_vjp's shape
    ((2, 6, 8, 8), 3, 8, 4),
    ((1, 6, 6, 8), 5, 4, 4),
])
def test_conv3d_p_grads_match_jax_vjp(shape, k, cin, cout):
    rng = np.random.default_rng(k * 100 + cin * 10 + cout)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal((k, k, k, cin, cout)) * 0.1).astype(np.float32)
    g = rng.standard_normal(shape + (cout,)).astype(np.float32)
    dx_j, dw_j = jax.grad(lambda x, w: jnp.vdot(jax_conv3d_p(x, w), g),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    before = _launch_counts()
    _, dx, dw = _port_grads(port.conv3d_p, x, w,
                            lambda out: (out * torch.from_numpy(g)).sum())
    assert _launch_counts() == before
    np.testing.assert_allclose(dx, np.asarray(dx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,d,h,w,ci,co,k", [
    (2, 8, 8, 8, 8, 16, 3),
    (2, 8, 8, 16, 32, 32, 5),
    (1, 8, 8, 8, 32, 64, 3),  # a sprint64 block's channels (32→64)
])
def test_conv_dw_folded_matches_jax(dtype, b, d, h, w, ci, co, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, d, h, w, ci)).astype(np.float32)
    g = rng.standard_normal((b, d, h, w, co)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax_conv_dw_folded(jnp.asarray(x, jdt), jnp.asarray(g, jdt), k))
    tdt = getattr(torch, dtype)
    xt, gt = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    # Both sides see the same bf16-rounded inputs.
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(jnp.asarray(x, jdt), np.float32))
    before = _launch_counts()
    got = port_dw.conv_dw_folded(xt, gt, k)
    assert _launch_counts() == before
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert err < 1e-5, err


def test_conv3d_hybrid_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 8, 8)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 8, 16)).astype(np.float32)
    want = np.asarray(jax_conv3d_hybrid(jnp.asarray(x), jnp.asarray(w)))
    gx_j, gw_j = jax.grad(lambda x, w: (jax_conv3d_hybrid(x, w) ** 2).sum(),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    before = _launch_counts()
    out, gx, gw = _port_grads(port.conv3d_hybrid, x, w,
                              lambda out: (out ** 2).sum())
    assert _launch_counts() == before
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gx, np.asarray(gx_j), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(gw, np.asarray(gw_j), rtol=2e-4, atol=1e-3)
    # The plain twin gives the same gradients.
    _, gx_p, gw_p = _port_grads(port.conv3d_hybrid_plain, x, w,
                                lambda out: (out ** 2).sum())
    np.testing.assert_array_equal(gx_p, gx)
    np.testing.assert_array_equal(gw_p, gw)


@pytest.mark.parametrize("chunk", [port_dw.CHUNK, port_dw.MMA_CHUNK])
@pytest.mark.parametrize("length,tiles", [
    (945, 2), (1, 1), (16, 528), (256 * 16 ** 3, 4), (256 * 16 ** 3, 14),
    (256 * 16 * 16 * 18, 6), (100_000, 1000),
])
def test_slab_plan_covers_the_sum(length, tiles, chunk):
    """Slabs are whole chunks (16 q-rows for the SIMT kernels, 32 for the
    bf16 tensor-core kernel), cover the sum exactly once, none is empty,
    and the launch stays near the block target."""
    slabs, slab_len = port_dw.plan_slabs(length, tiles, chunk)
    assert slab_len % chunk == 0 and slabs >= 1
    assert (slabs - 1) * slab_len < length <= slabs * slab_len
    assert slabs == 1 or slab_len >= port_dw.MIN_SLAB
    assert slabs * tiles <= 2 * max(port_dw.TARGET_BLOCKS, tiles)


@pytest.mark.parametrize("cin,cout,plan", [
    (32, 32, (512, 32, 4, 132, 7952)), (32, 64, (256, 64, 4, 66, 15888)),
    (64, 64, (256, 64, 4, 37, 28352)),
])
def test_conv3d_dw_slab_plan_is_unchanged(cin, cout, plan):
    """``conv3d_dw``'s launch at sprint64's batch-256 shapes: 16-byte copies,
    and slabs that fill one wave of 2 blocks on each of 132 SMs
    (264, 264 and 259 blocks)."""
    got = port.dw_plan((256, 16, 16, 16, cin), cout, 3, 0, 256)
    assert tuple(got) == plan
    tiles = -(-(27 * cin) // got.bm) * -(-cout // got.bn)
    assert tiles * got.slabs <= port.SMS * port.DW_BLOCKS_PER_SM


@pytest.mark.parametrize("cin,cout,x_ptr,g_ptr,vec", [
    (32, 64, 0, 16, 4), (8, 12, 4096, 64, 4),
    (32, 64, 4, 16, 1), (32, 64, 0, 8, 1),  # a base off 16-byte alignment
    (33, 64, 0, 0, 1), (32, 65, 0, 0, 1), (3, 5, 0, 0, 1),  # a channel count
    (6, 8, 0, 0, 1), (8, 2, 0, 0, 1),
])
def test_conv3d_dw_copy_width(cin, cout, x_ptr, g_ptr, vec):
    """16-byte copies only when Cin and Cout are multiples of 4 and both
    bases are 16-byte aligned; a function of the shapes and addresses."""
    assert port.dw_plan((2, 4, 4, 4, cin), cout, 3, x_ptr, g_ptr).vec == vec


@pytest.mark.parametrize("shape,cout,k", [
    ((256, 16, 16, 16, 32), 32, 3), ((256, 16, 16, 16, 64), 64, 3),
    ((8, 32, 32, 32, 32), 32, 5), ((3, 5, 7, 9, 33), 65, 3),
    ((1, 3, 5, 7, 4), 8, 3), ((2, 3, 4, 1, 8), 12, 3), ((1, 1, 1, 1, 3), 5, 1),
    ((64, 16, 16, 16, 64), 96, 7),
])
def test_conv3d_dw_plan_covers_the_sum(shape, cout, k):
    """Slabs are whole 16-position chunks, cover the positions exactly once,
    none is empty, the tiles are those the kernel instantiates, and the
    launch stays within one wave unless the tiles alone are more."""
    plan = port.dw_plan(shape, cout, k, 0, 0)
    length = shape[0] * shape[1] * shape[2] * shape[3]
    assert (plan.bm, plan.bn) in ((512, 32), (256, 64))
    assert plan.bn == (32 if cout <= 32 else 64)
    assert plan.slab_len % port.DW_CHUNK == 0 and plan.slabs >= 1
    assert (plan.slabs - 1) * plan.slab_len < length <= plan.slabs * plan.slab_len
    tiles = -(-(k ** 3 * shape[-1]) // plan.bm) * -(-cout // plan.bn)
    assert tiles * plan.slabs <= max(port.SMS * port.DW_BLOCKS_PER_SM, tiles)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("cin,cout,plan", [
    (32, 32, (128, 106, 11136)), (32, 64, (64, 59, 20000)),
    (64, 64, (64, 36, 32768)),
])
def test_folded_plan_is_unchanged(dtype, cin, cout, plan):
    """``conv_dw_folded``'s launch at sprint64's batch-256 shapes stays as
    it was before ``plan_slabs`` took a block target for ``conv3d_dw``."""
    dt = getattr(torch, dtype)
    x = torch.empty((256, 16, 16, 16, cin), dtype=dt, device="meta")
    g = torch.empty((256, 16, 16, 16, cout), dtype=dt, device="meta")
    assert port_dw.folded_plan(x, g, 3) == plan


@pytest.mark.parametrize("k,cin,cout,bn", [
    (3, 32, 32, 128), (3, 32, 64, 64), (3, 64, 64, 64), (5, 32, 32, 32),
])
def test_folded_tile_pads_least(k, cin, cout, bn):
    assert port_dw.folded_tile(k, cin, cout) == bn


def test_dw_wrappers_reject_bad_shapes():
    x = torch.zeros((1, 4, 4, 4, 3))
    for fn in (port.conv3d_dw, port_dw.conv_dw_folded):
        with pytest.raises(ValueError):
            fn(x, torch.zeros((1, 4, 4, 5, 2)), 3)  # spatial mismatch
        with pytest.raises(ValueError):
            fn(x, torch.zeros((1, 4, 4, 4, 2)), 2)  # even K
        with pytest.raises(ValueError, match="no kernel"):
            fn(x.to("meta"), torch.zeros((1, 4, 4, 4, 2), device="meta"), 3)
