"""The ``fused33`` lowering (``ops/conv33.py``) against the JAX package's
``fused33_conv`` and against the port's ``xla`` conv, on the CPU, forward
and both gradients, and FeatureNet's logits under ``fused33`` against the
JAX FeatureNet's.

Tolerances: in fp32 both sides sum the same 27·Cin products per output in
other orders, to 1e-5 of each output's scale. In bf16 the inputs and the
result are rounded to bf16 (8 mantissa bits) and JAX rounds each
gradient term to bf16 before summing where the port sums in fp32, so a
value lands a few bf16 ulps apart: 2e-2 of the scale, as
``tests/test_torch_model.py`` holds bf16 logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu.ops.conv33 import fused33_conv as jax_fused33
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.models.featurenet import (
    ConvBNRelu,
    FeatureNet,
    FeatureNetArch,
)
from featurenet_tpu_torch.ops.conv3d import HybridConv, conv3d_xla
from featurenet_tpu_torch.ops.conv33 import Fused33Conv, fused33_conv

R = 16
TOL = {"fp32": 1e-5, "bf16": 2e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shape=(2, 6, 5, 7, 5), cout=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, shape[-1], cout))
         / np.sqrt(27 * shape[-1])).astype(np.float32)
    r = rng.standard_normal(shape[:-1] + (cout,)).astype(np.float32)
    return x, w, r


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _torch_grads(conv, x, w, r, tdtype):
    xt = torch.from_numpy(x).to(tdtype).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = conv(xt, wt)
    (out.float() * torch.from_numpy(r)).sum().backward()
    return out.detach().float(), xt.grad.float(), wt.grad


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fused33_matches_jax_forward_and_gradients(dtype, seed):
    jdtype, tdtype = DTYPES[dtype]
    x, w, r = _inputs(seed)

    def loss(xj, wj):
        return (jax_fused33(xj, wj).astype(jnp.float32) * r).sum()

    xj = jnp.asarray(x).astype(jdtype)
    want = jax_fused33(xj, jnp.asarray(w))
    dx, dw = jax.grad(loss, argnums=(0, 1))(xj, jnp.asarray(w))
    out, gx, gw = _torch_grads(fused33_conv, x, w, r, tdtype)
    assert out.shape == want.shape
    for got, ref in ((out, want), (gx, dx), (gw, dw)):
        _close(got.numpy(), np.asarray(ref, np.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fused33_matches_the_xla_conv(dtype):
    _, tdtype = DTYPES[dtype]
    x, w, r = _inputs(2, shape=(1, 8, 8, 8, 16), cout=32)
    got = _torch_grads(fused33_conv, x, w, r, tdtype)
    want = _torch_grads(conv3d_xla, x, w, r, tdtype)
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy(), TOL[dtype])


def test_fused33_keeps_dtypes_and_refuses_other_kernels():
    x = torch.zeros((1, 4, 4, 4, 3), dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 3, 3, 5), requires_grad=True)
    y = fused33_conv(x, w)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 4, 4, 4, 5)
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32
    wh = torch.zeros((3, 3, 3, 3, 5), dtype=torch.float16, requires_grad=True)
    fused33_conv(x, wh).float().sum().backward()
    assert wh.grad.dtype == torch.float16  # the working copy's dtype
    with pytest.raises(ValueError, match="3\\^3"):
        fused33_conv(x, torch.zeros((5, 5, 5, 3, 5)))
    with pytest.raises(ValueError, match="3\\^3"):
        Fused33Conv(3, 5, kernel_size=5)
    # Under fused33 a stride-1 block of another kernel size is the xla block.
    assert isinstance(ConvBNRelu(3, 4, 5, 1, torch.float32, "fused33", False).conv,
                      HybridConv)
    assert isinstance(ConvBNRelu(3, 4, 3, 1, torch.float32, "fused33", False).conv,
                      Fused33Conv)


SPRINT = dict(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
              strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
              hidden=32)
POD = dict(features=(8, 8, 16, 16), kernels=(7, 5, 3, 3),
           strides=(2, 1, 1, 1), pool_after=(False, True, False, True),
           hidden=32)


@pytest.mark.parametrize("arch_kw", [SPRINT, POD], ids=["sprint", "pod"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_featurenet_fused33_logits_match_jax(arch_kw, dtype):
    """The JAX FeatureNet under fused33 (params under ``Conv_0``, as for
    ``xla``) against the port's on the same weights; pod's 5³ stride-1
    block takes the xla block on both sides."""
    jdtype, tdtype = DTYPES[dtype]
    tol = {"fp32": 1e-4, "bf16": 2e-2}[dtype]
    rng = np.random.default_rng(5)
    x = (rng.random((3, R, R, R, 1)) > 0.5).astype(np.float32)
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend="fused33", **arch_kw),
                           dtype=jdtype)
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(
        jmodel.init({"params": jax.random.key(5)}, jnp.asarray(x), train=False)))
    assert "Conv_0" in v["params"]["ConvBNRelu_3"]
    want = np.asarray(jmodel.apply(v, jnp.asarray(x), train=False))
    arch = FeatureNetArch(conv_backend="fused33", **arch_kw)
    tmodel = FeatureNet(arch, R, dtype=tdtype)
    tmodel.load_state_dict(convert.from_flax(v, arch))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
