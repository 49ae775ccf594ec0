"""The port's segmenter and its losses against the JAX package's, on the
CPU, with weights carried by ``convert.from_flax``.

Tolerances, each with its reason:

- the forward in fp32 on both sides: the same math, the convolutions sum
  the same products in other orders, so the logits agree to 1e-5 of their
  scale (relative); in bf16 both round activations at every block, at
  slightly different places, and are held to ``tests/test_torch_model.py``'s
  2e-2;
- the transposed conv alone: one product per output voxel plus the bias,
  1e-6;
- a strided block alone (conv, batch norm in train mode, ReLU): 1e-5 of
  the output's scale, the batch statistics 1e-5 relative;
- the losses and their metrics: the same fp32 arithmetic in another
  order, 1e-6 relative.

The segmenter runs at R=16 with ``seg_features=(4, 8)``; the strided block
also at 64→32 with three input channels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from featurenet_tpu.models.featurenet import ConvBNRelu as JaxConvBNRelu
from featurenet_tpu.models.segmenter import FeatureNetSegmenter as JaxSegmenter
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.models.featurenet import ConvBNRelu
from featurenet_tpu_torch.models.segmenter import (
    FeatureNetSegmenter,
    conv_transpose_2s2,
)
from featurenet_tpu_torch.runtime import build_model, serve_forward
from featurenet_tpu_torch.train import steps

R = 16
FEATURES = (4, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    # Many small forwards: a thread team per xdist worker only slows them.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _jax_variables(model, x, seed):
    """Flax init, then every bias, batch-norm affine and statistic made
    non-trivial, so the bridge maps each of them."""
    v = _np(model.init({"params": jax.random.key(seed)}, jnp.asarray(x)))
    rng = np.random.default_rng(seed)
    for name, scope in v["params"].items():
        if "bias" in scope:
            scope["bias"] = rng.normal(0, 0.2, scope["bias"].shape).astype(np.float32)
        if "BatchNorm_0" in scope:
            bn, st = scope["BatchNorm_0"], v["batch_stats"][name]["BatchNorm_0"]
            n = bn["scale"].shape[0]
            bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
            st["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return v


def _logits_both(context, decoder_blocks, jdtype, tdtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((2, R, R, R, 1)) > 0.5).astype(np.float32)
    jmodel = JaxSegmenter(features=FEATURES, dtype=jdtype, input_context=context,
                          decoder_blocks=decoder_blocks)
    v = _jax_variables(jmodel, x, seed)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x)))
    tmodel = FeatureNetSegmenter(FEATURES, dtype=tdtype, input_context=context,
                                 decoder_blocks=decoder_blocks)
    state = convert.from_flax(v)
    assert sorted(state) == sorted(tmodel.state_dict())  # one to one
    tmodel.load_state_dict(state)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("context", ["none", "proj", "proj_coords"])
@pytest.mark.parametrize("decoder_blocks", [1, 2])
def test_fp32_logits_match_jax(context, decoder_blocks):
    got, want = _logits_both(context, decoder_blocks, jnp.float32, torch.float32)
    assert got.dtype == np.float32 and got.shape == want.shape == (2, R, R, R, 25)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_bf16_logits_match_jax():
    got, want = _logits_both("proj_coords", 2, jnp.bfloat16, torch.bfloat16,
                             seed=1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_conv_transpose_matches_flax():
    """An asymmetric kernel and a bias: each output voxel ``2i+r`` takes
    ``x[i]·kernel[1-r]`` in Flax's orientation, which a flip would not
    hide."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    layer = fnn.ConvTranspose(7, kernel_size=(2, 2, 2), strides=(2, 2, 2),
                              dtype=jnp.float32, param_dtype=jnp.float32)
    kernel = rng.standard_normal((2, 2, 2, 6, 7)).astype(np.float32)
    bias = rng.standard_normal(7).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}},
                                  jnp.asarray(x)))
    got = conv_transpose_2s2(torch.from_numpy(x), torch.from_numpy(kernel),
                             torch.from_numpy(bias)).numpy()
    assert got.shape == want.shape == (2, 6, 8, 10, 7)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The unflipped kernel is another map: the orientation is tested.
    wrong = conv_transpose_2s2(torch.from_numpy(x),
                               torch.from_numpy(kernel[::-1, ::-1, ::-1].copy()),
                               torch.from_numpy(bias)).numpy()
    assert np.abs(wrong - want).max() > 1e-2


@pytest.mark.parametrize("size", [16, 64])
def test_strided_block_matches_jax(size):
    """A K=3/s2 ConvBNRelu (the encoder's downsample, through the
    space-to-depth conv) against the JAX block, train mode: output and
    the moved batch statistics."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, size, 3)).astype(np.float32)
    jblock = JaxConvBNRelu(4, kernel=3, stride=2, dtype=jnp.float32)
    v = _np(jblock.init(jax.random.key(0), jnp.asarray(x), True))
    want, mutated = jblock.apply(v, jnp.asarray(x), True,
                                 mutable=["batch_stats"])
    tblock = ConvBNRelu(3, 4, 3, 2, torch.float32, "xla", plain=False)
    with torch.no_grad():
        tblock.conv.kernel.copy_(torch.from_numpy(
            v["params"]["SpaceToDepthConv_0"]["kernel"]))
        got = tblock(torch.from_numpy(x), train=True).numpy()
    assert got.shape == want.shape == (1, size // 2, size // 2, size // 2, 4)
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-5 * scale
    new = _np(mutated["batch_stats"]["BatchNorm_0"])
    np.testing.assert_allclose(tblock.mean.numpy(), new["mean"], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tblock.var.numpy(), new["var"], rtol=1e-5)


def _loss_inputs(no_foreground: bool):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 6, 6, 6, 25)) * 3).astype(np.float32)
    seg = rng.integers(1, 25, (2, 6, 6, 6)).astype(np.int8)
    seg[rng.random(seg.shape) < 0.75] = 0
    if no_foreground:
        seg[:] = 0
    return logits, seg


@pytest.mark.parametrize("no_foreground", [False, True],
                         ids=["features", "no_foreground"])
@pytest.mark.parametrize("variant", ["balanced_ce", "ce_dice", "dice"])
def test_segmentation_loss_matches_jax(variant, no_foreground):
    """Loss, metrics, and the gradient reaching the logits."""
    logits, seg = _loss_inputs(no_foreground)
    grad = jax.value_and_grad(
        lambda z, s: jax_steps.segmentation_loss(z, s, variant), has_aux=True)
    (lj, mj), gj = jax.jit(grad)(jnp.asarray(logits),
                                 jnp.asarray(seg.astype(np.int32)))
    lt_in = torch.from_numpy(logits).requires_grad_()
    lt, mt = steps.segmentation_loss(lt_in, torch.from_numpy(seg), variant)
    assert set(mt) == set(mj) == {"loss", "accuracy", "fg_accuracy"}
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]),
                                   rtol=1e-6, atol=1e-7)
    if no_foreground:
        assert float(mt["fg_accuracy"]) == 0.0
    (gt,) = torch.autograd.grad(lt, lt_in)
    gj = np.asarray(gj)
    scale = float(np.abs(gj).max())
    assert float(np.abs(gt.numpy() - gj).max()) <= 1e-6 * scale + 1e-9


def test_build_model_and_serving_forward_for_segment():
    cfg = get_config("seg64", resolution=R, seg_features=FEATURES)
    model = build_model(cfg, seed=0)
    assert isinstance(model, FeatureNetSegmenter)
    assert model.input_context == "proj_coords" and model.decoder_blocks == 2
    x = torch.from_numpy((np.random.default_rng(0).random((2, R, R, R, 1))
                          > 0.5).astype(np.float32))
    labels = serve_forward(model, x)
    assert labels.dtype == torch.int8 and tuple(labels.shape) == (2, R, R, R)
    with torch.no_grad():
        assert torch.equal(labels.long(), model(x).argmax(dim=-1))
    with pytest.raises(ValueError, match="divisible"):
        model(torch.zeros((1, 10, 10, 10, 1)))
