"""The port's serving programs on the CPU (``runtime/registry.py``): the
program names against the JAX registry's, one memoized program per bucket
and per weight generation, the service's warmup building exactly its
buckets (the largest first), and each precision's program against the JAX
``Predictor`` on the same weights and inputs.

On the CPU a program is the eager forward (the card captures it as a CUDA
graph, ``tests/test_torch_cuda.py``), so its probabilities are the eager
forward's bitwise. Against JAX, both sides compute in bf16 activations
(and in the reduced rung's weights), so probabilities are held to 2e-2:
a few bf16 ulps of logits, scaled by the softmax's slope (< 1/4), and at
int8 a quantized weight on either side of a rounding boundary of the bf16
cast that follows.
"""

import jax
import numpy as np
import pytest
import torch

from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.infer import Predictor as JaxPredictor
from featurenet_tpu.runtime import Runtime
from featurenet_tpu.runtime.registry import serve_program_name as jax_program_name
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.data import synthetic
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.runtime import registry
from featurenet_tpu_torch.serve.service import InferenceService
from featurenet_tpu_torch.train.precision import SERVE_PRECISIONS

R = 16


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


@pytest.fixture(scope="module")
def weights():
    """smoke16 from the JAX init at key 0: the JAX variables and the port
    state_dict bridged from them."""
    jcfg = jax_get_config("smoke16")
    jstate = Runtime(jcfg, cache=None).build("init")(jax.random.key(0))
    v = _np({"params": jstate.params, "batch_stats": jstate.batch_stats})
    cfg = get_config("smoke16")
    return jcfg, v, cfg, convert.from_flax(v, cfg.arch)


def _grids(n, seed=3):
    return synthetic.generate_batch(np.random.default_rng(seed), n, R)["voxels"]


@pytest.mark.parametrize("precision", SERVE_PRECISIONS)
def test_serve_program_name_is_the_reference_mapping(precision):
    assert registry.serve_program_name(precision) == jax_program_name(precision)


def test_serve_program_name_refuses_an_unknown_precision():
    with pytest.raises(ValueError, match="unknown serving precision"):
        registry.serve_program_name("fp8")


def test_program_for_memoizes_one_program_per_bucket(weights):
    _, _, cfg, state = weights
    pred = Predictor(state, cfg, batch=4, device="cpu")
    p4, p1 = pred.program_for(4), pred.program_for(1)
    assert pred.program_for(4) is p4 and pred.program_for(1) is p1
    assert p4 is not p1 and (p4.batch, p1.batch) == (4, 1)
    assert p4.name == "serve" and p4.shape == (4, R, R, R, 1)
    assert p4.graph is None  # the CPU runs the eager forward
    assert pred._weights.programs.batches() == [1, 4]
    with pytest.raises(ValueError, match="batch must be >= 1"):
        pred.program_for(0)
    with pytest.raises(ValueError, match="input"):
        p4(torch.zeros((2, R, R, R, 1)))


def test_service_warms_exactly_its_buckets_largest_first(weights):
    _, _, cfg, state = weights
    pred = Predictor(state, cfg, batch=4, device="cpu")
    built, program_for = [], pred.program_for
    pred.program_for = lambda b: built.append(b) or program_for(b)
    service = InferenceService(pred, buckets=(4, 1, 2), max_wait_ms=1)
    try:
        assert built == [4, 2, 1]
        assert pred._weights.programs.batches() == [1, 2, 4]
        assert service.ready()
        out = service.predict(service.submit_voxels(_grids(1)[0]), timeout=30)
        assert set(out) == {"label", "class_name", "prob", "top3"}
        assert pred._weights.programs.batches() == [1, 2, 4]
    finally:
        assert service.drain()["exit_code"] == 0


@pytest.mark.parametrize("precision", SERVE_PRECISIONS)
def test_program_is_the_eager_forward_and_matches_jax(weights, precision):
    """Each precision's program at batch 4 (bf16's resident working copy
    through ``functional_call``, int8's dequantize inside the body) gives
    the eager forward's probabilities bitwise on the CPU, and the JAX
    Predictor's at the same precision within 2e-2 (module docstring)."""
    jcfg, v, cfg, state = weights
    pred = Predictor(state, cfg, batch=4, device="cpu", precision=precision)
    x = _grids(4)
    prog = pred.program_for(4)
    assert prog.name == registry.serve_program_name(precision)
    got = prog(torch.from_numpy(x))
    with torch.inference_mode():
        assert torch.equal(got, pred.forward_eager(torch.from_numpy(x)))
    jpred = JaxPredictor(v["params"], v["batch_stats"], jcfg, batch=4,
                         precision=precision)
    want = np.asarray(jpred.forward_padded(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2)
    np.testing.assert_allclose(pred.forward_padded(x, batch=4), want, atol=2e-2)
    assert pred.replays == 0  # replays count graphs, which the CPU has none of
