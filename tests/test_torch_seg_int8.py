"""int8 serving of a segmenter, the port against the JAX package, on the
CPU: the quantized tree, the int8 Predictor's per-voxel labels, the
per-voxel ``agreement`` and ``cli programs --warm``.

Inputs come from numpy seeds and a JAX segmenter init bridged into the
port (``convert.from_flax``). Tolerances, each with its reason:

- the quantizer does the same elementwise fp32 arithmetic and the same
  round-half-to-even on the same values: bitwise, key by key;
- labels: both Predictors compute the segmenter in bf16 (seg64's policy),
  where XLA and PyTorch round some sums apart, so logits agree to 2e-2
  (``tests/test_torch_segmenter.py``'s bf16 tolerance). A label may
  therefore differ only at a voxel whose reference top-2 logits are
  within twice that (4e-2), a near-tie; everywhere else it is equal;
- ``agreement`` is a share of voxels whose two argmaxes may each flip at
  such near-ties: within 1e-3 of the reference's.

Sizes: R=16, ``seg_features=(4, 8)``, ``proj_coords``, 2 decoder blocks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.infer import Predictor as JaxPredictor
from featurenet_tpu.models.segmenter import FeatureNetSegmenter as JaxSegmenter
from featurenet_tpu.runtime import quantize as jax_quantize
from featurenet_tpu.train import precision as jax_precision
from featurenet_tpu_torch import cli, convert
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.runtime import quantize
from featurenet_tpu_torch.runtime import build_model

R = 16
FEATURES = (4, 8)
SEG = dict(resolution=R, seg_features=FEATURES, global_batch=4)
LOGIT_TOL = 2e-2
NEAR_TIE = 2 * LOGIT_TOL


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _jax_segmenter(seed: int):
    """seg64's segmenter at narrow widths (bf16 compute), its variables
    with non-trivial batch-norm statistics and affine."""
    jmodel = JaxSegmenter(features=FEATURES, input_context="proj_coords",
                          decoder_blocks=2)
    init = jax.jit(lambda key: jmodel.init({"params": key},
                                           jnp.zeros((1, R, R, R, 1)), train=False))
    v = _np(init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    for scope in v["batch_stats"].values():
        bn = scope["BatchNorm_0"]
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    for name, scope in v["params"].items():
        if name.startswith("ConvBNRelu_"):
            bn = scope["BatchNorm_0"]
            bn["scale"] = rng.uniform(0.5, 1.5, bn["scale"].shape).astype(np.float32)
            bn["bias"] = rng.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
    return jmodel, v


def _grids(n, seed):
    return (np.random.default_rng(seed).random((n, R, R, R)) > 0.5).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 5])
def test_quantized_segmenter_tree_is_bitwise_jax(seed):
    _, v = _jax_segmenter(seed)
    masters = convert.from_flax(v)
    params = {k: t for k, t in masters.items()
              if not k.endswith((".mean", ".var"))}
    # The segmenter has no dense weight: every rank >= 2 tensor is a
    # [K,K,K,Cin,Cout] kernel, quantized on its trailing axis as in Flax.
    assert not [k for k, t in params.items() if t.dim() == 2]
    weights = [k for k, t in params.items() if t.dim() >= 2]
    assert all(params[k].dim() == 5 for k in weights) and len(weights) == 12
    # Eager, as the reference's Predictor quantizes (under jit XLA turns
    # amax / 127 into a multiply by its reciprocal, an ulp apart).
    jq, js = jax_quantize.quantize_tree(jax.tree_util.tree_map(jnp.asarray,
                                                               v["params"]))
    q, s = quantize.quantize_tree(params)
    want_q = convert._from_params(_np(jq), None)
    want_s = convert._from_params(_np(js), None)
    assert set(q) == set(want_q) == set(params)
    for k, x in params.items():
        if k in weights:
            assert q[k].dtype == torch.int8 and s[k].dtype == torch.float32, k
            assert torch.equal(q[k].float(), want_q[k]), k
            assert tuple(s[k].shape) == (1, 1, 1, 1, x.shape[-1]), k
            assert torch.equal(s[k].reshape(-1), want_s[k].reshape(-1)), k
        else:
            assert q[k] is x and float(s[k]) == 1.0, k
    want = convert._from_params(_np(jax_quantize.dequantize_tree(jq, js)), None)
    deq = quantize.dequantize_tree(q, s)
    for k in params:
        assert torch.equal(deq[k], want[k]), k


@pytest.fixture(scope="module")
def bridged():
    """One JAX segmenter's int8 Predictor and the port's of the same
    weights (each JAX program compiles once for the module)."""
    jmodel, v = _jax_segmenter(0)
    jcfg = jax_get_config("seg64", serve_precision="int8", **SEG)
    jpred = JaxPredictor(jax.tree_util.tree_map(jnp.asarray, v["params"]),
                         jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                         jcfg, batch=4)
    cfg = get_config("seg64", serve_precision="int8", **SEG)
    pred = Predictor(convert.from_flax(v), cfg, batch=4, device="cpu")
    return jmodel, v, jpred, pred


@pytest.mark.parametrize("seed", [0, 3])
def test_int8_segment_predictor_labels_match_jax(bridged, seed):
    jmodel, v, jpred, pred = bridged
    assert pred.precision == jpred.precision == "int8"
    grids = _grids(6, seed + 1)
    got = pred.predict_voxels_seg(grids)
    want = jpred.predict_voxels_seg(grids)
    assert got.dtype == want.dtype == np.int8 and got.shape == (6, R, R, R)
    forward = jax.jit(lambda p, stats, x: jmodel.apply(
        {"params": jax_precision.serve_params_cast(p, "int8"),
         "batch_stats": stats}, x, train=False))
    logits = np.asarray(forward(jax.tree_util.tree_map(jnp.asarray, v["params"]),
                                v["batch_stats"], jnp.asarray(grids[..., None])),
                        np.float32)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    flips = got != want
    print(f"int8 labels: {int(flips.sum())} of {flips.size} voxels differ, "
          f"all near-ties (gap < {NEAR_TIE})")
    assert np.all(gap[flips] < NEAR_TIE)
    assert flips.mean() < 1e-2
    # The int8 Predictor holds int8 kernels and scales, its module's
    # parameters are placeholders, and its fp32 masters stay on the host.
    assert all(t.dtype == torch.int8 for k, t in pred._qparams.items()
               if k.endswith("kernel"))
    assert all(t.is_meta for t in pred.model.parameters())
    assert all(t.device.type == "cpu" for t in pred._masters.values())


class _Compiled:
    """A Flax module's ``apply`` compiled once (the reference's
    ``agreement`` applies its model eagerly, one compile per op)."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply, static_argnames=("train",))


def test_int8_segment_agreement_matches_jax(bridged, monkeypatch):
    jmodel, _, jpred, pred = bridged
    monkeypatch.setattr(jpred, "model", _Compiled(jmodel))
    got, want = pred.agreement(n=8, seed=4), jpred.agreement(n=8, seed=4)
    print(f"per-voxel agreement int8 vs fp32: port {got}, reference {want}")
    assert abs(got - want) <= 1e-3
    assert 0.5 < got <= 1.0
    assert pred.int8_agreement(n=8, seed=4) == got


def test_segment_int8_serves_from_a_checkpoint_and_swaps(tmp_path):
    """The int8 Predictor of a segment checkpoint labels as its own eager
    dequantized forward does, and a swap keeps it int8."""
    from featurenet_tpu_torch.runtime import forward_with
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    cfg = get_config("seg64", **SEG)
    cks = []
    for seed in (1, 2):
        ck = str(tmp_path / f"ck{seed}")
        mgr = CheckpointManager(ck, config=cfg)
        mgr.save(create_state(build_model(cfg, seed=seed), cfg))
        mgr.close()
        cks.append(ck)
    pred = Predictor.from_checkpoint(cks[0], batch=4, device="cpu",
                                     precision="int8")
    grids = _grids(3, 7)
    labels = pred.predict_voxels_seg(grids)
    with torch.inference_mode():
        want = forward_with(pred.model, pred._dispatch_params(),
                            torch.from_numpy(grids[..., None])).argmax(-1)
    np.testing.assert_array_equal(labels, want.to(torch.int8).numpy())
    full = Predictor.from_checkpoint(cks[0], batch=4, device="cpu")
    assert pred.resident_weight_bytes < full.resident_weight_bytes / 3
    pred.swap_params(cks[1])
    assert pred.precision == "int8" and pred.model_version != full.model_version
    assert pred.predict_voxels_seg(grids).shape == (3, R, R, R)


def test_cli_programs_warm_builds_serve_int8_for_a_segmenter(capsys):
    assert cli.main(["programs", "--config", "seg64", "--warm",
                     "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    warm = lines[-1]["warmup"]
    for name in ("serve", "serve_bf16", "serve_int8"):
        assert warm[name]["source"] == "eager" and warm[name]["precision"] == \
            name.split("_")[-1].replace("serve", "fp32"), (name, warm[name])
    assert not [n for n in warm if n.startswith("serve_packed")]
    rows = {r["program"]: r for r in lines[:-1]}
    assert rows["serve_int8"]["applicable"] and not rows["serve_packed_int8"]["applicable"]
