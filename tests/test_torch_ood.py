"""Robustness evaluation of the port against the JAX package on the CPU:
the parameter window, the perturbation families, canonicalization, the
24-pose vote and the ``evaluate_ood`` report.

The reference's voxelizer runs its numpy path throughout
(``backend="numpy"``), never its native build. Tolerances, each with its
reason:

- ``param_range`` draws, ``_family_rng``, every ``_perturb`` row of
  ``DEFAULT_LEVELS``, ``dilate``/``erode`` and ``canonicalize``'s grid are
  numpy (and the port's native parity fill, bitwise numpy's on these
  watertight meshes) on the same inputs: bitwise.
- ``estimate_canonical_rotation``: the same float64 numpy calls; held to
  1e-12 per entry.
- Probabilities: both Predictors run the same smoke16 weights (a 2-step
  JAX ``Trainer`` run exported with ``export_jax_checkpoint.py``), the
  port through the ``pallas`` lowering's plain conv, the JAX package
  through XLA. Both models are built with fp32 activations here (the
  presets serve bf16 activations, whose roundings differ between the two
  packages by ~3e-4 of a probability, ``tests/test_torch_registry.py``):
  the sums then differ by fp32 rounding, and the 24-pose mean adds them in
  the same order. Held to 1e-5.
- ``evaluate_ood``: each part's probabilities within 1e-5 of the
  reference's; a label may differ only where the two probabilities of the
  reference's top 2 are within 1e-4 of each other, and every row without
  such a flip equals the reference's (the JAX Trainer's fp32 sums on the
  CPU vary slightly from run to run, so the weights, and with them the
  smallest margin of a report, are not fixed by the seed). In that test the reference's report voxelizes
  through the port's native library, to keep the test's time: its parity
  fill is bitwise the reference's numpy fill (``tests/
  test_torch_native.py``), and every level's ``_perturb`` is held bitwise
  against the reference's numpy path above.
"""

import functools
import importlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import export_jax_checkpoint
from featurenet_tpu import ood as jax_ood
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.data import synthetic as jax_syn
from featurenet_tpu.infer import Predictor as JaxPredictor
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.runtime import registry as jax_registry
from featurenet_tpu.train.loop import Trainer as JaxTrainer
from featurenet_tpu_torch import infer, ood
from featurenet_tpu_torch.data import synthetic as syn
from featurenet_tpu_torch.data import voxelize as port_voxelize
from featurenet_tpu_torch.data.canonicalize import (
    canonicalize,
    estimate_canonical_rotation,
)
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.models.featurenet import FeatureNet
from featurenet_tpu_torch.ops.augment import CUBE_GROUP

jax_canon = importlib.import_module("featurenet_tpu.data.canonicalize")
jax_voxelize = importlib.import_module("featurenet_tpu.data.voxelize")

R = 16
PROB_ATOL = 1e-5
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _reference_numpy_voxelizer(monkeypatch):
    numpy_only = functools.partial(jax_voxelize.voxelize, backend="numpy")
    monkeypatch.setattr(jax_ood, "voxelize", numpy_only)
    monkeypatch.setattr(jax_canon, "voxelize", numpy_only)


# --- the parameter window ----------------------------------------------------

@pytest.mark.parametrize("spec", ["mid", "tails", (0.2, 0.6), None])
def test_param_range_draws_the_reference_parts(spec):
    for label in (1, 9, 20):
        a, b = np.random.default_rng(label), np.random.default_rng(label)
        got = syn.generate_sample(a, R, label=label, param_range=spec)
        want = jax_syn.generate_sample(b, R, label=label, param_range=spec)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert a.bit_generator.state == b.bit_generator.state
    batch = syn.generate_batch(np.random.default_rng(4), 5, R, param_range=spec)
    ref = jax_syn.generate_batch(np.random.default_rng(4), 5, R, param_range=spec)
    for k in ("voxels", "label", "seg"):
        np.testing.assert_array_equal(batch[k], ref[k])


def test_param_range_ambient_window_and_errors_match_the_reference():
    with syn.param_range("tails"), jax_syn.param_range("tails"):
        got = syn.generate_sample(np.random.default_rng(7), R, label=1)[0]
        want = jax_syn.generate_sample(np.random.default_rng(7), R, label=1)[0]
        forced = syn.generate_sample(np.random.default_rng(7), R, label=1,
                                     param_range=None)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, syn.generate_sample(np.random.default_rng(7), R, label=1,
                                 param_range="tails")[0])
    np.testing.assert_array_equal(
        forced, syn.generate_sample(np.random.default_rng(7), R, label=1)[0])
    assert (got != forced).any()
    lo, hi = syn.PARAM_MID
    rng = np.random.default_rng(0)
    with syn.param_range("tails"):
        vals = [syn._u(rng, 0.0, 1.0) for _ in range(200)]
    assert all(v < lo or v > hi for v in vals)
    for bad in ("mids", (0.9, 0.1), (0.1,), 3):
        with pytest.raises(ValueError) as got_err:
            syn._resolve_param_range(bad)
        with pytest.raises(ValueError) as want_err:
            jax_syn._resolve_param_range(bad)
        assert str(got_err.value) == str(want_err.value)


# --- the perturbation families ---------------------------------------------

@pytest.mark.parametrize("family,level", ood.DEFAULT_LEVELS,
                         ids=[f"{f}-{lv}" for f, lv in ood.DEFAULT_LEVELS])
def test_perturb_is_bitwise_the_reference(family, level):
    assert ood._family_rng(5, family, level).bit_generator.state == \
        jax_ood._family_rng(5, family, level).bit_generator.state
    a, b = ood._family_rng(5, family, level), jax_ood._family_rng(5, family, level)
    window = "tails" if family == "tails" else None
    c = sum(map(ord, family)) % 24
    part = syn.generate_sample(a, R, label=c, param_range=window)[0]
    want_part = jax_syn.generate_sample(b, R, label=c, param_range=window)[0]
    np.testing.assert_array_equal(part, want_part)
    got = ood._perturb(family, level, part, a)
    want = jax_ood._perturb(family, level, want_part, b)
    assert got.dtype == bool and got.any()
    np.testing.assert_array_equal(got, want)
    assert a.bit_generator.state == b.bit_generator.state
    with pytest.raises(ValueError, match="unknown OOD family"):
        ood._perturb("blur", 1.0, part, a)


def test_dilate_and_erode_are_the_reference():
    rng = np.random.default_rng(1)
    g = rng.random((R, R, R)) < 0.4
    np.testing.assert_array_equal(ood.dilate(g), jax_ood.dilate(g))
    np.testing.assert_array_equal(ood.erode(g), jax_ood.erode(g))
    box = np.zeros((12, 12, 12), bool)
    box[4:8, 4:8, 4:8] = True
    assert ood.dilate(box).sum() > box.sum() > ood.erode(box).sum()
    np.testing.assert_array_equal(ood.erode(ood.dilate(box)), box)


# --- canonicalization ---------------------------------------------------------

def test_canonicalize_is_the_reference():
    rng = np.random.default_rng(3)
    for c in (7, 12):
        part = syn.generate_sample(rng, R, label=c)[0]
        rotated = ood.rotate_part(part, rng, None)
        got = estimate_canonical_rotation(rotated)
        want = jax_canon.estimate_canonical_rotation(rotated)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(canonicalize(rotated),
                                      jax_canon.canonicalize(rotated))
    empty = np.zeros((R, R, R), bool)
    np.testing.assert_array_equal(estimate_canonical_rotation(empty), np.eye(3))
    np.testing.assert_array_equal(canonicalize(empty), empty)


def _best_cube_iou(a, b):
    best = 0.0
    for perm, flips in CUBE_GROUP:
        x = np.transpose(a, perm)
        ax = [i for i, f in enumerate(flips) if f]
        if ax:
            x = np.flip(x, ax)
        best = max(best, float((x & b).sum()) / max(float((x | b).sum()), 1))
    return best


def test_canonicalize_recovers_pose():
    """``tests/test_ood.py``'s property on the port: the canonicalized
    rotated part overlaps some cube rotation of the remeshed original near
    the double-rasterization ceiling, far better than the rotated input."""
    rng = np.random.default_rng(3)
    part = syn.generate_sample(rng, 32, label=7)[0]
    ref = ood.remesh(part.astype(bool))
    rot = ood.rotate_part(part.astype(bool), rng, None)
    can = canonicalize(rot)
    assert _best_cube_iou(can, ref) > 0.6
    assert _best_cube_iou(can, ref) > _best_cube_iou(rot, ref) + 0.15


# --- the Predictor's robust modes and the report ---------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A smoke16 JAX Trainer run of 2 steps and its export to the port,
    served there through the ``pallas`` lowering."""
    root = tmp_path_factory.mktemp("ood")
    jck, pck = str(root / "jax"), str(root / "port")
    jcfg = jax_get_config("smoke16", global_batch=8, total_steps=2,
                          eval_batches=1, eval_every=10**9, data_workers=1,
                          checkpoint_dir=jck, checkpoint_every=2, log_every=1)
    JaxTrainer(jcfg).run()
    assert export_jax_checkpoint.export(jck, pck) == 2
    path = os.path.join(pck, "config.json")
    with open(path) as fh:
        d = json.load(fh)
    d["arch"]["conv_backend"] = "pallas"
    with open(path, "w") as fh:
        json.dump(d, fh)
    return jck, pck


@pytest.fixture
def fp32_models(monkeypatch):
    """Both packages' serving models with fp32 activations. The port's
    forwards run on one CPU thread: these tests make many small forwards,
    which a team of threads only slows when other test processes share
    the cores."""
    monkeypatch.setattr(jax_registry, "build_model",
                        lambda cfg: JaxFeatureNet(arch=cfg.arch, dtype=jnp.float32))
    monkeypatch.setattr(infer, "build_model", lambda cfg: FeatureNet(
        cfg.arch, cfg.resolution, dtype=torch.float32).eval())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grids(n, seed):
    rng = np.random.default_rng(seed)
    parts = [ood.rotate_part(syn.generate_sample(rng, R, label=i % 24)[0], rng,
                             None) for i in range(n)]
    return np.stack(parts).astype(np.float32)


def test_tta_and_canonicalize_match_the_reference(checkpoints, fp32_models):
    jck, pck = checkpoints
    port = Predictor.from_checkpoint(pck, batch=8, device="cpu")
    assert port.cfg.arch.conv_backend == "pallas"
    assert port.model.dtype == torch.float32
    ref = JaxPredictor.from_checkpoint(jck, batch=8)
    g = _grids(3, 8)  # 3 parts x 24 poses = 72 rows: 9 batches of 8
    for kw in ({}, {"tta_rotations": True}, {"canonicalize": True}):
        labels, probs = port.predict_voxels(g, **kw)
        _, want = ref.predict_voxels(g, **kw)
        assert probs.shape == (3, 24) and probs.dtype == np.float32
        np.testing.assert_allclose(probs, want, rtol=0, atol=PROB_ATOL,
                                   err_msg=str(kw))
        np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
        np.testing.assert_array_equal(labels, probs.argmax(-1))
    # The vote is invariant to a cube rotation of the input.
    _, tta = port.predict_voxels(g, tta_rotations=True)
    perm, flips = CUBE_GROUP[17]
    turned = np.transpose(g, (0, *(1 + p for p in perm)))
    turned = np.flip(turned, [1 + i for i, f in enumerate(flips) if f])
    _, tta_turned = port.predict_voxels(np.ascontiguousarray(turned),
                                        tta_rotations=True)
    np.testing.assert_allclose(tta_turned, tta, rtol=0, atol=PROB_ATOL)
    empty_labels, empty = port.predict_voxels(np.zeros((0, R, R, R)),
                                              tta_rotations=True)
    assert empty_labels.shape == (0,) and empty.shape == (0, 24)


def test_evaluate_ood_gives_the_reference_rows(checkpoints, fp32_models,
                                               monkeypatch):
    """Both reports over the same five levels at one part per class: every
    part's probabilities within 1e-5 of the reference's, the same label
    except where the reference's top 2 are a near-tie (under 1e-4), and
    every row without such a flip equal to the reference's."""
    jck, pck = checkpoints
    calls = {"jax": [], "port": []}

    def recording(side, predict):
        def wrapped(self, grids, **kw):
            labels, probs = predict(self, grids, **kw)
            calls[side].append((labels, probs))
            return labels, probs
        return wrapped

    monkeypatch.setattr(JaxPredictor, "predict_voxels",
                        recording("jax", JaxPredictor.predict_voxels))
    monkeypatch.setattr(Predictor, "predict_voxels",
                        recording("port", Predictor.predict_voxels))
    monkeypatch.setattr(jax_ood, "voxelize", port_voxelize.voxelize)
    levels = [("clean", None), ("noise", 0.01), ("morph", "erode"),
              ("tails", None), ("rotation", "so3")]
    want = jax_ood.evaluate_ood(jck, per_class=1, seed=1, levels=levels, batch=16)
    got = ood.evaluate_ood(pck, per_class=1, seed=1, levels=levels, batch=16,
                           device="cpu")
    # One call per (row, class), one part each.
    assert len(calls["jax"]) == len(calls["port"]) == len(levels) * 24
    flipped_rows = set()
    for k, ((jl, jp), (pl, pp)) in enumerate(zip(calls["jax"], calls["port"])):
        np.testing.assert_allclose(pp, jp, rtol=0, atol=PROB_ATOL)
        top2 = np.sort(jp[0])[-2:]
        if pl[0] != jl[0]:
            assert top2[1] - top2[0] < NEAR_TIE, (k, top2)
            flipped_rows.add(k // 24)
    assert [r["family"] for r in got] == [f for f, _ in levels]
    assert all(r["n"] == 24 for r in got) and got[0]["delta_vs_clean"] == 0.0
    # A flip in the clean row moves every row's delta_vs_clean.
    skip = {"delta_vs_clean"} if 0 in flipped_rows else set()
    for i, (g, w) in enumerate(zip(got, want)):
        if i in flipped_rows:
            assert (g["family"], g["level"], g["n"]) == (w["family"], w["level"], w["n"])
        else:
            assert ({k: v for k, v in g.items() if k not in skip}
                    == {k: v for k, v in w.items() if k not in skip}), (g, w)
    with pytest.raises(ValueError, match="unknown OOD families"):
        ood.evaluate_ood(pck, families=["blur"], device="cpu")
