"""The segmentation robustness report (``ood.py``'s ``evaluate_ood_seg``
and its helpers) and ``cli eval-ood`` on a segment checkpoint, the port
against the JAX package's ``featurenet_tpu/ood.py`` on the CPU.

Tolerances, each with its reason:

- ``_trilinear``, ``affine_resample_pair`` and every ``SEG_DEFAULT_LEVELS``
  row of ``_perturb_seg``: the same numpy calls on the same float64 values
  and draws: bitwise;
- the report: a JAX segment checkpoint exported into the port with
  ``export_jax_checkpoint.py``, both segmenters computing in fp32 (as
  ``tests/test_torch_ood.py`` holds the classify report), so logits agree
  to ~1e-6. Each part's labels are equal except at voxels whose
  reference top-2 logits are within 1e-4 (a near-tie), and every row
  without such a flip is equal to the reference's row.

Sizes: R=16, ``seg_features=(4, 8)``, 3 parts a row.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import export_jax_checkpoint
from featurenet_tpu import ood as jax_ood
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.data import offline as jax_offline
from featurenet_tpu.infer import Predictor as JaxPredictor
from featurenet_tpu.models.segmenter import FeatureNetSegmenter as JaxSegmenter
from featurenet_tpu.runtime import registry as jax_registry
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train import state as jax_state
from featurenet_tpu.train.checkpoint import CheckpointManager as JaxManager
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import cli, infer, ood
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.models.segmenter import FeatureNetSegmenter

R = 16
FEATURES = (4, 8)
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the host perturbations ----------------------------------------------------

def _seg_part(seed):
    return jax_offline._generate_seg_sample(np.random.default_rng(seed), R, 3,
                                            "canonical")


def test_trilinear_and_resample_pair_are_bitwise_the_reference():
    part, seg = _seg_part(2)
    rng = np.random.default_rng(0)
    src = rng.uniform(-2, R + 1, (3, 500))
    vol = rng.random((R, R, R)).astype(np.float32)
    np.testing.assert_array_equal(ood._trilinear(vol, src),
                                  jax_ood._trilinear(vol, src))
    rot = ood.random_rotation_matrix(np.random.default_rng(3), 30.0)
    for kw in ({}, {"rot": rot, "scale": 0.7}, {"scale": 1.1}):
        got = ood.affine_resample_pair(part, seg, **kw)
        want = jax_ood.affine_resample_pair(part, seg, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    v, s = ood.affine_resample_pair(part, None, rot, 0.7)
    assert s is None
    np.testing.assert_array_equal(v, jax_ood.affine_resample_pair(part, None, rot, 0.7)[0])
    assert ood.SEG_DEFAULT_LEVELS == jax_ood.SEG_DEFAULT_LEVELS
    assert ood.ROTATION_PRESCALE == jax_ood.ROTATION_PRESCALE


@pytest.mark.parametrize("family,level", ood.SEG_DEFAULT_LEVELS)
def test_perturb_seg_is_bitwise_the_reference(family, level):
    part, seg = _seg_part(5)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    got = ood._perturb_seg(family, level, part.astype(bool), seg, a)
    want = jax_ood._perturb_seg(family, level, part.astype(bool), seg, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert a.random() == b.random()  # the same draws taken


def test_rotation_control_annotation_is_the_reference():
    rows = [{"family": "clean", "level": None, "mean_iou": 0.5},
            {"family": "rotation", "level": 5.0, "mean_iou": 0.3},
            {"family": "scale", "level": 0.7, "mean_iou": 0.4}]
    want = jax_ood._annotate_rotation_control(
        jax_ood._annotate_delta([dict(r) for r in rows], "mean_iou"), "mean_iou")
    got = ood._annotate_rotation_control(
        ood._annotate_delta([dict(r) for r in rows], "mean_iou"), "mean_iou")
    assert got == want and got[1]["delta_vs_scale_control"] == -0.1
    assert ood._annotate_rotation_control(rows[:2], "mean_iou") == rows[:2]


# --- the report ------------------------------------------------------------------

def make_jax_seg_checkpoint(root, seed: int = 0):
    """A JAX segment checkpoint (seeded weights, batch-norm statistics and
    affine made non-trivial) and its export to the port."""
    jck, pck = str(root / "jax"), str(root / "port")
    jcfg = jax_get_config("seg64", resolution=R, seg_features=FEATURES,
                          global_batch=4, checkpoint_dir=jck)
    # Jitted: one compile of the init, not one per op (the same values).
    state = jax.jit(functools.partial(
        jax_create_state, jax_registry.build_model(jcfg),
        jax_steps.make_optimizer(jcfg)))(jnp.zeros((1, R, R, R, 1)),
                                         jax.random.key(seed))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(state.batch_stats))
    for scope in stats.values():
        bn = scope["BatchNorm_0"]
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    state = state.replace(batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    mgr = JaxManager(jck, config=jcfg)
    mgr.save(state)
    mgr.close()
    assert export_jax_checkpoint.export(jck, pck) == 0
    return jck, pck


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    return make_jax_seg_checkpoint(tmp_path_factory.mktemp("segood"))


def _compiled_create_state(model, tx, sample, rng, precision="fp32"):
    return jax.jit(functools.partial(jax_create_state, model, tx,
                                     precision=precision))(jnp.asarray(sample), rng)


@pytest.fixture
def fp32_segmenters(monkeypatch):
    """Both packages' segmenters with fp32 activations."""
    build = jax_registry.build_model
    monkeypatch.setattr(jax_registry, "build_model",
                        lambda cfg: build(cfg).clone(dtype=jnp.float32))
    # The reference's restore template (every value of it overwritten by
    # the restore) in one compile, not one per op.
    monkeypatch.setattr(jax_state, "create_state", _compiled_create_state)
    monkeypatch.setattr(infer, "build_model", lambda cfg: FeatureNetSegmenter(
        cfg.seg_features, dtype=torch.float32, input_context=cfg.seg_input_context,
        decoder_blocks=cfg.seg_decoder_blocks,
        bottleneck_blocks=cfg.seg_bottleneck_blocks).eval())


def test_evaluate_ood_seg_gives_the_reference_rows(checkpoints, fp32_segmenters,
                                                   monkeypatch):
    jck, pck = checkpoints
    calls = {"jax": [], "port": []}

    def recording(side, predict):
        def wrapped(self, grids):
            labels = predict(self, grids)
            calls[side].append((self, grids, labels))
            return labels
        return wrapped

    monkeypatch.setattr(JaxPredictor, "predict_voxels_seg",
                        recording("jax", JaxPredictor.predict_voxels_seg))
    monkeypatch.setattr(Predictor, "predict_voxels_seg",
                        recording("port", Predictor.predict_voxels_seg))
    levels = [("clean", None), ("rotation", 15.0), ("noise", 0.01),
              ("morph", "erode"), ("tails", None)]
    kw = dict(parts=3, seed=1, levels=levels, batch=4)
    want = jax_ood.evaluate_ood_seg(jck, **kw)
    got = ood.evaluate_ood_seg(pck, device="cpu", **kw)
    # The scale-0.7 control row follows a rotation row: one call a row.
    assert len(calls["jax"]) == len(calls["port"]) == len(levels) + 1
    assert [(r["family"], r["level"]) for r in got] == \
        levels + [("scale", ood.ROTATION_PRESCALE)]
    flipped, voxels = set(), 0
    for k, ((jp, jg, jl), (_, pg, pl)) in enumerate(zip(calls["jax"], calls["port"])):
        np.testing.assert_array_equal(pg, jg)  # the same perturbed inputs
        assert pl.dtype == np.int8 and pl.shape == jl.shape
        diff = pl != jl
        if diff.any():
            logits = np.asarray(jp.model.apply(
                {"params": jp._params, "batch_stats": jp._stats},
                jnp.asarray(jg[..., None]), train=False))
            top2 = np.sort(logits, axis=-1)[..., -2:]
            assert np.all((top2[..., 1] - top2[..., 0])[diff] < NEAR_TIE), k
            flipped.add(k)
            voxels += int(diff.sum())
    print(f"seg report: {voxels} near-tie voxels differ, rows {sorted(flipped)}")
    skip = {"delta_vs_clean", "delta_vs_scale_control"} if flipped else set()
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g["family"], g["level"], g["n"]) == (w["family"], w["level"], w["n"])
        if i not in flipped:
            assert ({k: v for k, v in g.items() if k not in skip}
                    == {k: v for k, v in w.items() if k not in skip}), (g, w)
    assert got[0]["delta_vs_clean"] == 0.0
    assert "delta_vs_scale_control" in got[1]
    with pytest.raises(ValueError, match="unknown seg OOD families"):
        ood.evaluate_ood_seg(pck, families=["blur"], device="cpu")


def test_cli_eval_ood_on_a_segment_checkpoint(checkpoints, tmp_path, capsys):
    _, pck = checkpoints
    out = str(tmp_path / "rows.json")
    assert cli.main(["eval-ood", "--checkpoint-dir", pck, "--device", "cpu",
                     "--seg-parts", "2", "--families", "rotation",
                     "--seed", "3", "--out", out]) == 0
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    with open(out) as fh:
        assert json.load(fh) == printed
    assert [(r["family"], r["level"]) for r in printed] == [
        ("clean", None), ("rotation", 5.0), ("rotation", 15.0), ("rotation", 45.0),
        ("rotation", "so3"), ("scale", 0.7)]
    assert all(r["n"] == 2 for r in printed)
    assert all("delta_vs_scale_control" in r for r in printed[1:5])
    assert printed == ood.evaluate_ood_seg(pck, parts=2, seed=3,
                                           families=["rotation"], device="cpu")
    for flag in ("--tta", "--canonicalize"):
        with pytest.raises(SystemExit, match="classify-only"):
            cli.main(["eval-ood", "--checkpoint-dir", pck, "--device", "cpu", flag])
    with pytest.raises(ValueError, match="segment checkpoints"):
        _classify_refused(tmp_path)


def _classify_refused(tmp_path):
    """``evaluate_ood_seg`` on a classify checkpoint raises."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    cfg = get_config("smoke16")
    ck = str(tmp_path / "cls")
    mgr = CheckpointManager(ck, config=cfg)
    mgr.save(create_state(build_model(cfg, seed=0), cfg))
    mgr.close()
    ood.evaluate_ood_seg(ck, parts=1, device="cpu")


def test_ood_main_prints_the_classify_rows(tmp_path, capsys, monkeypatch):
    """``python -m featurenet_tpu_torch.ood``: the reference module's entry
    point, the classify report's rows as JSON lines and ``--out``, its
    flags handed to ``evaluate_ood`` (the report itself is held by
    ``tests/test_torch_ood.py``)."""
    seen = {}
    rows = [{"family": "clean", "level": None, "accuracy": 0.5},
            {"family": "noise", "level": 0.01, "accuracy": 0.25}]

    def report(checkpoint_dir, **kw):
        seen.update(kw, checkpoint_dir=checkpoint_dir)
        return rows

    monkeypatch.setattr(ood, "evaluate_ood", report)
    out = str(tmp_path / "rows.json")
    ood.main(["--checkpoint-dir", "CK", "--per-class", "3", "--families",
              "noise,morph", "--seed", "5", "--device", "cpu", "--out", out])
    assert seen == {"checkpoint_dir": "CK", "per_class": 3, "seed": 5,
                    "families": ["noise", "morph"], "device": "cpu"}
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    with open(out) as fh:
        assert json.load(fh) == printed == rows
