"""The segmentation oracle (``data/seg_oracle.py``) and the checkpoint
diagnosis (``train/seg_diagnose.py``), the port against the JAX package's
on the CPU.

Tolerances, each with its reason:

- ``measure_ceiling`` and the diagnosis's helpers (``_families``,
  ``_mean_iou_from_confusion``, ``_collapse``, ``_accumulate_iou``): the
  same numpy calls on the same draws: equal;
- ``diagnose``: a JAX segment checkpoint exported into the port with
  ``export_jax_checkpoint.py``, both segmenters computing in fp32, so
  logits agree to ~1e-6 and a predicted label may differ only at a voxel
  whose reference top-2 logits are within 1e-4 (a near-tie). The two
  confusion matrices differ by at most one count moved per such voxel,
  ``mean_iou`` is within 1e-3, and with equal matrices the reports are
  equal.

Sizes: R=16, ``seg_features=(4, 8)``, a 24-part cache (its held-out split
5 parts).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import export_jax_checkpoint
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.data import seg_oracle as jax_oracle
from featurenet_tpu.runtime import registry as jax_registry
from featurenet_tpu.train import loop as jax_loop
from featurenet_tpu.train import seg_diagnose as jax_diag
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train import state as jax_state
from featurenet_tpu.train.checkpoint import CheckpointManager as JaxManager
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import runtime
from featurenet_tpu_torch.data import offline, seg_oracle
from featurenet_tpu_torch.models.segmenter import FeatureNetSegmenter
from featurenet_tpu_torch.train import seg_diagnose

R = 16
FEATURES = (4, 8)
NEAR_TIE = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("resolution,features,samples", [(16, 3, 6), (16, 2, 4),
                                                         (64, 3, 1)])
def test_measure_ceiling_is_the_reference(resolution, features, samples):
    got = seg_oracle.measure_ceiling(resolution, features, samples=samples, seed=2)
    want = jax_oracle.measure_ceiling(resolution, features, samples=samples, seed=2)
    assert got == want
    assert ("overlap_error_share_at_0889" in got) == (resolution == 64)


def test_oracle_main_prints_the_ceiling(capsys):
    seg_oracle.main(["--resolution", "16", "--samples", "2", "--seed", "1"])
    got = json.loads(capsys.readouterr().out)
    assert got == jax_oracle.measure_ceiling(16, 3, samples=2, seed=1)


def _confusions(seed):
    rng = np.random.default_rng(seed)
    conf = rng.integers(0, 50, (25, 25)) * (rng.random((25, 25)) < 0.3)
    conf[np.arange(25), np.arange(25)] += rng.integers(50, 400, 25)
    conf[3, 9] = conf[9, 3] = 300  # one family of two
    conf[4, 12] = conf[12, 17] = 500  # and one of three
    return conf.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_diagnosis_helpers_are_the_reference(seed):
    conf = _confusions(seed)
    for threshold in (0.05, 0.1, 0.3):
        fams = seg_diagnose._families(conf, threshold)
        assert fams == jax_diag._families(conf, threshold)
        got = seg_diagnose._collapse(conf, fams)
        np.testing.assert_array_equal(got, jax_diag._collapse(conf, fams))
        assert got.sum() == conf.sum()
    assert [3, 9] in seg_diagnose._families(conf, 0.3)
    miou, iou = seg_diagnose._mean_iou_from_confusion(conf)
    wmiou, wiou = jax_diag._mean_iou_from_confusion(conf)
    assert miou == wmiou
    np.testing.assert_array_equal(iou, wiou)
    rng = np.random.default_rng(seed)
    t, p = rng.integers(0, 25, (2, 300))
    got = [np.zeros(25, np.int64) for _ in range(2)]
    want = [np.zeros(25, np.int64) for _ in range(2)]
    seg_oracle._accumulate_iou(*got, t, p, 25)
    jax_oracle._accumulate_iou(*want, t, p, 25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert seg_oracle._mean_iou(*got)[0] == jax_oracle._mean_iou(*want)[0]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A JAX segment checkpoint (seeded weights, non-trivial batch-norm
    statistics), its export to the port, and a segmentation cache."""
    root = tmp_path_factory.mktemp("segdiag")
    jck, pck, cache = str(root / "jax"), str(root / "port"), str(root / "cache")
    jcfg = jax_get_config("seg64", resolution=R, seg_features=FEATURES,
                          global_batch=4, checkpoint_dir=jck)
    # Jitted: one compile of the init, not one per op (the same values).
    state = jax.jit(functools.partial(
        jax_create_state, jax_registry.build_model(jcfg),
        jax_steps.make_optimizer(jcfg)))(jnp.zeros((1, R, R, R, 1)),
                                         jax.random.key(3))
    rng = np.random.default_rng(3)
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
    offline.export_seg_cache(cache, num_parts=24, resolution=R, shard_size=10,
                             seed=1)
    return jck, pck, cache


def _compiled_create_state(model, tx, sample, rng, precision="fp32"):
    return jax.jit(functools.partial(jax_create_state, model, tx,
                                     precision=precision))(jnp.asarray(sample), rng)


@pytest.fixture
def fp32_segmenters(monkeypatch):
    build = jax_registry.build_model
    monkeypatch.setattr(jax_loop, "build_model",
                        lambda cfg: build(cfg).clone(dtype=jnp.float32))
    # The reference's restore template (every value of it overwritten by
    # the restore) in one compile, not one per op.
    monkeypatch.setattr(jax_state, "create_state", _compiled_create_state)
    monkeypatch.setattr(runtime, "build_model", lambda cfg: FeatureNetSegmenter(
        cfg.seg_features, dtype=torch.float32, input_context=cfg.seg_input_context,
        decoder_blocks=cfg.seg_decoder_blocks,
        bottleneck_blocks=cfg.seg_bottleneck_blocks).eval())


def test_diagnose_matches_the_reference(run, fp32_segmenters, monkeypatch):
    jck, pck, cache = run
    confs = {}

    def recording(side, fn):
        def wrapped(conf):
            confs.setdefault(side, conf.copy())
            return fn(conf)
        return wrapped

    monkeypatch.setattr(jax_diag, "_mean_iou_from_confusion",
                        recording("jax", jax_diag._mean_iou_from_confusion))
    monkeypatch.setattr(seg_diagnose, "_mean_iou_from_confusion",
                        recording("port", seg_diagnose._mean_iou_from_confusion))
    want = jax_diag.diagnose(jck, cache, threshold=0.1, batch=4)
    got = seg_diagnose.diagnose(pck, cache, threshold=0.1, batch=4, device="cpu")
    test = offline.SegCacheDataset(cache, global_batch=4, split="test")
    assert got["voxels"] == confs["port"].sum() == confs["jax"].sum() == \
        len(test.rows) * R ** 3
    moved = int(np.abs(confs["port"] - confs["jax"]).sum()) // 2
    if moved:
        # Count the reference's near-ties over the split.
        cfg = jax_get_config("seg64", resolution=R, seg_features=FEATURES)
        model = jax_registry.build_model(cfg).clone(dtype=jnp.float32)
        template = jax_create_state(model, jax_steps.make_optimizer(cfg),
                                    jnp.zeros((1, R, R, R, 1)), jax.random.key(0))
        mgr = JaxManager(jck)
        state = mgr.restore(template)
        mgr.close()
        ties = 0
        for b in test.epoch_batches(4):
            logits = np.asarray(model.apply(
                {"params": state.params, "batch_stats": state.batch_stats},
                jax_steps.unpack_voxels(jnp.asarray(b["voxels"])), train=False))
            top2 = np.sort(logits, axis=-1)[..., -2:]
            ties += int(((top2[..., 1] - top2[..., 0]) < NEAR_TIE)[b["mask"] > 0].sum())
        assert moved <= ties
    print(f"diagnose: {moved} voxel counts moved between the matrices")
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-3
    if not moved:
        assert {k: v for k, v in got.items() if k not in ("checkpoint", "voxels")} == \
            {k: v for k, v in want.items() if k != "checkpoint"}
    assert len(got["per_class_iou"]) == 25 and got["confusion_threshold"] == 0.1


def test_diagnose_refuses_and_its_main_prints(run, tmp_path, capsys):
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    _, pck, cache = run
    seg_diagnose.main(["--checkpoint-dir", pck, "--data-cache", cache,
                       "--batch", "4", "--device", "cpu", "--threshold", "0.2"])
    rec = json.loads(capsys.readouterr().out)
    assert rec["checkpoint"] == pck and rec["confusion_threshold"] == 0.2
    cfg = get_config("smoke16")
    ck = str(tmp_path / "cls")
    mgr = CheckpointManager(ck, config=cfg)
    mgr.save(create_state(build_model(cfg, seed=0), cfg))
    mgr.close()
    for bad in (ck, str(tmp_path / "none")):
        with pytest.raises(SystemExit, match="needs a segment checkpoint"):
            seg_diagnose.diagnose(bad, cache, device="cpu")
