"""The paired affine warp of a segment batch (``ops/augment.py``
``affine_warp_pair``) and the segment train step that warps, the port
against the JAX package's ``random_affine_batch_paired`` and
``make_train_step(task="segment", augment_affine=True)`` on the CPU.

The port is handed the draws the reference makes from its key. Tolerances,
each with its reason:

- voxels: within 1e-5 absolute, as ``tests/test_torch_augment.py`` holds
  the classify warp (fp32 source coordinates an fp32 rounding apart, the
  8 trilinear terms weighted from them, the port's in float64);
- labels: order 0, the nearest source voxel, halves away from zero on
  both sides. The port computes each source coordinate as a sum of three
  products, the reference as a matrix product, so the two can round a
  coordinate to different fp32 neighbours; a label can then differ only
  where that coordinate lies on a half-integer, so labels are equal
  everywhere except voxels whose reference coordinate is within 1e-4 of
  a half-integer on some axis (counted and printed). Where the
  coordinates are exact (no rotation, scale 0.5), every label is equal,
  halves included;
- groups whose take flag is false: bitwise, voxels and labels;
- the train steps: ``tests/test_torch_seg_train.py``'s tolerances (loss
  1e-5 relative, gradient norm 1e-4, batch-norm statistics 1e-4 of each
  leaf's scale, parameters within 2·lr per moving step with 99 % of
  entries within 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.config import Config as JaxConfig
from featurenet_tpu.models.segmenter import FeatureNetSegmenter as JaxSegmenter
from featurenet_tpu.ops import augment as jax_augment
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import Config, get_config
from featurenet_tpu_torch.data import offline, synthetic
from featurenet_tpu_torch.models.segmenter import FeatureNetSegmenter
from featurenet_tpu_torch.ops import augment
from featurenet_tpu_torch.train import steps
from featurenet_tpu_torch.train.loop import Trainer
from featurenet_tpu_torch.train.state import create_state

R = 16
FEATURES = (4, 8)
SHAPE = (5, 6, 7)  # non-cubic: swapped axes would show
NEAR_HALF = 1e-4
AFFINE = dict(scale_range=(0.7, 1.05), rotate=True, translate_vox=1.0,
              prob=1.0, ramp_steps=2)
NOISE = 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _reference_draw(key, b, groups, prob, scale_range, rotate, translate,
                    shape=SHAPE):
    """The draws ``random_affine_batch_paired`` makes from ``key`` as the
    port's ``AffineDraw``, and per group the reference's own source
    coordinates ``[3, D·H·W]`` (its matrix, its matrix product)."""
    n = augment.group_count(b, groups)
    lo, hi = scale_range
    D, H, W = shape
    c = jnp.array([(D - 1) / 2.0, (H - 1) / 2.0, (W - 1) / 2.0])
    grid = jnp.stack(jnp.meshgrid(jnp.arange(D, dtype=jnp.float32),
                                  jnp.arange(H, dtype=jnp.float32),
                                  jnp.arange(W, dtype=jnp.float32),
                                  indexing="ij")).reshape(3, -1)
    rots, scales, trans, takes, srcs = [], [], [], [], []
    for k in jax.random.split(key, n):
        kc, kp = jax.random.split(k)
        kq, ks, kt = jax.random.split(kc, 3)
        s = jax.random.uniform(ks, (), minval=lo, maxval=hi)
        t = (jax.random.uniform(kt, (3,), minval=-translate, maxval=translate)
             if translate > 0.0 else jnp.zeros(3))
        q = jax.random.normal(kq, (4,))
        shifted = (grid - (c + t)[:, None]) / s
        if rotate:
            shifted = jax_augment._quat_to_matrix(q).T @ shifted
        srcs.append(np.asarray(shifted + c[:, None]))
        scales.append(np.asarray(s))
        trans.append(np.asarray(t, np.float32))
        rots.append(augment.quat_to_matrix(torch.from_numpy(np.array(q)))
                    if rotate else torch.eye(3))
        takes.append(bool(jax.random.bernoulli(kp, prob)))
    draw = augment.AffineDraw(torch.stack(rots), torch.from_numpy(np.stack(scales)),
                              torch.from_numpy(np.stack(trans)), torch.tensor(takes))
    return draw, srcs


def _batch(seed: int, b: int = 6):
    rng = np.random.default_rng(seed)
    vox = (rng.random((b, *SHAPE, 1)) < 0.5).astype(np.float32)
    seg = rng.integers(0, 25, (b, *SHAPE)).astype(np.int8)
    return vox, seg


@pytest.mark.parametrize("prob,rotate,translate", [
    (0.0, True, 0.0), (0.5, False, 1.5), (1.0, True, 2.0), (1.0, True, 0.0)])
def test_paired_warp_matches_random_affine_batch_paired(prob, rotate, translate):
    """6 samples in 4 requested groups (3 groups of 2), one channel; the
    warp path and its plain gather."""
    vox, seg = _batch(int(prob * 10) + 3 * rotate + int(translate))
    key = jax.random.key(int(translate * 2) + 5)
    want_v, want_s = (np.asarray(a) for a in jax_augment.random_affine_batch_paired(
        jnp.asarray(vox), jnp.asarray(seg), key, 4, scale_range=(0.7, 1.05),
        rotate=rotate, translate_vox=translate, prob=prob))
    draw, srcs = _reference_draw(key, 6, 4, prob, (0.7, 1.05), rotate, translate)
    tv, ts = torch.from_numpy(vox), torch.from_numpy(seg)
    got_v, got_s = (a.numpy() for a in augment.affine_warp_pair(tv, ts, *draw))
    plain_v, plain_s = (a.numpy() for a in augment.affine_warp_pair_plain(tv, ts, *draw))
    assert got_s.dtype == np.int8
    np.testing.assert_array_equal(plain_s, got_s)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5)
    np.testing.assert_allclose(plain_v, want_v, rtol=0, atol=1e-5)
    near = 0
    for g, src in enumerate(srcs):
        frac = np.abs(src - np.floor(src) - 0.5)
        halfway = (frac < NEAR_HALF).any(axis=0).reshape(SHAPE)
        near += int(halfway.sum()) if draw.take[g] else 0
        for b in (2 * g, 2 * g + 1):
            diff = got_s[b] != want_s[b]
            assert not (diff & ~halfway).any(), (g, b)
    print(f"labels: {int((got_s != want_s).sum())} differ; {near} voxels of "
          f"taken groups lie within {NEAR_HALF} of a half-integer")
    kept = ~draw.take.repeat_interleave(2).numpy()
    np.testing.assert_array_equal(got_v[kept], vox[kept])
    np.testing.assert_array_equal(got_s[kept], seg[kept])
    if prob == 0.0:
        np.testing.assert_array_equal(got_s, seg)


def test_exact_half_coordinates_round_away_from_zero():
    """No rotation, scale 0.5, no translation: on an even axis every
    source coordinate is an exact half-integer (2p − c), so
    half-to-even rounding would move about half the labels; the port's
    labels equal the reference's everywhere."""
    vox, seg = _batch(9)
    key = jax.random.key(3)
    want_s = np.asarray(jax_augment.random_affine_batch_paired(
        jnp.asarray(vox), jnp.asarray(seg), key, 3, scale_range=(0.5, 0.5),
        rotate=False, prob=1.0)[1])
    draw, srcs = _reference_draw(key, 6, 3, 1.0, (0.5, 0.5), False, 0.0)
    assert all(np.all(np.abs(s[1] - np.round(s[1])) == 0.5) for s in srcs)
    got = augment.affine_warp_pair(torch.from_numpy(vox), torch.from_numpy(seg),
                                   *draw)[1].numpy()
    np.testing.assert_array_equal(got, want_s)
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, -1.4999999, 3.2],
                 np.float32)
    np.testing.assert_array_equal(augment.round_half_away(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.lax.round(jnp.asarray(x))))


def _setup():
    cfg = dict(peak_lr=1e-3, weight_decay=1e-4, warmup_steps=1, total_steps=10)
    jmodel = JaxSegmenter(features=FEATURES, dtype=jnp.float32,
                          input_context="proj_coords", decoder_blocks=2)
    # Jitted: one compile of the init, not one per op (the same values).
    jstate = jax.jit(functools.partial(
        jax_create_state, jmodel, jax_steps.make_optimizer(JaxConfig(**cfg))))(
        jnp.zeros((2, R, R, R, 1), jnp.float32), jax.random.key(0))
    tmodel = FeatureNetSegmenter(FEATURES, dtype=torch.float32,
                                 input_context="proj_coords", decoder_blocks=2)
    tmodel.load_state_dict(convert.from_flax(
        _np({"params": jstate.params, "batch_stats": jstate.batch_stats})))
    return jmodel, jstate, create_state(tmodel, Config(**cfg))


def test_resident_segment_step_with_the_warp_matches_jax():
    """Three ``ce_dice`` steps with the paired warp (prob 1 ramped over 2
    steps: no group warped at step 0, each with probability 1/2 at step 1,
    all at step 2) and the occupancy noise after it, the reference's
    ``make_train_step`` against the port's resident step on the same rows,
    handed the draws the reference makes from ``fold_in(rng, step)``."""
    jmodel, jstate, tstate = _setup()
    jstep = jax.jit(jax_steps.make_train_step(
        jmodel, task="segment", packed=True, seg_loss="ce_dice",
        augment_groups=2, augment_noise=NOISE, augment_affine=True,
        affine_opts=AFFINE))
    tstep = steps.make_resident_train_step(augment_groups=2, augment_affine=True,
                                           augment_noise=NOISE, task="segment",
                                           seg_loss="ce_dice")
    data = np.random.default_rng(5)
    batches = [synthetic.to_wire(synthetic.generate_batch(data, 4, R, num_features=3),
                                 "segment") for _ in range(3)]
    resident = torch.from_numpy(np.concatenate([b["voxels"] for b in batches]))
    labels = torch.from_numpy(np.concatenate([b["seg"] for b in batches]))
    rng = jax.random.key(1)
    names = [n for n, _ in tstate.model.named_parameters()]
    taken = []
    for s, batch in enumerate(batches):
        _, aug, noise = jax.random.split(jax.random.fold_in(rng, s), 3)
        prob = AFFINE["prob"] * jnp.clip(jnp.int32(s) / AFFINE["ramp_steps"],
                                         0.0, 1.0)
        draw, _ = _reference_draw(aug, 4, 2, prob, AFFINE["scale_range"], True,
                                  AFFINE["translate_vox"], shape=(R, R, R))
        flips = np.array(jax.random.bernoulli(noise, NOISE, (4, R, R, R, 1)))
        taken.append(int(draw.take.sum()))
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), rng)
        tm = tstep(tstate, resident, labels, torch.arange(4 * s, 4 * s + 4),
                   affine=draw, flips=torch.from_numpy(flips))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        for k in ("accuracy", "fg_accuracy"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert taken[0] == 0 and taken[2] == 2
    assert tstate.step == int(jstate.step) == 3
    want = convert.from_flax(_np({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}))
    got = tstate.model.state_dict()
    for k in (k for k in want if k.endswith((".mean", ".var"))):
        scale = max(float(want[k].abs().max()), 1e-12)
        assert float((got[k] - want[k]).abs().max()) <= 1e-4 * scale, k
    lr = tstate.optimizer.schedule
    bound = 2 * (lr(1) + lr(2)) + 1e-6
    for k in names:
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= bound, k
        assert float((diff <= 1e-5).float().mean()) >= 0.99, k


@pytest.fixture(scope="module")
def seg_cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segaff") / "c")
    offline.export_seg_cache(root, num_parts=16, resolution=R, shard_size=8)
    return root


def test_resident_segment_trainer_runs_the_warp(seg_cache):
    """A resident segment Trainer draws the affine stream (and no cube
    codes) and runs; the streamed refusal is held in
    ``tests/test_torch_precision.py``."""
    kw = dict(resolution=R, seg_features=FEATURES, global_batch=4,
              eval_batches=1, data_workers=1, data_cache=seg_cache,
              augment_affine=True, augment_affine_prob=0.5, total_steps=2,
              eval_every=100, log_every=1)
    cfg = get_config("seg64", hbm_cache=True, **kw)
    assert cfg.device_augment and cfg.augment_affine
    trainer = Trainer(cfg, device="cpu")
    assert "affine" in trainer._draws.streams and "codes" not in trainer._draws.streams
    assert np.isfinite(trainer.run()["loss"])
