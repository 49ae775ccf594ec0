"""robust64's training in the port against the JAX package's, on the CPU:
the augmented step (affine warp, ramp, occupancy noise) against JAX
``make_train_step`` on the reference's own draws; k steps per dispatch
against single steps, with the remainder step, the cadences and a resume
inside a group; the per-step draws as functions of (seed, step, stream)
alone; ``recalibrate_bn`` and ``cli recalibrate``; the robust training
flags of ``cli train``.

Tolerances:
- the step: as ``tests/test_torch_train.py::test_train_steps_match_jax``
  (loss 1e-5 relative, gradient norm 1e-4, batch-norm statistics 1e-4 of
  each leaf's scale, parameters 2·lr per moving step with 99 % of entries
  within 1e-5); the port's warp is within ~1e-6 of the reference's
  (``tests/test_torch_augment.py``), far inside them;
- k steps against single steps: rtol 1e-6, atol 1e-7, the reference's own
  k-step tolerance (``tests/test_train.py``); on the CPU the k steps run
  eagerly through the same code, so they agree bitwise;
- recalibration: everything but the batch-norm statistics bitwise.
"""

import dataclasses
import hashlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.config import Config as JaxConfig
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import cli, convert
from featurenet_tpu_torch.config import Config, get_config
from featurenet_tpu_torch.data import offline, synthetic
from featurenet_tpu_torch.models.featurenet import FeatureNet, FeatureNetArch
from featurenet_tpu_torch.train import steps
from featurenet_tpu_torch.train.checkpoint import load_run_config
from featurenet_tpu_torch.train.loop import Trainer
from featurenet_tpu_torch.train.state import create_state
from test_torch_augment import _reference_affine_draw

R = 16
# sprint64's structure at narrow widths, no dropout (tests/test_torch_train.py).
SPRINT = dict(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
              strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
              hidden=32, dropout=0.0)
# The recipe's knobs at smoke16 scale: the warp in 3 of 4 requested groups
# of a batch of 6, ramped in over 2 steps, translated, and 1 % flips.
AFFINE = dict(prob=1.0, ramp_steps=2, translate_vox=1.0)
NOISE = 0.01


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("robust") / "c16")
    offline.export_synthetic_cache(root, per_class=3, resolution=R, seed=1)
    return root


# --- one robust step against JAX -------------------------------------------------

def test_robust_step_matches_jax():
    """Three steps of the JAX step with the affine warp (prob 1 ramped over
    2 steps: no group warped at step 0, each with probability 1/2 at step
    1, all at step 2) and the noise, dropout off, against the port's step
    handed the draws the reference makes from its key: its
    ``fold_in(rng, step)`` split into dropout, pose and noise keys."""
    cfg = dict(peak_lr=1e-3, weight_decay=1e-4, warmup_steps=1, total_steps=10)
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend="xla", **SPRINT),
                           dtype=jnp.float32)
    jstate = jax_create_state(jmodel, jax_steps.make_optimizer(JaxConfig(**cfg)),
                              jnp.zeros((2, R, R, R, 1), jnp.float32),
                              jax.random.key(0))
    arch = FeatureNetArch(conv_backend="pallas", **SPRINT)
    tmodel = FeatureNet(arch, R, dtype=torch.float32)
    tmodel.load_state_dict(convert.from_flax(
        _np({"params": jstate.params, "batch_stats": jstate.batch_stats}), arch))
    tstate = create_state(tmodel, Config(**cfg))
    jstep = jax.jit(jax_steps.make_train_step(
        jmodel, packed=True, augment_groups=4, augment_noise=NOISE,
        augment_affine=True, affine_opts=AFFINE))
    tstep = steps.make_train_step(augment_groups=4, augment_affine=True,
                                  augment_noise=NOISE)
    rng = jax.random.key(1)
    data = np.random.default_rng(2)
    taken = []
    for s in range(3):
        batch = synthetic.to_wire(synthetic.generate_batch(data, 6, R))
        _, aug, noise = jax.random.split(jax.random.fold_in(rng, s), 3)
        prob = AFFINE["prob"] * jnp.clip(jnp.int32(s) / AFFINE["ramp_steps"], 0.0, 1.0)
        draw = _reference_affine_draw(aug, 6, 4, prob, (0.7, 1.05), True,
                                      AFFINE["translate_vox"])
        flips = np.array(jax.random.bernoulli(noise, NOISE, (6, R, R, R, 1)))
        taken.append(int(draw.take.sum()))
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), rng)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                   affine=draw, flips=torch.from_numpy(flips))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert taken[0] == 0 and taken[2] == 3
    assert tstate.step == int(jstate.step) == 3
    want = convert.from_flax(_np({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}), arch)
    got = tstate.model.state_dict()
    for k in (k for k in want if k.endswith((".mean", ".var"))):
        scale = max(float(want[k].abs().max()), 1e-12)
        assert float((got[k] - want[k]).abs().max()) <= 1e-4 * scale, k
    lr = tstate.optimizer.schedule
    bound = 2 * (lr(1) + lr(2)) + 1e-6
    for k, _ in tstate.model.named_parameters():
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= bound, k
        assert float((diff <= 1e-5).float().mean()) >= 0.99, k


def test_step_refuses_draws_it_does_not_use():
    batch = {k: torch.from_numpy(v) for k, v in synthetic.to_wire(
        synthetic.generate_batch(np.random.default_rng(0), 4, R)).items()}
    warp = steps.make_train_step(augment_groups=2, augment_affine=True,
                                 augment_noise=NOISE)
    with pytest.raises(ValueError, match="warps 2 groups"):
        warp(None, batch, flips=torch.zeros((4, R, R, R, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="flip mask"):
        warp(None, batch, affine=_reference_affine_draw(
            jax.random.key(0), 4, 2, 1.0, (0.7, 1.05), True, 0.0))
    with pytest.raises(ValueError, match="does not pose by them"):
        steps.make_train_step()(None, batch, codes=[0, 1])


# --- the draws -----------------------------------------------------------------

def _draws(cfg, slot_draws, slot):
    args = slot_draws.step_args(slot, cfg.global_batch, R)
    out = {"rows": slot_draws.draw_rows(slot),
           "dropout": torch.rand(8, generator=args.pop("generator")),
           "flips": args.pop("flips")}
    out.update(args.pop("affine")._asdict())
    assert not args
    return out


def test_each_draw_is_a_function_of_seed_step_and_stream():
    """Slot j of a dispatch seeded at step s draws what slot 0 of a single
    step at s + j draws, stream by stream (rows, dropout, the affine draw
    with its ramp, the flips); another step or seed draws otherwise."""
    cfg = get_config("smoke16", data_cache="c", hbm_cache=True, global_batch=8,
                     augment_affine=True, augment_affine_prob=0.5,
                     augment_ramp_steps=8, augment_noise=NOISE)
    group = steps.StepDraws(cfg, 3, "cpu", rows=50)
    single = steps.StepDraws(cfg, 1, "cpu", rows=50)
    assert group.streams == ("dropout", "rows", "affine", "noise")
    group.seed(5, 3)
    assert group.steps.tolist() == [5, 6, 7]
    for j in range(3):
        single.seed(5 + j, 1)
        a, b = _draws(cfg, group, j), _draws(cfg, single, 0)
        for k in a:
            assert torch.equal(a[k], b[k]), (j, k)
    other = steps.StepDraws(dataclasses.replace(cfg, seed=1), 1, "cpu", rows=50)
    other.seed(5, 1)
    group.seed(5, 1)
    assert not torch.equal(_draws(cfg, group, 0)["rows"], _draws(cfg, other, 0)["rows"])
    with pytest.raises(ValueError, match="4 steps for 3 draw slots"):
        group.seed(0, 4)
    cube = steps.StepDraws(get_config("smoke16", data_cache="c", hbm_cache=True),
                           1, "cpu", rows=9)
    assert cube.streams == ("dropout", "rows", "codes")


# --- k steps per dispatch -------------------------------------------------------

def _robust_cfg(cache, **kw):
    """smoke16 under robust64's recipe (affine warp at prob 0.5, noise,
    dropout 0.2) from ``cache``."""
    base = dict(data_cache=cache, hbm_cache=True, global_batch=8, total_steps=7,
                warmup_steps=2, log_every=2, eval_every=10 ** 9,
                checkpoint_every=5, eval_batches=1, data_workers=1,
                augment_affine=True, augment_affine_prob=0.5,
                augment_noise=NOISE)
    return get_config("smoke16", **{**base, **kw})


def _close(a: Trainer, b: Trainer) -> None:
    assert a.state.step == b.state.step
    assert int(a.state.optimizer.count) == int(b.state.optimizer.count)
    for x, y in zip(a.state.tensors(), b.state.tensors()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("resident", [True, False])
def test_k_steps_per_dispatch_match_single_steps(cache, tmp_path, resident):
    """The port of ``tests/test_train.py::test_steps_per_dispatch_matches_
    single_step``: 7 steps at k = 3 (two groups and one remainder step)
    against k = 1, resident and streamed; log and checkpoint fire on the
    group boundary after the step they are due at, and at the end."""
    runs = {}
    for k in (1, 3):
        cfg = _robust_cfg(cache, hbm_cache=resident, steps_per_dispatch=k,
                          checkpoint_dir=str(tmp_path / f"k{k}"))
        tr = Trainer(cfg, device="cpu", stream=io.StringIO())
        tr.run()
        runs[k] = tr
    _close(runs[1], runs[3])
    logged = {k: [r["step"] for r in tr.logger.history if r["kind"] == "train"]
              for k, tr in runs.items()}
    assert logged == {1: [2, 4, 6, 7], 3: [3, 6, 7]}
    assert runs[1].ckpt.all_steps() == [5, 7]
    assert runs[3].ckpt.all_steps() == [6, 7]
    assert runs[3].timing["steps"] == 7


def test_resume_inside_a_group_lands_on_the_unbroken_run(cache, tmp_path):
    """k = 3, resident: a run stopped at step 5 (one group, two single
    steps) and resumed to 7 draws what the unbroken run (two groups, one
    single step) drew, and lands on its state."""
    straight = Trainer(_robust_cfg(cache, steps_per_dispatch=3), device="cpu",
                       stream=io.StringIO())
    straight.run()
    cfg = _robust_cfg(cache, steps_per_dispatch=3,
                      checkpoint_dir=str(tmp_path / "ck"))
    Trainer(cfg, device="cpu", stream=io.StringIO()).run(num_steps=5)
    resumed = Trainer(cfg, device="cpu", stream=io.StringIO())
    resumed.run()
    assert resumed.logger.history[0]["step"] == 5  # the setup record
    _close(straight, resumed)


# --- recalibration and the command line -----------------------------------------

def _digest(directory: str) -> dict:
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _main(capsys, *argv) -> list[dict]:
    assert cli.main(list(argv)) == 0
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_recalibrate_moves_only_the_batch_norm_statistics(cache, tmp_path, capsys):
    """``cli train`` with the robust flags (k = 2) writes them into its
    config; ``cli recalibrate`` then re-estimates the statistics over clean
    batches into a new directory at the same step: parameters, moments,
    count and step bitwise as trained, the statistics moved, the source
    untouched, the run's config kept, and a resume from there continues
    at that step. ``recalibrate_bn`` on a Trainer does the same in place."""
    src, out = str(tmp_path / "src"), str(tmp_path / "out")
    recs = _main(capsys, "train", "--config", "smoke16", "--device", "cpu",
                 "--data-cache", cache, "--hbm-cache", "--global-batch", "8",
                 "--total-steps", "4", "--checkpoint-dir", src,
                 "--steps-per-dispatch", "2", "--augment-affine",
                 "--augment-affine-prob", "0.5", "--augment-ramp-steps", "2",
                 "--no-augment-affine-rotate", "--augment-scale-range", "0.8", "1.0",
                 "--augment-translate-vox", "1.5", "--augment-noise", "0.01")
    cfg = load_run_config(src)
    assert (cfg.steps_per_dispatch, cfg.augment_affine, cfg.augment_affine_prob,
            cfg.augment_ramp_steps, cfg.augment_affine_rotate,
            cfg.augment_scale_range, cfg.augment_translate_vox,
            cfg.augment_noise) == (2, True, 0.5, 2, False, (0.8, 1.0), 1.5, 0.01)
    assert recs[0]["config"]["steps_per_dispatch"] == 2
    before = _digest(src)
    for bad, match in ((("--batches", "0"), "--batches must be >= 1"),
                       (("--out-dir", src), "must differ")):
        argv = ["recalibrate", "--checkpoint-dir", src, "--out-dir", out,
                "--device", "cpu", *bad]
        with pytest.raises(SystemExit, match=match):
            cli.main(argv)
    (rec,) = _main(capsys, "recalibrate", "--checkpoint-dir", src, "--out-dir",
                   out, "--batches", "3", "--device", "cpu")
    assert rec == {"recalibrated": out, "from_step": 4, "batches": 3}
    assert _digest(src) == before
    assert load_run_config(out) == dataclasses.replace(cfg, checkpoint_dir=out)

    def state(directory):
        tr = Trainer(dataclasses.replace(cfg, checkpoint_dir=directory),
                     device="cpu", stream=io.StringIO())
        assert tr.resume_if_available() == 4
        return tr

    trained, recal = state(src), state(out)
    a, b = trained.state.model.state_dict(), recal.state.model.state_dict()
    stats = [k for k in a if k.endswith((".mean", ".var"))]
    assert stats and all(not torch.equal(a[k], b[k]) for k in stats)
    assert all(torch.equal(a[k], b[k]) for k in a if k not in stats)
    for x, y in zip(trained.state.optimizer.tensors(), recal.state.optimizer.tensors()):
        assert torch.equal(x, y)
    trained.recalibrate_bn(3)
    for k in a:
        assert torch.equal(trained.state.model.state_dict()[k], b[k]), k
    assert recal.run(num_steps=6)["loss"] > 0 and recal.state.step == 6
