"""JAX checkpoints in the port, on the CPU: the ``config.json`` the JAX
package writes loads through the port's ``config_from_dict``;
``convert.opt_from_optax`` maps optax's Adam state to the port's named
moments; and a run the JAX ``Trainer`` checkpointed, exported by
``export_jax_checkpoint.py``, resumes in the port and takes the same next
step as JAX's ``make_train_step``.

Tolerances: the export copies fp32 arrays, so weights, moments and counts
come across bitwise. The next step runs both models in fp32 (the
checkpoint holds fp32 masters; the compute dtype is not part of it) and is
held as ``tests/test_torch_train.py`` holds a step: loss to 1e-5 relative,
the gradients' global norm to 1e-4, batch-norm statistics to 1e-4 of each
leaf's scale, parameters to 2·lr (Adam's update is close to lr·sign(g), so
an entry whose gradient is rounding noise can move the other way) with
99 % of entries within 1e-5. The run is smoke16 with sprint64's structure
at narrow widths (``tests/test_torch_train.py``'s ``SPRINT``, no dropout):
smoke16's own arch max-pools a conv of binary voxels, whose outputs tie
often, and the two packages' fp32 roundings break such ties differently,
which moves single gradient entries by up to 2.5e-4 of their leaf's scale
whatever the conv backend.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from featurenet_tpu.config import Config as JaxConfig
from featurenet_tpu.config import config_to_dict as jax_config_to_dict
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train.checkpoint import CheckpointManager as JaxManager
from featurenet_tpu.train.loop import Trainer as JaxTrainer
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import PRESETS, check_identity, config_from_dict, get_config
from featurenet_tpu_torch.data import synthetic
from featurenet_tpu_torch.models.featurenet import FeatureNet, FeatureNetArch
from featurenet_tpu_torch.train import steps
from featurenet_tpu_torch.train.checkpoint import CheckpointManager, load_run_config
from featurenet_tpu_torch.train.loop import Trainer
from featurenet_tpu_torch.train.state import create_state

import export_jax_checkpoint

R = 16


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_jax_config_json_loads_in_the_port(name):
    """What the JAX package writes beside its checkpoints, through JSON,
    gives the port's preset with the JAX lowering ("xla")."""
    jcfg = jax_get_config(name)
    d = json.loads(json.dumps(jax_config_to_dict(jcfg), default=str))
    got = config_from_dict(d)
    want = get_config(name)
    assert got.arch.conv_backend == jcfg.arch.conv_backend == "xla"
    assert got == dataclasses.replace(want, arch=dataclasses.replace(
        want.arch, conv_backend="xla"))
    check_identity(got, want)


@pytest.mark.parametrize("overrides", [
    {}, dict(augment_ramp_steps=400, augment_affine_rotate=False,
             augment_scale_range=(0.8, 1.0), augment_translate_vox=2.0)])
def test_jax_robust64_config_keeps_every_affine_field(overrides):
    """The JAX robust64 ``config.json`` (as written, and with every affine
    knob off its default) loads with the warp, its knobs, the noise and
    k = 8 intact, the scale range back as a tuple, and trains."""
    jcfg = jax_get_config("robust64", **overrides)
    d = json.loads(json.dumps(jax_config_to_dict(jcfg), default=str))
    assert isinstance(d["augment_scale_range"], list)
    got = config_from_dict(d)
    for name in ("augment_affine", "augment_affine_prob", "augment_ramp_steps",
                 "augment_affine_rotate", "augment_scale_range",
                 "augment_translate_vox", "augment_noise", "steps_per_dispatch",
                 "hbm_cache", "augment_groups"):
        assert getattr(got, name) == getattr(jcfg, name), name
    assert got.augment_scale_range == tuple(jcfg.augment_scale_range)
    assert isinstance(got.augment_scale_range, tuple)
    assert (got.augment_affine_prob, got.steps_per_dispatch) == (0.5, 8)
    assert got.validate_training() is got


@pytest.mark.parametrize("kind,clip", [("adamw", 0.0), ("adam", 0.0),
                                       ("adamw", 0.5)])
def test_opt_from_optax_maps_the_moments(kind, clip):
    """Two optax updates of a FeatureNet's params; the port's named
    moments are the optax leaves (dense transposed), bitwise."""
    cfg = dict(optimizer=kind, peak_lr=1e-2, weight_decay=1e-2,
               warmup_steps=1, total_steps=10, grad_clip=clip)
    kw = dict(features=(4, 8), kernels=(3, 3), strides=(1, 1),
              pool_after=(True, True), hidden=8)
    jmodel = JaxFeatureNet(arch=JaxArch(**kw), dtype=jnp.float32)
    tx = jax_steps.make_optimizer(JaxConfig(**cfg))
    v = jmodel.init({"params": jax.random.key(0)},
                    jnp.zeros((1, R, R, R, 1)), train=False)
    params = v["params"]
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)
        upd, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
    arch = FeatureNetArch(**kw)
    got = convert.opt_from_optax(jax.device_get(opt_state), arch)
    assert got["count"] == 2
    names = [n for n, _ in FeatureNet(arch, R).named_parameters()]
    adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]
    for key in ("mu", "nu"):
        assert sorted(got[key]) == sorted(names)
        want = convert.from_flax(_np({"params": getattr(adam, key),
                                      "batch_stats": v["batch_stats"]}), arch)
        for n in names:
            assert torch.equal(got[key][n], want[n]), (key, n)
    sgd = jax_steps.make_optimizer(JaxConfig(optimizer="sgd")).init(params)
    with pytest.raises(ValueError, match="adam"):
        convert.opt_from_optax(jax.device_get(sgd), arch)


def test_exported_jax_run_resumes_in_the_port(tmp_path):
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    arch = JaxArch(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
                   strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
                   hidden=32, dropout=0.0)
    jcfg = jax_get_config("smoke16", arch=arch, global_batch=8, total_steps=2,
                          eval_batches=1, data_workers=1, checkpoint_dir=jck,
                          checkpoint_every=1, log_every=1)
    JaxTrainer(jcfg).run()
    assert export_jax_checkpoint.export(jck, pck) == 2

    # The sidecar, the step, the count and every array come across.
    cfg = load_run_config(pck)
    assert cfg.name == "smoke16" and cfg.arch.conv_backend == "xla"
    assert cfg.checkpoint_dir == pck
    port = Trainer(cfg, device="cpu")
    assert port.resume_if_available() == 2
    assert port.state.optimizer.count == 2
    r = cfg.resolution
    jmodel = JaxFeatureNet(arch=jcfg.arch, dtype=jnp.float32)
    template = jax_create_state(jmodel, jax_steps.make_optimizer(jcfg),
                                jnp.zeros((1, r, r, r, 1)), jax.random.key(9))
    mgr = JaxManager(jck)
    jstate = mgr.restore(template)
    mgr.close()
    assert int(jstate.step) == 2
    want = convert.from_flax(_np({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}), cfg.arch)
    for k, v in port.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    moments = convert.opt_from_optax(jax.device_get(jstate.opt_state), cfg.arch)
    names = [n for n, _ in port.state.model.named_parameters()]
    for key in ("mu", "nu"):
        for n, t in zip(names, getattr(port.state.optimizer, key)):
            assert torch.equal(t, moments[key][n]), (key, n)

    # One more step on the same batch, both in fp32.
    model = FeatureNet(cfg.arch, r, dtype=torch.float32)
    state = create_state(model, cfg)
    CheckpointManager(pck).restore(state)
    batch = synthetic.to_wire(synthetic.generate_batch(
        np.random.default_rng(5), 8, r))
    jstep = jax.jit(jax_steps.make_train_step(jmodel, packed=True))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                       jax.random.key(1))
    tm = steps.make_train_step()(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert state.step == int(jstate.step) == 3
    want = convert.from_flax(_np({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}), cfg.arch)
    got = state.model.state_dict()
    for k in want:
        if k.endswith((".mean", ".var")):
            scale = max(float(want[k].abs().max()), 1e-12)
            assert float((got[k] - want[k]).abs().max()) <= 1e-4 * scale, k
    bound = 2 * state.optimizer.schedule(2) + 1e-6
    for k in names:
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= bound, k
        assert float((diff <= 1e-5).float().mean()) >= 0.99, k


def test_exported_fp16_scaled_run_resumes_with_its_scale(tmp_path):
    """A JAX ``fp16_scaled`` run, exported, resumes in the port with its
    loss-scale state (``convert.scale_state_from_jax``), the masters and
    moments bitwise, and takes the same next step: the same scale verdict
    and, within ``tests/test_torch_precision.py``'s tolerances, the same
    loss."""
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    arch = JaxArch(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
                   strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
                   hidden=32, dropout=0.0)
    jcfg = jax_get_config("smoke16", arch=arch, global_batch=8, total_steps=2,
                          eval_batches=1, data_workers=1, checkpoint_dir=jck,
                          checkpoint_every=1, log_every=1,
                          train_precision="fp16_scaled")
    jtrainer = JaxTrainer(jcfg)
    jtrainer.run()
    jscale = float(jtrainer.state.loss_scale)
    jgood = int(jtrainer.state.good_steps)
    assert export_jax_checkpoint.export(jck, pck) == 2

    cfg = load_run_config(pck)
    assert cfg.train_precision == "fp16_scaled"
    port = Trainer(cfg, device="cpu")
    assert port.resume_if_available() == 2
    assert port.state.precision == "fp16_scaled"
    assert float(port.state.loss_scale) == jscale
    assert int(port.state.good_steps) == jgood
    want = convert.from_flax(_np({"params": jtrainer.state.params,
                                  "batch_stats": jtrainer.state.batch_stats}),
                             cfg.arch)
    for k, v in port.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k

    r = cfg.resolution
    jmodel = JaxFeatureNet(arch=jcfg.arch, dtype=jnp.float32)
    template = jax_create_state(jmodel, jax_steps.make_optimizer(jcfg),
                                jnp.zeros((1, r, r, r, 1)), jax.random.key(9),
                                precision="fp16_scaled")
    mgr = JaxManager(jck)
    jstate = mgr.restore(template)
    mgr.close()
    model = FeatureNet(cfg.arch, r, dtype=torch.float32)
    state = create_state(model, cfg)
    CheckpointManager(pck).restore(state)
    assert float(state.loss_scale) == float(jstate.loss_scale) == jscale
    batch = synthetic.to_wire(synthetic.generate_batch(
        np.random.default_rng(5), 8, r))
    jstep = jax.jit(jax_steps.make_train_step(jmodel, packed=True))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                       jax.random.key(1))
    tm = steps.make_train_step()(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    assert float(tm["grads_finite"]) == float(jm["grads_finite"])
    assert float(state.loss_scale) == float(jstate.loss_scale)
    assert int(state.good_steps) == int(jstate.good_steps)
    assert state.step == int(jstate.step) == 3
