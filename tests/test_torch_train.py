"""The port's training path against the JAX package's on the CPU.

Inputs come from numpy seeds and go through both packages. The JAX model's
Pallas kernels run in interpret mode; the port's wrappers run their plain
versions. Tolerances, each with its reason:

- data: the generator, the wire format and ``unpack_voxels`` are
  bit-identical (same numpy calls, integer ops);
- loss, schedule, optimizer: the same fp32 arithmetic in another order,
  1e-6 relative (1e-5 where a square root or a sum over a tree enters);
- model and train step, in fp32 on both sides: the convolutions sum the
  same products in other orders, so values agree to 1e-4 of their scale.
  Parameters after Adam steps are held to 2·lr per moving step: Adam's
  early updates are close to lr·sign(g), so an entry whose gradient is
  rounding noise can move the other way.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from featurenet_tpu.config import Config as JaxConfig
from featurenet_tpu.data import dataset as jax_dataset
from featurenet_tpu.data import synthetic as jax_synth
from featurenet_tpu.models.featurenet import ConvBNRelu as JaxConvBNRelu
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import Config, get_config
from featurenet_tpu_torch.data import dataset, synthetic
from featurenet_tpu_torch.models.featurenet import (
    ConvBNRelu,
    FeatureNet,
    FeatureNetArch,
    dropout,
    max_pool2,
)
from featurenet_tpu_torch.train import steps
from featurenet_tpu_torch.train.state import create_state

R = 16
# sprint64's structure at narrow widths (tests/test_torch_model.py), no dropout.
SPRINT = dict(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
              strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
              hidden=32, dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


# --- data --------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_generate_batch_and_wire_are_bit_identical(seed):
    want = jax_synth.generate_batch(np.random.default_rng(seed), 30, R)
    got = synthetic.generate_batch(np.random.default_rng(seed), 30, R)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    wire_j, wire_t = jax_synth.to_wire(want, "classify"), synthetic.to_wire(got)
    assert set(wire_j) == set(wire_t)
    for k in wire_j:
        np.testing.assert_array_equal(wire_t[k], wire_j[k])


def test_dataset_streams_match_jax():
    """Per-worker streams are the same SeedSequence folds as the JAX
    package's, and the prefetcher hands them out in ticket order."""
    kw = dict(resolution=R, global_batch=4, seed=5)
    jds = jax_dataset.SyntheticVoxelDataset(task="classify", **kw)
    tds = dataset.SyntheticVoxelDataset(**kw)
    for w in (0, 2):
        want, got = next(jds.worker_iter(w, 3)), next(tds.worker_iter(w))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    pf = dataset.Prefetcher(tds, "cpu", num_workers=3)
    try:
        out = [next(pf) for _ in range(6)]
    finally:
        pf.close()
    iters = [tds.worker_iter(w) for w in range(3)]
    for ticket, batch in enumerate(out):
        want = next(iters[ticket % 3])
        assert batch["voxels"].device.type == "cpu"
        for k in want:
            np.testing.assert_array_equal(batch[k].numpy(), want[k])


def test_prefetcher_surfaces_worker_errors():
    class Broken(dataset.SyntheticVoxelDataset):
        def worker_iter(self, worker_id=0):
            raise OSError("disk gone")
            yield  # pragma: no cover

    pf = dataset.Prefetcher(Broken(R, 2), "cpu", num_workers=2)
    with pytest.raises(dataset.ProducerError, match="disk gone"):
        next(pf)
    pf.close()


def test_unpack_voxels_is_bit_exact():
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, (3, R, R, R // 8), dtype=np.uint8)
    want = np.asarray(jax_steps.unpack_voxels(jnp.asarray(packed)))
    got = steps.unpack_voxels(torch.from_numpy(packed))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    vox = (rng.random((2, R, R, R)) > 0.5).astype(np.float32)
    round_trip = steps.unpack_voxels(torch.from_numpy(synthetic.pack_voxels(vox)))
    np.testing.assert_array_equal(round_trip.numpy()[..., 0], vox)


# --- loss, schedule, optimizer ------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_classification_loss_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((16, 24)) * 3).astype(np.float32)
    labels = rng.integers(0, 24, 16).astype(np.int32)
    loss_j, m_j = jax_steps.classification_loss(
        jnp.asarray(logits), jnp.asarray(labels), smoothing)
    loss_t, m_t = steps.classification_loss(
        torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    assert float(m_t["accuracy"]) == float(m_j["accuracy"])


def test_lr_schedule_matches_optax():
    """optax evaluates the schedule in fp32 (the warmup as
    ``(0 - peak)·(1 - s/w) + peak``), and so does the port, in the same
    order; they agree to an fp32 rounding of the peak (``cos`` may differ
    by an ulp)."""
    for peak, warmup, total, at in ((3e-4, 200, 8000, (0, 1, 57, 200, 4100, 8000, 8500)),
                                    (1e-3, 10, 5, (0, 5, 10, 11, 20))):
        want = jax_steps.make_lr_schedule(peak, warmup, total)
        got = steps.make_lr_schedule(peak, warmup, total)
        for s in at:
            np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                       atol=2 ** -23 * peak)
        assert got(0) == 0.0


@pytest.mark.parametrize("kind,clip", [("adamw", 0.0), ("adamw", 0.5),
                                       ("adam", 0.0), ("sgd", 0.0)])
def test_optimizer_matches_optax(kind, clip):
    """Five updates of a small tree with a warmup of 2 (so the rate moves
    off 0), against optax through the JAX package's ``make_optimizer``."""
    cfg = dict(optimizer=kind, peak_lr=1e-2, weight_decay=1e-2,
               warmup_steps=2, total_steps=20, grad_clip=clip)
    tx = jax_steps.make_optimizer(JaxConfig(**cfg))
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    opt = steps.make_optimizer(Config(**cfg), tp)
    for _ in range(5):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(grads[k]) for k in shapes])
    for k, t in zip(shapes, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-7)


# --- model pieces in train mode -----------------------------------------------

def test_batchnorm_train_matches_flax():
    """conv → BN (batch statistics, biased variance) → ReLU, and the
    running-statistic update, against Flax."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 6, 6, 6, 4)).astype(np.float32) + 0.5
    jm = JaxConvBNRelu(8, 3, 1, dtype=jnp.float32, conv_backend="pallas")
    v = _np(jm.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False))
    bn, st = v["params"]["BatchNorm_0"], v["batch_stats"]["BatchNorm_0"]
    bn["scale"] = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn["bias"] = rng.normal(0, 0.2, 8).astype(np.float32)
    st["mean"] = rng.normal(0, 0.2, 8).astype(np.float32)
    st["var"] = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    want, mutated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = ConvBNRelu(4, 8, 3, 1, torch.float32, "pallas", plain=False)
    with torch.no_grad():
        tm.conv.kernel.copy_(torch.from_numpy(v["params"]["PallasConv_0"]["kernel"]))
        tm.scale.copy_(torch.from_numpy(bn["scale"]))
        tm.bias.copy_(torch.from_numpy(bn["bias"]))
        tm.mean.copy_(torch.from_numpy(st["mean"]))
        tm.var.copy_(torch.from_numpy(st["var"]))
        got = tm(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    new = _np(mutated["batch_stats"]["BatchNorm_0"])
    np.testing.assert_allclose(tm.mean.numpy(), new["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.var.numpy(), new["var"], rtol=1e-5, atol=1e-6)


def test_max_pool_gradient_goes_to_the_first_maximum():
    """Ties (common after ReLU in bf16) route the whole gradient to the
    first maximum of the window, as XLA's max-pool VJP does."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 3, (2, 4, 4, 6, 3)).astype(np.float32)  # many ties
    r = rng.standard_normal((2, 2, 2, 3, 3)).astype(np.float32)
    pool = lambda a: fnn.max_pool(a, (2, 2, 2), strides=(2, 2, 2))  # noqa: E731
    want = np.asarray(jax.grad(lambda a: (pool(a) * r).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = max_pool2(xt)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(pool(jnp.asarray(x))))
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_dropout_keeps_flax_semantics():
    x = torch.ones((64, 128))
    assert dropout(x, 0.0, None) is x
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.5, g)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y > 0).float().mean()) - 0.5) < 0.02
    again = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)


# --- the whole step --------------------------------------------------------

def _setup(backend: str, seed: int = 0):
    """Bridged JAX and port train states (fp32 model, AdamW, warmup 1),
    and three wire batches."""
    cfg = dict(peak_lr=1e-3, weight_decay=1e-4, warmup_steps=1, total_steps=10)
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend=backend, **SPRINT),
                           dtype=jnp.float32)
    sample = jnp.zeros((2, R, R, R, 1), jnp.float32)
    jstate = jax_create_state(jmodel, jax_steps.make_optimizer(JaxConfig(**cfg)),
                              sample, jax.random.key(seed))
    arch = FeatureNetArch(conv_backend=backend, **SPRINT)
    tmodel = FeatureNet(arch, R, dtype=torch.float32)
    tmodel.load_state_dict(convert.from_flax(
        _np({"params": jstate.params, "batch_stats": jstate.batch_stats}), arch))
    tstate = create_state(tmodel, Config(**cfg))
    rng = np.random.default_rng(seed + 11)
    batches = [synthetic.to_wire(synthetic.generate_batch(rng, 6, R)) for _ in range(3)]
    return jmodel, jstate, arch, tstate, batches


def _port_tree(tree, stats, arch):
    """A JAX params-shaped tree (params, Adam moments) in port names."""
    return convert.from_flax(_np({"params": tree, "batch_stats": stats}), arch)


def _close_per_leaf(got: dict, want: dict, rel: float, keys=None):
    for k in keys or want:
        w, g = want[k].numpy(), got[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= rel * scale, (k, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("backend", ["pallas", "hybrid_dw", "xla"])
def test_train_steps_match_jax(backend):
    jmodel, jstate, arch, tstate, batches = _setup(backend)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, packed=True))
    tstep = steps.make_train_step()
    key = jax.random.key(1)
    names = [n for n, _ in tstate.model.named_parameters()]
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        if i == 0:
            # After one step Adam's moments are 0.1·g and 0.001·g²: the
            # first-step gradients, leaf by leaf.
            adam = jstate.opt_state[0]
            for name, moments in (("mu", tstate.optimizer.mu),
                                  ("nu", tstate.optimizer.nu)):
                want = _port_tree(getattr(adam, name), jstate.batch_stats, arch)
                _close_per_leaf(dict(zip(names, moments)), want, 1e-4, keys=names)
    assert tstate.step == int(jstate.step) == 3
    want = convert.from_flax(_np({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}), arch)
    got = tstate.model.state_dict()
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    _close_per_leaf(got, want, 1e-4, keys=stats)
    lr = tstate.optimizer.schedule
    bound = 2 * (lr(1) + lr(2)) + 1e-6
    for k in names:
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= bound, k
        assert float((diff <= 1e-5).float().mean()) >= 0.99, k


def test_eval_step_matches_jax():
    jmodel, jstate, arch, tstate, batches = _setup("pallas", seed=2)
    jeval = jax.jit(jax_steps.make_eval_step(jmodel, packed=True))
    for batch in batches:
        want = jeval(jstate.params, jstate.batch_stats,
                     jax.tree_util.tree_map(jnp.asarray, batch))
        got = steps.eval_step(tstate.model, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
        assert float(got["correct"]) == float(want["correct"])
        assert float(got["count"]) == float(want["count"])
        np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(got["confusion"].numpy(),
                                      np.asarray(want["confusion"]))
    agg_t = steps.aggregate_eval([got])
    agg_j = jax_steps.aggregate_eval([jax.device_get(want)])
    assert agg_t["confusion"] == agg_j["confusion"]
    np.testing.assert_allclose(agg_t["accuracy"], agg_j["accuracy"])


def test_trainer_runs_and_logs_on_cpu():
    from featurenet_tpu_torch.train.loop import Trainer

    lines = []

    class Sink:
        def write(self, s):
            lines.append(s)

        def flush(self):
            pass

    cfg = get_config("smoke16", global_batch=8, total_steps=4, log_every=2,
                     eval_every=4, eval_batches=1)
    tr = Trainer(cfg, device="cpu", stream=Sink())
    before = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    last = tr.run()
    kinds = [r["kind"] for r in tr.logger.history]
    assert kinds == ["setup", "train", "train", "eval"]
    assert [r["step"] for r in tr.logger.history] == [0, 2, 4, 4]
    assert np.isfinite(last["loss"]) and 0 <= last["eval_accuracy"] <= 1
    assert {"loss", "accuracy", "grad_norm", "samples_per_sec"} <= set(last)
    after = tr.state.model.state_dict()
    assert not torch.equal(before["dense1.weight"], after["dense1.weight"])
    assert not torch.equal(before["blocks.0.mean"], after["blocks.0.mean"])
    assert tr.timing["steps"] == 4 and 0 <= tr.timing["data_wait_s"] <= tr.timing["wall_s"]
    assert sum(1 for s in lines if s.strip()) == 4


def test_training_refuses_what_is_not_ported():
    """robust64 (affine warp, occupancy noise, 8 steps per dispatch) and
    sprint64 at k = 8 train; the reference's invalid values of those
    fields raise, as its ``validate`` raises them."""
    robust = get_config("robust64")
    assert robust.validate_training() is robust
    assert (robust.augment_affine, robust.augment_affine_prob,
            robust.augment_noise, robust.steps_per_dispatch) == (True, 0.5, 0.005, 8)
    k8 = get_config("sprint64", steps_per_dispatch=8)
    assert k8.validate_training() is k8
    for overrides, match in (
            (dict(augment_noise=0.5), "augment_noise is a per-voxel"),
            (dict(steps_per_dispatch=0), "steps_per_dispatch must be >= 1"),
            (dict(augment_scale_range=(1.05, 0.7)), "0 < lo <= hi"),
            (dict(augment_affine_prob=0.0), r"probability in \(0, 1\]"),
            (dict(augment_affine=False, augment_affine_prob=0.5),
             "augment_affine_prob configured but augment_affine is off"),
            (dict(hbm_cache=False, data_cache=None), "needs device augmentation"),
            (dict(augment_affine_rotate=False, augment_scale_range=(1.0, 1.0)),
             "is the identity")):
        with pytest.raises(ValueError, match=match):
            get_config("robust64", **overrides)
    listed = dataclasses.replace(robust, augment_scale_range=[0.8, 1.0]).validate()
    assert listed.augment_scale_range == (0.8, 1.0)
    # The precision rungs and the fused33 lowering are ported; an unknown
    # name of either still raises.
    for prec in ("bf16_master", "fp16_scaled"):
        get_config("sprint64", train_precision=prec).validate_training()
    with pytest.raises(ValueError, match="unknown train_precision"):
        get_config("sprint64", train_precision="fp8")
    arch = dataclasses.replace(get_config("sprint64").arch, conv_backend="fused33")
    assert arch.conv_backend == "fused33"
    with pytest.raises(ValueError, match="unknown conv_backend"):
        dataclasses.replace(arch, conv_backend="fused55")
    get_config("sprint64").validate_training()
    cached = get_config("sprint64", data_cache=".data/c", hbm_cache=True)
    assert cached.validate_training() is cached and cached.device_augment
    assert not get_config("sprint64").device_augment


@pytest.mark.parametrize("overrides,match", [
    (dict(hbm_cache=True), "requires data_cache"),
    (dict(data_cache="x", hbm_cache=True, augment_device=False), "silently ignored"),
    (dict(data_cache="x", hbm_cache=True, augment_groups=0), "augment_groups >= 1"),
])
def test_hbm_cache_config_guards(overrides, match):
    """The reference's hbm_cache guards (its spatial-sharding guard aside:
    the port has no mesh), at validate time."""
    with pytest.raises(ValueError, match=match):
        get_config("pod64", **overrides)
    # Each guard names a fix that then validates.
    fixed = dict(overrides, data_cache="x", augment=False)
    assert get_config("pod64", **fixed).hbm_cache

