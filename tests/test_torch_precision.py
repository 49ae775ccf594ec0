"""The precision ladder of the port against the JAX package's, on the CPU:
``train/precision.py`` (the working copies and dynamic loss scaling),
``runtime/quantize.py`` (int8) and the Predictor's bf16 and int8 rungs.

Inputs come from numpy seeds (and bridged JAX inits) and go through both
packages; the JAX Pallas kernels run in interpret mode, the port's wrappers
their plain versions. Tolerances, each with its reason:

- the serving casts and the quantizer do the same elementwise fp32 (and
  round-to-nearest-even) arithmetic on the same values: bitwise;
- Predictor logits at bf16 and int8: the model computes in bf16 on both
  sides, so they agree as ``tests/test_torch_model.py``'s bf16 logits do,
  to 2e-2;
- train steps: fp32 activations on both sides (as ``tests/test_torch_train.py``
  holds its steps), so the working copy is the only reduced part. Loss to
  1e-5 relative, the gradients' global norm to 1e-4, BN statistics to 1e-4
  of each leaf's scale, parameters to 2·lr per moving step with 99 % of
  entries within 1e-5: the tolerances of ``tests/test_torch_train.py``.
  The first step's gradients (Adam's moments after one step) are stored at
  the working dtype: where the two packages' fp32 sums straddle a rounding
  boundary of that dtype they land one of its ulps apart (2^-8 of an
  entry in bf16, 2^-11 in fp16), so the moments are held to that ulp of
  each leaf's scale plus the fp32 1e-4;
- the skipped fp16 update and the loss-scale arithmetic: bitwise;
- the device schedule against optax's: both evaluate it in fp32 in the same
  order, and only ``cos`` may differ by an fp32 ulp, so rtol 1e-6; near the
  decay's end ``1 + cos`` cancels, where that ulp of ``cos`` is an fp32 ulp
  of the peak rate in absolute terms, so also atol ``2^-23·peak``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.config import Config as JaxConfig
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu.runtime import quantize as jax_quantize
from featurenet_tpu.train import precision as jax_precision
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import Config, get_config
from featurenet_tpu_torch.data import synthetic
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.models.featurenet import (
    FeatureNet,
    FeatureNetArch,
    init_weights,
)
from featurenet_tpu_torch.runtime import quantize
from featurenet_tpu_torch.train import precision, steps
from featurenet_tpu_torch.train.state import TrainState, create_state

R = 16
# sprint64's structure at narrow widths (tests/test_torch_train.py), no dropout.
SPRINT = dict(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
              strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
              hidden=32, dropout=0.0)
ULP = {"bf16_master": 2.0 ** -8, "fp16_scaled": 2.0 ** -11}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _jax_init(arch_kw, seed=0, backend="xla"):
    """A JAX FeatureNet (bf16 compute, as served) and its variables, with
    non-trivial batch-norm statistics and affine."""
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend=backend, **arch_kw))
    v = _np(jmodel.init({"params": jax.random.key(seed)},
                        jnp.zeros((1, R, R, R, 1)), train=False))
    rng = np.random.default_rng(seed)
    for name, scope in v["params"].items():
        if "BatchNorm_0" in scope:
            n = scope["BatchNorm_0"]["scale"].shape[0]
            scope["BatchNorm_0"]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            scope["BatchNorm_0"]["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
            st = v["batch_stats"][name]["BatchNorm_0"]
            st["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return jmodel, v


def _port_params(tree, v, arch):
    """A JAX params-shaped tree in port names (parameters only)."""
    out = convert.from_flax({"params": _np(tree),
                             "batch_stats": v["batch_stats"]}, arch)
    names = [n for n, _ in FeatureNet(arch, R).named_parameters()]
    return {n: out[n] for n in names}


# --- policies ------------------------------------------------------------------

def test_policies_mirror_jax():
    assert precision.TRAIN_PRECISIONS == jax_precision.TRAIN_PRECISIONS
    assert precision.SERVE_PRECISIONS == jax_precision.SERVE_PRECISIONS
    for k in ("LOSS_SCALE_INIT", "LOSS_SCALE_GROWTH_INTERVAL",
              "LOSS_SCALE_MAX", "LOSS_SCALE_MIN"):
        assert getattr(precision, k) == getattr(jax_precision, k), k
    for name in precision.TRAIN_PRECISIONS:
        j, t = jax_precision.POLICIES[name], precision.POLICIES[name]
        assert (t.name, t.working_dtype, t.loss_scaling) == \
            (j.name, j.working_dtype, j.loss_scaling)
        assert precision.initial_loss_scale(name) == \
            jax_precision.initial_loss_scale(name)
    assert quantize.PAPER_TOP1_TARGET == jax_quantize.PAPER_TOP1_TARGET


def test_working_params_cast_every_floating_parameter():
    model = init_weights(FeatureNet(FeatureNetArch(**SPRINT), R), 0)
    masters = dict(model.named_parameters())
    for name, dtype in (("bf16_master", torch.bfloat16),
                        ("fp16_scaled", torch.float16)):
        policy = precision.get_policy(name)
        work = policy.working_params(masters)
        assert list(work) == list(masters)
        for k, w in work.items():
            assert w.dtype == dtype and w.requires_grad and w.is_leaf, k
            assert torch.equal(w, masters[k].detach().to(dtype)), k
        grads = policy.master_grads([w.detach() for w in work.values()])
        assert all(g.dtype == torch.float32 for g in grads)
    fp32 = precision.get_policy("fp32")
    assert all(a is b for a, b in zip(fp32.working_params(masters).values(),
                                      masters.values()))
    # The BN running statistics are buffers, never cast.
    assert {k for k, _ in model.named_buffers()}.isdisjoint(masters)


@pytest.mark.parametrize("bad", [
    lambda: precision.get_policy("fp8"),
    lambda: precision.serve_params_cast({}, "fp16"),
    lambda: get_config("smoke16", train_precision="bf16"),
    lambda: get_config("smoke16", serve_precision="bf16_master"),
    lambda: Predictor.from_seed(get_config("smoke16"), 0, device="cpu",
                                precision="int4"),
    lambda: TrainState(FeatureNet(FeatureNetArch(**SPRINT), R), None,
                       precision="tf32"),
], ids=["policy", "serve_cast", "config_train", "config_serve", "predictor",
        "state"])
def test_unknown_precision_raises(bad):
    with pytest.raises(ValueError, match="unknown"):
        bad()


def test_config_accepts_the_rungs_and_refuses_the_unported():
    for tp in precision.TRAIN_PRECISIONS:
        for sp in precision.SERVE_PRECISIONS:
            cfg = get_config("sprint64", train_precision=tp, serve_precision=sp)
            assert cfg.validate_training() is cfg
    robust = get_config("robust64")  # affine, noise and k = 8: all ported
    assert robust.validate_training() is robust
    seg = get_config("seg64")  # the segmenter: ported
    assert seg.validate_training() is seg and seg.task == "segment"
    for sp in precision.SERVE_PRECISIONS:  # int8 included
        assert get_config("seg64", serve_precision=sp).serve_precision == sp
    # A resident segment run warps in the step; a streamed one has no
    # in-step augmentation, so the warp is refused, as the reference
    # refuses it.
    warped = get_config("seg64", augment_affine=True, data_cache="c",
                        hbm_cache=True)
    assert warped.device_augment and warped.validate_training() is warped
    for streamed in (dict(data_cache="c"), {}):
        with pytest.raises(ValueError, match="needs device augmentation active"):
            get_config("seg64", augment_affine=True, **streamed)


# --- serving casts and the quantizer --------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_quantize_tree_is_bitwise_jax(seed):
    arch_kw = dict(SPRINT, hidden=24)
    jmodel, v = _jax_init(arch_kw, seed)
    arch = FeatureNetArch(**arch_kw)
    masters = _port_params(v["params"], v, arch)
    jq, js = jax_quantize.quantize_tree(jax.tree_util.tree_map(jnp.asarray,
                                                               v["params"]))
    q, s = quantize.quantize_tree(masters)
    want_q, want_s = _port_params(jq, v, arch), _port_params(js, v, arch)
    for k, x in masters.items():
        if x.dim() >= 2:
            assert q[k].dtype == torch.int8 and s[k].dtype == torch.float32, k
            assert torch.equal(q[k].float(), want_q[k]), k
            assert torch.equal(s[k].expand_as(x), want_s[k].expand_as(x)), k
        else:
            assert q[k] is x and float(s[k]) == 1.0, k
    deq = quantize.dequantize_tree(q, s)
    want = _port_params(jax_quantize.dequantize_tree(jq, js), v, arch)
    for k in masters:
        assert torch.equal(deq[k], want[k]), k


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_serve_params_cast_is_bitwise_jax(rung):
    jmodel, v = _jax_init(SPRINT)
    arch = FeatureNetArch(**SPRINT)
    masters = _port_params(v["params"], v, arch)
    got = precision.serve_params_cast(masters, rung)
    jcast = jax_precision.serve_params_cast(
        jax.tree_util.tree_map(jnp.asarray, v["params"]), rung)
    want = _port_params(jcast, v, arch)
    for k in masters:
        assert got[k].dtype == (torch.bfloat16 if rung == "bf16" else torch.float32)
        assert torch.equal(got[k].float(), want[k]), k
    assert precision.serve_params_cast(masters, "fp32") == masters


@pytest.mark.parametrize("rung", ["bf16", "int8"])
@pytest.mark.parametrize("backend", ["pallas", "fused33"])
def test_predictor_rung_matches_jax_forward_of_the_cast_tree(rung, backend):
    jmodel, v = _jax_init(SPRINT, seed=1, backend=backend)
    arch = FeatureNetArch(conv_backend=backend, **SPRINT)
    cfg = Config(name="t", resolution=R, arch=arch)
    pred = Predictor(convert.from_flax(v, arch), cfg, batch=4, device="cpu",
                     precision=rung)
    assert pred.precision == rung
    rng = np.random.default_rng(1)
    x = (rng.random((4, R, R, R, 1)) > 0.5).astype(np.float32)
    cast = jax_precision.serve_params_cast(
        jax.tree_util.tree_map(jnp.asarray, v["params"]), rung)
    want = np.asarray(jmodel.apply({"params": cast, "batch_stats": v["batch_stats"]},
                                   jnp.asarray(x), train=False))
    from featurenet_tpu_torch.runtime import forward_with

    with torch.inference_mode():
        got = forward_with(pred.model, pred._dispatch_params(),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    probs = pred.forward_padded(x)
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(want)), atol=2e-2)


def test_predictor_keeps_only_the_rung_resident():
    """bf16 holds half the fp32 bytes, int8 a quarter plus its scales; the
    module's own parameters leave the device, so nothing reads them."""
    cfg = get_config("smoke16")
    preds = {p: Predictor.from_seed(cfg, 0, batch=2, device="cpu", precision=p)
             for p in precision.SERVE_PRECISIONS}
    full = preds["fp32"].resident_weight_bytes
    n = sum(p.numel() for p in FeatureNet(cfg.arch, cfg.resolution).parameters())
    assert full == 4 * n
    assert preds["bf16"].resident_weight_bytes == 2 * n
    q = preds["int8"]
    assert all(t.dtype in (torch.int8, torch.float32) for t in q._qparams.values())
    weights = sum(t.numel() for t in q._qparams.values() if t.dtype == torch.int8)
    assert q.resident_weight_bytes < n + 4 * (n - weights) + 4 * 1000
    for p in ("bf16", "int8"):
        assert all(t.is_meta for t in preds[p].model.parameters()), p
        assert all(not t.is_meta for t in preds[p].model.buffers()), p
    x = np.zeros((2, 16, 16, 16, 1), np.float32)
    for p in preds.values():
        assert p.forward_padded(x).shape == (2, 24)


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_agreement_meets_the_paper_target(rung):
    """smoke16 from the JAX init at key 0, as the JAX package's own gates
    (tests/test_runtime.py) take it: 48 synthetic parts from seed 0."""
    from featurenet_tpu.runtime import Runtime
    from featurenet_tpu.infer import Predictor as JaxPredictor

    jcfg = jax_get_config("smoke16")
    jstate = Runtime(jcfg, cache=None).build("init")(jax.random.key(0))
    cfg = get_config("smoke16")
    state = convert.from_flax(_np({"params": jstate.params,
                                   "batch_stats": jstate.batch_stats}), cfg.arch)
    pred = Predictor(state, cfg, batch=8, device="cpu", precision=rung)
    got = pred.int8_agreement(n=48, seed=0) if rung == "int8" else \
        pred.agreement(n=48, seed=0)
    assert got >= quantize.PAPER_TOP1_TARGET
    want = JaxPredictor(jstate.params, jstate.batch_stats, jcfg, batch=8,
                        precision=rung).agreement(n=48, seed=0)
    assert abs(got - want) <= 1 / 48 + 1e-9


# --- train steps --------------------------------------------------------------

def _setup(backend, prec, seed=0):
    cfg = dict(peak_lr=1e-3, weight_decay=1e-4, warmup_steps=1, total_steps=10)
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend=backend, **SPRINT),
                           dtype=jnp.float32)
    sample = jnp.zeros((2, R, R, R, 1), jnp.float32)
    jstate = jax_create_state(jmodel, jax_steps.make_optimizer(JaxConfig(**cfg)),
                              sample, jax.random.key(seed), precision=prec)
    arch = FeatureNetArch(conv_backend=backend, **SPRINT)
    tmodel = FeatureNet(arch, R, dtype=torch.float32)
    tmodel.load_state_dict(convert.from_flax(
        _np({"params": jstate.params, "batch_stats": jstate.batch_stats}), arch))
    tstate = create_state(tmodel, Config(train_precision=prec, **cfg))
    rng = np.random.default_rng(seed + 11)
    batches = [synthetic.to_wire(synthetic.generate_batch(rng, 6, R))
               for _ in range(3)]
    return jmodel, jstate, arch, tstate, batches


def _close(got, want, rel):
    scale = max(float(want.abs().max()), 1e-12)
    return float((got - want).abs().max()) <= rel * scale


@pytest.mark.parametrize("backend", ["pallas", "hybrid_dw", "xla"])
@pytest.mark.parametrize("prec", ["bf16_master", "fp16_scaled"])
def test_reduced_train_steps_match_jax(prec, backend):
    jmodel, jstate, arch, tstate, batches = _setup(backend, prec)
    assert tstate.precision == prec == jstate.precision
    jstep = jax.jit(jax_steps.make_train_step(jmodel, packed=True))
    tstep = steps.make_train_step()
    names = [n for n, _ in tstate.model.named_parameters()]
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch),
                           jax.random.key(1))
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
        if prec == "fp16_scaled":
            assert float(tm["loss_scale"]) == float(jm["loss_scale"])
            assert float(tm["grads_finite"]) == float(jm["grads_finite"]) == 1.0
        if i == 0:
            adam = jstate.opt_state[0]
            for key, moments in (("mu", tstate.optimizer.mu),
                                 ("nu", tstate.optimizer.nu)):
                want = _port_params(getattr(adam, key), {"batch_stats": _np(
                    jstate.batch_stats)}, arch)
                # mu = 0.1·g, nu = 0.001·g² after one step: one working-dtype
                # ulp of g is one of mu and two of nu.
                rel = (1 if key == "mu" else 2) * ULP[prec] + 1e-4
                for n, t in zip(names, moments):
                    assert t.dtype == torch.float32
                    assert _close(t, want[n], rel), (key, n)
    assert tstate.step == int(jstate.step) == 3
    assert tstate.optimizer.count == 3
    assert float(tstate.loss_scale) == float(jstate.loss_scale)
    assert int(tstate.good_steps) == int(jstate.good_steps)
    want = convert.from_flax(_np({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}), arch)
    got = tstate.model.state_dict()
    for k in want:
        assert got[k].dtype == torch.float32, k  # masters and statistics
        if k.endswith((".mean", ".var")):
            assert _close(got[k], want[k], 1e-4), k
    lr = tstate.optimizer.schedule
    bound = 2 * (lr(1) + lr(2)) + 1e-6
    for k in names:
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= bound, k
        assert float((diff <= 1e-5).float().mean()) >= 0.99, k


def _train_state_tensors(state):
    opt = state.optimizer
    return ([t.clone() for t in state.model.state_dict().values()]
            + [t.clone() for t in opt.mu + opt.nu])


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_loss_scale_skip_is_bitwise_and_scale_recovers(backend):
    """The port of the reference's test (tests/test_train.py): a step at
    loss scale 2^30 overflows fp16 and is skipped bitwise (parameters,
    moments, count and BN statistics), the step advances and the scale
    halves; stepping on, the scale halves until the backward is finite;
    one finite step at the growth interval doubles the scale (capped) and
    resets the streak."""
    cfg = get_config("smoke16", train_precision="fp16_scaled", global_batch=8)
    cfg = dataclasses.replace(cfg, arch=dataclasses.replace(cfg.arch,
                                                            conv_backend=backend))
    model = init_weights(FeatureNet(cfg.arch, R), 0)
    state = create_state(model, cfg)
    assert float(state.loss_scale) == precision.LOSS_SCALE_INIT
    step = steps.make_train_step()
    batch = {k: torch.from_numpy(v) for k, v in synthetic.to_wire(
        synthetic.generate_batch(np.random.default_rng(0), 8, R)).items()}
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    step(state, batch, gen())  # settle one step
    step(state, batch, gen())  # the rate is 0 at step 0; now parameters move

    state.loss_scale.fill_(2.0 ** 30)
    before, count, at = _train_state_tensors(state), state.optimizer.count, state.step
    m = step(state, batch, gen())
    assert float(m["grads_finite"]) == 0.0
    assert float(state.loss_scale) == float(m["loss_scale"]) == 2.0 ** 29
    assert int(state.good_steps) == 0
    assert state.step == at + 1 and state.optimizer.count == count
    for a, b in zip(before, _train_state_tensors(state)):
        assert torch.equal(a, b)

    for _ in range(24):
        m = step(state, batch, gen())
        if float(m["grads_finite"]) == 1.0:
            break
    assert float(m["grads_finite"]) == 1.0
    assert float(state.loss_scale) < 2.0 ** 29
    assert state.optimizer.count == count + 1

    # Growth, from a scale well inside fp16's range (the recovered one sits
    # at the edge of overflow, which the moved parameters may cross).
    scale = 2.0 ** 10
    state.loss_scale.fill_(scale)
    state.good_steps.fill_(precision.LOSS_SCALE_GROWTH_INTERVAL - 1)
    m = step(state, batch, gen())
    assert float(m["grads_finite"]) == 1.0
    assert float(state.loss_scale) == min(scale * 2.0, precision.LOSS_SCALE_MAX)
    assert int(state.good_steps) == 0
    state.loss_scale.fill_(precision.LOSS_SCALE_MAX)
    state.good_steps.fill_(precision.LOSS_SCALE_GROWTH_INTERVAL - 1)
    m = step(state, batch, gen())
    if float(m["grads_finite"]) == 1.0:  # capped, never above the max
        assert float(state.loss_scale) == precision.LOSS_SCALE_MAX
    assert float(state.loss_scale) <= precision.LOSS_SCALE_MAX


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 200, 8000), (1e-3, 10, 5),
                                               (1e-2, 0, 50)])
def test_device_schedule_matches_optax(peak, warmup, total):
    """The schedule the optimizer evaluates from its device count, over every
    warmup and decay step and past the end, against optax's
    ``warmup_cosine_decay_schedule`` (the JAX package's) on int32 counts."""
    counts = np.arange(total + 50, dtype=np.int32)
    want = np.asarray(jax_steps.make_lr_schedule(peak, warmup, total)(
        jnp.asarray(counts)))
    got = steps.make_lr_schedule(peak, warmup, total)(torch.from_numpy(counts))
    assert got.dtype == torch.float32 and got.shape == counts.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2 ** -23 * peak)
    assert float(got[0]) == (0.0 if warmup else float(np.float32(peak)))


@pytest.mark.parametrize("kind", ["adamw", "adam", "sgd"])
def test_the_device_verdict_applies_or_leaves_every_slot_bitwise(kind):
    """``Optimizer.update`` under a device verdict: ``False`` leaves the
    parameters, the moments and the 0-d int32 count bitwise; ``True`` is the
    update without a verdict, bitwise."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 3, 3)]

    def make():
        params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in shapes]
        return steps.Optimizer(params, kind, steps.make_lr_schedule(1e-2, 1, 10),
                               weight_decay=1e-2, grad_clip=0.5)

    def grads():
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in shapes]

    opt = make()
    assert opt.count.dtype == torch.int32 and opt.count.dim() == 0
    for _ in range(2):
        opt.update(grads())  # the rate is 0 at count 0; then slots move
    slots = lambda o: o.params + o.mu + o.nu  # noqa: E731
    before, count = [t.clone() for t in slots(opt)], opt.count
    opt.update(grads(), finite=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(before, slots(opt)))
    assert torch.equal(opt.count, count) and int(opt.count) == 2

    twin = make()
    for dst, src in zip(slots(twin), before):
        dst.copy_(src)
    twin.count = count
    g = grads()
    opt.update(g, finite=torch.tensor(True))
    twin.update(g)
    assert all(torch.equal(a, b) for a, b in zip(slots(opt), slots(twin)))
    assert int(opt.count) == int(twin.count) == 3
    assert not torch.equal(opt.params[0], before[0])


def test_bf16_master_step_does_not_touch_the_scale_state():
    cfg = get_config("smoke16", train_precision="bf16_master", global_batch=4)
    model = init_weights(FeatureNet(cfg.arch, R), 0)
    state = create_state(model, cfg)
    batch = {k: torch.from_numpy(v) for k, v in synthetic.to_wire(
        synthetic.generate_batch(np.random.default_rng(2), 4, R)).items()}
    m = steps.make_train_step()(state, batch)
    assert "loss_scale" not in m and "grads_finite" not in m
    assert float(state.loss_scale) == 1.0 and int(state.good_steps) == 0
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("rung", ["bf16", "int8"])
def test_eval_step_at_a_serving_rung_matches_jax(rung):
    jmodel, jstate, arch, tstate, batches = _setup("pallas", "fp32", seed=2)
    jeval = jax.jit(jax_steps.make_eval_step(jmodel, packed=True,
                                             serve_precision=rung))
    for batch in batches:
        want = jeval(jstate.params, jstate.batch_stats,
                     jax.tree_util.tree_map(jnp.asarray, batch))
        got = steps.eval_step(tstate.model, {k: torch.from_numpy(v)
                                             for k, v in batch.items()}, rung)
        assert float(got["correct"]) == float(want["correct"])
        np.testing.assert_allclose(float(got["loss_sum"]),
                                   float(want["loss_sum"]), rtol=1e-5)


@pytest.mark.parametrize("prec", ["bf16_master", "fp16_scaled"])
def test_trainer_runs_a_rung_and_logs_the_scale(prec):
    from featurenet_tpu_torch.train.loop import Trainer

    class Sink:
        def write(self, s):
            pass

        def flush(self):
            pass

    cfg = get_config("smoke16", global_batch=8, total_steps=2, log_every=1,
                     eval_every=2, eval_batches=1, train_precision=prec,
                     serve_precision="int8")
    tr = Trainer(cfg, device="cpu", stream=Sink())
    last = tr.run()
    train = [r for r in tr.logger.history if r["kind"] == "train"]
    assert len(train) == 2 and all(np.isfinite(r["loss"]) for r in train)
    if prec == "fp16_scaled":
        assert all({"loss_scale", "grads_finite"} <= set(r) for r in train)
        assert train[-1]["loss_scale"] == float(tr.state.loss_scale)
    assert 0.0 <= last["eval_accuracy"] <= 1.0
    assert tr.state.precision == prec
