"""The port's ``FeatureNet`` against the JAX ``FeatureNet`` with bridged
weights (``convert.from_flax``), at narrow widths and R=16.

fp32 on both sides agrees within 1e-4: the same math, sums in another
order. In bf16 both frameworks round activations to 8 mantissa bits at
every block boundary but at slightly different places (PyTorch's
``F.linear`` adds the bias before rounding, XLA rounds the product first;
XLA and PyTorch convs accumulate in different orders), so a value near a
rounding boundary lands one bf16 ulp (2^-8 relative) apart and the
difference carries through the stack. The bf16 case is held to 2e-2, a
few bf16 ulps of logits of order 1 (at these sizes and seeds the two
agreed exactly).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import PRESETS, get_config
from featurenet_tpu_torch.models.featurenet import FeatureNet, FeatureNetArch

R = 16
# sprint64's structure (5³/s4 stem, three stride-1 3³ blocks, one pool):
# the flatten sees 2³ voxels, so NDHWC order matters.
SPRINT = dict(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
              strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
              hidden=32)
# pod64's structure (7³/s2 stem, 5³ conv2, two pools).
POD = dict(features=(8, 8, 16, 16), kernels=(7, 5, 3, 3),
           strides=(2, 1, 1, 1), pool_after=(False, True, False, True),
           hidden=32)
# abc128's head: global average pool and residual skips.
GAP = dict(features=(8, 8, 8), kernels=(3, 3, 3), strides=(2, 1, 1),
           pool_after=(False, True, False), hidden=16, head_gap=True,
           residual=True)


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _jax_variables(model, x, seed):
    """Flax init, then batch-norm statistics and affine made non-trivial
    so the bridge's BN mapping is exercised."""
    v = _to_numpy(model.init({"params": jax.random.key(seed)},
                             jnp.asarray(x), train=False))
    rng = np.random.default_rng(seed)
    for name, scope in v["params"].items():
        if "BatchNorm_0" not in scope:
            continue
        bn, st = scope["BatchNorm_0"], v["batch_stats"][name]["BatchNorm_0"]
        n = bn["scale"].shape[0]
        bn["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        bn["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
        st["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return v


def _logits_both(arch_kw, backend, jdtype, tdtype, seed=0,
                 port_backend="pallas"):
    rng = np.random.default_rng(seed)
    x = (rng.random((3, R, R, R, 1)) > 0.5).astype(np.float32)
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend=backend, **arch_kw),
                           dtype=jdtype)
    v = _jax_variables(jmodel, x, seed)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x), train=False))
    arch = FeatureNetArch(conv_backend=port_backend, **arch_kw)
    tmodel = FeatureNet(arch, R, dtype=tdtype)
    tmodel.load_state_dict(convert.from_flax(v, arch))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("arch_kw,backend", [
    (SPRINT, "pallas"),
    (POD, "pallas"),
    (GAP, "pallas"),
    (SPRINT, "xla"),        # Conv_0 scopes
    (SPRINT, "hybrid_dw"),  # HybridConv_0 scopes
], ids=["sprint-pallas", "pod-pallas", "gap-pallas", "sprint-xla",
        "sprint-hybrid"])
def test_fp32_logits_match_jax(arch_kw, backend):
    got, want = _logits_both(arch_kw, backend, jnp.float32, torch.float32)
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 24)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_logits_match_jax():
    got, want = _logits_both(SPRINT, "pallas", jnp.bfloat16, torch.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch_kw", [SPRINT, POD, GAP], ids=["sprint", "pod", "gap"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_xla_logits_match_jax_xla(arch_kw, dtype):
    """The port's ``xla`` lowering (``F.conv3d`` in the activation dtype)
    against the JAX default (``nn.Conv``), with the tolerances above."""
    jdtype, tdtype, tol = {"fp32": (jnp.float32, torch.float32, 1e-4),
                           "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]
    got, want = _logits_both(arch_kw, "xla", jdtype, tdtype, port_backend="xla")
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 24)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_flatten_order_is_ndhwc():
    """Permuting Dense_0's rows out of (d,h,w,c) order must change the
    logits: the bridge relies on the port flattening NDHWC."""
    rng = np.random.default_rng(3)
    x = (rng.random((2, R, R, R, 1)) > 0.5).astype(np.float32)
    jmodel = JaxFeatureNet(arch=JaxArch(conv_backend="pallas", **SPRINT),
                           dtype=jnp.float32)
    v = _jax_variables(jmodel, x, 3)
    arch = FeatureNetArch(**SPRINT)
    state = convert.from_flax(v, arch)
    w = state["dense0.weight"]  # [hidden, 2*2*2*16], columns (d,h,w,c)
    ncdhw = w.reshape(-1, 2, 2, 2, 16).permute(0, 4, 1, 2, 3).reshape(w.shape)
    tmodel = FeatureNet(arch, R, dtype=torch.float32)
    want = np.asarray(jmodel.apply(v, jnp.asarray(x), train=False))
    tmodel.load_state_dict({**state, "dense0.weight": ncdhw.contiguous()})
    with torch.no_grad():
        wrong = tmodel(torch.from_numpy(x)).numpy()
    assert not np.allclose(wrong, want, rtol=1e-4, atol=1e-4)


def test_converter_scopes_and_transpose():
    rng = np.random.default_rng(0)
    arch = FeatureNetArch(**SPRINT)
    x = np.zeros((1, R, R, R, 1), np.float32)
    v = _jax_variables(JaxFeatureNet(arch=JaxArch(conv_backend="pallas", **SPRINT),
                                     dtype=jnp.float32), x, 0)
    params = v["params"]
    assert "SpaceToDepthConv_0" in params["ConvBNRelu_0"]
    assert all("PallasConv_0" in params[f"ConvBNRelu_{i}"] for i in (1, 2, 3))
    state = convert.from_flax(v, arch)
    np.testing.assert_array_equal(state["dense0.weight"].numpy(),
                                  params["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(state["blocks.2.conv.kernel"].numpy(),
                                  params["ConvBNRelu_2"]["PallasConv_0"]["kernel"])
    assert set(state) == set(FeatureNet(arch, R).state_dict())
    # Two conv scopes in one block is ambiguous, none is missing: both raise.
    bad = params["ConvBNRelu_1"]
    bad["Conv_0"] = {"kernel": rng.standard_normal((3, 3, 3, 8, 8))}
    with pytest.raises(KeyError):
        convert.from_flax(v, arch)
    del bad["Conv_0"], bad["PallasConv_0"]
    with pytest.raises(KeyError):
        convert.from_flax(v, arch)


def test_npz_round_trip(tmp_path):
    from featurenet_tpu_torch.runtime import build_model

    cfg = get_config("smoke16")
    state = build_model(cfg, seed=7).state_dict()
    path = str(tmp_path / "w.npz")
    convert.save_npz(path, state, cfg)
    got, cfg2 = convert.load_npz(path)
    assert cfg2 == cfg
    assert set(got) == set(state)
    for k in state:
        assert torch.equal(got[k], state[k].float())


def test_seed_init_is_deterministic_and_lecun_scaled():
    from featurenet_tpu_torch.runtime import build_model

    cfg = get_config("sprint64")
    a = build_model(cfg, seed=1).state_dict()
    b = build_model(cfg, seed=1).state_dict()
    c = build_model(cfg, seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.3.conv.kernel"], c["blocks.3.conv.kernel"])
    k = a["blocks.3.conv.kernel"]  # 3³·64 fan-in
    assert abs(float(k.std()) - (27 * 64) ** -0.5) < 0.1 * (27 * 64) ** -0.5


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_presets_match_jax(name):
    """Every ported preset serves the JAX preset's model identity and
    carries its training recipe. ``arch.conv_backend`` is left out: the
    JAX package itself does not count it as identity (a lowering, not a
    model; ``config._identity_view``), and the port's presets keep
    "pallas" where the JAX ones say "xla"."""
    from featurenet_tpu.config import get_config as jax_get_config

    j, t = jax_get_config(name), get_config(name)
    assert (t.name, t.task, t.resolution, t.serve_precision, t.seed) == \
        (j.name, j.task, j.resolution, j.serve_precision, j.seed)
    def norm(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    ja = dataclasses.asdict(j.arch)
    for field, value in dataclasses.asdict(t.arch).items():
        if field != "conv_backend":
            assert norm(value) == norm(ja[field]), field
    assert ja["stem_s2d"]  # the port computes strided convs via s2d only
    for field in ("global_batch", "num_features", "eval_batches",
                  "data_workers", "optimizer", "peak_lr", "weight_decay",
                  "warmup_steps", "total_steps", "label_smoothing",
                  "grad_clip", "train_precision", "log_every", "eval_every",
                  "data_cache", "hbm_cache", "augment_affine",
                  "augment_noise", "steps_per_dispatch", "checkpoint_dir",
                  "checkpoint_every", "keep_checkpoints", "init_from"):
        assert getattr(t, field) == getattr(j, field), field
