"""The packed voxel cache and cache-backed training of the port against the
JAX package on the CPU.

Caches are written at R=16 with 3 parts per class from numpy seeds.
Tolerances, each with its reason:

- the cache files, the splits, every batch the datasets give and the
  resident split are integer data made by the same numpy calls: bitwise;
- the resident train step against JAX ``make_hbm_multi_train_step``: the
  same draws (indices and rotation codes computed from the reference's key
  derivation) through fp32 models, so the tolerances of
  ``tests/test_torch_train.py::test_train_steps_match_jax``. The JAX model
  lowers its convs through XLA, its default (the Pallas kernels' parity
  is that test's), and the port's through ``pallas``, its main path;
- a CPU Trainer run against itself (twice, and resumed from a
  checkpoint): bitwise.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from featurenet_tpu.config import Config as JaxConfig
from featurenet_tpu.data import offline as jax_offline
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
from featurenet_tpu.parallel.mesh import make_mesh
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import Config, get_config
from featurenet_tpu_torch.data import dataset, offline
from featurenet_tpu_torch.models.featurenet import FeatureNet, FeatureNetArch
from featurenet_tpu_torch.train import steps
from featurenet_tpu_torch.train.loop import Trainer, evaluate
from featurenet_tpu_torch.train.state import create_state

R = 16
PER_CLASS = 3
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """The same cache written by each package (seed 3)."""
    root = tmp_path_factory.mktemp("caches")
    port, ref = str(root / "port"), str(root / "jax")
    offline.export_synthetic_cache(port, per_class=PER_CLASS, resolution=R, seed=3)
    jax_offline.export_synthetic_cache(ref, per_class=PER_CLASS, resolution=R, seed=3)
    return port, ref


# --- the cache files ------------------------------------------------------------

def test_export_writes_the_reference_bytes(caches):
    port, ref = caches
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names and len(names) == 2 * 24 + 1
    for name in names:
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(port, "index.json")) as a, \
            open(os.path.join(ref, "index.json")) as b:
        assert json.load(a) == json.load(b)


@pytest.mark.parametrize("written_by", ["port", "jax"])
def test_each_package_loads_the_others_cache(caches, written_by):
    root = caches[0] if written_by == "port" else caches[1]
    t = offline.VoxelCacheDataset(root, 8, "train")
    j = jax_offline.VoxelCacheDataset(root, 8, "train")
    np.testing.assert_array_equal(t.labels, j.labels)
    idx = np.arange(len(t))
    np.testing.assert_array_equal(t._gather(idx), j._gather(idx))


# --- the datasets ---------------------------------------------------------------

@pytest.mark.parametrize("split,augment", [("train", False), ("train", True),
                                           ("test", False)])
def test_cache_dataset_matches_jax(caches, split, augment):
    kw = dict(global_batch=8, split=split, test_fraction=0.2, seed=5,
              augment=augment)
    t = offline.VoxelCacheDataset(caches[0], **kw)
    j = jax_offline.VoxelCacheDataset(caches[0], **kw)
    assert len(t) == len(j) == 24 * (2 if split == "train" else 1)
    np.testing.assert_array_equal(t.rows, j.rows)
    np.testing.assert_array_equal(t.labels, j.labels)
    for w in (0, 2):
        got, want = t.worker_iter(w), j.worker_iter(w, 3)
        for _ in range(2):
            a, b = next(got), next(want)
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(t.epoch_batches(7), j.epoch_batches(7), strict=True):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    got, want = t.materialize_split(), j.materialize_split()
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], t._gather(t.resident_order()))


def test_legacy_npz_cache_is_packed_at_open(tmp_path, caches):
    """An unpacked ``.npz`` cache (no ``storage`` field) loads packed, as
    in the reference."""
    src = offline.VoxelCacheDataset(caches[0], 4, "train")
    index = json.load(open(os.path.join(caches[0], "index.json")))
    for cls in index["classes"]:
        packed = np.load(os.path.join(caches[0], f"{cls}.npy"))
        np.savez_compressed(str(tmp_path / f"{cls}.npz"),
                            voxels=np.unpackbits(packed, axis=-1).astype(np.float32))
    del index["storage"]
    json.dump(index, open(tmp_path / "index.json", "w"))
    t = offline.VoxelCacheDataset(str(tmp_path), 4, "train")
    j = jax_offline.VoxelCacheDataset(str(tmp_path), 4, "train")
    idx = np.arange(len(t))
    np.testing.assert_array_equal(t._gather(idx), src._gather(idx))
    np.testing.assert_array_equal(t._gather(idx), j._gather(idx))


def test_cache_without_label_ids_is_refused_when_out_of_order(tmp_path, caches):
    index = json.load(open(os.path.join(caches[0], "index.json")))
    for cls in index["classes"]:
        os.symlink(os.path.join(caches[0], f"{cls}.npy"), tmp_path / f"{cls}.npy")
    del index["label_ids"]
    json.dump(index, open(tmp_path / "index.json", "w"))
    ordered = offline.VoxelCacheDataset(str(tmp_path), 4)
    np.testing.assert_array_equal(ordered.labels,
                                  offline.VoxelCacheDataset(caches[0], 4).labels)
    index["classes"] = index["classes"][::-1]
    json.dump(index, open(tmp_path / "index.json", "w"))
    os.utime(tmp_path / "index.json", (1, 1))  # a new memo key
    with pytest.raises(ValueError, match="predates the label_ids"):
        offline.VoxelCacheDataset(str(tmp_path), 4)


def test_trainer_refuses_labels_the_head_cannot_express(tmp_path, caches):
    index = json.load(open(os.path.join(caches[0], "index.json")))
    for cls in index["classes"]:
        os.symlink(os.path.join(caches[0], f"{cls}.npy"), tmp_path / f"{cls}.npy")
    index["label_ids"]["chamfer"] = 30
    json.dump(index, open(tmp_path / "index.json", "w"))
    cfg = get_config("smoke16", data_cache=str(tmp_path), global_batch=8)
    with pytest.raises(ValueError, match="label id 30.*num_classes=24"):
        Trainer(cfg, device="cpu")


def test_prefetcher_streams_a_cache_in_ticket_order(caches):
    ds = offline.VoxelCacheDataset(caches[0], 4, seed=2)
    pf = dataset.Prefetcher(ds, "cpu", num_workers=3)
    try:
        out = [next(pf) for _ in range(6)]
    finally:
        pf.close()
    iters = [ds.worker_iter(w) for w in range(3)]
    for ticket, batch in enumerate(out):
        want = next(iters[ticket % 3])
        for k in want:
            np.testing.assert_array_equal(batch[k].numpy(), want[k])


# --- the resident step ------------------------------------------------------------

SPRINT = dict(features=(8, 8, 16, 16), kernels=(5, 3, 3, 3),
              strides=(4, 1, 1, 1), pool_after=(False, False, False, True),
              hidden=32, dropout=0.0)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def test_resident_step_matches_jax_hbm_step(caches):
    """Three steps of ``make_hbm_multi_train_step(num_steps=1)`` on a
    one-device mesh with 8 rotation groups against the port's resident
    step fed the same row indices and codes."""
    batch, groups, draw_stream = 8, 8, 0x5A11
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

    voxels, labels, n = offline.VoxelCacheDataset(caches[0], batch, seed=1).materialize_split()
    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    sh = NamedSharding(mesh, P("data"))
    jdata, jlabels = jax.device_put(voxels, sh), jax.device_put(labels, sh)
    jstep = jax.jit(jax_steps.make_hbm_multi_train_step(
        jmodel, mesh, batch, augment_groups=groups, num_steps=1))
    tstep = steps.make_resident_train_step(augment_groups=groups)
    tdata, tlabels = torch.from_numpy(voxels), torch.from_numpy(labels)
    rng = jax.random.key(7)
    for s in range(3):
        # The reference's draw key and its step's augmentation key.
        dkey = jax.random.fold_in(jax.random.fold_in(rng, s), draw_stream)
        idx = jax.random.randint(jax.random.fold_in(dkey, 0), (batch,), 0, n)
        aug = jax.random.split(jax.random.fold_in(rng, s), 3)[1]
        codes = jax.random.randint(aug, (groups,), 0, 24).tolist()
        jstate, jm = jstep(jstate, jdata, jlabels, rng)
        tm = tstep(tstate, tdata, tlabels, torch.from_numpy(np.array(idx)),
                   None, codes)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
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


def test_resident_step_gathers_the_drawn_rows(caches):
    voxels, labels, n = offline.VoxelCacheDataset(caches[0], 8, seed=1).materialize_split()
    g = torch.Generator().manual_seed(0)
    idx = steps.draw_rows(g, n, 8)
    assert idx.dtype == torch.int64 and 0 <= int(idx.min()) and int(idx.max()) < n
    batch = steps.gather_rows(torch.from_numpy(voxels), torch.from_numpy(labels), idx)
    np.testing.assert_array_equal(batch["voxels"].numpy(), voxels[idx.numpy()])
    np.testing.assert_array_equal(batch["label"].numpy(), labels[idx.numpy()])
    step = steps.make_resident_train_step(augment_groups=8)
    with pytest.raises(ValueError, match="rotates 8 groups"):
        step(None, torch.from_numpy(voxels), torch.from_numpy(labels), idx)


# --- the Trainer ------------------------------------------------------------------

def _state(tr: Trainer) -> dict:
    opt = tr.state.optimizer
    return {"model": {k: v.clone() for k, v in tr.state.model.state_dict().items()},
            "moments": [t.clone() for t in opt.mu + opt.nu],
            "counts": (opt.count, tr.state.step)}


def _same(a: dict, b: dict) -> bool:
    return (a["counts"] == b["counts"]
            and all(torch.equal(a["model"][k], b["model"][k]) for k in a["model"])
            and all(torch.equal(x, y) for x, y in zip(a["moments"], b["moments"])))


@pytest.mark.parametrize("resident", [True, False])
def test_cache_training_is_deterministic_and_resumes(caches, tmp_path, resident):
    """Two runs of 4 steps agree bitwise. A run that stops at a checkpoint
    after step 2 and is resumed by a fresh Trainer ends at step 4; resident,
    it draws what the unbroken run drew and agrees with it bitwise
    (streamed, its producers start again at their seeds, as the
    reference's do)."""
    kw = dict(data_cache=caches[0], hbm_cache=resident, global_batch=8,
              log_every=2, eval_every=100, data_workers=2)
    sink = open(os.devnull, "w")
    first = Trainer(get_config("smoke16", total_steps=4, **kw), device="cpu",
                    stream=sink)
    first.run()
    again = Trainer(get_config("smoke16", total_steps=4, **kw), device="cpu",
                    stream=sink)
    again.run()
    assert _same(_state(first), _state(again))
    assert first.cfg.device_augment and first._groups == 8
    ck = str(tmp_path / "ck")
    cut = Trainer(get_config("smoke16", total_steps=2, checkpoint_dir=ck,
                             checkpoint_every=2, **kw), device="cpu", stream=sink)
    cut.run()
    resumed = Trainer(get_config("smoke16", total_steps=4, checkpoint_dir=ck,
                                 checkpoint_every=2, **kw), device="cpu",
                      stream=sink)
    resumed.run()
    assert resumed.ckpt.restored_step == 2 and resumed.state.step == 4
    if resident:
        assert _same(_state(first), _state(resumed))
    setup = first.logger.history[0]
    assert setup["kind"] == "setup"
    if resident:
        assert setup["hbm_resident_rows"] == 48 and "hbm_resident_mb" in setup
    else:
        assert "hbm_resident_rows" not in setup


def test_host_augmentation_streams_rotated_samples(caches):
    """``augment_device=False`` on a streamed cache rotates on the host
    and builds a step without rotation codes."""
    cfg = get_config("smoke16", data_cache=caches[0], augment_device=False,
                     global_batch=8, total_steps=2, eval_every=100, data_workers=1)
    tr = Trainer(cfg, device="cpu", stream=open(os.devnull, "w"))
    assert not cfg.device_augment and tr.train_data.augment and tr._groups == 0
    assert np.isfinite(tr.run()["loss"])


def test_exact_eval_pass_counts_every_held_out_row_once(caches):
    """Batches of 5 over the 24 held-out rows (the last padded with 1 masked
    row) give the sums of one unpadded batch of 24."""
    cfg = get_config("smoke16", data_cache=caches[0], global_batch=5)
    tr = Trainer(cfg, device="cpu", stream=open(os.devnull, "w"))
    ev = tr.evaluate()
    assert (ev["samples"], ev["batches"]) == (len(tr.eval_data), 5) == (24, 5)
    assert sum(map(sum, ev["confusion"])) == 24
    whole = offline.VoxelCacheDataset(caches[0], 24, "test")
    one = evaluate(tr.state.model, whole, 0, "cpu")
    assert one["batches"] == 1 and one["confusion"] == ev["confusion"]
    np.testing.assert_allclose(one["loss"], ev["loss"], rtol=1e-6)


def test_cli_export_data_then_train_resident_on_cpu(tmp_path):
    cache, ck = str(tmp_path / "c"), str(tmp_path / "ck")
    cli = [sys.executable, "-m", "featurenet_tpu_torch.cli"]
    out = subprocess.run(cli + ["export-data", "--out", cache, "--per-class", "2",
                                "--resolution", "16", "--seed", "4"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    exported = json.loads(out.stdout)
    assert exported["exported"] == {c: 2 for c in exported["exported"]}
    assert len(exported["exported"]) == 24 and exported["mesh_pose"] == "none"
    out = subprocess.run(cli + ["train", "--config", "smoke16", "--device", "cpu",
                                "--data-cache", cache, "--hbm-cache",
                                "--global-batch", "8", "--total-steps", "2",
                                "--checkpoint-dir", ck],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    records = [json.loads(line) for line in out.stdout.splitlines()]
    cfg = records[0]["config"]
    assert cfg["data_cache"] == cache and cfg["hbm_cache"] is True
    kinds = {r["kind"]: r for r in records[1:]}
    assert kinds["setup"]["hbm_resident_rows"] == 24
    assert np.isfinite(kinds["train"]["loss"]) and kinds["eval"]["samples"] == 24
    out = subprocess.run(cli + ["eval", "--device", "cpu", "--checkpoint-dir", ck],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ev = json.loads(out.stdout.splitlines()[-1])["eval"]
    assert (ev["accuracy"], ev["loss"]) == (kinds["eval"]["accuracy"],
                                            kinds["eval"]["loss"])
    assert ev["samples"] == 24


# --- the STL-tree build and the export modes ----------------------------------
# The reference builds and exports through its numpy voxelizer (never its
# native build); the port through its native library under "auto". The
# native parity fill is bitwise numpy's on these watertight meshes
# (tests/test_torch_native.py), so every file is held bitwise.

def _same_cache(a: str, b: str):
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            if name == "index.json":
                assert json.load(fa) == json.load(fb)
            else:
                assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def stl_tree(tmp_path_factory):
    from featurenet_tpu_torch.data.voxel_to_mesh import export_stl_tree

    root = str(tmp_path_factory.mktemp("stl") / "tree")
    export_stl_tree(root, per_class=1, resolution=R, seed=5)
    return root


def test_build_cache_is_the_reference_whatever_the_workers(stl_tree, tmp_path):
    port1, port2, ref = (str(tmp_path / n) for n in ("w1", "w2", "jax"))
    got = offline.build_cache(stl_tree, port1, resolution=R, workers=1)
    assert offline.build_cache(stl_tree, port2, resolution=R, workers=2) == got
    want = jax_offline.build_cache(stl_tree, ref, resolution=R, workers=1,
                                   backend="numpy")
    assert got == want
    assert got["label_ids"] == {c: i for i, c in enumerate(offline.CLASS_NAMES)}
    assert got["counts"] == {c: 1 for c in offline.CLASS_NAMES}
    assert len(os.listdir(port1)) == 2 * 24 + 1
    _same_cache(port1, port2)
    _same_cache(port1, ref)
    # The tree's parts through the mesh pipeline: the remesh export of the
    # same seed.
    remesh = str(tmp_path / "remesh")
    offline.export_synthetic_cache(remesh, per_class=1, resolution=R, seed=5,
                                   mesh_pose="remesh")
    for cls in offline.CLASS_NAMES:
        np.testing.assert_array_equal(
            np.load(os.path.join(port1, f"{cls}.npy")),
            np.load(os.path.join(remesh, f"{cls}.npy")))


def test_export_modes_write_the_reference_bytes(tmp_path, monkeypatch):
    import importlib

    jax_voxelize = importlib.import_module("featurenet_tpu.data.voxelize")
    numpy_only = jax_voxelize.voxelize
    monkeypatch.setattr(jax_voxelize, "voxelize",
                        lambda *a, **kw: numpy_only(*a, backend="numpy", **kw))
    kw = dict(per_class=1, resolution=R, seed=2, param_range="mid",
              mesh_pose="so3", margin_jitter=(0.04, 0.08))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    got = offline.export_synthetic_cache(port, **kw)
    want = jax_offline.export_synthetic_cache(ref, **kw)
    assert got == want
    assert (got["param_range"], got["mesh_pose"], got["margin_jitter"]) == \
        ("mid", "so3", [0.04, 0.08])
    _same_cache(port, ref)
    with pytest.raises(ValueError, match="mesh_pose"):
        offline.export_synthetic_cache(port, per_class=1, resolution=R,
                                       mesh_pose="tilted")


def test_build_cache_gives_unknown_class_dirs_ids_after_the_canonical(tmp_path):
    from featurenet_tpu_torch.data.mesh_primitives import mesh_box
    from featurenet_tpu_torch.data.stl import save_stl

    tree = tmp_path / "tree"
    for d in ("zz_custom", "chamfer", "aa_custom", "o_ring"):
        (tree / d).mkdir(parents=True)
        save_stl(str(tree / d / "p.stl"), mesh_box())
    with pytest.warns(UserWarning, match="non-canonical"):
        got = offline.build_cache(str(tree), str(tmp_path / "port"),
                                  resolution=8, workers=1)
    want = jax_offline.build_cache(str(tree), str(tmp_path / "jax"),
                                   resolution=8, workers=1, backend="numpy")
    assert got == want
    assert got["classes"] == ["o_ring", "chamfer", "aa_custom", "zz_custom"]
    assert got["label_ids"] == {"o_ring": 0, "chamfer": 18, "aa_custom": 24,
                                "zz_custom": 25}
    _same_cache(str(tmp_path / "port"), str(tmp_path / "jax"))
