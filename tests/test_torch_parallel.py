"""The port's data axis (``featurenet_tpu_torch/parallel/mesh.py``) and its
host-sharded feeds against the JAX package's, in one process on the CPU.

- ``make_mesh``, ``mesh_summary``, ``feed_shards`` and ``clamp_model_axis``
  against the reference's on the same layouts: the 8 virtual CPU devices,
  and multi-process layouts of fake devices (an object with a
  ``process_index``, the only attribute the reference's ``feed_shards``
  and ``mesh_summary`` read), with ``jax.process_index`` patched to each
  process in turn;
- ``SyntheticVoxelDataset``, ``VoxelCacheDataset`` and ``SegCacheDataset``
  streams, exact-pass shards and resident blocks at ``num_hosts=2``,
  ``host_id`` 0 and 1, bit for bit the reference's (the same numpy calls);
- the mesh fields of ``Config``: round trip, a ``config.json`` without
  them, the JAX presets' values, the refusals, and a checkpoint trained
  with a pod-scale mesh serving on one device.

The two-process world itself is ``tests/test_torch_multiproc.py``.
"""

import dataclasses
import json
import types

import jax
import numpy as np
import pytest
import torch

from featurenet_tpu.config import config_to_dict as jax_config_to_dict
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.data import dataset as jax_dataset
from featurenet_tpu.data import offline as jax_offline
from featurenet_tpu.parallel import mesh as jax_mesh
from featurenet_tpu_torch.config import (
    Config,
    check_identity,
    config_from_dict,
    config_to_dict,
    get_config,
)
from featurenet_tpu_torch.data import dataset, offline
from featurenet_tpu_torch.parallel import mesh

R = 16


def _fake_jax_mesh(devices, data, model):
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[:data * model]
    grid = grid.reshape(data, model)
    return types.SimpleNamespace(devices=grid, axis_names=("data", "model"),
                                 shape={"data": data, "model": model})


def _fake_devices(hosts: int, per_host: int):
    """Process-major fake devices, as ``jax.devices()`` orders a pod."""
    return [types.SimpleNamespace(process_index=p, id=p * per_host + i)
            for p in range(hosts) for i in range(per_host)]


@pytest.mark.parametrize("data,model", [(None, 1), (None, 2), (2, 2), (4, 1),
                                        (None, 3), (5, 2)])
def test_make_mesh_and_summary_match_reference(data, model):
    devs = jax.devices()
    port_devs = [mesh.MeshDevice(d.process_index, str(d)) for d in devs]
    try:
        want = jax_mesh.make_mesh(data, model)
    except ValueError:
        with pytest.raises(ValueError):
            mesh.make_mesh(data, model, devices=port_devs)
        return
    got = mesh.make_mesh(data, model, devices=port_devs)
    assert got.shape == dict(want.shape)
    assert mesh.mesh_summary(got) == jax_mesh.mesh_summary(want)
    assert [d.device for d in got.devices.flat] == [str(d) for d in want.devices.flat]


# (hosts, devices per host, data, model): one distinct row group per host;
# a model axis inside each host; a model axis spanning hosts (hosts share a
# row group); a subset mesh that leaves hosts out.
LAYOUTS = [(2, 1, None, 1), (4, 2, None, 1), (4, 2, None, 2), (4, 2, None, 4),
           (2, 4, None, 2), (4, 1, 2, 1), (3, 2, None, 3)]


@pytest.mark.parametrize("hosts,per_host,data,model", LAYOUTS)
def test_feed_shards_and_summary_match_reference(monkeypatch, hosts, per_host,
                                                 data, model):
    fakes = _fake_devices(hosts, per_host)
    n = len(fakes)
    d = data if data is not None else n // model
    want_mesh = _fake_jax_mesh(fakes, d, model)
    got_mesh = mesh.make_mesh(data, model, devices=[
        mesh.MeshDevice(f.process_index, f"dev{f.id}") for f in fakes])
    summary = mesh.mesh_summary(got_mesh)
    assert summary == jax_mesh.mesh_summary(want_mesh)
    for p in range(hosts):
        monkeypatch.setattr(jax, "process_index", lambda p=p: p)
        try:
            want = jax_mesh.feed_shards(want_mesh)
        except ValueError as e:
            with pytest.raises(ValueError):
                mesh.feed_shards(got_mesh, p)
            assert "owns no devices" in str(e) or "row" in str(e)
            continue
        assert mesh.feed_shards(got_mesh, p) == want, (p, want)
        lo, hi = mesh.row_block(got_mesh, 8 * want[0], p)
        assert (lo, hi) == (8 * want[1], 8 * want[1] + 8)


def test_feed_shards_refuses_a_non_contiguous_block():
    devs = [mesh.MeshDevice(p) for p in (0, 1, 0, 1)]
    m = mesh.make_mesh(4, 1, devices=devs)
    with pytest.raises(ValueError, match="non-contiguous"):
        mesh.feed_shards(m, 0)


def test_clamp_model_axis_matches_reference():
    for model in range(1, 17):
        for n in range(1, 13):
            assert mesh.clamp_model_axis(model, n) == \
                jax_mesh.clamp_model_axis(model, n), (model, n)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            mesh.clamp_model_axis(bad, 8)
        with pytest.raises(ValueError):
            jax_mesh.clamp_model_axis(bad, 8)


def test_one_process_mesh_has_no_backend_and_no_collective():
    assert mesh.rank_world() == (0, 1) and not mesh.in_world()
    m = mesh.train_mesh(get_config("smoke16"))
    assert mesh.mesh_summary(m) == {"data": 1, "model": 1, "devices": 1,
                                    "processes": 1}
    assert mesh.feed_shards(m) == (1, 0)


def test_abc128_model_axis_clamps_to_one_process(capsys):
    cfg = get_config("abc128")
    assert (cfg.mesh_model, cfg.spatial) == (2, True)
    m = mesh.train_mesh(cfg)
    assert m.shape == {"data": 1, "model": 1}
    warning = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert "mesh_model=2" in warning["mesh_warning"]


@pytest.mark.parametrize("over,match", [
    (dict(mesh_model=2, task="segment"), "task='segment'"),
    (dict(mesh_model=2, spatial=True, resolution=48, arch=dataclasses.replace(
        get_config("abc128").arch, conv_backend="pallas")), "split evenly"),
])
def test_a_model_axis_above_one_is_refused(monkeypatch, over, match):
    """In a world of two processes a model axis of 2 survives the clamp;
    what is still refused on it is a segmenter, and a depth that the model
    axis cannot split evenly at every pool (abc128's arch at 48³: 24 planes
    a slab, 6 at its third pool), while the same depth at model 1 and the
    model axis without spatial pass."""
    monkeypatch.setattr(mesh, "rank_world", lambda: (0, 2))
    with pytest.raises(ValueError, match=match):
        mesh.train_mesh(get_config("smoke16", **over))
    m = mesh.train_mesh(get_config("smoke16"))
    assert m.shape == {"data": 2, "model": 1}
    m = mesh.train_mesh(get_config("smoke16", **{**over, "mesh_model": 1}))
    assert m.shape == {"data": 2, "model": 1}
    if over.get("spatial"):
        m = mesh.train_mesh(get_config("smoke16", **{**over, "spatial": False}))
        assert m.shape == {"data": 1, "model": 2}


def test_train_program_refuses_a_multi_process_mesh():
    from featurenet_tpu_torch.runtime.registry import TrainProgram

    two = mesh.make_mesh(devices=[mesh.MeshDevice(0), mesh.MeshDevice(1)])
    with pytest.raises(ValueError, match="2 processes is not ported"):
        TrainProgram("multi_train_step", lambda: {}, None, [],
                     torch.device("cpu"), mesh=two)


# --- Config --------------------------------------------------------------

def test_mesh_fields_round_trip_and_are_not_identity():
    cfg = get_config("pod64", mesh_data=2, mesh_model=1, spatial=False)
    back = config_from_dict(json.loads(json.dumps(config_to_dict(cfg))))
    assert back == cfg and back.mesh_data == 2
    pod = get_config("pod64", mesh_data=4, mesh_model=2)
    check_identity(pod, get_config("pod64"))  # run policy, not identity


def test_config_json_without_mesh_fields_loads_with_defaults():
    d = config_to_dict(get_config("sprint64"))
    for k in ("mesh_data", "mesh_model", "spatial"):
        del d[k]
    cfg = config_from_dict(d)
    assert (cfg.mesh_data, cfg.mesh_model, cfg.spatial) == (None, 1, False)


@pytest.mark.parametrize("name", ["abc128", "pod64"])
def test_jax_mesh_fields_load(name):
    jcfg = jax_get_config(name, mesh_data=2)
    d = json.loads(json.dumps(jax_config_to_dict(jcfg), default=str))
    cfg = config_from_dict(d)
    assert (cfg.mesh_data, cfg.mesh_model, cfg.spatial) == \
        (jcfg.mesh_data, jcfg.mesh_model, jcfg.spatial)


def test_mesh_field_refusals_match_reference():
    with pytest.raises(ValueError, match="spatial"):
        Config(data_cache="c", hbm_cache=True, spatial=True).validate()
    with pytest.raises(ValueError, match="spatial"):
        jax_get_config("smoke16", data_cache="c", hbm_cache=True, spatial=True)
    with pytest.raises(ValueError, match="mesh axes"):
        Config(mesh_model=0).validate()


def test_pod_mesh_checkpoint_serves_on_one_device(tmp_path):
    """A checkpoint whose config.json carries a pod-scale mesh restores and
    serves on one device, with the probabilities of its weights."""
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.loop import Trainer

    ck = str(tmp_path / "ck")
    cfg = get_config("smoke16", global_batch=4, checkpoint_dir=ck)
    tr = Trainer(cfg, device="cpu")
    tr.ckpt.save(tr.state)
    tr.ckpt.close()
    path = tmp_path / "ck" / "config.json"
    saved = json.loads(path.read_text())
    saved.update(mesh_data=4, mesh_model=2, spatial=True)
    path.write_text(json.dumps(saved))
    pred = Predictor.from_checkpoint(ck, device="cpu", batch=2)
    assert (pred.cfg.mesh_model, pred.cfg.spatial) == (2, True)
    grids = np.random.default_rng(0).random((2, R, R, R)) > 0.5
    _, probs = pred.predict_voxels(grids.astype(np.float32))
    ref = Predictor(tr.state.model.state_dict(), get_config("smoke16"),
                    batch=2, device="cpu")
    np.testing.assert_array_equal(probs, ref.predict_voxels(
        grids.astype(np.float32))[1])
    assert CheckpointManager(ck).latest_step() == 0


# --- host-sharded datasets ----------------------------------------------

def _assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("host_id", [0, 1])
def test_synthetic_host_streams_match_reference(host_id):
    kw = dict(resolution=R, global_batch=6, seed=3, num_hosts=2, host_id=host_id)
    want = jax_dataset.SyntheticVoxelDataset(task="classify", **kw)
    got = dataset.SyntheticVoxelDataset(task="classify", **kw)
    assert got.local_batch == want.local_batch == 3
    for w in (0, 1):
        wi, gi = want.worker_iter(w, 2), got.worker_iter(w)
        for _ in range(2):
            _assert_batches_equal(next(gi), next(wi))
    with pytest.raises(ValueError, match="divide evenly"):
        dataset.SyntheticVoxelDataset(resolution=R, global_batch=5, num_hosts=2)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("caches")
    cls, seg = str(root / "cls"), str(root / "seg")
    offline.export_synthetic_cache(cls, per_class=3, resolution=R, seed=1)
    offline.export_seg_cache(seg, num_parts=20, resolution=R, shard_size=8,
                             seed=2)
    return cls, seg


@pytest.mark.parametrize("kind", ["classify", "segment"])
@pytest.mark.parametrize("host_id", [0, 1])
def test_cache_host_streams_shards_and_blocks_match_reference(caches, kind,
                                                              host_id):
    root = caches[0] if kind == "classify" else caches[1]
    jcls = (jax_offline.VoxelCacheDataset if kind == "classify"
            else jax_offline.SegCacheDataset)
    tcls = (offline.VoxelCacheDataset if kind == "classify"
            else offline.SegCacheDataset)
    for split in ("train", "test"):
        kw = dict(global_batch=4, split=split, test_fraction=0.25, seed=5,
                  num_hosts=2, host_id=host_id)
        want, got = jcls(root, **kw), tcls(root, **kw)
        assert got.local_batch == want.local_batch == 2
        for w in (0, 1):
            wi, gi = want.worker_iter(w, 2), got.worker_iter(w)
            for _ in range(2):
                _assert_batches_equal(next(gi), next(wi))
        for shards in (1, 2, 3):
            for sid in range(shards):
                wb = list(want.epoch_batches(2, num_shards=shards, shard_id=sid))
                gb = list(got.epoch_batches(2, num_shards=shards, shard_id=sid))
                assert len(gb) == len(wb)
                for g, w in zip(gb, wb):
                    _assert_batches_equal(g, w)
        for multiple_of, shards in ((1, 1), (2, 2), (4, 2), (3, 3)):
            for sid in range(shards):
                w = want.materialize_split(multiple_of=multiple_of,
                                           num_shards=shards, shard_id=sid)
                g = got.materialize_split(multiple_of=multiple_of,
                                          num_shards=shards, shard_id=sid)
                assert g[2] == w[2]
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_array_equal(g[1], w[1])
    with pytest.raises(ValueError, match="divide evenly"):
        tcls(root, global_batch=3, num_hosts=2)


def test_sharded_exact_pass_counts_every_sample_once(caches):
    ds = offline.VoxelCacheDataset(caches[0], global_batch=6, split="test",
                                   num_hosts=3, host_id=0)
    n = len(ds)
    seen, counts = [], []
    for sid in range(3):
        batches = list(ds.epoch_batches(ds.local_batch, 3, sid))
        counts.append(len(batches))
        for b in batches:
            seen.append(float(b["mask"].sum()))
    assert len(set(counts)) == 1  # lockstep: every shard as many batches
    assert sum(seen) == n


def test_one_host_defaults_keep_the_one_process_bytes(caches):
    """At one host the resident block is the whole split in
    ``resident_order`` and the stream is host 0's, as before sharding."""
    ds = offline.VoxelCacheDataset(caches[0], global_batch=4, seed=7)
    vox, labels, rows = ds.materialize_split()
    order = ds.resident_order()
    assert rows == len(order) == len(ds)
    np.testing.assert_array_equal(labels, ds.labels[order])
    np.testing.assert_array_equal(vox, ds._gather(order))
