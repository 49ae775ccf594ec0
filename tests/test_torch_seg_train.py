"""The port's segmentation path against the JAX package's, on the CPU: the
seg data (bitwise), the paired rotation, the train and eval steps, a
resumed run, a JAX run exported into the port, serving and the command
line.

Inputs come from numpy seeds and go through both packages. Tolerances:

- data, the wire format, the cube rotations, the caches: bitwise (the same
  numpy calls and integer ops);
- train steps in fp32 on both sides, as ``tests/test_torch_train.py``
  holds them: loss to 1e-5 relative, the gradients' global norm to 1e-4,
  batch-norm statistics to 1e-4 of each leaf's scale, parameters within
  2·lr per moving step with 99 % of entries within 1e-5 (Adam's early
  updates are close to lr·sign(g));
- eval: per-class intersection and union counts equal, ``per_class_iou``
  equal, ``mean_iou`` and the accuracy to 1e-6 relative (the reference
  adds the batches' sums in fp32, the port in fp64), the loss sum to 1e-5;
- a resumed port run against the unbroken one: bitwise.

Sizes: R=16, ``seg_features=(4, 8)`` (the CLI cases run seg64's widths at
R=16), batches of 4, caches of 24 parts.
"""

import http.client
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu.config import Config as JaxConfig
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.data import dataset as jax_dataset
from featurenet_tpu.data import offline as jax_offline
from featurenet_tpu.data import synthetic as jax_synth
from featurenet_tpu.models.segmenter import FeatureNetSegmenter as JaxSegmenter
from featurenet_tpu.ops import augment as jax_augment
from featurenet_tpu.train import steps as jax_steps
from featurenet_tpu.train.loop import Trainer as JaxTrainer
from featurenet_tpu.train.state import create_state as jax_create_state
from featurenet_tpu_torch import convert
from featurenet_tpu_torch.config import Config, get_config
from featurenet_tpu_torch.data import dataset, offline, synthetic
from featurenet_tpu_torch.data.mesh_primitives import mesh_box
from featurenet_tpu_torch.data.stl import save_stl
from featurenet_tpu_torch.infer import Predictor, SegPrediction
from featurenet_tpu_torch.models.segmenter import FeatureNetSegmenter
from featurenet_tpu_torch.ops.augment import rotate_pair_by_codes
from featurenet_tpu_torch.serve.http import make_server
from featurenet_tpu_torch.serve.service import InferenceService
from featurenet_tpu_torch.train import steps
from featurenet_tpu_torch.train.checkpoint import CheckpointManager, load_run_config
from featurenet_tpu_torch.train.loop import Trainer
from featurenet_tpu_torch.train.state import create_state

import export_jax_checkpoint

R = 16
FEATURES = (4, 8)
SEG = dict(resolution=R, seg_features=FEATURES, global_batch=4,
           eval_batches=1, data_workers=1)


@pytest.fixture(autouse=True)
def _one_thread():
    # Many small forwards: a thread team per xdist worker only slows them.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _same_files(a: str, b: str) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


# --- data ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 4])
def test_samples_with_removals_and_wire_are_bitwise(seed):
    want = jax_synth.generate_sample_with_removals(np.random.default_rng(seed),
                                                   R, num_features=3)
    got = synthetic.generate_sample_with_removals(np.random.default_rng(seed),
                                                  R, num_features=3)
    for w, g in zip(want[:3], got[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert len(got[3]) == len(want[3]) == 3
    for w, g in zip(want[3], got[3]):
        np.testing.assert_array_equal(g, w)
    order = np.argsort(want[1], kind="stable")
    for w, g in zip(jax_synth.carve(want[1], want[3], order=order),
                    synthetic.carve(got[1], got[3], order=order)):
        np.testing.assert_array_equal(g, w)
    for w, g in zip(jax_synth.carve(want[1], [], resolution=R),
                    synthetic.carve(got[1], [], resolution=R)):
        np.testing.assert_array_equal(g, w)
    batch = jax_synth.generate_batch(np.random.default_rng(seed), 3, R,
                                     num_features=3)
    wire_j = jax_synth.to_wire(batch, "segment")
    wire_t = synthetic.to_wire(batch, "segment")
    assert tuple(wire_t) == synthetic.WIRE_KEYS["segment"] == \
        jax_synth.WIRE_KEYS["segment"]
    for k in wire_j:
        assert wire_t[k].dtype == wire_j[k].dtype
        np.testing.assert_array_equal(wire_t[k], wire_j[k])
    kw = dict(resolution=R, global_batch=2, num_features=3, seed=seed)
    want = next(jax_dataset.SyntheticVoxelDataset(task="segment", **kw).worker_iter(1, 2))
    got = next(dataset.SyntheticVoxelDataset(task="segment", **kw).worker_iter(1))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("label_order", ["canonical", "generation"])
def test_export_seg_cache_is_bitwise(tmp_path, label_order):
    kw = dict(num_parts=24, resolution=R, shard_size=10, seed=3,
              label_order=label_order)
    want = jax_offline.export_seg_cache(str(tmp_path / "j"), **kw)
    got = offline.export_seg_cache(str(tmp_path / "t"), **kw)
    assert got == want and len(got["shards"]) == 3
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"))


@pytest.fixture(scope="module")
def seg_cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seg") / "c")
    offline.export_seg_cache(root, num_parts=24, resolution=R, shard_size=10)
    return root


@pytest.mark.parametrize("augment", [False, True])
def test_seg_cache_dataset_is_bitwise(seg_cache, augment):
    kw = dict(global_batch=5, seed=2)
    jds = jax_offline.SegCacheDataset(seg_cache, augment=augment, **kw)
    tds = offline.SegCacheDataset(seg_cache, augment=augment, **kw)
    np.testing.assert_array_equal(tds.rows, jds.rows)
    for w in (0, 1):
        jit, tit = jds.worker_iter(w, 2), tds.worker_iter(w)
        for _ in range(2):
            want, got = next(jit), next(tit)
            assert set(got) == set(want) == {"voxels", "seg", "mask"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    for w, g in zip(jds.materialize_split(), tds.materialize_split()):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    jtest = jax_offline.SegCacheDataset(seg_cache, 4, "test", seed=7)
    ttest = offline.SegCacheDataset(seg_cache, 4, "test", seed=7)
    pairs = list(zip(jtest.epoch_batches(4), ttest.epoch_batches(4)))
    assert len(pairs) == 2 and float(pairs[-1][1]["mask"].sum()) < 4
    for want, got in pairs:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="segmentation cache"):
        offline.VoxelCacheDataset(seg_cache)


def test_paired_rotation_turns_seg_with_its_voxels():
    """Each group of the batch: voxels and ``seg`` by the same cube code,
    each equal to the reference's ``rotate_grids`` for that code; the
    reference's ``random_rotate_batch_paired`` on its own draw agrees."""
    rng = np.random.default_rng(1)
    vox = (rng.random((6, 8, 8, 8, 1)) > 0.5).astype(np.uint8)
    seg = rng.integers(0, 25, (6, 8, 8, 8)).astype(np.int8)
    codes = np.array([0, 5, 23], dtype=np.int64)
    got_v, got_s = rotate_pair_by_codes(torch.from_numpy(vox), torch.from_numpy(seg),
                                        torch.from_numpy(codes))
    for i, c in enumerate(codes):
        sl = slice(2 * i, 2 * i + 2)
        np.testing.assert_array_equal(
            got_v.numpy()[sl], np.asarray(jax_augment.rotate_grids(vox[sl], int(c))))
        np.testing.assert_array_equal(
            got_s.numpy()[sl], np.asarray(jax_augment.rotate_grids(seg[sl], int(c))))
    key = jax.random.key(3)
    want_v, want_s = jax_augment.random_rotate_batch_paired(
        jnp.asarray(vox), jnp.asarray(seg), key, groups=3)
    drawn = np.asarray(jax.random.randint(key, (3,), 0, 24))
    got_v, got_s = rotate_pair_by_codes(torch.from_numpy(vox), torch.from_numpy(seg),
                                        torch.from_numpy(drawn.astype(np.int64)))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# --- the steps ------------------------------------------------------------------

def _setup(seed: int = 0):
    """Bridged JAX and port segmenter train states (fp32, AdamW, warmup 1)
    and three segment wire batches."""
    cfg = dict(peak_lr=1e-3, weight_decay=1e-4, warmup_steps=1, total_steps=10)
    jmodel = JaxSegmenter(features=FEATURES, dtype=jnp.float32,
                          input_context="proj_coords", decoder_blocks=2)
    jstate = jax_create_state(jmodel, jax_steps.make_optimizer(JaxConfig(**cfg)),
                              jnp.zeros((2, R, R, R, 1), jnp.float32),
                              jax.random.key(seed))
    tmodel = FeatureNetSegmenter(FEATURES, dtype=torch.float32,
                                 input_context="proj_coords", decoder_blocks=2)
    tmodel.load_state_dict(convert.from_flax(
        _np({"params": jstate.params, "batch_stats": jstate.batch_stats})))
    tstate = create_state(tmodel, Config(**cfg))
    rng = np.random.default_rng(seed + 11)
    batches = [synthetic.to_wire(synthetic.generate_batch(rng, 4, R, num_features=3),
                                 "segment") for _ in range(3)]
    return jmodel, jstate, tstate, batches


def _port_tree(tree, stats):
    return convert.from_flax(_np({"params": tree, "batch_stats": stats}))


def _close_per_leaf(got: dict, want: dict, rel: float, keys):
    for k in keys:
        w, g = want[k].numpy(), got[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= rel * scale, k


def test_segment_train_steps_match_jax():
    """Three ``ce_dice`` steps with the paired rotation in the step (2
    groups): the codes the JAX step draws from its key are handed to the
    port's step."""
    jmodel, jstate, tstate, batches = _setup()
    jstep = jax.jit(jax_steps.make_train_step(
        jmodel, task="segment", packed=True, seg_loss="ce_dice",
        augment_groups=2))
    tstep = steps.make_train_step(augment_groups=2, task="segment",
                                  seg_loss="ce_dice")
    key = jax.random.key(1)
    names = [n for n, _ in tstate.model.named_parameters()]
    for i, batch in enumerate(batches):
        aug = jax.random.split(jax.random.fold_in(key, i), 3)[1]
        codes = np.asarray(jax.random.randint(aug, (2,), 0, 24)).astype(np.int64)
        jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, batch), key)
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                   codes=torch.from_numpy(codes))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        for k in ("accuracy", "fg_accuracy"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        if i == 0:
            adam = jstate.opt_state[0]
            for name, moments in (("mu", tstate.optimizer.mu),
                                  ("nu", tstate.optimizer.nu)):
                want = _port_tree(getattr(adam, name), jstate.batch_stats)
                _close_per_leaf(dict(zip(names, moments)), want, 1e-4, names)
    assert tstate.step == int(jstate.step) == 3
    want = _port_tree(jstate.params, jstate.batch_stats)
    got = tstate.model.state_dict()
    _close_per_leaf(got, want, 1e-4, [k for k in want if k.endswith((".mean", ".var"))])
    lr = tstate.optimizer.schedule
    bound = 2 * (lr(1) + lr(2)) + 1e-6
    for k in names:
        diff = (got[k] - want[k]).abs()
        assert float(diff.max()) <= bound, k
        assert float((diff <= 1e-5).float().mean()) >= 0.99, k


def test_segment_eval_matches_jax():
    jmodel, jstate, tstate, batches = _setup(seed=2)
    jeval = jax.jit(jax_steps.make_eval_step(jmodel, task="segment", packed=True))
    got_all, want_all = [], []
    for j, batch in enumerate(batches):
        if j == 2:
            batch = dict(batch, mask=np.array([1, 1, 0, 1], np.float32))
        want = jax.device_get(jeval(jstate.params, jstate.batch_stats,
                                    jax.tree_util.tree_map(jnp.asarray, batch)))
        got = steps.eval_step(tstate.model, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
        assert set(got) == set(want)
        for k in ("correct", "count", "intersection", "union"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]),
                                   rtol=1e-5)
        got_all.append(got)
        want_all.append(want)
    agg_t, agg_j = steps.aggregate_eval(got_all), jax_steps.aggregate_eval(want_all)
    assert agg_t["per_class_iou"] == agg_j["per_class_iou"]
    np.testing.assert_allclose(agg_t["mean_iou"], agg_j["mean_iou"], rtol=1e-6)
    np.testing.assert_allclose(agg_t["accuracy"], agg_j["accuracy"], rtol=1e-6)


# --- runs ----------------------------------------------------------------------

def _states_equal(a, b) -> None:
    sa, sb = a.state.model.state_dict(), b.state.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for x, y in zip(a.state.optimizer.tensors(), b.state.optimizer.tensors()):
        assert torch.equal(x, y)
    assert a.state.step == b.state.step


def test_resident_segment_run_resumes_bitwise(seg_cache, tmp_path):
    """2 + 2 steps with a checkpoint between equal 4 unbroken steps,
    bitwise: resident int8 seg, the paired rotation drawn in the step,
    k = 2 steps per dispatch."""
    kw = dict(SEG, data_cache=seg_cache, hbm_cache=True, steps_per_dispatch=2,
              total_steps=4, eval_every=100, log_every=2)
    whole = Trainer(get_config("seg64", **kw), device="cpu")
    whole.run()
    assert whole.resident["hbm_resident_rows"] == 19
    ck = str(tmp_path / "ck")
    first = Trainer(get_config("seg64", checkpoint_dir=ck, checkpoint_every=2,
                               **kw), device="cpu")
    first.run(2)
    first.ckpt.close()
    second = Trainer(get_config("seg64", checkpoint_dir=ck, checkpoint_every=2,
                                **kw), device="cpu")
    last = second.run()
    _states_equal(whole, second)
    assert 0.0 <= last["eval_mean_iou"] <= 1.0 and len(last["eval_per_class_iou"]) == 25
    assert last["eval_samples"] == 5  # the held-out parts, not their voxels


def test_exported_jax_segment_run_resumes_in_the_port(tmp_path):
    jck, pck = str(tmp_path / "jax"), str(tmp_path / "port")
    # Batch 8: the JAX Trainer splits it over its 8 CPU devices.
    jcfg = jax_get_config("seg64", total_steps=2, checkpoint_dir=jck,
                          checkpoint_every=1, log_every=1,
                          **dict(SEG, global_batch=8))
    JaxTrainer(jcfg).run()
    assert export_jax_checkpoint.export(jck, pck) == 2
    cfg = load_run_config(pck)
    assert (cfg.task, cfg.seg_features, cfg.seg_input_context) == \
        ("segment", FEATURES, "proj_coords")
    port = Trainer(cfg, device="cpu")
    assert port.resume_if_available() == 2
    assert int(port.state.optimizer.count) == 2
    template = jax_create_state(
        JaxSegmenter(features=FEATURES, input_context="proj_coords",
                     decoder_blocks=2),
        jax_steps.make_optimizer(jcfg), jnp.zeros((1, R, R, R, 1)),
        jax.random.key(9))
    from featurenet_tpu.train.checkpoint import CheckpointManager as JaxManager

    mgr = JaxManager(jck)
    jstate = mgr.restore(template)
    mgr.close()
    want = convert.from_flax(_np({"params": jstate.params,
                                  "batch_stats": jstate.batch_stats}))
    for k, v in port.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    moments = convert.opt_from_optax(jax.device_get(jstate.opt_state))
    names = [n for n, _ in port.state.model.named_parameters()]
    for key in ("mu", "nu"):
        for n, t in zip(names, getattr(port.state.optimizer, key)):
            assert torch.equal(t, moments[key][n]), (key, n)
    assert np.isfinite(port.run(3)["loss"])


# --- serving and the command line ------------------------------------------------

@pytest.fixture(scope="module")
def seg_checkpoint(tmp_path_factory):
    cfg = get_config("seg64", **SEG)
    ck = str(tmp_path_factory.mktemp("segck") / "ck")
    mgr = CheckpointManager(ck, config=cfg)
    from featurenet_tpu_torch.runtime import build_model

    mgr.save(create_state(build_model(cfg, seed=4), cfg))
    mgr.close()
    return ck


def _stl_paths(tmp_path, n=2):
    paths = []
    for i, (lo, hi) in enumerate([((0.2, 0.2, 0.2), (0.8, 0.8, 0.8)),
                                  ((0.1, 0.3, 0.2), (0.9, 0.7, 0.5))][:n]):
        paths.append(str(tmp_path / f"part{i}.stl"))
        save_stl(paths[-1], mesh_box(lo, hi))
    return paths


def test_segment_predictor_service_and_http(seg_checkpoint, tmp_path):
    pred = Predictor.from_checkpoint(seg_checkpoint, batch=4, device="cpu")
    grids = (np.random.default_rng(0).random((3, R, R, R)) > 0.4).astype(np.float32)
    labels = pred.predict_voxels_seg(grids)
    assert labels.dtype == np.int8 and labels.shape == (3, R, R, R)
    with torch.no_grad():
        want = pred.model(torch.from_numpy(grids[..., None])).argmax(-1).numpy()
    np.testing.assert_array_equal(labels, want)
    assert pred.predict_voxels_seg(grids[:0]).shape == (0, R, R, R)
    with pytest.raises(ValueError, match="predict_voxels_seg"):
        pred.predict_voxels(grids)
    # int8: quantized kernels, labels of the same shape, close to fp32's.
    q = Predictor.from_checkpoint(seg_checkpoint, batch=4, device="cpu",
                                  precision="int8")
    qlabels = q.predict_voxels_seg(grids)
    assert qlabels.dtype == np.int8 and qlabels.shape == labels.shape
    assert float((qlabels == labels).mean()) > 0.9
    assert q.resident_weight_bytes < pred.resident_weight_bytes / 3
    paths = _stl_paths(tmp_path)
    out = pred.predict_stl(paths)
    assert all(isinstance(p, SegPrediction) for p in out)
    for p in out:
        counts = np.bincount(p.labels.ravel().astype(np.int64), minlength=25)
        assert p.voxel_counts == {
            synthetic.CLASS_NAMES[c - 1]: int(counts[c])
            for c in range(1, 25) if counts[c]}

    # The bucket predict_voxels_seg pads to: one program answers both.
    service = InferenceService(pred, buckets=(4,), max_wait_ms=2)
    assert service.format_row(labels[0]) == {"voxel_counts": {
        synthetic.CLASS_NAMES[c - 1]: int(n) for c, n in
        enumerate(np.bincount(labels[0].ravel().astype(np.int64), minlength=25))
        if c and n}}
    srv = make_server(service, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=30)
        for g, lab in zip(grids, labels):
            conn.request("POST", "/predict_voxels", body=g.astype("<f4").tobytes())
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200 and body == service.format_row(lab)
        with open(paths[0], "rb") as fh:
            conn.request("POST", "/predict", body=fh.read())
        resp = conn.getresponse()
        assert resp.status == 200
        assert json.loads(resp.read())["voxel_counts"] == out[0].voxel_counts
        conn.request("POST", "/admin/reload",
                     body=json.dumps({"checkpoint_dir": seg_checkpoint}))
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["ok"]
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        service.drain()


def _main(capsys, *args) -> list[dict]:
    from featurenet_tpu_torch import cli

    assert cli.main(list(args)) == 0
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_cli_segment_export_train_eval_infer(tmp_path, capsys):
    from featurenet_tpu_torch import cli

    cache, ck, out = (str(tmp_path / n) for n in ("c", "ck", "seg"))
    assert _main(capsys, "export-seg-data", "--out", cache, "--num-parts", "24",
                 "--resolution", "16")[0] == {"exported": 24, "shards": 1}
    recs = _main(capsys, "train", "--config", "seg64", "--device", "cpu",
                 "--resolution", "16", "--data-cache", cache, "--hbm-cache",
                 "--global-batch", "4", "--total-steps", "2",
                 "--checkpoint-dir", ck, "--seg-loss", "balanced_ce")
    assert recs[0]["config"]["task"] == "segment"
    assert recs[0]["config"]["seg_loss"] == "balanced_ce"
    ev = [r for r in recs if r.get("kind") == "eval"][-1]
    assert 0.0 <= ev["mean_iou"] <= 1.0
    got = _main(capsys, "eval", "--checkpoint-dir", ck, "--device", "cpu")[0]["eval"]
    assert got["mean_iou"] == ev["mean_iou"]
    assert got["per_class_iou"] == ev["per_class_iou"]
    paths = _stl_paths(tmp_path)
    rows = _main(capsys, "infer", "--checkpoint-dir", ck, "--device", "cpu",
                 "--seg-out", out, *paths)
    assert [r["path"] for r in rows] == paths
    for r in rows:
        labels = np.load(r["labels_path"])["labels"]
        assert labels.dtype == np.int8 and labels.shape == (R, R, R)
        assert sum(r["voxel_counts"].values()) == int((labels > 0).sum())
    with pytest.raises(SystemExit, match="identity|contradict"):
        cli.main(["train", "--checkpoint-dir", ck, "--device", "cpu",
                  "--seg-input-context", "none"])
