"""The port's checkpoints on the CPU (``featurenet_tpu_torch/train/
checkpoint.py``, the Trainer's resume and warm start, ``Predictor.
from_checkpoint``), after the JAX package's own tests of its manager
(``tests/test_faults.py``: walk-back, explicit step, all steps corrupt).

Resume is held bitwise: the CPU ops are deterministic, and a resumed run
must see the same weights, batch-norm statistics, Adam moments and count,
and dropout seed (from ``TrainState.step``) as the run that never stopped.
"""

import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest
import torch

from featurenet_tpu_torch.config import check_identity, get_config
from featurenet_tpu_torch.data import synthetic
from featurenet_tpu_torch.infer import Predictor
from featurenet_tpu_torch.train import checkpoint
from featurenet_tpu_torch.train.checkpoint import (
    CheckpointManager,
    ChecksumMismatch,
    load_run_config,
)
from featurenet_tpu_torch.train.loop import Trainer


class _Sink:
    def write(self, s):
        pass

    def flush(self):
        pass


def _cfg(ckpt=None, **kw):
    return get_config("smoke16", global_batch=4, total_steps=20, log_every=1,
                      eval_every=100, eval_batches=1, data_workers=1,
                      checkpoint_dir=None if ckpt is None else str(ckpt), **kw)


def _trainer(cfg):
    return Trainer(cfg, device="cpu", stream=_Sink())


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(v) for k, v in
             synthetic.to_wire(synthetic.generate_batch(rng, 4, 16)).items()}
            for _ in range(n)]


def _state(tr):
    """Everything a resume must bring back, as CPU tensors and ints."""
    opt = tr.state.optimizer
    names = [n for n, _ in tr.state.model.named_parameters()]
    return {"model": {k: v.clone() for k, v in tr.state.model.state_dict().items()},
            "mu": dict(zip(names, (t.clone() for t in opt.mu))),
            "nu": dict(zip(names, (t.clone() for t in opt.nu))),
            "count": opt.count, "step": tr.state.step}


def _assert_equal(a, b):
    assert (a["count"], a["step"]) == (b["count"], b["step"])
    for key in ("model", "mu", "nu"):
        assert set(a[key]) == set(b[key])
        for k in a[key]:
            assert torch.equal(a[key][k], b[key][k]), (key, k)


def _saved_steps(tmp_path, steps=3, keep=3):
    """A trainer that saved after each of ``steps`` steps; returns it and
    its state at every step."""
    tr = _trainer(_cfg(tmp_path / "ck", keep_checkpoints=keep))
    states = {}
    for b in _batches(steps):
        tr.step(b)
        tr.ckpt.save(tr.state)
        states[tr.state.step] = _state(tr)
    tr.ckpt.wait()
    return tr, states


def _damage(directory, step):
    """Flip one byte in the middle of a step's file (same size)."""
    path = os.path.join(directory, checkpoint.step_filename(step))
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) // 2)
        byte = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("n,m", [(2, 2), (1, 3)])
def test_resume_is_bitwise(tmp_path, n, m):
    batches = _batches(n + m)
    straight = _trainer(_cfg())
    for b in batches:
        straight.step(b)

    first = _trainer(_cfg(tmp_path / "ck"))
    for b in batches[:n]:
        first.step(b)
    first.ckpt.save(first.state)
    first.ckpt.close()

    resumed = _trainer(_cfg(tmp_path / "ck"))
    before = _state(resumed)
    assert resumed.resume_if_available() == n
    restored = _state(resumed)
    assert not torch.equal(before["model"]["blocks.0.mean"],
                           restored["model"]["blocks.0.mean"])
    # The optimizer still holds the model's own parameter tensors.
    assert all(p is q for (_, p), q in zip(resumed.state.model.named_parameters(),
                                           resumed.state.optimizer.params))
    for b in batches[n:]:
        resumed.step(b)
    assert not torch.equal(restored["model"]["dense1.weight"],
                           resumed.state.model.dense1.weight)
    _assert_equal(_state(resumed), _state(straight))


def test_checksum_mismatch_walks_back_and_explicit_step_raises(tmp_path, capsys):
    tr, states = _saved_steps(tmp_path)
    _damage(tr.cfg.checkpoint_dir, 3)
    fresh = _trainer(_cfg())
    mgr = CheckpointManager(tr.cfg.checkpoint_dir)
    mgr.restore(fresh.state)
    assert mgr.restored_step == 2
    _assert_equal(_state(fresh), states[2])
    err = capsys.readouterr().err
    assert '"checkpoint_warning"' in err and "ChecksumMismatch" in err
    fallback = [json.loads(line) for line in err.splitlines()
                if "checkpoint_fallback" in line]
    assert fallback == [{"checkpoint_fallback": {"from_step": 3, "to_step": 2}}]
    with pytest.raises(ChecksumMismatch):
        mgr.restore(fresh.state, step=3)
    with pytest.raises(ChecksumMismatch):
        mgr.verify()
    assert mgr.verify(2) == 2
    _assert_equal(_state(fresh), states[2])  # a refused restore changed nothing


def test_every_step_corrupt_raises_chained(tmp_path):
    tr, _ = _saved_steps(tmp_path)
    for s in (1, 2, 3):
        _damage(tr.cfg.checkpoint_dir, s)
    with pytest.raises(RuntimeError, match="every retained checkpoint") as e:
        CheckpointManager(tr.cfg.checkpoint_dir).restore(_trainer(_cfg()).state)
    assert isinstance(e.value.__cause__, ChecksumMismatch)


def test_retention_keeps_the_newest_steps(tmp_path):
    tr, _ = _saved_steps(tmp_path, steps=5, keep=2)
    assert tr.ckpt.all_steps() == [4, 5]
    names = sorted(os.listdir(tr.cfg.checkpoint_dir))
    assert names == ["checksum.4.json", "checksum.5.json", "config.json",
                     "step_4.pt", "step_5.pt"]


def test_cleanup_deletes_only_for_the_resume_caller(tmp_path):
    tr, states = _saved_steps(tmp_path)
    _damage(tr.cfg.checkpoint_dir, 3)
    CheckpointManager(tr.cfg.checkpoint_dir).restore(_trainer(_cfg()).state)
    Predictor.from_checkpoint(tr.cfg.checkpoint_dir, batch=2, device="cpu")
    assert tr.ckpt.all_steps() == [1, 2, 3]
    resumed = _trainer(_cfg(tmp_path / "ck"))
    assert resumed.resume_if_available() == 2
    _assert_equal(_state(resumed), states[2])
    assert resumed.ckpt.all_steps() == [1, 2]
    assert not os.path.exists(checkpoint.checksum_path(tr.cfg.checkpoint_dir, 3))


def test_writer_error_surfaces_on_wait_and_close(tmp_path, monkeypatch):
    def full(payload, path):
        raise OSError("no space left on device")

    monkeypatch.setattr(checkpoint, "_write_file", full)
    tr = _trainer(_cfg(tmp_path / "ck"))
    tr.ckpt.save(tr.state)
    with pytest.raises(RuntimeError, match="background checkpoint write") as e:
        tr.ckpt.wait()
    assert isinstance(e.value.__cause__, OSError)
    tr.ckpt.wait()  # reported once
    tr.ckpt.save(tr.state)
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        tr.ckpt.close()
    assert tr.ckpt.all_steps() == []


def test_sidecar_round_trips_and_identity_is_checked(tmp_path):
    cfg = _cfg(tmp_path / "ck")
    tr = _trainer(cfg)
    tr.ckpt.save(tr.state)
    tr.ckpt.close()
    saved = load_run_config(tmp_path / "ck")
    assert saved == cfg
    with pytest.raises(ValueError, match="contradict"):
        check_identity(saved, get_config("smoke16", resolution=32))
    xla = dataclasses.replace(cfg, arch=dataclasses.replace(
        cfg.arch, conv_backend="xla"))
    check_identity(saved, xla)
    pred = Predictor.from_checkpoint(tmp_path / "ck", config=xla, batch=2,
                                     device="cpu")
    assert pred.cfg.arch.conv_backend == "xla"
    with pytest.raises(ValueError, match="contradict"):
        Predictor.from_checkpoint(tmp_path / "ck", config="sprint64", device="cpu")


def test_init_from_warm_starts_at_step_zero(tmp_path):
    src, states = _saved_steps(tmp_path, steps=2)
    warm = _trainer(_cfg(init_from=src.cfg.checkpoint_dir))
    got = _state(warm)
    assert (got["step"], got["count"]) == (0, 0)
    for k, v in states[2]["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert all(not t.any() for t in list(got["mu"].values()) + list(got["nu"].values()))
    with pytest.raises(ValueError, match="contradict"):
        Trainer(get_config("smoke16", resolution=32, init_from=src.cfg.checkpoint_dir),
                device="cpu", stream=_Sink())


def test_run_saves_on_its_cadence_and_resumes(tmp_path):
    tr = _trainer(_cfg(tmp_path / "ck", checkpoint_every=2))
    tr.run(num_steps=3)
    assert tr.ckpt.all_steps() == [2, 3]
    assert tr.timing["saves"] == 2 and tr.timing["save_s"] > 0
    assert tr.ckpt.timing["writes"] == 2 and tr.ckpt.timing["bytes"] > 0
    again = _trainer(_cfg(tmp_path / "ck", checkpoint_every=2))
    again.run(num_steps=5)
    setup = [r for r in again.logger.history if r["kind"] == "setup"]
    assert setup[0]["step"] == 3
    assert [r["step"] for r in again.logger.history if r["kind"] == "train"] == [4, 5]
    assert again.state.step == 5 and again.ckpt.all_steps() == [3, 4, 5]


def test_predictor_from_checkpoint_serves_the_trained_weights(tmp_path):
    tr, _ = _saved_steps(tmp_path, steps=2)
    pred = Predictor.from_checkpoint(tr.cfg.checkpoint_dir, batch=4, device="cpu")
    with open(checkpoint.checksum_path(tr.cfg.checkpoint_dir, 2), "rb") as fh:
        sidecar = fh.read()
    assert pred.model_version == f"ck@2-{hashlib.sha256(sidecar).hexdigest()[:8]}"
    grids = (np.random.default_rng(1).random((6, 16, 16, 16)) > 0.6).astype(np.float32)
    labels, probs = pred.predict_voxels(grids)
    tr.state.model.eval()
    with torch.no_grad():
        want = torch.softmax(tr.state.model(torch.from_numpy(grids[..., None])), -1)
    np.testing.assert_array_equal(probs, want.numpy())
    np.testing.assert_array_equal(labels, want.argmax(-1).numpy())


def _run(tmp_path, precision, steps, batches):
    tr = _trainer(_cfg(tmp_path / "ck", train_precision=precision))
    tr.resume_if_available()
    for b in batches[tr.state.step:steps]:
        tr.step(b)
    tr.ckpt.save(tr.state)
    tr.ckpt.close()
    return tr


def test_loss_scale_state_round_trips_across_precisions(tmp_path):
    """fp16_scaled → fp32 → fp16_scaled, as the reference's
    ``test_loss_scale_state_survives_checkpoint_and_cross_precision``:
    the masters bitwise throughout, the adapted scale and streak carried
    through the fp32 run untouched, and the resumed fp16 run continuing
    from them instead of ``LOSS_SCALE_INIT``."""
    from featurenet_tpu_torch.train.precision import LOSS_SCALE_INIT

    batches = _batches(4)
    first = _run(tmp_path, "fp16_scaled", 2, batches)
    # An adapted state, as an overflow and a streak would leave it.
    first.state.loss_scale.fill_(LOSS_SCALE_INIT / 4)
    first.state.good_steps.fill_(7)
    first.ckpt.save(first.state)
    first.ckpt.close()
    saved = _state(first)

    as32 = _trainer(_cfg(tmp_path / "ck", train_precision="fp32"))
    assert as32.resume_if_available() == 2
    assert as32.state.precision == "fp32"
    _assert_equal(_state(as32), saved)
    assert float(as32.state.loss_scale) == LOSS_SCALE_INIT / 4
    assert int(as32.state.good_steps) == 7
    as32.step(batches[2])  # an fp32 step leaves the scale state alone
    assert float(as32.state.loss_scale) == LOSS_SCALE_INIT / 4
    as32.ckpt.save(as32.state)
    as32.ckpt.close()

    back = _trainer(_cfg(tmp_path / "ck", train_precision="fp16_scaled"))
    assert back.resume_if_available() == 3
    _assert_equal(_state(back), _state(as32))
    assert (float(back.state.loss_scale), int(back.state.good_steps)) == \
        (LOSS_SCALE_INIT / 4, 7)
    m = back.step(batches[3])
    assert float(m["grads_finite"]) == 1.0
    assert int(back.state.good_steps) == 8
    assert float(back.state.loss_scale) == LOSS_SCALE_INIT / 4
    assert back.state.loss_scale.dtype == torch.float32
    assert back.state.good_steps.dtype == torch.int32


@pytest.mark.parametrize("precision,scale", [("fp32", 1.0),
                                             ("fp16_scaled", 2.0 ** 15)])
def test_checkpoint_without_the_scale_state_restores(tmp_path, precision, scale):
    """A step written before the scale state was kept (no ``loss_scale``
    or ``good_steps``) restores with the live state's standing in, as the
    reference's ``legacy_abstract`` does: a fresh state's 1.0 and 0, or
    ``LOSS_SCALE_INIT`` and 0 under fp16_scaled."""
    tr, states = _saved_steps(tmp_path, steps=2)
    path = os.path.join(tmp_path / "ck", checkpoint.step_filename(2))
    payload = torch.load(path, weights_only=True)
    assert {"loss_scale", "good_steps"} <= set(payload)
    for k in ("loss_scale", "good_steps"):
        del payload[k]
    torch.save(payload, path)
    os.unlink(checkpoint.checksum_path(str(tmp_path / "ck"), 2))
    fresh = _trainer(_cfg(tmp_path / "ck", train_precision=precision))
    assert fresh.resume_if_available() == 2
    _assert_equal(_state(fresh), states[2])
    assert float(fresh.state.loss_scale) == scale
    assert int(fresh.state.good_steps) == 0
