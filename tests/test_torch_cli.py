"""``python -m featurenet_tpu_torch.cli`` end to end on the CPU: ``serve``
loads a weight file or a checkpoint directory (or seeds weights), prints
its banner with the bound port, answers over HTTP, and drains on SIGTERM;
``train`` prints its config and JSON records with a finite loss, saves
checkpoints and resumes from them; ``eval`` and ``infer`` read a
checkpoint directory. Left without ``--device``, every command refuses to
run where there is no card."""

import http.client
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.convert import save_npz
from featurenet_tpu_torch.runtime import build_model

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


# A served subprocess's small forwards on one torch thread: under xdist a
# thread team per worker slows each forward many times over.
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


def _cli(*args, **kw):
    return subprocess.Popen([sys.executable, "-m", "featurenet_tpu_torch.cli", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


TRAIN = ("--config", "smoke16", "--device", "cpu", "--global-batch", "8",
         "--eval-batches", "1", "--data-workers", "1")


def _records(out: str) -> list[dict]:
    return [json.loads(line) for line in out.strip().splitlines()]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A smoke16 run of 2 steps, checkpointed at each, and its records."""
    ck = str(tmp_path_factory.mktemp("run") / "ck")
    proc = _cli("train", *TRAIN, "--total-steps", "2", "--checkpoint-dir", ck,
                "--checkpoint-every", "1")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    return ck, _records(out)


@pytest.mark.parametrize("source", ["seed", "weights", "checkpoint"])
def test_cli_serve_round_trip(tmp_path, source, request):
    if source == "weights":
        path = str(tmp_path / "w.npz")
        cfg = get_config("smoke16")
        save_npz(path, build_model(cfg, seed=3).state_dict(), cfg)
        src = ["--weights", path]
    elif source == "checkpoint":
        src = ["--checkpoint-dir", request.getfixturevalue("trained")[0],
               "--conv-backend", "xla"]
    else:
        src = ["--seed", "3", "--config", "smoke16"]
    # One torch thread (see ONE_THREAD): the drain's exit code carries the
    # 250 ms latency SLO.
    proc = _cli("serve", *src, "--device", "cpu", "--port", "0",
                "--buckets", "1,4", "--duration-s", "120", env=ONE_THREAD)
    try:
        banner = json.loads(proc.stdout.readline())["serving"]
        assert banner["config"] == "smoke16" and banner["device"] == "cpu"
        if source == "checkpoint":
            assert banner["model_version"].startswith("ck@2-")
            assert banner["conv_backend"] == "xla"
        assert banner["buckets"] == [1, 4] and banner["port"] > 0
        conn = http.client.HTTPConnection("127.0.0.1", banner["port"], timeout=60)
        grid = np.zeros((16, 16, 16), "<f4")
        grid[4:12, 4:12, 4:12] = 1.0
        conn.request("POST", "/predict_voxels", body=grid.tobytes())
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and 0 < body["prob"] <= 1
        conn.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    stats = json.loads(out.strip().splitlines()[-1])["serve_stats"]
    assert stats["served"] == 1 and stats["exit_code"] == 0


def test_cli_serve_refuses_missing_card():
    proc = _cli("serve", "--seed", "0", "--config", "smoke16", "--port", "0",
                "--duration-s", "1", env={"PATH": "/usr/bin:/bin",
                                          "CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in err
    assert "serving" not in out


def test_cli_train_smoke16_on_cpu():
    proc = _cli("train", "--config", "smoke16", "--device", "cpu",
                "--total-steps", "3")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    records = [json.loads(line) for line in out.strip().splitlines()]
    cfg = records[0]["config"]
    assert cfg["name"] == "smoke16" and cfg["total_steps"] == 3
    assert cfg["arch"]["conv_backend"] == "pallas"
    kinds = [r["kind"] for r in records[1:]]
    assert kinds == ["setup", "train", "eval"]
    train = records[2]
    assert train["step"] == 3 and np.isfinite(train["loss"])
    assert np.isfinite(train["grad_norm"]) and train["samples_per_sec"] > 0
    assert 0.0 <= records[3]["accuracy"] <= 1.0


def test_cli_train_under_fp32_turns_tf32_off(capsys, monkeypatch):
    """``cli train`` of an fp32 config runs its fp32 convolutions and
    matmuls in fp32: cuDNN's TF32 (on by PyTorch's default) and cuBLAS's
    are off once the Trainer is built, whatever they were before."""
    import torch

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    records = _main(capsys, "train", *TRAIN, "--total-steps", "1")
    assert records[0]["config"]["train_precision"] == "fp32"
    assert records[-1]["kind"] == "eval"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cli_train_refuses_missing_card():
    proc = _cli("train", "--config", "smoke16", "--total-steps", "1",
                env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in err
    assert '"kind"' not in out


def test_cli_train_checkpoints_then_resumes(trained, tmp_path):
    ck = str(tmp_path / "ck")
    shutil.copytree(trained[0], ck)  # resuming adds steps; keep the fixture's
    assert sorted(os.listdir(ck)) == ["checksum.1.json", "checksum.2.json",
                                      "config.json", "step_1.pt", "step_2.pt"]
    # No --config: the run takes the config persisted with the checkpoint.
    proc = _cli("train", "--device", "cpu", "--checkpoint-dir", ck,
                "--total-steps", "3")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    again = _records(out)
    cfg = again[0]["config"]
    assert cfg["name"] == "smoke16" and cfg["total_steps"] == 3
    assert cfg["global_batch"] == 8
    assert [(r["kind"], r["step"]) for r in again[1:]] == [
        ("setup", 2), ("train", 3), ("eval", 3), ("checkpoint", 3)]
    assert again[-1]["saves"] == 1 and again[-1]["bytes"] > 0
    assert "step_3.pt" in os.listdir(ck)
    proc = _cli("train", "--config", "sprint64", "--device", "cpu",
                "--checkpoint-dir", ck, "--total-steps", "4")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode != 0 and "contradict" in err


def test_cli_eval_reproduces_the_train_time_eval(tmp_path):
    ck = str(tmp_path / "ck")
    proc = _cli("train", *TRAIN, "--total-steps", "2", "--checkpoint-dir", ck)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    want = [r for r in _records(out)[1:] if r["kind"] == "eval"][-1]
    proc = _cli("eval", "--device", "cpu", "--checkpoint-dir", ck)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    got = _records(out)[-1]["eval"]
    assert got["config"] == "smoke16" and got["model_version"].startswith("ck@2-")
    assert (got["accuracy"], got["loss"]) == (want["accuracy"], want["loss"])


def test_cli_infer_classifies_stl_parts(trained, tmp_path):
    from featurenet_tpu_torch.data.mesh_primitives import mesh_box
    from featurenet_tpu_torch.data.stl import save_stl

    paths = []
    for i, hi in enumerate([(0.8, 0.6, 0.4), (0.5, 0.9, 0.7)]):
        paths.append(str(tmp_path / f"part{i}.stl"))
        save_stl(paths[-1], mesh_box((0.1, 0.1, 0.1), hi))
    proc = _cli("infer", "--device", "cpu", "--checkpoint-dir", trained[0], *paths)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    rows = _records(out)
    assert [r["path"] for r in rows] == paths
    for r in rows:
        assert 0 <= r["label"] < 24 and 0 < r["prob"] <= 1 and len(r["top3"]) == 3
        assert r["model_version"].startswith("ck@2-")


@pytest.mark.parametrize("cmd", ["eval", "infer", "serve"])
def test_cli_checkpoint_commands_refuse_missing_card(trained, cmd):
    args = [cmd, "--checkpoint-dir", trained[0]]
    if cmd == "infer":
        args.append("part.stl")
    if cmd == "serve":
        args += ["--port", "0", "--duration-s", "1"]
    proc = _cli(*args, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in err
    assert "serving" not in out and '"eval"' not in out


def test_cli_train_eval_and_infer_at_the_rungs(tmp_path):
    """``--train-precision fp16_scaled --serve-precision int8 --conv-backend
    fused33`` on ``train``: the config carries them, the records the scale,
    and the train-time eval runs at int8; ``eval`` reproduces it from the
    checkpoint and ``--serve-precision bf16`` evaluates another rung;
    ``infer --precision bf16`` classifies at bf16."""
    from featurenet_tpu_torch.data.mesh_primitives import mesh_box
    from featurenet_tpu_torch.data.stl import save_stl

    ck = str(tmp_path / "ck")
    proc = _cli("train", *TRAIN, "--total-steps", "2", "--checkpoint-dir", ck,
                "--train-precision", "fp16_scaled", "--serve-precision", "int8",
                "--conv-backend", "fused33")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    records = _records(out)
    cfg = records[0]["config"]
    assert (cfg["train_precision"], cfg["serve_precision"],
            cfg["arch"]["conv_backend"]) == ("fp16_scaled", "int8", "fused33")
    train = [r for r in records[1:] if r["kind"] == "train"][-1]
    assert train["loss_scale"] > 0 and train["grads_finite"] == 1.0
    want = [r for r in records[1:] if r["kind"] == "eval"][-1]
    proc = _cli("eval", "--device", "cpu", "--checkpoint-dir", ck)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    got = _records(out)[-1]["eval"]
    assert got["serve_precision"] == "int8"
    assert (got["accuracy"], got["loss"]) == (want["accuracy"], want["loss"])
    proc = _cli("eval", "--device", "cpu", "--checkpoint-dir", ck,
                "--serve-precision", "bf16")
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    assert _records(out)[-1]["eval"]["serve_precision"] == "bf16"
    path = str(tmp_path / "part.stl")
    save_stl(path, mesh_box((0.1, 0.1, 0.1), (0.8, 0.6, 0.4)))
    proc = _cli("infer", "--device", "cpu", "--checkpoint-dir", ck,
                "--precision", "bf16", path)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    row = _records(out)[-1]
    assert row["precision"] == "bf16" and 0 <= row["label"] < 24


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_cli_serve_at_a_precision_reports_it(precision):
    proc = _cli("serve", "--seed", "3", "--config", "smoke16", "--device", "cpu",
                "--port", "0", "--buckets", "1,4", "--duration-s", "120",
                "--precision", precision)
    try:
        banner = json.loads(proc.stdout.readline())["serving"]
        assert banner["precision"] == precision
        conn = http.client.HTTPConnection("127.0.0.1", banner["port"], timeout=60)
        grid = np.zeros((16, 16, 16), "<f4")
        grid[4:12, 4:12, 4:12] = 1.0
        conn.request("POST", "/predict_voxels", body=grid.tobytes())
        resp = conn.getresponse()
        assert resp.status == 200 and 0 < json.loads(resp.read())["prob"] <= 1
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        assert json.loads(resp.read())["precision"] == precision
        conn.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err


def test_cli_refuses_an_unknown_precision():
    for args in (("train", "--train-precision", "fp8"),
                 ("serve", "--seed", "0", "--precision", "fp16"),
                 ("eval", "--checkpoint-dir", "x", "--serve-precision", "int4")):
        proc = _cli(*args, "--device", "cpu")
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 2 and "invalid choice" in err


# --- robustness evaluation and the data commands (in process) -------------------

def _main(capsys, *args) -> list[dict]:
    from featurenet_tpu_torch import cli

    assert cli.main(list(args)) == 0
    return _records(capsys.readouterr().out)


@pytest.fixture
def xla_checkpoint(tmp_path):
    """A seeded smoke16 checkpoint under the ``xla`` lowering (a library
    conv on the CPU), run on one CPU thread: the report makes one small
    forward per class and row."""
    import dataclasses

    import torch

    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    base = get_config("smoke16")
    cfg = dataclasses.replace(base, arch=dataclasses.replace(
        base.arch, conv_backend="xla"))
    ck = str(tmp_path / "ck")
    mgr = CheckpointManager(ck, config=cfg)
    mgr.save(create_state(build_model(cfg, seed=2), cfg))
    mgr.close()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield ck
    torch.set_num_threads(threads)


def test_cli_eval_ood_on_cpu(xla_checkpoint, tmp_path, capsys):
    out = str(tmp_path / "rows.json")
    rows = _main(capsys, "eval-ood", "--checkpoint-dir", xla_checkpoint,
                 "--device", "cpu", "--per-class", "1", "--families", "tails",
                 "--seed", "3", "--out", out)
    assert [(r["family"], r["level"]) for r in rows] == [("clean", None),
                                                         ("tails", None)]
    assert all(r["n"] == 24 and 0 <= r["accuracy"] <= 1 for r in rows)
    assert rows[0]["delta_vs_clean"] == 0.0
    with open(out) as fh:
        assert json.load(fh) == rows
    tta = _main(capsys, "eval-ood", "--checkpoint-dir", xla_checkpoint,
                "--device", "cpu", "--per-class", "1", "--families", "clean",
                "--seed", "3", "--tta")
    assert len(tta) == 1 and tta[0]["n"] == 24


def test_cli_stl_tree_build_cache_and_remesh_export(tmp_path, capsys):
    tree, built, remesh = (str(tmp_path / n) for n in ("stl", "built", "remesh"))
    exported = _main(capsys, "export-stl-data", "--out", tree, "--per-class",
                     "1", "--resolution", "16", "--seed", "6")[0]["exported"]
    assert exported == {c: 1 for c in exported} and len(exported) == 24
    assert _main(capsys, "build-cache", "--stl-root", tree, "--out", built,
                 "--resolution", "16", "--workers", "1")[0]["built"] == exported
    rec = _main(capsys, "export-data", "--out", remesh, "--per-class", "1",
                "--resolution", "16", "--seed", "6", "--mesh-pose", "remesh",
                "--param-range", "0.0,1.0")[0]
    assert (rec["mesh_pose"], rec["param_range"], rec["margin_jitter"]) == \
        ("remesh", [0.0, 1.0], None)
    for cls in exported:
        np.testing.assert_array_equal(np.load(os.path.join(built, f"{cls}.npy")),
                                      np.load(os.path.join(remesh, f"{cls}.npy")))
    jit = _main(capsys, "export-data", "--out", str(tmp_path / "j"),
                "--per-class", "1", "--resolution", "16", "--param-range", "tails",
                "--margin-jitter", "0.04,0.08")[0]
    assert (jit["mesh_pose"], jit["param_range"], jit["margin_jitter"]) == \
        ("none", "tails", [0.04, 0.08])


def test_cli_refuses_the_segmentation_paths(tmp_path):
    """What the reference refuses of the segmentation paths: a
    ``--resolution`` that contradicts a segmentation tree's sidecars, a
    segmentation tree that is not ``aligned_unit_cube``, and ``--tta`` or
    ``--canonicalize`` on a segment checkpoint; nothing is written."""
    from featurenet_tpu_torch import cli

    seg_tree = str(tmp_path / "segtree")
    assert cli.main(["export-stl-data", "--seg", "--out", seg_tree,
                     "--num-parts", "2", "--resolution", "16"]) == 0
    with pytest.raises(SystemExit, match="contradicts"):
        cli.main(["build-cache", "--stl-root", seg_tree, "--out",
                  str(tmp_path / "c"), "--resolution", "64"])
    with open(os.path.join(seg_tree, "index.json")) as fh:
        index = json.load(fh)
    index.pop("aligned_unit_cube")
    with open(os.path.join(seg_tree, "index.json"), "w") as fh:
        json.dump(index, fh)
    with pytest.raises(ValueError, match="aligned_unit_cube"):
        cli.main(["build-cache", "--stl-root", seg_tree, "--out",
                  str(tmp_path / "c"), "--workers", "1"])
    seg_ck = tmp_path / "segck"
    seg_ck.mkdir()
    (seg_ck / "config.json").write_text(json.dumps({"task": "segment"}))
    for flag in ("--tta", "--canonicalize"):
        with pytest.raises(SystemExit, match="classify-only"):
            cli.main(["eval-ood", "--checkpoint-dir", str(seg_ck),
                      "--device", "cpu", flag])
    assert not (tmp_path / "c").exists()
