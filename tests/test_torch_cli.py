"""``python -m featurenet_tpu_torch.cli`` end to end on the CPU: ``serve``
loads a weight file (or seeds weights), prints its banner with the bound
port, answers over HTTP, and drains on SIGTERM; ``train`` prints its config
and JSON records with a finite loss."""

import http.client
import json
import signal
import subprocess
import sys

import numpy as np
import pytest

from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.convert import save_npz
from featurenet_tpu_torch.runtime import build_model

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _cli(*args, **kw):
    return subprocess.Popen([sys.executable, "-m", "featurenet_tpu_torch.cli", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


@pytest.mark.parametrize("source", ["seed", "weights"])
def test_cli_serve_round_trip(tmp_path, source):
    if source == "weights":
        path = str(tmp_path / "w.npz")
        cfg = get_config("smoke16")
        save_npz(path, build_model(cfg, seed=3).state_dict(), cfg)
        src = ["--weights", path]
    else:
        src = ["--seed", "3", "--config", "smoke16"]
    proc = _cli("serve", *src, "--device", "cpu", "--port", "0",
                "--buckets", "1,4", "--duration-s", "120")
    try:
        banner = json.loads(proc.stdout.readline())["serving"]
        assert banner["config"] == "smoke16" and banner["device"] == "cpu"
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


def test_cli_train_refuses_missing_card():
    proc = _cli("train", "--config", "smoke16", "--total-steps", "1",
                env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in err
    assert '"kind"' not in out
