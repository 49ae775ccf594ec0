"""The port stands alone: no file of ``featurenet_tpu_torch/`` (or the
port's card scripts ``chip_smoke.py`` and ``ab_conv_dw_folded.py``)
imports JAX, Flax or the JAX package, the whole port imports with those
blocked, its entry points refuse to run silently on the CPU when asked for
the card that is not there, and the card scripts exit non-zero without
one."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "featurenet_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "featurenet_tpu"}
CARD_SCRIPTS = ("chip_smoke.py", "ab_conv_dw_folded.py")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / s for s in CARD_SCRIPTS]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
        "import featurenet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'featurenet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke, ab_conv_dw_folded\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_entry_points_refuse_cpu_without_being_asked(monkeypatch, tmp_path):
    from featurenet_tpu_torch import cli
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.ood import evaluate_ood
    from featurenet_tpu_torch.runtime import build_model, resolve_device
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.loop import Trainer
    from featurenet_tpu_torch.train.state import create_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smoke16")
    state = build_model(cfg, seed=0).state_dict()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(state, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_seed(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, state=state)
    assert Trainer(cfg, device="cpu").device == torch.device("cpu")
    ck = str(tmp_path / "ck")
    mgr = CheckpointManager(ck, config=cfg)
    mgr.save(create_state(build_model(cfg, seed=0), cfg))
    mgr.close()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_ood(ck, per_class=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval-ood", "--checkpoint-dir", ck, "--per-class", "1"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # 24 small forwards
    try:
        rows = evaluate_ood(ck, per_class=1, levels=[("clean", None)], batch=2,
                            device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert [r["n"] for r in rows] == [24]
    # The segmenter's entry points likewise; its data command is host-only.
    seg = get_config("seg64", resolution=16, seg_features=(4, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_seed(seg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(seg)
    assert cli.main(["export-seg-data", "--out", str(tmp_path / "seg"),
                     "--num-parts", "2", "--resolution", "16"]) == 0
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_refuses_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_exit_nonzero_without_a_card(script):
    out = subprocess.run([sys.executable, script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert '"ok": true' not in out.stdout


def test_ab_tool_forward_mode_exits_nonzero_without_a_card():
    out = subprocess.run([sys.executable, "ab_conv_dw_folded.py", "--kernel",
                          "conv3d_fwd", "build/none.cu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 1
    assert "no CUDA device" in out.stderr
