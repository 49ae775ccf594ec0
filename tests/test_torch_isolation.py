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

import numpy as np
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


# The serving wire's modules (obs core, exporter, load generator), the
# run directory's (spans, the report, the gates, the supervisor), the
# perf and model-quality planes', and the incident plane's and the
# store's.
WIRE_MODULES = ("obs/__init__.py", "obs/events.py", "obs/alerts.py",
                "obs/windows.py", "obs/tracing.py", "serve/metrics.py",
                "serve/loadgen.py", "obs/spans.py", "obs/report.py",
                "obs/gates.py", "train/supervisor.py", "obs/perf.py",
                "ops/flops.py", "obs/quality.py", "serve/recorder.py",
                "obs/tsdb.py", "obs/stacksampler.py", "obs/incidents.py",
                "obs/dash.py")
# The incident plane's and the store's modules, which import no torch.
INCIDENT_MODULES = ("obs/tsdb.py", "obs/stacksampler.py",
                    "obs/incidents.py", "obs/dash.py")


@pytest.mark.parametrize("module", WIRE_MODULES)
def test_wire_modules_are_checked_and_import_no_jax(module):
    path = PORT / module
    assert path in _port_files()
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_wire_entry_points_refuse_cpu_without_being_asked(monkeypatch, capsys):
    from featurenet_tpu_torch import cli, obs
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.runtime import registry
    from featurenet_tpu_torch.serve import loadgen

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smoke16")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.warmup(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["programs", "--config", "smoke16", "--warm"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.bench_serving(cfg, qps=10.0, n_requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.measure_trace_overhead(cfg, n_requests=1)
    assert not obs.active()  # the refused probe closed its run
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.measure_incident_overhead(cfg, n_requests=1)
    assert not obs.active()
    capsys.readouterr()
    # Listing builds nothing and needs no card.
    assert cli.main(["programs", "--config", "smoke16"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(registry.PROGRAMS)


def test_report_and_supervisor_import_no_torch():
    """``cli report``'s modules, the supervisor's run_dir half and the perf
    and quality planes' modules load with torch blocked, and ``cli
    report`` reaches its answer without it."""
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "import featurenet_tpu_torch.obs.report, featurenet_tpu_torch.obs.gates\n"
        "import featurenet_tpu_torch.obs.spans, featurenet_tpu_torch.train.supervisor\n"
        "import featurenet_tpu_torch.obs.perf, featurenet_tpu_torch.ops.flops\n"
        "import featurenet_tpu_torch.obs.quality, featurenet_tpu_torch.serve.recorder\n"
        "from featurenet_tpu_torch import cli\n"
        "try:\n"
        "    cli.main(['report', '/nonexistent-run-dir'])\n"
        "except SystemExit as e:\n"
        "    print(e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "is not a directory" in out.stdout


def test_quality_entry_points_refuse_cpu_without_being_asked(monkeypatch,
                                                            tmp_path):
    """``pin-quality``, ``replay`` and the quality tax run on the card
    unless asked for the CPU; the refused probe closes its run."""
    from featurenet_tpu_torch import cli, obs
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.serve import loadgen, recorder
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    cfg = get_config("smoke16")
    ck = str(tmp_path / "ck")
    mgr = CheckpointManager(ck, config=cfg)
    mgr.save(create_state(build_model(cfg, seed=0), cfg))
    mgr.close()
    ring = str(tmp_path / "capture")
    rec = recorder.FlightRecorder(ring, sample=1.0)
    rec.maybe_capture(np.zeros((16, 16, 16, 1), np.float32), "t", label=1,
                      confidence=0.5)
    rec.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["pin-quality", "--checkpoint-dir", ck, "--n", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["replay", ring, "--checkpoint-dir", ck])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.measure_quality_overhead(cfg, n_requests=1)
    assert not obs.active()


@pytest.mark.parametrize("module", INCIDENT_MODULES)
def test_incident_modules_import_no_torch(module):
    assert "torch" not in set(_imported_roots(PORT / module))


def test_incident_and_dash_answer_without_torch(tmp_path):
    """``cli incident list`` and ``cli dash --once`` load and answer in a
    process where torch cannot be imported."""
    from featurenet_tpu_torch.obs import tsdb

    run_dir = str(tmp_path / "run")
    store = tsdb.TimeSeriesStore.open(run_dir)
    store.append("alerts_active", 1.0, {"rule": "serving_p99_ms"})
    store.close()
    code = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "import featurenet_tpu_torch.obs.tsdb, featurenet_tpu_torch.obs.dash\n"
        "import featurenet_tpu_torch.obs.incidents\n"
        "import featurenet_tpu_torch.obs.stacksampler\n"
        "from featurenet_tpu_torch import cli\n"
        f"assert cli.main(['incident', 'list', {run_dir!r}]) == 0\n"
        f"assert cli.main(['dash', '--once', {run_dir!r}]) == 0\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no incident bundles under" in out.stdout
    assert "fleet dash · " in out.stdout
    assert "incidents: none recorded" in out.stdout
