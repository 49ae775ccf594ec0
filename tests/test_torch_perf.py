"""The port's perf plane against the JAX package's, on the CPU at smoke16
width, on one torch thread.

- ``ops/flops.py``: the analytic counts equal the reference's for every
  classifier preset's arch; sprint64 reads 1.627 GFLOP a sample forward
  and 4.880 a train sample.
- ``obs/perf.py``: ``device_peaks``, ``roofline``, ``mfu_value`` and
  ``observe_dispatch`` give what the reference's give on the same cost
  dicts and walls, with the same peak row patched into both tables (the
  port's table holds the H100 alone, the reference's TPUs alone: the
  stated difference). ``sample_device_memory`` returns ``[]`` and leaves
  CUDA uninitialised on the CPU, and emits the reference's event shape
  where CUDA answers.
- The report's perf section, its rendering, the live perf line and the
  perf gate keys on the same event streams.
- Where the port's counters come from: a serving program's ``flops`` is
  the forward's analytic count × batch (no ``bytes``, so no roofline); a
  Trainer emits one ``program_cost`` for its eager step at the first paced
  wait and folds the MFU of paced iterations only; the batcher and the
  Predictor fold each dispatch's wall.
- ``cli train --run-dir --poll-device-memory`` writes a run directory
  that ``cli report --validate`` passes.

Comparisons are exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from featurenet_tpu.config import PRESETS as JAX_PRESETS
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.obs import gates as jax_gates
from featurenet_tpu.obs import perf as jax_perf
from featurenet_tpu.obs import report as jax_report
from featurenet_tpu.obs import windows as jax_windows
from featurenet_tpu.ops import flops as jax_flops
from featurenet_tpu_torch import cli, obs
from featurenet_tpu_torch.config import PRESETS, get_config
from featurenet_tpu_torch.obs import events, gates, perf, report, windows
from featurenet_tpu_torch.ops import flops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = perf.H100
CLASSIFY = sorted(n for n in PRESETS if get_config(n).task == "classify")


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.close_run()
    yield
    obs.close_run()
    for w in (windows, jax_windows):
        w.uninstall()
    torch.set_num_threads(threads)


@pytest.fixture
def same_rows(monkeypatch):
    """The port's H100 row patched into the reference's tables, so both
    know the same kinds."""
    monkeypatch.setitem(jax_perf.PEAK_FLOPS_BY_KIND, H100,
                        perf.PEAK_FLOPS_BY_KIND[H100])
    monkeypatch.setitem(jax_perf.PEAK_BYTES_PER_SEC_BY_KIND, H100,
                        perf.PEAK_BYTES_PER_SEC_BY_KIND[H100])


# --- ops/flops.py ------------------------------------------------------------

@pytest.mark.parametrize("name", CLASSIFY)
def test_flops_match_jax_for_every_classifier_preset(name):
    assert name in JAX_PRESETS
    cfg, jcfg = get_config(name), jax_get_config(name)
    a, ja, r = cfg.arch, jcfg.arch, cfg.resolution
    assert r == jcfg.resolution
    assert flops.classifier_forward_flops(a, r) == \
        jax_flops.classifier_forward_flops(ja, r)
    assert flops.train_step_flops_per_sample(a, r) == \
        jax_flops.train_step_flops_per_sample(ja, r)
    assert flops.conv_stack_forward_flops(
        a.features, a.kernels, a.strides, a.pool_after, r) == \
        jax_flops.conv_stack_forward_flops(
            ja.features, ja.kernels, ja.strides, ja.pool_after, r)


def test_sprint64_flops_and_the_h100_peak():
    cfg = get_config("sprint64")
    assert round(flops.classifier_forward_flops(cfg.arch, 64) / 1e9, 3) == 1.627
    assert round(flops.train_step_flops_per_sample(cfg.arch, 64) / 1e9, 2) == 4.88
    assert perf.PEAK_FLOPS_BY_KIND[H100] == 989.4e12
    # The port's one MFU formula gives the reference's flops.mfu: 1,000
    # sprint64 train samples a second on the H100's bf16 peak.
    assert perf.mfu_value({"flops": 4.88e9 * 1000.0}, 1.0,
                          perf.device_peaks(H100)) == \
        jax_flops.mfu(1000.0, 4.88e9, peak=989.4e12)
    # The one table: its only row is the H100's.
    assert list(perf.PEAK_FLOPS_BY_KIND) == [H100]
    assert list(perf.PEAK_BYTES_PER_SEC_BY_KIND) == [H100]


# --- obs/perf.py ---------------------------------------------------------------

KINDS = (H100, "cpu", None, "TPU v5e")


@pytest.mark.parametrize("kind", KINDS)
def test_device_peaks_and_roofline_match_jax(same_rows, kind):
    if kind == "TPU v5e":
        # A TPU is the port's unknown tier; the reference knows it.
        assert perf.device_peaks(kind)["tier"] == "unknown"
        assert jax_perf.device_peaks(kind)["tier"] == "known"
        return
    peaks = perf.device_peaks(kind)
    assert peaks == jax_perf.device_peaks(kind)
    for fl, by in ((1e12, 1e9), (1e9, 1e9), (None, 1e9), (1e9, None), (0, 0)):
        assert perf.roofline(fl, by, peaks) == jax_perf.roofline(fl, by, peaks)


COSTS = ({"flops": 1.2e12}, {"flops": 1.2e12, "bytes": 4e9}, {"bytes": 4e9},
         {}, None, {"flops": 0.0, "peak_bytes": 7})


@pytest.mark.parametrize("kind", (H100, "cpu"))
def test_mfu_value_and_observe_dispatch_match_jax(same_rows, kind):
    peaks = perf.device_peaks(kind)
    for w in (windows, jax_windows):
        w.install(w.WindowAggregator())
    got, want = [], []
    for cost in COSTS:
        for wall in (0.05, 0.0, -1.0, 2.5):
            assert perf.mfu_value(cost, wall, peaks) == \
                jax_perf.mfu_value(cost, wall, peaks)
            got.append(perf.observe_dispatch(cost, wall, peaks))
            want.append(jax_perf.observe_dispatch(cost, wall, peaks))
    assert got == want
    snap, jsnap = windows.snapshot(), jax_windows.snapshot()
    for m in ("mfu", "achieved_bw_fraction"):
        assert (m in snap) == (m in jsnap) == (kind == H100)
        if m in snap:
            assert {k: snap[m][k] for k in ("n", "p50", "max")} == \
                {k: jsnap[m][k] for k in ("n", "p50", "max")}


def test_sample_device_memory_leaves_cuda_alone_on_the_cpu(tmp_path):
    assert not torch.cuda.is_initialized()
    obs.init_run(str(tmp_path / "run"), process_index=0)
    assert perf.sample_device_memory() == []
    assert events.kind_counts().get("device_memory") is None
    assert not torch.cuda.is_initialized()
    # Where torch cannot be imported at all (cli report, a supervisor).
    code = ("import sys; sys.modules['torch'] = None\n"
            "from featurenet_tpu_torch.obs import perf\n"
            "print(perf.sample_device_memory(), perf.local_device_peaks()['tier'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "unknown"]


def test_sample_device_memory_emits_the_reference_shape(monkeypatch, tmp_path):
    """With CUDA answering (faked here), one event per card the process
    holds memory on, with the reference's fields, which validate."""
    cuda = torch.cuda
    for name, fn in (("is_initialized", lambda: True),
                     ("device_count", lambda: 2),
                     ("current_device", lambda: 0),
                     ("memory_reserved", lambda i: [2048, 0][i]),
                     ("memory_allocated", lambda i: 1024),
                     ("max_memory_allocated", lambda i: 1536),
                     ("mem_get_info", lambda i: (10, 80 * 2**30))):
        monkeypatch.setattr(cuda, name, fn)
    obs.init_run(str(tmp_path / "run"), process_index=0)
    rows = perf.sample_device_memory()
    obs.close_run()
    assert rows == [{"device": 0, "bytes_in_use": 1024,
                     "peak_bytes_in_use": 1536, "bytes_limit": 80 * 2**30}]
    ev, bad = report.load_events(str(tmp_path / "run"))
    assert [e["ev"] for e in ev].count("device_memory") == 1
    assert report.validate_events(ev, bad) == []


# --- the report's perf section -------------------------------------------------

def _perf_stream(kind):
    t = 1_790_000_000.0
    ev = [{"t": t, "ev": "run_start", "pid": 1}]
    for i, (name, extra) in enumerate((
            ("serve", {"flops": 4.1e9, "peak_bytes": 0, "batch": 4,
                       "precision": "fp32"}),
            ("serve", {"flops": 1.0e9, "peak_bytes": 12, "batch": 1,
                       "precision": "fp32"}),
            ("hbm_train_step", {"flops": 1.2e12, "peak_bytes": 4.3e9,
                                "precision": "fp32", "take": 1}),
            ("multi_train_step", {"flops": 9.6e12, "peak_bytes": 4.5e9,
                                  "bytes": 2e11, "precision": "bf16_master"}),
            ("serve_int8", {}))):
        ev.append({"t": t + i, "ev": "program_compile", "pid": 1,
                   "program": name, "dur_s": 0.25 * i})
        ev.append({"t": t + i + 0.1, "ev": "program_cost", "pid": 1,
                   "program": name, "device_kind": kind, **extra})
    for i in range(3):
        ev.append({"t": t + 10 + i, "ev": "device_memory", "pid": 1,
                   "device": 0, "bytes_in_use": 1000 * (i + 1),
                   "peak_bytes_in_use": 2500, "bytes_limit": 80_000})
    ev.append({"t": t + 20, "ev": "window_summary", "pid": 1, "metric": "mfu",
               "n": 4, "p50": 0.024, "p95": 0.03, "p99": 0.03, "mean": 0.025,
               "max": 0.03, "seq": 1})
    ev.append({"t": t + 21, "ev": "window_summary", "pid": 1,
               "metric": "achieved_bw_fraction", "n": 4, "p50": 0.2,
               "p95": 0.3, "p99": 0.3, "mean": 0.2, "max": 0.3, "seq": 1})
    return ev


@pytest.mark.parametrize("kind", (H100, "cpu"))
def test_perf_section_rendering_and_gates_match_jax(same_rows, kind):
    ev = _perf_stream(kind)
    rep, jrep = report.build_report(ev), jax_report.build_report(ev)
    assert rep["perf"] == jrep["perf"]
    assert rep["perf"]["tier"] == ("known" if kind == H100 else "unknown")
    row = rep["perf"]["programs"]["multi_train_step"]
    assert ("roofline" in row) == (kind == H100)
    assert "roofline" not in rep["perf"]["programs"]["hbm_train_step"]
    assert rep["perf"]["device_memory"]["0/0"] == {
        "samples": 3, "bytes_in_use": 3000, "watermark_bytes": 3000,
        "bytes_limit": 80_000}
    lines = [ln for ln in report.format_report(rep).splitlines()
             if ln.startswith(("perf:", "  program", "  serve", "  hbm",
                               "  multi", "  device memory"))]
    jlines = [ln for ln in jax_report.format_report(jrep).splitlines()
              if ln.startswith(("perf:", "  program", "  serve", "  hbm",
                                "  multi", "  device memory"))]
    assert lines == jlines and len(lines) == 7
    assert report.follow_perf_line(rep) == jax_report.follow_perf_line(jrep)
    vals = gates.report_gate_values(rep)
    assert vals == jax_gates.report_gate_values(jrep)
    assert vals["mfu"] == 0.024 and vals["hbm_peak_train_bytes"] == 4.5e9
    for key in ("mfu", "hbm_peak_train_bytes"):
        assert gates.DIRECTIONS[key] == jax_gates.DIRECTIONS[key]
    base = gates.make_baseline(vals)
    assert base == jax_gates.make_baseline(vals)
    worse = dict(vals, mfu=0.01, hbm_peak_train_bytes=6e9)
    got = gates.evaluate_gates(worse, base)
    assert got == jax_gates.evaluate_gates(worse, base)
    assert {"mfu", "hbm_peak_train_bytes"} <= set(got["failed"])


# --- the port's counters -------------------------------------------------------

def _program_costs(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        return [e for e in map(json.loads, fh) if e["ev"] == "program_cost"]


def test_serving_program_cost_is_the_analytic_forward(tmp_path):
    from featurenet_tpu_torch.infer import Predictor

    cfg = get_config("smoke16")
    obs.init_run(str(tmp_path / "run"), process_index=0)
    pred = Predictor.from_seed(cfg, 0, batch=4, device="cpu", precision="bf16")
    progs = [pred.program_for(4), pred.program_for(1)]
    obs.close_run()
    fwd = flops.classifier_forward_flops(cfg.arch, 16)
    costs = _program_costs(str(tmp_path / "run"))
    assert [(e["program"], e["batch"], e["flops"], e["precision"],
             e["device_kind"]) for e in costs] == [
        ("serve_bf16", 4, fwd * 4.0, "bf16", "cpu"),
        ("serve_bf16", 1, fwd * 1.0, "bf16", "cpu")]
    assert [p.cost for p in progs] == [{"flops": fwd * 4.0}, {"flops": fwd * 1.0}]
    assert not any("peak_bytes" in e or "bytes" in e for e in costs)


def test_trainer_folds_mfu_on_paced_iterations_only(tmp_path, monkeypatch):
    """6 steps, 2 in flight: the pacer waits from step 3, so 4 MFU samples,
    each the step's analytic FLOPs over its group wall; one train_step
    program_cost, at the first wait. On the CPU's unknown tier: none."""
    from featurenet_tpu_torch.train.loop import Trainer

    walls = []
    real = perf.observe_dispatch

    def spy(cost, wall, peaks=None):
        walls.append(wall)
        return real(cost, wall, peaks)

    monkeypatch.setattr(perf, "observe_dispatch", spy)
    cfg = get_config("smoke16", total_steps=6, global_batch=8, eval_batches=1,
                     data_workers=1, max_inflight_steps=2,
                     run_dir=str(tmp_path / "run"))
    for known in (True, False):
        walls.clear()
        windows.uninstall()
        with open(os.devnull, "w") as sink:
            trainer = Trainer(cfg, device="cpu", stream=sink)
            if known:
                trainer._peaks = perf.device_peaks(H100)
            trainer.run()
            snap = windows.snapshot()
        obs.close_run()
        assert len(walls) == 4
        want = flops.train_step_flops_per_sample(cfg.arch, 16) * 8.0
        assert trainer._last_cost == {"flops": want}
        if known:
            assert snap["mfu"]["n"] == 4 and min(walls) > 0
        else:
            assert "mfu" not in snap
    (cost,) = _program_costs(str(tmp_path / "run"))[-1:]
    assert cost["program"] == "train_step" and cost["flops"] == want
    assert cost["take"] == 1 and cost["device_kind"] == "cpu"
    assert len(_program_costs(str(tmp_path / "run"))) == 2  # one per run


def test_batcher_and_predictor_fold_each_dispatch(tmp_path):
    from featurenet_tpu_torch.infer import Predictor
    from featurenet_tpu_torch.serve.batcher import ContinuousBatcher

    peaks = perf.device_peaks(H100)
    windows.install(windows.WindowAggregator())

    def forward(bucket, arr):
        if arr[0].sum() < 0:
            raise RuntimeError("boom")
        return np.zeros((bucket, 3), np.float32)

    b = ContinuousBatcher(forward, buckets=(1, 4), max_wait_ms=0.0,
                          cost_for={1: {"flops": 1e9}, 4: {"flops": 4e9}}.get,
                          peaks=peaks)
    b.submit(np.ones((2,), np.float32)).result(10)
    with pytest.raises(RuntimeError):
        b.submit(-np.ones((2,), np.float32)).result(10)  # no sample
    b.drain()
    assert windows.snapshot()["mfu"]["n"] == 1
    cfg = get_config("smoke16")
    pred = Predictor.from_seed(cfg, 0, batch=4, device="cpu")
    pred._peaks = peaks
    pred.predict_voxels(np.zeros((6, 16, 16, 16), np.float32))  # 2 chunks
    assert windows.snapshot()["mfu"]["n"] == 3


def test_cli_train_poll_device_memory_run_validates(tmp_path, capsys):
    run = str(tmp_path / "run")
    assert cli.main(["train", "--config", "smoke16", "--device", "cpu",
                     "--total-steps", "10", "--global-batch", "8",
                     "--eval-batches", "1", "--data-workers", "1",
                     "--run-dir", run, "--poll-device-memory"]) == 0
    obs.close_run()
    rec = json.loads(capsys.readouterr().out.splitlines()[0])["config"]
    assert rec["poll_device_memory"] is True
    ev, bad = report.load_events(run)
    assert report.validate_events(ev, bad) == []
    (cost,) = [e for e in ev if e["ev"] == "program_cost"]
    assert {"program", "device_kind", "flops", "precision"} <= set(cost)
    assert not [e for e in ev if e["ev"] == "device_memory"]  # the CPU
    rep = report.build_report_dir(run)
    assert rep["perf"]["tier"] == "unknown" and "mfu" not in rep["perf"]
    assert "mfu: unknown (cpu)" in report.format_report(rep)
