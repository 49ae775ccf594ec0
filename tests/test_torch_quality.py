"""The port's model-quality plane against the JAX package's, on the CPU at
smoke16 width, on one torch thread.

- ``obs/quality.py``: ``confidence_stats``, ``drift_score``, the baseline
  file (written bytes, loads and refusals), ``quality_rules``, and a
  ``QualityTracker`` fed the same sequence (its windows, its
  ``quality_drift`` events, ``stats``) give what the reference's give.
- ``serve/recorder.py``: ``pack_grid`` gives the same bytes, ``unpack_grid``
  inverts it, ``read_captures`` skips the same torn tails and foreign
  lines, and a ``FlightRecorder`` writes the same ring (records, segment
  rotation, the byte cap, the resumed torn tail, going dark on an
  ``OSError``) for the same requests. Records compare without their clock
  stamps.
- An ``InferenceService`` with a tracker and a recorder, on weights carried
  across from a JAX init by ``convert.from_flax``, against the JAX service
  on the same requests: the same capture records and quality windows
  (confidences within 1e-5: both models run fp32 activations, as in
  ``tests/test_torch_ood.py``; the requests' top-2 margins and their
  confidences' distance from the recorder's floor are checked to exceed
  2e-5, so no label or capture reason sits on a tie); a segmenter
  refused.
- The CLI: ``pin-quality`` counts what the JAX command counts on the same
  weights; ``serve --capture`` then ``replay`` in subprocesses (the
  identity candidate exits 0 at agreement 1.0 with no program built while
  scoring, another seed's weights exit 2 below the 0.967 gate), the
  reference's refusals, and the run directories of ``serve --quality
  --capture`` and ``replay --run-dir`` passing ``report --validate``.
"""

import http.client
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurenet_tpu import cli as jax_cli
from featurenet_tpu import infer as jax_infer
from featurenet_tpu.config import get_config as jax_get_config
from featurenet_tpu.models.featurenet import FeatureNet as JaxFeatureNet
from featurenet_tpu.obs import events as jax_events
from featurenet_tpu.obs import quality as jax_quality
from featurenet_tpu.obs import windows as jax_windows
from featurenet_tpu.runtime import Runtime
from featurenet_tpu.runtime import registry as jax_registry
from featurenet_tpu.serve import recorder as jax_recorder
from featurenet_tpu.serve.service import InferenceService as JaxService
from featurenet_tpu_torch import cli, convert, infer, obs
from featurenet_tpu_torch.config import get_config
from featurenet_tpu_torch.data import synthetic
from featurenet_tpu_torch.models.featurenet import FeatureNet
from featurenet_tpu_torch.obs import events, quality, report, windows
from featurenet_tpu_torch.serve import recorder
from featurenet_tpu_torch.serve.service import InferenceService
from featurenet_tpu_torch.train.checkpoint import CheckpointManager
from featurenet_tpu_torch.train.state import create_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 16
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _clean():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    for mod in (obs, jax_events):
        mod.close_run()
    for w in (windows, jax_windows):
        w.uninstall()
    torch.set_num_threads(threads)


# --- obs/quality.py ------------------------------------------------------------

def _rows(seed, n=12, k=24):
    rng = np.random.default_rng(seed)
    rows = [list(rng.dirichlet(np.full(k, a))) for a in (0.1, 1.0, 10.0)
            for _ in range(n // 3)]
    return rows + [[], [1.0] + [0.0] * (k - 1), [0.5, 0.5], [0.0, 0.0]]


@pytest.mark.parametrize("seed", [0, 1])
def test_confidence_stats_and_drift_score_match_jax(seed):
    for row in _rows(seed):
        assert quality.confidence_stats(row) == jax_quality.confidence_stats(row)
    rng = np.random.default_rng(seed)
    base = list(rng.dirichlet(np.ones(24)))
    for counts in ([0] * 24, list(rng.integers(0, 9, 24)), [5] + [0] * 30,
                   list(rng.integers(0, 3, 10))):
        for b in (base, base[:10], [1.0]):
            assert quality.drift_score(counts, b) == jax_quality.drift_score(counts, b)


def test_baseline_file_matches_jax(tmp_path):
    counts = [3, 0, 5, 1] + [0] * 20
    names = [f"c{i}" for i in range(24)]
    src = {"checkpoint_dir": "ck", "n": 9}
    p, j = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    assert quality.save_baseline(p, counts, class_names=names, source=src) == \
        jax_quality.save_baseline(j, counts, class_names=names, source=src)
    assert open(p, "rb").read() == open(j, "rb").read()
    assert quality.load_baseline(p) == jax_quality.load_baseline(j)
    assert quality.baseline_path("/r") == jax_quality.baseline_path("/r")
    msgs = []
    for mod, path in ((quality, p), (jax_quality, j)):
        with pytest.raises(ValueError) as e:
            mod.save_baseline(path, [0, 0])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    for body in ("not json", '{"dist": []}', '{"dist": [0.2, 0.2]}',
                 '{"dist": [1.0, -0.5, 0.5]}'):
        bad = str(tmp_path / "bad.json")
        with open(bad, "w") as fh:
            fh.write(body)
        msgs = []
        for mod in (quality, jax_quality):
            with pytest.raises(ValueError) as e:
                mod.load_baseline(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_quality_rules_match_jax():
    for kw in ({}, {"with_drift": False},
               {"confidence_floor": 0.7, "drift_ceiling": 0.1}):
        got = [(r.metric, r.op, r.threshold, r.severity)
               for r in quality.quality_rules(**kw)]
        want = [(r.metric, r.op, r.threshold, r.severity)
                for r in jax_quality.quality_rules(**kw)]
        assert got == want


def _events(run_dir, kind):
    with open(os.path.join(run_dir, "events.jsonl")) as fh:
        return [{k: v for k, v in e.items() if k not in ("t", "pid")}
                for e in map(json.loads, fh) if e["ev"] == kind]


@pytest.mark.parametrize("baseline", [None, "uniform", "skewed"])
def test_quality_tracker_matches_jax(tmp_path, baseline):
    base = {None: None, "uniform": [1 / 24] * 24,
            "skewed": [0.5, 0.25] + [0.25 / 22] * 22}[baseline]
    rng = np.random.default_rng(3)
    seq = [(int(rng.integers(0, 30)), *map(float, rng.random(3)))
           for _ in range(40)]
    got = {}
    for name, (ev, win, mod) in {"port": (events, windows, quality),
                                 "jax": (jax_events, jax_windows, jax_quality)}.items():
        ev.init_run(str(tmp_path / name), process_index=0)
        win.install(win.WindowAggregator())
        t = mod.QualityTracker(24, baseline=base, window=16, emit_every=8)
        scores = [t.observe(*obsd) for obsd in seq]
        snap = win.snapshot()
        got[name] = (scores, t.stats(), {m: {k: snap[m][k] for k in
                                             ("n", "p50", "p99", "max")}
                                         for m in snap})
        ev.close_run()
        win.uninstall()
    assert got["port"] == got["jax"]
    assert _events(str(tmp_path / "port"), "quality_drift") == \
        _events(str(tmp_path / "jax"), "quality_drift")
    assert bool(_events(str(tmp_path / "port"), "quality_drift")) == bool(base)


# --- serve/recorder.py ---------------------------------------------------------

def test_pack_grid_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((16, 16, 16), (16, 16, 16, 1), (5, 7, 3), (64, 64, 64)):
        g = (rng.random(shape) > 0.6).astype(np.float32)
        rec = recorder.pack_grid(g)
        assert json.dumps(rec) == json.dumps(jax_recorder.pack_grid(g))
        np.testing.assert_array_equal(recorder.unpack_grid(rec), g)
        np.testing.assert_array_equal(recorder.unpack_grid(rec),
                                      jax_recorder.unpack_grid(rec))
    assert len(json.dumps(recorder.pack_grid(g))) < 45_000  # a 64³ record


def _strip(recs):
    return [{k: v for k, v in r.items() if k != "t"} for r in recs]


def _feed(mod, root, **kw):
    """The same requests through one package's FlightRecorder; its stats
    and its ring, read back."""
    rec = mod.FlightRecorder(root, **kw)
    rng = np.random.default_rng(1)
    for i in range(24):
        g = (rng.random((8, 8, 8)) > 0.5).astype(np.float32)
        outcome = ("rejected", "error", "ok", "ok")[i % 4]
        rec.maybe_capture(g, f"trace-{i}", label=i % 5 if outcome == "ok" else None,
                          confidence=(i % 7) / 7 if outcome == "ok" else None,
                          total_ms=float(i * 10), outcome=outcome)
    rec.close()
    return rec.stats(), sorted(os.listdir(root)) if os.path.isdir(root) else []


@pytest.mark.parametrize("kw", [
    {},
    {"sample": 0.5, "slo_ms": 150.0, "confidence_floor": 0.2},
    {"sample": 1.0, "segment_bytes": 300, "max_bytes": 700},
], ids=["default", "policy", "ring_cap"])
def test_flight_recorder_writes_the_reference_ring(tmp_path, kw):
    p, j = str(tmp_path / "p" / "capture"), str(tmp_path / "j" / "capture")
    (pst, pfiles), (jst, jfiles) = _feed(recorder, p, **kw), _feed(jax_recorder, j, **kw)
    assert {k: v for k, v in pst.items() if k != "dir"} == \
        {k: v for k, v in jst.items() if k != "dir"}
    assert pfiles == jfiles
    assert _strip(recorder.read_captures(p)) == _strip(jax_recorder.read_captures(j))
    if "max_bytes" in kw:
        assert len(pfiles) > 1 and sum(
            os.path.getsize(os.path.join(p, f)) for f in pfiles) <= 700 + 300


def test_read_captures_and_resume_skip_torn_tails(tmp_path):
    root = str(tmp_path / "capture")
    _feed(recorder, root, sample=1.0)
    seg = os.path.join(root, sorted(os.listdir(root))[-1])
    with open(seg, "ab") as fh:
        fh.write(b'{"not": "a capture"}\n[1, 2]\n{"voxels": {"shape": [2')
    with open(os.path.join(root, "capture.x.jsonl"), "w") as fh:
        fh.write('{"voxels": 1}\n')
    want = _strip(jax_recorder.read_captures(root))
    assert _strip(recorder.read_captures(root)) == want and len(want) == 24
    assert recorder.read_captures(str(tmp_path / "none")) == []
    # A recorder resuming the torn segment terminates the tear first.
    rec = recorder.FlightRecorder(root, sample=1.0)
    assert rec.maybe_capture(np.ones((2, 2, 2)), "late", outcome="error")
    rec.close()
    got = recorder.read_captures(root)
    assert _strip(got[:-1]) == want and got[-1]["trace"] == "late"


def test_flight_recorder_goes_dark_like_jax(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    stats = []
    for mod in (recorder, jax_recorder):
        rec = mod.FlightRecorder(str(blocker / "capture"), sample=1.0)
        assert not rec.maybe_capture(np.ones((2, 2, 2)), "a", outcome="error")
        assert not rec.maybe_capture(np.ones((2, 2, 2)), "b", outcome="error")
        assert not rec.maybe_capture(np.ones((2, 2, 2)), "c", confidence=0.9,
                                     label=1)
        stats.append({k: v for k, v in rec.stats().items() if k != "dir"})
    assert stats[0] == stats[1] and stats[0]["dark"] and stats[0]["dropped"] == 3
    msgs = []
    for mod in (recorder, jax_recorder):
        with pytest.raises(ValueError) as e:
            mod.FlightRecorder(str(tmp_path), sample=1.5)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# --- the service ----------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """smoke16 from the JAX init at key 0: the JAX variables and the port
    state_dict carried across from them."""
    jcfg = jax_get_config("smoke16")
    jstate = Runtime(jcfg, cache=None).build("init")(jax.random.key(0))
    v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    cfg = get_config("smoke16")
    return jcfg, v, cfg, convert.from_flax(v, cfg.arch)


@pytest.fixture
def fp32_models(monkeypatch):
    """Both packages' serving models with fp32 activations."""
    monkeypatch.setattr(jax_registry, "build_model",
                        lambda cfg: JaxFeatureNet(arch=cfg.arch, dtype=jnp.float32))
    monkeypatch.setattr(infer, "build_model", lambda cfg: FeatureNet(
        cfg.arch, cfg.resolution, dtype=torch.float32).eval())


def _parts(n, seed=5):
    return synthetic.generate_batch(np.random.default_rng(seed), n, R)["voxels"]


def _serve_both(weights, tmp_path, grids, **rec_kw):
    """The same requests, one at a time with the same trace ids, through
    the port's service and the JAX service, each with a tracker (uniform
    baseline) and a recorder; per side its answers, tracker stats, quality
    windows and ring."""
    jcfg, v, cfg, state = weights
    preds = {"port": infer.Predictor(state, cfg, batch=1, device="cpu"),
             "jax": jax_infer.Predictor(v["params"], v["batch_stats"], jcfg,
                                        batch=1)}
    out = {}
    for name, pred in preds.items():
        qmod, rmod, win, Svc = ((quality, recorder, windows, InferenceService)
                                if name == "port" else
                                (jax_quality, jax_recorder, jax_windows,
                                 JaxService))
        tracker = qmod.QualityTracker(24, baseline=[1 / 24] * 24, window=16,
                                      emit_every=8)
        ring = rmod.FlightRecorder(str(tmp_path / name / "capture"), **rec_kw)
        svc = Svc(pred, buckets=(1,), max_wait_ms=0.0, quality=tracker,
                  recorder=ring)
        answers = [svc.predict(svc.submit_voxels(g, trace_id=f"req-{i}"), 60)
                   for i, g in enumerate(grids)]
        st = svc.drain()  # the last answer's hook has run
        snap = win.snapshot()
        out[name] = {
            "labels": [a["label"] for a in answers],
            "probs": np.array([a["prob"] for a in answers]),
            "tracker": st["quality"],
            "capture": {k: v for k, v in st["capture"].items() if k != "dir"},
            "windows": {m: snap[m] for m in ("confidence", "confidence_margin",
                                              "prediction_entropy",
                                              "quality_drift_score")},
            "ring": _strip(rmod.read_captures(str(tmp_path / name / "capture"))),
        }
        win.uninstall()
    return out["port"], out["jax"]


def test_service_quality_and_captures_match_jax(weights, fp32_models, tmp_path):
    grids = _parts(24)
    _, v, cfg, state = weights
    probs = infer.Predictor(state, cfg, batch=24, device="cpu").predict_voxels(
        grids)[1]
    # No label on a tie and no confidence at the floor: gaps of at least
    # twice the 1e-5 the two packages' probabilities are held to.
    top2 = np.sort(probs, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 2e-5
    conf = np.sort(probs.max(-1))
    assert conf[12] - conf[11] > 2e-5
    got, want = _serve_both(weights, tmp_path, grids, sample=0.5,
                            confidence_floor=float(conf[11] + conf[12]) / 2)
    assert got["labels"] == want["labels"]
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
    assert got["tracker"] == want["tracker"] and got["capture"] == want["capture"]
    assert got["capture"]["captured"] > 0 and got["capture"]["skipped"] > 0
    for m, row in got["windows"].items():
        assert row["n"] == want["windows"][m]["n"] == 24
        for k in ("p50", "p99", "max", "mean"):
            assert row[k] == pytest.approx(want["windows"][m][k], abs=2e-4)
    assert len(got["ring"]) == len(want["ring"])
    for a, b in zip(got["ring"], want["ring"]):
        assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-5)
        drop = ("confidence", "total_ms")
        assert {k: x for k, x in a.items() if k not in drop} == \
            {k: x for k, x in b.items() if k not in drop}
    assert {r["reason"] for r in got["ring"]} <= {"low_confidence", "sampled"}


def test_service_refuses_quality_for_a_segmenter():
    cfg = get_config("seg64", resolution=16, seg_features=(4, 8))
    pred = infer.Predictor.from_seed(cfg, 0, batch=1, device="cpu")
    for kw in ({"quality": quality.QualityTracker(24)},
               {"recorder": recorder.FlightRecorder("/nonexistent")}):
        with pytest.raises(ValueError, match="need a classify checkpoint"):
            InferenceService(pred, buckets=(1,), **kw)


# --- the CLI --------------------------------------------------------------------

def _checkpoint(path, cfg, state):
    mgr = CheckpointManager(path, config=cfg)
    model = infer.build_model(cfg)
    model.load_state_dict(state)
    mgr.save(create_state(model, cfg))
    mgr.close()
    return path


def test_pin_quality_counts_what_jax_counts(weights, fp32_models, tmp_path,
                                            monkeypatch, capsys):
    jcfg, v, cfg, state = weights
    ck = _checkpoint(str(tmp_path / "ck"), cfg, state)
    monkeypatch.setattr(jax_infer.Predictor, "from_checkpoint", classmethod(
        lambda cls, d, config=None, batch=32, precision=None: cls(
            v["params"], v["batch_stats"], jcfg, batch=batch,
            precision=precision)))
    argv = ["pin-quality", "--checkpoint-dir", ck, "--n", "40", "--batch", "8",
            "--seed", "2"]
    assert cli.main(argv + ["--device", "cpu", "--out",
                            str(tmp_path / "p.json")]) == 0
    jax_cli.main(argv + ["--out", str(tmp_path / "j.json")])
    got, want = (json.loads(ln)["quality_baseline"]
                 for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith('{"quality_baseline"'))
    assert got["n"] == want["n"] == 40 and got["top"] == want["top"]
    p, j = (quality.load_baseline(str(tmp_path / f)) for f in ("p.json", "j.json"))
    assert p["dist"] == j["dist"] and p["n"] == j["n"]
    # The default path is the checkpoint's; a segmenter has no class mix.
    assert cli.main(["pin-quality", "--checkpoint-dir", ck, "--n", "8",
                     "--device", "cpu"]) == 0
    assert os.path.exists(quality.baseline_path(ck))
    seg = get_config("seg64", resolution=16, seg_features=(4, 8))
    seg_ck = _checkpoint(str(tmp_path / "seg"), seg,
                         infer.build_model(seg).state_dict())
    with pytest.raises(SystemExit, match="drift baseline is a predicted-CLASS"):
        cli.main(["pin-quality", "--checkpoint-dir", seg_ck, "--n", "1",
                  "--device", "cpu"])


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "featurenet_tpu_torch.cli",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=ONE_THREAD)


# Requests served in the CLI test: one drift snapshot's worth.
N_SERVED = quality.DEFAULT_EMIT_EVERY


def test_cli_serve_capture_then_replay(tmp_path):
    cfg = get_config("smoke16")
    # Seed 3's weights spread these parts over several classes; seed 2's
    # put every one in a class seed 3 never picks.
    ck = _checkpoint(str(tmp_path / "ck"), cfg, _seeded(cfg, 3))
    other = _checkpoint(str(tmp_path / "other"), cfg, _seeded(cfg, 2))
    run = str(tmp_path / "run")
    base = quality.save_baseline(str(tmp_path / "base.json"), [1] * 24)
    assert base["n"] == 24
    srv = subprocess.Popen(
        [sys.executable, "-m", "featurenet_tpu_torch.cli", "serve",
         "--checkpoint-dir", ck, "--device", "cpu", "--port", "0",
         "--buckets", "1,4", "--run-dir", run, "--quality-baseline",
         str(tmp_path / "base.json"), "--capture", "--duration-s", "120"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=ONE_THREAD)
    try:
        banner = json.loads(srv.stdout.readline())["serving"]
        assert banner["quality"] and banner["capture_dir"] == os.path.join(
            run, "capture")
        conn = http.client.HTTPConnection("127.0.0.1", banner["port"], timeout=60)
        for g in _parts(N_SERVED):
            conn.request("POST", "/predict_voxels", body=g[..., 0].astype("<f4").tobytes())
            resp = conn.getresponse()
            assert resp.status == 200 and "label" in json.loads(resp.read())
        conn.close()
        srv.send_signal(signal.SIGTERM)
        out, err = srv.communicate(timeout=60)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.communicate()
    assert srv.returncode == 0, err
    stats = json.loads(out.strip().splitlines()[-1])["serve_stats"]
    assert stats["capture"]["captured"] == N_SERVED
    assert stats["quality"]["seen"] == N_SERVED and stats["quality"]["baseline"]
    rrun = str(tmp_path / "replay_run")
    ident = _cli("replay", os.path.join(run, "capture"), "--checkpoint-dir", ck,
                 "--device", "cpu", "--run-dir", rrun)
    assert ident.returncode == 0, ident.stderr
    r = json.loads(ident.stdout.splitlines()[-1])["replay"]
    assert (r["n"], r["agreement"], r["ok"], r["flips"],
            r["post_warmup_compiles"]) == (N_SERVED, 1.0, True, {}, 0)
    cand = _cli("replay", os.path.join(run, "capture"), "--checkpoint-dir",
                other, "--device", "cpu", "--conv-backend", "xla")
    assert cand.returncode == 2, cand.stderr
    r = json.loads(cand.stdout.splitlines()[-1])["replay"]
    assert r["agreement"] < 0.967 and not r["ok"] and r["n"] == N_SERVED
    assert r["candidate"]["conv_backend"] == "xla"
    assert sum(r["flips"].values()) == round((1 - r["agreement"]) * N_SERVED)
    # Both run directories validate, holding the kinds whose required
    # fields validation checks.
    for d, kinds in ((run, ("program_cost", "capture", "quality_drift")),
                     (rrun, ("replay_verdict",))):
        ev, bad = report.load_events(d)
        assert report.validate_events(ev, bad) == []
        for k in kinds:
            assert any(e["ev"] == k for e in ev), k
    rep = report.build_report_dir(run)
    assert rep["quality"]["captures"]["count"] == N_SERVED
    assert rep["quality"]["drift"]["snapshots"] == 1  # one per 64 answers
    assert report.build_report_dir(rrun)["quality"]["replay"]["agreement"] == 1.0


def _seeded(cfg, seed):
    return infer.build_model(cfg, seed=seed).state_dict()


def test_cli_replay_and_serve_refusals_match_jax(tmp_path, capsys):
    ring = str(tmp_path / "empty")
    os.makedirs(ring)
    for argv in (["replay", ring, "--checkpoint-dir", "ck", "--min-agreement",
                  "1.5"],
                 ["replay", ring, "--checkpoint-dir", "ck"]):
        msgs = []
        for main in (cli.main, jax_cli.main):
            with pytest.raises(SystemExit) as e:
                main(argv)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and msgs[0].startswith("replay: ")
    cfg = get_config("smoke16")
    ck = _checkpoint(str(tmp_path / "ck"), cfg, _seeded(cfg, 0))
    with pytest.raises(SystemExit, match="--capture needs --run-dir"):
        cli.main(["serve", "--checkpoint-dir", ck, "--device", "cpu",
                  "--capture"])
    with pytest.raises(SystemExit, match="--capture-sample"):
        cli.main(["serve", "--checkpoint-dir", ck, "--device", "cpu",
                  "--capture-dir", str(tmp_path / "c"), "--capture-sample", "2"])
    with pytest.raises(SystemExit, match="--quality-baseline"):
        cli.main(["serve", "--checkpoint-dir", ck, "--device", "cpu",
                  "--quality-baseline", str(tmp_path / "none.json")])
    seg = get_config("seg64", resolution=16, seg_features=(4, 8))
    seg_ck = _checkpoint(str(tmp_path / "seg"), seg, _seeded(seg, 0))
    with pytest.raises(SystemExit, match="need a classify checkpoint"):
        cli.main(["serve", "--checkpoint-dir", seg_ck, "--device", "cpu",
                  "--quality"])
