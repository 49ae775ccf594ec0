"""Data-parallel training across two processes on the CPU: one 2-rank
``gloo`` world of the port, spawned once (``_worker`` below, each rank on
one torch thread), runs every scenario at smoke16's widths on 16³ grids
and writes what it saw; the tests hold it against the JAX package and
against the port's own one-process run.

(a) One step on a global batch of 16, rank r holding rows ``[8r, 8r+8)``,
    against the reference's ``_grads_and_loss(make_mesh(), 1, batch)`` on
    its 8-device CPU mesh (``tests/test_parallel.py``) from the same
    weights, both models in fp32 and without dropout (as
    ``tests/test_torch_train.py`` holds the one-device step). Tolerances:
    the reference's (loss rtol 2e-5; parameters rtol 3e-4, atol 3e-6; batch
    statistics rtol 1e-3, atol 1e-4), and Adam's first moments, 0.1 times
    the global-mean gradient, within 3e-4 of each leaf's scale (the
    reference's parameter rtol: its 8-device mesh and the two ranks sum
    the batch in other orders; the first conv kernel's moments came 1.0e-4
    of their scale apart).
(b) Two steps of a cache-backed Trainer (device cube rotation, dropout 0.2,
    global batch 8) against the same steps of a one-process Trainer on the
    same global batches: the batch statistics after the first step (the
    learning rate is 0 there) within 1e-5 of each leaf's scale and the
    losses within 1e-5; the first moments within 1e-2 of each leaf's scale,
    because the model computes in bf16 and a weight gradient is a bf16
    product summed over the local batch (4 rows on a rank, 8 in one
    process), rounded at bf16's 2^-8 either way (the dense layers' came
    0.5 % of their scale apart); parameters after the second step within 2
    x the learning rate (Adam's first updates are close to lr x sign(g),
    and a gradient that is rounding noise may take the other sign).
(c) Every metric of every step bitwise equal on both ranks.
(d) The exact eval of (b) sharded by rank: both ranks return the same
    result, ``samples`` is the held-out count, and it agrees with the
    one-process eval: the same confusion matrix, the loss within 1e-4
    (the parameters it reads are (b)'s, 2 x lr apart).
(e) A resident (``hbm_cache``) run saved in lockstep and stopped at step 2
    by its planned-restart exit (75), then resumed by a new Trainer to step
    4: its step-4 checkpoint bitwise the unbroken run's.
(f) (e)'s run directory: ``events.jsonl`` and ``events.1.jsonl``, merged
    by the port's report into two hosts, with a clean schema.
(g) ``fp16_scaled``: rank 1 alone overflows (its loss scale 2^40), and
    both ranks skip the step bitwise, as they apply the next one together.
(h) A segmenter step (``ce_dice``, seg64's input context and decoder at
    features 8/16 on 16³ grids, global batch 4): its foreground share,
    its Dice sums and its batch norm are the global batch's, so the loss
    and ``fg_accuracy`` match the one-process step's within 1e-5 and the
    batch statistics within 1e-5 of each leaf's scale.
(i) A lockstep save torn by ``checkpoint_corrupt@save=2`` (rank 0 writes):
    the next run's ranks both restore step 1, the step rank 0's walk-back
    chose, and save step 2 whole again.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

R = 16
WORLD = 2
GLOO_TIMEOUT_S = 60
WORKER_TIMEOUT_S = 180


# --- the world's side (imports no JAX) ------------------------------------

def _save(path: str, obj) -> None:
    torch.save(obj, path)


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _opt_state(state) -> dict:
    names = [n for n, _ in state.model.named_parameters()]
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "mu": {n: t.clone() for n, t in zip(names, state.optimizer.mu)}}


def _rows(batch: dict, rank: int, world: int) -> dict:
    b = batch["voxels"].shape[0] // world
    return {k: torch.from_numpy(np.ascontiguousarray(v[rank * b:(rank + 1) * b]))
            for k, v in batch.items()}


def _scenario_a(work: str, rank: int) -> dict:
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.models.featurenet import FeatureNet, tiny_arch
    from featurenet_tpu_torch.train import steps
    from featurenet_tpu_torch.train.state import create_state

    arch = dataclasses.replace(tiny_arch(), dropout=0.0)
    model = FeatureNet(arch, R, dtype=torch.float32)
    model.load_state_dict(torch.load(os.path.join(work, "a_init.pt")))
    state = create_state(model, get_config("smoke16", global_batch=16))
    batch = dict(np.load(os.path.join(work, "a_batch.npz")))
    m = steps.make_train_step()(state, _rows(batch, rank, WORLD))
    _save(os.path.join(work, f"a_state.{rank}.pt"), _opt_state(state))
    return _metrics(m)


def _cfg_b(cache: str):
    from featurenet_tpu_torch.config import get_config

    return get_config("smoke16", global_batch=8, data_cache=cache, seed=3,
                      total_steps=10)


def _batches_b(cache: str) -> list[dict]:
    from featurenet_tpu_torch.data.offline import VoxelCacheDataset

    it = VoxelCacheDataset(cache, 8, seed=11).worker_iter(0)
    return [next(it) for _ in range(2)]


def _scenario_b(work: str, cache: str, rank: int, world: int) -> dict:
    """(b) and (d): two steps of a Trainer on this rank's rows, then its
    eval; (a one-process call gives the reference)."""
    from featurenet_tpu_torch.train.loop import Trainer

    tr = Trainer(_cfg_b(cache), device="cpu")
    out = {"steps": []}
    for i, batch in enumerate(_batches_b(cache)):
        out["steps"].append(_metrics(tr.step(_rows(batch, rank, world))))
        if i == 0:
            _save(os.path.join(work, f"b_state1.{rank}.pt"), _opt_state(tr.state))
    _save(os.path.join(work, f"b_state2.{rank}.pt"), _opt_state(tr.state))
    ev = tr.evaluate()
    out["eval"] = {k: v for k, v in ev.items() if k != "batches"}
    out["eval_batches"] = ev["batches"]
    out["held_out"] = len(tr.eval_data)
    return out


def _cfg_e(cache: str, work: str, name: str, **kw):
    from featurenet_tpu_torch.config import get_config

    return get_config("smoke16", global_batch=8, data_cache=cache,
                      hbm_cache=True, seed=5, total_steps=4, checkpoint_every=2,
                      log_every=1, eval_every=4,
                      checkpoint_dir=os.path.join(work, name), **kw)


def _scenario_e(work: str, cache: str) -> dict:
    from featurenet_tpu_torch import obs
    from featurenet_tpu_torch.train.loop import Trainer

    unbroken = Trainer(_cfg_e(cache, work, "ck_unbroken"), device="cpu")
    last_u = unbroken.run()
    run = os.path.join(work, "run_e")
    cfg = _cfg_e(cache, work, "ck_resumed", restart_every_steps=2, run_dir=run)
    try:
        Trainer(cfg, device="cpu").run()
        code = None
    except SystemExit as e:
        code = e.code
    resumed = Trainer(cfg, device="cpu")
    last_r = resumed.run()
    obs.close_run()
    keep = ("loss", "accuracy", "grad_norm", "eval_accuracy", "eval_loss",
            "eval_samples")
    return {"exit_code": code, "unbroken": {k: last_u[k] for k in keep},
            "resumed": {k: last_r[k] for k in keep},
            "records": [{k: r[k] for k in ("step", "loss", "accuracy",
                                           "grad_norm")}
                        for r in resumed.logger.history if r["kind"] == "train"]}


def _scenario_g(rank: int) -> dict:
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch, to_wire
    from featurenet_tpu_torch.train.loop import Trainer

    tr = Trainer(get_config("smoke16", global_batch=8, seed=4,
                            train_precision="fp16_scaled"), device="cpu")
    rng = np.random.default_rng(9)
    batches = [to_wire(generate_batch(rng, 8, R)) for _ in range(2)]
    before = {k: v.clone() for k, v in tr.state.model.state_dict().items()}
    tr.state.loss_scale.fill_(2.0 ** 40 if rank == 1 else 1.0)
    skipped = _metrics(tr.step(_rows(batches[0], rank, WORLD)))
    after = tr.state.model.state_dict()
    same = all(torch.equal(before[k], after[k]) for k in before)
    tr.state.loss_scale.fill_(1.0)
    applied = _metrics(tr.step(_rows(batches[1], rank, WORLD)))
    moved = not all(torch.equal(before[k], v)
                    for k, v in tr.state.model.state_dict().items())
    return {"skipped": skipped, "unchanged": same, "applied": applied,
            "moved": moved, "step": tr.state.step}


def _cfg_h():
    from featurenet_tpu_torch.config import get_config

    return get_config("seg64", resolution=16, seg_features=(8, 16),
                      global_batch=4, num_features=2, seed=6)


def _batch_h() -> dict:
    from featurenet_tpu_torch.data.synthetic import generate_batch, to_wire

    return to_wire(generate_batch(np.random.default_rng(13), 4, R,
                                  num_features=2), "segment")


def _scenario_h(work: str, rank: int, world: int) -> dict:
    from featurenet_tpu_torch.train.loop import Trainer

    tr = Trainer(_cfg_h(), device="cpu")
    m = _metrics(tr.step(_rows(_batch_h(), rank, world)))
    _save(os.path.join(work, f"h_state.{rank}.pt"), _opt_state(tr.state))
    return m


def _scenario_i(work: str, cache: str) -> dict:
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.loop import Trainer

    cfg = dataclasses.replace(
        _cfg_e(cache, work, "ck_torn", inject_faults="checkpoint_corrupt@save=2"),
        total_steps=2, checkpoint_every=1)
    Trainer(cfg, device="cpu").run()
    resumed = Trainer(dataclasses.replace(cfg, inject_faults=None), device="cpu")
    resumed.run()
    ck = CheckpointManager(cfg.checkpoint_dir)
    return {"restored": resumed.ckpt.restored_step, "latest": ck.latest_step(),
            "verified": ck.verify()}


def _worker() -> None:
    """One rank: ``argv`` = rank, port, work directory, cache."""
    import datetime

    import torch.distributed as dist

    rank, port, work, cache = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    try:
        out = {"a": _scenario_a(work, rank),
               "b": _scenario_b(work, cache, rank, WORLD),
               "e": _scenario_e(work, cache),
               "g": _scenario_g(rank),
               "h": _scenario_h(work, rank, WORLD),
               "i": _scenario_i(work, cache)}
        with open(os.path.join(work, f"result.{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


# --- the test's side -------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(work: str, cache: str) -> list[subprocess.Popen]:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    code = (f"import sys; sys.path[:0] = [{root!r}, {here!r}]; "
            "import test_torch_multiproc as t; t._worker()")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, "-c", code, str(r), port, work,
                              cache], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def _wait(procs) -> list[tuple[int, str]]:
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    out = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            text, _ = p.communicate()
        out.append((p.returncode, text))
    return out


def _jax_reference(work: str) -> dict:
    """The reference's one step over its 8-device data mesh, from the
    weights the world starts from (saved for it in port names)."""
    import jax
    import jax.numpy as jnp
    import test_parallel as ref

    from featurenet_tpu.config import get_config as jax_get_config
    from featurenet_tpu.data.synthetic import generate_batch, to_wire
    from featurenet_tpu.models import FeatureNet as JaxFeatureNet
    from featurenet_tpu.models.featurenet import tiny_arch as jax_tiny_arch
    from featurenet_tpu.parallel.mesh import make_mesh
    from featurenet_tpu.train.state import create_state as jax_create_state
    from featurenet_tpu.train.steps import make_optimizer
    from featurenet_tpu_torch import convert
    from featurenet_tpu_torch.models.featurenet import tiny_arch

    batch = generate_batch(np.random.default_rng(21), 16, resolution=R)
    np.savez(os.path.join(work, "a_batch.npz"), **to_wire(batch, "classify"))
    jarch = dataclasses.replace(jax_tiny_arch(), dropout=0.0)
    arch = dataclasses.replace(tiny_arch(), dropout=0.0)

    def np32(tree):
        return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                      jax.device_get(tree))

    init = jax_create_state(
        JaxFeatureNet(arch=jarch, dtype=jnp.float32),
        make_optimizer(jax_get_config("smoke16", global_batch=16)),
        jnp.zeros(batch["voxels"].shape, jnp.float32), jax.random.key(0))
    torch.save(convert.from_flax(np32({"params": init.params,
                                       "batch_stats": init.batch_stats}), arch),
               os.path.join(work, "a_init.pt"))
    saved = ref.tiny_arch
    ref.tiny_arch = lambda: jarch  # the one-device comparison's dropout 0
    try:
        s8, m8 = ref._grads_and_loss(make_mesh(), 1, batch)
    finally:
        ref.tiny_arch = saved
    return {
        "loss": float(m8["loss"]),
        "state": convert.from_flax(np32({"params": s8.params,
                                         "batch_stats": s8.batch_stats}), arch),
        "mu": convert.from_flax(np32({"params": s8.opt_state[0].mu,
                                      "batch_stats": s8.batch_stats}), arch),
    }


def _one_process_b(cache: str) -> dict:
    """The port's one-process Trainer on (b)'s global batches."""
    from featurenet_tpu_torch.train.loop import Trainer

    torch.set_num_threads(1)
    tr = Trainer(_cfg_b(cache), device="cpu")
    out = {"steps": []}
    for i, batch in enumerate(_batches_b(cache)):
        out["steps"].append(_metrics(tr.step(_rows(batch, 0, 1))))
        if i == 0:
            out["state1"] = _opt_state(tr.state)
    out["state2"] = _opt_state(tr.state)
    out["lr"] = float(tr.state.optimizer.schedule(1))
    ev = tr.evaluate()
    out["eval"] = {k: v for k, v in ev.items() if k != "batches"}
    seg = Trainer(_cfg_h(), device="cpu")
    out["h"] = _metrics(seg.step(_rows(_batch_h(), 0, 1)))
    out["h_state"] = _opt_state(seg.state)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from featurenet_tpu_torch.data.offline import export_synthetic_cache

    work = str(tmp_path_factory.mktemp("dp"))
    cache = os.path.join(work, "cache")
    export_synthetic_cache(cache, per_class=4, resolution=R, seed=2)
    threads = torch.get_num_threads()
    try:
        ref = _jax_reference(work)  # writes the world's inputs first
        out = None
        for _ in range(2):  # a second try only when the port was taken
            procs = _spawn(work, cache)
            one = _one_process_b(cache)  # while the world runs
            out = _wait(procs)
            if not any("ddress already in use" in t for _, t in out):
                break
    finally:
        torch.set_num_threads(threads)
    for code, text in out:
        assert code == 0, text[-4000:]
    results = []
    for r in range(WORLD):
        with open(os.path.join(work, f"result.{r}.json")) as fh:
            results.append(json.load(fh))
    return {"work": work, "cache": cache, "ref": ref, "one": one,
            "ranks": results}


def _load(world, name: str, rank: int) -> dict:
    return torch.load(os.path.join(world["work"], f"{name}.{rank}.pt"))


def _close_leaves(got: dict, want: dict, rel: float, keys) -> None:
    for k in keys:
        w, g = np.asarray(want[k]), got[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (k, err, scale)


def _stats(d: dict) -> list[str]:
    return [k for k in d if k.endswith((".mean", ".var"))]


def test_a_two_rank_step_matches_the_reference_data_mesh(world):
    ref = world["ref"]
    got = _load(world, "a_state", 0)
    np.testing.assert_allclose(world["ranks"][0]["a"]["loss"], ref["loss"],
                               rtol=2e-5)
    model, want = got["model"], ref["state"]
    params = [k for k in want if k not in _stats(want)]
    for k in params:
        np.testing.assert_allclose(model[k].numpy(), np.asarray(want[k]),
                                   rtol=3e-4, atol=3e-6, err_msg=k)
    for k in _stats(want):
        np.testing.assert_allclose(model[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    _close_leaves(got["mu"], ref["mu"], 3e-4, got["mu"])


def test_b_two_rank_steps_match_one_process(world):
    one = world["one"]
    for rank in range(WORLD):
        ranks = world["ranks"][rank]["b"]["steps"]
        for got, want in zip(ranks, one["steps"]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        s1 = _load(world, "b_state1", rank)
        _close_leaves(s1["model"], one["state1"]["model"], 1e-5,
                      _stats(one["state1"]["model"]))
        _close_leaves(s1["mu"], one["state1"]["mu"], 1e-2, s1["mu"])
        s2 = _load(world, "b_state2", rank)["model"]
        bound = 2 * one["lr"] + 1e-6
        for k, v in one["state2"]["model"].items():
            assert float((s2[k] - v).abs().max()) <= bound, k


def test_c_metrics_are_bitwise_equal_on_every_rank(world):
    r0, r1 = world["ranks"]
    assert r0["a"] == r1["a"]
    assert r0["b"]["steps"] == r1["b"]["steps"]
    assert r0["e"]["records"] == r1["e"]["records"]
    assert len(r0["e"]["records"]) == 2  # steps 3 and 4 of the resumed run
    # Only the loss scales differ: (g) set them apart on purpose.
    for g in (r0["g"], r1["g"]):
        g["skipped"].pop("loss_scale")
    assert r0["g"] == r1["g"]
    s0, s1 = _load(world, "b_state2", 0), _load(world, "b_state2", 1)
    for k in s0["model"]:
        assert torch.equal(s0["model"][k], s1["model"][k]), k


def test_d_sharded_exact_eval_counts_each_sample_once(world):
    r0, r1 = (r["b"] for r in world["ranks"])
    assert r0["eval"] == r1["eval"]
    assert r0["eval"]["samples"] == r0["held_out"]
    assert r0["eval_batches"] == r1["eval_batches"]
    one = world["one"]["eval"]
    assert r0["eval"]["samples"] == one["samples"]
    assert r0["eval"]["confusion"] == one["confusion"]
    np.testing.assert_allclose(r0["eval"]["loss"], one["loss"], rtol=1e-4)


def test_e_lockstep_save_and_resume_are_bitwise_the_unbroken_run(world):
    work = world["work"]
    for r in world["ranks"]:
        e = r["e"]
        assert e["exit_code"] == 75
        assert e["resumed"] == e["unbroken"]
    got = torch.load(os.path.join(work, "ck_resumed", "step_4.pt"))
    want = torch.load(os.path.join(work, "ck_unbroken", "step_4.pt"))
    assert got["step"] == want["step"] == 4
    for group in ("model", "mu", "nu"):
        for k in want[group]:
            assert torch.equal(got[group][k], want[group][k]), (group, k)
    for name in ("ck_resumed", "ck_unbroken"):
        files = sorted(os.listdir(os.path.join(work, name)))
        assert files == ["checksum.2.json", "checksum.4.json", "config.json",
                         "step_2.pt", "step_4.pt"], files


def test_f_per_rank_event_streams_merge_in_the_report(world):
    from featurenet_tpu_torch.obs.report import (
        build_report,
        format_report,
        load_events,
        load_manifest,
        validate_events,
    )

    run = os.path.join(world["work"], "run_e")
    assert {"events.jsonl", "events.1.jsonl", "run.json"} <= set(os.listdir(run))
    events, bad = load_events(run)
    assert bad == 0
    assert {e["process_index"] for e in events} == {0, 1}
    starts = [e for e in events if e["ev"] == "loop_start"]
    assert len(starts) == 4  # two segments on each rank
    for e in starts:
        assert e["mesh"] == {"data": 2, "model": 1, "devices": 2,
                             "processes": 2, "backend": "gloo"}
        assert e["global_batch"] == 8
    assert load_manifest(run)["torch"]["process_count"] == 2
    rep = build_report(events, load_manifest(run))
    assert sorted(rep["hosts"]) == [0, 1]
    assert "hosts: 2" in format_report(rep)
    assert sum(1 for e in events if e["ev"] == "run_end") == 2
    assert validate_events(events, bad_lines=bad) == []


def test_g_fp16_overflow_on_one_rank_skips_on_every_rank(world):
    for r in world["ranks"]:
        g = r["g"]
        assert g["skipped"]["grads_finite"] == 0.0 and g["unchanged"]
        assert g["applied"]["grads_finite"] == 1.0 and g["moved"]
        assert g["step"] == 2
    # Rank 0's rows alone, at its own scale, would have applied.
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.data.synthetic import generate_batch, to_wire
    from featurenet_tpu_torch.train.loop import Trainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = Trainer(get_config("smoke16", global_batch=4, seed=4,
                                train_precision="fp16_scaled"), device="cpu")
        tr.state.loss_scale.fill_(1.0)
        batch = to_wire(generate_batch(np.random.default_rng(9), 8, R))
        assert float(tr.step(_rows(batch, 0, 2))["grads_finite"]) == 1.0
    finally:
        torch.set_num_threads(threads)


def test_h_segment_step_uses_the_global_batch(world):
    one = world["one"]
    for rank in range(WORLD):
        got = world["ranks"][rank]["h"]
        for k in ("loss", "fg_accuracy", "accuracy"):
            np.testing.assert_allclose(got[k], one["h"][k], rtol=1e-5, err_msg=k)
        model = _load(world, "h_state", rank)["model"]
        _close_leaves(model, one["h_state"]["model"], 1e-5,
                      _stats(one["h_state"]["model"]))
    assert world["ranks"][0]["h"] == world["ranks"][1]["h"]


def test_i_torn_lockstep_save_is_walked_back_by_every_rank(world):
    for r in world["ranks"]:
        assert r["i"] == {"restored": 1, "latest": 2, "verified": 2}
