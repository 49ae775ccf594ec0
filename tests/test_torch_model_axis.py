"""The mesh's model axis (``featurenet_tpu_torch/parallel/mesh.py``): column
parallelism and spatial (depth) partitioning, against the JAX package.

- ``param_shardings``/``state_shardings`` against the reference's on the
  same parameters (the default arch at R=32, names mapped through
  ``convert.py``; the port's dense weights are the transpose of the
  reference's kernels, so their specs are reversed).
- The halo conv and the slab stem in one process: M threads stand for the
  M model ranks of one data row, their collectives a rendezvous patched
  over ``mesh._gather`` and ``mesh._reduce``; each thread runs the forward
  and the backward of its depth slab, and the slabs' outputs, input
  gradients (the exchanged planes' returned to their owner) and summed
  weight gradients are held against the whole grid's conv (rtol/atol
  1e-5), and the forward against the JAX package's conv (1e-4, as
  ``tests/test_torch_stem.py``).
- One real 4-rank ``gloo`` world (``data=2 × model=2``, the reference's
  ``mesh42``), spawned once, each rank on one torch thread, runs in turn:

  (a) a column-parallel step on an arch with a 64-wide conv and a 64-wide
      FC at R=16 (global batch 16) and (b) a spatial step on a narrow
      ``deep_arch`` at R=32 (7³/s2 stem, residual skips, a 64-wide last
      conv, GAP; global batch 8), each against the JAX package's
      one-device ``make_train_step`` from the same weights, both in fp32
      without dropout, to the reference's tolerances:

      - through ``make_train_step`` on the wire batch: the loss (rtol
        2e-5), the parameters (rtol 3e-4, atol 3e-6, as
        ``tests/test_parallel.py`` holds its mesh42 step, whose learning
        rate is 0 at step 0) and the batch statistics (rtol 1e-3, atol
        1e-4); the gradients, through Adam's first moments (0.1 x the
        gradient), within 3e-4 of each leaf's scale of the port's own
        one-process step on the same rows, a second witness;
      - the gradients against the reference's: the same step (the train
        step's ``loss_and_grads``, ``sync_gradients`` and update) on the
        batch's voxels made non-binary and centred (``_floats``), the
        first moments within 3e-4 of each leaf's scale (as
        ``tests/test_torch_multiproc.py`` holds its world's), the loss
        and the batch statistics as above. Binary (or [0, 1]) voxels put
        the blocks' batch means far from 0, where the reference's fp32
        statistics on the CPU (Flax's ``E[x²] - E[x]²`` over XLA's
        sums) are ill conditioned: on [0, 1] voxels its train step's
        gradients of the first blocks fall farther from a float64
        evaluation of the same step than this tolerance (its convs in
        float64 change them little), while the port's one-process step
        stays well inside it; on the centred voxels the two packages'
        steps agree well inside it.

      Every rank's metrics are bitwise equal.
  (c) a checkpoint round trip of a smoke16 ``Trainer`` at ``mesh_model=2``
      (its 64-wide FC column-sharded): the lockstep save gathers the
      shards into the one-process layout; a new world's Trainer restores
      step 1 and its step 2 is bitwise the unbroken run's; then in this
      process a one-process Trainer restores the same file and its exact
      eval of a cache's held-out split (sharded over the data axis in the
      world) counts the same samples into the same confusion matrix, its
      loss within 1e-5.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from featurenet_tpu_torch.parallel import mesh

WORLD = 4
MODEL = 2
GLOO_TIMEOUT_S = 60
WORKER_TIMEOUT_S = 180


# --- the rules ----------------------------------------------------------------

def test_param_and_state_shardings_match_the_reference():
    import jax
    import jax.numpy as jnp

    from featurenet_tpu.config import get_config as jax_get_config
    from featurenet_tpu.models import FeatureNet as JaxFeatureNet
    from featurenet_tpu.parallel import mesh as jax_mesh
    from featurenet_tpu.train.state import create_state as jax_create_state
    from featurenet_tpu.train.steps import make_optimizer
    from featurenet_tpu_torch import convert
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.models.featurenet import FeatureNet
    from featurenet_tpu_torch.train.state import create_state

    jstate = jax.eval_shape(lambda key: jax_create_state(
        JaxFeatureNet(dtype=jnp.float32), make_optimizer(jax_get_config("pod64")),
        jnp.zeros((1, 32, 32, 32, 1), jnp.float32), key), jax.random.key(0))
    spec = jax.tree_util.tree_map(
        lambda s: tuple(s.spec), jax_mesh.state_shardings(
            jstate, jax_mesh.make_mesh(model=MODEL)),
        is_leaf=lambda s: hasattr(s, "spec"))
    port_mesh = mesh.make_mesh(model=MODEL, devices=[
        mesh.MeshDevice(i) for i in range(len(jax.devices()))])
    model = FeatureNet(get_config("pod64").arch, 32)
    got = mesh.param_shardings(model.named_parameters(), port_mesh)

    def ref_names(tree):
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, tuple))[0]
        return {"/".join(getattr(k, "key", str(k)) for k in path): v
                for path, v in flat}

    ref = ref_names(spec.params)

    def port_name(path: str) -> str:
        scope, leaf = path.split("/", 1)[0], path.rsplit("/", 1)[1]
        if scope.startswith("ConvBNRelu_"):
            i = int(scope.split("_")[1])
            return (f"blocks.{i}.conv.kernel" if leaf == "kernel"
                    else f"blocks.{i}.{leaf}")
        j = int(scope.split("_")[1])
        return f"dense{j}.{'weight' if leaf == 'kernel' else 'bias'}"

    # The names as convert.py maps the reference's tree.
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   {"params": jstate.params,
                                    "batch_stats": jstate.batch_stats})
    mapped = {n for n in convert.from_flax(zeros)
              if not n.endswith((".mean", ".var"))}
    assert {port_name(p) for p in ref} == set(got) == mapped
    sharded = 0
    for path, r in ref.items():
        name = port_name(path)
        p = got[name]
        if name.startswith("dense") and name.endswith(".weight"):
            p = p[::-1]  # [out, in] against the reference's [in, out]
        if p:
            assert p == r, (path, r, got[name])
        else:
            assert all(x is None for x in r), (path, r)
        sharded += bool(p)
    # The two 64-wide convs and FC-128 shard; the 32-wide convs and FC-24 not.
    assert sharded == 3
    # The moments follow their parameters; the batch statistics replicate.
    port_state = create_state(model, get_config("pod64"))
    st = mesh.state_shardings(port_state, port_mesh)
    assert st["mu"] == got and st["nu"] == got
    assert all(not st["model"][k] for k in st["model"]
               if k.endswith((".mean", ".var")))
    mu = ref_names(spec.opt_state[0].mu)
    for path, s in mu.items():
        assert bool(st["mu"][port_name(path)]) == any(x is not None for x in s)
    stats = ref_names(spec.batch_stats)
    assert stats and all(all(x is None for x in s) for s in stats.values())


def test_model_axis_of_one_shards_nothing():
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.models.featurenet import FeatureNet

    one = mesh.make_mesh(devices=[mesh.MeshDevice(0), mesh.MeshDevice(1)])
    got = mesh.param_shardings(
        FeatureNet(get_config("pod64").arch, 32).named_parameters(), one)
    assert not any(got.values())
    assert mesh.depth_block(mesh.make_mesh(model=2, devices=[
        mesh.MeshDevice(i) for i in range(4)]), 128, process_index=3) == (64, 128)


# --- one process: M threads for M model ranks ---------------------------------

class _Ranks:
    """M threads exchanging tensors at a barrier, in model-rank order."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n
        self.me = threading.local()

    def exchange(self, t: torch.Tensor) -> list[torch.Tensor]:
        self.barrier.wait()
        self.slots[self.me.index] = t.detach().clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out

    def patch(self, monkeypatch) -> None:
        monkeypatch.setattr(mesh, "_gather", lambda t, axis: self.exchange(t))

        def reduce(t, group):
            parts = self.exchange(t.contiguous())
            out = parts[0].clone()
            for p in parts[1:]:
                out += p
            return out

        monkeypatch.setattr(mesh, "_reduce", reduce)

    def run(self, fn) -> list:
        """``fn(m)`` on a thread per model rank ``m``; their results."""
        out, errors = [None] * self.n, []

        def body(m):
            self.me.index = m
            try:
                out[m] = fn(m)
            except BaseException as e:  # re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(m,)) for m in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def _slab_grads(ranks: _Ranks, fn, x, w, g, sharded: bool):
    """Each rank's forward on its depth slab of ``x`` (and, ``sharded``,
    its columns of ``w``) and the backward of ``Σ out·g``: the slabs'
    outputs and input gradients concatenated in depth, and ``w``'s
    gradient (the shards' concatenated, or the slabs' partials summed)."""
    m = ranks.n
    d, c = x.shape[1] // m, w.shape[-1] // m

    def one(i):
        axis = mesh.ModelAxis(size=m, index=i, spatial=True)
        xs = x[:, i * d:(i + 1) * d].clone().requires_grad_()
        ws = (w[..., i * c:(i + 1) * c] if sharded else w).clone().requires_grad_()
        y = fn(axis, xs, ws)
        (y * g[:, y.shape[1] * i:y.shape[1] * (i + 1)]).sum().backward()
        return y.detach(), xs.grad, ws.grad

    outs = ranks.run(one)
    dw = (torch.cat([o[2] for o in outs], dim=-1) if sharded
          else sum(o[2] for o in outs))
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=1), dw)


def _full_grads(fn, x, w, g):
    xf, wf = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(xf, wf)
    (y * g).sum().backward()
    return y.detach(), xf.grad, wf.grad


def _block(axis, sharded: bool, stride: int, w: torch.Tensor):
    """A ``ConvBNRelu`` of the pallas backend laid on ``axis`` whose conv
    reads ``w`` (this rank's kernel, a leaf of the test's graph)."""
    from featurenet_tpu_torch.models.featurenet import ConvBNRelu

    b = ConvBNRelu(w.shape[3], w.shape[4], w.shape[0], stride, torch.float32,
                   "pallas", plain=False)
    del b.conv.kernel
    b.conv.kernel = w
    b.axis, b.sharded = axis, sharded
    return b


def _close(got, want, tol=1e-5):
    for a, b, what in zip(got, want, ("forward", "dx", "dW")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol, atol=tol,
                                   err_msg=what)


@pytest.mark.parametrize("m,k,sharded", [(2, 3, False), (4, 3, False),
                                         (2, 5, False), (2, 3, True)])
def test_halo_conv_on_slabs_matches_the_whole_grid(monkeypatch, m, k, sharded):
    import jax
    import jax.numpy as jnp

    from featurenet_tpu_torch.ops.conv3d import conv3d_p

    rng = np.random.default_rng(10 * m + k)
    x = torch.from_numpy(rng.standard_normal((2, 8, 6, 5, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, k, k, 3, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 8, 6, 5, 4)).astype(np.float32))
    ranks = _Ranks(m)
    ranks.patch(monkeypatch)

    got = _slab_grads(ranks, lambda axis, xs, ws: _block(
        axis, sharded, 1, ws).convolve(xs), x, w, g, sharded)
    want = _full_grads(conv3d_p, x, w, g)
    _close(got, want)
    jax_y = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_y), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("k,s", [(7, 2), (5, 4)])
def test_slab_stem_matches_the_whole_grid(monkeypatch, k, s):
    import jax.numpy as jnp

    from featurenet_tpu.ops import stem as jax_stem
    from featurenet_tpu_torch.ops import stem

    rng = np.random.default_rng(k * 10 + s)
    r = 16
    x = torch.from_numpy(rng.standard_normal((2, r, r, r, 1)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, k, k, 1, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (2, r // s, r // s, r // s, 8)).astype(np.float32))
    ranks = _Ranks(2)
    ranks.patch(monkeypatch)
    got = _slab_grads(ranks, lambda axis, xs, ws: _block(
        axis, False, s, ws).convolve(xs), x, w, g, False)
    want = _full_grads(lambda a, b: stem.space_to_depth_conv(a, b, s), x, w, g)
    _close(got, want)
    jax_y = jax_stem.space_to_depth_conv(jnp.asarray(x.numpy()),
                                         jnp.asarray(w.numpy()), s)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jax_y), rtol=1e-4,
                               atol=1e-4)


# --- the 4-rank world (imports no JAX) ------------------------------------------

def _cols_arch():
    from featurenet_tpu_torch.models.featurenet import FeatureNetArch

    return FeatureNetArch(features=(16, 64), kernels=(3, 3), strides=(1, 1),
                          pool_after=(True, True), hidden=64, dropout=0.0)


def _spatial_arch():
    from featurenet_tpu_torch.models.featurenet import deep_arch

    return dataclasses.replace(deep_arch(), features=(8, 16, 16, 32, 32, 64),
                               hidden=64, dropout=0.0)


CASES = {"a": (_cols_arch, 16, 16, False), "b": (_spatial_arch, 32, 8, True)}


def _step_case(work: str, name: str, rank: int, floats: bool = False) -> dict:
    """(a)/(b): one step of the world from the reference's initial
    weights on this rank's rows (and slab): the wire batch through
    ``make_train_step``, or with ``floats`` the non-binary voxels through
    the step's own ``loss_and_grads``, ``sync_gradients`` and update;
    rank 0 saves the gathered state."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.models.featurenet import FeatureNet
    from featurenet_tpu_torch.train import steps
    from featurenet_tpu_torch.train.checkpoint import _snapshot
    from featurenet_tpu_torch.train.state import create_state

    arch_fn, r, batch_n, spatial = CASES[name]
    model = FeatureNet(arch_fn(), r, dtype=torch.float32)
    model.load_state_dict(torch.load(os.path.join(work, f"{name}_init.pt")))
    m = mesh.make_mesh(model=MODEL, devices=mesh.world_devices())
    model.shard(mesh.model_axis(m, spatial))
    state = create_state(model, get_config("smoke16", global_batch=batch_n))
    tag = f"{name}_floats" if floats else name
    batch = dict(np.load(os.path.join(work, f"{tag}_batch.npz")))
    lo, hi = mesh.row_block(m, batch_n)
    rows = {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
            for k, v in batch.items()}
    if floats:
        grads, metrics = steps.loss_and_grads(
            model, steps.model_slab(model, rows["voxels"]), rows["label"])
        grads, metrics = steps.sync_gradients(
            grads, {k: v.detach() for k, v in metrics.items()}, model)
        state.apply_gradients(grads)
    else:
        metrics = steps.make_train_step()(state, rows)
    snap = _snapshot(state)  # a collective: every rank gathers
    if rank == 0:
        torch.save({"model": snap["model"], "mu": snap["mu"]},
                   os.path.join(work, f"{tag}_state.pt"))
    return {k: float(v) for k, v in metrics.items()}


def _cfg_c(work: str, name: str):
    from featurenet_tpu_torch.config import get_config

    return get_config("smoke16", global_batch=8, mesh_model=MODEL, seed=5,
                      data_cache=os.path.join(work, "cache"),
                      checkpoint_dir=os.path.join(work, name))


def _batches_c() -> list[dict]:
    from featurenet_tpu_torch.data.synthetic import generate_batch, to_wire

    rng = np.random.default_rng(17)
    return [to_wire(generate_batch(rng, 8, 16)) for _ in range(2)]


def _case_c(work: str) -> dict:
    """(c): two steps saved in lockstep; a new Trainer restores step 1 and
    takes step 2 again; the world's eval of step 2."""
    from featurenet_tpu_torch.train.checkpoint import _snapshot
    from featurenet_tpu_torch.train.loop import Trainer

    def rows(tr, batch):
        lo, hi = mesh.row_block(tr.mesh, 8)
        return {k: torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
                for k, v in batch.items()}

    batches = _batches_c()
    tr = Trainer(_cfg_c(work, "ck"), device="cpu")
    for b in batches:
        tr.step(rows(tr, b))
        tr.ckpt.save(tr.state)
    tr.ckpt.close()
    unbroken = _snapshot(tr.state)
    ev = tr.evaluate()
    again = Trainer(_cfg_c(work, "ck"), device="cpu")
    again.ckpt.restore(again.state, step=1)
    again.step(rows(again, batches[1]))
    resumed = _snapshot(again.state)
    same = all(torch.equal(unbroken[g][k], resumed[g][k])
               for g in ("model", "mu", "nu") for k in unbroken[g])
    local = {n: tuple(p.shape) for n, p in tr.state.model.named_parameters()}
    return {"bitwise": same and again.state.step == 2,
            "eval": {k: v for k, v in ev.items() if k != "batches"},
            "local_shapes": local, "mesh": mesh.mesh_summary(tr.mesh)}


def _worker() -> None:
    """One rank: ``argv`` = rank, port, work directory."""
    import datetime

    import torch.distributed as dist

    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=WORLD, timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    try:
        out = {**{n: _step_case(work, n, rank) for n in CASES},
               **{f"{n}_floats": _step_case(work, n, rank, floats=True)
                  for n in CASES},
               "c": _case_c(work)}
        with open(os.path.join(work, f"result.{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


# --- the test's side ------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(work: str) -> list[subprocess.Popen]:
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    code = (f"import sys; sys.path[:0] = [{root!r}, {here!r}]; "
            "import test_torch_model_axis as t; t._worker()")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, "-c", code, str(r), port, work],
                             env=env, stdout=subprocess.PIPE,
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


def _floats(batch: dict, seed: int) -> dict:
    """``batch`` with voxels ``1.5·occupancy + 0.5·U[0,1) - 1``: no two
    alike, and centred, so every block's batch statistics are well
    conditioned (see the module docstring)."""
    noise = np.random.default_rng(seed).random(batch["voxels"].shape)
    return {**batch, "voxels": (1.5 * batch["voxels"] + 0.5 * noise
                                - 1.0).astype(np.float32)}


def _write_inputs(work: str) -> dict:
    """Each step case's initial weights (the reference's init, in port
    names), its global batch and that batch with non-binary voxels
    (``_floats``), written for the world; returns the batches as the
    reference takes them, the latter under ``<case>_floats``."""
    import jax
    import jax.numpy as jnp

    from featurenet_tpu.config import get_config as jax_get_config
    from featurenet_tpu.data.synthetic import generate_batch, to_wire
    from featurenet_tpu.models import FeatureNet as JaxFeatureNet
    from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
    from featurenet_tpu.train.state import create_state as jax_create_state
    from featurenet_tpu.train.steps import make_optimizer
    from featurenet_tpu_torch import convert

    batches = {}
    for name, (arch_fn, r, n, _) in CASES.items():
        arch = arch_fn()
        batch = batches[name] = generate_batch(np.random.default_rng(21 + r), n,
                                               resolution=r)
        np.savez(os.path.join(work, f"{name}_batch.npz"),
                 **to_wire(batch, "classify"))
        floats = batches[f"{name}_floats"] = _floats(batch, 31 + r)
        np.savez(os.path.join(work, f"{name}_floats_batch.npz"),
                 **{k: floats[k] for k in ("voxels", "label", "mask")})
        jarch = _jax_arch(JaxArch, arch)
        init = jax_create_state(
            JaxFeatureNet(arch=jarch, dtype=jnp.float32),
            make_optimizer(jax_get_config("smoke16", global_batch=n)),
            jnp.zeros(batch["voxels"].shape, jnp.float32), jax.random.key(0))
        torch.save(convert.from_flax(_np32({"params": init.params,
                                            "batch_stats": init.batch_stats}),
                                     arch),
                   os.path.join(work, f"{name}_init.pt"))
    return batches


def _jax_arch(cls, arch):
    return cls(features=tuple(arch.features), kernels=tuple(arch.kernels),
               strides=tuple(arch.strides), pool_after=tuple(arch.pool_after),
               hidden=arch.hidden, dropout=arch.dropout,
               num_classes=arch.num_classes, head_gap=arch.head_gap,
               residual=arch.residual)


def _np32(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  jax.device_get(tree))


def _jax_references(batches: dict) -> dict:
    """The reference's one-device step of each case and of its
    non-binary batch (its ``tests/test_parallel.py`` ``_grads_and_loss``
    on ``mesh1``)."""
    import jax

    import test_parallel as ref
    from featurenet_tpu.models.featurenet import FeatureNetArch as JaxArch
    from featurenet_tpu.parallel.mesh import make_mesh
    from featurenet_tpu_torch import convert

    out = {}
    saved = ref.tiny_arch
    try:
        for name in batches:
            arch = CASES[name[0]][0]()
            ref.tiny_arch = lambda: _jax_arch(JaxArch, arch)
            s1, m1 = ref._grads_and_loss(
                make_mesh(data=1, model=1, devices=jax.devices()[:1]), 1,
                batches[name])
            out[name] = {
                "loss": float(m1["loss"]),
                "state": convert.from_flax(_np32({"params": s1.params,
                                                  "batch_stats": s1.batch_stats}),
                                           arch),
                "mu": _params_only(convert.from_flax(
                    _np32({"params": s1.opt_state[0].mu,
                           "batch_stats": s1.batch_stats}), arch))}
    finally:
        ref.tiny_arch = saved
    return out


def _one_process(work: str) -> dict:
    """The port's one-process step of each case: Adam's first moments."""
    from featurenet_tpu_torch.config import get_config
    from featurenet_tpu_torch.models.featurenet import FeatureNet
    from featurenet_tpu_torch.train import steps
    from featurenet_tpu_torch.train.state import create_state

    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, (arch_fn, r, n, _) in CASES.items():
            model = FeatureNet(arch_fn(), r, dtype=torch.float32)
            model.load_state_dict(torch.load(os.path.join(work, f"{name}_init.pt")))
            state = create_state(model, get_config("smoke16", global_batch=n))
            batch = np.load(os.path.join(work, f"{name}_batch.npz"))
            steps.make_train_step()(state, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
            names = [k for k, _ in model.named_parameters()]
            out[name] = dict(zip(names, state.optimizer.mu))
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from featurenet_tpu_torch.data.offline import export_synthetic_cache

    work = str(tmp_path_factory.mktemp("model_axis"))
    batches = _write_inputs(work)
    export_synthetic_cache(os.path.join(work, "cache"), per_class=2,
                           resolution=16, seed=2)
    out = None
    for _ in range(2):  # a second try only when the port was taken
        procs = _spawn(work)
        ref = _jax_references(batches)  # while the world runs
        one = _one_process(work)
        out = _wait(procs)
        if not any("ddress already in use" in t for _, t in out):
            break
    for code, text in out:
        assert code == 0, text[-4000:]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(work, f"result.{r}.json")) as fh:
            ranks.append(json.load(fh))
    return {"work": work, "ref": ref, "one": one, "ranks": ranks}


def _stats(d: dict) -> list[str]:
    return [k for k in d if k.endswith((".mean", ".var"))]


def _params_only(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in _stats(d)}


def _close_leaves(got: dict, want: dict, rel: float) -> None:
    """Every leaf of ``got`` within ``rel`` of its ``want`` leaf's scale
    (its largest magnitude)."""
    assert set(got) == set(want)
    for k, g in got.items():
        w = np.asarray(want[k])
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(np.asarray(g) - w).max())
        assert err <= rel * scale, (k, err, scale)


@pytest.mark.parametrize("case", ["a", "b"])
def test_model_axis_step_matches_the_reference_one_device_step(world, case):
    ref = world["ref"][case]
    got = torch.load(os.path.join(world["work"], f"{case}_state.pt"))
    np.testing.assert_allclose(world["ranks"][0][case]["loss"], ref["loss"],
                               rtol=2e-5)
    model, want = got["model"], ref["state"]
    assert set(model) == set(want)
    for k in want:
        if k in _stats(want):
            np.testing.assert_allclose(model[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-3, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(model[k].numpy(), np.asarray(want[k]),
                                       rtol=3e-4, atol=3e-6, err_msg=k)
    # A second witness of the gradients on the binary batch: the port's
    # one-process step.
    _close_leaves(got["mu"], world["one"][case], 3e-4)
    for r in world["ranks"][1:]:
        assert r[case] == world["ranks"][0][case]


@pytest.mark.parametrize("case", ["a", "b"])
def test_model_axis_gradients_match_the_reference_one_device_step(world, case):
    tag = f"{case}_floats"
    ref = world["ref"][tag]
    got = torch.load(os.path.join(world["work"], f"{tag}_state.pt"))
    np.testing.assert_allclose(world["ranks"][0][tag]["loss"], ref["loss"],
                               rtol=2e-5)
    _close_leaves(got["mu"], ref["mu"], 3e-4)
    for k in _stats(ref["state"]):
        np.testing.assert_allclose(got["model"][k].numpy(),
                                   np.asarray(ref["state"][k]), rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    for r in world["ranks"][1:]:
        assert r[tag] == world["ranks"][0][tag]


def test_model_axis_checkpoint_resumes_bitwise_and_restores_in_one_process(world):
    from featurenet_tpu_torch.train.loop import Trainer

    ranks = [r["c"] for r in world["ranks"]]
    assert all(r["bitwise"] for r in ranks)
    assert ranks[0]["mesh"] == {"data": 2, "model": 2, "devices": 4,
                                "processes": 4, "backend": "gloo"}
    assert ranks[0]["local_shapes"]["dense0.weight"] == [32, 2048]
    assert all(r["eval"] == ranks[0]["eval"] for r in ranks)
    ck = os.path.join(world["work"], "ck")
    saved = torch.load(os.path.join(ck, "step_2.pt"), weights_only=True)
    assert tuple(saved["model"]["dense0.weight"].shape) == (64, 2048)
    assert tuple(saved["mu"]["dense0.weight"].shape) == (64, 2048)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = Trainer(dataclasses.replace(_cfg_c(world["work"], "ck"),
                                          mesh_model=1), device="cpu")
        assert one.resume_if_available() == 2
        ev = one.evaluate()
    finally:
        torch.set_num_threads(threads)
    want = ranks[0]["eval"]
    assert ev["samples"] == want["samples"] and ev["confusion"] == want["confusion"]
    np.testing.assert_allclose(ev["loss"], want["loss"], rtol=1e-5)
