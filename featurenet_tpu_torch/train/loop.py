"""The Trainer: config → model → train state → data → run loop (port of
``featurenet_tpu/train/loop.py``: one device per process, and data
parallelism across the processes of a ``torch.distributed`` world).

``Trainer(cfg, device="cuda")`` builds the model of ``cfg.task``
(``runtime.build_model``: the classifier, or the segmenter) from
``cfg.seed`` (or from a port ``state_dict``, e.g. one bridged from a JAX
run by ``convert.from_flax``), its optimizer, and the train and eval data:

- synthetic parts streamed from the host (the default);
- with ``cfg.data_cache``, the cache's train split streamed by the
  ``Prefetcher``, and its held-out split evaluated as one exact pass;
- with ``cfg.hbm_cache`` as well, the train split uploaded to the device
  once (``materialize_split``); every step draws its rows there, and no
  producer thread runs. A failed upload or draw raises; nothing falls
  back to host streaming.

A segment run reads a segmentation cache (``SegCacheDataset``; a streamed
split rotates voxels and ``seg`` together on the host, a resident one keeps
its int8 ``seg`` on the device beside the packed voxels and rotates both in
the step, or under ``cfg.augment_affine`` warps both by one draw) or the synthetic stream of ``cfg.num_features``-feature parts in
the segment wire format; its eval reports ``mean_iou`` and
``per_class_iou``. k steps per dispatch run as for classify.

The state trains under ``cfg.train_precision`` (``train/precision.py``:
fp32 masters, a bf16 or fp16 working copy, loss scaling under
``fp16_scaled``, whose ``loss_scale`` and ``grads_finite`` are logged with
the loss), and eval runs the forward of ``cfg.serve_precision``.

With ``cfg.device_augment`` the step poses each batch in groups (the cube
rotation, or the affine warp under ``cfg.augment_affine``), and with
``cfg.augment_noise`` flips occupancy. Every draw of a step (dropout, the
resident rows, the pose, the flips) is made on the device from its own
generator, seeded from ``(seed, step, stream)`` before the step
(``steps.StepDraws``), so a resumed run draws what the unbroken run drew,
and k steps of one dispatch draw what k single steps draw.

``run(num_steps=None)`` first resumes from the newest good
checkpoint in ``cfg.checkpoint_dir``, if there is one, then runs to step
``num_steps`` (default ``cfg.total_steps``), ``k = cfg.steps_per_dispatch``
steps per dispatch while a whole group fits and single steps for the
rest, as the reference's loop does. On the card a dispatch of k steps
replays one CUDA graph (``runtime/registry.py`` ``TrainProgram``), one per
(path, k, precision), captured at the first full group; on the CPU the k
steps run eagerly. The metrics are the group's last step's. It logs at the
first group boundary at or past every ``log_every`` steps and at the end,
evaluates and saves likewise at ``eval_every`` and ``checkpoint_every``,
waits for the writes, and returns the last record. ``cfg.init_from``
warm-starts the weights from another run's checkpoint (identity checked).
After a resume a streamed source starts again at its seed, as the JAX
loop's does.

``recalibrate_bn(batches)`` re-estimates the batch-norm statistics with
train-mode forwards over clean training batches (no augmentation, no
update), the reference's answer to the blended statistics that mixed
clean and warped training leaves.

At most ``cfg.max_inflight_steps`` steps are in flight: after each
dispatch the loop records a CUDA event on the step's stream
(``DispatchPacer``) and waits for the event of the dispatch that many
steps back, never for the stream as a whole, so the host keeps fetching
the next batches while the card works. Each such completed wait, each eval
batch read back and each step the checkpoint writer finishes is confirmed
progress, and only then does the run touch ``cfg.heartbeat_file``, the
file a supervisor watches (``train/supervisor.py``); never at loop entry
or after a launch returns.

Supervised runs exit mid-run in two ways, by one protocol. With
``cfg.restart_every_steps`` the run stops after that many steps of this
process; on SIGTERM (the handler only sets a flag, installed from the
main thread and restored on the way out) it stops at the next dispatch
boundary. Either way it saves the exact step if that is not the newest
on disk, waits for the writer, beats, logs a ``setup`` record with
``planned_restart_exit`` or ``preempt_exit`` and raises
``SystemExit(75)``, which the supervisor answers with a free respawn. A
preempted run with no checkpoint directory dies by SIGTERM instead.
``cfg.inject_faults`` installs a fault plan (``faults.py``) whose markers
live in ``cfg.run_dir``, or else in ``cfg.checkpoint_dir``; the loop hosts
the ``sigterm`` and ``host_loss`` sites at each dispatch boundary.

With ``cfg.run_dir`` the Trainer writes the run directory (``obs/``):
``init_run`` with a window aggregator over ``cfg.alert_rules``; a
``heartbeat`` event at every beat (with the age since the last, also the
``heartbeat_age_s`` window); per dispatch a ``data_wait`` span around the
batch fetch (streamed only) and a ``dispatch`` span around the launch
(``take=k``, ``mode="hbm"`` for the resident step); a ``readback`` span
around the pacer's wait, only when it waits; the ``step_ms`` window
(the group's wall over ``take``); ``eval`` and ``checkpoint`` spans;
``loop_start`` (with ``global_batch``) and ``loop_end`` around the loop,
the windows flushed after it; ``preempt`` on a SIGTERM exit and
``run_end`` when the whole budget is done. ``cli report`` folds them.
The perf plane (``obs/perf.py``): one ``program_cost`` event per program
(a captured k-step graph at its capture; an eager step, ``train_step`` or
``hbm_train_step``, at the first paced wait after its first dispatch, with
the process's peak allocated bytes), and each paced group's wall folded
into the ``mfu`` window against the program's analytic FLOPs; with
``cfg.poll_device_memory`` a ``device_memory`` event per card at every
beat.

With ``cfg.profile_dir`` steps ``[max(profile_start, start), +
profile_steps)`` run under ``torch.profiler`` (CPU and, on the card,
CUDA activities), each dispatch in a ``train_dispatch@<step>`` range; the
device is synchronized before the profiler stops, and the trace is
written to ``profile_dir`` as a Chrome trace
(``trace_steps_<a>-<b>_<pid>.json``). The window is anchored at the first
step this process runs (a resumed run traces its own steps), and an
exception or a segment's end closes it with its trace kept.

Data parallelism (``parallel/mesh.py``): in a process group the Trainer
lays its mesh over the world (``train_mesh``: ``cfg.mesh_model`` clamped
to the world) and feeds this rank's row
group of every global batch (``feed_shards``): the streamed datasets take
``num_hosts``/``host_id``, a resident split is the feed group's block
(``materialize_split(multiple_of, num_shards, shard_id)``), and the step
keeps global semantics (``train/steps.py``). Eval is one exact pass
sharded by feed group, its sums all-reduced, so every rank returns the
same result and each held-out sample counts once. Each rank writes its own
event stream (``obs.init_run(process_index=rank)``: ``events.<rank>.jsonl``
beside rank 0's ``events.jsonl``), rank 0 alone ``config.json`` and the
TensorBoard scalars; checkpoints save in lockstep and resume from the step
rank 0 chooses (``train/checkpoint.py``); ``loop_start`` carries the
mesh's summary (both axes, backend included); ``host_loss`` fires on the
last rank only. A k-step CUDA graph under a world of more than one process
is refused (``runtime/registry.py`` ``TrainProgram``).

The model axis (``cfg.mesh_model`` above 1 once clamped): the model,
built whole from the seed (or the ``state`` given), is laid on this
rank's ``ModelAxis`` (``FeatureNet.shard``: its sharded parameters, and
the optimizer's moments with them, become this rank's columns), so every
model rank of a data row feeds the same rows (``feed_shards``) and, under
``cfg.spatial``, computes on its depth slab of them; the exact eval's sums
are all-reduced over the data axis alone, each model rank of a row having
evaluated the same rows. ``hbm_cache`` with ``spatial`` stays refused
(``Config.validate``), as the reference refuses it.

TF32: the Trainer sets cuDNN's and cuBLAS's TF32 off
(``precision.set_tf32``), so the fp32 convolutions and matmuls of every
process that trains, ``cli train`` included, run in fp32 as its config
states.

Not ported: the reference's HBM clamp of k (a graph's private pool reuses
each inner step's activations).

``timing`` keeps the wall seconds of the run's steps, how many of them the
loop spent waiting for the next batch (``data_wait_s``), so the data wait
is reported, not hidden in the rate, and apart from both the host seconds
spent in checkpoint saves (``save_s``, the snapshot and enqueue). A run
that saved ends with a ``checkpoint`` record: its saves, their mean host
ms, the writer's mean ms per step written, and the bytes of a step.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import os
import signal
import time

import torch

from featurenet_tpu_torch import faults, obs
from featurenet_tpu_torch.config import Config, check_identity, config_to_dict
from featurenet_tpu_torch.data.dataset import Prefetcher, SyntheticVoxelDataset
from featurenet_tpu_torch.data.offline import SegCacheDataset, VoxelCacheDataset
from featurenet_tpu_torch.data.synthetic import WIRE_KEYS
from featurenet_tpu_torch.obs import perf as obs_perf
from featurenet_tpu_torch.ops.augment import cube_index_maps, group_count
from featurenet_tpu_torch.ops.flops import train_step_flops_per_sample
from featurenet_tpu_torch.parallel.mesh import (
    all_reduce_flat,
    axis_of,
    feed_shards,
    mesh_summary,
    model_axis,
    rank_world,
    train_mesh,
)
from featurenet_tpu_torch.runtime import build_model, resolve_device
from featurenet_tpu_torch.runtime.registry import TrainProgram
from featurenet_tpu_torch.train.checkpoint import CheckpointManager, load_run_config
from featurenet_tpu_torch.train.heartbeat import touch_heartbeat
from featurenet_tpu_torch.train.precision import set_tf32
from featurenet_tpu_torch.train.state import TrainState, create_state, param_count
from featurenet_tpu_torch.train.supervisor import RESTART_EXIT_CODE
from featurenet_tpu_torch.train.steps import (
    StepDraws,
    aggregate_eval,
    eval_step,
    make_resident_train_step,
    make_train_step,
    model_slab,
    stream_seed,
    unpack_voxels,
)
from featurenet_tpu_torch.utils.logging import MetricLogger

EVAL_SEED_OFFSET = 10_000


def eval_dataset(cfg: Config, num_hosts: int = 1, host_id: int = 0):
    """The held-out data a run of ``cfg`` evaluates on: the cache's test
    split, or the held-out synthetic stream (``host_id``'s rows of it)."""
    if cfg.data_cache:
        cache = SegCacheDataset if cfg.task == "segment" else VoxelCacheDataset
        return cache(cfg.data_cache, cfg.global_batch, "test",
                     cfg.test_fraction, seed=cfg.seed + EVAL_SEED_OFFSET,
                     num_hosts=num_hosts, host_id=host_id)
    return SyntheticVoxelDataset(cfg.resolution, cfg.global_batch,
                                 cfg.num_features,
                                 seed=cfg.seed + EVAL_SEED_OFFSET, task=cfg.task,
                                 num_hosts=num_hosts, host_id=host_id)


def evaluate(model, data, batches: int, device,
             serve_precision: str = "fp32", on_batch=None,
             shards: tuple[int, int] = (1, 0)) -> dict:
    """Eval metrics of ``model`` at ``serve_precision``: over one exact
    pass of a cache split (``batches`` is not read), or over the first
    ``batches`` batches of a synthetic stream. ``batches`` and ``samples``
    (parts, not voxels) in the result count what was evaluated.
    ``on_batch`` is called with each batch's sums as they are made.

    ``shards = (num_shards, shard_id)`` of a data-parallel world: this
    rank walks its shard of the pass (``epoch_batches``), and in a process
    group of more than one the sums and the sample count are all-reduced,
    so every rank returns the global result (``batches`` counts this
    rank's); on a model axis over the data axis alone, the model ranks of
    a data row having evaluated the same rows."""
    rows = []

    def step(batch):
        sums = eval_step(model, batch, serve_precision)
        rows.append(batch["mask"].sum())
        if on_batch is not None:
            on_batch(sums)
        return sums

    if isinstance(data, (VoxelCacheDataset, SegCacheDataset)):
        sums = [step({k: torch.from_numpy(v).to(device)
                      for k, v in batch.items()})
                for batch in data.epoch_batches(data.local_batch, *shards)]
    else:
        stream = Prefetcher(data, device, num_workers=1)
        try:
            sums = [step(next(stream)) for _ in range(batches)]
        finally:
            stream.close()
    n_batches = len(sums)
    axis = axis_of(model)
    if axis.data_size > 1:
        sums, rows = _global_sums(sums, rows, axis.data_group)
    out = aggregate_eval(sums)
    out["batches"] = n_batches
    out["samples"] = int(sum(float(r) for r in rows))
    return out


def _global_sums(sums: list[dict], rows: list,
                 group=None) -> tuple[list[dict], list]:
    """The world's (or ``group``'s) totals of per-batch eval sums and mask
    rows, in float64 from one all-reduce."""
    keys = sorted(sums[0])
    *totals, n = all_reduce_flat(
        [torch.stack([s[k].double() for s in sums]).sum(0) for k in keys]
        + [torch.stack([r.double() for r in rows]).sum()], group=group)
    return [dict(zip(keys, totals))], [n]


class DispatchPacer:
    """The bound on dispatches in flight, and the proof of progress.
    ``mark(depth, step)`` after each dispatch records where the device's
    stream stands (a CUDA event; on the CPU the dispatch has already run);
    once more than ``depth`` marks are pending it waits for the oldest
    alone (``Event.synchronize``: a readback would wait for everything
    enqueued since, the dispatch just made included), in a ``readback``
    span, and returns True, the device having finished that dispatch."""

    def __init__(self, device: torch.device):
        self._cuda = device.type == "cuda"
        self._device = device
        self._pending: collections.deque = collections.deque()

    def mark(self, depth: int, step: int = 0) -> bool:
        event = None
        if self._cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
        self._pending.append(event)
        if len(self._pending) <= depth:
            return False
        oldest = self._pending.popleft()
        with obs.span("readback", step=step):
            if oldest is not None:
                oldest.synchronize()
        return True


class Trainer:
    def __init__(self, cfg: Config, device="cuda",
                 state: dict[str, torch.Tensor] | None = None, stream=None):
        self.cfg = cfg.validate_training()
        set_tf32(cfg.train_precision)
        self.device = resolve_device(device)
        self.rank, self.world = rank_world()
        if cfg.run_dir:
            # First, so every later event of this construction lands in
            # the run; the windows judge the run's own alert rules.
            from featurenet_tpu_torch.obs import alerts, windows

            obs.init_run(cfg.run_dir, config=config_to_dict(cfg),
                         process_index=self.rank)
            windows.install(windows.WindowAggregator(
                rules=alerts.parse_rules(cfg.alert_rules)))
        if cfg.inject_faults:
            # Markers in the run (or checkpoint) directory: a fault fires
            # once per run, not once per respawned process.
            faults.install(cfg.inject_faults,
                           state_dir=cfg.run_dir or cfg.checkpoint_dir)
        # The mesh over the world and this rank's row group of each global
        # batch; one process is a 1 x 1 mesh feeding every row.
        self.mesh = train_mesh(cfg, str(self.device))
        data_axis = self.mesh.shape["data"]
        if cfg.global_batch % data_axis:
            raise ValueError(f"global_batch {cfg.global_batch} must be a "
                             f"multiple of the data mesh axis size {data_axis}")
        self._feed = feed_shards(self.mesh)
        n_hosts, host_id = self._feed
        model = build_model(cfg, seed=cfg.seed if state is None else None)
        if state is not None:
            model.load_state_dict(state)
        self.params_n = param_count(model)
        if self.mesh.shape["model"] > 1:
            # This rank's columns of the whole model, and its groups.
            model.shard(model_axis(self.mesh, cfg.spatial))
        self.state: TrainState = create_state(model.to(self.device), cfg)
        if cfg.init_from:
            saved = load_run_config(cfg.init_from)
            if saved is not None:
                check_identity(saved, cfg)
            src = CheckpointManager(cfg.init_from)
            src.restore_init(self.state)
            src.close()
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints,
                                       config=cfg,
                                       on_written=lambda step: self._heartbeat())
                     if cfg.checkpoint_dir else None)
        # The TensorBoard scalars from rank 0 only: the ranks log the same.
        self.logger = MetricLogger(stream,
                                   tb_dir=cfg.tb_dir if self.rank == 0 else None)
        self.eval_data = eval_dataset(cfg, n_hosts, host_id)
        shard = dict(num_hosts=n_hosts, host_id=host_id)
        if cfg.data_cache and cfg.task == "segment":
            self.train_data = SegCacheDataset(
                cfg.data_cache, cfg.global_batch, "train", cfg.test_fraction,
                seed=cfg.seed, augment=cfg.augment and not cfg.device_augment,
                **shard)
        elif cfg.data_cache:
            self.train_data = VoxelCacheDataset(
                cfg.data_cache, cfg.global_batch, "train", cfg.test_fraction,
                seed=cfg.seed, augment=cfg.augment and not cfg.device_augment,
                **shard)
            # A label the head cannot express would train silently wrong.
            top = int(max(self.train_data.labels.max(), self.eval_data.labels.max()))
            if top >= cfg.arch.num_classes:
                raise ValueError(
                    f"cache {cfg.data_cache!r} contains label id {top} but "
                    f"the model head has num_classes={cfg.arch.num_classes}"
                )
        else:
            self.train_data = SyntheticVoxelDataset(
                cfg.resolution, cfg.global_batch, cfg.num_features, seed=cfg.seed,
                task=cfg.task, **shard,
            )
        if self.train_data.resolution != cfg.resolution:
            raise ValueError(
                f"cache {cfg.data_cache!r} holds {self.train_data.resolution}³ "
                f"parts; the config trains at {cfg.resolution}³")
        self._groups = cfg.augment_groups if cfg.device_augment else 0
        if self._groups and n_hosts > 1:
            # This rank's share of the global batch's groups (StepDraws
            # refuses a count that does not divide).
            self._groups = group_count(cfg.global_batch, self._groups) // n_hosts
        # The wire batch's keys a step reads: voxels and the target.
        self._keys = WIRE_KEYS[cfg.task][:2]
        step_opts = (cfg.label_smoothing, self._groups, cfg.augment_affine,
                     cfg.augment_noise, cfg.task, cfg.seg_loss)
        self._train_step = make_train_step(*step_opts)
        self._resident_step = make_resident_train_step(*step_opts)
        self.resident: dict = {}
        rows = 0
        if cfg.hbm_cache:
            # The targets: int32 labels, or the int8 per-voxel seg.
            # This feed group's block of the split (all of it on one rank).
            voxels, labels, _ = self.train_data.materialize_split(
                multiple_of=data_axis, num_shards=n_hosts, shard_id=host_id)
            rows = len(labels)
            self._data = torch.from_numpy(voxels).to(self.device)
            self._labels = torch.from_numpy(labels).to(self.device)
            self.resident = {"hbm_resident_rows": rows,
                             "hbm_resident_mb": round(voxels.nbytes / 1e6, 1)}
            if cfg.task == "segment":
                self.resident["hbm_resident_seg_mb"] = round(labels.nbytes / 1e6, 1)
        self._k = cfg.steps_per_dispatch
        self._draws = StepDraws(cfg, self._k, self.device, rows,
                                num_shards=n_hosts, shard=host_id)
        if "codes" in self._draws.streams:
            cube_index_maps(cfg.resolution, self.device)  # made before any step
        # k-step programs by (path, k, precision); on the card only.
        self.programs: dict[tuple, TrainProgram] = {}
        self._static: dict[tuple, list] = {}
        # Performance attribution (obs/perf.py): the card's peak row (the
        # unknown tier on the CPU: no MFU sample) and the counters of the
        # last dispatched program, folded against the paced group wall in
        # run(). An eager program's cost (by name and take) is emitted as
        # its program_cost event at the first paced wait after its first
        # dispatch, where the process's peak memory is read with no extra
        # synchronization.
        self._peaks = obs_perf.local_device_peaks(self.device)
        self._last_cost: dict | None = None
        self._eager_costs: dict[tuple, dict] = {}
        self._unreported: list[tuple] = []
        self.timing = {"steps": 0, "wall_s": 0.0, "data_wait_s": 0.0,
                       "saves": 0, "save_s": 0.0}

    def _one(self, slot: int, batch: dict | None) -> dict:
        """One train step with draw slot ``slot``: on a wire batch on the
        device, or on rows drawn from the resident split."""
        cfg = self.cfg
        if batch is not None:
            args = self._draws.step_args(slot, batch["voxels"].shape[0],
                                         cfg.resolution)
            return self._train_step(self.state, batch, **args)
        if not self.resident:
            raise ValueError("no batch given and no resident split (hbm_cache)")
        idx = self._draws.draw_rows(slot)
        args = self._draws.step_args(slot, self._draws.batch, cfg.resolution)
        return self._resident_step(self.state, self._data, self._labels, idx,
                                   **args)

    def step(self, batch: dict | None = None) -> dict:
        """One eager train step: on a wire batch already on the device, or,
        with no batch, on rows drawn from the resident split. Every draw
        comes from a generator seeded by (seed, step, stream)."""
        self._draws.seed(self.state.step, 1)
        return self._one(0, batch)

    def _flops(self, take: int) -> dict:
        """The analytic cost of ``take`` train steps of a global batch
        (``ops/flops.py``; a segmenter has no count)."""
        if self.cfg.task != "classify":
            return {}
        return {"flops": float(train_step_flops_per_sample(
            self.cfg.arch, self.cfg.resolution)) * self.cfg.global_batch * take}

    def _eager_cost(self, batches: list | None, take: int) -> dict:
        """The cost dict of an eager dispatch, made at its first use and
        queued for its program_cost event; named as the reference names
        its programs."""
        if take == 1:
            name = "train_step" if batches else "hbm_train_step"
        else:
            name = "multi_train_step" if batches else "hbm_train_step"
        key = (name, take)
        if key not in self._eager_costs:
            self._eager_costs[key] = self._flops(take)
            self._unreported.append(key)
        return self._eager_costs[key]

    def _report_costs(self) -> None:
        """Emit the queued eager programs' program_cost events, with the
        process's peak allocated bytes; called after a paced wait, when
        the device has finished the dispatches in question."""
        peak = obs_perf.peak_allocated(self.device)
        for name, take in self._unreported:
            cost = self._eager_costs[(name, take)]
            if peak is not None:
                cost["peak_bytes"] = peak
            obs_perf.emit_program_cost(name, cost, self._peaks,
                                       self.state.precision, take=take)
        self._unreported = []

    def dispatch(self, batches: list | None, take: int) -> dict:
        """``take`` train steps from ``state.step``, on ``take`` wire
        batches on the device or, with ``batches=None``, on the resident
        split; returns the last step's metrics. One step runs eagerly; k
        (``cfg.steps_per_dispatch``) replay the CUDA graph of their (path,
        k, precision) on the card, captured at its first use, and run
        eagerly on the CPU. The dispatched program's cost becomes
        ``_last_cost``."""
        if take != 1 and take != self._k:
            raise ValueError(f"a dispatch takes 1 or {self._k} steps, not {take}")
        if take == 1 or self.device.type != "cuda":
            self._last_cost = self._eager_cost(batches, take)
            if take == 1:
                return self.step(batches[0] if batches else None)
            self._draws.seed(self.state.step, take)
            for j in range(take):
                metrics = self._one(j, batches[j] if batches else None)
            return metrics
        key = ("streamed" if batches else "resident", take, self.state.precision)
        if key not in self.programs:
            self._capture(key, batches)
        for slot, batch in zip(self._static[key], batches or ()):
            for k, v in slot.items():
                v.copy_(batch[k])
        self._draws.seed(self.state.step, take)
        metrics = self.programs[key]()
        self.state.step += take
        self._last_cost = self.programs[key].cost
        return metrics

    def _capture(self, key: tuple, batches: list | None) -> None:
        static = [{k: b[k].clone() for k in self._keys}
                  for b in batches or ()]

        def body() -> dict:
            for j in range(key[1]):
                metrics = self._one(j, static[j] if static else None)
            return metrics

        self._static[key] = static
        self._draws.seed(self.state.step, key[1])
        self.programs[key] = TrainProgram(
            "multi_train_step" if static else "hbm_train_step", body,
            self.state, self._draws.generators(), self.device,
            precision=key[2], flops=self._flops(key[1]).get("flops"),
            mesh=self.mesh)

    @torch.no_grad()
    def recalibrate_bn(self, batches: int = 64) -> None:
        """Re-estimate the batch-norm running statistics over ``batches``
        clean training batches: train-mode forwards of the masters, no
        augmentation (a host-augmented cache is read through a clean
        shallow copy) and no update; only the statistics move. Dropout
        draws a fresh mask per batch (it sits after the last batch norm)."""
        if batches < 1:
            raise ValueError(f"batches must be >= 1, got {batches}")
        data = self.train_data
        if getattr(data, "augment", False):
            data = copy.copy(data)
            data.augment = False
        it = data.worker_iter(0)
        gen = torch.Generator(device=self.device)
        for i in range(batches):
            batch = next(it)
            gen.manual_seed(stream_seed(self.cfg.seed, i, "dropout"))
            voxels = unpack_voxels(torch.from_numpy(batch["voxels"]).to(self.device))
            self.state.model(model_slab(self.state.model, voxels), train=True,
                             generator=gen)

    def resume_if_available(self) -> int:
        """Restore the newest good checkpoint of ``cfg.checkpoint_dir``, if
        any, deleting newer steps that fail (this run re-saves them);
        returns the step to continue from."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state, cleanup=True)
        return self.state.step

    def _heartbeat(self) -> None:
        """Record confirmed progress for a supervisor (see the module
        docstring for where it is called), and in a run a ``heartbeat``
        event with the age since the last beat."""
        now = time.perf_counter()
        last = getattr(self, "_last_beat", None)
        obs.emit("heartbeat",
                 age_s=round(now - last, 3) if last is not None else None)
        if last is not None:
            obs.observe("heartbeat_age_s", round(now - last, 3))
        self._last_beat = now
        if self.cfg.poll_device_memory:
            # The device-memory watermark, on the heartbeat cadence: every
            # beat sits off the dispatch path (a paced wait, an eval
            # batch, a written checkpoint). No events on the CPU.
            obs_perf.sample_device_memory()
        if self.cfg.heartbeat_file:
            touch_heartbeat(self.cfg.heartbeat_file)

    def evaluate(self) -> dict:
        """Eval over the held-out data (the same batches at every call), at
        ``cfg.serve_precision``. A supervised run reads each batch back and
        beats: a whole held-out pass can outlast the stall timeout."""

        def beat(sums):
            float(sums["count"])  # the readback is the proof
            self._heartbeat()

        with obs.span("eval"):
            return evaluate(self.state.model, self.eval_data,
                            self.cfg.eval_batches, self.device,
                            self.cfg.serve_precision,
                            on_batch=beat if self.cfg.heartbeat_file else None,
                            shards=self._feed)

    def run(self, num_steps: int | None = None) -> dict:
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.total_steps
        start = self.resume_if_available()
        # A segment of a supervised run ends restart_every_steps in.
        stop = total
        if cfg.restart_every_steps and self.ckpt is not None:
            stop = min(total, start + cfg.restart_every_steps)
        self.logger.log(start, {"params": self.params_n,
                                "devices": int(self.mesh.devices.size),
                                **self.resident}, prefix="setup")
        stream = None if self.resident else Prefetcher(
            self.train_data, self.device, num_workers=cfg.data_workers)
        self.logger.start_window()
        # SIGTERM (a scheduler's preemption notice) only sets a flag, read
        # at each dispatch boundary; signal.signal refuses off the main
        # thread, where the default disposition stays.
        self._preempted = False
        prev_sigterm = None
        try:
            prev_sigterm = signal.signal(
                signal.SIGTERM,
                lambda signum, frame: setattr(self, "_preempted", True))
        except ValueError:
            pass
        preempted = False
        pacer = DispatchPacer(self.device)
        last: dict = {}
        # The report attributes span time to the step-time breakdown only
        # between loop_start and loop_end.
        obs.emit("loop_start", step=start, stop=stop, total=total,
                 mesh=mesh_summary(self.mesh), global_batch=cfg.global_batch)
        loop_t0 = time.perf_counter()
        # The trace window, anchored at the first step this process runs.
        trace_start = max(cfg.profile_start, start) if cfg.profile_dir else -1
        prof = None
        trace_done = False
        step = start
        try:
            while step < stop:
                if (trace_start >= 0 and step >= trace_start and prof is None
                        and not trace_done):
                    prof = self._start_trace()
                    trace_from = step
                take = self._k if self._k > 1 and step + self._k <= stop else 1
                t0 = time.perf_counter()
                if stream:
                    with obs.span("data_wait", take=take):
                        batches = [next(stream) for _ in range(take)]
                else:
                    batches = None
                t1 = time.perf_counter()
                ranged = (torch.profiler.record_function(f"train_dispatch@{step}")
                          if prof is not None else contextlib.nullcontext())
                with ranged, obs.span("dispatch", take=take,
                                      **({} if stream else {"mode": "hbm"})):
                    metrics = self.dispatch(batches, take)
                new_step = step + take
                paced = pacer.mark(max(cfg.max_inflight_steps // take, 1),
                                   new_step)
                if paced:
                    if self._unreported:
                        self._report_costs()
                    self._heartbeat()
                # The dispatch and paced wait of the group, per step (eval
                # and checkpoint work are spans of their own).
                group_wall = time.perf_counter() - t0
                obs.observe("step_ms", round(group_wall / take * 1e3, 3))
                if paced:
                    # Only a wall bounded by a real wait folds into the
                    # MFU: while the pipeline fills, the wall is enqueue
                    # time and would read an MFU far above 1.
                    obs_perf.observe_dispatch(self._last_cost, group_wall,
                                              peaks=self._peaks)
                if prof is not None and (
                        new_step >= trace_start + cfg.profile_steps
                        or new_step == total):
                    self._stop_trace(prof, trace_from, new_step)
                    prof = None
                    trace_done = True

                def crossed(every: int) -> bool:
                    return (new_step // every) > (step // every)

                self.logger.count_samples(cfg.global_batch * take)
                if crossed(cfg.log_every) or new_step == total:
                    last = self.logger.log(new_step, metrics)
                self.timing["steps"] += take
                self.timing["data_wait_s"] += t1 - t0
                self.timing["wall_s"] += time.perf_counter() - t0
                if crossed(cfg.eval_every) or new_step == total:
                    ev = self.evaluate()
                    self.logger.log(
                        new_step,
                        {k: v for k, v in ev.items() if k != "confusion"},
                        prefix="eval",
                    )
                    last = {**last, **{f"eval_{k}": v for k, v in ev.items()}}
                    # Don't charge eval wall time to the next train window.
                    self.logger.start_window()
                    self._heartbeat()
                if self.ckpt and (crossed(cfg.checkpoint_every)
                                  or new_step == total):
                    with obs.span("checkpoint", step=new_step):
                        self._save()
                step = new_step
                if faults.maybe_fail("sigterm", step=step):
                    # A real signal through the real handler, at the first
                    # boundary at or past N.
                    os.kill(os.getpid(), signal.SIGTERM)
                if (faults.active() and self.rank == self.world - 1
                        and faults.maybe_fail("host_loss", step=step)):
                    # The last host vanishes: no drain, no exit.
                    os.kill(os.getpid(), signal.SIGKILL)
                if self._preempted and step < total:
                    preempted = True
                    obs.emit("preempt", step=int(step))
                    break
        finally:
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            obs.emit("loop_end", step=int(step),
                     wall_s=time.perf_counter() - loop_t0)
            # A run shorter than the emission period still lands its
            # window summaries (and their alert verdicts).
            obs.flush_windows()
            if stream:
                stream.close()
            if prof is not None:
                # An exception or a segment's end inside the window: the
                # trace of those steps is kept.
                self._stop_trace(prof, trace_from, step)
            self.logger.flush()
        if preempted and self.ckpt is None:
            # Nothing persisted: exit 75 would ask for a free respawn that
            # starts again from step 0. Die by the signal instead, which a
            # supervisor counts as a crash.
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
        exiting = preempted or stop < total
        if self.ckpt:
            self.ckpt.wait()
            if exiting and self.ckpt.latest_step() != self.state.step:
                self._save()  # the exact step, whatever the cadence
                self.ckpt.wait()
            t, w = self.timing, self.ckpt.timing
            if t["saves"]:
                self.logger.log(self.state.step, {
                    "saves": t["saves"],
                    "save_ms_mean": t["save_s"] / t["saves"] * 1e3,
                    "writer_ms_mean": w["write_s"] / w["writes"] * 1e3,
                    "bytes": w["bytes"]}, prefix="checkpoint")
        if exiting:
            # A completed save is confirmed progress: a short segment must
            # not exit 75 without ever beating (a startup failure to the
            # supervisor).
            self._heartbeat()
            self.logger.log(self.state.step, {
                "preempt_exit" if preempted else "planned_restart_exit": 1.0},
                prefix="setup")
            raise SystemExit(RESTART_EXIT_CODE)
        # The whole budget is done: a live tail stops here. A segment's
        # exit above does not end the run.
        obs.emit("run_end", step=int(step), total=total)
        return last

    def _start_trace(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(self, prof, first: int, end: int) -> str:
        """Stop the trace window after the device has finished its steps,
        and write it to ``cfg.profile_dir``; returns the file's path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            f"trace_steps_{first}-{end}_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        return path

    def _save(self) -> None:
        """Snapshot the state and hand it to the checkpoint writer, timed on
        the step's thread."""
        t0 = time.perf_counter()
        self.ckpt.save(self.state)
        self.timing["saves"] += 1
        self.timing["save_s"] += time.perf_counter() - t0
