"""The Trainer: config → model → train state → synthetic stream → run loop
(port of ``featurenet_tpu/train/loop.py``, one device).

``Trainer(cfg, device="cuda")`` builds the model from ``cfg.seed`` (or
from a port ``state_dict``, e.g. one bridged from a JAX run by
``convert.from_flax``), its optimizer, and the seeded synthetic train and
eval streams. ``run(num_steps=None)`` first resumes from the newest good
checkpoint in ``cfg.checkpoint_dir``, if there is one, then runs to step
``num_steps`` (default ``cfg.total_steps``) one step per dispatch: it logs
every ``log_every`` steps and at the end, evaluates every ``eval_every``
steps and at the end, saves every ``checkpoint_every`` steps and at the
end, waits for the writes, and returns the last record, as the JAX loop
does. ``cfg.init_from`` warm-starts the weights from another run's
checkpoint (identity checked). After a resume the synthetic stream starts
again at its seed, as the JAX loop's does.

Not ported yet: the supervisor and preemption exits, obs events,
HBM-resident data and fused multi-step dispatch.

``timing`` keeps the wall seconds of the run's steps, how many of them the
loop spent waiting for the next batch (``data_wait_s``), so the data wait
is reported, not hidden in the rate, and apart from both the host seconds
spent in checkpoint saves (``save_s``, the snapshot and enqueue). A run
that saved ends with a ``checkpoint`` record: its saves, their mean host
ms, the writer's mean ms per step written, and the bytes of a step.
"""

from __future__ import annotations

import time

import torch

from featurenet_tpu_torch.config import Config, check_identity
from featurenet_tpu_torch.data.dataset import Prefetcher, SyntheticVoxelDataset
from featurenet_tpu_torch.models.featurenet import FeatureNet, init_weights
from featurenet_tpu_torch.runtime import resolve_device
from featurenet_tpu_torch.train.checkpoint import CheckpointManager, load_run_config
from featurenet_tpu_torch.train.state import TrainState, create_state, param_count
from featurenet_tpu_torch.train.steps import aggregate_eval, eval_step, make_train_step
from featurenet_tpu_torch.utils.logging import MetricLogger

EVAL_SEED_OFFSET = 10_000


def eval_dataset(cfg: Config) -> SyntheticVoxelDataset:
    """The held-out synthetic stream a run of ``cfg`` evaluates on."""
    return SyntheticVoxelDataset(cfg.resolution, cfg.global_batch,
                                 cfg.num_features,
                                 seed=cfg.seed + EVAL_SEED_OFFSET)


def evaluate(model, data: SyntheticVoxelDataset, batches: int, device) -> dict:
    """Eval metrics of ``model`` over the first ``batches`` batches of
    ``data``."""
    stream = Prefetcher(data, device, num_workers=1)
    try:
        sums = [eval_step(model, next(stream)) for _ in range(batches)]
    finally:
        stream.close()
    return aggregate_eval(sums)


class Trainer:
    def __init__(self, cfg: Config, device="cuda",
                 state: dict[str, torch.Tensor] | None = None, stream=None):
        self.cfg = cfg.validate_training()
        self.device = resolve_device(device)
        model = FeatureNet(cfg.arch, cfg.resolution)
        if state is None:
            init_weights(model, cfg.seed)
        else:
            model.load_state_dict(state)
        self.state: TrainState = create_state(model.to(self.device), cfg)
        self.params_n = param_count(model)
        if cfg.init_from:
            saved = load_run_config(cfg.init_from)
            if saved is not None:
                check_identity(saved, cfg)
            src = CheckpointManager(cfg.init_from)
            src.restore_init(self.state)
            src.close()
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints,
                                       config=cfg)
                     if cfg.checkpoint_dir else None)
        self.logger = MetricLogger(stream)
        self.train_data = SyntheticVoxelDataset(
            cfg.resolution, cfg.global_batch, cfg.num_features, seed=cfg.seed,
        )
        self.eval_data = eval_dataset(cfg)
        self._train_step = make_train_step(cfg.label_smoothing)
        self._generator = torch.Generator(device=self.device)
        self.timing = {"steps": 0, "wall_s": 0.0, "data_wait_s": 0.0,
                       "saves": 0, "save_s": 0.0}

    def step(self, batch: dict) -> dict:
        """One train step on a wire batch already on the device; dropout
        draws from a generator seeded by (seed, step)."""
        self._generator.manual_seed((self.cfg.seed + 1) * 2 ** 32 + self.state.step)
        return self._train_step(self.state, batch, self._generator)

    def resume_if_available(self) -> int:
        """Restore the newest good checkpoint of ``cfg.checkpoint_dir``, if
        any, deleting newer steps that fail (this run re-saves them);
        returns the step to continue from."""
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.ckpt.restore(self.state, cleanup=True)
        return self.state.step

    def evaluate(self) -> dict:
        """Eval over ``eval_batches`` batches of the held-out stream (the
        same batches at every call)."""
        return evaluate(self.state.model, self.eval_data,
                        self.cfg.eval_batches, self.device)

    def run(self, num_steps: int | None = None) -> dict:
        cfg = self.cfg
        total = num_steps if num_steps is not None else cfg.total_steps
        start = self.resume_if_available()
        self.logger.log(start, {"params": self.params_n, "devices": 1},
                        prefix="setup")
        stream = Prefetcher(self.train_data, self.device,
                            num_workers=cfg.data_workers)
        self.logger.start_window()
        last: dict = {}
        try:
            step = start
            while step < total:
                t0 = time.perf_counter()
                batch = next(stream)
                t1 = time.perf_counter()
                metrics = self.step(batch)
                new_step = step + 1

                def crossed(every: int) -> bool:
                    return (new_step // every) > (step // every)

                self.logger.count_samples(cfg.global_batch)
                if crossed(cfg.log_every) or new_step == total:
                    last = self.logger.log(new_step, metrics)
                self.timing["steps"] += 1
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
                if self.ckpt and (crossed(cfg.checkpoint_every)
                                  or new_step == total):
                    t2 = time.perf_counter()
                    self.ckpt.save(self.state)
                    self.timing["saves"] += 1
                    self.timing["save_s"] += time.perf_counter() - t2
                step = new_step
        finally:
            stream.close()
        if self.ckpt:
            self.ckpt.wait()
            t, w = self.timing, self.ckpt.timing
            if t["saves"]:
                self.logger.log(self.state.step, {
                    "saves": t["saves"],
                    "save_ms_mean": t["save_s"] / t["saves"] * 1e3,
                    "writer_ms_mean": w["write_s"] / w["writes"] * 1e3,
                    "bytes": w["bytes"]}, prefix="checkpoint")
        return last
