"""The Trainer: config → model → train state → synthetic stream → run loop
(port of ``featurenet_tpu/train/loop.py``, one device).

``Trainer(cfg, device="cuda")`` builds the model from ``cfg.seed`` (or
from a port ``state_dict``, e.g. one bridged from a JAX run by
``convert.from_flax``), its optimizer, and the seeded synthetic train and
eval streams. ``run()`` takes one step per dispatch, logs every
``log_every`` steps and at the end, evaluates every ``eval_every`` steps
and at the end, and returns the last record, as the JAX loop does.

Not ported yet: checkpoints, the supervisor, obs events, HBM-resident data
and fused multi-step dispatch.

``timing`` keeps the wall seconds of the run's steps and how many of them
the loop spent waiting for the next batch (``data_wait_s``), so the data
wait is reported, not hidden in the rate.
"""

from __future__ import annotations

import time

import torch

from featurenet_tpu_torch.config import Config
from featurenet_tpu_torch.data.dataset import Prefetcher, SyntheticVoxelDataset
from featurenet_tpu_torch.models.featurenet import FeatureNet, init_weights
from featurenet_tpu_torch.runtime import resolve_device
from featurenet_tpu_torch.train.state import TrainState, create_state, param_count
from featurenet_tpu_torch.train.steps import aggregate_eval, eval_step, make_train_step
from featurenet_tpu_torch.utils.logging import MetricLogger

EVAL_SEED_OFFSET = 10_000


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
        self.logger = MetricLogger(stream)
        self.train_data = SyntheticVoxelDataset(
            cfg.resolution, cfg.global_batch, cfg.num_features, seed=cfg.seed,
        )
        self.eval_data = SyntheticVoxelDataset(
            cfg.resolution, cfg.global_batch, cfg.num_features,
            seed=cfg.seed + EVAL_SEED_OFFSET,
        )
        self._train_step = make_train_step(cfg.label_smoothing)
        self._generator = torch.Generator(device=self.device)
        self.timing = {"steps": 0, "wall_s": 0.0, "data_wait_s": 0.0}

    def step(self, batch: dict) -> dict:
        """One train step on a wire batch already on the device; dropout
        draws from a generator seeded by (seed, step)."""
        self._generator.manual_seed((self.cfg.seed + 1) * 2 ** 32 + self.state.step)
        return self._train_step(self.state, batch, self._generator)

    def evaluate(self) -> dict:
        """Eval over ``eval_batches`` batches of the held-out stream (the
        same batches at every call)."""
        stream = Prefetcher(self.eval_data, self.device, num_workers=1)
        try:
            sums = [eval_step(self.state.model, next(stream))
                    for _ in range(self.cfg.eval_batches)]
        finally:
            stream.close()
        return aggregate_eval(sums)

    def run(self) -> dict:
        cfg = self.cfg
        total = cfg.total_steps
        start = self.state.step
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
                step = new_step
        finally:
            stream.close()
        return last
