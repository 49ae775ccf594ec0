"""Train state (port of ``featurenet_tpu/train/state.py``).

JAX keeps params, batch statistics and optimizer state in one immutable
pytree; in PyTorch's idiom the state is the model (fp32 master parameters
and batch-norm buffers, updated in place), the optimizer with its moments,
and the step count. ``precision`` names the training precision policy
(``train/precision.py``); the masters are fp32 under every policy.
``loss_scale`` (0-d fp32) and ``good_steps`` (0-d int32) are the dynamic
loss-scaling state of ``fp16_scaled``, on the model's device; they exist
under every policy, inert (1.0 and 0) outside it, so a checkpoint of any
precision restores into a run of any other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from featurenet_tpu_torch.parallel.mesh import axis_of
from featurenet_tpu_torch.train.precision import (
    PrecisionPolicy,
    get_policy,
    initial_loss_scale,
)
from featurenet_tpu_torch.train.steps import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optional[Optimizer]
    step: int = 0
    precision: str = "fp32"
    loss_scale: Optional[torch.Tensor] = None
    good_steps: Optional[torch.Tensor] = None

    def __post_init__(self):
        get_policy(self.precision)  # refuse an unknown policy
        device = next(self.model.parameters()).device
        if self.loss_scale is None:
            self.loss_scale = torch.tensor(initial_loss_scale(self.precision),
                                           dtype=torch.float32, device=device)
        if self.good_steps is None:
            self.good_steps = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def policy(self) -> PrecisionPolicy:
        return get_policy(self.precision)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step writes, in place: parameters and
        batch-norm statistics, the optimizer's slots, the loss-scale
        state."""
        return [*self.model.state_dict().values(), *self.optimizer.tensors(),
                self.loss_scale, self.good_steps]

    def apply_gradients(self, grads: Sequence[torch.Tensor],
                        finite: Optional[torch.Tensor] = None) -> None:
        """Apply ``grads`` (fp32, one per parameter, ``model.parameters()``
        order) to the masters, only where the device verdict ``finite``
        holds when one is given (``Optimizer.update``); the batch
        statistics already moved in the train-mode forward. The step
        advances either way."""
        self.optimizer.update(grads, finite)
        self.step += 1


def create_state(model: torch.nn.Module, cfg) -> TrainState:
    """A step-0 state over ``model`` with ``cfg``'s optimizer and
    ``cfg.train_precision``. On a model axis (``FeatureNet.shard``) the
    optimizer's moments take the parameters' shards, as the reference's
    ``state_shardings`` lays them, and its norm counts each shard once."""
    opt = make_optimizer(cfg, model.parameters())
    axis = axis_of(model)
    if axis.size > 1:
        opt.shards = [k == "shard" for k in model.grad_kinds()]
        opt.model_group = axis.group
    return TrainState(model, opt, precision=cfg.train_precision)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
