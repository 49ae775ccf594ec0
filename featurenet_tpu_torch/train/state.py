"""Train state (port of ``featurenet_tpu/train/state.py``, fp32 policy).

JAX keeps params, batch statistics and optimizer state in one immutable
pytree; in PyTorch's idiom the state is the model (fp32 master
parameters and batch-norm buffers, updated in place), the optimizer with
its moments, and the step count.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from featurenet_tpu_torch.train.steps import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """Apply ``grads`` (one per parameter, ``model.parameters()``
        order) to the masters; the batch statistics already moved in the
        train-mode forward."""
        self.optimizer.update(grads)
        self.step += 1


def create_state(model: torch.nn.Module, cfg) -> TrainState:
    """A step-0 state over ``model`` with ``cfg``'s optimizer."""
    return TrainState(model, make_optimizer(cfg, model.parameters()))


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
