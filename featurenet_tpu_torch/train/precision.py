"""Precision policies: fp32 masters with reduced-precision working copies,
for training and serving (port of ``featurenet_tpu/train/precision.py``).

Training. The optimizer and every checkpoint hold **fp32 master
parameters**. Under ``bf16_master`` and ``fp16_scaled`` the train step
casts one working copy of every floating parameter (conv kernels, batch-norm
``scale``/``bias``, dense weights and biases; never the batch-norm running
statistics, which are buffers) and differentiates with respect to it, so
the gradients are stored at the working dtype. They are upcast to fp32 at
the step boundary and the update applies to the masters.

``fp16_scaled`` adds **dynamic loss scaling**: the loss is multiplied by a
running scale before the backward, the upcast gradients are unscaled in
fp32, and a non-finite gradient tree skips the update bitwise and halves
the scale (floored at ``LOSS_SCALE_MIN``); ``LOSS_SCALE_GROWTH_INTERVAL``
finite steps in a row double it (capped at ``LOSS_SCALE_MAX``). The scale
state (``TrainState.loss_scale``/``good_steps``) exists under every
policy, inert (1.0 and 0) outside ``fp16_scaled``, so a checkpoint restores
into a run of any precision. ``fp32`` is the identity: the masters are the
working copy and nothing is cast.

Serving. ``serve_params_cast`` is the same idea for inference
(``Config.serve_precision``): ``bf16`` casts every floating parameter to
bfloat16, ``int8`` round-trips the weights through the per-channel
quantizer (``runtime/quantize.py``), ``fp32`` is the identity.

Parameters here are dicts of tensors keyed by ``named_parameters`` names,
the port's counterpart of the JAX ``params`` tree.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
from torch.profiler import record_function

TRAIN_PRECISIONS = ("fp32", "bf16_master", "fp16_scaled")
SERVE_PRECISIONS = ("fp32", "bf16", "int8")

# Dynamic loss scaling (fp16_scaled), the reference's constants.
LOSS_SCALE_INIT = 2.0 ** 15
LOSS_SCALE_GROWTH_INTERVAL = 200
LOSS_SCALE_MAX = 2.0 ** 24
LOSS_SCALE_MIN = 1.0

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _cast_floating(params: Mapping[str, torch.Tensor],
                   dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Every floating tensor of ``params`` cast to ``dtype`` (a tensor
    already at ``dtype``, or not floating, passes through)."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One training precision: the working copy's dtype (``None``: the
    masters are the working copy) and whether the step scales the loss."""

    name: str
    working_dtype: Optional[str] = None
    loss_scaling: bool = False

    def working_params(self, params: Mapping[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
        """The tensors the forward and backward differentiate: fresh leaves
        holding the masters cast to the working dtype (requiring grad), or
        the masters themselves under ``fp32``."""
        if self.working_dtype is None:
            return dict(params)
        with record_function("casts"):
            work = _cast_floating({k: v.detach() for k, v in params.items()},
                                  _DTYPES[self.working_dtype])
        return {k: v.requires_grad_() for k, v in work.items()}

    def master_grads(self, grads):
        """Gradients at the masters' dtype: the reduced ones upcast to fp32,
        or ``grads`` as they are under ``fp32``."""
        if self.working_dtype is None:
            return list(grads)
        with record_function("casts"):
            return [g.float() for g in grads]


POLICIES = {
    "fp32": PrecisionPolicy("fp32", None),
    "bf16_master": PrecisionPolicy("bf16_master", "bfloat16"),
    "fp16_scaled": PrecisionPolicy("fp16_scaled", "float16", loss_scaling=True),
}


def get_policy(name: str) -> PrecisionPolicy:
    """The policy of a ``Config.train_precision`` value; an unknown name
    raises rather than training at another precision."""
    if name not in POLICIES:
        raise ValueError(f"unknown train precision {name!r}; one of "
                         f"{', '.join(TRAIN_PRECISIONS)}")
    return POLICIES[name]


def initial_loss_scale(precision: str) -> float:
    """The loss scale a fresh state starts from: ``LOSS_SCALE_INIT`` under
    a loss-scaling policy, the inert 1.0 otherwise."""
    return LOSS_SCALE_INIT if get_policy(precision).loss_scaling else 1.0


def serve_params_cast(params: Mapping[str, torch.Tensor],
                      precision: str) -> dict[str, torch.Tensor]:
    """The serving working copy of ``params`` (never mutated): ``fp32`` as
    they are, ``bf16`` every floating tensor cast to bfloat16, ``int8``
    quantized and dequantized per output channel (numerically the weights
    the int8 Predictor serves)."""
    if precision == "fp32":
        return dict(params)
    if precision == "bf16":
        return _cast_floating(params, torch.bfloat16)
    if precision == "int8":
        from featurenet_tpu_torch.runtime.quantize import (
            dequantize_tree,
            quantize_tree,
        )

        return dequantize_tree(*quantize_tree(params))
    raise ValueError(f"unknown serve precision {precision!r}; one of "
                     f"{', '.join(SERVE_PRECISIONS)}")
