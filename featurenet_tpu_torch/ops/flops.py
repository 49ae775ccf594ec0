"""Analytic FLOP model of the FeatureNet conv stacks, for MFU (port of
``featurenet_tpu/ops/flops.py``; standard library only).

The count is the model's, not an implementation's: the same work reads
the same FLOPs whichever conv backend runs it (``pallas``, ``hybrid_dw``,
``xla``, ``fused33``), so an MFU of one backend compares with another's.
A profiler's count would not: ``torch.utils.flop_counter`` does not see
the hand-written conv kernels.

Counting convention, the reference's "2·MACs" model:
- conv: 2 · K³ · C_in · C_out · out_voxels per sample (SAME padding: out =
  ceil(in / stride); padded taps are counted);
- dense: 2 · in · out;
- a train step ≈ 3× the forward (the input gradient and the weight
  gradient each the forward's contraction volume). Batch norm, pooling,
  bias, softmax and the optimizer are elementwise work and left out.

The reference's ``mfu`` is not kept here: the port's one MFU formula is
``obs/perf.mfu_value``, against the one peak table there.
"""

from __future__ import annotations

import math


def conv_stack_forward_flops(
    features, kernels, strides, pool_after, resolution: int, c_in: int = 1
) -> int:
    """Forward matmul FLOPs per sample of a ConvBNRelu stack."""
    total = 0
    d = resolution
    for f, k, s, p in zip(features, kernels, strides, pool_after):
        d = math.ceil(d / s)  # SAME
        total += 2 * k**3 * c_in * f * d**3
        if p:
            d //= 2
        c_in = f
    return total


def classifier_forward_flops(arch, resolution: int) -> int:
    """Forward FLOPs per sample of ``FeatureNet(arch)`` at ``resolution``."""
    total = conv_stack_forward_flops(
        arch.features, arch.kernels, arch.strides, arch.pool_after, resolution
    )
    d = resolution
    for s, p in zip(arch.strides, arch.pool_after):
        d = math.ceil(d / s)
        if p:
            d //= 2
    flat = arch.features[-1] if arch.head_gap else arch.features[-1] * d**3
    total += 2 * flat * arch.hidden
    total += 2 * arch.hidden * arch.num_classes
    return total


def train_step_flops_per_sample(arch, resolution: int) -> int:
    """Forward + input gradient + weight gradient ≈ 3× the forward."""
    return 3 * classifier_forward_flops(arch, resolution)
