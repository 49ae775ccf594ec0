"""Post-training int8 weight quantization for serving (port of
``featurenet_tpu/runtime/quantize.py``).

Weight-only, per output channel, symmetric: every parameter of rank >= 2
(conv kernels, dense weights) becomes ``int8`` with one fp32 scale per
output channel, ``w ≈ q.float() * scale``; vectors (biases, batch-norm
``scale``/``bias``) stay fp32 with a placeholder scale of 1.0. The output
channel is the trailing axis of a conv kernel ``[K,K,K,Cin,Cout]``, as in
the JAX layout, but axis 0 of a dense weight, which the port stores as
``nn.Linear``'s ``[out, in]`` (the transpose of the Flax kernel).

With ``x / scale`` and ``torch.round`` (half to even, as ``jnp.round``)
the int8 values and the scales are the JAX package's, bitwise.

The segmenter's conv, transposed-conv and head kernels are all stored
``[K,K,K,Cin,Cout]`` and it has no dense weight, so every one of its
weights is quantized on the trailing axis, as the reference quantizes it.

``agreement`` is the precision-agnostic accuracy gate: the top-1 match
between two serving precisions of the same weights (held by the tests at
``PAPER_TOP1_TARGET``), or for a segmenter the per-voxel match; the
trailing-axis argmax covers both.
"""

from __future__ import annotations

from typing import Mapping

import torch

# The paper's held-out top-1 bar; every reduced serving rung is gated
# against it through ``agreement``.
PAPER_TOP1_TARGET = 0.967


def _is_weight(x: torch.Tensor) -> bool:
    return x.dim() >= 2


def _out_axis(x: torch.Tensor) -> int:
    """The output-channel axis: 0 of an ``nn.Linear`` weight ``[out, in]``,
    the last of a conv kernel ``[..., Cin, Cout]``."""
    return 0 if x.dim() == 2 else x.dim() - 1


def quantize_tree(params: Mapping[str, torch.Tensor]):
    """``params`` → ``(q, scales)``, two dicts with ``params``' keys:
    weights as int8 with a per-output-channel fp32 scale (shaped to
    broadcast against the weight), every other tensor as it is with a
    scalar 1.0 scale."""
    q, scales = {}, {}
    for k, x in params.items():
        if not _is_weight(x):
            q[k] = x
            scales[k] = torch.ones((), dtype=x.dtype, device=x.device)
            continue
        axis = _out_axis(x)
        reduce = tuple(d for d in range(x.dim()) if d != axis)
        amax = x.detach().abs().amax(dim=reduce, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0,
                            torch.ones_like(amax)).float()
        scales[k] = scale
        q[k] = torch.clamp(torch.round(x.detach() / scale), -127, 127).to(torch.int8)
    return q, scales


def dequantize_tree(q: Mapping[str, torch.Tensor],
                    scales: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Inverse of ``quantize_tree``: int8 tensors back to fp32."""
    return {k: v.float() * scales[k] if v.dtype == torch.int8 else v
            for k, v in q.items()}


def tree_bytes(*trees: Mapping[str, torch.Tensor]) -> int:
    """The bytes the tensors of ``trees`` hold."""
    return sum(t.numel() * t.element_size() for tree in trees
               for t in tree.values())


@torch.inference_mode()
def agreement(model, params: Mapping[str, torch.Tensor], voxels: torch.Tensor,
              reference_precision: str = "fp32",
              candidate_precision: str = "int8") -> float:
    """Top-1 (classify) or per-voxel (segment) agreement between two
    serving precisions of the same weights ``params`` (the fp32 masters,
    on the model's device) on ``voxels``; each side's forward runs
    ``serve_params_cast`` of its precision, with the model's own
    batch-norm statistics."""
    from featurenet_tpu_torch.runtime import forward_with
    from featurenet_tpu_torch.train.precision import serve_params_cast

    def top1(precision):
        logits = forward_with(model, serve_params_cast(params, precision), voxels)
        return logits.argmax(dim=-1)

    ref, got = top1(reference_precision), top1(candidate_precision)
    return float((ref == got).float().mean())
