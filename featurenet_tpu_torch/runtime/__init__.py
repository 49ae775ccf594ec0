"""Model construction and the serving forward (port of
``featurenet_tpu/runtime/registry.py``'s ``build_model`` and ``_serve_fn``).

``build_model`` dispatches on ``cfg.task``: the classifier
(``models/featurenet.py``) or the segmenter (``models/segmenter.py``). The
serving forward is a plain function over the model's own parameters or
over a working copy of them (``train/precision.py``): logits → fp32
softmax for a classifier, the per-voxel argmax as int8 labels for a
segmenter, made on the device so only labels cross to the host, never
the logit volume. ``runtime/registry.py`` builds the serving
programs from it, one per batch and precision (on the card a CUDA graph of
this forward, the reference's compiled program); ``runtime/quantize.py``
holds the int8 quantizer and the agreement gate.
"""

from __future__ import annotations

import torch

from featurenet_tpu_torch.config import Config
from featurenet_tpu_torch.models.featurenet import FeatureNet, init_weights
from featurenet_tpu_torch.models.segmenter import (
    FeatureNetSegmenter,
    init_segmenter_weights,
)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA unless the caller asks for
    the CPU; asking for CUDA without a card raises rather than running
    somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev


def build_model(cfg: Config, seed: int | None = None,
                plain: bool = False) -> FeatureNet | FeatureNetSegmenter:
    """The model a config trains and serves, on the CPU, in eval mode: the
    classifier, or for ``task="segment"`` the segmenter; random weights
    from ``seed`` when given (else the module's placeholders, to be
    overwritten by ``load_state_dict``). ``plain=True`` builds the
    classifier with the kernels' plain versions (the segmenter runs no
    kernel of this package)."""
    if cfg.task == "segment":
        model = FeatureNetSegmenter(
            cfg.seg_features, input_context=cfg.seg_input_context,
            decoder_blocks=cfg.seg_decoder_blocks,
            bottleneck_blocks=cfg.seg_bottleneck_blocks)
        if seed is not None:
            init_segmenter_weights(model, seed)
        return model.eval()
    model = FeatureNet(cfg.arch, cfg.resolution, plain=plain)
    if seed is not None:
        init_weights(model, seed)
    return model.eval()


def forward_with(model: FeatureNet, params: dict[str, torch.Tensor] | None,
                 voxels: torch.Tensor, **kw) -> torch.Tensor:
    """``model``'s logits with ``params`` (name → tensor, e.g. a bf16 or
    dequantized working copy) in place of its parameters; its buffers, the
    batch-norm statistics, are its own. ``params=None`` runs the model as
    it is."""
    if params is None:
        return model(voxels, **kw)
    return torch.func.functional_call(model, params, (voxels,), kw)


@torch.inference_mode()
def serve_forward(model, voxels: torch.Tensor,
                  params: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """``[B,R,R,R,1]`` voxels → fp32 class probabilities ``[B, classes]``
    (a classifier) or int8 per-voxel labels ``[B, R, R, R]`` (a
    segmenter), with ``params`` in place of the model's parameters when
    given."""
    logits = forward_with(model, params, voxels)
    if isinstance(model, FeatureNetSegmenter):
        return logits.argmax(dim=-1).to(torch.int8)
    return torch.softmax(logits, dim=-1)
