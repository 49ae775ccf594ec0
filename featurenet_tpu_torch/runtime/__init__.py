"""Model construction and the serving forward (port of
``featurenet_tpu/runtime/registry.py``'s ``build_model`` and ``_serve_fn``).

The serving forward is a plain function: logits → fp32 softmax, over the
model's own parameters or over a working copy of them
(``train/precision.py``). ``runtime/registry.py`` builds the serving
programs from it, one per batch and precision (on the card a CUDA graph of
this forward, the reference's compiled program); ``runtime/quantize.py``
holds the int8 quantizer and the agreement gate.
"""

from __future__ import annotations

import torch

from featurenet_tpu_torch.config import Config
from featurenet_tpu_torch.models.featurenet import FeatureNet, init_weights


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
                plain: bool = False) -> FeatureNet:
    """The classifier a config serves, on the CPU, in eval mode; random
    weights from ``seed`` when given (else the module's placeholders,
    to be overwritten by ``load_state_dict``). ``plain=True`` builds it
    with the kernels' plain versions."""
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
def serve_forward(model: FeatureNet, voxels: torch.Tensor,
                  params: dict[str, torch.Tensor] | None = None) -> torch.Tensor:
    """``[B,R,R,R,1]`` voxels → fp32 class probabilities ``[B, classes]``,
    with ``params`` in place of the model's parameters when given."""
    return torch.softmax(forward_with(model, params, voxels), dim=-1)
