"""Model construction and the serving forward (port of
``featurenet_tpu/runtime/registry.py``'s ``build_model`` and ``_serve_fn``).

The JAX registry compiles one program per batch shape; PyTorch runs
eagerly, so here the serving forward is a plain function:
logits → fp32 softmax.
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


@torch.inference_mode()
def serve_forward(model: FeatureNet, voxels: torch.Tensor) -> torch.Tensor:
    """``[B,R,R,R,1]`` voxels → fp32 class probabilities ``[B, classes]``."""
    return torch.softmax(model(voxels), dim=-1)
