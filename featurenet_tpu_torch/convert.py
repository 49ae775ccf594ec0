"""Weights across the two packages, and the port's own weight file.

``from_flax`` turns the variables of a JAX ``FeatureNet`` -- the nested
dict of numpy arrays ``jax.device_get(model.init(...))`` gives -- into a
``state_dict`` for the port's ``FeatureNet``:

- ``params/ConvBNRelu_i/<conv scope>/kernel`` → ``blocks.i.conv.kernel``,
  kept ``[K,K,K,Cin,Cout]``. The conv scope is ``SpaceToDepthConv_0``
  (strided stem), ``PallasConv_0`` (``conv_backend="pallas"``),
  ``Conv_0`` (``xla``, ``fused33``, or a direct strided conv) or
  ``HybridConv_0`` (``hybrid_dw``); all hold the same kernel.
- ``params/ConvBNRelu_i/BatchNorm_0/{scale,bias}`` and
  ``batch_stats/ConvBNRelu_i/BatchNorm_0/{mean,var}`` → ``blocks.i.*``.
- ``params/Dense_j/{kernel,bias}`` → ``dense{j}.{weight,bias}``; the Flax
  kernel is ``[in, out]`` and is transposed for ``F.linear``.

A ``FeatureNetSegmenter`` tree (one that holds ``ConvTranspose_0``) maps
the same way to the port's ``FeatureNetSegmenter``
(``models/segmenter.py``): ``ConvBNRelu_i`` → ``blocks.i`` (the strided
blocks' scope is ``SpaceToDepthConv_0``, the others' ``Conv_0``),
``ConvTranspose_j/{kernel,bias}`` → ``ups.j.{kernel,bias}`` and
``Conv_0/{kernel,bias}`` → ``head.{kernel,bias}``, every kernel in its
Flax layout; ``arch`` is not read.

``opt_from_optax`` maps the state of optax's ``adam``/``adamw`` (or either
after ``clip_by_global_norm``), as ``jax.device_get`` gives it, to the
port optimizer's moments keyed by parameter name and its ``count``; with
both, a JAX run resumes in the port (``export_jax_checkpoint.py``).
``scale_state_from_jax`` carries the loss-scale state (``loss_scale``,
``good_steps``) of a JAX ``TrainState``, so a JAX ``fp16_scaled`` run
resumes with its adapted scale.

The port never imports JAX; only the tests build the Flax side.

Every tree here is whole, in the layout of a one-process run, as the JAX
arrays come in: a run on a model axis loads it whole and then shards it by
the port's rule (``parallel/mesh.py`` ``param_shardings``; the Trainer's
``FeatureNet.shard``), and its checkpoints gather the shards back into
this layout (``train/checkpoint.py``).

``save_npz``/``load_npz`` store a port ``state_dict`` with its ``Config``
(as JSON) in one ``.npz`` file, which ``cli serve --weights`` reads.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from featurenet_tpu_torch.config import Config, config_from_dict, config_to_dict
from featurenet_tpu_torch.models.featurenet import FeatureNetArch

CONV_SCOPES = ("SpaceToDepthConv_0", "PallasConv_0", "Conv_0", "HybridConv_0")

_CONFIG_KEY = "__config__"


def _conv_kernel(scope: dict, name: str) -> np.ndarray:
    found = [s for s in CONV_SCOPES if s in scope]
    if len(found) != 1:
        raise KeyError(
            f"{name}: expected exactly one conv scope of {CONV_SCOPES}, "
            f"found {sorted(scope)}"
        )
    return scope[found[0]]["kernel"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _is_segmenter(params: dict) -> bool:
    return "ConvTranspose_0" in params


def _block_count(params: dict) -> int:
    return sum(1 for k in params if k.startswith("ConvBNRelu_"))


def _from_params(params: dict, arch) -> dict[str, torch.Tensor]:
    """The parameters of a ``params``-shaped tree, in port names."""
    out = {}
    for i in range(_block_count(params)):
        name = f"ConvBNRelu_{i}"
        out[f"blocks.{i}.conv.kernel"] = _t(_conv_kernel(params[name], name))
        bn = params[name]["BatchNorm_0"]
        out[f"blocks.{i}.scale"] = _t(bn["scale"])
        out[f"blocks.{i}.bias"] = _t(bn["bias"])
    if _is_segmenter(params):
        j = 0
        while f"ConvTranspose_{j}" in params:
            up = params[f"ConvTranspose_{j}"]
            out[f"ups.{j}.kernel"] = _t(up["kernel"])
            out[f"ups.{j}.bias"] = _t(up["bias"])
            j += 1
        out["head.kernel"] = _t(params["Conv_0"]["kernel"])
        out["head.bias"] = _t(params["Conv_0"]["bias"])
        return out
    if arch is not None and len(arch.features) != _block_count(params):
        raise KeyError(f"the tree has {_block_count(params)} conv blocks, the "
                       f"arch {len(arch.features)}")
    for j in range(2):
        dense = params[f"Dense_{j}"]
        out[f"dense{j}.weight"] = _t(dense["kernel"]).T.contiguous()
        out[f"dense{j}.bias"] = _t(dense["bias"])
    return out


def from_flax(variables: dict, arch: FeatureNetArch | None = None
              ) -> dict[str, torch.Tensor]:
    """Port ``state_dict`` (fp32 tensors) from the variables of a JAX
    ``FeatureNet`` or ``FeatureNetSegmenter``."""
    params = variables["params"]
    out = _from_params(params, arch)
    for i in range(_block_count(params)):
        bs = variables["batch_stats"][f"ConvBNRelu_{i}"]["BatchNorm_0"]
        out[f"blocks.{i}.mean"] = _t(bs["mean"])
        out[f"blocks.{i}.var"] = _t(bs["var"])
    return out


def _adam_states(tree):
    """The nodes of an optax state tree that carry Adam's ``mu``, ``nu``
    and ``count`` (``ScaleByAdamState``), found by their fields."""
    if all(hasattr(tree, f) for f in ("mu", "nu", "count")):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for node in tree:
            yield from _adam_states(node)


def opt_from_optax(opt_state, arch: FeatureNetArch | None = None) -> dict:
    """``{"mu": {name: tensor}, "nu": {name: tensor}, "count": int}`` for
    the port's ``Optimizer`` from the numpy state of optax's ``adam`` or
    ``adamw`` over a JAX ``FeatureNet``'s or ``FeatureNetSegmenter``'s
    params (the tree ``from_flax`` walks; dense moments transposed as the
    kernels are)."""
    found = list(_adam_states(opt_state))
    if len(found) != 1:
        raise ValueError(
            f"expected one Adam state (mu, nu, count) in the optax state, "
            f"found {len(found)}; only adam and adamw are mapped"
        )
    adam = found[0]
    return {"mu": _from_params(adam.mu, arch), "nu": _from_params(adam.nu, arch),
            "count": int(np.asarray(adam.count))}


def scale_state_from_jax(state) -> dict[str, torch.Tensor]:
    """``{"loss_scale": fp32, "good_steps": int32}`` 0-d tensors from the
    leaves of a JAX ``TrainState`` (or anything with those two fields), as
    ``jax.device_get`` gives them."""
    return {"loss_scale": torch.tensor(np.asarray(state.loss_scale, np.float32)),
            "good_steps": torch.tensor(np.asarray(state.good_steps, np.int32))}


def save_npz(path: str, state: dict[str, torch.Tensor], cfg: Config) -> None:
    """Write a port ``state_dict`` and its config to ``path`` (.npz)."""
    arrays = {k: v.detach().cpu().float().numpy() for k, v in state.items()}
    arrays[_CONFIG_KEY] = np.array(json.dumps(config_to_dict(cfg)))
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_npz(path: str) -> tuple[dict[str, torch.Tensor], Config]:
    """Read what ``save_npz`` wrote: ``(state_dict, config)``."""
    with np.load(path, allow_pickle=False) as z:
        if _CONFIG_KEY not in z.files:
            raise ValueError(f"{path!r}: no {_CONFIG_KEY} entry; not a port weight file")
        cfg = config_from_dict(json.loads(str(z[_CONFIG_KEY])))
        state = {k: torch.from_numpy(z[k].copy()) for k in z.files
                 if k != _CONFIG_KEY}
    return state, cfg
