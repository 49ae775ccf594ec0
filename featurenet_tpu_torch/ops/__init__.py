"""Convolution ops: the hand-written CUDA conv3d kernels (forward, weight
gradient, tap-folded weight gradient) and the s2d stem.

``launch_counts`` reads every kernel wrapper's launch count and
``reset_launch_counts`` sets them all to 0."""

_COUNTERS = {
    "conv3d_fwd": ("conv3d", "conv3d_fwd_launches"),
    "conv3d_dw": ("conv3d", "conv3d_dw_launches"),
    "conv3d_dw_sum": ("conv3d", "conv3d_dw_sum_launches"),
    "conv_dw_folded": ("conv_dw", "conv_dw_folded_launches"),
    "conv_dw_folded_sum": ("conv_dw", "conv_dw_folded_sum_launches"),
}


def _modules():
    from featurenet_tpu_torch.ops import conv3d, conv_dw

    return {"conv3d": conv3d, "conv_dw": conv_dw}


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by kernel (the wrappers' counters)."""
    mods = _modules()
    return {k: getattr(mods[m], attr) for k, (m, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch counter to 0."""
    mods = _modules()
    for m, attr in _COUNTERS.values():
        setattr(mods[m], attr, 0)
