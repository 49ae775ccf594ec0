#!/usr/bin/env python3
"""Export a JAX checkpoint directory as a checkpoint of the PyTorch port.

    python export_jax_checkpoint.py JAX_CHECKPOINT_DIR PORT_CHECKPOINT_DIR [--step N]

Reads the newest good step (or ``--step``) of a run that
``featurenet_tpu``'s Trainer wrote, through that package's own
``CheckpointManager``, and writes one step of the same number through the
port's ``CheckpointManager``: the weights and batch-norm statistics
(``convert.from_flax``; a classifier or, for a ``task="segment"`` run, the
segmenter), the Adam moments and count
(``convert.opt_from_optax``), the step, the loss-scale state
(``convert.scale_state_from_jax``; a JAX ``fp16_scaled`` run resumes with
its adapted scale), and the run's ``config.json``. The
port then resumes the run (``cli train --checkpoint-dir``) or serves,
evaluates and classifies from it (``cli serve|eval|infer
--checkpoint-dir``). The JAX run's ``conv_backend`` (``"xla"`` for every
JAX preset) travels with the config; ``--conv-backend`` picks another
lowering there.

It needs JAX and the JAX package, so it runs where they are installed,
not on a machine that has only the port. It belongs to neither package.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys


def export(src: str, dst: str, step: int | None = None) -> int:
    """Write ``src``'s step (default: the newest that restores) into the
    port checkpoint directory ``dst``; returns the step."""
    import jax
    import numpy as np
    import torch

    from featurenet_tpu.config import config_to_dict as jax_config_to_dict
    from featurenet_tpu.runtime import build_model as jax_build_model
    from featurenet_tpu.train.checkpoint import CheckpointManager as JaxManager
    from featurenet_tpu.train.checkpoint import load_run_config as jax_load_run_config
    from featurenet_tpu.train.state import create_state as jax_create_state
    from featurenet_tpu.train.steps import make_optimizer as jax_make_optimizer
    from featurenet_tpu_torch import convert
    from featurenet_tpu_torch.config import config_from_dict
    from featurenet_tpu_torch.runtime import build_model
    from featurenet_tpu_torch.train.checkpoint import CheckpointManager
    from featurenet_tpu_torch.train.state import create_state

    jcfg = jax_load_run_config(src)
    if jcfg is None:
        raise SystemExit(f"{src!r} has no config.json; not a JAX run directory")
    r = jcfg.resolution
    # The restore's template, built by one compiled init (its values are
    # overwritten; an eager init compiles every op on its own).
    jstate = jax.jit(functools.partial(
        jax_create_state, jax_build_model(jcfg), jax_make_optimizer(jcfg)))(
        np.zeros((1, r, r, r, 1), np.float32), jax.random.key(0))
    mgr = JaxManager(src)
    jstate = mgr.restore(jstate, step=step)
    mgr.close()

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))  # noqa: E731
    cfg = config_from_dict(json.loads(json.dumps(jax_config_to_dict(jcfg),
                                                 default=str)))
    cfg = dataclasses.replace(cfg, checkpoint_dir=os.path.abspath(dst),
                              init_from=None)
    model = build_model(cfg)
    model.load_state_dict(convert.from_flax(
        {"params": to_np(jstate.params), "batch_stats": to_np(jstate.batch_stats)},
        cfg.arch))
    state = create_state(model, cfg)
    if cfg.optimizer not in ("adam", "adamw"):
        raise SystemExit(f"optimizer {cfg.optimizer!r}: only adam and adamw "
                         "moments are exported")
    opt = convert.opt_from_optax(to_np(jstate.opt_state), cfg.arch)
    names = [n for n, _ in model.named_parameters()]
    for dst_t, key in ((state.optimizer.mu, "mu"), (state.optimizer.nu, "nu")):
        for t, n in zip(dst_t, names):
            t.copy_(opt[key][n])
    state.optimizer.count = torch.tensor(opt["count"], dtype=torch.int32)
    state.step = int(jstate.step)
    for key, t in convert.scale_state_from_jax(jstate).items():
        getattr(state, key).copy_(t)
    out = CheckpointManager(dst, keep=cfg.keep_checkpoints, config=cfg)
    out.save(state)
    out.close()
    return state.step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="JAX checkpoint directory")
    ap.add_argument("dst", help="port checkpoint directory to write")
    ap.add_argument("--step", type=int, default=None,
                    help="step to export (default: the newest that restores)")
    args = ap.parse_args(argv)
    step = export(args.src, args.dst, args.step)
    print(json.dumps({"exported": {"from": os.path.abspath(args.src),
                                   "to": os.path.abspath(args.dst),
                                   "step": step}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
