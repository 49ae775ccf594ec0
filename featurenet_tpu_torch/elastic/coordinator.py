"""The elastic coordinator's run-directory conventions (port of the part
of ``featurenet_tpu/elastic/coordinator.py`` the serving fleet uses;
stdlib only). The coordinator itself, which re-forms a training world
over N children, is not ported yet."""

from __future__ import annotations

import os


def heartbeat_path(run_dir: str, slot: int) -> str:
    """The heartbeat file of one slot: a convention the supervising process
    and the argv it spawns the child with share."""
    return os.path.join(os.path.abspath(run_dir), f"heartbeat.{int(slot)}")
