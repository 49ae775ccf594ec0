"""The re-mesh planner: which world the surviving hosts form (port of
``featurenet_tpu/elastic/planner.py``; stdlib only).

The one invariant a re-form keeps is the **global batch**: the training
trajectory is defined by ``Config.global_batch``, so a shrink from N hosts
to N-1 rescales the per-host share, never the global number. The Trainer
refuses a global batch the data axis does not divide, so an infeasible
world would die at startup; the planner refuses it here, before any
process is spawned. FeatureNet training is pure data parallelism, so any
world whose device count divides the global batch is admissible down to
``min_world_size``. In the port one process owns one device: a host's
``local_devices`` is 1 unless the caller says otherwise.
"""

from __future__ import annotations

from typing import Iterable


class InfeasibleWorld(RuntimeError):
    """No admissible world can be formed from the surviving hosts."""


def feasible_world_sizes(global_batch: int, local_devices: int,
                         max_hosts: int) -> list[int]:
    """Every world size ``1..max_hosts`` whose data axis
    (``n * local_devices``) divides ``global_batch``, ascending."""
    if global_batch < 1 or local_devices < 1:
        raise ValueError(
            f"global_batch ({global_batch}) and local_devices "
            f"({local_devices}) must be >= 1"
        )
    return [
        n for n in range(1, max_hosts + 1)
        if global_batch % (n * local_devices) == 0
    ]


def per_host_batch(global_batch: int, world_size: int) -> int:
    """The per-host share of a preserved global batch at ``world_size``."""
    if world_size < 1 or global_batch % world_size:
        raise ValueError(
            f"global_batch {global_batch} does not split over "
            f"{world_size} host(s)"
        )
    return global_batch // world_size


def plan_world(available: Iterable[int], *, min_world_size: int,
               global_batch: int, local_devices: int = 1) -> tuple[int, ...]:
    """The member slots of the next generation: the largest feasible world
    over the available hosts, keeping the LOWEST slot ids (slot order is
    rank order, and rank 0 owns the primary event stream and ``run.json``).

    Raises ``InfeasibleWorld`` when no world of at least ``min_world_size``
    hosts divides the global batch: the caller's give-up verdict, not a
    crash inside a spawned child.
    """
    slots = sorted(set(available))
    if min_world_size < 1:
        raise ValueError(f"min_world_size must be >= 1, got {min_world_size}")
    for n in range(len(slots), 0, -1):
        if n < min_world_size:
            break
        if global_batch % (n * local_devices) == 0:
            return tuple(slots[:n])
    raise InfeasibleWorld(
        f"no feasible world from {len(slots)} available host(s): need >= "
        f"{min_world_size} host(s) whose {local_devices}-device data axis "
        f"divides global_batch {global_batch}"
    )
