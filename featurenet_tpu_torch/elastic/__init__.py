"""Elastic training (port of ``featurenet_tpu/elastic/``; stdlib only).

- ``membership``: the durable membership file and generation counter in
  the run directory: which slots form the current world, and why.
- ``planner``: the re-mesh planner: from the surviving hosts, the largest
  world the global batch divides over (the global batch is preserved
  across re-forms; the per-host share rescales).
- ``coordinator``: the elastic coordinator, an N-child supervisor that
  detects a host's loss (its death or a stale heartbeat), shrinks the
  world to the survivors (each resumes from the newest good checkpoint in
  a fresh process group) and grows it back by re-admitting recovered
  hosts at the next generation boundary (an exit-75 planned cut).

The serving fleet reuses ``membership`` and ``heartbeat_path``
(``fleet/replica.py``); ``cli train --elastic`` runs the coordinator.
"""

from featurenet_tpu_torch.elastic.coordinator import (  # noqa: F401
    ElasticCoordinator,
    ElasticResult,
    heartbeat_path,
)
from featurenet_tpu_torch.elastic.membership import (  # noqa: F401
    MEMBERSHIP_FILENAME,
    Membership,
    membership_path,
    read_membership,
    ready_slots,
    signal_ready,
    write_membership,
)
from featurenet_tpu_torch.elastic.planner import (  # noqa: F401
    InfeasibleWorld,
    feasible_world_sizes,
    per_host_batch,
    plan_world,
)
