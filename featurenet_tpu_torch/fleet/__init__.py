"""The serving fleet (port of ``featurenet_tpu/fleet/``): N supervised
``featurenet_tpu_torch.cli serve`` replicas behind one router.

- ``replica``: the replica manager (spawn, heartbeat and exit-code
  supervision, ``/healthz``-gated readiness, loss and respawn with backoff,
  the roster in ``membership.json``) and the autoscaler.
- ``router``: the HTTP front end (least-queue-depth routing over ready
  replicas, spillover on a replica's 503, re-submit once on a dead
  connection, batch-lane shedding, the fleet-wide 503 with
  ``Retry-After``, advisory burn-rate scaling verdicts, the
  ``replica_loss`` fault site).
- ``pool``: the keep-alive connection pool every hop rides.
- ``scraper``: the ``/metrics`` collection loop into the run's store.
- ``loadgen``: the open-loop HTTP load generator and the replica argv.

Each replica owns its CUDA context on the card; the ``cli fleet`` process
(router, manager, scraper) creates none. Launch with ``cli fleet
--replicas N --checkpoint-dir D --run-dir R``; roll weights across it
with ``cli fleet rollout CK --run-dir R``.
"""

from featurenet_tpu_torch.fleet.replica import (  # noqa: F401
    Candidate,
    ReplicaManager,
)
from featurenet_tpu_torch.fleet.router import (  # noqa: F401
    FleetRouter,
    scale_verdict,
)
