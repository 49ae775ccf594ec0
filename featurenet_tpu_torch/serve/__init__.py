"""The serving front end: continuous batcher, service, HTTP (with the
stream endpoint and ``GET /metrics``), the Prometheus exporter and the
open-loop load generator."""
