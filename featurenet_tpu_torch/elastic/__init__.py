"""Elastic membership (port of the part of ``featurenet_tpu/elastic/``
that the serving fleet uses; stdlib only): the durable membership file
(``membership``) and the per-slot heartbeat convention (``coordinator``).
"""

from featurenet_tpu_torch.elastic.coordinator import heartbeat_path  # noqa: F401
from featurenet_tpu_torch.elastic.membership import (  # noqa: F401
    MEMBERSHIP_FILENAME,
    Membership,
    membership_path,
    read_membership,
    ready_slots,
    signal_ready,
    write_membership,
)
