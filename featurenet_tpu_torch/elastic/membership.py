"""The membership file: which slots form the world, and since when (port
of ``featurenet_tpu/elastic/membership.py``; stdlib only).

One JSON document (``membership.json``) in the run directory, rewritten
atomically at every change of the world. Children learn their world shape
on their argv; the file is what an external agent, or an operator mid
incident, reads to answer "which generation is this run on, at what size,
and why". The serving fleet's roster reuses the same document: members
are the ready replicas, the reason ``start``, ``replica_loss``,
``replica_rejoin`` or ``scale_down``. The bytes are the reference's for
the same ``Membership``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

MEMBERSHIP_FILENAME = "membership.json"


@dataclasses.dataclass(frozen=True)
class Membership:
    """One generation's world: its member slots, ordered (a member's rank
    is its index in ``members``). ``ready`` holds the slots whose external
    agent signalled recovery (``signal_ready``), to be re-admitted at the
    next generation boundary."""

    generation: int
    members: tuple[int, ...]
    min_world_size: int
    reason: str
    ready: tuple[int, ...] = ()

    @property
    def world_size(self) -> int:
        return len(self.members)


def membership_path(run_dir: str) -> str:
    return os.path.join(os.path.abspath(run_dir), MEMBERSHIP_FILENAME)


def write_membership(run_dir: str, m: Membership) -> str:
    """Persist ``m`` atomically (tmp + rename: a writer killed mid-write
    never leaves half a document). Returns the path written."""
    path = membership_path(run_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = {
        "generation": m.generation,
        "world_size": m.world_size,
        "members": list(m.members),
        "min_world_size": m.min_world_size,
        "reason": m.reason,
        "ready": list(m.ready),
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)
    return path


def read_membership(run_dir: str) -> Optional[Membership]:
    """The persisted membership, or ``None`` when none was written. A torn
    or garbled file also reads as ``None``: the writer is atomic, so
    garbage means something else wrote there."""
    try:
        with open(membership_path(run_dir), encoding="utf-8") as fh:
            doc = json.load(fh)
        return Membership(
            generation=int(doc["generation"]),
            members=tuple(int(s) for s in doc["members"]),
            min_world_size=int(doc.get("min_world_size", 1)),
            reason=str(doc.get("reason", "")),
            ready=tuple(int(s) for s in doc.get("ready", ())),
        )
    except (OSError, ValueError, KeyError, TypeError):
        return None


def signal_ready(run_dir: str, slot: int) -> bool:
    """Mark ``slot`` ready in the membership file (an external agent asking
    back in). True when the signal is recorded or the slot is already a
    member; False when no membership exists yet to signal against. A
    writer racing this read-modify-replace can drop the signal; the agent
    polls and signals again."""
    m = read_membership(run_dir)
    if m is None:
        return False
    slot = int(slot)
    if slot in m.members or slot in m.ready:
        return True
    write_membership(run_dir, dataclasses.replace(
        m, ready=tuple(sorted(set(m.ready) | {slot}))))
    return True


def ready_slots(run_dir: str) -> set[int]:
    """The slots that signalled recovery (empty without a membership)."""
    m = read_membership(run_dir)
    return set(m.ready) if m is not None else set()
