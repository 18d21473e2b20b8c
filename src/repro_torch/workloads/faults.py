"""Seeded fault-injection plans for chaos runs.

A ``FaultPlan`` is a deterministic schedule of kill / partition / heal events
against a replicated cluster, keyed by op index: the YCSB chaos driver
(``run_chaos_workload``) and the quorum unit/property tests replay the same
plan from the same seed, so a failing interleaving is reproducible by its
seed alone.

The generator enforces the invariants the quorum design states (and the
tests rely on):

  * at most ONE outstanding fault per shard — every fault is healed before
    the same shard is faulted again, so a write quorum always survives at
    ``replication>=3`` and no schedule can legally lose all live members;
  * every fault gets a heal, and the heal lands inside the op stream, so a
    plan always returns the cluster to full strength;
  * events at the same op index apply in list order (deterministic).

Kinds:
  * ``kill_primary``  — the shard's primary crashes AND loses its NVM
                        (rejoin = promote + fresh resync)
  * ``kill_backup``   — one backup replica crashes and loses its NVM
  * ``partition``     — the primary is cut off MID-WRITE: the in-flight
                        write's data-leg WQEs stay posted, a backup is
                        promoted under a bumped epoch, then the stale WQEs
                        ring and must bounce (split-brain fencing)
  * ``heal``          — repair the shard back to full strength
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

FAULT_KINDS = ("kill_primary", "kill_backup", "partition")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    op_index: int
    kind: str  # one of FAULT_KINDS, or "heal"
    shard: int
    replica: int = 0  # which member (kill_backup targets >= 1)


class FaultPlan:
    """An immutable, replayable schedule of FaultEvents over an op stream."""

    def __init__(self, events: List[FaultEvent], *, seed: int, n_ops: int,
                 n_shards: int, replication: int):
        self.events = sorted(events, key=lambda e: e.op_index)
        self.seed = seed
        self.n_ops = n_ops
        self.n_shards = n_shards
        self.replication = replication
        self._by_index: Dict[int, List[FaultEvent]] = {}
        for e in self.events:
            self._by_index.setdefault(e.op_index, []).append(e)

    @classmethod
    def generate(cls, seed: int, n_ops: int, n_shards: int,
                 replication: int = 3, n_faults: int = 6,
                 min_gap: int = 8) -> "FaultPlan":
        """Deterministically derive a plan from ``seed``: ``n_faults``
        fault+heal pairs spread over the op stream, each heal ``min_gap`` to
        ``2*min_gap`` ops after its fault, never two outstanding faults on
        one shard."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        healed_at = [0] * n_shards  # op index each shard becomes healthy again
        span = max(n_ops - 3 * min_gap, 1)
        starts = sorted(int(min_gap + rng.integers(span))
                        for _ in range(n_faults))
        for start in starts:
            # pick a shard that is healthy at `start` (deterministic order:
            # rotate from a seeded offset)
            first = int(rng.integers(n_shards))
            shard = next((s for s in (np.arange(n_shards) + first) % n_shards
                          if healed_at[int(s)] <= start), None)
            if shard is None:
                continue  # every shard mid-fault: drop this slot
            shard = int(shard)
            kind = FAULT_KINDS[int(rng.integers(len(FAULT_KINDS)))]
            replica = 0
            if kind == "kill_backup":
                replica = 1 + int(rng.integers(max(replication - 1, 1)))
            if replication < 2:
                kind = "kill_primary"  # nothing to mirror or promote
            heal_at = min(start + min_gap + int(rng.integers(min_gap + 1)),
                          n_ops - 1)
            if heal_at <= start:
                continue
            events.append(FaultEvent(start, kind, shard, replica))
            events.append(FaultEvent(heal_at, "heal", shard))
            healed_at[shard] = heal_at + 1
        return cls(events, seed=seed, n_ops=n_ops, n_shards=n_shards,
                   replication=replication)

    def due(self, op_index: int) -> List[FaultEvent]:
        """Events to apply before op ``op_index`` executes."""
        return self._by_index.get(op_index, [])

    @property
    def faults(self) -> List[FaultEvent]:
        return [e for e in self.events if e.kind != "heal"]

    def describe(self) -> str:
        return " ".join(f"@{e.op_index}:{e.kind}(s{e.shard}"
                        f"{',r%d' % e.replica if e.replica else ''})"
                        for e in self.events)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultPlan) and self.events == other.events

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"<FaultPlan seed={self.seed} n_ops={self.n_ops} "
                f"{len(self.faults)} faults: {self.describe()}>")
