"""ErdaCluster — N ErdaServer shards behind consistent-hash key routing.

Scaling the single-server protocol out: each shard is a full, independent
``ErdaServer`` (own NVM device, hopscotch table, log heads) with its own
``ErdaClient`` connection and its own transport, so one-sided reads keep their
zero-server-CPU property per shard and a shard's failure/recovery is contained
to that shard.

Key routing uses a consistent-hash ring with virtual nodes: shard ``i`` owns
``vnodes`` pseudo-random points on the 64-bit ring; a key is served by the
first point clockwise of ``hash(key)``.  Virtual nodes keep the load spread
even, and growing the cluster by one shard relocates only ~1/(n+1) of the key
space — the property online resharding rides.

Availability (``replication>=2``): every ring slot is a ``ShardGroup`` — a
primary replica plus ``replication-1`` backups placed on successive
ring-successor hosts — and every write mirrors both of its legs to every
live replica on its own QP within the same batch scopes, acked at a write
quorum (see ``repro_torch.core.replication``).  Reads stay one-sided against the
primary; while a primary is down the group serves QUORUM reads across the
backups instead of going dark.  ``fail_shard(i, replica=j)`` fails one
replica; ``failover(i)`` promotes the senior live backup under a bumped,
QP-fenced epoch (a partitioned old primary's stale-epoch writes bounce);
``recover_shard(i)`` crash-restarts intact members and re-syncs fresh
replicas for wiped/evicted slots.

Elastic membership (online resharding): ``add_shard()`` / ``remove_shard()``
change membership on a LIVE cluster.  The ring is versioned through a
``RingGeneration`` — the old and new rings coexist while the moving keyspace
slices migrate one at a time (epoch-fenced cutover, dual-read while in
flight, MigrationLog-driven copy, grace-period cleanup of the source
copies; see ``repro_torch.core.resharding``).  Groups live in a ``ShardMap`` keyed
by shard id, so ids stay stable (and may go sparse) across membership
changes while pre-elastic call sites that iterate ``cluster.groups`` keep
working.

Cluster-wide coordination:
  * ``recover()``         — run the §4.2 crash-recovery scan on every shard
                            (or one shard via ``recover_shard``): shards
                            recover independently, there is no global log.
  * ``maybe_clean()`` /
    ``compact()``         — drive the lock-free cleaner across all shards'
                            heads; cleaning one head on one shard never blocks
                            traffic to any other shard.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.client import ErdaClient
from repro_torch.core.hashtable import splitmix64
from repro_torch.core.replication import ShardDownError, ShardGroup
from repro_torch.core.resharding import RingGeneration, Resharding, key_hash
from repro_torch.core.server import ErdaServer, ServerConfig
from repro_torch.nvmsim.device import NVMDevice


class HashRing:
    """Consistent-hash ring with virtual nodes over the u64 hash space.

    Each shard's vnode points are ``splitmix64(splitmix64(shard + 1) ^ v)`` —
    a per-shard seeded stream, so a vnode index can never bleed into the shard
    field no matter how large ``vnodes`` grows (the old ``(shard << 20) | v``
    derivation collided across shards once ``v`` exceeded 2**20).  Points sort
    by the explicit ``(hash, shard)`` pair, so an equal-hash tie breaks the
    same way on every rebuild regardless of shard insertion order, and a key
    whose hash lands exactly ON a point belongs to THAT point's shard
    (``bisect_left``; first point clockwise, inclusive).

    A shard's points depend only on its ID — membership changes leave every
    surviving shard's points exactly where they were, which is what makes
    add/remove minimal-movement (only the slices whose closest-point owner
    changed move; see ``repro_torch.core.resharding.moving_slices``)."""

    def __init__(self, n_shards: int, vnodes: int = 64,
                 shard_ids: Optional[Sequence[int]] = None):
        if n_shards < 1:
            raise ValueError("cluster needs at least one shard")
        self.n_shards = n_shards
        self.vnodes = vnodes
        ids = list(shard_ids) if shard_ids is not None else list(range(n_shards))
        if len(ids) != n_shards:
            raise ValueError("shard_ids must name every shard exactly once")
        self.ids = sorted(ids)
        points = []
        for shard in ids:
            seed = splitmix64(shard + 1)
            for v in range(vnodes):
                points.append((splitmix64(seed ^ v), shard))
        points.sort()  # (hash, shard): deterministic tie-break
        self._points = points
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]

    # the key→ring-position hash lives in repro_torch.core.resharding (shared with
    # the slice machinery, so slice membership and routing can never disagree)
    key_hash = staticmethod(key_hash)

    def shard_for_hash(self, h: int) -> int:
        # bisect_left: a key hashing exactly onto a point is owned by it
        i = bisect.bisect_left(self._hashes, h)
        if i == len(self._hashes):
            i = 0  # wrap around the ring
        return self._shards[i]

    def shard_for(self, key: int) -> int:
        return self.shard_for_hash(key_hash(key))


class ShardMap(Dict[int, ShardGroup]):
    """shard_id → ShardGroup mapping that ITERATES ITS VALUES in shard-id
    order.  Pre-elastic code was written against a ``List[ShardGroup]``
    (``for g in cluster.groups``, ``enumerate(cluster.groups)``,
    ``cluster.groups[shard]``); keying by shard id keeps those call sites
    working after ``remove_shard`` makes the id space sparse.  Use
    ``.keys()`` / ``.items()`` for the ids."""

    def __iter__(self) -> Iterator[ShardGroup]:
        return iter([self[k] for k in sorted(self.keys())])


#: per-shard default — smaller than the single-server default since a cluster
#: multiplies it by n_shards
SHARD_CONFIG = ServerConfig(device_size=64 << 20, table_capacity=1 << 14)


class ErdaCluster:
    def __init__(self, n_shards: int = 4, cfg: Optional[ServerConfig] = None,
                 transport_factory: Optional[Callable[[NVMDevice], object]] = None,
                 vnodes: int = 64, replication: int = 1, device="cuda"):
        if replication < 1:
            raise ValueError("replication must be >= 1")
        self.device = device  # every shard connection verifies CRCs here
        self.cfg = cfg = cfg or SHARD_CONFIG
        self.replication = replication
        self.vnodes = vnodes
        self._transport_factory = transport_factory
        self.generation = RingGeneration(HashRing(n_shards, vnodes))
        self.resharding: Optional[Resharding] = None
        #: groups retired by remove_shard — kept so cumulative counters
        #: (stale_rejected, epoch bumps) stay monotonic across scale-in
        self.retired: List[ShardGroup] = []
        # each shard connection gets its own QP lane, so per-shard batches are
        # independently doorbell'd and their completions overlap across shards;
        # replica j of shard i rides lane j*n_shards + i and is placed on ring
        # host (i + j) % n_shards (successive ring successors)
        self.groups: ShardMap = ShardMap()
        for i in range(n_shards):
            replicas = [self._connect(ErdaServer(cfg), lane=j * n_shards + i)
                        for j in range(replication)]
            hosts = [None] + [(i + j) % n_shards
                              for j in range(1, replication)]
            self.groups[i] = ShardGroup(i, replicas[0],
                                        backups=replicas[1:],
                                        replica_hosts=hosts)
        # later lanes (healed joiners, elastic shards) allocate past the
        # initial block so every connection keeps a unique QP
        self._next_lane = replication * n_shards

    def _connect(self, server: ErdaServer, lane: int) -> ErdaClient:
        t = self._transport_factory(server.dev) if self._transport_factory else None
        return ErdaClient(server, client_id=lane, qp=lane, transport=t,
                          device=self.device)

    def _alloc_lane(self) -> int:
        lane = self._next_lane
        self._next_lane += 1
        return lane

    @property
    def ring(self) -> HashRing:
        """The CURRENT ring generation (the old ring while a migration is in
        flight — per-slice routing overrides live in ``self.resharding``)."""
        return self.generation.current

    @property
    def ring_version(self) -> int:
        return self.generation.version

    @property
    def n_shards(self) -> int:
        return len(self.groups)

    @property
    def shard_ids(self) -> List[int]:
        """Sorted live shard ids — contiguous ``0..n-1`` until a
        ``remove_shard`` makes the space sparse."""
        return sorted(self.groups.keys())

    @property
    def servers(self) -> List[ErdaServer]:
        """The CURRENT primary replica server of every shard."""
        return [g.primary.server for g in self.groups]

    @property
    def clients(self) -> List[ErdaClient]:
        """The CURRENT primary replica connection of every shard."""
        return [g.primary for g in self.groups]

    def _ring_successor(self, shard: int) -> int:
        ids = self.shard_ids
        i = ids.index(shard)
        return ids[(i + 1) % len(ids)]

    def shard_for_key(self, key: int) -> int:
        if self.resharding is not None:
            return self.resharding.route(key)[0]
        return self.ring.shard_for(key)

    def client_for_key(self, key: int) -> ErdaClient:
        return self.groups[self.shard_for_key(key)].primary

    def group_for_key(self, key: int) -> ShardGroup:
        return self.groups[self.shard_for_key(key)]

    # ------------------------------------------------------------------ kv ops
    def read(self, key: int) -> Optional[bytes]:
        rs = self.resharding
        if rs is not None:
            shard, s = rs.route(key)
            if s is not None:
                return rs.read(key, s)  # dual-fetch: in-flight slice
            return self.groups[shard].read(key)
        return self.groups[self.ring.shard_for(key)].read(key)

    def write(self, key: int, value: bytes) -> None:
        rs = self.resharding
        if rs is not None:
            shard, s = rs.route(key)
            if s is not None:
                rs.write(key, value, s)  # new owner + MigrationLog "fresh"
                return
            self.groups[shard].write(key, value)
            return
        self.groups[self.ring.shard_for(key)].write(key, value)

    def delete(self, key: int) -> None:
        rs = self.resharding
        if rs is not None:
            shard, s = rs.route(key)
            if s is not None:
                rs.delete(key, s)  # MigrationLog tombstone
                return
            self.groups[shard].delete(key)
            return
        self.groups[self.ring.shard_for(key)].delete(key)

    # ------------------------------------------------------------- batched ops
    def multi_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """Batched read across shards: keys group by owning shard, each shard
        client posts its sub-batch over its own QP (2 doorbells per shard, not
        2 round trips per key), and completions overlap across shards — the
        DES layer replays per-shard traces concurrently.  Keys in an
        in-flight migration slice take the per-key dual-read path (rare: one
        slice at a time)."""
        rs = self.resharding
        out: List[Optional[bytes]] = [None] * len(keys)
        by_shard: Dict[int, List[int]] = {}
        for i, key in enumerate(keys):
            if rs is not None:
                shard, s = rs.route(key)
                if s is not None:
                    out[i] = rs.read(key, s)
                    continue
            else:
                shard = self.ring.shard_for(key)
            by_shard.setdefault(shard, []).append(i)
        for shard, idxs in by_shard.items():
            vals = self.groups[shard].multi_read([keys[i] for i in idxs])
            for i, v in zip(idxs, vals):
                out[i] = v
        return out

    def multi_write(self, items: Sequence[Tuple[int, bytes]]) -> None:
        """Batched write across shards: per-shard sub-batches, each 2
        doorbells (metadata flips, fence, data writes) on that shard's QP."""
        rs = self.resharding
        by_shard: Dict[int, List[Tuple[int, bytes]]] = {}
        for key, value in items:
            if rs is not None:
                shard, s = rs.route(key)
                if s is not None:
                    rs.write(key, value, s)
                    continue
            else:
                shard = self.ring.shard_for(key)
            by_shard.setdefault(shard, []).append((key, value))
        for shard, shard_items in by_shard.items():
            self.groups[shard].multi_write(shard_items)

    # ------------------------------------------------------- elastic membership
    def add_shard(self, shard_id: Optional[int] = None, *, run: bool = True,
                  grace: int = 1, batch: int = 32) -> Resharding:
        """Grow the live cluster by one shard.  The new ``ShardGroup`` (full
        replication, fresh QP lanes) joins the membership immediately; a
        ``Resharding`` migrates the ~1/(n+1) of the keyspace whose closest
        ring point is now the new shard's, slice by slice, while every other
        key keeps serving untouched.  ``run=True`` drains the migration
        before returning; ``run=False`` returns the controller so a serving
        loop can interleave ``step(budget)`` with client traffic."""
        if self.resharding is not None:
            raise RuntimeError("a resharding is already in progress")
        new_id = max(self.groups.keys()) + 1 if shard_id is None else shard_id
        if new_id in self.groups:
            raise ValueError(f"shard {new_id} already exists")
        ids = sorted([*self.groups.keys(), new_id])
        replicas = [self._connect(ErdaServer(self.cfg), lane=self._alloc_lane())
                    for _ in range(self.replication)]
        pos = ids.index(new_id)
        hosts = [None] + [ids[(pos + j) % len(ids)]
                          for j in range(1, self.replication)]
        self.groups[new_id] = ShardGroup(new_id, replicas[0],
                                         backups=replicas[1:],
                                         replica_hosts=hosts)
        return self._begin_resharding(ids, adding=new_id, run=run,
                                      grace=grace, batch=batch)

    def remove_shard(self, shard_id: int, *, run: bool = True,
                     grace: int = 1, batch: int = 32) -> Resharding:
        """Shrink the live cluster by one shard.  The leaving shard keeps
        serving its keyspace while each of its slices cuts over and drains to
        the slice's new owner; once the migration completes the group retires
        (its cumulative counters fold into the cluster's)."""
        if self.resharding is not None:
            raise RuntimeError("a resharding is already in progress")
        if shard_id not in self.groups:
            raise ValueError(f"no such shard: {shard_id}")
        if len(self.groups) < 2:
            raise ValueError("cannot remove the last shard")
        if self.groups[shard_id].primary_down:
            raise ShardDownError(shard_id, "recover before removing")
        ids = sorted(i for i in self.groups.keys() if i != shard_id)
        return self._begin_resharding(ids, removing=shard_id, run=run,
                                      grace=grace, batch=batch)

    def _begin_resharding(self, ids: List[int], *, adding: Optional[int] = None,
                          removing: Optional[int] = None, run: bool,
                          grace: int, batch: int) -> Resharding:
        self.generation.begin(HashRing(len(ids), self.vnodes, shard_ids=ids))
        rs = Resharding(self, self.generation, adding=adding,
                        removing=removing, grace=grace, batch=batch)
        self.resharding = rs
        if run:
            rs.run_to_completion()
        return rs

    def _finish_resharding(self, rs: Resharding) -> None:
        """Called by ``Resharding`` once every slice is done and cleaned:
        swing the ring generation and retire a removed shard."""
        self.generation.commit()
        self.resharding = None
        if rs.removing is not None:
            g = self.groups.pop(rs.removing)
            self.retired.append(g)
            # host labels that pointed at the retired shard remap to its ring
            # successor (they are DES port placements, not data placement)
            for g2 in self.groups:
                g2.replica_hosts = [
                    None if h is None else
                    (h if h in self.groups else self._ring_successor(g2.shard_id))
                    for h in g2.replica_hosts]

    # ---------------------------------------------------------------- failover
    def fail_shard(self, shard: int, replica: int = 0, *,
                   wipe: bool = False) -> None:
        """Simulate losing shard ``shard``'s replica ``replica`` (0 = the
        primary).  A down primary degrades the group: reads fall back to
        quorum reads across the backups, writes raise ``ShardDownError``
        until ``failover`` promotes or ``recover_shard`` crash-restarts it.
        A down backup just shrinks the live set — writes keep acking while a
        write quorum holds.  ``wipe=True`` loses the NVM too: the slot can
        only rejoin via a fresh resync (``recover_shard``)."""
        self.groups[shard].fail_replica(replica, wipe=wipe)

    def failover(self, shard: int) -> Dict[str, int]:
        """Epoch-fenced promotion of shard ``shard``'s most senior live
        backup: membership drops the old primary, every survivor is
        §4.2-swept + reconnected, the group epoch bumps and the old epoch's
        write grant is revoked at every survivor's QP — a partitioned old
        primary's in-flight writes bounce (StaleEpochError).  The group
        keeps serving (degraded) until ``recover_shard`` re-syncs fresh
        replicas."""
        g = self.groups[shard]
        g.promote()
        return {"promotions": g.promotions, "epoch": g.epoch,
                "keys": g.primary.server.table.n_items}

    # ---------------------------------------------------------------- recovery
    def recover_shard(self, shard: int) -> Dict[str, int]:
        """Repair one shard back to full strength.  A crashed-in-place
        primary (media intact, never promoted away): §4.2 recovery scan +
        reconnect, then resume.  Down backups crash-restart in place when
        their NVM survived; wiped or promotion-evicted slots get a fresh
        rejoining replica re-synced from the primary's log.  Other shards
        keep serving untouched either way."""
        g = self.groups[shard]
        if g.primary_down and g.wiped[0]:
            raise ShardDownError(shard, "primary wiped — failover first")
        # §4.2-sweep the primary (a crash-restart repairs in place; a healthy
        # or degraded survivor gets its volatile index/tail rebuilt ahead of
        # any resync) and reconnect: size hints are stale-but-safe, but
        # LOCATION hints must drop — recovery may have flipped words back to
        # OLD offsets (§4.2 repair), so a cached word could otherwise
        # validate a superseded location
        stats: Dict[str, int] = dict(g.primary.server.recover())
        g.primary.reconnect()
        if g.replicated:
            g.primary.set_epoch(g.epoch)
            g.primary.transport.revoke_epochs_below(g.epoch)
        g.primary_down = False
        # sweep intact live backups too (full-site power loss recovers every
        # replica); down/wiped/evicted slots go through heal()'s
        # crash-restart-or-resync paths
        for i in range(1, len(g.replicas)):
            if not g.down[i]:
                for k, v in g.replicas[i].server.recover().items():
                    stats[f"backup_{k}"] = stats.get(f"backup_{k}", 0) + v
                g.replicas[i].reconnect()
                g.replicas[i].set_epoch(g.epoch)
        if self.replication > 1:
            def joiner_factory(slot: int) -> ErdaClient:
                # reuse the evicted slot's QP lane when one exists (traces
                # line up across a heal); fresh slots get a fresh lane
                if slot < len(g.replicas):
                    lane = g.replicas[slot].qp
                else:
                    lane = self._alloc_lane()
                return self._connect(ErdaServer(self.cfg), lane=lane)
            for k, v in g.heal(joiner_factory).items():
                stats[k] = stats.get(k, 0) + v
            g.backup_host = self._ring_successor(shard)
        return stats

    def recover(self) -> Dict[str, int]:
        """Cluster-wide recovery sweep (e.g. after full-site power loss)."""
        total: Dict[str, int] = {"shards": 0}
        for shard in self.shard_ids:
            for k, v in self.recover_shard(shard).items():
                total[k] = total.get(k, 0) + v
            total["shards"] += 1
        return total

    # ---------------------------------------------------------------- cleaning
    def maybe_clean(self) -> int:
        """Start + run cleaning on every head over threshold, on every shard."""
        from repro_torch.core.cleaning import sweep_server
        return sum(sweep_server(s) for s in self.servers)

    def compact(self) -> int:
        """Force-clean every head of every shard (page eviction / GC sweep)."""
        from repro_torch.core.cleaning import sweep_server
        return sum(sweep_server(s, force=True) for s in self.servers)

    # ------------------------------------------------------------------- stats
    @property
    def stats(self) -> Dict[str, int]:
        """Aggregated PRIMARY-connection op counters across all shards (the
        client-observed protocol cost; mirror-lane traffic is in
        ``replica_stats``)."""
        total: Dict[str, int] = {}
        for c in self.clients:
            for k, v in c.stats.items():
                total[k] = total.get(k, 0) + v
        return total

    @property
    def replica_stats(self) -> Dict[str, int]:
        """Aggregated backup-lane op counters (mirrored-write traffic),
        summed over every backup replica of every group."""
        total: Dict[str, int] = {}
        for g in self.groups:
            for b in g.backups:
                for k, v in b.stats.items():
                    total[k] = total.get(k, 0) + v
        return total

    @property
    def epoch_bumps(self) -> int:
        """Total epoch bumps across all groups — failover promotions plus
        resharding slice cutovers (including retired groups)."""
        return sum(g.epoch for g in self.groups) + \
            sum(g.epoch for g in self.retired)

    @property
    def degraded_reads(self) -> int:
        """Keys served through quorum reads while a primary was down."""
        return sum(g.degraded_reads for g in self.groups) + \
            sum(g.degraded_reads for g in self.retired)

    @property
    def stale_rejected(self) -> int:
        """Stale-epoch WQEs bounced at any replica's QP (split-brain writes
        fenced after a promotion, or straggler writes fenced by a slice
        cutover)."""
        return sum(g.stale_rejected for g in self.groups) + \
            sum(g.stale_rejected for g in self.retired)

    def keys_per_shard(self) -> List[int]:
        return [s.table.n_items for s in self.servers]
