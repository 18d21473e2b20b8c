"""Quorum shard replication (synchronous RDMA mirroring, ``replication>=2``).

A shard whose NVM is lost takes its keyspace offline; with replication every
ring slot is served by a ``ShardGroup`` — a primary replica plus one or more
backup replicas placed on successive ring hosts — and every write mirrors its
two legs to EVERY live replica:

  * the ``write_with_imm`` metadata flip and the one-sided data write are
    posted on each replica's OWN QP inside the same ``batch()`` scopes, so a
    replicated write still costs 2 doorbells per lane (all flips → fence →
    all data writes), and
  * the DES prices the mirrors as OVERLAPPED, not serialized: each lane is a
    separate transport whose trace replays as a concurrent process
    (cf. Tavakkol et al. 1810.09360 — one-sided batched PM mirroring is
    cheap; Kashyap et al. 1909.02092 — the remote persistence point is the
    mirrored data write's NVM media write, which each lane pays itself).

**Quorum rule.**  A write is acknowledged once a *write quorum* of the
current membership has both legs complete — W = majority of the members the
group currently has (r=2 → 2, r=3 → 2); in the DES the ack point is the
W-th lane's completion and the DURABILITY point is the W-th lane's persist
leg (for r=2, the LATER replica — see ``netsim.pricing.quorum_times_s``).
Functionally the group writes to ALL live replicas and refuses (raises
``ShardDownError``) when fewer than W members are live, which keeps the
invariant the whole design rests on:

    every LIVE member holds every acknowledged write

(a member that was down during a write only rejoins through a resync).  Any
live member is therefore safe to promote or to serve a degraded read.

**Reads.**  One-sided against the primary — zero server CPU, zero extra RTT.
While the primary is down (crashed, partitioned, or resyncing) the group
keeps serving through a *quorum read*: the same one-sided read on R =
(members − W + 1) live backups' own QPs (overlapped in the DES), values
cross-checked, the most senior live backup — the next promotion target —
winning any disagreement (only un-acked tails can disagree).  A degraded
group only stops serving reads when fewer than R backups are live.

**Epoch-fenced failover (split-brain safety).**  Every group carries an
epoch; every write-path WR is stamped with it.  ``promote()`` is a
membership change: it drops the dead/partitioned old primary, §4.2-sweeps
every surviving replica (an unacknowledged mirrored tail may sit torn in
their logs), bumps the epoch, and REVOKES the previous epoch's write grant
at each surviving replica's transport (``revoke_epochs_below``) — the
one-sided RDMA permission revocation of "The Impact of RDMA on Agreement"
(1905.12143), which makes promotion safe without a consensus round.  A
partitioned old coordinator's in-flight posted WQEs carry the stale epoch
and are rejected AT THE QP when their doorbell finally rings
(``StaleEpochError``), so a write the old primary thought it was completing
can never reach a survivor's memory, let alone be acknowledged, after the
promotion.  Survivors ``reconnect()`` at the bump, dropping their location
caches — the one hint class that is NOT stale-but-safe across a promotion.

Failure/repair state machine of a group (r=3):

    ACTIVE ──fail_replica(i)──▶ DEGRADED (quorum holds: serves everything)
       ▲         │
       │         ├─ primary down: reads degrade to quorum reads,
       │         │  writes raise ShardDownError until promote()
       │         ▼
       │      promote() ── epoch += 1, fence old primary, survivors sweep
       │         │
       └── heal(joiner_factory) ── crash-restart intact members in place,
           resync fresh joiners for wiped/evicted slots (batched one-sided
           reads from the primary, batched writes into the joiner)
"""
from __future__ import annotations

from contextlib import ExitStack
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import layout
from repro_torch.core.cleaning import live_resync_keys
from repro_torch.core.client import ErdaClient
from repro_torch.fabric.transport import StaleEpochError


class ShardDownError(Exception):
    """The shard group cannot serve the op: primary down (writes), or fewer
    live members than the required quorum."""

    def __init__(self, shard: int, reason: str = "primary replica is down"):
        super().__init__(f"shard {shard}: {reason}")
        self.shard = shard
        self.reason = reason


#: batch size resync uses to stream the survivor's objects into a joiner
RESYNC_BATCH = 32


class InFlightWrite:
    """A partitioned coordinator's mid-write state: the metadata flips were
    delivered (they rang before the partition), the data-write WQEs sit
    posted on each lane's send queue with the doorbell un-rung.  ``ring()``
    lets those stale WQEs finally reach the NICs — after a promotion they
    carry a revoked epoch and every surviving replica's QP rejects them
    (``StaleEpochError``), so the write can never be acknowledged out of the
    partition.  The split-brain regression test and the chaos driver's
    partition event both drive this."""

    def __init__(self, key: int, value: bytes, quorum: int,
                 lanes: List[Tuple[ErdaClient, object, object]]):
        self.key = key
        self.value = value
        self.quorum = quorum  # W at post time: completions below this ≠ ack
        self._lanes = lanes   # (client, open batch, data-write handle)
        self.outcomes: List[str] = []

    def ring(self) -> List[str]:
        """Ring each lane's pending doorbell; per-lane outcome is
        ``"completed"`` (the lane accepted the stale write — only possible
        at an endpoint whose grant was never revoked, e.g. the partitioned
        old primary itself) or ``"rejected"``."""
        outcomes = []
        for c, batch, _h in self._lanes:
            try:
                batch.__exit__(None, None, None)
                c.transport.poll(c.qp)
                outcomes.append("completed")
            except StaleEpochError:
                outcomes.append("rejected")
        self.outcomes = outcomes
        self._lanes = []
        return outcomes

    @property
    def acked(self) -> bool:
        """Could the partitioned coordinator have acknowledged this write?
        Only if a write quorum of lanes completed."""
        return self.outcomes.count("completed") >= self.quorum


class ShardGroup:
    """One ring slot's replica set: ``replicas[0]`` is the primary, the rest
    mirror every write.  Membership, liveness, epoch, and quorum policy all
    live here."""

    def __init__(self, shard_id: int, primary: ErdaClient,
                 backup: Optional[ErdaClient] = None,
                 backup_host: Optional[int] = None,
                 backups: Optional[Sequence[ErdaClient]] = None,
                 replica_hosts: Optional[Sequence[Optional[int]]] = None):
        if backups is None:
            backups = [backup] if backup is not None else []
        self.shard_id = shard_id
        self.replicas: List[ErdaClient] = [primary, *backups]
        self.down: List[bool] = [False] * len(self.replicas)
        self.wiped: List[bool] = [False] * len(self.replicas)
        if replica_hosts is None:
            replica_hosts = [None] + [backup_host] * len(backups)
        self.replica_hosts: List[Optional[int]] = list(replica_hosts)
        #: target replica count (membership may run short after a promotion
        #: until ``heal`` rebuilds the evicted slot)
        self.replication = max(len(self.replicas), 1)
        self.epoch = 0
        self.promotions = 0
        self.degraded_reads = 0
        self.quorum_read_conflicts = 0
        #: ex-primaries evicted by a promotion — fenced, kept for inspection
        self.fenced: List[ErdaClient] = []
        #: rejections whose transport left the group (wiped replicas
        #: replaced by fresh joiners) — folded into ``stale_rejected``
        self._retired_stale_rejected = 0
        if len(self.replicas) > 1:
            for r in self.replicas:
                r.set_epoch(self.epoch)

    # ----------------------------------------------------------- membership
    @property
    def primary(self) -> ErdaClient:
        return self.replicas[0]

    @property
    def backups(self) -> List[ErdaClient]:
        return self.replicas[1:]

    @property
    def backup(self) -> Optional[ErdaClient]:
        """First backup, or None — the r=2 view of the group."""
        return self.replicas[1] if len(self.replicas) > 1 else None

    @property
    def backup_host(self) -> Optional[int]:
        return self.replica_hosts[1] if len(self.replica_hosts) > 1 else None

    @backup_host.setter
    def backup_host(self, host: Optional[int]) -> None:
        while len(self.replica_hosts) < 2:
            self.replica_hosts.append(None)
        self.replica_hosts[1] = host

    @property
    def primary_down(self) -> bool:
        return self.down[0]

    @primary_down.setter
    def primary_down(self, v: bool) -> None:
        self.down[0] = v

    @property
    def write_quorum(self) -> int:
        """Majority of the CURRENT membership (a promotion is a membership
        change, so acked writes always sit on a majority of the
        configuration that acked them)."""
        return len(self.replicas) // 2 + 1

    @property
    def read_quorum(self) -> int:
        return len(self.replicas) - self.write_quorum + 1

    def _live(self) -> List[ErdaClient]:
        return [r for r, d in zip(self.replicas, self.down) if not d]

    @property
    def live_count(self) -> int:
        return len(self._live())

    @property
    def replicated(self) -> bool:
        return len(self.replicas) > 1

    @property
    def stale_rejected(self) -> int:
        """Stale-epoch WQEs bounced at any member's (or fenced
        ex-member's) QP."""
        seen, total = set(), self._retired_stale_rejected
        for c in [*self.replicas, *self.fenced]:
            t = c.transport
            if id(t) not in seen:
                seen.add(id(t))
                total += getattr(t, "stale_rejected", 0)
        return total

    # ------------------------------------------------------------------ state
    def _check_writable(self) -> None:
        if self.down[0]:
            raise ShardDownError(self.shard_id)
        if self.live_count < self.write_quorum:
            raise ShardDownError(
                self.shard_id,
                f"write quorum lost ({self.live_count} live < "
                f"{self.write_quorum} required)")

    def fail_replica(self, idx: int, *, wipe: bool = False) -> None:
        """Mark replica ``idx`` failed.  ``wipe=False`` models a crash with
        the NVM media intact (a later ``heal`` §4.2-repairs it in place) or
        a network partition; ``wipe=True`` models losing the NVM — the slot
        can only rejoin through a fresh resync."""
        self.down[idx] = True
        if wipe:
            self.wiped[idx] = True

    def fail_primary(self) -> None:
        """Simulate losing the primary replica: writes raise
        ``ShardDownError`` until ``promote()``; reads degrade to quorum
        reads across the backups (and only fail below the read quorum)."""
        self.fail_replica(0)

    def promote(self) -> ErdaClient:
        """Epoch-fenced failover: the most senior live backup becomes the
        primary.  A membership change + a fence, in this order:

        1. evict the old primary from the membership (its client is kept in
           ``fenced`` — its posted WQEs still carry the old epoch),
        2. §4.2-sweep EVERY surviving replica (any of their log tails may
           hold a mirrored-but-unacknowledged torn write),
        3. bump the group epoch, and at each survivor: ``reconnect()`` (drops
           the location cache — cached offsets are NOT stale-but-safe across
           a promotion), adopt the new epoch, and REVOKE the old epoch's
           write grant at the transport, so the evicted primary's in-flight
           stale-epoch writes bounce at the QP (1905.12143's one-sided
           permission fence — no consensus round needed).

        Returns the evicted ex-primary's client."""
        live_backups = [i for i in range(1, len(self.replicas))
                        if not self.down[i]]
        if not live_backups:
            raise RuntimeError(
                f"shard {self.shard_id}: no live backup replica to promote")
        if not self.down[0]:
            raise RuntimeError(
                f"shard {self.shard_id}: primary is up — nothing to promote")
        new_primary = live_backups[0]
        old = self.replicas[0]
        order = [new_primary] + [i for i in range(1, len(self.replicas))
                                 if i != new_primary]
        self.replicas = [self.replicas[i] for i in order]
        self.down = [self.down[i] for i in order]
        self.wiped = [self.wiped[i] for i in order]
        self.replica_hosts = [self.replica_hosts[i] for i in order]
        self.fenced.append(old)
        self.epoch += 1
        for r, is_down in zip(self.replicas, self.down):
            if is_down:
                continue  # a down member only rejoins via heal()/resync
            r.server.recover()
            r.reconnect()
            r.set_epoch(self.epoch)
            r.transport.revoke_epochs_below(self.epoch)
        self.promotions += 1
        return old

    def bump_epoch(self) -> int:
        """Fence the current generation WITHOUT a membership change — the
        slice-cutover primitive of online resharding.  The epoch bumps, every
        live member adopts it and revokes the old epoch's write grant at its
        QP, so an in-flight write posted before the cutover bounces
        (``StaleEpochError``) when its doorbell finally rings, while writes
        issued after the bump carry the new epoch and pass.  Unlike
        ``promote()`` there is no §4.2 sweep and no reconnect: the membership
        and the data are untouched, only the write generation moves."""
        self.epoch += 1
        for r, is_down in zip(self.replicas, self.down):
            if is_down:
                continue
            r.set_epoch(self.epoch)
            r.transport.revoke_epochs_below(self.epoch)
        return self.epoch

    # ---------------------------------------------------------------- repair
    def heal(self, joiner_factory: Callable[[int], ErdaClient]) -> Dict[str, int]:
        """Repair every failed member.  Intact (un-wiped) down members
        crash-restart in place: §4.2 recovery scan + reconnect.  Wiped
        members and slots evicted by a promotion are rebuilt fresh:
        ``joiner_factory(slot)`` provides a connected empty replica, which is
        resynced from the primary's log and installed under the current
        epoch.  The primary must be up (promote first after a primary
        loss)."""
        if self.down[0]:
            raise ShardDownError(self.shard_id,
                                 "promote a backup before healing")
        stats: Dict[str, int] = {}
        n_backup = 0
        for i in range(1, len(self.replicas)):
            if not self.down[i]:
                continue
            if self.wiped[i]:
                joiner = joiner_factory(i)
                stats["resynced"] = stats.get("resynced", 0) + \
                    self._resync_into(joiner)
                self._install(joiner, i)
            else:
                for k, v in self.replicas[i].server.recover().items():
                    stats[f"backup_{k}"] = stats.get(f"backup_{k}", 0) + v
                self.replicas[i].reconnect()
                self.replicas[i].set_epoch(self.epoch)
                self.replicas[i].transport.revoke_epochs_below(self.epoch)
                self.down[i] = False
                n_backup += 1
        while len(self.replicas) < self.replication:
            slot = len(self.replicas)
            joiner = joiner_factory(slot)
            stats["resynced"] = stats.get("resynced", 0) + \
                self._resync_into(joiner)
            self.replicas.append(joiner)
            self.down.append(False)
            self.wiped.append(False)
            self.replica_hosts.append(None)
            self._stamp(joiner)
        if n_backup:
            stats["backups_restarted"] = n_backup
        return stats

    def _stamp(self, joiner: ErdaClient) -> None:
        joiner.set_epoch(self.epoch)
        joiner.transport.revoke_epochs_below(self.epoch)

    def _install(self, joiner: ErdaClient, slot: int) -> None:
        self._retired_stale_rejected += getattr(
            self.replicas[slot].transport, "stale_rejected", 0)
        self.replicas[slot] = joiner
        self.down[slot] = False
        self.wiped[slot] = False
        self._stamp(joiner)

    def _resync_into(self, joiner: ErdaClient,
                     batch: int = RESYNC_BATCH) -> int:
        """Stream every live object of the primary into an (empty) joiner —
        batched one-sided reads from the primary, batched writes into the
        joiner.  The key list comes from the migration-aware resync scan
        (``live_resync_keys``): tombstoned keys and dead record versions are
        skipped BEFORE any verb is posted, so resync never spends one-sided
        reads fetching garbage it would only throw away (missing = deleted on
        a fresh replica)."""
        keys, scan = live_resync_keys(self.primary.server)
        self.last_resync_scan = scan
        n = 0
        for i in range(0, len(keys), batch):
            chunk = keys[i:i + batch]
            vals = self.primary.multi_read(chunk)
            live = [(k, v) for k, v in zip(chunk, vals) if v is not None]
            if live:
                joiner.multi_write(live)
                n += len(live)
        return n

    def resync_backup(self, joiner: ErdaClient,
                      batch: int = RESYNC_BATCH) -> int:
        """Resync ``joiner`` from the primary and install it as a backup —
        into the first empty/wiped backup slot, else appended.  Returns the
        number of objects resynced."""
        if self.down[0]:
            raise ShardDownError(self.shard_id)
        n = self._resync_into(joiner, batch)
        for i in range(1, len(self.replicas)):
            if self.down[i] and self.wiped[i]:
                self._install(joiner, i)
                return n
        self.replicas.append(joiner)
        self.down.append(False)
        self.wiped.append(False)
        self.replica_hosts.append(None)
        self._stamp(joiner)
        return n

    # -------------------------------------------------------------- read path
    def read(self, key: int) -> Optional[bytes]:
        if not self.down[0]:
            return self.primary.read(key)
        return self._quorum_read([key])[0]

    def multi_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        if not self.down[0]:
            return self.primary.multi_read(keys)
        return self._quorum_read(keys)

    def _quorum_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """Degraded read while the primary is down: the same one-sided read
        batch on R live backups' own QPs (lanes overlap in the DES — the
        degraded read costs about one healthy read, not R), values
        cross-checked.  Every acked write is on every live member, so any
        disagreement is an un-acked tail; the most senior live backup — the
        next promotion target — wins, which keeps the answer consistent with
        a subsequent failover."""
        live = [r for r, d in zip(self.backups, self.down[1:]) if not d]
        need = self.read_quorum
        if len(live) < need:
            raise ShardDownError(
                self.shard_id,
                f"read quorum lost ({len(live)} live backups < "
                f"{need} required)")
        lanes = [c.multi_read(keys) for c in live[:need]]
        self.degraded_reads += len(keys)
        senior = lanes[0]
        for other in lanes[1:]:
            for i, (a, b) in enumerate(zip(senior, other)):
                if a != b:
                    self.quorum_read_conflicts += 1
        return senior

    # ------------------------------------------------------------- write path
    def write(self, key: int, value: bytes) -> None:
        self._check_writable()
        live = self._live()
        if len(live) == 1:
            return self.primary.write(key, value)
        self._mirrored_multi_write([(key, value)], live)

    def delete(self, key: int) -> None:
        self._check_writable()
        live = self._live()
        if len(live) == 1:
            return self.primary.delete(key)
        self._mirrored_multi_write([(key, None)], live)

    def multi_write(self, items: Sequence[Tuple[int, bytes]]) -> None:
        self._check_writable()
        live = self._live()
        if len(live) == 1:
            return self.primary.multi_write(items)
        self._mirrored_multi_write(items, live)

    def _mirrored_multi_write(
            self, items: Sequence[Tuple[int, Optional[bytes]]],
            replicas: Sequence[ErdaClient]) -> None:
        """k writes (value None = delete) mirrored to every live replica:
        all lanes ride the SAME batch scopes — all flips on one doorbell per
        lane, a fence, all data writes on a second doorbell per lane.
        Functionally acknowledged (returns) once every lane's completions
        drained; the DES prices the ack at the write-QUORUM-th lane
        (``netsim.pricing.quorum_times_s``) since the slower minority only
        has to catch up before it can serve."""
        # client-local cleaning views (no server reach-through): any
        # replica's cleaner switches the whole mirrored batch to send
        if any(c.is_cleaning(k) for c in replicas for k, _ in items):
            # §4.4 send path on some replica: correctness over amortization
            # on the rare path — sequential mirrored blocking writes
            for key, value in items:
                for c in replicas:
                    if value is None:
                        c.delete(key)
                    else:
                        c.write(key, value)
            return
        legs = []
        with ExitStack() as stack:
            batches = [stack.enter_context(c.transport.batch())
                       for c in replicas]
            for key, value in items:
                delete = value is None
                rec = layout.pack_record(key, value, delete=delete)
                n = 0 if delete else len(value)
                hs = []
                for c in replicas:
                    c.stats["writes"] += 1
                    hs.append(c.post_write_req(key, n, delete=delete))
                legs.append((key, rec, delete, hs))
            for b in batches:
                b.fence()  # flips complete: data-write addresses in hand
            for key, rec, delete, hs in legs:
                for c, h in zip(replicas, hs):
                    c.post_data_write(h.result[0], rec)
        for c in replicas:
            c.transport.poll(c.qp)
        for key, _rec, delete, hs in legs:
            for c, h in zip(replicas, hs):
                c.finish_write(key, *h.result, delete=delete)

    # --------------------------------------------------- split-brain helper
    def begin_partitioned_write(self, key: int, value: bytes) -> InFlightWrite:
        """Start a mirrored write and stop at the partition point: the
        metadata flips ring (they were delivered before the cut), the data
        writes are posted on every lane with the doorbells UN-RUNG — exactly
        the WQE state a coordinator cut off mid-write leaves behind.  The
        returned ``InFlightWrite.ring()`` delivers them later; after a
        ``promote()`` every surviving lane rejects them with the stale
        epoch.  (The flips the survivors DID apply leave torn-NEW entries,
        which the promotion's §4.2 sweep repairs back to OLD.)"""
        self._check_writable()
        live = self._live()
        rec = layout.pack_record(key, value)
        lanes = []
        for c in live:
            batch = c.transport.batch().__enter__()
            c.stats["writes"] += 1
            h = c.post_write_req(key, len(value))
            batch.fence()  # the flip was delivered before the partition
            addr = h.result[0]
            hd = c.post_data_write(addr, rec)
            lanes.append((c, batch, hd))
        return InFlightWrite(key, value, self.write_quorum, lanes)
