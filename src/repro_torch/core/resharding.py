"""Online resharding — elastic scale-out/scale-in of a live ErdaCluster.

``ErdaCluster.add_shard()`` / ``remove_shard()`` migrate ownership while
clients keep serving.  The unit of migration is a *slice*: one contiguous
interval of the 64-bit hash ring whose owner differs between the old and the
new ring generation.  The ring's minimal-movement property bounds the total
moved keyspace at ~1/n of the ring, and slices migrate ONE AT A TIME so the
blast radius of any step is a single interval.

Per-slice protocol (cutover first, then copy — so readers really do dual-fetch
while the slice is in flight):

  1. **Epoch-fenced cutover.**  The source group's epoch bumps and the old
     epoch's write grant is revoked at every live replica QP (same fencing as
     failover promotion, without the membership change).  A straggler write
     posted against the previous generation bounces with ``StaleEpochError``
     when its doorbell finally rings — it can never ack against the old owner
     after ownership moved.  Location-cache entries for the slice's keys are
     purged surgically on both groups' clients (per-slice, the way cleaning
     epochs purge per-head) — the rest of the cache survives.
  2. **In-flight serving.**  Writes for the slice land on the NEW owner and
     append a ``fresh`` record to the MigrationLog; deletes append a
     *tombstone*.  Reads dual-fetch: new owner first, tombstones answer
     "deleted", otherwise fall back to the old owner's frozen copy.
  3. **Copy.**  The slice's live keys — enumerated by the migration-aware
     resync scan (``live_resync_keys``), which skips tombstoned and dead log
     records instead of copying garbage — stream old→new in bounded batches
     (``step(budget)``), skipping anything the MigrationLog says was
     superseded in flight.
  4. **Done + grace-period cleanup.**  The slice routes to the new owner
     only.  After a grace period (``grace`` later slice completions — the
     IceDB idiom: append-only log, tombstones, merge lock, deferred cleanup),
     the source copies are deleted under the log's merge lock and the slice's
     records are truncated from the log.

``RingGeneration`` versions the ring: the old and new rings coexist while a
migration is in flight, and the cluster consults the generation for routing.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from contextlib import contextmanager
from typing import (Deque, Dict, Iterator, List, Optional, Sequence, Set,
                    Tuple)

from repro_torch.core.cleaning import live_resync_keys
from repro_torch.core.hashtable import splitmix64

U64 = 1 << 64

#: the ring's key→point salt — shared with ``HashRing.shard_for`` so a slice
#: boundary computed here matches the routing decision made there
KEY_SALT = 0x5BD1E995


def key_hash(key: int) -> int:
    """Position of ``key`` on the 64-bit ring (``HashRing`` routes with the
    same hash, so slice membership and shard ownership always agree)."""
    return splitmix64(key ^ KEY_SALT)


class Slice:
    """One contiguous hash interval ``(lo, hi]`` whose owner changes between
    ring generations.  ``wraps=True`` marks the interval through zero:
    ``(lo, 2^64) ∪ [0, hi]``.  State machine: pending → inflight → done."""

    __slots__ = ("slice_id", "lo", "hi", "wraps", "src", "dst", "state")

    def __init__(self, slice_id: int, lo: int, hi: int, wraps: bool,
                 src: int, dst: int):
        self.slice_id = slice_id
        self.lo = lo
        self.hi = hi
        self.wraps = wraps
        self.src = src
        self.dst = dst
        self.state = "pending"

    def contains_hash(self, h: int) -> bool:
        if self.wraps:
            return h > self.lo or h <= self.hi
        return self.lo < h <= self.hi

    def contains_key(self, key: int) -> bool:
        return self.contains_hash(key_hash(key))

    @property
    def span(self) -> int:
        """Width of the interval in hash units (the slice's share of the
        minimal-movement bound)."""
        if self.wraps:
            return (U64 - self.lo - 1) + self.hi + 1
        return self.hi - self.lo

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Slice({self.slice_id}: {self.src}->{self.dst} "
                f"{self.state} span={self.span / U64:.4f})")


def moving_slices(old_ring, new_ring) -> List[Slice]:
    """The intervals whose owner differs between two rings.

    The merged point set of both rings partitions the hash space into
    intervals on which BOTH rings' ownership is constant; an interval moves
    iff the owners differ.  This is exact: a key's owner changes iff its hash
    falls in one of the returned slices (the minimal-movement property the
    ring tests assert)."""
    bounds = sorted(set(old_ring._hashes) | set(new_ring._hashes))
    out: List[Slice] = []
    for i, hi in enumerate(bounds):
        lo = bounds[i - 1] if i else bounds[-1]
        src = old_ring.shard_for_hash(hi)
        dst = new_ring.shard_for_hash(hi)
        if src != dst:
            out.append(Slice(len(out), lo, hi, wraps=(i == 0),
                             src=src, dst=dst))
    return out


class RingGeneration:
    """A versioned ring: the current ring plus, while a migration is in
    flight, the target ring and the moving slices between them.  The cluster
    routes through this object; ``commit()`` swings current→target and bumps
    the version once every slice is done."""

    def __init__(self, ring):
        self.current = ring
        self.version = 0
        self.target = None
        self.slices: List[Slice] = []
        self._his: List[int] = []

    @property
    def migrating(self) -> bool:
        return self.target is not None

    def begin(self, target_ring) -> List[Slice]:
        if self.migrating:
            raise RuntimeError("a ring migration is already in flight")
        self.target = target_ring
        self.slices = moving_slices(self.current, target_ring)
        self._his = [s.hi for s in self.slices]
        return self.slices

    def commit(self) -> None:
        if not self.migrating:
            raise RuntimeError("no ring migration to commit")
        self.current = self.target
        self.target = None
        self.slices = []
        self._his = []
        self.version += 1

    def slice_for_hash(self, h: int) -> Optional[Slice]:
        """The moving slice containing ``h``, or None if that part of the
        keyspace keeps its owner."""
        if not self.slices:
            return None
        i = bisect.bisect_left(self._his, h)
        if i < len(self.slices) and self.slices[i].contains_hash(h):
            return self.slices[i]
        # the wrap-through-zero slice (if it moves) sorts first by hi but
        # also covers the top of the hash space
        if self.slices[0].wraps and self.slices[0].contains_hash(h):
            return self.slices[0]
        return None

    def slice_for_key(self, key: int) -> Optional[Slice]:
        return self.slice_for_hash(key_hash(key))

    @property
    def moved_fraction(self) -> float:
        """Fraction of the keyspace the in-flight migration must move — the
        ring's minimal-movement bound for this membership change."""
        return sum(s.span for s in self.slices) / float(U64)


# --------------------------------------------------------------------------
# MigrationLog — append-only records + tombstones + merge lock + grace-period
# cleanup (the IceDB log idiom applied to slice migration)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class MigrationRecord:
    seq: int
    kind: str          # cutover | copy | fresh | tomb | done | clean
    slice_id: int
    key: Optional[int] = None
    nbytes: int = 0


class MigrationLogLocked(RuntimeError):
    """Raised when truncation is attempted without the merge lock held, or
    the merge lock is taken re-entrantly."""


class MigrationLog:
    """Append-only migration log.

    Record kinds:
      * ``cutover sid``       — slice sid epoch-fenced; writes now route new.
      * ``copy sid key n``    — key's live record copied old→new (n bytes).
      * ``fresh sid key``     — key written at the new owner in flight (its
                                frozen old copy is superseded: never copy it).
      * ``tomb sid key``      — key deleted in flight (tombstone: dual-reads
                                answer None, the copier skips it).
      * ``done sid``          — slice fully copied; routes new-only.
      * ``clean sid key``     — source copy dropped during cleanup.

    Truncation requires the merge lock (``with log.merge_lock(): ...``) and
    only runs for slices whose grace period — ``grace`` later slice
    completions — has elapsed, so a straggling reader of a just-finished
    slice never races the destruction of its source copy."""

    def __init__(self, grace: int = 1):
        self.grace = grace
        self.records: List[MigrationRecord] = []
        self._seq = 0
        self._merge_locked = False
        self.fresh: Dict[int, Set[int]] = {}
        self.tombs: Dict[int, Set[int]] = {}
        self.copied: Dict[int, Set[int]] = {}
        self.done_at: Dict[int, int] = {}
        self.cleaned: Set[int] = set()
        self.bytes_moved = 0
        self.keys_copied = 0
        self.tombstones = 0

    def append(self, kind: str, slice_id: int, key: Optional[int] = None,
               nbytes: int = 0) -> MigrationRecord:
        rec = MigrationRecord(self._seq, kind, slice_id, key, nbytes)
        self._seq += 1
        self.records.append(rec)
        if kind == "fresh":
            self.fresh.setdefault(slice_id, set()).add(key)
            self.tombs.setdefault(slice_id, set()).discard(key)
        elif kind == "tomb":
            self.tombstones += 1
            self.tombs.setdefault(slice_id, set()).add(key)
            self.fresh.setdefault(slice_id, set()).discard(key)
            self.copied.setdefault(slice_id, set()).discard(key)
        elif kind == "copy":
            self.copied.setdefault(slice_id, set()).add(key)
            self.bytes_moved += nbytes
            self.keys_copied += 1
        elif kind == "done":
            self.done_at[slice_id] = rec.seq
        return rec

    def is_tombstoned(self, slice_id: int, key: int) -> bool:
        return key in self.tombs.get(slice_id, ())

    def on_new_owner(self, slice_id: int, key: int) -> bool:
        """True when the new owner definitely holds the key's latest version
        (written fresh or already copied)."""
        return (key in self.fresh.get(slice_id, ())
                or key in self.copied.get(slice_id, ()))

    @contextmanager
    def merge_lock(self) -> Iterator["MigrationLog"]:
        if self._merge_locked:
            raise MigrationLogLocked("merge lock already held")
        self._merge_locked = True
        try:
            yield self
        finally:
            self._merge_locked = False

    def cleanup_due(self) -> List[int]:
        """Done slices whose grace period has elapsed: at least ``grace``
        slices completed after them, and they have not been cleaned yet."""
        out = []
        for sid, at in self.done_at.items():
            if sid in self.cleaned:
                continue
            later = sum(1 for a2 in self.done_at.values() if a2 > at)
            if later >= self.grace:
                out.append(sid)
        return sorted(out)

    def truncate(self, slice_ids: Sequence[int]) -> int:
        """Drop a cleaned slice's records (and per-slice views).  Merge lock
        required — truncation must never race a concurrent cleanup pass."""
        if not self._merge_locked:
            raise MigrationLogLocked("truncate requires the merge lock")
        drop = set(slice_ids)
        before = len(self.records)
        self.records = [r for r in self.records if r.slice_id not in drop]
        for sid in drop:
            self.cleaned.add(sid)
            self.fresh.pop(sid, None)
            self.tombs.pop(sid, None)
            self.copied.pop(sid, None)
        return before - len(self.records)


# --------------------------------------------------------------------------
# Resharding — drives one membership change, slice by slice, in bounded steps
# --------------------------------------------------------------------------

class Resharding:
    """One ``add_shard``/``remove_shard`` operation on a live cluster.

    ``step(budget)`` performs one cutover or up to ``budget`` key copies and
    returns True while work remains, so a serving loop interleaves migration
    with client traffic; ``run_to_completion()`` drains it.  Routing hooks
    (``route``/``read``/``write``/``delete``) are called by the cluster's kv
    ops for keys that land in a moving slice."""

    def __init__(self, cluster, generation: RingGeneration, *,
                 adding: Optional[int] = None, removing: Optional[int] = None,
                 grace: int = 1, batch: int = 32):
        self.cluster = cluster
        self.generation = generation
        self.old_ring = generation.current
        self.new_ring = generation.target
        self.adding = adding
        self.removing = removing
        self.batch = batch
        self.slices = generation.slices
        self.log = MigrationLog(grace=grace)
        self.done = False
        self._idx = 0
        self._pending: Deque[int] = deque()
        self._source_keys: Dict[int, List[int]] = {}
        self.dual_reads = 0
        self.cutovers = 0
        self.cleanup_removed = 0
        self.scan_stats = {"live": 0, "skipped_tombstones": 0,
                           "skipped_dead": 0}

    # ------------------------------------------------------------- routing
    def route(self, key: int) -> Tuple[int, Optional[Slice]]:
        """Effective owner shard for ``key`` plus the in-flight slice
        handling it, if any.  done → new owner; inflight → new owner with
        dual-read/tombstone semantics; pending/stable → old owner."""
        s = self.generation.slice_for_key(key)
        if s is None or s.state == "pending":
            return self.old_ring.shard_for(key), None
        if s.state == "done":
            return s.dst, None
        return s.dst, s

    def read(self, key: int, s: Slice) -> Optional[bytes]:
        """Dual-fetch for an in-flight slice: new owner first; a tombstone
        answers "deleted"; otherwise fall back to the old owner's frozen
        copy."""
        v = self.cluster.groups[s.dst].read(key)
        if v is not None:
            return v
        if self.log.is_tombstoned(s.slice_id, key):
            return None
        self.dual_reads += 1
        return self.cluster.groups[s.src].read(key)

    def write(self, key: int, value: bytes, s: Slice) -> None:
        self.cluster.groups[s.dst].write(key, value)
        self.log.append("fresh", s.slice_id, key)

    def delete(self, key: int, s: Slice) -> None:
        sid = s.slice_id
        if self.log.on_new_owner(sid, key):
            self.cluster.groups[s.dst].delete(key)
        else:
            # preserve delete-of-missing semantics: the key must exist
            # somewhere (old owner's frozen copy) and not already be tombstoned
            if (self.log.is_tombstoned(sid, key)
                    or self.cluster.groups[s.src].read(key) is None):
                raise KeyError(key)
        self.log.append("tomb", sid, key)

    # ----------------------------------------------------------- migration
    def step(self, budget: int = 8) -> bool:
        """One bounded unit of migration work: a slice cutover, or up to
        ``budget`` key copies.  Returns True while work remains."""
        if self.done:
            return False
        if self._idx >= len(self.slices):
            self._finalize()
            return False
        s = self.slices[self._idx]
        if s.state == "pending":
            self._cutover(s)
            return True
        left = budget
        while self._pending and left > 0:
            left -= self._copy_some(s, left)
        if not self._pending:
            s.state = "done"
            self.log.append("done", s.slice_id)
            self._idx += 1
            self._maybe_cleanup()
            if self._idx >= len(self.slices):
                self._finalize()
                return False
        return True

    def run_to_completion(self, budget: int = 256) -> "Resharding":
        while self.step(budget):
            pass
        return self

    def _cutover(self, s: Slice) -> None:
        g_src = self.cluster.groups[s.src]
        g_dst = self.cluster.groups[s.dst]
        if g_src.primary_down:
            raise RuntimeError(
                f"cannot migrate slice {s.slice_id}: source shard {s.src} "
                f"primary is down — failover/recover first")
        # 1. fence the old generation: writes posted before the cutover carry
        #    the previous epoch and bounce (StaleEpochError) when rung
        g_src.bump_epoch()
        # 2. surgical loc_cache purge — only the slice's keys, on both sides
        for g in (g_src, g_dst):
            for c, down in zip(g.replicas, g.down):
                if not down:
                    c.purge_locations(pred=s.contains_key)
        # 3. freeze + enumerate the slice's live keys on the source via the
        #    migration-aware scan (tombstoned/dead log records skipped)
        keys, scan = live_resync_keys(g_src.primary.server,
                                      key_filter=s.contains_key)
        for k, v in scan.items():
            self.scan_stats[k] += v
        self._source_keys[s.slice_id] = list(keys)
        self._pending = deque(keys)
        s.state = "inflight"
        self.log.append("cutover", s.slice_id)
        self.cutovers += 1

    def _copy_some(self, s: Slice, budget: int) -> int:
        """Copy up to ``min(budget, self.batch)`` keys old→new in one batched
        read+write, skipping keys the MigrationLog superseded in flight."""
        sid = s.slice_id
        chunk: List[int] = []
        popped = 0
        while self._pending and len(chunk) < min(budget, self.batch):
            k = self._pending.popleft()
            popped += 1
            if (self.log.is_tombstoned(sid, k)
                    or k in self.log.fresh.get(sid, ())):
                continue  # superseded in flight — copying it would be garbage
            chunk.append(k)
        if chunk:
            vals = self.cluster.groups[s.src].multi_read(chunk)
            live = [(k, v) for k, v in zip(chunk, vals) if v is not None]
            if live:
                self.cluster.groups[s.dst].multi_write(live)
                for k, v in live:
                    self.log.append("copy", sid, k, nbytes=len(v))
        return max(popped, 1)

    def _maybe_cleanup(self, force: bool = False) -> None:
        if force:
            due = sorted(sid for sid in self.log.done_at
                         if sid not in self.log.cleaned)
        else:
            due = self.log.cleanup_due()
        if not due:
            return
        with self.log.merge_lock():
            for sid in due:
                self._cleanup_slice(sid)
            self.log.truncate(due)

    def _cleanup_slice(self, sid: int) -> None:
        """Grace-period cleanup: drop the slice's source copies (mirrored
        tombstones on every source replica — the shard cleaner reclaims the
        log space on its next sweep)."""
        s = self.slices[sid]
        g_src = self.cluster.groups.get(s.src)
        if g_src is None or g_src.primary_down:
            return
        for k in self._source_keys.get(sid, ()):
            try:
                g_src.delete(k)
            except KeyError:
                continue  # already reclaimed (e.g. cleaner ran in between)
            self.cleanup_removed += 1
            self.log.append("clean", sid, k)

    def _finalize(self) -> None:
        if self.done:
            return
        self._maybe_cleanup(force=True)
        self.done = True
        self.cluster._finish_resharding(self)

    # --------------------------------------------------------------- stats
    @property
    def moved_fraction(self) -> float:
        return sum(s.span for s in self.slices) / float(U64)

    def report(self) -> Dict[str, object]:
        return {
            "slices": len(self.slices),
            "cutovers": self.cutovers,
            "dual_reads": self.dual_reads,
            "bytes_moved": self.log.bytes_moved,
            "keys_copied": self.log.keys_copied,
            "tombstones": self.log.tombstones,
            "cleanup_removed": self.cleanup_removed,
            "moved_fraction": self.moved_fraction,
            "scan": dict(self.scan_stats),
            "done": self.done,
        }
