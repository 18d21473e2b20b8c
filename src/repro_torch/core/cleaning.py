"""Lock-free log cleaning (paper §4.4, Figs 9-13).

Two phases, concurrent with client reads/writes:

  MERGE       — reverse scan of Region 1 from the tail at cleaning start;
                first-encountered (= latest) version per key is copied to
                Region 2 and the entry's OLD offset region is updated — the
                new tag is NOT flipped.  Client ops switch to RDMA send;
                client writes still append to Region 1 (NEW offset region
                updated in place, no flip).  Deleted objects are dropped.
  REPLICATION — records written to Region 1 after merge start are copied into
                a replication area reserved at the Region-2 tail.  Client
                writes now append to Region 2 *after* the reserved area and
                update the OLD offset region.  The copy is skipped when the
                entry's old offset already exceeds the reserved area's end —
                a client wrote a newer version during replication (paper's
                offset-comparison rule).
  FINISH      — head pointer swings Region 1 → Region 2, every entry of the
                head gets its new tag flipped (one atomic store each: the OLD
                region, which now holds the Region-2 offset, becomes NEW),
                entries whose latest version is a delete are removed, clients
                are told cleaning is over.

Crash safety: Region 1 and the un-flipped tags stay authoritative until
FINISH, so a crash mid-cleaning simply discards Region 2 (stale old-offsets
pointing into Region 2 are still valid full records of *previous* versions —
exactly what the old slot is for).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core import layout
from repro_torch.core.log import Head, Region, RecordRef


def _align8(n: int) -> int:
    return (n + 7) & ~7


def live_resync_keys(server, key_filter: Optional[Callable[[int], bool]] = None
                     ) -> Tuple[List[int], Dict[str, int]]:
    """Migration-aware resync scan: the live keys of one server, with a
    census of the garbage skipped.

    Every resync path (replica heal, slice migration) should copy only the
    LATEST live version of each key — never tombstoned keys, never
    superseded record versions.  This reuses the cleaner's MERGE idiom: a
    reverse scan of each head's record index where the first-encountered
    (= latest) version per key wins, a latest-version tombstone drops the
    key, and unindexed/superseded records are overlooked.  ``key_filter``
    restricts the scan to a keyspace slice (online resharding migrates one
    slice at a time).

    Returns ``(keys, stats)`` where stats counts ``live``,
    ``skipped_tombstones`` (latest version is a delete) and ``skipped_dead``
    (superseded versions and table-evicted records) — the verb census that
    proves garbage is neither read nor copied."""
    stats = {"live": 0, "skipped_tombstones": 0, "skipped_dead": 0}
    keys: List[int] = []
    table = server.table
    for head in server.log.heads.values():
        seen: Set[int] = set()
        for ref in reversed(head.index):
            if key_filter is not None and not key_filter(ref.key):
                continue
            if ref.key in seen:
                stats["skipped_dead"] += 1
                continue
            seen.add(ref.key)
            if ref.deleted:
                stats["skipped_tombstones"] += 1
                continue
            if table.lookup(ref.key) is None:
                stats["skipped_dead"] += 1
                continue
            keys.append(ref.key)
            stats["live"] += 1
    return keys, stats


def sweep_server(server, *, force: bool = False) -> int:
    """Run the cleaner to completion over every head of one server.

    ``force=False`` honours the occupancy threshold (``maybe_start_cleaning``);
    ``force=True`` cleans every head not already being cleaned.  Returns the
    number of heads cleaned — the single sweep used by both the single-server
    store facade and the cluster's cross-shard coordination."""
    cleaned = 0
    for head_id in list(server.log.heads):
        if force:
            if head_id in server.cleaners:
                continue
            server.start_cleaning(head_id).run_to_completion()
            cleaned += 1
        else:
            c = server.maybe_start_cleaning(head_id)
            if c is not None:
                c.run_to_completion()
                cleaned += 1
    return cleaned


class Cleaner:
    def __init__(self, server, head: Head):
        self.server = server
        self.head = head
        self.phase = "idle"
        self.deleted_keys: Set[int] = set()

    # ------------------------------------------------------------------ start
    def start(self) -> None:
        dev = self.server.dev
        self.merge_start_len = len(self.head.index)
        self.r2 = Region(dev.alloc(self.head.region_size, align=8), self.head.region_size)
        self.r2_tail = self.r2.start
        self.r2_index: List[RecordRef] = []
        self.seen: Set[int] = set()
        self.merge_pos = self.merge_start_len - 1
        self.head.cleaning = True
        self.phase = "merge"

    def _r2_reserve(self, size: int) -> int:
        addr = self.r2_tail
        if addr + size > self.r2.end:
            raise MemoryError("Region 2 exhausted during cleaning")
        self.r2_tail += _align8(size)
        return addr

    # ------------------------------------------------------------------ driver
    def step(self, budget: int = 64) -> bool:
        """Process up to `budget` records; returns True while work remains."""
        if self.phase == "merge":
            self._step_merge(budget)
            return True
        if self.phase == "replicate":
            return self._step_replicate(budget)
        return False

    def run_to_completion(self) -> None:
        while self.step(1 << 30):
            pass

    # ------------------------------------------------------------------ merge
    def _step_merge(self, budget: int) -> None:
        table = self.server.table
        dev = self.server.dev
        while budget > 0 and self.merge_pos >= 0:
            ref = self.head.index[self.merge_pos]
            self.merge_pos -= 1
            if ref.key in self.seen:
                continue  # stale version — "simply overlooks it"
            self.seen.add(ref.key)
            budget -= 1
            entry = table.lookup(ref.key)
            if entry is None:
                continue
            if ref.deleted:
                self.deleted_keys.add(ref.key)
                continue  # deleted objects are removed by not copying them
            rec = dev.read(ref.offset, ref.size)
            addr = self._r2_reserve(ref.size)
            dev.write(addr, rec)
            self.r2_index.append(RecordRef(addr, ref.key, ref.size, False))
            w = table.read_word(entry.slot)
            tag, off_new, _off_old = layout.unpack_word(w)
            table.write_word(entry.slot, layout.pack_word(tag, off_new, addr))
        if self.merge_pos < 0:
            self._begin_replication()

    def _begin_replication(self) -> None:
        self.repl_set = list(self.head.index[self.merge_start_len :])
        reserved = sum(_align8(r.size) for r in self.repl_set)
        self.repl_tail = self.r2_tail
        self.repl_end = self.r2_tail + reserved
        if self.repl_end > self.r2.end:
            raise MemoryError("Region 2 exhausted reserving replication area")
        self.client_tail = self.repl_end  # client writes land after the reserve
        self.repl_pos = len(self.repl_set) - 1
        self.repl_seen: Set[int] = set()
        self.r2_tail = self.repl_end
        self.phase = "replicate"

    # ------------------------------------------------------------- replication
    def _step_replicate(self, budget: int) -> bool:
        table = self.server.table
        dev = self.server.dev
        while budget > 0 and self.repl_pos >= 0:
            ref = self.repl_set[self.repl_pos]
            self.repl_pos -= 1
            if ref.key in self.repl_seen:
                continue
            self.repl_seen.add(ref.key)
            budget -= 1
            entry = table.lookup(ref.key)
            if entry is None:
                continue
            w = table.read_word(entry.slot)
            tag, off_new, off_old = layout.unpack_word(w)
            if off_old != layout.NULL_OFF and off_old >= self.repl_end:
                continue  # a client already wrote a newer version into Region 2
            if ref.deleted:
                self.deleted_keys.add(ref.key)
                continue
            self.deleted_keys.discard(ref.key)
            rec = dev.read(ref.offset, ref.size)
            addr = self.repl_tail
            self.repl_tail += _align8(ref.size)
            dev.write(addr, rec)
            self.r2_index.append(RecordRef(addr, ref.key, ref.size, False))
            table.write_word(entry.slot, layout.pack_word(tag, off_new, addr))
        if self.repl_pos < 0:
            self._finish()
            return False
        return True

    # ------------------------------------------------------------------ client ops during cleaning
    def client_write_addr(self, key: int, val_len: int, *, delete: bool = False) -> Tuple[int, int, int]:
        """Server-mediated write while cleaning (clients switched to send).
        Returns (addr, size, word) like ``handle_write_req`` — but mid-cleaning
        words are NOT speculation-safe (the replicate phase parks the latest
        version at the OLD offset, and FINISH flips every word), so the client
        drops rather than caches them."""
        table = self.server.table
        size = layout.record_size(val_len, delete=delete)
        if self.phase == "merge":
            addr = self.head.reserve(size)  # still Region 1
            entry = table.lookup(key)
            if entry is None:
                if delete:
                    raise KeyError(f"delete of missing key {key}")
                table.insert(key, self.head.head_id, addr)
                word = layout.pack_word(1, addr, layout.NULL_OFF)
            else:
                w = table.read_word(entry.slot)
                tag, _off_new, off_old = layout.unpack_word(w)
                # update NEW offset region in place; tag NOT flipped (§4.4)
                word = layout.pack_word(tag, addr, off_old)
                table.write_word(entry.slot, word)
            self.head.record_written(addr, key, size, delete)
        else:  # replicate: append to Region 2 after the reserved area
            addr = self.client_tail
            if addr + size > self.r2.end:
                raise MemoryError("Region 2 exhausted during cleaning")
            self.client_tail += _align8(size)
            entry = table.lookup(key)
            if entry is None:
                if delete:
                    raise KeyError(f"delete of missing key {key}")
                # create during replication: both regions point at the record so
                # the finish-time flip leaves NEW valid (see DESIGN.md)
                table.insert(key, self.head.head_id, addr)
                e = table.lookup(key)
                word = layout.pack_word(1, addr, addr)
                table.write_word(e.slot, word)
            else:
                w = table.read_word(entry.slot)
                tag, off_new, _off_old = layout.unpack_word(w)
                word = layout.pack_word(tag, off_new, addr)
                table.write_word(entry.slot, word)
            self.r2_index.append(RecordRef(addr, key, size, delete))
            if delete:
                self.deleted_keys.add(key)
            else:
                self.deleted_keys.discard(key)
        return addr, size, word

    def client_read(self, key: int) -> Optional[bytes]:
        table = self.server.table
        dev = self.server.dev
        entry = table.lookup(key)
        if entry is None:
            return None
        w = table.read_word(entry.slot)
        tag, off_new, off_old = layout.unpack_word(w)
        if self.phase == "merge":
            off = off_new  # "the server accesses the new offset region in Region 1"
        else:
            # offset-comparison rule (paper §4.4): old offset beyond the
            # reserved replication area ⇒ written during replication ⇒ latest
            if off_old != layout.NULL_OFF and off_old >= self.repl_end:
                off = off_old
            else:
                off = off_new
        if off == layout.NULL_OFF:
            return None
        rec = layout.parse_record(dev.mem, off)
        if rec.ok and rec.key == key:
            return None if rec.deleted else rec.value
        # fall back to the other version
        other = off_old if off == off_new else off_new
        if other != layout.NULL_OFF:
            rec = layout.parse_record(dev.mem, other)
            if rec.ok and rec.key == key:
                return None if rec.deleted else rec.value
        return None

    # ------------------------------------------------------------------ finish
    def _finish(self) -> None:
        table = self.server.table
        # swing the head pointer Region 1 → Region 2
        self.head.regions = [self.r2]
        self.head.tail = self.client_tail
        self.head.index = sorted(self.r2_index, key=lambda r: r.offset)
        # flip the new tags of every entry belonging to this head (Fig 13)
        for entry in list(table.iter_valid()):
            if entry.head_id != self.head.head_id:
                continue
            if entry.key in self.deleted_keys:
                table.remove(entry.slot)
                continue
            w = table.read_word(entry.slot)
            table.write_word(entry.slot, w ^ (1 << 63))
        self.head.cleaning = False
        self.phase = "done"
        self.server.cleaning_finished(self.head.head_id)
