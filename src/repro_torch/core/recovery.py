"""Server crash recovery (paper §4.2).

After a failure, the server must fix entries whose NEW offset points at a
record that never became fully durable (the client's one-sided write was cut
off at the NIC cache).  The paper scans the last segment following each head;
we additionally rebuild the volatile per-head record index (needed by the
cleaner) with a CRC-resynchronizing forward scan of the whole chain — records
are 8-byte aligned, and the CRC plus the fixed key length make false record
boundaries vanishingly unlikely.

For every valid table entry of the head:
  * NEW offset parses + CRC-verifies + key matches  → nothing to do;
  * NEW bad, OLD good  → one atomic store makes OLD current (flip-back);
  * both bad (torn create) → the entry is removed: the object never existed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import layout


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _tail_after_scan(dev, region, last_valid_end: int) -> int:
    """Recovered tail for the head's tail region: never before the end of the
    last valid record the scan found there, and never inside a torn hole.

    A cut-off one-sided write leaves a partially-persisted record (the hole)
    at the old tail; placing the tail at the last *valid* record's end would
    let post-recovery writes land inside bytes a torn write touched — and a
    miscounted scan would even overwrite surviving records.  The region is
    bump-allocated (fresh NVM is zero), so the dirty extent = everything up to
    the last nonzero byte; the tail goes past it, 8-aligned.  Trailing zeros
    of a *valid* record are covered by ``last_valid_end``; trailing zeros of a
    torn record are indistinguishable from free space and safe to reuse."""
    seg = dev.mem[last_valid_end:region.end]
    nz = np.flatnonzero(seg)
    dirty_end = last_valid_end + _align8(int(nz[-1]) + 1) if nz.size else last_valid_end
    return min(max(last_valid_end, dirty_end), region.end)


def recover_server(server) -> Dict[str, int]:
    stats = {"valid_records": 0, "repaired": 0, "removed": 0, "heads": 0}
    dev = server.dev
    # any in-flight cleaning is abandoned: Region 1 + un-flipped tags are
    # authoritative; orphaned Region-2 bytes persist harmlessly (old versions).
    # abandon_cleaning pushes a cleaning-epoch update so subscribed clients
    # leave the §4.4 send path (and purge location hints for those heads).
    server.abandon_cleaning()

    for head in server.log.heads.values():
        stats["heads"] += 1
        head.cleaning = False
        head.index = []
        for region in head.regions:
            off = region.start
            last_valid_end = region.start  # end of last valid record HERE
            while off + layout.HEADER_SIZE <= region.end:
                rec = layout.parse_record(dev.mem, off, max_len=region.end - off)
                if rec.ok:
                    head.index.append(_mkref(off, rec))
                    stats["valid_records"] += 1
                    off += _align8(rec.size)
                    last_valid_end = off
                else:
                    off += 8  # resync scan
        # the tail lives in the LAST region of the chain; `last_valid_end`
        # now holds that region's last valid record end
        head.tail = _tail_after_scan(dev, head.regions[-1], last_valid_end)

    # repair metadata (the paper's recovery step)
    table = server.table
    for entry in list(table.iter_valid()):
        w = table.read_word(entry.slot)
        tag, off_new, off_old = layout.unpack_word(w)
        new_ok = _version_ok(dev, off_new, entry.key)
        if new_ok:
            continue
        if _version_ok(dev, off_old, entry.key):
            table.write_word(entry.slot, layout.pack_word(tag, off_old, off_old))
            stats["repaired"] += 1
        else:
            table.remove(entry.slot)
            stats["removed"] += 1
    return stats


def _mkref(off: int, rec):
    from repro_torch.core.log import RecordRef
    return RecordRef(off, rec.key, rec.size, rec.deleted)


def _version_ok(dev, off: int, key: int) -> bool:
    if off == layout.NULL_OFF:
        return False
    rec = layout.parse_record(dev.mem, off)
    return rec.ok and rec.key == key
