"""Log-structured data regions (paper Figs 4-5).

A head array of fixed addresses links the log data.  Each head links a chain of
continuous memory regions (1 GiB in the paper; configurable — tests scale them
down), each divided into fixed segments (8 MiB in the paper).  Objects never
span segments: if a record does not fit the current segment, the tail skips to
the next segment boundary.  When a region fills, another region is allocated,
registered, and chained under the same head.

The server owns allocation: it maintains the last-written address per head and
hands slots to clients (the write_with_imm leg of the protocol).  A volatile
per-head record index (offset, key, size) supports the cleaner's reverse scan
and recovery; it is rebuilt by a forward scan after a crash, so it carries no
durability obligation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.nvmsim.device import NVMDevice


@dataclasses.dataclass
class Region:
    start: int
    size: int

    @property
    def end(self) -> int:
        return self.start + self.size


@dataclasses.dataclass
class RecordRef:
    offset: int   # absolute NVM address
    key: int
    size: int
    deleted: bool


class Head:
    """One head node: a chain of regions + a bump tail with segment fences."""

    def __init__(self, head_id: int, device: NVMDevice, region_size: int, segment_size: int):
        self.head_id = head_id
        self.dev = device
        self.region_size = region_size
        self.segment_size = segment_size
        self.regions: List[Region] = []
        self.tail: int = 0  # absolute address of the last written address of the log
        self.index: List[RecordRef] = []  # volatile (rebuilt on recovery)
        self.cleaning = False
        self._grow()

    def _grow(self) -> Region:
        start = self.dev.alloc(self.region_size, align=8)
        r = Region(start, self.region_size)
        self.regions.append(r)
        if len(self.regions) == 1:
            self.tail = start
        return r

    def current_region(self) -> Region:
        for r in self.regions:
            if r.start <= self.tail <= r.end:
                return r
        return self.regions[-1]

    def _segment_end(self, addr: int, region: Region) -> int:
        rel = addr - region.start
        seg = rel // self.segment_size
        return region.start + min((seg + 1) * self.segment_size, region.size)

    def reserve(self, size: int) -> int:
        """Allocate `size` bytes at the tail (8-byte aligned so recovery's
        resync scan has fixed stride); never spans a segment (paper §3.3)."""
        if size > self.segment_size:
            raise ValueError(f"record of {size} B exceeds segment size {self.segment_size}")
        size_al = (size + 7) & ~7
        region = self.current_region()
        seg_end = self._segment_end(self.tail, region)
        if self.tail + size_al > seg_end:
            self.tail = seg_end  # skip to next segment boundary
            if self.tail >= region.end:
                region = self._grow()
                self.tail = region.start
            seg_end = self._segment_end(self.tail, region)
            if self.tail + size_al > seg_end:
                raise ValueError("record does not fit a fresh segment")
        addr = self.tail
        self.tail += size_al
        return addr

    def record_written(self, addr: int, key: int, size: int, deleted: bool) -> None:
        self.index.append(RecordRef(addr, key, size, deleted))

    @property
    def used_bytes(self) -> int:
        return sum(r.size for r in self.regions[:-1]) + (self.tail - self.current_region().start)

    def last_segment_range(self) -> Tuple[int, int]:
        region = self.current_region()
        rel = self.tail - region.start
        seg_start = region.start + (rel // self.segment_size) * self.segment_size
        return seg_start, self.tail


def head_id_for_key(key: int, n_heads: int) -> int:
    """The key → head mapping.  Shared by the server's ``LogSpace`` and by
    clients: ``n_heads`` is a connection-time constant (paper §3.3), so a
    client can compute a key's head locally — e.g. to consult its cleaning
    view — without reaching through the server object."""
    from repro_torch.core.hashtable import splitmix64
    return splitmix64(key ^ 0xABCDEF) % n_heads


class LogSpace:
    """The head array + all heads.  Keys are mapped to heads by hash so load
    spreads across heads (the paper distinguishes heads via Head IDs)."""

    def __init__(self, device: NVMDevice, n_heads: int = 4, region_size: int = 4 << 20,
                 segment_size: int = 64 << 10):
        self.dev = device
        self.heads: Dict[int, Head] = {
            h: Head(h, device, region_size, segment_size) for h in range(n_heads)
        }
        self.n_heads = n_heads

    def head_for_key(self, key: int) -> Head:
        return self.heads[head_id_for_key(key, self.n_heads)]

    def head_array(self) -> Dict[int, int]:
        """head_id → first-region pointer; sent to clients at connection
        establishment (paper §3.3)."""
        return {h: hd.regions[0].start for h, hd in self.heads.items()}
