"""Read After Write baseline (paper §5.1) — the network-dominant scheme.

Write: the client SENDs a request and obtains a ring-buffer slot; pushes the
record with a one-sided RDMA WRITE; then issues a one-sided RDMA READ *after*
the write to force the data out of the volatile NIC cache into persistence
(the extra round-trip this scheme pays).  The server CPU polls the ring and
applies entries to the destination storage (second NVM write).

Read path: identical to Redo Logging (two-sided, CPU-served).

NVM byte counts match Table 1's Redo Logging column (ring write = 4+N,
apply = N, create metadata = Size(key)+8).

Every remote access goes through the injected ``repro_torch.fabric`` transport; see
redo_logging.py.
"""
from __future__ import annotations

import struct
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.baselines.redo_logging import _FlatTable
from repro_torch.fabric.transport import InProcessTransport, WorkRequest
from repro_torch.nvmsim.device import NVMDevice


class ReadAfterWriteStore:
    scheme = "raw"

    def __init__(self, device_size: int = 256 << 20, table_capacity: int = 1 << 16,
                 ring_capacity: int = 32 << 20,
                 transport_factory: Optional[Callable[[NVMDevice], object]] = None):
        self.dev = NVMDevice(device_size)
        self.transport = (transport_factory or InProcessTransport)(self.dev)
        self.table = _FlatTable(self.dev, table_capacity)
        self.ring_base = self.dev.alloc(ring_capacity, align=8)
        self.ring_cap = ring_capacity
        self.ring_tail = self.ring_base
        self.pending: Dict[int, bytes] = {}  # ring entries not yet applied
        self.dest: Dict[int, tuple] = {}
        self._len: Dict[int, int] = {}
        self.stats = {"reads": 0, "writes": 0, "send_ops": 0,
                      "one_sided_writes": 0, "one_sided_reads": 0, "applies": 0}

    # ------------------------------------------------------------------ write
    def _entry_for(self, key: int, value: bytes) -> bytes:
        kv = struct.pack("<Q", key) + bytes(value)
        return struct.pack("<I", zlib.crc32(kv) & 0xFFFFFFFF) + kv

    def _alloc_srv(self, entry_len: int) -> Callable[[], int]:
        def _alloc():
            if self.ring_tail + entry_len > self.ring_base + self.ring_cap:
                self.ring_tail = self.ring_base
            addr = self.ring_tail
            self.ring_tail += (entry_len + 7) & ~7
            return addr

        return _alloc

    def write(self, key: int, value: bytes) -> None:
        self.stats["writes"] += 1
        self.stats["send_ops"] += 1  # obtain ring-buffer address
        entry = self._entry_for(key, value)
        addr = self.transport.send_recv("raw.alloc", self._alloc_srv(len(entry)))
        # one-sided RDMA write into the ring buffer (NVM write #1: 4+N);
        # persistence is paid for by the forcing read below, not charged here
        self.stats["one_sided_writes"] += 1
        self.transport.one_sided_write(addr, entry, op="raw.ring_push",
                                       persist=False)
        # one-sided RDMA read-after-write forces persistence (no NVM write)
        self.stats["one_sided_reads"] += 1
        self.transport.one_sided_read(addr, len(entry), op="raw.raw_read")
        self.pending[key] = bytes(value)
        self._apply(key, value)  # server poll + apply (async in time)
        self.transport.server_async("raw.apply", len(entry) - 4)

    def multi_write(self, items: Sequence[Tuple[int, bytes]]) -> None:
        """Batched RAW write: one doorbell for all k slot allocations, a
        fence (pushes need their ring addresses), one doorbell for all k ring
        pushes, then — after a second fence — one doorbell for the forcing
        reads.  The push/read fence keeps the batched path priced exactly
        like the sequential write at batch=1 (push doorbell, then read
        doorbell), so the benchmark's amortized ratio measures batching
        alone, not a doorbell-pairing saving the sequential path never gets."""
        allocs = []
        with self.transport.batch() as b:
            for key, value in items:
                self.stats["writes"] += 1
                self.stats["send_ops"] += 1
                entry = self._entry_for(key, value)
                allocs.append((key, value, entry, self.transport.post(
                    WorkRequest("send_recv", op="raw.alloc",
                                handler=self._alloc_srv(len(entry))))))
            b.fence()  # ring addresses must be in hand before the pushes
            for key, _value, entry, h in allocs:
                self.stats["one_sided_writes"] += 1
                self.transport.post(WorkRequest(
                    "one_sided_write", op="raw.ring_push", addr=h.result,
                    data=entry, persist=False))
            b.fence()  # forcing reads ride their own doorbell, as sequentially
            for key, _value, entry, h in allocs:
                self.stats["one_sided_reads"] += 1
                self.transport.post(WorkRequest(
                    "one_sided_read", op="raw.raw_read", addr=h.result,
                    nbytes=len(entry)))
        self.transport.poll()
        for key, value, entry, _h in allocs:
            self.pending[key] = bytes(value)
            self._apply(key, value)
            self.transport.server_async("raw.apply", len(entry) - 4)

    def _apply(self, key: int, value: bytes) -> None:
        self.stats["applies"] += 1
        kv = struct.pack("<Q", key) + bytes(value)
        slab = self.dest.get(key)
        if slab is None or slab[1] < len(kv):
            addr = self.dev.alloc(max(len(kv), 16), align=8)
            self.dest[key] = (addr, max(len(kv), 16))
            self.table.put(key, addr)  # create metadata: Size(key)+8
        addr, _cap = self.dest[key]
        self.dev.write(addr, kv)  # NVM write #2: N bytes
        self._len[key] = len(kv)
        self.pending.pop(key, None)

    # ------------------------------------------------------------------- read
    def _read_srv(self, key: int) -> Callable[[], Optional[bytes]]:
        def _srv():
            if key in self.pending:
                return self.pending[key]
            if self.table.get(key) is None:
                return None
            addr, _cap = self.dest[key]
            kv = self.dev.read(addr, self._len[key]).tobytes()
            return kv[8:]

        return _srv

    def read(self, key: int) -> Optional[bytes]:
        self.stats["reads"] += 1
        self.stats["send_ops"] += 1
        return self.transport.send_recv("raw.read", self._read_srv(key))

    def multi_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """k read RPCs on one doorbell (read path is identical to redo's)."""
        handles = []
        with self.transport.batch():
            for key in keys:
                self.stats["reads"] += 1
                self.stats["send_ops"] += 1
                handles.append(self.transport.post(
                    WorkRequest("send_recv", op="raw.read",
                                handler=self._read_srv(key))))
        self.transport.poll()
        return [h.result for h in handles]

    # ------------------------------------------------------------------ delete
    def delete(self, key: int) -> None:
        self.stats["writes"] += 1
        self.stats["send_ops"] += 1

        def _srv():
            self.table.clear(key)
            self.dest.pop(key, None)
            self.pending.pop(key, None)
            self._len.pop(key, None)

        self.transport.send_recv("raw.delete", _srv)
