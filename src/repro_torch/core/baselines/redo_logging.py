"""Redo Logging baseline (paper §5.1 "Comparisons") — the CPU-involvement scheme.

Write: the client SENDs the record; the server appends {CRC32, key-value pair}
to a persistent redo-log region (NVM write #1: 4+N bytes), verifies integrity,
then applies the key-value pair to the destination address (NVM write #2:
N bytes) — the double-NVM-write cost Table 1 charges this scheme for.

Read: SEND; the server first looks in the redo log (recent unapplied writes),
otherwise hash-table → destination read; returns the value.  Both legs consume
server CPU, which is what caps throughput in Figs 18-21.

Metadata: a flat NVM hash table of [key:u64 | dest_addr:u64] entries
(create: Size(key)+8 bytes; delete: zeroing both fields, Size(key)+8).

Every remote access goes through the injected ``repro_torch.fabric`` transport, so
the same code yields functional state (InProcessTransport) or calibrated DES
latency/CPU accounting (SimTransport).
"""
from __future__ import annotations

import struct
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.hashtable import splitmix64
from repro_torch.fabric.transport import InProcessTransport, WorkRequest
from repro_torch.nvmsim.device import NVMDevice

_ENTRY = 16  # key u64 + dest addr u64


class _FlatTable:
    def __init__(self, dev: NVMDevice, capacity: int):
        self.dev = dev
        self.capacity = capacity
        self.base = dev.alloc(capacity * _ENTRY, align=8)

    def _slot(self, key: int) -> Optional[int]:
        h = splitmix64(key) % self.capacity
        for i in range(256):
            s = (h + i) % self.capacity
            raw = self.dev.read(self.base + s * _ENTRY, _ENTRY)
            k = int(raw[0:8].view("<u8")[0])
            a = int(raw[8:16].view("<u8")[0])
            if k == key:
                return s
            if k == 0 and a == 0:
                return -s - 1  # empty slot, encoded
        raise MemoryError("flat table full")

    def get(self, key: int) -> Optional[int]:
        s = self._slot(key)
        if s is None or s < 0:
            return None
        raw = self.dev.read(self.base + s * _ENTRY + 8, 8)
        return int(raw.view("<u8")[0])

    def put(self, key: int, addr: int) -> None:
        s = self._slot(key)
        s = s if s >= 0 else -s - 1
        self.dev.write(self.base + s * _ENTRY, struct.pack("<QQ", key, addr))

    def clear(self, key: int) -> None:
        s = self._slot(key)
        if s is not None and s >= 0:
            self.dev.write(self.base + s * _ENTRY, b"\x00" * _ENTRY)


class RedoLoggingStore:
    scheme = "redo"

    def __init__(self, device_size: int = 256 << 20, table_capacity: int = 1 << 16,
                 redo_capacity: int = 32 << 20,
                 transport_factory: Optional[Callable[[NVMDevice], object]] = None):
        self.dev = NVMDevice(device_size)
        self.transport = (transport_factory or InProcessTransport)(self.dev)
        self.table = _FlatTable(self.dev, table_capacity)
        self.redo_base = self.dev.alloc(redo_capacity, align=8)
        self.redo_cap = redo_capacity
        self.redo_tail = self.redo_base
        self.redo_index: Dict[int, bytes] = {}  # unapplied entries (volatile)
        self.dest: Dict[int, tuple] = {}        # key -> (addr, capacity) slabs
        self._len: Dict[int, int] = {}
        self.stats = {"reads": 0, "writes": 0, "send_ops": 0, "applies": 0}

    # ------------------------------------------------------------------ write
    def _write_wr(self, key: int, value: bytes) -> WorkRequest:
        """The SEND carrying one write: both the blocking and the batched
        path post exactly this WR."""
        kv = struct.pack("<Q", key) + bytes(value)  # the key-value pair (N bytes)
        crc = zlib.crc32(kv) & 0xFFFFFFFF
        entry = struct.pack("<I", crc) + kv

        def _srv():
            # NVM write #1: append to the redo log (4 + N bytes)
            if self.redo_tail + len(entry) > self.redo_base + self.redo_cap:
                self.redo_tail = self.redo_base  # ring-style reuse (applied entries)
            self.dev.write(self.redo_tail, entry)
            self.redo_tail += (len(entry) + 7) & ~7
            # server verifies integrity before acknowledging
            assert zlib.crc32(entry[4:]) & 0xFFFFFFFF == crc
            self.redo_index[key] = bytes(value)

        return WorkRequest("send_recv", op="redo.write", handler=_srv,
                           req_bytes=len(kv))

    def write(self, key: int, value: bytes) -> None:
        self.stats["writes"] += 1
        self.stats["send_ops"] += 1
        wr = self._write_wr(key, value)
        self.transport.send_recv(wr.op, wr.handler, req_bytes=wr.req_bytes)
        # async apply to the destination (second NVM write) — CPU load, not
        # client-visible latency (functional state updated synchronously)
        self._apply(key, value)
        self.transport.server_async("redo.apply", len(value) + 8)

    def multi_write(self, items: Sequence[Tuple[int, bytes]]) -> None:
        """All k SENDs posted on one doorbell; the server services each RPC
        individually (two-sided work cannot skip the CPU, only the doorbell
        and the network legs amortize)."""
        with self.transport.batch():
            for key, value in items:
                self.stats["writes"] += 1
                self.stats["send_ops"] += 1
                self.transport.post(self._write_wr(key, value))
        self.transport.poll()
        for key, value in items:
            self._apply(key, value)
            self.transport.server_async("redo.apply", len(value) + 8)

    def _apply(self, key: int, value: bytes) -> None:
        self.stats["applies"] += 1
        kv = struct.pack("<Q", key) + bytes(value)
        slab = self.dest.get(key)
        if slab is None or slab[1] < len(kv):
            addr = self.dev.alloc(max(len(kv), 16), align=8)
            self.dest[key] = (addr, max(len(kv), 16))
            # create: metadata write = key + dest addr (Size(key) + 8 bytes)
            self.table.put(key, addr)
        addr, _cap = self.dest[key]
        # NVM write #2: the key-value pair to the destination (N bytes)
        self.dev.write(addr, kv)
        self._len[key] = len(kv)
        self.redo_index.pop(key, None)

    # ------------------------------------------------------------------- read
    def _read_srv(self, key: int) -> Callable[[], Optional[bytes]]:
        def _srv():
            if key in self.redo_index:  # server first looks in the redo log
                return self.redo_index[key]
            if self.table.get(key) is None:
                return None
            addr, _cap = self.dest[key]
            n = self._len[key]
            kv = self.dev.read(addr, n).tobytes()
            return kv[8:]

        return _srv

    def read(self, key: int) -> Optional[bytes]:
        self.stats["reads"] += 1
        self.stats["send_ops"] += 1
        return self.transport.send_recv("redo.read", self._read_srv(key))

    def multi_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """k read RPCs on one doorbell — each still CPU-serviced per-op."""
        handles = []
        with self.transport.batch():
            for key in keys:
                self.stats["reads"] += 1
                self.stats["send_ops"] += 1
                handles.append(self.transport.post(
                    WorkRequest("send_recv", op="redo.read",
                                handler=self._read_srv(key))))
        self.transport.poll()
        return [h.result for h in handles]

    # ------------------------------------------------------------------ delete
    def delete(self, key: int) -> None:
        self.stats["writes"] += 1
        self.stats["send_ops"] += 1

        def _srv():
            # paper: "sets the metadata in a hash table to 0" (Size(key)+8 bytes)
            self.table.clear(key)
            self.dest.pop(key, None)
            self.redo_index.pop(key, None)
            self._len.pop(key, None)

        self.transport.send_recv("redo.delete", _srv)
