"""Simulated byte-addressable NVM device.

The paper (§5.1) simulates NVM by adding extra write latency to DRAM; we use the
same well-recognized method and additionally meter *write traffic* so that the
paper's Table 1 (NVM write bytes per create/update/delete) can be measured, not
just derived.  The device models:

  * byte-addressable load/store over a flat address space,
  * the 8-byte failure-atomicity unit of the NVM memory bus (``write_u64_atomic``),
  * DCW (data-comparison write [31]) accounting: bits that do not change are not
    programmed, which is why the flip-bit metadata update is cheap,
  * torn writes: a crash during a (non-atomic) write may persist an arbitrary
    prefix of the data — this is the failure Erda's CRC detects,
  * an extra write latency (default 150 ns, as in the paper) for latency models.

The port's copy adds spans (``repro_torch.tracing``): ``nvm.write`` around
``nvm.account`` (the DCW comparison pass and the store it is fused with), and
``nvm.read``, counting bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import tracing


class TornWrite(Exception):
    """Raised when a fault injector tears a write; the prefix was persisted."""

    def __init__(self, addr: int, requested: int, persisted: int):
        super().__init__(f"torn write @0x{addr:x}: {persisted}/{requested} bytes persisted")
        self.addr = addr
        self.requested = requested
        self.persisted = persisted


@dataclasses.dataclass
class FaultInjector:
    """Arms a single torn write: the Nth next non-atomic write persists only a
    fraction of its payload (never tearing inside an 8-byte atomic store, which
    models the memory-bus atomicity unit)."""

    countdown: int = 0  # tear the write issued when countdown hits 0
    fraction: float = 0.5  # fraction of bytes persisted
    armed: bool = False

    def arm(self, countdown: int = 0, fraction: float = 0.5) -> None:
        self.countdown = countdown
        self.fraction = fraction
        self.armed = True

    def check(self, nbytes: int) -> Optional[int]:
        """Returns number of bytes to persist if this write tears, else None."""
        if not self.armed:
            return None
        if self.countdown > 0:
            self.countdown -= 1
            return None
        self.armed = False
        return max(0, min(nbytes - 1, int(nbytes * self.fraction)))


@dataclasses.dataclass
class NVMStats:
    bytes_written: int = 0        # logical bytes issued to the device
    bytes_programmed: int = 0     # bytes whose content actually changed (DCW)
    bits_programmed: int = 0      # bit-granular DCW accounting
    write_ops: int = 0
    atomic_ops: int = 0
    bytes_read: int = 0
    read_ops: int = 0

    def snapshot(self) -> "NVMStats":
        return dataclasses.replace(self)

    def delta(self, since: "NVMStats") -> "NVMStats":
        return NVMStats(
            bytes_written=self.bytes_written - since.bytes_written,
            bytes_programmed=self.bytes_programmed - since.bytes_programmed,
            bits_programmed=self.bits_programmed - since.bits_programmed,
            write_ops=self.write_ops - since.write_ops,
            atomic_ops=self.atomic_ops - since.atomic_ops,
            bytes_read=self.bytes_read - since.bytes_read,
            read_ops=self.read_ops - since.read_ops,
        )


_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
#: bytes a large write's DCW pass XORs at a time (a multiple of 8, so only
#: the last chunk can leave a tail that is not whole 64-bit words)
_DCW_CHUNK = 4 << 20


class NVMDevice:
    """Flat simulated NVM with a bump allocator and write metering."""

    def __init__(
        self,
        size: int,
        *,
        extra_write_latency_ns: float = 150.0,
        write_bandwidth_gbps: float = 2.0,
        read_bandwidth_gbps: float = 10.0,
    ):
        self.size = int(size)
        self.mem = np.zeros(self.size, dtype=np.uint8)
        self.stats = NVMStats()
        self.fault = FaultInjector()
        self.extra_write_latency_ns = extra_write_latency_ns
        self.write_bandwidth_gbps = write_bandwidth_gbps
        self.read_bandwidth_gbps = read_bandwidth_gbps
        self._alloc_ptr = 0

    # ------------------------------------------------------------- allocation
    def alloc(self, nbytes: int, align: int = 8) -> int:
        ptr = (self._alloc_ptr + align - 1) & ~(align - 1)
        if ptr + nbytes > self.size:
            raise MemoryError(f"NVM exhausted: want {nbytes} at {ptr}, size {self.size}")
        self._alloc_ptr = ptr + nbytes
        return ptr

    @property
    def allocated(self) -> int:
        return self._alloc_ptr

    # -------------------------------------------------------------- data path
    def write(self, addr: int, data) -> None:
        """Non-atomic write; may be torn by the fault injector (prefix persists)."""
        with tracing.span("nvm.write") as sp:
            buf = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
            n = buf.size
            sp.add(bytes=n)
            if addr < 0 or addr + n > self.size:
                raise ValueError(f"write out of range: [{addr}, {addr + n}) size={self.size}")
            torn = self.fault.check(n)
            persist = n if torn is None else torn
            with tracing.span("nvm.account"):
                self.stats.bytes_written += n  # logical traffic (what Table 1 counts)
                # DCW, a chunk at a time: XOR old and new bytes once into one
                # scratch buffer, count the changed bytes, popcount the XOR as
                # 64-bit words, then store the new bytes while the chunk is
                # still in cache (the old ones are read first)
                scratch = np.empty(min(persist, _DCW_CHUNK), dtype=np.uint8)
                for lo in range(0, persist, _DCW_CHUNK):
                    hi = min(lo + _DCW_CHUNK, persist)
                    old, x = self.mem[addr + lo : addr + hi], scratch[: hi - lo]
                    np.bitwise_xor(old, buf[lo:hi], out=x)
                    w = x.size & ~7
                    self.stats.bytes_programmed += int(np.count_nonzero(x))
                    self.stats.bits_programmed += int(np.bitwise_count(x[:w].view(np.uint64)).sum())
                    if w < x.size:  # a tail under 8 bytes, by table
                        self.stats.bits_programmed += int(_POPCOUNT[x[w:]].sum())
                    old[...] = buf[lo:hi]
            self.stats.write_ops += 1
        if torn is not None:
            raise TornWrite(addr, n, persist)

    def write_u64_atomic(self, addr: int, value: int) -> None:
        """8-byte failure-atomic store (the NVM atomicity unit, §2.2)."""
        if addr % 8 != 0:
            raise ValueError("atomic u64 store must be 8-byte aligned")
        buf = np.frombuffer(np.uint64(value).tobytes(), dtype=np.uint8)
        old = self.mem[addr : addr + 8]
        changed = old != buf
        self.stats.bytes_written += 8
        self.stats.bytes_programmed += int(changed.sum())
        self.stats.bits_programmed += int(_POPCOUNT[np.bitwise_xor(old, buf)].sum())
        self.stats.write_ops += 1
        self.stats.atomic_ops += 1
        self.mem[addr : addr + 8] = buf  # never torn: hardware guarantee
        np.frombuffer(self.mem.data, dtype=np.uint64)  # noop view sanity

    def read_u64(self, addr: int) -> int:
        self.stats.bytes_read += 8
        self.stats.read_ops += 1
        return int(self.mem[addr : addr + 8].view(np.uint64)[0])

    def read(self, addr: int, nbytes: int) -> np.ndarray:
        if addr < 0 or addr + nbytes > self.size:
            raise ValueError(f"read out of range: [{addr}, {addr + nbytes}) size={self.size}")
        with tracing.span("nvm.read", bytes=nbytes):
            self.stats.bytes_read += nbytes
            self.stats.read_ops += 1
            return self.mem[addr : addr + nbytes].copy()

    # ---------------------------------------------------------- latency model
    def write_latency_s(self, nbytes: int) -> float:
        """150 ns extra write latency (paper default) + bandwidth term."""
        return self.extra_write_latency_ns * 1e-9 + nbytes / (self.write_bandwidth_gbps * 1e9)

    def read_latency_s(self, nbytes: int) -> float:
        return nbytes / (self.read_bandwidth_gbps * 1e9)
