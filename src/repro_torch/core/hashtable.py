"""NVM-resident hopscotch hash table holding Erda metadata (paper Fig 6).

Entry layout (24 B, 8-byte aligned so the atomic word is a real u64 slot):

    [ key: u64 | atomic_word: u64 | head_id: u8 | state: u8 | pad: 6 ]

``atomic_word`` is the paper's 8-byte atomic write region
{1b new_tag | 31b off_A | 31b off_B | 1b rsvd}; *every* metadata update the
steady-state write path performs goes through exactly one atomic u64 store of
this word (flip bit + one 31-bit offset region — DCW skips the rest).

Hopscotch hashing [10] with neighborhood H=8: a key lives within H slots of its
home bucket; inserts displace ("hop") entries backward to keep that invariant.
The paper picks hopscotch because a key-value pair stays in one small
contiguous region — a single one-sided RDMA read of H entries suffices for a
client-side lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

from repro_torch.core.layout import NULL_OFF, pack_word
from repro_torch.nvmsim.device import NVMDevice

ENTRY_SIZE = 24
STATE_EMPTY = 0
STATE_VALID = 1
H = 8                 # hopscotch neighborhood
ADD_RANGE = 256       # linear-probe range before resize is required


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


@dataclasses.dataclass
class Entry:
    slot: int
    key: int
    word: int
    head_id: int
    state: int


class HopscotchTable:
    def __init__(self, device: NVMDevice, capacity: int):
        self.dev = device
        self.capacity = int(capacity)
        self.base = device.alloc(self.capacity * ENTRY_SIZE, align=8)
        self.n_items = 0

    # ------------------------------------------------------------- low level
    def _addr(self, slot: int) -> int:
        return self.base + (slot % self.capacity) * ENTRY_SIZE

    def read_entry(self, slot: int) -> Entry:
        a = self._addr(slot)
        raw = self.dev.read(a, ENTRY_SIZE)
        key = int(raw[0:8].view("<u8")[0])
        word = int(raw[8:16].view("<u8")[0])
        return Entry(slot % self.capacity, key, word, int(raw[16]), int(raw[17]))

    def _write_body(self, slot: int, key: int, head_id: int, state: int) -> None:
        """Non-atomic part of an entry (create-time only)."""
        a = self._addr(slot)
        import struct
        self.dev.write(a, struct.pack("<Q", key))
        self.dev.write(a + 16, bytes([head_id & 0xFF, state & 0xFF]))

    def write_word(self, slot: int, word: int) -> None:
        """THE paper mechanism: single 8-byte atomic store publishing an update."""
        self.dev.write_u64_atomic(self._addr(slot) + 8, word)

    def read_word(self, slot: int) -> int:
        return self.dev.read_u64(self._addr(slot) + 8)

    # ------------------------------------------------------------ operations
    def home(self, key: int) -> int:
        return splitmix64(key) % self.capacity

    def lookup(self, key: int) -> Optional[Entry]:
        h = self.home(key)
        for i in range(H):
            e = self.read_entry(h + i)
            if e.state == STATE_VALID and e.key == key:
                return e
        return None

    def neighborhood_addr(self, key: int) -> Tuple[int, int]:
        """(addr, nbytes) of the neighborhood — what a client's one-sided read
        of the metadata fetches (wraps are split into one read in the sim)."""
        return self._addr(self.home(key)), H * ENTRY_SIZE

    def insert(self, key: int, head_id: int, off_new: int) -> Entry:
        if self.lookup(key) is not None:
            raise KeyError(f"duplicate key {key}")
        for _ in range(8):
            try:
                return self._insert(key, head_id, off_new)
            except MemoryError:
                self._resize()
        raise MemoryError("hopscotch: resize loop failed")

    def _resize(self) -> None:
        """Displacement failed (clustering / high load): double the table.
        A real deployment would re-register the region and refresh clients'
        geometry RCU-style; here the server owns the only geometry handle."""
        entries = list(self.iter_valid())
        self.capacity *= 2
        self.base = self.dev.alloc(self.capacity * ENTRY_SIZE, align=8)
        self.n_items = 0
        for e in entries:
            self._insert(e.key, e.head_id, 0)
            slot = self.lookup(e.key).slot
            self.write_word(slot, e.word)  # preserve words verbatim

    def _insert(self, key: int, head_id: int, off_new: int) -> Entry:
        h = self.home(key)
        free = None
        for i in range(ADD_RANGE):
            e = self.read_entry(h + i)
            if e.state == STATE_EMPTY:
                free = h + i
                break
        if free is None:
            raise MemoryError("hopscotch: no free slot in add range (resize needed)")
        # hop the free slot back into the neighborhood
        while free - h >= H:
            moved = False
            for j in range(free - H + 1, free):
                cand = self.read_entry(j)
                if cand.state != STATE_VALID:
                    continue
                cand_home = self.home(cand.key)
                dist = (free - cand_home) % self.capacity
                if dist < H:  # candidate may legally live at `free`
                    self._write_body(free, cand.key, cand.head_id, STATE_VALID)
                    self.write_word(free % self.capacity, cand.word)
                    self._write_body(j, 0, 0, STATE_EMPTY)
                    self.write_word(j % self.capacity, 0)
                    free = j
                    moved = True
                    break
            if not moved:
                raise MemoryError("hopscotch: displacement failed (table too full)")
        word = pack_word(1, off_new, NULL_OFF)
        # crash ordering: body first, word (the publish) last + atomically
        self._write_body(free, key, head_id, STATE_VALID)
        self.write_word(free % self.capacity, word)
        self.n_items += 1
        return self.read_entry(free)

    def remove(self, slot: int) -> None:
        self._write_body(slot, 0, 0, STATE_EMPTY)
        self.write_word(slot, 0)
        self.n_items -= 1

    def iter_valid(self) -> Iterator[Entry]:
        for s in range(self.capacity):
            e = self.read_entry(s)
            if e.state == STATE_VALID:
                yield e
