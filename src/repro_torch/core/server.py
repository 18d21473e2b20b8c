"""ErdaServer — the server side of the Erda protocol (paper §3-4).

Steady state, the server CPU touches *only* the write path's metadata step
(write_with_imm → allocate slot at the head's tail → single 8-byte atomic
flip-bit update → return the address).  Reads never involve the server.  That
asymmetry is the paper's entire performance story.

The server also hosts recovery (§4.2) and the lock-free cleaner (§4.4) in
``repro_torch.core.cleaning`` / ``repro_torch.core.recovery``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Optional, Set, Tuple

from repro_torch.core import layout
from repro_torch.core.hashtable import Entry, HopscotchTable
from repro_torch.core.log import Head, LogSpace
from repro_torch.nvmsim.device import NVMDevice


class DataLossError(Exception):
    pass


@dataclasses.dataclass
class ServerConfig:
    device_size: int = 256 << 20
    table_capacity: int = 1 << 16
    n_heads: int = 4
    region_size: int = 4 << 20
    segment_size: int = 64 << 10
    cleaning_threshold: float = 0.75  # fraction of region chain occupancy


class ErdaServer:
    def __init__(self, cfg: ServerConfig = ServerConfig(), device: Optional[NVMDevice] = None):
        self.cfg = cfg
        self.dev = device or NVMDevice(cfg.device_size)
        self.table = HopscotchTable(self.dev, cfg.table_capacity)
        self.log = LogSpace(self.dev, cfg.n_heads, cfg.region_size, cfg.segment_size)
        self.cleaners: Dict[int, "object"] = {}  # head_id -> active Cleaner
        # cleaning-epoch publication (§4.4): clients subscribe at connection
        # establishment and are notified whenever the set of cleaning heads
        # changes, so they never reach through the server to ask
        self.cleaning_epoch = 0
        self._cleaning_subs: Dict[object, Callable[[int, FrozenSet[int]], None]] = {}
        # registration: what one-sided clients may touch (paper §3.3)
        self.registered: Tuple[Tuple[int, int], ...] = ()
        self._register()

    def _register(self) -> None:
        self.registered = ((0, self.dev.size),)

    # --------------------------------------------------------------- write path
    def handle_write_req(self, key: int, val_len: int, *, delete: bool = False) -> Tuple[int, int, int]:
        """write_with_imm handler.  Updates metadata FIRST (one atomic 8-byte
        store), then returns the last-written address for the client's
        one-sided data write (paper Fig 7 order).  Returns (addr, record_size,
        word) — the freshly published hash-table word rides back in the same
        response so the writer can warm its location cache for free."""
        head = self.log.head_for_key(key)
        cleaner = self.cleaners.get(head.head_id)
        if cleaner is not None:
            return cleaner.client_write_addr(key, val_len, delete=delete)
        size = layout.record_size(val_len, delete=delete)
        addr = head.reserve(size)
        entry = self.table.lookup(key)
        if entry is None:
            if delete:
                raise KeyError(f"delete of missing key {key}")
            self.table.insert(key, head.head_id, addr)
            word = layout.pack_word(1, addr, layout.NULL_OFF)
        else:
            word = layout.flip_word(entry.word, addr)
            self.table.write_word(entry.slot, word)
        head.record_written(addr, key, size, delete)
        return addr, size, word

    # --------------------------------------------------------------- repair path
    def handle_repair(self, key: int, observed_word: int) -> None:
        """A client detected a torn NEW version (CRC failure) and read the OLD
        one.  Restore consistency: make the old offset current (paper §4.2:
        "replace the current new offset with the old offset").  One atomic
        store; idempotent; skipped if the entry moved on concurrently."""
        entry = self.table.lookup(key)
        if entry is None or entry.word != observed_word:
            return  # concurrent update already superseded the torn version
        tag, _off_new, off_old = layout.unpack_word(entry.word)
        if off_old == layout.NULL_OFF:
            # torn CREATE: the object never existed consistently — remove it
            self.table.remove(entry.slot)
            return
        self.table.write_word(entry.slot, layout.pack_word(tag, off_old, off_old))

    # --------------------------------------------------------------- read (two-sided; cleaning fallback only)
    def handle_read(self, key: int) -> Optional[bytes]:
        head = self.log.head_for_key(key)
        cleaner = self.cleaners.get(head.head_id)
        if cleaner is not None:
            return cleaner.client_read(key)
        entry = self.table.lookup(key)
        if entry is None:
            return None
        _tag, off_new, off_old = layout.unpack_word(entry.word)
        for off in (off_new, off_old):
            if off == layout.NULL_OFF:
                continue
            rec = layout.parse_record(self.dev.mem, off)
            if rec.ok and rec.key == key:
                return None if rec.deleted else rec.value
        raise DataLossError(f"no consistent version of key {key}")

    # --------------------------------------------------------------- cleaning
    def maybe_start_cleaning(self, head_id: int):
        from repro_torch.core.cleaning import Cleaner
        head = self.log.heads[head_id]
        if head.head_id in self.cleaners:
            return None
        if head.used_bytes < self.cfg.cleaning_threshold * head.region_size * len(head.regions):
            return None
        c = Cleaner(self, head)
        self.cleaners[head.head_id] = c
        c.start()
        self._notify_cleaning()
        return c

    def start_cleaning(self, head_id: int):
        from repro_torch.core.cleaning import Cleaner
        head = self.log.heads[head_id]
        if head.head_id in self.cleaners:
            raise RuntimeError("cleaning already active")
        c = Cleaner(self, head)
        self.cleaners[head.head_id] = c
        c.start()
        self._notify_cleaning()
        return c

    def cleaning_heads(self) -> Set[int]:
        return set(self.cleaners)

    def is_cleaning(self, key: int) -> bool:
        return self.log.head_for_key(key).head_id in self.cleaners

    def cleaning_finished(self, head_id: int) -> None:
        self.cleaners.pop(head_id, None)
        self._notify_cleaning()

    # ------------------------------------------------- cleaning-epoch pub/sub
    def subscribe_cleaning(self, token: object,
                           cb: Callable[[int, FrozenSet[int]], None]
                           ) -> Tuple[int, FrozenSet[int]]:
        """Register for cleaning-epoch pushes (§4.4: the server notifies
        clients when a head starts/finishes cleaning).  Returns the current
        (epoch, cleaning-head set) so a freshly connected client starts with a
        coherent view.  Re-subscribing with the same token replaces the old
        callback — what ``reconnect()`` does."""
        self._cleaning_subs[token] = cb
        return self.cleaning_epoch, frozenset(self.cleaners)

    def unsubscribe_cleaning(self, token: object) -> None:
        self._cleaning_subs.pop(token, None)

    def _notify_cleaning(self) -> None:
        self.cleaning_epoch += 1
        heads = frozenset(self.cleaners)
        for cb in list(self._cleaning_subs.values()):
            cb(self.cleaning_epoch, heads)

    def abandon_cleaning(self) -> None:
        """Drop all in-flight cleaners (recovery path) and push the epoch so
        subscribed clients fall off the §4.4 send path."""
        if self.cleaners:
            self.cleaners.clear()
            self._notify_cleaning()

    # --------------------------------------------------------------- recovery
    def recover(self) -> Dict[str, int]:
        from repro_torch.core.recovery import recover_server
        return recover_server(self)
