"""ErdaClient — the client side of the protocol (paper Fig 7).

Reads are TWO one-sided RDMA reads, zero server CPU:
  1. read the hopscotch neighborhood of the key's home bucket (metadata),
  2. read the object at the NEW offset from the 8-byte atomic word.
The client verifies the object's CRC locally.  On failure it re-reads the OLD
offset (already in hand — no extra metadata round-trip) and notifies the
server to repair the entry.

Speculative reads (location cache): the fetched data is self-verifying, so a
client that remembers a key's last-seen packed hash-table word can GUESS the
object's location and validate the guess for free.  On a warm key the
neighborhood read and the object read at the cached NEW offset ride the SAME
doorbell; after completion, if the freshly fetched word equals the cached one
the speculative buffer is the current version — one overlapped round trip
instead of two dependent ones.  Validation compares the WORDS, never the CRC
alone: a stale offset in a log-structured heap still holds a CRC-valid *old*
version, so a completed speculative read proves nothing by itself.  On word
mismatch the client falls back to the ordinary dependent read at the fresh
offset (unchanged 2-RTT cost) and repopulates the cache.  Writes learn the
freshly published word from the write_with_imm response and update the cache;
``reconnect()`` (recovery, failover) and cleaning-epoch pushes invalidate it.

Writes are write_with_imm (server does the 8-byte atomic metadata flip and
returns the tail address) + ONE one-sided data write.  No read-after-write, no
redo log, no second NVM copy.

All remote access goes through an injected ``repro_torch.fabric.Transport``: the
default ``InProcessTransport`` gives the direct-memory functional model, and
``SimTransport`` makes the *same code path* emit calibrated DES latency and
server-CPU time (benchmarks/schemes_des.py) — one verb accounting, two
backends, no drift.

``multi_read`` / ``multi_write`` batch independent per-key verbs over the
transport's posted-WR engine: all k neighborhood reads ride one doorbell, a
fence orders the dependent leg (word → object address, metadata flip → data
write), then all k second-leg verbs ride a second doorbell.  Same verbs as k
sequential ops — the parity tests keep holding — but the fixed round-trip
cost is paid twice per *batch* instead of twice per *key*.  Warm keys fold
their object reads into the phase-1 doorbell, so an all-warm batch needs one
doorbell instead of two.

Remote facts the client needs (head array, registered region size, segment
size, head count, cleaning view) are captured once at connection
establishment (paper §3.3) — the client never reaches through the server
object for them afterwards; ``reconnect()`` refreshes them after a server
recovery.
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch import tracing
from repro_torch._device import resolve_device
from repro_torch.core import layout
from repro_torch.core.hashtable import ENTRY_SIZE, H, STATE_VALID
from repro_torch.core.log import head_id_for_key
from repro_torch.core.server import DataLossError, ErdaServer
from repro_torch.fabric.transport import (Handle, InProcessTransport, Transport,
                                    WorkRequest)
from repro_torch.nvmsim.device import TornWrite


class ErdaClient:
    INITIAL_READ = 4096  # speculative first object read when size unknown

    def __init__(self, server: ErdaServer, client_id: int = 0,
                 transport: Optional[Transport] = None, qp: int = 0,
                 device="cuda"):
        self.server = server
        # where the CRC verify of fetched objects runs (kernels.ops.crc32_batch)
        self.device = resolve_device(device)
        self.client_id = client_id
        self.qp = qp  # this connection's work-queue lane on the transport
        self.transport = transport or InProcessTransport(server.dev)
        self.size_cache: Dict[int, int] = {}
        # location cache: key -> last-seen packed hash-table word.  Unlike
        # size hints these are NOT stale-but-safe (a stale offset holds a
        # CRC-valid OLD version), so every invalidation point — reconnect,
        # cleaning epoch, fallback — must drop entries, never trust them.
        self.loc_cache: Dict[int, int] = {}
        self.cache_generation = 0
        # replication epoch this connection's WRITE-path WRs are stamped
        # with (None = unfenced single-replica store).  A ShardGroup sets it
        # at install/promotion time; the transport rejects a stamped WR whose
        # epoch predates a revocation (split-brain fencing — see
        # fabric.transport.StaleEpochError).  Reads are never stamped.
        self.epoch: Optional[int] = None
        self.stats = {"reads": 0, "writes": 0, "fallbacks": 0, "repairs": 0,
                      "one_sided_reads": 0, "one_sided_writes": 0,
                      "send_ops": 0, "spec_hits": 0, "spec_misses": 0,
                      "spec_invalidations": 0}
        self._cleaning_epoch = 0
        self._cleaning_heads: FrozenSet[int] = frozenset()
        self.reconnect()

    def reconnect(self) -> None:
        """Connection establishment (paper §3.3): the server sends the head
        array plus the remote facts one-sided access needs — the registered
        region's size, the log segment size, the head count and the current
        cleaning view.  Re-run after a server recovery or a failover
        promotion.  Size hints survive (stale-but-safe: CRC re-verifies and
        a short guess just re-reads), but location entries are DROPPED and the
        cache generation bumps: after a promotion the same key lives at a
        different offset on the new primary's log, where the old offset can
        still hold a CRC-valid old version."""
        self.head_array = self.server.log.head_array()
        self.remote_size = self.server.dev.size
        self.segment_size = self.server.log.heads[0].segment_size
        self.n_heads = self.server.log.n_heads
        self.stats["spec_invalidations"] += len(self.loc_cache)
        self.loc_cache.clear()
        self.cache_generation += 1
        self._cleaning_epoch, self._cleaning_heads = \
            self.server.subscribe_cleaning(self, self._on_cleaning_update)

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Adopt a replication epoch: every subsequent write-path WR carries
        it, so a later revocation (promotion) fences this connection's
        in-flight and future writes at the QP."""
        self.epoch = epoch

    # -------------------------------------------------------- cleaning view
    def _on_cleaning_update(self, epoch: int, heads: FrozenSet[int]) -> None:
        """Cleaning-epoch push (§4.4: the server notifies clients when a head
        starts/finishes cleaning).  Location entries on any head whose
        cleaning state changed are purged: FINISH flips every word of the
        head (a cached word could never validate again) and relocates the
        data to Region 2."""
        changed = heads ^ self._cleaning_heads
        self._cleaning_epoch = epoch
        self._cleaning_heads = heads
        if changed and self.loc_cache:
            stale = [k for k in self.loc_cache
                     if head_id_for_key(k, self.n_heads) in changed]
            for k in stale:
                del self.loc_cache[k]
            self.stats["spec_invalidations"] += len(stale)

    def is_cleaning(self, key: int) -> bool:
        """Client-local §4.4 check: head id from the connection-time head
        count, cleaning set from the push-updated view — no server
        reach-through, no extra verbs."""
        return bool(self._cleaning_heads) and \
            head_id_for_key(key, self.n_heads) in self._cleaning_heads

    def purge_locations(self, keys: Optional[Sequence[int]] = None, *,
                        pred: Optional[Callable[[int], bool]] = None) -> int:
        """Surgical location-cache purge for an ownership change.  A slice
        cutover (online resharding) moves one keyspace interval to a new
        owner; only THOSE keys' cached words are invalid afterwards, so —
        exactly like the per-head purge cleaning epochs do — the migrated
        keys are dropped (by list or by predicate) and every other entry
        keeps its one-doorbell warm-read path.  Returns the number of
        entries purged."""
        if pred is not None:
            stale = [k for k in self.loc_cache if pred(k)]
        else:
            stale = [k for k in (keys or ()) if k in self.loc_cache]
        for k in stale:
            del self.loc_cache[k]
        self.stats["spec_invalidations"] += len(stale)
        return len(stale)

    # ------------------------------------------------------------- one-sided ops
    def _os_read(self, addr: int, nbytes: int, op: str = "erda.object") -> bytes:
        self.stats["one_sided_reads"] += 1
        nbytes = min(nbytes, self.remote_size - addr)
        return self.transport.one_sided_read(addr, nbytes, op=op, qp=self.qp)

    def _post_os_read(self, addr: int, nbytes: int,
                      op: str = "erda.object") -> Handle:
        self.stats["one_sided_reads"] += 1
        nbytes = min(nbytes, self.remote_size - addr)
        return self.transport.post(
            WorkRequest("one_sided_read", op=op, addr=addr, nbytes=nbytes),
            qp=self.qp)

    def _os_write(self, addr: int, data: bytes) -> None:
        self.stats["one_sided_writes"] += 1
        self.transport.one_sided_write(addr, data, op="erda.data", qp=self.qp,
                                       epoch=self.epoch)

    def _post_os_write(self, addr: int, data: bytes) -> Handle:
        self.stats["one_sided_writes"] += 1
        return self.transport.post(
            WorkRequest("one_sided_write", op="erda.data", addr=addr,
                        data=data, epoch=self.epoch),
            qp=self.qp)

    # ------------------------------------------------------------- metadata read
    def _post_entry_read(self, key: int) -> List[Handle]:
        """Post the neighborhood read(s) for a key: one one-sided read of up
        to H entries — two when the neighborhood wraps the table end (the
        registered region is contiguous, the table is a ring)."""
        table = self.server.table
        base = table._addr(table.home(key))
        want = H * ENTRY_SIZE
        first = min(want, table.base + table.capacity * ENTRY_SIZE - base)
        handles = [self._post_os_read(base, first, op="erda.meta")]
        if first < want:
            handles.append(self._post_os_read(table.base, want - first,
                                              op="erda.meta"))
        return handles

    @staticmethod
    def _scan_neighborhood(raw: bytes, key: int) -> Optional[int]:
        """Client-side hopscotch scan of a fetched neighborhood."""
        for i in range(H):
            chunk = raw[i * ENTRY_SIZE : (i + 1) * ENTRY_SIZE]
            if len(chunk) < ENTRY_SIZE:
                break
            k = struct.unpack_from("<Q", chunk, 0)[0]
            word = struct.unpack_from("<Q", chunk, 8)[0]
            state = chunk[17]
            if state == STATE_VALID and k == key:
                return word
        return None

    def _read_entry(self, key: int) -> Optional[int]:
        handles = self._post_entry_read(key)
        self.transport.poll(self.qp)
        return self._scan_neighborhood(b"".join(h.result for h in handles), key)

    # ------------------------------------------------------------- object read
    def _parse_object(self, key: int, off: int, buf: bytes,
                      ok: Optional[bool] = None) -> layout.RecordView:
        """CRC-verify + parse a fetched object; one size-miss re-read if the
        header claims more bytes than the speculative read covered.  ``ok``
        is the buffer's verdict when a batch verify already computed it."""
        self.transport.client_crc(len(buf))  # client-side verification cost
        if ok is None:
            ok = layout.verify_records([buf], self.device)[0]
        rec = layout.view_record(buf, ok)
        if not rec.ok:
            # maybe the object is just longer than our speculative read: check
            # the header's claimed size and re-read once (size-miss path)
            if len(buf) >= layout.HEADER_SIZE:
                flags, _crc, key_len, val_len = struct.unpack_from(layout.HEADER_FMT, buf, 0)
                claimed = layout.HEADER_SIZE + key_len + (0 if flags & layout.FLAG_DELETE else val_len)
                if claimed > len(buf) and claimed <= self.segment_size:
                    buf = self._os_read(off, claimed)
                    self.transport.client_crc(len(buf))
                    rec = layout.view_record(
                        buf, layout.verify_records([buf], self.device)[0])
        if rec.ok:
            self.size_cache[key] = rec.size
        return rec

    def _read_object(self, key: int, off: int) -> layout.RecordView:
        guess = self.size_cache.get(key, self.INITIAL_READ)
        return self._parse_object(key, off, self._os_read(off, guess))

    def read(self, key: int) -> Optional[bytes]:
        self.stats["reads"] += 1
        if self.is_cleaning(key):
            # during cleaning, ops for this head go through RDMA send (§4.4)
            return self._send_read(key)
        cached = self.loc_cache.get(key)
        if cached is not None:
            return self._spec_read(key, cached)
        word = self._read_entry(key)
        if word is None or word == 0:
            return None
        _tag, off_new, _off_old = layout.unpack_word(word)
        if off_new == layout.NULL_OFF:
            return None
        rec = self._read_object(key, off_new)
        return self._finish_read(key, word, rec)

    def _spec_read(self, key: int, cached: int) -> Optional[bytes]:
        """Warm-key read: the neighborhood read AND the object read at the
        cached NEW offset ride ONE doorbell.  Same verbs as the cold path on
        a hit — only the dependent round trip disappears."""
        _tag, off_spec, _off_old = layout.unpack_word(cached)
        guess = self.size_cache.get(key, self.INITIAL_READ)
        with self.transport.batch():
            metas = self._post_entry_read(key)
            spec = self._post_os_read(off_spec, guess)
        self.transport.poll(self.qp)
        word = self._scan_neighborhood(b"".join(h.result for h in metas), key)
        if word == cached:
            # validated: the fresh word proves the cached offset is current.
            # (CRC alone would not — a superseded offset still parses.)
            self.stats["spec_hits"] += 1
            rec = self._parse_object(key, off_spec, spec.result)
            return self._finish_read(key, word, rec)
        # mismatch: the guess was stale — dependent read at the FRESH offset
        # (the seed's 2-RTT cost; the speculative buffer is discarded)
        self.stats["spec_misses"] += 1
        self.loc_cache.pop(key, None)
        if word is None or word == 0:
            return None
        _tag, off_new, _off_old = layout.unpack_word(word)
        if off_new == layout.NULL_OFF:
            return None
        rec = self._read_object(key, off_new)
        return self._finish_read(key, word, rec)

    def _finish_read(self, key: int, word: int,
                     rec: layout.RecordView) -> Optional[bytes]:
        """Common tail of the read path once the NEW-offset object is parsed:
        CRC-verified hit (which warms the location cache), or fallback to the
        OLD version (paper §4.2)."""
        if rec.ok and rec.key == key:
            self.loc_cache[key] = word
            return None if rec.deleted else rec.value
        # --- fallback: torn/in-flight new version → old version (paper §4.2)
        self.stats["fallbacks"] += 1
        self.loc_cache.pop(key, None)  # word points at a torn NEW — not a hint
        _tag, _off_new, off_old = layout.unpack_word(word)
        if off_old == layout.NULL_OFF:
            # torn create; tell the server, the object does not exist yet
            self.stats["repairs"] += 1
            self._send_repair(key, word)
            return None
        rec_old = self._read_object(key, off_old)
        if rec_old.ok and rec_old.key == key:
            self.stats["repairs"] += 1
            self._send_repair(key, word)
            return None if rec_old.deleted else rec_old.value
        raise DataLossError(f"both versions of key {key} unreadable")

    def _send_read(self, key: int) -> Optional[bytes]:
        self.stats["send_ops"] += 1
        return self.transport.send_recv(
            "erda.read", lambda: self.server.handle_read(key), qp=self.qp)

    def _send_repair(self, key: int, word: int) -> None:
        self.stats["send_ops"] += 1
        self.transport.send_recv(
            "erda.repair", lambda: self.server.handle_repair(key, word),
            qp=self.qp)

    # ------------------------------------------------------------- batched reads
    def multi_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """Read k keys with 2 doorbells instead of 2 round trips per key —
        1 doorbell when every key is warm in the location cache.

        Phase 1 posts every key's neighborhood read — plus, for warm keys,
        the speculative object read at the cached offset — on one doorbell;
        the fence completes them (CRC/word checks need the data in hand).
        Phase 2 posts the object read for every cold or mis-speculated key on
        a second doorbell; if there are none, no second doorbell rings.  Rare
        paths — cleaning-head keys, CRC fallbacks, size-miss re-reads — drop
        to the sequential code so the batched path stays the common case.
        Observationally equivalent to k sequential ``read()`` calls; issues
        exactly the same verbs per DISTINCT key on hits — duplicate keys
        within one batch collapse to a single fetch (the batch reads a
        snapshot, so every occurrence returns the same value).  Span
        ``erda.multi_read``, counting the keys and the torn-read fallbacks
        taken inside it."""
        fallbacks = self.stats["fallbacks"]
        with tracing.span("erda.multi_read", keys=len(keys)) as sp:
            out: List[Optional[bytes]] = [None] * len(keys)
            first: Dict[int, int] = {}       # key -> index of its first occurrence
            dups: List[Tuple[int, int]] = []  # (duplicate index, first index)
            # (index, key, meta handles, cached word or None, spec handle or None)
            metas: List[Tuple[int, int, List[Handle], Optional[int], Optional[Handle]]] = []
            objs: List[Tuple[int, int, int, Handle]] = []
            with self.transport.batch() as b:
                for i, key in enumerate(keys):
                    self.stats["reads"] += 1
                    if key in first:
                        dups.append((i, first[key]))
                        continue
                    first[key] = i
                    if self.is_cleaning(key):
                        # §4.4 send path (a blocking verb inside the batch acts as
                        # a fence for this lane — correctness over amortization on
                        # the rare path)
                        out[i] = self._send_read(key)
                        continue
                    cached = self.loc_cache.get(key)
                    spec = None
                    if cached is not None:
                        _tag, off_spec, _old = layout.unpack_word(cached)
                        guess = self.size_cache.get(key, self.INITIAL_READ)
                        spec = self._post_os_read(off_spec, guess)
                    metas.append((i, key, self._post_entry_read(key), cached, spec))
                b.fence()  # neighborhoods must be in hand to learn object offsets
                words = [self._scan_neighborhood(
                    b"".join(h.result for h in handles), key)
                    for _i, key, handles, _cached, _spec in metas]
                # every validated speculative buffer is CRC-verified as one batch
                hits = [m[4].result for m, word in zip(metas, words)
                        if m[3] is not None and word == m[3]]
                hit_ok = iter(layout.verify_records(hits, self.device))
                for (i, key, handles, cached, spec), word in zip(metas, words):
                    if cached is not None:
                        if word == cached:
                            self.stats["spec_hits"] += 1
                            _tag, off_spec, _old = layout.unpack_word(cached)
                            rec = self._parse_object(key, off_spec, spec.result,
                                                     next(hit_ok))
                            out[i] = self._finish_read(key, word, rec)
                            continue
                        self.stats["spec_misses"] += 1
                        self.loc_cache.pop(key, None)
                    if word is None or word == 0:
                        continue
                    _tag, off_new, _off_old = layout.unpack_word(word)
                    if off_new == layout.NULL_OFF:
                        continue
                    guess = self.size_cache.get(key, self.INITIAL_READ)
                    objs.append((i, key, word,
                                 self._post_os_read(off_new, guess)))
            self.transport.poll(self.qp)  # drain the lane's CQ for both doorbells
            # every phase-2 object is CRC-verified as one batch
            obj_ok = layout.verify_records(
                [h.result for _i, _key, _word, h in objs], self.device)
            for (i, key, word, h), ok in zip(objs, obj_ok):
                _tag, off_new, _off_old = layout.unpack_word(word)
                rec = self._parse_object(key, off_new, h.result, ok)
                out[i] = self._finish_read(key, word, rec)
            for i, j in dups:
                out[i] = out[j]
            sp.add(fallbacks=self.stats["fallbacks"] - fallbacks)
        return out

    # ----------------------------------------------------- posted write legs
    # The two legs of a write as individually postable WRs, so coordinators
    # (batched multi-writes, the replication layer's mirrored lanes) can ride
    # several writes — or the same write on two replicas' QPs — on shared
    # doorbells: post_write_req(s) → fence → post_data_write(s) → finish.
    def post_write_req(self, key: int, val_len: int, *,
                       delete: bool = False) -> Handle:
        """Post the metadata write_with_imm leg (the server's atomic flip);
        ``h.result`` is (addr, size, word) once a fence/doorbell completes
        it."""
        self.stats["send_ops"] += 1
        return self.transport.post(
            WorkRequest("write_with_imm", op="erda.write_req",
                        handler=lambda: self.server.handle_write_req(
                            key, val_len, delete=delete),
                        epoch=self.epoch),
            qp=self.qp)

    def post_data_write(self, addr: int, rec: bytes) -> Handle:
        """Post the one-sided data write leg at the flip-returned address."""
        return self._post_os_write(addr, rec)

    def finish_write(self, key: int, addr: int, size: int,
                     word: Optional[int] = None, *,
                     delete: bool = False) -> None:
        """Book-keeping tail of a completed write (size + location hints +
        test hook).  The freshly published word warms the location cache —
        the next read of this key speculates in one doorbell.  A tombstone
        word is cached too: it points at a CRC-valid delete record, so the
        speculative read correctly returns 'missing'.  Words learned on the
        §4.4 send path are dropped instead — mid-cleaning words never survive
        the finish-time flip."""
        if delete:
            # a recreate may be any size; a stale hint would force the
            # size-miss re-read path needlessly
            self.size_cache.pop(key, None)
        else:
            self.size_cache[key] = size
        if word is None or self.is_cleaning(key):
            self.loc_cache.pop(key, None)
        else:
            self.loc_cache[key] = word
        self._post_write(key, addr, size)

    # ------------------------------------------------------------- write path
    def write(self, key: int, value: bytes) -> None:
        self.stats["writes"] += 1
        rec = layout.pack_record(key, value)
        if self.is_cleaning(key):
            addr, size, word = self._send_write_cleaning(key, rec, len(value))
            self.finish_write(key, addr, size, word)
            return
        self.stats["send_ops"] += 1
        addr, size, word = self.transport.write_with_imm(
            "erda.write_req",
            lambda: self.server.handle_write_req(key, len(value)), qp=self.qp,
            epoch=self.epoch)
        # may raise TornWrite under fault injection — the location cache then
        # keeps the PRE-write word, whose speculative read word-mismatches and
        # falls back to the seed's fresh-read/repair path (never a stale hit)
        self._os_write(addr, rec)
        self.finish_write(key, addr, size, word)

    def _send_write_cleaning(self, key: int, rec: bytes,
                             val_len: int, *, delete: bool = False):
        """§4.4 send path: the server allocates AND performs the data write."""
        self.stats["send_ops"] += 1

        def _srv():
            addr, size, word = self.server.handle_write_req(key, val_len,
                                                            delete=delete)
            self.server.dev.write(addr, rec)
            return addr, size, word

        return self.transport.send_recv("erda.write_cleaning", _srv,
                                        req_bytes=len(rec), qp=self.qp,
                                        epoch=self.epoch)

    # ------------------------------------------------------------ batched writes
    def multi_write(self, items: Sequence[Tuple[int, bytes]]) -> None:
        """Write k key/value pairs with 2 doorbells: one for every metadata
        write_with_imm (the server's atomic flips), a fence — each data write
        needs the address its metadata leg returned, and the protocol orders
        flip-then-data per key — then one doorbell for every one-sided data
        write.  Same verbs as k sequential ``write()`` calls."""
        imms: List[Tuple[int, bytes, bytes, Handle]] = []
        done: List[Tuple[int, int, int, int]] = []
        with tracing.span("erda.multi_write", keys=len(items)):
            with self.transport.batch() as b:
                for key, value in items:
                    self.stats["writes"] += 1
                    with tracing.span("erda.pack", bytes=len(value)):
                        rec = layout.pack_record(key, value)
                    if self.is_cleaning(key):
                        addr, size, word = self._send_write_cleaning(
                            key, rec, len(value))
                        done.append((key, addr, size, word))
                        continue
                    imms.append((key, value, rec,
                                 self.post_write_req(key, len(value))))
                b.fence()  # metadata flip completes before its dependent data write
                for key, _value, rec, h in imms:
                    addr, size, word = h.result
                    self.post_data_write(addr, rec)
                    done.append((key, addr, size, word))
            self.transport.poll(self.qp)
            for key, addr, size, word in done:
                self.finish_write(key, addr, size, word)

    def delete(self, key: int) -> None:
        self.stats["writes"] += 1
        rec = layout.pack_record(key, None, delete=True)
        if self.is_cleaning(key):
            addr, size, word = self._send_write_cleaning(key, rec, 0,
                                                         delete=True)
        else:
            self.stats["send_ops"] += 1
            addr, size, word = self.transport.write_with_imm(
                "erda.write_req",
                lambda: self.server.handle_write_req(key, 0, delete=True),
                qp=self.qp, epoch=self.epoch)
            self._os_write(addr, rec)
        self.finish_write(key, addr, size, word, delete=True)

    def _post_write(self, key: int, addr: int, size: int) -> None:
        pass  # hook for tests/telemetry


def memoryview_to_np(buf: bytes):
    import numpy as np
    return np.frombuffer(buf, dtype=np.uint8)
