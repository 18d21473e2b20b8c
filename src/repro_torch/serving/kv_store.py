"""Erda-backed KV-cache page store for serving — the port of
``repro/serving/kv_store.py`` over tensors.

Decode-time KV pages are Erda objects: appended with one one-sided write
each, page-table entries are the 8-byte atomic words, and a preempted host's
torn page is detected by CRC at fetch (one batch verify on the card per
shard) and falls back to the previous snapshot.  The log cleaner doubles as
page eviction/compaction.  Pages come back as tensors on the store's device.

By default pages are sharded across an ``ErdaCluster``; pass any
``make_store(...)`` object to override.  ``_page_key`` hashes a ``str``,
which Python salts per process, so pages cross between this store and the
reference's only within one process.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch._device import resolve_device
from repro_torch.checkpoint.serialization import leaf_from_bytes, leaf_to_bytes, to_tensor
from repro_torch.core import ServerConfig, make_store
from repro_torch.core.hashtable import ENTRY_SIZE, splitmix64
from repro_torch.core.layout import NULL_OFF
from repro_torch.tree import flatten_with_path, unflatten

#: per-shard geometry for the default serving cluster
PAGE_SHARD_CONFIG = ServerConfig(device_size=256 << 20, table_capacity=1 << 14,
                                 n_heads=4, region_size=16 << 20,
                                 segment_size=4 << 20)


#: the most NVM a page-store server may have: its hash-table words hold
#: 31-bit log offsets, and the all-ones offset is the null sentinel
MAX_SHARD_BYTES = NULL_OFF
#: bytes a page's record may add to its tensor (leaf and record headers)
RECORD_SLACK = 64 << 10


def page_shard_config(pages: Sequence[Tuple[str, int]], versions: int) -> ServerConfig:
    """Per-shard geometry of a page store in which every shard can hold
    ``versions`` snapshots of all of ``pages`` — (name, bytes) pairs, one
    snapshot's pages — however the cluster routes their keys.  A shard has
    one head and a segment holds one whole snapshot.  The log appends a
    shard's records in write order and starts a fresh segment for a record
    that does not fit what is left of its segment, so each segment after
    the first starts at a record that, with the segment before it, passes
    one snapshot's bytes: a snapshot boundary lies in between, and the
    records of ``versions`` snapshots, or of any part of them, take at most
    ``versions`` segments.  Raises ``ValueError`` when that NVM passes
    ``MAX_SHARD_BYTES``."""
    seg = sum((n + RECORD_SLACK + 7) & ~7 for _name, n in pages)
    seg = -(-seg // 4096) * 4096
    need = PAGE_SHARD_CONFIG.table_capacity * ENTRY_SIZE + versions * seg
    if need > MAX_SHARD_BYTES:
        raise ValueError(
            f"{versions} snapshots of {seg} B of pages need {need} B of NVM "
            f"on a page-store shard, past the {MAX_SHARD_BYTES} B a server "
            f"addresses with the atomic word's 31-bit offsets")
    return dataclasses.replace(PAGE_SHARD_CONFIG, n_heads=1, region_size=seg,
                               segment_size=seg, device_size=need)


def _page_key(seq_id: int, name: str, idx: int) -> int:
    return splitmix64(hash((seq_id, name, idx)) & 0x7FFFFFFFFFFFFFFF) | 1


class ErdaKVPageStore:
    def __init__(self, store=None, *, n_shards: int = 2, replication: int = 1,
                 device="cuda"):
        """``replication=2`` mirrors every page write to a ring-successor
        backup replica, so a preempted host losing a shard's NVM no longer
        loses that shard's KV pages — failover promotes the backup.
        ``device`` is where pages come back and, for the default store,
        where its clients CRC-verify fetched pages."""
        self.device = resolve_device(device)
        self.store = store or make_store("erda-cluster", n_shards=n_shards,
                                         replication=replication,
                                         cfg=PAGE_SHARD_CONFIG,
                                         device=self.device)

    def put_page(self, seq_id: int, name: str, idx: int, page) -> None:
        self.store.write(_page_key(seq_id, name, idx), leaf_to_bytes(page))

    def get_page(self, seq_id: int, name: str, idx: int) -> Optional[torch.Tensor]:
        raw = self.store.read(_page_key(seq_id, name, idx))
        return None if raw is None else leaf_from_bytes(raw, self.device)

    def get_pages(self, seq_id: int, name: str,
                  idxs: Sequence[int]) -> List[Optional[torch.Tensor]]:
        """Multi-page fetch: one doorbell-batched ``multi_read`` over the
        backing store (per-shard sub-batches on a cluster)."""
        raws = self.store.multi_read([_page_key(seq_id, name, i) for i in idxs])
        return [None if raw is None else leaf_from_bytes(raw, self.device)
                for raw in raws]

    def drop_page(self, seq_id: int, name: str, idx: int) -> None:
        self.store.delete(_page_key(seq_id, name, idx))

    # ------------------------------------------------- cache snapshot/restore
    def snapshot_cache(self, seq_id: int, cache) -> int:
        """Persist a whole decode cache tree as numbered pages — one batched
        multi_write (2 doorbells per shard), not one write per leaf.  Spans
        ``pages.snapshot`` around ``pages.serialize`` (the copies to the
        host), counting the page bytes."""
        leaves = flatten_with_path(cache)
        with tracing.span("pages.snapshot", leaves=len(leaves)) as sp:
            with tracing.span("pages.serialize"):
                items = [(_page_key(seq_id, path, 0), leaf_to_bytes(leaf))
                         for path, leaf in leaves]
            sp.add(bytes=sum(len(raw) for _key, raw in items))
            self.store.multi_write(items)
        return len(leaves)

    def restore_cache(self, seq_id: int, template):
        """The cache tree ``snapshot_cache`` persisted, read back, verified
        and on the store's device; None when a page is missing.  Spans
        ``pages.restore`` around ``pages.upload`` (the copies to the
        device), counting the page bytes."""
        leaves = flatten_with_path(template)
        with tracing.span("pages.restore", leaves=len(leaves)) as sp:
            raws = self.store.multi_read(
                [_page_key(seq_id, path, 0) for path, _leaf in leaves])
            if any(raw is None for raw in raws):
                return None
            sp.add(bytes=sum(len(raw) for raw in raws))
            with tracing.span("pages.upload"):
                out = [leaf_from_bytes(raw, self.device).to(to_tensor(leaf).dtype)
                       for (_path, leaf), raw in zip(leaves, raws)]
        return unflatten(template, out)

    def compact(self) -> None:
        """Page eviction/compaction = the paper's lock-free log cleaning,
        swept across every shard of the backing store."""
        self.store.maybe_clean()

    # ----------------------------------------------------------- availability
    def fail_shard(self, shard: int) -> None:
        """Simulate a serving host losing a page shard's NVM."""
        self.store.fail_shard(shard)

    def failover(self, shard: int):
        """Promote the shard's mirrored backup; pages keep serving."""
        return self.store.failover(shard)

    @property
    def stats(self):
        """Backing-store op counters (incl. the location cache's)."""
        return self.store.stats
