"""Erda-protocol checkpoint manager over nested dicts of tensors — the port of
``repro/checkpoint/erda_ckpt.py``.

Mapping (as in the reference):
  * every train-state leaf (split into ``shard_bytes`` sub-shards) is an Erda
    OBJECT: one one-sided write, CRC32 inside, no redo-log double write;
  * the checkpoint MANIFEST is one object updated per step — publishing it is
    the server's single 8-byte atomic flip, so a checkpoint becomes visible
    atomically, and the previous manifest stays reachable as the OLD version;
  * a writer that dies mid-shard leaves a torn object: restore detects it via
    CRC, falls back to the last consistent version, and repairs metadata;
  * stragglers: a slow writer simply hasn't flipped its entry — readers keep
    using the old version (no blocking).

Keys, the manifest JSON, the shard split and the leaf order (JAX's: dict keys
sorted, paths as ``jax.tree_util.keystr``) are the reference's, so both
packages leave the same NVM bytes and each restores what the other saved
(within one process: ``_leaf_key`` hashes a ``str``, which Python salts per
process).  One difference: a restore fetches a manifest's shards with ONE
``multi_read`` — one batch CRC verify on the card — where the reference reads
them one by one; results and NVM bytes are the same, doorbell counts are not.

The store may be one ``ErdaStore`` (the reference's) or an
``ErdaClusterStore`` (what ``launch.train.checkpoint_manager_for`` builds):
``restore``'s fallback to the previous manifest reads the hash-table word
and the old record on the server that owns ``MANIFEST_KEY`` (on a cluster,
the primary of its shard), and ``crash_recover`` runs the §4.2 scan on
every server through ``store.recover()``.  The reference reaches
``store.server`` directly and so works on a single store only.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

from repro_torch._device import resolve_device
from repro_torch.checkpoint.serialization import leaf_from_bytes, leaf_to_bytes
from repro_torch.core import DataLossError, ErdaStore
from repro_torch.core.hashtable import splitmix64
from repro_torch.tree import flatten_with_path, unflatten


def _leaf_key(tag: str, step: int, path: str, shard: int) -> int:
    h = splitmix64(hash((tag, step, path, shard)) & 0x7FFFFFFFFFFFFFFF)
    return h | 1  # keys must be non-zero


MANIFEST_KEY = 0x3A5F00D  # fixed key: its 8-byte atomic flip IS the commit


class ErdaCheckpointManager:
    def __init__(self, store: Optional[ErdaStore] = None, *,
                 device="cuda", tag: str = "ckpt", shard_bytes: int = 4 << 20):
        """``device`` is where restored leaves land and, for the default
        store, where its client CRC-verifies fetched shards."""
        from repro_torch.core import ServerConfig
        self.device = resolve_device(device)
        self.store = store or ErdaStore(ServerConfig(
            device_size=1 << 30, table_capacity=1 << 15,
            n_heads=8, region_size=32 << 20, segment_size=8 << 20),
            device=self.device)
        self.tag = tag
        self.shard_bytes = shard_bytes

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, fail_after_shards: Optional[int] = None):
        """Write all shards, then commit the manifest (one atomic flip).
        `fail_after_shards` injects a mid-checkpoint crash for tests."""
        entries = []
        written = 0
        for pstr, leaf in flatten_with_path(state):
            blob = leaf_to_bytes(leaf)
            shards = [blob[i : i + self.shard_bytes]
                      for i in range(0, len(blob), self.shard_bytes)] or [b""]
            for si, sh in enumerate(shards):
                if fail_after_shards is not None and written >= fail_after_shards:
                    raise RuntimeError("injected checkpoint-writer crash")
                self.store.write(_leaf_key(self.tag, step, pstr, si), sh)
                written += 1
            entries.append({"path": pstr, "shards": len(shards)})
        manifest = json.dumps({"step": step, "entries": entries}).encode()
        # THE commit point: one Erda update = one 8-byte atomic flip
        self.store.write(MANIFEST_KEY, manifest)
        return written

    # --------------------------------------------------------------- restore
    def _try_restore(self, manifest: Dict, template) -> Any:
        keys = [_leaf_key(self.tag, manifest["step"], e["path"], si)
                for e in manifest["entries"] for si in range(e["shards"])]
        vals = iter(self.store.multi_read(keys))  # one batch CRC verify
        out = {}
        for e in manifest["entries"]:
            parts = []
            for si in range(e["shards"]):
                v = next(vals)
                if v is None:
                    raise DataLossError(f"missing shard {e['path']}#{si}")
                parts.append(v)
            out[e["path"]] = leaf_from_bytes(b"".join(parts), self.device)
        return unflatten(template, [out[p] for p, _ in flatten_with_path(template)])

    def restore(self, template) -> Tuple[Optional[int], Any]:
        """Returns (step, state) of the newest CONSISTENT checkpoint.
        The Erda client transparently falls back to the old manifest version if
        the new one is torn; torn shards of the new step push the restore back
        to the previous committed step."""
        raw = self.store.read(MANIFEST_KEY)
        if raw is None:
            return None, None
        manifest = json.loads(bytes(raw).decode())
        try:
            return manifest["step"], self._try_restore(manifest, template)
        except DataLossError:
            pass
        # shards of the latest step torn → previous manifest version
        server = self._manifest_server()
        entry = server.table.lookup(MANIFEST_KEY)
        from repro_torch.core import layout
        _tag, _new, off_old = layout.unpack_word(entry.word)
        if off_old == layout.NULL_OFF:
            return None, None
        rec = layout.parse_record(server.dev.mem, off_old)
        if not rec.ok:
            return None, None
        manifest = json.loads(rec.value.decode())
        return manifest["step"], self._try_restore(manifest, template)

    def _manifest_server(self):
        """The ``ErdaServer`` that holds ``MANIFEST_KEY``: the single
        store's, or the primary of the cluster shard the key routes to."""
        if hasattr(self.store, "cluster"):
            shard = self.store.shard_for_key(MANIFEST_KEY)
            return self.store.cluster.groups[shard].primary.server
        return self.store.server

    # ----------------------------------------------------- failure injection
    def crash_recover(self):
        """Simulate a restart of every server: recovery scan + metadata
        repair (§4.2); returns the scan's stats (summed over a cluster's
        shards)."""
        return self.store.recover()
