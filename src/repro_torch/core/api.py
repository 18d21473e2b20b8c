"""Unified KV-store facade over Erda (single-server and sharded cluster) and
the two baselines.

All stores expose read/write/delete plus NVM statistics, so benchmarks and
property tests run the same op streams against every scheme.  Each store also
accepts a ``transport_factory`` so the same code runs over the functional
``InProcessTransport`` or the DES-timed ``SimTransport``
(``repro_torch.fabric``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.core.baselines.read_after_write import ReadAfterWriteStore
from repro_torch.core.baselines.redo_logging import RedoLoggingStore
from repro_torch.core.client import ErdaClient
from repro_torch.core.cluster import ErdaCluster
from repro_torch.core.server import ErdaServer, ServerConfig
from repro_torch.nvmsim.device import NVMDevice

TransportFactory = Callable[[NVMDevice], object]


class ErdaStore:
    scheme = "erda"

    def __init__(self, cfg: Optional[ServerConfig] = None,
                 transport_factory: Optional[TransportFactory] = None,
                 device="cuda"):
        self.server = ErdaServer(cfg or ServerConfig())
        self.client = ErdaClient(
            self.server,
            transport=transport_factory(self.server.dev) if transport_factory else None,
            device=device)
        self.dev = self.server.dev

    def write(self, key: int, value: bytes) -> None:
        self.client.write(key, value)

    def read(self, key: int) -> Optional[bytes]:
        return self.client.read(key)

    def delete(self, key: int) -> None:
        self.client.delete(key)

    def multi_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """Doorbell-batched: k keys in 2 doorbells instead of 2 RTT per key."""
        return self.client.multi_read(keys)

    def multi_write(self, items: Sequence[Tuple[int, bytes]]) -> None:
        self.client.multi_write(items)

    def recover(self):
        """§4.2 crash-recovery scan + metadata repair."""
        return self.server.recover()

    def compact(self) -> int:
        """Force the lock-free cleaner over every log head."""
        from repro_torch.core.cleaning import sweep_server
        return sweep_server(self.server, force=True)

    def maybe_clean(self) -> int:
        from repro_torch.core.cleaning import sweep_server
        return sweep_server(self.server)

    @property
    def devs(self) -> List[NVMDevice]:
        return [self.dev]

    @property
    def transport(self):
        return self.client.transport

    @property
    def stats(self):
        return self.client.stats


class ErdaClusterStore:
    """Store facade over an N-shard ``ErdaCluster`` — same surface as
    ``ErdaStore`` so every property/benchmark suite runs against both."""

    scheme = "erda-cluster"

    def __init__(self, n_shards: int = 4, cfg: Optional[ServerConfig] = None,
                 transport_factory: Optional[TransportFactory] = None,
                 vnodes: int = 64, replication: int = 1, device="cuda"):
        self.cluster = ErdaCluster(n_shards=n_shards, cfg=cfg,
                                   transport_factory=transport_factory,
                                   vnodes=vnodes, replication=replication,
                                   device=device)

    def write(self, key: int, value: bytes) -> None:
        self.cluster.write(key, value)

    def read(self, key: int) -> Optional[bytes]:
        return self.cluster.read(key)

    def delete(self, key: int) -> None:
        self.cluster.delete(key)

    def multi_read(self, keys: Sequence[int]) -> List[Optional[bytes]]:
        """Per-shard sub-batches over per-shard QPs, completions overlapped."""
        return self.cluster.multi_read(keys)

    def multi_write(self, items: Sequence[Tuple[int, bytes]]) -> None:
        self.cluster.multi_write(items)

    def recover(self):
        return self.cluster.recover()

    def recover_shard(self, shard: int):
        return self.cluster.recover_shard(shard)

    def fail_shard(self, shard: int, replica: int = 0, *,
                   wipe: bool = False) -> None:
        """Simulate losing one replica of the shard (0 = the primary;
        ``wipe=True`` loses its NVM too, forcing a resync to rejoin)."""
        self.cluster.fail_shard(shard, replica, wipe=wipe)

    def failover(self, shard: int):
        """Epoch-fenced promotion of the shard's senior live backup."""
        return self.cluster.failover(shard)

    def group(self, shard: int):
        """The shard's ``ShardGroup`` (epoch/quorum state, chaos hooks)."""
        return self.cluster.groups[shard]

    def compact(self) -> int:
        return self.cluster.compact()

    def maybe_clean(self) -> int:
        return self.cluster.maybe_clean()

    def shard_for_key(self, key: int) -> int:
        return self.cluster.shard_for_key(key)

    # ------------------------------------------------------ elastic membership
    def add_shard(self, shard_id: Optional[int] = None, *, run: bool = True,
                  grace: int = 1, batch: int = 32):
        """Grow the live cluster by one shard (online resharding).  Returns
        the ``Resharding`` controller; with ``run=False`` the caller drives
        ``step(budget)`` interleaved with traffic."""
        return self.cluster.add_shard(shard_id, run=run, grace=grace,
                                      batch=batch)

    def remove_shard(self, shard_id: int, *, run: bool = True,
                     grace: int = 1, batch: int = 32):
        """Shrink the live cluster by one shard (online resharding)."""
        return self.cluster.remove_shard(shard_id, run=run, grace=grace,
                                         batch=batch)

    @property
    def resharding(self):
        """The in-flight ``Resharding`` controller, or None."""
        return self.cluster.resharding

    @property
    def shard_ids(self) -> List[int]:
        return self.cluster.shard_ids

    @property
    def n_shards(self) -> int:
        return self.cluster.n_shards

    @property
    def devs(self) -> List[NVMDevice]:
        return [s.dev for s in self.cluster.servers]

    @property
    def stats(self):
        return self.cluster.stats


def make_store(scheme: str, *, device="cuda", **kwargs):
    """``device`` is where the Erda clients CRC-verify fetched objects; the
    baselines verify on the host and ignore it."""
    if scheme == "erda":
        return ErdaStore(kwargs.get("cfg"),
                         transport_factory=kwargs.get("transport_factory"),
                         device=device)
    if scheme == "erda-cluster":
        return ErdaClusterStore(**kwargs, device=device)
    if scheme == "redo":
        return RedoLoggingStore(**kwargs)
    if scheme == "raw":
        return ReadAfterWriteStore(**kwargs)
    raise ValueError(f"unknown scheme {scheme!r}")


ALL_SCHEMES = ("erda", "redo", "raw")
ALL_STORES = ("erda", "erda-cluster", "redo", "raw")
