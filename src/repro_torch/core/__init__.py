"""Erda protocol: copies of ``repro.core``'s framework-neutral modules, with
the client's CRC verify of fetched objects batched through the CUDA kernel
(``core/client.py``, ``layout.verify_records``).  Imported lazily."""
_LAZY = {
    "ALL_SCHEMES": ("repro_torch.core.api", "ALL_SCHEMES"),
    "ALL_STORES": ("repro_torch.core.api", "ALL_STORES"),
    "ErdaClusterStore": ("repro_torch.core.api", "ErdaClusterStore"),
    "ErdaStore": ("repro_torch.core.api", "ErdaStore"),
    "make_store": ("repro_torch.core.api", "make_store"),
    "ErdaClient": ("repro_torch.core.client", "ErdaClient"),
    "ErdaCluster": ("repro_torch.core.cluster", "ErdaCluster"),
    "HashRing": ("repro_torch.core.cluster", "HashRing"),
    "InFlightWrite": ("repro_torch.core.replication", "InFlightWrite"),
    "ShardDownError": ("repro_torch.core.replication", "ShardDownError"),
    "ShardGroup": ("repro_torch.core.replication", "ShardGroup"),
    "MigrationLog": ("repro_torch.core.resharding", "MigrationLog"),
    "Resharding": ("repro_torch.core.resharding", "Resharding"),
    "RingGeneration": ("repro_torch.core.resharding", "RingGeneration"),
    "moving_slices": ("repro_torch.core.resharding", "moving_slices"),
    "DataLossError": ("repro_torch.core.server", "DataLossError"),
    "ErdaServer": ("repro_torch.core.server", "ErdaServer"),
    "ServerConfig": ("repro_torch.core.server", "ServerConfig"),
    "StaleEpochError": ("repro_torch.fabric.transport", "StaleEpochError"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value
    return value
