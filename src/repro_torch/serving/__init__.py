"""Serving layer of the port: the Erda-backed KV page store (imported
lazily).  ``ServeEngine`` and serving at load come with later slices."""
_LAZY = {
    "ErdaKVPageStore": ("repro_torch.serving.kv_store", "ErdaKVPageStore"),
    "PAGE_SHARD_CONFIG": ("repro_torch.serving.kv_store", "PAGE_SHARD_CONFIG"),
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
