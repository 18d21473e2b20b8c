"""Serving layer of the port: the Erda-backed KV page store and the batched
decode engine (imported lazily).  Serving at load comes with the DES."""
_LAZY = {
    "ErdaKVPageStore": ("repro_torch.serving.kv_store", "ErdaKVPageStore"),
    "PAGE_SHARD_CONFIG": ("repro_torch.serving.kv_store", "PAGE_SHARD_CONFIG"),
    "ServeEngine": ("repro_torch.serving.engine", "ServeEngine"),
    "page_shard_config": ("repro_torch.serving.kv_store", "page_shard_config"),
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
