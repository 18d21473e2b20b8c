"""Serving layer of the port: the Erda-backed KV page store and the batched
decode engine, and the open-loop serving-at-load driver over the DES
(imported lazily)."""
_LAZY = {
    "ErdaKVPageStore": ("repro_torch.serving.kv_store", "ErdaKVPageStore"),
    "PAGE_SHARD_CONFIG": ("repro_torch.serving.kv_store", "PAGE_SHARD_CONFIG"),
    "ServeEngine": ("repro_torch.serving.engine", "ServeEngine"),
    "page_shard_config": ("repro_torch.serving.kv_store", "page_shard_config"),
    "serve_kv_at_load": ("repro_torch.serving.engine", "serve_kv_at_load"),
    "OpenLoopConfig": ("repro_torch.serving.load", "OpenLoopConfig"),
    "run_open_loop": ("repro_torch.serving.load", "run_open_loop"),
    "sweep_open_loop": ("repro_torch.serving.load", "sweep_open_loop"),
    "validate_schedule": ("repro_torch.serving.load", "validate_schedule"),
    "check_schedule_legality": ("repro_torch.serving.load",
                                "check_schedule_legality"),
    "QPScheduler": ("repro_torch.serving.load", "QPScheduler"),
    "capture_page_fetch_traces": ("repro_torch.serving.load",
                                  "capture_page_fetch_traces"),
    "event_trace_bytes": ("repro_torch.serving.load", "event_trace_bytes"),
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
