"""Erda checkpoint manager over tensor trees (imported lazily)."""
_LAZY = {
    "ErdaCheckpointManager": ("repro_torch.checkpoint.erda_ckpt",
                              "ErdaCheckpointManager"),
    "leaf_from_bytes": ("repro_torch.checkpoint.serialization",
                        "leaf_from_bytes"),
    "leaf_to_bytes": ("repro_torch.checkpoint.serialization", "leaf_to_bytes"),
    "tree_from_numpy": ("repro_torch.checkpoint.serialization",
                        "tree_from_numpy"),
    "tree_to_numpy": ("repro_torch.checkpoint.serialization", "tree_to_numpy"),
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
