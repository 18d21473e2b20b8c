"""Simulated NVM device (a copy of ``repro``'s: host numpy memory)."""
_LAZY = {name: ("repro_torch.nvmsim.device", name)
         for name in ("NVMDevice", "NVMStats", "TornWrite", "FaultInjector")}

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
