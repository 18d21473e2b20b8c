"""The pluggable RDMA transport seam (a copy of ``repro``'s transport).

Only the functional ``InProcessTransport`` is ported in slice 1; the DES
``SimTransport`` (``fabric/sim.py`` + ``netsim/``) comes with a later slice.
"""
_LAZY = {name: ("repro_torch.fabric.transport", name)
         for name in ("MSG_BYTES", "ONE_SIDED_VERBS", "VERBS", "Handle",
                      "InProcessTransport", "OpRecord", "StaleEpochError",
                      "Transport", "WorkRequest", "make_transport")}

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
