"""The pluggable RDMA transport seam (a copy of ``repro``'s transport): all
remote access in ``repro_torch.core`` goes through a Transport (five verbs
over a posted-WR/CQ/doorbell engine).  ``InProcessTransport`` is the
functional model; ``SimTransport`` has the same semantics plus calibrated DES
timing steps, priced per doorbell so batching amortizes (imported lazily).
"""
_LAZY = {name: ("repro_torch.fabric.transport", name)
         for name in ("MSG_BYTES", "ONE_SIDED_VERBS", "VERBS", "Handle",
                      "InProcessTransport", "OpRecord", "StaleEpochError",
                      "Transport", "WorkRequest", "make_transport")}
_LAZY.update({name: ("repro_torch.fabric.sim", name)
              for name in ("SimTransport", "replay_steps", "steps_cpu_s",
                           "steps_latency_s")})
_LAZY.update({name: ("repro_torch.netsim.contention", name)
              for name in ("OpHandle", "ServerPort", "contended_latency_us",
                           "doorbell_trace_latency_us", "replay_doorbells")})

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
