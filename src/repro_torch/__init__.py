"""PyTorch/CUDA port of the Erda store (``repro``) for NVIDIA Hopper.

Slice 1 covers the paper's main path — write an object one-sided, commit it
with the 8-byte atomic flip, read it back with a CRC check that falls back to
the old version when the write was torn (§4.2) — for the two users of the
store: the KV page store (``repro_torch.serving``) and the checkpoint
manager (``repro_torch.checkpoint``).  The framework-neutral protocol modules
are copies of the reference's; the client-side CRC verify of every fetched
object runs as one batch through the hand-written CUDA kernel in
``repro_torch.kernels``.

Entry points take ``device`` and default to ``"cuda"``: without a card they
raise ``RuntimeError``; ``device="cpu"`` runs the kernels' plain PyTorch
versions.  Subpackages are imported lazily.
"""
_LAZY = {
    "ErdaCheckpointManager": ("repro_torch.checkpoint", "ErdaCheckpointManager"),
    "ErdaKVPageStore": ("repro_torch.serving", "ErdaKVPageStore"),
    "make_store": ("repro_torch.core", "make_store"),
    "resolve_device": ("repro_torch._device", "resolve_device"),
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
