"""Per cent of the device time of the traced unit's decode steps (the
operations launched inside the program's ``serve.decode`` spans) taken by
the operations launched inside ``decode.cache_update`` and
``decode.stack``: writing each layer's new entry into its cache and
stacking the layers' caches again.  Needs the program's spans and a
profile that keeps launch times (``erdabench.program_spans``)."""


def read(r):
    spans, p = getattr(r, "traced_spans", None), r.profile
    if not spans or not hasattr(p, "device_s_launched_in"):
        return None
    total = p.device_s_launched_in(spans, ("serve.decode",))
    copies = p.device_s_launched_in(spans, ("decode.cache_update", "decode.stack"))
    return 100.0 * copies / total if total else None
