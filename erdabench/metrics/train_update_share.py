"""Per cent of the device time of the traced unit's train steps (the
operations launched inside the program's ``train.step`` spans) taken by
the AdamW update (``train.update``).  Needs the program's spans and a
profile that keeps launch times (``erdabench.program_spans``)."""


def read(r):
    spans, p = getattr(r, "traced_spans", None), r.profile
    if not spans or not hasattr(p, "device_s_launched_in"):
        return None
    total = p.device_s_launched_in(spans, ("train.step",))
    update = p.device_s_launched_in(spans, ("train.update",))
    return 100.0 * update / total if total else None
