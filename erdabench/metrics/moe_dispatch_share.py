"""Per cent of the device time of the traced unit's prefills (the
operations launched inside the program's ``serve.prefill`` spans) taken by
MoE routing, dispatch and combine (``moe.route``, ``moe.dispatch``,
``moe.combine``): the MoE layers' work other than the experts' matmuls.
Needs the program's spans and a profile that keeps launch times
(``erdabench.program_spans``)."""


def read(r):
    spans, p = getattr(r, "traced_spans", None), r.profile
    if not any(s.name == "moe.route" for s in spans or ()) \
            or not hasattr(p, "device_s_launched_in"):
        return None
    total = p.device_s_launched_in(spans, ("serve.prefill",))
    moe = p.device_s_launched_in(spans, ("moe.route", "moe.dispatch", "moe.combine"))
    return 100.0 * moe / total if total else None
