"""Per cent of the (token, expert) pairs routed in the traced unit's
prefills that the GShard dispatch dropped past their expert's capacity:
the program's ``moe.dropped`` over ``moe.pairs``, counted in the
``serve.prefill`` spans."""


def read(r):
    spans = [s for s in getattr(r, "traced_spans", None) or () if s.name == "serve.prefill"]
    pairs = sum(s.counts.get("moe.pairs", 0) for s in spans)
    if not pairs:
        return None
    return 100.0 * sum(s.counts.get("moe.dropped", 0) for s in spans) / pairs
