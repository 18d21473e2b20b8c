"""Per cent of the window's snapshot time (the program's ``pages.snapshot``
spans) spent inside the simulated NVM's writes (``nvm.write``, its DCW
comparison pass included), on the host's clock."""
from erdabench.program_spans import seconds_inside, span_seconds


def read(r):
    spans = getattr(r, "spans", None)
    total = span_seconds(spans or (), ("pages.snapshot",))
    if not total:
        return None
    return 100.0 * seconds_inside(spans, ("nvm.write",), ("pages.snapshot",)) / total
