"""Per cent of the window's restore time (the program's ``pages.restore``
spans) spent in the Erda client's batched CRC verify (``erda.verify``:
host packing, the copy to the card, the kernel and the compare), on the
host's clock."""
from erdabench.program_spans import seconds_inside, span_seconds


def read(r):
    spans = getattr(r, "spans", None)
    total = span_seconds(spans or (), ("pages.restore",))
    if not total:
        return None
    return 100.0 * seconds_inside(spans, ("erda.verify",), ("pages.restore",)) / total
