"""Per cent of the traced slice's decode segments in which the card ran
nothing (``torch.profiler``)."""


def read(r):
    return r.idle_percent("decode")
