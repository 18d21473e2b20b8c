"""Per cent of the traced slice's prefill segments (the call into
``prefill`` to the first token on the host) in which the card ran
nothing (``torch.profiler``)."""


def read(r):
    return r.idle_percent("prefill")
