"""Per cent of the traced slice's train steps (call to the loss on the
host) in which the card ran nothing (``torch.profiler``)."""


def read(r):
    return r.idle_percent("step")
