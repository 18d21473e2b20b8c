"""Host milliseconds of a decode step: each from the call into the model's
``decode_step`` to the next wrapped call (the token's argmax and copy to
the host included), over every step outside the traced slice."""


def read(r):
    n = r.count("decode")
    return 1e3 * r.seconds("decode") / n if n else None
