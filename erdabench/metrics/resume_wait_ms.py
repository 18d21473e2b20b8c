"""Host milliseconds a preempted batch waits to resume: from the call into
``restore_cache`` (multi_read, CRC verify on the card, upload) to the end of
the next ``get_page``, which brings the tokens page to the host, mean over
every resume outside the traced slice."""


def read(r):
    waits, start = [], None
    for name, a, b, _n in r.calls:
        if name == "restore_cache":
            start = a
        elif name == "get_page" and start is not None:
            waits.append(b - start)
            start = None
    return 1e3 * sum(waits) / len(waits) if waits else None
