"""Cache bytes a restore brings back to the card over its host time
(``restore_cache``: multi_read, CRC verify, upload, ending in a device
synchronise), in MB/s, over every restore outside the traced slice."""


def read(r):
    calls = [(b - a, n) for name, a, b, n in r.calls if name == "restore_cache"]
    secs = sum(c[0] for c in calls)
    return sum(c[1] for c in calls) / secs / 1e6 if secs else None
