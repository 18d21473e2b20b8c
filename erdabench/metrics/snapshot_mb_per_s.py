"""Cache bytes a snapshot persists over its host time (``snapshot_cache``,
ending in a device synchronise), in MB/s, over every snapshot outside the
traced slice."""


def read(r):
    calls = [(b - a, n) for name, a, b, n in r.calls if name == "snapshot_cache"]
    secs = sum(c[0] for c in calls)
    return sum(c[1] for c in calls) / secs / 1e6 if secs else None
