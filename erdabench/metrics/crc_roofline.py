"""Per cent of its roofline that the CRC kernel reaches in the traced
slice's resumes: the frozen ``counts.crc_bound_ms`` of every launched
(rows, words) batch over the device time of the ``crc32_`` kernels."""
from erdabench import counts


def read(r):
    shapes = r.counters.get("crc_shapes")
    if r.profile is None or not shapes:
        return None
    bound_ms = sum(k * counts.crc_bound_ms(n, w)[0] for (n, w), k in shapes.items())
    device_s = r.profile.device_s("crc32_")
    return 100.0 * bound_ms / 1e3 / device_s if device_s else None
