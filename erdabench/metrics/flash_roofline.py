"""Per cent of its roofline that the flash kernel reaches in the traced
slice: the frozen ``counts.flash_bound_ms`` of every launched shape (the
program's ``LaunchCount`` of the kernel) over the device time of the
``flash_fwd`` kernels in the trace."""
from erdabench import counts


def read(r):
    shapes = r.counters.get("flash_shapes")
    if r.profile is None or not shapes:
        return None
    bound_ms = sum(n * counts.flash_bound_ms(bh, s, hd, dt)[0]
                   for (bh, s, hd, dt), n in shapes.items())
    device_s = r.profile.device_s("flash_fwd")
    return 100.0 * bound_ms / 1e3 / device_s if device_s else None
