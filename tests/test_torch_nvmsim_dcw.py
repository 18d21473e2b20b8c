"""The port's NVM device counts DCW (data-comparison write) traffic in chunks
of 64-bit words; the reference ``repro.nvmsim.NVMDevice`` compares whole
writes byte by byte.  After the same writes both must hold the same bytes and
the same ``NVMStats``, field for field: the counts are the paper's metric."""
import dataclasses

import numpy as np
import pytest

from repro.nvmsim.device import NVMDevice as RefDevice
from repro.nvmsim.device import TornWrite as RefTornWrite
from repro_torch.nvmsim.device import _DCW_CHUNK, NVMDevice, TornWrite

C = _DCW_CHUNK
LENGTHS = [1, 7, 8, 9, 4095, C - 1, C, C + 1, 3 * C + 5]
SIZE = 3 * C + 256  # a multiple of 8, as write_u64_atomic needs
KINDS = (bytes, bytearray, np.asarray)


def over_everything(rng, n, addr):
    """Writes of n bytes at addr over zeros, over identical bytes, over bytes
    of which about one in seven changes, and over random bytes, each input
    type in turn."""
    first = rng.integers(0, 256, n, dtype=np.uint8)
    partly = first.copy()
    flip = rng.random(n) < 1 / 7
    partly[flip] ^= rng.integers(1, 256, int(flip.sum()), dtype=np.uint8)
    fresh = rng.integers(0, 256, n, dtype=np.uint8)
    return [("write", addr, kind(data)) for kind, data in
            zip(KINDS * 2, (first, first, partly, fresh, fresh, first))]


def torn(rng, n, addr, fraction):
    data = rng.integers(0, 256, n, dtype=np.uint8)
    return [("write", addr, data), ("tear", fraction),
            ("write", addr, bytes(rng.integers(0, 256, n, dtype=np.uint8))),
            ("write", addr, bytearray(data))]


def with_atomics(rng, n, addr):
    ops = []
    for i in range(3):
        ops.append(("write", addr, rng.integers(0, 256, n, dtype=np.uint8)))
        for a in range((addr + 7) & ~7, addr + n - 7, max(8, (n // 5) & ~7)):
            ops.append(("u64", a, int(rng.integers(0, 2**63 - 1)) | (i << 62)))
    return ops


CASES = {
    **{f"len{n}-{'odd' if addr % 2 else 'even'}":
       (lambda rng, n=n, addr=addr: over_everything(rng, n, addr))
       for n in LENGTHS for addr in (64, 131)},
    **{f"torn-len{n}-at{fraction}":
       (lambda rng, n=n, fraction=fraction: torn(rng, n, 131, fraction))
       for n, fraction in [(9, 0.5), (4095, 0.0), (C + 1, 0.999), (3 * C + 5, 0.75)]},
    **{f"atomics-len{n}":
       (lambda rng, n=n: with_atomics(rng, n, 40))
       for n in (16, 4095, 2 * C + 13)},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dcw_counts_and_bytes_equal_reference(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    port, ref = NVMDevice(SIZE), RefDevice(SIZE)
    for op in CASES[case](rng):
        if op[0] == "tear":
            port.fault.arm(0, op[1])
            ref.fault.arm(0, op[1])
        elif op[0] == "u64":
            port.write_u64_atomic(op[1], op[2])
            ref.write_u64_atomic(op[1], op[2])
        elif port.fault.armed:
            with pytest.raises(TornWrite) as got:
                port.write(op[1], op[2])
            with pytest.raises(RefTornWrite) as want:
                ref.write(op[1], op[2])
            assert (got.value.requested, got.value.persisted) == \
                (want.value.requested, want.value.persisted)
        else:
            port.write(op[1], op[2])
            ref.write(op[1], op[2])
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats), op[:2]
    assert all(type(v) is int for v in dataclasses.asdict(port.stats).values())
    assert np.array_equal(port.mem, ref.mem)
    assert port.stats.bits_programmed > 0
