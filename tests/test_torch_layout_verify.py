"""The port's batched CRC verify (``verify_records`` + ``view_record``) gives
exactly the reference's ``parse_record(b).ok`` and record fields."""
import dataclasses
import struct

import numpy as np
import pytest

from repro.core import layout as rlayout
from repro_torch.core import layout as tlayout


def tombstone_with_val_len(key, val_len):
    """A valid tombstone whose header's val_len field is non-zero: the CRC
    hashes a deleted record with val_len 0, so it still verifies."""
    rec = bytearray(rlayout.pack_record(key, None, delete=True))
    struct.pack_into("<I", rec, 7, val_len)
    return bytes(rec)


def corpus(seed=0):
    rng = np.random.default_rng(seed)
    bufs = []
    for n in (0, 1, 3, 4, 5, 13, 64, 257):
        val = rng.bytes(n)
        rec = rlayout.pack_record(int(rng.integers(1, 2**63)), val)
        bufs.append(rec)                                  # valid
        bufs.append(rec + rng.bytes(int(rng.integers(1, 40))))  # read past the end
        bufs.append(rec[: len(rec) // 2] + bytes(len(rec) - len(rec) // 2))  # torn
        bufs.append(rec[:-1])                             # truncated
        for _ in range(3):                                # one bit flipped
            flip = bytearray(rec)
            flip[int(rng.integers(0, len(rec)))] ^= 1 << int(rng.integers(0, 8))
            bufs.append(bytes(flip))
    dead = rlayout.pack_record(77, None, delete=True)
    bufs += [dead, dead + b"\x00" * 9, tombstone_with_val_len(78, 1000),
             tombstone_with_val_len(79, 3)]
    flip = bytearray(dead)
    flip[15] ^= 0x10
    bufs.append(bytes(flip))
    bad_klen = bytearray(rlayout.pack_record(5, b"abc"))
    struct.pack_into("<H", bad_klen, 5, 7)
    bufs += [bytes(bad_klen), b"", b"\x00" * 5, bytes(4096)]
    return bufs


def test_verdicts_equal_parse_record_in_one_batch():
    bufs = corpus()
    want = [rlayout.parse_record(np.frombuffer(b, np.uint8), 0).ok for b in bufs]
    got = tlayout.verify_records(bufs, "cpu")
    assert got.dtype == bool and list(got) == want
    assert any(want) and not all(want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_verdicts_equal_one_at_a_time(seed):
    for b in corpus(seed):
        want = rlayout.parse_record(np.frombuffer(b, np.uint8), 0)
        ok = tlayout.verify_records([b], "cpu")[0]
        assert ok == want.ok
        got = tlayout.view_record(b, ok)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_numpy_buffers_verify_like_bytes():
    bufs = corpus(4)
    as_np = [np.frombuffer(b, np.uint8) for b in bufs]
    np.testing.assert_array_equal(tlayout.verify_records(as_np, "cpu"),
                                  tlayout.verify_records(bufs, "cpu"))


def test_empty_batch_launches_nothing():
    assert tlayout.verify_records([], "cpu").shape == (0,)
    assert list(tlayout.verify_records([b"", b"\x01" * 10], "cpu")) == [False, False]
