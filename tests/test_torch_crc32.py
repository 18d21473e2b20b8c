"""Port's batch CRC-32 (repro_torch.kernels) against zlib and the JAX
package's table, plain version and Pallas kernel (interpret mode).  Every
check is exact."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.crc32 import crc32_pallas
from repro.kernels.crc32 import make_table as jax_make_table
from repro_torch.kernels import crc32 as tcrc
from repro_torch.kernels import ops as tops

SWEEP = [(1, 1), (4, 16), (32, 64), (128, 7), (1000, 3), (64, 32), (48, 8)]


def words(n, w, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=(n, w),
                                                dtype=np.uint32)


def as_tensor(d):
    return torch.from_numpy(d.view(np.int32))


def test_table_equals_reference_and_zlib():
    tab = tcrc.make_table()
    np.testing.assert_array_equal(tab, jax_make_table())
    for b in range(256):  # one-byte CRC through the table
        assert zlib.crc32(bytes([b])) == int(tab[b ^ 0xFF]) ^ 0xFF000000


@pytest.mark.parametrize("n,w", SWEEP)
def test_plain_matches_zlib_ref_and_pallas(n, w):
    data = words(n, w, n * 100 + w)
    got = tops.crc32_batch(as_tensor(data)).numpy()
    want = np.array([zlib.crc32(row.tobytes()) for row in data], np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jref.crc32_ref(jnp.asarray(data))))
    np.testing.assert_array_equal(
        got, np.asarray(crc32_pallas(jnp.asarray(data), interpret=True)))


def test_uint32_and_int32_words_agree():
    data = words(16, 9, 5)
    a = tops.crc32_batch(torch.from_numpy(data))
    b = tops.crc32_batch(as_tensor(data))
    assert a.dtype == torch.int64 and torch.equal(a, b)


def test_crc32_detects_any_single_bitflip():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 2**32, size=(8, 16), dtype=np.uint32)
    base = tops.crc32_batch(as_tensor(data)).numpy()
    for _trial in range(20):
        row, word, bit = rng.integers(0, 8), rng.integers(0, 16), rng.integers(0, 32)
        mutated = data.copy()
        mutated[row, word] ^= np.uint32(1 << bit)
        out = tops.crc32_batch(as_tensor(mutated)).numpy()
        assert out[row] != base[row]
        mask = np.ones(8, bool)
        mask[row] = False
        np.testing.assert_array_equal(out[mask], base[mask])


def test_bytes_batch_equals_reference():
    bufs = [b"hello world!", b"erda-object-123", b"x" * 40, b"", b"\x00\x01"]
    got = tops.crc32_bytes_batch(bufs, device="cpu")
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jops.crc32_bytes_batch(bufs))
    ln_pad = (max(len(b) for b in bufs) + 3) & ~3
    for i, b in enumerate(bufs):
        assert got[i] == zlib.crc32(b + b"\x00" * (ln_pad - len(b)))


def test_cpu_tensor_runs_plain_version_without_launching():
    before = tops.COUNTS["crc32_batch"].launches
    tops.crc32_batch(as_tensor(words(3, 2, 0)))
    assert tops.COUNTS["crc32_batch"].launches == before
    with pytest.raises(ValueError):
        tcrc.crc32_cuda(as_tensor(words(3, 2, 0)))  # never the CPU
    with pytest.raises(ValueError):
        tops.crc32_batch(torch.zeros(4, dtype=torch.int32))  # not (N, W)
