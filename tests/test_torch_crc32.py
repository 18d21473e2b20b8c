"""Port's batch CRC-32 (repro_torch.kernels) against zlib and the JAX
package's table, plain version and Pallas kernel (interpret mode).  Every
check is exact."""
import re
import zlib
from pathlib import Path

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


# ---------------------------------------------------------------------------
# A numpy model of csrc/crc32.cu's decomposition, step for step: 16-byte
# units aligned to the tensor, chunks counted back from each row's last unit,
# pieces CRC'd raw with the slice-by-16 tables, the in-block and per-row
# x^(8*len) combines, the trailing-zero inverse and the init/final terms.
# ``threads``/``piece_units``/``combine_threads`` default to the kernel's.

def _mult(a, b):
    """a * b mod P, elementwise over uint32 arrays (reflected)."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32).copy()
    a, b = np.broadcast_arrays(a, b)
    b = b.copy()
    p = np.zeros(a.shape, np.uint32)
    for i in range(32):
        p ^= np.where((a >> np.uint32(31 - i)) & np.uint32(1), b, np.uint32(0))
        b = (b >> np.uint32(1)) ^ np.where(b & np.uint32(1),
                                           np.uint32(tcrc.CRC_POLY), np.uint32(0))
    return p


def _step16(tab, crc, v):
    """Raw CRC state ``crc`` over the 16 bytes of units v[..., 0:4]."""
    a = v[..., 0] ^ crc
    out = np.zeros_like(crc)
    for w, word in enumerate([a, v[..., 1], v[..., 2], v[..., 3]]):
        for b in range(4):
            out ^= tab[15 - 4 * w - b][(word >> np.uint32(8 * b)) & np.uint32(0xFF)]
    return out


def crc_model(data, threads=256, piece_units=8, combine_threads=128):
    """(N, W) uint32 -> (N,) uint32 CRC-32s, computed as the kernel does."""
    n, w = data.shape
    flat = np.concatenate([data.ravel(), np.zeros(4, np.uint32)])
    tables = tcrc.kernel_tables()
    tab = tables[:4096].reshape(16, 256)
    x2n = [int(x) for x in tables[4096:4128]]
    inv = [int(x) for x in tables[4128:4132]]
    xpow = lambda e: tcrc.x_pow(e)
    chunk_units = threads * piece_units
    n_chunks = -(-(-(-w // 4) + 1) // chunk_units)
    if chunk_units == tcrc.CHUNK_UNITS:
        assert n_chunks == tcrc.n_chunks(w)
    rows = np.arange(n, dtype=np.int64)
    bw, ew = rows * w, rows * w + w
    u_end = (ew + 3) >> 2
    # pass 1: units (row, chunk, thread, unit) -> their 4 words, masked
    c = np.arange(n_chunks)[None, :, None, None]
    t = np.arange(threads)[None, None, :, None]
    i = np.arange(piece_units)[None, None, None, :]
    u = (u_end[:, None, None, None] - (n_chunks - c) * chunk_units
         + t * piece_units + i)
    g = 4 * u[..., None] + np.arange(4)
    live = (g >= bw[:, None, None, None, None]) & (g < ew[:, None, None, None, None])
    units = np.where(live, flat[np.clip(g, 0, len(flat) - 1)], np.uint32(0))
    crc = np.zeros(units.shape[:3], np.uint32)
    for k in range(piece_units):
        crc = _step16(tab, crc, units[:, :, :, k])
    after = np.array([xpow(8 * 16 * piece_units * (threads - 1 - tt))
                      for tt in range(threads)], np.uint32)
    chunk_crc = np.bitwise_xor.reduce(_mult(after[None, None, :], crc), axis=2)
    # pass 2: thread tt takes chunks [tt*per, (tt+1)*per) of the front-padded list
    per = -(-n_chunks // combine_threads)
    pad = per * combine_threads - n_chunks
    padded = np.concatenate([np.zeros((n, pad), np.uint32), chunk_crc], axis=1)
    m_chunk = xpow(8 * 16 * chunk_units)
    acc = np.zeros((n, combine_threads), np.uint32)
    for j in range(per):
        acc = _mult(m_chunk, acc) ^ padded[:, j::per][:, :combine_threads]
    mult_t = np.array([xpow(8 * 16 * chunk_units * per * (combine_threads - 1 - tt))
                       for tt in range(combine_threads)], np.uint32)
    raw = np.bitwise_xor.reduce(_mult(mult_t[None, :], acc), axis=1)
    e = 4 * u_end - ew
    raw = _mult(np.array([inv[k] for k in e], np.uint32), raw)
    init = np.uint32(tcrc.mult_mod_p(xpow(8 * 4 * w), 0xFFFFFFFF))
    assert x2n == tcrc.x2n_table()
    return raw ^ init ^ np.uint32(0xFFFFFFFF)


def _zlib_rows(data):
    return np.array([zlib.crc32(r.tobytes()) for r in data], np.uint32)


def test_kernel_tables():
    tables = tcrc.kernel_tables()
    assert tables.dtype == np.uint32 and tables.shape == (16 * 256 + 36,)
    tab = tables[:4096].reshape(16, 256)
    np.testing.assert_array_equal(tab[0], tcrc.make_table())
    # row k: byte i then k zero bytes, by the byte recurrence
    for k in (1, 7, 15):
        for i in (0, 1, 0x5A, 0xFF):
            c = int(tab[0][i])
            for _ in range(k):
                c = int(tab[0][c & 0xFF]) ^ (c >> 8)
            assert c == int(tab[k][i])
    # x^(2^k) has period 32 and x^(-32e) * x^(32e) = 1
    x2n = tcrc.x2n_table()
    assert tcrc.mult_mod_p(x2n[31], x2n[31]) == x2n[0]
    for e in range(4):
        assert tcrc.mult_mod_p(int(tables[4128 + e]), tcrc.x_pow(32 * e)) == 1 << 31


def test_combine_matches_zlib_combine():
    rng = np.random.default_rng(3)
    a, b = rng.bytes(37), rng.bytes(1001)
    raw = lambda x: zlib.crc32(x) ^ tcrc.mult_mod_p(tcrc.x_pow(8 * len(x)), 0xFFFFFFFF) ^ 0xFFFFFFFF
    assert raw(a + b) == tcrc.mult_mod_p(tcrc.x_pow(8 * len(b)), raw(a)) ^ raw(b)


@pytest.mark.parametrize("n,w", [(1, 1), (8, 1), (5, 3), (3, 16401),
                                 (2, 8188), (2, 8189), (2, 8191), (2, 8192),
                                 (3, 8193), (1, 0)])
def test_model_at_kernel_constants_matches_zlib_and_ref(n, w):
    data = words(n, w, 7 * n + w)
    got = crc_model(data)
    np.testing.assert_array_equal(got, _zlib_rows(data))
    if w:
        np.testing.assert_array_equal(got, np.asarray(jref.crc32_ref(jnp.asarray(data))))


@pytest.mark.parametrize("n,w", [(1, 1000), (4, 1001), (7, 257), (3, 2)])
def test_model_with_many_chunks_a_thread_matches_zlib(n, w):
    """Small chunks, so pass 2's threads each Horner several chunks."""
    data = words(n, w, w)
    got = crc_model(data, threads=4, piece_units=2, combine_threads=4)
    np.testing.assert_array_equal(got, _zlib_rows(data))
    np.testing.assert_array_equal(got, np.asarray(jref.crc32_ref(jnp.asarray(data))))


def test_kernel_constants_match_the_source():
    """The chunk size the wrapper sizes scratch by is the kernel's."""
    src = (Path(tcrc.__file__).parent / "csrc" / "crc32.cu").read_text()
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    piece = int(re.search(r"kPieceUnits = (\d+);", src).group(1))
    assert threads * piece == tcrc.CHUNK_UNITS
    assert [tcrc.n_chunks(w) for w in (0, 1, 8188, 8189, 8192, 16401)] == [1, 1, 1, 2, 2, 3]
