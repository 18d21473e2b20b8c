"""On-NVM byte layouts: the Erda object record and the 8-byte atomic word.

Paper (Figs 2-3, 6):
  normal object   = [1b delete | 32b CRC | key | value]
  deleted object  = [1b delete=1 | 32b CRC | key]
  atomic word     = [1b new_tag | 31b offset_A | 31b offset_B | 1b reserved]
    new_tag == 1  →  offset_A is the NEW version, offset_B the OLD
    new_tag == 0  →  offset_B is the NEW version, offset_A the OLD

Deviation (documented in DESIGN.md §4): the log must be self-describing for the
cleaner's scan and recovery, so our record header carries explicit lengths:

  header (11 B) = flags:u8 | crc:u32 | key_len:u16 | val_len:u32
  record        = header ++ key ++ value          (value absent when deleted)

The CRC is computed over the whole record with the CRC field zeroed — exactly
the paper's "checksum computed over the entire object".
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops

FLAG_DELETE = 0x01
HEADER_FMT = "<BIHI"  # flags, crc, key_len, val_len
HEADER_SIZE = struct.calcsize(HEADER_FMT)  # 11
assert HEADER_SIZE == 11
KEY_BYTES = 8  # u64 object keys

NULL_OFF = (1 << 31) - 1  # 31-bit null offset sentinel
_OFF_MASK = (1 << 31) - 1


def key_bytes(key: int) -> bytes:
    return struct.pack("<Q", key & 0xFFFFFFFFFFFFFFFF)


def record_crc(flags: int, key: bytes, value: bytes) -> int:
    hdr = struct.pack(HEADER_FMT, flags, 0, len(key), len(value))
    return zlib.crc32(hdr + key + value) & 0xFFFFFFFF


def pack_record(key: int, value: Optional[bytes], *, delete: bool = False) -> bytes:
    kb = key_bytes(key)
    vb = b"" if (delete or value is None) else bytes(value)
    flags = FLAG_DELETE if delete else 0
    crc = record_crc(flags, kb, vb)
    return struct.pack(HEADER_FMT, flags, crc, len(kb), len(vb)) + kb + vb


def record_size(val_len: int, *, delete: bool = False) -> int:
    return HEADER_SIZE + KEY_BYTES + (0 if delete else val_len)


@dataclasses.dataclass
class RecordView:
    ok: bool            # CRC verified
    deleted: bool
    key: int
    value: Optional[bytes]
    size: int           # total record bytes on NVM
    offset: int


def parse_record(buf, offset: int = 0, *, max_len: Optional[int] = None) -> RecordView:
    """Parse + CRC-verify a record from a byte buffer.  Never throws on torn
    data — returns ok=False, which is precisely the signal Erda's readers use.
    Only the record's own bytes are copied (callers hand us the whole device)."""
    n = buf.size if isinstance(buf, np.ndarray) else len(buf)
    end = n if max_len is None else min(n, offset + max_len)
    bad = RecordView(False, False, 0, None, 0, offset)
    if offset < 0 or offset + HEADER_SIZE > end:
        return bad
    hdr = bytes(buf[offset : offset + HEADER_SIZE])
    flags, crc, key_len, val_len = struct.unpack(HEADER_FMT, hdr)
    deleted = bool(flags & FLAG_DELETE)
    body = key_len if deleted else key_len + val_len
    if key_len != KEY_BYTES or offset + HEADER_SIZE + body > end:
        return bad
    kb = bytes(buf[offset + HEADER_SIZE : offset + HEADER_SIZE + key_len])
    vb = b"" if deleted else bytes(
        buf[offset + HEADER_SIZE + key_len : offset + HEADER_SIZE + key_len + val_len]
    )
    expect = record_crc(flags, kb, vb)
    if expect != crc:
        return bad
    key = struct.unpack("<Q", kb)[0]
    size = HEADER_SIZE + key_len + (0 if deleted else val_len)
    return RecordView(True, deleted, key, None if deleted else vb, size, offset)


# ------------------------------------------------------------------ atomic word
def pack_word(new_tag: int, off_new: int, off_old: int) -> int:
    """Paper's flip rule: tag==1 → new offset goes in region A (first 31 bits);
    tag==0 → new offset goes in region B."""
    if new_tag == 1:
        off_a, off_b = off_new, off_old
    else:
        off_a, off_b = off_old, off_new
    return ((new_tag & 1) << 63) | ((off_a & _OFF_MASK) << 32) | ((off_b & _OFF_MASK) << 1)


def unpack_word(word: int):
    """Returns (new_tag, off_new, off_old)."""
    tag = (word >> 63) & 1
    off_a = (word >> 32) & _OFF_MASK
    off_b = (word >> 1) & _OFF_MASK
    return (tag, off_a, off_b) if tag == 1 else (tag, off_b, off_a)


def flip_word(word: int, new_offset: int) -> int:
    """One update = flip the tag + write the new offset into the region the
    flipped tag selects; the previous 'new' becomes 'old' *without being
    rewritten* (DCW skips it) — the paper's write-optimized metadata update."""
    tag, off_new, _off_old = unpack_word(word)
    return pack_word(1 - tag, new_offset, off_new)


# ------------------------------------------------------- batched CRC verify
def verify_records(bufs, device) -> np.ndarray:
    """``[parse_record(b).ok for b in bufs]`` with the CRCs computed as one
    batch by ``kernels.ops.crc32_batch`` on ``device``.

    The header is checked on the host.  Each record that passes becomes one
    row: its bytes with the CRC field zeroed (and, for a tombstone, the value
    length too — ``record_crc`` hashes a deleted record with val_len 0),
    zero-padded to whole words of the widest row.  Appending p zero bytes maps
    CRC values one-to-one, so the row's padded CRC equals
    ``zlib.crc32(b"\\0" * p, stored)`` exactly when the record's own CRC
    equals the stored one: the verdict is exact, not probabilistic."""
    ok = np.zeros(len(bufs), dtype=bool)
    rows = []  # (index, record bytes, deleted, stored crc)
    for i, buf in enumerate(bufs):
        if len(buf) < HEADER_SIZE:
            continue
        flags, crc, key_len, val_len = struct.unpack_from(HEADER_FMT, buf, 0)
        deleted = bool(flags & FLAG_DELETE)
        nbytes = HEADER_SIZE + key_len + (0 if deleted else val_len)
        if key_len == KEY_BYTES and nbytes <= len(buf):
            rows.append((i, nbytes, deleted, crc))
    if not rows:
        return ok
    width = (max(r[1] for r in rows) + 3) & ~3
    arr = np.zeros((len(rows), width), dtype=np.uint8)
    for r, (i, nbytes, _deleted, _stored) in enumerate(rows):
        arr[r, :nbytes] = np.frombuffer(bufs[i], dtype=np.uint8, count=nbytes)
    arr[:, 1:5] = 0  # the CRC field is hashed as zero
    dels = [r for r, row in enumerate(rows) if row[2]]
    arr[dels, 7:11] = 0
    words = torch.from_numpy(arr.view("<i4"))
    crcs = ops.crc32_batch(words.to(device)).cpu().numpy()
    zeros = memoryview(bytes(width))
    for r, (i, nbytes, _deleted, stored) in enumerate(rows):
        ok[i] = int(crcs[r]) == zlib.crc32(zeros[: width - nbytes], stored)
    return ok


def view_record(buf, ok: bool) -> RecordView:
    """``parse_record(buf)`` for a buffer whose CRC verdict ``ok`` came from
    ``verify_records``: only the parse, no second CRC."""
    if not ok:
        return RecordView(False, False, 0, None, 0, 0)
    flags, _crc, key_len, val_len = struct.unpack_from(HEADER_FMT, buf, 0)
    deleted = bool(flags & FLAG_DELETE)
    key = struct.unpack_from("<Q", buf, HEADER_SIZE)[0]
    start = HEADER_SIZE + key_len
    value = None if deleted else bytes(buf[start : start + val_len])
    size = HEADER_SIZE + key_len + (0 if deleted else val_len)
    return RecordView(True, deleted, key, value, size, 0)
