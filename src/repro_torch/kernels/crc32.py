"""Batch CRC-32 (IEEE, reflected poly 0xEDB88320) as a CUDA kernel for Hopper.

The §4.2 verify step: Erda clients CRC-verify every fetched object and
checkpoint shard, as one batch (``core.layout.verify_records``).  Replaces
``repro/kernels/crc32.py::crc32_pallas``; the kernel source, its bound and
its design notes are in ``csrc/crc32.cu``.

Layout: data (N, W) 32-bit little-endian words (int32 or uint32), one row per
object, zero-padded to whole words; the CRC is over the padded row.  Results
are int64 tensors holding the uint32 CRC values.

The kernel cuts rows into chunks whose zero-initialised CRCs it combines by
GF(2) multiplication (zlib's ``crc32_combine``); the constants it needs —
slice-by-16 tables, x^(2^k) and x^(-32e) mod P — are made here with numpy
(``kernel_tables``) and copied to each device once.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import numpy as np
import torch

from repro_torch.kernels import build

CRC_POLY = 0xEDB88320
#: 16-byte units a chunk of the kernel's first pass covers (csrc/crc32.cu
#: kChunkUnits: 256 threads x 8 units, 32 KiB)
CHUNK_UNITS = 2048

#: launches of the CUDA kernel (never the plain version)
COUNT = build.LaunchCount()
#: device -> kernel_tables() on that device
_TABLES: Dict[torch.device, torch.Tensor] = {}


def make_table() -> np.ndarray:
    """Standard reflected CRC-32 byte table (matches zlib)."""
    tab = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = np.uint32((c >> np.uint32(1)) ^ (CRC_POLY * (c & np.uint32(1))))
        tab[i] = c
    return tab


def slice_tables(slices: int = 16) -> np.ndarray:
    """(slices, 256) tables: row k is the raw CRC of byte i followed by k
    zero bytes (row 0 is ``make_table``), for slice-by-``slices``."""
    tabs = [make_table()]
    for _ in range(1, slices):
        prev = tabs[-1]
        tabs.append((prev >> np.uint32(8)) ^ tabs[0][prev & np.uint32(0xFF)])
    return np.stack(tabs)


def mult_mod_p(a: int, b: int) -> int:
    """a * b mod P in zlib's reflected representation (bit 31 is x^0)."""
    p = 0
    for i in range(32):
        if (a >> (31 - i)) & 1:
            p ^= b
        b = (b >> 1) ^ CRC_POLY if b & 1 else b >> 1
    return p


def x2n_table() -> List[int]:
    """x^(2^k) mod P for k < 32; the sequence has period 32."""
    tab = [1 << 30]  # x^1
    for _ in range(31):
        tab.append(mult_mod_p(tab[-1], tab[-1]))
    return tab


def x_pow(n: int) -> int:
    """x^n mod P."""
    x2n, p, k = x2n_table(), 1 << 31, 0
    while n:
        if n & 1:
            p = mult_mod_p(x2n[k & 31], p)
        n >>= 1
        k += 1
    return p


def kernel_tables() -> np.ndarray:
    """The kernel's constants, as uint32: the (16, 256) slice tables, then
    x^(2^k) mod P for k < 32, then x^(-32e) mod P for e < 4 (x^(2^32-1) is 1
    mod P, so x^(-n) = x^(2^32-1-n))."""
    inv = [x_pow((1 << 32) - 1 - 32 * e) for e in range(4)]
    return np.concatenate([slice_tables().ravel(),
                           np.array(x2n_table() + inv, np.uint32)])


def n_chunks(n_words: int) -> int:
    """Chunks the kernel cuts each row of ``n_words`` words into: the row's
    16-byte units, one more for a row that starts mid-unit, in whole
    chunks."""
    return -(-(-(-n_words // 4) + 1) // CHUNK_UNITS)


def device_tables(device: torch.device) -> torch.Tensor:
    tabs = _TABLES.get(device)
    if tabs is None:
        tabs = torch.from_numpy(kernel_tables().view(np.int32)).to(device)
        _TABLES[device] = tabs
    return tabs


def check_words(data: torch.Tensor) -> None:
    if data.dim() != 2 or data.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"expected an (N, W) int32/uint32 tensor, got "
                         f"{tuple(data.shape)} {data.dtype}")


def crc32_cuda(data: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on ``data`` (a CUDA tensor) on the current stream;
    (N, W) words -> (N,) int64 CRCs."""
    check_words(data)
    if not data.is_cuda:
        raise ValueError("crc32_cuda needs a CUDA tensor")
    data = build.aligned16(data)
    n, w = data.shape
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    if n:
        chunks = n_chunks(w)
        scratch = torch.empty(n * chunks, dtype=torch.int32, device=data.device)
        tables = device_tables(data.device)
        fn = build.load("crc32").crc32_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64] + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            err = fn(data.data_ptr(), n, w, chunks, tables.data_ptr(),
                     scratch.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"crc32_rows launch failed: cudaError {err}")
        COUNT.add((n, w))
    return out.to(torch.int64) & 0xFFFFFFFF
