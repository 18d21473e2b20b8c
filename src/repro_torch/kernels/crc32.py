"""Batch CRC-32 (IEEE, reflected poly 0xEDB88320) as a CUDA kernel for Hopper.

The §4.2 verify step: Erda clients CRC-verify every fetched object and
checkpoint shard, as one batch (``core.layout.verify_records``).  Replaces
``repro/kernels/crc32.py::crc32_pallas``; the kernel source, its bound and
its design notes are in ``csrc/crc32.cu``.

Layout: data (N, W) 32-bit little-endian words (int32 or uint32), one row per
object, zero-padded to whole words; the CRC is over the padded row.  Results
are int64 tensors holding the uint32 CRC values.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

CRC_POLY = 0xEDB88320

#: launches of the CUDA kernel (never the plain version)
COUNT = build.LaunchCount()


def make_table() -> np.ndarray:
    """Standard reflected CRC-32 byte table (matches zlib)."""
    tab = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = np.uint32((c >> np.uint32(1)) ^ (CRC_POLY * (c & np.uint32(1))))
        tab[i] = c
    return tab


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
    data = data.contiguous()
    n, w = data.shape
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    if n:
        lib = build.load("crc32")
        fn = lib.crc32_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream(data.device).cuda_stream
            err = fn(data.data_ptr(), n, w, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"crc32_rows launch failed: cudaError {err}")
        COUNT.add((n, w))
    return out.to(torch.int64) & 0xFFFFFFFF
