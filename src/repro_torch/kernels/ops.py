"""Public wrappers around the port's kernels.

A wrapper runs the kernel's plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import build, crc32, ref

#: wrapper name -> its kernel's launch count
COUNTS: Dict[str, build.LaunchCount] = {"crc32_batch": crc32.COUNT}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.reset()


def crc32_batch(data: torch.Tensor) -> torch.Tensor:
    """CRC-32 of each row of an (N, W) tensor of 32-bit LE words -> (N,)
    int64 tensor of the uint32 values, on ``data``'s device."""
    crc32.check_words(data)
    if data.device.type == "cpu":
        return ref.crc32_ref(data)
    if data.device.type == "cuda":
        return crc32.crc32_cuda(data)
    raise ValueError(f"crc32_batch: unsupported device {data.device}")


def crc32_bytes_batch(buffers, device="cuda") -> np.ndarray:
    """List of byte strings -> uint32 CRCs.  Pads each to the widest
    buffer's whole words with zeros; the CRC is over the padded buffer (the
    reference's semantics)."""
    n = len(buffers)
    ln = max(len(b) for b in buffers)
    ln_pad = (ln + 3) & ~3
    arr = np.zeros((n, ln_pad), np.uint8)
    for i, b in enumerate(buffers):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
    words = torch.from_numpy(arr.view("<i4")).to(resolve_device(device))
    return crc32_batch(words).cpu().numpy().astype(np.uint32)
