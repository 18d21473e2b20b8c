"""Plain PyTorch versions of the port's kernels: what the CPU runs, and what
``chip_smoke.py`` holds each kernel against on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.crc32 import check_words, make_table


def crc32_ref(data: torch.Tensor) -> torch.Tensor:
    """Batch CRC-32 by the byte-table recurrence, vectorised over rows and
    looping over bytes.  data: (N, W) 32-bit LE words -> (N,) int64 holding
    the uint32 CRCs.  The CRC is carried in int64 masked to 32 bits (torch's
    CPU build has no uint32 ``>>``)."""
    check_words(data)
    n, _w = data.shape
    table = torch.from_numpy(make_table().astype("int64")).to(data.device)
    # (4W, N): byte j of every row, contiguous per step
    cols = data.contiguous().view(torch.uint8).t().contiguous().to(torch.int64)
    crc = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=data.device)
    for col in cols:
        crc = table[(crc ^ col) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
