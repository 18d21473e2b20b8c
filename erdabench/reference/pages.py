"""Plain references of the page store: a dict of what was put, and CRC-32
by zlib.  Imports nothing of the program."""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch


class DictPages:
    """The pages a sequence last put, by name.  A restore must give back
    each of them bit for bit."""

    def __init__(self):
        self.pages: Dict[Tuple[int, str], torch.Tensor] = {}

    def put(self, seq: int, name: str, page: torch.Tensor) -> None:
        self.pages[(seq, name)] = page

    def mismatches(self, seq: int, got: Dict[str, torch.Tensor]) -> int:
        """Pages of ``got`` that differ from what was put, in dtype, shape
        or any bit; a page never put counts as a mismatch."""
        bad = 0
        for name, page in got.items():
            want = self.pages.get((seq, name))
            bad += not (want is not None and want.dtype == page.dtype
                        and want.shape == page.shape
                        and torch.equal(want.to(page.device), page))
        return bad


def zlib_rows(words: torch.Tensor) -> List[int]:
    """zlib's CRC-32 of each row of an (N, W) tensor of 32-bit LE words."""
    host = np.ascontiguousarray(words.cpu().numpy().astype("<i4", copy=False))
    return [zlib.crc32(row.tobytes()) for row in host]
