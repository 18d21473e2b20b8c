"""Int8 gradient compression with error feedback — the port of
``repro/optim/compression.py``: per-tensor symmetric max-abs scale, round
half to even (as ``jnp.round``), and the quantization residual fed back into
the next step's gradient."""
from __future__ import annotations

import torch

from repro_torch.tree import map_leaves


def compress_int8(g: torch.Tensor):
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads):
    return map_leaves(compress_int8, grads)


def ef_compress(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression step: returns (quantized, scale, new_err)."""
    corrected = g.float() + err
    q, scale = compress_int8(corrected)
    new_err = corrected - decompress_int8(q, scale)
    return q, scale, new_err
