"""Blocked same-length self-attention as a CUDA kernel for Hopper.

The prefill attention of every layer of the served model
(``models.transformer.block_fwd`` on a CUDA tensor).  Replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``; the kernel
source, its bound and its design notes are in ``csrc/flash_attention.cu``.

Layout: q, k, v and the output are (BH, S, hd), float32 or bfloat16, with
hd in ``HEAD_DIMS`` (every head dim of the repository's configs, gemma3's
256 among them); ``ops.flash_attention`` folds (B, S, H, hd) into it.
Another head dim raises ``NotImplementedError``: the card never falls back
to the plain version.

Two routes, by dtype: bfloat16 runs on the tensor cores (wgmma, TMA), float32
on the CUDA cores (the tolerance of the float32 path rules out TF32).  Each
launch is counted under the key (BH, S, hd, dtype name), so a run shows
which route it took (``launches_by_route``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
#: torch dtype -> the kernel's dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: dtype name (the last element of a launch key) -> the route that runs it
ROUTES = {"bfloat16": "wgmma", "float32": "cuda_core"}

#: launches of the CUDA kernel (never the plain version)
COUNT = build.LaunchCount()


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (BH, S, hd) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def launches_by_route(shapes: Dict[Tuple, int]) -> Dict[str, int]:
    """Launches of each route in a ``LaunchCount.shapes`` of this kernel."""
    out = {route: 0 for route in ROUTES.values()}
    for key, n in shapes.items():
        out[ROUTES[key[-1]]] += n
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors on the current stream; (BH, S, hd)
    -> (BH, S, hd) in q's dtype; ``scale`` the softmax scale (None:
    1/sqrt(hd))."""
    check_qkv(q, k, v)
    if q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(
            f"the flash kernel is built for head_dim in {HEAD_DIMS}, got "
            f"{q.shape[-1]}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA device")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"the kernel takes float32/bfloat16, got {q.dtype}")
    q, k, v = build.aligned16(q), build.aligned16(k), build.aligned16(v)
    bh, s, hd = q.shape
    out = torch.empty_like(q)
    if out.numel():
        fn = build.load("flash_attention").flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     bh, s, hd, DTYPE_CODES[q.dtype], int(causal),
                     1.0 / math.sqrt(hd) if scale is None else scale, stream)
        if err != 0:
            raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
        COUNT.add((bh, s, hd, dtype_name(q.dtype)))
    return out
