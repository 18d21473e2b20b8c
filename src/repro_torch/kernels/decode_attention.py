"""Single-token attention against a KV cache as a CUDA kernel for Hopper.

Every decode step's attention on the card (``ops.decode_attention``, which
``models.transformer.decode_attention`` picks for a CUDA tensor in
``block_decode`` and the encoder-decoder's decoder).
Replaces no Pallas kernel: the JAX package's decode attention is plain
``jnp``; its plain version here is ``models.layers.attention.
decode_attention``.  The kernel source, its bound and its design notes are
in ``csrc/decode_attention.cu``.

Layout: q (B, 1, H, hd); caches (B, C, KV, hd), contiguous (a layer's slice
of the stacked cache is, and is never copied), one dtype with q, float32 or
bfloat16; ``kv_positions`` (C,) int32 and ``pos`` a 0-d int32 tensor, both
on the card (the kernel reads ``pos`` there: no host sync).  hd is one of
``HEAD_DIMS`` and the group H / KV at most ``MAX_GROUP``; anything else
raises, the card never falls back to the plain version.

A (batch row, KV head) pair is one block of the kernel, or ``split_count``
blocks over its slots when the pairs are too few to fill the card; the
split depends on the shapes and the card's SM count alone.  Each launch is
counted under the key (B, C, KV, G, hd, splits, dtype name).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES, HEAD_DIMS, dtype_name

#: query heads a KV head may serve (the kernel rounds G up to 1, 2, 4 or 8)
MAX_GROUP = 8
#: blocks an SM is given when pairs are split over their slots
BLOCKS_PER_SM = 4
#: fewest slots a split takes
MIN_SPLIT_SLOTS = 128

#: launches of the CUDA kernel (never the plain version)
COUNT = build.LaunchCount()
_DTYPE_NAMES = {dt: dtype_name(dt) for dt in DTYPE_CODES}


def split_count(pairs: int, slots: int, sms: int) -> int:
    """Blocks each (batch row, KV head) pair is split into over its
    ``slots``: one while the pairs alone give every SM a block, else enough
    for about ``BLOCKS_PER_SM`` blocks an SM, each of at least
    ``MIN_SPLIT_SLOTS`` slots.  The kernel gives each split ceil(slots /
    splits) slots; the count is trimmed so that the last gets some."""
    if pairs >= sms:
        return 1
    want = max(1, min(-(-BLOCKS_PER_SM * sms // pairs), slots // MIN_SPLIT_SLOTS))
    return -(-slots // -(-slots // want))


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry():
    """The library's launch function with its argument types (built at
    first use)."""
    fn = build.load("decode_attention").decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5 + [
        ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_args(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               kv_positions: torch.Tensor, pos: torch.Tensor) -> None:
    """Raise on what the kernel does not take; the checks read shapes,
    dtypes and strides only, so they run on any device."""
    qs, ks = q.shape, k_cache.shape
    if len(qs) != 4 or qs[1] != 1:
        raise ValueError(f"expected q of (B, 1, H, hd), got {tuple(qs)}")
    b, _, h, hd = qs
    if len(ks) != 4 or ks != v_cache.shape or ks[0] != b or ks[3] != hd:
        raise ValueError(f"expected caches of (B, C, KV, hd) = ({b}, C, KV, {hd}), got "
                         f"{tuple(ks)}, {tuple(v_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise NotImplementedError(
            f"the decode kernel is built for head_dim in {HEAD_DIMS}, got {hd}")
    c, kv = ks[1], ks[2]
    if c == 0 or h % kv or not 1 <= h // kv <= MAX_GROUP:
        raise ValueError(f"{h} query heads over {kv} KV heads and {c} slots: the kernel "
                         f"takes groups of 1 to {MAX_GROUP} and at least one slot")
    if not q.dtype == k_cache.dtype == v_cache.dtype or q.dtype not in DTYPE_CODES:
        raise ValueError(f"q and caches must share float32 or bfloat16, got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the caches must be contiguous: the kernel reads a layer's "
                         "cache in place")
    if kv_positions.shape != (c,) or kv_positions.dtype != torch.int32:
        raise ValueError(f"expected kv_positions of ({c},) int32, got "
                         f"{tuple(kv_positions.shape)} {kv_positions.dtype}")
    if not isinstance(pos, torch.Tensor) or pos.numel() != 1 or pos.dtype != torch.int32:
        raise ValueError("pos must be a one-element int32 tensor on the card")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          kv_positions: torch.Tensor, pos: torch.Tensor, *,
                          window: int = 0, scale=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors on the current stream -> (B, 1, H,
    hd) in q's dtype; ``window`` > 0 also masks positions at or before pos -
    window; ``scale`` the softmax scale (None: 1/sqrt(hd))."""
    check_args(q, k_cache, v_cache, kv_positions, pos)
    dev = q.get_device()  # -1 off the card
    if dev < 0 or any(t.get_device() != dev for t in (k_cache, v_cache, kv_positions, pos)):
        raise ValueError("decode_attention_cuda needs every tensor on one CUDA device")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("the caches must start 16-byte aligned")
    b, _, h, hd = q.shape
    _, c, kv, _ = k_cache.shape
    g = h // kv
    q = build.aligned16(q)
    kv_positions, pos = kv_positions.contiguous(), pos.contiguous()
    splits = split_count(b * kv, c, sm_count(dev))
    out = torch.empty_like(q)
    ws = q.new_empty(b * kv * splits * g * (hd + 2), dtype=torch.float32) if splits > 1 else None
    if out.numel():
        args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_positions.data_ptr(),
                pos.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
                b, c, kv, g, hd, DTYPE_CODES[q.dtype], splits, int(window),
                1.0 / math.sqrt(hd) if scale is None else scale)
        if dev == torch.cuda.current_device():
            err = _entry()(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(dev):
                err = _entry()(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_attention_fwd launch failed: cudaError {err}")
        COUNT.add((b, c, kv, g, hd, splits, _DTYPE_NAMES[q.dtype]))
    return out
