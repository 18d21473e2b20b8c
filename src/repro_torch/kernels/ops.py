"""Public wrappers around the port's kernels.

A wrapper runs the kernel's plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises.  ``decode_attention``
takes CUDA tensors alone: its plain version is the model layer's
(``models.layers.attention.decode_attention``), and its callers pick one of
the two by device (``models.transformer.decode_attention``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import build, crc32, decode_attention as decode, ref
from repro_torch.kernels import flash_attention as flash
from repro_torch.sharding.rules import local_heads

#: wrapper name -> its kernel's launch count
COUNTS: Dict[str, build.LaunchCount] = {"crc32_batch": crc32.COUNT,
                                        "flash_attention": flash.COUNT,
                                        "decode_attention": decode.COUNT}


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale=None) -> torch.Tensor:
    """Same-length self-attention over (B, S, H, hd) with H == KV heads
    (callers repeat KV for GQA) -> (B, S, H, hd), in q's dtype, with softmax
    scale ``scale`` (None: 1/sqrt(hd)).  Forward
    only: the kernel writes through a raw pointer, so its output has no
    gradient, and an input that requires one is refused rather than
    silently cut from the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward: run it under "
                           "torch.no_grad() / inference_mode, or train through "
                           "the plain attention (models.layers.attention)")
    if q.dim() != 4:
        raise ValueError(f"expected (B, S, H, hd) tensors, got {tuple(q.shape)}")
    b, s, h, hd = q.shape
    fold = lambda t: t.movedim(2, 1).reshape(b * h, s, hd).contiguous()
    flash.check_qkv(q.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1))
    q, k, v = fold(q), fold(k), fold(v)
    if q.device.type == "cpu":
        o = ref.attention_ref(q, k, v, causal=causal, scale=scale)
    elif q.device.type == "cuda":
        o = flash.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return o.reshape(b, h, s, hd).movedim(1, 2)


@local_heads
def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_positions: torch.Tensor, pos, *, window: int = 0,
                     scale=None) -> torch.Tensor:
    """One token's attention against a cache, with the arguments and result
    of the plain ``models.layers.attention.decode_attention``: the decode
    kernel, on CUDA tensors (``pos`` a 0-d int32 tensor on the card).  On a
    mesh, each device's (batch, head) shards (``local_heads``)."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode.decode_attention_cuda(q, k_cache, v_cache, kv_positions, pos,
                                        window=window, scale=scale)
