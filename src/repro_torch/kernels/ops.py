"""Public wrappers around the port's kernels.

A wrapper runs the kernel's plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises.  ``decode_attention``
takes CUDA tensors alone: its plain version is the model layer's
(``models.layers.attention.decode_attention``), and its callers pick one of
the two by device (``models.transformer.decode_attention``).  So do the MoE
layer's three, whose plain versions are ``models.layers.moe``'s
``queue_positions``, ``dispatch`` and ``combine`` (``apply_moe`` picks):

- ``moe_positions`` (count ``"moe_positions"``): each (token, expert)
  pair's queue position, keep, capacity slot, and each slot's pair;
- ``moe_dispatch`` (``"moe_dispatch"``): the experts' (E, B·n·C, d) input;
- ``moe_combine`` (``"moe_combine"``): each token's gated sum of its kept
  pairs' expert outputs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import build, crc32, decode_attention as decode, ref
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import moe

#: wrapper name -> its kernel's launch count
COUNTS: Dict[str, build.LaunchCount] = {"crc32_batch": crc32.COUNT,
                                        "flash_attention": flash.COUNT,
                                        "decode_attention": decode.COUNT,
                                        "moe_positions": moe.POSITIONS,
                                        "moe_dispatch": moe.DISPATCH,
                                        "moe_combine": moe.COMBINE}


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_positions: torch.Tensor, pos, *, window: int = 0,
                     scale=None) -> torch.Tensor:
    """One token's attention against a cache, with the arguments and result
    of the plain ``models.layers.attention.decode_attention``: the decode
    kernel, on CUDA tensors (``pos`` a 0-d int32 tensor on the card).  On a
    mesh its caller hands it each device's shards
    (``models.transformer.decode_attention``)."""
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    return decode.decode_attention_cuda(q, k_cache, v_cache, kv_positions, pos,
                                        window=window, scale=scale)


def moe_positions(topi: torch.Tensor, n_experts: int, capacity: int):
    """(pos, keep, slot, inverse) of the routed pairs ``topi`` (B, n, g, k)
    on the card: ``pos`` and ``keep`` as ``models.layers.moe.route``'s,
    ``slot`` each pair's e·C + pos (-1 dropped), ``inverse`` (B, n, E·C) the
    pair t·k + j that fills each slot of its group (-1 none)."""
    return moe.positions_cuda(topi, n_experts, capacity)


def moe_dispatch(x: torch.Tensor, inverse: torch.Tensor, n_experts: int,
                 k: int) -> torch.Tensor:
    """The experts' input (E, B·n·C, d) from x (B, S, d) and
    ``moe_positions``' inverse, on the card; equal to the plain
    ``models.layers.moe.dispatch``'s bit for bit."""
    return moe.dispatch_cuda(x, inverse, n_experts, k)


def moe_combine(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """(B, S, d): each token's kept pairs' rows of the experts' output ye
    (E, B·n·C, d), weighed by their float32 gates cast to ye's dtype and
    summed in float32, on the card (the plain ``models.layers.moe.combine``
    up to the order of that sum)."""
    return moe.combine_cuda(ye, slot, gates)
