"""MoE routing's queue positions, dispatch and combine as CUDA kernels for
Hopper.

The MoE layer's path on a CUDA tensor that needs no gradient
(``models.layers.moe``, which picks them; its plain versions are the
layer's own ``queue_positions``, ``dispatch`` and ``combine``).  Replaces
no Pallas kernel: the JAX package forms dispatch and combine as one-hot
einsums.  The kernel sources, their bounds and design notes are in
``csrc/moe.cu``.

Layout, for x (B, S, d) in n = S // g groups of g tokens, k experts a token,
E experts of C slots a group:

- ``positions_cuda``: topi (B, n, g, k) int64 -> pos (B, n, g, k) int64,
  keep (B, n, g, k) bool, slot (B, n, g, k) int32 (e·C + pos, -1 when
  dropped) and inverse (B, n, E·C) int32 (the pair t·k + j of its group
  that fills each slot, -1 when none does);
- ``dispatch_cuda``: x and inverse -> xe (E, B·n·C, d) in x's dtype;
- ``combine_cuda``: ye (E, B·n·C, d), slot and the float32 gates (B, n, g,
  k) -> (B, S, d) in ye's dtype.

Every tensor contiguous and on one CUDA device; x and ye float32 or
bfloat16, with rows a multiple of 16 bytes.  Anything else raises: these
wrappers have no plain branch.  The model layer picks the plain versions
itself, for a CPU tensor, under autograd and for a DTensor
(``models.layers.moe.on_card``).  Each launch is counted under the key (B·n
groups, g, k, E, C), dispatch and combine adding (d, dtype name).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES, dtype_name

#: experts the positions kernel takes (its per-warp counts live in shared memory)
MAX_EXPERTS = 1024

#: launches of each kernel (never the plain versions)
POSITIONS = build.LaunchCount()
DISPATCH = build.LaunchCount()
COMBINE = build.LaunchCount()


@functools.cache
def _entries():
    """The library's three launch functions with their argument types
    (built at first use)."""
    lib = build.load("moe")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.moe_positions.argtypes = [ptr] * 5 + [i64] * 5 + [ptr]
    lib.moe_dispatch.argtypes = [ptr] * 3 + [i64] * 6 + [ptr]
    lib.moe_combine.argtypes = [ptr] * 4 + [i64] * 5 + [ctypes.c_int, ptr]
    for fn in (lib.moe_positions, lib.moe_dispatch, lib.moe_combine):
        fn.restype = ctypes.c_int
    return lib


def _contiguous(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every input must be contiguous")


def _rows(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: expected float32 or bfloat16 rows, got {t.dtype}")
    if t.shape[-1] * t.element_size() % 16:
        raise ValueError(f"{name}: a row of {t.shape[-1]} {t.dtype} is not a multiple of "
                         "16 bytes")


def _on_one_card(name: str, *tensors: torch.Tensor) -> int:
    """The index of the CUDA device every tensor lies on, else raise."""
    dev = tensors[0].get_device()  # -1 off the card
    if dev < 0 or any(t.get_device() != dev for t in tensors):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}: every tensor "
                         "must lie on one CUDA device")
    return dev


def _launch(dev: int, name: str, fn, tensors, *args) -> None:
    """Launch ``fn`` on the current stream of CUDA device ``dev``, which
    holds the tensors."""
    call = lambda: fn(*(t.data_ptr() for t in tensors), *args,
                      torch.cuda.current_stream().cuda_stream)
    if dev == torch.cuda.current_device():
        err = call()
    else:
        with torch.cuda.device(dev):
            err = call()
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_positions(topi: torch.Tensor, n_experts: int, capacity: int) -> None:
    """Raise on what the positions kernel does not take (shapes, dtypes and
    strides only, so on any device)."""
    if topi.dim() != 4 or topi.dtype != torch.int64:
        raise ValueError(f"moe_positions: expected topi of (B, n, g, k) int64, got "
                         f"{tuple(topi.shape)} {topi.dtype}")
    if not 1 <= topi.shape[3] <= n_experts <= MAX_EXPERTS or capacity < 1:
        raise ValueError(f"moe_positions: {topi.shape[3]} experts a token of {n_experts} "
                         f"with capacity {capacity}: the kernel takes 1 <= k <= E <= "
                         f"{MAX_EXPERTS} and C >= 1")
    _contiguous("moe_positions", topi)


def positions_cuda(topi: torch.Tensor, n_experts: int, capacity: int):
    """(pos, keep, slot, inverse) of the pairs ``topi`` (B, n, g, k), with
    ``n_experts`` experts of ``capacity`` slots a group."""
    check_positions(topi, n_experts, capacity)
    dev = _on_one_card("moe_positions", topi)
    b, n, g, k = topi.shape
    pos = torch.empty_like(topi)
    keep = torch.empty(topi.shape, dtype=torch.bool, device=topi.device)
    slot = torch.empty(topi.shape, dtype=torch.int32, device=topi.device)
    inverse = torch.empty((b, n, n_experts * capacity), dtype=torch.int32, device=topi.device)
    if topi.numel():
        _launch(dev, "moe_positions", _entries().moe_positions,
                (topi, pos, keep, slot, inverse), b * n, g, k, n_experts, capacity)
        POSITIONS.add((b * n, g, k, n_experts, capacity))
    return pos, keep, slot, inverse


def check_dispatch(x: torch.Tensor, inverse: torch.Tensor, n_experts: int, k: int) -> None:
    """Raise on what the dispatch kernel does not take."""
    if x.dim() != 3 or inverse.dim() != 3 or inverse.dtype != torch.int32:
        raise ValueError(f"moe_dispatch: expected x (B, S, d) and an int32 inverse (B, n, "
                         f"E·C), got {tuple(x.shape)}, {tuple(inverse.shape)} {inverse.dtype}")
    b, s, _ = x.shape
    if (inverse.shape[0] != b or not 1 <= inverse.shape[1] <= max(s, 1)
            or s % inverse.shape[1] or inverse.shape[2] % n_experts or k < 1):
        raise ValueError(f"moe_dispatch: inverse {tuple(inverse.shape)} does not split x "
                         f"{tuple(x.shape)} into groups of {n_experts} experts' slots")
    _rows("moe_dispatch", x)
    _contiguous("moe_dispatch", x, inverse)


def dispatch_cuda(x: torch.Tensor, inverse: torch.Tensor, n_experts: int,
                  k: int) -> torch.Tensor:
    """xe (E, B·n·C, d): each expert's capacity slots, group by group, the
    row of the token that fills the slot or zeros."""
    check_dispatch(x, inverse, n_experts, k)
    dev = _on_one_card("moe_dispatch", x, inverse)
    b, s, d = x.shape
    n = inverse.shape[1]
    c = inverse.shape[2] // n_experts
    x = build.aligned16(x)
    xe = x.new_empty((n_experts, b * n * c, d))
    if xe.numel():
        _launch(dev, "moe_dispatch", _entries().moe_dispatch, (x, inverse, xe),
                b * n, s // n, k, n_experts, c, d * x.element_size())
        DISPATCH.add((b * n, s // n, k, n_experts, c, d, dtype_name(x.dtype)))
    return xe


def check_combine(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor) -> None:
    """Raise on what the combine kernel does not take."""
    if ye.dim() != 3 or slot.dim() != 4 or slot.dtype != torch.int32:
        raise ValueError(f"moe_combine: expected ye (E, B·n·C, d) and an int32 slot (B, n, "
                         f"g, k), got {tuple(ye.shape)}, {tuple(slot.shape)} {slot.dtype}")
    if gates.shape != slot.shape or gates.dtype != torch.float32:
        raise ValueError(f"moe_combine: expected float32 gates of {tuple(slot.shape)}, got "
                         f"{tuple(gates.shape)} {gates.dtype}")
    groups = slot.shape[0] * slot.shape[1]
    if groups and ye.shape[1] % groups:
        raise ValueError(f"moe_combine: ye {tuple(ye.shape)} has no whole capacity for "
                         f"{groups} groups")
    _rows("moe_combine", ye)
    _contiguous("moe_combine", ye, slot, gates)


def combine_cuda(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """(B, n·g, d) in ye's dtype: each token's kept pairs' rows of ye, each
    weighed by its gate rounded to that dtype, summed in float32."""
    check_combine(ye, slot, gates)
    dev = _on_one_card("moe_combine", ye, slot, gates)
    b, n, g, k = slot.shape
    e, _, d = ye.shape
    c = ye.shape[1] // (b * n) if b * n else 0
    ye = build.aligned16(ye)
    out = ye.new_empty((b, n * g, d))
    if out.numel():
        _launch(dev, "moe_combine", _entries().moe_combine, (ye, slot, gates, out),
                b * n, g, k, c, d, DTYPE_CODES[ye.dtype])
        COMBINE.add((b * n, g, k, e, c, d, dtype_name(ye.dtype)))
    return out
