"""Tensor leaf <-> bytes in ``repro``'s format: ``<I`` header length, JSON
``{"dtype", "shape"}`` with numpy's dtype names, then the raw little-endian
bytes.  Also the bridge between the JAX package's numpy pytrees and the
port's tensor trees (``tree_from_numpy`` / ``tree_to_numpy``).

bfloat16 travels as its int16 bit pattern: torch has no numpy path for it,
and the port does not need ``ml_dtypes`` to read or write it.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.tree import map_leaves

#: numpy dtype name -> torch dtype
DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def to_tensor(x) -> torch.Tensor:
    """A leaf as a tensor: tensors pass through; numpy arrays and scalars
    (bfloat16 from ``ml_dtypes`` included) are wrapped without a copy."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x, order="C")  # keeps 0-d leaves 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def leaf_to_bytes(leaf) -> bytes:
    t = to_tensor(leaf)
    meta = json.dumps({"dtype": _NAMES[t.dtype],
                       "shape": list(t.shape)}).encode()
    return struct.pack("<I", len(meta)) + meta + _host_bytes(t).tobytes()


def leaf_from_bytes(buf: bytes, device="cuda") -> torch.Tensor:
    (mlen,) = struct.unpack_from("<I", buf, 0)
    meta = json.loads(bytes(buf[4 : 4 + mlen]).decode())
    dtype = DTYPES[meta["dtype"]]
    host = torch.int16 if dtype == torch.bfloat16 else dtype
    flat = torch.frombuffer(bytearray(buf[4 + mlen :]), dtype=host) \
        if len(buf) > 4 + mlen else torch.empty(0, dtype=host)
    return flat.view(dtype).reshape(meta["shape"]).to(resolve_device(device))


def tree_from_numpy(tree, device="cuda"):
    """A pytree of numpy arrays (what the JAX package's arrays become under
    ``np.asarray``) as the same nested structure of tensors on ``device``."""
    dev = resolve_device(device)
    return map_leaves(lambda x: to_tensor(x).to(dev), tree)


def tree_to_numpy(tree):
    """A tensor tree as numpy arrays, for the JAX package.  bfloat16 leaves
    become ``ml_dtypes.bfloat16`` arrays (imported only for them)."""
    def conv(leaf):
        t = to_tensor(leaf)
        a = _host_bytes(t)
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            a = a.view(ml_dtypes.bfloat16)
        return a
    return map_leaves(conv, tree)
