"""The JAX package's model and train-state trees, and the port's.

The reference keeps each layer's leaves stacked along a leading
(n_layers, ...) axis for its scan; the port keeps a list of per-layer dicts
under ``"layers"``.  ``to_reference_tree`` stacks the port's lists into the
reference's leaves and ``from_reference_tree`` splits them back, so a
checkpoint of the port's train state has the reference's leaf paths
(``['opt']['m']['layers']['attn']['wq']``) and either package resumes what
the other saved.  Weights keep their (d_in, d_out) layout (both packages
apply them as ``x @ W``).

``params_from_numpy(jax.tree.map(np.asarray, params), cfg, device)`` and
``train_state_from_numpy`` take the JAX package's trees as numpy arrays;
bfloat16 (``ml_dtypes``) arrays cross through their int16 bit pattern, as in
``checkpoint.serialization``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.serialization import to_tensor
from repro_torch.models.transformer import check_supported
from repro_torch.tree import flatten_with_path, map_leaves, unflatten


def to_reference_tree(tree):
    """``tree`` with every ``"layers"`` list of per-layer trees stacked into
    one tree of (n_layers, ...) tensors."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for key, sub in tree.items():
        if key == "layers":
            per_layer = [[leaf for _p, leaf in flatten_with_path(layer)] for layer in sub]
            sub = unflatten(sub[0], [torch.stack(ts) for ts in zip(*per_layer)])
        else:
            sub = to_reference_tree(sub)
        out[key] = sub
    return out


def from_reference_tree(tree):
    """The inverse of ``to_reference_tree``: every ``"layers"`` tree of
    (n_layers, ...) tensors split into a list of per-layer trees, each leaf
    its own copy."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for key, sub in tree.items():
        if key == "layers":
            leaves = [leaf for _p, leaf in flatten_with_path(sub)]
            n = leaves[0].shape[0]
            sub = [unflatten(sub, [t[i].clone() for t in leaves]) for i in range(n)]
        else:
            sub = from_reference_tree(sub)
        out[key] = sub
    return out


def train_state_from_numpy(tree: Dict, cfg, device="cuda") -> Dict:
    """The JAX package's ``{"params", "opt": {"m", "v", "step"}}`` as the
    port's train state, copied onto ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    return from_reference_tree(map_leaves(lambda a: to_tensor(a).to(dev, copy=True), tree))


#: a bare parameter tree converts the same way
params_from_numpy = train_state_from_numpy
