"""The JAX package's model and train-state trees, and the port's.

The reference keeps each layer's leaves stacked along leading axes for its
scans; the port keeps lists of per-layer dicts: ``"layers"`` (the
transformer's and rwkv's), ``"global_layers"``, ``"tail_local"``,
``"ssm_tail"``, ``"enc_layers"`` and ``"dec_layers"`` are lists of layers,
(n, ...) in the reference, and local_global's ``"local_layers"`` and the
hybrid's ``"ssm_main"`` lists of groups of layers, (G, local_per_global,
...) and (G, every, ...).  The hybrid's ``"shared"`` block is one block,
not a stack.  ``to_reference_tree`` stacks the
port's lists into the reference's leaves and ``from_reference_tree`` splits
them back, so a checkpoint of the port's train state has the reference's
leaf paths (``['opt']['m']['local_layers']['attn']['wq']``) and either
package resumes what the other saved.  A moe layer's ``"moe"`` leaves
stack the same way (``['layers']['moe']['wg']``: (L, E, d, f), the float32
router (L, d, E)).  Weights keep their (d_in, d_out) layout (both packages
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
from repro_torch.models.registry import family_module
from repro_torch.tree import flatten_with_path, map_leaves, stack_trees, unflatten


#: key of a stack of layers -> the list levels it has in the port (the
#: leading axes its leaves have in the reference)
LAYER_STACKS = {"layers": 1, "global_layers": 1, "tail_local": 1, "local_layers": 2,
                "ssm_main": 2, "ssm_tail": 1, "enc_layers": 1, "dec_layers": 1}


def _stack(sub, depth: int):
    if depth == 0:
        return sub
    return stack_trees([_stack(item, depth - 1) for item in sub])


def _split(sub, depth: int):
    if depth == 0:
        return sub
    leaves = [leaf for _p, leaf in flatten_with_path(sub)]
    n = leaves[0].shape[0]
    return [_split(unflatten(sub, [t[i] for t in leaves]), depth - 1) for i in range(n)]


def to_reference_tree(tree):
    """``tree`` with every stack of layers (``LAYER_STACKS``) stacked into
    one tree of (n, ...) or (G, local_per_global, ...) tensors."""
    if not isinstance(tree, dict):
        return tree
    return {key: _stack(sub, LAYER_STACKS[key]) if key in LAYER_STACKS
            else to_reference_tree(sub) for key, sub in tree.items()}


def from_reference_tree(tree):
    """The inverse of ``to_reference_tree``: every stack of layers split
    into (lists of) per-layer trees, each leaf its own copy."""
    if not isinstance(tree, dict):
        return tree
    return {key: map_leaves(torch.clone, _split(sub, LAYER_STACKS[key]))
            if key in LAYER_STACKS else from_reference_tree(sub)
            for key, sub in tree.items()}


def train_state_from_numpy(tree: Dict, cfg, device="cuda") -> Dict:
    """The JAX package's ``{"params", "opt": {"m", "v", "step"}}`` as the
    port's train state, copied onto ``device``."""
    family_module(cfg)  # raises for a family no module serves
    dev = resolve_device(device)
    return from_reference_tree(map_leaves(lambda a: to_tensor(a).to(dev, copy=True), tree))


#: a bare parameter tree converts the same way
params_from_numpy = train_state_from_numpy
