"""The JAX package's model parameters, as numpy arrays, as the port's.

``params_from_numpy(jax.tree.map(np.asarray, params), cfg, device)``: the
reference keeps each layer's leaves stacked along a leading (n_layers, ...)
axis for its scan; the port keeps a list of per-layer dicts.  Weights keep
their (d_in, d_out) layout (both packages apply them as ``x @ W``), and
bfloat16 (``ml_dtypes``) arrays cross through their int16 bit pattern, as in
``checkpoint.serialization``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.checkpoint.serialization import to_tensor
from repro_torch.models.transformer import check_supported
from repro_torch.tree import map_leaves


def params_from_numpy(tree: Dict, cfg, device="cuda") -> Dict:
    check_supported(cfg)
    dev = resolve_device(device)
    conv = lambda a: to_tensor(a).to(dev, copy=True)
    return {"embed": map_leaves(conv, tree["embed"]),
            "final_norm": map_leaves(conv, tree["final_norm"]),
            "layers": [map_leaves(lambda a: conv(np.asarray(a)[i]), tree["layers"])
                       for i in range(cfg.n_layers)]}
