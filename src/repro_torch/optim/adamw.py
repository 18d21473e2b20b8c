"""AdamW, hand-rolled on nested dicts of tensors — the port of
``repro/optim/adamw.py``.

The reference's order of operations is kept (``torch.optim.AdamW`` differs
in it and in its handling of bf16 parameters): float32 moments, a 0-d int32
step, bias corrections ``1 - b ** step`` in float32, a global clip
``min(1, clip / (norm + 1e-9))`` on the float32 norm of every gradient leaf,
weight decay on every parameter, and the new parameter cast back to its
dtype.  Functional: returns new trees and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.tree import flatten_with_path, map_leaves, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> Dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    step_device = next((p.device for _path, p in flatten_with_path(params)), None)
    return {"m": map_leaves(zeros, params),
            "v": map_leaves(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device)}


def _leaves(tree):
    return [leaf for _path, leaf in flatten_with_path(tree)]


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.float())) for g in _leaves(tree)]).sum())


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state,
                 lr_scale=1.0) -> Tuple[Dict, Dict, Dict]:
    """-> (new params, new optimizer state, {"grad_norm": norm before the
    clip}).  ``lr_scale`` is a float or a 0-d float32 tensor (a schedule's
    value)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * lr_scale
    stepf = step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / (1 - cfg.b1 ** stepf)
        vhat = v / (1 - cfg.b2 ** stepf)
        newp = p.float() - lr * (
            mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float())
        return newp.to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        _leaves(params), _leaves(grads), _leaves(opt_state["m"]),
        _leaves(opt_state["v"]))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm}
