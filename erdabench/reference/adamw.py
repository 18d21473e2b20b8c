"""Plain AdamW (Loshchilov and Hutter) with a global-norm clip, on lists of
float32 tensors: the update the benchmark holds the program's optimizer
to.  Imports nothing of the program."""
from __future__ import annotations

from typing import Dict, List

import torch


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)).float()


@torch.no_grad()
def adamw_step(hp: Dict, params: List[torch.Tensor], grads: List[torch.Tensor],
               m: List[torch.Tensor], v: List[torch.Tensor], step: int) -> List[torch.Tensor]:
    """One update in place of ``params``, ``m`` and ``v`` (``step`` counts
    from 1).  Returns the clipped gradients the moments took in."""
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    clip = min(1.0, hp["grad_clip"] / (float(global_norm(grads)) + 1e-9))
    taken = []
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * clip
        taken.append(g)
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        mhat = mi / (1 - b1 ** step)
        vhat = vi / (1 - b2 ** step)
        p.sub_(hp["lr"] * (mhat / (vhat.sqrt() + eps) + hp["weight_decay"] * p))
    return taken
