"""Training step factory: loss and gradients over the model's ``train_loss``
plus the AdamW update, with optional gradient accumulation over
microbatches — the port of ``repro/train/step.py``.

Gradients come from ``torch.autograd.grad`` over the parameter leaves (in
their dtype, as ``jax.grad`` gives them).  Microbatch gradients accumulate
into float32 zeros and are scaled by ``1/n`` afterwards, and the schedule is
evaluated at the pre-update step, as in the reference.  The reference's
``lax.scan`` over microbatches is a plain loop here, so its ``unroll_micro``
has no counterpart.  ``max_seq`` reaches ``model.init``, which only the
encdec family's decoder positions use.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.sharding.rules import splittable
from repro_torch.tree import flatten_with_path, map_leaves, unflatten

TrainState = Dict[str, Any]  # {"params": ..., "opt": {m, v, step}}


def make_train_state(model, key=0, max_seq: int = 4096) -> TrainState:
    """Parameters from ``model.init(key, max_seq)`` and zeroed AdamW state,
    on the model's device."""
    params = model.init(key, max_seq=max_seq)
    return {"params": params, "opt": adamw_init(params)}


def make_train_state_abstract(model, max_seq: int = 4096) -> TrainState:
    """The train state's tree, shapes and dtypes on the meta device: a
    restore template that allocates nothing."""
    params = model.init_abstract(max_seq=max_seq)
    return {"params": params, "opt": adamw_init(params)}


def loss_and_grads(loss_fn: Callable, params, batch) -> Tuple[torch.Tensor, Dict]:
    """``jax.value_and_grad(loss_fn)(params, batch)``: the loss (detached)
    and a gradient tree shaped like ``params``."""
    leaves = [p.detach().requires_grad_(True)
              for _path, p in flatten_with_path(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(params, list(grads))


def make_train_step(model, opt_cfg: AdamWConfig = AdamWConfig(),
                    *, n_microbatches: int = 1,
                    schedule: Optional[Callable] = None):
    """The step function ``step(state, batch) -> (state, metrics)``.  Spans
    ``train.step`` (request: the step function's call count, tokens)
    around ``train.grads`` (forward and backward, every microbatch) and
    ``train.update`` (AdamW)."""
    loss_fn = model.train_loss
    calls = itertools.count()

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with tracing.span("train.step", request=next(calls),
                          tokens=math.prod(np.shape(batch.get("tokens", ())))):
            with tracing.span("train.grads"):
                loss, grads = _grads(state["params"], batch)
            with tracing.span("train.update"):
                lr_scale = schedule(state["opt"]["step"]) if schedule else 1.0
                new_params, new_opt, metrics = adamw_update(
                    opt_cfg, state["params"], grads, state["opt"], lr_scale)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    def _grads(params, batch):
        if n_microbatches == 1:
            loss, grads = loss_and_grads(loss_fn, params, batch)
        else:
            def split(x):
                # on a mesh the batch is gathered first when its shards do
                # not divide the microbatch count (``splittable``)
                x = splittable(torch.as_tensor(x), 0, n_microbatches)
                b = x.shape[0]
                return x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
            micro = {k: split(v) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            # zeros laid out as the parameter (a DTensor's placements too)
            grads = map_leaves(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(n_microbatches):
                l, g = loss_and_grads(loss_fn, params, {k: v[i] for k, v in micro.items()})
                loss = loss + l
                grads = unflatten(grads, [a + b for (_p, a), (_q, b) in zip(
                    flatten_with_path(grads), flatten_with_path(g))])
            inv = 1.0 / n_microbatches
            loss = loss * inv
            grads = map_leaves(lambda g: g * inv, grads)
        return loss, grads

    return step
