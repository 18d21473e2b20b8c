"""Mixture-of-Experts block — the port of ``repro/models/layers/moe.py``:
top-k routing with GShard capacity dispatch within groups of ``moe_group``
tokens of one batch row (the group halves until it divides S), tokens over
an expert's capacity passing through the residual, and the Switch-style
auxiliary load-balance loss.

Routing is the reference's exactly.  The router runs in float32 whatever
the model's dtype.  Top-k puts the lower expert index first among equal
gates, as ``jax.lax.top_k`` does (a stable descending sort: ``torch.topk``
promises no order for ties).  A (token, slot) pair's queue position at its
expert counts the earlier pairs routed there in token-major order over the
group's flattened (g·k) slots, and a pair at position >= C is dropped.

The reference forms dispatch and combine as one-hot (B, n, g, E, C) tensors
and einsums.  Here dispatch scatters each kept pair's token into its
expert's capacity slot, and combine gathers each pair's expert output and
weighs it by its gate, cast to x's dtype as the reference casts combine.
Both are exact rewrites: dispatch weights are 0/1 and a (token, expert)
pair holds at most one slot, so the dispatch einsum sums one nonzero term,
and the combine einsum a token's k terms in another order.  At
granite_moe_3b's prefill (4 x 1024 tokens) the one-hot tensor alone would
take 336 MB a layer.  The experts run as batched matmuls over the (E,
B·n·C, d) capacity buffers, as the reference's einsums do, so a decode step
(g = 1, C = 1) reads every expert's weights.

A config with ``d_ff_shared`` (granite 4.0-H) adds an always-on shared
expert, a SwiGLU MLP of that width over every token (leaf ``shared``),
to the routed experts' output; the reference has none.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models.layers.basic import _act, apply_mlp, dense_init, dtype_of


def init_moe(cfg, gen: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, (d, E), torch.float32),
         "wg": dense_init(gen, (E, d, f), dt),
         "wi": dense_init(gen, (E, d, f), dt),
         "wo": dense_init(gen, (E, f, d), dt)}
    if cfg.d_ff_shared:
        fs = cfg.d_ff_shared
        p["shared"] = {"wg": dense_init(gen, (d, fs), dt),
                       "wi": dense_init(gen, (d, fs), dt),
                       "wo": dense_init(gen, (fs, d), dt)}
    return p


def capacity(cfg, g: int) -> int:
    c = math.ceil(g * cfg.n_experts_active / cfg.n_experts * cfg.capacity_factor)
    return max(1, min(g, (c + 3) & ~3 if g >= 8 else c))


def group_size(cfg, S: int) -> int:
    """``moe_group`` (at most S), halved until it divides S."""
    g = min(cfg.moe_group, S)
    while S % g:
        g //= 2
    return g


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates along the last axis, the
    lower index first among equal gates (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class Routing(NamedTuple):
    """One MoE layer's routing of x (B, S, d) in n = S // g groups."""
    g: int                  # tokens a group
    C: int                  # capacity: slots an expert has in a group
    topi: torch.Tensor      # (B, n, g, k) experts of each token, best first
    topv: torch.Tensor      # (B, n, g, k) their gates, normalized, float32
    pos: torch.Tensor       # (B, n, g, k) each pair's queue position
    keep: torch.Tensor      # (B, n, g, k) pos < C


def route(params: Dict, x: torch.Tensor, cfg) -> Routing:
    B_, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    g = group_size(cfg, S)
    n = S // g
    logits = x.reshape(B_, n, g, d).float() @ params["router"]    # (B,n,g,E)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(topi, E).reshape(B_, n, g * k, E)
    queue = torch.cumsum(flat, dim=2) - flat                       # per expert
    pos = (queue * flat).sum(-1).reshape(B_, n, g, k)
    C = capacity(cfg, g)
    return Routing(g, C, topi, topv, pos, pos < C)


def apply_moe(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); dropped pairs contribute 0, and a shared
    expert adds its output for every token.

    Spans ``moe.route``, ``moe.dispatch``, ``moe.experts``,
    ``moe.combine`` and ``moe.shared``; while the recorder is on, counters
    ``moe.pairs`` (the
    routed (token, slot) pairs) and ``moe.dropped`` (those past their
    expert's capacity), the latter summed on x's device."""
    B_, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    with tracing.span("moe.route"):
        r = route(params, x, cfg)
    if tracing.enabled():
        tracing.count("moe.pairs", r.keep.numel())
        tracing.count("moe.dropped", (~r.keep).sum())
    n, C = S // r.g, r.C
    with tracing.span("moe.dispatch"):
        # each pair's row in the E·C capacity slots of its group; a dropped
        # pair goes to one extra row, which no expert reads and which stays
        # zero where combine reads it
        slot = torch.where(r.keep, r.topi * C + r.pos, E * C).reshape(B_, n, r.g * k, 1)
        slot = slot.expand(-1, -1, -1, d)
        tokens = x.reshape(B_, n, r.g, 1, d).expand(-1, -1, -1, k, -1).reshape(B_, n, r.g * k, d)
        xe = x.new_zeros((B_, n, E * C + 1, d)).scatter(2, slot, tokens)[:, :, :E * C]
        xe = xe.reshape(B_, n, E, C, d).permute(2, 0, 1, 3, 4).reshape(E, B_ * n * C, d)
    with tracing.span("moe.experts"):
        act = _act(cfg)
        h = act(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wi"])
        ye = torch.bmm(h, params["wo"])                            # (E, B·n·C, d)
    with tracing.span("moe.combine"):
        ye = ye.reshape(E, B_, n, C, d).permute(1, 2, 0, 3, 4).reshape(B_, n, E * C, d)
        ye = torch.cat([ye, ye.new_zeros((B_, n, 1, d))], dim=2)
        picked = torch.gather(ye, 2, slot).reshape(B_, n, r.g, k, d)
        w = r.topv.to(x.dtype).reshape(B_, n, r.g, 1, k)
        out = torch.matmul(w, picked).reshape(B_, S, d)
    if "shared" in params:
        with tracing.span("moe.shared"):
            out = out + apply_mlp(params["shared"], x, cfg)
    return out


def aux_load_balance_loss(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Switch-style auxiliary loss (fraction·probability per expert)."""
    gates = torch.softmax(x.float() @ params["router"], dim=-1)
    _, topi = top_k(gates, cfg.n_experts_active)
    frac = F.one_hot(topi, cfg.n_experts).float().mean((0, 1, 2))
    prob = gates.mean((0, 1))
    return cfg.n_experts * torch.sum(frac * prob)
