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
and einsums; at granite_moe_3b's prefill (4 x 1024 tokens) that tensor
alone would take 336 MB a layer.  Here both are exact rewrites, in one of
two paths, which give the same routing, pos and keep:

- **Plain** (``queue_positions``, ``dispatch``, ``combine``): on the CPU
  and the dry-run's meta tensors, a DTensor's included, and under autograd
  (training: the kernels have no backward).  Positions come from an int64
  one-hot of the g·k slots and its cumsum; dispatch scatters k expanded
  copies of each token into an (E·C + 1)-slot buffer (the extra row takes
  the drops) and permutes it; combine permutes the experts' output back,
  appends a zero row, gathers each pair's row and weighs it by its gate,
  cast to x's dtype as the reference casts combine, in a 1 x k matmul a
  token.
- **Kernels** (``ops.moe_positions``, ``ops.moe_dispatch``,
  ``ops.moe_combine``; ``kernels/csrc/moe.cu``): a CUDA tensor with no
  gradient wanted (``on_card``, asked once a layer by ``apply_moe``), i.e.
  serving's prefill and decode.  One launch each.  Positions write pos,
  keep, each pair's slot and each slot's pair; dispatch writes the
  experts' (E, B·n·C, d) input straight, each row its token's or zeros,
  bit for bit the plain one; combine reads each token's kept pairs' rows
  of the experts' output in place, gate cast to x's dtype, sums in float32
  and rounds once.  Neither the one-hot, the expanded tokens, the E·C + 1
  buffer, the index of width d, the permuted copies nor the (B, n, g, k,
  d) gather exist there.  A CUDA DTensor runs them on each device's
  shards, which must hold whole groups (x split by batch row at most) and
  every expert (``whole``), as a one-card mesh's do; a placement that
  splits either raises.

Dispatch weights are 0/1 and a (token, expert) pair holds at most one
slot, so the dispatch einsum sums one nonzero term, and the combine
einsum a token's k terms, here in another order.  The experts run as
batched matmuls over the (E, B·n·C, d) capacity buffers, as the
reference's einsums do, so a decode step (g = 1, C = 1) reads every
expert's weights.

A config with ``d_ff_shared`` (granite 4.0-H) adds an always-on shared
expert, a SwiGLU MLP of that width over every token (leaf ``shared``),
to the routed experts' output; the reference has none.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.models.layers.basic import _act, apply_mlp, dense_init, dtype_of
from repro_torch.tree import flatten_with_path, map_leaves


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
    # routed with ``card`` (``ops.moe_positions``), else None:
    slot: Optional[torch.Tensor] = None     # (B, n, g, k) int32 e·C + pos, -1 dropped
    inverse: Optional[torch.Tensor] = None  # (B, n, E·C) int32 pair t·k + j of each slot


def on_card(params: Dict, x: torch.Tensor) -> bool:
    """Whether the layer takes its kernels: x on a CUDA device (a DTensor
    on its local shards) and no gradient wanted, since the kernels have no
    backward."""
    if not x.is_cuda:
        return False
    return not (torch.is_grad_enabled() and (x.requires_grad or any(
        params[key].requires_grad for key in ("router", "wg", "wi", "wo"))))


def whole(placements, sizes, rows: bool = False) -> bool:
    """Whether a tensor placed so on a mesh of ``sizes`` is whole on each
    device: every mesh dim of more than one device replicates it, or, with
    ``rows`` (x's), shards its batch rows, each of which holds whole groups."""
    from torch.distributed.tensor import Replicate, Shard
    return all(n == 1 or isinstance(p, Replicate) or (rows and p == Shard(0))
               for p, n in zip(placements, sizes))


def _on_local_shards(params: Dict, x, cfg):
    """``apply_moe`` on each device's shards of a DTensor x (and of the
    parameters that are DTensors), the result placed as x."""
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    split = [path for path, t in flatten_with_path(params) if isinstance(t, DTensor)
             and not whole(t.placements, t.device_mesh.shape)]
    if not whole(x.placements, mesh.shape, rows=True) or split:
        raise ValueError(f"apply_moe: the MoE kernels take whole groups and experts on "
                         f"each device; x placed {x.placements} on a mesh of "
                         f"{tuple(mesh.shape)}, split leaves {split}")
    local = map_leaves(lambda t: t.to_local() if isinstance(t, DTensor) else t, params)
    out = apply_moe(local, x.to_local(), cfg)
    return DTensor.from_local(out, mesh, x.placements, run_check=False)


def queue_positions(topi: torch.Tensor, E: int) -> torch.Tensor:
    """Each pair's queue position at its expert (plain version): the
    earlier pairs routed there in token-major order over each group's g·k
    slots, through a one-hot and its cumsum."""
    B_, n, g, k = topi.shape
    flat = F.one_hot(topi, E).reshape(B_, n, g * k, E)
    queue = torch.cumsum(flat, dim=2) - flat                       # per expert
    return (queue * flat).sum(-1).reshape(B_, n, g, k)


def route(params: Dict, x: torch.Tensor, cfg, card: bool = False) -> Routing:
    """x's routing; with ``card`` (``apply_moe`` passes ``on_card``, x then
    a CUDA tensor and no DTensor) the queue positions come from
    ``ops.moe_positions``, which also fills ``slot`` and ``inverse``, else
    from the plain ``queue_positions``."""
    B_, S, d = x.shape
    E, k = cfg.n_experts, cfg.n_experts_active
    g = group_size(cfg, S)
    n = S // g
    logits = x.reshape(B_, n, g, d).float() @ params["router"]    # (B,n,g,E)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    C = capacity(cfg, g)
    if card:
        return Routing(g, C, topi, topv, *ops.moe_positions(topi.contiguous(), E, C))
    pos = queue_positions(topi, E)
    return Routing(g, C, topi, topv, pos, pos < C)


def dispatch(r: Routing, x: torch.Tensor, E: int):
    """(xe (E, B·n·C, d), slot) (plain version): each kept pair's token
    scattered into its expert's capacity slot of its group; ``slot`` (B, n,
    g·k, d), each pair's row of the E·C + 1 slots, is combine's index."""
    B_, S, d = x.shape
    k = r.topi.shape[-1]
    n, C = S // r.g, r.C
    # a dropped pair goes to one extra row, which no expert reads and which
    # stays zero where combine reads it
    slot = torch.where(r.keep, r.topi * C + r.pos, E * C).reshape(B_, n, r.g * k, 1)
    slot = slot.expand(-1, -1, -1, d)
    tokens = x.reshape(B_, n, r.g, 1, d).expand(-1, -1, -1, k, -1).reshape(B_, n, r.g * k, d)
    xe = x.new_zeros((B_, n, E * C + 1, d)).scatter(2, slot, tokens)[:, :, :E * C]
    return xe.reshape(B_, n, E, C, d).permute(2, 0, 1, 3, 4).reshape(E, B_ * n * C, d), slot


def combine(r: Routing, ye: torch.Tensor, slot: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, d) (plain version): each pair's row of ye (E, B·n·C, d)
    gathered through ``dispatch``'s slot and weighed by its gate cast to
    ``dtype``, x's."""
    E, _, d = ye.shape
    B_, n, g, k = r.topi.shape
    ye = ye.reshape(E, B_, n, r.C, d).permute(1, 2, 0, 3, 4).reshape(B_, n, E * r.C, d)
    ye = torch.cat([ye, ye.new_zeros((B_, n, 1, d))], dim=2)
    picked = torch.gather(ye, 2, slot).reshape(B_, n, g, k, d)
    w = r.topv.to(dtype).reshape(B_, n, g, 1, k)
    return torch.matmul(w, picked).reshape(B_, n * g, d)


def apply_moe(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); dropped pairs contribute 0, and a shared
    expert adds its output for every token.

    Spans ``moe.route``, ``moe.dispatch``, ``moe.experts``,
    ``moe.combine`` and ``moe.shared``; while the recorder is on, counters
    ``moe.pairs`` (the
    routed (token, slot) pairs) and ``moe.dropped`` (those past their
    expert's capacity), the latter summed on x's device."""
    E, k = cfg.n_experts, cfg.n_experts_active
    card = on_card(params, x)
    if card and hasattr(x, "device_mesh"):  # a DTensor
        return _on_local_shards(params, x, cfg)
    with tracing.span("moe.route"):
        r = route(params, x, cfg, card)
    if tracing.enabled():
        tracing.count("moe.pairs", r.keep.numel())
        tracing.count("moe.dropped", (~r.keep).sum())
    with tracing.span("moe.dispatch"):
        if card:
            xe = ops.moe_dispatch(x.contiguous(), r.inverse, E, k)
        else:
            xe, slot = dispatch(r, x, E)
    with tracing.span("moe.experts"):
        act = _act(cfg)
        h = act(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wi"])
        ye = torch.bmm(h, params["wo"])                            # (E, B·n·C, d)
    with tracing.span("moe.combine"):
        out = ops.moe_combine(ye, r.slot, r.topv) if card else combine(r, ye, slot, x.dtype)
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
