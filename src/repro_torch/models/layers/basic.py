"""Shared primitives: norms, RoPE, MLPs, embeddings, init helpers — the port
of ``repro/models/layers/basic.py``.

Parameters are nested dicts of tensors in the reference's layout: a weight
is (d_in, d_out) and is applied as ``x @ W``.  Norms run in float32 whatever
the activation dtype.  Random init draws from an explicit
``torch.Generator`` and creates each tensor on the generator's device; the
numbers differ from ``jax.random``'s, the distributions do not.  The
reference's ``scan_layers`` becomes a plain loop in ``models.transformer``;
the losses come with the training slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)


# ----------------------------------------------------------------------- norms
def init_norm(cfg, gen: torch.Generator) -> Dict:
    if cfg.norm == "nonparam_ln":  # olmo: no learned affine
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype_of(cfg),
                                device=gen.device)}


def apply_norm(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind in ("layernorm", "nonparam_ln"):
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
    if params:
        y = y * params["scale"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------------------ rope
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return theta ** (-exps / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, n, head_dim); positions: (S,) or broadcastable.  Split
    halves: dimension i pairs with i + head_dim/2."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------- mlp
def init_mlp(cfg, gen: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"wg": dense_init(gen, (d, f), dt),
                "wi": dense_init(gen, (d, f), dt),
                "wo": dense_init(gen, (f, d), dt)}
    return {"wi": dense_init(gen, (d, f), dt),
            "wo": dense_init(gen, (f, d), dt)}


def _act(cfg):
    # jax.nn.gelu approximates with tanh by default
    return F.silu if cfg.act == "silu" else lambda t: F.gelu(t, approximate="tanh")


def apply_mlp(params: Dict, x: torch.Tensor, cfg) -> torch.Tensor:
    act = _act(cfg)
    if "wg" in params:
        return (act(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]
    return act(x @ params["wi"]) @ params["wo"]


# ------------------------------------------------------------------- embedding
def init_embedding(cfg, gen: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    p = {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return p


def embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params: Dict, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["table"].T
