"""Shared primitives: norms, RoPE, MLPs, embeddings, init helpers — the port
of ``repro/models/layers/basic.py``.

Parameters are nested dicts of tensors in the reference's layout: a weight
is (d_in, d_out) and is applied as ``x @ W``.  Norms run in float32 whatever
the activation dtype.  Random init draws from an explicit
``torch.Generator`` (the numbers differ from ``jax.random``'s, the
distributions do not) and creates each tensor on the current default
device: ``registry.get_model``'s init sets it to the model's device, and a
``torch.device("meta")`` context gives shapes without storage.  The reference's ``scan_layers`` becomes a plain loop in
``models.transformer``, and ``jax.checkpoint`` becomes ``remat``.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.rules import constrain_batch, lookup, replicate_dim


def remat(fn, *args):
    """``fn(*args)``, with its intermediate activations recomputed in the
    backward pass instead of kept (``jax.checkpoint``); a plain call when no
    gradient is being recorded."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w * scale).to(dtype)


def halved_chunk(chunk: int, S: int) -> int:
    """The reference's chunk over S steps: ``min(chunk, S)`` halved until it
    divides S (the loss, ``wkv_chunked``, ``ssm_chunked``).  Another
    chunking would round differently."""
    c = min(chunk, S)
    while S % c:
        c //= 2
    return c


# ----------------------------------------------------------------------- norms
def init_norm(cfg, gen: torch.Generator) -> Dict:
    if cfg.norm == "nonparam_ln":  # olmo: no learned affine
        return {}
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype_of(cfg))}


def apply_norm(params: Dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind in ("layernorm", "nonparam_ln"):
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    if params:
        y = y * params["scale"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------------------ rope
@functools.lru_cache(maxsize=None)
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 theta^(-2i/head_dim), computed on the CPU and
    copied to ``device`` once.  The card's ``pow`` and the CPU's differ in
    the last place for some exponents, and at position p the angle moves by
    p ulps of the frequency: 3.6e-5 in the cached k on an H100 at head_dim
    256 and 160 tokens, past the model check's 3e-5.  With one set of frequencies both
    devices rotate by the same angles.  The tensor is shared, never
    written, and made outside inference mode, so training may use it."""
    with torch.inference_mode(False):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32)
        return (theta ** (-exps / head_dim)).to(device)


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


@functools.lru_cache(maxsize=None)
def sinusoidal_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    """(seq, d_model) float32 [sin | cos] of pos / 10000^(2i/d_model) (the
    encdec family's encoder positions), computed on the CPU and copied to
    ``device`` once, as ``rope_frequencies`` is: the card's ``sin``,
    ``cos`` and ``pow`` may differ from the CPU's in the last place.  The
    denominators are rounded once from float64, which meets XLA's float32
    ``pow`` on all but one of whisper's 384 (torch's float32 ``pow``
    misses four).  Shared, never written, and made outside inference
    mode."""
    with torch.inference_mode(False):
        pos = torch.arange(seq, dtype=torch.float32)[:, None]
        exps = torch.arange(0, d_model, 2, dtype=torch.float32)[None, :] / d_model
        den = torch.pow(torch.tensor(10_000.0, dtype=torch.float64), exps.double())
        angle = pos / den.float()
        return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(device)


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
    return lookup(params["table"], tokens.long())


def unembed(params: Dict, x: torch.Tensor, logits_scaling: float = 1.0) -> torch.Tensor:
    """Logits, divided by µP's ``logits_scaling`` unless it is 1."""
    logits = x @ params["unembed"] if "unembed" in params else x @ params["table"].T
    return logits if logits_scaling == 1.0 else logits / logits_scaling


# ------------------------------------------------------------------------ loss
def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in fp32; targets = tokens shifted by caller."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (logz - gold).mean()


def _ce_chunk(embed_params: Dict, xc, tc, wc, logits_scaling: float = 1.0) -> torch.Tensor:
    xc = constrain_batch(xc)
    logits = unembed(embed_params, xc, logits_scaling).float()
    logz = torch.logsumexp(logits, dim=-1)
    # on a mesh the gold logit is read from the whole vocab (``replicate_dim``)
    gold = torch.gather(replicate_dim(logits, 2), -1, tc[..., None])[..., 0]
    return ((logz - gold) * wc).sum()


def lm_loss_chunked(embed_params: Dict, x: torch.Tensor, tokens: torch.Tensor,
                    chunk: int = 512, logits_scaling: float = 1.0) -> torch.Tensor:
    """Fused unembed + next-token CE over sequence chunks, so the (B, S, V)
    float32 logits never materialize; each chunk is rematerialized in the
    backward pass (``remat``), trading one extra (B, c, V) product for the
    storage.  The final position has weight 0 (the shift keeps S whole), and
    the chunk is halved until it divides S."""
    B_, S, _ = x.shape
    tokens = tokens.long()
    targets = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    weights = torch.cat([torch.ones((B_, S - 1), dtype=torch.float32, device=x.device),
                         torch.zeros((B_, 1), dtype=torch.float32, device=x.device)], dim=1)
    c = halved_chunk(chunk, S)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + remat(_ce_chunk, embed_params, x[:, sl], targets[:, sl],
                              weights[:, sl], logits_scaling)
    return total / weights.sum()
