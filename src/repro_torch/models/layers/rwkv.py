"""RWKV6 "Finch" blocks: time mix with a data-dependent per-channel decay,
and the channel-mix FFN — the port of ``repro/models/layers/rwkv.py``.

Recurrence per head (k, r, v in R^hd, decay w_t in (0, 1)^hd):
    y_t = r_t · (S_{t-1} + (u ∘ k_t) v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

``wkv_chunked`` is the reference's chunked linear attention: within a chunk
the pairwise decay factorizes as exp(lw_i − lw_j) (lw the cumulative
log-decay), so the intra-chunk work is two products with decay-scaled r'
and k', and a plain loop (the reference's ``lax.scan``) carries the state
across chunks.  It is plain PyTorch on every device: the reference has no
kernel for it.  The chunk is the reference's: ``rwkv_chunk`` halved until
it divides S, since another chunking rounds differently.  Everything in
the recurrence is float32, and the output is cast to r's dtype.

The token shift uses the static mixes (``mu``); the decay keeps RWKV6's
data-dependent LoRA, in float32 (``w0`` is float32 and the LoRA's product
is cast up before the sum, as JAX's promotion does).  Decode states are
copies, not views of the sequence they come from, so a cache does not keep
a prefill's activations alive.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import apply_norm, dense_init, dtype_of, halved_chunk

#: rank of the decay's LoRA
LORA = 64


def init_rwkv_block(cfg, gen: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    return {
        "tm": {  # time mix
            "mu": 0.5 * torch.ones((5, d), dtype=dt),  # r, k, v, w, g shift mixes
            "wr": dense_init(gen, (d, d), dt),
            "wk": dense_init(gen, (d, d), dt),
            "wv": dense_init(gen, (d, d), dt),
            "wg": dense_init(gen, (d, d), dt),
            "wo": dense_init(gen, (d, d), dt),
            "w0": -6.0 * torch.ones((d,), dtype=torch.float32),  # base log-log decay
            "w_lora_a": dense_init(gen, (d, LORA), dt),
            "w_lora_b": dense_init(gen, (LORA, d), dt, scale=0.01),
            "u": dense_init(gen, (H, hd), torch.float32, scale=0.5),
            "ln": torch.ones((d,), dtype=dt),
        },
        "cm": {  # channel mix
            "mu": 0.5 * torch.ones((2, d), dtype=dt),
            "wr": dense_init(gen, (d, d), dt),
            "wk": dense_init(gen, (d, f), dt),
            "wv": dense_init(gen, (f, d), dt),
        },
    }


def _shift(x: torch.Tensor, last=None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros, or the carried ``last``, at t = 0)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _wkv_chunk(h, ri, ki, vi, lwi, u):
    """One chunk: (state (B,H,hd,hd), r/k/v/lw (B,c,H,hd)) -> (y, state)."""
    c = ri.shape[1]
    # decay of the state from the chunk start to just before step i
    lw_prev = F.pad(lwi[:, :-1], (0, 0, 0, 0, 1, 0))
    r_dec = ri * torch.exp(lw_prev)                      # r'_i (<= 1, safe)
    # k'_j = k_j·exp(−lw_j), clamped at 30 where the pair decay is ≈ 0 anyway
    k_dec = ki * torch.exp(torch.clamp(-lwi, max=30.0))
    scores = torch.einsum("bihd,bjhd->bhij", r_dec, k_dec)
    tri = torch.ones((c, c), dtype=torch.bool, device=ri.device).tril(-1)
    scores = torch.where(tri[None, None], scores, 0.0)
    y = torch.einsum("bhij,bjhd->bihd", scores, vi)
    bonus = torch.einsum("bihd,hd,bihd->bih", ri, u, ki)  # current-token bonus
    y = y + bonus[..., None] * vi
    y = y + torch.einsum("bihd,bhde->bihe", r_dec, h)    # the carried state
    lw_last = lwi[:, -1]                                 # (B,H,hd)
    k_end = ki * torch.exp(lw_last[:, None] - lwi)
    h_new = torch.exp(lw_last)[..., None] * h + torch.einsum("bjhd,bjhe->bhde",
                                                            k_end, vi)
    return y, h_new


def wkv_chunked(r, k, v, w, u, h0, chunk: int):
    """Chunked WKV.  r, k, v, w: (B,S,H,hd); u: (H,hd); h0: (B,H,hd,hd).
    Returns y (B,S,H,hd) in r's dtype and the last state (float32)."""
    B, S, H, hd = r.shape
    c = halved_chunk(chunk, S)
    n = S // c
    rs, ks, vs, ws = (a.reshape(B, n, c, H, hd).float() for a in (r, k, v, w))
    lw = torch.cumsum(torch.log(ws), dim=2)              # (B,n,c,H,hd)
    h = h0.float()
    ys = []
    for j in range(n):
        y, h = _wkv_chunk(h, rs[:, j], ks[:, j], vs[:, j], lw[:, j], u)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, H, hd)
    return y.to(r.dtype), h


def apply_time_mix(p: Dict, x: torch.Tensor, cfg, state=None):
    """state: None or dict(shift (B,1,d), h (B,H,hd,hd)).  Returns (y, new
    state)."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, d // cfg.n_heads
    last = None if state is None else state["shift"]
    xprev = _shift(x, last)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (x + (xprev - x) * mu[i] for i in range(5))
    r = (xr @ p["wr"]).reshape(B, S, H, hd)
    k = (xk @ p["wk"]).reshape(B, S, H, hd)
    v = (xv @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (RWKV6): w = exp(-exp(w0 + lora(xw)))
    wlog = p["w0"] + (torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    w = torch.exp(-torch.exp(wlog)).reshape(B, S, H, hd)
    h0 = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
          if state is None else state["h"])
    y, h_last = wkv_chunked(r, k, v, w, p["u"], h0, cfg.rwkv_chunk)
    y = y.reshape(B, S, d)
    y = apply_norm({"scale": p["ln"]}, y, "layernorm")   # group-norm-ish output norm
    y = (y * g) @ p["wo"]
    return y, {"shift": x[:, -1:].clone(), "h": h_last}


def apply_channel_mix(p: Dict, x: torch.Tensor, cfg, state=None):
    last = None if state is None else state["shift"]
    xprev = _shift(x, last)
    mu = p["mu"]
    xk = x + (xprev - x) * mu[0]
    xr = x + (xprev - x) * mu[1]
    k = torch.square(F.relu(xk @ p["wk"]))
    r = torch.sigmoid(xr @ p["wr"])
    v = k @ p["wv"]
    return v * r, {"shift": x[:, -1:].clone()}


def init_wkv_state(cfg, batch: int, device=None) -> Dict:
    d = cfg.d_model
    H, hd = cfg.n_heads, d // cfg.n_heads
    dt = dtype_of(cfg)
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return {"tm": {"shift": zeros((batch, 1, d), dt),
                   "h": zeros((batch, H, hd, hd), torch.float32)},
            "cm": {"shift": zeros((batch, 1, d), dt)}}
