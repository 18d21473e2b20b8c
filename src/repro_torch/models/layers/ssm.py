"""Mamba2 layer in the chunked SSD (state-space dual) form — the port of
``repro/models/layers/ssm.py``.

The sequence is split into chunks; within a chunk the SSD identity turns
the recurrence into masked products, and a plain loop (the reference's
``lax.scan``) carries the (nh, hp, ds) state across chunks.  Decode is the
single-token recurrence.  Plain PyTorch on every device: the reference has
no kernel here.

Recurrence (a scalar A per head, one group):
    h_t = exp(dt_t·A) · h_{t-1} + dt_t · B_t ⊗ x_t        y_t = C_t·h_t + D·x_t

Parity with the reference, kept on purpose:
  - the chunk is ``ssm_chunk`` halved until it divides S;
  - ``softplus`` is ``jax.nn.softplus``: ``logaddexp(x, 0)``, computed by
    ``torch.logaddexp``, whose formula (max + log1p(exp(-|x|))) is JAX's;
    ``torch.nn.functional.softplus`` turns into the identity above 20;
  - dtypes follow JAX's promotion: ``D`` is cast to the activations' dtype
    before it scales them, the gate norm's product is float32, and the
    decode state is float32.
Conv states are copies, not views of the sequence they come from.

Granite 4.0-H's mixer (the hybrid_moe family) adds two options the
reference lacks: a conv bias (``ssm_conv_bias``, leaf ``conv_b``) and the
gated RMSNorm (``ssm_gated_norm``): rmsnorm(y·silu(z))·w in float32 over
all of d_inner, eps ``norm_eps``, where zamba2 scales y·silu(z) by w alone.

Spans (``repro_torch.tracing``): ``ssm.proj`` (in-projection and conv),
``ssm.scan`` (the chunked SSD; counter ``ssm.chunks``, chunks a call) in a
sequence, ``ssm.step`` (the one-token recurrence) in decode, and
``ssm.out`` (gate, norm and out-projection) in both.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models.layers.basic import dense_init, dtype_of, halved_chunk


def init_ssm(cfg, gen: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    f32 = torch.float32
    p = {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * ds + nh), dt),
        "conv_w": dense_init(gen, (cfg.ssm_conv, conv_dim), dt, scale=0.5),
        "A_log": torch.zeros((nh,), dtype=f32),
        "D": torch.ones((nh,), dtype=f32),
        "dt_bias": torch.zeros((nh,), dtype=f32),
        "out_proj": dense_init(gen, (di, d), dt),
        "gate_norm": torch.ones((di,), dtype=dt),
    }
    if cfg.ssm_conv_bias:
        p["conv_b"] = torch.zeros((conv_dim,), dtype=dt)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(cfg, proj):
    di, ds = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * ds], proj[..., 2 * di + 2 * ds:]


def _causal_conv(xBC, conv_w, conv_state=None, conv_b=None):
    """Depthwise causal conv over time.  xBC: (B,S,Cd); conv_w: (K,Cd);
    conv_state: (B,K-1,Cd) activations carried for decode; conv_b: (Cd,)
    or None.  The taps are summed left to right, as the reference's Python
    ``sum``, and the bias added last."""
    K = conv_w.shape[0]
    pad = torch.zeros_like(xBC[:, :K - 1]) if conv_state is None else conv_state
    xp = torch.cat([pad, xBC], dim=1)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(K))
    if conv_b is not None:
        out = out + conv_b
    return F.silu(out), xp[:, -(K - 1):].clone()


def _segsum_decay(dA):
    """dA: (B,c,nh) per-step log-decay -> (L (B,i,j,nh) = exp(Σ_{t=j+1..i}
    dA_t) on and below the diagonal, 0 above; the cumulative sum (B,c,nh)).

    The one deliberate divergence from the reference: the upper triangle
    is masked before the ``exp``, not after.  Its differences are positive
    and, at a full config's 128-step chunk, overflow float32, so the
    reference's backward takes 0 · inf there and every gradient turns NaN
    (zamba2_1p2b cannot train); here that gradient is 0 · 0.  L and every
    gradient the reference computes finite are the same bit for bit."""
    cum = torch.cumsum(dA, dim=1)
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    c = dA.shape[1]
    tri = torch.ones((c, c), dtype=torch.bool, device=dA.device).tril()
    return torch.exp(torch.where(tri[None, :, :, None], diff, -torch.inf)), cum


def _ssd_chunk(h, xj, Bj, Cj, dAj, dtj):
    """One chunk: state (B,nh,hp,ds) and x (B,c,nh,hp), B/C (B,c,ds), dA/dt
    (B,c,nh) -> (y (B,c,nh,hp), state)."""
    L, cum = _segsum_decay(dAj)
    xdt = xj * dtj[..., None]                            # dt-weighted inputs
    scores = torch.einsum("bis,bjs->bij", Cj, Bj)
    y_intra = torch.einsum("bij,bijh,bjhp->bihp", scores, L, xdt)
    y_inter = torch.einsum("bis,bhps->bihp", Cj, h) * torch.exp(cum)[..., None]
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)       # (B,c,nh)
    h_new = torch.exp(cum[:, -1])[:, :, None, None] * h + torch.einsum(
        "bjs,bjhp->bhps", Bj, xdt * decay_to_end[..., None])
    return y_intra + y_inter, h_new


def ssm_chunked(cfg, x, B_in, C_in, dt, A, h0=None):
    """Chunked SSD.  x (B,S,nh,hp), B_in/C_in (B,S,ds), dt (B,S,nh) after
    softplus, A (nh,) negative.  Returns y (B,S,nh,hp) in x's dtype and the
    last state (B,nh,hp,ds) float32."""
    Bsz, S, nh, hp = x.shape
    ds = B_in.shape[-1]
    c = halved_chunk(cfg.ssm_chunk, S)
    n = S // c
    xc = x.reshape(Bsz, n, c, nh, hp).float()
    Bc = B_in.reshape(Bsz, n, c, ds).float()
    Cc = C_in.reshape(Bsz, n, c, ds).float()
    dtc = dt.reshape(Bsz, n, c, nh).float()
    dAc = dtc * A[None, None, None, :]                   # log-decay per step
    h = (torch.zeros((Bsz, nh, hp, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    tracing.count("ssm.chunks", n)
    ys = []
    for j in range(n):
        y, h = _ssd_chunk(h, xc[:, j], Bc[:, j], Cc[:, j], dAc[:, j], dtc[:, j])
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, nh, hp)
    return y.to(x.dtype), h


def _gate_out(params, y, z, x, cfg):
    """y·silu(z), RMS-normalised in float32 when ``cfg.ssm_gated_norm``,
    times the gate norm in float32, cast to x's dtype, and projected out."""
    if cfg.ssm_gated_norm:
        y = y.float() * F.silu(z.float())
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps)
    else:
        y = y * F.silu(z)
    y = (y.float() * params["gate_norm"].float()).to(x.dtype)
    return y @ params["out_proj"]


def apply_ssm(params: Dict, x: torch.Tensor, cfg, state=None):
    """The Mamba2 mixer over a sequence.  state: None (train, prefill) or
    dict(conv, h) to resume.  Returns (y, new state)."""
    B, S, d = x.shape
    nh, hp, ds, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    with tracing.span("ssm.proj"):
        proj = x @ params["in_proj"]
        z, xBC, dt_raw = _split_proj(cfg, proj)
        conv_state = None if state is None else state["conv"]
        xBC, new_conv = _causal_conv(xBC, params["conv_w"], conv_state, params.get("conv_b"))
    with tracing.span("ssm.scan"):
        xs = xBC[..., :di].reshape(B, S, nh, hp)
        B_in = xBC[..., di:di + ds]
        C_in = xBC[..., di + ds:]
        dt = softplus(dt_raw.float() + params["dt_bias"])
        A = -torch.exp(params["A_log"])                  # (nh,) negative
        h0 = None if state is None else state["h"]
        y, h_last = ssm_chunked(cfg, xs, B_in, C_in, dt, A, h0=h0)
        y = y + xs * params["D"][None, None, :, None].to(xs.dtype)
    with tracing.span("ssm.out"):
        y = _gate_out(params, y.reshape(B, S, di), z, x, cfg)
    return y, {"conv": new_conv, "h": h_last}


def decode_ssm(params: Dict, x: torch.Tensor, cfg, state):
    """The single-token recurrence.  x: (B,1,d); state: dict(conv, h)."""
    B = x.shape[0]
    nh, hp, ds, di = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    with tracing.span("ssm.proj"):
        proj = x @ params["in_proj"]
        z, xBC, dt_raw = _split_proj(cfg, proj)
        xBC, new_conv = _causal_conv(xBC, params["conv_w"], state["conv"], params.get("conv_b"))
    with tracing.span("ssm.step"):
        xs = xBC[..., :di].reshape(B, nh, hp)
        B_in = xBC[..., di:di + ds][:, 0]                # (B,ds)
        C_in = xBC[..., di + ds:][:, 0]
        dt = softplus(dt_raw[:, 0].float() + params["dt_bias"])  # (B,nh)
        A = -torch.exp(params["A_log"])
        decay = torch.exp(dt * A)                        # (B,nh)
        h = state["h"] * decay[..., None, None] + torch.einsum(
            "bs,bhp,bh->bhps", B_in.float(), xs.float(), dt)
        y = torch.einsum("bs,bhps->bhp", C_in.float(), h)
        y = y + xs.float() * params["D"][None, :, None]
        y = y.reshape(B, 1, di).to(x.dtype)
    with tracing.span("ssm.out"):
        y = _gate_out(params, y, z, x, cfg)
    return y, {"conv": new_conv, "h": h}


def init_ssm_state(cfg, batch: int, device=None) -> Dict:
    nh, hp, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * ds
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype_of(cfg), device=device),
            "h": torch.zeros((batch, nh, hp, ds), dtype=torch.float32, device=device)}
