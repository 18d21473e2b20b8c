"""Attention: GQA projections, chunked online-softmax attention, banded
(sliding-window) attention, dense attention, and single-token decode against
full or ring-buffer KV caches — the port of
``repro/models/layers/attention.py``.

These are the plain versions, in float32 inside and cast back, and
differentiable: what the CPU runs, and what the card runs except in
serving's prefill — training's attention (the reference computes it outside
any kernel too) and decode attention, whose products stay
``torch.matmul``/``einsum`` as the reference left them to XLA.  Serving's
prefill attention goes through the flash kernel on the card
(``models.transformer.block_fwd``), except a window layer longer than its
window, which runs ``banded_attention`` here on every device (the
reference's kernel has no window either).  On a mesh the four attentions
run on each device's (batch, head) shards (``sharding.rules.local_heads``:
K/V's sequence gathered once a call, as the reference's
``constrain_batch_only`` hoists it once a layer), and a projection whose
sharding does not divide its heads is gathered before it is split
(``splittable``); both are the identity on plain tensors.  The query
offsets of the reference, which no family's path passes, are dropped.
The softmax scale is 1/sqrt(head_dim) unless a ``scale`` argument sets
it (µP's ``attention_multiplier``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers.basic import apply_rope, dense_init, dtype_of, remat
from repro_torch.sharding.rules import local_heads, splittable

NEG_INF = -1e30


def init_attention(cfg, gen: torch.Generator) -> Dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (d, cfg.q_dim), dt),
        "wk": dense_init(gen, (d, cfg.kv_dim), dt),
        "wv": dense_init(gen, (d, cfg.kv_dim), dt),
        "wo": dense_init(gen, (cfg.q_dim, d), dt),
    }


def qkv(params: Dict, x: torch.Tensor, cfg, positions=None, *, kv_x=None):
    """Project (+RoPE).  Returns q:(B,S,H,hd), k/v:(B,Skv,KV,hd): keys and
    values from ``kv_x`` when given (cross-attention; its keys are not
    rotated), else from ``x``.  No rotation without ``positions`` or with
    ``rope_theta`` 0 (whisper), and then no frequencies are built."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = splittable(x @ params["wq"], -1, cfg.n_heads).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = splittable(src @ params["wk"], -1, cfg.n_kv_heads).reshape(
        B, Skv, cfg.n_kv_heads, cfg.head_dim)
    v = splittable(src @ params["wv"], -1, cfg.n_kv_heads).reshape(
        B, Skv, cfg.n_kv_heads, cfg.head_dim)
    if positions is not None and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,KV,G,hd) for GQA: head h is in KV group h // G."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, hd)


def _scaled(qf: torch.Tensor, scale=None) -> torch.Tensor:
    """Float32 queries times the softmax scale: divided by sqrt(hd) when
    ``scale`` is None, as the reference does."""
    return qf / math.sqrt(qf.shape[-1]) if scale is None else qf * scale


# ----------------------------------------------------- chunked causal attention
def _kv_chunk(qg, kj, vj, q_pos, kv_pos, causal: bool, m, l, acc):
    """One KV chunk of the online softmax: (m, l, acc) -> updated."""
    s = torch.einsum("bqkgh,bckh->bqkgc", qg, kj.float())
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]               # (Sq, ck)
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, vj.float())
    return m_new, l_new, acc_new


@local_heads
def chunked_attention(q, k, v, cfg, *, causal: bool = True, scale=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks.  q:(B,Sq,H,hd), k/v:(B,Skv,KV,hd).
    Each chunk's body is rematerialized in the backward pass (``remat``), so
    training does not keep every chunk's (s, p) score buffers."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    KV = k.shape[2]
    ck = min(cfg.attn_chunk, Skv)
    if Skv % ck:
        ck = math.gcd(Skv, ck) or Skv
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    qg = _group(q, KV).float() * scale                        # (B,Sq,KV,G,hd)
    q_pos = torch.arange(Sq, device=q.device)
    G = H // KV
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    for j in range(Skv // ck):
        kv_pos = j * ck + torch.arange(ck, device=q.device)
        m, l, acc = remat(_kv_chunk, qg, k[:, j * ck:(j + 1) * ck],
                          v[:, j * ck:(j + 1) * ck], q_pos, kv_pos, causal,
                          m, l, acc)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ------------------------------------------------------------ banded (SWA) attn
def _band_chunk(qi, kj, vj, start: int, window: int, scale: float):
    """One query chunk of banded attention: qi (B,cq,KV,G,hd) against the
    band kj, vj (B,W+cq,KV,hd) that starts W tokens before it."""
    cq = qi.shape[1]
    s = torch.einsum("bqkgh,bckh->bqkgc", qi.float() * scale, kj.float())
    q_pos = start + torch.arange(cq, device=qi.device)
    kv_pos = start - window + torch.arange(window + cq, device=qi.device)
    diff = q_pos[:, None] - kv_pos[None, :]
    mask = (diff >= 0) & (diff < window) & (kv_pos[None, :] >= 0)
    s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqkgc,bckh->bqkgh", p, vj.float())


@local_heads
def banded_attention(q, k, v, cfg, *, window: int, scale=None) -> torch.Tensor:
    """Sliding-window causal attention: each query chunk sees [start-W,
    chunk_end), so compute is O(S·(W+cq)).  q:(B,S,H,hd), k/v:(B,S,KV,hd).
    K/V are padded in front by W zeros so every band is in range; each
    chunk is rematerialized in the backward pass, as in
    ``chunked_attention``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    cq = min(cfg.attn_chunk, S, max(window, 128))
    if S % cq:
        cq = math.gcd(S, cq)
    W = window
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    kp = F.pad(k, (0, 0, 0, 0, W, 0))
    vp = F.pad(v, (0, 0, 0, 0, W, 0))
    qg = _group(q, KV)
    outs = [remat(_band_chunk, qg[:, start:start + cq], kp[:, start:start + W + cq],
                  vp[:, start:start + W + cq], start, W, scale)
            for start in range(0, S, cq)]
    return torch.cat(outs, dim=1).reshape(B, S, H, hd).to(q.dtype)


# ------------------------------------------------------------------ full (enc)
@local_heads
def full_attention(q, k, v, *, causal: bool, scale=None) -> torch.Tensor:
    """Small-sequence dense attention."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = _scaled(_group(q, KV).float(), scale)
    s = torch.einsum("bqkgh,bckh->bqkgc", qg, k.float())
    if causal:
        mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


# --------------------------------------------------------------------- decode
@local_heads
def decode_attention(q, k_cache, v_cache, kv_positions, pos, *, window: int = 0,
                     scale=None):
    """One-token attention against a cache.
    q: (B,1,H,hd); caches: (B,C,KV,hd); kv_positions: (C,) absolute positions
    (-1 = empty slot); pos: the current position (0-d tensor or int);
    ``window`` > 0 also masks positions at or before pos - window; ``scale``
    the softmax scale (None: 1/sqrt(hd))."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = _scaled(_group(q, KV).float(), scale)
    s = torch.einsum("bqkgh,bckh->bqkgc", qg, k_cache.float())
    valid = (kv_positions >= 0) & (kv_positions <= pos)
    if window:
        valid &= kv_positions > pos - window
    s = s.masked_fill(~valid[None, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckh->bqkgh", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def cache_update(k_cache, v_cache, kv_positions, k_new, v_new, pos, *,
                 ring: int = 0):
    """Insert one token's k/v at `pos`: at slot pos % ring in a ring buffer
    (ring > 0), else at pos clipped into the cache.  Out of place, like the
    reference: returns new tensors."""
    C = k_cache.shape[1]
    pos = torch.as_tensor(pos, device=k_cache.device)
    slot = (torch.remainder(pos, ring) if ring else pos.clamp(0, C - 1)).reshape(1).long()
    k_cache = k_cache.index_copy(1, slot, k_new.to(k_cache.dtype))
    v_cache = v_cache.index_copy(1, slot, v_new.to(v_cache.dtype))
    kv_positions = kv_positions.index_copy(
        0, slot, pos.reshape(1).to(kv_positions.dtype))
    return k_cache, v_cache, kv_positions
