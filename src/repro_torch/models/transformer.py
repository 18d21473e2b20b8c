"""Decoder-only transformer LM, dense family with full attention — the port
of ``repro/models/transformer.py``'s serving path (olmo_1b and its kin).

Parameters: ``{"embed": {"table"[, "unembed"]}, "final_norm": {...},
"layers": [block params] * n_layers}`` — the reference's tree with the
stacked (L, ...) layer leaves split per layer, run by a plain loop (the
reference's ``scan_layers``).

Step functions:
  train_loss(params, batch)           — next-token CE
  prefill(params, batch)              — (last_logits (B,1,V), cache)
  decode_step(params, cache, token)   — one token against the cache
The cache is the reference's tree, ``{"pos": 0-d int32, "full": {"k":
(L,B,C,KV,hd), "v": ..., "kv_pos": (L,C) int32}}`` with C = S + CACHE_PAD, so
its leaves flatten to the same paths (and page keys) as the reference's.

On a CUDA tensor, prefill attention runs the flash kernel
(``kernels.ops.flash_attention``) at every sequence length; on the CPU it is
the reference's plain branch (dense up to 512 tokens, chunked above).
``train_loss`` always takes the plain branch: the flash kernel has no
backward (nor has the reference's), and its wrapper refuses inputs that
require a gradient.  With ``cfg.remat == "full"`` each layer is
rematerialized in the backward pass, as the reference's scan body is.  Ring
(sliding-window) and int8 caches, MoE, vlm and local_global are not ported
yet: ``check_supported`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import basic as B

CACHE_PAD = 128  # decode caches get S + CACHE_PAD capacity


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for what this slice does not port."""
    missing = [what for what, bad in (
        (f"family {cfg.family!r}", cfg.family != "dense"),
        (f"attn_pattern {cfg.attn_pattern!r} (ring caches)",
         cfg.attn_pattern != "full"),
        ("MoE layers", bool(cfg.n_experts)),
        ("the int8 KV cache", cfg.cache_quant)) if bad]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet "
            f"(ROADMAP.md, Queue 1)")


# ---------------------------------------------------------------------- blocks
def init_block(cfg, gen: torch.Generator) -> Dict:
    return {"ln1": B.init_norm(cfg, gen), "attn": A.init_attention(cfg, gen),
            "ln2": B.init_norm(cfg, gen), "mlp": B.init_mlp(cfg, gen)}


def _mix(cfg, p, x, attn_out):
    """Residual attn-out projection + MLP."""
    x = x + attn_out @ p["attn"]["wo"]
    h = B.apply_norm(p["ln2"], x, cfg.norm)
    return x + B.apply_mlp(p["mlp"], h, cfg)


def block_fwd(cfg, p, x, positions, *, flash: bool) -> Tuple[torch.Tensor, Tuple]:
    """One layer over the whole sequence; returns (x, (k, v)).  ``flash``
    sends the attention to the flash kernel, else to the plain branch."""
    B_, S, _ = x.shape
    h = B.apply_norm(p["ln1"], x, cfg.norm)
    q, k, v = A.qkv(p["attn"], h, cfg, positions)
    if flash:
        G = cfg.n_heads // cfg.n_kv_heads
        kr, vr = (k, v) if G == 1 else (k.repeat_interleave(G, dim=2),
                                        v.repeat_interleave(G, dim=2))
        o = ops.flash_attention(q, kr, vr, causal=True)
    elif S <= 512:
        o = A.full_attention(q, k, v, causal=True)
    else:
        o = A.chunked_attention(q, k, v, cfg, causal=True)
    o = o.reshape(B_, S, cfg.q_dim)
    return _mix(cfg, p, x, o), (k, v)


def block_decode(cfg, p, x, lcache, pos):
    """x: (B,1,d); lcache: dict(k, v, kv_pos) for this layer."""
    B_ = x.shape[0]
    h = B.apply_norm(p["ln1"], x, cfg.norm)
    q, k, v = A.qkv(p["attn"], h, cfg, pos.reshape(1))
    kc, vc, kp = A.cache_update(lcache["k"], lcache["v"], lcache["kv_pos"],
                                k, v, pos)
    o = A.decode_attention(q, kc, vc, kp, pos)
    o = o.reshape(B_, 1, cfg.q_dim)
    return _mix(cfg, p, x, o), {"k": kc, "v": vc, "kv_pos": kp}


# ------------------------------------------------------------------------ init
def init_lm(cfg, gen: torch.Generator) -> Dict:
    check_supported(cfg)
    return {"embed": B.init_embedding(cfg, gen),
            "final_norm": B.init_norm(cfg, gen),
            "layers": [init_block(cfg, gen) for _ in range(cfg.n_layers)]}


# --------------------------------------------------------------------- forward
def _embed_inputs(cfg, params, batch):
    table = params["embed"]["table"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    x = B.embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _backbone(cfg, params, x, positions):
    """Serving's pass: returns (x, [(k, v)] per layer)."""
    kvs = []
    for lp in params["layers"]:
        x, kv = block_fwd(cfg, lp, x, positions, flash=x.is_cuda)
        kvs.append(kv)
    return x, kvs


def train_loss(cfg, params, batch) -> torch.Tensor:
    check_supported(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    tokens = torch.as_tensor(batch["tokens"], device=x.device)

    def layer(lp, h):
        return block_fwd(cfg, lp, h, positions, flash=False)[0]

    for lp in params["layers"]:
        x = B.remat(layer, lp, x) if cfg.remat == "full" else layer(lp, x)
    x = B.apply_norm(params["final_norm"], x, cfg.norm)
    return B.lm_loss_chunked(params["embed"], x, tokens, chunk=cfg.loss_chunk)


# ---------------------------------------------------------------------- caches
def _full_cache_from_kv(k, v, S, pad=CACHE_PAD):
    """k, v: (L,B,S,KV,hd) -> capacity S+pad cache with (L, S+pad) kv_pos."""
    kc = F.pad(k, (0, 0, 0, 0, 0, pad))
    vc = F.pad(v, (0, 0, 0, 0, 0, pad))
    kv_pos = torch.cat([torch.arange(S, dtype=torch.int32, device=k.device),
                        torch.full((pad,), -1, dtype=torch.int32, device=k.device)])
    return {"k": kc, "v": vc, "kv_pos": kv_pos.expand(k.shape[0], -1).clone()}


def prefill(cfg, params, batch):
    check_supported(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    x, kvs = _backbone(cfg, params, x, positions)
    x = B.apply_norm(params["final_norm"], x, cfg.norm)
    logits = B.unembed(params["embed"], x[:, -1:])
    k = torch.stack([kv[0] for kv in kvs])
    v = torch.stack([kv[1] for kv in kvs])
    cache = {"pos": torch.tensor(S, dtype=torch.int32, device=x.device),
             "full": _full_cache_from_kv(k, v, S)}
    return logits, cache


def init_cache(cfg, batch_size: int, seq_len: int, device) -> Dict:
    """Empty cache with capacity for seq_len history (+pad)."""
    check_supported(cfg)
    dt = B.dtype_of(cfg)
    C = seq_len + CACHE_PAD
    shape = (cfg.n_layers, batch_size, C, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.tensor(seq_len, dtype=torch.int32, device=device),
            "full": {"k": torch.zeros(shape, dtype=dt, device=device),
                     "v": torch.zeros(shape, dtype=dt, device=device),
                     "kv_pos": torch.full((cfg.n_layers, C), -1,
                                          dtype=torch.int32, device=device)}}


def decode_step(cfg, params, cache, token):
    """token: (B,1) int -> (logits (B,1,V), new cache)."""
    pos = cache["pos"]
    x = B.embed(params["embed"], token)
    full = cache["full"]
    new = {"k": [], "v": [], "kv_pos": []}
    for i, lp in enumerate(params["layers"]):
        lc = {name: full[name][i] for name in new}
        x, nc = block_decode(cfg, lp, x, lc, pos)
        for name in new:
            new[name].append(nc[name])
    x = B.apply_norm(params["final_norm"], x, cfg.norm)
    logits = B.unembed(params["embed"], x)
    return logits, {"pos": pos + 1,
                    "full": {name: torch.stack(ts) for name, ts in new.items()}}
