"""Zamba2-style hybrid: a Mamba2 backbone with ONE shared attention + MLP
block (its weights reused) after every ``shared_attn_every`` ssm layers —
the port of ``repro/models/hybrid.py``.  zamba2_1p2b's 38 layers are 6
groups of 6 ssm layers, each followed by the shared block, and a tail of 2.

Parameters: ``{"embed", "ssm_main": [[ssm layer] * every] * G, "shared":
{"ln1", "attn", "ln2", "mlp"}, "final_norm"}`` plus ``"ssm_tail": [ssm
layer] * tail`` when ``n_layers`` leaves a tail; an ssm layer is ``{"ln",
"ssm"}``.  The cache is the reference's tree: ``{"pos", "ssm_main":
{"conv": (G,every,B,K-1,Cd), "h": (G,every,B,nh,hp,ds)}, "attn": {"k",
"v": (G,B,C,KV,hd), "kv_pos": (G,C)}, "ssm_tail": {...} or None}`` — one
KV cache entry for each application of the shared block.  Without a tail
(the scaled-down config: 12 layers at every 2) ``"ssm_tail"`` is None,
which holds no leaf: a snapshot has no page for it.

The shared block is the transformer's block (``transformer.block_fwd`` and
``block_decode``): on a CUDA tensor its prefill attention runs the flash
kernel at any length; on the CPU, and in training, the reference's plain
branch (dense up to 512 tokens, chunked above).  With ``cfg.remat ==
"full"`` every ssm layer and every group (its layers and the shared block)
are rematerialized, as the reference's nested ``jax.checkpoint``s are.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import basic as B
from repro_torch.models.layers import ssm as S
from repro_torch.sharding.rules import constrain_batch
from repro_torch.tree import index_tree, stack_trees


def _split(cfg) -> Tuple[int, int, int]:
    """(every, G groups, tail layers)."""
    every = cfg.shared_attn_every
    G = cfg.n_layers // every
    return every, G, cfg.n_layers - G * every


def _init_ssm_layer(cfg, gen: torch.Generator) -> Dict:
    return {"ln": B.init_norm(cfg, gen), "ssm": S.init_ssm(cfg, gen)}


def init_lm(cfg, gen: torch.Generator) -> Dict:
    every, G, tail = _split(cfg)
    p = {"embed": B.init_embedding(cfg, gen),
         "ssm_main": [[_init_ssm_layer(cfg, gen) for _ in range(every)]
                      for _ in range(G)],
         "shared": T.init_block(cfg, gen, "full", bool(cfg.n_experts)),
         "final_norm": B.init_norm(cfg, gen)}
    if tail:
        p["ssm_tail"] = [_init_ssm_layer(cfg, gen) for _ in range(tail)]
    return p


def _ssm_layer_fwd(cfg, lp, x, state=None):
    x = constrain_batch(x)
    h = B.apply_norm(lp["ln"], x, cfg.norm, cfg.norm_eps)
    if state is None:
        y, new_state = S.apply_ssm(lp["ssm"], h, cfg, None)
    else:
        y, new_state = S.decode_ssm(lp["ssm"], h, cfg, state)
    return x + y, new_state


def _shared_fwd(cfg, sp, x, positions, *, flash: bool):
    """The shared block over the whole sequence -> (x, (k, v)); ``block_fwd``
    pins its input's batch (``constrain_batch``), as the reference's
    ``_shared_fwd`` does."""
    x, kv, _aux = T.block_fwd(cfg, sp, x, positions, "full", flash=flash, aux=False)
    return x, kv


def _shared_decode(cfg, sp, x, kv_cache, pos):
    return T.block_decode(cfg, sp, x, kv_cache, pos, "full")


def _forward(cfg, params, x, positions):
    """Serving: every layer over the whole sequence; returns (x, per-group
    lists of ssm states, per-group (k, v), tail states or None)."""
    flash = x.is_cuda
    states, kvs = [], []
    for group in params["ssm_main"]:
        gstates = []
        for lp in group:
            x, st = _ssm_layer_fwd(cfg, lp, x)
            gstates.append(st)
        x, kv = _shared_fwd(cfg, params["shared"], x, positions, flash=flash)
        states.append(gstates)
        kvs.append(kv)
    tail_states = None
    if "ssm_tail" in params:
        tail_states = []
        for lp in params["ssm_tail"]:
            x, st = _ssm_layer_fwd(cfg, lp, x)
            tail_states.append(st)
    return x, states, kvs, tail_states


def _embed(params, tokens):
    table = params["embed"]["table"]
    return B.embed(params["embed"], torch.as_tensor(tokens, device=table.device))


def train_loss(cfg, params, batch) -> torch.Tensor:
    x = _embed(params, batch["tokens"])
    tokens = torch.as_tensor(batch["tokens"], device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat == "full"
    ssm_layer = lambda lp, h: _ssm_layer_fwd(cfg, lp, h)[0]

    def ssm_layers(layers, h):
        for lp in layers:
            h = B.remat(ssm_layer, lp, h) if remat else ssm_layer(lp, h)
        return h

    def group(layers, sp, h):
        h = ssm_layers(layers, h)
        return _shared_fwd(cfg, sp, h, positions, flash=False)[0]

    for layers in params["ssm_main"]:
        x = (B.remat(group, layers, params["shared"], x) if remat
             else group(layers, params["shared"], x))
    if "ssm_tail" in params:
        x = ssm_layers(params["ssm_tail"], x)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return B.lm_loss_chunked(params["embed"], x, tokens, chunk=cfg.loss_chunk)


def prefill(cfg, params, batch):
    x = _embed(params, batch["tokens"])
    S_ = x.shape[1]
    positions = torch.arange(S_, device=x.device)
    x, states, kvs, tail_states = _forward(cfg, params, x, positions)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x[:, -1:])
    cache = {"pos": torch.tensor(S_, dtype=torch.int32, device=x.device),
             "ssm_main": stack_trees([stack_trees(g) for g in states]),
             "attn": T._full_cache_from_kv(*stack_trees(kvs), S_),
             "ssm_tail": None if tail_states is None else stack_trees(tail_states)}
    return logits, cache


def init_cache(cfg, batch_size: int, seq_len: int, device) -> Dict:
    every, G, tail = _split(cfg)
    dt = B.dtype_of(cfg)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    C = seq_len + T.CACHE_PAD
    states = lambda n: stack_trees([S.init_ssm_state(cfg, batch_size, device)
                                    for _ in range(n)])
    return {"pos": torch.tensor(seq_len, dtype=torch.int32, device=device),
            "ssm_main": stack_trees([states(every) for _ in range(G)]),
            "attn": {"k": torch.zeros((G, batch_size, C, KV, hd), dtype=dt, device=device),
                     "v": torch.zeros((G, batch_size, C, KV, hd), dtype=dt, device=device),
                     "kv_pos": torch.full((G, C), -1, dtype=torch.int32, device=device)},
            "ssm_tail": states(tail) if tail else None}


def decode_step(cfg, params, cache, token):
    """token: (B,1) int -> (logits (B,1,V), new cache)."""
    pos = cache["pos"]
    x = _embed(params, token)

    def ssm_layers(layers, stacked, h):
        new = []
        for i, lp in enumerate(layers):
            h, st = _ssm_layer_fwd(cfg, lp, h, state=index_tree(stacked, i))
            new.append(st)
        return h, stack_trees(new)

    new_main, new_attn = [], []
    for g, layers in enumerate(params["ssm_main"]):
        x, st = ssm_layers(layers, index_tree(cache["ssm_main"], g), x)
        x, kv = _shared_decode(cfg, params["shared"], x,
                               index_tree(cache["attn"], g), pos)
        new_main.append(st)
        new_attn.append(kv)
    new_tail = None
    if "ssm_tail" in params:
        x, new_tail = ssm_layers(params["ssm_tail"], cache["ssm_tail"], x)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x)
    return logits, {"pos": pos + 1, "ssm_main": stack_trees(new_main),
                    "attn": stack_trees(new_attn), "ssm_tail": new_tail}
