"""RWKV6 language model (the ssm family): attention-free, each block a time
mix and a channel mix with token shift — the port of
``repro/models/rwkv_model.py``.

Parameters: ``{"embed", "ln_in", "layers": [block] * n_layers,
"final_norm"}``, a block ``{"ln1", "ln2", "tm", "cm"}`` (``layers.rwkv``).
Decode carries a (shift, wkv state) per layer, O(1) in the context length,
in the reference's cache tree: ``{"pos": 0-d int32, "layers": {"tm":
{"shift": (L,B,1,d), "h": (L,B,H,hd,hd) float32}, "cm": {"shift":
(L,B,1,d)}}}``.  No attention, so no flash kernel: every device runs the
plain ``wkv_chunked``.  With ``cfg.remat == "full"`` each layer is
rematerialized in the backward pass, as the reference's scan body is.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.layers import basic as B
from repro_torch.models.layers import rwkv as R
from repro_torch.sharding.rules import constrain_batch
from repro_torch.tree import index_tree, stack_trees


def init_lm(cfg, gen: torch.Generator) -> Dict:
    def init_layer():
        return {"ln1": B.init_norm(cfg, gen), "ln2": B.init_norm(cfg, gen),
                **R.init_rwkv_block(cfg, gen)}

    return {"embed": B.init_embedding(cfg, gen), "ln_in": B.init_norm(cfg, gen),
            "layers": [init_layer() for _ in range(cfg.n_layers)],
            "final_norm": B.init_norm(cfg, gen)}


def _block(cfg, lp, x, state=None):
    x = constrain_batch(x)
    tm_state = None if state is None else state["tm"]
    cm_state = None if state is None else state["cm"]
    h = B.apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    y, new_tm = R.apply_time_mix(lp["tm"], h, cfg, tm_state)
    x = x + y
    h = B.apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    y, new_cm = R.apply_channel_mix(lp["cm"], h, cfg, cm_state)
    x = x + y
    return x, {"tm": new_tm, "cm": new_cm}


def _inputs(cfg, params, tokens):
    table = params["embed"]["table"]
    x = B.embed(params["embed"], torch.as_tensor(tokens, device=table.device))
    return B.apply_norm(params["ln_in"], x, cfg.norm, cfg.norm_eps)


def train_loss(cfg, params, batch) -> torch.Tensor:
    x = _inputs(cfg, params, batch["tokens"])
    tokens = torch.as_tensor(batch["tokens"], device=x.device)
    remat = cfg.remat == "full"
    layer = lambda lp, h: _block(cfg, lp, h)[0]
    for lp in params["layers"]:
        x = B.remat(layer, lp, x) if remat else layer(lp, x)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return B.lm_loss_chunked(params["embed"], x, tokens, chunk=cfg.loss_chunk)


def prefill(cfg, params, batch):
    x = _inputs(cfg, params, batch["tokens"])
    S = x.shape[1]
    states = []
    for lp in params["layers"]:
        x, st = _block(cfg, lp, x)
        states.append(st)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x[:, -1:])
    return logits, {"pos": torch.tensor(S, dtype=torch.int32, device=x.device),
                    "layers": stack_trees(states)}


def init_cache(cfg, batch_size: int, seq_len: int, device) -> Dict:
    """The decode state of ``seq_len`` tokens of history: zeros whatever
    the length."""
    return {"pos": torch.tensor(seq_len, dtype=torch.int32, device=device),
            "layers": stack_trees([R.init_wkv_state(cfg, batch_size, device)
                                   for _ in range(cfg.n_layers)])}


def decode_step(cfg, params, cache, token):
    """token: (B,1) int -> (logits (B,1,V), new cache)."""
    x = _inputs(cfg, params, token)
    new = []
    for i, lp in enumerate(params["layers"]):
        x, st = _block(cfg, lp, x, state=index_tree(cache["layers"], i))
        new.append(st)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x)
    return logits, {"pos": cache["pos"] + 1, "layers": stack_trees(new)}
