"""Whisper-style encoder-decoder — the port of ``repro/models/encdec.py``.
The audio frontend is a stub, as in the reference: the input is frame
embeddings (B, encoder_seq, d), ``batch["frames"]``; the backbone (an
encoder, and a decoder with cross-attention) is real.  Positions are
sinusoidal in the encoder and learned (``dec_pos``, (max_seq, d)) in the
decoder; no RoPE (``rope_theta`` 0).

Parameters: ``{"embed", "dec_pos", "enc_layers": [enc layer] *
encoder_layers, "dec_layers": [dec layer] * n_layers, "enc_norm",
"final_norm"}``.  The cache is the reference's tree: ``{"pos", "self":
{"k", "v": (L,B,C,KV,hd), "kv_pos": (L,C)}, "cross": {"k", "v":
(L,B,encoder_seq,KV,hd)}}`` — the cross K/V are computed once, in prefill.

On a CUDA tensor the encoder's self-attention (not causal) and the
decoder's causal self-attention in prefill run the flash kernel; the
cross-attention, whose queries and keys differ in length, stays the plain
``full_attention``, as in the reference.  On the CPU, and in training,
every attention is the reference's plain branch.  ``dec_pos`` is read as
``jax.lax.dynamic_slice_in_dim`` reads it: a start past ``max_seq - S``
is clamped to it (torch indexing would raise instead).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import transformer as T
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import basic as B
from repro_torch.sharding.rules import constrain_batch, splittable_grad
from repro_torch.tree import index_tree, stack_trees


def _init_enc_layer(cfg, gen: torch.Generator) -> Dict:
    return {"ln1": B.init_norm(cfg, gen), "attn": A.init_attention(cfg, gen),
            "ln2": B.init_norm(cfg, gen), "mlp": B.init_mlp(cfg, gen)}


def _init_dec_layer(cfg, gen: torch.Generator) -> Dict:
    return {"ln1": B.init_norm(cfg, gen), "self_attn": A.init_attention(cfg, gen),
            "ln_x": B.init_norm(cfg, gen), "cross_attn": A.init_attention(cfg, gen),
            "ln2": B.init_norm(cfg, gen), "mlp": B.init_mlp(cfg, gen)}


def init_lm(cfg, gen: torch.Generator, max_seq: int) -> Dict:
    return {"embed": B.init_embedding(cfg, gen),
            "dec_pos": B.dense_init(gen, (max_seq, cfg.d_model), B.dtype_of(cfg),
                                    scale=0.01),
            "enc_layers": [_init_enc_layer(cfg, gen) for _ in range(cfg.encoder_layers)],
            "dec_layers": [_init_dec_layer(cfg, gen) for _ in range(cfg.n_layers)],
            "enc_norm": B.init_norm(cfg, gen),
            "final_norm": B.init_norm(cfg, gen)}


def _enc_layer(cfg, lp, h, flash: bool):
    z = B.apply_norm(lp["ln1"], h, cfg.norm, cfg.norm_eps)
    q, k, v = A.qkv(lp["attn"], z, cfg)
    o = T.self_attention(cfg, q, k, v, flash=flash, causal=False)
    o = splittable_grad(o.reshape(h.shape[0], h.shape[1], cfg.q_dim), -1, cfg.n_heads)
    h = h + o @ lp["attn"]["wo"]
    z = B.apply_norm(lp["ln2"], h, cfg.norm, cfg.norm_eps)
    return h + B.apply_mlp(lp["mlp"], z, cfg)


def encode(cfg, params, frames, *, train: bool = False):
    """(B, encoder_seq, d) frames -> the encoder's output, in the model's
    dtype.  Serving (``train`` False) sends attention to the flash kernel
    on a CUDA tensor; training takes the plain branch and rematerializes
    each layer under ``remat == "full"``."""
    dev = params["dec_pos"].device
    x = constrain_batch(torch.as_tensor(frames, device=dev).to(B.dtype_of(cfg)))
    x = x + B.sinusoidal_positions(x.shape[1], cfg.d_model, dev).to(x.dtype)
    flash = x.is_cuda and not train
    remat = train and cfg.remat == "full"
    layer = lambda lp, h: _enc_layer(cfg, lp, h, flash)
    for lp in params["enc_layers"]:
        x = B.remat(layer, lp, x) if remat else layer(lp, x)
    return B.apply_norm(params["enc_norm"], x, cfg.norm, cfg.norm_eps)


def _dec_layer(cfg, lp, x, enc_out, *, self_kv=None, cross_kv=None, pos=None,
               flash: bool = False):
    """One decoder layer: over the whole sequence when ``self_kv`` is None
    (train, prefill), else one token against the caches.  Returns (x, new
    self K/V — (k, v), or the updated cache dict — and the cross (k, v))."""
    x = constrain_batch(x)
    Bsz, S, _ = x.shape
    z = B.apply_norm(lp["ln1"], x, cfg.norm, cfg.norm_eps)
    q, k, v = A.qkv(lp["self_attn"], z, cfg)
    if self_kv is None:
        o = T.self_attention(cfg, q, k, v, flash=flash)
        new_self = (k, v)
    else:
        kc, vc, kp = A.cache_update(self_kv["k"], self_kv["v"], self_kv["kv_pos"],
                                    k, v, pos)
        o = T.decode_attention(q, kc, vc, kp, pos)
        new_self = {"k": kc, "v": vc, "kv_pos": kp}
    x = x + splittable_grad(o.reshape(Bsz, S, cfg.q_dim), -1, cfg.n_heads) @ lp["self_attn"]["wo"]

    z = B.apply_norm(lp["ln_x"], x, cfg.norm, cfg.norm_eps)
    if cross_kv is None:
        q, ck, cv = A.qkv(lp["cross_attn"], z, cfg, kv_x=enc_out)
    else:
        q = (z @ lp["cross_attn"]["wq"]).reshape(Bsz, S, cfg.n_heads, cfg.head_dim)
        ck, cv = cross_kv["k"], cross_kv["v"]
    o = A.full_attention(q, ck, cv, causal=False)
    x = x + splittable_grad(o.reshape(Bsz, S, cfg.q_dim), -1, cfg.n_heads) @ lp["cross_attn"]["wo"]

    z = B.apply_norm(lp["ln2"], x, cfg.norm, cfg.norm_eps)
    x = x + B.apply_mlp(lp["mlp"], z, cfg)
    return x, new_self, (ck, cv)


def _dec_pos(params, start, size: int) -> torch.Tensor:
    """``dynamic_slice_in_dim(dec_pos, start, size)``: rows [start, start +
    size) with start clamped into [0, max_seq - size]; ``start`` an int or
    a 0-d tensor (no host sync)."""
    table = params["dec_pos"]
    start = torch.clamp(torch.as_tensor(start, device=table.device),
                        0, table.shape[0] - size)
    return table.index_select(0, start + torch.arange(size, device=table.device))


def _decoder_inputs(cfg, params, tokens, offset=0):
    table = params["embed"]["table"]
    tokens = torch.as_tensor(tokens, device=table.device)
    x = B.embed(params["embed"], tokens)
    return x + _dec_pos(params, offset, tokens.shape[1])[None]


def train_loss(cfg, params, batch) -> torch.Tensor:
    enc_out = encode(cfg, params, batch["frames"], train=True)
    x = _decoder_inputs(cfg, params, batch["tokens"])
    tokens = torch.as_tensor(batch["tokens"], device=x.device)
    remat = cfg.remat == "full"
    layer = lambda lp, h, e: _dec_layer(cfg, lp, h, e)[0]
    for lp in params["dec_layers"]:
        x = B.remat(layer, lp, x, enc_out) if remat else layer(lp, x, enc_out)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    return B.lm_loss_chunked(params["embed"], x, tokens, chunk=cfg.loss_chunk)


def prefill(cfg, params, batch):
    enc_out = encode(cfg, params, batch["frames"])
    x = _decoder_inputs(cfg, params, batch["tokens"])
    S = x.shape[1]
    selfs, crosses = [], []
    for lp in params["dec_layers"]:
        x, kv, ckv = _dec_layer(cfg, lp, x, enc_out, flash=x.is_cuda)
        selfs.append(kv)
        crosses.append(ckv)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x[:, -1:])
    ck, cv = T._stack_kv(crosses)
    return logits, {"pos": torch.tensor(S, dtype=torch.int32, device=x.device),
                    "self": T._full_cache_from_kv(*T._stack_kv(selfs), S),
                    "cross": {"k": ck, "v": cv}}


def init_cache(cfg, batch_size: int, seq_len: int, device) -> Dict:
    dt = B.dtype_of(cfg)
    KV, hd, L = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    C = seq_len + T.CACHE_PAD
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    return {"pos": torch.tensor(seq_len, dtype=torch.int32, device=device),
            "self": {"k": zeros(L, batch_size, C, KV, hd),
                     "v": zeros(L, batch_size, C, KV, hd),
                     "kv_pos": torch.full((L, C), -1, dtype=torch.int32, device=device)},
            "cross": {"k": zeros(L, batch_size, cfg.encoder_seq, KV, hd),
                      "v": zeros(L, batch_size, cfg.encoder_seq, KV, hd)}}


def decode_step(cfg, params, cache, token):
    """token: (B,1) int -> (logits (B,1,V), new cache)."""
    pos = cache["pos"]
    x = _decoder_inputs(cfg, params, token, offset=pos)
    new_self = []
    for i, lp in enumerate(params["dec_layers"]):
        x, sc, _ = _dec_layer(cfg, lp, x, None, self_kv=index_tree(cache["self"], i),
                              cross_kv=index_tree(cache["cross"], i), pos=pos)
        new_self.append(sc)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x)
    return logits, {"pos": pos + 1, "self": stack_trees(new_self),
                    "cross": cache["cross"]}
