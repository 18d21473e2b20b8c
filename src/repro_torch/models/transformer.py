"""Decoder-only transformer LM: the dense, swa and local_global attention
patterns, the moe family and the vlm family — the port of
``repro/models/transformer.py``.

Parameters are the reference's tree with its stacked layer leaves split
into per-layer lists, run by plain loops (the reference's ``scan_layers``):
``{"embed": {"table"[, "unembed"]}, "final_norm": {...}}`` plus
``"layers": [block] * n_layers`` (full, swa), or for local_global
``"local_layers": [[block] * local_per_global] * G``, ``"global_layers":
[block] * G`` and, when ``n_layers`` leaves a remainder, ``"tail_local":
[block] * rem`` (gemma3_27b: 62 = 10 x 6 + 2).  ``models.convert`` stacks
them into the reference's (G, local_per_global, ...), (G, ...) and
(rem, ...) leaves.

A moe config (``n_experts`` > 0) gives every layer that is not a
local_global local layer a ``"moe"`` block (``layers.moe``) in place of
``"mlp"``, as the reference's ``init_block`` does; each layer's forward
returns its auxiliary load-balance loss beside its output.

The hybrid_moe family (granite 4.0-H; the JAX package has none) is a full
stack whose ``layer_types`` give each layer's mixer: a ``"mamba"`` layer
holds ``"ssm"`` (``layers.ssm``) where the others hold ``"attn"``, and
every layer, of either kind, its MoE with a shared expert.  Its cache
holds the attention layers' KV under ``"full"`` beside the Mamba layers'
``"ssm": {"conv": (n_mamba,B,K-1,Cd), "h": (n_mamba,B,nh,hp,ds)}``.  µP's
scalars (``embedding_multiplier``, ``attention_multiplier`` as the
softmax scale, ``residual_multiplier`` on every block's output,
``logits_scaling``) apply to every family here and are the identity at
their defaults.

Step functions:
  train_loss(params, batch)           — next-token CE (text positions only
                                        for vlm, whose patch embeddings are
                                        prepended to the tokens'), plus
                                        0.01 · (sum of the layers' aux) /
                                        n_layers for moe
  prefill(params, batch)              — (last_logits (B,1,V), cache)
  decode_step(params, cache, token)   — one token against the cache
The cache is the reference's tree, so its leaves flatten to the same paths
(and page keys): ``{"pos": 0-d int32}`` plus ``"full": {"k": (L,B,C,KV,hd),
"v", "kv_pos": (L,C)}`` with C = S + CACHE_PAD (full), ``"win"``: W-slot
ring buffers (L,B,W,KV,hd) with (L,W) positions (swa), or ``"local"``
(G,lpg,B,W,KV,hd), ``"full"`` (G,B,C,KV,hd) and ``"tail"`` (rem,B,W,KV,hd)
(local_global).  ``init_cache`` with ``cache_quant`` makes the full caches
int8 with bf16 per-(token, head) scales; ring caches stay in the model's
dtype and prefill caches carry no scales, so decode quantizes only a cache
``init_cache`` made, as the reference does.

On a CUDA tensor, prefill attention runs the flash kernel
(``kernels.ops.flash_attention``), except in a window layer longer than
its window, which runs ``banded_attention`` on every device; on the CPU it
is the reference's plain branch (dense up to 512 tokens, chunked above).
Decode attention (``decode_attention``) runs the decode kernel on a CUDA
tensor (``kernels.ops.decode_attention``, on the bf16 cache, or the int8
cache's dequantized K/V) and ``layers.attention.decode_attention``
elsewhere.
``train_loss`` always takes the plain branch: the flash kernel has no
backward (nor has the reference's), and its wrapper refuses inputs that
require a gradient.  With ``cfg.remat == "full"`` each layer is
rematerialized in the backward pass, as the reference's scan body is, and
for local_global the whole group as well.  Decode drops the aux loss, as
the reference's does.  The other families have modules of their own
(``rwkv_model``, ``hybrid``, ``encdec``), which reuse ``block_fwd``,
``block_decode``, ``self_attention`` and the cache helpers here, as the
reference's import its.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import basic as B
from repro_torch.models.layers import moe as M
from repro_torch.models.layers import ssm as SSM
from repro_torch.sharding.rules import constrain_batch, splittable_grad
from repro_torch.tree import index_tree, stack_trees

CACHE_PAD = 128  # decode caches get S + CACHE_PAD capacity
#: a layer kind -> the cache entry that holds its state
CACHE_KEY = {"full": "full", "window": "win", "mamba": "ssm"}


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a config of another family than the
    transformer's (``models.registry`` routes those)."""
    if cfg.family not in ("dense", "moe", "vlm", "hybrid_moe"):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the "
                         f"transformer's (models.registry routes it)")


# ---------------------------------------------------------------------- blocks
def init_block(cfg, gen: torch.Generator, kind: str) -> Dict:
    """kind: the attention pattern of a plain stack, ``"local"`` /
    ``"full"`` for local_global's local and global layers, or ``"mamba"``
    for a Mamba2 mixer; every layer but a local one is MoE in a moe
    config."""
    p = {"ln1": B.init_norm(cfg, gen)}
    if kind == "mamba":
        p["ssm"] = SSM.init_ssm(cfg, gen)
    else:
        p["attn"] = A.init_attention(cfg, gen)
    p["ln2"] = B.init_norm(cfg, gen)
    if cfg.n_experts and kind != "local":
        p["moe"] = M.init_moe(cfg, gen)
    else:
        p["mlp"] = B.init_mlp(cfg, gen)
    return p


def _zero(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _residual(cfg, x, y):
    """x + y, with y scaled by µP's ``residual_multiplier`` unless it is 1."""
    return x + (y if cfg.residual_multiplier == 1.0 else cfg.residual_multiplier * y)


def _mix(cfg, p, x, mixed, *, aux: bool = True):
    """Residual mixer output + MLP/MoE.  ``mixed`` is the attention's
    heads, projected out here, or a Mamba mixer's output, projected
    already.  Returns (x, aux_loss): 0 without MoE, and None when ``aux`` is
    False (decode).  On a mesh the residual is pinned (``constrain_batch``)
    before the norm: DTensor would otherwise carry the row-parallel
    projection's partial sums through the norm's scaling into the MLP,
    which then runs whole on every 'model' device; GSPMD reduces them here
    by itself.  The heads' gradient is gathered where they split unevenly
    (``splittable_grad``)."""
    if "attn" in p:
        mixed = splittable_grad(mixed, -1, cfg.n_heads) @ p["attn"]["wo"]
    x = constrain_batch(_residual(cfg, x, mixed))
    h = B.apply_norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    if "moe" not in p:
        return _residual(cfg, x, B.apply_mlp(p["mlp"], h, cfg)), (_zero(x) if aux else None)
    loss = M.aux_load_balance_loss(p["moe"], h, cfg) if aux else None
    return _residual(cfg, x, M.apply_moe(p["moe"], h, cfg)), loss


def self_attention(cfg, q, k, v, *, flash: bool, causal: bool = True):
    """Same-length attention over a whole sequence, q (B,S,H,hd), k/v
    (B,S,KV,hd): the flash kernel when ``flash`` (KV repeated for GQA),
    else the reference's plain branch — dense when not causal or up to 512
    tokens, chunked above."""
    scale = cfg.attn_scale
    if flash:
        G = cfg.n_heads // cfg.n_kv_heads
        kr, vr = (k, v) if G == 1 else (k.repeat_interleave(G, dim=2),
                                        v.repeat_interleave(G, dim=2))
        return ops.flash_attention(q, kr, vr, causal=causal, scale=scale)
    if not causal or q.shape[1] <= 512:
        return A.full_attention(q, k, v, causal=causal, scale=scale)
    return A.chunked_attention(q, k, v, cfg, causal=True, scale=scale)


def decode_attention(q, k_cache, v_cache, kv_positions, pos, *, window: int = 0,
                     scale=None):
    """One token's attention against a cache (``A.decode_attention``'s
    arguments and result): the decode kernel on a CUDA tensor, the plain
    version on any other device (the CPU, the dry-run's meta tensors)."""
    attend = ops.decode_attention if q.is_cuda else A.decode_attention
    return attend(q, k_cache, v_cache, kv_positions, pos, window=window, scale=scale)


def block_fwd(cfg, p, x, positions, kind: str, *, flash: bool,
              aux: bool = True) -> Tuple[torch.Tensor, Tuple, torch.Tensor]:
    """One layer over the whole sequence; returns (x, (k, v), aux loss, None
    unless ``aux``), a Mamba layer its {conv, h} state in place of (k, v).
    kind: 'full' | 'window' | 'mamba'.  A window layer longer than its
    window runs banded attention; otherwise ``flash`` sends the attention
    to the flash kernel (a causal mask equals the window's there), else to
    the plain branch."""
    x = constrain_batch(x)
    B_, S, _ = x.shape
    h = B.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    if kind == "mamba":
        y, state = SSM.apply_ssm(p["ssm"], h, cfg)
        x, loss = _mix(cfg, p, x, y, aux=aux)
        return x, state, loss
    q, k, v = A.qkv(p["attn"], h, cfg, positions)
    if kind == "window" and cfg.window and S > cfg.window:
        o = A.banded_attention(q, k, v, cfg, window=cfg.window, scale=cfg.attn_scale)
    else:
        o = self_attention(cfg, q, k, v, flash=flash)
    o = o.reshape(B_, S, cfg.q_dim)
    x, loss = _mix(cfg, p, x, o, aux=aux)
    return x, (k, v), loss


def _quantize_kv(t):
    """Per-(token, head) symmetric int8: (B,S,KV,hd) -> (int8, bf16 scale)."""
    tf = t.float()
    scale = torch.clamp(tf.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(tf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def block_decode(cfg, p, x, lcache, pos, kind: str):
    """x: (B,1,d); lcache: dict(k, v, kv_pos[, k_scale, v_scale]) for this
    layer, a ring buffer when kind == 'window', or a Mamba layer's dict(conv,
    h) when kind == 'mamba'."""
    x = constrain_batch(x)
    B_ = x.shape[0]
    h = B.apply_norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    if kind == "mamba":
        y, state = SSM.decode_ssm(p["ssm"], h, cfg, lcache)
        return _mix(cfg, p, x, y, aux=False)[0], state
    q, k, v = A.qkv(p["attn"], h, cfg, pos.reshape(1))
    scale = cfg.attn_scale
    ring = lcache["k"].shape[1] if kind == "window" else 0
    window = cfg.window if kind == "window" else 0
    if cfg.cache_quant and "k_scale" in lcache:
        kq, ks_new = _quantize_kv(k)
        vq, vs_new = _quantize_kv(v)
        with tracing.span("decode.cache_update"):
            kc, vc, kp = A.cache_update(lcache["k"], lcache["v"], lcache["kv_pos"],
                                        kq, vq, pos, ring=ring)
            ks, vs, _ = A.cache_update(lcache["k_scale"], lcache["v_scale"],
                                       lcache["kv_pos"], ks_new, vs_new, pos, ring=ring)
        # the product in float32, as XLA forms the reference's bf16 one
        # (excess precision): one rounding, to q's dtype
        kd = (kc.float() * ks.float()).to(q.dtype)
        vd = (vc.float() * vs.float()).to(q.dtype)
        with tracing.span("decode.attention"):
            o = decode_attention(q, kd, vd, kp, pos, window=window, scale=scale)
        new_cache = {"k": kc, "v": vc, "kv_pos": kp, "k_scale": ks, "v_scale": vs}
    else:
        with tracing.span("decode.cache_update"):
            kc, vc, kp = A.cache_update(lcache["k"], lcache["v"], lcache["kv_pos"],
                                        k, v, pos, ring=ring)
        with tracing.span("decode.attention"):
            o = decode_attention(q, kc, vc, kp, pos, window=window, scale=scale)
        new_cache = {"k": kc, "v": vc, "kv_pos": kp}
    o = o.reshape(B_, 1, cfg.q_dim)
    return _mix(cfg, p, x, o, aux=False)[0], new_cache


# ----------------------------------------------------------------- layer plans
def _groups(cfg) -> Tuple[int, int]:
    """local_global: (G whole groups, rem trailing local layers)."""
    g = cfg.local_per_global + 1
    G = cfg.n_layers // g
    return G, cfg.n_layers - G * g


def layer_plan(cfg) -> Tuple[str, ...]:
    """Per-layer kind: 'full', 'window' or (hybrid_moe) 'mamba'."""
    if cfg.family == "hybrid_moe":
        return tuple("mamba" if t == "mamba" else "full" for t in cfg.layer_types)
    if cfg.attn_pattern == "swa":
        return ("window",) * cfg.n_layers
    if cfg.attn_pattern == "local_global":
        G, rem = _groups(cfg)
        pat = ("window",) * cfg.local_per_global + ("full",)
        return pat * G + ("window",) * rem
    return ("full",) * cfg.n_layers


# ------------------------------------------------------------------------ init
def init_lm(cfg, gen: torch.Generator) -> Dict:
    check_supported(cfg)
    p = {"embed": B.init_embedding(cfg, gen), "final_norm": B.init_norm(cfg, gen)}
    if cfg.attn_pattern == "local_global":
        G, rem = _groups(cfg)
        p["local_layers"] = [[init_block(cfg, gen, "local")
                              for _ in range(cfg.local_per_global)] for _ in range(G)]
        p["global_layers"] = [init_block(cfg, gen, "full") for _ in range(G)]
        if rem:
            p["tail_local"] = [init_block(cfg, gen, "local") for _ in range(rem)]
    elif cfg.family == "hybrid_moe":
        p["layers"] = [init_block(cfg, gen, kind) for kind in layer_plan(cfg)]
    else:
        p["layers"] = [init_block(cfg, gen, cfg.attn_pattern)
                       for _ in range(cfg.n_layers)]
    return p


# --------------------------------------------------------------------- forward
def _embed(cfg, params, tokens):
    x = B.embed(params["embed"], tokens)
    return x if cfg.embedding_multiplier == 1.0 else x * cfg.embedding_multiplier


def _embed_inputs(cfg, params, batch):
    table = params["embed"]["table"]
    tokens = torch.as_tensor(batch["tokens"], device=table.device)
    x = _embed(cfg, params, tokens)
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patches"], device=x.device)
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    x = constrain_batch(x)
    positions = torch.arange(x.shape[1], device=x.device)
    return x, positions


def _backbone(cfg, params, x, positions, *, train: bool):
    """Every layer over the whole sequence; returns (x, kvs, aux), aux the
    sum of the layers' auxiliary losses in training (0 when serving, which
    computes none: the reference's prefill drops it).  Serving (``train``
    False) sends attention to the flash kernel on a CUDA tensor and returns
    the layers' (k, v) as the caches group them: ``{"layers": [kv]}`` (a
    Mamba layer's entry its state), or for local_global ``{"local": [[kv] *
    lpg] * G, "full": [kv] * G[, "tail": [kv] * rem]}``.  Training takes the
    plain branch, rematerializes as the reference's scans do under ``remat
    == "full"`` and returns no (k, v)."""
    flash = x.is_cuda and not train
    remat = train and cfg.remat == "full"

    def train_layer(lp, h, kind):
        h, _kv, aux = block_fwd(cfg, lp, h, positions, kind, flash=False)
        return h, aux

    def run(kinds, layers, h):
        kvs, aux = [], _zero(h)
        for lp, kind in zip(layers, kinds):
            if not train:
                h, kv, _ = block_fwd(cfg, lp, h, positions, kind, flash=flash, aux=False)
                kvs.append(kv)
                continue
            h, a = B.remat(train_layer, lp, h, kind) if remat else train_layer(lp, h, kind)
            aux = aux + a
        return h, kvs, aux

    if cfg.attn_pattern != "local_global":
        x, kvs, aux = run(layer_plan(cfg), params["layers"], x)
        return x, {"layers": kvs}, aux

    def group(lps, gp, h):
        h, lkv, laux = run(("window",) * len(lps), lps, h)
        if train:  # the global layer is rematerialized with its group only
            h, gaux = train_layer(gp, h, "full")
            return h, laux + gaux
        h, gkv, _ = block_fwd(cfg, gp, h, positions, "full", flash=flash, aux=False)
        return h, lkv, gkv

    out = {"local": [], "full": []}
    aux = _zero(x)
    for lps, gp in zip(params["local_layers"], params["global_layers"]):
        if train:
            # remat the WHOLE group, as the reference does: its global
            # layer's activations are recomputed, not kept per group
            x, a = B.remat(group, lps, gp, x) if remat else group(lps, gp, x)
            aux = aux + a
        else:
            x, lkv, gkv = group(lps, gp, x)
            out["local"].append(lkv)
            out["full"].append(gkv)
    if "tail_local" in params:
        x, out["tail"], a = run(("window",) * len(params["tail_local"]),
                                params["tail_local"], x)
        aux = aux + a
    return x, out, aux


def train_loss(cfg, params, batch) -> torch.Tensor:
    check_supported(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    tokens = torch.as_tensor(batch["tokens"], device=x.device)
    x, _, aux = _backbone(cfg, params, x, positions, train=True)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    if cfg.family == "vlm":
        x = x[:, cfg.n_patches:]  # loss only on text positions
    loss = B.lm_loss_chunked(params["embed"], x, tokens, chunk=cfg.loss_chunk,
                             logits_scaling=cfg.logits_scaling)
    if cfg.n_experts:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss


# ---------------------------------------------------------------------- caches
def _stack_kv(kvs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nested lists of) per-layer (k, v) -> stacked (..., B, S, KV, hd)."""
    if isinstance(kvs, tuple):
        return kvs
    parts = [_stack_kv(kv) for kv in kvs]
    return torch.stack([k for k, _ in parts]), torch.stack([v for _, v in parts])


def _full_cache_from_kv(k, v, S, pad=CACHE_PAD):
    """k, v: (L,B,S,KV,hd) -> capacity S+pad cache with (L, S+pad) kv_pos."""
    kc = F.pad(k, (0, 0, 0, 0, 0, pad))
    vc = F.pad(v, (0, 0, 0, 0, 0, pad))
    kv_pos = torch.cat([torch.arange(S, dtype=torch.int32, device=k.device),
                        torch.full((pad,), -1, dtype=torch.int32, device=k.device)])
    return {"k": kc, "v": vc, "kv_pos": kv_pos.expand(k.shape[0], -1).clone()}


def _ring_cache_from_kv(k, v, S, W):
    """k, v: (*lead, B, S, KV, hd) -> W-slot ring caches keeping the last W
    tokens, with (*lead, W) kv_pos.  For S >= W the window is rotated by the
    reference's ``argsort`` of (arange(W) - shift) mod W, shift = (S - W)
    mod W, and its positions travel with it; for S < W token p sits at slot
    p and the empty slots (-1) are at the back."""
    lead = k.shape[:-4]
    dev = k.device
    if S >= W:
        pos = torch.arange(S - W, S, dtype=torch.int32, device=dev)
        shift = (S - W) % W
        idx = torch.remainder(torch.arange(W, device=dev) - shift, W)
        inv = torch.argsort(idx)
        kw, vw = k[..., S - W:, :, :], v[..., S - W:, :, :]
        kc, vc, kv_pos = kw[..., inv, :, :], vw[..., inv, :, :], pos[inv]
    else:
        kv_pos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                            torch.full((W - S,), -1, dtype=torch.int32, device=dev)])
        kc = F.pad(k, (0, 0, 0, 0, 0, W - S))
        vc = F.pad(v, (0, 0, 0, 0, 0, W - S))
    return {"k": kc, "v": vc, "kv_pos": kv_pos.expand(*lead, W).clone()}


def prefill(cfg, params, batch):
    check_supported(cfg)
    x, positions = _embed_inputs(cfg, params, batch)
    S = x.shape[1]
    x, kvs, _aux = _backbone(cfg, params, x, positions, train=False)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x[:, -1:], cfg.logits_scaling)
    cache = {"pos": torch.tensor(S, dtype=torch.int32, device=x.device)}
    W = cfg.window
    if cfg.attn_pattern == "local_global":
        cache["local"] = _ring_cache_from_kv(*_stack_kv(kvs["local"]), S, W)
        cache["full"] = _full_cache_from_kv(*_stack_kv(kvs["full"]), S)
        if "tail" in kvs:
            cache["tail"] = _ring_cache_from_kv(*_stack_kv(kvs["tail"]), S, W)
    elif cfg.attn_pattern == "swa":
        cache["win"] = _ring_cache_from_kv(*_stack_kv(kvs["layers"]), S, W)
    else:
        plan, per = layer_plan(cfg), kvs["layers"]
        if "mamba" in plan:
            cache["ssm"] = stack_trees([st for st, k in zip(per, plan) if k == "mamba"])
            per = [kv for kv, k in zip(per, plan) if k != "mamba"]
        if per:
            cache["full"] = _full_cache_from_kv(*_stack_kv(per), S)
    return logits, cache


def init_cache(cfg, batch_size: int, seq_len: int, device) -> Dict:
    """Empty cache with capacity for seq_len history (+pad): int8 full
    caches with bf16 scales under ``cache_quant``, W-slot ring caches in the
    model's dtype for window layers, zero Mamba states for mamba layers."""
    check_supported(cfg)
    dt = B.dtype_of(cfg)
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    C = seq_len + CACHE_PAD
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    empty = lambda shape: torch.full(shape, -1, dtype=torch.int32, device=device)

    def full(n):
        kv_dt = torch.int8 if cfg.cache_quant else dt
        c = {"k": zeros((n, batch_size, C, KV, hd), kv_dt),
             "v": zeros((n, batch_size, C, KV, hd), kv_dt),
             "kv_pos": empty((n, C))}
        if cfg.cache_quant:
            c["k_scale"] = zeros((n, batch_size, C, KV, 1), torch.bfloat16)
            c["v_scale"] = zeros((n, batch_size, C, KV, 1), torch.bfloat16)
        return c

    def ring(lead):
        W = cfg.window
        return {"k": zeros(lead + (batch_size, W, KV, hd), dt),
                "v": zeros(lead + (batch_size, W, KV, hd), dt),
                "kv_pos": empty(lead + (W,))}

    cache = {"pos": torch.tensor(seq_len, dtype=torch.int32, device=device)}
    if cfg.attn_pattern == "local_global":
        G, rem = _groups(cfg)
        cache.update(local=ring((G, cfg.local_per_global)), full=full(G))
        if rem:
            cache["tail"] = ring((rem,))
    elif cfg.attn_pattern == "swa":
        cache["win"] = ring((cfg.n_layers,))
    else:
        n_mamba = layer_plan(cfg).count("mamba")
        if n_mamba:
            cache["ssm"] = stack_trees([SSM.init_ssm_state(cfg, batch_size, device)
                                        for _ in range(n_mamba)])
        if n_mamba < cfg.n_layers:
            cache["full"] = full(cfg.n_layers - n_mamba)
    return cache


def decode_step(cfg, params, cache, token):
    """token: (B,1) int -> (logits (B,1,V), new cache).  Spans
    ``decode.cache_update`` (each layer's cache write) and
    ``decode.attention`` (its attention over the cache), both in
    ``block_decode``, and ``decode.stack`` (the ``stack_trees`` calls that
    rebuild the cache)."""
    pos = cache["pos"]
    x = _embed(cfg, params, token)

    def run(kinds, layers, caches, h):
        """Each layer on the next layer of its kind's stacked cache in
        ``caches`` (``CACHE_KEY``); returns (h, the same keys' new stacks)."""
        new = {}
        for lp, kind in zip(layers, kinds):
            mine = new.setdefault(CACHE_KEY[kind], [])
            stacked = caches[CACHE_KEY[kind]]
            h, nc = block_decode(cfg, lp, h, index_tree(stacked, len(mine)), pos, kind)
            mine.append(nc)
        with tracing.span("decode.stack"):
            return h, {key: stack_trees(v) for key, v in new.items()}

    new_cache = {"pos": pos + 1}
    if cfg.attn_pattern == "local_global":
        local, full = [], []
        for g, (lps, gp) in enumerate(zip(params["local_layers"],
                                          params["global_layers"])):
            x, nl = run(("window",) * len(lps), lps, {"win": index_tree(cache["local"], g)}, x)
            x, nf = block_decode(cfg, gp, x, index_tree(cache["full"], g), pos, "full")
            local.append(nl["win"])
            full.append(nf)
        with tracing.span("decode.stack"):
            new_cache.update(local=stack_trees(local), full=stack_trees(full))
        if "tail_local" in params:
            tail = params["tail_local"]
            x, nt = run(("window",) * len(tail), tail, {"win": cache["tail"]}, x)
            new_cache["tail"] = nt["win"]
    else:
        x, new = run(layer_plan(cfg), params["layers"], cache, x)
        new_cache.update(new)
    x = B.apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
    logits = B.unembed(params["embed"], x, cfg.logits_scaling)
    return logits, new_cache
