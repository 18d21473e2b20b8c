"""Plain PyTorch reference of the decoder-only transformer the benchmark
serves and trains: OLMo-1B (dense, non-parametric LayerNorm, MHA) and
granite-3.0-3b-a800m (RMSNorm, GQA, 40 experts top-8 with GShard capacity
dispatch in groups).

It imports nothing of the program.  It reads the configuration's ``model``
dict and the weight tree the benchmark made (the same tensors the program
gets), and computes in float32 (TF32 off) from the bfloat16 weights.  The
layer equations follow the published descriptions:

- pre-norm blocks, x + attn(norm(x)), then x + mlp(norm(x)); a final norm;
  logits against the tied embedding table;
- norms: LayerNorm without affine (OLMo) or RMSNorm with a scale, eps 1e-6;
- rotary embeddings over split halves (dim i pairs with i + hd/2), theta
  from the config, frequencies computed once on the CPU;
- causal attention, key/value head h // G for query head h;
- SwiGLU MLP: (silu(x Wg) * (x Wi)) Wo;
- MoE: float32 router, softmax, top-k (lower expert first on ties), gates
  renormalised over the k, each (token, slot) pair queued at its expert in
  token-major order within a group, pairs past the capacity
  ceil(g * k / E * 1.25) (rounded up to a multiple of 4 for g >= 8) dropped.
  When serving, the prompt is routed in groups of ``moe_group`` tokens
  (halved until they divide the prompt) and each later token as a group of
  its own, which is what a prefill and then one decode step a token route.

``precision="fp8"`` is the control: every product with a weight takes both
operands rounded to float8 e4m3 (a scale per tensor) before it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

#: float8 e4m3's largest finite value
FP8_MAX = 448.0


def no_tf32() -> None:
    """Plain float32 products on the card: TF32 would round their inputs to
    10 bits of mantissa."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to float8 e4m3 with one scale for the tensor,
    back in float32."""
    scale = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_ste(t: torch.Tensor) -> torch.Tensor:
    """``fp8_round`` in the forward pass, the identity in the backward."""
    return t + (fp8_round(t.detach()) - t).detach()


class Reference:
    def __init__(self, model: Dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.m = model
        self.precision = precision

    # ------------------------------------------------------------ primitives
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.precision == "fp8":
            return fp8_ste(x) @ fp8_ste(w)
        return x @ w

    def norm(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        if self.m["norm"] in ("layernorm", "nonparam_ln"):
            mu = x.mean(-1, keepdim=True)
            y = (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + 1e-6)
        else:
            y = x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + 1e-6)
        return y * p["scale"].float() if p else y

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        hd = x.shape[-1]
        exps = torch.arange(0, hd, 2, dtype=torch.float32)
        freqs = (self.m.get("rope_theta", 10_000.0) ** (-exps / hd)).to(x.device)
        ang = pos[:, None].float() * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def attention(self, p: Dict, h: torch.Tensor, q_block: int = 1024) -> torch.Tensor:
        m = self.m
        B, S, _ = h.shape
        H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        pos = torch.arange(S, device=h.device)
        q = self.rope(self.mm(h, p["wq"]).reshape(B, S, H, hd), pos)
        k = self.rope(self.mm(h, p["wk"]).reshape(B, S, KV, hd), pos)
        v = self.mm(h, p["wv"]).reshape(B, S, KV, hd)
        k = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)   # (B,H,S,hd)
        v = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
        q = q.transpose(1, 2) / math.sqrt(hd)
        outs = []
        for s0 in range(0, S, q_block):
            qs = q[:, :, s0:s0 + q_block]
            s = qs @ k.transpose(-1, -2)                            # (B,H,q,S)
            qpos = torch.arange(s0, s0 + qs.shape[2], device=h.device)
            s = s.masked_fill(qpos[:, None] < pos[None, :], float("-inf"))
            outs.append(torch.softmax(s, dim=-1) @ v)
        o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)
        return self.mm(o, p["wo"])

    def mlp(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        return self.mm(F.silu(self.mm(h, p["wg"])) * self.mm(h, p["wi"]), p["wo"])

    # ------------------------------------------------------------------- moe
    def capacity(self, g: int) -> int:
        m = self.m
        c = math.ceil(g * m["n_experts_active"] / m["n_experts"]
                      * m.get("capacity_factor", 1.25))
        return max(1, min(g, (c + 3) & ~3 if g >= 8 else c))

    def group(self, S: int) -> int:
        g = min(self.m.get("moe_group", 256), S)
        while S % g:
            g //= 2
        return g

    def route(self, router: torch.Tensor, x: torch.Tensor, g: int):
        """x (N, d), N a whole number of groups of g -> (experts (N, k),
        gates (N, k), kept (N, k))."""
        m = self.m
        E, k = m["n_experts"], m["n_experts_active"]
        gates = torch.softmax(x @ router.float(), dim=-1)
        topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
        topv, topi = topv[:, :k], topi[:, :k]
        topv = topv / topv.sum(-1, keepdim=True).clamp(min=1e-9)
        onehot = F.one_hot(topi.reshape(-1, g * k), E)             # (n, g*k, E)
        before = torch.cumsum(onehot, dim=1) - onehot
        pos = (before * onehot).sum(-1).reshape(-1, k)
        return topi, topv, pos < self.capacity(g)

    def moe(self, p: Dict, h: torch.Tensor, prompt_len: int) -> torch.Tensor:
        B, S, d = h.shape
        P = min(prompt_len, S)
        parts = [self.route(p["router"], h[:, :P].reshape(-1, d), self.group(P))]
        if S > P:  # every served token is a group of one
            parts.append(self.route(p["router"], h[:, P:].reshape(-1, d), 1))
        rows = [h[:, :P].reshape(-1, d)] + ([h[:, P:].reshape(-1, d)] if S > P else [])
        out = []
        for x, (topi, topv, keep) in zip(rows, parts):
            y = torch.zeros_like(x)
            for e in range(self.m["n_experts"]):
                tok, slot = torch.nonzero((topi == e) & keep, as_tuple=True)
                if tok.numel():
                    ye = self.mm(F.silu(self.mm(x[tok], p["wg"][e]))
                                 * self.mm(x[tok], p["wi"][e]), p["wo"][e])
                    y.index_add_(0, tok, ye * topv[tok, slot, None])
            out.append(y)
        return torch.cat([out[0].reshape(B, P, d)]
                         + ([out[1].reshape(B, S - P, d)] if S > P else []), dim=1)

    # ---------------------------------------------------------------- blocks
    def block(self, p: Dict, x: torch.Tensor, prompt_len: int) -> torch.Tensor:
        x = x + self.attention(p["attn"], self.norm(p["ln1"], x))
        h = self.norm(p["ln2"], x)
        return x + (self.moe(p["moe"], h, prompt_len) if "moe" in p
                    else self.mlp(p["mlp"], h))

    def hidden(self, params: Dict, tokens: torch.Tensor,
               prompt_len: Optional[int] = None, remat: bool = False) -> torch.Tensor:
        """Final-normed hidden states (B, S, d) of ``tokens`` (B, S)."""
        P = tokens.shape[1] if prompt_len is None else prompt_len
        x = params["embed"]["table"].float()[tokens.long()]
        for lp in params["layers"]:
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(self.block, lp, x, P,
                                                      use_reentrant=False)
            else:
                x = self.block(lp, x, P)
        return self.norm(params["final_norm"], x)

    def logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, params["embed"]["table"].T)

    # ------------------------------------------------------------ train loss
    def loss(self, params: Dict, tokens: torch.Tensor, chunk: int = 512) -> torch.Tensor:
        """Mean next-token cross entropy over the B * (S - 1) positions that
        have a next token."""
        x = self.hidden(params, tokens, remat=True)
        B, S, _ = x.shape
        total = x.new_zeros(())
        for s0 in range(0, S - 1, chunk):
            s1 = min(s0 + chunk, S - 1)
            lg = self.logits(params, x[:, s0:s1])
            total = total + F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                            tokens[:, s0 + 1:s1 + 1].reshape(-1).long(),
                                            reduction="sum")
        return total / (B * (S - 1))


def served_logits(ref: Reference, params: Dict, prompts: torch.Tensor,
                  served: torch.Tensor, block: int = 4) -> List[torch.Tensor]:
    """Float32 logits (n, V) at each position that produced a served token:
    the last prompt position and every served token but the last, for
    ``block`` requests at a time.  prompts (R, P), served (R, n)."""
    P, n = prompts.shape[1], served.shape[1]
    out = []
    with torch.no_grad():
        for r0 in range(0, prompts.shape[0], block):
            seq = torch.cat([prompts[r0:r0 + block], served[r0:r0 + block, :-1]], dim=1)
            x = ref.hidden(params, seq, prompt_len=P)[:, P - 1:P - 1 + n]
            out.extend(ref.logits(params, x).unbind(0))
    return out
