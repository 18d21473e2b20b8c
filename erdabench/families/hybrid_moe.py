"""The program's ``hybrid_moe`` family, granite-4.0-h-small's
``granitemoehybrid`` architecture: weights made on the card from the seed,
a plain PyTorch reference, and the FLOP counts behind the MFU readers
(``cell.FAMILY_API``).

It imports nothing of the program.  The reference reads the
configuration's ``model`` dict and the weight tree ``make_params`` made
(the tensors the program gets), and computes in float32 (TF32 off) from
the bfloat16 weights, one layer's weights upcast at a time, so that a pass
over 8k tokens fits on the card beside the program's 64 GB.  Per layer, as
the published model computes it:

- x0 = embedding_multiplier · embed(tokens);
- h = x + residual_multiplier · mixer(rmsnorm(x)), the mixer Mamba2 or
  attention by ``layer_types``; x = h + residual_multiplier · (moe(rmsnorm(h))
  + shared(rmsnorm(h))); logits = (rmsnorm(x) @ embedᵀ) / logits_scaling;
  RMSNorm eps ``norm_eps``;
- attention: GQA with no position embedding, softmax(q·kᵀ ·
  attention_multiplier) v, causal;
- Mamba2: [z, xBC, dt] = x @ in_proj; xBC = silu(depthwise causal conv1d
  with bias); x, B, C = split(xBC) (one group); dt = softplus(dt + dt_bias),
  its limit (0, inf) a no-op; A = -exp(A_log); h_t = exp(dt_t A) h_{t-1} +
  dt_t B_t ⊗ x_t, y_t = C_t · h_t + D x_t, here as a chunked float32 scan
  (``scan``, chunks of ``SCAN_CHUNK``, not the program's chunking);
  y = rmsnorm(y · silu(z)) · w over all of d_inner; out = y @ out_proj;
- MoE: the harness's transformer reference's routing (softmax over the
  experts, top-k, renormalised over the k — the published softmax over the
  top-k logits — with GShard capacity 1.25 in groups of ``moe_group``, as
  the program routes; the config's ``assumed`` names the departure from
  the published dropless routing), plus the always-on shared SwiGLU expert
  of ``d_ff_shared``;
- training: mean next-token cross entropy plus 0.01 · the layers' Switch
  load-balance losses / n_layers, as the program's ``train_loss``.

``precision="fp8"`` is the control: every product with a weight, the
conv's included, takes both operands rounded to float8 e4m3 (a scale per
tensor), as in ``reference.model``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from erdabench import weights
from erdabench.reference import model as ref_model

#: the reference scan's chunk
SCAN_CHUNK = 64
#: the embedding table's standard deviation.  At the transformer's 0.02,
#: embedding_multiplier 12 keeps a cosine of ~0.12 between the last hidden
#: state and its own token's (tied) embedding, 7.7 standard deviations of
#: the logits above the rest: every served token repeats the last prompt
#: token, whatever the layers compute, and the float8 control read a gap of
#: 0 on every token.  At 0.008 no served token is such a copy
EMBED_STD = 0.008


def _widths(m: Dict):
    """(d_inner, SSM heads, conv channels)."""
    di = m["ssm_expand"] * m["d_model"]
    return di, di // m["ssm_head_dim"], di + 2 * m["ssm_state"]


def _bf16_leaves(m: Dict):
    """(path, shape, scale) of every weight in the model's dtype, in
    creation order: matrices at 1/sqrt(fan in), the embedding at
    ``EMBED_STD``, the conv's taps and bias at 1/sqrt(taps)."""
    d, f, E, K = m["d_model"], m["d_ff"], m["n_experts"], m["ssm_conv"]
    hd, fs = m["head_dim"], m["d_ff_shared"]
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    di, nh, cd = _widths(m)
    out = [(("embed", "table"), (m["vocab_size"], d), EMBED_STD)]
    for i, kind in enumerate(m["layer_types"]):
        if kind == "mamba":
            mixer = [("in_proj", (d, 2 * di + 2 * m["ssm_state"] + nh)), ("out_proj", (di, d)),
                     ("conv_w", (K, cd)), ("conv_b", (cd,))]
            out += [(("layers", i, "ssm", n), s, 1 / math.sqrt(s[0] if n.endswith("proj") else K))
                    for n, s in mixer]
        else:
            out += [(("layers", i, "attn", n), s, 1 / math.sqrt(s[0]))
                    for n, s in (("wq", (d, q)), ("wk", (d, kv)), ("wv", (d, kv)), ("wo", (q, d)))]
        out += [(("layers", i, "moe", n), s, 1 / math.sqrt(s[1]))
                for n, s in (("wg", (E, d, f)), ("wi", (E, d, f)), ("wo", (E, f, d)))]
        out += [(("layers", i, "moe", "shared", n), s, 1 / math.sqrt(s[0]))
                for n, s in (("wg", (d, fs)), ("wi", (d, fs)), ("wo", (fs, d)))]
    return out


def make_params(m: Dict, seed: int, device) -> Dict:
    """The program's weight tree for ``m``: the model-dtype weights are one
    ``torch.randn`` on the device, cut into views and scaled in place; the
    float32 routers (1/sqrt(d)) and each Mamba mixer's A_log (log of
    U[1, 16]), D (ones) and dt_bias (softplus⁻¹ of a step log-uniform in
    [0.001, 0.1], Mamba2's initialisation) a second draw.  Norm scales are
    ones."""
    dt = weights.DTYPES[m["dtype"]]
    leaves = _bf16_leaves(m)
    total = sum(math.prod(s) for _p, s, _c in leaves)
    flat = torch.randn(total, generator=weights.generator(seed, 0, device), dtype=dt,
                       device=device)
    d, E, L = m["d_model"], m["n_experts"], m["n_layers"]
    ones = lambda n: torch.ones(n, dtype=dt, device=device)
    layers = []
    for kind in m["layer_types"]:
        layers.append({"ln1": {"scale": ones(d)}, "ssm" if kind == "mamba" else "attn": {},
                       "ln2": {"scale": ones(d)}, "moe": {"shared": {}}})
    params = {"embed": {}, "final_norm": {"scale": ones(d)}, "layers": layers}
    off = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = flat[off:off + n].view(shape).mul_(scale)
        off += n
    gen = weights.generator(seed, 1, device)
    routers = torch.randn((L, d, E), generator=gen, dtype=torch.float32,
                          device=device) / math.sqrt(d)
    di, nh, _cd = _widths(m)
    for i, lp in enumerate(layers):
        lp["moe"]["router"] = routers[i]
        if "ssm" in lp:
            u = torch.rand((2, nh), generator=gen, dtype=torch.float32, device=device)
            step = torch.exp(math.log(1e-3) + u[1] * (math.log(1e-1) - math.log(1e-3)))
            lp["ssm"].update(A_log=torch.log(1 + 15 * u[0]),
                             D=torch.ones(nh, dtype=torch.float32, device=device),
                             dt_bias=step + torch.log(-torch.expm1(-step)),
                             gate_norm=ones(di))
    return params


class Reference(ref_model.Reference):
    """Float32 granite-4.0-H; routing, expert and SwiGLU products are the
    transformer reference's (``reference.model``)."""

    # ------------------------------------------------------------ primitives
    def norm(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        y = x * torch.rsqrt((x ** 2).mean(-1, keepdim=True) + self.m["norm_eps"])
        return y * p["scale"].float()

    def q8(self, t: torch.Tensor) -> torch.Tensor:
        return ref_model.fp8_ste(t) if self.precision == "fp8" else t

    def residual(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return x + self.m["residual_multiplier"] * y

    # ------------------------------------------------------------- attention
    def attention(self, p: Dict, h: torch.Tensor, q_block: int = 512) -> torch.Tensor:
        """Causal GQA, no position embedding, softmax scale
        ``attention_multiplier``."""
        m = self.m
        B, S, _ = h.shape
        H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        q = self.mm(h, p["wq"]).reshape(B, S, H, hd).transpose(1, 2)
        k = self.mm(h, p["wk"]).reshape(B, S, KV, hd).repeat_interleave(H // KV, dim=2)
        v = self.mm(h, p["wv"]).reshape(B, S, KV, hd).repeat_interleave(H // KV, dim=2)
        k, v = k.transpose(1, 2), v.transpose(1, 2)               # (B,H,S,hd)
        pos = torch.arange(S, device=h.device)
        outs = []
        for s0 in range(0, S, q_block):
            s = (q[:, :, s0:s0 + q_block] * m["attention_multiplier"]) @ k.transpose(-1, -2)
            s = s.masked_fill(pos[s0:s0 + q_block, None] < pos[None, :], float("-inf"))
            outs.append(torch.softmax(s, dim=-1) @ v)
        o = torch.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)
        return self.mm(o, p["wo"])

    # ---------------------------------------------------------------- mamba2
    @staticmethod
    def scan(x, Bm, Cm, dt, A, h, chunk: int = SCAN_CHUNK):
        """The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t ⊗ x_t, y_t =
        C_t · h_t, a chunk at a time: within a chunk y_t = Σ_{s<=t} (C_t·B_s)
        exp(a_s+1 + … + a_t) dt_s x_s + exp(a_1 + … + a_t) C_t · h_0, with
        a = dt A.  x (B,T,nh,hp), Bm/Cm (B,T,n), dt (B,T,nh), A (nh,), h
        (B,nh,hp,n) -> (y (B,T,nh,hp), the last h)."""
        ys = []
        for t0 in range(0, x.shape[1], chunk):
            xs, bs, cs, ds = (t[:, t0:t0 + chunk] for t in (x, Bm, Cm, dt))
            c = xs.shape[1]
            cum = torch.cumsum(ds * A, dim=1)                          # (B,c,nh)
            later = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
            gap = (cum[:, :, None] - cum[:, None, :]).masked_fill(
                ~later[None, :, :, None], float("-inf"))              # (B,t,s,nh)
            w = torch.exp(gap) * (cs @ bs.transpose(1, 2))[..., None] * ds[:, None]
            y = torch.einsum("btsh,bshp->bthp", w, xs)
            y = y + torch.einsum("btn,bhpn->bthp", cs, h) * torch.exp(cum)[..., None]
            carry = torch.exp(cum[:, -1:] - cum) * ds                  # (B,c,nh)
            h = (torch.exp(cum[:, -1])[:, :, None, None] * h
                 + torch.einsum("bsh,bshp,bsn->bhpn", carry, xs, bs))
            ys.append(y)
        return torch.cat(ys, dim=1), h

    def mamba(self, p: Dict, u: torch.Tensor) -> torch.Tensor:
        m = self.m
        Bsz, T, _ = u.shape
        di, nh, cd = _widths(m)
        n, K = m["ssm_state"], m["ssm_conv"]
        proj = self.mm(u, p["in_proj"])
        z, xBC, dt = proj.split([di, cd, nh], dim=-1)
        taps = self.q8(p["conv_w"].float()).t()[:, None, :]           # (cd, 1, K)
        xBC = F.conv1d(self.q8(xBC).transpose(1, 2), taps, p["conv_b"].float(),
                       padding=K - 1, groups=cd)[..., :T].transpose(1, 2)
        xBC = F.silu(xBC)
        x = xBC[..., :di].reshape(Bsz, T, nh, -1)
        dt = F.softplus(dt + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        h0 = u.new_zeros((Bsz, nh, x.shape[-1], n))
        y, _h = self.scan(x, xBC[..., di:di + n], xBC[..., di + n:], dt, A, h0)
        y = (y + x * p["D"].float()[:, None]).reshape(Bsz, T, di)
        y = y * F.silu(z)
        y = y * torch.rsqrt((y ** 2).mean(-1, keepdim=True) + m["norm_eps"]) * p["gate_norm"].float()
        return self.mm(y, p["out_proj"])

    # ---------------------------------------------------------------- blocks
    def aux(self, p: Dict, h: torch.Tensor) -> torch.Tensor:
        """Switch load balance: E · Σ_e (share of top-k picks) · (mean gate)."""
        E, k = self.m["n_experts"], self.m["n_experts_active"]
        gates = torch.softmax(h @ p["router"].float(), dim=-1)
        picks = torch.topk(gates, k, dim=-1).indices
        frac = F.one_hot(picks, E).float().mean((0, 1, 2))
        return E * torch.sum(frac * gates.mean((0, 1)))

    def layer(self, p: Dict, x: torch.Tensor, prompt_len: int):
        """One layer; returns (x, its load-balance loss)."""
        u = self.norm(p["ln1"], x)
        x = self.residual(x, self.mamba(p["ssm"], u) if "ssm" in p else self.attention(p["attn"], u))
        h = self.norm(p["ln2"], x)
        moe = self.moe(p["moe"], h, prompt_len) + self.mlp(p["moe"]["shared"], h)
        aux = self.aux(p["moe"], h) if torch.is_grad_enabled() else h.new_zeros(())
        return self.residual(x, moe), aux

    def run(self, params: Dict, tokens: torch.Tensor, prompt_len: int):
        """(final-normed hidden states (B, S, d), summed load-balance loss)."""
        x = params["embed"]["table"].float()[tokens.long()] * self.m["embedding_multiplier"]
        total = x.new_zeros(())
        for lp in params["layers"]:
            if torch.is_grad_enabled():
                x, a = torch.utils.checkpoint.checkpoint(self.layer, lp, x, prompt_len,
                                                         use_reentrant=False)
            else:
                x, a = self.layer(lp, x, prompt_len)
            total = total + a
        return self.norm(params["final_norm"], x), total

    def hidden(self, params: Dict, tokens: torch.Tensor, prompt_len=None, remat=False):
        P = tokens.shape[1] if prompt_len is None else prompt_len
        return self.run(params, tokens, P)[0]

    def logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return self.mm(x, params["embed"]["table"].T) / self.m["logits_scaling"]

    def loss(self, params: Dict, tokens: torch.Tensor, chunk: int = 512) -> torch.Tensor:
        x, aux = self.run(params, tokens, tokens.shape[1])
        B, S, _ = x.shape
        total = x.new_zeros(())
        for s0 in range(0, S - 1, chunk):
            s1 = min(s0 + chunk, S - 1)
            lg = self.logits(params, x[:, s0:s1])
            total = total + F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                            tokens[:, s0 + 1:s1 + 1].reshape(-1).long(),
                                            reduction="sum")
        return total / (B * (S - 1)) + 0.01 * aux / self.m["n_layers"]


def served_logits(ref: Reference, params: Dict, prompts: torch.Tensor,
                  served: torch.Tensor) -> List[torch.Tensor]:
    """Float32 logits (n, V) at each position that produced a served token,
    two requests at a time (a float32 pass over 2 x 8k tokens)."""
    return ref_model.served_logits(ref, params, prompts, served, block=2)


# ------------------------------------------------------------------ counts
def matmul_params_per_token(m: Dict) -> int:
    """Weights one token multiplies through in the layer stack: each
    layer's router, its ``n_experts_active`` experts and the shared one,
    each Mamba mixer's in and out projections, each attention mixer's q, k,
    v and o."""
    d, hd = m["d_model"], m["head_dim"]
    di, nh, _cd = _widths(m)
    n_mamba = m["layer_types"].count("mamba")
    moe = d * m["n_experts"] + 3 * d * (m["n_experts_active"] * m["d_ff"] + m["d_ff_shared"])
    mamba = d * (2 * di + 2 * m["ssm_state"] + nh) + di * d
    attn = 2 * d * m["n_heads"] * hd + 2 * d * m["n_kv_heads"] * hd
    return m["n_layers"] * moe + n_mamba * mamba + (m["n_layers"] - n_mamba) * attn


def scan_flops(m: Dict, batch: int, seq: int) -> int:
    """The chunked SSD's own products over every Mamba layer, with chunk c
    (``ssm_chunk`` halved until it divides S), n = ``ssm_state`` and P =
    d_inner: per chunk C·Bᵀ (2c²n), the masked scores times the inputs
    (2c²P), C times the carried state (2cnP) and the state's update (2cnP);
    a sequence holds S/c chunks, so 2·S·c·(n + P) + 4·S·n·P a layer."""
    c = min(m["ssm_chunk"], seq)
    while seq % c:
        c //= 2
    di, n = _widths(m)[0], m["ssm_state"]
    per = 2 * seq * c * (n + di) + 4 * seq * n * di
    return m["layer_types"].count("mamba") * batch * per


def attention_flops(m: Dict, batch: int, seq: int) -> int:
    """Causal score and value products of the attention layers:
    2·B·H·S²·hd each."""
    n_attn = m["n_layers"] - m["layer_types"].count("mamba")
    return n_attn * 2 * batch * m["n_heads"] * seq * seq * m["head_dim"]


def prefill_flops(m: Dict, batch: int, seq: int) -> int:
    """Nominal operations of one prefill of ``batch`` prompts of ``seq``
    tokens: 2 · ``matmul_params_per_token`` · tokens, the attention layers'
    causal products, the SSD scan's (``scan_flops``) and the unembedding
    of each prompt's last position; capacity slots are not counted."""
    return (2 * matmul_params_per_token(m) * batch * seq + attention_flops(m, batch, seq)
            + scan_flops(m, batch, seq) + 2 * batch * m["d_model"] * m["vocab_size"])


def train_flops(m: Dict, batch: int, seq: int) -> int:
    """Model operations of one training step, PaLM's convention as
    ``counts.train_flops``: 6 · N · T with N the weights used in products
    (the unembedding included), 12 · H · hd · S a token for each attention
    layer, and three times the SSD scan's forward products."""
    n = matmul_params_per_token(m) + m["d_model"] * m["vocab_size"]
    n_attn = m["n_layers"] - m["layer_types"].count("mamba")
    tokens = batch * seq
    return (6 * n * tokens + 12 * n_attn * m["n_heads"] * m["head_dim"] * seq * tokens
            + 3 * scan_flops(m, batch, seq))
