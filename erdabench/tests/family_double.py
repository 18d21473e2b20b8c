"""A test double of a family module (``erdabench/families/<family>.py``, see
``cell.family_module``) for the program's ``hybrid`` family: Mamba2 layers
with one shared attention block, zamba2's layout.  ``test_bench_families``
copies it into a tiny tree as ``erdabench/families/hybrid.py``.

It checks the harness's plumbing, not parity.  Its weights are the
program's own initialisation from the seed, and its reference wraps the
program's forward in float32, which a real family module may not do: that
imports nothing of the program and computes the model itself.  It has no
control of its own (``precision`` is logged, not used).  Every call is
logged in ``CALLS``.
"""
from erdabench import weights
from erdabench.serve import map_tree

CALLS = []


def _model(m, dtype, device):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import get_model
    return get_model(ModelConfig(**dict(m, dtype=dtype)), device)


def make_params(m, seed, device):
    CALLS.append(("make_params", seed))
    return _model(m, m["dtype"], device).init(weights.generator(seed, 0, device))


class Reference:
    def __init__(self, m, precision="fp32"):
        CALLS.append(("Reference", precision))
        self.m = m

    def port(self, device):
        return _model(self.m, "float32", device)

    def loss(self, params, tokens):
        CALLS.append(("loss", tuple(tokens.shape)))
        return self.port(tokens.device).train_loss(params, {"tokens": tokens})


def served_logits(ref, params, prompts, served):
    """Float32 logits (n, V) at each position that produced a served token,
    through the program's prefill and decode with the served tokens fed."""
    import torch
    CALLS.append(("served_logits", tuple(served.shape)))
    model = ref.port(prompts.device)
    p32 = map_tree(lambda t: t.float(), params)
    with torch.no_grad():
        logits, cache = model.prefill(p32, {"tokens": prompts})
        out = [logits[:, 0]]
        for i in range(served.shape[1] - 1):
            logits, cache = model.decode_step(p32, cache, served[:, i:i + 1].to(torch.int32))
            out.append(logits[:, 0])
    return list(torch.stack(out, 1).unbind(0))


def matmul_params_per_token(m):
    """Mamba2's in and out projections in every layer, and the shared
    block's q, k, v, o and SwiGLU at each of its ``n_layers / every``
    applications."""
    d, di, ds = m["d_model"], m["ssm_expand"] * m["d_model"], m["ssm_state"]
    nh = di // m["ssm_head_dim"]
    q, kv = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    shared = 2 * d * q + 2 * d * kv + 3 * d * m["d_ff"]
    return (m["n_layers"] * (d * (2 * di + 2 * ds + nh) + di * d)
            + m["n_layers"] // m["shared_attn_every"] * shared)


def prefill_flops(m, batch, seq):
    CALLS.append(("prefill_flops", batch, seq))
    sites = m["n_layers"] // m["shared_attn_every"]
    attn = sites * 2 * batch * m["n_heads"] * seq * seq * m["head_dim"]
    return (2 * matmul_params_per_token(m) * batch * seq + attn
            + 2 * batch * m["d_model"] * m["vocab_size"])


def train_flops(m, batch, seq):
    CALLS.append(("train_flops", batch, seq))
    sites = m["n_layers"] // m["shared_attn_every"]
    n = matmul_params_per_token(m) + m["d_model"] * m["vocab_size"]
    return (6 * n + 12 * sites * m["n_heads"] * m["head_dim"] * seq) * batch * seq
