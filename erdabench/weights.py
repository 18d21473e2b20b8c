"""Weights and token streams made on the device from ``--seed``.

The weight tree has the layout the program's transformer takes as
``params`` (``{"embed": {"table"}, "final_norm", "layers": [...]}``), and the
reference reads the same tensors.  All bfloat16 weights are one
``torch.randn`` call on the card, cut into views and scaled in place
(1/sqrt(fan in), 0.02 for the embedding); the routers, which the
configuration keeps in float32, are a second call.  Norm scales are ones.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use of the seed (weights, prompts,
    the train feed), so that the uses draw independent numbers."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def _leaf_shapes(m: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path, shape, scale) of every bfloat16 matrix, in creation order."""
    d, hd, f = m["d_model"], m["head_dim"], m["d_ff"]
    q_dim, kv_dim = m["n_heads"] * hd, m["n_kv_heads"] * hd
    out = [(("embed", "table"), (m["vocab_size"], d), 0.02)]
    for i in range(m["n_layers"]):
        for name, shape in (("wq", (d, q_dim)), ("wk", (d, kv_dim)),
                            ("wv", (d, kv_dim)), ("wo", (q_dim, d))):
            out.append((("layers", i, "attn", name), shape, 1 / math.sqrt(shape[0])))
        if m.get("n_experts"):
            E = m["n_experts"]
            for name, shape in (("wg", (E, d, f)), ("wi", (E, d, f)), ("wo", (E, f, d))):
                out.append((("layers", i, "moe", name), shape, 1 / math.sqrt(shape[1])))
        else:
            for name, shape in (("wg", (d, f)), ("wi", (d, f)), ("wo", (f, d))):
                out.append((("layers", i, "mlp", name), shape, 1 / math.sqrt(shape[0])))
    return out


def make_params(m: Dict, seed: int, device) -> Dict:
    """The weight tree of configuration ``m`` (its ``model`` dict)."""
    dt = DTYPES[m.get("dtype", "bfloat16")]
    leaves = _leaf_shapes(m)
    total = sum(math.prod(shape) for _p, shape, _s in leaves)
    flat = torch.randn(total, generator=generator(seed, 0, device), dtype=dt,
                       device=device)
    norm = (lambda: {}) if m["norm"] == "nonparam_ln" else \
        (lambda: {"scale": torch.ones(m["d_model"], dtype=dt, device=device)})
    layers = [{"ln1": norm(), "attn": {}, "ln2": norm()} for _ in range(m["n_layers"])]
    params = {"embed": {}, "final_norm": norm(), "layers": layers}
    off = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(scale)
        off += n
        node = params
        for key in path[:-1]:
            node = node[key] if not isinstance(key, str) or key in node else \
                node.setdefault(key, {})
        node[path[-1]] = leaf
    if m.get("n_experts"):
        d, E, L = m["d_model"], m["n_experts"], m["n_layers"]
        routers = torch.randn((L, d, E), generator=generator(seed, 1, device),
                              dtype=torch.float32, device=device) / math.sqrt(d)
        for i, lp in enumerate(layers):
            lp["moe"]["router"] = routers[i]
    return params


def token_stream(seed: int, vocab: int, device):
    """Batches of uniform token ids ``(batch, length)`` int32 on the
    device; the i-th call of one stream gives the same ids for one seed."""
    gen = generator(seed, 2, device)

    def draw(batch: int, length: int) -> torch.Tensor:
        return torch.randint(0, vocab, (batch, length), generator=gen,
                             dtype=torch.int32, device=device)
    return draw
