"""The benchmark's yardstick: the H100's peaks and the operations and bytes
each measured piece of work needs, computed from shapes alone.

Frozen copies: the peaks are NVIDIA's H100 SXM data sheet (dense rates,
700 W), the CRC and flash bounds are ``chip_smoke.py``'s ``crc_bound_ms`` /
``flash_bound_ms`` as they stood when the benchmark was defined.  Nothing
here imports the program, so a later change to the program cannot move
the yardstick.
"""
from __future__ import annotations

from typing import Dict, Tuple

from erdabench import cell

#: dense bf16 tensor-core operations a second
BF16_TENSOR_OPS_PER_S = 989e12
#: float32 operations a second outside the tensor cores
CUDA_CORE_OPS_PER_S = 67e12
#: HBM bytes a second
HBM_BYTES_PER_S = 3.35e12
#: integer operations a CRC byte needs by the byte-table recurrence (xor,
#: and, table load, shift, xor); the bytes bound it either way
CRC_OPS_PER_BYTE = 5


def crc_bound_ms(n: int, w: int) -> Tuple[float, str]:
    """The least time the card could take for an (n rows, w words) CRC
    batch: words read once and CRCs written once over HBM, against the
    integer steps over the CUDA-core rate.  (ms, "bytes" | "operations")."""
    t_bytes = (n * w * 4 + n * 4) / HBM_BYTES_PER_S
    t_ops = n * w * 4 * CRC_OPS_PER_BYTE / CUDA_CORE_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def flash_bound_ms(bh: int, s: int, hd: int, dtype: str,
                   causal: bool = True) -> Tuple[float, str]:
    """The least time the card could take for one same-length attention
    call over (bh, s, hd): q, k, v read once and o written once over HBM,
    against 4*bh*s^2*hd operations (half when causal) over the tensor
    cores' bf16 rate or the CUDA cores' float32 rate."""
    elt = 2 if dtype == "bfloat16" else 4
    t_bytes = 4 * bh * s * hd * elt / HBM_BYTES_PER_S
    ops = 4 * bh * s * s * hd / (2 if causal else 1)
    t_ops = ops / (BF16_TENSOR_OPS_PER_S if dtype == "bfloat16"
                   else CUDA_CORE_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def matmul_params_per_token(model: Dict) -> int:
    """Weights one token multiplies through in a forward pass of one layer
    stack, embedding lookup excluded and the tied unembedding excluded:
    q, k, v, o projections and the MLP (a MoE layer: the router and its
    ``n_experts_active`` experts)."""
    d, hd = model["d_model"], model["head_dim"]
    q_dim, kv_dim = model["n_heads"] * hd, model["n_kv_heads"] * hd
    attn = d * q_dim + 2 * d * kv_dim + q_dim * d
    mlp = 3 * d * model["d_ff"]
    if model.get("n_experts"):
        mlp = mlp * model["n_experts_active"] + d * model["n_experts"]
    return model["n_layers"] * (attn + mlp)


def attention_flops(model: Dict, batch: int, seq: int, causal: bool = True) -> int:
    """Score and value products of same-length self-attention over every
    layer: 4*B*H*S^2*hd a layer, half of it when causal."""
    per = 4 * batch * model["n_heads"] * seq * seq * model["head_dim"]
    return model["n_layers"] * (per // 2 if causal else per)


def prefill_flops(model: Dict, batch: int, seq: int) -> int:
    """Nominal operations of one prefill of ``batch`` prompts of ``seq``
    tokens: 2 * weights * tokens through the stack, causal attention, and
    the unembedding of each prompt's last position.  A family with a
    module of its own (``cell.family_module``) counts its own."""
    own = cell.own_family(model)
    if own is not None:
        return own.prefill_flops(model, batch, seq)
    tokens = batch * seq
    return (2 * matmul_params_per_token(model) * tokens
            + attention_flops(model, batch, seq)
            + 2 * batch * model["d_model"] * model["vocab_size"])


def train_flops(model: Dict, batch: int, seq: int) -> int:
    """Model operations of one training step (PaLM's convention, Chowdhery
    et al. 2022, appendix B): 6 * N * T with N the weights used in matrix
    products (the unembedding, tied or not, included; the lookup not),
    plus 12 * L * H * hd * S a token of attention.  Rematerialisation is not
    counted: it is hardware work, not model work.  A family with a module
    of its own (``cell.family_module``) counts its own."""
    own = cell.own_family(model)
    if own is not None:
        return own.train_flops(model, batch, seq)
    tokens = batch * seq
    n = matmul_params_per_token(model) + model["d_model"] * model["vocab_size"]
    attn = 12 * model["n_layers"] * model["n_heads"] * model["head_dim"] * seq
    return 6 * n * tokens + attn * tokens
