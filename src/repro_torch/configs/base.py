"""Config system: one frozen dataclass per architecture + the shape grid.

Every assigned architecture gets a module in repro_torch.configs exposing CONFIG;
``get_config(name)`` resolves them, ``scaled_down()`` produces the reduced
smoke-test variant (same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | hybrid_moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention pattern
    attn_pattern: str = "full"   # full | swa | local_global
    window: int = 0              # sliding-window size (swa / local layers)
    local_per_global: int = 0    # gemma3: 5 local then 1 global per group
    rope_theta: float = 10_000.0  # 0: no position embedding (NoPE)
    norm: str = "rmsnorm"        # rmsnorm | layernorm | nonparam_ln
    norm_eps: float = 1e-6
    act: str = "silu"            # silu | gelu
    mlp_kind: str = "swiglu"     # swiglu | gelu_mlp
    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    capacity_factor: float = 1.25
    moe_group: int = 256         # GShard dispatch group (perf knob)
    d_ff_shared: int = 0         # an always-on shared SwiGLU expert's width (0: none)
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_bias: bool = False
    ssm_gated_norm: bool = False  # rmsnorm(y·silu(z))·w (granite 4.0-H), else y·silu(z)·w
    # hybrid (zamba2): one SHARED attention block applied every k ssm layers
    shared_attn_every: int = 0
    # hybrid_moe (granite 4.0-H): each layer's mixer, "mamba" or "attention",
    # every mixer followed by the MoE; empty for every other family
    layer_types: Tuple[str, ...] = ()
    # µP (granite): x0 = embedding_multiplier·embed; softmax scale
    # attention_multiplier (0: 1/sqrt(head_dim)); x + residual_multiplier·
    # block(x); logits / logits_scaling.  The transformer's families read them.
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # rwkv6
    rwkv_chunk: int = 64
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0         # stub-frontend frames (whisper: 1500)
    # vlm (pixtral)
    n_patches: int = 0           # stub-frontend patch embeddings per image
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: str = "full"          # full | none  (activation checkpoint policy)
    attn_chunk: int = 1024       # online-softmax KV/Q chunk for long prefill
    loss_chunk: int = 512        # fused unembed+CE sequence chunk
    cache_quant: bool = False    # int8 KV cache (serving memory-term knob)
    seq_parallel: bool = True    # Megatron-SP residual activations (perf knob)
    unroll: bool = False         # measurement mode: unroll layer/attn/loss
                                 # scans so XLA cost_analysis counts real trip
                                 # counts (scan bodies are otherwise counted
                                 # once); state recurrences (ssm/rwkv) stay
                                 # scanned — <3%% of their layer FLOPs

    def __post_init__(self):
        # a configuration file's list, kept hashable
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if self.layer_types and len(self.layer_types) != self.n_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} layer_types "
                             f"for {self.n_layers} layers")

    # ------------------------------------------------------------------ utils
    @property
    def attn_scale(self) -> Optional[float]:
        """The softmax scale, None for 1/sqrt(head_dim)."""
        return self.attention_multiplier or None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def scaled_down(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        n_layers = min(self.n_layers, 4 if self.shared_attn_every == 0 else self.shared_attn_every * 2)
        lpg = self.local_per_global
        if lpg:
            n_layers = lpg + 1  # one full local:global group
        layer_types = ("mamba", "attention") if self.layer_types else ()  # one of each mixer
        n_layers = len(layer_types) or n_layers
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            head_dim=32,
            d_ff=256 if self.n_experts == 0 else 64,
            d_ff_shared=128 if self.d_ff_shared else 0,
            layer_types=layer_types,
            vocab_size=512,
            window=min(self.window, 64) if self.window else 0,
            n_experts=min(self.n_experts, 8),
            n_experts_active=min(self.n_experts_active, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16,
            rwkv_chunk=16,
            shared_attn_every=min(self.shared_attn_every, 2) if self.shared_attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            attn_chunk=32,
            remat="none",
        )

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline bookkeeping); for
        hybrid_moe every leaf of ``init``'s tree, norms and SSM scalars
        included."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid_moe":
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv = (di + 2 * ds) * (self.ssm_conv + self.ssm_conv_bias)
            mamba = d * (2 * di + 2 * ds + nh) + conv + 3 * nh + di * d + di
            attn = 2 * d * self.q_dim + 2 * d * self.kv_dim
            moe = d * self.n_experts + 3 * d * f * self.n_experts + 3 * d * self.d_ff_shared
            n_mamba = self.layer_types.count("mamba")
            return (emb + d + L * (2 * d + moe) + n_mamba * mamba
                    + (L - n_mamba) * attn)
        if self.family == "ssm":  # rwkv6
            # time-mix: wr,wk,wv,wg,wo (5·d²) + decay LoRA (2·64·d);
            # channel-mix: wr (d²) + wk/wv (2·d·f)
            per = 6 * d * d + 2 * d * f + 128 * d
            return emb + L * per
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mlp_kind == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.n_experts:
            mlp = mlp * self.n_experts + d * self.n_experts
        per = attn + mlp
        if self.family == "hybrid":
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            ssm_per = d * (2 * di + 2 * ds + nh) + di * d + di * self.ssm_conv
            n_sites = self.n_layers // max(1, self.shared_attn_every)
            return emb + L * ssm_per + (attn + 3 * d * f)  # one shared block
        if self.family == "encdec":
            cross = per  # decoder layers add cross-attention
            return emb + (self.encoder_layers + L) * per + L * attn
        return emb + L * per

    def active_param_count(self) -> int:
        if not self.n_experts:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp_active = 3 * d * f * self.n_experts_active + d * self.n_experts
        emb = self.vocab_size * d
        return emb + L * (attn + mlp_active)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "whisper_small", "gemma3_12b", "olmo_1b", "mistral_nemo_12b", "gemma3_27b",
    "pixtral_12b", "granite_moe_3b", "mixtral_8x22b", "zamba2_1p2b", "rwkv6_1p6b",
]

# long_500k requires a sub-quadratic mechanism (DESIGN.md §5)
SUBQUADRATIC = {"gemma3_12b", "gemma3_27b", "mixtral_8x22b", "zamba2_1p2b", "rwkv6_1p6b"}


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False
    return True


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def all_cells():
    for a in ARCH_IDS:
        for s in SHAPES:
            if cell_applicable(a, s):
                yield a, s
