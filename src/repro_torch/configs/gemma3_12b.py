"""gemma3-12b [dense]: 48L, d=3840, 16H GQA kv=8, head_dim=256, d_ff=15360,
vocab 262144; 5 local (sliding 1024) : 1 global attention, 128k ctx.
[hf:google/gemma-3-12b-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15_360, vocab_size=262_144,
    attn_pattern="local_global", window=1024, local_per_global=5,
    rope_theta=1_000_000.0,
)
