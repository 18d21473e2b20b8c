"""gemma3-27b [dense]: 62L, d=5376, 32H GQA kv=16, head_dim=128, d_ff=21504,
vocab 262144; 5:1 local:global (window 1024), 128k ctx.
head_dim=128 (published value; d_model/n_heads=168 is not MXU-aligned — see
DESIGN.md hardware-adaptation notes).  [hf:google/gemma-3-27b-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21_504, vocab_size=262_144,
    attn_pattern="local_global", window=1024, local_per_global=5,
    rope_theta=1_000_000.0,
)
