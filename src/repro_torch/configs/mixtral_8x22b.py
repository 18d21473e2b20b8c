"""mixtral-8x22b [moe]: 56L, d=6144, 48H GQA kv=8, head_dim=128, d_ff=16384,
vocab 32768, 8 experts top-2, sliding-window attention.  [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16_384, vocab_size=32_768,
    n_experts=8, n_experts_active=2,
    attn_pattern="swa", window=4096,
    rope_theta=1_000_000.0,
)
