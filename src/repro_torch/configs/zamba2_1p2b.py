"""zamba2-1.2b [hybrid]: 38 Mamba2 layers (d=2048, ssm_state=64) + a SHARED
attention+MLP block (32H, kv=32, d_ff=8192) applied every 6 ssm layers.
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_1p2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6,
)
