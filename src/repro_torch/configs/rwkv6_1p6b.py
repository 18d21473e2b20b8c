"""rwkv6-1.6b "Finch" [ssm]: 24L, d=2048, attention-free time-mix with
data-dependent decay, channel-mix d_ff=7168, vocab 65536.  [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_1p6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab_size=65_536,
    norm="layernorm",
)
