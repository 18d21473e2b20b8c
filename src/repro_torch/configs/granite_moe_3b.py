"""granite-moe-3b-a800m [moe]: 32L, d=1536, 24H GQA kv=8, head_dim=64,
per-expert d_ff=512, vocab 49155, 40 experts top-8.  (The assignment row says
both "40e top-8" and "32 experts"; we follow the explicit 40e spec — matches
granite-3.0-3b-a800m.)  [hf:ibm-granite]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_3b", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49_155,
    n_experts=40, n_experts_active=8,
)
