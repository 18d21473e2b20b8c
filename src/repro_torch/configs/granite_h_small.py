"""granite-4.0-h-small [hybrid_moe]: 40 layers at d 4096, 36 Mamba2 mixers
(128 heads of 64, d_state 128, one group, conv 4 with bias, chunk 256,
gated RMSNorm) and 4 GQA mixers with no position embedding (32 q / 8 kv
heads of 128) at layers 5, 15, 25 and 35; every mixer followed by 72
experts of 768, top-10, and a shared expert of 1536; µP's four scalars;
RMSNorm eps 1e-5; tied vocabulary 100,352.  32.2 B parameters.  Not in
``ARCH_IDS``: the JAX package has no such family.
[hf:ibm-granite/granite-4.0-h-small]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_h_small", family="hybrid_moe",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=768, vocab_size=100_352,
    n_experts=72, n_experts_active=10, d_ff_shared=1536,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    ssm_conv_bias=True, ssm_gated_norm=True,
    layer_types=tuple("attention" if i % 10 == 5 else "mamba" for i in range(40)),
    rope_theta=0.0, norm_eps=1e-5,
    embedding_multiplier=12.0, attention_multiplier=0.0078125,
    residual_multiplier=0.22, logits_scaling=16.0,
)
