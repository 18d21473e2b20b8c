"""whisper-small [audio]: enc-dec, conv frontend stubbed to precomputed frame
embeddings (input_specs provides them).  12L encoder + 12L decoder, d=768,
12H MHA (kv=12), d_ff=3072, vocab 51865.  [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51_865,
    norm="layernorm", act="gelu", mlp_kind="gelu_mlp",
    encoder_layers=12, encoder_seq=1500,
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
)
