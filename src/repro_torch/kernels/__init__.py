# Hand-written Hopper kernels of the port: one per Pallas kernel of repro,
# and ones for decode attention and the MoE layer:
#   crc32.py + csrc/crc32.cu — batch object/shard CRC verification (§4.2)
#   flash_attention.py + csrc/flash_attention.cu — prefill self-attention
#     (bf16 on the tensor cores with wgmma/TMA, f32 on the CUDA cores)
#   decode_attention.py + csrc/decode_attention.cu — a decode step's attention
#     over the KV cache (no Pallas counterpart: the reference's is plain jnp)
#   moe.py + csrc/moe.cu — the MoE layer's queue positions, dispatch and
#     combine (no Pallas counterpart: the reference's are one-hot einsums)
#   csrc/hopper.cuh — the PTX helpers (cp.async, mbarrier, TMA, wgmma) they use
# ops.py holds the public wrappers and launch counts; ref.py the plain
# PyTorch versions (decode's is models/layers/attention.py, the MoE kernels'
# models/layers/moe.py); build.py compiles csrc/ with nvcc at first use.
