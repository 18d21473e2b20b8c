# Hand-written Hopper kernels of the port, one per Pallas kernel of repro:
#   crc32.py + csrc/crc32.cu — batch object/shard CRC verification (§4.2)
#   flash_attention.py + csrc/flash_attention.cu — prefill self-attention
#     (bf16 on the tensor cores with wgmma/TMA, f32 on the CUDA cores)
#   csrc/hopper.cuh — the PTX helpers (cp.async, mbarrier, TMA, wgmma) both use
# ops.py holds the public wrappers and launch counts; ref.py the plain
# PyTorch versions; build.py compiles csrc/ with nvcc at first use.
