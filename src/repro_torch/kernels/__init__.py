# Hand-written Hopper kernels of the port, one per Pallas kernel of repro:
#   crc32.py + csrc/crc32.cu — batch object/shard CRC verification (§4.2)
# ops.py holds the public wrappers and launch counts; ref.py the plain
# PyTorch versions; build.py compiles csrc/ with nvcc at first use.
