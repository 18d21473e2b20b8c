from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.optim.compression import compress_int8, decompress_int8

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "compress_int8", "decompress_int8"]
