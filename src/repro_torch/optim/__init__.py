"""Optimizers, the lr schedule and gradient compression of the training
path. Mirrors ``repro/optim/__init__.py``."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "compress_int8",
           "decompress_int8", "cosine_schedule"]
