"""Optimizer of the port (``repro.optim``): AdamW, its schedule and the
error-feedback int8 gradient compression."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.optim.compress import (compress_grads, decompress_grads,
                                        ef_init, ef_round_trip)
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine", "ef_init", "compress_grads", "decompress_grads",
           "ef_round_trip"]
