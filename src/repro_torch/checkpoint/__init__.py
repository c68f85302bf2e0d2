"""Checkpoints of the port in the JAX package's layout
(``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (AsyncCheckpointer, latest_step,
                                         load_arrays, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["AsyncCheckpointer", "latest_step", "load_arrays",
           "restore_checkpoint", "save_checkpoint"]
