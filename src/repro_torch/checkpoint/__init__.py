"""Checkpoints of the port in the JAX package's layout
(``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
