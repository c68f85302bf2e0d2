"""Checkpoint writer of the port (``repro.checkpoint``)."""
from repro_torch.checkpoint.ckpt import save_checkpoint

__all__ = ["save_checkpoint"]
