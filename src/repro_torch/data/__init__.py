"""Synthetic data of the port (``repro.data``)."""
from repro_torch.data.synthetic import calib_stream, lm_batch, vit_batch

__all__ = ["calib_stream", "lm_batch", "vit_batch"]
