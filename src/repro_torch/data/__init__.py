"""Synthetic data of the port (``repro.data``)."""
from repro_torch.data.synthetic import calib_stream, vit_batch

__all__ = ["calib_stream", "vit_batch"]
