"""Synthetic data of the port (``repro.data``)."""
from repro_torch.data.synthetic import (calib_stream, lm_batch, lm_stream,
                                        vit_batch, vit_stream)

__all__ = ["calib_stream", "lm_batch", "lm_stream", "vit_batch",
           "vit_stream"]
