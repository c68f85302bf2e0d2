"""Split-KV single-token decode attention (``repro.kernels.flash_decode``)."""
