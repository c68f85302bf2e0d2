"""Forward flash attention (``repro.kernels.flash_attention``)."""
