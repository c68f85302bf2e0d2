"""Flash attention, forward and backward
(``repro.kernels.flash_attention``)."""
