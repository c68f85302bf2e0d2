"""RWKV-6 recurrence (``repro.kernels.wkv6``)."""
