"""Gram kernel: X^T Y plus column sums (``repro.kernels.gram``)."""
