"""Plain PyTorch version of the gram kernel (``repro.kernels.gram.ref``)."""
from __future__ import annotations

import torch


def gram_cross(x: torch.Tensor, y: torch.Tensor) -> dict:
    """x: (..., N, Fx), y: (..., N, Fy) -> {'s2': (..., Fx, Fy) fp32 X^T Y,
    's1': (..., Fy) fp32 column sums of Y}."""
    xf = x.float()
    yf = y.float()
    return {"s2": xf.transpose(-1, -2) @ yf, "s1": yf.sum(dim=-2)}


def gram(x: torch.Tensor) -> dict:
    """x: (..., N, F) -> {'s2': (..., F, F) fp32 X^T X, 's1': (..., F)}."""
    return gram_cross(x, x)
