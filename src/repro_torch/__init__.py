"""PyTorch/CUDA port of the CORP reproduction (``repro``) for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``models``, ``core``, ``kernels``, ``data``,
``checkpoint``, ``launch``) and imports nothing from it. Plain tensor code is
PyTorch; the Pallas TPU kernels on the ported path are hand-written CUDA C++
for ``sm_90a`` under ``repro_torch/kernels/*/csrc``.

Every entry point takes ``device=None``, meaning ``"cuda"``, and raises when
CUDA is absent: nothing drops to the CPU on its own. Pass ``device="cpu"``
to run the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda. Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(or --device cpu) to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


__all__ = ["resolve_device"]
