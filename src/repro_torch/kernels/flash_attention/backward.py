"""Backward of the attention op: the hand-written kernel
``csrc/flash_attention_bwd.cu``.

The JAX package's Pallas attention is forward only and JAX differentiates
its jnp paths; the port's plain version serves CPU tensors only, so the
gradient on the card is this kernel (FlashAttention-2's backward, from the
forward's logsumexp). ``ops.attention`` reaches it through its autograd
Function; ``attention_bwd`` on CPU tensors is the plain version
(``ref.attention_bwd``). ``launches`` counts wrapper calls that launched
(one call: the delta, dK/dV and dQ kernels).
"""
from __future__ import annotations

import ctypes
import math
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window=None,
                  scale=None):
    """The gradient of ``ops.attention(q, k, v)`` -> (dq, dk, dv) in q's
    dtype, given its output ``o`` (B, T, H, dv), the forward's logsumexp
    ``lse`` (B, H, T) fp32 and the output's gradient ``do``. On CUDA
    tensors it launches the kernel or raises; CPU tensors take the plain
    version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    ts = (q, k, v, o, lse, do)
    if all(t.device.type == "cpu" for t in ts):
        return _ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window, scale=scale)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("attention_bwd: q, k, v, o, lse, do must lie on "
                         "one CUDA device (or all on the CPU)")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, do)):
        raise TypeError(f"attention_bwd: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {o.dtype}, {do.dtype}; the kernel "
                        f"takes float32 or bfloat16, all alike")
    B, T, H, dq = q.shape
    S, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if (k.shape[0], k.shape[3]) != (B, dq) or v.shape[:3] != k.shape[:3] \
            or o.shape != (B, T, H, dv) or do.shape != o.shape:
        raise ValueError(f"attention_bwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)} disagree")
    if Hkv < 1 or H % Hkv or not (1 <= dq <= 256 and 1 <= dv <= 256):
        raise ValueError(f"attention_bwd: {H} heads over {Hkv}, dq={dq}, "
                         f"dv={dv}; the kernel takes head dims 1..256")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"attention_bwd: lse must be contiguous fp32 "
                         f"{(B, H, T)}, got {tuple(lse.shape)} {lse.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"attention_bwd: window={window} must be >= 1")
    dq_ = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv_ = torch.empty_like(v, memory_format=torch.contiguous_format)
    if B and T and H and S:
        delta = torch.empty((B, H, T), dtype=torch.float32, device=dev)
        strides = (ctypes.c_int64 * 32)(
            *(s for t in (q, k, v, o, do, dq_, dk, dv_) for s in t.stride()))
        fn = _build.kernel("repro_flash_attention_bwd", _ARGTYPES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq_.data_ptr(), dk.data_ptr(),
                 dv_.data_ptr(), B, T, S, H, Hkv, dq, dv, float(scale),
                 int(causal), int(window is not None), int(window or 0),
                 ctypes.addressof(strides), stream)
        _build.check(err, "flash_attention_bwd")
        _build.count(sys.modules[__name__])
    else:
        for t in (dq_, dk, dv_):
            t.zero_()
    return dq_, dk, dv_
