"""Attention op: forward online-softmax attention, and its gradient.

Replaces ``repro.kernels.flash_attention.ops.attention`` (Pallas TPU kernel
``flash_attention.py:73``). On a CUDA tensor the wrapper launches the
hand-written kernel in ``csrc/flash_attention.cu`` or raises; only a CPU
tensor takes the plain version in ``ref.py``. bf16 inputs run the
tensor-core kernel (``mma.sync``), fp32 inputs the CUDA-core kernel; both
read the (B, T, H, d) layout through strides, mask ragged T and S
themselves, and take dq != dv and head dims up to 256. A tensor whose rows
cannot be copied 16 bytes at a time is read element by element by the same
kernel: the wrapper makes no copies.

Training: on CUDA tensors, with grad mode on and an input requiring grad,
``attention`` goes through ``_FlashAttention``, an autograd Function whose
forward is the same kernel writing each row's logsumexp beside o and whose
backward is the hand-written kernel of ``backward.py``. CPU tensors keep
the plain version, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
import math
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import rows16
from repro_torch.kernels.flash_attention import backward as _backward
from repro_torch.kernels.flash_attention import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)


def attention(q, k, v, *, causal: bool = True, window=None, scale=None):
    """q: (B,T,H,dq), k: (B,S,Hkv,dq), v: (B,S,Hkv,dv) -> (B,T,H,dv) in
    q's dtype. ``scale`` defaults to 1/sqrt(dq); ``window`` (keys within
    ``window`` positions of the query) applies on top of ``causal``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _ref.attention(q, k, v, causal=causal, window=window,
                              scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)[0]


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward (with its logsumexp) and backward; saves q, k,
    v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, window, scale = ctx.mask
        dq, dk, dv = _backward.attention_bwd(*ctx.saved_tensors, do,
                                             causal=causal, window=window,
                                             scale=scale)
        return dq, dk, dv, None, None, None


def _forward(q, k, v, causal, window, scale, with_lse=False):
    """The forward kernel on CUDA tensors -> (o, lse (B, H, T) fp32 or
    None)."""
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"attention: q, k, v on {q.device}, {k.device}, "
                         f"{v.device}; need one CUDA device (or the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention: dtypes {q.dtype}, {k.dtype}, {v.dtype};"
                        f" the kernel takes float32 or bfloat16, all alike")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("attention: q, k, v must be (B, T|S, heads, dim)")
    B, T, H, dq = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if (k.shape[0], k.shape[3]) != (B, dq) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"attention: {H} query heads over {Hkv} kv heads")
    if not (1 <= dq <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"attention: head dims dq={dq}, dv={dv}; the kernel "
                         f"takes 1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"attention: window={window} must be >= 1")
    o = torch.empty((B, T, H, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev) \
        if with_lse else None
    if B and T and H:
        strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(),
                                        *v.stride(), *o.stride())
        fn = _build.kernel("repro_flash_attention_fwd", _ARGTYPES)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), None if lse is None else lse.data_ptr(),
                 B, T, S, H, Hkv, dq, dv, float(scale),
                 int(causal), int(window is not None),
                 int(window or 0),
                 sum(rows16(t) << i for i, t in enumerate((q, k, v))),
                 ctypes.addressof(strides), stream)
        _build.check(err, "flash_attention")
        _build.count(sys.modules[__name__])
    return o, lse
