"""RWKV-6 recurrence op.

Replaces ``repro.kernels.wkv6.ops.wkv6`` (Pallas TPU kernel ``wkv6``,
``wkv6.py:76``). On a CUDA tensor the wrapper launches the hand-written
chunked kernel in ``csrc/wkv6.cu`` or raises; only CPU tensors take the
plain scan in ``ref.py``. The kernel reads r, k, v, w in the model's
(B, T, H, N) layout through strides, takes any T >= 1, and writes the
final state into ``out_state`` when one is given, which may be the initial
state itself: a decode step updates one layer's slice of the stacked cache
in place.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)

MAX_HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 2)


def _overlap(a, b) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() \
        and b0 < a0 + a.numel() * a.element_size()


def wkv6(r, k, v, w, u, state=None, *, out_state=None):
    """r, k, v, w: (B, T, H, N); u: (H, N) fp32; ``state``: optional
    (B, H, N, N) fp32 initial state (zeros when None). Returns (y (B, T, H,
    N) in r's dtype, final state (B, H, N, N) fp32); the final state is
    ``out_state`` when given (it may be ``state`` itself)."""
    extra = [t for t in (state, out_state) if t is not None]
    if all(t.device.type == "cpu" for t in (r, k, v, w, u, *extra)):
        y, s = _ref.wkv6(r, k, v, w, u, state)
        if out_state is None:
            return y, s
        return y, out_state.copy_(s)
    global launches
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (k, v, w, u, *extra)):
        raise ValueError("wkv6: r, k, v, w, u and the states must lie on "
                         "one CUDA device (or all on the CPU)")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError(f"wkv6: dtypes {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}; the kernel takes float32 or bfloat16, "
                        f"all alike")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: r, k, v, w must share one (B, T, H, N) "
                         f"shape, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, T, H, N = r.shape
    if not (1 <= N <= MAX_HEAD_DIM) or T < 1 or B < 1 or H < 1 \
            or B > 65535:
        raise ValueError(f"wkv6: shape {tuple(r.shape)}; the kernel takes "
                         f"T >= 1, 1 <= B <= 65535, H >= 1 and head dims "
                         f"1..{MAX_HEAD_DIM}")
    if tuple(u.shape) != (H, N) or u.dtype != torch.float32 \
            or not u.is_contiguous():
        raise ValueError(f"wkv6: u must be a contiguous fp32 ({H}, {N}), "
                         f"got {u.dtype} {tuple(u.shape)}")
    for name, s in (("state", state), ("out_state", out_state)):
        if s is not None and (tuple(s.shape) != (B, H, N, N)
                              or s.dtype != torch.float32
                              or not s.is_contiguous()):
            raise ValueError(f"wkv6: {name} must be a contiguous fp32 "
                             f"({B}, {H}, {N}, {N}), got {s.dtype} "
                             f"{tuple(s.shape)}")
    if out_state is None:
        out_state = torch.empty((B, H, N, N), dtype=torch.float32,
                                device=dev)
    elif state is not None and out_state.data_ptr() != state.data_ptr() \
            and _overlap(out_state, state):
        raise ValueError("wkv6: out_state overlaps state without being it")
    y = torch.empty((B, T, H, N), dtype=r.dtype, device=dev)
    strides = (ctypes.c_int64 * 20)(*r.stride(), *k.stride(), *v.stride(),
                                    *w.stride(), *y.stride())
    fn = _build.kernel("repro_wkv6", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
             w.data_ptr(), u.data_ptr(),
             None if state is None else state.data_ptr(),
             out_state.data_ptr(), y.data_ptr(), B, T, H, N,
             ctypes.addressof(strides), stream)
    _build.check(err, "wkv6")
    launches += 1
    return y, out_state
