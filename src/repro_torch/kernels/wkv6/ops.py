"""RWKV-6 recurrence op, and its gradient.

Replaces ``repro.kernels.wkv6.ops.wkv6`` (Pallas TPU kernel ``wkv6``,
``wkv6.py:76``). On a CUDA tensor the wrapper launches the hand-written
kernels in ``csrc/wkv6.cu`` or raises; only CPU tensors take the plain
scan in ``ref.py``. T = 1 runs the streaming one-token kernel, T > 1 the
chunk-parallel prefill (per-chunk state deltas, a walk over the chunks,
per-chunk outputs; ``Plan`` sizes its scratch). Both read r, k, v, w in
the model's (B, T, H, N) layout through strides, and write the final state
into ``out_state`` when one is given, which may be the initial state
itself: a decode step updates one layer's slice of the stacked cache in
place. ``launches`` counts wrapper calls that launched, one each.

Training: on CUDA tensors, with grad mode on and any of r, k, v, w, u or
``state`` requiring grad, ``wkv6`` goes through ``_WKV6``, an autograd
Function whose forward is the same kernel keeping each chunk's start state
(the prefill's scratch after its walk) and whose backward is the
hand-written kernel of ``backward.py`` (``csrc/wkv6_bwd.cu``). An in-place
state update cannot be differentiated, so ``out_state`` under grad raises
``ValueError``. CPU tensors keep the plain scan, which autograd
differentiates. So RWKV-6 trains on the card.
"""
from __future__ import annotations

import ctypes
import math
import sys
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import rows16
from repro_torch.kernels.wkv6 import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)

MAX_HEAD_DIM = 64
CHUNK = 64              # tokens per chunk of the prefill kernels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 2)


@dataclass(frozen=True)
class Plan:
    """The prefill's cut of T tokens: ``chunks`` chunks of up to 64 tokens
    (the last one ragged), each a block per (head, batch row), and the fp32
    scratch they pass between launches: one N x N state delta (then start
    state) and one decay vector per (batch row, head, chunk). T = 1 runs
    the one-token kernel and needs no scratch."""
    B: int
    T: int
    H: int
    N: int

    @property
    def chunks(self) -> int:
        return math.ceil(self.T / CHUNK) if self.T > 1 else 0

    @property
    def blocks(self) -> int:
        """Blocks of each per-chunk launch (T = 1: of the one launch)."""
        return max(1, self.chunks) * self.H * self.B

    @property
    def state_shape(self) -> tuple:
        return (self.B, self.H, self.chunks, self.N, self.N)

    @property
    def decay_shape(self) -> tuple:
        return (self.B, self.H, self.chunks, self.N)


def _vec(t: torch.Tensor) -> bool:
    """Rows of ``t`` may be read 16 bytes at a time: ``rows16`` and whole
    16-byte chunks a row."""
    return rows16(t) and t.shape[-1] * t.element_size() % 16 == 0


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
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u,
                                                        state)):
        if out_state is not None:
            raise ValueError("wkv6: out_state under grad: an in-place state "
                             "update cannot be differentiated; take the "
                             "returned state instead")
        return _WKV6.apply(r, k, v, w, u, state)
    y, s, _ = _forward(r, k, v, w, u, state, out_state)
    return y, s


class _WKV6(torch.autograd.Function):
    """The kernel's forward, keeping each chunk's start state, and the
    backward kernel; saves r, k, v, w, u, the state and the starts. The
    final state's gradient may be None (not used): the backward takes
    zeros."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s, starts = _forward(r, k, v, w, u, state, None)
        ctx.save_for_backward(r, k, v, w, u, state, starts)
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, dstate):
        from repro_torch.kernels.wkv6 import backward as _backward
        r, k, v, w, u, state, starts = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype)
        if dstate is not None:
            dstate = dstate.float().contiguous()
        return _backward.wkv6_bwd(r, k, v, w, u, state, dy, dstate,
                                  starts=starts)


def _forward(r, k, v, w, u, state, out_state):
    """The forward kernel on CUDA tensors -> (y, final state, starts):
    each chunk's start state (B, H, chunks, N, N) fp32, the prefill's
    scratch after its walk (T = 1: ``state`` itself, None for zeros)."""
    extra = [t for t in (state, out_state) if t is not None]
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
            or B > 65535 or H > 65535:
        raise ValueError(f"wkv6: shape {tuple(r.shape)}; the kernel takes "
                         f"T >= 1, 1 <= B, H <= 65535 and head dims "
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
    pl = Plan(B, T, H, N)
    ds = dec = None
    if pl.chunks:
        ds = torch.empty(pl.state_shape, dtype=torch.float32, device=dev)
        dec = torch.empty(pl.decay_shape, dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 20)(*r.stride(), *k.stride(), *v.stride(),
                                    *w.stride(), *y.stride())
    fn = _build.kernel("repro_wkv6", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
             w.data_ptr(), u.data_ptr(),
             None if state is None else state.data_ptr(),
             out_state.data_ptr(), y.data_ptr(),
             None if ds is None else ds.data_ptr(),
             None if dec is None else dec.data_ptr(), B, T, H, N,
             sum(_vec(t) << i for i, t in enumerate((r, k, v, w))),
             ctypes.addressof(strides), stream)
    _build.check(err, "wkv6")
    _build.count(sys.modules[__name__])
    return y, out_state, ds if pl.chunks else state
