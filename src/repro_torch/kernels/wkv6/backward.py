"""Backward of the RWKV-6 recurrence: the hand-written kernel
``csrc/wkv6_bwd.cu``.

The JAX package's Pallas ``wkv6`` is forward only and JAX differentiates
its jnp paths; the port's plain version serves CPU tensors only, so the
gradient on the card is this kernel, and RWKV-6 trains there. ``ops.wkv6``
reaches it through its autograd Function, which hands over the forward's
chunk start states; ``wkv6_bwd`` on CPU tensors is the plain version
(``ref.wkv6_bwd``). It reads r, k, v, w and dy through their strides, as
the forward does. dw is the direct form, rowsum(dS_t * S_{t-1}) on the
forward's states recomputed from each chunk's start (nothing is divided by
w), so it stays exact at small decays; where the forward kernel takes
log2(max(w, 1e-38)) the backward takes w as it is. ``Plan`` sizes its fp32
scratch. ``launches`` counts wrapper calls that launched (one call: four
kernels, the chunks' gradient deltas, the reverse walk, the per-chunk
gradients and du's sum).
"""
from __future__ import annotations

import ctypes
import math
import sys
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ops as _ops
from repro_torch.kernels.wkv6 import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 2)


@dataclass(frozen=True)
class Plan:
    """The backward's cut of T tokens: the forward's chunks of 64 (the last
    one ragged; T = 1 is one chunk), each a block per (head, batch row) in
    its per-chunk launches, and its fp32 scratch: one N x N gradient delta
    (then the chunk's end-state gradient), one decay vector and one partial
    du per (batch row, head, chunk). ``starts_shape`` is what the forward
    keeps for it: each chunk's start state."""
    B: int
    T: int
    H: int
    N: int

    @property
    def chunks(self) -> int:
        return math.ceil(self.T / _ops.CHUNK)

    @property
    def blocks(self) -> int:
        return self.chunks * self.H * self.B

    @property
    def grad_shape(self) -> tuple:
        return (self.B, self.H, self.chunks, self.N, self.N)

    @property
    def decay_shape(self) -> tuple:
        return (self.B, self.H, self.chunks, self.N)

    starts_shape = grad_shape


def wkv6_bwd(r, k, v, w, u, state, dy, dstate=None, *, starts=None):
    """The gradient of ``ops.wkv6(r, k, v, w, u, state)`` given ``dy``
    (B, T, H, N) in r's dtype and the final state's gradient ``dstate``
    (B, H, N, N) fp32 (zeros when None) -> (dr, dk, dv, dw in r's dtype, du
    (H, N) fp32, dstate0 (B, H, N, N) fp32, or None when ``state`` is
    None). ``starts``: the forward's chunk start states
    (``Plan.starts_shape``; T = 1: ``state``); when None on CUDA tensors
    with T > 1 the forward kernel runs first to make them. On CUDA tensors
    it launches the kernel or raises; CPU tensors take the plain
    version."""
    given = [t for t in (state, dstate, starts) if t is not None]
    if all(t.device.type == "cpu" for t in (r, k, v, w, u, dy, *given)):
        return _ref.wkv6_bwd(r, k, v, w, u, state, dy, dstate)
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (k, v, w, u, dy, *given)):
        raise ValueError("wkv6_bwd: r, k, v, w, u, dy and the states must "
                         "lie on one CUDA device (or all on the CPU)")
    if r.dtype not in _ops._DTYPES or any(t.dtype != r.dtype
                                          for t in (k, v, w, dy)):
        raise TypeError(f"wkv6_bwd: dtypes {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}, {dy.dtype}; the kernel takes float32 "
                        f"or bfloat16, all alike")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w, dy)):
        raise ValueError(f"wkv6_bwd: r, k, v, w, dy must share one (B, T, "
                         f"H, N) shape, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}, {tuple(dy.shape)}")
    B, T, H, N = r.shape
    if not (1 <= N <= _ops.MAX_HEAD_DIM) or T < 1 or B < 1 or H < 1 \
            or B > 65535 or H > 65535:
        raise ValueError(f"wkv6_bwd: shape {tuple(r.shape)}; the kernel "
                         f"takes T >= 1, 1 <= B, H <= 65535 and head dims "
                         f"1..{_ops.MAX_HEAD_DIM}")
    if tuple(u.shape) != (H, N) or u.dtype != torch.float32 \
            or not u.is_contiguous():
        raise ValueError(f"wkv6_bwd: u must be a contiguous fp32 ({H}, {N}),"
                         f" got {u.dtype} {tuple(u.shape)}")
    pl = Plan(B, T, H, N)
    if starts is None:
        starts = state if T == 1 else _ops._forward(r, k, v, w, u, state,
                                                    None)[2]
    want = {"state": (B, H, N, N), "dstate": (B, H, N, N),
            "starts": pl.starts_shape if T > 1 else (B, H, N, N)}
    for name, s in (("state", state), ("dstate", dstate),
                    ("starts", starts)):
        if s is not None and (tuple(s.shape) != want[name]
                              or s.dtype != torch.float32
                              or not s.is_contiguous()):
            raise ValueError(f"wkv6_bwd: {name} must be a contiguous fp32 "
                             f"{want[name]}, got {s.dtype} "
                             f"{tuple(s.shape)}")
    dr, dk, dv, dw = (torch.empty((B, T, H, N), dtype=r.dtype, device=dev)
                      for _ in range(4))
    du = torch.empty((H, N), dtype=torch.float32, device=dev)
    dstate0 = None if state is None else torch.empty(
        (B, H, N, N), dtype=torch.float32, device=dev)
    dg = torch.empty(pl.grad_shape, dtype=torch.float32, device=dev)
    dec, dup = (torch.empty(pl.decay_shape, dtype=torch.float32, device=dev)
                for _ in range(2))
    strides = (ctypes.c_int64 * 20)(*r.stride(), *k.stride(), *v.stride(),
                                    *w.stride(), *dy.stride())

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _build.kernel("repro_wkv6_bwd", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_ops._DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
             w.data_ptr(), dy.data_ptr(), u.data_ptr(), ptr(starts),
             ptr(dstate), ptr(dstate0), dr.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), dw.data_ptr(), du.data_ptr(), dg.data_ptr(),
             dec.data_ptr(), dup.data_ptr(), B, T, H, N,
             sum(_ops._vec(t) << i for i, t in enumerate((r, k, v, w, dy))),
             ctypes.addressof(strides), stream)
    _build.check(err, "wkv6_bwd")
    _build.count(sys.modules[__name__])
    return dr, dk, dv, dw, du, dstate0
