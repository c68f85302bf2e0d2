"""Gram op: the calibration second moments X^T Y plus column sums.

Replaces ``repro.kernels.gram.ops.gram`` / ``gram_cross`` (Pallas TPU
kernels ``gram.py:104`` / ``gram.py:152``) and ``gram_sharded``, a rank's
column block of ``gram`` on the same ``gram_cross`` kernel. On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/gram.cu`` or raises; only a CPU
tensor takes the plain version in ``ref.py``. Leading dims (the stacked
layer axis of a tap) are folded into the kernel's work items: one launch
covers every layer. Accumulation is fp32 for fp32 and bf16 inputs alike.
``gram(x)`` runs only the upper triangle of tiles and returns an exactly
symmetric ``s2``. The tiles of a last, partial wave are split over the
tokens and their partials added in order by a second kernel
(deterministic, no atomics). A tensor whose rows cannot be copied 16
bytes at a time is read element by element by the same kernel: the wrapper
makes no copies.
"""
from __future__ import annotations

import collections
import ctypes
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import rows16
from repro_torch.kernels.gram import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)
# the same launches by op and input dtype: {("gram" | "gram_cross",
# "float32" | "bfloat16"): n}
launches_by = collections.Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_int64] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])

TILE = 128              # output tile edge of a block (gram.cu BM, BN)
STAGE_TOKENS = 16       # tokens per stage (gram.cu BK)


def split_plan(pairs: int, n: int, sms: int) -> tuple:
    """(full, splits) for a launch of ``pairs`` (layer, tile) pairs over
    ``n`` tokens, one block of 256 threads on each of ``sms`` SMs: whole
    waves of pairs run whole, and the pairs of a last, partial wave are split
    over the tokens into ``splits`` items each so that they fill one wave
    (gram_cross at (3152, 3072) x (3152, 768): 144 pairs on 132 SMs, 12
    pairs split 11 ways). ``full == pairs`` when nothing is split."""
    rem = pairs % sms
    splits = min(sms // rem, -(-n // STAGE_TOKENS)) if rem else 1
    if splits < 2:
        return pairs, 1
    return pairs - rem, splits


def _as3d(a: torch.Tensor) -> torch.Tensor:
    if a.ndim < 2:
        raise ValueError(f"gram expects (..., N, F), got shape "
                         f"{tuple(a.shape)}")
    return a.reshape((-1,) + tuple(a.shape[-2:]))


def gram_cross(x: torch.Tensor, y: torch.Tensor) -> dict:
    """x: (..., N, Fx), y: (..., N, Fy) -> {'s2': (..., Fx, Fy) fp32 X^T Y,
    's1': (..., Fy) fp32 column sums of Y}."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return _ref.gram_cross(x, y)
    return _launch(x, y, sym=False)


def _launch(x: torch.Tensor, y: torch.Tensor, sym: bool) -> dict:
    _build.refuse_grad("gram" if sym else "gram_cross", (x, y),
                       "calibration statistics are not trained through")
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"gram_cross: tensors on {x.device} and {y.device}; "
                         f"need both on one CUDA device (or both on the CPU)")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"gram_cross: dtypes {x.dtype}, {y.dtype}; the "
                        f"kernel takes float32 or bfloat16, the same for both")
    if x.shape[:-1] != y.shape[:-1]:
        raise ValueError(f"gram_cross: shapes {tuple(x.shape)} and "
                         f"{tuple(y.shape)} differ before the last dim")
    lead = tuple(x.shape[:-2])
    x3, y3 = _as3d(x), _as3d(y)
    L, N, Fx = x3.shape
    Fy = y3.shape[-1]
    s2 = torch.empty((L, Fx, Fy), dtype=torch.float32, device=x.device)
    s1 = torch.empty((L, Fy), dtype=torch.float32, device=x.device)
    if L and Fx and Fy:
        nti, ntj = -(-Fx // TILE), -(-Fy // TILE)
        pairs = L * (nti * (nti + 1) // 2 if sym else nti * ntj)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        full, splits = split_plan(pairs, N, sms)
        p2 = p1 = None
        if full < pairs:
            slots = (pairs - full) * splits
            p2 = torch.empty((slots, TILE, TILE), dtype=torch.float32,
                             device=x.device)
            p1 = torch.empty((slots, TILE), dtype=torch.float32,
                             device=x.device)
        fn = _build.kernel("repro_gram_cross", _ARGTYPES)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x3.data_ptr(), y3.data_ptr(),
                 s2.data_ptr(), s1.data_ptr(),
                 p2.data_ptr() if p2 is not None else None,
                 p1.data_ptr() if p1 is not None else None, L, N, Fx, Fy,
                 *x3.stride(), *y3.stride(), int(sym),
                 int(rows16(x3)) | int(rows16(y3)) << 1, full, splits,
                 stream)
        _build.check(err, "gram_cross")
        _build.count(sys.modules[__name__],
                     ("gram" if sym else "gram_cross", str(x.dtype)[6:]))
    return {"s2": s2.reshape(lead + (Fx, Fy)), "s1": s1.reshape(lead + (Fy,))}


def gram_sharded(x: torch.Tensor, shard) -> dict:
    """Model-sharded gram (``repro.kernels.gram.ops.gram_sharded``): x
    (..., N, F), this rank's rows -> {'s2': (..., F, F/m) fp32 X^T X[:,
    lo:hi], 's1': (..., F/m) its column sums}, for this rank's column block
    [lo, hi) = ``shard.block(F)`` (a ``distrib.sharding.CalibSharding``).

    One gram_cross launch against the block as a strided view of x: for
    rows of a contiguous x, ``_as3d``'s reshape of the view is a view too
    (no copy), and its rows stay 16-byte copyable when the block's offset
    is. Nothing is reduced here: the calibration engine sums the batch
    axes' partial sums once a pass. ``shard.block`` raises for a width the
    model axis does not split."""
    lo, hi = shard.block(x.shape[-1])
    return gram_cross(x, x[..., lo:hi])


def gram(x: torch.Tensor) -> dict:
    """x: (..., N, F) -> {'s2': (..., F, F) fp32 X^T X, exactly symmetric,
    's1': (..., F)}."""
    if x.device.type == "cpu":
        return _ref.gram(x)
    return _launch(x, x, sym=True)
