"""Backward of the attention op: the hand-written kernel
``csrc/flash_attention_bwd.cu``.

The JAX package's Pallas attention is forward only and JAX differentiates
its jnp paths; the port's plain version serves CPU tensors only, so the
gradient on the card is this kernel (FlashAttention-2's backward, from the
forward's logsumexp: bf16 on the tensor cores, fp32 register-tiled on the
CUDA cores). ``ops.attention`` reaches it through its autograd Function;
``attention_bwd`` on CPU tensors is the plain version
(``ref.attention_bwd``). ``Plan`` is the kernel's launch plan, which the
wrapper passes to the C entry point. ``launches`` counts wrapper calls that
launched (one call: the delta, dK/dV and dQ kernels).
"""
from __future__ import annotations

import ctypes
import math
import sys
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)

TILE = 64               # keys of a dK/dV block, query rows of a dQ block
SMEM_MAX = 232448       # dynamic shared memory a block may have
SMEM_HALF = 115712      # a block's share where two share an SM
SMS = 132               # an H100's SMs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
             + [ctypes.c_float] + [ctypes.c_int] * 9
             + [ctypes.c_void_p] * 2)


def _smem(resident: int, stage: int, extra: int, two_blocks: bool) -> int:
    """Bytes of a block: its resident tiles, two stages of the streamed
    ones where they fit its share of an SM (half of it where two blocks
    share one), else one, and ``extra``."""
    limit = SMEM_HALF if two_blocks else SMEM_MAX
    stages = 2 if resident + 2 * stage + extra <= limit else 1
    return resident + stages * stage + extra


@dataclass(frozen=True)
class Plan:
    """The backward's launches for one call, as
    ``csrc/flash_attention_bwd.cu`` makes them (the ``TcKv``, ``TcQ``,
    ``FKv`` and ``FQ`` layouts, ``query_rows`` and ``key_tiles``). A dK/dV
    block owns ``TILE`` keys of a kv head and batch row and streams the
    query tiles of ``query_tiles(key_tile)`` for its heads of the group:
    in bf16 a pair of blocks (a cluster, ``split`` 2) may share the key
    tile, each taking every other head, and sum the group between them; a
    dQ block owns ``TILE`` query rows of a head and streams the key tiles
    of ``key_tiles(query_tile)``. Streamed tiles hold ``stream`` rows."""
    B: int
    T: int
    S: int
    H: int
    Hkv: int
    dq: int
    dv: int
    causal: bool
    window: int | None
    dtype: torch.dtype

    @property
    def bf16(self) -> bool:
        return self.dtype == torch.bfloat16

    @property
    def instance(self) -> tuple:
        """The compiled head dims (dq, dv) that cover the call's."""
        m = max(self.dq, self.dv)
        if m <= 64:
            return (64, 64)
        if m <= 128:
            return (128, 128)
        if self.dq <= 192 and self.dv <= 128:
            return (192, 128)
        return (256, 256)

    @property
    def stream(self) -> int:
        """Rows of a streamed tile: 64, or 32 for fp32 above head dim 128
        (so that the resident tile and one stage fit a block)."""
        return 64 if self.bf16 or max(self.instance) <= 128 else 32

    @property
    def split(self) -> int:
        """bf16 dK/dV blocks a key tile: 2 (a cluster of two, every other
        head each) where the group is even and the key tiles alone leave
        SMs idle, else 1. On the card pairs beat clusters of 3, 4 and 6
        (PERF.md §6)."""
        tiles = -(-self.S // TILE) * self.Hkv * self.B
        return 2 if (self.bf16 and (self.H // self.Hkv) % 2 == 0
                     and tiles < SMS) else 1

    @property
    def grid_kv(self) -> tuple:
        return (-(-self.S // TILE) * self.split, self.Hkv, self.B)

    @property
    def grid_q(self) -> tuple:
        return (-(-self.T // TILE), self.H, self.B)

    @property
    def threads_kv(self) -> int:
        return 256

    @property
    def threads_q(self) -> int:
        return 128 if self.bf16 else 256

    @property
    def smem_kv(self) -> int:
        dq, dv = self.instance
        if self.bf16:        # K, V resident; Q, dO, lse, D; P^T of 4 pairs
            tile = 2 * (dq + dv + 16)
            return _smem(TILE * tile, 64 * tile + 8 * 64, 16384, False)
        tq = self.stream     # K, V (rows + 4 words); Q, dO, lse, D; P, dS
        return _smem(4 * TILE * (dq + dv + 8), 4 * tq * (dq + dv + 2),
                     8 * tq * 68, max(dq, dv) <= 64)

    @property
    def smem_q(self) -> int:
        dq, dv = self.instance
        if self.bf16:        # Q, dO resident; K, V
            tile = 2 * (dq + dv + 16)
            return _smem(TILE * tile, 64 * tile, 0,
                         (TILE + 64) * tile <= SMEM_HALF)
        tk = self.stream     # Q, dO; K, V (rows + 4 words); dS^T
        return _smem(4 * TILE * (dq + dv), 4 * tk * (dq + dv + 8),
                     4 * tk * 68, max(dq, dv) <= 64)

    def query_tiles(self, key_tile: int) -> range:
        """The query tiles (of ``stream`` rows) that the dK/dV block of
        ``key_tile`` walks: those holding a row that sees one of its
        keys."""
        k0 = key_tile * TILE
        k1, off = min(k0 + TILE, self.S), self.S - self.T
        lo, hi = 0, self.T
        if self.causal:
            lo = max(0, k0 - off)
        if self.window is not None:
            hi = min(self.T, k1 - 1 + self.window - off)
        if hi <= lo:
            return range(0)
        return range(lo // self.stream, -(-hi // self.stream))

    def key_tiles(self, query_tile: int) -> range:
        """The key tiles (of ``stream`` keys) that the dQ block of
        ``query_tile`` walks: those holding a key that one of its rows
        sees."""
        tk, off = self.stream, self.S - self.T
        nk = -(-self.S // tk)
        q0 = query_tile * TILE
        pos_lo, pos_hi = q0 + off, min(q0 + TILE, self.T) - 1 + off
        lo, hi = 0, nk
        if self.causal:
            hi = 0 if pos_hi < 0 else min(nk, pos_hi // tk + 1)
        if self.window is not None:
            e = pos_lo - self.window
            lo = 0 if e < 0 else (nk if e + 1 >= self.S else (e + 1) // tk)
        return range(lo, max(lo, hi))


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
        pl = Plan(B, T, S, H, Hkv, dq, dv, causal, window, q.dtype)
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
                 sum(_build.rows16(t) << i for i, t in enumerate((q, k, v,
                                                                  do)))
                 | (_build.rows16(o) and _build.rows16(do)
                    and dv * o.element_size() % 16 == 0) << 4,
                 *pl.instance, pl.split, pl.smem_kv, pl.smem_q,
                 ctypes.addressof(strides), stream)
        _build.check(err, "flash_attention_bwd")
        _build.count(sys.modules[__name__])
    else:
        for t in (dq_, dk, dv_):
            t.zero_()
    return dq_, dk, dv_
