"""Decode attention op: one new query token against a masked KV cache.

Replaces ``repro.kernels.flash_decode.ops.decode_attention`` (Pallas TPU
kernel ``decode_attention_splits``, ``flash_decode.py:51``, and its
logsumexp merge). On a CUDA tensor the wrapper launches the hand-written
kernel in ``csrc/flash_decode.cu`` or raises; only a CPU tensor takes the
plain version in ``ref.py``. The kernel reads the cache in its own
(B, S, Hkv, d) layout through strides, so a decode step passes one layer's
slice of the stacked cache without a copy. It is one launch: the splits of
a (batch row, kv head) merge inside their thread block cluster, and tiles
without a valid key are never read. A row with no valid key gives 0 on
both devices, as the Pallas kernel does (the JAX ref gives the mean of V
there; ``ref.py`` says why the port does not).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import rows16
from repro_torch.kernels.flash_decode import ref as _ref

launches = 0            # kernel launches in this process (chip_smoke reads it)

MAX_HEAD_DIM = 256
MAX_GROUP = 32          # query heads per kv head
TILE = 64               # keys per shared-memory tile of the kernel
MAX_SPLITS = 8          # splits of one row: the blocks of one cluster
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VALID_DTYPES = (torch.bool, torch.int8, torch.uint8)
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 2)


@dataclass(frozen=True)
class Plan:
    """How the kernel cuts one (batch row, kv head) of the cache: ``tiles``
    tiles of 64 keys, dealt round-robin to ``splits`` blocks of one
    cluster, so a valid prefix spreads over all of them."""
    tiles: int
    splits: int

    def tiles_of(self, split: int) -> range:
        return range(split, self.tiles, self.splits)


def plan(S: int, n_rows: int, sms: int, bs=None) -> Plan:
    """Splits for a cache of S keys and ``n_rows`` = B * Hkv rows on a card
    of ``sms`` SMs: enough that the blocks fill the SMs, each with at least
    two tiles for its pipeline, at most ``MAX_SPLITS`` and one a tile.
    ``bs`` (keys per split) is rounded up to whole tiles and gives
    ceil(S / bs) splits, within the same limits."""
    tiles = math.ceil(S / TILE)
    if bs is None:
        want = min(tiles // 2, math.ceil(sms / max(1, n_rows)))
    else:
        want = math.ceil(S / (math.ceil(bs / TILE) * TILE))
    return Plan(tiles, max(1, min(want, MAX_SPLITS, tiles)))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k, v, valid, *, scale=None, bs=None):
    """q: (B,H,dq); k: (B,S,Hkv,dq); v: (B,S,Hkv,dv); valid: (B,S) bool or
    int8 -> (B,H,dv) in q's dtype, 0 for a row with no valid key. ``bs`` (keys per split, rounded up to
    whole 64-key tiles, at most 8 splits) defaults to ``plan``'s choice;
    the result does not depend on it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if all(t.device.type == "cpu" for t in (q, k, v, valid)):
        return _ref.decode_attention(q, k, v, valid, scale)
    global launches
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, valid)):
        raise ValueError(f"decode_attention: q, k, v, valid on {q.device}, "
                         f"{k.device}, {v.device}, {valid.device}; need one "
                         f"CUDA device (or the CPU)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes float32 or bfloat16, "
                        f"all alike")
    if valid.dtype not in _VALID_DTYPES:
        raise TypeError(f"decode_attention: valid of dtype {valid.dtype}; "
                        f"need bool, int8 or uint8")
    if q.ndim != 3 or k.ndim != 4 or v.ndim != 4 or valid.ndim != 2:
        raise ValueError("decode_attention: need q (B,H,dq), k/v "
                         "(B,S,Hkv,d), valid (B,S)")
    B, H, dq = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if (k.shape[0], k.shape[3]) != (B, dq) or v.shape[:3] != k.shape[:3] \
            or tuple(valid.shape) != (B, S):
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, valid "
                         f"{tuple(valid.shape)} disagree")
    if Hkv < 1 or H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {H} query heads over {Hkv} kv "
                         f"heads; the kernel takes groups of 1..{MAX_GROUP}")
    if not (1 <= dq <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"decode_attention: head dims dq={dq}, dv={dv}; the "
                         f"kernel takes 1..{MAX_HEAD_DIM}")
    if S < 1:
        raise ValueError("decode_attention: empty cache (S = 0)")
    if bs is not None and int(bs) < 1:
        raise ValueError(f"decode_attention: bs={bs} must be >= 1")
    o = torch.empty((B, H, dv), dtype=q.dtype, device=dev)
    if B == 0:
        return o
    if B > 65535:
        raise ValueError(f"decode_attention: B={B}; the kernel takes up to "
                         f"65535 rows")
    ns = plan(S, B * Hkv, sm_count(dev.index), bs).splits
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *valid.stride(), *o.stride())
    fn = _build.kernel("repro_flash_decode", _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             valid.data_ptr(), o.data_ptr(), B, S, H, Hkv, dq, dv, ns,
             float(scale), rows16(k) | rows16(v) << 1,
             ctypes.addressof(strides), stream)
    _build.check(err, "flash_decode")
    launches += 1
    return o
