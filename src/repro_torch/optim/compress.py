"""Error-feedback int8 gradient compression (``repro.optim.compress``).

Each leaf plus its residual is quantized to int8 with one float32 scale
(max |x| / 127, rounded half to even as ``jnp.round`` rounds); the
residual ``x - dq(q(x))`` feeds back into the next step, so the
compressed estimator telescopes. Plain functions on trees of tensors: the
algorithm that would wrap a data-parallel gradient reduction.
"""
from __future__ import annotations

import torch

from repro_torch.interop import map_tree


def ef_init(params):
    """The error-feedback residual: zeros float32, the params' tree."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _q8(x):
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq8(q, scale):
    return q.float() * scale


def _zip(fn, a, b):
    return {k: _zip(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k])
            for k, v in a.items()}


def compress_grads(grads, ef_state):
    """Returns ((int8 tree, float32 scale tree), new ef_state): the int8
    tree is what would cross the wire."""
    def one(g, e):
        x = g.float() + e
        q, scale = _q8(x)
        return q, scale, x - _dq8(q, scale)

    both = _zip(one, grads, ef_state)
    return ((map_tree(lambda t: t[0], both), map_tree(lambda t: t[1], both)),
            map_tree(lambda t: t[2], both))


def decompress_grads(compressed):
    qt, st = compressed
    return _zip(_dq8, qt, st)


def ef_round_trip(grads, ef_state):
    """Quantize -> (wire) -> dequantize with the error feedback carried."""
    compressed, new_ef = compress_grads(grads, ef_state)
    return decompress_grads(compressed), new_ef
