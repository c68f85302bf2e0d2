"""Shared model components (``repro.models.common``): initialisers, layer
stacking, norms (qk-norm too), activations, rope frequencies and
activation taps."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.interop import flatten, map_tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# initialisers: drawn from an explicit generator on its own device. A CPU
# generator gives the same weights whatever device they are moved to; a
# CUDA one draws a large model on the card (other values, same shapes)
# ---------------------------------------------------------------------------

# a leaf larger than this many values is drawn one slice of its first axis
# at a time (deepseek-v3's expert stack is 3.76 G values: 15 GB in fp32)
_CHUNKED_DRAW = 1 << 30


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Normal weights over ``sqrt(shape[0])``, as the JAX package scales
    them (an expert stack (E, D, F) is scaled by its expert count). A leaf
    of more than ``_CHUNKED_DRAW`` values is drawn in fp32 one slice of its
    first axis at a time and cast into its dtype, so the fp32 transient is
    one slice."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    if math.prod(shape) <= _CHUNKED_DRAW:
        return (torch.randn(shape, generator=gen, device=gen.device)
                * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for row in out:
        row.copy_(torch.randn(row.shape, generator=gen, device=gen.device)
                  .mul_(scale))
    return out


def embed_init(gen: torch.Generator, shape, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * 0.02) \
        .to(dtype)


def stack_layers(trees):
    """Per-layer param (or cache) dicts -> one dict whose leaves carry a
    leading layer axis, as the JAX package stacks a scanned segment."""
    return {k: stack_layers([t[k] for t in trees])
            if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def init_stacked(make, reps: int):
    """``stack_layers([make() for _ in range(reps)])`` without holding the
    layers twice: each layer is drawn in turn (the same draws, in the same
    order) and copied into the stacked buffers."""
    first = make()
    if reps == 1:               # a view: the one layer is not copied
        return map_tree(lambda t: t[None], first)
    out = map_tree(lambda t: t.new_empty((reps,) + tuple(t.shape)), first)
    dst = flatten(out)
    for r in range(reps):
        for k, v in flatten(first if r == 0 else make()).items():
            dst[k][r].copy_(v)
    return out


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked dict: views, so in-place writes reach the
    stacked tensors."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def init_norm(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones(d), "bias": torch.zeros(d)}
    return {"scale": torch.ones(d)}


# ---------------------------------------------------------------------------
# norms (fp32 math, result in the input dtype)
# ---------------------------------------------------------------------------

def apply_norm(p, x, cfg):
    xf = x.float()
    if "bias" in p:  # layernorm; biased variance, as jnp.var
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(x, scale, eps):
    """QK-norm over the last (head) dim; ``scale`` broadcasts against x's
    trailing dims: shared by every head (d,) or per head (H, d)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation(name: str):
    """jax.nn.gelu defaults to the tanh approximation, so "gelu" is
    ``F.gelu(approximate="tanh")`` here."""
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: F.relu(x).square(),
    }[name]


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float) -> np.ndarray:
    """Per-pair inverse frequencies in float64 (dim must be even); callers
    cast to fp32, as the JAX package does."""
    return 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def apply_rope(x, positions, theta: float):
    """Rope with one frequency table for every head
    (``repro.models.common.apply_rope``): x (..., T, H, D), D even,
    positions (..., T). Interleaved pairs (0::2, 1::2), fp32 angles, the
    result cast back to x's dtype."""
    inv = torch.from_numpy(rope_freqs(x.shape[-1], theta)).float() \
        .to(x.device)
    ang = positions.float()[..., None] * inv              # (..., T, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# taps (activation tape for CORP calibration)
# ---------------------------------------------------------------------------

_TAP_DTYPE = torch.float32


class tap_dtype:
    """Context setting the dtype activation taps are recorded in (fp32 by
    default; statistics accumulate in fp32 whatever the tap dtype)."""

    def __init__(self, dtype):
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype

    def __enter__(self):
        global _TAP_DTYPE
        self._prev, _TAP_DTYPE = _TAP_DTYPE, self.dtype
        return self

    def __exit__(self, *exc):
        global _TAP_DTYPE
        _TAP_DTYPE = self._prev
        return False


_EXPERT_TAPS = False


@contextlib.contextmanager
def expert_taps(on: bool = True):
    """Record the MoE taps ``moe_x`` / ``moe_yc`` (the regressors of
    whole-expert removal) while the context is open. Off by default: their
    second moment is ((E+1) D)^2 a layer, 1.1 TB at qwen3-moe's full
    width, and only expert pruning reads it (the reference records them
    on every taped forward)."""
    global _EXPERT_TAPS
    prev, _EXPERT_TAPS = _EXPERT_TAPS, on
    try:
        yield
    finally:
        _EXPERT_TAPS = prev


def expert_taps_on() -> bool:
    return _EXPERT_TAPS


def tap(taps: dict | None, name: str, value):
    """Record an intermediate activation; ``taps`` is None when not taping."""
    if taps is not None:
        taps[name] = value.to(_TAP_DTYPE)


def merge_taps(dst: dict | None, src: dict, prefix: str):
    if dst is not None:
        for k, v in src.items():
            dst[f"{prefix}/{k}" if prefix else k] = v
