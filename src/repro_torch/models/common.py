"""Shared model components (``repro.models.common``): initialisers, layer
stacking, norms (qk-norm too), activations, rope frequencies and
activation taps."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

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


# ---------------------------------------------------------------------------
# tensor parallelism (the serving forward over a mesh's model axis)
# ---------------------------------------------------------------------------

class TensorParallel:
    """A rank's share of the model axis: its process group, its index and
    the axis' size. The serving forward takes it as ``tp=`` (None when
    unsharded, so an unsharded call runs as before) and runs Megatron's
    split over the rank's blocks (``distrib.sharding.forward_specs``):
    column blocks in, row blocks out, one ``all_reduce`` of the partial
    sums, which are reduced in fp32 and cast back. The residual stream
    stays replicated over the model axis.

    The collectives go through the process group, or with ``host`` (a
    ``distrib.hostcoll.HostCollectives`` of the group's ranks, which share
    a host) through shared memory.

    ``timed`` adds the host seconds of every collective to ``coll_s``
    (after a device sync, so that they hold the collective alone);
    ``calls`` counts them. A context of one rank (``size`` 1) runs no
    collective.

    ``rows``: where a step's rows are split over a data axis (a sharded
    decode step's slots, a sharded calibration pass's batch), that axis'
    own ``TensorParallel`` (``gather_rows`` gives the whole step's rows,
    in order); else None. Routed MoE reads it to route the whole step as
    one device does (``mlp.apply_moe``). A row context's ``counts`` holds
    each rank's row count where the shares differ (a calibration batch's
    ``tensor_split``); None means equal shares.
    """

    def __init__(self, group, index: int, size: int, host=None):
        self.group, self.index, self.size = group, index, size
        self.host = host
        self.rows = None
        self.counts = None
        self.timed = False
        self.coll_s = 0.0
        self.calls = 0

    def block(self, n: int):
        """This rank's block [lo, hi) of a dim of ``n``."""
        step = n // self.size
        return self.index * step, (self.index + 1) * step

    def local(self, t, n_local: int):
        """The rank's block of ``t``'s last dim when it holds the whole dim
        (a replicated vector, e.g. an MLP bias), else ``t``."""
        if t.shape[-1] == n_local:
            return t
        lo, hi = self.block(t.shape[-1])
        return t[..., lo:hi]

    def _run(self, fn, t):
        """``fn(t)``, counted (and timed when ``timed``)."""
        self.calls += 1
        if not self.timed:
            return fn(t)
        import time
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn(t)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.coll_s += time.perf_counter() - t0
        return out

    def all_reduce(self, x):
        """Sum of the ranks' partial ``x``, reduced in fp32, in x's
        dtype."""
        if self.size == 1:
            return x
        if self.host is not None:
            return self._run(self.host.all_reduce, x)
        import torch.distributed as dist
        y = x.float().contiguous()
        self._run(lambda t: dist.all_reduce(t, group=self.group), y)
        return y.to(x.dtype)

    def reduce_product(self, a, b, eq: str | None = None):
        """``a @ b`` (or ``einsum(eq, a, b)``) of the rank's blocks,
        completed over the ranks (``all_reduce``): the partial in a's
        dtype, summed in fp32, the sum in a's dtype."""
        return self.all_reduce(a @ b if eq is None
                               else torch.einsum(eq, a, b))

    def all_gather(self, x, dim: int = -1):
        """The ranks' blocks of ``x`` concatenated along ``dim``."""
        if self.size == 1:
            return x
        if self.host is not None:
            return self._run(lambda t: self.host.all_gather(t, dim), x)
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._run(lambda t: dist.all_gather(parts, t, group=self.group), x)
        return torch.cat(parts, dim=dim)

    def gather_rows(self, x):
        """The ranks' rows of ``x`` concatenated along dim 0, and the index
        of this rank's first row in them. Shares of unequal ``counts`` are
        padded to the longest for the ``all_gather`` and cut after it."""
        n = x.shape[0]
        counts = self.counts or [n] * self.size
        if counts[self.index] != n:
            raise ValueError(f"rank {self.index} holds {n} rows, its share "
                             f"of {counts} is {counts[self.index]}")
        top = max(counts)
        if n < top:
            x = torch.cat([x, x.new_zeros((top - n,) + x.shape[1:])])
        whole = self.all_gather(x, 0)
        if top * self.size != sum(counts):
            whole = torch.cat([whole[i * top:i * top + c]
                               for i, c in enumerate(counts)])
        return whole, sum(counts[:self.index])

    def embed(self, table, ids, rows: int, cols: int):
        """Embedding lookup of ``ids`` in the rank's block of a ``rows`` x
        ``cols`` table: split on rows (the vocab), the ids outside the
        block are masked and the ranks' lookups summed (exact: one term is
        not zero); split on columns, the columns are gathered; whole, a
        plain lookup."""
        if table.shape[0] != rows:
            lo = self.index * table.shape[0]
            inside = (ids >= lo) & (ids < lo + table.shape[0])
            x = table[(ids - lo).clamp(0, table.shape[0] - 1)]
            return self.all_reduce(x * inside[..., None].to(x.dtype))
        x = table[ids]
        return self.all_gather(x, -1) if table.shape[1] != cols else x

    def vocab_argmax(self, logits, vocab_size: int):
        """argmax over the last dim of the whole row, from this rank's
        column block of it (``logits`` (..., V/m)): pad columns past
        ``vocab_size`` are masked, each rank takes its block's max and its
        first index, and one ``all_gather`` picks the largest, on a tie the
        lowest index, as ``argmax`` over the row does. int64 indices."""
        w = logits.shape[-1]
        lo = self.index * w
        cols = torch.arange(lo, lo + w, device=logits.device)
        lf = logits.float().masked_fill(cols >= vocab_size, float("-inf"))
        idx = lf.argmax(-1)
        best = lf.gather(-1, idx[..., None])[..., 0]
        packed = torch.stack([best.double(), (idx + lo).double()], dim=0)
        both = self.all_gather(packed[None], dim=0)      # (m, 2, ...)
        rank = both[:, 0].argmax(0)                      # first max: lowest
        return both[:, 1].gather(0, rank[None])[0].long()


def remat(fn, *args):
    """``fn(*args)`` under activation checkpointing: nothing of it is kept
    for the backward, which runs it again (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``). ``fn`` draws no random
    numbers, so no RNG state is saved."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)
