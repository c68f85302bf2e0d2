"""Calibration-statistics sharding (the calibration half of
``repro.distrib.sharding``).

A calibration pass on a mesh splits two ways:

  * rows: each batch rank (the mesh's "pod" and "data" axes) takes its
    ``torch.tensor_split`` share of every batch's leading dim (``rows``).
    Every statistic is a sum over samples, so an uneven split is exact and
    nothing is padded; the true counts come out of the sum. The one layer
    whose output for a row depends on the other rows, routed MoE (an
    expert's capacity is shared by a routing group), gathers the batch's
    rows over the batch axes, routes them as one device does and keeps
    its own (``models.mlp._apply_moe_tp``), so any split is exact.
  * columns: each model rank keeps the block of every statistic leaf's
    trailing dim that ``stats_specs`` shards: no rank holds a full F x F
    second moment.

A rank adds its rows' statistics into its own blocks; ``reduce`` sums them
over the batch axes (once a pass, and before each checkpoint save) and
``gather`` concatenates the model axis' blocks into the full leaves.

The forward of a pass holds only the rank's blocks of the parameters
(``place``: ``forward_specs`` blocks, the tree a sharded serving rank
holds) and runs tensor-parallel over the model axis
(``tensor_parallel``), so its taps are the rank's heads and channels; the
statistics gather them where their blocks need other columns
(``core.stats``).

Parameters have their own rule (``param_specs``, JAX's leaf for leaf) and
the serving forward its variant (``forward_specs``: the head-parallel
forward splits a few leaves on another dim, with as many elements a rank);
``shard_params`` cuts a rank's blocks by either. A spec is a tuple with one
entry a dim: ``None``, an axis name, or a tuple of axis names, as a JAX
``PartitionSpec`` reads. ``batch_specs`` places a batch's leading dim.
``activation_policy``, ``constrain`` and ``constrain_qkv`` are GSPMD layout
hints and are not carried over: the port's tensor-parallel forward keeps
the residual replicated over the model axis.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.interop import map_tree

# Stat leaves that stay replicated: bookkeeping whose size never grows with
# the unit width (sample counts, pruned-tail energies, the one-traversal
# engine's per-group Frobenius totals).
_REPLICATED_STATS = frozenset({"n", "t2", "t2_tot"})


def _sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a dict, a ``CalibSharding``/``ServeSharding``
    (anything with ``sizes``) or a ``DeviceMesh``, in axis order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "sizes"):
        return dict(mesh.sizes)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def splits(width: int, model_size: int) -> bool:
    """The placement rule's one test: a trailing dim of ``width`` is
    sharded over a ``model_size``-way model axis when the axis has more
    than one rank and divides it; any other width stays replicated."""
    return model_size > 1 and width >= model_size and width % model_size == 0


def stats_specs(stats, mesh, *, model_axis: str = "model"):
    """Placement of every leaf of a calibration-statistics tree, with JAX's
    rule: a leaf whose trailing dim divides the model axis' size is sharded
    on that dim, ``(model_axis, dim)``; ``None`` keeps it replicated: the
    counts and tails ``n``, ``t2``, ``t2_tot``, scalars and widths that do
    not divide. Leading stack, expert and group dims are never sharded.

    Args:
      stats: nested dict whose leaves have a ``.shape`` (tensors, arrays)
        or are shape tuples; the innermost key names the leaf.
      mesh: a ``DeviceMesh``, a ``CalibSharding`` or a plain ``{axis:
        size}`` dict (the rule needs no ranks).

    >>> tree = {"blk/mlp": {"s2": (3, 8, 8), "s1": (3, 8), "n": (3,)}}
    >>> stats_specs(tree, {"data": 2, "model": 4})["blk/mlp"]
    {'s2': ('model', 2), 's1': ('model', 1), 'n': None}
    >>> stats_specs(tree, {"data": 2, "model": 3})["blk/mlp"]["s2"] is None
    True
    """
    m = _sizes(mesh).get(model_axis, 1)

    def spec(name, leaf):
        shape = tuple(getattr(leaf, "shape", leaf))
        if not shape or name in _REPLICATED_STATS \
                or not splits(shape[-1], m):
            return None
        return (model_axis, len(shape) - 1)

    return {k: stats_specs(v, mesh, model_axis=model_axis)
            if isinstance(v, dict) else spec(k, v) for k, v in stats.items()}


def _axis_group(mesh, axes: Tuple[str, ...], backend=None):
    """The process group of the ranks that differ only along ``axes``
    (one a combination of the other coordinates), and this rank's linear
    index along them. Every rank of the default group creates every group,
    in one order, as ``dist.new_group`` requires; ``backend`` (default: the
    default group's) is e.g. ``"gloo"`` for a group of host tensors."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    rest = [i for i, a in enumerate(names) if a not in axes]
    along = [names.index(a) for a in axes]
    rows = ranks.permute(rest + along).reshape(
        -1, math.prod(ranks.shape[i] for i in along))
    me, mine = dist.get_rank(), (None, 0)
    for row in rows.tolist():
        group = dist.new_group(row, backend=backend)
        if me in row:
            mine = (group, row.index(me))
    return mine


class CalibSharding:
    """How a calibration pass is laid out on a mesh
    (``repro.distrib.sharding.CalibSharding``).

    mesh: the ``DeviceMesh`` the ranks run on (``launch.mesh.make_mesh``).
    model_axis: the axis whose ranks split every statistic's columns.
    batch_axes: the axes whose ranks split every batch's rows.

    Beyond JAX's fields it holds this rank's coordinates, its device (the
    current CUDA device for a CUDA mesh, else the CPU) and the process
    groups of the model axis and of the batch axes together. Building it is
    a collective call of every rank of the default group; a rank outside
    the mesh then raises.
    """

    def __init__(self, mesh, model_axis: str = "model",
                 batch_axes: Tuple[str, ...] = ("pod", "data")):
        self.mesh = mesh
        self.model_axis = model_axis
        self.batch_axes = tuple(batch_axes)
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = tuple(mesh.mesh.shape)
        self.model_group, self.model_index = _axis_group(
            mesh, (model_axis,) if model_axis in self.axis_names else ())
        self.batch_group, self.batch_index = _axis_group(
            mesh, self.present_batch_axes)
        if mesh.get_coordinate() is None:
            raise ValueError(f"rank {dist.get_rank()} lies outside the "
                             f"{self.shape} mesh")
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
        self._tp = None
        self.param_bytes = None

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def model_size(self) -> int:
        return self.sizes.get(self.model_axis, 1)

    @property
    def present_batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.batch_axes if a in self.sizes)

    @property
    def batch_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.present_batch_axes)

    def splits(self, width: int) -> bool:
        """Whether ``stats_specs`` shards a trailing dim of ``width``."""
        return splits(width, self.model_size)

    def block(self, width: int) -> Tuple[int, int]:
        """This rank's column block [lo, hi) of a sharded trailing dim;
        raises for a width that ``splits`` keeps replicated."""
        if not self.splits(width):
            raise ValueError(f"width {width} is not sharded over the "
                             f"{self.model_size}-way {self.model_axis!r} "
                             f"axis")
        step = width // self.model_size
        return self.model_index * step, (self.model_index + 1) * step

    def row_range(self, n: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a batch of n: its
        ``torch.tensor_split`` share (the first n % size shares one row
        longer)."""
        q, r = divmod(n, self.batch_size)
        i = self.batch_index
        lo = i * q + min(i, r)
        return lo, lo + q + (i < r)

    def rows(self, batch: Dict) -> Dict:
        """This rank's share (``row_range``) of every batch leaf's leading
        dim."""
        if self.batch_size == 1:
            return batch
        lo, hi = self.row_range(len(next(iter(batch.values()))))
        return {k: v[lo:hi] for k, v in batch.items()}

    def tensor_parallel(self, n_rows: int | None = None):
        """This rank's ``models.common.TensorParallel`` over the model
        group, made once, whose ``rows`` is the batch group's (None with
        one batch rank); given ``n_rows``, the ranks' shares of a batch of
        that many rows go into its ``counts``. The forward of a pass runs
        on it."""
        from repro_torch.models.common import TensorParallel
        if self._tp is None:
            self._tp = TensorParallel(self.model_group, self.model_index,
                                      self.model_size)
            if self.batch_size > 1:
                self._tp.rows = TensorParallel(
                    self.batch_group, self.batch_index, self.batch_size)
        if n_rows is not None and self._tp.rows is not None:
            q, r = divmod(n_rows, self.batch_size)
            self._tp.rows.counts = [q + (i < r)
                                    for i in range(self.batch_size)]
        return self._tp

    def place(self, params):
        """This rank's blocks of a whole parameter tree (on the host or the
        card) by ``forward_specs``, on this rank's device, as
        ``RankParams``: the blocks a sharded serving rank holds
        (``shard_params``), each copied from its view of the whole leaf
        into one buffer there, each leaf a view of it at a 256-byte aligned
        offset, so that a pass allocates its parameters once and frees them
        at once, and the host holds no copy of the blocks beside the tree.
        Their bytes go into ``param_bytes``. ``RankParams`` are returned as
        they are."""
        if isinstance(params, RankParams):
            return params
        specs = forward_specs(params, self.sizes)
        blocks = shard_params(params, specs, self.mesh, dist.get_rank(),
                              copy=False)
        leaves = list(_leaves(blocks))
        nbytes = [t.numel() * t.element_size() for t in leaves]
        buf = torch.empty(sum(-(-n // 256) * 256 for n in nbytes),
                          dtype=torch.uint8, device=self.device)
        views, at = [], 0
        for t, n in zip(leaves, nbytes):
            views.append(buf[at:at + n].view(t.dtype).view(t.shape))
            views[-1].copy_(t)
            at += -(-n // 256) * 256
        self.param_bytes = sum(nbytes)
        views = iter(views)     # map_tree walks the tree as _leaves does
        return RankParams(map_tree(lambda t: next(views), blocks), specs)

    def specs(self, stats):
        return stats_specs(stats, self.sizes, model_axis=self.model_axis)

    def take(self, stats, specs):
        """Full-width leaves -> this rank's blocks (contiguous copies, so
        the full leaves are freed) by ``specs``."""
        def one(t, spec):
            if spec is None:
                return t
            lo, hi = self.block(t.shape[-1])
            return t[..., lo:hi].contiguous()
        return {k: self.take(v, specs[k]) if isinstance(v, dict)
                else one(v, specs[k]) for k, v in stats.items()}

    def reduce(self, stats) -> None:
        """Sum every leaf over the batch axes, in place, on every rank. A
        collective reads a tensor's storage as contiguous, so a strided
        leaf is reduced in a contiguous copy and copied back."""
        if self.batch_size == 1:
            return
        for t in _leaves(stats):
            buf = t.contiguous()
            dist.all_reduce(buf, group=self.batch_group)
            if buf is not t:
                t.copy_(buf)

    def gather(self, stats, specs):
        """This rank's blocks -> the full leaves, gathered over the model
        axis on every rank of this rank's model group."""
        m = self.model_size

        def one(t, spec):
            if spec is None or m == 1:
                return t
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(m)]
            dist.all_gather(parts, t, group=self.model_group)
            return torch.cat(parts, dim=-1)
        return {k: self.gather(v, specs[k]) if isinstance(v, dict)
                else one(v, specs[k]) for k, v in stats.items()}


class RankParams(dict):
    """A rank's blocks of a parameter tree (``CalibSharding.place``,
    ``serve.sharding.ServeSharding.take_params``), with their ``specs``
    (``forward_specs`` of the whole tree), which a sharded calibration
    engine and a sharded serving engine take as they are: a caller that
    cannot hold every rank's whole tree at once cuts its blocks one rank at
    a time."""

    def __init__(self, blocks, specs):
        super().__init__(blocks)
        self.specs = specs


def as_sharding(mesh):
    """``None``, a ``CalibSharding`` as it is, or a ``DeviceMesh`` -> its
    ``CalibSharding`` (a collective call: every rank builds it)."""
    return mesh if mesh is None or isinstance(mesh, CalibSharding) \
        else CalibSharding(mesh)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# parameter placement
# ---------------------------------------------------------------------------

def _divisible(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _spec_for(path: str, shape, model_size: int, fsdp_axes, fsdp_size: int,
              scanned: bool):
    """The spec of one parameter leaf, with JAX's rule and priority: the
    expert axis, then the head axis, then the wider dim of a linear (the
    other one if it does not divide), then the vocab dim of ``embed`` and
    ``head``; a router and a vector stay replicated, a leading scan axis
    is never sharded, and a dim is never padded. With FSDP the first other
    dim of a >= 2-D leaf that divides goes over ``fsdp_axes``."""
    dims = list(shape)
    off = 1 if scanned else 0
    body = dims[off:]
    spec = [None] * len(dims)
    leaf = path.rsplit("/", 1)[-1]

    model_dim = None
    if leaf in ("wg", "wu", "wd") and len(body) == 3:        # MoE (E, D, F)
        if _divisible(body[0], model_size):
            model_dim = 0
    elif leaf in ("wq", "wk", "wv") and len(body) == 3:      # (D, H, dq)
        if _divisible(body[1], model_size):
            model_dim = 1
        elif _divisible(body[0], model_size):
            model_dim = 0
    elif leaf == "wo" and len(body) == 3:                    # (H, dv, D)
        if _divisible(body[0], model_size):
            model_dim = 0
        elif _divisible(body[2], model_size):
            model_dim = 2
    elif leaf in ("w_uq_nope", "w_uq_rope", "w_uk_nope", "w_uv") \
            and len(body) == 3:                              # (r, H, d)
        if _divisible(body[1], model_size):
            model_dim = 1
    elif leaf in ("embed", "head") and len(body) == 2:
        vdim = 0 if body[0] >= body[1] else 1
        if _divisible(body[vdim], model_size):
            model_dim = vdim
    elif leaf == "router":
        model_dim = None
    elif len(body) == 2:
        cand = 0 if body[0] >= body[1] else 1
        if _divisible(body[cand], model_size):
            model_dim = cand
        elif _divisible(body[1 - cand], model_size):
            model_dim = 1 - cand

    if model_dim is not None:
        spec[off + model_dim] = "model"
    if fsdp_axes and fsdp_size > 1:
        for i, d in enumerate(body):
            if spec[off + i] is None and len(body) >= 2 \
                    and _divisible(d, fsdp_size):
                spec[off + i] = fsdp_axes if len(fsdp_axes) > 1 \
                    else fsdp_axes[0]
                break
    return tuple(spec)


def _shape(leaf):
    return tuple(getattr(leaf, "shape", leaf))


def _scanned(path: str) -> bool:
    """A leaf of a scanned segment (``seg<i>/p<j>/...``): its first dim is
    the layer stack."""
    return "/p" in path and any(seg.startswith("p") and seg[1:].isdigit()
                                for seg in path.split("/"))


def _map_paths(fn, tree, prefix=""):
    return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
            if isinstance(v, dict)
            else fn(f"{prefix}/{k}" if prefix else str(k), v)
            for k, v in tree.items()}


def param_specs(params, mesh, *, fsdp: bool = False):
    """Specs of a parameter tree (``repro.distrib.sharding.param_specs``):
    a nested dict of spec tuples, one a leaf.

    Args:
      params: nested dict whose leaves have a ``.shape`` or are shape
        tuples (only shapes are read).
      mesh: a ``DeviceMesh``, a ``CalibSharding``/``ServeSharding`` or a
        plain ``{axis: size}`` dict; the sizes gate divisibility.
      fsdp: also shard one remaining dim of every >= 2-D leaf over
        ("pod", "data") (ZeRO-3).

    >>> specs = param_specs({"embed": (504, 64), "ln": {"scale": (64,)},
    ...                      "seg0": {"p0": {"mixer": {"wq": (2, 64, 4, 16)},
    ...                                      "mlp": {"wd": (2, 256, 64)}}}},
    ...                     {"data": 2, "model": 2})
    >>> specs["embed"], specs["ln"]["scale"]
    (('model', None), (None,))
    >>> specs["seg0"]["p0"]["mixer"]["wq"], specs["seg0"]["p0"]["mlp"]["wd"]
    ((None, None, 'model', None), (None, 'model', None))
    """
    sizes = _sizes(mesh)
    model_size = sizes.get("model", 1)
    fsdp_axes = tuple(a for a in ("pod", "data") if a in sizes) if fsdp \
        else ()
    fsdp_size = math.prod(sizes[a] for a in fsdp_axes) if fsdp_axes else 1
    return _map_paths(lambda path, leaf: _spec_for(
        path, _shape(leaf), model_size, fsdp_axes, fsdp_size,
        _scanned(path)), params)


# leaves the head-parallel forward splits on their head (first) dim: the
# per-head biases, rope tables and qk-norm scales (H, d), and RWKV's bonus
# u (H, N); JAX's generic rule splits the wider trailing dim
_HEAD_DIM_LEAVES = frozenset({"bq", "bk", "bv", "rope_inv_q", "rope_inv_k",
                              "q_scale", "k_scale", "u"})
# RWKV's square projections of the time mix (a dict with ``w_lora_a``),
# r, k, v, g, which the forward splits on their output dim (columns: its
# heads' channels); JAX splits the input dim
_RWKV_TIME_COLS = frozenset({"wr", "wk", "wv", "wg"})
# the Mamba mixer's 2-D leaves (a dict with ``in_proj`` and ``out_proj``):
# the dim of its inner channels, which the forward splits; JAX splits the
# wider dim, D in a pruned mixer whose kept channels are few enough
_MAMBA_CHANNEL_DIM = {"in_proj": 1, "conv_w": 1, "dt_proj": 1, "a_log": 0,
                      "x_proj": 0, "out_proj": 0}
# leaves whose last dim holds two equal halves, each indexed by the same
# channels: Mamba's in_proj (D, 2 d_inner) = (x | z). A split of that dim
# takes the same block of each half (``block_of(paired=True)``)
PAIRED_LEAVES = frozenset({"in_proj"})


def _forward_dim(name: str, body, tree):
    """The dim of a leaf's body (its shape past a scan axis) that the
    tensor-parallel forward splits where JAX's rule may take another, or
    None for JAX's rule."""
    if len(body) != 2:
        return None
    if name in _HEAD_DIM_LEAVES:
        return 0
    if "w_lora_a" in tree and name in _RWKV_TIME_COLS \
            and body[0] == body[1]:
        return 1
    if name in ("wg", "wu", "wd") and "wu" in tree and "wd" in tree:
        # a dense MLP (the shared expert too): Megatron's columns of F in,
        # rows of F out; JAX splits the wider dim, D where F < D
        return 0 if name == "wd" else 1
    if name == "bd_moe":
        return 0        # (E, D): the experts' block; JAX splits the wider D
    if name in _MAMBA_CHANNEL_DIM and "in_proj" in tree \
            and "out_proj" in tree:
        return _MAMBA_CHANNEL_DIM[name]
    return None


def forward_specs(params, mesh):
    """``param_specs`` with the tensor-parallel forward's splits
    (``models.common.TensorParallel``): the leaves of ``_HEAD_DIM_LEAVES``
    on their head dim, the RWKV time mix's square ``wr``, ``wk``, ``wv``,
    ``wg`` on their output dim, a dense MLP's ``wg``, ``wu`` on their
    columns and ``wd`` on its rows (the hidden dim F), MoE's ``bd_moe``
    (E, D) on its experts, and the Mamba mixer's 2-D leaves on their inner
    channels (``in_proj``'s in paired halves, ``shard_params``). Each such
    leaf keeps the element count of JAX's block, since JAX splits its
    other dim and both divide the model axis; a leaf whose dim does not
    divide keeps JAX's spec."""
    sizes = _sizes(mesh)
    m = sizes.get("model", 1)
    specs = param_specs(params, sizes)

    def walk(tree, sp, path):
        out = {}
        for k, v in tree.items():
            p = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                out[k] = walk(v, sp[k], p)
                continue
            shape = _shape(v)
            off = 1 if _scanned(p) else 0
            body = shape[off:]
            dim = _forward_dim(k, body, tree)
            if m > 1 and dim is not None and _divisible(body[dim], m):
                spec = [None] * len(shape)
                spec[off + dim] = "model"
                out[k] = tuple(spec)
            else:
                out[k] = sp[k]
        return out

    return walk(params, specs, "")


def check_forward_split(cfg, model_size: int) -> None:
    """Refuse a config whose heads or channels the tensor-parallel forward
    (sharded calibration and sharded serving) cannot split over a
    ``model_size``-way model axis: each split dim must divide it, or
    ``forward_specs`` keeps JAX's spec on another dim and the rank's blocks
    do not fit the forward (routed experts that do not divide are kept
    whole by JAX's rule, while the forward splits experts, never their
    channels). Raises ``ValueError`` naming every such dim, except where
    the only one is fewer kv heads than ranks (e.g. a reduced config's one
    kv head on a 2-way axis): the ranks sharing a kv head would each need
    a copy of it (kv-head replication, Megatron's rule), which the port
    does not do yet, so that raises ``NotImplementedError``."""
    if model_size <= 1:
        return
    dims = {}
    kinds = set(cfg.layer_kinds)
    if cfg.family != "lm" or kinds & {"attn", "swa"}:
        dims["n_heads"] = cfg.n_heads
        if cfg.mla is None:
            dims["n_kv_heads"] = cfg.n_kv_heads
    if "rwkv" in kinds:
        dims["rwkv heads"] = cfg.d_model // cfg.rwkv.head_dim
        dims["d_ff"] = cfg.eff_d_ff
    if "mamba" in kinds:
        dims["d_inner"] = cfg.eff_d_inner
    moe = [cfg.layer_is_moe(i) for i in range(cfg.n_layers)] \
        if cfg.family == "lm" else [False]
    if not all(moe) and "rwkv" not in kinds:
        dims["d_ff"] = cfg.eff_dense_d_ff or cfg.eff_d_ff
    if any(moe):
        dims["experts"] = cfg.eff_num_experts
        if cfg.moe.num_shared:
            dims["shared d_ff"] = cfg.moe.num_shared * cfg.eff_d_expert
    bad = {k: v for k, v in dims.items() if v % model_size}
    if list(bad) == ["n_kv_heads"] and model_size % bad["n_kv_heads"] == 0:
        raise NotImplementedError(
            f"{cfg.name}: {bad['n_kv_heads']} kv heads over a "
            f"{model_size}-way model axis need kv-head replication, which "
            f"the tensor-parallel forward does not do yet")
    if bad:
        raise ValueError(
            f"{cfg.name}: {', '.join(f'{k} {v}' for k, v in bad.items())} "
            f"do not split over a {model_size}-way model axis; the "
            f"tensor-parallel forward splits them")


def batch_specs(batch, mesh):
    """The leading (batch) dim of every leaf over ("pod", "data") where
    their size divides it; otherwise replicated, never padded."""
    sizes = _sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    n = math.prod(sizes[a] for a in axes) if axes else 1

    def one(leaf):
        shape = _shape(leaf)
        spec = [None] * len(shape)
        if shape and axes and shape[0] % n == 0:
            spec[0] = axes if len(axes) > 1 else axes[0]
        return tuple(spec)
    return {k: batch_specs(v, sizes) if isinstance(v, dict) else one(v)
            for k, v in batch.items()}


def coordinates(mesh, rank: int) -> Dict[str, int]:
    """``{axis: index}`` of global ``rank`` on a ``DeviceMesh`` (its rank
    tensor) or, for a ``{axis: size}`` dict, row-major over the axes in
    their order."""
    if isinstance(mesh, dict) or hasattr(mesh, "sizes"):
        sizes = _sizes(mesh)
        idx = np.unravel_index(rank, tuple(sizes.values()))
        return {a: int(i) for a, i in zip(sizes, idx)}
    pos = (mesh.mesh == rank).nonzero()
    if pos.numel() == 0:
        raise ValueError(f"rank {rank} lies outside the mesh")
    return {a: int(i) for a, i in zip(mesh.mesh_dim_names, pos[0].tolist())}


def block_of(leaf, spec, sizes: Dict[str, int], coords: Dict[str, int],
             paired: bool = False):
    """A rank's block of one leaf (a tensor or numpy array) by its spec: on
    each sharded dim the ``1/n`` slice at the rank's linear index over the
    dim's axes (row-major in the spec's order). A view; a spec of
    ``None`` entries returns the leaf itself. ``paired`` (a leaf of
    ``PAIRED_LEAVES``): a split last dim is two halves, and the block is
    the rank's slice of the first half followed by the same slice of the
    second (a new array, of the element count of a plain split)."""
    index, halves = [], None
    for d, entry in enumerate(spec):
        if entry is None:
            index.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes.get(a, 1), i * sizes.get(a, 1) + coords.get(a, 0)
        if paired and d == len(spec) - 1:
            half = leaf.shape[d] // 2
            step = half // n
            halves = (i * step, half + i * step, step)
            index.append(slice(None))
            continue
        step = leaf.shape[d] // n
        index.append(slice(i * step, (i + 1) * step))
    if not any(e is not None for e in spec):
        return leaf
    out = leaf[tuple(index)]
    if halves is None:
        return out
    a, b, step = halves
    parts = (out[..., a:a + step], out[..., b:b + step])
    return torch.cat(parts, dim=-1) if isinstance(out, torch.Tensor) \
        else np.concatenate(parts, axis=-1)


def shard_params(params, specs, mesh, rank: int, copy: bool = True):
    """Rank ``rank``'s blocks of a parameter tree by ``specs``
    (``param_specs`` or ``forward_specs``): a sharded leaf becomes a
    contiguous copy of its block (with ``copy=False`` a view of it), a
    replicated one stays the same object; a leaf of ``PAIRED_LEAVES`` is
    cut in paired halves (``block_of``). ``mesh``: a ``DeviceMesh``, a
    sharding object or an ``{axis: size}`` dict."""
    sizes, coords = _sizes(mesh), coordinates(mesh, rank)

    def one(name, leaf, spec):
        out = block_of(leaf, spec, sizes, coords,
                       paired=name in PAIRED_LEAVES)
        if out is leaf or not copy:
            return out
        return out.contiguous() if isinstance(out, torch.Tensor) \
            else np.ascontiguousarray(out)

    def walk(tree, sp):
        return {k: walk(v, sp[k]) if isinstance(v, dict)
                else one(k, v, sp[k]) for k, v in tree.items()}
    return walk(params, specs)
