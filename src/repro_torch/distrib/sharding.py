"""Calibration-statistics sharding (the calibration half of
``repro.distrib.sharding``).

A calibration pass on a mesh splits two ways:

  * rows: each batch rank (the mesh's "pod" and "data" axes) takes its
    ``torch.tensor_split`` share of every batch's leading dim (``rows``).
    Every statistic is a sum over samples, so an uneven split is exact and
    nothing is padded; the true counts come out of the sum. The one layer
    whose output for a row depends on the other rows, routed MoE (an
    expert's capacity is shared by a routing group), routes the whole
    batch's groups or raises (``models.mlp._group_tokens``).
  * columns: each model rank keeps the block of every statistic leaf's
    trailing dim that ``stats_specs`` shards: no rank holds a full F x F
    second moment.

A rank adds its rows' statistics into its own blocks; ``reduce`` sums them
over the batch axes (once a pass, and before each checkpoint save) and
``gather`` concatenates the model axis' blocks into the full leaves.
Parameters stay replicated on every rank: placing them by ``param_specs``
needs the tensor-parallel forward, which is not ported (ROADMAP Queue 1
item 2b), and so do ``activation_policy``, ``constrain`` and
``batch_specs`` as placements.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist

# Stat leaves that stay replicated: bookkeeping whose size never grows with
# the unit width (sample counts, pruned-tail energies, the one-traversal
# engine's per-group Frobenius totals).
_REPLICATED_STATS = frozenset({"n", "t2", "t2_tot"})


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, dict):
        return dict(mesh)
    if isinstance(mesh, CalibSharding):
        return mesh.sizes
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


def _axis_group(mesh, axes: Tuple[str, ...]):
    """The process group of the ranks that differ only along ``axes``
    (one a combination of the other coordinates), and this rank's linear
    index along them. Every rank of the default group creates every group,
    in one order, as ``dist.new_group`` requires."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    rest = [i for i, a in enumerate(names) if a not in axes]
    along = [names.index(a) for a in axes]
    rows = ranks.permute(rest + along).reshape(
        -1, math.prod(ranks.shape[i] for i in along))
    me, mine = dist.get_rank(), (None, 0)
    for row in rows.tolist():
        group = dist.new_group(row)
        if me in row:
            mine = (group, row.index(me))
    return mine


class CalibSharding:
    """How a calibration pass is laid out on a mesh
    (``repro.distrib.sharding.CalibSharding``).

    mesh: the ``DeviceMesh`` the ranks run on (``launch.mesh.make_mesh``).
    model_axis: the axis whose ranks split every statistic's columns.
    batch_axes: the axes whose ranks split every batch's rows.

    Beyond JAX's fields it holds this rank's coordinates and the process
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
        """Sum every leaf over the batch axes, in place, on every rank."""
        if self.batch_size == 1:
            return
        for t in _leaves(stats):
            dist.all_reduce(t, group=self.batch_group)

    def gather(self, stats, specs):
        """This rank's blocks -> the full leaves, gathered over the model
        axis on every rank of this rank's model group."""
        m = self.model_size

        def one(t, spec):
            if spec is None or m == 1:
                return t
            parts = [torch.empty_like(t) for _ in range(m)]
            dist.all_gather(parts, t, group=self.model_group)
            return torch.cat(parts, dim=-1)
        return {k: self.gather(v, specs[k]) if isinstance(v, dict)
                else one(v, specs[k]) for k, v in stats.items()}


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
