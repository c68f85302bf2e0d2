"""Mesh sharding of the serving slot cache (``repro.serve.sharding``), and
the ranks of a sharded engine.

The placement rule is JAX's: the slot dim of every slot-cache leaf (the
axis ``cache._infer_batch_axes`` finds) goes over the data axis when it
divides, and each payload leaf goes over the model axis on the dim its
contract parallelises:

  contract    leaf                  model-sharded dim
  ---------   -------------------   ------------------------------
  kv          k / v                 kv heads        (..., S, Hkv, d)
  kv (MLA)    ckv / k_rope          latent dims     (..., T, r)
  recurrent   wkv                   rwkv heads      (..., H, N, N)
  recurrent   ssm                   ssm channels    (..., d_inner, N)
  recurrent   conv / shift          conv channels   (..., K, d_inner)
  (hybrid)    k / v beside them     kv heads        (..., S, Hkv, d)
  encdec      k_mem / v_mem         cross heads     (..., M, H, d)
  (all)       pos / abs_pos         replicated bookkeeping

Dims count from the end of the shape, so a leading layer stack shifts
nothing. A payload dim that does not divide the model axis is never
padded: the config is refused with ``errors.msg("shard_ineligible")``.
``slot_specs`` and ``device_bytes_estimate`` take a plain ``{axis: size}``
dict in place of a mesh, so the rule needs no ranks. A spec is a tuple
with one entry a dim (``None`` or an axis name), as a JAX
``PartitionSpec`` reads.

Where JAX lowers one program over the mesh, the port runs one process a
rank (``launch.mesh.launch``). ``ServeSharding`` holds what a rank needs
to serve its blocks: its coordinates, the model group its forward reduces
over (``TensorParallel``), a host (gloo) group of the data axis that
gathers a decode step's next tokens, and a host control group over which
the lead (the mesh's first rank, which alone runs the scheduler and the
front-end) posts every device operation of the engine before it runs it
(``post``); the other ranks follow them in the same order (``ServeEngine.
follow``). So every rank enters the same collectives in the same order.

The forward's model-axis collectives go through the model group, unless
the mesh's ranks share cards (``shares_card``: CUDA ranks of one host,
more of them than its cards, as four ``gloo`` ranks on one card), where
NCCL cannot run and a process-group collective costs milliseconds: then
they go through shared memory (``distrib.hostcoll``). The data axis has a
``TensorParallel`` of its own (``rows``), on the same transport: routed
MoE gathers a decode step's rows over it (``models.mlp.apply_moe``).
"""
from __future__ import annotations

import math
import platform
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distrib.sharding import (RankParams, _axis_group, _sizes,
                                          block_of, coordinates,
                                          forward_specs, shard_params)
from repro_torch.interop import flatten, map_tree
from repro_torch.launch.mesh import host_ranks
from repro_torch.models.common import TensorParallel
from repro_torch.serve import errors

# Bookkeeping leaves that never shard over the model axis: per-slot valid
# lengths and ring positions, which every rank's decode mask reads whole.
REPLICATED_SLOT_LEAVES = frozenset({"pos", "abs_pos"})

# Payload leaves: the model-axis dim, counted from the end of the shape.
MODEL_DIM_FROM_END = {
    "k": 2, "v": 2,            # attn KV rows   (..., S, Hkv, d)
    "k_mem": 2, "v_mem": 2,    # enc-dec cross  (..., M, H, d)
    "wkv": 3,                  # rwkv6 state    (..., H, N, N)
    "ssm": 2,                  # mamba state    (..., d_inner, N)
    "conv": 1,                 # mamba conv     (..., K, d_inner)
    "shift": 1,                # rwkv shifts    (..., D)
    "ckv": 1,                  # MLA latent     (..., T, rank)
    "k_rope": 1,               # MLA rope keys  (..., T, r_rope)
}


def _unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _shape(leaf):
    return tuple(getattr(leaf, "shape", leaf))


def slot_specs(template, batch_axes, mesh, *, data_axis: str = "data",
               model_axis: str = "model", name: str = "slot-cache"):
    """Specs of a slot-cache tree: a nested dict of spec tuples.

    Args:
      template: the cache tree (tensors, ``meta`` tensors too, or arrays;
        only shapes are read). The innermost key names the leaf and
        chooses the rule (``MODEL_DIM_FROM_END``,
        ``REPLICATED_SLOT_LEAVES``); other leaves stay model-replicated.
      batch_axes: each leaf's slot axis, by path (``SlotCache.batch_axes``)
        or as a nested dict. The slot dim goes over ``data_axis`` when it
        divides that axis' size, so a batch-1 template comes out
        data-replicated.
      mesh: a ``DeviceMesh``, a ``ServeSharding`` or an ``{axis: size}``
        dict.
      name: the config's name for the refusal.

    Raises ``ValueError(errors.msg("shard_ineligible", ...))`` at the first
    payload leaf, in sorted path order as JAX flattens, whose model dim
    does not divide the model axis: all or nothing, never padded.

    >>> tmpl = {"k": (4, 16, 2, 8), "v": (4, 16, 2, 8), "pos": (4,)}
    >>> axes = {"k": 0, "v": 0, "pos": 0}
    >>> sp = slot_specs(tmpl, axes, {"data": 2, "model": 2})
    >>> sp["k"], sp["pos"]
    (('data', None, 'model', None), ('data',))
    >>> slot_specs({"k": (1, 16, 2, 8)}, {"k": 0},
    ...            {"data": 2, "model": 2})["k"]
    (None, None, 'model', None)
    >>> try:
    ...     slot_specs(tmpl, axes, {"model": 4})
    ... except ValueError:
    ...     print("refused")
    refused
    """
    sizes = _sizes(mesh)
    d = sizes.get(data_axis, 1)
    m = sizes.get(model_axis, 1)
    axes = batch_axes if all(not isinstance(v, dict)
                             for v in batch_axes.values()) \
        else flatten(batch_axes)
    out = {}
    for path, leaf in flatten(template).items():
        shape = _shape(leaf)
        slot_ax = axes[path]
        leaf_name = path.rsplit("/", 1)[-1]
        spec = [None] * len(shape)
        if d > 1 and shape[slot_ax] % d == 0:
            spec[slot_ax] = data_axis
        if m > 1 and leaf_name in MODEL_DIM_FROM_END:
            md = len(shape) - MODEL_DIM_FROM_END[leaf_name]
            if md < 0 or md == slot_ax or shape[md] % m:
                raise ValueError(errors.msg("shard_ineligible", name=name,
                                            leaf=leaf_name, m=m))
            spec[md] = model_axis
        out[path] = tuple(spec)
    return _unflatten(out)


def _itemsize(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


def device_bytes_estimate(template, specs, mesh) -> int:
    """Per-device bytes of a sharded cache, from shapes alone: each leaf's
    bytes over the product of the axis sizes its spec shards over (exact,
    since ``slot_specs`` only shards dims that divide).

    >>> tmpl = {"k": torch.zeros((4, 16, 8, 8), device="meta")}
    >>> device_bytes_estimate(tmpl, {"k": ("data", None, "model", None)},
    ...                       {"data": 2, "model": 4})
    2048
    """
    sizes = _sizes(mesh)
    sp = flatten(specs)
    total = 0
    for path, leaf in flatten(template).items():
        nbytes = math.prod(_shape(leaf)) * _itemsize(leaf)
        denom = 1
        for entry in sp[path]:
            if entry is None:
                continue
            group = (entry,) if isinstance(entry, str) else tuple(entry)
            denom *= math.prod(sizes.get(a, 1) for a in group)
        total += nbytes // denom
    return int(total)


def shares_card(mesh) -> bool:
    """Whether the ranks of ``mesh`` share cards: CUDA ranks, every one on
    this host, more of them than its cards, on an x86-64 host (whose store
    order ``distrib.hostcoll`` relies on). A sharded engine's forward then
    reduces through shared memory, else through its model group."""
    world = dist.get_world_size()
    return (mesh.device_type == "cuda" and host_ranks(world) == world
            and world > torch.cuda.device_count()
            and platform.machine() in ("x86_64", "AMD64"))


# device operations the lead posts (ServeEngine._post / follow)
OPS = ("prefill", "walk", "install", "decode", "reset_slot", "reset", "stop")


class ServeSharding:
    """How a serving engine is laid out on a mesh
    (``repro.serve.sharding.ServeSharding``).

    mesh: the ``DeviceMesh`` of the ranks (``launch.mesh.make_mesh``),
      with a ``data`` and a ``model`` axis (either may be absent).
    data_axis: the axis the slot dim shards over.
    model_axis: the axis the payload dims and the forward shard over.

    Building it is a collective call of every rank of the default group
    (it creates the groups). ``lead`` is the mesh's first rank.
    ``transport`` says how the forward's model-axis collectives travel:
    ``"host"`` (shared memory) where the ranks share cards
    (``shares_card``), else ``"group"`` (the model axis' process group,
    gloo or nccl as the ranks were started).
    """

    def __init__(self, mesh, data_axis: str = "data",
                 model_axis: str = "model"):
        self.mesh = mesh
        self.data_axis, self.model_axis = data_axis, model_axis
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = tuple(mesh.mesh.shape)
        extra = {a: s for a, s in self.sizes.items()
                 if a not in (data_axis, model_axis) and s > 1}
        if extra:
            raise ValueError(f"sharded serving takes a {data_axis} x "
                             f"{model_axis} mesh; axes {extra} are not "
                             f"served")
        self.rank = dist.get_rank()
        self.coords = coordinates(mesh, self.rank)
        self.model_group, self.model_index = _axis_group(
            mesh, (model_axis,) if model_axis in self.axis_names else ())
        self.data_group, self.data_index = _axis_group(
            mesh, (data_axis,) if data_axis in self.axis_names else (),
            backend="gloo")
        ranks = mesh.mesh.flatten().tolist()
        self.control = dist.new_group(ranks, backend="gloo")
        self.lead_rank = ranks[0]
        self.lead = self.rank == self.lead_rank
        grid = mesh.mesh.reshape(self.data_size, self.model_size)
        # global rank of each data index' first model rank (its results)
        self.group_leaders = grid[:, 0].tolist()
        self.transport = "host" if len(ranks) > 1 and shares_card(mesh) \
            else "group"
        # the data axis' group for device tensors (the forward's gathers
        # of a decode step's rows), of the default backend
        rows_group = _axis_group(mesh, (data_axis,))[0] \
            if self.data_size > 1 else None
        host = rows_host = None
        if self.transport == "host":
            from repro_torch.distrib.hostcoll import HostCollectives
            if self.model_size > 1:
                host = HostCollectives.for_group(
                    grid[self.data_index].tolist(), self.model_index,
                    self.control)
            if self.data_size > 1:
                rows_host = HostCollectives.for_group(
                    grid[:, self.model_index].tolist(), self.data_index,
                    self.control)
        self.tp = TensorParallel(self.model_group, self.model_index,
                                 self.model_size, host) \
            if len(ranks) > 1 else None
        # the data axis' context: ServeEngine hands it to the forward
        # (``tp.rows``) for a decode step whose slots it splits
        self.rows = TensorParallel(rows_group, self.data_index,
                                   self.data_size, rows_host) \
            if self.data_size > 1 else None

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def data_size(self) -> int:
        return self.sizes.get(self.data_axis, 1)

    @property
    def model_size(self) -> int:
        return self.sizes.get(self.model_axis, 1)

    def take_params(self, params, device=None) -> RankParams:
        """This rank's blocks of a whole parameter tree by
        ``forward_specs`` (contiguous copies of the sharded leaves), moved
        to ``device`` when given: a tree on the host is cut there, so only
        the blocks reach the card."""
        specs = forward_specs(params, self)
        blocks = shard_params(params, specs, self, self.rank)
        if device is not None:
            blocks = map_tree(lambda t: t.to(device), blocks)
        return RankParams(blocks, specs)

    def block(self, tree, specs):
        """This rank's blocks of a tensor tree by ``specs``: a copy of each
        sharded leaf's block (the whole leaf is freed with its tree), the
        replicated leaves as they are."""
        def one(t, spec):
            out = block_of(t, spec, self.sizes, self.coords)
            return t if out is t else out.clone(
                memory_format=torch.contiguous_format)
        return {k: self.block(v, specs[k]) if isinstance(v, dict)
                else one(v, specs[k]) for k, v in tree.items()}

    # -- the lead's control messages ------------------------------------------

    def post(self, op: str, slot: int = -1, a: int = 0, b: int = 0,
             payload=None, floats=None) -> None:
        """Lead: send one device operation to every rank (a header of six
        int64 and, when given, the ``payload``'s int32 values and the
        ``floats``' fp32 values, an enc-dec prefill's frames)."""
        n = 0 if payload is None else int(np.asarray(payload).size)
        nf = 0 if floats is None else int(np.asarray(floats).size)
        head = torch.tensor([OPS.index(op), slot, a, b, n, nf],
                            dtype=torch.int64)
        dist.broadcast(head, self.lead_rank, group=self.control)
        for values, k, dt in ((payload, n, np.int32),
                              (floats, nf, np.float32)):
            if k:
                dist.broadcast(torch.from_numpy(np.ascontiguousarray(
                    values, dt).reshape(-1)), self.lead_rank,
                    group=self.control)

    def receive(self):
        """Follower: the next operation -> (op, slot, a, b, payload or
        None, floats or None), both flat."""
        head = torch.empty(6, dtype=torch.int64)
        dist.broadcast(head, self.lead_rank, group=self.control)
        op, slot, a, b, n, nf = head.tolist()
        out = []
        for k, dt in ((n, torch.int32), (nf, torch.float32)):
            buf = None
            if k:
                buf = torch.empty(k, dtype=dt)
                dist.broadcast(buf, self.lead_rank, group=self.control)
                buf = buf.numpy()
            out.append(buf)
        return (OPS[op], slot, a, b, *out)

    def from_group(self, values, data_index: int):
        """Every rank: the int32 ``values`` that data index ``data_index``'s
        first model rank computed, on the lead (a control broadcast from
        that rank, which every rank enters; none when it is the lead)."""
        src = self.group_leaders[data_index]
        if src == self.lead_rank:
            return values
        buf = torch.from_numpy(np.ascontiguousarray(values, np.int32)) \
            if src == self.rank else torch.empty(1, dtype=torch.int32)
        dist.broadcast(buf, src, group=self.control)
        return buf.numpy() if self.lead else None

    def gather_data(self, values, n: int):
        """Ranks of model index 0: the data axis' blocks of a step's next
        tokens (``n`` each, int32) -> all of them, in data order, on the
        lead (one gather over the data axis); None elsewhere."""
        if self.data_size == 1:
            return values
        if self.model_index != 0:
            return None
        t = torch.from_numpy(np.ascontiguousarray(values, np.int32))
        parts = [torch.empty(n, dtype=torch.int32)
                 for _ in range(self.data_size)] if self.lead else None
        dist.gather(t, parts, dst=self.lead_rank, group=self.data_group)
        return torch.cat(parts).numpy() if self.lead else None

    def gather_all(self, value: int) -> list:
        """Every rank's ``value`` (e.g. its cache bytes), in rank order, on
        every rank."""
        t = torch.tensor([value], dtype=torch.int64)
        parts = [torch.empty(1, dtype=torch.int64)
                 for _ in range(math.prod(self.shape))]
        dist.all_gather(parts, t, group=self.control)
        return [int(p) for p in parts]
