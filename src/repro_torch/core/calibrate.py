"""Streaming calibration engine for CORP (``repro.core.calibrate``).

One forward per batch: the model runs once with taps, and every unit's
statistics of the pass are reduced from that forward's taps and added into
an accumulator that stays on the device for the whole pass.

    engine = CalibrationEngine(model, units, phase=1)
    stats  = engine.run(params, calib_batches())            # pass 1
    engine2 = CalibrationEngine(model, units, phase=2, plan=plan)
    p2     = engine2.run(params, calib_batches())           # pass 2

Phase ``"1+2"`` is the one-traversal mode: pass-1 statistics and the
speculative pass-2 sums against fixed candidate keep-sets, from the same
forward. ``stats_dtype="bfloat16"`` streams the taps in bf16 (every sum
stays fp32). ``run(checkpointer=)`` makes a pass resumable
(``repro_torch.distrib.fault.CalibrationCheckpointer``).

``mesh=`` (a ``DeviceMesh`` of ``launch.mesh.make_mesh``, or a
``distrib.sharding.CalibSharding``) shards the pass, every rank running the
engine. At the start of a pass each rank places its blocks of the
parameters on its device (``CalibSharding.place``: ``forward_specs``
blocks, JAX's ``param_specs`` element counts, the tree a sharded serving
rank holds), from a whole tree the caller may keep on the host, and drops
them at the pass's end; a caller that placed them itself (a
``distrib.sharding.RankParams``) keeps them. A rank forwards its share of
each batch's rows tensor-parallel over its blocks
(``models.common.TensorParallel``; routed MoE gathers the batch's rows over
the batch axes and routes them as one device: ``models.mlp._apply_moe_tp``)
and adds their statistics, reduced from its rank-local taps
(``core.stats``), into its blocks of the accumulator, column-sharded over
the model axis by ``stats_specs`` (a dense unit's s2 is F x F/m on each
rank, through ``gram_ops.gram_sharded``). The blocks are summed over the
batch axes once a pass and before each checkpoint save, after which only
the ranks at batch index 0 keep the sums and the others start again from
zeros; ``run`` returns on every rank the statistics gathered over the model
axis, what the engine without a mesh returns.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import stats as stats_mod
from repro_torch.core.units import Unit
from repro_torch.distrib.sharding import as_sharding, check_forward_split
from repro_torch.interop import flatten
from repro_torch.models import common as model_common

STATS_DTYPES = ("float32", "bfloat16")


class CalibrationEngine:
    """Statistics gatherer for one calibration pass.

    Args:
      model: a ``repro_torch.models.Model`` (``apply(params, batch, taps)``).
      units: prunable units whose statistics to gather, all from one forward.
      phase: 1 (MLP moments + attention energies), 2 (class-1 attention
        ridge inputs; needs ``plan``) or ``"1+2"`` (pass 1 plus the
        speculative pass-2 sums; needs ``spec_plan``). The ``"1+2"``
        accumulator is ``{"p1": <pass-1 tree>, "p2spec": <speculative
        tree>}``.
      plan: phase 2 only, ``{unit.name: (keep, prune)}`` index arrays.
      spec_plan: phase ``"1+2"`` only, ``{unit.name: (L, G, c) candidate
        keep-indices}`` (``ranking.candidate_attn``), fixed for the pass.
      stats_dtype: dtype the taps are streamed in, "float32" or "bfloat16"
        (half the bytes into the gram kernels; every statistic still
        accumulates in fp32, so only each tap's rounding differs).
      expert_moments: also reduce the MoE expert-removal moments (``yn``,
        ``ys1``, ``ys2``; ((E+1) D)^2 a layer), which only whole-expert
        pruning reads. Off, the forward does not even record their taps.
      mesh: a ``DeviceMesh`` (its "model" axis splits the columns and the
        forward) or a ``CalibSharding``: the pass runs sharded on its ranks
        (module docstring); a config whose heads or channels do not split
        over the model axis raises ``ValueError``
        (``distrib.sharding.check_forward_split``).

    Attributes:
      fingerprint: hash of what this engine accumulates (phase, streaming
        dtype, units, the pass-2 plan, the candidate sets and, sharded, the
        mesh), the JAX engine's recipe. Stored with every statistics
        checkpoint, so a checkpoint of another configuration or mesh is
        never resumed.
      local_shapes: sharded, after ``run``: ``{key path: shape}`` of this
        rank's accumulator blocks before the gather, and ``local_bytes``
        their bytes.
      param_shapes: sharded, after ``run``: ``{key path: shape}`` of the
        parameter blocks the pass placed on this rank's device, and
        ``param_bytes`` their bytes.
    """

    def __init__(self, model, units: List[Unit], *, phase=1,
                 plan: Optional[Dict] = None,
                 spec_plan: Optional[Dict] = None, mesh=None,
                 stats_dtype="float32", expert_moments: bool = False):
        if phase not in (1, 2, "1+2"):
            raise ValueError(f"phase {phase!r}; need 1, 2 or '1+2'")
        if stats_dtype not in STATS_DTYPES:
            raise ValueError(f"stats_dtype {stats_dtype!r}; need one of "
                             f"{STATS_DTYPES}")
        if phase == 2 and plan is None:
            raise ValueError("phase 2 needs a keep/prune plan")
        if phase == "1+2" and spec_plan is None:
            raise ValueError('phase "1+2" needs a speculative candidate plan')
        self.model = model
        self.units = list(units)
        self.phase = phase
        self.stats_dtype = stats_dtype
        self.expert_moments = expert_moments
        # index arrays as the JAX engine holds them (int32), so the
        # fingerprint hashes the same bytes
        self.plan = None if plan is None else {
            k: tuple(np.asarray(a, np.int32) for a in v)
            for k, v in plan.items()}
        self.spec_plan = None if spec_plan is None else {
            k: np.asarray(v, np.int32) for k, v in spec_plan.items()}
        self.shard = as_sharding(mesh)
        if self.shard is not None:
            check_forward_split(model.cfg, self.shard.model_size)
        self._device_plans = None
        self._acc = None            # the running sums of ``run``
        self._specs = {}            # sharded: the placements of their leaves
        self.local_shapes, self.local_bytes = None, None
        self.param_shapes, self.param_bytes = None, None
        self.fingerprint = self._fingerprint()

    def _fingerprint(self) -> str:
        h = hashlib.sha256()
        h.update(f"phase={self.phase};stats_dtype={self.stats_dtype}"
                 .encode())
        if self.expert_moments:
            h.update(b";expert_moments")
        for u in self.units:
            h.update(f";{u.name}:{u.kind}:{u.attn_class}".encode())
        if self.plan is not None:
            for k in sorted(self.plan):
                h.update(f";plan:{k}".encode())
                for a in self.plan[k]:
                    h.update(a.tobytes())
        if self.spec_plan is not None:
            for k in sorted(self.spec_plan):
                h.update(f";spec:{k}".encode())
                h.update(self.spec_plan[k].tobytes())
        if self.shard is not None:
            h.update(f";mesh={self.shard.axis_names}x{self.shard.shape}"
                     f":{self.shard.model_axis}".encode())
        return h.hexdigest()[:16]

    def _plans_on(self, device):
        """The plans as int64 index tensors on ``device``, made once."""
        if self._device_plans is None:
            def idx(a):
                return torch.as_tensor(a, dtype=torch.int64, device=device)
            self._device_plans = (
                None if self.plan is None else
                {k: tuple(idx(a) for a in v) for k, v in self.plan.items()},
                None if self.spec_plan is None else
                {k: idx(v) for k, v in self.spec_plan.items()})
        return self._device_plans

    def _unflatten(self, flat: Dict) -> Dict:
        """A checkpoint's ``{key path: tensor}`` -> this engine's
        accumulator tree ``[{"p1"|"p2spec":}] {unit.name: {stat: t}}``. A
        unit name holds ``/``; a statistic's name does not."""
        tree = {}
        for path, t in flat.items():
            node = tree
            if self.phase == "1+2":
                head, path = path.split("/", 1)
                node = tree.setdefault(head, {})
            unit, stat = path.rsplit("/", 1)
            node.setdefault(unit, {})[stat] = t
        return tree

    def reduce(self, params, batch) -> Dict:
        """One batch's statistics of this pass, from one forward. Inside
        ``run``, pass 2 adds its class-1 G, and pass 1 every unit's sums,
        into the running accumulator in place and leaves them out of the
        result (``stats._p2_attn``, ``stats.pass1_reduce``). Sharded,
        ``params`` are this rank's blocks (``CalibSharding.place``) and the
        forward of its rows runs tensor-parallel over them."""
        taps, tp = {}, None
        if self.shard is not None:
            tp = self.shard.tensor_parallel(len(next(iter(batch.values()))))
            batch = self.shard.rows(batch)
        with model_common.tap_dtype(self.stats_dtype), \
                model_common.expert_taps(self.expert_moments):
            self.model.apply(params, batch, taps=taps, tp=tp)
        sh, specs = self.shard, self._specs
        if self.phase == 1:
            return stats_mod.pass1_reduce(taps, self.units, self._acc,
                                          shard=sh, specs=specs)
        plan, spec_plan = self._plans_on(next(iter(taps.values())).device)
        if self.phase == 2:
            return stats_mod.pass2_reduce(taps, self.units, plan, self._acc,
                                          shard=sh, specs=specs)
        return {"p1": stats_mod.pass1_reduce(
                    taps, self.units,
                    None if self._acc is None else self._acc["p1"],
                    shard=sh, specs=specs.setdefault("p1", {})),
                "p2spec": stats_mod.spec_pass2_reduce(
                    taps, self.units, spec_plan, shard=sh,
                    specs=specs.setdefault("p2spec", {}))}

    @torch.no_grad()
    def run(self, params, batches: Iterable, *, checkpointer=None,
            fail_hook: Optional[Callable[[int], None]] = None) -> Dict:
        """Stream ``batches`` through the model; returns the summed
        statistics ``{unit.name: {stat: tensor}}`` on the params' device
        (sharded: on the rank's, where its blocks are placed for the pass
        and dropped at its end).

        Args:
          checkpointer: optional ``CalibrationCheckpointer``. The newest
            valid checkpoint of this fingerprint is restored, the batches
            it covers are skipped (batches are deterministic by index), the
            accumulator is saved every N batches (a host copy, written in
            the background) and the last save is on disk before ``run``
            returns. Sharded, the full tree is saved, gathered (``_save``),
            and every rank restores it and keeps its blocks; a checkpoint
            of another mesh has another fingerprint and is ignored.
          fail_hook: optional ``hook(i)`` called before batch ``i``; if it
            raises, the batch is dropped and the pass goes on (statistics
            carry their own sample counts, so a dropped batch only shrinks
            n).
        """
        it = iter(batches)
        try:
            first = next(it)
        except StopIteration:
            raise ValueError("empty calibration stream") from None
        acc, start = None, 0
        self._specs = {}
        if self.shard is None:
            device = next(iter(flatten(params).values())).device
        else:
            params = self.shard.place(params)
            blocks = flatten(params)
            self.param_shapes = {k: tuple(t.shape) for k, t in blocks.items()}
            self.param_bytes = sum(t.numel() * t.element_size()
                                   for t in blocks.values())
            device = self.shard.device
            del blocks
        if checkpointer is not None:
            flat, start = checkpointer.restore(self.fingerprint, device)
            if flat is not None:
                acc = self._unflatten(flat)
                if self.shard is not None:
                    acc = self._own(acc)
            if self.shard is not None:     # all restored before any save
                self._barrier()
        try:
            for i, batch in enumerate(itertools.chain([first], it)):
                if i < start:
                    continue
                if fail_hook is not None:
                    try:
                        fail_hook(i)
                    except Exception:   # noqa: BLE001 -- a lost batch
                        continue
                self._acc = acc
                acc = stats_mod.tree_add(acc, self.reduce(params, batch))
                if checkpointer is not None and checkpointer.due(i + 1):
                    self._save(checkpointer, acc, i + 1)
        finally:
            self._acc = None
            del params          # sharded: the rank's blocks, dropped here
        if acc is None:
            raise ValueError("every calibration batch failed")
        if checkpointer is not None:
            checkpointer.finish()
        if self.shard is not None:
            acc = self._gathered(acc)
            if checkpointer is not None:
                self._barrier()
        return acc

    # -- sharded --------------------------------------------------------------

    def _save(self, checkpointer, acc, n_batches: int):
        """Save the sums of the first ``n_batches``. Sharded: summed over
        the batch axes first; the batch-index-0 ranks keep the sums (the
        others start again from zeros) and gather them over the model
        axis, and the mesh's first rank writes the full tree."""
        sh = self.shard
        if sh is None:
            checkpointer.save(acc, n_batches, self.fingerprint)
            return
        sh.reduce(acc)
        if sh.batch_index != 0:
            for t in flatten(acc).values():
                t.zero_()
            return
        full = sh.gather(acc, self._specs)
        if sh.model_index == 0:
            checkpointer.save(full, n_batches, self.fingerprint)

    def _own(self, full: Dict) -> Dict:
        """A restored full tree -> this rank's blocks, zeros off batch
        index 0 (the sums live on the batch-index-0 ranks)."""
        self._specs = self.shard.specs(full)
        acc = self.shard.take(full, self._specs)
        if self.shard.batch_index != 0:
            for t in flatten(acc).values():
                t.zero_()
        return acc

    def _gathered(self, acc: Dict) -> Dict:
        """The pass's blocks summed over the batch axes and gathered over
        the model axis, on every rank; records ``local_shapes`` and
        ``local_bytes`` first."""
        blocks = flatten(acc)
        self.local_shapes = {k: tuple(t.shape) for k, t in blocks.items()}
        self.local_bytes = sum(t.numel() * t.element_size()
                               for t in blocks.values())
        self.shard.reduce(acc)
        return self.shard.gather(acc, self._specs)

    def _barrier(self):
        """Every rank of the mesh waits for every other: over the model
        axis, then over the batch axes."""
        for group, size in ((self.shard.model_group, self.shard.model_size),
                            (self.shard.batch_group, self.shard.batch_size)):
            if size > 1:
                dist.barrier(group=group)


def run_pass(model, units: List[Unit], params, batches: Iterable, *,
             phase=1, plan: Optional[Dict] = None, checkpointer=None,
             mesh=None, stats_dtype="float32") -> Dict:
    """One-call convenience wrapper: build an engine and run one pass."""
    eng = CalibrationEngine(model, units, phase=phase, plan=plan, mesh=mesh,
                            stats_dtype=stats_dtype)
    return eng.run(params, batches, checkpointer=checkpointer)
