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
(``repro_torch.distrib.fault.CalibrationCheckpointer``). Single device:
``mesh=`` is not ported and raises.
"""
from __future__ import annotations

import hashlib
import itertools
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core import stats as stats_mod
from repro_torch.core.units import Unit
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

    Attributes:
      fingerprint: hash of what this engine accumulates (phase, streaming
        dtype, units, the pass-2 plan and the candidate sets), the recipe
        of the JAX engine without its mesh part. Stored with every
        statistics checkpoint, so a checkpoint of another configuration is
        never resumed.
    """

    def __init__(self, model, units: List[Unit], *, phase=1,
                 plan: Optional[Dict] = None,
                 spec_plan: Optional[Dict] = None, mesh=None,
                 stats_dtype="float32", expert_moments: bool = False):
        if phase not in (1, 2, "1+2"):
            raise ValueError(f"phase {phase!r}; need 1, 2 or '1+2'")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded calibration is not ported; see "
                "repro.core.calibrate.CalibrationEngine(mesh=)")
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
        self._device_plans = None
        self._acc = None            # the running sums of ``run``
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
        result (``stats._p2_attn``, ``stats.pass1_reduce``)."""
        taps = {}
        with model_common.tap_dtype(self.stats_dtype), \
                model_common.expert_taps(self.expert_moments):
            self.model.apply(params, batch, taps=taps)
        if self.phase == 1:
            return stats_mod.pass1_reduce(taps, self.units, self._acc)
        plan, spec_plan = self._plans_on(next(iter(taps.values())).device)
        if self.phase == 2:
            return stats_mod.pass2_reduce(taps, self.units, plan, self._acc)
        return {"p1": stats_mod.pass1_reduce(
                    taps, self.units,
                    None if self._acc is None else self._acc["p1"]),
                "p2spec": stats_mod.spec_pass2_reduce(taps, self.units,
                                                      spec_plan)}

    @torch.no_grad()
    def run(self, params, batches: Iterable, *, checkpointer=None,
            fail_hook: Optional[Callable[[int], None]] = None) -> Dict:
        """Stream ``batches`` through the model; returns the summed
        statistics ``{unit.name: {stat: tensor}}`` on the params' device.

        Args:
          checkpointer: optional ``CalibrationCheckpointer``. The newest
            valid checkpoint of this fingerprint is restored, the batches
            it covers are skipped (batches are deterministic by index), the
            accumulator is saved every N batches (a host copy, written in
            the background) and the last save is on disk before ``run``
            returns.
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
        if checkpointer is not None:
            device = next(iter(flatten(params).values())).device
            flat, start = checkpointer.restore(self.fingerprint, device)
            if flat is not None:
                acc = self._unflatten(flat)
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
                if checkpointer is not None:
                    checkpointer.maybe_save(acc, i + 1, self.fingerprint)
        finally:
            self._acc = None
        if acc is None:
            raise ValueError("every calibration batch failed")
        if checkpointer is not None:
            checkpointer.finish()
        return acc


def run_pass(model, units: List[Unit], params, batches: Iterable, *,
             phase=1, plan: Optional[Dict] = None, checkpointer=None,
             mesh=None, stats_dtype="float32") -> Dict:
    """One-call convenience wrapper: build an engine and run one pass."""
    eng = CalibrationEngine(model, units, phase=phase, plan=plan, mesh=mesh,
                            stats_dtype=stats_dtype)
    return eng.run(params, batches, checkpointer=checkpointer)
