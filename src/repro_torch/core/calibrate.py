"""Streaming calibration engine for CORP (``repro.core.calibrate``).

One forward per batch: the model runs once with taps, and every unit's
statistics of the pass are reduced from that forward's taps and added into
an accumulator that stays on the device for the whole pass.

    engine = CalibrationEngine(model, units, phase=1)
    stats  = engine.run(params, calib_batches())            # pass 1
    engine2 = CalibrationEngine(model, units, phase=2, plan=plan)
    p2     = engine2.run(params, calib_batches())           # pass 2

Single device only. The one-traversal phase ``"1+2"``, ``mesh=`` and
``stats_dtype="bfloat16"`` are not ported yet; they raise. Statistics
checkpoints (``run(checkpointer=)`` in the JAX package) are not ported.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core import stats as stats_mod
from repro_torch.core.units import Unit
from repro_torch.models import common as model_common


class CalibrationEngine:
    """Statistics gatherer for one calibration pass.

    Args:
      model: a ``repro_torch.models.Model`` (``apply(params, batch, taps)``).
      units: prunable units whose statistics to gather, all from one forward.
      phase: 1 (MLP moments + attention energies) or 2 (class-1 attention
        ridge inputs; needs ``plan``).
      plan: phase 2 only, ``{unit.name: (keep, prune)}`` index arrays.
    """

    def __init__(self, model, units: List[Unit], *, phase=1,
                 plan: Optional[Dict] = None, mesh=None,
                 stats_dtype="float32"):
        if phase not in (1, 2):
            raise NotImplementedError(
                f"phase {phase!r} is not ported (the one-traversal phase "
                f"'1+2' lives in repro.core.calibrate.CalibrationEngine)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded calibration is not ported; see "
                "repro.core.calibrate.CalibrationEngine(mesh=)")
        if stats_dtype != "float32":
            raise NotImplementedError(
                "bf16 tap streaming is not ported; see repro.core.calibrate"
                ".CalibrationEngine(stats_dtype=)")
        if phase == 2 and plan is None:
            raise ValueError("phase 2 needs a keep/prune plan")
        self.model = model
        self.units = list(units)
        self.phase = phase
        self.plan = plan

    def _device_plan(self, device):
        return {k: tuple(torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                         device=device) for a in v)
                for k, v in self.plan.items()}

    @torch.no_grad()
    def run(self, params, batches: Iterable) -> Dict:
        """Stream ``batches`` through the model; returns the summed
        statistics ``{unit.name: {stat: tensor}}`` on the params' device."""
        acc = None
        plan = None
        for batch in batches:
            taps = {}
            with model_common.tap_dtype(torch.float32):
                self.model.apply(params, batch, taps=taps)
            if self.phase == 1:
                s = stats_mod.pass1_reduce(taps, self.units)
            else:
                if plan is None:
                    dev = next(iter(taps.values())).device
                    plan = self._device_plan(dev)
                s = stats_mod.pass2_reduce(taps, self.units, plan)
            acc = stats_mod.tree_add(acc, s)
        if acc is None:
            raise ValueError("empty calibration stream")
        return acc
