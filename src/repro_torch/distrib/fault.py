"""Resumable calibration statistics (``repro.distrib.fault``, item 2b).

The engine's accumulator is a tree of linear sums, so any prefix of the
calibration stream is a valid checkpoint: ``CalibrationCheckpointer``
saves it every N batches (atomically, through ``repro_torch.checkpoint``,
on a background thread) and restores the newest valid one
with its batch cursor. Calibration batches are deterministic by index, so
a restarted pass skips the consumed prefix and lands on the same sums.

Under a mesh the checkpoint is gathered on save, as in JAX: the engine
sums its blocks over the batch axes and gathers them over the model axis,
and the mesh's first rank alone writes the full tree; on restore every rank
reads it and keeps its own blocks. The format does not depend on the mesh,
but the engine's fingerprint does, so a checkpoint written under another
mesh is ignored. ``remesh`` builds the largest mesh the live ranks allow.

``run_with_restarts`` is the generic restartable loop (a step that
raises restarts from the newest checkpoint) and ``TolerantAccumulator``
sums linear statistics over batches, dropping a batch whose computation
raises and counting the survivors.
"""
from __future__ import annotations

import json
import logging
import math
import os
from typing import Callable, Iterable, Optional

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_arrays, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.interop import map_tree

log = logging.getLogger("repro_torch.fault")


class CalibrationCheckpointer:
    """Periodic, atomic checkpoints of a calibration-statistics tree.

    ``CalibrationEngine.run(..., checkpointer=)`` calls ``restore`` once,
    ``save`` after every batch that ``due`` names and ``finish`` after the
    last one.

    The engine adds each batch's statistics into its accumulator in place,
    so a save must not hold the live tensors: ``AsyncCheckpointer.save``
    copies them to host memory before it returns, and only the write and
    the rename run in the background (at most one in flight). ``finish``
    waits for that write and re-raises its error.
    """

    def __init__(self, ckpt_dir: str, every: int = 8):
        if every < 1:
            raise ValueError("checkpoint interval must be >= 1 batch")
        self.ckpt_dir = ckpt_dir
        self.every = every
        self._async = AsyncCheckpointer(ckpt_dir)

    def restore(self, fingerprint: str = "", device=None):
        """-> ({key path: tensor on ``device``}, batches it covers), or
        (None, 0) when there is nothing to resume.

        The JAX method fills a template; the port's engine has no
        accumulator before its first batch, so this returns the
        checkpoint's leaves by key path and the engine rebuilds its tree
        from them. ``fingerprint`` (the engine's hash of phase,
        streaming dtype, units and plans) is checked in the manifest before
        any array is read: a checkpoint written for another configuration
        is ignored with a warning, and the pass starts fresh."""
        self.finish()          # never read under our own in-flight save
        last = latest_step(self.ckpt_dir)
        if last is None:
            return None, 0
        man = os.path.join(self.ckpt_dir, f"step_{last:08d}",
                           "manifest.json")
        with open(man) as f:
            saved_fp = json.load(f).get("extra", {}).get("fingerprint", "")
        if fingerprint and saved_fp != fingerprint:
            log.warning("calibration checkpoint in %s was written for a "
                        "different configuration (fingerprint %r != %r); "
                        "ignoring it and starting fresh", self.ckpt_dir,
                        saved_fp, fingerprint)
            return None, 0
        flat, _ = load_arrays(self.ckpt_dir, last, device)
        log.info("resumed calibration stats at batch %d", last)
        return flat, last

    def due(self, n_batches: int) -> bool:
        """Whether the sums of the first ``n_batches`` are to be saved."""
        return n_batches % self.every == 0

    def save(self, acc, n_batches: int, fingerprint: str = ""):
        self._async.save(n_batches, acc, {"n_batches": n_batches,
                                          "fingerprint": fingerprint})


    def finish(self):
        """Block until the save in flight is on disk; re-raises its error."""
        self._async.wait()


def run_with_restarts(make_state, step_fn, *, ckpt_dir: str,
                      total_steps: int, save_every: int,
                      max_restarts: int = 10, save_fn=None):
    """Generic restartable loop (``repro.distrib.fault.run_with_restarts``).

    ``make_state()`` -> a fresh state (a nested dict of tensors);
    ``step_fn(state, step)`` -> state; ``save_fn(state, step)`` defaults to
    ``save_checkpoint`` into ``ckpt_dir``. A step that raises restarts the
    loop from the newest valid checkpoint, at most ``max_restarts`` times;
    the next failure is raised."""
    save_fn = save_fn or (lambda st, s: save_checkpoint(ckpt_dir, s, st))
    restarts = 0
    while True:
        state = make_state()
        start = 0
        last = latest_step(ckpt_dir)
        if last is not None:
            state, _ = restore_checkpoint(ckpt_dir, last, state)
            start = last
            log.info("restored step %d", last)
        try:
            for step in range(start, total_steps):
                state = step_fn(state, step)
                if (step + 1) % save_every == 0 or step + 1 == total_steps:
                    save_fn(state, step + 1)
            return state
        except Exception as e:           # noqa: BLE001 -- restart anything
            restarts += 1
            log.warning("step failed (%s); restart %d/%d", e, restarts,
                        max_restarts)
            if restarts > max_restarts:
                raise


class TolerantAccumulator:
    """Bounded-staleness accumulation of linear statistics
    (``repro.distrib.fault.TolerantAccumulator``).

    ``run`` sums ``step_fn(params, batch)`` over the batches; a batch whose
    computation raises (a lost host, simulated by ``fail_hook(i)``) is
    dropped and counted in ``n_failed``, so the caller reweights by the
    surviving sample count (calibration batches are i.i.d.). Returns the
    sums on the host."""

    def __init__(self, step_fn: Callable, params,
                 fail_hook: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.params = params
        self.fail_hook = fail_hook
        self.total = None
        self.n_ok = 0
        self.n_failed = 0

    def run(self, batches: Iterable):
        from repro_torch.core.stats import tree_add
        for i, batch in enumerate(batches):
            try:
                if self.fail_hook is not None:
                    self.fail_hook(i)     # may raise to simulate failure
                out = self.step_fn(self.params, batch)
            except Exception:             # noqa: BLE001
                self.n_failed += 1
                continue
            self.total = tree_add(self.total, out)
            self.n_ok += 1
        if self.total is None:
            raise RuntimeError("every calibration batch failed")
        return map_tree(lambda t: t.detach().cpu(), self.total)


def remesh(shape_hint=None, axis_names=("data", "model"), *,
           device_type: str = "cuda"):
    """The largest mesh the live ranks support (``repro.distrib.fault
    .remesh``): ``shape_hint`` when the default group has that many ranks,
    else the squarest two-axis factorisation of its size. Every rank calls
    it (``launch.mesh.make_mesh``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    n = dist.get_world_size()
    if shape_hint is not None and math.prod(shape_hint) <= n:
        shape = tuple(shape_hint)
    else:
        a = math.isqrt(n)
        while n % a:
            a -= 1
        shape = (n // a, a)
    return make_mesh(shape, tuple(axis_names)[-len(shape):],
                     device_type=device_type)
