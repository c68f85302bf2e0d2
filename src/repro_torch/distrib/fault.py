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

``run_with_restarts`` and ``TolerantAccumulator`` of the JAX module serve
no path of the port (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import json
import logging
import math
import os

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, load_arrays

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
