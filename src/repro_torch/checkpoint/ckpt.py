"""Atomic checkpoint writer (``repro.checkpoint.ckpt.save_checkpoint``).

Same layout as the JAX package, so its ``restore_checkpoint`` loads what
the port writes: ``<dir>/step_<n>/arrays.npz`` keyed by the param tree's
``/``-joined key paths, plus ``manifest.json`` (step, sha256 of the npz,
extended dtypes, array count, extra). The step is written to a tmp
directory and renamed into place, so a half-written step never looks
complete.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np

from repro_torch.interop import flatten, to_numpy


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: dict | None = None) -> str:
    """Atomic save of a nested dict of tensors. Returns the final step
    directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = flatten(to_numpy(tree))
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **arrays)
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    manifest = {"step": step, "sha256": digest, "dtypes": {},
                "n_arrays": len(arrays), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final
