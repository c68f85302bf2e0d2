"""Atomic checkpoints in the JAX package's layout (``repro.checkpoint.ckpt``).

``<dir>/step_<n>/arrays.npz`` keyed by the param tree's ``/``-joined key
paths, plus ``manifest.json`` (step, sha256 of the npz, extended dtypes,
array count, extra). The step is written to a tmp directory and renamed
into place, so a half-written step never looks complete; ``latest_step``
skips steps whose hash does not match. So the JAX package's
``restore_checkpoint`` loads what the port writes, and the port's loads
what ``repro.launch.prune`` writes, bf16 leaves included (stored as raw
uint16 with the true dtype in the manifest).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.interop import flatten, to_numpy

# extended dtype named in the manifest -> (16-bit integer view the npz is
# read through, torch dtype it is reinterpreted as)
_EXTENDED = {"bfloat16": (np.int16, torch.bfloat16)}


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
    manifest = {"step": step, "sha256": _sha256(npz_path), "dtypes": {},
                "n_arrays": len(arrays), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _valid(step_dir: str) -> bool:
    man = os.path.join(step_dir, "manifest.json")
    npz = os.path.join(step_dir, "arrays.npz")
    if not (os.path.exists(man) and os.path.exists(npz)):
        return False
    try:
        with open(man) as f:
            m = json.load(f)
        return _sha256(npz) == m["sha256"]
    except (OSError, ValueError, KeyError):
        return False


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest step with a *valid* checkpoint (corrupt/partial skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                s = int(name.split("_")[1])
            except ValueError:
                continue
            if _valid(os.path.join(ckpt_dir, name)):
                steps.append(s)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any):
    """Restore into the structure, dtypes and devices of ``like`` (a nested
    dict of tensors). Returns (tree, extra).

    Raises ``ValueError`` naming every checkpoint leaf that ``like`` lacks
    (a compensation bias that CORP pruning added, say), rather than drop it
    and restore a different model."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    ext = manifest.get("dtypes", {})
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    unknown = sorted(set(arrays) - set(flatten(like)))
    if unknown:
        raise ValueError(f"{ckpt_dir} step {step}: leaves the template "
                         f"lacks: {', '.join(unknown)}")

    def load(path, leaf):
        a = arrays[path]
        if path in ext:
            if ext[path] not in _EXTENDED:
                raise NotImplementedError(f"{path}: dtype {ext[path]} is not "
                                          f"restorable by the port")
            raw, dt = _EXTENDED[ext[path]]
            t = torch.from_numpy(a.view(raw)).view(dt)
        else:
            t = torch.from_numpy(a)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return _map_paths(load, like), manifest["extra"]


def _map_paths(fn, tree, prefix: str = ""):
    return {k: _map_paths(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}
