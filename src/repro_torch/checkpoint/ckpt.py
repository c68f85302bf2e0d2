"""Atomic checkpoints in the JAX package's layout (``repro.checkpoint.ckpt``).

``<dir>/step_<n>/arrays.npz`` keyed by the param tree's ``/``-joined key
paths, plus ``manifest.json`` (step, sha256 of the npz, extended dtypes,
array count, extra). The step is written to a tmp directory and renamed
into place, so a half-written step never looks complete; ``latest_step``
skips steps whose hash does not match. So the JAX package's
``restore_checkpoint`` loads what the port writes, and the port's loads
what ``repro.launch.prune`` writes, bf16 leaves included (stored as raw
uint16 with the true dtype in the manifest). ``AsyncCheckpointer`` writes
from a host copy on a background thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.interop import flatten, map_tree

# extended dtype named in the manifest -> (16-bit integer view the npz is
# read through, torch dtype it is reinterpreted as)
_EXTENDED = {"bfloat16": (np.int16, torch.bfloat16)}


def _stored(t: torch.Tensor):
    """A leaf as the npz stores it: numpy in its own dtype, or a bf16 leaf
    as its raw bits (uint16, as the JAX package writes them) and the
    dtype's name for the manifest."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


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
    stored = {k: _stored(t) for k, t in flatten(tree).items()}
    arrays = {k: a for k, (a, _) in stored.items()}
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **arrays)
    manifest = {"step": step, "sha256": _sha256(npz_path),
                "dtypes": {k: d for k, (_, d) in stored.items() if d},
                "n_arrays": len(arrays), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _sha256(path: str) -> str:
    """The file's sha256, read in 64 MB pieces (a full-width checkpoint
    is tens of GB)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(1 << 26), b""):
            h.update(piece)
    return h.hexdigest()


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


def _read(ckpt_dir: str, step: int):
    """-> ({path: ndarray}, {path: extended dtype}, extra) of one step."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return arrays, manifest.get("dtypes", {}), manifest["extra"]


def _tensor(path: str, a: np.ndarray, ext: dict) -> torch.Tensor:
    if path not in ext:
        return torch.from_numpy(a)
    if ext[path] not in _EXTENDED:
        raise NotImplementedError(f"{path}: dtype {ext[path]} is not "
                                  f"restorable by the port")
    raw, dt = _EXTENDED[ext[path]]
    return torch.from_numpy(a.view(raw)).view(dt)


def restore_checkpoint(ckpt_dir: str, step: int, like: Any,
                       prefix: str = "", zero_if_absent=()):
    """Restore into the structure, dtypes and devices of ``like`` (a nested
    dict of tensors). Returns (tree, extra).

    ``prefix`` restores one subtree: only the leaves whose key path starts
    with it, the prefix taken off (``"0/"`` is the params of the
    ``(params, opt_state)`` tuple that ``repro.launch.train`` saves).
    ``zero_if_absent``: key-path endings (``"mlp/bv_comp"``) of template
    leaves that a checkpoint may lack; such a leaf restores as zeros (a
    compensation bias that a ``--no-compensate`` prune does not write).

    Raises ``ValueError`` naming every checkpoint leaf (under ``prefix``)
    that ``like`` lacks (a compensation bias the template has no slot for,
    say), rather than drop it and restore a different model, and naming
    any other template leaf the checkpoint lacks."""
    arrays, ext, extra = _read(ckpt_dir, step)
    n = len(prefix)
    arrays = {k[n:]: a for k, a in arrays.items() if k.startswith(prefix)}
    ext = {k[n:]: d for k, d in ext.items() if k.startswith(prefix)}
    unknown = sorted(set(arrays) - set(flatten(like)))
    if unknown:
        raise ValueError(f"{ckpt_dir} step {step}: leaves the template "
                         f"lacks: {', '.join(prefix + k for k in unknown)}")

    def load(path, leaf):
        if path not in arrays:
            if any(path.endswith(e) for e in zero_if_absent):
                return torch.zeros_like(leaf)
            raise ValueError(f"{ckpt_dir} step {step}: no leaf "
                             f"{prefix + path}")
        t = _tensor(path, arrays[path], ext)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return _map_paths(load, like), extra


def load_arrays(ckpt_dir: str, step: int, device=None):
    """Template-free restore: ``({key path: tensor}, extra)``, each leaf in
    its stored dtype, on ``device``. For a tree whose shapes the caller
    cannot know before it has data, such as a calibration accumulator; the
    caller rebuilds the nesting (a path does not say it, since a unit name
    holds ``/`` too) and checks the tree's identity
    (``repro_torch.distrib.fault`` checks a fingerprint)."""
    arrays, ext, extra = _read(ckpt_dir, step)
    out = {}
    for path, a in arrays.items():
        t = _tensor(path, a, ext)
        out[path] = t if device is None else t.to(device)
    return out, extra


def _map_paths(fn, tree, prefix: str = ""):
    return {k: _map_paths(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


class AsyncCheckpointer:
    """Writes checkpoints on a background thread, at most one in flight.

    ``save`` copies the tree to host memory before it returns, so the
    caller may go on updating its tensors in place (a calibration
    accumulator is, by the next batch's ``add_``); only the serialisation
    and the atomic rename run in the background. After each save the
    thread removes all but the newest ``keep`` steps. ``wait`` joins the
    save in flight and re-raises the error it hit."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        # a copy even of a CPU tensor, whose .cpu() would be the tensor
        snapshot = map_tree(lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, snapshot, extra)
                self._gc()
            except Exception as e:      # noqa: BLE001 -- raised by wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
