"""Carry parameter trees between the JAX package and the port, via numpy.

A JAX param pytree of this repo is a nested dict; its leaves, as numpy
arrays, map one to one onto the port's nested dict of tensors. Key paths
stay identical to ``repro.checkpoint.ckpt._flatten`` (``seg0/p0/mixer/wq``),
including the leading layer-stack axis of the scanned segments.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> {"a/b/c": leaf}, in sorted key order (as jax flattens
    dicts)."""
    out = {}
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def from_numpy(tree, device=None) -> dict:
    """Nested dict of numpy arrays (a JAX pytree after ``np.asarray``) ->
    nested dict of tensors on ``device`` (default cuda)."""
    dev = resolve_device(device)
    return map_tree(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(dev), tree)


def to_numpy(tree) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays on the host."""
    return map_tree(lambda t: t.detach().cpu().numpy(), tree)
