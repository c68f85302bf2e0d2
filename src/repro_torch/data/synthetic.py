"""Deterministic synthetic vision data (``repro.data.synthetic``).

numpy makes every array, with the same generators and seeds as the JAX
package, so both packages see bit-identical images; they are returned as
torch tensors on the requested device. Vision only: the LM and enc-dec
streams are not ported yet.

Images are class prototypes plus structured (low-rank) noise, so models
develop the anisotropic activations CORP exploits (paper App. A).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import resolve_device


@functools.lru_cache(maxsize=8)
def _prototypes(n_classes: int, img: int, seed: int):
    rng = np.random.RandomState(seed + 7)
    protos = rng.randn(n_classes, img, img, 3).astype(np.float32)
    # smooth the prototypes (low-frequency structure)
    for _ in range(2):
        protos = 0.25 * (np.roll(protos, 1, 1) + np.roll(protos, -1, 1)
                         + np.roll(protos, 1, 2) + np.roll(protos, -1, 2))
    basis = rng.randn(8, img, img, 3).astype(np.float32) * 0.5
    return protos, basis


def vit_batch(step: int, *, batch: int, img: int, n_classes: int,
              seed: int = 0, shard: int = 0, nshards: int = 1,
              noise: float = 0.6, iid_noise: float = 0.1, device=None):
    """{'images': (b, img, img, 3) float32, 'labels': (b,)} on ``device``."""
    dev = resolve_device(device)
    protos, basis = _prototypes(n_classes, img, seed)
    b = batch // nshards
    rng = np.random.RandomState(
        ((seed * 999_983 + step) * 1009 + shard + 1) % (2**31 - 1))
    labels = rng.randint(0, n_classes, size=b)
    coef = rng.randn(b, basis.shape[0]).astype(np.float32)
    x = protos[labels] + noise * np.einsum("bk,khwc->bhwc", coef, basis)
    x = x + iid_noise * rng.randn(b, img, img, 3).astype(np.float32)
    return {"images": torch.from_numpy(x).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def calib_stream(cfg, *, n_samples: int, batch: int, seed: int = 1234,
                 device=None):
    """Zero-arg-callable factory: a fresh finite iterator of unlabeled
    calibration batches per call (CORP traverses the stream twice)."""
    if cfg.family != "vit":
        raise NotImplementedError(
            f"calibration stream of family {cfg.family!r} is not ported; "
            f"see repro.data.synthetic.calib_stream")
    dev = resolve_device(device)
    steps = max(1, n_samples // batch)

    def make():
        for i in range(steps):
            b = vit_batch(10_000 + i, batch=batch, img=cfg.img_size,
                          n_classes=max(cfg.n_classes, 2), seed=seed,
                          device=dev)
            yield {"images": b["images"]}
    return make
