"""Shared inputs of the port's parity tests (tests/test_torch_*.py): the
same numpy-made weights and images go to the JAX package and to the port."""
from __future__ import annotations

import jax
import numpy as np

from repro.models import build_model as jax_build
from repro_torch import configs as pt_configs


def jax_params(cfg, seed=0):
    """JAX init, every leaf perturbed so biases, norms and cls are not
    trivially zero or one (the folds and norms must see real values)."""
    params = jax_build(cfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def images(cfg, B=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


def port_cfg(cfg):
    """The port's config of a (possibly pruned) reduced DeiT-Base."""
    base = pt_configs.resolve_config("deit-base-reduced")
    return base.replace(d_ff_kept=cfg.d_ff_kept, qk_kept=cfg.qk_kept)
