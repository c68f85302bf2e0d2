"""Shared inputs of the port's parity tests (tests/test_torch_*.py): the
same numpy-made weights, images and tokens go to the JAX package and to
the port."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np

from repro.configs import get_config, reduced
from repro.models import build_model as jax_build
from repro_torch import configs as pt_configs


def jax_params(cfg, seed=0):
    """JAX init, every leaf perturbed so biases, norms and cls are not
    trivially zero or one (the folds and norms must see real values)."""
    params = jax.jit(jax_build(cfg).init)(jax.random.PRNGKey(seed))
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


def lm_cfgs(pruned=False):
    """qwen2-1.5b-reduced (fp32) in both packages, optionally pruned at
    0.5/0.5 (qk 16 -> 8 while dv stays 16)."""
    jcfg = reduced(get_config("qwen2-1.5b"))
    pcfg = pt_configs.resolve_config("qwen2-1.5b-reduced")
    if pruned:
        jcfg, pcfg = jcfg.pruned(0.5, 0.5), pcfg.pruned(0.5, 0.5)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def greedy_chain_ok(model, params, req, out_tokens):
    """The port's ``tests/helpers.py::greedy_chain_ok``: feed prompt +
    generated tokens through ONE full forward of the port's ``apply``;
    every generated token must be the argmax at the position that produced
    it (causality makes this a stepwise greedy rollout)."""
    import torch
    P = len(req.tokens)
    seq = np.concatenate([np.asarray(req.tokens, np.int32),
                          np.asarray(out_tokens[:-1], np.int32)])
    logits = model.apply(params, {"tokens": torch.from_numpy(seq)[None]})[0]
    pred = logits[0, :, : model.cfg.vocab_size].argmax(-1).numpy()
    want = pred[P - 1: P - 1 + len(out_tokens)]
    return list(want) == [int(t) for t in out_tokens]
