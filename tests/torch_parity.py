"""Shared inputs of the port's parity tests (tests/test_torch_*.py): the
same numpy-made weights, images and tokens go to the JAX package and to
the port."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config, reduced
from repro.models import build_model as jax_build
from repro_torch import configs as pt_configs

# one intra-op thread a test process: the suite runs one process a worker
# (pytest-xdist), and torch's default of one thread a core in every worker
# oversubscribes the cores the JAX tests share (the parity shapes are too
# small to gain from more)
torch.set_num_threads(1)


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


def lm_cfgs(pruned=False, arch="qwen2-1.5b", n_layers=None):
    """``arch``-reduced (fp32; qwen2-1.5b by default) in both packages,
    optionally with ``n_layers`` layers and pruned at 0.5/0.5 (qk 16 -> 8
    while dv stays 16)."""
    jcfg = reduced(get_config(arch))
    pcfg = pt_configs.resolve_config(arch + "-reduced")
    if n_layers is not None:
        jcfg = jcfg.replace(n_layers=n_layers)
        pcfg = pcfg.replace(n_layers=n_layers)
    if pruned:
        jcfg, pcfg = jcfg.pruned(0.5, 0.5), pcfg.pruned(0.5, 0.5)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


def greedy_chain_ok(model, params, req, out_tokens):
    """The port's ``tests/helpers.py::greedy_chain_ok``: feed prompt +
    generated tokens through ONE full forward of the port's ``apply``;
    every generated token must be the argmax at the position that produced
    it (causality makes this a stepwise greedy rollout)."""
    P = len(req.tokens)
    seq = np.concatenate([np.asarray(req.tokens, np.int32),
                          np.asarray(out_tokens[:-1], np.int32)])
    logits = model.apply(params, {"tokens": torch.from_numpy(seq)[None]})[0]
    pred = logits[0, :, : model.cfg.vocab_size].argmax(-1).numpy()
    want = pred[P - 1: P - 1 + len(out_tokens)]
    return list(want) == [int(t) for t in out_tokens]


def to_port_cfg(jcfg):
    """The port's ``ModelConfig`` of any JAX config, field by field (the
    nested MoE, MLA, Mamba and RWKV dataclasses too), for the configs the
    port has no registry entry of."""
    from repro_torch.configs import base as pt_base
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(pt_base, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return pt_base.ModelConfig(**kw)


def lm_prune_setup(arch, seed, n_samples=24, batch=8, seq=32,
                   n_layers=None):
    """A reduced LM (fp32; ``n_layers`` layers if given) in both packages
    on the same numpy weights, its calibration streams (the reference's
    Markov tokens; 3 batches of 8 x 32 tokens, more than d_ff = 256 of
    them, so the MLP ridge systems are well posed) and a held-out token
    batch."""
    import jax.numpy as jnp
    from repro.data import calib_stream as jax_stream
    from repro_torch import interop
    from repro_torch.data import calib_stream as pt_stream
    from repro_torch.models import build_model as pt_build
    jcfg, pcfg = lm_cfgs(arch=arch, n_layers=n_layers)
    params = jax_params(jcfg, seed=seed)
    held = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (3, 20)).astype(np.int32)
    kw = dict(n_samples=n_samples, batch=batch, seq=seq)
    return {"jcfg": jcfg, "cfg": pcfg, "np": params,
            "jax_model": jax_build(jcfg),
            "jax_params": jax.tree.map(jnp.asarray, params),
            "pt_model": pt_build(pcfg),
            "pt_params": interop.from_numpy(params, device="cpu"),
            "jax_calib": jax_stream(jcfg, **kw),
            "pt_calib": pt_stream(pcfg, device="cpu", **kw),
            "held": held,
            "jax_held": {"tokens": jnp.asarray(held)},
            "pt_held": {"tokens": torch.from_numpy(held)}}


def mlp_rank_args(stats, w2):
    """The port's ``ranking.rank_mlp`` inputs from numpy pass-1 moments and
    the second matrix (..., F, D): diag(s2), n, na, column norms."""
    return (np.einsum("...ff->...f", np.asarray(stats["s2"], np.float64)),
            stats["n"], stats["na"],
            np.linalg.norm(np.asarray(w2, np.float64), axis=-1))


def lm_logits(model, params, batch):
    """Logits (numpy) of either package's LM on ``batch``."""
    return np.asarray(model.apply(params, batch)[0])


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))
