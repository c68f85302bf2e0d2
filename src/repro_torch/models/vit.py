"""ViT / DeiT (``repro.models.vit``): the paper's own architecture family.

Pre-norm ViT: patch embedding (conv-as-linear on flattened patches), cls
token, learned positional embeddings, bidirectional attention blocks, a
classification head. The blocks are stored stacked under ``seg0/p0`` with
the layer axis first, as the JAX pytree keeps them for ``lax.scan``; the
forward loops over that axis and returns taps stacked the same way
(``seg0/p0/{h,q,k}``, layer axis first). ``vit_loss`` is the training
objective.

``apply_vit`` takes ``tp``, a rank's ``common.TensorParallel`` (None:
unsharded), with its blocks as params (``distrib.sharding.forward_specs``,
the sharded calibration forward): attention runs over the rank's heads
and the MLP over its hidden channels, one fp32 ``all_reduce`` a sub-layer
(``blocks.apply_block``), so the taps are the rank's heads and channels.
The leaves outside the blocks follow their specs: ``patch_w`` split on
its input rows gives partial sums, reduced once (on its columns, the
columns are gathered); ``class_head`` split on its classes gives the
rank's block of the logits, gathered (on D, partial sums, reduced);
``pos``, ``cls``, the norms and the biases are whole.
"""
from __future__ import annotations

import torch

from repro_torch.models import blocks as blk
from repro_torch.models.common import (apply_norm, dense_init, dtype_of,
                                       embed_init, init_norm, layer_slice,
                                       remat as _remat, stack_layers)


def num_patches(cfg) -> int:
    return (cfg.img_size // cfg.patch) ** 2


def init_vit(gen: torch.Generator, cfg):
    """Parameters on the CPU, drawn from ``gen``."""
    dt = dtype_of(cfg)
    N = num_patches(cfg)
    params = {
        "cls": torch.zeros((1, 1, cfg.d_model), dtype=dt),
        "pos": embed_init(gen, (1, N + 1, cfg.d_model), dt),
        "final_norm": init_norm(cfg),
        "class_head": dense_init(gen, (cfg.d_model, cfg.n_classes), dt,
                                 scale=0.02),
        "head_bias": torch.zeros(cfg.n_classes),
    }
    if cfg.frontend == "patch_conv":
        pdim = cfg.patch * cfg.patch * 3
        params["patch_w"] = dense_init(gen, (pdim, cfg.d_model), dt)
        params["patch_b"] = torch.zeros(cfg.d_model)
    params["seg0"] = {"p0": stack_layers(
        [blk.init_block(gen, cfg, "attn", False)
         for _ in range(cfg.n_layers)])}
    return params


def patchify(images, cfg):
    """images: (B, H, W, 3) -> (B, N, p*p*3)."""
    B, H, W, C = images.shape
    p = cfg.patch
    x = images.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p),
                                                p * p * C)


def _patch_embed(params, patches, tp):
    """patches (B, N, p*p*3) @ ``patch_w``, whole or the rank's block."""
    w = params["patch_w"]
    if tp is None:
        return patches @ w
    if w.shape[0] != patches.shape[-1]:       # the rank's input rows
        lo, hi = tp.block(patches.shape[-1])
        return tp.reduce_product(patches[..., lo:hi], w)
    return tp.all_gather(patches @ w, -1)


def _classify(params, pooled, cfg, tp):
    """pooled (B, D) @ ``class_head``: whole, or from the rank's block of
    its classes (gathered) or of D (reduced)."""
    head = params["class_head"]
    if tp is None:
        return pooled @ head
    if head.shape[0] != cfg.d_model:            # the rank's rows of D
        lo, hi = tp.block(cfg.d_model)
        return tp.reduce_product(pooled[..., lo:hi], head)
    return tp.all_gather(pooled @ head, -1)


def apply_vit(params, inputs, cfg, *, taps=None, train=False, remat=None,
              tp=None):
    """inputs: images (B,H,W,3) if frontend='patch_conv', else patch
    embeddings (B, N, D). Returns fp32 logits (B, n_classes).

    ``remat`` (default: ``train``) recomputes each layer in the backward,
    as the reference checkpoints its scan body (one layer) with
    ``nothing_saveable``; a forward that records taps keeps its
    activations. ``tp``: tensor-parallel over the rank's blocks (module
    docstring)."""
    remat = train if remat is None else remat
    dt = dtype_of(cfg)
    if cfg.frontend == "patch_conv":
        x = _patch_embed(params, patchify(inputs.to(dt), cfg), tp) \
            + params["patch_b"].to(dt)
    else:
        x = inputs.to(dt)
    B, N, D = x.shape
    x = torch.cat([params["cls"].expand(B, 1, D), x], dim=1)
    x = x + params["pos"][:, :N + 1].to(dt)
    layers = params["seg0"]["p0"]
    per_layer = []
    for i in range(cfg.n_layers):
        t = {} if taps is not None else None

        def body(x, i=i, t=t):
            return blk.apply_block(layer_slice(layers, i), x, cfg, "attn",
                                   False, taps=t, mask_kind="full", tp=tp)
        x = _remat(body, x) if remat and taps is None else body(x)
        per_layer.append(t)
    if taps is not None:
        for k in per_layer[0]:
            taps[f"seg0/p0/{k}"] = torch.stack([t[k] for t in per_layer])
    x = apply_norm(params["final_norm"], x, cfg)
    pooled = x[:, 0] if cfg.pool == "cls" else x.mean(dim=1)
    logits = _classify(params, pooled, cfg, tp) + params["head_bias"].to(dt)
    return logits.float()


def vit_loss(params, batch, cfg, *, train=True, remat=None):
    """batch: {'images' | 'embeds', 'labels' (B,)} -> the mean cross
    entropy, fp32 0-d."""
    inputs = batch["images"] if "images" in batch else batch["embeds"]
    logits = apply_vit(params, inputs, cfg, train=train, remat=remat)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"][:, None].long())[:, 0]
    return torch.mean(logz - gold)
